"""JSON-safe result persistence (copy of `st_dadk_tpu/utils/io.py`)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np


def json_safe(obj: Any) -> Any:
    """Recursively convert numpy and torch values to JSON types."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if type(obj).__module__.startswith("torch"):
        return json_safe(obj.detach().cpu().numpy())
    if isinstance(obj, Path):
        return str(obj)
    return obj


def save_json(obj: Any, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(json_safe(obj), f, indent=2)
