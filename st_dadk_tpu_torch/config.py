"""Typed experiment configuration (copy of `st_dadk_tpu/config.py`).

Every known key is a dataclass field with the reference code's default;
unknown keys are kept in `extra`. The fields are the JAX package's that
the port reads; the others (TPU knobs, CLI keys) land in `extra`, so a
config file of the JAX package loads here and round-trips.

Config files are read and written by this module's own parser of the flat
YAML subset the repo's configs use (`load_yaml` / `dump_yaml`), so the port
needs no `yaml` package: `key: value` lines with scalars, `null`, booleans,
numbers, quoted or plain strings, flow lists (nested once, as in a grid of
`k_spatial_centers`) or block lists of scalars, comments and blank lines.
Scalars resolve as PyYAML's `safe_load` resolves them (YAML 1.1: `2e-2`
without a dot is a string, `1.0e-2` a float). Anything outside the subset
raises ValueError naming its line; nothing is read otherwise or dropped.

`resolve_device` maps the JAX package's accelerator names in `device`
(`tpu`, `gpu`: the card) to `cuda`; every other name goes to `torch.device`
as it is.
"""
from __future__ import annotations

import dataclasses
import json
import math
import numbers
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ExperimentConfig:
    # -- experiment identity --------------------------------------------------
    tag: str = "default"
    data_file: str = "data/2b/2b_7.csv"
    base_seed: int = 42
    n_experiments: int = 10       # repeats of the runner (seeds base_seed + i - 1)
    device: str = "cuda"          # torch device; 'tpu' / 'gpu' mean the card

    # -- model architecture ---------------------------------------------------
    k_spatial_centers: List[int] = field(default_factory=lambda: [25, 81, 121])
    k_temporal_centers: List[int] = field(default_factory=lambda: [10, 15, 45])
    spatial_basis_function: str = "wendland"   # wendland | gaussian | triangular
    spatial_init_method: str = "uniform"       # uniform | gmm | random_site | kmeans_balanced | kmeans_exact
    spatial_learnable: bool = False
    hidden_dims: List[int] = field(default_factory=lambda: [256, 256, 128])
    dropout: float = 0.1
    layernorm: bool = True
    p_covariates: int = 0
    use_delta_reparameterization: bool = False

    # -- learnable-basis control ----------------------------------------------
    gradient_damping: bool = False
    damping_threshold: float = 0.3
    damping_strength: float = 1.0
    domain_penalty_weight: float = 0.0
    movement_penalty_weight: float = 0.0
    basis_lr_ratio: float = 0.05
    basis_unfreeze_epoch: int = 0
    basis_lr_rampup_epochs: int = 0

    # -- sparsity penalty ------------------------------------------------------
    sparsity_penalty_type: str = "none"        # none | element | group | sparse_group
    sparsity_lambda_l1: float = 0.001
    sparsity_lambda_group: float = 0.01
    sparsity_apply_to_spatial: bool = True
    sparsity_apply_to_temporal: bool = True

    # -- non-crossing penalty (multi-quantile) ---------------------------------
    non_crossing_weight: float = 0.0
    non_crossing_power: int = 1
    non_crossing_lambda: float = 0.0
    non_crossing_delta_mode: str = "eq310"

    # -- observation design ----------------------------------------------------
    obs_method: str = "site-wise"              # site-wise | random
    obs_ratio: float = 0.5
    obs_spatial_pattern: str = "uniform"       # uniform | corner
    obs_spatial_intensity: float = 1.0
    split_method: str = "site-wise"            # site-wise | random
    train_ratio: float = 0.8
    normalize_target: bool = False

    # -- training ----------------------------------------------------------------
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 256
    patience: int = 15
    early_stop_min_rel_delta: float = 0.0
    grad_clip: float = 0.0
    scheduler: Optional[str] = None            # None | 'cosine'
    warmup_epochs: int = 0

    # -- regression head ---------------------------------------------------------
    regression_type: str = "mean"              # mean | quantile | multi-quantile
    quantile_levels: List[float] = field(default_factory=lambda: [0.1, 0.5, 0.9])
    current_quantile: Optional[float] = None   # tau of one per-tau quantile fit

    # -- kernel routes (the JAX package's opt-ins; see models/st_interp.py) -----
    use_pallas_training: bool = False          # phi built on its own in training
    use_fused_training: bool = False           # fused basis->layer-1 in training

    # -- arithmetic options of the fit (the JAX package's defaults) -------------
    # trunk activation dtype: 'f32', 'bf16' (activations and their
    # cotangents in bfloat16; params, LayerNorm statistics, the loss and the
    # optimizer stay float32), or 'auto': float32 unless the model's size
    # (models/st_interp.py AUTO_BF16_HIDDEN_SUM) or a batch's lane width
    # (train/batch_engine.py AUTO_BF16_LANES) passes its trigger on the H100
    train_dtype: str = "auto"
    packed_optimizer: bool = False             # AdamW, EMA and clipping on one flat
                                               # buffer a parameter group (train/packing.py)
    tail_compaction: bool = False              # the lane engine narrows a batch to its
                                               # active lanes once, at a multiple of
    compaction_epoch: int = 100                # compaction_epoch epochs
    # the rank mesh's lane axis of the lane engine across processes
    # (train/batch_engine.py, parallel/mesh.py)
    mesh_axis: str = "exp"

    # -- port extras -------------------------------------------------------------
    data_root: Optional[str] = None            # prefix for relative data_file paths
    k_spatial_pad: Optional[int] = None        # ragged-k lane: phi padded to this width
    save_plots: bool = True                    # the figures (viz/plots.py) at finalize
    save_artifacts: bool = True                # model/prediction/basis npz files
    eval_chunk: int = 32768                    # points per predict chunk

    # unknown keys. The port reads 'shuffle' ('auto' | 'hash' | 'perm' |
    # 'none', train/loop.py), 'init_subsample', 'init_gmm_n_init',
    # 'init_seed_rounds', 'init_em_dtype', 'ablate_validate',
    # 'sparsity_threshold_ratio' (the basis-evolution figure) and
    # 'lanes_per_device' (lanes a batch of the lane engine).
    # Accepted and ignored on purpose: the JAX package's TPU and lane-engine
    # knobs, which change how a fit runs there but not its numbers
    # ('pregather', 'remat', 'profile_dir', 'final_stop_sync';
    # 'packed_upload' and 'packed_finalize_pull', JAX's one-copy transfers,
    # which the port does not carry: host-device copies are a small share
    # of a batch on the card, PERF.md section 5; the on-device metrics of
    # the lane engine need no knob, it takes them where JAX does by what the
    # lanes need; 'pipeline_blocking_finalize': a loop of `run_job_batch`
    # is the port's serial baseline; the JAX-only fields 'scan_unroll',
    # 'dropout_rng' (its RNG streams do not cross frameworks anyway) and the
    # CLI keys), and 'init_gmm_fused': JAX runs the resolutions'
    # GMM EMs as one loop with the same seeding keys and the same tol stop
    # for each (resolution, restart) (st_dadk_tpu/ops/init_centers.py:
    # 408-434 against :281-303), the EM the port runs per resolution; on
    # the CPU the two JAX programs give bitwise equal centers and sigmas.
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        known = {f.name for f in dataclasses.fields(cls) if f.name != "extra"}
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for k, v in d.items():
            if k in known:
                kwargs[k] = v
            else:
                extra[k] = v
        cfg = cls(**kwargs)
        cfg.extra = extra
        # YAML often stores scientific-notation floats as strings
        cfg.lr = float(cfg.lr)
        cfg.weight_decay = float(cfg.weight_decay)
        return cfg

    @classmethod
    def from_yaml(cls, path: str | Path) -> "ExperimentConfig":
        return cls.from_dict(read_yaml(path))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return d

    def to_yaml(self, path: str | Path) -> None:
        write_yaml(self.to_dict(), path)

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    def resolve_data_file(self) -> Path:
        """Resolve the data file against data_root, the CWD and the
        checkout's root."""
        p = Path(self.data_file)
        if p.is_absolute():
            return p
        roots = []
        if self.data_root:
            roots.append(Path(self.data_root))
        roots += [Path.cwd(), Path(__file__).resolve().parent.parent]
        for root in roots:
            cand = root / p
            if cand.exists():
                return cand
        return p

    @property
    def output_dim(self) -> int:
        if self.regression_type == "multi-quantile":
            return len(self.quantile_levels)
        return 1

    def json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def load_config(path: str | Path,
                overrides: Optional[Dict[str, Any]] = None) -> ExperimentConfig:
    """The config file at `path` with the non-None `overrides` applied
    (copy of the JAX package's `load_config`)."""
    cfg = ExperimentConfig.from_yaml(path)
    if overrides:
        clean = {k: v for k, v in overrides.items() if v is not None}
        known = {f.name for f in dataclasses.fields(ExperimentConfig)}
        cfg = cfg.replace(**{k: v for k, v in clean.items() if k in known})
        for k, v in clean.items():
            if k not in known:
                cfg.extra[k] = v
    return cfg


# the JAX package's names for the accelerator: here, the card
_ACCELERATOR_NAMES = {"tpu": "cuda", "gpu": "cuda"}


def resolve_device(name: Any) -> "torch.device":
    """The torch device a config's `device` (or a caller's) names: 'tpu'
    and 'gpu' are the card ('cuda'); 'cpu', 'cuda:1' or a torch.device pass
    through as they are."""
    import torch
    if isinstance(name, torch.device):
        return name
    return torch.device(_ACCELERATOR_NAMES.get(str(name), str(name)))


# ---------------------------------------------------------------------------
# The flat YAML subset of the repo's config files
# ---------------------------------------------------------------------------

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)[ \t]*:(?:[ \t]+(.*))?\Z")
_NULL = frozenset({"", "~", "null", "Null", "NULL"})
_TRUE = frozenset({"yes", "Yes", "YES", "true", "True", "TRUE",
                   "on", "On", "ON"})
_FALSE = frozenset({"no", "No", "NO", "false", "False", "FALSE",
                    "off", "Off", "OFF"})
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# what PyYAML's resolver reads as an int, float or date beyond the forms
# above (octal, hex, binary, '_' digit groups, base 60, timestamps): refused
_YAML_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
                       r"\Z")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*\Z")
_YAML_DATE = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# characters a plain scalar may not start with, and what may not follow
# '-', '?' or ':' at its start
_INDICATORS = frozenset("&*!|>%@`{}[],#'\"")
_DOUBLE_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


def _plain(text: str, where: str) -> Any:
    """One plain scalar, resolved as PyYAML resolves it, or ValueError."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s) and not (len(s.lstrip("+-")) > 1
                              and s.lstrip("+-")[0] == "0"):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    m = _INF.match(s)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    if (_YAML_INT.fullmatch(s) or _YAML_FLOAT.fullmatch(s)
            or _YAML_DATE.match(s) or s in ("=", "<<")):
        raise ValueError(f"{where}: {s!r} is a YAML number or date form "
                         f"outside the config subset")
    if (s[0] in _INDICATORS or (s[0] in "-?:" and s[1:2] in ("", " "))
            or ": " in s or s.endswith(":") or " #" in s or "\t" in s):
        raise ValueError(f"{where}: {s!r} is not a plain scalar of the "
                         f"config subset")
    return s


def _quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    """The quoted string starting at s[i] and the index after it."""
    q, out, i = s[i], [], i + 1
    while i < len(s):
        c = s[i]
        if c == q:
            if q == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and q == '"':
            esc = s[i + 1:i + 2]
            if esc not in _DOUBLE_ESCAPES:
                raise ValueError(f"{where}: escape \\{esc} outside the "
                                 f"config subset")
            out.append(_DOUBLE_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"{where}: unterminated {q}-quoted string")


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t":
        i += 1
    return i


def _flow_list(s: str, i: int, depth: int, where: str) -> Tuple[list, int]:
    """The flow list starting at s[i] == '[' (one nested level at most)."""
    items: list = []
    i = _skip_ws(s, i + 1)
    if s[i:i + 1] == "]":
        return items, i + 1
    while True:
        i = _skip_ws(s, i)
        if i >= len(s):
            raise ValueError(f"{where}: unterminated flow list")
        c = s[i]
        if c == "[":
            if depth >= 1:
                raise ValueError(f"{where}: lists nested deeper than once "
                                 f"are outside the config subset")
            item, i = _flow_list(s, i, depth + 1, where)
        elif c in "'\"":
            item, i = _quoted(s, i, where)
        else:
            j = i
            while j < len(s) and s[j] not in ",]":
                if s[j] in "[{}" or (s[j] == "#" and s[j - 1] in " \t"):
                    raise ValueError(f"{where}: {s[i:j + 1]!r} in a flow "
                                     f"list is outside the config subset")
                j += 1
            if not s[i:j].strip():
                raise ValueError(f"{where}: empty item in a flow list")
            item, i = _plain(s[i:j], where), j
        items.append(item)
        i = _skip_ws(s, i)
        if s[i:i + 1] == ",":
            i = _skip_ws(s, i + 1)
            if s[i:i + 1] == "]":
                return items, i + 1
        elif s[i:i + 1] == "]":
            return items, i + 1
        else:
            raise ValueError(f"{where}: expected ',' or ']' in a flow list")


def _rest_is_comment(s: str, i: int, where: str) -> None:
    i = _skip_ws(s, i)
    if i < len(s) and (s[i] != "#" or (i > 0 and s[i - 1] not in " \t")):
        raise ValueError(f"{where}: unexpected {s[i:]!r} after the value")


def _value(text: str, where: str) -> Any:
    """The value of one `key: value` line or block-list item."""
    s = text.strip()
    if s.startswith("["):
        v, i = _flow_list(s, 0, 0, where)
    elif s[:1] in ("'", '"'):
        v, i = _quoted(s, 0, where)
    else:
        cut = re.search(r"[ \t]#", s)
        return _plain(s[:cut.start()] if cut else s, where)
    _rest_is_comment(s, i, where)
    return v


def load_yaml(text: str, source: str = "<yaml>") -> Dict[str, Any]:
    """The mapping a config file of the subset holds (see the module's
    docstring); ValueError naming the line on anything outside it."""
    out: Dict[str, Any] = {}
    block_key: Optional[str] = None        # key whose block list is open
    for n, line in enumerate(text.splitlines(), start=1):
        where = f"{source}:{n}"
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if block_key is not None and stripped.startswith("-") and \
                stripped[1:2] in ("", " ", "\t"):
            item = stripped[1:].strip()
            if item.startswith("-") and item[1:2] in ("", " ", "\t"):
                raise ValueError(f"{where}: nested block lists are outside "
                                 f"the config subset")
            if out[block_key] is None:
                out[block_key] = []
            out[block_key].append(_value(item, where))
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented line outside the config "
                             f"subset: {stripped!r}")
        m = _KEY.match(line.rstrip())
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line of the "
                             f"config subset: {stripped!r}")
        key, rest = m.group(1), m.group(2)
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if rest is None or not rest.strip() or rest.strip().startswith("#"):
            out[key], block_key = None, key
        else:
            out[key], block_key = _value(rest, where), None
    return out


def read_yaml(path: str | Path) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return load_yaml(f.read(), str(path))


def _dump_scalar(v: Any, where: str) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, numbers.Integral):
        return str(int(v))
    if isinstance(v, numbers.Real):
        f = float(v)
        if math.isnan(f):
            return ".nan"
        if math.isinf(f):
            return ".inf" if f > 0 else "-.inf"
        r = repr(f)
        if "." not in r and "e" in r:          # PyYAML's form: 1.0e-05
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        if "\n" in v or "\r" in v:
            raise ValueError(f"{where}: multi-line strings are outside the "
                             f"config subset")
        try:
            plain_ok = (v == v.strip() and not any(c in v for c in ",[]{}")
                        and _plain(v, where) == v)
        except ValueError:
            plain_ok = False
        return v if plain_ok else "'" + v.replace("'", "''") + "'"
    raise ValueError(f"{where}: a {type(v).__name__} value is outside the "
                     f"config subset")


def _dump_value(v: Any, depth: int, where: str) -> str:
    if isinstance(v, (list, tuple)):
        if depth >= 2:
            raise ValueError(f"{where}: lists nested deeper than once are "
                             f"outside the config subset")
        return "[" + ", ".join(_dump_value(x, depth + 1, where)
                               for x in v) + "]"
    return _dump_scalar(v, where)


def dump_yaml(d: Dict[str, Any]) -> str:
    """`d` as text of the subset, keys sorted as yaml.dump sorts them;
    `load_yaml` and yaml.safe_load read it back as `d`. ValueError on a key
    or value outside the subset."""
    lines = []
    for key in sorted(d):
        if not isinstance(key, str) or not re.fullmatch(
                r"[A-Za-z_][A-Za-z0-9_]*", key):
            raise ValueError(f"key {key!r} is outside the config subset")
        lines.append(f"{key}: {_dump_value(d[key], 0, key)}")
    return "\n".join(lines) + "\n"


def write_yaml(d: Dict[str, Any], path: str | Path) -> None:
    text = dump_yaml(d)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
