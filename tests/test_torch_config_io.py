"""The port's own reader and writer of the flat YAML its configs use
(st_dadk_tpu_torch.config.load_yaml / dump_yaml) against yaml.safe_load, and
the device names of the JAX package's configs (config.resolve_device)."""
from pathlib import Path

import pytest
import torch
import yaml

from st_dadk_tpu_torch.config import (ExperimentConfig, dump_yaml, load_yaml,
                                      read_yaml, resolve_device)

REPO = Path(__file__).resolve().parent.parent
# the configs users start from, and the config.yaml of every run on record
# (written by the JAX package's yaml.dump)
CONFIG_FILES = sorted((REPO / "configs").glob("*.yaml")) + sorted(
    (REPO / "results").rglob("config.yaml"))


def test_the_repo_has_config_files():
    assert REPO / "configs" / "config_st_interp.yaml" in CONFIG_FILES
    assert len(CONFIG_FILES) >= 20


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_every_repo_config_reads_as_safe_load_reads_it(path):
    want = yaml.safe_load(path.read_text()) or {}
    got = read_yaml(path)
    assert got == want
    # the types too: 2e-2 is a string in YAML 1.1, 1.0e-2 a float
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


def test_the_users_config_loads_and_names_the_card():
    path = REPO / "configs" / "config_st_interp.yaml"
    cfg = ExperimentConfig.from_yaml(path)
    want = yaml.safe_load(path.read_text())
    assert cfg.device == "tpu"
    assert resolve_device(cfg.device) == torch.device("cuda")
    assert {k: v for k, v in cfg.to_dict().items() if k in want} == dict(
        want, lr=float(want["lr"]), weight_decay=float(want["weight_decay"]))


@pytest.mark.parametrize("name,want", [("tpu", "cuda"), ("gpu", "cuda"),
                                       ("cpu", "cpu"), ("cuda", "cuda"),
                                       ("cuda:1", "cuda:1")])
def test_device_names(name, want):
    assert resolve_device(name) == torch.device(want)
    assert resolve_device(torch.device(want)) == torch.device(want)


def test_an_unknown_device_name_still_raises():
    with pytest.raises(RuntimeError):
        resolve_device("abacus")


_WRITTEN = [
    ExperimentConfig(),
    ExperimentConfig.from_dict(dict(
        tag="x y", data_file="data/2a/2a_8.csv", lr=1e-5, weight_decay=0.0,
        k_spatial_centers=[25, 81], quantile_levels=[0.05, 0.5, 0.95],
        current_quantile=0.5, device="tpu", config_id=3, shuffle="none",
        note="it's: #1", empty="", yes_str="yes", num_str="1e-3",
        grid=[[25, 81], [25, 81, 121]], big=1.5e300, neg=-0.0,
        tiny=5e-324, inf=float("inf"), nothing=None, flag=True)),
]


@pytest.mark.parametrize("cfg", _WRITTEN, ids=["defaults", "every_kind"])
def test_written_configs_read_back_alike_by_both_readers(cfg, tmp_path):
    path = tmp_path / "config.yaml"
    cfg.to_yaml(path)
    text = path.read_text()
    assert load_yaml(text) == yaml.safe_load(text) == cfg.to_dict()
    back = ExperimentConfig.from_yaml(path)
    assert back.to_dict() == cfg.to_dict()


def test_the_writer_sorts_keys_like_yaml_dump():
    d = {"b": 1, "a": [1, 2], "c": "s"}
    assert [line.split(":")[0] for line in dump_yaml(d).splitlines()] == \
        sorted(d)


def test_comments_blank_lines_and_block_lists():
    text = ("# head\n\nk: [1, 2]  # tail\nname: 'a # b'\nlst:\n  - 1\n"
            "  - two\nv: 3 # c\nq: \"x\\ty\"\nz: ~\n")
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,line", [
    ("a: 1\n  b: 2\n", 2),             # a nested mapping
    ("a:\n  b: 2\n", 2),
    ("a: {b: 1}\n", 1),                # a flow mapping
    ("a: [[[1]]]\n", 1),               # lists nested twice
    ("a: &x 1\n", 1),                  # an anchor
    ("a: !!str 1\n", 1),               # a tag
    ("a: |\n  text\n", 1),             # a block scalar
    ("a: 0x1f\n", 1),                  # numbers of other bases
    ("a: 1_000\n", 1),
    ("a: 2026-10-17\n", 1),            # a date
    ("a: 1\na: 2\n", 2),               # a duplicate key
    ("- 1\n", 1),                      # a top-level list
    ("a: [1, 2\n", 1),                 # unterminated
    ("a: 'x\n", 1),
    ("a: b: c\n", 1),
    ("a: [1, 2] x\n", 1),             # text after a flow list
    ("a: \"x\" y\n", 1),
])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=rf"<yaml>:{line}:"):
        load_yaml(text)


@pytest.mark.parametrize("d", [{"a": {"b": 1}}, {"a": [[[1]]]},
                               {"a": "two\nlines"}, {"a b": 1},
                               {"a": object()}])
def test_the_writer_refuses_what_the_reader_would_not_read(d):
    with pytest.raises(ValueError):
        dump_yaml(d)


def test_no_module_of_the_port_imports_yaml():
    import ast
    for path in (REPO / "st_dadk_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] == "yaml" for n in names), path
