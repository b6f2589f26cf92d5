"""The lane optimizer's multi-tensor kernels (`csrc/lane_optimizer.cu`,
`st_dadk_tpu_torch/ops/lane_optimizer.py`), pinned on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here: the leaf-table planner and a mirror of how a
kernel finds its leaf and walks its elements (every element of every leaf
once, in the right lane, group and clip group), the constants and ctypes
signatures against the C source, the plain path every CPU tensor takes, and
a numpy mirror of the kernels' per-element arithmetic against the plain
version.
"""
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.models.st_interp import ModelSpec, STInterpLanes
from st_dadk_tpu_torch.ops import lane_optimizer as lo
from st_dadk_tpu_torch.train import optimizer as to
from st_dadk_tpu_torch.train.packing import PackSpec
from torch_threads import worker_threads  # noqa: F401

SRC = (Path(lo.__file__).resolve().parent.parent / "csrc"
       / "lane_optimizer.cu").read_text()


def _model(learnable, lanes=2):
    spec = ModelSpec(output_dim=5, spatial_learnable=learnable)
    k = spec.k_spatial
    rng = np.random.default_rng(0)
    return STInterpLanes(spec, rng.uniform(size=(lanes, k, 2)).astype(
        np.float32), np.full((lanes, k), 0.1, np.float32))


def _sizes(tensors):
    return [t[0].numel() for t in tensors]


STDK_SIZES = _sizes(list(_model(False).parameters()))
DASTDK = _model(True)
BASIS_SIZES = _sizes(list(DASTDK.basis.parameters()))
PACKED_SIZES = _sizes(list(PackSpec.for_model(_model(True)).attach(
    _model(True)).values()))


# ---------------------------------------------------------------------------
# The kernel source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["THREADS", "CHUNK", "MAX_LEAVES",
                                  "MAX_CLIP_GROUPS", "TABLE_COLS",
                                  "MAX_LANES"])
def test_constants_match_the_kernel_source(name):
    m = re.search(r"constexpr int %s = (\d+);" % name, SRC)
    assert m, name
    assert int(m.group(1)) == getattr(lo, name)


@pytest.mark.parametrize("name,n_ptr,n_int", lo._SIGNATURES)
def test_lane_optimizer_ctypes_signatures_match_the_c_entry_points(
        name, n_ptr, n_int, monkeypatch):
    m = re.search(r"int %s\(([^)]*)\)" % name, SRC)
    assert m, name
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    assert params[-1] == "void*"
    assert [p.endswith("*") for p in params[:-1]] == (
        [True] * n_ptr + [False] * n_int)
    assert all(p == "int" for p in params[n_ptr:-1])
    fake = types.SimpleNamespace(**{nm: types.SimpleNamespace()
                                    for nm, _, _ in lo._SIGNATURES})
    monkeypatch.setattr(lo, "load_library", lambda _: fake)
    monkeypatch.setattr(lo, "_KERNELS", None)
    lo._kernels()
    fn = getattr(fake, name)
    assert fn.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
    assert fn.restype is ctypes.c_int


def test_the_model_leaves_the_cases_cover():
    """The bench's STDK has 14 leaves of 176,901 elements a lane; DA-STDK
    adds centers and log-bandwidths; packed, two buffers of the same."""
    assert len(STDK_SIZES) == 14 and sum(STDK_SIZES) == 176901
    assert BASIS_SIZES == [2 * 227, 227]
    assert sorted(PACKED_SIZES) == [681, 176901]


# ---------------------------------------------------------------------------
# The planner and its mirror
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "stdk_128": (128, STDK_SIZES),
    "dastdk_4": (4, BASIS_SIZES + STDK_SIZES),
    "packed_128": (128, PACKED_SIZES),
    "narrowed_32": (32, STDK_SIZES),
    "small_and_odd": (3, [5, 1, 3, 4, 4095, 4097, 4099, 8192, 12, 7]),
    "past_one_launch": (2, [1 + (i * 37) % 300 for i in range(150)]),
}


@pytest.mark.parametrize("vec_where_possible", [True, False])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planner_mirror_covers_every_element_once(case, vec_where_possible):
    """Every element of every leaf once, by blocks of its own leaf, each
    element within the lane's n (so lane m's elements are m n + e, no lane
    reaching another's), and every launch within MAX_LEAVES leaves and the
    grid."""
    lanes, sizes = PLAN_CASES[case]
    vec = [vec_where_possible and n % 4 == 0 for n in sizes]
    seen = [np.zeros(n, np.int64) for n in sizes]
    launches = lo.plan_launches(sizes)
    assert launches[0][0] == 0 and launches[-1][1] == len(sizes)
    offset = 0
    for (a, b, firsts, off), nxt in zip(launches, launches[1:] + [None]):
        assert 1 <= b - a <= lo.MAX_LEAVES
        assert nxt is None or nxt[0] == b
        assert off == offset
        blocks = firsts[-1] + lo.blocks_of(sizes[b - 1])
        offset += blocks
        assert lanes <= lo.MAX_LANES and blocks < 2 ** 31
        for x in range(blocks):
            i = lo.leaf_of(firsts, x)
            leaf = a + i
            e = lo.block_elements(sizes[leaf], x - firsts[i], vec[leaf])
            assert e.size and e.min() >= 0 and e.max() < sizes[leaf]
            seen[leaf][e] += 1
    assert all((s == 1).all() for s in seen)
    assert offset == sum(lo.blocks_of(n) for n in sizes)


def test_leaf_tables_hold_groups_sizes_and_float4_access():
    """AdamW's table: each leaf's four addresses, n, first block, LR column
    and float4 access only where n % 4 == 0 (out.b, 5 a lane, takes
    floats)."""
    model = _model(True, lanes=3)
    groups = {"mlp": list(model.mlp.parameters()),
              "basis": list(model.basis.parameters())}
    leaves, cols = [], []
    for j, ps in enumerate(groups.values()):
        for p in ps:
            leaves.append((p, torch.zeros_like(p), torch.zeros_like(p),
                           torch.zeros_like(p)))
            cols.append(j)
    sizes = [p[0].numel() for p, *_ in leaves]
    (table, offset), = lo.leaf_tables(leaves, sizes, cols)
    assert offset == 0 and table.shape == (16, lo.TABLE_COLS)
    for row, leaf, n, j in zip(table, leaves, sizes, cols):
        assert list(row[:4]) == [t.data_ptr() for t in leaf]
        assert row[4] == n and row[6] == j
        assert row[7] == (n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                              for t in leaf))
    assert list(table[:, 5]) == list(np.cumsum(
        [0] + [lo.blocks_of(n) for n in sizes[:-1]]))
    assert table[sizes.index(5), 7] == 0


def test_clip_plan_keeps_each_group_in_one_run_of_partials():
    """Both clip groups in the same launches: the basis leaves' blocks, then
    the MLP's, each block's partial column within its own group's run;
    max norms as float32."""
    model = _model(True, lanes=3)
    basis = [torch.randn_like(p) for p in model.basis.parameters()]
    mlp = [torch.randn_like(p) for p in model.mlp.parameters()]
    lanes, tables, group_first, norms = lo.clip_plan([(basis, 1.0),
                                                      (mlp, 10.0)])
    assert lanes == 3
    assert list(norms) == [np.float32(1.0), np.float32(10.0)]
    nb = sum(lo.blocks_of(g[0].numel()) for g in basis)
    nm = sum(lo.blocks_of(g[0].numel()) for g in mlp)
    assert list(group_first) == [0, nb, nb + nm]
    for table, offset in tables:
        firsts = list(table[:, 5])
        blocks = firsts[-1] + lo.blocks_of(int(table[-1, 4]))
        for x in range(blocks):
            c = table[lo.leaf_of(firsts, x), 6]
            assert group_first[c] <= offset + x < group_first[c + 1]
    rows = np.concatenate([t for t, _ in tables])
    assert list(rows[:, 0]) == [g.data_ptr() for g in basis + mlp]
    assert list(rows[:, 6]) == [0] * len(basis) + [1] * len(mlp)


def test_clip_plan_refuses_an_empty_leaf_and_five_groups():
    with pytest.raises(ValueError, match="elements a lane"):
        lo.clip_plan([([torch.zeros(2, 0), torch.ones(2, 3)], 1.0)])
    with pytest.raises(ValueError, match="groups"):
        lo.clip_plan([([torch.ones(2, 3)], 1.0)] * 5)


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.ones(3, 4, dtype=torch.float64), "float32"),
    (lambda: torch.ones(4, 3).t(), "contiguous"),
    (lambda: torch.ones(2, 4), "lane axis"),
    (lambda: torch.ones(()), "lanes"),
])
def test_lane_leaves_refuse_what_the_kernels_do_not_take(bad, match):
    leaves = [(torch.ones(3, 5),), (bad(),)]
    if match == "lanes":
        leaves = leaves[1:]
    with pytest.raises((TypeError, ValueError), match=match):
        lo._lane_leaves("lane test", leaves, ("g",))


# ---------------------------------------------------------------------------
# CPU tensors take the plain path
# ---------------------------------------------------------------------------

def _state(seed, lanes=4, shapes=((7, 3), (3,), (6, 2), (5,))):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((lanes,) + s, generator=g) for s in shapes]


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On CPU tensors the three stages are their plain versions bit for bit
    (the clip's groups in order) and nothing is built or launched."""
    monkeypatch.setattr(lo, "_kernels", lambda: pytest.fail("launched"))
    lo.reset_launch_counts()
    params, grads = _state(0), [10 * g for g in _state(1)]
    ms, vs, ema = _state(2), [x.abs() for x in _state(3)], _state(4)
    lrs = torch.tensor([[1e-2, 2e-3]] * 4)
    executes = torch.tensor([True, False, True, True])
    decay = torch.tensor([0.99, 0.9, 0.95, 0.5])

    def run(clip, adamw, ema_fn, plain):
        p = [x.clone() for x in params]
        g = [x.clone() for x in grads]
        m, v, e = ([x.clone() for x in xs] for xs in (ms, vs, ema))
        if plain:
            clip(g[2:], 0.5)
            clip(g[:2], 10.0)
        else:
            clip([(g[2:], 0.5), (g[:2], 10.0)])
        for a, b in zip(p, g):
            a.grad = b
        count = torch.tensor([3, 0, 1, 2], dtype=torch.int32)
        out = adamw([list(zip(p[:2], m[:2], v[:2])),
                     list(zip(p[2:], m[2:], v[2:]))], lrs, executes, count,
                    0.9, 0.999, 1e-8, 5e-4)
        assert out is count
        ema_fn(e, p, decay, 1.0 - decay, executes)
        return p + g + m + v + e + [count]

    got = run(lo.clip_lanes_, lo.adamw_lanes_, lo.ema_lanes_, False)
    want = run(lo.plain_clip_lanes_, lo.plain_adamw_lanes_,
               lo.plain_ema_lanes_, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[-1].tolist() == [4, 0, 2, 3]
    assert lo.launch_counts() == dict.fromkeys(
        ("lane_clip_sumsq", "lane_clip_scale", "lane_adamw", "lane_ema"), 0)


def test_transform_grads_lanes_clips_basis_then_mlp_as_two_calls():
    """`_transform_grads_lanes` clips the basis group at 0.1 x grad_clip and
    the MLP group at grad_clip, bitwise the two one-group calls."""
    from types import SimpleNamespace

    from st_dadk_tpu_torch.train import loop
    model = _model(True, lanes=3)
    groups = {"mlp": list(model.mlp.parameters()),
              "basis": list(model.basis.parameters())}
    g = torch.Generator().manual_seed(5)
    for ps in groups.values():
        for p in ps:
            p.grad = 3 * torch.randn(p.shape, generator=g)
    want = {id(p): p.grad.clone() for ps in groups.values() for p in ps}
    to.clip_by_global_norm_lanes_([want[id(p)] for p in groups["basis"]],
                                  1.0)
    to.clip_by_global_norm_lanes_([want[id(p)] for p in groups["mlp"]], 10.0)
    spec = SimpleNamespace(model=SimpleNamespace(spatial_learnable=False),
                           grad_clip=10.0)
    loop._transform_grads_lanes(spec, model, groups)
    for ps in groups.values():
        for p in ps:
            assert torch.equal(p.grad, want[id(p)])


# ---------------------------------------------------------------------------
# The kernels' per-element arithmetic, mirrored in numpy float32
# ---------------------------------------------------------------------------

F = np.float32


def _fma(a, b, c):
    """fma(a, b, c) of float32 operands, rounded once to float32 (the
    product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(F)


def _mirror_adamw(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-8,
                  wd=5e-4):
    """lane_optimizer.cu::adamw_element and the lane's scalars."""
    t = F(step + 1)
    bc1 = F(1) - F(np.power(F(b1), t, dtype=F))
    bc2 = F(1) - F(np.power(F(b2), t, dtype=F))
    decay = F(1) - F(lr) * F(wd)
    m_new = _fma(F(1 - b1), g, m * F(b1))
    v_new = _fma(F(1 - b2) * g, g, v * F(b2))
    upd = (m_new / bc1) / (np.sqrt(v_new / bc2) + F(eps))
    return p * decay - F(lr) * upd, m_new, v_new


def test_mirrored_kernel_arithmetic_meets_the_plain_version():
    """The kernels' formulas, rounded where each eager op rounds, agree with
    the plain version: AdamW within 2 ulp after three steps, the EMA
    bitwise, the clip's scale (reciprocal, then the product) within its
    sum's order."""
    rng = np.random.default_rng(7)
    lanes, n = 3, 1000
    p0 = rng.normal(size=(lanes, n)).astype(F)
    grads = [rng.normal(size=(lanes, n)).astype(F) * F(s) for s in
             (1.0, 1e-3, 30.0)]
    lrs = np.asarray([2e-2, 1e-3, 7e-3], F)
    p = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    count = torch.zeros(lanes, dtype=torch.int32)
    mp, mm, mv = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    ex = torch.ones(lanes, dtype=torch.bool)
    for s, g in enumerate(grads):
        p.grad = torch.as_tensor(g)
        lo.plain_adamw_lanes_([[(p, m, v)]], torch.as_tensor(
            lrs[:, None]), ex, count, 0.9, 0.999, 1e-8, 5e-4)
        for lane in range(lanes):
            mp[lane], mm[lane], mv[lane] = _mirror_adamw(
                mp[lane], g[lane], mm[lane], mv[lane], lrs[lane], s)
    for got, want in ((p.detach(), mp), (m, mm), (v, mv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -22, atol=0)

    s, q = rng.normal(size=(lanes, n)).astype(F), p0
    d = np.asarray([0.99, 0.5, 0.9], F)
    e = torch.as_tensor(s.copy())
    lo.plain_ema_lanes_([e], [torch.as_tensor(q)], torch.as_tensor(d),
                        torch.as_tensor(F(1) - d), ex)
    want = s * d[:, None] + q * (F(1) - d)[:, None]
    assert np.array_equal(e.numpy(), want)

    g = grads[2].copy()
    total = np.sqrt(np.sum((g.astype(np.float64) ** 2), axis=1)).astype(F)
    scale = np.minimum(F(1) / (total + F(1e-6)) * F(10.0), F(1))
    gt = torch.as_tensor(g.copy())
    lo.plain_clip_lanes_([gt], 10.0)
    np.testing.assert_allclose(gt.numpy(), g * scale[:, None], rtol=1e-6)
