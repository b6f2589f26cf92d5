"""Exact size-constrained k-means (copy of `st_dadk_tpu/ops/kmeans_exact.py`).

The reference initialises DA-STDK centers with `KMeansConstrained(
n_clusters=k, random_state=42, n_init=3, max_iter=100)`, which solves a
min-cost-flow assignment per Lloyd iteration. This module is that solver:

  - cluster sizes are exactly balanced: floor(n/k) or ceil(n/k) points a
    cluster (`balanced_caps`);
  - each Lloyd assignment is the exact integer min-cost solution on costs
    scaled by `_COST_SCALE`: a forward auction with epsilon scaling on the
    points (`auction_assign_balanced`), or, where the points collapse to
    u <= n/2 unique sites (training coords repeat every site across times),
    a u x k transportation problem on the sites;
  - the transportation problem is solved by the native network simplex of
    `native/transport.cpp` (`transport_assign_native`, warm-started across
    Lloyd iterations), built with g++ at first use by `ops/_build.py`, or,
    where the caller asks for it with `solver="lp"`, by column generation
    over HiGHS LPs (`transport_assign`), the plain version the tests hold
    the native solver to. Unlike the JAX package, a library that does not
    build raises instead of falling back to the LP; a native solve that
    hits its pivot cap takes the LP for that iteration, as there;
  - k-means++ seeding from `numpy.random.RandomState(random_state)`, n_init
    restarts keeping the lowest inertia, max_iter Lloyd iterations.

Given the same float64 points, `kmeans_constrained` makes the JAX
package's draws and integer plans, so its centers are that package's bit
for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from st_dadk_tpu_torch.ops import _build

SOLVERS = ("native", "lp")

_COST_SCALE = 1e7          # coords in [0,1]^2 -> integer costs <= 2e7

_NATIVE_LIB: Optional[ctypes.CDLL] = None


def _native_transport_lib() -> ctypes.CDLL:
    """ctypes handle of native/transport.cpp's library, built at the first
    call (RuntimeError where g++ fails)."""
    global _NATIVE_LIB
    if _NATIVE_LIB is None:
        lib = _build.load_host_library("transport")
        fn = lib.stdadk_transport_simplex
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
        ]
        _NATIVE_LIB = lib
    return _NATIVE_LIB


def transport_assign_native(cost_u: np.ndarray, supplies: np.ndarray,
                            caps: np.ndarray,
                            state: Optional[Tuple[np.ndarray, np.ndarray]]
                            = None
                            ) -> Optional[Tuple[np.ndarray, Tuple]]:
    """Exact transportation plan via the native network simplex
    (`stdadk_transport_simplex`, native/transport.cpp:50).

    Returns (flows (u, k) int64, state) where `state` warm-starts the next
    call with the SAME supplies/caps (Lloyd iterations: only costs move, so
    the previous basis stays primal-feasible), or None where the solver hit
    its pivot cap cold and warm (the caller then takes the exact LP)."""
    lib = _native_transport_lib()
    u, k = cost_u.shape
    cost_c = np.ascontiguousarray(cost_u, np.float64)
    sup = np.ascontiguousarray(supplies, np.int64)
    cap = np.ascontiguousarray(caps, np.int64)
    if sup.shape != (u,) or cap.shape != (k,):
        raise ValueError(f"supplies {sup.shape} / caps {cap.shape} do not "
                         f"match costs {cost_c.shape}")
    if state is not None:
        flow, basis = state
        if flow.shape != (u, k) or basis.shape != (u, k):
            raise ValueError("warm-start state of another shape")
        warm = 1
    else:
        flow = np.zeros((u, k), np.int64)
        basis = np.zeros((u, k), np.uint8)
        warm = 0
    max_pivots = 200 * (u + k) + 100_000
    status = lib.stdadk_transport_simplex(u, k, cost_c, sup, cap,
                                          flow, basis, warm, max_pivots)
    if status < 0 and warm:
        # retry cold before giving up (a degenerate warm basis can stall)
        flow[:] = 0
        basis[:] = 0
        status = lib.stdadk_transport_simplex(u, k, cost_c, sup, cap,
                                              flow, basis, 0, max_pivots)
    if status == -2:
        raise ValueError("stdadk_transport_simplex: supplies and caps do not "
                         "sum alike")
    if status < 0:
        return None
    return flow, (flow, basis)


def _pairwise_d2(X: np.ndarray, C: np.ndarray) -> np.ndarray:
    diff = X[:, None, :] - C[None, :, :]
    return np.einsum("nkd,nkd->nk", diff, diff)


def auction_assign_balanced(cost: np.ndarray, caps: np.ndarray,
                            eps_final: Optional[float] = None,
                            scale_factor: float = 6.0) -> np.ndarray:
    """Exact balanced transportation by forward auction with eps-scaling.

    cost: (n, m) float64 with INTEGER values; caps: (m,) int with
    caps.sum() == n (every slot filled). Returns col (n,) minimizing
    sum_i cost[i, col[i]] with bincount(col) == caps, exactly
    (eps_final < 1/n on integer costs).
    """
    n, m = cost.shape
    caps = np.asarray(caps, np.int64)
    assert int(caps.sum()) == n, "balanced auction needs caps.sum() == n"
    if eps_final is None:
        eps_final = 1.0 / (n + 1)
    value = -cost
    spread = float(value.max() - value.min())
    eps = max(spread / 8.0, eps_final)

    # per-column slot prices as one padded (m, cmax) array (+inf pads), so
    # the cheapest/2nd-cheapest scan per bidding round is a single
    # np.partition over the matrix instead of a Python loop over columns
    # (roadmap: auction vectorization). Prices persist across scales
    # (standard eps-scaling warm start); occupants are cleared each scale.
    cmax = int(caps.max())
    sp = np.full((m, cmax), np.inf)
    for j in range(m):
        sp[j, : caps[j]] = 0.0
    assignment = np.full(n, -1, np.int64)

    while True:
        occ = np.full((m, cmax), -1, np.int64)
        assignment.fill(-1)

        while True:
            U = np.where(assignment < 0)[0]
            if U.size == 0:
                break
            # cheapest and second-cheapest slot price per column (vectorized;
            # +inf padding makes single-slot columns yield p2 = inf)
            if cmax == 1:
                p1 = sp[:, 0]
                p2 = np.full(m, np.inf)
            else:
                two = np.partition(sp, 1, axis=1)[:, :2]
                p1, p2 = two[:, 0], two[:, 1]

            V1 = value[U] - p1[None, :]
            j1 = np.argmax(V1, axis=1)
            rows = np.arange(U.size)
            v1 = V1[rows, j1]
            vown = value[U, j1]
            V1[rows, j1] = -np.inf
            alt = np.max(V1, axis=1) if m > 1 else np.full(U.size, -np.inf)
            # the second-best SLOT may be the same column's 2nd-cheapest slot
            v2 = np.maximum(alt, vown - p2[j1])
            bids = p1[j1] + (v1 - v2) + eps

            for j in np.unique(j1):
                mask = j1 == j
                pts = U[mask]
                prs = bids[mask]
                order = np.argsort(-prs)
                s, o = sp[j], occ[j]
                for idx in order:
                    slot = int(np.argmin(s))
                    if prs[idx] <= s[slot]:
                        continue            # stale bid; point re-bids later
                    old = o[slot]
                    if old >= 0:
                        assignment[old] = -1
                    s[slot] = prs[idx]
                    o[slot] = pts[idx]
                    assignment[pts[idx]] = j

        if eps <= eps_final:
            out = np.empty(n, np.int64)
            for j in range(m):
                out[occ[j, : caps[j]]] = j
            return out
        eps = max(eps / scale_factor, eps_final)


def constrained_assignment(cost: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Exact equal-size assignment on float costs (scaled to integers)."""
    ci = np.round(cost * _COST_SCALE)
    return auction_assign_balanced(ci, caps)


def balanced_caps(n: int, k: int) -> np.ndarray:
    """floor/ceil(n/k) capacities summing to n (first n%k clusters get +1)."""
    q, r = divmod(n, k)
    caps = np.full(k, q, np.int64)
    caps[:r] += 1
    return caps


def _solve_restricted(cost_u, supplies, caps, rows, cols):
    """LP on the arc subset {(rows[a], cols[a])}; returns (flows full (u,k),
    row duals (u,), col duals (k,)) or None if the restriction is
    infeasible. Duals come from HiGHS' equality multipliers."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, vstack

    u, k = cost_u.shape
    na = len(rows)
    arange = np.arange(na)
    A_row = csr_matrix((np.ones(na), (rows, arange)), shape=(u, na))
    A_col = csr_matrix((np.ones(na), (cols, arange)), shape=(k, na))
    res = linprog(cost_u[rows, cols],
                  A_eq=vstack([A_row, A_col], format="csr"),
                  b_eq=np.concatenate([supplies.astype(np.float64),
                                       caps.astype(np.float64)]),
                  bounds=(0, None), method="highs")
    if not res.success:
        return None
    flows = np.zeros((u, k), np.int64)
    np.add.at(flows, (rows, cols), np.round(res.x).astype(np.int64))
    # HiGHS' eqlin.marginals ARE the LP duals y with c_ij - y_i - z_j >= 0
    # at optimum (verified: basic arcs get exactly-zero reduced cost with
    # this sign, and negating them breaks the column-generation
    # certificate — tests/test_kmeans_exact.py::test_column_generation_*)
    duals = res.eqlin.marginals
    return flows, duals[:u], duals[u:]


def _greedy_feasible_arcs(cost_u: np.ndarray, supplies: np.ndarray,
                          caps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Arc set of one feasible integral plan (greedy cheapest-fill, largest
    supplies first). Every arc either exhausts its row or saturates its
    column, so the set has at most u + k arcs; adding it to a restricted LP
    guarantees feasibility regardless of supply skew."""
    u, k = cost_u.shape
    rem = caps.astype(np.int64).copy()
    order_cols = np.argsort(cost_u, axis=1)
    rows_out: list = []
    cols_out: list = []
    for i in np.argsort(-supplies):
        s = int(supplies[i])
        for j in order_cols[i]:
            if s == 0:
                break
            take = min(s, int(rem[j]))
            if take > 0:
                rows_out.append(i)
                cols_out.append(int(j))
                rem[j] -= take
                s -= take
    return np.asarray(rows_out, np.int64), np.asarray(cols_out, np.int64)


def transport_assign(cost_u: np.ndarray, supplies: np.ndarray,
                     caps: np.ndarray, arcs_per_row: int = 16,
                     active_init: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact transportation plan: flows (u, k) minimizing sum f*cost with
    row sums == supplies, col sums == caps, f >= 0 integral.

    The balanced transportation LP has an integral optimal vertex (totally
    unimodular constraints); HiGHS' simplex returns a vertex, so rounding
    recovers the exact integer plan. The full (u x k) LP gets slow past
    ~40k arcs, so this solves by COLUMN GENERATION: restrict to each row's
    `arcs_per_row` cheapest sinks (plus each column's cheapest sources, for
    feasibility), then repeatedly add any arc whose reduced cost
    c_ij - y_i - z_j is negative under the restricted optimum's duals and
    re-solve. Termination with no violated arcs is an exact optimality
    certificate for the FULL problem (LP duality); the loop widens the arc
    budget and ultimately falls back to the full LP, so the result is
    always exact. Returns (flows, active) so Lloyd iterations can
    warm-start the arc set (`active_init`) as centers settle. Used by the
    duplicate-site fast path in `kmeans_constrained`.
    """
    u, k = cost_u.shape
    cost_u = np.asarray(cost_u, np.float64)
    if u * k <= 16384 or arcs_per_row >= k:
        rows = np.repeat(np.arange(u), k)
        cols = np.tile(np.arange(k), u)
        out = _solve_restricted(cost_u, supplies, caps, rows, cols)
        if out is None:                      # pragma: no cover - degenerate
            raise RuntimeError("transportation LP infeasible")
        return out[0], out[0] > 0

    t = min(arcs_per_row, k)
    near_cols = np.argpartition(cost_u, t - 1, axis=1)[:, :t]     # (u, t)
    tc = min(max(arcs_per_row, 4), u)
    near_rows = np.argpartition(cost_u, tc - 1, axis=0)[:tc, :]   # (tc, k)
    active = np.zeros((u, k), bool)
    active[np.repeat(np.arange(u), t), near_cols.ravel()] = True
    active[near_rows.ravel(), np.tile(np.arange(k), tc)] = True
    # feasibility seed: a greedy integral plan's arcs make the first
    # restricted LP feasible even under heavily skewed supplies (without
    # this, an infeasible restriction used to trigger arc-budget doubling
    # down to the FULL LP — and the bloated set then poisoned every later
    # warm-started call: 224 s/solve at u=803, k=81 on the Table-4.4
    # Random_Clustered masks)
    gr, gc = _greedy_feasible_arcs(cost_u, supplies, caps)
    active[gr, gc] = True
    if active_init is not None:
        active |= active_init

    tol = 1e-9 * max(float(cost_u.max()), 1.0)
    for _ in range(12):
        rows, cols = np.nonzero(active)
        out = _solve_restricted(cost_u, supplies, caps, rows, cols)
        if out is None:                      # pragma: no cover - safety
            # should not happen with the greedy feasibility seed; widen
            # every row's arc budget as a safety net
            t = min(2 * t, k)
            near_cols = np.argpartition(cost_u, t - 1, axis=1)[:, :t]
            active[np.repeat(np.arange(u), t), near_cols.ravel()] = True
            continue
        flows, y, z = out
        reduced = cost_u - y[:, None] - z[None, :]
        violated = (reduced < -tol) & ~active
        if not violated.any():
            # warm start for the NEXT Lloyd iteration: only the optimal
            # support (<= u+k-1 basic arcs), NOT the whole working set —
            # carrying the full set forward made LP size grow monotonically
            # across iterations
            return flows, flows > 0
        # add the most violated arcs (all of them if few)
        vi, vj = np.nonzero(violated)
        if len(vi) > 4 * u:
            order = np.argsort(reduced[vi, vj])[: 4 * u]
            vi, vj = vi[order], vj[order]
        active[vi, vj] = True
    # safety net: exactness over speed
    rows = np.repeat(np.arange(u), k)
    cols = np.tile(np.arange(k), u)
    out = _solve_restricted(cost_u, supplies, caps, rows, cols)
    if out is None:                          # pragma: no cover - degenerate
        raise RuntimeError("transportation LP infeasible")
    return out[0], out[0] > 0


def kmeans_constrained(X: np.ndarray, k: int,
                       n_init: int = 3, max_iter: int = 100,
                       random_state: int = 42,
                       tol: float = 1e-4, solver: str = "native"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact-balance constrained k-means; returns (centers (k,2), labels (n,)).

    Defaults mirror the reference call (random_state=42, n_init=3,
    max_iter=100); every cluster holds exactly floor(n/k) or ceil(n/k)
    points, and each Lloyd assignment is the exact min-cost solution.
    `solver` names the transportation solver of the duplicate-site path:
    'native' (native/transport.cpp) or 'lp' (`transport_assign`)."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    X = np.asarray(X, np.float64)
    n = len(X)
    caps = balanced_caps(n, k)
    rng = np.random.RandomState(random_state)

    # duplicate-site fast path: KAUST train coords repeat every site across
    # T times, so n points collapse to u << n unique locations. Duplicate
    # points have identical cost rows, so the balanced assignment is exactly
    # a transportation problem on unique points with integer supplies —
    # solved per Lloyd iteration by one small LP instead of an n-point
    # auction (~100x fewer bidders at 2a scale: 8,000 -> <=1,000).
    Xu, inv, cnt = np.unique(X, axis=0, return_inverse=True,
                             return_counts=True)
    # the HiGHS LP is fast only while the (u x k) flow polytope stays small
    # (measured: u=100/k=121 whole fit 1.4s; u=600 one assignment 33s) —
    # beyond that the point-level auction is the better exact solver
    dedup = len(Xu) * 2 <= n
    if dedup:
        # stable position-within-site index for expanding flows to labels
        order = np.argsort(inv, kind="stable")
        pos_in_site = np.empty(n, np.int64)
        starts = np.concatenate([[0], np.cumsum(cnt)])
        for u_i in range(len(Xu)):
            pos_in_site[order[starts[u_i]:starts[u_i + 1]]] = \
                np.arange(cnt[u_i])

    best = None
    for _ in range(n_init):
        centers = _kmeans_pp_np(X, k, rng)
        prev = np.inf
        labels = None
        warm = None
        native_state = None
        use_native = dedup and solver == "native"
        for _ in range(max_iter):
            if dedup:
                cost_u = _pairwise_d2(Xu, centers)
                if use_native:
                    out = transport_assign_native(cost_u, cnt, caps,
                                                  state=native_state)
                else:
                    out = None
                if out is not None:
                    flows, native_state = out
                else:
                    flows, warm = transport_assign(cost_u, cnt, caps,
                                                   active_init=warm)
                inertia = float((flows * cost_u).sum())
                # expand: site u_i's points fill its clusters in flow order
                bounds = np.cumsum(flows, axis=1)             # (u, k)
                labels = (pos_in_site[:, None] >=
                          bounds[inv]).sum(axis=1).astype(np.int64)
                w = flows.sum(axis=0).astype(np.float64)      # == caps
                centers_new = (flows.T @ Xu) / np.maximum(w, 1.0)[:, None]
                keep_mask = w > 0
                centers[keep_mask] = centers_new[keep_mask]
            else:
                cost = _pairwise_d2(X, centers)
                labels = constrained_assignment(cost, caps)
                inertia = float(cost[np.arange(n), labels].sum())
                for j in range(k):
                    pts = X[labels == j]
                    if len(pts):
                        centers[j] = pts.mean(axis=0)
            if prev - inertia <= tol * max(abs(prev), 1.0):
                break
            prev = inertia
        if best is None or inertia < best[0]:
            best = (inertia, centers.copy(), labels.copy())
    return best[1], best[2]


def _kmeans_pp_np(X: np.ndarray, k: int, rng: np.random.RandomState
                  ) -> np.ndarray:
    n = len(X)
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rng.randint(n)]
    d2 = ((X - centers[0]) ** 2).sum(1)
    for j in range(1, k):
        # degenerate potential (duplicate sites: k > n_unique leaves all
        # remaining min-distances at 0, e.g. site-wise obs with k=121 over
        # 100 unique sites) -> uniform draw, like sklearn's k-means++
        tot = d2.sum()
        if not np.isfinite(tot) or tot <= 1e-12:
            centers[j] = X[rng.randint(n)]
        else:
            centers[j] = X[rng.choice(n, p=d2 / tot)]
        d2 = np.minimum(d2, ((X - centers[j]) ** 2).sum(1))
    return centers
