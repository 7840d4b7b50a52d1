"""The sixteenth slice of kmpc_tpu_torch against kmpc_tpu: kernels A and B
in the cluster layout.

The cluster layout (``csrc/pdhg_log_utility{,_scenarios}_cluster{,_adaptive}.cu``,
``csrc/pdhg_log_utility_cluster.cuh``) runs the wide-row body with one
problem's horizon rows split over a thread-block cluster of at most 8 CTAs,
their arrays in each CTA's shared memory and the rows that meet across CTAs
read through distributed shared memory; kernel B's returns resident or
streamed through each warp's ring by TMA bulk copies. It takes the shapes
no single CTA holds and a cluster does, which the global layout took
before; the global layout keeps the rest and ``allow_short``.

On the CPU: the plan (``cluster_plan``: the CTAs, the rows a CTA and the
bytes a CTA, counted here by hand; chip_smoke.py holds them against the
values the built libraries report), the routing of every shape the port
once refused, the padded returns a bulk copy reads, and the packed wrappers
(the kernels' plain version on the CPU) against kmpc_tpu's packed wrappers
on the same numpy inputs at two routed shapes of each kernel and body. On a
card (marked ``cuda``, and skipped here): the cluster kernels give the
wide-row kernels' bits at shapes both take, launched at two and three CTAs
a problem. JAX is imported only inside the comparisons, so that

    python -m pytest tests/test_torch_port_cluster.py -m cuda --noconftest

runs the card's test on a machine without it.

Bars (the repository's kernel-vs-XLA bars, tests/test_mpc_pallas.py):
objective <= 1e-5 (scenarios 5e-5), weights, duals and the fixed-point
residual <= 5e-4; equal ``converged``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops.mpc import MPCParams

OBJ_TOL, SCEN_OBJ_TOL, W_TOL = 1e-5, 5e-5, 5e-4
FEAS_TOL = 1e-5
ACCURATE = dict(adaptive=True, adapt_every=2, precond=True)
PIPE = dict(pipeline_reduces=True, proj_refresh_every=16, precond=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: one torch thread, as in
    test_torch_port_mv_block.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, **kw})


def _log_inputs(B, H, N, seed, S=None):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    shape = (B, H, N) if S is None else (B, S, H, N)
    ys = (rng.standard_normal(shape) * 0.01
          + (0.0005 if S is None else 0.0)).astype(np.float32)
    return cw, ys


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# (S, H, N, adaptive, storage, ring) -> (C, span, floats a CTA), counted by
# hand: KW = 32 ceil(N / 32), SR = span KW; the returns (one forecast SR;
# resident span S N; streamed span stages chunk KW, rounded to 4 floats),
# w, p, the projection input and wbar (4 SR + KW), with adaptive dw, dp
# (2 SR) and the residual partials (2 span 32); the curvature ratios (span,
# or span 4 with scenarios), fp and the bounds (2 span), rounded to 2
# floats; streamed, the mbarriers (2 span stages).
PLANS = [
    # One forecast at the global path's shape: C=2 (10 rows), adaptive C=3.
    ((None, 20, 1000, False, None, None),
     (2, 10, 5 * 10240 + 1024 + 30)),
    ((None, 20, 1000, True, None, None),
     (3, 7, 7 * 7168 + 1024 + 448 + 21 + 1)),
    # 33 rows: never one CTA (32 warps at most).
    ((None, 33, 20, False, None, None),
     (2, 17, 5 * 17 * 32 + 32 + 51 + 1)),
    # 252 rows of 64 assets: 8 CTAs of 32 rows (the last of 28).
    ((None, 252, 64, True, None, None),
     (8, 32, 7 * 32 * 64 + 64 + 2 * 32 * 32 + 96)),
    # Kernel B streamed at the global path's shape, ring (2, 2): C=4.
    ((16, 20, 1000, False, "streamed", (2, 2)),
     (4, 5, 5 * 2 * 2 * 1024 + 4 * 5120 + 1024 + 20 + 10 + 20)),
    # ... adaptive, ring (2, 1): C=4 (three CTAs of 7 rows would take
    # 235544 bytes).
    ((16, 20, 1000, True, "streamed", (2, 1)),
     (4, 5, 5 * 2 * 1 * 1024 + 6 * 5120 + 1024 + 320 + 20 + 10 + 20)),
    # Resident returns, rounded to 4 floats before w.
    ((16, 33, 128, False, "resident", None),
     (2, 17, 17 * 16 * 128 + 4 * 17 * 128 + 128 + 68 + 34)),
    ((3, 5, 2400, True, "resident", None),
     (3, 2, 2 * 3 * 2400 + 6 * 2 * 2400 + 2400 + 128 + 8 + 4)),
]


@pytest.mark.parametrize("key,want", PLANS)
def test_cluster_plan_by_hand(key, want):
    """``cluster_plan`` (the wrapper's copy of the header's plan): the
    fewest CTAs whose CTA of ceil(H / C) rows fits a block's shared memory,
    the rows a CTA, and the bytes a CTA."""
    S, H, N, adaptive, storage, ring = key
    c, span, nbytes, stages, chunk = M.cluster_plan(S, H, N, adaptive,
                                                    storage, ring)
    assert (c, span, nbytes) == (want[0], want[1], 4 * want[2])
    assert nbytes <= M.SMEM_PER_BLOCK
    assert (stages, chunk) == (ring if storage == "streamed" else
                               (0, 1) if S is None else (0, M.WIDE_CHUNK))


def test_cluster_plan_over_a_grid():
    """At every shape a cluster holds: at most CLUSTER_MAX CTAs of at most
    WIDE_MAX_H rows, every CTA with a row, the plan within a block's shared
    memory, and one CTA fewer (with its larger span) past it; the streamed
    plan does not grow with S, and the ring is the first of CLUSTER_RINGS
    that fits."""
    held = 0
    for S in (None, 1, 16, 512):
        for H in (1, 5, 20, 33, 64, 128, 252, 300):
            for N in (1, 20, 129, 500, 1000, 2400, 6000):
                for adaptive in (False, True):
                    c, span, nbytes, stages, chunk = M.cluster_plan(
                        S, H, N, adaptive)
                    if c == 0:
                        continue
                    held += 1
                    assert 1 <= c <= M.CLUSTER_MAX and span <= M.WIDE_MAX_H
                    assert (c - 1) * span < H <= c * span
                    assert nbytes <= M.SMEM_PER_BLOCK
                    storage = "registers" if S is None else \
                        M.cluster_storage(S, H, N)
                    ring = (stages, chunk)
                    if c > 1:
                        fewer = -(-H // (c - 1))
                        assert fewer > M.WIDE_MAX_H or M.cluster_cta_bytes(
                            S, fewer, N, adaptive, storage,
                            *ring) > M.SMEM_PER_BLOCK
                    if storage == "streamed":
                        assert ring == M.cluster_ring(S, H, N, adaptive)
                        assert M.cluster_plan(2 * S, H, N, adaptive,
                                              "streamed", ring)[:3] == \
                            (c, span, nbytes)
    assert held > 100
    assert M.cluster_plan(None, 300, 20, True)[0] == 0    # 38 rows a CTA
    assert M.cluster_plan(None, 20, 6000, False)[0] == 0  # a row past a CTA


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _refused():
    path = Path(__file__).resolve().parent / "test_torch_port_global.py"
    spec = importlib.util.spec_from_file_location("port_global_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REFUSED


@pytest.mark.parametrize("group", ["one_forecast", "scenarios"])
def test_refused_shapes_route_to_the_cluster_layout_where_it_holds_them(
        group):
    """Every shape the port refused before the global layout (kernels A
    and B) routes to the cluster layout's kernel of its body where a
    cluster of at most 8 CTAs holds the adaptive body's plan, else to the
    global layout's; ``allow_short`` (no hyperplane projection in the
    cluster kernels) to the global layout."""
    bodies = [MPCParams(), _params(ACCURATE), _params(PIPE)]
    short = MPCParams(allow_short=True)
    reached = set()
    for S, H, N in _refused()[group]:
        held = M.cluster_plan(S, H, N, True)[0] > 0
        want = "cluster" if held else "global"
        reached.add(want)
        assert M.layout_supports("cluster", S, H, N) is held
        assert M.kernel_layout(S, H, N) == want, (S, H, N)
        for p in bodies:
            layout, body, kernel = M._route(S, H, N, p)
            assert (layout, kernel) == (
                want, M._KERNELS[(S is not None, want, body)])
            assert kernel in (M._CLUSTER if held else M._GLOBAL)
        assert M.kernel_layout(S, H, N, allow_short=True) == "global"
        assert M._route(S, H, N, short)[2] in M._GLOBAL
        assert not M.layout_supports("cluster", S, H, N, allow_short=True)
    assert "cluster" in reached
    # Past a cluster of 8 CTAs: the global layout.
    assert M.kernel_layout(None, 20, 6000) == "global"
    assert M.kernel_layout(16, 252, 1000) == "global"
    assert M.kernel_layout(None, 300, 20) == "block"


def test_the_global_paths_shapes_route_to_the_cluster_kernels():
    """The global path's solves (1000 names, H=20, S=16) and its entry
    points: A's and B's cluster kernels of each body, B's returns streamed
    through CLUSTER_RINGS' first ring; the layouts that take smaller
    shapes keep them (the cluster layout comes after the block and
    wide-row layouts)."""
    assert M._route(None, 20, 1000, MPCParams())[2] is \
        M.PDHG_LOG_UTILITY_CLUSTER
    assert M._route(None, 20, 1000, _params(ACCURATE))[2] is \
        M.PDHG_LOG_UTILITY_CLUSTER_ADAPTIVE
    assert M._route(16, 20, 1000, _params(PIPE))[:2] == ("cluster", "pipe")
    assert M._route(16, 20, 1000, _params(ACCURATE))[2] is \
        M.PDHG_LOG_UTILITY_SCENARIOS_CLUSTER_ADAPTIVE
    assert M.cluster_storage(16, 20, 1000) == "streamed"
    assert M.cluster_ring(16, 20, 1000, False) == M.CLUSTER_RINGS[0]
    assert M._storage(M.PDHG_LOG_UTILITY_SCENARIOS_CLUSTER, 16, 20,
                      1000) == "streamed"
    for S, H, N, layout in ((None, 5, 150, "wide"), (None, 60, 64, "block"),
                            (16, 5, 150, "wide"), (16, 20, 20, "rows")):
        assert M.kernel_layout(S, H, N) == layout
        assert M.layout_supports("cluster", S, H, N)
    assert M.LAYOUTS.index("cluster") == M.LAYOUTS.index("global") - 1


def test_bulk_copies_read_padded_aligned_rows():
    """Kernel B's cluster launch reads the returns a row of ``ldr`` floats
    at a time (a bulk copy takes 16-byte rows): N rounded up to 4, the
    returns copied with zero columns past N where N is not a multiple of
    4, in place where it is; one forecast passes the CTAs alone. A cluster
    that leaves a CTA without a row is refused before any launch."""
    for N, copied in ((1000, False), (1001, True), (150, True)):
        r = torch.rand(2, 3, 4, N) + 0.5
        rk, args = M._cluster_args(M.PDHG_LOG_UTILITY_SCENARIOS_CLUSTER, r,
                                   False, "streamed", 2, (2, 2))
        ldr = -(-N // 4) * 4
        assert args == (2, 2, 2, ldr) and rk.shape == (2, 3, 4, ldr)
        assert (rk is not r) is copied
        assert torch.equal(rk[..., :N], r)
        assert not rk[..., N:].any()
    r = torch.rand(2, 20, 1000)
    assert M._cluster_args(M.PDHG_LOG_UTILITY_CLUSTER, r, False, None, None,
                           None) == (r, (2,))
    with pytest.raises(ValueError, match="no cluster"):
        M._cluster_args(M.PDHG_LOG_UTILITY_CLUSTER, torch.rand(1, 5, 500),
                        False, None, 4, None)    # 2 rows a CTA: one empty


# ---------------------------------------------------------------------------
# The packed wrappers against kmpc_tpu's at routed shapes
# ---------------------------------------------------------------------------

# name: (S, H, N, bodies); B=2. Kernel A's adaptive body at two shapes of
# its own: at 2400 assets it parts at balancing ties (held by its spread on
# the card, chip_smoke.py's ``hold_spread``).
ROUTED = {
    "A_H5N2400": (None, 5, 2400, ("fixed", "pipe")),
    "A_H33N500": (None, 33, 500, ("fixed", "pipe")),
    "A_H16N760": (None, 16, 760, ("adaptive",)),
    "A_H32N400": (None, 32, 400, ("adaptive",)),
    "B_S16H33N128_resident": (16, 33, 128, ("fixed", "pipe", "adaptive")),
    "B_S16H5N1500_streamed": (16, 5, 1500, ("fixed", "pipe", "adaptive")),
}
BODIES = {"fixed": dict(proj_refresh_every=16),
          "pipe": PIPE, "adaptive": ACCURATE}
# chip_smoke.py's REFEREE_FACTOR: an adaptive objective past the bar may lie
# at most this many times as far from the float64 run as kmpc_tpu's float32
# kernel does, plus the bar.
REFEREE_FACTOR = 3.0


@pytest.mark.parametrize("name,body", [
    (name, body) for name, case in ROUTED.items() for body in case[3]])
def test_cluster_shape_matches_kmpc_tpu(name, body):
    """At a shape the port's card routes to the cluster layout, the port's
    packed wrapper meets the kernel-vs-XLA bars against kmpc_tpu's, with
    the dual output. kmpc_tpu's wrapper hands these shapes to its XLA
    solver (the working set misses VMEM); kernel A's pipelined and adaptive
    bodies are held against kmpc_tpu's Pallas kernel itself, in interpret
    mode at one 128-lane tile (its XLA solver has no pipelined body), at 48
    iterations. Kernel A's adaptive objective is held as chip_smoke.py holds
    an adaptive case: past the bar, the port must lie within the bar plus
    REFEREE_FACTOR times kmpc_tpu's own distance of the float64 run of the
    plain version (a 12000-term float32 problem part from its float64 run
    by up to 3e-5 in objective in kmpc_tpu's kernel, where weights agree
    within 1e-5)."""
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    S, H, N, _ = ROUTED[name]
    pallas = S is None and body != "fixed"
    kw = dict(BODIES[body], max_iters=48 if pallas else 120)
    p = _params(kw)
    assert M._route(S, H, N, p)[:2] == ("cluster", body)
    if S is not None:
        assert M.cluster_storage(S, H, N) == name.rsplit("_", 1)[1]
    assert JP._default_tile_b_packed(H, -(-N // 8) * 8, S=S) is None
    cw, ys = _log_inputs(2, H, N, 1901 + H + N, S)
    jsolve = (JP.solve_mpc_log_utility_pallas_packed if S is None
              else JP.solve_mpc_log_utility_scenarios_packed)
    tsolve = (M.solve_mpc_log_utility_packed if S is None
              else M.solve_mpc_log_utility_scenarios_packed)
    tile = dict(tile_b=128, interpret=True) if pallas else {}
    w_ref, info_ref = jsolve(jnp.asarray(cw), jnp.asarray(ys),
                             _params(kw, JParams), return_dual=True, **tile)
    w, info = tsolve(torch.as_tensor(cw), torch.as_tensor(ys), p,
                     device="cpu", return_dual=True)
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=W_TOL,
                               rtol=0)
    obj_tol = OBJ_TOL if S is None else SCEN_OBJ_TOL
    obj, obj_ref = info["objective"].numpy(), info_ref["objective"]
    if p.adaptive and S is None:
        r64 = torch.exp(torch.as_tensor(ys).double())
        cw64 = torch.as_tensor(cw).double()
        out = M.pdhg_log_utility_plain(cw64, r64, p)
        obj64 = M._finalize_packed(out[0], r64, cw64, p, out[1])[1][
            "objective"].numpy()
        apart = np.abs(obj - obj_ref) > obj_tol
        assert np.all(np.abs(obj - obj64)[apart] <= obj_tol + REFEREE_FACTOR
                      * np.abs(obj_ref - obj64)[apart]), (obj, obj_ref, obj64)
    else:
        np.testing.assert_allclose(obj, obj_ref, atol=obj_tol, rtol=0)
    for key in ("fixed_point_residual", "dual"):
        np.testing.assert_allclose(info[key].numpy(), info_ref[key],
                                   atol=W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])
    w64 = w.double().numpy()
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= FEAS_TOL) and w64.min() >= 0
    prev = np.concatenate([cw.astype(np.float64)[:, None], w64[:, :-1]], 1)
    assert np.all(np.abs(w64 - prev).sum(-1) <= p.max_turnover + FEAS_TOL)


# ---------------------------------------------------------------------------
# On a card: the cluster kernels give the wide-row kernels' bits
# ---------------------------------------------------------------------------

# name: (S, H, N, storage, params, CTAs); shapes the wide-row layout takes.
CUDA_CASES = {
    "A_H5N150_fixed": (None, 5, 150, None, dict(proj_refresh_every=16,
                                                precond=True), 2),
    "A_H5N150_pipe": (None, 5, 150, None, PIPE, 3),
    "A_H5N150_adaptive": (None, 5, 150, None, ACCURATE, 2),
    "A_H5N500_no_ball": (None, 5, 500, None, dict(max_turnover=0.0), 5),
    "B_S16H5N150_streamed": (16, 5, 150, "streamed", dict(), 2),
    "B_S16H5N150_resident_pipe": (16, 5, 150, "resident", PIPE, 3),
    "B_S5H5N141_streamed_adaptive": (5, 5, 141, "streamed", dict(
        adaptive=True, adapt_every=1), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cluster_layout_gives_the_wide_bits_on_the_card(name):
    """Launched privately at two or more CTAs a problem where the wide-row
    layout also takes the shape, the cluster kernel gives the wide-row
    kernel's bits (weights, fixed-point residual, dual, steps): the same
    operations in the same order, the rows split over a cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these cases)")
    S, H, N, storage, kw, ctas = CUDA_CASES[name]
    p = _params(dict(kw, max_iters=300))
    dev = torch.device("cuda")
    cw, ys = _log_inputs(6, H, N, 2001 + N, S)
    cw = torch.as_tensor(cw, device=dev)
    r = torch.exp(torch.as_tensor(ys, device=dev)).contiguous()
    body = M._body(p)
    outs = [M._launch(M._KERNELS[(S is not None, layout, body)], body, cw, r,
                      p, None, None, True, p.adaptive, storage=storage,
                      cluster_ctas=ctas if layout == "cluster" else None)
            for layout in ("wide", "cluster")]
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(*outs)]
    assert all(same), f"{name}: weights, fp, dual, steps equal: {same}"
