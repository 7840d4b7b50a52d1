"""The tenth slice of kmpc_tpu_torch against kmpc_tpu: kernel C (the
mean-variance solve) at one horizon row in the lane layout
(``csrc/pdhg_mean_variance_lanes{,_adaptive}.cu``): one warp per problem,
Sigma's row in the lane's registers up to 32 assets, w broadcast through a
per-warp shared vector, the simplex threshold's sweeps in every lane in one
fixed order (or by the warp butterfly at large batches); and the MV ladder
(``csrc/mv_ladder.cu``) rebuilt on that body.

On the CPU: the lane plan (``mv_lanes_plan``, counted here by hand;
chip_smoke.py holds it against the value the built library reports), the
ladder's plan, the routing over (B, N, shared, body) at H=1 and the sweep by
batch, a numpy float32 model of the in-lane sweep's order against the port's
``michelot_sweep`` and kmpc_tpu's ``_packed_threshold``, and the plain
version against kmpc_tpu's Pallas kernel (interpret mode) at two shapes the
lane layout takes. On a card (marked ``cuda``, and skipped here): the lane
kernels against the plain version at the plan's edges, in each sweep compiled
for N (both up to 32 assets, the butterfly past), twice
for the same bits; JAX is imported only inside the Pallas comparisons, so

    python -m pytest tests/test_torch_port_mv_lanes.py -m cuda --noconftest

runs them on a machine without it (the suite's conftest.py imports JAX).

Bars (the repository's mean-variance kernel-vs-XLA bars): weights and the
fixed-point residual <= 5e-5, objective <= 1e-6, equal ``converged``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops import mv_ladder as D
from kmpc_tpu_torch.ops.mpc import MPCParams
from kmpc_tpu_torch.ops.projections import michelot_threshold

MV_W_TOL, MV_OBJ_TOL = 5e-5, 1e-6
NEG = np.float32(-1e30)
EDGE_N = (1, 20, 30, 31, 32, 33, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: one torch thread, as in
    test_torch_port_mv_block.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, N, seed, shared, scale=0.05):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, 1, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N) if shared else (B, N, N)) * scale
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4
    # A slightly asymmetric input: the wrappers symmetrise it first.
    sig = sig + 1e-5 * np.triu(np.ones((N, N)), 1)
    return cw, mu, sig.astype(np.float32)


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, "gamma": 5.0, **kw})


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,shared,warps,floats", [
    # Two vectors a warp (N rounded up to 8 within one slot, else 32 K
    # floats each), four warps; past 32 assets Sigma's N columns of 32 K
    # floats per warp (as many warps as fit a block) or once a CTA.
    (1, False, 4, 4 * 2 * 8),
    (20, False, 4, 4 * 2 * 24),
    (20, True, 4, 4 * 2 * 24),
    (30, False, 4, 4 * 2 * 32),
    (32, True, 4, 4 * 2 * 32),
    (33, False, 4, 4 * (2 * 64 + 33 * 64)),
    (33, True, 4, 4 * 2 * 64 + 33 * 64),
    (64, False, 4, 4 * (2 * 64 + 64 * 64)),
    (100, False, 4, 4 * (2 * 128 + 100 * 128)),
    (128, False, 3, 3 * (2 * 128 + 128 * 128)),
    (128, True, 4, 4 * 2 * 128 + 128 * 128),
])
def test_lanes_plan(N, shared, warps, floats):
    """``mv_lanes_plan`` against the kernel's plan (``mv_lanes_plan`` in
    csrc/pdhg_mean_variance_lanes.cuh, counted here by hand)."""
    assert V.mv_lanes_plan(N, shared) == (warps, 4 * floats)
    assert 4 * floats <= V.SMEM_PER_BLOCK


@pytest.mark.parametrize("N", [0, 129, 200, 960])
def test_lanes_plan_refuses_what_it_does_not_take(N):
    assert V.mv_lanes_plan(N, False) is None
    assert V.mv_lanes_plan(N, True) is None


@pytest.mark.parametrize("N,chains,warps,rows,floats", [
    # Each chain's two vectors (one slot's row 24 or 32 floats wide, else
    # 32 K); Sigma's N columns of 32 K floats per chain where the chains'
    # register rows would pass 64 floats a lane.
    (20, 1, 4, True, 4 * 2 * 24),
    (20, 2, 4, True, 4 * 2 * 2 * 24),
    (20, 4, 2, False, 2 * 4 * (2 * 24 + 20 * 32)),
    (8, 4, 2, False, 2 * 4 * (2 * 24 + 8 * 32)),
    (30, 2, 8, True, 8 * 2 * 2 * 32),
    (30, 4, 2, False, 2 * 4 * (2 * 32 + 30 * 32)),
    (33, 1, 4, False, 4 * (2 * 64 + 33 * 64)),
    (100, 2, 2, False, 2 * 2 * (2 * 128 + 100 * 128)),
])
def test_ladder_plan(N, chains, warps, rows, floats):
    """The ladder's rows in registers or Sigma in shared memory
    (``ladder_rows``) and a block's shared memory (``ladder_block_bytes``)
    against csrc/mv_ladder.cu's plan, counted by hand; its covariances'
    part keeps ``ladder_smem_bytes``."""
    assert D.ladder_rows(N, chains) is rows
    assert D.ladder_block_bytes(N, chains, warps) == 4 * floats
    assert D.ladder_smem_bytes(N, chains, warps) == (
        0 if rows else warps * chains * N * 32 * -(-N // 32) * 4)


def test_ladder_refuses_an_unknown_sweep():
    cw, mu, sig = (torch.as_tensor(x) for x in D.ladder_inputs(3, 12))
    with pytest.raises(ValueError, match="sweep"):
        D.mv_ladder_cuda(cw, mu, sig, "proj", 8, sweep="tree")
    cw, mu, sig = (torch.as_tensor(x) for x in D.ladder_inputs(3, 33))
    with pytest.raises(ValueError, match="up to 32 assets"):
        D.mv_ladder_cuda(cw, mu, sig, "proj", 8, sweep="inlane")


# ---------------------------------------------------------------------------
# Routing at one horizon row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_routing_at_one_row(shared, adaptive):
    """At H=1 every N the lane plan takes (up to 128 assets: the shapes
    of the warp layout, ``mv_kernel_supports``) routes to the lane layout,
    for any batch; past it the tile or block layout, or with a covariance
    per problem past the block layout's staging the cluster layout; the
    lane kernel of the
    body; the sweep in every lane up to LANES_INLANE_MAX_B problems, by
    the butterfly past it."""
    p = MPCParams(adaptive=adaptive)
    for B in (1, 7, 1028, 4096, 65536):
        for N in (1, 8, 20, 30, 31, 32, 33, 64, 100, 128, 129, 320, 960):
            layout = V.mv_kernel_layout(1, N, shared, adaptive, B)
            assert (layout == "lanes") == (N <= 128), (B, N)
            assert (layout == "lanes") == V.mv_kernel_supports(1, N)
            if layout == "lanes":
                assert V._mv_route(1, N, p, shared, B) == (
                    "lanes", V._MV_KERNELS[("lanes", adaptive)])
            elif not shared and not V.mv_sigma_staged(1, N):
                assert layout == "cluster", (B, N, layout)
            else:
                assert layout in ("tile", "block"), (B, N, layout)
        want = "inlane" if B <= V.LANES_INLANE_MAX_B else "butterfly"
        assert V.mv_lanes_sweep(B, 30) == want
        assert V.mv_lanes_sweep(B, 33) == "butterfly"
    # Past one row the lane layout takes nothing.
    for H in (2, 5, 20):
        assert V.mv_kernel_layout(H, 20, shared, adaptive, 1028) != "lanes"


def test_the_markowitz_path_and_headline_route_to_the_lane_kernels():
    """The comparison's Markowitz solve (B=1028, H=1, N=20), the exact
    scan's (B=1) and bench.py's ``--mode markowitz`` (B=65536, N=30), each
    body: the lane kernels, in-lane at the paths' batches and by the
    butterfly at bench.py's."""
    for B, N in ((1028, 20), (1, 20), (65536, 30)):
        for adaptive in (False, True):
            layout, kernel = V._mv_route(1, N, MPCParams(adaptive=adaptive),
                                         False, B)
            assert layout == "lanes"
            assert kernel.name == "pdhg_mean_variance_lanes" + (
                "_adaptive" if adaptive else "")
    assert V.mv_lanes_sweep(1028, 20) == V.mv_lanes_sweep(1, 20) == "inlane"
    assert V.mv_lanes_sweep(65536, 30) == "butterfly"


def test_routing_error_names_the_lane_budget():
    """A shape past every shared-memory plan (which raised, naming the lane
    layout's budget, before the global layout) routes to the cluster layout
    where a cluster holds it, else to the global layout; only a shape
    below one row or asset raises."""
    assert V._mv_route(20, 800, MPCParams()) == (
        "cluster", V.PDHG_MEAN_VARIANCE_CLUSTER)
    assert V._mv_route(252, 1000, MPCParams()) == (
        "global", V.PDHG_MEAN_VARIANCE_GLOBAL)
    with pytest.raises(ValueError, match="at least 1"):
        V._mv_route(0, 800, MPCParams())


def test_a_launch_refuses_an_unknown_sweep():
    """The sweep is checked before anything is built or launched."""
    cw, mu, sig = (torch.as_tensor(x) for x in _inputs(2, 20, 1, False))
    with pytest.raises(ValueError, match="sweep"):
        V._mv_launch(V.PDHG_MEAN_VARIANCE_LANES, cw, mu, sig, MPCParams(),
                     sweep="tree")


def test_the_in_lane_sweep_is_compiled_up_to_one_slot():
    """Both sweeps up to 32 assets, the butterfly alone past them; a launch
    asking for the in-lane sweep past one slot is refused before anything
    is built or launched."""
    for N in (1, 20, 30, 32):
        assert V.mv_lanes_sweeps(N) == V.LANES_SWEEPS
    for N in (33, 64, 100, 128):
        assert V.mv_lanes_sweeps(N) == ("butterfly",)
        for B in (1, 7, 1028, 65536):
            assert V.mv_lanes_sweep(B, N) in V.mv_lanes_sweeps(N)
    for N in (33, 128):
        cw, mu, sig = (torch.as_tensor(x) for x in _inputs(2, N, 1, False))
        with pytest.raises(ValueError, match="sweep 'inlane'"):
            V._mv_launch(V.PDHG_MEAN_VARIANCE_LANES, cw, mu, sig,
                         MPCParams(), sweep="inlane")


def test_chip_smoke_checks_and_times_the_lane_layout():
    """chip_smoke.py holds the lane plan against the built library over
    the plan's edges, times the lane layout at the path's, the scan's and
    bench.py's markowitz shapes, and both sweeps where the switch lies."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    assert set(EDGE_N) | {129} <= set(C.LANES_PLAN_N)
    timed = {s[:4] for s in C.mv_layout_shapes()}
    for shape in ((1028, 1, 20, False), (1, 1, 20, False),
                  (65536, 1, 30, False), (4096, 1, 30, False)):
        assert shape in timed, shape
    assert C.MARKOWITZ[:3] == (65536, 1, 30)


# ---------------------------------------------------------------------------
# The in-lane sweep's order
# ---------------------------------------------------------------------------


def lanes_vec(N):
    return -(-N // 8) * 8 if N <= 32 else 32 * -(-N // 32)


def inlane_threshold(v, N, n, theta=None):
    """The lane layout's in-lane threshold in numpy float32, in its order:
    the V staged values (kNeg past N), value j into partial j % 4, the
    partials summed as (0 + 1) + (2 + 3); a cold start (the sum of the
    unmasked values - 1) / N where ``theta`` is None; n sweeps (the sum of
    the values above theta - 1) / max(their count, 1)."""
    f = np.float32
    x = np.full(lanes_vec(N), NEG, np.float32)
    x[:N] = v
    if theta is None:
        s = [f(0)] * 4
        for j, xj in enumerate(x):
            s[j % 4] = f(s[j % 4] + (xj if xj > f(0.5) * NEG else f(0)))
        theta = f(f(f(s[0] + s[1]) + f(s[2] + s[3])) - f(1)) / f(N)
    theta = f(theta)
    for _ in range(n):
        c, s = [f(0)] * 4, [f(0)] * 4
        for j, xj in enumerate(x):
            a = xj > theta
            c[j % 4] = f(c[j % 4] + (f(1) if a else f(0)))
            s[j % 4] = f(s[j % 4] + (xj if a else f(0)))
        cnt = f(f(c[0] + c[1]) + f(c[2] + c[3]))
        tot = f(f(s[0] + s[1]) + f(s[2] + s[3]))
        theta = f(f(tot - f(1)) / max(cnt, f(1)))
    return theta


def _jax_threshold(v, N, n, theta=None):
    """kmpc_tpu's ``_packed_threshold`` on one problem's values (asset axis
    padded to a multiple of 8 with its mask value)."""
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP

    NP = -(-N // 8) * 8
    vm = np.full((1, NP, 1), NEG, np.float32)
    vm[0, :N, 0] = v
    th0 = None if theta is None else jnp.full((1, 1, 1), theta, jnp.float32)
    return np.float32(np.asarray(JP._packed_threshold(
        jnp.asarray(vm), 1.0, n, theta0=th0, n_valid=float(N)))[0, 0, 0])


@settings(max_examples=40, deadline=None)
@given(st.sampled_from((1, 20, 30, 32, 33, 64, 128)),
       st.integers(0, 2 ** 31 - 1), st.sampled_from((1, 3, 8)),
       st.booleans())
def test_inlane_sweep_against_both_packages(N, seed, n, cold):
    """The in-lane threshold's projection max(v - theta, 0) against the
    port's ``michelot_threshold`` and kmpc_tpu's ``_packed_threshold`` on
    the same float32 values, cold or from a carried theta, within the
    mean-variance weight bar."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(N) * 0.05 + 1.0 / N).astype(np.float32)
    theta0 = None if cold else np.float32(rng.uniform(-0.05, 0.05))
    th = inlane_threshold(v, N, n, theta0)
    th_port = michelot_threshold(
        torch.as_tensor(v)[None], 1.0, n,
        None if cold else torch.full((1, 1), float(theta0))).item()
    th_jax = _jax_threshold(v, N, n, theta0)
    w = np.maximum(v - th, 0)
    for ref in (th_port, th_jax):
        assert np.abs(w - np.maximum(v - np.float32(ref), 0)).max() \
            <= MV_W_TOL, (N, n, cold, th, ref)


@pytest.mark.parametrize("N", EDGE_N)
def test_inlane_sweep_reaches_the_projection(N):
    """Enough in-lane sweeps from the cold start give the simplex
    projection: nonnegative weights that sum to 1 within float32."""
    rng = np.random.default_rng(N)
    v = (rng.standard_normal(N) * 0.1 + 1.0 / N).astype(np.float32)
    w = np.maximum(v - inlane_threshold(v, N, 16), 0)
    assert abs(float(w.astype(np.float64).sum()) - 1.0) <= 1e-5
    assert (w >= 0).all()


# ---------------------------------------------------------------------------
# The plain version against kmpc_tpu's Pallas kernel at lane shapes
# ---------------------------------------------------------------------------

# name: (B, N, shared, params)
CASES = {
    "N20_refresh": (4, 20, False, dict(max_iters=300,
                                       proj_refresh_every=16)),
    "N33_shared_adaptive_k2": (3, 33, True, dict(
        max_iters=300, adaptive=True, adapt_every=2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lane_shapes_match_pallas(name):
    # JAX inside the test: the card's tests below run without it.
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    B, N, shared, kw = CASES[name]
    p = _params(kw)
    assert V.mv_kernel_layout(1, N, shared, p.adaptive, B) == "lanes"
    cw, mu, sig = _inputs(B, N, 1001 + N, shared)
    w_ref, info_ref = JP.solve_mpc_mean_variance_pallas_packed(
        jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
        _params(kw, JParams), interpret=True)
    w, info = V.solve_mpc_mean_variance_packed(
        torch.as_tensor(cw), torch.as_tensor(mu), torch.as_tensor(sig), p,
        device="cpu")
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=MV_W_TOL,
                               rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], atol=MV_OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"].numpy(),
                               info_ref["fixed_point_residual"],
                               atol=MV_W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])


# ---------------------------------------------------------------------------
# On a card: the lane kernels against the plain version
# ---------------------------------------------------------------------------

# name: (B, N, shared, params): the plan's edges (N = 1, 31, 32, 33, 128),
# bench.py's N=30 with the adaptive body, B=1 and a ragged last CTA (B=7,
# four warps a CTA), both bodies; each in the sweeps compiled for N.
CUDA_CASES = {
    "N1": (5, 1, False, dict(max_iters=300)),
    "N20_B1_adaptive_k2": (1, 20, False, dict(
        max_iters=400, adaptive=True, adapt_every=2)),
    "N20_shared_B7_refresh16": (7, 20, True, dict(
        max_iters=400, proj_refresh_every=16)),
    "N31_cold_proj": (6, 31, False, dict(max_iters=300, proj_warm_iters=0)),
    "N30_B6_adaptive_k2": (6, 30, False, dict(
        max_iters=400, adaptive=True, adapt_every=2)),
    "N32_over_relax": (6, 32, False, dict(max_iters=400, over_relax=1.5)),
    "N33_shared_adaptive_k1": (5, 33, True, dict(
        max_iters=300, adaptive=True, adapt_every=1)),
    "N128_B7": (7, 128, False, dict(max_iters=300)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name, sweep", [
    (name, sweep) for name, case in CUDA_CASES.items()
    for sweep in V.mv_lanes_sweeps(case[1])])
def test_lane_kernel_matches_plain_on_the_card(name, sweep):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these cases)")
    B, N, shared, kw = CUDA_CASES[name]
    p = _params(kw)
    cw, mu, sig = (torch.as_tensor(x, device="cuda")
                   for x in _inputs(B, N, 1101 + N, shared, scale=0.01))
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    kernel = V._MV_KERNELS[("lanes", p.adaptive)]
    runs = [V._mv_launch(kernel, cw, mu, sig, p, sweep=sweep)
            for _ in range(2)]
    plain = V.pdhg_mean_variance_plain(cw, mu, sig, p)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    wk, ik = V._finalize_mv(*runs[0], mu, sig, cw, p)
    wp, ip = V._finalize_mv(*plain, mu, sig, cw, p)
    assert (ik["objective"] - ip["objective"]).abs().max().item() \
        <= MV_OBJ_TOL
    if not p.adaptive:
        assert (wk - wp).abs().max().item() <= MV_W_TOL


# (variant, unroll, chains, warps, B, N, iters): Sigma's rows in registers
# (one and two chains, 24 and 32 floats wide) and in shared memory (four
# chains, past 32 assets), a batch no multiple of the chains.
LADDER_CUDA = [("carry", 4, 2, 4, 9, 20, 60), ("sigma", 4, 1, 4, 9, 20, 60),
               ("sigma", 1, 4, 2, 9, 20, 61), ("proj", 4, 2, 2, 7, 30, 80),
               ("proj", 4, 4, 1, 9, 16, 80), ("proj", 4, 4, 2, 9, 20, 80),
               ("proj", 1, 1, 4, 5, 33, 41), ("proj", 4, 2, 1, 5, 128, 40),
               ("proj", 4, 1, 4, 7, 8, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", V.LANES_SWEEPS)
@pytest.mark.parametrize("rung", LADDER_CUDA, ids=str)
def test_ladder_matches_plain_on_the_card(rung, sweep):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these cases)")
    variant, unroll, chains, warps, B, N, iters = rung
    if sweep == "inlane" and (variant != "proj" or N > 32):
        sweep = "butterfly"
    cw, mu, sig = (torch.as_tensor(x, device="cuda").contiguous()
                   for x in D.ladder_inputs(B, N))
    wk = D.mv_ladder_cuda(cw, mu, sig, variant, iters, unroll, chains, warps,
                          sweep)
    again = D.mv_ladder_cuda(cw, mu, sig, variant, iters, unroll, chains,
                             warps, sweep)
    wp = D.mv_ladder_plain(cw, mu, sig, variant, iters, unroll)
    torch.cuda.synchronize()
    assert torch.equal(wk, again)
    assert (wk - wp).abs().max().item() <= MV_W_TOL
