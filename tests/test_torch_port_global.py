"""The fifteenth slice of kmpc_tpu_torch against kmpc_tpu: every input
kmpc_tpu's packed solvers answer, answered by the port's packed wrappers.

kmpc_tpu's packed wrappers hand two kinds of input to their XLA solvers
(``_needs_xla_fallback`` and a working set past VMEM,
``_default_tile_b_packed``): ``allow_short`` and the shapes past the
kernel's budget. The port answers both on the card: the global layout
(``csrc/pdhg_log_utility{,_scenarios}_global{,_adaptive}.cu``,
``csrc/pdhg_mean_variance_global{,_adaptive}.cu``: the block layout's body
with its iterates in a global-memory workspace, a slot a CTA of a persistent
grid) takes every shape no other layout holds, and the block and global
layouts project on the hyperplane under ``allow_short`` by a flag.

On the CPU: the routing of every shape the port refused before, the
workspace's plan (``global_workspace_bytes``, ``mv_global_workspace_bytes``,
counted here by hand; chip_smoke.py holds them against the values the built
library reports), and the packed wrappers (the kernels' plain version on the
CPU) against kmpc_tpu's packed wrappers on the same numpy inputs at the
refused shapes and under ``allow_short``. On a card (marked ``cuda``, and
skipped here): the global layout at a shape the block layout also takes,
at a batch past its persistent grid, gives the block kernel's bits. JAX is imported only inside the comparisons,
so that

    python -m pytest tests/test_torch_port_global.py -m cuda --noconftest

runs the card's test on a machine without it.

Bars (the repository's kernel-vs-XLA bars, tests/test_mpc_pallas.py):
log-utility and scenarios objective <= 1e-5, weights, duals and the
fixed-point residual <= 5e-4; mean-variance objective <= 1e-6, weights and
the fixed-point residual <= 5e-5; equal ``converged``.
"""

import numpy as np
import pytest
import torch

from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams

OBJ_TOL, W_TOL = 1e-5, 5e-4
MV_OBJ_TOL, MV_W_TOL = 1e-6, 5e-5
FEAS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: one torch thread, as in
    test_torch_port_mv_block.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, "gamma": 5.0, **kw})


def _log_inputs(B, H, N, seed, S=None):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    shape = (B, H, N) if S is None else (B, S, H, N)
    ys = (rng.standard_normal(shape) * 0.01
          + (0.0005 if S is None else 0.0)).astype(np.float32)
    return cw, ys


def _mv_inputs(B, H, N, seed, shared):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N) if shared else (B, N, N)) * 0.05
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4
    # A slightly asymmetric input: the wrappers symmetrise it first.
    sig = sig + 1e-5 * np.triu(np.ones((N, N)), 1)
    return cw, mu, sig.astype(np.float32)


# ---------------------------------------------------------------------------
# Routing: a layout for every shape
# ---------------------------------------------------------------------------

# The shapes kernel_layout / mv_kernel_layout gave None at before the global
# layout, (S, H, N); S None is one forecast.
REFUSED = {
    "one_forecast": [(None, 5, 2400), (None, 8, 1500), (None, 10, 1500),
                     (None, 20, 1000), (None, 32, 500), (None, 33, 500),
                     (None, 60, 500), (None, 128, 128), (None, 252, 64)],
    "scenarios": [(16, 5, 1500), (16, 8, 1000), (16, 20, 500),
                  (16, 33, 128), (16, 128, 20),
                  (16, 252, 1000), (512, 20, 1000)],
    "mean_variance": [(None, 5, 2400), (None, 20, 1000), (None, 33, 500),
                      (None, 60, 500), (None, 252, 1000)],
}


@pytest.mark.parametrize("group", list(REFUSED))
def test_every_shape_the_port_refused_routes_to_a_layout(group):
    """Each shape the port refused before routes to the cluster layout's
    kernel of its body where a cluster of at most 8 CTAs holds it (kernels
    A and B) or of up to 16 CTAs (kernel C), else to the global layout's
    (the shape
    picks the layout, the parameters the body), and every shape of a grid
    gets a layout; only S, H or N below 1 gets None."""
    bodies = [MPCParams(), MPCParams(adaptive=True, adapt_every=2),
              MPCParams(pipeline_reduces=True, proj_refresh_every=16)]
    for S, H, N in REFUSED[group]:
        if group == "mean_variance":
            want = "cluster" if V.mv_cluster_supports(H, N) else "global"
            for shared in (False, True):
                assert V.mv_kernel_layout(H, N, shared) == want
                for p in bodies[:2]:
                    assert V._mv_route(H, N, p, shared, B=1028) == (
                        want, V._MV_KERNELS[(want, p.adaptive)])
            continue
        want = "cluster" if M.cluster_kernel_supports(S, H, N) else "global"
        assert M.kernel_layout(S, H, N) == want, (S, H, N)
        for p in bodies:
            layout, body, kernel = M._route(S, H, N, p)
            assert layout == want and kernel is M._KERNELS[
                (S is not None, want, body)]
            assert kernel in (M._CLUSTER if want == "cluster" else M._GLOBAL)
    if group == "scenarios":   # past a cluster of 8 CTAs' shared memory
        assert M.kernel_layout(16, 252, 1000) == "global"
    for S in (None, 1, 16, 512):
        for H in (1, 5, 20, 33, 128, 252):
            for N in (1, 20, 129, 500, 1000, 2400):
                assert M.kernel_layout(S, H, N) in M.LAYOUTS
                assert M.kernel_layout(S, H, N, allow_short=True) in \
                    M.SHORT_LAYOUTS
                if S is None:
                    assert V.mv_kernel_layout(H, N) in (
                        "lanes", "tile", "block", "global", "cluster")
    assert M.kernel_layout(None, 0, 20) is None
    assert V.mv_kernel_layout(5, 0) is None
    with pytest.raises(ValueError, match="at least 1"):
        M._route(16, 5, 0, MPCParams())
    with pytest.raises(ValueError, match="at least 1"):
        V._mv_route(0, 20, MPCParams())


def test_allow_short_routes_to_the_block_and_global_layouts():
    """``allow_short`` takes the block layout where one problem fits a
    block's shared memory, else the global layout (the two project on the
    hyperplane by a flag); the other layouts refuse it. It carries no
    threshold, so it never runs the pipelined body."""
    short = MPCParams(allow_short=True, pipeline_reduces=True,
                      proj_refresh_every=16)
    assert M._route(None, 5, 20, short)[:2] == ("block", "fixed")
    assert M._route(16, 5, 20, short)[:2] == ("block", "fixed")
    assert M._route(None, 20, 1000, short)[:2] == ("global", "fixed")
    assert M._route(16, 20, 500, short)[2] is M.PDHG_LOG_UTILITY_SCENARIOS_GLOBAL
    adaptive = MPCParams(allow_short=True, adaptive=True)
    assert M._route(None, 5, 20, adaptive)[2] is \
        M.PDHG_LOG_UTILITY_BLOCK_ADAPTIVE
    assert M._sweep_budgets(short, 20)[0] is False
    for layout in ("rows", "warp", "wide"):
        assert not M.layout_supports(layout, None, 5, 20, allow_short=True)
    assert M.layout_supports("global", None, 5, 20, allow_short=True)
    assert V._mv_route(1, 20, MPCParams(allow_short=True)) == (
        "block", V.PDHG_MEAN_VARIANCE_BLOCK)
    assert V._mv_route(20, 1000, MPCParams(allow_short=True,
                                           adaptive=True)) == (
        "global", V.PDHG_MEAN_VARIANCE_GLOBAL_ADAPTIVE)


# ---------------------------------------------------------------------------
# The workspace's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,N,grid,slot,smem", [
    # slot: w, p, the projection and dual inputs, 4 H N; smem: 8 H + 2 S H
    # + 4 + (block_threads(N) / 32) (S H + 3 H), or 0 and in the slot where
    # it exceeds a block's shared memory.
    (None, 20, 1000, 132, 4 * 20000, 160 + 40 + 4 + 16 * 80),
    (16, 20, 500, 264, 4 * 10000, 160 + 640 + 4 + 16 * 380),
    (16, 5, 1500, 1, 4 * 7500, 40 + 160 + 4 + 16 * 95),
    (None, 252, 64, 132, 4 * 16128, 2016 + 504 + 4 + 2 * 1008),
    (16, 252, 1000, 7, 4 * 252000 + (2016 + 8064 + 4 + 16 * 4788), 0),
    (512, 20, 1000, 3, 4 * 20000 + (160 + 20480 + 4 + 16 * 10300), 0),
])
def test_global_workspace_matches_the_plan(S, H, N, grid, slot, smem):
    """``global_workspace_bytes`` and ``global_smem_bytes`` against the
    kernel's plan (``global_plan`` in csrc/pdhg_log_utility_block.cuh,
    counted here by hand): grid slots of the four [H][N] iterates, the
    small plan in shared memory where it fits a block's, else in the slot.
    The returns and the current weights are read in place, so the slot
    does not grow with S where the small plan fits."""
    assert M.global_smem_bytes(S, H, N) == 4 * smem
    assert M.global_workspace_bytes(S, H, N, grid) == 4 * slot * grid
    assert 4 * smem <= M.SMEM_PER_BLOCK


@pytest.mark.parametrize("H,N,grid,slot,smem", [
    # slot: 4 H N; smem: H + 4 + (block_threads(N) / 32) 2 H.
    (20, 1000, 132, 80000, 20 + 4 + 16 * 40),
    (33, 500, 264, 66000, 33 + 4 + 16 * 66),
    (5, 2400, 1, 48000, 5 + 4 + 16 * 10),
    (1800, 500, 2, 4 * 900000 + (1800 + 4 + 16 * 3600), 0),
])
def test_mv_global_workspace_matches_the_plan(H, N, grid, slot, smem):
    """``mv_global_workspace_bytes`` and ``mv_global_smem_bytes`` against
    ``mv_global_plan`` in csrc/pdhg_mean_variance_block.cuh, counted by
    hand; mu, the current weights and Sigma are read in place."""
    assert V.mv_global_smem_bytes(H, N) == 4 * smem
    assert V.mv_global_workspace_bytes(H, N, grid) == 4 * slot * grid


# ---------------------------------------------------------------------------
# The packed wrappers against kmpc_tpu's at the refused shapes
# ---------------------------------------------------------------------------


def _check_log(w, info, w_ref, info_ref, cw, p):
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    info = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in info.items()}
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=W_TOL,
                               rtol=0)
    np.testing.assert_allclose(info["objective"], info_ref["objective"],
                               atol=OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"],
                               info_ref["fixed_point_residual"], atol=W_TOL,
                               rtol=0)
    if "dual" in info_ref:
        np.testing.assert_allclose(info["dual"], info_ref["dual"],
                                   atol=W_TOL, rtol=0)
    assert np.array_equal(info["converged"], info_ref["converged"])
    _check_feasible(w, cw, p)


def _check_feasible(w, cw, p, capped=True):
    """The sum, the turnover cap where the program has one (the
    mean-variance program has none), the sign only without shorts."""
    w64 = w.double().numpy()
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= FEAS_TOL)
    if p.allow_short:
        assert w64.min() < -1e-6     # shorts do occur
    else:
        assert np.all(w64 >= 0)
    if capped and p.max_turnover > 0:
        prev = np.concatenate([cw.astype(np.float64)[:, None], w64[:, :-1]],
                              1)
        assert np.all(np.abs(w64 - prev).sum(-1)
                      <= p.max_turnover + FEAS_TOL)


def _log_case(B, S, H, N, kw, seed, warm=False, dual=False):
    """The port's packed wrapper (the plain version, on the CPU) against
    kmpc_tpu's on the same inputs; with ``warm`` both continue for a
    quarter of the budget from the port's first solve's iterates."""
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    cw, ys = _log_inputs(B, H, N, seed, S)
    p = _params(kw)
    jsolve = (JP.solve_mpc_log_utility_pallas_packed if S is None
              else JP.solve_mpc_log_utility_scenarios_packed)
    tsolve = (M.solve_mpc_log_utility_packed if S is None
              else M.solve_mpc_log_utility_scenarios_packed)
    warm_kw, jwarm_kw = {}, {}
    if warm:
        from dataclasses import replace

        w0, i0 = tsolve(torch.as_tensor(cw), torch.as_tensor(ys), p,
                        device="cpu", return_dual=True)
        p = replace(p, max_iters=p.max_iters // 4)
        kw = {**kw, "max_iters": p.max_iters}
        warm_kw = dict(w_warm=w0, p_warm=i0["dual"])
        jwarm_kw = {k: jnp.asarray(v.numpy()) for k, v in warm_kw.items()}
    w_ref, info_ref = jsolve(jnp.asarray(cw), jnp.asarray(ys),
                             _params(kw, JParams), return_dual=dual,
                             **jwarm_kw)
    w, info = tsolve(torch.as_tensor(cw), torch.as_tensor(ys), p,
                     device="cpu", return_dual=dual, **warm_kw)
    _check_log(w, info, w_ref, info_ref, cw, p)


def _mv_case(B, H, N, shared, kw, seed):
    import jax.numpy as jnp

    from kmpc_tpu.ops import mpc_pallas as JP
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    cw, mu, sig = _mv_inputs(B, H, N, seed, shared)
    p = _params(kw)
    w_ref, info_ref = JP.solve_mpc_mean_variance_pallas_packed(
        jnp.asarray(cw), jnp.asarray(mu), jnp.asarray(sig),
        _params(kw, JParams), interpret=True)
    w, info = V.solve_mpc_mean_variance_packed(
        torch.as_tensor(cw), torch.as_tensor(mu), torch.as_tensor(sig), p,
        device="cpu")
    info_ref = {k: np.asarray(v) for k, v in info_ref.items()}
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=MV_W_TOL,
                               rtol=0)
    np.testing.assert_allclose(info["objective"].numpy(),
                               info_ref["objective"], atol=MV_OBJ_TOL, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"].numpy(),
                               info_ref["fixed_point_residual"],
                               atol=MV_W_TOL, rtol=0)
    assert np.array_equal(info["converged"].numpy(), info_ref["converged"])
    _check_feasible(w, cw, p, capped=False)


# name: (S, H, N); B=2, 400 iterations
REFUSED_CASES = {
    "A_H20N1000": (None, 20, 1000),
    "B_S16H20N500": (16, 20, 500),
}


@pytest.mark.parametrize("name", list(REFUSED_CASES))
def test_refused_log_utility_shape_matches_kmpc_tpu(name):
    """At a shape kmpc_tpu's wrapper hands to its XLA solver (its working
    set misses VMEM) and the port's card routes to the cluster layout (the
    global layout before it), the port's packed wrapper meets the
    kernel-vs-XLA bars against it."""
    from kmpc_tpu.ops import mpc_pallas as JP

    S, H, N = REFUSED_CASES[name]
    assert JP._default_tile_b_packed(H, -(-N // 8) * 8, S=S) is None
    assert M.kernel_layout(S, H, N) == "cluster"
    _log_case(2, S, H, N, dict(max_iters=400), 1501 + N)


@pytest.mark.parametrize("shared", [False, True])
def test_refused_mean_variance_shape_matches_kmpc_tpu(shared):
    """Kernel C at H=20 N=1000, a covariance per problem and one shared:
    kmpc_tpu's wrapper hands it to its XLA solver, the port's card to the
    cluster layout (the global layout before it); the port's packed
    wrapper meets the bars against it."""
    H, N = 20, 1000
    assert V.mv_kernel_layout(H, N, shared) == "cluster"
    assert V.mv_kernel_layout(H, N, shared, B=1013) == "cluster"
    _mv_case(2, H, N, shared, dict(max_iters=400), 1601 + int(shared))


# ---------------------------------------------------------------------------
# allow_short against kmpc_tpu's packed wrappers
# ---------------------------------------------------------------------------

# name: (B, S, H, N, params, warm, dual); the log-utility solvers
SHORT_CASES = {
    "log_H5N10": (4, None, 5, 10, dict(max_iters=400), False, False),
    "log_H5N10_warm_dual": (4, None, 5, 10, dict(max_iters=400), True, True),
    "log_H5N10_adaptive": (4, None, 5, 10, dict(
        max_iters=400, adaptive=True, adapt_every=2, precond=True), False,
        True),
    "log_H5N10_no_ball": (3, None, 5, 10, dict(max_iters=400,
                                                max_turnover=0.0),
                          False, False),
    "scenarios_S3H5N10": (4, 3, 5, 10, dict(max_iters=400), False, True),
    "log_H20N1000_global": (2, None, 20, 1000, dict(max_iters=400), False,
                            False),
}


@pytest.mark.parametrize("name", list(SHORT_CASES))
def test_allow_short_log_utility_matches_kmpc_tpu(name):
    """``allow_short`` (the hyperplane projection, no threshold carried):
    the port's packed wrapper against kmpc_tpu's, which hands it to its XLA
    solver, under the kernel-vs-XLA bars; warm inputs and the dual output
    too. Shorts do occur, and every row sums to 1 within the turnover cap."""
    B, S, H, N, kw, warm, dual = SHORT_CASES[name]
    _log_case(B, S, H, N, dict(kw, allow_short=True), 1701 + N + H, warm,
              dual)


@pytest.mark.parametrize("adaptive", [False, True])
def test_allow_short_mean_variance_matches_kmpc_tpu(adaptive):
    kw = dict(max_iters=400, allow_short=True, adaptive=adaptive,
              adapt_every=2)
    _mv_case(4, 3, 8, False, kw, 1801)


# ---------------------------------------------------------------------------
# On a card: the global layout gives the block layout's bits
# ---------------------------------------------------------------------------

# name: (S, H, N, params); shapes the block layout also takes. S "C" is
# kernel C with a covariance per problem.
CUDA_CASES = {
    "A_H20N30": (None, 20, 30, dict(max_iters=300, proj_refresh_every=16)),
    "A_H5N150_adaptive": (None, 5, 150, dict(max_iters=300, adaptive=True,
                                              adapt_every=2)),
    "A_H5N20_short": (None, 5, 20, dict(max_iters=300, allow_short=True)),
    "B_S4H5N40": (4, 5, 40, dict(max_iters=300)),
    "C_H20N30": ("C", 20, 30, dict(max_iters=300)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_global_layout_gives_the_block_bits_on_the_card(name):
    """At a batch past the global kernel's persistent grid (every CTA
    solves two or three problems in turn through its workspace slot), the
    global layout gives the block layout's bits on every problem."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these cases)")
    S, H, N, kw = CUDA_CASES[name]
    p = _params(kw)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B = 2 * sms * M.GLOBAL_CTAS_PER_SM + 5
    if S == "C":
        cw, mu, sig = (torch.as_tensor(x, device=dev)
                       for x in _mv_inputs(B, H, N, 1901 + N, False))
        sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
        kernels = [V._MV_KERNELS[(layout, p.adaptive)]
                   for layout in ("block", "global")]
        outs = [V._mv_launch(k, cw, mu, sig, p, return_steps=p.adaptive)
                for k in kernels]
        shape = (H, N)
    else:
        cw, ys = _log_inputs(B, H, N, 1901 + N, S)
        cw = torch.as_tensor(cw, device=dev)
        r = torch.exp(torch.as_tensor(ys, device=dev)).contiguous()
        body = M._body(p)
        kernels = [M._KERNELS[(S is not None, layout, body)]
                   for layout in ("block", "global")]
        outs = [M._launch(k, body, cw, r, p, None, None, True, p.adaptive)
                for k in kernels]
        shape = (S or 0, H, N)
    torch.cuda.synchronize()
    assert B > M.global_grid(kernels[1], B, shape, p.allow_short, dev)
    assert all(torch.equal(x, y) for x, y in zip(*outs))
