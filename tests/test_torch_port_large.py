"""The fourth slice of kmpc_tpu_torch against kmpc_tpu: the pipelined body
(``make_trip_pipe``, ``pipeline_reduces``) and the shapes past one warp's
registers (H=20, N=150), which the port solves in its block-per-problem
kernels; the routing of every shape that kmpc_tpu's packed wrappers send to
their Pallas kernel; and the Jacobi backtest at H=20 with the pipeline
configuration.

The JAX reference is the Pallas wrapper in interpret mode on the CPU, as
tests/test_mpc_pallas.py runs it; the port runs each kernel's plain
PyTorch version through its CPU entry point (on the CPU a wrapper takes the
plain version only because the tensor lies there; the block and warp
kernels share it). Inputs are made with numpy from a seed.

Bars (those of tests/test_torch_port_kernels.py): weights and duals
<= 5e-4, objective <= 1e-5 (scenario: 5e-5), status codes equal outside a
10% band around feas_tol; the backtest's portfolio values rtol 1e-3 (those
of tests/test_torch_port_backtest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmpc_tpu.ops import mpc_pallas as JP
from kmpc_tpu.ops.mpc import MPCParams as JParams
from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops.mpc import MPCParams

W_TOL, OBJ_TOL, SCEN_OBJ_TOL = 5e-4, 1e-5, 5e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(kw, cls=MPCParams):
    return cls(**{"sigma_scale": 2.0, **kw})


def _inputs(B, H, N, seed, S=None):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    shape = (B, H, N) if S is None else (B, S, H, N)
    ys = (rng.standard_normal(shape) * 0.01
          + (0.0005 if S is None else 0.0)).astype(np.float32)
    return cw, ys


def _pallas(cw, ys, kw, **extra):
    solve = (JP.solve_mpc_log_utility_pallas_packed if ys.ndim == 3
             else JP.solve_mpc_log_utility_scenarios_packed)
    w, info = solve(jnp.asarray(cw), jnp.asarray(ys), _params(kw, JParams),
                    tile_b=128, interpret=True, return_dual=True, **extra)
    return np.asarray(w), {k: np.asarray(v) for k, v in info.items()}


def _port(cw, ys, kw, **extra):
    solve = (M.solve_mpc_log_utility_packed if ys.ndim == 3
             else M.solve_mpc_log_utility_scenarios_packed)
    return solve(_t(cw), _t(ys), _params(kw), device="cpu", return_dual=True,
                 **extra)


def _check(w, info, w_ref, info_ref, cw, kw, obj_tol=OBJ_TOL):
    p = _params(kw)
    w = w.numpy()
    info = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in info.items()}
    assert set(info) == set(info_ref)
    np.testing.assert_allclose(w, w_ref, atol=W_TOL, rtol=0)
    np.testing.assert_allclose(info["dual"], info_ref["dual"], atol=W_TOL,
                               rtol=0)
    np.testing.assert_allclose(info["objective"], info_ref["objective"],
                               atol=obj_tol, rtol=0)
    np.testing.assert_allclose(info["fixed_point_residual"],
                               info_ref["fixed_point_residual"], atol=W_TOL,
                               rtol=0)
    near = np.abs(info_ref["fixed_point_residual"] - p.feas_tol) \
        <= 0.1 * p.feas_tol
    assert np.array_equal(info["status_code"][~near],
                          info_ref["status_code"][~near])
    w64 = w.astype(np.float64)
    assert np.all(np.abs(w64.sum(-1) - 1.0) <= 1e-5) and np.all(w64 >= 0)
    if p.max_turnover > 0:
        prev = np.concatenate([cw.astype(np.float64)[:, None], w64[:, :-1]], 1)
        assert np.all(np.abs(w64 - prev).sum(-1) <= p.max_turnover + 1e-6)


# ---------------------------------------------------------------------------
# The pipelined body, H=5, N=20
# ---------------------------------------------------------------------------

PIPE = dict(pipeline_reduces=True)

# name: (B, S, params). Refresh 8 and 16 give one trip length (min(k, 8));
# 301 iterations leave a remainder of synchronous iterations.
PIPE_CASES = {
    "r16_it300": (6, None, dict(max_iters=300, proj_refresh_every=16)),
    "r16_it301": (6, None, dict(max_iters=301, proj_refresh_every=16)),
    "r8_it300_precond": (6, None, dict(max_iters=300, proj_refresh_every=8,
                                       precond=True)),
    "r8_it301_no_ball": (6, None, dict(max_iters=301, proj_refresh_every=8,
                                       max_turnover=0.0)),
    "r16_ridge_precond": (5, None, dict(max_iters=300, proj_refresh_every=16,
                                        precond=True, ridge=1e-3,
                                        feas_tol=3e-4)),
    # Over-relaxation: see test_pipelined_over_relaxation_does_not_settle.
    "r16_over_relax_it100": (6, None, dict(max_iters=100,
                                           proj_refresh_every=16,
                                           over_relax=1.5)),
    "S4_r16_precond": (6, 4, dict(max_iters=300, proj_refresh_every=16,
                                  precond=True)),
    "S4_r8_it301_no_ball": (6, 4, dict(max_iters=301, proj_refresh_every=8,
                                       max_turnover=0.0)),
}


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_pipelined_body_matches_pallas(name):
    B, S, kw = PIPE_CASES[name]
    kw = dict(kw, **PIPE)
    assert M._pipelined(_params(kw))
    cw, ys = _inputs(B, 5, 20, seed=101 + len(name), S=S)
    w_ref, info_ref = _pallas(cw, ys, kw)
    w, info = _port(cw, ys, kw)
    _check(w, info, w_ref, info_ref, cw, kw,
           OBJ_TOL if S is None else SCEN_OBJ_TOL)


@pytest.mark.parametrize("S", [None, 3])
def test_pipelined_warm_continuation_matches_pallas(S):
    """A quarter of the budget from the Pallas first solve's (primal, dual)
    on both sides: the ball's threshold and l1 restart from 0."""
    kw = dict(max_iters=300, proj_refresh_every=16, precond=True, **PIPE)
    cw, ys = _inputs(6, 5, 20, seed=131, S=S)
    w1, i1 = _pallas(cw, ys, kw)
    kw2 = dict(kw, max_iters=75)
    w2, i2 = _pallas(cw, ys, kw2, w_warm=jnp.asarray(w1),
                     p_warm=jnp.asarray(i1["dual"]))
    w, info = _port(cw, ys, kw2, w_warm=_t(w1), p_warm=_t(i1["dual"]))
    _check(w, info, w2, i2, cw, kw2, OBJ_TOL if S is None else SCEN_OBJ_TOL)


def test_pipelined_body_differs_from_the_refresh_body():
    """The pipelined body is its own iteration: the same budget without
    ``pipeline_reduces`` ends elsewhere, and with a zero-length run both
    are the cold start's half-step."""
    cw, ys = _inputs(5, 5, 20, seed=7)
    kw = dict(max_iters=200, proj_refresh_every=16)
    r = torch.exp(_t(ys))
    piped = M.pdhg_log_utility_plain(_t(cw), r, _params(dict(kw, **PIPE)))[0]
    cond = M.pdhg_log_utility_plain(_t(cw), r, _params(kw))[0]
    assert (piped - cond).abs().max().item() > 1e-6
    zero = dict(kw, max_iters=0)
    assert torch.equal(
        M.pdhg_log_utility_plain(_t(cw), r, _params(dict(zero, **PIPE)))[0],
        M.pdhg_log_utility_plain(_t(cw), r, _params(zero))[0])


def test_pipelined_over_relaxation_does_not_settle():
    """With over-relaxation 1.5 the pipelined iteration keeps moving in both
    packages (the stale ball threshold overshoots): at 301 iterations its
    fixed-point residual stays several times the refresh body's, so two
    float32 realisations of it part by more than rounding (which is why
    the parity case above runs 100 iterations). Both packages show it."""
    cw, ys = _inputs(6, 5, 20, seed=4)
    kw = dict(max_iters=301, proj_refresh_every=16, over_relax=1.5)
    _, info_j = _pallas(cw, ys, dict(kw, **PIPE))
    _, info_t = _port(cw, ys, dict(kw, **PIPE))
    _, info_c = _port(cw, ys, kw)
    fp_c = info_c["fixed_point_residual"].max().item()
    assert info_t["fixed_point_residual"].max().item() > 3 * fp_c
    assert info_j["fixed_point_residual"].max() > 3 * fp_c


# ---------------------------------------------------------------------------
# Shapes past one warp's registers: the block layout's plain version
# ---------------------------------------------------------------------------

ACCURATE = dict(adaptive=True, adapt_every=2, precond=True)

# name: (B, H, N, params)
BLOCK_CASES = {
    "H20N12_cond": (4, 20, 12, dict(max_iters=300, proj_refresh_every=16,
                                    precond=True)),
    "H20N12_pipe": (4, 20, 12, dict(max_iters=301, proj_refresh_every=16,
                                    **PIPE)),
    "H20N12_adaptive": (4, 20, 12, dict(max_iters=300, **ACCURATE)),
    "H3N150_body": (4, 3, 150, dict(max_iters=300)),
    "H3N150_pipe": (4, 3, 150, dict(max_iters=300, proj_refresh_every=8,
                                    precond=True, **PIPE)),
    "H3N150_adaptive": (4, 3, 150, dict(max_iters=300, **ACCURATE)),
    # One forecast past four slots, each body: the wide-row layout's
    # shapes.
    "H3N160_wide_body": (3, 3, 160, dict(max_iters=60)),
    "H3N160_wide_pipe": (3, 3, 160, dict(max_iters=59, proj_refresh_every=8,
                                         precond=True, **PIPE)),
    "H3N160_wide_adaptive": (3, 3, 160, dict(max_iters=60, **ACCURATE)),
}


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_block_layout_shapes_match_pallas(name):
    B, H, N, kw = BLOCK_CASES[name]
    # Past the warp layout's registers: the row layout takes 20 rows of 12
    # assets, the wide-row layout 150 and 160 assets.
    assert M.kernel_layout(None, H, N) == ("rows" if N <= 128 else "wide")
    cw, ys = _inputs(B, H, N, seed=151 + H + N)
    w_ref, info_ref = _pallas(cw, ys, kw)
    w, info = _port(cw, ys, kw)
    _check(w, info, w_ref, info_ref, cw, kw)


# ---------------------------------------------------------------------------
# Routing: every shape kmpc_tpu's kernel admits reaches a CUDA kernel
# ---------------------------------------------------------------------------

# (adaptive, warm, dual) and the extra [H, NP, 128] VMEM blocks kmpc_tpu's
# packed wrappers declare for them (mpc_pallas.py _default_tile_b_packed's
# callers: 2 for the warm inputs, 1 for the dual, 3 for the adaptive body).
FLAGS = [(a, w, d) for a in (False, True) for w in (False, True)
         for d in (False, True)]


@pytest.mark.parametrize("S", [None, 1, 4, 16, 64, 256])
def test_every_shape_the_pallas_kernel_admits_routes_to_a_cuda_kernel(S):
    """Over a grid of (H, N) and every (adaptive, warm, dual): where
    kmpc_tpu's ``_default_tile_b_packed`` admits the shape to its Pallas
    kernel, ``kernel_layout`` names a CUDA kernel; the row layout wherever
    it fits (only at ceil(N/32) <= 4 and H <= 32, any S), else the
    wide-row layout where it fits and is preferred, else the block layout
    where it holds the problem, else the wide-row layout where it fits;
    never the warp layout; and the block layout's own budget is its shared
    memory."""
    routed = {"warp": 0, "rows": 0, "wide": 0, "block": 0}
    Hs = list(range(1, 25)) + [32, 33, 40, 64, 100, 200]
    Ns = list(range(1, 70, 3)) + [96, 128, 129, 136, 150, 200, 256, 257,
                                  300, 500, 512, 513, 546, 600, 1000, 2730]
    for H in Hs:
        for N in Ns:
            NP = (N + 7) // 8 * 8
            warp_fits = M.kernel_supports(H, N) and (
                S is None or M.scenario_kernel_supports(S, H, N))
            rows_fit = M.rows_kernel_supports(S, H, N)
            assert not rows_fit or (-(-N // 32) <= 4 and H <= 32), (S, H, N)
            layout = M.kernel_layout(S, H, N)
            if rows_fit:
                assert layout == "rows", (S, H, N)
            elif warp_fits:
                assert layout == "warp", (S, H, N)
            elif M.wide_kernel_supports(S, H, N) and M.wide_preferred(
                    H, N, S):
                assert layout == "wide", (S, H, N)
            elif M.block_smem_bytes(S, H, N) <= M.SMEM_PER_BLOCK:
                assert layout == "block", (S, H, N)
            elif M.wide_kernel_supports(S, H, N):
                assert layout == "wide", (S, H, N)
            for adaptive, warm, dual in FLAGS:
                extra = 2 * warm + dual + 3 * adaptive
                if JP._default_tile_b_packed(H, NP, S=S,
                                             extra_blocks=extra) is None:
                    continue
                assert layout in ("warp", "rows", "wide", "block"), (
                    S, H, N, adaptive, warm, dual)
                routed[layout] += 1
    assert routed["rows"] > 0 and routed["warp"] == 0
    # At S=256 every shape kmpc_tpu's kernel admits is small enough for the
    # row layout.
    assert (routed["block"] > 0 and routed["wide"] > 0) == (
        S is None or S <= 64)


@pytest.mark.parametrize("S", [None, 16])
def test_a_cuda_tensor_beyond_both_layouts_raises(S):
    """The route the CUDA wrapper takes before any launch: a shape beyond
    every single CTA's shared memory (which raised until the global layout
    took it) routes to the cluster layout's kernel of the body where a
    cluster of at most 8 CTAs holds it, else to the global layout's."""
    H = 20
    for N, layout in ((2000, "cluster"), (5000, "global")):
        assert M.kernel_layout(S, H, N) == layout
        for p, body in ((MPCParams(), "fixed"),
                        (_params(ACCURATE), "adaptive")):
            assert M._route(S, H, N, p) == (
                layout, body, M._KERNELS[(S is not None, layout, body)])
    # The shape picks the layout, the parameters the body.
    pipe = _params(dict(proj_refresh_every=16, **PIPE))
    assert M._route(S, 5, 20, pipe)[:2] == ("rows", "pipe")
    assert M._route(S, 17, 20, pipe)[:2] == ("rows", "pipe")
    assert M._route(S, 17, 20, _params(ACCURATE))[:2] == (
        "rows", "adaptive")
    assert M._route(S, 20, 30, MPCParams())[:2] == ("rows", "fixed")


# ---------------------------------------------------------------------------
# The Jacobi backtest at H=20 with the pipeline configuration
# ---------------------------------------------------------------------------


def test_jacobi_backtest_at_horizon_20_with_the_pipeline_configuration():
    """Koopman-MPC by 3 Jacobi sweeps over 48 dates of 8 assets at H=20,
    ``PROJ_REFRESH_EVERY=16``, ``PIPELINE_REDUCES``, ``PRECOND`` and 300
    iterations, the settings built by each package's ``backtest_settings``
    path from a config, in both packages (kmpc_tpu's fused kernel in
    interpret mode): portfolio values rtol 1e-3."""
    import kmpc_tpu.config as jcfg
    import kmpc_tpu_torch.config as tcfg
    from kmpc_tpu.backtest import engine as J
    from kmpc_tpu.ops.mpc import mpc_params_from_config as jparams
    from kmpc_tpu_torch.backtest import engine as T
    from kmpc_tpu_torch.run_experiment import backtest_settings

    import test_torch_port_backtest as BT

    H = 20
    cfgs = []
    for cfgmod in (jcfg, tcfg):
        cfg = cfgmod.get_config("finance_sparse")
        cfg.MPC.SOLVER.PROJ_REFRESH_EVERY = 16
        cfg.MPC.SOLVER.PIPELINE_REDUCES = True
        cfg.MPC.SOLVER.PRECOND = True
        cfg.MPC.SOLVER.MAX_ITERS = 300
        cfgs.append(cfg)
    bt_t, mpc_t = backtest_settings(cfgs[1], horizon=H)
    assert bt_t.HORIZON == H and mpc_t.horizon == H
    assert M._pipelined(mpc_t) and mpc_t.max_iters == 300
    mpc_j = jparams(cfgs[0], horizon=H, sigma_scale=2.0)
    assert mpc_j.pipeline_reduces and mpc_j.proj_refresh_every == 16
    jm, params, tm = BT.build_models()
    fd_j, fd_t = BT._finance_data("jax"), BT._finance_data("torch")
    n_dates = fd_t.test.shape[0] - fd_t.sequence_length - H
    dj = J.run_backtest_parallel(
        J.KoopmanMPCStrategy(model=jm, params=params, mpc=mpc_j,
                             use_fused_kernel=True),
        fd_j, jcfg.BacktestConfig(HORIZON=H), num_sweeps=BT.SWEEPS)
    dt = T.run_backtest_parallel(
        T.KoopmanMPCStrategy(model=tm, mpc=mpc_t), fd_t, bt_t,
        num_sweeps=BT.SWEEPS)
    assert len(dj) == len(dt) == n_dates
    np.testing.assert_allclose(dt["portfolio_value"].to_numpy(),
                               dj["portfolio_value"].to_numpy(), rtol=1e-3)
    assert dt["turnover"].to_numpy()[1:].max() > 1e-4


def test_cli_takes_a_run_config_and_horizon_20(tmp_path, monkeypatch):
    """``python -m kmpc_tpu_torch.run_experiment --config ... --horizon 20``
    on the CPU at a tiny budget: the run config's pipeline settings and the
    horizon reach every strategy's solver (the same settings the five
    strategies are built from), fresh full-width weights."""
    import json

    import kmpc_tpu_torch.config as tcfg
    from kmpc_tpu_torch import run_experiment as R

    cfg = tcfg.get_config("finance_sparse")
    cfg.MPC.SOLVER.PROJ_REFRESH_EVERY = 16
    cfg.MPC.SOLVER.PIPELINE_REDUCES = True
    cfg.MPC.SOLVER.PRECOND = True
    cfg.to_json(str(tmp_path / "config.json"))
    seen = []
    build = R.build_strategies

    def spy(model, mpc, mv_mpc, lookback, scenarios=0, fused=True):
        seen.append((mpc, mv_mpc))
        return build(model, mpc, mv_mpc, lookback, scenarios, fused)

    monkeypatch.setattr(R, "build_strategies", spy)
    monkeypatch.chdir(tmp_path)
    results = R.main(["--cpu", "--config", str(tmp_path / "config.json"),
                      "--horizon", "20", "--mpc_iters", "16", "--parallel",
                      "--sweeps", "1",
                      "--output", str(tmp_path / "out")])
    assert list(results) == ["BuyAndHold", "Markowitz", "DMD", "KoopmanMPC"]
    (mpc, mv_mpc), = seen
    assert mpc.horizon == 20 and M._pipelined(mpc) and mpc.precond
    assert mpc.max_iters == 16 and mv_mpc.horizon == 1
    assert M.kernel_layout(None, 20, 20) == "rows"
    for metrics in results.values():
        assert np.isfinite(metrics["Final Value"])
    assert json.loads((tmp_path / "out" / "experiment_results.json")
                      .read_text()) == results
    with pytest.raises(SystemExit):
        R.main(["--cpu", "--config", "c.json", "--path", "run"])


# ---------------------------------------------------------------------------
# The adaptive body at 500 assets sits at float32's limit
# ---------------------------------------------------------------------------


def _finalized_plain(cw, r, p, dtype=torch.float32, perm=None):
    """The plain version's finalised weights [B, H, N] in float64, its
    objectives and its step histories (the last column of the steps), run
    in ``dtype`` with the assets in the order ``perm`` (the weights put back
    in the original order)."""
    order = torch.arange(cw.shape[-1]) if perm is None else perm
    out = M.pdhg_log_utility_plain(
        cw[:, order].to(dtype), r[..., order].to(dtype), p,
        return_steps=p.adaptive)
    w = out[0][..., torch.argsort(order)].double()
    w, info = M._finalize_packed(w, r.double(), cw.double(), p,
                                 out[1].double())
    history = out[-1][:, -1].double() if p.adaptive else None
    return w, info["objective"], history


def test_adaptive_body_at_500_assets_is_at_float32s_limit():
    """The evidence for the bars of the block-layout adaptive kernels at
    N=500 (chip_smoke.py: the kernel's simplex sums within twice the plain
    version's, and the float64 referee): at H=5, N=500, 400 iterations,
    adaptive k=2 and precond, the adaptive steps grow until a 500-term
    float32 sum is off by ~1e-5. The float32 plain version then parts from
    itself in float64, and from a float32 run with the assets permuted, by
    1e-5-scale objectives while all three step histories agree, and its
    simplex sums are off by ~1e-5; the fixed-step body's are not."""
    B, H, N = 4, 5, 500
    p = _params(dict(max_iters=400, **ACCURATE))
    p_fixed = _params(dict(max_iters=400, proj_refresh_every=16,
                           precond=True))
    readings = {"obj_vs_float64": [], "obj_vs_permuted": [],
                "w_vs_float64": [], "simplex": [], "simplex_fixed": []}
    for seed in (40, 41, 42):
        cw, ys = _inputs(B, H, N, seed)
        cw, r = _t(cw), torch.exp(_t(ys))
        perm = torch.randperm(N, generator=torch.Generator().manual_seed(seed))
        w32, obj32, hist32 = _finalized_plain(cw, r, p)
        w64, obj64, hist64 = _finalized_plain(cw, r, p, torch.float64)
        _, obj_perm, hist_perm = _finalized_plain(cw, r, p, perm=perm)
        w_fixed, _, _ = _finalized_plain(cw, r, p_fixed)
        assert torch.equal(hist32, hist64) and torch.equal(hist32, hist_perm)
        readings["obj_vs_float64"].append((obj32 - obj64).abs().max().item())
        readings["obj_vs_permuted"].append(
            (obj32 - obj_perm).abs().max().item())
        readings["w_vs_float64"].append((w32 - w64).abs().max().item())
        readings["simplex"].append((w32.sum(-1) - 1).abs().max().item())
        readings["simplex_fixed"].append(
            (w_fixed.sum(-1) - 1).abs().max().item())
    print(readings)
    for key in ("obj_vs_float64", "obj_vs_permuted", "simplex"):
        assert 5e-6 <= min(readings[key]) and max(readings[key]) <= 5e-5, (
            key, readings[key])
    assert max(readings["w_vs_float64"]) <= W_TOL
    assert max(readings["simplex_fixed"]) <= 1e-6, readings["simplex_fixed"]


def _chip_smoke():
    """chip_smoke.py as a module: its bars run on any device."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _standin_outputs(seed, fault=0.0, problem=None):
    """Plain-version outputs at H=5, N=500 (B=4, 400 iterations, adaptive
    k=2, precond) and a stand-in kernel's: the plain version run with the
    assets permuted (another float32 realisation of the same solver, with
    the same step histories), with ``fault`` of weight moved in every row
    (of ``problem`` only, if given) from its largest holding to its lowest
    return."""
    B, H, N = 4, 5, 500
    p = _params(dict(max_iters=400, **ACCURATE))
    cw, ys = _inputs(B, H, N, seed)
    cw, r = _t(cw), torch.exp(_t(ys))
    out_p = M.pdhg_log_utility_plain(cw, r, p, return_dual=True,
                                     return_steps=True)
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(seed))
    inv = torch.argsort(perm)
    w, fp, dual, steps = M.pdhg_log_utility_plain(
        cw[:, perm], r[..., perm], p, return_dual=True, return_steps=True)
    w = w[..., inv].clone()
    move = torch.full((B, H, 1), fault)
    if problem is not None:
        move[torch.arange(B) != problem] = 0.0
    w.scatter_add_(-1, w.argmax(-1, keepdim=True), -move)
    w.scatter_add_(-1, r.argmin(-1, keepdim=True), move)
    return cw, r, p, (w, fp, dual[..., inv], steps), out_p


def test_float64_referee_holds_another_float32_realisation():
    """chip_smoke.py's bars for an adaptive log-utility case, on the CPU,
    with a stand-in kernel that is a correct float32 solver: at N=500 it
    misses the fixed-step objective bar (1e-5) against the plain version
    with equal step histories, and the float64 referee holds it."""
    C = _chip_smoke()
    cw, r, p, out_k, out_p = _standin_outputs(40)
    res = {}
    C.hold_to_plain("standin", cw, r, p, {}, out_k, out_p, res)
    assert res["decisions_parted"] == 0 and res["max_abs_dobj"] > C.OBJ_TOL
    assert res["held_by_float64_referee"] >= 1
    assert res["kernel_apart_from_float64"] <= \
        res["plain_apart_from_float64"] + 2


@pytest.mark.parametrize("fault", [0.0, 1e-2])
def test_wide_referee_holds_each_problem_to_its_own_noise(fault):
    """chip_smoke.py's bars for a ``wide`` case (the block path's adaptive
    body), on the CPU, with the stand-in kernel: held as it is; with 1e-2 of
    weight moved in every row of one problem whose step histories are
    equal (about twice a typical weight at N=150), refused."""
    C = _chip_smoke()
    cw, r, p, out_k, out_p = _standin_outputs(40, fault=fault, problem=1)
    res = {}
    if not fault:
        C.hold_to_plain("standin", cw, r, p, {}, out_k, out_p, res, wide=True)
        assert res["decisions_parted"] == 0
        assert res["held_by_float64_referee"] >= 1
        return
    with pytest.raises(AssertionError, match="equal step histories"):
        C.hold_to_plain("planted", cw, r, p, {}, out_k, out_p, res,
                        wide=True)


@pytest.mark.parametrize("fault", [0.0, 1e-2])
def test_one_problems_float32_noise_does_not_widen_anothers(fault):
    """The referee of a ``wide`` case on distances as an H100 showed them:
    one problem (0) whose permuted plain run lies 4.4e-3 from the float64
    run in weights, as the kernel does, is held; a kernel 1e-2 from it on
    another problem (1), whose plain runs lie within 2e-5, is refused,
    where a case-wide noise of 4.4e-3 would have held it (3 x 4.4e-3 plus
    the bar is 1.4e-2)."""
    C = _chip_smoke()
    B = 4
    steps = torch.zeros(B, 3)
    d_plain = torch.tensor([2e-5, 1e-5, 1e-5, 1e-5], dtype=torch.float64)
    d_perm = torch.tensor([4.4e-3, 2e-5, 1e-5, 1e-5], dtype=torch.float64)
    d_kernel = torch.tensor([4.4e-3, fault or 2e-5, 1e-5, 1e-5],
                            dtype=torch.float64)
    small = torch.full((B,), 1e-7, dtype=torch.float64)

    def referee():
        return ((small, d_kernel, small), (small, d_plain, small),
                torch.ones(B, dtype=torch.bool), (small, d_perm, small))

    dw = torch.tensor([4.4e-3, fault or 2e-5, 0.0, 0.0])
    zeros = torch.zeros(B)
    res = {}
    args = ("t", steps, steps, dw, zeros, zeros, W_TOL, OBJ_TOL,
            C.FLIP_OBJ_TOL, res, referee)
    if not fault:
        held = C.adaptive_agreement(*args)
        assert res["held_by_float64_referee"] == 1 and not held[0]
        return
    with pytest.raises(AssertionError, match="equal step histories"):
        C.adaptive_agreement(*args)


@pytest.mark.parametrize("seed", [40, 41])
def test_float64_referee_rejects_a_planted_objective_fault(seed):
    """The same stand-in with 4.5e-4 of weight moved in every row, within
    the weight bar: its objectives move by 4e-6 to 8e-5 from the plain
    version's with equal step histories (about 3x the float32 noise at
    most), and the float64 referee refuses it."""
    C = _chip_smoke()
    cw, r, p, out_k, out_p = _standin_outputs(seed, fault=4.5e-4)
    w_k, _ = M._finalize_packed(out_k[0], r, cw, p, out_k[1])
    w_p, _ = M._finalize_packed(out_p[0], r, cw, p, out_p[1])
    assert (w_k - w_p).abs().max().item() <= W_TOL
    with pytest.raises(AssertionError, match="equal step histories"):
        C.hold_to_plain("planted", cw, r, p, {}, out_k, out_p, {})
