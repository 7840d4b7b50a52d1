"""kmpc_tpu_torch against kmpc_tpu: the evaluation suite, its figures and
the systems' post-training evaluation.

Both packages run on the CPU from kmpc_tpu's initial weights (carried by
``utils/params.py``); the port's evaluation takes kmpc_tpu's initial
states through its seam (``_evaluate_system``), as its own are drawn by a
torch generator. Bars: the same metric structure, equal ``num_valid`` and
``best_periodic`` modes, every value within 1e-5 relative, the Lyapunov
basin assignments equal.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.data.systems import make_system as jsystem
from kmpc_tpu.eval import evaluation as JE
from kmpc_tpu.models import make_model as jmake
from kmpc_tpu.ops.rollout import rollout as jrollout
from kmpc_tpu_torch.data.systems import make_system as tsystem
from kmpc_tpu_torch.eval import evaluation as TE
from kmpc_tpu_torch.models.koopman import make_model as tmake
from kmpc_tpu_torch.utils.params import params_from_jax

REL = 1e-5
SMALL = dict(horizons=(10, 30), batch_size=8, periodic_reencode_periods=(5, 10))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    both = np.isfinite(a) & np.isfinite(b)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    assert np.all(np.abs(a[both] - b[both])
                  <= rel * np.maximum(np.abs(b[both]), 1e-12))


def _models(env, target=8):
    jc, tc = jcfg.get_config("generic"), tcfg.get_config("generic")
    for c in (jc, tc):
        c.MODEL.TARGET_SIZE = target
        c.ENV.ENV_NAME = env
    obs = jsystem(jc, env).observation_size
    jm = jmake(jc, obs)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tmake(tc, obs, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return jc, tc, jm, params, tm.eval()


SQUARED = [
    np.array([[1.0, np.nan, 2.0], [3.0, np.nan, np.inf], [0.5, 1.0, 1.0]]),
    np.full((4, 2), np.nan),
    np.array([[np.inf, 1.0], [np.inf, 2.0]]),
    np.abs(np.random.default_rng(0).standard_normal((7, 5))),
]


@pytest.mark.parametrize("i", range(len(SQUARED)))
@pytest.mark.parametrize("horizon", [1, 2, 100])
def test_horizon_mse_and_curve_match_kmpc_tpu(i, horizon):
    sq = SQUARED[i]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = JE.compute_horizon_mse(sq, horizon)
        want_curve = JE.cumulative_mse_curve(sq)
    got = TE.compute_horizon_mse(sq, horizon)
    assert got[3] == want[3]
    _close(got[:2], want[:2])
    _close(got[2], want[2])
    _close(TE.cumulative_mse_curve(sq), want_curve)


def _jax_evaluation(env):
    """kmpc_tpu's evaluate_model at the small settings, its initial states
    and the port's evaluation of the same states."""
    jc, tc, jm, params, tm = _models(env)
    js = JE.EvaluationSettings(systems=(env,), **SMALL)
    want = JE.evaluate_model(jm, params, jc, js, verbose=False)[env]
    x0 = np.asarray(jsystem(jc, env).reset(
        jax.random.PRNGKey(jc.SEED + js.seed_offset), js.batch_size))
    ts = TE.EvaluationSettings(systems=(env,), **SMALL)
    got = TE._evaluate_system(tm, tsystem(tc, env), ts, torch.tensor(x0),
                              None, False)
    return jc, jm, params, tm, want, got


@pytest.mark.parametrize("env", ["duffing", "lyapunov"])
def test_evaluate_model_matches_kmpc_tpu(env):
    jc, jm, params, tm, want, got = _jax_evaluation(env)
    assert set(got) == set(want) | ({"basins"} if env == "lyapunov" else set())
    assert got["files"] == want["files"] == {}
    assert list(got["modes"]) == list(want["modes"])
    for mode, w in want["modes"].items():
        g = got["modes"][mode]
        assert set(g) == set(w) and list(g["horizons"]) == list(w["horizons"])
        for hk, wh in w["horizons"].items():
            gh = g["horizons"][hk]
            assert set(gh) == set(wh)
            assert gh["num_valid"] == wh["num_valid"], (mode, hk)
            _close([gh["mean"], gh["std"]], [wh["mean"], wh["std"]])
            _close(gh["values"], wh["values"])
        _close(g["mse_curve"], w["mse_curve"])
    assert set(got["best_periodic"]) == set(want["best_periodic"])
    for hk, w in want["best_periodic"].items():
        assert got["best_periodic"][hk]["mode"] == w["mode"]
        _close(got["best_periodic"][hk]["mean"], w["mean"])


def test_lyapunov_basins_match_kmpc_tpu():
    """The basin grid of ``_save_lyapunov_comparison`` (15 x 15 initial
    states in [-2.5, 2.5]^2, 2000 steps), computed by kmpc_tpu's functions,
    against the port's ``lyapunov_basins``."""
    from scipy.spatial import cKDTree

    jc, tc, jm, params, tm = _models("lyapunov")
    grid = np.linspace(-2.5, 2.5, 15)
    xx, yy = np.meshgrid(grid, grid)
    bx0 = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1), jnp.float32)
    true_traj = np.asarray(jsystem(jc, "lyapunov").trajectory(bx0, 2000))
    pred_traj = np.asarray(jrollout(jm, params, bx0, 2000, 1))
    attractors = JE._estimate_attractors(true_traj)
    got = TE.lyapunov_basins(tm, tsystem(tc, "lyapunov"))
    # kmpc_tpu's np.unique keeps a rounded -0.0 beside 0.0 (one attractor
    # twice); the port counts it once. The same points either way.
    assert ({tuple(p) for p in got["true_attractors"]}
            == {tuple(p) for p in attractors + 0.0})
    tree = cKDTree(attractors)
    for traj, key in ((true_traj, "true_assignment"),
                      (pred_traj, "learned_assignment")):
        finals = traj[-1]
        ok = np.all(np.isfinite(finals), axis=-1)
        _, want = tree.query(np.clip(finals[ok], -10, 10))
        # Each initial state assigned the same attractor (by its point).
        np.testing.assert_array_equal(
            got["true_attractors"][got[key][ok]], attractors[want] + 0.0)
        assert np.all(got[key][~ok] == -1)
    assert got["agreement"] == np.mean(got["true_assignment"]
                                       == got["learned_assignment"])


@pytest.mark.parametrize("env", ["duffing", "lyapunov"])
def test_figures_are_written_where_matplotlib_imports(env, tmp_path):
    pytest.importorskip("matplotlib")
    _, tc, _, _, tm = _models(env)
    res = TE.evaluate_model(tm, tc, TE.EvaluationSettings(systems=(env,),
                                                          **SMALL),
                            output_dir=tmp_path, verbose=False)
    files = res[env]["files"]
    assert "mse_curve" in files and "error_curve_combined" in files
    if env == "lyapunov":
        assert {"basin_assignment", "phase_portrait_comparison"} <= set(files)
    for path in files.values():
        assert (tmp_path / env / path.split("/")[-1]).exists(), path
    saved = json.loads((tmp_path / "metrics.json").read_text())
    assert set(saved) == {env} and saved[env]["files"] == files


def test_no_figures_without_matplotlib(monkeypatch, tmp_path):
    """Without matplotlib the evaluation warns, draws nothing, and its
    metrics and metrics.json are what they are with it."""
    _, tc, _, _, tm = _models("duffing")
    settings = TE.EvaluationSettings(systems=("duffing",), **SMALL)
    with_figures = TE.evaluate_model(tm, tc, settings, verbose=False)

    def missing():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(TE, "_mpl", missing)
    with pytest.warns(UserWarning, match="matplotlib"):
        res = TE.evaluate_model(tm, tc, settings, output_dir=tmp_path,
                                verbose=False)
    assert res["duffing"]["files"] == {}
    assert res["duffing"]["modes"] == with_figures["duffing"]["modes"]
    assert json.loads((tmp_path / "metrics.json").read_text())["duffing"][
        "modes"] == res["duffing"]["modes"]


def test_train_system_final_eval_writes_both_results(monkeypatch, tmp_path):
    """``train_system(final_eval=True)`` evaluates the last and best
    checkpoints (EvaluationSettings' defaults) and leaves the trained
    model as it was."""
    from kmpc_tpu_torch.train import loop as T

    monkeypatch.setattr(TE, "_mpl", lambda: (_ for _ in ()).throw(
        ImportError("no figures in this test")))
    cfg = tcfg.get_config("generic")
    cfg.ENV.ENV_NAME = "duffing"
    cfg.MODEL.TARGET_SIZE = 8
    cfg.TRAIN.NUM_STEPS, cfg.TRAIN.BATCH_SIZE = 3, 8
    with pytest.warns(UserWarning, match="matplotlib|figures"):
        state, model, run_dir = T.train_system(
            cfg, log_dir=str(tmp_path), verbose=False, final_eval=True,
            device="cpu")
    for tag in ("last", "best"):
        res = json.loads((run_dir / f"evaluation_results_{tag}.json")
                         .read_text())
        modes = res["duffing"]["modes"]
        assert set(modes) == {"no_reencode", "every_step", "periodic_10",
                              "periodic_25", "periodic_50", "periodic_100"}
        assert modes["every_step"]["horizons"]["1000"]["num_valid"] == 100
        assert (run_dir / f"evaluation_{tag}" / "metrics.json").exists()
    assert model is state.model and state.step == 3


def test_finance_plots(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.eval import finance_plots as FP
    from kmpc_tpu_torch.train.loop import evaluate_finance

    cfg = tcfg.get_config("finance_sparse")
    cfg.ENV.FINANCE.CACHE_DIR = None
    cfg.MODEL.TARGET_SIZE = 16
    cfg.MODEL.ENCODER.LAYERS = [16]
    fd = load_finance_data(cfg, device="cpu")
    model = tmake(cfg, fd.observation_size, device="cpu").init_params(
        torch.Generator().manual_seed(0)).eval()
    init, future = fd.get_test_sequences(num_sequences=6, max_length=12)
    ev = evaluate_finance(model, init, future, max_horizon=12)
    files = FP.save_finance_plots(ev, fd, tmp_path / "figs")
    assert set(files) == {"forecast_mse_vs_horizon",
                          "predicted_vs_actual_returns",
                          "prediction_correlation", "mode_mse_comparison"}
    assert all((tmp_path / "figs" / f"{k}.png").exists() for k in files)

    def missing():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(FP, "_mpl", missing)
    with pytest.warns(UserWarning, match="matplotlib"):
        assert FP.save_finance_plots(ev, fd, tmp_path / "none") == {}
    assert not (tmp_path / "none").exists()
