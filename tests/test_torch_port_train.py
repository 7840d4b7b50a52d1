"""kmpc_tpu_torch against kmpc_tpu: the training path — the dynamical
systems, the finance batches, AdamW with its K group, the train steps,
checkpoints that both packages read, the loops and the CLI's config.

Both packages run on the CPU at small sizes. JAX's PRNG streams cannot be
reproduced in torch, so every comparison feeds both packages the same
numpy initial states, batches or window indices, and kmpc_tpu's initial
parameters are carried into the port (``utils/params.py``). Bars: system
steps and trajectories relative 1e-5; one AdamW update within 1e-7
absolute of optax; the loss of each of five steps on the same batches
within relative 1e-4 (weights are not compared after several steps: Adam
moves a near-zero gradient's weight by about the learning rate either way).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.data.finance import load_finance_data as jload
from kmpc_tpu.data.systems import make_system as jsystem
from kmpc_tpu.data.systems import system_dt as jsystem_dt
from kmpc_tpu.models import make_model as jmake
from kmpc_tpu.train import loop as J
from kmpc_tpu.utils import checkpoint as JC
from kmpc_tpu_torch.data.finance import load_finance_data as tload
from kmpc_tpu_torch.data.systems import make_system as tsystem
from kmpc_tpu_torch.data.systems import system_dt as tsystem_dt
from kmpc_tpu_torch.models.koopman import make_model as tmake
from kmpc_tpu_torch.train import loop as T
from kmpc_tpu_torch.utils import checkpoint as TC
from kmpc_tpu_torch.utils.params import params_from_jax

SYSTEMS = ["pendulum", "duffing", "lotka_volterra", "lorenz63", "parabolic",
           "lyapunov"]
LOSS_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small CPU operations: one torch thread is as fast, and leaves
    the cores to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tiny(mod, env="duffing", seq=False, preset="generic", target=8):
    """tests/test_train.py's small run in package ``mod``'s config."""
    cfg = mod.get_config(preset)
    cfg.ENV.ENV_NAME = env
    cfg.MODEL.TARGET_SIZE = target
    cfg.MODEL.ENCODER.LAYERS = [16]
    cfg.TRAIN.NUM_STEPS = 6
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TRAIN.USE_SEQUENCE_LOSS = seq
    cfg.TRAIN.SEQUENCE_LENGTH = 4
    cfg.TRAIN.EVAL_INTERVAL = 5
    cfg.TRAIN.LOG_INTERVAL = 2
    return cfg


def _tiny_finance(mod):
    cfg = mod.get_config("finance_sparse")
    cfg.MODEL.TARGET_SIZE = 16
    cfg.MODEL.ENCODER.LAYERS = [32]
    cfg.TRAIN.NUM_STEPS = 6
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TRAIN.SEQUENCE_LENGTH = 4
    cfg.TRAIN.EVAL_INTERVAL = 5
    cfg.TRAIN.LOG_INTERVAL = 2
    cfg.ENV.FINANCE = mod.FinanceConfig(
        TICKERS=["T1", "T2", "T3"], START_DATE="2018-01-01",
        END_DATE="2021-12-31", TRAIN_END="2019-12-31", VAL_END="2020-12-31",
        EMBEDDING_DIM=3, CACHE_DIR=None, SYNTHETIC=True)
    return cfg


@pytest.fixture(scope="module")
def finance():
    """The tiny finance run's data in both packages."""
    return jload(_tiny_finance(jcfg)), tload(_tiny_finance(tcfg), device="cpu")


# ---------------------------------------------------------------------------
# Dynamical systems
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SYSTEMS)
def test_system_step_and_trajectory_match(name):
    js, ts = jsystem(jcfg.Config(), name), tsystem(tcfg.Config(), name)
    assert (ts.name, ts.dt, ts.observation_size) == (js.name, js.dt, js.observation_size)
    x0 = np.asarray(js.reset(jax.random.PRNGKey(3), 6))
    assert _rel(ts.step(torch.tensor(x0)).numpy(), js.step(jnp.asarray(x0))) <= 1e-5
    want = js.trajectory(jnp.asarray(x0), 25)
    got = ts.trajectory(torch.tensor(x0), 25).numpy()
    assert got.shape == (25, 6, js.observation_size)
    assert _rel(got, want) <= 1e-5
    assert tsystem_dt(tcfg.Config(), name) == jsystem_dt(jcfg.Config(), name)


@pytest.mark.parametrize("name", SYSTEMS)
def test_system_initial_states_and_windows(name):
    """Initial states on the generator's device, in the JAX law's support,
    the same for the same seed; windows start at them and follow RK4."""
    ts = tsystem(tcfg.Config(), name)
    js = jsystem(jcfg.Config(), name)
    x = ts.reset(torch.Generator().manual_seed(1), 512)
    ref = np.asarray(js.reset(jax.random.PRNGKey(0), 512))
    assert x.shape == ref.shape and x.dtype == torch.float32
    if name != "lorenz63":
        lo, hi = ref.min(0), ref.max(0)
        span = hi - lo
        assert np.all(x.numpy().min(0) >= lo - 0.05 * span)
        assert np.all(x.numpy().max(0) <= hi + 0.05 * span)
    assert torch.equal(x, ts.reset(torch.Generator().manual_seed(1), 512))
    assert ts.reset(torch.Generator().manual_seed(1)).shape == (ts.observation_size,)
    seq = ts.sequence_batch(torch.Generator().manual_seed(2), 4, 3)
    assert seq.shape == (4, 4, ts.observation_size)
    torch.testing.assert_close(seq[:, 1:], ts.trajectory(seq[:, 0], 3).transpose(0, 1))


# ---------------------------------------------------------------------------
# Finance batches and host helpers
# ---------------------------------------------------------------------------


def test_finance_batches_match(finance):
    jd, td = finance
    for split in ("train", "val", "test"):
        for L in (1, 4):
            assert td.num_examples(split, L) == jd.num_examples(split, L)
    starts = np.random.default_rng(0).integers(0, jd.num_examples("train", 4), 16)
    np.testing.assert_array_equal(
        td.batch_at(torch.tensor(starts), "train", 4).numpy(),
        np.asarray(jd.batch_at(jnp.asarray(starts), "train", 4)))
    for got, want in zip(td.get_test_sequences(20, 30), jd.get_test_sequences(20, 30)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_batch_windows(finance):
    _, td = finance
    win = td.sample_batch(torch.Generator().manual_seed(0), "train", 32, 4)
    again = td.sample_batch(torch.Generator().manual_seed(0), "train", 32, 4)
    assert win.shape == (32, 5, td.observation_size) and torch.equal(win, again)
    train = td.train.numpy()
    for w in win.numpy():
        i = int(np.flatnonzero((train == w[0]).all(1))[0])
        np.testing.assert_array_equal(w, train[i:i + 5])
    with pytest.raises(ValueError, match="too short"):
        td.sample_batch(torch.Generator(), "val", 4, td.val.shape[0])


def test_finance_host_helpers_match():
    import pandas as pd

    from kmpc_tpu.data import finance as jf
    from kmpc_tpu_torch.data import finance as tf

    rng = np.random.default_rng(0)
    rets = pd.DataFrame(rng.standard_normal((60, 4)) * 0.01,
                        columns=list("ABCD"),
                        index=pd.bdate_range("2020-01-01", periods=60))
    pd.testing.assert_frame_equal(tf.compute_return_stats(rets),
                                  jf.compute_return_stats(rets))
    pd.testing.assert_series_equal(tf.compute_autocorrelation(rets, 2),
                                   jf.compute_autocorrelation(rets, 2))
    emb = tf.time_delay_embedding(rets.to_numpy(np.float32), 3)
    assert tf.verify_embedding_shift(emb, 4, 3) == jf.verify_embedding_shift(emb, 4, 3) is True
    emb[5, 0] += 1.0
    assert tf.verify_embedding_shift(emb, 4, 3) == jf.verify_embedding_shift(emb, 4, 3) is False


# ---------------------------------------------------------------------------
# Dispatch, optimizer, steps
# ---------------------------------------------------------------------------


def test_dispatch_chunks_match():
    for start in (0, 3, 7):
        for steps in (1, 6, 26, 101):
            for spd in (1, 4, 25):
                for intervals in ((2, 5), (100, 500), (3, 7), (1, 1)):
                    assert (list(T._dispatch_chunks(start, steps, spd, intervals))
                            == list(J._dispatch_chunks(start, steps, spd, intervals)))


def _carried(jc, tc, obs, seed=0):
    """kmpc_tpu's train state at PRNGKey(seed) and the port's with the
    same weights and a fresh AdamW."""
    jm = jmake(jc, obs)
    jstate = J.init_train_state(jc, jm, jax.random.PRNGKey(seed))
    tm = tmake(tc, obs, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate["params"])))
    return jm, jstate, T.TrainState(tm, T.build_optimizer(tc, tm))


@pytest.mark.parametrize("preset", ["generic", "lista"])
def test_adamw_update_matches_optax(preset):
    """Three updates from the same gradients, both groups, weight decay
    on, at finance_sparse's learning rates: every parameter within 1e-7 of
    optax's. (optax forms its bias corrections in float32, 1 - 0.999 to
    1.3e-5 relative, so its first update is about 6.5e-6 relative smaller
    than AdamW's, 6.5e-9 at lr 1e-3.)"""
    jc, tc = (_tiny(m, preset=preset) for m in (jcfg, tcfg))
    for c in (jc, tc):
        c.TRAIN.LR, c.TRAIN.K_MATRIX_LR, c.TRAIN.WEIGHT_DECAY = 1e-3, 1e-4, 0.05
    jm, jstate, ts = _carried(jc, tc, 2)
    tx = J.build_optimizer(jc, None)
    params, opt_state = jstate["params"], jstate["opt_state"]
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32) * 0.1,
            jax.tree.map(np.asarray, params))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for name, p in ts.model.named_parameters():
            p.grad = params_from_jax(grads)[name]
        ts.optimizer.step()
    for name, want in params_from_jax(jax.tree.map(np.asarray, params)).items():
        got = dict(ts.model.named_parameters())[name].detach()
        assert (got - want).abs().max().item() <= 1e-7, name
    groups = {g["name"]: g for g in ts.optimizer.param_groups}
    assert groups["kmat"]["weight_decay"] == 0.0 and groups["kmat"]["lr"] == 1e-4
    assert len(groups["kmat"]["params"]) == 1


def _finance_batches(jd, L, n, B=8, seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, jd.num_examples("train", L), (n, B))
    return [np.asarray(jd.batch_at(jnp.asarray(s), "train", L)) for s in starts]


def _system_pairs(name, n, B=8, seed=0):
    js = jsystem(jcfg.Config(), name)
    out = []
    for i in range(n):
        x = np.asarray(js.reset(jax.random.PRNGKey(seed + i), B))
        out.append((x, np.asarray(js.step(jnp.asarray(x)))))
    return out


def _as_batch(b, framework):
    conv = jnp.asarray if framework == "jax" else torch.tensor
    return tuple(conv(a) for a in b) if isinstance(b, tuple) else conv(b)


def _steps(jstep, jstate, tstep, tstate, batches):
    """Both packages' train steps over ``batches``; their losses."""
    jl, tl = [], []
    for b in batches:
        jstate, jm = jstep(jstate, _as_batch(b, "jax"))
        tstate, tm = tstep(tstate, _as_batch(b, "torch"))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jstate, tstate, np.asarray(jl), np.asarray(tl)


@pytest.mark.parametrize("case", ["finance_seq_scan", "finance_seq_kpower",
                                  "duffing_lista_pairs", "duffing_nonlinear_pairs"])
def test_five_train_steps_match(case, finance):
    if case.startswith("finance"):
        jc, tc = (_tiny_finance(m) for m in (jcfg, tcfg))
        for c in (jc, tc):
            c.TRAIN.ROLLOUT = case.rsplit("_", 1)[1]
        batches = _finance_batches(finance[0], 4, 5)
        obs = finance[0].observation_size
    else:
        preset = "lista" if "lista" in case else "lista_nonlinear"
        jc, tc = (_tiny(m, preset=preset, target=32) for m in (jcfg, tcfg))
        batches, obs = _system_pairs("duffing", 5), 2
    jm, jstate, ts = _carried(jc, tc, obs)
    _, _, jl, tl = _steps(J.make_train_step(jc, jm, 1.0), jstate,
                          T.make_train_step(tc, ts.model, 1.0), ts, batches)
    assert ts.step == 5
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    assert len(set(jl.round(7))) > 1  # the steps moved the loss


def test_system_train_step_synthesises_on_the_generator():
    tc = _tiny(tcfg, seq=True)
    ts = T.init_train_state(tc, tmake(tc, 2, device="cpu"),
                            torch.Generator().manual_seed(0))
    step = T.make_system_train_step(tc, ts.model, tsystem(tc))
    _, m = step(ts, torch.Generator().manual_seed(5))
    assert ts.step == 1 and np.isfinite(float(m["loss"]))
    assert set(m) >= {"loss", "residual_loss", "sparsity_ratio"}


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["generic", "lista_nonlinear"])
def test_checkpoints_read_both_ways(preset, tmp_path):
    """Two steps in one package, its checkpoint resumed by the other, and
    the next two steps' losses equal to the first package's own within
    1e-4 (the second of them depends on the carried AdamW moments)."""
    jc, tc = (_tiny(m, preset=preset, target=16) for m in (jcfg, tcfg))
    for c in (jc, tc):
        c.TRAIN.LR = c.TRAIN.K_MATRIX_LR = 1e-2
    batches = _system_pairs("duffing", 4, seed=10)
    jm, jstate, ts = _carried(jc, tc, 2)
    jstep, tstep = J.make_train_step(jc, jm, 1.0), T.make_train_step(tc, ts.model, 1.0)
    jstate, ts, _, _ = _steps(jstep, jstate, tstep, ts, batches[:2])

    # kmpc_tpu -> the port.
    JC.save_checkpoint(tmp_path / "j", jstate, 2, jc.to_dict())
    _, _, fresh = _carried(jc, tc, 2, seed=7)
    fresh, meta = TC.load_checkpoint(tmp_path / "j", fresh)
    assert fresh.step == 2 and meta["step"] == 2
    # The port -> kmpc_tpu.
    TC.save_checkpoint(tmp_path / "t", ts, ts.step, tc.to_dict())
    like = J.init_train_state(jc, jm, jax.random.PRNGKey(7))
    loaded, meta = JC.load_checkpoint(tmp_path / "t", like)
    assert int(loaded["step"]) == 2 and meta["step"] == 2
    loaded = jax.tree.map(jnp.asarray, loaded)

    jstate, _, jl, _ = _steps(jstep, jstate, tstep, ts, batches[2:])
    _, _, from_port, from_jax = _steps(
        J.make_train_step(jc, jm, 1.0), loaded,
        T.make_train_step(tc, fresh.model, 1.0), fresh, batches[2:])
    np.testing.assert_allclose(from_jax, jl, rtol=LOSS_REL)
    np.testing.assert_allclose(from_port, jl, rtol=LOSS_REL)


def test_load_checkpoint_refuses_a_shape_mismatch(tmp_path):
    tc = _tiny(tcfg)
    ts = T.init_train_state(tc, tmake(tc, 2, device="cpu"), torch.Generator())
    TC.save_checkpoint(tmp_path / "c", ts, 0)
    tc.MODEL.TARGET_SIZE = 12
    other = T.init_train_state(tc, tmake(tc, 2, device="cpu"), torch.Generator())
    with pytest.raises(ValueError, match="Shape mismatch"):
        TC.load_checkpoint(tmp_path / "c", other)


def test_load_jax_checkpoint_serves_listakm(tmp_path):
    from kmpc_tpu_torch.utils.params import load_jax_checkpoint

    jc = _tiny(jcfg, preset="lista", target=16)
    jm = jmake(jc, 2)
    state = J.init_train_state(jc, jm, jax.random.PRNGKey(1))
    JC.save_checkpoint(tmp_path / "last", state, 3, jc.to_dict())
    jc.to_json(str(tmp_path / "config.json"))
    cfg, tm, step = load_jax_checkpoint(tmp_path, device="cpu")
    assert step == 0 and tm.model_name == "LISTAKM"
    x = np.random.default_rng(0).standard_normal((5, 2)).astype(np.float32)
    with torch.no_grad():
        got = tm.step_env(torch.tensor(x)).numpy()
    assert _rel(got, jm.step_env(state["params"], jnp.asarray(x))) <= 1e-5


# ---------------------------------------------------------------------------
# Evaluation and the loops
# ---------------------------------------------------------------------------


def test_evaluations_and_val_loss_match(finance):
    jd, td = finance
    jc, tc = (_tiny_finance(m) for m in (jcfg, tcfg))
    jm, jstate, ts = _carried(jc, tc, jd.observation_size)
    params = jstate["params"]
    ji, jf = jd.get_test_sequences(8, 12)
    ti, tf = td.get_test_sequences(8, 12)
    want = J.evaluate_finance(jm, params, ji, jf, max_horizon=10)
    got = T.evaluate_finance(ts.model, ti, tf, max_horizon=10)
    assert got["best_mode"] == want["best_mode"]
    for k in ("mean_mse_reencode", "mean_mse_no_reencode", "final_mse_reencode",
              "final_mse_no_reencode", "best_mse"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    for k in want["mse_curves"]:
        assert _rel(got["mse_curves"][k], want["mse_curves"][k]) <= 1e-5, k
    assert abs(T._val_loss(ts.model, td, tc) - J._val_loss(jm, params, jd, jc)) \
        <= 1e-5 * abs(J._val_loss(jm, params, jd, jc))

    jc, tc = (_tiny(m) for m in (jcfg, tcfg))
    jm, jstate, ts = _carried(jc, tc, 2)
    js, tsys = jsystem(jc), tsystem(tc)
    x0 = np.asarray(js.reset(jax.random.PRNGKey(9), 4))
    want = J.evaluate_system(jm, jstate["params"], js, jnp.asarray(x0), num_steps=30)
    got = T.evaluate_system(ts.model, tsys, torch.tensor(x0), num_steps=30)
    for k in ("mean_error", "final_error"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


def _files(run_dir):
    return sorted(str(p.relative_to(run_dir)) for p in Path(run_dir).rglob("*")
                  if p.is_file() and p.suffix != ".png")


@pytest.mark.parametrize("kind", ["finance", "system"])
def test_loops_write_kmpc_tpus_files(kind, tmp_path):
    """train_finance / train_system at 6 steps, in process: the same files
    as kmpc_tpu's run (its plots aside: the port draws none), the same
    metric names, and each package's checkpoint read by the other."""
    from kmpc_tpu_torch.utils.params import load_jax_checkpoint

    if kind == "finance":
        jc, tc = (_tiny_finance(m) for m in (jcfg, tcfg))
        _, _, jdir = J.train_finance(jc, log_dir=str(tmp_path / "j"), verbose=False)
        ts, tm, tdir = T.train_finance(tc, log_dir=str(tmp_path / "t"),
                                       verbose=False, device="cpu")
    else:
        jc, tc = (_tiny(m, seq=True) for m in (jcfg, tcfg))
        _, _, jdir = J.train_system(jc, log_dir=str(tmp_path / "j"), verbose=False)
        ts, tm, tdir = T.train_system(tc, log_dir=str(tmp_path / "t"),
                                      verbose=False, device="cpu")
    assert _files(tdir) == _files(jdir)
    assert ts.step == 6
    names = {json.loads(line)["name"]
             for line in open(tdir / "metrics_history.jsonl")}
    assert names == {json.loads(line)["name"]
                     for line in open(jdir / "metrics_history.jsonl")}
    assert (json.loads((tdir / "config.json").read_text())
            == json.loads((jdir / "config.json").read_text()))
    # kmpc_tpu resumes the port's run, the port serves kmpc_tpu's.
    jm = jmake(jc, tm.observation_size)
    like = J.init_train_state(jc, jm, jax.random.PRNGKey(0))
    state, meta = JC.load_checkpoint(tdir / "last", like)
    assert meta["step"] == int(state["step"]) == 6
    cfg, served, step = load_jax_checkpoint(jdir, device="cpu")
    assert step > 0 and served.model_name == tm.model_name


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """The data stream is seeded from (SEED, step): 6 steps, then a resume
    from the last checkpoint to 8, ends on the weights of 8 straight steps."""
    tc = _tiny(tcfg, seq=True)
    tc.TRAIN.NUM_STEPS = 8
    straight, _, _ = T.train_system(tc, log_dir=str(tmp_path / "a"),
                                    verbose=False, device="cpu")
    tc.TRAIN.NUM_STEPS = 6
    _, _, first = T.train_system(tc, log_dir=str(tmp_path / "b"),
                                 verbose=False, device="cpu")
    tc.TRAIN.NUM_STEPS = 8
    resumed, _, _ = T.train_system(tc, log_dir=str(tmp_path / "c"),
                                   checkpoint_path=str(first / "last"),
                                   verbose=False, device="cpu")
    assert resumed.step == straight.step == 8
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_train_raises_where_the_slice_stops(tmp_path):
    """A PARALLEL mesh whose product is not the world's size raises
    ValueError, as make_mesh does, before any file is written (a mesh that
    matches the world trains: tests/test_torch_port_parallel.py)."""
    tc = _tiny(tcfg)
    tc.PARALLEL.DATA = 2
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        T.train(tc, log_dir=str(tmp_path), device="cpu")
    assert not any(Path(tmp_path).iterdir())
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

FLAGS = [
    [],
    ["--config", "finance_sparse", "--num_steps", "12", "--steps_per_dispatch", "5"],
    ["--config", "lista", "--env", "lorenz63", "--batch_size", "16",
     "--target_size", "64", "--lista_alpha", "0.01", "--seed", "3"],
    ["--config", "lista_nonlinear", "--env", "pendulum", "--pairwise",
     "--sparsity_coeff", "0.5", "--reconst_coeff", "0.2", "--pred_coeff", "0.1"],
    ["--config", "generic_prediction", "--lr", "0.003", "--sequence_length", "7",
     "--dtype", "float32"],
    ["--config", "generic_sparse", "--env", "lyapunov"],
]


@pytest.mark.parametrize("flags", FLAGS)
def test_cli_config_matches_train_py(flags, monkeypatch):
    """The port's flags-to-config function against the root train.py's
    mapping (its train() replaced, so nothing trains)."""
    import sys

    import train as jtrain
    from kmpc_tpu_torch.train.__main__ import config_from_args, parse_args

    seen = {}
    monkeypatch.setattr(J, "train", lambda cfg, **kw: seen.update(cfg=cfg, kw=kw)
                        or (None, None, "run"))
    monkeypatch.setattr(sys, "argv", ["train.py", *flags])
    jtrain.main()
    got = config_from_args(parse_args(flags))
    assert got.to_dict() == seen["cfg"].to_dict()


def test_cli_device_and_refusals(monkeypatch):
    from kmpc_tpu_torch.train import __main__ as cli

    seen = {}
    monkeypatch.setattr(T, "train", lambda cfg, **kw: seen.update(kw) or (None, None, "run"))
    cli.main(["--cpu", "--num_steps", "2", "--no_final_eval"])
    assert seen["device"] == torch.device("cpu") and seen["final_eval"] is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--num_steps", "2"])
    cfg = cli.config_from_args(cli.parse_args(["--dtype", "bfloat16"]))
    assert cfg.TRAIN.DTYPE == "bfloat16"
    assert tmake(cfg, 2, device="cpu").compute_dtype == "bfloat16"


def test_metrics_logger_writes_kmpc_tpus_files(tmp_path):
    from kmpc_tpu.utils.logger import MetricsLogger as JL
    from kmpc_tpu_torch.utils.logger import MetricsLogger as TL

    for cls, d in ((JL, tmp_path / "j"), (TL, tmp_path / "t")):
        log = cls(d, flush_interval=3)
        for s in range(5):
            log.log_dict({"loss": 1.0 / (s + 1), "a": float(s)}, s, prefix="train")
        log.log_scalar("val/loss", 0.5, 4)
        log.close()
    for name in ("metrics_history.jsonl", "metrics_summary.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
