"""kmpc_tpu_torch against kmpc_tpu: the sparsity sweep.

kmpc_tpu's ``stack_states`` (one set of initial weights, stacked over the
coefficients) is carried into the port's stacked parameters by
``utils/params.py``, and both packages' ``make_sweep_train_step`` take the
same numpy batches. The training tests' bars: every step's losses within 1e-4
relative, step 1's metrics within 1e-5, the parameters after step 3
within 1e-5; and each member equal to the port's single run with its
coefficient (``make_train_step``) on the same batches.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.models import make_model as jmake
from kmpc_tpu.train import sweep as JS
from kmpc_tpu_torch.models.koopman import make_model as tmake
from kmpc_tpu_torch.train import loop as T
from kmpc_tpu_torch.train import sweep as TS
from kmpc_tpu_torch.utils.params import params_from_jax

COEFFS = [0.0, 1e-3, 0.1]
OBS, B, STEPS = 2, 8, 3
LOSS_REL, METRIC_REL, PARAM_TOL = 1e-4, 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(preset, sequence):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_config(preset)
        cfg.MODEL.TARGET_SIZE = 8
        cfg.TRAIN.BATCH_SIZE = B
        cfg.TRAIN.USE_SEQUENCE_LOSS = sequence
        cfg.TRAIN.SEQUENCE_LENGTH = 4
        out.append(cfg)
    return out


def _batches(sequence, seed=0):
    rng = np.random.default_rng(seed)
    if sequence:
        return [rng.standard_normal((B, 5, OBS)).astype(np.float32)
                for _ in range(STEPS)]
    return [tuple(rng.standard_normal((B, OBS)).astype(np.float32)
                  for _ in range(2)) for _ in range(STEPS)]


def _as(batch, fn):
    return tuple(fn(x) for x in batch) if isinstance(batch, tuple) else fn(batch)


def _runs(preset, sequence):
    jc, tc = _cfgs(preset, sequence)
    jm = jmake(jc, OBS)
    states = JS.stack_states(jc, jm, jax.random.PRNGKey(0), len(COEFFS))
    stacked = params_from_jax(jax.tree.map(np.asarray, states["params"]))
    tm = tmake(tc, OBS, device="cpu")
    tm.load_state_dict({k: v[0] for k, v in stacked.items()})
    tstate = TS.stack_states(tc, tm, None, len(COEFFS))
    return jc, tc, jm, states, stacked, tm, tstate


@pytest.mark.parametrize("preset,sequence", [
    ("generic_sparse", False), ("generic_sparse", True), ("lista", False)])
def test_sweep_steps_match_kmpc_tpu(preset, sequence):
    jc, tc, jm, states, stacked, tm, tstate = _runs(preset, sequence)
    for k, v in tstate.params.items():
        assert torch.equal(v.detach(), stacked[k]), k
    jstep = JS.make_sweep_train_step(jc, jm, 0.01)
    tstep = TS.make_sweep_train_step(tc, tm, 0.01)
    jco, tco = jnp.asarray(COEFFS, jnp.float32), torch.tensor(COEFFS)
    for i, b in enumerate(_batches(sequence)):
        states, mj = jstep(states, _as(b, jnp.asarray), jco)
        tstate, mt = tstep(tstate, _as(b, torch.tensor), tco)
        lj, lt = np.asarray(mj["loss"]), mt["loss"].numpy()
        assert np.all(np.abs(lt - lj) <= LOSS_REL * np.maximum(np.abs(lj), 1e-12))
        if i == 0:
            for k in mj:
                a, w = mt[k].numpy(), np.asarray(mj[k])
                assert np.all(np.abs(a - w) <= METRIC_REL
                              * np.maximum(np.abs(w), 1.0)), k
    want = params_from_jax(jax.tree.map(np.asarray, states["params"]))
    for k, v in want.items():
        assert (tstate.params[k].detach() - v).abs().max() <= PARAM_TOL, k
    assert tstate.step == STEPS


def test_each_member_is_its_single_run():
    """AdamW is elementwise: each member of the stacked run moves as the
    single run with its coefficient does, on the same batches."""
    _, tc, _, _, stacked, tm, tstate = _runs("generic_sparse", False)
    tstep = TS.make_sweep_train_step(tc, tm, 0.01)
    singles = []
    for c in COEFFS:
        cc = copy.deepcopy(tc)
        cc.MODEL.SPARSITY_COEFF = c
        m = tmake(cc, OBS, device="cpu")
        m.load_state_dict({k: v[0] for k, v in stacked.items()})
        singles.append((T.TrainState(m, T.build_optimizer(cc, m)),
                        T.make_train_step(cc, m, 0.01)))
    for b in _batches(False, seed=1):
        tstate, mt = tstep(tstate, _as(b, torch.tensor), torch.tensor(COEFFS))
        for i, (st, step) in enumerate(singles):
            _, ms = step(st, _as(b, torch.tensor))
            for k in ms:
                assert abs(ms[k].item() - mt[k][i].item()) <= METRIC_REL * max(
                    abs(ms[k].item()), 1.0), (i, k)
    for i, (st, _) in enumerate(singles):
        for k, v in st.model.state_dict().items():
            assert (TS.member(tstate, i)[k] - v).abs().max() <= PARAM_TOL, (i, k)


def test_fused_sweep_step_draws_the_single_runs_batches():
    """``make_fused_sweep_step`` draws each step's batch from a generator
    seeded from (SEED, step), as ``make_system_train_step`` does: the
    members follow their single runs through ``train/loop.py``."""
    from kmpc_tpu_torch import stream_seed
    from kmpc_tpu_torch.data.systems import make_system

    tc = tcfg.get_config("generic_sparse")
    tc.MODEL.TARGET_SIZE, tc.TRAIN.BATCH_SIZE = 8, B
    system = make_system(tc, "duffing")
    tm = tmake(tc, OBS, device="cpu")
    state = TS.stack_states(tc, tm, torch.Generator().manual_seed(0), 2)
    fused = TS.make_fused_sweep_step(tc, tm, system)
    for s in (5, 6):
        state, metrics = fused(state, s, torch.tensor([0.0, 0.5]))
    assert state.step == 2 and metrics["loss"].shape == (2,)
    cc = copy.deepcopy(tc)
    cc.MODEL.SPARSITY_COEFF = 0.5
    m = tmake(cc, OBS, device="cpu")
    m.load_state_dict({k: v[0] for k, v in TS.stack_states(
        tc, tm, torch.Generator().manual_seed(0), 2).params.items()})
    st = T.TrainState(m, T.build_optimizer(cc, m))
    step = T.make_system_train_step(cc, m, system)
    gen = torch.Generator()
    for s in (5, 6):
        gen.manual_seed(stream_seed(tc.SEED, T._DATA, s))
        _, ms = step(st, gen)
    assert abs(ms["loss"].item() - metrics["loss"][1].item()) <= 1e-6


def test_run_sparsity_sweep_writes_kmpc_tpus_results(tmp_path):
    jc, tc = _cfgs("generic_sparse", False)
    for c in (jc, tc):
        c.TRAIN.NUM_STEPS, c.TRAIN.LOG_INTERVAL = 2, 1
        c.ENV.ENV_NAME = "duffing"
    jres, _ = JS.run_sparsity_sweep(jc, [0.0, 0.1], log_dir=str(tmp_path / "j"),
                                    eval_horizon=5, eval_batch=4, verbose=False)
    tres, run_dir = TS.run_sparsity_sweep(
        tc, [0.0, 0.1], log_dir=str(tmp_path / "t"), eval_horizon=5,
        eval_batch=4, verbose=False, device="cpu")
    saved = json.loads((run_dir / "sparsity_sweep_results.json").read_text())
    assert list(saved) == list(jres) and saved == tres
    assert saved["coefficients"] == [0.0, 0.1] and saved["horizon"] == 5
    assert all(np.isfinite(saved["no_reencode_mse"]))
    assert all(0.0 <= r <= 1.0 for r in saved["sparsity_ratio"])


def test_sweep_cli_matches_sweep_sparsity_py(monkeypatch):
    """The port's flags-to-config against the root sweep_sparsity.py's
    (both sweeps replaced, so nothing trains)."""
    import sys

    import sweep_sparsity as root
    from kmpc_tpu_torch import sweep_sparsity as cli

    seen = {}

    def fake(tag):
        def run(cfg, coeffs, **kw):
            seen[tag] = (cfg.to_dict(), list(coeffs), kw["eval_horizon"])
            return {"coefficients": list(coeffs),
                    "no_reencode_mse": [1.0] * len(coeffs)}, "run"
        return run

    monkeypatch.setattr(JS, "run_sparsity_sweep", fake("jax"))
    monkeypatch.setattr(TS, "run_sparsity_sweep", fake("torch"))
    for flags in ([], ["--config", "lista", "--env", "pendulum",
                       "--num_steps", "7", "--batch_size", "16",
                       "--coefficients", "0", "0.2", "--eval_horizon", "9"]):
        monkeypatch.setattr(sys, "argv", ["sweep_sparsity.py", *flags])
        root.main()
        cli.main(flags + ["--cpu"])
        assert seen["jax"] == seen["torch"]
    assert cli.DEFAULT_COEFFS == root.DEFAULT_COEFFS
