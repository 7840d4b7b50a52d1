"""kmpc_tpu_torch.parallel against kmpc_tpu.parallel: the device mesh, the
placements, the sharded solver, the date-sharded Jacobi backtest and data-
and tensor-parallel training on torch.distributed.

Single-process cases hold the mesh's size rules and errors, the
tensor-parallel specs, the replication where 'model' does not divide,
``process_local_batch_size``, ``scaling_report`` and the no-op
``initialize_distributed`` against kmpc_tpu's. One world of four gloo ranks
on the CPU (``kmpc_tpu_torch/parallel/rehearse.py``, started once for the
file in the background, one torch thread a rank, a free port, killed after
180 s) runs the sharded cases; the test process holds its results against
kmpc_tpu's sharded functions on the 8-device virtual CPU mesh (the same
mesh shapes on four of its devices), against kmpc_tpu's unsharded ones and
against the port's unsharded ones, on the same inputs.

Bars: solves, weights 5e-4 and objective 1e-5 (scenario 5e-5;
mean-variance 5e-5 / 1e-6), the packed-kernel bars; the date-sharded
backtest, portfolio values rtol 2e-5 and weights atol 3e-5
(tests/test_sharding.py's), against the port's unsharded run and against
kmpc_tpu's sharded and unsharded runs (DMD's operator carried over); one
train step, loss rtol 1e-4 and every parameter atol 1e-5
(tests/test_sharding.py's; the row-sharded decoder sums partial products
over 'model', another order of summation than one process's), and every
rank's parameters bit-equal.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.parallel import distributed as JD
from kmpc_tpu.parallel import mesh as JM
from kmpc_tpu_torch.parallel import distributed as TD
from kmpc_tpu_torch.parallel import mesh as TM
from kmpc_tpu_torch.parallel import rehearse as R

W_TOL, OBJ_TOL, SCEN_OBJ_TOL = 5e-4, 1e-5, 5e-5
MV_W_TOL, MV_OBJ_TOL = 5e-5, 1e-6
PV_RTOL, BT_W_ATOL = 2e-5, 3e-5
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 (virtual) devices")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_POOL = ThreadPoolExecutor(max_workers=1)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The four-rank rehearsal, started before the file's first test so
    that it runs while the single-process cases and kmpc_tpu's references
    are computed."""
    out = tmp_path_factory.mktemp("parallel")
    return out, _POOL.submit(R.rehearse, out, 180.0)


@pytest.fixture(scope="module")
def ranks(world, jax_solves):
    """The rehearsal's results (kmpc_tpu's solves computed first, while
    the ranks run)."""
    return world[1].result()


def _jmesh(sizes):
    d, s, m = sizes
    return JM.make_mesh({"data": d, "scenario": s, "model": m},
                        jax.devices()[:d * s * m])


# ---------------------------------------------------------------------------
# Single process
# ---------------------------------------------------------------------------


@requires_8
@pytest.mark.parametrize("shape", [
    None, {}, {"data": 2, "scenario": 2, "model": 2}, {"data": -1},
    {"data": 2, "scenario": -1}, {"model": -1}, {"data": 4, "scenario": 2},
    {"scenario": 8}, {"data": 1, "scenario": 1, "model": -1},
])
def test_mesh_sizes_match_make_mesh(shape):
    assert TM.mesh_sizes(shape, 8) == dict(JM.make_mesh(shape).shape)


@requires_8
@pytest.mark.parametrize("shape", [
    {"data": 3, "scenario": 5, "model": 7}, {"data": -1, "model": -1},
    {"data": 3, "scenario": -1}, {"data": 2}, {"model": 16},
])
def test_mesh_sizes_raise_as_make_mesh(shape):
    with pytest.raises(ValueError):
        JM.make_mesh(shape)
    with pytest.raises(ValueError):
        TM.mesh_sizes(shape, 8)


def test_make_mesh_raises_before_making_a_world():
    """A shape the world of one cannot hold raises ValueError before any
    process group exists."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        TM.make_mesh({"data": 2}, device="cpu")
    assert not torch.distributed.is_initialized()


def _models(preset):
    """kmpc_tpu's and the port's model of ``preset`` at z=64, obs 40."""
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu_torch.models.koopman import make_model as tmake

    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_config(preset)
        cfg.MODEL.TARGET_SIZE = 64
        if not preset.startswith("lista"):
            cfg.MODEL.ENCODER.LAYERS = [64, 48]
        out.append(cfg)
    jm = jmake(out[0], 40)
    return jm, jm.init(jax.random.PRNGKey(0)), tmake(out[1], 40, device="cpu")


def _jax_spec(jspecs, name):
    """kmpc_tpu's spec of the port's parameter ``name``, in the port's
    orientation."""
    from kmpc_tpu_torch.utils.params import jax_path

    path, transpose = jax_path(name)
    node = jspecs
    for token in path.split("//"):
        node = node[int(token[1:-1])] if token.startswith("[") else node[token]
    spec = tuple(node)
    if not any(spec):
        return ()
    spec = spec + (None,) * (2 - len(spec))
    return spec[::-1] if transpose else spec


@pytest.mark.parametrize("preset", ["finance_sparse", "generic_sparse", "lista",
                                    "lista_nonlinear"])
def test_param_specs_match_kmpc_tpu(preset):
    """GenericKM, SparseKM, LISTAKM with a linear and an MLP encoder: the
    same parameters sharded over 'model' on the same (latent) dimension."""
    jm, params, tm = _models(preset)
    jspecs = JM.param_specs(jm, params)
    specs = TM.param_specs(tm)
    assert set(specs) == {n for n, _ in tm.named_parameters()}
    for name, spec in specs.items():
        assert spec == _jax_spec(jspecs, name), name
    assert specs["kmat"] == (None, "model")


def test_param_specs_name_the_latent_products():
    _, _, tm = _models("finance_sparse")
    specs = TM.param_specs(tm)
    sharded = {n: s for n, s in specs.items() if s}
    assert sharded == {"kmat": (None, "model"),
                       "encoder.network.4.weight": ("model", None),
                       "decoder.network.0.weight": (None, "model")}
    _, _, lm = _models("lista")
    assert {n: s for n, s in TM.param_specs(lm).items() if s} == {
        "kmat": (None, "model"), "dict": ("model", None),
        "lista.S": (None, "model"), "lista.We.weight": ("model", None)}


@requires_8
def test_indivisible_latent_is_replicated_as_kmpc_tpu(ranks):
    """z=33 on a 'model' axis of 2: kmpc_tpu replicates every parameter,
    and so do the four ranks."""
    from kmpc_tpu.models import make_model as jmake

    cfg = jcfg.get_config("finance_sparse")
    cfg.MODEL.TARGET_SIZE = 33
    cfg.MODEL.ENCODER.LAYERS = [64]
    jm = jmake(cfg, R.OBS)
    sharded = JM.shard_params(jm.init(jax.random.PRNGKey(0)), jm,
                              _jmesh(R.TRAIN_MESH))
    assert all(leaf.sharding.spec == jax.sharding.PartitionSpec()
               for leaf in jax.tree.leaves(sharded))
    got = {k: str(v) for k, v in ranks.items() if k.startswith("z33/")}
    assert got and all(v == "R,R,R" for v in got.values())


def test_process_local_batch_size_and_scaling_report():
    assert TD.process_local_batch_size(64) == JD.process_local_batch_size(64)
    rep = TD.scaling_report(80_000.0, num_chips=2, per_chip_baseline=50_000.0)
    assert rep == JD.scaling_report(80_000.0, num_chips=2,
                                    per_chip_baseline=50_000.0)
    assert rep["scaling_efficiency"] == pytest.approx(0.8)


def test_initialize_distributed_is_a_noop_without_an_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    TD.initialize_distributed()
    TD.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    JD.initialize_distributed()   # kmpc_tpu's is a no-op there too
    with pytest.raises(ValueError, match="world size"):
        TD.initialize_distributed(coordinator_address="127.0.0.1:1")


# ---------------------------------------------------------------------------
# Four gloo ranks: the sharded solver
# ---------------------------------------------------------------------------


def _jax_solver(program, fused):
    if program == "log":
        if fused:
            from kmpc_tpu.ops.mpc_pallas import (
                solve_mpc_log_utility_pallas_packed as f)
        else:
            from kmpc_tpu.ops.mpc import solve_mpc_log_utility_batch as f
    elif program == "scenario":
        if fused:
            from kmpc_tpu.ops.mpc_pallas import (
                solve_mpc_log_utility_scenarios_packed as f)
        else:
            from kmpc_tpu.ops.scenario import (
                solve_mpc_log_utility_scenarios as f)
    else:
        if fused:
            from kmpc_tpu.ops.mpc_pallas import (
                solve_mpc_mean_variance_pallas_packed as f)
        else:
            from kmpc_tpu.ops.mpc import solve_mpc_mean_variance_batch as f
    return f


def _bars(program):
    if program == "mv":
        return MV_W_TOL, MV_OBJ_TOL
    return W_TOL, SCEN_OBJ_TOL if program == "scenario" else OBJ_TOL


def _port_unsharded(program, fused, arrays):
    from kmpc_tpu_torch.ops.mpc import MPCParams

    params = MPCParams(**R.solve_params(program))
    args = [torch.as_tensor(a) for a in arrays]
    if not fused:
        mod = {"log": "mpc", "scenario": "scenario", "mv": "mpc"}[program]
        name = {"log": "solve_mpc_log_utility_batch",
                "scenario": "solve_mpc_log_utility_scenarios",
                "mv": "solve_mpc_mean_variance_batch"}[program]
        fn = getattr(__import__(f"kmpc_tpu_torch.ops.{mod}", fromlist=[name]),
                     name)
        return fn(*args, params)
    from kmpc_tpu_torch.ops.mpc_cuda import (
        solve_mpc_log_utility_packed, solve_mpc_log_utility_scenarios_packed)
    from kmpc_tpu_torch.ops.mv_cuda import solve_mpc_mean_variance_packed

    fn = {"log": solve_mpc_log_utility_packed,
          "scenario": solve_mpc_log_utility_scenarios_packed,
          "mv": solve_mpc_mean_variance_packed}[program]
    return fn(*args, params, device="cpu")


SOLVE_CASES = [(c, f) for c in ("log", "scenario", "mv", "mv_shared")
               for f in (0, 1)]


@pytest.fixture(scope="module")
def jax_solves():
    """kmpc_tpu's solves of each case: sharded on a 2x2x1 mesh of four
    virtual devices, and unsharded."""
    from kmpc_tpu.ops.mpc import MPCParams as JParams

    out = {}
    mesh = _jmesh(R.MESHES["2x2x1"])
    for case, fused in SOLVE_CASES:
        program, arrays = R.solve_inputs()[case]
        params = JParams(**R.solve_params(program))
        args = [jnp.asarray(a) for a in arrays]
        w, info = JM.sharded_mpc_solver(mesh, params, bool(fused),
                                        program)(*args)
        out[case, fused, "sharded"] = (np.asarray(w),
                                       np.asarray(info["objective"]))
        w, info = _jax_solver(program, fused)(*args, params)
        out[case, fused, "unsharded"] = (np.asarray(w),
                                         np.asarray(info["objective"]))
    return out


@requires_8
@pytest.mark.parametrize("mesh", list(R.MESHES))
@pytest.mark.parametrize("case,fused", SOLVE_CASES)
def test_sharded_solver_matches(case, fused, mesh, ranks, jax_solves):
    program, arrays = R.solve_inputs()[case]
    key = f"solve/{case}/{mesh}/{fused}"
    w, obj = ranks[f"{key}/w"], ranks[f"{key}/objective"]
    w_tol, obj_tol = _bars(program)
    assert w.shape == arrays[1].shape[:1] + (arrays[1].shape[-2],
                                             arrays[1].shape[-1])
    wt, it = _port_unsharded(program, fused, arrays)
    refs = {"port": (wt.numpy(), it["objective"].numpy()),
            "kmpc_tpu sharded": jax_solves[case, fused, "sharded"],
            "kmpc_tpu": jax_solves[case, fused, "unsharded"]}
    for name, (wr, objr) in refs.items():
        assert np.max(np.abs(w - wr)) <= w_tol, name
        assert np.max(np.abs(obj - objr)) <= obj_tol, name
    assert set(k.rsplit("/", 1)[1] for k in ranks if k.startswith(key + "/")) \
        == {"w", *TM._SHARDED_INFO_KEYS}
    if program == "mv":
        assert np.all(ranks[f"{key}/turnover_violation"] == 0.0)


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_batch_the_shards_do_not_divide(mesh, ranks):
    """18 problems over 4 shards: the eager solve runs whole on every rank
    (kmpc_tpu replicates it), the fused one is refused."""
    _, arrays = R.solve_inputs()["log_odd"]
    key = f"solve/log_odd/{mesh}"
    wt, it = _port_unsharded("log", 0, arrays)
    np.testing.assert_allclose(ranks[f"{key}/0/w"], wt.numpy(), atol=W_TOL)
    np.testing.assert_allclose(ranks[f"{key}/0/objective"],
                               it["objective"].numpy(), atol=OBJ_TOL)
    assert bool(ranks[f"{key}/1/refused"])
    assert f"{key}/1/w" not in ranks


# ---------------------------------------------------------------------------
# Four gloo ranks: the date-sharded backtest
# ---------------------------------------------------------------------------


def _jax_finance_data():
    from kmpc_tpu.data.finance import FinanceData, FinanceStats

    emb, dates, mean, std, third = R.backtest_panel()
    n = R.BT["N"]
    return FinanceData(
        train=jnp.asarray(emb[:third]), val=jnp.asarray(emb[third:2 * third]),
        test=jnp.asarray(emb), train_dates=dates[:third],
        val_dates=dates[third:2 * third], test_dates=dates,
        stats=FinanceStats(mean=mean, std=std,
                           tickers=[f"A{i}" for i in range(n)]),
        metadata={"n_assets": n, "embedding_dim": 2, "observation_size": 2 * n},
        mean=jnp.asarray(mean), std=jnp.asarray(std), sequence_length=1)


def _backtest_runs(package, K, mesh=None):
    """(cold, warm) histories of the rehearsal's DMD backtests with the
    operator K, in kmpc_tpu ('jax') or the port ('torch')."""
    if package == "jax":
        from kmpc_tpu.backtest.engine import (
            DMDStrategy, make_parallel_backtester)
        from kmpc_tpu.config import BacktestConfig
        from kmpc_tpu.ops.mpc import MPCParams
        fd, K = _jax_finance_data(), jnp.asarray(K)
    else:
        from kmpc_tpu_torch.backtest.engine import (
            DMDStrategy, make_parallel_backtester)
        from kmpc_tpu_torch.config import BacktestConfig
        from kmpc_tpu_torch.ops.mpc import MPCParams
        fd, K = R.finance_data(), torch.as_tensor(K)
    cfg = BacktestConfig(HORIZON=R.BT["horizon"])
    cold = DMDStrategy(mpc=MPCParams(max_iters=R.BT["iters"]), K=K,
                       use_fused_kernel=True)
    warm = DMDStrategy(mpc=MPCParams(max_iters=R.BT["warm_iters"]), K=K,
                       use_fused_kernel=True)
    runs = [make_parallel_backtester(cold, fd, cfg, num_sweeps=R.BT["sweeps"],
                                     mesh=mesh)[0](),
            make_parallel_backtester(
                warm, fd, cfg, num_sweeps=R.BT["sweeps"], mesh=mesh,
                warm_sweeps_iters=R.BT["warm_sweep_iters"])[0]()]
    return [{k: np.asarray(h[k]) for k in ("portfolio_value", "weights")}
            for h in runs]


@requires_8
def test_date_sharded_backtest_matches(ranks):
    """43 dates over 4 shards (edge-padded), DMD through the fused solve,
    cold and with warm sweeps."""
    K = ranks["bt/K"]
    T = ranks["bt/cold/portfolio_value"].shape[0]
    assert T % 4 != 0, "the dates must exercise the padding"
    port = _backtest_runs("torch", K)
    jax_sharded = _backtest_runs("jax", K, _jmesh(R.MESHES["2x2x1"]))
    jax_whole = _backtest_runs("jax", K)
    for i, tag in enumerate(("cold", "warm")):
        pv, w = ranks[f"bt/{tag}/portfolio_value"], ranks[f"bt/{tag}/weights"]
        for ref in (port[i], jax_sharded[i], jax_whole[i]):
            np.testing.assert_allclose(pv, ref["portfolio_value"],
                                       rtol=PV_RTOL, err_msg=tag)
            np.testing.assert_allclose(w, ref["weights"], atol=BT_W_ATOL,
                                       err_msg=tag)


# ---------------------------------------------------------------------------
# Four gloo ranks: data- and tensor-parallel training
# ---------------------------------------------------------------------------


def _port_model(name, ranks, tag="init"):
    from kmpc_tpu_torch.models.koopman import make_model

    model = make_model(R.train_config(name), R.OBS, device="cpu")
    prefix = f"train/{name}/{tag}/"
    model.load_state_dict({k[len(prefix):]: torch.as_tensor(v)
                           for k, v in ranks.items() if k.startswith(prefix)})
    return model


def _jax_step(name, init_model, mesh=None):
    """kmpc_tpu's train step from the port's initial weights on the
    rehearsal's batch: (loss, params carried into the port's names)."""
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu.train import loop as J
    from kmpc_tpu_torch.utils.params import (
        _unflatten_params, params_from_jax, params_to_jax)

    jc = jcfg.get_config("finance_sparse" if name == "generic" else "lista")
    jc.MODEL.TARGET_SIZE = 64
    if name == "generic":
        jc.MODEL.ENCODER.LAYERS = [64]
    jc.TRAIN.BATCH_SIZE, jc.TRAIN.SEQUENCE_LENGTH = R.TRAIN_B, R.TRAIN_L
    jm = jmake(jc, R.OBS)
    params = jax.tree.map(jnp.asarray, _unflatten_params(
        {f"params//{k}": v for k, v in params_to_jax(init_model).items()}))
    state = {"params": params,
             "opt_state": J.build_optimizer(jc, None).init(params),
             "step": jnp.zeros((), jnp.int32)}
    batch = R.train_batch(name)
    batch = (jnp.asarray(batch) if name == "generic"
             else tuple(map(jnp.asarray, batch)))
    if mesh is not None:
        state["params"] = JM.shard_params(state["params"], jm, mesh)
        batch = JM.shard_batch(batch, mesh, ("data", "scenario"))
    state, metrics = J.make_train_step(jc, jm, 1.0)(state, batch)
    return float(metrics["loss"]), params_from_jax(
        jax.tree.map(np.asarray, state["params"]))


def _port_step(name, init_model):
    from kmpc_tpu_torch.train.loop import (
        TrainState, build_optimizer, make_train_step)

    cfg = R.train_config(name)
    state = TrainState(init_model, build_optimizer(cfg, init_model))
    batch = R.train_batch(name)
    batch = (torch.as_tensor(batch) if name == "generic"
             else tuple(map(torch.as_tensor, batch)))
    _, metrics = make_train_step(cfg, init_model, 1.0)(state, batch)
    return float(metrics["loss"]), {n: p.detach()
                                    for n, p in init_model.named_parameters()}


@requires_8
@pytest.mark.parametrize("name", ["generic", "lista"])
def test_dp_tp_train_step_matches(name, ranks):
    """One step at data 2 x model 2 against one process (the port's and
    kmpc_tpu's) and kmpc_tpu's own sharded step, from the same weights on
    the same batch; every rank holds the same parameters after it."""
    loss = float(ranks[f"train/{name}/metrics/loss"])
    after = _port_model(name, ranks, "after")
    refs = {"port": _port_step(name, _port_model(name, ranks)),
            "kmpc_tpu": _jax_step(name, _port_model(name, ranks)),
            "kmpc_tpu sharded": _jax_step(name, _port_model(name, ranks),
                                          _jmesh(R.TRAIN_MESH))}
    for ref, (ref_loss, ref_params) in refs.items():
        assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL), ref
        for n, p in after.named_parameters():
            assert (p.detach() - ref_params[n]).abs().max() <= PARAM_ATOL, \
                (ref, n)
    assert bool(ranks[f"train/{name}/same_on_every_rank"])
    model = _port_model(name, ranks)
    for n, spec in TM.param_specs(model).items():
        want = ["R", "R", "R"]
        if spec:
            want[2] = f"S({spec.index('model')})"
        assert str(ranks[f"train/{name}/placement/{n}"]) == ",".join(want), n


def test_train_finance_under_a_mesh_matches_one_process(ranks, tmp_path):
    """train_finance at PARALLEL 2 x 1 x 2: four steps, rank 0's files
    only, each step's logged loss and the evaluation's validation loss
    against the one-process run of the same config."""
    import json
    from pathlib import Path

    from kmpc_tpu_torch.train.loop import train_finance

    run_dir = Path(str(ranks["tf/run_dir"]))
    assert int(ranks["tf/step"]) == 4 and bool(ranks["tf/same_on_every_rank"])
    assert [p.name for p in run_dir.parent.iterdir()] == [run_dir.name]
    for f in ("config.json", "metrics_history.jsonl", "last/arrays.npz",
              "evaluation_results.json"):
        assert (run_dir / f).exists(), f
    cfg = json.loads((run_dir / "config.json").read_text())["PARALLEL"]
    assert (cfg["DATA"], cfg["SCENARIO"], cfg["MODEL"]) == R.TRAIN_MESH
    _, _, one = train_finance(R.train_finance_config(), log_dir=str(tmp_path),
                              verbose=False, device="cpu")

    def logged(d):
        rows = [json.loads(x) for x in
                (d / "metrics_history.jsonl").read_text().splitlines()]
        return {(r["name"], r["step"]): r["value"] for r in rows
                if r["name"] in ("train/loss", "val/loss")}

    got, want = logged(run_dir), logged(one)
    assert set(got) == set(want) and len(got) == 6   # 4 steps, 2 evaluations
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=LOSS_RTOL), key


# ---------------------------------------------------------------------------
# Four gloo ranks: the distributed helpers
# ---------------------------------------------------------------------------


def test_distributed_helpers_across_ranks(ranks):
    """host_local_to_global: four ranks' rows [2, 3] make a [8, 3] tensor
    whose sum is every rank's rows summed; process_local_batch_size splits
    64 into 16 and refuses 30; make_mesh refuses a shape the world does not
    hold."""
    want = sum((np.arange(6, dtype=np.float32) + 10.0 * r).sum()
               for r in range(4))
    assert tuple(ranks["h2g/shape"]) == (8, 3)
    assert float(ranks["h2g/sum"]) == want
    assert int(ranks["plbs/64"]) == 16 and bool(ranks["plbs/30_refused"])
    assert bool(ranks["mesh/3_refused"])
