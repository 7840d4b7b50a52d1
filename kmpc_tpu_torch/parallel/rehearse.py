"""Rehearse the parallel layer on gloo ranks on the CPU, at small sizes.

    python -m kmpc_tpu_torch.parallel.rehearse --out DIR

Every rank runs the same cases sharded on a mesh of the world (the inputs
made from numpy seeds by the functions below, so another program can feed
the same ones to a reference), and rank 0 writes the results to
``DIR/results.npz`` and the sharded training run under ``DIR/train_finance``:

- the three programs through ``sharded_mpc_solver`` at meshes 2x2x1 and
  4x1x1, eager and fused (the kernels' plain versions on the CPU), a
  per-problem and a shared covariance, an eager batch the shards do not
  divide (replicated) and the fused one refused;
- a date-sharded DMD Jacobi backtest whose dates the shards do not divide,
  cold and with warm sweeps;
- one data- and tensor-parallel train step at 2x1x2 of GenericKM (z=64)
  and LISTAKM from seeded weights, with whether every rank holds the same
  parameters after it, and the placements of a z=33 model (replicated:
  'model' does not divide it);
- ``train_finance`` under a 2x1x2 ``PARALLEL`` mesh for four steps;
- ``host_local_to_global`` summed across ranks and
  ``process_local_batch_size``.

It needs a world of four ranks (the meshes above).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

from kmpc_tpu_torch.parallel.distributed import (
    host_local_to_global, initialize_distributed, process_local_batch_size,
)
from kmpc_tpu_torch.parallel.launch import launch
from kmpc_tpu_torch.parallel.mesh import (
    full, make_mesh, make_sharded_train_step, same_on_every_rank,
    shard_params, sharded_mpc_solver,
)

WORLD = 4
MESHES = {"2x2x1": (2, 2, 1), "4x1x1": (4, 1, 1)}
TRAIN_MESH = (2, 1, 2)
B, H, N, S = 16, 5, 12, 4
LOG_ITERS, MV_ITERS, MV_GAMMA = 300, 300, 5.0
BT = dict(T=48, N=6, seed=11, horizon=3, sweeps=3, iters=150,
          warm_iters=200, warm_sweep_iters=50)
OBS, TRAIN_B, TRAIN_L = 40, 16, 4


def solve_inputs():
    """{case: (program, arrays)}: the batched problems of the sharded
    solves (tests/test_sharding.py's sizes)."""
    rng = np.random.default_rng(3)
    f32 = np.float32
    cw = rng.dirichlet(np.ones(N), size=B).astype(f32)
    ys = (rng.standard_normal((B, H, N)) * 0.01).astype(f32)
    scen = (rng.standard_normal((B, S, H, N)) * 0.01).astype(f32)
    mu = (rng.standard_normal((B, 1, N)) * 0.01).astype(f32)
    A = rng.standard_normal((B, N, N)) * 0.01
    sig = (np.einsum("bij,bkj->bik", A, A) + np.eye(N) * 1e-4).astype(f32)
    A1 = rng.standard_normal((N, N)) * 0.01
    shared = (A1 @ A1.T + np.eye(N) * 1e-4).astype(f32)
    cw_odd = rng.dirichlet(np.ones(N), size=B + 2).astype(f32)
    ys_odd = (rng.standard_normal((B + 2, H, N)) * 0.01).astype(f32)
    return {"log": ("log", (cw, ys)), "scenario": ("scenario", (cw, scen)),
            "mv": ("mv", (cw, mu, sig)), "mv_shared": ("mv", (cw, mu, shared)),
            "log_odd": ("log", (cw_odd, ys_odd))}


def solve_params(program: str) -> dict:
    """The MPCParams fields of a program's solves."""
    if program == "mv":
        return dict(max_iters=MV_ITERS, gamma=MV_GAMMA)
    return dict(max_iters=LOG_ITERS)


def backtest_panel():
    """(embedded standardised returns [rows, 2 N], dates, mean, std, third):
    a synthetic panel as tests/test_backtest.py's ``_mock_finance_data``
    builds it (T=48, N=6, seed 11, embedding 2)."""
    from kmpc_tpu_torch.data.finance import time_delay_embedding

    rng = np.random.default_rng(BT["seed"])
    T, n = BT["T"], BT["N"]
    rets = rng.standard_normal((T, n)).astype(np.float32) * 0.01
    mean = rets[: T // 2].mean(0)
    std = np.maximum(rets[: T // 2].std(0), 1e-8)
    emb = time_delay_embedding((rets - mean) / std, 2)
    dates = pd.bdate_range("2021-01-01", periods=len(emb))
    return emb, dates, mean, std, len(emb) // 3


def finance_data(device="cpu"):
    """The port's FinanceData of :func:`backtest_panel`."""
    from kmpc_tpu_torch.data.finance import FinanceData, FinanceStats

    emb, dates, mean, std, third = backtest_panel()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    n = BT["N"]
    return FinanceData(
        train=t(emb[:third]), val=t(emb[third:2 * third]), test=t(emb),
        train_dates=dates[:third], val_dates=dates[third:2 * third],
        test_dates=dates,
        stats=FinanceStats(mean=mean, std=std,
                           tickers=[f"A{i}" for i in range(n)]),
        metadata={"n_assets": n, "embedding_dim": 2, "observation_size": 2 * n},
        mean=t(mean), std=t(std), sequence_length=1)


def train_config(name: str, target_size: int = 64):
    """The port's config of a training case: 'generic' (finance_sparse's
    GenericKM, encoder [64], the sequence loss) or 'lista' (the lista
    preset, pairwise), at z=``target_size``."""
    from kmpc_tpu_torch.config import get_config

    cfg = get_config("finance_sparse" if name == "generic" else "lista")
    cfg.MODEL.TARGET_SIZE = target_size
    if name == "generic":
        cfg.MODEL.ENCODER.LAYERS = [64]
    cfg.TRAIN.BATCH_SIZE = TRAIN_B
    cfg.TRAIN.SEQUENCE_LENGTH = TRAIN_L
    return cfg


def train_batch(name: str):
    """A global batch: windows [B, L+1, obs] for the sequence loss, a pair
    (x, nx) [B, obs] for the pairwise one."""
    rng = np.random.default_rng(1)
    win = rng.standard_normal((TRAIN_B, TRAIN_L + 1, OBS)).astype(np.float32)
    return win if name == "generic" else (win[:, 0], win[:, 1])


def train_finance_config():
    """``train_finance``'s config: a narrow finance_sparse on a three-asset
    synthetic panel, four steps, logs every step, an evaluation at step 3."""
    from kmpc_tpu_torch.config import FinanceConfig, get_config

    cfg = get_config("finance_sparse")
    cfg.MODEL.TARGET_SIZE = 16
    cfg.MODEL.ENCODER.LAYERS = [32]
    cfg.TRAIN.NUM_STEPS = 4
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TRAIN.LOG_INTERVAL = 1
    cfg.TRAIN.EVAL_INTERVAL = 3
    cfg.ENV.FINANCE = FinanceConfig(
        TICKERS=["T1", "T2", "T3"], START_DATE="2018-01-01",
        END_DATE="2021-12-31", TRAIN_END="2019-12-31", VAL_END="2020-12-31",
        EMBEDDING_DIM=3, CACHE_DIR=None, SYNTHETIC=True)
    return cfg


def _mesh(sizes):
    d, s, m = sizes
    return make_mesh({"data": d, "scenario": s, "model": m}, device="cpu")


def _placements(model) -> dict:
    return {n: ",".join(str(pl) for pl in p.placements)
            for n, p in model.named_parameters()}


def run_rank(out: Path) -> None:
    from kmpc_tpu_torch.backtest.engine import (
        DMDStrategy, make_parallel_backtester,
    )
    from kmpc_tpu_torch.config import BacktestConfig
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.train.loop import init_train_state, train_finance

    torch.set_num_threads(1)
    res = {}

    def t(a):
        return torch.as_tensor(a)

    for mname, sizes in MESHES.items():
        mesh = _mesh(sizes)
        for case, (program, arrays) in solve_inputs().items():
            for fused in (0, 1):
                solve = sharded_mpc_solver(
                    mesh, MPCParams(**solve_params(program)),
                    use_fused_kernel=bool(fused), program=program)
                key = f"solve/{case}/{mname}/{fused}"
                try:
                    w, info = solve(*map(t, arrays))
                except ValueError:
                    res[f"{key}/refused"] = True
                    continue
                res[f"{key}/w"] = w
                res.update({f"{key}/{k}": v for k, v in info.items()})

    mesh = _mesh(MESHES["2x2x1"])
    fd = finance_data()
    strat = DMDStrategy(mpc=MPCParams(max_iters=BT["iters"]),
                        use_fused_kernel=True).fit(fd.train)
    res["bt/K"] = strat.K
    cfg_bt = BacktestConfig(HORIZON=BT["horizon"])
    hist = make_parallel_backtester(strat, fd, cfg_bt, num_sweeps=BT["sweeps"],
                                    mesh=mesh)[0]()
    warm = DMDStrategy(mpc=MPCParams(max_iters=BT["warm_iters"]), K=strat.K,
                       use_fused_kernel=True)
    hist_w = make_parallel_backtester(
        warm, fd, cfg_bt, num_sweeps=BT["sweeps"],
        warm_sweeps_iters=BT["warm_sweep_iters"], mesh=mesh)[0]()
    for tag, h in (("cold", hist), ("warm", hist_w)):
        res[f"bt/{tag}/portfolio_value"] = h["portfolio_value"]
        res[f"bt/{tag}/weights"] = h["weights"]

    mesh = _mesh(TRAIN_MESH)
    for name in ("generic", "lista"):
        cfg = train_config(name)
        model = make_model(cfg, OBS, device="cpu")
        state = init_train_state(cfg, model, torch.Generator().manual_seed(5))
        res.update({f"train/{name}/init/{n}": v.detach().clone()
                    for n, v in model.state_dict().items()})
        batch = train_batch(name)
        batch = t(batch) if name == "generic" else tuple(map(t, batch))
        step = make_sharded_train_step(cfg, model, mesh)
        state, metrics = step(state, batch)
        res.update({f"train/{name}/metrics/{k}": v for k, v in metrics.items()})
        res.update({f"train/{name}/after/{n}": full(p.detach())
                    for n, p in model.named_parameters()})
        res[f"train/{name}/same_on_every_rank"] = same_on_every_rank(model)
        for n, pl in _placements(model).items():
            res[f"train/{name}/placement/{n}"] = pl
    narrow = shard_params(make_model(train_config("generic", 33), OBS,
                                     device="cpu"), mesh)
    for n, pl in _placements(narrow).items():
        res[f"z33/placement/{n}"] = pl

    tf_dir = out / "train_finance"
    tcfg = train_finance_config()
    tcfg.PARALLEL.DATA, tcfg.PARALLEL.SCENARIO, tcfg.PARALLEL.MODEL = TRAIN_MESH
    state, _, run_dir = train_finance(tcfg, log_dir=str(tf_dir), verbose=False,
                                      device="cpu")
    res["tf/run_dir"] = str(run_dir)
    res["tf/step"] = state.step
    res["tf/same_on_every_rank"] = same_on_every_rank(state.model)

    rank = dist.get_rank()
    mesh = _mesh(MESHES["4x1x1"])
    local = np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * rank
    g = host_local_to_global(mesh, "data", local)
    res["h2g/shape"] = np.asarray(g.shape)
    res["h2g/sum"] = full(g.sum())
    res["plbs/64"] = process_local_batch_size(64)
    try:
        process_local_batch_size(30)
        res["plbs/30_refused"] = False
    except ValueError:
        res["plbs/30_refused"] = True
    try:
        make_mesh({"data": 3}, device="cpu")
        res["mesh/3_refused"] = False
    except ValueError:
        res["mesh/3_refused"] = True

    if rank == 0:
        np.savez(out / "results.npz", **{
            k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in res.items()})
    dist.barrier()


def rehearse(out, timeout: float = 180.0) -> dict:
    """Start a world of WORLD gloo ranks (one thread each) running the
    cases into ``out`` and return ``results.npz`` as a dict; the world is
    killed if it outlasts ``timeout`` seconds."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    launch([sys.executable, "-m", "kmpc_tpu_torch.parallel.rehearse",
            "--out", str(out), "--rank"], world=WORLD, timeout=timeout,
           env={"OMP_NUM_THREADS": "1"})
    with np.load(out / "results.npz") as npz:
        return {k: npz[k] for k in npz.files}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="results directory")
    parser.add_argument("--rank", action="store_true",
                        help="run as one rank of a world already started")
    args = parser.parse_args(argv)
    if not args.rank:
        res = rehearse(args.out)
        print(f"{len(res)} results in {Path(args.out) / 'results.npz'}")
        return
    initialize_distributed(device="cpu")
    try:
        run_rank(Path(args.out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
