"""``dryrun_multichip(n)``: the parallel layer once on a world of ``n``
ranks (port of ``__graft_entry__.py``'s ``dryrun_multichip``).

    python -m kmpc_tpu_torch.parallel.dryrun --world 4 --cpu   # 4 gloo ranks
    python -m kmpc_tpu_torch.parallel.dryrun --world 2         # 2 cards, NCCL
    torchrun --nproc_per_node=4 -m kmpc_tpu_torch.parallel.dryrun --world 4

It factors ``n`` into (data, scenario, model) as kmpc_tpu does, takes one
data- and tensor-parallel train step of the flagship model cut small,
solves the three programs sharded through the fused kernels (their plain
versions on the CPU) and the log-utility one through the eager solver
beside them, and runs a date-sharded Jacobi backtest whose dates the
shards do not divide.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Union

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

from kmpc_tpu_torch.parallel.distributed import initialize_distributed
from kmpc_tpu_torch.parallel.launch import launch
from kmpc_tpu_torch.parallel.mesh import (
    make_mesh, make_sharded_train_step, sharded_mpc_solver,
)

FACTORS = {1: (1, 1, 1), 2: (2, 1, 1), 4: (2, 2, 1), 8: (2, 2, 2),
           16: (4, 2, 2), 32: (4, 4, 2)}


def factor(n: int):
    """(data, scenario, model) for ``n`` ranks, as kmpc_tpu factors them."""
    return FACTORS.get(n, (n, 1, 1))


def dryrun_multichip(n_devices: int,
                     device: Optional[Union[str, torch.device]] = None) -> None:
    """The dry run on a world of ``n_devices`` ranks. Called with no world
    and more than one rank, it starts the world (one rank a card, or gloo
    ranks for ``device="cpu"``) and waits for it; inside a world of that
    size it is one rank's part."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not dist.is_initialized() and n_devices > 1:
        outs = launch([sys.executable, "-m", "kmpc_tpu_torch.parallel.dryrun",
                       "--world", str(n_devices), *(["--cpu"] if cpu else [])],
                      world=n_devices, timeout=900,
                      env={"OMP_NUM_THREADS": "1"} if cpu else None)
        print(outs[0], end="", flush=True)
        return
    d, s, m = factor(n_devices)
    mesh = make_mesh({"data": d, "scenario": s, "model": m}, device=device)
    dev = (torch.device("cpu") if mesh.device_type == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    rank = dist.get_rank()

    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.train.loop import init_train_state

    cfg = get_config("finance_sparse")
    cfg.MODEL.TARGET_SIZE = 64
    cfg.MODEL.ENCODER.LAYERS = [64, 64]
    cfg.TRAIN.SEQUENCE_LENGTH = 4
    B = d * s * 4
    cfg.TRAIN.BATCH_SIZE = B
    obs = len(cfg.ENV.FINANCE.TICKERS) * cfg.ENV.FINANCE.EMBEDDING_DIM
    model = make_model(cfg, obs, device=dev)
    state = init_train_state(
        cfg, model, torch.Generator(device=dev).manual_seed(cfg.SEED))
    step = make_sharded_train_step(cfg, model, mesh)
    x_seq = torch.randn((B, cfg.TRAIN.SEQUENCE_LENGTH + 1, obs),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    state, metrics = step(state, x_seq)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), "sharded train step produced a non-finite loss"

    # The three programs, problem-sharded (H=5, 30 assets).
    H, N, S = 5, 30, 3
    nprob = d * s * 8
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cw = t(rng.dirichlet(np.ones(N), size=nprob))
    ys = t(rng.standard_normal((nprob, H, N)) * 0.01)
    w, _ = sharded_mpc_solver(mesh, MPCParams(max_iters=50))(cw, ys)
    wk, _ = sharded_mpc_solver(mesh, MPCParams(max_iters=50),
                               use_fused_kernel=True)(cw, ys)
    assert w.shape == (nprob, H, N) and bool(torch.isfinite(w).all())
    assert float((wk - w).abs().max()) < 5e-3, "fused/eager shard mismatch"
    scen = t(rng.standard_normal((nprob, S, H, N)) * 0.01)
    ws, _ = sharded_mpc_solver(mesh, MPCParams(max_iters=50),
                               use_fused_kernel=True, program="scenario")(cw, scen)
    assert ws.shape == (nprob, H, N) and bool(torch.isfinite(ws).all())
    mu = t(rng.standard_normal((nprob, 1, N)) * 0.01)
    A = rng.standard_normal((N, N)) * 0.01
    sig = t(A @ A.T + np.eye(N) * 1e-4)
    wm, _ = sharded_mpc_solver(mesh, MPCParams(max_iters=50, gamma=5.0),
                               use_fused_kernel=True, program="mv")(cw, mu, sig)
    assert wm.shape == (nprob, 1, N) and bool(torch.isfinite(wm).all())

    bt_dates = _date_sharded_backtest(mesh, dev)
    if rank == 0:
        print(f"dryrun_multichip({n_devices}): mesh(data={d},scenario={s},"
              f"model={m}) on {mesh.device_type}, train loss={loss:.4f}, mpc "
              f"batch={nprob} (eager + fused), scenario S={S}, mean-variance, "
              f"date-sharded backtest ({bt_dates} dates) OK", flush=True)


def _date_sharded_backtest(mesh, dev) -> int:
    """One small date-sharded Jacobi backtest on the mesh (a date count the
    shards do not divide); returns the number of rebalance dates."""
    from kmpc_tpu_torch.backtest.engine import (
        DMDStrategy, make_parallel_backtester,
    )
    from kmpc_tpu_torch.config import BacktestConfig
    from kmpc_tpu_torch.data.finance import (
        FinanceData, FinanceStats, time_delay_embedding,
    )
    from kmpc_tpu_torch.ops.mpc import MPCParams

    rng = np.random.default_rng(2)
    n_assets, d_emb, T = 6, 2, 40
    rets = (rng.standard_normal((T, n_assets)) * 0.01).astype(np.float32)
    mean = rets.mean(0)
    std = np.maximum(rets.std(0), 1e-8)
    emb = time_delay_embedding((rets - mean) / std, d_emb)
    dates = pd.bdate_range("2021-01-04", periods=len(emb))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    fd = FinanceData(
        train=t(emb[:12]), val=t(emb[12:24]), test=t(emb),
        train_dates=dates[:12], val_dates=dates[12:24], test_dates=dates,
        stats=FinanceStats(mean=mean, std=std,
                           tickers=[f"A{i}" for i in range(n_assets)]),
        metadata={"n_assets": n_assets, "embedding_dim": d_emb,
                  "observation_size": d_emb * n_assets},
        mean=t(mean), std=t(std), sequence_length=1,
    )
    strat = DMDStrategy(mpc=MPCParams(max_iters=40), use_fused_kernel=True)
    run, ts = make_parallel_backtester(strat, fd, BacktestConfig(HORIZON=3),
                                       num_sweeps=2, mesh=mesh)
    pv = run()["portfolio_value"]
    assert bool(torch.isfinite(pv).all()) and bool((pv > 0).all())
    return len(ts)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=1,
                        help="ranks in the world (1, 2, 4, 8, ...)")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU (default: one rank a card)")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    initialize_distributed(device=device)
    try:
        dryrun_multichip(args.world, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
