"""The port's verification tools against kmpc_tpu's: the scipy oracle, the
native host solver, the parity-CDF harness and the profiler.

The oracle and the native solver are the same numpy / scipy and C++ code
in both packages, so their outputs are compared at rounding level
(objectives within 1e-9, the native weights equal). The harness's merge is
compared number for number on the repository's parity_cache/, which no
test may change (hashed before and after). Torch runs on one thread. The
file imports no JAX at its top, so that its case for the card runs there
with ``-m cuda --noconftest``.
"""

import hashlib
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ORACLE_OBJ_TOL = 1e-9
NATIVE_EAGER_W_TOL = 2e-3   # tests/test_native.py's bar (f64 C++ vs f32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _log_instance(seed, H, N):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(N)), rng.standard_normal((H, N)) * 0.01


def _log_objective(w, cw, y, ridge, c=0.001):
    r = np.exp(y)
    u = np.diff(np.vstack([cw[None], w]), axis=0)
    return (np.sum(np.log((w * r).sum(-1))) - c * np.abs(u).sum()
            - 0.5 * ridge * (w * w).sum())


@pytest.mark.parametrize("ridge", [0.0, 1e-3])
def test_log_utility_oracle_matches_kmpc_tpu(ridge):
    from kmpc_tpu.ops.mpc_oracle import solve_mpc_log_utility_oracle as J
    from kmpc_tpu_torch.ops.mpc_oracle import solve_mpc_log_utility_oracle as T

    warnings.filterwarnings("ignore", message="delta_grad")
    cw, y = _log_instance(2, 5, 12)
    wj, ij = J(cw, y, ridge=ridge)
    wt, it = T(cw, y, ridge=ridge)
    assert it["status"] == ij["status"] == "optimal"
    assert abs(_log_objective(wt, cw, y, ridge)
               - _log_objective(wj, cw, y, ridge)) <= ORACLE_OBJ_TOL
    assert it["value"] == pytest.approx(ij["value"], abs=ORACLE_OBJ_TOL)


def test_mean_variance_oracle_matches_kmpc_tpu():
    from kmpc_tpu.ops.mpc_oracle import solve_mpc_mean_variance_oracle as J
    from kmpc_tpu_torch.ops.mpc_oracle import (
        solve_mpc_mean_variance_oracle as T,
    )

    warnings.filterwarnings("ignore", message="delta_grad")
    rng = np.random.default_rng(4)
    H, N = 3, 10
    cw = rng.dirichlet(np.ones(N))
    mu = rng.standard_normal((H, N)) * 0.01
    A = rng.standard_normal((N, N)) * 0.05
    sig = A @ A.T + np.eye(N) * 1e-4
    wj, ij = J(cw, mu, sig, gamma=5.0)
    wt, it = T(cw, mu, sig, gamma=5.0)
    assert it["status"] == ij["status"] == "optimal"
    assert it["value"] == pytest.approx(ij["value"], abs=ORACLE_OBJ_TOL)


def _files_under(path):
    return sorted(p.relative_to(ROOT).as_posix()
                  for p in path.rglob("*") if p.is_file())


def test_native_builds_under_the_package_and_matches_kmpc_tpu():
    """The port builds its own copy of the C++ source into
    kmpc_tpu_torch/_build/ (nothing under native/ appears or changes) and
    gives kmpc_tpu's native outputs exactly: the same source, flags and
    compiler."""
    from kmpc_tpu_torch import native as TN

    native_dir = ROOT / "native"
    before = {p: (ROOT / p).stat().st_mtime_ns
              for p in _files_under(native_dir)}
    assert TN.SOURCE.is_relative_to(ROOT / "kmpc_tpu_torch")
    assert TN.library_path().parent == ROOT / "kmpc_tpu_torch" / "_build"
    if not TN.native_available():
        pytest.skip("no g++ toolchain")
    assert TN.build_native().parent == ROOT / "kmpc_tpu_torch" / "_build"
    assert TN.num_threads() >= 1
    after = {p: (ROOT / p).stat().st_mtime_ns
             for p in _files_under(native_dir)}
    assert after == before, "the port wrote under native/"

    from kmpc_tpu import native as JN

    rng = np.random.default_rng(1)
    B, H, N = 6, 5, 15
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    wt, _ = TN.solve_mpc_log_utility_native(cw, ys, max_iters=2000,
                                            ridge=1e-3)
    wj, _ = JN.solve_mpc_log_utility_native(cw, ys, max_iters=2000,
                                            ridge=1e-3)
    np.testing.assert_array_equal(wt, wj)
    A = rng.standard_normal((B, N, N)) * 0.05
    sig = (np.einsum("bij,bkj->bik", A, A) + np.eye(N) * 1e-4).astype(
        np.float32)
    mu = (rng.standard_normal((B, 2, N)) * 0.01).astype(np.float32)
    mt, _ = TN.solve_mpc_mean_variance_native(cw, mu, sig, gamma=5.0,
                                              max_iters=1000)
    mj, _ = JN.solve_mpc_mean_variance_native(cw, mu, sig, gamma=5.0,
                                              max_iters=1000)
    np.testing.assert_array_equal(mt, mj)
    # Single-problem shapes, and a shared Sigma broadcast over the batch.
    w1, _ = TN.solve_mpc_log_utility_native(cw[0], ys[0], max_iters=500)
    assert w1.shape == (H, N)
    m1, _ = TN.solve_mpc_mean_variance_native(cw, mu, sig[0], gamma=5.0,
                                              max_iters=500)
    assert m1.shape == (B, 2, N)


def test_native_matches_the_eager_solver_and_is_feasible():
    from kmpc_tpu_torch import native as TN
    from kmpc_tpu_torch.ops.mpc import MPCParams, solve_mpc_log_utility_batch

    if not TN.native_available():
        pytest.skip("no g++ toolchain")
    rng = np.random.default_rng(1)
    B, H, N = 6, 5, 15
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    w_nat, info = TN.solve_mpc_log_utility_native(cw, ys, max_iters=8000)
    assert info["status"] == "optimal"
    w_eager, _ = solve_mpc_log_utility_batch(
        torch.as_tensor(cw), torch.as_tensor(ys),
        MPCParams(max_iters=8000, sigma_scale=2.0))
    assert np.abs(w_nat - w_eager.numpy()).max() < NATIVE_EAGER_W_TOL
    # Feasibility as tests/test_native.py checks it.
    assert np.allclose(w_nat.sum(-1), 1.0, atol=1e-5)
    assert np.all(w_nat >= -1e-6)
    u = np.diff(np.concatenate([cw[:, None], w_nat], axis=1), axis=1)
    assert np.all(np.abs(u).sum(-1) <= 0.2 + 1e-3)


def _hashes(path):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.iterdir()) if p.is_file()}


@pytest.mark.parametrize("family", ["random", "realistic"])
def test_merge_family_matches_the_root_harness(family, tmp_path):
    """The port's merge on the repository's records (its own cache an empty
    directory) gives the root harness's numbers exactly, and leaves
    parity_cache/ as it was."""
    import parity_cdf as J
    from kmpc_tpu_torch import parity_cdf as T

    cache = ROOT / "parity_cache"
    before = _hashes(cache)
    cw, ys = T.get_instances(family, 1000, tmp_path, device="cpu")
    cwj, ysj = J.get_instances(family, 1000, cache)
    np.testing.assert_array_equal(cw, cwj)
    np.testing.assert_array_equal(ys, ysj)
    ft = T.merge_family(family, cw, ys, 1e-3, [1000, 30000], tmp_path,
                        device="cpu")
    fj = J.merge_family(family, cwj, ysj, 1e-3, [1000, 30000], cache)
    assert ft == fj
    assert ft["settings"]["pdhg_30000_polished"]["n"] > 0
    assert _hashes(cache) == before
    assert list(tmp_path.iterdir()) == []     # nothing needed solving


def test_make_random_instances_bit_for_bit():
    import parity_cdf as J
    from kmpc_tpu_torch import parity_cdf as T

    for n, seed in ((6, 3), (50, 0)):
        for a, b in zip(T.make_random_instances(n, seed),
                        J.make_random_instances(n, seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert T.polish_order(1000) == J.polish_order(1000)


def test_profiler_sync_stage_timer_benchmark_and_trace(tmp_path):
    """``sync`` gives kmpc_tpu's checksum on the same arrays (sums of small
    integers and halves, exact in float32 in any order); StageTimer and
    benchmark time CPU work; trace writes a Chrome trace."""
    import jax.numpy as jnp
    import json

    from kmpc_tpu.utils import profiler as JP
    from kmpc_tpu_torch.utils import profiler as TP

    rng = np.random.default_rng(0)
    a = rng.integers(-50, 50, size=(7, 9)).astype(np.float32) / 2
    b = rng.integers(0, 9, size=(11,)).astype(np.int32)
    flags = np.array([True, False, True])
    tree_t = {"a": torch.as_tensor(a), "rest": [torch.as_tensor(b),
                                                torch.as_tensor(flags)]}
    tree_j = {"a": jnp.asarray(a), "rest": [jnp.asarray(b),
                                            jnp.asarray(flags)]}
    assert TP.sync(tree_t) == JP.sync(tree_j)
    assert TP.sync({}) == JP.sync({}) == 0.0

    timer = TP.StageTimer()
    for _ in range(3):
        with timer.stage("matmul", torch.ones(2)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    s = timer.summary()["matmul"]
    assert s["count"] == 3 and s["total_s"] > 0
    assert "matmul" in timer.report()

    res = TP.benchmark(lambda x: x @ x, torch.ones(32, 32), reps=3)
    assert set(res) == {"best_s", "mean_s", "reps"} and res["reps"] == 3
    assert 0 < res["best_s"] <= res["mean_s"]

    with TP.trace(str(tmp_path)) as prof:
        torch.ones(128, 128) @ torch.ones(128, 128)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]
    assert prof.key_averages()


@pytest.mark.cuda
def test_polished_path_runs_on_the_card():
    """On a card (this file imports no JAX: ``--noconftest`` runs it
    there): the float64 stages run on the card (the outputs and the
    polished dual lie there, in float64), and the card certifies the same
    instances as the CPU, weights within 1e-7 where both certify."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py's verify_path runs "
                    "the same checks)")
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_polish import (
        solve_mpc_log_utility_batch_polished,
    )

    rng = np.random.default_rng(0)
    B, H, N = 8, 3, 6
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    y = (rng.standard_normal((B, H, N)) * 0.01 + 1e-3).astype(np.float32)
    params = MPCParams(max_iters=3000, sigma_scale=2.0, ridge=1e-3,
                       polish=True)
    wc, ic = solve_mpc_log_utility_batch_polished(
        torch.tensor(cw, device="cuda"), torch.tensor(y, device="cuda"),
        params)
    assert wc.is_cuda and wc.dtype == torch.float64
    assert ic["dual"].is_cuda and ic["dual"].dtype == torch.float64
    wh, ih = solve_mpc_log_utility_batch_polished(
        torch.tensor(cw), torch.tensor(y), params)
    rc, rh = ic["residual_after"].cpu().numpy(), ih["residual_after"].numpy()
    np.testing.assert_array_equal(rc < 1e-10, rh < 1e-10)
    both = (rc < 1e-10) & (rh < 1e-10)
    assert both.any()
    assert np.abs(wc.cpu().numpy() - wh.numpy())[both].max() < 1e-7
