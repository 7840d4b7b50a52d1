"""kmpc_tpu_torch's MV ladder (kernel D) against scripts/mv_ladder.py.

The script's kernel factory is local to its ``main``, so the three bodies
(``carry``, ``sigma``, ``proj``) are written out here with ``jax.numpy`` in
the script's batch-in-lanes layout, line for line from its ``make_kernel``
(the same constants, ``_packed_threshold`` from kmpc_tpu for the warm
sweep, ``iters // unroll`` trips), and the port's plain PyTorch version of
each rung is held against them on the script's inputs. Bar: weights 5e-5
(float32 sums in another order over 40 to 203 iterations; measured about
1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmpc_tpu.ops.mpc_pallas import _packed_threshold
from kmpc_tpu_torch.ops import mv_ladder as D

W_TOL = 5e-5


def _jax_ladder(cw, mu, sig, variant, iters, unroll):
    """scripts/mv_ladder.py ``make_kernel`` with one chain and one tile that
    holds the whole batch: cw [B, N], mu [B, N], sig [B, N, N] -> [B, N]."""
    gamma, c, ss = 5.0, 0.001, 2.0
    B, N = cw.shape
    NP = ((N + 7) // 8) * 8
    cw_t = jnp.asarray(np.pad(cw.T, ((0, NP - N), (0, 0))))          # [NP, B]
    mus = jnp.asarray(np.pad(mu.T, ((0, NP - N), (0, 0))))[None]     # [1,NP,B]
    sigs = jnp.asarray(np.pad(sig.transpose(1, 2, 0),
                              ((0, NP - N), (0, NP - N), (0, 0))))
    row = jax.lax.broadcasted_iota(jnp.int32, (NP, B), 0)
    valid2 = (row < N).astype(jnp.float32)
    nm = jnp.where(row < N, 0.0, -1e30).astype(jnp.float32)[None]
    fro = jnp.sqrt(jnp.sum(sigs * sigs, axis=(0, 1)))[None, None]
    L = jnp.maximum(2.0 * gamma * fro, 1e-6)
    sg = ss * jnp.sqrt(L + 1.0) / 2.0
    tau = 1.0 / (0.5 * L + sg * 4.0)

    def grad_g(w):
        quad = jnp.sum(sigs * w[0][None], axis=1)[None]
        return 2.0 * gamma * quad - mus

    def one_chain(w, p, th):
        if variant == "carry":
            w2 = w - tau * (p - mus)
            return w2, p + sg * (w2 - w), th
        vm = (w - tau * (grad_g(w) + p)) + nm
        if variant == "sigma":
            w_new = jnp.maximum(vm, 0.0)
        else:
            th = _packed_threshold(vm, 1.0, 1, theta0=th, n_valid=float(N))
            w_new = jnp.maximum(vm - th, 0.0)
        w_bar = 2.0 * w_new - w
        p_new = jnp.clip(p + sg * (w_bar - cw_t[None]), -c, c)
        return w_new, p_new, th

    w = jnp.broadcast_to(cw_t[None], (1, NP, B)) * valid2[None]
    carry = (w, jnp.zeros_like(w), jnp.zeros((1, 1, B), jnp.float32))

    def body_u(_, c_):
        for _j in range(unroll):
            c_ = one_chain(*c_)
        return c_

    carry = jax.lax.fori_loop(0, iters // unroll, body_u, carry)
    return np.asarray((carry[0] * valid2[None])[0, :N].T)


@pytest.mark.parametrize("variant", D.VARIANTS)
@pytest.mark.parametrize("unroll,iters,N", [(4, 203, 30), (1, 40, 12),
                                            (4, 80, 33)])
def test_ladder_plain_version_matches_the_script(variant, unroll, iters, N):
    cw, mu, sig = D.ladder_inputs(9, N)
    want = _jax_ladder(cw, mu, sig, variant, iters, unroll)
    got = D.mv_ladder(torch.as_tensor(cw), torch.as_tensor(mu),
                      torch.as_tensor(sig), variant, iters, unroll=unroll,
                      chains=2, warps=2).numpy()
    np.testing.assert_allclose(got, want, atol=W_TOL, rtol=0)
    if variant == "proj":
        # One warm sweep trails the simplex: close to it, not on it.
        assert np.all(got >= 0) and np.all(np.abs(got.sum(-1) - 1.0) < 5e-2)


def test_ladder_inputs_are_the_scripts():
    """Seed 0, a Dirichlet draw, 0.01-scale forecasts, A A' + 1e-4 I."""
    cw, mu, sig = D.ladder_inputs(5, 30)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        cw, rng.dirichlet(np.ones(30), size=5).astype(np.float32))
    np.testing.assert_array_equal(
        mu, (rng.standard_normal((5, 1, 30)) * 0.01).astype(np.float32)[:, 0])
    A = rng.standard_normal((5, 30, 30)) * 0.01
    np.testing.assert_allclose(
        sig, np.einsum("bij,bkj->bik", A, A) + np.eye(30) * 1e-4, rtol=1e-6)


def test_ladder_drops_the_remainder_of_the_unroll():
    cw, mu, sig = (torch.as_tensor(x) for x in D.ladder_inputs(4, 12))
    a = D.mv_ladder_plain(cw, mu, sig, "proj", 43, unroll=4)
    b = D.mv_ladder_plain(cw, mu, sig, "proj", 40, unroll=4)
    c = D.mv_ladder_plain(cw, mu, sig, "proj", 43, unroll=1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_ladder_variants_differ():
    cw, mu, sig = (torch.as_tensor(x) for x in D.ladder_inputs(4, 30))
    outs = [D.mv_ladder_plain(cw, mu, sig, v, 60) for v in D.VARIANTS]
    assert (outs[0] - outs[1]).abs().max() > 1e-4
    assert (outs[1] - outs[2]).abs().max() > 1e-4


@pytest.mark.parametrize("kw", [
    dict(variant="full"), dict(unroll=2), dict(chains=3), dict(warps=9),
    dict(warps=0),
])
def test_ladder_refuses_rungs_it_does_not_have(kw):
    cw, mu, sig = (torch.as_tensor(x) for x in D.ladder_inputs(3, 12))
    args = dict(variant="proj", iters=8, unroll=4, chains=1, warps=4)
    args.update(kw)
    with pytest.raises(ValueError, match="expected variant"):
        D.mv_ladder(cw, mu, sig, **args)


def test_ladder_checks_sizes_and_the_device():
    cw, mu, sig = (torch.as_tensor(x) for x in D.ladder_inputs(3, 12))
    with pytest.raises(ValueError, match="CUDA"):
        D.mv_ladder_cuda(cw, mu, sig, "proj", 8)
    with pytest.raises(ValueError, match=r"\[B, N, N\]"):
        D.mv_ladder_cuda(cw, mu, sig[:2], "proj", 8)
    big = torch.zeros(2, 129)
    with pytest.raises(ValueError, match="N <= 128"):
        D.mv_ladder_plain(big, big, torch.zeros(2, 129, 129), "proj", 4)
    # 8 warps of 4 chains at N=128: 2 MB of covariances, beyond a block.
    assert D.ladder_smem_bytes(128, 4, 8) == 8 * 4 * 128 * 128 * 4
    with pytest.raises(ValueError, match="shared memory"):
        D.mv_ladder(torch.zeros(2, 128), torch.zeros(2, 128),
                    torch.zeros(2, 128, 128), "proj", 4, chains=4, warps=8)
    assert D.ladder_smem_bytes(30, 4, 2) == 2 * 4 * 30 * 32 * 4


def test_ladder_cli_prints_every_rung(capsys):
    rows = D.main(["--cpu", "--batch", "8", "--iters", "8", "--N", "12"])
    out = capsys.readouterr().out
    assert "cpu, plain versions" in out
    assert len(rows) == len(D.RUNGS) == out.count("us/iter")
    assert {r["variant"] for r in rows} == set(D.VARIANTS)
    assert {r["chains"] for r in rows} == set(D.CHAINS)
    assert {r["unroll"] for r in rows} == set(D.UNROLLS)
    assert {r["warps"] for r in rows} == {1, 2, 4, 8}
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    assert D.MV_LADDER.launches == 0
