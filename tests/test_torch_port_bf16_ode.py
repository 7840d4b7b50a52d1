"""kmpc_tpu_torch against kmpc_tpu: the bfloat16 compute dtype and the
latent ODE.

Both packages run on the CPU from kmpc_tpu's initial weights (carried by
``utils/params.py``) on the same numpy inputs. The dtypes as
``tests/test_model.py`` asserts of kmpc_tpu (latents and decodes bfloat16,
losses float32, gradients finite float32), and the bfloat16 loss within 5%
of the float32 loss (``tests/test_model.py``'s bar).

The bars against kmpc_tpu's bfloat16 lie between what the port's bfloat16
reads and what the port's float32 compute reads, both measured on the CPU
on these inputs (``generic`` and ``lista``, both rollouts):

- losses, metrics and codes, BF16_REL = 1e-4: bfloat16 0 to 1.3e-7 apart
  (both sum bfloat16 products in float32; only the order differs), float32
  compute 1.0e-3 to 5.1e-3 for losses and metrics, 5.9e-3 and 2.3e-2 for
  codes;
- gradients per tensor (norm of the difference over the norm),
  BF16_GRAD_REL = 1e-2: bfloat16 at most 4.3e-3 (K's gradient sums its
  steps' bfloat16-rounded terms in another order, and upstream of it the
  scan's), float32 compute 1.4e-2 to 3.5e-2 on some tensor of every case.

The ODE: RK4 within 1e-5 of kmpc_tpu's; dopri5 within 1e-4 relative of
kmpc_tpu's ``odeint`` and of float64 ``scipy.linalg.expm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.models import KoopmanModel as JKoopman
from kmpc_tpu.models import make_model as jmake
from kmpc_tpu_torch.models.koopman import KoopmanModel, dopri5
from kmpc_tpu_torch.models.koopman import make_model as tmake
from kmpc_tpu_torch.utils.params import _flatten, jax_path, params_from_jax

OBS = 6
BF16_REL = 1e-4
BF16_GRAD_REL = 1e-2
BF16_F32_REL = 0.05


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(preset, rollout="scan", obs=OBS, target=16):
    """kmpc_tpu's float32 and bfloat16 models with one set of weights (K
    perturbed off the identity), and the port's two with them."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = jcfg.get_config(preset), tcfg.get_config(preset)
        for c in (jc, tc):
            c.MODEL.TARGET_SIZE = target
            c.TRAIN.DTYPE = dtype
            c.TRAIN.ROLLOUT = rollout
        out[dtype] = (jmake(jc, obs), tmake(tc, obs, device="cpu"))
    params = jax.tree.map(np.asarray,
                          out["float32"][0].init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["kmat"] = (np.eye(target, dtype=np.float32) + 0.1
                      * rng.standard_normal((target, target)).astype(np.float32))
    for _, tm in out.values():
        tm.load_state_dict(params_from_jax(params))
    return params, out


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("rollout", ["scan", "kpower"])
@pytest.mark.parametrize("preset", ["generic", "lista"])
def test_bfloat16_sequence_loss_matches_kmpc_tpu(preset, rollout):
    params, m = _models(preset, rollout)
    (j32, t32), (j16, t16) = m["float32"], m["bfloat16"]
    assert t16.compute_dtype == "bfloat16"
    x = _x((8, 4, OBS), 2)
    xt = torch.tensor(x)
    z16 = t16.encode(xt)
    assert z16.dtype == torch.bfloat16
    assert t16.decode(z16).dtype == torch.bfloat16
    assert t16.step_env(xt).shape == xt.shape
    lj, mj = j16.loss_sequence(params, jnp.asarray(x))
    lt, mt = t16.loss_sequence(xt)
    l32, _ = t32.loss_sequence(xt)
    assert lt.dtype == torch.float32 and np.isfinite(float(lt))
    assert _rel(lt, lj) <= BF16_REL, (float(lt), float(lj))
    assert abs(float(lt) - float(l32)) <= BF16_F32_REL * max(abs(float(l32)), 1.0)
    for k in mj:
        assert abs(float(mt[k]) - float(mj[k])) <= BF16_REL * max(
            abs(float(mj[k])), 1.0), k


@pytest.mark.parametrize("preset", ["generic", "lista"])
def test_bfloat16_pairwise_loss_and_codes_match_kmpc_tpu(preset):
    params, m = _models(preset)
    (j16, t16) = m["bfloat16"]
    x, nx = _x((8, OBS), 3), _x((8, OBS), 4)
    lj, _ = j16.loss(params, jnp.asarray(x), jnp.asarray(nx))
    lt, _ = t16.loss(torch.tensor(x), torch.tensor(nx))
    assert lt.dtype == torch.float32
    assert _rel(lt, lj) <= BF16_REL, (float(lt), float(lj))
    zj = np.asarray(j16.encode(params, jnp.asarray(x)).astype(jnp.float32))
    zt = t16.encode(torch.tensor(x)).detach().float().numpy()
    scale = max(np.abs(zj).max(), 1e-30)
    assert np.abs(zt - zj).max() <= BF16_REL * scale


@pytest.mark.parametrize("preset", ["generic", "lista"])
def test_bfloat16_gradients_are_finite_float32(preset):
    _, m = _models(preset)
    t16 = m["bfloat16"][1]
    loss, _ = t16.loss_sequence(torch.tensor(_x((8, 4, OBS), 5)))
    loss.backward()
    for name, p in t16.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("rollout", ["scan", "kpower"])
@pytest.mark.parametrize("preset", ["generic", "lista"])
def test_bfloat16_gradients_match_kmpc_tpu(preset, rollout):
    """Each parameter's gradient of the bfloat16 sequence loss against
    ``jax.grad`` of kmpc_tpu's, per tensor."""
    params, m = _models(preset, rollout)
    j16, t16 = m["bfloat16"]
    x = _x((8, 4, OBS), 2)
    jgrads = jax.grad(lambda p: j16.loss_sequence(p, jnp.asarray(x))[0])(params)
    flat = _flatten(jax.tree.map(np.asarray, jgrads))
    t16.loss_sequence(torch.tensor(x))[0].backward()
    for name, p in t16.named_parameters():
        path, transpose = jax_path(name)
        want = (flat[path].T if transpose else flat[path]).astype(np.float64)
        got = p.grad.numpy().astype(np.float64)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= BF16_GRAD_REL, (name, rel)


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        KoopmanModel(observation_size=4, target_size=8,
                     compute_dtype="float16")


def _ode_inputs(target=16, batch=8, seed=6):
    params, m = _models("generic", target=target)
    j32, t32 = m["float32"]
    z0 = np.asarray(j32.encode(params, jnp.asarray(_x((batch, OBS), seed))))
    return params, j32, t32, z0


@pytest.mark.parametrize("t_span", [np.arange(6) * 0.1,
                                    np.array([0.0, 0.05, 0.2, 0.25, 0.6])])
def test_rk4_matches_kmpc_tpu(t_span):
    """A fixed RK4 step between neighbouring points, uniform or not."""
    params, j32, t32, z0 = _ode_inputs()
    ts = t_span.astype(np.float32)
    zj = np.asarray(j32.integrate_latent_ode(params, jnp.asarray(z0),
                                             jnp.asarray(ts), method="rk4"))
    with torch.no_grad():
        zt = t32.integrate_latent_ode(torch.tensor(z0), torch.tensor(ts),
                                      method="rk4").numpy()
    assert zt.shape == (len(ts), *z0.shape)
    assert np.abs(zt - zj).max() <= 1e-5


@pytest.mark.parametrize("horizon", [0.5, 3.0])
def test_dopri5_matches_odeint_and_expm(horizon):
    params, j32, t32, z0 = _ode_inputs()
    ts = (np.linspace(0.0, horizon, 7)).astype(np.float32)
    zj = np.asarray(j32.integrate_latent_ode(params, jnp.asarray(z0),
                                             jnp.asarray(ts)))
    with torch.no_grad():
        zt = t32.integrate_latent_ode(torch.tensor(z0), torch.tensor(ts)
                                      ).numpy()
    K = params["kmat"].astype(np.float64)
    ref = np.stack([z0.astype(np.float64) @ scipy.linalg.expm(K * t)
                    for t in ts.astype(np.float64)])
    scale = np.abs(ref).max()
    assert np.abs(zt - ref).max() <= 1e-4 * scale
    assert np.abs(zt - zj).max() <= 1e-4 * np.abs(zj).max()


def test_dopri5_lands_on_every_output_time():
    """y' = -y from 1: each output is exp(-t), whatever the spacing."""
    ts = torch.tensor([0.0, 1e-3, 0.5, 0.5001, 2.0, 7.0])
    y = dopri5(lambda v: -v, torch.ones(3), ts)
    ref = torch.exp(-ts)[:, None].expand(-1, 3)
    assert torch.allclose(y, ref, rtol=1e-4, atol=1e-7)


def test_ode_path_integrates_in_float32_under_bfloat16():
    """The latents integrate in float32 whatever the compute dtype; the
    final decode rides it (``tests/test_model.py:496-513``)."""
    params, m = _models("generic", target=8)
    t16 = m["bfloat16"][1]
    x = torch.tensor(_x((8, OBS), 7))
    with torch.no_grad():
        z0 = t16.encode(x)
        traj = t16.integrate_latent_ode(z0, torch.arange(4) * 0.1)
        out = t16.rollout_sequence_ode(x, num_steps=3, dt=0.1)
        rk = t16.rollout_sequence_ode(x, num_steps=3, dt=0.1, method="rk4")
    assert traj.dtype == torch.float32 and traj.shape == (4, 8, 8)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 8, OBS)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - rk.float()).abs().max() <= 0.05 * out.float().abs().max()
    with pytest.raises(ValueError, match="ODE method"):
        t16.integrate_latent_ode(z0, torch.arange(4) * 0.1, method="euler")


def test_rollout_sequence_ode_matches_kmpc_tpu():
    params, m = _models("generic")
    j32, t32 = m["float32"]
    x = _x((5, OBS), 8)
    oj = np.asarray(j32.rollout_sequence_ode(params, jnp.asarray(x),
                                             num_steps=5, dt=0.1))
    with torch.no_grad():
        ot = t32.rollout_sequence_ode(torch.tensor(x), 5, 0.1).numpy()
    assert ot.shape == oj.shape == (6, 5, OBS)
    assert np.abs(ot - oj).max() <= 1e-4 * max(np.abs(oj).max(), 1.0)


def test_jax_bfloat16_model_carries_float32_weights():
    """kmpc_tpu's bfloat16 model keeps float32 parameters, so its tree
    carries into the port as the float32 model's does."""
    jc = jcfg.get_config("generic")
    jc.MODEL.TARGET_SIZE = 8
    jc.TRAIN.DTYPE = "bfloat16"
    jm = jmake(jc, OBS)
    assert isinstance(jm, JKoopman) and jm.compute_dtype == "bfloat16"
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    sd = params_from_jax(params)
    assert all(v.dtype == torch.float32 for v in sd.values())
    tc = tcfg.get_config("generic")
    tc.MODEL.TARGET_SIZE = 8
    tc.TRAIN.DTYPE = "bfloat16"
    tm = tmake(tc, OBS, device="cpu")
    tm.load_state_dict(sd)
    x = _x((4, OBS), 9)
    zj = np.asarray(jm.encode(params, jnp.asarray(x)).astype(jnp.float32))
    zt = tm.encode(torch.tensor(x)).detach().float().numpy()
    assert np.abs(zt - zj).max() <= BF16_REL * max(np.abs(zj).max(), 1e-30)
