"""kmpc_tpu_torch against kmpc_tpu: LISTA, LISTAKM and the Koopman losses.

Both packages run on the CPU. kmpc_tpu's initial parameters (from a
PRNGKey) are carried into the port by ``utils/params.py``, and both get the
same numpy inputs. Bars: forward outputs and every loss term relative 1e-5;
gradients (``jax.value_and_grad`` against ``torch.autograd``) relative 1e-4
per tensor, as the norm of the difference over the norm; the dead-codes
case's gradients finite and equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg
from kmpc_tpu.models import make_model as jmake
from kmpc_tpu.models.koopman import spectral_metrics as jspectral
from kmpc_tpu.models.lista import lista_apply, shrink as jshrink
from kmpc_tpu_torch.models.koopman import make_model as tmake
from kmpc_tpu_torch.models.koopman import spectral_metrics as tspectral
from kmpc_tpu_torch.models.lista import shrink as tshrink
from kmpc_tpu_torch.utils.params import (
    _flatten, jax_path, params_from_jax, params_to_jax, torch_name,
)

OBS = 6
REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small CPU operations: one torch thread is as fast, and leaves
    the cores to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(preset, target=16, **train):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_config(preset)
        cfg.MODEL.TARGET_SIZE = target
        if preset == "lista_nonlinear":
            cfg.MODEL.ENCODER.LAYERS = [16, 16]
        for k, v in train.items():
            setattr(cfg.TRAIN, k, v)
        out.append(cfg)
    return out


def _models(preset, obs=OBS, seed=0, target=16, kmat_noise=0.1, **train):
    """kmpc_tpu's model at PRNGKey(seed) and the port's with its weights;
    K perturbed off the identity so its orientation shows."""
    jc, tc = _cfgs(preset, target, **train)
    jm = jmake(jc, obs)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    params["kmat"] = (np.eye(target, dtype=np.float32) + kmat_noise
                      * rng.standard_normal((target, target)).astype(np.float32))
    tm = tmake(tc, obs, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# LISTA
# ---------------------------------------------------------------------------


def test_shrink_matches():
    x = _x((5, 33), 1)
    x[0, :3] = [0.05, -0.05, 0.0]   # exactly at the threshold, and zero
    np.testing.assert_array_equal(
        tshrink(torch.tensor(x), 0.05).numpy(), np.asarray(jshrink(jnp.asarray(x), 0.05)))


@pytest.mark.parametrize("preset", ["lista", "lista_nonlinear"])
def test_lista_apply_matches(preset):
    jm, params, tm = _models(preset, target=24)
    x = _x((9, OBS), 2)
    want = lista_apply(params["lista"], jnp.asarray(x), num_loops=jm.lista_num_loops,
                       alpha=jm.lista_alpha, L=jm.lista_L,
                       activation=jm.encoder_activation,
                       last_relu=jm.encoder_last_relu)
    got = tm.lista(torch.tensor(x)).detach().numpy()
    assert _rel(got, want) <= REL
    assert np.any(np.asarray(want) == 0) and np.any(np.asarray(want) != 0)


@pytest.mark.parametrize("preset,names", [
    ("lista", {"dict", "kmat", "lista.S", "lista.We.weight"}),
    ("lista_nonlinear", {"dict", "kmat", "lista.S", "lista.We.network.0.weight",
                         "lista.We.network.0.bias", "lista.We.network.2.weight",
                         "lista.We.network.2.bias", "lista.We.network.4.weight",
                         "lista.We.network.4.bias"}),
])
def test_lista_state_dict_keys_are_the_reference_modules(preset, names):
    """The names kmpc_tpu/utils/torch_import.py reads from a reference
    LISTAKM state dict, with the reference's [z, x] orientation of We."""
    _, tc = _cfgs(preset, target=12)
    tm = tmake(tc, OBS, device="cpu")
    assert set(tm.state_dict()) == names
    if preset == "lista":
        assert tuple(tm.lista.We.weight.shape) == (12, OBS)
    assert tuple(tm.dict.shape) == (12, OBS)


@pytest.mark.parametrize("preset", ["lista", "lista_nonlinear"])
def test_lista_init_follows_the_jax_init_laws(preset):
    """Dictionary 0.01 randn from the generator; S = I - dict dict^T / L;
    the linear encoder (1/L) dict; K the identity."""
    _, tc = _cfgs(preset, target=32)
    tm = tmake(tc, OBS, device="cpu").init_params(torch.Generator().manual_seed(3))
    d = tm.dict.detach().double()
    L = tc.MODEL.ENCODER.LISTA.L
    assert 0.005 < float(d.std()) < 0.02
    np.testing.assert_allclose(tm.lista.S.detach().double().numpy(),
                               (torch.eye(32, dtype=torch.float64) - d @ d.T / L).numpy(),
                               atol=1e-6)
    if preset == "lista":
        np.testing.assert_allclose(tm.lista.We.weight.detach().numpy(),
                                   (d / L).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(tm.kmat.detach().numpy(), np.eye(32))
    # The same generator seed gives the same weights.
    again = tmake(tc, OBS, device="cpu").init_params(torch.Generator().manual_seed(3))
    for (n, a), (_, b) in zip(tm.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# Forward outputs and the losses
# ---------------------------------------------------------------------------

MODELS = ["generic", "lista", "lista_nonlinear", "generic_sparse"]


@pytest.mark.parametrize("preset", MODELS)
def test_forward_outputs_match(preset):
    jm, params, tm = _models(preset)
    x, nx = _x((8, OBS), 3), _x((8, OBS), 4)
    jx, jnx, tx, tnx = jnp.asarray(x), jnp.asarray(nx), torch.tensor(x), torch.tensor(nx)
    with torch.no_grad():
        pairs = [
            (tm.encode(tx), jm.encode(params, jx)),
            (tm.decode(tm.encode(tx)), jm.decode(params, jm.encode(params, jx))),
            (tm.step_latent(tm.encode(tx)), jm.step_latent(params, jm.encode(params, jx))),
            (tm.step_env(tx), jm.step_env(params, jx)),
            (tm.residual(tx, tnx), jm.residual(params, jx, jnx)),
            (tm.reconstruction(tx), jm.reconstruction(params, jx)),
            (tm.sparsity_loss(tx), jm.sparsity_loss(params, jx)),
            (tm.rollout_sequence(tx, 4), jm.rollout_sequence(params, jx, 4)),
        ]
    for i, (got, want) in enumerate(pairs):
        assert got.shape == tuple(np.shape(want)), i
        assert _rel(got.numpy(), want) <= REL, (i, _rel(got.numpy(), want))


def _metrics_match(tmetrics, jmetrics):
    assert set(tmetrics) == set(jmetrics) == {
        "loss", "residual_loss", "reconst_loss", "prediction_loss",
        "sparsity_loss", "sparsity_ratio"}
    for k in jmetrics:
        got, want = float(tmetrics[k].detach()), float(jmetrics[k])
        assert abs(got - want) <= REL * max(abs(want), 1e-6), (k, got, want)


def _grads_match(tgrads: dict, jgrads, bar=GRAD_REL):
    flat = _flatten(jax.tree.map(np.asarray, jgrads))
    assert {jax_path(n)[0] for n in tgrads} == set(flat)
    for name, g in tgrads.items():
        path, transpose = jax_path(name)
        want = flat[path].T if transpose else flat[path]
        assert np.all(np.isfinite(g)), name
        assert _rel(g, want) <= bar, (name, _rel(g, want))


def _torch_loss_and_grads(tm, fn):
    tm.zero_grad(set_to_none=True)
    total, metrics = fn()
    total.backward()
    return metrics, {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("preset", MODELS)
def test_pairwise_loss_and_gradients_match(preset):
    jm, params, tm = _models(preset)
    x, nx = _x((8, OBS), 5), _x((8, OBS), 6)
    (_, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(x), jnp.asarray(nx)), has_aux=True)(params)
    tmetrics, tgrads = _torch_loss_and_grads(
        tm, lambda: tm.loss(torch.tensor(x), torch.tensor(nx)))
    _metrics_match(tmetrics, jmetrics)
    _grads_match(tgrads, jgrads)


@pytest.mark.parametrize("rollout", ["scan", "kpower"])
@pytest.mark.parametrize("preset", MODELS)
def test_sequence_loss_and_gradients_match(preset, rollout):
    jm, params, tm = _models(preset, ROLLOUT=rollout)
    assert tm.rollout_impl == jm.rollout_impl == rollout
    seq = _x((8, 5, OBS), 7)
    (_, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jm.loss_sequence(p, jnp.asarray(seq)), has_aux=True)(params)
    tmetrics, tgrads = _torch_loss_and_grads(
        tm, lambda: tm.loss_sequence(torch.tensor(seq)))
    _metrics_match(tmetrics, jmetrics)
    _grads_match(tgrads, jgrads)


@pytest.mark.parametrize("rollout", ["scan", "kpower"])
def test_latent_rollout_matches(rollout):
    jm, params, tm = _models("generic", ROLLOUT=rollout)
    z0 = _x((5, 16), 8)
    for steps in (0, 1, 6):
        want = jm.rollout_latent_discrete(params, jnp.asarray(z0), steps)
        got = tm.rollout_latent_discrete(torch.tensor(z0), steps).detach().numpy()
        assert got.shape == (5, steps + 1, 16)
        assert _rel(got, want) <= REL


def test_lista_gradients_finite_with_dead_codes():
    """A sample whose codes are all soft-thresholded to zero makes its
    residual row exactly zero (tests/test_model.py's case): every gradient
    finite, and equal to kmpc_tpu's."""
    jm, params, tm = _models("lista", obs=2, target=64, kmat_noise=0.0)
    x = np.asarray([[1.0, -0.7], [1e-6, -1e-6]], np.float32)
    nx = np.asarray([[0.99, -0.69], [1e-6, -1e-6]], np.float32)
    with torch.no_grad():
        assert float(tm.encode(torch.tensor(x))[1].abs().sum()) == 0.0
    (_, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(x), jnp.asarray(nx)), has_aux=True)(params)
    tmetrics, tgrads = _torch_loss_and_grads(
        tm, lambda: tm.loss(torch.tensor(x), torch.tensor(nx)))
    _metrics_match(tmetrics, jmetrics)
    _grads_match(tgrads, jgrads)


def test_safe_norm_has_a_zero_subgradient_at_zero():
    from kmpc_tpu_torch.models.koopman import _safe_norm

    v = torch.tensor([[0.0, 0.0], [3.0, 4.0]], requires_grad=True)
    _safe_norm(v).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), [[0.0, 0.0], [0.6, 0.8]])


def test_spectral_metrics_match():
    _, params, tm = _models("generic")
    got, want = tspectral(tm.kmat), jspectral(params)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k])
    nan = tspectral(torch.full((3, 3), float("nan")))
    assert all(np.isnan(v) for v in nan.values())


# ---------------------------------------------------------------------------
# make_model and the weight map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["lista", "lista_nonlinear"])
def test_make_model_builds_listakm_at_the_preset_width(preset):
    cfg = tcfg.get_config(preset)
    tm = tmake(cfg, 2, device="cpu")
    assert tm.model_name == "LISTAKM" and tm.target_size == 2048
    assert tm.lista.num_loops == 10


def test_make_model_raises_for_bfloat16():
    """TRAIN.DTYPE bfloat16 builds a model computing in bfloat16 since the
    mixed precision was ported; a dtype of neither kind raises, naming
    compute_dtype."""
    cfg = tcfg.get_config("lista")
    cfg.TRAIN.DTYPE = "bfloat16"
    assert tmake(cfg, 2, device="cpu").compute_dtype == "bfloat16"
    cfg.TRAIN.DTYPE = "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        tmake(cfg, 2, device="cpu")


@pytest.mark.parametrize("preset", MODELS)
def test_params_map_both_ways(preset):
    """params_to_jax is the inverse of params_from_jax, and jax_path of
    torch_name, over every parameter of each preset."""
    _, params, tm = _models(preset)
    flat = _flatten(params)
    back = params_to_jax(tm)
    assert set(back) == set(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr)
        name, transpose = torch_name(path)
        assert jax_path(name) == (path, transpose)
