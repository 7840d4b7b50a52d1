"""kmpc_tpu_torch against kmpc_tpu: the reference's PyTorch checkpoints.

Reference-layout state dicts are built by hand (``nn.Sequential`` MLPs with
the activations interleaved, [out, in] Linear weights, right-multiplying K,
S and the dictionary, a ``dict_init`` buffer), as
``tests/test_torch_import.py`` builds them, and ``torch.save``d with the
reference's keys. Bars: the port's load against kmpc_tpu's
``load_torch_checkpoint``, forward within 1e-6; an optimizer resume and one
step against kmpc_tpu's resumed optax step within 3e-6 (optax forms its
bias corrections in float32, 6.5e-6 relative of an update, as
``tests/test_torch_port_train.py`` notes);
the export -> load round trip bit-equal.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import kmpc_tpu.config as jcfg
import kmpc_tpu.utils.torch_import as JI
import kmpc_tpu_torch.config as tcfg
import kmpc_tpu_torch.utils.torch_import as TI
from kmpc_tpu.train.loop import build_optimizer as jbuild
from kmpc_tpu.train.loop import init_train_state as jinit
from kmpc_tpu_torch.models.koopman import make_model as tmake
from kmpc_tpu_torch.train import loop as T

OBS, Z = 6, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp(in_size, out_size, hidden, use_bias):
    layers, prev = [], in_size
    for h in hidden:
        layers += [nn.Linear(prev, h, bias=use_bias), nn.ReLU()]
        prev = h
    layers.append(nn.Linear(prev, out_size, bias=use_bias))
    return nn.Sequential(*layers)


class _RefGenericKM(nn.Module):
    """The reference's GenericKM / SparseKM parameter layout."""

    def __init__(self, use_bias):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.network = _mlp(OBS, Z, [16, 12], use_bias)
        self.decoder = nn.Module()
        self.decoder.network = _mlp(Z, OBS, [12], use_bias)
        self.kmat = nn.Parameter(torch.eye(Z) + 0.01 * torch.randn(Z, Z))


class _RefLISTAKM(nn.Module):
    """The reference's LISTAKM layout, its ``dict_init`` buffer included;
    the encoder linear or an MLP."""

    def __init__(self, linear):
        super().__init__()
        wd = 0.5 * torch.randn(OBS, Z)
        self.dict = nn.Parameter(wd.T.clone())
        self.register_buffer("dict_init", wd.T.clone())
        self.lista = nn.Module()
        if linear:
            self.lista.We = nn.Linear(OBS, Z, bias=False)
        else:
            self.lista.We = nn.Module()
            self.lista.We.network = _mlp(OBS, Z, [16], False)
        self.lista.S = nn.Parameter(torch.eye(Z) - 0.1 * (wd.T @ wd))
        self.kmat = nn.Parameter(torch.eye(Z) + 0.01 * torch.randn(Z, Z))


def _cfg(kind):
    """(kmpc_tpu's config, the port's) for a reference model ``kind``."""
    out = []
    for mod in (jcfg, tcfg):
        if kind in ("generic", "sparse"):
            cfg = mod.get_config("generic")
            cfg.MODEL.MODEL_NAME = "GenericKM" if kind == "generic" else "SparseKM"
            cfg.MODEL.ENCODER.LAYERS = [16, 12]
            cfg.MODEL.DECODER.LAYERS = [12]
            bias = kind == "sparse"
            cfg.MODEL.ENCODER.USE_BIAS = cfg.MODEL.DECODER.USE_BIAS = bias
            cfg.MODEL.ENCODER.LAST_RELU = False
        else:
            cfg = mod.get_config("lista" if kind == "lista_linear"
                                 else "lista_nonlinear")
            cfg.MODEL.ENCODER.LAYERS = [16]
            cfg.MODEL.ENCODER.USE_BIAS = False
            cfg.MODEL.ENCODER.LAST_RELU = False
            cfg.MODEL.ENCODER.LISTA.NUM_LOOPS = 3
            cfg.MODEL.ENCODER.LISTA.L = 10.0
            cfg.MODEL.ENCODER.LISTA.ALPHA = 0.05
        cfg.MODEL.TARGET_SIZE = Z
        out.append(cfg)
    return out


KINDS = ["generic", "sparse", "lista_linear", "lista_mlp"]


def _reference(kind, seed=0):
    torch.manual_seed(seed)
    if kind in ("generic", "sparse"):
        return _RefGenericKM(kind == "sparse")
    return _RefLISTAKM(kind == "lista_linear")


def _reference_optimizer(ref, cfg, steps=3, seed=7):
    """The reference's AdamW (groups: the others at LR with weight decay,
    K at K_MATRIX_LR without) after ``steps`` steps of injected gradients;
    returns it and a function injecting the next gradient."""
    named = list(ref.named_parameters())
    opt = torch.optim.AdamW([
        {"params": [p for n, p in named if "kmat" not in n],
         "lr": cfg.TRAIN.LR, "weight_decay": cfg.TRAIN.WEIGHT_DECAY},
        {"params": [p for n, p in named if "kmat" in n],
         "lr": cfg.TRAIN.K_MATRIX_LR, "weight_decay": 0.0}])
    gen = torch.Generator().manual_seed(seed)

    def inject():
        grads = {}
        for n, p in ref.named_parameters():
            p.grad = torch.randn(p.shape, generator=gen)
            grads[n] = p.grad.clone()
        return grads

    for _ in range(steps):
        inject()
        opt.step()
    return opt, inject


def _save(path, ref, cfg, step=3, opt=None, **extra):
    torch.save({"step": step, "model_state_dict": ref.state_dict(),
                "optimizer_state_dict": opt.state_dict() if opt else {},
                "config": cfg.to_dict(), "metrics": {"loss": 0.5}, **extra},
               path)


@pytest.mark.parametrize("kind", KINDS)
def test_load_matches_kmpc_tpu(kind, tmp_path):
    ref = _reference(kind)
    jc, tc = _cfg(kind)
    path = tmp_path / "checkpoint.pt"
    _save(path, ref, jc, finance_metadata={"n_assets": 3})
    want = JI.load_torch_checkpoint(str(path))
    got = TI.load_torch_checkpoint(str(path), device="cpu")
    assert got["step"] == 3 and got["metrics"] == {"loss": 0.5}
    assert got["finance_metadata"] == {"n_assets": 3}
    assert got["config"].to_dict() == tcfg.Config.from_dict(
        jc.to_dict()).to_dict()
    model = got["model"]
    assert model.model_name == want["model"].model_name
    assert "dict_init" not in dict(model.named_parameters())
    x = np.random.default_rng(1).standard_normal((5, OBS)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    with torch.no_grad():
        zt, yt = model.encode(xt).numpy(), model.step_env(xt).numpy()
    zj = np.asarray(want["model"].encode(want["params"], xj))
    yj = np.asarray(want["model"].step_env(want["params"], xj))
    assert np.abs(zt - zj).max() <= 1e-6 * max(np.abs(zj).max(), 1.0)
    assert np.abs(yt - yj).max() <= 1e-6 * max(np.abs(yj).max(), 1.0)


@pytest.mark.parametrize("kind", ["sparse", "lista_linear"])
def test_optimizer_resume_and_one_step_match_kmpc_tpu(kind, tmp_path):
    """One step after the resume, with the same injected gradient: the
    port's AdamW against kmpc_tpu's resumed optax step and the reference's
    own AdamW step."""
    ref = _reference(kind, seed=3)
    jc, tc = _cfg(kind)
    opt, inject = _reference_optimizer(ref, tc)
    path = tmp_path / "checkpoint.pt"
    _save(path, ref, jc, opt=opt)

    jmodel = JI.load_torch_checkpoint(str(path))["model"]
    jstate = JI.resume_train_state_from_torch(
        str(path), jc, jinit(jc, jmodel, jax.random.PRNGKey(0)))
    tmodel = tmake(tc, OBS, device="cpu")
    tstate = T.init_train_state(tc, tmodel, torch.Generator().manual_seed(0))
    tstate = TI.resume_train_state_from_torch(str(path), tc, tstate)
    assert tstate.step == int(jstate["step"]) == 3

    grads = inject()
    tx = jbuild(jc, jstate["params"])
    updates, _ = tx.update(
        jax.tree.map(jnp.asarray, JI.convert_state_dict(grads, jmodel.model_name)),
        jstate["opt_state"], jstate["params"])
    want = JI.export_params_to_state_dict(
        optax.apply_updates(jstate["params"], updates), jmodel.model_name)
    for n, p in tmodel.named_parameters():
        p.grad = grads[n].clone()
    tstate.optimizer.step()
    opt.step()
    theirs = ref.state_dict()
    for n, p in tmodel.named_parameters():
        got = p.detach().numpy()
        assert np.abs(got - want[n]).max() <= 3e-6, n
        assert np.abs(got - theirs[n].numpy()).max() <= 1e-7, n


def test_resume_needs_the_configured_shapes(tmp_path):
    ref = _reference("sparse")
    jc, tc = _cfg("sparse")
    opt, _ = _reference_optimizer(ref, tc, steps=1)
    path = tmp_path / "checkpoint.pt"
    _save(path, ref, jc, opt=opt)
    tc.MODEL.TARGET_SIZE = 2 * Z
    state = T.init_train_state(tc, tmake(tc, OBS, device="cpu"),
                               torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not match"):
        TI.resume_train_state_from_torch(str(path), tc, state)


def test_weights_only_refuses_a_pickled_object(tmp_path):
    ref = _reference("generic")
    jc, _ = _cfg("generic")
    path = tmp_path / "checkpoint.pt"
    torch.save({"step": 7, "model_state_dict": ref.state_dict(),
                "config": jc.to_dict(),
                "metrics": argparse.Namespace(loss=0.5)}, path)
    with pytest.raises(RuntimeError, match="allow_pickle"):
        TI.load_torch_checkpoint(str(path), device="cpu")
    with pytest.warns(UserWarning, match="allow_pickle=True"):
        ckpt = TI.load_torch_checkpoint(str(path), allow_pickle=True,
                                        device="cpu")
    assert ckpt["step"] == 7 and ckpt["metrics"].loss == 0.5


def test_check_finance_compatibility():
    class FakeFD:
        n_assets = 3
        observation_size = 12
        metadata = {"embedding_dim": 4}

    TI.check_finance_compatibility(FakeFD(), {"finance_metadata": {
        "n_assets": 3, "embedding_dim": 4, "observation_size": 12}})
    for key, bad in (("n_assets", 20), ("embedding_dim", 5),
                     ("observation_size", 13)):
        with pytest.raises(ValueError, match=key):
            TI.check_finance_compatibility(FakeFD(),
                                           {"finance_metadata": {key: bad}})
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        TI.check_finance_compatibility(
            FakeFD(), {"config": tcfg.get_config("finance_sparse")})


@pytest.mark.parametrize("kind", KINDS)
def test_export_load_round_trip_is_bit_equal(kind, tmp_path):
    _, tc = _cfg(kind)
    model = tmake(tc, OBS, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    path = tmp_path / "checkpoint.pt"
    TI.save_reference_checkpoint(path, model, tc, step=11,
                                 finance_metadata={"n_assets": 3})
    back = TI.load_torch_checkpoint(str(path), device="cpu")
    assert back["step"] == 11 and back["finance_metadata"] == {"n_assets": 3}
    for (n, a), (m, b) in zip(model.state_dict().items(),
                              back["model"].state_dict().items()):
        assert n == m and torch.equal(a, b), n
    # kmpc_tpu reads the port's export as a reference checkpoint.
    want = JI.load_torch_checkpoint(str(path))
    for n, a in JI.export_params_to_state_dict(
            want["params"], want["model"].model_name).items():
        assert np.array_equal(a, model.state_dict()[n].numpy()), n


def test_infer_observation_size_bias_first_ordering():
    sd = {"encoder.network.0.bias": torch.zeros(16),
          "encoder.network.0.weight": torch.zeros(16, OBS),
          "encoder.network.2.weight": torch.zeros(Z, 16),
          "encoder.network.2.bias": torch.zeros(Z)}
    assert TI._infer_observation_size(sd, "GenericKM") == OBS
    with pytest.raises(KeyError, match="no GenericKM parameter"):
        TI.convert_state_dict({"lista.S": torch.zeros(Z, Z)}, "GenericKM")


def test_train_resumes_a_reference_checkpoint_at_its_step(tmp_path):
    """``train(checkpoint_path=*.pt)`` continues at the saved step with the
    saved moments: 3 steps resumed from a port run saved at step 2 in the
    reference's layout end where 5 uninterrupted steps end."""
    cfg = tcfg.get_config("generic")
    cfg.ENV.ENV_NAME = "duffing"
    cfg.MODEL.TARGET_SIZE = 8
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_STEPS = 8, 5
    straight, _, _ = T.train(cfg, log_dir=str(tmp_path / "a"), verbose=False,
                             device="cpu")
    cfg.TRAIN.NUM_STEPS = 2
    first, _, _ = T.train(cfg, log_dir=str(tmp_path / "b"), verbose=False,
                          device="cpu")
    path = tmp_path / "checkpoint.pt"
    TI.save_reference_checkpoint(path, first.model, cfg, step=first.step,
                                 optimizer=first.optimizer)
    cfg.TRAIN.NUM_STEPS = 5
    resumed, _, _ = T.train(cfg, log_dir=str(tmp_path / "c"),
                            checkpoint_path=str(path), verbose=False,
                            device="cpu")
    assert resumed.step == straight.step == 5
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
