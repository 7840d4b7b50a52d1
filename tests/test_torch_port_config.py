"""kmpc_tpu_torch against kmpc_tpu: configuration, solver parameters,
weight carrying, the finance data pipeline and the package's purity.

Both packages run on the CPU here; inputs come from numpy and pass between
them as numpy arrays.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import kmpc_tpu.config as jcfg
import kmpc_tpu_torch.config as tcfg

ROOT = Path(__file__).resolve().parents[1]

SECTIONS = ["FinanceConfig", "EncoderConfig", "DecoderConfig", "ModelConfig",
            "MPCSolverConfig", "MPCConfig", "BacktestConfig", "Config"]


def _defaults(klass):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(klass)}


@pytest.mark.parametrize("section", SECTIONS)
def test_config_section_defaults_match(section):
    j, t = getattr(jcfg, section), getattr(tcfg, section)
    jd, td = _defaults(j), _defaults(t)
    assert list(jd) == list(td)
    for name in jd:
        a, b = jd[name], td[name]
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        else:
            assert a == b, name


@pytest.mark.parametrize("name", ["default", "generic", "generic_sparse",
                                  "generic_prediction", "lista",
                                  "lista_nonlinear", "finance_sparse"])
def test_get_config_matches(name):
    assert tcfg.get_config(name).to_dict() == jcfg.get_config(name).to_dict()


def test_config_json_round_trip_reads_jax_file(tmp_path):
    cfg = jcfg.get_config("finance_sparse")
    cfg.MPC.SOLVER.MAX_ITERS = 123
    cfg.MODEL.ENCODER.LAYERS = [8, 4]
    cfg.to_json(str(tmp_path / "config.json"))
    back = tcfg.Config.from_json(str(tmp_path / "config.json"))
    assert back.to_dict() == cfg.to_dict()
    assert isinstance(back.MPC.SOLVER, tcfg.MPCSolverConfig)


def test_mpc_params_fields_and_defaults_match():
    from kmpc_tpu.ops.mpc import MPCParams as J
    from kmpc_tpu_torch.ops.mpc import MPCParams as T

    jf = [(f.name, f.default) for f in dataclasses.fields(J)]
    tf = [(f.name, f.default) for f in dataclasses.fields(T)]
    assert jf == tf


@pytest.mark.parametrize("name,overrides", [
    ("finance_sparse", {}),
    ("generic", {"sigma_scale": 2.0, "max_iters": 300}),
    ("finance_sparse", {"horizon": 3, "cost_coeff": 0.002, "precond": True}),
])
def test_mpc_params_from_config_matches(name, overrides):
    from kmpc_tpu.ops.mpc import mpc_params_from_config as jm
    from kmpc_tpu_torch.ops.mpc import mpc_params_from_config as tm

    jc, tc = jcfg.get_config(name), tcfg.get_config(name)
    jc.MPC.SOLVER.TOL = tc.MPC.SOLVER.TOL = 3e-4
    assert (dataclasses.asdict(jm(jc, **overrides))
            == dataclasses.asdict(tm(tc, **overrides)))


def _narrow_models(use_bias, norm_fn, activation):
    """The same narrow GenericKM (obs 40, layers [32, 32], z 16) in both
    packages, the JAX one with its PRNGKey(0) init carried across."""
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu_torch.models.koopman import make_model as tmake
    from kmpc_tpu_torch.utils.params import params_from_jax

    out = []
    for cfgmod in (jcfg, tcfg):
        cfg = cfgmod.get_config("generic")
        cfg.MODEL.TARGET_SIZE = 16
        cfg.MODEL.ENCODER.LAYERS = [32, 32]
        cfg.MODEL.ENCODER.USE_BIAS = use_bias
        cfg.MODEL.ENCODER.ACTIVATION = activation
        cfg.MODEL.DECODER.LAYERS = [24]
        cfg.MODEL.DECODER.USE_BIAS = use_bias
        cfg.MODEL.NORM_FN = norm_fn
        out.append(cfg)
    jm = jmake(out[0], 40)
    params = jm.init(jax.random.PRNGKey(0))
    # A K that is not the identity, so that z @ K's orientation shows.
    rng = np.random.default_rng(3)
    params["kmat"] = np.eye(16, dtype=np.float32) + 0.1 * rng.standard_normal(
        (16, 16)).astype(np.float32)
    tree = jax.tree.map(np.asarray, params)
    tm = tmake(out[1], 40, device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    return jm, params, tm.eval()


@pytest.mark.parametrize("use_bias,norm_fn,activation", [
    (True, "id", "relu"), (False, "ball", "tanh"), (True, "id", "gelu"),
])
def test_params_from_jax_round_trip(use_bias, norm_fn, activation):
    jm, params, tm = _narrow_models(use_bias, norm_fn, activation)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 40)).astype(np.float32)
    z = rng.standard_normal((7, 16)).astype(np.float32)
    with torch.no_grad():
        pairs = [
            (jm.encode(params, x), tm.encode(torch.as_tensor(x))),
            (jm.decode(params, z), tm.decode(torch.as_tensor(z))),
            (jm.step_latent(params, z), tm.step_latent(torch.as_tensor(z))),
        ]
    for j, t in pairs:
        np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5,
                                   rtol=0)


def test_init_params_follows_jax_init_laws():
    from kmpc_tpu_torch.models.koopman import make_model

    cfg = tcfg.get_config("generic")
    cfg.MODEL.ENCODER.USE_BIAS = True
    m = make_model(cfg, 30, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for lin in m.encoder.linears() + m.decoder.linears():
        bound = 1.0 / lin.in_features ** 0.5
        for t in (lin.weight, lin.bias):
            if t is not None:
                assert t.abs().max().item() <= bound
                assert t.abs().max().item() > 0.5 * bound
    assert torch.equal(m.kmat, torch.eye(cfg.MODEL.TARGET_SIZE))
    again = make_model(cfg, 30, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for a, b in zip(m.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_load_jax_checkpoint(tmp_path):
    from kmpc_tpu.models import make_model as jmake
    from kmpc_tpu.train.loop import init_train_state
    from kmpc_tpu.utils.checkpoint import save_checkpoint
    from kmpc_tpu_torch.utils.params import load_jax_checkpoint

    cfg = jcfg.get_config("generic")
    cfg.ENV.ENV_NAME = "finance"
    cfg.MODEL.TARGET_SIZE = 8
    cfg.MODEL.ENCODER.LAYERS = [12]
    cfg.MODEL.ENCODER.USE_BIAS = True
    jm = jmake(cfg, 20)
    state = init_train_state(cfg, jm, jax.random.PRNGKey(1))
    state["step"] = np.asarray(17, np.int32)
    cfg.to_json(str(tmp_path / "config.json"))
    save_checkpoint(tmp_path / "last", state, 17, cfg.to_dict())

    tc, tm, step = load_jax_checkpoint(tmp_path, device="cpu")
    assert step == 17
    assert tc.to_dict() == cfg.to_dict()
    x = np.random.default_rng(1).standard_normal((5, 20)).astype(np.float32)
    with torch.no_grad():
        got = tm.step_env(torch.as_tensor(x)).numpy()
    want = np.asarray(jm.step_env(state["params"], x))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _short_finance(cfgmod):
    fin = cfgmod.FinanceConfig(
        START_DATE="2015-01-01", END_DATE="2016-06-30",
        TRAIN_END="2015-09-30", VAL_END="2015-12-31",
        CACHE_DIR=None, EMBEDDING_DIM=5,
    )
    fin.TICKERS = fin.TICKERS[:7]
    return fin


def test_load_finance_data_matches():
    from kmpc_tpu.data.finance import load_finance_data as jload
    from kmpc_tpu_torch.data.finance import load_finance_data as tload

    jd = jload(_short_finance(jcfg))
    td = tload(_short_finance(tcfg), device="cpu")
    for name in ("train", "val", "test", "mean", "std"):
        a, b = np.asarray(getattr(jd, name)), getattr(td, name)
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0)
    for name in ("train_dates", "val_dates", "test_dates"):
        assert getattr(jd, name).equals(getattr(td, name))
    assert jd.metadata == td.metadata
    obs = td.test[:4]
    np.testing.assert_allclose(
        td.destandardize_returns(td.extract_current_returns(obs)).numpy(),
        np.asarray(jd.destandardize_returns(
            jd.extract_current_returns(jd.test[:4]))), atol=1e-6, rtol=0)


def test_finance_data_reads_cache_and_writes_none_without_cache_dir(tmp_path):
    from kmpc_tpu_torch.data.finance import (
        generate_synthetic_prices, load_price_data,
    )

    tickers = ["A", "B", "C"]
    prices = load_price_data(tickers, "2015-01-01", "2015-03-01",
                             cache_path=None)
    assert list(tmp_path.iterdir()) == []
    pd_ref = generate_synthetic_prices(tickers, "2015-01-01", "2015-03-01")
    assert prices.equals(pd_ref)
    cache = tmp_path / "p.parquet"
    (prices * 2.0).to_parquet(cache)
    assert load_price_data(tickers, "2015-01-01", "2015-03-01",
                           cache_path=cache).equals(prices * 2.0)


def test_time_delay_embedding_matches():
    from kmpc_tpu.data.finance import time_delay_embedding as j
    from kmpc_tpu_torch.data.finance import time_delay_embedding as t

    data = np.random.default_rng(0).standard_normal((11, 3)).astype(np.float32)
    np.testing.assert_array_equal(j(data, 4), t(data, 4))


def test_default_device_never_picks_the_cpu():
    from kmpc_tpu_torch import default_device

    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            default_device()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "kmpc_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_neither_jax_nor_kmpc_tpu(rel):
    banned = {"jax", "jaxlib", "kmpc_tpu"}
    for name in _imports(ROOT / rel):
        top = name.split(".")[0]
        assert top not in banned, f"{rel} imports {name}"
