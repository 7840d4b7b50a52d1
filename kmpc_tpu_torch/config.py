"""Configuration tree of kmpc_tpu_torch.

Its own copy of kmpc_tpu's nested dataclasses (same sections, fields and
defaults, so a JAX run directory's ``config.json`` loads here unchanged)
with its presets: ``default``, ``generic``, ``generic_sparse``,
``generic_prediction``, ``lista``, ``lista_nonlinear`` and
``finance_sparse``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, asdict
from typing import List, Optional


# Default universe of liquid US stocks (diverse sectors).
# Mirrors reference: config.py:135-146.
DEFAULT_FINANCE_TICKERS = [
    # Technology
    "AAPL", "MSFT", "GOOGL", "AMZN", "META",
    # Finance
    "JPM", "BAC", "GS", "V", "MA",
    # Healthcare
    "JNJ", "UNH", "PFE", "ABBV",
    # Consumer
    "PG", "KO", "PEP", "WMT",
    # Energy & Industrials
    "XOM", "CVX",
]


# ---------------------------------------------------------------------------
# Dynamical-system sections (reference: config.py:149-186)
# ---------------------------------------------------------------------------


@dataclass
class ParabolicConfig:
    LAMBDA: float = -1.0
    MU: float = -0.1
    DT: float = 0.1


@dataclass
class DuffingConfig:
    DT: float = 0.01


@dataclass
class PendulumConfig:
    DT: float = 0.01


@dataclass
class LotkaVolterraConfig:
    DT: float = 0.01


@dataclass
class Lorenz63Config:
    DT: float = 0.01


@dataclass
class LyapunovConfig:
    DT: float = 0.05
    SIGMA: float = 0.5


@dataclass
class FinanceConfig:
    """Finance environment configuration (reference: config.py:188-209).

    SYNTHETIC=True generates a deterministic, seeded factor-model price
    panel instead of downloading from yfinance (the reference's network
    boundary, reference: data_finance.py:90-144). The downstream pipeline
    (cleaning, log-returns, standardization, embedding, splits) is
    identical either way.
    """

    TICKERS: List[str] = field(default_factory=lambda: DEFAULT_FINANCE_TICKERS.copy())
    START_DATE: str = "2012-01-01"
    END_DATE: str = "2024-12-31"
    TRAIN_END: str = "2018-12-31"
    VAL_END: str = "2020-12-31"
    EMBEDDING_DIM: int = 20
    CACHE_DIR: Optional[str] = None
    SEQUENCE_LENGTH: int = 10
    SYNTHETIC: bool = True       # no-network default; real data used when a cache file exists
    SYNTHETIC_SEED: int = 1234


@dataclass
class EnvConfig:
    ENV_NAME: str = "duffing"  # duffing|parabolic|pendulum|lotka_volterra|lorenz63|lyapunov|finance
    PARABOLIC: ParabolicConfig = field(default_factory=ParabolicConfig)
    DUFFING: DuffingConfig = field(default_factory=DuffingConfig)
    PENDULUM: PendulumConfig = field(default_factory=PendulumConfig)
    LOTKA_VOLTERRA: LotkaVolterraConfig = field(default_factory=LotkaVolterraConfig)
    LORENZ63: Lorenz63Config = field(default_factory=Lorenz63Config)
    LYAPUNOV: LyapunovConfig = field(default_factory=LyapunovConfig)
    FINANCE: FinanceConfig = field(default_factory=FinanceConfig)


# ---------------------------------------------------------------------------
# Model sections (reference: config.py:225-267)
# ---------------------------------------------------------------------------


@dataclass
class ListaConfig:
    NUM_LOOPS: int = 10
    L: float = 1e3
    ALPHA: float = 0.1
    LINEAR_ENCODER: bool = False


@dataclass
class EncoderConfig:
    LAYERS: List[int] = field(default_factory=lambda: [16, 16])
    LAST_RELU: bool = False
    USE_BIAS: bool = False
    ACTIVATION: str = "relu"  # relu|tanh|gelu
    LISTA: ListaConfig = field(default_factory=ListaConfig)


@dataclass
class DecoderConfig:
    LAYERS: List[int] = field(default_factory=list)
    USE_BIAS: bool = False
    ACTIVATION: str = "relu"


@dataclass
class ModelConfig:
    MODEL_NAME: str = "SparseKM"  # GenericKM|SparseKM|LISTAKM
    NORM_FN: str = "id"           # id|ball
    TARGET_SIZE: int = 16

    # Loss coefficients (reference: config.py:259-263)
    RES_COEFF: float = 1.0
    RECONST_COEFF: float = 0.02
    PRED_COEFF: float = 0.0
    SPARSITY_COEFF: float = 1e-3

    ENCODER: EncoderConfig = field(default_factory=EncoderConfig)
    DECODER: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass
class TrainConfig:
    NUM_STEPS: int = 2_000
    BATCH_SIZE: int = 256
    DATA_SIZE: int = 256 * 8
    LR: float = 1e-4
    WEIGHT_DECAY: float = 1e-4
    K_MATRIX_LR: float = 1e-5

    USE_SEQUENCE_LOSS: bool = False
    SEQUENCE_LENGTH: int = 10

    # TPU-native additions (no reference counterpart — the reference trains
    # on a single cpu/cuda/mps device, reference: train.py:1032-1079)
    DTYPE: str = "float32"          # model COMPUTE dtype: float32|bfloat16.
                                    # bfloat16 = TPU mixed precision: float32
                                    # master params, bf16 matmul inputs and
                                    # activations, float32 MXU accumulation
                                    # and loss reductions (models/koopman.py)
    ROLLOUT: str = "scan"           # latent rollout impl in loss_sequence:
                                    # "scan" (T sequential z@K matmuls) or
                                    # "kpower" (precompute K^1..K^T, apply as
                                    # one batched MXU contraction — only a
                                    # candidate win when BATCH_SIZE >>
                                    # TARGET_SIZE; see KoopmanModel.rollout_impl)
    EVAL_INTERVAL: int = 500
    LOG_INTERVAL: int = 100
    STEPS_PER_DISPATCH: int = 1     # fuse K optimizer steps into ONE compiled
                                    # program (lax.scan over steps, on-device
                                    # batch sampling). Amortizes the ~30 ms
                                    # per-dispatch relay latency; identical
                                    # RNG stream / numerics to K=1. Ignored
                                    # (forced to 1) when a PARALLEL mesh
                                    # shards batches host-side.


# ---------------------------------------------------------------------------
# MPC / backtest sections (reference: mpc.py:17-25, backtest.py:22-30)
# ---------------------------------------------------------------------------


@dataclass
class MPCSolverConfig:
    """First-order batched solver settings (new; replaces CVXPY/ECOS)."""

    MAX_ITERS: int = 2000        # fixed PDHG iteration count (branch-free under jit)
    TOL: float = 0.0             # 0 => always run MAX_ITERS (no data-dependent exit)
    STEP_SCALE: float = 1.0      # primal step safety factor
    OVER_RELAX: float = 1.0      # rho in (0, 2); 1 = plain PDHG. rho=1.9
                                 # measured ~1.86x matched-accuracy
                                 # throughput (in-kernel; outside the
                                 # delta=1 guarantee — see RESULTS.md)
    ADAPTIVE: bool = False       # residual-balancing adaptive step sizes:
                                 # ~6x fewer iterations at matched objective
                                 # accuracy on the log-utility program
                                 # (in-kernel; see MPCParams.adaptive)
    ADAPT_EVERY: int = 1         # >1: compute the balancing residuals and
                                 # adapt tau/sigma only every k-th iteration
                                 # (scalar in-kernel cond) — the residual
                                 # reductions are the adaptive body's ~24%/iter
                                 # tax; the full warm projection budget stays
                                 # per-iteration (see MPCParams.adapt_every)
    POLISH: bool = False         # float64 host semismooth-Newton polish after
                                 # the PDHG solve (verification path: drives the
                                 # fixed-point residual to ~1e-13 on accepted
                                 # problems; runs on CPU, off the jit hot path).
                                 # Honored by solve_mpc_log_utility and
                                 # mpc_polish.solve_mpc_log_utility_batch_polished.
    POLISH_NEWTON: int = 4       # damped Newton steps per polish
    PRECOND: bool = False        # per-horizon-row diagonal (Pock-Chambolle
                                 # style) step preconditioning: boundary
                                 # rows of the difference operator get ~2x
                                 # steps, primal steps use the per-row
                                 # curvature bound (see MPCParams.precond)
    PIPELINE_REDUCES: bool = False  # packed kernel + PROJ_REFRESH_EVERY>1:
                                 # consume the previous iteration's Michelot
                                 # sweep (one-iteration-stale thresholds) so
                                 # the MXU reduce round-trips leave the
                                 # critical path (see
                                 # MPCParams.pipeline_reduces)
    PROJ_REFRESH_EVERY: int = 0  # >1: packed kernel runs 1 warm Michelot sweep
                                 # per PDHG iteration + a full-budget refresh
                                 # every k-th (~1.1x solver speed, ~5e-5
                                 # weight-parity tail); 0 = full budget always


@dataclass
class MPCConfig:
    HORIZON: int = 5
    GAMMA: float = 0.0           # risk aversion (0 = log utility / Kelly)
    COST_COEFF: float = 0.001    # transaction cost (10 bps)
    MAX_TURNOVER: float = 0.2
    ALLOW_SHORT: bool = False
    SOLVER: MPCSolverConfig = field(default_factory=MPCSolverConfig)


@dataclass
class BacktestConfig:
    INITIAL_CAPITAL: float = 10_000.0
    HORIZON: int = 5
    REBALANCE_FREQ: int = 1
    COST_COEFF: float = 0.001
    RISK_FREE_RATE: float = 0.0
    ALLOW_SHORT: bool = False
    LOOKBACK_WINDOW: int = 60


# ---------------------------------------------------------------------------
# Parallelism section (new — reference has no distributed execution,
# SURVEY.md §2 "Parallelism & distributed communication")
# ---------------------------------------------------------------------------


@dataclass
class ParallelConfig:
    """Device-mesh layout for SPMD execution.

    Axes:
      data     — shards the training batch (gradients psum over ICI)
      scenario — shards backtest dates / Monte-Carlo scenarios for MPC
      model    — shards kmat [z, z] and wide encoder/decoder matmuls
    Total mesh size must equal the number of participating devices.
    """

    DATA: int = 1
    SCENARIO: int = 1
    MODEL: int = 1
    # Axis names, in mesh order.
    AXIS_NAMES: List[str] = field(default_factory=lambda: ["data", "scenario", "model"])


# ---------------------------------------------------------------------------
# Root config
# ---------------------------------------------------------------------------


@dataclass
class Config:
    SEED: int = 0
    ENV: EnvConfig = field(default_factory=EnvConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    MPC: MPCConfig = field(default_factory=MPCConfig)
    BACKTEST: BacktestConfig = field(default_factory=BacktestConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self, filepath: str) -> None:
        with open(filepath, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, config_dict: dict) -> "Config":
        return _dataclass_from_dict(cls, config_dict)

    @classmethod
    def from_json(cls, filepath: str) -> "Config":
        with open(filepath, "r") as f:
            return cls.from_dict(json.load(f))


def _dataclass_from_dict(klass, data: dict):
    """Generic recursive dataclass reconstruction (ignores unknown keys)."""
    if not dataclasses.is_dataclass(klass):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(klass)}
    for name, f in fields.items():
        if data is None or name not in data:
            continue
        value = data[name]
        ftype = f.type
        # Resolve string annotations lazily from this module's namespace.
        if isinstance(ftype, str):
            ftype = globals().get(ftype, None)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[name] = _dataclass_from_dict(ftype, value)
        else:
            kwargs[name] = value
    return klass(**kwargs)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def get_default_config() -> Config:
    return Config()


def get_train_generic_km_config() -> Config:
    """GenericKM: standard Koopman AE with an MLP encoder."""
    cfg = Config()
    cfg.TRAIN.LR = 1e-4
    cfg.MODEL.MODEL_NAME = "GenericKM"
    cfg.MODEL.TARGET_SIZE = 64
    cfg.MODEL.NORM_FN = "id"
    cfg.MODEL.DECODER.LAYERS = []
    cfg.MODEL.ENCODER.LAYERS = [64, 64]
    cfg.MODEL.SPARSITY_COEFF = 0.0
    return cfg


def get_train_generic_sparse_config() -> Config:
    """GenericKM with L1 regularization."""
    cfg = Config()
    cfg.TRAIN.LR = 1e-4
    cfg.MODEL.MODEL_NAME = "GenericKM"
    cfg.MODEL.TARGET_SIZE = 64
    cfg.MODEL.NORM_FN = "id"
    cfg.MODEL.DECODER.LAYERS = []
    cfg.MODEL.ENCODER.LAYERS = [64, 64]
    cfg.MODEL.ENCODER.LAST_RELU = True
    cfg.MODEL.ENCODER.USE_BIAS = True
    cfg.MODEL.RECONST_COEFF = 0.5
    cfg.MODEL.SPARSITY_COEFF = 0.01
    return cfg


def get_train_generic_prediction_config() -> Config:
    """Prediction-focused GenericKM."""
    cfg = Config()
    cfg.MODEL.MODEL_NAME = "GenericKM"
    cfg.TRAIN.LR = 1e-3
    cfg.MODEL.DECODER.LAYERS = []
    cfg.MODEL.PRED_COEFF = 1.0
    cfg.MODEL.RES_COEFF = 0.0
    cfg.MODEL.RECONST_COEFF = 0.0
    cfg.MODEL.SPARSITY_COEFF = 0.0
    return cfg


def get_train_lista_config() -> Config:
    """LISTAKM with a linear LISTA encoder, 2048 codes."""
    cfg = Config()
    cfg.MODEL.MODEL_NAME = "LISTAKM"
    cfg.MODEL.ENCODER.LISTA.LINEAR_ENCODER = True
    cfg.MODEL.ENCODER.LISTA.NUM_LOOPS = 10
    cfg.MODEL.TARGET_SIZE = 1024 * 2
    cfg.MODEL.RES_COEFF = 1.0
    cfg.MODEL.RECONST_COEFF = 1.0
    cfg.MODEL.PRED_COEFF = 0.0
    cfg.MODEL.SPARSITY_COEFF = 1.0
    cfg.MODEL.NORM_FN = "id"
    cfg.MODEL.ENCODER.LISTA.L = 0.1
    cfg.MODEL.ENCODER.LISTA.ALPHA = 5e-3
    return cfg


def get_train_lista_nonlinear_config() -> Config:
    """LISTAKM with an MLP encoder (64-64-64, bias, last ReLU), 2048 codes."""
    cfg = Config()
    cfg.MODEL.MODEL_NAME = "LISTAKM"
    cfg.MODEL.ENCODER.LISTA.LINEAR_ENCODER = False
    cfg.MODEL.ENCODER.LAYERS = [64, 64, 64]
    cfg.MODEL.ENCODER.LISTA.NUM_LOOPS = 10
    cfg.MODEL.TARGET_SIZE = 1024 * 2
    cfg.MODEL.RES_COEFF = 1.0
    cfg.MODEL.RECONST_COEFF = 1.0
    cfg.MODEL.PRED_COEFF = 0.0
    cfg.MODEL.SPARSITY_COEFF = 1.0
    cfg.MODEL.NORM_FN = "id"
    cfg.MODEL.ENCODER.LISTA.L = 1e4
    cfg.MODEL.ENCODER.LISTA.ALPHA = 1.0
    cfg.MODEL.ENCODER.LAST_RELU = True
    cfg.MODEL.ENCODER.USE_BIAS = True
    return cfg


def get_train_finance_sparse_config() -> Config:
    """Finance portfolio rebalancing: GenericKM 400 -> 1024 -> 1024 ->
    1024 with bias, a linear 1024 -> 400 decoder, K of 1024 x 1024."""
    cfg = Config()
    cfg.ENV.ENV_NAME = "finance"

    cfg.MODEL.MODEL_NAME = "GenericKM"
    cfg.MODEL.TARGET_SIZE = 1024
    cfg.MODEL.NORM_FN = "id"

    cfg.MODEL.ENCODER.LAYERS = [1024, 1024]
    cfg.MODEL.ENCODER.LAST_RELU = False
    cfg.MODEL.ENCODER.USE_BIAS = True
    cfg.MODEL.ENCODER.ACTIVATION = "relu"

    cfg.MODEL.DECODER.LAYERS = []
    cfg.MODEL.DECODER.USE_BIAS = False

    cfg.MODEL.RES_COEFF = 0.1
    cfg.MODEL.RECONST_COEFF = 0.1
    cfg.MODEL.PRED_COEFF = 0.1
    cfg.MODEL.SPARSITY_COEFF = 1e-3

    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.K_MATRIX_LR = 1e-4
    cfg.TRAIN.NUM_STEPS = 10_000
    cfg.TRAIN.BATCH_SIZE = 64
    cfg.TRAIN.DATA_SIZE = 64 * 20
    cfg.TRAIN.USE_SEQUENCE_LOSS = True
    cfg.TRAIN.SEQUENCE_LENGTH = 10
    cfg.TRAIN.STEPS_PER_DISPATCH = 25

    cfg.ENV.FINANCE.CACHE_DIR = ".cache/finance_data"
    return cfg


_CONFIG_REGISTRY = {
    "generic": get_train_generic_km_config,
    "generic_sparse": get_train_generic_sparse_config,
    "generic_prediction": get_train_generic_prediction_config,
    "lista": get_train_lista_config,
    "lista_nonlinear": get_train_lista_nonlinear_config,
    "finance_sparse": get_train_finance_sparse_config,
}


def get_config(name: str = "default") -> Config:
    """Preset lookup: ``default`` or a name of ``_CONFIG_REGISTRY``."""
    if name == "default":
        return get_default_config()
    if name not in _CONFIG_REGISTRY:
        raise ValueError(
            f"Unknown config name '{name}'. Available: "
            f"{['default', *_CONFIG_REGISTRY]}"
        )
    return _CONFIG_REGISTRY[name]()
