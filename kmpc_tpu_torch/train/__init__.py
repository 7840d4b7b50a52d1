"""Training: AdamW with a K group, the finance and system loops."""

from kmpc_tpu_torch.train.loop import (
    TrainState, build_optimizer, evaluate_finance, evaluate_system,
    init_train_state, make_system_train_step, make_train_step, train,
    train_finance, train_system,
)

__all__ = [
    "TrainState", "build_optimizer", "evaluate_finance", "evaluate_system",
    "init_train_state", "make_system_train_step", "make_train_step", "train",
    "train_finance", "train_system",
]
