from molnextr_tpu_torch.train.losses import (
    Criterion,
    graph_loss,
    label_smoothing_ce,
    sequence_loss,
)
from molnextr_tpu_torch.train.state import TrainState, create_train_state, make_schedules
from molnextr_tpu_torch.train.step import eval_step, multi_train_step, train_step

__all__ = [
    "Criterion",
    "graph_loss",
    "label_smoothing_ce",
    "sequence_loss",
    "TrainState",
    "create_train_state",
    "make_schedules",
    "train_step",
    "multi_train_step",
    "eval_step",
]
