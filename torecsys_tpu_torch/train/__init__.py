"""Training: pipeline builder, trainer, train step and optimizer state."""

from torecsys_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from torecsys_tpu_torch.train.optimizers import available_optimizers, get_optimizer
from torecsys_tpu_torch.train.pipeline import OBJECTIVES, Pipeline
from torecsys_tpu_torch.train.state import TrainState
from torecsys_tpu_torch.train.steps import interleave_pos_neg, make_eval_step, make_train_step
from torecsys_tpu_torch.train.trainer import Trainer

__all__ = ["OBJECTIVES", "Pipeline", "TrainState", "Trainer", "available_optimizers",
           "get_optimizer", "interleave_pos_neg", "latest_checkpoint", "make_eval_step",
           "make_train_step", "restore_checkpoint", "save_checkpoint"]
