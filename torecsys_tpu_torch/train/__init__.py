"""Training: pipeline builder, trainer, train step and optimizer state."""

from torecsys_tpu_torch.train.optimizers import get_optimizer
from torecsys_tpu_torch.train.pipeline import Pipeline
from torecsys_tpu_torch.train.state import TrainState
from torecsys_tpu_torch.train.trainer import Trainer

__all__ = ["Pipeline", "TrainState", "Trainer", "get_optimizer"]
