"""Layers of the port (counterpart of ``torecsys_tpu/layers``)."""

from torecsys_tpu_torch.layers.ctr import *  # noqa: F401,F403
from torecsys_tpu_torch.layers.ctr import __all__ as _ctr_all
from torecsys_tpu_torch.layers.base import BaseLayer
from torecsys_tpu_torch.layers.emb import GeneralizedMatrixFactorizationLayer, StarSpaceLayer
from torecsys_tpu_torch.layers.regularization import Regularizer
from torecsys_tpu_torch.layers.rnn import (
    RNN,
    Bidirectional,
    GRUCell,
    OptimizedLSTMCell,
    SimpleCell,
    flip_sequences,
)

GMFLayer = GeneralizedMatrixFactorizationLayer

__all__ = [*_ctr_all, "BaseLayer", "Bidirectional", "GMFLayer", "GRUCell",
           "GeneralizedMatrixFactorizationLayer", "OptimizedLSTMCell", "RNN", "Regularizer",
           "SimpleCell", "StarSpaceLayer", "flip_sequences"]
