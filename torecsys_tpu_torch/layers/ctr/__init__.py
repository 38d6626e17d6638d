"""CTR layers (counterpart of ``torecsys_tpu/layers/ctr``)."""

from torecsys_tpu_torch.layers.ctr.dense import MultilayerPerceptionLayer
from torecsys_tpu_torch.layers.ctr.factorization import FactorizationMachineLayer

__all__ = ["FactorizationMachineLayer", "MultilayerPerceptionLayer"]
