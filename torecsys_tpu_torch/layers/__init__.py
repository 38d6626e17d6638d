"""Layers of the port (counterpart of ``torecsys_tpu/layers``)."""

from torecsys_tpu_torch.layers.ctr import FactorizationMachineLayer, MultilayerPerceptionLayer

__all__ = ["FactorizationMachineLayer", "MultilayerPerceptionLayer"]
