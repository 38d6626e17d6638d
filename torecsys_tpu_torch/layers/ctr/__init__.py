"""CTR layers (counterpart of ``torecsys_tpu/layers/ctr``)."""

from torecsys_tpu_torch.layers.ctr.cin import BatchNorm, CompressInteractionNetworkLayer
from torecsys_tpu_torch.layers.ctr.cross import CrossNetworkLayer
from torecsys_tpu_torch.layers.ctr.dense import Dense, MultilayerPerceptionLayer, WideLayer
from torecsys_tpu_torch.layers.ctr.factorization import (
    AttentionalFactorizationMachineLayer,
    FactorizationMachineLayer,
    FieldAwareFactorizationMachineLayer,
)
from torecsys_tpu_torch.layers.ctr.product import (
    InnerProductNetworkLayer,
    OuterProductNetworkLayer,
)

__all__ = ["AttentionalFactorizationMachineLayer", "BatchNorm",
           "CompressInteractionNetworkLayer", "CrossNetworkLayer", "Dense",
           "FactorizationMachineLayer", "FieldAwareFactorizationMachineLayer",
           "InnerProductNetworkLayer", "MultilayerPerceptionLayer", "OuterProductNetworkLayer",
           "WideLayer"]
