"""CTR layers (counterpart of ``torecsys_tpu/layers/ctr``)."""

from torecsys_tpu_torch.layers.ctr.attention import ComposeExcitationNetworkLayer
from torecsys_tpu_torch.layers.ctr.cin import BatchNorm, CompressInteractionNetworkLayer
from torecsys_tpu_torch.layers.ctr.cross import (
    BilinearInteractionLayer,
    BilinearNetworkLayer,
    CrossNetworkLayer,
    FieldAllTypeBilinear,
    FieldEachTypeBilinear,
    FieldInteractionTypeBilinear,
)
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

# the JAX package's aliases of the excitation layer
CENLayer = ComposeExcitationNetworkLayer
SENETLayer = ComposeExcitationNetworkLayer
SqueezeAndExcitationNetworkLayer = ComposeExcitationNetworkLayer

__all__ = ["AttentionalFactorizationMachineLayer", "BatchNorm", "BilinearInteractionLayer",
           "BilinearNetworkLayer", "CENLayer", "ComposeExcitationNetworkLayer",
           "CompressInteractionNetworkLayer", "CrossNetworkLayer", "Dense",
           "FactorizationMachineLayer", "FieldAllTypeBilinear",
           "FieldAwareFactorizationMachineLayer", "FieldEachTypeBilinear",
           "FieldInteractionTypeBilinear", "InnerProductNetworkLayer",
           "MultilayerPerceptionLayer", "OuterProductNetworkLayer", "SENETLayer",
           "SqueezeAndExcitationNetworkLayer", "WideLayer"]
