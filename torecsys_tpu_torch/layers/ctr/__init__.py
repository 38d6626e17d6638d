"""CTR layers (counterpart of ``torecsys_tpu/layers/ctr``)."""

from torecsys_tpu_torch.layers.ctr.attention import (
    BiasEncodingLayer,
    ComposeExcitationNetworkLayer,
    DenseGeneral,
    MultiHeadDotProductAttention,
    PositionBiasAwareLearningFrameworkLayer,
    PositionEmbeddingLayer,
)
from torecsys_tpu_torch.layers.ctr.cin import BatchNorm, CompressInteractionNetworkLayer
from torecsys_tpu_torch.layers.ctr.cross import (
    BilinearInteractionLayer,
    BilinearNetworkLayer,
    CrossNetworkLayer,
    FieldAllTypeBilinear,
    FieldEachTypeBilinear,
    FieldInteractionTypeBilinear,
    LowRankCrossNetworkLayer,
)
from torecsys_tpu_torch.layers.ctr.dense import Dense, MultilayerPerceptionLayer, WideLayer
from torecsys_tpu_torch.layers.ctr.factorization import (
    AttentionalFactorizationMachineLayer,
    FactorizationMachineLayer,
    FieldAwareFactorizationMachineLayer,
)
from torecsys_tpu_torch.layers.ctr.moe import MixtureOfExpertsLayer
from torecsys_tpu_torch.layers.ctr.product import (
    InnerProductNetworkLayer,
    OuterProductNetworkLayer,
)
from torecsys_tpu_torch.layers.ctr.routing import DynamicRoutingLayer, resolve_num_capsules

# the JAX package's aliases
AFMLayer = AttentionalFactorizationMachineLayer
CENLayer = ComposeExcitationNetworkLayer
CINLayer = CompressInteractionNetworkLayer
DenseLayer = MultilayerPerceptionLayer
DNNLayer = MultilayerPerceptionLayer
FFMLayer = FieldAwareFactorizationMachineLayer
FMLayer = FactorizationMachineLayer
FullyConnectLayer = MultilayerPerceptionLayer
FeedForwardLayer = MultilayerPerceptionLayer
MOELayer = MixtureOfExpertsLayer
PALLayer = PositionBiasAwareLearningFrameworkLayer
SENETLayer = ComposeExcitationNetworkLayer
SqueezeAndExcitationNetworkLayer = ComposeExcitationNetworkLayer

__all__ = ["AFMLayer", "AttentionalFactorizationMachineLayer", "BatchNorm", "BiasEncodingLayer",
           "BilinearInteractionLayer", "BilinearNetworkLayer", "CENLayer", "CINLayer",
           "ComposeExcitationNetworkLayer", "CompressInteractionNetworkLayer",
           "CrossNetworkLayer", "DNNLayer", "Dense", "DenseGeneral", "DenseLayer",
           "DynamicRoutingLayer", "FFMLayer", "FMLayer", "FactorizationMachineLayer",
           "FeedForwardLayer", "FieldAllTypeBilinear", "FieldAwareFactorizationMachineLayer",
           "FieldEachTypeBilinear", "FieldInteractionTypeBilinear", "FullyConnectLayer",
           "InnerProductNetworkLayer", "LowRankCrossNetworkLayer", "MOELayer",
           "MixtureOfExpertsLayer",
           "MultiHeadDotProductAttention", "MultilayerPerceptionLayer",
           "OuterProductNetworkLayer", "PALLayer", "PositionBiasAwareLearningFrameworkLayer",
           "PositionEmbeddingLayer", "SENETLayer", "SqueezeAndExcitationNetworkLayer",
           "WideLayer", "resolve_num_capsules"]
