"""Multi-task, mixture-of-experts and matching CTR models (counterpart of
``torecsys_tpu/models/ctr/multitask.py``): DeepMoE, MMoE, ESMM, ESM² and
DeepMCP, registered under the JAX package's names and aliases.

``from_inputs`` reads the widths off the ``Inputs`` (``num_fields`` and
``embed_size`` of ``emb_inputs``; DeepMCP's ``user_size`` and
``content_size``, the flattened widths of ``user_emb_inputs`` and
``content_emb_inputs``); every other argument is the JAX package's.  The
outputs are the JAX package's: MMoE's ``(B, num_tasks)`` raw scores,
DeepMoE's ``(B, num_gates)``, and the tuples of ESMM and ESM² (sigmoid
heads, ``outputs_probability = True``) and of DeepMCP.  Under
``set_compute_dtype("bfloat16")`` the experts, the gates, the towers and
the heads run in bf16; ``Sequential`` casts each output to float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr import MixtureOfExpertsLayer, MultilayerPerceptionLayer
from torecsys_tpu_torch.layers.precision import sigmoid
from torecsys_tpu_torch.models.base import CtrBaseModel, input_shape, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

Activation = Callable[[torch.Tensor], torch.Tensor]


class _FlatMLPExpert(nn.Module):
    """An expert: a :class:`MultilayerPerceptionLayer` over the flattened
    ``(B, N·E)`` features → ``(B, O)``, named ``MultilayerPerceptionLayer_0``
    as flax names it inside the expert."""

    def __init__(self, in_features: int, output_size: int, layer_sizes: Sequence[int],
                 dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None):
        super().__init__()
        self.MultilayerPerceptionLayer_0 = MultilayerPerceptionLayer(
            in_features, output_size, layer_sizes=tuple(layer_sizes), dropout_rate=dropout_rate,
            activation=activation, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.MultilayerPerceptionLayer_0.reset_parameters(generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return self.MultilayerPerceptionLayer_0(emb_inputs.reshape(emb_inputs.shape[0], -1))


def _expert_factory(output_size, layer_sizes, dropout_rate, activation, device):
    def make(in_features: int) -> _FlatMLPExpert:
        return _FlatMLPExpert(in_features, output_size, layer_sizes, dropout_rate, activation,
                              device)

    return make


def _emb_widths(inputs, kwargs):
    n, e = input_shape(inputs, "emb_inputs")
    kwargs.setdefault("num_fields", n)
    kwargs.setdefault("embed_size", e)
    return kwargs


@register_model("DeepMoE", "DeepMixtureOfExperts")
class DeepMixtureOfExpertsModel(CtrBaseModel):
    """``num_moe_layers`` stacked MoE layers (``moe_0`` ...; experts are
    MLPs) → the sum over the last axis → ``(B, num_gates)``.  Layer ``i >
    0`` reads layer ``i - 1``'s ``(B, G, K·O)`` as ``(fields, embed)``."""

    def __init__(self, num_fields: int, embed_size: int, num_moe_layers: int = 1,
                 num_experts: int = 4, num_gates: int = 1, expert_output_size: int = 16,
                 expert_layer_sizes: Sequence[int] = (32,), deep_dropout_rate: float = 0.0,
                 activation: Activation = torch.relu, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_moe_layers = num_moe_layers
        factory = _expert_factory(expert_output_size, expert_layer_sizes, deep_dropout_rate,
                                  activation, dev)
        fields, embed = num_fields, embed_size
        for i in range(num_moe_layers):
            self.add_module(f"moe_{i}", MixtureOfExpertsLayer(
                fields, embed, factory, num_experts, num_gates, device=dev))
            fields, embed = num_gates, num_experts * expert_output_size
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        return cls(**_emb_widths(inputs, kwargs))

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        x = emb_inputs
        for i in range(self.num_moe_layers):
            x = getattr(self, f"moe_{i}")(x)
        return torch.sum(x, dim=2)


@register_model("MMoE", "MultiGateMixtureOfExperts")
class MultiGateMixtureOfExpertsModel(CtrBaseModel):
    """An MoE layer with one gate per task (``moe``) → one tower MLP per
    task (``tower_{t}``, output 1) over its gate's ``(B, K·O)`` row →
    ``(B, num_tasks)`` raw scores."""

    def __init__(self, num_fields: int, embed_size: int, num_tasks: int, num_experts: int = 4,
                 expert_output_size: int = 16, expert_layer_sizes: Sequence[int] = (32,),
                 tower_layer_sizes: Sequence[int] = (16,), deep_dropout_rate: float = 0.0,
                 activation: Activation = torch.relu, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_tasks = num_tasks
        self.moe = MixtureOfExpertsLayer(
            num_fields, embed_size,
            _expert_factory(expert_output_size, expert_layer_sizes, deep_dropout_rate,
                            activation, dev),
            num_experts, num_tasks, device=dev)
        for t in range(num_tasks):
            self.add_module(f"tower_{t}", MultilayerPerceptionLayer(
                num_experts * expert_output_size, 1, layer_sizes=tuple(tower_layer_sizes),
                dropout_rate=deep_dropout_rate, activation=activation, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        return cls(**_emb_widths(inputs, kwargs))

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        moe_out = self.moe(emb_inputs)  # (B, T, K·O)
        return torch.cat([getattr(self, f"tower_{t}")(moe_out[:, t, :])
                          for t in range(self.num_tasks)], dim=1)


class _PooledHeads(CtrBaseModel):
    """Sigmoid heads (MLPs to 1, named as the JAX package names them) over
    the mean over E of ``(B, N, E)``: each head's input is N."""

    outputs_probability = True
    heads: Sequence[str] = ()

    def __init__(self, num_fields: int, deep_layer_sizes: Sequence[int] = (64, 64),
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        for name in self.heads:
            self.add_module(name, MultilayerPerceptionLayer(
                num_fields, 1, layer_sizes=tuple(deep_layer_sizes),
                dropout_rate=deep_dropout_rate, activation=activation, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("num_fields", input_shape(inputs, "emb_inputs")[0])
        return cls(**kwargs)

    def _probabilities(self, emb_inputs: torch.Tensor):
        pooled = torch.mean(emb_inputs, dim=2)  # (B, N)
        # a bf16 head's sigmoid rounds as the JAX package's does (layers.precision)
        return [sigmoid(getattr(self, name)(pooled)) for name in self.heads]


@register_model("ESMM", "EntireSpaceMultiTask")
class EntireSpaceMultiTaskModel(_PooledHeads):
    """Two sigmoid heads, ``cvr_deep`` and ``ctr_deep`` → ``(pCVR, pCTR)``,
    each ``(B, 1)``."""

    heads = ("cvr_deep", "ctr_deep")

    def forward(self, emb_inputs: torch.Tensor):
        pcvr, pctr = self._probabilities(emb_inputs)
        return pcvr, pctr


@register_model("ESM2", "ElaboratedEntireSpaceSupervisedMultiTask")
class ElaboratedEntireSpaceSupervisedMultiTaskModel(_PooledHeads):
    """Four conditional-probability heads composed into the ESM² purchase
    graph → ``(p_click, p_d_action, p_buy)``, each ``(B, 1)``."""

    heads = ("impress_to_click_deep", "click_to_d_action_deep", "d_action_to_buy_deep",
             "o_action_to_buy_deep")

    def forward(self, emb_inputs: torch.Tensor):
        p_impress_click, p_click_d_action, p_d_action_buy, p_o_action_buy = (
            self._probabilities(emb_inputs))
        p_impress_d_action = p_impress_click * p_click_d_action
        p_click_d_action_buy = p_click_d_action * p_d_action_buy
        p_click_o_action_buy = (1.0 - p_click_d_action_buy) * p_o_action_buy
        p_click_buy = p_click_d_action_buy + p_click_o_action_buy
        p_impress_buy = p_impress_click * p_click_buy
        return p_impress_click, p_impress_d_action, p_impress_buy


@register_model("DeepMCP", "DeepMatchingCorrelationPrediction")
class DeepMatchingCorrelationPredictionModel(CtrBaseModel):
    """The prediction, matching and correlation subnets over the user,
    content, positive and negative item embeddings →
    ``(y_pred (B, 1), y_match (B, 1), y_corr_pos (B, 1), y_corr_neg (B,
    K))``: ``prediction`` over concat(user, content); ``match_user`` and
    ``match_item`` tanh towers, their dot product, a sigmoid; the shared
    ``correlation`` tower over content, the positive item and each of the K
    negatives (``neg_emb_inputs`` ``(B, K, ...)``, each as wide as the
    content), dot products against the content's, sigmoids."""

    def __init__(self, user_size: int, content_size: int,
                 pred_layer_sizes: Sequence[int] = (64, 64),
                 match_layer_sizes: Sequence[int] = (64,), match_output_size: int = 16,
                 corr_layer_sizes: Sequence[int] = (64,), corr_output_size: int = 16,
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)

        def mlp(in_features, out, sizes):
            return MultilayerPerceptionLayer(in_features, out, layer_sizes=tuple(sizes),
                                             dropout_rate=deep_dropout_rate,
                                             activation=activation, device=dev)

        self.prediction = mlp(user_size + content_size, 1, pred_layer_sizes)
        self.match_user = mlp(user_size, match_output_size, match_layer_sizes)
        self.match_item = mlp(content_size, match_output_size, match_layer_sizes)
        self.correlation = mlp(content_size, corr_output_size, corr_layer_sizes)
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("user_size", math.prod(input_shape(inputs, "user_emb_inputs")))
        kwargs.setdefault("content_size", math.prod(input_shape(inputs, "content_emb_inputs")))
        return cls(**kwargs)

    def forward(self, user_emb_inputs: torch.Tensor, content_emb_inputs: torch.Tensor,
                pos_emb_inputs: torch.Tensor, neg_emb_inputs: torch.Tensor):
        b = user_emb_inputs.shape[0]
        user = user_emb_inputs.reshape(b, -1)
        content = content_emb_inputs.reshape(b, -1)
        pos = pos_emb_inputs.reshape(b, -1)
        negs = neg_emb_inputs.reshape(b, neg_emb_inputs.shape[1], -1)  # (B, K, C)
        y_pred = self.prediction(torch.cat([user, content], dim=1))
        user_match = torch.tanh(self.match_user(user))
        item_match = torch.tanh(self.match_item(content))
        y_match = torch.sigmoid(torch.sum(user_match * item_match, dim=1, keepdim=True))
        content_corr = self.correlation(content)  # (B, C')
        pos_corr = self.correlation(pos)
        neg_corr = self.correlation(negs)  # (B, K, C')
        y_corr_pos = torch.sigmoid(torch.sum(content_corr * pos_corr, dim=1, keepdim=True))
        y_corr_neg = torch.sigmoid(torch.einsum("bc,bkc->bk", content_corr, neg_corr))
        return y_pred, y_match, y_corr_pos, y_corr_neg


DeepMCP = DeepMatchingCorrelationPredictionModel
DeepMoE = DeepMixtureOfExpertsModel
ESM2 = ElaboratedEntireSpaceSupervisedMultiTaskModel
ESMM = EntireSpaceMultiTaskModel
MMoE = MultiGateMixtureOfExpertsModel

__all__ = ["DeepMCP", "DeepMatchingCorrelationPredictionModel", "DeepMixtureOfExpertsModel",
           "DeepMoE", "ESM2", "ESMM", "ElaboratedEntireSpaceSupervisedMultiTaskModel",
           "EntireSpaceMultiTaskModel", "MMoE", "MultiGateMixtureOfExpertsModel"]
