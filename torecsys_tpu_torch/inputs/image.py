"""Image inputs: convolutional embedders for item images (counterpart of
``torecsys_tpu/inputs/image.py``).

* :class:`ImageInput` — per stage: a convolution, flax's BatchNorm, ReLU,
  dropout, a max pool; then the mean over the image and a Dense head to
  ``(B, 1, E)``.
* :class:`PretrainedImageInput` — a frozen tower from a local ``.npz``
  (:func:`save_tower_weights`' format), an injected backbone, or a
  trainable fallback tower, with a new Dense ``head``.

Images are NHWC ``(B, H, W, C)`` of any dtype (uint8 pixels included), cast
to float32.  The tower computes in float32 whatever the pipeline's compute
dtype, as the JAX package builds it without ``dtype=``.

The convolutions are the JAX package's ``nn.Conv`` (outside any Pallas
kernel there), on the NHWC batch viewed as an NCHW tensor in the
``channels_last`` memory format, with no copy.  flax pads ``'SAME'`` with
``total // 2`` on the low side and the rest on the high side (asymmetric for
a stride above 1 or an even kernel); an asymmetric padding is applied
explicitly.  flax's kernel ``(kh, kw, in, out)`` is the port's ``weight``
``(out, in, kh, kw)`` (``convert``).

Both directions are the port's own (:class:`_Conv2d`), not cuDNN's: the
input unfolded into columns and batched float32 GEMMs (TF32 off, as the
JAX package's float32 ``nn.Conv``), each reduction of a fixed order.  cuDNN
picks its engine, and with it its bits, from the memory free when a plan is
made, so its convolutions could not give a replayed step the bits of its
eager steps; these do.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torecsys_tpu_torch.inputs.base import BaseInput, Batch
from torecsys_tpu_torch.layers.ctr.cin import BatchNorm
from torecsys_tpu_torch.layers.ctr.dense import _TRUNC_STD, Dense
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

SEP = "/"


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``'SAME'`` padding of one spatial axis: ``(low, high)`` with
    ``low = total // 2``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


# the unfolded input of one batch chunk of either direction, at most (bytes)
COLS_BYTES = 256 << 20


def columns(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """``F.unfold(x, kernel, padding=padding, stride=stride)``, ``(n, C*k*k,
    L)``, in one copy of a strided view of the padded input: ``F.unfold`` on
    the card launches a kernel per example."""
    if padding:
        x = F.pad(x, (padding,) * 4)
    win = x.unfold(2, kernel, stride).unfold(3, kernel, stride)  # (n, C, Ho, Wo, k, k)
    n, c, ho, wo = win.shape[:4]
    return win.permute(0, 1, 4, 5, 2, 3).reshape(n, c * kernel * kernel, ho * wo)


def _chunk(x: torch.Tensor, cols_per: int, positions: int) -> int:
    """Examples a batch chunk of :func:`columns` holds (:data:`COLS_BYTES`)."""
    return max(1, COLS_BYTES // (cols_per * positions * x.element_size()))


class _Conv2d(torch.autograd.Function):
    """A convolution of the port's own, both directions, in batch chunks of
    the input unfolded (:func:`columns`, at most :data:`COLS_BYTES` a
    chunk).  cuDNN's deterministic algorithms are each reproducible, but
    which one runs depends on the memory free when its plan is made: at the
    image tower's second convolution (batch 4096, 32 to 64 channels at
    32x32) its forward and input gradient took other bits with 1 GiB free
    beyond their outputs, its weight gradient with 8 GiB, than with the
    card free (``tools/torch_conv_probe.py``).  The forward is each chunk's
    batched product of the columns with the weight, written as
    ``channels_last`` output, plus the bias; the backward's weight gradient
    each chunk's batched product of the output gradient with the columns,
    summed chunk by chunk in order; its input gradient the weight's product
    with the output gradient, folded back (``F.fold``, which gathers); the
    bias gradient a sum.  Every part is a GEMM or a reduction of a fixed
    order: the same bits in every run, eager or replayed."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride: int, padding: int):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        out_ch, k = weight.shape[0], weight.shape[-1]
        w2t = weight.contiguous().reshape(out_ch, -1).t()
        b, _, h, w = x.shape
        ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
        out = x.new_empty((b, ho, wo, out_ch))  # NHWC: the NCHW result channels_last
        chunk = _chunk(x, w2t.shape[0], ho * wo)
        for i in range(0, b, chunk):
            cols = columns(x[i:i + chunk], k, stride, padding)
            dst = out[i:i + chunk].view(-1, ho * wo, out_ch)
            torch.matmul(cols.transpose(1, 2), w2t, out=dst)
            dst.add_(bias)
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        out_ch, k = weight.shape[0], weight.shape[-1]
        geometry = dict(kernel_size=k, padding=ctx.padding, stride=ctx.stride)
        w2 = weight.contiguous().reshape(out_ch, -1)
        grad = grad.contiguous()
        b, cols_per, positions = x.shape[0], w2.shape[1], grad.shape[2] * grad.shape[3]
        chunk = _chunk(x, cols_per, positions)
        gw = torch.zeros_like(w2)
        gx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        for i in range(0, b, chunk):
            go = grad[i:i + chunk].reshape(-1, out_ch, positions)
            cols = columns(x[i:i + chunk], k, ctx.stride, ctx.padding)
            gw += torch.bmm(go, cols.transpose(1, 2)).sum(dim=0)
            if gx is not None:
                gx[i:i + chunk] = F.fold(torch.matmul(w2.t(), go), x.shape[2:], **geometry)
        return gx, gw.reshape(weight.shape), grad.sum(dim=(0, 2, 3)), None, None


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s))``, ``'SAME'``
    padding, on an NCHW tensor (``channels_last`` on the card): ``weight``
    ``(out, in, k, k)`` (flax's ``kernel`` ``(k, k, in, out)``), ``bias``
    ``(out,)``, flax's init (lecun-normal weight over ``k * k * in``, zero
    bias)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.kernel_size, self.stride = kernel_size, stride
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size,
                                               device=dev))
        self.bias = nn.Parameter(torch.empty(features, device=dev))

    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        (hl, hh), (wl, wh) = (same_padding(n, k, s) for n in x.shape[2:])
        pad = 0
        if (hl, wl) == (hh, wh) and hl == wl:
            pad = hl
        elif hl or hh or wl or wh:
            x = F.pad(x, (wl, wh, hl, hh))
        weight = self.weight
        if x.is_cuda:
            weight = weight.contiguous(memory_format=torch.channels_last)
        return _Conv2d.apply(x, weight, self.bias, s, pad)


class ImageInput(BaseInput):
    """Conv tower over item images → ``(B, 1, E)``.

    Per stage ``i``: ``conv_i`` (:class:`Conv`), ``bn_i`` (flax's
    BatchNorm over ``(B, H, W)`` per channel, momentum 0.99, eps 1e-5,
    running ``mean``/``var`` buffers), ReLU, dropout when
    ``dropout_rate > 0`` (torch's generator: the JAX bits cannot be had),
    then a ``'VALID'`` max pool of window and stride ``p`` when ``p > 1``;
    then the mean over H and W and the float32 ``head`` Dense."""

    def __init__(self, embed_size: int, in_channels: int,
                 layers_size: Sequence[int] = (32, 64), kernel_sizes: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), pooling_sizes: Sequence[int] = (2, 2),
                 use_batchnorm: bool = True, dropout_rate: float = 0.0,
                 fields: Sequence[str] = ("image",), device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_size, self.in_channels = embed_size, in_channels
        self.fields = tuple(fields)
        self.use_batchnorm = use_batchnorm
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.stages = tuple(zip(layers_size, kernel_sizes, strides, pooling_sizes))
        channels = in_channels
        for i, (feat, k, s, _) in enumerate(self.stages):
            self.add_module(f"conv_{i}", Conv(channels, feat, k, s, device=dev))
            if use_batchnorm:
                self.add_module(f"bn_{i}", BatchNorm(feat, axis=-1, device=dev))
            channels = feat
        self.head = Dense(channels, embed_size, follows_pipeline=False, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for i in range(len(self.stages)):
            getattr(self, f"conv_{i}").reset_parameters(generator)
            if self.use_batchnorm:
                getattr(self, f"bn_{i}").reset_parameters()
        self.head.reset_parameters(generator)

    def output_shape(self) -> Tuple[int, int]:
        return 1, self.embed_size

    def forward(self, batch: Batch) -> torch.Tensor:
        images = batch[self.fields[0]]
        if images.dim() != 4:
            raise ValueError(f"image field must be (B, H, W, C), got {tuple(images.shape)}")
        # NCHW view of the NHWC batch: channels_last memory, no copy
        x = images.float().permute(0, 3, 1, 2)
        for i, (_, _, _, p) in enumerate(self.stages):
            x = getattr(self, f"conv_{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn_{i}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = torch.relu(x)
            if self.dropout is not None:
                x = self.dropout(x)
            if p > 1:
                x = F.max_pool2d(x, p, p)
        return self.head(x.mean(dim=(2, 3)))[:, None, :]


def save_tower_weights(path: str, tower: ImageInput) -> str:
    """Write an :class:`ImageInput` tower's variables as a flat ``.npz`` of
    flax paths (``params/conv_0/kernel`` in flax's ``(k, k, in, out)``
    layout, ``batch_stats/bn_0/mean``, ...): the format the JAX package's
    ``save_tower_weights`` writes and ``PretrainedImageInput.weights_path``
    reads, in either package.  Returns ``path`` (numpy adds ``.npz`` where it
    is missing, as there)."""
    from torecsys_tpu_torch.convert import flax_array, flax_paths

    flat = {f"params{SEP}{fp}": flax_array(fp, dict(tower.named_parameters())[name])
            for name, fp in flax_paths(tower).items()}
    flat.update({f"batch_stats{SEP}{name.replace('.', SEP)}": b.detach().cpu().numpy()
                 for name, b in tower.named_buffers()})
    np.savez(path, **flat)
    return path


@functools.lru_cache(maxsize=8)
def _load_tower_weights(path: str) -> Dict[str, np.ndarray]:
    """A flat ``.npz`` of tower variables, ``{flax path: array}``, loaded once
    per path (cached, as the JAX package caches its loads)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class PretrainedImageInput(BaseInput):
    """Pretrained-backbone image embedder → ``(B, 1, E)``.  Three branches,
    in this order:

    1. ``weights_path``: a local ``.npz`` of an :class:`ImageInput` tower's
       variables (:func:`save_tower_weights`), built at the JAX default
       widths with ``backbone_embed_size`` outputs.  The tower runs in eval
       mode with those fixed weights and running statistics: constants, not
       parameters, not buffers, not in a checkpoint or the optimizer (the
       JAX package bakes them into its step).  Only ``head`` trains.
    2. ``backbone``: a callable ``images -> (B, F)`` (flattened where it is
       not 2-D; ``frozen`` detaches its output).  An ``nn.Module`` is a
       child named ``backbone`` whose parameters are trained parameters, as
       a flax Module passed as an attribute is adopted with its parameters;
       a plain callable owns none.  The port builds eagerly, so
       ``backbone_features`` gives ``F``.
    3. neither: a trainable :class:`ImageInput` named ``fallback_tower`` of
       ``in_channels`` channels (the JAX package reads them from the images).
    """

    def __init__(self, embed_size: int, backbone: Optional[Callable] = None,
                 frozen: bool = True, fields: Sequence[str] = ("image",),
                 weights_path: Optional[str] = None, backbone_embed_size: int = 64,
                 in_channels: int = 3, backbone_features: Optional[int] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_size, self.fields, self.frozen = embed_size, tuple(fields), frozen
        self.weights_path = weights_path
        self.backbone = None
        if weights_path is not None:
            variables = _load_tower_weights(weights_path)
            tower = ImageInput(backbone_embed_size,
                               variables[f"params{SEP}conv_0{SEP}kernel"].shape[2],
                               fields=fields, device=dev)
            _fill_tower(tower, variables)
            tower.eval()
            for t in (*tower.parameters(), *tower.buffers()):
                t.requires_grad_(False)
            # not registered: its tensors are constants of the step
            object.__setattr__(self, "_tower", tower)
            features = backbone_embed_size
        elif backbone is not None:
            if backbone_features is None:
                raise ValueError("a backbone needs backbone_features, the width of its "
                                 "flattened output (the port builds its head eagerly)")
            self.backbone = backbone
            features = backbone_features
        else:
            self.fallback_tower = ImageInput(embed_size, in_channels, fields=fields, device=dev)
            features = None
        if features is not None:
            self.head = Dense(features, embed_size, follows_pipeline=False, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        if hasattr(self, "head"):
            self.head.reset_parameters(generator)
        else:
            self.fallback_tower.reset_parameters(generator)

    def output_shape(self) -> Tuple[int, int]:
        return 1, self.embed_size

    def forward(self, batch: Batch) -> torch.Tensor:
        if not hasattr(self, "head"):
            return self.fallback_tower(batch)
        x = batch[self.fields[0]].float()
        if self.weights_path is not None:
            with torch.no_grad():
                feats = self._tower({self.fields[0]: x}).reshape(x.shape[0], -1)
        else:
            feats = self.backbone(x)
            if self.frozen:
                feats = feats.detach()
            if feats.dim() != 2:
                feats = feats.reshape(feats.shape[0], -1)
        return self.head(feats)[:, None, :]


def _fill_tower(tower: ImageInput, variables: Dict[str, np.ndarray]) -> None:
    """Copy flat ``params/...`` and ``batch_stats/...`` arrays into ``tower``."""
    from torecsys_tpu_torch.convert import from_flax_params, unflatten

    params = {k.split(SEP, 1)[1]: v for k, v in variables.items() if k.startswith("params" + SEP)}
    stats = {k.split(SEP, 1)[1]: v for k, v in variables.items()
             if k.startswith("batch_stats" + SEP)}
    from_flax_params(tower, unflatten(params), batch_stats=unflatten(stats) if stats else None)


__all__ = ["Conv", "ImageInput", "PretrainedImageInput", "same_padding", "save_tower_weights"]
