"""The precisions the reference computes in.

``stated`` is the configuration's: the towers' products in bf16 as flax's
``Dense(dtype=bfloat16, param_dtype=float32)`` takes them (input and weight
cast to bf16, the product rounded to bf16, the bf16 bias added in bf16,
the activation in bf16), everything else in float32 with TF32 off, which
the reference computes in float64 (``reference.ctr.DTYPE``).

``control`` is one step below each of them: the bf16 products' operands in
fp8 (e4m3, one scale a tensor, as fp8 training takes them) with the product
rounded to bf16; the float32 GEMMs' operands rounded to TF32 (10 bits of
mantissa, round to nearest even); the rows read from the float32 table
rounded to bf16.  Each rounding passes the gradient straight through, so
the backward pass computes on the rounded values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("stated", "control")
FP8_MAX = 448.0


def _through(t: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded``'s values with ``t``'s gradient."""
    return t + (rounded - t).detach()


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded through float8 e4m3 at one scale, its largest
    magnitude onto e4m3's largest."""
    x = t.detach().float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return _through(t.float(), q)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float32, then to TF32's 10-bit mantissa, to nearest
    even; kept in its dtype."""
    bits = t.detach().float().contiguous().view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return _through(t, rounded.view(torch.float32).to(t.dtype))


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, kept in its dtype."""
    return _through(t, t.detach().to(torch.bfloat16).to(t.dtype))


def dense_bf16(x: torch.Tensor, weight: torch.Tensor, bias, mode: str) -> torch.Tensor:
    """A tower layer whose product the configuration states in bf16; the
    output is bf16."""
    if mode == "stated":
        y = F.linear(x.to(torch.bfloat16), weight.to(torch.bfloat16))
    else:
        y = F.linear(fp8(x.float()), fp8(weight)).to(torch.bfloat16)
    return y if bias is None else y + bias.to(torch.bfloat16)


def matmul_f32(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """A GEMM that the configuration states in float32 with TF32 off, in the
    operands' dtype; in ``control`` its operands rounded to TF32."""
    if mode == "control":
        a, b = tf32(a), tf32(b)
    return torch.matmul(a, b)


def table_rows(rows: torch.Tensor, mode: str) -> torch.Tensor:
    """Rows read from the table the configuration states in float32; in
    ``control`` rounded to bf16."""
    return bf16(rows) if mode == "control" else rows


def no_tf32() -> None:
    """Keep float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


__all__ = ["MODES", "bf16", "dense_bf16", "fp8", "matmul_f32", "no_tf32", "table_rows", "tf32"]
