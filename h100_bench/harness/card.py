"""The card: its checks, its name and power limit, and the published peaks.

Peaks are those of one NVIDIA H100 SXM in NVIDIA's data sheet (dense rates,
no sparsity), at its full 700 W power limit: HBM3 at 3.35 TB/s, 989 TFLOP/s
in bf16 on the tensor cores, 67 TFLOP/s in float32 outside them (TF32 off),
495 TFLOP/s in TF32.  A roofline share is stated against them, with the
card's power limit printed beside it (:func:`card_line`).
"""

from __future__ import annotations

import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}


class NoCard(RuntimeError):
    """The run asked for more cards than the machine shows."""


def require_cards(n: int):
    """Fail where CUDA is unavailable or fewer than ``n`` cards show: the
    benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} card(s), the cell asks for {n}")


def card_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` reads them
    (``not read`` where it cannot run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({type(err).__name__})"
    return out.stdout.strip().splitlines()[0]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def bound_s(n_bytes: float, ops_by_dtype=None) -> float:
    """The least time the card could take: the larger of ``n_bytes`` over
    the HBM rate and the sum of each dtype's operations over its peak."""
    t_ops = sum(n / PEAK_OPS_PER_S[d] for d, n in (ops_by_dtype or {}).items())
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)


__all__ = ["HBM_BYTES_PER_S", "NoCard", "PEAK_OPS_PER_S", "bound_s", "card_line", "log",
           "require_cards"]
