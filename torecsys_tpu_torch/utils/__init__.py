"""Helpers shared across the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it resolves to ``cuda`` and raises when no CUDA
    device is present.  The CPU is used only when the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torecsys_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device: torch.device, seed: int = 0,
                      generator: Optional[torch.Generator] = None) -> torch.Generator:
    """``generator`` itself, or a fresh one on ``device`` seeded with ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


__all__ = ["DeviceLike", "default_generator", "resolve_device"]
