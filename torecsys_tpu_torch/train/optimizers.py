"""Dense optimizer registry (counterpart of ``torecsys_tpu/train/optimizers.py``).

``get_optimizer`` returns a factory ``params -> torch.optim.Optimizer``:
torch optimizers are built over their parameters, which the trainer knows
only once it has split the dense parameters from the embedding tables.

Adam is ``torch.optim.Adam`` with ``foreach=False``: its update
``lr * (m / (1 - b1^t)) / (sqrt(v) / sqrt(1 - b2^t) + eps)`` is optax's
``lr * m_hat / (sqrt(v_hat) + eps)`` with eps after the bias-corrected
square root, so the two agree step for step up to float32 rounding.

On the card Adam is built with ``capturable=True``, for the eager steps as
for the steps captured in a CUDA graph (``train.steps.make_train_scan``),
so both give the same bits: its step count is then a float32 tensor on the
card and its bias correction ``1 - b**t`` is taken in float32, as optax
takes it.  On the CPU it is ``capturable=False`` (torch takes no CPU
parameters there), and the bias correction is taken in float64.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable

import torch


def get_optimizer(name: str = "Adam", lr: float = 1e-3, **kwargs: Any
                  ) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]:
    """Build a dense optimizer factory from a (torch-style or optax) name.

    Only Adam is ported.  ``lr`` may also be passed as ``learning_rate``;
    optax's ``b1``/``b2``/``eps`` names are accepted.
    """
    lr = kwargs.pop("learning_rate", lr)
    if name.lower() != "adam":
        raise KeyError(f"optimizer {name!r} is not ported; available: ['Adam']")
    b1 = kwargs.pop("b1", 0.9)
    b2 = kwargs.pop("b2", 0.999)
    eps = kwargs.pop("eps", 1e-8)
    if kwargs:
        raise TypeError(f"unsupported Adam arguments: {sorted(kwargs)}")
    return functools.partial(_adam, lr=lr, betas=(b1, b2), eps=eps)


def _adam(params: Iterable[torch.nn.Parameter], **kwargs: Any) -> torch.optim.Adam:
    params = list(params)
    on_card = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, foreach=False, capturable=on_card, **kwargs)


__all__ = ["get_optimizer"]
