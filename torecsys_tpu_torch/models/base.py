"""Model base classes and name registry (counterpart of
``torecsys_tpu/models/base.py``).

Models return raw scores of shape ``(B, 1)``; criteria decide whether they
expect logits or probabilities.  A torch module needs its input widths when
it is built, so a registered model also has :meth:`BaseModel.from_inputs`,
which reads them off the ``Inputs`` it will be applied to.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from torch import nn

MODELS: Dict[str, Type[nn.Module]] = {}


def register_model(*names: str) -> Callable[[Type[nn.Module]], Type[nn.Module]]:
    """Class decorator adding a model (and its aliases) to the registry."""

    def wrap(cls: Type[nn.Module]) -> Type[nn.Module]:
        for name in (cls.__name__, *names):
            MODELS[name] = cls
        return cls

    return wrap


def get_model(name_or_model, inputs=None, **kwargs):
    """Resolve a model by registry name or pass an instance through.

    With ``inputs`` given, the model's input widths are taken from them
    (:meth:`BaseModel.from_inputs`).  The model is built on ``device``
    (default: the card).
    """
    if isinstance(name_or_model, nn.Module):
        return name_or_model
    if name_or_model not in MODELS:
        raise KeyError(f"unknown model {name_or_model!r}; available: {sorted(MODELS)}")
    cls = MODELS[name_or_model]
    if inputs is not None:
        return cls.from_inputs(inputs, **kwargs)
    return cls(**kwargs)


def input_shape(inputs, name: str) -> Tuple[int, int]:
    """The ``(N, E)`` of the ``(B, N, E)`` tensor that ``inputs.schema[name]``
    emits (its ``output_shape()``)."""
    if name not in inputs.schema:
        raise KeyError(f"the model reads {name!r}, which the inputs do not give "
                       f"(they give {sorted(inputs.schema)})")
    return inputs.schema[name].output_shape()


class BaseModel(nn.Module):
    """Base class for all models."""

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        for child in self.children():
            if hasattr(child, "reset_parameters"):
                child.reset_parameters(generator)


class CtrBaseModel(BaseModel):
    """Base class for CTR models — ``forward(**inputs) → (B, 1)`` raw scores."""

    outputs_probability = False


class EmbBaseModel(BaseModel):
    """Base class for embedding models."""


class LtrBaseModel(BaseModel):
    """Base class for learning-to-rank models."""
