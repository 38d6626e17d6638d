"""Models of the port (counterpart of ``torecsys_tpu/models``)."""

from torecsys_tpu_torch.models.base import (
    MODELS,
    BaseModel,
    CtrBaseModel,
    get_model,
    register_model,
)
from torecsys_tpu_torch.models.ctr import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr import __all__ as _ctr_all
from torecsys_tpu_torch.models.sequential import Sequential

__all__ = ["MODELS", "BaseModel", "CtrBaseModel", "Sequential", "get_model", "register_model",
           *_ctr_all]
