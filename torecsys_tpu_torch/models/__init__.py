"""Models of the port (counterpart of ``torecsys_tpu/models``)."""

from torecsys_tpu_torch.models.base import (
    MODELS,
    BaseModel,
    CtrBaseModel,
    get_model,
    register_model,
)
from torecsys_tpu_torch.models.ctr import (
    FM,
    LR,
    DeepFactorizationMachineModel,
    DeepFM,
    FactorizationMachineModel,
    LogisticRegressionModel,
)
from torecsys_tpu_torch.models.sequential import Sequential

__all__ = ["FM", "LR", "MODELS", "BaseModel", "CtrBaseModel", "DeepFM",
           "DeepFactorizationMachineModel", "FactorizationMachineModel",
           "LogisticRegressionModel", "Sequential", "get_model", "register_model"]
