"""CTR models (counterpart of ``torecsys_tpu/models/ctr``)."""

from torecsys_tpu_torch.models.ctr.fm_family import (
    FM,
    LR,
    DeepFactorizationMachineModel,
    DeepFM,
    FactorizationMachineModel,
    LogisticRegressionModel,
)

__all__ = ["FM", "LR", "DeepFM", "DeepFactorizationMachineModel", "FactorizationMachineModel",
           "LogisticRegressionModel"]
