"""CTR models (counterpart of ``torecsys_tpu/models/ctr``)."""

from torecsys_tpu_torch.models.ctr.fm_family import DeepFactorizationMachineModel, DeepFM

__all__ = ["DeepFM", "DeepFactorizationMachineModel"]
