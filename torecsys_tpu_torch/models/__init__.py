"""Models of the port (counterpart of ``torecsys_tpu/models``)."""

from torecsys_tpu_torch.models.base import (
    MODELS,
    BaseModel,
    CtrBaseModel,
    EmbBaseModel,
    LtrBaseModel,
    get_model,
    register_model,
)
from torecsys_tpu_torch.models.ctr import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr import __all__ as _ctr_all
from torecsys_tpu_torch.models.emb import MatrixFactorizationModel, StarSpaceModel
from torecsys_tpu_torch.models.ltr import LearningToRankWrapper, PersonalizedReRankingModel
from torecsys_tpu_torch.models.sequential import Sequential

# the JAX package's short names
MF = MatrixFactorizationModel
LTRWrapper = LearningToRankWrapper
PRM = PersonalizedReRankingModel

__all__ = ["MODELS", "BaseModel", "CtrBaseModel", "EmbBaseModel", "LTRWrapper",
           "LearningToRankWrapper", "LtrBaseModel", "MF", "MatrixFactorizationModel", "PRM",
           "PersonalizedReRankingModel", "Sequential", "StarSpaceModel", "get_model",
           "register_model", *_ctr_all]
