"""CTR models (counterpart of ``torecsys_tpu/models/ctr``)."""

from torecsys_tpu_torch.models.ctr.deep import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.deep import __all__ as _deep_all
from torecsys_tpu_torch.models.ctr.fm_family import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.fm_family import __all__ as _fm_all

__all__ = [*_fm_all, *_deep_all]
