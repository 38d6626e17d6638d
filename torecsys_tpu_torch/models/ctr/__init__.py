"""CTR models (counterpart of ``torecsys_tpu/models/ctr``)."""

from torecsys_tpu_torch.models.ctr.deep import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.deep import __all__ as _deep_all
from torecsys_tpu_torch.models.ctr.dlrm import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.dlrm import __all__ as _dlrm_all
from torecsys_tpu_torch.models.ctr.ffm_deep import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.ffm_deep import __all__ as _ffm_deep_all
from torecsys_tpu_torch.models.ctr.fibinet import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.fibinet import __all__ as _fibinet_all
from torecsys_tpu_torch.models.ctr.fm_family import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.fm_family import __all__ as _fm_all
from torecsys_tpu_torch.models.ctr.multitask import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.multitask import __all__ as _multitask_all
from torecsys_tpu_torch.models.ctr.session import *  # noqa: F401,F403
from torecsys_tpu_torch.models.ctr.session import __all__ as _session_all

__all__ = [*_fm_all, *_deep_all, *_dlrm_all, *_ffm_deep_all, *_fibinet_all, *_multitask_all,
           *_session_all]
