"""Host-side data preparation (counterpart of ``torecsys_tpu/data``)."""

from torecsys_tpu_torch.data.presort import (
    AUX_NAMES,
    AUX_PREFIX,
    Presorter,
    PresortSpec,
    build_presort_specs,
    spec_for_module,
)

__all__ = ["AUX_NAMES", "AUX_PREFIX", "PresortSpec", "Presorter",
           "build_presort_specs", "spec_for_module"]
