"""Host-side data pipeline (counterpart of ``torecsys_tpu/data``): datasets,
vocabulary fields, schema-driven collation to fixed-shape numpy batches,
sample-data loaders, sub-sampling, the Criteo file stream and the presort.
Everything here runs on the host; the card only sees fixed-shape arrays."""

from torecsys_tpu_torch.data.collate import CollateFunction, DataLoader, FieldSpec
from torecsys_tpu_torch.data.dataset import DataFrameToDataset, NdarrayToDataset
from torecsys_tpu_torch.data.fields import IndexField, SentenceField
from torecsys_tpu_torch.data.presort import (
    AUX_NAMES,
    AUX_PREFIX,
    Presorter,
    PresortSpec,
    build_presort_specs,
    spec_for_module,
)
from torecsys_tpu_torch.data.sample_data import (
    download_bx_data,
    download_criteo_data,
    download_jester_data,
    download_ml_data,
    load_bx_data,
    load_criteo_batches,
    load_criteo_data,
    load_ml_data,
    make_synthetic_ctr,
    request_download,
)
from torecsys_tpu_torch.data.streaming import (
    CriteoFileIterable,
    file_larger_than,
    open_criteo_stream,
)
from torecsys_tpu_torch.data.sub_sampling import sub_sampling

__all__ = [
    "AUX_NAMES",
    "AUX_PREFIX",
    "CollateFunction",
    "CriteoFileIterable",
    "DataFrameToDataset",
    "DataLoader",
    "FieldSpec",
    "IndexField",
    "NdarrayToDataset",
    "PresortSpec",
    "Presorter",
    "SentenceField",
    "build_presort_specs",
    "download_bx_data",
    "download_criteo_data",
    "download_jester_data",
    "download_ml_data",
    "file_larger_than",
    "load_bx_data",
    "load_criteo_batches",
    "load_criteo_data",
    "load_ml_data",
    "make_synthetic_ctr",
    "open_criteo_stream",
    "request_download",
    "spec_for_module",
    "sub_sampling",
]
