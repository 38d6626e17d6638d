"""torecsys_tpu_torch: the PyTorch and CUDA port of ``torecsys_tpu``.

The package mirrors the JAX package's module layout, so each counterpart
sits at the same relative path.  It imports ``torch`` and numpy, never JAX
or anything of ``torecsys_tpu``.  Its entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; with no
device given and no CUDA present they raise.

Ported so far: the DeepFM CTR model trained on the sparse, host-presorted
embedding route or on the dense-table route, its evaluation (streaming AUC
and logloss) and prediction, with the kernels of those paths (row gather,
two segment-sums, row-wise update) hand-written in CUDA for Hopper
(``ops/kernels``, sources in ``csrc/``).
"""

from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding, ValueInput
from torecsys_tpu_torch.models import DeepFM, Sequential, get_model
from torecsys_tpu_torch.train import Pipeline, Trainer

__version__ = "0.1.0"

__all__ = ["DeepFM", "Inputs", "MultiIndicesEmbedding", "Pipeline", "Sequential",
           "Trainer", "ValueInput", "get_model"]
