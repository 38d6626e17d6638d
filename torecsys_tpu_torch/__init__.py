"""torecsys_tpu_torch: the PyTorch and CUDA port of ``torecsys_tpu``.

The package mirrors the JAX package's module layout, so each counterpart
sits at the same relative path.  It imports ``torch`` and numpy, never JAX
or anything of ``torecsys_tpu``.  Its entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; with no
device given and no CUDA present they raise.

Ported so far: the CTR models LR, FM, FMNN, FFM, AFM, NFM, DeepFM, PNN,
DCN, xDeepFM, NCF, Wide&Deep, FiBiNET, DeepFFM, FAT-DeepFFM, the
multi-task models DeepMoE, MMoE, ESMM, ESM² and DeepMCP, PAL, and DSIN
over flax's recurrent cells (``layers.rnn``), over the single-index, fused
and field-aware embedding inputs and the list and sequence inputs
(``inputs.sequence``) (xDeepFM's and PRM's BatchNorm statistics as module
buffers; a model with several outputs trains under a callable criterion),
PRM re-ranking with its multi-head attention, and MIND's dynamic-routing
layer, trained on the sparse embedding route (host-presorted, or sorted
and deduped on the card with ``Trainer(presort=False)``) or on the
dense-table route, their evaluation
(streaming AUC and logloss) and prediction; the ``ltr`` and ``emb``
objectives (the ranking and embedding losses, the in-batch miner, MF,
StarSpace and the LTR wrapper, NDCG evaluation) on the dense route and the
regularizer on every route; checkpoints with resume
(``train.checkpoint``), the data utilities with the C++ Criteo parser and
chunked file streaming (``data``), and the command line (``cli``:
``python -m torecsys_tpu_torch.cli``), with every kernel the JAX package
wrote for the TPU (row gather, unique stored-row gather, two segment-sums,
row-wise update, fused dedup and update) hand-written in CUDA for Hopper
(``ops/kernels``, sources in ``csrc/``).
"""

from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding, ValueInput
from torecsys_tpu_torch.models import DeepFM, Sequential, get_model
from torecsys_tpu_torch.train import Pipeline, Trainer

__version__ = "0.1.0"

__all__ = ["DeepFM", "Inputs", "MultiIndicesEmbedding", "Pipeline", "Sequential",
           "Trainer", "ValueInput", "get_model"]
