"""Metrics (counterpart of ``torecsys_tpu/metrics``): the streaming metrics
and the functional ranking metrics."""

from torecsys_tpu_torch.metrics import functional
from torecsys_tpu_torch.metrics.functional import (
    discounted_cumulative_gain,
    ideal_discounted_cumulative_gain,
    mean_average_precision_at_k,
    mean_average_recall_at_k,
    mse,
    normalized_discounted_cumulative_gain,
    novelty_score,
)
from torecsys_tpu_torch.metrics.streaming import (
    AUCState,
    MeanState,
    Novelty,
    NoveltyState,
    StreamingAUC,
    StreamingLogLoss,
    StreamingMean,
    StreamingNDCG,
)

__all__ = [
    "AUCState", "MeanState", "Novelty", "NoveltyState", "StreamingAUC", "StreamingLogLoss",
    "StreamingMean", "StreamingNDCG", "discounted_cumulative_gain", "functional",
    "ideal_discounted_cumulative_gain", "mean_average_precision_at_k",
    "mean_average_recall_at_k", "mse", "normalized_discounted_cumulative_gain", "novelty_score",
]
