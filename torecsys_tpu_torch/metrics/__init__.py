"""Metrics (counterpart of ``torecsys_tpu/metrics``): the streaming CTR
metrics so far."""

from torecsys_tpu_torch.metrics.streaming import (
    AUCState,
    MeanState,
    StreamingAUC,
    StreamingLogLoss,
    StreamingMean,
)

__all__ = ["AUCState", "MeanState", "StreamingAUC", "StreamingLogLoss", "StreamingMean"]
