"""Streaming metrics with device-tensor states (counterpart of
``torecsys_tpu/metrics/streaming.py``).

A metric is an ``init`` / ``update`` / ``compute`` triple over a small state
of device tensors.  ``update`` enqueues its work on the states' device and
never waits on it; ``merge`` of two states (two evaluation shards, two
hosts) is a tensor add; ``compute`` gives a 0-d tensor, read on the host
once at the end.

AUC is the fixed-bin score-histogram formulation of the JAX package: 8192
bins, one ``index_add_`` per batch, trapezoidal area at the end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from torecsys_tpu_torch.utils import DeviceLike, resolve_device


def _weights(values: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return torch.ones_like(values)
    return weights.reshape(-1).to(torch.float32)


class AUCState(NamedTuple):
    pos_hist: torch.Tensor  # (num_bins,) positive-score histogram
    neg_hist: torch.Tensor  # (num_bins,) negative-score histogram


@dataclasses.dataclass(frozen=True)
class StreamingAUC:
    """Histogram-binned streaming ROC-AUC over sigmoid scores in [0, 1]."""

    num_bins: int = 8192

    def init(self, device: DeviceLike = None) -> AUCState:
        z = torch.zeros(self.num_bins, dtype=torch.float32, device=resolve_device(device))
        return AUCState(pos_hist=z, neg_hist=z.clone())

    def update(self, state: AUCState, scores: torch.Tensor, labels: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> AUCState:
        scores = torch.clamp(scores.reshape(-1).to(torch.float32), 0.0, 1.0)
        labels = labels.reshape(-1).to(torch.float32)
        w = _weights(labels, weights)
        # float32 product truncated toward zero, as the JAX package's astype
        bins = torch.clamp_max((scores * self.num_bins).to(torch.int64), self.num_bins - 1)
        return AUCState(pos_hist=state.pos_hist.index_add(0, bins, labels * w),
                        neg_hist=state.neg_hist.index_add(0, bins, (1.0 - labels) * w))

    def compute(self, state: AUCState) -> torch.Tensor:
        """Trapezoidal AUC from the two histograms."""
        pos, neg = state.pos_hist, state.neg_hist
        total_pos = torch.clamp_min(torch.sum(pos), 1e-12)
        total_neg = torch.clamp_min(torch.sum(neg), 1e-12)
        # For each bin b (ascending score): pairs won = pos[b] * (neg below b)
        # plus half-credit for ties within the bin.
        neg_below = torch.cumsum(neg, dim=0) - neg
        won = torch.sum(pos * neg_below) + 0.5 * torch.sum(pos * neg)
        return won / (total_pos * total_neg)

    @staticmethod
    def merge(a: AUCState, b: AUCState) -> AUCState:
        return AUCState(*(x + y for x, y in zip(a, b)))


class MeanState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StreamingMean:
    """Weighted streaming mean: the accumulator behind logloss."""

    def init(self, device: DeviceLike = None) -> MeanState:
        dev = resolve_device(device)
        return MeanState(total=torch.zeros((), dtype=torch.float32, device=dev),
                         count=torch.zeros((), dtype=torch.float32, device=dev))

    def update(self, state: MeanState, values: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> MeanState:
        values = values.reshape(-1).to(torch.float32)
        w = _weights(values, weights)
        return MeanState(total=state.total + torch.sum(values * w),
                         count=state.count + torch.sum(w))

    def compute(self, state: MeanState) -> torch.Tensor:
        return state.total / torch.clamp_min(state.count, 1e-12)

    @staticmethod
    def merge(a: MeanState, b: MeanState) -> MeanState:
        return MeanState(*(x + y for x, y in zip(a, b)))


@dataclasses.dataclass(frozen=True)
class StreamingLogLoss:
    """Streaming binary cross-entropy on probability scores."""

    eps: float = 1e-7
    _mean: StreamingMean = StreamingMean()

    def init(self, device: DeviceLike = None) -> MeanState:
        return self._mean.init(device)

    def update(self, state: MeanState, scores: torch.Tensor,
               labels: torch.Tensor) -> MeanState:
        p = torch.clamp(scores.reshape(-1).to(torch.float32), self.eps, 1.0 - self.eps)
        y = labels.reshape(-1).to(torch.float32)
        ll = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        return self._mean.update(state, ll)

    def compute(self, state: MeanState) -> torch.Tensor:
        return self._mean.compute(state)

    merge = staticmethod(StreamingMean.merge)


__all__ = ["AUCState", "MeanState", "StreamingAUC", "StreamingLogLoss", "StreamingMean"]
