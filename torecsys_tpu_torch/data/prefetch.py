"""Host pipeline prefetch: overlap batch preparation with device steps
(counterpart of ``torecsys_tpu/data/prefetch.py``).

:func:`prefetch_map` maps a transform over a batch iterator with a small
thread pool, a bounded look-ahead and strictly in-order yields, so the host
work for batch ``i + k`` (the presort, pinning) runs while the card executes
batch ``i``, and the batch order is kept.  Threads, not processes: the hot
transforms release the interpreter lock (the C++ presort through ctypes,
numpy copies), and a multi-MB batch is not pickled through a pipe.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional


def prefetch_map(src: Iterable, transform: Optional[Callable] = None, num_workers: int = 2,
                 depth: int = 4) -> Iterator:
    """Yield ``transform(item)`` for each item of ``src``, in order, with up
    to ``depth`` items in flight across ``num_workers`` threads.

    ``num_workers <= 0`` or ``depth <= 0`` maps inline.  An exception from
    ``src`` or ``transform`` propagates at its item's yield.  A consumer that
    stops early (closing the generator) shuts the pool down without waiting
    for the items in flight; their futures are cancelled.
    """
    if num_workers <= 0 or depth <= 0:
        for item in src:
            yield item if transform is None else transform(item)
        return
    fn = transform if transform is not None else (lambda x: x)
    pending = collections.deque()
    # No `with` block: its exit joins the workers, which blocks a consumer
    # that stops early until the items in flight finish.
    pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        for item in src:
            pending.append(pool.submit(fn, item))
            if len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


class Prefetcher:
    """Re-iterable wrapper: a fresh :func:`prefetch_map` run per epoch.

    ``loader`` is a re-iterable container or a zero-argument callable
    returning an iterator, as :meth:`Trainer.fit` takes.
    """

    def __init__(self, loader, transform=None, num_workers: int = 2, depth: int = 4):
        self.loader = loader
        self.transform = transform
        self.num_workers = num_workers
        self.depth = depth

    def __iter__(self):
        src = self.loader() if callable(self.loader) else self.loader
        return prefetch_map(src, self.transform, self.num_workers, self.depth)


__all__ = ["Prefetcher", "prefetch_map"]
