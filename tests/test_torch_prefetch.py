"""The port's prefetch (``data/prefetch.py``) on the JAX package's
``TestPrefetch`` cases, and the Trainer's prefetch workers: ``fit`` with
``prefetch=2`` gives the same bits as ``prefetch=0``."""

import numpy as np
import pytest
from test_torch_train import JaxRun, _batches, _port

from torecsys_tpu_torch.data.prefetch import Prefetcher, prefetch_map


def _bad(x):
    if x == 3:
        raise ValueError("boom")
    return x


def _order_preserved():
    assert list(prefetch_map(range(50), lambda x: x * 2, num_workers=4, depth=6)) == [
        x * 2 for x in range(50)]


def _zero_workers_inline():
    assert list(prefetch_map(range(5), None, num_workers=0)) == list(range(5))


def _exception_propagates():
    it = prefetch_map(range(10), _bad, num_workers=2, depth=3)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)


def _early_stop_shuts_down():
    it = prefetch_map(range(1000), lambda x: x, num_workers=2, depth=4)
    got = [next(it) for _ in range(3)]
    it.close()
    assert got == [0, 1, 2]


@pytest.mark.parametrize("case", [_order_preserved, _zero_workers_inline, _exception_propagates,
                                  _early_stop_shuts_down])
def test_prefetch_map(case):
    """tests/test_presort.py TestPrefetch: order kept, inline without
    workers, an exception raised at its own item's yield, an early close
    that does not wait for the pool."""
    case()


def test_prefetcher_iterates_afresh_each_epoch():
    pf = Prefetcher(lambda: iter(range(6)), lambda x: x + 1, num_workers=3, depth=2)
    assert list(pf) == list(pf) == list(range(1, 7))


@pytest.mark.parametrize("presort", [None, False])
def test_fit_with_prefetch_workers_gives_the_same_bits(presort):
    """Presort and packing in two worker threads, in order: the trained
    parameters equal those of the loop-thread path to the bit."""
    batches = _batches()
    params = JaxRun(batches[:1]).params()
    runs = []
    for prefetch in (0, 2):
        port = _port(params, presort=presort)
        port.prefetch = prefetch
        port.fit(lambda: iter(batches), max_epochs=2)
        assert int(port.state.step) == 2 * len(batches)
        runs.append({n: p.detach().clone()
                     for n, p in port.pipeline.sequential.named_parameters()})
        assert (port.host_ms["presort"] > 0) == (presort is None)
        assert port.host_ms["pack"] > 0
    for name in runs[0]:
        np.testing.assert_array_equal(runs[0][name].numpy(), runs[1][name].numpy(), err_msg=name)
