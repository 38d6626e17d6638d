"""The slice end to end: the on-device sparse route (``Trainer(presort=False)``:
no host presort, the step sorts and dedups on the card) of the port against
the JAX package's ``Trainer(presort=False)``, from the same carried-over
initial weights, on ``make_synthetic_ctr`` batches, on both settings of
``TORECSYS_TPU_FUSED_DEDUP``; and the port's on-device and presorted routes
against each other from one state.

Tolerances: losses rtol 1e-5; parameters as ``_assert_params_close`` holds
them (atol 1e-6, 1e-3 of lr; see there)."""

import numpy as np
import pytest
import torch

from test_torch_train import STEPS, TABLE, JaxRun, _assert_params_close, _batches, _port
from torecsys_tpu_torch.convert import torch_name
from torecsys_tpu_torch.ops.kernels import sparse_update as K


def _count_calls(monkeypatch):
    """Wrap the row-update kernels' wrappers (module attributes) in call
    counters: on the CPU they take their plain versions and count no launch."""
    calls = {"fused_sorted_dedup_update": 0, "fused_rowwise_update": 0,
             "widen_segment_sum": 0}
    for name in calls:
        real = getattr(K, name)

        def wrapper(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(K, name, wrapper)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_five_ondevice_steps_track_the_jax_trainer(fused, monkeypatch):
    batches = _batches()
    ref = JaxRun(batches, presort=False)
    ref_losses = [ref.step(b) for b in batches]
    port = _port(JaxRun(batches[:1], presort=False).params(), presort=False)
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", "1" if fused else "0")
    calls = _count_calls(monkeypatch)
    losses = [float(x) for x in port.train_steps(batches)]
    assert calls == ({"fused_sorted_dedup_update": STEPS, "fused_rowwise_update": 0,
                      "widen_segment_sum": 0} if fused else
                     {"fused_sorted_dedup_update": 0, "fused_rowwise_update": STEPS,
                      "widen_segment_sum": STEPS})
    assert port.host_ms["presort"] == 0.0
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(port.state.step) == STEPS
    _assert_params_close(port, ref.params())


@pytest.mark.parametrize("fused", [False, True])
def test_ondevice_and_presorted_routes_agree(fused, monkeypatch):
    """Both routes sort stably, so they sum each stored row's grads in the
    same order and take the same steps, to the bit."""
    batches = _batches()
    init = JaxRun(batches[:1]).params()
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", "1" if fused else "0")
    runs = {}
    for presort in (None, False):
        port = _port(init, presort=presort)
        losses = torch.stack(port.train_steps(batches))
        runs[presort] = (losses, dict(port.pipeline.sequential.named_parameters()),
                         port.state.opt_state["sparse"][torch_name(TABLE)]["mv"])
    (l_pre, p_pre, mv_pre), (l_dev, p_dev, mv_dev) = runs[None], runs[False]
    torch.testing.assert_close(l_dev, l_pre, rtol=0, atol=0)
    for name in p_pre:
        torch.testing.assert_close(p_dev[name], p_pre[name], rtol=0, atol=0, msg=name)
    torch.testing.assert_close(mv_dev, mv_pre, rtol=0, atol=0)


def test_ondevice_route_updates_the_row_a_negative_id_reads():
    """A negative raw id of the first field reads row ``rows + id`` of the
    logical view (``jnp.take``'s rule; the forward matches the JAX step's),
    and the on-device route updates that row: the run equals one fed the
    wrapped id itself.  (The JAX package's XLA update reads such a row as
    zeros and writes it wrapped; ROADMAP section 3.)"""
    batches = _batches()[:2]
    ref = JaxRun(batches, presort=False)
    init = ref.params()
    rows = np.asarray(init["inputs"]["schema_emb_inputs"]["embedding"]).size // 16
    runs = []
    for raw in (-1, rows - 1):
        feed = [{**b, "cat_0": np.where(np.arange(len(b["cat_0"])) < 3, raw,
                                        b["cat_0"]).astype(b["cat_0"].dtype)} for b in batches]
        port = _port(init, presort=False)
        losses = torch.stack(port.train_steps(feed))
        if raw < 0:
            np.testing.assert_allclose(float(losses[0]), ref.step(feed[0]), rtol=1e-5)
        named = dict(port.pipeline.sequential.named_parameters())
        runs.append((losses, {k: v.detach() for k, v in named.items()},
                     port.state.opt_state["sparse"][torch_name(TABLE)]["mv"]))
    (l_neg, p_neg, mv_neg), (l_wrap, p_wrap, mv_wrap) = runs
    torch.testing.assert_close(l_neg, l_wrap, rtol=0, atol=0)
    for name in p_neg:
        torch.testing.assert_close(p_neg[name], p_wrap[name], rtol=0, atol=0, msg=name)
    torch.testing.assert_close(mv_neg, mv_wrap, rtol=0, atol=0)
    assert bool(mv_neg[-1, 0, -16:].ne(0).all())  # the last logical row was updated
