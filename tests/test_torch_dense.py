"""The dense-table route and the ``pack == 1`` sparse route of the port's
Trainer against the JAX package's Trainer, from the same carried-over
weights (and optimizer state), on ``make_synthetic_ctr`` batches.

Tolerances are those of the sparse slice (``test_torch_train``): per-step
losses rtol 1e-5; parameters atol 1e-6, which is 1e-3 of the learning rate
(the dense Adam's bias correction rounds in float32 in optax and in float64
in torch), except the table elements whose gradients are within a few eps
of zero on the ``pack == 1`` route (see that test).
"""

import numpy as np
import torch
from test_torch_train import STEPS, TABLE, JaxRun, _assert_params_close, _batches, _port

from torecsys_tpu_torch.convert import flatten, torch_name


def test_five_dense_steps_track_the_jax_trainer():
    batches = _batches()
    ref = JaxRun(batches, sparse=False)
    port = _port(ref.params(), sparse=False)
    assert port._presorter is None
    assert isinstance(port.state.opt_state, torch.optim.Adam)
    table = dict(port.pipeline.sequential.named_parameters())[torch_name(TABLE)]
    assert any(p is table for p in port.state.opt_state.param_groups[0]["params"])
    ref_losses = [ref.step(b) for b in batches]
    losses = [float(x) for x in port.train_steps(batches)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(port.state.step) == STEPS
    _assert_params_close(port, ref.params())


def test_dense_optimizer_state_carry_over_continues_the_jax_run():
    """convert carries the dense route's plain optax Adam state (count, mu and
    nu of every parameter, the table included); both sides then take the
    same next step."""
    batches = _batches()
    ref = JaxRun(batches, sparse=False)
    for b in batches[:2]:
        ref.step(b)
    port = _port(ref.params(), ref.opt_state(), sparse=False)
    assert int(port.state.step) == 2
    table = dict(port.pipeline.sequential.named_parameters())[torch_name(TABLE)]
    mu = np.asarray(ref.opt_state()[0].mu["inputs"]["schema_emb_inputs"]["embedding"])
    np.testing.assert_array_equal(port.state.opt_state.state[table]["exp_avg"].numpy(), mu)
    loss = float(port.train_steps([batches[2]])[0])
    np.testing.assert_allclose(loss, ref.step(batches[2]), rtol=1e-5)
    _assert_params_close(port, ref.params())


def test_pack_one_sparse_steps_track_the_jax_trainer():
    """E = 128 packs one logical row per stored row: the sparse update's
    segment-sum takes ``segment_sum_wide``."""
    batches = _batches()[:3]
    ref = JaxRun(batches, embed=128)
    port = _port(ref.params(), embed=128)
    assert port.pipeline.inputs.schema["emb_inputs"].pack == 1
    ref_losses = [ref.step(b) for b in batches]
    losses = [float(x) for x in port.train_steps(batches)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_params_close(port, ref.params(), embed=128, skip=(TABLE,))
    # Adam steps an element by lr * m_hat / (sqrt(v_hat) + eps).  Where the
    # element's gradients are within a few eps of zero (sums that nearly
    # cancel), a float32 rounding difference in them is a large relative
    # one, and the step moves by a visible part of lr; there (a few elements
    # in 10^4 here) the bound is 1e-2 of lr, elsewhere 1e-3 of lr.
    table = dict(port.pipeline.sequential.named_parameters())[torch_name(TABLE)]
    mv = np.asarray(ref.opt_state()["sparse"][TABLE]["mv"])
    v_hat = mv[:, 1] / (1 - 0.999 ** len(batches))
    near_eps = np.sqrt(v_hat) < 10 * 1e-8
    got = table.detach().numpy()
    want = np.asarray(flatten(ref.params())[TABLE])
    np.testing.assert_allclose(got[~near_eps], want[~near_eps], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[near_eps], want[near_eps], rtol=0, atol=1e-5)
