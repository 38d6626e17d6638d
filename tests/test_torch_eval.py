"""Evaluation and prediction: the port's streaming metrics against the JAX
package's on the same scores, and ``Trainer.evaluate`` / ``predict``
against the JAX Trainer's from the same weights after a sparse-route fit.

Tolerances: streaming AUC atol 1e-6 and logloss rtol 1e-6 on the same
scores (the histograms are equal; the sums differ in order only).  Through
the model, the two sides' scores differ by float32 rounding, and a score
that lands on a bin edge may fall in the neighbouring bin: ``val_auc``
atol 1e-4; ``val_logloss`` and the scores rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import FIELDS, NUM_DENSE, JaxRun, _batches, _port

from torecsys_tpu.data.sample_data import make_synthetic_ctr
from torecsys_tpu.metrics import StreamingAUC as JaxAUC
from torecsys_tpu.metrics import StreamingLogLoss as JaxLogLoss
from torecsys_tpu_torch.metrics import StreamingAUC, StreamingLogLoss, StreamingMean


def _scores(rng, n=6000):
    scores = rng.uniform(size=n).astype(np.float32)
    # ties at bin edges: k / 8192 lands exactly on bin k's lower edge
    scores[:1500] = rng.integers(0, 8193, 1500) / np.float32(8192)
    labels = (rng.uniform(size=n) < scores).astype(np.float32)
    return scores, labels


@pytest.mark.parametrize("weighted", [False, True])
def test_streaming_auc_and_logloss_match_jax(weighted):
    rng = np.random.default_rng(0)
    auc, ll, jauc, jll = StreamingAUC(), StreamingLogLoss(), JaxAUC(), JaxLogLoss()
    a_state, l_state = auc.init("cpu"), ll.init("cpu")
    ja_state, jl_state = jauc.init(), jll.init()
    for _ in range(3):
        s, y = _scores(rng)
        w = rng.uniform(0.5, 2.0, s.shape).astype(np.float32) if weighted else None
        a_state = auc.update(a_state, torch.from_numpy(s), torch.from_numpy(y),
                             None if w is None else torch.from_numpy(w))
        ja_state = jauc.update(ja_state, jnp.asarray(s), jnp.asarray(y),
                               None if w is None else jnp.asarray(w))
        l_state = ll.update(l_state, torch.from_numpy(s), torch.from_numpy(y))
        jl_state = jll.update(jl_state, jnp.asarray(s), jnp.asarray(y))
    np.testing.assert_allclose(a_state.pos_hist.numpy(), np.asarray(ja_state.pos_hist),
                               rtol=1e-6)
    np.testing.assert_allclose(float(auc.compute(a_state)), float(jauc.compute(ja_state)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ll.compute(l_state)), float(jll.compute(jl_state)),
                               rtol=1e-6)


def test_streaming_states_merge_by_addition():
    rng = np.random.default_rng(1)
    s, y = (torch.from_numpy(a) for a in _scores(rng))
    auc, mean = StreamingAUC(), StreamingMean()
    whole = auc.update(auc.init("cpu"), s, y)
    parts = StreamingAUC.merge(auc.update(auc.init("cpu"), s[:2500], y[:2500]),
                               auc.update(auc.init("cpu"), s[2500:], y[2500:]))
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    m = StreamingMean.merge(mean.update(mean.init("cpu"), s[:10]),
                            mean.update(mean.init("cpu"), s[10:]))
    torch.testing.assert_close(mean.compute(m), s.mean(), rtol=1e-6, atol=0)


def _val_batches(n=3, b=512):
    data = make_synthetic_ctr(num_rows=n * b, field_sizes=FIELDS, num_dense=NUM_DENSE, seed=7)
    return [{k: v[i * b:(i + 1) * b] for k, v in data.items()} for i in range(n)]


def test_evaluate_and_predict_match_the_jax_trainer():
    batches, val = _batches(), _val_batches()
    ref = JaxRun(batches)
    port = _port(ref.params())
    metrics = port.fit(batches, val_loader=val)
    assert {"val_auc", "val_logloss"} <= set(metrics)
    assert np.isfinite(metrics["val_auc"]) and np.isfinite(metrics["val_logloss"])
    assert port.evaluate(val) == {k: metrics[k] for k in ("val_auc", "val_logloss")}

    for b in batches:
        ref.step(b)
    port = _port(ref.params())  # the JAX fit's weights
    want = ref.t.evaluate(val)
    got = port.evaluate(val)
    np.testing.assert_allclose(got["val_auc"], want["val_auc"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["val_logloss"], want["val_logloss"], rtol=1e-5)
    scores = port.predict(val[0])
    assert scores.shape == (512, 1) and ((scores > 0) & (scores < 1)).all()
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref.t.predict(val[0])), rtol=1e-5)

    unlabeled = {k: v for k, v in val[0].items() if k != "label"}
    with pytest.raises(ValueError, match="target field"):
        port.evaluate([unlabeled])
    assert port.predict(unlabeled).shape == (512, 1)
