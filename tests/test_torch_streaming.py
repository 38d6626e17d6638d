"""The port's ``CriteoFileIterable`` (``torecsys_tpu_torch/data/streaming.py``)
against the JAX package's, bit for bit, on the bundled Criteo sample read in
place: shuffle off and on across two epochs, 2 shards, the remainder kept,
and ``shard_batch_counts`` with ``sync_batches`` on and off (mirrors
``tests/test_streaming.py``).  Then the models the stream feeds: ``LR`` and
``FM`` forward against the flax models from carried-over weights, and 5
steps of the port's Trainer against the JAX Trainer's, for ``FM`` and
``DeepFM`` on both embedding routes, from the same weights, on batches of
the stream."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu import inputs as jax_inputs
from torecsys_tpu.cli import _criteo_schema_inputs as jax_criteo_inputs
from torecsys_tpu.data.streaming import CriteoFileIterable as JaxStream
from torecsys_tpu.models import Sequential as JaxSequential
from torecsys_tpu.models import get_model as jax_get_model
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import Inputs, Pipeline, Sequential, Trainer, ValueInput, get_model
from torecsys_tpu_torch.cli import _criteo_schema_inputs
from torecsys_tpu_torch.convert import from_flax_params
from torecsys_tpu_torch.data import CriteoFileIterable, file_larger_than, open_criteo_stream
from torecsys_tpu_torch.data.native import NUM_CATS

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "torecsys_tpu", "data", "sample", "criteo_sample.tsv")
HASHES = (1000,) * NUM_CATS
SMALL_CHUNK = 1 << 14  # 16 KB: a few dozen rows a chunk, many carries


def _pair(chunk=SMALL_CHUNK, **kw):
    port = CriteoFileIterable(SAMPLE, HASHES, **kw)
    ref = JaxStream(SAMPLE, HASHES, **{"shard_index": 0, "num_shards": 1, **kw})
    port.chunk_bytes = ref.chunk_bytes = chunk  # under the 1 MB floor, as the JAX tests do
    return port, ref


def _assert_same_epoch(port_batches, ref_batches):
    assert len(port_batches) == len(ref_batches) > 0
    for got, want in zip(port_batches, ref_batches):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(np.ascontiguousarray(got[k]).view(np.uint8),
                                  np.ascontiguousarray(want[k]).view(np.uint8)), k


CONFIGS = {
    "in_order": dict(batch_size=100, shuffle=False),
    "shuffled": dict(batch_size=256, shuffle=True, seed=3),
    "shuffled_one_chunk": dict(batch_size=256, shuffle=True, seed=5, chunk=1 << 20),
    "remainder_kept": dict(batch_size=300, shuffle=False, drop_remainder=False),
    "shard_0_of_2": dict(batch_size=64, shuffle=True, seed=1, shard_index=0, num_shards=2),
    "shard_1_of_2": dict(batch_size=64, shuffle=True, seed=1, shard_index=1, num_shards=2),
    "shard_1_of_2_unsynced": dict(batch_size=64, shard_index=1, num_shards=2,
                                  sync_batches=False),
    "target_renamed": dict(batch_size=512, target_fields="click"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_matches_the_jax_stream_over_two_epochs(name):
    kw = dict(CONFIGS[name])
    port, ref = _pair(chunk=kw.pop("chunk", SMALL_CHUNK), **kw)
    for _ in range(2):  # epoch e shuffles with seed + e
        _assert_same_epoch(list(port), list(ref))


@pytest.mark.parametrize("sync", [True, False])
def test_shard_batch_counts_match_the_jax_stream_and_the_yields(sync):
    counts = []
    for s in (0, 1):
        port, ref = _pair(batch_size=64, shard_index=s, num_shards=2, sync_batches=sync)
        assert port.shard_batch_counts() == ref.shard_batch_counts()
        counts.append(port.shard_batch_counts())
        yielded = len(list(port))
        assert yielded == (min(counts[-1]) if sync else counts[-1][s])
    assert counts[0] == counts[1]


def test_default_shard_is_this_process_alone_and_helpers():
    it = CriteoFileIterable(SAMPLE, HASHES)
    assert (it.shard_index, it.num_shards) == (0, 1)
    with pytest.raises(ValueError, match="shard_index"):
        CriteoFileIterable(SAMPLE, HASHES, shard_index=2, num_shards=2)
    with pytest.raises(ValueError, match="26"):
        CriteoFileIterable(SAMPLE, (1000,) * 25)
    opened = open_criteo_stream(SAMPLE, HASHES, 512, shuffle=True, seed=4)
    assert (opened.batch_size, opened.shuffle, opened.seed) == (512, True, 4)
    assert file_larger_than(SAMPLE, 10) and not file_larger_than(SAMPLE, 1 << 40)
    assert not file_larger_than(SAMPLE + ".nope", 10)


# ---- the models the stream feeds ----------------------------------------------

def test_lr_and_fm_forward_match_the_flax_models():
    rng = np.random.default_rng(0)
    dense = tuple(f"d{j}" for j in range(5))
    cats = ("c0", "c1", "c2")
    batch = {**{d: rng.normal(size=32).astype(np.float32) for d in dense},
             **{c: rng.integers(0, 40, 32).astype(np.int32) for c in cats}}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    from torecsys_tpu_torch import MultiIndicesEmbedding

    for name in ("LR", "FM"):
        jax_schema = {"feat_inputs": jax_inputs.ValueInput(fields=dense)}
        schema = {"feat_inputs": ValueInput(dense)}
        if name == "FM":
            jax_schema["emb_inputs"] = jax_inputs.MultiIndicesEmbedding(
                embed_size=8, field_sizes=(40, 40, 40), fields=cats)
            schema["emb_inputs"] = MultiIndicesEmbedding(8, (40, 40, 40), cats, device="cpu")
        flax_seq = JaxSequential(inputs=jax_inputs.Inputs(schema=jax_schema),
                                 model=jax_get_model(name))
        variables = flax_seq.init(jax.random.PRNGKey(1), jb)
        inputs = Inputs(schema)
        port = Sequential(inputs, get_model(name, inputs=inputs, device="cpu"))
        from_flax_params(port, jax.tree_util.tree_map(np.asarray, variables["params"]))
        with torch.no_grad():
            got = port(tb)
        ref = flax_seq.apply(variables, jb)
        assert got.shape == ref.shape == (32, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6, err_msg=name)
    assert get_model("LR", inputs=Inputs({"feat_inputs": ValueInput(dense)}),
                     device="cpu").outputs_probability


HASH, E, B, STEPS, LR_ = 500, 8, 256, 5, 1e-3
MODELS = {"FM": {}, "DeepFM": {"deep_layer_sizes": (16, 8)}}


def _stream_batches(cls, **kw):
    it = cls(SAMPLE, (HASH,) * NUM_CATS, batch_size=B, shuffle=True, seed=0, **kw)
    it.chunk_bytes = 1 << 15
    out = []
    for b in it:
        out.append(b)
        if len(out) == STEPS:
            return out


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_five_stream_steps_track_the_jax_trainer(model, sparse):
    ref_batches = _stream_batches(JaxStream, shard_index=0, num_shards=1)
    batches = _stream_batches(CriteoFileIterable)
    _assert_same_epoch(batches, ref_batches)
    jpipe = (JaxPipeline().set_objective("ctr").set_inputs(jax_criteo_inputs(HASH, E))
             .set_model(model, **MODELS[model]).set_criterion("BCEWithLogitsLoss")
             .set_optimizer("Adam", lr=LR_).set_sparse_embeddings(sparse)
             .set_target_fields("label"))
    ref = JaxTrainer(jpipe, prefetch=0, seed=0)
    ref.init_state(ref_batches[0])
    params = jax.device_get(ref.state.params)
    ref._setup_presorter()
    assert (ref._presorter is not None) == sparse
    ref._build_steps()
    ref_losses = []
    for b in ref_batches:
        if ref._presorter is not None:
            b = ref._presorter(b)
        with ref._trace_contexts():
            ref.state, logs = ref._train_step_fn(ref.state, ref._place_batch(b))
        ref_losses.append(float(logs["loss"]))

    pipe = (Pipeline(device="cpu").set_objective("ctr")
            .set_inputs(_criteo_schema_inputs(HASH, E, "cpu"))
            .set_model(model, **MODELS[model]).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=LR_).set_sparse_embeddings(sparse)
            .set_target_fields("label"))
    port = Trainer(pipe)
    port.init_state()
    from_flax_params(pipe.sequential, params)
    assert port.sparse == sparse and (port._presorter is not None) == sparse
    losses = [float(x) for x in port.train_steps(batches)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(port.state.step) == STEPS
