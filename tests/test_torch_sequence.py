"""The port's recurrent cells, the list and sequence inputs, the masked
attention, dynamic routing and the operations remainder, against the JAX
package (and flax) from the same parameters (``convert.from_flax_params``).

Tolerances, float32 throughout: rtol 1e-5 with an atol of 1e-6 of the
largest reference value (``_close``), for outputs and for gradients; the
operations that involve no rounding are held to the bit.  Inputs and
parameters are drawn with numpy from fixed seeds; the tables are drawn at a
scale (0.5) at which the cells' gates leave their linear range.

* Each cell alone (flax's ``OptimizedLSTMCell``, ``GRUCell``,
  ``SimpleCell``), one step from a random carry.
* ``RNN`` without lengths and with them (a row of full length, short rows
  and a row of length 0), forward and ``reverse``, with and without
  ``keep_order``; ``flip_sequences``; ``Bidirectional`` with lengths.
* ``ListIndicesEmbedding`` and ``SequenceIndicesEmbedding`` under every
  ``output_method``, on ids with padding, with and without a
  ``lengths_field``, one row padding throughout; the list with attention
  (2 heads, the ``(B, 1, L, L)`` key mask), the sequence with each cell,
  2 layers, bidirectional with ``bidir_proj``; the table's gradient.
* ``MultiHeadDotProductAttention`` with a mask (a query with every key
  masked takes flax's uniform softmax), and without one bit for bit
  unchanged by a mask of all True.
* ``DynamicRoutingLayer``: the output and the gradients of both
  parameters, the routing logits carried through the iterations.
* The operations remainder, ``BaseLayer`` and the status decorators.
"""

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torecsys_tpu.utils.operations as JO
from torecsys_tpu.inputs import sequence as JS
from torecsys_tpu.layers.ctr.routing import DynamicRoutingLayer as JaxRouting
from torecsys_tpu.utils import decorator as JD
from torecsys_tpu_torch.convert import flatten, from_flax_params, torch_name
from torecsys_tpu_torch.inputs import sequence as TS
from torecsys_tpu_torch.layers import (
    RNN,
    BaseLayer,
    Bidirectional,
    DynamicRoutingLayer,
    GRUCell,
    MultiHeadDotProductAttention,
    OptimizedLSTMCell,
    SimpleCell,
    flip_sequences,
    resolve_num_capsules,
)
from torecsys_tpu_torch.utils import decorator as TD
from torecsys_tpu_torch.utils import operations as TO

B, L, E, H, V = 5, 6, 4, 3, 30
# lengths: full, short, one, zero (a row of padding throughout), two
LENGTHS = np.array([L, 3, 1, 0, 2], np.int32)
CELLS = {"lstm": (fnn.OptimizedLSTMCell, OptimizedLSTMCell),
         "gru": (fnn.GRUCell, GRUCell), "rnn": (fnn.SimpleCell, SimpleCell)}


def _draw(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _randomize(tree, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(size=np.shape(a)) * scale).astype(
            np.float32), tree)


def _close(got, want, rtol=1e-5):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * max(np.abs(want).max(), 1e-30))


def _ids(seed=0, padding=0):
    """``(B, L)`` ids in [1, V) with the positions past ``LENGTHS`` padding."""
    ids = np.random.default_rng(seed).integers(1, V, size=(B, L)).astype(np.int32)
    ids[np.arange(L)[None, :] >= LENGTHS[:, None]] = padding
    return ids


# ---- the cells ----------------------------------------------------------------------

def _cell_pair(kind, in_features, seed=0):
    jcell = CELLS[kind][0](features=H)
    x = _draw(B, in_features, seed=seed)
    carry = jcell.initialize_carry(jax.random.key(0), x.shape)
    params = _randomize(jcell.init(jax.random.key(seed), carry, x)["params"], seed + 1)
    port = from_flax_params(CELLS[kind][1](in_features, H, device="cpu"), params)
    assert set(dict(port.named_parameters())) == {torch_name(p) for p in flatten(params)}
    return jcell, port, params


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_each_cell_matches_flax_one_step(kind):
    jcell, port, params = _cell_pair(kind, E)
    x = _draw(B, E, seed=5)
    if kind == "lstm":
        carry = (_draw(B, H, seed=6), _draw(B, H, seed=7))
        tcarry = tuple(torch.from_numpy(c) for c in carry)
    else:
        carry = _draw(B, H, seed=6)
        tcarry = torch.from_numpy(carry)
    (want_carry, want_y) = jcell.apply({"params": params}, carry, x)
    got_carry, got_y = port(tcarry, torch.from_numpy(x))
    _close(got_y, want_y)
    for g, w in zip(jax.tree.leaves(got_carry), jax.tree.leaves(want_carry)):
        _close(g, w)


def test_cells_compute_a_bf16_input_in_float32():
    """flax promotes a bf16 input to the float32 kernels: so does the port,
    and its output and carry are float32."""
    jcell, port, params = _cell_pair("lstm", E)
    x = _draw(B, E, seed=5)
    carry = jcell.initialize_carry(jax.random.key(0), x.shape)
    want_carry, want_y = jcell.apply({"params": params}, carry,
                                     jnp.asarray(x).astype(jnp.bfloat16))
    assert want_y.dtype == jnp.float32
    zeros = torch.zeros(B, H)
    got_carry, got_y = port((zeros, zeros), torch.from_numpy(x).bfloat16())
    assert got_y.dtype == torch.float32
    _close(got_y, want_y)


# ---- RNN, flip_sequences, Bidirectional ---------------------------------------------

@pytest.mark.parametrize("lengths", [False, True], ids=["no_lengths", "lengths"])
@pytest.mark.parametrize("order", ["forward", "reverse", "reverse_keep_order"])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_rnn_matches_flax(kind, order, lengths):
    x = _draw(B, L, E, seed=11)
    seq_lengths = LENGTHS if lengths else None
    kwargs = {"reverse": order != "forward", "keep_order": order == "reverse_keep_order"}
    jrnn = fnn.RNN(CELLS[kind][0](features=H))
    params = _randomize(jrnn.init(jax.random.key(1), x)["params"], 12)
    want = jrnn.apply({"params": params}, x, seq_lengths=seq_lengths, **kwargs)
    cell = from_flax_params(CELLS[kind][1](E, H, device="cpu"), params["cell"])
    got = RNN(cell)(torch.from_numpy(x),
                    seq_lengths=None if seq_lengths is None else torch.from_numpy(seq_lengths),
                    **kwargs)
    _close(got, want)


@pytest.mark.parametrize("lengths", [False, True], ids=["no_lengths", "lengths"])
def test_flip_sequences_matches_flax(lengths):
    from flax.linen.recurrent import flip_sequences as jax_flip

    x = _draw(B, L, 2, seed=13)
    seq_lengths = LENGTHS if lengths else None
    want = jax_flip(jnp.asarray(x), seq_lengths, num_batch_dims=1, time_major=False)
    got = flip_sequences(torch.from_numpy(x),
                         None if seq_lengths is None else torch.from_numpy(seq_lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_bidirectional_matches_flax(kind):
    x = _draw(B, L, E, seed=14)
    jbi = fnn.Bidirectional(fnn.RNN(CELLS[kind][0](features=H)),
                            fnn.RNN(CELLS[kind][0](features=H)))
    params = _randomize(jbi.init(jax.random.key(2), x)["params"], 15)
    want = jbi.apply({"params": params}, x, seq_lengths=LENGTHS)
    fwd = from_flax_params(CELLS[kind][1](E, H, device="cpu"), params["forward_rnn"]["cell"])
    bwd = from_flax_params(CELLS[kind][1](E, H, device="cpu"), params["backward_rnn"]["cell"])
    got = Bidirectional(RNN(fwd), RNN(bwd))(torch.from_numpy(x),
                                            seq_lengths=torch.from_numpy(LENGTHS))
    assert got.shape == (B, L, 2 * H)
    _close(got, want)


# ---- the list and sequence inputs ---------------------------------------------------

METHODS = ("avg_pooling", "mean", "max_pooling", "sum", "none")


def _batch(lengths_field, seed=0):
    batch = {"hist": _ids(seed)}
    if lengths_field:
        batch["hist_len"] = LENGTHS.copy()
    return batch


def _input_pair(jax_cls, port_cls, kwargs, batch, seed=21):
    jm = jax_cls(field_size=V, embed_size=E, fields=("hist",), **kwargs)
    params = _randomize(jm.init(jax.random.key(seed), batch)["params"], seed + 1)
    port = from_flax_params(port_cls(V, E, ("hist",), device="cpu", **kwargs), params)
    assert set(dict(port.named_parameters())) == {torch_name(p) for p in flatten(params)}
    return jm, port, params


def _forward_and_table_grad(jm, port, params, batch):
    """Both outputs, and the table's gradient of the sum of the outputs'
    squares (the padding-throughout row's ``finfo.min`` under max pooling
    left out)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def finite(out):
        return jnp.where(jnp.abs(out) < 1e30, out, 0.0)

    want = jm.apply({"params": params}, batch)
    jgrad = jax.grad(lambda p: jnp.sum(finite(jm.apply({"params": p}, batch)) ** 2))(params)
    got = port(tb)
    out = torch.where(got.abs() < 1e30, got, torch.zeros_like(got))
    (tgrad,) = torch.autograd.grad(torch.sum(out ** 2), [port.embedding])
    return got, want, tgrad, jgrad["embedding"]


@pytest.mark.parametrize("lengths_field", [False, True], ids=["padding", "lengths_field"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("attn", [False, True], ids=["plain", "attention"])
def test_list_indices_embedding_matches_the_jax_input(attn, method, lengths_field):
    kwargs = {"output_method": method, "use_attn": attn, "num_heads": 2 if attn else 1,
              "lengths_field": "hist_len" if lengths_field else None}
    batch = _batch(lengths_field)
    jm, port, params = _input_pair(JS.ListIndicesEmbedding, TS.ListIndicesEmbedding, kwargs,
                                   batch)
    got, want, tgrad, jgrad = _forward_and_table_grad(jm, port, params, batch)
    assert got.shape == ((B, L, E) if method == "none" else (B, 1, E))
    _close(got, want)
    _close(tgrad, jgrad)


@pytest.mark.parametrize("lengths_field", [False, True], ids=["padding", "lengths_field"])
@pytest.mark.parametrize("method", METHODS)
def test_sequence_indices_embedding_matches_under_every_output_method(method, lengths_field):
    kwargs = {"output_method": method, "lengths_field": "hist_len" if lengths_field else None}
    batch = _batch(lengths_field)
    jm, port, params = _input_pair(JS.SequenceIndicesEmbedding, TS.SequenceIndicesEmbedding,
                                   kwargs, batch)
    got, want, tgrad, jgrad = _forward_and_table_grad(jm, port, params, batch)
    _close(got, want)
    _close(tgrad, jgrad)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "bidirectional"])
@pytest.mark.parametrize("rnn_method", ["lstm", "gru", "rnn"])
def test_sequence_indices_embedding_stacks_each_cell(rnn_method, bidirectional):
    """Two layers of each cell, one way and bidirectional (the second
    layer's input kernels ``(2E, E)``, flax's names ``<Cell>_0 .. _3`` in
    the input's scope, ``bidir_proj``), with padding-derived lengths."""
    kwargs = {"rnn_method": rnn_method, "bidirectional": bidirectional, "num_layers": 2,
              "output_method": "avg_pooling"}
    batch = _batch(False, seed=3)
    jm, port, params = _input_pair(JS.SequenceIndicesEmbedding, TS.SequenceIndicesEmbedding,
                                   kwargs, batch)
    cell = CELLS[rnn_method][1].__name__
    assert port.cell_names == [f"{cell}_{i}" for i in range(4 if bidirectional else 2)]
    if bidirectional:
        assert tuple(getattr(port, f"{cell}_2")._modules[
            "ii" if rnn_method == "lstm" else "i" if rnn_method == "rnn" else "in"
        ].weight.shape) == (E, 2 * E)
    got, want, tgrad, jgrad = _forward_and_table_grad(jm, port, params, batch)
    _close(got, want)
    _close(tgrad, jgrad)
    # every parameter's gradient
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = dict(port.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(torch.sum(port(tb) ** 2), list(named.values()))))
    jgrads = flatten(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, batch) ** 2))(params))
    for path, jg in jgrads.items():
        jg = np.asarray(jg)
        _close(grads[torch_name(path)], jg.T if path.endswith("kernel") else jg)


def test_sequence_inputs_keep_float32_under_a_bf16_pipeline():
    """The list's attention, the cells and ``bidir_proj`` are float32 in
    the JAX package under any compute dtype: ``apply_compute_dtype`` leaves
    them so."""
    from torecsys_tpu_torch.layers.precision import apply_compute_dtype

    lst = TS.ListIndicesEmbedding(V, E, ("hist",), use_attn=True, device="cpu")
    seq = TS.SequenceIndicesEmbedding(V, E, ("hist",), bidirectional=True, device="cpu")
    for m in (lst, seq):
        apply_compute_dtype(m, "bfloat16")
    assert lst.attention.compute_dtype is None and seq.bidir_proj.compute_dtype is None
    out = seq({"hist": torch.from_numpy(_ids())})
    assert out.dtype == torch.float32


def test_sequence_inputs_state_their_output_shape():
    assert TS.ListIndicesEmbedding(V, E, ("hist",), device="cpu").output_shape() == (1, E)
    assert TS.SequenceIndicesEmbedding(V, E, ("hist",), device="cpu").output_shape() == (1, E)
    with pytest.raises(ValueError, match="L is the batch's"):
        TS.ListIndicesEmbedding(V, E, ("hist",), output_method="none",
                                device="cpu").output_shape()
    with pytest.raises(ValueError, match="unknown rnn_method"):
        TS.SequenceIndicesEmbedding(V, E, ("hist",), rnn_method="tcn", device="cpu")


# ---- the masked attention -------------------------------------------------------------

def test_attention_mask_matches_flax():
    x = _draw(B, L, E, seed=31)
    mask = np.arange(L)[None, :] < LENGTHS[:, None]  # row 3: every key masked
    mask4 = np.broadcast_to(mask[:, None, None, :], (B, 1, L, L))
    jm = fnn.MultiHeadDotProductAttention(num_heads=2, qkv_features=E)
    params = _randomize(jm.init(jax.random.key(3), x, x)["params"], 32)
    port = from_flax_params(MultiHeadDotProductAttention(E, 2, qkv_features=E, device="cpu"),
                            params)
    want = jm.apply({"params": params}, x, x, mask=mask4)
    got = port(torch.from_numpy(x), mask=torch.from_numpy(np.ascontiguousarray(mask4)))
    _close(got, want)
    # the masked row: a uniform softmax over every key
    uniform = jm.apply({"params": params}, x[3:4], x[3:4],
                       mask=np.zeros((1, 1, L, L), bool))
    _close(got[3:4], uniform)
    # without a mask the bits are those of a mask of all True
    plain = port(torch.from_numpy(x))
    assert torch.equal(plain, port(torch.from_numpy(x), mask=torch.ones(B, 1, L, L, dtype=bool)))
    _close(plain, jm.apply({"params": params}, x, x))


# ---- dynamic routing --------------------------------------------------------------------

@pytest.mark.parametrize("num_iter", [1, 3])
def test_dynamic_routing_matches_the_jax_layer(num_iter):
    n, o = 9, 5
    x = _draw(B, n, E, seed=41)
    jl = JaxRouting(embed_size=E, routed_size=o, max_num_caps=4, num_fields=n,
                    num_iter=num_iter)
    params = _randomize(jl.init(jax.random.key(4), x)["params"], 42, scale=0.3)
    port = from_flax_params(DynamicRoutingLayer(E, o, 4, n, num_iter=num_iter, device="cpu"),
                            params)
    k = resolve_num_capsules(n, 4)
    assert k == 3 and tuple(port.routing_logits.shape) == (1, k, n)
    assert tuple(port.shared_projection.shape) == (E, o)
    got = port(torch.from_numpy(x))
    _close(got, jl.apply({"params": params}, x))
    named = dict(port.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(torch.sum(got ** 2), list(named.values()))))
    jgrads = jax.grad(lambda p: jnp.sum(jl.apply({"params": p}, x) ** 2))(params)
    for name in ("shared_projection", "routing_logits"):
        _close(grads[name], jgrads[name])


def test_resolve_num_capsules_matches_the_jax_package():
    from torecsys_tpu.layers.ctr.routing import resolve_num_capsules as jax_resolve

    for n in (1, 2, 3, 7, 8, 100, 5000):
        for k in (1, 3, 8):
            assert resolve_num_capsules(n, k) == jax_resolve(n, k)


# ---- the operations remainder, BaseLayer, the decorators -------------------------------

def test_operations_remainder_matches_the_jax_package(tmp_path):
    assert TO.combination(7, 3) == JO.combination(7, 3) == 35
    for n in (1, 2, 5):
        for off in (0, 1, 2):
            for got, want in zip(TO.pair_indices(n, off), JO.pair_indices(n, off)):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.int32
    v = _draw(B, L, E, seed=51)
    value, scores = TO.dummy_attention(None, None, torch.from_numpy(v))
    jvalue, jscores = JO.dummy_attention(None, None, jnp.asarray(v))
    np.testing.assert_array_equal(value.numpy(), np.asarray(jvalue))
    assert scores.shape == jscores.shape and not scores.any()
    for dim in (0, 1, 2):
        np.testing.assert_array_equal(TO.replicate_tensor(torch.from_numpy(v), 3, dim).numpy(),
                                      np.asarray(JO.replicate_tensor(jnp.asarray(v), 3, dim)))
    # squash, at 0 too (the eps keeps the gradient finite there)
    x = _draw(B, 3, E, seed=52)
    x[0, 0] = 0.0
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TO.squash(tx, dim=-1)
    _close(got, JO.squash(jnp.asarray(x), axis=-1))
    (g,) = torch.autograd.grad(got.sum(), [tx])
    _close(g, jax.grad(lambda a: JO.squash(a, axis=-1).sum())(jnp.asarray(x)))
    assert torch.isfinite(g).all()
    # the heat map, through matplotlib (Agg)
    import matplotlib

    matplotlib.use("Agg")
    out = tmp_path / "attn.png"
    TO.show_attention(torch.rand(3, 4), x_axis="a,b,c,d", y_axis=["x", "y", "z"],
                      save_dir=str(out))
    assert out.stat().st_size > 0
    with pytest.raises(ValueError, match="2-D"):
        TO.show_attention(np.zeros(3), save_dir=str(out))


def test_show_attention_without_matplotlib_raises_import_error(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="requires matplotlib"):
        TO.show_attention(np.zeros((2, 2)))


def test_base_layer_and_the_decorators_match_the_jax_package():
    class Layer(BaseLayer):
        pass

    assert Layer().inputs_size is None and Layer().outputs_size is None

    for mod in (TD, JD):
        @mod.in_development("x")
        class Thing:
            def __init__(self, v):
                self.v = v

        with pytest.warns(FutureWarning, match="in development"):
            assert Thing(3).v == 3

        @mod.deprecated("new_thing")
        def old(v):
            return v + 1

        with pytest.warns(DeprecationWarning, match="use new_thing instead"):
            assert old(1) == 2

        @mod.in_development()
        def func(v):
            return v * 2

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert func(2) == 4
        assert [type(x.message) for x in w] == [FutureWarning]
