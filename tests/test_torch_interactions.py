"""The port's interaction primitives (``torecsys_tpu_torch/ops/interactions.py``)
against the JAX package's (``torecsys_tpu/ops/interactions.py``) on the
same float32 inputs drawn with numpy, rtol 1e-6 / atol 1e-6.

The inputs lie on a 1/8 grid, small enough that every product and partial
sum of these shapes is exact in float32: the two sides sum the same terms
in orders that differ, and only a wrong term, pair or layout can tell them
apart.  (On normal draws a sum of 64 unit-sized products differs between
the two by rounding alone, up to 2e-6 here.)"""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.ops import interactions as J
from torecsys_tpu.utils.operations import pair_indices
from torecsys_tpu_torch.ops import interactions as T

B, N, E = 6, 5, 8
P = N * (N - 1) // 2


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _draw(*shape, seed=0):
    """Normal draws rounded to the 1/8 grid."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=shape) * 8) / 8).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 28])
def test_pairs_are_the_jax_packages_row_major_pairs(n):
    rows, cols = pair_indices(n)
    got_rows, got_cols = T._pairs(n, torch.device("cpu"))
    np.testing.assert_array_equal(got_rows.numpy(), rows)
    np.testing.assert_array_equal(got_cols.numpy(), cols)


def test_fm_ffm_afm_and_inner_products():
    x, fx = _draw(B, N, E), _draw(B, N * N, E, seed=1)
    _close(T.fm_pairwise_interaction(torch.from_numpy(x)), J.fm_pairwise_interaction(x))
    _close(T.ffm_pairwise_interaction(torch.from_numpy(fx), N),
           J.ffm_pairwise_interaction(jnp.asarray(fx), N))
    _close(T.afm_pairwise_products(torch.from_numpy(x)), J.afm_pairwise_products(jnp.asarray(x)))
    _close(T.inner_product_pairs(torch.from_numpy(x)), J.inner_product_pairs(jnp.asarray(x)))
    with pytest.raises(ValueError, match="N\\*N"):
        T.ffm_pairwise_interaction(torch.from_numpy(x), N)


@pytest.mark.parametrize("kernel_type,shape", [("mat", (E, P, E)), ("vec", (P, E)),
                                               ("num", (P, 1))])
def test_outer_product_pairs(kernel_type, shape):
    x, k = _draw(B, N, E), _draw(*shape, seed=2)
    _close(T.outer_product_pairs(torch.from_numpy(x), torch.from_numpy(k), kernel_type),
           J.outer_product_pairs(jnp.asarray(x), jnp.asarray(k), kernel_type))
    with pytest.raises(ValueError, match="kernel_type"):
        T.outer_product_pairs(torch.from_numpy(x), torch.from_numpy(k), "other")


def test_cross_layer():
    d = N * E
    x0, x, w, b = _draw(B, d), _draw(B, d, seed=1), _draw(d, seed=2), _draw(d, seed=3)
    got = T.cross_layer(*(torch.from_numpy(a) for a in (x0, x, w, b)))
    _close(got, J.cross_layer(*(jnp.asarray(a) for a in (x0, x, w, b))))


@pytest.mark.parametrize("h,o", [(N, 6), (3, 4)])
def test_cin_interaction(h, o):
    x0, xk, w = _draw(B, N, E), _draw(B, h, E, seed=1), _draw(o, h, N, seed=2)
    got = T.cin_interaction(*(torch.from_numpy(a) for a in (x0, xk, w)))
    assert got.shape == (B, o, E)
    _close(got, J.cin_interaction(*(jnp.asarray(a) for a in (x0, xk, w))))


# ---- the CIN's compression as one autograd Function (ops.kernels.cin) -------
#
# On the CPU the Function's forward is the composition the port ran before
# (the outer product formed, one matmul) and its backward autograd's through
# that composition, recomputed: the same operations in the same order, so
# the same bits as autograd over the composition, in float64 and float32.
# On the card the kernels run instead; their wrappers' card branch is
# exercised here with the plain versions standing in for the launches.

# (B, N, E, H, O, what xk is): the split-half CIN's strided second half of a
# (B, 2H, E) map, the direct variant's whole map, the first layer's x0
# itself; O and H off any tile; E 1, 10 (the benchmark's, with its N = 26)
# and 16; B 1 and 4097
CIN_SHAPES = {
    "split_half_strided": (6, 5, 8, 4, 7, "half"),
    "direct": (6, 5, 8, 5, 6, "direct"),
    "first_layer_xk_is_x0": (5, 5, 3, 5, 9, "x0"),
    "odd_o_h": (7, 3, 10, 13, 11, "half"),
    "e1": (9, 4, 1, 6, 5, "half"),
    "e10_n26": (4, 26, 10, 10, 20, "half"),
    "e16": (3, 4, 16, 3, 9, "direct"),
    "b1": (1, 4, 10, 5, 6, "half"),
    "b4097": (4097, 3, 2, 2, 3, "half"),
}


def _cin_composed(x0, xk, w):
    """The CIN's compression as the port composed it before the Function:
    the outer product in memory, one matmul, autograd's backward."""
    b, h, e = xk.shape
    n = x0.shape[1]
    o = w.shape[0]
    z = xk.permute(1, 0, 2)[:, None] * x0.permute(1, 0, 2)[None]
    out = torch.matmul(w.reshape(o, h * n), z.reshape(h * n, b * e))
    return out.reshape(o, b, e).permute(1, 0, 2)


def _cin_leaves(shape, dtype, seed=0):
    """The leaves of one call, normal draws: x0, the tensor xk is cut from
    (None where xk is x0), the weight, and the output's gradient."""
    b, n, e, h, o, kind = shape
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randn(b, n, e, generator=gen, dtype=dtype)
    full = None if kind == "x0" else torch.randn(b, 2 * h if kind == "half" else h, e,
                                                   generator=gen, dtype=dtype)
    w = torch.randn(o, h, n, generator=gen, dtype=dtype)
    upstream = torch.randn(b, o, e, generator=gen, dtype=dtype)
    return x0, full, w, upstream


def _cin_run(fn, shape, leaves):
    """``fn``'s output and the gradients of its leaves (xk's through the
    tensor it is cut from, or through x0)."""
    h, kind = shape[3], shape[5]
    x0, full, w, upstream = (None if t is None else t.clone().requires_grad_()
                             for t in leaves)
    upstream = upstream.detach()
    xk = x0 if kind == "x0" else (full[:, h:] if kind == "half" else full)
    out = fn(x0, xk, w)
    (out * upstream).sum().backward()
    return out.detach(), x0.grad, None if full is None else full.grad, w.grad


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(CIN_SHAPES.values()), ids=list(CIN_SHAPES))
def test_cin_function_is_the_composition_it_replaced(shape, dtype):
    """The Function's plain route: the forward, dx0, dxk and dW the same bits
    as autograd over the composition."""
    leaves = _cin_leaves(shape, dtype)
    got = _cin_run(T.cin_interaction, shape, leaves)
    want = _cin_run(_cin_composed, shape, leaves)
    assert got[0].shape == shape[:1] + (shape[4], shape[2])
    for name, g, w in zip(("out", "dx0", "dxk", "dw"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == dtype and torch.equal(g, w), name


def _cin_card_branch(monkeypatch):
    """The wrappers' card branch on the CPU: ``device_kind`` says "cuda"
    inside ``ops.kernels.cin`` alone, and each launch writes what the plain
    versions compute into the wrapper's outputs.  Returns the launches'
    records: the name and whether ``xk`` came strided."""
    from torecsys_tpu_torch.ops import kernels
    from torecsys_tpu_torch.ops.kernels import cin

    calls = []
    fake = types.SimpleNamespace(**{k: getattr(kernels, k) for k in dir(kernels)
                                    if not k.startswith("__")})
    fake.device_kind = lambda *tensors: "cuda"
    monkeypatch.setattr(cin, "_k", fake)

    def forward(x0, xk, weight, out):
        calls.append(("forward", xk.is_contiguous()))
        out.copy_(cin.cin_forward_plain(x0, xk, weight))

    def backward(grad, x0, xk, weight, dx0, dxk, dweight):
        calls.append(("backward", xk.is_contiguous()))
        for buf, t in zip((dx0, dxk, dweight), cin.cin_backward_plain(grad, x0, xk, weight)):
            buf.copy_(t)

    monkeypatch.setattr(cin, "_forward_launch", forward)
    monkeypatch.setattr(cin, "_backward_launch", backward)
    return calls


@pytest.mark.parametrize("shape", [CIN_SHAPES[k] for k in ("split_half_strided", "direct",
                                                           "first_layer_xk_is_x0")],
                         ids=["split_half_strided", "direct", "first_layer_xk_is_x0"])
def test_cin_card_branch_with_the_plain_versions_standing_in(monkeypatch, shape):
    """One forward and one backward launch a call, xk handed on strided as
    it came; a packed (B, O, E) output; the plain route's values and
    gradients; ``launches`` count each."""
    from torecsys_tpu_torch.ops.kernels import cin

    leaves = _cin_leaves(shape, torch.float32)
    want = _cin_run(T.cin_interaction, shape, leaves)
    calls = _cin_card_branch(monkeypatch)
    before = (cin.cin_forward.launches, cin.cin_backward.launches)
    got = _cin_run(T.cin_interaction, shape, leaves)
    assert (cin.cin_forward.launches - before[0], cin.cin_backward.launches - before[1]) == (1, 1)
    assert calls == [("forward", shape[5] != "half"), ("backward", shape[5] != "half")]
    assert got[0].is_contiguous()
    for name, g, w in zip(("out", "dx0", "dxk", "dw"), got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_cin_layer_launches_three_and_three_on_the_card_branch(monkeypatch):
    """A 3-layer split-half CIN with BatchNorm: 3 forward and 3 backward
    launches a step, the CPU route's output and gradients within 1e-5 of
    each tensor's largest element:
    the card branch hands BatchNorm a packed (B, O, E) map where the CPU
    route hands it a permuted view, and the batch statistics' sums take
    their terms in another order.  The pre-BatchNorm biases' gradients are 0
    in exact arithmetic, rounding noise either way, and are not compared."""
    from torecsys_tpu_torch.layers.ctr.cin import CompressInteractionNetworkLayer
    from torecsys_tpu_torch.ops.kernels import cin

    def step(layer, x):
        x = x.clone().requires_grad_()
        out = layer(x)
        out.sum().backward()
        return out.detach(), x.grad, {n: p.grad for n, p in layer.named_parameters()}

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 5, 4, generator=gen)
    layer = CompressInteractionNetworkLayer(4, 5, 1, (6, 6, 4), device="cpu", generator=gen)
    want = step(copy.deepcopy(layer), x)
    _cin_card_branch(monkeypatch)
    before = (cin.cin_forward.launches, cin.cin_backward.launches)
    got = step(layer, x)
    assert (cin.cin_forward.launches - before[0], cin.cin_backward.launches - before[1]) == (3, 3)
    def close(g, w, name):  # within 1e-5 of the tensor's largest element
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * w.abs().max().item(), msg=name)

    close(got[0], want[0], "out")
    close(got[1], want[1], "x")
    compared = [n for n in got[2] if not n.startswith("bias_")]
    assert len(compared) == len(got[2]) - 3
    for name in compared:
        close(got[2][name], want[2][name], name)


@pytest.mark.parametrize("bad", ["bf16", "f16", "int", "x0_rank", "xk_batch", "xk_embed",
                                 "weight_maps", "weight_fields", "grad_shape", "mixed_dtype",
                                 "mixed_device"])
def test_cin_wrappers_refuse_what_they_do_not_take(bad):
    """Anywhere: a dtype other than float32 (float64 on the CPU), shapes that
    do not fit together, tensors on more than one device."""
    from torecsys_tpu_torch.ops.kernels import cin

    x0, xk, w = torch.zeros(3, 4, 2), torch.zeros(3, 5, 2), torch.zeros(6, 5, 4)
    grad = torch.zeros(3, 6, 2)
    args = {"x0": x0, "xk": xk, "weight": w, "grad": grad}
    change = {
        "bf16": {"x0": x0.bfloat16(), "xk": xk.bfloat16(), "weight": w.bfloat16(),
                 "grad": grad.bfloat16()},
        "f16": {"x0": x0.half(), "xk": xk.half(), "weight": w.half(), "grad": grad.half()},
        "int": {"x0": x0.int(), "xk": xk.int(), "weight": w.int(), "grad": grad.int()},
        "x0_rank": {"x0": x0[0]},
        "xk_batch": {"xk": xk[:2]},
        "xk_embed": {"xk": torch.zeros(3, 5, 3)},
        "weight_maps": {"weight": torch.zeros(6, 4, 4)},
        "weight_fields": {"weight": torch.zeros(6, 5, 3)},
        "grad_shape": {"grad": torch.zeros(3, 5, 2)},
        "mixed_dtype": {"weight": w.double()},
        "mixed_device": {"weight": torch.zeros(6, 5, 4, device="meta")},
    }[bad]
    args.update(change)
    if bad != "grad_shape":
        with pytest.raises(ValueError):
            cin.cin_forward(args["x0"], args["xk"], args["weight"])
    with pytest.raises(ValueError):
        cin.cin_backward(args["grad"], args["x0"], args["xk"], args["weight"])


@pytest.mark.parametrize("bad", ["f64", "x0_strided", "grad_strided", "xk_embed_strided"])
def test_cin_card_branch_refuses_what_the_kernels_do_not_take(monkeypatch, bad):
    """On the card: float64, and x0, the gradient or xk's E axis strided."""
    from torecsys_tpu_torch.ops.kernels import cin

    _cin_card_branch(monkeypatch)
    x0, xk, w = torch.zeros(3, 4, 2), torch.zeros(3, 10, 2)[:, 5:], torch.zeros(6, 5, 4)
    grad = torch.zeros(3, 6, 2)
    cin.cin_forward(x0, xk, w)
    cin.cin_backward(grad, x0, xk, w)
    args = {"x0": x0, "xk": xk, "weight": w, "grad": grad}
    args.update({
        "f64": {"x0": x0.double(), "xk": xk.double(), "weight": w.double(),
                "grad": grad.double()},
        "x0_strided": {"x0": torch.zeros(4, 3, 2).transpose(0, 1)},
        "grad_strided": {"grad": torch.zeros(6, 3, 2).transpose(0, 1)},
        "xk_embed_strided": {"xk": torch.zeros(3, 5, 4)[:, :, ::2]},
    }[bad])
    with pytest.raises(ValueError):
        if bad == "grad_strided":
            cin.cin_backward(args["grad"], args["x0"], args["xk"], args["weight"])
        else:
            cin.cin_forward(args["x0"], args["xk"], args["weight"])
