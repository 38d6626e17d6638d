"""The low-rank cross's combine (``ops.kernels.cross``, the autograd Function
``ops.interactions.low_rank_cross``): its plain twin, which the CPU runs,
against autograd over the composition it replaced (``x0 * u(v(x)).to(x0.dtype)
+ x`` a layer), and the wrappers' card branch with the plain versions standing
in for the kernels' launches.  Free of JAX.

The forward takes the same operations in the same order: the same bits.  The
backward's products are autograd's, so every weight's and bias' gradient is
the same bits on the CPU too; only ``x0``'s gradient sums its terms (three
layers' ``Gt * p``, the first layer's ``Gt`` and its V product's input
gradient) in another order, the layers' terms gathered layer by layer, so it
is held to ``X0_GRAD_TOL`` of its largest element: a few roundings of float32
(2^-24 each) or of bf16 (2^-8 each).
"""

import copy
import types

import pytest
import torch

from torecsys_tpu_torch.layers.ctr import LowRankCrossNetworkLayer
from torecsys_tpu_torch.layers.precision import apply_compute_dtype
from torecsys_tpu_torch.ops import kernels
from torecsys_tpu_torch.ops.kernels import cross as cross_kernel

LAYERS = 3
RANK = 16
# (B, D): the DLRM cell's width (16-byte vectors), a width off the 8-column
# vector (element by element), one row
SHAPES = [(8, 3456), (5, 12), (1, 24)]
SHAPE_IDS = ["d3456", "d12", "b1"]
X0_GRAD_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}


def composed(layer, x0):
    """The combine as it was: ATen's ops under autograd, a layer at a time."""
    x = x0
    for i in range(layer.num_layers):
        p = getattr(layer, f"u_{i}")(getattr(layer, f"v_{i}")(x))
        x = x0 * p.to(x0.dtype) + x
    return x


def make_layer(compute, dtype, d, seed=3):
    """A 3-layer cross at rank 16 with nonzero biases; under no compute dtype
    and bf16 inputs its parameters are bf16 (a bf16 model), so its float32
    products take bf16 operands."""
    gen = torch.Generator().manual_seed(seed)
    layer = LowRankCrossNetworkLayer(LAYERS, d, RANK, device="cpu", generator=gen)
    with torch.no_grad():
        for i in range(LAYERS):
            getattr(layer, f"u_{i}").bias.normal_(0.0, 0.1, generator=gen)
    if compute is None and dtype == torch.bfloat16:
        layer = layer.to(torch.bfloat16)
    apply_compute_dtype(layer, compute)
    return layer


def inputs(b, d, dtype, seed=4):
    gen = torch.Generator().manual_seed(seed + b * d)
    return (torch.randn(b, d, generator=gen).to(dtype),
            torch.randn(b, d, generator=gen).to(dtype))


def grads(fn, layer, x0, upstream):
    x = x0.clone().requires_grad_()
    out = fn(layer, x)
    (out * upstream).sum().backward()
    return out.detach(), x.grad, {n: p.grad for n, p in layer.named_parameters()}


@pytest.mark.parametrize("b,d", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["x0_f32", "x0_bf16"])
@pytest.mark.parametrize("compute", [None, "bfloat16"], ids=["f32", "bf16"])
def test_twin_matches_the_composition_it_replaced(compute, dtype, b, d):
    layer = make_layer(compute, dtype, d)
    before = copy.deepcopy(layer)
    x0, upstream = inputs(b, d, dtype)
    out, dx0, dparams = grads(lambda m, x: m(x), layer, x0, upstream)
    want, want_dx0, want_dparams = grads(composed, before, x0, upstream)
    assert out.dtype == dtype and torch.equal(out, want)
    assert dx0.dtype == dtype
    torch.testing.assert_close(dx0.float(), want_dx0.float(), rtol=0,
                               atol=X0_GRAD_TOL[dtype] * want_dx0.float().abs().max().item())
    assert sorted(dparams) == sorted(want_dparams) and len(dparams) == 3 * LAYERS
    for name, g in dparams.items():
        torch.testing.assert_close(g, want_dparams[name], rtol=0, atol=0, msg=name)


def card_branch(monkeypatch):
    """The wrappers' card branch on the CPU: ``device_kind`` says "cuda"
    inside ``ops.kernels.cross`` alone, and each launch writes what the plain
    version computes into the wrapper's outputs.  Returns the launches'
    records."""
    calls = []
    fake = types.SimpleNamespace(**{k: getattr(kernels, k) for k in dir(kernels)
                                    if not k.startswith("__")})
    fake.device_kind = lambda *tensors: "cuda"
    monkeypatch.setattr(cross_kernel, "_k", fake)

    def forward(x0, x, y, bias, out, out_copy):
        calls.append(("forward", x is x0, out_copy is not None,
                      cross_kernel.vector_path(x0.shape[1], x0, x, y, bias, out, out_copy)))
        o, c = cross_kernel.low_rank_cross_forward_plain(x0, None if x is x0 else x, y, bias,
                                                         out_copy is not None)
        out.copy_(o)
        if c is not None:
            out_copy.copy_(c)

    def backward(grad, grad_copy, grad_x0, x0, y, bias, x_is_x0, dx0, dx, dy, partials, dbias):
        calls.append(("backward", x_is_x0, grad_copy is not None, grad_x0 is not None,
                      dx is not None, None if partials is None else tuple(partials.shape)))
        got = cross_kernel.low_rank_cross_backward_plain(grad, grad_copy, grad_x0, x0, y, bias,
                                                         x_is_x0)
        for buf, t in zip((dx0, dx, dy, dbias), got):
            if buf is not None:
                buf.copy_(t)

    monkeypatch.setattr(cross_kernel, "_forward_launch", forward)
    monkeypatch.setattr(cross_kernel, "_backward_launch", backward)
    return calls


@pytest.mark.parametrize("b,d", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("compute", [None, "bfloat16"], ids=["f32", "bf16"])
def test_card_branch_with_the_plain_versions_standing_in(monkeypatch, compute, b, d):
    """One launch a layer forward and one backward, with the arguments the
    kernel needs: the first layer's x passed as x0, the bf16 copy made for
    the layers whose successor reads it, x0's gradient from every layer but
    the last, the bias partials of 64-row blocks, ``dx`` written only where
    the copy had a gradient; the results equal the CPU's; ``launches``
    count 3 + 3."""
    layer = make_layer(compute, torch.float32, d)
    x0, upstream = inputs(b, d, torch.float32)
    want, want_dx0, want_dparams = grads(lambda m, x: m(x), copy.deepcopy(layer), x0, upstream)
    calls = card_branch(monkeypatch)
    before = (cross_kernel.low_rank_cross_forward.launches,
              cross_kernel.low_rank_cross_backward.launches)
    x = x0.clone().requires_grad_()
    out = layer(x)
    (out * upstream).sum().backward()
    assert (cross_kernel.low_rank_cross_forward.launches - before[0],
            cross_kernel.low_rank_cross_backward.launches - before[1]) == (LAYERS, LAYERS)
    assert torch.equal(out, want) and torch.equal(x.grad, want_dx0)
    for name, p in layer.named_parameters():
        assert torch.equal(p.grad, want_dparams[name]), name
    bf16 = compute is not None
    vec = d % 8 == 0
    assert calls[:LAYERS] == [("forward", i == 0, bf16 and i + 1 < LAYERS, vec)
                              for i in range(LAYERS)]
    rows = (-(-b // cross_kernel.ROWS_PER_BLOCK), d)
    # autograd runs the layers' backwards last layer first
    assert calls[LAYERS:] == [("backward", i == 0, bf16 and i + 1 < LAYERS, i + 1 < LAYERS,
                               bf16 and 0 < i < LAYERS - 1, rows if bf16 else None)
                              for i in reversed(range(LAYERS))]


@pytest.mark.parametrize("compute", [None, "bfloat16"], ids=["f32", "bf16"])
def test_card_branch_takes_an_expanded_gradient(monkeypatch, compute):
    """``layer(x).sum().backward()`` hands the last layer an expanded
    gradient of stride 0, which the layer's reshape keeps as a view: the
    backward packs it before the kernel's card check, and the gradients
    equal the CPU's."""
    layer = make_layer(compute, torch.float32, 24)
    x0, _ = inputs(3, 24, torch.float32)
    want = x0.clone().requires_grad_()
    copy.deepcopy(layer)(want).sum().backward()
    card_branch(monkeypatch)
    got = x0.clone().requires_grad_()
    layer(got).sum().backward()
    assert torch.equal(got.grad, want.grad)


def test_wrappers_refuse_what_the_kernel_does_not_take(monkeypatch):
    """On the card: a dtype other than float32 and bf16, a non-contiguous
    tensor; anywhere: shapes that differ, a bias of another dtype or width."""
    card_branch(monkeypatch)
    x0 = torch.zeros(4, 16)
    y = torch.zeros(4, 16, dtype=torch.bfloat16)
    bias = torch.zeros(16, dtype=torch.bfloat16)
    cross_kernel.low_rank_cross_forward(x0, None, y, bias, True)
    cross_kernel.low_rank_cross_backward(x0, y, x0, x0, y, bias)
    bad_forward = (dict(x0=x0.double()), dict(y=y.double(), bias=bias.double()),
                   dict(x0=torch.zeros(16, 4).t()), dict(y=torch.zeros(4, 8, dtype=y.dtype)),
                   dict(bias=bias.float()), dict(bias=bias[:8]), dict(x=x0[:2]))
    for bad in bad_forward:
        args = dict(x0=x0, x=None, y=y, bias=bias)
        args.update(bad)
        with pytest.raises(ValueError):
            cross_kernel.low_rank_cross_forward(args["x0"], args["x"], args["y"], args["bias"])
    for bad in (dict(grad=x0.bfloat16()), dict(grad_copy=x0), dict(grad=torch.zeros(16, 4).t()),
                dict(grad_x0=y), dict(grad_x0=x0[:2])):
        args = dict(grad=x0, grad_copy=None, grad_x0=None, x0=x0, y=y, bias=bias)
        args.update(bad)
        with pytest.raises(ValueError):
            cross_kernel.low_rank_cross_backward(**args)


def test_vector_path_needs_whole_vectors_on_16_byte_boundaries():
    t = torch.zeros(64)
    assert cross_kernel.vector_path(8, t, None, t[4:])
    assert not cross_kernel.vector_path(12, t)
    assert not cross_kernel.vector_path(8, t, t[1:])
    assert not cross_kernel.vector_path(8, t.bfloat16()[2:])


def test_trainer_counts_cross_fused_only_where_the_kernel_ran(monkeypatch):
    """Through the Trainer on the CPU (the small DLRM-DCNv2 of the gloo
    tests, 2 cross layers), the wrappers' ``launches``, set to 0 before each
    run: the plain twin launches nothing; the card branch 2 forward and 2
    backward a step."""
    from dlrm_ranks import batches, pipeline

    from torecsys_tpu_torch import Trainer

    feed = batches(19, 2)

    def launched():
        cross_kernel.low_rank_cross_forward.launches = 0
        cross_kernel.low_rank_cross_backward.launches = 0
        trainer = Trainer(pipeline(True), seed=0, log_every=10**9, presort=False)
        trainer.init_state()
        trainer.train_steps(feed)
        return (cross_kernel.low_rank_cross_forward.launches,
                cross_kernel.low_rank_cross_backward.launches)

    assert launched() == (0, 0)
    card_branch(monkeypatch)
    assert launched() == (2 * len(feed), 2 * len(feed))
