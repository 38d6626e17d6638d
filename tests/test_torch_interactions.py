"""The port's interaction primitives (``torecsys_tpu_torch/ops/interactions.py``)
against the JAX package's (``torecsys_tpu/ops/interactions.py``) on the
same float32 inputs drawn with numpy, rtol 1e-6 / atol 1e-6.

The inputs lie on a 1/8 grid, small enough that every product and partial
sum of these shapes is exact in float32: the two sides sum the same terms
in orders that differ, and only a wrong term, pair or layout can tell them
apart.  (On normal draws a sum of 64 unit-sized products differs between
the two by rounding alone, up to 2e-6 here.)"""

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
