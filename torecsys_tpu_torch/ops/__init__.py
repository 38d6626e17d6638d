"""Tensor-level operations: embedding lookup, interactions, sparse updates
and the hand-written kernels under ``ops.kernels``."""

from torecsys_tpu_torch.ops.embedding import (
    embedding_lookup,
    fused_offset_lookup,
    pack_factor,
    pack_table,
    packed_lookup,
    packed_shape,
    unpack_table,
)
from torecsys_tpu_torch.ops.interactions import (
    afm_pairwise_products,
    cin_interaction,
    cross_layer,
    ffm_pairwise_interaction,
    fm_pairwise_interaction,
    inner_product_pairs,
    outer_product_pairs,
)

__all__ = ["afm_pairwise_products", "cin_interaction", "cross_layer", "embedding_lookup",
           "ffm_pairwise_interaction", "fm_pairwise_interaction", "fused_offset_lookup",
           "inner_product_pairs", "outer_product_pairs", "pack_factor", "pack_table",
           "packed_lookup", "packed_shape", "unpack_table"]
