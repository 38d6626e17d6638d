"""Tensor-level operations: embedding lookup, interactions, sparse updates
and the hand-written kernels under ``ops.kernels``."""
