"""The initial weights, made from the seed on the device.

A weight spec is ``{name: (shape, init)}`` with ``init`` one of:

* ``("table", std)``: a logical ``(V, E)`` embedding table, N(0, std²),
  drawn in blocks of :data:`TABLE_BLOCK_ROWS` rows, each from its own
  generator, so that any block can be made again alone (:func:`table_block`)
  without holding a second table;
* ``("fan_in",)``: N(0, 1 / fan_in), ``fan_in`` the product of the shape
  after its first axis (a ``(out, in)`` weight, a CIN's ``(H, H', N)``
  filters);
* ``("zeros",)`` or ``("ones",)``.

Every tensor is float32, drawn by a ``torch.Generator`` on ``device``; the
other tensors than the tables come from one generator, in the spec's order.
The same seed gives the same weights on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

TABLE_BLOCK_ROWS = 1 << 21
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed of the run's ``seed`` and a stream number."""
    return (seed * 1_000_003 + stream * _MIX) & _MASK


def table_block(seed: int, table_index: int, block: int, rows: int, embed: int, std: float,
                device) -> torch.Tensor:
    """Rows ``[block * TABLE_BLOCK_ROWS, ...)`` of the ``table_index``-th table
    of the spec, ``rows`` rows in all."""
    lo = block * TABLE_BLOCK_ROWS
    n = min(TABLE_BLOCK_ROWS, rows - lo)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1 + table_index * 4096
                                                                  + block))
    return torch.empty((n, embed), dtype=torch.float32, device=device).normal_(
        0.0, std, generator=gen)


def table_blocks(seed: int, table_index: int, rows: int, embed: int, std: float,
                 device) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(first row, block)`` of each block of a table, in order."""
    for block in range(-(-rows // TABLE_BLOCK_ROWS)):
        yield block * TABLE_BLOCK_ROWS, table_block(seed, table_index, block, rows, embed, std,
                                                    device)


def tables(spec: Dict) -> Dict[str, int]:
    """``{name: table index}`` of the spec's tables, in order."""
    names = [n for n, (_, init) in spec.items() if init[0] == "table"]
    return {n: i for i, n in enumerate(names)}


def initial_blocks(spec: Dict, name: str, seed: int, device):
    """A callable yielding the ``(first row, block)`` blocks of the table
    ``name`` of ``spec`` from ``seed``, in order."""
    (rows, embed), (_, std) = spec[name]
    index = tables(spec)[name]
    return lambda: table_blocks(seed, index, rows, embed, std, device)


def make(spec: Dict, seed: int, device, with_tables: bool = True) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec`` (the tables only where ``with_tables``)."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    index = tables(spec)
    for name, (shape, init) in spec.items():
        kind = init[0]
        if kind == "table":
            if with_tables:
                rows, embed = shape
                t = torch.empty(shape, dtype=torch.float32, device=device)
                for lo, block in table_blocks(seed, index[name], rows, embed, init[1], device):
                    t[lo:lo + block.shape[0]].copy_(block)
                    del block
                out[name] = t
            continue
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if kind == "fan_in":
            t.normal_(0.0, 1.0 / math.sqrt(math.prod(shape[1:])), generator=gen)
        elif kind == "zeros":
            t.zero_()
        elif kind == "ones":
            t.fill_(1.0)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = t
    return out


__all__ = ["TABLE_BLOCK_ROWS", "initial_blocks", "make", "stream_seed", "table_block",
           "table_blocks", "tables"]
