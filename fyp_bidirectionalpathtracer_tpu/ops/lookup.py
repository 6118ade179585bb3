"""Small-table row lookup."""
from __future__ import annotations


def table_lookup(table, idx):
    """table [M, K], idx [...] int -> [..., K]: a plain gather, exact in
    every dtype (no matmul, so no reduced-precision path such as TF32)."""
    return table[idx]
