"""Norms of large leaves without a float32 copy of the whole leaf."""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 26


def leaf_norm(x: torch.Tensor) -> float:
    """Euclidean norm of ``x``: float64 sums over float32 chunks."""
    flat = x.detach().reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), CHUNK):
        c = flat[i:i + CHUNK].double()
        total += float(torch.dot(c, c))
    return math.sqrt(total)


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """``leaf_norm(a - b)``, the difference taken chunk by chunk."""
    fa, fb = a.detach().reshape(-1), b.detach().reshape(-1)
    total = 0.0
    for i in range(0, fa.numel(), CHUNK):
        c = fa[i:i + CHUNK].double() - fb[i:i + CHUNK].double()
        total += float(torch.dot(c, c))
    return math.sqrt(total)
