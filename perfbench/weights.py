"""The model's weights, made from the seed on the device.

One ``torch.randn`` call a leaf, in the dtype the leaf is trained in,
from one ``torch.Generator`` on the device, in a fixed order; so the
same seed on the same kind of device gives the same weights, and
:func:`iter_leaves` can make them again one leaf at a time (the
correctness check reads each leaf's change against its start without
holding a second copy). The tree has the layout both the program and
the reference take: ``embed [V, D]``, ``layers`` with every per-layer
leaf stacked on a leading ``L`` dim (an MoE layer's block under
``layers["moe"]``), ``final_norm [D]``, ``lm_head [D, V]``; every matrix
applied as ``x @ W``. Matrices are ``normal · fan_in^-0.5``, norms 1; an
MoE router is float32 (as the program keeps it)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from perfbench.cell import ModelSpec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# (name, shape, fan_in or None for a norm, float32 whatever the model's
# dtype)
Leaf = Tuple[str, Tuple[int, ...], object, bool]


def leaves(spec: ModelSpec) -> List[Leaf]:
    """Every leaf, in the order the generator draws them."""
    L, D, F, V = spec.n_layers, spec.d_model, spec.d_ff, spec.vocab_size
    H, Hkv, Dh, E = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.n_experts
    out = [("embed", (V, D), D, False),
           ("layers.attn_norm", (L, D), None, False),
           ("layers.wq", (L, D, H * Dh), D, False),
           ("layers.wk", (L, D, Hkv * Dh), D, False),
           ("layers.wv", (L, D, Hkv * Dh), D, False),
           ("layers.wo", (L, H * Dh, D), H * Dh, False),
           ("layers.mlp_norm", (L, D), None, False)]
    if E:
        out += [("layers.moe.router", (L, D, E), D, True),
                ("layers.moe.w_gate", (L, E, D, F), D, False),
                ("layers.moe.w_up", (L, E, D, F), D, False),
                ("layers.moe.w_down", (L, E, F, D), F, False)]
    else:
        out += [("layers.w_gate", (L, D, F), D, False),
                ("layers.w_up", (L, D, F), D, False),
                ("layers.w_down", (L, F, D), F, False)]
    out += [("final_norm", (D,), None, False), ("lm_head", (D, V), D, False)]
    return out


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed % 2**63)


def iter_leaves(spec: ModelSpec, seed: int, device
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every leaf, made from ``seed`` one after
    the other."""
    gen = generator(seed, device)
    dtype = DTYPES[spec.dtype]
    for name, shape, fan_in, f32 in leaves(spec):
        dt = torch.float32 if f32 else dtype
        if fan_in is None:
            yield name, torch.ones(shape, dtype=dt, device=device)
            continue
        w = torch.randn(shape, generator=gen, dtype=dt, device=device)
        yield name, w.mul_(fan_in ** -0.5)


def to_tree(named) -> Dict[str, object]:
    """The nested tree of ``(dotted name, tensor)`` pairs."""
    tree: Dict[str, object] = {}
    for name, t in named:
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flat(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """The ``(dotted name, tensor)`` pairs of a nested tree, in
    :func:`leaves`' order where the names are its own."""
    out = []
    for k, v in tree.items():
        out += flat(v, f"{prefix}{k}.") if isinstance(v, dict) \
            else [(f"{prefix}{k}", v)]
    return out


def make_params(spec: ModelSpec, seed: int, device) -> Dict[str, object]:
    """The whole tree from ``seed``."""
    return to_tree(iter_leaves(spec, seed, device))
