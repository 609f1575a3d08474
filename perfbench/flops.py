"""Every operation and byte count the benchmark divides by, from the
cell's shapes alone (never from what the program did).

Counts are per training step of one GPU (its ``rows`` rows of ``seq``
tokens), forward and backward together; a multiply-add is 2 FLOPs.
"""

from __future__ import annotations

from typing import Dict

from perfbench.cell import ModelSpec

BF16_BYTES = 2
F32_BYTES = 4


def param_counts(spec: ModelSpec) -> Dict[str, int]:
    """``total``: every parameter; ``matrix``: the matrices (embedding
    table and lm_head included); ``active_matrix``: the matrices one
    token meets, lm_head counted and the embedding table not (a lookup
    is no product), ``top_k`` of the ``E`` experts of an MoE layer, its
    router counted."""
    D, F, V, L = spec.d_model, spec.d_ff, spec.vocab_size, spec.n_layers
    attn = D * spec.n_heads * spec.head_dim * 2 \
        + D * spec.n_kv_heads * spec.head_dim * 2
    ffn = 3 * D * F
    norms = 2 * D * L + D
    if spec.n_experts:
        router = D * spec.n_experts
        layer_matrix = attn + router + spec.n_experts * ffn
        layer_active = attn + router + spec.top_k * ffn
    else:
        layer_matrix = layer_active = attn + ffn
    matrix = L * layer_matrix + 2 * V * D
    return {"total": matrix + norms, "matrix": matrix,
            "active_matrix": L * layer_active + V * D}


def model_flops_per_token(spec: ModelSpec, seq: int) -> float:
    """Training FLOPs a token: ``6 ·`` the active matrix parameters plus
    causal attention's ``6 · n_layers · seq · d_model`` (the score and
    value products, forward and backward, over the half of the
    positions a causal token sees)."""
    return 6.0 * param_counts(spec)["active_matrix"] \
        + 6.0 * spec.n_layers * seq * spec.n_heads * spec.head_dim


def attention_work(spec: ModelSpec, rows: int, seq: int) -> Dict[str, float]:
    """Causal attention's forward and backward in one step, every layer:
    ``7 · B · H · T² · Dh`` FLOPs (forward 4, backward 10 with the
    score recompute, halved by the mask), and the bytes of q, k, v, the
    output, its logsumexp and the output's gradient read once, and dq,
    dk, dv written once (bfloat16; the logsumexp float32)."""
    L, H, Hkv, Dh = spec.n_layers, spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = rows * seq * H * Dh * BF16_BYTES
    kv = rows * seq * Hkv * Dh * BF16_BYTES
    lse = rows * H * seq * F32_BYTES
    per_layer = (4 * q + 4 * kv + lse)   # q, out, dout, dq; k, v, dk, dv
    return {"flops": 7.0 * L * rows * H * seq * seq * Dh,
            "bytes": float(L * per_layer)}


def moe_work(spec: ModelSpec, rows: int, seq: int) -> Dict[str, float]:
    """The MoE layers' useful work in one step: ``18 · D · F`` FLOPs a
    kept claim (three products forward and twice that backward; ``top_k``
    claims a token, every one kept at the cell's capacity) plus the
    router's ``6 · D · E`` a token; bytes: every expert weight read and
    its gradient written, in bfloat16."""
    if not spec.n_experts:
        return {"flops": 0.0, "bytes": 0.0}
    D, F, E, L = spec.d_model, spec.d_ff, spec.n_experts, spec.n_layers
    tokens = rows * seq
    flops = L * (18.0 * D * F * tokens * spec.top_k + 6.0 * D * E * tokens)
    return {"flops": flops, "bytes": float(L * E * 3 * D * F * BF16_BYTES * 2)}


def optimizer_bytes(spec: ModelSpec) -> float:
    """AdamW's least traffic a step: 7 tensors of each parameter's dtype
    (read p, g, m, v; write p, m, v)."""
    counts = param_counts(spec)
    router = spec.n_layers * spec.d_model * spec.n_experts
    item = F32_BYTES if spec.dtype == "float32" else BF16_BYTES
    return 7.0 * ((counts["total"] - router) * item + router * F32_BYTES)


def least_seconds(work: Dict[str, float], peak_flops: float,
                  peak_bytes_per_s: float) -> float:
    """The roofline's least time: operations at the peak rate or bytes
    at the peak bandwidth, whichever takes longer."""
    return max(work["flops"] / peak_flops, work["bytes"] / peak_bytes_per_s)

