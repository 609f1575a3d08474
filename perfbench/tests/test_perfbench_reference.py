"""The reference against the program on tiny models, one step, dense
and MoE (this test imports both; the reference imports nothing of the
program); and the control, the reference with float8 products, well
outside what the program reads."""

import dataclasses

import pytest
import torch

from perfbench import compare, weights
from perfbench.cell import ModelSpec
from perfbench.drivers.port import port_config
from perfbench.reference import model as ref

DENSE = ModelSpec(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=128, max_seq=128, rope_theta=10000.0,
                  norm_eps=1e-5, dtype="float32",
                  port={"sp_attention": "flash", "remat": False})
MOE = dataclasses.replace(DENSE, n_experts=4, top_k=2, aux_coef=0.01,
                          capacity_factor=2.0,
                          port=dict(DENSE.port, moe_capacity_factor=2.0))


def _tokens(spec, seed, rows=2, seq=32):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, spec.vocab_size, (rows, seq + 1), generator=g)


@pytest.mark.parametrize("spec", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_loss_and_gradients_match_the_program(spec):
    from horovod_tpu_torch.models import transformer as ttr
    tokens = _tokens(spec, 5)
    named = list(weights.iter_leaves(spec, 3, "cpu"))
    prog = weights.to_tree((n, p.clone().requires_grad_(True))
                           for n, p in named)
    loss = ttr.lm_loss(prog, {"tokens": tokens}, port_config(spec))
    loss.backward()
    work = [p.clone().requires_grad_(True) for _, p in named]
    with ref.exact_matmuls():
        rloss = ref.loss_fn(weights.to_tree(zip([n for n, _ in named], work)),
                            tokens, spec)
        rgrads = torch.autograd.grad(rloss, work)
    loss, rloss = float(loss.detach()), float(rloss.detach())
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    for (name, p), g in zip(weights.flat(prog), rgrads):
        assert torch.allclose(p.grad, g, rtol=1e-4, atol=1e-6), name


def _readings(spec, seed, prec, rows=2):
    from perfbench.norms import diff_norm
    batches = [_tokens(spec, seed + i, rows) for i in range(3)]
    named = list(weights.iter_leaves(spec, seed, "cpu"))
    out = ref.train(named, batches, spec, prec)
    out["change"] = {n: diff_norm(p, p0) for (n, p), (_, p0) in zip(
        named, weights.iter_leaves(spec, seed, "cpu"))}
    return out


@pytest.mark.parametrize("spec", [DENSE, MOE], ids=["dense", "moe"])
def test_adamw_matches_torch(spec):
    """Three steps of the reference's AdamW against torch's on the same
    float32 gradients."""
    from horovod_tpu_torch.models import transformer as ttr
    named = list(weights.iter_leaves(spec, 4, "cpu"))
    ours = [p.clone() for _, p in named]
    theirs = [p.clone().requires_grad_(True) for _, p in named]
    opt_ref, opt = ref.AdamW(ours), ttr.default_optimizer(theirs)
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in ours]
        opt_ref.step(grads)
        for p, gr in zip(theirs, grads):
            p.grad = gr.clone()
        opt.step()
    for a, b in zip(ours, theirs):
        assert torch.allclose(a, b.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec", [DENSE, MOE], ids=["dense", "moe"])
def test_control_reads_far_from_the_reference(spec):
    """The control (the model computed in float8) held against the
    float32 reference: its gradient gap is well above the float32
    program's (which this size reads at about 1e-7), and it fails the
    cell's limits."""
    exact = _readings(spec, 11, ref.F32)
    control = _readings(spec, 11, ref.FP8)
    gaps = compare.gaps(control, exact)
    assert gaps["grad_gap"] > 1e-3
    from perfbench.cell import load_cell
    limits = load_cell("mixtral8x7b-l2-t2048").limits
    ok, _ = compare.judge(gaps, limits)
    assert not ok
