"""The layer attribution on a CPU profile of the tiny MoE step (each op's
own host time stands in for kernels there): each layer finds its own
ops, forward and backward, and no other layer's; the wrappers go away
after the traced steps."""

import torch

from horovod_tpu_torch.models import moe as moe_lib
from horovod_tpu_torch.ops import flash_attention as fa
from perfbench import trace as tracing
from perfbench import weights
from perfbench.drivers import train_step
from perfbench.tests.test_perfbench_reference import MOE

CALLS = {"attention": ["horovod_tpu_torch.ops.flash_attention:flash_attention"],
         "moe": ["horovod_tpu_torch.models.moe:moe_ffn"]}


def _profile():
    params = weights.make_params(MOE, 1, torch.device("cpu"))
    prog = train_step.Program(MOE, params, torch.device("cpu"))
    tokens = torch.randint(0, MOE.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(2))
    prog.step(tokens)
    return tracing.profile_steps(lambda: prog.step(tokens), 1, lambda: None,
                                 torch.device("cpu"), CALLS)


def test_attribution_finds_each_layer_forward_and_backward():
    orig = (fa.flash_attention, moe_lib.moe_ffn)
    tr = _profile()
    assert (fa.flash_attention, moe_lib.moe_ffn) == orig
    assert not tr.on_device
    attn, moe = tr.layer_seconds("attention"), tr.layer_seconds("moe")
    opt = tr.range_seconds("Optimizer.step#")
    assert attn > 0 and moe > 0 and opt > 0
    span = tr.span_seconds()
    assert attn + moe + opt < span[1] - span[0]

    def names(key):
        forward = tr._under(lambda e: e.name == tracing.LAYER + key)
        return {owner.name for owner, _ in tr.items if id(owner) in forward}

    # The plain flash forward's softmax is attention's, the projections
    # (transformer.py's mm) are not; the router's sort and the expert
    # bmm are the MoE layer's.
    attn_ops, moe_ops = names("attention"), names("moe")
    assert "aten::exp" in attn_ops
    assert "aten::mm" not in attn_ops and "aten::sort" not in attn_ops
    assert {"aten::sort", "aten::bmm"} <= moe_ops
    # The backward, found by sequence number, adds to each layer.
    forward_only = tr._seconds(tr._under(
        lambda e: e.name == tracing.LAYER + "attention"))
    assert attn > forward_only


def test_busy_is_the_union_of_intervals():
    assert tracing.busy_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert tracing.merge([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
