"""What every driver shares: the program's config of a :class:`ModelSpec`
and the parts of a driver that do not depend on how it steps."""

from __future__ import annotations

import torch

from horovod_tpu_torch.models import moe as moe_lib
from horovod_tpu_torch.models import transformer as ttr

from perfbench.norms import leaf_norm
from perfbench.weights import DTYPES, flat


def port_config(spec) -> "ttr.TransformerConfig":
    """The program's ``TransformerConfig`` of the configuration file.
    The MoE layer's load-balancing coefficient is fixed in the program;
    the file has to state that value."""
    kw = dict(vocab_size=spec.vocab_size, d_model=spec.d_model,
              n_layers=spec.n_layers, n_heads=spec.n_heads,
              n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff,
              max_seq=spec.max_seq, rope_theta=spec.rope_theta,
              norm_eps=spec.norm_eps, dtype=DTYPES[spec.dtype])
    if spec.n_experts:
        fixed = moe_lib.MoEConfig().aux_loss_coef
        if spec.aux_coef != fixed:
            raise ValueError(f"router_aux_loss_coef {spec.aux_coef}: the "
                             f"program runs {fixed}")
        kw.update(n_experts=spec.n_experts, moe_top_k=spec.top_k)
    kw.update(spec.port)
    return ttr.TransformerConfig(**kw)


class Base:
    """A driver's program state: ``params`` (the harness's tree, which
    the program trains in place) and its optimizer ``opt``."""

    def __init__(self, spec, params, device):
        self.cfg = port_config(spec)
        self.params = params
        self.named = flat(params)
        self.device = device
        self.exposed: list = []

    def first_grad_norm(self, leaf: torch.Tensor) -> float:
        """The norm of the leaf's gradient as the optimizer got it at its
        first step, from its state after that step (``exp_avg / (1 -
        beta1)``); 0 where the optimizer holds no state for it."""
        state = self.opt.state.get(leaf, {})
        if "exp_avg" not in state:
            return 0.0
        beta1 = self.opt.param_groups[0]["betas"][0]
        return leaf_norm(state["exp_avg"]) / (1 - beta1)

    def close(self) -> None:
        self.opt.zero_grad(set_to_none=True)
        self.opt = None
        self.params = self.named = None
