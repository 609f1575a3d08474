"""Entry point of the port, the twin of the repository's
``__graft_entry__.entry()``: the flagship decoder's forward and an
example input.

    fwd, (params, tokens) = entry()        # on cuda; entry("cpu") on CPU
    logits = fwd(params, tokens)           # [4, 512, 8192] bf16

The multi-chip dry run (``__graft_entry__.dryrun_multichip``) is
ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  forward, init_params)


def _cfg(tiny: bool = False) -> TransformerConfig:
    if tiny:
        return TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=256, max_seq=256, dtype=torch.bfloat16)
    return TransformerConfig(
        vocab_size=8192, d_model=512, n_layers=8, n_heads=16, n_kv_heads=8,
        d_ff=1376, max_seq=1024, dtype=torch.bfloat16)


def entry(device=None):
    """``(fwd, (params, tokens))``: the forward of the flagship config
    with random parameters from seed 0 and zero tokens ``[4, 512]``."""
    device = resolve_device(device)
    cfg = _cfg()
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device)
    tokens = torch.zeros((4, 512), dtype=torch.int32, device=device)

    def fwd(params, tokens):
        return forward(params, tokens, cfg)

    return fwd, (params, tokens)
