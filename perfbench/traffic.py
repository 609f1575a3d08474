"""The general generator of training traffic: token batches from a
traffic file's parameters and the seed.

Step ``i`` of the run trains the global batch ``i``: ``gpus ·
rows_per_gpu`` rows of ``seq + 1`` token ids (inputs and the shifted
targets), drawn ``uniform`` over the vocabulary from a generator seeded
apart from the weights'. GPU ``r`` trains rows ``[r · rows_per_gpu,
(r + 1) · rows_per_gpu)``. ``pool_steps`` batches are drawn on the
device ahead of the window; past them the pool is reused in turn. Every
seed draws the same sizes: the seed changes the ids, not the work."""

from __future__ import annotations

import torch

from perfbench.cell import Traffic

# Keeps the token stream's generator apart from the weights'.
TOKEN_SEED_OFFSET = 0x5EED_70CE


def token_seed(seed: int) -> int:
    return (seed + TOKEN_SEED_OFFSET) % 2**63


class TokenStream:
    """GPU ``rank``'s rows of every step's batch."""

    def __init__(self, traffic: Traffic, vocab: int, seed: int, rank: int,
                 device, steps: int = 0):
        if traffic.token_ids != "uniform":
            raise ValueError(f"token_ids {traffic.token_ids!r}: only "
                             f"'uniform' is drawn")
        n = steps or traffic.pool_steps
        gen = torch.Generator(device).manual_seed(token_seed(seed))
        pool = torch.randint(0, vocab, (n, traffic.global_rows,
                                        traffic.seq + 1),
                             generator=gen, device=device)
        b = traffic.rows_per_gpu
        self.rows = pool[:, rank * b:(rank + 1) * b].clone()
        self.n = n

    def batch(self, step: int) -> torch.Tensor:
        """``[rows_per_gpu, seq + 1]`` token ids of step ``step``."""
        return self.rows[step % self.n]

