"""One process a card, data parallel through Horovod's hook-based
``DistributedOptimizer`` on the program's eager plane, as a Horovod user
writes the loop: ``hvd.init()``, rank 0's parameters broadcast, then
each step ``zero_grad``, ``lm_loss``, ``backward``, ``synchronize`` and
``step`` under ``skip_synchronize``. CUDA events on the training stream
mark the end of ``backward()`` and of ``synchronize()``: the exchange
the backward did not hide."""

from __future__ import annotations

import os

import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import transformer as ttr

from perfbench.drivers.port import Base


def init_world(rank: int, world: int, device, ports) -> None:
    """``hvd.init()`` as rank ``rank`` of ``world`` processes on one
    host, with the environment the launcher gives a rank; the native
    core keeps off ``/dev/shm``."""
    env = dict(HOROVOD_RANK=rank, HOROVOD_SIZE=world,
               HOROVOD_LOCAL_RANK=rank, HOROVOD_LOCAL_SIZE=world,
               HOROVOD_CROSS_RANK=0, HOROVOD_CROSS_SIZE=1,
               HOROVOD_SHM_DISABLE=1)
    if world > 1:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=ports[0],
                   HOROVOD_CONTROLLER_ADDR=f"127.0.0.1:{ports[1]}")
    os.environ.update({k: str(v) for k, v in env.items()})
    hvd.init(None if device.type == "cuda" else device.type)


def shutdown() -> None:
    hvd.shutdown()


class Program(Base):
    def __init__(self, spec, params, device):
        super().__init__(spec, params, device)
        for _, p in self.named:
            p.requires_grad_(True)
        hvd.broadcast_parameters(self.named, root_rank=0)
        self.opt = hvd.DistributedOptimizer(
            ttr.default_optimizer([p for _, p in self.named]),
            named_parameters=self.named)
        self.cuda = device.type == "cuda"

    def _event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def step(self, tokens):
        opt = self.opt
        opt.zero_grad(set_to_none=True)
        loss = ttr.lm_loss(self.params, {"tokens": tokens}, self.cfg)
        loss.backward()
        end_backward = self._event()
        opt.synchronize()
        end_sync = self._event()
        with opt.skip_synchronize():
            opt.step()
        self.exposed.append((end_backward, end_sync))
        return loss.detach()

    def exposed_ms(self, steps):
        """Exposed exchange ms of each of ``steps`` (the recorded steps'
        indices); None off the card. Call after the device is idle."""
        if not self.cuda:
            return None
        return [self.exposed[i][0].elapsed_time(self.exposed[i][1])
                for i in steps]
