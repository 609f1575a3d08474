"""One process, one card: the program's ``make_train_step(cfg)`` step,
its state built from the harness's weights (``init_state(params=...)``)."""

from __future__ import annotations

from horovod_tpu_torch.models import transformer as ttr

from perfbench.drivers.port import Base


def init_world(rank: int, world: int, device, ports) -> None:
    if world != 1:
        raise ValueError("train_step runs one process")


def shutdown() -> None:
    pass


class Program(Base):
    def __init__(self, spec, params, device):
        super().__init__(spec, params, device)
        init_state, self._step = ttr.make_train_step(self.cfg, device=device)
        self.state = init_state(params=params)
        self.opt = self.state["opt"]

    def step(self, tokens):
        self.state, loss = self._step(self.state, {"tokens": tokens})
        return loss

    def close(self) -> None:
        super().close()
        self.state = None
