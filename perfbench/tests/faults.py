"""Faults planted in the program underneath a run, for the test that
sees ``correct`` come out false (a worker process plants the one its
``PERFBENCH_FAULT`` names). Each breaks the timed path as a later change
could:

* ``unchanged``: the optimizer's step does nothing, so each step returns
  its state unchanged;
* ``half_batch``: the loss takes the first half of the rows, the mean
  over them;
* ``no_exchange``: the hook optimizer launches no allreduce and keeps
  each rank's own gradient;
* ``loss_altered``: the loss the step returns is 1 % high (its gradient
  unchanged).
"""

import torch

FAULTS = ("unchanged", "half_batch", "no_exchange", "loss_altered")


class _NoExchange:
    """Stands in for ``horovod_tpu_torch.api`` in the hook optimizer:
    an allreduce returns its input, and nothing crosses to another rank."""

    def __init__(self, api):
        self._api = api

    def __getattr__(self, name):
        return getattr(self._api, name)

    @staticmethod
    def allreduce_async(tensor, **kw):
        return ("local", tensor.clone())

    def synchronize(self, handle):
        if isinstance(handle, tuple) and handle[0] == "local":
            return handle[1]
        return self._api.synchronize(handle)


def plant(name: str, patch=setattr) -> None:
    """Plant fault ``name``; ``patch(obj, attr, value)`` sets each
    attribute (a test passes ``monkeypatch.setattr`` to undo them)."""
    from horovod_tpu_torch.models import transformer as ttr
    if name == "unchanged":
        patch(torch.optim.AdamW, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        orig = ttr.lm_loss

        def half(params, batch, cfg, mesh=None):
            t = batch["tokens"]
            return orig(params, {"tokens": t[:max(1, t.shape[0] // 2)]},
                        cfg, mesh)
        patch(ttr, "lm_loss", half)
    elif name == "no_exchange":
        from horovod_tpu_torch.torch import optimizer
        patch(optimizer, "api", _NoExchange(optimizer.api))
    elif name == "loss_altered":
        orig = ttr.lm_loss

        def altered(params, batch, cfg, mesh=None):
            loss = orig(params, batch, cfg, mesh)
            return loss + 0.01 * loss.detach()
        patch(ttr, "lm_loss", altered)
    else:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
