"""Parallelism of the port: for now, single-device attention selection."""

from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    local_attention,
    make_sp_attention,
)
