"""Parallelism of the port: the process world and its mesh (dp, fsdp,
sp, tp), the model's differentiable collectives, and attention
selection with the sequence-parallel bodies."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    build_mesh,
    data_parallel_mesh,
    init_process_group,
    replica_group,
    sp_group,
    tp_group,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    local_attention,
    make_sp_attention,
    ring_flash_attention,
    ring_self_attention,
    sequence_sharded_attention,
    ulysses_attention,
)
