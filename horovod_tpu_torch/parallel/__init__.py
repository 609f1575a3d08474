"""Parallelism of the port: the process world and its data-parallel
mesh, and attention selection."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    build_mesh,
    data_parallel_mesh,
    init_process_group,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    local_attention,
    make_sp_attention,
)
