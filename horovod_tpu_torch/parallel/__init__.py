"""Parallelism of the port: the process world and its mesh (dp, fsdp,
pp, sp, tp, ep), the model's differentiable collectives, attention
selection with the sequence-parallel bodies, and the pipeline (GPipe
and 1F1B) over pp."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    build_mesh,
    data_parallel_mesh,
    ep_group,
    init_process_group,
    pp_group,
    replica_group,
    sp_group,
    tp_group,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pp_train_step,
    make_pp_train_step_1f1b,
    pipeline_apply,
    pp_param_specs,
    pp_reshape_layers,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    local_attention,
    make_sp_attention,
    ring_flash_attention,
    ring_self_attention,
    sequence_sharded_attention,
    ulysses_attention,
)
