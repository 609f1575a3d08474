"""Device ops of the port: the attention kernel and its autograd
(:mod:`horovod_tpu_torch.ops.flash_attention`) and the collectives over
a process group (:mod:`horovod_tpu_torch.ops.collectives`)."""
