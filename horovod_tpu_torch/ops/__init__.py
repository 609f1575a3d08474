"""Device ops of the port: the attention kernel and its autograd
(:mod:`horovod_tpu_torch.ops.flash_attention`)."""
