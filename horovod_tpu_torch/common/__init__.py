"""Process-level constants of the port: reduce ops and the launcher's
topology contract (copies of :mod:`horovod_tpu.common`'s JAX-free
modules, so the port imports nothing of the reference package)."""
