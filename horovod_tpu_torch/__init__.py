"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu`` for
NVIDIA Hopper (H100).

The JAX package ``horovod_tpu`` is the reference; this package mirrors
its layout (``models/transformer.py``, ``ops/flash_attention.py``,
``ops/collectives.py``, ``parallel/``, ``common/``, ``compression.py``,
``functions.py``) so each ported function sits where its counterpart
does; ``binding.py`` is the counterpart of the JAX framework binding
(``horovod_tpu/jax/__init__.py``). It imports ``torch`` and numpy only —
never JAX, optax, flax or anything under ``horovod_tpu``.

Data parallelism is one process per GPU over NCCL
(:func:`horovod_tpu_torch.parallel.init_process_group`); the train step
takes a data-parallel mesh (``make_train_step(..., mesh=...)``).

Every TPU (Pallas) kernel on a ported path is a hand-written CUDA C++
kernel for ``sm_90a`` under ``csrc/``, built at first use
(:mod:`horovod_tpu_torch.ops._kernels`). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no CUDA device and no
explicit CPU request they raise rather than fall back.
"""

from horovod_tpu_torch.device import resolve_device  # noqa: F401
