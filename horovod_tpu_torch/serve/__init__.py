"""Continuous-batching inference serving for the port's transformer, on
one device — the counterpart of :mod:`horovod_tpu.serve` without its
fleet plane (router, RPC, workers: ROADMAP item 14) and without a mesh
(item 17).

An iteration-level scheduler (:class:`ServeEngine`) drives the prefill,
chunked-resume, decode, verify and inject programs
(:mod:`horovod_tpu_torch.serve.decode`) over a paged KV cache
(:mod:`horovod_tpu_torch.serve.kv_cache`), with prefix caching, chunked
prefill, speculative decoding (:mod:`horovod_tpu_torch.serve.speculative`)
and the handoff surface, and reports throughput and tail latency through
:mod:`horovod_tpu_torch.serve.metrics`::

    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params)
    from horovod_tpu_torch import serve

    cfg = TransformerConfig.llama3_8b()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    engine = serve.ServeEngine(cfg, params, serve.ServeConfig(max_batch=8))
    rid = engine.submit(prompt_tokens, max_new_tokens=32)
    engine.run_until_idle()
    print(engine.result(rid).tokens)

A monolithic prefill attends through the Hopper flash kernel
(``csrc/flash_fwd.cu``); the paged attention of the other programs is
torch ops, as it is XLA outside any Pallas kernel in the reference.
"""

from horovod_tpu_torch.serve.engine import (  # noqa: F401
    PrefillHandoff,
    QueueFull,
    RequestResult,
    ServeConfig,
    ServeEngine,
)
from horovod_tpu_torch.serve.kv_cache import (  # noqa: F401
    BlockAllocator,
    KVCache,
    NULL_BLOCK,
    OutOfBlocks,
    block_hash,
    hash_chain,
    init_kv_cache,
    pick_bucket,
)
from horovod_tpu_torch.serve.decode import make_serve_fns  # noqa: F401
from horovod_tpu_torch.serve.metrics import (  # noqa: F401
    ServeMetrics,
    percentile,
)
from horovod_tpu_torch.serve.speculative import (  # noqa: F401
    DraftConfig,
    SpecDecoder,
    accept_greedy,
    make_draft_target_params,
)
from horovod_tpu_torch.serve.bench import (  # noqa: F401
    make_multi_tenant_trace,
    make_shared_prefix_trace,
    make_trace,
    run_prefix_benchmark,
    run_serving_benchmark,
    run_spec_benchmark,
)
