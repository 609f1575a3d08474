"""Continuous-batching inference serving for the port's transformer, on
one device or over a tp/ep mesh (``ServeEngine(mesh=...)``, one process
a card), and the fleet above it — the counterpart of
:mod:`horovod_tpu.serve`.

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

Above one engine, :class:`ServeRouter` (:mod:`~horovod_tpu_torch.serve.
router`) runs a fleet: replicas behind a cache-affinity admission router
with prefill/decode pools, deadline-class shedding and failover. A
replica is an engine in the router's process or a worker process
(:mod:`~horovod_tpu_torch.serve.worker`, ``python -m
horovod_tpu_torch.serve.worker``) behind the RPC plane
(:mod:`~horovod_tpu_torch.serve.rpc`, the reference's framing), and KV
pages move worker to worker (:mod:`~horovod_tpu_torch.serve.migrate`)::

    router = serve.ServeRouter(cfg, params, serve.RouterConfig(
        n_replicas=2), serve.ServeConfig(max_batch=8))
    print(router.generate([prompt_tokens], 32))

    workers = [serve.spawn_worker() for _ in range(2)]   # on the card
    fleet = serve.ServeRouter(cfg, None, serve.RouterConfig(n_replicas=2),
                              serve.ServeConfig(max_batch=8),
                              workers=workers, worker_seed=0)

On a tp/ep mesh the fleet keeps the engine's rule: one process a card,
and every rank runs the same ``ServeRouter(..., mesh=mesh)`` over its
shards, submitting the same requests in the same order; every replica is
a ``ServeEngine(mesh=)`` over that mesh, and the router reads mesh rank
0's clock::

    shards = shard_params(params, cfg, mesh, serving=True)
    router = serve.ServeRouter(cfg, shards, serve.RouterConfig(
        n_replicas=2), serve.ServeConfig(max_batch=8), mesh=mesh)

Worker replicas join a mesh fleet through mesh rank 0, which holds each
worker's connection; every other rank passes a placeholder and mirrors
rank 0's calls::

    worker = (serve.spawn_worker() if dist.get_rank() == 0
              else serve.MirrorHandle())
    router.add_remote_replica(worker)

A monolithic prefill attends through the Hopper flash kernel
(``csrc/flash_fwd.cu``), in every replica; the paged attention of the
other programs is torch ops, as it is XLA outside any Pallas kernel in
the reference. :mod:`~horovod_tpu_torch.serve.trace_merge` merges a
fleet's trace files onto one timebase.
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
    pool_kv_heads,
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
from horovod_tpu_torch.serve.router import (  # noqa: F401
    FleetMetrics,
    FleetSaturated,
    RouterConfig,
    ServeRouter,
)
from horovod_tpu_torch.serve.rpc import (  # noqa: F401
    RPC_PROTOCOL_VERSION,
    LockstepConn,
    MirrorHandle,
    RemoteReplica,
    RpcConn,
    RpcConnectionError,
    RpcError,
    RpcProtocolError,
    WorkerHandle,
    connect_worker,
    spawn_worker,
)
from horovod_tpu_torch.serve.bench import (  # noqa: F401
    make_multi_tenant_trace,
    make_shared_prefix_trace,
    make_trace,
    run_prefix_benchmark,
    run_router_benchmark,
    run_serving_benchmark,
    run_spec_benchmark,
)
