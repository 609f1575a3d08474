"""Speculative decoding: a draft transformer proposes, the target
verifies — the counterpart of :mod:`horovod_tpu.serve.speculative`.

At small batch each decode step reads all the target's weights to emit
one token a sequence. A small draft proposing ``k`` tokens lets the
target verify all k in one chunked step, so the weights are read once
per k tokens. Under greedy decoding the accepted stream equals plain
decode's, because verification compares the target's own argmax at
every proposed position and keeps exactly the longest matching prefix.

The draft is an ordinary transformer behind the same programs
(:func:`~horovod_tpu_torch.serve.decode.make_serve_fns`, memoized), with
its own paged KV pool in the target's block geometry and one batched
draft decode call per proposed token. Its params are
``init_params(draft.model_cfg, torch.Generator(device).manual_seed(
draft.seed))`` — the port's own generator, so a draft from a seed is
the same on every engine of one device type, though not the JAX
package's ``PRNGKey(seed)`` draft.

**Verify** runs ``[last_token, d1..d_{k-1}]`` through the ``verify``
program over the sequence's reserved pages and emits the target's
argmax at every chunk position. Acceptance is host-side and exact:
``d_{j+1}`` is accepted iff it equals the target's argmax after
``d_j``; the first mismatch contributes the target's own token. When
all k match the round emits the k draft tokens and no bonus token, so
the draft's KV cursor stays in lockstep with the target's.

**Rollback is a cursor rewind**: verify wrote K/V for every chunk
position, accepted or not; rejected positions stay past the sequence's
length cursor, never read (attention masks by position) and overwritten
before the cursor reaches them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.profiler import record_function

from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.models.transformer import init_params
from horovod_tpu_torch.serve.kv_cache import BlockAllocator, pick_bucket


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """The ``ServeConfig.draft`` sub-config: which draft transformer to
    run and how to build its params. The draft inherits the engine's
    block geometry; only the model differs."""

    model_cfg: Any               # TransformerConfig of the draft model
    # Draft params are init_params(model_cfg, a generator on the
    # engine's device seeded with `seed`).
    seed: int = 0
    cache_dtype: Any = None      # draft KV dtype (default: draft dtype)


def accept_greedy(proposals: Sequence[int],
                  verified: Sequence[int]) -> Tuple[int, List[int]]:
    """The greedy acceptance rule: ``proposals`` are the draft's k tokens
    ``d1..dk``, ``verified`` the target's argmax after each of ``[t0,
    d1..d_{k-1}]``. Returns ``(n_accepted, emitted)``: the longest
    matching draft prefix plus, on the first mismatch, the target's own
    token. All-match emits exactly the k draft tokens (no bonus)."""
    k = len(proposals)
    assert len(verified) == k
    emitted: List[int] = []
    for j in range(k):
        if proposals[j] == verified[j]:
            emitted.append(proposals[j])
        else:
            emitted.append(verified[j])
            return j, emitted
    return k, emitted


@dataclasses.dataclass
class _DraftSeq:
    """Draft-side state of one active sequence: its mirror reservation
    in the draft pool. The KV cursor is the engine sequence's
    ``n_cached`` (the lockstep the acceptance rule keeps)."""

    blocks: List[int]
    table: torch.Tensor          # [table_width] int32, draft pool ids


class SpecDecoder:
    """The speculative side-car of one
    :class:`~horovod_tpu_torch.serve.engine.ServeEngine`: draft params,
    a paged KV pool and the propose/verify/accept round that replaces
    ``_decode_once`` when ``ServeConfig.draft`` is set. It owns no
    scheduling: admission, prefill, retirement and handoff run as
    before."""

    def __init__(self, engine):
        from horovod_tpu_torch.serve import decode as decode_lib
        from horovod_tpu_torch.serve.kv_cache import init_kv_cache

        self._eng = engine
        cfg = engine.cfg
        draft: DraftConfig = cfg.draft
        dm = draft.model_cfg
        tm = engine.model_cfg
        if dm.vocab_size != tm.vocab_size:
            raise ValueError(
                f"draft vocab {dm.vocab_size} != target vocab "
                f"{tm.vocab_size} — proposals are token ids and must "
                "share one vocabulary")
        self.k = cfg.spec_k
        device = engine.device
        self._params = init_params(
            dm, torch.Generator(device).manual_seed(draft.seed),
            device=device)
        bs = cfg.block_size
        self._bs = bs
        self._width = engine._table_width
        # Sized for the draft's own worst case: it holds only active
        # sequences' full private reservations (no content index), at
        # most max_batch x table_width blocks, whatever prefix sharing
        # let the target admit.
        n_blocks = cfg.max_batch * self._width + 1
        self.allocator = BlockAllocator(n_blocks, bs)
        self.cache = init_kv_cache(dm, n_blocks, bs,
                                   dtype=draft.cache_dtype, device=device)
        (self._prefill_fn, self._resume_fn, self._decode_fn, _inject,
         _verify) = decode_lib.make_serve_fns(
             dm, block_size=bs, table_width=self._width, device=device,
             compression=cfg.compression)
        self._seqs: Dict[int, _DraftSeq] = {}

    # -- per-sequence lifecycle ---------------------------------------

    def drop(self, rid: int) -> None:
        """Release the draft-side reservation of a retired, exported or
        migrated sequence (no-op for sequences the draft never saw)."""
        st = self._seqs.pop(rid, None)
        if st is not None:
            self.allocator.free(st.blocks)

    def _ensure(self, seq) -> _DraftSeq:
        """Draft-side catch-up for a sequence the draft has no state
        for (a fresh prefill, or a handoff injected mid-decode): reserve
        mirror blocks and prefill the draft's KV for every position the
        target has cached — ``(prompt + generated)[:n_cached]``, in
        block-aligned chunks through the engine's prefill buckets. The
        draft prefills the whole stream itself (the target's prefix
        cache may have skipped prompt work the draft never did)."""
        st = self._seqs.get(seq.rid)
        if st is not None:
            return st
        from horovod_tpu_torch.serve.engine import _ints

        need = self.allocator.blocks_for_tokens(
            len(seq.prompt) + seq.max_new)
        blocks = self.allocator.alloc(need)
        st = _DraftSeq(blocks=blocks, table=_ints(blocks, self._width))
        self._seqs[seq.rid] = st
        stream = (list(seq.prompt) + list(seq.generated))[:seq.n_cached]
        buckets = self._eng._prefill_buckets
        chunk_cap = max(buckets)
        off = 0
        while off < len(stream):
            chunk = min(len(stream) - off, chunk_cap)
            if off + chunk < len(stream):
                chunk -= chunk % self._bs   # non-final chunks stay
                #                             block-aligned
            toks = _ints(stream[off:off + chunk],
                         pick_bucket(chunk, buckets))
            kc, vc, _tok = self._resume_fn(
                self._params, self.cache.k, self.cache.v, toks, off,
                chunk, st.table)
            self.cache.k, self.cache.v = kc, vc
            off += chunk
        return st

    # -- the round ----------------------------------------------------

    def round(self) -> None:
        """One speculative iteration for the engine's active batch: k
        batched draft decode steps propose, one target verify step
        checks, host-side acceptance emits 1..k tokens a sequence and
        rewinds past rejected positions."""
        from horovod_tpu_torch.serve.engine import _ints

        eng = self._eng
        active = eng._active
        if not active:
            return
        n = len(active)
        bucket = pick_bucket(n, eng._batch_buckets)
        states = [self._ensure(s) for s in active]

        # -- propose: k draft decode steps, batched -------------------
        d_tables = torch.zeros((bucket, self._width), dtype=torch.int32)
        t_tables = torch.zeros((bucket, self._width), dtype=torch.int32)
        for i, (st, seq) in enumerate(zip(states, active)):
            d_tables[i] = st.table
            t_tables[i] = seq.table
        frontier = _ints([s.last_token for s in active], bucket)
        start = _ints([s.n_cached for s in active], bucket)
        positions = start.clone()
        proposals = torch.zeros((n, self.k), dtype=torch.int64)
        t0 = eng._clock()
        with record_function("serve:spec_draft"):
            for step in range(self.k):
                kc, vc, out = self._decode_fn(
                    self._params, self.cache.k, self.cache.v, frontier,
                    positions, d_tables)
                out = out.cpu()
                self.cache.k, self.cache.v = kc, vc
                proposals[:, step] = out[:n]
                frontier = out
                positions = positions + 1
        t1 = eng._clock()

        # -- verify: ONE chunked target step over reserved pages ------
        chunk = torch.zeros((bucket, self.k), dtype=torch.int32)
        for i, seq in enumerate(active):
            chunk[i, 0] = seq.last_token
            chunk[i, 1:] = proposals[i, :self.k - 1]
        with record_function("serve:spec_verify"):
            kc, vc, ver = eng._verify_fn(
                eng._params, eng.cache.k, eng.cache.v, chunk, start,
                t_tables)
            ver = ver.tolist()
        t2 = eng._clock()
        eng.cache.k, eng.cache.v = kc, vc

        # -- accept + cursor rollback, host-side ----------------------
        emitted_total = 0
        accepted_total = 0
        proposed_total = 0
        for i, seq in enumerate(active):
            n_acc, emitted = accept_greedy(proposals[i].tolist(), ver[i])
            # Plain decode stops at max_new and at the first eos.
            room = seq.max_new - len(seq.generated)
            emitted = emitted[:room]
            if eng.cfg.eos_id is not None and eng.cfg.eos_id in emitted:
                emitted = emitted[:emitted.index(eng.cfg.eos_id) + 1]
            n_acc = min(n_acc, len(emitted))
            # The accept rate's denominator counts the proposals the
            # target judged before the stream ended: the accepted prefix
            # and, if the round ended on an emitted mismatch, that one.
            proposed_total += n_acc + (1 if n_acc < len(emitted) else 0)
            seq.generated.extend(emitted)
            # The rollback: rejected chunk positions stay past the
            # cursor; table and pool untouched.
            seq.n_cached += len(emitted)
            emitted_total += len(emitted)
            accepted_total += n_acc
        eng.metrics.record_spec_round(
            t0, t1 - t0, t2 - t1, n, eng.cfg.max_batch,
            proposed=proposed_total, accepted=accepted_total,
            emitted=emitted_total,
            traces=[s.trace for s in active if s.trace])


# ---------------------------------------------------------------------------
# Bench/test rig: a target that agrees with its draft by construction
# ---------------------------------------------------------------------------

def make_draft_target_params(draft_cfg, n_layers: int, seed: int = 0,
                             extra_seed: int = 1, device=None):
    """Build ``(target_cfg, target_params)`` on ``device`` such that the
    target is ``n_layers`` deep but computes exactly the logits of the
    ``draft_cfg`` model built from ``seed``: the first
    ``draft_cfg.n_layers`` layers (and embed, final norm, lm head) are
    the draft's own params, and every extra layer's residual
    out-projections (``wo``, ``w_down``) are zero — a layer that adds
    nothing but costs its full matmuls. The draft agrees with the target
    at every position (accept rate 1.0), so a measured speedup isolates
    what speculation buys per accepted token. An engine configured with
    ``DraftConfig(draft_cfg, seed=seed)`` on the same device rebuilds
    the matching draft."""
    device = resolve_device(device)
    if n_layers <= draft_cfg.n_layers:
        raise ValueError(
            f"target n_layers {n_layers} must exceed the draft's "
            f"{draft_cfg.n_layers}")
    target_cfg = dataclasses.replace(draft_cfg, n_layers=n_layers)
    draft_params = init_params(
        draft_cfg, torch.Generator(device).manual_seed(seed), device=device)
    target_params = init_params(
        target_cfg, torch.Generator(device).manual_seed(extra_seed),
        device=device)
    Ld = draft_cfg.n_layers
    layers = {}
    for name, leaf in target_params["layers"].items():
        leaf[:Ld] = draft_params["layers"][name]
        if name in ("wo", "w_down"):
            leaf[Ld:] = 0
        layers[name] = leaf
    out = dict(target_params)
    out["layers"] = layers
    for name in ("embed", "final_norm", "lm_head"):
        out[name] = draft_params[name]
    return target_cfg, out
