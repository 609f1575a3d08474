"""Speculative decoding in the port (``horovod_tpu_torch.serve.
speculative``) against the JAX package's, on the CPU, f32, the tiny
config with JAX's parameters (``params_from_jax``):

- the speculative engine's streams AND its proposal / acceptance counts
  equal the JAX speculative engine's, token for token and count for
  count, for the constructed pair of ``make_draft_target_params`` (a
  1-layer draft, a 2-layer target whose extra layer adds nothing) and
  for a disagreeing draft (the target's config from seed 1), with
  ``spec_k`` 3. The port builds a draft from a seed with its own
  generator, so the tests put JAX's draft params into the port's
  decoder (``engine._spec._params``) before the first submit;
- ``make_draft_target_params``' construction against JAX's on the same
  draft and extra params;
- the reference's own properties on the port
  (``tests/test_speculative.py``): the greedy acceptance rule, the
  config validation, streams equal to plain decode for agreeing and
  disagreeing drafts, the randomized rollback property with both
  allocators' integrity checked, eos, composition with the prefix cache,
  chunked prefill and mid-decode migration, the draft pool's sizing,
  and the metrics.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import init_transformer
from horovod_tpu.serve import ServeConfig as JaxServeConfig
from horovod_tpu.serve import ServeEngine as JaxServeEngine
from horovod_tpu.serve.speculative import DraftConfig as JaxDraftConfig
from horovod_tpu.serve.speculative import \
    make_draft_target_params as jax_make_pair

from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.serve import ServeConfig, ServeEngine
from horovod_tpu_torch.serve.speculative import (DraftConfig, accept_greedy,
                                                 make_draft_target_params)

KW = dict(max_batch=4, block_size=4, max_prompt=24, max_new_tokens=6,
          batch_buckets=(4,), prefill_buckets=(4, 8, 16, 24))
K = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prompts(n=6, rng_seed=21, prefix_len=12):
    rng = np.random.RandomState(rng_seed)
    prefix = rng.randint(1, 256, size=prefix_len).tolist()
    return [prefix + rng.randint(1, 256,
                                 size=int(rng.randint(2, 6))).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    jp = init_transformer(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, ttr.params_from_jax(_np(jp), device="cpu")


def _engine(model, draft_seed=None, **kw):
    """A port engine on the tiny model; ``draft_seed`` turns speculation
    on with a draft of the same config whose params are JAX's from that
    seed (seed 0: the target's own, all-accept)."""
    jcfg, _, tcfg, tp = model
    opts = dict(KW)
    opts.update(kw)
    if draft_seed is not None:
        opts.update(draft=DraftConfig(tcfg, seed=draft_seed), spec_k=K)
    eng = ServeEngine(tcfg, tp, ServeConfig(**opts), device="cpu")
    if draft_seed is not None:
        eng._spec._params = ttr.params_from_jax(_np(init_transformer(
            jcfg, jax.random.PRNGKey(draft_seed))), device="cpu")
    return eng


def _serve(engine, trace):
    rids = [engine.submit(p, n) for p, n in trace]
    engine.run_until_idle()
    return [list(engine.result(r).tokens) for r in rids]


def _counts(eng):
    m = eng.metrics
    return m.spec_rounds, m.spec_proposed, m.spec_accepted


# ---------------------------------------------------------------------------
# Against the JAX speculative engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The constructed pair in both packages: a 1-layer draft and a
    2-layer target from JAX's seeds; the port's target and draft params
    are JAX's."""
    jd = JaxConfig.tiny(n_layers=1, dtype=jnp.float32, remat=False)
    td = ttr.TransformerConfig.tiny(n_layers=1, dtype=torch.float32,
                                    remat=False)
    jt_cfg, jt = jax_make_pair(jd, n_layers=2, seed=0)
    return (jd, jt_cfg, jt, td, ttr.params_from_jax(_np(jt), device="cpu"),
            ttr.params_from_jax(_np(init_transformer(
                jd, jax.random.PRNGKey(0))), device="cpu"))


def test_constructed_pair_matches_jax_and_accepts_everything(pair):
    jd, jt_cfg, jt, td, tt, tdraft = pair
    trace = [(p, n) for p, n in zip(_prompts(5), (6, 4, 5, 6, 3))]
    jeng = JaxServeEngine(jt_cfg, jt, JaxServeConfig(
        **KW, draft=JaxDraftConfig(jd, seed=0), spec_k=K))
    want = _serve(jeng, trace)
    t_cfg = dataclasses.replace(td, n_layers=2)
    teng = ServeEngine(t_cfg, tt, ServeConfig(
        **KW, draft=DraftConfig(td, seed=0), spec_k=K), device="cpu")
    teng._spec._params = tdraft
    assert _serve(teng, trace) == want
    assert _counts(teng) == _counts(jeng)
    assert teng.metrics.spec_accepted == teng.metrics.spec_proposed > 0


def test_make_draft_target_params_construction(pair):
    """The port's construction on the CPU: the draft's layers first, the
    extra layers' wo/w_down zero, embed / final norm / lm head the
    draft's; the target's greedy streams equal the draft's."""
    _, _, _, td, _, _ = pair
    t_cfg, tp = make_draft_target_params(td, n_layers=3, seed=4,
                                         device="cpu")
    dp = ttr.init_params(td, torch.Generator().manual_seed(4), device="cpu")
    assert t_cfg.n_layers == 3
    for name, leaf in tp["layers"].items():
        assert torch.equal(leaf[:1], dp["layers"][name])
        if name in ("wo", "w_down"):
            assert not leaf[1:].any()
        else:
            assert leaf[1:].any()
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(tp[name], dp[name])
    trace = [(p, 5) for p in _prompts(3)]
    want = _serve(ServeEngine(td, dp, ServeConfig(**KW), device="cpu"),
                  trace)
    assert _serve(ServeEngine(t_cfg, tp, ServeConfig(**KW), device="cpu"),
                  trace) == want
    with pytest.raises(ValueError, match="exceed"):
        make_draft_target_params(td, n_layers=1, device="cpu")


@pytest.mark.parametrize("draft_seed", [0, 1])
def test_spec_streams_and_counts_equal_jax(model, draft_seed):
    jcfg, jp, _, _ = model
    trace = [(p, n) for p, n in zip(_prompts(6), (5, 6, 2, 5, 4, 6))]
    jeng = JaxServeEngine(jcfg, jp, JaxServeConfig(
        **KW, draft=JaxDraftConfig(jcfg, seed=draft_seed), spec_k=K))
    want = _serve(jeng, trace)
    eng = _engine(model, draft_seed=draft_seed)
    assert _serve(eng, trace) == want
    assert _counts(eng) == _counts(jeng)
    if draft_seed:
        assert eng.metrics.spec_accepted < eng.metrics.spec_proposed


# ---------------------------------------------------------------------------
# The reference's properties, on the port
# ---------------------------------------------------------------------------

def test_accept_greedy():
    assert accept_greedy([4, 5, 6], [4, 5, 6]) == (3, [4, 5, 6])
    assert accept_greedy([4, 9, 6], [4, 5, 6]) == (1, [4, 5])
    assert accept_greedy([9, 5, 6], [4, 5, 6]) == (0, [4])
    assert accept_greedy([7], [7]) == (1, [7])
    assert accept_greedy([7], [8]) == (0, [8])


def test_spec_config_validation(model):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(tcfg, tp, ServeConfig(**KW, draft=DraftConfig(tcfg)),
                    device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(tcfg, tp, ServeConfig(**KW, spec_k=4), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(tcfg, tp, ServeConfig(**KW, spec_k=2, draft=DraftConfig(
            ttr.TransformerConfig.tiny(vocab_size=128, dtype=torch.float32,
                                       remat=False))), device="cpu")


@pytest.mark.parametrize("draft_seed", [0, 1])
def test_spec_streams_equal_plain_decode(model, draft_seed):
    prompts = _prompts()
    ref = _engine(model).generate(prompts, 5)
    eng = _engine(model, draft_seed=draft_seed)
    assert eng.generate(prompts, 5) == ref
    m = eng.metrics
    if draft_seed:
        assert m.spec_accepted < m.spec_proposed
    else:
        assert m.spec_accepted == m.spec_proposed > 0
        assert m.snapshot()["spec_accept_rate"] == 1.0
        plain = _engine(model)
        plain.generate(prompts, 5)
        assert m.spec_rounds < plain.metrics.decode_steps
    assert eng.allocator.n_used == eng._spec.allocator.n_used == 0


def test_spec_rollback_randomized_property(model):
    plain = _engine(model)
    engines = {0: _engine(model, draft_seed=0),
               1: _engine(model, draft_seed=1)}
    for seed in (3, 4, 5):
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(1, 256, size=int(rng.randint(2, 20))).tolist()
                   for _ in range(int(rng.randint(2, 6)))]
        max_new = int(rng.randint(1, 7))
        ref = plain.generate(prompts, max_new)
        for dseed, eng in engines.items():
            assert eng.generate(prompts, max_new) == ref, (seed, dseed)
            assert 0 <= eng.metrics.spec_accepted <= eng.metrics.spec_proposed
            eng.allocator.verify_integrity()
            eng._spec.allocator.verify_integrity()
    assert engines[1].metrics.spec_accepted < \
        engines[1].metrics.spec_proposed
    assert engines[0].metrics.spec_accepted == \
        engines[0].metrics.spec_proposed


def test_spec_eos_stops_exactly_like_plain(model):
    probe = _engine(model).generate([[1, 2, 3]], 6)[0]
    eos = probe[2]
    ref = _engine(model, eos_id=eos).generate([[1, 2, 3]], 6)
    out = _engine(model, draft_seed=0, eos_id=eos).generate([[1, 2, 3]], 6)
    assert out == ref and out[0][-1] == eos and len(out[0]) < len(probe)


def test_spec_composes_with_cache_and_chunked_prefill(model):
    prompts = _prompts()
    ref = _engine(model, prefix_caching=False).generate(prompts, 5)
    assert _engine(model, draft_seed=0).generate(prompts, 5) == ref
    assert _engine(model, draft_seed=1,
                   prefill_chunk=4).generate(prompts, 5) == ref


def test_spec_migration_mid_decode(model):
    prompts = _prompts(3)
    ref = _engine(model).generate(prompts, 5)
    a, b = _engine(model, draft_seed=1), _engine(model, draft_seed=1)
    rids = [a.submit(p, 5) for p in prompts]
    a.step()
    a.step()
    movable = a.running_exportable()
    assert movable
    moved = {rid: b.inject_prefilled(a.export_running(rid))
             for rid in movable}
    a.run_until_idle()
    assert a.allocator.n_used == a._spec.allocator.n_used == 0
    b.run_until_idle()
    got = [(b.result(moved[r]) if r in moved else a.result(r)).tokens
           for r in rids]
    assert got == ref and b._spec.allocator.n_used == 0


def test_spec_draft_pool_covers_prefix_shared_batches(model):
    prompts = _prompts(4, prefix_len=16)
    eng = _engine(model, draft_seed=1, n_blocks=24)
    ref = _engine(model, n_blocks=24).generate(prompts, 5)
    assert eng.generate(prompts, 5) == ref
    assert eng._spec.allocator.n_used == 0
    assert eng._spec.allocator.n_blocks > eng.allocator.n_blocks


def test_draft_params_come_from_the_ports_generator(model):
    _, _, tcfg, _ = model
    eng = ServeEngine(tcfg, model[3], ServeConfig(
        **KW, draft=DraftConfig(tcfg, seed=7), spec_k=K), device="cpu")
    want = ttr.init_params(tcfg, torch.Generator().manual_seed(7),
                           device="cpu")
    for a, b in zip(ttr.param_leaves(eng._spec._params),
                    ttr.param_leaves(want)):
        assert torch.equal(a, b)


def test_spec_metrics_snapshot_and_exposition(model):
    from horovod_tpu_torch.metrics import metrics_prometheus

    eng = _engine(model, draft_seed=0)
    eng.generate(_prompts(2), 4)
    snap = eng.metrics.snapshot()
    assert snap["spec_rounds"] > 0 and snap["spec_accept_rate"] == 1.0
    assert snap["spec_proposed_total"] == snap["spec_accepted_total"] > 0
    assert snap["p99_spec_draft_ms"] >= snap["p50_spec_draft_ms"] >= 0
    assert snap["p99_spec_verify_ms"] >= snap["p50_spec_verify_ms"] >= 0
    txt = metrics_prometheus()
    inst = re.escape(eng.metrics.instance)
    for fam in ("serve_spec_proposed_total", "serve_spec_accepted_total",
                "serve_spec_accept_rate"):
        assert re.search(r'^%s\{instance="%s"\} ' % (fam, inst), txt, re.M)
    assert {"serve:spec_draft", "serve:spec_verify"} <= {
        e["name"] for e in eng.metrics._events}
    plain = _engine(model)
    plain.generate(_prompts(1), 2)
    psnap = plain.metrics.snapshot()
    assert psnap["spec_rounds"] == 0 and psnap["spec_accept_rate"] == 0.0
