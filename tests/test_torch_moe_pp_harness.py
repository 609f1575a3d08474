"""``chip_smoke.py``'s phase 13 rehearsed on a gloo world of 4 with the
tiny f32 config (4 layers as the slice, 2 for the MoE configuration,
heads 4 / 2, 8 experts) and plans of the chip's shape: (F) ep=4, (G)
ep=4 with the int8 island, (H) ep=2 x tp=2, (I) pp=4 GPipe and (J) pp=4
1F1B with 4 microbatches, (K) pp=2 x ep=2 GPipe with 4 microbatches;
and three meshes the chip's plans do not use: dp=2 x ep=2 (the routing
statistics over dp), pp=2 x tp=2 1F1B (the head per microbatch) and
dp=2 x pp=2 GPipe. ``moe_world`` runs the one-card references and every
plan's own checks (the first loss within ``FIRST_LOSS_RTOL`` of one
card's, with an MoE pipeline's microbatches; the trained parameters'
loss through the plan within ``TP_LOSS_RTOL`` of theirs through one
card; a dense plan's every loss within ``TP_LOSS_RTOL``; collective
counts equal to ``moe_pp_counts``; the replicated shards' digests
equal; (G)'s layer output within ``ISLAND_INT8_BAND`` of the GSPMD
path's and its control outside it) and raises if one fails. Each
rank also records the shapes the flash forward is called at within each
plan (its ranks' and the one-card check's), which must be those
``plan_kernel_cases`` gives phase 3 to check against the plain version
on the card. One-card phase 13
(``phase_moe``) needs the card; ``active_params`` is checked here.
"""

import dataclasses
import os
import pickle

import torch
import torch.multiprocessing as mp

import chip_smoke as cs
from horovod_tpu_torch.models import transformer as ttr

PLANS = (("F", {"ep": 4}, "flash", 4, 32, None, 1, "moe", "gspmd"),
         ("G", {"ep": 4}, "flash", 4, 32, None, 1, "moe", "island"),
         ("H", {"ep": 2, "tp": 2}, "flash", 4, 32, None, 1, "moe", "gspmd"),
         ("I", {"pp": 4}, "flash", 4, 32, "gpipe", 4, "slice", None),
         ("J", {"pp": 4}, "flash", 4, 32, "1f1b", 4, "slice", None),
         ("K", {"pp": 2, "ep": 2}, "flash", 4, 32, "gpipe", 4, "moe",
          "gspmd"),
         ("dpep", {"dp": 2, "ep": 2}, "flash", 4, 32, None, 1, "moe",
          "gspmd"),
         ("pptp", {"pp": 2, "tp": 2}, "flash", 4, 32, "1f1b", 2, "slice",
          None),
         ("dppp", {"dp": 2, "pp": 2}, "flash", 4, 32, "gpipe", 2, "slice",
          None))
DIMS = dict(warmup=1, steps=2)


def _cfg():
    return ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False,
                                      n_layers=4)


def _signature(b, t, h, hkv, d, causal, f32_out):
    return (b * h, t, b * hkv, d, causal, f32_out)


def _rehearse(rank, n, port, out_dir):
    from horovod_tpu_torch.ops import flash_attention as tfa

    seen, plan = {}, [None]
    fwd, phase = tfa._fwd, cs.phase_moe_pp

    def record(q, k, v, *, scale, causal, out_dtype=None, q_per_kv=1):
        if plan[0] is not None:
            seen.setdefault(plan[0], set()).add(_signature(
                1, q.shape[1], q.shape[0], k.shape[0], q.shape[2], causal,
                out_dtype == torch.float32))
        return fwd(q, k, v, scale=scale, causal=causal, out_dtype=out_dtype,
                   q_per_kv=q_per_kv)

    def traced(cfg, seed, name, *args, **kw):
        plan[0] = name
        try:
            phase(cfg, seed, name, *args, **kw)
        finally:
            plan[0] = None

    tfa._fwd, cs.phase_moe_pp = record, traced
    torch.set_num_threads(1)
    cs.moe_world(rank, n, port, _cfg(), 0, "cpu", PLANS, DIMS)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(seen, f)


def test_phase13_rehearsal_passes_and_launches_the_checked_shapes(tmp_path):
    mp.spawn(_rehearse, args=(4, cs.free_port(), str(tmp_path)), nprocs=4,
             join=True)
    seen = {}
    for rank in range(4):
        with open(tmp_path / f"{rank}.pkl", "rb") as f:
            for name, shapes in pickle.load(f).items():
                seen.setdefault(name, set()).update(shapes)
    want = {}
    for name, b, t, h, hkv, d, _, causal, odt in cs.plan_kernel_cases(
            _cfg(), PLANS):
        want.setdefault(name.split("_")[0], set()).add(
            _signature(b, t, h, hkv, d, causal, odt == "float32"))
    assert seen == want


def test_plan_kernel_cases_at_llama3_8b_widths():
    """The four-card plans' per-rank shapes at the chip's config, and
    every one among the cases phase 3 checks: the ep ranks' whole rows,
    the tp=2 rank's heads, and a pipeline microbatch of one row."""
    cfg = dataclasses.replace(ttr.TransformerConfig.llama3_8b(), n_layers=4)
    got = {c[0]: c[1:] for c in cs.plan_kernel_cases(cfg, cs.MOE_PP_PLANS)}
    whole = (4, 2048, 32, 8, 128, "bfloat16", True, None)
    row = (1, 2048, 32, 8, 128, "bfloat16", True, None)
    assert got == {"F_rank": whole, "G_rank": whole,
                   "H_rank": (4, 2048, 16, 4, 128, "bfloat16", True, None),
                   "I_rank": row, "J_rank": row, "K_rank": row,
                   "F_one": whole, "G_one": whole, "H_one": whole,
                   "I_one": whole, "J_one": whole, "K_one": row}
    checked = {c[1:] for c in cs.kernel_cases(cfg)}
    for plans in (cs.MOE_PP_PLANS, cs.MOE_PP_PLANS_2):
        assert {c[1:] for c in cs.plan_kernel_cases(cfg, plans)} <= checked


def test_active_parameters_of_the_moe_configuration():
    """Phase 13's MoE configuration at Llama-3-8B widths: 3.95 B
    parameters, 1.409 B of experts a layer, of which top-2 of 8 are
    active."""
    cfg = cs.moe_config(dataclasses.replace(
        ttr.TransformerConfig.llama3_8b(), n_layers=4))
    n, active = cs.active_params(cfg)
    experts = 2 * 3 * 8 * 4096 * 14336
    assert n == 2 * 128256 * 4096 + 4096 + 2 * (
        2 * 4096 + 4096 * 4096 * 2 + 2 * 4096 * 1024 + 4096 * 8) + experts
    assert active == n - experts + experts // 4
    dense = dataclasses.replace(ttr.TransformerConfig.llama3_8b(), n_layers=4)
    assert cs.active_params(dense)[0] == cs.active_params(dense)[1]
