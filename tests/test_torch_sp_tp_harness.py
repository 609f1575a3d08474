"""``chip_smoke.py``'s phase 12 rehearsed on a gloo world of 4 with the
tiny f32 config (heads 4 / 2) and plans of its shape: (A) tp=4 with
"flash" (tp above the kv heads), (B) sp=4 "ring_flash", (C) sp=4
"ulysses", (D) tp=2 x sp=2 "ring_flash", and two meshes the chip's
plans do not use: dp=2 x sp=2 "ring" (the flattened dp x sp gradient
group) and fsdp=2 x tp=2 "flash" (the fsdp step's forward on the mesh
without its fsdp axis). ``tp_world`` runs the
one-card references and every plan's own checks (losses within
``TP_LOSS_RTOL`` of the reference, collective counts equal to
``tp_sp_counts``, shard and gathered digests equal) and raises if one
fails. Each rank also records the shapes the flash forward is called at
within each plan, which must be those ``plan_kernel_cases`` gives phase
3 to check against the plain version on the card.
"""

import dataclasses
import os
import pickle

import torch
import torch.multiprocessing as mp

import chip_smoke as cs
from horovod_tpu_torch.models import transformer as ttr

PLANS = (("A", {"tp": 4}, "flash", 4, 32),
         ("B", {"sp": 4}, "ring_flash", 1, 64),
         ("C", {"sp": 4}, "ulysses", 1, 64),
         ("D", {"tp": 2, "sp": 2}, "ring_flash", 1, 64),
         ("dpsp", {"dp": 2, "sp": 2}, "ring", 4, 64),
         ("fsdptp", {"fsdp": 2, "tp": 2}, "flash", 4, 32))
DIMS = dict(warmup=1, steps=2)


def _cfg():
    return ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)


def _signature(b, t, h, hkv, d, causal, f32_out):
    """What a flash forward call shows of its case: q and k/v rows
    (``B·H`` and ``B·Hkv``), T, D, causal, f32 out."""
    return (b * h, t, b * hkv, d, causal, f32_out)


def _rehearse(rank, n, port, out_dir):
    from horovod_tpu_torch.ops import flash_attention as tfa

    seen, plan = {}, [None]
    fwd, phase_tp = tfa._fwd, cs.phase_tp

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
            phase_tp(cfg, seed, name, *args, **kw)
        finally:
            plan[0] = None

    tfa._fwd, cs.phase_tp = record, traced
    cs.tp_world(rank, n, port, _cfg(), 0, "cpu", PLANS, DIMS)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(seen, f)


def test_phase12_rehearsal_passes_and_launches_the_checked_shapes(tmp_path):
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
    every one among the cases phase 3 checks."""
    cfg = dataclasses.replace(ttr.TransformerConfig.llama3_8b(), n_layers=4)
    got = {c[0]: c[1:] for c in cs.plan_kernel_cases(cfg, cs.TP_PLANS)}
    assert got == {
        "A_rank": (4, 2048, 8, 2, 128, "bfloat16", True, None),
        "B_chunk": (1, 2048, 32, 32, 128, "bfloat16", False, "float32"),
        "B_chunk_diag": (1, 2048, 32, 32, 128, "bfloat16", True, "float32"),
        "D_chunk": (1, 4096, 16, 16, 128, "bfloat16", False, "float32"),
        "D_chunk_diag": (1, 4096, 16, 16, 128, "bfloat16", True, "float32"),
    }
    checked = {c[1:] for c in cs.kernel_cases(cfg)}
    for plans in (cs.TP_PLANS, cs.TP_PLANS_2):
        assert {c[1:] for c in cs.plan_kernel_cases(cfg, plans)} <= checked
