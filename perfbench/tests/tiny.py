"""A checkout-shaped root with tiny cells, for the tests: the real
``BENCHMARK.json`` with its configurations and cells replaced by tiny
float32 ones that take the real cells' drivers, limits and per-layer
metrics, so a whole run fits on the CPU in seconds."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.cell import ROOT

TINY = dict(hidden_size=64, intermediate_size=128, max_position_embeddings=128,
            num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
            rope_theta=10000.0, sliding_window=None, torch_dtype="float32",
            vocab_size=256, num_hidden_layers=2)
MOE = dict(TINY, num_local_experts=4, num_experts_per_tok=2,
           router_aux_loss_coef=0.01,
           port={"sp_attention": "flash", "remat": False,
                 "moe_capacity_factor": 2.0})
DENSE = dict(TINY, port={"sp_attention": "flash", "remat": False})

#: tiny cell -> (config, its sizes, chips, the real cell it stands for)
CELLS = {"tiny-moe": ("tiny-moe-config", MOE, 1, "mixtral8x7b-l2-t2048"),
         "tiny-dp2": ("tiny-dense-config", DENSE, 2, "mistral7b-l8-t2048-dp4")}

#: What a worker process of a test needs on this CPU: one thread, and
#: the program's persistent fused-op path off (its gloo plane hangs
#: within ten steps at two ranks with it on: PERF.md, Open questions).
CPU_ENV = {"OMP_NUM_THREADS": "1", "HOROVOD_STEADY_PERSISTENT": "off"}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(root: Path) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for cell, (conf, sizes, chips, real) in CELLS.items():
        bench["configs"].append({"name": conf, "source": "tiny", "reduced": [],
                                 "file": f"perfbench/configs/{conf}.json",
                                 "why": "a test"})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": f"{cell}-traffic",
                                   "chips": chips, "why": "a test"})
        _write(root / "perfbench" / "configs" / f"{conf}.json", sizes)
        _write(root / "perfbench" / "traffic" / f"{cell}-traffic.json",
               dict(gpus=chips, rows_per_gpu=2, seq=16, token_ids="uniform",
                    checked_steps=3, pool_steps=8))
        own = json.loads((ROOT / "perfbench" / "workloads" /
                          f"{real}.json").read_text())
        own["warmup_steps"] = min(own.get("warmup_steps", 0), 1)
        _write(root / "perfbench" / "workloads" / f"{cell}.json", own)
        for m in bench["per_layer"]:
            if real in m.get("workloads", [real]):
                m.setdefault("workloads", []).append(cell)
    _write(root / "BENCHMARK.json", bench)
    return root
