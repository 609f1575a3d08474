"""Find a cell and everything it names, by name, from data files.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. It names a
configuration (``perfbench/configs/<config>.json``), a traffic mix
(``perfbench/traffic/<traffic>.json``) and has a file of its own
(``perfbench/workloads/<cell>.json``: the driver that runs the program,
its extra warm-up steps and the limits of the correctness check). A
per-layer metric is ``perfbench/metrics/<metric>.py``. Nothing here
imports the program or the reference: the model's sizes are plain
numbers (:class:`ModelSpec`), which the drivers turn into the program's
config and the reference reads as they are.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH_DIR = "perfbench"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A decoder LM's sizes as run (the configuration file's keys)."""
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq: int
    rope_theta: float
    norm_eps: float
    dtype: str                      # "bfloat16" | "float32"
    n_experts: int = 0              # 0: dense SwiGLU FFN in every layer
    top_k: int = 0
    aux_coef: float = 0.0
    capacity_factor: float = 0.0
    port: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def spec_from_config(conf: Dict[str, Any]) -> ModelSpec:
    """The :class:`ModelSpec` of a configuration file (Hugging Face key
    names, as the published ``config.json`` has them)."""
    if conf["hidden_size"] % conf["num_attention_heads"]:
        raise ValueError("hidden_size must divide by num_attention_heads")
    if conf.get("sliding_window") is not None:
        raise ValueError("a sliding window is not run by this harness")
    port = dict(conf.get("port", {}))
    experts = conf.get("num_local_experts", 0)
    return ModelSpec(
        vocab_size=conf["vocab_size"], d_model=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"],
        max_seq=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]), dtype=conf["torch_dtype"],
        n_experts=experts,
        top_k=conf.get("num_experts_per_tok", 0) if experts else 0,
        aux_coef=float(conf.get("router_aux_loss_coef", 0.0)),
        capacity_factor=float(port.get("moe_capacity_factor", 0.0)),
        port=port)


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A training traffic mix: ``rows_per_gpu`` rows of ``seq`` tokens
    (and the one after) on each of ``gpus`` GPUs a step, token ids drawn
    as ``token_ids`` says; the first ``checked_steps`` steps are the ones
    the correctness check follows; ``pool_steps`` batches are drawn
    ahead of the window and reused in turn past that."""
    gpus: int
    rows_per_gpu: int
    seq: int
    token_ids: str
    checked_steps: int
    pool_steps: int

    @property
    def global_rows(self) -> int:
        return self.gpus * self.rows_per_gpu


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    spec: ModelSpec
    traffic: Traffic
    driver: str
    warmup_steps: int
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = ROOT if root is None else Path(root)
    bench = _read(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}")
    w = entries[0]
    base = root / BENCH_DIR
    traffic = Traffic(**_read(base / "traffic" / f"{w['traffic']}.json"))
    if traffic.gpus != w["chips"]:
        raise ValueError(f"traffic {w['traffic']!r} is for {traffic.gpus} "
                         f"GPUs, the cell asks for {w['chips']} chips")
    own = _read(base / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=w["chips"],
        spec=spec_from_config(_read(base / "configs" / f"{w['config']}.json")),
        traffic=traffic, driver=own["driver"],
        warmup_steps=int(own.get("warmup_steps", 0)),
        limits={k: float(v) for k, v in own["limits"].items()},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _code(cell: Cell, kind: str, name: str) -> Path:
    """``perfbench/<kind>/<name>.py`` of the cell's root, else of this
    harness."""
    own = cell.root / BENCH_DIR / kind / f"{name}.py"
    return own if own.exists() else HERE / kind / f"{name}.py"


def metric_reader(cell: Cell, metric: str):
    """The reader of the per-layer metric ``metric``."""
    return load_module(_code(cell, "metrics", metric),
                       f"perfbench_metric_{metric.replace('.', '_')}")


def driver_module(cell: Cell):
    """The driver that runs the program in this cell."""
    return load_module(_code(cell, "drivers", cell.driver),
                       f"perfbench_driver_{cell.driver}")
