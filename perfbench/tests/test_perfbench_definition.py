"""BENCHMARK.json against its contract and its files; every
configuration against its published widths; the counts of
``perfbench/flops.py`` against hand-worked figures."""

import json
import re

import pytest

from perfbench import flops
from perfbench.cell import ROOT, load_cell, metric_reader, spec_from_config

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _config(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    return json.loads((ROOT / entry["file"]).read_text())


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {
        "train_tokens_per_s", "peak_mem_gib", "setup_s"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_cells_have_their_files_and_limits():
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert cell.traffic.gpus == w["chips"] in (1, 4)
        assert set(cell.limits) >= {"loss_gap", "grad_gap", "change_gap"}
        if w["chips"] > 1:
            assert cell.limits["ranks_differ"] == 0
        assert len(w["why"]) <= 200


def test_per_layer_metrics_match_their_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        reader = metric_reader(load_cell(m["workloads"][0]), m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])


@pytest.mark.parametrize("name,vocab,layers", [
    ("mistral-7b-v0.3-l8", 32768, 8), ("mixtral-8x7b-v0.1-l2", 32000, 2)])
def test_configuration_has_the_published_widths(name, vocab, layers):
    from perfbench.drivers.port import port_config
    conf = _config(name)
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(entry["reduced"]) == set(conf["reduced"]) == set(
        conf["published"])
    cfg = port_config(spec_from_config(conf))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.n_layers) == (
        4096, 32, 8, 128, 14336, vocab, layers)
    assert (cfg.rope_theta, cfg.norm_eps, cfg.remat, cfg.sp_attention) == (
        1e6, 1e-5, False, "flash")
    if "num_local_experts" in conf:
        assert (cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor) == (
            8, 2, 4.0)


@pytest.mark.parametrize("name", ["mistral-7b-v0.3-l8", "mixtral-8x7b-v0.1-l2"])
def test_weights_take_the_program_layout(name):
    from horovod_tpu_torch.models import transformer as ttr
    from perfbench import weights
    from perfbench.drivers.port import port_config
    spec = spec_from_config(_config(name))
    ours = {n: tuple(s) for n, s, _, _ in weights.leaves(spec)}
    theirs = {n: tuple(s) for n, s in ttr.named_param_leaves(
        ttr.param_shapes(port_config(spec)))}
    assert ours == theirs


def test_parameter_counts():
    mistral = spec_from_config(_config("mistral-7b-v0.3-l8"))
    mixtral = spec_from_config(_config("mixtral-8x7b-v0.1-l2"))
    assert flops.param_counts(mistral)["total"] == 2_013_335_552
    assert flops.param_counts(mistral)["matrix"] == 1_879_048_192 + 131_072 * 1024
    assert flops.param_counts(mistral)["active_matrix"] == 1_879_048_192
    assert flops.param_counts(mixtral)["total"] == 3_164_688_384
    assert flops.param_counts(mixtral)["active_matrix"] == 919_666_688


def test_work_counts():
    mistral = spec_from_config(_config("mistral-7b-v0.3-l8"))
    mixtral = spec_from_config(_config("mixtral-8x7b-v0.1-l2"))
    att = flops.attention_work(mixtral, 4, 2048)
    assert att["flops"] == 7 * 2 * 4 * 32 * 2048 ** 2 * 128
    # q, out, dout, dq: 4 x 67,108,864 B; k, v, dk, dv: 4 x 16,777,216 B;
    # the logsumexp 1,048,576 B; a layer.
    assert att["bytes"] == 2 * (4 * 67_108_864 + 4 * 16_777_216 + 1_048_576)
    moe = flops.moe_work(mixtral, 4, 2048)
    assert moe["flops"] == 2 * (18 * 4096 * 14336 * 8192 * 2
                                + 6 * 4096 * 8 * 8192)
    assert moe["bytes"] == 2 * 8 * 3 * 4096 * 14336 * 2 * 2
    # Every parameter bf16 but the router's 65,536 in f32.
    assert flops.optimizer_bytes(mixtral) == 7 * (
        (3_164_688_384 - 65_536) * 2 + 65_536 * 4)
    assert flops.optimizer_bytes(mistral) == 7 * 2 * 2_013_335_552
    assert flops.model_flops_per_token(mixtral, 2048) == (
        6 * 919_666_688 + 6 * 2 * 2048 * 4096)
