"""Whole runs of tiny cells on the CPU (the harness's look for a chip
skipped): correct when the program is sound, not correct with each
fault planted underneath; a cell, configuration, traffic mix and
per-layer metric that exist only as new files are found by name; no
run loads JAX or the JAX package, and the reference loads nothing of
the program."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.cell import ROOT, load_cell
from perfbench.tests import faults
from perfbench.tests.tiny import CPU_ENV, make_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, trace=False, fault=None, seed=2**31 + 7):
    c = load_cell(cell, root)
    env = dict(CPU_ENV)
    if fault:
        env["PERFBENCH_FAULT"] = fault
    t0 = time.monotonic()
    reports = harness.run_cell(c, seed, 0.5, trace, CPU, t0, extra_env=env)
    return harness.result(c, trace, reports, t0, "cpu", "cpu")


@pytest.mark.parametrize("cell", ["tiny-moe", "tiny-dp2"])
def test_a_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert out["window"]["steps"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,cell", [
    ("unchanged", "tiny-moe"), ("half_batch", "tiny-moe"),
    ("loss_altered", "tiny-moe"), ("no_exchange", "tiny-dp2"),
    ("half_batch", "tiny-dp2")])
def test_a_fault_underneath_is_not_correct(root, fault, cell, monkeypatch):
    if load_cell(cell, root).chips == 1:
        faults.plant(fault, monkeypatch.setattr)
        out = _run(root, cell)
    else:
        out = _run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]


def test_new_files_are_found_by_name(root, tmp_path):
    new = tmp_path / "root"
    shutil.copytree(root, new)
    (new / "perfbench" / "metrics").mkdir(parents=True)
    (new / "perfbench" / "metrics" / "steps_traced.py").write_text(
        "LAYER = 'device'\nUNIT = 'steps'\nMOVES = 'train_tokens_per_s'\n"
        "NEEDS = {}\n\n\ndef read(run):\n"
        "    return float(run.trace['steps'])\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny-moe"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(new, "tiny-moe", trace=True)
    assert out["metrics"]["steps_traced"]["value"] == harness.TRACE_STEPS
    assert "busy_s" in out["device"] and "breakdown" in out


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", "import sys\nsys.path.insert(0, %r)\n%s\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"
         % (str(ROOT), code)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **CPU_ENV))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_run_loads_jax_and_the_reference_loads_no_program(root):
    code = ("import time, torch\nfrom perfbench import harness, calibrate\n"
            "from perfbench.cell import load_cell\n"
            f"c = load_cell('tiny-moe', {str(root)!r})\n"
            "r = harness.run_cell(c, 3, 0.2, True, torch.device('cpu'),"
            " time.monotonic())\n"
            "assert harness.banned_modules() == []")
    top = _modules_after(code)
    assert not top & set(harness.BANNED)
    assert "horovod_tpu_torch" in top
    ref = _modules_after("import perfbench.reference.model")
    assert not ref & ({"horovod_tpu_torch"} | set(harness.BANNED))


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mixtral8x7b-l2-t2048", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_the_mixtral_cell_is_correct_on_the_card(card):
    c = load_cell("mixtral8x7b-l2-t2048")
    t0 = time.monotonic()
    reports = harness.run_cell(c, 2**31 + 99, 2.0, False,
                               torch.device("cuda"), t0)
    out = harness.result(c, False, reports, t0,
                         torch.cuda.get_device_name(0), harness.card_line())
    assert out["correct"], out["checks"]
