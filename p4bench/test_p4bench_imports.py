"""What the benchmark loads, each in a fresh interpreter: nothing of JAX,
the JAX package (``repro``) or its benchmarks (``benchmarks``), compared
by whole top-level names; the reference and the traffic load nothing of
the program (``repro_torch``).  And a run on a machine with no card
fails with a message and prints no result."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REPORT = ("\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] "
          "for m in sys.modules})))")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    env.update(extra)
    return env


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + REPORT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_cell_setup_load_no_jax():
    code = """
import importlib, json, torch
from pathlib import Path
from p4bench import harness, probe, run, control
spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
for m in spec["end_to_end"] + spec["per_layer"]:
    importlib.import_module(
        "p4bench.metrics." + m["name"])
for w in spec["workloads"]:
    cell = harness.load_cell(w["name"])
    r = harness.Run(cell, 2 ** 33, 0.0, torch.device("cpu"),
                    warmup_batches=1)
    r.setup(n_txns=2 * cell["traffic"]["batch"])
"""
    names = _loaded(code)
    assert "repro_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import p4bench.reference.serial, "
                    "p4bench.reference.compare, p4bench.traffic.ycsb, "
                    "p4bench.traffic.tpcc")
    assert not names & (FORBIDDEN | {"repro_torch"}), names


def test_run_without_a_card_fails_with_a_message():
    out = subprocess.run(
        [sys.executable, "p4bench/run.py", "--workload", "ycsb_a.allhot",
         "--seed", "1", "--seconds", "10", "--trace", "0"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert out.stdout.strip() == ""
