"""A configuration, a traffic mix, a cell and a per-layer metric are added
by adding files and entries: the extension's toy cells run from a
checkout in which no file the benchmark had was edited."""
import hashlib
import json
import os
import subprocess
import sys

import pytest

from . import checkout


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def result_of(root, *args):
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.run([sys.executable, "portbench/run.py", *args,
                           "--device", "cpu"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout"))


def test_only_files_were_added(root):
    before = _digests(checkout.PB)
    after = _digests(root / "portbench")
    assert all(after[f] == d for f, d in before.items())
    added = set(after) - set(before)
    assert added == {f.relative_to(checkout.EXT) for f in
                     checkout.EXT.rglob("*") if f.is_file()
                     and f.name != "entries.json"
                     and "__pycache__" not in f.parts}
    bench = json.loads((checkout.ROOT / "BENCHMARK.json").read_text())
    grown = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in grown[key]]
        assert names[:len(bench[key])] == [m["name"] for m in bench[key]]


def test_new_training_cell_and_metric(root):
    out = result_of(root, "--workload", "vgg16-toy.toy.train-b16", "--seed",
                    "2147483799", "--seconds", "0.5", "--trace", "1")
    assert out["correct"] is True
    assert out["metrics"]["window_steps.train"]["unit"] == "steps"
    assert out["metrics"]["mfu.train"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "loss_finite"}


def test_new_scoring_cell(root):
    out = result_of(root, "--workload", "resnet50-toy.toy.eval-b16",
                    "--seed", "4294967296", "--seconds", "0.5", "--trace",
                    "0")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"eval_samples_per_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"
