"""No module a run loads is JAX or the JAX package (top-level names
compared whole), the reference loads nothing of the program, and a run
without the program or without a card prints no result."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

from . import checkout
from .test_portbench_extension import result_of

PB = Path(__file__).resolve().parents[1]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for f in (PB / "reference").glob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in (
                "deeplearning4j_tpu_torch", "deeplearning4j_tpu", "jax"), f
    code = ("import sys; import portbench.reference.common, "
            "portbench.reference.resnet, portbench.reference.vgg, "
            "portbench.reference.steps; print(sorted({m.split('.')[0] for m "
            "in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & {"deeplearning4j_tpu_torch", "deeplearning4j_tpu",
                         "jax", "jaxlib", "flax"}


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for f in PB.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN, (f, name)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "deeplearning4j_tpu_torch_x", sys)
    assert "deeplearning4j_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout"))


def test_a_run_loads_neither(root):
    # run.py refuses to print a result when it finds one loaded
    out = result_of(root, "--workload", "resnet50-toy.toy.eval-b16",
                    "--seed", "17", "--seconds", "0.3")
    assert out["correct"] is True


def _no_result(root, *args):
    proc = subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())


def test_without_the_program_no_result(tmp_path):
    root = checkout.make(tmp_path, with_program=False)
    _no_result(root, "--workload", "resnet50-toy.toy.eval-b16", "--seed",
               "3", "--seconds", "0.3", "--device", "cpu")
    _no_result(root, "--workload", "resnet50.train.host-b128", "--seed",
               "3", "--seconds", "1")


def test_without_a_card_no_result(root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _no_result(root, "--workload", "resnet50.train.host-b128", "--seed", "3",
               "--seconds", "1")
