"""The control comes out not correct: the reference computed in float8 in
the program's place (the precision below the configurations' bfloat16),
judged by the cell's own limits. On the CPU at toy sizes; with a card
(`-m gpu`), every cell at its own size on three seeds."""
import json
from pathlib import Path

import pytest

from portbench.check import judge

from . import checkout, cells

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout")) / \
        "BENCHMARK.json"


@pytest.mark.parametrize("workload", ["vgg16-toy.toy.train-b16",
                                      "resnet50-toy.toy.eval-b16"])
def test_control_fails_at_toy_size(bench, workload):
    s = cells.session(bench, workload, 41)
    ok, rows = judge(s.cell.loop.control(s)["readings"], s.cell.limits)
    assert not ok, rows


def _cells():
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_at_cell_size(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        s = cells.session(ROOT / "BENCHMARK.json", workload, seed)
        s.device = "cuda"
        ok, rows = judge(s.cell.loop.control(s)["readings"], s.cell.limits)
        assert not ok, (seed, rows)
