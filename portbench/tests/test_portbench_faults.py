"""A run whose timed path is broken underneath comes out not correct:
once for each fault the cells can have. The toy cells run on the CPU,
past the look for a card; a sound run of each comes out correct."""
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch.distributed as dist

from . import checkout, cells


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout")) / \
        "BENCHMARK.json"


def test_sound_training_run(bench):
    out = cells.run(bench, "vgg16-toy.toy.train-b16", 21)
    assert out["correct"] is True


def test_a_step_that_leaves_the_state_unchanged(bench, monkeypatch):
    from deeplearning4j_tpu_torch.nn.updater import updaters

    def unchanged(layer, params, grads, ustate, iteration, minimize=True,
                  **kw):
        return ustate
    monkeypatch.setattr(updaters, "apply_layer", unchanged)
    out = cells.run(bench, "vgg16-toy.toy.train-b16", 22)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(bench, monkeypatch):
    from deeplearning4j_tpu_torch.nn import multilayer
    from deeplearning4j_tpu_torch.nn.graph import computation_graph
    real = multilayer.mean_score

    def half(per_example):
        return real(per_example[: per_example.shape[0] // 2])
    monkeypatch.setattr(multilayer, "mean_score", half)
    monkeypatch.setattr(computation_graph, "mean_score", half)
    for cell in ("vgg16-toy.toy.train-b16", "resnet50-toy.toy.train-b16"):
        out = cells.run(bench, cell, 23)
        assert out["correct"] is False, cell


def test_batch_norm_left_behind(bench):
    from portbench.tools.readings import batch_norm_left_behind
    with batch_norm_left_behind():
        out = cells.run(bench, "resnet50-toy.toy.train-b16", 27)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_sound_scoring_run(bench):
    assert cells.run(bench, "resnet50-toy.toy.eval-b16", 24)["correct"]


def test_an_answer_altered_where_it_is_produced(bench, monkeypatch):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    real = ComputationGraph.output
    calls = []

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 5:            # one row of one batch in the window
            p = out[0]
            p[3] = np.roll(p[3], 1)
        return out
    monkeypatch.setattr(ComputationGraph, "output", altered)
    out = cells.run(bench, "resnet50-toy.toy.eval-b16", 25, seconds=1.0)
    assert out["correct"] is False


def _rank(bench, rank, world, port, fault, q):
    os.environ["OMP_NUM_THREADS"] = "2"
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from portbench.loops import parallel_wrapper as dp
    if fault:
        ParallelWrapper._reduce = lambda self, grads, score: (grads, score)
    s = cells.session(bench, "resnet50-toy.toy.dp2-b8", 26, seconds=0.2)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False)
    out = dp.rank_main(s, rank, world, store)
    if rank == 0:
        q.put(cells.result(s, out))


@pytest.mark.parametrize("fault", [False, True],
                         ids=["sound", "the_exchange_left_out"])
def test_data_parallel(bench, fault):
    world = 2
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(bench, r, world, store.port,
                                              fault, q)) for r in range(world)]
    for p in procs:
        p.start()
    out = q.get(timeout=600)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    assert out["correct"] is (not fault)
