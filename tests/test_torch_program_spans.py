"""The port's own spans (`optimize.profiler.span` / `follow` /
`program_spans`), on the CPU.

A MultiLayerNetwork with BatchNorm and a residual ComputationGraph each
`fit` over an `AsyncDataSetIterator` and `evaluate` under
`torch.profiler.profile`. The spans: the names of the fit loop's steps and
phases, each layer's forward, BatchNorm's backward, the feed's wait and
scoring's stages; one `train.step` a step and one `eval.batch` a batch;
each span's parent on the training thread. The exported chrome trace holds
a `user_annotation` range for every span recorded, with the same names,
counts and parents. Without a profiler nothing is recorded, and
`obs.TRACER`'s enabled state is what it was; a `ProfilerListener` window
gets the spans of its steps; the off path costs under 2 us a span, as the
reference's disabled tracer. On the card (`-m gpu`): every phase has a
device time, and forward + backward + update cover at least 90% of the
traced steps' busy time and no more than their length.
"""
import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (AsyncDataSetIterator,
                                                         ListDataSetIterator)
from deeplearning4j_tpu_torch.models.zoo import resnet as TR
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import profiler as P

STEPS = 3
PREFIXES = ("train.", "eval.", "infer.", "data.", "layer.")


def _mln(device="cpu"):
    conf = (NeuralNetConfiguration.Builder().seed(3).updater("nesterovs")
            .momentum(0.9).learning_rate(0.05).list()
            .layer(0, L.DenseLayer(n_out=8, activation="identity"))
            .layer(1, L.BatchNormalization())
            .layer(2, L.ActivationLayer(activation="relu"))
            .layer(3, L.OutputLayer(n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _graph(device="cpu"):
    b = (NeuralNetConfiguration.Builder().seed(7).updater("nesterovs")
         .momentum(0.9).learning_rate(0.05).weight_init("relu"))
    gb = b.graph_builder().add_inputs("input")
    x = TR._conv_bn(gb, "stem", "input", 8, (3, 3), (2, 2), "relu")
    x = TR._bottleneck(gb, "s2b0", x, 4, 1, True)
    gb.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("fc", L.OutputLayer(n_out=3, activation="softmax",
                                     loss_function="mcxent"), "avgpool")
    conf = (gb.set_outputs("fc")
            .set_input_types(InputType.convolutional(8, 8, 3)).build())
    return ComputationGraph(conf, device=device).init()


def _batches(kind, n=STEPS, rows=4, seed=0):
    r = np.random.default_rng(seed)
    shape = (rows * n, 5) if kind == "mln" else (rows * n, 8, 8, 3)
    x = r.standard_normal(shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, rows * n)]
    return list(DataSet(x, y).batch_by(rows))


NETS = {"mln": _mln, "graph": _graph}


def _layer_types(net):
    """How many layers of each type the network has."""
    layers = (net.layers if isinstance(net, MultiLayerNetwork) else
              [v.conf for v in net.conf.vertices.values() if v.is_layer])
    return collections.Counter(layer.layer_type for layer in layers)


def _feed(batches, device="cpu"):
    return AsyncDataSetIterator(ListDataSetIterator(batches), device=device)


def _parents(spans):
    """(name, parent name or None) of (name, thread, t0, t1) spans, the
    parent the innermost span of the same thread that contains it."""
    out = []
    by_thread = collections.defaultdict(list)
    for s in spans:
        by_thread[s[1]].append(s)
    for group in by_thread.values():
        group.sort(key=lambda s: (s[2], -s[3]))
        open_ = []
        for name, _, t0, t1 in group:
            while open_ and open_[-1][1] <= t0:
                open_.pop()
            out.append((name, open_[-1][0] if open_ else None))
            open_.append((name, t1))
    return collections.Counter(out)


def _ours(name):
    return name.startswith(PREFIXES)


@pytest.fixture(scope="module", params=sorted(NETS))
def profiled(request, tmp_path_factory):
    """A network fitted over STEPS batches and scored over them under the
    profiler: (its layer types, its program spans, the ring's new spans,
    the chrome trace's events, the tracer's state before and after)."""
    net = NETS[request.param]()
    kind = "mln" if isinstance(net, MultiLayerNetwork) else "graph"
    batches = _batches(kind)
    net.fit(_feed(batches))                       # warm, unprofiled
    before = len(obs.TRACER.spans())
    was = obs.TRACER.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        net.fit(_feed(batches))
        net.evaluate(ListDataSetIterator(batches))
    ring = obs.TRACER.spans()[before:]
    path = tmp_path_factory.mktemp("trace") / "t.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return (_layer_types(net), P.program_spans(), ring, events,
            (was, obs.TRACER.enabled))


def test_span_names_and_counts(profiled):
    types, spans, _, _, _ = profiled
    counts = {n: s["count"] for n, s in spans.items()}
    for name in ("train.step", "train.dispatch", "train.forward",
                 "train.backward", "train.update", "train.listeners",
                 "eval.batch", "infer.forward", "infer.to_host",
                 "eval.score"):
        assert counts.pop(name) == STEPS, name
    assert counts.pop("train.fit") == counts.pop("eval.run") == 1
    assert counts.pop("data.wait") == 2 * STEPS     # fit's and scoring's
    assert types["batchnorm"] >= 1
    assert counts.pop("layer.batchnorm.backward") == STEPS * types[
        "batchnorm"]
    # a forward of every layer a step and a scored batch; the output
    # layer's training forward is its score (`_layer_score`), and the
    # graph's training forward also runs its output vertex
    graph = types["globalpooling"] > 0
    assert counts == {f"layer.{t}": (2 + (t == "output" and graph)) * STEPS
                      * n for t, n in types.items()}
    # the CPU has no device time; self time never exceeds the span's
    for s in spans.values():
        assert s["device_s"] is None
        assert 0 <= s["self_s"] <= s["host_s"] + 1e-12


def test_span_tree_on_the_training_thread(profiled):
    ring = profiled[2]
    parents = _parents([(s.name, s.track, s.t0_ns, s.t0_ns + s.dur_ns)
                        for s in ring if _ours(s.name)])
    assert {s.track for s in ring if _ours(s.name)} == {"MainThread"}
    expect = {"train.fit": None, "train.step": "train.fit",
              "train.dispatch": "train.step",
              "train.listeners": "train.step",
              "train.forward": "train.dispatch",
              "train.backward": "train.dispatch",
              "train.update": "train.dispatch",
              "layer.batchnorm.backward": "train.backward",
              "eval.run": None, "eval.batch": "eval.run",
              "infer.forward": "eval.batch", "infer.to_host": "eval.batch",
              "eval.score": "eval.batch"}
    for (name, parent), n in parents.items():
        if name in expect:
            assert parent == expect[name], (name, parent)
        elif name == "data.wait":
            # the fit loop takes inside its step, scoring before its batch
            assert parent in ("train.step", "eval.run"), parent
        else:
            assert name.startswith("layer.")
            assert parent in ("train.forward", "infer.forward"), (name,
                                                                 parent)
    assert parents[("data.wait", "train.step")] == STEPS
    assert parents[("data.wait", "eval.run")] == STEPS


def test_chrome_trace_holds_every_span(profiled):
    _, spans, ring, events, _ = profiled
    ranges = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("ph") == "X" and _ours(e["name"])]
    assert collections.Counter(r[0] for r in ranges) == {
        n: s["count"] for n, s in spans.items()}
    ring_tree = _parents([(s.name, s.track, s.t0_ns, s.t0_ns + s.dur_ns)
                          for s in ring if _ours(s.name)])
    assert _parents(ranges) == ring_tree


def test_profiled_calls_leave_the_tracer_as_it_was(profiled):
    was, after = profiled[4]
    assert was is False and after is False
    obs.TRACER.enable()
    try:
        net = _mln()
        with profile(activities=[ProfilerActivity.CPU]):
            net.fit(_feed(_batches("mln", n=1)))
        assert obs.TRACER.enabled
    finally:
        obs.TRACER.disable()


def test_without_a_profiler_nothing_is_recorded():
    net = _mln()
    batches = _batches("mln")
    with profile(activities=[ProfilerActivity.CPU]):
        net.fit(_feed(batches))
    seen = P.program_spans()
    ring = len(obs.TRACER.spans())
    net.fit(_feed(batches))
    net.evaluate(ListDataSetIterator(batches))
    net.fit(batches[0])
    net.output(batches[0].features)
    assert P.program_spans() == seen
    assert len(obs.TRACER.spans()) == ring
    assert not obs.TRACER.enabled


def test_a_profiler_listener_window_gets_its_steps(tmp_path):
    net = _mln()
    listener = P.ProfilerListener(tmp_path, start_iteration=2,
                                  num_iterations=2)
    net.set_listeners(listener)
    net.fit(_feed(_batches("mln", n=6)))
    assert listener.done
    spans = P.program_spans()
    # started in the 2nd step's listeners, stopped in the 4th's: steps 3
    # and 4 are the window's
    for name in ("train.step", "train.dispatch", "train.forward",
                 "train.backward", "train.update", "train.listeners"):
        assert spans[name]["count"] == 2, name
    assert spans["data.wait"]["count"] == 2
    with open(listener.path) as fh:
        names = collections.Counter(
            e["name"] for e in json.load(fh)["traceEvents"]
            if e.get("cat") == "user_annotation")
    assert names["train.forward"] == names["train.update"] == 2


def test_off_path_costs_under_two_microseconds():
    """Without a profiler a span is one attribute check returning a shared
    no-op (the reference's disabled-tracer pin: < 2 us a call)."""
    P.follow("train.step").__exit__(None, None, None)   # no profiler: off
    dev = torch.device("cpu")
    n = 50_000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            P.span("layer.dense", dev)
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 2e-6, f"off span() cost {best * 1e9:.0f} ns"
    ring = len(obs.TRACER.spans())
    with P.span("train.forward", dev):
        pass
    assert len(obs.TRACER.spans()) == ring


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _union_s(intervals):
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total / 1e6


@pytest.mark.gpu
def test_phases_cover_the_steps_busy_time_on_the_card(cuda, tmp_path):
    net = _graph(cuda)
    batches = _batches("graph", n=8, rows=32)
    net.fit(_feed(batches, cuda))                  # cuDNN's search, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(_feed(batches, cuda))
        torch.cuda.synchronize()
    spans = P.program_spans()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    fit = [e for e in events if e.get("name") == "train.fit"
           and e.get("cat") == "user_annotation"][0]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")
              and e["ts"] >= fit["ts"]]
    busy = _union_s(device)
    length = (max(t1 for _, t1 in device) - fit["ts"]) / 1e6
    phases = [spans[n]["device_s"] for n in ("train.forward",
                                             "train.backward",
                                             "train.update")]
    assert all(s is not None and s > 0 for s in phases), phases
    assert spans["layer.batchnorm"]["device_s"] > 0
    assert spans["layer.batchnorm.backward"]["device_s"] > 0
    assert 0.9 * busy <= sum(phases) <= length, (phases, busy, length)
