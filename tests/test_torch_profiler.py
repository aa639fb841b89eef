"""The port's device profiler (`optimize/profiler.py`, over
`torch.profiler`).

`summarize_trace` on a small hand-written trace in torch's Chrome format
(kineto's "GPU 0" device lane beside a host lane): the device lane's
kernel, memcpy and memset events are summed, host events and device-lane
events of other categories are not; names merge at the first "." as the
reference's rule (`merge_fusion_names=False` keeps them whole); rows sorted
by total ms, ms rounded to 3 places and shares to 2, as hand-computed. The
newest trace under the directory wins; a trace without a device lane (the
CPU's) raises, as does a directory with no trace. `trace()` and
`ProfilerListener` on the CPU write a trace into the directory; the
listener starts at its start iteration and stops `num_iterations` calls
later, then stays stopped.
"""
import json
import os
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.profiler import (ProfilerListener,
                                                        summarize_trace,
                                                        trace)


def _meta(pid, name):
    return [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": name}},
            {"ph": "M", "name": "process_labels", "pid": pid, "tid": 0,
             "args": {"labels": name}}]


def _x(pid, name, cat, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": 7,
            "ts": 1.0, "dur": dur_us}


HOST = 4242
EVENTS = (_meta(HOST, "python") + [{"ph": "M", "name": "process_labels",
                                    "pid": HOST, "tid": 0,
                                    "args": {"labels": "CPU"}}]
          + _meta(0, "GPU 0")
          + [_x(0, "void cutlass::Kernel<cutlass_80_wmma.gemm>(Params)",
                "kernel", 1500.0),
             _x(0, "void cutlass::Kernel<cutlass_80_wmma.gemm>(Params)",
                "kernel", 1000.0),
             _x(0, "sm90_xmma_fprop.nhwc", "kernel", 2000.4),
             _x(0, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 300.0),
             _x(0, "Memset (Device)", "gpu_memset", 3.3333),
             _x(0, "cudaLaunchKernel", "cuda_runtime", 9999.0),
             _x(0, "ProfilerStep#1", "gpu_user_annotation", 9999.0),
             _x(HOST, "aten::conv2d", "cpu_op", 7777.0),
             _x(HOST, "void fake_kernel_on_host", "kernel", 5555.0)])


def _write(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fh)


def test_summarize_trace_hand_computed(tmp_path):
    _write(str(tmp_path / "run" / "host_1.1.pt.trace.json"), EVENTS)
    rows = summarize_trace(tmp_path)
    # merged: the cutlass kernel is cut at its first "." (2.5 ms, 2 calls),
    # the sm90 name too; total 2.5 + 2.0004 + 0.3 + 0.0033333 ms
    total = 2.5 + 2.0004 + 0.3 + 0.0033333
    assert rows == [
        {"name": "void cutlass::Kernel<cutlass_80_wmma", "total_ms": 2.5,
         "count": 2, "pct": round(100 * 2.5 / total, 2)},
        {"name": "sm90_xmma_fprop", "total_ms": 2.0,
         "count": 1, "pct": round(100 * 2.0004 / total, 2)},
        {"name": "Memcpy HtoD (Pageable -> Device)", "total_ms": 0.3,
         "count": 1, "pct": round(100 * 0.3 / total, 2)},
        {"name": "Memset (Device)", "total_ms": 0.003, "count": 1,
         "pct": round(100 * 0.0033333 / total, 2)}]
    assert [r["pct"] for r in rows] == [52.04, 41.64, 6.25, 0.07]
    whole = summarize_trace(tmp_path, merge_fusion_names=False)
    assert [r["name"] for r in whole][:2] == [
        "void cutlass::Kernel<cutlass_80_wmma.gemm>(Params)",
        "sm90_xmma_fprop.nhwc"]
    assert sum(r["count"] for r in whole) == 5


def test_newest_trace_wins_and_a_cpu_trace_raises(tmp_path):
    old = str(tmp_path / "a.pt.trace.json")
    _write(old, EVENTS)
    cpu_only = [e for e in EVENTS if e["pid"] == HOST]
    new = str(tmp_path / "b" / "c.pt.trace.json")
    _write(new, cpu_only)
    os.utime(old, (time.time() - 60, time.time() - 60))
    with pytest.raises(RuntimeError, match="no device lane"):
        summarize_trace(tmp_path)
    os.utime(new, (time.time() - 120, time.time() - 120))
    assert summarize_trace(tmp_path)[0]["count"] == 2
    with pytest.raises(FileNotFoundError):
        summarize_trace(tmp_path / "empty")


def _net():
    conf = (NeuralNetConfiguration.Builder().seed(3).updater("adam").list()
            .layer(0, DenseLayer(n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _batches(n):
    r = np.random.default_rng(0)
    x = r.random((8 * n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 8 * n)]
    return list(DataSet(x, y).batch_by(8))


def _names(path):
    with open(path) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    net = _net()
    with trace(tmp_path / "prof") as logdir:
        net.fit(_batches(1)[0])
    assert logdir == str(tmp_path / "prof")
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    names = _names(os.path.join(logdir, files[0]))
    assert any(n and n.startswith("aten::") for n in names)
    with pytest.raises(RuntimeError, match="no device lane"):
        summarize_trace(logdir)


def test_profiler_listener_traces_its_window_then_stops(tmp_path):
    net = _net()
    listener = ProfilerListener(tmp_path, start_iteration=2,
                                num_iterations=3)
    seen = []
    net.set_listeners(listener)
    net.add_listener(type("Spy", (), {"iteration_done": lambda self, m, i:
                                      seen.append((i, listener._prof
                                                   is not None))})())
    net.fit(ListDataSetIterator(_batches(8)))
    # started at the 2nd call, stopped at the 5th
    assert seen == [(0, False), (1, True), (2, True), (3, True), (4, False),
                    (5, False), (6, False), (7, False)]
    assert listener.done and listener.path is not None
    assert os.path.dirname(listener.path) == str(tmp_path)
    assert [f for f in os.listdir(tmp_path)] == [
        os.path.basename(listener.path)]
    assert "aten::mm" in _names(listener.path) or \
        "aten::addmm" in _names(listener.path)
