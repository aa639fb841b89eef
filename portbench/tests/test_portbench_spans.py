"""The readers of the program's own spans (`readers/_spans.py` and the nine
beside it): each one's arithmetic on a stubbed `program_spans()` read-out
(per traced step or scored batch, self time, None where nothing was
recorded or the program has no read-out), and a traced toy run of a
training and a scoring cell on the CPU printing the host-side ones."""
import json
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.readers import _spans

from . import checkout
from .test_portbench_extension import result_of


def _row(count, host=0.0, self_=0.0, device=None):
    return {"count": count, "host_s": host, "self_s": self_,
            "device_s": device}


TRAIN = {
    "train.step": _row(5, 0.600, 0.004),
    "train.dispatch": _row(5, 0.550, 0.006),
    "train.forward": _row(5, 0.200, 0.010, 0.150),
    "train.backward": _row(5, 0.150, 0.150, 0.300),
    "train.update": _row(5, 0.100, 0.100, 0.050),
    "layer.batchnorm": _row(265, 0.050, 0.050, 0.040),
    "layer.batchnorm.backward": _row(265, 0.060, 0.060, 0.045),
    "data.wait": _row(5, 0.002, 0.002),
}
EVAL = {
    "eval.batch": _row(4, 0.240, 0.001),
    "infer.forward": _row(4, 0.100, 0.020, 0.160),
    "infer.to_host": _row(4, 0.080, 0.080),
    "eval.score": _row(4, 0.012, 0.012),
    "layer.batchnorm": _row(212, 0.030, 0.030, 0.120),
    "data.wait": _row(4, 0.008, 0.008),
}


def _read(monkeypatch, metric, phase, spans):
    monkeypatch.setattr(_spans, "program_spans", lambda: spans)
    reader = harness._module("readers", metric.split(".")[0])
    # ctx.steps counts the untraced window: the readers must not use it
    return reader.read(SimpleNamespace(phase=phase, steps=1000, ranks=[]))


@pytest.mark.parametrize("metric,phase,spans,expect", [
    ("forward_device_ms.train", "train", TRAIN, 150.0 / 5),
    ("backward_device_ms.train", "train", TRAIN, 300.0 / 5),
    ("update_device_ms.train", "train", TRAIN, 50.0 / 5),
    ("update_host_ms.train", "train", TRAIN, 100.0 / 5),
    ("batchnorm_device_ms.train", "train", TRAIN, (40.0 + 45.0) / 5),
    ("feed_wait_ms.train", "train", TRAIN, 2.0 / 5),
    ("step_self_ms.train", "train", TRAIN, (4.0 + 6.0) / 5),
    ("forward_device_ms.eval", "eval", EVAL, 160.0 / 4),
    ("batchnorm_device_ms.eval", "eval", EVAL, 120.0 / 4),
    ("to_host_ms.eval", "eval", EVAL, 80.0 / 4),
    ("score_host_ms.eval", "eval", EVAL, 12.0 / 4),
    ("feed_wait_ms.eval", "eval", EVAL, 8.0 / 4),
])
def test_reader_arithmetic(monkeypatch, metric, phase, spans, expect):
    assert _read(monkeypatch, metric, phase, spans) == pytest.approx(expect)


@pytest.mark.parametrize("metric", [
    "forward_device_ms.train", "backward_device_ms.train",
    "update_device_ms.train", "update_host_ms.train",
    "batchnorm_device_ms.train", "feed_wait_ms.train", "step_self_ms.train"])
def test_none_where_nothing_was_recorded(monkeypatch, metric):
    # no read-out (a program without the spans), an empty one, no step
    for spans in (None, {}, {k: v for k, v in TRAIN.items()
                             if k != "train.step"}):
        assert _read(monkeypatch, metric, "train", spans) is None
    # the span missing (the step's own self time is step_self_ms's), or
    # timed on the host only (the CPU)
    bare = {"train.step": TRAIN["train.step"]}
    assert (_read(monkeypatch, metric, "train", bare) is None) == (
        metric != "step_self_ms.train")
    host_only = {k: dict(v, device_s=None) for k, v in TRAIN.items()}
    value = _read(monkeypatch, metric, "train", host_only)
    assert (value is None) == metric.split(".")[0].endswith("_device_ms")


def test_a_scoring_read_out_gives_training_metrics_nothing(monkeypatch):
    # the phase's step span is what a value is per: a scoring run has no
    # train.step, so a training reader finds nothing
    assert _read(monkeypatch, "feed_wait_ms.train", "train", EVAL) is None
    assert _read(monkeypatch, "update_host_ms.train", "eval", TRAIN) is None


def test_a_program_without_the_read_out_gives_none(monkeypatch):
    import deeplearning4j_tpu_torch.optimize.profiler as prof
    monkeypatch.delattr(prof, "program_spans")
    assert _spans.program_spans() is None


HOST = ("update_host_ms", "feed_wait_ms", "step_self_ms", "to_host_ms",
        "score_host_ms")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose toy cells are listed under the span metrics."""
    root = checkout.make(tmp_path_factory.mktemp("checkout"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        base, phase = m["name"].split(".")
        if base in HOST or base.endswith("_device_ms"):
            m["workloads"] += (["resnet50-toy.toy.train-b16"]
                               if phase == "train" else
                               ["resnet50-toy.toy.eval-b16"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.mark.parametrize("cell,phase", [
    ("resnet50-toy.toy.train-b16", "train"),
    ("resnet50-toy.toy.eval-b16", "eval")])
def test_a_traced_toy_run_prints_the_host_span_metrics(root, cell, phase):
    out = result_of(root, "--workload", cell, "--seed", "3000000019",
                    "--seconds", "0.3", "--trace", "1")
    assert out["correct"] is True
    got = {k for k in out["metrics"] if k.split(".")[0] in HOST
           or k.split(".")[0].endswith("_device_ms")}
    expect = ({"update_host_ms.train", "feed_wait_ms.train",
               "step_self_ms.train"} if phase == "train" else
              {"to_host_ms.eval", "score_host_ms.eval", "feed_wait_ms.eval"})
    # the CPU times no device: the device metrics are left out
    assert got == expect
    assert all(out["metrics"][k]["value"] > 0 for k in got)
    assert all(out["metrics"][k]["unit"] == "ms" for k in got)
