"""The port's datasets (`deeplearning4j_tpu_torch.datasets`) against the JAX
package's: every iterator, the normalizers, the MNIST / Iris / CIFAR /
Curves / LFW iterators, the record readers, and `AsyncDataSetIterator`.

Held, on the CPU:
  - every iterator's batch stream (features, labels, masks and
    `example_metas`), over two epochs with a reset between them, bit-equal
    to the reference's (the same dtype, shape and bytes; a bf16 array is
    compared by its uint16 bit patterns);
  - `AsyncDataSetIterator` / `AsyncMultiDataSetIterator` staged to
    device="cpu", with one and two workers, the bf16 wire on and off and
    labels cast or kept: the same stream, bit-equal, as the reference's
    (which stages with `jax.device_put`);
  - the bf16 wire itself (`_wire_caster`): torch's float -> bf16 rounding
    (nearest, ties to even) gives the reference's ml_dtypes bits, for f32
    and f64 inputs, ties included;
  - normalizer statistics and host transforms: bit-equal (numpy on both
    sides); the device transform (`as_device_transform`, plain torch) against
    the reference's jitted one: within 1 ulp in f32, 1 bf16 ulp in bf16;
  - an AsyncDataSetIterator whose producer raises while its queue is full
    raises on the consumer's thread (checked with a 30 s join: no hang);
  - `device=None` means the card: without one the iterator raises and says
    how to ask for the CPU.
"""
import gzip
import os
import struct
import threading
import time
import types

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.datasets as TD
from deeplearning4j_tpu_torch.common.device import to_port
from deeplearning4j_tpu_torch.datasets import iterators as TI
from deeplearning4j_tpu_torch.datasets import mnist as TM
from deeplearning4j_tpu_torch.datasets import records as TR

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import deeplearning4j_tpu.datasets as JD
    from deeplearning4j_tpu.datasets import iterators, mnist, records
    return types.SimpleNamespace(D=JD, I=iterators, M=mnist, R=records)


def _port():
    return types.SimpleNamespace(D=TD, I=TI, M=TM, R=TR)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

def _bits(a):
    """(dtype name, shape, bytes) of one batch array: numpy, jax or torch;
    bf16 as its uint16 bit patterns."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return ("bfloat16", tuple(a.shape),
                    a.contiguous().view(torch.int16).numpy().tobytes())
        a = a.numpy()
    a = np.asarray(a)
    return (a.dtype.name, a.shape, np.ascontiguousarray(a).tobytes())


def _flat(ds):
    if isinstance(ds.features, (list, tuple)):         # MultiDataSet
        fields = [ds.features, ds.labels, ds.features_masks or [],
                  ds.labels_masks or []]
        out = [[_bits(a) for a in f] for f in fields]
    else:
        out = [_bits(a) for a in (ds.features, ds.labels,
                                  ds.features_mask, ds.labels_mask)]
    metas = getattr(ds, "example_metas", None)
    return out, None if metas is None else [tuple(m) for m in metas]


def _stream(it, epochs=2):
    out = []
    for _ in range(epochs):
        it.reset()
        while it.has_next():
            out.append(_flat(it.next()))
    return out


def _xy(n=20, f=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _masked_batches(M, n=4):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        ds = M.D.DataSet(rng.standard_normal((3, 5, 2)).astype(np.float32),
                         rng.standard_normal((3, 5, 2)).astype(np.float32),
                         (rng.random((3, 5)) > 0.3).astype(np.float32),
                         (rng.random((3, 5)) > 0.3).astype(np.float32))
        ds.example_metas = [("src", 3 * i + j) for j in range(3)]
        out.append(ds)
    return out


def _multi_batches(M, n=3):
    rng = np.random.default_rng(2)
    out = []
    for _ in range(n):
        out.append(M.D.MultiDataSet(
            [rng.standard_normal((4, 3)).astype(np.float32),
             rng.integers(0, 255, (4, 6, 6, 2)).astype(np.uint8)],
            [np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]],
            [None, (rng.random((4,)) > 0.5).astype(np.float32)],
            [(rng.random((4,)) > 0.5).astype(np.float32)]))
    return out


def _write_csvs(tmp):
    tmp.mkdir(exist_ok=True)
    rng = np.random.default_rng(4)
    path = tmp / "rows.csv"
    with open(path, "w") as fh:
        fh.write("a,b,c,d,label,target\n")
        for _ in range(11):
            v = rng.integers(0, 100, 4) / 8.0
            fh.write(",".join(str(x) for x in v)
                     + f",{rng.integers(0, 3)},{rng.integers(0, 50) / 4}\n")
    seq = tmp / "seq"
    seq.mkdir(exist_ok=True)
    for i in range(5):
        with open(seq / f"s{i}.csv", "w") as fh:
            for _ in range(2 + i):
                fh.write(f"{rng.integers(0, 9) / 2},{rng.integers(0, 9)},"
                         f"{rng.integers(0, 2)}\n")
    return str(path), str(seq)


def _write_idx(d, n=23):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    with open(os.path.join(d, "train-images-idx3-ubyte"), "wb") as fh:
        fh.write(struct.pack(">HBB", 0, 0x08, 3))
        fh.write(struct.pack(">III", n, 28, 28))
        fh.write(imgs.tobytes())
    with gzip.open(os.path.join(d, "train-labels-idx1-ubyte.gz"), "wb") as fh:
        fh.write(struct.pack(">HBB", 0, 0x08, 1))
        fh.write(struct.pack(">I", n))
        fh.write(labels.tobytes())


def _saved_files(M, tmp):
    tmp.mkdir(exist_ok=True)
    x, y = _xy(9)
    paths = []
    for i, ds in enumerate(TD.DataSet(x, y).batch_by(4)):
        p = str(tmp / f"b{i}.npz")
        ds.save(p)
        paths.append(p)
    return M.I.FileDataSetIterator(paths)


def _validated(M):
    x, y = _xy(12)
    x[5, 1] = np.nan                  # the second batch is rejected
    return M.I.ValidatingDataSetIterator(
        M.I.ListDataSetIterator(M.D.DataSet(x, y), 4),
        M.I.DataSetValidator(policy="skip"))


def _with_pre(M):
    x, y = _xy(12)
    inner = M.I.ListDataSetIterator(M.D.DataSet(x, y), 5)
    inner.set_pre_processor(M.D.NormalizerStandardize().fit(
        M.D.DataSet(x, y)))
    return M.I.MultipleEpochsIterator(2, inner)


def _combined(M):
    x, y = _xy(12)
    x = np.abs(x) * 40
    it = M.I.ArraysDataSetIterator((x, y), 5)
    it.set_pre_processor(M.I.CombinedPreProcessor.Builder()
                         .add_pre_processor(M.D.ImagePreProcessingScaler())
                         .add_pre_processor(M.D.NormalizerMinMaxScaler(
                             -1, 1).fit(M.D.DataSet(x / 255, y)))
                         .build())
    return it


def _one_shot(M):
    x, y = _xy(9)
    return M.I.ExistingDataSetIterator(
        (M.D.DataSet(x[i:i + 3], y[i:i + 3]) for i in range(0, 9, 3)))


def _records(M, tmp, **kw):
    path, _ = _write_csvs(tmp)
    return M.R.RecordReaderDataSetIterator(
        M.R.CSVRecordReader(path, skip_lines=1), 4, **kw)


def _sequences(M, tmp, regression=False):
    _, seq = _write_csvs(tmp)
    return M.R.SequenceRecordReaderDataSetIterator(
        M.R.CSVSequenceRecordReader(seq, prefetch=1), batch_size=2,
        num_classes=None if regression else 2, regression=regression,
        label_index=2)


def _multi_records(M, tmp):
    path, _ = _write_csvs(tmp)
    return (M.R.RecordReaderMultiDataSetIterator.Builder(3)
            .add_reader("csv", M.R.CSVRecordReader(path, skip_lines=1))
            .add_input("csv", 0, 1).add_input("csv", 2, 3)
            .add_output_one_hot("csv", 4, 3).add_output("csv", 5, 5)
            .build())


CASES = {
    "list": lambda M, tmp: M.I.ListDataSetIterator(M.D.DataSet(*_xy()), 6),
    "list_masks_metas": lambda M, tmp: M.I.ListDataSetIterator(
        _masked_batches(M)),
    "iterator": lambda M, tmp: M.I.IteratorDataSetIterator(
        lambda: iter(M.D.DataSet(*_xy()).batch_by(7))),
    "multiple_epochs_with_pre": lambda M, tmp: _with_pre(M),
    "sampling": lambda M, tmp: M.I.SamplingDataSetIterator(
        M.D.DataSet(*_xy()), 4, 14, seed=3),
    "existing_factory": lambda M, tmp: M.I.ExistingDataSetIterator(
        lambda: M.D.DataSet(*_xy()).batch_by(8), total_outcomes=3),
    "existing_one_shot": lambda M, tmp: _one_shot(M),
    "arrays": lambda M, tmp: M.I.ArraysDataSetIterator(_xy(), 6),
    "arrays_pairs": lambda M, tmp: M.I.ArraysDataSetIterator(
        [(f, l) for f, l in zip(*_xy(7))], 3),
    "reconstruction": lambda M, tmp: M.I.ReconstructionDataSetIterator(
        M.I.ArraysDataSetIterator(_xy(), 8)),
    "moving_window": lambda M, tmp: M.I.MovingWindowDataSetIterator(
        *_xy(30), window=4, stride=3, batch_size=3),
    "files": lambda M, tmp: _saved_files(M, tmp),
    "validating_skip": lambda M, tmp: _validated(M),
    "combined_pre": lambda M, tmp: _combined(M),
    "mnist_synthetic": lambda M, tmp: M.M.MnistDataSetIterator(
        16, num_examples=40),
    "mnist_test_binarized": lambda M, tmp: M.M.MnistDataSetIterator(
        10, num_examples=25, train=False, binarize=True),
    "iris": lambda M, tmp: M.M.IrisDataSetIterator(batch_size=32),
    "cifar_synthetic": lambda M, tmp: M.D.CifarDataSetIterator(
        8, num_examples=20),
    "curves": lambda M, tmp: M.D.CurvesDataSetIterator(6, num_examples=14),
    "lfw_synthetic": lambda M, tmp: M.D.LFWDataSetIterator(
        5, num_examples=12, image_shape=(16, 16, 3), num_classes=4),
    "records_classification_metas": lambda M, tmp: _records(
        M, tmp, label_index=4, num_classes=3, collect_meta_data=True),
    "records_regression": lambda M, tmp: _records(
        M, tmp, label_index=4, label_index_to=5, regression=True),
    "sequences": lambda M, tmp: _sequences(M, tmp),
    "sequences_regression": lambda M, tmp: _sequences(M, tmp, True),
    "multi_records": lambda M, tmp: _multi_records(M, tmp),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iterator_stream_equals_reference(J, case, tmp_path):
    ours = _stream(CASES[case](_port(), tmp_path / "ours"))
    ref = _stream(CASES[case](J, tmp_path / "ours"))
    assert len(ours) == len(ref) > 0
    assert ours == ref


@pytest.mark.parametrize("name", ["cifar", "lfw", "mnist_idx"])
def test_real_data_readers_equal_reference(J, name, monkeypatch, tmp_path):
    """The fixture-backed real-data branches: CIFAR-10's pickled batches,
    LFW's person directories (PIL), MNIST's IDX files (the image file
    plain, the label file gzipped)."""
    if name == "cifar":
        monkeypatch.setenv("DL4J_TPU_CIFAR_DIR",
                           os.path.join(FIXTURES, "cifar10"))
        make = lambda M: M.D.CifarDataSetIterator(6, train=True)  # noqa: E731
    elif name == "lfw":
        monkeypatch.setenv("DL4J_TPU_LFW_DIR", os.path.join(FIXTURES, "lfw"))
        make = lambda M: M.D.LFWDataSetIterator(  # noqa: E731
            3, image_shape=(32, 32, 3), num_classes=2)
    else:
        _write_idx(str(tmp_path))
        monkeypatch.setenv("DL4J_TPU_MNIST_DIR", str(tmp_path))
        make = lambda M: M.M.MnistDataSetIterator(8)  # noqa: E731
    ours, ref = make(_port()), make(J)
    assert not ours.synthetic and not ref.synthetic
    assert _stream(ours) == _stream(ref)


def test_read_idx_python_parser(J, tmp_path, monkeypatch):
    # the Python route (the native one: tests/test_torch_native_ops.py)
    from deeplearning4j_tpu_torch.common import native_ops
    monkeypatch.setattr(native_ops, "get_lib", lambda: None)
    _write_idx(str(tmp_path), n=7)
    for fname in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"):
        p = os.path.join(tmp_path, fname)
        ours = TM.read_idx(p)
        assert ours.dtype == np.uint8
        # the reference may read with its native parser (raw bytes as f32)
        np.testing.assert_array_equal(ours, np.asarray(J.M.read_idx(p)))


ASYNC = [dict(num_workers=w, transfer_dtype=t, cast_labels=c)
         for w in (1, 2) for t in (None, "bfloat16") for c in (True, False)]


@pytest.mark.parametrize("kw", ASYNC, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_async_stream_equals_reference(J, kw):
    """Staged to the CPU, the async stream equals the reference's staged
    one bit for bit, masks and metas included; the second epoch comes after
    a reset of the wrapper."""
    def make(M, **extra):
        return M.I.AsyncDataSetIterator(M.I.ListDataSetIterator(
            _masked_batches(M, 5)), queue_size=2, **kw, **extra)
    ours = make(_port(), device="cpu")
    ref = make(J)
    assert _stream(ours) == _stream(ref)
    multi = [M.I.AsyncMultiDataSetIterator(
        M.I.ListDataSetIterator(_multi_batches(M)), **kw,
        **({"device": "cpu"} if M is not J else {})) for M in (_port(), J)]
    assert _stream(multi[0]) == _stream(multi[1])


def test_async_fresh_wrapper_iterates_from_zero_and_keeps_order():
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    y = np.zeros((16, 2), np.float32)
    it = TI.AsyncDataSetIterator(TI.ArraysDataSetIterator((x, y), 2),
                                 queue_size=3, num_workers=4, device="cpu")
    for _ in range(2):
        feats = [ds.features.numpy() for ds in it]
        np.testing.assert_array_equal(np.concatenate(feats), x)


def test_bf16_wire_bits_equal_reference(J):
    """Round to nearest even, on f32 and f64 inputs; ties, subnormals,
    infinities and NaN included."""
    rng = np.random.default_rng(7)
    x32 = rng.standard_normal(4096).astype(np.float32) * 10
    tie = (rng.integers(0, 2 ** 15, 512).astype(np.uint32) << 16) | 0x8000
    x32 = np.concatenate([x32, tie.view(np.float32),
                          np.array([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                    3.4e38, np.nan], np.float32)])
    x64 = np.concatenate([rng.standard_normal(4096) * 1e3,
                          x32.astype(np.float64)])
    for x in (x32, x64, x32[:4606].reshape(-1, 7, 1)):
        ours = TI._wire_caster("bfloat16")(x)
        ref = np.asarray(J.I._wire_caster("bfloat16")(x))
        assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
        np.testing.assert_array_equal(
            ours.view(torch.int16).numpy().view(np.uint16),
            ref.view(np.uint16))
    ints = np.arange(6, dtype=np.uint8)
    assert TI._wire_caster("bfloat16")(ints) is ints


def test_staged_nhwc_batch_is_a_channels_last_view():
    x = np.random.default_rng(8).integers(0, 255, (4, 6, 5, 3)).astype(
        np.uint8)
    it = TI.AsyncDataSetIterator(
        TI.ListDataSetIterator([TD.DataSet(x, np.zeros((4, 2), np.float32))]),
        device="cpu", transfer_dtype="bfloat16", cast_labels=False)
    ds = it.next()
    assert ds.labels.dtype == torch.float32          # labels kept
    t = to_port(ds.features, torch.device("cpu"))
    assert t.shape == (4, 3, 6, 5)
    assert t.is_contiguous(memory_format=torch.channels_last)
    assert t.data_ptr() == ds.features.data_ptr()


def test_async_without_a_card_raises_and_names_the_cpu():
    it = TI.ListDataSetIterator(TD.DataSet(*_xy()), 5)
    if torch.cuda.is_available():
        assert TI.AsyncDataSetIterator(it)._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TI.AsyncDataSetIterator(it)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TI.wrap_async_for_fit(it, torch.float32)


class _Boom(TI.DataSetIterator):
    """Yields `n_ok` batches as fast as asked, then raises."""

    def __init__(self, n_ok):
        self.n_ok, self._i = n_ok, 0

    def has_next(self):
        return True

    def next_batch(self):
        self._i += 1
        if self._i > self.n_ok:
            raise ValueError("boom")
        return TD.DataSet(np.full((2, 2), self._i, np.float32),
                          np.zeros((2, 2), np.float32))

    def reset(self):
        self._i = 0


@pytest.mark.parametrize("workers", [1, 3])
def test_producer_error_under_a_full_queue_raises_not_hangs(workers):
    it = TI.AsyncDataSetIterator(_Boom(8), queue_size=2,
                                 num_workers=workers, device="cpu")
    time.sleep(0.3)                 # the producer fills the queue and waits
    seen, errors = [], []

    def consume():
        try:
            while it.has_next():
                seen.append(float(it.next_batch().features[0, 0]))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive(), "the consumer hangs"
    assert seen == [float(i) for i in range(1, 9)]
    assert len(errors) == 1 and isinstance(errors[0].__cause__, ValueError)


def test_pre_processor_not_reapplied_to_cached_batches():
    """The reference's pin: a pre-processor transforms a shallow copy, so
    the second epoch over cached batches is normalized once."""
    x, y = _xy(12)
    it = TI.ListDataSetIterator(TD.DataSet(x.copy(), y), 4)
    it.set_pre_processor(TD.NormalizerStandardize().fit(TD.DataSet(x, y)))
    first = [ds.features.copy() for ds in it]
    second = [ds.features.copy() for ds in it]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(it._batches[0].features, x[:4])
    a = TI.AsyncDataSetIterator(it, device="cpu")
    with pytest.raises(RuntimeError, match="underlying"):
        a.set_pre_processor(None)


# ---------------------------------------------------------------------------
# Normalizers
# ---------------------------------------------------------------------------

def _norms(M):
    x, y = _xy(24, f=5)
    x = x * np.float32(3) + np.float32(1.5)
    it = M.I.ListDataSetIterator(M.D.DataSet(x, y), 7)
    return x, y, {"standardize": M.D.NormalizerStandardize().fit(it),
                  "minmax": M.D.NormalizerMinMaxScaler(-2, 3).fit(it),
                  "imagescaler": M.D.ImagePreProcessingScaler(0.5, 1.5,
                                                              200.0)}


def test_normalizer_statistics_and_host_transforms_equal_reference(J):
    x, y, ours = _norms(_port())
    _, _, ref = _norms(J)
    for kind in ours:
        assert ours[kind].to_dict() == ref[kind].to_dict()
        a = ours[kind].transform(TD.DataSet(x.copy(), y)).features
        b = ref[kind].transform(J.D.DataSet(x.copy(), y)).features
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        back = TD.normalizers.Normalizer.from_dict(ours[kind].to_dict())
        assert back.to_dict() == ours[kind].to_dict()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_device_transform_within_one_ulp_of_reference(J, dtype):
    rng = np.random.default_rng(9)
    _, _, ours = _norms(_port())
    _, _, ref = _norms(J)
    inputs = [rng.standard_normal((6, 5)).astype(np.float32) * 3,
              rng.integers(0, 256, (6, 5)).astype(np.uint8)]
    for kind in ours:
        for x in inputs:
            a = ours[kind].as_device_transform(dtype)(torch.from_numpy(x))
            b = np.asarray(ref[kind].as_device_transform(dtype)(x))
            if dtype is None:
                assert a.dtype == torch.float32 and b.dtype == np.float32
                np.testing.assert_array_max_ulp(a.numpy(), b, maxulp=1)
            else:
                ab = a.view(torch.int16).numpy().astype(np.int32)
                bb = b.view(np.int16).astype(np.int32)
                assert np.abs(ab - bb).max() <= 1, kind
        assert ours[kind].as_device_transform(dtype) is \
            ours[kind].as_device_transform(dtype)      # memoized


def test_async_device_transform_applies_on_the_staged_batch(J):
    """uint8 pixels over the wire, scaled by ImagePreProcessingScaler on the
    staging stream: equal to the scaler applied to the same tensor."""
    x = np.random.default_rng(10).integers(0, 256, (8, 4, 4, 3)).astype(
        np.uint8)
    scaler = TD.ImagePreProcessingScaler()
    it = TI.AsyncDataSetIterator(
        TI.ArraysDataSetIterator((x, np.zeros((8, 2), np.float32)), 4),
        device_transform=scaler, transfer_dtype="bfloat16", device="cpu")
    got = torch.cat([ds.features for ds in it])
    want = scaler.as_device_transform()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    ref = J.I.AsyncDataSetIterator(
        J.I.ArraysDataSetIterator((x, np.zeros((8, 2), np.float32)), 4),
        device_transform=J.D.ImagePreProcessingScaler(),
        transfer_dtype="bfloat16")
    np.testing.assert_array_max_ulp(
        got.numpy(), np.concatenate([np.asarray(ds.features) for ds in ref]),
        maxulp=1)


def test_normalizer_in_the_model_zip_both_ways(J, tmp_path):
    """`write_model(..., normalizer=)` stores normalizer.json; each package
    restores the other's."""
    from deeplearning4j_tpu.util import model_serializer as jser

    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.util import model_serializer as tser
    _, _, ours = _norms(_port())
    _, _, ref = _norms(J)
    path = str(tmp_path / "lenet.zip")
    tser.write_model(lenet(device="cpu"), path, normalizer=ours["minmax"])
    assert jser.restore_normalizer(path).to_dict() == \
        ours["minmax"].to_dict()
    assert tser.restore_model(path, device="cpu").num_params() == 431080
    jnet = jser.restore_model(path)
    jpath = str(tmp_path / "ref.zip")
    jser.write_model(jnet, jpath, normalizer=ref["standardize"])
    assert tser.restore_normalizer(jpath).to_dict() == \
        ref["standardize"].to_dict()
    assert tser.restore_normalizer(str(tmp_path / "lenet.zip")).kind == \
        "minmax"
