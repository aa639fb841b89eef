"""The port's Keras bridge (`deeplearning4j_tpu_torch/keras/server.py`)
against the JAX package's.

Both packages' servers run on 127.0.0.1 over the same Keras files (the
port's on the CPU): `/health`, then `/predict` before any fit, then four
`/fit` calls of three epochs in batches of 16, then `/predict` again. The
predictions agree to 1e-5 before and after; each fit's score (the last
batch's) agrees to 1e-5; the scores fall, as the reference's test asks.
The data files are .h5 (datasets "features" / "labels") and .npz; a bad
request answers 400 or 500, never a hung connection.
`HDF5MiniBatchDataSetIterator`'s batches equal the reference's. The entry
point runs on the card unless told otherwise.
"""
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.keras import (DeepLearning4jEntryPoint,
                                            KerasBridgeServer)
from deeplearning4j_tpu_torch.keras.server import HDF5MiniBatchDataSetIterator


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.keras import server
    return types.SimpleNamespace(jax=jax, server=server)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A Keras 1 MLP 4-8-2 and its data, as .h5 and as .npz."""
    h5py = pytest.importorskip("h5py")
    d = tmp_path_factory.mktemp("keras_bridge")
    rng = np.random.default_rng(0)
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "Dense",
         "config": {"name": "d1", "output_dim": 8, "activation": "relu",
                    "batch_input_shape": [None, 4]}},
        {"class_name": "Dense",
         "config": {"name": "d2", "output_dim": 2,
                    "activation": "softmax"}}]}
    model = str(d / "model.h5")
    with h5py.File(model, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg).encode("utf-8")
        mw = f.create_group("model_weights")
        for lname, arrs in [
                ("d1", [("W", rng.standard_normal((4, 8)) * 0.3),
                        ("b", np.zeros(8))]),
                ("d2", [("W", rng.standard_normal((8, 2)) * 0.3),
                        ("b", np.zeros(2))])]:
            g = mw.create_group(lname)
            names = []
            for suffix, arr in arrs:
                n = f"{lname}_{suffix}"
                g.create_dataset(n, data=np.asarray(arr, np.float32))
                names.append(n.encode())
            g.attrs["weight_names"] = names
    x = np.random.default_rng(1).random((64, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 2).astype(int)]
    out = {"model": model, "x_h5": str(d / "x.h5"), "y_h5": str(d / "y.h5"),
           "x_npz": str(d / "x.npz"), "y_npz": str(d / "y.npz"), "x": x,
           "y": y}
    with h5py.File(out["x_h5"], "w") as f:
        f.create_dataset("features", data=x)
    with h5py.File(out["y_h5"], "w") as f:
        f.create_dataset("labels", data=y)
    np.savez(out["x_npz"], features=x)
    np.savez(out["y_npz"], labels=y)
    return out


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def _session(server, files, kind):
    """health, predict, four fits, predict: the readings."""
    base = f"http://127.0.0.1:{server.port}"
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        assert json.load(r)["ok"]
    x, y = files[f"x_{kind}"], files[f"y_{kind}"]
    model = files["model"]
    before = np.asarray(_post(base, "/predict", {
        "model_path": model, "features_path": x})["predictions"])
    scores = [_post(base, "/fit", {"model_path": model, "features_path": x,
                                   "labels_path": y, "nb_epoch": 3,
                                   "batch_size": 16})["score"]
              for _ in range(4)]
    after = np.asarray(_post(base, "/predict", {
        "model_path": model, "features_path": x})["predictions"])
    return before, scores, after


@pytest.mark.parametrize("kind", ["h5", "npz"])
def test_fit_and_predict_over_http_match_the_reference(J, files, kind):
    port = KerasBridgeServer(device="cpu").start()
    ref = J.server.KerasBridgeServer().start()
    try:
        b_t, s_t, a_t = _session(port, files, kind)
        b_j, s_j, a_j = _session(ref, files, kind)
    finally:
        port.stop()
        ref.stop()
    assert b_t.shape == a_t.shape == (64, 2)
    np.testing.assert_allclose(b_t, b_j, atol=1e-5)
    np.testing.assert_allclose(s_t, s_j, atol=1e-5)
    np.testing.assert_allclose(a_t, a_j, atol=1e-5)
    assert s_t[-1] < s_t[0]                       # repeated fits keep learning
    np.testing.assert_allclose(a_t.sum(1), 1.0, atol=1e-3)


def test_errors_answer_with_http_codes(files):
    server = KerasBridgeServer(device="cpu").start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for path, body, codes in (
                ("/fit", b'{"model_path": "missing.h5"}', (400, 500)),
                ("/fit", b"{not json", (400,)),
                ("/predict", json.dumps({
                    "model_path": "missing.h5",
                    "features_path": files["x_npz"]}).encode(), (500,)),
                ("/nowhere", b"{}", (404,))):
            req = urllib.request.Request(base + path, data=body)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=60)
            assert ei.value.code in codes, (path, ei.value.code)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nowhere", timeout=60)
        assert ei.value.code == 404
    finally:
        server.stop()
    assert server.port > 0 and server._httpd is None


def test_minibatch_iterator_is_the_reference_s(J, files):
    for kind in ("h5", "npz"):
        mine = list(HDF5MiniBatchDataSetIterator(
            files[f"x_{kind}"], files[f"y_{kind}"], batch_size=24))
        ref = list(J.server.HDF5MiniBatchDataSetIterator(
            files[f"x_{kind}"], files[f"y_{kind}"], batch_size=24))
        assert [b.num_examples() for b in mine] == [24, 24, 16]
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.features, np.asarray(b.features))
            np.testing.assert_array_equal(a.labels, np.asarray(b.labels))


def test_entry_point_caches_models_and_defaults_to_the_card(files):
    ep = DeepLearning4jEntryPoint(device="cpu")
    p1 = ep.predict(files["model"], files["x_npz"])
    assert ep._model(files["model"])[0] is ep._model(files["model"])[0]
    np.testing.assert_array_equal(p1, ep.predict(files["model"],
                                                 files["x_npz"]))
    if torch.cuda.is_available():
        assert DeepLearning4jEntryPoint().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeepLearning4jEntryPoint()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KerasBridgeServer()
