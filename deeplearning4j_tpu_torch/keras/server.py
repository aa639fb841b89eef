"""The Keras bridge, an HTTP gateway through which another process trains
and queries imported Keras models: port of
deeplearning4j_tpu/keras/server.py.

  POST /fit      {"model_path", "features_path", "labels_path",
                  "nb_epoch"?, "batch_size"?}     -> {"score": ...}
  POST /predict  {"model_path", "features_path"}  -> {"predictions": [...]}
  GET  /health                                    -> {"ok": true}

Models are imported through `keras_import` on the entry point's device
(None: the card) and cached per path; a data file is .h5 (dataset
"features" / "labels", or its only dataset; read with h5py) or .npz. The
server listens on 127.0.0.1 only.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..common.device import resolve_device
from ..datasets.dataset import DataSet
from ..datasets.iterators import next_processed
from .keras_import import _h5py


def _load_array(path, key):
    if str(path).endswith((".h5", ".hdf5")):
        with _h5py().File(path, "r") as f:
            if key in f:
                return np.asarray(f[key])
            names = list(f.keys())     # a one-dataset file (one batch)
            if len(names) == 1:
                return np.asarray(f[names[0]])
            raise KeyError(f"no dataset '{key}' in {path} (has {names})")
    with np.load(path) as z:
        return np.asarray(z[key] if key in z else z[list(z.files)[0]])


class HDF5MiniBatchDataSetIterator:
    """The minibatches of a features file and a labels file."""

    def __init__(self, features_path, labels_path, batch_size=32):
        x = _load_array(features_path, "features")
        y = _load_array(labels_path, "labels")
        self._batches = list(DataSet(x, y).batch_by(int(batch_size)))
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._batches)

    def next_batch(self):
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def reset(self):
        self._pos = 0

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_batch()


class DeepLearning4jEntryPoint:
    """fit / predict on an imported Keras model, the models cached per path,
    on `device` (None: the card, which must be present)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._models = {}      # path -> (net, its lock)
        self._lock = threading.Lock()

    def _model(self, model_path):
        from .keras_import import (import_keras_model_and_weights,
                                   import_keras_sequential_model_and_weights)
        with self._lock:
            if model_path not in self._models:
                try:
                    net = import_keras_sequential_model_and_weights(
                        model_path, device=self.device)
                except Exception:
                    net = import_keras_model_and_weights(
                        model_path, device=self.device)
                self._models[model_path] = (net, threading.Lock())
            return self._models[model_path]

    def fit(self, model_path, features_path, labels_path, nb_epoch=1,
            batch_size=32):
        """nb_epoch passes of one step a batch; returns the last score."""
        net, mlock = self._model(model_path)
        it = HDF5MiniBatchDataSetIterator(features_path, labels_path,
                                          batch_size)
        # one fit at a time per model: the server's threads share the net
        with mlock:
            for _ in range(int(nb_epoch)):
                it.reset()
                while it.has_next():
                    net.fit(next_processed(it))
            return float(net.score())

    def predict(self, model_path, features_path):
        net, mlock = self._model(model_path)
        x = _load_array(features_path, "features")
        with mlock:
            out = net.output(x)
        if isinstance(out, (list, tuple)):
            out = out[0]
        return np.asarray(out)


class KerasBridgeServer:
    """The HTTP gateway over a DeepLearning4jEntryPoint, on 127.0.0.1
    (`port` 0: a free one, read back from `.port` after `start()`)."""

    def __init__(self, port=0, device=None):
        self.port = int(port)
        self.entry_point = DeepLearning4jEntryPoint(device)
        self._httpd = None
        self._thread = None

    def start(self):
        ep = self.entry_point

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._json({"error": "bad json"}, 400)
                    return
                try:
                    if self.path == "/fit":
                        score = ep.fit(req["model_path"],
                                       req["features_path"],
                                       req["labels_path"],
                                       req.get("nb_epoch", 1),
                                       req.get("batch_size", 32))
                        self._json({"score": score})
                    elif self.path == "/predict":
                        preds = ep.predict(req["model_path"],
                                           req["features_path"])
                        self._json({"predictions": preds.tolist()})
                    else:
                        self._json({"error": "not found"}, 404)
                except KeyError as e:
                    self._json({"error": f"missing field {e}"}, 400)
                except Exception as e:   # the caller sees the failure
                    self._json({"error": str(e)[:500]}, 500)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
