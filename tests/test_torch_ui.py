"""The port's training UI (`ui/`) against the JAX package's.

Mirrors tests/test_ui.py on the port. A `StatsListener` on each package
over the same fits of the same weights (the reference draws them,
`from_jax_params` carries them over) reports the same: every key but the
timestamps, the timing rates, `machine` and `memory`; score, parameter and
update summaries within 1e-6, histogram counts equal, the activation
summaries of the armed step within 1e-5 and its grids within one grey
level. The storages the port writes, the reference replays, and back; the
components' JSON is the reference's; the two servers serve the same pages
and the same /api JSON from the same storage; a remote router of either
package posts into the other's server. Every socket is 127.0.0.1.
"""
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener,
                                         FileStatsStorage,
                                         FlowIterationListener,
                                         HistogramIterationListener,
                                         InMemoryStatsStorage,
                                         RemoteUIStatsStorageRouter,
                                         SqliteStatsStorage, StatsListener,
                                         StatsUpdateConfiguration, UIServer)
from deeplearning4j_tpu_torch.ui import components as C

SUMMARY_TOL = 1e-6
ACT_TOL = 1e-5
# what differs between two runs of one package: the clock and the host
VOLATILE = {"timestamp", "iterationTimeMs", "totalRuntimeMs",
            "examplesPerSecond", "minibatchesPerSecond", "memory",
            "machine", "startTime"}
PAGES = ["/", "/train/model", "/train/histogram", "/train/flow",
         "/train/activations", "/train/system", "/tsne"]


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import (InputType, MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration)
    from deeplearning4j_tpu import ui as JUI
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.parallel import (ParallelWrapper as JPW,
                                             make_mesh as jmesh)
    from deeplearning4j_tpu.ui import components as JC
    return types.SimpleNamespace(jax=jax, InputType=InputType, Net=JNet,
                                 Conf=NeuralNetConfiguration, UI=JUI,
                                 DataSet=JDataSet, List=JList, L=JL, PW=JPW,
                                 make_mesh=jmesh, C=JC)


def _jnet(J, kind="dense", seed=1):
    b = J.Conf.Builder().seed(seed)
    if kind == "dense":
        conf = (b.updater("adam").learning_rate(0.01).list()
                .layer(0, J.L.DenseLayer(n_out=8, activation="relu"))
                .layer(1, J.L.OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"))
                .set_input_type(J.InputType.feed_forward(4)).build())
    else:
        conf = (b.updater("sgd").learning_rate(0.01).list()
                .layer(0, J.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                               activation="relu"))
                .layer(1, J.L.SubsamplingLayer(pooling_type="max",
                                               kernel_size=(2, 2)))
                .layer(2, J.L.OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"))
                .set_input_type(J.InputType.convolutional(10, 10, 1))
                .build())
    return J.Net(conf).init()


def _twin(J, jnet):
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    return net.from_jax_params(tree(jnet._params), tree(jnet._model_state),
                               tree(jnet._updater_state))


def _data(kind="dense", n=16, seed=0):
    r = np.random.default_rng(seed)
    shape = (n, 4) if kind == "dense" else (n, 10, 10, 1)
    return (r.random(shape).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.integers(0, 3, n)])


def _close(a, b, tol, path=""):
    """Reports equal: numbers within `tol`, histogram counts and every
    other value exactly, grids within one grey level."""
    if isinstance(a, dict):
        keys = set(a) - VOLATILE
        assert keys == set(b) - VOLATILE, path
        for k in keys:
            _close(a[k], b[k], tol, f"{path}/{k}")
    elif path.endswith("/channels"):
        np.testing.assert_allclose(np.asarray(a, np.int64),
                                   np.asarray(b, np.int64), atol=1,
                                   err_msg=path)
    elif path.endswith("/counts") or isinstance(a, (str, bool)):
        assert a == b, path
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    else:
        assert abs(a - b) <= tol * max(1.0, abs(b)), (path, a, b)


def _both_fit(J, jnet, net, make_config, n_fits, kind="dense", sid="s1"):
    """The same listener config on both packages, n_fits fits each of the
    same batch; returns (port storage, reference storage)."""
    store, jstore = InMemoryStatsStorage(), J.UI.InMemoryStatsStorage()
    net.set_listeners(StatsListener(
        store, make_config(StatsUpdateConfiguration), session_id=sid))
    jnet.set_listeners(J.UI.StatsListener(
        jstore, make_config(J.UI.StatsUpdateConfiguration), session_id=sid))
    x, y = _data(kind)
    for _ in range(n_fits):
        net.fit(DataSet(x, y))
        jnet.fit(J.DataSet(x, y))
    return store, jstore


def test_stats_listener_reports_match_the_reference(J):
    jnet = _jnet(J)
    net = _twin(J, jnet)
    store, jstore = _both_fit(
        J, jnet, net,
        lambda cls: cls(collect_histograms=True, histogram_bins=10), 5)
    assert store.list_session_ids() == jstore.list_session_ids() == ["s1"]
    static, jstatic = store.get_static_info("s1"), jstore.get_static_info("s1")
    _close(static, jstatic, 0)
    assert static["machine"]["backend"] == "cpu"
    ups, jups = store.get_all_updates("s1"), jstore.get_all_updates("s1")
    assert len(ups) == len(jups) == 5
    _close(ups, jups, SUMMARY_TOL)
    last = ups[-1]
    assert last["totalExamples"] == 5 * 16
    assert sum(last["parameters"]["0_W"]["histogram"]["counts"]) == 4 * 8
    assert last["memory"]["deviceBytesInUse"] == 0
    assert last["memory"]["deviceBytesLimit"] == 0
    assert {"0_W", "0_b", "1_W", "1_b"} == set(last["updates"])


def test_activation_stats_of_the_step_match_the_reference(J):
    """No probe: the listener arms the step at iteration 0, later reports
    carry the summaries of the fit batch itself (the reference's
    test_activation_stats_from_fused_step_no_probe on both packages)."""
    jnet = _jnet(J, "conv", seed=3)
    net = _twin(J, jnet)
    store, jstore = _both_fit(
        J, jnet, net,
        lambda cls: cls(collect_activations=True,
                        max_activation_channels=2), 3, kind="conv")
    ups, jups = store.get_all_updates("s1"), jstore.get_all_updates("s1")
    assert "activationStats" not in ups[0]
    _close([u["activationStats"] for u in ups[1:]],
           [u["activationStats"] for u in jups[1:]], ACT_TOL)
    _close([u["activations"] for u in ups[1:]],
           [u["activations"] for u in jups[1:]], ACT_TOL)
    _close(ups, jups, SUMMARY_TOL + ACT_TOL)
    assert set(ups[-1]["activationStats"]) == {"0", "1"}
    g = ups[-1]["activations"]["0"]
    assert g["height"] == 8 and len(g["channels"]) == 2
    # the summaries are of the pre-step forward on the fit batch
    x, _ = _data("conv")
    before = net.params()
    net.fit(DataSet(*_data("conv")))
    after = net.params()
    net.set_params(before)
    conv = np.asarray(net.feed_forward(x)[1], np.float64)
    live = net._last_activation_stats
    assert net._last_activation_stats_iter == 3
    assert isinstance(live[0]["mean"], torch.Tensor)
    assert abs(float(live[0]["mean"]) - conv.mean()) < ACT_TOL
    assert abs(float(live[0]["stdev"]) - conv.std()) < ACT_TOL
    assert abs(float(live[0]["meanMagnitude"]) - np.abs(conv).mean()) \
        < ACT_TOL
    net.set_params(after)


def test_collect_activation_stats_toggles_like_the_reference(J):
    """The toggle bumps the generation once per change; disarming drops
    the summaries; the listener never re-arms a model disarmed by hand;
    the disarmed step is the never-armed step, bit for bit."""
    jnet = _jnet(J, "conv", seed=3)
    net, plain = _twin(J, jnet), _twin(J, jnet)
    g0 = net._act_stats_gen
    assert net.collect_activation_stats(True, 2, 4) is net
    assert net._act_stats_cfg == (2, 4) and net._act_stats_gen == g0 + 1
    net.collect_activation_stats(True, 2, 4)
    assert net._act_stats_gen == g0 + 1
    x, y = _data("conv")
    net.fit(DataSet(x, y))
    plain.fit(DataSet(x, y))
    assert [set(s) for s in net._last_activation_stats] == \
        [{"mean", "stdev", "meanMagnitude", "grid"}] * 2
    # max_size 4 on an 8x8 map: every 2nd row and column
    assert tuple(net._last_activation_stats[0]["grid"].shape) == (4, 4, 2)
    np.testing.assert_array_equal(net.params(), plain.params())
    store = InMemoryStatsStorage()
    net.set_listeners(StatsListener(store, StatsUpdateConfiguration(
        collect_activations=True), session_id="off"))
    net.collect_activation_stats(False)
    assert net._last_activation_stats is None and net._act_stats_cfg is None
    assert net._act_stats_gen == g0 + 2
    net._stats_listener_armed = True      # disarmed by hand after arming
    net.fit(DataSet(x, y))
    net.fit(DataSet(x, y))
    assert net._act_stats_cfg is None
    assert all("activationStats" not in u
               for u in store.get_all_updates("off"))
    # the reference agrees on the generation bookkeeping
    jnet.collect_activation_stats(True, 2, 4)
    jnet.collect_activation_stats(True, 2, 4)
    jnet.collect_activation_stats(False)
    assert jnet._act_stats_gen == 2 == net._act_stats_gen - g0


def test_armed_step_without_listener_reads_nothing_on_the_host(
        J, monkeypatch):
    from test_torch_listeners import _HostReads
    jnet = _jnet(J, "conv", seed=3)
    net = _twin(J, jnet).collect_activation_stats()
    x, y = _data("conv")
    net.fit(DataSet(x, y))       # warm: first-call work out of the count
    reads = _HostReads(monkeypatch)
    net.fit(ListDataSetIterator(list(DataSet(x, y).batch_by(4))))
    assert reads.n == 0
    assert net._last_activation_stats_iter == 4


def test_arming_mid_fit_over_an_iterator_matches_the_reference(J):
    jnet = _jnet(J, "conv", seed=8)
    net = _twin(J, jnet)
    x, y = _data("conv", n=12, seed=9)
    store, jstore = InMemoryStatsStorage(), J.UI.InMemoryStatsStorage()
    net.set_listeners(StatsListener(store, StatsUpdateConfiguration(
        collect_activations=True), session_id="midfit"))
    jnet.set_listeners(J.UI.StatsListener(
        jstore, J.UI.StatsUpdateConfiguration(collect_activations=True),
        session_id="midfit"))
    net.fit(ListDataSetIterator(list(DataSet(x, y).batch_by(4))))
    jnet.fit(J.List(list(J.DataSet(x, y).batch_by(4))))
    ups, jups = store.get_all_updates("midfit"), jstore.get_all_updates(
        "midfit")
    assert len(ups) == 3 and "activationStats" in ups[-1]
    _close(ups, jups, SUMMARY_TOL + ACT_TOL)


def test_one_rank_wrapper_reports_the_step_s_activation_stats(J):
    jnet = _jnet(J, "conv", seed=4)
    net = _twin(J, jnet)
    x, y = _data("conv", n=24, seed=6)
    store, jstore = InMemoryStatsStorage(), J.UI.InMemoryStatsStorage()
    net.set_listeners(StatsListener(store, StatsUpdateConfiguration(
        collect_activations=True), session_id="pw1"))
    jnet.set_listeners(J.UI.StatsListener(
        jstore, J.UI.StatsUpdateConfiguration(collect_activations=True),
        session_id="pw1"))
    ParallelWrapper.Builder(net).averaging_frequency(1).build().fit(
        ListDataSetIterator(list(DataSet(x, y).batch_by(8))))
    mesh = J.make_mesh(n_data=1, devices=J.jax.devices()[:1])
    J.PW.Builder(jnet).mesh(mesh).averaging_frequency(1).build().fit(
        J.List(list(J.DataSet(x, y).batch_by(8))))
    ups, jups = store.get_all_updates("pw1"), jstore.get_all_updates("pw1")
    assert "activationStats" in ups[-1] and "0" in ups[-1]["activationStats"]
    _close(ups, jups, SUMMARY_TOL + ACT_TOL)


def _filled(J):
    """A port run's static info and updates (histograms, activations)."""
    jnet = _jnet(J, "conv", seed=3)
    net = _twin(J, jnet)
    store = InMemoryStatsStorage()
    net.set_listeners(StatsListener(store, StatsUpdateConfiguration(
        collect_histograms=True, collect_activations=True),
        session_id="s1"))
    x, y = _data("conv")
    for _ in range(3):
        net.fit(DataSet(x, y))
    return store.get_static_info("s1"), store.get_all_updates("s1")


@pytest.mark.parametrize("kind", ["file", "sqlite"])
def test_storages_written_by_one_package_replay_in_the_other(J, tmp_path,
                                                             kind):
    static, ups = _filled(J)
    classes = {"file": (FileStatsStorage, J.UI.FileStatsStorage),
               "sqlite": (SqliteStatsStorage, J.UI.SqliteStatsStorage)}[kind]
    ext = {"file": "jsonl", "sqlite": "db"}[kind]
    for i, (writer, reader) in enumerate([classes, classes[::-1]]):
        path = str(tmp_path / f"stats{i}.{ext}")
        w = writer(path)
        w.put_static_info(static)
        for u in ups:
            w.put_update(u)
        if hasattr(w, "close"):
            w.close()
        r = reader(path)
        assert r.list_session_ids() == ["s1"]
        assert r.get_static_info("s1") == static
        assert r.get_all_updates("s1") == ups
        if kind == "sqlite":
            assert r.get_updates_since("s1", 0) == ups[1:]
            r.close()


def test_components_json_is_the_reference_s(J):
    def build(M):
        line = M.ChartLine(title="score", x_label="it", y_label="s")
        line.add_series("a", [0, 1, 2], [1.0, 0.5, 0.25])
        hist = M.ChartHistogram(title="h")
        hist.add_bin(0.0, 1.0, 3)
        hist.add_bin(1.0, 2.0, 5)
        tl = M.ChartTimeline(title="t")
        tl.add_lane("lane", [(0, 2, "x"), (2, 3.5, "y")])
        sc = M.ChartScatter(title="sc")
        sc.add_series("p", [0.0, 1.0], [1.0, 0.0])
        return M.ComponentDiv(
            M.ComponentText("hello", style={"color": "red"}),
            M.ComponentTable(["k", "v"], [["a", "1"]], title="tbl"),
            line, hist, tl, sc, M.ChartStackedArea(title="sa"))
    div, jdiv = build(C), build(J.C)
    assert div.to_json() == jdiv.to_json()
    back = C.Component.from_json(jdiv.to_json())
    assert back.to_json() == jdiv.to_json()
    assert C.render_html([div]) == J.C.render_html([jdiv])


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.status, r.read()


def test_servers_serve_the_same_pages_and_api(J):
    static, ups = _filled(J)
    store, jstore = InMemoryStatsStorage(), J.UI.InMemoryStatsStorage()
    for s in (store, jstore):
        s.put_static_info(static)
        for u in ups:
            s.put_update(u)
    server = UIServer(port=0).attach(store)
    jserver = J.UI.UIServer(port=0).attach(jstore)
    try:
        base = f"http://127.0.0.1:{server.port}"
        jbase = f"http://127.0.0.1:{jserver.port}"
        for path in PAGES + ["/api/sessions", "/api/static/s1",
                             "/api/updates/s1"]:
            status, body = _get(base + path)
            assert status == 200, path
            assert body == _get(jbase + path)[1], path
        assert json.loads(_get(base + "/api/updates/s1")[1]) == ups
        coords = {"coords": [[0.0, 1.0], [2.0, 3.0]], "labels": ["a", "b"]}
        for b in (base, jbase):
            req = urllib.request.Request(
                f"{b}/api/tsne/s1", data=json.dumps(coords).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                assert json.load(r)["ok"]
        assert _get(base + "/api/tsne/s1") == _get(jbase + "/api/tsne/s1")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/api/tsne/nobody")
        assert ei.value.code == 404
        status, text = _get(base + "/metrics")
        assert status == 200 and isinstance(text.decode(), str)
    finally:
        server.stop()
        jserver.stop()


def test_post_without_storage_returns_503():
    server = UIServer(port=0).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/remoteReceive/update",
            data=b'{"sessionId": "x"}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 503
    finally:
        server.stop()


def test_remote_routers_post_across_the_packages(J):
    store, jstore = InMemoryStatsStorage(), J.UI.InMemoryStatsStorage()
    server = UIServer(port=0).attach(store)
    jserver = J.UI.UIServer(port=0).attach(jstore)
    try:
        pairs = [(J.UI.RemoteUIStatsStorageRouter, server, store),
                 (RemoteUIStatsStorageRouter, jserver, jstore)]
        for router_cls, srv, st in pairs:
            router = router_cls(f"http://127.0.0.1:{srv.port}")
            router.put_static_info({"sessionId": "remote1", "model": {
                "class": "MultiLayerNetwork", "numParams": 1},
                "machine": {"device": "test"}})
            router.put_update({"sessionId": "remote1", "iteration": 0,
                               "score": 1.5})
            assert st.list_session_ids() == ["remote1"]
            assert st.get_all_updates("remote1")[0]["score"] == 1.5
            assert "Training overview" in _get(
                f"http://127.0.0.1:{srv.port}/")[1].decode()
    finally:
        server.stop()
        jserver.stop()


def test_listener_events_push(J):
    events, jevents = [], []
    store, jstore = InMemoryStatsStorage(), J.UI.InMemoryStatsStorage()
    store.register_stats_storage_listener(lambda k, p: events.append(k))
    jstore.register_stats_storage_listener(lambda k, p: jevents.append(k))
    jnet = _jnet(J)
    net = _twin(J, jnet)
    net.set_listeners(StatsListener(store))
    jnet.set_listeners(J.UI.StatsListener(jstore))
    x, y = _data()
    net.fit(DataSet(x, y))
    jnet.fit(J.DataSet(x, y))
    assert events == jevents == ["static", "update"]


def test_legacy_listeners_report_as_the_reference_s(J):
    x, y = _data("conv", n=4)
    for make, jmake, key in [
            (lambda: HistogramIterationListener(session_id="h"),
             lambda: J.UI.HistogramIterationListener(session_id="h"),
             "parameters"),
            (lambda: ConvolutionalIterationListener(x[:1], session_id="c"),
             lambda: J.UI.ConvolutionalIterationListener(
                 x[:1], session_id="c"), "activations"),
            (lambda: FlowIterationListener(session_id="f"),
             lambda: J.UI.FlowIterationListener(session_id="f"), "score")]:
        jnet = _jnet(J, "conv", seed=1)
        net = _twin(J, jnet)
        pl, jl = make(), jmake()
        net.set_listeners(pl)
        jnet.set_listeners(jl)
        net.fit(DataSet(x, y))
        jnet.fit(J.DataSet(x, y))
        sid = pl.session_id
        ups = pl.router.get_all_updates(sid)
        jups = jl.router.get_all_updates(sid)
        assert key in ups[-1]
        _close(ups, jups, SUMMARY_TOL + ACT_TOL)
        assert "configJson" in pl.router.get_static_info(sid)["model"]
