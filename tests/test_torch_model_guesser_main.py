"""The port's `util/model_guesser.py` and the ParallelWrapper command line
(`parallel/main.py`) against the JAX package's.

The guesser: a model zip restores the same parameters in both packages; a
JSON or YAML configuration (MultiLayer and ComputationGraph) parses to the
reference's configuration; garbage raises naming the guess. The command
line: `run([..., "--device", "cpu"])` on a toy LeNet-style zip trains the
same parameters as the same `ParallelWrapper` fit in-process, writes a zip
the reference restores, and, started as two processes with the standard
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT variables, joins a gloo group
and trains what the one-process run trains (1e-5: the two halves' mean
gradient is the whole batch's, rounded otherwise).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel import main as M
from deeplearning4j_tpu_torch.util import model_serializer as MS
from deeplearning4j_tpu_torch.util.model_guesser import (load_config_guess,
                                                         load_model_guess)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import deeplearning4j_tpu as D
    from deeplearning4j_tpu.nn.conf import layers as L
    from deeplearning4j_tpu.nn.conf.graph_vertices import MergeVertex
    from deeplearning4j_tpu.util import (load_config_guess as jconf,
                                         load_model_guess as jmodel,
                                         restore_model, write_model)
    return type("J", (), {"D": D, "L": L, "Merge": MergeVertex,
                          "conf_guess": staticmethod(jconf),
                          "model_guess": staticmethod(jmodel),
                          "restore": staticmethod(restore_model),
                          "write": staticmethod(write_model)})


def _jmln(J):
    conf = (J.D.NeuralNetConfiguration.Builder().seed(7).updater("adam")
            .learning_rate(0.01).list()
            .layer(0, J.L.DenseLayer(n_out=6, activation="tanh"))
            .layer(1, J.L.OutputLayer(n_out=2, activation="softmax",
                                      loss_function="mcxent"))
            .set_input_type(J.D.InputType.feed_forward(3)).build())
    return J.D.MultiLayerNetwork(conf).init()


def _jgraph_conf(J):
    return (J.D.NeuralNetConfiguration.Builder().graph_builder()
            .add_inputs("in")
            .add_layer("a", J.L.DenseLayer(n_out=4, activation="tanh"), "in")
            .add_layer("b", J.L.DenseLayer(n_out=4, activation="tanh"), "in")
            .add_vertex("m", J.Merge(), "a", "b")
            .add_layer("o", J.L.OutputLayer(n_out=2, activation="softmax",
                                            loss_function="mcxent"), "m")
            .set_outputs("o")
            .set_input_types(J.D.InputType.feed_forward(3))
            .build())


def test_guess_zip_restores_the_reference_s_model(J, tmp_path):
    jnet = _jmln(J)
    p = str(tmp_path / "m.zip")
    J.write(jnet, p)
    net = load_model_guess(p, device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    np.testing.assert_array_equal(net.params(), np.asarray(jnet.params()))
    assert net.conf.to_json() == J.model_guess(p).conf.to_json()
    no_updater = load_model_guess(p, load_updater=False, device="cpu")
    np.testing.assert_array_equal(no_updater.params(), net.params())


def test_guess_json_and_yaml_configs_as_the_reference(J, tmp_path):
    mconf = _jmln(J).conf
    gconf = _jgraph_conf(J)
    files = {"c.json": mconf.to_json(), "c.yaml": mconf.to_yaml(),
             "g.json": gconf.to_json(), "g.yaml": gconf.to_yaml()}
    for name, text in files.items():
        p = tmp_path / name
        p.write_text(text)
        m = load_model_guess(str(p), device="cpu")
        want = ComputationGraph if name[0] == "g" else MultiLayerNetwork
        assert isinstance(m, want) and m.device.type == "cpu"
        assert m.conf.to_json() == J.model_guess(str(p)).conf.to_json()
        # raw strings parse too
        assert load_config_guess(text).to_json() == \
            J.conf_guess(text).to_json()


def test_guess_garbage_raises(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("definitely: not a [model")
    with pytest.raises(ValueError, match="guess"):
        load_model_guess(str(p), device="cpu")


# -- the command line ----------------------------------------------------------

def _batches():
    r = np.random.default_rng(3)
    x = r.random((48, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 1.5).astype(int)]
    return list(DataSet(x, y).batch_by(8))


def make_iterator():
    """The command line's iterator factory: six batches of eight rows."""
    return ListDataSetIterator(_batches())


def _zip(J, tmp_path):
    p = str(tmp_path / "in.zip")
    J.write(_jmln(J), p)
    return p


FACTORY = "test_torch_model_guesser_main:make_iterator"


def test_main_trains_as_the_wrapper_in_process(J, tmp_path):
    src = _zip(J, tmp_path)
    out = str(tmp_path / "out.zip")
    assert M._join_group("cpu") == (0, False)
    net = M.run(["--model-path", src, "--iterator-factory", FACTORY,
                 "--epochs", "2", "--model-output-path", out,
                 "--device", "cpu"])
    ref = load_model_guess(src, device="cpu")
    ParallelWrapper(ref, averaging_frequency=1).fit(make_iterator(),
                                                    num_epochs=2)
    np.testing.assert_array_equal(net.params(), ref.params())
    assert net.conf.iteration_count == 12
    written = MS.restore_model(out, device="cpu")
    np.testing.assert_array_equal(written.params(), ref.params())
    assert not np.array_equal(written.params(),
                              load_model_guess(src, device="cpu").params())
    # the reference restores the port's zip
    np.testing.assert_array_equal(np.asarray(J.restore(out).params()),
                                  ref.params())


def test_main_parser_is_the_reference_s_and_device(monkeypatch):
    p = M.build_parser()
    args = p.parse_args(["--model-path", "m", "--iterator-factory", "a:b"])
    assert args.device == "cuda" and args.workers is None
    assert args.averaging_frequency == 1 and args.epochs == 1
    with pytest.raises(ValueError, match="module:callable"):
        M._resolve_factory("no_colon")
    # a CPU network joins over gloo whatever cards the host has; a card's
    # leaves the choice to `initialize`
    from deeplearning4j_tpu_torch.parallel import distributed
    joined = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **kw: joined.append((a, kw)) or True)
    for k, v in dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29999").items():
        monkeypatch.setenv(k, v)
    assert M._join_group("cpu") == (1, True)
    assert M._join_group("cuda") == (1, True)
    assert joined == [(("127.0.0.1:29999", 2, 1), {"backend": "gloo"}),
                      (("127.0.0.1:29999", 2, 1), {"backend": None})]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_joins_the_launcher_s_group(J, tmp_path):
    src = _zip(J, tmp_path)
    outs = [str(tmp_path / f"out{r}.zip") for r in range(2)]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                                  "tests")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.main",
             "--model-path", src, "--iterator-factory", FACTORY,
             "--model-output-path", outs[rank], "--device", "cpu"],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    for pr in procs:
        out, _ = pr.communicate(timeout=120)
        assert pr.returncode == 0, out.decode()[-3000:]
    assert os.path.exists(outs[0]) and not os.path.exists(outs[1])
    two = MS.restore_model(outs[0], device="cpu")
    one = load_model_guess(src, device="cpu")
    ParallelWrapper(one, averaging_frequency=1).fit(make_iterator())
    np.testing.assert_allclose(two.params(), one.params(), rtol=0,
                               atol=1e-5)
    assert two.conf.iteration_count == one.conf.iteration_count == 6
