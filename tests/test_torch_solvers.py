"""The port's full-batch solvers (`optimize/solvers.py`) against the JAX
package's.

The reference's TestSolvers bodies (tests/test_roc_solvers_cgrnn.py:61-91)
rebuilt on the port: each algorithm cuts the score of an f64 4-8-2 tanh
MLP on the XOR-ish data below 0.7 of its start in 60 iterations, and LBFGS
takes it below 0.3 in 100. They start from the reference's weights (the
reference draws them, `from_jax_params` carries them over): the port draws
its own with another generator, and from that draw line gradient descent
ends 60 iterations at 0.524 against a bar of 0.522 (0.7 x 0.745), where
from the reference's draw both packages end at 0.535 (read: 1.9e-15
apart). Parity: the same weights and data through each package's
`Solver`, 10 iterations: the final scores within 1e-8 relative (read:
<= 8.2e-16) and the parameters within 1e-8 (read: <= 5.0e-15). The facade
dispatches on the configuration's optimization_algo, fits one SGD step for
"sgd", and refuses an unknown name.
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import (LBFGS, ConjugateGradient,
                                               LineGradientDescent, Solver)

ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny forwards: one intra-op thread each, so that a
    worker among several does not wait on a pool of all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(builder, dense, output, input_type, algo):
    return (builder().seed(11).optimization_algo(algo)
            .data_type("float64").list()
            .layer(0, dense(n_out=8, activation="tanh"))
            .layer(1, output(n_out=2, activation="softmax",
                             loss_function="mcxent"))
            .set_input_type(input_type.feed_forward(4)).build())


def _net(algo, device="cpu"):
    return MultiLayerNetwork(_conf(NeuralNetConfiguration.Builder, DenseLayer,
                                   OutputLayer, InputType, algo),
                             device=device).init()


def _xor_ish():
    r = np.random.default_rng(3)
    x = r.random((32, 4)).astype(np.float64)
    y = np.eye(2, dtype=np.float64)[
        ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(int)]
    return x, y


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_reduces_score(J, algo):
    net = _twin(J, algo)
    x, y = _xor_ish()
    s0 = net.score(DataSet(x, y))
    final = Solver(net, max_iterations=60).optimize(x, y)
    assert final < s0 * 0.7, (algo, s0, final)
    assert net.score() == final
    assert net.score(DataSet(x, y), training=True) == pytest.approx(
        final, rel=1e-12)


def test_lbfgs_beats_few_sgd_steps(J):
    x, y = _xor_ish()
    net = _twin(J, "lbfgs")
    Solver(net, max_iterations=100).optimize(x, y)
    assert net.score(DataSet(x, y)) < 0.3


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import (InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JDense,
                                                   OutputLayer as JOut)
    from deeplearning4j_tpu.optimize.solvers import Solver as JSolver
    return types.SimpleNamespace(
        jax=jax, Net=JNet, Solver=JSolver,
        conf=lambda algo: _conf(JConf.Builder, JDense, JOut, JInputType,
                                algo))


def _twin(J, algo, jnet=None):
    """A port network holding the reference's freshly drawn weights."""
    jnet = jnet or J.Net(J.conf(algo)).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    net.from_jax_params(J.jax.tree.map(np.array, jnet._params))
    np.testing.assert_array_equal(net.params(), np.asarray(jnet.params()))
    return net


@pytest.mark.parametrize("algo", ALGOS)
def test_ten_iterations_match_the_reference(J, algo):
    x, y = _xor_ish()
    jnet = J.Net(J.conf(algo)).init()
    net = _twin(J, algo, jnet)
    want = J.Solver(jnet, max_iterations=10).optimize(x, y)
    got = Solver(net, max_iterations=10).optimize(x, y)
    assert got == pytest.approx(want, rel=1e-8)
    np.testing.assert_allclose(net.params(), np.asarray(jnet.params()),
                               rtol=1e-8, atol=1e-10)


def test_solver_dispatch():
    x, y = _xor_ish()
    assert Solver(_net("lbfgs")).algo == "lbfgs"
    for algo, cls in (("lbfgs", LBFGS),
                      ("conjugate_gradient", ConjugateGradient),
                      ("line_gradient_descent", LineGradientDescent)):
        opt = cls(_net(algo), x, y, max_iterations=1)
        assert np.isfinite(opt.optimize())
    net = _net("sgd")
    assert Solver(net).optimize(x, y) is net
    assert net.conf.iteration_count == 1
    with pytest.raises(ValueError, match="Unknown optimization algorithm"):
        Solver(_net("lbfgs"), algo="newton").optimize(x, y)
