"""The port's recurrent path against the JAX package's: the recurrent layers
(`nn/conf/layers/recurrent.py`), `RnnOutputLayer`, `SelfAttentionLayer`,
truncated BPTT and `rnn_time_step` on both containers, the char-RNN
(BASELINE.md configuration #3, `models/zoo/char_rnn.py`) and the golden
`lstm.zip`.

The same numpy inputs and parameters go to both packages; the reference
draws the weights (the port cannot reproduce JAX's draws) and hands them
over as numpy arrays (`from_jax_params`, whose recurrent layouts are the
reference's: no transpose). Held, on the CPU:
  - each layer: forward, final carry and the gradients of a random
    projection of both (input, parameters, incoming carry), without a
    mask, with a [B, T] mask whose rows are padded at the end and in the
    middle, and from a non-zero carry: f32 1e-5 (abs + rel), f64 1e-12;
  - the char-RNN (V=11, 2x8 GravesLSTM, T=12, tbptt 5: segments of 5, 5
    and 2) over two `fit` calls: every segment's score, the parameters
    after each fit and `iteration_count` (6). Its RMSProp (lr 0.1) runs in
    float64, to 1e-9: RMSProp steps by lr·g / (sqrt(E[g^2]) + 1e-8), so a
    gradient of ~1e-8, whose last bits the two backends' f32 sums set
    differently (a difference of near-equal sums), moves its parameter by
    up to lr; in f32 ten of 1331 parameters part by up to 8.6e-5 after
    one fit. The same run with SGD (no division by the gradient's size)
    is held in f32 to 1e-5 (abs + rel), as LeNet's Nesterov steps are in
    tests/test_torch_multilayer.py;
  - bf16 (SGD): the port's error against the reference's f32 run is at
    most twice the reference's own bf16 error, or one bf16 step (2^-8) of
    the largest value where that is more (the rule of
    tests/test_torch_computation_graph.py);
  - `rnn_time_step` one step at a time against JAX's and against the full
    `output` (1e-5), and the reference's ComputationGraph pins
    (tests/test_roc_solvers_cgrnn.py:111-135);
  - golden `lstm.zip`: parameters bit-equal, output within 1e-5 of
    `lstm_io.npz`, the updater state equal to JAX's restore; a zip the
    port writes restores in JAX with equal parameters and updater state.

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_recurrent.py -m gpu
"""
import os
import types
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models.zoo.char_rnn import (char_rnn,
                                                          char_rnn_conf)
from deeplearning4j_tpu_torch.nn.conf import layers as TLy
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util import model_serializer as TS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")
TOL = {"float32": 1e-5, "float64": 1e-12}
B, T, F, H = 3, 7, 5, 6
# row 0 whole; row 1 padded at the end; row 2 padded in the middle
MASK = np.ones((B, T), np.float32)
MASK[1, 5:] = 0.0
MASK[2, 2:4] = 0.0
LAYERS = ["graveslstm", "gravesbidirectionallstm", "simplernn"]
# the small char-RNN: T % tbptt = 2, a short tail segment
V, HID, SEQ, TBPTT, NB = 11, 8, 12, 5, 3


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import importlib

    import jax.numpy as jnp

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.dataset import \
        MultiDataSet as JMultiDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JListIt
    from deeplearning4j_tpu.nn.conf import layers
    from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
        MultiLayerConfiguration as JConf, NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.graph.computation_graph import \
        ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.util import model_serializer as ser
    zoo = importlib.import_module("deeplearning4j_tpu.models.zoo.char_rnn")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, layers=layers, DataSet=JDataSet,
        MultiDataSet=JMultiDataSet, ListIt=JListIt, InputType=JInputType,
        Conf=JConf, NNC=JNNC, Graph=JGraph, Net=JNet, ser=ser,
        char_rnn_conf=zoo.char_rnn_conf)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _one_hot(seed, n, t, v=V):
    rng = np.random.default_rng(seed)
    return np.eye(v, dtype=np.float32)[rng.integers(0, v, (n, t))]


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

def _layer_pair(J, kind, **kw):
    kw = dict(dict(n_in=F, n_out=H, activation="tanh", weight_init="xavier"),
              **kw)
    return J.layers.LAYER_REGISTRY[kind](**kw), TLy.LAYER_REGISTRY[kind](**kw)


def _layer_case(J, kind, case, dtype):
    """(layer pair, params, x, carry, mask) as numpy in `dtype`: every
    parameter random (so the peepholes and the forget bias take part)."""
    jl, tl = _layer_pair(J, kind)
    shapes = jl.init_params(J.jax.random.PRNGKey(0))
    params = {k: _rand(10 + i, v.shape, 0.5).astype(dtype)
              for i, (k, v) in enumerate(sorted(shapes.items()))}
    x = _rand(1, (B, T, F)).astype(dtype)
    carry = {k: (np.zeros(v.shape, dtype) if case != "carry"
                 else _rand(20 + i, v.shape).astype(dtype))
             for i, (k, v) in enumerate(sorted(jl.init_carry(B).items()))}
    mask = None if case == "plain" else MASK.astype(dtype)
    return jl, tl, params, x, carry, mask


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["plain", "mask", "carry"])
@pytest.mark.parametrize("kind", LAYERS)
def test_recurrent_layer_matches_jax(J, kind, case, dtype):
    """Forward, final carry, and the gradients of sum(out·ct) + Σ
    sum(carry'·ct_c) for the input, every parameter and the incoming
    carry. "mask" and "carry" use the [B, T] mask; "carry" starts from a
    non-zero state."""
    jax, jnp = J.jax, J.jnp
    jl, tl, params, x, carry, mask = _layer_case(J, kind, case, dtype)
    ct = _rand(30, (B, T, H)).astype(dtype)
    ct_c = {k: _rand(40 + i, v.shape).astype(dtype)
            for i, (k, v) in enumerate(sorted(carry.items()))}

    def jloss(p, xx, c):
        out, c2 = jl.forward_with_carry(
            p, xx, c, mask=None if mask is None else jnp.asarray(mask))
        return (jnp.sum(out * ct) + sum(jnp.sum(c2[k] * ct_c[k])
                                        for k in c2)), (out, c2)

    (_, (out_j, c_j)), g_j = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            {k: jnp.asarray(v) for k, v in carry.items()})

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tc = {k: torch.tensor(v, requires_grad=True) for k, v in carry.items()}
    out_t, c_t = tl.forward_with_carry(
        tp, tx, tc, mask=None if mask is None else torch.tensor(mask))
    loss = (out_t * torch.tensor(ct)).sum() + sum(
        (c_t[k] * torch.tensor(ct_c[k])).sum() for k in c_t)
    leaves = [tx] + list(tp.values()) + list(tc.values())
    grads = torch.autograd.grad(loss, leaves)
    tol = TOL[dtype]
    assert out_t.dtype == tx.dtype and out_t.shape == (B, T, H)
    _close(out_t.detach(), out_j, tol, "out")
    for k in c_j:
        _close(c_t[k].detach(), c_j[k], tol, f"carry {k}")
    _close(grads[0], g_j[1], tol, "dx")
    for k, g in zip(tp, grads[1:1 + len(tp)]):
        _close(g, g_j[0][k], tol, f"d{k}")
    for k, g in zip(tc, grads[1 + len(tp):]):
        _close(g, g_j[2][k], tol, f"dcarry {k}")


@pytest.mark.parametrize("kind", LAYERS)
def test_masked_steps_emit_zero_and_keep_the_state(J, kind):
    """Step by step (calls of one step, chained by their carries): a masked
    step outputs exactly 0 and hands on exactly the carry it got; the
    chained steps agree with the whole masked sequence in one call (one
    direction; 1e-6, the hoisted projection is one product of another
    shape)."""
    _, tl, params, x, carry, _ = _layer_case(J, kind, "carry", "float32")
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tx = torch.tensor(x)
    c = {k: torch.tensor(v) for k, v in carry.items()}
    mask = torch.tensor(MASK)
    outs = []
    for t in range(T):
        out, nxt = tl.forward_with_carry(tp, tx[:, t:t + 1], c,
                                         mask=mask[:, t:t + 1])
        off = mask[:, t] == 0
        assert torch.all(out[off] == 0)
        for k in c:
            torch.testing.assert_close(nxt[k][off], c[k][off], rtol=0,
                                       atol=0)
        outs.append(out)
        c = nxt
    whole, final = tl.forward_with_carry(
        tp, tx, {k: torch.tensor(v) for k, v in carry.items()}, mask=mask)
    assert torch.all(whole[mask == 0] == 0)
    if kind != "gravesbidirectionallstm":   # its backward pass runs T..1
        torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=0,
                                   atol=1e-6)
        for k in final:
            torch.testing.assert_close(c[k], final[k], rtol=0, atol=1e-6)


def test_layer_init_follows_the_reference(J):
    """Shapes and names as the reference's; xavier with the reference's
    fans (fan-out H for W [nIn, 4H], H for RW [H, 4H]); the forget gate's
    bias slice set, the peepholes zero. Variances within 6 standard
    errors."""
    n_in, h = 64, 64
    gen = torch.Generator().manual_seed(0)
    for kind in LAYERS:
        jl, tl = _layer_pair(J, kind, n_in=n_in, n_out=h)
        want = jl.init_params(J.jax.random.PRNGKey(0))
        got = tl.init_params(gen)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        for k, v in got.items():
            assert v.dtype == torch.float32
            if k.startswith(("W", "RW")):
                fan_in = n_in if k.startswith("W") else h
                var = 2.0 / (fan_in + h)
                se = var * np.sqrt(2.0 / v.numel())
                assert abs(float(v.var()) - var) < 6 * se, (kind, k)
            elif k.startswith("peep"):
                assert not v.any()
            else:       # b: zero, the forget gate's slice 1.0
                np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    attention = TLy.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2)
    assert {k: tuple(v.shape) for k, v in attention.init_params(gen).items()
            } == {"Wq": (8, 8), "Wk": (8, 8), "Wv": (8, 8), "Wo": (8, 8),
                  "b": (8,)}


def test_layer_json_is_the_reference_json(J):
    for kind, kw in (("graveslstm", dict(forget_gate_bias_init=0.5,
                                         scan_unroll=4)),
                     ("gravesbidirectionallstm", dict(gate_activation="hardsigmoid")),
                     ("simplernn", {}),
                     ("rnnoutput", dict(loss_function="mse")),
                     ("selfattention", dict(n_heads=2, causal=True))):
        kw = dict(n_in=8, n_out=8, **kw)
        ref = J.layers.LAYER_REGISTRY[kind](**kw).to_dict()
        assert TLy.LAYER_REGISTRY[kind](**kw).to_dict() == ref
        assert TLy.LayerConf.from_dict(ref).to_dict() == ref
    # every layer type of the reference is ported; the three pretrain
    # layers write the reference's dicts too
    assert sorted(TLy.LAYER_REGISTRY) == sorted(J.layers.LAYER_REGISTRY)
    assert not hasattr(TLy, "NOT_PORTED")
    for kind, kw in (("rbm", dict(n_in=8, n_out=4, hidden_unit="gaussian",
                                  k=2)),
                     ("autoencoder", dict(n_in=8, n_out=4,
                                          corruption_level=0.2)),
                     ("vae", dict(n_in=8, n_out=2, encoder_layer_sizes=(6,),
                                  reconstruction_distribution={
                                      "type": "exponential",
                                      "activation": "tanh"}))):
        ref = J.layers.LAYER_REGISTRY[kind](**kw).to_dict()
        assert TLy.LAYER_REGISTRY[kind](**kw).to_dict() == ref
        assert TLy.LayerConf.from_dict(ref).to_dict() == ref


def test_rnn_output_layer_score_with_a_2d_label_mask(J):
    """The per-example score sums each example's time steps and features;
    a [B, T] label mask drops padded steps. Score and the gradients of its
    sum, f32 1e-5."""
    jax, jnp = J.jax, J.jnp
    kw = dict(n_in=H, n_out=4, activation="softmax", loss_function="mcxent")
    jl, tl = J.layers.RnnOutputLayer(**kw), TLy.RnnOutputLayer(**kw)
    params = {"W": _rand(2, (H, 4)), "b": _rand(3, (4,))}
    x = _rand(4, (B, T, H))
    y = _one_hot(5, B, T, 4)

    def jscore(p, xx):
        return jl.compute_score_per_example(p, xx, jnp.asarray(y),
                                            mask=jnp.asarray(MASK))

    per_j = np.asarray(jscore(_np(params), x))
    g_j = jax.grad(lambda p, xx: jnp.sum(jscore(p, xx)), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    per_t = tl.compute_score_per_example(tp, tx, torch.tensor(y),
                                         mask=torch.tensor(MASK))
    assert per_t.shape == (B,)
    grads = torch.autograd.grad(per_t.sum(), [tx, tp["W"], tp["b"]])
    _close(per_t.detach(), per_j, TOL["float32"], "score")
    for got, want in zip(grads, (g_j[1], g_j[0]["W"], g_j[0]["b"])):
        _close(got, want, TOL["float32"])
    # masked steps contribute nothing: row 2's first four steps (steps 2-3
    # masked) score as its first two alone
    torch.testing.assert_close(
        tl.compute_score_per_example(tp, tx[2:, :4], torch.tensor(y[2:, :4]),
                                     mask=torch.tensor(MASK[2:, :4]))
        .detach(),
        tl.compute_score_per_example(tp, tx[2:, :2], torch.tensor(y[2:, :2]))
        .detach())


@pytest.mark.parametrize("causal", [False, True])
def test_self_attention_layer_matches_jax(J, causal):
    """The local route (blockwise attention) with a key mask: output (zero
    at masked steps) and the gradients of sum(out·ct), f32 1e-5."""
    jax, jnp = J.jax, J.jnp
    kw = dict(n_in=8, n_out=8, n_heads=2, causal=causal)
    jl, tl = J.layers.SelfAttentionLayer(**kw), TLy.SelfAttentionLayer(**kw)
    keys = ("Wq", "Wk", "Wv", "Wo", "b")
    params = {k: _rand(50 + i, (8,) if k == "b" else (8, 8), 0.5)
              for i, k in enumerate(keys)}
    x = _rand(6, (B, T, 8))
    ct = _rand(7, (B, T, 8))
    mask = MASK.copy()
    mask[:, 0] = 1.0      # every query row sees at least one key

    def jloss(p, xx):
        out = jl.forward(p, xx, mask=jnp.asarray(mask))
        return jnp.sum(out * ct), out

    (_, out_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1),
                                         has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    out_t = tl.forward(tp, tx, mask=torch.tensor(mask))
    grads = torch.autograd.grad((out_t * torch.tensor(ct)).sum(),
                                [tx] + [tp[k] for k in keys])
    _close(out_t.detach(), out_j, TOL["float32"], "out")
    assert torch.all(out_t[torch.tensor(mask) == 0] == 0)
    _close(grads[0], g_j[1], TOL["float32"], "dx")
    for k, g in zip(keys, grads[1:]):
        _close(g, g_j[0][k], TOL["float32"], f"d{k}")


# ---------------------------------------------------------------------------
# The char-RNN: truncated BPTT, rnn_time_step
# ---------------------------------------------------------------------------

# case -> (updater, data type); see the module docstring
CHAR_CASES = {"sgd-f32": ("sgd", "float32"),
              "rmsprop-f64": ("rmsprop", "float64"),
              "sgd-bf16": ("sgd", "bfloat16")}


def _char_kw(case="sgd-f32"):
    updater, dtype = CHAR_CASES[case]
    return dict(vocab_size=V, hidden=HID, tbptt_length=TBPTT,
                updater=updater, data_type=dtype)


def _char_batches():
    return [(_one_hot(60 + i, NB, SEQ), _one_hot(70 + i, NB, SEQ))
            for i in range(2)]


class _Scores:
    """A reference listener: the score of every optimizer step."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration):
        self.scores.append(float(net._score))


def _record_scores(net):
    """The port's score after every optimizer step (one per segment)."""
    scores = []
    step = net._train_step

    def recording(loss_fn):
        carries = step(loss_fn)
        scores.append(net.score())
        return carries

    net._train_step = recording
    return scores


@pytest.fixture(scope="module")
def char_runs(J):
    """The reference's char-RNN in each case: initial parameters (the same
    draws in every case), every segment's score and the flat parameters
    after each of two `fit` calls on the first batch."""
    x, y = _char_batches()[0]
    runs = {}
    for case in CHAR_CASES:
        net = J.Net(J.char_rnn_conf(**_char_kw(case))).init()
        rec = _Scores()
        net.listeners.append(rec)
        run = {"params0": J.jax.tree.map(np.array, net._params),
               "flat0": net.params(), "after": []}
        for _ in range(2):
            net.fit(J.DataSet(x, y))
            run["after"].append(net.params())
        run["scores"] = rec.scores
        run["iterations"] = net.conf.iteration_count
        runs[case] = run
    return runs


def _port_char_rnn(runs, case="sgd-f32", device="cpu"):
    net = char_rnn(device=device, **_char_kw(case))
    return net.from_jax_params(runs[case]["params0"])


@pytest.mark.parametrize("case", ["sgd-f32", "rmsprop-f64"])
def test_char_rnn_tbptt_matches_jax(char_runs, case):
    run = char_runs[case]
    net = _port_char_rnn(char_runs, case)
    scores = _record_scores(net)
    x, y = _char_batches()[0]
    tol = 1e-5 if case == "sgd-f32" else 1e-9
    for i in range(2):
        net.fit(x, y)
        np.testing.assert_allclose(net.params(), run["after"][i], rtol=tol,
                                   atol=tol, err_msg=f"fit {i}")
    assert net.conf.iteration_count == run["iterations"] == 6
    np.testing.assert_allclose(scores, run["scores"], rtol=0, atol=tol)
    assert all(p.dtype == (torch.float64 if case == "rmsprop-f64"
                           else torch.float32) for p in net.parameters())


def test_char_rnn_bf16_within_twice_jax_bf16_error(char_runs):
    run, f32 = char_runs["sgd-bf16"], char_runs["sgd-f32"]
    net = _port_char_rnn(char_runs, "sgd-bf16")
    scores = _record_scores(net)
    x, y = _char_batches()[0]
    for _ in range(2):
        net.fit(x, y)
    assert all(np.isfinite(scores)) and len(scores) == 6
    _within_bf16_limit(scores, run["scores"], f32["scores"], "scores")
    _within_bf16_limit(net.params(), run["after"][-1], f32["after"][-1],
                       "params")


def _within_bf16_limit(port_bf16, ref_bf16, ref_f32, what):
    ref_f32 = np.asarray(ref_f32, np.float64)
    limit = max(2 * np.abs(np.asarray(ref_bf16, np.float64) - ref_f32).max(),
                2.0 ** -8 * np.abs(ref_f32).max())
    err = np.abs(np.asarray(port_bf16, np.float64) - ref_f32).max()
    assert err <= limit, f"{what}: bf16 error {err} over {limit}"


def test_char_rnn_conf_json_both_ways(J):
    for kw in ({}, dict(vocab_size=V, hidden=HID, layers=3, tbptt_length=7,
                        data_type="bfloat16", scan_unroll=2)):
        ref = J.char_rnn_conf(**kw).to_json()
        mine = char_rnn_conf(**kw).to_json()
        assert mine == ref
        assert MultiLayerConfiguration.from_json(ref).to_json() == ref
        assert J.Conf.from_json(mine).to_json() == mine
    conf = char_rnn_conf()
    assert (conf.backprop_type, conf.tbptt_fwd_length,
            conf.tbptt_back_length) == ("tbptt", 50, 50)
    assert [l.n_out for l in conf.layers] == [200, 200, 77]


def test_from_jax_params_keeps_the_recurrent_layout(J, char_runs):
    """The bridge copies W [nIn, 4H], RW [H, 4H], b, peep as they are: the
    flat parameters (`_param_sort_key`: W, RW, b, then peep) are the
    reference's, bit for bit, and so is every leaf."""
    run = char_runs["sgd-f32"]
    net = _port_char_rnn(char_runs)
    np.testing.assert_array_equal(net.params(), run["flat0"])
    for i, layer in enumerate(run["params0"]):
        for k, v in layer.items():
            np.testing.assert_array_equal(
                net._params[i][k].detach().numpy(), v)


def test_rnn_time_step_matches_jax_and_the_full_output(J, char_runs):
    ref = J.Net(J.char_rnn_conf(**_char_kw())).init()
    net = _port_char_rnn(char_runs)
    x, _ = _char_batches()[1]
    full = net.output(x)
    _close(full, np.asarray(ref.output(x)), 1e-5, "output")
    steps = []
    for t in range(SEQ):
        got = net.rnn_time_step(x[:, t])
        assert got.shape == (NB, V)
        _close(got, np.asarray(ref.rnn_time_step(x[:, t])), 1e-5, f"step {t}")
        steps.append(got)
    _close(np.stack(steps, 1), full, 1e-5, "chained")
    # a run of steps continues from the held state too
    net.rnn_clear_previous_state()
    head = net.rnn_time_step(x[:, :5])
    tail = net.rnn_time_step(x[:, 5:])
    assert head.shape == (NB, 5, V)
    _close(np.concatenate([head, tail], 1), full, 1e-5, "runs")


def test_rnn_clear_previous_state(char_runs):
    net = _port_char_rnn(char_runs)
    x, _ = _char_batches()[1]
    first = net.rnn_time_step(x[:, 0])
    second = net.rnn_time_step(x[:, 0])
    assert not np.allclose(first, second)       # the state moved on
    assert set(net._rnn_state) == {0, 1}
    net.rnnClearPreviousState()
    assert net._rnn_state is None
    np.testing.assert_array_equal(net.rnnTimeStep(x[:, 0]), first)


def test_tbptt_fit_over_an_iterator_with_masks_matches_jax(J, char_runs):
    """Two batches through each package's iterator, one with a features
    and a labels mask (sliced per segment like the sequence)."""
    fmask = np.ones((NB, SEQ), np.float32)
    fmask[1, 9:] = 0.0
    lmask = fmask.copy()
    lmask[2, :3] = 0.0
    (x0, y0), (x1, y1) = _char_batches()
    ref = J.Net(J.char_rnn_conf(**_char_kw("rmsprop-f64"))).init()
    ref.fit(J.ListIt([J.DataSet(x0, y0),
                      J.DataSet(x1, y1, fmask, lmask)]))
    net = _port_char_rnn(char_runs, "rmsprop-f64")
    net.fit(ListDataSetIterator([DataSet(x0, y0),
                                 DataSet(x1, y1, fmask, lmask)]))
    assert net.conf.iteration_count == ref.conf.iteration_count == 6
    assert abs(net.score() - float(ref._score)) <= 1e-9
    np.testing.assert_allclose(net.params(), ref.params(), rtol=1e-9,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# ComputationGraph (the reference's pins, tests/test_roc_solvers_cgrnn.py)
# ---------------------------------------------------------------------------

def _graph_conf(builder, lstm, out, input_type, tbptt=False,
                data_type="float32"):
    gb = (builder().seed(5).updater("adam").learning_rate(0.01)
          .data_type(data_type)
          .graph_builder()
          .add_inputs("in")
          .add_layer("lstm", lstm(n_out=8, activation="tanh"), "in")
          .add_layer("out", out(n_out=3, activation="softmax",
                                loss_function="mcxent"), "lstm")
          .set_outputs("out")
          .set_input_types(input_type.recurrent(4)))
    if tbptt:
        gb.backprop_type("tbptt").t_bptt_forward_length(5)
    return gb.build()


def _graphs(J, tbptt=False, data_type="float32"):
    ref = J.Graph(_graph_conf(J.NNC.Builder, J.layers.GravesLSTM,
                              J.layers.RnnOutputLayer, J.InputType, tbptt,
                              data_type)).init()
    conf = _graph_conf(NeuralNetConfiguration.Builder, TLy.GravesLSTM,
                       TLy.RnnOutputLayer, InputType, tbptt, data_type)
    assert conf.to_json() == ref.conf.to_json()
    net = ComputationGraph(conf, device="cpu").init()
    return ref, net.from_jax_params(J.jax.tree.map(np.array, ref._params))


def test_graph_tbptt_iteration_count(J):
    _, net = _graphs(J, tbptt=True)
    r = np.random.default_rng(0)
    x = r.random((2, 20, 4)).astype(np.float32)
    y = np.zeros((2, 20, 3), np.float32)
    y[:, :, 0] = 1.0
    net.fit(MultiDataSet([x], [y]))
    assert net.conf.iteration_count == 4   # 20 / 5 segments
    assert np.isfinite(net.score())


@pytest.mark.parametrize("over", ["dataset", "iterator"])
def test_graph_tbptt_matches_jax(J, over):
    """float64 (Adam, as tests/test_torch_multilayer.py): T=12, tbptt 5."""
    ref, net = _graphs(J, tbptt=True, data_type="float64")
    x = _rand(80, (2, 12, 4))
    y = _one_hot(81, 2, 12, 3)
    if over == "dataset":
        ref.fit(J.MultiDataSet([x], [y]))
        net.fit(MultiDataSet([x], [y]))
    else:
        ref.fit(J.ListIt([J.DataSet(x, y), J.DataSet(x[::-1], y)]))
        net.fit(ListDataSetIterator([DataSet(x, y), DataSet(x[::-1], y)]))
    assert net.conf.iteration_count == ref.conf.iteration_count
    assert net.conf.iteration_count == (3 if over == "dataset" else 6)
    np.testing.assert_allclose(net.params(), ref.params(), rtol=1e-9,
                               atol=1e-9)


def test_graph_rnn_time_step_matches_full_output(J):
    ref, net = _graphs(J)
    r = np.random.default_rng(1)
    x = r.random((2, 6, 4)).astype(np.float32)
    full = net.output(x)[0]
    _close(full, np.asarray(ref.output(x)[0]), 1e-5, "output")
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(x[:, t])[0] for t in range(6)]
    assert steps[0].shape == (2, 3)
    np.testing.assert_allclose(np.stack(steps, axis=1), full, rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="batch size changed"):
        net.rnn_time_step(x[:1, 0])
    net.rnn_clear_previous_state()
    assert net.rnn_time_step(x[:1, 0])[0].shape == (1, 3)


# ---------------------------------------------------------------------------
# Golden lstm.zip and the port's recurrent zips
# ---------------------------------------------------------------------------

def test_golden_lstm_zip_restores_exactly(J):
    path = os.path.join(GOLDEN, "lstm.zip")
    io = np.load(os.path.join(GOLDEN, "lstm_io.npz"))
    net = TS.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(net.params(), io["params"])
    np.testing.assert_allclose(net.output(io["x"]), io["y"], rtol=0,
                               atol=1e-5)
    ref = J.ser.restore_multi_layer_network(path)
    want = J.jax.tree_util.tree_leaves(ref._updater_state)
    got = TS.tree_leaves(net.reference_updater_state())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert net.conf.iteration_count == ref.conf.iteration_count == 3
    with zipfile.ZipFile(path) as zf:
        text = zf.read("configuration.json").decode("utf-8")
    assert (MultiLayerConfiguration.from_json(text).to_json()
            == J.Conf.from_json(text).to_json())


def test_port_written_recurrent_zip_restores_in_jax(J, char_runs, tmp_path):
    net = _port_char_rnn(char_runs, "rmsprop-f64")
    x, y = _char_batches()[0]
    net.fit(x, y)
    path = str(tmp_path / "char_rnn.zip")
    TS.write_model(net, path)
    ref = J.ser.restore_multi_layer_network(path)
    np.testing.assert_array_equal(ref.params(), net.params())
    for a, b in zip(J.jax.tree_util.tree_leaves(ref._updater_state),
                    TS.tree_leaves(net.reference_updater_state()),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert ref.conf.iteration_count == 3
    _close(net.output(x), np.asarray(ref.output(x)), 1e-5, "output")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_char_rnn_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        assert char_rnn(vocab_size=V, hidden=HID).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            char_rnn()


def test_fused_tbptt_still_raises_with_its_item():
    """Item 17 is ported: fused TBPTT takes the segments of a sequence as
    one group, bit-identical to one step a segment."""
    kw = dict(device="cpu", vocab_size=V, hidden=HID, tbptt_length=TBPTT)
    a, b = char_rnn(**kw), char_rnn(**kw).fused_steps(4)
    assert b._fused_steps == 4
    x, y = _char_batches()[0]
    for n in (a, b):
        n.fit(x, y)
    np.testing.assert_array_equal(a.params(), b.params())
    assert a.conf.iteration_count == b.conf.iteration_count
    assert b.fused_counts["groups"] >= 1


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_char_rnn_f32_on_card_matches_cpu(cuda):
    """The same seeded weights, f32 with SGD (see the module docstring),
    TF32 off (`card_numerics`): three segments a fit, two fits; every
    score and the parameters within 1e-5 (abs + rel, as against JAX); `rnn_time_step` chained equals `output`
    on the card within 1e-5."""
    x, y = _one_hot(90, 8, 12), _one_hot(91, 8, 12)
    nets = [char_rnn(device=d, vocab_size=V, hidden=HID, tbptt_length=5,
                     updater="sgd")
            for d in (cuda, "cpu")]
    np.testing.assert_array_equal(nets[0].params(), nets[1].params())
    scores = [_record_scores(n) for n in nets]
    for _ in range(2):
        for n in nets:
            n.fit(x, y)
    np.testing.assert_allclose(scores[0], scores[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(nets[0].params(), nets[1].params(),
                               rtol=1e-5, atol=1e-5)
    full = nets[0].output(x)
    steps = np.stack([nets[0].rnn_time_step(x[:, t]) for t in range(12)], 1)
    np.testing.assert_allclose(steps, full, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_golden_lstm_zip_on_card(cuda):
    io = np.load(os.path.join(GOLDEN, "lstm_io.npz"))
    net = TS.restore_multi_layer_network(os.path.join(GOLDEN, "lstm.zip"))
    assert net.device.type == "cuda"
    np.testing.assert_array_equal(net.params(), io["params"])
    np.testing.assert_allclose(net.output(io["x"]), io["y"], rtol=0,
                               atol=1e-5)
