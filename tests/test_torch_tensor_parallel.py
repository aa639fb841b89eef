"""The port's tensor parallelism against the JAX package's: the Megatron
block (`make_tp_block_fn`), the three-axis (data, model, pipe) pipeline,
and the wrapper's `.tensor_parallel(True)` / `.sharded_updater_state(True)`.

The reference runs on tests/conftest.py's virtual CPU devices; the port as
4 gloo CPU rank processes started by one module fixture (each runs this
file as a script, FileStore under the tmp dir, a 60 s group timeout and a
150 s join, then a kill). The same numpy weights go to both (the wrapper's
nets: the reference's draws, moved with `from_jax_params`).

Held:
- the TP block on a ("data", "model") mesh of 2 x 2 (model groups {0, 1},
  {2, 3}): its output against the reference's block under `shard_map` and
  against the dense block at 1e-5; its gradients (each rank's slices of
  wqkv, wo, w1, b1, w2, the whole LayerNorms and b2, and x) against the
  dense block's gradient in the TP layout at rtol 2e-4 / atol 2e-5, and the
  replicated ones bit-equal across the model ranks;
- three-axis (data 1, model 2, pipe 2): the loss of each of 3 steps
  (momentum 0.9) at 1e-5, every stage's parameters after them at rtol
  2e-4 / atol 2e-5, and the loss falling over 10 steps;
- the wrapper on (data 2, model 2), where each split layer computes its
  columns: LeNet-shaped conv net with Adam, TP + ZeRO, an SGD net with
  ClipL2PerLayer under TP, and (SPLIT_CASES) Embedding -> Dense ->
  Output, AutoEncoder -> Output, a ComputationGraph with BatchNorm and an
  add vertex, the conv net with L2 and the health watchdog, and a net
  whose middle layer does not divide: parameters and score after the
  first batch at 1e-5 and after 3 epochs at rtol 2e-4 / atol 2e-5 against
  the reference's wrapper on the same mesh; each rank holds half of every
  split leaf during the fit and the whole network after it; a
  StatsListener on rank 0 alone reads the whole parameters during the
  TP + ZeRO fit (its reports those of the replicated fit, 1e-5);
- inside the port: ZeRO on 4 data ranks bit-equal to the replicated run,
  TP on (2, 2) within 1e-5 of it; `lower_step` leaves the network bit-
  unchanged and records what a real step records; under FlopCounterMode
  a TP step counts half the FLOPs of the replicated step on the same rows
  (within 1%), and it all-gathers the pre-activations over "model", never
  a parameter.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mp_common as C  # noqa: E402

WORLD = 4
V, D, H, F, T_LEN = 11, 16, 4, 32, 8
WRAP_CASES = {"tp_zero_adam": ("adam", True, True),
              "tp_clip": ("clip", True, False)}
WRAP_OTHER = []   # on the ranks: the spec of a net of another width


def _wrap_conf(kind, seed, width=8):
    """The JAX package's net of a wrapper case (8x8x2 images, 4 classes)."""
    from deeplearning4j_tpu import (InputType, MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration)
    from deeplearning4j_tpu.nn.conf import layers as L
    b = NeuralNetConfiguration.Builder().seed(seed)
    if kind == "adam":
        b = b.updater("adam").learning_rate(1e-2)
    else:
        b = (b.updater("sgd").learning_rate(0.5)
             .gradient_normalization("ClipL2PerLayer")
             .gradient_normalization_threshold(0.05))
    conf = (b.list()
            .layer(0, L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                         activation="relu"))
            .layer(1, L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(2, L.DenseLayer(n_out=width, activation="relu"))
            .layer(3, L.OutputLayer(n_out=4, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 2)).build())
    return JNet(conf).init()


def _wrap_data():
    rng = np.random.default_rng(4)
    x = rng.normal(0.5, 1.0, (48, 8, 8, 2)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[rng.integers(0, 4, 48)]


# the wrapper cases in which more kinds of split layer compute their
# columns, each on (data 2, model 2): name -> (net, TP, ZeRO, watchdog)
SPLIT_CASES = {"embed_dense": ("embed", True, False, False),
               "autoencoder": ("autoencoder", True, True, False),
               "graph_bn_add": ("graph", True, True, False),
               "conv_l2_health": ("l2", True, True, True),
               "mixed_split": ("mixed", True, False, False)}


def _split_conf(kind, seed):
    """The JAX package's net of a SPLIT_CASES case: (a) Embedding -> Dense
    -> Output; (b) AutoEncoder -> Output (supervised: the forward is
    encode); (c) a ComputationGraph conv (no bias) -> BatchNorm, conv,
    their sum (ElementWiseVertex add) -> Dense -> Output; (d) the conv net
    of `_wrap_conf` with L2; (e) Dense(8) -> Dense(3), which does not
    divide over 2 -> Output, with ClipL2PerParamType."""
    from deeplearning4j_tpu import (ComputationGraph as JGraph, InputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration)
    from deeplearning4j_tpu.nn.conf import layers as L
    from deeplearning4j_tpu.nn.conf.graph_vertices import ElementWiseVertex
    b = NeuralNetConfiguration.Builder().seed(seed)
    out = L.OutputLayer(n_out=4, activation="softmax",
                        loss_function="mcxent")
    if kind == "graph":
        gb = (b.updater("adam").learning_rate(1e-2).graph_builder()
              .add_inputs("in"))
        # no bias before BatchNorm: its gradient is 0 but for rounding,
        # whose sign Adam's first step would follow
        gb.add_layer("c1", L.ConvolutionLayer(
            n_out=4, kernel_size=(3, 3), activation="identity",
            has_bias=False), "in")
        gb.add_layer("bn", L.BatchNormalization(activation="relu"), "c1")
        gb.add_layer("c2", L.ConvolutionLayer(
            n_out=4, kernel_size=(3, 3), activation="relu"), "in")
        gb.add_vertex("add", ElementWiseVertex("add"), "bn", "c2")
        gb.add_layer("fc", L.DenseLayer(n_out=8, activation="relu"), "add")
        gb.add_layer("out", out, "fc")
        return JGraph(gb.set_outputs("out").set_input_types(
            InputType.convolutional(8, 8, 2)).build()).init()
    if kind == "l2":
        conf = (b.updater("adam").learning_rate(1e-2).l2(1e-2).list()
                .layer(0, L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                             activation="relu"))
                .layer(1, L.SubsamplingLayer(kernel_size=(2, 2),
                                             stride=(2, 2)))
                .layer(2, L.DenseLayer(n_out=8, activation="relu"))
                .layer(3, out)
                .set_input_type(InputType.convolutional(8, 8, 2)).build())
        return JNet(conf).init()
    if kind == "embed":
        b = b.updater("adam").learning_rate(1e-2)
        hidden = [L.EmbeddingLayer(n_in=V, n_out=8, activation="identity"),
                  L.DenseLayer(n_out=8, activation="tanh")]
        n_in = InputType.feed_forward(1)
    elif kind == "autoencoder":
        b = b.updater("sgd").learning_rate(0.5)
        hidden = [L.AutoEncoder(n_out=8, activation="sigmoid")]
        n_in = InputType.feed_forward(16)
    else:
        b = (b.updater("nesterovs").momentum(0.9).learning_rate(0.1)
             .gradient_normalization("ClipL2PerParamType")
             .gradient_normalization_threshold(0.05))
        hidden = [L.DenseLayer(n_out=8, activation="relu"),
                  L.DenseLayer(n_out=3, activation="tanh")]
        n_in = InputType.feed_forward(16)
    lb = b.list()
    for i, layer in enumerate(hidden + [out]):
        lb = lb.layer(i, layer)
    return JNet(lb.set_input_type(n_in).build()).init()


def _split_data(kind):
    """48 rows of a SPLIT_CASES net's features and one-hot labels."""
    if kind in ("graph", "l2"):
        return _wrap_data()
    rng = np.random.default_rng(5)
    if kind == "embed":
        x = rng.integers(0, V, (48, 1)).astype(np.float32)
    else:
        x = rng.random((48, 16), dtype=np.float32)
    return x, np.eye(4, dtype=np.float32)[rng.integers(0, 4, 48)]


def _specs():
    rng = np.random.default_rng(1)
    block = C.draw_block(rng, D, H, F)
    aux, blocks = C.draw_lm(2, V, D, H, 2, T_LEN, F)
    x = np.random.default_rng(3).integers(0, V, (4, T_LEN))
    return {"block": {"tp": C.tp_from_dense(block, H),
                      "x": C.normal(rng, (2, T_LEN, D), 1.0),
                      "w": C.normal(rng, (2, T_LEN, D), 1.0)},
            "three": {"aux": aux,
                      "blocks": [C.tp_from_dense(b, H) for b in blocks],
                      "x": x.astype(np.int32),
                      "y": ((x + 1) % V).astype(np.int32)},
            "wrap": {}}


# ------------------------------------------------------------------ ranks

def _block_rank(spec):
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(n_data=2, n_model=2, device="cpu")
    m = mesh.index("model")
    blk = T.tp_block_from_jax(spec["tp"], m, 2, device="cpu")
    x = torch.from_numpy(spec["x"]).requires_grad_()
    out = T.make_tp_block_fn(H // 2, mesh=mesh)(blk, x)
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(spec["w"])).sum(),
                                [p for _, p in blk.named_parameters()] + [x])
    return {"model": m, "out": out.detach().numpy(),
            "grads": {n: g.numpy() for n, g in zip(names, grads)},
            "dx": grads[-1].numpy()}


def _three_rank(spec):
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallel, make_pipeline_mesh)
    mesh = make_pipeline_mesh(2, n_data=1, n_model=2, device="cpu")
    aux = T._params_from_jax(spec["aux"], [], None, torch.device("cpu"))[0]
    blocks = [T.tp_block_from_jax(b, device="cpu") for b in spec["blocks"]]
    pp = PipelineParallel(T.make_tp_block_fn(H // 2, mesh=mesh), blocks,
                          mesh, loss_fn=T.lm_loss, aux_params=aux,
                          pre_fn=T.embed_fn, n_micro=2, learning_rate=0.1,
                          momentum=0.9, param_specs=T.tp_block_specs())
    local = {n: tuple(p.shape) for n, p in pp.stage.named_parameters()}
    losses = [pp.fit_batch(spec["x"], spec["y"]) for _ in range(3)]
    stages = [{k: t.numpy() for k, t in st.items()}
              for st in pp.stage_params()]
    more = [pp.fit_batch(spec["x"], spec["y"]) for _ in range(7)]
    return {"losses": losses, "stages": stages, "more": more,
            "local": local}


def _wrap_rank(name, spec):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, mesh_cost
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    from test_torch_parallel_wrapper import port_net
    _, tp, zero = WRAP_CASES[name]
    x, y = _wrap_data()
    batches = list(DataSet(x, y).batch_by(16))

    def run(nm, tp, zero, epochs=3):
        net = port_net(spec)
        pw = (ParallelWrapper.Builder(net)
              .mesh(make_mesh(n_data=WORLD // nm, n_model=nm, device="cpu"))
              .tensor_parallel(tp).sharded_updater_state(zero).build())
        pw._ensure_sharded()
        shapes = {f"{k}.{n}": tuple(p.shape)
                  for k, per in net._params.items() for n, p in per.items()}
        ushapes = {f"{k}.{n}.{s}": tuple(t.shape)
                   for k, per in net._updater_state.items()
                   for n, st in per.items() for s, t in st.items()}
        pw.fit(ListDataSetIterator(batches[:1]))
        first = (net.params().copy(), float(net._score))
        pw.fit(ListDataSetIterator(batches), num_epochs=epochs)
        return net, pw, {"first": first, "params": net.params().copy(),
                         "score": float(net._score), "shapes": shapes,
                         "ushapes": ushapes}

    def listened(nm):
        """A fit on (data 4 / nm, model nm), TP + ZeRO when nm = 2, with a
        StatsListener on rank 0 alone: its static info and reports."""
        import torch.distributed as dist

        from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage,
                                                 StatsListener,
                                                 StatsUpdateConfiguration)
        net, store = port_net(spec), InMemoryStatsStorage()
        if dist.get_rank() == 0:
            net.set_listeners(StatsListener(store, StatsUpdateConfiguration(
                collect_histograms=True), session_id="tp"))
        (ParallelWrapper.Builder(net)
         .mesh(make_mesh(n_data=WORLD // nm, n_model=nm, device="cpu"))
         .tensor_parallel(nm > 1).sharded_updater_state(nm > 1).build()
         .fit(ListDataSetIterator(batches), num_epochs=2))
        return {"static": store.get_static_info("tp"),
                "updates": store.get_all_updates("tp")}

    out = {}
    net, pw, out["tp"] = run(2, tp, zero)
    out["whole"] = {f"{k}.{n}": tuple(p.shape)
                    for k, per in net._params.items() for n, p in per.items()}
    held = [t.detach().clone() for t in _held(net)]
    counters = (net.conf.iteration_count, float(net._score))
    lowered = pw.lower_step(batches[0])
    out["unchanged"] = (all(torch.equal(a, b) for a, b in
                            zip(held, _held(net)))
                        and counters == (net.conf.iteration_count,
                                         float(net._score)))
    pw._ensure_sharded()
    with mesh_cost.recording() as rec:          # the step alone
        pw._fit_allreduce(ListDataSetIterator(batches[:1]))
    pw._join_state()
    out["footprint"] = (lowered.footprint, rec)
    if zero:
        out["rep4"] = run(1, False, False)[2]
        out["zero4"] = run(1, False, True)[2]
        out["listened"] = {nm: listened(nm) for nm in (1, 2)}
    return out


def _split_rank(name, spec):
    """A SPLIT_CASES case on (data 2, model 2): the parameters and score
    after the first batch and after 3 epochs, and each parameter's shape
    while the state is split."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    from test_torch_parallel_wrapper import port_net
    kind, tp, zero, health = SPLIT_CASES[name]
    batches = list(DataSet(*_split_data(kind)).batch_by(16))
    net = port_net(spec)
    b = (ParallelWrapper.Builder(net)
         .mesh(make_mesh(n_data=2, n_model=2, device="cpu"))
         .tensor_parallel(tp).sharded_updater_state(zero))
    pw = (b.health_policy(True) if health else b).build()
    pw._ensure_sharded()
    shapes = {f"{k}.{n}": tuple(p.shape)
              for k, per in net._params.items() for n, p in per.items()}
    pw.fit(ListDataSetIterator(batches[:1]))
    first = (net.params().copy(), float(net._score))
    pw.fit(ListDataSetIterator(batches), num_epochs=3)
    return {"first": first, "params": net.params().copy(),
            "score": float(net._score), "shapes": shapes}


def _flops_rank(spec):
    """One step of the LeNet-shaped case on (data 2, model 2) under
    FlopCounterMode, with the split compute and replicated (each rank the
    same 8 rows whole); and what the split step all-gathers over "model":
    each gather's input shape and whether it is a parameter's storage."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel import parallel_wrapper as PWM
    from deeplearning4j_tpu_torch.parallel import sharding
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    from test_torch_parallel_wrapper import port_net
    x, y = _wrap_data()
    batch = DataSet(x[:16], y[:16])

    def wrapper(tp):
        net = port_net(spec)
        return net, (ParallelWrapper.Builder(net)
                     .mesh(make_mesh(n_data=2, n_model=2, device="cpu"))
                     .tensor_parallel(tp).sharded_updater_state(tp).build())

    out = {}
    for tp in (True, False):
        _, pw = wrapper(tp)
        with FlopCounterMode(display=False) as fc:
            pw.lower_step(batch)
        out["split" if tp else "replicated"] = fc.get_total_flops()
    net, pw = wrapper(True)
    pw._ensure_sharded()
    ptrs = {p.data_ptr() for per in net._params.values()
            for p in per.values()}
    g_m, seen, orig = pw.mesh.axis_group("model"), [], sharding.all_gather

    def spy(t, group, dim=0):
        if group is g_m:
            seen.append((tuple(t.shape), t.data_ptr() in ptrs))
        return orig(t, group, dim)

    sharding.all_gather = PWM.all_gather = spy
    try:
        pw._fit_allreduce(ListDataSetIterator([batch]))
    finally:
        sharding.all_gather = PWM.all_gather = orig
    pw._join_state()
    out["gathers"] = seen
    out["model_index"] = pw.mesh.index("model")
    dist.barrier()
    return out


def _dropout_rank():
    """Inside the port, on (data 2, model 2): a conv net whose layers all
    take input dropout (0.8 kept) and whose activation stats are armed,
    2 steps split and 2 replicated (every rank its data index's 8 rows
    whole): the parameters, the score and each layer's activation
    summaries."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    conf = (NeuralNetConfiguration.Builder().seed(9).updater("adam")
            .learning_rate(1e-2).dropout(0.8).list()
            .layer(0, L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                         activation="relu"))
            .layer(1, L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(2, L.DenseLayer(n_out=8, activation="relu"))
            .layer(3, L.OutputLayer(n_out=4, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 2)).build())
    batches = list(DataSet(*_wrap_data()).batch_by(16))[:2]
    out = {}
    for tp in (True, False):
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.collect_activation_stats(True)
        (ParallelWrapper.Builder(net)
         .mesh(make_mesh(n_data=2, n_model=2, device="cpu"))
         .tensor_parallel(tp).build().fit(ListDataSetIterator(batches)))
        out["split" if tp else "replicated"] = {
            "params": net.params().copy(), "score": float(net._score),
            "acts": [[float(a[k]) for k in ("mean", "stdev",
                                            "meanMagnitude")]
                     for a in net._last_activation_stats]}
    return out


def _remat_rank():
    """A ComputationGraph built with `remat_segments=True` under the
    split step: the message it raises."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    gb = (NeuralNetConfiguration.Builder().seed(3).graph_builder()
          .add_inputs("in"))
    gb.add_layer("d1", L.DenseLayer(n_out=8, activation="relu"), "in")
    gb.add_layer("d2", L.DenseLayer(n_out=8, activation="relu"), "d1")
    gb.add_vertex("add", ElementWiseVertex("add"), "d1", "d2")
    gb.add_layer("out", L.OutputLayer(n_out=4, activation="softmax",
                                      loss_function="mcxent"), "add")
    net = ComputationGraph(gb.set_outputs("out").set_input_types(
        InputType.feed_forward(16)).build(), remat_segments=True,
        device="cpu").init()
    x, y = _split_data("mixed")
    try:
        (ParallelWrapper.Builder(net)
         .mesh(make_mesh(n_data=2, n_model=2, device="cpu"))
         .tensor_parallel(True).build().fit(DataSet(x[:16], y[:16])))
    except ValueError as e:
        return str(e)
    return "trained"


def _held(net):
    return ([p for per in net._params.values() for p in per.values()]
            + [t for per in net._updater_state.values()
               for st in per.values() for t in st.values()]
            + [b for st in net._model_state.values() for b in st.values()])


def _w2v_rank():
    """Skip-gram with syn0 / syn1neg column-sharded over 4 "model" ranks,
    and the same learner unsharded on this rank."""
    from deeplearning4j_tpu_torch.models.embeddings.learning import SkipGram
    from deeplearning4j_tpu_torch.models.embeddings.lookup_table import \
        InMemoryLookupTable
    from deeplearning4j_tpu_torch.models.word2vec.vocab import VocabCache
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    out = {}
    for name, mesh in (("sharded", make_mesh(n_data=1, n_model=WORLD,
                                             device="cpu")),
                       ("whole", None)):
        vocab = VocabCache()
        for i in range(50):
            vocab.add_token(f"w{i}", count=5 + i % 7)
        vocab.finish()
        table = InMemoryLookupTable(vocab, vector_length=32, seed=1,
                                    negative=3,
                                    use_hs=False).reset_weights()
        sg = SkipGram(batch_pairs=128).configure(
            vocab, table, window=3, negative=3, use_hs=False, seed=1,
            mesh=mesh, device="cpu")
        if mesh is not None:
            out["local"] = tuple(sg._syn0.shape)
        rng = np.random.default_rng(2)
        for _ in range(6):
            sg.learn_sequence(rng.integers(0, 50, 64).tolist(), 0.025)
        sg.finish()
        out[name] = (table.syn0.copy(), table.syn1neg.copy())
    return out


def _ckpt_rank(spec, out_dir):
    """Sharded checkpoints between layouts: a TP + ZeRO fit checkpoints
    every round shard by shard; its last round restored into a whole net
    and into a fresh TP + ZeRO layout, a one-file checkpoint into the split
    layout, and a net of another width refused."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedCheckpointManager
    from test_torch_parallel_wrapper import port_net
    x, y = _wrap_data()
    batches = list(DataSet(x, y).batch_by(16))
    ck = str(Path(out_dir) / "shards")

    def split_wrapper(net, directory=None):
        b = (ParallelWrapper.Builder(net)
             .mesh(make_mesh(n_data=2, n_model=2, device="cpu"))
             .tensor_parallel(True).sharded_updater_state(True))
        if directory is not None:
            b = b.checkpointing(directory, keep_last=2)
        return b.build()

    net = port_net(spec)
    split_wrapper(net, ck).fit(ListDataSetIterator(batches))
    mgr = ShardedCheckpointManager(ck, keep_last=2)
    last = mgr.latest_step()
    state = lambda n: [t.detach().clone() for t in _held(n)]
    want = state(net)
    out = {"last": last, "is_dir": Path(ck, f"ckpt_{last}").is_dir(),
           "steps": mgr.steps(), "params": net.params().copy(),
           "iterations": net.conf.iteration_count}
    whole = port_net(spec)
    mgr.restore(whole, last)
    out["into_whole"] = all(torch.equal(a, b) for a, b in
                            zip(state(whole), want))
    out["counters"] = whole.conf.iteration_count == net.conf.iteration_count
    fresh = port_net(spec)
    fpw = split_wrapper(fresh)
    fpw._ensure_sharded()
    mgr.restore(fresh, last)
    fpw._join_state()
    out["into_split"] = all(torch.equal(a, b) for a, b in
                            zip(state(fresh), want))
    files = ShardedCheckpointManager(str(Path(out_dir) / "file"))
    files.save(net, 1)
    again = port_net(spec)
    apw = split_wrapper(again)
    apw._ensure_sharded()
    files.restore(again, 1)
    apw._join_state()
    out["file_into_split"] = all(torch.equal(a, b) for a, b in
                                 zip(state(again), want))
    other = port_net(WRAP_OTHER[0])
    try:
        mgr.restore(other, last)
        out["wrong"] = "restored"
    except ValueError as e:
        out["wrong"] = str(e)
    return out


def _rank_main(rank, world, store, out_dir):
    C.init_rank(rank, world, store)
    specs = C.load_specs(out_dir)
    res = {"block": _block_rank(specs["block"]),
           "three": _three_rank(specs["three"]),
           "wrap": {name: _wrap_rank(name, specs["wrap"][name])
                    for name in WRAP_CASES},
           "split": {name: _split_rank(name, specs["split"][name])
                     for name in SPLIT_CASES},
           "flops": _flops_rank(specs["wrap"]["tp_zero_adam"]),
           "dropout": _dropout_rank(),
           "remat": _remat_rank(),
           "w2v": _w2v_rank()}
    WRAP_OTHER.append(specs["other"])
    res["ckpt"] = _ckpt_rank(specs["wrap"]["tp_zero_adam"], out_dir)
    C.finish_rank(out_dir, rank, res)


# -------------------------------------------------------------- reference

def _tp_specs_unstacked():
    from jax.sharding import PartitionSpec as P
    return {"ln1": {"g": P(), "b": P()},
            "attn": {"wqkv": P("model"), "wo": P("model")},
            "ln2": {"g": P(), "b": P()},
            "mlp": {"w1": P(None, "model"), "b1": P("model"),
                    "w2": P("model", None), "b2": P()}}


def _reference_models(specs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from deeplearning4j_tpu.common.jax_compat import shard_map
    from deeplearning4j_tpu.models.zoo import transformer as JT
    from deeplearning4j_tpu.parallel.pipeline import (PipelineParallel,
                                                      make_pipeline_mesh)
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    out = {}
    b = specs["block"]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    fn = shard_map(JT.make_tp_block_fn(H // 2, "model"), mesh=mesh,
                   in_specs=(_tp_specs_unstacked(), P()), out_specs=P(),
                   check_vma=False)
    out["tp_out"] = np.asarray(jax.jit(fn)(tree(b["tp"]), b["x"]))
    # the dense block on the same numbers (the TP layout undone)
    tp = b["tp"]
    hd = D // H
    wq = np.asarray(tp["attn"]["wqkv"])             # [H, D, 3hd]
    dense = {**tp, "attn": {
        "wqkv": np.concatenate([wq[:, :, i * hd:(i + 1) * hd].transpose(
            1, 0, 2).reshape(D, D) for i in range(3)], axis=1),
        "wo": np.asarray(tp["attn"]["wo"]).reshape(D, D)}}
    blk = JT.make_block_fn(H)
    x, w = jnp.asarray(b["x"]), jnp.asarray(b["w"])
    out["dense_out"] = np.asarray(blk(tree(dense), x))
    g, dx = jax.grad(lambda p, x: jnp.sum(blk(p, x) * w),
                     argnums=(0, 1))(tree(dense), x)
    g = jax.tree.map(np.asarray, g)
    out["grads"] = C.flat(C.tp_from_dense(g, H))
    out["dx"] = np.asarray(dx)

    t = specs["three"]
    mesh3 = make_pipeline_mesh(2, n_data=1, n_model=2,
                               devices=jax.devices()[:4])
    pp = PipelineParallel(JT.make_tp_block_fn(H // 2, "model"),
                          [tree(bb) for bb in t["blocks"]], mesh3,
                          loss_fn=JT.lm_loss, aux_params=tree(t["aux"]),
                          pre_fn=JT.embed_fn, n_micro=2, data_axis="data",
                          learning_rate=0.1, momentum=0.9,
                          param_specs=JT.tp_block_specs("pipe", "model"))
    out["three_losses"] = [pp.fit_batch(t["x"], t["y"]) for _ in range(3)]
    out["three_stages"] = [C.flat(jax.tree.map(np.asarray, s))
                           for s in pp.stage_params()]
    return out


def _reference_wrapper(jnet, data, tp, zero, health=False):
    import jax

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
    from deeplearning4j_tpu.parallel import make_mesh as jmesh
    x, y = data
    bs = [JDataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 48, 16)]
    b = (JPW.Builder(jnet).mesh(jmesh(n_data=2, n_model=2,
                                      devices=jax.devices()[:4]))
         .tensor_parallel(tp).sharded_updater_state(zero))
    pw = (b.health_policy(True) if health else b).build()
    pw.fit(JList(bs[:1]))
    first = (np.asarray(jnet.params(), np.float64), float(jnet._score))
    pw.fit(JList(bs), num_epochs=3)
    return {"first": first, "params": np.asarray(jnet.params(), np.float64),
            "score": float(jnet._score)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = pytest.importorskip("jax")
    specs = _specs()
    jnets = {}

    def spec_of(jnet):
        return {"cg": isinstance(jnet._params, dict),
                "conf": jnet.conf.to_json(),
                "params": jax.tree.map(np.array, jnet._params),
                "state": jax.tree.map(np.array, jnet._model_state),
                "ustate": jax.tree.map(np.array, jnet._updater_state)}

    for i, name in enumerate(WRAP_CASES):
        jnet = jnets[name] = _wrap_conf(WRAP_CASES[name][0], seed=60 + i)
        specs["wrap"][name] = spec_of(jnet)
    specs["other"] = spec_of(_wrap_conf("adam", seed=70, width=12))
    specs["split"], split_nets = {}, {}
    for i, name in enumerate(SPLIT_CASES):
        jnet = split_nets[name] = _split_conf(SPLIT_CASES[name][0],
                                              seed=80 + i)
        specs["split"][name] = spec_of(jnet)

    def reference():
        out = _reference_models(specs)
        out["wrap"] = {n: _reference_wrapper(jnets[n], _wrap_data(),
                                             *WRAP_CASES[n][1:])
                       for n in jnets}
        out["split"] = {n: _reference_wrapper(
            split_nets[n], _split_data(SPLIT_CASES[n][0]),
            *SPLIT_CASES[n][1:]) for n in SPLIT_CASES}
        return out

    tmp = tmp_path_factory.mktemp("tp")
    ref, ranks = C.run_ranks(tmp, __file__, WORLD, specs, reference)
    specs["tmp"] = str(tmp)
    return specs, ref, ranks


def test_tp_block_against_shard_map_and_the_dense_block(runs):
    _, ref, ranks = runs
    for r in ranks:
        got = r["block"]
        C.close(got["out"], ref["tp_out"], 0, C.TOL, "vs shard_map")
        C.close(got["out"], ref["dense_out"], 0, C.TOL, "vs dense")
        C.close(got["dx"], ref["dx"], what="dx")
        m = got["model"]
        specs = {"attn.wqkv": 0, "attn.wo": 0, "mlp.w1": 1, "mlp.b1": 0,
                 "mlp.w2": 0}
        for n, g in got["grads"].items():
            want = ref["grads"][n]
            if n in specs:
                c = want.shape[specs[n]] // 2
                want = np.take(want, range(m * c, (m + 1) * c), specs[n])
            C.close(g, want, what=n)
    for a, b in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        for n in ("ln1.g", "ln1.b", "ln2.g", "ln2.b", "mlp.b2"):
            np.testing.assert_array_equal(a["block"]["grads"][n],
                                          b["block"]["grads"][n])


def test_three_axis_pipeline_matches_the_reference(runs):
    _, ref, ranks = runs
    for r in ranks:
        got = r["three"]
        np.testing.assert_allclose(got["losses"], ref["three_losses"],
                                   rtol=C.TOL, atol=C.TOL)
        for gs, ws in zip(got["stages"], ref["three_stages"]):
            for k in ws:
                C.close(gs[k], ws[k], what=k)
        assert got["more"][-1] < got["losses"][0]
        # each rank holds its head group and MLP slice
        assert got["local"]["attn.wqkv"] == (H // 2, D, 3 * D // H)
        assert got["local"]["mlp.w1"] == (D, F // 2)
        assert got["local"]["ln1.g"] == (D,)


@pytest.mark.parametrize("name", list(WRAP_CASES))
def test_wrapper_tensor_parallel_matches_the_reference(runs, name):
    _, ref, ranks = runs
    want = ref["wrap"][name]
    for r in ranks:
        got = r["wrap"][name]["tp"]
        C.close(got["first"][0], want["first"][0], 0, C.TOL, "first round")
        assert abs(got["first"][1] - want["first"][1]) < C.TOL
        C.close(got["params"], want["params"], what="3 epochs")
        assert abs(got["score"] - want["score"]) < C.TOL
        # half of every split leaf while the fit runs; whole after it
        assert got["shapes"]["0.W"] == (2, 2, 3, 3)
        assert got["shapes"]["2.W"][1] == 4 and got["shapes"]["3.b"] == (2,)
        assert r["wrap"][name]["whole"]["0.W"] == (4, 2, 3, 3)
        if WRAP_CASES[name][2]:
            assert got["ushapes"]["0.W.m"] == (1, 2, 3, 3)
            assert got["ushapes"]["0.W.t"] == ()
    np.testing.assert_array_equal(ranks[0]["wrap"][name]["tp"]["params"],
                                  ranks[3]["wrap"][name]["tp"]["params"])


def test_zero_is_the_replicated_run_bit_for_bit(runs):
    _, _, ranks = runs
    for r in ranks:
        w = r["wrap"]["tp_zero_adam"]
        np.testing.assert_array_equal(w["zero4"]["params"],
                                      w["rep4"]["params"])
        assert w["zero4"]["score"] == w["rep4"]["score"]
        assert w["zero4"]["ushapes"]["2.W.m"][0] == \
            w["rep4"]["ushapes"]["2.W.m"][0] // 4
        C.close(w["tp"]["params"], w["rep4"]["params"], 0, C.TOL, "TP")


def test_listeners_read_whole_parameters_under_tensor_parallelism(runs):
    """A StatsListener on rank 0 alone hears the TP + ZeRO fit with the
    whole parameters, as the reference's listener reads its global arrays:
    the replicated fit's parameter count and names, histograms over every
    element, and its parameter and update summaries within 1e-5 (the TP
    run is within 1e-5 of the replicated one). The other ranks hear
    nothing and still take part in the gathers."""
    _, _, ranks = runs
    rep, tp = (ranks[0]["wrap"]["tp_zero_adam"]["listened"][nm]
               for nm in (1, 2))
    assert tp["static"]["model"]["numParams"] == \
        rep["static"]["model"]["numParams"]
    assert len(tp["updates"]) == len(rep["updates"]) == 6
    for got, want in zip(tp["updates"], rep["updates"]):
        for part in ("parameters", "updates"):
            if part not in want:
                continue
            assert set(got[part]) == set(want[part])
            for name, s in got[part].items():
                w = want[part][name]
                for k in ("mean", "stdev", "meanMagnitude"):
                    assert abs(s[k] - w[k]) <= C.TOL, (part, name, k)
                assert sum(s["histogram"]["counts"]) == \
                    sum(w["histogram"]["counts"])
    assert sum(tp["updates"][-1]["parameters"]["0_W"]["histogram"]
               ["counts"]) == 4 * 2 * 3 * 3
    for r in ranks[1:]:
        assert r["wrap"]["tp_zero_adam"]["listened"][2]["updates"] == []


@pytest.mark.parametrize("name", list(WRAP_CASES))
def test_wrapper_lower_step_changes_nothing(runs, name):
    _, _, ranks = runs
    for r in ranks:
        w = r["wrap"][name]
        assert w["unchanged"]
        lowered, real = w["footprint"]
        assert lowered == real
        # the gradients' all-reduce over "data", and dX's over "model" of
        # the dense and output layers (the conv's input needs none); with
        # ClipL2PerLayer one more, of the split gradients' norms
        clip = name == "tp_clip"
        assert lowered["all-reduce"]["count"] == 3 + clip
        # the three split layers' pre-activations over "model"; with ZeRO
        # each parameter's updated slices over "data" (all six divide)
        zero = WRAP_CASES[name][2]
        assert lowered["all-gather"]["count"] == 3 + 6 * zero


# each split case's parameter shapes while split: half the output columns
# of a split layer, the rest whole (1 of "model"'s 2)
SPLIT_SHAPES = {
    "embed_dense": {"0.W": (V, 4), "0.b": (4,), "1.W": (8, 4),
                    "2.W": (8, 2)},
    "autoencoder": {"0.W": (16, 4), "0.b": (4,), "0.vb": (16,),
                    "1.W": (8, 2)},
    "graph_bn_add": {"c1.W": (2, 2, 3, 3), "c2.W": (2, 2, 3, 3),
                     "bn.gamma": (4,), "fc.W": (144, 4), "out.W": (8, 2)},
    "conv_l2_health": {"0.W": (2, 2, 3, 3), "0.b": (2,), "2.W": (36, 4),
                       "3.W": (8, 2)},
    "mixed_split": {"0.W": (16, 4), "1.W": (8, 3), "1.b": (3,),
                    "2.W": (3, 2)}}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_wrapper_splits_the_compute_of_every_layer_kind(runs, name):
    """Embedding, dense, output, autoencoder and convolution layers
    compute their columns on (data 2, model 2), in a ComputationGraph with
    BatchNorm and an add vertex too, with L2 and the health watchdog
    (penalty and norms summed over "model"), and beside a layer that does
    not divide (replicated): the parameters and score after the first
    batch at 1e-5 and after 3 epochs at rtol 2e-4 / atol 2e-5 against the
    reference's wrapper on the same mesh; every rank ends alike."""
    _, ref, ranks = runs
    want = ref["split"][name]
    for r in ranks:
        got = r["split"][name]
        C.close(got["first"][0], want["first"][0], 0, C.TOL, "first round")
        assert abs(got["first"][1] - want["first"][1]) < C.TOL
        C.close(got["params"], want["params"], what="3 epochs")
        assert abs(got["score"] - want["score"]) < C.TOL
        for key, shape in SPLIT_SHAPES[name].items():
            assert got["shapes"][key] == shape, key
    np.testing.assert_array_equal(ranks[0]["split"][name]["params"],
                                  ranks[3]["split"][name]["params"])


def test_each_rank_computes_half_the_replicated_step_s_flops(runs):
    """FlopCounterMode over one step of the LeNet-shaped net (every layer
    with parameters divides) on (data 2, model 2): with the compute split
    each rank counts 1/2 of what it counts replicated on the same 8 rows,
    within 1%."""
    _, _, ranks = runs
    for r in ranks:
        f = r["flops"]
        assert f["replicated"] > 0
        assert abs(f["split"] / f["replicated"] / 0.5 - 1.0) <= 0.01, f


def test_the_split_step_never_gathers_a_split_parameter(runs):
    """What one TP + ZeRO step all-gathers over "model": the conv, dense
    and output layers' slices of their pre-activations (8 rows each), and
    no parameter's storage."""
    _, _, ranks = runs
    for r in ranks:
        gathers = r["flops"]["gathers"]
        assert [shape for shape, _ in gathers] == [(8, 2, 6, 6), (8, 4),
                                                   (8, 2)]
        assert not any(is_param for _, is_param in gathers)


def test_split_layers_draw_one_dropout_mask_and_report_whole_stats(runs):
    """With input dropout on every layer and activation stats armed, the
    split run is the replicated run within 1e-5 (the model ranks of a data
    index draw the same keep masks from generators that agree), and its
    per-layer activation summaries are those of the whole activations."""
    _, _, ranks = runs
    for r in ranks:
        d = r["dropout"]
        C.close(d["split"]["params"], d["replicated"]["params"], 0, C.TOL,
                "dropout")
        assert abs(d["split"]["score"] - d["replicated"]["score"]) < C.TOL
        assert len(d["split"]["acts"]) == 3
        C.close(d["split"]["acts"], d["replicated"]["acts"], 0, C.TOL,
                "activation stats")


def test_remat_segments_under_the_split_step_raises(runs):
    """A recompute would run the split layers' collectives again in the
    backward: the split step refuses `remat_segments=True`, naming both,
    rather than compute whole layers."""
    _, _, ranks = runs
    for r in ranks:
        assert "remat_segments=True" in r["remat"]
        assert "tensor_parallel(True)" in r["remat"]


def test_model_sharded_word2vec_is_the_unsharded_run(runs):
    """syn0 and syn1neg column-sharded over 4 model ranks (each holds 8 of
    32 columns; the pair logits all-reduced) against the whole tables:
    1e-5 in f32, and every rank writes back the same whole tables."""
    _, _, ranks = runs
    for r in ranks:
        w = r["w2v"]
        assert w["local"] == (50, 8)
        for got, want in zip(w["sharded"], w["whole"]):
            C.close(got, want, 0, C.TOL, "tables")
    for a, b in zip(ranks[0]["w2v"]["sharded"], ranks[3]["w2v"]["sharded"]):
        np.testing.assert_array_equal(a, b)


def test_sharded_checkpoints_restore_across_layouts(runs):
    """The TP + ZeRO run's round checkpoints are directories of every
    rank's shards (retention kept 2); the last restores bit-equal into a
    whole net on 4 ranks, into a fresh split layout, and into one process
    without a group; a one-file checkpoint restores into the split layout;
    a net of another width is refused, naming the arrays."""
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedCheckpointManager
    from test_torch_parallel_wrapper import port_net
    specs, _, ranks = runs
    for r in ranks:
        c = r["ckpt"]
        assert c["is_dir"] and c["steps"] == [2, 3] and c["last"] == 3
        assert c["into_whole"] and c["counters"]
        assert c["into_split"] and c["file_into_split"]
        assert "does not match the target architecture" in c["wrong"]
        assert "params[2][W]" in c["wrong"]
    one = port_net(specs["wrap"]["tp_zero_adam"])
    ShardedCheckpointManager(str(Path(specs["tmp"]) / "shards"),
                             keep_last=2).restore(one, 3)
    np.testing.assert_array_equal(one.params(), ranks[0]["ckpt"]["params"])
    assert one.conf.iteration_count == ranks[0]["ckpt"]["iterations"]


def test_zero_with_local_steps_raises():
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    with pytest.raises(ValueError, match="averaging_frequency=1"):
        (ParallelWrapper.Builder(lenet(device="cpu")).averaging_frequency(2)
         .sharded_updater_state(True).build())


@pytest.fixture
def cuda():
    return C.cuda_or_skip()


@pytest.mark.gpu
def test_tp_block_on_the_card_is_the_dense_block(cuda):
    """One model rank holding every head: the Megatron block equals the
    dense block on the card, f32, forward and gradients 1e-5."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    gen = torch.Generator().manual_seed(0)
    dense = T.init_block(gen, 64, 4, 256, device=cuda)
    tp = T.tp_block_from_block(dense, 4)
    x = torch.randn(2, 32, 64, generator=gen).to(cuda)
    y_d = T.make_block_fn(4)(dense, x)
    y_t = T.make_tp_block_fn(4)(tp, x)
    C.close(y_t.detach().cpu(), y_d.detach().cpu(), 0, C.TOL)
    g_d = torch.autograd.grad(y_d.square().sum(), list(dense.parameters()))
    g_t = torch.autograd.grad(y_t.square().sum(), list(tp.parameters()))
    want = T.tp_layout(dict(zip([n for n, _ in dense.named_parameters()],
                                g_d)), 4)
    for (n, _), g in zip(tp.named_parameters(), g_t):
        C.close(g.cpu(), want[n].cpu(), 1e-5, 1e-5, n)


@pytest.mark.gpu
def test_wrapper_tp_and_zero_on_one_card_rank_are_fit(cuda):
    """On one rank on the card the wrapper with both options is plain
    `fit`, bit for bit (nothing to split)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    rng = np.random.default_rng(0)
    x = rng.random((16, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    a, b = lenet(device=cuda, updater="adam"), lenet(device=cuda,
                                                     updater="adam")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True      # one plan a shape
    try:
        (ParallelWrapper.Builder(a).tensor_parallel(True)
         .sharded_updater_state(True).build().fit(DataSet(x, y)))
        b.fit(DataSet(x, y))
    finally:
        torch.backends.cudnn.deterministic = prev
    np.testing.assert_array_equal(a.params(), b.params())


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
