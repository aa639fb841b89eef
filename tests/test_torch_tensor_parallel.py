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
- the wrapper on (data 2, model 2), LeNet-shaped conv net with Adam, TP +
  ZeRO, and an SGD net with ClipL2PerLayer under TP: parameters and score
  after the first batch at 1e-5 and after 3 epochs at rtol 2e-4 / atol
  2e-5 against the reference's wrapper on the same mesh; each rank holds
  half of every split leaf during the fit and the whole network after it;
  a StatsListener on rank 0 alone reads the whole parameters during the
  TP + ZeRO fit (its reports those of the replicated fit, 1e-5);
- inside the port: ZeRO on 4 data ranks bit-equal to the replicated run,
  TP on (2, 2) within 1e-5 of it; `lower_step` leaves the network bit-
  unchanged and records what a real step records.
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


def _reference_wrapper(name, jnet):
    import jax

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
    from deeplearning4j_tpu.parallel import make_mesh as jmesh
    _, tp, zero = WRAP_CASES[name]
    x, y = _wrap_data()
    bs = [JDataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 48, 16)]
    pw = (JPW.Builder(jnet).mesh(jmesh(n_data=2, n_model=2,
                                       devices=jax.devices()[:4]))
          .tensor_parallel(tp).sharded_updater_state(zero).build())
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
        return {"cg": False, "conf": jnet.conf.to_json(),
                "params": jax.tree.map(np.array, jnet._params),
                "state": jax.tree.map(np.array, jnet._model_state),
                "ustate": jax.tree.map(np.array, jnet._updater_state)}

    for i, name in enumerate(WRAP_CASES):
        jnet = jnets[name] = _wrap_conf(WRAP_CASES[name][0], seed=60 + i)
        specs["wrap"][name] = spec_of(jnet)
    specs["other"] = spec_of(_wrap_conf("adam", seed=70, width=12))

    def reference():
        out = _reference_models(specs)
        out["wrap"] = {n: _reference_wrapper(n, jnets[n]) for n in jnets}
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
        assert lowered["all-reduce"]["count"] == 1
        assert lowered["all-gather"]["count"] >= 6


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
