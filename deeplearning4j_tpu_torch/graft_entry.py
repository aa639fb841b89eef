"""The port's counterpart of the repository's `__graft_entry__.entry()`:
the flagship model's inference forward on one card.

`entry(device=None)` returns `(forward, (params, x))`: `forward(params, x)`
is the ResNet-50 ComputationGraph's inference forward (224x224x3, bf16,
1000 classes) on the given parameters (the f32 masters, keyed by vertex
name as `ComputationGraph._params` holds them; the forward casts them to
bf16), and `x` is `np.random.default_rng(0).random((8, 224, 224, 3))` as
float32 on the device, NHWC. The output is the [8, 1000] bf16 softmax.

`dryrun_multichip(n, device=None)` is the counterpart of the reference's
`dryrun_multichip`: it starts n gloo rank processes itself (a FileStore in
a temporary directory; every rank on `device`: the card unless `device`
says otherwise, so n ranks share one card; without a card it raises and
says how to ask for device="cpu") and runs every parallel mode of the port on them: the
wrapper's data + tensor parallelism with the ZeRO-style updater state,
k-step parameter averaging, ring attention (plain and flash hops), GPipe
over TransformerLM blocks, the three-axis (data, model, pipe) program,
expert-parallel MoE, dp x ep top-2 and the model-sharded Word2Vec. Each
mode's outputs are checked
(against the one-rank computation where there is one), its wall time is
taken, and its per-step collective footprint is recorded
(`parallel.mesh_cost`). It prints the reference's `MULTICHIP_COST {...}`
line and, at 4 ranks, fails when a mode's bytes or op count pass twice the
committed budget `tests/fixtures/collective_budgets_torch.json`
(UPDATE_COLLECTIVE_BUDGETS_TORCH=1 rewrites it). It returns the costs.
Where the reference picks shapes the port cannot take or a mesh that does
not exist at n ranks, the port's differ: the ring's head dimension is 16
(the flash kernels' least), and the three-axis mesh at 4 ranks is (data 1,
model 2, pipe 2) (the reference's pipe-4 choice leaves no model axis and
skips the mode). The Word2Vec mode is the reference's: syn0 and syn1neg
column-sharded over n "model" ranks.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from .common.device import card_numerics, resolve_device

BUDGET_PATH = (Path(__file__).resolve().parents[1] / "tests" / "fixtures"
               / "collective_budgets_torch.json")
# rank 0's whole result of the last `dryrun_multichip` (its costs, timings,
# losses and the flash kernels' launches on that rank)
LAST_RUN = {}


def entry(device=None):
    """(forward, (params, x)) of the ResNet-50 inference forward, on the
    card unless `device` says otherwise."""
    from .models.zoo.resnet import resnet50

    device = resolve_device(device)
    net = resnet50(height=224, width=224, channels=3, num_classes=1000,
                   data_type="bfloat16", device=device)
    params = net._params
    out_name = net.conf.network_outputs[0]

    def forward(params, x):
        with torch.no_grad(), card_numerics(net.device, net.compute_dtype):
            acts, *_ = net._apply_graph(net._cast_params(params),
                                        net._states(), net._inputs(x),
                                        train=False, rng=None)
        return acts[out_name]

    x = torch.as_tensor(np.random.default_rng(0).random((8, 224, 224, 3)),
                        dtype=torch.float32, device=device)
    return forward, (params, x)


# -- the multi-rank dry run ----------------------------------------------------

def _dryrun_rank(rank, n, store, out_path, device):
    """One rank of `dryrun_multichip`."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=120))
    code = 1
    try:
        result = _dryrun_modes(rank, n, torch.device(device))
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(result, fh)
        code = 0
    except BaseException:
        import traceback
        traceback.print_exc()
    finally:
        # the meshes hold gloo subgroups; leave without tearing them down
        # in the interpreter's shutdown (a failure exits 1)
        import sys
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _dryrun_modes(rank, n, dev):
    from .datasets.dataset import DataSet
    from .datasets.iterators import ListDataSetIterator
    from .models.zoo import transformer as T
    from .nn.conf.input_type import InputType
    from .nn.conf.layers import (ConvolutionLayer, DenseLayer, OutputLayer,
                                 SubsamplingLayer)
    from .nn.conf.neural_net_configuration import NeuralNetConfiguration
    from .nn.multilayer import MultiLayerNetwork
    from .parallel import mesh_cost, moe
    from .parallel.parallel_wrapper import ParallelWrapper
    from .parallel.pipeline import PipelineParallel, make_pipeline_mesh
    from .parallel.ring_attention import (blockwise_attention,
                                          ring_self_attention)
    from .ops import flash_attention as fa
    from .parallel.sharding import make_mesh

    fa.reset_launches()
    timings, costs = {}, {}
    t0 = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        timings[name] = round(now - t0[0], 3)
        t0[0] = now

    def cost(name, lowered):
        fp, mem = mesh_cost.lowered_footprint(lowered)
        costs[name] = {**mesh_cost.footprint_totals(fp), "ops": fp}
        if mem is not None:
            costs[name]["memory"] = mem

    def recorded(fn):
        with mesh_cost.recording() as rec:
            out = fn()
        return out, mesh_cost.Lowered(rec)

    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n_data=n // n_model, n_model=n_model, device=dev)
    conf = (NeuralNetConfiguration.Builder()
            .seed(7).updater("adam").learning_rate(1e-3).list()
            .layer(0, ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                       activation="relu"))
            .layer(1, SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(2, DenseLayer(n_out=32, activation="relu"))
            .layer(3, OutputLayer(n_out=4, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 2)).build())
    net = MultiLayerNetwork(conf, device=dev).init()
    pw = (ParallelWrapper.Builder(net).mesh(mesh).tensor_parallel(n_model > 1)
          .sharded_updater_state(True).averaging_frequency(1).build())
    rng = np.random.default_rng(0)
    B = max(8, 2 * n)
    x = rng.random((B, 8, 8, 2)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    mark("setup")
    cost("dp_tp_zero1", pw.lower_step(DataSet(x, y)))
    pw.fit(DataSet(x, y))
    assert np.isfinite(float(net._score))
    mark("dp_tp_zero1")

    pw2 = (ParallelWrapper.Builder(net)
           .mesh(make_mesh(n_data=n, n_model=1, device=dev))
           .averaging_frequency(2).build())
    halves = [DataSet(x[:B // 2], y[:B // 2]), DataSet(x[B // 2:], y[B // 2:])]
    cost("param_averaging", pw2.lower_kstep(halves))
    pw2.fit(ListDataSetIterator(halves))
    mark("param_averaging")

    # sequence parallelism: this rank's chunk of the ring against the
    # one-rank attention; then the flash hops
    r2 = np.random.default_rng(1)
    q = torch.as_tensor(r2.standard_normal((2, 4 * n, 2, 16)),
                        dtype=torch.float32, device=dev)
    c = 4
    qc = q[:, rank * c:(rank + 1) * c].contiguous()
    full = blockwise_attention(q, q, q, causal=True)[:, rank * c:
                                                     (rank + 1) * c]
    ring, lowered = recorded(lambda: ring_self_attention(qc, qc, qc,
                                                         causal=True))
    assert torch.allclose(ring, full, atol=1e-4)
    ring_f = ring_self_attention(qc, qc, qc, causal=True, use_flash=True)
    assert torch.allclose(ring_f, full, atol=1e-4)
    cost("ring_attention_sp", lowered)
    mark("ring_attention_sp")

    # GPipe over TransformerLM blocks on a ("data", "pipe") mesh
    n_pipe = 4 if n % 4 == 0 else n
    pp_mesh = make_pipeline_mesh(n_pipe, n_data=n // n_pipe, device=dev)
    aux, blocks = T.init_lm(11, d_model=16, n_heads=2, n_layers=n_pipe,
                            max_len=8, seed=3, device=dev)
    pp = PipelineParallel(T.make_block_fn(2), blocks, pp_mesh,
                          loss_fn=T.lm_loss, aux_params=aux,
                          pre_fn=T.embed_fn, n_micro=2, data_axis="data",
                          learning_rate=0.1)
    xt = rng.integers(0, 11, (2 * 2 * (n // n_pipe), 8)).astype(np.int32)
    cost("gpipe_pp", pp.lower_step(xt, (xt + 1) % 11))
    pp_loss = pp.fit_batch(xt, (xt + 1) % 11)
    assert np.isfinite(pp_loss)
    mark("gpipe_pp")

    # three axes: Megatron blocks inside the GPipe rotation
    n_pipe3 = 4 if n % 8 == 0 else 2
    rest = n // n_pipe3
    n_model3 = 2 if rest % 2 == 0 else 1
    n_data3 = rest // n_model3
    loss3 = None
    if n_model3 > 1:
        mesh3 = make_pipeline_mesh(n_pipe3, n_data=n_data3,
                                   n_model=n_model3, device=dev)
        heads3 = 2 * n_model3
        gen = torch.Generator().manual_seed(9)
        blocks3 = [T.init_tp_block(gen, 16, heads3, 32, device=dev)
                   for _ in range(n_pipe3)]
        aux3, _ = T.init_lm(11, d_model=16, n_heads=heads3, n_layers=1,
                            max_len=8, seed=9, device=dev)
        pp3 = PipelineParallel(
            T.make_tp_block_fn(2, mesh=mesh3), blocks3, mesh3,
            loss_fn=T.lm_loss, aux_params=aux3, pre_fn=T.embed_fn,
            n_micro=2, data_axis="data", learning_rate=0.1,
            param_specs=T.tp_block_specs())
        x3 = rng.integers(0, 11, (2 * 2 * n_data3, 8)).astype(np.int32)
        cost("dp_tp_pp_3axis", pp3.lower_step(x3, (x3 + 1) % 11))
        loss3 = pp3.fit_batch(x3, (x3 + 1) % 11)
        assert np.isfinite(loss3)
        assert tuple(pp3.stage.attn.wqkv.shape)[0] == heads3 // n_model3
        mark("dp_tp_pp_3axis")

    # expert parallelism: one expert a rank, against the dense layer
    ep_mesh = moe.make_expert_mesh(n, device=dev)
    gen = torch.Generator().manual_seed(0)
    moe_p = moe.init_moe(gen, 16, n, 32, device=dev)
    moe_ps = moe.shard_moe_params(moe_p, ep_mesh)
    xm = torch.as_tensor(rng.standard_normal((8 * n, 16)),
                         dtype=torch.float32, device=dev)
    with torch.no_grad():
        (y_ep, _), lowered = recorded(
            lambda: moe.moe_mlp_sharded(ep_mesh)(moe_ps, xm))
        y_ref, _ = moe.moe_mlp_dense(moe_p, xm)
    assert torch.allclose(y_ep, y_ref, atol=1e-4)
    cost("moe_ep", lowered)
    mark("moe_ep")

    if n % 2 == 0 and n >= 4:
        de_mesh = moe.make_expert_mesh(n // 2, n_data=2, device=dev)
        moe_p2 = moe.init_moe(torch.Generator().manual_seed(1), 16, n // 2,
                              32, device=dev)
        moe_ps2 = moe.shard_moe_params(moe_p2, de_mesh)
        with torch.no_grad():
            (y_de, _), lowered = recorded(lambda: moe.moe_mlp_sharded(
                de_mesh, k=2, data_axis="data")(moe_ps2, xm))
            y_de_ref, _ = moe.moe_mlp_dense(moe_p2, xm, k=2)
        assert torch.allclose(y_de, y_de_ref, atol=1e-4)
        cost("dp_ep_moe_top2", lowered)
        mark("dp_ep_moe_top2")

    # distributed Word2Vec: the tables column-sharded over "model" ranks
    from .models.embeddings.learning import SkipGram
    from .models.embeddings.lookup_table import InMemoryLookupTable
    from .models.word2vec.vocab import VocabCache
    w2v_mesh = make_mesh(n_data=1, n_model=n, device=dev)
    vocab = VocabCache()
    for i in range(50):
        vocab.add_token(f"w{i}", count=5)
    vocab.finish()
    table = InMemoryLookupTable(vocab, vector_length=8 * n, seed=1,
                                negative=3, use_hs=False).reset_weights()
    sg = SkipGram(batch_pairs=256)
    sg.configure(vocab, table, window=3, negative=3, use_hs=False, seed=1,
                 mesh=w2v_mesh, device=dev)
    r3 = np.random.default_rng(2)
    for _ in range(4):
        sg.learn_sequence(r3.integers(0, 50, 64).tolist(), 0.025)
    cost("w2v_model_sharded", sg.lower_step())
    sg.finish()
    assert np.isfinite(table.syn0).all()
    mark("w2v_model_sharded")

    # every rank runs the same programs; rank 0 reports its costs
    return {"timings_s": timings, "collectives": costs,
            "pp_loss": pp_loss, "loss3": loss3,
            "mesh": {"data": mesh.shape["data"],
                     "model": mesh.shape["model"]},
            "n_pipe": n_pipe, "axes3": [n_data3, n_model3, n_pipe3],
            "score": float(net._score), "flash_launches": dict(fa.launches)}


def dryrun_multichip(n_ranks, device=None, timeout_s=600):
    """Every parallel mode of the port on `n_ranks` gloo ranks started
    here, on the card unless `device` says otherwise; prints the MULTICHIP_COST line and checks the budget at 4 ranks
    (see the module's docstring). Ranks still running after `timeout_s`
    are killed and the run fails. Returns the rank-0 costs dict."""
    import torch.multiprocessing as mp
    n = int(n_ranks)
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "costs.json")
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(n, os.path.join(tmp, "store"),
                                       out_path, dev),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"dryrun_multichip({n}): ranks still "
                                   f"running after {timeout_s} s")
        with open(out_path) as fh:
            result = json.load(fh)
    LAST_RUN.clear()
    LAST_RUN.update(result)
    costs = result["collectives"]
    print("MULTICHIP_COST " + json.dumps({"timings_s": result["timings_s"],
                                          "collectives": costs}))
    if n == 4:
        if os.environ.get("UPDATE_COLLECTIVE_BUDGETS_TORCH") == "1":
            BUDGET_PATH.write_text(json.dumps(
                {k: {kk: vv for kk, vv in v.items() if kk != "memory"}
                 for k, v in costs.items()}, indent=1, sort_keys=True)
                + "\n")
        budget = json.loads(BUDGET_PATH.read_text())
        violations = []
        for name, got in costs.items():
            want = budget.get(name)
            if want is None:
                violations.append(f"{name}: no committed budget")
                continue
            if (got["bytes"] > 2 * max(want["bytes"], 1)
                    or got["count"] > 2 * max(want["count"], 1)):
                violations.append(
                    f"{name}: bytes {want['bytes']} -> {got['bytes']}, "
                    f"count {want['count']} -> {got['count']}")
        if violations:
            raise RuntimeError(
                "collective budget exceeded (>2x the committed fixture; "
                "regenerate with UPDATE_COLLECTIVE_BUDGETS_TORCH=1 if the "
                "change is intentional): " + "; ".join(violations))
    d3, m3, p3 = result["axes3"]
    axis3 = (f"data={d3}xmodel={m3}xpipe={p3} tp-in-pp 3-axis "
             f"(loss={result['loss3']:.3f})" if result["loss3"] is not None
             else "3-axis skipped (odd mesh)")
    print(f"dryrun_multichip({n}): ok (mesh data={result['mesh']['data']} "
          f"model={result['mesh']['model']} zero1 + seq={n} ring-attention "
          f"+ pipe={result['n_pipe']} gpipe transformer "
          f"(loss={result['pp_loss']:.3f}) + {axis3} + expert={n} moe "
          f"all_to_all + w2v model={n}, score={result['score']:.4f})")
    return costs
