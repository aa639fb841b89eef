"""The port's GPipe (`parallel/pipeline.py`) against the JAX package's.

The reference runs on tests/conftest.py's virtual CPU devices; the port as
4 gloo CPU rank processes started by one module fixture (each runs this
file as a script, joined through a FileStore under the tmp dir; a 60 s
group timeout and a 150 s join, then a kill, so a hang fails). The same
numpy weights and inputs go to both.

Held:
- `gpipe` over tanh MLP stages at (pipe 2) (two 2-rank meshes over
  subgroups), (pipe 4) and (data 2, pipe 2): the output at 1e-5 and every
  stage's gradient of mean(out**2) at rtol 2e-4 / atol 2e-5;
- `PipelineParallel` over the TransformerLM's blocks at (pipe 4) with
  flash stages and (data 2, pipe 2) with dense and flash stages (the
  port's plain version of the flash kernels against the Pallas kernels in
  interpret mode), three `fit_batch` steps with momentum 0.9: each step's
  loss at 1e-5, then every stage's parameters (gathered by
  `stage_params()`) and the embedding and head at rtol 2e-4 / atol 2e-5;
- `lower_step` leaves every parameter and velocity bit-unchanged, and its
  footprint equals what a real step records;
- `forward` gives every rank the whole batch's activations, equal to the
  sequential blocks.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mp_common as C  # noqa: E402

WORLD = 4
V, D, H, T_LEN = 11, 16, 2, 8
PP_CASES = {"p4_flash": (1, 4, "flash"), "d2p2_dense": (2, 2, "dense"),
            "d2p2_flash": (2, 2, "flash")}
GPIPE_CASES = {"p2": (1, 2), "p4": (1, 4), "d2p2": (2, 2)}
M = 4


def _mlp(seed, n):
    rng = np.random.default_rng(seed)
    return [{"W": C.normal(rng, (8, 8), 0.3), "b": C.normal(rng, 8, 0.1)}
            for _ in range(n)]


def _tokens(nd, seed):
    x = np.random.default_rng(seed).integers(0, V, (2 * 2 * nd, T_LEN))
    return x.astype(np.int32), ((x + 1) % V).astype(np.int32)


def _specs():
    specs = {"gpipe": {}, "pp": {}}
    for name, (nd, npipe) in GPIPE_CASES.items():
        specs["gpipe"][name] = {
            "stages": _mlp(10 + npipe, npipe),
            "x": np.random.default_rng(npipe + nd).standard_normal(
                (M, 2 * nd, 8)).astype(np.float32)}
    for name, (nd, npipe, _) in PP_CASES.items():
        aux, blocks = C.draw_lm(20 + npipe, V, D, H, npipe, T_LEN)
        x, y = _tokens(nd, 30 + nd)
        specs["pp"][name] = {"aux": aux, "blocks": blocks, "x": x, "y": y}
    return specs


# ------------------------------------------------------------------ ranks

def _mesh_for(nd, npipe, rank):
    """(data nd, pipe npipe) over every rank, or over the 2-rank subgroup
    holding this rank when the mesh is smaller than the world."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.pipeline import make_pipeline_mesh
    group = None
    if nd * npipe < WORLD:
        subs = [dist.new_group(list(range(i, i + nd * npipe)))
                for i in range(0, WORLD, nd * npipe)]
        group = subs[rank // (nd * npipe)]
    return make_pipeline_mesh(npipe, n_data=nd, group=group, device="cpu")


def _gpipe_rank(spec, nd, npipe, rank):
    from deeplearning4j_tpu_torch.parallel.pipeline import as_module, gpipe
    from deeplearning4j_tpu_torch.parallel.sharding import all_reduce_mean
    mesh = _mesh_for(nd, npipe, rank)
    s = mesh.index("pipe")
    stage = as_module({k: torch.from_numpy(v.copy())
                       for k, v in spec["stages"][s].items()})
    x = torch.from_numpy(spec["x"])
    c = x.shape[1] // nd
    x = x[:, mesh.index("data") * c:(mesh.index("data") + 1) * c]
    fn = lambda p, h: torch.tanh(h @ p["W"] + p["b"])
    out = gpipe(fn, mesh)(stage, x)
    grads = torch.autograd.grad((out ** 2).mean(), [stage.W, stage.b])
    grads = all_reduce_mean(list(grads), mesh)
    return {"stage": s, "data": mesh.index("data"), "out": out.detach(),
            "W": grads[0].numpy(), "b": grads[1].numpy()}


def _pp_rank(spec, nd, npipe, attention, rank):
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.parallel import mesh_cost
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallel
    mesh = _mesh_for(nd, npipe, rank)
    aux, blocks = T._params_from_jax(spec["aux"], spec["blocks"], None,
                                     torch.device("cpu"))
    pp = PipelineParallel(T.make_block_fn(H, attention), blocks, mesh,
                          loss_fn=T.lm_loss, aux_params=aux,
                          pre_fn=T.embed_fn, n_micro=2,
                          data_axis="data" if nd > 1 else None,
                          learning_rate=0.1, momentum=0.9)
    out = {"losses": [pp.fit_batch(spec["x"], spec["y"]) for _ in range(3)]}
    out["stages"] = [{k: t.numpy() for k, t in st.items()}
                     for st in pp.stage_params()]
    out["aux"] = {k: p.detach().numpy().copy()
                  for k, p in pp.aux.named_parameters()}
    out["forward"] = pp.forward(spec["x"]).numpy()
    held = [t.detach().clone() for t in pp._params() + pp._vel]
    lowered = pp.lower_step(spec["x"], spec["y"])
    out["unchanged"] = all(torch.equal(a, b) for a, b in
                           zip(held, pp._params() + pp._vel))
    with mesh_cost.recording() as rec:
        pp.fit_batch(spec["x"], spec["y"])
    out["footprint"] = (mesh_cost.lowered_footprint(lowered)[0], rec)
    return out


def _rank_main(rank, world, store, out_dir):
    C.init_rank(rank, world, store)
    specs = C.load_specs(out_dir)
    res = {"gpipe": {}, "pp": {}}
    for name, (nd, npipe) in GPIPE_CASES.items():
        res["gpipe"][name] = _gpipe_rank(specs["gpipe"][name], nd, npipe,
                                         rank)
    for name, (nd, npipe, attn) in PP_CASES.items():
        res["pp"][name] = _pp_rank(specs["pp"][name], nd, npipe, attn, rank)
    C.finish_rank(out_dir, rank, res)


# -------------------------------------------------------------- reference

def _reference(specs):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.models.zoo import transformer as JT
    from deeplearning4j_tpu.parallel.pipeline import (PipelineParallel,
                                                      gpipe,
                                                      make_pipeline_mesh,
                                                      stack_stage_params)
    out = {"gpipe": {}, "pp": {}}
    fn = lambda p, h: jnp.tanh(h @ p["W"] + p["b"])
    for name, (nd, npipe) in GPIPE_CASES.items():
        spec = specs["gpipe"][name]
        mesh = make_pipeline_mesh(npipe, n_data=nd,
                                  devices=jax.devices()[:nd * npipe])
        pipe = gpipe(fn, mesh, data_axis="data")
        stk = stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                  for s in spec["stages"]])
        x = jnp.asarray(spec["x"])

        def loss(p):
            y = pipe(p, x)
            return jnp.mean(y ** 2), y

        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stk)
        out["gpipe"][name] = {"out": np.asarray(y), "W": np.asarray(g["W"]),
                              "b": np.asarray(g["b"])}
    for name, (nd, npipe, attn) in PP_CASES.items():
        spec = specs["pp"][name]
        mesh = make_pipeline_mesh(npipe, n_data=nd,
                                  devices=jax.devices()[:nd * npipe])
        tree = lambda t: jax.tree.map(jnp.asarray, t)
        pp = PipelineParallel(JT.make_block_fn(H, attn),
                              [tree(b) for b in spec["blocks"]], mesh,
                              loss_fn=JT.lm_loss,
                              aux_params=tree(spec["aux"]),
                              pre_fn=JT.embed_fn, n_micro=2,
                              data_axis="data", learning_rate=0.1,
                              momentum=0.9)
        losses = [pp.fit_batch(spec["x"], spec["y"]) for _ in range(3)]
        out["pp"][name] = {
            "losses": losses,
            "stages": [C.flat(jax.tree.map(np.asarray, s))
                       for s in pp.stage_params()],
            "aux": C.flat(jax.tree.map(np.asarray, pp.aux)),
            "forward": np.asarray(pp.forward(spec["x"]))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    specs = _specs()
    ref, ranks = C.run_ranks(tmp_path_factory.mktemp("pipe"), __file__,
                             WORLD, specs, lambda: _reference(specs))
    return specs, ref, ranks


@pytest.mark.parametrize("name", list(GPIPE_CASES))
def test_gpipe_forward_and_stage_gradients(runs, name):
    _, ref, ranks = runs
    want = ref["gpipe"][name]
    for r in ranks:
        got = r["gpipe"][name]
        c = want["out"].shape[1] // GPIPE_CASES[name][0]
        d = got["data"]
        C.close(got["out"], want["out"][:, d * c:(d + 1) * c], 0, C.TOL,
                f"{name} output")
        C.close(got["W"], want["W"][got["stage"]], what=f"{name} dW")
        C.close(got["b"], want["b"][got["stage"]], what=f"{name} db")


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pipeline_parallel_three_steps(runs, name):
    _, ref, ranks = runs
    want = ref["pp"][name]
    for r in ranks:
        got = r["pp"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=C.TOL,
                                   atol=C.TOL)
        for s, (gs, ws) in enumerate(zip(got["stages"], want["stages"])):
            assert set(gs) == set(ws)
            for k in ws:
                C.close(gs[k], ws[k], what=f"{name} stage {s} {k}")
        for k in want["aux"]:
            C.close(got["aux"][k], want["aux"][k], what=f"{name} aux {k}")
        C.close(got["forward"], want["forward"], what=f"{name} forward")


def test_ranks_agree_and_lowering_changes_nothing(runs):
    _, _, ranks = runs
    for name in PP_CASES:
        for r in ranks:
            got = r["pp"][name]
            assert got["unchanged"], name
            lowered, real = got["footprint"]
            assert lowered == real and lowered["collective-permute"][
                "count"] == 2 * (2 + PP_CASES[name][1] - 1) - 1, name
        for r in ranks[1:]:
            for a, b in zip(r["pp"][name]["stages"],
                            ranks[0]["pp"][name]["stages"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])


def test_microbatch_guard_and_mesh_without_group():
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh, microbatch)
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(np.zeros((10, 3)), 4)
    assert microbatch(np.zeros((8, 3)), 4).shape == (4, 2, 3)
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_pipeline_mesh(4, device="cpu")
    mesh = make_pipeline_mesh(1, device="cpu")
    assert mesh.shape == {"data": 1, "pipe": 1} and mesh.n_ranks == 1


def test_one_rank_pipeline_is_the_sequential_model():
    """A pipe of one stage on one rank (no group): PipelineParallel is the
    TransformerLM's own fit_batch (1e-6: the embedding's gradient sums
    per microbatch)."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallel, make_pipeline_mesh)
    aux, blocks = C.draw_lm(5, V, D, H, 1, T_LEN)
    a, b = T._params_from_jax(aux, blocks, None, torch.device("cpu"))
    lm = T.TransformerLM.from_jax_params(aux, blocks, H, device="cpu",
                                         momentum=0.9)
    pp = PipelineParallel(T.make_block_fn(H), b, make_pipeline_mesh(
        1, device="cpu"), loss_fn=T.lm_loss, aux_params=a,
        pre_fn=T.embed_fn, n_micro=2, learning_rate=0.1, momentum=0.9)
    x, y = _tokens(1, 3)
    for _ in range(2):
        assert abs(pp.fit_batch(x, y) - lm.fit_batch(x, y)) < 1e-6
    for k, t in pp.stage_params()[0].items():
        C.close(t, dict(lm.blocks[0].named_parameters())[k].detach(), 0,
                1e-6, k)


@pytest.fixture
def cuda():
    return C.cuda_or_skip()


@pytest.mark.gpu
def test_one_stage_flash_pipeline_on_the_card(cuda):
    """On the card a one-stage pipeline's flash blocks run the kernels:
    M + S - 1 = 2 launches each of K2, K4, K5 per step and of K1 per
    forward; f32 against the TransformerLM's own step on the card."""
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallel, make_pipeline_mesh)
    aux, blocks = C.draw_lm(6, V, 64, 2, 1, 64)
    a, b = T._params_from_jax(aux, blocks, None, cuda)
    lm = T.TransformerLM.from_jax_params(aux, blocks, 2, attention="flash",
                                         device=cuda, momentum=0.9)
    pp = PipelineParallel(T.make_block_fn(2, "flash"), b, make_pipeline_mesh(
        1, device=cuda), loss_fn=T.lm_loss, aux_params=a, pre_fn=T.embed_fn,
        n_micro=2, learning_rate=0.1, momentum=0.9)
    x = np.random.default_rng(0).integers(0, V, (4, 64))
    fa.reset_launches()
    got = pp.fit_batch(x, (x + 1) % V)
    assert fa.launches == {"fwd": 0, "fwd_lse": 2, "partial": 0,
                           "bwd_dq": 2, "bwd_dkv": 2}
    fa.reset_launches()
    pp.forward(x)
    assert fa.launches["fwd"] == 2
    assert abs(got - lm.fit_batch(x, (x + 1) % V)) < 1e-5


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
