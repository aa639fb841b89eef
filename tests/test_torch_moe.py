"""The port's mixture of experts (`parallel/moe.py`, `make_moe_block_fn`)
against the JAX package's.

In the pytest process: `moe_mlp_dense` against the reference's at k=1 and
k=2, with a capacity ranked over 4 shards: the output and the aux loss at
1e-5, the expert ids equal, the gradients of sum(y * w) + aux with respect
to every parameter and to x at rtol 2e-4 / atol 2e-5; a router tie picks
the lower expert first, as `lax.top_k`; the aux of a uniform router is 1.

On 4 gloo CPU rank processes (one module fixture; each runs this file as
a script, FileStore under the tmp dir, 60 s group timeout, 150 s join):
`moe_mlp_sharded` on an ("expert",) mesh of 4 (E = 8, two a rank) at k=1
and k=2, with and without a capacity that drops units, and on a ("data",
"expert") mesh of 2 x 2 at top-2: the whole batch's output and the aux on
every rank against the reference's dense (and the port's dense) at 1e-5,
the expert ids of every rank's shard equal to the dense routing's, and the
gradients of every local parameter and of x (the replicated loss sum(y *
w) + aux on every rank) against the reference's at rtol 2e-4 / atol 2e-5;
then one SGD step of a `make_moe_block_fn` block with the sharded experts
against the reference's block with the dense ones.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mp_common as C  # noqa: E402

WORLD = 4
D, E, F, B = 16, 8, 32, 64
# name: (k, capacity, mesh (n_data, n_expert), experts)
SHARDED = {"k1": (1, None, (1, 4), E), "k1_cap": (1, 2, (1, 4), E),
           "k2": (2, None, (1, 4), E), "k2_cap": (2, 3, (1, 4), E),
           "dp_ep_k2": (2, None, (2, 2), 4)}
BLOCK_H, BLOCK_T = 2, 8


def _case(name):
    k, cap, (nd, ne), e = SHARDED[name]
    rng = np.random.default_rng(len(name) + 7 * k)
    return {"params": C.draw_moe(len(name), D, e, F),
            "x": C.normal(rng, (B, D), 1.0),
            "w": C.normal(rng, (B, D), 1.0)}


def _block_spec():
    rng = np.random.default_rng(11)
    blk = C.draw_block(rng, D, BLOCK_H, F)
    del blk["mlp"]
    blk["moe"] = C.draw_moe(12, D, E, F)
    return {"block": blk, "x": C.normal(rng, (2, BLOCK_T, D), 1.0),
            "w": C.normal(rng, (2, BLOCK_T, D), 1.0)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ------------------------------------------------------------------ ranks

def _sharded_rank(name, spec):
    from deeplearning4j_tpu_torch.parallel import moe
    k, cap, (nd, ne), e = SHARDED[name]
    mesh = moe.make_expert_mesh(ne, n_data=nd, device="cpu")
    full = moe.MoE(**_t(spec["params"]))
    local = moe.shard_moe_params(full, mesh)
    x = torch.from_numpy(spec["x"]).requires_grad_()
    apply = moe.moe_mlp_sharded(mesh, capacity=cap, k=k,
                                data_axis="data" if nd > 1 else None)
    y, aux = apply(local, x)
    names = ["gate", "w1", "b1", "w2", "b2"]
    grads = torch.autograd.grad(
        (y * torch.from_numpy(spec["w"])).sum() + aux,
        [getattr(local, n) for n in names] + [x])
    n_sh = nd * ne
    shard = mesh.index("data") * ne + mesh.index("expert")
    rows = slice(shard * B // n_sh, (shard + 1) * B // n_sh)
    ids = moe._route_topk(full.gate, x.detach()[rows], k)[0]
    y_dense, aux_dense = moe.moe_mlp_dense(full, x.detach(), cap, n_sh, k)
    return {"y": y.detach().numpy(), "aux": float(aux), "ids": ids.numpy(),
            "rows": (rows.start, rows.stop), "expert": mesh.index("expert"),
            "grads": {n: g.numpy() for n, g in zip(names + ["x"], grads)},
            "port_dense": (y_dense.detach().numpy(), float(aux_dense))}


def _block_rank(spec):
    from deeplearning4j_tpu_torch.models.zoo import transformer as T
    from deeplearning4j_tpu_torch.parallel import moe
    mesh = moe.make_expert_mesh(WORLD, device="cpu")
    blk = T.moe_block_from_jax(spec["block"], device="cpu")
    blk.moe = moe.shard_moe_params(blk.moe, mesh)
    fn = T.make_moe_block_fn(BLOCK_H, moe.moe_mlp_sharded(mesh))
    x = torch.from_numpy(spec["x"])
    y, aux = fn(blk, x)
    loss = (y * torch.from_numpy(spec["w"])).sum() + aux
    params = list(blk.parameters())
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p -= 0.1 * g
    return {"loss": float(loss), "expert": mesh.index("expert"),
            "params": {n: p.detach().numpy().copy()
                       for n, p in blk.named_parameters()}}


def _rank_main(rank, world, store, out_dir):
    C.init_rank(rank, world, store)
    specs = C.load_specs(out_dir)
    res = {name: _sharded_rank(name, specs[name]) for name in SHARDED}
    res["block"] = _block_rank(specs["block"])
    C.finish_rank(out_dir, rank, res)


# -------------------------------------------------------------- reference

def _reference(specs):
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.models.zoo import transformer as JT
    from deeplearning4j_tpu.parallel import moe as JM
    out = {}
    for name, (k, cap, (nd, ne), e) in SHARDED.items():
        spec = specs[name]
        p = jax.tree.map(jnp.asarray, spec["params"])
        x, w = jnp.asarray(spec["x"]), jnp.asarray(spec["w"])
        loss = lambda p, x: (lambda ya: jnp.sum(ya[0] * w) + ya[1])(
            JM.moe_mlp_dense(p, x, cap, nd * ne, k))
        y, aux = jax.jit(JM.moe_mlp_dense, static_argnums=(2, 3, 4))(
            p, x, cap, nd * ne, k)
        g, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "ids": np.asarray(JM._route_topk(p["gate"], x, k)[0]),
                     "grads": {**jax.tree.map(np.asarray, g),
                               "x": np.asarray(gx)}}
    spec = specs["block"]
    blk = jax.tree.map(jnp.asarray, spec["block"])
    fn = JT.make_moe_block_fn(BLOCK_H, JM.moe_mlp_dense)
    w = jnp.asarray(spec["w"])

    def loss(p):
        y, aux = fn(p, jnp.asarray(spec["x"]))
        return jnp.sum(y * w) + aux

    lv, g = jax.jit(jax.value_and_grad(loss))(blk)
    new = jax.tree.map(lambda a, b: a - 0.1 * b, blk, g)
    out["block"] = {"loss": float(lv),
                    "params": C.flat(jax.tree.map(np.asarray, new))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    specs = {name: _case(name) for name in SHARDED}
    specs["block"] = _block_spec()
    ref, ranks = C.run_ranks(tmp_path_factory.mktemp("moe"), __file__,
                             WORLD, specs, lambda: _reference(specs))
    return specs, ref, ranks


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_matches_the_reference(runs, name):
    _, ref, ranks = runs
    want = ref[name]
    k, cap, (nd, ne), e = SHARDED[name]
    per = e // ne
    for r in ranks:
        got = r[name]
        C.close(got["y"], want["y"], 0, C.TOL, "y")
        assert abs(got["aux"] - want["aux"]) < C.TOL
        C.close(got["port_dense"][0], got["y"], 0, C.TOL, "port dense")
        assert abs(got["port_dense"][1] - got["aux"]) < C.TOL
        lo, hi = got["rows"]
        np.testing.assert_array_equal(got["ids"], want["ids"][lo:hi])
        ex = slice(got["expert"] * per, (got["expert"] + 1) * per)
        for n, g in got["grads"].items():
            w = want["grads"][n]
            C.close(g, w if n in ("gate", "x") else w[ex], what=n)
    if cap is not None:   # the capacity really drops units
        y_free = ref[name.replace("_cap", "")]["y"]
        assert np.abs(want["y"] - y_free).max() > 1e-3


def test_moe_block_step_with_sharded_experts(runs):
    _, ref, ranks = runs
    want = ref["block"]
    for r in ranks:
        got = r["block"]
        assert abs(got["loss"] - want["loss"]) < 1e-4 * abs(want["loss"])
        ex = slice(got["expert"] * 2, got["expert"] * 2 + 2)
        for n, p in got["params"].items():
            w = want["params"][n]
            if n.startswith("moe.") and n != "moe.gate":
                w = w[ex]
            C.close(p, w, what=n)


# ---------------------------------------------- the dense path, in-process

@pytest.mark.parametrize("k,cap", [(1, None), (2, None), (1, 3), (2, 5)])
def test_dense_matches_the_reference(k, cap):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import moe as JM

    from deeplearning4j_tpu_torch.parallel import moe
    p = C.draw_moe(k + 3, D, E, F)
    rng = np.random.default_rng(k)
    x, w = C.normal(rng, (B, D), 1.0), C.normal(rng, (B, D), 1.0)
    jp = jax.tree.map(jnp.asarray, p)
    jl = lambda p, x: (lambda ya: jnp.sum(ya[0] * w) + ya[1])(
        JM.moe_mlp_dense(p, x, cap, 4, k))
    jy, jaux = JM.moe_mlp_dense(jp, jnp.asarray(x), cap, 4, k)
    jg, jgx = jax.grad(jl, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = moe.MoE(**_t(p))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_mlp_dense(tp, tx, cap, 4, k)
    names = ["gate", "w1", "b1", "w2", "b2"]
    g = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                            [getattr(tp, n) for n in names] + [tx])
    C.close(y.detach(), jy, 0, C.TOL, "y")
    assert abs(float(aux.detach()) - float(jaux)) < C.TOL
    np.testing.assert_array_equal(
        moe._route_topk(tp.gate, tx.detach(), k)[0].numpy(),
        np.asarray(JM._route_topk(jp["gate"], jnp.asarray(x), k)[0]))
    for n, gt in zip(names + ["x"], g):
        C.close(gt, jgx if n == "x" else jg[n], what=n)


def test_router_tie_picks_the_lower_expert_and_uniform_aux_is_one():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import moe as JM

    from deeplearning4j_tpu_torch.parallel import moe
    gate = np.zeros((D, E), np.float32)          # every prob 1/E: a tie
    x = np.random.default_rng(0).standard_normal((8, D)).astype(np.float32)
    for k in (1, 2):
        ids = moe._route_topk(torch.from_numpy(gate), torch.from_numpy(x),
                              k)[0].numpy()
        want = np.asarray(JM._route_topk(jnp.asarray(gate), jnp.asarray(x),
                                         k)[0])
        np.testing.assert_array_equal(ids, want)
        assert (ids == np.arange(k)).all()
    probs = torch.full((E * 4, E), 1.0 / E)
    expert = torch.arange(E * 4) % E
    assert abs(float(moe.load_balance_loss(probs, expert, E)) - 1.0) < 1e-6


@pytest.fixture
def cuda():
    return C.cuda_or_skip()


@pytest.mark.gpu
def test_one_rank_expert_layer_on_the_card_is_dense(cuda):
    """An expert mesh of one rank on the card (every expert local): the
    sharded apply equals the dense layer, k=1 and k=2 with a capacity,
    f32 1e-5."""
    from deeplearning4j_tpu_torch.parallel import moe
    mesh = moe.make_expert_mesh(1, device=cuda)
    p = moe.MoE(**{k: v.to(cuda) for k, v in _t(C.draw_moe(1, D, E,
                                                           F)).items()})
    x = torch.from_numpy(C.normal(np.random.default_rng(0), (B, D),
                                  1.0)).to(cuda)
    for k, cap in ((1, None), (2, 12)):
        y, aux = moe.moe_mlp_sharded(mesh, capacity=cap, k=k)(
            moe.shard_moe_params(p, mesh), x)
        yd, auxd = moe.moe_mlp_dense(p, x, cap, 1, k)
        C.close(y.detach().cpu(), yd.detach().cpu(), 0, C.TOL)
        assert abs(float(aux.detach()) - float(auxd.detach())) < C.TOL


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
