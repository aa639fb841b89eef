"""The port's ring attention (`parallel/ring_attention.py`) against the JAX
package's.

The JAX side runs `ring_self_attention` on the 4-device CPU mesh of
tests/conftest.py (the flash route through the Pallas kernels in interpret
mode). The port runs as real ranks: one fixture starts 4 CPU processes
once per module, joined in a gloo group through a FileStore under the
test's tmp dir (no TCP port, so parallel test workers cannot collide), and
each rank runs every case on its own chunk, through the kernels' plain
versions. The same cases run again on a ring of 2: the group of global
ranks [1, 3], whose group ranks differ from their global ones. Each rank
saves its chunks and the parent concatenates them along T.

Shapes: B=2, T=32, H=2, D=16, f32 (chunks of 8 and 16). A ring of any size
computes the same global function, only the order of the f32 sums
changes, so the JAX ring of 4 is the reference for both. Tolerances: 1e-5
abs for f32 outputs and for the gradients of mean(out**2) (JAX's own
bound for its ring, tests/test_ring_attention.py); bf16 flash-route
gradients keep bf16 and lie within 0.03 of the largest f32 reference
gradient (JAX's bound for its bf16 ring backward).

The group has a 60 s timeout and the ranks 120 s to finish; then they are
killed and the fixture fails, so a hang fails tests instead of running the
suite into its time limit.

The card-only test (`gpu` marker) runs a 2-rank ring on one card over gloo
and skips without one:
    python -m pytest --noconftest tests/test_torch_ring_attention.py -m gpu
"""
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.parallel import ring_attention as ra

REPO = Path(__file__).resolve().parents[1]
B, T, H, D = 2, 32, 2, 16      # D: a head dim the kernels take
SEED, BF16_SEED = 3, 11
PAIR = [1, 3]            # the ring of 2: these global ranks
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120
# every row keeps key 0, so no row of the masked cases sees only masked keys
MASK = np.array([[1.0] * 20 + [0.0] * 12, [1.0] * 27 + [0.0] * 5], np.float32)
ROUTES = [(flash, causal) for flash in (False, True) for causal in (False,
                                                                    True)]


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _bf16_qkv():
    """bf16-representable f32 inputs, so both sides start from the same
    numbers."""
    return [torch.from_numpy(a).bfloat16().float().numpy()
            for a in _qkv(BF16_SEED)]


# ------------------------------------------------------------ rank process

def _chunk(a, n, r, dtype, device):
    t = T // n
    return torch.from_numpy(np.ascontiguousarray(a[:, r * t:(r + 1) * t])).to(
        device=device, dtype=dtype)


def _loss_and_grads(q, k, v, group, causal, flash, kv_mask=None):
    """This rank's share of mean(out**2) over the global output, and the
    gradients of the global loss for this rank's chunk."""
    q, k, v = (a.clone().requires_grad_() for a in (q, k, v))
    out = ra.ring_self_attention(q, k, v, group, causal, kv_mask, flash)
    loss = (out.float() ** 2).sum() / (B * T * H * D)
    return [out.detach(), *torch.autograd.grad(loss, (q, k, v))]


def _rank_cases(group, device):
    """Every case on this rank's chunk: {case: [tensors]}."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    q, k, v = (_chunk(a, n, r, torch.float32, device) for a in _qkv(SEED))
    mask = _chunk(MASK[:, :, None], n, r, torch.float32, device)[..., 0]
    res = {}
    for flash, causal in ROUTES:
        with torch.no_grad():
            res[f"fwd/{flash}/{causal}"] = [ra.ring_self_attention(
                q, k, v, group, causal, use_flash=flash)]
        res[f"grad/{flash}/{causal}"] = _loss_and_grads(q, k, v, group,
                                                        causal, flash)
    for causal in (False, True):
        res[f"mask/{causal}"] = _loss_and_grads(q, k, v, group, causal,
                                                False, mask)
    qb, kb, vb = (_chunk(a, n, r, torch.bfloat16, device)
                  for a in _bf16_qkv())
    res["bf16"] = _loss_and_grads(qb, kb, vb, group, True, True)
    return {key: [t.cpu() for t in val] for key, val in res.items()}


def _rank_main(rank, world, store, out_dir, device):
    """One rank: join the gloo group, run every case on the world ring and,
    in a world of 4, on the ring of 2 of the PAIR ranks; save {ring size:
    cases}."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 einsums in f32
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    pair = dist.new_group(PAIR) if world == 4 else None
    fa.reset_launches()
    results = {world: _rank_cases(None, device)}
    if pair is not None and rank in PAIR:
        results[2] = _rank_cases(pair, device)
    results["launches"] = dict(fa.launches)
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def run_ranks(world, tmp, device="cpu"):
    """Start `world` rank processes, wait up to JOIN_TIMEOUT_S and kill
    what is left; fail unless all exit 0. Returns {ring size: {case:
    [tensors over the full T]}} and each rank's launch counts."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    tmp.mkdir(parents=True, exist_ok=True)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / "store"),
         str(tmp), device], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, "\n".join(
        f"rank {r} exit {c}:\n{(tmp / f'rank{r}.log').read_text()[-3000:]}"
        for r, c in enumerate(codes))
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    rings = {}
    for n, members in ((world, range(world)), (2, PAIR))[:world // 2]:
        cases = ranks[members[0]][n]
        rings[n] = {key: [torch.cat([ranks[m][n][key][i] for m in members],
                                    1) for i in range(len(val))]
                    for key, val in cases.items()}
    return rings, [r["launches"] for r in ranks]


@pytest.fixture(scope="module")
def port_rings(tmp_path_factory):
    return run_ranks(4, tmp_path_factory.mktemp("ring"))


# --------------------------------------------------------------- reference

@pytest.fixture(scope="module")
def jax_rings():
    """The JAX ring of 4 on the same global inputs: {case: [out, dq, dk,
    dv]} as numpy (every case through one jitted value_and_grad)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deeplearning4j_tpu.parallel.ring_attention import ring_self_attention
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))

    def value_and_grad(flash, causal, mask=None):
        def loss(q, k, v):
            out = ring_self_attention(q, k, v, mesh, axis="seq",
                                      causal=causal, kv_mask=mask,
                                      use_flash=flash)
            return jnp.mean(out.astype(jnp.float32) ** 2), out
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True))

    def run(fn, qkv):
        (_, out), grads = fn(*(jnp.asarray(a) for a in qkv))
        return [np.asarray(a) for a in (out, *grads)]

    qkv = _qkv(SEED)
    ref = {}
    for flash, causal in ROUTES:
        fn = value_and_grad(flash, causal)
        ref[f"grad/{flash}/{causal}"] = run(fn, qkv)
        if flash and causal:   # the same compiled function, bf16 inputs
            ref["bf16"] = run(fn, _bf16_qkv())
    for causal in (False, True):
        ref[f"mask/{causal}"] = run(
            value_and_grad(False, causal, jnp.asarray(MASK)), qkv)
    return ref


# ------------------------------------------------------------------- tests

RING_SIZES = [4, 2]


@pytest.mark.parametrize("n", RING_SIZES)
@pytest.mark.parametrize("flash,causal", ROUTES)
def test_forward_matches_jax(port_rings, jax_rings, n, flash, causal):
    """Without grad (the flash route's primal, no lse): the output."""
    got = port_rings[0][n][f"fwd/{flash}/{causal}"][0]
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(),
                               jax_rings[f"grad/{flash}/{causal}"][0],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", RING_SIZES)
@pytest.mark.parametrize("flash,causal", ROUTES)
def test_grads_match_jax(port_rings, jax_rings, n, flash, causal):
    """With grad: the output and the gradients of mean(out**2). The flash
    route is `_RingFlashAttention` (the fused ring backward); the einsum
    route is autograd through `_PPermute`."""
    got = port_rings[0][n][f"grad/{flash}/{causal}"]
    for name, g, want in zip(("out", "dq", "dk", "dv"), got,
                             jax_rings[f"grad/{flash}/{causal}"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n", RING_SIZES)
@pytest.mark.parametrize("causal", [False, True])
def test_key_mask_matches_jax(port_rings, jax_rings, n, causal):
    """The einsum route with a key mask that rotates with K/V: output and
    gradients."""
    got = port_rings[0][n][f"mask/{causal}"]
    for name, g, want in zip(("out", "dq", "dk", "dv"), got,
                             jax_rings[f"mask/{causal}"]):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n", RING_SIZES)
def test_bf16_flash_grads_track_f32(port_rings, jax_rings, n):
    """bf16 chunks: the hops' gradients stay f32 and are rounded once, so
    the bf16 gradients track the f32 reference within 0.03 of its largest
    entry."""
    got = port_rings[0][n]["bf16"]
    for name, g, want in zip(("out", "dq", "dk", "dv"), got,
                             jax_rings["bf16"]):
        assert g.dtype == torch.bfloat16, name
        top = np.abs(want).max()
        assert top > 0
        np.testing.assert_allclose(g.float().numpy() / top, want / top,
                                   rtol=0, atol=0.03, err_msg=name)


def test_cpu_ranks_count_no_launch(port_rings):
    assert port_rings[1] == [dict.fromkeys(fa.launches, 0)] * 4


def test_flash_with_key_mask_raises():
    q = torch.zeros(B, 8, H, D)
    with pytest.raises(ValueError, match="kv_mask"):
        ra.ring_self_attention(q, q, q, use_flash=True,
                               kv_mask=torch.ones(B, 8))


def test_blockwise_attention_matches_jax():
    """The single-device reference, with the key mask and causal."""
    jnp = pytest.importorskip("jax.numpy")
    from deeplearning4j_tpu.parallel.ring_attention import blockwise_attention
    q, k, v = _qkv(SEED)
    want = blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               kv_mask=jnp.asarray(MASK), causal=True)
    got = ra.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 kv_mask=torch.from_numpy(MASK), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------- card only

@pytest.mark.gpu
def test_two_rank_ring_on_one_card(tmp_path):
    """Ranks on cuda:0 rotating through the host over gloo: every case runs
    through the kernels (K3 per hop; K4, K5 per hop of the backward) and
    agrees with the same ring on the CPU (plain versions): 1e-5 in f32
    (the kernels' FMA order); the bf16 gradients within 1e-2 of the
    largest CPU gradient (bf16 products summed in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, launches = run_ranks(2, tmp_path / "card", "cuda")
    cpu, _ = run_ranks(2, tmp_path / "cpu", "cpu")
    for key, tensors in card[2].items():
        for got, want in zip(tensors, cpu[2][key]):
            assert got.dtype == want.dtype
            if got.dtype == torch.bfloat16:
                top = want.float().abs().max()
                torch.testing.assert_close(got.float() / top,
                                           want.float() / top, rtol=0,
                                           atol=1e-2)
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # per rank, 2 hops in each flash case: 2 forwards without grad, 2 with
    # grad and the bf16 one (K3 twice each; K4, K5 twice in each backward)
    assert launches == [{"fwd": 0, "fwd_lse": 0, "partial": 10, "bwd_dq": 6,
                         "bwd_dkv": 6}] * 2


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
               sys.argv[5])
