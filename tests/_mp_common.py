"""Shared pieces of the model-parallel parity tests (test_torch_pipeline,
test_torch_tensor_parallel, test_torch_moe): weights drawn with numpy in
the reference's names and shapes (never the reference's own random init,
whose compile per shape costs seconds), a tree flattener, and the gloo rank
start-up. No JAX here: the rank processes import this module."""
import pickle
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel_wrapper import join_ranks, start_ranks  # noqa: E402

GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 150
RTOL, ATOL = 2e-4, 2e-5          # tests/test_parallel.py:77-78
TOL = 1e-5


def normal(rng, shape, std):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def draw_block(rng, d, h, f):
    """One `init_block` tree (dense layout)."""
    ln = lambda: {"g": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                  "b": normal(rng, d, 0.1)}
    return {"ln1": ln(),
            "attn": {"wqkv": normal(rng, (d, 3 * d), d ** -0.5),
                     "wo": normal(rng, (d, d), d ** -0.5)},
            "ln2": ln(),
            "mlp": {"w1": normal(rng, (d, f), d ** -0.5),
                    "b1": normal(rng, f, 0.1),
                    "w2": normal(rng, (f, d), f ** -0.5),
                    "b2": normal(rng, d, 0.1)}}


def draw_lm(seed, vocab, d, h, n_layers, max_len, f=None):
    """(aux, blocks) of `init_lm`'s names and shapes."""
    rng = np.random.default_rng(seed)
    f = f or 4 * d
    aux = {"tok": normal(rng, (vocab, d), 0.5),
           "pos": normal(rng, (max_len, d), 0.5),
           "lnf": {"g": np.ones(d, np.float32), "b": np.zeros(d, np.float32)},
           "head": normal(rng, (d, vocab), d ** -0.5)}
    return aux, [draw_block(rng, d, h, f) for _ in range(n_layers)]


def tp_from_dense(p, h):
    """A dense-layout block tree in `init_tp_block`'s layout (per-head
    wqkv [H, D, 3*hd] and wo [H, hd, D]); the same function."""
    d = p["attn"]["wo"].shape[0]
    hd = d // h
    q, k, v = np.split(p["attn"]["wqkv"], 3, axis=1)
    per = lambda a: a.reshape(d, h, hd).transpose(1, 0, 2)     # [H, D, hd]
    out = {**p, "attn": {
        "wqkv": np.ascontiguousarray(np.concatenate(
            [per(q), per(k), per(v)], axis=2)),
        "wo": np.ascontiguousarray(p["attn"]["wo"].reshape(h, hd, d))}}
    return out


def draw_moe(seed, d, e, f):
    rng = np.random.default_rng(seed)
    return {"gate": normal(rng, (d, e), d ** -0.5),
            "w1": normal(rng, (e, d, f), d ** -0.5),
            "b1": normal(rng, (e, f), 0.1),
            "w2": normal(rng, (e, f, d), f ** -0.5),
            "b2": normal(rng, (e, d), 0.1)}


def flat(tree, prefix=""):
    """{dotted name: numpy array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def init_rank(rank, world, store):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))


def finish_rank(out_dir, rank, results):
    """Write this rank's results and leave at once (the meshes hold gloo
    subgroups; the interpreter's teardown of them is not waited for)."""
    import os
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(results, fh)
    sys.stdout.flush()
    os._exit(0)


def run_ranks(tmp, script, world, specs, reference=None):
    """Pickle `specs`, start `world` ranks of `script`, run `reference()`
    meanwhile; returns (reference's result, [each rank's results])."""
    with open(tmp / "cases.pkl", "wb") as fh:
        pickle.dump(specs, fh)
    procs, logs = start_ranks(world, tmp, script=script)
    try:
        ref = reference() if reference is not None else None
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return ref, join_ranks(procs, logs, tmp,
                           time.monotonic() + JOIN_TIMEOUT_S)


def load_specs(out_dir):
    with open(Path(out_dir) / "cases.pkl", "rb") as fh:
        return pickle.load(fh)


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def cuda_or_skip():
    """The CUDA device, or a skip (decided when a test runs, never at
    import)."""
    import pytest
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
