"""Fused multi-step training, K optimizer steps per dispatch: port of
deeplearning4j_tpu/nn/fused.py.

The fit loops of both containers stage K batches (the AsyncDataSetIterator
machinery, unchanged), copy them into the group's K static batch buffers
and run the container's one step body K times in order over them: the
dropout draws, the learning rate of each inner step, the updaters and (when
armed) the training-health gate all run inside, exactly as they run step by
step. On the CPU that is a loop over the step body. On the card the K steps
are captured once as one CUDA graph (`CapturedGroup`) per (K, batch
signature), or per (K, segment length, shapes) for truncated BPTT, and a
group is one replay: one dispatch. On a CUDA network a group that cannot be
captured raises; only the reference's single-step cases run eagerly (a
ragged tail, mixed batch shapes, `num_iterations != 1`).

Contracts (pinned by tests/test_torch_fused_steps.py and chip_smoke.py's
phase 26):

  * `fused_steps(K)` is bit-identical to K sequential steps: parameters,
    updater state, layer state, the generator's stream, the counters, the
    health counters. The loop body is the single step; nothing is
    reassociated. The learning rates of the K inner steps are filled into a
    device buffer by the host before each group, and the single step reads
    its rate from the same kind of buffer.
  * The health scalars of every inner step come back stacked; the host
    classifies them step by step after the group (`common.health.
    finish_fused`), with one device-to-host copy a group.
  * With a health checkpoint seam, groups are clipped at checkpoint
    boundaries, so the cadence stays counted in optimizer steps.
"""
from __future__ import annotations

import torch

from .. import obs


def batch_signature(ds):
    """Shape and dtype signature of a DataSet/MultiDataSet (or of a device
    batch tuple), deciding whether K staged batches can share one fused
    group. Reads shapes off the arrays without copying them."""
    def sig(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return tuple(sig(x) for x in a)
        if isinstance(a, dict):
            return tuple(sorted((k, sig(v)) for k, v in a.items()))
        return (tuple(a.shape), str(getattr(a, "dtype", "")))

    if isinstance(ds, tuple):
        return sig(ds)
    masks = (getattr(ds, "features_mask", None),
             getattr(ds, "labels_mask", None),
             getattr(ds, "features_masks", None),
             getattr(ds, "labels_masks", None))
    return (sig(ds.features), sig(ds.labels), sig(masks))


def uniform_group(group):
    """True when every batch of the group has the first one's signature."""
    first = batch_signature(group[0])
    return all(batch_signature(ds) == first for ds in group[1:])


def group_size(net, k):
    """The fused group size at the net's current position: `k`, clipped to
    the next health-checkpoint boundary when the watchdog has a checkpoint
    seam (a due checkpoint must save the exact post-step state, which only
    exists between groups, and the cadence stays counted in optimizer
    steps)."""
    if getattr(net, "_health_ckpt", None) is None:
        return k
    every = net._health_ckpt_every
    done = int(net.conf.iteration_count) % every
    return max(1, min(k, every - done))


def install(net, k):
    """The one implementation behind both containers' `fused_steps`: record
    K and drop the captured groups."""
    k = max(1, int(k))
    if k != getattr(net, "_fused_steps", 1):
        net._fused_steps = k
        net._fused_cache = None
    return net


def fused_program(net, key, builder):
    """The net's cache of fused groups, dropped when the health watchdog is
    armed or disarmed (`_health_gen`). A build is the rare, expensive event
    a trace must show (`train.compile`)."""
    gen = getattr(net, "_health_gen", 0)
    cache = getattr(net, "_fused_cache", None)
    if cache is None or cache.get("gen") != gen:
        cache = {"gen": gen}
        net._fused_cache = cache
    if key not in cache:
        with obs.TRACER.span("train.compile", cat="train", key=repr(key)):
            cache[key] = builder()
    return cache[key]


def tree_map(fn, tree):
    """fn over the tensors of a batch tree (tuples, lists, dicts, None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_zip(fn, trees):
    """fn over matching tensors of same-structured batch trees."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        out = [tree_zip(fn, [t[i] for t in trees])
               for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    if isinstance(first, dict):
        return {k: tree_zip(fn, [t[k] for t in trees]) for k in first}
    return fn(trees)


class CapturedGroup:
    """One fused group captured as a CUDA graph.

    `run(static)` is the group's body over the static input buffers (a
    dict of tensors and trees of tensors); it returns the group's outputs.
    It runs once eagerly on a side stream to warm the libraries (cuBLAS
    workspaces, cuDNN's algorithm search, which cannot run under capture)
    inside `preserve`, which puts back every state the warm-up moved, then
    once under capture. The network's dropout generator is registered with
    the graph, so each replay draws fresh Philox offsets, as eager steps
    would. `replay(values)` copies the new inputs into the static buffers
    (each value a tree shaped as its buffer) and replays: one dispatch.

    `held` lists the tensors the graph reads and writes in place (the
    parameters, the updater and layer state); `valid(held)` is False once
    the network holds other tensor objects, and the group is then captured
    again."""

    def __init__(self, run, static, held, generator, preserve):
        self.static = static
        self.lr_rows = None      # the rates static["lr"] holds
        self.held = list(held)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with preserve():
            with torch.cuda.stream(side):
                run(static)
            torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with preserve():
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = run(static)

    def valid(self, held):
        return len(held) == len(self.held) and all(
            a is b for a, b in zip(held, self.held))

    def replay(self, values):
        for name, v in values.items():
            tree_zip(lambda pair: pair[0].copy_(pair[1]),
                     [self.static[name], v])
        self.graph.replay()
        return self.out
