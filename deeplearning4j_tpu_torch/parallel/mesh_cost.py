"""Mesh-program cost telemetry: port of
deeplearning4j_tpu/parallel/mesh_cost.py.

The reference reads collective counts and bytes off a compiled XLA module's
text. The HLO parser is copied here as it is (`shape_bytes`,
`hlo_collective_footprint`, `footprint_totals`), for reading the
reference's dumps.

The port has no lowering: its programs' collectives are explicit
`torch.distributed` calls, made by the helpers of `sharding` and by
`ring_attention._ppermute`, which report each one to the active recorder by
the reference's op names (all-reduce, all-gather, all-to-all,
collective-permute), bytes being the result's bytes, as the reference
counts them. So a program's "lowering" here is one run of its step under
the recorder (`recording`, `run_recorded`): every rank runs it (the
collectives need every rank), on the program's own tensors, which are put
back bit for bit after it. `lowered_footprint(lowered)` returns
(footprint, memory): memory is the card's peak allocated bytes over that
step on CUDA, None on the CPU.
"""
from __future__ import annotations

import contextlib
import re

import torch

from . import sharding

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1,
    "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
                "collective-permute", "reduce-scatter")

# `= <result-shape-or-tuple> <op>[-start](`; -done ops alias the -start's
# buffer and must not double count
_OP_RE = re.compile(
    r"=\s+(\([^)]*\)|\S+)\s+(" + "|".join(_COLLECTIVES) + r")(-start)?\(")

_SHAPE_RE = re.compile(
    r"(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")


def shape_bytes(shape_text):
    """Total bytes of every typed array shape in an HLO type string
    (handles tuples by summing the components)."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_text):
        n = 1
        for d in m.group(2).split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[m.group(1)]
    return total


def hlo_collective_footprint(hlo_text):
    """{collective-op: {"count": n, "bytes": b}} over a compiled module's
    text. Bytes = result-shape bytes."""
    out = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m is None:
            continue
        shape = m.group(1)
        b = shape_bytes(shape)
        if m.group(3):
            # async form: the -start result tuple aliases the OPERANDS as
            # its leading components; subtract them so sync and async
            # lowerings agree. A variadic collective has N operand aliases:
            # strip trailing context scalars, then subtract the first half
            # of the remaining 2k components; an odd remainder falls back
            # to the single-operand assumption (shapes[0]).
            shapes = [sm.group(0) for sm in _SHAPE_RE.finditer(shape)]
            if len(shapes) > 1:
                core = list(shapes)
                while len(core) > 2 and core[-1] in ("u32[]", "s32[]"):
                    core.pop()
                if len(core) % 2 == 0:
                    b -= sum(shape_bytes(s) for s in core[:len(core) // 2])
                else:
                    b -= shape_bytes(shapes[0])
        rec = out.setdefault(m.group(2), {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += b
    return out


def footprint_totals(fp):
    return {"count": sum(r["count"] for r in fp.values()),
            "bytes": sum(r["bytes"] for r in fp.values())}


@contextlib.contextmanager
def recording():
    """Within it, every port collective is counted into the yielded dict
    ({op: {"count", "bytes"}})."""
    rec = {}
    sharding._RECORDERS.append(rec)
    try:
        yield rec
    finally:
        sharding._RECORDERS.remove(rec)


class Lowered:
    """One recorded step: its collective footprint and, on CUDA, the peak
    bytes allocated over it."""

    def __init__(self, footprint, memory=None):
        self.footprint = footprint
        self.memory = memory


def run_recorded(step, tensors, device=None, generators=()):
    """Run `step()` under the recorder, then put every tensor of `tensors`
    and the state of each torch.Generator of `generators` back as they
    were. Returns a `Lowered`."""
    tensors = list(tensors)
    saved = [t.detach().clone() for t in tensors]
    gen_states = [g.get_state() for g in generators]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    try:
        with recording() as rec:
            step()
        memory = None
        if cuda:
            torch.cuda.synchronize(device)
            memory = {"peak_allocated_bytes":
                      int(torch.cuda.max_memory_allocated(device))}
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        for g, s in zip(generators, gen_states):
            g.set_state(s)
    return Lowered(rec, memory)


def lowered_footprint(lowered):
    """(collective footprint, memory dict or None) of a `Lowered`."""
    return lowered.footprint, lowered.memory
