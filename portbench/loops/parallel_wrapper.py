"""Data-parallel training through `parallel.ParallelWrapper`, one rank a
card, NCCL between them (gloo between CPU ranks in the tests).

The run's process is rank 0: it hosts the rendezvous (a TCP store on
localhost, on a port the system picks), starts ranks 1..n-1 as processes
of `run.py` and waits for each. Every rank builds the network from the
same seed, draws the same pool of global batches and feeds the wrapper
through its own AsyncDataSetIterator; the wrapper takes the rank's rows
of each global batch (SPMD). The first steps, the warm-up, the window
and the traced window are `fit.py`'s, with the wrapper's `fit` as the
call and one step count for every rank. Rank 0 gathers every rank's
readings and measurements, then, with the program freed, runs the
reference's first steps on the global batch (recomputing each block in
the backward, so that its float32 activations fit) and judges every
rank's parameters against it.
"""
from __future__ import annotations

import subprocess
import sys

import torch
import torch.distributed as dist

from .. import check, traffic as T
from ..harness import HERE, note
from ..reference import common as C
from . import fit as F

RANK_TIMEOUT_S = 300


def run(s):
    """Rank 0's run: start the other ranks, take part, wait for them."""
    world = int(s.cell.traffic["ranks"])
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          wait_for_workers=False)
    cmd = [sys.executable, str(HERE / "run.py"), *s.argv,
           "--world", str(world), "--store-port", str(store.port)]
    children = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=sys.stderr)
                for r in range(1, world)]
    try:
        out = rank_main(s, 0, world, store)
    finally:
        codes = []
        for p in children:
            try:
                codes.append(p.wait(timeout=RANK_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
    if any(codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    return out


def connect(port, world):
    """A rank's side of the rendezvous."""
    return dist.TCPStore("127.0.0.1", int(port), world, is_master=False)


def rank_main(s, rank, world, store):
    """One rank's part; rank 0 returns the run's measurements."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    cuda = torch.device(s.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        s.device = f"cuda:{rank}"
    dev = s.device
    dist.init_process_group("nccl" if cuda else "gloo", store=store,
                            rank=rank, world_size=world)
    try:
        def agree(n):
            t = torch.tensor([int(n)], device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return int(t.item())

        s.agree = agree
        s.barrier = ((lambda: dist.barrier(device_ids=[rank])) if cuda
                     else dist.barrier)
        note(f"rank {rank} joined")
        net = fam.build(cfg, C.subseed(s.seed, "program"), dev)
        host = C.to_host(C.make_params(fam.reference.leaves(cfg), s.seed,
                                       dev))
        net.from_jax_params(fam.params_tree(cfg, host))
        note(f"rank {rank}: network built, weights loaded")
        wrapper = (ParallelWrapper.Builder(net).workers(world)
                   .averaging_frequency(tr["averaging_frequency"]).build())
        data = T.pool(cfg, tr, s.seed, dev)
        prog = F.program_first_steps(s, net, wrapper.fit, data, host)
        note(f"rank {rank}: first steps read")
        del host
        mine = F.windows(s, net, wrapper.fit, data, tr["check_steps"])
        every = [None] * world
        dist.all_gather_object(every, {"prog": prog, "rank": mine})
        del net, wrapper
        F.free()
        if rank != 0:
            return None
        ref = F.reference_first_steps(s, data)
        readings = check.worst_over([check.train_readings(e["prog"], ref)
                                     for e in every])
        out = F.measured(s, [e["rank"] for e in every], readings)
        out["first_steps"] = (every[0]["prog"], ref)
        return out
    finally:
        dist.destroy_process_group()


def control(s):
    """The control's readings on the global batch, on this process's
    card."""
    return F.control(s)
