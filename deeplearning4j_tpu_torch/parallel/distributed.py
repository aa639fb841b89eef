"""Multi-process runtime setup: port of
deeplearning4j_tpu/parallel/distributed.py over `torch.distributed`.

The reference initialises `jax.distributed` and builds a mesh over every
process's devices. Here each process is one rank of a process group, and
the mesh is that group (`sharding.DataMesh`). Nothing on the machine tells
a program of a cluster: the caller gives the coordinator's address, the
number of processes and this one's id.
"""
from __future__ import annotations

import logging
from datetime import timedelta

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, timeout_s=None):
    """Join `num_processes` ranks at `coordinator_address` ("host:port")
    as rank `process_id`; a no-op (False) for one process. The backend
    defaults to NCCL where each rank has its own card (this host has at
    least `num_processes` cards; the rank takes card process_id modulo
    their count), gloo otherwise: gloo carries CPU tensors, so ranks that
    share a card reduce through the host."""
    if num_processes is None or num_processes <= 1:
        log.info("single-process run: torch.distributed not initialized")
        return False
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if n_cards >= num_processes else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % n_cards)
    kw = {} if timeout_s is None else {"timeout": timedelta(
        seconds=float(timeout_s))}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)
    return True


def global_mesh(n_data=None, n_model=1, device=None):
    """A data mesh over every rank (the world group); see
    `sharding.make_mesh`."""
    from .sharding import make_mesh
    return make_mesh(n_data=n_data, n_model=n_model, device=device)


def process_local_batch_slice(global_batch_size):
    """This process's rows of a global batch: rank r of n feeds
    [r * B/n, (r + 1) * B/n) (all of it without a process group)."""
    if dist.is_available() and dist.is_initialized():
        n_proc, idx = dist.get_world_size(), dist.get_rank()
    else:
        n_proc, idx = 1, 0
    per = global_batch_size // n_proc
    return slice(idx * per, (idx + 1) * per)
