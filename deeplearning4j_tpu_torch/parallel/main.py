"""Command-line multi-device training runner.

Port of deeplearning4j_tpu/parallel/main.py, the equivalent of reference
deeplearning4j-scaleout-parallelwrapper
parallelism/main/ParallelWrapperMain.java:31 (JCommander flags configuring a
ParallelWrapper over a model file + DataSetIteratorProviderFactory, optional
remote UI stats) — argparse instead of JCommander, a `module:callable`
factory instead of a reflective class name.

The port's wrapper runs one process a rank. Started by a launcher that sets
the standard RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT variables (e.g.
torchrun), each process joins that process group
(`parallel.distributed.initialize`) and trains its rows of every batch;
without them it runs world 1. Rank 0 alone reports to the UI and writes
the model. `--device` (default cuda) is where the network computes; "cpu"
runs it on the CPU.

    python -m deeplearning4j_tpu_torch.parallel.main \
        --model-path model.zip --iterator-factory mypkg.data:make_iterator \
        --averaging-frequency 1 --epochs 2 \
        --model-output-path trained.zip [--ui-url http://host:9000]
"""
from __future__ import annotations

import argparse
import importlib
import os


def _resolve_factory(spec):
    """"pkg.mod:fn" -> the callable. The reference instantiates a
    DataSetIteratorProviderFactory class reflectively
    (ParallelWrapperMain.java:60-ish `dataSetIteratorFactoryClazz`)."""
    mod, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"factory '{spec}' must be 'module:callable'")
    fn = getattr(importlib.import_module(mod), attr)
    obj = fn() if isinstance(fn, type) else fn
    # factory classes expose create(); plain callables return the iterator
    return obj.create() if hasattr(obj, "create") else obj()


def build_parser():
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.parallel.main",
        description="Configure and run multi-device training from the "
                    "command line (ParallelWrapperMain equivalent)")
    p.add_argument("--model-path", required=True,
                   help="model file (any ModelSerializer/ModelGuesser "
                        "loadable format)")
    p.add_argument("--iterator-factory", required=True,
                   help="module:callable returning a DataSetIterator")
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--averaging-frequency", type=int, default=1)
    p.add_argument("--no-average-updaters", action="store_true")
    p.add_argument("--tensor-parallel", action="store_true")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--model-output-path", default=None,
                   help="where to save the trained model zip")
    p.add_argument("--ui-url", default=None,
                   help="remote UI server base URL to POST stats to "
                        "(RemoteUIStatsStorageRouter role)")
    p.add_argument("--report-score", action="store_true",
                   help="print the score after each epoch")
    p.add_argument("--device", default="cuda",
                   help="where the network computes: cuda (default) or cpu")
    return p


def _join_group(device):
    """Join the process group the launcher's RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT describe; (rank, joined). Without them (or
    with a world of 1): (0, False). A network on the CPU joins over gloo,
    whatever cards the host has (NCCL carries CUDA tensors only)."""
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    if world <= 1 or not all(k in env for k in ("RANK", "MASTER_ADDR",
                                                  "MASTER_PORT")):
        return 0, False
    import torch

    from .distributed import initialize
    rank = int(env["RANK"])
    backend = "gloo" if torch.device(device).type == "cpu" else None
    initialize(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", world, rank,
               backend=backend)
    return rank, True


def run(argv=None):
    args = build_parser().parse_args(argv)

    from ..util.model_guesser import load_model_guess
    from ..util.model_serializer import write_model
    from .parallel_wrapper import ParallelWrapper

    rank, joined = _join_group(args.device)
    try:
        net = load_model_guess(args.model_path, device=args.device)
        if args.ui_url and rank == 0:
            from ..ui import RemoteUIStatsStorageRouter, StatsListener
            net.set_listeners(StatsListener(
                RemoteUIStatsStorageRouter(args.ui_url)))

        it = _resolve_factory(args.iterator_factory)
        pw = ParallelWrapper(
            net, workers=args.workers,
            averaging_frequency=args.averaging_frequency,
            average_updaters=not args.no_average_updaters,
            tensor_parallel=args.tensor_parallel)
        for epoch in range(args.epochs):   # fit() resets the iterator
            pw.fit(it)
            if args.report_score and rank == 0:
                print(f"epoch {epoch}: score={float(net.score()):.6f}",
                      flush=True)
        if args.model_output_path and rank == 0:
            write_model(net, args.model_output_path, save_updater=True)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
    return net


if __name__ == "__main__":
    run()
