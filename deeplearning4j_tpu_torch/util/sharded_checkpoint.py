"""Training-state checkpoints: port of deeplearning4j_tpu/util/
sharded_checkpoint.py for replicated training state (one process's whole
state, or a data-parallel group's, which is the same on every rank).

The on-disk format is the port's own, not orbax's (the reference writes
orbax; the port has no orbax): one file per checkpoint, written by
`torch.save` under a temporary name in the same directory, then moved into
place with `os.replace`, so a reader sees a whole checkpoint or none. It
holds everything an exact resume needs:

  * the f32 masters in the port's layout (convolution kernels OIHW), the
    updater state and the layers' state (BatchNorm's running statistics),
    all as CPU tensors keyed by layer key and name;
  * `conf.iteration_count` and `conf.epoch_count`;
  * the dropout generator's `get_state()`;
  * the score of the last step.

A restore copies every tensor into the network's own tensors in place, so
whatever holds them (a captured fused group's CUDA graph) stays valid, and
refuses a checkpoint whose shapes differ from the network's.

With a torch.distributed process group, rank 0 writes and prunes, every
rank waits at a barrier, and every rank restores the same file.
Mesh-sharded state (tensor parallelism, ZeRO, `torch.distributed.
checkpoint`) is ROADMAP.md queue 1 item 20. `ShardedModelSaver` is the
early-stopping saver over these files.
"""
from __future__ import annotations

import json
import logging
import os
import shutil

import torch

log = logging.getLogger(__name__)

_PREFIX = "ckpt_"


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _rank():
    d = _dist()
    return d.get_rank() if d is not None else 0


def _barrier():
    d = _dist()
    if d is not None:
        d.barrier()


def _state(net):
    """The checkpointed training state of `net`, as CPU tensors."""
    net._ensure_init()
    keyed = net._keyed_layers()
    score = getattr(net, "_score", None)
    return {
        "format": "deeplearning4j_tpu_torch/1",
        "params": {str(key): {k: p.detach().cpu().clone()
                              for k, p in net._slot(key).params.items()}
                   for key, _ in keyed},
        "updater_state": {str(key): {k: {s: t.detach().cpu().clone()
                                         for s, t in st.items()}
                                     for k, st in net._updater_state[key]
                                     .items()}
                          for key, _ in keyed},
        "model_state": {str(key): {n: b.detach().cpu().clone()
                                   for n, b in net._slot(key).state()
                                   .items()}
                        for key, _ in keyed},
        "iteration_count": int(net.conf.iteration_count),
        "epoch_count": int(getattr(net.conf, "epoch_count", 0)),
        "rng": net._dropout_gen.get_state(),
        "score": None if score is None else float(score),
    }


def _check_restore_shapes(net, doc):
    """Refuse a checkpoint of another architecture, naming what differs."""
    keyed = net._keyed_layers()
    bad = []

    def cmp(name, want, saved):
        if saved is None:
            bad.append(f"{name}: missing from the checkpoint")
        elif tuple(saved.shape) != tuple(want.shape):
            bad.append(f"{name}: saved {tuple(saved.shape)} vs net "
                       f"{tuple(want.shape)}")

    for key, _ in keyed:
        sk = str(key)
        for k, p in net._slot(key).params.items():
            cmp(f"params[{sk}][{k}]", p,
                doc["params"].get(sk, {}).get(k))
        for n, b in net._slot(key).state().items():
            cmp(f"model_state[{sk}][{n}]", b,
                doc["model_state"].get(sk, {}).get(n))
        for k, st in net._updater_state[key].items():
            for s, t in st.items():
                cmp(f"updater_state[{sk}][{k}][{s}]", t,
                    doc["updater_state"].get(sk, {}).get(k, {}).get(s))
    extra = set(doc["params"]) - {str(key) for key, _ in keyed}
    bad.extend(f"params[{k}]: not in the net" for k in sorted(extra))
    if bad:
        detail = "; ".join(bad[:8])
        raise ValueError(f"checkpoint does not match the target architecture"
                         f" ({len(bad)} mismatched arrays): {detail}")


def save_checkpoint(net, path, overwrite=True):
    """Save `net`'s whole training state to the file `path` (rank 0 writes,
    every rank of a process group waits at a barrier). `overwrite=False`
    raises if `path` exists."""
    path = os.path.abspath(str(path))
    if not overwrite and os.path.exists(path):
        raise ValueError(f"checkpoint {path!r} exists (overwrite=False)")
    doc = _state(net)
    if _rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(doc, tmp)
        os.replace(tmp, path)
    _barrier()
    return path


@torch.no_grad()
def load_checkpoint(net, path):
    """Restore the checkpoint at `path` into `net`, in place: parameters,
    updater and layer state, the counters, the dropout generator and the
    score. The architecture must match the saved one. Returns `net`."""
    net._ensure_init()
    doc = torch.load(os.path.abspath(str(path)), map_location="cpu",
                     weights_only=True)
    _check_restore_shapes(net, doc)
    for key, _ in net._keyed_layers():
        sk = str(key)
        for k, p in net._slot(key).params.items():
            p.copy_(doc["params"][sk][k])
        for n, b in net._slot(key).state().items():
            b.copy_(doc["model_state"][sk][n])
        for k, st in net._updater_state[key].items():
            for s, t in st.items():
                t.copy_(doc["updater_state"][sk][k][s])
    net.conf.iteration_count = int(doc["iteration_count"])
    if hasattr(net.conf, "epoch_count"):
        net.conf.epoch_count = int(doc["epoch_count"])
    net._dropout_gen.set_state(doc["rng"])
    score = doc["score"]
    net._score = (None if score is None
                  else torch.tensor(score, dtype=torch.float64))
    return net


class ShardedCheckpointManager:
    """Step-numbered checkpoints with retention (the reference's
    CheckpointListener/CheckpointManager role): keep the last `keep_last`
    steps plus the best-scoring one (`mode` "min" or "max"), prune the rest.

    Layout: `<directory>/ckpt_<step>` per checkpoint and
    `<directory>/manager.json` (steps, scores, mode, keep_last). With a
    process group, rank 0 writes the metadata and prunes."""

    def __init__(self, directory, keep_last=3, mode="min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(str(directory))
        self.keep_last = max(1, int(keep_last))
        self.mode = mode
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "manager.json")
        self._meta = {"steps": [], "scores": {}}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)
            # the retention policy is persisted and checked: resuming with
            # another mode would invert best_step and prune the true best
            for key, mine in (("mode", self.mode),
                              ("keep_last", self.keep_last)):
                stored = self._meta.get(key)
                if stored is not None and stored != mine:
                    raise ValueError(
                        f"checkpoint dir was managed with {key}={stored!r}"
                        f"; refusing to resume with {key}={mine!r} (pass "
                        f"the original value)")

    def _path(self, step):
        return os.path.join(self.directory, f"{_PREFIX}{int(step)}")

    def steps(self):
        return list(self._meta["steps"])

    def latest_step(self):
        """The newest checkpointed step, or None for an empty directory."""
        return self._meta["steps"][-1] if self._meta["steps"] else None

    def best_step(self):
        scores = {int(s): v for s, v in self._meta["scores"].items()
                  if v is not None}
        if not scores:
            return None
        if self.mode == "min":
            # the latest wins ties: smaller score first, then larger step
            return min(scores, key=lambda s: (scores[s], -s))
        return max(scores, key=lambda s: (scores[s], s))

    def save(self, net, step, score=None):
        """Checkpoint `net` at `step` (optionally scored), then prune to the
        retention policy. Returns the checkpoint's path.

        Crash-safety order: the checkpoint is committed first (a whole file
        or none), then the metadata is replaced atomically, and only then
        are pruned checkpoints deleted; a crash at any point leaves metadata
        that names only whole checkpoints (at worst orphans, swept on the
        next save)."""
        step = int(step)
        path = save_checkpoint(net, self._path(step))
        if step not in self._meta["steps"]:
            self._meta["steps"].append(step)
            self._meta["steps"].sort()
        if score is not None or str(step) not in self._meta["scores"]:
            # never erase a recorded score with a score-less re-save: the
            # former best must not silently become prunable
            self._meta["scores"][str(step)] = (None if score is None
                                               else float(score))
        stale = self._compute_prune()
        self._write_meta()
        if _rank() == 0:
            for s in stale:
                _remove(self._path(s))
            self._sweep_orphans()
        _barrier()
        return path

    def _compute_prune(self):
        """Drop out-of-policy steps from the metadata and return them (the
        files are deleted after the metadata write)."""
        keep = set(self._meta["steps"][-self.keep_last:])
        best = self.best_step()
        if best is not None:
            keep.add(best)
        stale = [s for s in self._meta["steps"] if s not in keep]
        for step in stale:
            self._meta["steps"].remove(step)
            self._meta["scores"].pop(str(step), None)
        return stale

    def _write_meta(self):
        if _rank() != 0:
            return
        self._meta["mode"] = self.mode
        self._meta["keep_last"] = self.keep_last
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._meta, f)
        os.replace(tmp, self._meta_path)       # atomic on POSIX

    def _sweep_orphans(self):
        """Delete checkpoints the metadata no longer names (left by a crash
        between the metadata write and the deletion) and partial saves
        (`ckpt_<step>.tmp-<pid>`, left by a crash inside a save)."""
        live = {f"{_PREFIX}{s}" for s in self._meta["steps"]}
        for name in os.listdir(self.directory):
            if not name.startswith(_PREFIX) or name in live:
                continue
            stem = name[len(_PREFIX):].split(".tmp-")[0]
            if stem.isdigit():
                _remove(os.path.join(self.directory, name))

    def restore(self, net, step):
        return load_checkpoint(net, self._path(int(step)))

    def restore_latest(self, net):
        if not self._meta["steps"]:
            raise FileNotFoundError(f"no checkpoints under "
                                    f"{self.directory!r}")
        return self.restore(net, self._meta["steps"][-1])

    def restore_best(self, net):
        best = self.best_step()
        if best is None:
            raise FileNotFoundError("no scored checkpoints under "
                                    f"{self.directory!r}")
        return self.restore(net, best)


class ShardedModelSaver:
    """The early-stopping saver SPI over the checkpoint files of
    `save_checkpoint` (reference util/sharded_checkpoint.py:298-331; the
    reference's LocalFileModelSaver writes the zip). A checkpoint holds no
    configuration, so the saver takes `net_factory`, a zero-argument
    callable building the same architecture, for the restore. The
    reference saves orbax directories: nothing is read across packages."""

    def __init__(self, directory, net_factory):
        self.directory = os.path.abspath(directory)
        self.net_factory = net_factory
        os.makedirs(self.directory, exist_ok=True)

    @property
    def best_path(self):
        return os.path.join(self.directory, "bestModel")

    @property
    def latest_path(self):
        return os.path.join(self.directory, "latestModel")

    def save_best_model(self, net, score):
        save_checkpoint(net, self.best_path)

    def save_latest_model(self, net, score):
        save_checkpoint(net, self.latest_path)

    def get_best_model(self):
        return load_checkpoint(self.net_factory(), self.best_path)

    def get_latest_model(self):
        return load_checkpoint(self.net_factory(), self.latest_path)

    saveBestModel = save_best_model
    getBestModel = get_best_model


def _remove(path):
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass


class RoundCheckpointer:
    """The per-averaging-round checkpoint and crash-resume gate that
    ParallelWrapper and ParameterAveragingTrainingMaster share (the round
    is the resume unit: master = one split; wrapper = one batch in
    all-reduce mode, one k-group in k-step mode).

    With `directory=None` it is a pure round counter. Otherwise:
    `maybe_resume(net)`, once per lifetime and only into a never-trained
    net (iteration_count 0; a warm net is an in-process continuation, not a
    crash restart), restores the newest checkpoint and records how many
    rounds it covers; `round_starts()` then gates those rounds off (the
    caller still consumes their batches so the data stream stays aligned);
    `round_done(net)` saves every `every` rounds. Re-running the same
    training command after a crash so resumes from the last completed round
    with the exact generator state and counters, bit-comparable to a run
    that was never interrupted."""

    def __init__(self, directory=None, every=1, keep_last=3, resume=True,
                 owner="trainer"):
        self.directory = None if directory is None else str(directory)
        self.every = max(1, int(every))
        self.keep_last = max(1, int(keep_last))
        self.resume = bool(resume)
        self.owner = owner
        self.round = 0           # rounds dispatched, monotonic for life
        self.resume_round = 0    # rounds covered by a restored checkpoint
        self._mgr = None
        self._checked = False

    def manager(self):
        if self.directory is None:
            return None
        if self._mgr is None:
            self._mgr = ShardedCheckpointManager(self.directory,
                                                 keep_last=self.keep_last)
        return self._mgr

    def maybe_resume(self, net):
        if self._checked:
            return
        self._checked = True
        mgr = self.manager()
        if mgr is None:
            return
        last = mgr.latest_step()
        if (not self.resume or last is None
                or net.conf.iteration_count != 0):
            return
        mgr.restore(net, last)
        self.resume_round = last
        log.warning("%s: resuming from checkpoint round %d under %s, "
                    "fast-forwarding past the rounds it covers", self.owner,
                    last, self.directory)

    def round_starts(self):
        """True when this round must run; False when a restored checkpoint
        already contains it."""
        r = self.round
        self.round += 1
        return r >= self.resume_round

    def round_done(self, net):
        mgr = self.manager()
        if mgr is None or self.round % self.every != 0:
            return
        score = getattr(net, "_score", None)
        mgr.save(net, self.round,
                 score=None if score is None else float(score))
