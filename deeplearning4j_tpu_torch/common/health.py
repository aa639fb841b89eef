"""The training-health watchdog: port of deeplearning4j_tpu/common/health.py.

Three pieces, as in the reference:

  * Device side (`grad_health`, the gate in `nn.updater.updaters.
    apply_layer`): an armed training step also computes a few scalars, the
    global and per-layer gradient norms, the score and an all-finite flag,
    all on the device, and applies its update only where the flag holds
    (`torch.where(ok, new, old)` written back into the live tensors, since
    the port's updaters write parameters in place). A poisoned batch is so
    skipped inside the step, with no read on the host; a disarmed step runs
    exactly the code it ran before the watchdog existed.

  * Host side (`TrainingHealthPolicy`, stdlib only, copied from the
    reference): classify each step's health, NaN/Inf (the device already
    skipped), an EMA z-score loss spike or a gradient-norm explosion, into an
    action: count and skip, roll back to the last good round, or abort after
    N consecutive bad steps naming the offending rounds. Its counters mirror
    onto the port's `obs` registry as `train.health.*`.

  * Loop driver (`apply_policy`, `install`, `finish_step`, `finish_fused`,
    `fit_loop_rollback`, `fit_loop_checkpoint`): the one action dispatch of
    every training loop (both containers' batch and TBPTT loops, fused or
    not; ParallelWrapper in both modes; the TrainingMaster). A rollback
    restores the newest checkpoint of `util.sharded_checkpoint`, which also
    rewinds the counters and the dropout generator, so the stream after it
    replays exactly.

`rowwise_finite` is the serving side's output screen.
"""
from __future__ import annotations

import collections
import logging
import math
import threading

import numpy as np
import torch

from ..util.model_serializer import tree_leaves

log = logging.getLogger(__name__)

# actions returned by TrainingHealthPolicy.observe / apply_policy
OK = "ok"            # healthy step
SKIP = "skip"        # non-finite: the device already skipped the update
SPIKE = "spike"      # divergence counted but not undone (no rollback seam)
ROLLBACK = "rollback"  # divergence: restore the last good round
ABORT = "abort"      # N consecutive unhealthy steps: stop the run


class TrainingDivergedError(RuntimeError):
    """Raised when the watchdog aborts a run after `max_consecutive_bad`
    consecutive unhealthy steps. The message names the offending rounds."""


# ---------------------------------------------------------------------------
# Device side, inside the training step
# ---------------------------------------------------------------------------

def grad_health(grads, score, sums=None):
    """The step's health scalars, on the device: {"score", "grad_norm",
    "layer_grad_norms": {layer key: norm}, "all_finite"}. `grads` is the
    container's {layer key: {param name: gradient}}; `sums`, when given, the
    same tree of each whole gradient's sum of squares, read in place of
    the gradients (the tensor-parallel step's are slices).

    The squared norms accumulate in f32, per layer and in total. Squares
    are not negative, so the total is non-finite iff some gradient element
    is NaN/Inf, or the norm overflowed f32, a gradient explosion just as
    worth skipping. `all_finite` is a 0-d bool tensor; nothing is read on
    the host."""
    layer_norms = {}
    total_sq = None
    for key, group in grads.items():
        sq = None
        for name, g in group.items():
            s = (torch.sum(torch.square(g.float())) if sums is None
                 else sums[key][name].float())
            sq = s if sq is None else sq + s
        if sq is None:
            sq = torch.zeros((), dtype=torch.float32, device=score.device)
        layer_norms[key] = torch.sqrt(sq)
        total_sq = sq if total_sq is None else total_sq + sq
    if total_sq is None:
        total_sq = torch.zeros((), dtype=torch.float32, device=score.device)
    score32 = score.detach().float()
    return {"score": score32, "grad_norm": torch.sqrt(total_sq),
            "layer_grad_norms": layer_norms,
            "all_finite": torch.isfinite(total_sq) & torch.isfinite(score32)}


def gate_update(ok, new_tree, old_tree):
    """`torch.where(ok, new, old)` leaf by leaf over matching dicts of
    tensors: where `ok` (a 0-d bool tensor) is False the old values come
    back, with no read on the host. The parameters and the updater and
    layer state are gated where they are written (`updaters.apply_layer`,
    `Network._store_state`); this gates what a step hands on (the TBPTT
    carries)."""
    if isinstance(new_tree, dict):
        return {k: gate_update(ok, v, old_tree[k])
                for k, v in new_tree.items()}
    return torch.where(ok, new_tree, old_tree)


def stack_health(healths):
    """K steps' health dicts as one dict of [K] tensors (the fused group's
    per-step report)."""
    return {"score": torch.stack([h["score"] for h in healths]),
            "grad_norm": torch.stack([h["grad_norm"] for h in healths]),
            "layer_grad_norms": {
                key: torch.stack([h["layer_grad_norms"][key]
                                  for h in healths])
                for key in healths[0]["layer_grad_norms"]},
            "all_finite": torch.stack([h["all_finite"] for h in healths])}


def rowwise_finite(tree, batch_axis=0):
    """Per-example finiteness of an inference output tree: bool [B] numpy
    vector, True where every leaf's row `b` is all-finite. The serving
    layer's optional output screen (`InferenceServer(screen_outputs=True)`)
    uses it to fail only the poisoned requests of a micro-batch. Leaves are
    numpy arrays or tensors (bf16 is widened to f32, which is exact);
    integer and bool leaves cannot be non-finite."""
    ok = None
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            leaf = leaf.cpu().numpy()
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            continue
        axes = tuple(i for i in range(a.ndim) if i != batch_axis)
        row_ok = np.isfinite(a).all(axis=axes)
        ok = row_ok if ok is None else (ok & row_ok)
    return ok


# ---------------------------------------------------------------------------
# Host side: classification policy (copied from the reference, stdlib only)
# ---------------------------------------------------------------------------

class TrainingHealthPolicy:
    """Classify per-step health and decide the response.

    Classification (in precedence order):
      1. non-finite score/gradients -> SKIP (the device already withheld
         the update; the host counts it and moves on);
      2. gradient-norm explosion (`grad_norm_limit`) or loss spike (score
         more than `spike_zscore` EW-standard-deviations above the
         exponential moving average of *healthy* scores, after
         `warmup_steps` healthy observations) -> ROLLBACK (or SPIKE when
         the caller has no rollback seam / `rollback_on_spike=False`);
      3. `max_consecutive_bad` consecutive unhealthy steps -> ABORT
         (raised as TrainingDivergedError by `apply_policy`).

    The EMA baseline only ingests healthy steps, so a spike cannot poison
    its own detector. Counters and a bounded event log feed `snapshot()`;
    `record_validation_reject` lets the data-pipeline validator aggregate
    into the same run-health view.
    """

    def __init__(self, spike_zscore=6.0, ema_decay=0.9, warmup_steps=8,
                 grad_norm_limit=None, max_consecutive_bad=5,
                 rollback_on_spike=True, max_events=64):
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        self.spike_zscore = float(spike_zscore)
        self.ema_decay = float(ema_decay)
        self.warmup_steps = int(warmup_steps)
        self.grad_norm_limit = (None if grad_norm_limit is None
                                else float(grad_norm_limit))
        self.max_consecutive_bad = int(max_consecutive_bad)
        self.rollback_on_spike = bool(rollback_on_spike)
        self.counts = {"ok": 0, "skips": 0, "spikes": 0, "rollbacks": 0,
                       "aborts": 0, "validation_rejects": 0}
        self.events = collections.deque(maxlen=int(max_events))
        self.consecutive_bad = 0
        self._ema = None
        self._var = 0.0
        self._healthy_seen = 0
        # observe() runs on the training thread, but validation rejects
        # arrive from the async staging pool's threads
        self._lock = threading.Lock()

    def _count(self, key, n=1):
        """Increment a health counter and mirror it onto the process-wide
        metrics registry (`train.health.<key>`)."""
        self.counts[key] += n
        from ..obs.registry import default_registry
        default_registry().counter("train.health." + key).inc(n)

    # -- classification -------------------------------------------------
    def observe(self, health, round_index=None):
        """Classify one step. Returns OK / SKIP / SPIKE / ROLLBACK /
        ABORT. `health` is the step's dict (tensors or Python scalars)."""
        score = float(health["score"])
        grad_norm = float(health["grad_norm"])
        finite = bool(health["all_finite"])
        if not finite:
            bad = int(health.get("bad_steps", 1))
            steps = int(health.get("steps", 1))
            if 0 < bad < steps:
                # k-local-steps partial round: only some of the round's
                # local steps were non-finite, each already skipped on its
                # rank; the averaged round still progressed and its score
                # covers the healthy steps. Count the skips; don't
                # escalate. (The round's max grad norm includes the skipped
                # step, so spike checks are not applied.)
                self._count("skips", bad)
                self.consecutive_bad = 0
                self._event("skip", round_index,
                            reason=f"{bad}/{steps} local steps non-finite "
                                   "(partial round, average applied)",
                            score=score, gradNorm=grad_norm)
                log.warning("training-health partial skip at round %s: "
                            "%d/%d local steps non-finite", round_index,
                            bad, steps)
                return OK
            return self._unhealthy(SKIP, "non-finite score/gradients",
                                   round_index, score, grad_norm)
        reason = None
        if (self.grad_norm_limit is not None
                and grad_norm > self.grad_norm_limit):
            reason = (f"gradient norm {grad_norm:.4g} exceeds limit "
                      f"{self.grad_norm_limit:.4g}")
        else:
            z = self._zscore(score)
            if z is not None and z > self.spike_zscore:
                reason = (f"loss spike: score {score:.4g} is {z:.1f} "
                          f"EW-stdev above EMA {self._ema:.4g}")
        if reason is not None:
            want = ROLLBACK if self.rollback_on_spike else SPIKE
            return self._unhealthy(want, reason, round_index, score,
                                   grad_norm)
        self._count("ok")
        self.consecutive_bad = 0
        self._ingest(score)
        return OK

    def _zscore(self, score):
        if self._ema is None or self._healthy_seen < self.warmup_steps:
            return None
        std = math.sqrt(max(self._var, 0.0))
        scale = max(std, abs(self._ema) * 1e-3, 1e-12)
        return (score - self._ema) / scale

    def _ingest(self, score):
        self._healthy_seen += 1
        if self._ema is None:
            self._ema = score
            return
        d = self.ema_decay
        delta = score - self._ema
        self._ema += (1.0 - d) * delta
        self._var = d * (self._var + (1.0 - d) * delta * delta)

    def _unhealthy(self, want, reason, round_index, score, grad_norm):
        kind = "skip" if want == SKIP else "spike"
        self._count(kind + "s")
        self.consecutive_bad += 1
        self._event(kind, round_index, reason=reason, score=score,
                    gradNorm=grad_norm)
        log.warning("training-health %s at round %s: %s", kind,
                    round_index, reason)
        if self.consecutive_bad >= self.max_consecutive_bad:
            self._count("aborts")
            self._event("abort", round_index, reason=reason)
            return ABORT
        return want

    # -- bookkeeping hooks ----------------------------------------------
    def record_rollback(self, round_index, restored_round):
        self._count("rollbacks")
        self._event("rollback", round_index,
                    restoredRound=int(restored_round))
        log.warning("training-health rollback: round %s restored from "
                    "checkpointed round %s", round_index, restored_round)

    def record_validation_reject(self, reason, batch_index=None):
        with self._lock:
            self._count("validation_rejects")
        self._event("validation_reject", batch_index, reason=str(reason))

    def _event(self, kind, round_index, **meta):
        e = {"kind": kind,
             "round": None if round_index is None else int(round_index)}
        e.update(meta)
        with self._lock:
            self.events.append(e)

    # -- reporting ------------------------------------------------------
    def snapshot(self):
        """JSON-able run-health summary."""
        with self._lock:
            return {"counts": dict(self.counts),
                    "consecutiveBad": int(self.consecutive_bad),
                    "lastEvent": self.events[-1] if self.events else None}

    def diagnose(self):
        """Loud abort diagnostic naming the offending rounds."""
        with self._lock:       # a staging thread may be appending events
            events = list(self.events)
        bad = [e for e in events if e["kind"] in ("skip", "spike")]
        rounds = [e["round"] for e in bad[-self.consecutive_bad:]]
        last = bad[-1] if bad else {}
        return (f"training diverged: {self.consecutive_bad} consecutive "
                f"unhealthy steps (limit {self.max_consecutive_bad}); "
                f"offending rounds {rounds}; last: round {last.get('round')}"
                f" ({last.get('reason', 'unknown')})")


# ---------------------------------------------------------------------------
# Loop driver, shared by every training loop
# ---------------------------------------------------------------------------

def apply_policy(policy, health, round_index, rollback=None):
    """Classify one step and drive the host-side action. Returns the
    action taken (OK / SKIP / SPIKE / ROLLBACK); raises
    TrainingDivergedError on ABORT.

    `rollback` is the loop's seam to the last good round: a zero-arg
    callable returning the restored round number, or False/None when no
    checkpoint exists (the action then degrades to SPIKE: counted, params
    left as they are, escalating to abort if divergence persists)."""
    action = policy.observe(health, round_index)
    if action == ABORT:
        raise TrainingDivergedError(policy.diagnose())
    if action == ROLLBACK:
        restored = rollback() if rollback is not None else None
        if restored is None or restored is False:
            log.warning("training-health: divergence at round %s but no "
                        "checkpoint to roll back to; counting and "
                        "continuing", round_index)
            return SPIKE
        policy.record_rollback(round_index, restored)
        return ROLLBACK
    return action


def install(net, policy=True, checkpoint_dir=None, checkpoint_every=10,
            keep_checkpoints=3):
    """Arm (or disarm) the watchdog on a network: the one implementation
    behind both containers' `training_health`.

    policy: a TrainingHealthPolicy, True for the defaults, or None/False to
    disarm. `checkpoint_dir` gives the single-process fit loops their
    rollback seam: a ShardedCheckpointManager under it saves the whole
    training state every `checkpoint_every` healthy iterations, and a
    divergence restores the newest save (parameters, updater and layer
    state, the dropout generator and the counters). Without it, divergence
    degrades to count and continue; ParallelWrapper and TrainingMaster
    supply their own round seam. Arming or disarming invalidates the
    network's captured fused groups (`_health_gen`)."""
    if policy is True:
        policy = TrainingHealthPolicy()
    elif policy is False:
        policy = None
    armed = policy is not None
    net._health_policy = policy
    net._health_gen = getattr(net, "_health_gen", 0) + 1
    net._health_ckpt = None
    net._health_ckpt_every = max(1, int(checkpoint_every))
    if armed and checkpoint_dir is not None:
        from ..util.sharded_checkpoint import ShardedCheckpointManager
        net._health_ckpt = ShardedCheckpointManager(
            str(checkpoint_dir), keep_last=max(1, int(keep_checkpoints)))
    return net


def finish_step(net, health, score):
    """The armed fit-loop step epilogue of both containers (batch and TBPTT
    loops): classify the health, drive the host action through the net's
    checkpoint seam, and keep a skipped or rolled-back step's score out of
    `net._score`. Returns the action; ROLLBACK means the counters and the
    generator were already restored and the caller abandons the current
    batch or sequence; ABORT raises TrainingDivergedError."""
    rollback = None
    if getattr(net, "_health_ckpt", None) is not None:
        def rollback():
            return fit_loop_rollback(net)
    action = apply_policy(net._health_policy, health,
                          round_index=net.conf.iteration_count,
                          rollback=rollback)
    if action not in (ROLLBACK, SKIP):
        net._score = score
    return action


def split_stacked(health, n_steps):
    """A fused group's stacked health ([K] tensors) as K per-step dicts of
    Python scalars, with one device-to-host copy for the whole report."""
    keys = list(health["layer_grad_norms"])
    rows = torch.stack(
        [health["score"].float(), health["grad_norm"].float(),
         health["all_finite"].float()]
        + [health["layer_grad_norms"][k].float() for k in keys]).cpu()
    host = rows.numpy()
    out = []
    for i in range(n_steps):
        out.append({"score": float(host[0, i]),
                    "grad_norm": float(host[1, i]),
                    "all_finite": bool(host[2, i] != 0.0),
                    "layer_grad_norms": {k: float(host[3 + j, i])
                                         for j, k in enumerate(keys)}})
    return out


def host_health(health):
    """One step's (or one round's) health dict as Python scalars, with one
    device-to-host copy; extra scalar keys (a round's `bad_steps` and
    `steps`) come along."""
    out = split_stacked(stack_health([health]), 1)[0]
    for k, v in health.items():
        if k not in out:
            out[k] = int(v)
    return out


def finish_fused(net, scores, health_stack, n_steps):
    """The fused-group epilogue of both containers (batch and TBPTT): walk
    the K inner steps in order, updating the score, counters and listeners
    per optimizer step and, when armed, classifying each step's health as
    the sequential loop would.

    Returns the inner index whose classification triggered a ROLLBACK (the
    counters and the generator already restored; the caller re-runs the
    remaining staged batches from the restored state, so the stream
    matches K sequential steps), or None when every step was consumed.
    ABORT raises TrainingDivergedError, as in the sequential loop."""
    if health_stack is None and not net.listeners:
        # nothing reads per-step scalars: no read on the host at all (the
        # sequential loop takes none either). The score is the group's
        # last step's, read lazily.
        net._score = scores[n_steps - 1]
        net.conf.iteration_count += n_steps
        return None
    healths = (split_stacked(health_stack, n_steps)
               if health_stack is not None else None)
    action = OK
    for i in range(n_steps):
        if healths is None:
            net._score = scores[i]
            action = OK
        else:
            action = finish_step(net, healths[i], scores[i])
            if action == ROLLBACK:
                return i
        net.conf.iteration_count += 1
        net._fire_iteration_done()
    # groups are clipped at checkpoint boundaries (fused.group_size), so a
    # due save can only land on the last inner step, where the net's state
    # is the post-due-step state
    if healths is not None and action == OK:
        fit_loop_checkpoint(net)
    return None


def fit_loop_rollback(net):
    """The single-process fit loops' rollback seam: restore the newest
    health checkpoint into the net (counters and generator included).
    Returns the restored round (iteration) number, or False when no
    checkpoint exists yet."""
    mgr = getattr(net, "_health_ckpt", None)
    if mgr is None or mgr.latest_step() is None:
        return False
    last = mgr.latest_step()
    mgr.restore(net, last)
    return last


def fit_loop_checkpoint(net):
    """Periodic save for the fit-loop seam: checkpoint the whole training
    state at the current iteration count when due."""
    mgr = getattr(net, "_health_ckpt", None)
    if mgr is None:
        return
    it = int(net.conf.iteration_count)
    if it % net._health_ckpt_every == 0:
        score = getattr(net, "_score", None)
        score = None if score is None else float(score)
        if score is not None and not math.isfinite(score):
            score = None       # a NaN score must not enter best-step math
        mgr.save(net, it, score=score)
