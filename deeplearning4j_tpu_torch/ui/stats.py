"""Stats collection: StatsListener + report model.

Port of deeplearning4j_tpu/ui/stats.py, the equivalent of reference
ui-model stats/BaseStatsListener.java:43 (iterationDone:273-420):
per-iteration score, timing, examples/sec, memory, learning rates, and
per-parameter summary statistics (mean/stdev/mean-magnitude) + histograms
of params/gradients/updates. The SBE wire encoding is replaced by plain
dict reports (JSON-able); routing/storage in ui/storage.py.

Parameters are read in the reference's names and layouts
(`reference_params()`: `{layer}_{param}`, HWIO kernels), so a report of
the port and one of the reference on the same weights agree. Reading them
copies every parameter from the card to the host: the collection
frequency and the histogram toggle exist for exactly that reason (the
reference has the same knobs in StatsUpdateConfiguration). The activation
summaries the armed step leaves on the card (`collect_activation_stats`)
are read here, in one copy per report; with no listener nothing is read.
The device and its memory come from torch: backend "cuda" or "cpu",
`torch.cuda.get_device_name`, `torch.cuda.memory_allocated` and the card's
total memory (both 0 on the CPU).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..optimize.listeners import IterationListener


class StatsUpdateConfiguration:
    """reference: ui-model api/StatsUpdateConfiguration.java"""

    def __init__(self, collect_score=True, collect_timing=True,
                 collect_memory=True, collect_learning_rates=True,
                 collect_histograms=False, histogram_bins=20,
                 collect_mean=True, collect_stdev=True,
                 collect_mean_magnitudes=True, report_frequency=1,
                 collect_activations=False, max_activation_channels=8,
                 max_activation_size=48):
        self.collect_score = collect_score
        self.collect_timing = collect_timing
        self.collect_memory = collect_memory
        self.collect_learning_rates = collect_learning_rates
        self.collect_histograms = collect_histograms
        self.histogram_bins = int(histogram_bins)
        self.collect_mean = collect_mean
        self.collect_stdev = collect_stdev
        self.collect_mean_magnitudes = collect_mean_magnitudes
        self.report_frequency = max(1, int(report_frequency))
        # conv-activation capture (reference ConvolutionalListenerModule /
        # ConvolutionalIterationListener): requires an activation_probe
        # batch on the StatsListener; each report carries normalized
        # per-channel activation grids of every 4-D layer output
        self.collect_activations = collect_activations
        self.max_activation_channels = int(max_activation_channels)
        self.max_activation_size = int(max_activation_size)


def _summary(arr, bins=None):
    a = np.asarray(arr, np.float64).ravel()
    out = {"mean": float(a.mean()) if a.size else 0.0,
           "stdev": float(a.std()) if a.size else 0.0,
           "meanMagnitude": float(np.abs(a).mean()) if a.size else 0.0}
    if bins:
        counts, edges = np.histogram(a, bins=bins)
        out["histogram"] = {"counts": counts.tolist(),
                            "min": float(edges[0]), "max": float(edges[-1])}
    return out


class StatsListener(IterationListener):
    """reference: ui-model stats/BaseStatsListener.java"""

    def __init__(self, router_or_storage, config=None, session_id=None,
                 worker_id="worker_0", activation_probe=None):
        self.router = router_or_storage
        self.config = config or StatsUpdateConfiguration()
        self.session_id = session_id or f"session_{int(time.time() * 1000)}"
        self.worker_id = worker_id
        # small sample batch run through feed_forward when
        # collect_activations is on and the step does not emit summaries
        # (a ComputationGraph, or the legacy probe listener)
        self.activation_probe = activation_probe
        self._last_report_time = None
        self._total_examples = 0
        self._total_minibatches = 0
        self._init_sent = False
        self._start_time = time.time()
        self._prev_params = None

    # ------------------------------------------------------------------
    def iteration_done(self, model, iteration):
        c = self.config
        now = time.time()
        self._total_minibatches += 1
        self._total_examples += getattr(model, "_last_batch_size", 0)
        if iteration % c.report_frequency != 0:
            return
        if not self._init_sent:
            self.router.put_static_info(self._static_info(model))
            self._init_sent = True

        report = {"sessionId": self.session_id, "workerId": self.worker_id,
                  "timestamp": int(now * 1000), "iteration": int(iteration)}
        if c.collect_score:
            report["score"] = float(model.score())
        if c.collect_timing:
            if self._last_report_time is not None:
                dt = now - self._last_report_time
                report["iterationTimeMs"] = dt * 1000.0 * c.report_frequency
            total_dt = max(now - self._start_time, 1e-9)
            report["totalRuntimeMs"] = total_dt * 1000.0
            report["examplesPerSecond"] = self._total_examples / total_dt
            report["minibatchesPerSecond"] = self._total_minibatches / total_dt
            report["totalExamples"] = self._total_examples
            report["totalMinibatches"] = self._total_minibatches
            self._last_report_time = now
        if c.collect_memory:
            report["memory"] = self._memory_info(model)
        if c.collect_learning_rates:
            report["learningRates"] = self._learning_rates(model)
        pol = getattr(model, "_health_policy", None)
        if pol is not None:
            # run-health from the training-health watchdog
            # (common/health.py): skip/spike/rollback/validation-reject
            # counters + the latest event, so the UI can show a run's
            # numerical health next to its score curve
            report["health"] = pol.snapshot()
        if c.collect_mean or c.collect_stdev or c.collect_histograms:
            bins = c.histogram_bins if c.collect_histograms else None
            params = dict(self._param_arrays(model))
            report["parameters"] = {name: _summary(arr, bins)
                                    for name, arr in params.items()}
            # "updates" = param deltas since the last report (reference
            # BaseStatsListener collects update histograms the same way the
            # updater writes them; the delta over report_frequency steps
            # needs no gradient copied off the device)
            if self._prev_params is not None:
                report["updates"] = {
                    name: _summary(arr - self._prev_params[name], bins)
                    for name, arr in params.items()
                    if name in self._prev_params}
            self._prev_params = params
        if c.collect_activations:
            live = getattr(model, "_last_activation_stats", None)
            live_iter = getattr(model, "_last_activation_stats_iter", None)
            fresh = (live is not None
                     and live_iter != getattr(self, "_last_seen_act_iter",
                                              object()))
            if fresh:
                # the step emitted summaries of the REAL training
                # batch (BaseStatsListener.java:273-420 onForwardPass role).
                # Freshness is tracked PER LISTENER by the writing
                # iteration: training modes whose steps don't emit stats
                # (k-local-steps averaging, PS wrapper) must not re-report
                # a stale batch as new data, while a second attached
                # listener still sees the same fresh summaries
                self._last_seen_act_iter = live_iter
                report["activationStats"] = self._live_summaries(live)
                grids = self._live_grids(live)
                if grids:
                    report["activations"] = grids
            elif self.activation_probe is not None:
                # legacy probe path: an extra forward on a user batch
                acts = self._activation_grids(model)
                if acts:
                    report["activations"] = acts
            elif (hasattr(model, "collect_activation_stats")
                  and not getattr(model, "_stats_listener_armed", False)):
                # no probe given: arm the step to emit summaries from the
                # next iteration on. Armed AT MOST
                # ONCE per model (flag ON the model — an id() set would
                # alias recycled addresses) — if the user later calls
                # collect_activation_stats(False) explicitly, listeners
                # must not silently re-arm it
                model._stats_listener_armed = True
                model.collect_activation_stats(
                    True, c.max_activation_channels, c.max_activation_size)
        self.router.put_update(report)

    # ------------------------------------------------------------------
    def _static_info(self, model):
        import platform

        dev = getattr(model, "device", torch.device("cpu"))
        return {
            "sessionId": self.session_id,
            "workerId": self.worker_id,
            "startTime": int(self._start_time * 1000),
            "machine": {"hostname": platform.node(),
                        "os": platform.system(),
                        "backend": dev.type,
                        "device": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else str(dev))},
            "model": {"class": type(model).__name__,
                      "numParams": int(model.num_params()),
                      "configJson": model.conf.to_json()},
        }

    @staticmethod
    def _memory_info(model=None):
        dev = getattr(model, "device", torch.device("cpu"))
        out = {"deviceBytesInUse": 0, "deviceBytesLimit": 0}
        if dev.type == "cuda":
            out["deviceBytesInUse"] = int(torch.cuda.memory_allocated(dev))
            out["deviceBytesLimit"] = int(
                torch.cuda.get_device_properties(dev).total_memory)
        try:
            import resource
            out["hostMaxRssKb"] = int(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        except Exception:
            pass
        return out

    def _learning_rates(self, model):
        out = {}
        layers = (model.layers if hasattr(model, "layers")
                  else [s.conf for s in model.conf.vertices.values()
                        if s.is_layer])
        for i, l in enumerate(layers):
            out[getattr(l, "name", None) or str(i)] = float(
                l.learning_rate or 0.0)
        return out

    @staticmethod
    def _live_summaries(live):
        """Scalar per-layer stats from the step's on-device summaries, read
        to the host in one copy."""
        keys = [(i, k) for i, s in enumerate(live) for k in s if k != "grid"]
        vals = torch.stack([live[i][k].detach().float().reshape(())
                            for i, k in keys]).cpu().tolist()
        out = {str(i): {} for i in range(len(live))}
        for (i, k), v in zip(keys, vals):
            out[str(i)][k] = float(v)
        return out

    @staticmethod
    def _norm_grid(g):
        g = np.asarray(g, np.float64)
        lo, hi = float(g.min()), float(g.max())
        return (np.zeros_like(g, np.uint8) if hi <= lo
                else ((g - lo) / (hi - lo) * 255).astype(np.uint8))

    def _live_grids(self, live):
        """Conv activation images from the step-emitted downsampled grids
        (ConvolutionalIterationListener image capture, no probe pass)."""
        out = {}
        for i, s in enumerate(live):
            if "grid" not in s:
                continue
            g = s["grid"]                       # [h, w, ch], first example
            g = (g.detach().float().cpu().numpy()
                 if isinstance(g, torch.Tensor) else np.asarray(g))
            grids = [self._norm_grid(g[:, :, ci]).tolist()
                     for ci in range(g.shape[2])]
            if grids:
                out[str(i)] = {"height": len(grids[0]),
                               "width": len(grids[0][0]),
                               "channels": grids}
        return out

    def _activation_grids(self, model):
        """Per-layer activation images for conv layers: first probe example,
        up to max_activation_channels channels, each normalized to 0-255
        (reference ConvolutionalIterationListener image capture)."""
        c = self.config
        acts = model.feed_forward(self.activation_probe, train=False)
        if isinstance(acts, dict):          # ComputationGraph: name -> act
            items = acts.items()
        else:                               # MLN: [input, layer0, ...]
            items = ((str(i - 1), a) for i, a in enumerate(acts) if i > 0)
        out = {}
        for name, a in items:
            a = np.asarray(a)
            if a.ndim != 4:     # NHWC conv maps only
                continue
            a = a[0]            # first example
            h, w, ch = a.shape
            step = max(1, max(h, w) // c.max_activation_size)
            a = a[::step, ::step, :]
            grids = []
            for ci in range(min(ch, c.max_activation_channels)):
                g = a[:, :, ci].astype(np.float64)
                lo, hi = float(g.min()), float(g.max())
                g8 = np.zeros_like(g, np.uint8) if hi <= lo else \
                    ((g - lo) / (hi - lo) * 255).astype(np.uint8)
                grids.append(g8.tolist())
            if grids:
                out[name] = {"height": len(grids[0]),
                             "width": len(grids[0][0]),
                             "channels": grids}
        return out

    def _param_arrays(self, model):
        """(name, numpy array) of every parameter, in the reference's names
        ({layer}_{param}) and layouts. Copies: on the CPU the arrays would
        share the parameters' memory, which the updaters write in place."""
        tree = model.reference_params()
        if isinstance(tree, dict):              # ComputationGraph
            for name, p in tree.items():
                for k, v in p.items():
                    yield f"{name}_{k}", np.array(v)
        else:                                   # MultiLayerNetwork
            for i, p in enumerate(tree):
                for k, v in p.items():
                    yield f"{i}_{k}", np.array(v)


class ServingStatsReporter:
    """Route serving-layer metrics through the SAME storage path training
    stats use (StatsStorageRouter / ui/storage.py), so the existing UI
    server sees a serving session next to training sessions with zero new
    plumbing. One static-info record names the served model; each
    `report()` appends a timestamped update whose `serving` key carries the
    ServingMetrics snapshot (p50/p99 latency, queue depth, batch occupancy,
    shed/swap counts). The serving loops call `report()` on a cadence the
    server owns (`InferenceServer(stats_reporter=..., report_every=N)`) —
    metrics must never add a per-request host hop."""

    def __init__(self, router_or_storage, session_id=None,
                 worker_id="server_0", model_info=None):
        self.router = router_or_storage
        self.session_id = session_id or f"serving_{int(time.time() * 1000)}"
        self.worker_id = worker_id
        self._model_info = model_info or {}
        self._init_sent = False

    def report(self, snapshot):
        """Append one serving-metrics update (a ServingMetrics.snapshot()
        dict, but any JSON-able mapping works)."""
        if not self._init_sent:
            self.router.put_static_info({
                "sessionId": self.session_id, "workerId": self.worker_id,
                "startTime": int(time.time() * 1000),
                "serving": dict(self._model_info)})
            self._init_sent = True
        self.router.put_update({
            "sessionId": self.session_id, "workerId": self.worker_id,
            "timestamp": int(time.time() * 1000),
            "serving": dict(snapshot)})
