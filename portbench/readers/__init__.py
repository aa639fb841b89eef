"""One reader per per-layer metric, named by the metric's name before its
first dot: `read(ctx)` returns the metric's value, or None where the run
gives it nothing to read. `ctx` has `phase`, `steps` and `window_s` (the
untraced window), `flops_per_step` and `peak_flops` (per card), and
`ranks`: each rank's `data_wait_s`, `peak_window_bytes` and `trace` (the
traced window's summary, `profile.summarize`)."""
