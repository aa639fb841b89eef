"""What the program-span readers share: the port's own spans of the
traced window (`optimize.profiler.program_spans()`: each span name's
count, host, self host and device seconds), per step (`train.step`) or
per scored batch (`eval.batch`) of that window. A program without those
spans gives None, and so does a number no span recorded."""

STEP = {"train": "train.step", "eval": "eval.batch"}


def program_spans():
    """The program's span read-out, or None where it has none."""
    try:
        from deeplearning4j_tpu_torch.optimize.profiler import program_spans
    except ImportError:
        return None
    return program_spans()


def per_step(ctx, names, field):
    """ms a traced step or batch in the spans `names`: the sum of their
    `field` ("host_s", "self_s" or "device_s") over the count of the
    phase's step spans."""
    spans = program_spans()
    if not spans:
        return None
    steps = spans.get(STEP[ctx.phase], {}).get("count")
    values = [spans[n][field] for n in names
              if n in spans and spans[n][field] is not None]
    if not steps or not values:
        return None
    return 1e3 * sum(values) / steps
