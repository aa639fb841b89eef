"""Device ms a step in the forward (`train.forward`: the loss in
`_step_body`) or a scored batch in it (`infer.forward`: the forward in
`output`): the span's CUDA event interval on the training stream."""
from ._spans import per_step


def read(ctx):
    name = "train.forward" if ctx.phase == "train" else "infer.forward"
    return per_step(ctx, [name], "device_s")
