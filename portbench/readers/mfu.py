"""The whole step's share of the card's peak, in %: the operations of the
window's steps (`flops`) over the window's time (host clock) at the
card's peak."""


def read(ctx):
    return 100.0 * ctx.flops_per_step * ctx.steps / (
        ctx.window_s * ctx.peak_flops)
