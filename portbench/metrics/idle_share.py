"""idle_share: the share of the traced window in which no operation
(kernel, copy or set) ran on the card: 1 - the union of their intervals
over the window, in percent.

Layer: device (one H100).  Moves env_steps_per_s: the card waits for the
host there."""

LAYER = 'device'
UNIT = '%'
MOVES = 'env_steps_per_s'


def read(ctx):
    t = ctx.trace
    if not t.busy_us or not t.window_us:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
