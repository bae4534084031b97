"""reset_draw_mb: megabytes (1e6 bytes) a reset drew on the host and
copied to the card (the port's counter ``reset_draw_bytes``), over the
traced window's resets (``counters()['resets']``).

Layer: reset and placement: the host's draws from the episode's CPU
generator and their copies.  Moves env_steps_per_s.  A program without
``BatchedEnv.counters`` reads nothing."""

LAYER = 'reset and placement'
UNIT = 'MB'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters:
        return None
    c = counters()
    if not c['resets']:
        return None
    return c['reset_draw_bytes'] / c['resets'] / 1e6
