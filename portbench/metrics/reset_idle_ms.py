"""reset_idle_ms: milliseconds a reset in which the card ran nothing, the
idle gaps whose label (the innermost host range when the operation that
ended the gap was launched) is one of the port's reset spans
(``magical.reset``, ``magical.reset.*``), over the traced window's resets
(``counters()['resets']``).

Layer: reset and placement: the card waits for the host's draws, syncs and
launches.  Moves env_steps_per_s.  A program without the spans or
``BatchedEnv.counters`` reads nothing."""

LAYER = 'reset and placement'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    resets = counters()['resets'] if counters else 0
    us = sum(us for label, us in ctx.trace.gaps
             if label.startswith('magical.reset'))
    if not us or not resets:
        return None
    return us / resets / 1e3
