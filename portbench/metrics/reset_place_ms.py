"""reset_place_ms: device milliseconds a reset of the operations launched
inside the port's placement spans (``magical.reset.place``) but not inside
its draws (``magical.reset.draw``: the proposals' copies to the card),
over the traced window's resets (``counters()['resets']``).

Layer: reset and placement (``tasks/base.py`` ``place``,
``tasks/randomize.py`` ``place_entity``, ``place_from_proposals``).  Moves
env_steps_per_s: every episode pays one reset inside the window.  A
program without the spans or ``BatchedEnv.counters`` reads nothing."""

LAYER = 'reset and placement'
UNIT = 'ms'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    resets = counters()['resets'] if counters else 0
    us = ctx.trace.device_us(('magical.reset.place',),
                             ('magical.reset.draw',))
    if not us or not resets:
        return None
    return us / resets / 1e3
