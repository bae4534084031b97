"""reset_syncs: device-to-host reads a reset (the port's counter
``reset_syncs``, each read in a ``magical.reset.sync`` span), over the
traced window's resets (``counters()['resets']``).

Layer: reset and placement: each read waits for the card and leaves it
idle while the host draws and launches again.  Moves env_steps_per_s.  A
program without ``BatchedEnv.counters`` reads nothing."""

LAYER = 'reset and placement'
UNIT = 'count'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters:
        return None
    c = counters()
    if not c['resets']:
        return None
    return c['reset_syncs'] / c['resets']
