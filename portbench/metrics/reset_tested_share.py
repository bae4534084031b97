"""reset_tested_share: the share of a reset's drawn placement proposals
that the placement kernel tested, in percent: proposals tested (whole
rounds of 32, up to each env's first fit) over proposals drawn, summed
over envs and the traced window's placements
(``counters()['place_items']``, counted by each env's warp).

Layer: reset and placement (``tasks/place_kernel.py`` ->
``csrc/place.cu``).  Moves env_steps_per_s.  A program without the
counter, or one that placed nothing, reads nothing."""

LAYER = 'reset and placement'
UNIT = '%'
MOVES = 'env_steps_per_s'


def read(ctx):
    counters = getattr(ctx.env, 'counters', None)
    if not counters:
        return None
    items = counters().get('place_items')
    if not items or not items['drawn']:
        return None
    return 100.0 * items['tested'] / items['drawn']
