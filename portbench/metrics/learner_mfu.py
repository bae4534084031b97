"""learner_mfu: the whole GAIL iteration's share of the card's dense
bfloat16 peak, in percent: the model FLOPs of the traced run's unprofiled
iterations (``portbench/work/learner.py``: convolutions and dense layers,
the discriminator's backward only where its step was taken) over their
seconds (CUDA events) times 989.4 TFLOP/s.

Layer: GAIL iteration (``train/gail.py`` and ``models/nets.py``).  Moves
train_samples_per_s."""

LAYER = 'GAIL iteration'
UNIT = '%'
MOVES = 'train_samples_per_s'


def read(ctx):
    flops, seconds = getattr(ctx, 'flops', None), getattr(ctx, 'host_s',
                                                          None)
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * ctx.peak_flops)
