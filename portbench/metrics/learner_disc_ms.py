"""learner_disc_ms: device milliseconds an iteration of the
discriminator: its forwards that give the rollout's reward and the
discriminator's update (the operations inside the harness's
``learner.disc`` ranges), over the traced iterations.

Layer: GAIL discriminator (``train/gail.py`` ``GAILTrainer.collect``'s
reward and ``disc_update``).  Moves train_samples_per_s."""

LAYER = 'GAIL discriminator'
UNIT = 'ms'
MOVES = 'train_samples_per_s'


def read(ctx):
    iterations = getattr(ctx, 'iterations', None)
    us = ctx.trace.device_us(('learner.disc',))
    if not us or not iterations:
        return None
    return us / iterations / 1e3
