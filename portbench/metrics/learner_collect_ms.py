"""learner_collect_ms: device milliseconds an iteration of the rollout:
the operations launched inside the harness's ``learner.collect`` range
(the reset, the policy's forwards and sampling, the 40 env steps), less
the discriminator's reward inside it (``learner.disc``), over the traced
iterations.

Layer: GAIL rollout (``train/gail.py`` ``GAILTrainer.collect`` and
``BatchedEnv.reset``).  Moves train_samples_per_s."""

LAYER = 'GAIL rollout'
UNIT = 'ms'
MOVES = 'train_samples_per_s'


def read(ctx):
    iterations = getattr(ctx, 'iterations', None)
    us = ctx.trace.device_us(('learner.collect',), ('learner.disc',))
    if not us or not iterations:
        return None
    return us / iterations / 1e3
