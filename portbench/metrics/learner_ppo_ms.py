"""learner_ppo_ms: device milliseconds an iteration of the PPO epochs:
the operations launched inside the harness's ``learner.ppo`` range (every
minibatch step, with its GAE, forward, backward and Adam step; a
backward's operations by the time of their launch), over the traced
iterations.

Layer: GAIL PPO update (``train/gail.py`` ``GAILTrainer.ppo_update``).
Moves train_samples_per_s."""

LAYER = 'GAIL PPO update'
UNIT = 'ms'
MOVES = 'train_samples_per_s'


def read(ctx):
    iterations = getattr(ctx, 'iterations', None)
    us = ctx.trace.device_us(('learner.ppo',))
    if not us or not iterations:
        return None
    return us / iterations / 1e3
