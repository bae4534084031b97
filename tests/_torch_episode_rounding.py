"""The reference against itself under a change of rounding alone: each leg
of tests/fixtures/torch_episode_reference.npz run again on magical_tpu's
XLA `control_step` jitted for one env (vmap over a batch of 1, env after
env) instead of the fixture's batch of 64, from the same resets under the
same actions, and its end poses and scores compared with the fixture's by
the gate's statistics (tests/_torch_episode_fixture.draw_stats), printed
beside the gate of tests/fixtures/torch_episode_floor.json.  XLA's CPU
step built for one env rounds apart from its build for 64, so this is a
path that is right and rounds apart from the fixture's, as the port does.

Run (a few minutes a leg on one CPU core, ClusterColour the longest):

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 \\
        python tests/_torch_episode_rounding.py [TASK ...]
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))
os.environ.setdefault('MAGICAL_TPU_PALLAS', '0')

from _torch_episode_fixture import (B, FLOOR, OUT, TASKS,  # noqa: E402
                                    draw_stats)


def one_env_run(task, acts):
    """End poses and scores of the leg, one env a call."""
    import jax
    import jax.numpy as jnp

    from magical_tpu.core import physics as P
    from magical_tpu.tasks import ALL_TASKS

    t = ALL_TASKS[task]
    step = jax.jit(jax.vmap(P.control_step))
    reset = jax.jit(jax.vmap(lambda k: t.reset_fn(k, t.flags_for('Demo'))))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    pos, score = [], []
    for e in range(B):
        st = reset(keys[e:e + 1])
        for a in acts[:, e:e + 1]:
            st = step(st, jnp.asarray(a))
        pos.append(np.asarray(st.pos))
        score.append(np.asarray(jax.vmap(t.score_fn)(st)))
    return np.concatenate(pos), np.concatenate(score)


def main(tasks):
    with np.load(OUT) as f:
        data = {k: f[k] for k in f.files}
    with open(FLOOR) as f:
        floor = json.load(f)
    for task in tasks:
        pos, score = one_env_run(task, data[f'{task}/actions'])
        stats = draw_stats(pos, score, data[f'{task}/end/pos'],
                           data[f'{task}/score'])
        print(task, 'XLA at batch 1 against the fixture:', json.dumps(stats),
              'gate:', json.dumps(floor[task]['gate']), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:] or TASKS)
