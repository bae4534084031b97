"""The reference against itself under a change of rounding alone: each leg
of tests/fixtures/torch_episode_reference.npz run again on magical_tpu's
XLA `control_step` jitted for a smaller batch (vmap over `--batch` envs,
1 by default, call after call) instead of the fixture's batch of 64, from
the same resets under the same actions.  XLA's CPU step built for one env
rounds apart from its build for 64, so this is a path that is right and
rounds apart from the fixture's, as the port does: it has to pass both
parts of the hold
(tests/_torch_episode_fixture.hold against
tests/fixtures/torch_episode_floor.json), the end part by its whole
episodes and the step part by one step, at batch 1, into each step
horizon from the fixture's unmoved state.  Prints its statistics, each
part's verdict with the candidate's T beside the draws' largest T, and
the replaced quantile gate's verdict per leg.

Each leg's run is kept under build/episode_fixture/ (named like the
writer's runs), so a second call only holds them.  Run (one leg a
process, all at once; a few minutes for MoveToCorner and ~15 for each
other leg on a busy host):

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 \\
        python tests/_torch_episode_rounding.py [--batch N]
"""

import argparse
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault('MAGICAL_TPU_PALLAS', '0')

from _torch_episode_fixture import (  # noqa: E402
    B, STEP_FIELDS, TASKS, leg_reset, part_path, step_horizons, step_maxima,
    step_pair, step_stats)
from _torch_episode_mutants import (load_fixture, load_floor,  # noqa: E402
                                    verdicts)


def split_run(task, n):
    """The leg `n` envs a call: end positions and scores, as
    _torch_episode_mutants.run_leg gives them."""
    import jax
    import jax.numpy as jnp

    from magical_tpu.core import physics as P
    from magical_tpu.tasks import ALL_TASKS

    t = ALL_TASKS[task]
    step = jax.jit(jax.vmap(P.control_step))
    acts = load_fixture()[f'{task}/actions']
    resets = leg_reset(task)
    out = {k: [] for k in ('end_pos', 'score')}
    for e in range(0, B, n):
        st = jax.tree_util.tree_map(lambda x: x[e:e + n], resets)
        for a in acts[:, e:e + n]:
            st = step(st, jnp.asarray(a))
        out['end_pos'].append(np.asarray(st.pos))
        out['score'].append(np.asarray(jax.vmap(t.score_fn)(st)))
    return {k: np.concatenate(v) for k, v in out.items()}


def split_steps(task, n):
    """The leg's step part `n` envs a call: step_stats of one XLA step
    into each step horizon from the fixture's unmoved state."""
    import jax
    import jax.numpy as jnp

    from magical_tpu.core import physics as P

    step = jax.jit(jax.vmap(P.control_step))
    like = leg_reset(task)
    data = load_fixture()
    maxima = {}
    for h in step_horizons(task):
        before, act, after = step_pair(data, task, h)
        rows = []
        for e in range(0, B, n):
            st = like.replace(**{k: jnp.asarray(v[e:e + n])
                                 for k, v in before.items()})
            nxt = step(st, jnp.asarray(act[e:e + n]))
            rows.append({f: np.asarray(getattr(nxt, f)) for f in STEP_FIELDS})
        maxima[h] = step_maxima({f: np.concatenate([r[f] for r in rows])
                                 for f in STEP_FIELDS}, after)
    return step_stats(maxima)


def kept_run(task, n):
    path = part_path(task, 'one_env' if n == 1 else f'batch{n}')
    if not os.path.exists(path):
        np.savez(path + '.tmp.npz', **split_run(task, n))
        os.replace(path + '.tmp.npz', path)
        print(task, f'batch-{n} run done', flush=True)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def main(argv=None):
    import multiprocessing as mp
    p = argparse.ArgumentParser()
    p.add_argument('--batch', type=int, default=1)
    n = p.parse_args(argv).batch
    assert B % n == 0 and n < B, n
    os.makedirs(os.path.dirname(part_path(TASKS[0], None)), exist_ok=True)
    with mp.get_context('spawn').Pool(len(TASKS)) as pool:
        runs = dict(zip(TASKS, pool.map(functools.partial(kept_run, n=n),
                                        TASKS, chunksize=1)))
        steps = dict(zip(TASKS, pool.map(functools.partial(split_steps, n=n),
                                         TASKS, chunksize=1)))
    v = verdicts(runs, steps, load_fixture(), load_floor())
    print(json.dumps(dict(candidate=f'XLA at batch {n}', quantile_gate={
        t: int(sum(g.values())) for t, g in v['gate'].items()},
        end=v['end'], step=v['step'], stats=v['stats'])), flush=True)


if __name__ == '__main__':
    main()
