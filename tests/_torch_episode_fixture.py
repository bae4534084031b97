"""Write tests/fixtures/torch_episode_reference.npz: the whole-episode
reference that tests/test_torch_episode.py and chip_smoke.py's
`[episode]` phase hold magical_tpu_torch against.

The legs are those of scripts/chaos_floor.py, whose 1-ulp self-divergence
(tests/fixtures/chaos_floor.json) bounds the port's divergence: B = 64
Demo resets from PRNGKey(0), its 40-action script repeated, and `ep_len`
steps of the XLA `control_step` (MatchRegions 120, ClusterColour 240).
Each step is one call of a jitted, vmapped `control_step` from a Python
loop (a `lax.scan` over the episode takes hours to compile on the CPU).

For each task the file holds, under `<task>/`:
  reset/<field>, step1/<field>, end/<field>   every EnvState field, (B, ...)
  score                                         (B,) end scores
  nudge<k>/<field>   the step-1 state of the first N_NUDGED envs from the
                     reset with every position (k = 0, 1) or angle (k = 2,
                     3) moved 1 ulp up or down: the reference's own
                     one-step chaos
  trace_steps, trace_pos, trace_angle   poses at a few steps, to bisect
and `actions`, the action of every step (the same for every env).

Run (about fifteen minutes on the CPU, most of it ClusterColour):

    JAX_PLATFORMS=cpu MAGICAL_TPU_PALLAS=0 python tests/_torch_episode_fixture.py
"""

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault('MAGICAL_TPU_PALLAS', '0')

OUT = os.path.join(REPO, 'tests', 'fixtures', 'torch_episode_reference.npz')
B = 64
N_NUDGED = 8
TASKS = ('MatchRegions', 'ClusterColour')
TRACE_STEPS = (1, 2, 5, 10, 20, 40, 80, 120, 160, 200, 240)


def action_script(n_steps):
    """scripts/chaos_floor.py's action script, one action per step."""
    from magical_tpu import constants as C
    A = {n: i for i, n in enumerate(C.ACTION_NAMES)}
    script = [A['UpOpen']] * 10 + [A['UpLeftOpen']] * 6 + [A['UpOpen']] * 10 \
        + [A['UpRightOpen']] * 6 + [A['UpClose']] * 8
    return [script[t % len(script)] for t in range(n_steps)]


def _fields(state, prefix, out, rows=slice(None)):
    for f in dataclasses.fields(state):
        out[f'{prefix}/{f.name}'] = np.asarray(getattr(state, f.name))[rows]


def main():
    import jax
    import jax.numpy as jnp

    from magical_tpu.core import physics as P
    from magical_tpu.tasks import ALL_TASKS

    step = jax.jit(jax.vmap(P.control_step))
    out = {'actions': np.asarray(action_script(max(
        ALL_TASKS[t].ep_len for t in TASKS)), np.int32)}
    for name in TASKS:
        task = ALL_TASKS[name]
        keys = jax.random.split(jax.random.PRNGKey(0), B)
        st = jax.jit(jax.vmap(
            lambda k: task.reset_fn(k, task.flags_for('Demo'))))(keys)
        _fields(st, f'{name}/reset', out)
        a0 = jnp.full((B,), out['actions'][0], jnp.int32)
        for k, (f, d) in enumerate((('pos', np.inf), ('pos', -np.inf),
                                    ('angle', np.inf), ('angle', -np.inf))):
            x = np.nextafter(np.asarray(getattr(st, f)), np.float32(d))
            nudged = step(st.replace(**{f: jnp.asarray(x)}), a0)
            _fields(nudged, f'{name}/nudge{k}', out, slice(0, N_NUDGED))
        trace = [s for s in TRACE_STEPS if s <= task.ep_len]
        tpos, tang = [], []
        for t in range(task.ep_len):
            st = step(st, jnp.full((B,), out['actions'][t], jnp.int32))
            if t + 1 == 1:
                _fields(st, f'{name}/step1', out)
            if t + 1 in trace:
                tpos.append(np.asarray(st.pos))
                tang.append(np.asarray(st.angle))
        _fields(st, f'{name}/end', out)
        out[f'{name}/score'] = np.asarray(jax.vmap(task.score_fn)(st))
        out[f'{name}/trace_steps'] = np.asarray(trace, np.int32)
        out[f'{name}/trace_pos'] = np.stack(tpos)
        out[f'{name}/trace_angle'] = np.stack(tang)
        print(name, 'scores', out[f'{name}/score'].tolist(), flush=True)
    np.savez_compressed(OUT, **out)
    print(f'wrote {OUT} ({os.path.getsize(OUT)} bytes)', flush=True)


if __name__ == '__main__':
    main()
