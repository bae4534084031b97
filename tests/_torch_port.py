"""Shared helpers of the tests that hold magical_tpu_torch against
magical_tpu: JAX states to numpy and back, and the action schedules."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from magical_tpu import constants as JC
from magical_tpu.tasks import ALL_TASKS as JAX_TASKS
from magical_tpu_torch.core.convert import state_from_numpy, state_to_numpy

# The port's CPU tests run many small tensor ops, which gain nothing from
# intra-op threads; with several test workers on one host the threads
# only contend.
torch.set_num_threads(1)

A = {n: i for i, n in enumerate(JC.ACTION_NAMES)}


def jax_to_numpy(state) -> dict:
    return {f.name: np.array(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def jax_to_torch(state):
    return state_from_numpy(jax_to_numpy(state), 'cpu')


def torch_to_numpy(state) -> dict:
    return state_to_numpy(state)


def jax_demo_states(batch, task='MoveToCorner'):
    t = JAX_TASKS[task]
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    return jax.jit(jax.vmap(lambda k: t.reset_fn(k, t.flags_for('Demo'))))(
        keys)


def seek_block_actions(batch, n_steps):
    """(n_steps, B) int32: turn towards the block for 1-3 steps, then push
    it with the fingers open (first half of the envs) or closed."""
    seqs = []
    for b in range(batch):
        n_turn = 1 + b % 3
        push = 'UpOpen' if b < batch // 2 else 'UpClose'
        seqs.append([A['UpLeftOpen']] * n_turn
                    + [A[push]] * (n_steps - n_turn))
    return np.asarray(seqs, np.int32).T


def nudge_pos(jstate):
    """The JAX state with every position moved by one ulp (towards +inf):
    the input change that measures the reference's own chaos."""
    p = np.nextafter(np.asarray(jstate.pos), np.float32(np.inf))
    return jstate.replace(pos=jnp.asarray(p))


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def torch_actions(a):
    return torch.as_tensor(np.asarray(a, np.int32))
