"""magical_tpu_torch's batch-1 Gym adapter and its gymnasium shim, on the
CPU (the plain versions of the kernels, with ``device='cpu'``)."""

import pickle

import numpy as np
import pytest
import torch

from magical_tpu_torch.api import gym_interop, registry
from magical_tpu_torch.core import render

NAME = 'MoveToRegion-TestAll-LoRes4E-v0'


def _to_last_step(env):
    """Move the adapter's episode to the step before its last."""
    t = env.max_episode_steps - 1
    env._carry.t = t
    env._carry.state.t.fill_(t)


def test_adapter_reset_step_score_and_end():
    env = registry.make(NAME, device='cpu')
    assert env.seed(5) == [5]
    obs = env.reset()
    assert obs.shape == (96, 96, 12) and obs.dtype == np.uint8
    assert env.observation_space.contains(obs)
    obs, rew, done, info = env.step(env.action_space.sample())
    assert obs.shape == (96, 96, 12) and rew == 0.0 and done is False
    assert set(info) == {'eval_score', 'n_placement_failures'}
    assert info['eval_score'] == 0.0
    _to_last_step(env)
    obs, rew, done, info = env.step(0)
    assert done is True
    assert info['eval_score'] == env.score_on_end_of_traj() in (0.0, 1.0)


def test_adapter_pickles_mid_episode():
    env = registry.make(NAME, device='cpu')
    env.seed(11)
    env.reset()
    for a in (4, 7, 2):
        env.step(a)
    env2 = pickle.loads(pickle.dumps(env))
    assert env2.device == env.device and env2._carry.t == 3
    for a in (2, 9):
        o1, r1, d1, i1 = env.step(a)
        o2, r2, d2, i2 = env2.step(a)
        np.testing.assert_array_equal(o1, o2)
        assert (r1, d1, i1) == (r2, d2, i2)
    # the generator travelled too: the next resets draw alike
    np.testing.assert_array_equal(env.reset(), env2.reset())


def test_adapter_raw_observations_render_and_entity_spec(capsys):
    env = registry.make('MoveToCorner-TestAll-v0', device='cpu')
    env.seed(2)
    obs = env.reset()
    assert set(obs) == {'allo', 'ego'}
    assert all(v.shape == (384, 384, 3) and v.dtype == np.uint8
               for v in obs.values())
    frames = env.render()
    st = env._carry.state
    b = env._batched
    plain = render.render_views(st, b.task.max_blocks, b.task.max_goals,
                                b.robot_first, views=('allo', 'ego'))
    for v in ('allo', 'ego'):
        np.testing.assert_array_equal(frames[v], plain[v][0].numpy())
    env.debug_print_entity_spec()
    out = capsys.readouterr().out
    assert 'ROBOT_POSE' in out and 'BLOCK_SHAPES' in out


def test_debug_reward_ids_reward_the_shaping():
    env = registry.make('MoveToCorner-Demo-DebugReward-LoRes4E-v0',
                        device='cpu')
    env.seed(0)
    obs = env.reset()
    assert set(obs) == {'allo', 'ego'}            # raw, as registered
    _, rew, _, _ = env.step(0)
    assert rew < 0.0


def test_gymnasium_shim():
    gymnasium = pytest.importorskip('gymnasium')
    registry.register_envs()
    env = gymnasium.make(gym_interop.gym_id(NAME), device='cpu')
    assert isinstance(env.action_space, gymnasium.spaces.Discrete)
    obs, info = env.reset(seed=7)
    assert obs.shape == (96, 96, 12) and info == {}
    out = env.step(env.action_space.sample())
    assert len(out) == 5
    obs, rew, terminated, truncated, info = out
    assert terminated is False and truncated is False
    assert 'eval_score' in info
    assert env.render().shape == (96, 96, 3)
    # the JAX package's bare IDs are not the port's
    assert gym_interop.gym_id(NAME) != NAME
    env.close()


def test_adapter_state_is_numpy_and_restores_onto_its_device():
    env = registry.make(NAME, device='cpu')
    env.seed(1)
    env.reset()
    st = env.__getstate__()
    assert st['device'] == 'cpu'
    assert isinstance(st['carry']['state']['pos'], np.ndarray)
    env2 = object.__new__(type(env))
    env2.__setstate__(st)
    assert env2._carry.state.pos.device == torch.device('cpu')
    assert torch.equal(env2._carry.state.pos, env._carry.state.pos)
