"""Real Gym/Gymnasium registry integration.

The PyTorch counterpart of ``magical_tpu/api/gym_interop.py``.  The
reference's public surface is ``gym.make('MoveToCorner-Demo-v0')`` via
``gym.register`` entry points (benchmarks/__init__.py:976-999).  When
``gymnasium`` (or legacy ``gym``) is importable, ``register_envs`` also
registers every MAGICAL env ID there, wrapping the single-env adapter
(:class:`magical_tpu_torch.api.gym_env.MagicalGymEnv`) in a thin API shim.
The IDs live in the ``magical_tpu_torch`` namespace, so that they stand
beside the JAX package's bare IDs in one process:

    gymnasium.make('magical_tpu_torch/MoveToRegion-TestAll-v0',
                   fidelity='hi', device='cuda')

- gymnasium: new-style ``reset(seed=...) -> (obs, info)`` and 5-tuple
  ``step``; the episode time limit maps to ``truncated`` (the reference
  terminates via TimeLimit only, base_env.py:270-274).
- legacy gym: the adapter's native 4-tuple API is already a match.

The shim converts the duck-typed spaces (api/spaces.py) to the host
library's Box/Discrete/Dict so downstream IL code sees real spaces.
Without either library, registration is a no-op.
"""

from __future__ import annotations

import collections

NAMESPACE = 'magical_tpu_torch'

_GYM_REGISTERED = False


def gym_id(env_id: str) -> str:
    """The id under which `env_id` is registered with gymnasium / gym."""
    return f'{NAMESPACE}/{env_id}'


def _convert_space(space, gspaces):
    """api/spaces.* -> gymnasium/gym spaces."""
    from magical_tpu_torch.api import spaces as S
    if isinstance(space, S.Discrete):
        return gspaces.Discrete(space.n)
    if isinstance(space, S.Box):
        return gspaces.Box(low=space.low, high=space.high,
                           shape=space.shape, dtype=space.dtype)
    if isinstance(space, S.Dict):
        return gspaces.Dict(collections.OrderedDict(
            (k, _convert_space(v, gspaces))
            for k, v in space.spaces.items()))
    raise TypeError(f'unsupported space {space!r}')


def _make_gymnasium_cls(gymnasium):
    from magical_tpu_torch.api.gym_env import MagicalGymEnv

    class GymnasiumMagicalEnv(gymnasium.Env):
        """Gymnasium adapter over the batched engine (batch-1)."""

        metadata = {'render_modes': ['rgb_array']}

        def __init__(self, env_name: str, render_mode=None, **kwargs):
            self._env = MagicalGymEnv(env_name, **kwargs)
            self.env_name = env_name
            self.render_mode = render_mode or 'rgb_array'
            self.max_episode_steps = self._env.max_episode_steps
            self.fps = self._env.fps
            gs = gymnasium.spaces
            self.action_space = _convert_space(self._env.action_space, gs)
            self.observation_space = _convert_space(
                self._env.observation_space, gs)

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._env.seed(seed)
            obs = self._env.reset()
            return obs, {}

        def step(self, action):
            obs, rew, done, info = self._env.step(action)
            # the engine only ends episodes at the step limit
            return obs, rew, False, done, info

        def render(self):
            views = self._env.render()
            return views.get('allo', next(iter(views.values())))

        def score_on_end_of_traj(self):
            return self._env.score_on_end_of_traj()

        def debug_print_entity_spec(self):
            return self._env.debug_print_entity_spec()

        def close(self):
            self._env.close()

    return GymnasiumMagicalEnv


def register_gym_envs(env_ids):
    """Register `env_ids` (under `gym_id`) with gymnasium (preferred) or
    legacy gym.  No-op (returns False) when neither library is
    importable."""
    global _GYM_REGISTERED
    if _GYM_REGISTERED:
        return False
    try:
        import gymnasium
    except ImportError:
        gymnasium = None
    if gymnasium is not None:
        cls = _make_gymnasium_cls(gymnasium)
        registered = set(gymnasium.registry.keys())
        for env_id in env_ids:
            if gym_id(env_id) in registered:
                continue
            gymnasium.register(
                id=gym_id(env_id),
                entry_point=_entry_point_factory(cls, env_id),
                # the engine signals truncation itself; registering a
                # max_episode_steps would stack a second TimeLimit
                max_episode_steps=None,
                disable_env_checker=True,
            )
        _GYM_REGISTERED = True
        return True
    try:
        import gym
    except ImportError:
        return False
    from magical_tpu_torch.api.gym_env import MagicalGymEnv
    registered = set(getattr(gym.envs.registry, 'env_specs', {}))
    for env_id in env_ids:
        if gym_id(env_id) in registered:
            continue
        gym.register(id=gym_id(env_id),
                     entry_point=_entry_point_factory(MagicalGymEnv, env_id))
    _GYM_REGISTERED = True
    return True


def _entry_point_factory(cls, env_id):
    def entry_point(**kwargs):
        return cls(env_id, **kwargs)
    return entry_point
