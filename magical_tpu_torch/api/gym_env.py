"""Single-environment Gym-style adapter over the batched engine.

The PyTorch counterpart of ``magical_tpu/api/gym_env.py``: the familiar
interface of the reference's BaseEnv (base_env.py:60-343) —
``reset() -> obs``, ``step(a) -> (obs, rew, done, info)``, ``seed``,
``render``, ``observation_space``/``action_space``,
``score_on_end_of_traj`` — over a batch-1 :class:`BatchedEnv` on one
device (the card unless ``device='cpu'``).  Observations and frames
come back as numpy arrays.

    env = MagicalGymEnv('MoveToRegion-TestAll-v0', fidelity='hi')
    env.seed(0)
    obs = env.reset()              # {'allo', 'ego'}: (384, 384, 3) uint8
    obs, rew, done, info = env.step(3)
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.api.batched_env import BatchedEnv, EnvCarry
from magical_tpu_torch.core.convert import state_from_numpy, state_to_numpy


def _first_np(x):
    """Env 0 of a batched tensor (or a dict of them), as numpy."""
    if isinstance(x, dict):
        return {k: _first_np(v) for k, v in x.items()}
    return x[0].cpu().numpy()


class MagicalGymEnv:
    metadata = {'render.modes': ['rgb_array']}

    def __init__(self, env_name: str, fidelity: str = 'lo',
                 device: Union[str, torch.device] = 'cuda'):
        self._batched = BatchedEnv(env_name, fidelity=fidelity,
                                   device=device)
        self.env_name = env_name
        self.device = self._batched.device
        self.max_episode_steps = self._batched.max_episode_steps
        self.fps = 8
        self.action_space = self._batched.action_space
        self.observation_space = self._batched.observation_space
        self._carry = None
        self._seed = None
        self._gen = None
        self.seed()

    def seed(self, seed=None):
        """base_env.py:133-140 semantics: re-seed the generator every
        following reset draws from."""
        if seed is None:
            seed = int(np.random.randint(0, (1 << 31) - 1))
        self._seed = seed
        self._gen = torch.Generator().manual_seed(seed)
        return [seed]

    def reset(self):
        self._carry, obs = self._batched.reset(self._gen, 1)
        return _first_np(obs)

    def step(self, action):
        assert self._carry is not None, 'call reset() first'
        a = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        self._carry, obs, rew, done, info = self._batched.step(self._carry, a)
        info_np = {k: float(v[0]) for k, v in info.items()}
        return _first_np(obs), float(rew[0]), bool(done[0]), info_np

    def render(self, mode='rgb_array'):
        """Raw dual-camera frames of the current state, {'allo', 'ego'}:
        (384, 384, 3) uint8 at hi fidelity, (96, 96, 3) at lo."""
        res = 384 if self._batched.fidelity == 'hi' else 96
        return _first_np(self._batched.render_views(
            self._carry.state, res, ('allo', 'ego')))

    def score_on_end_of_traj(self):
        return float(self._batched.task.score_fn(self._carry.state)[0])

    def debug_print_entity_spec(self):
        """base_env.py:345-400 — print the current scene layout in the
        reference's copy-pasteable format."""
        st = state_to_numpy(self._carry.state)
        pos, ang = st['pos'][0], st['angle'][0]

        def f_pose(p, a):
            return '((%.3f, %.3f), %.3f)' % (p[0], p[1], a)

        print(f'ROBOT_POSE = {f_pose(pos[0], ang[0])}')
        act = st['block_active'][0]
        if act.any():
            cols, shapes = st['block_colour'][0], st['block_shape'][0]
            idx = np.nonzero(act)[0]
            print('BLOCK_COLOURS = [' + ', '.join(
                f'en.ShapeColour.{C.SHAPE_COLOUR_NAMES[cols[i]].upper()}'
                for i in idx) + ']')
            print('BLOCK_SHAPES = [' + ', '.join(
                f'en.ShapeType.{C.SHAPE_TYPE_NAMES[shapes[i]].upper()}'
                for i in idx) + ']')
            print('BLOCK_POSES = [' + ', '.join(
                f_pose(pos[5 + i], ang[5 + i]) for i in idx) + ']')
        gact = st['goal_active'][0]
        if gact.any():
            g, gc = st['goal_xyhw'][0], st['goal_colour'][0]
            idx = np.nonzero(gact)[0]
            print('GOAL_REGION_XYHWS = [' + ', '.join(
                '(%.3f, %.3f, %.3f, %.3f)' % (
                    g[i, 0] - g[i, 3] / 2, g[i, 1] + g[i, 2] / 2,
                    g[i, 2], g[i, 3]) for i in idx) + ']')
            print('GOAL_REGION_COLOURS = [' + ', '.join(
                f'en.ShapeColour.{C.SHAPE_COLOUR_NAMES[gc[i]].upper()}'
                for i in idx) + ']')

    def close(self):
        self._carry = None

    # -- pickling (EzPickle parity, base_env.py:20-46, plus live state) ----
    # The live carry travels as numpy and comes back onto the device the
    # adapter is rebuilt on.

    def __getstate__(self):
        carry = None
        if self._carry is not None:
            carry = {'state': state_to_numpy(self._carry.state),
                     'frames': {v: f.cpu().numpy()
                                for v, f in self._carry.frames.items()},
                     't': self._carry.t}
        return {'env_name': self.env_name,
                'fidelity': self._batched.fidelity,
                'device': str(self.device),
                'seed': self._seed,
                'generator': self._gen.get_state().numpy(),
                'carry': carry}

    def __setstate__(self, st):
        self.__init__(st['env_name'], fidelity=st['fidelity'],
                      device=st['device'])
        self.seed(st['seed'])
        self._gen.set_state(torch.from_numpy(st['generator']))
        c = st['carry']
        if c is not None:
            self._carry = EnvCarry(
                state=state_from_numpy(c['state'], self.device),
                frames={v: torch.from_numpy(f).to(self.device)
                        for v, f in c['frames'].items()},
                t=c['t'])
