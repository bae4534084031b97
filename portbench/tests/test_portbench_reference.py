"""The frozen reference against the port's plain path on the CPU, bit for
bit: the reset from a seed, one step, the lo and hi frames, the stacked
observation and the score, on the configurations' Demo and TestAll
variants (MoveToRegion's through the learner's configuration).  (The port
on ``device='cpu'`` runs the plain PyTorch versions the reference was
copied from.)"""

import dataclasses
import json

import pytest
import torch

from magical_tpu_torch.api.batched_env import BatchedEnv
from portbench.harness import spec
from portbench.reference.env import Scene

B = 3
CASES = [(cfg, variant) for cfg in ('move-to-corner', 'cluster-colour',
                                    'gail-move-to-region')
         for variant in ('Demo', 'TestAll')]


def config(name):
    return json.loads((spec.HERE / 'configs' / f'{name}.json').read_text())


def assert_same_state(port, ref):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


@pytest.mark.parametrize('name,variant', CASES)
def test_reset_step_observation_and_score(name, variant):
    cfg = config(name)
    env_id = f'{cfg["task"]}-{variant}-{cfg["preproc"]}-v0'
    env = BatchedEnv(env_id, device='cpu')
    scene = Scene(cfg, variant, 'lo')
    carry, obs = env.reset(torch.Generator().manual_seed(11), B)
    ref = scene.reset(torch.Generator().manual_seed(11), B, 'cpu')
    assert_same_state(carry.state, ref)
    frames = [scene.frames(ref)]
    assert torch.equal(obs, scene.observation(frames))
    act = torch.tensor([3, 10, 16], dtype=torch.int32)
    for _ in range(2):
        carry, obs, _, done, info = env.step(carry, act)
        ref = scene.step(ref, act)
        frames.append(scene.frames(ref))
    assert_same_state(carry.state, ref)
    assert torch.equal(obs, scene.observation(frames))
    assert torch.equal(env.task.score_fn(carry.state), scene.score(ref))


@pytest.mark.parametrize('name,variant', CASES)
def test_hi_frames(name, variant):
    cfg = config(name)
    env_id = f'{cfg["task"]}-{variant}-{cfg["preproc"]}-v0'
    env = BatchedEnv(env_id, fidelity='hi', device='cpu')
    scene = Scene(cfg, variant, 'hi')
    carry, obs = env.reset(torch.Generator().manual_seed(5), 2)
    ref = scene.reset(torch.Generator().manual_seed(5), 2, 'cpu')
    assert torch.equal(obs, scene.observation([scene.frames(ref)]))
