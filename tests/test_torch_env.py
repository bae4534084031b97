"""The whole slice: magical_tpu_torch's BatchedEnv against magical_tpu's,
and what the port refuses or does without a GPU."""

import functools
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magical_tpu.api.batched_env import BatchedEnv as JaxEnv
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.core import physics_kernel, render_kernel

from _torch_port import A, jax_to_numpy, torch_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
# Per-env actions for which 8 control steps stay well-conditioned (no
# finger/block contact, so the chaos of tests/fixtures/chaos_floor.json
# has not set in): the two engines then agree to ~1e-7 in pose.
STEADY = np.array([A['UpOpen'], A['RightOpen'], A['LeftClose'],
                   A['DownClose']], np.int32)
POSE_ATOL = 1e-4
# lo frames: at most 1 level apart on at most 0.1% of the channel values
# (AA coverage rounding; see tests/test_torch_render.py)
LO_MAX_LEVELS = 1
LO_MAX_SHARE = 1e-3


@functools.lru_cache(maxsize=None)
def _jax_env(name):
    return JaxEnv(name)


def _assert_obs_close(jo, to):
    if isinstance(jo, dict):
        assert jo.keys() == to.keys()
        for v in jo:
            _assert_obs_close(jo[v], to[v])
        return
    a = np.asarray(jo).astype(int)
    b = to.numpy().astype(int)
    assert a.shape == b.shape
    assert to.dtype == torch.uint8
    d = np.abs(a - b)
    assert d.max() <= LO_MAX_LEVELS
    assert (d > 0).mean() <= LO_MAX_SHARE


@pytest.mark.parametrize('name', ['MoveToCorner-Demo-LoRes4E-v0',
                                  'MoveToCorner-Demo-LoRes3EA-v0'])
def test_batched_env_matches_reference(name):
    je, te = _jax_env(name), BatchedEnv(name)
    jc, jo = je.reset(jax.random.split(jax.random.PRNGKey(0), B))
    tc, to = te.reset(0, B)
    _assert_obs_close(jo, to)
    for _ in range(8):
        jc, jo, jr, jd, ji = je.step(jc, jnp.asarray(STEADY))
        tc, to, tr, td, ti = te.step(tc, torch.from_numpy(STEADY))
        _assert_obs_close(jo, to)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jn, tn = jax_to_numpy(jc.state), torch_to_numpy(tc.state)
    np.testing.assert_allclose(tn['pos'], jn['pos'], atol=POSE_ATOL)
    np.testing.assert_allclose(tn['angle'], jn['angle'], atol=POSE_ATOL)
    np.testing.assert_array_equal(tn['t'], jn['t'])
    assert tc.t == 8


def test_last_step_is_done_with_the_reference_score():
    name = 'MoveToCorner-Demo-LoRes4E-v0'
    je, te = _jax_env(name), BatchedEnv(name)
    jc, _ = je.reset(jax.random.split(jax.random.PRNGKey(0), B))
    tc, _ = te.reset(0, B)
    # t = 79, and the block moved towards the corner so that the score
    # ramp is away from its clip: positions differ per env
    blk = np.array([[-0.5, 0.5], [-0.6, 0.55], [-0.3, 0.2], [0.2, -0.4]],
                   np.float32)
    pos = np.array(jc.state.pos)
    pos[:, 5] = blk
    jc = jc.replace(state=jc.state.replace(
        pos=jnp.asarray(pos), t=jnp.full((B,), 79, jnp.int32)))
    tc.state.pos[:, 5] = torch.from_numpy(blk)
    tc.state.t.fill_(79)
    tc.t = 79
    jc, _, _, jd, ji = je.step(jc, jnp.asarray(STEADY))
    tc, _, _, td, ti = te.step(tc, torch.from_numpy(STEADY))
    assert np.asarray(jd).all() and td.all()
    js, ts = np.asarray(ji['eval_score']), ti['eval_score'].numpy()
    assert (js > 0).any() and (js < 1).any()
    # the block barely moves in one step; scores agree to float32 rounding
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_array_equal(ti['n_placement_failures'].numpy(),
                                  np.asarray(ji['n_placement_failures']))


def test_other_preprocessors_reset_and_step():
    """LoResStack, LoResCHW4E and LoRes4A assemble the same frames as
    LoRes4E in their own layouts (their byte layout against the reference
    is held by tests/test_torch_render.py)."""
    def run(name):
        env = BatchedEnv(f'MoveToCorner-Demo-{name}-v0')
        carry, obs = env.reset(0, B)
        out = [obs]
        for _ in range(5):
            carry, obs, *_ = env.step(carry, torch.from_numpy(STEADY))
            out.append(obs)
        return out

    ego, allo = run('LoRes4E'), run('LoRes4A')
    for name in ('LoResStack', 'LoResCHW4E'):
        for t, obs in enumerate(run(name)):
            if name == 'LoResStack':
                assert torch.equal(obs['ego'], ego[t])
                assert torch.equal(obs['allo'], allo[t])
            else:
                assert torch.equal(obs, ego[t].permute(0, 3, 1, 2))
    # the reset frame fills the stack; each step shifts it by one frame
    assert torch.equal(ego[0][..., :3], ego[0][..., 9:])
    assert torch.equal(ego[4][..., 3:], ego[5][..., :9])


def test_rollout_and_cpu_path_launch_nothing():
    physics_kernel.control_step.launches = 0
    render_kernel.render_into_slots.launches = 0
    render_kernel.render_views_lo.launches = 0
    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0')
    carry, obs = env.reset(torch.Generator().manual_seed(1), 2)

    def policy(obs, gen):
        return torch.randint(0, 18, (obs.shape[0],), generator=gen)

    carry, obs, rews, dones, scores = env.rollout(
        carry, obs, policy, torch.Generator().manual_seed(2), length=3)
    assert rews.shape == dones.shape == scores.shape == (3, 2)
    assert obs.shape == (2, 96, 96, 12) and obs.dtype == torch.uint8
    assert carry.t == 3 and carry.state.t.tolist() == [3, 3]
    assert physics_kernel.control_step.launches == 0
    assert render_kernel.render_into_slots.launches == 0
    assert render_kernel.render_views_lo.launches == 0


@pytest.mark.parametrize('name,kw', [
    ('MoveToRegion-Demo-LoRes4E-v0', {}),
    ('MoveToCorner-TestJitter-LoRes4E-v0', {}),
    ('MoveToCorner-TestShape-LoRes4E-v0', {}),
    ('MoveToCorner-Demo-v0', {}),
    ('MoveToCorner-Demo-DebugReward-v0', {}),
    ('MoveToCorner-Demo-LoRes4E-v0', {'fidelity': 'hi', 'device': 'cuda'}),
])
def test_outside_the_slice_raises(name, kw):
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        BatchedEnv(name, **kw)


def test_lockstep_check(monkeypatch):
    monkeypatch.setenv('MAGICAL_TPU_DEBUG_LOCKSTEP', '1')
    env = BatchedEnv('MoveToCorner-Demo-LoRes4E-v0')
    carry, _ = env.reset(0, 2)
    carry, *_ = env.step(carry, torch.zeros(2, dtype=torch.int32))
    carry.state.t[0] += 1
    with pytest.raises(AssertionError, match='lockstep'):
        env.step(carry, torch.zeros(2, dtype=torch.int32))


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
