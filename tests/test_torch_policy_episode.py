"""The closed-loop hold that scores: the JAX-trained GAIL policy
(gail_policy.msgpack) driving magical_tpu's BatchedEnv in flax, against
the same weights carried into the port (models/convert.py) driving the
port's BatchedEnv on the CPU, greedy and in float32, over a whole
MoveToRegion-Demo episode.  Each side acts on its own observations, so a
difference anywhere in the stack (render, frame stack, network, physics,
score) shows as another action or another score.  GAIL_RESULT.json records
that this policy scores 1.0 greedy on this env.

The JAX side is recorded in tests/fixtures/torch_policy_episode.npz by
tests/_torch_policy_episode_fixture.py (XLA takes ~10 s to compile its
env step on the CPU); flax recomputes the recorded logits here on the
recorded observations, and the same policy's logits there are held in
float32 and in bfloat16, its working type.

The slow tier adds the port's twin of tests/test_training.py's BC
efficacy test on the CPU."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from magical_tpu.models import nets as JN
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.models import convert
from magical_tpu_torch.models.nets import MagicalCNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(REPO, 'gail_policy.msgpack')
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'torch_policy_episode.npz')
ENV = 'MoveToRegion-Demo-LoRes4E-v0'
# The two engines' lo frames differ by at most 1 level on at most 0.1% of
# the values (tests/test_torch_env.py), which moves the logits by far
# less than this: only where JAX's own top-two margin is this small may
# the greedy actions differ.
TIE_MARGIN = 1e-4
# logits on the same observations, relative to the largest logit.
# float32: the trained full-width weights carry the sums' rounding further
# than tests/test_torch_nets.py's random small nets (GroupNorm's fast
# variance E[x²] - E[x]² cancels where a group's mean is large against
# its spread): measured 1.4e-5, held to 1e-4.  bfloat16: one bfloat16 ulp
# carried through the layers, as there.
F32_RTOL = 1e-4
BF16_RTOL = 3e-2


@pytest.fixture(scope='module')
def reference():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _port_net(dtype):
    net = MagicalCNN(with_value_head=True, dtype=dtype)
    net.load_state_dict(convert.params_from_flax(
        convert.read_flax_msgpack(POLICY)))
    return net


def _flax_apply(dtype):
    """The committed policy in flax (read by flax's own msgpack reader):
    a jitted obs -> (logits, value)."""
    net = JN.MagicalCNN(with_value_head=True, dtype=dtype)
    template = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 96, 96, 12), jnp.uint8))
    with open(POLICY, 'rb') as f:
        params = meta.unbox(flax.serialization.from_state_dict(
            template, flax.serialization.msgpack_restore(f.read())))
    apply = jax.jit(net.apply)
    return lambda obs: apply(params, jnp.asarray(obs))


def test_greedy_policy_episode_matches_the_reference(reference, capsys):
    """Equal greedy actions at every step (except where JAX's top-two
    margin is under TIE_MARGIN, printed), equal dones, equal end scores,
    and those scores 1.0."""
    net = _port_net(torch.float32)
    env = BatchedEnv(ENV, device='cpu')
    batch = reference['score'].shape[0]
    ties = []
    # inference mode: the plain CPU step is op-dispatch bound (~0.2-0.4 s
    # at 2 envs), and this cuts ~a quarter of it
    with torch.inference_mode():
        c, o = env.reset(0, batch)
        for t in range(env.max_episode_steps):
            jl = reference['logits'][t]
            ta = net(o)[0].argmax(-1).numpy()
            top2 = np.sort(jl, -1)[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
            for e in np.flatnonzero(jl.argmax(-1) != ta):
                assert margin[e] < TIE_MARGIN, (t, e, margin[e])
                ties.append((t, e, float(margin[e])))
            c, o, _, d, i = env.step(c, torch.from_numpy(ta.astype(np.int32)))
            np.testing.assert_array_equal(d.numpy(), reference['done'][t])
    with capsys.disabled():
        for t, e, m in ties:
            print(f'\nstep {t} env {e}: actions differ at JAX margin {m:.2e}')
    score = i['eval_score'].numpy()
    np.testing.assert_array_equal(score, reference['score'])
    assert (score == 1.0).all(), score


def test_committed_policy_logits_on_real_observations(reference):
    """The committed policy at full width on the 8 recorded observations
    of JAX's episode (steps 0, 10, 20 and 39 of both envs): flax gives the
    recorded logits again (the fixture is this policy's), and the port the
    same greedy actions, logits and values within the stated tolerances,
    in float32 and in bfloat16."""
    obs = reference['obs']
    steps = reference['obs_steps']
    recorded = reference['logits'][steps].reshape(len(obs), -1)
    for jdt, tdt, rtol in ((jnp.float32, torch.float32, F32_RTOL),
                           (jnp.bfloat16, torch.bfloat16, BF16_RTOL)):
        want, want_v = _flax_apply(jdt)(obs)
        if jdt == jnp.float32:
            np.testing.assert_allclose(np.asarray(want), recorded,
                                       rtol=0, atol=1e-5)
        with torch.no_grad():
            got, got_v = _port_net(tdt)(torch.from_numpy(obs))
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
        for g, w in ((got, want), (got_v, want_v)):
            w = np.asarray(w, np.float32)
            assert np.abs(g.float().numpy() - w).max() \
                <= rtol * np.abs(w).max()


@pytest.mark.slow
def test_bc_learns_move_to_region():
    """The port's twin of tests/test_training.py's BC efficacy test, on
    the CPU: the scripted expert on MoveToRegion-Demo -> 300 BC steps ->
    a greedy Demo score of at least 0.8."""
    from magical_tpu_torch.tools.train_gail_mtr import (collect_expert,
                                                        eval_policy)
    from magical_tpu_torch.train.bc import BCTrainer
    env = BatchedEnv(ENV, device='cpu')
    ds_obs, ds_act, expert_scores = collect_expert(env, 24)
    assert expert_scores.mean() >= 0.9, 'scripted expert must be good'
    trainer = BCTrainer(obs_shape=ds_obs.shape[1:], lr=1e-3, seed=1,
                        device='cpu')
    rng = np.random.default_rng(0)
    for _ in range(300):
        idx = rng.choice(len(ds_act), size=128, replace=False)
        metrics = trainer.train_step(ds_obs[idx], ds_act[idx])
    assert float(metrics['acc']) > 0.7
    scores, _ = eval_policy(env, trainer.net, 16, seed=5, greedy=True)
    assert scores.mean() >= 0.8, f'BC policy scored {scores.mean():.3f}'
