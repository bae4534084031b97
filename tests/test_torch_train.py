"""magical_tpu_torch's learner (train/bc.py, train/gail.py) held against
magical_tpu's BC and GAIL trainers and optax, GAIL's collection and outer
loop on the port's env, the port's BatchedEnv(render_enabled=False) and
its benchmark CLI (tools/benchmark.py).

Every hold runs float32 on both sides from the same params (flax's init,
carried across by models/convert.params_from_flax) on the same numpy
inputs and indices.  The JAX trainers build their nets in bfloat16 with no
dtype argument, so the tests put float32 modules on the JAX trainer
instances before their first jitted call (the jitted bound methods trace
`self.net`, `self.policy` and `self.disc` then).  Sampling cannot match
JAX's threefry stream, so both sides get the same actions and indices.
"""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from magical_tpu.api.batched_env import BatchedEnv as JaxEnv
from magical_tpu.models import nets as JN
from magical_tpu.train import bc as JBC
from magical_tpu.train import gail as JG
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.core import render_kernel
from magical_tpu_torch.models.convert import params_from_flax
from magical_tpu_torch.train import bc as BC
from magical_tpu_torch.train import gail as G

from _torch_port import jax_to_numpy, torch_to_numpy

OBS = (24, 24, 12)
WIDTHS = (16, 32)
T, B = 8, 4
# float32 on both sides: the convolutions and sums round apart (the nets
# agree to ~1e-6 relative, tests/test_torch_nets.py), so losses agree to
# RTOL (measured 1.3e-6 at most) and parameters after an Adam step to
# PARAM_ATOL (measured 4.5e-7 at most): a first Adam step moves each
# parameter by ~lr·sign(g), and where |g| is near Adam's eps (1e-8) that
# ratio amplifies the gradient's rounding (on the card against the CPU it
# can flip the sign: tests/test_torch_cuda.py).
RTOL = 1e-5
PARAM_ATOL = 2e-6


def _np(x):
    return np.asarray(x)


def _port_params(params):
    """flax params (boxes and all) -> the port's state_dict."""
    return params_from_flax(jax.tree_util.tree_map(_np, meta.unbox(params)))


def _sd(params):
    return {k: v.numpy() for k, v in _port_params(params).items()}


def _assert_params_close(jax_params, module, atol=PARAM_ATOL):
    want = _sd(jax_params)
    got = {k: v.detach().cpu().numpy() for k, v in
           module.state_dict().items()}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def _obs(rng, n):
    return rng.integers(0, 256, (n,) + OBS, dtype=np.uint8)


# ---------------------------------------------------------------------------
# BC
# ---------------------------------------------------------------------------

def _bc_pair(lr=3e-4):
    jt = JBC.BCTrainer(obs_shape=OBS, lr=lr)
    jt.net = JN.MagicalCNN(widths=WIDTHS, dtype=jnp.float32)
    state = jax.jit(jt.init)(jax.random.PRNGKey(0))   # flax's eager init
    # compiles op by op
    tt = BC.BCTrainer(OBS, lr=lr, widths=WIDTHS, dtype=torch.float32,
                      device='cpu')
    tt.net.load_state_dict(_port_params(state.params))
    return jt, state, tt


def test_bc_step_matches_optax_adamw():
    """Two AdamW steps (decoupled decay on every parameter, biases and
    GroupNorm included): loss, acc and every parameter after each."""
    jt, state, tt = _bc_pair()
    rng = np.random.default_rng(0)
    for _ in range(2):
        obs, acts = _obs(rng, 16), rng.integers(0, 18, 16).astype(np.int32)
        state, jm = jt.train_step(state, jnp.asarray(obs), jnp.asarray(acts))
        tm = tt.train_step(obs, acts)
        assert tm['loss'].shape == () and tm['acc'].shape == ()
        np.testing.assert_allclose(float(tm['loss']), float(jm['loss']),
                                   rtol=RTOL)
        assert float(tm['acc']) == float(jm['acc'])
        _assert_params_close(state.params, tt.net)


def test_bc_step_reduces_loss_fast():
    """The port's twin of tests/test_training.py's smoke test: two BC
    steps on a toy batch strictly reduce the NLL, at the default widths
    and in bfloat16."""
    trainer = BC.BCTrainer(obs_shape=OBS, lr=1e-3, device='cpu')
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 255, (64,) + OBS, dtype=np.uint8)
    acts = rng.integers(0, 18, (64,)).astype(np.int32)
    m0 = trainer.train_step(obs, acts)
    for _ in range(8):
        m = trainer.train_step(obs, acts)
    assert float(m['loss']) < float(m0['loss'])
    assert float(m['acc']) > float(m0['acc'])


def test_bc_policy_fn_and_fit():
    jt, state, tt = _bc_pair()
    rng = np.random.default_rng(1)
    obs = _obs(rng, 8)
    logits = _np(jax.jit(jt.net.apply)(state.params, jnp.asarray(obs)))
    greedy = tt.policy_fn(greedy=True)(torch.from_numpy(obs), None)
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    gen = torch.Generator().manual_seed(0)
    draws = tt.policy_fn()(torch.from_numpy(obs), gen)
    assert draws.dtype == torch.int32 and draws.shape == (8,)
    # fit draws its permutation from numpy: 2 epochs of 2 full batches
    acts = rng.integers(0, 18, 40).astype(np.int32)
    m = tt.fit(_obs(rng, 40), acts, batch_size=16, epochs=2,
               rng=np.random.default_rng(0))
    assert tt.step == 4 and np.isfinite(float(m['loss']))


def test_gumbel_sampler_draws_the_categorical():
    """sample_actions draws softmax(logits) (Gumbel-max, as
    jax.random.categorical): 20000 draws of 4 actions, each frequency
    within 5 binomial standard deviations."""
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).repeat(20000, 1)
    a = BC.sample_actions(logits, torch.Generator().manual_seed(3))
    p = torch.softmax(logits[0], -1).numpy()
    freq = np.bincount(a.numpy(), minlength=4) / len(a)
    sd = np.sqrt(p * (1 - p) / len(a))
    assert (np.abs(freq - p) < 5 * sd).all(), (freq, p)


def test_demos_to_dataset_matches_the_reference():
    from magical_tpu_torch.data.trajectories import MAGICALTrajectory
    rng = np.random.default_rng(2)
    trajs = [MAGICALTrajectory(acts=rng.integers(0, 18, n),
                               obs=rng.integers(0, 256, (n + 1, 4, 4, 12),
                                                dtype=np.uint8),
                               rews=np.zeros(n), infos=[{}] * n)
             for n in (3, 5)]
    want, got = JBC.demos_to_dataset(trajs), BC.demos_to_dataset(trajs)
    assert got.keys() == want.keys() and got['acts'].dtype == np.int32
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got['obs'].shape == (8, 4, 4, 12)


# ---------------------------------------------------------------------------
# GAIL
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_gail_cached(kw):
    """A JAX GAIL trainer (its jitted methods compile once per test
    module) and its initial state, for trainer arguments `kw`."""
    jt = _jax_gail(**dict(kw))
    return jt, jax.jit(jt.init)(jax.random.PRNGKey(0))


def _jax_gail(**kw):
    jt = JG.GAILTrainer(None, obs_shape=OBS, **kw)
    jt.policy = JN.MagicalCNN(with_value_head=True, widths=WIDTHS,
                              dtype=jnp.float32)
    jt.disc = JN.Discriminator(widths=WIDTHS, dtype=jnp.float32)
    return jt


def _gail_pair(**kw):
    jt, state = _jax_gail_cached(tuple(sorted(kw.items())))
    tt = G.GAILTrainer(None, OBS, policy_widths=WIDTHS, disc_widths=WIDTHS,
                       dtype=torch.float32, device='cpu', **kw)
    tt.policy.load_state_dict(_port_params(state.policy_params))
    tt.disc.load_state_dict(_port_params(state.disc_params))
    return jt, state, tt


def _traj(seed=0):
    """A seeded (T, B) rollout with dones, as numpy and as torch."""
    rng = np.random.default_rng(seed)
    done = np.zeros((T, B), bool)
    done[3, 1] = done[7, :] = done[5, 2] = True
    tr = {'obs': rng.integers(0, 256, (T, B) + OBS, dtype=np.uint8),
          'act': rng.integers(0, 18, (T, B)).astype(np.int32),
          'logp': -rng.uniform(2.0, 3.5, (T, B)).astype(np.float32),
          'value': rng.normal(0, 1, (T, B)).astype(np.float32),
          'done': done,
          'reward': rng.normal(0, 1, (T, B)).astype(np.float32),
          'last_value': rng.normal(0, 1, (B,)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in tr.items()},
            {k: torch.from_numpy(v) for k, v in tr.items()})


def test_gae_matches_the_reference():
    jt, _, tt = _gail_pair()
    jtr, ttr = _traj()
    ja, jr = jax.jit(jt._gae)(jtr)
    ta, tr = tt.gae(ttr)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('minibatch', [False, True])
def test_ppo_update_matches_optax(minibatch):
    """One PPO step, on the whole rollout and on a minibatch of the same
    indices (the advantage normalised over the whole rollout, population
    std): pg, vloss, entropy and every policy parameter."""
    jt, state, tt = _gail_pair(entropy_coef=0.02)
    jtr, ttr = _traj(1)
    idx = np.random.default_rng(3).permutation(T * B)[:12] \
        if minibatch else None
    state, jm = jt._ppo_update(state, jtr,
                               None if idx is None else jnp.asarray(idx))
    tm = tt.ppo_update(ttr, None if idx is None else torch.from_numpy(idx))
    for k in ('pg', 'vloss', 'entropy'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    _assert_params_close(state.policy_params, tt.policy)


def _disc_inputs(seed=4):
    rng = np.random.default_rng(seed)
    jtr, ttr = _traj(seed)
    exp_obs, exp_act = _obs(rng, 10), rng.integers(0, 18, 10).astype(
        np.int32)
    idx_p = rng.choice(T * B, 12, replace=False)
    idx_e = rng.choice(10, 6, replace=False)
    return jtr, ttr, exp_obs, exp_act, idx_p, idx_e


def _disc_step(jt, state, tt, flat=False):
    jtr, ttr, exp_obs, exp_act, idx_p, idx_e = _disc_inputs()
    jo, ja, to, ta = jtr['obs'], jtr['act'], ttr['obs'], ttr['act']
    if flat:            # already-flat rollouts are taken as they are
        jo, ja = jo.reshape((-1,) + OBS), ja.reshape(-1)
        to, ta = to.reshape((-1,) + OBS), ta.reshape(-1)
    state, jm = jt._disc_update(state, jo, ja, jnp.asarray(idx_p),
                                jnp.asarray(exp_obs), jnp.asarray(exp_act),
                                jnp.asarray(idx_e))
    tm = tt.disc_update(to, ta, torch.from_numpy(idx_p),
                        torch.from_numpy(exp_obs), torch.from_numpy(exp_act),
                        torch.from_numpy(idx_e))
    np.testing.assert_allclose(float(tm['disc_loss']), float(jm['disc_loss']),
                               rtol=RTOL)
    assert float(tm['disc_acc']) == float(jm['disc_acc'])
    return state, tm


@pytest.mark.parametrize('flat', [False, True])
def test_disc_update_matches_optax(flat):
    jt, state, tt = _gail_pair(disc_freeze_acc=1.0)
    state, _ = _disc_step(jt, state, tt, flat)
    _assert_params_close(state.disc_params, tt.disc)
    assert tt.disc_opt.state[tt.disc.out.bias]['step'] == 1


def test_disc_freeze_skips_the_whole_step():
    """Above disc_freeze_acc neither side moves the parameters, either
    Adam moment or Adam's count: one free step, then a frozen one."""
    jt, state, tt = _gail_pair(disc_freeze_acc=1.0)
    state, _ = _disc_step(jt, state, tt)
    # any accuracy is above -1 (the JAX trainer reads it while tracing)
    jt, _ = _jax_gail_cached((('disc_freeze_acc', -1.0),))
    tt.disc_freeze_acc = -1.0
    before_j = jax.tree_util.tree_map(_np, (state.disc_params,
                                            state.disc_opt))
    before_t = {k: v.clone() for k, v in tt.disc.state_dict().items()}
    opt_t = {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in tt.disc_opt.state.items()}
    state, _ = _disc_step(jt, state, tt)
    after_j = jax.tree_util.tree_map(_np, (state.disc_params,
                                           state.disc_opt))
    jax.tree_util.tree_map(np.testing.assert_array_equal, before_j, after_j)
    for k, v in tt.disc.state_dict().items():
        assert torch.equal(v, before_t[k]), k
    for p, s in tt.disc_opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt_t[id(p)][k]), k
    _assert_params_close(state.disc_params, tt.disc)


def test_disc_obs_only_ignores_actions():
    """disc_obs_only feeds the discriminator action 0 on both sides: the
    same update as the reference, and the same whatever the actions."""
    jt, state, tt = _gail_pair(disc_obs_only=True, disc_freeze_acc=1.0)
    state, _ = _disc_step(jt, state, tt)
    _assert_params_close(state.disc_params, tt.disc)
    _, ttr, exp_obs, exp_act, idx_p, idx_e = _disc_inputs()
    obs = torch.from_numpy(exp_obs)
    a = torch.from_numpy(exp_act)
    with torch.no_grad():
        assert torch.equal(tt.disc(obs, tt._disc_act(a)),
                           tt.disc(obs, tt._disc_act((a + 5) % 18)))


def test_gail_collects_from_the_env_and_trains():
    """collect on the port's env: (T, B, ...) on the device, each step's
    logp and value the policy's own on its observation, the reward the
    discriminator's logit; then train()'s outer loop (fresh resets each
    iteration) moves both networks and keeps them finite."""
    import torch.nn.functional as F
    env = BatchedEnv('MoveToRegion-Demo-LoRes4E-v0', device='cpu')
    tt = G.GAILTrainer(env, (96, 96, 12), rollout_len=3,
                       policy_widths=WIDTHS, disc_widths=WIDTHS,
                       dtype=torch.float32, disc_freeze_acc=1.0)
    carry, obs = env.reset(0, 2)
    carry, obs, traj = tt.collect(carry, obs, torch.Generator().manual_seed(0))
    assert carry.t == 3 and traj['obs'].shape == (3, 2, 96, 96, 12)
    assert traj['act'].dtype == torch.int32 and traj['last_value'].shape == (2,)
    assert not traj['done'].any()
    with torch.no_grad():
        logits, value = tt.policy(traj['obs'][1])
        logp = F.log_softmax(logits, -1).gather(
            1, traj['act'][1].long()[:, None])[:, 0]
        d = tt.disc(traj['obs'].reshape(-1, 96, 96, 12),
                    traj['act'].reshape(-1))
    torch.testing.assert_close(traj['logp'][1], logp)
    torch.testing.assert_close(traj['value'][1], value)
    torch.testing.assert_close(traj['reward'].reshape(-1), d)
    before = [p.clone() for p in (*tt.policy.parameters(),
                                  *tt.disc.parameters())]
    rng = np.random.default_rng(5)
    out = tt.train(0, rng.integers(0, 256, (6, 96, 96, 12), dtype=np.uint8),
                   rng.integers(0, 18, 6).astype(np.int32), iterations=1,
                   batch_envs=2, disc_batch=4, ppo_epochs=1, verbose=False)
    after = [p.detach() for p in (*tt.policy.parameters(),
                                  *tt.disc.parameters())]
    n = len(list(tt.policy.parameters()))
    moved = [not torch.equal(a, b) for a, b in zip(before, after)]
    assert any(moved[:n]) and any(moved[n:])
    assert all(bool(torch.isfinite(a).all()) for a in after)
    assert np.isfinite(float(out['ppo']['pg']))


# ---------------------------------------------------------------------------
# BatchedEnv(render_enabled=False) and the benchmark CLI
# ---------------------------------------------------------------------------

def _render_launches():
    return (render_kernel.render_into_slots.launches,
            render_kernel.render_views_lo.launches,
            render_kernel.render_views_hi.launches,
            render_kernel.render_hi_into_slots.launches)


def test_render_disabled_runs_physics_only():
    """obs {} at reset and at every step, the same states as with
    rendering, no render counted; the observation space unchanged."""
    name = 'MoveToRegion-Demo-LoRes4E-v0'
    on = BatchedEnv(name, device='cpu')
    off = BatchedEnv(name, render_enabled=False, device='cpu')
    assert repr(off.observation_space) == repr(on.observation_space)
    c1, o1 = on.reset(3, 2)
    n = _render_launches()
    c2, o2 = off.reset(3, 2)
    assert o2 == {} and c2.frames == {}
    acts = torch.tensor([[4, 7], [1, 1], [0, 4]], dtype=torch.int32)
    for a in acts:
        c1, o1, r1, d1, i1 = on.step(c1, a)
        c2, o2, r2, d2, i2 = off.step(c2, a)
        assert o2 == {} and c2.frames == {} and c2.t == c1.t
        assert torch.equal(d1, d2) and torch.equal(r1, r2)
        assert torch.equal(i1['eval_score'], i2['eval_score'])
    assert _render_launches() == n
    for k, v in torch_to_numpy(c1.state).items():
        np.testing.assert_array_equal(torch_to_numpy(c2.state)[k], v, k)


def test_render_disabled_matches_the_reference_and_pickles():
    """Against magical_tpu's render_enabled=False on the raw ID (the JAX
    package's step refuses it on preprocessed IDs, ROADMAP §3): obs {}
    and the same reset state; the port's steps (whose physics
    test_torch_env.py holds against the reference's) give {} too; the
    constructor arguments survive pickling."""
    name = 'MoveToRegion-Demo-v0'
    jenv = JaxEnv(name, render_enabled=False)
    jc, jo = jenv.reset(jax.random.split(jax.random.PRNGKey(0), 2))
    env = BatchedEnv(name, render_enabled=False, device='cpu')
    c, o = env.reset(0, 2)
    assert jo == {} and o == {}
    want, got = jax_to_numpy(jc.state), torch_to_numpy(c.state)
    for k in ('pos', 'angle', 'vel', 'omega'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    c, o, *_ = env.step(c, torch.tensor([4, 7], dtype=torch.int32))
    assert o == {} and c.frames == {}
    env2 = pickle.loads(pickle.dumps(env))
    assert env2.render_enabled is False and env2.device == env.device
    assert env2.env_name == name and env2.fidelity == 'lo'
    assert env2.reset(0, 2)[1] == {}


# JSON keys of magical_tpu/tools/benchmark.py's line; the port's adds the
# device it ran on
BENCH_KEYS = {'env', 'batch', 'steps', 'fidelity', 'render', 'compile_s',
              'env_steps_per_s', 'ms_per_batched_step'}


@pytest.mark.parametrize('render', [True, False])
def test_benchmark_cli_on_the_cpu(render, capsys):
    """tools/benchmark.py --json prints the reference tool's line (plus
    the device); --no-render steps physics only (tests/test_torch_cuda.py
    runs it on the card, with --trace-dir)."""
    from magical_tpu_torch.tools import benchmark
    n = _render_launches()
    argv = ['--device', 'cpu', '--batch', '2', '--steps', '2', '--json',
            '--env', 'MoveToRegion-Demo-LoRes4E-v0']
    benchmark.main(argv + ([] if render else ['--no-render']))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert set(res) == BENCH_KEYS | {'device'} and res['device'] == 'cpu'
    assert res['render'] is render and res['batch'] == 2
    assert res['steps'] == 2 and res['fidelity'] == 'lo'
    assert res['env_steps_per_s'] > 0 and res['ms_per_batched_step'] > 0
    assert _render_launches() == n


@pytest.mark.slow
def test_gail_script_runs_with_no_updates(tmp_path):
    """tools/train_gail_mtr.py on the CPU with --ppo-epochs 0 and
    --disc-updates 0 (where scripts/train_gail_mtr.py raises NameError),
    writing its result and policy where it is told; ~2 min on the CPU."""
    from magical_tpu_torch.tools import train_gail_mtr
    out = tmp_path / 'GAIL_RESULT.json'
    res = train_gail_mtr.main(
        ['--device', 'cpu', '--iters', '1', '--envs', '2', '--eval-envs',
         '2', '--demos', '1', '--ppo-epochs', '0', '--disc-updates', '0',
         '--out', str(out)])
    assert json.loads(out.read_text())['curve'] == res['curve']
    assert res['curve'][0]['disc_acc'] is None
    assert res['curve'][0]['entropy'] is None
    assert (tmp_path / 'gail_policy.npz').is_file()
    assert set(res['final_eval']) == {
        f'{v}_{k}' for v in ('Demo', 'TestJitter')
        for k in ('random', 'greedy', 'stoch')}
