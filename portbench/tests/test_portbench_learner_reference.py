"""The learner's reference against the port on the CPU, in float32 at a
small size, on the benchmark's seeded random weights: the rollout's
log-probs, values and rewards, GAE, one PPO step and one discriminator
step, to float32 rounding.  (The MoveToRegion reference is held bit for
bit in ``test_portbench_reference.py``.)

Tolerances: both sides compute in float32 with the same equations, and
differ only in the order of a convolution's or a sum's additions; on
the card the float32 program's rollout outputs read within 1e-6 of the
reference and its first gradient within 3e-6 (the cell's check, float32
witness), so 1e-4 (of the quantity's own scale where stated) leaves room
and still fails a wrong equation by orders of magnitude."""

import numpy as np
import pytest
import torch

from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.train.gail import GAILTrainer
from portbench.harness import learner, spec
from portbench.reference import learner as L

CELL = 'gail-mtr'
TOL = 1e-4


def close(got, want, scale=1.0, tol=TOL):
    return float((got - want).abs().max()) <= tol * max(scale, 1e-30)


@pytest.fixture(scope='module')
def rollout():
    """A float32 trainer on the benchmark's weights and a 4-step rollout
    of 2 envs, its ends set by hand in one env."""
    cfg = spec.cell(CELL).config
    hp = cfg['learner']
    env = BatchedEnv('MoveToRegion-Demo-LoRes4E-v0', device='cpu')
    carry, obs = env.reset(torch.Generator().manual_seed(5), 2)
    tr = GAILTrainer(env, obs_shape=tuple(obs.shape[1:]),
                     policy_lr=hp['policy_lr'], disc_lr=hp['disc_lr'],
                     entropy_coef=hp['entropy_coef'], rollout_len=4,
                     policy_widths=cfg['policy']['widths'],
                     disc_widths=cfg['discriminator']['widths'],
                     disc_obs_only=True, dtype=torch.float32, device='cpu')
    w_pol, w_disc = learner.make_weights(cfg, obs.shape[-1], 77, 'cpu')
    tr.policy.load_state_dict(w_pol)
    tr.disc.load_state_dict(w_disc)
    _, last, traj = tr.collect(carry, obs, torch.Generator().manual_seed(3))
    traj['done'][1, 0] = True
    return tr, traj, last, w_pol, w_disc, hp


def test_collect_gives_the_reference_log_probs_values_and_rewards(rollout):
    tr, traj, last, w_pol, w_disc, _ = rollout
    obs = traj['obs'].reshape((-1,) + tuple(traj['obs'].shape[2:]))
    act = traj['act'].reshape(-1)
    logits, value = L.policy(w_pol, obs)
    logp = torch.log_softmax(logits, -1).gather(1, act.long()[:, None])[:, 0]
    assert close(traj['logp'].reshape(-1), logp)
    assert close(traj['value'].reshape(-1), value)
    assert close(traj['last_value'], L.policy(w_pol, last)[1])
    reward = L.discriminator(w_disc, obs, torch.zeros_like(act), 18)
    assert close(traj['reward'].reshape(-1), reward)


def test_gae_is_the_reference_and_is_cut_at_ends(rollout):
    tr, traj, *_, hp = rollout
    adv, ret = tr.gae(traj)
    want_adv, want_ret = L.gae(traj['reward'], traj['value'], traj['done'],
                               traj['last_value'], hp['gamma'], hp['lam'])
    assert close(adv, want_adv) and close(ret, want_ret)
    uncut = L.gae(traj['reward'], traj['value'],
                  torch.zeros_like(traj['done']), traj['last_value'],
                  hp['gamma'], hp['lam'])[0]
    assert not close(adv, uncut)


def test_one_ppo_step_is_the_reference(rollout):
    tr, traj, _, _, _, hp = rollout
    start = {k: q.detach().clone() for k, q in tr.policy.named_parameters()}
    idx = np.array([6, 1, 3, 4])
    parts = tr.ppo_update(traj, idx)
    adv, ret = L.gae(traj['reward'], traj['value'], traj['done'],
                     traj['last_value'], hp['gamma'], hp['lam'])
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
    i = torch.as_tensor(idx)
    p = L.leaves(start)
    loss, want = L.ppo_loss(p, flat(traj['obs'])[i], flat(traj['act'])[i],
                            flat(traj['logp'])[i],
                            flat(L.normalise(adv))[i], flat(ret)[i], hp)
    for name in ('pg', 'vloss', 'entropy'):
        w = want[name].detach()
        assert close(parts[name], w, abs(float(w))), name
    g = L.grads(loss, p)
    for k, param in tr.policy.named_parameters():
        moment = tr.policy_opt.state[param]['exp_avg'] / 0.1
        assert close(moment, g[k], float(g[k].abs().max())), k


def test_one_discriminator_step_is_the_reference(rollout):
    tr, traj, _, _, w_disc, _ = rollout
    obs = traj['obs'].reshape((-1,) + tuple(traj['obs'].shape[2:]))
    act = traj['act'].reshape(-1)
    ip, ie = np.array([0, 2, 5, 7]), np.array([1, 3, 4])
    out = tr.disc_update(traj['obs'], traj['act'], ip, obs, act, ie)
    p = L.leaves(w_disc)
    zp = torch.zeros(4, dtype=torch.long)
    ze = torch.zeros(3, dtype=torch.long)
    exp, pol, acc = L.disc_loss(p, obs[ip], zp, obs[ie], ze, 18)
    loss = (exp + pol).detach()
    assert close(out['disc_loss'], loss, float(loss))
    assert float(out['disc_acc']) == float(acc)
    # the expert's and the policy's terms nearly cancel (both see nearly
    # the same images), so each leaf is held to their scale; GroupNorm
    # over such images magnifies the order of the first layers' float32
    # additions to 1.6e-4 of it (measured), hence 1e-3 here
    g_e, g_p = L.grads(exp, p), L.grads(pol, p)
    for k, param in tr.disc.named_parameters():
        moment = tr.disc_opt.state[param]['exp_avg'] / 0.1
        assert close(moment, g_e[k] + g_p[k],
                     float(g_e[k].abs().max() + g_p[k].abs().max()),
                     tol=1e-3), k


def test_the_reference_adam_goes_on_from_a_given_state():
    # two steps at once, and the second again from the first's moments:
    # the same parameters, as the check follows a trained iteration
    gen = torch.Generator().manual_seed(9)
    p = {'w': torch.randn(5, 3, generator=gen)}
    g1, g2 = ({'w': torch.randn(5, 3, generator=gen)} for _ in range(2))
    whole = L.Adam(3e-4)
    want = whole.step(whole.step(L.leaves(p), g1), g2)
    first = L.Adam(3e-4)
    mid = first.step(L.leaves(p), g1)
    got = L.Adam(3e-4, m=first.m, v=first.v, t=first.t).step(mid, g2)
    assert torch.equal(got['w'], want['w'])


def test_the_control_rounds_its_backward_through_float8():
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(64, 32, generator=gen).requires_grad_(True)
    w = (0.2 * torch.randn(16, 32, generator=gen)).requires_grad_(True)
    up = torch.randn(64, 16, generator=gen)

    def grad():
        return torch.autograd.grad((L.dense(x, w, torch.zeros(16)) * up)
                                   .sum(), w)[0]
    plain = grad()
    with L.lowered():
        low = grad()
    # one scale for the tensor, then e5m2's two mantissa bits: the
    # rounded gradient holds at most 4 values an octave
    s = torch.finfo(torch.float8_e5m2).max / float(low.abs().max())
    assert torch.equal((low * s).to(torch.float8_e5m2).float(), low * s)
    assert not torch.equal(low, plain)
    assert close(low, plain, float(plain.abs().max()), tol=0.3)
