"""GAIL training run on MoveToRegion: beat the random policy.

The counterpart of ``scripts/train_gail_mtr.py``, with its flags and
defaults: scripted-expert demos -> (optional BC warm start) -> GAIL
(minibatched PPO and the discriminator, on the card) -> evaluation with
95% t-CIs (``eval/protocol.tconfint_mean``).  Unlike that script it
evaluates the greedy and the stochastic policy apart and judges success on
the greedy one alone (the script took the better of the two before its CI
test), and it runs with ``--disc-updates 0`` or ``--ppo-epochs 0``.

Success: the final greedy policy's 95% CI lower bound is above the random
policy's upper bound on MoveToRegion-Demo-LoRes4E-v0 and on
-TestJitter-LoRes4E-v0.  It writes the result (config, random baseline,
curve, final evaluation, wall time and the card) and the policy (a
``data/checkpoint.save_pytree`` npz of its state_dict) under
``build/gail_torch/`` by default:

    python -m magical_tpu_torch.tools.train_gail_mtr --iters 600 --envs 256 \\
        --entropy 0.02 --disc-lr 5e-5 --disc-updates 1 --disc-batch 2048 \\
        --disc-freeze-acc 0.98 --disc-obs-only --eval-every 30
"""

import argparse
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.data.checkpoint import save_pytree
from magical_tpu_torch.eval.protocol import tconfint_mean
from magical_tpu_torch.train.bc import policy_of
from magical_tpu_torch.train.gail import GAILTrainer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = 'MoveToRegion-Demo-LoRes4E-v0'
DEFAULT_OUT = os.path.join(REPO, 'build', 'gail_torch', 'GAIL_RESULT.json')


def scripted_expert(state) -> torch.Tensor:
    """Turn toward the goal, drive, park inside (tests/test_training.py's
    expert): int32 actions (B,)."""
    pos = state.pos[:, 0]
    ang = state.angle[:, 0]
    xyhw = state.goal_xyhw[:, 0]
    d = xyhw[:, :2] - pos
    target_ang = torch.atan2(-d[:, 0], d[:, 1])
    err = torch.remainder(target_ang - ang + math.pi, 2 * math.pi) - math.pi
    act = torch.where(err > 0.15, 4, torch.where(err < -0.15, 7, 1))
    inside = ((d[:, 0].abs() < 0.5 * xyhw[:, 3] - 0.1)
              & (d[:, 1].abs() < 0.5 * xyhw[:, 2] - 0.1))
    return torch.where(inside, 0, act).to(torch.int32)


def collect_expert(env, n, seed=0):
    """`n` scripted-expert episodes: (obs (n·T, ...) uint8 and acts (n·T,)
    int32, both on the env's device, and the end scores as numpy)."""
    carry, obs = env.reset(seed, n)
    all_obs, all_act = [], []
    for _ in range(env.max_episode_steps):
        act = scripted_expert(carry.state)
        all_obs.append(obs)
        all_act.append(act)
        carry, obs, rew, done, info = env.step(carry, act)
    return (torch.cat(all_obs), torch.cat(all_act),
            info['eval_score'].cpu().numpy())


def eval_policy(env, net, n, seed, greedy=True):
    """`n` rollouts of `net` -> (per-env end scores, mean final distance
    of the robot to the goal)."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    carry, obs = env.reset(seed, n)
    carry, obs, rews, dones, scores = env.rollout(
        carry, obs, policy_of(net, greedy), gen)
    st = carry.state
    d = torch.linalg.norm(st.pos[:, 0] - st.goal_xyhw[:, 0, :2], dim=-1)
    return scores[-1].cpu().numpy(), float(d.mean())


def eval_random(env, n, seed):
    gen = torch.Generator(device=env.device).manual_seed(seed)
    carry, obs = env.reset(seed, n)

    def policy(obs, g):
        return torch.randint(0, 18, (obs.shape[0],), generator=g,
                             device=env.device, dtype=torch.int32)

    *_, scores = env.rollout(carry, obs, policy, gen)
    return scores[-1].cpu().numpy()


def _fmt(x):
    return 'n/a' if x is None else f'{x:.3f}'


def _ci(scores):
    lo, hi = tconfint_mean(scores)
    return float(scores.mean()), [float(lo), float(hi)]


def card(device):
    """The card's name and power limit as nvidia-smi gives them ('cpu' on
    the CPU)."""
    if device.type != 'cuda':
        return 'cpu'
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bc_warm_start(trainer, de_obs, de_act, steps, rng):
    """`steps` Adam(1e-3) steps of the policy on expert batches of 256
    (cross-entropy); returns the last loss."""
    import torch.nn.functional as F
    opt = torch.optim.Adam(trainer.policy.parameters(), lr=1e-3)
    loss = None
    for _ in range(steps):
        idx = torch.as_tensor(rng.choice(len(de_act),
                                         size=min(256, len(de_act)),
                                         replace=False), device=de_obs.device)
        logits, _ = trainer.policy(de_obs[idx])
        loss = F.cross_entropy(logits, de_act[idx].long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--iters', type=int, default=200)
    ap.add_argument('--envs', type=int, default=256)
    ap.add_argument('--eval-every', type=int, default=20)
    ap.add_argument('--eval-envs', type=int, default=128)
    ap.add_argument('--demos', type=int, default=32)
    ap.add_argument('--entropy', type=float, default=0.01)
    ap.add_argument('--disc-lr', type=float, default=1e-4)
    ap.add_argument('--policy-lr', type=float, default=3e-4)
    ap.add_argument('--disc-updates', type=int, default=2)
    ap.add_argument('--disc-batch', type=int, default=512)
    ap.add_argument('--ppo-epochs', type=int, default=4)
    ap.add_argument('--ppo-minibatches', type=int, default=4)
    ap.add_argument('--disc-freeze-acc', type=float, default=0.9)
    ap.add_argument('--disc-obs-only', action='store_true',
                    help='GAIfO-style obs-only discriminator')
    ap.add_argument('--bc-init-steps', type=int, default=0,
                    help='optional BC warm-start steps on the demos')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    if out == os.path.join(REPO, 'GAIL_RESULT.json'):
        raise SystemExit(f'{out} is the JAX package\'s result; write '
                         f'elsewhere')

    env = BatchedEnv(ENV, device=args.device)
    smi = card(env.device)
    t0 = time.time()
    print(f'collecting {args.demos} expert demos on {smi}...', flush=True)
    de_obs, de_act, exp_scores = collect_expert(env, args.demos)
    print(f'expert score {exp_scores.mean():.3f} '
          f'({time.time() - t0:.0f}s)', flush=True)
    if exp_scores.mean() < 0.9:
        raise SystemExit('the scripted expert scores under 0.9')

    rand_scores = eval_random(env, args.eval_envs, args.seed + 999)
    r_mean, (r_lo, r_hi) = _ci(rand_scores)
    print(f'random baseline: {r_mean:.3f} CI [{r_lo:.3f},{r_hi:.3f}]',
          flush=True)

    trainer = GAILTrainer(env, obs_shape=tuple(de_obs.shape[1:]),
                          policy_lr=args.policy_lr, disc_lr=args.disc_lr,
                          entropy_coef=args.entropy,
                          disc_freeze_acc=args.disc_freeze_acc,
                          disc_obs_only=args.disc_obs_only,
                          rollout_len=env.max_episode_steps, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reset_gen = torch.Generator().manual_seed(args.seed)
    act_gen = torch.Generator(device=env.device).manual_seed(args.seed)
    if args.bc_init_steps:
        loss = bc_warm_start(trainer, de_obs, de_act, args.bc_init_steps,
                             rng)
        print(f'bc init: final loss {loss:.3f}', flush=True)

    curve = []
    best = {'iter': -1, 'mean': -1.0, 'lo': -1.0, 'hi': -1.0}
    n_pol = trainer.rollout_len * args.envs
    pm = dm = None
    for it in range(args.iters):
        # fresh episodes every iteration (no auto-reset)
        carry, obs = env.reset(reset_gen, args.envs)
        carry, obs, traj = trainer.collect(carry, obs, act_gen)
        mb = max(1, n_pol // args.ppo_minibatches)
        for _ in range(args.ppo_epochs):
            perm = rng.permutation(n_pol)
            for m in range(args.ppo_minibatches):
                pm = trainer.ppo_update(traj, perm[m * mb:(m + 1) * mb])
        for _ in range(args.disc_updates):
            ip = rng.choice(n_pol, size=args.disc_batch, replace=False)
            ie = rng.choice(len(de_act), size=min(args.disc_batch,
                                                  len(de_act)),
                            replace=False)
            dm = trainer.disc_update(traj['obs'], traj['act'], ip, de_obs,
                                     de_act, ie)
        if (it + 1) % args.eval_every == 0 or it == args.iters - 1:
            sc, dist = eval_policy(env, trainer.policy, args.eval_envs,
                                   args.seed + 10_000 + it)
            sc_s, dist_s = eval_policy(env, trainer.policy, args.eval_envs,
                                       args.seed + 20_000 + it, greedy=False)
            mean, (lo, hi) = _ci(sc)
            stoch, stoch_ci = _ci(sc_s)
            rew = float(traj['reward'].mean())
            row = {'iter': it + 1, 'eval_mean': mean, 'ci': [lo, hi],
                   'eval_stoch': stoch, 'ci_stoch': stoch_ci,
                   'final_dist_greedy': dist, 'final_dist_stoch': dist_s,
                   'disc_acc': None if dm is None else float(dm['disc_acc']),
                   'gail_reward': rew,
                   'entropy': None if pm is None else float(pm['entropy']),
                   'wall_s': round(time.time() - t0, 1)}
            curve.append(row)
            print(f'it {it + 1}: greedy {mean:.3f} CI [{lo:.3f},{hi:.3f}] '
                  f'stoch {stoch:.3f} dist {dist:.2f}/{dist_s:.2f} '
                  f'disc_acc {_fmt(row["disc_acc"])} gail_rew {rew:+.2f} '
                  f'ent {_fmt(row["entropy"])} ({row["wall_s"]}s)',
                  flush=True)
            if mean > best['mean']:
                best = {'iter': it + 1, 'mean': mean, 'lo': lo, 'hi': hi}
            if lo > r_hi and mean > 0.5:
                print('success criterion reached; stopping early',
                      flush=True)
                break

    # the final block: greedy and stochastic apart, each env with its own
    # random baseline; success on greedy alone
    os.makedirs(os.path.dirname(out), exist_ok=True)
    policy_path = save_pytree(os.path.join(os.path.dirname(out),
                                           'gail_policy'),
                              trainer.policy.state_dict())
    final = {}
    for variant in ('Demo', 'TestJitter'):
        e = env if variant == 'Demo' else BatchedEnv(
            ENV.replace('-Demo-', f'-{variant}-'), device=args.device)
        rs = eval_random(e, args.eval_envs, args.seed + 777)
        rmean, rci = _ci(rs)
        final[f'{variant}_random'] = {'mean': rmean, 'ci': rci}
        for greedy in (True, False):
            sc, dist = eval_policy(e, trainer.policy, args.eval_envs,
                                   args.seed + 30_000, greedy=greedy)
            m, ci = _ci(sc)
            tag = f'{variant}_{"greedy" if greedy else "stoch"}'
            final[tag] = {'mean': m, 'ci': ci, 'final_dist': dist,
                          'beats_random_95ci': bool(ci[0] > rci[1])}
            print(f'final {tag}: {m:.3f} CI [{ci[0]:.3f},{ci[1]:.3f}] vs '
                  f'random hi {rci[1]:.3f}', flush=True)

    success = all(final[f'{v}_greedy']['beats_random_95ci']
                  for v in ('Demo', 'TestJitter'))
    result = {
        'env': ENV,
        'final_eval': final,
        'config': vars(args) | {'out': os.path.relpath(out, REPO)},
        'expert_score_mean': float(exp_scores.mean()),
        'random_baseline': {'mean': r_mean, 'ci': [r_lo, r_hi],
                            'n': int(args.eval_envs)},
        'gail_best': best,
        'beats_random_95ci': success,
        'curve': curve,
        'wall_s': round(time.time() - t0, 1),
        'device': smi,
        'policy': os.path.relpath(policy_path, REPO),
    }
    with open(out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps({'beats_random_95ci': success, 'gail_best': best,
                      'random': result['random_baseline'],
                      'wall_s': result['wall_s'], 'device': smi}),
          flush=True)
    return result


if __name__ == '__main__':
    main()
