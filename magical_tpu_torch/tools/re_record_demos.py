"""Replay stored demo action sequences through a live env to regenerate
their observations.

The counterpart of ``magical_tpu/tools/re_record_demos.py`` (the
reference's misc/re_record_demos.py): each demo's actions are replayed in
a (deterministic, Demo-variant) target env through the port's Gym-style
adapter, padded with no-ops if they end before the episode does, and a new
demo is written in the reference format with this engine's observations.
It relies on the Demo variants' deterministic resets as the reference
does.  The env runs on the card unless ``--device cpu`` is given.

    python -m magical_tpu_torch.tools.re_record_demos \\
        MoveToCorner-Demo-v0 demo1.pkl.gz --out-dir demos-rerecorded/
"""

import argparse
import os

import numpy as np

from magical_tpu_torch.api.gym_env import MagicalGymEnv
from magical_tpu_torch.data.trajectories import (MAGICALTrajectory,
                                                 load_demos, save_demo)


def re_record(target_env_name, demo_paths, out_dir, fidelity='hi',
              verbose=True, device='cuda'):
    """Re-record every demo of `demo_paths` in `target_env_name` into
    `out_dir`; returns the new demos' paths."""
    os.makedirs(out_dir, exist_ok=True)
    env = MagicalGymEnv(target_env_name, fidelity=fidelity, device=device)
    out_paths = []
    for old_path, demo in zip(demo_paths, load_demos(demo_paths)):
        if verbose:
            print(f"Working on demo at '{old_path}'")
        actions = np.asarray(demo['trajectory'].acts)
        observations = [env.reset()]
        rews, infos = [], []
        done = False
        for act_num, act in enumerate(actions, 1):
            obs, rew, done, info = env.step(int(act))
            observations.append(obs)
            rews.append(rew)
            infos.append(info)
            if done:
                if act_num != len(actions) and verbose:
                    print(f"Got 'done' at action {act_num}/{len(actions)}")
                break
        # pad with no-ops if the stored actions run out before the time
        # limit (re_record_demos.py:48-58)
        n_pad = 0
        while not done:
            obs, rew, done, info = env.step(0)
            observations.append(obs)
            rews.append(rew)
            infos.append(info)
            n_pad += 1
        if n_pad and verbose:
            print(f"Padded with {n_pad} noops")
        score = info.get('eval_score')
        traj = MAGICALTrajectory(acts=actions, obs=observations,
                                 rews=rews, infos=infos)
        old_bn = os.path.basename(old_path)
        new_bn = old_bn.replace(demo['env_name'], target_env_name)
        new_bn = new_bn.replace(' ', '0')
        new_path = os.path.join(out_dir, new_bn)
        if verbose:
            print(f"score {score}; saving to '{new_path}'")
        save_demo(new_path, target_env_name, traj, score)
        out_paths.append(new_path)
    return out_paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('target_env_name')
    ap.add_argument('demo_paths', nargs='+')
    ap.add_argument('--out-dir', default='demos-rerecorded')
    ap.add_argument('--fidelity', default='hi', choices=('hi', 'lo'))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    return re_record(args.target_env_name, args.demo_paths, args.out_dir,
                     args.fidelity, device=args.device)


if __name__ == '__main__':
    main()
