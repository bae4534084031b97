"""Resumable sweep of every registered env ID, with an on-disk ledger.

The counterpart of ``scripts/run_id_sweep.py``: the reference's CI bar is
"every registered env ID rolls complete episodes of random actions" (its
tests/test_rollout_preproc.py:17-36).  Each ID rolls one whole episode of
random actions at batch 2 and must give, as there:

- ``done`` at the last step only;
- end scores in [0, 1], and 0 before the end;
- finite positions.

Each ID that passes is appended to the ledger at once and skipped on a
restart; a failure is recorded and the sweep goes on.  ``--max-ids`` caps
the IDs this process runs (no cap by default) and ``--reverse`` walks the
list from the other end, so that two processes can share a ledger.  The
envs run on the card unless ``--device cpu`` is given.

    python -m magical_tpu_torch.tools.id_sweep [--ledger build/id_sweep.txt]
"""

import argparse
import os
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_LEDGER = os.path.join(REPO, 'build', 'id_sweep.txt')
BATCH = 2


def load_ledger(path):
    """The IDs the ledger at `path` records as green."""
    ok = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[1] == 'ok':
                    ok.add(parts[0])
    return ok


def append(path, line):
    with open(path, 'a') as f:
        f.write(line + '\n')
        f.flush()
        os.fsync(f.fileno())


def run_id(env_name, device='cuda', batch=BATCH):
    """One whole episode of random actions of `env_name` at `batch` envs,
    with the sweep's assertions; returns the number of steps."""
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.parallel.rollout import random_policy

    env = BatchedEnv(env_name, device=device)
    carry, obs = env.reset(7, batch)
    gen = torch.Generator(device=env.device).manual_seed(42)
    carry, obs, rews, dones, scores = env.rollout(
        carry, obs, random_policy(batch), gen)
    dones = dones.cpu().numpy()
    scores = scores.cpu().numpy()
    assert dones.shape[0] == env.max_episode_steps
    assert dones[-1].all() and not dones[:-1].any()
    assert ((scores[-1] >= 0.0) & (scores[-1] <= 1.0)).all()
    assert (scores[:-1] == 0.0).all()
    assert bool(torch.isfinite(carry.state.pos).all())
    return env.max_episode_steps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--ledger', default=DEFAULT_LEDGER)
    p.add_argument('--max-ids', type=int, default=None)
    p.add_argument('--reverse', action='store_true')
    p.add_argument('--ids', nargs='*', default=None,
                   help='sweep these IDs only (default: every registered ID)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from magical_tpu_torch.api import registry
    registry.register_envs()
    all_ids = list(args.ids or registry.ALL_REGISTERED_ENVS)
    if args.reverse:
        all_ids = all_ids[::-1]
    os.makedirs(os.path.dirname(os.path.abspath(args.ledger)), exist_ok=True)
    done = load_ledger(args.ledger)
    todo = [i for i in all_ids if i not in done][:args.max_ids]
    print(f'{len(done)} already green, {len(todo)} this process '
          f'of {len(all_ids)} total', flush=True)
    t0 = time.time()
    failed, steps = [], 0
    for n, env_name in enumerate(todo):
        if env_name in load_ledger(args.ledger):
            continue                  # the other process got there first
        t1 = time.time()
        try:
            steps += run_id(env_name, args.device)
        except Exception as e:  # noqa: BLE001 — record and continue
            append(args.ledger, f'{env_name} FAIL {type(e).__name__}: '
                   + str(e).replace('\n', ' ')[:200])
            print(f'[{n + 1}/{len(todo)}] {env_name} FAIL: {e}', flush=True)
            traceback.print_exc()
            failed.append(env_name)
            continue
        append(args.ledger, f'{env_name} ok')
        print(f'[{n + 1}/{len(todo)}] {env_name} ok in '
              f'{time.time() - t1:.2f}s', flush=True)
    green = len(set(all_ids) & load_ledger(args.ledger))
    wall = time.time() - t0
    print(f'sweep complete: {green}/{len(all_ids)} green, {steps} '
          f'episode steps at batch {BATCH} in {wall:.1f} s', flush=True)
    return {'green': green, 'total': len(all_ids), 'failed': failed,
            'steps': steps, 'seconds': wall}


if __name__ == '__main__':
    out = main()
    raise SystemExit(1 if out['failed'] else 0)
