"""K1 (the control-step kernel) over whole episodes of the benchmark's
three traffics, to hold two trees' K1 bit for bit on the same card.

Each run takes the magical_tpu_torch it imports (set PYTHONPATH to the
tree's root): for MoveToCorner-Demo, ClusterColour-TestAll and
ClusterColour-Demo at `--batch` envs (no render), one reset from `--seed`
and a whole episode of the benchmark's held random actions
(portbench/harness/traffic.py), with a digest of every K1 field after
every step (the fields' bits, weighted by position, summed in int64) and
the end state, into `--out`; it prints the steps' time a step (CUDA
events; the step is K1 and the score) and K1's alone on the state after
TIME_AT steps (K1_LAUNCHES launches from one state, CUDA events).
`--compare` then holds two such files equal, digest by digest and bit for
bit at the end.

Run on a CUDA machine (no JAX), each tree in its own process:

    PYTHONPATH=<tree a> python3 tests/_torch_k1_ab.py --out a.npz
    PYTHONPATH=<tree b> python3 tests/_torch_k1_ab.py --out b.npz
    python3 tests/_torch_k1_ab.py --compare a.npz b.npz
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IDS = ('MoveToCorner-Demo-LoRes4E-v0', 'ClusterColour-TestAll-LoRes4E-v0',
       'ClusterColour-Demo-LoRes4E-v0')
TIME_AT = 25
K1_LAUNCHES = 20


def digest(state, fields):
    """(len(fields),) int64 on the card: each field's bits times their
    position plus one, summed (wrapping)."""
    import torch
    out = []
    for name in fields:
        x = getattr(state, name).reshape(-1)
        bits = (x.view(torch.int32) if x.dtype == torch.float32
                else x.to(torch.int32)).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device)
        out.append((bits * w).sum())
    return torch.stack(out)


def k1_alone_ms(state, action):
    """K1's milliseconds a launch on `state` (cloned), after a warm-up."""
    import torch

    from magical_tpu_torch.core import physics_kernel
    st = state.clone()
    physics_kernel.control_step(st, action)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
    start.record()
    for _ in range(K1_LAUNCHES):
        physics_kernel.control_step(st, action)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / K1_LAUNCHES


def record(seed, batch, out):
    import torch

    import magical_tpu_torch
    from magical_tpu_torch.api.batched_env import BatchedEnv
    from magical_tpu_torch.core import physics_kernel
    sys.path.insert(0, REPO)
    from portbench.harness import traffic
    saved = {'package': np.array(os.path.dirname(magical_tpu_torch.__file__)),
             'device': np.array(torch.cuda.get_device_name(0))}
    for env_id in IDS:
        t0 = time.perf_counter()
        env = BatchedEnv(env_id, device='cuda', render_enabled=False)
        fields = [f for f, _, _ in physics_kernel._fields(env.task.max_blocks)]
        carry, _ = env.reset(seed, batch)
        acts = traffic.held_actions(seed, env.max_episode_steps, batch,
                                    'cuda')
        digests = []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
        start.record()
        for t, a in enumerate(acts):
            if t == TIME_AT:
                kept = carry.state.clone(), a
            carry, *_ = env.step(carry, a)
            digests.append(digest(carry.state, fields))
        end.record()
        torch.cuda.synchronize()
        k1_ms = k1_alone_ms(*kept)
        saved[f'{env_id}/digests'] = torch.stack(digests).cpu().numpy()
        for f in fields:
            saved[f'{env_id}/{f}'] = getattr(carry.state, f).cpu().numpy()
        print(f'{env_id}: {len(acts)} steps at {batch} envs, '
              f'{start.elapsed_time(end) / len(acts):.3f} ms a step with its '
              f'digest, K1 alone {k1_ms:.4f} ms after {TIME_AT} steps, '
              f'{time.perf_counter() - t0:.1f} s in all', flush=True)
    np.savez(out, **saved)


def compare(a, b):
    a, b = np.load(a), np.load(b)
    print(f'{a["package"]} against {b["package"]} on {a["device"]}')
    same = True
    for env_id in IDS:
        da, db = a[f'{env_id}/digests'], b[f'{env_id}/digests']
        steps = np.flatnonzero((da != db).any(1))
        ends = [k.split('/', 1)[1] for k in a.files
                if k.startswith(env_id + '/') and not k.endswith('digests')
                and not np.array_equal(a[k], b[k])]
        ok = steps.size == 0 and not ends
        same &= ok
        print(f'{env_id}: {len(da)} steps, '
              + ('the same bits at every step and at the end' if ok else
                 f'first step that differs {steps[:1] + 1}, end fields '
                 f'that differ {ends}'))
    return same


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out')
    ap.add_argument('--seed', type=int, default=2 ** 31 + 1601)
    ap.add_argument('--batch', type=int, default=4096)
    ap.add_argument('--compare', nargs=2)
    args = ap.parse_args()
    if args.compare:
        sys.exit(0 if compare(*args.compare) else 1)
    record(args.seed, args.batch, args.out)


if __name__ == '__main__':
    main()
