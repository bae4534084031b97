"""Performance benchmark CLI.

The counterpart of ``magical_tpu/tools/benchmark.py``: batched
env-steps/s (step and render) or physics-only throughput (``--no-render``)
of one env ID, optionally with a ``torch.profiler`` trace.  It runs on the
card unless ``--device cpu`` is given.  ``compile_s`` is the first reset
and step, the kernels' build included; the steps after it are timed on
the host's clock around the loop, with the card synchronised before and
after.  With ``--trace-dir`` the trace also holds one reset, made before
the timed loop, and the port's spans (``magical_tpu_torch/trace.py``).

    python -m magical_tpu_torch.tools.benchmark --env MoveToCorner-Demo-LoRes4E-v0 \\
        --batch 4096 --steps 30 --json
"""

import argparse
import contextlib
import json
import os
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--env', default='MoveToCorner-Demo-LoRes4E-v0')
    p.add_argument('--batch', type=int, default=4096)
    p.add_argument('--steps', type=int, default=30)
    p.add_argument('--fidelity', default='lo', choices=['lo', 'hi'])
    p.add_argument('--no-render', action='store_true')
    p.add_argument('--trace-dir', default=None,
                   help='write a torch.profiler (Chrome) trace here')
    p.add_argument('--json', action='store_true')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from magical_tpu_torch.api.batched_env import BatchedEnv
    env = BatchedEnv(args.env, fidelity=args.fidelity,
                     render_enabled=not args.no_render, device=args.device)
    cuda = env.device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    carry, obs = env.reset(0, args.batch)
    acts = torch.zeros((args.batch,), dtype=torch.int32, device=env.device)
    carry, obs, *_ = env.step(carry, acts)
    sync()
    compile_s = time.perf_counter() - t0

    tracer = contextlib.nullcontext()
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile
        tracer = profile(activities=[ProfilerActivity.CPU]
                         + ([ProfilerActivity.CUDA] if cuda else []))
    with tracer:
        if args.trace_dir:
            env.reset(1, args.batch)         # its spans, outside the timing
            sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            carry, obs, *_ = env.step(carry, acts)
        sync()
        dt = time.perf_counter() - t0
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        tracer.export_chrome_trace(os.path.join(args.trace_dir, 'trace.json'))

    sps = args.batch * args.steps / dt
    result = dict(env=args.env, batch=args.batch, steps=args.steps,
                  fidelity=args.fidelity, render=not args.no_render,
                  compile_s=round(compile_s, 2),
                  env_steps_per_s=round(sps, 1),
                  ms_per_batched_step=round(1e3 * dt / args.steps, 3),
                  device=(torch.cuda.get_device_name(env.device) if cuda
                          else 'cpu'))
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f'{k:20s} {v}')
    return result


if __name__ == '__main__':
    main()
