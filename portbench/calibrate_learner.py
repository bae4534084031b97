"""The readings that a learner cell's limits are set from, over many
seeds in one process: for each seed, a run of the cell (set-up and its
iteration 0, then `--iterations` window iterations; the check reads
iteration 0 and the last) with the check's numbers for the program, or
the float32 witness (``--witness``, the trainer computing in float32), or
the program with a fault planted (``--fault``, one of
``learner_faults.FAULTS`` by its index in sorted order), and with
``--control`` the control's readings too (the reference in the program's
place, every layer's input and weight rounded through float8 e4m3 and the
gradients its backward hands them through float8 e5m2).

    python3 portbench/calibrate_learner.py --workload gail-mtr \
        --seeds 11,12,13 --control

Prints one JSON line a seed, then the largest reading and the smallest
control reading of each number.  The benchmark's own runs do not run the
control.
"""

import argparse
import contextlib
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--iterations', type=int, default=1)
    p.add_argument('--control', action='store_true')
    p.add_argument('--witness', action='store_true')
    p.add_argument('--fault', type=int, default=None)
    args = p.parse_args(argv)
    import torch
    from portbench import learner_faults
    from portbench.harness import bench, learner, spec
    if not torch.cuda.is_available():
        print('calibrate_learner: no CUDA card', file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    fault = None if args.fault is None else sorted(
        learner_faults.FAULTS)[args.fault]
    dtype = torch.float32 if args.witness else torch.bfloat16
    worst = {k: 0.0 for k in learner.NUMBERS}
    least = {k: math.inf for k in learner.NUMBERS}
    for seed in (int(s) for s in args.seeds.split(',')):
        with (learner_faults.planted(fault) if fault
              else contextlib.nullcontext()):
            r = learner.run_cell(cell, seed, math.inf, False,
                                 control=args.control,
                                 episodes=args.iterations, dtype=dtype,
                                 detail=True)
        got = {k: v['value'] for k, v in r['checks'].items()}
        for k in learner.NUMBERS:
            worst[k] = max(worst[k], got[k])
            if args.control:
                least[k] = min(least[k], r['control'][k])
        print(bench.dumps({'seed': seed, 'fault': fault,
                           'witness': args.witness, 'program': got,
                           'correct': r['correct'],
                           'control': r.get('control'),
                           'detail': r['detail'],
                           'window': r['window'],
                           'memory_peak_bytes':
                               r['device']['memory_peak_bytes']}),
              flush=True)
    print(bench.dumps({'workload': args.workload, 'fault': fault,
                       'witness': args.witness, 'largest': worst,
                       'control_smallest': least}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
