"""The readings that a cell's limits are set from, over many seeds in one
process: for each seed, a run of the cell with a window of `--seconds`,
with the check's numbers for the program and for the control (the
reference in bfloat16 in the program's place, at the same states).

    python3 portbench/calibrate.py --workload cc-testall-lo \
        --seeds 11,12,13 --seconds 10

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.  The benchmark's own runs do not
run the control.
"""

import argparse
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    args = p.parse_args(argv)
    import torch
    from portbench.harness import bench, check, spec
    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    worst = {k: 0.0 for k in check.NUMBERS}
    least = {k: math.inf for k in check.NUMBERS}
    for seed in (int(s) for s in args.seeds.split(',')):
        r = bench.run_cell(cell, seed, args.seconds, False, control=True)
        got = {k: v['value'] for k, v in r['checks'].items()}
        for k in check.NUMBERS:
            worst[k] = max(worst[k], got[k])
            least[k] = min(least[k], r['control'][k])
        print(bench.dumps({'seed': seed, 'program': got,
                           'control': r['control'], 'window': r['window'],
                           'metrics': r['metrics']}), flush=True)
    print(bench.dumps({'workload': args.workload, 'program_largest': worst,
                       'control_smallest': least}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
