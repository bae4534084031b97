"""Run one cell of BENCHMARK.json once, on this machine's CUDA card.

    python3 portbench/run.py --workload mtc-demo-lo --seed 7 --seconds 30 \
        --trace 0

From the root of a checkout.  Prints, as the last line of its standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), `device` (with ``--trace 1`` also `busy_s` and `window_s`,
and a `breakdown`), and last `checks`, each number the check compared
beside its limit, which also end its standard error.  Exits non-zero, and
prints no result, without a card, or where JAX or the JAX package was
loaded.
"""

import time

START = time.time()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.harness import bench, check, spec
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print('portbench: no CUDA card; the benchmark runs only on one',
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f'portbench: {args.workload} takes {cell.chips} cards, this '
              f'machine has {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    print(f'portbench: {bench.device_line()}', file=sys.stderr)
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            start=START)
    found = bench.forbidden_modules()
    if found:
        print(f'portbench: loaded, and must not be: {found}',
              file=sys.stderr)
        return 3
    checks = result['checks']
    values = {k: v['value'] for k, v in checks.items()}
    limits = {k: v['limit'] for k, v in checks.items()}
    print(bench.dumps(result))
    sys.stdout.flush()
    for line in check.lines(values, limits, list(checks)):
        print(line, file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
