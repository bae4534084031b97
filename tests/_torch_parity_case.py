"""Re-run on the card the case of chip_smoke.py's `[parity]` phase at 64
envs (chip_smoke.parity_case): MoveToCorner-Demo's parity scenes of seeds
0-63 built by `state_from_spec`, PARITY_STEPS - 1 control-kernel (K1)
steps under the actions a 64-env batch draws from the phase's generator
(seed SEED + 7), then the last step three ways: K1 twice, and the plain
version REPEATS times in `phys_compare`'s batch of 128 envs (the scenes,
then the scenes with every position 1 ulp up).  It prints K1's largest
error against each plain run, the plain version's own run-to-run spread,
and, for the env where K1 is furthest from the plain version, 64 distinct
1-ulp nudges of that env (chip_smoke.nudge_spread).

Run on a CUDA machine from the root of the repository (no JAX):

    python3 tests/_torch_parity_case.py
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPEATS = 8


def main():
    import torch

    import chip_smoke as cs
    from magical_tpu_torch.core import physics, physics_kernel

    st, a = cs.parity_case()
    B = st.batch
    k = [physics_kernel.control_step(st.clone(), a).pos for _ in range(2)]
    if not torch.equal(k[0], k[1]):
        raise AssertionError('K1: two runs on the same inputs differ')
    nudged = st.clone()
    nudged.pos = torch.nextafter(nudged.pos,
                                 torch.full_like(nudged.pos, float('inf')))
    both = cs.cat_states(st.clone(), nudged)
    plain = [physics.control_step(both.clone(), torch.cat([a, a])).pos
             for _ in range(REPEATS)]
    err = torch.stack([(k[0] - p[:B]).abs().flatten(1).amax(1)
                       for p in plain])                         # (R, B)
    chaos = torch.stack([(p[B:] - p[:B]).abs().flatten(1).amax(1)
                         for p in plain])
    spread = torch.stack([(p[:B] - plain[0][:B]).abs().flatten(1).amax(1)
                          for p in plain[1:]]).amax(0)          # (B,)
    i = int(err.amax(0).argmax())
    print(f'[case] MoveToCorner-Demo, B={B}, step {cs.PARITY_STEPS}: K1 the '
          f'same bits twice; K1 against {REPEATS} plain runs, largest env '
          f'error per run: '
          + ', '.join(f'{x:.3e}' for x in err.amax(1).tolist()))
    print(f'[case] the 1-ulp-up nudge, largest env per run: '
          + ', '.join(f'{x:.3e}' for x in chaos.amax(1).tolist()))
    print(f'[case] the plain version against its own first run: largest '
          f'env {float(spread.max()):.3e}, envs that differ '
          f'{int((spread > 0).sum())} of {B}')
    print(f'[case] env {i}: K1 against each plain run '
          + ', '.join(f'{x:.3e}' for x in err[:, i].tolist())
          + f'; the plain runs spread {float(spread[i]):.3e}')
    e, nudges = cs.nudge_spread(st, i, a)
    q = torch.quantile(nudges.double(), torch.tensor(
        [0.0, 0.5, 1.0], dtype=torch.float64, device=nudges.device)).tolist()
    print(f'[case] env {i}: K1 alone {e:.3e}; its {cs.PARITY_NUDGES} 1-ulp '
          f'nudges move the plain version by min/median/max {q[0]:.3e}/'
          f'{q[1]:.3e}/{q[2]:.3e}')


if __name__ == '__main__':
    main()
