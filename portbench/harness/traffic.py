"""Traffic from the seed: the seed of each episode's reset, the held random
actions, and which rows and steps of each episode the check compares.

Every seed gets the same sizes (batch, episode length, tables); only the
values differ.
"""

from __future__ import annotations

import numpy as np
import torch

N_ACTIONS = 18


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed for the part `path` (ints) of the run of `seed`."""
    words = [int(seed) % 2 ** 64] + [int(p) for p in path]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# the parts of a run that draw from the seed
RESET, ACTIONS, CHECK = 0, 1, 2


def reset_generator(seed: int, episode: int) -> torch.Generator:
    """The CPU generator of episode `episode`'s reset (as the port's
    rollouts reset, from a CPU generator)."""
    return torch.Generator().manual_seed(sub_seed(seed, RESET, episode))


def held_actions(seed: int, n_steps: int, batch: int, device,
                 hold=(4, 16)) -> torch.Tensor:
    """(n_steps, batch) int32 on `device`: each env draws one of the 18
    actions and holds it for a number of steps drawn uniformly from
    hold[0] to hold[1], then the next; drawn on `device` from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, ACTIONS))
    n_seg = n_steps // hold[0] + 1
    acts = torch.randint(0, N_ACTIONS, (batch, n_seg), generator=gen,
                         device=device, dtype=torch.int32)
    lens = torch.randint(hold[0], hold[1] + 1, (batch, n_seg),
                         generator=gen, device=device)
    ends = torch.cumsum(lens, 1)
    t = torch.arange(n_steps, device=device).expand(batch, n_steps)
    seg = torch.searchsorted(ends, t.contiguous(), right=True)
    return torch.gather(acts, 1, seg).t().contiguous()


def check_plan(seed: int, n_episodes: int, ep_len: int, batch: int,
               rows: int):
    """For each of `n_episodes` episodes, the step the check compares
    (1 to ep_len) and `rows` distinct envs; and the order in which the
    check takes the episodes that the window finished."""
    rng = np.random.Generator(np.random.PCG64(sub_seed(seed, CHECK)))
    steps = rng.integers(1, ep_len + 1, n_episodes)
    envs = np.stack([rng.choice(batch, min(rows, batch), replace=False)
                     for _ in range(n_episodes)])
    order = rng.permutation(n_episodes)
    return steps, envs, order
