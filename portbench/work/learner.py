"""The model FLOPs of a GAIL iteration, from the networks' shapes alone.

Counted: every convolution and dense layer, two FLOPs a multiply-add.  A
backward pass costs twice its forward (the input's gradient and the
weight's), except the first convolution's, which has no input to
differentiate and costs once its forward.  Not counted: GroupNorm, the
activations, the pooling, the softmax, GAE, Adam and the env; they are a
small share of the work and none of it runs on the tensor cores.
"""

from __future__ import annotations

# The H100 SXM's published dense bfloat16 peak at 700 W (NVIDIA's data
# sheet), FLOPs a second.
PEAK_BF16_FLOPS = 989.4e12


def _out(n: int, stride: int = 2) -> int:
    return -(-n // stride)          # SAME padding


def trunk_flops(hw: int, channels: int, widths, first_kernel: int):
    """(the trunk's forward FLOPs for one sample, its first
    convolution's)."""
    total, first, c, n = 0, 0, channels, hw
    for i, w in enumerate(widths):
        k = first_kernel if i == 0 else 3
        n = _out(n)
        f = 2 * k * k * c * w * n * n
        total += f
        first = first or f
        c = w
    return total, first


def net_flops(net: dict, hw: int, channels: int, n_actions: int,
              discriminator: bool):
    """(forward FLOPs of one sample, backward FLOPs of one sample) of the
    configuration's `net` entry."""
    trunk, first = trunk_flops(hw, channels, net['widths'],
                               net['first_kernel'])
    feat = net['widths'][-1] + (n_actions if discriminator else 0)
    heads = 1 if discriminator else n_actions + (1 if net['value_head']
                                                 else 0)
    dense = 2 * feat * net['fc'] + 2 * net['fc'] * heads
    fwd = trunk + dense
    return fwd, 2 * fwd - first


def iteration_flops(config: dict, traffic: dict, obs_shape,
                    disc_steps_taken: int) -> float:
    """One iteration's model FLOPs: the rollout's policy forwards (each
    step's and the bootstrap's), the discriminator's reward over the
    rollout, the PPO epochs' forwards and backwards over every sample, and
    the discriminator updates' forwards, with their backwards where the
    step was taken."""
    hw, _, ch = obs_shape
    A = config['n_actions']
    pf, pb = net_flops(config['policy'], hw, ch, A, False)
    df, db = net_flops(config['discriminator'], hw, ch, A, True)
    B, T = traffic['batch'], config['ep_len']
    n = B * T
    rollout = (T + 1) * B * pf + n * df
    ppo = traffic['ppo_epochs'] * n * (pf + pb)
    per_disc = min(traffic['disc_batch'], n) + min(
        traffic['disc_batch'], traffic['expert_episodes'] * T)
    disc = traffic['disc_updates'] * per_disc * df \
        + disc_steps_taken * per_disc * db
    return float(rollout + ppo + disc)
