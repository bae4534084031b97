"""Policy and discriminator networks of the learner.

The PyTorch counterparts of ``magical_tpu/models/nets.py``'s flax modules,
with the same fields and flax's arithmetic, so that weights carried across
by ``models/convert.py`` give the same logits:

- convolutions pad SAME as XLA does, which is asymmetric at stride 2 (at
  96² with a 5x5 kernel one row before and two after), explicitly with
  ``F.pad``;
- GroupNorm is flax's: epsilon 1e-6, the statistics in float32 whatever
  the working type, the variance as E[x²] - E[x]² clipped at 0;
- parameters stay float32 and are cast to ``dtype`` at each use (flax's
  ``param_dtype`` against its ``dtype``); the ``pi``, ``v`` and ``out``
  heads compute in float32;
- initialisation is flax's: LeCun-normal kernels (a normal truncated at
  two standard deviations, rescaled to std sqrt(1/fan_in)), zero biases,
  GroupNorm scales 1.

The observation is uint8 (B, H, W, C), channels last as ``BatchedEnv``
returns it; a channels-first (B, C, H, W) input is recognised by the JAX
package's test.  No layer here is a kernel of the repository: the
convolutions and products are PyTorch's own ops, as the JAX package left
them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from magical_tpu_torch import constants as C

GN_GROUPS = 8
GN_EPS = 1e-6               # flax's GroupNorm default (torch's is 1e-5)
# the std of a unit normal truncated at +-2 (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal``: a normal truncated at +-2 std, with std
    sqrt(1/fan_in) after truncation."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def same_pad(x: torch.Tensor, k: int, stride: int = 2) -> torch.Tensor:
    """Pad an NCHW tensor as XLA's SAME convolution does: total
    max((ceil(n/s) - 1)·s + k - n, 0), its floor half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad: last dim first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv_same(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """flax ``nn.Conv(strides=2, padding='SAME', dtype=dtype)``: input,
    kernel and bias in `dtype`, the bias added after the convolution."""
    k = conv.kernel_size[0]
    y = F.conv2d(same_pad(x, k, conv.stride[0]), conv.weight.to(dtype),
                 stride=conv.stride)
    return y + conv.bias.to(dtype)[:, None, None]


def group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """flax ``nn.GroupNorm``: statistics in float32 (the fast variance,
    clipped at 0), the normalisation in float32, the result in x's type."""
    B, Ch, H, W = x.shape
    g = gn.num_groups
    xf = x.float().reshape(B, g, Ch // g, H, W)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(2, 3, 4), keepdim=True)
                      - mean * mean, min=0.0)
    scale = gn.weight.reshape(1, g, Ch // g, 1, 1)
    y = (xf - mean) * (torch.rsqrt(var + gn.eps) * scale) \
        + gn.bias.reshape(1, g, Ch // g, 1, 1)
    return y.reshape(B, Ch, H, W).to(x.dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: inputs, kernel and bias in `dtype`."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def dense_colwise(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """:func:`dense` of a layer whose weight and bias are split by output
    column over a 1-D mesh (DTensors, ``ColwiseParallel``): each rank
    computes its columns, which are then gathered, so every rank holds
    the whole (B, out) result as a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = lin.weight.device_mesh
    xd = DTensor.from_local(x.to(dtype), mesh, [Replicate()],
                            run_check=False)
    y = F.linear(xd, lin.weight.to(dtype)) + lin.bias.to(dtype)
    return y.redistribute(mesh, [Replicate()]).to_local()


def to_nchw(obs: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 (B, H, W, C), or (B, C, H, W) where shape[1] <= 16 <
    shape[-1] (the JAX package's test), -> (B, C, H, W) in [0, 1]."""
    if not (obs.shape[1] <= 16 and obs.shape[-1] > 16):
        obs = obs.permute(0, 3, 1, 2)
    return obs.to(dtype) / 255.0


class _Trunk(nn.Module):
    """Strided convolutions, each followed by GroupNorm(8) and a ReLU,
    then a global average pool: (B, widths[-1]) in `dtype`."""

    def __init__(self, in_channels, widths, first_kernel, dtype):
        super().__init__()
        self.widths = tuple(widths)
        self.dtype = dtype
        c = in_channels
        for i, w in enumerate(self.widths):
            k = first_kernel if i == 0 else 3
            setattr(self, f'conv{i}', nn.Conv2d(c, w, k, stride=2))
            setattr(self, f'gn{i}', nn.GroupNorm(GN_GROUPS, w, eps=GN_EPS))
            c = w

    def trunk(self, obs):
        x = to_nchw(obs, self.dtype)
        for i in range(len(self.widths)):
            x = conv_same(x, getattr(self, f'conv{i}'), self.dtype)
            x = F.relu(group_norm(x, getattr(self, f'gn{i}')))
        return x.mean(dim=(2, 3))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initialisation, from `generator` (a CPU generator; the
        module must be on the CPU) or the global one."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, m.weight[0].numel(), generator)
                    m.bias.zero_()
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, m.in_features, generator)
                    m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()


class MagicalCNN(_Trunk):
    """Policy trunk and action logits (and an optional value head):
    ``magical_tpu/models/nets.py:MagicalCNN``.  forward(obs) -> logits
    (B, num_actions) float32, or (logits, value (B,)) with the value
    head."""

    def __init__(self, num_actions: int = C.N_ACTIONS,
                 widths: Sequence[int] = (64, 128, 128, 256),
                 dtype: torch.dtype = torch.bfloat16,
                 with_value_head: bool = False, in_channels: int = 12,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, widths, 5, dtype)
        self.num_actions = num_actions
        self.with_value_head = with_value_head
        self.fc = nn.Linear(self.widths[-1], 256)
        self.pi = nn.Linear(256, num_actions)
        if with_value_head:
            self.v = nn.Linear(256, 1)
        self.reset_parameters(generator)
        self.fc_split = False

    def split_fc(self, mesh):
        """Split ``fc`` by output column over `mesh`'s ``model`` dim
        (``ColwiseParallel``, the gathered output replicated): the layout
        of flax's ``(None, 'model')`` annotation on its kernel.  A layout
        only: the logits are those of the whole layer.  Replaces fc's
        parameters, so an optimiser is made after it."""
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                       parallelize_module)
        parallelize_module(self.fc, mesh['model'],
                           ColwiseParallel(output_layouts=Replicate()))
        self.fc_split = True
        return self

    def forward(self, obs):
        fc = dense_colwise if self.fc_split else dense
        x = F.relu(fc(self.trunk(obs), self.fc, self.dtype))
        logits = dense(x, self.pi, torch.float32)
        if self.with_value_head:
            return logits, dense(x, self.v, torch.float32)[..., 0]
        return logits


class Discriminator(_Trunk):
    """GAIL discriminator D(obs, act) -> logit of 'expert' (B,) float32:
    ``magical_tpu/models/nets.py:Discriminator``."""

    def __init__(self, num_actions: int = C.N_ACTIONS,
                 widths: Sequence[int] = (64, 128, 128),
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 12,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, widths, 3, dtype)
        self.num_actions = num_actions
        self.fc = nn.Linear(self.widths[-1] + num_actions, 256)
        self.out = nn.Linear(256, 1)
        self.reset_parameters(generator)

    def forward(self, obs, act):
        a = F.one_hot(act.long(), self.num_actions).to(self.dtype)
        x = torch.cat([self.trunk(obs), a], dim=-1)
        x = F.relu(dense(x, self.fc, self.dtype))
        return dense(x, self.out, torch.float32)[..., 0]


def obs_channels(obs_shape) -> int:
    """The channel count of an observation shape (H, W, C), or (C, H, W)
    by the JAX package's channels-first test."""
    return obs_shape[0] if (obs_shape[0] <= 16 and obs_shape[-1] > 16) \
        else obs_shape[-1]
