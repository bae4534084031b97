"""The plain GAIL learner that decides the learner cell's `correct`: the
policy and discriminator networks, GAE, the clipped PPO loss, the
discriminator's loss and Adam, in float32 PyTorch with no kernel of the
port.  It imports nothing of the port: it is written from the equations
that the configuration file states (``portbench/configs/
gail-move-to-region.json``), after the flax modules of MAGICAL's GAIL
baseline.

Parameters are a dict of tensors named as the benchmark names them
(``conv0.weight`` (out, in, k, k), ``gn0.weight``, ``fc.weight`` (out,
in), ...), the same names as the program's modules take them by.

The equations, and where they depart from the description:

- a convolution pads SAME as XLA does: a total of max((ceil(n/2) - 1) * 2
  + k - n, 0) rows, the floor half before (at 96 rows and k = 5: one
  before, two after); stride 2; the bias added after;
- GroupNorm over 8 groups: mean and E[x^2] - mean^2 clipped at 0, over
  each group's channels and pixels, eps 1e-6, then the channel's scale
  and shift; then a ReLU;
- the trunk ends in a mean over the pixels (global average pooling);
- the policy: fc (256) and a ReLU, then the logits ``pi`` and the value
  ``v``; the discriminator: the trunk's features and the action's one-hot
  (action 0 where the discriminator sees observations only), fc (256) and
  a ReLU, then one logit ``out``;
- the observation is uint8 (N, H, W, C) and enters as its value / 255.

Everything is float32.  :func:`lowered` is the control: every
convolution's and dense layer's input and weight rounded through
``float8_e4m3fn``, and the gradient that the backward hands each of them
rounded through ``float8_e5m2`` after scaling the tensor's largest
magnitude to e5m2's largest (the forward and backward formats of fp8
training), which is a lower precision than the bfloat16 the
configuration computes in.  Adam's arithmetic stays float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

GN_GROUPS = 8
GN_EPS = 1e-6
# the rows one forward pass takes at once where no gradient is kept
CHUNK = 1024

# the rounding of a layer's input and weight, and of the gradient the
# backward hands them, or None
_ROUND = None


@contextlib.contextmanager
def lowered(forward=torch.float8_e4m3fn, backward=torch.float8_e5m2):
    """The control: every convolution's and dense layer's input and
    weight rounded through `forward`, and their gradients through
    `backward` (scaled), while the block runs."""
    global _ROUND
    old = _ROUND
    _ROUND = (forward, backward)
    try:
        yield
    finally:
        _ROUND = old


def _scaled(g: torch.Tensor, dtype) -> torch.Tensor:
    """`g` rounded through `dtype` with one scale for the tensor, its
    largest magnitude mapped to `dtype`'s largest."""
    top = float(g.abs().max())
    if not 0.0 < top < math.inf:
        return g
    s = torch.finfo(dtype).max / top
    return (g * s).to(dtype).to(g.dtype) / s


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward = backward
        return x.to(forward).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, ctx.backward), None, None


def _q(x: torch.Tensor) -> torch.Tensor:
    if _ROUND is None:
        return x
    return _Round.apply(x, *_ROUND)


# -- the networks -------------------------------------------------------------

def conv_same(x, w, b, stride=2):
    k = w.shape[-1]
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    y = F.conv2d(F.pad(_q(x), pads), _q(w), stride=stride)
    return y + b[:, None, None]


def group_norm(x, scale, shift):
    n, c, h, w = x.shape
    g = x.reshape(n, GN_GROUPS, c // GN_GROUPS, h, w)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.clamp((g * g).mean(dim=(2, 3, 4), keepdim=True)
                      - mean * mean, min=0.0)
    y = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(n, c, h, w)
    return y * scale[:, None, None] + shift[:, None, None]


def dense(x, w, b):
    return _q(x) @ _q(w).t() + b


def trunk(p, obs, n_layers):
    x = obs.permute(0, 3, 1, 2).float() / 255.0
    for i in range(n_layers):
        x = conv_same(x, p[f'conv{i}.weight'], p[f'conv{i}.bias'])
        x = F.relu(group_norm(x, p[f'gn{i}.weight'], p[f'gn{i}.bias']))
    return x.mean(dim=(2, 3))


def _layers(p):
    return sum(1 for k in p if k.startswith('conv') and k.endswith('weight'))


def policy(p, obs):
    """(logits (N, A), value (N,))."""
    x = F.relu(dense(trunk(p, obs, _layers(p)), p['fc.weight'],
                     p['fc.bias']))
    return dense(x, p['pi.weight'], p['pi.bias']), \
        dense(x, p['v.weight'], p['v.bias'])[:, 0]


def discriminator(p, obs, act, n_actions):
    """The logit of 'expert' (N,)."""
    a = F.one_hot(act.long(), n_actions).float()
    x = torch.cat([trunk(p, obs, _layers(p)), a], -1)
    x = F.relu(dense(x, p['fc.weight'], p['fc.bias']))
    return dense(x, p['out.weight'], p['out.bias'])[:, 0]


@torch.no_grad()
def in_chunks(fn, obs, *rest, device=None):
    """`fn` over the rows of `obs` (and of each of `rest`), CHUNK rows at
    a time, each moved to `device`; the outputs concatenated."""
    outs = []
    for s in range(0, obs.shape[0], CHUNK):
        parts = [x[s:s + CHUNK].to(device) for x in (obs,) + rest]
        out = fn(*parts)
        outs.append(out if isinstance(out, tuple) else (out,))
    cat = tuple(torch.cat(o) for o in zip(*outs))
    return cat if len(cat) > 1 else cat[0]


# -- GAE and the losses -------------------------------------------------------

def gae(reward, value, done, last_value, gamma, lam):
    """(advantages, returns), each (T, B): GAE(gamma, lam) over the
    rollout in reverse from the bootstrap value `last_value` (B,), cut
    where `done`."""
    adv = torch.zeros_like(reward)
    nxt_adv = torch.zeros_like(last_value)
    nxt_v = last_value
    for t in range(reward.shape[0] - 1, -1, -1):
        live = 1.0 - done[t].float()
        delta = reward[t] + gamma * nxt_v * live - value[t]
        nxt_adv = delta + gamma * lam * live * nxt_adv
        adv[t] = nxt_adv
        nxt_v = value[t]
    return adv, adv + value


def normalise(adv):
    """The advantage less its mean over the whole rollout, over its
    population std (+ 1e-8)."""
    a = adv - adv.mean()
    return a / (torch.sqrt((a * a).mean()) + 1e-8)


def ppo_loss(p, obs, act, old_logp, adv, ret, hp):
    """The clipped PPO loss of one minibatch: (loss, {'pg', 'vloss',
    'entropy'})."""
    logits, value = policy(p, obs)
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(1, act.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1 - hp['clip_eps'], 1 + hp['clip_eps'])
    pg = -torch.minimum(ratio * adv, clipped * adv).mean()
    vloss = ((value - ret) ** 2).mean()
    ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = pg + hp['value_coef'] * vloss - hp['entropy_coef'] * ent
    return loss, {'pg': pg, 'vloss': vloss, 'entropy': ent}


def disc_loss(p, pol_obs, pol_act, exp_obs, exp_act, n_actions):
    """The discriminator's loss, expert -> 1 and policy -> 0, each side's
    mean binary cross-entropy, as its two terms, and its accuracy:
    (expert's term, policy's term, acc); the loss is their sum."""
    pol = discriminator(p, pol_obs, pol_act, n_actions)
    exp = discriminator(p, exp_obs, exp_act, n_actions)
    acc = 0.5 * ((exp > 0).float().mean() + (pol <= 0).float().mean())
    return (F.binary_cross_entropy_with_logits(exp, torch.ones_like(exp)),
            F.binary_cross_entropy_with_logits(pol, torch.zeros_like(pol)),
            acc)


def grads(loss, p):
    """{name: d loss / d p[name]} (zeros where the loss does not reach)."""
    names = list(p)
    g = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(p[k]) if x is None else x
            for k, x in zip(names, g)}


def leaves(p):
    """A copy of `p` whose tensors require gradients."""
    return {k: v.detach().clone().float().requires_grad_(True)
            for k, v in p.items()}


class Adam:
    """Adam (Kingma and Ba, 2015) with bias correction, as optax.adam's
    defaults: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps); from the
    moments `m`, `v` ({name: tensor}) after `t` steps where given."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, m=None, v=None,
                 t=0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = int(t)
        self.m = None if m is None else {k: x.float() for k, x in m.items()}
        self.v = None if v is None else {k: x.float() for k, x in v.items()}

    def step(self, p, g):
        """`p` after one step on gradients `g` (new tensors)."""
        if self.m is None:
            self.m = {k: torch.zeros_like(x) for k, x in g.items()}
            self.v = {k: torch.zeros_like(x) for k, x in g.items()}
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, x in p.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g[k]
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g[k] * g[k]
            step = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            out[k] = (x.detach() - self.lr * step).requires_grad_(True)
        return out


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(got: dict, want: dict, keep=None, floor=None) -> dict:
    """Each leaf's gap of norms: |‖got‖ - ‖want‖| over the larger of
    ‖want‖ and the median leaf's ‖want‖ (and of `floor`'s norm for the
    leaf, where given), for the leaves in `keep` (all where None)."""
    names = [k for k in want if keep is None or k in keep]
    if not names:
        return {}
    w = {k: norm(want[k]) for k in names}
    med = sorted(w.values())[len(w) // 2]
    out = {}
    for k in names:
        least = 0.0 if floor is None else floor[k]
        d = abs(norm(got[k]) - w[k]) / max(w[k], med, least, 1e-30)
        out[k] = math.inf if math.isnan(d) else d
    return out


def leaf_gap(got: dict, want: dict, keep=None, floor=None) -> float:
    """The worst leaf's gap of norms (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, want, keep, floor).values(), default=0.0)
