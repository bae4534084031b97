"""The learner cells (a traffic file with ``"loop": "gail"``): whole GAIL
iterations of the port's ``GAILTrainer``, their set-up, the window, the
traced window and the check.

One iteration is the GAIL tool's (``magical_tpu_torch/tools/
train_gail_mtr.py``): a reset of fresh episodes from the iteration's
generator, ``GAILTrainer.collect`` (the policy's actions through one whole
episode, the discriminator's reward), ``ppo_epochs`` x ``ppo_minibatches``
calls of ``ppo_update`` on minibatches of a permutation drawn on the host,
then ``disc_updates`` calls of ``disc_update`` on policy and expert
samples drawn on the host.  The harness makes the weights of both
networks from the seed, on the device, and hands the same to the program
and to the reference.

Set-up builds one trainer, collects the expert's demonstrations (the
tool's scripted expert), and runs iteration 0 through the window's own
call; the window then runs whole iterations on the same trainer until
``seconds`` have passed, a CUDA event before the first and after each.
Every iteration keeps the same for the check (:class:`Record`): both
networks' parameters and Adam state at its start, its reset, the check
rows' states, each PPO step's indices, parameters and losses, the
discriminator's indices and its state after its step, and its rollout,
held on the device until the next iteration's record replaces it.

The check (:func:`readings`) reads two iterations, after the window and
with the program freed, against ``portbench/reference/learner.py`` and
the MoveToRegion reference: iteration 0, from the harness's weights, and
the window's last, from the program's own parameters and Adam state at
its start (the iterations between are the program's alone); each number
is the larger of the two, and is described in ``NUMBERS``.  The reference
follows the program's first PPO steps from the same parameters; the
rollout's observations and actions, which only the program's env and
sampler give, are its data, and the env's part of them is held to the env
reference by ``reset_gap`` and ``frame_gap``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import tempfile
import time
import types
from typing import Callable

import numpy as np
import torch

from portbench.harness import check, spec, trace, traffic
from portbench.harness.window import STACK, Clock, clone_state
from portbench.reference import dtype as DT
from portbench.reference import learner as L
from portbench.reference.env import Scene, to_float
from portbench.work import learner as work

NUMBERS = (
    'reset_gap',    # the iteration's reset, the whole batch, against the
                    # reference's from the same generator
    'frame_gap',    # the rollout's observation rows after the reset and
                    # at a seeded step, against the reference's frames of
                    # the program's states: the largest uint8 difference
    'logit_gap',    # the rollout's log-probs of the taken actions, values
                    # and bootstrap values, against the reference policy's
                    # at the iteration's starting parameters: the largest
                    # |difference|,
                    # in the heads' own units (nats, the value's)
    'reward_gap',   # the rollout's rewards against the reference
                    # discriminator's logits: the largest |difference|
    'adv_gap',      # GAE's advantages and returns from the program's
                    # rewards, values and ends, against the reference's
                    # from the same; infinite where an episode end is not
                    # at the rollout's last step
    'ppo_gap',      # each of the first FOLLOWED PPO steps' losses, the
                    # reference following from the starting parameters and
                    # Adam state on the program's rollout: the gap of pg
                    # over the mean |normalised advantage|, of the value
                    # loss's root (the rms value error, in the value's
                    # units) and of the entropy (nats)
    'steps_gap',    # every PPO step's losses, read the same way, the
                    # reference from the program's parameters before it
    'grad_gap',     # the gradient the optimiser got at the first PPO step,
                    # worked out from Adam's first moment before and after
                    # it, by the worst leaf (reference/learner.leaf_gap)
    'change_gap',   # the policy's change over the first FOLLOWED steps:
                    # each leaf's gap of norms, over the leaves whose
                    # reference gradient reaches a thousandth of the median
                    # leaf's, and of those the median (the higher middle);
                    # by the worst leaf it is not steady: Adam scales an
                    # element whose gradient and second moment both lie at
                    # rounding's level (a unit all but dead) to a move of
                    # a tenth of lr or more, by rounding alone
    'disc_gap',     # the discriminator's first step: its loss (relative)
                    # and, where it was taken, its gradient (from Adam's
                    # first moment) by the worst leaf, each leaf against
                    # the sum of its expert and policy terms' norms where
                    # that is larger; infinite where its parameters or Adam
                    # state moved and the step was frozen, or did not move
                    # and it was taken
)
INF = math.inf
# the learner's layers (PERF.md §3), read from the harness's own ranges
# (``learner.collect``, ``.ppo``, ``.disc``) and the window's time
LAYERS = ('GAIL rollout', 'GAIL PPO update', 'GAIL discriminator',
          'GAIL iteration')
# the parts of a run that draw from the seed, past traffic's
WEIGHTS, EXPERT, SAMPLE, DRAWS = 10, 11, 12, 13
# the rows of the rollout whose frames the check compares
CHECK_ROWS = 64
# PPO steps the reference follows from the starting weights
FOLLOWED = 3
# leaves whose reference gradient is under this share of the median
# leaf's move under Adam by rounding alone; the change leaves them out
STILL = 1e-3


def _no_range(name):
    return contextlib.nullcontext()


def make_weights(config: dict, channels: int, seed: int, device):
    """(policy, discriminator) parameters {name: tensor}, float32, from the
    seed, on `device`, in one draw: LeCun-normal kernels (std
    sqrt(1/fan_in)), biases and GroupNorm shifts N(0, 0.05^2), GroupNorm
    scales 1 + N(0, 0.05^2)."""
    A = config['n_actions']

    def shapes(net, disc):
        out, c = {}, channels
        for i, w in enumerate(net['widths']):
            k = net['first_kernel'] if i == 0 else 3
            out[f'conv{i}.weight'] = (w, c, k, k)
            out[f'conv{i}.bias'] = (w,)
            out[f'gn{i}.weight'] = (w,)
            out[f'gn{i}.bias'] = (w,)
            c = w
        feat = c + (A if disc else 0)
        out['fc.weight'], out['fc.bias'] = (net['fc'], feat), (net['fc'],)
        heads = {'out': 1} if disc else {'pi': A, 'v': 1}
        for name, n in heads.items():
            out[f'{name}.weight'], out[f'{name}.bias'] = (n, net['fc']), (n,)
        return out

    nets = [shapes(config['policy'], False),
            shapes(config['discriminator'], True)]
    total = sum(math.prod(s) for net in nets for s in net.values())
    gen = torch.Generator(device=device).manual_seed(
        traffic.sub_seed(seed, WEIGHTS))
    z = torch.randn(total, generator=gen, device=device)
    out, at = [], 0
    for net in nets:
        params = {}
        for name, shape in net.items():
            n = math.prod(shape)
            x = z[at:at + n].reshape(shape)
            at += n
            if name.endswith('weight') and len(shape) > 1:
                x = x * math.sqrt(1.0 / math.prod(shape[1:]))
            elif name.startswith('gn') and name.endswith('weight'):
                x = 1.0 + 0.05 * x
            else:
                x = 0.05 * x
            params[name] = x.contiguous()
        out.append(params)
    return out


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _moment(module, opt) -> dict:
    """Adam's first moment of each parameter (zeros before a step)."""
    return _adam(module, opt)[0]


def _adam(module, opt):
    """A copy of Adam's state: (first moments, second moments, the steps
    taken); zeros and 0 before its first step."""
    m, v, t = {}, {}, 0
    for k, p in module.named_parameters():
        st = opt.state.get(p, {})
        if 'exp_avg' in st:
            m[k] = st['exp_avg'].detach().clone()
            v[k] = st['exp_avg_sq'].detach().clone()
            t = st['step'].detach().clone()
        else:
            m[k], v[k] = torch.zeros_like(p), torch.zeros_like(p)
    return m, v, t


class Record:
    """What one iteration keeps for the check: every iteration keeps the
    same, so that every iteration of every run pays the same."""

    def __init__(self, i: int, rows: torch.Tensor, trainer):
        self.iteration = i
        self.rows = rows
        self.states = []            # the rows' states after each step
        self.perms = []             # each PPO step's indices
        self.before = []            # the policy before each PPO step
        self.parts = []             # each PPO step's (pg, vloss, entropy)
        self.p_start = _params(trainer.policy)
        self.adam_start = _adam(trainer.policy, trainer.policy_opt)
        self.d_start = _params(trainer.disc)
        self.dadam_start = _adam(trainer.disc, trainer.disc_opt)

    def recording(self, step: Callable):
        def recorded(carry, act):
            out = step(carry, act)
            self.states.append(clone_state(out[0].state, self.rows))
            return out
        return recorded

    def before_ppo(self, k, idx, trainer):
        self.perms.append(np.asarray(idx))
        self.before.append(_params(trainer.policy))

    def after_ppo(self, k, parts, trainer):
        self.parts.append(torch.stack([parts['pg'], parts['vloss'],
                                       parts['entropy']]).detach().clone())
        if k == 0:
            self.m_first = _moment(trainer.policy, trainer.policy_opt)
        if k == FOLLOWED - 1:
            self.p_followed = _params(trainer.policy)

    def after_disc(self, ip, ie, dm, trainer):
        self.ip, self.ie, self.disc = ip, ie, dm
        self.d_after = _params(trainer.disc)
        self.dadam_after = _adam(trainer.disc, trainer.disc_opt)

    def after_collect(self, traj, last_obs):
        self.traj = traj            # held, not copied: collect's own
        self.last_obs = last_obs.clone()


class Learner:
    """One run's env, trainer, expert data and draws."""

    def __init__(self, cell: spec.Cell, seed: int, device, batch: int,
                 dtype=torch.bfloat16):
        from magical_tpu_torch.tools.train_gail_mtr import collect_expert
        from magical_tpu_torch.train.gail import GAILTrainer
        from portbench.harness.bench import make_env
        c, tr = cell.config, cell.traffic
        self.config, self.traffic = c, tr
        self.seed, self.batch = seed, batch
        self.phases = {}               # set-up's parts, host seconds
        mark = time.time()
        self.env = env = make_env(cell, device)
        self.T = env.max_episode_steps
        self.n = self.T * batch
        self.phases['env'] = time.time() - mark
        mark = time.time()
        self.de_obs, self.de_act, _ = collect_expert(
            env, int(tr['expert_episodes']),
            seed=torch.Generator().manual_seed(
                traffic.sub_seed(seed, EXPERT)))
        self.sync()
        self.phases['expert'] = time.time() - mark
        mark = time.time()
        obs_shape = tuple(self.de_obs.shape[1:])
        self.obs_shape = obs_shape
        hp = c['learner']
        self.trainer = GAILTrainer(
            env, obs_shape=obs_shape, num_actions=c['n_actions'],
            policy_lr=hp['policy_lr'], disc_lr=hp['disc_lr'],
            gamma=hp['gamma'], lam=hp['lam'], clip_eps=hp['clip_eps'],
            entropy_coef=hp['entropy_coef'], value_coef=hp['value_coef'],
            rollout_len=self.T, policy_widths=c['policy']['widths'],
            disc_widths=c['discriminator']['widths'],
            disc_freeze_acc=hp['disc_freeze_acc'],
            disc_obs_only=c['discriminator']['obs_only'], dtype=dtype,
            device=device)
        w_policy, w_disc = make_weights(c, obs_shape[-1], seed, env.device)
        self.trainer.policy.load_state_dict(w_policy)
        self.trainer.disc.load_state_dict(w_disc)
        self.act_gen = torch.Generator(device=env.device).manual_seed(
            traffic.sub_seed(seed, SAMPLE))
        self.rng = np.random.Generator(np.random.PCG64(
            traffic.sub_seed(seed, DRAWS)))
        self.ppo_steps = int(tr['ppo_epochs']) * int(tr['ppo_minibatches'])
        self.rows = None              # the check's rows (run_cell's plan)
        self.latest = None            # the last iteration's Record
        self.sync()
        self.phases['trainer'] = time.time() - mark

    def iterate(self, i: int, span: Callable = _no_range):
        """Iteration `i`: the tool's loop body, keeping its :class:`Record`
        as ``latest``.  Returns each discriminator update's accuracy (0-d
        tensors on the device)."""
        env, tr, trainer, rng, n = (self.env, self.traffic, self.trainer,
                                    self.rng, self.n)
        self.latest = None            # its rollout goes before the next's
        rec = Record(i, self.rows, trainer)
        with span('learner.collect'):
            carry, obs = env.reset(traffic.reset_generator(self.seed, i),
                                   self.batch)
            rec.reset_state = clone_state(carry.state)
            env.step = rec.recording(env.step)
            try:
                carry, obs, traj = trainer.collect(carry, obs, self.act_gen)
            finally:
                del env.step
            rec.after_collect(traj, obs)
        with span('learner.ppo'):
            mb = max(1, n // int(tr['ppo_minibatches']))
            k = 0
            for _ in range(int(tr['ppo_epochs'])):
                perm = rng.permutation(n)
                for m in range(int(tr['ppo_minibatches'])):
                    idx = perm[m * mb:(m + 1) * mb]
                    rec.before_ppo(k, idx, trainer)
                    parts = trainer.ppo_update(traj, idx)
                    rec.after_ppo(k, parts, trainer)
                    k += 1
        with span('learner.disc'):
            n_exp = len(self.de_act)
            accs = []
            for u in range(int(tr['disc_updates'])):
                ip = rng.choice(n, size=min(int(tr['disc_batch']), n),
                                replace=False)
                ie = rng.choice(n_exp, size=min(int(tr['disc_batch']),
                                                n_exp), replace=False)
                dm = trainer.disc_update(traj['obs'], traj['act'], ip,
                                         self.de_obs, self.de_act, ie)
                if u == 0:
                    rec.after_disc(ip, ie, dm, trainer)
                accs.append(dm['disc_acc'])
        self.latest = rec
        return accs

    def finish(self, rec: Record):
        """What the check takes of `rec` from the trainer before it is
        freed (GAE of the rollout, the discriminator's expert rows, its
        freeze), and the rollout's observations moved to the host."""
        host = torch.device('cpu')
        t, traj = self.trainer, rec.traj
        rec.adv, rec.ret = t.gae(traj)
        rec.obs = traj['obs'].to(host)
        rec.traj = {k: v for k, v in traj.items() if k != 'obs'}
        rec.last_obs = rec.last_obs.to(host)
        rec.exp_obs = self.de_obs.index_select(
            0, torch.as_tensor(rec.ie, device=self.de_obs.device)).to(host)
        rec.disc_taken = not bool(rec.disc['disc_acc'] > t.disc_freeze_acc)

    def sync(self):
        if self.env.device.type == 'cuda':
            torch.cuda.synchronize()

    def free(self):
        """Drop the program's state (trainer, env, expert data)."""
        for name in ('trainer', 'env', 'de_obs', 'de_act'):
            setattr(self, name, None)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Window:
    marks_ms: list
    iterations: int
    taken: list           # each iteration's discriminator steps taken

    @property
    def seconds(self):
        return self.marks_ms[-1] / 1e3


def run_window(run: Learner, seconds: float, max_iterations=None,
               first: int = 1, span: Callable = _no_range) -> Window:
    """Whole iterations from `first` until `seconds` have passed on the
    host's clock (or `max_iterations` have run); one sync at the end."""
    clock = Clock(run.env.device)
    accs = []
    clock.mark()
    start = time.perf_counter()
    i = first
    while True:
        with span('learner.iteration'):
            accs.append(run.iterate(i, span))
        clock.mark()
        i += 1
        if time.perf_counter() - start >= seconds or (
                max_iterations is not None and i - first >= max_iterations):
            break
    marks = clock.times_ms()
    freeze = run.trainer.disc_freeze_acc
    taken = [sum(not bool(a > freeze) for a in it) for it in accs]
    return Window(marks_ms=marks, iterations=i - first, taken=taken)


def samples_per_s(run: Learner, w: Window) -> float:
    """Every sample the window's iterations learned on, over its seconds
    (resets, rollouts, updates and the host's draws inside)."""
    return w.iterations * run.n / w.seconds


def window_flops(run: Learner, w: Window) -> float:
    return sum(work.iteration_flops(run.config, run.traffic | {
        'batch': run.batch}, run.obs_shape, taken) for taken in w.taken)


# -- the traced run -----------------------------------------------------------

def attribute(events: list) -> trace.Trace:
    """The device operations of chrome-trace `events`, each with the
    ``learner.`` ranges open at its launch, by time (an op launched from
    the autograd engine's thread belongs to the range the main thread was
    in); the window from the first such range to the last operation's
    end, and the idle gaps labelled by the innermost range."""
    ranges = sorted((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                    for e in events if e.get('ph') == 'X'
                    and e.get('cat') == 'user_annotation'
                    and e.get('name', '').startswith('learner.'))
    launch = {}
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in trace.LAUNCH_CATS:
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                launch[corr] = e['ts']
    ops = []
    for e in sorted((e for e in events if e.get('ph') == 'X'
                     and e.get('cat') in trace.DEVICE_CATS),
                    key=lambda e: e['ts']):
        ts = launch.get((e.get('args') or {}).get('correlation'))
        names = () if ts is None else tuple(
            r[2] for r in ranges if r[0] <= ts <= r[1])
        ops.append(trace.Op(e['name'], float(e['ts']),
                            float(e.get('dur', 0)), names, 0))
    return trace.timeline(ops, ranges[0][0] if ranges else None)


def traced_window(run: Learner, iterations: int, host_iterations: int):
    """`iterations` under the profiler, with the harness's ranges and the
    discriminator's forward in ``learner.disc``; then `host_iterations`
    more unprofiled, timed by CUDA events.  Returns the readers' context."""
    from torch.profiler import ProfilerActivity, profile
    disc = run.trainer.disc
    forward = disc.forward

    def ranged(*args, **kwargs):
        with trace.span('learner.disc'):
            return forward(*args, **kwargs)
    disc.forward = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w = run_window(run, math.inf, max_iterations=iterations,
                           span=trace.span)
        with tempfile.TemporaryDirectory() as tmp:
            path = f'{tmp}/trace.json'
            prof.export_chrome_trace(path)
            with open(path) as f:
                t = attribute(json.load(f)['traceEvents'])
        del prof
    finally:
        del disc.forward
    host = run_window(run, math.inf, max_iterations=host_iterations,
                      first=1 + iterations)
    return w, types.SimpleNamespace(
        trace=t, iterations=w.iterations, flops=window_flops(run, host),
        host_s=host.seconds, host_iterations=host.iterations,
        peak_flops=work.PEAK_BF16_FLOPS)


# -- the check ----------------------------------------------------------------

def _rel(got, want) -> float:
    """The largest |got - want| over the largest |want| (infinite where
    not finite)."""
    d = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    x = d / max(scale, 1e-30)
    return INF if not math.isfinite(x) else x


def _abs(got, want) -> float:
    """The largest |got - want| (infinite where not finite)."""
    d = float((got.double() - want.double()).abs().max())
    return d if math.isfinite(d) else INF


def _parts(pk: dict) -> list:
    return [float(pk[n].detach()) for n in ('pg', 'vloss', 'entropy')]


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _moved(rec: Record) -> bool:
    """Whether the discriminator's parameters or Adam state differ after
    its first step from the iteration's start."""
    (m0, v0, t0), (m1, v1, t1) = rec.dadam_start, rec.dadam_after
    return int(t0) != int(t1) or any(
        not torch.equal(a[k], b[k])
        for a, b in ((rec.d_start, rec.d_after), (m0, m1), (v0, v1))
        for k in a)


def _worst(gaps: dict):
    k = max(gaps, key=gaps.get) if gaps else None
    return [k, gaps.get(k, 0.0)]


def readings(cell, run: Learner, recs: list, control: bool = False,
             detail: dict = None) -> dict:
    """{number: reading}: the largest of :func:`iteration_readings` over
    the iterations `recs` kept; `detail` gets each one's parts, by its
    iteration."""
    out = {k: 0.0 for k in NUMBERS}
    for rec in recs:
        part = {}
        got = iteration_readings(cell, run, rec, control, part)
        if detail is not None:
            detail[str(rec.iteration)] = part | {'numbers': got}
        out = {k: max(out[k], got[k]) for k in NUMBERS}
    return out


def iteration_readings(cell, run: Learner, rec: Record,
                       control: bool = False, detail: dict = None) -> dict:
    """{number: reading} of one iteration against the reference, from the
    parameters and Adam state it started from, or, with `control`, of the
    control's answers in the program's place: the env reference in
    bfloat16 (``dtype.lowered``) for the reset and frames, GAE in
    bfloat16, the learner reference with every layer's input and weight
    rounded through float8, and its backward too (``learner.lowered``).
    `detail`, where given, gets the parts that each number is the largest
    of."""
    detail = {} if detail is None else detail
    c, tr = cell.config, cell.traffic
    hp, A = c['learner'], c['n_actions']
    dev = rec.reset_state.pos.device
    T, B = run.T, run.batch
    scene = Scene(c, tr['variant'], tr['fidelity'])
    out = {}

    # the reset and the frames
    i = rec.iteration
    want = scene.reset(traffic.reset_generator(run.seed, i), B, dev)
    if control:
        with DT.lowered():
            got = scene.reset(traffic.reset_generator(run.seed, i), B, dev)
    else:
        got = check.as_reference(rec.reset_state)
    out['reset_gap'] = check.state_gap(got, want)
    rows = rec.rows
    steps = [check.as_reference(clone_state(rec.reset_state, rows))] + [
        check.as_reference(s) for s in rec.states]
    t_check = rec.check_step
    frame_gap = 0.0
    for t in (0, t_check):
        hist = steps[max(0, t - STACK + 1):t + 1]
        states = check._cat_states(hist)
        k = len(rows)

        def stacked(frames):
            return scene.observation([{v: f[j * k:(j + 1) * k]
                                       for v, f in frames.items()}
                                      for j in range(len(hist))])
        want = stacked(scene.frames(states))
        if control:
            with DT.lowered():
                got = stacked(scene.frames(to_float(states,
                                                    torch.bfloat16)))
        else:
            got = rec.obs[t].index_select(0, rows.cpu()).to(dev)
        frame_gap = max(frame_gap, check._gap(got, want))
    out['frame_gap'] = frame_gap

    # the rollout's forwards, at the iteration's starting parameters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    obs, act = _flat(rec.obs), _flat(rec.traj['act'])
    act0 = torch.zeros_like(act)

    def forwards():
        logits, value = L.in_chunks(lambda o: L.policy(rec.p_start, o),
                                    obs, device=dev)
        _, last_v = L.in_chunks(lambda o: L.policy(rec.p_start, o),
                                rec.last_obs, device=dev)
        reward = L.in_chunks(lambda o, a: L.discriminator(rec.d_start, o, a,
                                                          A),
                             obs, act0.cpu(), device=dev)
        logp = torch.log_softmax(logits, -1).gather(
            1, act.long()[:, None])[:, 0]
        return logp, value, last_v, reward

    ref = forwards()
    if control:
        with L.lowered():
            got = forwards()
    else:
        t_ = rec.traj
        got = (_flat(t_['logp']), _flat(t_['value']), t_['last_value'],
               _flat(t_['reward']))
    out['logit_gap'] = max(_abs(got[0], ref[0]), _abs(
        torch.cat([got[1], got[2]]), torch.cat([ref[1], ref[2]])))
    out['reward_gap'] = _abs(got[3], ref[3])
    detail.update(logp=_abs(got[0], ref[0]),
                  reward_std=float(ref[3].std()))

    # GAE, from the program's rewards, values and ends
    t_ = rec.traj
    done = t_['done']
    ends = torch.zeros_like(done)
    ends[-1] = True
    inputs = (t_['reward'], t_['value'], done, t_['last_value'])
    adv_w, ret_w = L.gae(*inputs, hp['gamma'], hp['lam'])
    if control:
        adv_g, ret_g = L.gae(*(x.to(torch.bfloat16) if x.is_floating_point()
                               else x for x in inputs),
                             hp['gamma'], hp['lam'])
    else:
        adv_g, ret_g = rec.adv, rec.ret
    out['adv_gap'] = INF if not torch.equal(done, ends) else max(
        _rel(adv_g, adv_w), _rel(ret_g, ret_w))

    # PPO: the reference follows the first steps from the starting
    # parameters and Adam state, and takes each step's losses from the
    # program's parameters before it, all on the program's rollout (its
    # log-probs, and GAE of its rewards, values and ends), which the
    # numbers above hold apart
    adv_in = _flat(L.normalise(adv_w))
    ret_in, logp_in = _flat(ret_w), _flat(t_['logp'])

    def minibatch(k):
        idx = torch.as_tensor(rec.perms[k], dtype=torch.long)
        d = idx.to(dev)
        return (obs[idx].to(dev), act[d], logp_in[d], adv_in[d], ret_in[d],
                float(adv_in[d].abs().mean()))

    m0, v0, t0 = rec.adam_start

    def follow():
        p = L.leaves(rec.p_start)
        opt = L.Adam(hp['policy_lr'], **hp['adam'], m=m0, v=v0, t=t0)
        parts, first_grad = [], None
        for k in range(min(FOLLOWED, len(rec.perms))):
            *mb, scale = minibatch(k)
            loss, pk = L.ppo_loss(p, *mb, hp)
            g = L.grads(loss, p)
            parts.append((_parts(pk), scale))
            first_grad = g if first_grad is None else first_grad
            p = opt.step(p, g)
        change = {k: (p[k] - rec.p_start[k]).detach() for k in p}
        return parts, first_grad, change

    @torch.no_grad()
    def each_step():
        out = []
        for k, p in enumerate(rec.before):
            *mb, scale = minibatch(k)
            out.append((_parts(L.ppo_loss(p, *mb, hp)[1]), scale))
        return out

    want_parts, want_g1, want_change = follow()
    want_steps = each_step()
    b1 = hp['adam']['b1']
    if control:
        with L.lowered():
            got_parts, got_g1, got_change = follow()
            got_steps = each_step()
        got_parts = [pk for pk, _ in got_parts]
        got_steps = [pk for pk, _ in got_steps]
    else:
        got_steps = [[float(x) for x in parts] for parts in rec.parts]
        got_parts = got_steps[:len(want_parts)]
        got_g1 = {k: (v - b1 * m0[k]) / (1 - b1)
                  for k, v in rec.m_first.items()}
        got_change = {k: rec.p_followed[k] - rec.p_start[k]
                      for k in rec.p_followed}

    def loss_gaps(want, got):
        out = []
        for (w, adv_scale), g in zip(want, got):
            gaps = [abs(g[0] - w[0]) / adv_scale,
                    abs(math.sqrt(max(g[1], 0.0)) - math.sqrt(w[1])),
                    abs(g[2] - w[2])]
            out.append(max(INF if math.isnan(x) else x for x in gaps))
        return out
    detail['ppo'] = loss_gaps(want_parts, got_parts)
    detail['steps'] = loss_gaps(want_steps, got_steps)
    out['ppo_gap'] = max(detail['ppo'])
    out['steps_gap'] = max(detail['steps'])
    detail['grad'] = _worst(L.leaf_gaps(got_g1, want_g1))
    out['grad_gap'] = L.leaf_gap(got_g1, want_g1)
    norms = {k: L.norm(v) for k, v in want_g1.items()}
    med = statistics.median(norms.values())
    moving = {k for k, v in norms.items() if v >= STILL * med}
    changes = L.leaf_gaps(got_change, want_change, moving)
    out['change_gap'] = statistics.median_high(changes.values())
    detail['change'] = _worst(changes)

    # the discriminator's first step, from its starting parameters
    ip = torch.as_tensor(rec.ip, dtype=torch.long)
    zeros_p = torch.zeros(len(ip), dtype=torch.long, device=dev)
    zeros_e = torch.zeros(len(rec.exp_obs), dtype=torch.long, device=dev)

    def disc_step():
        p = L.leaves(rec.d_start)
        exp, pol, acc = L.disc_loss(p, obs[ip].to(dev), zeros_p,
                                    rec.exp_obs.to(dev), zeros_e, A)
        g_e, g_p = L.grads(exp, p), L.grads(pol, p)
        return (float((exp + pol).detach()), float(acc),
                {k: g_e[k] + g_p[k] for k in p},
                {k: L.norm(g_e[k]) + L.norm(g_p[k]) for k in p})

    loss_w, acc_w, g_w, halves = disc_step()
    if control:
        with L.lowered():
            loss_g, acc_g, g_g, _ = disc_step()
        taken = True
    else:
        loss_g = float(rec.disc['disc_loss'])
        acc_g = float(rec.disc['disc_acc'])
        taken = rec.disc_taken
        dm0, dm1 = rec.dadam_start[0], rec.dadam_after[0]
        g_g = {k: (dm1[k] - b1 * dm0[k]) / (1 - b1) for k in dm1}
    gap = abs(loss_g - loss_w) / abs(loss_w)
    detail['disc'] = [gap, acc_g, abs(acc_g - acc_w),
                      _worst(L.leaf_gaps(g_g, g_w, floor=halves))
                      if taken else None]
    moved = control or _moved(rec)
    if taken:
        gap = max(gap, L.leaf_gap(g_g, g_w, floor=halves))
    if taken != moved:
        gap = INF
    out['disc_gap'] = INF if math.isnan(gap) else gap
    return out


# -- one run ------------------------------------------------------------------

def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device='cuda', start: float = None, batch: int = None,
             control: bool = False, here=spec.HERE, episodes: int = None,
             dtype=torch.bfloat16, detail: bool = False) -> dict:
    """One run of a learner cell, as ``bench.run_cell`` gives one of an env
    cell; `episodes` caps the window's iterations (and the traced run's),
    `dtype` is the trainer's compute type (the float32 witness), and
    `detail` adds the parts of each reading (calibration)."""
    from portbench.harness import bench
    start = time.time() if start is None else start
    device = torch.device(device)
    tr = cell.traffic
    batch = int(batch or tr['batch'])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(bench.HOST_THREADS)
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = Learner(cell, seed, device, batch, dtype)
    plan = np.random.Generator(np.random.PCG64(
        traffic.sub_seed(seed, traffic.CHECK)))
    run.rows = torch.as_tensor(np.sort(plan.choice(
        batch, min(CHECK_ROWS, batch), replace=False)), dtype=torch.long,
        device=run.env.device)
    mark = time.time()
    run.iterate(0)
    first = run.latest
    first.check_step = int(plan.integers(1, run.T))
    run.finish(first)
    run.sync()
    run.phases['iteration_0'] = time.time() - mark
    setup_s = time.time() - start
    if traced:
        tt = tr['trace']
        cap = (lambda n: n) if episodes is None else (
            lambda n: min(n, episodes))
        w, ctx = traced_window(run, cap(int(tt['iterations'])),
                               cap(int(tt['host_iterations'])))
    else:
        w = run_window(run, seconds, max_iterations=episodes)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = bench.forbidden_modules()
    if found:
        raise RuntimeError(f'loaded while the window ran: {found}')
    flops = window_flops(run, w)
    rate = samples_per_s(run, w)
    phases = run.phases
    n_samples = run.n
    last = run.latest
    last.check_step = int(plan.integers(1, run.T))
    run.finish(last)
    run.free()
    limits = tr['limits']
    parts = {'program': {}, 'control': {}}
    checked = time.time()
    values = readings(cell, run, [first, last], detail=parts['program'])
    check_s = time.time() - checked
    result = {'correct': check.verdict(values, limits, NUMBERS),
              'attempted': w.iterations * n_samples, 'failed': 0}
    if traced:
        result['metrics'] = bench.per_layer(cell, ctx, here)
    else:
        quantity = {'train_samples_per_s': rate, 'setup_s': setup_s}
        result['metrics'] = {m['name']: {'value': quantity[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
    result['device'] = {
        'platform': 'gpu' if cuda else 'cpu',
        'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
        'count': 1, 'memory_peak_bytes': peak}
    if traced:
        t = ctx.trace
        result['device'].update(busy_s=t.busy_us / 1e6,
                                window_s=t.window_us / 1e6)
        result['breakdown'] = trace.breakdown(t)
    if control:
        result['control'] = readings(cell, run, [first, last],
                                     control=True, detail=parts['control'])
    if detail:
        result['detail'] = parts
    intervals = [b - a for a, b in zip(w.marks_ms, w.marks_ms[1:])]
    result['window'] = {
        'seconds': w.seconds, 'iterations': w.iterations,
        'iteration_ms_median': statistics.median(intervals),
        'disc_steps_taken': sum(w.taken), 'checked': [0, last.iteration],
        'check_s': check_s,
        'setup_parts_s': phases,
        'model_tflop_per_s': flops / w.seconds / 1e12}
    result['checks'] = {k: {'value': values[k], 'limit': limits[k]}
                        for k in NUMBERS}
    return result
