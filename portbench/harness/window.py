"""The measured window and its arithmetic.

The window runs closed-loop whole episodes through the port's public
entry, ``BatchedEnv.reset`` and ``BatchedEnv.step``: a reset from the
episode's seed, then ``ep_len`` steps of held random actions drawn before
the window, then the next reset.  A CUDA event is recorded before the
first reset and after every reset and every step; nothing synchronises
until the window has closed.  The window closes after the first step that
ends once ``seconds`` have passed on the host's clock, and then
synchronises once.

Besides, the window keeps what the check compares (:mod:`check`): for
every episode, the state after its reset, the rows of its observation the
check plan names, those rows of the state after the steps up to the
episode's check step, the whole state before and after that step, the
observation rows and the whole `done` and score at it, and the whole
state, score and `done` after the last step.  Every episode keeps the
same, so their cost is the same in every run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable, Optional

import torch

from portbench.harness import traffic

STACK = 4          # frames back from a check step that its observation holds


def clone_state(state, rows=None):
    """A copy of every tensor of `state` (its `rows` only, where given)."""
    return type(state)(**{
        f.name: (getattr(state, f.name) if rows is None
                 else getattr(state, f.name).index_select(0, rows)).clone()
        for f in dataclasses.fields(state)})


class Clock:
    """Marks on the device's timeline: CUDA events on a card, the host's
    clock on the CPU (the harness's tests, which time nothing)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def times_ms(self):
        """Each mark's time after the first, in ms (after a sync)."""
        if self.cuda:
            torch.cuda.synchronize()
            first = self.marks[0]
            return [first.elapsed_time(ev) for ev in self.marks]
        return [(t - self.marks[0]) * 1e3 for t in self.marks]


@dataclasses.dataclass
class Episode:
    """What the window kept of one episode."""
    index: int
    check_step: int
    rows: torch.Tensor                    # (R,) long, on the device
    reset_state: object = None            # whole batch
    reset_obs: torch.Tensor = None        # rows
    states: dict = dataclasses.field(default_factory=dict)  # step -> rows
    pre: object = None                    # whole batch, before check_step
    post: object = None                   # whole batch, after check_step
    obs: torch.Tensor = None              # rows, at check_step
    done: torch.Tensor = None             # whole batch, at check_step
    score: torch.Tensor = None            # whole batch, at check_step
    end_state: object = None              # whole batch, after the last step
    end_score: torch.Tensor = None
    end_done: torch.Tensor = None
    steps: int = 0                        # steps the window ran


@dataclasses.dataclass
class Window:
    marks_ms: list        # each mark's time after the first
    resets: int
    steps: int
    batch: int
    episodes: list        # Episode, in the order they ran

    @property
    def seconds(self):
        return self.marks_ms[-1] / 1e3

    @property
    def intervals_ms(self):
        return [b - a for a, b in zip(self.marks_ms, self.marks_ms[1:])]


@dataclasses.dataclass
class Plan:
    """What a run's window steps: the env, its batch, the pool of action
    tables (episode e takes table e mod pool) and the check plan."""
    env: object
    seed: int
    batch: int
    actions: torch.Tensor                 # (pool * ep_len, B) int32
    pool: int
    check_steps: list
    check_rows: torch.Tensor              # (E, R) long, on the device
    check_order: list                     # the episodes, in check order

    @property
    def ep_len(self):
        return self.env.max_episode_steps


def make_plan(env, seed: int, batch: int, pool: int, max_episodes: int,
              rows: int, hold=(4, 16)) -> Plan:
    dev = env.device
    steps, envs, order = traffic.check_plan(seed, max_episodes,
                                            env.max_episode_steps, batch,
                                            rows)
    return Plan(env=env, seed=seed, batch=batch,
                actions=traffic.held_actions(
                    seed, pool * env.max_episode_steps, batch, dev,
                    tuple(hold)),
                pool=pool, check_steps=[int(s) for s in steps],
                check_rows=torch.as_tensor(envs, dtype=torch.long,
                                           device=dev),
                check_order=[int(e) for e in order])


def _no_range(name):
    return contextlib.nullcontext()


def run(plan: Plan, seconds: float, max_episodes: Optional[int] = None,
        first_episode: int = 0, span: Callable = _no_range,
        on_step: Optional[Callable] = None) -> Window:
    """Run the window: whole episodes from `first_episode` until
    `seconds` have passed (or `max_episodes` have ended).  `span(name)`
    is a context around the harness's own calls (the traced run's ranges);
    `on_step(episode, step, carry)` runs after each step."""
    env, B, L = plan.env, plan.batch, plan.ep_len
    n_plan = len(plan.check_steps)
    clock = Clock(env.device)
    episodes = []
    steps = 0
    clock.mark()
    start = time.perf_counter()
    e = first_episode
    while True:
        if e >= n_plan:
            raise RuntimeError(f'the window ran past the {n_plan} episodes '
                               f'its check plan holds')
        gen = traffic.reset_generator(plan.seed, e)
        with span('portbench.reset'):
            carry, obs = env.reset(gen, B)
        clock.mark()
        ep = Episode(index=e, check_step=plan.check_steps[e],
                     rows=plan.check_rows[e])
        with span('portbench.keep'):
            ep.reset_state = clone_state(carry.state)
            ep.reset_obs = obs.index_select(0, ep.rows)
        ep.pre = ep.reset_state if ep.check_step == 1 else None
        episodes.append(ep)
        table = (e % plan.pool) * L
        p = ep.check_step
        closed = False
        for j in range(1, L + 1):
            with span('portbench.actions'):
                act = plan.actions[table + j - 1]
            with span('portbench.step'):
                carry, obs, _, done, info = env.step(carry, act)
            clock.mark()
            steps += 1
            ep.steps = j
            if p - STACK < j <= p or j == L:
                with span('portbench.keep'):
                    if p - STACK < j <= p:
                        ep.states[j] = clone_state(carry.state, ep.rows)
                    if j == p - 1:
                        ep.pre = clone_state(carry.state)
                    if j == p:
                        ep.post = clone_state(carry.state)
                        ep.obs = obs.index_select(0, ep.rows)
                        ep.done = done.clone()
                        ep.score = info['eval_score'].clone()
                    if j == L:
                        ep.end_state = clone_state(carry.state)
                        ep.end_score = info['eval_score'].clone()
                        ep.end_done = done.clone()
            if on_step is not None:
                with span('portbench.count'):
                    on_step(ep, j, carry)
            if time.perf_counter() - start >= seconds:
                closed = True
                break
        e += 1
        if closed or (max_episodes is not None
                      and e - first_episode >= max_episodes):
            break
    marks = clock.times_ms()
    return Window(marks_ms=marks, resets=len(episodes), steps=steps,
                  batch=B, episodes=episodes)


def env_steps_per_s(w: Window) -> float:
    """Every env-step the window completed over the window's seconds,
    resets included in the time."""
    return w.batch * w.steps / w.seconds


def percentile(values, q: int) -> float:
    """The q-th percentile (Python's `statistics.quantiles`, exclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[q - 1]


def step_ms_p95(w: Window) -> float:
    """95th percentile of the intervals between consecutive marks, every
    step's and every reset's."""
    return percentile(w.intervals_ms, 95)
