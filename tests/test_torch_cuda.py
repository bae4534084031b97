"""The port's CUDA kernels on the card, against their plain PyTorch
versions: ragged batch sizes, the wrappers' input checks, the ring-slot
write and the whole slice on CUDA against the same slice on the CPU.

Marked `cuda`; every test skips without a CUDA card.  On a machine with
one:  python -m pytest -m cuda tests/test_torch_cuda.py -q
(chip_smoke.py holds the same kernels at the main path's shapes).
"""

import pytest
import torch

from magical_tpu_torch import constants as C
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.core import (physics, physics_kernel, preproc, render,
                                    render_kernel)
from magical_tpu_torch.core.state import make_initial_state

pytestmark = pytest.mark.cuda

NAME = 'MoveToCorner-Demo-LoRes4E-v0'
# Built without FMA contraction, the kernels round like their plain
# versions; the control step still differs where the plain version's
# per-body impulse sums (scatter_add_ with atomics on CUDA) add in another
# order, which the solver grows in its chaotic envs: the median env agrees
# to 1e-6.  Frames: within 1 uint8 level.
STEP_MEDIAN_ATOL = 1e-6
MAX_LEVELS = 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels run only there')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _states(batch, n_steps, cuda):
    env = BatchedEnv(NAME, device=cuda)
    carry, _ = env.reset(0, batch)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(n_steps):
        act = torch.randint(0, 18, (batch,), generator=gen, device=cuda,
                            dtype=torch.int32)
        carry, *_ = env.step(carry, act)
    act = torch.randint(0, 18, (batch,), generator=gen, device=cuda,
                        dtype=torch.int32)
    return env, carry.state.clone(), act


@pytest.mark.parametrize('batch', [1, 129, 300])
def test_control_step_kernel_any_batch(cuda, batch):
    _, st, act = _states(batch, 6, cuda)
    sp = physics.control_step(st, act)
    sk = st.clone()
    n = physics_kernel.control_step.launches
    out = physics_kernel.control_step(sk, act)
    torch.cuda.synchronize()
    assert out is sk and physics_kernel.control_step.launches == n + 1
    for f in ('pos', 'angle', 'vel', 'omega', 'con_jn', 'con_jt',
              'joint_acc'):
        err = (getattr(sk, f) - getattr(sp, f)).abs().reshape(batch, -1) \
            .amax(1)
        assert float(err.median()) <= STEP_MEDIAN_ATOL, f
    assert torch.equal(sk.con_id, sp.con_id)
    assert torch.equal(sk.t, sp.t)


def test_control_step_kernel_rejects_what_it_does_not_take(cuda):
    _, st, act = _states(4, 0, cuda)
    with pytest.raises(TypeError):
        physics_kernel.control_step(st, act.long())
    with pytest.raises(ValueError):
        physics_kernel.control_step(st, act.cpu())
    with pytest.raises(ValueError):
        physics_kernel.control_step(st, torch.stack([act, act], 1)[:, 0])
    with pytest.raises(NotImplementedError):
        physics_kernel.control_step(make_initial_state(4, 2, 1, cuda), act)


@pytest.mark.parametrize('batch', [1, 5, 300])
@pytest.mark.parametrize('view', ['allo', 'ego'])
def test_render_kernels_any_batch(cuda, batch, view):
    env, st, _ = _states(batch, 3, cuda)
    args = (env.task.max_blocks, env.task.max_goals, env.robot_first)
    plain = render.render_views(st, *args, views=(view,), fidelity='lo',
                                static_shapes=env.static_shapes)[view]
    fresh = render_kernel.render_views_lo(
        st, *args, views=(view,), static_shapes=env.static_shapes)[view]
    spec = preproc.PreprocSpec(None, **{f'{view}_frames': 4})
    ring = torch.full((4, batch, 96, 96, 3), 7, dtype=torch.uint8,
                      device=cuda)
    render_kernel.render_into_slots(st, {view: ring}, 6, *args, spec,
                                    static_shapes=env.static_shapes)
    torch.cuda.synchronize()
    assert bool((ring[[0, 1, 3]] == 7).all())          # slot 6 mod 4 only
    for got in (fresh, ring[2]):
        d = (got.int() - plain.int()).abs()
        assert int(d.max()) <= MAX_LEVELS


def test_slice_on_cuda_matches_the_slice_on_the_cpu(cuda):
    # actions that keep 8 steps free of contacts, where the two paths
    # agree to rounding (tests/test_torch_env.py)
    acts = torch.tensor([C.ACTION_NAMES.index(a) for a in (
        'UpOpen', 'RightOpen', 'LeftClose', 'DownClose')], dtype=torch.int32)
    envs = {d: BatchedEnv(NAME, device=d) for d in ('cpu', cuda)}
    out = {d: e.reset(0, 4) for d, e in envs.items()}
    for _ in range(8):
        out = {d: envs[d].step(out[d][0], acts.to(d)) for d in out}
    (cc, co, *_), (gc, go, *_) = out['cpu'], out[cuda]
    d = (go.cpu().int() - co.int()).abs()
    assert int(d.max()) <= MAX_LEVELS and float((d > 0).float().mean()) \
        <= 1e-3
    torch.testing.assert_close(gc.state.pos.cpu(), cc.state.pos, rtol=0,
                               atol=1e-4)
    assert gc.t == cc.t == 8
