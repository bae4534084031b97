"""The frozen work counters against ``chip_smoke.py``'s, on the same
states, and that they read nothing of the port."""

import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke
from magical_tpu_torch.api.batched_env import BatchedEnv
from magical_tpu_torch.core import render_kernel as rk
from portbench.reference.state import EnvState
from portbench.work import counts

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize('env_id', ['MoveToCorner-TestAll-LoRes4E-v0',
                                    'ClusterColour-TestAll-LoRes4E-v0'])
def test_counts_equal_chip_smoke(env_id):
    env = BatchedEnv(env_id, device='cpu')
    carry, _ = env.reset(3, 4)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        carry, *_ = env.step(carry, torch.randint(
            0, 18, (4,), generator=gen, dtype=torch.int32))
    st = carry.state
    ref = EnvState(**{f.name: getattr(st, f.name)
                      for f in dataclasses.fields(st)})
    assert counts.k1_work(ref) == chip_smoke.k1_work(st)
    args, ss = env._render_args(), env.static_shapes
    disp = rk.kernel_display(st, *args, static_shapes=ss)
    prog = rk.display_program(*args, ss, st.device)
    inputs = [getattr(st, f) for f, _ in rk._SCENE_FIELDS] + list(prog)
    for view in ('allo', 'ego'):
        for fidelity in ('lo', 'hi'):
            assert counts.render_work(
                counts.display(ref, *args, ss), ref, view, 96, fidelity) \
                == chip_smoke.render_work(disp, st, view, 96, fidelity,
                                          inputs)
    assert counts.bound(1e9, 1e6) == chip_smoke.bound(1e9, 1e6)


def test_counts_load_nothing_of_the_port():
    code = ('import sys; import portbench.work.counts, '
            'portbench.reference.env; '
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert 'magical_tpu_torch' not in out and "'magical_tpu'" not in out
