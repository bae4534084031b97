"""The port's copied tables, static metadata and state helpers equal
magical_tpu's, and the port imports without JAX."""

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magical_tpu import constants as JC
from magical_tpu import geometry as JG
from magical_tpu.api import names as JN
from magical_tpu.core import physics as JP
from magical_tpu.core import preproc as JPre
from magical_tpu.core import render as JR
from magical_tpu.core import state as JS
from magical_tpu.tasks import ALL_TASKS as JT
from magical_tpu_torch import constants as TC
from magical_tpu_torch import geometry as TG
from magical_tpu_torch.api import names as TN
from magical_tpu_torch.core import physics as TP
from magical_tpu_torch.core import physics_kernel as TPK
from magical_tpu_torch.core import preproc as TPre
from magical_tpu_torch.core import render as TR
from magical_tpu_torch.core import state as TS
from magical_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from magical_tpu_torch.tasks import ALL_TASKS as TT

from _torch_port import jax_demo_states, jax_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith('_') and not callable(v)
            and not isinstance(v, type(os))}


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f'{what}[{k}]')
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, enum.Enum):
        assert a.value == b.value and a.name == b.name, what
    else:
        assert a == b, what


@pytest.mark.parametrize('mods', [(JC, TC), (JG, TG)],
                         ids=['constants', 'geometry'])
def test_copied_tables_equal(mods):
    jmod, tmod = mods
    ja, ta = _public(jmod), _public(tmod)
    assert ja.keys() == ta.keys()
    for k in ja:
        _assert_same(ja[k], ta[k], k)
    for enum_name in ('ShapeType', 'ShapeColour'):
        if hasattr(jmod, enum_name):
            assert [(e.name, e.value) for e in getattr(jmod, enum_name)] == \
                [(e.name, e.value) for e in getattr(tmod, enum_name)]


@pytest.mark.parametrize('mb', [0, 1, 3, 10])
def test_slot_pair_candidate_tables_equal(mb):
    for name in ('slot_tables', 'pair_table', 'candidate_bodies'):
        ja, ta = getattr(JP, name)(mb), getattr(TP, name)(mb)
        for x, y in zip(ja, ta):
            _assert_same(x, y, f'{name}({mb})')
    assert TS.max_contacts(mb) == JS.max_contacts(mb)
    assert TS.n_joint_acc(mb) == JS.n_joint_acc(mb)


def test_static_prim_meta_and_preproc_specs_equal():
    for task in ('MoveToCorner', 'MatchRegions'):
        t = JT[task]
        for variant in ('Demo', 'TestAll'):
            ss = t.static_block_shapes(t.flags_for(variant))
            assert JR.static_prim_meta(t.max_blocks, t.max_goals, True, ss) \
                == TR.static_prim_meta(t.max_blocks, t.max_goals, True, ss)
    assert list(JPre.PREPROCESSORS) == list(TPre.PREPROCESSORS)
    for k, spec in JPre.PREPROCESSORS.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(TPre.PREPROCESSORS[k])
        assert spec.views == TPre.PREPROCESSORS[k].views
    mtc = TT['MoveToCorner']
    assert mtc.static_block_shapes(mtc.flags_for('Demo')) == \
        JT['MoveToCorner'].static_block_shapes(
            JT['MoveToCorner'].flags_for('Demo'))


@pytest.mark.parametrize('name', [
    'MoveToCorner-Demo-LoRes4E-v0', 'MoveToCorner-TestShape-v0',
    'ClusterColour-TestAll-LoResStack-v1', 'FindDupe-Demo-v0'])
def test_env_name_grammar_equal(name):
    j, t = JN.EnvName(name), TN.EnvName(name)
    for attr in ('task', 'variant', 'preproc', 'version', 'is_test',
                 'demo_env_name'):
        assert getattr(j, attr) == getattr(t, attr)
    for kw in ({'variant': 'TestAll'}, {'preproc': 'LoRes3EA'},
               {'task': 'MatchRegions', 'version': 'v1'}):
        assert JN.update_magical_env_name(name, **kw) == \
            TN.update_magical_env_name(name, **kw)


def test_initial_state_and_inverse_masses_equal():
    B = 3
    js = JS.make_initial_state(1, 1)
    ts = TS.make_initial_state(B, 1, 1, 'cpu')
    jd = jax_to_numpy(js)
    td = state_to_numpy(ts)
    for k, v in jd.items():
        assert td[k].shape == (B,) + v.shape, k
        assert td[k].dtype == v.dtype, k
        np.testing.assert_array_equal(td[k], np.broadcast_to(v, td[k].shape),
                                      err_msg=k)
    # place robot and block, then compare poses and inverse masses
    js = JS.place_block(JS.place_robot(js, (0.3, -0.2), 1.1), 0,
                        (0.1, 0.5), 0.4, int(JC.ShapeType.STAR), 2)
    ts = TS.place_robot(ts, torch.tensor([[0.3, -0.2]] * B),
                        torch.full((B,), 1.1))
    ts = TS.place_block(ts, 0, (0.1, 0.5), 0.4, int(TC.ShapeType.STAR), 2)
    for k in ('pos', 'angle'):
        # rotations round differently (XLA contracts to FMA): 1e-7 is a
        # few float32 ulps at these magnitudes
        np.testing.assert_allclose(state_to_numpy(ts)[k][0],
                                   np.asarray(getattr(js, k)), atol=1e-7)
    for k in ('block_shape', 'block_colour', 'block_active'):
        np.testing.assert_array_equal(state_to_numpy(ts)[k][0],
                                      np.asarray(getattr(js, k)))
    jm, ji = JS.inv_mass_arrays(js)
    tm, ti = TS.inv_mass_arrays(ts)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))


def test_convert_round_trip_and_float32_tables():
    """Every field of a batched JAX state, filled with arbitrary values of
    its dtype (the PRNG words above 2**31 too), survives numpy -> port ->
    numpy unchanged."""
    rng = np.random.default_rng(3)
    d = {}
    for k, v in jax_to_numpy(jax_demo_states(4)).items():
        if v.dtype == bool:
            d[k] = rng.random(v.shape) < 0.5
        elif v.dtype.kind == 'f':
            d[k] = rng.standard_normal(v.shape).astype(v.dtype)
        else:
            d[k] = rng.integers(0, np.iinfo(v.dtype).max, v.shape,
                                dtype=v.dtype)
    back = state_to_numpy(state_from_numpy(d, 'cpu'))
    assert d.keys() == back.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert d['rng'].dtype == np.uint32 and (d['rng'] >= 2 ** 31).any()
    # the geometry tables are float64 before their final cast; the port's
    # tensors of them must be float32
    assert TS.f32(TG.BLOCK_VERTS, 'cpu').dtype == torch.float32
    ftab, itab, _ = TPK.table_arrays(1)
    assert ftab.dtype == np.float32 and itab.dtype == np.int32


def test_kernel_tables_hold_the_plain_tables():
    ftab, itab, (cand_fr_at, n_scalars, slot_body_at) = TPK.table_arrays(1)
    _, _, fr = TP.candidate_bodies(1)
    np.testing.assert_array_equal(ftab[cand_fr_at:], fr)
    body, _ = TP.slot_tables(1)
    np.testing.assert_array_equal(itab[slot_body_at:slot_body_at + len(body)],
                                  body)
    assert ftab[0:18].tolist() == TC.ACTION_TARGET_SPEED.tolist()


def test_port_imports_without_jax():
    code = (
        'import sys, pkgutil, importlib\n'
        'import magical_tpu_torch\n'
        'for m in pkgutil.walk_packages(magical_tpu_torch.__path__, '
        '"magical_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "magical_tpu" or m.startswith("magical_tpu.")]\n'
        'print("BAD", bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
