"""magical_tpu_torch's demo IO, offline preprocessing, checkpoints,
reference-demo extraction, evaluation protocol and package facade, held
against magical_tpu's data and eval modules on the same inputs (the cases
of tests/test_data_eval.py on the port)."""

import gzip
import io
import os
import pickle
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import torch

from magical_tpu.core import preproc as JPP
from magical_tpu.data import trajectories as JT
from magical_tpu.eval import protocol as JE
from magical_tpu_torch.core import preproc as TPP
from magical_tpu_torch.data import checkpoint as CK
from magical_tpu_torch.data import reference_demos as RD
from magical_tpu_torch.data import trajectories as T
from magical_tpu_torch.eval import protocol as E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREPROCS = [('LoRes4E', (8, 8, 12), 'array'),
            ('LoRes3EA', (8, 8, 12), 'array'),
            ('LoRes4A', (8, 8, 12), 'array'),
            ('LoResCHW4E', (12, 8, 8), 'array'),
            ('LoResStack', (8, 8, 12), 'dict')]


def _fake_traj(cls, T_steps=5, res=8, seed=None):
    """A trajectory of (4 res)² frames: constant per step, or random with
    `seed`."""
    rng = None if seed is None else np.random.RandomState(seed)

    def frame(v):
        if rng is not None:
            return rng.randint(0, 256, (res * 4, res * 4, 3)).astype(np.uint8)
        return np.full((res * 4, res * 4, 3), v, np.uint8)
    obs = [{'allo': frame(t * 10), 'ego': frame(t * 10 + 1)}
           for t in range(T_steps + 1)]
    return cls(acts=np.arange(T_steps, dtype=np.int64), obs=obs,
               rews=np.zeros(T_steps), infos=[{} for _ in range(T_steps)])


# ---------------------------------------------------------------------------
# Demo IO
# ---------------------------------------------------------------------------

def test_demo_save_load_roundtrip(tmp_path):
    traj = _fake_traj(T.MAGICALTrajectory)
    path = os.path.join(tmp_path, 'demo-Test-0.pkl.gz')
    T.save_demo(path, 'MoveToCorner-Demo-v0', traj, 0.5)
    (loaded,) = list(T.load_demos([path]))
    assert loaded['env_name'] == 'MoveToCorner-Demo-v0'
    assert loaded['score'] == 0.5
    assert isinstance(loaded['trajectory'], T.MAGICALTrajectory)
    np.testing.assert_array_equal(loaded['trajectory'].acts, traj.acts)


@pytest.mark.parametrize('module', ['magical.saved_trajectories',
                                    'milbench.baselines.saved_trajectories',
                                    'magical_tpu.data.trajectories'])
def test_unpickler_rewrites_foreign_classes(tmp_path, module):
    """A pickle that names another package's trajectory class loads as
    the port's (protocol-0 pickles carry module paths as plain text)."""
    traj = _fake_traj(T.MAGICALTrajectory, 2, 2)
    name = b'MILBenchTrajectory' if module.startswith('milbench') \
        else b'MAGICALTrajectory'
    raw0 = pickle.dumps({'env_name': 'E-Demo-v0', 'trajectory': traj,
                         'score': 1.0}, protocol=0)
    patched = raw0.replace(b'magical_tpu_torch.data.trajectories',
                           module.encode())
    patched = patched.replace(b'\nMAGICALTrajectory\n', b'\n' + name + b'\n')
    assert module.encode() in patched
    path = os.path.join(tmp_path, 'ref.pkl.gz')
    with gzip.GzipFile(path, 'wb') as f:
        f.write(patched)
    (loaded,) = list(T.load_demos([path]))
    assert isinstance(loaded['trajectory'], T.MAGICALTrajectory)


def test_splice_in_preproc_name():
    assert T.splice_in_preproc_name('MoveToCorner-Demo-v0', 'LoRes4E') == \
        JT.splice_in_preproc_name('MoveToCorner-Demo-v0', 'LoRes4E') == \
        'MoveToCorner-Demo-LoRes4E-v0'
    with pytest.raises(AssertionError):
        T.splice_in_preproc_name('MoveToCorner-Demo-v0', 'HiRes')


def test_resize_area_matches_box_mean():
    img = (np.arange(16 * 16 * 3) % 251).reshape(16, 16, 3).astype(np.uint8)
    out = T._resize_area(img, 4)
    manual = np.floor(
        img.reshape(4, 4, 4, 4, 3).astype(np.float64).mean((1, 3)) + 0.5)
    np.testing.assert_array_equal(out, manual.astype(np.uint8))
    np.testing.assert_array_equal(out, JT._resize_area(img, 4))


@pytest.fixture
def res8():
    """Both packages' preprocessor specs at res 8 (the fake frames are 32²)
    for the test, 96 again after it."""
    specs = list(JPP.PREPROCESSORS.values()) + list(TPP.PREPROCESSORS.values())
    for spec in specs:
        object.__setattr__(spec, 'res', 8)      # frozen dataclass override
    yield
    for spec in specs:
        object.__setattr__(spec, 'res', 96)


@pytest.mark.parametrize('preproc,shape,kind', PREPROCS)
def test_preprocess_demos(res8, preproc, shape, kind):
    traj = _fake_traj(T.MAGICALTrajectory, T_steps=5, res=8)
    (out,) = T.preprocess_demos_with_wrapper([traj], 'E-Demo-v0',
                                             preproc_name=preproc)
    if kind == 'array':
        assert out.obs.shape == (6,) + shape
        # reset padding: first obs has all frames equal
        first = out.obs[0]
        if preproc == 'LoResCHW4E':
            np.testing.assert_array_equal(first[:3], first[9:])
        elif preproc == 'LoRes3EA':
            np.testing.assert_array_equal(first[..., 3:6], first[..., 9:12])
        else:
            np.testing.assert_array_equal(first[..., :3], first[..., 9:])
    else:
        assert out.obs['allo'].shape == (6,) + shape
        assert out.obs['ego'].shape == (6,) + shape
    np.testing.assert_array_equal(out.acts, traj.acts)


@pytest.mark.parametrize('preproc', [p for p, _, _ in PREPROCS])
def test_preprocessed_obs_equal_the_jax_packages(res8, preproc):
    """Random frames through both packages' preprocess_demos_with_wrapper:
    the same bytes."""
    tt = _fake_traj(T.MAGICALTrajectory, T_steps=6, seed=1)
    jt = _fake_traj(JT.MAGICALTrajectory, T_steps=6, seed=1)
    (got,) = T.preprocess_demos_with_wrapper([tt], 'E-Demo-v0',
                                             preproc_name=preproc)
    (want,) = JT.preprocess_demos_with_wrapper([jt], 'E-Demo-v0',
                                               preproc_name=preproc)
    if isinstance(want.obs, dict):
        assert set(got.obs) == set(want.obs)
        for k in want.obs:
            np.testing.assert_array_equal(got.obs[k], want.obs[k])
    else:
        assert got.obs.dtype == want.obs.dtype == np.uint8
        np.testing.assert_array_equal(got.obs, want.obs)


_NO_JAX = textwrap.dedent('''
    import sys

    class _Refuse:
        """Importing jax or magical_tpu raises."""
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'jaxlib', 'magical_tpu'):
                raise ImportError(f'{name} is not importable here')
            return None

    sys.meta_path.insert(0, _Refuse())
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    from magical_tpu_torch.data import trajectories as T
    try:
        import magical_tpu  # noqa: F401
    except ImportError:
        pass
    else:
        raise SystemExit('magical_tpu imported')
    (demo,) = T.load_demos([sys.argv[2]])
    assert type(demo['trajectory']) is T.MAGICALTrajectory
    outs = {}
    for name in ('LoRes4E', 'LoRes3EA', 'LoRes4A', 'LoResCHW4E',
                 'LoResStack'):
        (o,) = T.preprocess_demos_with_wrapper([demo['trajectory']],
                                               demo['env_name'],
                                               preproc_name=name)
        if isinstance(o.obs, dict):
            outs.update({f'{name}/{k}': v for k, v in o.obs.items()})
        else:
            outs[name] = o.obs
    np.savez(sys.argv[3], score=demo['score'], acts=demo['trajectory'].acts,
             **outs)
    assert not any(m.split('.')[0] in ('jax', 'magical_tpu')
                   for m in sys.modules)
''')


def test_a_jax_written_demo_loads_without_jax(tmp_path):
    """A demo saved by magical_tpu's save_demo, with 384² frames, loads
    through the port in a process where importing jax or magical_tpu
    raises; its preprocessed obs equal magical_tpu's byte for byte for
    the 5 preprocessors."""
    traj = _fake_traj(JT.MAGICALTrajectory, T_steps=3, res=96, seed=2)
    demo = os.path.join(tmp_path, 'demo-MoveToRegion-Demo-v0-0.pkl.gz')
    JT.save_demo(demo, 'MoveToRegion-Demo-v0', traj, 1.0)
    out = os.path.join(tmp_path, 'obs.npz')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    subprocess.run([sys.executable, '-c', _NO_JAX, REPO, demo, out],
                   check=True, env=env, timeout=120)
    got = np.load(out)
    assert float(got['score']) == 1.0
    np.testing.assert_array_equal(got['acts'], traj.acts)
    for name in JPP.PREPROCESSORS:
        (want,) = JT.preprocess_demos_with_wrapper(
            [traj], 'MoveToRegion-Demo-v0', preproc_name=name)
        if isinstance(want.obs, dict):
            for k, v in want.obs.items():
                np.testing.assert_array_equal(got[f'{name}/{k}'], v)
        else:
            np.testing.assert_array_equal(got[name], want.obs)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_env_carry_checkpoint_restores_mid_episode(tmp_path):
    """An EnvCarry saved after 3 steps, restored, steps to the same obs,
    state and step count as the original."""
    from magical_tpu_torch.api.batched_env import BatchedEnv
    env = BatchedEnv('MoveToRegion-TestAll-LoRes3EA-v0', device='cpu')
    carry, obs = env.reset(3, 2)
    acts = torch.tensor([[1, 10], [4, 4], [7, 2], [3, 16]], dtype=torch.int32)
    for a in acts[:3]:
        carry, obs, *_ = env.step(carry, a)
    path = CK.save_pytree(os.path.join(tmp_path, 'ckpt', 'carry'), carry)
    assert path.endswith('.npz') and os.path.isfile(path)
    back = CK.load_pytree(path, device='cpu')
    assert back.t == carry.t == 3 and set(back.frames) == set(carry.frames)
    c1, o1, *_ = env.step(carry, acts[3])
    c2, o2, *_ = env.step(back, acts[3])
    assert torch.equal(o1, o2)
    for f in ('pos', 'angle', 'vel', 'con_id', 'con_jn', 'joint_acc', 't',
              'rng', 'goal_active'):
        assert torch.equal(getattr(c1.state, f), getattr(c2.state, f)), f


def test_state_and_dict_checkpoints(tmp_path):
    from magical_tpu_torch.api.batched_env import BatchedEnv
    env = BatchedEnv('FindDupe-TestAll-LoRes4E-v0', device='cpu')
    carry, _ = env.reset(0, 2)
    path = CK.save_pytree(tmp_path / 'state.npz', carry.state)
    back = CK.load_pytree(tmp_path / 'state', device='cpu')
    for f, v in vars(carry.state).items():
        assert torch.equal(getattr(back, f), v), f
    tensors = {'w': torch.arange(6.0).reshape(2, 3),
               'mask': torch.tensor([True, False])}
    back = CK.load_pytree(CK.save_pytree(tmp_path / 'd', tensors),
                          device='cpu')
    assert set(back) == set(tensors)
    assert all(torch.equal(back[k], v) for k, v in tensors.items())
    with pytest.raises(TypeError):
        CK.save_pytree(tmp_path / 'x', [1, 2])
    assert path.endswith('state.npz')


# ---------------------------------------------------------------------------
# Reference demos: the extraction, on an archive built here
# ---------------------------------------------------------------------------

def _archive(members):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, 'w') as zf:
        for name, data in members.items():
            zf.writestr(name, data)
    return buf.getvalue()


def test_extract_demos_strips_the_top_directory(tmp_path):
    data = _archive({'magical-data-master/README.md': b'demos',
                     'magical-data-master/demos/move-to-corner/'
                     'demo-0.pkl.gz': b'\x1f\x8b'})
    dest = str(tmp_path / 'demos')
    assert RD.extract_demos(data, dest) == dest
    assert open(os.path.join(dest, 'README.md'), 'rb').read() == b'demos'
    assert os.path.isfile(os.path.join(dest, 'demos', 'move-to-corner',
                                       'demo-0.pkl.gz'))
    assert os.path.isfile(os.path.join(dest, RD.DONE_MARKER))
    # from a path, too
    zpath = tmp_path / 'master.zip'
    zpath.write_bytes(data)
    RD.extract_demos(str(zpath), str(tmp_path / 'again'))
    assert os.path.isfile(tmp_path / 'again' / 'README.md')
    # an extracted tree is not fetched again (no network is touched)
    assert RD.try_download_demos(dest, progress=False) == dest


def test_extract_demos_refuses_members_outside_dest(tmp_path):
    data = _archive({'top/../../escape.txt': b'x'})
    with pytest.raises(ValueError):
        RD.extract_demos(data, str(tmp_path / 'demos'))
    assert not (tmp_path / 'escape.txt').exists()


# ---------------------------------------------------------------------------
# The evaluation protocol
# ---------------------------------------------------------------------------

def test_tconfint_matches_t_table_and_the_jax_packages():
    scores = [0.0, 1.0, 0.5, 0.5, 0.5]
    lo, hi = E.tconfint_mean(scores, 0.05)
    sem = np.std(scores, ddof=1) / np.sqrt(5)
    assert lo == pytest.approx(np.mean(scores) - 2.7764451052 * sem, abs=1e-6)
    assert hi == pytest.approx(np.mean(scores) + 2.7764451052 * sem, abs=1e-6)
    assert (lo, hi) == JE.tconfint_mean(scores, 0.05)
    rng = np.random.RandomState(0)
    for n in (2, 7, 1024):
        s = rng.uniform(0, 1, n)
        assert E.tconfint_mean(s) == JE.tconfint_mean(s)
    lo1, hi1 = E.tconfint_mean([0.3])
    assert np.isnan(lo1) and np.isnan(hi1)


@pytest.mark.parametrize('df', [1, 4, 5, 29, 1023])
def test_t_ppf_equals_scipy_and_the_jax_packages(df):
    from scipy import stats
    for q in (0.9, 0.975, 0.995):
        got = E._t_ppf(q, df)
        assert got == JE._t_ppf(q, df)
        assert abs(got - stats.t.ppf(q, df)) < 1e-8
    for a, b, x in ((2.0, 0.5, 0.3), (0.5, 0.5, 0.9), (10.0, 0.5, 0.99)):
        assert E._betainc(a, b, x) == JE._betainc(a, b, x)
        assert abs(E._betainc(a, b, x) - stats.beta.cdf(x, a, b)) < 1e-10


class _FakeEval(E.EvaluationProtocol):
    run_id = 'fake-algo'

    def obtain_scores(self, env_name):
        rng = np.random.RandomState(sum(map(ord, env_name)) % 1000)
        return rng.uniform(0, 1, size=self.n_rollouts).tolist()


def _check_frame(rows, demo):
    from magical_tpu_torch.api.registry import DEMO_ENVS_TO_TEST_ENVS_MAP
    assert [r['test_env'] for r in rows] == \
        [demo, *DEMO_ENVS_TO_TEST_ENVS_MAP[demo]]
    assert all(r['demo_env'] == demo for r in rows)
    assert all(r['ci95_lower'] <= r['mean_score'] <= r['ci95_upper']
               for r in rows)


def test_evaluation_protocol_returns_a_dataframe():
    pd = pytest.importorskip('pandas')
    ev = _FakeEval(demo_env_name='MoveToCorner-Demo-LoRes4E-v0',
                   n_rollouts=6)
    frame = ev.do_eval()
    assert isinstance(frame, pd.DataFrame) and len(frame) == 6
    _check_frame(frame.to_dict('records'), 'MoveToCorner-Demo-LoRes4E-v0')
    tex = E.latexify_results(frame)
    assert 'tabular' in tex and 'fake-algo' in tex


def test_evaluation_protocol_without_pandas(monkeypatch):
    """Where pandas is not importable (as on a machine without it), do_eval
    returns the list of rows, and latexify_results takes it."""
    monkeypatch.setitem(sys.modules, 'pandas', None)
    ev = _FakeEval(demo_env_name='ClusterColour-Demo-LoRes4E-v0',
                   n_rollouts=5)
    rows = ev.do_eval(verbose=True)
    assert isinstance(rows, list) and len(rows) == 8
    _check_frame(rows, 'ClusterColour-Demo-LoRes4E-v0')
    tex = E.latexify_results(rows)
    assert tex.count(r'\begin{tabular}') == 1 and 'fake-algo' in tex
    assert tex.strip().splitlines()[-1] == r'\end{tabular}'


def test_protocol_refuses_too_few_scores():
    class Short(_FakeEval):
        def obtain_scores(self, env_name):
            return [0.5]
    with pytest.raises(ValueError):
        Short(demo_env_name='MoveToCorner-Demo-v0', n_rollouts=3).do_eval()


def _multi_rows():
    rows = []
    for run_id in ('algo-a', 'algo-b', 'algo-c'):
        for env in ('Env1-v0', 'Env2-v0'):
            rows.append(dict(demo_env='Env1-v0', test_env=env,
                             mean_score=0.5, ci95_lower=0.4,
                             ci95_upper=0.6, std_score=0.1, run_id=run_id))
    return rows


@pytest.mark.parametrize('as_frame', [True, False])
def test_latexify_multi_run_well_formed(as_frame):
    rows = _multi_rows()
    if as_frame:
        pd = pytest.importorskip('pandas')
        data, dup = (pd.DataFrame.from_records(rows),
                     pd.DataFrame.from_records(rows + rows[:1]))
        assert E.latexify_results(data) == JE.latexify_results(data)
    else:
        data, dup = rows, rows + rows[:1]
    tex = E.latexify_results(data)
    assert tex.count(r'\bottomrule') == 1
    assert tex.count(r'\end{tabular}') == 1
    assert tex.count(r'\begin{tabular}') == 1
    lines = tex.strip().splitlines()
    assert lines[-1] == r'\end{tabular}'
    assert lines[-2] == r'\bottomrule'
    body = [ln for ln in lines if ln.startswith(r'\textbf{algo')]
    assert [ln.split('}')[0] for ln in body] == [
        r'\textbf{algo-a', r'\textbf{algo-b', r'\textbf{algo-c']
    assert all(ln.endswith(r'\\') for ln in body)
    with pytest.raises(ValueError):
        E.latexify_results(dup)


def test_latexify_rows_equal_the_frames_table():
    pd = pytest.importorskip('pandas')
    rows = _multi_rows()
    rows[3]['mean_score'] = 0.25
    assert E.latexify_results(rows) == \
        JE.latexify_results(pd.DataFrame.from_records(rows))


# ---------------------------------------------------------------------------
# tools/convert_demos
# ---------------------------------------------------------------------------

def test_convert_demos_multidiscrete_to_flat(tmp_path):
    from magical_tpu.tools import convert_demos as JCD
    from magical_tpu_torch import constants as C
    from magical_tpu_torch.tools import convert_demos as CD
    old = np.array([[0, 0, 0], [1, 0, 0], [2, 2, 1], [0, 1, 1]], np.int64)
    flat = CD.convert_acts(old)
    np.testing.assert_array_equal(flat, [0, 1, 17, 12])
    np.testing.assert_array_equal(flat, JCD.convert_acts(old))
    for (ud, lr, gr), aid in zip(old, flat):
        up, dn, lf, rt, op, cl = C.ACTION_TABLE[aid]
        assert (up, dn) == ((ud == 1), (ud == 2))
        assert (lf, rt) == ((lr == 1), (lr == 2))
        assert (op, cl) == ((gr == 0), (gr == 1))

    src = tmp_path / 'src' / 'sub'
    src.mkdir(parents=True)
    traj = _fake_traj(T.MAGICALTrajectory, T_steps=4)._replace(acts=old)
    T.save_demo(str(src / 'demo-X-0.pkl.gz'), 'MoveToCorner-Demo-v0',
                traj, 1.0)
    out = CD.convert_tree(str(tmp_path / 'src'), str(tmp_path / 'dst'),
                          verbose=False)
    assert out == [str(tmp_path / 'dst' / 'sub' / 'demo-X-0.pkl.gz')]
    (loaded,) = list(T.load_demos(out))
    np.testing.assert_array_equal(loaded['trajectory'].acts, [0, 1, 17, 12])
    assert loaded['trajectory'].acts.dtype == np.int32


# ---------------------------------------------------------------------------
# The package facade
# ---------------------------------------------------------------------------

FACADE = ('make', 'register_envs', 'ALL_REGISTERED_ENVS',
          'DEMO_ENVS_TO_TEST_ENVS_MAP', 'AVAILABLE_PREPROCESSORS',
          'load_demos', 'preprocess_demos_with_wrapper',
          'splice_in_preproc_name', 'MAGICALTrajectory', 'try_download_demos')


def test_facade_names_resolve_like_the_jax_packages():
    import magical_tpu
    import magical_tpu_torch as M
    for name in FACADE:
        assert hasattr(magical_tpu, name), name
        getattr(M, name)
    assert M.load_demos is T.load_demos
    assert M.try_download_demos is RD.try_download_demos
    assert M.AVAILABLE_PREPROCESSORS == magical_tpu.AVAILABLE_PREPROCESSORS
    M.register_envs()
    magical_tpu.register_envs()
    assert M.ALL_REGISTERED_ENVS == magical_tpu.ALL_REGISTERED_ENVS
    assert dict(M.DEMO_ENVS_TO_TEST_ENVS_MAP) == \
        dict(magical_tpu.DEMO_ENVS_TO_TEST_ENVS_MAP)
    env = M.make('MoveToCorner-Demo-LoRes4E-v0', batched=True, device='cpu')
    assert env.max_episode_steps == 80
    with pytest.raises(AttributeError):
        M.no_such_name
    assert set(FACADE) <= set(dir(M))


def test_import_is_light():
    """`import magical_tpu_torch` imports neither torch nor JAX; the
    facade's first use brings torch, never JAX."""
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'import magical_tpu_torch as M; '
            'assert "torch" not in sys.modules; '
            'M.MAGICALTrajectory; '
            'assert "torch" in sys.modules; '
            'assert not any(m.split(".")[0] in ("jax", "magical_tpu") '
            'for m in sys.modules)')
    subprocess.run([sys.executable, '-c', code, REPO], check=True,
                   timeout=120)
