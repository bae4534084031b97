"""magical_tpu_torch's CLI (``python -m magical_tpu_torch``) and tools
(render_demos, re_record_demos, web_viewer), on the CPU, held against the
JAX package's where it has the same function: the PNG encoder, the ANSI
preview, the PPM writer, the teleop action table and the demo frames are
byte-equal to JAX's; a demo the port's CLI records is read back by JAX's
loader; on a scripted policy the port's CLI records the demo JAX's CLI
recorded (tests/fixtures/torch_jax_demo.pkl.gz, written by
tests/_torch_tools_fixture.py); the port re-records its own demo and
JAX's; the viewer serves its page, frames and state on a loopback port.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import urllib.request
import zlib

import numpy as np
import pytest

from magical_tpu.__main__ import (_ansi_preview as jax_ansi_preview,
                                  _teleop_action as jax_teleop_action,
                                  _write_ppm as jax_write_ppm)
from magical_tpu.data import trajectories as JT
from magical_tpu.tools import render_demos as JRD
from magical_tpu.tools.web_viewer import encode_png as jax_encode_png
from magical_tpu_torch import constants as C
from magical_tpu_torch.__main__ import _ansi_preview, _teleop_action, \
    _write_ppm
from magical_tpu_torch.data import trajectories as T
from magical_tpu_torch.tools import render_demos as RD
from magical_tpu_torch.tools import web_viewer as WV
from magical_tpu_torch.tools.re_record_demos import re_record

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX_DEMO = os.path.join(HERE, 'fixtures', 'torch_jax_demo.pkl.gz')
ENV = 'MoveToRegion-Demo-LoRes4E-v0'
# tests/test_torch_env.py's lo render tolerance against the JAX package:
# at most 1 uint8 level in every frame, on at most 0.1% of the episode's
# values
LO_MAX_LEVELS = 1
LO_MAX_SHARE = 1e-3


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _cli_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, HERE, os.environ.get('PYTHONPATH', '')]), OMP_NUM_THREADS='1')


def _cli(*args, **kw):
    return subprocess.run([sys.executable, '-m', 'magical_tpu_torch',
                           '--device', 'cpu', *args], env=_cli_env(),
                          capture_output=True, timeout=600, cwd=REPO, **kw)


def _decode_png(png):
    """(width, height, pixels) of an 8-bit RGB PNG of one IDAT chunk."""
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    n, tag = struct.unpack('>I4s', png[8:16])
    assert tag == b'IHDR'
    w, h, depth, colour = struct.unpack('>IIBB', png[16:26])
    assert (depth, colour) == (8, 2)
    i = 8 + 12 + n
    n, tag = struct.unpack('>I4s', png[i:i + 8])
    assert tag == b'IDAT'
    raw = zlib.decompress(png[i + 8:i + 8 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return w, h, rows[:, 1:].reshape(h, w, 3)


# ---------------------------------------------------------------------------
# byte-equal to JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(8, 8, 3), (96, 96, 3), (37, 53, 3)])
def test_encode_png_is_jaxs(shape):
    rgb = _frames(1, shape)
    png = WV.encode_png(rgb)
    assert png == jax_encode_png(rgb)
    w, h, pix = _decode_png(png)
    assert (h, w) == shape[:2] and np.array_equal(pix, rgb)


def test_ansi_preview_and_ppm_are_jaxs(tmp_path):
    for seed, shape in ((2, (96, 96, 3)), (3, (384, 384, 3))):
        frame = _frames(seed, shape)
        assert _ansi_preview(frame) == jax_ansi_preview(frame)
        assert _ansi_preview(frame, 20) == jax_ansi_preview(frame, 20)
        _write_ppm(tmp_path / 'a.ppm', frame)
        jax_write_ppm(tmp_path / 'b.ppm', frame)
        assert (tmp_path / 'a.ppm').read_bytes() == \
            (tmp_path / 'b.ppm').read_bytes()


def test_teleop_action_table_is_jaxs():
    for ch in map(chr, range(32, 127)):
        assert _teleop_action(ch) == jax_teleop_action(ch), ch


def _demo(obs):
    return {'env_name': ENV, 'score': 0.0, 'trajectory': T.MAGICALTrajectory(
        acts=np.zeros(2, np.int32), obs=obs, rews=np.zeros(2), infos=None)}


@pytest.mark.parametrize('kind', ['dict', 'ego_only', 'stack', 'rgb'])
def test_frames_from_demo_are_jaxs(kind, tmp_path):
    obs = {'dict': {'ego': _frames(4, (3, 8, 8, 3)),
                    'allo': _frames(5, (3, 8, 8, 3))},
           'ego_only': {'ego': _frames(6, (3, 8, 8, 3))},
           'stack': _frames(7, (3, 8, 8, 12)),
           'rgb': _frames(8, (3, 8, 8, 3))}[kind]
    got, want = RD.frames_from_demo(_demo(obs)), JRD.frames_from_demo(
        _demo(obs))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.shape == want.shape == (3, 8, 8, 3)
    # without ffmpeg both write the same PPM frames
    a = RD.write_video(got, str(tmp_path / 'a.mp4'))
    b = JRD.write_video(want, str(tmp_path / 'b.mp4'))
    if a.endswith('.mp4'):
        pytest.skip('ffmpeg is present: both wrote videos')
    for i in range(3):
        assert open(os.path.join(a, f'{i:05d}.ppm'), 'rb').read() == \
            open(os.path.join(b, f'{i:05d}.ppm'), 'rb').read()


def test_frames_from_demo_takes_per_step_observations():
    """re_record_demos writes a list of per-step observations; the frames
    are those of the same observations stacked."""
    steps = [{'allo': _frames(9 + t, (8, 8, 3)),
              'ego': _frames(20 + t, (8, 8, 3))} for t in range(3)]
    got = RD.frames_from_demo(_demo(steps))
    assert np.array_equal(got, np.stack([o['allo'] for o in steps]))
    stacks = [_frames(30 + t, (8, 8, 12)) for t in range(3)]
    assert np.array_equal(RD.frames_from_demo(_demo(stacks)),
                          np.stack(stacks)[..., -3:])


# ---------------------------------------------------------------------------
# the CLI, the tools
# ---------------------------------------------------------------------------

def _record(tmp_path_factory, policy):
    out = tmp_path_factory.mktemp('cli')
    r = _cli('--env-name', ENV, '--policy', policy, '--episodes', '1',
             '--seed', '0', '--record', str(out))
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    (name,) = os.listdir(out)
    return str(out / name), r.stdout.decode()


@pytest.fixture(scope='module')
def cli_demo(tmp_path_factory):
    """The port's CLI: one random episode of ENV from seed 0, recorded."""
    return _record(tmp_path_factory, 'random')


def _assert_lo_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= LO_MAX_LEVELS, d.reshape(len(d), -1).max(1)
    assert (d > 0).mean() <= LO_MAX_SHARE


def test_cli_random_demo_reads_back_in_jax(cli_demo):
    """The demo of `--policy random`: JAX's loader reads it, its actions
    are numpy's RandomState(seed) draws as in JAX's CLI, and its
    observations are the episode's (reset first)."""
    path, stdout = cli_demo
    assert 'episode 0: len 40 score' in stdout and 'saved' in stdout
    (got,) = list(JT.load_demos([path]))
    (jax_demo,) = list(JT.load_demos([JAX_DEMO]))
    assert got['env_name'] == ENV and got['score'] in (0.0, 1.0)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(got['trajectory'].acts,
                                  [rng.randint(18) for _ in range(40)])
    obs = got['trajectory'].obs
    assert obs.shape == (41, 96, 96, 12) and obs.dtype == np.uint8
    assert obs[0].tobytes() == jax_demo['trajectory'].obs[0].tobytes()


def test_cli_matches_jaxs_cli(tmp_path_factory):
    """The port's CLI and JAX's on the same scripted policy
    (tests/_torch_tools_fixture.py): equal actions and score, the reset
    observation byte-equal, every frame within the lo tolerance."""
    path, _ = _record(tmp_path_factory, '_torch_tools_fixture:scripted')
    (got,) = list(JT.load_demos([path]))
    (want,) = list(JT.load_demos([JAX_DEMO]))
    tg, tw = got['trajectory'], want['trajectory']
    np.testing.assert_array_equal(tg.acts, tw.acts)
    assert got['score'] == want['score'] == 1.0
    assert tg.obs.shape == tw.obs.shape == (41, 96, 96, 12)
    assert tg.obs[0].tobytes() == tw.obs[0].tobytes()
    _assert_lo_close(tg.obs, tw.obs)


def test_teleop_reads_stdin_and_quits():
    r = _cli('--env-name', ENV, '--teleop', input=b'wwdkq')
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    out = r.stdout.decode()
    assert out.count('WASD move') == 5 and '\x1b[38;2;' in out


def test_re_record_round_trip_on_the_port(cli_demo, tmp_path):
    """tests/test_data_eval.py's re-record round trip, on the port: the
    Demo reset is deterministic, so the score comes back."""
    path, _ = cli_demo
    (src,) = list(T.load_demos([path]))
    (out,) = re_record(ENV, [path], str(tmp_path), fidelity='lo',
                       verbose=False, device='cpu')
    (loaded,) = list(T.load_demos([out]))
    np.testing.assert_array_equal(loaded['trajectory'].acts,
                                  src['trajectory'].acts)
    assert loaded['score'] == src['score']
    assert len(loaded['trajectory'].obs) == len(src['trajectory'].obs)
    assert np.array_equal(np.stack(loaded['trajectory'].obs),
                          src['trajectory'].obs)


def test_re_record_of_jaxs_demo(tmp_path):
    (out,) = re_record(ENV, [JAX_DEMO], str(tmp_path), fidelity='lo',
                       verbose=False, device='cpu')
    (got,) = list(T.load_demos([out]))
    (want,) = list(JT.load_demos([JAX_DEMO]))
    np.testing.assert_array_equal(got['trajectory'].acts,
                                  want['trajectory'].acts)
    assert got['score'] == want['score']
    obs = np.stack(got['trajectory'].obs)
    assert obs.shape == want['trajectory'].obs.shape
    assert obs[0].tobytes() == want['trajectory'].obs[0].tobytes()
    _assert_lo_close(obs, want['trajectory'].obs)


def test_render_demos_cli(cli_demo, tmp_path):
    path, _ = cli_demo
    (out,) = RD.main([path, '--out-dir', str(tmp_path)])
    if out.endswith('.mp4'):
        assert os.path.getsize(out) > 0
    else:
        frames = sorted(os.listdir(out))
        assert len(frames) == 41
        head = open(os.path.join(out, frames[0]), 'rb').read()
        assert head.startswith(b'P6\n96 96\n255\n')
        assert len(head) == len(b'P6\n96 96\n255\n') + 96 * 96 * 3


def _get(url, data=None):
    with urllib.request.urlopen(url, data=data, timeout=60) as r:
        return r.status, r.headers['Content-Type'], r.read()


def test_viewer_serves_page_frames_state_and_keys():
    server, session = WV.make_server(ENV, port=0, fps=50, device='cpu')
    assert server.server_address[0] == '127.0.0.1'
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{port}'
    try:
        status, ctype, body = _get(base + '/')
        assert status == 200 and ctype == 'text/html'
        assert b'/frame.png' in body and b'/keys' in body
        for _ in range(600):        # the first frame follows the reset
            status, ctype, png = _get(base + '/frame.png')
            assert status == 200 and ctype == 'image/png'
            w, h, _ = _decode_png(png)
            if (w, h) != (8, 8):
                break
            threading.Event().wait(0.05)
        assert (w, h) == (96, 96)          # the allo view at lo
        status, ctype, body = _get(base + '/state')
        state = json.loads(body)
        assert ctype == 'application/json'
        assert set(state) == {'t', 'episode', 'score', 'recording'}
        status, _, body = _get(base + '/keys', json.dumps(['up']).encode())
        assert status == 200 and body == b'ok'
        assert session.action() == (C.ACTION_NAMES.index('UpOpen'), False)
        for _ in range(600):
            later = json.loads(_get(base + '/state')[2])
            if later['t'] > state['t'] and later['recording']:
                break
            threading.Event().wait(0.05)
        assert later['t'] > state['t'] and later['recording']
        with pytest.raises(urllib.error.HTTPError):
            _get(base + '/nothing')
    finally:
        session.stop = True
        server.shutdown()
        server.server_close()


def test_cli_serve_binds_loopback_by_default():
    """`--serve` reaches the viewer with the loopback host by default: a
    port already taken on 127.0.0.1 is refused there."""
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    s.listen(1)
    try:
        r = _cli('--env-name', ENV, '--serve', str(s.getsockname()[1]))
    finally:
        s.close()
    assert r.returncode != 0
    assert b'Address already in use' in r.stderr
