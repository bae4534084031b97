"""Real-time interactive viewer and teleop over HTTP.

The counterpart of ``magical_tpu/tools/web_viewer.py``.  The reference's
human mode is a pyglet window with arrow-key teleop and demo recording
(its __main__.py:92-171, gym_render.py:547-605); this viewer serves the
same interaction over HTTP: a stdlib ThreadingHTTPServer streams PNG
frames of the allocentric view to a browser canvas at the env's frame
rate and takes the held keys from the page's keydown/keyup handlers.
Controls as in the reference: arrows move, space closes the grippers, R
resets.  Recording as in the reference: it starts on the first non-null
action and saves the gzip-pickled {'env_name', 'trajectory', 'score'} at
the episode's end.  The server binds to 127.0.0.1 unless told otherwise;
the env runs on the card unless ``device='cpu'``.

Usage:  python -m magical_tpu_torch --serve 8712 [--record DIR]
then open http://localhost:8712/ .
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><title>magical_tpu_torch viewer</title><style>
body { background:#222; color:#eee; font-family:monospace;
       display:flex; flex-direction:column; align-items:center; }
img  { image-rendering:pixelated; width:576px; height:576px;
       border:1px solid #555; margin-top:12px; }
#hud { margin-top:8px; }
</style></head><body>
<div>magical_tpu_torch — arrows move &middot; space grips &middot; R resets</div>
<img id="view" src="/frame.png">
<div id="hud"></div>
<script>
const held = new Set();
const keymap = {ArrowUp:'up', ArrowDown:'down', ArrowLeft:'left',
                ArrowRight:'right', ' ':'close', r:'reset', R:'reset'};
function send() {
  fetch('/keys', {method:'POST', body:JSON.stringify([...held])});
}
addEventListener('keydown', e => { const k = keymap[e.key];
  if (k) { e.preventDefault(); if (!held.has(k)) { held.add(k); send(); } }});
addEventListener('keyup', e => { const k = keymap[e.key];
  if (k) { e.preventDefault(); held.delete(k); send(); }});
setInterval(send, 500);
const img = document.getElementById('view');
function refresh() {
  fetch('/frame.png?' + Date.now()).then(r => r.blob()).then(b => {
    img.src = URL.createObjectURL(b);
    fetch('/state').then(r => r.json()).then(s => {
      document.getElementById('hud').textContent =
        `ep ${s.episode}  t ${s.t}  score ${s.score}` +
        (s.recording ? '  [REC]' : '');
    });
    setTimeout(refresh, 1000 / 12);
  }).catch(() => setTimeout(refresh, 500));
}
refresh();
</script></body></html>"""


def encode_png(rgb, level=1):
    """Minimal 8-bit RGB PNG encoder (stdlib only)."""
    h, w, _ = rgb.shape
    raw = b''.join(b'\x00' + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return (struct.pack('>I', len(data)) + c
                + struct.pack('>I', zlib.crc32(c) & 0xffffffff))

    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw, level))
            + chunk(b'IEND', b''))


def _action_of_keys(keys):
    """The reference's action grammar of a set of held keys: opposite
    directions cancel, the grippers close while 'close' is held."""
    from magical_tpu_torch import constants as C
    up, down = 'up' in keys, 'down' in keys
    left, right = 'left' in keys, 'right' in keys
    name = (('Up' if up and not down else '')
            + ('Down' if down and not up else '')
            + ('Left' if left and not right else '')
            + ('Right' if right and not left else '')
            + ('Close' if 'close' in keys else 'Open'))
    return C.ACTION_NAMES.index(name)


def save_episode(record_dir, env_name, episode, traj, score):
    """Write one episode ({'obs', 'acts', 'rews', 'infos'} lists, obs one
    longer) as a demo file under `record_dir`; returns its path."""
    import datetime
    import os

    from magical_tpu_torch.data.trajectories import (MAGICALTrajectory,
                                                     save_demo)
    os.makedirs(record_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime('%FT%H:%M:%S')
    path = os.path.join(record_dir,
                        f'demo-{env_name}-{stamp}-{episode}.pkl.gz')
    obs0 = traj['obs'][0]
    if isinstance(obs0, dict):
        obs = {k: np.stack([o[k] for o in traj['obs']]) for k in obs0}
    else:
        obs = np.stack(traj['obs'])
    save_demo(path, env_name, MAGICALTrajectory(
        acts=np.asarray(traj['acts']), obs=obs,
        rews=np.asarray(traj['rews']), infos=traj['infos']), score)
    return path


class Session:
    """Env stepping loop driven by the latest held-key state."""

    def __init__(self, env_name, record_dir=None, fps=None, seed=None,
                 device='cuda'):
        import magical_tpu_torch
        magical_tpu_torch.register_envs()
        self.env_name = env_name
        self.env = magical_tpu_torch.make(env_name, device=device)
        if seed is not None:
            self.env.seed(seed)
        self.fps = fps or getattr(self.env, 'fps', 8.0)
        self.record_dir = record_dir
        self.lock = threading.Lock()
        self.keys = set()
        self.frame_png = encode_png(np.zeros((8, 8, 3), np.uint8))
        self.t = 0
        self.episode = 0
        self.score = 0.0
        self.recording = False
        self.stop = False
        self._traj = None

    def action(self):
        """(action, reset wanted) of the held keys."""
        with self.lock:
            keys = set(self.keys)
        return _action_of_keys(keys), ('reset' in keys)

    def _begin_episode(self):
        obs = self.env.reset()
        self.t = 0
        self.score = 0.0
        self.recording = False
        self._traj = {'obs': [obs], 'acts': [], 'rews': [], 'infos': []}
        self._publish(obs)

    def _publish(self, obs):
        if isinstance(obs, dict) and 'allo' in obs:
            frame = obs['allo']         # the raw allo view
        else:
            frame = self.env.render()['allo']
        png = encode_png(np.asarray(frame))
        with self.lock:
            self.frame_png = png

    def run(self):
        from magical_tpu_torch import constants as C
        noop = C.ACTION_NAMES.index('Open')
        self._begin_episode()
        while not self.stop:
            t0 = time.time()
            act, want_reset = self.action()
            if want_reset:
                self._begin_episode()
                time.sleep(0.25)        # debounce R
                continue
            # recording starts on the first non-null action (the
            # reference's __main__.py:128-131)
            if act != noop:
                self.recording = True
            obs, rew, done, info = self.env.step(act)
            for k, v in (('obs', obs), ('acts', act), ('rews', rew),
                         ('infos', info)):
                self._traj[k].append(v)
            self.t += 1
            self._publish(obs)
            if done:
                self.score = float(info['eval_score'])
                print(f'episode {self.episode}: len {self.t} '
                      f'score {self.score:.3f}', flush=True)
                if self.record_dir and self.recording:
                    print('saved', save_episode(
                        self.record_dir, self.env_name, self.episode,
                        self._traj, self.score), flush=True)
                self.episode += 1
                self._begin_episode()
            dt = time.time() - t0
            if dt < 1.0 / self.fps:
                time.sleep(1.0 / self.fps - dt)


def make_server(env_name, port=8712, record_dir=None, fps=None, seed=None,
                host='127.0.0.1', device='cuda'):
    """The HTTP server (not yet serving) and its Session, whose stepping
    thread is started; port 0 takes a free port
    (``server.server_address[1]``)."""
    session = Session(env_name, record_dir=record_dir, fps=fps, seed=seed,
                      device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):            # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.send_header('Cache-Control', 'no-store')
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split('?')[0]
            if path == '/':
                self._send(200, 'text/html', PAGE.encode())
            elif path == '/frame.png':
                with session.lock:
                    png = session.frame_png
                self._send(200, 'image/png', png)
            elif path == '/state':
                body = json.dumps(dict(
                    t=session.t, episode=session.episode,
                    score=round(session.score, 3),
                    recording=session.recording)).encode()
                self._send(200, 'application/json', body)
            else:
                self._send(404, 'text/plain', b'not found')

        def do_POST(self):
            if self.path == '/keys':
                n = int(self.headers.get('Content-Length', 0))
                try:
                    keys = set(json.loads(self.rfile.read(n) or b'[]'))
                except ValueError:
                    keys = set()
                with session.lock:
                    session.keys = keys
                self._send(200, 'text/plain', b'ok')
            else:
                self._send(404, 'text/plain', b'not found')

    # loopback by default: the viewer can teleop the env and (with
    # --record) write demo files, so exposing it must be deliberate
    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=session.run, daemon=True).start()
    return server, session


def serve(env_name, port=8712, record_dir=None, fps=None, seed=None,
          open_msg=True, host='127.0.0.1', device='cuda'):
    """Serve the viewer until interrupted; returns the Session."""
    server, session = make_server(env_name, port, record_dir, fps, seed,
                                  host, device)
    if open_msg:
        print(f'serving {env_name} on http://{host}:'
              f'{server.server_address[1]}/ (arrows move, space grips, R '
              'resets' + (f'; recording to {record_dir}' if record_dir
                          else '') + ')', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        session.stop = True
        server.server_close()
    return session
