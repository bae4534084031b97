"""Interactive demo recorder and env runner CLI of the port.

The counterpart of ``python -m magical_tpu`` (``magical_tpu/__main__.py``;
the reference's ``python -m magical``, its __main__.py:62-174).  The
reference opens a pyglet window for keyboard teleop; this CLI has three
modes that work headless:

  * --policy random           random-action rollouts (smoke/demo data)
  * --policy module:fn        any python policy fn(obs, t) -> int action
  * --teleop                  terminal teleop (WASD + j/k grip, q quits),
                              rendering an ANSI preview of the allo view

Recording matches the reference byte format: gzip-pickled
``{'env_name', 'trajectory': MAGICALTrajectory, 'score'}``
(__main__.py:150-159); recording auto-starts on the first non-NOOP
action (reference behaviour __main__.py:128-131 — here every step is
recorded since actions always carry open/close).  The env runs on the
card unless ``--device cpu`` is given."""

import argparse
import importlib
import os
import sys

import numpy as np


def _ansi_preview(frame, width=48):
    """Render an RGB frame as ANSI half-block art."""
    h, w = frame.shape[:2]
    step = max(1, w // width)
    rows = []
    for y in range(0, h - step, step * 2):
        row = []
        for x in range(0, w, step):
            r1, g1, b1 = frame[y, x]
            r2, g2, b2 = frame[min(y + step, h - 1), x]
            row.append(f'\x1b[38;2;{r1};{g1};{b1}m'
                       f'\x1b[48;2;{r2};{g2};{b2}m▀')
        rows.append(''.join(row) + '\x1b[0m')
    return '\n'.join(rows)


def _write_ppm(path, frame):
    """Write an RGB uint8 frame as binary PPM (no image deps needed)."""
    h, w = frame.shape[:2]
    with open(path, 'wb') as f:
        f.write(f'P6\n{w} {h}\n255\n'.encode())
        f.write(np.ascontiguousarray(frame, dtype=np.uint8).tobytes())


def _teleop_action(ch):
    from magical_tpu_torch import constants as C
    up = ch in 'wW'
    down = ch in 'sS'
    left = ch in 'aA'
    right = ch in 'dD'
    close = ch in 'kK'
    name = (('Up' if up else '') + ('Down' if down else '')
            + ('Left' if left else '') + ('Right' if right else '')
            + ('Close' if close else 'Open'))
    return C.ACTION_NAMES.index(name)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--env-name', default='MoveToCorner-Demo-v0')
    p.add_argument('--record', metavar='DIR', default=None,
                   help='save trajectories to this directory')
    p.add_argument('--policy', default=None,
                   help="'random' or 'module:function'")
    p.add_argument('--teleop', action='store_true')
    p.add_argument('--episodes', type=int, default=1)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--print-spec', action='store_true',
                   help='print the entity layout after reset')
    p.add_argument('--view', action='store_true',
                   help='live ANSI view of policy rollouts at --fps '
                        '(the headless stand-in for the reference\'s '
                        'pyglet human-render window, gym_render.py:547-605)')
    p.add_argument('--fps', type=float, default=8.0,
                   help='frame-rate limit for --view / teleop redraw '
                        '(reference runs its human loop at env.fps=8)')
    p.add_argument('--save-frames', metavar='DIR', default=None,
                   help='also dump each allo frame as a PPM image')
    p.add_argument('--serve-host', default='127.0.0.1',
                   help='bind address for --serve (default loopback; '
                        'set 0.0.0.0 to expose deliberately)')
    p.add_argument('--serve', metavar='PORT', type=int, default=None,
                   help='real-time interactive viewer/teleop over HTTP: '
                        'streams frames to a browser page with arrow-key '
                        'control (the headless counterpart of the '
                        "reference's pyglet window; see "
                        'tools/web_viewer.py)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    if args.serve is not None:
        from magical_tpu_torch.tools.web_viewer import serve
        serve(args.env_name, port=args.serve, record_dir=args.record,
              fps=args.fps, seed=args.seed, host=args.serve_host,
              device=args.device)
        return

    import magical_tpu_torch
    from magical_tpu_torch.tools.web_viewer import save_episode

    magical_tpu_torch.register_envs()
    env = magical_tpu_torch.make(args.env_name, device=args.device)
    if args.seed is not None:
        env.seed(args.seed)

    if args.policy == 'random' or (args.policy is None and not args.teleop):
        rng = np.random.RandomState(args.seed or 0)
        policy = lambda obs, t: int(rng.randint(18))   # noqa: E731
    elif args.policy:
        mod_name, fn_name = args.policy.split(':')
        policy = getattr(importlib.import_module(mod_name), fn_name)
    else:
        policy = None

    for ep in range(args.episodes):
        obs = env.reset()
        if args.print_spec:
            st = env._carry.state
            print('robot pose:', st.pos[0, 0].cpu().numpy(),
                  float(st.angle[0, 0]))
            print('blocks:', int(st.block_active[0].sum()))
        traj = {'obs': [obs], 'acts': [], 'rews': [], 'infos': []}
        done = False
        t = 0
        last_draw = 0.0
        while not done:
            if policy is not None:
                act = int(policy(obs, t))
                if args.view or args.save_frames:
                    frames = env.render()
                    if args.view:
                        import time
                        now = time.time()
                        wait = last_draw + 1.0 / args.fps - now
                        if wait > 0:
                            time.sleep(wait)
                        last_draw = time.time()
                        sys.stdout.write('\x1b[2J\x1b[H')
                        print(_ansi_preview(frames['allo']))
                        print(f'ep {ep} t {t}', flush=True)
                    if args.save_frames:
                        os.makedirs(args.save_frames, exist_ok=True)
                        _write_ppm(os.path.join(
                            args.save_frames,
                            f'ep{ep:03d}-t{t:04d}.ppm'), frames['allo'])
            else:
                frames = env.render()
                sys.stdout.write('\x1b[2J\x1b[H')
                print(_ansi_preview(frames['allo']))
                print('WASD move, j=open k=close grip, q quit > ', end='',
                      flush=True)
                ch = sys.stdin.read(1)
                if ch in 'qQ':
                    return
                act = _teleop_action(ch)
            obs, rew, done, info = env.step(act)
            traj['obs'].append(obs)
            traj['acts'].append(act)
            traj['rews'].append(rew)
            traj['infos'].append(info)
            t += 1
        score = info['eval_score']
        print(f'episode {ep}: len {t} score {score:.3f}', flush=True)
        if args.record:
            print('saved', save_episode(args.record, args.env_name, ep,
                                        traj, score))


if __name__ == '__main__':
    main()
