"""Render saved demos to video or frames.

The counterpart of ``magical_tpu/tools/render_demos.py`` (the reference's
misc/render_demos.py, demos to mp4): ffmpeg where it is on the PATH, else
one binary PPM a frame.  numpy only.

    python -m magical_tpu_torch.tools.render_demos demo1.pkl.gz --out-dir vids/
"""

import argparse
import os
import shutil
import subprocess
import tempfile

import numpy as np


def frames_from_demo(demo):
    """The demo's frames to show, (T, H, W, 3) uint8: the allo view of a
    dict observation (else its first view), or the newest frame of a
    channel stack.  The observations may also be a list of per-step
    observations (re_record_demos writes them so)."""
    traj = demo['trajectory']
    obs = traj.obs
    if isinstance(obs, (list, tuple)):
        # a list of per-step observations, as re_record_demos writes them
        obs = ({k: np.stack([o[k] for o in obs]) for k in obs[0]}
               if isinstance(obs[0], dict) else np.stack(obs))
    if isinstance(obs, dict):
        frames = obs.get('allo', next(iter(obs.values())))
    else:
        frames = obs
        if frames.ndim == 4 and frames.shape[-1] > 3:
            frames = frames[..., -3:]   # newest frame of a channel stack
    return np.asarray(frames)


def _write_ppms(frames, out_dir):
    for i, f in enumerate(frames):
        with open(os.path.join(out_dir, f'{i:05d}.ppm'), 'wb') as fp:
            fp.write(b'P6\n%d %d\n255\n' % (f.shape[1], f.shape[0]))
            fp.write(np.ascontiguousarray(f).tobytes())


def write_video(frames, out_path, fps=8):
    """`frames` to the mp4 `out_path` through ffmpeg; without ffmpeg, to a
    directory of PPM frames named after it.  Returns what was written."""
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        base = os.path.splitext(out_path)[0]
        os.makedirs(base, exist_ok=True)
        _write_ppms(frames, base)
        return base
    with tempfile.TemporaryDirectory() as td:
        _write_ppms(frames, td)
        subprocess.run(
            [ffmpeg, '-y', '-framerate', str(fps), '-i',
             os.path.join(td, '%05d.ppm'), '-pix_fmt', 'yuv420p', out_path],
            check=True, capture_output=True)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('demos', nargs='+')
    p.add_argument('--out-dir', default='demo-videos')
    p.add_argument('--fps', type=int, default=8)
    args = p.parse_args(argv)

    from magical_tpu_torch.data.trajectories import load_demos
    os.makedirs(args.out_dir, exist_ok=True)
    outs = []
    for path, demo in zip(args.demos, load_demos(args.demos)):
        frames = frames_from_demo(demo)
        stem = os.path.splitext(os.path.basename(path))[0]
        out = write_video(frames, os.path.join(args.out_dir, stem + '.mp4'),
                          args.fps)
        print(f'{path} -> {out} ({len(frames)} frames)')
        outs.append(out)
    return outs


if __name__ == '__main__':
    main()
