"""Convert old multi-discrete-action demos to the flat 18-action format.

The counterpart of ``magical_tpu/tools/convert_demos.py`` (after the
reference's magical/misc/convert_demos_to_new_act_format.py):
old demos store actions as (ud, lr, grip) triples with
ud in {none, up, down}, lr in {none, left, right}, grip in {open, close};
the flat id is grip*9 + lr*3 + ud (the canonical order of
ACTION_NUMS_FLAGS_NAMES, reference entities.py:162-190, mirrored by
constants.ACTION_TABLE).

    python -m magical_tpu_torch.tools.convert_demos --source demos/ --dest demos-new/
"""

import argparse
import os

import numpy as np

from magical_tpu_torch.data.trajectories import (MAGICALTrajectory, load_demos,
                                                 save_demo)

SUFFIX = '.pkl.gz'


def convert_acts(old_acts):
    """(N, 3) multi-discrete -> (N,) flat int32 action ids."""
    old = np.asarray(old_acts)
    assert old.ndim == 2 and old.shape[1] == 3, old.shape
    ud, lr, grip = old[:, 0], old[:, 1], old[:, 2]
    assert ud.max(initial=0) < 3 and lr.max(initial=0) < 3 \
        and grip.max(initial=0) < 2
    return (grip * 9 + lr * 3 + ud).astype(np.int32)


def convert_tree(source, dest, verbose=True):
    source = os.path.abspath(source)
    dest = os.path.abspath(dest)
    os.makedirs(dest, exist_ok=True)
    out_paths = []
    for dirpath, _, filenames in os.walk(source):
        for filename in sorted(filenames):
            if not filename.endswith(SUFFIX):
                continue
            src_path = os.path.join(dirpath, filename)
            demo, = load_demos([src_path])
            traj = demo['trajectory']
            new_traj = MAGICALTrajectory(
                acts=convert_acts(traj.acts), obs=traj.obs,
                rews=traj.rews, infos=traj.infos)
            rel = os.path.relpath(dirpath, start=source)
            dest_dir = os.path.join(dest, rel)
            os.makedirs(dest_dir, exist_ok=True)
            dst_path = os.path.join(dest_dir, filename)
            if verbose:
                print(f"'{src_path}' -> '{dst_path}'")
            save_demo(dst_path, demo['env_name'], new_traj,
                      demo.get('score'))
            out_paths.append(dst_path)
    return out_paths


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--source', default='demos/')
    ap.add_argument('--dest', default='demos-new/')
    args = ap.parse_args()
    convert_tree(args.source, args.dest)


if __name__ == '__main__':
    main()
