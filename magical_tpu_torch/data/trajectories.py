"""Demo-trajectory (de)serialisation and offline preprocessing.

The counterpart of ``magical_tpu/data/trajectories.py``, numpy as there.
Byte-compatible with the reference's gzip-pickle demo format
(the reference's magical/saved_trajectories.py and __main__.py:150-159):
a gzip'd pickle of ``{'env_name': str, 'trajectory': MAGICALTrajectory,
'score': float}``.  The class-rewriting unpickler accepts pickles written
against `imitation`, `milbench`, the reference `magical` package or
``magical_tpu`` (so a demo the JAX package wrote loads without JAX).

``preprocess_demos_with_wrapper`` reproduces the reference's
wrapper-replay pipeline (saved_trajectories.py:87-149) numerically: the
demos' raw dual-view 384x384 observations are pushed through the same
resize + frame-stack math the live preprocessors use, so demos and live
observations stay pixel-identical — without standing up a mock env.
"""

from __future__ import annotations

import gzip
import pickle
from pickle import Unpickler
from typing import List, NamedTuple, Optional

import numpy as np

from magical_tpu_torch.core.preproc import PREPROCESSORS, PreprocSpec


class MAGICALTrajectory(NamedTuple):
    """Trajectory container (saved_trajectories.py:14-21)."""
    acts: np.ndarray
    obs: dict
    rews: np.ndarray
    infos: Optional[List[dict]]


class _TrajRewriteUnpickler(Unpickler):
    """saved_trajectories.py:24-33 + acceptance of the reference's class
    and of the JAX package's."""

    def find_class(self, module, name):
        if (module, name) in (
                ('imitation.util.rollout', 'Trajectory'),
                ('milbench.baselines.saved_trajectories',
                 'MILBenchTrajectory'),
                ('magical.saved_trajectories', 'MAGICALTrajectory'),
                ('magical_tpu.data.trajectories', 'MAGICALTrajectory')):
            return MAGICALTrajectory
        return super().find_class(module, name)


def load_demos(demo_paths, rewrite_traj_cls=True, verbose=False):
    """saved_trajectories.py:36-49 — generator of demo dicts."""
    n_demos = len(demo_paths)
    for d_num, d_path in enumerate(demo_paths, start=1):
        if verbose:
            print(f"Loading '{d_path}' ({d_num}/{n_demos})")
        with gzip.GzipFile(d_path, 'rb') as fp:
            unpickler = _TrajRewriteUnpickler(fp) if rewrite_traj_cls \
                else Unpickler(fp)
            yield unpickler.load()


def save_demo(path, env_name, trajectory: MAGICALTrajectory, score: float):
    """__main__.py:150-159 — gzip-pickled demo dict."""
    with gzip.GzipFile(path, 'wb') as fp:
        pickle.dump({'env_name': env_name, 'trajectory': trajectory,
                     'score': score}, fp)


def splice_in_preproc_name(base_env_name, preproc_name):
    """saved_trajectories.py:52-60."""
    from magical_tpu_torch.api.names import update_magical_env_name
    assert preproc_name in PREPROCESSORS, \
        f"no preprocessor named '{preproc_name}', options are " \
        f"{', '.join(PREPROCESSORS)}"
    return update_magical_env_name(base_env_name, preproc=preproc_name)


# ---------------------------------------------------------------------------
# Offline preprocessing (numpy, matches the on-device pipeline)
# ---------------------------------------------------------------------------

def _resize_area(img: np.ndarray, res: int) -> np.ndarray:
    """cv2.INTER_AREA for integer downscale ratios = box mean
    (benchmarks/__init__.py:162-169; exact at the 384->96 ratio)."""
    h, w = img.shape[:2]
    fh, fw = h // res, w // res
    assert fh * res == h and fw * res == w, (h, w, res)
    x = img.reshape(res, fh, res, fw, *img.shape[2:]).astype(np.float64)
    # cv2 rounds half away from zero (fixed-point +0.5), not half-to-even
    return np.floor(x.mean(axis=(1, 3)) + 0.5).astype(np.uint8)


def _stack_frames(frames: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(frames, axis=-1)


def preprocess_demos_with_wrapper(trajectories, orig_env_name,
                                  preproc_name=None, wrapper=None):
    """saved_trajectories.py:87-149 — preprocess raw demo observations the
    same way the named preprocessor would during live rollouts.

    `wrapper` (a Gym-wrapper constructor) is not supported in the
    batched pipeline; use `preproc_name`."""
    if wrapper is not None:
        raise NotImplementedError(
            'custom wrapper callables are not supported; pass preproc_name')
    assert preproc_name is not None
    spec: PreprocSpec = PREPROCESSORS[preproc_name]

    out = []
    for traj in trajectories:
        obs_seq = traj.obs           # list/array of dicts or dict of arrays
        T = len(traj.acts) + 1

        def get_frame(t, view):
            o = obs_seq[t] if not isinstance(obs_seq, dict) else \
                {k: v[t] for k, v in obs_seq.items()}
            return np.asarray(o[view])

        # rolling buffers with reset padding (first frame repeated)
        bufs = {v: [_resize_area(get_frame(0, v), spec.res) ]
                * spec.depth(v) for v in spec.views}

        def observation():
            per_view = {v: _stack_frames(bufs[v]) for v in spec.views}
            if spec.stacked_dict:
                return dict(per_view)
            parts = []
            if spec.allo_frames:
                parts.append(per_view['allo'])
            if spec.ego_frames:
                parts.append(per_view['ego'])
            o = parts[0] if len(parts) == 1 else _stack_frames(parts)
            if spec.channels_first:
                o = np.moveaxis(o, -1, 0)
            return o

        new_obs = [observation()]
        for t in range(1, T):
            for v in spec.views:
                bufs[v] = bufs[v][1:] + [_resize_area(get_frame(t, v),
                                                      spec.res)]
            new_obs.append(observation())

        if isinstance(new_obs[0], dict):
            stacked = {k: np.stack([o[k] for o in new_obs])
                       for k in new_obs[0]}
        else:
            stacked = np.stack(new_obs)
        out.append(type(traj)(
            acts=np.asarray(traj.acts), obs=stacked,
            rews=np.asarray(traj.rews), infos=traj.infos))
    return out
