"""Observation preprocessors over on-device frame rings.

The PyTorch counterpart of ``magical_tpu/core/preproc.py``: the five
preprocessor specs of the reference (benchmarks/__init__.py:242-274) and
the circular frame-buffer path (``init_frames_cf``, ``push_frames_cf``,
``observation_cf``).

Ring layout, chosen for the GPU: one ring per view, ``(depth, B, res,
res, 3)`` uint8, where slot ``k`` holds the frame of a step ``t`` with
``t mod depth == k``.  A slot is one contiguous (B, res, res, 3) block, so
the render kernel writes each new frame straight into it, and the
observation is one stacking copy.  The observation itself is the JAX
package's layout, byte for byte: (B, res, res, 3 * frames) with frames
oldest to newest, allo frames before ego frames.

Requires envs in LOCKSTEP (one step counter for the whole batch), as the
batched API guarantees: episodes are fixed-length and reset re-creates
the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PreprocSpec:
    name: Optional[str]
    res: int = 96
    allo_frames: int = 0
    ego_frames: int = 0
    stacked_dict: bool = False     # LoResStack: dict of per-view stacks
    channels_first: bool = False
    raw: bool = False              # no preprocessing: dict of raw frames

    @property
    def views(self) -> Tuple[str, ...]:
        if self.raw:
            return ('allo', 'ego')
        v = []
        if self.allo_frames:
            v.append('allo')
        if self.ego_frames:
            v.append('ego')
        return tuple(v)

    def depth(self, view):
        return {'allo': self.allo_frames, 'ego': self.ego_frames}[view]


# benchmarks/__init__.py:242-274
PREPROCESSORS = {
    'LoRes3EA': PreprocSpec('LoRes3EA', allo_frames=1, ego_frames=3),
    'LoRes4E': PreprocSpec('LoRes4E', ego_frames=4),
    'LoRes4A': PreprocSpec('LoRes4A', allo_frames=4),
    'LoResStack': PreprocSpec('LoResStack', allo_frames=4, ego_frames=4,
                              stacked_dict=True),
    'LoResCHW4E': PreprocSpec('LoResCHW4E', ego_frames=4,
                              channels_first=True),
}
AVAILABLE_PREPROCESSORS = list(PREPROCESSORS)

RAW_SPEC = PreprocSpec(None, res=384, raw=True)


def get_preproc(name: Optional[str]) -> PreprocSpec:
    if name is None:
        return RAW_SPEC
    if name == 'DebugReward':
        # MoveToCorner debug envs use the raw observation pipeline
        return RAW_SPEC
    return PREPROCESSORS[name]


def init_frames_cf(spec: PreprocSpec, raw_imgs: dict) -> dict:
    """raw_imgs: {view: (B, res, res, 3) uint8} reset frames.  Reset
    padding: every slot of each view's ring holds the reset frame."""
    return {v: raw_imgs[v].unsqueeze(0).repeat(spec.depth(v), 1, 1, 1, 1)
            for v in spec.views}


def push_frames_cf(spec: PreprocSpec, bufs: dict, raw_imgs: dict, t: int):
    """Write the step-t frames into slot (t mod depth) of each view's
    ring, IN PLACE; returns `bufs`."""
    for v in spec.views:
        bufs[v][t % spec.depth(v)].copy_(raw_imgs[v])
    return bufs


def observation_cf(spec: PreprocSpec, bufs: dict, t: int, res: int):
    """Assemble the user-facing observation from the rings after the
    step-t frame was written: (B, res, res, 3 * frames) uint8 (LoResCHW4E:
    (B, 3 * frames, res, res); LoResStack: {view: (B, res, res, 12)})."""
    def stacked(v):
        d = spec.depth(v)
        ring = bufs[v]
        # oldest (slot t+1) .. newest (slot t), channels-last
        frames = [ring[(t + 1 + k) % d] for k in range(d)]
        B = ring.shape[1]
        return torch.stack(frames, 3).reshape(B, res, res, 3 * d)

    if spec.stacked_dict:
        return {v: stacked(v) for v in spec.views}
    parts = [stacked(v) for v in spec.views]
    obs = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    if spec.channels_first:
        obs = obs.permute(0, 3, 1, 2).contiguous()
    return obs
