"""Checkpoint / resume for env state and tensors.

The counterpart of ``magical_tpu/data/checkpoint.py``, which pickles a JAX
treedef beside an npz of leaves (or uses orbax).  Here a checkpoint is one
``.npz`` of named fields and nothing pickled: an `EnvState` saves each
field through ``core/convert``, an `EnvCarry` its state, its frame rings
and its step count, and a dict its tensors under their keys.  Loading puts
every tensor on the device asked for (the card unless the caller asks for
the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from magical_tpu_torch.api.batched_env import EnvCarry, resolve_device
from magical_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from magical_tpu_torch.core.state import EnvState


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _with_prefix(prefix, arrays):
    return {f'{prefix}/{k}': v for k, v in arrays.items()}


def _under(data, prefix):
    n = len(prefix) + 1
    return {k[n:]: data[k] for k in data.files if k.startswith(prefix + '/')}


def save_pytree(path: str, obj) -> str:
    """Save an `EnvState`, an `EnvCarry` or a dict of tensors (or arrays)
    to `path` (``.npz`` appended if missing); returns the file written."""
    if isinstance(obj, EnvCarry):
        arrays = {**_with_prefix('state', state_to_numpy(obj.state)),
                  **_with_prefix('frames', {v: _numpy(f) for v, f in
                                            obj.frames.items()}),
                  't': np.asarray(obj.t, np.int64)}
        kind = 'EnvCarry'
    elif isinstance(obj, EnvState):
        arrays, kind = _with_prefix('state', state_to_numpy(obj)), 'EnvState'
    elif isinstance(obj, dict):
        arrays = _with_prefix('tensor', {k: _numpy(v) for k, v in obj.items()})
        kind = 'dict'
    else:
        raise TypeError(f'cannot checkpoint a {type(obj).__name__}: an '
                        f'EnvState, an EnvCarry or a dict of tensors')
    path = os.fspath(path)
    if not path.endswith('.npz'):
        path += '.npz'
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, kind=np.asarray(kind), **arrays)
    return path


def load_pytree(path: str, device='cuda'):
    """Load what `save_pytree` saved, its tensors on `device`."""
    device = resolve_device(device)
    path = os.fspath(path)
    if not path.endswith('.npz') and not os.path.exists(path):
        path += '.npz'
    with np.load(path, allow_pickle=False) as data:
        kind = str(data['kind'])
        if kind == 'dict':
            return {k: torch.from_numpy(v).to(device)
                    for k, v in _under(data, 'tensor').items()}
        state = state_from_numpy(_under(data, 'state'), device)
        if kind == 'EnvState':
            return state
        if kind != 'EnvCarry':
            raise ValueError(f'{path}: unknown checkpoint kind {kind!r}')
        frames = {v: torch.from_numpy(f).to(device)
                  for v, f in _under(data, 'frames').items()}
        return EnvCarry(state=state, frames=frames, t=int(data['t']))
