"""Carry environment state between numpy and the port's `EnvState`.

This is how a batched JAX ``EnvState`` reaches the port: the caller turns
each field into a numpy array (``np.asarray``) and hands the dict over.
The path has no weights, so state is all there is to convert.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from magical_tpu_torch.core.state import EnvState

# Fields whose numpy dtype the port does not keep as is: the JAX PRNG key
# is two uint32 words, held here as int64.
_TO_TORCH_DTYPE = {np.dtype(np.uint32): torch.int64}
_TO_NUMPY_DTYPE = {'rng': np.uint32}


def state_from_numpy(arrays: dict, device) -> EnvState:
    """Build a batched `EnvState` on `device` from a dict of numpy arrays
    with the env axis first, one entry per field."""
    out = {}
    for f in dataclasses.fields(EnvState):
        a = np.asarray(arrays[f.name])
        dtype = _TO_TORCH_DTYPE.get(a.dtype)
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[f.name] = t.to(device=device, dtype=dtype or t.dtype).contiguous()
    return EnvState(**out)


def state_to_numpy(state: EnvState) -> dict:
    """The inverse of `state_from_numpy`: {field: numpy array}."""
    out = {}
    for f in dataclasses.fields(EnvState):
        a = getattr(state, f.name).detach().cpu().numpy()
        if f.name in _TO_NUMPY_DTYPE:
            a = a.astype(_TO_NUMPY_DTYPE[f.name])
        out[f.name] = a
    return out
