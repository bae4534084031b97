"""magical_tpu_torch — the PyTorch / CUDA port of magical_tpu, the batched
MAGICAL environment engine.

It mirrors ``magical_tpu``'s module paths and function names, and its
facade (``magical_tpu/__init__.py``): `make`, `register_envs`,
`ALL_REGISTERED_ENVS`, `DEMO_ENVS_TO_TEST_ENVS_MAP`,
`AVAILABLE_PREPROCESSORS`, the demo IO (`load_demos`,
`preprocess_demos_with_wrapper`, `splice_in_preproc_name`,
`MAGICALTrajectory`) and `try_download_demos`.  Every name is imported on
first access, so ``import magical_tpu_torch`` stays light.  The package
imports torch and numpy only; its CUDA kernels (``csrc/``) are built on
first use on a CUDA device (``_build.py``).
"""

import importlib

# facade name -> the module that defines it
_FACADE = {
    'make': 'magical_tpu_torch.api.registry',
    'register_envs': 'magical_tpu_torch.api.registry',
    'ALL_REGISTERED_ENVS': 'magical_tpu_torch.api.registry',
    'DEMO_ENVS_TO_TEST_ENVS_MAP': 'magical_tpu_torch.api.registry',
    'AVAILABLE_PREPROCESSORS': 'magical_tpu_torch.core.preproc',
    'load_demos': 'magical_tpu_torch.data.trajectories',
    'preprocess_demos_with_wrapper': 'magical_tpu_torch.data.trajectories',
    'splice_in_preproc_name': 'magical_tpu_torch.data.trajectories',
    'MAGICALTrajectory': 'magical_tpu_torch.data.trajectories',
    'try_download_demos': 'magical_tpu_torch.data.reference_demos',
}

__all__ = sorted(_FACADE)


def __getattr__(name):
    if name not in _FACADE:
        raise AttributeError(
            f'module {__name__!r} has no attribute {name!r}')
    return getattr(importlib.import_module(_FACADE[name]), name)


def __dir__():
    return sorted(set(globals()) | set(_FACADE))


__version__ = '0.1.0'
