"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` source goes through one ``nvcc`` call into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library lands in ``build/magical_tpu_torch/`` beside the
package, under a name that hashes the sources and flags, so a changed
source rebuilds and an unchanged one is reused.  Nothing is built when
the package is imported: the kernel wrappers call :func:`library` on
their first launch on a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'magical_tpu_torch'

# Hopper only (wgmma/TMA live under sm_90a).  No --use_fast_math, and no
# contraction of a multiply and an add into one FMA (-fmad=false): the
# kernels then round every operation as their plain PyTorch versions do,
# which makes the lo render byte-equal to its plain version on the card
# and cuts the control step's one-step difference ~25x, for ~3-8% of
# kernel time (PERF.md).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types.
SIGNATURES = {
    'physics_table_layout': [_P],
    'physics_control_step': [_P] * 20 + [_I] * 4 + [_P],
    'render_lo_into_slot': [_P] * 10 + [_I] * 5 + [ctypes.c_float] * 9
    + [_P],
    'render_lo_frame': [_P] * 10 + [_I] * 5 + [ctypes.c_float] * 9 + [_P],
}

_LIB = None
BUILD_SECONDS = None


def sources():
    return sorted(CSRC_DIR.glob('*.cu')) + sorted(CSRC_DIR.glob('*.cuh'))


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(pathlib.Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    cands.append(pathlib.Path('/usr/local/cuda/bin/nvcc'))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'magical_tpu_torch build only where the CUDA '
                           'toolkit is installed')
    return found


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile csrc/*.cu into the build directory unless the library for
    the current sources already exists; returns its path."""
    global BUILD_SECONDS
    out = BUILD_DIR / f'libmagical_tpu_torch_{_digest()}.so'
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC_DIR.glob('*.cu'))]
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ['-Xptxas', '-v']
    cmd += ['-o', tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    (BUILD_DIR / 'build.log').write_text(
        ' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{proc.stderr[-4000:]}')
    if verbose:
        print(proc.stderr, end='')
    os.replace(tmp, out)
    return out


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')
