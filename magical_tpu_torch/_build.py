"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` source goes through its own ``nvcc`` call into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); the calls run side by side.  The libraries land in
``build/magical_tpu_torch/`` beside the package, each under a name that
hashes its source, the shared headers and the flags, so a changed source
rebuilds and an unchanged one is reused.  Nothing is built when the
package is imported: the kernel wrappers call :func:`library` on their
first launch on a CUDA device.
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
import types

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
# The render entry points' arguments (csrc/render_lo.cuh SCENE_ARGS): the
# state's, the program's and the frame's pointers, the sizes and the ego
# flag, the camera's floats, the tile, the stream.
_SCENE = [_P] * 13 + [_I] * 7 + [ctypes.c_float] * 9 + [_I] * 2 + [_P]
# C entry points and their argument types.
SIGNATURES = {
    'physics_table_layout': [_P],
    **{f'physics_control_step_mb{mb}': [_P] * 20 + [_I] * 4 + [_P] * 3
       for mb in (1, 3, 4, 7, 8, 10)},
    'render_program_layout': [_P],
    **{entry: _SCENE for entry in (
        'render_lo_into_slot', 'render_lo_frame', 'render_lo_tiles2d',
        'render_hi_frame')},
    # K4's step entry also takes its three counters' pointers (or nulls)
    'render_hi_into_slot': _SCENE[:-1] + [_P] * 4,
    # the placement (csrc/place.cu): the proposals, the entity, the placed
    # rows and the mask, the pick, ok and the counter, B, T, E, the stream
    'place_first_fit': [_P] * 15 + [_I] * 3 + [_P],
}

_LIB = None
BUILD_SECONDS = None


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


def _digest(cu: pathlib.Path) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in [cu] + sorted(CSRC_DIR.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> list:
    """Compile every csrc/*.cu whose library for the current sources does
    not exist yet, one nvcc process per source, all started together;
    returns the libraries' paths.  Each command, its seconds and its
    output (with `verbose`, ptxas's report of every kernel's registers,
    stack frame and spills) go to build.log in BUILD_DIR."""
    global BUILD_SECONDS
    outs = [(cu, BUILD_DIR / f'lib{cu.stem}_{_digest(cu)}.so')
            for cu in sorted(CSRC_DIR.glob('*.cu'))]
    todo = [(cu, out) for cu, out in outs if not out.is_file()]
    if not todo:
        return [out for _, out in outs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    t0 = time.perf_counter()
    try:
        for cu, out in todo:
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ['-Xptxas', '-v']
            cmd += ['-o', tmp, str(cu)]
            # nvcc's output goes to a file, so that a long ptxas report
            # cannot fill a pipe while the others are polled
            log = tempfile.TemporaryFile('w+', dir=BUILD_DIR)
            jobs.append((cmd, tmp, out, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        seconds = {}
        while len(seconds) < len(jobs):
            for cmd, *_, proc in jobs:
                if cmd[-1] not in seconds and proc.poll() is not None:
                    seconds[cmd[-1]] = time.perf_counter() - t0
            time.sleep(0.05)
        results = []
        for cmd, tmp, out, log, proc in jobs:
            log.seek(0)
            results.append((cmd, tmp, out, proc.returncode, '', log.read()))
            log.close()
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    BUILD_SECONDS = time.perf_counter() - t0
    (BUILD_DIR / 'build.log').write_text(''.join(
        ' '.join(cmd) + f'\n{seconds[cmd[-1]]:.3f} s\n' + so + se
        for cmd, _, _, _, so, se in results))
    failed = []
    for cmd, tmp, out, rc, so, se in results:
        if rc != 0:
            os.unlink(tmp)
            failed.append(f'{cmd[-1]}: nvcc failed ({rc}):\n{se[-4000:]}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return [out for _, out in outs]


def library(verbose: bool = False) -> types.SimpleNamespace:
    """The kernels' C entry points (`SIGNATURES`), from the libraries
    built on first use."""
    global _LIB
    if _LIB is None:
        libs = [ctypes.CDLL(str(p)) for p in build(verbose)]
        entries = {}
        for name, argtypes in SIGNATURES.items():
            fn = next(getattr(lib, name) for lib in libs
                      if hasattr(lib, name))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            entries[name] = fn
        _LIB = types.SimpleNamespace(**entries)
    return _LIB


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')
