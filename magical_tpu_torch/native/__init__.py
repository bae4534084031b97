"""ctypes bindings for the native host-support library.

The counterpart of ``magical_tpu/native``: ``magical_native.cpp`` holds a
numpy-compatible MT19937 stream (the reference-parity reset sampler draws
from it) and a threaded INTER_AREA resize (offline demo preprocessing).
The library is built on first use with the host ``c++`` into
``build/magical_tpu_torch/`` beside the package, under a name that hashes
the source and the flags, as ``_build.py`` builds the CUDA kernels; no
library is committed.  Every entry point has a pure-numpy fallback with
identical results, taken when the library cannot be built: `backend()`
says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from magical_tpu_torch._build import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / 'magical_native.cpp'
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-shared')

_lock = threading.Lock()
_lib = None
_tried = False
# Why the library is unavailable, when it is: the compiler's message.
build_error = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f'libmagical_native_{h.hexdigest()[:16]}.so'


def _build(out: pathlib.Path):
    """Compile SOURCE into `out` with the host c++ (atomically: several
    processes may build at once)."""
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        raise RuntimeError('no host C++ compiler (c++ or g++) on PATH')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, str(SOURCE),
                               '-lpthread'], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'{cxx} failed ({proc.returncode}):\n'
                               f'{proc.stderr[-4000:]}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError) as ex:
            build_error = str(ex)
            return None
        lib.resize_area_batch.restype = None
        lib.resize_area_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
        lib.mt_new.restype = ctypes.c_void_p
        lib.mt_new.argtypes = [ctypes.c_uint32]
        lib.mt_free.restype = None
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib.mt_uniform.restype = None
        lib.mt_uniform.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_void_p,
                                   ctypes.c_int]
        lib.mt_randint.restype = None
        lib.mt_randint.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int]
        lib.mt_shuffle_indices.restype = None
        lib.mt_shuffle_indices.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def backend() -> str:
    """'native' or 'numpy': what the entry points below run on."""
    return 'native' if available() else 'numpy'


def resize_area_batch(imgs: np.ndarray, res: int,
                      n_threads: int = 8) -> np.ndarray:
    """Batched INTER_AREA downscale of (N, H, W, C) uint8 images to
    (N, res, res, C), or one (H, W, C) image; exact cv2 semantics at
    integer ratios (a box mean rounded half up)."""
    lib = _load()
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    single = imgs.ndim == 3
    if single:
        imgs = imgs[None]
    n, h, w, c = imgs.shape
    fh, fw = h // res, w // res
    if fh * res != h or fw * res != w:
        raise ValueError(f'{h}x{w} is not an integer multiple of {res}')
    if lib is None:
        x = imgs.reshape(n, res, fh, res, fw, c).astype(np.float64)
        out = np.floor(x.mean(axis=(2, 4)) + 0.5).astype(np.uint8)
    else:
        out = np.empty((n, res, res, c), np.uint8)
        lib.resize_area_batch(
            imgs.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            n, h, w, c, fh, fw, n_threads)
    return out[0] if single else out


class NativeRandomState:
    """numpy.random.RandomState-compatible MT19937 stream (native), used
    by the reference-parity reset sampler.  Falls back to numpy's own
    RandomState when the library is unavailable (identical streams)."""

    def __init__(self, seed: int):
        self._lib = _load()
        if self._lib is None:
            self._np = np.random.RandomState(seed)
            self._h = None
        else:
            self._np = None
            self._h = self._lib.mt_new(ctypes.c_uint32(seed & 0xffffffff))

    def __del__(self):
        if getattr(self, '_h', None) and self._lib is not None:
            self._lib.mt_free(self._h)
            self._h = None

    def uniform(self, low=0.0, high=1.0, size=None):
        if self._np is not None:
            return self._np.uniform(low, high, size)
        n = int(np.prod(size)) if size is not None else 1
        out = np.empty(n, np.float64)
        self._lib.mt_uniform(self._h, float(low), float(high),
                             out.ctypes.data_as(ctypes.c_void_p), n)
        if size is None:
            return float(out[0])
        return out.reshape(size)

    def randint(self, low, high=None, size=None):
        if high is None:
            low, high = 0, low
        if self._np is not None:
            return self._np.randint(low, high, size)
        n = int(np.prod(size)) if size is not None else 1
        out = np.empty(n, np.int64)
        self._lib.mt_randint(self._h, int(low), int(high),
                             out.ctypes.data_as(ctypes.c_void_p), n)
        if size is None:
            return int(out[0])
        return out.reshape(size)

    def choice(self, values, size=None):
        """RandomState.choice with uniform replacement (the only form the
        reference uses: rng.choice(arr) / rng.choice(arr, size=n))."""
        values = list(values)
        if self._np is not None:
            idx = self._np.randint(0, len(values), size)
        else:
            idx = self.randint(0, len(values), size)
        if size is None:
            return values[int(idx)]
        return [values[int(i)] for i in np.asarray(idx).ravel()]

    def shuffle(self, lst):
        n = len(lst)
        if self._np is not None:
            idx = np.arange(n)
            self._np.shuffle(idx)
        else:
            idx = np.arange(n, dtype=np.int64)
            self._lib.mt_shuffle_indices(
                self._h, idx.ctypes.data_as(ctypes.c_void_p), n)
        lst[:] = [lst[i] for i in idx]
