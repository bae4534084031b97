"""magical_tpu_torch.native against numpy's RandomState, the box mean and
magical_tpu.native: the MT19937 stream and the INTER_AREA resize on both
backends (the library built with the host c++, and the numpy fallback)."""

import numpy as np
import pytest

from magical_tpu import native as jax_native
from magical_tpu_torch import native
from magical_tpu_torch._build import BUILD_DIR

SEEDS = (0, 7, 42, 2 ** 31 - 2)


@pytest.fixture(params=['native', 'numpy'])
def backend(request, monkeypatch):
    """Run the test on the native library, then on the numpy fallback."""
    if request.param == 'numpy':
        monkeypatch.setattr(native, '_load', lambda: None)
    else:
        assert native.available(), native.build_error
    assert native.backend() == request.param
    return request.param


def test_library_is_built_into_the_build_dir():
    assert native.available(), native.build_error
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.is_file()
    # the name hashes the source and the flags
    assert path.name.startswith('libmagical_native_')


@pytest.mark.parametrize('seed', SEEDS)
def test_mt19937_matches_numpy_randomstate(backend, seed):
    a = native.NativeRandomState(seed)
    b = np.random.RandomState(seed)
    assert a.uniform(0, 1) == b.uniform(0, 1)
    np.testing.assert_array_equal(a.uniform(-2, 3, (6,)),
                                  b.uniform(-2, 3, 6))
    np.testing.assert_array_equal(a.randint(0, 10, (8,)),
                                  b.randint(0, 10, 8))
    assert a.randint(1, 3) == b.randint(1, 3)
    # a range past 32 bits draws two words a number
    np.testing.assert_array_equal(a.randint(0, 2 ** 40, (4,)),
                                  b.randint(0, 2 ** 40, 4))
    la, lb = list(range(11)), np.arange(11)
    a.shuffle(la)
    b.shuffle(lb)
    assert la == lb.tolist()
    assert a.choice(list('rgby'), size=5) == \
        b.choice(np.asarray(list('rgby'), dtype=object), size=5).tolist()
    assert a.uniform(-1, 1) == b.uniform(-1, 1)


@pytest.mark.parametrize('seed', SEEDS)
def test_stream_matches_the_jax_packages(backend, seed):
    """The same calls on the port's and magical_tpu's streams give the
    same numbers."""
    a, b = native.NativeRandomState(seed), jax_native.NativeRandomState(seed)
    for _ in range(3):
        assert a.uniform(-0.5, 0.5) == b.uniform(-0.5, 0.5)
        np.testing.assert_array_equal(a.randint(0, 4, (7,)),
                                      b.randint(0, 4, (7,)))
        assert a.choice([3, 1, 2, 0]) == b.choice([3, 1, 2, 0])
        la, lb = list(range(9)), list(range(9))
        a.shuffle(la)
        b.shuffle(lb)
        assert la == lb


@pytest.mark.parametrize('shape,res', [((3, 64, 64, 3), 16),
                                       ((2, 384, 384, 3), 96),
                                       ((32, 32, 3), 8)])
def test_resize_matches_the_box_mean(backend, shape, res):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    out = native.resize_area_batch(img, res)
    x = img if img.ndim == 4 else img[None]
    f = x.shape[1] // res
    ref = np.floor(x.reshape(len(x), res, f, res, f, 3).astype(np.float64)
                   .mean((2, 4)) + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(out, ref if img.ndim == 4 else ref[0])
    np.testing.assert_array_equal(out, jax_native.resize_area_batch(img, res))


def test_resize_rejects_a_non_integer_ratio():
    with pytest.raises(ValueError):
        native.resize_area_batch(np.zeros((1, 30, 30, 3), np.uint8), 8)
