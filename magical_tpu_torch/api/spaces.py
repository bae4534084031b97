"""Minimal gym-compatible observation/action space classes.

The counterpart of ``magical_tpu/api/spaces.py``, in numpy: duck-typed
spaces with the attributes MAGICAL users rely on (shape, dtype, low, high,
n, spaces, sample, contains), so that code written against Gym's API keeps
working without gym installed (base_env.py:97-109 uses
spaces.Box/Dict/Discrete).
"""

import collections

import numpy as np


class Space:
    def sample(self, rng=None):
        raise NotImplementedError

    def contains(self, x):
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.uint8):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype), self.shape)

    def sample(self, rng=None):
        rng = rng or np.random
        if np.issubdtype(self.dtype, np.integer):
            return rng.randint(self.low, self.high.astype(np.int64) + 1,
                               size=self.shape).astype(self.dtype)
        return rng.uniform(self.low, self.high,
                           size=self.shape).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and np.all(x >= self.low) \
            and np.all(x <= self.high)

    def __repr__(self):
        return f'Box{self.shape}'


class Discrete(Space):
    def __init__(self, n):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)
        self._rng = np.random.RandomState()

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed)
        return [seed]

    def sample(self, rng=None):
        rng = rng or self._rng
        return int(rng.randint(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f'Discrete({self.n})'


class Dict(Space):
    def __init__(self, spaces_dict):
        self.spaces = collections.OrderedDict(spaces_dict)

    def sample(self, rng=None):
        return collections.OrderedDict(
            (k, s.sample(rng)) for k, s in self.spaces.items())

    def contains(self, x):
        return all(k in x and s.contains(x[k])
                   for k, s in self.spaces.items())

    def __repr__(self):
        return f'Dict({list(self.spaces)})'
