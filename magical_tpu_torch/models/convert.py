"""Carry flax weights into the port's networks.

``read_flax_msgpack(path)`` reads what ``flax.serialization.to_bytes``
writes, in pure Python (no msgpack package is needed): the msgpack subset
of maps, strings, binaries, arrays, ints and floats, with flax's two
extension types for numpy data, an ndarray (ext 1) and a numpy scalar
(ext 3), each a msgpack triple (shape, dtype name, C-order bytes).  It
returns the nested dicts that ``flax.serialization.msgpack_restore``
returns, with numpy leaves.

``params_from_flax(tree)`` maps such a tree of flax params onto the
``state_dict`` names of ``models/nets.py``: convolution kernels HWIO ->
OIHW, dense kernels (in, out) -> (out, in), GroupNorm ``scale`` ->
``weight``, and boxed leaves (``{'value': array}``, as
``nn.with_partitioning`` writes them) unboxed.  A name it does not know
raises.

    net = MagicalCNN(with_value_head=True)
    net.load_state_dict(params_from_flax(read_flax_msgpack(path)))
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    """A msgpack decoder of the subset flax writes (see the module
    docstring); anything else raises, by its msgpack type name."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.buf):
            raise ValueError('msgpack: truncated input')
        out = self.buf[self.i:self.i + n]
        self.i += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    # type byte -> struct format of a fixed-size value; -> (format of the
    # length, reader) of a sized one; -> payload size of a fixext
    FIXED = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
             0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q',
             0xca: '>f', 0xcb: '>d'}
    SIZED = {0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
             0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
             0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
             0xde: ('>H', 'map'), 0xdf: ('>I', 'map'),
             0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext')}
    FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
    UNSUPPORTED = {0xc0: 'nil', 0xc2: 'false', 0xc3: 'true'}

    def value(self):
        b = self.unpack('>B')
        if b <= 0x7f:                                   # positive fixint
            return b
        if b >= 0xe0:                                   # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b in self.FIXED:
            return self.unpack(self.FIXED[b])
        if b in self.SIZED:
            fmt, read = self.SIZED[b]
            return getattr(self, read)(self.unpack(fmt))
        if b in self.FIXEXT:
            return self.ext(self.FIXEXT[b])
        raise ValueError(f'msgpack: type {self.UNSUPPORTED.get(b, hex(b))} '
                         f'is not in the subset flax.serialization writes')

    def str(self, n):
        return bytes(self.take(n)).decode('utf-8')

    def bin(self, n):
        return bytes(self.take(n))

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n):
        code = self.unpack('>b')
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f'msgpack: ext type {code} is not an ndarray '
                             f'({EXT_NDARRAY}) or numpy scalar '
                             f'({EXT_NPSCALAR})')
        inner = _Reader(data)
        shape, dtype, raw = inner.value()
        if inner.i != len(data):
            raise ValueError('msgpack: trailing bytes in an ndarray')
        if dtype == 'bfloat16':
            raise ValueError('msgpack: bfloat16 arrays are not supported')
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def read_flax_msgpack(path) -> dict:
    """The tree ``flax.serialization.msgpack_restore`` gives for the bytes
    of `path`, with numpy leaves."""
    with open(path, 'rb') as f:
        r = _Reader(f.read())
    tree = r.value()
    if r.i != len(r.buf):
        raise ValueError(f'{path}: trailing bytes after the msgpack value')
    return tree


_MODULE = re.compile(r'(conv|gn)\d+|fc|pi|v|out')


def _leaf(module: str, leaf: str, arr: np.ndarray):
    """(state_dict suffix, array in the port's layout) of one flax leaf."""
    if module.startswith('conv'):
        layout = {'kernel': ('weight', lambda k: k.transpose(3, 2, 0, 1)),
                  'bias': ('bias', None)}
    elif module.startswith('gn'):
        layout = {'scale': ('weight', None), 'bias': ('bias', None)}
    else:
        layout = {'kernel': ('weight', lambda k: k.T), 'bias': ('bias', None)}
    if leaf not in layout:
        raise KeyError(f'flax leaf {module}/{leaf} has no counterpart')
    name, fn = layout[leaf]
    return name, fn(arr) if fn else arr


def params_from_flax(tree) -> dict:
    """flax params of MagicalCNN or Discriminator (nested dicts of numpy
    arrays, under a top 'params' key or not) -> the module's state_dict
    (float32 CPU tensors)."""
    if set(tree) == {'params'}:
        tree = tree['params']
    out = {}
    for module, leaves in tree.items():
        if not _MODULE.fullmatch(module) or not isinstance(leaves, dict):
            raise KeyError(f'flax module {module!r} has no counterpart')
        for leaf, arr in leaves.items():
            if isinstance(arr, dict):
                if set(arr) != {'value'}:
                    raise KeyError(f'flax leaf {module}/{leaf}: a box with '
                                   f'{sorted(arr)}')
                arr = arr['value']
            name, arr = _leaf(module, leaf, np.asarray(arr))
            out[f'{module}.{name}'] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order='C'))
    return out
