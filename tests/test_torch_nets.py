"""magical_tpu_torch's networks (models/nets.py) and weight carrier
(models/convert.py) held against magical_tpu's flax modules: the flax
msgpack reader bit for bit, logits from the same params at odd and even
observation sizes in float32 and bfloat16, and flax's initialisation.
The committed JAX-trained policy on real observations is held in
tests/test_torch_policy_episode.py, beside the JAX env it needs."""

import functools
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from magical_tpu.models import nets as JN
from magical_tpu_torch.models import convert
from magical_tpu_torch.models.nets import Discriminator, MagicalCNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(REPO, 'gail_policy.msgpack')
# float32: the convolutions and sums round apart, ~1.4e-6 of the largest
# logit at most (measured over these cases); held to 1e-5.
F32_RTOL = 1e-5
# bfloat16: both sides round each layer's output to bfloat16, but XLA's
# CPU convolutions and PyTorch's accumulate in other orders, so a value
# near a rounding boundary lands one bfloat16 ulp (2^-8 relative) apart
# and the next layers carry it on: measured up to 6.5e-3 of the largest
# logit (96², 4 layers); held to 3e-2.
BF16_RTOL = 3e-2
DTYPES = {'float32': (jnp.float32, torch.float32, F32_RTOL),
          'bfloat16': (jnp.bfloat16, torch.bfloat16, BF16_RTOL)}


@functools.lru_cache(maxsize=None)
def _flax_params(kind, widths, value_head=False):
    """flax's initialisation of JN.<kind> (jitted: flax's eager init
    compiles op by op); its params do not depend on the dtype or the
    observation size."""
    obs = jnp.zeros((1, 24, 24, 12), jnp.uint8)
    if kind == 'MagicalCNN':
        net, args = JN.MagicalCNN(widths=widths,
                                  with_value_head=value_head), (obs,)
    else:
        net = JN.Discriminator(widths=widths)
        args = (obs, jnp.zeros((1,), jnp.int32))
    return jax.jit(net.init)(jax.random.PRNGKey(len(widths)), *args)


def _port_params(params):
    return convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(params)))


def _close(got, want, rtol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def test_reader_equals_flax_bit_for_bit():
    mine = convert.read_flax_msgpack(POLICY)
    with open(POLICY, 'rb') as f:
        ref = flax.serialization.msgpack_restore(f.read())
    lm = jax.tree_util.tree_leaves_with_path(mine)
    lr = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in lm] == [p for p, _ in lr] and len(lm) == 22
    for (p, a), (_, b) in zip(lm, lr):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


def test_reader_round_trips_flax_types_and_refuses_others(tmp_path):
    tree = {'a': {'x': np.arange(6, dtype=np.int32).reshape(2, 3),
                  'y': np.float32(2.5), 'z': np.zeros((0, 4), np.float64)},
            'b': np.linspace(-1, 1, 70000, dtype=np.float32)}
    path = tmp_path / 't.msgpack'
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    got = convert.read_flax_msgpack(path)
    ref = flax.serialization.msgpack_restore(path.read_bytes())
    jax.tree_util.tree_map(
        lambda a, b: (np.testing.assert_array_equal(a, b),
                      np.testing.assert_equal(a.dtype, b.dtype)), got, ref)
    assert isinstance(got['a']['y'], np.float32)
    path.write_bytes(flax.serialization.msgpack_serialize({'a': None}))
    with pytest.raises(ValueError, match='nil'):
        convert.read_flax_msgpack(path)
    path.write_bytes(flax.serialization.msgpack_serialize({'a': 1 + 2j}))
    with pytest.raises(ValueError, match='ext type 2'):
        convert.read_flax_msgpack(path)


def test_params_from_flax_names_every_leaf_or_raises():
    tree = convert.read_flax_msgpack(POLICY)
    sd = convert.params_from_flax(tree)
    net = MagicalCNN(with_value_head=True)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    k = tree['params']['conv1']['kernel']
    np.testing.assert_array_equal(sd['conv1.weight'].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd['fc.weight'].numpy(),
                                  tree['params']['fc']['kernel']['value'].T)
    np.testing.assert_array_equal(sd['gn2.weight'].numpy(),
                                  tree['params']['gn2']['scale'])
    for bad in ({'dense7': {'kernel': k}}, {'conv0': {'scale': k}},
                {'fc': {'kernel': {'value': k, 'names': k}}}):
        with pytest.raises(KeyError):
            convert.params_from_flax(bad)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('res', [24, 25, 96])
def test_policy_logits_match_flax(res, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    obs = np.random.default_rng(res).integers(0, 256, (4, res, res, 12),
                                               dtype=np.uint8)
    for widths, value_head in (((16, 32), False), ((16, 32, 32, 64), True)):
        jnet = JN.MagicalCNN(widths=widths, dtype=jdt,
                             with_value_head=value_head)
        params = _flax_params('MagicalCNN', widths, value_head)
        want = jax.jit(jnet.apply)(params, jnp.asarray(obs))
        net = MagicalCNN(widths=widths, dtype=tdt,
                         with_value_head=value_head)
        net.load_state_dict(_port_params(params))
        with torch.no_grad():
            got = net(torch.from_numpy(obs))
        if value_head:
            _close(got[0], want[0], rtol)
            _close(got[1], want[1], rtol)
            assert got[0].dtype == got[1].dtype == torch.float32
        else:
            _close(got, want, rtol)
        # a channels-first input gives the same outputs
        with torch.no_grad():
            cf = net(torch.from_numpy(obs).permute(0, 3, 1, 2))
        for a, b in zip(cf if value_head else (cf,),
                        got if value_head else (got,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('res', [24, 25, 96])
def test_discriminator_logits_match_flax(res, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    rng = np.random.default_rng(res + 1)
    obs = rng.integers(0, 256, (4, res, res, 12), dtype=np.uint8)
    act = rng.integers(0, 18, 4).astype(np.int32)
    jnet = JN.Discriminator(widths=(16, 32), dtype=jdt)
    params = _flax_params('Discriminator', (16, 32))
    want = jax.jit(jnet.apply)(params, jnp.asarray(obs),
                               jnp.asarray(act))
    net = Discriminator(widths=(16, 32), dtype=tdt)
    net.load_state_dict(_port_params(params))
    with torch.no_grad():
        got = net(torch.from_numpy(obs), torch.from_numpy(act))
    assert got.shape == (4,) and got.dtype == torch.float32
    _close(got, want, rtol)


@pytest.mark.parametrize('net_cls', [MagicalCNN, Discriminator])
def test_init_is_flax_init(net_cls):
    """The port's own initialisation has flax's distribution: kernels
    LeCun-normal truncated at 2 std (each layer's std against flax's
    sqrt(1/fan_in) within 5 standard errors, none beyond the cut), biases
    0 and GroupNorm scales 1; reproducible from the generator."""
    net = net_cls(generator=torch.Generator().manual_seed(0))
    again = net_cls(generator=torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(net.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(p, q), name
        if name.startswith('gn'):
            want = 1.0 if name.endswith('weight') else 0.0
            assert bool((p == want).all()), name
        elif name.endswith('bias'):
            assert not bool(p.any()), name
        else:
            fan_in = p[0].numel()
            std = float(p.std())
            n = p.numel()
            assert abs(std - np.sqrt(1 / fan_in)) \
                <= 5 * np.sqrt(1 / fan_in) / np.sqrt(2 * n), (name, std)
            cut = 2 * np.sqrt(1 / fan_in) / 0.87962566103423978
            assert float(p.abs().max()) <= cut * (1 + 1e-6), name
