"""magical_tpu_torch's env-ID registry and observation spaces against
magical_tpu's."""

import numpy as np
import pytest

import magical_tpu
from magical_tpu.api.batched_env import BatchedEnv as JaxEnv
from magical_tpu.core.preproc import PREPROCESSORS as JAX_PREPROCESSORS
from magical_tpu_torch.api import registry
from magical_tpu_torch.api import spaces as S
from magical_tpu_torch.api.batched_env import BatchedEnv


@pytest.fixture(scope='module', autouse=True)
def _registered():
    magical_tpu.register_envs()
    registry.register_envs()


def test_env_ids_equal_the_reference():
    assert registry.ALL_REGISTERED_ENVS == magical_tpu.ALL_REGISTERED_ENVS
    assert len(registry.ALL_REGISTERED_ENVS) == 366
    assert list(registry.DEMO_ENVS_TO_TEST_ENVS_MAP.items()) == \
        list(magical_tpu.DEMO_ENVS_TO_TEST_ENVS_MAP.items())
    assert registry.register_envs() is False          # idempotent


def _same_space(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(a, S.Dict):
        assert list(a.spaces) == list(b.spaces)
        for k in a.spaces:
            _same_space(a.spaces[k], b.spaces[k])
    elif isinstance(a, S.Box):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    else:
        assert a.n == b.n


@pytest.mark.parametrize('preproc', [None] + list(JAX_PREPROCESSORS))
def test_spaces_equal_the_reference(preproc):
    suffix = f'-{preproc}' if preproc else ''
    name = f'MoveToRegion-TestAll{suffix}-v0'
    je, te = JaxEnv(name), BatchedEnv(name, device='cpu')
    _same_space(te.observation_space, je.observation_space)
    _same_space(te.action_space, je.action_space)
    obs = te.observation_space.sample(np.random.RandomState(0))
    assert te.observation_space.contains(obs)


def test_make_returns_the_adapter_or_the_batched_env():
    env = registry.make('MoveToCorner-TestShape-LoRes4A-v0',
                        device='cpu')
    assert type(env).__name__ == 'MagicalGymEnv'
    assert env.observation_space.shape == (96, 96, 12)
    benv = registry.make('MoveToCorner-TestShape-LoRes4A-v0', batched=True,
                         fidelity='hi', device='cpu')
    assert isinstance(benv, BatchedEnv) and benv.fidelity == 'hi'
    with pytest.raises(KeyError):
        registry.make('MoveToCorner-TestLayout-v0')
