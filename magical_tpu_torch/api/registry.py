"""Environment registry: all 366 env IDs + the demo->test map.

The PyTorch counterpart of ``magical_tpu/api/registry.py``, mirroring
register_envs (benchmarks/__init__.py:394-1049): 60 base IDs (8 tasks x
their variants), x5 preprocessed IDs each, +6 MoveToCorner DebugReward IDs.
"""

import collections

from magical_tpu_torch.api.names import EnvName, update_magical_env_name
from magical_tpu_torch.core.preproc import AVAILABLE_PREPROCESSORS
from magical_tpu_torch.tasks import REGISTRATION_ORDER, TASK_VARIANTS

_REGISTERED = False
ALL_REGISTERED_ENVS = []
DEMO_ENVS_TO_TEST_ENVS_MAP = collections.OrderedDict()


def register_envs():
    """Populate ALL_REGISTERED_ENVS / DEMO_ENVS_TO_TEST_ENVS_MAP.  Safe to
    call multiple times (returns False on repeat, like the reference)."""
    global _REGISTERED
    if _REGISTERED:
        return False
    _REGISTERED = True

    for task_name in REGISTRATION_ORDER:
        for variant in TASK_VARIANTS[task_name]:
            base = f'{task_name}-{variant}-v0'
            ALL_REGISTERED_ENVS.append(base)
            for preproc in AVAILABLE_PREPROCESSORS:
                ALL_REGISTERED_ENVS.append(
                    update_magical_env_name(base, preproc=preproc))

    train_to_test = {}
    observed_demo = set()
    for name in ALL_REGISTERED_ENVS:
        parsed = EnvName(name)
        if parsed.is_test:
            train_to_test.setdefault(parsed.demo_env_name, []).append(
                parsed.env_name)
        else:
            observed_demo.add(parsed.env_name)
    train_to_test = {k: tuple(v) for k, v in train_to_test.items()}
    assert observed_demo == set(train_to_test.keys())
    DEMO_ENVS_TO_TEST_ENVS_MAP.update(sorted(train_to_test.items()))

    # MoveToCorner debug-reward envs (benchmarks/__init__.py:1021-1047)
    debug_name = 'MoveToCorner-Demo-DebugReward-v0'
    ALL_REGISTERED_ENVS.append(debug_name)
    for preproc in AVAILABLE_PREPROCESSORS:
        ALL_REGISTERED_ENVS.append(
            f'MoveToCorner-Demo-DebugReward-{preproc}-v0')

    # gymnasium / gym entry points when a host library is available
    # (benchmarks/__init__.py:976-999); no-op otherwise.
    from magical_tpu_torch.api.gym_interop import register_gym_envs
    register_gym_envs(ALL_REGISTERED_ENVS)
    return True


def make(env_name: str, batched: bool = False, **kwargs):
    """gym.make equivalent.  By default returns the single-env Gym-style
    adapter; pass batched=True for the native BatchedEnv.  Keyword
    arguments (`fidelity`, `device`) go to the env, which runs on the card
    unless `device='cpu'` is given (and raises without a card)."""
    register_envs()
    if env_name not in ALL_REGISTERED_ENVS:
        raise KeyError(f'unknown env id {env_name!r}')
    if batched:
        from magical_tpu_torch.api.batched_env import BatchedEnv
        return BatchedEnv(env_name, **kwargs)
    from magical_tpu_torch.api.gym_env import MagicalGymEnv
    return MagicalGymEnv(env_name, **kwargs)
