"""Environment-name grammar.

Reproduces the reference's public naming API exactly
(benchmarks/__init__.py:275-391): names look like
``<Task>-<Variant>[-<Preproc>]-v<N>``, e.g.
``MoveToCorner-TestShape-LoRes4A-v0``.
"""

import re

_ENV_NAME_RE = re.compile(
    r'^(?P<name_prefix>[^-]+)(?P<demo_test_spec>-(Demo|Test[^-]*))'
    r'(?P<env_name_suffix>(-[^-]+)*)(?P<version_suffix>-v\d+)$')


class EnvName:
    """benchmarks/__init__.py:317-391."""

    def __init__(self, env_name):
        match = _ENV_NAME_RE.match(env_name)
        if match is None:
            raise ValueError(
                f"env name '{env_name}' does not match _ENV_NAME_RE spec")
        groups = match.groupdict()
        self.name_prefix = groups['name_prefix']
        self.demo_test_spec = groups['demo_test_spec']
        self.env_name_suffix = groups['env_name_suffix']
        self.version_suffix = groups['version_suffix']
        assert env_name == self.env_name
        if not self.is_test:
            assert self.demo_env_name == self.env_name, \
                (self.demo_env_name, self.env_name)

    @property
    def env_name(self):
        return self.name_prefix + self.demo_test_spec \
            + self.env_name_suffix + self.version_suffix

    @property
    def is_test(self):
        return self.demo_test_spec.startswith('-Test')

    @property
    def demo_env_name(self):
        return self.name_prefix + '-Demo' + self.env_name_suffix \
            + self.version_suffix

    @property
    def task(self):
        return self.name_prefix

    @property
    def variant(self):
        return self.demo_test_spec.strip('-')

    @property
    def preproc(self):
        return self.env_name_suffix.strip('-') \
            if self.env_name_suffix else None

    @property
    def version(self):
        return self.version_suffix.strip('-')


def update_magical_env_name(env_name, *, task=None, variant=None,
                            preproc=None, version=None):
    """benchmarks/__init__.py:285-314."""
    ename = EnvName(env_name)
    name_parts = []
    name_parts.append(task if task is not None else ename.task)
    name_parts.append(variant if variant is not None else ename.variant)
    if preproc is None:
        preproc = ename.preproc
    if preproc is not None:
        name_parts.append(preproc)
    name_parts.append(version if version is not None else ename.version)
    return '-'.join(name_parts)
