"""Task registry of the port: the tasks ported so far, as data + batched
functions (``magical_tpu/tasks/__init__.py`` holds all eight).

`TASK_VARIANTS` names every task family of the benchmark with its
variants, ported or not, for the env-ID registry (api/registry.py).
"""

from magical_tpu_torch.tasks import base as _base
from magical_tpu_torch.tasks import move_to_corner as _move_to_corner
from magical_tpu_torch.tasks import move_to_region as _move_to_region

ALL_TASKS = {
    'MoveToCorner': _move_to_corner.TASK,
    'MoveToRegion': _move_to_region.TASK,
}

# Registration order matches benchmarks/__init__.py:965-973 (ClusterShape
# before ClusterColour per :815-962).
REGISTRATION_ORDER = ('ClusterShape', 'ClusterColour', 'FindDupe',
                      'FixColour', 'MakeLine', 'MatchRegions',
                      'MoveToCorner', 'MoveToRegion')

TASK_VARIANTS = {name: _base.FULL_VARIANTS for name in REGISTRATION_ORDER}
TASK_VARIANTS.update({name: t.variants for name, t in ALL_TASKS.items()})
