"""Task registry of the port: the 8 MAGICAL tasks as data + batched
functions (the counterpart of ``magical_tpu/tasks/__init__.py``).

`TASK_VARIANTS` names every task family with its variants, for the env-ID
registry (api/registry.py).
"""

from magical_tpu_torch.tasks import cluster as _cluster
from magical_tpu_torch.tasks import find_dupe as _find_dupe
from magical_tpu_torch.tasks import fix_colour as _fix_colour
from magical_tpu_torch.tasks import make_line as _make_line
from magical_tpu_torch.tasks import match_regions as _match_regions
from magical_tpu_torch.tasks import move_to_corner as _move_to_corner
from magical_tpu_torch.tasks import move_to_region as _move_to_region

# Registration order matches benchmarks/__init__.py:965-973 (ClusterShape
# before ClusterColour per :815-962).
ALL_TASKS = {
    'ClusterShape': _cluster.SHAPE_TASK,
    'ClusterColour': _cluster.COLOUR_TASK,
    'FindDupe': _find_dupe.TASK,
    'FixColour': _fix_colour.TASK,
    'MakeLine': _make_line.TASK,
    'MatchRegions': _match_regions.TASK,
    'MoveToCorner': _move_to_corner.TASK,
    'MoveToRegion': _move_to_region.TASK,
}

REGISTRATION_ORDER = tuple(ALL_TASKS)

TASK_VARIANTS = {name: t.variants for name, t in ALL_TASKS.items()}
