"""Task registry of the port: the tasks ported so far, as data + batched
functions (``magical_tpu/tasks/__init__.py`` holds all eight)."""

from magical_tpu_torch.tasks import move_to_corner as _move_to_corner

ALL_TASKS = {
    'MoveToCorner': _move_to_corner.TASK,
}
