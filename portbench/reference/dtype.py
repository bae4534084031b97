"""The reference's float type: float32, as the configurations state, and
bfloat16 inside :func:`lowered`, the control that a run's comparison has to
fail."""

import contextlib

import torch

F = torch.float32


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    """Compute the reference in `dtype`: every float tensor the frozen
    modules make, and torch's default float type, while the block runs."""
    global F
    old, old_default = F, torch.get_default_dtype()
    F = dtype
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        F = old
        torch.set_default_dtype(old_default)
