"""magical_tpu_torch — the PyTorch / CUDA port of magical_tpu, the batched
MAGICAL environment engine.

It mirrors ``magical_tpu``'s module paths and function names.  The
package imports torch and numpy only; its CUDA kernels (``csrc/``) are
built on first use on a CUDA device (``_build.py``).
"""

__version__ = '0.1.0'
