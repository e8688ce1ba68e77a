"""PyTorch + CUDA port of magcache_tpu for NVIDIA Hopper.

The JAX package ``magcache_tpu`` is the reference this package is held
against. Module and subpackage names mirror it, so ``magcache_tpu.X.Y`` has
its counterpart at ``magcache_tpu_torch.X.Y``. The port imports ``torch``
and never ``jax`` or ``magcache_tpu``; it reads the shared calibration data
(``magcache_tpu/data/*.json``) by file path.

Slice ported so far: Wan2.1 T2V-1.3B with UniPC, dual CFG cache lanes and
MagCache E/K/R, through three hand-written kernels (``ops/attention.py``,
``ops/fused_prologue.py``; sources under ``csrc/``).
"""

__version__ = "0.1.0"
