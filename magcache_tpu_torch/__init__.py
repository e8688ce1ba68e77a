"""PyTorch + CUDA port of magcache_tpu for NVIDIA Hopper.

The JAX package ``magcache_tpu`` is the reference this package is held
against. Module and subpackage names mirror it, so ``magcache_tpu.X.Y`` has
its counterpart at ``magcache_tpu_torch.X.Y``. The port imports ``torch``
and never ``jax`` or ``magcache_tpu``; it reads the shared calibration data
(``magcache_tpu/data/*.json``) by file path.

Ported so far: Wan2.1 T2V-1.3B (UniPC, dual CFG cache lanes, MagCache
E/K/R, sequence parallelism, the UMT5 encoder and the VAE decode), Open-Sora
1.2 (STDiT3 on three routes), FLUX.1-dev / Kontext, Latte-1,
Open-Sora-Plan, CogVideoX-5B and Vchitect-XL, their VAEs, and the T5, mT5,
CLIP and SD3 text encoders (``models/{t5,clip,text}.py``). Every TPU
kernel of the JAX package has a hand-written counterpart (``ops/``; sources
under ``csrc/``).
"""

__version__ = "0.1.0"
