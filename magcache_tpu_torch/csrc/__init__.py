"""Kernel sources: CUDA C++ (``*.cu``, built by ``ops/build.py``) and Triton
(``prologue_triton.py``, imported only by the launching wrappers)."""
