"""Kernel sources: CUDA C++ (``*.cu`` and their ``*.cuh`` headers), built
by ``ops/build.py``."""
