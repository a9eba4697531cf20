"""IC-GVINS on PyTorch + CUDA: the port of ``ic_gvins_tpu`` to an NVIDIA H100.

The JAX package ``ic_gvins_tpu`` is the reference; every module here has a
twin of the same name and path there. This package imports ``torch`` and
never ``jax``, and it changes no global default dtype: image math is f32,
camera / RANSAC-normalization / triangulation math is f64, each stated at
the call. The three Pallas TPU kernels of the frontend are hand-written
CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/_build.py``).
"""

__version__ = "0.1.0"
