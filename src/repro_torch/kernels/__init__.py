"""Hand-written Hopper kernels of the port.

Each kernel lives in ``kernels/<name>/`` as ``ref.py`` (the plain PyTorch
version) and ``ops.py`` (the wrapper), with its CUDA C++ source in
``kernels/csrc/``.  A wrapper takes the plain version for a tensor on the
CPU and launches the kernel for a CUDA tensor, or raises; it never falls
back.  ``_build.py`` compiles the sources with ``nvcc`` at first use.
"""
