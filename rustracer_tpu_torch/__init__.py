"""rustracer_tpu_torch: the PyTorch + CUDA port of rustracer_tpu.

The JAX package ``rustracer_tpu`` is the reference; this package mirrors its
layout (core/, accel/, ops/, scene/, render/, integrators/) and writes the
render path's hot loops as hand kernels for NVIDIA Hopper (csrc/, bound in
cuda.py). Every kernel has a plain PyTorch version beside it, which runs for
CPU tensors and is the kernel's specification.
"""

__version__ = "0.1.0"
