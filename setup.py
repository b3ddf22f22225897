from setuptools import setup, find_packages

setup(
    name="rustracer-tpu",
    version="0.1.0",
    description="TPU-native differentiable physically-based renderer "
                "(JAX/XLA + native C++ BVH builder), with a PyTorch + CUDA "
                "port for NVIDIA Hopper (rustracer_tpu_torch)",
    packages=find_packages(include=["rustracer_tpu", "rustracer_tpu.*",
                                    "rustracer_tpu_torch",
                                    "rustracer_tpu_torch.*"]),
    package_data={"rustracer_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                          "csrc/*.cpp"]},
    python_requires=">=3.10",
    entry_points={"console_scripts": ["rustracer-tpu=rustracer_tpu.utils.cli:main"]},
)
