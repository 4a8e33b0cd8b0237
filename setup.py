"""Package metadata (counterpart of the reference's setup.py)."""

from setuptools import find_packages, setup

setup(
    name="bayesian-torch-tpu",
    version="0.1.0",
    description=("TPU-native Bayesian neural network layers for "
                 "uncertainty estimation (JAX/flax.nnx/Pallas)"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["bayesian_torch_tpu",
                                    "bayesian_torch_tpu.*",
                                    "bayesian_torch_tpu_torch",
                                    "bayesian_torch_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these at first use;
    # scripts/ holds its launch scripts
    package_data={"bayesian_torch_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                               "scripts/*.sh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.5",
        "flax>=0.10",
        "optax",
        "orbax-checkpoint",
        "numpy",
    ],
    extras_require={
        "test": ["pytest", "torch", "scikit-learn"],
    },
    license="BSD-3-Clause",
)
