#!/usr/bin/env python
"""Install script for the TPU-native WaveNet vocoder framework."""

from setuptools import find_packages, setup

setup(
    name="pytorchwavenetvocoder_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) WaveNet vocoder framework",
    packages=find_packages(exclude=("tests",)),
    install_requires=["jax", "numpy", "scipy", "h5py"],
    # the PyTorch + CUDA port: its kernels are built from csrc/ at first use
    package_data={"pytorchwavenetvocoder_tpu_torch": ["csrc/*.cu",
                                                       "csrc/*.cuh"]},
    extras_require={"torch": ["torch", "numpy", "scipy"]},
    entry_points={
        "console_scripts": [
            "wn-feature-extract=pytorchwavenetvocoder_tpu.bin.feature_extract:main",
            "wn-calc-stats=pytorchwavenetvocoder_tpu.bin.calc_stats:main",
            "wn-noise-shaping=pytorchwavenetvocoder_tpu.bin.noise_shaping:main",
            "wn-train=pytorchwavenetvocoder_tpu.bin.train:main",
            "wn-decode=pytorchwavenetvocoder_tpu.bin.decode:main",
        ]
    },
    python_requires=">=3.10",
)
