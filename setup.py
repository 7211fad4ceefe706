"""Packaging (reference setup.py equivalent) + native extension build."""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Best-effort build of the native FITS tile reader (optional)."""

    def run(self):
        native = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "native")
        if os.path.exists(os.path.join(native, "Makefile")):
            try:
                subprocess.run(["make", "-C", native], check=True)
            except Exception as e:  # library is optional
                print(f"native build skipped: {e}")
        super().run()


setup(
    name="caesar-yolo-tpu",
    version="0.1.0",
    description=("TPU-native radio source detection framework "
                 "(JAX/XLA re-design of SKA-INAF/caesar-yolo)"),
    packages=find_packages(include=["caesar_yolo_tpu*", "caesar_yolo_tpu_torch*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
    extras_require={
        "train": ["orbax-checkpoint"],
        "convert": ["torch"],
        "plot": ["matplotlib"],
    },
    entry_points={
        "console_scripts": [
            "caesar-yolo-tpu=caesar_yolo_tpu.cli.run:main",
            "caesar-yolo-tpu-train=caesar_yolo_tpu.cli.train:main",
            "caesar-yolo-tpu-eval=caesar_yolo_tpu.cli.evaluate:main",
        ],
    },
    cmdclass={"build_py": BuildWithNative},
)
