"""Package build for paddle_tpu.

Reference parity: the reference's build system is CMake + a generated
python/setup.py (SURVEY §2 L12); here the Python package installs with
setuptools and the native runtime pieces (record IO, feeder queues,
rendezvous server, C++ predictor/trainer demos) build on demand with the
system toolchain — `python setup.py build_native` prebuilds them all, or
use the CMakeLists.txt for an IDE/CI-driven native build.
"""
import os
import subprocess
import sys

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    """Prebuild every native artifact (otherwise built lazily on first
    use): libpaddle_tpu_native.so, rendezvous_server, predictor_demo,
    train_demo."""

    description = "build the C++ runtime components"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        # load native/__init__.py directly (it needs only the stdlib) so
        # the build works in a bare-toolchain env without jax installed
        import importlib.util
        root = os.path.dirname(os.path.abspath(__file__))
        spec = importlib.util.spec_from_file_location(
            "paddle_tpu.native",
            os.path.join(root, "paddle_tpu", "native", "__init__.py"))
        native = importlib.util.module_from_spec(spec)
        sys.modules.setdefault("paddle_tpu.native", native)
        spec.loader.exec_module(native)
        native.lib()
        native.build_rendezvous()
        native.build_predictor()
        native.build_trainer()
        print("native components built under paddle_tpu/native/")


def _version():
    """Single source of truth: paddle_tpu/__init__.py __version__."""
    import re
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu", "__init__.py")
    with open(path) as f:
        return re.search(r'__version__ = "([^"]+)"', f.read()).group(1)


setup(
    name="paddle_tpu",
    version=_version(),
    description=("TPU-native deep-learning framework with the PaddlePaddle "
                 "Fluid programming model (JAX/XLA/Pallas execution)"),
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={
        "paddle_tpu.native": ["*.cc", "*.h"],
        "paddle_tpu_torch.ops": ["csrc/*.cu"],
        "paddle_tpu_torch.native": ["*.cc"],
    },
    python_requires=">=3.9",
    install_requires=[
        "numpy",
        "jax",
    ],
    cmdclass={"build_native": BuildNative},
)
