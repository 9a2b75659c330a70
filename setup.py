"""Build the native extensions:

    python setup.py build_ext --inplace

* humid_tpu.cluster._ccluster — CSR clustering with the reference's exact
  traversal semantics (csrc/cluster.cpp).
* humid_tpu.io._cfastqio — bulk FastQ record framing (csrc/fastqio.cpp).

Both are optional: the pure-Python/numpy fallbacks produce identical
results.
"""

import os

from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext

_HAVE_DEFLATE = os.path.exists("/usr/include/libdeflate.h")


class BuildExt(build_ext):
    """Links OpenMP the way this compiler can: ``-fopenmp`` at link time
    reads the compiler's ``libgomp.spec``, which some compiler installs
    lack although the system's libgomp runtime is present — then the
    runtime is linked directly."""

    def build_extensions(self):
        link = self._openmp_link_args()
        for ext in self.extensions:
            if "-fopenmp" in ext.extra_link_args:
                ext.extra_link_args = [
                    a for a in ext.extra_link_args if a != "-fopenmp"] + link
        super().build_extensions()

    def _openmp_link_args(self):
        os.makedirs(self.build_temp, exist_ok=True)
        src = os.path.join(self.build_temp, "omp_probe.cpp")
        with open(src, "w") as f:
            f.write("#include <omp.h>\n"
                    "int probe() { return omp_get_max_threads(); }\n")
        objs = self.compiler.compile([src], output_dir=self.build_temp,
                                     extra_postargs=["-fopenmp", "-fPIC"])
        for args in (["-fopenmp"], ["-l:libgomp.so.1"]):
            try:
                self.compiler.link_shared_object(
                    objs, os.path.join(self.build_temp, "omp_probe.so"),
                    extra_postargs=args, target_lang="c++")
                return args
            except Exception:
                continue
        raise RuntimeError("no OpenMP runtime to link the extensions with")

setup(
    name="humid_tpu",
    version="0.1.0",
    packages=[
        "humid_tpu",
        "humid_tpu.cluster",
        "humid_tpu.io",
        "humid_tpu.ops",
        "humid_tpu.parallel",
    ],
    cmdclass={"build_ext": BuildExt},
    entry_points={
        "console_scripts": ["humid-tpu = humid_tpu.cli:main"],
    },
    ext_modules=[
        Extension(
            "humid_tpu.cluster._ccluster",
            sources=["csrc/cluster.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-fopenmp"],
            extra_link_args=["-fopenmp"],
        ),
        Extension(
            "humid_tpu.io._cfastqio",
            sources=["csrc/fastqio.cpp"],
            extra_compile_args=(
                ["-O3", "-std=c++17"]
                + (["-DHAVE_LIBDEFLATE"] if _HAVE_DEFLATE else [])
            ),
            libraries=["deflate"] if _HAVE_DEFLATE else [],
        ),
        Extension(
            "humid_tpu._hostops",
            sources=["csrc/hostops.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-fopenmp"],
            extra_link_args=["-fopenmp"],
        ),
    ],
)
