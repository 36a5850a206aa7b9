"""Build the native host runtime library (g++; no pybind11 required).

Usage: python -m altro_tpu_torch._native.build
The library lands in the package's build directory
(`altro_tpu_torch/_build/libaltro_native.so`, beside the CUDA kernels, not
next to the source) and is loaded lazily by `altro_tpu_torch.native`.
"""
from __future__ import annotations

import os
import pathlib
import subprocess

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src" / "altro_native.cpp"
OUT = HERE.parent / "_build" / "libaltro_native.so"


def build(verbose: bool = True) -> pathlib.Path:
    OUT.parent.mkdir(parents=True, exist_ok=True)
    # build under a name of this process's own, then rename: processes that
    # build at once never load a half-written library
    tmp = OUT.with_name(f"{OUT.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, OUT)
    finally:
        tmp.unlink(missing_ok=True)
    return OUT


if __name__ == "__main__":
    build()
    print(f"built {OUT}")
