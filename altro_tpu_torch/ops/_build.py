"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

`load()` compiles every `csrc/*.cu` into `_build/libaltro_kernels.so` on
first use and again whenever a source (or the flags) change, then loads the
library and checks that the ctypes structs below match the C layout of
`csrc/altro_abi.h`.  Nothing here runs at import: the tests import every
module on machines without nvcc or a card.

There is no fallback: without nvcc, or on a failed build, `load()` raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libaltro_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register and spill report, kept in KernelLibrary.build_log
)

# csrc/altro_abi.h
MAX_FAMS = 4
NMAX = 8
GOAL, CONTROL_BOUND = 0, 1
CONE_ZERO, CONE_NEGATIVE_ORTHANT = 0, 1

_int, _dbl, _ptr = ctypes.c_int, ctypes.c_double, ctypes.c_void_p


class CostFam(ctypes.Structure):
    _fields_ = [("k0", _int), ("k1", _int), ("stacked", _int), ("offset", _int)]


class ConFam(ctypes.Structure):
    _fields_ = [
        ("kind", _int), ("cone", _int), ("k0", _int), ("k1", _int), ("p", _int),
        ("stage_row", _int), ("stage_fam", _int), ("term_row", _int), ("term_fam", _int),
        ("lo_mask", _int), ("hi_mask", _int),
        ("a", _dbl * NMAX), ("b", _dbl * NMAX),
    ]


class Problem(ctypes.Structure):
    _fields_ = [
        ("N", _int), ("method", _int), ("n_cost", _int), ("n_con", _int),
        ("gain_limit", _dbl), ("state_max2", _dbl), ("control_max2", _dbl),
        ("cost", CostFam * MAX_FAMS), ("con", ConFam * MAX_FAMS),
    ]


class BackwardArgs(ctypes.Structure):
    _fields_ = [
        (name, _ptr) for name in (
            "cost_tab", "t", "h", "X", "U", "rho", "lam", "lam_rho", "lamT", "lamT_rho",
            "K", "d", "dV1", "dV2", "J0", "failed",
        )
    ] + [(name, _int) for name in ("B", "Ps", "Fs", "Pt", "Ft")]


class ForwardArgs(ctypes.Structure):
    _fields_ = [
        (name, _ptr) for name in (
            "cost_tab", "t", "h", "x0", "alpha", "X", "U", "K", "d",
            "lam", "lam_rho", "lamT", "lamT_rho", "Xn", "Ubar", "J", "valid", "status",
        )
    ] + [(name, _int) for name in ("B", "Ps", "Fs", "Pt", "Ft", "check_bounds")]


ENTRY_POINTS = (
    "altro_backward_fused_unicycle_f32",
    "altro_backward_fused_unicycle_f64",
    "altro_forward_unicycle_f32",
    "altro_forward_unicycle_f64",
)


class KernelLibrary:
    """The loaded kernel library; `build_seconds` is 0 when an up-to-date
    build was found, `build_log` holds nvcc's report of the last build."""

    def __init__(self, lib: ctypes.CDLL, build_seconds: float, build_log: str):
        self.lib = lib
        self.build_seconds = build_seconds
        self.build_log = build_log

    def launch(self, name: str, args: ctypes.Structure, prob_ptr: int, stream: int) -> None:
        """Call one entry point; raise on a refused launch."""
        err = getattr(self.lib, name)(ctypes.addressof(args), prob_ptr, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels "
        "of altro_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*")):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def build() -> tuple[Path, float, str]:
    """Compile the library unless an up-to-date one exists; returns
    (path, seconds spent compiling, nvcc's output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib_path, 0.0, ""
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    return lib_path, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build if needed, load, declare the C signatures and check the ABI."""
    path, seconds, log = build()
    lib = ctypes.CDLL(str(path))
    lib.altro_abi_sizes.argtypes = [_ptr]
    lib.altro_abi_sizes.restype = None
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [_ptr, _ptr, _ptr]  # args (host), problem (device), stream
        fn.restype = _int
    sizes = (ctypes.c_int * 3)()
    lib.altro_abi_sizes(ctypes.addressof(sizes))
    want = (ctypes.sizeof(Problem), ctypes.sizeof(BackwardArgs), ctypes.sizeof(ForwardArgs))
    if tuple(sizes) != want:
        raise RuntimeError(f"ABI mismatch: C sizes {tuple(sizes)} vs ctypes {want}")
    return KernelLibrary(lib, seconds, log)
