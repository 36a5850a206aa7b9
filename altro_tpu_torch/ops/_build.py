"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

`load()` compiles every `csrc/*.cu` into `_build/libaltro_kernels.so` on
first use and again whenever a source (or the flags) change, one nvcc per
source, all started together, then one link.  It loads the library and
checks that the ctypes structs below match the C layout of
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register and spill report, kept in KernelLibrary.build_log
)

# csrc/altro_abi.h
MAX_FAMS = 4
NMAX = 16
NDYN = 8
GOAL, CONTROL_BOUND, CIRCLE = 0, 1, 2
CONE_ZERO, CONE_NEGATIVE_ORTHANT = 0, 1

_int, _dbl, _ptr = ctypes.c_int, ctypes.c_double, ctypes.c_void_p


class CostFam(ctypes.Structure):
    _fields_ = [("k0", _int), ("k1", _int), ("stacked", _int), ("offset", _int)]


class ConFam(ctypes.Structure):
    _fields_ = [
        ("kind", _int), ("cone", _int), ("k0", _int), ("k1", _int), ("p", _int),
        ("stage_row", _int), ("stage_fam", _int), ("term_row", _int), ("term_fam", _int),
        ("lo_mask", _int), ("hi_mask", _int), ("xi", _int), ("yi", _int),
        ("a", _dbl * NMAX), ("b", _dbl * NMAX), ("r", _dbl * NMAX),
    ]


class Problem(ctypes.Structure):
    _fields_ = [
        ("N", _int), ("method", _int), ("n_cost", _int), ("n_con", _int),
        ("gain_limit", _dbl), ("state_max2", _dbl), ("control_max2", _dbl),
        ("dyn", _dbl * NDYN), ("cost", CostFam * MAX_FAMS), ("con", ConFam * MAX_FAMS),
    ]


class LaneSrc(ctypes.Structure):
    _fields_ = [("off", _int), ("kstride", _int)]


class Lanes(ctypes.Structure):
    _fields_ = [
        ("knot_rows", _int), ("static_rows", _int), ("dyn", LaneSrc * NDYN),
        ("cost", (LaneSrc * 6) * MAX_FAMS), ("con", (LaneSrc * 3) * MAX_FAMS),
    ]


class Geometry(ctypes.Structure):
    _fields_ = [(name, _int) for name in ("lanes", "knots", "group", "threads", "smem", "tab_smem")]


class BackwardArgs(ctypes.Structure):
    _fields_ = [
        (name, _ptr) for name in (
            "cost_tab", "t", "h", "X", "U", "rho", "lam", "lam_rho", "lamT", "lamT_rho",
            "K", "d", "dV1", "dV2", "J0", "failed",
        )
    ] + [(name, _int) for name in ("B", "Ps", "Fs", "Pt", "Ft")] + [("geo", Geometry)]


class ForwardArgs(ctypes.Structure):
    _fields_ = [
        (name, _ptr) for name in (
            "cost_tab", "t", "h", "x0", "alpha", "X", "U", "K", "d",
            "lam", "lam_rho", "lamT", "lamT_rho", "Xn", "Ubar", "J", "valid", "status",
        )
    ] + [(name, _int) for name in ("B", "Ps", "Fs", "Pt", "Ft", "check_bounds", "chain_only")] + [
        (name, _ptr) for name in ("J0", "dV1", "dV2", "budget", "alpha_out", "z", "success", "tries", "counts")
    ] + [(name, _dbl) for name in ("lower", "upper", "factor")] + [("search", _int), ("geo", Geometry)]


class RiccatiArgs(ctypes.Structure):
    _fields_ = [
        (name, _ptr) for name in (
            "A", "Bd", "lxx", "lxu", "luu", "lx", "lu", "rho", "K", "d", "dV1", "dV2", "failed",
        )
    ] + [("gain_limit", _dbl), ("N", _int), ("B", _int), ("geo", Geometry)]


# (n, m) of the Riccati sweep's instantiations in csrc/riccati.cu
RICCATI_SHAPES = ((3, 2), (4, 1), (6, 2), (13, 4))
# models with a device functor in csrc/models.cuh, which the fused kernels
# are instantiated for
FUSED_MODELS = ("unicycle", "cartpole", "quadrotor", "triple_integrator2")

# entry point -> pointer arguments: (args, problem, stream) for the fused
# kernels, (args, problem, lanes on the host, lanes on the device, lane
# table, stream) for their lane-params instantiations, (args, stream) for the
# Riccati sweep
ENTRY_POINTS = {
    **{f"altro_{kind}_{model}_{s}": 3
       for kind in ("backward_fused", "forward") for model in FUSED_MODELS for s in ("f32", "f64")},
    **{f"altro_{kind}_lanes_{model}_{s}": 6
       for kind in ("backward_fused", "forward") for model in FUSED_MODELS for s in ("f32", "f64")},
    **{f"altro_riccati_n{n}m{m}_{s}": 2 for n, m in RICCATI_SHAPES for s in ("f32", "f64")},
}


class KernelLibrary:
    """The loaded kernel library; `build_seconds` is 0 when an up-to-date
    build was found, `build_log` holds nvcc's report of the last build."""

    def __init__(self, lib: ctypes.CDLL, build_seconds: float, build_log: str):
        self.lib = lib
        self.build_seconds = build_seconds
        self.build_log = build_log

    def model_ops(self) -> dict:
        """model -> (operations of one f, of one tangent of f at a point
        whose value is known): the counts written beside each functor in
        csrc/models.cuh."""
        out = (ctypes.c_int * (2 * len(FUSED_MODELS)))()
        self.lib.altro_model_ops(ctypes.addressof(out))
        return {name: (out[2 * i], out[2 * i + 1]) for i, name in enumerate(FUSED_MODELS)}

    def launch(self, name: str, args: ctypes.Structure, *ptrs: int) -> None:
        """Call one entry point with its args struct and the device
        pointers and stream that follow it; raise on a refused launch."""
        err = getattr(self.lib, name)(ctypes.addressof(args), *ptrs)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")

    def circle_rows(self, suffix: str, dx: int, dy: int, r: int, out: int, count: int,
                    stream: int) -> None:
        """altro_circle_rows_{suffix}: the fused kernels' compensated
        circle rows of `count` device values; raise on a refused launch."""
        err = getattr(self.lib, f"altro_circle_rows_{suffix}")(dx, dy, r, out, count, stream)
        if err != 0:
            raise RuntimeError(f"altro_circle_rows_{suffix}: CUDA launch failed with cudaError_t {err}")


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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails, after
    every one has ended.  Returns their joined output.  If this is
    interrupted, the commands still running are killed."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=CSRC))
        outs = [p.communicate() for p in procs]
    finally:  # interrupted (a signal, an error): leave no compiler running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    return "".join(out + err for out, err in outs)


def build() -> tuple[Path, float, str]:
    """Compile the library unless an up-to-date one exists; returns
    (path, seconds spent compiling, nvcc's output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib_path, 0.0, ""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    return lib_path, seconds, log


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build if needed, load, declare the C signatures and check the ABI."""
    path, seconds, log = build()
    lib = ctypes.CDLL(str(path))
    for name in ("altro_abi_sizes", "altro_model_ops"):
        getattr(lib, name).argtypes = [_ptr]
        getattr(lib, name).restype = None
    for name, nargs in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [_ptr] * nargs  # args (host), [problem, [lanes (host), lanes, lane table] (device),] stream
        fn.restype = _int
    for s in ("f32", "f64"):
        fn = getattr(lib, f"altro_circle_rows_{s}")
        fn.argtypes = [_ptr] * 4 + [_int, _ptr]  # dx, dy, r, out, count, stream
        fn.restype = _int
    sizes = (ctypes.c_int * 5)()
    lib.altro_abi_sizes(ctypes.addressof(sizes))
    want = (
        ctypes.sizeof(Problem), ctypes.sizeof(BackwardArgs), ctypes.sizeof(ForwardArgs),
        ctypes.sizeof(RiccatiArgs), ctypes.sizeof(Lanes),
    )
    if tuple(sizes) != want:
        raise RuntimeError(f"ABI mismatch: C sizes {tuple(sizes)} vs ctypes {want}")
    return KernelLibrary(lib, seconds, log)
