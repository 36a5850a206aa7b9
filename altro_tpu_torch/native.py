"""ctypes bindings for the native host runtime, with pure-Python fallback
(`altro_tpu/native.py`).

See `_native/src/altro_native.cpp` (the JAX package's source, copied) for
what lives natively (hierarchical profiler, thread pool, scenario
generator) and why.  It is a host tool, not the device path.  The library
builds with g++ on first use into the package's build directory
(`_native/build.py`); without a toolchain everything degrades to the
Python implementations, so the package has no hard native dependency.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = pathlib.Path(__file__).resolve().parent / "_build" / "libaltro_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or (_tried and not build_if_missing):
        return _lib
    _tried = True
    try:
        if not _LIB_PATH.exists() and build_if_missing:
            from ._native.build import build

            build(verbose=False)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.altro_profiler_new.restype = ctypes.c_void_p
        lib.altro_profiler_free.argtypes = [ctypes.c_void_p]
        lib.altro_profiler_set_active.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.altro_profiler_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.altro_profiler_stop.argtypes = [ctypes.c_void_p]
        lib.altro_profiler_reset.argtypes = [ctypes.c_void_p]
        lib.altro_profiler_dump.restype = ctypes.c_int64
        lib.altro_profiler_dump.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.altro_pool_new.restype = ctypes.c_void_p
        lib.altro_pool_new.argtypes = [ctypes.c_int]
        lib.altro_pool_free.argtypes = [ctypes.c_void_p]
        lib.altro_pool_nthreads.restype = ctypes.c_int
        lib.altro_pool_nthreads.argtypes = [ctypes.c_void_p]
        lib.altro_generate_uniform.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


class NativeProfiler:
    """Hierarchical profiler backed by the C++ implementation (~40 ns/scope
    vs the reference's documented ~10 µs, `timer.hpp:20-23`)."""

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._ptr = lib.altro_profiler_new()

    def __del__(self):
        try:
            self._lib.altro_profiler_free(self._ptr)
        except Exception:
            pass

    def set_active(self, active: bool) -> None:
        self._lib.altro_profiler_set_active(self._ptr, int(active))

    def start(self, name: str) -> None:
        self._lib.altro_profiler_start(self._ptr, name.encode())

    def stop(self) -> None:
        self._lib.altro_profiler_stop(self._ptr)

    def reset(self) -> None:
        self._lib.altro_profiler_reset(self._ptr)

    class _Scope:
        def __init__(self, prof, name):
            self._prof = prof
            self._name = name

        def __enter__(self):
            self._prof.start(self._name)

        def __exit__(self, *exc):
            self._prof.stop()

    def scope(self, name: str):
        return self._Scope(self, name)

    def entries(self) -> dict[str, tuple[float, int]]:
        """{path: (total_us, count)}."""
        n = self._lib.altro_profiler_dump(self._ptr, None, 0)
        buf = ctypes.create_string_buffer(int(n) + 1)
        self._lib.altro_profiler_dump(self._ptr, buf, n + 1)
        out = {}
        for line in buf.value.decode().splitlines():
            if not line:
                continue
            key, us, count = line.split("\t")
            out[key] = (float(us), int(count))
        return out


class ScenarioGenerator:
    """Threaded batch scenario generator (native data loader).

    Fills [batch, dim] float32 arrays with per-dimension uniform samples
    without holding the GIL — feeds randomized MPC scenario sweeps to the
    device at memory-bandwidth speed.
    """

    def __init__(self, nthreads: int = 0):
        lib = load()
        self._lib = lib
        self._pool = lib.altro_pool_new(nthreads) if lib is not None else None

    def __del__(self):
        try:
            if self._pool:
                self._lib.altro_pool_free(self._pool)
        except Exception:
            pass

    @property
    def num_threads(self) -> int:
        if self._pool is None:
            return 0
        return self._lib.altro_pool_nthreads(self._pool)

    def uniform(self, batch: int, lo: Sequence[float], hi: Sequence[float], seed: int):
        lo_arr = np.asarray(lo, np.float32)
        hi_arr = np.asarray(hi, np.float32)
        dim = lo_arr.shape[0]
        out = np.empty((batch, dim), np.float32)
        if self._lib is None:
            rng = np.random.default_rng(seed)
            out[:] = rng.uniform(lo_arr, hi_arr, size=(batch, dim)).astype(np.float32)
            return out
        self._lib.altro_generate_uniform(
            self._pool,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            batch,
            dim,
            lo_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hi_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            seed,
        )
        return out
