"""Micro-benchmark harness (`altro_tpu/utils/benchmarking.py`).

Analog of `altro/utils/benchmarking.hpp:21-113`: run a callable N times and
report mean/median/std/min/max.  Kernel launches return before the device
has finished, so with `block` each call is followed by a device
synchronisation when CUDA is in use (the JAX version blocks on the result);
one warm-up call first leaves out the kernels' build and the caches'
filling.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass
class BenchmarkResults:
    samples_ms: np.ndarray

    @property
    def mean(self) -> float:
        return float(self.samples_ms.mean())

    @property
    def median(self) -> float:
        return float(np.median(self.samples_ms))

    @property
    def std(self) -> float:
        return float(self.samples_ms.std())

    @property
    def min(self) -> float:
        return float(self.samples_ms.min())

    @property
    def max(self) -> float:
        return float(self.samples_ms.max())

    def __repr__(self) -> str:
        return (
            f"BenchmarkResults(mean={self.mean:.3f}ms, median={self.median:.3f}ms, "
            f"std={self.std:.3f}, min={self.min:.3f}, max={self.max:.3f}, "
            f"n={len(self.samples_ms)})"
        )


def _wait(block: bool) -> None:
    if block and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(
    fn: Callable[[], Any],
    samples: int = 10,
    warmup: int = 1,
    block: bool = True,
) -> BenchmarkResults:
    """Time `fn()` `samples` times (milliseconds)."""
    for _ in range(warmup):
        fn()
        _wait(block)
    times = np.zeros(samples)
    for i in range(samples):
        t0 = time.perf_counter()
        fn()
        _wait(block)
        times[i] = (time.perf_counter() - t0) * 1e3
    return BenchmarkResults(samples_ms=times)
