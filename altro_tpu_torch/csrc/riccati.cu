// Stand-alone Riccati backward sweep over materialized expansions, one
// thread per batch lane.
//
// Replaces the TPU kernel riccati_pallas._kernel
// (altro_tpu/ops/riccati_pallas.py:111-187, launched by riccati_pallas
// :190-290).  Per lane, sweeping k = N-1 ... 0 from P_N = lxx[N],
// p_N = lx[N]: the knot's A, B, lxx, lxu, luu, lx, lu are read and one
// riccati_step (riccati_step.cuh, the same function the fused backward
// kernel calls) updates the carry and gives K, d.  A pure function of its
// inputs and ρ, so the regularization retry loop can relaunch it.
//
// What bounds it on the H100: bytes.  Per knot a lane reads
// n²+nm+n²+nm+m²+n+m values and writes mn+m, against about 2n³+4n²m
// multiply-adds: for the unicycle (3,2) 39 values read for ~150 flops, for
// the quadrotor (13,4) 475 values for ~10,000 flops, both far below the
// card's ~20 flops per byte.  The batch is the fastest axis, so every load
// and store of a warp is one coalesced 128-byte line per entry; the carry
// (P, p, ΔV, failed) stays in registers.  At (13,4) a lane's working set
// (P, A, lxx, Qxx and the products: about 700 values) exceeds the 255
// registers a thread may hold and spills to local memory (nvcc -Xptxas=-v
// reports it); keeping P and the Q terms in shared memory is left to a
// later change.  The TPU's batch % 1024 tile rule does not apply: the last
// block masks its ragged edge.
#include <cuda_runtime.h>

#include "altro_abi.h"
#include "riccati_step.cuh"

namespace altro {

constexpr int kBlock = 128;

template <typename T, int n, int m>
__global__ void __launch_bounds__(kBlock) riccati_kernel(AltroRiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int N = a.N;
  const long Bl = a.B;
  const T* __restrict__ gA = static_cast<const T*>(a.A);
  const T* __restrict__ gB = static_cast<const T*>(a.Bd);
  const T* __restrict__ glxx = static_cast<const T*>(a.lxx);
  const T* __restrict__ glxu = static_cast<const T*>(a.lxu);
  const T* __restrict__ gluu = static_cast<const T*>(a.luu);
  const T* __restrict__ glx = static_cast<const T*>(a.lx);
  const T* __restrict__ glu = static_cast<const T*>(a.lu);
  T* __restrict__ Ko = static_cast<T*>(a.K);
  T* __restrict__ dout = static_cast<T*>(a.d);
  const T glim = T(a.gain_limit);
  const T rho = static_cast<const T*>(a.rho)[b];

  T P[n * n], p[n];
#pragma unroll
  for (int i = 0; i < n * n; ++i) P[i] = glxx[(long(N) * n * n + i) * Bl + b];
#pragma unroll
  for (int i = 0; i < n; ++i) p[i] = glx[(long(N) * n + i) * Bl + b];
  T dv1 = T(0), dv2 = T(0);
  bool failed = false;

  for (int k = N - 1; k >= 0; --k) {
    T A[n * n], Bd[n * m], lxx[n * n], lxu[n * m], luu[m * m], lx[n], lu[m];
#pragma unroll
    for (int i = 0; i < n * n; ++i) A[i] = gA[(long(k) * n * n + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < n * m; ++i) Bd[i] = gB[(long(k) * n * m + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < n * n; ++i) lxx[i] = glxx[(long(k) * n * n + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < n * m; ++i) lxu[i] = glxu[(long(k) * n * m + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < m * m; ++i) luu[i] = gluu[(long(k) * m * m + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < n; ++i) lx[i] = glx[(long(k) * n + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < m; ++i) lu[i] = glu[(long(k) * m + i) * Bl + b];

    T K[m * n], d[m];
    riccati_step<T, n, m>(A, Bd, lxx, lxu, luu, lx, lu, rho, glim, P, p, dv1, dv2, failed, K, d);

#pragma unroll
    for (int i = 0; i < m * n; ++i) Ko[(long(k) * m * n + i) * Bl + b] = K[i];
#pragma unroll
    for (int i = 0; i < m; ++i) dout[(long(k) * m + i) * Bl + b] = d[i];
  }

  static_cast<T*>(a.dV1)[b] = dv1;
  static_cast<T*>(a.dV2)[b] = dv2;
  static_cast<int*>(a.failed)[b] = failed ? 1 : 0;
}

template <typename T, int n, int m>
int launch_riccati(const AltroRiccatiArgs* args, void* stream) {
  const int grid = (args->B + kBlock - 1) / kBlock;
  if (grid > 0) {
    riccati_kernel<T, n, m><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace altro

#define ALTRO_RICCATI_ENTRY(NN, MM, S, T)                                              \
  int altro_riccati_n##NN##m##MM##_##S(const AltroRiccatiArgs* args, void* stream) { \
    return altro::launch_riccati<T, NN, MM>(args, stream);                             \
  }

extern "C" {
ALTRO_RICCATI_ENTRY(3, 2, f32, float)
ALTRO_RICCATI_ENTRY(3, 2, f64, double)
ALTRO_RICCATI_ENTRY(4, 1, f32, float)
ALTRO_RICCATI_ENTRY(4, 1, f64, double)
ALTRO_RICCATI_ENTRY(6, 2, f32, float)
ALTRO_RICCATI_ENTRY(6, 2, f64, double)
ALTRO_RICCATI_ENTRY(13, 4, f32, float)
ALTRO_RICCATI_ENTRY(13, 4, f64, double)
}  // extern "C"
