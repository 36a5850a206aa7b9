// Stand-alone Riccati backward sweep over materialized expansions: a block
// owns `lanes` batch lanes, runs each lane's sweep on a group of threads,
// and walks the horizon backwards in chunks of `knots` knots, a copy warp
// staging the next chunk's expansions in shared memory while the chunk
// before is swept.
//
// Replaces the TPU kernel riccati_pallas._kernel
// (altro_tpu/ops/riccati_pallas.py:111-187, launched by riccati_pallas
// :190-290).  Per lane, sweeping k = N-1 ... 0 from P_N = lxx[N],
// p_N = lx[N]: the knot's A, B, lxx, lxu, luu, lx, lu give the Q terms and
// one Riccati step (sweep_group.cuh:sweep_knot_group, the step the fused
// backward kernel runs too) updates the carry and gives K, d.  A pure
// function of its inputs and ρ, so the regularization retry loop can
// relaunch it.
//
// What bounds it on the H100: bytes.  Per knot a lane reads
// 2n²+2nm+m²+n+m values and writes mn+m, against about 2n³+4n²m
// operations: for the unicycle (3,2) 39 values for ~150 flops, for the
// quadrotor (13,4) 475 values for ~10,000 flops, both below the card's
// ~20 flops per byte (23 µs at N=100, B=4096 and 65 µs at N=50, B=2048 in
// f32).  The one-thread-per-lane kernel this replaces ran 13x and 200x
// slower than that: 32 blocks at B=4096 left most of the card idle, each
// knot's loads sat on the lane's chain, and at n=13 the thread's working
// set spilled 13.7 KB to local memory.  So:
//   - Blocks of 8 lanes, a group of sweep_group_size(n) threads per lane
//     (4 at (3,2), 8 at (4,1) and (6,2), 16 at (13,4)), one per row of P
//     and the Q terms, which live in shared memory (SweepScratch): B=4096
//     launches 512 blocks, B=2048 256, and at n=13 a thread's share of a
//     knot is one row, so nothing spills.
//   - One more warp copies: while the groups sweep chunk c out of one
//     shared buffer, it stages chunk c+1's A, Bd, lxx, lxu, luu, lx, lu of
//     the block's lanes into the other with cp.async (the terminal knot:
//     lxx, lx only), so no knot waits on a device-memory load.  One
//     __syncthreads per chunk.
//   - The copy width comes from B's alignment: with B·sizeof(T) a multiple
//     of 16 and every input 16-byte aligned, each entry of a knot is one or
//     two 16-byte copies of V = 16/sizeof(T) neighbouring lanes (every row
//     then starts aligned, and a last block's lanes past B fill whole
//     vectors, which are skipped); any other B (1001, 1) copies element by
//     element and skips lanes past B.  One test per launch rather than per
//     row, and no vector straddles the ragged edge; widths such as 1001 are
//     rare on the solver's paths (fleets of 4096, tails of 1024).
//   - A buffer holds one run per V lanes, [run][knot][entry][V lanes]: the
//     16-byte copies land whole, a thread's entry e sits at e·V, so the
//     row-indexed reads of a group step 16 bytes a row, and runs start 64
//     bytes apart modulo 128, in other banks.  At most two rows of a warp
//     (r and r+8) share a bank.
//   - Knots per chunk come from the wrapper (ops/riccati.py:
//     RiccatiKernel.geometry): at most STAGE_WORDS staged values, and
//     shared memory for four blocks per multiprocessor, so that B=4096 runs
//     in one wave, or two at n=13, where registers allow no more (two
//     buffers of 2 knots at (13,4) f32).
// The TPU's batch % 1024 tile rule does not apply: lanes past B compute
// on stale shared memory and store nothing.
#include <cstdint>

#include <cuda_runtime.h>

#include "altro_abi.h"
#include "fused_common.cuh"
#include "sweep_group.cuh"

namespace altro {

constexpr int kRicMaxThreads = 8 * 16 + 32;  // 8 lanes of 16 threads and the copy warp

// Blocks per multiprocessor that ptxas keeps registers for: two, except
// for the f64 n=13 sweep, which spills at the 168 registers that two
// 160-thread blocks leave it
template <typename T, int n>
constexpr int ric_min_blocks() {
  return sizeof(T) == 8 && n > 8 ? 1 : 2;
}

// Shared memory of one block: two buffers of knots × entries × lanes, then
// the sweep's per-lane scratch.  ops/riccati.py:riccati_smem mirrors it.
template <typename T, int n, int m>
struct RicLayout {
  static constexpr int G = sweep_group_size<n>();
  static constexpr int V = 16 / int(sizeof(T));  // lanes per 16-byte copy
  // entries of one staged knot
  static constexpr int A = 0, Bd = A + n * n, lxx = Bd + n * m, lxu = lxx + n * n,
                       luu = lxu + n * m, lx = luu + m * m, lu = lx + n, E = lu + m;
  int run, buf, scr, total;  // run and buffer in values; scratch offset and size in bytes
  __host__ __device__ explicit RicLayout(const AltroGeometry& g) {
    run = ((g.knots * E * V * int(sizeof(T)) + 127) / 128 * 128 + 64) / int(sizeof(T));
    buf = g.lanes / V * run;
    scr = 2 * buf * int(sizeof(T));
    total = scr + align16(g.lanes * SweepScratch<n, m>::size * int(sizeof(T)));
  }
};

// A staged knot as the shared sweep reads it: entry e of this lane at s[e·V]
template <typename T, int n, int m>
struct StagedKnot {
  using Lay = RicLayout<T, n, m>;
  static constexpr int V = Lay::V;
  const T* s;
  __device__ __forceinline__ T A(int i, int j) const { return s[(Lay::A + i * n + j) * V]; }
  __device__ __forceinline__ T Bd(int i, int j) const { return s[(Lay::Bd + i * m + j) * V]; }
  __device__ __forceinline__ T lxx(int r, int c) const { return s[(Lay::lxx + r * n + c) * V]; }
  __device__ __forceinline__ T lxu(int r, int c) const { return s[(Lay::lxu + r * m + c) * V]; }
  __device__ __forceinline__ T luu(int r, int c) const { return s[(Lay::luu + r * m + c) * V]; }
  __device__ __forceinline__ T lx(int r) const { return s[(Lay::lx + r) * V]; }
  __device__ __forceinline__ T lu(int r) const { return s[(Lay::lu + r) * V]; }
};

// Entry e of knot k in device memory (lane 0 at offset 0)
template <typename T, int n, int m>
__device__ __forceinline__ const T* entry_row(const AltroRiccatiArgs& a, int k, int e) {
  using Lay = RicLayout<T, n, m>;
  const long Bl = a.B;
  if (e < Lay::Bd) return static_cast<const T*>(a.A) + (long(k) * n * n + e - Lay::A) * Bl;
  if (e < Lay::lxx) return static_cast<const T*>(a.Bd) + (long(k) * n * m + e - Lay::Bd) * Bl;
  if (e < Lay::lxu) return static_cast<const T*>(a.lxx) + (long(k) * n * n + e - Lay::lxx) * Bl;
  if (e < Lay::luu) return static_cast<const T*>(a.lxu) + (long(k) * n * m + e - Lay::lxu) * Bl;
  if (e < Lay::lx) return static_cast<const T*>(a.luu) + (long(k) * m * m + e - Lay::luu) * Bl;
  if (e < Lay::lu) return static_cast<const T*>(a.lx) + (long(k) * n + e - Lay::lx) * Bl;
  return static_cast<const T*>(a.lu) + (long(k) * m + e - Lay::lu) * Bl;
}

// cp.async of chunk c (sweep positions c·knots ...; position q is knot
// N − q) of the block's lanes into `dst` by the copy warp's thread ct:
// 16-byte copies of V lanes when `vec`, else one per element; knots past N,
// lanes past B, and at the terminal knot every entry but lxx and lx are
// skipped.
template <typename T, int n, int m>
__device__ __forceinline__ void stage_chunk(const AltroRiccatiArgs& a, const RicLayout<T, n, m>& lay,
                                            T* dst, int c, bool vec, int ct) {
  using Lay = RicLayout<T, n, m>;
  constexpr int V = Lay::V, E = Lay::E;
  const int N = a.N, L = a.geo.lanes, KC = a.geo.knots, b0 = blockIdx.x * L;
  const int per = vec ? L / V : L;  // copies per entry
  for (int u = ct; u < KC * E * per; u += 32) {
    const int w = u % per, e = (u / per) % E, kc = u / (per * E), pos = c * KC + kc;
    if (pos > N) break;
    const int k = N - pos;
    if (k == N && !((e >= Lay::lxx && e < Lay::lxu) || (e >= Lay::lx && e < Lay::lu))) continue;
    const T* src = entry_row<T, n, m>(a, k, e) + b0;
    if (vec) {
      if (b0 + w * V < a.B) cp_async<16>(dst + w * lay.run + (kc * E + e) * V, src + w * V);
    } else if (b0 + w < a.B) {
      cp_async<int(sizeof(T))>(dst + w / V * lay.run + (kc * E + e) * V + w % V, src + w);
    }
  }
}

// The sweep's groups are threads 0 .. lanes·G − 1 (lane l = tid / G, row
// r = tid % G); the copy warp follows them.  Chunk c is staged in
// iteration c and swept in iteration c + 1, from the other buffer; the
// barrier ends each iteration.
template <typename T, int n, int m>
__global__ void __launch_bounds__(kRicMaxThreads, (ric_min_blocks<T, n>()))
    riccati_kernel(AltroRiccatiArgs a) {
  using Lay = RicLayout<T, n, m>;
  constexpr int G = Lay::G, V = Lay::V;
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay lay(a.geo);
  T* bufs = reinterpret_cast<T*>(smem);
  const int N = a.N, L = a.geo.lanes, KC = a.geo.knots;
  const int ncons = L * G;
  const int tid = threadIdx.x;
  const int chunks = (N + KC) / KC;  // positions 0 .. N
  const int l = tid / G, r = tid % G;
  const bool cons = tid < ncons;
  const int b = blockIdx.x * L + l;
  const T rho = cons && b < a.B ? static_cast<const T*>(a.rho)[b] : T(0);
  const T glim = T(a.gain_limit);
  T* sc = reinterpret_cast<T*>(smem + lay.scr) + (cons ? l : 0) * SweepScratch<n, m>::size;
  const T* mine = bufs + l / V * lay.run + l % V;  // this lane's entries in buffer 0
  T* Ko = static_cast<T*>(a.K);
  T* dout = static_cast<T*>(a.d);
  SweepCarry<T> cy;

  const std::uintptr_t ptrs =
      reinterpret_cast<std::uintptr_t>(a.A) | reinterpret_cast<std::uintptr_t>(a.Bd) |
      reinterpret_cast<std::uintptr_t>(a.lxx) | reinterpret_cast<std::uintptr_t>(a.lxu) |
      reinterpret_cast<std::uintptr_t>(a.luu) | reinterpret_cast<std::uintptr_t>(a.lx) |
      reinterpret_cast<std::uintptr_t>(a.lu);
  const bool vec = (long(a.B) * long(sizeof(T))) % 16 == 0 && (ptrs & 15u) == 0;

  for (int c = 0; c <= chunks; ++c) {
    if (!cons) {
      if (c < chunks) stage_chunk<T, n, m>(a, lay, bufs + (c & 1) * lay.buf, c, vec, tid - ncons);
      cp_async_commit();
      cp_async_wait<0>();
    } else if (c > 0) {
      const T* buf = mine + ((c - 1) & 1) * lay.buf;
      for (int kc = 0; kc < KC; ++kc) {
        const int pos = (c - 1) * KC + kc;
        if (pos > N) break;
        const StagedKnot<T, n, m> src{buf + kc * Lay::E * V};
        if (pos == 0) {
          sweep_terminal_group<T, n, m>(src, sc, r);
        } else {
          sweep_knot_group<T, n, m>(src, sc, rho, glim, cy, r, Ko, dout, N - pos, b, a.B);
        }
      }
    }
    __syncthreads();
  }

  if (cons && r == 0 && b < a.B) {
    static_cast<T*>(a.dV1)[b] = cy.dv1;
    static_cast<T*>(a.dV2)[b] = cy.dv2;
    static_cast<int*>(a.failed)[b] = cy.failed ? 1 : 0;
  }
}

template <typename T, int n, int m>
int launch_riccati(const AltroRiccatiArgs* args, void* stream) {
  using Lay = RicLayout<T, n, m>;
  const AltroGeometry& g = args->geo;
  if (g.group != Lay::G || g.lanes < 1 || g.lanes % Lay::V != 0 || g.lanes * Lay::G % 32 != 0 ||
      g.knots < 1 || g.threads != g.lanes * Lay::G + 32 || g.threads > kRicMaxThreads ||
      g.tab_smem != 0 || Lay(g).total != g.smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (args->B + g.lanes - 1) / g.lanes;
  if (grid > 0) {
    static int smem_set = 48 * 1024;  // the most dynamic shared memory allowed so far
    if (g.smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          riccati_kernel<T, n, m>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = g.smem;
    }
    riccati_kernel<T, n, m><<<grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(*args);
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
