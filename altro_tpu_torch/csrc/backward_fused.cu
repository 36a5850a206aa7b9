// The fused backward kernel's shared-param entry points (backward_fused.cuh has the
// kernel; backward_fused_lanes.cu instantiates its lane-params kernels, so that
// nvcc builds the two halves in parallel).
#include "backward_fused.cuh"

namespace altro {

// out[i] = comp_circle(dx[i], dy[i], r[i]): the circle rows' arithmetic
// alone (altro_circle_rows_*), one thread per row
template <typename T>
__global__ void circle_rows_kernel(const T* __restrict__ dx, const T* __restrict__ dy,
                                   const T* __restrict__ r, T* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = comp_circle(dx[i], dy[i], r[i]);
}

template <typename T>
int launch_circle_rows(const T* dx, const T* dy, const T* r, T* out, int count, void* stream) {
  if (count > 0) {
    circle_rows_kernel<T><<<(count + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        dx, dy, r, out, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace altro

extern "C" {

int altro_circle_rows_f32(const float* dx, const float* dy, const float* r, float* out, int count,
                          void* stream) {
  return altro::launch_circle_rows(dx, dy, r, out, count, stream);
}

int altro_circle_rows_f64(const double* dx, const double* dy, const double* r, double* out,
                          int count, void* stream) {
  return altro::launch_circle_rows(dx, dy, r, out, count, stream);
}

void altro_abi_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(AltroProblem));
  out[1] = static_cast<int>(sizeof(AltroBackwardArgs));
  out[2] = static_cast<int>(sizeof(AltroForwardArgs));
  out[3] = static_cast<int>(sizeof(AltroRiccatiArgs));
  out[4] = static_cast<int>(sizeof(AltroLanes));
}

void altro_model_ops(int* out) {
  const int ops[8] = {altro::Unicycle::kFOps,          altro::Unicycle::kTangentOps,
                      altro::Cartpole::kFOps,          altro::Cartpole::kTangentOps,
                      altro::Quadrotor::kFOps,         altro::Quadrotor::kTangentOps,
                      altro::TripleIntegrator2::kFOps, altro::TripleIntegrator2::kTangentOps};
  for (int i = 0; i < 8; ++i) out[i] = ops[i];
}

#define ALTRO_BACKWARD_ENTRY(NAME, MODEL, T)                                               \
  int altro_backward_fused_##NAME(const AltroBackwardArgs* args, const AltroProblem* prob, \
                                  void* stream) {                                          \
    return altro::launch_backward<T, altro::MODEL>(args, prob, stream);                    \
  }
ALTRO_BACKWARD_ENTRY(unicycle_f32, Unicycle, float)
ALTRO_BACKWARD_ENTRY(unicycle_f64, Unicycle, double)
ALTRO_BACKWARD_ENTRY(cartpole_f32, Cartpole, float)
ALTRO_BACKWARD_ENTRY(cartpole_f64, Cartpole, double)
ALTRO_BACKWARD_ENTRY(quadrotor_f32, Quadrotor, float)
ALTRO_BACKWARD_ENTRY(quadrotor_f64, Quadrotor, double)
ALTRO_BACKWARD_ENTRY(triple_integrator2_f32, TripleIntegrator2, float)
ALTRO_BACKWARD_ENTRY(triple_integrator2_f64, TripleIntegrator2, double)
#undef ALTRO_BACKWARD_ENTRY

}  // extern "C"
