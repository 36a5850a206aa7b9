// The forward kernel's shared-param entry points (forward.cuh has the
// kernel; forward_lanes.cu instantiates its lane-params kernels, so that
// nvcc builds the two halves in parallel).
#include "forward.cuh"

extern "C" {

#define ALTRO_FORWARD_ENTRY(NAME, MODEL, T)                                                        \
  int altro_forward_##NAME(const AltroForwardArgs* args, const AltroProblem* prob, void* stream) {  \
    return altro::launch_forward<T, altro::MODEL>(args, prob, stream);                             \
  }
ALTRO_FORWARD_ENTRY(unicycle_f32, Unicycle, float)
ALTRO_FORWARD_ENTRY(unicycle_f64, Unicycle, double)
ALTRO_FORWARD_ENTRY(cartpole_f32, Cartpole, float)
ALTRO_FORWARD_ENTRY(cartpole_f64, Cartpole, double)
ALTRO_FORWARD_ENTRY(quadrotor_f32, Quadrotor, float)
ALTRO_FORWARD_ENTRY(quadrotor_f64, Quadrotor, double)
ALTRO_FORWARD_ENTRY(triple_integrator2_f32, TripleIntegrator2, float)
ALTRO_FORWARD_ENTRY(triple_integrator2_f64, TripleIntegrator2, double)
#undef ALTRO_FORWARD_ENTRY

}  // extern "C"
