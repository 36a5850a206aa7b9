// The fused backward kernel's lane-params entry points, altro_backward_fused_lanes_*
// (per-instance params, csrc/altro_abi.h:AltroLanes); the kernel is in
// backward_fused.cuh.
#include "backward_fused.cuh"

extern "C" {

#define ALTRO_BACKWARD_LANES_ENTRY(NAME, MODEL, T)                                                  \
  int altro_backward_fused_lanes_##NAME(const AltroBackwardArgs* args, const AltroProblem* prob,    \
                                        const AltroLanes* lanes, const AltroLanes* lanes_dev,       \
                                        const void* lane_tab, void* stream) {                       \
    return altro::launch_backward<T, altro::MODEL, true>(args, prob, stream, lanes, lanes_dev, lane_tab); \
  }
ALTRO_BACKWARD_LANES_ENTRY(unicycle_f32, Unicycle, float)
ALTRO_BACKWARD_LANES_ENTRY(unicycle_f64, Unicycle, double)
ALTRO_BACKWARD_LANES_ENTRY(cartpole_f32, Cartpole, float)
ALTRO_BACKWARD_LANES_ENTRY(cartpole_f64, Cartpole, double)
ALTRO_BACKWARD_LANES_ENTRY(quadrotor_f32, Quadrotor, float)
ALTRO_BACKWARD_LANES_ENTRY(quadrotor_f64, Quadrotor, double)
ALTRO_BACKWARD_LANES_ENTRY(triple_integrator2_f32, TripleIntegrator2, float)
ALTRO_BACKWARD_LANES_ENTRY(triple_integrator2_f64, TripleIntegrator2, double)
#undef ALTRO_BACKWARD_LANES_ENTRY

}  // extern "C"
