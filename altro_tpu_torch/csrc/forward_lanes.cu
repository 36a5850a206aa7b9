// The forward kernel's lane-params entry points, altro_forward_lanes_*
// (per-instance params, csrc/altro_abi.h:AltroLanes); the kernel is in
// forward.cuh.
#include "forward.cuh"

extern "C" {

#define ALTRO_FORWARD_LANES_ENTRY(NAME, MODEL, T)                                                  \
  int altro_forward_lanes_##NAME(const AltroForwardArgs* args, const AltroProblem* prob,           \
                                 const AltroLanes* lanes, const AltroLanes* lanes_dev,             \
                                 const void* lane_tab, void* stream) {                             \
    return altro::launch_forward<T, altro::MODEL, true>(args, prob, stream, lanes, lanes_dev, lane_tab); \
  }
ALTRO_FORWARD_LANES_ENTRY(unicycle_f32, Unicycle, float)
ALTRO_FORWARD_LANES_ENTRY(unicycle_f64, Unicycle, double)
ALTRO_FORWARD_LANES_ENTRY(cartpole_f32, Cartpole, float)
ALTRO_FORWARD_LANES_ENTRY(cartpole_f64, Cartpole, double)
ALTRO_FORWARD_LANES_ENTRY(quadrotor_f32, Quadrotor, float)
ALTRO_FORWARD_LANES_ENTRY(quadrotor_f64, Quadrotor, double)
ALTRO_FORWARD_LANES_ENTRY(triple_integrator2_f32, TripleIntegrator2, float)
ALTRO_FORWARD_LANES_ENTRY(triple_integrator2_f64, TripleIntegrator2, double)
#undef ALTRO_FORWARD_LANES_ENTRY

}  // extern "C"
