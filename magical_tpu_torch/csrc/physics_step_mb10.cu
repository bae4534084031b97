// The control-step kernel at 10 blocks (ClusterColour and ClusterShape):
// see physics_step.cu.

#include "physics_entry.cuh"

PHYSICS_CONTROL_STEP(10)
