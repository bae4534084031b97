// The control-step kernel at 8 blocks (MatchRegions): see physics_step.cu.

#include "physics_entry.cuh"

PHYSICS_CONTROL_STEP(8)
