// The control-step kernel at 7 blocks (FindDupe): see physics_step.cu.

#include "physics_entry.cuh"

PHYSICS_CONTROL_STEP(7)
