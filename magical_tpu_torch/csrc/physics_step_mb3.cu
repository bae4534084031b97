// The control-step kernel at 3 blocks (FixColour): see physics_step.cu.

#include "physics_entry.cuh"

PHYSICS_CONTROL_STEP(3)
