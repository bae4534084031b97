// The control-step kernel at 4 blocks (MakeLine): see physics_step.cu.

#include "physics_entry.cuh"

PHYSICS_CONTROL_STEP(4)
