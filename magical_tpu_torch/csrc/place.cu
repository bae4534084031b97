// The reset's placement on the card: for every env, the first of its T
// proposed poses at which an entity fits, the Hopper kernel behind
// tasks/place_kernel.py.
//
// Replaces no Pallas kernel: the JAX package places with XLA ops
// (magical_tpu/tasks/randomize.py), and the port's plain version
// (randomize.place_from_proposals) tests all T = 128 proposals of every
// env against every placed row in (B, T, E, ...) tensors, then takes the
// first that fits.  It was added because that plain version is most of a
// randomised reset on the card: ~100 small PyTorch kernels and five
// device-to-host reads a placement (the reads prune sub-shape kinds),
// which at 4096 envs made a ClusterColour-TestAll reset 2.5 s of device
// time, ~98% of it on proposals after the first fit (it comes at index
// 0.45-1.88 on average).
//
// What bounds it on the H100: dependent scalar float math, short and data
// dependent.  A proposal's test is up to 6 of its sub-shapes against up to
// 60 placed ones, each a circle test or a SAT of 8 x 8 dot products; its
// inputs are a few KB an env, so memory traffic is negligible; and the
// work that matters ends at each env's first fit, which plain tensors
// cannot stop at without a read on the host.
//
// The design: one warp an env, up to 4 envs a block.  The warp stages the
// env's entity (its local sub-shapes) and the placed sub-shapes that its
// mask keeps, active ones only and with their edges, in shared memory
// once (place.cuh Shape, 172 bytes each: ~10 KB at ClusterColour's last
// placement).  Then the proposals go in rounds of 32, one lane a
// proposal: a lane builds one of its sub-shapes at a time in registers (16
// floats of vertices and its edges) and stops at its first wall or
// overlap; a ballot over the round's fits gives the first fitting
// proposal as its lowest set bit, and the warp stops there.  A round
// without one moves on to the next 32; after the last, the pick is T - 1,
// as in the plain version.  One launch a placement on PyTorch's current
// stream, no synchronisation, nothing allocated; the count of proposals
// tested (whole rounds) is added where the caller passes its counter.

#include <cuda_runtime.h>

#include "place.cuh"

using namespace magical_place;

namespace {

constexpr int MAX_ENVS_PER_BLOCK = 4;

// Bytes of shared memory a warp takes: its entity and E * KSUB shapes.
__host__ __device__ inline size_t warp_smem(int E) {
  return sizeof(Local) + (size_t)E * KSUB * sizeof(Shape);
}

__global__ void place_kernel(Args a) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + warp;
  if (b >= a.B) return;                  // ragged edge: whole warps
  unsigned char* mine = smem + (size_t)warp * warp_smem(a.E);
  Local& ent = *reinterpret_cast<Local*>(mine);
  Shape* placed = reinterpret_cast<Shape*>(mine + sizeof(Local));

  for (int i = lane; i < NLOCAL; i += LANES) load_local(a, b, i, ent);
  // the placed sub-shapes that take part, packed by a ballot
  int n = 0;
  for (int base = 0; base < a.E * KSUB; base += LANES) {
    const int i = base + lane;
    const bool on = i < a.E * KSUB && placed_on(a, b, i);
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (on) load_placed(a, b, i, placed[n + __popc(m & ((1u << lane) - 1u))]);
    n += __popc(m);
  }
  __syncwarp();

  int pick = a.T - 1, tested = 0;
  bool fit = false;
  for (int base = 0; base < a.T; base += LANES) {
    const int t = base + lane;
    bool ok = false;
    if (t < a.T) {
      const size_t at = (size_t)b * a.T + t;
      ok = proposal_fits(ent, placed, n, a.pos[2 * at], a.pos[2 * at + 1],
                         a.cos_a[at], a.sin_a[at]);
    }
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    tested += a.T - base < LANES ? a.T - base : LANES;
    if (m) {
      pick = base + __ffs(m) - 1;
      fit = true;
      break;
    }
  }
  if (lane == 0) {
    a.pick[b] = pick;
    a.ok[b] = fit;
    if (a.counts) {
      a.counts[2 * (size_t)b] += a.T;
      a.counts[2 * (size_t)b + 1] += tested;
    }
  }
}

}  // namespace

// The first fitting proposal of every env (place.cuh Args), on `stream`.
extern "C" int place_first_fit(const void* pos, const void* cos_a,
                               const void* sin_a, const void* ent_v,
                               const void* ent_rad, const void* ent_nv,
                               const void* ent_act, const void* pl_v,
                               const void* pl_rad, const void* pl_nv,
                               const void* pl_act, const void* mask,
                               void* pick, void* ok, void* counts, int B,
                               int T, int E, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || E < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.cos_a = static_cast<const float*>(cos_a);
  a.sin_a = static_cast<const float*>(sin_a);
  a.ent_v = static_cast<const float*>(ent_v);
  a.ent_rad = static_cast<const float*>(ent_rad);
  a.ent_nv = static_cast<const int*>(ent_nv);
  a.ent_act = static_cast<const unsigned char*>(ent_act);
  a.pl_v = static_cast<const float*>(pl_v);
  a.pl_rad = static_cast<const float*>(pl_rad);
  a.pl_nv = static_cast<const int*>(pl_nv);
  a.pl_act = static_cast<const unsigned char*>(pl_act);
  a.mask = static_cast<const unsigned char*>(mask);
  a.pick = static_cast<long long*>(pick);
  a.ok = static_cast<unsigned char*>(ok);
  a.counts = static_cast<long long*>(counts);
  a.B = B;
  a.T = T;
  a.E = E;
  // envs a block: as many as fit the 48 KB a block takes without opting
  // in, up to 4
  const size_t per = warp_smem(E);
  int envs = (int)((48 * 1024) / per);
  if (envs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (envs > MAX_ENVS_PER_BLOCK) envs = MAX_ENVS_PER_BLOCK;
  dim3 grid((B + envs - 1) / envs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  place_kernel<<<grid, envs * LANES, envs * per, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
