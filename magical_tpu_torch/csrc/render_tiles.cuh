// The tiled render kernel behind every render entry point: K2, K3 and K5
// at lo fidelity (render_lo.cu) and K4 at hi fidelity (render_hi.cu).
// Device code; its per-prim and per-pixel arithmetic is render_lo.cuh's.
//
// One block per (env, tile of row_tile x col_tile output pixels), the
// env x tile index on gridDim.x, ragged at the frame's right and bottom
// edges, a thread per pixel of the tile (whole warps, at most 256).  The
// block's threads build the env's prims from its state and the scene's
// display program, a prim per thread (build_prim), take each prim's screen
// box on the camera's grid (prim_box) and keep the prims whose box meets
// the tile's samples (its pixels at lo, their 4x4 subpixels at hi),
// compacted into shared memory in display order by a warp ballot and a
// prefix count over the warps (no atomics, which would reorder them);
// slots 0 and 1, the arena fill and border, are always kept.  Then each
// thread composites its pixels over the kept prims alone; at hi, each row
// of a pixel's subpixels over the kept prims whose box meets that row
// (shade_pixel_hi), so a warp runs a prim only where one of its pixels
// needs it.  A prim has coverage exactly 0 outside its box, and
// out * (1 - 0) + c * 0 == out, so every tiling gives the same bytes.
//
// K4's step launch counts its work where the caller asks (HiCounts): then
// it runs as render_tiles_counted_kernel, whose thread 0 of each block
// reads clock64() at the block's start, after the cull and after the
// shading, and adds to its env's rows the cycles building and culling and
// the cycles shading, and the block's active prims from slot 2 up and
// those of them it kept.  Nine blocks share an env at HI_TILE, so the adds
// are atomic.  Without counters every launch runs render_tiles_kernel,
// which has none of that code.

#pragma once

#include <cuda_runtime.h>

#include "render_lo.cuh"

namespace magical_render {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;

// K4's counters, each an int64 (B, 2) array, or null: cycles {build and
// cull, shade} (core/render_kernel.py K4_PHASES) and prims {active, kept}
// (K4_ITEMS).
struct HiCounts {
  long long* cycles;
  long long* items;
};

// The body of both kernels: `a.res` is the output's resolution; `a.cam`
// describes the sampled grid, HI ? 4 : 1 times finer.  At hi the kept
// prims' boxes follow them in shared memory.  With COUNT, K4's counters.
template <bool HI, bool COUNT>
__device__ __forceinline__ void render_tiles(SceneArgs a, int row_tile,
                                             int col_tile, HiCounts counts) {
  static_assert(HI || !COUNT, "only K4 counts");
  extern __shared__ float smem[];
  Prim* kept = reinterpret_cast<Prim*>(smem);
  Box* boxes = reinterpret_cast<Box*>(kept + a.P);
  __shared__ int warp_kept[MAX_WARPS];
  __shared__ int n_active;
  constexpr int SUB = HI ? 4 : 1;        // grid samples a pixel side
  const int n_cols = (a.res + col_tile - 1) / col_tile;
  const int tiles = ((a.res + row_tile - 1) / row_tile) * n_cols;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int r0 = (tile / n_cols) * row_tile;
  const int c0 = (tile % n_cols) * col_tile;
  const int rows = min(row_tile, a.res - r0), cols = min(col_tile, a.res - c0);
  const Camera cam = env_camera(a, b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  long long t_start = 0, t_culled = 0;
  if constexpr (COUNT) {
    if (threadIdx.x == 0) {
      t_start = clock64();
      n_active = 0;
    }
  }

  int n_kept = 0;
  for (int base = 0; base < a.P; base += blockDim.x) {
    const int i = base + threadIdx.x;
    Prim p;
    Box box;
    bool keep = false;
    if (i < a.P) {
      build_prim(a, b, i, p);
      prim_box(p, cam, box);
      keep = i < 2 || (p.active && box_meets(box, SUB * r0, SUB * rows,
                                             SUB * c0, SUB * cols));
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    unsigned active = 0;
    if constexpr (COUNT)
      active = __ballot_sync(0xffffffffu, i >= 2 && i < a.P && p.active);
    __syncthreads();
    if constexpr (COUNT) {               // after n_active's zero
      if (lane == 0) atomicAdd(&n_active, __popc(active));
    }
    int at = n_kept, total = n_kept;
    for (int w = 0; w < warps; ++w) {
      if (w < warp) at += warp_kept[w];
      total += warp_kept[w];
    }
    if (keep) {
      const int k = at + __popc(ballot & ((1u << lane) - 1u));
      kept[k] = p;
      if (HI) boxes[k] = box;
    }
    n_kept = total;
    __syncthreads();                     // kept[] written, warp_kept free
  }
  if constexpr (COUNT) {
    if (threadIdx.x == 0) t_culled = clock64();
  }

  for (int q = threadIdx.x; q < rows * cols; q += blockDim.x) {
    const int row = r0 + q / cols, col = c0 + q % cols;
    unsigned char* rgb =
        a.out + ((size_t)b * a.res * a.res + row * a.res + col) * 3;
    if (HI)
      shade_pixel_hi(kept, boxes, n_kept, cam, row, col, rgb);
    else
      shade_pixel(kept, n_kept, cam, row, col, rgb);
  }
  if constexpr (COUNT) {
    __syncthreads();                     // every pixel of the tile shaded
    if (threadIdx.x == 0) {
      const long long t_end = clock64();
      unsigned long long* cyc =
          reinterpret_cast<unsigned long long*>(counts.cycles) + 2 * (size_t)b;
      unsigned long long* items =
          reinterpret_cast<unsigned long long*>(counts.items) + 2 * (size_t)b;
      atomicAdd(cyc, (unsigned long long)(t_culled - t_start));
      atomicAdd(cyc + 1, (unsigned long long)(t_end - t_culled));
      atomicAdd(items, (unsigned long long)n_active);
      // slots 0 and 1 are kept whatever their boxes
      atomicAdd(items + 1, (unsigned long long)(n_kept - min(a.P, 2)));
    }
  }
}

template <bool HI>
__global__ void render_tiles_kernel(SceneArgs a, int row_tile, int col_tile) {
  render_tiles<HI, false>(a, row_tile, col_tile, HiCounts{nullptr, nullptr});
}

template <bool HI>
__global__ void render_tiles_counted_kernel(SceneArgs a, int row_tile,
                                            int col_tile, HiCounts counts) {
  render_tiles<HI, true>(a, row_tile, col_tile, counts);
}

// One launch of `kernel` with its dynamic shared memory (raised past 48 KB
// where it needs more); returns the CUDA error of the launch.
template <typename Kernel, typename... Args>
int launch_grid(Kernel kernel, long long blocks, int threads, size_t smem,
                void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// Launch the kernel over (row_tile x col_tile) tiles on `stream`, with
// K4's counters where `counts` has them; returns the CUDA error of the
// launch.
template <bool HI>
int launch_tiles(const SceneArgs& a, int row_tile, int col_tile,
                 void* stream, HiCounts counts = {nullptr, nullptr}) {
  if (a.P > MAX_PRIMS || row_tile <= 0 || col_tile <= 0 ||
      (counts.cycles == nullptr) != (counts.items == nullptr) ||
      (!HI && counts.cycles))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const long long blocks = (long long)a.B *
                           ((a.res + row_tile - 1) / row_tile) *
                           ((a.res + col_tile - 1) / col_tile);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int pixels = (row_tile < a.res ? row_tile : a.res) *
                     (col_tile < a.res ? col_tile : a.res);
  const int warps = (pixels + 31) / 32;
  const int threads = 32 * (warps < MAX_WARPS ? warps : MAX_WARPS);
  const size_t smem = a.P * (sizeof(Prim) + (HI ? sizeof(Box) : 0));
  if constexpr (HI) {
    if (counts.cycles)
      return launch_grid(render_tiles_counted_kernel<HI>, blocks, threads,
                         smem, stream, a, row_tile, col_tile, counts);
  }
  return launch_grid(render_tiles_kernel<HI>, blocks, threads, smem, stream,
                     a, row_tile, col_tile);
}

}  // namespace magical_render
