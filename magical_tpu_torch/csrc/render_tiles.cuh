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
// slots 0 and 1, the arena fill and border, are always kept.  A prim has
// coverage exactly 0 outside its box, and out * (1 - 0) + c * 0 == out, so
// every tiling gives the same bytes.  At lo each thread then composites
// its pixels over the kept prims alone.  At hi (shade_tile_hi) each thread
// first classes its pixels: one SDF at a pixel's centre says whether a
// kept prim covers none, all or part of its 16 subpixels
// (class_pixel_hi).  Most pixels are decided whole, their byte the colour
// of the topmost full prim; the few that a prim's edge crosses are packed
// into a list and shaded per subpixel, from the topmost full prim up, by
// four lanes a pixel.
//
// K4's step launch counts its work where the caller asks (HiCounts): then
// it runs as render_tiles_counted_kernel, whose thread 0 of each block
// reads clock64() at the block's start, after the cull and after the
// shading (the classing included), and adds to its env's rows the cycles
// building and culling and the cycles shading, the block's active prims
// from slot 2 up and those of them it kept, and the tile's pixels and
// those of them left undecided.  Nine blocks share an env at HI_TILE, so
// the adds are atomic.  Without counters every launch runs
// render_tiles_kernel, which has none of that code.

#pragma once

#include <cuda_runtime.h>

#include "render_lo.cuh"

namespace magical_render {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;

// K4's counters, each an int64 (B, 2) array, or null: cycles {build and
// cull, shade} (core/render_kernel.py K4_PHASES), prims {active, kept}
// (K4_ITEMS) and pixels {pixels, undecided} (K4_PIXELS).
struct HiCounts {
  long long* cycles;
  long long* items;
  long long* pixels;
};

// K4's list of undecided pixels holds HI_LIST_PER_THREAD entries a thread
// (1024 at 256 threads: HI_TILE's pixels); a larger tile is classed and
// shaded in turns of that many pixels.  An entry is a pixel's index in the
// tile shifted past its start index (at most MAX_PRIMS < 256).
constexpr int HI_LIST_PER_THREAD = 4;
constexpr int HI_LIST_PIXELS = 1 << 23;  // a tile's pixels, at most
static_assert(MAX_PRIMS < 256, "a start index fits 8 bits of an entry");

// K4's shading of the tile of rows [r0, r0 + rows) and columns [c0, c0 +
// cols) over the kept prims: every thread classes a pixel at a time
// (class_pixel_hi) and writes it at once where no prim is partial above
// its start; the others go, with their start, onto `list` (a warp's by
// one atomic add, in no order, since pixels are independent).  Then four
// lanes a pixel shade the list, a row of its subpixels each
// (shade_row_hi), and add their levels by shuffles.  Returns the number of
// undecided pixels, the same in every thread.
__device__ __forceinline__ int shade_tile_hi(const SceneArgs& a,
                                             const Prim* kept,
                                             const Box* boxes, int n_kept,
                                             const Camera& cam, int b,
                                             int r0, int c0, int rows,
                                             int cols, int* list) {
  __shared__ int n_list;
  const float reach = hi_class_reach(cam);
  const unsigned lane = threadIdx.x % 32;
  const int turn = HI_LIST_PER_THREAD * blockDim.x;
  const int groups = blockDim.x / 4, i = threadIdx.x % 4;
  unsigned char* frame = a.out + (size_t)b * a.res * a.res * 3;
  int undecided = 0;
  for (int base = 0; base < rows * cols; base += turn) {
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();                     // n_list zero, the list free
    const int end = min(base + turn, rows * cols);
    for (int q0 = base; q0 < end; q0 += blockDim.x) {
      const int q = q0 + threadIdx.x;
      bool partial = false;
      int start = 0;
      if (q < end) {
        const int row = r0 + q / cols, col = c0 + q % cols;
        start = class_pixel_hi(kept, boxes, n_kept, cam, row, col, reach,
                               &partial);
        if (!partial)
          write_decided_hi(kept, start, cam,
                           frame + ((size_t)row * a.res + col) * 3);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, partial);
      int at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&n_list, __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (partial)
        list[at + __popc(ballot & ((1u << lane) - 1u))] = (q << 8) | start;
    }
    __syncthreads();                     // the list written
    const int n = n_list;
    undecided += n;
    for (int e0 = 0; e0 < n; e0 += groups) {
      const int e = e0 + threadIdx.x / 4;
      float sum[3] = {0.0f, 0.0f, 0.0f};
      int row = 0, col = 0;
      if (e < n) {
        const int q = list[e] >> 8;
        row = r0 + q / cols;
        col = c0 + q % cols;
        shade_row_hi(kept, boxes, n_kept, list[e] & 255, cam, row, col, i,
                     sum);
      }
      for (int c = 0; c < 3; ++c) {
        sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], 1);
        sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], 2);
      }
      if (e < n && i == 0) {
        unsigned char* rgb = frame + ((size_t)row * a.res + col) * 3;
        for (int c = 0; c < 3; ++c) rgb[c] = mean_level_hi(sum[c]);
      }
    }
    if (base + turn < rows * cols) __syncthreads();  // n_list read
  }
  return undecided;
}

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

  if constexpr (HI) {
    const int undecided =
        shade_tile_hi(a, kept, boxes, n_kept, cam, b, r0, c0, rows, cols,
                      reinterpret_cast<int*>(boxes + a.P));
    if constexpr (COUNT) {
      __syncthreads();                   // every pixel of the tile shaded
      if (threadIdx.x == 0) {
        const long long t_end = clock64();
        unsigned long long* cyc =
            reinterpret_cast<unsigned long long*>(counts.cycles) +
            2 * (size_t)b;
        unsigned long long* items =
            reinterpret_cast<unsigned long long*>(counts.items) +
            2 * (size_t)b;
        unsigned long long* pixels =
            reinterpret_cast<unsigned long long*>(counts.pixels) +
            2 * (size_t)b;
        atomicAdd(cyc, (unsigned long long)(t_culled - t_start));
        atomicAdd(cyc + 1, (unsigned long long)(t_end - t_culled));
        atomicAdd(items, (unsigned long long)n_active);
        // slots 0 and 1 are kept whatever their boxes
        atomicAdd(items + 1, (unsigned long long)(n_kept - min(a.P, 2)));
        atomicAdd(pixels, (unsigned long long)(rows * cols));
        atomicAdd(pixels + 1, (unsigned long long)undecided);
      }
    }
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += blockDim.x) {
      const int row = r0 + q / cols, col = c0 + q % cols;
      unsigned char* rgb =
          a.out + ((size_t)b * a.res * a.res + row * a.res + col) * 3;
      shade_pixel(kept, n_kept, cam, row, col, rgb);
    }
  }
}

template <bool HI>
__global__ void render_tiles_kernel(SceneArgs a, int row_tile, int col_tile) {
  render_tiles<HI, false>(a, row_tile, col_tile,
                          HiCounts{nullptr, nullptr, nullptr});
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
                 void* stream,
                 HiCounts counts = {nullptr, nullptr, nullptr}) {
  if (a.P > MAX_PRIMS || row_tile <= 0 || col_tile <= 0 ||
      (counts.cycles == nullptr) != (counts.items == nullptr) ||
      (counts.cycles == nullptr) != (counts.pixels == nullptr) ||
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
  if (HI && pixels >= HI_LIST_PIXELS) return (int)cudaErrorInvalidValue;
  const size_t smem =
      a.P * (sizeof(Prim) + (HI ? sizeof(Box) : 0)) +
      (HI ? HI_LIST_PER_THREAD * threads * sizeof(int) : 0);
  if constexpr (HI) {
    if (counts.cycles)
      return launch_grid(render_tiles_counted_kernel<HI>, blocks, threads,
                         smem, stream, a, row_tile, col_tile, counts);
  }
  return launch_grid(render_tiles_kernel<HI>, blocks, threads, smem, stream,
                     a, row_tile, col_tile);
}

}  // namespace magical_render
