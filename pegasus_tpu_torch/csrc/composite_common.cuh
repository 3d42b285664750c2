// Shared by the tile compositor's forward (composite_tiles.cu) and backward
// (composite_tiles_bwd.cu): the tile shape, the parameter rows, and the one
// expression that decides each (pixel, entry) alpha.  Both kernels include
// this function, so the backward recomputes exactly the alphas, and exactly
// the kept set, that the forward composited (built without
// --use_fast_math: expf and the float order must not change between them).

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // threads per block: one per pixel

// parameter rows (ops/binning.py P_*)
constexpr int P_MX = 0, P_MY = 1, P_CA = 2, P_CB = 3, P_CC = 4, P_OPAC = 5;
constexpr int P_R = 6, P_G = 7, P_B = 8, P_DEPTH = 9, P_RADIUS = 10, P_OBJ = 11;

// One splat's alpha at pixel (fx, fy), with the CUDA rasterizer's cutoffs:
// power > 0, alpha < 1/255 and the 3-sigma box drop the entry; alpha is
// clamped to 0.99.  Returns whether the entry is kept; dx, dy, exp(power)
// (exppow) and the unclamped alpha (raw) are what the backward chains
// through.  The products and sums are the _rn intrinsics, which the
// compiler never contracts into FMAs: the rounding is then the same in
// every kernel that inlines this function, whatever code surrounds it, and
// the same as the plain torch versions' unfused float32 arithmetic.
// pegasus_tpu_torch/tools/alpha_rounding.py times this form against the
// contracted one and counts the pairs on which contraction changes keep.
__device__ __forceinline__ bool entry_alpha(float fx, float fy, float mx,
                                            float my, float ca, float cb,
                                            float cc, float opac, float rad,
                                            float& dx, float& dy,
                                            float& exppow, float& raw,
                                            float& alpha) {
  dx = fx - mx;
  dy = fy - my;
  // -0.5 * (ca dx dx + cc dy dy) - cb dx dy, evaluated left to right
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, dx), dy));
  exppow = expf(fminf(power, 0.f));
  raw = __fmul_rn(opac, exppow);
  alpha = fminf(raw, 0.99f);
  // & rather than &&: the four tests combine into one predicate, where the
  // short-circuit form made nvcc branch and store the result in a register
  // before the caller's test, on every pair
  return (power <= 0.f) & (alpha >= 1.f / 255.f) & (fabsf(dx) <= rad) &
         (fabsf(dy) <= rad);
}

// ---- work items: each tile's segment cut into runs of at most `chunk` ----
//
// Tile t holds max(1, ceil(count_t / chunk)) items, numbered tile by tile
// in order (item i of the frame is item c of its tile, i = first_t + c).
// Both kernels launch one block per item over a grid of ceil(M / chunk) +
// n_tiles blocks, the bound ops/rasterize_cuda.py::max_items computes
// without reading the counts on the host; blocks past the last item exit.
// The table is not stored: every block derives its own (tile, first item)
// from tile_count, a scan of n_tiles ints from L2.

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ int items_of(int count, int chunk) {
  return count > chunk ? (count + chunk - 1) / chunk : 1;
}

// The tile that holds frame item `item` and the index of that tile's first
// item, for the whole block: (-1, 0) past the last item.  Thread j sums
// the items of tiles [j * per, (j + 1) * per), a warp scan and the warp
// totals give its exclusive prefix, and the one thread whose range holds
// `item` walks its tiles.  `s_warp` holds PX / 32 + 2 ints.
__device__ __forceinline__ void locate_item(const int* __restrict__ tile_count,
                                            int n_tiles, int chunk, int item,
                                            int* s_warp, int& tile,
                                            int& first) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + PX - 1) / PX;
  const int t0 = min(tid * per, n_tiles), t1 = min(t0 + per, n_tiles);
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += items_of(tile_count[t], chunk);
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  if (tid == 0) {
    s_warp[PX / 32] = -1;
    s_warp[PX / 32 + 1] = 0;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += s_warp[w];
  int f = incl - sum;
  if (item >= f && item < incl) {
    for (int t = t0; t < t1; ++t) {
      const int n = items_of(tile_count[t], chunk);
      if (item < f + n) {
        s_warp[PX / 32] = t;
        s_warp[PX / 32 + 1] = f;
        break;
      }
      f += n;
    }
  }
  __syncthreads();
  tile = s_warp[PX / 32];
  first = s_warp[PX / 32 + 1];
}

// Per-item partials: item i's composite of its own entries from T = 1, in
// the output's channel order (A = 0:5+K rgb, depth, alpha, seg; V =
// 5+K:5+2K vis; L = 5+2K:5+3K amodal log; then T_full, T_ne), stored
// channel-major as partials[i][f][pixel of the tile], f < 5 + 3K + 2.
// Written only for tiles of more than one item.  Items of a tile combine in
// order with the 'over' operator:
//   out_A += T_acc A_c,  vis += T_ne_acc V_c,  amodal += L_c,
//   T_acc *= T_c,  T_ne_acc *= T_ne_c.

}  // namespace composite
