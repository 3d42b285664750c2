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

}  // namespace composite
