// Backward of the tile compositor for Hopper (sm_90a): per-entry gradients
// of the splat parameters from the cotangent of every compositor channel.
//
// Replaces the TPU kernel pegasus_tpu/ops/pallas_vjp.py::
// _composite_bwd_kernel (called from _backward_call), the VJP of the
// forward composite_tiles.cu.  Same math (pallas_vjp.py:15-35), not the
// same blocks.  Per pixel p and depth-ordered entries e of its tile:
//
//   out_A[f] = sum_e w_e feat_e[f],  w_e = a_e T_excl(e),  t_out = prod (1-a_e)
//   dL/da_e  = T_excl(e) (feat_e . gA) - (S_>e + t_out g_t) / (1 - a_e)
//   S_>e     = S - sum_{e' <= e} w_e' (feat_e' . gA),  S = out_A . gA
//
// plus the same terms for the chain with environment alphas zeroed (vis
// channels, object entries only) and -gC[obj] / (1 - a_e) for the amodal
// log-transmittance (every kept entry, environment included).  dL/da is
// gated by keep & (opac * exp(power) < 0.99), as the forward's clamp, and
// chained to mean x/y, conic a/b/c and opacity; rgb and depth get w_e gA.
//
// What bounded the first version on an H100: the longest tile, which one
// block walked alone and twice (pass 1 only formed the totals S, S_ne and
// the final transmittances), then the per-entry work of each warp: 10
// reductions of 5 shuffle steps, three IEEE divisions and 10 shared-memory
// float atomics, which sm_90 runs as compare-and-swap loops.  3.15 ms at the
// training shape against a bound of 0.043 ms.  This design:
//
//   * one walk.  S = out_A . gA, S_ne = vis . gB and both final
//     transmittances are read off the forward's output, which the autograd
//     Function saves, so each entry is visited once, front to back, with
//     prefix sums: suffix = S - prefix;
//   * the forward's work items (composite_common.cuh; C = CHUNK_ENTRIES =
//     256 entries, chosen from both kernels' times at C = 128 .. 1024 that
//     chip_smoke.py prints, PERF.md): one block per item.  An item's start
//     state follows from the forward's partials of the items before it in
//     its tile: T_start(c) = prod_{c' < c} T_c', pre(c) = sum_{c' < c}
//     T_start(c') (A_c' . gA), and the same from the vis partials for the
//     chain without the environment.  Without the partials the wrapper
//     raises: nothing re-walks a segment to rebuild them;
//   * every entry belongs to exactly one item, so one block owns its
//     gradient row: no global atomics.  A warp reduces an entry's 10
//     per-pixel terms in one transposed butterfly (at each step a lane keeps
//     half of the rows it still holds and sends the other half: 5 + 3 + 2 +
//     1 + 1 shuffles in place of 50), after which 10 lanes hold the 10 row
//     sums and store them to the warp's own s_part[warp][row][entry]; after
//     each batch of BATCH entries one thread per entry adds the eight warps'
//     sums in a fixed order.  No atomics anywhere, so the gradients are
//     bitwise repeatable from run to run.  Entries no lane keeps skip the
//     butterfly (__any_sync);
//   * a warp skips an entry outright when none of its pixels lies in the
//     entry's 3-sigma box (entry_alpha()'s own |dx|, |dy| <= radius test);
//   * the three 1 / (1 - a_e) terms share one correctly rounded reciprocal;
//   * alpha and keep come from entry_alpha() (composite_common.cuh), the
//     forward's own expression;
//   * the K seg / vis / amodal cotangents of each pixel live in dynamic
//     shared memory ([3K][256] floats, 96 KB at K = 32), read at the
//     entry's object id, so one instance serves every K <= 32;
//   * pixels beyond the ragged image edge have zero cotangent and are never
//     read.
//
// The plain version in ops/composite_vjp.py is the yardstick; it divides
// where the kernel multiplies by the reciprocal, and sums in another order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/rasterize_cuda.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int N_GRAD = 10;  // gradient rows P_MX .. P_DEPTH

// Entries per batch: the gather's shared rows and each warp's row sums
// s_part[warp][row][entry] (20 KB) hold one batch.
constexpr int BATCH = 64;

// The row whose warp sum warp_sum_rows leaves in lane `lane`, and whether
// that lane holds one: 10 distinct lanes hold rows 0..9.
__device__ __forceinline__ void lane_row(int lane, int& row, bool& valid) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
  const int idx = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);  // of the 3 kept at xor 8
  row = 5 * b4 + 3 * b3 + idx;
  valid = !(lane & 1) && idx < 3 && 3 * b3 + idx < 5;
}

// Sum each of the 10 values v[0..9] over the warp; lane_row says which
// lane holds which row's sum.  Step xor 16 keeps rows 0-4 or 5-9 (5
// shuffles), xor 8 keeps 3 of those 5 (padded to 6: 3 shuffles), xor 4
// keeps 2 of 3 (2 shuffles), xor 2 keeps 1 of 2 (1 shuffle), xor 1 adds
// the pair (1 shuffle).
__device__ __forceinline__ float warp_sum_rows(const float (&v)[N_GRAD], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float u[6];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float send = b4 ? v[j] : v[j + 5];
    const float keep = b4 ? v[j + 5] : v[j];
    u[j] = keep + __shfl_xor_sync(FULL_MASK, send, 16);
  }
  u[5] = 0.f;
  float w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float send = b3 ? u[j] : u[j + 3];
    const float keep = b3 ? u[j + 3] : u[j];
    w[j] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
  }
  float x[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float hi = j == 0 ? w[2] : 0.f;  // the third kept row, or padding
    const float send = b2 ? w[j] : hi;
    const float keep = b2 ? hi : w[j];
    x[j] = keep + __shfl_xor_sync(FULL_MASK, send, 4);
  }
  float y = (b1 ? x[1] : x[0]) + __shfl_xor_sync(FULL_MASK, b1 ? x[0] : x[1], 2);
  return y + __shfl_xor_sync(FULL_MASK, y, 1);
}

struct BwdArgs {
  const float* params;
  int64_t n_splats;
  const int* entry_splat;
  const int* tile_start;
  const int* tile_count;
  const float* grad_out;  // [H, W, F]
  const float* out;       // the forward's [H, W, F]
  const float* partials;  // the forward's [n_items][F][PX]
  float* entry_grad;      // [10, n_entries]
  int64_t n_entries;
  int width, height, ntx, n_tiles, k_out, chunk;
};

__global__ void __launch_bounds__(PX) composite_tiles_bwd_kernel(BwdArgs a) {
  extern __shared__ float s_gk[];  // [3 * k_out][PX]: gA seg, gB, gC
  __shared__ float s_mx[BATCH], s_my[BATCH], s_ca[BATCH], s_cb[BATCH], s_cc[BATCH];
  __shared__ float s_op[BATCH], s_r[BATCH], s_g[BATCH], s_b[BATCH], s_d[BATCH];
  __shared__ float s_rad[BATCH];
  __shared__ int s_obj[BATCH];
  __shared__ float s_part[PX / 32][N_GRAD][BATCH];
  __shared__ int s_warp[PX / 32 + 2];

  const int item = blockIdx.x;
  int tile, first;
  locate_item(a.tile_count, a.n_tiles, a.chunk, item, s_warp, tile, first);
  if (tile < 0) return;  // past the last item: the grid is a bound
  const int c = item - first;
  const int lo = a.tile_start[tile] + c * a.chunk;
  const int n = max(0, min(a.chunk, a.tile_count[tile] - c * a.chunk));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int row;
  bool holds_row;
  lane_row(lane, row, holds_row);
  const int px = (tile % a.ntx) * TILE + tid % TILE;
  const int py = (tile / a.ntx) * TILE + tid / TILE;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const bool inside = px < a.width && py < a.height;
  const int k_out = a.k_out;
  const int f = 5 + 3 * k_out + 2;

  // this pixel's cotangent: rgb, depth, alpha, t_full, t_noenv in
  // registers, the 3K object channels in shared memory
  float gA0 = 0.f, gA1 = 0.f, gA2 = 0.f, gA3 = 0.f, gA4 = 0.f;
  float g_tf = 0.f, g_tn = 0.f;
  const int64_t pix = static_cast<int64_t>(py) * a.width + px;
  const float* g = a.grad_out + pix * f;
  if (inside) {
    gA0 = g[0];
    gA1 = g[1];
    gA2 = g[2];
    gA3 = g[3];
    gA4 = g[4];
    g_tf = g[5 + 3 * k_out];
    g_tn = g[5 + 3 * k_out + 1];
  }
  for (int ch = 0; ch < 3 * k_out; ++ch) s_gk[ch * PX + tid] = inside ? g[5 + ch] : 0.f;
  const float* gA_obj = s_gk + tid;                   // [obj * PX]
  const float* gB_obj = s_gk + k_out * PX + tid;      // vis
  const float* gC_obj = s_gk + 2 * k_out * PX + tid;  // amodal log

  // totals off the forward's output: S = out_A . gA, S_ne = vis . gB and
  // the final transmittances
  float s_full = 0.f, s_ne = 0.f, t_full_end = 1.f, t_ne_end = 1.f;
  if (inside) {
    const float* o = a.out + pix * f;
    s_full = o[0] * gA0 + o[1] * gA1 + o[2] * gA2 + o[3] * gA3 + o[4] * gA4;
    for (int k = 0; k < k_out; ++k) {
      s_full += o[5 + k] * gA_obj[k * PX];
      s_ne += o[5 + k_out + k] * gB_obj[k * PX];
    }
    t_full_end = o[5 + 3 * k_out];
    t_ne_end = o[5 + 3 * k_out + 1];
  }

  // this item's start state from the partials of the items before it
  float t_full = 1.f, t_ne = 1.f, pre = 0.f, pre_ne = 0.f;
  if (inside) {
    for (int cc = 0; cc < c; ++cc) {
      const float* p = a.partials + static_cast<int64_t>(first + cc) * f * PX + tid;
      float a_g = p[0] * gA0 + p[PX] * gA1 + p[2 * PX] * gA2 + p[3 * PX] * gA3 +
                  p[4 * PX] * gA4;
      float v_g = 0.f;
      for (int k = 0; k < k_out; ++k) {
        a_g += p[(5 + k) * PX] * gA_obj[k * PX];
        v_g += p[(5 + k_out + k) * PX] * gB_obj[k * PX];
      }
      pre += t_full * a_g;
      pre_ne += t_ne * v_g;
      t_full *= p[(5 + 3 * k_out) * PX];
      t_ne *= p[(5 + 3 * k_out + 1) * PX];
    }
  }

  const float* params = a.params;
  const int64_t ns = a.n_splats;
  for (int base = 0; base < n; base += BATCH) {
    const int n_b = min(BATCH, n - base);
    __syncthreads();  // every thread is done with the previous batch
    if (tid < n_b) {
      const int64_t s = a.entry_splat[lo + base + tid];
      s_mx[tid] = params[P_MX * ns + s];
      s_my[tid] = params[P_MY * ns + s];
      s_ca[tid] = params[P_CA * ns + s];
      s_cb[tid] = params[P_CB * ns + s];
      s_cc[tid] = params[P_CC * ns + s];
      s_op[tid] = params[P_OPAC * ns + s];
      s_r[tid] = params[P_R * ns + s];
      s_g[tid] = params[P_G * ns + s];
      s_b[tid] = params[P_B * ns + s];
      s_d[tid] = params[P_DEPTH * ns + s];
      s_rad[tid] = params[P_RADIUS * ns + s];
      s_obj[tid] = static_cast<int>(params[P_OBJ * ns + s]);
    }
    __syncthreads();
    for (int j = 0; j < n_b; ++j) {
      float sum = 0.f;  // this lane's row of the warp's sums for entry j
      const float rad = s_rad[j];
      const bool in_box = inside & (fabsf(fx - s_mx[j]) <= rad) &
                          (fabsf(fy - s_my[j]) <= rad);
      if (__any_sync(FULL_MASK, in_box)) {  // else the whole warp misses
        float v[N_GRAD];
#pragma unroll
        for (int r = 0; r < N_GRAD; ++r) v[r] = 0.f;
        float dx, dy, exppow, raw, alpha;
        const bool kept =
            entry_alpha(fx, fy, s_mx[j], s_my[j], s_ca[j], s_cb[j], s_cc[j],
                        s_op[j], rad, dx, dy, exppow, raw, alpha) &
            inside;
        if (kept) {
          const int obj = s_obj[j];
          const float one_m = 1.f - alpha;
          const float inv = __frcp_rn(one_m);  // one reciprocal, no divisions
          const float fg = s_r[j] * gA0 + s_g[j] * gA1 + s_b[j] * gA2 +
                           s_d[j] * gA3 + gA4 + gA_obj[obj * PX];
          const float t_excl = t_full;
          const float w = alpha * t_excl;
          pre += w * fg;
          // the suffix sum and the t_out term, and the amodal d log(1 - a) / da
          float tail = (s_full - pre) + t_full_end * g_tf + gC_obj[obj * PX];
          float da = t_excl * fg;
          t_full *= one_m;
          if (obj != 0) {  // the vis chain: object entries only
            const float gb = gB_obj[obj * PX];
            const float t_excl_ne = t_ne;
            const float w_ne = alpha * t_excl_ne;
            pre_ne += w_ne * gb;
            da += t_excl_ne * gb;
            tail += (s_ne - pre_ne) + t_ne_end * g_tn;
            t_ne *= one_m;
          }
          da -= tail * inv;
          v[6] = w * gA0;
          v[7] = w * gA1;
          v[8] = w * gA2;
          v[9] = w * gA3;
          if (raw < 0.99f) {  // no gradient through the 0.99 clamp
            const float ca = s_ca[j], cb = s_cb[j], cc = s_cc[j];
            const float dpow = da * alpha;  // d raw / d power = raw = alpha
            v[P_MX] = dpow * (ca * dx + cb * dy);
            v[P_MY] = dpow * (cc * dy + cb * dx);
            v[P_CA] = dpow * (-0.5f * dx * dx);
            v[P_CB] = dpow * (-dx * dy);
            v[P_CC] = dpow * (-0.5f * dy * dy);
            v[P_OPAC] = da * exppow;
          }
        }
        if (__any_sync(FULL_MASK, kept)) sum = warp_sum_rows(v, lane);
      }
      if (holds_row) s_part[warp][row][j] = sum;
    }
    __syncthreads();  // every warp has written its sums for this batch
    if (tid < n_b) {  // the eight warps' sums, in a fixed order
      const int64_t e = lo + base + tid;
#pragma unroll
      for (int r = 0; r < N_GRAD; ++r) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < PX / 32; ++w) s += s_part[w][r][tid];
        a.entry_grad[r * a.n_entries + e] = s;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  grad_out is the contiguous
// [H, W, 5 + 3*k_out + 2] cotangent, out the forward's output and partials
// its per-item partials (the same n_items and chunk); entry_grad the
// [10, n_entries] output (rows P_MX .. P_DEPTH; every entry of every tile is
// written).  Launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// k_out outside 1..32, no tiles, chunk < 1 or too few items).
extern "C" int composite_tiles_bwd_launch(
    const float* params, int64_t n_splats, const int* entry_splat,
    const int* tile_start, const int* tile_count, const float* grad_out,
    const float* out, const float* partials, float* entry_grad,
    int64_t n_entries, int n_items, int width, int height, int ntx, int nty,
    int k_out, int chunk, void* stream) {
  const int n_tiles = ntx * nty;
  if (k_out < 1 || k_out > 32 || n_tiles < 1 || chunk < 1 || n_items < n_tiles)
    return cudaErrorInvalidValue;
  const int dyn_bytes = 3 * k_out * PX * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      composite_tiles_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{params,   n_splats,   entry_splat, tile_start, tile_count,
                  grad_out, out,        partials,    entry_grad, n_entries,
                  width,    height,     ntx,         n_tiles,    k_out,
                  chunk};
  composite_tiles_bwd_kernel<<<n_items, PX, dyn_bytes,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
