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
//   S_>e     = sum_{e' > e} w_e' (feat_e' . gA)
//
// plus the same terms for the chain with environment alphas zeroed (vis
// channels, object entries only) and -gC[obj] / (1 - a_e) for the amodal
// log-transmittance (every kept entry, environment included).  dL/da is
// gated by keep & (opac * exp(power) < 0.99), as the forward's clamp, and
// chained to mean x/y, conic a/b/c and opacity; rgb and depth get w_e gA.
//
//   * one block per 16x16 tile, one thread per pixel, batches of 256
//     entries gathered through entry_splat into shared memory (the
//     forward's staging);
//   * two passes over the segment in front-to-back order: pass 1 gives each
//     pixel the totals S_full, S_ne and the final transmittances, pass 2
//     walks again keeping prefix sums, so suffix = S - prefix.  A thread
//     walks its entries in order, so the TPU's log-space cumsum, its
//     128-lane window overlap and the object-free-chunk branch have no
//     counterpart here.  alpha and keep come from entry_alpha()
//     (composite_common.cuh), the forward's own expression;
//   * no read-modify-write of a global gradient matrix (the TPU's is
//     race-free only because its grid runs in order).  Every entry belongs
//     to exactly one tile, so one block owns it: each warp sums an entry's
//     10 per-pixel terms with shuffles and adds them to s_grad[10][256]
//     with one shared-memory atomic per warp and row, skipping entries that
//     no lane of the warp keeps.  The rows go to a per-entry output
//     [10, M] at the end of each batch; ops/composite_vjp.py scatters them
//     to splats with index_add_;
//   * the K seg / vis / amodal cotangents of each pixel live in dynamic
//     shared memory ([3K][256] floats, 96 KB at K = 32), read at the
//     entry's object id, so one instance serves every K <= 32 and no
//     register array is indexed at run time;
//   * pixels beyond the ragged image edge have zero cotangent and are never
//     read.
//
// What bounds it on an H100: like the forward, the longest tile (one block
// walks it alone, twice), and then the per-entry warp reductions (10 values,
// 5 shuffle steps each, for every entry a warp keeps).  The bytes are small:
// each entry's 48 bytes gathered twice per tile, F floats of cotangent per
// pixel, 40 bytes written per entry.  Float atomics make the order of the
// eight warp partials vary between runs, so results are not bitwise
// repeatable; the plain version in ops/composite_vjp.py is the yardstick.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/rasterize_cuda.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int N_GRAD = 10;  // gradient rows P_MX .. P_DEPTH
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__global__ void __launch_bounds__(PX)
composite_tiles_bwd_kernel(const float* __restrict__ params, int64_t n_splats,
                           const int* __restrict__ entry_splat,
                           const int* __restrict__ tile_start,
                           const int* __restrict__ tile_count,
                           const float* __restrict__ grad_out,
                           float* __restrict__ entry_grad, int64_t n_entries,
                           int width, int height, int ntx, int k_out) {
  extern __shared__ float s_gk[];  // [3 * k_out][PX]: gA seg, gB, gC
  __shared__ float s_mx[PX], s_my[PX], s_ca[PX], s_cb[PX], s_cc[PX];
  __shared__ float s_op[PX], s_r[PX], s_g[PX], s_b[PX], s_d[PX], s_rad[PX];
  __shared__ int s_obj[PX];
  __shared__ float s_grad[N_GRAD][PX];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = (tile % ntx) * TILE + tid % TILE;
  const int py = (tile / ntx) * TILE + tid / TILE;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const bool inside = px < width && py < height;
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  // this pixel's cotangent: rgb, depth, alpha, t_full, t_noenv in
  // registers, the 3K object channels in shared memory
  float gA0 = 0.f, gA1 = 0.f, gA2 = 0.f, gA3 = 0.f, gA4 = 0.f;
  float g_tf = 0.f, g_tn = 0.f;
  const int f = 5 + 3 * k_out + 2;
  const float* g = grad_out + (static_cast<int64_t>(py) * width + px) * f;
  if (inside) {
    gA0 = g[0];
    gA1 = g[1];
    gA2 = g[2];
    gA3 = g[3];
    gA4 = g[4];
    g_tf = g[5 + 3 * k_out];
    g_tn = g[5 + 3 * k_out + 1];
  }
  for (int c = 0; c < 3 * k_out; ++c) s_gk[c * PX + tid] = inside ? g[5 + c] : 0.f;
  const float* gA_obj = s_gk + tid;               // [obj * PX]
  const float* gB_obj = s_gk + k_out * PX + tid;  // vis
  const float* gC_obj = s_gk + 2 * k_out * PX + tid;  // amodal log
#pragma unroll
  for (int r = 0; r < N_GRAD; ++r) s_grad[r][tid] = 0.f;

  auto stage = [&](int base, int n_b) {
    __syncthreads();  // every thread is done with the previous batch
    if (tid < n_b) {
      const int64_t s = entry_splat[start + base + tid];
      s_mx[tid] = params[P_MX * n_splats + s];
      s_my[tid] = params[P_MY * n_splats + s];
      s_ca[tid] = params[P_CA * n_splats + s];
      s_cb[tid] = params[P_CB * n_splats + s];
      s_cc[tid] = params[P_CC * n_splats + s];
      s_op[tid] = params[P_OPAC * n_splats + s];
      s_r[tid] = params[P_R * n_splats + s];
      s_g[tid] = params[P_G * n_splats + s];
      s_b[tid] = params[P_B * n_splats + s];
      s_d[tid] = params[P_DEPTH * n_splats + s];
      s_rad[tid] = params[P_RADIUS * n_splats + s];
      s_obj[tid] = static_cast<int>(params[P_OBJ * n_splats + s]);
    }
    __syncthreads();
  };

  // ---- pass 1: totals S_full, S_ne and the final transmittances ----------
  float t_full = 1.f, t_ne = 1.f, s_full = 0.f, s_ne = 0.f;
  for (int base = 0; base < count; base += PX) {
    const int n_b = min(PX, count - base);
    stage(base, n_b);
    if (!inside) continue;
    for (int j = 0; j < n_b; ++j) {
      float dx, dy, exppow, raw, alpha;
      if (!entry_alpha(fx, fy, s_mx[j], s_my[j], s_ca[j], s_cb[j], s_cc[j],
                       s_op[j], s_rad[j], dx, dy, exppow, raw, alpha))
        continue;
      const int obj = s_obj[j];
      const float fg = s_r[j] * gA0 + s_g[j] * gA1 + s_b[j] * gA2 +
                       s_d[j] * gA3 + gA4 + gA_obj[obj * PX];
      const float w = alpha * t_full;
      s_full += w * fg;
      t_full *= 1.f - alpha;
      if (obj != 0) {
        const float w_ne = alpha * t_ne;
        s_ne += w_ne * gB_obj[obj * PX];
        t_ne *= 1.f - alpha;
      }
    }
  }
  const float t_full_end = t_full, t_ne_end = t_ne;

  // ---- pass 2: per-entry gradients ------------------------------------------
  t_full = 1.f;
  t_ne = 1.f;
  float pre = 0.f, pre_ne = 0.f;
  for (int base = 0; base < count; base += PX) {
    const int n_b = min(PX, count - base);
    stage(base, n_b);
    for (int j = 0; j < n_b; ++j) {
      float v[N_GRAD];
#pragma unroll
      for (int r = 0; r < N_GRAD; ++r) v[r] = 0.f;
      float dx, dy, exppow, raw, alpha;
      const bool kept =
          inside && entry_alpha(fx, fy, s_mx[j], s_my[j], s_ca[j], s_cb[j],
                                s_cc[j], s_op[j], s_rad[j], dx, dy, exppow,
                                raw, alpha);
      if (kept) {
        const int obj = s_obj[j];
        const float one_m = 1.f - alpha;
        const float fg = s_r[j] * gA0 + s_g[j] * gA1 + s_b[j] * gA2 +
                         s_d[j] * gA3 + gA4 + gA_obj[obj * PX];
        const float t_excl = t_full;
        const float w = alpha * t_excl;
        pre += w * fg;
        float da = t_excl * fg - ((s_full - pre) + t_full_end * g_tf) / one_m;
        t_full *= one_m;
        if (obj != 0) {  // the vis chain: object entries only
          const float gb = gB_obj[obj * PX];
          const float t_excl_ne = t_ne;
          const float w_ne = alpha * t_excl_ne;
          pre_ne += w_ne * gb;
          da += t_excl_ne * gb - ((s_ne - pre_ne) + t_ne_end * g_tn) / one_m;
          t_ne *= one_m;
        }
        da -= gC_obj[obj * PX] / one_m;  // amodal: d log(1 - a) / da
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
      if (__any_sync(FULL_MASK, kept)) {
#pragma unroll
        for (int r = 0; r < N_GRAD; ++r) v[r] = warp_sum(v[r]);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < N_GRAD; ++r) atomicAdd(&s_grad[r][j], v[r]);
        }
      }
    }
    __syncthreads();  // every warp has added its partials for this batch
    if (tid < n_b) {
      const int64_t e = start + base + tid;
#pragma unroll
      for (int r = 0; r < N_GRAD; ++r) {
        entry_grad[r * n_entries + e] = s_grad[r][tid];
        s_grad[r][tid] = 0.f;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  grad_out is the contiguous
// [H, W, 5 + 3*k_out + 2] cotangent; entry_grad the [10, n_entries] output
// (rows P_MX .. P_DEPTH; every entry of every tile is written).  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for k_out
// outside 1..32 or no tiles).
extern "C" int composite_tiles_bwd_launch(
    const float* params, int64_t n_splats, const int* entry_splat,
    const int* tile_start, const int* tile_count, const float* grad_out,
    float* entry_grad, int64_t n_entries, int width, int height, int ntx,
    int nty, int k_out, void* stream) {
  const int n_tiles = ntx * nty;
  if (k_out < 1 || k_out > 32 || n_tiles < 1) return cudaErrorInvalidValue;
  const int dyn_bytes = 3 * k_out * PX * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      composite_tiles_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tiles_bwd_kernel<<<n_tiles, PX, dyn_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      params, n_splats, entry_splat, tile_start, tile_count, grad_out,
      entry_grad, n_entries, width, height, ntx, k_out);
  return static_cast<int>(cudaGetLastError());
}
