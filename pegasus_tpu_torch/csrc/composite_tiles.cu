// Tile compositor for Hopper (sm_90a): front-to-back alpha compositing of
// exact-binned Gaussian splats, emitting every modality in one pass.
//
// Replaces the TPU kernel pegasus_tpu/ops/rasterize_pallas.py::
// _composite_kernel_mt (and its single-tile twin _composite_kernel), called
// from composite_tiles_pallas.  Same per-pixel math, not the same blocks:
//
//   * one block per 16x16 image tile, one thread per pixel (256 threads);
//   * the block walks its tile's depth-ordered entry segment
//     entry_splat[start, start + count) in batches of 256: each thread
//     gathers one entry's fields from the per-splat parameter table
//     (struct-of-arrays, rows P_* of ops/binning.py) into shared memory,
//     then every thread walks the batch in order;
//   * transmittance is the plain product T <- T * (1 - alpha), for the full
//     chain and for the chain with environment alphas zeroed.  This replaces
//     the TPU's log-space cumsum done as triangular MXU matmuls;
//   * the K seg / vis / amodal accumulators live in registers (the kernel
//     is templated on a maximum K of 8, 16 or 32; ids must be < k_out);
//   * the result is written straight to [H, W, F], masked at the ragged
//     image edge, so no untile pass follows.  F = 5 + 3*k_out + 2:
//       0:3 rgb (premultiplied, no background), 3 depth, 4 alpha,
//       5:5+K seg, 5+K:5+2K vis (env excluded), 5+2K:5+3K amodal
//       log-transmittance, 5+3K t_full, 5+3K+1 t_noenv.
//   * no early termination: amodal needs every object entry, exactly like
//     the golden compositor (rasterize_pallas.py:245).
//
// What bounds it on an H100: load balance.  A 640x480 frame has 1200
// tiles, about one wave of 256-thread blocks on 132 SMs, and each block
// walks its own tile's segment alone, so the longest tile sets the time.
// At the 210k-splat bench orbit view the longest tile holds 5,738 entries
// against a mean of 466 (p99 4,359), and the kernel takes 1.51 ms (H100
// 80GB HBM3, 700 W), about 0.26 us per entry of that tile.  The arithmetic (~30 FP32 operations
// and an expf per pixel and entry, 143M pixel-entry pairs per frame) is a
// few percent of the card's FP32 rate, and the bytes are small: each
// entry's 48 bytes are gathered once per tile, mostly from L2, and each
// pixel writes F floats once.  This first version keeps every per-pixel
// value in registers and each batch in shared memory, and does nothing
// about the imbalance yet: splitting long segments across blocks (the
// 'over' operator is associative, so partial composites combine in order)
// and overlapping the next batch's gather with compute are later work.
//
// The same kernel is the forward of the training path (K2', the forward of
// pegasus_tpu/ops/pallas_vjp.py::composite_core), launched from the
// autograd Function in ops/composite_vjp.py; its backward is
// composite_tiles_bwd.cu, which recomputes alpha with the same
// entry_alpha() from composite_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/rasterize_cuda.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

template <int K>
__global__ void __launch_bounds__(PX)
composite_tiles_kernel(const float* __restrict__ params, int64_t n_splats,
                       const int* __restrict__ entry_splat,
                       const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count,
                       float* __restrict__ out, int width, int height,
                       int ntx, int k_out) {
  __shared__ float s_mx[PX], s_my[PX], s_ca[PX], s_cb[PX], s_cc[PX];
  __shared__ float s_op[PX], s_r[PX], s_g[PX], s_b[PX], s_d[PX], s_rad[PX];
  __shared__ int s_obj[PX];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (tile % ntx) * TILE + tid % TILE;
  const int py = (tile / ntx) * TILE + tid / TILE;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float t_full = 1.f, t_ne = 1.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_a = 0.f;
  float seg[K], vis[K], am[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    seg[k] = 0.f;
    vis[k] = 0.f;
    am[k] = 0.f;
  }

  for (int base = 0; base < count; base += PX) {
    const int n_b = min(PX, count - base);
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

    for (int j = 0; j < n_b; ++j) {
      float dx, dy, exppow, raw, alpha;
      if (!entry_alpha(fx, fy, s_mx[j], s_my[j], s_ca[j], s_cb[j], s_cc[j],
                       s_op[j], s_rad[j], dx, dy, exppow, raw, alpha))
        continue;

      const int obj = s_obj[j];
      const float w = alpha * t_full;
      acc_r += w * s_r[j];
      acc_g += w * s_g[j];
      acc_b += w * s_b[j];
      acc_d += w * s_d[j];
      acc_a += w;
      t_full *= 1.f - alpha;
      const float log1m = log1pf(-alpha);
      const bool env = obj == 0;
      const float w_ne = env ? 0.f : alpha * t_ne;
      if (!env) t_ne *= 1.f - alpha;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (obj == k) {
          seg[k] += w;
          vis[k] += w_ne;
          am[k] += log1m;
        }
      }
    }
  }

  if (px < width && py < height) {
    const int f = 5 + 3 * k_out + 2;
    float* o = out + (static_cast<int64_t>(py) * width + px) * f;
    o[0] = acc_r;
    o[1] = acc_g;
    o[2] = acc_b;
    o[3] = acc_d;
    o[4] = acc_a;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < k_out) {
        o[5 + k] = seg[k];
        o[5 + k_out + k] = vis[k];
        o[5 + 2 * k_out + k] = am[k];
      }
    }
    o[5 + 3 * k_out] = t_full;
    o[5 + 3 * k_out + 1] = t_ne;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for k_out outside 1..32 or no tiles).
extern "C" int composite_tiles_launch(const float* params, int64_t n_splats,
                                      const int* entry_splat,
                                      const int* tile_start,
                                      const int* tile_count, float* out,
                                      int width, int height, int ntx, int nty,
                                      int k_out, void* stream) {
  const int n_tiles = ntx * nty;
  if (k_out < 1 || k_out > 32 || n_tiles < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles), block(PX);
  if (k_out <= 8) {
    composite_tiles_kernel<8><<<grid, block, 0, st>>>(
        params, n_splats, entry_splat, tile_start, tile_count, out, width,
        height, ntx, k_out);
  } else if (k_out <= 16) {
    composite_tiles_kernel<16><<<grid, block, 0, st>>>(
        params, n_splats, entry_splat, tile_start, tile_count, out, width,
        height, ntx, k_out);
  } else {
    composite_tiles_kernel<32><<<grid, block, 0, st>>>(
        params, n_splats, entry_splat, tile_start, tile_count, out, width,
        height, ntx, k_out);
  }
  return static_cast<int>(cudaGetLastError());
}
