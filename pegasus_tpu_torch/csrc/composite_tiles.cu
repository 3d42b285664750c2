// Tile compositor for Hopper (sm_90a): front-to-back alpha compositing of
// exact-binned Gaussian splats, emitting every modality in one pass.
//
// Replaces the TPU kernel pegasus_tpu/ops/rasterize_pallas.py::
// _composite_kernel_mt (and its single-tile twin _composite_kernel), called
// from composite_tiles_pallas, and the training forward
// pegasus_tpu/ops/pallas_vjp.py::_forward_call.  Same per-pixel math, not
// the same blocks.  Output [H, W, F], F = 5 + 3*k_out + 2:
//   0:3 rgb (premultiplied, no background), 3 depth, 4 alpha,
//   5:5+K seg, 5+K:5+2K vis (env excluded), 5+2K:5+3K amodal
//   log-transmittance, 5+3K t_full, 5+3K+1 t_noenv.
// No early termination: amodal needs every object entry, exactly like the
// golden compositor (rasterize_pallas.py:245).
//
// What bounded the first version on an H100 was load balance: one block
// per 16x16 tile walked its whole depth-ordered segment alone, so the
// longest tile set the time (5,738 entries against a mean of 466 at the
// 210k-splat orbit view, 1.50 ms for the frame).  The arithmetic (~30 FP32
// operations and an expf per in-image pixel-entry pair) is a few percent of
// the card's FP32 rate, and the bytes are small.  This design:
//
//   * cuts every tile's segment into work items of at most `chunk` entries
//     (C = CHUNK_ENTRIES = 256 in ops/rasterize_cuda.py, which says why;
//     composite_common.cuh numbers them) and runs one block per item, one
//     thread per pixel: the longest tile of the 210k orbit view becomes 23
//     blocks spread over the SMs, and the frame 2,874 blocks of at most 256
//     entries in place of 1,200 of very unequal length.  Each item
//     composites its entries from T = 1;
//   * an item that is its tile's only one writes [H, W, F] directly.  The
//     items of a longer tile write per-pixel partials (composite_common.cuh),
//     and the one of them that finishes last (a per-tile counter) combines
//     them in item order with the 'over' operator, while they are still in
//     L2 and while the other items run (a separate combine kernel, one
//     block per tile, walked up to 60 items' partials of a tile after the
//     item kernel had ended).  The order is fixed and no float is summed
//     by an atomic, so the output is bitwise repeatable from run to run.
//     The training forward keeps the partials for the backward
//     (composite_tiles_bwd.cu reads each item's start state off them);
//   * a warp skips an entry outright when none of its 32 pixels lies in
//     the entry's 3-sigma box (the same |dx|, |dy| <= radius test that
//     entry_alpha() applies, so the kept set is unchanged): a splat's box
//     covers a few rows of a tile it was binned to, and a warp is two rows;
//   * the K seg / vis / amodal accumulators live in registers, with
//     instances for K <= 1, 2, 4, 8, 16 and 32 (training composites K = 1,
//     generation K = 7), so a kept pair loops over no more objects than the
//     instance holds;
//   * each batch of 256 entries is gathered through entry_splat into shared
//     memory without cp.async double buffering: the item split leaves four
//     (K = 8) to five (K = 1) blocks on an SM, whose gathers overlap the
//     others' compositing, and an item of C = 256 entries is one batch.
//
// One kernel launch per call, after a memset of the per-tile counters.  It
// allocates nothing; the wrapper passes the scratch from torch.empty.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/rasterize_cuda.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

struct FwdArgs {
  const float* params;
  int64_t n_splats;
  const int* entry_splat;
  const int* tile_start;
  const int* tile_count;
  float* out;       // [H, W, F]
  float* partials;  // [n_items][F][PX]
  int* tile_done;   // [n_tiles], zero at launch: items of the tile finished
  int width, height, ntx, n_tiles, k_out, chunk;
};

// Combine the n_items partials of the tile whose first item is `first`, in
// item order (composite_common.cuh), into pixel (px, py) of [H, W, F].  The
// partials were written by other blocks of this launch: __ldcg reads them
// from L2, past this SM's L1.
template <int K>
__device__ __forceinline__ void combine_items(const FwdArgs& a, int first, int n_items,
                                              int tid, int px, int py) {
  const int k_out = a.k_out;
  const int f = 5 + 3 * k_out + 2;
  float t_acc = 1.f, t_ne_acc = 1.f;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float seg[K], vis[K], am[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    seg[k] = 0.f;
    vis[k] = 0.f;
    am[k] = 0.f;
  }
  for (int c = 0; c < n_items; ++c) {
    const float* p = a.partials + static_cast<int64_t>(first + c) * f * PX + tid;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) acc[ch] += t_acc * __ldcg(p + ch * PX);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < k_out) {
        seg[k] += t_acc * __ldcg(p + (5 + k) * PX);
        vis[k] += t_ne_acc * __ldcg(p + (5 + k_out + k) * PX);
        am[k] += __ldcg(p + (5 + 2 * k_out + k) * PX);
      }
    }
    t_acc *= __ldcg(p + (5 + 3 * k_out) * PX);
    t_ne_acc *= __ldcg(p + (5 + 3 * k_out + 1) * PX);
  }

  float* o = a.out + (static_cast<int64_t>(py) * a.width + px) * f;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) o[ch] = acc[ch];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < k_out) {
      o[5 + k] = seg[k];
      o[5 + k_out + k] = vis[k];
      o[5 + 2 * k_out + k] = am[k];
    }
  }
  o[5 + 3 * k_out] = t_acc;
  o[5 + 3 * k_out + 1] = t_ne_acc;
}

// Blocks per SM that the register budget must allow for each instance: the
// combine of the last item adds live registers, and without the cap nvcc
// spends them on fewer blocks per SM, which costs the compositing loop more
// than the combine gains.
template <int K>
constexpr int min_blocks() {
  return K <= 2 ? 5 : K <= 8 ? 4 : K <= 16 ? 2 : 1;
}

template <int K>
__global__ void __launch_bounds__(PX, min_blocks<K>()) composite_tiles_kernel(FwdArgs a) {
  __shared__ float s_mx[PX], s_my[PX], s_ca[PX], s_cb[PX], s_cc[PX];
  __shared__ float s_op[PX], s_r[PX], s_g[PX], s_b[PX], s_d[PX], s_rad[PX];
  __shared__ int s_obj[PX];
  __shared__ int s_warp[PX / 32 + 2];

  const int item = blockIdx.x;
  int tile, first;
  locate_item(a.tile_count, a.n_tiles, a.chunk, item, s_warp, tile, first);
  if (tile < 0) return;  // past the last item: the grid is a bound
  const int c = item - first;
  const int count = a.tile_count[tile];
  const int lo = a.tile_start[tile] + c * a.chunk;
  const int n = max(0, min(a.chunk, count - c * a.chunk));

  const int tid = threadIdx.x;
  const int px = (tile % a.ntx) * TILE + tid % TILE;
  const int py = (tile / a.ntx) * TILE + tid / TILE;
  const bool inside = px < a.width && py < a.height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  float t_full = 1.f, t_ne = 1.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_a = 0.f;
  float seg[K], vis[K], am[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    seg[k] = 0.f;
    vis[k] = 0.f;
    am[k] = 0.f;
  }

  const float* params = a.params;
  const int64_t ns = a.n_splats;
  for (int base = 0; base < n; base += PX) {
    const int n_b = min(PX, n - base);
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
      const float rad = s_rad[j];
      const bool in_box = inside & (fabsf(fx - s_mx[j]) <= rad) &
                          (fabsf(fy - s_my[j]) <= rad);
      if (!__any_sync(FULL_MASK, in_box)) continue;  // the whole warp misses
      float dx, dy, exppow, raw, alpha;
      const bool keep = entry_alpha(fx, fy, s_mx[j], s_my[j], s_ca[j], s_cb[j],
                                    s_cc[j], s_op[j], rad, dx, dy, exppow,
                                    raw, alpha);
      if (!(keep & inside)) continue;

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

  const int k_out = a.k_out;
  const int f = 5 + 3 * k_out + 2;
  const bool several = count > a.chunk;
  float* o;
  int64_t step;
  if (several) {  // one of several items: partials, channel-major
    o = a.partials + static_cast<int64_t>(item) * f * PX + tid;
    step = PX;
  } else {
    if (!inside) return;
    o = a.out + (static_cast<int64_t>(py) * a.width + px) * f;
    step = 1;
  }
  o[0 * step] = acc_r;
  o[1 * step] = acc_g;
  o[2 * step] = acc_b;
  o[3 * step] = acc_d;
  o[4 * step] = acc_a;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < k_out) {
      o[(5 + k) * step] = seg[k];
      o[(5 + k_out + k) * step] = vis[k];
      o[(5 + 2 * k_out + k) * step] = am[k];
    }
  }
  o[(5 + 3 * k_out) * step] = t_full;
  o[(5 + 3 * k_out + 1) * step] = t_ne;
  if (!several) return;

  // The tile's item that finishes last combines its partials, as in CUDA's
  // threadFenceReduction sample: each block fences its writes before it
  // counts itself in tile_done, and the block that counts n_items reads
  // them all.  Nothing waits on another block.
  const int n_items = items_of(count, a.chunk);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_warp[0] = atomicAdd(a.tile_done + tile, 1) == n_items - 1;
  __syncthreads();
  if (!s_warp[0]) return;
  __threadfence();
  if (inside) combine_items<K>(a, first, n_items, tid, px, py);
}

template <int K>
int launch(const FwdArgs& a, int n_items, cudaStream_t st) {
  composite_tiles_kernel<K><<<n_items, PX, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `partials` is scratch of
// n_items x (5 + 3*k_out + 2) x 256 floats, n_items >= ceil(M / chunk) +
// n_tiles (ops/rasterize_cuda.py::max_items); its rows for tiles of more
// than one item hold the per-item partials afterwards.  `tile_done` is
// scratch of ntx * nty ints, zeroed here.  Enqueues the memset and the
// kernel on `stream`, does not synchronise, allocates nothing; returns the
// first CUDA error (cudaErrorInvalidValue for k_out outside 1..32, no
// tiles, chunk < 1 or too few items).
extern "C" int composite_tiles_launch(const float* params, int64_t n_splats,
                                      const int* entry_splat,
                                      const int* tile_start,
                                      const int* tile_count, float* out,
                                      float* partials, int* tile_done,
                                      int n_items, int width, int height,
                                      int ntx, int nty, int k_out, int chunk,
                                      void* stream) {
  const int n_tiles = ntx * nty;
  if (k_out < 1 || k_out > 32 || n_tiles < 1 || chunk < 1 || n_items < n_tiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(tile_done, 0, n_tiles * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{params,   n_splats,  entry_splat, tile_start, tile_count,
                  out,      partials,  tile_done,   width,      height,
                  ntx,      n_tiles,   k_out,       chunk};
  if (k_out <= 1) return launch<1>(a, n_items, st);
  if (k_out <= 2) return launch<2>(a, n_items, st);
  if (k_out <= 4) return launch<4>(a, n_items, st);
  if (k_out <= 8) return launch<8>(a, n_items, st);
  if (k_out <= 16) return launch<16>(a, n_items, st);
  return launch<32>(a, n_items, st);
}
