// Fused Gaussian-target MSE loss and its gradient, for Hopper.
//
// Replaces the Pallas TPU kernels of unipose_tpu/ops/pallas/heatmap_loss.py:86
// (`heatmap_mse`, a custom VJP): the forward `_sq_err_sum` (:67, pallas_call
// :70, body `_fwd_kernel` :43) and the backward `_bwd` (:106, pallas_call
// :111, body `_bwd_kernel` :59).  Both build the (K+1)-channel target from
// the keypoints where they need it, as `_targets_for_block` (:27-40) does,
// so the target never exists in device memory:
//
//   cx, cy = truncf(x) / stride, truncf(y) / stride
//   heat_k = expf(-d2 / 2 / (sigma * sigma)),  d2 on the integer pixel grid
//   heat_k = min(heat_k, 1); heat_k < 0.0099 -> 0
//   target = [1 - max_k heat_k, heat_0, ..., heat_{K-1}]
//   forward : loss  = sum((pred - target)^2) / N,  N = B*H*W*(K+1)
//   backward: dpred = (pred - target) * (2 * g / N), g read on the device
//
// pred is NHWC (B, H, W, K+1), f32 or bf16 (computed in f32; dpred written
// in pred's type, :50, :64); kpts are f32 pixel coordinates (B, K, R), the
// first two of each row of R = 2 or 3 floats read (so a (B, K, 3)[..., :2]
// view needs no copy).  expf, IEEE division and no FMA in d2: no fast math,
// so that a value near the 0.0099 threshold falls on the side it falls on in
// the plain version.
//
// Bound.  The forward reads pred once: at (8, 46, 46, 15) f32, 1.02 MB,
// 0.30 us at 3.35 TB/s; the backward reads pred and writes dpred, 2.03 MB,
// 0.61 us.  The 14 * 2116 * 8 = 0.24 M expf are small beside that.  At these
// sizes one launch and one trip to memory set the time, so the design is
// one launch each way, with every byte of a tile asked for at once.
//
// Tiles.  The pixels are numbered q = b*H*W + y*W + x and cut into tiles of
// P pixels (the last one shorter), which cross image boundaries, so that no
// tile but the last is part-empty.  P is a multiple of 8, so a tile's bytes
// P*(K+1)*elem are a multiple of 16 in both dtypes, and every tile starts at
// the same offset mod 16 as pred itself.  A block stages its tile in shared
// memory with 16-byte cp.async copies, all issued before any is waited on,
// after peeling the misaligned head and the tail with scalar loads (a bf16
// slice pred[1:] at 46x46 starts 63,480 B in, 8 B off a 16-byte boundary):
// the tile sits in shared memory at the global address's offset mod 16, so
// each 16-byte run lands on a 16-byte boundary.  The backward computes dpred
// into a second tile, placed at dpred's offset, and writes it out with
// 16-byte stores.  A tile may span several images (at 8x8 or 16x16 a
// 256-pixel tile holds 4 or 1-2 of them), so the block builds a table of the
// centers of every image its tile touches.
//
// The plan (P, tiles a block, blocks) is computed in Python,
// ops/kernels/heatmap_mse.py::tile_plan, so that a CPU test can check that it
// covers every pixel once and fills the card: P = pixels / SMs rounded down
// to a multiple of 8, at most THREADS, so that there are at least as many
// tiles as SMs; one tile a block up to BLOCKS_PER_SM blocks an SM, then
// several contiguous tiles a block.  `smem_bytes` here and `_smem_bytes`
// there lay out the same shared memory: a change goes in both places.
//
// Work split: a group of tpp threads a pixel, each taking joints j, j +
// tpp, ...: one thread a pixel at tiles of 128 pixels or more (batch 8 and
// up at 46x46), and below that a power of two that keeps P * tpp under 128
// (4 at 16x16 and batch 32, 8 at 46x46 and batch 1, 16 at 8x8 and batch
// 32); K is a template parameter for the datasets' widths (Penn Action 13,
// LSP 14, MPII 16, NTID 19), with a generic K beside them.  A thread
// computes its joints' Gaussians (at most one expf each, unrolled, so the
// exps are independent and overlap) and their channels from the staged
// tile; the background takes the max over the group by xor shuffles (a max
// is exact in any order), and the group's first thread computes it.  One
// thread a pixel left small tiles with one warp walking all K Gaussians in
// series, which set the time at 8x8 and 16x16 heatmaps, where every joint
// reaches every pixel; on large tiles the group's index arithmetic cost
// more than its shorter chains saved (PERF.md).  One thread an element
// would need an index division by K+1 an element and a shared-memory max.
// A joint farther than sqrt(9.4) sigma from the pixel has target 0
// whatever the rounding (see ZERO_D2_OVER_SIGMA_SQ), so the division and
// the expf, the bulk of the arithmetic, are skipped for it: at sigma 3 a
// joint reaches the pixels of a disc of radius 9.2, 266 of a 46x46 map's
// 2116.
//
// The forward's sum is one launch and deterministic.  The grid has one
// block more than the plan: each tile block writes its f32 partial sum
// (its threads' sums in a fixed tree) into its own 64-bit slot beside a
// ready flag, and the extra, last block waits on the flags, adds the
// partials in index order with a fixed-order block sum, writes sum / N and
// empties the slots.  No float atomics, so the loss has the same bits from
// run to run, and the slots are left empty for the next launch, so a CUDA
// graph can replay it.  The reducer block spins, but it holds one of the
// card's many block slots and the tile blocks need nothing from it, so
// they run in the others and fill its slots.
//
// Why not the last-block-done pattern (every block fences, writes its
// partial and takes a ticket from an arrival counter; the block that draws
// the last ticket adds the partials): it was built and measured first
// (PERF.md), and its tail, a chain of L2 round trips in the last block
// after every other block has finished, kept the forward at the time of
// the earlier two-launch design.  The reducer block reads the slots while the tiles
// are being computed, so only the last slot's trip is left on the path.  A
// cooperative grid sync was not taken either: it needs every block
// resident, for one barrier the slots give for free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"  // smem_u32, cp_async16

namespace {

constexpr int THREADS = 256;           // pixels a tile at most (heatmap_mse.py THREADS)
// dynamic shared memory a block, under the 48 KB that needs no opt-in, with
// room for the static part (heatmap_mse.py SMEM_LIMIT)
constexpr int SMEM_LIMIT = 46 * 1024;

struct Geometry {
  int B, H, W, K;
  int kpts_row;  // floats between two keypoints: 2, or 3 for a (B, K, 3)[..., :2] view
  int stride;
  float sigma_sq;  // sigma * sigma
  float n_elems;   // B*H*W*(K+1) as f32 (the JAX kernel's f32(pred.size))
  int P;           // pixels a tile
  int tiles;
  int tiles_per_block;  // block i takes tiles [i * tiles_per_block, ...)
};

// Bytes of one staged tile: P*C*elem (a multiple of 16) and 16 for the
// offset mod 16 it sits at.
__host__ __device__ __forceinline__ int tile_bytes(int P, int C, int elem) {
  return P * C * elem + 16;
}

// Images a run of P consecutive pixels can touch.
__host__ __device__ __forceinline__ int max_images(int B, int HW, int P) {
  const int n = (P - 1) / HW + 2;
  return n < B ? n : B;
}

// The layout: the input tile, the output tile (backward), the centers table.
int smem_bytes(const Geometry& g, int elem, bool backward) {
  const int tiles = backward ? 2 : 1;
  return tiles * tile_bytes(g.P, g.K + 1, elem) + max_images(g.B, g.H * g.W, g.P) * 2 * g.K * 4;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A partial-sum slot: 0 when empty, else (1 << 32) | the f32's bits, written
// and read whole (a 64-bit access is single-copy atomic) at gpu scope.
__device__ __forceinline__ void put_slot(unsigned long long* slot, float v) {
  const unsigned long long word = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(slot), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long get_slot(const unsigned long long* slot) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(word) : "l"(slot) : "memory");
  return word;
}

__device__ __forceinline__ int offset16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Split n elements from src into a scalar head up to the first 16-byte
// boundary, whole 16-byte runs, and a scalar tail.
template <typename T>
struct Runs {
  int head, vecs, tail;  // tail: the first element after the runs
  __device__ Runs(const T* src, int n) {
    head = min(n, ((16 - offset16(src)) & 15) / (int)sizeof(T));
    vecs = (n - head) * (int)sizeof(T) / 16;
    tail = head + vecs * 16 / (int)sizeof(T);
  }
};

// Elements src[0, n) into the tile at buf, element j at buf + offset16(src)
// + j*elem: 16-byte cp.async for the runs (not waited on here), scalar
// loads for the head and tail.
template <typename T>
__device__ __forceinline__ void stage(unsigned char* buf, const T* __restrict__ src, int n) {
  const Runs<T> r(src, n);
  const int shift = offset16(src);
  const uint32_t vdst = smem_u32(buf + shift + r.head * sizeof(T));
  const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(src + r.head);
  for (int i = threadIdx.x; i < r.vecs; i += THREADS) cp_async16(vdst + 16 * i, vsrc + 16 * i);
  T* dst = reinterpret_cast<T*>(buf + shift);
  for (int j = threadIdx.x; j < r.head; j += THREADS) dst[j] = src[j];
  for (int j = r.tail + threadIdx.x; j < n; j += THREADS) dst[j] = src[j];
}

// The tile at buf (element j at buf + offset16(dst) + j*elem) out to dst[0, n).
template <typename T>
__device__ __forceinline__ void unstage(const unsigned char* buf, T* __restrict__ dst, int n) {
  const Runs<T> r(dst, n);
  const int shift = offset16(dst);
  const uint4* vsrc = reinterpret_cast<const uint4*>(buf + shift + r.head * sizeof(T));
  uint4* vdst = reinterpret_cast<uint4*>(dst + r.head);
  for (int i = threadIdx.x; i < r.vecs; i += THREADS) vdst[i] = vsrc[i];
  const T* src = reinterpret_cast<const T*>(buf + shift);
  for (int j = threadIdx.x; j < r.head; j += THREADS) dst[j] = src[j];
  for (int j = r.tail + threadIdx.x; j < n; j += THREADS) dst[j] = src[j];
}

// The centers (truncf(kpt) / stride, as (cx, cy)) of images b0 .. b0+n-1,
// (n, K, 2).
__device__ __forceinline__ void load_centers(float* centers, const float* __restrict__ kpts,
                                             const Geometry& g, int b0, int n) {
  const int per_image = 2 * g.K;
  for (int i = threadIdx.x; i < n * per_image; i += THREADS) {
    const int s = i / per_image;
    const int r = i - s * per_image;
    const float v = kpts[(size_t)(b0 + s) * g.K * g.kpts_row + (r >> 1) * g.kpts_row + (r & 1)];
    centers[i] = truncf(v) / (float)g.stride;
  }
}

// d2 / sigma^2 beyond which a joint's target is 0: exp(-9.4 / 2) = 0.0091,
// under the 0.0099 cut by far more than expf's and the division's rounding,
// so skipping the division and the expf there gives the same bits.
constexpr float ZERO_D2_OVER_SIGMA_SQ = 9.4f;

// One joint's target at pixel (gx, gy), as _targets_for_block (:35-38);
// d2_zero = ZERO_D2_OVER_SIGMA_SQ * sigma_sq.
__device__ __forceinline__ float joint_heat(float gx, float gy, float cx, float cy,
                                            float sigma_sq, float d2_zero) {
  const float dx = gx - cx;
  const float dy = gy - cy;
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  if (d2 >= d2_zero) return 0.0f;  // most joints of most pixels
  float h = expf(-d2 / 2.0f / sigma_sq);
  h = h > 1.0f ? 1.0f : h;
  return h < 0.0099f ? 0.0f : h;
}

// Threads a pixel: 1 where the tile has THREADS / 2 pixels or more; below
// that, doubled while P * tpp stays under THREADS / 2 and tpp within a warp
// and below K (no more threads than joints).
__device__ __forceinline__ int threads_per_pixel(int P, int K) {
  int tpp = 1;
  while (tpp < 32 && tpp < K && tpp * P < THREADS / 2) tpp *= 2;
  return tpp;
}

// f(k, heat_k) for the pixel's joints j, j + tpp, ... (none when !active),
// then the max of heat over the pixel's tpp threads (lanes aligned in a
// group of tpp, every lane of the warp taking part): fully unrolled for a
// compile-time KT, a loop for the generic K (KT = 0).
template <int KT, typename F>
__device__ __forceinline__ float heat_max(bool active, int K, int j, int tpp, const float* cen,
                                          float gx, float gy, float sigma_sq, F f) {
  float hmax = 0.0f;
  const float d2_zero = ZERO_D2_OVER_SIGMA_SQ * sigma_sq;
  auto joint = [&](int k) {
    const float h = joint_heat(gx, gy, cen[2 * k], cen[2 * k + 1], sigma_sq, d2_zero);
    hmax = fmaxf(hmax, h);
    f(k, h);
  };
  if (active) {
    if constexpr (KT > 0) {
      if (tpp == 1) {  // large tiles: no index arithmetic in the unrolled loop
#pragma unroll
        for (int k = 0; k < KT; ++k) joint(k);
      } else {
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          if (j + i * tpp < KT) joint(j + i * tpp);
        }
      }
    } else {
      for (int k = j; k < K; k += tpp) joint(k);
    }
  }
  for (int off = tpp >> 1; off > 0; off >>= 1)  // max is exact in any order
    hmax = fmaxf(hmax, __shfl_xor_sync(0xffffffffu, hmax, off));
  return hmax;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    if (lane < THREADS / 32) v = warp_sums[lane];
    v = warp_sum(v);
  }
  return v;
}

// The thread's place in the tile that starts at pixel q0 in image b0:
// pixel p of the tile, joint offset j in its group of tpp, and the
// pixel's image slot in the centers table and grid position (for an
// active thread only).
struct Place {
  int p, j, slot;
  bool active;
  float gx, gy;
  __device__ Place(const Geometry& g, int tpp, int q0, int b0, int n) {
    p = threadIdx.x / tpp;
    j = threadIdx.x & (tpp - 1);
    active = p < n;
    slot = 0;
    gx = gy = 0.0f;
    if (active) {
      const int hw = g.H * g.W;
      const int q = q0 + p;
      const int b = q / hw;
      const int r = q - b * hw;
      const int y = r / g.W;
      slot = b - b0;
      gx = (float)(r - y * g.W);
      gy = (float)y;
    }
  }
};

template <typename T, int KT>
__global__ void __launch_bounds__(THREADS)
heatmap_mse_fwd_kernel(const T* __restrict__ pred, const float* __restrict__ kpts,
                       unsigned long long* __restrict__ slots, float* __restrict__ out,
                       Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == gridDim.x - 1) {  // the reducer
    // thread t adds slots t, t + THREADS, ... in order as they fill, and
    // empties each for the next launch; then the fixed tree
    float v = 0.0f;
    for (int i = threadIdx.x; i < (int)gridDim.x - 1; i += THREADS) {
      unsigned long long word;
      do {
        word = get_slot(slots + i);
      } while ((word >> 32) == 0);
      v += __uint_as_float(static_cast<unsigned int>(word));
      slots[i] = 0ull;
    }
    v = block_sum(v);
    if (threadIdx.x == 0) out[0] = v / g.n_elems;
    return;
  }
  const int K = KT > 0 ? KT : g.K;
  const int C = K + 1;
  const int pixels = g.B * g.H * g.W;
  float* centers = reinterpret_cast<float*>(smem + tile_bytes(g.P, C, sizeof(T)));
  const T* tile = reinterpret_cast<const T*>(smem + offset16(pred));
  const int tpp = threads_per_pixel(g.P, K);
  float acc = 0.0f;
  for (int i = 0; i < g.tiles_per_block; ++i) {
    const int t = blockIdx.x * g.tiles_per_block + i;
    if (t >= g.tiles) break;
    const int q0 = t * g.P;
    const int n = min(g.P, pixels - q0);
    const int b0 = q0 / (g.H * g.W);
    stage(smem, pred + (size_t)q0 * C, n * C);
    load_centers(centers, kpts, g, b0, (q0 + n - 1) / (g.H * g.W) - b0 + 1);
    cp_async_wait_all();
    __syncthreads();
    const Place at(g, tpp, q0, b0, n);
    const T* v = tile + at.p * C;
    const float hmax = heat_max<KT>(at.active, K, at.j, tpp, centers + at.slot * 2 * K, at.gx,
                                    at.gy, g.sigma_sq, [&](int k, float h) {
                                      const float d = to_float(v[k + 1]) - h;
                                      acc += d * d;
                                    });
    if (at.active && at.j == 0) {
      const float d0 = to_float(v[0]) - (1.0f - hmax);
      acc += d0 * d0;
    }
    __syncthreads();  // the next tile overwrites this one
  }
  acc = block_sum(acc);

  if (threadIdx.x == 0) put_slot(slots + blockIdx.x, acc);
}

template <typename T, int KT>
__global__ void __launch_bounds__(THREADS)
heatmap_mse_bwd_kernel(const T* __restrict__ pred, const float* __restrict__ kpts,
                       const float* __restrict__ g_in, T* __restrict__ dpred, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = KT > 0 ? KT : g.K;
  const int C = K + 1;
  const int pixels = g.B * g.H * g.W;
  unsigned char* in = smem;
  unsigned char* out = smem + tile_bytes(g.P, C, sizeof(T));
  float* centers = reinterpret_cast<float*>(out + tile_bytes(g.P, C, sizeof(T)));
  const T* tile_in = reinterpret_cast<const T*>(in + offset16(pred));
  T* tile_out = reinterpret_cast<T*>(out + offset16(dpred));
  const float scale = __ldg(g_in) * 2.0f / g.n_elems;  // _bwd :109
  const int tpp = threads_per_pixel(g.P, K);
  for (int i = 0; i < g.tiles_per_block; ++i) {
    const int t = blockIdx.x * g.tiles_per_block + i;
    if (t >= g.tiles) break;
    const int q0 = t * g.P;
    const int n = min(g.P, pixels - q0);
    const int b0 = q0 / (g.H * g.W);
    stage(in, pred + (size_t)q0 * C, n * C);
    load_centers(centers, kpts, g, b0, (q0 + n - 1) / (g.H * g.W) - b0 + 1);
    cp_async_wait_all();
    __syncthreads();
    const Place at(g, tpp, q0, b0, n);
    const T* v = tile_in + at.p * C;
    T* d = tile_out + at.p * C;
    const float hmax = heat_max<KT>(at.active, K, at.j, tpp, centers + at.slot * 2 * K, at.gx,
                                    at.gy, g.sigma_sq, [&](int k, float h) {
                                      d[k + 1] = from_float<T>((to_float(v[k + 1]) - h) * scale);
                                    });
    if (at.active && at.j == 0) d[0] = from_float<T>((to_float(v[0]) - (1.0f - hmax)) * scale);
    __syncthreads();
    unstage(out, dpred + (size_t)q0 * C, n * C);
    // the next tile's compute writes `out` only after the barrier that
    // follows its staging, by when every thread has written this one out
  }
}

template <typename T, int KT>
int forward(const void* pred, const void* kpts, void* slots, void* out, const Geometry& g,
            int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(g, sizeof(T), false);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  heatmap_mse_fwd_kernel<T, KT><<<blocks + 1, THREADS, smem, stream>>>(  // + the reducer
      static_cast<const T*>(pred), static_cast<const float*>(kpts),
      static_cast<unsigned long long*>(slots), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T, int KT>
int backward(const void* pred, const void* kpts, const void* g_in, void* dpred,
             const Geometry& g, int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(g, sizeof(T), true);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  heatmap_mse_bwd_kernel<T, KT><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(pred), static_cast<const float*>(kpts),
      static_cast<const float*>(g_in), static_cast<T*>(dpred), g);
  return (int)cudaGetLastError();
}

// The instantiation for g.K: the datasets' widths, else the generic one.
template <typename T, typename Launch>
int by_joints(int K, Launch launch) {
  switch (K) {
    case 13: return launch.template operator()<T, 13>();
    case 14: return launch.template operator()<T, 14>();
    case 16: return launch.template operator()<T, 16>();
    case 19: return launch.template operator()<T, 19>();
    default: return launch.template operator()<T, 0>();
  }
}

Geometry geometry(int B, int H, int W, int K, int kpts_row, int stride, float sigma_sq,
                  int tile_pixels, int tiles_per_block) {
  const int pixels = B * H * W;
  const int tiles = (pixels + tile_pixels - 1) / tile_pixels;
  return Geometry{B, H, W, K, kpts_row, stride, sigma_sq,
                  (float)((long long)pixels * (K + 1)), tile_pixels, tiles, tiles_per_block};
}

bool valid(const Geometry& g, int blocks) {
  return g.P > 0 && g.P <= THREADS && g.P % 8 == 0 && g.tiles_per_block > 0 &&
         (long long)blocks * g.tiles_per_block >= g.tiles &&
         (long long)(blocks - 1) * g.tiles_per_block < g.tiles;
}

struct ForwardLaunch {
  const void *pred, *kpts;
  void *slots, *out;
  const Geometry& g;
  int blocks;
  cudaStream_t stream;
  template <typename T, int KT>
  int operator()() const {
    return forward<T, KT>(pred, kpts, slots, out, g, blocks, stream);
  }
};

struct BackwardLaunch {
  const void *pred, *kpts, *g_in;
  void* dpred;
  const Geometry& g;
  int blocks;
  cudaStream_t stream;
  template <typename T, int KT>
  int operator()() const {
    return backward<T, KT>(pred, kpts, g_in, dpred, g, blocks, stream);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  kpts_row: floats between two keypoints (2 or 3).
// sigma_sq = sigma * sigma.  tile_pixels, tiles_per_block, blocks: the plan
// of ops/kernels/heatmap_mse.py::tile_plan.  slots: `blocks` 64-bit words,
// 0 before the first launch and after every launch.  Returns a cudaError_t.
int heatmap_mse_forward(int dtype, const void* pred, const void* kpts, int kpts_row, void* slots,
                        void* out, int B, int H, int W, int K, int stride, float sigma_sq,
                        int tile_pixels, int tiles_per_block, int blocks, void* stream) {
  const Geometry g = geometry(B, H, W, K, kpts_row, stride, sigma_sq, tile_pixels,
                              tiles_per_block);
  if (!valid(g, blocks)) return (int)cudaErrorInvalidValue;
  const ForwardLaunch launch{pred, kpts, slots, out, g, blocks, static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? by_joints<float>(K, launch) : by_joints<__nv_bfloat16>(K, launch);
}

// g_in: the incoming 0-dim f32 cotangent, on the device.
int heatmap_mse_backward(int dtype, const void* pred, const void* kpts, int kpts_row,
                         const void* g_in, void* dpred, int B, int H, int W, int K, int stride,
                         float sigma_sq, int tile_pixels, int tiles_per_block, int blocks,
                         void* stream) {
  const Geometry g = geometry(B, H, W, K, kpts_row, stride, sigma_sq, tile_pixels,
                              tiles_per_block);
  if (!valid(g, blocks)) return (int)cudaErrorInvalidValue;
  const BackwardLaunch launch{pred, kpts, g_in, dpred, g, blocks,
                              static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? by_joints<float>(K, launch) : by_joints<__nv_bfloat16>(K, launch);
}

const char* heatmap_mse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
