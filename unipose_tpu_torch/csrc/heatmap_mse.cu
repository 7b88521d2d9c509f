// Fused Gaussian-target MSE loss and its gradient, for Hopper.
//
// Replaces the Pallas TPU kernels of unipose_tpu/ops/pallas/heatmap_loss.py:86
// (`heatmap_mse`, a custom VJP): the forward `_sq_err_sum` (:67, pallas_call
// :70, body `_fwd_kernel` :43) and the backward `_bwd` (:106, pallas_call
// :111, body `_bwd_kernel` :59).  Both build the (K+1)-channel target from
// the (B, K, 2) keypoints where they need it, as `_targets_for_block`
// (:27-40) does, so the target never exists in device memory:
//
//   cx, cy = truncf(x) / stride, truncf(y) / stride
//   heat_k = expf(-d2 / 2 / (sigma * sigma)),  d2 on the integer pixel grid
//   heat_k = min(heat_k, 1); heat_k < 0.0099 -> 0
//   target = [1 - max_k heat_k, heat_0, ..., heat_{K-1}]
//   forward : loss  = sum((pred - target)^2) / N,  N = B*H*W*(K+1)
//   backward: dpred = (pred - target) * (2 * g / N), g read on the device
//
// pred is NHWC (B, H, W, K+1), f32 or bf16 (computed in f32; dpred written
// in pred's type, :50, :64); kpts are f32 (B, K, 2) pixel coordinates.
// expf, IEEE division and no FMA in d2: no fast math, so that a value near
// the 0.0099 threshold falls on the side it falls on in the plain version.
//
// Work and bound on the main path (pred (8, 46, 46, 15) f32, LSP at 368x368):
// the forward reads pred once, 8*46*46*15*4 B = 1.02 MB, about 0.30 us at
// 3.35 TB/s; the backward reads pred and writes dpred, 2.03 MB, about 0.61 us.
// The 14 * 2116 * 8 = 0.24 M expf are negligible beside that.  At these
// sizes a launch (a few us) costs more than the bytes, so launch latency and
// not bandwidth sets the time; the design is the simple one.
//
// Design.  One thread per output pixel (b, y, x), blocks of THREADS pixels of
// one image (grid THREADS-pixel tiles x B).  A block loads its image's K
// centers into shared memory; each thread builds its pixel's K+1 targets in
// registers against its K+1 contiguous pred values.  The TPU kernel carries
// its sum across sequential grid steps (:46-56); blocks here run in no
// order, so the forward writes one partial sum per block and a second
// one-block launch adds the partials in a fixed order and divides by N.  No
// float atomics: the loss is bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // pixels a block
constexpr int FINAL_THREADS = 256;  // the partial-sum launch

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

// One joint's target at pixel (gx, gy), as _targets_for_block (:35-38).
__device__ __forceinline__ float joint_heat(float gx, float gy, float cx, float cy,
                                            float sigma_sq) {
  const float dx = gx - cx;
  const float dy = gy - cy;
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  float h = expf(-d2 / 2.0f / sigma_sq);
  h = h > 1.0f ? 1.0f : h;
  return h < 0.0099f ? 0.0f : h;
}

// The image's centers (truncf(kpt) / stride), (K, 2) as (cx, cy).
__device__ __forceinline__ void load_centers(float* centers, const float* kpts, int b, int K,
                                             int stride) {
  for (int i = threadIdx.x; i < 2 * K; i += blockDim.x) {
    centers[i] = truncf(kpts[(size_t)b * 2 * K + i]) / (float)stride;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
template <int NT>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[NT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    if (lane < NT / 32) v = warp_sums[lane];
    v = warp_sum(v);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
heatmap_mse_fwd_kernel(const T* __restrict__ pred, const float* __restrict__ kpts,
                       float* __restrict__ partials, int H, int W, int K, int stride,
                       float sigma_sq) {
  extern __shared__ float centers[];
  const int b = blockIdx.y;
  load_centers(centers, kpts, b, K, stride);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  float acc = 0.0f;
  if (p < H * W) {
    const float gy = (float)(p / W);
    const float gx = (float)(p % W);
    const T* px = pred + ((size_t)b * H * W + p) * (K + 1);
    float hmax = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float h = joint_heat(gx, gy, centers[2 * k], centers[2 * k + 1], sigma_sq);
      hmax = fmaxf(hmax, h);
      const float d = to_float(px[k + 1]) - h;
      acc += d * d;
    }
    const float d0 = to_float(px[0]) - (1.0f - hmax);
    acc += d0 * d0;
  }
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(FINAL_THREADS)
heatmap_mse_finalize_kernel(const float* __restrict__ partials, int n, float n_elems,
                            float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += FINAL_THREADS) acc += partials[i];
  acc = block_sum<FINAL_THREADS>(acc);
  if (threadIdx.x == 0) out[0] = acc / n_elems;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
heatmap_mse_bwd_kernel(const T* __restrict__ pred, const float* __restrict__ kpts,
                       const float* __restrict__ g, T* __restrict__ dpred, int H, int W,
                       int K, int stride, float sigma_sq, float n_elems) {
  extern __shared__ float centers[];
  const int b = blockIdx.y;
  load_centers(centers, kpts, b, K, stride);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const float scale = g[0] * 2.0f / n_elems;  // _bwd :109
  const float gy = (float)(p / W);
  const float gx = (float)(p % W);
  const size_t base = ((size_t)b * H * W + p) * (K + 1);
  const T* px = pred + base;
  T* dx = dpred + base;
  float hmax = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float h = joint_heat(gx, gy, centers[2 * k], centers[2 * k + 1], sigma_sq);
    hmax = fmaxf(hmax, h);
    dx[k + 1] = from_float<T>((to_float(px[k + 1]) - h) * scale);
  }
  dx[0] = from_float<T>((to_float(px[0]) - (1.0f - hmax)) * scale);
}

int tiles(int H, int W) { return (H * W + THREADS - 1) / THREADS; }

template <typename T>
int forward(const void* pred, const void* kpts, void* partials, void* out, int B, int H, int W,
            int K, int stride, float sigma_sq, float n_elems, cudaStream_t stream) {
  const dim3 grid(tiles(H, W), B);
  const size_t smem = 2 * K * sizeof(float);
  heatmap_mse_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pred), static_cast<const float*>(kpts),
      static_cast<float*>(partials), H, W, K, stride, sigma_sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heatmap_mse_finalize_kernel<<<1, FINAL_THREADS, 0, stream>>>(
      static_cast<const float*>(partials), B * tiles(H, W), n_elems, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* pred, const void* kpts, const void* g, void* dpred, int B, int H, int W,
             int K, int stride, float sigma_sq, float n_elems, cudaStream_t stream) {
  const dim3 grid(tiles(H, W), B);
  const size_t smem = 2 * K * sizeof(float);
  heatmap_mse_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pred), static_cast<const float*>(kpts),
      static_cast<const float*>(g), static_cast<T*>(dpred), H, W, K, stride, sigma_sq,
      n_elems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of f32 partial sums the forward writes (the caller's scratch).
int heatmap_mse_num_partials(int B, int H, int W) { return B * tiles(H, W); }

// dtype: 0 = f32, 1 = bf16.  sigma_sq = sigma * sigma; n_elems = B*H*W*(K+1)
// as f32 (the JAX kernel's f32(pred.size)).  Returns a cudaError_t.
int heatmap_mse_forward(int dtype, const void* pred, const void* kpts, void* partials, void* out,
                        int B, int H, int W, int K, int stride, float sigma_sq, float n_elems,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(pred, kpts, partials, out, B, H, W, K, stride, sigma_sq, n_elems, s);
  return forward<__nv_bfloat16>(pred, kpts, partials, out, B, H, W, K, stride, sigma_sq,
                                n_elems, s);
}

// g: the incoming 0-dim f32 cotangent, on the device.
int heatmap_mse_backward(int dtype, const void* pred, const void* kpts, const void* g,
                         void* dpred, int B, int H, int W, int K, int stride, float sigma_sq,
                         float n_elems, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(pred, kpts, g, dpred, B, H, W, K, stride, sigma_sq, n_elems, s);
  return backward<__nv_bfloat16>(pred, kpts, g, dpred, B, H, W, K, stride, sigma_sq, n_elems,
                                 s);
}

const char* heatmap_mse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
