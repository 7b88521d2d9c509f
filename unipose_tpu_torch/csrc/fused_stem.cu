// Fused eval-mode ResNet stem for Hopper.
//
// Replaces the Pallas TPU kernel unipose_tpu/ops/pallas/stem.py:119
// (`fused_stem`, body `_stem_kernel` :65) and computes what it computes, on
// weights folded by unipose_tpu_torch/ops/kernels/fused_stem.py::fold_stem_params:
//
//   conv = conv7x7/2 pad 3 (x)             as the exact 4x4 space-to-depth form
//   act  = relu(conv * scale + bias)       eval BatchNorm folded, f32
//   out  = maxpool3x3/2 pad 1 (act)        only this tensor is written
//
// x is (B, H, W, 3) NHWC, f32 or bf16; out is (B, ceil(H/4), ceil(W/4), 64)
// in x's dtype.  Products accumulate in f32 and the result is rounded once,
// at the output, as the Pallas kernel does (:90, :113).
//
// Layout on this card.  The TPU kernel feeds its matrix unit a 12-deep
// contraction by building the space-to-depth(2) tensor, padding it and moving
// channels into the sublane dim (:124-130).  Here none of that is built: the
// (192, 64) tap-major weights w4[(ti*4 + tj)*12 + (dy*2 + dx)*3 + c] are read
// as an 8x8 stride-2 conv over the image itself, tap (u, v) = (2ti + dy,
// 2tj + dx) of conv output (r, q) reading pixel (2r + u - 4, 2q + v - 4).
// Pixels outside the image read as 0, which makes every H and W exact (the
// 7x7/2 conv of an odd-sized image is the conv of that image with one zero
// row or column added), so the TPU grid's (H/4) % 4 == 0 and square-input
// constraints (:125-126) do not apply.  Weights that come from a 7x7 conv
// have zero taps in row u = 0 and column v = 0; a block finds that in the
// weights it loaded and then skips them: 147 products an output instead of
// 192.  Every value after the ReLU is >= 0 and every pool window holds at
// least one in-image conv output, so the pool takes the max over in-image
// conv outputs, starting from 0: exactly the -inf-padded pool.
//
// What bounds it.  At 368x368 an image is 184^2 x 64 conv outputs x 147
// products (0.637 GFLOP) against 0.81 MB read and 1.08 MB written in bf16:
// operations bound it (0.64 us at 989 TFLOP/s bf16; 9.5 us in f32 at
// 67 TFLOP/s).  What the TPU kernel keeps out of device memory is the
// 184^2 x 64 conv output, which the unfused stem writes and reads back about
// four times (~26 MB an image in bf16).  So one block computes an 8x8 tile of
// pooled outputs for all 64 channels: it holds its 17x17x64 f32 conv tile
// (74 KB), the 40x40x3 input patch and the weights in shared memory (143 KB,
// dynamic), and writes only the pooled tile.  Both spatial dims are tiled:
// 144 blocks an image at 368x368, so batch 1 already covers the 132 SMs.
// Each thread accumulates 4 conv positions x 4 channels in registers (one
// float4 weight load and four broadcast patch loads a tap for 16 FMAs) on
// the CUDA cores; tensor cores (wgmma) and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C_OUT = 64;
constexpr int TAPS = 192;          // 8 x 8 taps x 3 channels
constexpr int TP = 8;              // pooled tile edge
constexpr int TC = 2 * TP + 1;     // conv tile edge (pool halo included)
constexpr int NP = 4 * TP + 8;     // input patch edge
constexpr int THREADS = 256;
constexpr int CG = C_OUT / 4;      // channel groups of 4
constexpr int PG = THREADS / CG;   // position groups
constexpr int RB = 4;              // conv positions a thread holds at once
constexpr int SMEM_FLOATS = TAPS * C_OUT + 3 * NP * NP + TC * TC * C_OUT + 2 * C_OUT;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 max4(float4 a, const float4 b) {
  a.x = fmaxf(a.x, b.x);
  a.y = fmaxf(a.y, b.y);
  a.z = fmaxf(a.z, b.z);
  a.w = fmaxf(a.w, b.w);
  return a;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_stem_kernel(const T* __restrict__ x, const T* __restrict__ w4,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  T* __restrict__ out, int H, int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [(u*8 + v)*3 + c][64]
  float* conv_s = w_s + TAPS * C_OUT;         // [jy*TC + jx][64]
  float* patch = conv_s + TC * TC * C_OUT;    // [c][row][col]
  float* sb = patch + 3 * NP * NP;            // scale[64], bias[64]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;

  // Weights, re-indexed by the 8x8 tap they stand for.
  int edge_nonzero = 0;
  for (int i = tid; i < TAPS * C_OUT; i += THREADS) {
    const int k = i / C_OUT, ch = i % C_OUT;
    const int tap = k / 12, rem = k % 12;
    const int u = 2 * (tap / 4) + rem / 6, v = 2 * (tap % 4) + (rem / 3) % 2;
    const float val = to_float(w4[i]);
    w_s[((u * 8 + v) * 3 + rem % 3) * C_OUT + ch] = val;
    edge_nonzero |= (u == 0 || v == 0) && val != 0.f;
  }
  if (tid < 2 * C_OUT) sb[tid] = tid < C_OUT ? scale[tid] : bias[tid - C_OUT];

  // Patch pixel (i, j) is image pixel (4*py0 - 6 + i, 4*px0 - 6 + j).
  const int r0 = 4 * py0 - 6, c0 = 4 * px0 - 6;
  const T* xb = x + (size_t)b * H * W * 3;
  for (int i = tid; i < NP * NP * 3; i += THREADS) {
    const int c = i % 3, p = i / 3;
    const int r = r0 + p / NP, q = c0 + p % NP;
    patch[(c * NP + p / NP) * NP + p % NP] =
        (r >= 0 && r < H && q >= 0 && q < W) ? to_float(xb[((size_t)r * W + q) * 3 + c]) : 0.f;
  }
  const int u0 = __syncthreads_or(edge_nonzero) ? 0 : 1;

  const int cg = tid % CG, pg = tid / CG;
  const float4 sc = *reinterpret_cast<const float4*>(sb + 4 * cg);
  const float4 bi = *reinterpret_cast<const float4*>(sb + C_OUT + 4 * cg);

  // Conv tile position q = jy*TC + jx is conv output (2*py0 - 1 + jy, 2*px0 - 1 + jx).
  for (int q0 = pg * RB; q0 < TC * TC; q0 += PG * RB) {
    int base[RB];
    float4 acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int q = min(q0 + r, TC * TC - 1);
      base[r] = 2 * (q / TC) * NP + 2 * (q % TC);
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int u = u0; u < 8; ++u) {
      for (int v = u0; v < 8; ++v) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 wv =
              *reinterpret_cast<const float4*>(w_s + ((u * 8 + v) * 3 + c) * C_OUT + 4 * cg);
          const float* pp = patch + c * NP * NP + u * NP + v;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float a = pp[base[r]];
            acc[r].x = fmaf(a, wv.x, acc[r].x);
            acc[r].y = fmaf(a, wv.y, acc[r].y);
            acc[r].z = fmaf(a, wv.z, acc[r].z);
            acc[r].w = fmaf(a, wv.w, acc[r].w);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int q = q0 + r;
      if (q >= TC * TC) break;
      const int cr = 2 * py0 - 1 + q / TC, cc = 2 * px0 - 1 + q % TC;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);  // outside the conv output: 0, see above
      if (cr >= 0 && cr < Hc && cc >= 0 && cc < Wc) {
        y.x = fmaxf(acc[r].x * sc.x + bi.x, 0.f);
        y.y = fmaxf(acc[r].y * sc.y + bi.y, 0.f);
        y.z = fmaxf(acc[r].z * sc.z + bi.z, 0.f);
        y.w = fmaxf(acc[r].w * sc.w + bi.w, 0.f);
      }
      *reinterpret_cast<float4*>(conv_s + q * C_OUT + 4 * cg) = y;
    }
  }
  __syncthreads();

  // Pooled (py0 + ly, px0 + lx) takes conv tile rows 2ly..2ly+2, cols 2lx..2lx+2.
  for (int p = pg; p < TP * TP; p += PG) {
    const int ly = p / TP, lx = p % TP;
    const int py = py0 + ly, px = px0 + lx;
    if (py >= Hp || px >= Wp) continue;
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = max4(m, *reinterpret_cast<const float4*>(
                        conv_s + ((2 * ly + dy) * TC + 2 * lx + dx) * C_OUT + 4 * cg));
    store4(out + (((size_t)b * Hp + py) * Wp + px) * C_OUT + 4 * cg, m);
  }
}

template <typename T>
int run(const void* x, const void* w4, const float* scale, const float* bias, void* out, int B,
        int H, int W, cudaStream_t st) {
  const int Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const int Hp = (Hc + 1) / 2, Wp = (Wc + 1) / 2;
  cudaError_t e = cudaFuncSetAttribute(fused_stem_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Wp + TP - 1) / TP, (Hp + TP - 1) / TP, B);
  fused_stem_kernel<T><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w4), scale, bias, static_cast<T*>(out), H,
      W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, 3) and w4 (192, 64) of one dtype (0 = f32, 1 = bf16), scale
// and bias (64,) f32, out (B, ceil(H/4), ceil(W/4), 64) of x's dtype; every
// pointer 16-byte aligned.  Returns 0 or the first cudaError_t raised.
int fused_stem_forward(int dtype, const void* x, const void* w4, const float* scale,
                       const float* bias, void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w4, scale, bias, out, B, H, W, st);
  if (dtype == 1) return run<__nv_bfloat16>(x, w4, scale, bias, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}

const char* fused_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
