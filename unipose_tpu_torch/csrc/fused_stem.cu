// Fused eval-mode ResNet stem for Hopper.
//
// Replaces the Pallas TPU kernel unipose_tpu/ops/pallas/stem.py:119
// (`fused_stem`, body `_stem_kernel` :65, `pallas_call` :133) and computes
// what it computes, on weights folded by
// unipose_tpu_torch/ops/kernels/fused_stem.py::fold_stem_params:
//
//   conv = conv7x7/2 pad 3 (x)             as the exact 4x4 space-to-depth form
//   act  = relu(conv * scale + bias)       eval BatchNorm folded, f32
//   out  = maxpool3x3/2 pad 1 (act)        only this tensor is written
//
// x is (B, H, W, 3) NHWC, f32 or bf16; out is (B, ceil(H/4), ceil(W/4), 64)
// in x's dtype.  Products accumulate in f32 and the result is rounded once,
// at the output, as the Pallas kernel does (:90, :113).  The (192, 64)
// folded weights are tap-major: w4[(ti*4 + tj)*12 + (dy*2 + dx)*3 + c],
// tap (ti, tj) of conv output (r, q) reading space-to-depth(2) pixel
// (r + ti - 2, q + tj - 2), i.e. image pixel (2r + 2ti + dy - 4,
// 2q + 2tj + dx - 4).  Pixels outside the image read as 0, which makes
// every H and W exact (the 7x7/2 conv of an odd-sized image is the conv of
// that image with one zero row or column added), so the TPU grid's
// (H/4) % 4 == 0 and square-input constraints (:125-126) do not apply.
// Every value after the ReLU is >= 0 and every pool window holds at least
// one in-image conv output, so the pool takes the max over in-image conv
// outputs, starting from 0: exactly the -inf-padded pool.
//
// What bounds it.  At 368x368 an image is 184^2 x 64 conv outputs x 147
// products (0.637 GFLOP) against 0.81 MB read and 1.08 MB written in bf16:
// operations bound it (0.64 us at 989 TFLOP/s bf16; 9.5 us in f32 at
// 67 TFLOP/s).  What the TPU kernel keeps out of device memory is the
// 184^2 x 64 conv output, which the unfused stem writes and reads back
// about four times (~26 MB an image in bf16).  So one block computes an 8x8
// tile of pooled outputs for all 64 channels from the 17x17 conv tile
// behind it, in shared memory, and writes only the pooled tile: 144 blocks
// an image at 368x368.  In practice the bf16 kernel is bounded by the
// block's input staging (a 40x40x3 patch scattered into space-to-depth
// layout, 32 KB of weights from L2) and the epilogue, not by the MMAs.
//
// bf16: the TPU's contraction on the tensor cores (fused_stem_mma_kernel).
// The TPU kernel gave its matrix unit the 12-deep space-to-depth
// contraction (stem.py:82-91); here it is fitted to mma.sync's k = 16:
//   - the input tile is held as 20x20 space-to-depth(2) pixels of 16 bf16
//     channels (12 real, 4 zero; 32 bytes a pixel, 12.8 KB), so each of the
//     16 taps (ti, tj) is exactly one k16 step: 16 MMA k-steps per 16-row
//     M tile, a 256-deep padded contraction (147 products are real);
//   - A fragments come by ldmatrix straight from that tile: row (jy, jx) of
//     an M tile reads s2d pixel (jy + ti, jx + tj), a 16-byte-aligned
//     16-byte row, so the gather needs no im2col buffer.  The two halves of
//     a pixel swap on bit 2 of its index, so 8 rows of one ldmatrix hit 8
//     distinct bank groups;
//   - B is the weights packed once on the host as (16 taps, 16, 64) bf16
//     with zero rows 12-15 (32 KB), read by ldmatrix.trans; 16-byte chunk c
//     of row r sits at c ^ (r & 7);
//   - mma.sync.m16n8k16 bf16 -> f32 (wgmma would need 64-row M tiles of a
//     17-wide conv tile and buys nothing here: the MMAs are ~2.4 K a block,
//     a few microseconds at batch 32 in all); 8 warps take the 19 M tiles
//     of the 289 conv positions in turn, each for all 64 channels;
//   - epilogue: scale * acc + bias, ReLU in f32 registers, conv positions
//     outside the image set to 0, stored as bf16 to a 17x17x64 tile
//     (37 KB, chunk c of row p at c ^ (p & 7)); then the 3x3/2 pool reads
//     it with 16-byte vectors of 8 channels and writes 16-byte vectors.
// Storing the conv tile in bf16 is exact, not an approximation: rounding
// to nearest is monotonic, so round(max(a, b)) == max(round(a), round(b)),
// and the pooled output equals the f32-tile result rounded once.
// Shared memory: 32 KB weights + 12.8 KB input + 37 KB conv tile + 0.5 KB
// scale and bias = 83 KB, so two blocks of 256 threads fit an SM
// (__launch_bounds__(256, 2) caps registers at 128 a thread).
//
// f32 keeps the CUDA-core kernel (fused_stem_kernel<float>): tensor cores
// would take f32 operands as TF32 (10-bit mantissa), which misses the 1e-4
// parity bar.  It reads the weights as an 8x8 stride-2 conv over a 40x40x3
// f32 patch and holds the 17x17x64 f32 conv tile (143 KB, one block an
// SM); weights from a 7x7 conv have zero taps in row u = 0 and column
// v = 0, which a block finds in the weights it loaded and skips: 147
// products an output instead of 192.  Each thread accumulates 4 conv
// positions x 4 channels in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// ---- bf16: tensor cores -------------------------------------------------

constexpr int S2D = TC + 3;                  // s2d tile edge: conv tile + 3 taps
constexpr int MMA_THREADS = 256;
constexpr int M_TILES = (TC * TC + 15) / 16; // 19 tiles of 16 conv positions
constexpr int W16_BYTES = 16 * 16 * C_OUT * 2;  // (16 taps, 16, 64) bf16
constexpr int S2D_BYTES = S2D * S2D * 32;
constexpr int CONV_BYTES = TC * TC * C_OUT * 2;
constexpr int MMA_SMEM_BYTES = W16_BYTES + S2D_BYTES + CONV_BYTES + 2 * C_OUT * 4;

// Byte offset of 16-byte half h of s2d pixel p (the halves swap on bit 2 of p).
__device__ __forceinline__ int s2d_offset(int p, int h) { return p * 32 + ((h ^ ((p >> 2) & 1)) << 4); }

__global__ void __launch_bounds__(MMA_THREADS, 2)
fused_stem_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w16,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Hc, int Wc, int Hp,
                      int Wp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* w_s = smem_raw;               // [tap*16 + k][64] bf16, chunk c at c ^ (row & 7)
  unsigned char* s2d_s = w_s + W16_BYTES;      // [si*S2D + sj][16] bf16, see s2d_offset
  unsigned char* conv_s = s2d_s + S2D_BYTES;   // [jy*TC + jx][64] bf16, chunk c at c ^ (row & 7)
  float* sb = reinterpret_cast<float*>(conv_s + CONV_BYTES);  // scale[64], bias[64]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;

  // Weights: 256 rows of 8 16-byte chunks, copied without passing registers.
  for (int i = tid; i < 16 * 16 * 8; i += MMA_THREADS) {
    const int r = i >> 3, c = i & 7;
    cp_async16(smem_u32(w_s + r * 128 + ((c ^ (r & 7)) << 4)), w16 + r * C_OUT + c * 8);
  }
  asm volatile("cp.async.commit_group;\n");
  if (tid < 2 * C_OUT) sb[tid] = tid < C_OUT ? scale[tid] : bias[tid - C_OUT];

  // Input: patch row rr (image row r0 + rr) and s2d column sj hold image
  // pixels (2sj, 2sj + 1) x 3 channels, 6 contiguous bf16, which are s2d
  // channels dy*6 .. dy*6 + 5 (dy = rr & 1) of s2d pixel (rr >> 1, sj);
  // channels 12-15 are 0.
  for (int p = tid; p < S2D * S2D; p += MMA_THREADS)
    *reinterpret_cast<uint2*>(s2d_s + s2d_offset(p, 1) + 8) = make_uint2(0u, 0u);
  const int r0 = 4 * py0 - 6, c0 = 4 * px0 - 6;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * 3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int t = tid; t < 2 * S2D * S2D; t += MMA_THREADS) {
    const int rr = t / S2D, sj = t - (t / S2D) * S2D;
    const int r = r0 + rr, q0 = c0 + 2 * sj;
    const bool row_in = r >= 0 && r < H;
    const long long base = ((long long)r * W + q0) * 3;
    __nv_bfloat16 v[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int q = q0 + e / 3;
      v[e] = (row_in && q >= 0 && q < W) ? xb[base + e] : zero;
    }
    const int p = (rr >> 1) * S2D + sj, dy = rr & 1;
#pragma unroll
    for (int e = 0; e < 6; e += 2) {
      const int ch = dy * 6 + e;  // even: a pair never straddles the two halves
      *reinterpret_cast<__nv_bfloat162*>(s2d_s + s2d_offset(p, ch >> 3) + (ch & 7) * 2) =
          __halves2bfloat162(v[e], v[e + 1]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t s2d_base = smem_u32(s2d_s), w_base = smem_u32(w_s);
  for (int mt = warp; mt < M_TILES; mt += MMA_THREADS / 32) {
    // This lane's ldmatrix row: conv tile position p (the pad rows of the
    // last tile repeat the last position; their results are not stored).
    const int p = min(mt * 16 + (lane & 15), TC * TC - 1);
    const int pix0 = (p / TC) * S2D + p % TC;
    const int half = lane >> 4;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 16; ++tap) {
      const int pix = pix0 + (tap >> 2) * S2D + (tap & 3);
      uint32_t a[4];
      ldmatrix_x4(a, s2d_base + s2d_offset(pix, half));
      const int krow = tap * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        const int chunk = 2 * j + (lane >> 4);
        ldmatrix_x4_trans(bf, w_base + krow * 128 + ((chunk ^ (krow & 7)) << 4));
        mma_bf16(acc[2 * j], a, bf[0], bf[1]);
        mma_bf16(acc[2 * j + 1], a, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = mt * 16 + g + 8 * hr;
      if (q >= TC * TC) continue;
      const int cr = 2 * py0 - 1 + q / TC, cc = 2 * px0 - 1 + q % TC;
      const bool in = cr >= 0 && cr < Hc && cc >= 0 && cc < Wc;  // outside: 0, see above
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * tig;
        const float v0 = in ? fmaxf(acc[nt][2 * hr] * sb[n] + sb[C_OUT + n], 0.f) : 0.f;
        const float v1 = in ? fmaxf(acc[nt][2 * hr + 1] * sb[n + 1] + sb[C_OUT + n + 1], 0.f) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(conv_s + q * 128 + ((nt ^ (q & 7)) << 4) + tig * 4) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  // Pooled (py0 + ly, px0 + lx), channels 8c..8c+7, from conv tile rows
  // 2ly..2ly+2, cols 2lx..2lx+2, starting from 0.
  for (int t = tid; t < TP * TP * 8; t += MMA_THREADS) {
    const int pos = t >> 3, c = t & 7;
    const int ly = pos / TP, lx = pos % TP;
    const int py = py0 + ly, px = px0 + lx;
    if (py >= Hp || px >= Wp) continue;
    uint4 pooled = make_uint4(0u, 0u, 0u, 0u);  // bf16 +0 in every lane
    __nv_bfloat162* m = reinterpret_cast<__nv_bfloat162*>(&pooled);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int q = (2 * ly + dy) * TC + 2 * lx + dx;
        const uint4 u = *reinterpret_cast<const uint4*>(conv_s + q * 128 + ((c ^ (q & 7)) << 4));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e] = __hmax2(m[e], h[e]);
      }
    *reinterpret_cast<uint4*>(out + (((size_t)b * Hp + py) * Wp + px) * C_OUT + 8 * c) = pooled;
  }
}

int run_mma(const void* x, const void* w16, const float* scale, const float* bias, void* out,
            int B, int H, int W, cudaStream_t st) {
  const int Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const int Hp = (Hc + 1) / 2, Wp = (Wc + 1) / 2;
  cudaError_t e = cudaFuncSetAttribute(fused_stem_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Wp + TP - 1) / TP, (Hp + TP - 1) / TP, B);
  fused_stem_mma_kernel<<<grid, MMA_THREADS, MMA_SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w16), scale, bias,
      static_cast<__nv_bfloat16*>(out), H, W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
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

// x (B, H, W, 3) of dtype 0 = f32 or 1 = bf16; w: f32 the (192, 64) w4,
// bf16 the (16, 16, 64) packed weights (ops/kernels/fused_stem.py::
// pack_stem_weights); scale and bias (64,) f32; out (B, ceil(H/4),
// ceil(W/4), 64) of x's dtype; every pointer 16-byte aligned.  Returns 0 or
// the first cudaError_t raised.
int fused_stem_forward(int dtype, const void* x, const void* w, const float* scale,
                       const float* bias, void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, w, scale, bias, out, B, H, W, st);
  if (dtype == 1) return run_mma(x, w, scale, bias, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the kernel for `dtype` that fit one SM at once, or -1.
int fused_stem_blocks_per_sm(int dtype) {
  int n = -1;
  cudaError_t e;
  if (dtype == 0) {
    e = cudaFuncSetAttribute(fused_stem_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_stem_kernel<float>, THREADS,
                                                        SMEM_BYTES);
  } else {
    e = cudaFuncSetAttribute(fused_stem_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MMA_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_stem_mma_kernel, MMA_THREADS,
                                                        MMA_SMEM_BYTES);
  }
  return e == cudaSuccess ? n : -1;
}

const char* fused_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
