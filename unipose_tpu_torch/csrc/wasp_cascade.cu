// Fused eval-mode WASP (waterfall atrous spatial pooling) for Hopper.
//
// Replaces the Pallas TPU kernel unipose_tpu/ops/pallas/wasp_cascade.py:167
// (`wasp_cascade`, body `_wasp_kernel` :116, `_dilated_conv_relu` :91,
// `pallas_call` :197) and computes what it computes, on weights folded by
// unipose_tpu_torch/ops/kernels/wasp_cascade.py::fold_wasp_params:
//
//   x1 = relu(x @ w1 + b1)                    aspp1, 1x1 2048 -> 256
//   x2 = relu(dil3x3(x1, w2, d0) + b2)         cascaded dilated 3x3 convs,
//   x3 = relu(dil3x3(x2, w3, d1) + b3)         taps wholly in the zero
//   x4 = relu(dil3x3(x3, w4, d2) + b4)         padding (|offset| >= S) skipped
//   br_i = x_i @ w2eff                         the double conv2, collapsed
//   x5 = relu(mean_hw(x) @ wg + bg)            GAP branch, broadcast to S x S
//   y  = relu([br_1..br_4, x5] @ wc + bc)      concat 1280 -> 256
//
// Rounding points are the Pallas kernel's: every product accumulates in
// f32; x1..x4, the branches, the GAP mean and x5 are rounded to the input
// dtype (f32 or bf16) where :138-155 round them; biases are f32.
//
// Work at 368x368, output stride 16 (S = 23), per image: about 1.53 G
// multiply-adds (3.05 GFLOP) -- aspp1 0.28 G, the three dilated convs 0.94 G
// (all 9 taps count at S = 23: dilation 18 < 23), the branches 0.14 G, the
// final 1x1 0.17 G -- on about 3.2 M weights (6.4 MB in bf16) and a 2.2 MB
// bf16 input.  On an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) the bound
// at batch 1 in bf16 is about 3.1 us of compute against 2.6 us of memory,
// and at batch 32 about 99 us, compute-bound.  At batch 1 what bounds it in
// practice is latency: the cascade is a chain of six dependent products,
// each a few K steps deep, plus the launches between them.
//
// Design.  The TPU kernel runs one grid step per image with every
// intermediate in VMEM.  On Hopper one block per image would leave 131 of
// 132 SMs idle at batch 1, and the four (S*S, 256) intermediates do not fit
// in a block's 227 KB of shared memory.  So the cascade is a chain of
// launches on the caller's stream, each spread over (B*S*S row tiles x
// output-channel tiles [x K slices]): a GAP partial-sum pass, the GAP
// branch, then six tiled products through one GEMM template whose
// A-operand loader is the only part that differs:
//   DENSE    rows of a row-major matrix (aspp1, the four branches at once);
//   DILATED  the implicit GEMM of a dilated 3x3 conv: row (b, i, j), column
//            tap * 256 + c reads x[b, i + dy, j + dx, c], or 0 in the padding,
//            over the active taps only;
//   CONCAT   columns 0..1023 from the four branch products, 1024..1279 from
//            x5 of the row's image (the concat is never materialised).
// Intermediates round-trip through device memory (x1..x4 and the branch
// products, scratch allocated by the caller); at these sizes they stay in
// the 50 MB L2.  The GAP passes (~0.1% of the work) run on CUDA cores.
//
// bf16: tensor cores (wasp_mma_kernel<MODE>).  64x128 output tiles, 4 warps
// of 32x64, mma.sync.m16n8k16 bf16 -> f32; BK = 64 (a K tile never
// straddles a tap or a concat segment: 64 divides 256).  A 3-stage
// shared-memory ring filled by cp.async 16-byte copies, whose src-size-0
// form zero-fills padding rows and taps, so the MMA loop has no branch;
// operands by ldmatrix (B with .trans from the row-major (K, 256) weights,
// which need no packing), 16-byte chunks XOR-swizzled by row.  Shared
// memory 3 x (8 + 16) KB = 72 KB: three blocks of 128 threads an SM.
// mma.sync, not wgmma: the products are small (a 64-row tile of 529 rows
// at batch 1), and at batch 32 the 98 GFLOP need only ~25% of the
// tensor-core peak to meet a 0.4 ms budget; wgmma's descriptors and
// warpgroup-wide tiles are left for a later PR.
// Split-K for small batches: where a product has fewer tiles than the card
// has SMs, its K steps are cut into `slices` contiguous runs (slice i of
// n takes steps [i*steps/n, (i+1)*steps/n)), n = min(steps, ceil(SMs /
// tiles)), each block writing its f32 partial sums to a workspace; a
// reduce pass sums the slices in slice order and then adds the bias,
// applies the ReLU and rounds.  No float atomics, so two calls give the
// same bits.  The plan is a pure function of (B, S, dilations, SM count),
// computed by the Python wrapper (split_plan) and passed in.  At batch 1,
// S = 23, the products split 8, 8, 8, 8, 2, 8 ways: 136-144 blocks each.
// At batch 32 nothing splits (530 tiles).
//
// f32 keeps the CUDA-core kernel (gemm_kernel<float>): tensor cores would
// take f32 operands as TF32, which misses the 1e-4 parity bar.  Tiles are
// 64x64 (32x32 when 64x64 would give fewer blocks than SMs), BK = 32, 4x4
// outputs a thread, f32 FMA, no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include "tensor_core.cuh"

namespace {

constexpr int C_IN = 2048;   // backbone channels
constexpr int C_MID = 256;   // WASP width
constexpr int BK = 32;       // f32 K tile; divides C_MID, so a K tile never straddles a tap
constexpr int GAP_SPLIT = 16;  // spatial slices of the GAP partial sums

enum Mode { DENSE = 0, DILATED = 1, CONCAT = 2 };

template <typename T>
struct GemmArgs {
  const T* a;         // DENSE: (M, lda); DILATED: (B, S, S, C_MID); CONCAT: (4, M, C_MID)
  const T* x5;        // CONCAT: (B, C_MID), broadcast over the image's S*S rows
  const T* w;         // (rows, N) row-major
  const float* bias;  // (N,) or null
  T* out;             // (M, N)
  int M, N, K;        // DILATED: K = active taps * C_MID
  int lda;
  int S;
  int relu;
  int tap_dy[9], tap_dx[9], tap_id[9];
  float* ws;          // bf16 split-K: (slices, M, N) f32 partial sums
  int slices;         // bf16: K slices (1: no split)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements from a 16-byte-aligned address, widened to f32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// out[m, n] = act(sum_k A[m, k] * w[k, n] + bias[n]), one BM x BN tile a block.
template <typename T, int BM, int BN, int MODE>
__global__ void __launch_bounds__((BM / 4) * (BN / 4))
gemm_kernel(const GemmArgs<T> p) {
  constexpr int NT = (BM / 4) * (BN / 4);
  constexpr int A_CHUNKS = BM * BK / 8 / NT;
  constexpr int B_CHUNKS = BK * BN / 8 / NT;
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small for its threads");
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int SS = p.S * p.S;

  // Each thread loads the same A rows for every K tile: decode them once.
  int a_row[A_CHUNKS], a_kc[A_CHUNKS], a_b[A_CHUNKS], a_i[A_CHUNKS], a_j[A_CHUNKS];
#pragma unroll
  for (int q = 0; q < A_CHUNKS; ++q) {
    const int idx = tid + q * NT;
    a_row[q] = idx / (BK / 8);
    a_kc[q] = (idx % (BK / 8)) * 8;
    const int m = m0 + a_row[q];
    a_b[q] = a_i[q] = a_j[q] = 0;
    if (MODE != DENSE) {
      a_b[q] = m / SS;
      const int r = m - a_b[q] * SS;
      a_i[q] = r / p.S;
      a_j[q] = r - a_i[q] * p.S;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int ty = tid / (BN / 4), tx = tid % (BN / 4);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    int tap = 0, wrow = k0;  // wrow: first row of w this K tile reads
    if (MODE == DILATED) {
      tap = k0 / C_MID;
      wrow = p.tap_id[tap] * C_MID + (k0 - tap * C_MID);
    }
#pragma unroll
    for (int q = 0; q < A_CHUNKS; ++q) {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int m = m0 + a_row[q];
      if (m < p.M) {
        const T* src = nullptr;
        if (MODE == DENSE) {
          src = p.a + (size_t)m * p.lda + k0 + a_kc[q];
        } else if (MODE == DILATED) {
          const int ii = a_i[q] + p.tap_dy[tap], jj = a_j[q] + p.tap_dx[tap];
          if (ii >= 0 && ii < p.S && jj >= 0 && jj < p.S)
            src = p.a + (((size_t)a_b[q] * p.S + ii) * p.S + jj) * C_MID +
                  (k0 - tap * C_MID) + a_kc[q];
        } else {
          const int seg = k0 / C_MID, c = k0 - seg * C_MID + a_kc[q];
          src = seg < 4 ? p.a + ((size_t)seg * p.M + m) * C_MID + c
                        : p.x5 + (size_t)a_b[q] * C_MID + c;
        }
        if (src != nullptr) load8(src, v);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) As[a_kc[q] + e][a_row[q]] = v[e];
    }
#pragma unroll
    for (int q = 0; q < B_CHUNKS; ++q) {
      const int idx = tid + q * NT;
      const int r = idx / (BN / 8), nc = (idx % (BN / 8)) * 8;
      float v[8];
      load8(p.w + (size_t)(wrow + r) * p.N + n0 + nc, v);
      *reinterpret_cast<float4*>(&Bs[r][nc]) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&Bs[r][nc + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.bias != nullptr) {
#pragma unroll
    for (int c = 0; c < 4; ++c) bias[c] = p.bias[n + c];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= p.M) continue;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t = acc[r][c] + bias[c];
      v[c] = p.relu ? fmaxf(t, 0.f) : t;
    }
    store4(p.out + (size_t)m * p.N + n, v);
  }
}

// partial[b, s, c] = sum of x[b, pixel, c] over spatial slice s; grid
// (B, C_IN / 256, GAP_SPLIT), one channel a thread.
template <typename T>
__global__ void gap_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int SS) {
  const int b = blockIdx.x, c = blockIdx.y * 256 + threadIdx.x, slice = blockIdx.z;
  const int per = (SS + GAP_SPLIT - 1) / GAP_SPLIT;
  const int p0 = slice * per, p1 = min(SS, p0 + per);
  float s = 0.f;
  for (int pix = p0; pix < p1; ++pix) s += to_float(x[((size_t)b * SS + pix) * C_IN + c]);
  partial[((size_t)b * GAP_SPLIT + slice) * C_IN + c] = s;
}

// x5[b, n] = relu(round(mean_hw x[b]) @ wg[:, n] + bg[n]); grid (B, 256 /
// GAP_COLS), 256 threads: each of 8 warps sums a 256-deep run of the
// contraction for GAP_COLS channels, then one warp adds the 8 runs in order.
constexpr int GAP_COLS = 32;
template <typename T>
__global__ void gap_branch_kernel(const float* __restrict__ partial, const T* __restrict__ wg,
                                  const float* __restrict__ bg, T* __restrict__ x5, int SS) {
  __shared__ float g[C_IN];
  __shared__ float runs[8][GAP_COLS];
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C_IN; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < GAP_SPLIT; ++k) s += partial[((size_t)b * GAP_SPLIT + k) * C_IN + c];
    g[c] = to_float(from_float<T>(s / (float)SS));  // mean in f32, rounded to T (:150-152)
  }
  __syncthreads();
  const int col = threadIdx.x % GAP_COLS, run = threadIdx.x / GAP_COLS;
  const int n = blockIdx.y * GAP_COLS + col;
  float acc = 0.f;
  for (int k = run * (C_IN / 8); k < (run + 1) * (C_IN / 8); ++k)
    acc = fmaf(g[k], to_float(wg[(size_t)k * C_MID + n]), acc);
  runs[run][col] = acc;
  __syncthreads();
  if (run == 0) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) s += runs[r][col];
    x5[(size_t)b * C_MID + n] = from_float<T>(fmaxf(s + bg[n], 0.f));
  }
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int TBM = 64, TBN = 128, TBK = 64, STAGES = 3, TC_THREADS = 128;
constexpr int A_STAGE_BYTES = TBM * TBK * 2;
constexpr int B_STAGE_BYTES = TBK * TBN * 2;
constexpr int TC_SMEM_BYTES = STAGES * (A_STAGE_BYTES + B_STAGE_BYTES);
constexpr int PRODUCTS = 6;  // aspp1, x2, x3, x4, branches, concat

using TcArgs = GemmArgs<__nv_bfloat16>;

// out[m, n] = act(sum_k A[m, k] * w[k, n] + bias[n]) over K slice blockIdx.z,
// one 64x128 tile a block.  Shared memory per stage: A [64 rows][64 k] with
// 16-byte chunk c of row r at c ^ (r & 7); B [64 k][128 n] with chunk c of
// row k at c ^ (k & 7).
template <int MODE>
__global__ void __launch_bounds__(TC_THREADS)
wasp_mma_kernel(const TcArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's 32x64 sub-tile
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN, slice = blockIdx.z;
  const int steps = p.K / TBK;
  const int kb = slice * steps / p.slices, nk = (slice + 1) * steps / p.slices - kb;
  const int SS = p.S * p.S;
  const uint32_t a_base = smem_u32(smem_raw), b_base = a_base + STAGES * A_STAGE_BYTES;

  // A: 64 rows x 8 chunks, 4 a thread, all in chunk column tid & 7.
  const int a_c = tid & 7;
  int a_m[4], a_b[4], a_i[4], a_j[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + (tid >> 3) + 16 * q;
    a_m[q] = m;
    a_b[q] = a_i[q] = a_j[q] = 0;
    if (MODE != DENSE && m < p.M) {
      a_b[q] = m / SS;
      const int r = m - a_b[q] * SS;
      a_i[q] = r / p.S;
      a_j[q] = r - a_i[q] * p.S;
    }
  }

  auto load_stage = [&](int stage, int ks) {
    const int k0 = ks * TBK;
    int tap = 0, wrow = k0;  // wrow: first row of w this K tile reads
    if (MODE == DILATED) {
      tap = k0 / C_MID;
      wrow = p.tap_id[tap] * C_MID + (k0 - tap * C_MID);
    }
    const uint32_t sa = a_base + stage * A_STAGE_BYTES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = a_m[q], r = (tid >> 3) + 16 * q;
      const __nv_bfloat16* src = p.w;  // any valid address when nothing is read
      int bytes = 0;
      if (m < p.M) {
        if (MODE == DENSE) {
          src = p.a + (size_t)m * p.lda + k0 + a_c * 8;
          bytes = 16;
        } else if (MODE == DILATED) {
          const int ii = a_i[q] + p.tap_dy[tap], jj = a_j[q] + p.tap_dx[tap];
          if (ii >= 0 && ii < p.S && jj >= 0 && jj < p.S) {
            src = p.a + (((size_t)a_b[q] * p.S + ii) * p.S + jj) * C_MID + (k0 - tap * C_MID) + a_c * 8;
            bytes = 16;
          }
        } else {
          const int seg = k0 / C_MID, c = k0 - seg * C_MID + a_c * 8;
          src = seg < 4 ? p.a + ((size_t)seg * p.M + m) * C_MID + c : p.x5 + (size_t)a_b[q] * C_MID + c;
          bytes = 16;
        }
      }
      cp_async16(sa + r * 128 + ((a_c ^ (r & 7)) << 4), src, bytes);
    }
    const uint32_t sb = b_base + stage * B_STAGE_BYTES;
    const int b_c = tid & 15;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = (tid >> 4) + 8 * q;
      cp_async16(sb + r * 256 + ((b_c ^ (r & 7)) << 4), p.w + (size_t)(wrow + r) * C_MID + n0 + b_c * 8, 16);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kb + s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (int t = 0; t < nk; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1
    if (t + STAGES - 1 < nk) load_stage((t + STAGES - 1) % STAGES, kb + t + STAGES - 1);
    asm volatile("cp.async.commit_group;\n");
    const uint32_t sa = a_base + (t % STAGES) * A_STAGE_BYTES;
    const uint32_t sb = b_base + (t % STAGES) * B_STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + (lane & 15), c = kk * 2 + (lane >> 4);
        ldmatrix_x4(a[i], sa + r * 128 + ((c ^ (r & 7)) << 4));
      }
      const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        const int c = wn * 8 + 2 * j + (lane >> 4);
        ldmatrix_x4_trans(bf, sb + kr * 256 + ((c ^ (kr & 7)) << 4));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], a[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * hr;
      if (m >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn * 64 + nt * 8 + 2 * tig;
        float v0 = acc[i][nt][2 * hr], v1 = acc[i][nt][2 * hr + 1];
        if (p.slices > 1) {
          *reinterpret_cast<float2*>(p.ws + ((size_t)slice * p.M + m) * C_MID + n) = make_float2(v0, v1);
        } else {
          if (p.bias != nullptr) {
            v0 += p.bias[n];
            v1 += p.bias[n + 1];
          }
          if (p.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * C_MID + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// out[m, n] = round(act(sum over slices, in slice order, of ws[s, m, n] +
// bias[n])); four columns a thread.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ out, int M, int slices, int relu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // float4 index into (M, 256)
  if (idx >= M * (C_MID / 4)) return;
  const size_t plane = (size_t)M * (C_MID / 4);
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4 s = w4[idx];
  for (int k = 1; k < slices; ++k) {
    const float4 v = w4[k * plane + idx];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  float v[4] = {s.x, s.y, s.z, s.w};
  const int n = (idx % (C_MID / 4)) * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (bias != nullptr) v[c] += bias[n + c];
    if (relu) v[c] = fmaxf(v[c], 0.f);
  }
  store4(out + (size_t)idx * 4, v);
}

template <int MODE>
cudaError_t launch_tc(TcArgs g, int slices, float* ws, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(wasp_mma_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int steps = g.K / TBK;
  if (slices < 1 || slices > steps || (slices > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  g.slices = slices;
  g.ws = ws;
  wasp_mma_kernel<MODE><<<dim3((g.M + TBM - 1) / TBM, C_MID / TBN, slices), TC_THREADS, TC_SMEM_BYTES, st>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return e;
  const int n4 = g.M * (C_MID / 4);
  splitk_reduce_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(ws, g.bias, g.out, g.M, slices, g.relu);
  return cudaGetLastError();
}


int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <typename T, int MODE>
cudaError_t launch_gemm(const GemmArgs<T>& g, cudaStream_t st) {
  const int rows64 = (g.M + 63) / 64;
  if (rows64 * (g.N / 64) >= sm_count()) {
    gemm_kernel<T, 64, 64, MODE><<<dim3(rows64, g.N / 64), 256, 0, st>>>(g);
  } else {
    gemm_kernel<T, 32, 32, MODE><<<dim3((g.M + 31) / 32, g.N / 32), 64, 0, st>>>(g);
  }
  return cudaGetLastError();
}

// Taps of a dilated 3x3 conv on an S x S plane that reach a real pixel.
int active_taps(int d, int S, int* dy, int* dx, int* id) {
  int n = 0;
  for (int ky = 0; ky < 3; ++ky)
    for (int kx = 0; kx < 3; ++kx) {
      const int oy = (ky - 1) * d, ox = (kx - 1) * d;
      if (abs(oy) >= S || abs(ox) >= S) continue;
      dy[n] = oy;
      dx[n] = ox;
      id[n] = ky * 3 + kx;
      ++n;
    }
  return n;
}

// One product: f32 on the CUDA cores, bf16 on the tensor cores with its K slices.
template <int MODE>
cudaError_t launch_product(const GemmArgs<float>& g, int, float*, cudaStream_t st) {
  return launch_gemm<float, MODE>(g, st);
}
template <int MODE>
cudaError_t launch_product(const GemmArgs<__nv_bfloat16>& g, int slices, float* ws, cudaStream_t st) {
  return launch_tc<MODE>(g, slices, ws, st);
}

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

template <typename T>
int run(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
        const T* w3, const float* b3, const T* w4, const float* b4, const T* w2eff,
        const T* wg, const float* bg, const T* wc, const float* bc, T* out, T* xs, T* br,
        float* partial, T* x5, float* ws, int B, int S, const int* dil, const int* slices,
        cudaStream_t st) {
  const int SS = S * S, M = B * SS;
  const size_t plane = (size_t)M * C_MID;

  gap_partial_kernel<T><<<dim3(B, C_IN / 256, GAP_SPLIT), 256, 0, st>>>(x, partial, SS);
  RETURN_IF_ERROR(cudaGetLastError());
  gap_branch_kernel<T><<<dim3(B, C_MID / GAP_COLS), 8 * GAP_COLS, 0, st>>>(partial, wg, bg, x5, SS);
  RETURN_IF_ERROR(cudaGetLastError());

  GemmArgs<T> g = {};
  g.M = M;
  g.N = C_MID;
  g.S = S;

  // aspp1: x1 = relu(x @ w1 + b1)
  g.a = x;
  g.lda = C_IN;
  g.K = C_IN;
  g.w = w1;
  g.bias = b1;
  g.relu = 1;
  g.out = xs;
  RETURN_IF_ERROR((launch_product<DENSE>(g, slices[0], ws, st)));

  // the waterfall: x_{l+1} = relu(dil3x3(x_l) + b)
  const T* wd[3] = {w2, w3, w4};
  const float* bd[3] = {b2, b3, b4};
  for (int l = 0; l < 3; ++l) {
    const int ntaps = active_taps(dil[l], S, g.tap_dy, g.tap_dx, g.tap_id);
    g.a = xs + l * plane;
    g.K = ntaps * C_MID;
    g.w = wd[l];
    g.bias = bd[l];
    g.out = xs + (l + 1) * plane;
    RETURN_IF_ERROR((launch_product<DILATED>(g, slices[1 + l], ws, st)));
  }

  // the four branches through w2eff in one product over (4 * M) rows
  g.a = xs;
  g.lda = C_MID;
  g.M = 4 * M;
  g.K = C_MID;
  g.w = w2eff;
  g.bias = nullptr;
  g.relu = 0;
  g.out = br;
  RETURN_IF_ERROR((launch_product<DENSE>(g, slices[4], ws, st)));

  // y = relu([br_1..br_4, x5] @ wc + bc)
  g.a = br;
  g.x5 = x5;
  g.M = M;
  g.K = 5 * C_MID;
  g.w = wc;
  g.bias = bc;
  g.relu = 1;
  g.out = out;
  RETURN_IF_ERROR((launch_product<CONCAT>(g, slices[5], ws, st)));
  return 0;
}

}  // namespace

extern "C" {

// Scratch, allocated by the caller: xs and br (4, B*S*S, 256) of the input
// dtype, partial (B, 16, 2048) f32, x5 (B, 256) of the input dtype; for
// bf16, ws (max over the products of slices * rows * 256) f32, or null when
// nothing splits.  s0..s5: the K slices of aspp1, the three dilated convs,
// the branches and the concat (ops/kernels/wasp_cascade.py::split_plan); 1
// each for f32.
// dtype: 0 = f32, 1 = bf16.  Returns 0 or the first cudaError_t raised.
int wasp_cascade_forward(int dtype, const void* x, const void* w1, const float* b1,
                         const void* w2, const float* b2, const void* w3, const float* b3,
                         const void* w4, const float* b4, const void* w2eff, const void* wg,
                         const float* bg, const void* wc, const float* bc, void* out,
                         void* xs, void* br, float* partial, void* x5, float* ws, int B, int S,
                         int d0, int d1, int d2, int s0, int s1, int s2, int s3, int s4, int s5,
                         void* stream) {
  if (B <= 0 || S <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0) return (int)cudaErrorInvalidValue;
  const int dil[3] = {d0, d1, d2};
  const int slices[PRODUCTS] = {s0, s1, s2, s3, s4, s5};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    return run<T>((const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)w3, b3,
                  (const T*)w4, b4, (const T*)w2eff, (const T*)wg, bg, (const T*)wc, bc,
                  (T*)out, (T*)xs, (T*)br, partial, (T*)x5, ws, B, S, dil, slices, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return run<T>((const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)w3, b3,
                  (const T*)w4, b4, (const T*)w2eff, (const T*)wg, bg, (const T*)wc, bc,
                  (T*)out, (T*)xs, (T*)br, partial, (T*)x5, ws, B, S, dil, slices, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of the bf16 tensor-core GEMM that fit one SM at once, or -1.
int wasp_mma_blocks_per_sm() {
  int n = -1;
  cudaError_t e = cudaFuncSetAttribute(wasp_mma_kernel<DILATED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wasp_mma_kernel<DILATED>, TC_THREADS,
                                                      TC_SMEM_BYTES);
  return e == cudaSuccess ? n : -1;
}

const char* wasp_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
