// s8 x s8 -> s32 convolution for Hopper: the int8 front end's conv.
//
// Replaces unipose_tpu/ops/quant.py:116 (`conv_i8`), which is not a Pallas
// kernel but an XLA conv with preferred_element_type=int32 on the TPU's
// matrix unit.  No PyTorch call computes it on CUDA: F.conv2d takes no
// int8 on the card, and torch._int_mm covers only the 1x1 convs.  It
// computes, exactly,
//
//   out[b, oy, ox, n] = sum over (ky, kx, c) of
//       x[b, oy*s - p + ky*d, ox*s - p + kx*d, c] * w[n, (ky*kw + kx)*Cin + c]
//
// with x (B, H, W, Cin) int8 NHWC, pixels outside the image read as 0, and
// out (B, Ho, Wo, N) int32 NHWC: the accumulator the JAX function returns.
// The weights are packed once on the host
// (ops/kernels/conv_i8.py::pack_weight) as (N, Kp) int8, K = kh*kw*Cin
// tap-major, zero-padded to Kp, a multiple of TK, so the last K step reads
// zeros and no K needs to be a multiple of anything (conv1: Cin 3, K 147).
// Every product is at most 2^14 in size and K <= 2304 in the front end, so the
// int32 sum never overflows.
//
// Implicit GEMM: M = B*Ho*Wo output pixels, N = Cout, K as above.  One
// block of 256 threads computes a TM x TN = 64 x 64 output tile: at each
// K step it gathers the 64 x 32-byte A tile (the im2col rows, never
// written to device memory) and the 64 x 32-byte B tile into shared
// memory, then each thread takes a 4 x 4 sub-tile (rows ty + 16i, columns
// tx + 16j) with __dp4a, four s8 products and an s32 add an instruction.
// With Cin a multiple of 8 a thread's 8 A bytes lie in one tap and load as
// one 8-byte vector; conv1 (Cin 3) gathers them byte by byte.
//
// What bounds it.  The front end at 368x368 is ~4.9 G multiply-adds an
// image (9.8 G operations) against a few MB moved: operations bound it, at
// 1979 TOPS dense int8 on the tensor cores.  This first kernel runs on the
// CUDA cores (dp4a), an order of magnitude below that rate, with no
// double buffering; mma.sync m16n8k32 or wgmma s8, TMA loads and a fused
// epilogue (scale, bias, ReLU, requantisation to int8) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output pixels a block
constexpr int TN = 64;        // output channels a block
constexpr int TK = 32;        // K bytes a step (8 words of 4 s8)
constexpr int KW = TK / 4;    // words a step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int32_t* __restrict__ out, int H, int W, int Cin, int Ho, int Wo, int N,
               int kw, int stride, int pad, int dil, int K, int Kp, long long M) {
  __shared__ int As[TM][KW + 1];
  __shared__ int Bs[TN][KW + 1];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;

  // Loader role: row lr of the A and B tiles, bytes [8 lq, 8 lq + 8) of a step.
  const int lr = tid >> 2, lq = tid & 3;
  const long long m = m0 + lr;
  const bool mvalid = m < M;
  int b = 0, oy = 0, ox = 0;
  if (mvalid) {
    ox = (int)(m % Wo);
    long long t = m / Wo;
    oy = (int)(t % Ho);
    b = (int)(t / Ho);
  }
  const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
  const int8_t* xb = x + (long long)b * H * W * Cin;
  const int n = n0 + lr;
  const int8_t* wrow = w + (long long)n * Kp;

  // Compute role: rows ty + 16 i, columns tx + 16 j of the tile.
  const int ty = tid >> 4, tx = tid & 15;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kp; k0 += TK) {
    const int k = k0 + lq * 8;
    int2 av = make_int2(0, 0);
    if (mvalid && k < K) {
      if (VEC) {  // Cin % 8 == 0: the 8 bytes are channels of one tap
        const int tap = k / Cin, c = k - tap * Cin;
        const int ky = tap / kw, kx = tap - ky * kw;
        const int iy = iy0 + ky * dil, ix = ix0 + kx * dil;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          av = *reinterpret_cast<const int2*>(xb + ((long long)iy * W + ix) * Cin + c);
      } else {
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kk = k + e;
          if (kk < K) {
            const int tap = kk / Cin, c = kk - tap * Cin;
            const int ky = tap / kw, kx = tap - ky * kw;
            const int iy = iy0 + ky * dil, ix = ix0 + kx * dil;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
              const uint32_t v = (uint8_t)xb[((long long)iy * W + ix) * Cin + c];
              word[e >> 2] |= v << (8 * (e & 3));
            }
          }
        }
        av = make_int2((int)word[0], (int)word[1]);
      }
    }
    As[lr][lq * 2] = av.x;
    As[lr][lq * 2 + 1] = av.y;
    int2 bv = make_int2(0, 0);
    if (n < N) bv = *reinterpret_cast<const int2*>(wrow + k0 + lq * 8);
    Bs[lr][lq * 2] = bv.x;
    Bs[lr][lq * 2 + 1] = bv.y;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      int a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = Bs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long mm = m0 + ty + 16 * i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn < N) out[mm * N + nn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) int8, w (N, Kp) int8 packed (K = kh*kw*Cin tap-major,
// zero to Kp), out (B, Ho, Wo, N) int32; x and w 16-byte aligned.  Returns
// 0 or the first cudaError_t raised.
int conv_i8_forward(const void* x, const void* w, void* out, int B, int H, int W, int Cin,
                    int Ho, int Wo, int N, int kh, int kw, int stride, int pad, int dil, int Kp,
                    void* stream) {
  const int K = kh * kw * Cin;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho <= 0 || Wo <= 0 || N <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || dil <= 0 || pad < 0 || Kp < K || Kp % TK)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * Ho * Wo;
  const long long mtiles = (M + TM - 1) / TM;
  if (mtiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mtiles, (unsigned)((N + TN - 1) / TN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  if (Cin % 8 == 0)
    conv_i8_kernel<true><<<grid, THREADS, 0, st>>>(xp, wp, op, H, W, Cin, Ho, Wo, N, kw, stride,
                                                    pad, dil, K, Kp, M);
  else
    conv_i8_kernel<false><<<grid, THREADS, 0, st>>>(xp, wp, op, H, W, Cin, Ho, Wo, N, kw, stride,
                                                     pad, dil, K, Kp, M);
  return (int)cudaGetLastError();
}

const char* conv_i8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
