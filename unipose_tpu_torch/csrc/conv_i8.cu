// s8 x s8 -> s32 convolution on Hopper's int8 tensor cores, with the int8
// front end's epilogue fused behind it.
//
// Replaces unipose_tpu/ops/quant.py:116 (`conv_i8`), which is not a Pallas
// kernel but an XLA conv with preferred_element_type=int32 on the TPU's
// matrix unit, and the f32 epilogue that XLA fuses into that conv's
// consumers (quant.py:291-303: scale, bias, residual, ReLU, requantisation).
// No PyTorch call computes it on CUDA: F.conv2d takes no int8 on the card,
// and torch._int_mm covers only the 1x1 convs.  The conv is, exactly,
//
//   acc[b, oy, ox, n] = sum over (ky, kx, c) of
//       x[b, oy*s - p + ky*d, ox*s - p + kx*d, c] * w[n, (ky*kw + kx)*Cin + c]
//
// with x (B, H, W, Cin) int8 NHWC, pixels outside the image read as 0.  The
// weights are packed once on the host (ops/kernels/conv_i8.py::pack_weight)
// as (N, Kp) int8, K = kh*kw*Cin tap-major, zero-padded to Kp, a multiple of
// 32.  Every product is at most 2^14 in size and K <= 2304 in the front end,
// so the int32 sum never overflows and is exact in any order.
//
// One main loop, three epilogues (MODE), all on (M, N) = (B*Ho*Wo, Cout)
// NHWC outputs:
//   ACC_I32     the int32 accumulator (unipose::conv_i8, the JAX function);
//   AFFINE_F32  f32 acc*scale[n] + bias[n] (the downsample's residual);
//   CODES_I8    int8 codes of requant(relu(acc*scale[n] + bias[n] + r)), r
//               none, an f32 tensor, or int8 codes times residual_scale; and,
//               when asked, the codes dequantised (q*out_scale) as f32 or
//               bf16 (a stage's output).
// scale[n] is w_scale[n]*s_in, computed once on the host by the torch op
// the plain version uses.  The epilogue gives the plain version's numbers
// operation for operation, or codes would flip at rounding ties: acc to f32
// rounded to nearest (__int2float_rn, or exactly the same on the FP32 pipe
// when K <= 256), then __fmul_rn and __fadd_rn (nvcc would contract a*b + c
// into one FMA, which rounds once where PyTorch rounds twice), the residual
// before the ReLU, the code of the true quotient v / out_scale (not of a
// multiply by the reciprocal: code_fast, div_rn), rounded half to even and
// clamped to +-127.
//
// Main loop: implicit GEMM, M = B*Ho*Wo, N = Cout, K = kh*kw*Cin.  A block
// computes a BM x 64 tile with (BM/32) x 2 warps of 32 x 32, each on
// mma.sync m16n8k32 s8 (2 x 4 tiles a k-step), operands by ldmatrix from
// shared memory.  K advances 64 bytes a stage through a cp.async ring (4
// stages on the 16-byte path, 3 on the byte path), 16-byte copies: the A
// tile is the im2col rows, gathered tap by tap and never written to device
// memory (the zero-fill form of cp.async gives the padding, out-of-image
// taps and the K tail), the B tile the packed weight rows.  Both operands
// are K-contiguous, the layout mma.sync's row.col takes.  16-byte chunks
// are XOR-swizzled by row so that ldmatrix reads eight rows without bank
// conflicts.  What does not change from stage to stage (row offsets, tile
// addresses) is computed once; a chunk's tap advances by BK bytes a stage.
// Blocks run column tiles fastest, so the blocks that share an A tile run
// together.
//
// Cin not a multiple of 16 (conv1's 3 channels, K = 147): a 16-byte chunk
// spans taps, so such convs gather A byte by byte (into the same layout;
// only B comes by cp.async).  Undilated, with kw*Cin >= 16, the block's
// input rows are first staged in shared memory with their padding as
// zeros, and the gather copies runs of kw*Cin contiguous bytes with no
// bounds checks; otherwise it reads device memory with them.
//
// Epilogue: through the ring's shared memory, 16 rows of a warp's tile at a
// time, so that device memory sees 16-byte accesses along rows; the
// residual of both passes is asked for by cp.async at once, the scale and
// bias while the ring fills.  The conversions that run on the slow
// conversion pipe (I2F, F2I, FRND, F2F) are done on the FP32 pipe where
// that is exact.
//
// Tile: BM = 128 or 64, whichever runs the grid in fewer rows of waves
// (dispatch_vec), with the register budget of 3 and 4 blocks an SM.  No
// split-K.
//
// What bounds it.  The fused front end at 368x368 moves ~80 MB an image
// (its 24 launches' inputs, weights, residuals, codes and dequantised
// outputs, each once) against 9.8 G operations: bytes bound it, ~0.024 ms
// an image at 3.35 TB/s.  A launch runs at 3-64% of its own bound, the
// front end's 24 at 14% (batch 1) and 27% (batch 8) of theirs (PERF.md
// §6): the epilogue is not overlapped with the next tile's loads, and
// mma.sync runs at 1-13% of the dense int8 rate.  A persistent,
// warp-specialised redesign (wgmma, TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int BN = 64;           // output channels a block
constexpr int BK = 64;           // K bytes a stage: two m16n8k32 steps
constexpr int CHUNKS = BK / 16;  // 16-byte chunks a tile row
constexpr int KP_ALIGN = 32;     // pack_weight pads K to a multiple of this
// A warp's epilogue staging: 16 rows of FS words and of CS bytes.
constexpr int FS = 40, CS = 48, EPI_BYTES = 16 * FS * 4 + 16 * CS;
// The cp.async ring's stages: 48 KB at BM = 128 and 32 KB at 64 on the
// 16-byte path; 3 on the byte path (conv1's K is 3 stages), beside its
// staged input rows.
constexpr int STAGES_VEC = 4, STAGES_BYTE = 3;
constexpr int ring_bytes(int bm, bool vec) { return (vec ? STAGES_VEC : STAGES_BYTE) * (bm + BN) * BK; }
constexpr int PATCH_BYTES = 11 * 1024;  // the byte path's staged input rows

enum Mode { ACC_I32 = 0, AFFINE_F32 = 1, CODES_I8 = 2 };
enum Residual { RES_NONE = 0, RES_F32 = 1, RES_I8 = 2 };
enum Deq { DEQ_NONE = 0, DEQ_F32 = 1, DEQ_BF16 = 2 };

struct Conv {
  const int8_t* x;
  const int8_t* w;
  long long M;
  int H, W, Cin, Ho, Wo, N, kh, kw, stride, pad, dil, K, Kp;
};

struct Epilogue {
  const float* scale;    // (N,) w_scale * s_in
  const float* bias;     // (N,)
  const void* residual;  // (M, N) f32, or int8 codes, or null
  void* out;             // (M, N) int32 / f32 / int8
  void* deq;             // (M, N) f32 / bf16, or null
  float out_scale, residual_scale;
  int residual_kind, deq_kind;
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of BK-byte rows.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// The epilogue's staging: a warp's 16 x 32 sub-tile, rows [m, m + 16) and
// columns [n, n + 32) of an (M, N) row-major array, moved between device
// memory and shared memory (row stride ss elements, 16-byte aligned).  With
// v16 (N a multiple of 16: every row 16-byte aligned, a chunk all in or all
// out of the array) as 16-byte accesses, 16 / sizeof(T) elements a lane
// (loads by cp.async: the caller commits and waits), else as one element a
// lane; clipped to M x N.
template <typename T>
__device__ __forceinline__ void stage_in(T* s, int ss, const T* gm, long long m, int n, long long M,
                                         int N, bool v16, int lane) {
  constexpr int E = 16 / sizeof(T), CPR = 32 / E;  // elements a chunk, chunks a row
  if (v16) {
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR, c = (i % CPR) * E;
      const bool ok = m + r < M && n + c < N;
      cp_async16(smem_u32(s + r * ss + c), ok ? gm + (m + r) * N + n + c : gm, ok ? 16 : 0);
    }
  } else {
    for (int i = lane; i < 16 * 32; i += 32) {
      const int r = i >> 5, c = i & 31;
      if (m + r < M && n + c < N) s[r * ss + c] = __ldg(gm + (m + r) * N + n + c);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_out(const T* s, int ss, T* gm, long long m, int n, long long M,
                                          int N, bool v16, int lane) {
  constexpr int E = 16 / sizeof(T), CPR = 32 / E;
  if (v16) {
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR, c = (i % CPR) * E;
      if (m + r < M && n + c < N)
        *reinterpret_cast<uint4*>(gm + (m + r) * N + n + c) =
            *reinterpret_cast<const uint4*>(s + r * ss + c);
    }
  } else {
    for (int i = lane; i < 16 * 32; i += 32) {
      const int r = i >> 5, c = i & 31;
      if (m + r < M && n + c < N) gm[(m + r) * N + n + c] = s[r * ss + c];
    }
  }
}

// a / b rounded to nearest, as a true division (__fdiv_rn) rounds it, for
// a > 0, b > 0; rcp = 1 / b rounded to nearest, computed once.  Markstein's
// step (q0 = a*rcp, then q0 + rem*rcp with the remainder rem = a - q0*b
// exact by FMA) lands within an ulp of a / b; the exact remainders of that
// quotient and of its neighbour on the remainder's side then pick the float
// nearest a / b.  (A quotient of two floats is never a midpoint, so there
// is no tie to break.)  Outside 2^-100 <= a, a*rcp < 2^100, where every
// remainder is exact, the quotient goes to __fdiv_rn, whose own sequence
// checks each quotient for its slow path.
__device__ __forceinline__ float div_rn(float a, float b, float rcp) {
  float q = __fmul_rn(a, rcp);
  if (!(a >= 7.88860905e-31f && q < 1.26765060e30f)) return __fdiv_rn(a, b);
  q = __fmaf_rn(__fmaf_rn(-q, b, a), rcp, q);
  const float rem = __fmaf_rn(-q, b, a);
  const float next = __int_as_float(__float_as_int(q) + (rem > 0.f ? 1 : -1));
  return fabsf(__fmaf_rn(-next, b, a)) < fabsf(rem) ? next : q;
}

// Exact conversions on the FP32 pipe, which the conversion instructions
// (I2F, F2I, FRND, F2F) run at an eighth of the rate of: an integer i with
// |i| < 2^22 added to 1.5 * 2^23 is that float's mantissa, so
// float(i) = (1.5 * 2^23 + i) - 1.5 * 2^23, and round_half_even(x) for
// |x| < 2^22 is the mantissa of x + 1.5 * 2^23.
__device__ __forceinline__ float small_int_to_float(int i) {
  return __fsub_rn(__int_as_float(0x4B400000 + i), 12582912.f);
}

__device__ __forceinline__ int round_small(float x) {
  return __float_as_int(__fadd_rn(x, 12582912.f)) - 0x4B400000;
}

// bf16 of a finite x, rounded to nearest even (as __float2bfloat16_rn).
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return __ushort_as_bfloat16((unsigned short)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16));
}

// The int8 code of relu(v) at scale s, clamp(round_half_even(relu(v) / s),
// -127, 127) with the true quotient, from q = v * rcp: q lies within 2 ulps
// of the quotient (2 ulps of a quotient under 128 are at most 2^-16), so
// where no half-integer is within 2^-15 of q both round to the same code.
// `near` marks the others, whose codes the caller takes again from the
// exact quotient (div_rn).
//
// The ReLU and the clamp act on q: q <= 0 gives 0, and from q >= 127 the
// quotient is at least 127 - 2^-16, whose code is 127 whichever way it rounds.
__device__ __forceinline__ int code_fast(float v, float rcp, bool& near) {
  const float q = fminf(fmaxf(__fmul_rn(v, rcp), 0.f), 127.f);
  const float t = __fadd_rn(q, 12582912.f);  // q rounded half to even, in the mantissa
  near = fabsf(__fsub_rn(q, __fsub_rn(t, 12582912.f))) > 0.5f - 0x1p-15f;
  return __float_as_int(t) - 0x4B400000;
}

// VEC: Cin % 16 == 0, so a 16-byte chunk of an im2col row lies in one tap.
// Register budget: 3 blocks an SM at BM = 128 (85 registers a thread), 4 at 64.
template <int BM, bool VEC, int MODE>
__global__ void __launch_bounds__(2 * BM, BM == 128 ? 3 : 4)
conv_i8_kernel(const Conv p, const Epilogue e) {
  constexpr int THREADS = 2 * BM, STAGE = (BM + BN) * BK, STAGES = VEC ? STAGES_VEC : STAGES_BYTE;
  constexpr int RPP = THREADS / CHUNKS;  // tile rows a loader pass covers: BM / 2
  extern __shared__ __align__(128) int8_t smem[];  // the ring: STAGES * STAGE bytes
  __shared__ __align__(16) int8_t patch[VEC ? 16 : PATCH_BYTES];
  static_assert(THREADS / 32 * EPI_BYTES <= STAGES * STAGE, "the epilogue's staging fits the ring");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Column tiles vary fastest, so the blocks that read one A tile run
  // together and A comes from device memory once, not once a column tile.
  const int ntiles = (p.N + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / ntiles) * BM;
  const int n0 = (blockIdx.x % ntiles) * BN;

  // Byte path, undilated: the input rows the block's output pixels read,
  // staged once in shared memory with the padding as zeros (rows outside the
  // image, pad columns on both sides), when they fit (conv1: 9 rows of
  // 1136 bytes).  An im2col row's kw*Cin bytes for one ky are then one
  // contiguous run there, which the gather copies with no bounds checks and
  // no tap arithmetic.  A row's data starts PL bytes in (PL >= pad*Cin, a
  // multiple of 16), so that rows whose bytes are 16-byte aligned in device
  // memory arrive by cp.async.
  bool use_patch = false;
  int patch_lo = 0, patch_row = 0, patch_pl = 0;  // first input row; bytes a row; data offset
  if (!VEC) {
    const long long hw = (long long)p.Ho * p.Wo, m_last = min(m0 + BM, p.M) - 1;
    const long long b = m0 / hw;
    const int row_bytes = p.W * p.Cin;
    patch_pl = (p.pad * p.Cin + 15) & ~15;
    patch_row = (patch_pl + row_bytes + p.pad * p.Cin + 15) & ~15;
    if (p.dil == 1 && b == m_last / hw) {
      const int oy0 = (int)((m0 % hw) / p.Wo), oy1 = (int)((m_last % hw) / p.Wo);
      const int rows = (oy1 - oy0) * p.stride + p.kh;
      patch_lo = oy0 * p.stride - p.pad;
      use_patch = (long long)rows * patch_row <= PATCH_BYTES && p.kw * p.Cin >= 16;
      if (use_patch) {
        for (int i = tid; i < rows * patch_row / 16; i += THREADS)
          reinterpret_cast<uint4*>(patch)[i] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();
        const int8_t* xb = p.x + b * p.H * row_bytes;
        const bool aligned = (reinterpret_cast<uintptr_t>(p.x) & 15) == 0 && (row_bytes & 15) == 0;
        for (int r = 0; r < rows; ++r) {
          const int iy = patch_lo + r;
          if (iy < 0 || iy >= p.H) continue;
          const int8_t* src = xb + (long long)iy * row_bytes;
          int8_t* dst = patch + r * patch_row + patch_pl;
          if (aligned) {
            for (int i = tid; i < row_bytes / 16; i += THREADS) cp_async16(smem_u32(dst + 16 * i), src + 16 * i);
          } else {
            for (int i = tid; i < row_bytes; i += THREADS) dst[i] = __ldg(src + i);
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
    }
    __syncthreads();
  }

  // Loader roles.  B, and A on the VEC path: chunk lc of rows lr + i*RPP.  A
  // on the byte path: row tid % BM, chunks 2 (tid / BM) + {0, 1}, so that a
  // warp's lanes gather neighbouring output pixels.  Everything that does
  // not change from stage to stage is computed here: the rows' offsets in x
  // and in the tiles, the weight rows; the VEC path's tap (ky, kx, c) of
  // its chunk advances by BK bytes a stage.
  const int lr = tid / CHUNKS, lc = tid % CHUNKS;
  constexpr int AROWS = VEC ? 2 : 1;
  long long a_base[AROWS], a_org[AROWS];  // x's offsets of the row's image and first tap
  int a_iy0[AROWS], a_ix0[AROWS];
  bool a_ok[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i) {
    const long long m = m0 + (VEC ? lr + i * RPP : tid % BM);
    a_ok[i] = m < p.M;
    const long long mm = a_ok[i] ? m : 0;
    const int ox = (int)(mm % p.Wo);
    const long long t = mm / p.Wo;
    const int oy = (int)(t % p.Ho);
    a_base[i] = (t / p.Ho) * p.H * p.W * p.Cin;
    a_iy0[i] = oy * p.stride - p.pad;
    a_ix0[i] = ox * p.stride - p.pad;
    a_org[i] = a_base[i] + ((long long)a_iy0[i] * p.W + a_ix0[i]) * p.Cin;
  }
  int k_next = lc * 16, c_next = k_next, ky_next = 0, kx_next = 0;  // the VEC chunk's next tap
  if (VEC)
    while (c_next >= p.Cin) {
      c_next -= p.Cin;
      if (++kx_next == p.kw) kx_next = 0, ++ky_next;
    }
  constexpr int BROWS = BN / RPP;
  const int8_t* w_row[BROWS];
  uint32_t b_dst[BROWS];
#pragma unroll
  for (int j = 0; j < BROWS; ++j) {
    const int n = n0 + lr + j * RPP;
    w_row[j] = n < p.N ? p.w + (long long)n * p.Kp : nullptr;
    b_dst[j] = BM * BK + swz(lr + j * RPP, lc);
  }
  const uint32_t ring = smem_u32(smem);

  auto load_stage = [&](int slot, int kt) {
    int8_t* As = smem + slot * STAGE;
    const uint32_t stage = ring + slot * STAGE;
    if (VEC) {
      const int k = k_next;
      const int tap_off = (ky_next * p.dil * p.W + kx_next * p.dil) * p.Cin + c_next;
#pragma unroll
      for (int i = 0; i < AROWS; ++i) {
        const int iy = a_iy0[i] + ky_next * p.dil, ix = a_ix0[i] + kx_next * p.dil;
        const bool ok = a_ok[i] && k < p.K && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        const int8_t* src = ok ? p.x + a_org[i] + tap_off : p.x;
        cp_async16(stage + swz(lr + i * RPP, lc), src, ok ? 16 : 0);
      }
      k_next += BK;
      c_next += BK;
      while (c_next >= p.Cin) {
        c_next -= p.Cin;
        if (++kx_next == p.kw) kx_next = 0, ++ky_next;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int chunk = 2 * (tid / BM) + j, k = kt * BK + chunk * 16;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (a_ok[0] && k < p.K && use_patch) {
          // Run ky of the row starts at its pixel's first tap in patch row
          // (iy0 - patch_lo) + ky.  A run is at least 16 bytes, so the chunk
          // crosses at most one run's end: its bytes from `split` on are the
          // next run's, patch_row - run bytes further.  No branch a byte.
          const int run = p.kw * p.Cin, ky = k / run, off = k - ky * run, split = run - off;
          const int8_t* src =
              patch + (a_iy0[0] - patch_lo + ky) * patch_row + patch_pl + a_ix0[0] * p.Cin + off;
          const int jump = patch_row - run;
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const uint32_t v = (uint8_t)src[b + (b >= split ? jump : 0)];
            word[b >> 2] |= (k + b < p.K ? v : 0u) << (8 * (b & 3));
          }
        } else if (a_ok[0] && k < p.K) {
          int tap = k / p.Cin, c = k - tap * p.Cin;
          int ky = tap / p.kw, kx = tap - ky * p.kw;
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (k + b < p.K) {
              const int iy = a_iy0[0] + ky * p.dil, ix = a_ix0[0] + kx * p.dil;
              if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
                const uint32_t v =
                    (uint8_t)__ldg(p.x + a_base[0] + ((long long)iy * p.W + ix) * p.Cin + c);
                word[b >> 2] |= v << (8 * (b & 3));
              }
              if (++c == p.Cin) {
                c = 0;
                if (++kx == p.kw) {
                  kx = 0;
                  ++ky;
                }
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(As + swz(tid % BM, chunk)) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    const int k = kt * BK + lc * 16;
#pragma unroll
    for (int j = 0; j < BROWS; ++j) {
      const bool ok = w_row[j] != nullptr && k < p.Kp;
      cp_async16(stage + b_dst[j], ok ? w_row[j] + k : p.w, ok ? 16 : 0);
    }
  };

  const int ktiles = (p.Kp + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  // The block's columns' scale and bias, read once while the ring fills, so
  // that the epilogue does not wait for them.
  __shared__ float sc_bs[2][BN];
  if (MODE != ACC_I32 && tid < 2 * BN) {
    const int n = n0 + (tid & (BN - 1));
    sc_bs[tid / BN][tid & (BN - 1)] = n < p.N ? __ldg((tid < BN ? e.scale : e.bias) + n) : 0.f;
  }

  // Compute role: warp (wm, wn) owns rows wm*32.., columns wn*32.. of the
  // tile; its ldmatrix addresses within a stage, per k-step.
  const int wm = warp >> 1, wn = warp & 1;
  uint32_t a_ld[2][2], b_ld[2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a_ld[ks][i] = swz(wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, ks * 2 + (lane >> 4));
      b_ld[ks][i] = BM * BK + swz(wn * 32 + i * 16 + (lane & 7) + (lane >> 4) * 8, ks * 2 + ((lane >> 3) & 1));
    }
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    cp_async_commit();

    const uint32_t stage = ring + (kt % STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(a[mi], stage + a_ld[ks][mi]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, stage + b_ld[ks][nj]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: its memory is the epilogue's

  // Epilogue, 16 rows of the warp's 32 x 32 tile at a time (mi), through the
  // warp's own shared memory, so that device memory sees 16-byte accesses
  // along rows: F, 16 x FS words (the f32 residual in; int32, f32 or the
  // dequantised values out), and Cb, 16 x CS bytes (int8 residual in, codes
  // out).  The accumulator (mi, ni) holds rows g and g + 8 of the pass,
  // columns 8 ni + 2t and + 1 of the warp's 32.
  float* F = reinterpret_cast<float*>(smem + warp * EPI_BYTES);
  int8_t* Cb = reinterpret_cast<int8_t*>(F + 16 * FS);
  const int g = lane >> 2, t = lane & 3;
  const int wcol = n0 + wn * 32;    // the warp's first column
  const bool v16 = p.N % 16 == 0;   // rows 16-byte aligned; a chunk all in or all out
  const float rcp = MODE == CODES_I8 ? __frcp_rn(e.out_scale) : 0.f;
  float sc[4][2], bs[4][2];  // the thread's 8 columns' scale and bias
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 32 + 8 * ni + 2 * t + j;
      sc[ni][j] = MODE != ACC_I32 ? sc_bs[0][c] : 0.f;
      bs[ni][j] = MODE != ACC_I32 ? sc_bs[1][c] : 0.f;
    }
  // The residual of both passes is asked for at once: pass 0's into F / Cb,
  // pass 1's into R1, beyond the warps' staging, where the ring has room for
  // it (else after pass 0, into F / Cb).
  constexpr int R1_BYTES = 16 * FS * 4;
  constexpr bool TWO = THREADS / 32 * (EPI_BYTES + R1_BYTES) <= STAGES * STAGE;
  int8_t* R1 = smem + THREADS / 32 * EPI_BYTES + warp * R1_BYTES;
  const bool res = MODE == CODES_I8 && e.residual_kind != RES_NONE;
  auto fetch = [&](int mi, void* f32_dst, void* i8_dst) {
    const long long mrow = m0 + wm * 32 + mi * 16;
    if (e.residual_kind == RES_F32)
      stage_in(static_cast<float*>(f32_dst), FS, static_cast<const float*>(e.residual), mrow, wcol, p.M, p.N,
               v16, lane);
    else
      stage_in(static_cast<int8_t*>(i8_dst), CS, static_cast<const int8_t*>(e.residual), mrow, wcol, p.M,
               p.N, v16, lane);
  };
  if (res) {
    fetch(0, F, Cb);
    if (TWO) fetch(1, R1, R1);
    cp_async_commit();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const long long mrow = m0 + wm * 32 + mi * 16;
    if (res) {
      if (mi == 1 && !TWO) {
        fetch(1, F, Cb);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncwarp();
    }
    const float* Fr = mi == 1 && TWO ? reinterpret_cast<const float*>(R1) : F;  // the pass's residual
    const int8_t* Cr = mi == 1 && TWO ? R1 : Cb;
    float v[2][4][2];
    int q[2][4][2];
    bool near[2][4][2], any_near = false;
    // acc -> f32: exactly as __int2float_rn, on the FP32 pipe when every
    // |acc| <= 2^22 (K <= 256 even with -128 codes), else by I2F.
    auto affine = [&](auto small) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int a = acc[mi][ni][2 * h + j];
            const float af = decltype(small)::value ? small_int_to_float(a) : __int2float_rn(a);
            v[h][ni][j] = __fadd_rn(__fmul_rn(af, sc[ni][j]), bs[ni][j]);
          }
    };
    if (p.K <= 256)
      affine(std::true_type{});
    else
      affine(std::false_type{});
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (MODE != CODES_I8) continue;
          const int at = (g + 8 * h) * FS + 8 * ni + 2 * t + j;
          if (e.residual_kind == RES_F32)
            v[h][ni][j] = __fadd_rn(v[h][ni][j], Fr[at]);
          else if (e.residual_kind == RES_I8)
            v[h][ni][j] = __fadd_rn(
                v[h][ni][j],
                __fmul_rn(small_int_to_float(Cr[(g + 8 * h) * CS + 8 * ni + 2 * t + j]), e.residual_scale));
          q[h][ni][j] = code_fast(v[h][ni][j], rcp, near[h][ni][j]);  // ReLU and requantisation
          any_near |= near[h][ni][j];
        }
    // Near a half-integer (about one element in 16,000), the exact quotient:
    // a branch the whole warp takes, off the common path.
    if (MODE == CODES_I8 && __any_sync(0xffffffffu, any_near)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (near[h][ni][j])
              q[h][ni][j] = min(__float2int_rn(div_rn(v[h][ni][j], e.out_scale, rcp)), 127);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = g + 8 * h, c = 8 * ni + 2 * t + j;
          if (MODE == ACC_I32) {
            reinterpret_cast<int32_t*>(F)[r * FS + c] = acc[mi][ni][2 * h + j];
          } else if (MODE == AFFINE_F32) {
            F[r * FS + c] = v[h][ni][j];
          } else {
            Cb[r * CS + c] = (int8_t)q[h][ni][j];
            const float d = __fmul_rn(small_int_to_float(q[h][ni][j]), e.out_scale);
            if (e.deq_kind == DEQ_F32) F[r * FS + c] = d;
            if (e.deq_kind == DEQ_BF16) reinterpret_cast<__nv_bfloat16*>(F)[r * 2 * FS + c] = to_bf16(d);
          }
        }
    __syncwarp();
    if (MODE == ACC_I32) {
      stage_out(reinterpret_cast<int32_t*>(F), FS, static_cast<int32_t*>(e.out), mrow, wcol, p.M, p.N, v16, lane);
    } else if (MODE == AFFINE_F32) {
      stage_out(F, FS, static_cast<float*>(e.out), mrow, wcol, p.M, p.N, v16, lane);
    } else {
      stage_out(Cb, CS, static_cast<int8_t*>(e.out), mrow, wcol, p.M, p.N, v16, lane);
      if (e.deq_kind == DEQ_F32)
        stage_out(F, FS, static_cast<float*>(e.deq), mrow, wcol, p.M, p.N, v16, lane);
      else if (e.deq_kind == DEQ_BF16)
        stage_out(reinterpret_cast<__nv_bfloat16*>(F), 2 * FS, static_cast<__nv_bfloat16*>(e.deq), mrow,
                  wcol, p.M, p.N, v16, lane);
    }
    __syncwarp();  // the next pass reuses F and Cb
  }
}

// The ring's dynamic shared memory, and the carveout that gives shared memory its
// largest share of the SM (the default may keep more L1 and fit fewer
// blocks).  Set once a device.
template <int BM, bool VEC, int MODE>
cudaError_t prepare(int dev) {
  static bool done[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(conv_i8_kernel<BM, VEC, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ring_bytes(BM, VEC));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_i8_kernel<BM, VEC, MODE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  done[dev] = e == cudaSuccess;
  return e;
}

// Blocks that fit one SM at once (CUDA's occupancy calculator, remembered
// a device), or -1.
template <int BM, bool VEC, int MODE>
int blocks_per_sm(int dev) {
  static int known[64];
  if (dev < 0 || dev >= 64) return -1;
  int& n = known[dev];
  if (n > 0) return n;
  cudaError_t err = prepare<BM, VEC, MODE>(dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_i8_kernel<BM, VEC, MODE>, 2 * BM,
                                                        ring_bytes(BM, VEC));
  return err == cudaSuccess ? n : -1;
}

template <int BM, bool VEC, int MODE>
int launch(const Conv& p, const Epilogue& e, cudaStream_t st, int dev) {
  const long long blocks = (p.M + BM - 1) / BM * ((p.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t set = prepare<BM, VEC, MODE>(dev);
  if (set != cudaSuccess) return (int)set;
  conv_i8_kernel<BM, VEC, MODE><<<(unsigned)blocks, 2 * BM, ring_bytes(BM, VEC), st>>>(p, e);
  return (int)cudaGetLastError();
}

// The tile: BM = 128 or 64, whichever runs the grid in fewer rows of waves
// (a wave: every SM full of blocks), 128 on a tie.  Rows a wave are
// BM x the blocks that fit an SM, so the smaller tile wins where the larger
// one's last wave would run nearly empty.
template <int MODE, bool VEC>
int dispatch_vec(const Conv& p, const Epilogue& e, cudaStream_t st, int dev, int sms) {
  const long long nt = (p.N + BN - 1) / BN;
  const int o128 = blocks_per_sm<128, VEC, MODE>(dev), o64 = blocks_per_sm<64, VEC, MODE>(dev);
  if (o128 < 1 || o64 < 1) return (int)cudaErrorInvalidConfiguration;
  const long long w128 = ((p.M + 127) / 128 * nt + (long long)sms * o128 - 1) / ((long long)sms * o128);
  const long long w64 = ((p.M + 63) / 64 * nt + (long long)sms * o64 - 1) / ((long long)sms * o64);
  return w128 * 128 <= w64 * 64 ? launch<128, VEC, MODE>(p, e, st, dev) : launch<64, VEC, MODE>(p, e, st, dev);
}

template <int MODE>
int dispatch(const Conv& p, const Epilogue& e, cudaStream_t st) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return p.Cin % 16 == 0 ? dispatch_vec<MODE, true>(p, e, st, dev, sms)
                         : dispatch_vec<MODE, false>(p, e, st, dev, sms);
}

int run(Conv p, int B, int kh, const Epilogue& e, int mode, void* stream) {
  p.kh = kh;
  p.K = kh * p.kw * p.Cin;
  if (B <= 0 || p.H <= 0 || p.W <= 0 || p.Cin <= 0 || p.Ho <= 0 || p.Wo <= 0 || p.N <= 0 ||
      kh <= 0 || p.kw <= 0 || p.stride <= 0 || p.dil <= 0 || p.pad < 0 || p.Kp < p.K ||
      p.Kp % KP_ALIGN)
    return (int)cudaErrorInvalidValue;
  p.M = (long long)B * p.Ho * p.Wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case ACC_I32:
      return dispatch<ACC_I32>(p, e, st);
    case AFFINE_F32:
      if (e.residual_kind != RES_NONE || e.deq_kind != DEQ_NONE) return (int)cudaErrorInvalidValue;
      return dispatch<AFFINE_F32>(p, e, st);
    case CODES_I8:
      if (!(e.out_scale > 0.f) || e.residual_kind < RES_NONE || e.residual_kind > RES_I8 ||
          e.deq_kind < DEQ_NONE || e.deq_kind > DEQ_BF16)
        return (int)cudaErrorInvalidValue;
      return dispatch<CODES_I8>(p, e, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Conv conv_of(const void* x, const void* w, int H, int W, int Cin, int Ho, int Wo, int N, int kw,
             int stride, int pad, int dil, int Kp) {
  Conv p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.H = H, p.W = W, p.Cin = Cin, p.Ho = Ho, p.Wo = Wo, p.N = N, p.kw = kw;
  p.stride = stride, p.pad = pad, p.dil = dil, p.Kp = Kp;
  return p;
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) int8, w (N, Kp) int8 packed (K = kh*kw*Cin tap-major,
// zero to Kp), out (B, Ho, Wo, N) int32; x and w 16-byte aligned.  Returns
// 0 or the first cudaError_t raised.
int conv_i8_forward(const void* x, const void* w, void* out, int B, int H, int W, int Cin,
                    int Ho, int Wo, int N, int kh, int kw, int stride, int pad, int dil, int Kp,
                    void* stream) {
  Epilogue e{};
  e.out = out;
  return run(conv_of(x, w, H, W, Cin, Ho, Wo, N, kw, stride, pad, dil, Kp), B, kh, e, ACC_I32,
             stream);
}

// The conv with its epilogue: mode 1 writes f32 acc*scale + bias to out;
// mode 2 writes the int8 codes of requant(relu(acc*scale + bias + r)) to
// out, r from `residual` (residual_kind 0 none, 1 f32, 2 int8 codes times
// residual_scale), and with deq_kind 1 / 2 also q*out_scale as f32 / bf16
// to deq.  scale and bias (N,) f32; residual, out and deq (B, Ho, Wo, N).
int conv_i8_requant_forward(const void* x, const void* w, const void* scale, const void* bias,
                            const void* residual, void* out, void* deq, int B, int H, int W,
                            int Cin, int Ho, int Wo, int N, int kh, int kw, int stride, int pad,
                            int dil, int Kp, float out_scale, float residual_scale, int mode,
                            int residual_kind, int deq_kind, void* stream) {
  if (mode == ACC_I32 || (residual_kind != RES_NONE && residual == nullptr) ||
      (deq_kind != DEQ_NONE && deq == nullptr))
    return (int)cudaErrorInvalidValue;
  Epilogue e{};
  e.scale = static_cast<const float*>(scale);
  e.bias = static_cast<const float*>(bias);
  e.residual = residual;
  e.out = out;
  e.deq = deq;
  e.out_scale = out_scale;
  e.residual_scale = residual_scale;
  e.residual_kind = residual_kind;
  e.deq_kind = deq_kind;
  return run(conv_of(x, w, H, W, Cin, Ho, Wo, N, kw, stride, pad, dil, Kp), B, kh, e, mode,
             stream);
}

// Blocks of the fused op's kernel (MODE 2) that fit one SM at once, for BM = bm and the 16-byte (vec 1) or byte (vec 0) gather, or -1.
int conv_i8_blocks_per_sm(int bm, int vec) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (bm == 128) return vec ? blocks_per_sm<128, true, CODES_I8>(dev) : blocks_per_sm<128, false, CODES_I8>(dev);
  return vec ? blocks_per_sm<64, true, CODES_I8>(dev) : blocks_per_sm<64, false, CODES_I8>(dev);
}

const char* conv_i8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
