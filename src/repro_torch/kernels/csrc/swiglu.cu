// Fused SwiGLU MLP: out = (silu(x @ Wg) * (x @ Wu)) @ Wd.
//
// Replaces the TPU kernel repro/kernels/swiglu.py::_swiglu_kernel
// (pallas_call in swiglu_fused). x is [M, d], Wg and Wu are [d, F], Wd is
// [F, d], all contiguous and of one dtype, float32 or bfloat16. As in the
// Pallas body, g and u are float32 sums, h = silu(g) * u is formed in
// float32 and rounded to x's dtype before the product with Wd, that product
// is summed in float32, and the result is cast to x's dtype. The [M, F]
// hidden h never reaches device memory. The F tiles of one call run on
// different SMs and add their partial products into a float32 [M, d]
// workspace with atomics, so the order of that sum, and the last bits of
// the result, may vary from run to run; the tolerances allow that.
//
// Bound on an H100: the weights. At Qwen3-8B's widths (d = 4096,
// F = 12288) one call reads 150,994,944 weights, 302 MB in bf16, ~90 us at
// 3.35 TB/s; at M = 64 rows its 19.3 GFLOP would take 19.5 us on the bf16
// tensor cores (64 FLOP per weight byte, far below the ~295 FLOP/B ridge),
// so bytes bound it from decode (M = 4) through a 64-token prefill.
//
// bfloat16 (the serving path): swiglu_kernel_mma streams the weights and
// multiplies on the tensor cores with warp-level mma.sync (m16n8k16, bf16
// in, f32 out), which keeps pace with the loads at these row counts.
//   * Grid: (F / 96 hidden-column slices, M / 64 row tiles); at Qwen3-8B's
//     widths 128 blocks of 12 warps, one per SM, each reading its slice of
//     the weights exactly once per row tile.
//   * Every weight tile moves in 16-byte cp.async copies through a 4-stage
//     ring in shared memory (up to ~105 KB in flight per SM): first the
//     d / 64 tiles of [64 x 96] Wg and Wu columns (with x's [64 x 64]
//     slice), then the d / 128 tiles of the block's [96 x 128] Wd rows, so
//     the first Wd tiles load while g and u are still being summed.
//   * Swap-AB products: the weight tile is the 16-row A operand (16 hidden
//     or output columns x 16 of the reduced dimension, ldmatrix.trans), and
//     the rows of x (or of h) are the n = 8 side. One n-tile covers decode
//     (M <= 8) with no weight byte wasted; M = 64 is 8 n-tiles on the same
//     A fragments. Warp w sums g (w < 6) or u (w >= 6) for 16 hidden columns
//     over all of d in registers; h = silu(g) * u is formed in f32, rounded
//     to bf16 and kept in shared memory; the down product of each 128-column
//     output tile sums all 96 hidden columns in registers.
//   * Cross-block reduction: each output tile is staged in shared memory
//     and added to the workspace with vector atomicAdd(float4) (sm_90), one
//     per 4 outputs; the blocks walk the output tiles from staggered starts
//     so that they do not all add into one tile at once.
//   * A second small launch, swiglu_cast_kernel, casts the workspace to bf16
//     and zeroes it again for the next call, so no memset runs (the wrapper
//     caches one zeroed workspace per device and stream). Casting in
//     the kernel's last block instead (an atomic ticket) leaves one SM to
//     cast and re-zero all of [M, d] at the end of the call, which cost
//     more than this launch at M = 64.
//   Takes any M; d and F multiples of 8 and 16-byte aligned pointers (the
//   wrapper checks). Built with -DSWIGLU_NO_REDUCE, the workspace atomics sit
//   behind a branch that is never taken, so the products still run and
//   nothing is added: chip_smoke.py times that build to price the reduction.
// float32: swiglu_kernel_simt, the CUDA-core kernel of the first port (the
// f32 tolerances, 1e-4 and 1e-5 relative, rule out TF32 and bf16): a grid
// over (8-row tile of x, 64-column tile of F); the 8 warps split d, each
// lane owns two hidden columns and all 8 rows; partial g and u are summed
// in shared memory; each thread adds two output columns' 8 row sums into
// the output with atomicAdd after a memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 8;      // rows of x per block
constexpr int kBF = 64;       // hidden columns per block
constexpr int kWarps = 8;
constexpr int kSimtThreads = 32 * kWarps;
constexpr int kKC = 256;      // d values of x staged in shared memory at a time

__device__ __forceinline__ float load_or_zero(const float* p, long long at, bool in) {
  return in ? p[at] : 0.f;
}

__global__ void __launch_bounds__(kSimtThreads)
swiglu_kernel_simt(const float* __restrict__ x, const float* __restrict__ wg,
                   const float* __restrict__ wu, const float* __restrict__ wd,
                   float* __restrict__ out, int M, int d, int F) {
  __shared__ __align__(16) float xs[kKC * kRows];            // [k][row]
  __shared__ float red[2][kWarps][kRows][kBF];               // partial g, u
  __shared__ __align__(16) float hs[kBF * kRows];            // [f][row]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kRows;
  const int f0 = blockIdx.y * kBF;
  const int fa = f0 + 2 * lane, fb = fa + 1;
  const bool in_a = fa < F, in_b = fb < F;

  // 1. g and u for this block's 8 rows and 64 columns, d split over warps
  float g[kRows][2], u[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) g[r][0] = g[r][1] = u[r][0] = u[r][1] = 0.f;
  for (int c0 = 0; c0 < d; c0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * kRows; idx += kSimtThreads) {
      const int r = idx / kKC, kk = idx % kKC;  // consecutive threads read along a row of x
      const bool in = m0 + r < M && c0 + kk < d;
      xs[kk * kRows + r] = load_or_zero(x, (long long)(m0 + r) * d + c0 + kk, in);
    }
    __syncthreads();
    constexpr int kPerWarp = kKC / kWarps;
    const int kk_end = min(kPerWarp, d - c0 - warp * kPerWarp);
#pragma unroll 8
    for (int kk = 0; kk < kk_end; ++kk) {
      const int kl = warp * kPerWarp + kk;
      const long long row = (long long)(c0 + kl) * F;
      const float ga = load_or_zero(wg, row + fa, in_a), gb = load_or_zero(wg, row + fb, in_b);
      const float ua = load_or_zero(wu, row + fa, in_a), ub = load_or_zero(wu, row + fb, in_b);
      const float4 x0 = *reinterpret_cast<const float4*>(&xs[kl * kRows]);
      const float4 x1 = *reinterpret_cast<const float4*>(&xs[kl * kRows + 4]);
      const float xr[kRows] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        g[r][0] = fmaf(xr[r], ga, g[r][0]);
        g[r][1] = fmaf(xr[r], gb, g[r][1]);
        u[r][0] = fmaf(xr[r], ua, u[r][0]);
        u[r][1] = fmaf(xr[r], ub, u[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red[0][warp][r][2 * lane] = g[r][0];
    red[0][warp][r][2 * lane + 1] = g[r][1];
    red[1][warp][r][2 * lane] = u[r][0];
    red[1][warp][r][2 * lane + 1] = u[r][1];
  }
  __syncthreads();

  // 2. h = silu(g) * u, kept on chip
  for (int idx = tid; idx < kRows * kBF; idx += kSimtThreads) {
    const int r = idx / kBF, f = idx % kBF;
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      gs += red[0][w][r][f];
      us += red[1][w][r][f];
    }
    hs[f * kRows + r] = (gs * (1.f / (1.f + expf(-gs)))) * us;
  }
  __syncthreads();

  // 3. out[rows, :] += h @ Wd[f0 : f0 + 64, :]
  const int f_count = min(kBF, F - f0);
  for (int n = 2 * tid; n < d; n += 2 * kSimtThreads) {
    const bool in_n1 = n + 1 < d;
    float a0[kRows], a1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 8
    for (int f = 0; f < f_count; ++f) {
      const long long row = (long long)(f0 + f) * d;
      const float w0 = wd[row + n];
      const float w1 = load_or_zero(wd, row + n + 1, in_n1);
      const float4 h0 = *reinterpret_cast<const float4*>(&hs[f * kRows]);
      const float4 h1 = *reinterpret_cast<const float4*>(&hs[f * kRows + 4]);
      const float hr[kRows] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a0[r] = fmaf(hr[r], w0, a0[r]);
        a1[r] = fmaf(hr[r], w1, a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (m0 + r >= M) break;
      float* o = out + (long long)(m0 + r) * d + n;
      atomicAdd(o, a0[r]);
      if (in_n1) atomicAdd(o + 1, a1[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: cp.async ring + mma.sync
// ---------------------------------------------------------------------------

constexpr int kFB = 96;                  // hidden columns per block
constexpr int kMT = 64;                  // rows of x per block (8 n-tiles)
constexpr int kK1 = 64;                  // d rows per Wg / Wu tile
constexpr int kN3 = 128;                 // output columns per Wd tile
constexpr int kMmaWarps = 2 * kFB / 16;  // one per (gate or up, 16 hidden columns)
constexpr int kThreads = 32 * kMmaWarps;
constexpr int kStages = 4;
// shared-memory rows padded by 16 bytes, so that the 8 rows an ldmatrix
// reads fall in different banks
constexpr int kWRow = kFB + 8;           // Wg / Wu tile row, elements (208 B)
constexpr int kXRow = kK1 + 8;           // x tile row (144 B)
constexpr int kDRow = kN3 + 8;           // Wd tile row (272 B)
constexpr int kHRow = kFB + 8;           // h row (208 B)
constexpr int kGRow = kMT + 4;           // g staging row, floats
constexpr int kORow = kN3 + 4;           // output staging row, floats
constexpr int kWTile = kK1 * kWRow;      // elements
constexpr int kStageBytes1 = 2 * (2 * kWTile + kMT * kXRow);
constexpr int kStageBytes3 = 2 * kFB * kDRow;
constexpr int kStageBytes = kStageBytes1 > kStageBytes3 ? kStageBytes1 : kStageBytes3;
constexpr int kHBytes = 2 * kMT * kHRow;
constexpr int kGBytes = 4 * kFB * kGRow;
constexpr int kOBytes = 4 * kMT * kORow;
constexpr int kScratchBytes = kGBytes > kOBytes ? kGBytes : kOBytes;
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + kHBytes + kScratchBytes;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16) of the transpose of a row-major shared tile: rows k
// of the tile are A's columns. base points at (k0, m0); row in bytes.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], uint32_t base, int row_bytes,
                                             int lane) {
  const int mat = lane / 8, i = lane % 8;
  ldmatrix_x4_trans(a, base + (i + 8 * (mat >> 1)) * row_bytes + 16 * (mat & 1));
}

// B fragments of two k16 steps (k0 .. k0 + 31) for 8 n: rows n of a
// row-major shared tile hold k. b[0], b[1]: step 0; b[2], b[3]: step 1.
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], uint32_t base, int row_bytes,
                                            int lane) {
  ldmatrix_x4(b, base + (lane % 8) * row_bytes + 16 * (lane / 8));
}

__global__ void __launch_bounds__(kThreads, 1)
swiglu_kernel_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                  const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ wd,
                  float* __restrict__ ws, int M, int d, int F) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t ring = smem_addr(smem);
  const uint32_t h_s = ring + kStages * kStageBytes;  // h [kMT][kHRow] bf16
  uint8_t* const scratch = smem + kStages * kStageBytes + kHBytes;
  float* const g_stage = reinterpret_cast<float*>(scratch);  // [kFB][kGRow], phase 2
  float* const o_stage = reinterpret_cast<float*>(scratch);  // [kMT][kORow], phase 3

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * kFB;
  const int m0 = blockIdx.y * kMT;
  const int rows = min(kMT, M - m0);
  const int nt = (rows + 7) / 8;  // n-tiles of 8 rows
  const int t1 = (d + kK1 - 1) / kK1;  // Wg / Wu tiles
  const int t3 = (d + kN3 - 1) / kN3;  // Wd tiles = output tiles
  const int n_tiles = t1 + t3;
  const int start3 = blockIdx.x % t3;  // staggered first output tile

  auto load_tile = [&](int t) {
    const uint32_t st = ring + (t % kStages) * kStageBytes;
    if (t < t1) {
      const int k0 = t * kK1;
      // Wg and Wu: kK1 rows x 12 chunks each; x: 64 rows x kK1 / 8 chunks
      for (int c = tid; c < 2 * kK1 * (kFB / 8) + kMT * (kK1 / 8); c += kThreads) {
        if (c < 2 * kK1 * (kFB / 8)) {
          const int which = c / (kK1 * (kFB / 8)), cc = c % (kK1 * (kFB / 8));
          const int r = cc / (kFB / 8), ch = cc % (kFB / 8);
          const int k = k0 + r, f = f0 + 8 * ch;
          const bool in = k < d && f < F;
          const __nv_bfloat16* w = which ? wu : wg;
          cp_async16(st + 2 * (which * kWTile + r * kWRow + 8 * ch),
                     in ? w + (long long)k * F + f : w, in);
        } else {
          const int cc = c - 2 * kK1 * (kFB / 8);
          const int r = cc / (kK1 / 8), ch = cc % (kK1 / 8);
          const int m = m0 + r, k = k0 + 8 * ch;
          const bool in = r < rows && k < d;
          cp_async16(st + 2 * (2 * kWTile + r * kXRow + 8 * ch),
                     in ? x + (long long)m * d + k : x, in);
        }
      }
    } else {
      const int n0 = ((t - t1 + start3) % t3) * kN3;
      // Wd: 96 rows x 16 chunks
      for (int c = tid; c < kFB * (kN3 / 8); c += kThreads) {
        const int r = c / (kN3 / 8), ch = c % (kN3 / 8);
        const int f = f0 + r, n = n0 + 8 * ch;
        const bool in = f < F && n < d;
        cp_async16(st + 2 * (r * kDRow + 8 * ch), in ? wd + (long long)f * d + n : wd, in);
      }
    }
  };

  // g (warps 0-5) or u (warps 6-11) of hidden columns f0 + 16 (warp % 6) ..,
  // all rows: c[j] is n-tile j (rows 8 j ..)
  const int which = warp / (kFB / 16), ft = warp % (kFB / 16);
  float c[kMT / 8][4];
#pragma unroll
  for (int j = 0; j < kMT / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const uint32_t st = ring + (t % kStages) * kStageBytes;

    if (t < t1) {
      // g or u += W[k0 .., 16 columns]^T x[:, k0 ..]^T, 32 of d at a time
      const uint32_t w_tile = st + 2 * (which * kWTile + 16 * ft);
      const uint32_t x_tile = st + 2 * 2 * kWTile;
#pragma unroll
      for (int k = 0; k < kK1; k += 32) {
        uint32_t a0[4], a1[4];
        load_a_trans(a0, w_tile + k * 2 * kWRow, 2 * kWRow, lane);
        load_a_trans(a1, w_tile + (k + 16) * 2 * kWRow, 2 * kWRow, lane);
#pragma unroll
        for (int j = 0; j < kMT / 8; ++j) {
          if (j < nt) {
            uint32_t b[4];
            load_b_pair(b, x_tile + 2 * (8 * j * kXRow + k), 2 * kXRow, lane);
            mma_bf16(c[j], a0, b[0], b[1]);
            mma_bf16(c[j], a1, b[2], b[3]);
          }
        }
      }
      if (t == t1 - 1) {
        // h = silu(g) * u in f32, rounded to bf16, into h [row][f]. Fragment:
        // c[j][0..1] is hidden column g0 = 16 ft + lane / 4 at rows
        // 8 j + 2 (lane % 4) + {0, 1}; c[j][2..3] the column g0 + 8.
        const int fr = 16 * ft + lane / 4, mr = 2 * (lane % 4);
        if (which == 0) {
#pragma unroll
          for (int j = 0; j < kMT / 8; ++j) {
            *reinterpret_cast<float2*>(&g_stage[fr * kGRow + 8 * j + mr]) =
                make_float2(c[j][0], c[j][1]);
            *reinterpret_cast<float2*>(&g_stage[(fr + 8) * kGRow + 8 * j + mr]) =
                make_float2(c[j][2], c[j][3]);
          }
        }
        __syncthreads();
        if (which == 1) {
          __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
#pragma unroll
          for (int j = 0; j < kMT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = fr + 8 * (e >> 1), m = 8 * j + mr + (e & 1);
              const float gv = g_stage[f * kGRow + m];
              h[m * kHRow + f] = __float2bfloat16_rn((gv * (1.f / (1.f + expf(-gv)))) * c[j][e]);
            }
        }
        __syncthreads();
      }
    } else {
      // output tile n0 .. n0 + 127: out^T = Wd[f0 .., n0 ..]^T h^T over 96 f
      const int n0 = ((t - t1 + start3) % t3) * kN3;
      for (int unit = warp; unit < (kN3 / 16) * nt; unit += kMmaWarps) {
        const int dt = unit % (kN3 / 16), j = unit / (kN3 / 16);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k0 = 0; k0 < kFB; k0 += 32) {
          uint32_t a0[4], a1[4], b[4];
          const uint32_t d_tile = st + 2 * (k0 * kDRow + 16 * dt);
          load_a_trans(a0, d_tile, 2 * kDRow, lane);
          load_a_trans(a1, d_tile + 16 * 2 * kDRow, 2 * kDRow, lane);
          load_b_pair(b, h_s + 2 * (8 * j * kHRow + k0), 2 * kHRow, lane);
          mma_bf16(acc, a0, b[0], b[1]);
          mma_bf16(acc, a1, b[2], b[3]);
        }
        // acc[0..1]: output column 16 dt + lane / 4, rows 8 j + 2 (lane % 4) + {0, 1}
        const int n = 16 * dt + lane / 4, m = 8 * j + 2 * (lane % 4);
        o_stage[m * kORow + n] = acc[0];
        o_stage[(m + 1) * kORow + n] = acc[1];
        o_stage[m * kORow + n + 8] = acc[2];
        o_stage[(m + 1) * kORow + n + 8] = acc[3];
      }
      __syncthreads();
      // one vector atomic per 4 outputs into the f32 workspace
      for (int i = tid; i < rows * (kN3 / 4); i += kThreads) {
        const int m = i / (kN3 / 4), n = n0 + 4 * (i % (kN3 / 4));
        if (n < d) {
          const float4 v = *reinterpret_cast<const float4*>(&o_stage[m * kORow + n - n0]);
#ifdef SWIGLU_NO_REDUCE
          if (M < 0)  // never
#endif
          atomicAdd(reinterpret_cast<float4*>(ws + (long long)(m0 + m) * d + n), v);
        }
      }
    }
  }

  cp_async_wait<0>();
}

// out = bf16(ws), and ws = 0 again for the next call; 4 values a thread
__global__ void swiglu_cast_kernel(float4* __restrict__ ws, __nv_bfloat162* __restrict__ out,
                                   long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = ws[i];
    ws[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    out[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    out[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

cudaError_t opt_in_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(swiglu_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// out is the [M, d] float32 result; the kernel sums into it directly.
extern "C" int swiglu_f32(const void* x, const void* wg, const void* wu, const void* wd,
                          void* out, int M, int d, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)M * d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + kRows - 1) / kRows, (F + kBF - 1) / kBF);
  swiglu_kernel_simt<<<grid, kSimtThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<const float*>(wd), static_cast<float*>(out), M, d, F);
  return static_cast<int>(cudaGetLastError());
}

// ws is an [M, d] float32 workspace, zero on entry and left zero on exit;
// out is the [M, d] bfloat16 result. d and F multiples of 8, every pointer
// 16-byte aligned.
extern "C" int swiglu_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                           void* ws, void* out, int M, int d, int F, void* stream) {
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((F + kFB - 1) / kFB, (M + kMT - 1) / kMT);
  swiglu_kernel_mma<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), static_cast<const __nv_bfloat16*>(wd),
      static_cast<float*>(ws), M, d, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = (long long)M * d / 4;
  const long long blocks = (n4 + 255) / 256;
  swiglu_cast_kernel<<<(int)(blocks < 132 * 8 ? blocks : 132 * 8), 256, 0, s>>>(
      static_cast<float4*>(ws), static_cast<__nv_bfloat162*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of the bf16 kernel (build report)
extern "C" int swiglu_bf16_smem_bytes() { return (int)kSmemBytes; }
