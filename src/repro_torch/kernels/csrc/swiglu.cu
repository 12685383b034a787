// Fused SwiGLU MLP: out = (silu(x @ Wg) * (x @ Wu)) @ Wd.
//
// Replaces the TPU kernel repro/kernels/swiglu.py::_swiglu_kernel
// (pallas_call in swiglu_fused). x is [M, d], Wg and Wu are [d, F], Wd is
// [F, d], all contiguous and of one dtype, float32 or bfloat16. As in the
// Pallas body, g and u are float32 sums, h = silu(g) * u is formed in
// float32 and rounded to x's dtype before the product with Wd, that product
// is summed in float32, and the result is cast to x's dtype. The [M, F]
// hidden h never reaches device memory.
//
// Bound on an H100: the weights. At Qwen3-8B's widths (d = 4096,
// F = 12288) one call reads 150,994,944 weights, 302 MB in bf16, ~90 us at
// 3.35 TB/s; at M = 64 rows its 19.3 GFLOP would take 19.5 us on the bf16
// tensor cores, so bytes bound it from decode (M = 4) through a 64-token
// prefill.
//
// Design: a grid over (8-row tile of x, 64-column tile of F), the row tile
// fastest, so the blocks that share a weight tile run together and read it
// from HBM once; at decode (M <= 8) one row tile covers every row and each
// weight is read exactly once. In a block:
//   1. the 8 warps split d; each lane owns two of the 64 hidden columns and
//      all 8 rows, reads its Wg and Wu columns straight from global memory
//      (one warp covers a 128-byte row segment) and takes x from a float32
//      tile in shared memory;
//   2. the warps' partial g and u are summed in shared memory, and
//      h = silu(g) * u is rounded to x's dtype and kept there ([64][8]);
//   3. each thread owns two output columns at a time, reads Wd's 64 rows
//      of them, and adds its 8 row sums into a float32 [M, d] workspace with
//      atomicAdd.
// A second, small launch casts the workspace to bfloat16 (a float32 call
// sums straight into its output). The atomics make the order in which the
// F tiles are summed vary from run to run, so results may differ in the
// last bits between runs; the tolerances allow that. The products run on
// the CUDA cores in float32, never TF32 (tensor cores are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;      // rows of x per block
constexpr int kBF = 64;       // hidden columns per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 256;      // d values of x staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float load_or_zero(const T* p, long long at, bool in) {
  return in ? to_f32(p[at]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
              const T* __restrict__ wd, float* __restrict__ ws, int M, int d, int F) {
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
    for (int idx = tid; idx < kKC * kRows; idx += kThreads) {
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

  // 2. h = silu(g) * u, rounded to x's dtype, kept on chip
  for (int idx = tid; idx < kRows * kBF; idx += kThreads) {
    const int r = idx / kBF, f = idx % kBF;
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      gs += red[0][w][r][f];
      us += red[1][w][r][f];
    }
    const float h = (gs * (1.f / (1.f + expf(-gs)))) * us;
    hs[f * kRows + r] = to_f32(from_f32<T>(h));
  }
  __syncthreads();

  // 3. ws[rows, :] += h @ Wd[f0 : f0 + 64, :]
  const int f_count = min(kBF, F - f0);
  for (int n = 2 * tid; n < d; n += 2 * kThreads) {
    const bool in_n1 = n + 1 < d;
    float a0[kRows], a1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 8
    for (int f = 0; f < f_count; ++f) {
      const long long row = (long long)(f0 + f) * d;
      const float w0 = to_f32(wd[row + n]);
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
      float* out = ws + (long long)(m0 + r) * d + n;
      atomicAdd(out, a0[r]);
      if (in_n1) atomicAdd(out + 1, a1[r]);
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                 long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(ws[i]);
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* ws, int M,
           int d, int F, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ws, 0, sizeof(float) * (size_t)M * d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + kRows - 1) / kRows, (F + kBF - 1) / kBF);
  swiglu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), static_cast<float*>(ws), M, d, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out is the [M, d] float32 result; the kernel sums into it directly.
extern "C" int swiglu_f32(const void* x, const void* wg, const void* wu, const void* wd,
                          void* out, int M, int d, int F, void* stream) {
  return launch<float>(x, wg, wu, wd, out, M, d, F, static_cast<cudaStream_t>(stream));
}

// ws is an [M, d] float32 workspace; out is the [M, d] bfloat16 result.

extern "C" int swiglu_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                           void* ws, void* out, int M, int d, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch<__nv_bfloat16>(x, wg, wu, wd, ws, M, d, F, s);
  if (err != 0) return err;
  const long long n = (long long)M * d;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cast_bf16_kernel<<<(int)blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                               static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
