// int8 / bf16 quantization for the compressed upload: three elementwise
// kernels, each beside its plain PyTorch version in kernels/ref.py.
//
// Replaces the TPU kernels of repro/kernels/quantize.py:
//   quantize_rows        <- quantize_rows_flat (_quant_rows_kernel)
//   downcast_bf16_rows   <- downcast_bf16_rows_flat (_bf16_rows_kernel)
//   quantize_stochastic  <- quantize_stochastic_flat (_quant_kernel)
//
// Bound on an H100: memory. Each element is read once as f32 (plus the
// caller's f32 uniform for the stochastic kernel) and written once as int8
// or bf16, with one division and one add: ~0.4 flop per byte, far below the
// ~20 flop/byte at which f32 arithmetic would limit it. At the MNIST CNN's
// 206,922 parameters and 10 rows one int8 pass moves ~10.3 MB, ~3.1 us at
// 3.35 TB/s.
//
// Design: the TPU versions pad each row to a 2048/4096 tile and run one
// VMEM block per grid step. Here a thread owns one element at a time in a
// grid-stride loop (neighbouring threads on neighbouring addresses, so f32
// loads and int8/bf16 stores coalesce), the ragged tail is masked by the
// loop bound instead of padded, and rows index blockIdx.y with a row stride
// of N, so no alignment of N is assumed (the CNN has a leaf of N = 10).
//
// The codes are a contract: they must equal the reference's bit for bit.
// So the quotient is the correctly rounded IEEE one (__fdiv_rn, never a
// multiply by 1/scale), rounding is floor(y + 0.5) or floor(y + u) with the
// add pinned by __fadd_rn, and the clip to [-127, 127] comes before the
// cast (__float2int_rn would round half to even). The kernels produce codes
// or bf16 values only: the dequantize multiply and the error-feedback
// residual are separate torch ops in the caller, so no FMA can fold them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

__device__ __forceinline__ int8_t clip_to_code(float v) {
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

// q[r, n] = clip(floor(x[r, n] / scales[r] + 0.5), -127, 127)
__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ scales,
                                     int8_t* __restrict__ q, long long N) {
  const long long row = blockIdx.y;
  const float s = scales[row];
  const float* xr = x + row * N;
  int8_t* qr = q + row * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    qr[n] = clip_to_code(floorf(__fadd_rn(__fdiv_rn(xr[n], s), 0.5f)));
  }
}

// out[i] = bf16(x[i]), round to nearest even
__global__ void downcast_bf16_rows_kernel(const float* __restrict__ x,
                                          __nv_bfloat16* __restrict__ out,
                                          long long n_total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_total;
       i += stride) {
    out[i] = __float2bfloat16_rn(x[i]);
  }
}

// q[i] = clip(floor(x[i] / scale + u[i]), -127, 127)
__global__ void quantize_stochastic_kernel(const float* __restrict__ x,
                                           const float* __restrict__ u,
                                           const float* __restrict__ scale,
                                           int8_t* __restrict__ q,
                                           long long n_total) {
  const float s = *scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_total;
       i += stride) {
    q[i] = clip_to_code(floorf(__fadd_rn(__fdiv_rn(x[i], s), u[i])));
  }
}

unsigned int blocks_for(long long n, long long cap) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < cap ? b : cap);
}

}  // namespace

// x [R, N] f32 row-major, scales [R] f32 -> q [R, N] int8. R <= 65535.
extern "C" int quantize_rows(const void* x, const void* scales, void* q, int R,
                             long long N, void* stream) {
  // spread ~kMaxBlocks blocks over the rows, at least one per row
  long long per_row = kMaxBlocks / (R > 0 ? R : 1);
  dim3 grid(blocks_for(N, per_row > 0 ? per_row : 1), static_cast<unsigned int>(R));
  quantize_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scales),
      static_cast<int8_t*>(q), N);
  return static_cast<int>(cudaGetLastError());
}

// x [n] f32 (any row layout: the downcast is elementwise) -> out [n] bf16
extern "C" int downcast_bf16_rows(const void* x, void* out, long long n,
                                  void* stream) {
  downcast_bf16_rows_kernel<<<blocks_for(n, kMaxBlocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// x [n] f32, u [n] f32 in [0, 1), scale -> a device f32 scalar; q [n] int8
extern "C" int quantize_stochastic(const void* x, const void* u, const void* scale,
                                   void* q, long long n, void* stream) {
  quantize_stochastic_kernel<<<blocks_for(n, kMaxBlocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(scale), static_cast<int8_t*>(q), n);
  return static_cast<int>(cudaGetLastError());
}
