// Weighted FedAvg reduction: out[n] = sum_c w[c] * x[c, n].
//
// Replaces the TPU kernel repro/kernels/fedavg_reduce.py::_reduce_kernel
// (pallas_call in fedavg_reduce_flat). x is [C, N] row-major, float32 or
// bfloat16; w is [C] float32 and already normalized; out is [N] float32.
//
// Bound on an H100: memory. The kernel reads C*N*sizeof(x) + 4*C bytes and
// writes 4*N, and does 2*C*N flops, far below the ~20 flop/byte at which
// float32 FMAs rather than HBM would limit it. At the MNIST CNN's largest
// leaf (C = 10, N = 200704, f32) that is ~8.8 MB, about 2.6 us at 3.35 TB/s.
//
// Design: the TPU version pads N to a 2048 tile and runs one [C,1]x[C,T]
// dot per grid step. Here each thread owns one column at a time (grid-stride
// loop, so neighbouring threads read neighbouring addresses of every row),
// loops over C with the weights staged in shared memory, accumulates in a
// float32 register in c order, and masks the ragged tail instead of padding.
// Columns are independent, so there is no cross-block reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void fedavg_reduce_kernel(const T* __restrict__ x,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int C, int N) {
  extern __shared__ float sw[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sw[c] = w[c];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    float acc = 0.0f;
    const T* col = x + n;
    for (int c = 0; c < C; ++c) acc = fmaf(sw[c], to_f32(col[(long long)c * N]), acc);
    out[n] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

template <typename T>
int launch(const void* x, const void* w, void* out, int C, int N, void* stream) {
  int blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fedavg_reduce_kernel<T><<<blocks, kThreads, C * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fedavg_reduce_f32(const void* x, const void* w, void* out, int C,
                                 int N, void* stream) {
  return launch<float>(x, w, out, C, N, stream);
}

extern "C" int fedavg_reduce_bf16(const void* x, const void* w, void* out, int C,
                                  int N, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, C, N, stream);
}
