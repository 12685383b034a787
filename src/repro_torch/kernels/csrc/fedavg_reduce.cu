// Weighted FedAvg reduction over a table of leaves:
//   out_l[n] = sum_c w[c] * x_l[c, n]   for every leaf l of a parameter tree.
//
// Replaces the TPU kernel repro/kernels/fedavg_reduce.py::_reduce_kernel
// (pallas_call in fedavg_reduce_flat), which the reference launches once per
// leaf. Each x_l is [C, n_l] row-major, float32 or bfloat16 (one type per
// launch); w is [C] float32 and already normalized; out_l is [n_l] float32.
//
// Bound on an H100: memory, and at the MNIST CNN's sizes the launch. The
// kernel reads C*sum(n_l)*sizeof(x) + 4*C bytes and writes 4*sum(n_l), and
// does 2*C*sum(n_l) flops, far below the ~20 flop/byte at which float32
// FMAs rather than HBM would limit it. At the CNN (C = 10, 206,922 f32
// parameters in 8 leaves) that is ~9.1 MB, ~2.7 us at 3.35 TB/s, and seven
// of the eight leaves move under 60 KB between them: one launch per leaf
// cost ~2.6-3 us each. So one launch covers every leaf.
//
// Design:
// - The leaf table (pointers, n_l, first block, access mode) is a kernel
//   parameter passed by value (__grid_constant__, ~2 KB of the 4 KB limit):
//   no host-to-device copy and no extra launch. The entry point fills in
//   the blocks and access modes; the wrapper splits a tree of more than
//   kMaxLeaves leaves into several launches.
// - Blocks are flattened over (leaf, column tile); a block finds its leaf by
//   binary search over the table's first blocks.
// - A thread owns V neighbouring columns (16 bytes of x per row: V = 4
//   floats or 8 bf16) and reads each row with one 16-byte load where x_l's
//   base is 16-byte aligned and n_l % V == 0; otherwise it reads V columns
//   a block width apart with scalar loads (still coalesced). An offset view
//   can be 4-byte but not 16-byte aligned, and the CNN has a leaf of 10. The output is written
//   as float4 where out_l is 16-byte aligned, else as scalars.
// - The loop over clients is unrolled kUnroll deep, all loads issued before
//   the first FMA, so each thread keeps up to kUnroll 16-byte loads in
//   flight.
// - The weights are staged in shared memory.
// - Each output element is one float32 fmaf chain over c in order, as in
//   the earlier one-launch-per-leaf kernel, so a leaf's result is bitwise
//   the same alone as among other leaves, whatever its access mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;
constexpr int kUnroll = 16;

// kept in step with _Leaf / _Table in kernels/fedavg_reduce.py
struct Leaf {
  const void* x;    // [C, n] row-major
  float* out;       // [n]
  long long n;      // > 0
  int first_block;  // set by the entry point
  int mode;         // set by the entry point: bit 0 vector loads, bit 1 vector stores
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int count;
};

constexpr int kVectorLoads = 1;
constexpr int kVectorStores = 2;

// 16 bytes of x: 4 floats or 8 bf16 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void to_f32(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ static float scalar(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void to_f32(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // low half is the lower address
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float scalar(const void* p, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
};

template <typename T>
__host__ __device__ constexpr long long tile_cols() { return (long long)kThreads * Vec<T>::kN; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_reduce_leaves_kernel(const __grid_constant__ LeafTable table,
                            const float* __restrict__ w, int C) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float sw[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sw[c] = w[c];

  // the last leaf whose first block is <= this block
  const int b = blockIdx.x;
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& leaf = table.leaf[lo];
  const long long n = leaf.n;
  const long long tile0 = (long long)(b - leaf.first_block) * tile_cols<T>();
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;

  if (leaf.mode & kVectorLoads) {
    // columns col .. col + V - 1; n % V == 0, so the group is whole or absent
    const long long col = tile0 + (long long)threadIdx.x * V;
    if (col >= n) return;
    const uint4* base = reinterpret_cast<const uint4*>(static_cast<const T*>(leaf.x) + col);
    const long long row_stride = n / V;  // in uint4
    for (int c0 = 0; c0 < C; c0 += kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u < C) v[u] = __ldg(base + (long long)(c0 + u) * row_stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + u < C) {
          float f[V];
          Vec<T>::to_f32(v[u], f);
          const float wc = sw[c0 + u];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(wc, f[j], acc[j]);
        }
      }
    }
    float* o = leaf.out + col;
    if (leaf.mode & kVectorStores) {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(o + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = acc[j];
    }
    return;
  }

  // scalar: columns tile0 + j * kThreads + threadIdx.x, j < V
  for (int c0 = 0; c0 < C; c0 += kUnroll) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long col = tile0 + (long long)j * kThreads + threadIdx.x;
      if (col >= n) break;
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u < C) v[u] = Vec<T>::scalar(leaf.x, (long long)(c0 + u) * n + col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u < C) acc[j] = fmaf(sw[c0 + u], v[u], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long col = tile0 + (long long)j * kThreads + threadIdx.x;
    if (col < n) leaf.out[col] = acc[j];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const LeafTable* given, const void* w, int C, void* stream) {
  constexpr int V = Vec<T>::kN;
  if (given->count < 1 || given->count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  LeafTable table = *given;
  long long blocks = 0;
  for (int l = 0; l < table.count; ++l) {
    Leaf& leaf = table.leaf[l];
    if (leaf.n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    leaf.first_block = static_cast<int>(blocks);
    leaf.mode = 0;
    if (leaf.n % V == 0 && aligned16(leaf.x)) {
      leaf.mode |= kVectorLoads;
      if (aligned16(leaf.out)) leaf.mode |= kVectorStores;
    }
    blocks += (leaf.n + tile_cols<T>() - 1) / tile_cols<T>();
    if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  fedavg_reduce_leaves_kernel<T><<<static_cast<unsigned int>(blocks), kThreads,
                                   C * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const float*>(w), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fedavg_reduce_max_leaves() { return kMaxLeaves; }

// table: host copy of the leaf table (x, out, n filled in; first_block and
// mode are computed here); w [C] f32 on the device. Returns a cudaError_t.
extern "C" int fedavg_reduce_leaves_f32(const void* table, const void* w, int C, void* stream) {
  return launch<float>(static_cast<const LeafTable*>(table), w, C, stream);
}

extern "C" int fedavg_reduce_leaves_bf16(const void* table, const void* w, int C, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const LeafTable*>(table), w, C, stream);
}
