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
// Design of quantize_rows: the TPU version pads each row to a 4096 tile and
// runs one VMEM block per grid step, one call per leaf. Here one launch
// covers every leaf of a tree: at the CNN seven of its eight leaves move
// under 60 KB between them, and a launch per leaf cost ~2.6-3 us each.
// - A leaf table (x, scales, q, rows, n_l, first block, access mode) is a
//   kernel parameter passed by value (__grid_constant__, ~3 KB of the 4 KB
//   limit): no host-to-device copy, no extra launch. The wrapper splits a
//   longer list of leaves into several launches.
// - Blocks are flattened over (leaf, row, column tile of 16 * kThreads); a
//   block finds its leaf by binary search over the first blocks.
// - A thread owns 16 neighbouring elements of a row: four 16-byte loads and
//   one 16-byte int8 store where the leaf allows it (x and q 16-byte aligned,
//   n_l % 16 == 0, so every row starts aligned); otherwise 16 elements a
//   block width apart with scalar loads and stores (still coalesced).
//
// Design of downcast_bf16_rows: the same idea over its own leaf table (x,
// out, n, first block, access mode). The downcast is elementwise, so a leaf
// [rows, n_l] is one flat row of rows * n_l; blocks are flattened over
// (leaf, tile of 16 * kThreads). A thread converts four float4 vectors a
// block width apart and writes each as one 8-byte store of 4 bf16 values
// where the leaf allows it (x and out 16-byte aligned, length % 4 == 0);
// otherwise 16 elements a block width apart with scalar accesses. One
// launch per bf16 round in place of one per leaf.
//
// Design of quantize_stochastic: one tile of 4 * kThreads elements per
// block, no grid-stride loop. A thread loads one float4 of x and one of u
// and writes its 4 codes as one 4-byte store where x and u are 16-byte
// aligned and q 4-byte aligned; the thread just past the last whole vector
// does the ragged tail (up to 3 elements). An unaligned array (an offset
// view) takes scalar accesses a block width apart. The scale is read once
// per block into shared memory, while x and u are in flight.
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

__device__ __forceinline__ int8_t clip_to_code(float v) {
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

constexpr int kMaxLeaves = 64;
constexpr int kPerThread = 16;
constexpr long long kTileCols = (long long)kThreads * kPerThread;

// kept in step with _RowsLeaf / _RowsTable in kernels/quantize.py
struct RowsLeaf {
  const float* x;       // [rows, n] row-major
  const float* scales;  // [rows]
  int8_t* q;            // [rows, n] row-major
  long long n;          // > 0
  int rows;             // > 0
  int first_block;      // set by the entry point
  int vec;              // set by the entry point: 16-byte loads and stores
  int pad;
};

struct RowsTable {
  RowsLeaf leaf[kMaxLeaves];
  int count;
};

// the last leaf whose first block is <= b
template <typename Table>
__device__ __forceinline__ int leaf_of(const Table& table, int b) {
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int8_t code_of(float x, float s) {
  return clip_to_code(floorf(__fadd_rn(__fdiv_rn(x, s), 0.5f)));
}

__device__ __forceinline__ uint32_t byte_of(int8_t c) { return static_cast<uint8_t>(c); }

// q_l[r, n] = clip(floor(x_l[r, n] / scales_l[r] + 0.5), -127, 127)
__global__ void __launch_bounds__(kThreads)
quantize_rows_leaves_kernel(const __grid_constant__ RowsTable table) {
  const int b = blockIdx.x;
  const RowsLeaf& leaf = table.leaf[leaf_of(table, b)];
  const long long n = leaf.n;
  const long long tiles = (n + kTileCols - 1) / kTileCols;
  const long long t = b - leaf.first_block;
  const long long row = t / tiles;
  const long long tile0 = (t % tiles) * kTileCols;
  const float s = leaf.scales[row];
  const float* xr = leaf.x + row * n;
  int8_t* qr = leaf.q + row * n;

  if (leaf.vec) {
    const long long col = tile0 + (long long)threadIdx.x * kPerThread;
    if (col >= n) return;  // n % 16 == 0: the group is whole or absent
    const float4* src = reinterpret_cast<const float4*>(xr + col);
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(src + i);
    uint32_t word[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)  // lowest address in the lowest byte
      word[i] = byte_of(code_of(v[i].x, s)) | byte_of(code_of(v[i].y, s)) << 8 |
                byte_of(code_of(v[i].z, s)) << 16 | byte_of(code_of(v[i].w, s)) << 24;
    *reinterpret_cast<uint4*>(qr + col) = make_uint4(word[0], word[1], word[2], word[3]);
    return;
  }
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long col = tile0 + (long long)j * kThreads + threadIdx.x;
    if (col < n) v[j] = xr[col];
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long col = tile0 + (long long)j * kThreads + threadIdx.x;
    if (col < n) qr[col] = code_of(v[j], s);
  }
}

// kept in step with _CastLeaf / _CastTable in kernels/quantize.py
struct CastLeaf {
  const float* x;       // [n]: a leaf [rows, n_l] taken flat
  __nv_bfloat16* out;   // [n]
  long long n;          // > 0
  int first_block;      // set by the entry point
  int vec;              // set by the entry point: float4 loads, 8-byte stores
};

struct CastTable {
  CastLeaf leaf[kMaxLeaves];
  int count;
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {  // lo at the lower address
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// out_l[i] = bf16(x_l[i]), round to nearest even
__global__ void __launch_bounds__(kThreads)
downcast_bf16_rows_leaves_kernel(const __grid_constant__ CastTable table) {
  const int b = blockIdx.x;
  const CastLeaf& leaf = table.leaf[leaf_of(table, b)];
  const long long n = leaf.n;
  const long long tile0 = (long long)(b - leaf.first_block) * kTileCols;

  if (leaf.vec) {
    constexpr int kVecs = kPerThread / 4;
    const float4* src = reinterpret_cast<const float4*>(leaf.x);
    uint2* dst = reinterpret_cast<uint2*>(leaf.out);
    const long long n4 = n >> 2, v0 = tile0 >> 2;
    float4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long i = v0 + (long long)j * kThreads + threadIdx.x;
      if (i < n4) v[j] = __ldg(src + i);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long i = v0 + (long long)j * kThreads + threadIdx.x;
      if (i < n4) dst[i] = make_uint2(bf16_pair(v[j].x, v[j].y), bf16_pair(v[j].z, v[j].w));
    }
    return;
  }
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = tile0 + (long long)j * kThreads + threadIdx.x;
    if (i < n) v[j] = leaf.x[i];
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = tile0 + (long long)j * kThreads + threadIdx.x;
    if (i < n) leaf.out[i] = __float2bfloat16_rn(v[j]);
  }
}

constexpr long long kStochTile = 4ll * kThreads;

__device__ __forceinline__ int8_t stochastic_code(float x, float u, float s) {
  return clip_to_code(floorf(__fadd_rn(__fdiv_rn(x, s), u)));
}

// q[i] = clip(floor(x[i] / scale + u[i]), -127, 127)
__global__ void __launch_bounds__(kThreads)
quantize_stochastic_kernel(const float* __restrict__ x, const float* __restrict__ u,
                           const float* __restrict__ scale, int8_t* __restrict__ q,
                           long long n, int vec) {
  __shared__ float s_block;
  if (threadIdx.x == 0) s_block = *scale;
  const long long tile0 = (long long)blockIdx.x * kStochTile;

  if (vec) {  // uniform over the block, so every thread meets the barrier
    const long long i = (tile0 >> 2) + threadIdx.x, n4 = n >> 2;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), uv = xv;
    if (i < n4) {
      xv = __ldg(reinterpret_cast<const float4*>(x) + i);
      uv = __ldg(reinterpret_cast<const float4*>(u) + i);
    }
    __syncthreads();  // the scale, loaded while x and u are in flight
    const float s = s_block;
    if (i < n4) {
      reinterpret_cast<uint32_t*>(q)[i] =  // lowest address in the lowest byte
          byte_of(stochastic_code(xv.x, uv.x, s)) | byte_of(stochastic_code(xv.y, uv.y, s)) << 8 |
          byte_of(stochastic_code(xv.z, uv.z, s)) << 16 |
          byte_of(stochastic_code(xv.w, uv.w, s)) << 24;
    } else if (i == n4) {  // the ragged tail, n % 4 elements
      for (long long k = 4 * n4; k < n; ++k) q[k] = stochastic_code(x[k], u[k], s);
    }
    return;
  }
  float xs[4], us[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = tile0 + (long long)j * kThreads + threadIdx.x;
    if (i < n) {
      xs[j] = x[i];
      us[j] = u[i];
    }
  }
  __syncthreads();
  const float s = s_block;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = tile0 + (long long)j * kThreads + threadIdx.x;
    if (i < n) q[i] = stochastic_code(xs[j], us[j], s);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" int quantize_rows_max_leaves() { return kMaxLeaves; }

// table: host copy of the leaf table (x, scales, q, rows, n filled in;
// first_block and vec are computed here). Returns a cudaError_t.
extern "C" int quantize_rows(const void* given, void* stream) {
  RowsTable table = *static_cast<const RowsTable*>(given);
  if (table.count < 1 || table.count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0;
  for (int l = 0; l < table.count; ++l) {
    RowsLeaf& leaf = table.leaf[l];
    if (leaf.n <= 0 || leaf.rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
    leaf.first_block = static_cast<int>(blocks);
    leaf.vec = leaf.n % kPerThread == 0 && aligned(leaf.x, 16) && aligned(leaf.q, 16);
    blocks += leaf.rows * ((leaf.n + kTileCols - 1) / kTileCols);
    if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  quantize_rows_leaves_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// table: host copy of the cast table (x, out, n filled in; first_block
// and vec are computed here). Returns a cudaError_t.
extern "C" int downcast_bf16_rows(const void* given, void* stream) {
  CastTable table = *static_cast<const CastTable*>(given);
  if (table.count < 1 || table.count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0;
  for (int l = 0; l < table.count; ++l) {
    CastLeaf& leaf = table.leaf[l];
    if (leaf.n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    leaf.first_block = static_cast<int>(blocks);
    leaf.vec = leaf.n % 4 == 0 && aligned(leaf.x, 16) && aligned(leaf.out, 16);
    blocks += (leaf.n + kTileCols - 1) / kTileCols;
    if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  downcast_bf16_rows_leaves_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// x [n] f32, u [n] f32 in [0, 1), scale -> a device f32 scalar; q [n] int8
extern "C" int quantize_stochastic(const void* x, const void* u, const void* scale,
                                   void* q, long long n, void* stream) {
  const long long blocks = (n + kStochTile - 1) / kStochTile;
  if (n <= 0 || blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned(x, 16) && aligned(u, 16) && aligned(q, 4);
  quantize_stochastic_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(scale), static_cast<int8_t*>(q), n, vec);
  return static_cast<int>(cudaGetLastError());
}
