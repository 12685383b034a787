// Flash attention, causal / sliding-window / GQA, with an online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention_bhsd). q is [BH, Sq, D], k and v are
// [BKV, Skv, D], all contiguous, float32 or bfloat16; query head bh reads kv
// head bh / G with G = BH / BKV (GQA, no repeated copy). out is [BH, Sq, D]
// in q's dtype. Masks, as in the Pallas body: kpos < Skv; causal keeps
// qpos >= kpos (top-left aligned, no query offset); a window > 0 keeps
// qpos - kpos < window. Masked scores are -1e30, not -inf, and m, l and the
// accumulator are float32, so the result is the Pallas kernel's.
//
// Bound on an H100: at the serving shape (B = 4, S = 16, 32 q heads, 8 kv
// heads, D = 128, bf16) the kernel moves ~1.3 MB, ~0.4 us at 3.35 TB/s,
// below the launch floor. A long causal prefill (S = 4096) does ~137 GFLOP
// and is bound by operations.
//
// Design: one block of 256 threads per (bh, 64-row query tile). The query
// tile sits in shared memory as float32; 32-row K and V tiles are staged
// there in turn. Scores, softmax and P @ V run on the CUDA cores in float32
// (P is kept in float32, as the Pallas body keeps it; no TF32, no tensor
// cores yet: a simple kernel first). KV tiles that the causal mask or the
// window rule out entirely are never loaded, as flash_attention.py:58-62
// skips them. Rows past Sq and keys past Skv are masked, so any Sq and Skv
// are taken. Rows of shared memory are padded by one float so that threads
// reading down a column hit different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 32;  // keys per staged tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

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

// shared memory layout, in floats
template <int D>
struct Smem {
  static constexpr int kQ = kBQ * (D + 1);
  static constexpr int kK = kBKV * (D + 1);
  static constexpr int kV = kBKV * D;
  static constexpr int kP = kBQ * (kBKV + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP + 3 * kBQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int G, int Sq, int Skv, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][D + 1]
  float* Ks = Qs + Smem<D>::kQ;      // [kBKV][D + 1]
  float* Vs = Ks + Smem<D>::kK;      // [kBKV][D]
  float* Ps = Vs + Smem<D>::kV;      // [kBQ][kBKV + 1]
  float* m_s = Ps + Smem<D>::kP;     // [kBQ] running max
  float* l_s = m_s + kBQ;            // [kBQ] running sum
  float* c_s = l_s + kBQ;            // [kBQ] this tile's correction

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + (long long)(bh / G) * Skv * D;
  const T* vb = v + (long long)(bh / G) * Skv * D;
  T* ob = o + (long long)bh * Sq * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * (D + 1) + c] = q0 + r < Sq ? to_f32(qb[(long long)(q0 + r) * D + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // Each thread owns rows tr + 16 i (i < 4) of the tile: score columns
  // tc + 16 j (j < 2) and output columns tc + 16 j (j < D / 16).
  const int tr = tid / 16, tc = tid % 16;
  constexpr int kCols = D / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // kv tiles that hold at least one unmasked key for this query tile
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1) / kBKV * kBKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    for (int idx = tid; idx < kBKV * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < Skv;
      const long long at = (long long)(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[at]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qp = q0 + tr + 16 * i, kp = k0 + tc + 16 * j;
        bool keep = kp < Skv;
        if (causal) keep = keep && qp >= kp;
        if (window > 0) keep = keep && qp - kp < window;
        Ps[(tr + 16 * i) * (kBKV + 1) + tc + 16 * j] = keep ? s[i][j] * scale : kNegInf;
      }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int row = tid / 4, part = tid % 4;
      float* prow = Ps + row * (kBKV + 1);
      float mx = kNegInf;
      for (int c = part; c < kBKV; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBKV; c += 4) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[row] = corr;
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr + 16 * i) * (kBKV + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = Vs[c * D + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr + 16 * i;
    if (q0 + row >= Sq) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[(long long)(q0 + row) * D + tc + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH, int BKV,
             int Sq, int Skv, int causal, int window, float scale, void* stream) {
  const size_t bytes = Smem<D>::kBytes;
  // The shared-memory opt-in is set once per device for each instantiation,
  // not on every launch (a second setting by a racing thread is harmless).
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_kernel<T, D><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH / BKV, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq,
           int Skv, int D, int causal, int window, float scale, void* stream) {
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, o, BH, BKV, Sq, Skv, causal, window, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, BH, BKV, Sq, Skv, causal, window, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, BH, BKV, Sq, Skv, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int BH, int BKV, int Sq, int Skv, int D, int causal,
                                   int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, BH, BKV, Sq, Skv, D, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int BH, int BKV, int Sq, int Skv, int D, int causal,
                                    int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, BKV, Sq, Skv, D, causal, window, scale,
                               stream);
}
