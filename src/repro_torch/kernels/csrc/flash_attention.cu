// Flash attention, causal / sliding-window / GQA, with an online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention_bhsd). q is [BH, Sq, D], k is [BKV, Skv, D]
// and v is [BKV, Skv, Dv], all contiguous, float32 or bfloat16; query head
// bh reads kv head bh / G with G = BH / BKV (GQA, no repeated copy). out is
// [BH, Sq, Dv] in q's dtype. D is one of 16, 24, 32, 64, 96, 112, 128, 192
// and Dv one of 16, 32, 64, 96, 112, 128 with Dv <= D (FLASH_PAIRS below):
// MLA's prefill is D = 192 (128 + 64 rope) with Dv = 128, Phi-3-vision's
// D = Dv = 96, Zamba2's shared attention D = Dv = 112 (3584 / 32 heads);
// the reduced test configs take D = Dv = 16 (heads of 16) and reduced
// MLA's prefill D = 24 (16 + 8 rope) with Dv = 16.
// Masks, as in the Pallas body: kpos < Skv; causal keeps
// qpos >= kpos (top-left aligned, no query offset); a window > 0 keeps
// qpos - kpos < window. Masked scores are -1e30, not -inf, m and l are
// float32, and the result is acc / max(l, 1e-30) (the bf16 kernel multiplies
// by the reciprocal, within one f32 step of the quotient: an IEEE division
// is a subroutine, and each thread has 64 of them). KV tiles that the
// causal mask or the window rule out entirely are never loaded, as
// flash_attention.py:58-62 skips them. Any Sq and Skv >= 1 are taken.
//
// Bound on an H100: at the serving shape (B = 4, S = 16, 32 q heads, 8 kv
// heads, D = 128, bf16) the kernel moves ~1.3 MB, ~0.4 us at 3.35 TB/s,
// below the launch floor. A long causal prefill (S = 4096) does ~137 GFLOP
// and is bound by operations: 139 us on the bf16 tensor cores. At MLA's
// D = 192 / Dv = 128 the products do (192 + 128) / 256 = 1.25x the work of
// D = 128 for each pair of query and key.
//
// bfloat16 (the serving path): flash_kernel_wgmma, in FA3's shape.
//   * Both products run on the tensor cores as wgmma with f32 accumulators
//     in registers: S = Q K^T with Q and K in swizzled shared memory, and
//     O += P V with P in registers and V read transposed from shared memory.
//     The online softmax runs in registers (row max and row sum over the
//     quad of lanes that holds a row). P is rounded to bf16 before P V, as
//     FA3 and the JAX model's full_attention round it; scores, m, l and the
//     accumulator stay f32.
//   * One producer warp keeps TMA loads of 64-key K and V tiles in flight in
//     a two-stage ring guarded by mbarriers, so the next tile's bytes arrive
//     while one consumer warpgroup (64 query rows) computes; two blocks
//     share an SM (141 registers a thread and 83 KB of shared memory at
//     D = 128), so one block's products run beside the other's softmax.
//     TMA zero-fills keys past Skv. A width that is a multiple of 64 columns
//     loads as 64-column boxes of 128 B rows under the 128-byte swizzle (D =
//     128 two boxes, D = 192 three); another multiple of 32, 32 or 96, as
//     32-column boxes of 64 B rows under the 64-byte swizzle (a 96-column
//     row, 192 B, is no multiple of the 128-byte span); 112 (a 224 B row, a
//     multiple of neither span) as seven 16-column boxes of 32 B rows under
//     the 32-byte swizzle, one box a k16 step of Q K^T. K (D columns) and V
//     (Dv) have their own maps and boxes: S = Q K^T runs padded(D) / 16 steps of
//     k16 (12 at D = 192, 7 at D = 112), O += P V keeps a Dv-wide
//     accumulator (an n112 product at Dv = 112, n16 at Dv = 16). D = 16 is
//     one 16-column box; D = 24, no whole number of k16 steps, is padded
//     to 32 inside the kernel: Q and K tiles are 32 columns wide (one
//     64-byte-swizzle box), K's tensor map has a global width of 24 and a
//     box of 32, so TMA writes zeros into columns 24-31, and the consumers
//     store zeros there for Q; zero columns add nothing to Q K^T, and the
//     scale stays 24^-0.5. The tensor maps are encoded per call on the host
//     through the runtime's driver entry point, so the library needs no
//     -lcuda.
//   * The consumers store Q into shared memory themselves, in K's swizzle; so when G * Sq <= 64 (a short prompt: 4 x 14 = 56 at the
//     serving shape) the G query heads of one kv head are packed into one
//     64-row tile (row r is head r / Sq at position r % Sq) and K / V are
//     loaded once per kv head: 32 blocks there instead of 128 mostly empty
//     ones.
//   * Long prompts: the grid's slow dimension walks the query tiles last to
//     first, so under causal masking the longest tiles start first.
//   * Only tiles on the edge of the causal or window band, or past Skv,
//     apply the element mask.
// float32: flash_kernel_simt, the CUDA-core kernel of the first port (no
// TF32: the f32 tolerance, 2e-5, rules it out). One block of 256 threads
// per (bh, 64-row query tile); 32-key K and V tiles staged in shared memory
// as float32; scores, softmax and P @ V in float32 on the CUDA cores.
//
// Both kernels are instantiated for every (D, Dv) of FLASH_PAIRS; the entry
// points return cudaErrorInvalidValue for any other pair.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// every (D, Dv) the kernels take
#define FLASH_PAIRS(X)                                                                       \
  X(16, 16) X(24, 16) X(32, 32) X(64, 32) X(64, 64) X(96, 32) X(96, 64) X(96, 96)           \
  X(112, 112) X(128, 32) X(128, 64) X(128, 96) X(128, 128) X(192, 32) X(192, 64) X(192, 96) \
  X(192, 128)

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// Sets the dynamic shared-memory opt-in of a kernel once per device, not on
// every launch (a second setting by a racing thread is harmless).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block
constexpr int kSimtBKV = 32;  // keys per staged tile
constexpr int kSimtThreads = 256;

// shared memory layout, in floats; rows padded by one float so that threads
// reading down a column hit different banks
template <int D, int Dv>
struct SimtSmem {
  static constexpr int kQ = kBQ * (D + 1);
  static constexpr int kK = kSimtBKV * (D + 1);
  static constexpr int kV = kSimtBKV * Dv;
  static constexpr int kP = kBQ * (kSimtBKV + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP + 3 * kBQ);
};

template <int D, int Dv>
__global__ void __launch_bounds__(kSimtThreads)
flash_kernel_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int G, int Sq, int Skv,
                  int causal, int window, float scale) {
  extern __shared__ float smem[];
  using L = SimtSmem<D, Dv>;
  float* Qs = smem;                      // [kBQ][D + 1]
  float* Ks = Qs + L::kQ;                // [kSimtBKV][D + 1]
  float* Vs = Ks + L::kK;                // [kSimtBKV][Dv]
  float* Ps = Vs + L::kV;                // [kBQ][kSimtBKV + 1]
  float* m_s = Ps + L::kP;               // [kBQ] running max
  float* l_s = m_s + kBQ;                // [kBQ] running sum
  float* c_s = l_s + kBQ;                // [kBQ] this tile's correction

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + (long long)bh * Sq * D;
  const float* kb = k + (long long)(bh / G) * Skv * D;
  const float* vb = v + (long long)(bh / G) * Skv * Dv;
  float* ob = o + (long long)bh * Sq * Dv;

  for (int idx = tid; idx < kBQ * D; idx += kSimtThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * (D + 1) + c] = q0 + r < Sq ? qb[(long long)(q0 + r) * D + c] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // Each thread owns rows tr + 16 i (i < 4) of the tile: score columns
  // tc + 16 j (j < 2) and output columns tc + 16 j (j < Dv / 16).
  const int tr = tid / 16, tc = tid % 16;
  constexpr int kCols = Dv / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // kv tiles that hold at least one unmasked key for this query tile
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1) / kSimtBKV * kSimtBKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kSimtBKV) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    for (int idx = tid; idx < kSimtBKV * D; idx += kSimtThreads) {
      const int r = idx / D, c = idx % D;
      Ks[r * (D + 1) + c] = k0 + r < Skv ? kb[(long long)(k0 + r) * D + c] : 0.f;
    }
    for (int idx = tid; idx < kSimtBKV * Dv; idx += kSimtThreads) {
      const int r = idx / Dv, c = idx % Dv;
      Vs[r * Dv + c] = k0 + r < Skv ? vb[(long long)(k0 + r) * Dv + c] : 0.f;
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
        Ps[(tr + 16 * i) * (kSimtBKV + 1) + tc + 16 * j] = keep ? s[i][j] * scale : kNegInf;
      }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int row = tid / 4, part = tid % 4;
      float* prow = Ps + row * (kSimtBKV + 1);
      float mx = kNegInf;
      for (int c = part; c < kSimtBKV; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kSimtBKV; c += 4) {
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
    for (int c = 0; c < kSimtBKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr + 16 * i) * (kSimtBKV + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = Vs[c * Dv + tc + 16 * j];
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
    for (int j = 0; j < kCols; ++j) ob[(long long)(q0 + row) * Dv + tc + 16 * j] = acc[i][j] / l;
  }
}

template <int D, int Dv>
int launch_simt(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq,
                int Skv, int causal, int window, float scale, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  const size_t bytes = SimtSmem<D, Dv>::kBytes;
  cudaError_t err = opt_in_smem(flash_kernel_simt<D, Dv>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_kernel_simt<D, Dv><<<grid, kSimtThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), BH / BKV, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA (inline PTX, sm_90a)
// ---------------------------------------------------------------------------

constexpr int kBKV = 64;                 // keys per TMA tile
constexpr int kStages = 2;               // K / V ring depth
constexpr int kConsumers = 128;          // one warpgroup: 64 query rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-d tensor map into shared memory; completion counted in bytes
// on the mbarrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (1: 128-byte swizzle, 2: 64-byte,
// 3: 32-byte)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// SS: A and B from shared memory, both K-major; D = A B, m64n64k16, f32 accumulators
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// RS: A from registers, B from shared memory MN-major (transposed); D += A B, m64n16k16, f32 accumulators
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS: A from registers, B from shared memory MN-major (transposed); D += A B, m64n32k16, f32 accumulators
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS: A from registers, B from shared memory MN-major (transposed); D += A B, m64n64k16, f32 accumulators
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS: A from registers, B from shared memory MN-major (transposed); D += A B, m64n96k16, f32 accumulators
__device__ __forceinline__ void wgmma_rs_m64n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS: A from registers, B from shared memory MN-major (transposed); D += A B, m64n112k16, f32 accumulators
__device__ __forceinline__ void wgmma_rs_m64n112(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS: A from registers, B from shared memory MN-major (transposed); D += A B, m64n128k16, f32 accumulators
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// One operand tile of R rows x W columns in shared memory: column boxes of
// kW elements (one swizzle row of kRowBytes bytes), each box R rows deep, as
// TMA writes them; every box starts on a 1024-byte boundary. A multiple of
// 64 columns takes the 128-byte swizzle, another multiple of 32 (32, 96)
// the 64-byte one, and any other multiple of 16 (112) the 32-byte one.
template <int W>
struct Tile {
  static_assert(W % 16 == 0, "a tile is a whole number of 16-column boxes");
  static constexpr int kRowBytes = W % 64 == 0 ? 128 : W % 32 == 0 ? 64 : 32;
  static constexpr int kW = kRowBytes / 2;
  static constexpr int kBoxes = W / kW;
  // descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // the swizzle XORs the 16-byte chunk index with the row's low bits
  static constexpr uint32_t kSwizzleMask = kRowBytes / 16 - 1;
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int kSbo = 8 * kRowBytes;          // next group of 8 rows
  static constexpr int kQBoxBytes = kBQ * kRowBytes;
  static constexpr int kKVBoxBytes = kBKV * kRowBytes;
  static constexpr int kQBytes = kBQ * W * 2;
  static constexpr int kKVBytes = kBKV * W * 2;       // one K or V tile
};

// a head width in shared memory: a whole number of k16 steps (24 -> 32)
__host__ __device__ constexpr int padded(int w) { return (w + 15) / 16 * 16; }

// Q, the K ring and the V ring, 1024-byte aligned, and the ring's mbarriers
template <int D, int Dv>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + Tile<padded(D)>::kQBytes +
         kStages * (Tile<padded(D)>::kKVBytes + Tile<Dv>::kKVBytes) + 2 * kStages * 8;
}

// the byte offset within a swizzled box at which TMA puts logical offset off
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

template <int D, int Dv>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int G,
                   int Sq, int Skv, int causal, int window, float scale_log2) {
  static_assert(Dv % 16 == 0, "Dv is a whole number of 16-column boxes");
  using L = Tile<padded(D)>;  // Q and K, D padded to whole k16 steps
  using LV = Tile<Dv>;        // V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + L::kQBytes;                 // [kStages] K tiles
  const uint32_t v_s = k_s + kStages * L::kKVBytes;      // [kStages] V tiles
  const uint32_t bars = v_s + kStages * LV::kKVBytes;    // full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  // this block's query rows: row r is head head0 + r / per at position
  // pos0 + r % per; with G * Sq <= 64 the G heads of one kv head share it
  const bool packed = G * Sq <= kBQ;
  int kvh, head0, pos0, per, nrows;
  if (packed) {
    kvh = blockIdx.x;
    head0 = kvh * G;
    pos0 = 0;
    per = Sq;
    nrows = G * Sq;
  } else {
    head0 = blockIdx.x;
    kvh = head0 / G;
    pos0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last query tile first
    per = kBQ;
    nrows = min(kBQ, Sq - pos0);
  }
  const int qmin = pos0;
  const int qmax = packed ? Sq - 1 : pos0 + nrows - 1;
  // kv tiles that hold at least one unmasked key for these rows
  const int kv_end = causal ? min(Skv, qmax + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, qmin - window + 1) / kBKV * kBKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBKV - 1) / kBKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one lane keeps the K / V ring full
    if (threadIdx.x == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&v_map)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int k0 = kv_begin + t * kBKV;
        mbar_wait(empty(stage), phase ^ 1u);
        mbar_expect_tx(full(stage), L::kKVBytes + LV::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_3d(k_s + stage * L::kKVBytes + c * L::kKVBoxBytes, &k_map, full(stage),
                      c * L::kW, k0, kvh);
#pragma unroll
        for (int c = 0; c < LV::kBoxes; ++c)
          tma_load_3d(v_s + stage * LV::kKVBytes + c * LV::kKVBoxBytes, &v_map, full(stage),
                      c * LV::kW, k0, kvh);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumers: Q into shared memory in the boxes' swizzle, 16 bytes a load
  // (chunks past D, the padding, are zeros); every load of a thread is
  // issued before the first store
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kChunks = padded(D) / 8;                    // per row
  constexpr int kPerThread = kBQ * kChunks / kConsumers;
  uint4 qv[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = tid + i * kConsumers, r = idx / kChunks, c = idx % kChunks;
    qv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && c < D / 8) {
      const long long row = (long long)(head0 + r / per) * Sq + pos0 + r % per;
      qv[i] = *reinterpret_cast<const uint4*>(q + row * D + c * 8);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = tid + i * kConsumers, r = idx / kChunks, c = idx % kChunks;
    const int box = c * 16 / L::kRowBytes;
    const uint32_t off = r * L::kRowBytes + c * 16 % L::kRowBytes;
    *reinterpret_cast<uint4*>(gbase + box * L::kQBoxBytes + swizzle(off, L::kSwizzleMask)) = qv[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // this thread's two rows of every accumulator (wgmma's fragment layout):
  // r0 = 16 warp + lane / 4 and r0 + 8; register j holds column
  // 8 (j / 4) + 2 (lane % 4) + (j & 1) of row r0 + 8 ((j >> 1) & 1)
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int qp0 = pos0 + r0 % per, qp1 = pos0 + r1 % per;
  const int col = 2 * (lane % 4);

  float acc[Dv / 2];
#pragma unroll
  for (int j = 0; j < Dv / 2; ++j) acc[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's part of the row sum

  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * kBKV;
    mbar_wait(full(stage), phase);
    const uint32_t k_tile = k_s + stage * L::kKVBytes, v_tile = v_s + stage * LV::kKVBytes;

    // S = Q K^T, padded(D) / 16 steps of 16 along the head dimension
    float s[kBKV / 2];
#pragma unroll
    for (int j = 0; j < kBKV / 2; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < padded(D) / 16; ++kk) {
      const int box = kk * 32 / L::kRowBytes;
      const uint32_t within = kk * 32 % L::kRowBytes;
      const uint64_t da = smem_desc(q_s + box * L::kQBoxBytes + within, 16, L::kSbo, L::kLayout);
      const uint64_t db = smem_desc(k_tile + box * L::kKVBoxBytes + within, 16, L::kSbo, L::kLayout);
      wgmma_ss_m64n64(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale into the exp2 domain; the element mask only on the band's edge
    const bool edge = k0 + kBKV > Skv || (causal && k0 + kBKV - 1 > qmin) ||
                      (window > 0 && qmax - k0 >= window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBKV / 2; ++j) {
      float x = s[j] * scale_log2;
      if (edge) {
        const int kp = k0 + 8 * (j / 4) + col + (j & 1);
        const int qp = (j & 2) ? qp1 : qp0;
        bool keep = kp < Skv;
        if (causal) keep = keep && qp >= kp;
        if (window > 0) keep = keep && qp - kp < window;
        if (!keep) x = kNegInf;
      }
      s[j] = x;
      if (j & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBKV / 2; ++j) {
      const float p = exp2f(s[j] - ((j & 2) ? mn1 : mn0));
      s[j] = p;
      if (j & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < Dv / 2; ++j) acc[j] *= (j & 2) ? c1 : c0;

    // P in bf16: the score fragment of keys 16 kk .. 16 kk + 15 is the A
    // fragment of the kk-th step of P V
    uint32_t a[kBKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V, V read transposed (MN-major): 16 keys a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint64_t db = smem_desc(v_tile + kk * 16 * LV::kRowBytes, LV::kKVBoxBytes, LV::kSbo,
                                    LV::kLayout);
      if constexpr (Dv == 128) wgmma_rs_m64n128(acc, a[kk], db);
      else if constexpr (Dv == 112) wgmma_rs_m64n112(acc, a[kk], db);
      else if constexpr (Dv == 96) wgmma_rs_m64n96(acc, a[kk], db);
      else if constexpr (Dv == 64) wgmma_rs_m64n64(acc, a[kk], db);
      else if constexpr (Dv == 32) wgmma_rs_m64n32(acc, a[kk], db);
      else wgmma_rs_m64n16(acc, a[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(stage));  // this stage's K and V are no longer read
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= nrows) continue;
    const float inv_l = 1.f / (h ? l1 : l0);
    __nv_bfloat16* out = o + ((long long)(head0 + r / per) * Sq + pos0 + r % per) * Dv + col;
#pragma unroll
    for (int i = 0; i < Dv / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * inv_l, acc[4 * i + 2 * h + 1] * inv_l);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads, Skv, W] bf16 as a 3-d map of (kW columns x kBKV keys x 1 head)
// boxes of the padded tile, swizzled as wgmma reads them; keys past Skv and
// columns past W (a padded width) read as zeros
template <int W>
bool encode_kv_map(CUtensorMap* map, const void* ptr, int heads, int Skv) {
  using L = Tile<padded(W)>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)Skv, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)Skv * W * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::kW, (cuuint32_t)kBKV, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, L::kTmaSwizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int Dv>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq,
                 int Skv, int causal, int window, float scale, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  const size_t bytes = wgmma_smem_bytes<D, Dv>();
  cudaError_t err = opt_in_smem(flash_kernel_wgmma<D, Dv>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap k_map, v_map;
  if (!encode_kv_map<D>(&k_map, k, BKV, Skv) || !encode_kv_map<Dv>(&v_map, v, BKV, Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = BH / BKV;
  const dim3 grid = G * Sq <= kBQ ? dim3(BKV) : dim3(BH, (Sq + kBQ - 1) / kBQ);
  flash_kernel_wgmma<D, Dv><<<grid, kThreads, bytes, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), G, Sq,
      Skv, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_CASE(launch, D_, DV_)                                                    \
  if (D == D_ && Dv == DV_)                                                          \
    return launch<D_, DV_>(q, k, v, o, BH, BKV, Sq, Skv, causal, window, scale,      \
                           static_cast<cudaStream_t>(stream));
#define SIMT_CASE(D_, DV_) FLASH_CASE(launch_simt, D_, DV_)
#define WGMMA_CASE(D_, DV_) FLASH_CASE(launch_wgmma, D_, DV_)
#define SMEM_CASE(D_, DV_) \
  if (D == D_ && Dv == DV_) return (int)wgmma_smem_bytes<D_, DV_>();

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int BH, int BKV, int Sq, int Skv, int D, int Dv, int causal,
                                   int window, float scale, void* stream) {
  FLASH_PAIRS(SIMT_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v 16-byte aligned; Skv >= 1
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int BH, int BKV, int Sq, int Skv, int D, int Dv, int causal,
                                    int window, float scale, void* stream) {
  FLASH_PAIRS(WGMMA_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of the bf16 kernel at (D, Dv) (build report); -1 for
// a pair it does not take
extern "C" int flash_attention_bf16_smem_bytes(int D, int Dv) {
  FLASH_PAIRS(SMEM_CASE)
  return -1;
}
