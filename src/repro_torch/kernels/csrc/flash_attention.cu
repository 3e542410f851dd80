// Blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): causal, sliding-window and
// bidirectional masks, GQA by the head fold kv = bh / G, f32 scores and
// f32 softmax state (m, l, acc), output in q's dtype. Its plain PyTorch
// version is repro_torch/kernels/ref.py::attention_ref.
//
// Semantics kept from the TPU kernel, to the bit where it matters:
//   * the mask is the finite NEG_INF = -1e30, not -inf: a row whose first
//     visited kv tile is fully masked then averages that tile (p = 1)
//     and the next tile with a live key wipes it through corr = 0, as the
//     reference does; -inf would give exp(-inf - -inf) = NaN;
//   * the epilogue divides by max(l, 1e-30);
//   * kv tiles that no row of the q tile can see are skipped (the TPU
//     kernel's `need`): below the window of the tile's first row, above
//     the causal limit of its last row.
//
// Bound on an H100 (RecurrentGemma-2B prefill: 40 q heads of 1 kv head,
// S = 3072, hd = 256, window 2048, bf16): operations. The visible (q, k)
// pairs need ~0.17 TFLOP of QK and PV products, 0.17 ms at the 989
// TFLOP/s of the bf16 tensor cores, against 0.04 ms for the ~140 MB of
// q/k/v/o at 3.35 TB/s. This first kernel computes in f32 on the CUDA cores, as the
// TPU kernel computes in f32 (67 TFLOP/s peak, and its shared-memory
// operand loads keep it well below that): it is the simple, exact
// version; tensor cores (wgmma) and TMA are later work.
//
// Design: one block of 4 warps per (q head, 32-row q tile); a loop over
// 32-row kv tiles inside the block takes the place of the TPU grid's
// sequential kv axis. Each warp owns 8 q rows; lane j owns key j of the
// tile for the scores, so a row's max and sum are warp shuffles, and
// head-dim columns lane + 32 i of the accumulator. q, k and v tiles are
// staged in shared memory as f32 (k rows padded to an odd stride so the
// lanes' key reads hit distinct banks): 96 KB at hd = 256, above the
// 48 KB default, so the kernel opts in to more dynamic shared memory.
// Any hd up to 256 is taken; the wrapper refuses larger ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // q rows per warp
constexpr int kBQ = kWarps * kRows;       // q rows per block
constexpr int kBK = 32;                   // kv rows per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__host__ __device__ __forceinline__ int k_stride(int hd) {
  return (hd % 2 == 0) ? hd + 1 : hd;     // odd: lanes' rows in distinct banks
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kBQ * hd + (size_t)kBK * k_stride(hd)
                          + (size_t)kBK * hd);
}

// NI: accumulator columns per lane (hd <= 32 * NI).
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int hd, int g, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ks = k_stride(hd);
  float* q_s = smem;                      // kBQ x hd
  float* k_s = q_s + kBQ * hd;            // kBK x ks
  float* v_s = k_s + kBK * ks;            // kBK x hd

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qb = q + (int64_t)bh * sq * hd;
  const int64_t kv_off = (int64_t)(bh / g) * skv * hd;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd;
    const int qp = q0 + r;
    q_s[e] = qp < sq ? to_f32(qb[(int64_t)qp * hd + (e - r * hd)]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  // kv tiles some row of this q tile can see
  const int nk = (skv + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;       // first live key of the first row
    kt_begin = lo > 0 ? lo / kBK : 0;
  }
  int kt_end = nk;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;
    kt_end = min(nk, q_last / kBK + 1);
  }

  const float* q_w = q_s + warp * kRows * hd;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // the last tile is consumed
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int r = e / hd;
      const int c = e - r * hd;
      const bool in = k0 + r < skv;
      const int64_t gi = (int64_t)(k0 + r) * hd + c;
      k_s[r * ks + c] = in ? to_f32(kb[gi]) : 0.f;
      v_s[r * hd + c] = in ? to_f32(vb[gi]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* k_row = k_s + lane * ks;
    for (int d = 0; d < hd; ++d) {
      const float kd = k_row[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += q_w[r * hd + d] * kd;
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      bool live = kp < skv && qp < sq;
      if (causal) live = live && kp <= qp;
      if (window > 0) live = live && kp > qp - window;
      const float sr = live ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= corr;
    }

    for (int j = 0; j < kBK; ++j) {
      float vj[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c = lane + 32 * i;
        vj[i] = c < hd ? v_s[j * hd + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o_row = o + ((int64_t)bh * sq + qp) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) store(o_row + c, acc[r][i] * inv);
    }
  }
}

template <typename T, int NI>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int g, int sq, int skv, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  static bool configured[64] = {false};
  const size_t smem = smem_bytes(hd);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !configured[dev]) {
    // the largest hd this instantiation takes: one setting serves all
    err = cudaFuncSetAttribute(flash_kernel<T, NI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(32 * NI));
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)bh);
  flash_kernel<T, NI><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, hd, g, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int g, int sq, int skv, int hd, int causal, int window,
             float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                        scale, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                        scale, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                        scale, stream);
  return launch<T, 8>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                      stream);
}

}  // namespace

// q: (bh, sq, hd); k, v: (bhkv, skv, hd); o: (bh, sq, hd); all contiguous,
// on the current device, of one dtype (0 = float32, 1 = bfloat16); bh a
// multiple of bhkv; 1 <= hd <= 256. window <= 0 means no window. Launches
// on `stream`; returns the CUDA error of the launch (0 when accepted), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int bh, int bhkv, int sq,
                               int skv, int hd, int causal, int window,
                               float scale, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (bhkv <= 0 || bh % bhkv != 0 || hd < 1 || hd > 256 || skv < 0 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  const int g = bh / bhkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, g, sq, skv, hd, causal,
                                   window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
