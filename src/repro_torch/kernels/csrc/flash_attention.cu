// Blocked online-softmax attention for Hopper (sm_90a), in two routes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): causal, sliding-window and
// bidirectional masks, GQA by the head fold kv = bh / G, f32 scores and
// f32 softmax state (m, l, acc), output in q's dtype. Its plain PyTorch
// version is repro_torch/kernels/ref.py::attention_ref.
//
// Semantics kept from the TPU kernel by both routes, to the bit where it
// matters:
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
// q/k/v/o at 3.35 TB/s.
//
// bf16 route (flash_mma_kernel): the tensor cores, FlashAttention-2 style.
// One block of 4 warps per (q head, 64-row q tile), each warp owning 16 q
// rows; a loop over kv tiles inside the block takes the place of the TPU
// grid's sequential kv axis. S = Q K^T and O += P V are
// mma.sync.m16n8k16 bf16 products with f32 accumulators, their operands
// read from shared memory by ldmatrix (ldmatrix.trans for V). q and k are
// bf16, so every product in Q K^T is exact and only the summation order
// differs from an f32 dot product. p enters P V as two bf16 terms, hi =
// bf16(p) and lo = bf16(p - hi), both summed into the same accumulator: p
// keeps ~16 bits for 1.5x the products of a single bf16 p. The online
// softmax runs in log2 units (scores prescaled by scale * log2(e), exp2);
// a row's max and sum are taken over the 4 lanes that share an MMA row.
// K and V tiles arrive by cp.async into a two-stage ring (rows past skv
// zero-filled), so tile n + 1 loads while tile n is computed; Q is loaded
// once and read again by ldmatrix for every kv tile, since at hd 256 the
// O accumulator alone takes 128 registers a thread. Rows are padded by 16
// bytes so the 8 rows of an ldmatrix phase fall on distinct banks. hd is
// padded with zero columns to HD = 64, 128 or 256 (zeros add nothing to
// Q K^T or P V). kv tile: 64 rows for HD <= 128 (85 KB of shared memory
// at HD 128: two blocks an SM), 32 rows at HD 256 (99 KB: two blocks an
// SM, where 64 rows would take 165 KB and leave one).
// What holds it below the tensor cores' rate: every warp reads all of K
// and V of a tile through ldmatrix, and Q again for every tile (shared
// memory bandwidth), mma.sync rather than wgmma, and the 1.5x products of
// the split p. wgmma with TMA-fed tiles and warp specialisation is later
// work.
//
// f32 route (flash_simt_kernel): f32 on the CUDA cores, as the TPU kernel
// computes, within 2e-5 of the plain version (TF32 tensor cores could not
// meet that). One block of 4 warps per (q head, 32-row q tile); each warp
// owns 8 q rows; lane j owns key j of a 32-key tile for the scores, so a
// row's max and sum are warp shuffles, and head-dim columns lane + 32 i of
// the accumulator. q, k and v tiles are staged in shared memory (k rows
// padded to an odd stride so the lanes' key reads hit distinct banks):
// 96 KB at hd = 256. Bound by its shared-memory operand loads (9 loads
// per 8 FMAs in the score loop), far below the f32 peak; it runs the
// reference's f32 cases, not the serving path.
//
// Both routes take any hd up to 256; the wrapper refuses larger ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// -- f32 route: SIMT --------------------------------------------------------

namespace simt {

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // q rows per warp
constexpr int kBQ = kWarps * kRows;       // q rows per block
constexpr int kBK = 32;                   // kv rows per tile, one per lane
constexpr int kThreads = kWarps * 32;

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
template <int NI>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int skv, int hd, int g, int causal, int window,
                  float scale) {
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
  const float* qb = q + (int64_t)bh * sq * hd;
  const int64_t kv_off = (int64_t)(bh / g) * skv * hd;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd;
    const int qp = q0 + r;
    q_s[e] = qp < sq ? qb[(int64_t)qp * hd + (e - r * hd)] : 0.f;
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
      k_s[r * ks + c] = in ? kb[gi] : 0.f;
      v_s[r * hd + c] = in ? vb[gi] : 0.f;
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
    float* o_row = o + ((int64_t)bh * sq + qp) * hd;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) o_row[c] = acc[r][i] * inv;
    }
  }
}

template <int NI>
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
    err = cudaFuncSetAttribute(flash_simt_kernel<NI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(32 * NI));
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)bh);
  flash_simt_kernel<NI><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv,
      hd, g, causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int g, int sq, int skv, int hd, int causal, int window,
             float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<1>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                     stream);
  if (hd <= 64)
    return launch<2>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                     stream);
  if (hd <= 128)
    return launch<4>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                     stream);
  return launch<8>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                   stream);
}

}  // namespace simt

// -- bf16 route: tensor cores -----------------------------------------------

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;          // q rows per block, 16 per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// HD: hd padded to 64, 128 or 256.
template <int HD>
struct Cfg {
  static constexpr int kBK = HD > 128 ? 32 : 64;     // kv rows per tile
  static constexpr int kStride = HD + 8;             // row pitch in bf16
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(kBQ + 2 * kStages * kBK) * kStride;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; only the first `bytes` (16 or 0) are read,
// the rest of the 16 are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) as two bf16 pairs with x = hi.x + lo.x, y = hi.y + lo.y to ~16
// bits; x - bf16(x) is exact in f32
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Rows [row0, row0 + ROWS) of a (rows, hd) bf16 matrix into a ROWS x
// kStride tile of shared memory; rows at or past `limit` and columns past
// hd (up to HD) as zeros. vec: 16-byte cp.async (hd % 8 == 0 and 16-byte
// aligned bases), else plain loads and stores.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int limit, int hd,
                                          bool vec) {
  constexpr int kStride = Cfg<HD>::kStride;
  if (vec) {
    constexpr int kChunks = HD / 8;       // 16-byte chunks per row
    constexpr int kRowStep = kThreads / kChunks;   // rows per pass
    static_assert(kThreads % kChunks == 0 && ROWS % kRowStep == 0,
                  "whole rows, whole passes");
    const int r0 = threadIdx.x / kChunks;
    const int col = (threadIdx.x % kChunks) * 8;
    const bf16* from = src + (int64_t)(row0 + r0) * hd + col;
    const uint32_t to = smem_u32(dst + r0 * kStride + col);
#pragma unroll
    for (int i = 0; i < ROWS / kRowStep; ++i) {
      const bool in = row0 + r0 + i * kRowStep < limit && col < hd;
      cp_async16(to + i * kRowStep * kStride * sizeof(bf16),
                 in ? from + (int64_t)i * kRowStep * hd : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
      const int r = e / HD;
      const int col = e - r * HD;
      dst[r * kStride + col] = (row0 + r < limit && col < hd)
                                   ? src[(int64_t)(row0 + r) * hd + col]
                                   : __float2bfloat16(0.f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                 int skv, int hd, int g, int causal, int window,
                 float scale_log2, int vec) {
  constexpr int BK = Cfg<HD>::kBK;
  constexpr int ST = Cfg<HD>::kStride;
  constexpr int NS = BK / 8;              // S fragments (8 keys each)
  constexpr int NO = HD / 8;              // O fragments (8 columns each)
  constexpr uint32_t kTileBytes = BK * ST * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // kBQ x ST
  bf16* k_s = q_s + kBQ * ST;                        // kStages x BK x ST
  bf16* v_s = k_s + kStages * BK * ST;               // kStages x BK x ST

  const int bh = blockIdx.y;
  // q tiles from the last: under a causal mask they see the most keys, so
  // the short first tiles fill the grid's last wave
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bf16* qb = q + (int64_t)bh * sq * hd;
  const int64_t kv_off = (int64_t)(bh / g) * skv * hd;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  // kv tiles some row of this q tile can see (the f32 route's rule)
  const int nk = (skv + BK - 1) / BK;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;       // first live key of the first row
    kt_begin = lo > 0 ? lo / BK : 0;
  }
  int kt_end = nk;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;
    kt_end = min(nk, q_last / BK + 1);
  }

  load_tile<HD, kBQ>(q_s, qb, q0, sq, hd, vec);
  if (kt_begin < kt_end) {
    load_tile<HD, BK>(k_s, kb, kt_begin * BK, skv, hd, vec);
    load_tile<HD, BK>(v_s, vb, kt_begin * BK, skv, hd, vec);
  }
  cp_async_commit();

  // this lane's accumulator rows: row0 (c0, c1) and row0 + 8 (c2, c3)
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float acc[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this lane's share of the row sum

  // ldmatrix row addresses. Q (A operand, x4 = one 16 x 16 fragment):
  // lanes 0-15 rows 0-15 at column 0, lanes 16-31 at column 8. K (B of
  // Q K^T, x4 = two 8-key fragments): lanes 0-7 keys 0-7 at column 0,
  // 8-15 keys 0-7 at 8, 16-23 keys 8-15 at 0, 24-31 keys 8-15 at 8. V (B
  // of P V, transposed, x4 = two 8-column fragments): lanes 0-7 keys 0-7
  // at column 0, 8-15 keys 8-15 at 0, 16-23 keys 0-7 at 8, 24-31 keys
  // 8-15 at 8.
  const uint32_t q_addr =
      smem_u32(q_s + (warp * 16 + (lane & 15)) * ST + (lane >> 4) * 8);
  const uint32_t k_addr0 = smem_u32(
      k_s + ((lane & 7) + ((lane >> 4) << 3)) * ST + ((lane >> 3) & 1) * 8);
  const uint32_t v_addr0 = smem_u32(
      v_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ST + (lane >> 4) * 8);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {                // the next tile loads meanwhile
      const int nxt = (stage ^ 1) * BK * ST;
      load_tile<HD, BK>(k_s + nxt, kb, (kt + 1) * BK, skv, hd, vec);
      load_tile<HD, BK>(v_s + nxt, vb, (kt + 1) * BK, skv, hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                      // tile kt is in shared memory

    // S = Q K^T (16 x BK per warp), f32
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t k_addr = k_addr0 + stage * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, k_addr + np * 16 * ST * sizeof(bf16) + kk * 32);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale into log2 units; mask where the tile crosses an edge
    const int k0 = kt * BK;
    const bool edge = k0 + BK > skv || q0 + kBQ > sq ||
                      (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int qp = row0 + (e >> 1) * 8;
          const int kp = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          bool live = kp < skv && qp < sq;
          if (causal) live = live && kp <= qp;
          if (window > 0) live = live && kp > qp - window;
          if (!live) x = kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax, two rows per lane, reduced over the row's 4 lanes
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      corr[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f(s[n][2 * i + j] - mx);
          s[n][2 * i + j] = p;
          sum += p;
        }
      }
      l[i] = l[i] * corr[i] + sum;
    }
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }

    // O += P V, p as hi + lo: the S fragments of keys 16j..16j+15 are the
    // A fragment of the j-th k step
    const uint32_t v_addr = v_addr0 + stage * kTileBytes;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_pair(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
      split_pair(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
      split_pair(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
      split_pair(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_addr + j * 16 * ST * sizeof(bf16) + dp * 32);
        mma_bf16(acc[2 * dp], hi, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();                      // stage is free for tile kt + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  const bool pairs = (hd & 1) == 0;       // bf16x2 stores stay aligned
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* o_row = o + ((int64_t)bh * sq + qp) * hd;
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      const int c = t * 8 + (lane & 3) * 2;
      const float x = acc[t][2 * i] / den;
      const float y = acc[t][2 * i + 1] / den;
      if (pairs && c + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + c) =
            __floats2bfloat162_rn(x, y);
      } else {
        if (c < hd) o_row[c] = __float2bfloat16(x);
        if (c + 1 < hd) o_row[c + 1] = __float2bfloat16(y);
      }
    }
  }
}

template <int HD>
cudaError_t configure() {
  static bool configured[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_mma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cfg<HD>::kSmem);
  if (err == cudaSuccess && dev >= 0 && dev < 64) configured[dev] = true;
  return err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int g, int sq, int skv, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return (int)err;
  const int vec = hd % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) == 0;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)bh);
  flash_mma_kernel<HD><<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, sq, skv, hd,
      g, causal, window, scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int g, int sq, int skv, int hd, int causal, int window,
             float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<64>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                      stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                       scale, stream);
  return launch<256>(q, k, v, o, bh, g, sq, skv, hd, causal, window, scale,
                     stream);
}

template <int HD>
int describe(int* out) {
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_mma_kernel<HD>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_mma_kernel<HD>, kThreads, Cfg<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = HD;
  out[1] = kBQ;
  out[2] = Cfg<HD>::kBK;
  out[3] = kStages;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = (int)Cfg<HD>::kSmem;
  out[7] = blocks;
  return 0;
}

}  // namespace mma

}  // namespace

// q: (bh, sq, hd); k, v: (bhkv, skv, hd); o: (bh, sq, hd); all contiguous,
// on the current device, of one dtype: 0 = float32 (the SIMT route), 1 =
// bfloat16 (the tensor-core route); bh a multiple of bhkv; 1 <= hd <= 256.
// window <= 0 means no window. Launches on `stream`; returns the CUDA
// error of the launch (0 when accepted), or cudaErrorInvalidValue for
// arguments the kernel does not take.
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
    return simt::dispatch(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                          scale, s);
  if (dtype == 1)
    return mma::dispatch(q, k, v, o, bh, g, sq, skv, hd, causal, window,
                         scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route's design for head width hd (1 <= hd <= 256), as
// built: out[0..7] = padded hd, q rows per block, kv rows per tile, K/V
// stages, registers per thread, local (spilled) bytes per thread, dynamic
// shared memory bytes per block, blocks resident per SM. Returns a CUDA
// error code (0 on success).
extern "C" int flash_mma_design(int hd, int* out) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return mma::describe<64>(out);
  if (hd <= 128) return mma::describe<128>(out);
  return mma::describe<256>(out);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
