// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::rglru_scan
// (body _rglru_kernel): h_t = a_t * h_{t-1} + b_t elementwise over the
// channels, sequential over S, h carried in f32; returns every h_t and the
// final state. Its plain PyTorch version is
// repro_torch/kernels/ref.py::rglru_scan_ref.
//
// Bound on an H100: bytes. Each step reads a and b and writes h, 12 bytes
// per (batch, step, channel) and one multiply-add: at RecurrentGemma-2B's
// prefill (B = 4, S = 3072, D = 2560) that is 377 MB, 0.113 ms at
// 3.35 TB/s. The recurrence is sequential per channel, so the card can
// only be kept busy by having many loads in flight: at ~0.7 us of memory
// latency, 3.35 TB/s needs ~2.3 MB in flight, ~18 KB per SM.
//
// Two routes, chosen by the wrapper (kernels/rglru_scan.py scan_route)
// from shape and alignment alone, and counted apart:
//
//  * ring (D % 4 == 0, a and b 16-byte aligned, S > 0): one block of one
//    warp owns 32 channels of one batch row, so one step of its tile is
//    128 contiguous bytes. The tile streams through a ring of kStages
//    stages in shared memory, each kSteps steps of a and of b, copied by
//    the Tensor Memory Accelerator: one 3-D tensor map per input over
//    (D, S, B) with a (32, kSteps, 1) box, completing on one mbarrier per
//    stage with its byte count. Lane 0 is the producer: it fills the ring
//    at the start and refills a stage as soon as the warp has walked it,
//    so kStages - 1 stages (12 KB of a and b) are in flight per block,
//    2-3 blocks per SM at the path's shape: 24-36 KB per SM against the
//    ~18 KB the latency asks for. (A first ring of 4 stages of 64 steps,
//    64 KB of shared memory a block, ran 1.3x slower on the card at the
//    path's prefill shape than these 16-step stages, 16 KB a block; the
//    times are in PERF.md.) The 32 lanes walk an arrived stage step by
//    step with h = fmaf(a, h, b), the order of the first design and of
//    rglru_scan_ref, and store h straight to device memory, one coalesced
//    128-byte row per step. A ragged channel tile (D = 40) and a ragged
//    last stage read zeros that the tensor map fills past the edges; no
//    lane stores past D and the walk stops at S, so no padded byte is
//    read from or written to device memory (the reference pads with a = 1,
//    b = 0, which leaves h as it is: the same result).
//  * direct (every other shape or base): the first design, kept as it
//    was: one thread per (batch, channel) walks S, neighbouring threads on
//    neighbouring channels so each step's loads and stores coalesce, the
//    8 steps of a chunk loaded before any is used (16 loads in flight per
//    thread). It needs no alignment; with only B * D threads it runs well
//    above the byte bound.
//
// The tensor-map encoder is a CUDA driver API function; it is looked up
// at run time through cudaGetDriverEntryPoint, so the library links
// nothing beyond the CUDA runtime.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- the direct route -------------------------------------------------------

constexpr int kChunk = 8;
constexpr int kThreads = 64;      // small blocks spread B * D over the SMs

__global__ void __launch_bounds__(kThreads)
rglru_direct_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ h0, float* __restrict__ h,
                    float* __restrict__ h_final, int batch, int seq,
                    int dim) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)batch * dim) return;
  const int64_t bi = idx / dim;
  const int64_t base = bi * seq * dim + (idx - bi * dim);
  float hv = h0[idx];
  for (int s0 = 0; s0 < seq; s0 += kChunk) {
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int s = s0 + u;
      const int64_t at = base + (int64_t)s * dim;
      av[u] = s < seq ? a[at] : 1.f;
      bv[u] = s < seq ? b[at] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      const int s = s0 + u;
      if (s < seq) h[base + (int64_t)s * dim] = hv;
    }
  }
  h_final[idx] = hv;
}

// -- the ring route ---------------------------------------------------------

constexpr int kTile = 32;                          // channels per block
constexpr int kSteps = 16;                         // steps per stage
constexpr int kStages = 4;                         // stages in the ring
constexpr int kStageFloats = kTile * kSteps;       // one input, one stage
constexpr int kStageBytes = kStageFloats * 4;      // 2 KB
constexpr int kRingSmem = 2 * kStages * kStageBytes + kStages * 8;
static_assert(kRingSmem <= 48 * 1024,
              "above 48 KB the launch must opt in to more shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Lane 0: ask for stage k of the block's tile (steps k * kSteps onward) of
// both inputs into ring slot k % kStages.
__device__ __forceinline__ void fill_stage(const CUtensorMap* map_a,
                                           const CUtensorMap* map_b,
                                           float* sa, float* sb,
                                           uint64_t* full, int k, int d0,
                                           int bi) {
  const int slot = k % kStages;
  const uint32_t bar = smem_addr(&full[slot]);
  const int s0 = k * kSteps;
  // the warp's reads of this slot (generic proxy) come before the copy's
  // writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(2 * kStageBytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(sa + slot * kStageFloats)),
         "l"(reinterpret_cast<uint64_t>(map_a)), "r"(bar),
         "r"(d0), "r"(s0), "r"(bi) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(sb + slot * kStageFloats)),
         "l"(reinterpret_cast<uint64_t>(map_b)), "r"(bar),
         "r"(d0), "r"(s0), "r"(bi) : "memory");
}

__global__ void __launch_bounds__(kTile)
rglru_ring_kernel(__grid_constant__ const CUtensorMap map_a,
                  __grid_constant__ const CUtensorMap map_b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_final, int seq, int dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);   // [kStages][kSteps][kTile]
  float* sb = sa + kStages * kStageFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kStageFloats);
  const int lane = threadIdx.x;
  const int tiles = (dim + kTile - 1) / kTile;
  const int bi = blockIdx.x / tiles;
  const int d0 = (blockIdx.x - bi * tiles) * kTile;
  const int d = d0 + lane;
  const bool live = d < dim;
  const int n_stages = (seq + kSteps - 1) / kSteps;
  if (lane == 0) {
    for (int i = 0; i < kStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&full[i])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kStages && k < n_stages; ++k) {
      fill_stage(&map_a, &map_b, sa, sb, full, k, d0, bi);
    }
  }
  __syncwarp();
  float hv = live ? h0[(int64_t)bi * dim + d] : 0.f;
  float* hp = h + (int64_t)bi * seq * dim + d;
  for (int k = 0; k < n_stages; ++k) {
    const int slot = k % kStages;
    mbar_wait(smem_addr(&full[slot]), (uint32_t)(k / kStages) & 1u);
    const float* pa = sa + slot * kStageFloats + lane;
    const float* pb = sb + slot * kStageFloats + lane;
    const int s0 = k * kSteps;
    const int n = min(kSteps, seq - s0);
    float* hs = hp + (int64_t)s0 * dim;
    if (n == kSteps) {
#pragma unroll 16
      for (int u = 0; u < kSteps; ++u) {
        hv = fmaf(pa[u * kTile], hv, pb[u * kTile]);
        if (live) hs[(int64_t)u * dim] = hv;
      }
    } else {
      for (int u = 0; u < n; ++u) {
        hv = fmaf(pa[u * kTile], hv, pb[u * kTile]);
        if (live) hs[(int64_t)u * dim] = hv;
      }
    }
    __syncwarp();                    // every lane is done with this slot
    if (lane == 0 && k + kStages < n_stages) {
      fill_stage(&map_a, &map_b, sa, sb, full, k + kStages, d0, bi);
    }
  }
  if (live) h_final[(int64_t)bi * dim + d] = hv;
}

// cuTensorMapEncodeTiled (CUDA driver API), looked up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes of this library above the CUDA runtime's: a driver CUresult
// from the encoder is returned as kDriverError + CUresult.
constexpr int kDriverError = 100000;

int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return (int)cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A 3-D map over a (batch, seq, dim) f32 array, innermost first, with the
// ring's (kTile, kSteps, 1) box; zeros past every edge.
int encode(CUtensorMap* map, const void* base, int batch, int seq, int dim) {
  EncodeTiled fn = nullptr;
  const int rc = encoder(&fn);
  if (rc != 0) return rc;
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)dim * 4,
                                 (cuuint64_t)dim * seq * 4};
  const cuuint32_t box[3] = {kTile, kSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                          const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kDriverError + (int)res;
}

}  // namespace

// a, b, h: (batch, seq, dim); h0, h_final: (batch, dim); float32,
// contiguous, on the current device. Each launches on `stream` and returns
// the CUDA error of the launch (0 when accepted). The ring route refuses
// (cudaErrorInvalidValue) what it does not take: dim % 4 != 0, a or b not
// 16-byte aligned, seq == 0.
extern "C" int rglru_scan_direct(const void* a, const void* b, const void* h0,
                                 void* h, void* h_final, int batch, int seq,
                                 int dim, void* stream) {
  if (batch < 0 || seq < 0 || dim < 0) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)batch * dim;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  rglru_direct_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h,
      (float*)h_final, batch, seq, dim);
  return (int)cudaGetLastError();
}

extern "C" int rglru_scan_ring(const void* a, const void* b, const void* h0,
                               void* h, void* h_final, int batch, int seq,
                               int dim, void* stream) {
  if (batch < 0 || seq <= 0 || dim <= 0 || dim % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(a) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(b) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return 0;
  CUtensorMap map_a, map_b;
  int rc = encode(&map_a, a, batch, seq, dim);
  if (rc == 0) rc = encode(&map_b, b, batch, seq, dim);
  if (rc != 0) return rc;
  const int64_t blocks = (int64_t)batch * ((dim + kTile - 1) / kTile);
  rglru_ring_kernel<<<(unsigned)blocks, kTile, kRingSmem,
                      (cudaStream_t)stream>>>(
      map_a, map_b, (const float*)h0, (float*)h, (float*)h_final, seq, dim);
  return (int)cudaGetLastError();
}

// The ring route as built on the current device: out[0..6] = channels per
// block, steps per stage, stages, shared memory bytes per block, blocks
// resident per SM, registers per thread, local (spilled) bytes per thread.
extern "C" int rglru_ring_design(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rglru_ring_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_ring_kernel, kTile, kRingSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = kTile;
  out[1] = kSteps;
  out[2] = kStages;
  out[3] = kRingSmem;
  out[4] = per_sm;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* rglru_error_string(int code) {
  if (code >= kDriverError) return "cuTensorMapEncodeTiled refused the map";
  return cudaGetErrorString((cudaError_t)code);
}
