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
// prefill (B = 4, S = 3072, D = 2560) that is 377 MB, 0.11 ms at 3.35 TB/s.
//
// Design: one thread per (batch, channel), neighbouring threads on
// neighbouring channels, so each step's loads and stores coalesce; the
// loop over S takes the place of the TPU kernel's in-body chunk loop. The
// steps of a chunk of 8 are loaded before any is used, so 16 loads are in
// flight per thread instead of 2. The reference pads S to its chunk with
// a = 1, b = 0; the loop here pads the last chunk the same way (1 * h + 0
// is h exactly) and stores only real steps.
// Known limit: B * D threads is all the parallelism (10,240 at the shape
// above, ~78 per SM), too few to cover the loads' latency, so the kernel
// runs well above its byte bound. Splitting S with a carry pass is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;
constexpr int kThreads = 64;      // small blocks spread B * D over the SMs

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ h,
             float* __restrict__ h_final, int batch, int seq, int dim) {
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
      hv = av[u] * hv + bv[u];
      const int s = s0 + u;
      if (s < seq) h[base + (int64_t)s * dim] = hv;
    }
  }
  h_final[idx] = hv;
}

}  // namespace

// a, b, h: (batch, seq, dim); h0, h_final: (batch, dim); float32,
// contiguous, on the current device. Launches on `stream`; returns the
// CUDA error of the launch (0 when accepted).
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* h, void* h_final, int batch, int seq,
                          int dim, void* stream) {
  const int64_t n = (int64_t)batch * dim;
  if (n <= 0) return 0;
  if (batch < 0 || seq < 0 || dim < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  rglru_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h,
      (float*)h_final, batch, seq, dim);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
