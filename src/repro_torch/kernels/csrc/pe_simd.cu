// G-GPU PE execute stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pe_simd.py::pe_execute
// (body _pe_kernel): one ALU operation per wavefront row, selected by the
// row's opcode from the 22 int32 cases of the ISA; every other opcode
// (HALT, LW/SW, branches, TID/NITEMS/WGID) gives 0. Its plain PyTorch
// version is repro_torch/ggpu/engine/alu.py::select_alu.
//
// Bound on an H100: memory. Each lane reads a and b and writes out (12
// bytes) and each row reads op and imm (8 bytes), with a few integer
// operations per lane. At the largest shape the simulator gives it (W=1024
// wavefronts of L=64 lanes, vec_mul on one CU) that is 786 KB, about
// 0.23 us at 3.35 TB/s: far below the latency of one launch, so the
// stage is launch-bound, not bandwidth-bound.
//
// Design: one thread per (row, lane) element over a grid-stride loop, the
// row's opcode and immediate read per element (they sit in L1 after the
// first lane of the row). It works unchanged for L = 64 (G-GPU) and for
// L = 1, W = 1 (the scalar baseline). The simple design comes first; its
// speed is later work (the round around it is what costs, see PERF.md).
//
// The int32 semantics are written out with no undefined behaviour:
//   ADD/SUB/MUL/SLL/SLLI/LUI wrap through uint32_t; SRA/SRAI are
//   arithmetic on int32_t; SRL/SRLI are logical on uint32_t; shift amounts
//   are clipped to [0, 31]; MULH is __mulhi; DIV/REM are floor ops with
//   x / 0 -> 0, INT_MIN / -1 -> INT_MIN and INT_MIN % -1 -> 0.
// ops_mask is the set of opcodes the program uses, as a bitmask: a pruned
// opcode gives 0, as select_alu(ops_present=...) does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
  ADD = 1, SUB, MUL, MULH, DIV, REM, AND, OR, XOR, SLL, SRL, SRA, SLT,
  ADDI, ANDI, ORI, XORI, SLLI, SRLI, SRAI, SLTI, LUI
};

__device__ __forceinline__ int clip_shift(int32_t s) {
  return s < 0 ? 0 : (s > 31 ? 31 : s);
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return (int32_t)(0u - (uint32_t)a);  // INT_MIN / -1 wraps
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

__device__ __forceinline__ int32_t floor_rem(int32_t a, int32_t b) {
  if (b == 0 || b == -1) return 0;
  int32_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ int32_t alu(int op, int32_t a, int32_t b,
                                       int32_t imm, uint32_t ops_mask) {
  if (op < 0 || op > 31 || !((ops_mask >> op) & 1u)) return 0;
  const uint32_t ua = (uint32_t)a, ub = (uint32_t)b, ui = (uint32_t)imm;
  switch (op) {
    case ADD:  return (int32_t)(ua + ub);
    case SUB:  return (int32_t)(ua - ub);
    case MUL:  return (int32_t)(ua * ub);
    case MULH: return __mulhi(a, b);
    case DIV:  return floor_div(a, b);
    case REM:  return floor_rem(a, b);
    case AND:  return a & b;
    case OR:   return a | b;
    case XOR:  return a ^ b;
    case SLL:  return (int32_t)(ua << clip_shift(b));
    case SRL:  return (int32_t)(ua >> clip_shift(b));
    case SRA:  return a >> clip_shift(b);
    case SLT:  return a < b ? 1 : 0;
    case ADDI: return (int32_t)(ua + ui);
    case ANDI: return a & imm;
    case ORI:  return a | imm;
    case XORI: return a ^ imm;
    case SLLI: return (int32_t)(ua << clip_shift(imm));
    case SRLI: return (int32_t)(ua >> clip_shift(imm));
    case SRAI: return a >> clip_shift(imm);
    case SLTI: return a < imm ? 1 : 0;
    case LUI:  return (int32_t)(ui << 12);
    default:   return 0;
  }
}

__global__ void pe_execute_kernel(const int32_t* __restrict__ op,
                                  const int32_t* __restrict__ imm,
                                  const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b,
                                  int32_t* __restrict__ out,
                                  int64_t n, int L, uint32_t ops_mask) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t row = i / L;
    out[i] = alu(op[row], a[i], b[i], imm[row], ops_mask);
  }
}

// Streaming multiprocessors of the current device, read once per device.
int sm_count(int* count) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) {
    return (int)cudaDeviceGetAttribute(count,
                                       cudaDevAttrMultiProcessorCount, dev);
  }
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *count = cached[dev];
  return 0;
}

}  // namespace

// Launches on `stream` of the current device; returns the CUDA error of
// the launch (0 when it was accepted). op, imm: (W, 1); a, b, out: (W, L);
// all int32, contiguous, on the current device.
extern "C" int pe_execute(const void* op, const void* imm, const void* a,
                          const void* b, void* out, int W, int L,
                          unsigned int ops_mask, void* stream) {
  const int64_t n = (int64_t)W * L;
  if (n <= 0) return 0;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)sms * 16) blocks = (int64_t)sms * 16;  // 16 per SM
  pe_execute_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)op, (const int32_t*)imm, (const int32_t*)a,
      (const int32_t*)b, (int32_t*)out, n, L, ops_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* pe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
