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
// operations per lane. At the largest single launch of the simulator's
// main path (W=1024 wavefronts of L=64 lanes, vec_mul on one CU) that is
// 795 KB, about 0.24 us at 3.35 TB/s: below what one launch costs, so the
// launch, not the body, sets the floor. chip_smoke.py measures that floor
// with pe_empty_kernel (the same arguments and grid, no body) and reports
// it beside the kernel's time and its bound. Above the floor, what a
// launch costs is the latency of its slowest thread: its loads, then the
// longest case of the ALU (DIV/REM, a software division) on its lanes,
// then its store.
//
// One kernel for every shape: one lane a thread, exactly W * L threads in
// blocks of 256 (4 wavefronts at L = 64), no grid-stride loop, 32-bit
// index arithmetic (the wrapper holds W * L < 2^31) and 4-byte accesses,
// so no base needs more than int32 alignment. The row is a compile-time
// shift at the G-GPU's L = 64 and a division by the runtime L otherwise
// (the scalar baseline's 1 x 1, any other L). Where 32 divides L a warp
// covers 32 lanes of one row, so the opcode, the immediate and the switch
// are warp-uniform: no warp runs two cases of the ALU, and each thread
// runs the longest case once. (Four lanes a thread with 16-byte loads was
// tried first and measured slower on the card: a quarter of the threads,
// each running its case four times, two rows per warp. The first design,
// one thread per element over a grid-stride loop with 64-bit counters,
// was slower too at every L = 64 shape; PERF.md keeps both times.)
//
// The int32 semantics are written out with no undefined behaviour (alu):
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

constexpr int kThreads = 256;

// kL > 0: rows of kL lanes known at compile time; kL == 0: rows of L.
template <int kL>
__global__ void __launch_bounds__(kThreads)
pe_execute_kernel(const int32_t* __restrict__ op,
                  const int32_t* __restrict__ imm,
                  const int32_t* __restrict__ a,
                  const int32_t* __restrict__ b, int32_t* __restrict__ out,
                  uint32_t n, uint32_t L, uint32_t ops_mask) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t row;
  if constexpr (kL > 0) {
    row = i / kL;                        // a shift at kL = 64
  } else {
    row = i / L;
  }
  out[i] = alu(op[row], a[i], b[i], imm[row], ops_mask);
}

// The launch floor: pe_execute's arguments, no body.
__global__ void pe_empty_kernel(const int32_t*, const int32_t*,
                                const int32_t*, const int32_t*, int32_t*,
                                uint32_t, uint32_t, uint32_t) {}

// W * L elements as the kernel's 32-bit count, or false if there are none
// or too many.
bool elements(int W, int L, uint32_t* n) {
  const int64_t total = (int64_t)W * L;
  if (W < 0 || L < 0 || total >= (1ll << 31)) return false;
  *n = (uint32_t)total;
  return true;
}

}  // namespace

// op, imm: (W, 1); a, b, out: (W, L); all int32, contiguous, on the current
// device. Launches on `stream` and returns the CUDA error of the launch (0
// when it was accepted); refuses (cudaErrorInvalidValue) W * L >= 2^31.
extern "C" int pe_execute(const void* op, const void* imm, const void* a,
                          const void* b, void* out, int W, int L,
                          unsigned int ops_mask, void* stream) {
  uint32_t n = 0;
  if (!elements(W, L, &n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (L == 64) {
    pe_execute_kernel<64><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)op, (const int32_t*)imm, (const int32_t*)a,
        (const int32_t*)b, (int32_t*)out, n, L, ops_mask);
  } else {
    pe_execute_kernel<0><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)op, (const int32_t*)imm, (const int32_t*)a,
        (const int32_t*)b, (int32_t*)out, n, L, ops_mask);
  }
  return (int)cudaGetLastError();
}

// pe_empty_kernel with the grid and arguments pe_execute launches for these
// inputs: what a launch costs with no body.
extern "C" int pe_launch_floor(const void* op, const void* imm, const void* a,
                               const void* b, void* out, int W, int L,
                               unsigned int ops_mask, void* stream) {
  uint32_t n = 0;
  if (!elements(W, L, &n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  pe_empty_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int32_t*)op, (const int32_t*)imm, (const int32_t*)a,
      (const int32_t*)b, (int32_t*)out, n, L, ops_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* pe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
