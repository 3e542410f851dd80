"""G-GPU PE execute stage: the CUDA kernel and its wrapper.

``pe_execute`` is the port of ``repro.kernels.pe_simd.pe_execute`` (the
Pallas TPU kernel): one ALU operation per wavefront row. On a CUDA tensor
it launches ``csrc/pe_simd.cu`` on the current stream of the tensors'
device, or raises; on a CPU
tensor it runs the plain version ``engine.alu.select_alu``. ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.ggpu.engine.alu import select_alu
from repro_torch.kernels import _build

LAUNCHES = 0
ALL_OPS = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def ops_mask(ops_present) -> int:
    """``ops_present`` (a frozenset of opcodes, None = all) as the
    kernel's 32-bit opcode mask."""
    if ops_present is None:
        return ALL_OPS
    mask = 0
    for code in ops_present:
        if 0 <= code < 32:
            mask |= 1 << code
    return mask


@functools.cache
def _lib():
    lib = _build.load("pe_simd")
    lib.pe_execute.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    lib.pe_execute.restype = ctypes.c_int
    lib.pe_error_string.argtypes = [ctypes.c_int]
    lib.pe_error_string.restype = ctypes.c_char_p
    return lib


def _check(op, imm, a, b):
    for name, t in (("op", op), ("imm", imm), ("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"pe_execute: {name} must be int32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pe_execute: {name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"pe_execute: {name} is on {t.device}, "
                             f"a is on {a.device}")
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"pe_execute: a, b must be one (W, L) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if op.shape != (a.shape[0], 1) or imm.shape != (a.shape[0], 1):
        raise ValueError(f"pe_execute: op, imm must be ({a.shape[0]}, 1), "
                         f"got {tuple(op.shape)} and {tuple(imm.shape)}")


def pe_execute(op, imm, a, b, ops_present=None):
    """op, imm: (W, 1) int32; a, b: (W, L) int32 -> (W, L) int32 results.
    ``ops_present`` prunes opcodes as in ``select_alu``."""
    global LAUNCHES
    _check(op, imm, a, b)
    if a.device.type == "cpu":
        return select_alu(op, a, b, imm, ops_present)
    if a.device.type != "cuda":
        raise ValueError(f"pe_execute: no kernel for device {a.device}")
    out = torch.empty_like(a)
    W, L = a.shape
    mask = ops_mask(None if ops_present is None else frozenset(ops_present))
    with torch.cuda.device(a.device):      # launch on the tensors' card
        rc = _lib().pe_execute(
            op.data_ptr(), imm.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), W, L, mask,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("pe_execute launch failed: "
                           + _lib().pe_error_string(rc).decode())
    LAUNCHES += 1
    return out
