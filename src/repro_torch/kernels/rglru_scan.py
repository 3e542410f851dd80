"""RG-LRU diagonal linear recurrence: the CUDA kernel and its wrapper.

``rglru_scan`` is the port of ``repro.kernels.rglru_scan.rglru_scan`` (the
Pallas TPU kernel): h_t = a_t * h_{t-1} + b_t over (B, S, D), state in
f32. On CUDA tensors it launches ``csrc/rglru_scan.cu`` on the current
stream of the tensors' device, or raises; on CPU tensors it runs the plain
version ``ref.rglru_scan_ref``. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

LAUNCHES = 0


@functools.cache
def _lib():
    lib = _build.load("rglru_scan")
    lib.rglru_scan.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.rglru_scan.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b, h0):
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, a is "
                             f"on {a.device}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a, b must be one (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: h0 must be {(a.shape[0], a.shape[2])},"
                         f" got {tuple(h0.shape)}")


def rglru_scan(a, b, h0):
    """a, b: (B, S, D) f32; h0: (B, D) f32 -> (h (B, S, D), h_final)."""
    global LAUNCHES
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    batch, seq, dim = a.shape
    h = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        rc = _lib().rglru_scan(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_final.data_ptr(), batch, seq, dim,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + _lib().rglru_error_string(rc).decode())
    LAUNCHES += 1
    return h, h_final
