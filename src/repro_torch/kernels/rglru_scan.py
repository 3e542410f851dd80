"""RG-LRU diagonal linear recurrence: the CUDA kernel and its wrapper.

``rglru_scan`` is the port of ``repro.kernels.rglru_scan.rglru_scan`` (the
Pallas TPU kernel): h_t = a_t * h_{t-1} + b_t over (B, S, D), state in
f32. On CUDA tensors it launches ``csrc/rglru_scan.cu`` on the current
stream of the tensors' device, or raises; on CPU tensors it runs the plain
version ``ref.rglru_scan_ref``. The kernel has two routes, chosen by shape
and alignment (``scan_route``): "ring" (32 channels a block, S streamed
through a ring of shared-memory stages by the Tensor Memory Accelerator)
and "direct" (one thread per (batch, channel), loads straight from device
memory; any D or base). ``LAUNCHES`` counts kernel launches and
``ROUTE_LAUNCHES`` splits them by route. On ``meta`` tensors (the dry
run, ``launch.dryrun``) it launches nothing and returns the outputs'
shapes and dtypes. On meta and CUDA tensors it notes its bytes to any
active ``roofline.counter.StepCost``, which cannot see the launch: a, b
and h0 read, h and the final h written (no dot FLOPs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.roofline import counter

LAUNCHES = 0
ROUTES = ("ring", "direct")
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
_ENTRY = {"ring": "rglru_scan_ring", "direct": "rglru_scan_direct"}
_DESIGN_KEYS = ("tile", "steps", "stages", "smem_bytes", "blocks_per_sm",
                "registers", "spill_bytes")


@functools.cache
def _lib():
    lib = _build.load("rglru_scan")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rglru_ring_design.argtypes = [ctypes.c_void_p]
    lib.rglru_ring_design.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def scan_route(B: int, S: int, D: int, aligned: bool) -> str:
    """The kernel route for (B, S, D) inputs whose bases are 16-byte
    aligned (``aligned``, a and b): "ring" when D % 4 == 0 (a step's row a
    multiple of 16 bytes, as the tensor map needs), the bases are aligned
    and S > 0; "direct" otherwise."""
    return "ring" if D % 4 == 0 and aligned and S > 0 and D > 0 \
        else "direct"


def ring_design() -> dict:
    """The ring route as built on the current device: tile, steps per
    stage, stages, shared memory per block, blocks resident per SM,
    registers and spilled bytes per thread (``_DESIGN_KEYS``)."""
    out = (ctypes.c_int * len(_DESIGN_KEYS))()
    rc = _lib().rglru_ring_design(out)
    if rc != 0:
        raise RuntimeError("rglru_ring_design failed: "
                           + _lib().rglru_error_string(rc).decode())
    return dict(zip(_DESIGN_KEYS, out))


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


def _aligned(a, b) -> bool:
    return a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0


def rglru_scan(a, b, h0):
    """a, b: (B, S, D) f32; h0: (B, D) f32 -> (h (B, S, D), h_final)."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type == "meta":
        _note(a, h0)
        return torch.empty_like(a), torch.empty_like(h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    return _launch(scan_route(*a.shape, _aligned(a, b)), a, b, h0)


def _note(a, h0) -> None:
    counter.note("rglru_scan", 0, 3 * counter.nbytes(a)
                 + 2 * counter.nbytes(h0))


def _launch(path: str, a, b, h0):
    """Launch route ``path`` ("ring" or "direct") on CUDA tensors that
    ``_check`` passed and, for the ring, that ``scan_route`` sends
    there."""
    global LAUNCHES
    batch, seq, dim = a.shape
    h = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        rc = getattr(_lib(), _ENTRY[path])(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_final.data_ptr(), batch, seq, dim,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + _lib().rglru_error_string(rc).decode())
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    _note(a, h0)
    return h, h_final
