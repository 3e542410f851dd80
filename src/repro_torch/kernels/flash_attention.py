"""Blocked online-softmax attention: the CUDA kernel and its wrapper.

``flash_attention`` is the port of ``repro.kernels.flash_attention.
flash_attention`` (the Pallas TPU kernel), in its layout: q (BH, Sq, hd),
k and v (BHkv, Skv, hd) with BH = BHkv * G, q head ``bh`` reading kv head
``bh // G``. On CUDA tensors it launches ``csrc/flash_attention.cu`` on
the current stream of the tensors' device, or raises; on CPU tensors it
runs the plain version ``ref.attention_ref``. The kernel has two routes
(``route``): bf16 runs on the tensor cores (``flash_mma_kernel``), f32 on
the CUDA cores (``flash_simt_kernel``). ``LAUNCHES`` counts kernel
launches and ``ROUTE_LAUNCHES`` splits them by route, so a run can show
that it went through the kernel and which one. On ``meta`` tensors (the
dry run, ``launch.dryrun``) it launches nothing and returns the output's
shape and dtype. On meta and CUDA tensors it notes its work to any
active ``roofline.counter.StepCost``, which cannot see the launch: 4 *
hd FLOPs per visible (q, k) pair of each head (``visible_pairs``), and
q, k, v read and the output written.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref
from repro_torch.roofline import counter

LAUNCHES = 0
MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "simt"}
ROUTE_LAUNCHES = dict.fromkeys(ROUTES.values(), 0)
_DESIGN_KEYS = ("hd_pad", "block_q", "block_k", "stages", "registers",
                "spill_bytes", "smem_bytes", "blocks_per_sm")


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_mma_design.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.flash_mma_design.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def route(dtype, hd: int) -> str:
    """The kernel route a CUDA tensor of ``dtype`` and head width ``hd``
    takes, as ``csrc/flash_attention.cu`` dispatches it: "tensor_core"
    for bf16, "simt" for f32. Raises for what no route takes."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_attention: the kernel takes hd <= {MAX_HD}, "
                         f"got {hd}")
    return ROUTES[dtype]


def tensor_core_tiles(hd: int) -> tuple:
    """(padded hd, q rows per block, kv rows per tile) of the tensor-core
    route for head width ``hd``, as ``flash_mma_kernel`` is instantiated:
    hd padded to 64, 128 or 256; kv tiles of 64 rows, 32 at 256."""
    hd_pad = next(w for w in (64, 128, 256) if hd <= w)
    return hd_pad, 64, 32 if hd_pad > 128 else 64


def tensor_core_design(hd: int) -> dict:
    """The tensor-core route's design as built on the current device:
    tiles, K/V stages, registers and spilled bytes per thread, shared
    memory per block, blocks resident per SM (``_DESIGN_KEYS``)."""
    out = (ctypes.c_int * len(_DESIGN_KEYS))()
    rc = _lib().flash_mma_design(int(hd), out)
    if rc != 0:
        raise RuntimeError("flash_mma_design failed: "
                           + _lib().flash_error_string(rc).decode())
    return dict(zip(_DESIGN_KEYS, out))


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps, per head: the work attention needs."""
    q = np.arange(sq, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    hi = np.minimum(q, skv - 1) if causal else np.full_like(q, skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} must be float32 or "
                            f"bfloat16 like q, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be 3-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q is on {q.device}")
    bh, _, hd = q.shape
    bhkv = k.shape[0]
    if v.shape != k.shape or k.shape[2] != hd:
        raise ValueError(f"flash_attention: k, v must be (BHkv, Skv, {hd}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if bhkv == 0 or bh % bhkv:
        raise ValueError(f"flash_attention: {bh} q heads do not fold onto "
                         f"{bhkv} kv heads")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float = 0.0):
    """q: (BH, Sq, hd); k, v: (BHkv, Skv, hd) -> (BH, Sq, hd) in q's dtype.
    ``window`` > 0 keeps keys with kpos > qpos - window; ``scale`` 0
    means hd ** -0.5."""
    global LAUNCHES
    _check(q, k, v)
    bh, sq, hd = q.shape
    scale = scale or (1.0 / math.sqrt(hd))
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    path = route(q.dtype, hd)
    bhkv, skv, _ = k.shape
    out = torch.empty_like(q)
    if q.device.type == "meta":
        _note(q, k, causal, window)
        return out
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], bh, bhkv, sq, skv, hd, int(causal),
            int(window), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + _lib().flash_error_string(rc).decode())
    LAUNCHES += 1
    ROUTE_LAUNCHES[path] += 1
    _note(q, k, causal, window)
    return out


def _note(q, k, causal: bool, window: int) -> None:
    if counter.active():
        bh, sq, hd = q.shape
        counter.note("flash_attention",
                     4 * hd * bh * visible_pairs(sq, k.shape[1], causal,
                                                 window),
                     2 * counter.nbytes(q) + 2 * counter.nbytes(k))
