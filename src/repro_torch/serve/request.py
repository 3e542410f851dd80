"""Request/Result model for the serving subsystem (the port's copy of
``repro.serve.request``: numpy and zlib only).

A ``Request`` is one queued G-GPU kernel launch plus its serving metadata:
the ``tag`` a caller uses to correlate results, a ``priority`` (higher
drains earlier), and an optional modeled-time ``deadline_us`` used as a
tie-breaker (earliest-deadline-first within a priority class). The
``ticket`` identifies the request within its scheduler and orders results.

``KernelLaunch`` is the pre-package name of this class and remains as an
alias for compatibility (``repro_torch.serve.engine`` re-exports it); the
extra fields all default, so positional ``KernelLaunch(prog, mem0,
n_items, tag)`` construction is unchanged.

``Result`` is a (mem, info) named tuple — exactly the pair the engine's
``run_kernel`` returns, so code that unpacks ``mem, info = result`` keeps
working. The serving layer adds ``info["ticket"]``, ``info["batch_size"]``
(how many launches shared the dispatch) and ``info["tag"]`` (when set).

A request may declare an ``out_region=(lo, hi)``: the half-open slice of
the final memory image the caller actually wants back. The async launch
path then downloads only that slice (``Result.mem`` holds it), and
``(0, 0)`` means cycles-only — no memory transfer at all (how the DSE
evaluator collects). Without a region, ``Result.mem`` is the full image,
bit-exact with direct ``run_kernel``.

**Dependency edges.** ``deps`` declares that this request consumes the
output of earlier requests: each ``Dep(producer, dst, src)`` names a
producer *ticket*, the half-open region ``dst`` of *this* request's
memory image the producer's output lands in, and optionally the region
``src`` of the producer's final image to read (default: the producer's
declared ``out_region``). A dependency-aware scheduler dispatches the
consumer only once every producer has been dispatched, and patches the
producer's device-resident output directly into the consumer's staged
memory — the words at ``dst`` in ``mem0`` are placeholders (conventionally
zeros) that never travel through the host. Producers that exist only to
feed consumers declare ``out_region=(0, 0)`` so nothing is downloaded
anywhere along the chain. ``schedule`` labels the lowering schedule the
kernel was compiled with (the compiler's schedule label); the fleet
keys its learned service-time model on (kernel, schedule), since tuned
and default lowerings of one kernel have different true cycle counts.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np


def result_checksum(mem) -> int:
    """CRC32 of a result's memory words — the optional output audit a
    ``Request`` may carry (``audit=``). A caller who knows the expected
    output (e.g. a replayed trace, or any idempotent kernel) stamps the
    fault-free checksum on the request; the scheduler then verifies every
    collected result and treats a mismatch as a *corrupted* launch
    (retried or quarantined, never silently returned). Cheap: one pass
    over the downloaded words that were coming back anyway."""
    return zlib.crc32(np.ascontiguousarray(
        np.asarray(mem, np.int32)).tobytes())


@functools.lru_cache(maxsize=4096)
def _static_ops_cached(prog_bytes: bytes, width: int) -> tuple:
    """Content-keyed twin of ``engine.stepper._static_ops``: serving
    traffic re-dispatches the same few programs forever, so the opcode
    set is computed once per program *content*, not once per chunk."""
    prog = np.frombuffer(prog_bytes, np.int32).reshape(-1, width)
    return tuple(sorted({int(o) for o in prog[:, 0]}))


@dataclasses.dataclass(frozen=True)
class Dep:
    """One dependency edge: this request's ``dst`` region is fed by
    ``producer``'s final-memory ``src`` region (``None``: the producer's
    declared ``out_region``, resolved at admission). Regions are
    half-open ``(lo, hi)`` word slices and must have equal width."""
    producer: int
    dst: Tuple[int, int]
    src: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class Request:
    """One queued G-GPU kernel launch with serving metadata."""
    prog: np.ndarray
    mem0: np.ndarray
    n_items: int
    tag: str = ""
    priority: int = 0            # higher drains earlier
    deadline_us: float = math.inf  # modeled-time deadline (EDF tie-break)
    ticket: int = -1             # assigned by the scheduler at submit
    out_region: Optional[Tuple[int, int]] = None  # download slice (lo, hi)
    deps: Tuple[Dep, ...] = ()   # producer edges (see module doc)
    schedule: str = ""           # lowering-schedule label ("" = unknown)
    audit: Optional[int] = None  # expected result_checksum(mem) (or None)
    attempts: int = 0            # completed re-dispatches (retry policy)
    arrival_s: Optional[float] = None  # wall clock at admission (stamped
    #                              by the scheduler; deadline-drop policies
    #                              measure the latency budget from here)

    def __post_init__(self):
        self.prog = np.asarray(self.prog, np.int32)
        self.mem0 = np.asarray(self.mem0, np.int32)
        self.n_items = int(self.n_items)
        if self.out_region is not None:
            # validate at admission: a malformed region must bounce the
            # submit (per-request, handleable), not poison every later
            # drain from inside the dispatch path
            lo, hi = self.out_region
            if not (0 <= lo <= hi <= self.mem0.shape[0]):
                raise ValueError(
                    f"out_region {self.out_region} outside memory image "
                    f"[0, {self.mem0.shape[0]})")
        self.deps = tuple(self.deps)
        for d in self.deps:
            if not isinstance(d, Dep):
                raise ValueError(f"deps must be Dep instances, got {d!r}")
            lo, hi = d.dst
            if not (0 <= lo <= hi <= self.mem0.shape[0]):
                raise ValueError(
                    f"dep dst {d.dst} outside memory image "
                    f"[0, {self.mem0.shape[0]})")
            if d.src is not None and d.src[1] - d.src[0] != hi - lo:
                raise ValueError(
                    f"dep src {d.src} and dst {d.dst} widths differ")

    def kernel_key(self) -> tuple:
        """Same-kernel identity: launches sharing this key fold into one
        cohort stepper call (program, item count, memory shape)."""
        return (self.prog.tobytes(), self.n_items, self.mem0.shape[0])

    def static_ops(self) -> tuple:
        """The program's opcode set (the decode-specialization jit static),
        via a process-wide content-keyed cache — repeat traffic never
        rescans its program."""
        return _static_ops_cached(self.prog.tobytes(), self.prog.shape[1])


# compatibility alias: the pre-package launch record
KernelLaunch = Request


class Result(NamedTuple):
    """One completed launch: final memory image + the engine info dict."""
    mem: np.ndarray
    info: dict

    @property
    def ticket(self) -> int:
        return self.info.get("ticket", -1)
