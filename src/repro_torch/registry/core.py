"""Registry core: named axes of decorator-registered plugins (the port's
own copy of ``repro.registry.core``, which the port may not import).

An :class:`Axis` is one extension dimension of the system — benches,
memory systems, chunk-planning policies, fleet routers, traffic
generators, fault scenarios. Each axis knows the
*provider modules* whose import registers the built-in plugins, plus the
``repro_torch.registry.plugins`` drop-in package that is scanned
automatically, so a brand-new scenario is **one new file** that appears
in every enumeration without touching any core module.

Rules every axis enforces:

  * **decorator or direct registration** — ``@AXIS.register("name")``
    on a class/function, or ``AXIS.register("name", obj)`` for
    pre-built instances;
  * **duplicate-name rejection** — a second registration of a taken
    name raises :class:`DuplicateNameError` (silent shadowing is how
    two plugins corrupt each other's sweeps);
  * **lazy discovery** — provider modules import only when the axis is
    first queried, so ``import repro_torch.registry`` stays light and the
    engine/serve modules can register themselves without import cycles;
  * **deterministic enumeration** — ``names()``/``items()`` are sorted
    by name, so the order never depends on which axis was queried first
    or which module happened to import earlier.

Lookup failures raise :class:`UnknownPluginError`, a ``KeyError``
subclass so pre-registry call sites (``get_memsys``) keep their
contract, with the same ``choices:`` message shape.
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["Axis", "DuplicateNameError", "RegistryError",
           "UnknownPluginError", "resolve", "scan_package"]


class RegistryError(Exception):
    """Base class for registry failures."""


class DuplicateNameError(RegistryError):
    """Two plugins claimed the same name on one axis."""


class UnknownPluginError(RegistryError, KeyError):
    """Lookup of a name no plugin registered (``KeyError`` for
    compatibility with the pre-registry dict-based call sites)."""

    def __str__(self) -> str:  # KeyError would repr() the args tuple
        return self.args[0]


_MISSING = object()


class Axis:
    """One pluggable dimension: a name -> plugin mapping with lazy
    provider discovery (see module doc).

    ``providers`` are module paths imported on first query; their import
    side effect is the ``register`` calls for the built-ins. The shared
    ``repro_torch.registry.plugins`` drop-in package is appended to every
    axis's provider list by default (``scan_plugins=False`` opts out —
    used by unit tests that build throwaway axes)."""

    def __init__(self, name: str, doc: str = "",
                 providers: Tuple[str, ...] = (),
                 scan_plugins: bool = True):
        self.name = name
        self.doc = doc
        self._providers = tuple(providers)
        if scan_plugins:
            self._providers += ("repro_torch.registry.plugins",)
        self._entries: Dict[str, object] = {}
        self._discovered = False

    # -- registration -------------------------------------------------------

    def register(self, name: str, obj: object = _MISSING):
        """Register ``obj`` under ``name``; with ``obj`` omitted,
        returns a decorator. The decorated object is returned unchanged,
        so ``@AXIS.register("x")`` stacks freely with ``@dataclass``."""
        if obj is _MISSING:
            def deco(target):
                self._add(name, target)
                return target
            return deco
        self._add(name, obj)
        return obj

    def _add(self, name: str, obj: object) -> None:
        if not isinstance(name, str) or not name:
            raise RegistryError(
                f"{self.name} plugin name must be a non-empty string, "
                f"got {name!r}")
        if name in self._entries:
            raise DuplicateNameError(
                f"{self.name} plugin {name!r} is already registered "
                f"({self._entries[name]!r}); plugin names must be unique "
                f"per axis")
        self._entries[name] = obj

    # -- discovery ----------------------------------------------------------

    def discover(self) -> None:
        """Import every provider module once (their import registers the
        built-ins). Import errors propagate — a broken plugin must fail
        the registry smoke loudly, not vanish from the enumeration."""
        if self._discovered:
            return
        # flip first: a provider that queries its own axis mid-import
        # (e.g. to extend an existing entry) must not recurse
        self._discovered = True
        try:
            for mod in self._providers:
                importlib.import_module(mod)
        except BaseException:
            self._discovered = False
            raise

    # -- lookup / enumeration -----------------------------------------------

    def get(self, name: str) -> object:
        self.discover()
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownPluginError(
                f"unknown {self.name} {name!r}; choices: "
                f"{sorted(self._entries)}") from None

    def names(self) -> List[str]:
        """Registered names, sorted — the deterministic enumeration
        order every sweep is generated from."""
        self.discover()
        return sorted(self._entries)

    def items(self) -> List[Tuple[str, object]]:
        self.discover()
        return [(n, self._entries[n]) for n in sorted(self._entries)]

    def __contains__(self, name: str) -> bool:
        self.discover()
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        self.discover()
        return len(self._entries)

    def __repr__(self) -> str:
        state = sorted(self._entries) if self._discovered \
            else f"undiscovered, providers={list(self._providers)}"
        return f"Axis({self.name!r}: {state})"


def scan_package(package) -> List[str]:
    """Import every module inside ``package`` (sorted by name — the
    drop-in directory's automagic). Returns the imported module names."""
    out = []
    for info in sorted(pkgutil.iter_modules(package.__path__),
                       key=lambda m: m.name):
        importlib.import_module(f"{package.__name__}.{info.name}")
        out.append(info.name)
    return out


def resolve(spec: str, default_attr: Optional[str] = None) -> Callable:
    """Resolve a ``"module:attr"`` runner spec to the callable it names
    (the indirection that lets a registry entry name a runner without
    importing it)."""
    mod, _, attr = spec.partition(":")
    target = importlib.import_module(mod)
    attr = attr or default_attr
    try:
        return getattr(target, attr)
    except (AttributeError, TypeError) as exc:
        raise RegistryError(
            f"spec {spec!r}: module {mod!r} has no attribute {attr!r}"
        ) from exc
