"""Ambient sharding context (the port's ``repro.sharding.ctx``).

Model code calls ``shard_hint(x, kind)`` at layout-critical points; what
that means is decided by the active :class:`ShardingRules` (set by the
Trainer). With no rules set, hints are the identity, so model code never
depends on a mesh being present. Outside the sharded train step a
``DTensor`` is redistributed to the kind's spec and a plain tensor is
left as it is (the serving steps keep the one-device layout).

Inside the sharded train step (``sharded``, entered by
``models.steps``) each rank computes on plain local tensors, Megatron
style: its rows of the batch (split over the rules' dp axes), its
"model" part of every parameter the rules split over "model", and the
residual stream split along the sequence where the "acts" spec says.
``shard_hint(x, kind, src=...)`` then moves a rank's tensor to what
``activation_spec(kind, global shape)`` says, from what ``src`` says it
is: "partial" (the value is the sum over the "model" ranks), "whole"
(the same on every rank) or "cols" (this rank's columns of a
column-parallel product).

The collectives are autograd Functions over the rules' mesh groups, in
pairs: gather forward with reduce-scatter (or this rank's slice)
backward, reduce-scatter with gather, all-reduce with identity, and
identity with all-reduce. A gradient of a tensor every "model" rank
holds whole is that rank's whole gradient, except where the tensor
feeds a per-rank part of a product: ``grad_sum`` marks those
(``gather``, ``whole_seq``), whose backward sums the ranks' shares. On a group of one rank every
collective is the identity and adds no autograd node, so a (1, 1) mesh
computes what one device computes, bit for bit.

``gather_param`` is the dp gather of one parameter at the layer unit
that reads it (``models.model``): its backward reduce-scatters the
gradient over the dp axes that shard it, all-reduces it over those that
replicate it, and divides by the dp extent, where the ranks' rows
differ; where every rank computes every row it takes the rank's slice.
``batch_mean`` takes a mean over the dp ranks' rows (the MoE FFN's
load-balancing fractions), the identity outside the sharded step.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Tuple

import torch

_state = threading.local()
# the sharded train step's context: process-wide, not per thread, since
# the autograd engine may run a checkpoint's recompute on its own thread
_step: list = [None]


def current_rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def set_rules(rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


# ---------------------------------------------------------------------------
# mesh axes and plain collectives
# ---------------------------------------------------------------------------

class Axis(NamedTuple):
    """One mesh dim: its process group, extent and this rank's index."""
    group: object
    n: int
    rank: int


ONE = Axis(None, 1, 0)


def mesh_axis(mesh, name: str) -> Axis:
    """The mesh dim ``name`` as an ``Axis`` (``ONE`` if absent or of
    extent 1)."""
    names = tuple(mesh.mesh_dim_names)
    if name not in names or mesh.size(names.index(name)) == 1:
        return ONE
    return Axis(mesh.get_group(name), mesh.size(names.index(name)),
                mesh.get_local_rank(name))


def _c10d(new: str, old: str):
    """torch's collective ``new``, or ``old`` where this torch lacks it
    (newer releases deprecate ``old``; the signatures agree)."""
    import torch.distributed as dist
    return getattr(dist, new, None) or getattr(dist, old)


def all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((ax.n * xt.shape[0], *xt.shape[1:]))
    _c10d("all_gather_single", "all_gather_into_tensor")(
        out, xt, group=ax.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the ranks' ``x``."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // ax.n, *xt.shape[1:]))
    _c10d("reduce_scatter_single", "reduce_scatter_tensor")(
        out, xt, group=ax.group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, ax: Axis, op=None) -> torch.Tensor:
    """The sum (or ``op``) of the ranks' ``x``, a new tensor."""
    import torch.distributed as dist
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=ax.group)
    return y


def local_slice(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view)."""
    size = x.shape[dim] // ax.n
    return x.narrow(dim, ax.rank * size, size)


def all_to_all(x: torch.Tensor, ax: Axis, sizes_out, sizes_in
               ) -> torch.Tensor:
    """``x``'s rows sent in blocks of ``sizes_out`` (one per rank, in
    rank order) and received in blocks of ``sizes_in``."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((sum(sizes_in), *x.shape[1:]))
    dist.all_to_all_single(out, x, list(sizes_in), list(sizes_out),
                           group=ax.group)
    return out


# ---------------------------------------------------------------------------
# the collectives as autograd pairs
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """Forward all-gather along ``dim``; backward reduce-scatter
    (``grad_sum``: each rank's gradient is its share) or this rank's
    slice (each rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, ax, grad_sum):
        ctx.dim, ctx.ax, ctx.grad_sum = dim, ax, grad_sum
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            return reduce_scatter(g, ctx.dim, ctx.ax), None, None, None
        return local_slice(g, ctx.dim, ctx.ax).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward reduce-scatter along ``dim``; backward all-gather."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return reduce_scatter(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


class _AllReduce(torch.autograd.Function):
    """Forward all-reduce (a partial sum made whole); backward the
    identity (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward the identity; backward all-reduce: the gradient of a whole
    tensor whose consumers each hold a share of it."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _Split(torch.autograd.Function):
    """Forward this rank's block along ``dim`` of a whole tensor;
    backward all-gather (the whole gradient on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return local_slice(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


def gather(x, dim: int, ax: Axis, grad_sum: bool):
    return x if ax.n == 1 else _Gather.apply(x, dim, ax, grad_sum)


def scatter_sum(x, dim: int, ax: Axis):
    return x if ax.n == 1 else _ReduceScatter.apply(x, dim, ax)


def reduce_sum(x, ax: Axis):
    return x if ax.n == 1 else _AllReduce.apply(x, ax)


def copy(x, ax: Axis):
    return x if ax.n == 1 else _Copy.apply(x, ax)


def split(x, dim: int, ax: Axis):
    return x if ax.n == 1 else _Split.apply(x, dim, ax)


class _Exchange(torch.autograd.Function):
    """Rows exchanged by ``all_to_all`` (a permutation of blocks across
    the ranks); backward the inverse exchange. Exact both ways."""

    @staticmethod
    def forward(ctx, x, ax, sizes_out, sizes_in):
        ctx.ax, ctx.sizes = ax, (sizes_out, sizes_in)
        return all_to_all(x, ax, sizes_out, sizes_in)

    @staticmethod
    def backward(ctx, g):
        sizes_out, sizes_in = ctx.sizes
        return all_to_all(g, ctx.ax, sizes_in, sizes_out), None, None, None


def swiglu_pairs(w, ax: Axis):
    """A fused gate|up weight (..., 2 ff) split contiguously along its
    last dim over ``ax`` (rank r holds columns [2r f, 2(r+1) f), f =
    ff / n) as this rank's (gate, up) pair: gate columns [r f, (r+1) f)
    beside up columns ff + [r f, (r+1) f), so that rank r's SwiGLU units
    are its rows of the row-parallel ``wo``. Column blocks move between
    ranks by one all-to-all, forward and backward."""
    if ax.n == 1:
        return w
    n, r = ax.n, ax.rank
    f = w.shape[-1] // 2
    # global block j (of width f) lives on rank j // 2; rank t wants
    # gate block t and up block n + t
    want = lambda t: (t, n + t)                                # noqa: E731
    send = [[j for j in (2 * r, 2 * r + 1) if j in want(t)]
            for t in range(n)]
    recv = [[j for j in want(r) if j // 2 == s] for s in range(n)]
    cols = w.movedim(-1, 0)
    blocks = [cols[(j - 2 * r) * f:(j - 2 * r + 1) * f]
              for t in range(n) for j in send[t]]
    out = _Exchange.apply(torch.cat(blocks), ax,
                          [len(b) * f for b in send],
                          [len(b) * f for b in recv])
    got = {}
    at = 0
    for s in range(n):
        for j in recv[s]:
            got[j] = out[at:at + f]
            at += f
    return torch.cat([got[j] for j in want(r)]).movedim(0, -1)


# ---------------------------------------------------------------------------
# the sharded train step's context
# ---------------------------------------------------------------------------

class Sharded:
    """What the sharded train step's model code reads: the "model" axis,
    the dp axes of extent > 1 (minor to major), whether each rank has
    rows of its own (``split``), and the rules."""

    def __init__(self, rules, split: bool):
        mesh = rules.mesh
        self.rules = rules
        self.model = mesh_axis(mesh, rules.tp_axis)
        names = tuple(mesh.mesh_dim_names)
        minor_first = sorted(rules.dp_axes, key=names.index, reverse=True)
        self.dp = [(a, mesh_axis(mesh, a)) for a in minor_first
                   if mesh_axis(mesh, a).n > 1]
        self.split = split
        self.dp_n = rules.axes_size(rules.dp_axes)
        self.seq = False          # the residual stream split along S

    def begin_stream(self, shape) -> None:
        """Note the residual stream's global ``shape`` (B, S, d): whether
        the "acts" spec splits it along the sequence."""
        self.seq = self.model_dim("acts", tuple(shape)) == 1

    def model_dim(self, kind: str, shape) -> Optional[int]:
        """The dim of a tensor of global ``shape`` that ``kind``'s spec
        splits over "model", or None."""
        if self.model.n == 1:
            return None
        spec = self.rules.activation_spec(kind, tuple(shape))
        return next((i for i, e in enumerate(spec or ())
                     if self.rules.tp_axis in self.rules.entry_axes(e)), None)


def sharded() -> Optional[Sharded]:
    """The active sharded train step's context, or None."""
    return _step[0]


@contextlib.contextmanager
def sharded_step(rules, split: bool):
    """Within the block, model code computes the sharded train step's
    local parts (module doc); ``split``: each rank's batch is its rows of
    the global batch, split over the rules' dp axes."""
    prev = _step[0]
    _step[0] = Sharded(rules, split)
    try:
        yield _step[0]
    finally:
        _step[0] = prev


def shard_hint(x, kind: str, src: str = "local", *, shape=None):
    """Outside the sharded train step: redistribute a DTensor ``x`` to the
    spec of activation ``kind`` if rules are active and give one;
    otherwise the identity.

    Inside it: move this rank's ``x`` to the spec of ``kind`` at its
    global shape along the "model" axis. ``src`` says what ``x`` is:
      * "local": already laid out by the spec (the identity);
      * "partial": the sum over the "model" ranks is the value (a
        row-parallel product): reduce-scattered along the spec's split
        dim, all-reduced where it splits none;
      * "whole": the same on every rank: sliced along the spec's split
        dim (backward all-gather), unchanged where it splits none;
      * "cols": this rank's block of the last dim of a column-parallel
        product, flattening the last two dims of ``shape`` (the global
        (B, S, H, hd) of "heads"): reshaped to its heads where the spec
        splits the heads, gathered whole where it does not (every rank's
        consumer holding the whole gradient), and then sliced along the
        sequence where the spec splits that."""
    st = sharded()
    rules = current_rules()
    if st is not None and not _is_dtensor(x):
        return _move(st, x, kind, src, shape)
    if rules is None or not _is_dtensor(x):
        return x
    spec = rules.activation_spec(kind, tuple(x.shape))
    if spec is None:
        return x
    return x.redistribute(rules.mesh, rules.placements(spec))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _move(st: Sharded, x, kind, src, shape):
    ax = st.model
    if src == "local" or ax.n == 1:
        if src == "cols" and shape is not None:
            return x.reshape(*x.shape[:-1], *shape[-2:])
        return x
    if src == "cols":
        d = st.model_dim(kind, shape)
        lead = x.shape[:-1]
        if d == len(shape) - 2:                  # this rank's heads
            return x.reshape(*lead, shape[-2] // ax.n, shape[-1])
        whole = gather(x, x.ndim - 1, ax, False)
        whole = whole.reshape(*lead, *shape[-2:])
        return whole if d is None else split(whole, d, ax)
    d = st.model_dim(kind, tuple(x.shape))
    if src == "partial":
        return reduce_sum(x, ax) if d is None else scatter_sum(x, d, ax)
    if src == "whole":
        return x if d is None else split(x, d, ax)
    raise ValueError(f"src={src!r}")


def whole_seq(x, grad_sum: bool):
    """The whole sequence of this rank's residual part ``x`` (B, s, d)
    inside the sharded step: gathered along dim 1 where the stream is
    split (backward reduce-scatter with ``grad_sum``, else this rank's
    slice), else ``x`` (all-reduced backward with ``grad_sum``). Outside
    the step, ``x``."""
    st = sharded()
    if st is None or st.model.n == 1:
        return x
    if st.seq:
        return gather(x, 1, st.model, grad_sum)
    return copy(x, st.model) if grad_sum else x


def seq_param(t):
    """A parameter every "model" rank holds whole, as read by this rank's
    part of a sequence-split stream: its gradient is summed over the
    "model" ranks (backward all-reduce) where the stream is split, so
    each rank gets the whole one. Outside the step, ``t``."""
    st = sharded()
    if st is None or not st.seq:
        return t
    return copy(t, st.model)


def split_dim(t) -> Optional[int]:
    """The dim of parameter ``t`` the rules split over "model" in the
    sharded step (``models.steps.bind_shards`` notes it as
    ``model_dim``), or None: not split, or outside the step."""
    return None if sharded() is None else getattr(t, "model_dim", None)


@contextlib.contextmanager
def swapped(pairs):
    """Each (module, name, tensor) of ``pairs`` in place of the module's
    parameter ``name`` for the block."""
    saved = [(m, n, m._parameters[n]) for m, n, _ in pairs]
    for m, n, t in pairs:
        m._parameters[n] = t
    try:
        yield
    finally:
        for m, n, t in saved:
            m._parameters[n] = t


def _params_of(module):
    return [(m, n, t) for m in module.modules()
            for n, t in m._parameters.items() if t is not None]


def whole_block(module, fn, x):
    """``fn(x_whole)`` run in full on every "model" rank: ``module``'s
    parameters split over "model" gathered whole (backward this rank's
    slice), this rank's part ``x`` of the residual stream gathered along
    the sequence; the result (or a tuple's first entry) returned as this
    rank's part. The rules' fallback where a layer's weights are not
    split, and the recurrent mixers' layout (ROADMAP item 9d)."""
    st = sharded()
    pairs = [(m, n, gather(t, t.model_dim, st.model, False))
             for m, n, t in _params_of(module)
             if getattr(t, "model_dim", None) is not None]
    with swapped(pairs):
        res = fn(whole_seq(x, grad_sum=False))
    if isinstance(res, tuple):
        return (shard_hint(res[0], "acts", "whole"), *res[1:])
    return shard_hint(res, "acts", "whole")


# ---------------------------------------------------------------------------
# the dp gather of a layer unit's parameters
# ---------------------------------------------------------------------------

class _DPGather(torch.autograd.Function):
    """Forward: the shard gathered over each dp mesh dim that splits it,
    minor to major (``plan``: (tensor dim or None, Axis) per dp dim of
    extent > 1, None where that dim replicates it). Backward, where the
    rows are split: reduce-scatter over the splitting dims and all-reduce
    over the replicating ones, major to minor, then divide by the dp
    extent (each rank's loss is the mean over its own rows); where every
    rank computes every row: this rank's slice."""

    @staticmethod
    def forward(ctx, shard, plan, split, n):
        ctx.plan, ctx.split, ctx.n = plan, split, n
        out = shard
        for dim, ax in plan:
            if dim is not None:
                out = all_gather(out, dim, ax)
        return out if out is not shard else shard.view_as(shard)

    @staticmethod
    def backward(ctx, g):
        for dim, ax in reversed(ctx.plan):
            if not ctx.split:
                if dim is not None:
                    g = local_slice(g, dim, ax)
            elif dim is None:
                g = all_reduce(g, ax)
            else:
                g = reduce_scatter(g, dim, ax)
        if ctx.split:
            g = g / ctx.n
        return g.contiguous(), None, None, None


def gather_param(shard) -> torch.Tensor:
    """A parameter's local shard gathered over the dp axes for the unit
    that reads it (its ``dp_plan``, as ``_DPGather``'s, noted by
    ``models.steps.bind_shards``), keeping its ``model_dim``; the shard
    itself where the dp axes have no rank but this one."""
    st = sharded()
    plan = getattr(shard, "dp_plan", ())
    if st is None or not plan:
        return shard
    out = _DPGather.apply(shard, plan, st.split, st.dp_n)
    out.model_dim = shard.model_dim
    return out


@contextlib.contextmanager
def gathered(modules):
    """Within the block, each parameter of ``modules`` (None entries
    skipped) is its dp gather (``gather_param``): a layer unit's weights
    exist whole over dp only while the unit runs. Inside a checkpoint the
    recompute gathers again. Outside the sharded step, nothing."""
    if sharded() is None:
        yield
        return
    pairs = [(m, n, gather_param(t)) for mod in modules if mod is not None
             for m, n, t in _params_of(mod)]
    with swapped(pairs):
        yield


# ---------------------------------------------------------------------------
# means over the batch
# ---------------------------------------------------------------------------

class _BatchMean(torch.autograd.Function):
    """The mean over the dp ranks of ``x``, each rank's over its own,
    equally many, rows. Every rank then holds the global value and
    computes the same loss terms from it. Each rank's loss weighs its
    rows as if they were the whole batch, and the parameters' dp gathers
    average the ranks' gradients; so the backward passes the gradient
    through as it is, which after that average is the one-device
    gradient."""

    @staticmethod
    def forward(ctx, x, axes, n):
        y = x.detach()
        for ax in axes:
            y = all_reduce(y, ax)
        return y / n

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's rows, as the mean over the global
    batch's rows inside the sharded step when the rows are split;
    ``x`` itself otherwise."""
    st = sharded()
    if st is None or not st.split or not st.dp:
        return x
    return _BatchMean.apply(x, [ax for _, ax in st.dp], st.dp_n)
