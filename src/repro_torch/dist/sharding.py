"""Logical-axis sharding over ``torch.distributed`` (the port of
``repro.dist.sharding``).

Model code names the axes of its arrays with *logical* names ("batch",
"fsdp", "tp", "tp?", "vocab", "expert", "kv_seq", "kv_hd", None); a
``Mapping`` binds them to the axes of a ``launch.mesh.Mesh`` ("data",
"model") and is made current with ``activate``.  The resolution rules
are the reference's, table, divisibility drop and all:

  "batch"   -> the mapping's batch axes (default ("data",))
  "fsdp"    -> ("data",) when Mapping.fsdp else replicated
  "tp", "tp?", "vocab", "expert" -> ("model",)
  "kv_seq"  -> Mapping.kv_seq_axis;  "kv_hd" -> Mapping.kv_hd_axis
  None      -> replicated

A mapped axis that does not divide the dim is dropped (replicated), and
a mesh axis is never used twice in one spec.  ``spec`` returns a plain
tuple per dim (None, an axis name, or a tuple of names): the
counterpart of a ``PartitionSpec``.

The reference runs one program and lets GSPMD place the arrays.  Here
every rank runs the same host loop on its own slices (SPMD): ``shard``
and ``shard_tree`` cut a whole tensor or tree down to the calling
rank's slice by its spec, and the model code calls the collectives
below at the few places where the single-program result needs them:
``all_reduce`` (MAX of activation abs-maxima, SUM of int32 partial
products) and ``all_gather`` (batch rows of the logits).  Each call is
counted in ``Mapping.collectives`` by kind and axes, and its result's
bytes in ``Mapping.collective_bytes``.  With no mapping
current, ``current_mapping()`` is None and the model code calls none of
them: single-device code pays nothing.

Training differentiates through the sharded program, so the model code
reaches its float collectives through ``torch.autograd.Function``s
whose backward is the collective the gradient needs (Megatron's pair
and its relatives):

  ``copy_to``     "f": identity forward, SUM all-reduce backward; in
                  front of a column-parallel GEMM, whose input is
                  replicated but whose gradient each rank holds a part of
  ``reduce_from`` "g": SUM all-reduce forward, identity backward; after
                  a row-parallel GEMM (and the vocab-parallel embedding),
                  whose output is then replicated with its gradient.
                  (``torch.distributed.nn.functional.all_reduce`` is not
                  used: its backward all-reduces the replicated gradient
                  again, TP times too large)
  ``gather_from`` all-gather forward, this rank's slice backward
  ``scatter_to``  this rank's slice forward, all-gather backward
  ``fsdp_gather`` all-gather over the FSDP axes forward, reduce-scatter
                  MEAN backward: the zero-3 weight gather, whose backward
                  is the data-parallel gradient mean of the leaf; a
                  layer's weights are gathered where the layer runs
                  (``LayerParams``)

The float parts that run whole on every rank (``whole``, ``own``,
``whole_weight``: the recurrent cells) are ``gather_from`` and
``scatter_to`` under autograd.  Each counts its collectives when they
run (a backward one as ``{kind}_bwd``).  Without autograd (serving) each is the plain
collective it wraps, counted as before.  gloo has no reduce-scatter and
no bf16 all-reduce: the reduce-scatter is written as an all-reduce and
a slice there, and a bf16 sum travels as f32 (two terms round once, as
NCCL's sum does); the NCCL path uses ``reduce_scatter_tensor`` and the
tensor's own dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.quantization import QTensor

_ACTIVE: list["Mapping"] = []
_ROWS: list = []
QTENSOR_FIELDS = ("values", "scale")


@dataclass
class ShardedQTensor(QTensor):
    """A QTensor cut to the calling rank's slice, with the resolved spec
    of its ``values``: the GEMMs read from it which of their dims lie on
    "model" (``gemm_split``), whatever the axis's size."""
    spec: tuple = ()


@dataclass(frozen=True)
class GemmSplit:
    """How one approx-MAC GEMM is split under a mapping.

    col: the output columns lie on "model" (at any TP size, one
    included); this rank holds logical
    columns [n_offset, n_offset + local N) of ``n_logical``.  row: the
    contraction dim lies on "model": the int32 partial products are
    summed over it before the one epilogue multiply.  scale_axes: the
    mesh axes whose ranks hold other parts of the GEMM's input, over
    which the activation abs-max is reduced (MAX) before the scale
    formula: "data" for a column-parallel or unsplit GEMM (the batch),
    every axis for a row-parallel one and for an expert bank split by
    experts (expert: the other experts' rows lie on the other ranks of
    "model")."""
    mapping: "Mapping"
    n_logical: int
    n_offset: int = 0
    row: bool = False
    col: bool = False
    expert: bool = False

    @property
    def scale_axes(self) -> tuple[str, ...]:
        m = self.mapping
        return m.all_axes if self.row or self.expert else tuple(
            a for a in m.all_axes if a != "model")


class Mapping:
    """Binds logical axis names to the axes of a mesh."""

    def __init__(self, mesh, *, fsdp: bool = False,
                 batch_axes: Sequence[str] = ("data",),
                 kv_seq_axis: Sequence[str] | None = None,
                 kv_hd_axis: Sequence[str] | None = None):
        self.mesh = mesh
        self.fsdp = fsdp
        self.batch_axes = tuple(a for a in batch_axes
                                if a in mesh.axis_names)
        self.kv_seq_axis = tuple(kv_seq_axis) if kv_seq_axis else None
        self.kv_hd_axis = tuple(kv_hd_axis) if kv_hd_axis else None
        self.collectives: Counter = Counter()
        # the bytes of each counted call's result, by the same key
        self.collective_bytes: Counter = Counter()

    # -- logical -> mesh axis resolution --------------------------------
    def _axis_size(self, axes: tuple[str, ...]) -> int:
        return self.mesh.axis_size(axes)

    def _resolve_one(self, name, dim: int, used: set[str]):
        if name is None:
            return None
        table = {
            "batch": self.batch_axes,
            "fsdp": ("data",) if self.fsdp else None,
            "tp": ("model",),
            "tp?": ("model",),
            "vocab": ("model",),
            "expert": ("model",),
            "kv_seq": self.kv_seq_axis,
            "kv_hd": self.kv_hd_axis,
        }
        axes = table.get(name)
        if not axes:
            return None
        axes = tuple(a for a in axes if a in self.mesh.axis_names
                     and a not in used)
        if not axes or dim % self._axis_size(axes) != 0:
            return None
        used.update(axes)
        return axes if len(axes) > 1 else axes[0]

    def spec(self, logical: Sequence, shape: Sequence[int]) -> tuple:
        """The mesh axes of each dim of one array (None: replicated),
        from its logical axes and shape; a rank mismatch replicates."""
        if len(logical) != len(shape):
            return ()
        used: set[str] = set()
        return tuple(self._resolve_one(n, d, used)
                     for n, d in zip(logical, shape))

    def shardings(self, spec_tree, shape_tree):
        """The resolved spec of every leaf of `shape_tree` (tensors,
        QTensors, or anything with a ``shape``), in its structure, by
        walking `spec_tree` along the leaf's path (``_walk``); a leaf
        whose walk ends on no spec tuple is replicated (())."""
        return _map_with_path(
            lambda path, leaf: self._leaf_spec(spec_tree, path, leaf),
            shape_tree)

    def _leaf_spec(self, spec_tree, path, leaf) -> tuple:
        spec = _walk(spec_tree, path)
        if isinstance(spec, tuple) and _is_leaf_spec(spec):
            return self.spec(spec, tuple(leaf.shape))
        return ()

    # -- the calling rank's slices --------------------------------------
    def local_range(self, axes, dim: int) -> tuple[int, int]:
        """[lo, hi) of a dim of size `dim` that the calling rank holds
        when the dim is sharded over `axes` (None: the whole dim)."""
        if axes is None:
            return 0, dim
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = self.mesh.axis_size(axes)
        size = dim // n
        lo = self.mesh.axis_index(axes) * size
        return lo, lo + size

    def shard(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The calling rank's slice of a whole tensor by a resolved spec
        (a contiguous copy when anything is cut; `x` itself where every
        axis of the spec holds one rank)."""
        out = x
        for dim, axes in enumerate(spec):
            if axes is not None:
                lo, hi = self.local_range(axes, x.shape[dim])
                if hi - lo < x.shape[dim]:
                    out = out.narrow(dim, lo, hi - lo)
        return out.clone(memory_format=torch.contiguous_format) \
            if out is not x else x

    def shard_tree(self, tree, spec_tree, path: tuple = ()):
        """Every leaf of `tree` cut to the calling rank's slice by the
        spec its path resolves to in `spec_tree` (`tree` sits at `path`
        in it); a QTensor becomes a ``ShardedQTensor`` that carries its
        values' resolved spec, and a tensor that is cut carries its own
        as a ``spec`` attribute (a float GEMM weight's split,
        ``gemm_split``)."""
        def leaf(path, x):
            spec = self._leaf_spec(spec_tree, path, x)
            out = self.shard(x, spec)
            if any(a is not None for a in spec):
                out = out.view_as(out) if out is x else out
                out.spec = spec
            return out

        def qtensor(path, q):
            vspec = self._leaf_spec(spec_tree, path + ("values",), q.values)
            return ShardedQTensor(leaf(path + ("values",), q.values),
                                  leaf(path + ("scale",), q.scale), q.axis,
                                  vspec)
        return _map_with_path(leaf, tree, qtensor, path)

    # -- collectives ----------------------------------------------------
    def group_of(self, axes: Sequence[str]):
        return self.mesh.group(tuple(axes))

    def count(self, kind: str, axes: tuple, nbytes: int) -> None:
        """One call of collective `kind` over `axes` whose result holds
        `nbytes`, in ``collectives`` and ``collective_bytes``."""
        self.collectives[(kind, axes)] += 1
        self.collective_bytes[(kind, axes)] += int(nbytes)

    def all_reduce(self, x: torch.Tensor, op: str,
                   axes: Sequence[str]) -> torch.Tensor:
        """x reduced ("sum" or "max") over the ranks of `axes`, in place
        on a copy; returns it.  Counted even over a group of one."""
        axes = tuple(axes)
        self.count(f"all_reduce_{op}", axes, nbytes(x))
        out = x.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(out, op=red, group=self.group_of(axes))
        return out

    def all_gather(self, x: torch.Tensor, dim: int, axes: Sequence[str],
                   kind: str = "all_gather") -> torch.Tensor:
        """The ranks' x of `axes` concatenated along `dim`, in rank
        order (a byte copy: bf16, which gloo does not take, travels as
        its bytes), counted as `kind`."""
        axes = tuple(axes)
        n = self.mesh.axis_size(axes)
        self.count(kind, axes, n * nbytes(x))
        dim = dim % x.ndim
        src = x.contiguous()
        if src.dtype == torch.bfloat16:
            src = src.view(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group_of(axes))
        out = torch.cat(parts, dim=dim)
        return out.view(x.dtype) if out.dtype != x.dtype else out

    # -- differentiable collectives (module docstring) -------------------
    def _sum_(self, x: torch.Tensor, axes: tuple, kind: str) -> torch.Tensor:
        """SUM all-reduce of `x` in place over `axes`, counted as `kind`
        (a bf16 tensor over gloo summed in f32)."""
        self.count(kind, axes, nbytes(x))
        group = self.group_of(axes)
        if x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo":
            wide = x.to(torch.float32)
            dist.all_reduce(wide, group=group)
            return x.copy_(wide)
        dist.all_reduce(x, group=group)
        return x

    def copy_to(self, x: torch.Tensor, axes=("model",)) -> torch.Tensor:
        """"f": x itself forward; the gradient SUM-reduced over `axes`."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _CopyTo.apply(x, self, tuple(axes))

    def reduce_from(self, x: torch.Tensor, axes=("model",)) -> torch.Tensor:
        """"g": x SUM-reduced over `axes` (a new tensor, counted as
        "all_reduce_sum"); the gradient passes through."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _ReduceFrom.apply(x, self, tuple(axes))
        return self._sum_(x.clone(), tuple(axes), "all_reduce_sum")

    def gather_from(self, x: torch.Tensor, dim: int, axes=("model",),
                    kind: str = "all_gather") -> torch.Tensor:
        """The ranks' x of `axes` concatenated along `dim` (counted as
        `kind`); the gradient of the whole is replicated, so each rank
        keeps its slice."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _GatherFrom.apply(x, self, dim % x.ndim, tuple(axes),
                                     kind)
        return self.all_gather(x, dim, tuple(axes), kind)

    def scatter_to(self, x: torch.Tensor, dim: int,
                   axes=("model",)) -> torch.Tensor:
        """This rank's slice of a replicated x along `dim`; the slices'
        gradients are all-gathered into the whole's."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _ScatterTo.apply(x, self, dim % x.ndim, tuple(axes))
        lo, hi = self.local_range(tuple(axes), x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    def fsdp_gather(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """A zero-3 shard gathered whole along `dim` over `axes`
        ("fsdp_all_gather"); backward, the gradient's MEAN over `axes`,
        cut to this rank's shard ("fsdp_reduce_scatter_bwd")."""
        axes = tuple(axes)
        if torch.is_grad_enabled() and x.requires_grad:
            return _FsdpGather.apply(x, self, dim % x.ndim, axes)
        self.count("fsdp_all_gather", axes,
                   self.mesh.axis_size(axes) * nbytes(x))
        return self._gather(x, dim % x.ndim, axes)

    def _gather(self, x, dim, axes):
        n = self.mesh.axis_size(axes)
        src = x.contiguous()
        if src.dtype == torch.bfloat16:        # gloo takes no bf16
            src = src.view(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group_of(axes))
        out = torch.cat(parts, dim=dim)
        return out.view(x.dtype) if out.dtype != x.dtype else out

    def _reduce_scatter_mean(self, g, dim, axes):
        """g (whole) summed over `axes`, cut to this rank's slice along
        `dim`, divided by the axes' size.  NCCL: ``reduce_scatter_tensor``
        on the dim moved to the front; gloo, which has none: an
        all-reduce, then the slice."""
        n = self.mesh.axis_size(axes)
        self.count("fsdp_reduce_scatter_bwd", axes, nbytes(g) // n)
        group = self.group_of(axes)
        if dist.get_backend(group) == "gloo":
            whole = g.contiguous().clone()
            dist.all_reduce(whole, group=group)
            lo, hi = self.local_range(axes, g.shape[dim])
            return whole.narrow(dim, lo, hi - lo).div_(n)
        src = g.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.div_(n).movedim(0, dim).contiguous()

    def mean_(self, tensors: list, axes) -> None:
        """Each of `tensors` replaced in place by its MEAN over `axes`:
        one SUM all-reduce of their concatenation ("all_reduce_mean")."""
        axes = tuple(axes)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        self.count("all_reduce_mean", axes, nbytes(flat))
        dist.all_reduce(flat, group=self.group_of(axes))
        flat.div_(self.mesh.axis_size(axes))
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()

    # -- the train state ------------------------------------------------
    def use_params(self, params, specs):
        """The params a rank's layers compute with: each leaf gathered
        whole over the FSDP axes of its resolved spec (``fsdp_gather``),
        its ``spec`` attribute the spec that is left ("model" splits
        only), which ``gemm_split`` reads.  `specs`: the resolved spec
        tree of `params` (``shardings`` on the whole params).  Each
        layer of ``params["blocks"]`` stays a ``LayerParams``, gathered
        where the layer runs.  A QTensor (weight-gathered serving) comes
        back a ``ShardedQTensor`` with its values and scale gathered
        alike, its spec the values' that is left."""
        if isinstance(params, dict) and "blocks" in params:
            rest = self.use_params(
                {k: v for k, v in params.items() if k != "blocks"},
                {k: v for k, v in specs.items() if k != "blocks"})
            rest["blocks"] = [LayerParams(self, p, s) for p, s in
                              zip(params["blocks"], specs["blocks"])]
            return rest

        def one(x, spec):
            if isinstance(x, QTensor):
                values = one(x.values, spec["values"])
                return ShardedQTensor(values, one(x.scale, spec["scale"]),
                                      x.axis, values.spec)
            out = x
            for dim, axes in enumerate(spec):
                if axes is not None and self._is_fsdp(axes):
                    out = self.fsdp_gather(out, dim, _as_axes(axes))
            out = out.view_as(out) if out is x else out   # a new object
            out.spec = tuple(None if a is not None and self._is_fsdp(a)
                             else a for a in spec)
            return out
        from repro_torch.train.optimizer import tree_map
        return tree_map(one, params, specs)

    def _is_fsdp(self, axes) -> bool:
        return self.fsdp and set(_as_axes(axes)) <= {"data"}

    def unshard(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole tensor of a rank's slice `x` by its resolved spec:
        every sharded dim all-gathered over its axes (exact)."""
        for dim, axes in enumerate(spec):
            if axes is not None:
                x = self.all_gather(x, dim, _as_axes(axes),
                                    "unshard_all_gather")
        return x

    def whole_shape(self, shape, spec: tuple) -> tuple:
        """The whole tensor's shape of a slice of `shape` by `spec`."""
        return tuple(d * (self.mesh.axis_size(_as_axes(a)) if a else 1)
                     for d, a in zip(shape, spec)) + tuple(shape[len(spec):])

    def split_axes(self, spec: tuple) -> tuple[str, ...]:
        """The mesh axes that split a tensor of resolved `spec`, in the
        mesh's order."""
        used = {a for axes in spec if axes is not None
                for a in _as_axes(axes)}
        return tuple(a for a in self.all_axes if a in used)

    def batch_sharding(self, tree):
        """The resolved spec of every leaf of `tree` with its dim 0 over
        the batch axes (replicated where they do not divide it, and for
        scalars): the reference's ``batch_sharding``."""
        def one(_, x):
            shape = tuple(x.shape)
            if (not shape or not self.batch_axes
                    or shape[0] % self._axis_size(self.batch_axes)):
                return ()
            first = (self.batch_axes if len(self.batch_axes) > 1
                     else self.batch_axes[0])
            return (first,) + (None,) * (len(shape) - 1)
        return _map_with_path(one, tree)

    @property
    def batch_size(self) -> int:
        """The ranks that hold other rows of a batch."""
        return self._axis_size(self.batch_axes) if self.batch_axes else 1

    @property
    def tp(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return self.mesh.axis_names


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, axes):
        ctx.m, ctx.axes = m, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.m._sum_(g.clone(), ctx.axes, "all_reduce_sum_bwd"), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, axes):
        return m._sum_(x.clone(), axes, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, dim, axes, kind):
        ctx.m, ctx.dim, ctx.axes = m, dim, axes
        return m.all_gather(x, dim, axes, kind)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.m.local_range(ctx.axes, g.shape[ctx.dim])
        return g.narrow(ctx.dim, lo, hi - lo), None, None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, dim, axes):
        ctx.m, ctx.dim, ctx.axes = m, dim, axes
        lo, hi = m.local_range(axes, x.shape[dim])
        return x.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, g):
        m = ctx.m
        m.count("all_gather_bwd", ctx.axes,
                m.mesh.axis_size(ctx.axes) * nbytes(g))
        return m._gather(g, ctx.dim, ctx.axes), None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, dim, axes):
        ctx.m, ctx.dim, ctx.axes = m, dim, axes
        m.count("fsdp_all_gather", axes, m.mesh.axis_size(axes) * nbytes(x))
        return m._gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.m._reduce_scatter_mean(g, ctx.dim, ctx.axes), None, \
            None, None


class LayerParams:
    """One layer's params as the rank holds them, gathered whole by
    ``gather`` where the layer runs (``transformer._layer``).  Under
    remat that is inside the recomputed region, so a layer's gathered
    weights live while it runs its forward or its backward, not for the
    whole step (zero-3); the backward gathers them again."""

    __slots__ = ("mapping", "params", "specs")

    def __init__(self, mapping: "Mapping", params, specs):
        self.mapping, self.params, self.specs = mapping, params, specs

    def gather(self):
        return self.mapping.use_params(self.params, self.specs)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _as_axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _is_leaf_spec(t) -> bool:
    return all(e is None or isinstance(e, str) for e in t)


def _walk(spec_tree, path):
    """The spec node at `path`: entries with no matching key or index
    in the spec tree are skipped (one param-spec tree serves params and
    their optimizer moments), and a leaf spec reached early broadcasts
    downward."""
    node = spec_tree
    for entry in path:
        if isinstance(node, tuple) and _is_leaf_spec(node):
            break
        if isinstance(node, dict) and entry in node:
            node = node[entry]
        elif (isinstance(node, list) and isinstance(entry, int)
              and entry < len(node)):
            node = node[entry]
    return node


def _map_with_path(fn, tree, qfn=None, path=()):
    """fn(path, leaf) over the tensors of a tree of dicts, lists,
    tuples, QTensors and dataclasses (a QTensor's fields are path
    entries "values" and "scale"; ``qfn(path, qtensor)``, when given,
    maps a QTensor whole; an ``AdamWState``'s fields are entries too);
    anything else passes through."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, qfn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, qfn, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, QTensor):
        if qfn is not None:
            return qfn(path, tree)
        return {f: fn(path + (f,), getattr(tree, f))
                for f in QTENSOR_FIELDS}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        # an optimizer state (``AdamWState``): its fields are path entries
        return type(tree)(**{f.name: _map_with_path(
            fn, getattr(tree, f.name), qfn, path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor) or hasattr(tree, "shape"):
        return fn(path, tree)
    return tree


def gemm_split(w) -> GemmSplit | None:
    """The split of a GEMM against weight `w` ((K, N) or an (E, K, N)
    bank) under the current mapping; None with no mapping current.  The
    split is read from the weight's resolved ``spec``: a
    ``ShardedQTensor``'s, or the ``spec`` attribute that ``shard_tree``
    or ``Mapping.use_params`` gives a float weight.  A weight with
    neither (placed replicated) splits nothing, but its input's abs-max
    is still reduced over "data".  A bank whose expert dim lies on
    "model" holds this rank's experts (``expert``)."""
    m = current_mapping()
    if m is None:
        return None
    n = w.values.shape[-1] if isinstance(w, QTensor) else w.shape[-1]
    spec = getattr(w, "spec", ())
    if len(spec) < 2:
        return GemmSplit(m, n)
    if any(a not in (None, "model") for a in spec):
        raise ValueError(f"GEMM weight spec {spec}: only the 'model' axis "
                         "splits a GEMM; gather the FSDP axes first "
                         "(Mapping.use_params)")
    col, row = spec[-1] == "model", spec[-2] == "model"
    expert = len(spec) == 3 and spec[0] == "model"
    if col and row:
        raise ValueError(f"GEMM weight spec {spec} splits both dims")
    if not col:
        return GemmSplit(m, n, 0, row, expert=expert)
    return GemmSplit(m, n * m.tp, m.mesh.coords["model"] * n, row, True)


def serve_mapping(mesh, *, kv: str = "hd",
                  batch_axes: Sequence[str] = ("data",),
                  fsdp: bool = False) -> Mapping:
    """The sharded serving engine's mapping, the reference's preset:
    "tp"/"tp?"/"vocab"/"expert" on "model", and the decode cache laid
    out by `kv`:

      * "hd": the KV-head dim takes "model" when the TP size divides
        the KV-head count (attention stays whole per head: the sharded
        engine is bit-identical to one device); otherwise the head_dim
        does ("kv_hd", the fallback);
      * "seq": the cache's sequence dim takes "model" (sequence
        parallelism; the decode softmax reduces across shards:
        allclose, not bit-identical).  Pair it with
        ``ModelConfig.kv_onehot_write``.

    ``fsdp``: weight-gathered serving, the reference's ``serve_mapping``
    option: the weights' "fsdp" dims lie on "data" as well, and each
    layer's are gathered where it runs (``Mapping.use_params``; exact,
    so the streams keep their bits)."""
    if kv == "hd":
        return Mapping(mesh, fsdp=fsdp, batch_axes=batch_axes,
                       kv_hd_axis=("model",))
    if kv == "seq":
        return Mapping(mesh, fsdp=fsdp, batch_axes=batch_axes,
                       kv_seq_axis=("model",))
    raise ValueError(f"kv must be 'hd' or 'seq', got {kv!r}")


def train_state_specs(param_specs) -> dict:
    """Spec tree of a train state: params and their (param-shaped)
    optimizer moments share the param specs; the step replicates."""
    return {"params": param_specs, "opt": param_specs, "step": ()}


# ---------------------------------------------------------------------------
# the current mapping
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def activate(mapping: Mapping | None):
    """Make `mapping` current for the model code called inside (None:
    no mapping, the single-device path)."""
    _ACTIVE.append(mapping)
    try:
        yield mapping
    finally:
        _ACTIVE.pop()


def current_mapping() -> Mapping | None:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def batch_rows(axes):
    """Make `axes` (a resolved "batch" entry: mesh axes, or None) the
    axes the current call's batch rows lie on: ``transformer.prefill``
    and ``decode_step`` cut their inputs' rows by it, and the float
    parts that run whole on every rank (``whole``) gather the rows over
    it."""
    _ROWS.append(axes)
    try:
        yield axes
    finally:
        _ROWS.pop()


def row_axes():
    """The current call's batch-row axes (None: every rank holds every
    row, or no call under a mapping set them)."""
    return _ROWS[-1] if _ROWS else None


def whole(x: torch.Tensor, model_dim: int | None = None, *,
          rows: bool = True, row_dim: int = 0) -> torch.Tensor:
    """A rank's part of an activation or state made whole, exactly: its
    dim `model_dim` gathered over "model" (None: not split there) and,
    with `rows`, its batch rows (dim `row_dim`) over ``row_axes()``.
    The float parts whose bits depend on the shapes they run at (f32
    matmuls, reductions over a split dim, batched products) run on the
    whole tensor on every rank, as on one device, and keep their part
    (``own``).  The identity with no mapping current; an axis of one
    rank gathers nothing.

    Under autograd it is ``gather_from``: every rank runs the same
    whole computation, whose gradients are then whole and the same on
    every rank (``own``'s backward gathers them), so the backward keeps
    the rank's slice and needs no collective.  Its input's gradient is
    then exact whatever else the input feeds: a column-parallel GEMM
    behind "f", whose backward has already summed over "model", or a
    replicated leaf, which the train step sums over no "model" rank."""
    m = current_mapping()
    if m is None:
        return x
    for dim, axes in enumerate(_part_spec(x, model_dim, rows, row_dim)):
        if axes is not None and m.mesh.axis_size(_as_axes(axes)) > 1:
            x = m.gather_from(x, dim, _as_axes(axes))
    return x


def own(x: torch.Tensor, model_dim: int | None = None, *,
        rows: bool = True, row_dim: int = 0) -> torch.Tensor:
    """This rank's part of a whole `x` (``whole``'s inverse).  Under
    autograd its "model" part is ``scatter_to``: the parts' gradients
    are all-gathered ("all_gather_bwd"), so the whole computation behind
    `x` differentiates the whole gradient on every rank.  Its rows are a
    plain slice: rows do not mix in the whole computations, and a
    weight's gradient must hold this rank's rows alone, whose
    data-parallel MEAN the train step takes (a gather there would count
    every row on every data rank)."""
    m = current_mapping()
    if m is None:
        return x
    spec = _part_spec(x, model_dim, rows, row_dim)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return m.shard(x, spec)
    for dim, axes in enumerate(spec):
        if axes is None or m.mesh.axis_size(_as_axes(axes)) == 1:
            continue
        if axes == "model":
            x = m.scatter_to(x, dim, ("model",))
        else:
            lo, hi = m.local_range(_as_axes(axes), x.shape[dim])
            x = x.narrow(dim, lo, hi - lo)
    return x


def _part_spec(x, model_dim, rows: bool, row_dim: int) -> tuple:
    spec = [None] * x.ndim
    if rows and row_axes() is not None:
        spec[row_dim % x.ndim] = row_axes()
    if model_dim is not None:
        spec[model_dim % x.ndim] = "model"
    return tuple(spec)


def whole_weight(w: torch.Tensor) -> torch.Tensor:
    """A float weight gathered whole over the axes of its ``spec``
    attribute (exact; itself where nothing splits it, an axis of one
    rank included), counted as "weight_all_gather".  Under autograd the
    gradient of the whole weight is whole on every rank (``whole``), and
    the backward keeps the rank's slice; a leaf's data-parallel MEAN
    stays the FSDP gather's or the train step's."""
    m = current_mapping()
    spec = getattr(w, "spec", ())
    if m is None or not any(a is not None for a in spec):
        return w
    for dim, axes in enumerate(spec):
        if axes is not None and m.mesh.axis_size(_as_axes(axes)) > 1:
            w = m.gather_from(w, dim, _as_axes(axes), "weight_all_gather")
    return w


def lsc(x: torch.Tensor, *logical) -> torch.Tensor:
    """The logical sharding constraint: a whole tensor cut to the
    calling rank's slice by its logical axes; the identity with no
    mapping current."""
    m = current_mapping()
    if m is None:
        return x
    return m.shard(x, m.spec(logical, tuple(x.shape)))


def lsc_tree(tree: Any, spec_tree) -> Any:
    """Tree-wide ``lsc`` from a spec tree (params, a cache)."""
    m = current_mapping()
    if m is None:
        return tree
    return m.shard_tree(tree, spec_tree)
