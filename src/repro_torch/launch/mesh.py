"""Device meshes over ``torch.distributed`` process groups (the H100
form of ``repro.launch.mesh``).

A ``Mesh`` is a grid of named axes ("data", "model", optionally "pod")
over the ranks of the default process group, rank-major in the order
of the axes (rank = data_index * tp + model_index on a (dp, tp) mesh,
the device order of ``jax.make_mesh``).  Each axis, and each set of
axes, has one process group per slice of the grid: ``Mesh.group``
returns the calling rank's.  A mesh built without a process group
(``Mesh.abstract``) carries only its shape, for spec resolution
(``dist.sharding.Mapping.spec``).

Nothing here picks a backend or a device: the caller initializes the
default group (``init_process_group`` with its backend, address, world
size and rank, or ``torchrun``'s environment), and a mesh whose size is
not the world size raises.

``make_production_mesh`` is the layout of one DGX H100 node (8 cards
on "model", tensor parallelism over NVLink) or of several nodes
(nodes on "data", over the network between them); with ``multi_pod``
a leading "pod" axis of 2 pods (the reference's multi-pod form: the
outer data-parallel dimension, whose gradient traffic crosses between
pods).  ``make_train_mesh`` is the trainer's mesh over whatever world
the launcher finds (``train_mesh_shape``).  The constants at the end
are the H100 SXM data sheet's.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch.distributed as dist


class Mesh:
    """Named axes over ranks 0 .. prod(shape) - 1 of the default group.

    shape: sizes per axis; axis_names: their names; rank: the calling
    rank (None for an abstract mesh).  ``coords[a]`` is the rank's index
    along axis a."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int | None = None, groups: dict | None = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self._groups = groups or {}
        if rank is None:
            self.coords = None
        else:
            idx, rest = {}, rank
            for a in reversed(self.axis_names):
                rest, idx[a] = divmod(rest, self.shape[a])
            self.coords = {a: idx[a] for a in self.axis_names}

    @classmethod
    def abstract(cls, shape, axis_names) -> "Mesh":
        """A mesh for spec resolution only: no rank, no groups."""
        return cls(shape, axis_names)

    def axis_index(self, axes: Sequence[str]) -> int:
        """The rank's index along `axes` taken together (row-major in
        the mesh's axis order), as a dimension sharded over them is cut."""
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def rank_at(self, **coords) -> int:
        """The global rank at the caller's coordinates, with those given
        replaced (e.g. ``rank_at(stage=0)``)."""
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + coords.get(a, self.coords[a])
        return rank

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share the caller's
        coordinates on every axis not in `axes`."""
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            raise ValueError(f"mesh {self.shape} has no group for {axes} "
                             f"(an abstract mesh has none)")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh over the default process group, which must hold exactly
    prod(shape) ranks.  Every rank creates every group, in one order
    (``torch.distributed.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(init_process_group, or run under torchrun)")
    world = dist.get_world_size()
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                         f"has {world}")
    axes = tuple(axes)
    rank = dist.get_rank()
    grid = list(itertools.product(*[range(s) for s in shape]))  # rank order
    groups = {}
    for r in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, r):
            fixed = [a for a in axes if a not in sub]
            slices: dict[tuple, list[int]] = {}
            for rk, coord in enumerate(grid):
                key = tuple(coord[axes.index(a)] for a in fixed)
                slices.setdefault(key, []).append(rk)
            for members in slices.values():
                g = (dist.group.WORLD if len(members) == world
                     else dist.new_group(members))
                if rank in members:
                    groups[sub] = g
    return Mesh(shape, axes, rank=rank, groups=groups)


def make_serve_mesh(*, dp: int = 1, tp: int | None = None) -> Mesh:
    """("data", "model") mesh for the sharded serving engine: `dp`
    replica groups x `tp` tensor-parallel shards.  `tp` defaults to the
    rest of the world; dp * tp must equal the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        if world % dp:
            raise ValueError(f"dp={dp} does not divide the {world} ranks")
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh ({dp}, {tp}) needs {dp * tp} ranks, the "
                         f"world has {world}")
    return make_mesh((dp, tp), ("data", "model"))


# the cards of one DGX/HGX H100 node: the most ranks tensor parallelism
# spans, as it stays inside a node's NVLink (``nn.attention`` fixes its
# decode chunks by it)
CARDS_PER_NODE = 8


def make_production_mesh(*, multi_pod: bool = False, nodes: int = 1,
                         cards_per_node: int = CARDS_PER_NODE) -> Mesh:
    """The documented H100 layout: each node's cards on "model" (tensor
    parallelism stays inside a node, over NVLink) and the nodes on
    "data"; ``multi_pod`` doubles the world into 2 pods on a leading
    "pod" axis, (2, nodes, 8) ("pod", "data", "model") — the reference's
    (2, 16, 16) on H100 nodes — whose mapping batches over ("pod",
    "data").  The layout is ``train_mesh_shape``'s; it needs (2 *) nodes
    * cards_per_node ranks."""
    world = nodes * cards_per_node * (2 if multi_pod else 1)
    shape = train_mesh_shape(world, multi_pod=multi_pod,
                             cards_per_node=cards_per_node)
    return make_mesh(shape, _train_axes(multi_pod))


def train_mesh_shape(world: int, *, multi_pod: bool = False,
                     cards_per_node: int = CARDS_PER_NODE) -> tuple:
    """The trainer's mesh for `world` ranks: gcd(world, cards_per_node)
    cards on "model" (tensor parallelism inside a node), the rest on
    "data"; with ``multi_pod`` the rest is split into 2 pods on a
    leading "pod" axis when it is even (1 pod otherwise).  One rank is
    (1, 1) or (1, 1, 1)."""
    tp = math.gcd(world, cards_per_node)
    rest = world // tp
    if not multi_pod:
        return (rest, tp)
    pods = 2 if rest % 2 == 0 else 1
    return (pods, rest // pods, tp)


def _train_axes(multi_pod: bool) -> tuple:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_train_mesh(*, multi_pod: bool = False) -> Mesh:
    """``train_mesh_shape`` over the default process group's world, on
    ("data", "model") or ("pod", "data", "model")."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(train_mesh_shape(world, multi_pod=multi_pod),
                     _train_axes(multi_pod))


# NVIDIA H100 SXM data sheet, per card (dense tensor-core peaks)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12          # the approx-MAC int8 path
HBM_BW = 3.35e12                 # bytes/s
HBM_BYTES = 80e9                 # device memory
# weight-gathered serving (``launch/dryrun.weight_gathered``): the
# weights are also sharded over "data" when their TP-sharded bf16 bytes
# pass half of one card's memory (the reference's 8 GiB of a TPU v5e's
# 16 GiB, restated for the H100)
FSDP_SERVE_BYTES = HBM_BYTES / 2
NVLINK_BW = 900e9                # bytes/s per card, all 18 links together
