"""The (data, space) mesh over ``torch.distributed`` ranks.

The port of ``sift3d_tpu/parallel/mesh.py``. JAX runs one controller over
a global ``Mesh(devices.reshape(data, space))``; the port runs one process
per rank, each holding one device, with the same layout:
``rank = d * space + s``.

- "data": independent volumes / registration pairs;
- "space": one volume split along a spatial axis, with halo exchange.

A rank works on its own block of each array, as JAX's ``shard_map`` body
sees it. The collectives of that body map onto ``torch.distributed`` calls
on the axis's process group: ``psum`` -> ``all_reduce(SUM)``, ``pmax`` ->
``all_reduce(MAX)``, ``all_gather`` -> ``all_gather``, ``axis_index`` ->
the rank's coordinate, ``ppermute`` -> ``batch_isend_irecv`` to the axis
neighbours (``exchange``). Booleans travel as uint8. The group is NCCL on
the card and gloo on the CPU (``init_distributed``); every process calls
``torch.distributed.destroy_process_group()`` before it exits.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..dtypes import resolve_device

def factor_devices(n: int, max_space: int = 4) -> tuple[int, int]:
    """Split n devices into (data, space) with space a small power of 2."""
    space = 1
    while space * 2 <= max_space and n % (space * 2) == 0:
        space *= 2
    return n // space, space


def _rank_device(dev: torch.device) -> torch.device:
    """This process's card (``LOCAL_RANK`` under ``torchrun``), or the
    CPU."""
    if dev.type != "cuda":
        return dev
    if "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    elif dev.index is not None:
        torch.cuda.set_device(dev.index)
    return torch.device("cuda", torch.cuda.current_device())


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     device=None) -> torch.device:
    """Join this process to the world of ranks; returns its device.

    NCCL on the card, gloo when ``device="cpu"``; with no card and no
    ``device="cpu"`` it raises, as every entry point does. With no
    ``init_method`` and one process (and no ``torchrun`` environment) it
    starts no group, as ``jax.distributed.initialize`` is skipped in JAX;
    ``make_mesh`` then makes a one-rank group. ``init_method`` is a
    ``torch.distributed`` URL (``tcp://host:port``, ``file:///path``); under
    ``torchrun`` leave it None (``env://``).
    """
    dev = _rank_device(resolve_device(device))
    if dist.is_initialized():
        return dev
    env = "WORLD_SIZE" in os.environ
    if init_method is None and world_size in (None, 1) and not env:
        return dev
    dist.init_process_group(
        _backend(dev), init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, space) mesh of ranks."""
    data: int
    space: int
    d: int                      # this rank's "data" coordinate
    s: int                      # this rank's "space" coordinate
    device: torch.device
    groups: dict                # axis name -> this rank's process group

    @property
    def shape(self) -> dict:
        return {"data": self.data, "space": self.space}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """``jax.lax.axis_index``: this rank's coordinate along ``axis``."""
        return self.d if axis == "data" else self.s

    def rank_at(self, axis: str, i: int) -> int:
        """The global rank of coordinate ``i`` along ``axis``, the other
        coordinate this rank's."""
        d, s = (i, self.s) if axis == "data" else (self.d, i)
        return d * self.space + s


def make_mesh(data: int | None = None, space: int | None = None,
              device=None) -> Mesh:
    """Build this rank's (data, space) mesh over the world of ranks.

    ``device`` as for ``init_distributed`` (None is the card). With no
    group started, a one-rank group is made, so that the collectives still
    go through ``torch.distributed``. Every rank calls ``new_group`` for
    every group of both axes, in the same order.
    """
    dev = _rank_device(resolve_device(device))
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                world_size=1, rank=0)
    if dist.get_backend() != _backend(dev):
        raise ValueError(f"a {dev.type} mesh needs the {_backend(dev)} "
                         f"backend, not {dist.get_backend()}")
    n = dist.get_world_size()
    if data is None or space is None:
        data, space = factor_devices(n)
    if data * space != n:
        raise ValueError(f"data*space = {data * space} != {n} ranks")
    d, s = divmod(dist.get_rank(), space)
    groups = {}
    for dd in range(data):
        g = dist.new_group([dd * space + ss for ss in range(space)])
        if dd == d:
            groups["space"] = g
    for ss in range(space):
        g = dist.new_group([dd * space + ss for dd in range(data)])
        if ss == s:
            groups["data"] = g
    return Mesh(data, space, d, s, dev, groups)


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device of an entry point's call over ``mesh``: ``device`` as
    every entry point resolves it (None is the card, and raises without
    one), which must be the kind the mesh is on."""
    dev = resolve_device(device)
    if mesh.device.type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device}, the call on {dev}")
    return mesh.device


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` fit for a collective (bool as uint8)."""
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def psum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``axis``."""
    out = _wire(t).clone()
    dist.all_reduce(out, dist.ReduceOp.SUM, group=mesh.groups[axis])
    return out


def pmax(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Elementwise max of ``t`` over the ranks of ``axis``."""
    out = _wire(t).clone()
    dist.all_reduce(out, dist.ReduceOp.MAX, group=mesh.groups[axis])
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(n, ...) stack of every rank's ``t`` along ``axis``, in coordinate
    order (same shape on every rank)."""
    w = _wire(t)
    out = [torch.empty_like(w) for _ in range(mesh.size(axis))]
    dist.all_gather(out, w, group=mesh.groups[axis])
    return torch.stack(out).to(t.dtype)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int) -> torch.Tensor:
    """Every rank's block of ``axis`` joined along ``dim``."""
    return torch.cat(list(all_gather(t, mesh, axis).unbind(0)), dim=dim)


def exchange(sends, recvs, mesh: Mesh, axis: str) -> None:
    """``ppermute``: send each (tensor, coordinate, tag) of ``sends`` and
    fill each (buffer, coordinate, tag) of ``recvs`` from the ranks at
    those coordinates along ``axis``, in one ``batch_isend_irecv``. A
    message's tag names it at both ends (NCCL ignores tags and keeps the
    order). An empty exchange does nothing: a rank with no neighbour takes
    no part."""
    group = mesh.groups[axis]
    ops = [dist.P2POp(dist.isend, t, mesh.rank_at(axis, c), group, tag=g)
           for t, c, g in sends]
    ops += [dist.P2POp(dist.irecv, t, mesh.rank_at(axis, c), group, tag=g)
            for t, c, g in recvs]
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_shift(tensors, mesh: Mesh, axis: str):
    """Each rank's tensors moved to the next coordinate along ``axis``
    (i -> i + 1 mod n); returns what arrives from the previous one."""
    n = mesh.size(axis)
    if n == 1:
        return list(tensors)
    i = mesh.index(axis)
    wires = [_wire(t) for t in tensors]
    bufs = [torch.empty_like(w) for w in wires]
    exchange([(w, (i + 1) % n, k) for k, w in enumerate(wires)],
             [(b, (i - 1) % n, k) for k, b in enumerate(bufs)], mesh, axis)
    return [b.to(t.dtype) for b, t in zip(bufs, tensors)]
