"""A (data, model) grid of devices driven from one process (port of the
parts of repro.launch.mesh that are not TPU-specific).

The reference runs the fabric step under ``shard_map`` over a
``jax.sharding.Mesh``: C channels over ``data``, each channel's ingest and
world state over ``model``. Here a :class:`Mesh` is an explicit 2-D list
of ``torch.device``s, position (d, m) being data rank d and model rank m.
One controller runs every rank's work on its position's device, stage by
stage, and the collectives of the reference become copies between the
ranks of one data row (:meth:`Mesh.all_gather`, :meth:`Mesh.psum`,
:meth:`Mesh.permute`, :meth:`Mesh.all_to_all`) or of one model column
(:meth:`Mesh.column_gather`). Each collective adds the
bytes it delivers from one position to another to :attr:`Mesh.moved`, by
kind, counted from the shapes: positions that share a device count the
same bytes as positions on two cards; and one to :attr:`Mesh.calls` under
the reference's HLO name of its type (``all-gather``, ``all-reduce``,
``collective-permute``, ``all-to-all``), which the contract analysis
(repro_torch.analysis) holds against its budgets. The mesh LM
(``models.lm.MeshLM``) runs its layers over the same collectives.

A mesh holds the devices it is given. Positions share a device only where
the caller lists them so; :func:`from_cards` takes one card a position and
raises when there are fewer. Nothing falls back to fewer cards or to the
CPU.
"""

from __future__ import annotations

import collections

import torch

from repro_torch import canonical_device


class Mesh:
    """Devices on a (data, model) grid: ``devices[d][m]`` is rank (d, m)."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        rows = [[canonical_device(x) for x in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             f"devices, got {devices!r}")
        self.devices = tuple(tuple(r) for r in rows)
        self.shape = {"data": len(rows), "model": len(rows[0])}
        self.moved = collections.Counter()  # kind -> bytes between ranks
        self.calls = collections.Counter()  # collective type -> calls

    @property
    def dp_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def first(self) -> torch.device:
        """Rank (0, 0)'s device: where the orderer runs and where gathered
        results land."""
        return self.devices[0][0]

    def row(self, d: int) -> tuple:
        """The model ranks' devices of data rank ``d``."""
        return self.devices[d]

    def distinct(self) -> list:
        """The distinct devices, in rank order."""
        return list(dict.fromkeys(x for r in self.devices for x in r))

    def synchronize(self) -> None:
        """Wait for every card of the mesh."""
        for dev in self.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def __repr__(self) -> str:
        grid = [[str(x) for x in r] for r in self.devices]
        return f"Mesh({grid}, distinct={len(self.distinct())})"

    # -- collectives over one data row's model ranks --------------------------

    def all_gather(self, d: int, parts: list, dim: int, kind: str) -> list:
        """``parts[m]`` on rank (d, m)'s device -> on every rank of row
        ``d``, the parts concatenated along ``dim`` in rank order."""
        self._count(kind, parts, "all-gather")
        return [torch.cat([p.to(dev) for p in parts], dim=dim)
                for dev in self.row(d)]

    def psum(self, d: int, parts: list, kind: str) -> list:
        """``parts[m]`` on rank (d, m)'s device -> on every rank of row
        ``d``, their sum (OR for bool). The routed gathers send masked
        parts, each element non-zero on one rank at most, so the sum of
        u32 words held as int32 is exact."""
        self._count(kind, parts, "all-reduce")
        out = []
        for dev in self.row(d):
            acc = None
            for p in parts:
                q = p.to(dev)
                acc = q if acc is None else (
                    acc | q if q.dtype == torch.bool else acc + q)
            out.append(acc)
        return out

    def permute(self, d: int, parts: list, pairs: list, kind: str) -> list:
        """The reference's ``ppermute`` over row ``d``: for each (source,
        destination) rank pair, ``parts[source]`` onto the destination's
        device, at position ``destination`` of the result (None where no
        pair lands). Only the pairs between two ranks count as moved."""
        self.calls["collective-permute"] += 1
        out = [None] * len(parts)
        for src, dst in pairs:
            out[dst] = parts[src].to(self.row(d)[dst])
            if src != dst:
                self.moved[kind] += (parts[src].numel()
                                     * parts[src].element_size())
        return out

    def all_to_all(self, d: int, chunks: list, dim: int, kind: str) -> list:
        """``chunks[m][j]``, on rank (d, m)'s device, is what rank m sends
        to rank j -> on rank j's device, ``chunks[m][j]`` of every m
        concatenated along ``dim`` in rank order. Chunks may differ in size
        (a prompt shorter than the cache sends less to the last ranks);
        only those between two ranks count as moved."""
        self.calls["all-to-all"] += 1
        out = []
        for j, dev in enumerate(self.row(d)):
            out.append(torch.cat([c[j].to(dev) for c in chunks], dim=dim))
            self.moved[kind] += sum(c[j].numel() * c[j].element_size()
                                    for m, c in enumerate(chunks) if m != j)
        return out

    def column_gather(self, m: int, parts: list, dim: int, kind: str
                      ) -> list:
        """The all-gather over ``data``: ``parts[d]`` on rank (d, m)'s
        device -> on every rank of column ``m``, concatenated along ``dim``
        in rank order."""
        self._count(kind, parts, "all-gather")
        return [torch.cat([p.to(row[m]) for p in parts], dim=dim)
                for row in self.devices]

    def collect(self, parts: list, dim: int, kind: str) -> torch.Tensor:
        """``parts[d]`` on rank (d, 0) -> concatenated along ``dim`` on
        :attr:`first`: a result handed back to the caller, as the
        reference's unpinned ``out_shardings`` leave it, so no collective
        is counted; the bytes from other positions count under ``kind``."""
        first = self.first
        for p, row in zip(parts, self.devices):
            if row[0] != first:
                self.moved[kind] += p.numel() * p.element_size()
        return torch.cat([p.to(first) for p in parts], dim=dim)

    def _count(self, kind: str, parts: list, op: str) -> None:
        """Each part reaches the row's other ranks once."""
        n = len(parts)
        self.calls[op] += 1
        self.moved[kind] += (n - 1) * sum(p.numel() * p.element_size()
                                          for p in parts)


def from_cards(data: int, model: int) -> Mesh:
    """A (data, model) mesh with one card a position, ``cuda:{d * model +
    m}`` at (d, m). Raises when fewer cards are present than positions."""
    need = data * model
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {need} cards, "
                           f"{have} present")
    return Mesh([[torch.device("cuda", d * model + m) for m in range(model)]
                 for d in range(data)])


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axis names: the port's grid has no ``pod`` axis."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def dp_size(mesh: Mesh) -> int:
    return mesh.dp_size


def model_size(mesh: Mesh) -> int:
    return mesh.model_size
