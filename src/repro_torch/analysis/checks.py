"""Program checks: contract clauses over one recorded call of a program
(port of repro.analysis.checks).

The reference compiles each program and reads its HLO. A torch program has
no artifact to read, so the port runs it: once as a warm-up (the first
call on a card builds the kernels), then once under :class:`Recorder`, a
``TorchDispatchMode`` that sees every aten op the call dispatches, the
torch counterpart of reading the compiled program. Beside it the program's
:class:`~repro_torch.launch.mesh.Mesh` counts its collectives by type. On a
card the recorded call also runs under
``torch.cuda.set_sync_debug_mode("error")``.

Clause by clause, what is read:

  * collectives / wire bytes -- the mesh's ``calls`` and ``moved``
    counters across the call (each ``all_gather``, ``psum`` and
    ``permute`` is one call of its type, as one collective instruction of
    the reference's HLO).
  * commit passes -- the ops that write into a table field's storage
    (``index_put_``, ``copy_``, ... by their schema's write alias), counted
    per table: keys, versions and values written once each make one pass.
  * host syncs -- ``_local_scalar_dense`` (``.item()``, ``int()``,
    ``bool()`` of a tensor), ops whose output size hangs on the data
    (``nonzero``, boolean-mask indexing, ``masked_select``, ``unique``) and
    copies from a card to the CPU; on a card, whatever the sync debug mode
    refuses.
  * dtypes -- every op's non-scalar results (f64, u64), and the tensors
    the program takes and returns (s64).
  * in place -- the donated fields' storage before and after the call, and
    ops that copy a table (``clone``, ``cat``, a functional ``index_put``,
    ...) into a fresh tensor of its shape and dtype.

Every check returns a list of :class:`Violation`; empty means the clause
holds. The gate composes them; the tests seed one defect at a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

DTYPE_NAMES = {torch.float64: "f64", torch.int64: "s64", torch.uint64: "u64"}

# Ops that hand a device value to the host, or size their result by the
# data (the card must finish before the host learns the size).
_SYNC_OPS = {
    "aten::_local_scalar_dense": "a device value read on the host "
                                 "(.item(), int() or bool() of a tensor)",
    "aten::nonzero": "nonzero sizes its result by the data",
    "aten::masked_select": "masked_select sizes its result by the data",
    "aten::_unique": "unique sizes its result by the data",
    "aten::_unique2": "unique sizes its result by the data",
    "aten::unique_dim": "unique sizes its result by the data",
    "aten::unique_consecutive": "unique sizes its result by the data",
    "aten::equal": "equal returns a host bool",
}
_INDEX_OPS = {"aten::index", "aten::index_put", "aten::index_put_",
              "aten::_index_put_impl", "aten::_index_put_impl_"}
_D2H_OPS = {"aten::_to_copy", "aten::copy_", "aten::_copy_from",
            "aten::_copy_from_and_resize"}
# Ops that can copy a table into a fresh tensor of its shape.
_COPY_OPS = {"aten::clone", "aten::_to_copy", "aten::copy", "aten::cat",
             "aten::stack", "aten::index_put", "aten::_index_put_impl",
             "aten::scatter", "aten::index_copy", "aten::masked_scatter",
             "aten::where"}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract clause, named so that the gate's message tells
    the reader which program and which clause of ``contracts.json`` to look
    at."""

    program: str
    clause: str  # e.g. "collectives.all-gather", "donation.aliasing"
    message: str

    def __str__(self) -> str:
        return f"{self.program}: [{self.clause}] {self.message}"


# ---------------------------------------------------------------------------
# Storage extents
# ---------------------------------------------------------------------------


def extent(t: torch.Tensor) -> tuple:
    """(device, first byte, one past the last byte) a tensor's elements
    span in its storage."""
    lo = t.data_ptr()
    if t.numel() == 0:
        return str(t.device), lo, lo
    span = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return str(t.device), lo, lo + (span + 1) * t.element_size()


def overlaps(a: tuple, b: tuple) -> bool:
    return a[0] == b[0] and a[1] < b[2] and b[1] < a[2]


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# The recording mode
# ---------------------------------------------------------------------------


class Recorder(TorchDispatchMode):
    """Sees every aten op dispatched inside it and keeps what the checks
    read: the op count, non-scalar results by dtype, host syncs, the
    extents each op wrote, and the copies that may be of a table."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        self.dtype_ops = collections.Counter()  # dtype name -> ops
        self.syncs: list[str] = []
        self.writes: list[tuple] = []  # extents written
        self.copies: list[tuple] = []  # (op, shape, dtype, input extents)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        meta = _META.get(func)
        if meta is None:
            meta = _META[func] = _op_meta(func)
        name, writes, fresh = meta
        self._note_sync(name, args, kwargs)
        # Writes are noted before the call: the extent an op was handed is
        # the one it writes into.
        for i, key in writes:
            val = args[i] if i < len(args) else kwargs.get(key)
            if isinstance(val, torch.Tensor):
                self.writes.append(extent(val))
            elif isinstance(val, (list, tuple)):
                self.writes += [extent(t) for t in val
                                if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        self.n_ops += 1
        results = out if isinstance(out, (tuple, list)) else (out,)
        seen = {DTYPE_NAMES[t.dtype] for t in results
                if isinstance(t, torch.Tensor) and t.dim() > 0
                and t.dtype in DTYPE_NAMES}
        for dt in seen:
            self.dtype_ops[dt] += 1
        if fresh:
            ins = [extent(t) for t in _tensors((args, kwargs))]
            self.copies += [(name, tuple(results[i].shape),
                             results[i].dtype, ins) for i in fresh
                            if isinstance(results[i], torch.Tensor)]
        return out

    def _note_sync(self, name, args, kwargs) -> None:
        if name in _SYNC_OPS:
            self.syncs.append(f"{name}: {_SYNC_OPS[name]}")
        elif name in _INDEX_OPS:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(t is not None and t.dtype in (torch.bool, torch.uint8)
                   for t in idx):
                self.syncs.append(f"{name}: boolean-mask indexing sizes "
                                  "its result by the data")
        elif (name == "aten::repeat_interleave"
              and kwargs.get("output_size") is None
              and (len(args) == 1 or isinstance(args[1], torch.Tensor))):
            # .Tensor(repeats) or .self_Tensor(self, repeats): the output
            # size is the repeats' sum.
            self.syncs.append(f"{name}: tensor repeats without output_size")
        elif name in _D2H_OPS:
            if name == "aten::_to_copy":
                src, dst = args[0], kwargs.get("device")
                dst = torch.device(dst) if dst is not None else src.device
            elif name == "aten::copy_":
                dst, src = args[0].device, args[1]
            else:  # _copy_from(self, dst): self is the source
                src, dst = args[0], args[1].device
            if dst.type == "cpu" and src.device.type != "cpu":
                self.syncs.append(f"{name}: a copy from {src.device} to "
                                  "the CPU")


_META: dict = {}


def _op_meta(func) -> tuple:
    """(name, the (position, name) of each argument the op writes, the
    positions of its fresh results when it may copy a table) of an op,
    from its schema."""
    schema = func._schema
    writes = [(i, a.name) for i, a in enumerate(schema.arguments)
              if a.alias_info is not None and a.alias_info.is_write]
    fresh = ([i for i, r in enumerate(schema.returns) if r.alias_info is None]
             if schema.name in _COPY_OPS else [])
    return schema.name, writes, fresh


@contextlib.contextmanager
def cuda_sync_guard(devices):
    """``torch.cuda.set_sync_debug_mode("error")`` around the block when
    any of ``devices`` is a card: a synchronizing CUDA call raises."""
    if not any(torch.device(d).type == "cuda" for d in devices):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ---------------------------------------------------------------------------
# Clauses
# ---------------------------------------------------------------------------


def check_collectives(name: str, contract: dict, measured: dict
                      ) -> list[Violation]:
    """Calls of each collective type against the budget map. Types not
    named in the budget have budget 0; budgets are ceilings."""
    budget = contract.get("collectives")
    out: list[Violation] = []
    if budget is None:
        return out
    for op, count in sorted((measured.get("collectives") or {}).items()):
        allowed = budget.get(op, 0)
        if count > allowed:
            out.append(Violation(
                name, f"collectives.{op}",
                f"{count:g} {op} calls, budget {allowed} -- amend "
                f"contracts.json [programs.{name}.collectives.{op}] if this "
                "is intended"))
    max_wire = contract.get("max_wire_bytes")
    wire = measured.get("collective_wire_bytes", 0.0)
    if max_wire is not None and wire > max_wire:
        out.append(Violation(
            name, "collectives.wire_bytes",
            f"{wire:.3e} collective bytes a position, budget "
            f"{max_wire:.3e}"))
    return out


def table_passes(writes: list, tables: list) -> dict:
    """label -> commit passes into that table: the writes whose extent
    meets each of its fields, summed over the fields and divided by their
    number."""
    out = {}
    for label, fields in tables:
        n = sum(1 for f in fields.values() for ext in writes
                if overlaps(ext, extent(f)))
        out[label] = n / len(fields)
    return out


def check_commit_passes(name: str, contract: dict, passes: dict
                        ) -> list[Violation]:
    want = contract.get("commit_scatter_passes")
    if want is None:
        return []
    bad = {k: v for k, v in passes.items() if v != want}
    if not bad:
        return []
    return [Violation(
        name, "commit_scatter_passes",
        f"commit passes a call {sorted(set(bad.values()))} into "
        f"{len(bad)} of {len(passes)} tables (e.g. {next(iter(bad))}), "
        f"contract requires exactly {want} (the fused window commit pays "
        "ONE pass whatever the depth)")]


def check_host_syncs(name: str, contract: dict, syncs: list
                     ) -> list[Violation]:
    """No host sync inside a program: each one stalls the host until the
    device has drained, so the step cannot be queued ahead or captured."""
    if not contract.get("forbid_host_callbacks", False) or not syncs:
        return []
    first = list(dict.fromkeys(syncs))
    return [Violation(
        name, "forbidden_ops.host_sync",
        f"{len(syncs)} host sync(s) inside the program: "
        + "; ".join(first[:4]) + (" ..." if len(first) > 4 else ""))]


def check_dtypes(name: str, contract: dict, dtype_ops: dict,
                 io_dtypes: dict) -> list[Violation]:
    out = []
    for dt in contract.get("forbidden_dtypes") or ():
        if dtype_ops.get(dt):
            out.append(Violation(
                name, f"forbidden_dtypes.{dt}",
                f"{dtype_ops[dt]} op(s) with a non-scalar {dt} result in "
                "the program (dtype widening on the hot path)"))
    for dt in contract.get("forbidden_io_dtypes") or ():
        if io_dtypes.get(dt):
            out.append(Violation(
                name, f"forbidden_io_dtypes.{dt}",
                f"{io_dtypes[dt]} tensor(s) of {dt} taken or returned by "
                "the program"))
    return out


def check_donation(name: str, contract: dict, donated: list,
                   copies: list) -> list[Violation]:
    """Every donated state field must come back in the storage it went in
    with, and no op may copy a table into a fresh tensor: either is the
    program paying a full table write the in-place commit saves."""
    don = contract.get("donation")
    if don is None:
        return []
    if not donated:
        return [Violation(
            name, "donation.missing",
            "contract expects donated inputs but the program names none")]
    kept = [lbl for lbl, same in donated if same]
    frac = len(kept) / len(donated)
    want = float(don.get("min_aliased_fraction", 1.0))
    out = []
    if frac < want:
        moved = [lbl for lbl, same in donated if not same]
        out.append(Violation(
            name, "donation.aliasing",
            f"only {len(kept)}/{len(donated)} donated fields came back in "
            f"place (need >= {want:.0%}); {moved[:4]} came back in new "
            "storage"))
    if copies:
        out.append(Violation(
            name, "donation.copy",
            f"{len(copies)} table-sized copies inside the call: "
            + "; ".join(f"{op} -> {list(shape)}" for op, shape in copies[:4])))
    return out


# ---------------------------------------------------------------------------
# One program, one recorded call
# ---------------------------------------------------------------------------


def _table_copies(copies: list, tables: list) -> list:
    """The recorded copies that read a table and give a fresh tensor of a
    table field's shape and dtype (one table's, or the stacked channels')."""
    fields = [t for _, f in tables for t in f.values()]
    shapes = {(tuple(t.shape), t.dtype) for t in fields} | {
        (tuple(t._base.shape), t.dtype) for t in fields if t._base is not None}
    exts = [extent(t) for t in fields]
    return [(op, shape) for op, shape, dt, ins in copies
            if (shape, dt) in shapes
            and any(overlaps(i, e) for i in ins for e in exts)]


def _sync_site(err: BaseException) -> str:
    """The innermost frame of the program's own code (not torch's, not
    this package's) in a traceback."""
    import traceback

    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "/torch/" not in f.filename and "/analysis/" not in f.filename]
    if not frames:
        return "inside torch"
    f = frames[-1]
    return f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno} {f.name}"


def run_program(built, *, on_record=None) -> dict:
    """Warm-up call, then the recorded call of ``built`` (a
    :class:`~repro_torch.analysis.registry.BuiltProgram`); ``on_record()``
    runs just before the recorded call (a caller zeroes its launch counts
    there). Returns the measurements the clauses read, under the
    reference's report names."""
    out = built.fn(*built.args)
    args = built.again(out) if built.again is not None else built.args
    devices = {t.device for t in _tensors(args)}
    mesh = built.mesh
    calls0 = collections.Counter(mesh.calls) if mesh is not None else None
    moved0 = collections.Counter(mesh.moved) if mesh is not None else None
    tables = built.tables(args) if built.tables is not None else []
    before = built.donated(args) if built.donated is not None else []
    ptrs = [(lbl, t.data_ptr()) for lbl, t in before]
    rec = Recorder()
    cuda_error = None
    if on_record is not None:
        on_record()
    with rec:
        try:
            with cuda_sync_guard(devices):
                res = built.fn(*args)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            cuda_error = f"{str(e).splitlines()[0]} at {_sync_site(e)}"
            res = None
    if res is not None:
        after = dict(built.donated_out(res)) if built.donated_out else {}
        donated = [(lbl, lbl in after and after[lbl].data_ptr() == p)
                   for lbl, p in ptrs]
    else:
        donated = [(lbl, True) for lbl, _ in ptrs]
    io = collections.Counter(
        DTYPE_NAMES[t.dtype] for t in _tensors((args, res))
        if t.dtype in DTYPE_NAMES)
    measured = {
        "collectives": dict(mesh.calls - calls0) if mesh is not None else {},
        "moved_bytes": dict(mesh.moved - moved0) if mesh is not None else {},
        "ops": rec.n_ops,
        "dtype_ops": {k: rec.dtype_ops.get(k, 0) for k in ("f64", "s64",
                                                           "u64")},
        "io_dtypes": dict(io),
        "host_syncs": rec.syncs + ([f"cuda: {cuda_error}"]
                                   if cuda_error else []),
        "donated_fields": len(donated),
        "in_place_fields": sum(1 for _, same in donated if same),
        "donated": donated,
        "table_copies": _table_copies(rec.copies, tables),
    }
    positions = (mesh.model_size * mesh.dp_size) if mesh is not None else 1
    measured["collective_wire_bytes"] = (
        sum(measured["moved_bytes"].values()) / positions)
    if built.tables is not None:
        measured["table_passes"] = table_passes(rec.writes, tables)
        vals = sorted(set(measured["table_passes"].values()))
        measured["commit_scatter_passes"] = vals[0] if len(vals) == 1 else vals
    return measured


def check_measured(name: str, contract: dict, measured: dict
                   ) -> list[Violation]:
    """Every clause of ``contract`` over one program's measurements."""
    out = check_collectives(name, contract, measured)
    if "table_passes" in measured:
        out += check_commit_passes(name, contract, measured["table_passes"])
    out += check_host_syncs(name, contract, measured["host_syncs"])
    out += check_dtypes(name, contract, measured["dtype_ops"],
                        measured["io_dtypes"])
    out += check_donation(name, contract, measured["donated"],
                          measured["table_copies"])
    return out


def summary(measured: dict) -> dict:
    """The JSON-safe part of a program's measurements, for the report."""
    keep = ("collectives", "moved_bytes", "collective_wire_bytes", "ops",
            "dtype_ops", "io_dtypes", "host_syncs", "donated_fields",
            "in_place_fields", "commit_scatter_passes")
    out = {k: measured[k] for k in keep if k in measured}
    out["table_copies"] = [list(map(str, c)) for c in measured["table_copies"]]
    return out
