"""Marshal / unmarshal: the wire format and the P-III unmarshal cache (port
of repro.core.unmarshal).

A marshaled transaction is a row of u8 wire bytes. Decoding is a byte->u32
reinterpretation plus field slicing, and an integrity pass: an FNV chain
over every payload word checked against the header checksum, so decode cost
scales with payload size as protobuf parsing does. Opt O-I ships only the
structured prefix (:func:`struct_prefix_words`) through consensus, decoded
by :func:`unmarshal_prefix`.

Wire layout per transaction, in u32 words (little-endian bytes):
  [0:2] tx_id   [2] client   [3] channel   [4] payload checksum
  [5:5+RK*3]    read_keys (RK,2) + read_vers (RK)
  [...]         write_keys (WK,2) + write_vals (WK,VW)
  [...]         endorse_tags (NE)
  [rest]        opaque application payload
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing, types, u32

_CHECK_SEED = 0x811C9DC5
_FIELDS = ("tx_id", "client", "channel", "read_keys", "read_vers",
           "write_keys", "write_vals", "endorse_tags")


def _layout(dims: types.FabricDims) -> dict:
    """Word offsets (start, end) of each field group."""
    sizes = (("tx_id", 2), ("client", 1), ("channel", 1), ("checksum", 1),
             ("read_keys", dims.rk * 2), ("read_vers", dims.rk),
             ("write_keys", dims.wk * 2), ("write_vals", dims.wk * dims.vw),
             ("endorse_tags", dims.ne))
    o, pos = {}, 0
    for name, n in sizes:
        o[name] = (pos, pos + n)
        pos += n
    o["opaque"] = (pos, dims.payload_words)
    return o


# Word index of the header checksum, in the dims-independent header prefix.
CHECKSUM_WORD: int = _layout(types.FabricDims())["checksum"][0]


def payload_checksum(words: torch.Tensor) -> torch.Tensor:
    """FNV chain over the words after the checksum: (B, P) -> (B,)."""
    return hashing.hash_words(words[:, CHECKSUM_WORD + 1:], seed=_CHECK_SEED)


def marshal(txb: types.TxBatch, dims: types.FabricDims, *, fill_seed: int = 1
            ) -> torch.Tensor:
    """TxBatch -> wire bytes (B, 4*payload_words) u8."""
    b = txb.batch
    dev = txb.tx_id.device
    lay = _layout(dims)
    words = torch.zeros((b, dims.payload_words), dtype=u32.WORD, device=dev)
    for name in _FIELDS:
        s, e = lay[name]
        words[:, s:e] = getattr(txb, name).reshape(b, e - s)
    # Opaque application body: pseudo-random filler the committer must still
    # checksum, as protobuf must walk unparsed submessages.
    s, e = lay["opaque"]
    if e > s:
        idx = torch.arange(b * (e - s), dtype=u32.WORD, device=dev)
        words[:, s:e] = hashing.hash_u32(u32.add(idx, fill_seed)).reshape(
            b, e - s)
    words[:, CHECKSUM_WORD] = payload_checksum(words)
    return words.view(torch.uint8)


def wire_words(wire: torch.Tensor) -> torch.Tensor:
    """(B, 4P) u8 -> (B, P) u32 words, a view (little-endian, as the JAX
    bitcast): the wire must be contiguous."""
    return wire.contiguous().view(u32.WORD)


def struct_prefix_words(dims: types.FabricDims) -> int:
    """Words of the structured prefix (header with checksum, read/write sets
    and tags): what Opt O-I ships through consensus instead of the wire."""
    return _layout(dims)["endorse_tags"][1]


class Unmarshaled(NamedTuple):
    txb: types.TxBatch
    checksum_ok: torch.Tensor  # (B,) bool


def _field(words: torch.Tensor, lay: dict, dims: types.FabricDims,
           name: str) -> torch.Tensor:
    """One field of every transaction, a view into the (B, P) words."""
    b = words.shape[0]
    s, e = lay[name]
    shape = {"tx_id": (2,), "read_keys": (dims.rk, 2),
             "read_vers": (dims.rk,), "write_keys": (dims.wk, 2),
             "write_vals": (dims.wk, dims.vw),
             "endorse_tags": (dims.ne,)}.get(name)
    return words[:, s:e].reshape(b, *shape) if shape else words[:, s]


def unmarshal(wire: torch.Tensor, dims: types.FabricDims) -> Unmarshaled:
    """Wire bytes -> TxBatch (views into the wire) + integrity flag."""
    words = wire_words(wire)
    lay = _layout(dims)
    txb = types.TxBatch(*(_field(words, lay, dims, name)
                          for name in _FIELDS))
    ok = payload_checksum(words) == words[:, CHECKSUM_WORD]
    return Unmarshaled(txb=txb, checksum_ok=ok)


def unmarshal_prefix(words: torch.Tensor, dims: types.FabricDims
                     ) -> types.TxBatch:
    """TxBatch (views) of (B, >= struct_prefix_words) u32 rows: the prefix,
    or a whole row, which begins with it. No integrity pass: the opaque
    body is absent, and its checksum was checked where it was ingested."""
    lay = _layout(dims)
    return types.TxBatch(*(_field(words, lay, dims, name)
                           for name in _FIELDS))


class UnmarshalCache:
    """P-III: cyclic buffer of decoded blocks, sized to the pipeline depth.

    A block's slot is ``block_no % depth``; a slot is overwritten only after
    its block left the pipeline. Host-side bookkeeping; the decoded tensors
    stay on their device."""

    def __init__(self, depth: int):
        self.depth = depth
        self._slots: list[Unmarshaled | None] = [None] * depth
        self._tags: list[int | None] = [None] * depth
        self.hits = 0
        self.misses = 0

    def get(self, block_no: int, wire: torch.Tensor, dims: types.FabricDims
            ) -> Unmarshaled:
        slot = block_no % self.depth
        if self._tags[slot] == block_no:
            self.hits += 1
            return self._slots[slot]
        self.misses += 1
        dec = unmarshal(wire, dims)
        self.put(block_no, dec)
        return dec

    def put(self, block_no: int, dec: Unmarshaled) -> None:
        slot = block_no % self.depth
        self._slots[slot] = dec
        self._tags[slot] = block_no

    def evict(self, block_no: int) -> None:
        slot = block_no % self.depth
        if self._tags[slot] == block_no:
            self._tags[slot] = None
            self._slots[slot] = None


def write_sets(wire: torch.Tensor, dims: types.FabricDims):
    """The write keys (B, WK, 2) and values (B, WK, VW) of a block, views
    into the wire with no integrity pass: all that the state journal and
    the chain replay read of a block whose checksums were already checked
    at commit."""
    words, lay = wire_words(wire), _layout(dims)
    return (_field(words, lay, dims, "write_keys"),
            _field(words, lay, dims, "write_vals"))
