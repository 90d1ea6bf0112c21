"""Wrapper of the MVCC validation kernel (``csrc/mvcc_validate.cu``).

A CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``ref.py``; there is no fallback between them. Two routes, both for any
block size: one CTA a block (``mvcc_kernel``, one launch) for blocks of at
most ``CTA_MAX_TXS`` txs, else the tiled route (``mvcc_conf_kernel`` over a
grid, then ``mvcc_scan_kernel``: two launches, with the conflict words in
a scratch buffer). :func:`validate_blocks` takes NB independent blocks in
those one or two launches. ``launches`` counts kernel launches,
``launches_by_device`` the same by device (``"cuda:1"``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core import u32
from repro_torch.kernels import build
from repro_torch.kernels.mvcc_validate import ref

ROUTES = ("cta", "tiled")
# The one-CTA route up to here: its all-pairs phase on one SM grows as B^2,
# and on an H100 it is the faster route at 160 txs and the slower at 192
# (RK = WK = 2, each route forced; chip_smoke.py's route lines).
CTA_MAX_TXS = 160
launches = 0
launches_by_device = collections.Counter()


@functools.cache
def _c_size(fn: str, n_args: int):
    """A size function of the library taking ``n_args`` ints."""
    f = getattr(build.libraries()["mvcc_validate"], fn)
    f.argtypes = [ctypes.c_int] * n_args
    f.restype = ctypes.c_longlong
    return f


def smem_bytes(b: int, nr: int, nw: int) -> int:
    """Dynamic shared memory of one block's one-CTA launch on the card: the
    keys, the conflict words (one per (chunk, tx)) and the ok words."""
    return _c_size("mvcc_validate_smem", 3)(b, nr, nw)


@functools.cache
def _smem_limit(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def fits_one_cta(b: int, nr: int, nw: int, device: torch.device) -> bool:
    """Whether a block's keys and conflict words fit one thread block's
    shared memory on ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return smem_bytes(b, nr, nw) <= _smem_limit(index)


def route_for(b: int, nr: int, nw: int, device: torch.device) -> str:
    """The route a block takes on ``device``: ``"cta"`` for at most
    ``CTA_MAX_TXS`` txs whose keys and conflict words fit one thread
    block's shared memory, else ``"tiled"``."""
    return ("cta" if b <= CTA_MAX_TXS and fits_one_cta(b, nr, nw, device)
            else "tiled")


def validate(read_keys, read_vers, write_keys, current_versions, ok0, *,
             route: str | None = None):
    """One block: (B,RK,2),(B,RK),(B,WK,2),(B,RK),(B,) bool -> (B,) bool;
    :func:`validate_blocks` with NB = 1."""
    return validate_blocks(read_keys[None], read_vers[None], write_keys[None],
                           current_versions[None], ok0[None], route=route)[0]


def validate_blocks(read_keys, read_vers, write_keys, current_versions, ok0,
                    *, route: str | None = None):
    """NB independent blocks in one call: (NB,B,RK,2), (NB,B,RK),
    (NB,B,WK,2), (NB,B,RK), (NB,B) bool -> (NB,B) bool, each block validated
    on its own. On the card it is one launch on the one-CTA route and two
    on the tiled route, for any NB.

    ``route`` ("cta" or "tiled") overrides the choice by shape on the card,
    so that tests can hold each route against the plain version at any
    size; the one-CTA route still needs the shape to fit, and a shape that
    does not is refused with a ValueError."""
    global launches
    dev = read_keys.device
    nblk, b, nr, _ = read_keys.shape
    nw = write_keys.shape[2]
    build.check("read_keys", read_keys, u32.WORD, (nblk, b, nr, 2), dev)
    build.check("read_vers", read_vers, u32.WORD, (nblk, b, nr), dev)
    build.check("write_keys", write_keys, u32.WORD, (nblk, b, nw, 2), dev)
    build.check("current_versions", current_versions, u32.WORD,
                (nblk, b, nr), dev)
    build.check("ok0", ok0, torch.bool, (nblk, b), dev)
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r}: expected one of {ROUTES}")
    if not build.dispatch(dev):
        return ref.validate_blocks_ref(read_keys, read_vers, write_keys,
                                       current_versions, ok0)
    valid = torch.empty((nblk, b), dtype=torch.bool, device=dev)
    if nblk * b == 0:
        return valid
    if route == "cta" and not fits_one_cta(b, nr, nw, dev):
        raise ValueError(
            f"route 'cta': a block of {b} txs with RK={nr}, WK={nw} needs "
            f"{smem_bytes(b, nr, nw)} bytes of shared memory, more than one "
            f"thread block has on {dev}")
    route = route or route_for(b, nr, nw, dev)
    ptrs = [t.data_ptr() for t in (read_keys, read_vers, write_keys,
                                   current_versions, ok0, valid)]
    if route == "cta":
        f = build.c_function("mvcc_validate", "mvcc_validate", 6, 4)
        build.launch(f, "mvcc_validate", dev, *ptrs, nblk, b, nr, nw)
        launches += 1
        launches_by_device[str(dev)] += 1
        return valid
    scratch = torch.empty(
        (nblk * _c_size("mvcc_validate_scratch_words", 1)(b),),
        dtype=u32.WORD, device=dev)
    f = build.c_function("mvcc_validate", "mvcc_validate_tiled", 7, 4)
    build.launch(f, "mvcc_validate_tiled", dev, *ptrs, scratch.data_ptr(),
                 nblk, b, nr, nw)
    launches += 2
    launches_by_device[str(dev)] += 2
    return valid
