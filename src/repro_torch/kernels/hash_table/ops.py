"""Wrappers of the hash-table kernels (``csrc/hash_table.cu``): the probe
and the sequential commit.

A CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``ref.py``; there is no fallback between them. ``launches`` counts probe
launches and ``commit_launches`` commit launches, and
``launches_by_device`` / ``commit_launches_by_device`` the same by device
(``"cuda:1"``). The probe is one kernel
for every shape (a group of lanes a query; 16-byte value loads at VW = 4),
and so is the commit (``commit_runs_kernel``: each bucket's run of writes
applied with its row in registers, or walked in memory when S > 32).
"""

from __future__ import annotations

import collections

import torch

from repro_torch.core import u32
from repro_torch.kernels import build
from repro_torch.kernels.hash_table import ref

launches = 0
commit_launches = 0
launches_by_device = collections.Counter()
commit_launches_by_device = collections.Counter()


def _check_table(tkeys, tvers, tvals, dev):
    nb, s, vw = tvals.shape
    if nb & (nb - 1):
        raise ValueError(f"n_buckets={nb} must be a power of two")
    build.check("tkeys", tkeys, u32.WORD, (nb, s, 2), dev)
    build.check("tvers", tvers, u32.WORD, (nb, s), dev)
    build.check("tvals", tvals, u32.WORD, (nb, s, vw), dev)
    return nb, s, vw


def lookup(tkeys, tvers, tvals, queries):
    """Probe (Q, 2) paired keys: (found (Q,) bool, versions (Q,),
    values (Q, VW), slots (Q,) int32)."""
    global launches
    dev = queries.device
    nb, s, vw = _check_table(tkeys, tvers, tvals, dev)
    q = queries.shape[0]
    build.check("queries", queries, u32.WORD, (q, 2), dev)
    if not build.dispatch(dev):
        return ref.lookup_ref(tkeys, tvers, tvals, queries)
    found = torch.empty((q,), dtype=torch.bool, device=dev)
    vers = torch.empty((q,), dtype=u32.WORD, device=dev)
    vals = torch.empty((q, vw), dtype=u32.WORD, device=dev)
    slots = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return found, vers, vals, slots
    vec4 = int(vw == 4 and tkeys.data_ptr() % 8 == 0
               and tvals.data_ptr() % 16 == 0 and vals.data_ptr() % 16 == 0)
    f = build.c_function("hash_table", "ht_lookup", 8, 5)
    build.launch(f, "ht_lookup", dev, tkeys.data_ptr(), tvers.data_ptr(),
                 tvals.data_ptr(), queries.data_ptr(), found.data_ptr(),
                 vers.data_ptr(), vals.data_ptr(), slots.data_ptr(),
                 q, nb, s, vw, vec4)
    launches += 1
    launches_by_device[str(dev)] += 1
    return found, vers, vals, slots


def commit(tkeys, tvers, tvals, wkeys, wvals, active):
    """Sequential insert-or-update of (K, 2) keys, (K, VW) values and (K,)
    bool ``active`` into the table, IN PLACE. Returns the () bool overflow
    flag (some active write found neither its key nor an empty slot)."""
    global commit_launches
    dev = wkeys.device
    nb, s, vw = _check_table(tkeys, tvers, tvals, dev)
    k = wkeys.shape[0]
    build.check("wkeys", wkeys, u32.WORD, (k, 2), dev)
    build.check("wvals", wvals, u32.WORD, (k, vw), dev)
    build.check("active", active, torch.bool, (k,), dev)
    if not build.dispatch(dev):
        return ref.commit_ref(tkeys, tvers, tvals, wkeys, wvals, active)
    flag = torch.zeros((1,), dtype=u32.WORD, device=dev)
    if k:
        f = build.c_function("hash_table", "ht_commit", 7, 4)
        build.launch(f, "ht_commit", dev, tkeys.data_ptr(), tvers.data_ptr(),
                     tvals.data_ptr(), wkeys.data_ptr(), wvals.data_ptr(),
                     active.data_ptr(), flag.data_ptr(), k, nb, s, vw)
        commit_launches += 1
        commit_launches_by_device[str(dev)] += 1
    return flag[0] != 0
