"""Loader for ``contracts.json``, the port's committed program contracts
(port of repro.analysis.contracts).

One file holds every program invariant the gate (``repro_torch.analysis.
gate``) and ``chip_smoke.py`` check, so an intended change (a new
collective, a shifted budget) is amended in one reviewed place. It starts
from the reference's file and departs from it only where the port's
program really differs; ROADMAP §3 names each departure and
``tests/test_torch_analysis.py`` asserts exactly those.

Layout (see ``contracts.json``)::

    {
      "defaults":  {... clauses applied to every program ...},
      "programs":  {"<name>": {... per-program clauses, override ...}},
      "retrace":   {"max_signatures": {"default": N, "<name>": M}},
      "lint":      {"allow": ["file.py:qual*", ...]}
    }

Per-program clauses:
  ``collectives``            -- {type: max calls of the mesh's collectives
                               a program call}; types not listed are
                               budget 0.
  ``max_wire_bytes``         -- per-position ceiling on the bytes the
                               collectives move.
  ``commit_scatter_passes``  -- exact commit passes a program call into
                               each table (keys, versions and values
                               written once each = 1 pass).
  ``forbidden_dtypes``       -- dtypes no op of the program may give as a
                               non-scalar result.
  ``forbidden_io_dtypes``    -- dtypes no tensor the program takes or
                               returns may have (the port's u32 arithmetic
                               widens through int64 inside an op chain, so
                               s64 is held here, not per op).
  ``forbid_host_callbacks``  -- no host sync inside the program.
  ``donation``               -- {"min_aliased_fraction": f}: the share of
                               the donated state fields that must come
                               back in the storage they went in with, and
                               no table-sized copy inside the call.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

CONTRACTS_PATH = os.path.join(os.path.dirname(__file__), "contracts.json")


@lru_cache(maxsize=None)
def _load_cached(path: str, mtime: float) -> dict:
    with open(path) as f:
        return json.load(f)


def load(path: str | None = None) -> dict:
    p = path or CONTRACTS_PATH
    return _load_cached(p, os.path.getmtime(p))


def for_program(name: str, data: dict | None = None) -> dict:
    """Effective contract for one program: defaults overlaid with the
    program's own clauses. An unknown program gets the defaults."""
    data = data or load()
    merged = dict(data.get("defaults", {}))
    merged.update(data.get("programs", {}).get(name, {}))
    return merged


def program_names(data: dict | None = None) -> list[str]:
    data = data or load()
    return sorted(data.get("programs", {}))


def commit_scatter_passes(data: dict | None = None) -> int:
    """The fused window-commit budget shared by every fabric_step program.
    Refuses to guess if the committed contracts disagree across them."""
    data = data or load()
    vals = {
        c["commit_scatter_passes"]
        for n, c in data.get("programs", {}).items()
        if n.startswith("fabric_step/") and "commit_scatter_passes" in c
    }
    if len(vals) != 1:
        raise ValueError(
            f"fabric_step commit_scatter_passes contracts disagree: {vals}")
    return vals.pop()


def retrace_budget(name: str, data: dict | None = None) -> int:
    data = data or load()
    rt = data.get("retrace", {}).get("max_signatures", {})
    return int(rt.get(name, rt.get("default", 4)))
