"""The contracts gate: ``python -m repro_torch.analysis.gate`` (port of
repro.analysis.gate).

Runs the whole analysis and exits nonzero on any violation:

  1. **programs** -- build every registered hot-path program
     (:mod:`repro_torch.analysis.registry`) on a (1, M) mesh at a small
     sizing, run it once as a warm-up and once recorded, and check the
     call against its committed contract (collective budgets, commit
     passes, host syncs, dtypes, in-place state).
  2. **retrace** -- drive a small workload (windows, a tail window, stats
     reads, a resize, more windows) through a ``WindowCommitter`` with the
     auditor attached; a rebuilt step or a signature past the budget
     fails.
  3. **lint** -- AST scan of ``src/repro_torch/`` for host syncs outside
     the allowlisted phase-edge sites.

``--device cuda`` (the default) runs on the card: a mesh of four cards
when there are four, else four positions on ``cuda:0``; without a card it
raises, there is no fallback. ``--device cpu`` runs on four CPU
positions. ``--json PATH`` writes the full per-program report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.analysis import checks, contracts, lint, registry
from repro_torch.analysis.retrace import RetraceAuditor
from repro_torch.core import types
from repro_torch.launch import mesh as mesh_mod

MODEL_RANKS = 4


def make_mesh(device: str = "cuda", model: int = MODEL_RANKS):
    """A (1, ``model``) mesh: ``data`` = 1 as the reference gate's, one
    card a position when there are enough, else every position on
    ``cuda:0``; on the CPU, ``model`` CPU positions. Raises for ``cuda``
    without a card."""
    if device == "cpu":
        return mesh_mod.Mesh([["cpu"] * model])
    if not torch.cuda.is_available():
        raise RuntimeError("the gate runs on the card unless --device cpu "
                           "is given, and no CUDA device is available")
    if torch.cuda.device_count() >= model:
        return mesh_mod.from_cards(1, model)
    return mesh_mod.Mesh([["cuda:0"] * model])


def build_context(mesh) -> registry.BuildContext:
    return registry.BuildContext(mesh=mesh, dims=types.TEST_DIMS)


# ---------------------------------------------------------------------------
# 1. Programs: run every registered program, check the recorded call
# ---------------------------------------------------------------------------


def check_program(built, contract: dict, on_record=None
                  ) -> tuple[dict, list]:
    """(measurements, violations) of one built program's recorded call;
    ``on_record()`` runs just before it."""
    t0 = time.perf_counter()
    measured = checks.run_program(built, on_record=on_record)
    measured["seconds"] = time.perf_counter() - t0
    return measured, checks.check_measured(built.name, contract, measured)


def run_static(ctx: registry.BuildContext, only: set | None = None
               ) -> tuple[dict, list]:
    report: dict = {}
    viols: list = []
    for name, reg in registry.discover().items():
        if only is not None and name not in only:
            continue
        built = reg.builder(ctx)
        measured, v = check_program(built, contracts.for_program(name))
        report[name] = {
            "description": reg.description,
            "measured": {**checks.summary(measured),
                         "seconds": measured["seconds"]},
            "violations": [str(x) for x in v],
        }
        viols += v
    return report, viols


# ---------------------------------------------------------------------------
# 2. Retrace: a small workload under the auditor
# ---------------------------------------------------------------------------


def run_retrace(mesh, dims) -> RetraceAuditor:
    """Windows, a one-block tail window, stats reads, a resize epoch, more
    windows, on an audited sharded committer at depth 2. Each step build
    is allowed its enumerable signatures (the first window, one per
    resize) and nothing else."""
    from repro_torch.launch import fabric_step as fs
    from repro_torch.pipeline.engine_bridge import WindowCommitter

    auditor = RetraceAuditor()
    msize = mesh.model_size
    cfg = dataclasses.replace(fs.FASTFABRIC_SHARDED_STEP, pipeline_depth=2)
    nb = 16 * msize
    wc = WindowCommitter(dims, cfg, n_buckets=nb, slots=4, mesh=mesh)
    wc.attach_retrace_auditor(auditor)
    b_round = 4 * msize
    wire = torch.zeros((1, 2, b_round, 4 * dims.payload_words),
                       dtype=torch.uint8, device=mesh.first)
    ids = torch.zeros((1, 2, b_round, 2), dtype=torch.int32,
                      device=mesh.first)
    for _ in range(3):  # the first window's signature, then repeats
        wc.commit_windows(wire, ids)
    wc.commit_windows(wire[:, :1], ids[:, :1])  # a round's tail window
    wc.shard_stats([0])
    wc.shard_stats([0])
    wc.resize(2 * nb)  # an epoch: the butterfly and a new table layout
    for _ in range(2):
        wc.commit_windows(wire, ids)
    wc.block_until_ready()
    return auditor


# ---------------------------------------------------------------------------
# 3. Lint
# ---------------------------------------------------------------------------


def run_lint() -> list:
    allow = contracts.load().get("lint", {}).get("allow", [])
    return lint.lint_tree(lint.default_root(), allow)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def report_line(name: str, rec: dict) -> str:
    ok = "ok " if not rec["violations"] else "FAIL"
    m = rec["measured"]
    colls = ",".join(f"{k}={v:g}" for k, v in
                     sorted(m["collectives"].items())) or "-"
    csp = m.get("commit_scatter_passes")
    dt = m["dtype_ops"]
    return (f"[{ok}] {name:26s} collectives: {colls:38s} in place "
            f"{m['in_place_fields']}/{m['donated_fields']}"
            + (f"  commit_passes={csp}" if csp is not None else "")
            + f"  f64/s64/u64 ops {dt['f64']}/{dt['s64']}/{dt['u64']}"
            f"  syncs {len(m['host_syncs'])}  {m['seconds']:.1f} s")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the programs run (default: the card)")
    ap.add_argument("--json", default=None,
                    help="write the full report as JSON to this path")
    ap.add_argument("--only", nargs="+", default=None,
                    help="restrict the program pass to these names")
    ap.add_argument("--skip-retrace", action="store_true")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--list", action="store_true",
                    help="list registered programs and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, reg in registry.discover().items():
            print(f"{name:32s} {reg.description}")
        return 0

    mesh = make_mesh(args.device)
    ctx = build_context(mesh)
    report = {
        "device": args.device,
        "mesh": [[str(x) for x in r] for r in mesh.devices],
        "distinct_devices": len(mesh.distinct()),
        "programs": {},
        "retrace": {},
        "lint": [],
    }
    all_viols: list = []

    only = set(args.only) if args.only else None
    report["programs"], viols = run_static(ctx, only)
    all_viols += viols
    for name, rec in report["programs"].items():
        print(report_line(name, rec))

    if not args.skip_retrace:
        auditor = run_retrace(mesh, types.TEST_DIMS)
        report["retrace"] = auditor.report()
        all_viols += auditor.violations
        for name, rec in report["retrace"].items():
            ok = "ok " if not rec["violations"] else "FAIL"
            print(f"[{ok}] retrace {name:28s} calls={rec['calls']}"
                  f" builds={rec['builds']} traces={rec['traces']}"
                  f" signatures={rec['signatures']}")

    if not args.skip_lint:
        lviols = run_lint()
        report["lint"] = [str(v) for v in lviols]
        all_viols += lviols
        print(f"[{'ok ' if not lviols else 'FAIL'}] lint src/repro_torch: "
              f"{len(lviols)} host-sync call(s) outside allowlisted sites")

    report["violations"] = [str(v) for v in all_viols]
    report["ok"] = not all_viols
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    if all_viols:
        print(f"\n{len(all_viols)} contract violation(s):", file=sys.stderr)
        for v in all_viols:
            print(f"  {v}", file=sys.stderr)
        return 1
    print(f"\nall contracts hold ({len(report['programs'])} programs, "
          f"{len(report['retrace'])} audited programs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
