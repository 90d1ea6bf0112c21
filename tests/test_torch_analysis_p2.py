"""The port's program-contract analysis, part 2 (see
test_torch_analysis.py): the retrace audit of the window committer, the
source lint, and the collective calls of ``fabric_step/shard/d1`` and
``fabric_step/shard/d8`` against the reference's compiled programs. For
the last, each program is built by its registry at the gate's sizing on a
(1, 4) mesh; the JAX side runs in a subprocess on four forced host devices
(the flag must be set before JAX is imported), compiles each program once
and counts the collectives of its HLO, trip-corrected
(``repro.launch.hlo_cost``), while the port counts the calls of its
:class:`~repro_torch.launch.mesh.Mesh` over one call of each program on
four CPU positions."""

import ast
import collections
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from repro_torch.analysis import contracts, gate, lint, registry
from repro_torch.analysis.retrace import RetraceAuditor
from repro_torch.core import types
from repro_torch.launch import fabric_step as fs
from repro_torch.pipeline.engine_bridge import WindowCommitter

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PROGRAMS = ("fabric_step/shard/d1", "fabric_step/shard/d8")


# ---------------------------------------------------------------------------
# Retrace auditing
# ---------------------------------------------------------------------------


def test_retrace_signatures_within_budget_ok_and_churn_flagged():
    aud = RetraceAuditor(max_signatures=2)
    f = aud.wrap("t/ok", lambda x: x * 2)
    f(torch.zeros(4))
    f(torch.zeros(4))  # the same signature
    f(torch.zeros(8))  # a new shape, within the budget
    rec = aud.programs["t/ok"]
    assert (rec.calls, rec.builds, rec.traces, len(rec.seen)) == (3, 1, 2, 2)
    assert not aud.violations
    f(torch.zeros(16))  # a shape varying every round
    assert [v.clause for v in aud.violations] == ["retrace.signature_churn"]


def test_seeded_rebuilt_step_flagged():
    dims = types.TEST_DIMS
    cfg = dataclasses.replace(fs.FASTFABRIC_STEP, pipeline_depth=2)
    wc = WindowCommitter(dims, cfg, n_buckets=64, slots=4, device="cpu")
    aud = RetraceAuditor()
    wc.attach_retrace_auditor(aud)
    wire = torch.zeros((1, 2, 8, 4 * dims.payload_words), dtype=torch.uint8)
    ids = torch.zeros((1, 2, 8, 2), dtype=torch.int32)
    wc.commit_windows(wire, ids)
    wc.commit_windows(wire, ids)
    assert not aud.violations
    wc._steps.clear()  # a lost step cache: the same key built again
    wc.commit_windows(wire, ids)
    viols = aud.violations
    assert [v.clause for v in viols] == ["retrace.recompiled"]
    assert "pipeline/window_step/d2" in str(viols[0])


def test_committer_audited_workload_clean():
    auditor = gate.run_retrace(gate.make_mesh("cpu"), types.TEST_DIMS)
    assert not auditor.violations
    steps = auditor.programs["pipeline/window_step/d2"]
    assert (steps.calls, steps.builds) == (5, 1)
    assert steps.traces == 2  # the first window and the post-resize one
    tail = auditor.programs["pipeline/window_step/d1"]
    assert (tail.calls, tail.traces) == (1, 1)
    stats = auditor.programs["pipeline/stats_pass"]
    assert (stats.calls, stats.traces) == (2, 1)
    assert auditor.programs["pipeline/resize_exchange"].calls == 1


# ---------------------------------------------------------------------------
# Source lint
# ---------------------------------------------------------------------------

_LINT_SRC = """\
from repro_torch.core import u32

def hot_loop(x):
    return x.sum().item()

class Edge:
    def drain(self, x):
        return u32.to_numpy(x), x.cpu(), x.tolist()

    def wait(self, mesh):
        mesh.synchronize()
"""


def test_lint_flags_and_allowlist(tmp_path):
    (tmp_path / "mod.py").write_text(_LINT_SRC)
    viols = lint.lint_tree(str(tmp_path), allow=["mod.py:Edge.drain"])
    assert [v.clause for v in viols] == ["lint.item", "lint.synchronize"]
    assert "hot_loop" in viols[0].message
    viols = lint.lint_tree(str(tmp_path), allow=["mod.py:hot_loop"])
    assert [v.clause for v in viols] == [
        "lint.u32.to_numpy", "lint.cpu", "lint.tolist", "lint.synchronize"]
    assert not lint.lint_tree(str(tmp_path), allow=["mod.py:*"])


def test_lint_repo_is_clean():
    assert gate.run_lint() == []


def test_port_imports_neither_jax_nor_the_reference():
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), (path, n)


def test_contracts_single_source_of_truth():
    assert contracts.commit_scatter_passes() == 1
    c = contracts.for_program("not/registered")
    assert c["forbid_host_callbacks"] and "f64" in c["forbidden_dtypes"]
    assert c["forbidden_io_dtypes"] == ["s64"]
    assert contracts.for_program("pipeline/stats_pass")["donation"] is None
    assert contracts.for_program("serving/decode_step")[
        "forbidden_dtypes"] == ["f64"]


_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import jax
    from repro.analysis import gate, registry
    from repro.launch import hlo_cost

    mesh = jax.make_mesh((1, 4), ("data", "model"))
    assert dict(mesh.shape) == {"data": 1, "model": 4}
    ctx = gate.build_context(mesh)
    out = {}
    for name in sys.argv[1:]:
        built = registry.discover()[name].builder(ctx)
        hlo = built.fn.lower(*built.args).compile().as_text()
        colls = hlo_cost.analyze(hlo)["collectives"] or {}
        out[name] = {op: v["count"] for op, v in colls.items()}
    print(json.dumps(out))
""")


def test_collective_counts_equal_the_jax_artifacts():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(root / "src"))
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, *PROGRAMS], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ctx = gate.build_context(gate.make_mesh("cpu"))
        ours = {}
        for name in PROGRAMS:
            built = registry.get(name).builder(ctx)
            before = collections.Counter(ctx.mesh.calls)
            built.fn(*built.args)
            ours[name] = dict(ctx.mesh.calls - before)
        out, err = jax_side.communicate(timeout=300)
    finally:
        jax_side.kill()
    assert jax_side.returncode == 0, err[-2000:]
    theirs = json.loads(out.strip().splitlines()[-1])
    for name in PROGRAMS:
        assert ours[name] == {op: int(n) for op, n in theirs[name].items()
                              if n}, name
        assert all(float(n).is_integer() for n in theirs[name].values())
    assert ours["fabric_step/shard/d1"] == {"all-gather": 3, "all-reduce": 2}
    assert ours["fabric_step/shard/d8"] == {"all-gather": 3, "all-reduce": 1}
