"""The port's program-contract analysis (repro_torch.analysis), held
against the reference's (repro.analysis), mirroring tests/test_analysis.py.

The port registers the reference's seven programs under the same names;
its ``contracts.json`` equals the reference's but for the departures
listed here (and in ROADMAP §3); the known-good programs meet their
contracts on four CPU positions; and each SEEDED defect (an extra
collective, a per-block commit inside a window, a host sync in a step
body, an f64 op, an s64 result, a table cloned instead of written in
place) flips exactly the clause it targets. Part 2 holds the retrace
audit, the lint and the collective counts against the JAX programs."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import contracts as jax_contracts
from repro.analysis import registry as jax_registry
from repro_torch.analysis import checks, contracts, gate, registry
from repro_torch.core import world_state as ws
from repro_torch.launch import fabric_step as fs

# Where the port's contracts.json parts from the reference's, by path:
# the port's u32 arithmetic widens through int64 inside an op chain, so s64
# is held on what a program takes and returns, not per op; the lint's
# allowlist names the port's own phase-edge sites.
DEPARTURES = {
    "defaults.forbidden_dtypes": (["f64", "s64", "u64"], ["f64", "u64"]),
    "defaults.forbidden_io_dtypes": (None, ["s64"]),
    "lint.allow": "the port's phase edges",
}


@pytest.fixture(scope="module")
def ctx():
    return gate.build_context(gate.make_mesh("cpu"))


@pytest.fixture(scope="module")
def static(ctx):
    """The gate's program pass over every registered program, once."""
    return gate.run_static(ctx)


def _diff(a, b, path=""):
    """Paths where two JSON trees differ, with (a, b) at each."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = {}
        for k in sorted(set(a) | set(b)):
            out.update(_diff(a.get(k), b.get(k), f"{path}{k}."))
        return out
    return {} if a == b else {path[:-1]: (a, b)}


def test_registry_names_equal_the_reference():
    ours = registry.discover()
    assert set(ours) == set(jax_registry.discover())
    assert len(ours) == 7
    for reg in ours.values():
        assert reg.description


def test_contracts_equal_reference_but_the_departures():
    diff = _diff(jax_contracts.load(), contracts.load())
    assert set(diff) == set(DEPARTURES)
    for path, want in DEPARTURES.items():
        if isinstance(want, tuple):
            assert diff[path] == want, path
    # The allowlist names phase edges only, no blanket package pattern.
    assert "*" not in contracts.load()["lint"]["allow"]


@pytest.mark.parametrize("name", sorted(jax_registry.discover()))
def test_known_good_program_meets_its_contract(static, name):
    report, _ = static
    rec = report[name]
    assert rec["violations"] == []
    m = rec["measured"]
    assert m["host_syncs"] == [] and m["table_copies"] == []
    assert m["dtype_ops"]["f64"] == m["dtype_ops"]["u64"] == 0
    assert "s64" not in m["io_dtypes"]
    want = contracts.for_program(name)["collectives"]
    assert m["collectives"] == {k: v for k, v in want.items() if v}
    if name.startswith("fabric_step/"):
        assert m["commit_scatter_passes"] == 1
        assert m["in_place_fields"] == m["donated_fields"] == 12
        assert m["moved_bytes"]["consensus"] > 0
    elif name == "serving/decode_step":
        assert m["in_place_fields"] == m["donated_fields"] == 2
    elif name == "pipeline/resize_exchange":
        assert m["moved_bytes"]["resize"] > 0


def test_gate_cli_smoke(tmp_path):
    out = tmp_path / "report.json"
    rc = gate.main(["--device", "cpu", "--only", "pipeline/stats_pass",
                    "--skip-retrace", "--skip-lint", "--json", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["device"] == "cpu"
    assert list(rep["programs"]) == ["pipeline/stats_pass"]
    assert rep["mesh"] == [["cpu"] * 4]


# ---------------------------------------------------------------------------
# Seeded violations: each flips exactly the intended clause
# ---------------------------------------------------------------------------


def _seeded(ctx, name, cfg, depth, wrap):
    """The registered step program of ``cfg`` at ``depth`` with its
    callable replaced by ``wrap(step)``, checked against ``name``'s
    contract -> the violated clauses."""
    built = registry.step_program(ctx, name, cfg, depth)
    built.fn = wrap(built.fn)
    m = checks.run_program(built)
    return [v.clause for v in checks.check_measured(
        name, contracts.for_program(name), m)]


def test_seeded_extra_all_gather_flags_budget(ctx):
    def wrap(step):
        def fn(st, wire, ids):
            out = step(st, wire, ids)
            ctx.mesh.all_gather(0, [r.block_no for r in out[0].ranks[0]], 0,
                                "extra")
            return out
        return fn

    assert _seeded(ctx, "fabric_step/repl/d1", fs.FASTFABRIC_STEP, 1,
                   wrap) == ["collectives.all-gather"]
    # A type the budget does not name is budget 0.
    viols = checks.check_collectives(
        "t", {"collectives": {}}, {"collectives": {"all-to-all": 2}})
    assert [v.clause for v in viols] == ["collectives.all-to-all"]
    assert "contracts.json" in viols[0].message


def test_seeded_per_block_commit_in_a_window_flags_passes(ctx):
    one = fs.make_fabric_step(ctx.dims, fs.FASTFABRIC_SHARDED_STEP,
                              mesh=ctx.mesh)

    def wrap(step):
        def fn(st, wire, ids):  # the window committed a block at a time
            valid = []
            for k in range(wire.shape[1]):
                st, v = one(st, wire[:, k], ids[:, k])
                valid.append(v)
            return st, torch.stack(valid, 1)
        return fn

    # Two blocks committed one at a time: two passes into every table,
    # and each block's own consensus gathers and routed read.
    cfg = dataclasses.replace(fs.FASTFABRIC_SHARDED_STEP, pipeline_depth=2)
    assert _seeded(ctx, "fabric_step/shard/d8", cfg, 2, wrap) == [
        "collectives.all-gather", "collectives.all-reduce",
        "commit_scatter_passes"]
    viols = checks.check_commit_passes(
        "t", {"commit_scatter_passes": 1}, {"rank(0,0)/channel 0": 2.0})
    assert "[2.0]" in viols[0].message


def test_seeded_item_in_step_body_flags_host_sync(ctx):
    def wrap(step):
        def fn(st, wire, ids):
            out = step(st, wire, ids)
            if out[1].any().item():  # a host branch on a device value
                pass
            return out
        return fn

    assert _seeded(ctx, "fabric_step/shard/d1", fs.FASTFABRIC_SHARDED_STEP,
                   1, wrap) == ["forbidden_ops.host_sync"]


def test_seeded_wide_dtypes_flag_their_clauses(ctx):
    def f64(step):
        def fn(st, wire, ids):
            st, v = step(st, wire, ids)
            return st, v & (v.double() >= 0)
        return fn

    def s64(step):
        def fn(st, wire, ids):
            st, v = step(st, wire, ids)
            return st, v.long()
        return fn

    assert _seeded(ctx, "fabric_step/repl/d1", fs.FASTFABRIC_STEP, 1,
                   f64) == ["forbidden_dtypes.f64"]
    assert _seeded(ctx, "fabric_step/repl/d1", fs.FASTFABRIC_STEP, 1,
                   s64) == ["forbidden_io_dtypes.s64"]


def test_seeded_table_clone_flags_donation(ctx):
    def wrap(step):
        def fn(st, wire, ids):
            st, v = step(st, wire, ids)
            rank = st.ranks[0][1]
            row = (st.ranks[0][0], rank._replace(keys=rank.keys.clone()),
                   *st.ranks[0][2:])
            return st._replace(ranks=(row,)), v
        return fn

    assert _seeded(ctx, "fabric_step/repl/d1", fs.FASTFABRIC_STEP, 1,
                   wrap) == ["donation.aliasing", "donation.copy"]
    viols = checks.check_donation("t", {"donation": {}}, [], [])
    assert [v.clause for v in viols] == ["donation.missing"]


def test_gate_exits_nonzero_on_a_seeded_violation(monkeypatch, capsys):
    """The CLI's verdict: a registered program with a host sync in its body
    makes the gate exit 1 and name the clause."""
    def build(c):
        built = registry.step_program(c, "t/seeded", fs.FASTFABRIC_STEP, 1)
        step = built.fn

        def fn(st, wire, ids):
            res = step(st, wire, ids)
            res[1].any().item()
            return res

        built.fn = fn
        return built

    monkeypatch.setitem(registry._PROGRAMS, "t/seeded",
                        registry.Registered("t/seeded", build, "seeded"))
    rc = gate.main(["--device", "cpu", "--only", "t/seeded",
                    "--skip-retrace", "--skip-lint"])
    assert rc == 1
    assert "[forbidden_ops.host_sync]" in capsys.readouterr().err


def test_put_rows_equals_boolean_mask_scatter():
    """The sync-free masked write the commits use equals the boolean-mask
    scatter it replaced, with some, none and every row kept."""
    rng = np.random.default_rng(5)
    for kept in (0.5, 0.0, 1.0):
        dst = torch.from_numpy(rng.integers(-9, 9, (40, 3), dtype=np.int32))
        idx = torch.from_numpy(rng.permutation(40)[:16].astype(np.int64))
        rows = torch.from_numpy(rng.integers(-9, 9, (16, 3), dtype=np.int32))
        mask = torch.from_numpy(rng.random(16) < kept)
        flat, flat_want = dst[:, 0].clone(), dst[:, 0].clone()
        want = dst.clone()
        want[idx[mask]] = rows[mask]
        ws.put_rows(dst, idx, rows, mask)
        assert torch.equal(dst, want), kept
        flat_want[idx[mask]] = rows[:, 1][mask]
        ws.put_rows(flat, idx, rows[:, 1], mask)
        assert torch.equal(flat, flat_want), kept
