"""The port's bucket-sharded fabric step against JAX ``make_fabric_step``
with ``shard_state=True``: at M = 4 on a (1, 4) mesh of forced host
devices, in one subprocess (the flag must be set before JAX is imported),
and at M = 1 in-process on a (1, 1) mesh. Depth 1 and depth 8 over two
windows (fresh accounts, then read-your-write blocks), an 8 x 2 table that
overflows mid-window, and C = 2 channels at depth 4: every
``FabricMeshState`` field and the validity bits through u32 views. The
port at M = 2 is held against the same results: its tables, heads and
bits are the M = 4 ones, its overflow bit m the OR of the M = 4 bits 2m
and 2m + 1 (ownership nests). The butterfly resize (grow, shrink, a lossy
shrink at one bucket a shard) against JAX ``make_resize_program``. The
JAX side compiles each of its four step configurations once."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import fabric_step as jfs
from repro_torch.core import u32
from repro_torch.launch import fabric_step as tfs
from repro_torch.launch import state_sharding as tss

from torch_pipeline_inputs import (TDIMS, assert_same, jax_run, numpy_state,
                                   port_cfg, window)

M_JAX = 4
SHARDED = jfs.FASTFABRIC_SHARDED_STEP
PIPELINED = jfs.FASTFABRIC_PIPELINED_STEP
FIELDS = tfs.FabricMeshState._fields

# The JAX side: reads in.npz, runs every configuration on a (1, 4) mesh,
# writes out.npz. Each step is compiled once and fed its inputs placed as
# the compiled program takes them.
_JAX_SIDE = textwrap.dedent("""
    import dataclasses, os, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import types
    from repro.launch import fabric_step as fs
    from repro.pipeline import engine_bridge as eb

    d = sys.argv[1]
    inp = dict(np.load(os.path.join(d, "in.npz")))
    dims = types.TEST_DIMS
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    assert mesh.shape["model"] == 4
    out = {}

    def compiled(cfg, depth, nch, nb, slots, wire):
        step = jax.jit(fs.make_fabric_step(
            dims, dataclasses.replace(cfg, pipeline_depth=depth), mesh))
        return step.lower(
            fs.create_mesh_state(nch, dims, n_buckets=nb, slots=slots),
            jnp.zeros(wire.shape[:-1] + wire.shape[-1:], jnp.uint8),
            jnp.zeros(wire.shape[:-1] + (2,), jnp.uint32)).compile()

    def run(name, cfg, depth, nb, slots, wires, ids, nch=1):
        # wires: (steps, C, [D,] B, WB); saves the state after each step.
        step = compiled(cfg, depth, nch, nb, slots, wires[0])
        st = fs.create_mesh_state(nch, dims, n_buckets=nb, slots=slots)
        shard_in = step.input_shardings[0]
        for k in range(wires.shape[0]):
            args = jax.device_put(
                (st, jnp.asarray(wires[k]), jnp.asarray(ids[k])), shard_in)
            st, v = step(*args)
            for f, a in zip(fs.FabricMeshState._fields, st):
                out[f"{name}/{k}/{f}"] = np.asarray(a)
            out[f"{name}/{k}/valid"] = np.asarray(v)
        return st

    cfg_d1 = fs.FASTFABRIC_SHARDED_STEP
    cfg_d8 = fs.FASTFABRIC_PIPELINED_STEP
    run("d1", cfg_d1, 1, 256, 8, inp["d1_wire"], inp["d1_ids"])
    st8 = run("d8", cfg_d8, 8, 256, 8, inp["d8_wire"], inp["d8_ids"])
    sto = run("ovf", cfg_d8, 8, 8, 2, inp["ovf_wire"], inp["ovf_ids"])
    run("c2", cfg_d1, 4, 256, 8, inp["c2_wire"], inp["c2_ids"], nch=2)

    def resize(name, st, old_nb, new_nb):
        prog = jax.jit(eb.make_resize_program(cfg_d1, mesh, old_nb, new_nb))
        keys, vers, vals, bits = prog(st[0], st[1], st[2])
        for f, a in zip(("keys", "versions", "values", "bits"),
                        (keys, vers, vals, bits)):
            out[f"{name}/{f}"] = np.asarray(a)
        return keys, vers, vals

    grown = resize("grow", st8, 256, 512)
    resize("shrink", grown, 512, 256)
    resize("lossy", sto, 8, 4)
    np.savez(os.path.join(d, "out.npz"), **out)
""")


def _steps(windows):
    """(steps, C=1, D, B, ...) wire and ids from a list of windows."""
    return (np.stack([w[None] for w, _ in windows]),
            np.stack([i[None] for _, i in windows]))


@pytest.fixture(scope="module")
def inputs():
    fresh = window(8, n=16, seed=0)
    ryw = window(8, n=16, seed=4, read_your_write=True)
    ovf = window(8, n=16, seed=7, endorser_buckets=8, endorser_slots=2)
    c2 = [[window(4, n=16, seed=20 + 3 * k) for k in range(2)],
          [window(4, n=16, seed=30, read_your_write=True)] * 2]
    d8_wire, d8_ids = _steps([fresh, ryw])
    d1 = {"d1_wire": np.concatenate([fresh[0], ryw[0]])[:, None],
          "d1_ids": np.concatenate([fresh[1], ryw[1]])[:, None]}
    ovf_wire, ovf_ids = _steps([ovf])
    c2_wire = np.stack([np.stack([c2[c][k][0] for c in range(2)])
                        for k in range(2)])
    c2_ids = np.stack([np.stack([c2[c][k][1] for c in range(2)])
                       for k in range(2)])
    return {**d1, "d8_wire": d8_wire, "d8_ids": d8_ids,
            "ovf_wire": ovf_wire, "ovf_ids": ovf_ids, "c2_wire": c2_wire,
            "c2_ids": c2_ids}


@pytest.fixture(scope="module")
def jax_side(inputs, tmp_path_factory):
    """Start the JAX subprocess; the fixture's value waits for its results
    (the in-process M = 1 case compiles meanwhile)."""
    d = tmp_path_factory.mktemp("sharded_step")
    np.savez(d / "in.npz", **inputs)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, str(d)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    cache = {}

    def results():
        if not cache:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            cache.update(np.load(d / "out.npz"))
        return cache

    yield results
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _jax(res, name, k):
    """The JAX state and validity after step ``k`` of a run, in the form
    ``assert_same`` takes."""
    return ([tuple(res[f"{name}/{k}/{f}"] for f in FIELDS)],
            res[f"{name}/{k}/valid"])


def _fold_bits(lanes, m):
    """M = 4 overflow lanes -> the lanes of the same run at ``m`` shards."""
    bits = tss.bits_to_int(lanes)
    group = M_JAX // m
    folded = 0
    for s in range(M_JAX):
        if bits >> s & 1:
            folded |= 1 << (s // group)
    return tss.int_to_lanes(folded)


def _expected(states, valid, m):
    """A JAX M = 4 result as the port at ``m`` shards must give it."""
    state = list(states[0])
    state[FIELDS.index("overflow")] = np.stack(
        [_fold_bits(row, m) for row in state[FIELDS.index("overflow")]])
    return [tuple(state)], valid


def _port(cfg, depth, m, wires, ids, nb=256, slots=8, nch=1):
    """The port's step over ``wires`` (steps, C, [D,] B, WB): the state and
    validity after each step."""
    step = tfs.make_fabric_step(
        TDIMS, dataclasses.replace(port_cfg(cfg), pipeline_depth=depth),
        n_shards=m)
    st = tfs.create_mesh_state(nch, TDIMS, nb, slots, device="cpu")
    out = []
    for k in range(wires.shape[0]):
        st, v = step(st, torch.from_numpy(wires[k].copy()),
                     u32.from_numpy(ids[k]))
        out.append((numpy_state(st), v.numpy()))
    return out


@pytest.mark.parametrize("m", (1, 2, 4))
def test_sharded_depth1_matches_jax(m, inputs, jax_side):
    got = _port(SHARDED, 1, m, inputs["d1_wire"], inputs["d1_ids"])
    if m == 1:
        # In-process against a (1, 1) mesh with shard_state=True.
        wire, ids = inputs["d1_wire"][:, 0], inputs["d1_ids"][:, 0]
        states, valid = jax_run(SHARDED, wire, ids, 1)
        assert_same(([s for s, _ in got], np.stack([v[0] for _, v in got])),
                    (states, valid), "depth 1, M = 1")
        return
    res = jax_side()
    for k, (st, v) in enumerate(got):
        assert_same(([st], v), _expected(*_jax(res, "d1", k), m),
                    f"depth 1, M = {m}, block {k}")


@pytest.mark.parametrize("m", (1, 2, 4))
def test_sharded_window_matches_jax(m, inputs, jax_side):
    """Depth 8 over the fresh window, then the read-your-write one; each
    window also equals eight depth-1 steps of the JAX step."""
    got = _port(PIPELINED, 8, m, inputs["d8_wire"], inputs["d8_ids"])
    res = jax_side()
    for k, (st, v) in enumerate(got):
        assert_same(([st], v), _expected(*_jax(res, "d8", k), m),
                    f"depth 8, M = {m}, window {k}")
        d1 = _jax(res, "d1", 8 * k + 7)[0][0]
        for f in ("keys", "versions", "values", "journal_head"):
            np.testing.assert_array_equal(st[FIELDS.index(f)],
                                          d1[FIELDS.index(f)], err_msg=f)
    assert got[1][1].all() and got[0][1].all()  # read-your-write is valid


@pytest.mark.parametrize("m", (1, 2, 4))
def test_sharded_overflow_matches_jax(m, inputs, jax_side):
    """An 8 x 2 table (2 buckets a shard at M = 4) whose inserts drop
    mid-window: the window and eight depth-1 steps equal JAX's window,
    and the set bits name the shards that dropped writes."""
    wire, ids = inputs["ovf_wire"], inputs["ovf_ids"]
    res = jax_side()
    want = _expected(*_jax(res, "ovf", 0), m)
    ((st, v),) = _port(PIPELINED, 8, m, wire, ids, nb=8, slots=2)
    assert_same(([st], v), want, f"overflow window, M = {m}")
    steps = _port(SHARDED, 1, m, wire[0, 0][:, None], ids[0, 0][:, None],
                  nb=8, slots=2)
    assert_same(([steps[-1][0]], np.stack([s[1][0] for s in steps])[None]),
                want, f"overflow, eight depth-1 steps, M = {m}")
    bits = tss.bits_to_int(st[FIELDS.index("overflow")][0])
    assert bits and bits < 1 << m
    if m == M_JAX:
        assert bits != 1  # a shard other than 0 dropped too


def test_two_sharded_channels_match_jax(inputs, jax_side):
    """C = 2 at depth 4, M = 4: channel 0 fresh accounts, channel 1
    read-your-write blocks whose second window replays its first."""
    got = _port(SHARDED, 4, M_JAX, inputs["c2_wire"], inputs["c2_ids"],
                nch=2)
    res = jax_side()
    for k, (st, v) in enumerate(got):
        assert_same(([st], v), _jax(res, "c2", k), f"C = 2, window {k}")
    assert got[1][1][0].all() and not got[1][1][1].any()


def test_butterfly_resize_matches_jax_program(inputs, jax_side):
    """``resize_sharded`` at M = 4 against the reference committer's resize
    program (the butterfly ppermutes inside shard_map): a grow of the
    depth-8 run's table 256 -> 512, the shrink back, and a lossy shrink of
    the overflowing 8 x 2 table to 4 x 2 (one bucket a shard)."""
    res = jax_side()

    def port_resize(keys, vers, vals, new_nb):
        table = tss.ws.HashState(*(u32.from_numpy(a[0], "cpu")
                                   for a in (keys, vers, vals)))
        out = tss.resize_sharded(tss.shard_views(table, M_JAX),
                                 new_nb // M_JAX, table.n_buckets, M_JAX)
        merged = [np.concatenate([u32.host_copy(getattr(s, f))
                                  for s in out.state])[None]
                  for f in ("keys", "versions", "values")]
        return merged, u32.host_copy(tss.overflow_bits(out.shard_overflow))

    src = {"grow": _jax(res, "d8", 1)[0][0],
           "lossy": _jax(res, "ovf", 0)[0][0]}
    src["shrink"] = tuple(res[f"grow/{f}"] for f in ("keys", "versions",
                                                     "values"))
    sizes = {"grow": 512, "shrink": 256, "lossy": 4}
    for name in ("grow", "shrink", "lossy"):
        merged, bits = port_resize(*src[name][:3], sizes[name])
        for f, a in zip(("keys", "versions", "values"), merged):
            np.testing.assert_array_equal(a, res[f"{name}/{f}"],
                                          err_msg=f"{name} {f}")
        np.testing.assert_array_equal(bits, res[f"{name}/bits"][0],
                                      err_msg=f"{name} bits")
    assert tss.bits_to_int(res["lossy/bits"][0]) != 0
    assert tss.bits_to_int(res["grow/bits"][0]) == 0
