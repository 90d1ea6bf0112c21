"""The port's fabric step over a (2, 2) mesh, ``make_fabric_step(...,
mesh=...)`` on four CPU positions, against JAX ``make_fabric_step`` on a
(2, 2) mesh of forced host devices (a subprocess: the flag must be set
before JAX is imported; each configuration compiled once). Four
configurations: bucket-sharded state at depth 1 and at depth 4 with C = 2
channels over ``data``; replicated state at depth 1 with C = 1 channel
replicated over ``data``; and the Fabric 1.2 step (the whole wire in
consensus, sequential commit) at C = 2 over ``data``. Two steps each
(fresh accounts, then blocks that read the first ones' writes on channel
1). Every ``FabricMeshState`` field, gathered from the ranks, and the
validity bits equal JAX's through u32 views; every model rank's replica
and heads are identical; every shard and replica is its own storage on its
position's device; each model rank MACs only its B/M rows; the gathered
bytes equal their formulas (O-I: ``spw`` words a transaction, Fabric 1.2:
``payload_words``)."""

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
from repro_torch.core import u32, unmarshal
from repro_torch.kernels.sig_mac import ops as mac_ops
from repro_torch.launch import fabric_step as tfs
from repro_torch.launch import mesh as tmesh

from torch_pipeline_inputs import TDIMS, numpy_state, port_cfg, window

FIELDS = tfs.FabricMeshState._fields
B, NB, SLOTS = 16, 256, 8
# name -> (JAX config name, depth, channels, channels over data)
CONFIGS = {
    "sharded_d1": ("FASTFABRIC_SHARDED_STEP", 1, 2, True),
    "sharded_d4": ("FASTFABRIC_SHARDED_STEP", 4, 2, True),
    "replicated_c1": ("FASTFABRIC_STEP", 1, 1, False),
    "fabric12": ("FABRIC_V12_STEP", 1, 2, True),
}

_JAX_SIDE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import types
    from repro.launch import fabric_step as fs

    d = sys.argv[1]
    configs = json.loads(sys.argv[2])
    inp = dict(np.load(os.path.join(d, "in.npz")))
    dims = types.TEST_DIMS
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    out = {}
    for name, (cfg_name, depth, nch, over) in configs.items():
        cfg = dataclasses.replace(getattr(fs, cfg_name),
                                  pipeline_depth=depth)
        wires, ids = inp[f"{name}/wire"], inp[f"{name}/ids"]
        step = jax.jit(fs.make_fabric_step(
            dims, cfg, mesh, channels_over_data=over)).lower(
            fs.create_mesh_state(nch, dims, n_buckets=%d, slots=%d),
            jnp.zeros(wires.shape[1:], jnp.uint8),
            jnp.zeros(ids.shape[1:], jnp.uint32)).compile()
        st = fs.create_mesh_state(nch, dims, n_buckets=%d, slots=%d)
        for k in range(wires.shape[0]):
            args = jax.device_put(
                (st, jnp.asarray(wires[k]), jnp.asarray(ids[k])),
                step.input_shardings[0])
            st, v = step(*args)
            for f, a in zip(fs.FabricMeshState._fields, st):
                out[f"{name}/{k}/{f}"] = np.asarray(a)
            out[f"{name}/{k}/valid"] = np.asarray(v)
    np.savez(os.path.join(d, "out.npz"), **out)
""" % (NB, SLOTS, NB, SLOTS))


@pytest.fixture(scope="module")
def inputs():
    """(steps, C, [D,] B, ...) wire and ids of each configuration: channel
    0 fresh accounts, channel 1 a read-your-write window whose second step
    replays its first."""
    fresh = [window(4, n=B, seed=20 + 3 * k) for k in range(2)]
    ryw = window(4, n=B, seed=30, read_your_write=True)
    win_w = np.stack([np.stack([fresh[k][0], ryw[0]]) for k in range(2)])
    win_i = np.stack([np.stack([fresh[k][1], ryw[1]]) for k in range(2)])
    # Depth 1: the first window's blocks 0 and 1 as two steps.
    d1_w, d1_i = win_w[0].swapaxes(0, 1)[:2], win_i[0].swapaxes(0, 1)[:2]
    out = {}
    for name, (_, depth, nch, _) in CONFIGS.items():
        w, i = (win_w, win_i) if depth > 1 else (d1_w, d1_i)
        out[f"{name}/wire"] = np.ascontiguousarray(w[:, 2 - nch:])
        out[f"{name}/ids"] = np.ascontiguousarray(i[:, 2 - nch:])
    return out


@pytest.fixture(scope="module")
def jax_side(inputs, tmp_path_factory):
    """Start the JAX subprocess; the fixture's value waits for its results
    (the port's runs compute meanwhile)."""
    import json
    d = tmp_path_factory.mktemp("mesh_step")
    np.savez(d / "in.npz", **inputs)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(d), json.dumps(CONFIGS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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


@pytest.fixture(scope="module")
def port(jax_side, inputs):
    """Each configuration on an all-CPU (2, 2) mesh: the gathered state and
    validity after each step, the last placed state, the mesh's byte
    counts and the rows of every K1 call."""
    out = {}
    for name, (cfg_name, depth, nch, over) in CONFIGS.items():
        cfg = dataclasses.replace(port_cfg(getattr(jfs, cfg_name)),
                                  pipeline_depth=depth)
        mesh = tmesh.Mesh([["cpu", "cpu"], ["cpu", "cpu"]])
        step = tfs.make_fabric_step(TDIMS, cfg, mesh=mesh,
                                    channels_over_data=over)
        ms = tfs.create_mesh_state(nch, TDIMS, NB, SLOTS, mesh=mesh,
                                   shard_state=cfg.shard_state,
                                   channels_over_data=over)
        calls = []
        real = mac_ops.mac_many

        def counted(msg, *a, **k):
            calls.append((msg.shape[0], str(msg.device)))
            return real(msg, *a, **k)

        steps = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mac_ops, "mac_many", counted)
            wires, ids = inputs[f"{name}/wire"], inputs[f"{name}/ids"]
            for k in range(wires.shape[0]):
                ms, v = step(ms, torch.from_numpy(wires[k].copy()),
                             u32.from_numpy(ids[k]))
                steps.append((numpy_state(tfs.gather_state(ms, "cpu")),
                              v.numpy()))
        out[name] = {"cfg": cfg, "mesh": mesh, "ms": ms, "steps": steps,
                     "calls": calls, "moved": dict(mesh.moved)}
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_mesh_step_matches_jax(name, port, jax_side):
    res = jax_side()
    for k, (st, v) in enumerate(port[name]["steps"]):
        np.testing.assert_array_equal(v, res[f"{name}/{k}/valid"],
                                      err_msg=f"{name} step {k} valid")
        for f, x in zip(FIELDS, st):
            y = res[f"{name}/{k}/{f}"]
            assert x.dtype == y.dtype == np.uint32, (f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{name} {k} {f}")
    if name == "sharded_d4":  # channel 1's second window replays its first
        valid = port[name]["steps"][1][1]
        assert valid[0].all() and not valid[1].any()


@pytest.mark.parametrize("name", CONFIGS)
def test_model_ranks_hold_identical_replicas_and_heads(name, port):
    ms = port[name]["ms"]
    rows = [ms.ranks[d] for d in range(len(ms.channels))]
    for row in rows:
        for r in row[1:]:
            for f in FIELDS:
                if f in tfs.TABLE_FIELDS and ms.shard_state:
                    continue
                assert torch.equal(getattr(r, f), getattr(row[0], f)), f
    if not ms.over_data:  # every data row computed every channel
        for f in FIELDS:
            assert torch.equal(getattr(rows[1][0], f),
                               getattr(rows[0][0], f)), f


@pytest.mark.parametrize("name", CONFIGS)
def test_each_rank_owns_its_tensors_on_its_device(name, port):
    ms = port[name]["ms"]
    mesh = port[name]["mesh"]
    depth, nch, over = CONFIGS[name][1:]
    c_loc = nch // 2 if over else nch
    nb_loc = NB // 2 if ms.shard_state else NB
    for f in FIELDS:
        ptrs = set()
        for d, row in enumerate(ms.ranks):
            assert ms.channels[d] == (
                tuple(range(d * c_loc, (d + 1) * c_loc)) if over
                else tuple(range(nch)))
            for m, r in enumerate(row):
                t = getattr(r, f)
                assert t.device == mesh.devices[d][m]
                assert t.shape[0] == c_loc
                if f in tfs.TABLE_FIELDS:
                    assert t.shape[1] == nb_loc
                ptrs.add(t.untyped_storage().data_ptr())
        assert len(ptrs) == 4, f


@pytest.mark.parametrize("name", CONFIGS)
def test_each_model_rank_macs_its_rows(name, port):
    """One K1 call a rank a step, on B/M rows of each block of each of its
    channels (the endorsement check where the rows were ingested)."""
    depth, nch, over = CONFIGS[name][1:]
    c_loc = nch // 2 if over else nch
    n_steps = len(port[name]["steps"])
    assert port[name]["calls"] == [(c_loc * depth * B // 2, "cpu")] * (
        4 * n_steps)


@pytest.mark.parametrize("name", CONFIGS)
def test_gathered_bytes_match_their_formulas(name, port):
    cfg, moved = port[name]["cfg"], port[name]["moved"]
    depth, nch, over = CONFIGS[name][1:]
    n_steps, m = len(port[name]["steps"]), 2
    # Channel blocks a data row gathers, summed over the rows.
    blocks = n_steps * depth * (nch if over else 2 * nch)
    words = (unmarshal.struct_prefix_words(TDIMS) if cfg.separate_metadata
             else TDIMS.payload_words)
    assert moved["consensus"] == blocks * (m - 1) * B * (4 * words + 9)
    assert moved["consensus"] == blocks * tfs.consensus_bytes(TDIMS, cfg, B,
                                                              m)
    if not cfg.shard_state:
        assert set(moved) == {"consensus"}
        return
    n = depth * B  # transactions a channel window
    keys = n * TDIMS.rk if depth == 1 else n * (TDIMS.rk + 2 * TDIMS.wk)
    assert moved["routed_read"] == blocks // depth * (m - 1) * m * 4 * keys
    if depth == 1:  # the one-hot overflow psum: (C_loc, M) bools a rank
        c_loc = nch // 2 if over else nch
        assert moved["overflow_reduce"] == n_steps * 2 * (m - 1) * m * (
            c_loc * m)
    else:  # the window's overflow bits come from its replicated plan
        assert "overflow_reduce" not in moved
