"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's ``launch.sharding``, on shape stand-ins (the port's ``meta``
tensors, JAX's ``eval_shape``): ``param_specs`` of every architecture at
model widths 4 and 16, leaf for leaf, the port's per-layer leaf against the
stacked JAX leaf without its L entry; ``cache_pspecs``, ``batch_pspecs``,
``token_pspec`` and ``opt_specs`` on (1, 4), (2, 2) and (2, 8) meshes at
batch 1 and at a batch that divides over ``data``. Then the placement's
round trip, the counted all-to-all, and the mesh LM's refusals: the
batch-1 layout with ``data`` > 1, a cache length that does not divide over
``model``, and the ssm, hybrid and encdec families."""

import types

import jax
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import sharding as jsh, specs as jspecs
from repro.models.lm import LM as JLM
from repro_torch.configs import base as tcfg
from repro_torch.launch import mesh as mesh_mod, sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models.lm import LM, Batch, MeshLM

MESHES = ((1, 4), (2, 2), (2, 8))


def _jax_mesh(data, model):
    """What the JAX rules read of a mesh: its axis names and widths."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": data, "model": model})


def _port_mesh(data, model):
    return mesh_mod.Mesh([["meta"] * model] * data)


def _jax_by_path(tree) -> dict:
    """JAX leaves (specs: PartitionSpec leaves) by their key path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(getattr(k, "key", getattr(k, "name", None)) for k in p): s
            for p, s in flat}


def _port_vs_jax(port_tree, jax_tree, stacked: bool):
    """Every port leaf against the JAX leaf it stands for: a leaf under a
    layer list against the stacked leaf, without its L entry unless
    ``stacked``."""
    want = _jax_by_path(jax_tree)
    got = tsh.leaves_with_path(port_tree)
    seen = set()
    for path, spec in got:
        if path[0] in tsh.LAYER_LISTS:
            key = (path[0],) + path[2:]
            ref = tuple(want[key]) if stacked else tuple(want[key])[1:]
        else:
            key = path
            ref = tuple(want[key])
        seen.add(key)
        assert tuple(spec) == ref, (path, spec, ref)
    assert seen == set(want)


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_param_specs_match_jax(arch):
    jshapes = jspecs.param_shapes(JLM(jcfg.get(arch)))
    tshapes = tspecs.param_shapes(LM(tcfg.get(arch), device="meta"))
    assert tshapes["embed"].device.type == "meta"
    for model in (4, 16):
        _port_vs_jax(tsh.param_specs(tshapes, _port_mesh(1, model)),
                     jsh.param_specs(jshapes, _jax_mesh(1, model)), False)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cache_batch_token_and_opt_specs_match_jax(shape):
    jm, tm = _jax_mesh(*shape), _port_mesh(*shape)
    for arch, seq in (("llava-next-34b", 4096), ("qwen2-moe-a2.7b", 2048),
                      ("seamless-m4t-medium", 1024), ("zamba2-1.2b", 512)):
        jc, tc = jcfg.get(arch), tcfg.get(arch)
        for b in (1, shape[0] * 2):
            jcache = jsh.cache_pspecs(jspecs.cache_shapes(JLM(jc), b, seq),
                                      jm)
            tcache = tsh.cache_pspecs(
                tspecs.cache_shapes(LM(tc, device="meta"), b, seq), tm)
            jbatch = jsh.batch_pspecs(jspecs.batch_specs(
                jc, seq, b, with_labels=True), jm)
            tbatch = tsh.batch_pspecs(tspecs.batch_specs(
                tc, seq, b, with_labels=True), tm)
            for f in ("k", "v", "cross_k", "cross_v", "conv", "ssm_state",
                      "hyb_k", "hyb_v"):
                want, got = getattr(jcache, f), getattr(tcache, f)
                assert (got is None) == (want is None), f
                assert want is None or tuple(got) == tuple(want), (f, b)
            for f in ("tokens", "labels", "prefix_embeds", "enc_embeds"):
                want, got = getattr(jbatch, f), getattr(tbatch, f)
                assert (got is None) == (want is None), f
                assert want is None or tuple(got) == tuple(want), (f, b)
            assert tuple(tsh.token_pspec(b, tm)) == tuple(
                jsh.token_pspec(b, jm))
        if arch in ("llava-next-34b", "qwen2-moe-a2.7b"):
            tshapes = tspecs.param_shapes(LM(tc, device="meta"))
            jshapes = jspecs.param_shapes(JLM(jc))
            for zero1 in (True, False):
                want = jsh.opt_specs(jshapes, jm, zero1=zero1)
                got = tsh.opt_specs(tshapes, tm, zero1=zero1)
                assert tuple(got.step) == tuple(want.step) == ()
                _port_vs_jax(got.m, want.m, True)
                _port_vs_jax(got.v, want.v, True)


def test_zero1_and_divisibility_rules():
    """zero1_pspec on the first replicated dividing dim, and the `div` rule
    that a dim must be at least the axis width."""
    assert tsh.zero1_pspec(tsh.P(None, "model"), (8, 4), ("data",), 4) == (
        "data", "model")
    assert tsh.zero1_pspec(tsh.P(None, "model"), (6, 4), ("data",), 4) == (
        None, "model")
    small = torch.empty((2, 8), device="meta")
    assert tsh.param_pspec(("embed",), small, 4) == (None, None)
    assert tsh.param_pspec(("layers", 0, "attn", "wq"), small, 16) == (
        None, None)
    assert tsh.param_pspec(("layers", 0, "attn", "wq"), small, 4) == (
        None, "model")


def test_place_and_gather_round_trip():
    """A smoke LM's params cut over a (2, 2) mesh of CPU positions: each
    block a copy (no view of the source), gathered back equal."""
    cfg = tcfg.get_smoke("moonshot-v1-16b-a3b")
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mesh = mesh_mod.Mesh([["cpu", "cpu"], ["cpu", "cpu"]])
    model = MeshLM.from_lm(lm, mesh)
    assert model.moe_mode == "ep"
    w = model.params[1][1]["layers"][0]["moe"]["w_gate"]
    assert w.shape == (cfg.n_experts // 2, cfg.d_model, cfg.d_ff)
    src = lm.params["layers"][0]["moe"]["w_gate"]
    assert w.data_ptr() != src[cfg.n_experts // 2:].data_ptr()
    back = model.gather_params("cpu")
    for (path, a), (_, b) in zip(tsh.leaves_with_path(lm.params.tree()),
                                 tsh.leaves_with_path(back)):
        assert torch.equal(a, b), path


def test_all_to_all_counts_bytes_between_ranks():
    mesh = mesh_mod.Mesh([["cpu"] * 3])
    chunks = [[torch.full((2, n), float(10 * m + j)) for j, n in
               enumerate((1, 2, 0))] for m in range(3)]
    got = mesh.all_to_all(0, chunks, 1, "x")
    assert [g.shape for g in got] == [(2, 3), (2, 6), (2, 0)]
    assert got[1][0].tolist() == [1, 1, 11, 11, 21, 21]
    assert mesh.calls == {"all-to-all": 1}
    # chunk j of rank m crosses when m != j: for each j, two ranks send
    # 2 rows of (1, 2, 0) columns of 4 bytes
    assert mesh.moved["x"] == 2 * (1 + 2 + 0) * 2 * 4
    assert mesh_mod.dp_axes(mesh) == ("data",)


def _smoke_mesh_lm(arch, shape):
    cfg = tcfg.get_smoke(arch)
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return cfg, MeshLM.from_lm(lm, mesh_mod.Mesh([["cpu"] * shape[1]]
                                                  * shape[0]))


@pytest.mark.parametrize("case", ["batch1_over_data", "seq_not_dividing"])
def test_mesh_lm_refuses_layouts_of_other_slices(case):
    cfg, model = _smoke_mesh_lm("qwen2.5-14b", (2, 2))
    if case == "batch1_over_data":
        with pytest.raises(NotImplementedError, match="batch-1"):
            model.init_cache(1, 16)
        cache = model.init_cache(2, 16)
        with pytest.raises(ValueError, match="batch 2"):
            model.decode_step(cache, torch.zeros(1, dtype=torch.int32), 3)
    else:
        with pytest.raises(ValueError, match="does not divide"):
            model.init_cache(2, 15)
        cache = model.init_cache(2, 8)
        with pytest.raises(ValueError, match="past the cache"):
            model.prefill(Batch(tokens=torch.zeros((2, 9), dtype=torch.int32)),
                          cache)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_mesh_lm_refuses_other_families(arch):
    with pytest.raises(NotImplementedError, match="later slice"):
        MeshLM(tcfg.get_smoke(arch), mesh_mod.Mesh([["cpu"] * 2]))
