"""The mesh LM (``models.lm.MeshLM``) on the card against the one-device
port on the same card, and K5 at the mesh's per-rank shapes against its
plain version. The mesh is (1, 4): one card a position with four cards,
else four positions on ``cuda:0``. f32, TF32 off: logits within 1e-4 of
the largest |logit|, greedy tokens equal, the gathered caches within 1e-5
of each field's largest magnitude; the mesh's prefill and decode step make
no host sync under ``set_sync_debug_mode("error")``. Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_lm_mesh.py

Without a card every test here skips."""

import dataclasses

import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.lm import LM, Batch, MeshLM

pytestmark = pytest.mark.gpu
LOGITS_TOL, CACHE_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mesh(cuda):
    if torch.cuda.device_count() >= 4:
        return mesh_mod.from_cards(1, 4)
    return mesh_mod.Mesh([[cuda] * 4])


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _batch(cfg, b, n_text, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, n_text), generator=g, device=dev,
                         dtype=torch.int32)
    prefix = None
    if cfg.frontend == "vision":
        prefix = torch.randn((b, cfg.n_prefix, cfg.d_model), generator=g,
                             device=dev) * 0.02
    return Batch(tokens=toks, prefix_embeds=prefix)


def _serve(model, batch, cache_len, n_new):
    cache = model.init_cache(batch.tokens.shape[0], cache_len)
    s = batch.tokens.shape[1] + (0 if batch.prefix_embeds is None
                                 else batch.prefix_embeds.shape[1])
    logits, cache = model.prefill(batch, cache)
    out, toks = [logits], [logits.argmax(-1)]
    for i in range(n_new):
        logits, cache = model.decode_step(cache, toks[-1], s + i)
        out.append(logits)
        toks.append(logits.argmax(-1))
    return out, torch.stack(toks, 1), cache, s


def _near(got, want, tol, what):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * scale, (what, err, scale)


def _mesh_vs_one(cfg, mesh, dev, *, b, n_text, cache_len, n_new=4):
    one = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    model = MeshLM.from_lm(one, mesh)
    batch = _batch(cfg, b, n_text, dev, 1)
    with torch.no_grad():
        want, want_toks, want_cache, _ = _serve(one, batch, cache_len, n_new)
        fa_ops.launches_by_device.clear()
        got, toks, cache, s = _serve(model, batch, cache_len, n_new)
        by_dev = dict(fa_ops.launches_by_device)
        for i, (a, w) in enumerate(zip(got, want)):
            _near(a, w, LOGITS_TOL, f"logits {i}")
        assert torch.equal(toks, want_toks)
        full = cache.gather(dev)
        _near(full.k, want_cache.k, CACHE_TOL, "k")
        _near(full.v, want_cache.v, CACHE_TOL, "v")
    return model, batch, by_dev, s


@pytest.mark.parametrize("arch", ["llava-next-34b", "qwen3-4b",
                                  "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_smoke_mesh_matches_one_device(cuda, mesh, no_tf32, arch):
    """Smoke configs: K/V gathered (llava, qwen3 at width 4), TP inside
    experts (qwen2-moe), EP (moonshot)."""
    cfg = cfg_base.get_smoke(arch)
    _, _, by_dev, _ = _mesh_vs_one(cfg, mesh, cuda, b=4, n_text=24,
                                   cache_len=48)
    want = {}
    for row in mesh.devices:
        for x in row:
            want[str(x)] = want.get(str(x), 0) + cfg.n_layers
    assert by_dev == want


@pytest.mark.parametrize("arch,n_text,cache_len",
                         [("llava-next-34b", 200, 800),
                          ("moonshot-v1-16b-a3b", 256, 288)])
def test_full_width_mesh_matches_one_device_and_syncs_nothing(
        cuda, mesh, no_tf32, arch, n_text, cache_len):
    """Full width cut to 2 layers, f32 (chip_smoke.py phase 24 (a))."""
    cfg = dataclasses.replace(cfg_base.get(arch), n_layers=2,
                              dtype="float32")
    model, batch, _, s = _mesh_vs_one(cfg, mesh, cuda, b=2, n_text=n_text,
                                      cache_len=cache_len)
    cache = model.init_cache(2, cache_len)
    tok = torch.zeros(2, dtype=torch.int32, device=cuda)
    mesh.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            model.prefill(batch, cache)
            model.decode_step(cache, tok, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mesh.synchronize()


@pytest.mark.parametrize("shape", [(4, 4096, 14, 2, 128), (4, 2048, 4, 4, 128),
                                   (2, 776, 14, 2, 128)], ids=str)
def test_k5_at_per_rank_shapes_matches_plain(cuda, shape):
    """K5 at the mesh's per-rank shapes over 4 model ranks: LLaVA-NeXT-34B
    (14 Q, 2 KV heads), Moonshot (4 MHA heads), and the f32 check's
    LLaVA prompt (576 + 200 positions) in bf16."""
    b, s, h, hkv, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (h, hkv, hkv))
    got = fa_ops.flash_attention(q, k, v, causal=True).float()
    want = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=True)
    torch.testing.assert_close(got, want, atol=fa_ref.BF16_ATOL,
                               rtol=fa_ref.BF16_RTOL)
