"""Shape stand-ins for every (arch x shape) cell (port of
repro.launch.specs): tensors on the ``meta`` device, so a full-width
config is laid out (``launch.sharding``) without allocating anything.
``enc_len_for``/``text_len_for`` centralize the modality-stub conventions
(audio frames = seq//4; vision prefix = cfg.n_prefix patches).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, Batch

META = torch.device("meta")


def enc_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Audio-frame (encoder) length for encdec archs: seq//4."""
    return seq_len // 4 if cfg.family == "encdec" else 0


def text_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Token positions = seq minus the vision prefix."""
    if cfg.frontend == "vision":
        return seq_len - cfg.n_prefix
    return seq_len


def batch_specs(cfg: ModelConfig, seq_len: int, batch: int,
                *, with_labels: bool) -> Batch:
    s = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt,
                                                   device=META)
    st = text_len_for(cfg, seq_len)
    prefix = enc = None
    if cfg.frontend == "vision":
        prefix = s(batch, cfg.n_prefix, cfg.d_model, dt=cfg.torch_dtype)
    if cfg.family == "encdec":
        enc = s(batch, enc_len_for(cfg, seq_len), cfg.d_model,
                dt=cfg.torch_dtype)
    return Batch(tokens=s(batch, st),
                 labels=s(batch, st) if with_labels else None,
                 prefix_embeds=prefix, enc_embeds=enc)


def _meta(model: LM) -> LM:
    return LM(model.cfg, device=META)


def param_shapes(model: LM) -> dict:
    """The params tree of ``model``'s config, meta tensors (the port's
    layout: ``layers`` a list of per-layer dicts)."""
    return _meta(model).init(torch.Generator()).params.tree()


def cache_shapes(model: LM, batch: int, seq_len: int):
    return _meta(model).init_cache(batch, seq_len,
                                   enc_len=enc_len_for(model.cfg, seq_len))


def decode_token_specs(batch: int):
    return (torch.empty((batch,), dtype=torch.int32, device=META),
            torch.empty((), dtype=torch.int32, device=META))
