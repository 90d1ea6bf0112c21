"""llava-next-34b — VLM: dense GQA decoder backbone + anyres patch-embedding
frontend STUB. [hf:llava-hf/llava-v1.6; unverified]

The vision tower is a stub per the assignment: ``input_specs()`` provides
``n_prefix`` precomputed patch embeddings (anyres tiling is metadata only);
the backbone sees [patch embeds | token embeds].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    frontend="vision",
    n_prefix=576,  # one 24x24 patch grid (anyres base tile)
    rope_theta=5_000_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        frontend="vision",
        n_prefix=16,
        dtype="float32",
    )
