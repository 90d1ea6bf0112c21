"""zamba2-1.2b — hybrid: Mamba2 backbone + weight-shared attention block
applied every 6 layers. [arXiv:2411.15242; hf]

The published model interleaves a single shared transformer block (attention
+ MLP, one parameter set) at a fixed cadence over the Mamba2 stack; we
reproduce that structure (cadence ``attn_every=6`` -> ceil(38/6)=7
applications) with the shared block's own KV caches per application site.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_head=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=16,
        attn_every=2,
        dtype="float32",
    )
