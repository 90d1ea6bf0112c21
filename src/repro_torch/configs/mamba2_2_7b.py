"""mamba2-2.7b — attention-free SSD (state-space duality) stack.
[arXiv:2405.21060; unverified]

d_inner = 2*d_model = 5120, head_dim 64 -> 80 SSD heads, state N=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        d_ff=0,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=16,
        dtype="float32",
    )
