"""moonshot-v1-16b-a3b — MoE, 64 routed experts top-6 (+2 shared, per the
Moonlight reference config). [hf:moonshotai/Moonlight-16B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=1408,  # per-expert width
    vocab=163840,
    n_experts=64,
    top_k=6,
    n_shared=2,
    rope_theta=50_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=32,
        vocab=256,
        n_experts=8,
        top_k=2,
        n_shared=1,
        dtype="float32",
    )
