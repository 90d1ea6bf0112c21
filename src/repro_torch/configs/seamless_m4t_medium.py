"""seamless-m4t-medium — encoder-decoder, multimodal (audio frontend stub).
[arXiv:2308.11596; hf]

12L is interpreted as 12 encoder + 12 decoder layers (the m4t-medium text
model is 12/12). The speech frontend is a STUB per the assignment:
``input_specs()`` provides precomputed audio-frame embeddings of length
seq_len//4 (≈20ms frames after the conformer downsampling) as encoder
input; the decoder consumes tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,  # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=4096,
    vocab=256206,
    frontend="audio",
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        n_layers=2,
        enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        frontend="audio",
        dtype="float32",
    )
