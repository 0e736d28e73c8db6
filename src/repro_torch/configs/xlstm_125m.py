"""xlstm-125m [arXiv:2405.04517]: 12L, d_model=768, 4 heads, head_dim=192,
no separate FFN (d_ff=0 — xLSTM blocks carry their own projections),
vocab=50304. Alternating mLSTM (matrix memory, chunkwise-parallel) and
sLSTM (scalar memory, sequential) blocks, with a constant-size state."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("xlstm-125m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        pattern=("mlstm", "slstm"),
        mlp_kind="none",
        pos_kind="none",
        lstm_chunk=128,
        sub_quadratic=True,
    )
