"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]: dense 40L,
d_model=5120, 32 heads (GQA kv=8), head_dim=128, d_ff=14336 SwiGLU,
vocab=131072, full attention (128k ctx), rope_theta=1e6."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("mistral-nemo-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        pattern=("attn",),
        mlp_kind="swiglu",
        rope_theta=1e6,
        tie_embeddings=False,
        sub_quadratic=False,
    )
