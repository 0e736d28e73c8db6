"""internvl2-26b [arXiv:2404.16821]: VLM — InternViT frontend (STUB: patch
embeddings precomputed, n_prefix=1024) + InternLM2-20B backbone: 48L,
d_model=6144, 48 heads (GQA kv=8), head_dim=128, d_ff=16384 SwiGLU,
vocab=92553."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("internvl2-26b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        pattern=("attn",),
        mlp_kind="swiglu",
        frontend="vision_stub",
        n_prefix=1024,
        tie_embeddings=False,
        sub_quadratic=False,
    )
