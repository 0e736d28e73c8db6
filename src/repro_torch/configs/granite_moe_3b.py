"""granite-moe-3b-a800m [hf:ibm-granite]: MoE 32L, d_model=1536, 24 heads
(GQA kv=8), vocab=49155, 40 experts top-8, d_ff=512 per expert (SwiGLU)."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        pattern=("attn",),
        mlp_kind="swiglu",
        moe_experts=40,
        moe_top_k=8,
        moe_d_ff=512,
        sub_quadratic=False,
    )
