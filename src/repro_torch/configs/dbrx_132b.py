"""dbrx-132b [hf:databricks/dbrx-base]: MoE 40L, d_model=6144, 48 heads
(GQA kv=8), head_dim=128, vocab=100352, 16 experts top-4, d_ff=10752
per expert (GLU), rope_theta=5e5, fine-grained MoE."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        pattern=("attn",),
        mlp_kind="swiglu",
        moe_experts=16,
        moe_top_k=4,
        moe_d_ff=10752,
        rope_theta=5e5,
        tie_embeddings=False,
        sub_quadratic=False,
    )
