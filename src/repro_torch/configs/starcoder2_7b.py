"""starcoder2-7b [arXiv:2402.19173]: dense 32L, d_model=4608, 36 heads
(GQA kv=4), d_ff=18432, vocab=49152, RoPE, GELU MLP (starcoder2 uses
pre-LN + gelu; we keep LN to match)."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        pattern=("attn",),
        mlp_kind="gelu",
        norm_kind="ln",
        rope_theta=1e5,
        sub_quadratic=False,
    )
