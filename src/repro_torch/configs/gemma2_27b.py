"""gemma2-27b [arXiv:2408.00118]: dense 46L, d_model=4608, 32 heads
(GQA kv=16), head_dim=128, d_ff=36864 GeGLU, vocab=256000.

Alternating local(4096):global 1:1, attn logit softcap 50, final softcap 30,
pre+post RMSNorm per sub-block, embed scaled by sqrt(d)."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("gemma2-27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        pattern=("local", "attn"),
        window=4096,
        mlp_kind="geglu",
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norm=True,
        embed_scale=True,
        sub_quadratic=False,   # half the layers are full global attention
    )
