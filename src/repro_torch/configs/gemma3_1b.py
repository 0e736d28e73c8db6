"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L, d_model=1152, 4 heads (GQA kv=1),
d_ff=6912 GeGLU, vocab=262144. 5:1 local:global (window 512), 128k-class.

26 = 4 periods of 6 (5 local + 1 global) + remainder (local, local):
5/6 of the layers hold a 512-window KV cache, the global ones a
full-length one."""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("gemma3-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=288,
        d_ff=6912,
        vocab_size=262144,
        pattern=("local", "local", "local", "local", "local", "attn"),
        window=512,
        mlp_kind="geglu",
        embed_scale=True,
        rope_theta=1e6,
        sub_quadratic=True,
    )
