"""recurrentgemma-2b (Griffin) [arXiv:2402.19427]: 26L, d_model=2560,
10 heads (GQA kv=1), d_ff=7680 GeGLU, vocab=256000.

Pattern: (rec, rec, local) — RG-LRU : local attention = 2 : 1, local window
2048. d_rnn = d_model. 26 = 8 periods of 3 + remainder (rec, rec).
"""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        pattern=("rec", "rec", "local"),
        window=2048,
        mlp_kind="geglu",
        embed_scale=True,
        d_rnn=2560,
        conv_width=4,
        sub_quadratic=True,    # O(1) recurrent state + windowed KV
    )
