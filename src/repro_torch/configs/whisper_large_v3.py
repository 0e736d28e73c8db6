"""whisper-large-v3 [arXiv:2212.04356]: enc-dec audio, 32L enc + 32L dec,
d_model=1280, 20 heads (MHA: kv=20), d_ff=5120, vocab=51866.

Conv frontend is a STUB: input_specs() supplies precomputed (b, frames, 1280)
log-mel frame embeddings. Decoder has causal self-attn + cross-attn;
sinusoidal positions; pre-LN (whisper uses LayerNorm, GELU MLP).
"""
from repro_torch.configs.base import register
from repro_torch.models.model import ModelConfig


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        pattern=("attn",),
        mlp_kind="gelu",
        norm_kind="ln",
        pos_kind="sinusoidal",
        enc_dec=True,
        n_enc_layers=32,
        frontend="audio_stub",
        tie_embeddings=True,
        sub_quadratic=False,   # full-attention encoder
    )
