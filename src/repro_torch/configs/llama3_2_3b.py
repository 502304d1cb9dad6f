"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-*]: dense 28L d=3072 24H (kv=8)
d_ff=8192, vocab 128256, RoPE + SwiGLU + GQA."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=128,
    pattern=("attn",), rope_theta=500_000.0, act="swiglu",
    long_variant="swa",
)
