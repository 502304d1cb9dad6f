"""Phi-3-mini 3.8B [arXiv:2404.14219]: dense 32L d=3072 32H (kv=32)
d_ff=8192, vocab 32064, RoPE + SwiGLU."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    pattern=("attn",), rope_theta=10_000.0, act="swiglu",
    long_variant="swa",
)
