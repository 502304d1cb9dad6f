"""GLM-4-9B [hf:THUDM/glm-4-9b]: dense 40L d=4096 32H (kv=2) d_ff=13696,
vocab 151552, RoPE + SwiGLU + extreme GQA (kv=2)."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552, head_dim=128,
    pattern=("attn",), rope_theta=10_000.0, act="swiglu",
    long_variant="swa",
)
