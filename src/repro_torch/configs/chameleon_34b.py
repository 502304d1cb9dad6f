"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM, 48L d=8192 64H (kv=8)
d_ff=22016, vocab 65536 (text + VQ image tokens share the vocab — the
early-fusion design means image tokens ARE tokens; no patch stub needed),
qk-norm as in the paper."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    pattern=("attn",), qk_norm=True,
    rope_theta=10_000.0, act="swiglu", long_variant="swa",
)
