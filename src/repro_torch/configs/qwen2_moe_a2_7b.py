"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16)
MoE 60 experts top-4 + 4 shared experts (d_expert=1408), vocab 151936."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    pattern=("attn_moe",),
    n_experts=60, experts_per_tok=4, n_shared_experts=4, d_expert=1408,
    rope_theta=1_000_000.0, act="swiglu", long_variant="swa",
)
