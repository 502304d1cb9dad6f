"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E]: MoE 48L
d=5120 40H (kv=8), 16 routed experts top-1 + 1 shared (d_expert=8192),
vocab 202048, early fusion: vision encoder is a STUB — input_specs supplies
precomputed patch embeddings fused at the sequence head."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    pattern=("attn_moe",),
    n_experts=16, experts_per_tok=1, n_shared_experts=1, d_expert=8192,
    n_patches=64,
    rope_theta=500_000.0, act="swiglu", long_variant="swa",
)
