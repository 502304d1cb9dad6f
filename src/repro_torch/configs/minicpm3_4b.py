"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense 62L d=2560 40H with MLA
(multi-head latent attention: q_lora=768, kv_lora=256, nope=64, rope=32,
v=64), d_ff=6400, vocab 73448. Decode caches the compressed latent."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=96,
    pattern=("attn",), attn_kind="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64,
    rope_theta=10_000.0, act="swiglu", long_variant="swa",
)
