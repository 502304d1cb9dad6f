"""RecurrentGemma-2B / Griffin [arXiv:2402.19427]: hybrid 26L d=2560
10H (MQA kv=1, local window 2048), d_ff=7680 GeGLU, RG-LRU width 2560,
pattern 2 recurrent : 1 local-attention. Runs long_500k natively."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    pattern=("rec", "rec", "attn"), window=2048,
    rglru_width=2560, conv_width=4,
    rope_theta=10_000.0, act="geglu", long_variant="native",
)
