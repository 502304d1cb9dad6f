"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks d=2048, 4 heads, 7 mLSTM : 1
sLSTM pattern, no separate FFN (d_ff=0; blocks carry their own
projections). Attention-free: long requests run natively from (C, n, m)."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    mlstm_heads=4, proj_factor=2.0, conv_width=4,
    pos_emb="none", act="geglu", long_variant="native",
)
