"""Whisper-tiny [arXiv:2212.04356]: enc-dec 4+4L d=384 6H d_ff=1536,
vocab 51865, GELU + LayerNorm + learned positions. No conv/mel frontend:
the encoder takes precomputed frame embeddings (B, n_frames, d_model)."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    pattern=("xattn",), enc_dec=True, n_enc_layers=4, n_frames=1500,
    act="gelu", norm="layer", pos_emb="learned", long_variant="swa",
)
