"""Architecture registry of the port: ``get(arch_id)`` -> ArchConfig,
``reduced(cfg)`` -> a CPU-sized variant of the same family.

``ARCH_IDS`` and ``ALIASES`` list every architecture of the reference, and
each has a config here.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.common import ArchConfig

ARCH_IDS = (
    "qwen2_moe_a2_7b",
    "phi3_mini_3_8b",
    "whisper_tiny",
    "llama3_2_3b",
    "glm4_9b",
    "recurrentgemma_2b",
    "chameleon_34b",
    "llama4_scout_17b_a16e",
    "minicpm3_4b",
    "xlstm_1_3b",
)

# external ids (dashes) map to module names (underscores)
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get(arch_id: str) -> ArchConfig:
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; known: "
                         f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"{__name__}.{mod_name}").CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to a CPU-runnable variant of the same family:
    <=2 pattern repeats, d_model<=256, <=4 experts, tiny vocab, float32."""
    n_layers = len(cfg.pattern) * min(2, max(1, cfg.n_units))
    d_model = min(cfg.d_model, 256)
    n_heads = max(2, min(cfg.n_heads, 4))
    hd = d_model // n_heads
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads >= cfg.n_heads:
        n_kv = n_heads
    repl = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024),
        window=min(cfg.window, 64) if cfg.window else 0,
        max_target_len=2048,
        dtype="float32",
    )
    if cfg.n_experts:
        repl.update(n_experts=4,
                    experts_per_tok=min(cfg.experts_per_tok, 2),
                    n_shared_experts=min(cfg.n_shared_experts, 1),
                    d_expert=min(cfg.d_expert or 256, 256))
    if cfg.enc_dec:
        repl.update(n_enc_layers=2, n_frames=16)
    if cfg.n_patches:
        repl.update(n_patches=4)
    if cfg.rglru_width:
        repl.update(rglru_width=d_model)
    if cfg.attn_kind == "mla":
        repl.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                    qk_rope_dim=16, v_head_dim=32, head_dim=48)
    if cfg.mlstm_heads:
        repl.update(mlstm_heads=2)
    return dataclasses.replace(cfg, **repl)
