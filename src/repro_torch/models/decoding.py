"""Autoregressive decoding over KV caches: prefill and batched greedy or
temperature generation. The port of ``repro.models.decoding``.

``prefill`` is ``forward(..., return_cache=True)``, so prefill attention
runs the flash-attention kernel on the card; decode steps attend over the
cache with plain tensor code, as the reference does. An encoder-decoder
(whisper) takes its frames at prefill, which encodes them inside the
forward, and the encoder's output at every decode step; ``generate``
encodes once more for the steps, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import transformer as T
from .common import ArchConfig


def make_serve_step(cfg: ArchConfig, *, window_override: Optional[int] = None,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """Returns serve_step(params, cache, tokens, pos, enc_out=None) ->
    (next (B, 1), logits, cache): greedy, or sampled at ``temperature``
    from ``generator``; ``enc_out`` as in
    :func:`~repro_torch.models.transformer.decode_step`."""
    def serve_step(params, cache, tokens, pos, enc_out=None):
        logits, cache = T.decode_step(cfg, params, cache, tokens, pos,
                                      enc_out=enc_out,
                                      window_override=window_override)
        last = logits[:, -1, : cfg.vocab_size].to(torch.float32)
        if temperature > 0.0:
            nxt = torch.multinomial(torch.softmax(last / temperature, -1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[:, None], logits, cache
    return serve_step


def prefill(cfg: ArchConfig, params, tokens, max_len: int, *,
            enc_frames=None, patch_embeds=None,
            window_override: Optional[int] = None):
    """Run the full-sequence forward and return (logits, cache) with the
    cache sized to ``max_len`` (prompt written at positions [0, S));
    ``enc_frames`` and ``patch_embeds`` as in
    :func:`~repro_torch.models.transformer.forward`."""
    logits, _, cache = T.forward(cfg, params, tokens, enc_frames=enc_frames,
                                 patch_embeds=patch_embeds, return_cache=True,
                                 cache_len=max_len,
                                 window_override=window_override)
    return logits, cache


@torch.no_grad()
def generate(cfg: ArchConfig, params, prompt, n_new: int, *,
             temperature: float = 0.0, seed: int = 0, enc_frames=None,
             window_override: Optional[int] = None):
    """Greedy/temperature generation. prompt: (B, S) int64 -> (B, n_new).

    The first new token is the prefill's argmax, as in the reference; with
    ``temperature > 0`` the rest are sampled from a ``torch.Generator``
    seeded with ``seed`` on the prompt's device. An encoder-decoder takes
    ``enc_frames`` (B, F, d): the prefill encodes them inside its forward
    and the decode steps attend to one more encoding of them.
    """
    s = prompt.shape[1]
    enc_out = T.encode(cfg, params, enc_frames) if cfg.enc_dec else None
    logits, cache = prefill(cfg, params, prompt, s + n_new,
                            enc_frames=enc_frames,
                            window_override=window_override)
    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(seed)
    step = make_serve_step(cfg, window_override=window_override,
                           temperature=temperature, generator=generator)
    last = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None]
    out = [last]
    for t in range(n_new - 1):
        last, _, cache = step(params, cache, last, s + t, enc_out)
        out.append(last)
    return torch.cat(out, dim=1)
