"""Data pipeline, the port of ``repro.data.pipeline``: deterministic
synthetic LM token streams (document-style, EOS-delimited, Zipfian
unigrams with a bigram mixing kernel so the loss is learnable), shardable
by pod for the consensus trainer, and the Ising data module feeding the
paper's estimators.

Tokens are drawn with numpy's ``RandomState`` seeded exactly as the
reference seeds it, so batch ``i`` of shard ``h`` equals the reference's
array for array; it is a pure function of (seed, h, i), the property
checkpoint resume relies on. Batches reach the device as int64 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.sampling import exact_sample, gibbs_sample
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512


class SyntheticLM:
    """Deterministic synthetic token stream with document structure, put on
    ``device`` (default the CUDA card)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = 1.0 / ranks ** cfg.zipf_a
        self._probs = probs / probs.sum()

    def arrays(self, index: int, shard: int = 0,
               n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Batch ``index`` for shard ``shard`` as int32 numpy arrays, the
        reference's values."""
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + index * 9_973 + shard * 7) % 2**31)
        toks = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # bigram structure: with prob .5 next token = (prev * 31 + 7) % V
        mix = rng.rand(b, cfg.seq_len) < 0.5
        nxt = (toks[:, :-1] * 31 + 7) % cfg.vocab_size
        toks[:, 1:] = np.where(mix, nxt, toks[:, 1:])
        # EOS-delimited documents
        doc_breaks = rng.rand(b, cfg.seq_len + 1) < (1.0 / cfg.mean_doc_len)
        toks = np.where(doc_breaks, cfg.eos_id, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def to_device(self, arrays: Dict[str, np.ndarray]) -> Dict:
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   dtype=torch.int64).to(self.device)
                for k, v in arrays.items()}

    def batch(self, index: int, shard: int = 0, n_shards: int = 1) -> Dict:
        """Batch ``index`` for shard ``shard``: a pure function of its
        inputs; (b, S) int64 ``tokens`` and ``labels`` on the device."""
        return self.to_device(self.arrays(index, shard, n_shards))

    def __iter__(self) -> Iterator[Dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def pod_sharded_batches(ds: SyntheticLM, n_pods: int, h_steps: int,
                        start_round: int = 0) -> Iterator[Dict]:
    """Batches for one consensus round: (P, H, local_batch, S) tensors.

    Each pod sees a DISJOINT slice of the stream: the paper's per-sensor
    local datasets X_A(i). Stacked on the host, copied once a round."""
    r = start_round
    while True:
        per_pod = [[ds.arrays(r * h_steps + h, shard=pod, n_shards=n_pods)
                    for h in range(h_steps)] for pod in range(n_pods)]
        yield ds.to_device({k: np.stack([np.stack([a[k] for a in steps])
                                         for steps in per_pod])
                            for k in ("tokens", "labels")})
        r += 1


def ising_batches(model, n: int, n_batches: int,
                  generator: torch.Generator, sampler: str = "gibbs"):
    """Streaming Ising datasets for the paper's estimators, drawn on the
    device of ``model.theta`` from ``generator`` (a generator of that
    device), which carries on from batch to batch."""
    for _ in range(n_batches):
        if sampler == "exact":
            yield exact_sample(model, n, generator)
        else:
            yield gibbs_sample(model, n, generator)
