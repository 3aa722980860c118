"""Synthetic LM token stream with deterministic, shardable batches (the
port's own copy of ``repro.data.tokens``: numpy only, the same seeds,
bitwise the same arrays).

For training the LM architectures the stream mixes Zipfian unigrams with
deterministic k-gram "rules", so that a model *can* reduce its loss
below the unigram entropy: enough signal to validate training end to end
without external data.

The loader is **fault-tolerance friendly**: batch ``i`` is a pure
function of (seed, step, shard), so a restarted or re-sharded job
regenerates the exact same stream from the checkpointed step counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int = 1024
    seq_len: int = 256
    seed: int = 1234
    rule_order: int = 3  # k-gram determinism injected into the stream
    rule_frac: float = 0.5  # fraction of positions that follow a rule


def _zipf_probs(vocab: int, s: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks**s
    return p / p.sum()


def batch_at_step(
    cfg: TokenStreamConfig, step: int, batch_size: int, shard: int = 0,
    num_shards: int = 1,
) -> dict[str, np.ndarray]:
    """Deterministic batch for (step, shard): {'tokens', 'labels'}, int32
    (batch_size // num_shards, seq_len), labels the tokens shifted by one."""
    rng = np.random.RandomState(
        (cfg.seed * 1_000_003 + step) % (2**31) + shard * 7919
    )
    bs = batch_size // num_shards
    probs = _zipf_probs(cfg.vocab)
    toks = rng.choice(cfg.vocab, size=(bs, cfg.seq_len + 1), p=probs)
    # deterministic k-gram rule: token := hash of the previous k tokens
    k = cfg.rule_order
    rule_mask = rng.rand(bs, cfg.seq_len + 1) < cfg.rule_frac
    for t in range(k, cfg.seq_len + 1):
        ctx = toks[:, t - k : t]
        ruled = (ctx * np.array([17, 31, 101][:k])).sum(1) % cfg.vocab
        toks[:, t] = np.where(rule_mask[:, t], ruled, toks[:, t])
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
