"""A copy of ``repro.data.pipeline`` (numpy only; the port imports nothing of the
JAX package), so the port's streams and subgraphs are bit-equal to the
reference's.

Synthetic data generators — deterministic, host-side (numpy), streaming.

Everything yields ready-to-device dicts with *static shapes* so a single
compiled step serves the whole run.  Deterministic per (seed, step) — a
restart resumes the stream exactly, which the checkpoint manifest relies on
(fault tolerance includes the data pipeline, not just the params).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

__all__ = [
    "lm_batch_stream",
    "mind_batch_stream",
    "synthetic_graph",
    "molecule_batch_stream",
]


def lm_batch_stream(
    *, batch: int, seq_len: int, vocab: int, seed: int = 0, start_step: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Zipf-ish synthetic token stream (skewed like natural text ranks)."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        # zipf over the vocab, clipped; cheap and rank-skewed
        raw = rng.zipf(1.3, size=(batch, seq_len + 1))
        toks = np.minimum(raw - 1, vocab - 1).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:], "step": step}
        step += 1


def mind_batch_stream(
    *,
    batch: int,
    n_items: int,
    hist_len: int,
    n_profile_feats: int,
    profile_bag_len: int,
    n_interests: int,
    n_negatives: int,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        hist = rng.integers(0, n_items, (batch, hist_len)).astype(np.int32)
        hlen = rng.integers(4, hist_len + 1, batch)
        hmask = np.arange(hist_len)[None, :] < hlen[:, None]
        yield {
            "hist_ids": hist,
            "hist_mask": hmask,
            "profile_ids": rng.integers(0, n_profile_feats, (batch, profile_bag_len)).astype(np.int32),
            "profile_mask": np.ones((batch, profile_bag_len), bool),
            "routing_logits_init": rng.normal(size=(batch, n_interests, hist_len)).astype(np.float32),
            "target_id": rng.integers(0, n_items, batch).astype(np.int32),
            "neg_ids": rng.integers(0, n_items, (batch, n_negatives)).astype(np.int32),
            "step": step,
        }
        step += 1


def synthetic_graph(
    *,
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int,
    seed: int = 0,
    feat_cols: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Random graph with power-law-ish degree for full-batch cells.

    Edge endpoints are drawn from a squared-uniform so a few hub nodes get
    large degree (closer to citation/product graphs than Erdos-Renyi)."""
    rng = np.random.default_rng(seed)
    u = (rng.uniform(size=n_edges) ** 2 * n_nodes).astype(np.int64) % n_nodes
    v = rng.integers(0, n_nodes, n_edges)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return {
        "node_feat": feat,
        "edge_index": np.stack([u, v]).astype(np.int32),
        "edge_mask": np.ones(n_edges, bool),
        "node_mask": np.ones(n_nodes, bool),
        "labels": labels,
    }


def molecule_batch_stream(
    *,
    batch: int,
    n_atoms: int,
    n_edges: int,
    n_species: int,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batched small molecular graphs (positions + species + radius edges)."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        pos = rng.normal(size=(batch, n_atoms, 3)).astype(np.float32) * 2.0
        species = rng.integers(0, n_species, (batch, n_atoms)).astype(np.int32)
        # radius-graph edges (host side): nearest pairs up to n_edges
        src = rng.integers(0, n_atoms, (batch, n_edges)).astype(np.int32)
        dst = rng.integers(0, n_atoms, (batch, n_edges)).astype(np.int32)
        energy = rng.normal(size=(batch,)).astype(np.float32)
        yield {
            "positions": pos,
            "species": species,
            "edge_index": np.stack([src, dst], axis=1),   # (B, 2, E)
            "edge_mask": (src != dst),
            "node_mask": np.ones((batch, n_atoms), bool),
            "energy": energy,
            "step": step,
        }
        step += 1
