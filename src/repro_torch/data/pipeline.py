"""Deterministic synthetic data pipeline (host substrate; ports
``src/repro/data/pipeline.py``).

Everything the training loops consume comes through here: token streams for
LM training, graph batches for GNNs, id/label streams for recsys, and the
paper's dynamic edge-batch stream.  All streams are:
  * deterministic per (seed, step) — a restarted job regenerates the exact
    batch sequence from the checkpoint step;
  * prefetchable — ``prefetch(it, depth)`` overlaps host generation with
    device compute via a background thread;
  * placed on ``device=`` (default the card; pass ``device="cpu"`` for the
    CPU), the same values as the reference's arrays.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# generic machinery
# ---------------------------------------------------------------------------

def counted_stream(make_batch: Callable[[int], Dict], *, start: int = 0
                   ) -> Iterator[Dict]:
    step = start
    while True:
        yield make_batch(step)
        step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetcher (host→device overlap)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


def _put(a: np.ndarray, dtype: torch.dtype, dev: torch.device
         ) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def lm_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
              start: int = 0, device="cuda"
              ) -> Iterator[Dict[str, torch.Tensor]]:
    """Markov-ish synthetic token stream: learnable but non-trivial.

    tokens[t+1] = (a·tokens[t] + noise) mod vocab gives next-token structure
    a model can actually fit — smoke-scale loss curves are meaningful.
    """
    a = 31
    dev = resolve_device(device)

    def make(step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((seed, step))
        x = np.empty((batch, seq + 1), np.int64)
        x[:, 0] = rng.integers(0, vocab, batch)
        noise = rng.integers(0, 7, (batch, seq))
        for t in range(seq):
            x[:, t + 1] = (a * x[:, t] + noise[:, t]) % vocab
        return {"tokens": _put(x[:, :-1], torch.int32, dev),
                "labels": _put(x[:, 1:], torch.int32, dev)}

    return counted_stream(make, start=start)


# ---------------------------------------------------------------------------
# GNN batches
# ---------------------------------------------------------------------------

def gnn_full_graph_batch(*, n: int, e: int, d_feat: int, n_out: int,
                         seed: int = 0, with_pos: bool = False,
                         device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {
        "nodes": _put(rng.normal(size=(n, d_feat)).astype(np.float32),
                      torch.float32, dev),
        "senders": _put(rng.integers(0, n, e).astype(np.int32),
                        torch.int32, dev),
        "receivers": _put(rng.integers(0, n, e).astype(np.int32),
                          torch.int32, dev),
        "labels": _put(rng.integers(0, n_out, n).astype(np.int32),
                       torch.int32, dev),
    }
    if with_pos:
        out["pos"] = _put(rng.normal(size=(n, 3)).astype(np.float32),
                          torch.float32, dev)
    return out


def graphsage_minibatch_stream(sampler, feats: np.ndarray,
                               labels: np.ndarray, *, batch_nodes: int,
                               fanouts: Sequence[int], seed: int = 0,
                               start: int = 0, device="cuda"
                               ) -> Iterator[Dict]:
    """Wraps the real neighbor sampler into the trainer batch format."""
    dev = resolve_device(device)

    def make(step: int) -> Dict:
        rng = np.random.default_rng((seed, step))
        seeds = rng.integers(0, sampler.n, size=batch_nodes)
        hops = sampler.sample_block(seeds, fanouts, rng)
        batch = {f"hop{i}": _put(np.asarray(feats[h], np.float32),
                                 torch.float32, dev)
                 for i, h in enumerate(hops)}
        batch["labels"] = _put(np.asarray(labels[seeds], np.int32),
                               torch.int32, dev)
        return batch

    return counted_stream(make, start=start)


# ---------------------------------------------------------------------------
# recsys stream
# ---------------------------------------------------------------------------

def recsys_stream(n_fields: int, rows_per_field: int, batch: int, *,
                  seed: int = 0, start: int = 0, device="cuda"
                  ) -> Iterator[Dict]:
    """CTR stream with planted structure: the label correlates with a hash
    of two field ids, so AUC above 0.5 is learnable."""
    dev = resolve_device(device)
    offsets = np.arange(n_fields, dtype=np.int64) * rows_per_field

    def make(step: int) -> Dict:
        rng = np.random.default_rng((seed, step))
        local = rng.integers(0, rows_per_field, (batch, n_fields))
        ids = local + offsets[None, :]
        signal = ((local[:, 0] ^ local[:, 1 % n_fields]) % 7) < 3
        flip = rng.random(batch) < 0.2
        labels = np.where(flip, ~signal, signal).astype(np.float32)
        return {"ids": _put(ids, torch.int32, dev),
                "labels": _put(labels, torch.float32, dev)}

    return counted_stream(make, start=start)


# ---------------------------------------------------------------------------
# dynamic-graph batch stream (the paper's workload)
# ---------------------------------------------------------------------------

def dynamic_graph_stream(hg, *, batch_frac: float, seed: int = 0,
                         deletions_frac: float = 0.5):
    """Yields (HostGraph_t-1, HostGraph_t, deletions, insertions) forever."""
    from repro_torch.core.delta import random_batch
    step = 0
    while True:
        dels, ins = random_batch(hg, batch_frac, seed=(seed + step),
                                 deletions_frac=deletions_frac)
        hg_new = hg.apply_batch(dels, ins)
        yield hg, hg_new, dels, ins
        hg = hg_new
        step += 1
