"""Keyframe-sharded place-recognition scoring over a ``ShardGroup``.

Port of ``ydorbslam_tpu/parallel/retrieval_sharded.py``: each rank scores
the query against its block of the keyframe axis of the index (the
(K/n, N_WORDS) histograms and presence rows are only read there), then
the small results cross the ranks by ``all_gather`` in rank order.  A
row's score is the same arithmetic as ``slam.retrieval.score_all`` (the
L1 sum accumulated in float64 and rounded once), and a row's sum never
crosses ranks, so the gathered scores are bit-equal to ``score_all``'s.
"""
from __future__ import annotations

import torch

from ..ops.select import stable_topk
from ..slam.retrieval import RetrievalIndex, score_all
from .multihost import ShardGroup, all_gather_rows, shard_rows


def _local_index(idx: RetrievalIndex, g: ShardGroup) -> RetrievalIndex:
    return RetrievalIndex(*(shard_rows(x, g) for x in idx))


def sharded_topk_scores(g: ShardGroup, idx: RetrievalIndex, query_hist: torch.Tensor, k: int = 8):
    """-> (global keyframe ids (k,), scores (k,)) of the best-scoring
    keyframes: each rank's top ``min(k, K/n)`` of its block, gathered
    (k * n candidates), then the top k of those; ties go to the lower id
    (``stable_topk``, the order of ``jax.lax.top_k``)."""
    K = idx.hist.shape[0]
    kl = min(k, K // g.size)
    _, score = score_all(_local_index(idx, g), query_hist)
    vals, local_ids = stable_topk(score, kl)
    gids = local_ids + g.rank * (K // g.size)
    all_vals = all_gather_rows(vals, g)
    all_gids = all_gather_rows(gids, g)
    best, sel = stable_topk(all_vals, k)
    return all_gids[sel], best


def score_all_sharded(g: ShardGroup, idx: RetrievalIndex, query_hist: torch.Tensor):
    """``slam.retrieval.score_all`` with the keyframe axis sharded:
    -> (common words (K,), L1 score (K,)), bit-equal to ``score_all``."""
    common, score = score_all(_local_index(idx, g), query_hist)
    return all_gather_rows(common, g), all_gather_rows(score, g)
