"""Place-recognition retrieval: the DBoW3 replacement, on torch tensors.

Port of ``ydorbslam_tpu/slam/retrieval.py``.  The reference scores BoW
vectors from a hierarchical k-means vocabulary through an inverted file
(src/keyFrameDatabase.cpp); the JAX package replaces both with a
vocabulary-free multi-bank LSH, and so does this port:

  * each 256-bit descriptor hashes into H=4 banks of 4096 words (12
    sampled bit positions per bank, from ``RandomState(0x10C4)``, so the
    banks are the JAX package's);
  * a keyframe is a dense (H*4096,) L1-normalised tf histogram and a
    word-presence row;
  * "common words" is one presence product over all keyframes, and the
    similarity is DBoW3's L1 score, 1 - 0.5*|v - w|_1, against every
    keyframe at once.

Candidate gating follows KeyFrameDatabase::detectLoopCandidates /
detectRelocalizationCandidates (keyFrameDatabase.cpp:26-180): exclude
covisibles, > 0.8 x max common words, score >= min_score, covisibility
group accumulation, keep > 0.75 x best.  Both top-k selections go
through ``ops.select.stable_topk`` (ties to the lower index, as
``jax.lax.top_k``).  The two float sums (the L1 distance over all words
and a group's neighbour scores) accumulate in float64 and round once to
float32, so the card and the CPU rank candidates alike; the JAX
package's float32 sums differ from them by a few ulps.

Descriptors are the port's int32 views of the uint32 words: ``(d >> b)
& 1`` is the bit b for every b, bit 31 included, because ``& 1`` drops
the sign extension.  The index holds two (K, H*4096) float32 tables:
21 MB at K = 160 keyframes, 67 MB at the default K = 512.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.scatter import scatter_add, scatter_set
from ..ops.select import stable_topk

N_BANKS = 4  # default bank geometry (config: loop.retrieval_banks)
BANK_BITS = 12  # config: loop.retrieval_bank_bits


@functools.lru_cache()
def _hash_bit_positions(n_banks: int = N_BANKS, bank_bits: int = BANK_BITS) -> np.ndarray:
    """(n_banks, bank_bits) fixed random bit indices into the 256 bits."""
    rs = np.random.RandomState(0x10C4)
    return np.stack(
        [rs.choice(256, bank_bits, replace=False) for _ in range(n_banks)]
    ).astype(np.int32)


@functools.lru_cache()
def _hash_tables(n_banks: int, bank_bits: int, device: torch.device):
    """(lane int64, bit, weight, offset int32) tables of the hash on
    ``device``, copied there once."""
    pos = _hash_bit_positions(n_banks, bank_bits)
    tabs = ((pos // 32).astype(np.int64), pos % 32,
            (1 << np.arange(bank_bits)).astype(np.int32),
            (np.arange(n_banks) << bank_bits).astype(np.int32))
    return tuple(torch.from_numpy(a).to(device) for a in tabs)


def descriptor_words(desc: torch.Tensor, n_banks: int = N_BANKS,
                     bank_bits: int = BANK_BITS) -> torch.Tensor:
    """(N, 8) int32 descriptor words -> (N, n_banks) int32 word ids."""
    lane, bit, weight, offset = _hash_tables(n_banks, bank_bits, desc.device)
    bits = (desc[:, lane] >> bit) & 1  # (N, H, B)
    return torch.sum(bits * weight, dim=-1, dtype=torch.int32) + offset


def bow_histogram(desc: torch.Tensor, valid: torch.Tensor, n_banks: int = N_BANKS,
                  bank_bits: int = BANK_BITS) -> torch.Tensor:
    """(N, 8) + (N,) -> (n_words,) L1-normalised tf histogram.  Invalid
    keypoints go to an overflow bin that is dropped, so a frame without
    a valid keypoint gives the zero histogram."""
    n_words = n_banks * (1 << bank_bits)
    words = descriptor_words(desc, n_banks, bank_bits)
    w = torch.where(valid[:, None], words, n_words)
    zeros = torch.zeros((n_words + 1,), dtype=torch.float32, device=desc.device)
    hist = scatter_add(zeros, w.reshape(-1), 1.0)[:n_words]
    return hist / torch.clamp(hist.sum(), min=1e-6)


class RetrievalIndex(NamedTuple):
    """Per-keyframe BoW state on the device."""

    hist: torch.Tensor  # (K, n_words) f32 normalized tf
    presence: torch.Tensor  # (K, n_words) f32 0/1
    valid: torch.Tensor  # (K,) bool


def empty_index(K: int, n_banks: int = N_BANKS, bank_bits: int = BANK_BITS,
                device="cuda") -> RetrievalIndex:
    n_words = n_banks * (1 << bank_bits)
    return RetrievalIndex(
        hist=torch.zeros((K, n_words), dtype=torch.float32, device=device),
        presence=torch.zeros((K, n_words), dtype=torch.float32, device=device),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def add_keyframe(idx: RetrievalIndex, kf_id, desc: torch.Tensor, kp_valid: torch.Tensor,
                 n_banks: int = N_BANKS, bank_bits: int = BANK_BITS) -> RetrievalIndex:
    """KeyFrameDatabase::add: the keyframe's histogram and presence row."""
    h = bow_histogram(desc, kp_valid, n_banks, bank_bits)
    return RetrievalIndex(
        hist=scatter_set(idx.hist, kf_id, h),
        presence=scatter_set(idx.presence, kf_id, (h > 0).to(torch.float32)),
        valid=scatter_set(idx.valid, kf_id, True),
    )


def remove_keyframes(idx: RetrievalIndex, kf_ids: torch.Tensor) -> RetrievalIndex:
    """Batched KeyFrameDatabase::erase: clear every id in ``kf_ids``
    ((R,) int, -1 padded; the padding rows are dropped)."""
    K = idx.valid.shape[0]
    rows = torch.where(kf_ids >= 0, kf_ids, K)
    return RetrievalIndex(
        hist=scatter_set(idx.hist, rows, 0.0),
        presence=scatter_set(idx.presence, rows, 0.0),
        valid=scatter_set(idx.valid, rows, False),
    )


def remove_keyframe(idx: RetrievalIndex, kf_id) -> RetrievalIndex:
    """KeyFrameDatabase::erase of one keyframe: ``remove_keyframes`` with
    one id."""
    return remove_keyframes(idx, torch.full((1,), kf_id, dtype=torch.int64,
                                            device=idx.valid.device))


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Row sums of float32 values accumulated in float64 and rounded once
    to float32: the same bits on the CPU and on the card, whatever order
    the device reduces in."""
    return torch.sum(x, dim=-1, dtype=torch.float64).to(torch.float32)


def score_all(idx: RetrievalIndex, query_hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (common words (K,), L1 score (K,)) of the query against every
    keyframe.  The common-word counts are exact integers in float32."""
    qp = (query_hist > 0).to(torch.float32)
    common = idx.presence @ qp
    score = 1.0 - 0.5 * _sum_f32(torch.abs(idx.hist - query_hist[None, :]))
    return torch.where(idx.valid, common, 0.0), torch.where(idx.valid, score, -1.0)


def detect_candidates(
    idx: RetrievalIndex,
    query_hist: torch.Tensor,
    connected: torch.Tensor,  # (K,) bool: covisible group of the query (excluded)
    covis: torch.Tensor,  # (K,K) i32 covisibility weights (for group scores)
    min_score,  # scalar gate (loop: min covis score; reloc: -1)
    max_out: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated candidate detection (keyFrameDatabase.cpp:26-105).  Returns
    (candidate keyframe ids (max_out,) padded -1, their accumulated group
    scores)."""
    common, score = score_all(idx, query_hist)
    eligible = idx.valid & ~connected
    common = torch.where(eligible, common, 0.0)
    ok = eligible & (common > 0.8 * torch.max(common)) & (score >= min_score) & (common > 0)
    base = torch.where(ok, score, 0.0)
    # Group accumulation: each candidate adds the scores of its top-10
    # covisible neighbours that are candidates too.
    top_w, top_i = stable_topk(covis, min(10, covis.shape[0]))
    acc = base + _sum_f32(torch.where(top_w > 0, base[top_i], 0.0))
    acc = torch.where(ok, acc, -1.0)
    keep = ok & (acc > 0.75 * torch.max(acc))
    vals, ids = stable_topk(torch.where(keep, acc, -1.0), max_out)
    return torch.where(vals > 0, ids, -1), vals
