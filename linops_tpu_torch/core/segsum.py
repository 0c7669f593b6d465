"""Segment sums in a fixed order: the port's deterministic scatter-add.

On CUDA ``index_add_`` adds with atomics in no fixed order, so a rerun can
change the bits of a float result. Every sum the port scatters follows a
plan instead (``segment_plan``): a stable sort of the contributions by the
segment they add into (a stable sort keeps index order inside a segment,
the order of the reference's sequential ``segment_sum``), then a tree of
fixed shape. Each level gathers a segment's entries, ``WIDTH`` at a time,
into the rows of a (chunks, ``WIDTH``) block padded with zeros and sums
each row; the
row sums of one segment are the next level's entries, until a segment holds
one. Every step is a gather or a ``torch.sum`` over a fixed axis, so the
result is the same on every run, and no step is a sequential walk along a
long segment. Building a plan reads sizes back to the host; operators build
theirs once and keep them beside their data, as ``BSROperator`` keeps K2's
column plan.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["SegmentPlan", "segment_plan", "segment_sum"]

WIDTH = 16  # entries a tree level sums per row


class SegmentPlan(NamedTuple):
    """Level i gathers ``index[i]`` (chunks, WIDTH) from the previous level's
    entries (the contributions for i = 0) with one zero entry appended, which
    the slots past a segment's end point at, and sums each row. Segment s
    then takes entry ``out[s]`` of the last level (the zero when s is
    empty)."""

    index: Tuple[torch.Tensor, ...]
    out: torch.Tensor


def _index_dtype(n: int):
    return torch.int32 if n < 2 ** 31 else torch.int64


def segment_plan(seg, nseg: int, *, is_sorted: bool = False) -> SegmentPlan:
    """The plan that sums contribution k into segment ``seg[k]`` (any shape,
    flattened) of ``nseg``; ``is_sorted`` when ``seg`` is non-decreasing."""
    seg = seg.reshape(-1).long()
    dev = seg.device
    if is_sorted:
        pos = torch.arange(seg.numel(), device=dev)
        seg_s = seg
    else:
        pos = torch.argsort(seg, stable=True)
        seg_s = seg.index_select(0, pos)
    counts = torch.bincount(seg_s, minlength=nseg)
    index = []
    n = seg.numel()  # entries at this level; entry n is the appended zero
    while n and int(counts.max()) > 1:
        first = torch.cumsum(counts, 0) - counts  # each segment's first sorted entry
        rank = torch.arange(n, device=dev) - first[seg_s]
        chunks = (counts + WIDTH - 1) // WIDTH
        nchunk = int(chunks.sum())
        chunk = (torch.cumsum(chunks, 0) - chunks)[seg_s] + rank // WIDTH
        idx = torch.full((nchunk, WIDTH), n, dtype=_index_dtype(n + 1), device=dev)
        idx[chunk, rank % WIDTH] = pos.to(idx.dtype)
        index.append(idx)
        # the chunk sums, in segment order, are the next level's entries
        seg_s = torch.repeat_interleave(torch.arange(nseg, device=dev), chunks)
        pos = torch.arange(nchunk, device=dev)
        counts, n = chunks, nchunk
    out = torch.full((nseg,), n, dtype=torch.int64, device=dev)
    out[seg_s] = pos
    return SegmentPlan(tuple(index), out)


def _with_zero(vals):
    return torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])


def segment_sum(contrib, plan: SegmentPlan):
    """``out[s] = Σ contrib[k]`` over the k of segment s, added in the plan's
    fixed tree; ``contrib`` is (nnz, ...) in the order ``seg`` was given,
    and ``out`` (nseg, ...) in its dtype. Empty segments are zero."""
    vals = contrib
    for idx in plan.index:
        g = _with_zero(vals).index_select(0, idx.reshape(-1))
        vals = g.reshape(idx.shape + vals.shape[1:]).sum(dim=1, dtype=vals.dtype)
    return _with_zero(vals).index_select(0, plan.out)
