"""Clos-routed unstructured SpMV: the host pack and the device pipeline.

Counterpart of ``linops_tpu/sparse/routed.py``. ``x[cols]`` over scattered
columns is a fine-grained gather; this module turns an unstructured SpMV into
a fixed sequence of gathers within rows of 128 lanes (the lane-gather kernels
K7-K13, ``kernels/lane_gather.py``):

1. **Pack (host, numpy):** nnz are laid out column-block-major, each
   128-column block's segment padded to a multiple of 128, so fetching
   ``x[col]`` for a 128-lane window is one lane gather from a single
   128-element x block. Rows are split into width-``w`` sub-row slots.
2. **Route:** moving each product from its gather position to its row slot
   is a static permutation, realised by a radix-128 Clos network
   (``sparse/routing.py``): 3 or 5 crossbars, each one lane gather; the
   wirings between them are plain tensor transposes. The input crossbar
   (G1) folds into the pack's ordering.
3. **Apply (device):** phase-1 gather·multiply (K8, or K9 with a transposed
   output for 5-stage routes), the crossbar chain (K7), and the last
   crossbar fused with the width-w slot sum (K10).
4. **Combine:** rows are tiled by 128 and each tile's sub-rows padded to a
   shared slot count K at pack time, so the partial→row reduction is a
   per-window contiguous segment sum (K11); a program whose segment bounds
   were dropped takes the tiled combine (K13), which accepts any row order
   within a tile. Pathological tiles fall back to a chain of routed
   ``ReducePass`` rounds.

The transpose runs the same network backwards (``RoutedTranspose``), ending
in K12. Matrices beyond one routing domain (2^21 slots) are chunked by row
tiles; chunks share shapes and every kernel call spans all of them.

The pack's arrays are bit-identical to the reference's. ``use_kernel``
(the reference's ``use_pallas``) selects the kernel pipeline; by default it
is taken for CUDA tensors whose result is f32 or bf16, and the plain
pipeline (``torch.gather`` and fixed-order segment sums) otherwise. On CPU tensors
the kernel pipeline runs the kernels' plain versions.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.base import default_device
from ..kernels import lane_gather as LG
from .formats import check_int32_range
from .routing import RADIX, clos_route

__all__ = ["ReducePass", "RoutedSpMV", "RoutedTranspose", "pack_routed_csr", "upload_program",
           "routed_matvec", "routed_rmatvec", "routed_matmat", "routed_rmatmat",
           "CLOS_MAX_SLOTS"]

CLOS_MID = RADIX * RADIX          # 16384: largest 3-stage domain
CLOS_MAX_SLOTS = RADIX ** 3       # 2^21: largest single routing domain
_REDUCE_U = 8                     # combine-pass window (divides 128)
TILED_MAX_K = 32768               # per-tile slot cap for the tiled combine

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class ReducePass(NamedTuple):
    """One routed combine pass: slice per-chunk input spans, pad each to the
    shared domain N, route, reshape-sum by u, concatenate."""

    stages: tuple            # full crossbar list (G1 first), (C, ...) int8
    u: int                   # reshape-sum width
    n_in: int                # padded per-chunk domain size N
    in_spans: tuple          # per-chunk (lo, hi) input position spans
    out_keep: tuple          # per-chunk kept output length


class RoutedSpMV(NamedTuple):
    """A packed routing program (C chunks sharing a slot count N = m·128).

    vals/lane_idx are in post-G1 column-block-major window order; ``stages``
    holds the remaining crossbar index arrays (0, 2 or 4 of them). The
    middle (G3) crossbar is lane-padded to 128 when B < 128 so it stays a
    128-lane gather."""

    vals: torch.Tensor       # (C, m, 128) products' left factors (0 at pads)
    lane_idx: torch.Tensor   # (C, m, 128) int8: col % 128
    win_block: torch.Tensor  # (C, m) int32: x block id per window
    stages: tuple            # per-stage (C, ...) int8 gather arrays
    rowid: torch.Tensor      # (T8, K) int8 row-within-tile per sub-row slot
    #                          (-1 = trash); None for the trivial layout and
    #                          the ReducePass fallback
    passes: tuple            # ReducePass combine chain (fallback / empty)
    comb_lo: torch.Tensor    # (T8·K/128, 128) int8 segsum combine boundaries
    comb_hi: torch.Tensor
    shape: Tuple[int, int]   # (nrow, ncol)
    w: int                   # slots per sub-row (divides 128)
    chunk_keep: tuple        # per-chunk kept partial count

    @property
    def nnz_slots(self):
        return self.vals.shape[0] * self.vals.shape[1] * RADIX


class RoutedTranspose(NamedTuple):
    """Transpose program derived from the forward pack (no second router run).

    A Clos route is a sequence of per-window lane permutations and fixed
    wirings; its inverse is the reversed sequence of per-window inverse
    permutations with the same wirings. ``Aᵀu`` therefore expands u to the
    row slots, routes back to the pre-G1 column-block-major positions,
    multiplies by the pre-G1 values and sums per column: same-column entries
    are contiguous within each window, so that is the boundary segment sum
    (K12), and each column block's per-window sums are gathered and summed.
    """

    vals_pre: torch.Tensor     # (C, m, 128) pre-G1 values (0 at pads)
    g1inv: torch.Tensor        # (C, m, 128) int8: inverse input crossbar
    expand_tile: torch.Tensor  # (C, m) int32: u-tile id per slot window
    expand_idx: torch.Tensor   # (C, m, 128) int8: row-within-tile ∘ G5⁻¹
    stages_t: tuple            # inverse middle crossbars, per-stage (C, ...)
    bnd_lo: torch.Tensor       # (C, m, 128) int8: column-run boundaries
    bnd_hi: torch.Tensor       # (C, m, 128) int8
    win_rows: torch.Tensor     # (nb, Wb) int32: S rows per column block (the
    #                            index C·m points at an appended zero row)
    n_tiles: int               # u is padded to n_tiles·128
    shape: Tuple[int, int]     # forward (nrow, ncol)


def _invert_rows(g):
    """Per-row inverse of row-wise permutations: inv[r, g[r, c]] = c."""
    g = np.asarray(g)
    inv = np.empty(g.shape, np.int32)
    np.put_along_axis(
        inv, np.asarray(g, np.int64),
        np.broadcast_to(np.arange(g.shape[1], dtype=np.int32), g.shape), axis=1)
    return inv


def upload_program(prog, device):
    """A program (``RoutedSpMV``, ``RoutedTranspose``, ``ReducePass`` or a
    tuple of them) with every numpy leaf as a tensor on ``device``; tensors
    are moved, everything else is kept."""
    if isinstance(prog, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(prog)).to(device)
    if isinstance(prog, torch.Tensor):
        return prog.to(device)
    if isinstance(prog, tuple):
        items = (upload_program(v, device) for v in prog)
        return type(prog)(*items) if hasattr(prog, "_fields") else tuple(items)
    return prog


# ----------------------------------------------------------------------------
# Pack (host, numpy)
# ----------------------------------------------------------------------------


def _clos_size(slots: int) -> int:
    """Smallest valid Clos domain size ≥ slots (≤ CLOS_MAX_SLOTS). 5-stage
    domains are rounded so B = N/16384 is a multiple of 8, as the reference
    rounds them (its kernels' tile rule), so both packs stay identical."""
    if slots <= CLOS_MID:
        return max(-(-slots // RADIX) * RADIX, RADIX)
    step = 8 * CLOS_MID
    return -(-slots // step) * step


def _auto_width(nnz_row: np.ndarray) -> int:
    """The w minimising the tile-padded slot count T·K(w)·w."""
    n_r = nnz_row.shape[0]
    tiles = np.arange(n_r) // RADIX
    T = -(-n_r // RADIX)
    best, best_cost = 8, None
    for w in (4, 8, 16, 32, 64, 128):
        n_sub = -(-nnz_row // w)
        tile_cnt = np.bincount(tiles, weights=n_sub.astype(np.float64), minlength=T)
        K = max(-(-int(tile_cnt.max(initial=1.0)) // RADIX) * RADIX, RADIX)
        cost = T * K * w
        if best_cost is None or cost < best_cost:
            best, best_cost = w, cost
    return best


def _col_padded_slots(cols: np.ndarray) -> int:
    """Column-side slots: each nonempty 128-column block padded to ×128."""
    counts = np.unique(cols // RADIX, return_counts=True)[1]
    return int(((-(-counts // RADIX)) * RADIX).sum())


def _pad_middle_stage(stages):
    """Lane-pad the middle crossbar of a 5-stage route when B < 128."""
    stages = list(stages)
    if len(stages) == 5:
        g3 = stages[2]
        if g3.shape[1] < RADIX:
            stages[2] = np.pad(g3, ((0, 0), (0, RADIX - g3.shape[1])))
    return stages


def _clos_route_fast(dest):
    """The native router (the same stage arrays, far faster at 2^21 slots),
    or the numpy router where the native one cannot be built."""
    from ..native import clos_route_native

    r = clos_route_native(dest)
    return r if r is not None else clos_route(dest)


def _route_int8(dest):
    """clos_route + middle-stage padding + int8 cast."""
    return [g.astype(np.int8) for g in _pad_middle_stage(_clos_route_fast(dest))]


def _build_reduce_passes(seg0: np.ndarray, n_rows: int, up):
    """The routed combine chain. seg0: row id per initial partial position
    (-1 = trash), nondecreasing over the real entries. After the final pass,
    position r of the output holds y[r]."""
    passes = []
    seg = seg0
    while True:
        real = seg >= 0
        pos_real = np.flatnonzero(real)
        segs = seg[pos_real]
        counts = np.bincount(segs, minlength=n_rows)
        final = counts.max(initial=0) <= _REDUCE_U
        if final:
            u = int(2 ** np.ceil(np.log2(max(int(counts.max(initial=1)), 1))))
            u = max(u, 1)
            gcnt = np.ones(n_rows, np.int64)
            gbase = np.arange(n_rows, dtype=np.int64)
        else:
            u = _REDUCE_U
            gcnt = -(-counts // u)
            cum = np.zeros(n_rows + 1, np.int64)
            np.cumsum(gcnt, out=cum[1:])
            gbase = cum[:-1]

        # rank of each real element within its row (real entries sorted)
        starts = np.zeros(n_rows + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(segs.shape[0]) - starts[segs]
        dest_of_real = (gbase[segs] + rank // u) * u + rank % u

        # input position upper bound per row (for row-range chunking)
        row_hi = np.zeros(n_rows, np.int64)
        np.maximum.at(row_hi, segs, pos_real + 1)
        row_hi = np.maximum.accumulate(row_hi)

        chunks = []  # (r0, r1, in_lo, in_hi)
        r0, in_lo = 0, 0

        def fits(r0, r1, in_lo):
            in_hi = max(int(row_hi[r1 - 1]), in_lo)
            out_span = int((gbase[r1 - 1] + gcnt[r1 - 1] - gbase[r0]) * u)
            return max(in_hi - in_lo, out_span) <= CLOS_MAX_SLOTS

        while r0 < n_rows:
            if fits(r0, n_rows, in_lo):
                r1 = n_rows
            else:
                lo, hi = r0 + 1, n_rows
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if fits(r0, mid, in_lo):
                        lo = mid
                    else:
                        hi = mid - 1
                r1 = lo
            in_hi = max(int(row_hi[r1 - 1]), in_lo)
            # positions past the last real one are all trash and are dropped,
            # never routed
            chunks.append((r0, r1, in_lo, in_hi))
            r0, in_lo = r1, in_hi

        N = 1
        for (r0c, r1c, ilo, ihi) in chunks:
            out_span = int((gbase[r1c - 1] + gcnt[r1c - 1] - gbase[r0c]) * u)
            N = max(N, _clos_size(max(ihi - ilo, out_span)))

        stage_l, next_seg_parts, out_keep = [], [], []
        for (r0c, r1c, ilo, ihi) in chunks:
            out_base = int(gbase[r0c]) * u
            mask = (pos_real >= ilo) & (pos_real < ihi)
            dest_c = np.full(N, -1, np.int64)
            dest_c[pos_real[mask] - ilo] = dest_of_real[mask] - out_base
            realc = dest_c >= 0
            used = np.zeros(N, bool)
            used[dest_c[realc]] = True
            dest = np.empty(N, np.int64)
            dest[realc] = dest_c[realc]
            dest[~realc] = np.flatnonzero(~used)  # trash + pads -> free slots
            stage_l.append(_route_int8(dest))
            grp_rows = np.repeat(np.arange(r0c, r1c), gcnt[r0c:r1c])
            seg_part = np.full(N // u, -1, np.int64)
            seg_part[: grp_rows.shape[0]] = grp_rows
            next_seg_parts.append(seg_part)
            out_keep.append(r1c - r0c if final else N // u)

        passes.append(ReducePass(
            stages=tuple(up(np.stack([s[i] for s in stage_l]))
                         for i in range(len(stage_l[0]))),
            u=int(u), n_in=int(N),
            in_spans=tuple((int(a), int(b)) for (_, _, a, b) in chunks),
            out_keep=tuple(int(k) for k in out_keep),
        ))
        if final:
            break
        seg = np.concatenate(next_seg_parts)
    return tuple(passes)


def _run_bounds(keys, lanes, n_windows):
    """Per-window segment boundaries for the segsum kernels.

    keys = window·128 + output lane per entry (sorted nondecreasing); lanes
    = source lane of the entry within its window (sorted within each key
    run). Returns (lo, hi) int8 (n_windows, 128): hi = last lane of the run
    (-1 empty), lo = first lane - 1 (-1 when starting at lane 0)."""
    first = np.full(n_windows * RADIX, -1, np.int16)
    last = np.full(n_windows * RADIX, -1, np.int16)
    if keys.size:
        change = np.empty(keys.shape[0], bool)
        change[0] = True
        change[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(change)
        ends = np.r_[starts[1:], keys.shape[0]] - 1
        first[keys[starts]] = lanes[starts]
        last[keys[starts]] = lanes[ends]
    hi = last.astype(np.int8).reshape(n_windows, RADIX)
    lo = np.where(last >= 0, first - 1, -1).astype(np.int8).reshape(n_windows, RADIX)
    return lo, hi


def pack_routed_csr(data, indices, indptr, shape, w="auto", dtype=None,
                    with_transpose=False, to_device=True, device=None):
    """Pack host CSR arrays into a ``RoutedSpMV`` routing program.

    ``with_transpose=True`` also returns the derived transpose program
    (``RoutedTranspose``), or None when the layout cannot support it
    (ReducePass-fallback combines, or column-count skew that would blow up
    the per-block window gather), as a second tuple element.

    ``to_device=False`` leaves every leaf a numpy array (ReducePass stages
    included); ``upload_program`` moves such a program later. Otherwise the
    leaves are tensors on ``device``, the CUDA device by default (see
    ``core.base.default_device``).
    """
    if to_device:
        dev = default_device(device, "pack_routed_csr")
        def _up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    else:
        def _up(a):
            return a
    n_r, n_c = int(shape[0]), int(shape[1])
    check_int32_range(shape, int(data.shape[0]))
    data = np.asarray(data)
    if dtype is not None:
        data = data.astype(dtype)
    indices = np.asarray(indices, np.int64)
    indptr = np.asarray(indptr, np.int64)
    nnz = int(data.shape[0])
    if nnz == 0:
        raise ValueError("cannot route an empty matrix")
    if indptr.shape[0] != n_r + 1 or indptr[0] != 0 or indptr[-1] != nnz:
        raise ValueError(
            f"indptr must be (nrow+1,) with indptr[0]=0, indptr[-1]=nnz; got "
            f"shape {indptr.shape}, ends ({indptr[0]}, {indptr[-1]}) vs nnz {nnz}")
    nnz_row = np.diff(indptr)
    if (nnz_row < 0).any():
        raise ValueError("indptr must be nondecreasing")
    if indices.min(initial=0) < 0 or indices.max(initial=0) >= n_c:
        raise ValueError("column indices out of range")
    if w == "auto":
        w = _auto_width(nnz_row)
    if RADIX % w:
        raise ValueError(f"w must divide {RADIX}, got {w}")

    # sub-rows: row r contributes ceil(nnz_r / w) of them, in row order
    n_sub = -(-nnz_row // w)
    S0 = int(n_sub.sum())
    sub_base = np.zeros(n_r + 1, np.int64)
    np.cumsum(n_sub, out=sub_base[1:])
    row_of_sub = np.repeat(np.arange(n_r, dtype=np.int64), n_sub)
    # nnz range covered by each sub-row (CSR order is contiguous per row)
    j_of_sub = np.arange(S0) - np.repeat(sub_base[:-1], n_sub)
    sub_start = np.repeat(indptr[:-1], n_sub) + j_of_sub * w
    sub_end = np.minimum(sub_start + w, np.repeat(indptr[1:], n_sub))

    row_of_nnz = np.repeat(np.arange(n_r, dtype=np.int64), nnz_row)
    k_in_row = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], nnz_row)
    sub_of_nnz = sub_base[row_of_nnz] + k_in_row // w

    # combine layout: tile rows by 128 and pad every tile's sub-row list to a
    # shared K, so the partial->row reduction is one tile-local segment sum;
    # the routed ReducePass chain is the fallback for pathological tiles
    T = -(-n_r // RADIX)
    tile_cnt = np.bincount(row_of_sub // RADIX, minlength=T).astype(np.int64)
    K = max(-(-int(tile_cnt.max(initial=1)) // RADIX) * RADIX, RADIX)
    trivial = bool((n_sub == 1).all())
    tiled = (not trivial) and K * w <= CLOS_MAX_SLOTS and K <= TILED_MAX_K

    rowid = None
    if trivial:
        # every row is exactly one sub-row: partials ARE the rows
        dest_global = sub_of_nnz * w + k_in_row % w
    elif tiled:
        tile_first = np.zeros(T + 1, np.int64)
        np.cumsum(tile_cnt, out=tile_first[1:])
        tile_of_sub = row_of_sub // RADIX
        slot_of_sub = tile_of_sub * K + (np.arange(S0) - tile_first[tile_of_sub])
        dest_global = slot_of_sub[sub_of_nnz] * w + k_in_row % w
        T8 = -(-T // 8) * 8  # tiles padded to 8, as the reference pads them
        rowid = np.full((T8, K), -1, np.int8)
        rowid[tile_of_sub, slot_of_sub - tile_of_sub * K] = (row_of_sub % RADIX).astype(np.int8)
    else:
        dest_global = sub_of_nnz * w + k_in_row % w

    # chunk split: contiguous slot ranges (tile-aligned when tiled) fitting
    # both the sub-row slots and the padded column-side layout in one domain
    if tiled:
        unit_slots, n_units = K * w, T

        def nnz_range(t0, t1):
            return indptr[t0 * RADIX], indptr[min(t1 * RADIX, n_r)]
    else:
        unit_slots, n_units = w, S0

        def nnz_range(s0, s1):
            return sub_start[s0], sub_end[s1 - 1]

    def fits(u0, u1, cap):
        if (u1 - u0) * unit_slots > cap:
            return False
        lo, hi = nnz_range(u0, u1)
        return _col_padded_slots(indices[lo:hi]) <= cap

    # derived-transpose eligibility: the trivial layout additionally needs
    # chunk starts aligned so every slot window maps to ONE u-tile
    align_ok = True
    q_align = max(RADIX // w, 1) if (with_transpose and trivial) else 1

    bounds = [0]
    while bounds[-1] < n_units:
        u0 = bounds[-1]
        lo = u0 + 1
        hi = min(u0 + CLOS_MAX_SLOTS // unit_slots, n_units)
        if fits(u0, hi, CLOS_MAX_SLOTS):
            if hi < n_units and hi % q_align:
                hi -= hi % q_align  # keep the NEXT chunk's start aligned
                if hi <= u0:
                    align_ok = False
                    hi = min(u0 + CLOS_MAX_SLOTS // unit_slots, n_units)
            bounds.append(hi)
            continue
        while lo < hi:  # largest u1 with fits(u0, u1)
            mid = (lo + hi + 1) // 2
            if fits(u0, mid, CLOS_MAX_SLOTS):
                lo = mid
            else:
                hi = mid - 1
        if lo == u0:
            raise ValueError(
                "a single row tile exceeds the routing domain; use the "
                "gather/segment-sum CSR path for this pattern")
        if lo < n_units and lo % q_align:
            lo_al = lo - lo % q_align
            if lo_al > u0:
                lo = lo_al
            else:
                align_ok = False
        bounds.append(lo)
    # rebalance multi-chunk splits to equal sizes: stacked chunks share one
    # domain N = max over chunks, and the greedy split leaves a half-empty
    # last chunk padded up to the full ones. Keep the greedy bounds when a
    # balanced chunk fails the fits() check.
    if len(bounds) > 2:
        nch = len(bounds) - 1
        per = -(-n_units // nch)
        if q_align > 1:
            per = -(-per // q_align) * q_align
        bal = [min(i * per, n_units) for i in range(nch)] + [n_units]
        if (all(b1 > b0 for b0, b1 in zip(bal[:-1], bal[1:]))
                and all(fits(b0, b1, CLOS_MAX_SLOTS) for b0, b1 in zip(bal[:-1], bal[1:]))):
            bounds = bal
    chunks = list(zip(bounds[:-1], bounds[1:]))
    derive_t = with_transpose and (trivial or tiled) and align_ok

    # shared domain size N across chunks (stacking requires equal shapes)
    N = 0
    for u0, u1 in chunks:
        lo, hi = nnz_range(u0, u1)
        need = max((u1 - u0) * unit_slots, _col_padded_slots(indices[lo:hi]))
        N = max(N, _clos_size(need))

    m = N // RADIX
    T8 = -(-T // 8) * 8 if tiled else T
    blk_win_rows = [[] for _ in range(-(-n_c // RADIX))] if derive_t else None

    def _pack_chunk(c_u0_u1):
        # a pure function of read-only outer arrays: a multi-chunk pack fans
        # out over threads (numpy and the native router release the GIL)
        c, (u0, u1) = c_u0_u1
        lo, hi = nnz_range(u0, u1)
        cols_c = indices[lo:hi]
        vals_c = data[lo:hi]
        dest_c = dest_global[lo:hi] - u0 * unit_slots
        nnz_c = cols_c.shape[0]

        # column-block-major layout with per-block ×128 padding, entries
        # sorted by column: same-column contiguity per window is what makes
        # the derived transpose's segsum possible
        blk = cols_c // RADIX
        order = np.argsort(cols_c, kind="stable")
        ublk, counts = np.unique(blk, return_counts=True)
        padded = (-(-counts // RADIX)) * RADIX
        seg_off = np.zeros(ublk.shape[0] + 1, np.int64)
        np.cumsum(padded, out=seg_off[1:])
        rank = np.arange(nnz_c) - np.repeat(np.concatenate([[0], np.cumsum(counts)])[:-1], counts)
        pos = np.repeat(seg_off[:-1], counts) + rank  # column-side position

        col_in = np.zeros(N, np.int64)
        val_in = np.zeros(N, data.dtype)
        col_in[: seg_off[-1]] = np.repeat(ublk * RADIX, padded)  # pad cols
        col_in[pos] = cols_c[order]
        val_in[pos] = vals_c[order]

        # destination permutation: real nnz to their slots, pads to the
        # remaining (row-pad + trash) slots in order
        is_real = np.zeros(N, bool)
        is_real[pos] = True
        used = np.zeros(N, bool)
        used[dest_c] = True
        dest = np.empty(N, np.int64)
        dest[pos] = dest_c[order]
        dest[~is_real] = np.flatnonzero(~used)

        stages = _clos_route_fast(dest)
        g1 = stages[0]
        f_vals = np.take_along_axis(val_in.reshape(m, RADIX), g1, axis=1)
        f_lane = np.take_along_axis((col_in % RADIX).reshape(m, RADIX), g1, axis=1).astype(np.int8)
        f_winb = (col_in.reshape(m, RADIX)[:, 0] // RADIX).astype(np.int32)
        f_stages = [g.astype(np.int8) for g in _pad_middle_stage(stages)[1:]]

        if not derive_t:
            return f_vals, f_lane, f_winb, f_stages, None

        # ---- derived transpose: invert the stage arrays (O(N)) ----
        g1inv_store = _invert_rows(g1)
        if len(stages) > 1:
            inv_last = _invert_rows(stages[-1])
        else:
            inv_last = np.broadcast_to(np.arange(RADIX, dtype=np.int32), (m, RADIX))
        if len(stages) == 5:
            ig3 = _invert_rows(stages[2])
            if ig3.shape[1] < RADIX:  # mirror _pad_middle_stage
                ig3 = np.pad(ig3, ((0, 0), (0, RADIX - ig3.shape[1])))
            st_t = [_invert_rows(stages[3]).astype(np.int8), ig3.astype(np.int8),
                    _invert_rows(stages[1]).astype(np.int8)]
        elif len(stages) == 3:
            st_t = [_invert_rows(stages[1]).astype(np.int8)]
        else:
            st_t = []

        # expand: slot window i draws u[row] from tile expand_tile[i] with the
        # per-slot row id composed through the final inverse crossbar. Values
        # entering non-real slots are annihilated downstream (the forward
        # pack maps pad positions onto exactly the non-real slots and pad
        # positions carry vals_pre = 0), so clips are safe.
        widx = np.arange(m, dtype=np.int64)[:, None] * RADIX + inv_last
        if tiled:
            lt = (np.arange(m, dtype=np.int64) * RADIX) // (K * w)
            tg = np.minimum(u0 + lt, T8 - 1)
            sub = (widx % (K * w)) // w
            eidx = rowid[tg[:, None], sub]
            etile = tg.astype(np.int32)
        else:  # trivial: sub-row == row; chunk starts are q_align-aligned
            rows_g = u0 + widx // w
            etile = np.minimum((u0 + np.arange(m, dtype=np.int64) * (RADIX // w)) // RADIX,
                               T - 1).astype(np.int32)
            eidx = (np.minimum(rows_g, n_r - 1) % RADIX).astype(np.int8)

        # per-window column-run boundaries at the pre-G1 layout (sorted by
        # construction: pos is ascending and within-block order is by col)
        lcol = (cols_c[order] % RADIX).astype(np.int64)
        keys = (pos // RADIX) * RADIX + lcol
        blo, bhi = _run_bounds(keys, pos % RADIX, m)

        # the final per-block gather: S rows (global, chunk-major) holding
        # each block's per-window column sums
        win_entries = [
            (int(ublk[j]), range(c * m + int(seg_off[j] // RADIX),
                                 c * m + int(seg_off[j + 1] // RADIX)))
            for j in range(ublk.shape[0])
        ]
        tpart = (np.maximum(eidx.astype(np.int16), 0).astype(np.int8), etile,
                 g1inv_store.astype(np.int8), st_t, val_in.reshape(m, RADIX), blo, bhi,
                 win_entries)
        return f_vals, f_lane, f_winb, f_stages, tpart

    if len(chunks) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(len(chunks), os.cpu_count() or 1)) as ex:
            results = list(ex.map(_pack_chunk, enumerate(chunks)))
    else:
        results = [_pack_chunk((0, chunks[0]))]
    vals_l, lane_l, winb_l, stage_l = [], [], [], []
    t_valsp, t_g1inv, t_etile, t_eidx, t_stages, t_blo, t_bhi = [], [], [], [], [], [], []
    for f_vals, f_lane, f_winb, f_stages, tpart in results:
        vals_l.append(f_vals)
        lane_l.append(f_lane)
        winb_l.append(f_winb)
        stage_l.append(f_stages)
        if tpart is not None:
            eidx8, etile, g1inv8, st_t, valsp, blo, bhi, win_entries = tpart
            t_eidx.append(eidx8)
            t_etile.append(etile)
            t_g1inv.append(g1inv8)
            t_stages.append(st_t)
            t_valsp.append(valsp)
            t_blo.append(blo)
            t_bhi.append(bhi)
            for b, rng_ in win_entries:
                blk_win_rows[b].extend(rng_)

    stages_stacked = tuple(_up(np.stack([s[i] for s in stage_l]))
                           for i in range(len(stage_l[0])))

    # combine: tiled (segsum) / trivial (partials ARE rows) / ReducePass chain
    S_pad = N // w
    passes = ()
    if trivial or tiled:
        keep = tuple(int(u1 - u0) * (K if tiled else 1) for u0, u1 in chunks)
    else:
        keep = ()  # the ReducePass chain consumes the FULL per-chunk partials
        seg0 = np.full(len(chunks) * S_pad, -1, np.int64)
        for c, (s0, s1) in enumerate(chunks):
            seg0[c * S_pad: c * S_pad + (s1 - s0)] = row_of_sub[s0:s1]
        passes = _build_reduce_passes(seg0, n_r, _up)

    # segsum combine boundaries (tiled only): rowid runs are contiguous and
    # nondecreasing within each 128-partial window
    comb_lo = comb_hi = None
    if tiled:
        flat = rowid.reshape(-1).astype(np.int64)
        idxr = np.flatnonzero(flat >= 0)
        keys = (idxr // RADIX) * RADIX + flat[idxr]
        comb_lo, comb_hi = _run_bounds(keys, idxr % RADIX, rowid.size // RADIX)

    fwd = RoutedSpMV(
        vals=_up(np.stack(vals_l)),
        lane_idx=_up(np.stack(lane_l)),
        win_block=_up(np.stack(winb_l)),
        stages=stages_stacked,
        rowid=None if rowid is None else _up(rowid),
        passes=passes,
        comb_lo=None if comb_lo is None else _up(comb_lo),
        comb_hi=None if comb_hi is None else _up(comb_hi),
        shape=(n_r, n_c),
        w=int(w),
        chunk_keep=keep,
    )
    if not with_transpose:
        return fwd

    derived = None
    if derive_t:
        nb = -(-n_c // RADIX)
        Wb = max(max((len(v) for v in blk_win_rows), default=1), 1)
        # skew guard: a block touched by vastly more windows than average (a
        # near-dense column block) would blow up the padded gather
        if nb * Wb <= 4 * len(chunks) * m + 1024:
            wr = np.full((nb, Wb), len(chunks) * m, np.int32)
            for b, v in enumerate(blk_win_rows):
                wr[b, : len(v)] = v
            derived = RoutedTranspose(
                vals_pre=_up(np.stack(t_valsp)),
                g1inv=_up(np.stack(t_g1inv)),
                expand_tile=_up(np.stack(t_etile)),
                expand_idx=_up(np.stack(t_eidx)),
                stages_t=tuple(_up(np.stack([s[i] for s in t_stages]))
                               for i in range(len(t_stages[0]))),
                bnd_lo=_up(np.stack(t_blo)),
                bnd_hi=_up(np.stack(t_bhi)),
                win_rows=_up(wr),
                n_tiles=int(T8),
                shape=(n_r, n_c),
            )
    return fwd, derived


# ----------------------------------------------------------------------------
# Device pipeline
# ----------------------------------------------------------------------------


def _use_kernel(use_kernel, vals, x) -> bool:
    """The reference's ``use_pallas`` default: the kernel pipeline for CUDA
    tensors whose result is f32 or bf16."""
    if use_kernel is not None:
        return bool(use_kernel)
    return x.is_cuda and torch.promote_types(vals.dtype, x.dtype) in _KERNEL_DTYPES


def _take(a, idx, use_kernel, rep: int = 1):
    """Gather a (rep·R0, L) rep-outer array by a shared (R0, L) idx: K7 for
    128 lanes on the kernel pipeline, ``torch.gather`` otherwise."""
    if use_kernel and a.shape[1] == RADIX:
        return LG.lane_gather(a.contiguous(), idx.contiguous(), rep=rep)
    return LG.lane_gather_plain(a, idx, rep)


def _crossbar_chain(a, mids, use_kernel, C: int, m: int, rep: int, pre_w1=False):
    """The crossbars between the first and the last (``routing.py::clos_apply``)
    with their wirings, over all chunks and repeats at once: one gather per
    crossbar level, one batched transpose per wiring.

    a: (rep·C·m, 128), or (rep·C·128, m) per-chunk transposed when
    ``pre_w1`` (5-stage only: the producer already emitted W1's layout).
    mids: per-stage (C, ...) int8 arrays shared across the ``rep`` repeats;
    none (trivial), one (3-stage: the (128, m) G3) or three (5-stage: G2,
    G3, G4, or the inverse route's G4⁻¹, G3⁻¹, G2⁻¹). Returns
    (rep·C·m, 128)."""
    BT = rep * C
    if not mids:
        return a.reshape(BT * m, RADIX)
    if len(mids) == 1:  # 3-stage: W1, G3 on (128, m) windows, W1ᵀ
        at = a.reshape(BT, m, RADIX).transpose(1, 2).reshape(BT * RADIX, m)
        at = _take(at, mids[0].reshape(C * RADIX, m), use_kernel and m == RADIX, rep)
        return at.reshape(BT, RADIX, m).transpose(1, 2).reshape(BT * m, RADIX)

    def take_flat(arr2d, g):
        return _take(arr2d, g.reshape(arr2d.shape[0] // rep, -1), use_kernel, rep)

    b = m // RADIX
    g2, g3, g4 = mids
    if pre_w1:
        a = a.reshape(BT * RADIX * b, RADIX)
    else:
        a = a.reshape(BT, m, RADIX).transpose(1, 2).reshape(BT * RADIX * b, RADIX)  # W1
    a = take_flat(a, g2)
    a = a.reshape(BT, RADIX, b, RADIX).transpose(2, 3).reshape(BT * RADIX * RADIX, b)  # W2
    if b < RADIX:  # the middle crossbar is lane-padded at pack time
        a = take_flat(torch.nn.functional.pad(a, (0, RADIX - b)), g3)[:, :b]
    else:
        a = take_flat(a, g3)
    a = a.reshape(BT, RADIX, RADIX, b).transpose(2, 3).reshape(BT * RADIX * b, RADIX)  # W2ᵀ
    a = take_flat(a, g4)
    return a.reshape(BT, RADIX, b * RADIX).transpose(1, 2).reshape(BT * m, RADIX)  # W1ᵀ


def _route_and_sum_batched(a, stages, use_kernel, w, pre_w1, rep=1):
    """The crossbar chain over all chunks and repeats at once, then the last
    crossbar fused with the width-w slot sum (K10).

    a: (rep·C, m, 128) phase-1 products, or (rep·C·128, m) per-chunk
    transposed when ``pre_w1``. stages: the crossbars after the folded G1,
    per-stage (C, ...) int8 arrays shared across the ``rep`` repeats (RHS
    columns). Returns (rep·C, m·128/w)."""
    C = stages[0].shape[0] if stages else a.shape[0] // rep
    m = a.shape[1]
    BT = rep * C
    if not stages:
        return a.reshape(BT, -1, w).sum(dim=2)
    a = _crossbar_chain(a, stages[:-1], use_kernel, C, m, rep, pre_w1)
    g5 = stages[-1].reshape(C * m, RADIX)
    if use_kernel:
        return LG.lane_gather_sum(a.contiguous(), g5, w, rep=rep).reshape(BT, m * RADIX // w)
    return _take(a, g5, False, rep).reshape(BT, -1, w).sum(dim=2)


def _route_and_sum(a, stages, use_kernel, g1_folded, w):
    """One program's route on (m, 128) tiles (G1 first unless folded), then
    the width-w slot sum: (m·128/w,) partials. The batched chain with one
    chunk and one repeat."""
    stages = list(stages)
    if not g1_folded and stages:
        a = _take(a, stages.pop(0), use_kernel)
    return _route_and_sum_batched(a[None], [s[None] for s in stages], use_kernel, w,
                                  pre_w1=False)[0]


def _reduce_pass(q, p: ReducePass, use_kernel):
    """Route partials into width-u per-row windows and reshape-sum."""
    outs = []
    for c, (lo, hi) in enumerate(p.in_spans):
        qc = q[lo:hi]
        if qc.shape[0] < p.n_in:
            qc = torch.nn.functional.pad(qc, (0, p.n_in - qc.shape[0]))
        part = _route_and_sum(qc.reshape(-1, RADIX), tuple(s[c] for s in p.stages), use_kernel,
                              g1_folded=False, w=p.u)
        outs.append(part[: p.out_keep[c]])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _phase1(p: RoutedSpMV, xw, use_kernel, rep: int):
    """Phase 1 (gather·multiply by the x blocks) and the crossbar chain over
    every chunk: (rep·C, m·128/w) partials."""
    C, m = p.vals.shape[0], p.vals.shape[1]
    lane_flat = p.lane_idx.reshape(C * m, RADIX)
    vals_flat = p.vals.reshape(C * m, RADIX)
    if use_kernel and m > RADIX and len(p.stages) == 4:
        # K9's transposed output folds each chunk's W1 wiring into a reshape
        at = LG.lane_gather_mul_t_batched(xw, lane_flat, vals_flat, C, m, rep=rep)
        return _route_and_sum_batched(at, p.stages, use_kernel, p.w, pre_w1=True, rep=rep)
    f = LG.lane_gather_mul if use_kernel else LG.lane_gather_mul_plain
    a = f(xw, lane_flat, vals_flat, rep=rep)
    return _route_and_sum_batched(a.reshape(rep * C, m, RADIX), p.stages, use_kernel, p.w,
                                  pre_w1=False, rep=rep)


def _tiled_combine(q, p: RoutedSpMV, use_kernel, rep: int):
    """Sub-row partials (rep, T8·K) -> row sums (rep, T8·128)."""
    T8, K = p.rowid.shape
    if q.shape[1] < T8 * K:
        q = torch.nn.functional.pad(q, (0, T8 * K - q.shape[1]))
    if use_kernel and p.comb_lo is not None:
        S = LG.lane_segsum(q.reshape(rep * T8 * K // RADIX, RADIX).contiguous(), p.comb_lo,
                           p.comb_hi, rep=rep)
        return S.reshape(rep, T8, K // RADIX, RADIX).sum(dim=2).reshape(rep, -1)
    # any rowid per tile (the pack always sets the bounds): K13, or its plain
    # version, a segment sum, on the plain pipeline
    combine = LG.tiled_combine if use_kernel else LG.tiled_combine_plain
    return combine(q.reshape(-1).contiguous(), p.rowid, rep=rep).reshape(rep, -1)


def routed_matvec(p: RoutedSpMV, x, use_kernel=None):
    """y = A @ x through the packed routing program ``p``."""
    n_r, n_c = p.shape
    x = torch.as_tensor(x, device=p.vals.device)
    use_kernel = _use_kernel(use_kernel, p.vals, x)
    nb = -(-n_c // RADIX)
    if x.shape[0] < nb * RADIX:
        x = torch.nn.functional.pad(x, (0, nb * RADIX - x.shape[0]))
    x2 = x.reshape(nb, RADIX)
    C = p.vals.shape[0]
    xw = torch.index_select(x2, 0, p.win_block.reshape(-1))  # (C·m, 128) x-block fetch
    P = _phase1(p, xw, use_kernel, rep=1)
    if p.passes:  # fallback routed combine (pathological tiles)
        q = P.reshape(-1)
        for rp in p.passes:
            q = _reduce_pass(q, rp, use_kernel)
        return q[:n_r]
    kept = [P[c, :k] for c, k in enumerate(p.chunk_keep)]
    q = kept[0] if C == 1 else torch.cat(kept)
    if p.rowid is None:
        return q[:n_r]  # trivial: every row is exactly one sub-row
    return _tiled_combine(q[None], p, use_kernel, rep=1)[0, :n_r]


def _rmat(pt: RoutedTranspose, U2, use_kernel):
    """Aᵀ applied to k stacked u's, U2 (k, n_tiles, 128): (k, n_c)."""
    n_r, n_c = pt.shape
    k = U2.shape[0]
    C, m = pt.vals_pre.shape[0], pt.vals_pre.shape[1]
    uw = U2[:, pt.expand_tile.reshape(-1).long()].reshape(k * C * m, RADIX)
    a = _take(uw, pt.expand_idx.reshape(C * m, RADIX), use_kernel, k)
    a = _crossbar_chain(a, pt.stages_t, use_kernel, C, m, k)  # inverse middle crossbars
    # final: G1⁻¹ ∘ multiply(vals_pre) ∘ per-column segment sums
    args = (pt.g1inv.reshape(C * m, RADIX), pt.vals_pre.reshape(C * m, RADIX),
            pt.bnd_lo.reshape(C * m, RADIX), pt.bnd_hi.reshape(C * m, RADIX))
    if use_kernel:
        S = LG.lane_gather_mul_segsum(a.contiguous(), *args, rep=k)
    else:
        S = LG.lane_gather_mul_segsum_plain(a, *args, rep=k)
    S = torch.cat([S.reshape(k, C * m, RADIX),
                   torch.zeros((k, 1, RADIX), dtype=S.dtype, device=S.device)], dim=1)
    nb, Wb = pt.win_rows.shape
    y = S[:, pt.win_rows.reshape(-1).long()].reshape(k, nb, Wb, RADIX).sum(dim=2)
    return y.reshape(k, -1)[:, :n_c]


def routed_rmatvec(pt: RoutedTranspose, u, use_kernel=None):
    """y = Aᵀ @ u through the derived transpose program ``pt``: expand u into
    the row-slot domain, run the inverse crossbars with the same wirings,
    multiply by the pre-G1 values and sum per column (K12), then gather each
    column block's per-window sums. Cost about one forward apply."""
    u = torch.as_tensor(u, device=pt.vals_pre.device)
    use_kernel = _use_kernel(use_kernel, pt.vals_pre, u)
    if u.shape[0] < pt.n_tiles * RADIX:
        u = torch.nn.functional.pad(u, (0, pt.n_tiles * RADIX - u.shape[0]))
    return _rmat(pt, u.reshape(1, pt.n_tiles, RADIX), use_kernel)[0]


def routed_matmat(p: RoutedSpMV, X, use_kernel=None, panel=False):
    """Y = A @ X (k columns) through one shared routing program: every
    kernel runs with ``rep=k``, the repeated operands stacked column-outer
    and the shared ones (indices, values, boundaries) read from one copy.

    ``panel=True``: X arrives as (k, n) row panels and Y returns as
    (k, n_r), the pipeline's own column-outer layout on both ends."""
    n_r, n_c = p.shape
    X = torch.as_tensor(X, device=p.vals.device)
    if not panel:
        X = X.t()
    k = X.shape[0]
    if k == 1:
        y = routed_matvec(p, X[0], use_kernel=use_kernel)
        return y[None, :] if panel else y[:, None]
    if p.passes:  # ReducePass fallback layouts: one column at a time (rare)
        Y = torch.stack([routed_matvec(p, X[j], use_kernel=use_kernel) for j in range(k)])
        return Y if panel else Y.t()
    use_kernel = _use_kernel(use_kernel, p.vals, X)
    nb = -(-n_c // RADIX)
    if X.shape[1] < nb * RADIX:
        X = torch.nn.functional.pad(X, (0, nb * RADIX - X.shape[1]))
    C, m = p.vals.shape[0], p.vals.shape[1]
    xw = X.reshape(k, nb, RADIX)[:, p.win_block.reshape(-1).long()].reshape(k * C * m, RADIX)
    P = _phase1(p, xw, use_kernel, rep=k).reshape(k, C, -1)
    kept = [P[:, c, :kc] for c, kc in enumerate(p.chunk_keep)]
    q = kept[0] if len(kept) == 1 else torch.cat(kept, dim=1)
    if p.rowid is not None:
        q = _tiled_combine(q, p, use_kernel, rep=k)
    return q[:, :n_r] if panel else q[:, :n_r].t()


def routed_rmatmat(pt: RoutedTranspose, U, use_kernel=None, panel=False):
    """Y = Aᵀ @ U (k columns) through the shared derived-transpose program,
    the rep-grid analogue of ``routed_rmatvec``. ``panel`` as in
    ``routed_matmat``."""
    U = torch.as_tensor(U, device=pt.vals_pre.device)
    if not panel:
        U = U.t()
    k = U.shape[0]
    if k == 1:
        y = routed_rmatvec(pt, U[0], use_kernel=use_kernel)
        return y[None, :] if panel else y[:, None]
    use_kernel = _use_kernel(use_kernel, pt.vals_pre, U)
    if U.shape[1] < pt.n_tiles * RADIX:
        U = torch.nn.functional.pad(U, (0, pt.n_tiles * RADIX - U.shape[1]))
    Y = _rmat(pt, U.reshape(k, pt.n_tiles, RADIX), use_kernel)
    return Y if panel else Y.t()
