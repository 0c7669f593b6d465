"""Static permutation routing: radix-128 Clos networks (host numpy).

Counterpart of ``linops_tpu/sparse/routing.py``, copied so that both packages
route alike. The routed SpMV pipeline (``sparse/routed.py``) must move each
product from its gather-friendly position (col-block-major, where fetching
``x[col]`` for a 128-lane window reads one 128-element x block) to its
reduce-friendly row slot. That move is a static permutation, fixed at pack
time. A Clos network with radix 128 routes any permutation of N <= 128^3
(= 2^21) elements in at most five crossbar stages, where every crossbar is a
gather within 128 lanes (the lane-gather kernels, ``kernels/lane_gather.py``)
and the fixed wirings between stages are axis transposes. Larger operators
chunk by rows; each chunk routes on its own.

This module computes the per-stage gather-index arrays:
    stage k: a[w, l] = a[w, idx_k[w, l]]   (within each 128-lane window w)
with the wirings defined by ``clos_apply`` (the numpy oracle that the device
pipeline mirrors). The decomposition is the classic recursive Clos routing:
the level-1 middle-subnet assignment is an edge colouring of a 128-regular
bipartite multigraph, obtained by repeated Euler splits (128 = 2^7 halvings).
"""

from __future__ import annotations

import numpy as np

__all__ = ["clos_route", "clos_apply", "clos_stage_shapes", "RADIX"]

RADIX = 128


def _euler_split(src: np.ndarray, dst: np.ndarray, deg: int):
    """Split a deg-regular bipartite multigraph (edges src[i] -> dst[i]) into
    two (deg/2)-regular halves by walking Euler circuits alternately.
    Returns a bool array: True = first half."""
    n_edges = src.shape[0]
    n_src = int(src.max()) + 1 if n_edges else 0
    # adjacency: for each src node, its incident edge ids (deg each)
    order = np.argsort(src, kind="stable")
    # edges sorted by src: node u owns order[u*deg:(u+1)*deg]
    side = np.zeros(n_edges, bool)
    visited = np.zeros(n_edges, bool)
    # for dst nodes: edge ids sorted by dst
    order_d = np.argsort(dst, kind="stable")
    ptr_s = np.zeros(n_src, np.int64)
    n_dst = int(dst.max()) + 1 if n_edges else 0
    ptr_d = np.zeros(n_dst, np.int64)

    def next_edge_from_src(u):
        p = ptr_s[u]
        while p < deg:
            e = order[u * deg + p]
            p += 1
            if not visited[e]:
                ptr_s[u] = p
                return e
        ptr_s[u] = p
        return -1

    def next_edge_from_dst(v):
        p = ptr_d[v]
        while p < deg:
            e = order_d[v * deg + p]
            p += 1
            if not visited[e]:
                ptr_d[v] = p
                return e
        ptr_d[v] = p
        return -1

    for e0 in range(n_edges):
        if visited[e0]:
            continue
        # walk a circuit: bipartite regular graphs have all-even degrees, so
        # every component is Eulerian and the walk returns to the start
        e = e0
        first = True
        while e >= 0:
            visited[e] = True
            side[e] = first
            v = dst[e]
            e2 = next_edge_from_dst(v)
            if e2 < 0:
                break
            visited[e2] = True
            side[e2] = not first
            u = src[e2]
            e = next_edge_from_src(u)
    return side


def _edge_color(src: np.ndarray, dst: np.ndarray, deg: int) -> np.ndarray:
    """Proper edge coloring of a deg-regular bipartite multigraph with deg
    colors (deg a power of two), by recursive Euler splitting."""
    n_edges = src.shape[0]
    colors = np.zeros(n_edges, np.int64)
    if deg == 1:
        return colors
    half = _euler_split(src, dst, deg)
    for part, base in ((half, 0), (~half, deg // 2)):
        ids = np.nonzero(part)[0]
        sub = _edge_color(src[ids], dst[ids], deg // 2)
        colors[ids] = base + sub
    return colors


def clos_stage_shapes(n: int):
    """(M, B) for the (M, 128) layout with M = B·128 (or M ≤ 128, B = 0)."""
    if n % RADIX:
        raise ValueError(f"clos size must be a multiple of {RADIX}, got {n}")
    m = n // RADIX
    if m > RADIX * RADIX:
        raise ValueError(f"clos size {n} exceeds {RADIX}^3; chunk the rows")
    if m <= RADIX:
        return m, 0
    if m % RADIX:
        raise ValueError(f"group count {m} must be <= 128 or a multiple of 128")
    return m, m // RADIX


def _route_recursive(dest: np.ndarray):
    """Route a permutation of n = m·128 elements (m ≤ 128·128).

    Returns a list of (idx arrays + wiring tags) consumed by clos_apply:
    for m ≤ 128: [g1 (m,128), g2T (128,m), g3 (m,128)] — 3 stages;
    for m = B·128: 5 stages (see clos_apply).
    idx semantics: AFTER the wiring reshape, out[w, l] = in[w, idx[w, l]].
    """
    n = dest.shape[0]
    m, b = clos_stage_shapes(n)
    if m == 1:
        # single crossbar: one gather; inverse of dest
        g = np.empty(n, np.int64)
        g[dest] = np.arange(n)
        return [g.reshape(1, RADIX)]

    grp_src = np.arange(n) // RADIX
    grp_dst = dest // RADIX
    color = _edge_color(grp_src, grp_dst, RADIX)

    # stage 1 (input crossbars): element e at (grp_src, lane) moves to lane
    # color[e] of its group. Build gather idx: g1[r, c] = source lane of the
    # element leaving group r on subnet c.
    g1 = np.empty((m, RADIX), np.int64)
    g1[grp_src, color] = np.arange(n) % RADIX

    # middle subnets: subnet c carries, from each source group r, one element
    # destined for group grp_dst; its sub-permutation maps position r ->
    # position r' = grp_dst. Compute per-color sub-destinations.
    sub_dest = np.empty((RADIX, m), np.int64)
    sub_dest[color, grp_src] = grp_dst

    # stage 5 (output crossbars): element arriving at group r' from subnet c
    # sits (pre-stage) at lane c and must exit at lane dest % RADIX.
    g5 = np.empty((m, RADIX), np.int64)
    g5[grp_dst, dest % RADIX] = color

    if b == 0:
        # subnets of size m <= 128: each is ONE crossbar. After the wiring
        # transpose the array is (128, m): subnet c = row c; gather within m
        # lanes: g3[c, p'] = p with sub_dest[c, p] = p'.
        g3 = np.empty((RADIX, m), np.int64)
        g3[np.arange(RADIX)[:, None], sub_dest] = np.arange(m)[None, :]
        return [g1, g3, g5]

    # subnets of size m = B·128: recurse (each is a 3-stage Clos itself)
    g2 = np.empty((RADIX * b, RADIX), np.int64)
    g3 = np.empty((RADIX * RADIX, b), np.int64)
    g4 = np.empty((RADIX * b, RADIX), np.int64)
    for c in range(RADIX):
        sub = _route_recursive(sub_dest[c])
        assert len(sub) == 3
        s1, s3, s5 = sub  # (b,128), (128,b), (b,128)
        g2[c * b:(c + 1) * b] = s1
        g3[c * RADIX:(c + 1) * RADIX] = s3
        g4[c * b:(c + 1) * b] = s5
    return [g1, g2, g3, g4, g5]


def clos_route(dest: np.ndarray):
    """Gather-index arrays routing element at position i to dest[i].

    dest: permutation of arange(n), n = m·128 with m ≤ 128 or m = B·128.
    Returns (idx_list, meta) where idx_list has 3 (m ≤ 128) or 5 arrays and
    ``clos_apply`` is the layout contract.
    """
    dest = np.asarray(dest, np.int64)
    n = dest.shape[0]
    if not np.array_equal(np.sort(dest), np.arange(n)):
        raise ValueError("dest is not a permutation")
    return _route_recursive(dest)


def clos_apply(v: np.ndarray, idx_list) -> np.ndarray:
    """Numpy oracle of the device pipeline (kernels + XLA transposes).

    v: flat (n,) array in input order; returns the routed flat array.
    Layout contract (mirrored exactly by the jit pipeline):
      3-stage (m ≤ 128):
        a = v.reshape(m, 128); G1; a = a.T (128, m); G3; a = a.T; G5
      5-stage (m = B·128):
        a = v.reshape(m, 128); G1
        a = a.T.reshape(128·B, 128)                  # W1
        G2
        a = a.reshape(128, B, 128).transpose(0, 2, 1).reshape(128·128, B)  # W2
        G3
        a = a.reshape(128, 128, B).transpose(0, 2, 1).reshape(128·B, 128)  # W2ᵀ
        G4
        a = a.reshape(128, B·128).T.reshape(m, 128)  # W1ᵀ
        G5
    """
    n = v.shape[0]
    m, b = clos_stage_shapes(n)
    take = lambda a, idx: np.take_along_axis(a, idx, axis=1)
    if len(idx_list) == 1:
        return take(v.reshape(1, RADIX), idx_list[0]).reshape(-1)
    if len(idx_list) == 3:
        g1, g3, g5 = idx_list
        a = take(v.reshape(m, RADIX), g1)
        a = take(a.T.copy(), g3)
        a = take(a.T.copy(), g5)
        return a.reshape(-1)
    g1, g2, g3, g4, g5 = idx_list
    a = take(v.reshape(m, RADIX), g1)
    a = a.T.reshape(RADIX * b, RADIX)
    a = take(a, g2)
    a = a.reshape(RADIX, b, RADIX).transpose(0, 2, 1).reshape(RADIX * RADIX, b)
    a = take(a, g3)
    a = a.reshape(RADIX, RADIX, b).transpose(0, 2, 1).reshape(RADIX * b, RADIX)
    a = take(a, g4)
    a = a.reshape(RADIX, b * RADIX).T.reshape(m, RADIX)
    a = take(a, g5)
    return a.reshape(-1)
