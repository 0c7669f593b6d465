#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``linops_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (plus detail lines), run in the order 1, 2, 3, 4, 6,
7, 5 (the times come last, after every kernel has been checked):

1. device: the card's name and power limit; f32 matmuls must not run in TF32.
2. build: compile the hand-written kernels from ``linops_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, started together).
3. kernels: K1 (BSR forward) and K2 (BSR transpose) against their plain
   PyTorch versions and an f64 version of the same data, at the benchmark's
   two shapes (8x128 blocks, kmax 8; 128x128 blocks, kmax 4; n = 65536),
   f32 and bf16 blocks. Tolerance: max|Δ|/max|y| ≤ 1e-5 (both sides
   accumulate in f32).
4. main path of slice 1: A = D (BᵀB) D + σI over the 8x128 BSR operator, an
   inverse L-BFGS preconditioner built by pushing pairs (s, A s), and
   preconditioned CG; checked in f64, against a second run on the plain
   backend, and for kernel launches. Then the step of
   ``__graft_entry__.entry()`` in the port at n = 8192 against a numpy oracle.
5. times: CUDA events after warm-up, marginal method (long minus short run
   over the difference in count), for K1/K2 beside their plain versions and
   for one CG iteration; for K3-K6 beside their plain versions and beside
   K1/K2 on the same operator, at both n = 2^22 window shapes.
6. window kernels: K3-K6 through ``BSROperator`` at the reference bench's
   large-n shapes (n = 2^22, 8x128: banded kmax 2, ``bench.py:636-647``;
   band + far cluster kmax 3, ``bench.py:674-688``), f32 and bf16 blocks,
   made on the card from a seed: the plan's kind, agreement with the plain
   versions and with f64 (max|Δ|/max|y| ≤ 1e-5), K4/K6 bit-identical on a
   rerun, and launch counts showing K3-K6 ran and K1/K2 did not.
7. main path of slice 2: a 5-point Laplacian on a 1536² grid (implicit
   diffusion operator I + L, n = 2,359,296) from scipy through
   ``opSparse(format="bsr", symmetric=True)`` (native packer, banded plan),
   CG to a tolerance of 1e-5, checked against a plain-backend rerun and an
   f64 residual computed by scipy; then ``matvec_chain`` in modes N and T on
   both bench operators, so that K3-K6 each run on a path.

Prints a JSON line describing each kernel, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits non-zero
on any failure, and when no CUDA device is present: there is no CPU path.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N = 65536
SHAPES = {  # name -> (bm, bn, kmax)
    "8x128": (8, 128, 8),
    "128x128": (128, 128, 4),
}
KERNEL_RTOL = 1e-5
I_SHORT, I_LONG, REPS = 10, 60, 3
SEED = 0
K1_SOURCE = "linops_tpu_torch/kernels/csrc/bsr_spmv.cu"
K1_REPLACES = "linops_tpu/kernels/bsr_spmv.py:207"  # bsr_matvec_pallas
K2_REPLACES = "linops_tpu/kernels/bsr_spmv.py:640"  # bsr_rmatvec_pallas
WIN_SOURCE = "linops_tpu_torch/kernels/csrc/bsr_window.cu"
WIN_KERNELS = {  # name -> (replaces, bench shape whose f32 case it is reported at)
    "bsr_matvec_windowed": ("linops_tpu/kernels/bsr_spmv.py:481", "banded"),  # K3
    "bsr_rmatvec_windowed": ("linops_tpu/kernels/bsr_spmv.py:759", "banded"),  # K4
    "bsr_matvec_multiwin": ("linops_tpu/kernels/bsr_spmv.py:543", "band+cluster"),  # K5
    "bsr_rmatvec_multiwin": ("linops_tpu/kernels/bsr_spmv.py:927", "band+cluster"),  # K6
}
WIN_N = 1 << 22
WIN_KMAX = {"banded": 2, "band+cluster": 3}
GRID = 1536  # phase 7: Laplacian grid width and height


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def make_bsr(name, dtype, dev, scale=1.0):
    """Random BSR data at a benchmark shape, made on the card from SEED."""
    bm, bn, kmax = SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(SEED)
    blocks = (torch.randn((N // bm, kmax, bm, bn), generator=g, device=dev) * scale).to(dtype)
    cols = torch.randint(0, N // bn, (N // bm, kmax), generator=g, device=dev,
                         dtype=torch.int32)
    return blocks, cols


def win_cols(name):
    """Block columns of the reference bench's large-n operators (numpy):
    ``bench.py:636-647`` (banded) and ``bench.py:674-688`` (band + cluster)."""
    nbrow, nbcol = WIN_N // 8, WIN_N // 128
    bi = np.arange(nbrow, dtype=np.int64)
    if name == "banded":
        q0 = (bi * (nbcol - 2)) // (nbrow - 1)
        bc = np.minimum(q0[:, None] + np.arange(2)[None, :], nbcol - 1)
    else:
        q0 = (bi * (nbcol - 3)) // (nbrow - 1)
        bc = np.concatenate([np.minimum(q0[:, None] + np.arange(2)[None, :], nbcol - 3),
                             np.full((nbrow, 1), nbcol - 2, np.int64)], axis=1)
    return bc.astype(np.int32)


def win_operator(lt, name, dtype, dev, seed):
    """The bench's large-n BSR operator, blocks made on the card from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kmax = WIN_KMAX[name]
    blocks = torch.randn((WIN_N // 8, kmax, 8, 128), generator=g, device=dev).to(dtype)
    cols = torch.from_numpy(win_cols(name)).to(dev)
    return lt.BSROperator(lt.BSR(blocks, cols, (WIN_N, WIN_N)))


def f64_matvec(K, blocks, cols, xb, chunk=512):
    """The plain forward in f64, block rows in chunks (no f64 copy of all blocks)."""
    return torch.cat([K.bsr_matvec_plain(blocks[i:i + chunk].double(), cols[i:i + chunk],
                                         xb.double())
                      for i in range(0, blocks.shape[0], chunk)])


def f64_rmatvec(K, blocks, cols, ub, nbcol, chunk=512):
    """The plain transpose in f64, block rows in chunks."""
    out = None
    for i in range(0, blocks.shape[0], chunk):
        part = K.bsr_rmatvec_plain(blocks[i:i + chunk].double(), cols[i:i + chunk],
                                   ub[i:i + chunk].double(), nbcol)
        out = part if out is None else out + part
    return out


def event_ms(fn, iters):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def marginal_ms(fn):
    """ms per call: median over REPS of (t(I_LONG) - t(I_SHORT)) / (I_LONG - I_SHORT)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    deltas = [(event_ms(fn, I_LONG) - event_ms(fn, I_SHORT)) / (I_LONG - I_SHORT)
              for _ in range(REPS)]
    return float(np.median(deltas))


def np_inverse_lbfgs(pairs, mem, v):
    """Numpy oracle of the inverse L-BFGS two-loop recursion, in f64."""
    eps = np.finfo(np.float32).eps
    kept = [(s, y) for s, y in pairs if float(y @ s) > eps][-mem:]
    s_l, y_l = kept[-1]
    gamma = float(y_l @ s_l) / float(y_l @ y_l)
    q = v.copy()
    alphas = []
    for s, y in reversed(kept):
        a = float(s @ q) / float(y @ s)
        q -= a * y
        alphas.append(a)
    q *= gamma
    for (s, y), a in zip(kept, reversed(alphas)):
        q += (a - float(y @ q) / float(y @ s)) * s
    return q


def free():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def win_names(op):
    """(forward, transpose) kernel names the operator's plan selects."""
    if op.cols_local is not None:
        return "bsr_matvec_windowed", "bsr_rmatvec_windowed"
    return "bsr_matvec_multiwin", "bsr_rmatvec_multiwin"


def win_plain(K, op, xb=None, ub=None):
    """The plain version of the operator's window kernel, forward or transpose."""
    d = op.data
    nbcol = op.shape[1] // 128
    if op.cols_local is not None:
        if xb is not None:
            return K.bsr_matvec_windowed_plain(d.blocks, op.cols_local, op.win_q, xb, wb=op._wb,
                                               x_pad_blocks=op._x_pad_blocks)
        return K.bsr_rmatvec_windowed_plain(d.blocks, op.cols_local, op.win_q, ub, wb=op._wb,
                                            x_pad_blocks=op._x_pad_blocks, nbcol=nbcol)
    if xb is not None:
        return K.bsr_matvec_multiwin_plain(d.blocks, d.block_cols, op.win_q, xb, wb=op._wb,
                                           x_pad_blocks=op._x_pad_blocks)
    return K.bsr_rmatvec_multiwin_plain(d.blocks, d.block_cols, op.win_q_t, op.win_valid_t, ub,
                                        wb=op._wb, x_pad_blocks=op._x_pad_blocks_t, nbcol=nbcol)


def win_kernel(K, op, xb=None, ub=None):
    """The operator's window kernel, called through its wrapper."""
    d = op.data
    nbcol = op.shape[1] // 128
    if op.cols_local is not None:
        if xb is not None:
            return K.bsr_matvec_windowed_kernel(d.blocks, op.cols_local, op.win_q, xb, wb=op._wb,
                                                x_pad_blocks=op._x_pad_blocks)
        return K.bsr_rmatvec_windowed_kernel(d.blocks, op.cols_local, op.win_q, ub, wb=op._wb,
                                             x_pad_blocks=op._x_pad_blocks, nbcol=nbcol,
                                             index=(op.t_perm, op.t_ptr))
    if xb is not None:
        return K.bsr_matvec_multiwin_kernel(d.blocks, d.block_cols, op.win_q, xb, wb=op._wb,
                                            x_pad_blocks=op._x_pad_blocks, index=op.lane_rows)
    return K.bsr_rmatvec_multiwin_kernel(d.blocks, d.block_cols, op.win_q_t, op.win_valid_t, ub,
                                         wb=op._wb, x_pad_blocks=op._x_pad_blocks_t, nbcol=nbcol,
                                         index=(op.t_perm, op.t_ptr))


def phase6(lt, K, dev):
    """K3-K6 at the bench's large-n shapes through the operator: plan kind,
    plain and f64 agreement, determinism, launch counts. Returns max|Δ|
    against the plain version per kernel (the f32 case)."""
    err_abs = {}
    for name in WIN_KMAX:
        for dtype in (torch.float32, torch.bfloat16):
            free()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            op = win_operator(lt, name, dtype, dev, SEED + 10)
            t_plan = time.perf_counter() - t0
            banded = name == "banded"
            check(op.win_q is not None and (op.cols_local is not None) == banded
                  and (banded or op.win_q_t is not None),
                  f"{name} {dtype}: no {'banded' if banded else 'multi-window + transpose'} plan")
            fwd, tr = win_names(op)
            d = op.data
            nbrow, nbcol = d.blocks.shape[0], WIN_N // 128
            g = torch.Generator(device=dev).manual_seed(SEED + 11)
            v = torch.randn(WIN_N, generator=g, device=dev)
            u = torch.randn(WIN_N, generator=g, device=dev)
            K.reset_launch_counts()
            y, o, o2 = op * v, op.T * u, op.T * u
            torch.cuda.synchronize()
            counts = K.launch_counts()
            want = {**dict.fromkeys(counts, 0), fwd: 1, tr: 2}
            check(counts == want, f"{name} {dtype}: launches {counts}, expected {want}")
            xb, ub = v.reshape(nbcol, 128), u.reshape(nbrow, 8)
            y_plain = win_plain(K, op, xb=xb).reshape(-1)
            o_plain = win_plain(K, op, ub=ub).reshape(-1)
            y64 = f64_matvec(K, d.blocks, d.block_cols, xb, chunk=1 << 15).reshape(-1)
            o64 = f64_rmatvec(K, d.blocks, d.block_cols, ub, nbcol, chunk=1 << 15).reshape(-1)
            errs = {"N plain": rel_err(y, y_plain), "N f64": rel_err(y, y64),
                    "T plain": rel_err(o, o_plain), "T f64": rel_err(o, o64)}
            check(torch.isfinite(y).all() and torch.isfinite(o).all(), f"{name}: non-finite output")
            check(all(e <= KERNEL_RTOL for e in errs.values()),
                  f"{name} {dtype}: window kernels disagree: {errs}")
            check(torch.equal(o, o2), f"{name} {dtype}: {tr} is not deterministic")
            if dtype == torch.float32:
                err_abs[fwd] = float((y - y_plain).abs().max())
                err_abs[tr] = float((o - o_plain).abs().max())
            plan = (f"wb {op._wb}, {op.win_q.shape[-1]} groups of {nbrow // op.win_q.shape[-1]} "
                    f"block rows" + ("" if banded else f", W {op.win_q.shape[0]} fwd / "
                                     f"{op.win_q_t.shape[0]} T lanes"))
            print(f"[6 window kernels] {name} kmax={WIN_KMAX[name]} blocks {str(dtype)[6:]} "
                  f"({d.blocks.numel() * d.blocks.element_size() / 1e9:.2f} GB): plan {plan} "
                  f"({t_plan:.2f} s incl. blocks); {fwd}/{tr}: "
                  + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                  + f" (limit {KERNEL_RTOL:g}); {tr} bit-identical on rerun; launches {fwd} 1, "
                  f"{tr} 2, K1/K2 0; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
            del op, d, y, o, o2, y_plain, o_plain, y64, o64, v, u, xb, ub
    return err_abs


def laplacian(grid):
    """I + L for the 5-point Laplacian L on a grid x grid mesh (Dirichlet),
    scipy CSR, f32: diagonal 5, off-diagonals -1."""
    import scipy.sparse as sps

    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(grid, grid))
    eye = sps.identity(grid)
    A = sps.kron(eye, t) + sps.kron(t, eye) + sps.identity(grid * grid)
    return A.tocsr().astype(np.float32)


def phase7(lt, K, dev):
    """Slice 2's path through the entry points a user calls. Returns the
    launch counts of the run (reset just before it)."""
    from linops_tpu_torch import native

    free()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    A = laplacian(GRID)
    n = A.shape[0]
    check(n > K.BSR_PALLAS_MAX_X_ELEMS, "the Laplacian is too small to plan windows")
    packs = native.pack_calls
    t1 = time.perf_counter()
    op_host = lt.opSparse(A, format="bsr", block_shape=(8, 128), symmetric=True)
    t2 = time.perf_counter()
    check(native.pack_calls == packs + 1, "opSparse did not run the native packer")
    check(op_host.win_q is not None and op_host.cols_local is not None,
          "the Laplacian got no banded window plan")
    op = op_host.to(dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    d = op.data
    host_csr = A.data.nbytes + A.indices.nbytes + A.indptr.nbytes
    dev_bytes = sum(t.numel() * t.element_size() for t in
                    (d.blocks, d.block_cols, op.win_q, op.cols_local, op.col_perm, op.col_ptr,
                     op.t_perm, op.t_ptr))
    print(f"[7 slice-2 path] I + L, 5-point Laplacian on {GRID}² (n = {n}, {A.nnz} nnz): "
          f"scipy CSR {host_csr / 1e9:.3f} GB on the host ({t1 - t0:.2f} s); opSparse(bsr 8x128) "
          f"kmax {d.blocks.shape[1]}, {d.blocks.numel() * d.blocks.element_size() / 1e9:.3f} GB of "
          f"blocks packed natively ({t2 - t1:.2f} s incl. plan); banded plan wb {op._wb}, "
          f"{op.win_q.shape[0]} groups of {d.blocks.shape[0] // op.win_q.shape[0]} block rows; "
          f"{dev_bytes / 1e9:.3f} GB on the card (blocks, cols, plan, indices; upload "
          f"{t3 - t2:.2f} s)", flush=True)
    del op_host
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    b = torch.randn(n, generator=g, device=dev)
    t0 = time.perf_counter()
    x, k, res = lt.cg(op, b, tol=1e-5, maxiter=200)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    check(k < 200 and torch.isfinite(x).all() and tuple(x.shape) == (n,),
          f"cg on the Laplacian: {k} iterations, finite {bool(torch.isfinite(x).all())}")
    x_host, b_host = x.double().cpu().numpy(), b.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_host - A.astype(np.float64) @ x_host) / np.linalg.norm(b_host))
    check(true_res <= 1e-4, f"Laplacian f64 residual {true_res:.3e} > 1e-4")
    plain = lt.BSROperator(d, symmetric=True, backend="torch")
    x_t, k_t, _ = lt.cg(plain, b, tol=1e-5, maxiter=200)
    dx = float(torch.linalg.vector_norm(x_t - x) / torch.linalg.vector_norm(x_t))
    check(abs(k_t - k) <= 1 and dx <= 1e-4,
          f"plain-backend cg: {k_t} iterations (kernel {k}), |Δx|/|x| {dx:.2e}")
    counts = K.launch_counts()
    check(counts["bsr_matvec_windowed"] > 0 and counts["bsr_matvec"] == 0,
          f"the Laplacian cg did not run K3 alone: {counts}")
    print(f"[7 slice-2 path] cg(tol 1e-5): {k} iterations, f64 residual (scipy) {true_res:.3e} "
          f"(limit 1e-4), {t_cg:.3f} s incl. first calls; plain backend {k_t} iterations, "
          f"|Δx|/|x| {dx:.2e} (limit 1e-4); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del op, d, plain, x, x_t, b, A
    for name in WIN_KMAX:  # matvec_chain N and T on both bench operators
        free()
        op = win_operator(lt, name, torch.float32, dev, SEED + 21)
        v = torch.ones(WIN_N, device=dev)
        plain = lt.BSROperator(op.data, backend="torch")
        for mode in ("N", "T"):
            got = lt.matvec_chain(op, v, 5, mode=mode)
            ref = lt.matvec_chain(plain, v, 5, mode=mode)
            e = rel_err(got, ref)
            check(torch.isfinite(got).all() and e <= 1e-4,
                  f"matvec_chain {name} {mode}: |Δ|/max {e:.2e} against the plain backend")
            print(f"[7 slice-2 path] matvec_chain(5, mode {mode}) on the {name} bench operator: "
                  f"max|Δ|/max against the plain backend {e:.2e} (limit 1e-4)", flush=True)
        del op, plain, v, got, ref
    counts = K.launch_counts()
    for name in WIN_KERNELS:
        check(counts[name] > 0, f"{name} never ran on the slice-2 path: {counts}")
    check(counts["bsr_matvec"] == 0 and counts["bsr_rmatvec"] == 0,
          f"K1/K2 ran on the slice-2 path: {counts}")
    print(f"[7 slice-2 path] launches {counts}", flush=True)
    return counts


def phase5_windows(lt, K, dev, card):
    """Times of K3-K6 beside their plain versions and K1/K2 on the same
    operator. Returns {shape: {name: ms}} for the f32 cases."""
    out = {}
    for name in WIN_KMAX:
        for dtype in (torch.float32, torch.bfloat16):
            free()
            op = win_operator(lt, name, dtype, dev, SEED + 30)
            fwd, tr = win_names(op)
            d = op.data
            nbrow, nbcol = d.blocks.shape[0], WIN_N // 128
            xb = torch.randn((nbcol, 128), device=dev)
            ub = torch.randn((nbrow, 8), device=dev)
            gb = d.blocks.numel() * d.blocks.element_size() / 1e9
            row = {
                fwd: marginal_ms(lambda: win_kernel(K, op, xb=xb)),
                fwd + " plain": marginal_ms(lambda: win_plain(K, op, xb=xb)),
                "K1": marginal_ms(lambda: K.bsr_matvec_kernel(d.blocks, d.block_cols, xb)),
                tr: marginal_ms(lambda: win_kernel(K, op, ub=ub)),
                tr + " plain": marginal_ms(lambda: win_plain(K, op, ub=ub)),
                "K2": marginal_ms(lambda: K.bsr_rmatvec_kernel(
                    d.blocks, d.block_cols, ub, nbcol, perm=op.col_perm, colptr=op.col_ptr)),
            }
            if dtype == torch.float32:
                out[name] = row
            print(f"[5 times] {name} kmax={WIN_KMAX[name]} n=2^22 blocks {str(dtype)[6:]} "
                  f"({gb * 1e3:.1f} MB stored): "
                  + ", ".join(f"{k} {v * 1e3:.1f} us = {gb / (v / 1e3):.0f} GB/s" for k, v in row.items())
                  + f"; {card}", flush=True)
            del op, d, xb, ub
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import linops_tpu_torch as lt
    from linops_tpu_torch.kernels import bsr_spmv as K
    from linops_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # --- 1. device ----------------------------------------------------------
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    check(lt.f32_exact(), "f32 contractions are not f32-exact")
    print(f"[1 device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off, f32 matmul precision highest", flush=True)

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all(["bsr_spmv", "bsr_window"])  # one nvcc per source, in parallel
    K._lib(), K._win_lib()
    print("[2 build] -> sm_90a: " + ", ".join(
        f"{n}.cu " + (f"{build.build_seconds[n]:.2f} s" if build.build_seconds[n]
                      else "already built from this source hash")
        for n in ("bsr_spmv", "bsr_window"))
        + f" (wall {time.perf_counter() - t0:.2f} s)", flush=True)

    # --- 3. kernels vs plain vs f64 -------------------------------------------
    err_abs = {"bsr_matvec": 0.0, "bsr_rmatvec": 0.0}
    for name in SHAPES:
        bm, bn, kmax = SHAPES[name]
        nbcol = N // bn
        for dtype in (torch.float32, torch.bfloat16):
            torch.cuda.reset_peak_memory_stats()
            blocks, cols = make_bsr(name, dtype, dev)
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            xb = torch.randn((nbcol, bn), generator=g, device=dev)
            ub = torch.randn((N // bm, bm), generator=g, device=dev)
            perm, colptr = K.bsr_column_index(cols, nbcol)
            y = K.bsr_matvec_kernel(blocks, cols, xb)
            o = K.bsr_rmatvec_kernel(blocks, cols, ub, nbcol, perm=perm, colptr=colptr)
            o2 = K.bsr_rmatvec_kernel(blocks, cols, ub, nbcol, perm=perm, colptr=colptr)
            torch.cuda.synchronize()
            y_plain = K.bsr_matvec_plain(blocks, cols, xb)
            o_plain = K.bsr_rmatvec_plain(blocks, cols, ub, nbcol)
            y64 = f64_matvec(K, blocks, cols, xb)
            o64 = f64_rmatvec(K, blocks, cols, ub, nbcol)
            errs = {"N plain": rel_err(y, y_plain), "N f64": rel_err(y, y64),
                    "T plain": rel_err(o, o_plain), "T f64": rel_err(o, o64)}
            check(torch.isfinite(y).all() and torch.isfinite(o).all(), f"{name}: non-finite output")
            check(tuple(y.shape) == (N // bm, bm) and tuple(o.shape) == (nbcol, bn),
                  f"{name}: output shapes {tuple(y.shape)}, {tuple(o.shape)}")
            check(all(e <= KERNEL_RTOL for e in errs.values()),
                  f"{name} {dtype}: kernel disagrees: {errs}")
            check(torch.equal(o, o2), f"{name} {dtype}: K2 is not deterministic")
            if name == "8x128" and dtype == torch.float32:  # the main path's case
                err_abs["bsr_matvec"] = float((y - y_plain).abs().max())
                err_abs["bsr_rmatvec"] = float((o - o_plain).abs().max())
            peak = torch.cuda.max_memory_allocated() / 2**20
            print(f"[3 kernels] {name} kmax={kmax} blocks {str(dtype)[6:]}: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (max|Δ|/max|y|, limit {KERNEL_RTOL:g}); K2 bit-identical on rerun; "
                  f"peak {peak:.0f} MiB", flush=True)
            del blocks, cols, y, o, o2, y_plain, o_plain, y64, o64, perm, colptr

    # --- 4. main path ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    bm, bn, kmax = SHAPES["8x128"]
    blocks, cols = make_bsr("8x128", torch.float32, dev, scale=(kmax * bn) ** -0.5)
    f32 = torch.float32
    d = torch.linspace(1.0, 2.0, N, dtype=f32, device=dev)
    sigma = 2.0

    def graph(backend):
        B = lt.BSROperator(lt.BSR(blocks, cols, (N, N)), backend=backend)
        D = lt.opDiagonal(d)
        return D @ (B.T @ B) @ D + sigma * lt.opEye(N, dtype=f32)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    b = torch.randn(N, generator=g, device=dev)
    pair_s = [torch.randn(N, generator=g, device=dev) for _ in range(8)]

    K.reset_launch_counts()
    A = graph("auto")
    H = lt.InverseLBFGSOperator(f32, N, mem=8, device=dev)
    for s in pair_s:
        H.push(s, A * s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, k, res = lt.cg(A, b, M=H, tol=1e-5, maxiter=500)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    launches = K.launch_counts()
    check(launches["bsr_matvec"] > 0 and launches["bsr_rmatvec"] > 0,
          f"a kernel never ran on the main path: {launches}")
    check(k < 500, f"cg did not converge in 500 iterations (residual {float(res):.3e})")
    check(torch.isfinite(x).all() and tuple(x.shape) == (N,), "cg returned a non-finite or misshapen x")

    x64 = x.double()
    dx = d.double() * x64
    Bdx = f64_matvec(K, blocks, cols, dx.reshape(-1, bn)).reshape(-1)
    Ax64 = d.double() * f64_rmatvec(K, blocks, cols, Bdx.reshape(-1, bm), N // bn).reshape(-1) + sigma * x64
    true_res = float(torch.linalg.vector_norm(b.double() - Ax64) / torch.linalg.vector_norm(b.double()))
    check(true_res <= 1e-4, f"f64 residual {true_res:.3e} > 1e-4")

    A_plain = graph("torch")
    x_t, k_t, _ = lt.cg(A_plain, b, M=H, tol=1e-5, maxiter=500)
    dx_rel = float(torch.linalg.vector_norm(x_t - x) / torch.linalg.vector_norm(x_t))
    check(abs(k_t - k) <= 1, f"plain-backend cg took {k_t} iterations, kernel {k}")
    check(dx_rel <= 1e-3, f"plain-backend x differs by {dx_rel:.3e} > 1e-3")
    check(K.launch_counts() == launches, "backend='torch' launched a kernel")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[4 main path] cg(D (BᵀB) D + {sigma}·I, M=inverse L-BFGS mem 8): {k} iterations, "
          f"recursive residual {float(res) / float(torch.linalg.vector_norm(b)):.3e}, "
          f"f64 residual {true_res:.3e} (limit 1e-4), {t_cg:.3f} s incl. first calls; "
          f"plain backend: {k_t} iterations, |Δx|/|x| {dx_rel:.2e} (limit 1e-3); "
          f"launches {launches}; peak {peak:.0f} MiB", flush=True)

    # entry()'s step (__graft_entry__.py:25-44) in the port, against numpy
    ne = 8192
    rng = np.random.default_rng(0)
    d1 = torch.linspace(1.0, 2.0, ne, dtype=f32, device=dev)
    d2 = torch.linspace(0.5, 1.5, ne, dtype=f32, device=dev)
    He = lt.InverseLBFGSOperator(f32, ne, mem=8, device=dev)
    pairs = []
    for _ in range(8):
        s = rng.standard_normal(ne).astype(np.float32)
        y = (s + 0.1 * rng.standard_normal(ne)).astype(np.float32)
        He.push(s, y)
        pairs.append((s.astype(np.float64), y.astype(np.float64)))
    Ae = 2.0 * (lt.opDiagonal(d1) @ (lt.opEye(ne, dtype=f32) + lt.opDiagonal(d2)))
    xe = torch.zeros(ne, dtype=f32, device=dev)
    be = torch.ones(ne, dtype=f32, device=dev)
    r = be - Ae.apply(xe, "N")
    z = He.apply(r, "N")
    step = xe + (torch.vdot(r, z) / torch.vdot(z, Ae.apply(z, "N"))) * z
    a_np = 2.0 * np.linspace(1.0, 2.0, ne, dtype=np.float32).astype(np.float64) * (
        1.0 + np.linspace(0.5, 1.5, ne, dtype=np.float32).astype(np.float64))
    r_np = np.ones(ne)
    z_np = np_inverse_lbfgs(pairs, 8, r_np)
    step_np = (r_np @ z_np) / (z_np @ (a_np * z_np)) * z_np
    got = step.double().cpu().numpy()
    e_rel = float(np.abs(got - step_np).max() / np.abs(step_np).max())
    check(np.isfinite(got).all() and got.shape == (ne,), "entry step: non-finite or misshapen")
    check(e_rel <= 1e-4, f"entry step differs from the numpy oracle by {e_rel:.3e}")
    print(f"[4 entry step] n={ne}: max|Δ|/max|x| vs numpy f64 {e_rel:.2e} (limit 1e-4)", flush=True)

    win_err = phase6(lt, K, dev)
    win_launches = phase7(lt, K, dev)

    # --- 5. times ---------------------------------------------------------------
    times = {}
    for name in SHAPES:
        bm, bn, kmax = SHAPES[name]
        nbcol = N // bn
        for dtype in (torch.float32, torch.bfloat16):
            blk, cl = make_bsr(name, dtype, dev)
            xb = torch.randn((nbcol, bn), device=dev)
            ub = torch.randn((N // bm, bm), device=dev)
            perm, colptr = K.bsr_column_index(cl, nbcol)
            gb = blk.numel() * blk.element_size() / 1e9
            row = {
                "K1": marginal_ms(lambda: K.bsr_matvec_kernel(blk, cl, xb)),
                "K1 plain": marginal_ms(lambda: K.bsr_matvec_plain(blk, cl, xb)),
                "K2": marginal_ms(lambda: K.bsr_rmatvec_kernel(
                    blk, cl, ub, nbcol, perm=perm, colptr=colptr)),
                "K2 plain": marginal_ms(lambda: K.bsr_rmatvec_plain(blk, cl, ub, nbcol)),
            }
            times[(name, dtype)] = row
            print(f"[5 times] {name} kmax={kmax} blocks {str(dtype)[6:]} ({gb * 1e3:.1f} MB stored): "
                  + ", ".join(f"{k} {v * 1e3:.1f} us = {gb / (v / 1e3):.0f} GB/s" for k, v in row.items())
                  + f"; {card}", flush=True)
            del blk, cl, xb, ub, perm, colptr

    def cg_iter_ms(op):
        def run(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lt.cg(op, b, M=H, tol=0.0, maxiter=iters)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3
        run(3)
        return float(np.median([(run(I_LONG) - run(I_SHORT)) / (I_LONG - I_SHORT)
                                for _ in range(REPS)]))

    cg_kernel, cg_plain = cg_iter_ms(A), cg_iter_ms(A_plain)
    print(f"[5 times] cg iteration (2 BSR applies, 1 L-BFGS apply, 1 host sync), 8x128 f32: "
          f"kernels {cg_kernel * 1e3:.1f} us, plain backend {cg_plain * 1e3:.1f} us; {card}",
          flush=True)

    win_times = phase5_windows(lt, K, dev, card)

    main_case = times[("8x128", torch.float32)]
    kernels = [
        {"name": "bsr_matvec", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["bsr_matvec"], "max_abs_err": err_abs["bsr_matvec"],
         "ms": main_case["K1"], "plain_ms": main_case["K1 plain"]},
        {"name": "bsr_rmatvec", "route": "cuda", "source": K1_SOURCE, "replaces": K2_REPLACES,
         "launches": launches["bsr_rmatvec"], "max_abs_err": err_abs["bsr_rmatvec"],
         "ms": main_case["K2"], "plain_ms": main_case["K2 plain"]},
    ]
    for name, (replaces, shape) in WIN_KERNELS.items():
        t = win_times[shape]
        kernels.append({"name": name, "route": "cuda", "source": WIN_SOURCE, "replaces": replaces,
                        "launches": win_launches[name], "max_abs_err": win_err[name],
                        "ms": t[name], "plain_ms": t[name + " plain"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
