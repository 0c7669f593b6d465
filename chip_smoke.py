#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``linops_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (plus detail lines):

1. device: the card's name and power limit; f32 matmuls must not run in TF32.
2. build: compile the hand-written kernels from ``linops_tpu_torch/kernels/csrc``.
3. kernels: K1 (BSR forward) and K2 (BSR transpose) against their plain
   PyTorch versions and an f64 version of the same data, at the benchmark's
   two shapes (8x128 blocks, kmax 8; 128x128 blocks, kmax 4; n = 65536),
   f32 and bf16 blocks. Tolerance: max|Δ|/max|y| ≤ 1e-5 (both sides
   accumulate in f32).
4. main path: A = D (BᵀB) D + σI over the 8x128 BSR operator, an inverse
   L-BFGS preconditioner built by pushing pairs (s, A s), and preconditioned
   CG; checked in f64, against a second run on the plain backend, and for
   kernel launches. Then the step of ``__graft_entry__.entry()`` in the port
   at n = 8192 against a numpy oracle.
5. times: CUDA events after warm-up, marginal method (long minus short run
   over the difference in count), for K1/K2 beside their plain versions and
   for one CG iteration.

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
    K._lib()
    secs = build.build_seconds["bsr_spmv"]
    print(f"[2 build] bsr_spmv.cu -> sm_90a: "
          + (f"{secs:.2f} s" if secs else "already built from this source hash")
          + f" (load {time.perf_counter() - t0:.2f} s)", flush=True)

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
    check(all(launches[name] > 0 for name in launches), f"a kernel never ran on the main path: {launches}")
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

    main_case = times[("8x128", torch.float32)]
    kernels = [
        {"name": "bsr_matvec", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["bsr_matvec"], "max_abs_err": err_abs["bsr_matvec"],
         "ms": main_case["K1"], "plain_ms": main_case["K1 plain"]},
        {"name": "bsr_rmatvec", "route": "cuda", "source": K1_SOURCE, "replaces": K2_REPLACES,
         "launches": launches["bsr_rmatvec"], "max_abs_err": err_abs["bsr_rmatvec"],
         "ms": main_case["K2"], "plain_ms": main_case["K2 plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
