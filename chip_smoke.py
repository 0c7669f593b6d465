#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``linops_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (plus detail lines), run in the order 1, 2, 3, 4, 6,
7, 9, 8, 5 (with phase 4's main path rerun under the profiler at its end),
11, 12, 13, 10, 14, 13h, 15 (15f, E2, after 15a), 13i, 14i, 16, then one profiled slice-1 CG (the times come
after every kernel has been checked; phases 12, 10, 14 and the profiled CG
come after phase 5 because torch.profiler traces of whole solves, run before
phase 5, left phase 5's own traces without device time; phases 11 and 12 run
no profiler). Every solve runs on ``utils/loop.py``: the first solve of a
signature runs the plain loop (one read per iteration), its next one
captures a block of ``loop.BLOCK`` masked iterations in a CUDA graph and
replays it, reading the host once per block. Launch counts are the wrappers' (a replay adds none); phase 4's
are held against a profiler trace of a rerun, and each captured block's
against the kernel nodes of its graph (and a trace of one replay, which
shows them run but can lose records).

1. device: the card's name and power limit; f32 matmuls must not run in TF32.
2. build: compile the hand-written kernels from ``linops_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, started together; ``graph_cond.cu`` is G1, the
   while node's condition kernel, and the host shim that records the node;
   ``small_lstsq.cu`` is E2, GMRES's least-squares step).
3. kernels: K1 (BSR forward) and K2 (BSR transpose) against their plain
   PyTorch versions and an f64 version of the same data, at the benchmark's
   two shapes (8x128 blocks, kmax 8; 128x128 blocks, kmax 4; n = 65536),
   f32 and bf16 blocks. Tolerance: max|Δ|/max|y| ≤ 1e-5 (both sides
   accumulate in f32).
4. main path of slice 1: A = D (BᵀB) D + σI over the 8x128 BSR operator, an
   inverse L-BFGS preconditioner built by pushing pairs (s, A s), and
   preconditioned CG; checked in f64, against a second run on the plain
   backend, and for kernel launches (rerun at the end under torch.profiler:
   the same counts, equal to the kernels its trace counts). Then the step of
   ``__graft_entry__.entry()`` in the port at n = 8192 against a numpy oracle.
5. times: CUDA events after warm-up, marginal method (long minus short run
   over the difference in count), for K1/K2 beside their plain versions and
   for one CG iteration; for K3-K6 beside their plain versions and beside
   K1/K2 on the same operator, at both n = 2^22 window shapes; K7-K14 also
   per call in a CUDA graph of 20 calls and in a torch.profiler trace. The
   library yardstick of K1-K6 is cuSPARSE's CSR matvec through torch.mv: on
   a CSR of A for the forwards, on a CSR of Aᵀ built once (outside the
   timing, as K2's plan is built once per operator) for the transposes.
6. window kernels: K3-K6 through ``BSROperator`` at the reference bench's
   large-n shapes (n = 2^22, 8x128: banded kmax 2, ``bench.py:636-647``;
   band + far cluster kmax 3, ``bench.py:674-688``), f32 and bf16 blocks,
   made on the card from a seed: the plan's kind, agreement with the plain
   versions and with f64 (max|Δ|/max|y| ≤ 1e-5), K4/K6 bit-identical on a
   rerun, and launch counts showing K3-K6 ran and K1/K2 did not; then K2
   through its column plan on the band + cluster operator (a hot column of
   2^19 slots) against the same plain and f64 sums, bit-identical on rerun.
7. main path of slice 2: a 5-point Laplacian on a 1536² grid (implicit
   diffusion operator I + L, n = 2,359,296) from scipy through
   ``opSparse(format="bsr", symmetric=True)`` (native packer, banded plan),
   CG to a tolerance of 1e-5, checked against a plain-backend rerun and an
   f64 residual computed by scipy; then ``matvec_chain`` in modes N and T on
   both bench operators, so that K3-K6 each run on a path.
8. lane kernels: K7-K12 against their plain versions at phase 9's shapes
   (f32, bf16; rep 1 and 8); K13 (``tiled_combine``) on step 1's program
   with its segment bounds dropped, against the same program through K11
   and the plain pipeline, alone against its plain version (also on a
   shuffled rowid with trash slots), bit-identical on a rerun, and in a CG
   on that program; K14 (``lane_gather_mul_t``) on one chunk of step 1, bit
   for bit against K9 with C = 1 and its plain version.
9. main path of slice 3: CG on an unstructured SPD matrix at n = 2^20
   through ``opSparse(format="auto")`` (the Clos-routed pipeline), auto_8m
   N/T and 8 right-hand sides, an RCM sandwich, a routed permutation.
10. main path of slice 4, at the reference bench's sizes: GMRES(30) and
   BiCGSTAB on ``ShiftedOperator(auto_8m, 8)``; damped LSQR on a 2^20 x 2^19
   unstructured matrix (derived transpose, K12); MINRES on the saddle-point
   system ``vcat(hcat(I + L, Bᵀ), hcat(B, opZeros))`` (phase 7's Laplacian,
   B an ``opRestriction`` to every 8th point) and a slice of it; CG with 8
   right-hand sides (routed kernels at rep 8); the shifted L-BFGS solves
   (compact, EJM, several σ at once, MINRES) at n = 10^6, mem 16. Each solve
   against an f64 residual and the plain pipeline (for GMRES with the plain
   SVD in E2's place), with its launches; GMRES's first solve reads once per
   restart, plus once, and launches E2 once per restart.
11. main path of slice 6, at the reference bench's sizes: (a) the 5-point
   Laplacian on 2048² as a stencil, as DIA and as L1⊗I + I⊗L1, N/T and a
   width-6 row panel against scipy f64, with apply times; (b) LOBPCG (k = 2)
   on it against the closed-form eigenvalues, with its time per iteration;
   svds, normest and estimate_opnorm of phase 4's BSR operator (K1/K2)
   against each other and the plain backend; rsvd of auto_8m through the
   routed matrix applies against the plain pipeline; (c) trace, diagonal
   and log-determinant estimates of I + L against their exact values, and
   funm_apply on phase 4's graph; (d) L-SR1 at n = 10^6, mem 16 against an
   f64 recomputation, timed; the diagonal quasi-Newton updates against f64;
   checkpoints reloaded bit for bit; (e) opCholesky/opLDL (4096²),
   opIterativeInverse against cg, opSparseInverse (512²), TimedOperator,
   the property checks; (f) the fixed-order sums bit-identical over five
   reruns (CSR N/T at n = 2^20, the plain K2 in f64, a restriction's
   transpose, the f64 routed combine), and the CSR apply against the
   index_add_ apply it replaced. Its launches must include K1, K2 and the
   routed kernels.
12. main path of slice 7, gradients taken with ``torch.autograd`` through
   the kernel applies: (a) L = ½‖Ax − b‖² on phase 3's 8x128 operator
   (modes N and T, f32 and bf16 blocks): the x-gradient bit-identical to the
   explicit adjoint apply, x and block gradients against the plain backend's
   autograd (max|Δ|/max ≤ 1e-5 for x, 1e-6 for f32 blocks, 1e-2 for bf16
   blocks), one transpose kernel per backward; a mixed graph; times by
   marginal CUDA events beside the device time of a profiled run; (b) K3-K6
   at n = 2^22, x-gradients bit-identical to the explicit applies; (c) the
   phase-10b routed matrix (K7, K12 in the backward) and a 2^20 permutation,
   and the routed values' gradients (the forward program's through N, the
   derived transpose's through T: K7 and K8 in the backward) against the
   plain pipeline's autograd (max|Δ|/max ≤ 1e-5); (f) ``torch.func.vmap``
   over 8 vectors of A (one K1p launch on the batch) and of Aᵀ (one K2p
   launch; both bit for bit 8 vector applies) and of the
   routed N apply (the matrix kind, ≤ 1e-6); (g) ``vmap(cg)`` over 4
   systems of slice 1's size against 4 solves (iterations ±1, |Δx|/|x| ≤
   1e-3); (d) the implicit backward of ``opIterativeInverse(cg, tol 1e-6)``
   on slice 1's graph against the closed form and the plain backend
   (‖Δ‖/‖g‖ ≤ 1e-4), with its times; (e) ``apply_linear``. Its backward
   launches must include K1-K6, K7, K10, K12.
13. main path of slice 8, the distributed layer (``linops_tpu_torch.parallel``)
   in a world of one NCCL rank (one card: two ranks cannot share it): slice
   1's graph and preconditioner through ``shard_operator`` (the dryrun step;
   CG in captured blocks with the sharded per-iteration loop's and the
   unsharded iterations and x bit for bit, the same K1/K2 launches, ⌈I/4⌉
   reads a cached solve; collectives per apply, unchanged; µs per iteration
   captured, per-iteration and unsharded), the 2^22 window operators
   sharded (K3-K6 bit for bit, and in captured matvec chains), auto_8m
   replicated (K7-K12 bit for bit), ``banded_partition`` at n = 16384 with
   CG, ``stencil_partition_2d`` on 2048² against the stencil operator (≤
   1e-6) and Chebyshev without an all-reduce, both solves captured and bit
   for bit their per-iteration loop's, ``scaling_report(1)`` and the card's
   copy rate. Its launches must include K1-K6 and K7, K9-K12.
   13h (after phase 14, whose unsharded 14d and 14h numbers it prints beside
   its own): DTensor vectors wherever the reference takes a sharded array.
   GMRES(30) on ``shard_operator`` of 10a's auto_8m + 8I with b placed
   ``Shard(0)`` (its basis kept as this rank's rows), both ways: x in b's
   placement, restarts and x bit for bit the unsharded solve's, one read
   and no other synchronizing call per restart of a cached solve, the
   collectives of one Arnoldi step, E2 and K7, K9-K11 in the captured block
   and no cuSOLVER kernel; 14h's nested GMRES on DTensor vectors (14h's
   counts, x bit for bit); phase 11c's ``funm_apply`` on a DTensor b; 10e's
   L-BFGS model sharded, DTensor pairs pushed and the shifted solves at its
   three σ bit for bit; slice 1's CG with a plain Jacobi ``opDiagonal`` M on
   a DTensor b, bit for bit the same M sharded. Its launches must include
   K1, K2, K7, K9-K11, E2 and G1.
   13i (after phase 15, whose unsharded 15b and 15e numbers it prints
   beside its own): spectral routines, estimators and checks on distributed
   operators, each bit for bit the unsharded call with the same generator
   and each output in the reference's placement. LOBPCG (k = 2) on the
   2048² Laplacian through ``stencil_partition_2d``, both ways (the same
   arithmetic as a plain operator, bit for bit; reads per cached solve
   15b's; two all-reduces per mesh dimension an iteration; E1 and no
   cuSOLVER kernel in the block), then k = 32 (E1's cluster kernel); svds,
   normest and the checks of phase 4's B sharded; rsvd of auto_8m
   replicated; 11c's estimators on I + L sharded, within 11c's limits; the
   Nyström preconditioner of slice 1's graph sharded as M of its CG with a
   plain b (x split by rows). Its launches must include K1, K2, K7, K9-K12
   and E1 (both kernels).
   14i (after 13i, on its 1x1 mesh): ``opIterativeInverse``'s block apply
   as one panel solve. 14h's GMRES inverse on an (n, 8) Rademacher block and
   in ``estimate_trace``, against the column loop (restarts per column
   equal, each column within 1e-5, one E2 launch per restart where the loop
   launches 8, wall and CUDA-event µs per cached block apply of both);
   LOBPCG (k = 4) on the 2048² Laplacian with a CG inverse as M, and the
   same on ``stencil_partition_2d``, both ways (one while node per M apply
   where the column loop has 4; bits; no collective in an inner iteration;
   wall and CUDA-event µs per iteration, marginal over two lengths). Its
   launches, counted over the panel path's runs alone (not the column
   loop's), must include E2, G1, K7, K9-K11 and E1.
   16 (after 14i): a BSR operator's block transposes in one launch, as the
   reference's vmapped K2/K4/K6 are one batched kernel. (a) K2p, K4p and K6p
   on phase 5's operators (8x128 f32 and bf16, 128x128; the 2^22 banded and
   band + far cluster window operators) at k = 1, 3, 8, 12, 32: within
   1e-5 of their plain versions, the same bits on a rerun, bit for bit the
   vector kernel's column loop; µs in a CUDA graph of 20 and by marginal
   events beside the column loop, the plain panel and cuSPARSE's SpMM on a
   CSR of Aᵀ; the window operators' T blocks through estimate_trace(AᵀA).
   (b) svds(k = 4) of phase 4's B in cached captured blocks against the
   same solve with B's T/H blocks as the column loop: bit for bit, one K2p
   launch per H block, µs per iteration both ways. (c) the Nyström sketch of
   slice 1's graph: one K2p launch per Bᵀ block, plain and through
   shard_operator at world size 1, bit for bit. (d) the gradient of
   ½‖Bᵀ M − Y‖² against the plain backend's. Its launches, counted over
   16's paths alone, must include K2p, K4p and K6p.
   17 (after 16): a BSR operator's forward blocks in one launch (the N block
   on the card, a symmetric operator's T block, ``torch.func.vmap`` of an N
   vector apply), as the reference's vmapped K1/K3/K5 are one batched
   kernel. (a) K1p, K3p and K5p on phase 5's operators and the 2^22 window
   operators at k = 1, 3, 8, 12, 32: within 1e-5 of their plain versions,
   the same bits on a rerun, bit for bit the vector kernel's column loop;
   µs at k = 8 in a CUDA graph of 20 and by marginal events beside the
   column loop, ``bsr_matmat``, the plain panel and cuSPARSE's SpMM on a CSR
   of A; the window operators' N blocks through estimate_trace(A Aᵀ). (b)
   svds(k = 4) of phase 4's B in cached captured blocks against the same
   solve with its N block as ``bsr_matmat``; LOBPCG(k = 4) on slice 2's
   I + L (K3p alone in its block, θ against the closed form); a symmetric
   T block bit for bit its N block. (c) vmap of an N apply (one K1p
   launch) and a vmapped CG in captured blocks (⌈I/4⌉ host reads cached,
   bit for bit the per-iteration vmap loop). (d) a FunctionOperator's block
   in one call of its function, also as a DTensor block. (e) the gradient of ½‖A_sym M − Y‖². Its launches, counted
   over 17's paths alone, must include K1p, K3p and K5p.

14. main path of slice 9, the device-resident solve loop: slice 1's CG and
   each phase-10 solve (GMRES(30) and BiCGSTAB on auto_8m + 8I, damped LSQR,
   the saddle-point MINRES, CG with 8 right-hand sides), CGs on step 1's
   routed matrix (K7, K9-K11) and on its program without bounds (K13),
   matvec chains on the 2^22 window operators (K3-K6), MINRES on B + I and a
   trust-region σ-search (example 04's) on the n = 10^6 L-BFGS model, each
   in the per-iteration loop (``loop.BLOCK = 1``, no capture) and in
   graph blocks: a first solve (the plain loop), a second (it captures) and
   cached ones: the same count, x bit for bit, the launches each captured
   block recorded against its graph's kernel nodes and a profiler trace of
   one replay, one replay under
   ``torch.cuda.set_sync_debug_mode("error")``, wall and device µs per
   iteration, busy shares, host reads and synchronizing calls per solve,
   capture ms; slice 1's CG at block lengths 1-16, and solves right after an
   L-BFGS push (a new signature each), the plain and default loops
   interleaved round by round;
   shifted L-BFGS solves with σ on the card (no synchronisation, the same
   bits as a Python σ); (f) a nested solve: CG on the Schur complement
   B (I + L)⁻¹ Bᵀ of phase 10c's saddle point, the inverse an inner CG to
   1e-6 (K3), both ways: the outer and summed inner iterations and x the
   same, ⌈I/4⌉ reads a cached solve, one CUDA while node per outer
   iteration with K3 and G1 in its body, S x = g in f64 through the plain
   backend; the reference's small case (an inexact inner cg as the
   preconditioner) on slice 1's graph; G1 against its plain version (the
   iterations a while node runs) and timed; (d) GMRES(30) reads once per
   restart (plus once in the per-iteration loop), makes no synchronizing
   call but its reads, and its block holds one E2; (h) a nested GMRES:
   BiCGSTAB on 10a's auto_8m + 8I preconditioned by
   ``opIterativeInverse(tol 1e-2, maxiter 30)`` ("auto": GMRES(30), one
   restart an apply), both ways: outer iterations, summed inner restarts and
   x the same, ⌈I/4⌉ reads a cached solve, two while nodes per outer
   iteration, each body one restart with E2 and G1, ‖b − S x‖/‖b‖ in f64.
   The captured blocks must hold K1-K7, K9-K13, G1 and E2.
15. main path of slice 10, LOBPCG, svds and normest on the device loop:
   (a) E1 (``kernels/small_eigh.py``, the small Hermitian eigensolver) against
   its plain version torch.linalg.eigh for f32, f64, c64, c128 at m = 1, 2,
   6, 24, 96, 150 (|Δλ|, ‖AV − VΛ‖₂ ≤ 50·eps·‖A‖₂, max|VᴴV − I| ≤ 50·eps), a
   NaN input that ends, its gradient against eigh's, and its time at m = 2,
   6, 24, 96 (f32) beside torch.linalg.eigh's and the bound of what an
   eigendecomposition needs (about 9 m³ operations); (b) LOBPCG (k = 2,
   gram basis, f32) on phase 11's 2048² stencil in the per-iteration loop and
   in captured blocks (``loop_modes``: same count, θ and X bit for bit, E1
   four times per iteration in the block's graph and no cuSOLVER kernel, a
   replay under sync-debug error, wall and device µs per iteration, busy
   share, reads and syncs per solve), θ within its residual of the
   closed-form eigenvalues, and the marginal wall time per iteration; E1's
   launch count is this step's; every matrix E1 got in one solve against
   eigh, and the solves with eigh in E1's place (the eigh loop) and with
   eigh on inputs widened to f64: the same count, θ within 16 f32 ulps of
   ‖A‖₂; (c) svds and normest of phase 4's BSR operator in captured blocks
   against phase 11b's values, svds also against the solve with eigh in
   E1's place; (d) every ported example's ``main()`` on the card (03 and 08 in the world of one rank); (e) LOBPCG
   at k = 32 on the stencil (E1 at m = 32 and 96): wall µs per iteration,
   the per-iteration loop with eigh against cached blocks with E1; E1 on
   every matrix one solve gives it, θ against eigh widened to f64; (f) E2
   (``kernels/small_lstsq.py``, GMRES's least-squares step) against its
   plain version (the SVD at ``jnp.linalg.lstsq``'s cutoff) on the
   Hessenbergs one 10a solve gives it and on random, lucky-breakdown and zero
   Hessenbergs in f32, f64, c64, c128 at m = 2-256 (m = 120 and up in the
   global workspace but in f32): the residual within 50·eps·‖b‖ of the plain
   version's, σ against the SVD in f64, exact zeros past a breakdown, the
   same bits on a rerun and alone; its time at m = 2-128 (100-120 around the
   first design's shared-memory edge) in a CUDA graph of 20 beside the plain
   version, ``torch.linalg.pinv`` and the bound (4 (m + 1) m² + 8 m³
   operations).

Prints a JSON line describing each kernel, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits non-zero
on any failure, and when no CUDA device is present: there is no CPU path.
"""

import collections
import contextlib
import json
import os
import re
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
TRACE_TRIES = 8  # profiler traces taken to count a run's kernels (trace_until)
TRACES_TAKEN = []  # (traces taken, whether the last counted what was wanted), per trace_until
SPINS = 16  # spin kernels launched at each end of a traced window (traced), doubled each retry
SPINS_LOST = []  # (spins lost at the window's start, at its end, whether want was counted), per trace
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
LG_SOURCE = "linops_tpu_torch/kernels/csrc/lane_gather.cu"
LANE_KERNELS = {  # name -> the TPU kernel it replaces (def line)
    "lane_gather": "linops_tpu/kernels/lane_gather.py:68",  # K7
    "lane_gather_mul": "linops_tpu/kernels/lane_gather.py:368",  # K8
    "lane_gather_mul_t_batched": "linops_tpu/kernels/lane_gather.py:324",  # K9
    "lane_gather_sum": "linops_tpu/kernels/lane_gather.py:158",  # K10
    "lane_segsum": "linops_tpu/kernels/lane_gather.py:232",  # K11
    "lane_gather_mul_segsum": "linops_tpu/kernels/lane_gather.py:263",  # K12
    "tiled_combine": "linops_tpu/kernels/lane_gather.py:119",  # K13
    "lane_gather_mul_t": "linops_tpu/kernels/lane_gather.py:301",  # K14
}
N3 = 1 << 20  # phase 9 step 1: the unstructured SPD matrix
N_AUTO8M = 1 << 19  # phase 9 step 2
N_RCM, BW_RCM = 1 << 18, 56  # phase 9 step 3
N_K8 = 1500  # phase 8: the 3-stage operator that runs K8
N_LSQ_ROWS = 1 << 20  # phase 10b: the least-squares matrix is N_LSQ_ROWS x N_AUTO8M
# H100 SXM peaks (NVIDIA's data sheet): device memory rate, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = 67e12


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


def graph_ms(fn, n=20):
    """ms per call with the host's launch cost out of the way: n calls
    captured in one CUDA graph, the graph replayed and timed with CUDA
    events; median of REPS replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    del g
    return float(np.median(times))


def profiled_ms(fn, kernel, n=20):
    """Mean device duration in ms of the CUDA kernel named ``kernel`` (the
    function name in the .cu file) over n calls, from a torch.profiler trace;
    None when the trace holds no device time for it."""
    fn()
    _, prof = traced(lambda: [fn() for _ in range(n)])
    total, count = 0.0, 0
    for e in prof.key_averages():
        if f"::{kernel}<" in e.key:  # "(anonymous namespace)::segsum_kernel<float>(...)"
            t = getattr(e, "device_time_total", None)
            total += t if t is not None else e.cuda_time_total
            count += e.count
    return total / count / 1e3 if count and total > 0 else None


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


def sr1_apply_recursive(pairs, v):
    """B v in f64 for the SR1 matrix that ``pairs`` (oldest first) build
    from B₀ = I/γ, γ = ⟨s,y⟩/⟨y,y⟩ of the newest pair, one rank-1 update at a
    time: aᵢ = yᵢ − Bᵢ₋₁sᵢ, Bᵢ = Bᵢ₋₁ + aᵢaᵢᵀ/⟨aᵢ,sᵢ⟩. No compact form."""
    pairs = [(s.double(), y.double()) for s, y in pairs]
    s_new, y_new = pairs[-1]
    gamma = float(s_new @ y_new) / float(y_new @ y_new)
    terms = []  # (aᵢ, ⟨aᵢ, sᵢ⟩)

    def apply(x):
        out = x / gamma
        for a, a_s in terms:
            out = out + a * (float(a @ x) / a_s)
        return out

    for s, y in pairs:
        a = y - apply(s)
        terms.append((a, float(a @ s)))
    return apply(v.double())


def diagonal_qn_recursive(cls, pairs, d):
    """The diagonal ``cls`` holds after pushing ``pairs`` onto ``d``, in
    f64, from each update's closed form: the weak-secant updates add
    c·(s⊙s) with ⟨s, d s⟩ = ⟨s, y⟩ after (Andrei's from d − 1 with ⟨s, s⟩
    added to the gap), the Barzilai-Borwein σ = ⟨s,y⟩/⟨s,s⟩, and the
    diagonal BFGS |y|·Σ|y|·⟨s,s⟩/⟨s,y⟩."""
    d = d.double()
    for s, y in pairs:
        s, y = s.double(), y.double()
        s2, sy, ss = s * s, float(s @ y), float(s @ s)
        if cls == "DiagonalPSB":
            d = d + (sy - float(s2 @ d)) / float(s2 @ s2) * s2
        elif cls == "DiagonalAndrei":
            d = d + (sy - float(s2 @ d) + ss) / float(s2 @ s2) * s2 - 1.0
        elif cls == "SpectralGradient":
            d = torch.full_like(d, sy / ss)
        else:
            d = y.abs() * (float(y.abs().sum()) * ss / sy)
    return d


_LOOP_FUNCTION = []


def loop_function(lt, *args, **kwargs):
    """A ``FunctionOperator`` whose block applies are the column loop of its
    vector applies (the base class's, one call of the function per column),
    not one vmapped call: the yardsticks and twins the phases compare with a
    loop of vector applies. One class for every such operator, so that a
    captured block's key sees the same class."""
    if not _LOOP_FUNCTION:
        from linops_tpu_torch.core.base import LinearOperator

        class LoopFunction(lt.FunctionOperator):
            def apply_matrix(self, M, mode="N"):
                return LinearOperator.apply_matrix(self, M, mode)

        _LOOP_FUNCTION.append(LoopFunction)
    return _LOOP_FUNCTION[0](*args, **kwargs)


def free():
    from linops_tpu_torch.utils import loop

    loop.clear_cache()  # captured blocks hold copies of their operators and memory pools
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def win_names(op):
    """(forward, transpose) kernel names the operator's plan selects."""
    if op.cols_local is not None:
        return "bsr_matvec_windowed", "bsr_rmatvec_windowed"
    return "bsr_matvec_multiwin", "bsr_rmatvec_multiwin"


def win_plain(K, op, xb=None, ub=None):
    """The plain version of the operator's window kernel, forward or
    transpose (with the summation order the operator keeps)."""
    d = op.data
    nbcol = op.shape[1] // 128
    if op.cols_local is not None:
        if xb is not None:
            return K.bsr_matvec_windowed_plain(d.blocks, op.cols_local, op.win_q, xb, wb=op._wb,
                                               x_pad_blocks=op._x_pad_blocks)
        return K.bsr_rmatvec_windowed_plain(d.blocks, op.cols_local, op.win_q, ub, wb=op._wb,
                                            x_pad_blocks=op._x_pad_blocks, nbcol=nbcol,
                                            sum_plan=op.plain_transpose_plan())
    if xb is not None:
        return K.bsr_matvec_multiwin_plain(d.blocks, d.block_cols, op.win_q, xb, wb=op._wb,
                                           x_pad_blocks=op._x_pad_blocks)
    return K.bsr_rmatvec_multiwin_plain(d.blocks, d.block_cols, op.win_q_t, op.win_valid_t, ub,
                                        wb=op._wb, x_pad_blocks=op._x_pad_blocks_t, nbcol=nbcol,
                                        sum_plan=op.plain_transpose_plan())


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
                                         index=op.t_plan)


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
            if not banded:  # K2 on the hot column: its column plan against the same sums
                plan = op.col_plan
                k2 = K.bsr_rmatvec_kernel(d.blocks, d.block_cols, ub, nbcol, plan=plan).reshape(-1)
                k2b = K.bsr_rmatvec_kernel(d.blocks, d.block_cols, ub, nbcol, plan=plan).reshape(-1)
                e2 = {"plain": rel_err(k2, o_plain), "f64": rel_err(k2, o64)}
                check(torch.isfinite(k2).all() and all(e <= KERNEL_RTOL for e in e2.values()),
                      f"{name} {dtype}: K2 disagrees on the hot column: {e2}")
                check(torch.equal(k2, k2b), f"{name} {dtype}: K2 is not deterministic")
                counts = (plan.colptr[1:] - plan.colptr[:-1]).long()
                hot = int(counts.argmax())
                print(f"[6 window kernels] {name} {str(dtype)[6:]}: bsr_rmatvec (K2) through its "
                      f"column plan ({plan.chunk_col.numel()} chunks of at most "
                      f"{plan.chunk_slots} slots; hot column {hot} holds {int(counts[hot])} "
                      f"slots in {int(plan.col_chunk[hot + 1] - plan.col_chunk[hot])} chunks): "
                      + ", ".join(f"{k} {e:.2e}" for k, e in e2.items())
                      + f" (limit {KERNEL_RTOL:g}); bit-identical on rerun", flush=True)
                del k2, k2b
            del op, d, y, o, o2, y_plain, o_plain, y64, o64, v, u, xb, ub
    return err_abs


def five_point(grid):
    """The 5-point Laplacian L on a grid x grid mesh (Dirichlet), scipy CSR
    f64: diagonal 4, off-diagonals -1."""
    import scipy.sparse as sps

    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(grid, grid))
    eye = sps.identity(grid)
    return (sps.kron(eye, t) + sps.kron(t, eye)).tocsr()


def laplacian(grid):
    """I + L on a grid x grid mesh, scipy CSR, f32: diagonal 5, off-diagonals -1."""
    import scipy.sparse as sps

    return (five_point(grid) + sps.identity(grid * grid)).tocsr().astype(np.float32)


def phase7(lt, K, dev):
    """Slice 2's path through the entry points a user calls. Returns the
    launch counts of the run (reset just before it) and (the Laplacian's
    operator, its scipy matrix) for phase 10."""
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
                    (d.blocks, d.block_cols, op.win_q, op.cols_local, *op.col_plan[:-1],
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
    laplacian_op = (op, A)  # phase 10's saddle-point block
    del d, plain, x, x_t, b
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
    return counts, laplacian_op


def phase5_windows(lt, K, dev, card):
    """Times of K3-K6 beside their plain versions and K1/K2 on the same
    operator, and (f32) the cuSPARSE CSR matvec of A (K3/K5's yardstick) and
    of Aᵀ built once (K4/K6's). Returns {shape: {name: ms}} for the f32
    cases."""
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
                    d.blocks, d.block_cols, ub, nbcol, plan=op.col_plan)),
            }
            ops_ = 2 * d.blocks.numel()
            bounds = {fwd: bound_ms(nbytes(d.blocks, d.block_cols, xb) + nbrow * 8 * 4, ops_),
                      tr: bound_ms(nbytes(d.blocks, d.block_cols, ub) + nbcol * 128 * 4, ops_)}
            print(f"[5 times] {name} {str(dtype)[6:]} bounds: "
                  + ", ".join(f"{k} {b_[0] * 1e3:.1f} us ({b_[1]}), {row[k] * 1e3:.1f} us = "
                              f"{b_[0] / row[k]:.1%} of it" for k, b_ in bounds.items())
                  + f"; {tr} {row[tr] / row['K2']:.3f}x K2; {card}", flush=True)
            if dtype == torch.float32:
                out[name] = {**row, fwd + " bound": bounds[fwd], tr + " bound": bounds[tr]}
            print(f"[5 times] {name} kmax={WIN_KMAX[name]} n=2^22 blocks {str(dtype)[6:]} "
                  f"({gb * 1e3:.1f} MB stored): "
                  + ", ".join(f"{k} {v * 1e3:.1f} us = {gb / (v / 1e3):.0f} GB/s" for k, v in row.items())
                  + f"; {card}", flush=True)
            if dtype == torch.float32:  # cuSPARSE yardsticks: a CSR of A, a CSR of Aᵀ
                lib = out[name]
                lib[fwd + " library"], lib[fwd + " library note"] = library_time(
                    fwd, lambda: csr_of_bsr(d.blocks, d.block_cols, WIN_N), xb.reshape(-1),
                    win_plain(K, op, xb=xb).reshape(-1))
                lib[tr + " library"], lib[tr + " library note"] = library_time(
                    tr, lambda: csr_t_of_bsr(K, d.blocks, d.block_cols, nbcol), ub.reshape(-1),
                    win_plain(K, op, ub=ub).reshape(-1))
                shown = {k: "null" if lib[k + " library"] is None
                         else f"{lib[k + ' library'] * 1e3:.1f} us" for k in (fwd, tr)}
                print(f"[5 times] {name} f32 cuSPARSE CSR torch.mv ({d.blocks.numel() / 1e9:.2f}G "
                      f"values, int32 indices): {fwd} on a CSR of A {shown[fwd]}, {tr} on a CSR "
                      f"of Aᵀ built once {shown[tr]}; {card}", flush=True)
            del op, d, xb, ub
    return out


# ----------------------------------------------------------------------------
# Slice 3: the Clos-routed unstructured path and the lane-gather kernels
# ----------------------------------------------------------------------------


def tree_bytes(obj) -> int:
    """Bytes of every tensor in a routing program (NamedTuples, tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(tree_bytes(v) for v in obj)
    return 0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes, n_ops=0, peak_ops=F32_PEAK):
    """(least time in ms, what bounds it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def spd_unstructured(n, per_row, seed):
    """A = R + Rᵀ + D (scipy CSR, f32): R with Poisson(per_row) entries per
    row at uniform columns with normal values, D making A strictly
    diagonally dominant."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    counts = rng.poisson(per_row, n)
    nnz = int(counts.sum())
    rows = np.repeat(np.arange(n, dtype=np.int32), counts)
    R = sps.csr_matrix((rng.standard_normal(nnz).astype(np.float32),
                        (rows, rng.integers(0, n, nnz, dtype=np.int32))), shape=(n, n))
    S = (R + R.T).tocsr()
    d = np.asarray(abs(S).sum(axis=1)).ravel() + 1.0
    return (S + sps.diags(d.astype(np.float32))).tocsr().astype(np.float32)


def auto_8m(seed):
    """The reference bench's auto_8m matrix (bench.py:942-973): n = 2^19,
    Poisson(16) uniform columns per row, normal f32 values, not symmetric."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    na = N_AUTO8M
    counts = rng.poisson(16, na)
    nnz = int(counts.sum())
    indptr = np.zeros(na + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = rng.integers(0, na, nnz)
    order = np.lexsort((cols, np.repeat(np.arange(na), counts)))
    return sps.csr_matrix((rng.standard_normal(nnz).astype(np.float32),
                           cols[order].astype(np.int32), indptr), shape=(na, na))


def scrambled_banded(seed):
    """A banded f32 matrix (half-bandwidth BW_RCM, n = N_RCM) under a random
    symmetric permutation: the shape reorder.py:7 and bench.py:915-940 name."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    offs = range(-BW_RCM, BW_RCM + 1)
    A = sps.diags([rng.standard_normal(N_RCM - abs(k)).astype(np.float32) for k in offs], offs,
                  format="csr", dtype=np.float32)
    sig = rng.permutation(N_RCM)
    return A[sig][:, sig].tocsr()


def dev_vec(n, dev, seed, k=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n,) if k is None else (n, k), generator=g, device=dev)


def phase9(lt, K, LG, dev):
    """Slice 3's path through the entry points a user calls. Returns the
    operators (for phases 8 and 5) and the lane-kernel launches of the run
    (counts set to 0 just before, read just after)."""
    import warnings

    from linops_tpu_torch.sparse.routed import RoutedTranspose, routed_matvec

    out = {}
    LG.reset_launch_counts()
    K.reset_launch_counts()
    totals = dict.fromkeys(LG.launch_counts(), 0)

    def take_counts():
        c = LG.launch_counts()
        for k_, v_ in c.items():
            totals[k_] += v_
        LG.reset_launch_counts()
        return c

    # --- 1. CG on an unstructured SPD matrix -------------------------------
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A1 = spd_unstructured(N3, 8, SEED + 40)
    t1 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        op1 = lt.opSparse(A1, format="auto", symmetric=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    p1 = op1.routed
    check(isinstance(op1, lt.RoutedCSROperator), f"auto picked {type(op1).__name__}")
    check(any("pack" in str(w.message) for w in wl), "format='auto' did not warn about the pack")
    check(p1.vals.is_cuda and p1.vals.shape[0] > 1 and p1.vals.shape[1] > 128
          and len(p1.stages) == 4 and p1.comb_lo is not None,
          f"not a multi-chunk 5-stage tiled program: vals "
          f"{tuple(p1.vals.shape)}, {len(p1.stages)} stages")
    print(f"[9 slice-3 path] A = R + Rᵀ + D, n = 2^20, {A1.nnz} nnz (scipy, {t1 - t0:.2f} s); "
          f"opSparse(format='auto', symmetric=True) -> {type(op1).__name__} on {p1.vals.device}: "
          f"{p1.vals.shape[0]} chunks x {p1.vals.shape[1]} windows (5-stage), w {p1.w}, "
          f"{tree_bytes(p1) / 1e6:.1f} MB program; host pack {op1.pack_seconds['host']:.2f} s, "
          f"upload {op1.pack_seconds['upload']:.2f} s, total {t2 - t1:.2f} s incl. the BSR test; "
          f"warned: {str(wl[0].message)[:60]}...", flush=True)
    b = dev_vec(N3, dev, SEED + 41)
    t0 = time.perf_counter()
    x, k, res = lt.cg(op1, b, tol=1e-5, maxiter=2000)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    c1 = take_counts()
    for name in ("lane_gather", "lane_gather_mul_t_batched", "lane_gather_sum", "lane_segsum"):
        check(c1[name] > 0, f"{name} never ran in the slice-3 cg: {c1}")
    check(k < 2000 and torch.isfinite(x).all() and tuple(x.shape) == (N3,),
          f"slice-3 cg: {k} iterations, finite {bool(torch.isfinite(x).all())}")
    x_host, b_host = x.double().cpu().numpy(), b.double().cpu().numpy()
    true_res = float(np.linalg.norm(b_host - A1.astype(np.float64) @ x_host)
                     / np.linalg.norm(b_host))
    check(true_res <= 1e-4, f"slice-3 cg f64 residual {true_res:.3e} > 1e-4")
    plain = loop_function(lt, N3, N3, lambda v: routed_matvec(p1, v, use_kernel=False),
                          symmetric=True, hermitian=True, dtype=torch.float32)
    x_p, k_p, _ = lt.cg(plain, b, tol=1e-5, maxiter=2000)
    dx = float(torch.linalg.vector_norm(x_p - x) / torch.linalg.vector_norm(x_p))
    check(sum(LG.launch_counts().values()) == 0, "the plain pipeline launched a kernel")
    check(abs(k_p - k) <= 1 and dx <= 1e-4,
          f"plain-pipeline cg: {k_p} iterations (kernels {k}), |Δx|/|x| {dx:.2e}")
    print(f"[9 slice-3 path] cg(tol 1e-5): {k} iterations, f64 residual (scipy) {true_res:.3e} "
          f"(limit 1e-4), {t_cg:.3f} s incl. first calls; plain pipeline {k_p} iterations, "
          f"|Δx|/|x| {dx:.2e} (limit 1e-4); launches {c1}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    out["op1"], out["nnz1"], out["A1"], out["cg_iters1"] = op1, A1.nnz, A1, k
    del x, x_p, b, plain

    # --- 2. transpose and multi-RHS on the bench's auto_8m matrix -----------
    free()
    A2 = auto_8m(SEED + 42)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        op2 = lt.opSparse(A2, format="auto")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(isinstance(op2, lt.RoutedCSROperator) and isinstance(op2.routed_t, RoutedTranspose),
          "auto_8m: not a routed operator with a derived transpose")
    check(any("pack" in str(w.message) for w in wl), "auto_8m: no pack warning")
    A2d = A2.astype(np.float64)
    v = dev_vec(A2.shape[0], dev, SEED + 43)
    errs = {}
    for mode in ("N", "T"):
        got = lt.matvec_chain(op2, v, 5, mode=mode)
        ref = v.double().cpu().numpy()
        for _ in range(5):
            ref = (A2d @ ref) if mode == "N" else (A2d.T @ ref)
            ref = ref / np.linalg.norm(ref)
        errs[f"chain {mode}"] = float(np.abs(got.double().cpu().numpy() - ref).max()
                                      / np.abs(ref).max())
    c2 = take_counts()
    LG.reset_launch_counts()
    op2.T * v
    cT = take_counts()
    check(cT["lane_gather"] > 0 and cT["lane_gather_mul_segsum"] > 0,
          f"auto_8m transpose did not run K7 and K12: {cT}")
    X = dev_vec(A2.shape[1], dev, SEED + 44, k=8)
    Xh = X.double().cpu().numpy()
    check(op2.matrix_path("N") == "routed" and op2.matrix_path("T", panel=True) == "routed_panel",
          "the matrix applies do not take the routed pipeline on the card")
    for tag, got, ref in (("apply_matrix N", lt.matmat(op2, X), A2d @ Xh),
                          ("apply_matrix T", lt.matmat(op2, X, mode="T"), A2d.T @ Xh),
                          ("apply_matrix_t N", op2.apply_matrix_t(X.t().contiguous()),
                           (A2d @ Xh).T),
                          ("apply_matrix_t T", op2.apply_matrix_t(X.t().contiguous(), "T"),
                           (A2d.T @ Xh).T)):
        errs[tag] = float(np.abs(got.double().cpu().numpy() - ref).max() / np.abs(ref).max())
    take_counts()
    check(all(e <= 1e-5 for e in errs.values()), f"auto_8m disagrees with scipy: {errs}")
    print(f"[9 slice-3 path] auto_8m: n = 2^19, {A2.nnz} nnz -> {type(op2).__name__}, "
          f"{op2.routed.vals.shape[0]} chunks, derived transpose, built in {t_build:.2f} s (host "
          f"pack {op2.pack_seconds['host']:.2f} s, upload {op2.pack_seconds['upload']:.2f} s); "
          + ", ".join(f"{k_} {e:.2e}" for k_, e in errs.items())
          + f" (max|Δ|/max against scipy f64, limit 1e-5); launches of one T apply {cT}",
          flush=True)
    out["op2"], out["nnz2"], out["A2"] = op2, A2.nnz, A2
    del A2d, X

    # --- 3. the RCM sandwich --------------------------------------------------
    free()
    Asc = scrambled_banded(SEED + 45)
    t0 = time.perf_counter()
    op3 = lt.opSparse(Asc, format="auto", reorder="rcm")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(isinstance(op3, lt.ReorderedOperator) and isinstance(op3.inner, lt.BSROperator),
          f"rcm: inner {type(getattr(op3, 'inner', None)).__name__}, expected BSROperator")
    K.reset_launch_counts()
    v = dev_vec(N_RCM, dev, SEED + 46)
    A3d = Asc.astype(np.float64)
    vh = v.double().cpu().numpy()
    e3 = {}
    for mode, ref in (("N", A3d @ vh), ("T", A3d.T @ vh)):
        got = lt.matvec(op3, v, mode=mode).double().cpu().numpy()
        e3[mode] = float(np.abs(got - ref).max() / np.abs(ref).max())
    c3, k3 = take_counts(), K.launch_counts()
    check(all(e <= 1e-5 for e in e3.values()), f"rcm sandwich disagrees with scipy: {e3}")
    check(c3["lane_gather"] > 0 and c3["lane_gather_sum"] > 0, f"rcm: P did not run K7/K10: {c3}")
    check(sum(k3.values()) > 0, f"rcm: the inner BSR ran no kernel: {k3}")
    d3 = op3.inner.data
    print(f"[9 slice-3 path] rcm: scrambled band n = 2^18, half-bandwidth {BW_RCM}, {Asc.nnz} nnz "
          f"-> ReorderedOperator(BSR {d3.block_shape[0]}x{d3.block_shape[1]} kmax "
          f"{d3.blocks.shape[1]}, window plan {op3.inner.win_q is not None}) in {t_build:.2f} s; "
          f"N {e3['N']:.2e}, T {e3['T']:.2e} (max|Δ|/max against scipy f64, limit 1e-5); "
          f"lane launches {c3}; BSR launches {k3}", flush=True)
    del Asc, A3d, op3, d3

    # --- 4. a permutation of 2^20 --------------------------------------------
    free()
    perm = np.random.default_rng(SEED + 47).permutation(1 << 20)
    t0 = time.perf_counter()
    P = lt.opPermutation(perm)
    t_build = time.perf_counter() - t0
    x = dev_vec(1 << 20, dev, SEED + 48)
    pt = torch.from_numpy(perm).to(dev)
    inv = torch.empty_like(pt)
    inv[pt] = torch.arange(1 << 20, device=dev)
    check(torch.equal(lt.matvec(P, x), x[pt]), "P x != x[perm]")
    check(torch.equal(lt.matvec(P, x, mode="T"), x[inv]), "Pᵀ x != x[perm⁻¹]")
    c4 = take_counts()
    check(c4["lane_gather"] > 0 and c4["lane_gather_sum"] == 2, f"permutation launches {c4}")
    print(f"[9 slice-3 path] opPermutation(2^20): N and T exactly x[perm], x[perm⁻¹]; routed in "
          f"{t_build:.2f} s (forward program; the inverse packs at the first T); launches {c4}",
          flush=True)
    out["perm"] = (P, x)
    out["launches"] = totals
    print(f"[9 slice-3 path] lane-kernel launches over steps 1-4: {totals}", flush=True)
    return out


def lane_cases(p1, p2t, p3s):
    """{kernel: (rows of its data operand, dtype -> its other arguments)} at
    the main path's shapes: K7/K9/K10/K11 from step 1's program, K12 from
    step 2's derived transpose, K8 from the 3-stage operator's program."""
    C1, m1 = p1.vals.shape[0], p1.vals.shape[1]
    C3, m3 = p3s.vals.shape[0], p3s.vals.shape[1]
    C2, m2 = p2t.vals_pre.shape[0], p2t.vals_pre.shape[1]
    T8, Kt = p1.rowid.shape
    flat = lambda t, rows: t.reshape(rows, 128)  # noqa: E731
    return {
        "lane_gather": (C1 * m1, lambda dt: (flat(p1.stages[0], C1 * m1),)),
        "lane_gather_mul": (C3 * m3, lambda dt: (flat(p3s.lane_idx, C3 * m3),
                                                 flat(p3s.vals, C3 * m3).to(dt))),
        "lane_gather_mul_t_batched": (C1 * m1, lambda dt: (flat(p1.lane_idx, C1 * m1),
                                                           flat(p1.vals, C1 * m1).to(dt), C1, m1)),
        "lane_gather_sum": (C1 * m1, lambda dt: (flat(p1.stages[3], C1 * m1), p1.w)),
        "lane_segsum": (T8 * Kt // 128, lambda dt: (p1.comb_lo, p1.comb_hi)),
        "lane_gather_mul_segsum": (C2 * m2, lambda dt: (
            flat(p2t.g1inv, C2 * m2), flat(p2t.vals_pre, C2 * m2).to(dt),
            flat(p2t.bnd_lo, C2 * m2), flat(p2t.bnd_hi, C2 * m2))),
    }


def segsum_limit(z, lo, rep, dt, ref):
    """8·eps_f32·Σ|window| per element (the prefix difference), plus one ulp
    of a bf16 result."""
    r0 = lo.shape[0]
    win = z.double().abs().reshape(rep, r0, 128).sum(2, keepdim=True).expand(rep, r0, 128)
    lim = 8 * torch.finfo(torch.float32).eps * win.reshape(rep * r0, 128)
    if dt == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.double().abs()
    return lim


def phase8(lt, LG, dev, ops):
    """K7-K12 against their plain versions on the card, f32 and bf16, rep 1
    and 8, at the shapes of phase 9's programs; K8 also on a 3-stage
    operator's path and at a synthetic (8·65536, 128). Returns (max|Δ| of
    each f32 rep-1 case, K8's launches on its operator's path, the 3-stage
    program)."""
    import scipy.sparse as sps

    # K8 runs only on 3-stage routes (at most 16384 slots): at 0.4 % density,
    # n = 2000 packs 5-stage and n = N_K8 (about 9000 nnz) is near the largest
    # that stays 3-stage
    A = sps.random(N_K8, N_K8, density=0.004, format="csr", random_state=SEED + 50,
                   dtype=np.float32)
    op3s = lt.opSparse(A, format="routed")
    p3s = op3s.routed
    check(p3s.vals.shape[1] <= 128 and len(p3s.stages) == 2, "the K8 operator is not 3-stage")
    v = dev_vec(N_K8, dev, SEED + 51)
    LG.reset_launch_counts()
    y = lt.matvec(op3s, v)
    k8_launches = LG.launch_counts()["lane_gather_mul"]
    check(k8_launches > 0, "the 3-stage operator did not run K8")
    e = float((y.double().cpu() - torch.from_numpy(A.astype(np.float64) @ v.double().cpu()
                                                   .numpy())).abs().max())
    check(e <= 1e-5 * float(y.abs().max()), f"3-stage operator: max|Δ| {e:.2e} against scipy")
    print(f"[8 lane kernels] 3-stage operator: n = {N_K8}, {A.nnz} nnz at 0.4 %, "
          f"{p3s.vals.shape[1]} windows; one apply launched K8 {k8_launches} time(s); max|Δ| "
          f"{e:.2e} against scipy (limit 1e-5·max|y|)", flush=True)

    cases = lane_cases(ops["op1"].routed, ops["op2"].routed_t, p3s)
    err = {}
    for name, (rows, extra) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            for rep in (1, 8):
                free()
                args = extra(dt)
                a = dev_vec(rep * rows, dev, SEED + 52, k=128).to(dt)
                kern, plain = getattr(LG, name), getattr(LG, name + "_plain")
                got, again = kern(a, *args, rep=rep), kern(a, *args, rep=rep)
                ref = plain(a, *args, rep=rep)
                check(torch.equal(got, again), f"{name} {dt} rep {rep}: not bit-identical on rerun")
                check(got.dtype == ref.dtype and got.shape == ref.shape,
                      f"{name}: {got.dtype}{tuple(got.shape)} vs {ref.dtype}{tuple(ref.shape)}")
                d = (got.double() - ref.double()).abs()
                if name in ("lane_gather", "lane_gather_mul", "lane_gather_mul_t_batched"):
                    ok, lim = torch.equal(got, ref), "exact"
                elif name == "lane_gather_sum":
                    tol = 1e-6 if dt == torch.float32 else 2.0 ** -7
                    ok, lim = bool(d.max() <= tol * ref.double().abs().max()), f"{tol:g}·max|y|"
                elif name == "lane_segsum":
                    ok, lim = bool((d <= segsum_limit(a, args[0], rep, dt, ref)).all()), "eps·Σ|window|"
                else:
                    z = LG.lane_gather_mul_plain(a.float(), args[0], args[1].float(), rep=rep)
                    ok, lim = bool((d <= segsum_limit(z, args[2], rep, dt, ref)).all()), "eps·Σ|window|"
                check(ok, f"{name} {str(dt)[6:]} rep {rep}: max|Δ| {float(d.max()):.3e} ({lim})")
                if dt == torch.float32 and rep == 1:
                    err[name] = float(d.max())
                print(f"[8 lane kernels] {name} {str(dt)[6:]} rep {rep}: ({rep}x{rows}, 128) "
                      f"max|Δ| {float(d.max()):.2e} against plain ({lim}); bit-identical on rerun",
                      flush=True)
                del a, got, again, ref, d
    # K8 at a large synthetic shape
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    idx = torch.randint(0, 128, (65536, 128), generator=g, device=dev, dtype=torch.int8)
    vals = dev_vec(65536, dev, SEED + 54, k=128)
    xw = dev_vec(8 * 65536, dev, SEED + 55, k=128)
    check(torch.equal(LG.lane_gather_mul(xw, idx, vals, rep=8),
                      LG.lane_gather_mul_plain(xw, idx, vals, rep=8)),
          "lane_gather_mul differs from plain at (8·65536, 128)")
    print("[8 lane kernels] lane_gather_mul f32 rep 8 at (8·65536, 128): equal to plain", flush=True)
    return err, k8_launches, p3s


def tiled_limit(q, rowid, rep, ref):
    """K13 against its plain version: 4·eps_f32·Σ|q| over each row's slots
    (two f32 sums of the same terms in other orders), plus one ulp of a bf16
    result."""
    T, K = rowid.shape
    rid = rowid.long()
    seg = torch.where(rid >= 0, torch.arange(T, device=rid.device)[:, None] * 128 + rid,
                      T * 128).reshape(-1)
    absq = torch.zeros((rep, T * 128 + 1), dtype=torch.float64, device=q.device)
    absq.index_add_(1, seg, q.double().abs().reshape(rep, T * K))
    lim = 4 * torch.finfo(torch.float32).eps * absq[:, :T * 128].reshape(-1)
    if q.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.double().abs()
    return lim


def phase8_k13_k14(lt, LG, dev, ops):
    """K13 and K14 on the card at the main path's shapes. K13: step 1's
    program with its segment bounds dropped (the reference's pack always
    keeps them, so this is the only way a routed apply reaches K13) through
    ``routed_matvec`` against the same program through K11 and the plain
    pipeline, a rerun for the bits, K13 alone against its plain version (f32
    and bf16, rep 1 and 8, the pack's rowid and a shuffled one with trash
    slots), then CG on the forced program, whose K13 launches the kernels
    line reports. K14: one chunk of step 1 against K9 with C = 1 (bit for
    bit) and its plain version. Returns ({kernel: max|Δ| against plain, f32
    rep 1}, K13's launches in the forced CG)."""
    from linops_tpu_torch.sparse.routed import routed_matvec

    op1 = ops["op1"]
    p1 = op1.routed
    pf = p1._replace(comb_lo=None, comb_hi=None)
    T8, Kt = p1.rowid.shape
    err = {}
    v = dev_vec(N3, dev, SEED + 56)
    LG.reset_launch_counts()
    y13 = routed_matvec(pf, v)
    c = LG.launch_counts()
    check(c["tiled_combine"] == 1 and c["lane_segsum"] == 0,
          f"the program without bounds did not combine through K13: {c}")
    y11, y_plain = routed_matvec(p1, v), routed_matvec(pf, v, use_kernel=False)
    e11, ep = rel_err(y13, y11), rel_err(y13, y_plain)
    check(e11 <= 1e-5 and ep <= 1e-5, f"K13 routed apply: against K11 {e11:.2e}, plain {ep:.2e}")
    check(torch.equal(y13, routed_matvec(pf, v)), "K13's routed apply is not bit-identical on rerun")
    print(f"[8 lane kernels] tiled_combine (K13) in routed_matvec on step 1's program without "
          f"bounds (T = {T8} tiles, K = {Kt} slots): max|Δ|/max against the same program through "
          f"K11 {e11:.2e}, against the plain pipeline {ep:.2e} (limit 1e-5); bit-identical on "
          f"rerun", flush=True)
    del y13, y11, y_plain
    g = torch.Generator(device=dev).manual_seed(SEED + 57)
    shuffled = torch.gather(p1.rowid, 1, torch.argsort(torch.rand(p1.rowid.shape, generator=g,
                                                                  device=dev), dim=1))
    shuffled = torch.where(torch.rand(shuffled.shape, generator=g, device=dev) < 0.25,
                           torch.full_like(shuffled, -1), shuffled)
    for tag, rowid in (("the pack's rowid", p1.rowid), ("shuffled, 1/4 more trash", shuffled)):
        for dt in (torch.float32, torch.bfloat16):
            for rep in (1, 8):
                free()
                q = dev_vec(rep * T8 * Kt, dev, SEED + 58).to(dt)
                got, again = LG.tiled_combine(q, rowid, rep=rep), LG.tiled_combine(q, rowid, rep=rep)
                ref = LG.tiled_combine_plain(q, rowid, rep)
                check(torch.equal(got, again), f"K13 {dt} rep {rep}: not bit-identical on rerun")
                d = (got.double() - ref.double()).abs()
                check(got.dtype == ref.dtype and bool((d <= tiled_limit(q, rowid, rep, ref)).all()),
                      f"K13 {tag} {dt} rep {rep}: max|Δ| {float(d.max()):.3e} against plain")
                if dt == torch.float32 and rep == 1 and rowid is p1.rowid:
                    err["tiled_combine"] = float(d.max())
                print(f"[8 lane kernels] tiled_combine {str(dt)[6:]} rep {rep}, {tag}: "
                      f"({rep}·{T8}·{Kt},) -> ({rep}·{T8}·128,), max|Δ| {float(d.max()):.2e} "
                      f"against plain (4·eps_f32·Σ|row|); bit-identical on rerun", flush=True)
                del q, got, again, ref, d
    # K14 on one chunk of step 1
    m1 = p1.vals.shape[1]
    xw = dev_vec(m1, dev, SEED + 59, k=128)
    idx, vals = p1.lane_idx[0], p1.vals[0]
    LG.reset_launch_counts()
    out = LG.lane_gather_mul_t(xw, idx, vals)
    c = LG.launch_counts()
    check(c["lane_gather_mul_t"] == 1 and c["lane_gather_mul_t_batched"] == 0, f"K14 launches {c}")
    k9 = LG.lane_gather_mul_t_batched(xw, idx, vals, 1, m1)
    plain = LG.lane_gather_mul_t_plain(xw, idx, vals)
    check(torch.equal(out, k9), "K14 differs from K9 with C = 1")
    check(torch.equal(out, plain), "K14 differs from its plain version")
    err["lane_gather_mul_t"] = float((out - plain).abs().max())
    print(f"[8 lane kernels] lane_gather_mul_t (K14) on one chunk of step 1 ({m1}, 128) -> "
          f"(128, {m1}): bit-identical to K9 with C = 1 and to its plain version", flush=True)
    del xw, out, k9, plain
    # CG on the forced program: K13 on a solve's path
    free()
    op_f = lt.RoutedCSROperator(op1.data, symmetric=True, hermitian=True, routed=pf)
    b = dev_vec(N3, dev, SEED + 41)  # phase 9's right-hand side
    LG.reset_launch_counts()
    t0 = time.perf_counter()
    x, k, _ = lt.cg(op_f, b, tol=1e-5, maxiter=2000)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    c = LG.launch_counts()
    A1 = ops["A1"]
    bh = b.double().cpu().numpy()
    res = float(np.linalg.norm(bh - A1.astype(np.float64) @ x.double().cpu().numpy())
                / np.linalg.norm(bh))
    check(c["tiled_combine"] > 0 and c["lane_segsum"] == 0, f"forced-program cg launches {c}")
    check(abs(k - ops["cg_iters1"]) <= 1 and res <= 1e-4,
          f"forced-program cg: {k} iterations (phase 9: {ops['cg_iters1']}), residual {res:.3e}")
    print(f"[8 lane kernels] cg(tol 1e-5) on step 1's matrix through the program without bounds: "
          f"{k} iterations (phase 9's {ops['cg_iters1']}), f64 residual {res:.3e} (limit 1e-4), "
          f"{t_cg:.3f} s; launches {c}", flush=True)
    return err, c["tiled_combine"]


# where a lane kernel's launch count comes from when not from phase 9's run
LAUNCH_SOURCES = {
    "lane_gather_mul": "one apply of phase 8's 3-stage operator (no main path runs K8)",
    "tiled_combine": "phase 8's CG on step 1's program with its segment bounds dropped "
                     "(no pack builds a program without them)",
    "lane_gather_mul_t": "none: no path calls it (its reference caller is dead code)",
}

# the CUDA function of each lane kernel's wrapper in lane_gather.cu
LANE_FUNCS = {"lane_gather": "gather_kernel", "lane_gather_mul": "gather_mul_kernel",
              "lane_gather_mul_t_batched": "gather_mul_t_kernel",
              "lane_gather_sum": "gather_sum_kernel", "lane_segsum": "segsum_kernel",
              "lane_gather_mul_segsum": "gather_mul_segsum_kernel",
              "tiled_combine": "tiled_combine_kernel", "lane_gather_mul_t": "gather_mul_t_kernel"}


def lane_row(name, kern, plain, library, n_bytes, library_in_graph=True):
    """A lane kernel's times: ``ms``, ``plain_ms`` and ``library_ms`` per call
    under a CUDA graph (the card's time: these kernels take 4-130 us, where
    back-to-back eager calls are timed at the wrapper's host cost), the
    kernel's marginal event time (``event_ms``) and its device duration in a
    torch.profiler trace (``profiler_ms``). A library call that cannot be
    captured in a graph (``torch.segment_reduce`` reads its lengths back to
    the host) takes marginal events instead: ``library_in_graph=False``."""
    lib_ms = None if not library else graph_ms(library) if library_in_graph else \
        marginal_ms(library)
    row = {"ms": graph_ms(kern), "plain_ms": graph_ms(plain), "library_ms": lib_ms,
           "event_ms": marginal_ms(kern), "profiler_ms": profiled_ms(kern, LANE_FUNCS[name])}
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes)
    return row


def segsum_lengths(lo, hi):
    """K11's segments as ``torch.segment_reduce`` lengths over the flat data:
    every column run (lanes lo+1..hi of its window) one segment, the lanes
    between runs segments of their own (their sums are not read)."""
    lo_, hi_ = lo.long().cpu().numpy(), hi.long().cpu().numpy()
    base = np.arange(lo_.shape[0])[:, None] * 128
    run = hi_ >= 0
    cuts = np.unique(np.concatenate([(base + lo_ + 1)[run], (base + hi_ + 1)[run],
                                     base[:, 0], [lo_.size]]))
    return torch.from_numpy(np.diff(cuts)).to(lo.device)


def phase5_lanes(lt, LG, dev, ops, p3s, card):
    """Times of K7-K12 at step 1's and step 2's shapes (K8 at a synthetic
    shape), beside their plain versions, their bound and, for K7,
    torch.gather; and the routed apply per call. Returns {kernel: row of the
    main-path shape}."""
    p1, p2, p2t = ops["op1"].routed, ops["op2"].routed, ops["op2"].routed_t
    rows = {}

    def show(name, where, row, n_bytes):
        prof = row["profiler_ms"]
        print(f"[5 times] {name} at {where} f32: {row['ms'] * 1e3:.1f} us per call in a CUDA "
              f"graph = {n_bytes / row['ms'] / 1e6:.0f} GB/s ({n_bytes / 1e6:.1f} MB; bound "
              f"{row['bound_ms'] * 1e3:.1f} us, {row['bound_ms'] / row['ms'] * 100:.0f}% of it); "
              f"profiler {'not measured' if prof is None else f'{prof * 1e3:.1f} us'}; eager "
              f"events {row['event_ms'] * 1e3:.1f} us; plain {row['plain_ms'] * 1e3:.1f} us"
              + (f", library {row['library_ms'] * 1e3:.1f} us" if row["library_ms"] else "")
              + f"; {card}", flush=True)

    for tag, fwd, tr in (("step 1", p1, p2t), ("step 2", p2, p2t)):
        for name, (n_rows, extra) in lane_cases(fwd, tr, p3s).items():
            if name == "lane_gather_mul" or (tag == "step 1" and name == "lane_gather_mul_segsum"):
                continue  # K8 is timed below; K12 runs on step 2's transpose only
            free()
            args = extra(torch.float32)
            a = dev_vec(n_rows, dev, SEED + 60, k=128)
            kern, plain = getattr(LG, name), getattr(LG, name + "_plain")
            out = kern(a, *args)
            n_bytes = nbytes(a, out) + sum(nbytes(t) for t in args if isinstance(t, torch.Tensor))
            library = None
            if name == "lane_gather":
                idx_long = args[0].long()
                library = lambda: torch.gather(a, 1, idx_long)  # noqa: E731
            if name == "lane_segsum":  # the same segments as lengths, built beforehand
                lengths = segsum_lengths(*args)
                library = lambda: torch.segment_reduce(a.reshape(-1), "sum",  # noqa: E731
                                                       lengths=lengths)
            row = lane_row(name, lambda: kern(a, *args), lambda: plain(a, *args), library,
                           n_bytes, library_in_graph=name != "lane_segsum")
            show(name, f"{tag}'s shape ({n_rows}, 128)", row, n_bytes)
            if tag == "step 1" or name == "lane_gather_mul_segsum":
                rows[name] = row
            del a, out
    # K8 at the synthetic shape
    free()
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    idx = torch.randint(0, 128, (65536, 128), generator=g, device=dev, dtype=torch.int8)
    vals, xw = dev_vec(65536, dev, SEED + 62, k=128), dev_vec(8 * 65536, dev, SEED + 63, k=128)
    out = LG.lane_gather_mul(xw, idx, vals, rep=8)
    n_bytes = nbytes(xw, idx, vals, out)
    rows["lane_gather_mul"] = lane_row(
        "lane_gather_mul", lambda: LG.lane_gather_mul(xw, idx, vals, rep=8),
        lambda: LG.lane_gather_mul_plain(xw, idx, vals, rep=8), None, n_bytes)
    show("lane_gather_mul", "(8·65536, 128)", rows["lane_gather_mul"], n_bytes)
    del xw, vals, idx, out
    # K13 at step 1's combine shape; its yardstick is index_add_ over segment
    # ids computed beforehand (not deterministic on the card: atomics)
    free()
    T8, Kt = p1.rowid.shape
    q = dev_vec(T8 * Kt, dev, SEED + 65)
    out = LG.tiled_combine(q, p1.rowid)
    rid = p1.rowid.long()
    seg = torch.where(rid >= 0, torch.arange(T8, device=dev)[:, None] * 128 + rid,
                      T8 * 128).reshape(-1)
    n_bytes = nbytes(q, p1.rowid, out)
    rows["tiled_combine"] = lane_row(
        "tiled_combine", lambda: LG.tiled_combine(q, p1.rowid),
        lambda: LG.tiled_combine_plain(q, p1.rowid),
        lambda: torch.zeros(T8 * 128 + 1, device=dev).index_add_(0, seg, q), n_bytes)
    show("tiled_combine", f"step 1's combine ({T8} tiles x {Kt} slots)", rows["tiled_combine"],
         n_bytes)
    del q, out, rid, seg
    # K14 on one chunk of step 1
    m1 = p1.vals.shape[1]
    xw = dev_vec(m1, dev, SEED + 66, k=128)
    idx, vals = p1.lane_idx[0], p1.vals[0]
    out = LG.lane_gather_mul_t(xw, idx, vals)
    n_bytes = nbytes(xw, idx, vals, out)
    rows["lane_gather_mul_t"] = lane_row(
        "lane_gather_mul_t", lambda: LG.lane_gather_mul_t(xw, idx, vals),
        lambda: LG.lane_gather_mul_t_plain(xw, idx, vals), None, n_bytes)
    show("lane_gather_mul_t", f"one chunk of step 1 ({m1}, 128)", rows["lane_gather_mul_t"],
         n_bytes)
    del xw, out
    # the routed apply per call
    for tag, op, nnz in (("step 1 (N = T, symmetric)", ops["op1"], ops["nnz1"]),
                         ("auto_8m", ops["op2"], ops["nnz2"])):
        for mode in ("N", "T") if tag == "auto_8m" else ("N",):
            v = dev_vec(op.shape[1], dev, SEED + 64)
            LG.reset_launch_counts()
            op.apply(v, mode)
            per = {k_: c for k_, c in LG.launch_counts().items() if c}
            t, tg = marginal_ms(lambda: op.apply(v, mode)), graph_ms(lambda: op.apply(v, mode))
            print(f"[5 times] routed apply {tag} mode {mode}: {t * 1e3:.1f} us per eager call = "
                  f"{nnz / t / 1e6:.2f} Gnnz/s, {tg * 1e3:.1f} us in a CUDA graph ({tg / t * 100:.0f}% of "
                  f"eager) = {nnz / tg / 1e6:.2f} Gnnz/s; launches per apply "
                  f"{per}; {card}", flush=True)
    P, x = ops["perm"]
    for mode in ("N", "T"):
        idx = P.perm.long()
        t, tg = marginal_ms(lambda: P.apply(x, mode)), graph_ms(lambda: P.apply(x, mode))
        print(f"[5 times] opPermutation(2^20) mode {mode}: {t * 1e3:.1f} us per eager call, "
              f"{tg * 1e3:.1f} us in a CUDA graph; plain x[perm] {marginal_ms(lambda: x[idx]) * 1e3:.1f} "
              f"us eager, {graph_ms(lambda: x[idx]) * 1e3:.1f} us in a graph; {card}", flush=True)
    return rows


# ----------------------------------------------------------------------------
# Slice 4: the Krylov suite on the block algebra
# ----------------------------------------------------------------------------


def lsq_matrix(seed):
    """A rectangular least-squares matrix (scipy CSR, f32): N_LSQ_ROWS x N_AUTO8M,
    Poisson(8) uniform columns per row, normal values."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    counts = rng.poisson(8, N_LSQ_ROWS)
    nnz = int(counts.sum())
    rows = np.repeat(np.arange(N_LSQ_ROWS, dtype=np.int32), counts)
    A = sps.csr_matrix((rng.standard_normal(nnz).astype(np.float32),
                        (rows, rng.integers(0, N_AUTO8M, nnz, dtype=np.int32))),
                       shape=(N_LSQ_ROWS, N_AUTO8M))
    A.sum_duplicates()
    return A


def timed_solve(solve):
    """(result, seconds) of one solve, from the host clock around work that
    ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernel_label(key: str) -> str:
    """A device activity's short name: the first identifier followed by a
    template or argument list ("...::gather_kernel<float>(...)" ->
    "gather_kernel"), with the functor of an elementwise kernel, else the
    key's start."""
    import re

    m = re.search(r"(\w+)[<(]", key)
    if m is None:
        return key[:32]
    inner = re.search(r"(direct_copy_kernel_cuda|\w*Functor\w*|\w+_kernel_cuda)", key)
    if "elementwise" in m.group(1) and inner:
        return f"{m.group(1)}[{inner.group(1)}]"
    return m.group(1)


def device_profile(fn, top=3):
    """(device ms, the ``top`` kernels by device ms) of one call of fn, from
    a torch.profiler trace: the sum of every device activity's own time but
    ``traced``'s spins; (None, []) when the trace holds no device time."""
    _, prof = traced(fn)
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0 and kernel_label(e.key) != "spin_kernel":  # traced's own
            name = kernel_label(e.key)
            per[name] = per.get(name, 0.0) + t / 1e3
    if not per:
        return None, []
    return sum(per.values()), sorted(per.items(), key=lambda kv: -kv[1])[:top]


def kernel_symbols() -> dict:
    """kernel name -> the device function each of its launches runs once."""
    from linops_tpu_torch.kernels import (bsr_spmv, graph_cond, lane_gather, small_eigh,
                                          small_lstsq)

    return {**bsr_spmv.LAUNCH_SYMBOLS, **lane_gather.LAUNCH_SYMBOLS,
            **small_eigh.LAUNCH_SYMBOLS, **graph_cond.LAUNCH_SYMBOLS,
            **small_lstsq.LAUNCH_SYMBOLS}


def by_symbol(counts: dict) -> dict:
    """Launch counts per kernel name -> per device function (K9 and K14
    share one), the nonzero ones."""
    out = {}
    for name, c in counts.items():
        sym = kernel_symbols()[name]
        out[sym] = out.get(sym, 0) + c
    return {k: v for k, v in out.items() if v}


def traced_launches(prof) -> dict:
    """The port's kernels a torch.profiler trace ran, per device function:
    the count of each one's activities."""
    syms = set(kernel_symbols().values())
    out = {}
    for e in prof.key_averages():
        name = kernel_label(e.key)
        if name in syms:
            out[name] = out.get(name, 0) + e.count
    return {k: v for k, v in out.items() if v}


CONDITIONAL_NODE = 13  # CU_GRAPH_NODE_TYPE_CONDITIONAL


def graph_kernel_names(g) -> list:
    """The mangled name of every kernel node of a captured block's CUDA
    graph and of the bodies of its while nodes (``g.bodies``), read through
    the driver API (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``, then
    ``cuFuncGetName`` or ``cuKernelGetName``)."""
    names = []
    for graph in [g.graph.raw_cuda_graph(), *getattr(g, "bodies", ())]:
        names += graph_node_names(graph)[0]
    return names


def while_nodes_of(g) -> int:
    """The conditional nodes of a captured block's top-level graph."""
    return graph_node_names(g.graph.raw_cuda_graph())[1].get(CONDITIONAL_NODE, 0)


def graph_node_names(graph_ptr) -> tuple:
    """(the mangled names of a CUDA graph's kernel nodes, its nodes per
    ``CUgraphNodeType``) of one graph, not descending into bodies."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(rc, what):
        check(rc == 0, f"graph_kernels: {what} returned CUDA driver error {rc}")

    graph = vp(graph_ptr)
    count = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (vp * count.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    names, kinds = [], {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds[kind.value] = kinds.get(kind.value, 0) + 1
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_uint8 * 128)()  # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern at 56
        ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), params), "cuGraphKernelNodeGetParams")
        func = vp.from_buffer(params, 0).value
        kern = vp.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(kern)), "cuKernelGetName")
        names.append(name.value.decode())
    return names, kinds


def graph_kernels(g) -> dict:
    """The port's kernels a captured block holds, per device function: its
    CUDA graph's kernel nodes (``graph_kernel_names``)."""
    wanted = {f"{len(s_)}{s_}": s_ for s_ in set(kernel_symbols().values())}
    out = {}
    for mangled in graph_kernel_names(g):
        for tag, sym in wanted.items():
            if tag in mangled:
                out[sym] = out.get(sym, 0) + 1
    return out


def traced(fn, spins=SPINS):
    """(fn's result, a torch.profiler trace of one call of fn) whose window
    starts and ends with ``spins`` spin kernels (``torch.cuda._sleep``), each
    end waited for. A trace on the H100 loses some of the first device
    records of its window (2-16 in most traces), rarely some of the last:
    the spins take that loss. SPINS_LOST keeps how many of them each trace
    lost at either end (and ``trace_until`` whether it counted what was
    wanted)."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(spins):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin()
        out = fn()
        torch.cuda.synchronize()
        spin()
    dev = sorted((e.time_range.start, kernel_label(e.name)) for e in prof.events()
                 if "CUDA" in str(getattr(e, "device_type", "")))
    work = [t for t, name in dev if name != "spin_kernel"]
    seen = sum(name == "spin_kernel" for _, name in dev)
    head = min(seen, spins) if not work else sum(
        name == "spin_kernel" and t < work[0] for t, name in dev)
    SPINS_LOST.append((spins - head, spins - (seen - head), None))
    return out, prof


def trace_until(fn, want, tries=TRACE_TRIES):
    """(fn's last result, its torch.profiler trace, the port's kernels the
    traces counted per device function, the traces taken) for the first of
    up to ``tries`` traced calls of fn whose count is ``want`` (``traced``,
    with twice the last call's spins), else the most that any one trace
    counted of each kernel. A trace can lose activity records (on the H100,
    without the spins: a replay traced with 3 of its 4 K1, another with
    none) but never counts a kernel that did not run, so a kernel that one
    trace counts c times ran at least c times in that call."""
    seen = {}
    for n in range(1, tries + 1):
        out, prof = traced(fn, SPINS << (n - 1))
        got = traced_launches(prof)
        SPINS_LOST[-1] = (*SPINS_LOST[-1][:2], got == want)
        for k, c in got.items():
            seen[k] = max(seen.get(k, 0), c)
        if got == want:
            break
    TRACES_TAKEN.append((n, got == want))
    return out, prof, got if got == want else seen, n


def replay_trace(g, want, top=6):
    """(the ``top`` kernels by device µs, the port's kernels per device
    function, the traces taken) of one replay of a captured block, from a
    torch.profiler trace that counts ``want`` (``trace_until``)."""
    _, prof, got, n = trace_until(g.replay, want)
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0 and kernel_label(e.key) != "spin_kernel":
            per[kernel_label(e.key)] = per.get(kernel_label(e.key), 0.0) + t / 1e3
    return sorted(per.items(), key=lambda kv: -kv[1])[:top], got, n


def solve_line(tag, k, unit, secs, res, lim, k_p, secs_p, dx, counts, syncs, prof):
    per = secs / max(k, 1) * 1e6
    dev_ms, ranked = prof
    busy = ("device busy not measured" if dev_ms is None else
            f"device busy {dev_ms:.1f} ms of a rerun (torch.profiler; "
            f"{dev_ms / (secs * 1e3) * 100:.0f}% of the wall time above), top: "
            + ", ".join(f"{n} {ms:.1f} ms" for n, ms in ranked))
    print(f"[10 slice-4 path] {tag}: {k} {unit}, {secs:.3f} s = {per:.1f} us per {unit[:-1]} "
          f"({syncs} host reads in the solve); f64 residual {res:.3e} (limit {lim:g}); plain "
          f"pipeline {k_p} {unit} in {secs_p:.3f} s, |Δx|/|x| {dx:.2e}; launches "
          f"{ {n: c for n, c in counts.items() if c} }; {busy}", flush=True)
    return {"iters": k, "s": secs, "us_per_iter": per, "plain_iters": k_p, "plain_s": secs_p,
            "device_ms": dev_ms}


def phase10(lt, K, LG, dev, ops, laplacian_op):
    """Slice 4's path through the entry points a user calls, at the
    reference bench's sizes: GMRES and BiCGSTAB on a shifted unstructured
    operator (10a), damped LSQR on a rectangular one (10b), MINRES on a
    saddle-point block system (10c), CG with 8 right-hand sides (10d) and the
    shifted L-BFGS solves (10e). Each solve: its iterations, an f64 residual
    computed off the kernel path (scipy, or an f64 operator), the same solve
    on the plain pipeline, its kernel launches. Returns (the launches of the
    whole phase, its solve records)."""
    import scipy.sparse as sps

    from linops_tpu_torch.kernels import small_lstsq as E2
    from linops_tpu_torch.sparse.routed import routed_matvec, routed_rmatvec
    from linops_tpu_torch.utils import loop

    mods = (LG, K, E2)
    for mod in mods:
        mod.reset_launch_counts()
    totals = {name: 0 for mod in mods for name in mod.launch_counts()}
    rec = {}

    def take():
        c = {name: n for mod in mods for name, n in mod.launch_counts().items()}
        for name, n in c.items():
            totals[name] += n
        for mod in mods:
            mod.reset_launch_counts()
        return c

    def dx_of(x, x_p):
        return float(torch.linalg.vector_norm(x_p.double() - x.double())
                     / torch.linalg.vector_norm(x_p.double()))

    # --- 10a. shifted unstructured: GMRES(30) and BiCGSTAB ---------------------
    free()
    op2, A2 = ops["op2"], ops["A2"]
    n2 = A2.shape[0]
    S = lt.ShiftedOperator(op2, 8.0)
    p2 = op2.routed
    S_plain = lt.ShiftedOperator(loop_function(
        lt, n2, n2, lambda v: routed_matvec(p2, v, use_kernel=False), dtype=torch.float32), 8.0)
    b = dev_vec(n2, dev, SEED + 70)
    bh = b.double().cpu().numpy()
    S64 = A2.astype(np.float64) + 8.0 * sps.identity(n2)
    for name, run in (("gmres", lambda op: lt.gmres(op, b, tol=1e-5, restart=30, maxiter=20)),
                      ("bicgstab", lambda op: lt.bicgstab(op, b, tol=1e-5, maxiter=500))):
        take()
        (x, k, _), secs = timed_solve(lambda: run(S))
        reads = loop.stats["reads"]
        c = take()
        with small_lstsq_as(E2.small_lstsq_plain):  # GMRES's least squares: the plain SVD
            (x_p, k_p, _), secs_p = timed_solve(lambda: run(S_plain))
        check(sum(take().values()) == 0, f"10a {name}: the plain pipeline launched a kernel")
        if name == "gmres":  # the signature's first solve: one read per restart, plus one
            check(c["small_lstsq"] == k and reads <= k + 1,
                  f"10a gmres: {c['small_lstsq']} E2 launches and {reads} reads in {k} restarts")
        res = float(np.linalg.norm(bh - S64 @ x.double().cpu().numpy()) / np.linalg.norm(bh))
        dx = dx_of(x, x_p)
        check(torch.isfinite(x).all() and res <= 1e-4 and abs(k - k_p) <= 1 and dx <= 1e-3,
              f"10a {name}: {k} (plain {k_p}), residual {res:.3e}, |Δx|/|x| {dx:.2e}")
        check(c["lane_gather"] > 0 and c["lane_gather_sum"] > 0, f"10a {name} launches {c}")
        unit = "restarts" if name == "gmres" else "iterations"
        prof = device_profile(lambda: run(S))
        take()
        rec[f"10a {name}"] = solve_line(
            f"10a {name}(A + 8I), A auto_8m (n = 2^19, {A2.nnz} nnz), tol 1e-5", k, unit, secs,
            res, 1e-4, k_p, secs_p, dx, c, reads, prof)
    del S, S_plain, S64, b, x, x_p

    # --- 10b. damped LSQR on a rectangular unstructured matrix -----------------
    free()
    t0 = time.perf_counter()
    Al = lsq_matrix(SEED + 71)
    t1 = time.perf_counter()
    op_l = lt.opSparse(Al, format="auto")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(isinstance(op_l, lt.RoutedCSROperator) and op_l.routed_t is not None,
          f"10b: {type(op_l).__name__} without a derived transpose")
    pl, plt_ = op_l.routed, op_l.routed_t
    mrow, ncol = Al.shape
    L_plain = loop_function(lt, mrow, ncol, lambda v: routed_matvec(pl, v, use_kernel=False),
                            lambda u: routed_rmatvec(plt_, u, use_kernel=False),
                            dtype=torch.float32)
    b = dev_vec(mrow, dev, SEED + 72)
    bh = b.double().cpu().numpy()
    damp = 1e-3
    take()
    (x, k, _), secs = timed_solve(lambda: lt.lsqr(op_l, b, damp=damp, tol=1e-5, maxiter=500))
    reads = loop.stats["reads"]
    c = take()
    (x_p, k_p, _), secs_p = timed_solve(lambda: lt.lsqr(L_plain, b, damp=damp, tol=1e-5,
                                                        maxiter=500))
    check(sum(take().values()) == 0, "10b: the plain pipeline launched a kernel")
    A64 = Al.astype(np.float64)
    xh = x.double().cpu().numpy()
    r = bh - A64 @ xh
    res = float(np.linalg.norm(A64.T @ r - damp ** 2 * xh)
                / (sps.linalg.norm(A64) * np.linalg.norm(r)))
    dx = dx_of(x, x_p)
    check(torch.isfinite(x).all() and res <= 1e-4 and abs(k - k_p) <= 1,
          f"10b lsqr: {k} (plain {k_p}), residual {res:.3e}")
    check(c["lane_gather_mul_segsum"] > 0 and c["lane_gather_sum"] > 0, f"10b launches {c}")
    print(f"[10 slice-4 path] 10b matrix {mrow} x {ncol}, {Al.nnz} nnz (scipy {t1 - t0:.2f} s), "
          f"opSparse(format='auto') -> routed, {pl.vals.shape[0]} chunks, derived transpose, "
          f"{t2 - t1:.2f} s (host pack {op_l.pack_seconds['host']:.2f} s)", flush=True)
    prof = device_profile(lambda: lt.lsqr(op_l, b, damp=damp, tol=1e-5, maxiter=500))
    take()
    rec["10b lsqr"] = solve_line(
        f"10b lsqr(damp {damp:g}), tol 1e-5, ‖Aᵀr − damp²x‖/(‖A‖_F‖r‖)", k, "iterations", secs,
        res, 1e-4, k_p, secs_p, dx, c, reads, prof)
    del op_l, L_plain, pl, plt_, Al, A64, b, x, x_p, r

    # --- 10c. saddle-point system under MINRES ------------------------------------
    free()
    A_op, Alap = laplacian_op
    n = Alap.shape[0]
    idx = np.arange(0, n, 8)
    p = idx.size
    B = lt.opRestriction(idx, n)
    Kop = lt.vcat(lt.hcat(A_op, B.T), lt.hcat(B, lt.opZeros(p, p, dtype=torch.float32)))
    A_plain = lt.BSROperator(A_op.data, symmetric=True, backend="torch")
    K_plain = lt.vcat(lt.hcat(A_plain, B.T), lt.hcat(B, lt.opZeros(p, p, dtype=torch.float32)))
    b = dev_vec(n + p, dev, SEED + 73)
    bh = b.double().cpu().numpy()
    take()
    (x, k, _), secs = timed_solve(lambda: lt.minres(Kop, b, tol=1e-5, maxiter=2000))
    reads = loop.stats["reads"]
    c = take()
    (x_p, k_p, _), secs_p = timed_solve(lambda: lt.minres(K_plain, b, tol=1e-5, maxiter=2000))
    check(sum(take().values()) == 0, "10c: the plain backend launched a kernel")
    Bs = sps.csr_matrix((np.ones(p), (np.arange(p), idx)), shape=(p, n))
    K64 = sps.bmat([[Alap.astype(np.float64), Bs.T], [Bs, None]]).tocsr()
    res = float(np.linalg.norm(bh - K64 @ x.double().cpu().numpy()) / np.linalg.norm(bh))
    dx = dx_of(x, x_p)
    check(torch.isfinite(x).all() and res <= 1e-4 and abs(k - k_p) <= 1 and dx <= 1e-3,
          f"10c minres: {k} (plain {k_p}), residual {res:.3e}, |Δx|/|x| {dx:.2e}")
    check(c["bsr_matvec_windowed"] > 0 and c["bsr_matvec"] == 0, f"10c launches {c}")
    r0, c0 = n - 500, n - 500
    v = dev_vec(1000, dev, SEED + 74)
    pad = torch.zeros(n + p, device=dev)
    pad[c0:c0 + 1000] = v
    e_sl = rel_err(Kop[r0:r0 + 1000, c0:c0 + 1000] * v, (Kop * pad)[r0:r0 + 1000])
    check(e_sl <= 1e-6, f"10c slice: {e_sl:.2e}")
    take()
    prof = device_profile(lambda: lt.minres(Kop, b, tol=1e-5, maxiter=2000))
    take()
    rec["10c minres"] = solve_line(
        f"10c minres on [[I + L, Bᵀ], [B, 0]] ({GRID}², n = {n}, p = {p} pinned points, "
        f"{n + p} unknowns), tol 1e-5", k, "iterations", secs, res, 1e-4, k_p, secs_p, dx, c, reads,
        prof)
    print(f"[10 slice-4 path] 10c slice K[{r0}:{r0 + 1000}, {c0}:{c0 + 1000}] applied = rows of K "
          f"applied to the zero-padded vector: max|Δ|/max {e_sl:.2e} (limit 1e-6)", flush=True)
    del Kop, K_plain, A_plain, B, K64, Bs, b, x, x_p, v, pad

    # --- 10d. CG with 8 right-hand sides on the routed SPD matrix ----------------
    free()
    op1, A1 = ops["op1"], ops["A1"]
    p1 = op1.routed
    check(op1.matrix_path("N") == "routed", "10d: the matrix apply does not take the routed path")
    P_plain = loop_function(lt, N3, N3, lambda v: routed_matvec(p1, v, use_kernel=False),
                            symmetric=True, hermitian=True, dtype=torch.float32)
    Bm = dev_vec(N3, dev, SEED + 75, k=8)
    take()
    (X, k, _), secs = timed_solve(lambda: lt.cg(op1, Bm, tol=1e-5, maxiter=2000))
    reads = loop.stats["reads"]
    c = take()
    (X_p, k_p, _), secs_p = timed_solve(lambda: lt.cg(P_plain, Bm, tol=1e-5, maxiter=2000))
    check(sum(take().values()) == 0, "10d: the plain pipeline launched a kernel")
    Bh, Xh = Bm.double().cpu().numpy(), X.double().cpu().numpy()
    res_cols = np.linalg.norm(Bh - A1.astype(np.float64) @ Xh, axis=0) / np.linalg.norm(Bh, axis=0)
    dx = dx_of(X, X_p)
    check(torch.isfinite(X).all() and float(res_cols.max()) <= 1e-4 and abs(k - k_p) <= 1,
          f"10d cg: {k} (plain {k_p}), residuals {res_cols}")
    check(c["lane_gather_mul_t_batched"] > 0 and c["lane_segsum"] > 0, f"10d launches {c}")
    prof = device_profile(lambda: lt.cg(op1, Bm, tol=1e-5, maxiter=2000))
    take()
    rec["10d cg k=8"] = solve_line(
        f"10d cg with 8 right-hand sides on step 1's matrix (n = 2^20, {ops['nnz1']} nnz), "
        f"routed kernels at rep 8, tol 1e-5, worst column", k, "iterations", secs,
        float(res_cols.max()), 1e-4, k_p, secs_p, dx, c, reads, prof)
    del Bm, X, X_p, P_plain

    # --- 10e. shifted L-BFGS solves --------------------------------------------
    free()
    nq, mem = 1_000_000, 16
    g = torch.Generator(device=dev).manual_seed(SEED + 76)
    Bq = lt.LBFGSOperator(torch.float32, nq, mem=mem, device=dev)
    B64 = lt.LBFGSOperator(torch.float64, nq, mem=mem, device=dev)
    for _ in range(mem):  # the bench's pairs: y = s + 0.1·noise
        s_ = torch.randn(nq, generator=g, device=dev)
        y_ = s_ + 0.1 * torch.randn(nq, generator=g, device=dev)
        Bq.push(s_, y_)
        B64.push(s_.double(), y_.double())
    b = dev_vec(nq, dev, SEED + 77)
    sigmas = (0.1, 1.0, 10.0)
    take()
    xs = {}
    times = {}
    for sg in sigmas:
        x_c = lt.solve_shifted_system(Bq, b, sg)
        x_e = lt.solve_shifted_system(Bq, b, sg, method="ejm")
        r64 = float(torch.linalg.vector_norm(b.double() - B64 * x_c.double() - sg * x_c.double())
                    / torch.linalg.vector_norm(b.double()))
        e_e = rel_err(x_e, x_c)
        check(torch.isfinite(x_c).all() and r64 <= 1e-4 and e_e <= 1e-4,
              f"10e σ {sg}: residual {r64:.3e}, EJM {e_e:.2e}")
        xs[sg] = x_c
        times[sg] = (marginal_ms(lambda: lt.solve_shifted_system(Bq, b, sg)),
                     marginal_ms(lambda: lt.solve_shifted_system(Bq, b, sg, method="ejm")))
        dev_c = device_profile(lambda: lt.solve_shifted_system(Bq, b, sg))
        dev_e = device_profile(lambda: lt.solve_shifted_system(Bq, b, sg, method="ejm"))
        busy = ("device busy not measured" if dev_c[0] is None or dev_e[0] is None else
                f"device busy {dev_c[0] * 1e3:.1f} us compact (top: "
                + ", ".join(f"{n_} {ms * 1e3:.1f} us" for n_, ms in dev_c[1])
                + f"), {dev_e[0] * 1e3:.1f} us EJM (torch.profiler)")
        print(f"[10 slice-4 path] 10e solve_shifted_system(L-BFGS n = {nq}, mem {mem}, σ {sg:g}): "
              f"f64 residual {r64:.3e} (limit 1e-4); EJM max|Δ|/max {e_e:.2e} (limit 1e-4); card "
              f"time per solve {times[sg][0] * 1e3:.1f} us compact, {times[sg][1] * 1e3:.1f} us "
              f"EJM (eager events); {busy}", flush=True)
    X3 = lt.solve_shifted_systems(Bq, b, list(sigmas))
    e3 = max(rel_err(X3[i], xs[sg]) for i, sg in enumerate(sigmas))
    check(e3 <= 1e-4, f"10e solve_shifted_systems: {e3:.2e}")
    t3 = marginal_ms(lambda: lt.solve_shifted_systems(Bq, b, list(sigmas)))
    (x_m, k_m, _), secs_m = timed_solve(
        lambda: lt.minres(lt.ShiftedOperator(Bq, 1.0), b, tol=1e-6, maxiter=200))
    e_m = rel_err(x_m, xs[1.0])
    check(e_m <= 1e-4, f"10e minres(B + I): {k_m} iterations, {e_m:.2e} from compact")
    c = take()
    print(f"[10 slice-4 path] 10e solve_shifted_systems(σ = {list(sigmas)}): max|Δ|/max against "
          f"the single solves {e3:.2e}, {t3 * 1e3:.1f} us per call for all three (eager events); "
          f"minres(ShiftedOperator(B, 1)) {k_m} iterations in {secs_m:.3f} s, max|Δ|/max against "
          f"compact {e_m:.2e} (limit 1e-4); launches {c}", flush=True)
    rec["10e"] = {"compact_ms": {sg: t[0] for sg, t in times.items()},
                  "ejm_ms": {sg: t[1] for sg, t in times.items()}, "batched3_ms": t3,
                  "minres_iters": k_m}
    del Bq, B64, b, xs, X3, x_m
    print(f"[10 slice-4 path] launches over 10a-10e: { {n: c for n, c in totals.items() if c} }",
          flush=True)
    return totals, rec


def sync_warnings(fn) -> int:
    """How many synchronizing CUDA calls one call of fn makes: warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def replay_without_sync(g) -> None:
    """One replay of a captured block under sync-debug mode "error": it
    raises if the block holds a host synchronisation."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def median_solve(solve, reps=REPS):
    """(the last result, the median seconds) of ``reps`` timed solves."""
    runs = [timed_solve(solve) for _ in range(reps)]
    return runs[-1][0], float(np.median([t for _, t in runs]))


def loop_modes(loop, tag, solve, unit="iterations", x_rtol=0.0, why="", phase="14",
               inspect=None):
    """``solve`` (returning (x, k, res)) in the per-iteration loop (BLOCK 1,
    no capture: one read per iteration, every kernel launched from the
    host) and in graph blocks: a first solve of the signature (the plain
    loop), a second (it captures), then cached ones. Checks the same
    count and x bit for bit (or within ``x_rtol``, for ``why``), the cached
    block's recorded launches against a profiler trace of one replay, and
    one replay under sync-debug "error"; prints wall (median of REPS solves)
    and device (one profiled solve) µs per iteration, busy shares, host
    reads and syncs per solve, the first solve's, the capturing solve's
    (and its capture ms) and the cached wall time; ``inspect(g)`` may check
    the cached block further. Returns the record."""
    block = loop.BLOCK
    loop.clear_cache()
    with per_iteration(loop):
        solve()  # the allocator's blocks after free(); lazy plans
        (x1, k1, _), s1 = median_solve(solve)
        st1 = dict(loop.stats)
        d1 = device_profile(solve)[0]
    loop.clear_cache()
    (x2, k2, _), s2 = timed_solve(solve)  # the signature's first solve: the plain loop
    st2 = dict(loop.stats)
    (xc, kc, _), sc = timed_solve(solve)  # its second: captures
    stc = dict(loop.stats)
    (x3, k3, _), s3 = median_solve(solve)
    st3 = dict(loop.stats)
    syncs = sync_warnings(solve)
    d3, top3 = device_profile(solve, top=4)
    g = loop.last_graph()
    check(g is not None and st3["captures"] == 0 and st3["replays"] > 0,
          f"{phase} {tag}: the cached solve replayed no captured block: {st3}")
    held = dict(g.launches)
    nodes = graph_kernels(g)
    check(nodes == by_symbol(held), f"{phase} {tag}: the cached block's graph holds {nodes}; its "
                                    f"capture recorded {held}")
    if inspect is not None:
        inspect(g)
    in_replay, traced, tries = replay_trace(g, nodes)
    # a kernel in a while node's body runs once per inner block: a replay can
    # trace it more often than the graph holds it (or not at all when the
    # inner loop stops at once)
    bodies = len(getattr(g, "bodies", ()))
    check((traced.keys() <= nodes.keys()) if bodies else
          (traced.keys() == nodes.keys() and all(traced[s_] <= nodes[s_] for s_ in traced)),
          f"{phase} {tag}: one replay of the cached block traced {traced} ({tries} traces; the "
          f"last one's device time: {in_replay}); its graph holds {nodes}")
    names = graph_kernel_names(g)
    nccl = sum("nccl" in n_.lower() for n_ in names)  # NCCL's kernels, listed apart
    replay_without_sync(g)
    check(k1 == k2 == kc == k3, f"{phase} {tag}: {k1} {unit} per iteration, {k2} in the first "
                                f"solve, {kc} capturing, {k3} cached")
    dx = max(rel_err(x, x1) for x in (x2, xc, x3))
    same = all(torch.equal(x, x1) for x in (x2, xc, x3))
    check(same or dx <= x_rtol, f"{phase} {tag}: graph blocks differ from the per-iteration loop "
                                f"by {dx:.2e} (allowed {x_rtol:g}{': ' + why if why else ''})")
    k = max(k1, 1)
    capture_ms = st2["capture_ms"] + stc["capture_ms"]
    busy = ("device time not measured" if d1 is None or d3 is None else
            f"device {d1 * 1e3 / k:.1f} -> {d3 * 1e3 / k:.1f} us per {unit[:-1]}, busy "
            f"{d1 / (s1 * 1e3):.2f} -> {d3 / (s3 * 1e3):.2f}; cached top: "
            + ", ".join(f"{n_} {ms * 1e3 / k:.1f} us" for n_, ms in top3))
    print(f"[{phase} device loop] {tag}: {k1} {unit}; x {'bit for bit' if same else f'{dx:.2e}'}; "
          f"wall {s1 * 1e6 / k:.1f} us per {unit[:-1]} per-iteration -> {s3 * 1e6 / k:.1f} us "
          f"cached graph blocks of {block}; {busy}; host reads per solve {st1['reads']} -> "
          f"{st3['reads']} ({st3['blocks']} blocks), synchronizing calls seen in the cached solve "
          f"{syncs}; first solve {s2 * 1e3:.1f} ms ({st2['path']}, {st2['reads']} reads, "
          f"{st2['captures']} captures), second {sc * 1e3:.1f} ms incl. capture "
          f"{capture_ms:.1f} ms, cached {s3 * 1e3:.1f} ms; the graph holds {nodes} (kernel "
          f"nodes{f', with the bodies of its {while_nodes_of(g)} while nodes' if bodies else ''}; "
          f"{len(names)} kernel nodes in all, {nccl} of them NCCL's; the capture recorded "
          f"{held}), one replay traced {traced} (trace {tries} of up to {TRACE_TRIES}): "
          + ", ".join(f"{n_} {ms * 1e3:.1f} us" for n_, ms in in_replay)
          + "; replay under sync-debug error: no sync", flush=True)
    return {"iters": k1, "wall_us_per_iter": (s1 * 1e6 / k, s3 * 1e6 / k),
            "device_us_per_iter": (None if d1 is None else d1 * 1e3 / k,
                                   None if d3 is None else d3 * 1e3 / k),
            "busy": (None if d1 is None else d1 / (s1 * 1e3),
                     None if d3 is None else d3 / (s3 * 1e3)),
            "reads": (st1["reads"], st3["reads"]), "syncs_seen": syncs,
            "capture_ms": capture_ms, "first_ms": s2 * 1e3, "capturing_ms": sc * 1e3,
            "cached_ms": s3 * 1e3, "held": held, "nodes": nodes, "traced": traced,
            "in_replay": [n_ for n_, _ in in_replay], "while_nodes": while_nodes_of(g),
            "bodies": bodies, "nccl_nodes": nccl, "kernel_nodes": len(names),
            "bits": same}


def copy_us(g, tensors, new=None, reps=REPS) -> float:
    """µs of device time that refreshing a captured block's mirrors from
    ``tensors`` (the walk of the solve's operators) takes when the tensors
    ``new`` holds (all, for None) are new: the copies a solve's first replay
    makes, median of ``reps`` (each forced by marking those copies stale)."""
    m = g.mirrors
    stale = [i for i in m.index if new is None or any(tensors[i] is t for t in new)]
    times = []
    for _ in range(reps):
        for i in stale:
            m.last[i] = (lambda: None, -1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        m.refresh(tensors)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) * 1e3)
    return float(np.median(times))


def push_solve_modes(lt, loop, A, b, dev, card, rounds=10, seed=SEED + 78):
    """A quasi-Newton outer loop's traffic: an inverse L-BFGS model of A
    (mem 8, 8 pairs in); each round pushes one pair, then solves
    cg(A, b, M = the model) three ways: in the plain loop (one read per
    iteration: the model declared not capture-safe for that solve, what a
    solve after a push ran before the state was keyed by layout), in the
    default loop (the push keeps the signature: the captured block copies
    the new state in and replays), and once more in the default loop with
    no push between (a cached solve of the same graph). Checks, every round,
    the same count and x bit for bit in the plain and the default loop; from
    the third round on the default solve replays and captures nothing, and
    over all rounds the signature is captured once; one round's default
    solve makes no synchronizing call but its reads. Prints the medians, the
    per-round ratios, the state copy's µs per solve and the bytes of static
    state the cached block holds."""
    from linops_tpu_torch.qn.lbfgs import InverseLBFGSOperator

    g = torch.Generator(device=dev).manual_seed(seed)
    H = lt.InverseLBFGSOperator(torch.float32, A.nrow, mem=8, device=dev)

    def push():
        s_ = torch.randn(A.nrow, generator=g, device=dev)
        H.push(s_, A * s_)

    def solve():
        return lt.cg(A, b, M=H, tol=1e-5, maxiter=500)

    def plain():
        InverseLBFGSOperator.capture_safe = False
        try:
            return timed_solve(solve)
        finally:
            del InverseLBFGSOperator.capture_safe

    for _ in range(8):
        push()
    loop.clear_cache()
    sizes0 = lt.apply_cache_sizes()
    rec, syncs = [], None
    for r in range(rounds):
        push()
        (xp, kp, _), tp = plain()
        stp = dict(loop.stats)
        (xd, kd, _), td = timed_solve(solve)
        std = dict(loop.stats)
        (xc, kc, _), tc = timed_solve(solve)
        stc = dict(loop.stats)
        check(kp == kd == kc and torch.equal(xp, xd) and torch.equal(xp, xc)
              and stp["path"] == "per_iteration",
              f"14a push-then-solve round {r}: {kp} / {kd} / {kc} iterations, bits "
              f"{torch.equal(xp, xd)} {torch.equal(xp, xc)}, plain path {stp['path']}")
        if r >= 2:
            check(std["path"] == "graph" and std["captures"] == 0 and std["replays"] > 0
                  and std["copied_bytes"] > 0 and stc["copied_bytes"] == 0,
                  f"14a push-then-solve round {r}: the solve after the push did not replay "
                  f"over its copied state: {std}; the next: {stc}")
        if r == rounds - 1:
            syncs_cached = sync_warnings(solve)
            push()
            syncs = sync_warnings(solve)
            check(syncs == syncs_cached and loop.stats["replays"] > 0,
                  f"14a: a solve after a push made {syncs} synchronizing calls, a cached one "
                  f"{syncs_cached} ({loop.stats})")
        rec.append((tp, td, tc, kd, std, stc))
    sizes = lt.apply_cache_sizes()
    captures = sum(r_[4]["captures"] + r_[5]["captures"] for r_ in rec)
    check(captures == 1 and sizes["captures"] - sizes0["captures"] == 1,
          f"14a: {captures} captures over {rounds} push-then-solve rounds ({sizes0} -> {sizes})")
    gr = loop.last_graph()
    from linops_tpu_torch.core.base import capture_signature

    state_us = copy_us(gr, capture_signature((A, H)).tensors, new=H.state)
    tail = rec[2:]
    ms = {k_: float(np.median([r_[i] for r_ in tail])) * 1e3
          for i, k_ in ((0, "plain"), (1, "push"), (2, "cached"))}
    vs_cached = sorted(r_[1] / r_[2] for r_ in tail)
    vs_plain = sorted(r_[1] / r_[0] for r_ in tail)
    print(f"[14 device loop] 14a push then solve (slice 1's CG, inverse L-BFGS mem 8, one push "
          f"before each of {rounds} rounds, iterations {[r_[3] for r_ in rec]}): paths "
          f"{[r_[4]['path'] for r_ in rec]}, captures {[r_[4]['captures'] for r_ in rec]}, "
          f"replays {[r_[4]['replays'] for r_ in rec]}; from round 3: plain loop "
          f"{ms['plain']:.2f} ms per solve, push then replay {ms['push']:.2f} ms, cached solve "
          f"with no push {ms['cached']:.2f} ms; push-then-solve over the cached solve median "
          f"{float(np.median(vs_cached)):.3f} (range {vs_cached[0]:.3f}-{vs_cached[-1]:.3f}), "
          f"over the plain loop median {float(np.median(vs_plain)):.3f} (range "
          f"{vs_plain[0]:.3f}-{vs_plain[-1]:.3f}); state copied per solve "
          f"{rec[-1][4]['copied_bytes']} bytes in {state_us:.1f} us of device time; copies "
          f"held by the cached block {gr.static_bytes} bytes; synchronizing calls in a solve "
          f"after a push {syncs} (a cached solve's {syncs_cached}); apply_cache_sizes {sizes0} -> "
          f"{sizes}; x bit for bit the plain loop's every round; {card}", flush=True)
    return {"ms": ms, "vs_cached": vs_cached, "vs_plain": vs_plain, "copy_us": state_us,
            "static_bytes": gr.static_bytes, "captures": captures}


def sigma_rounds(lt, loop, tag, solve, update, values, card):
    """``update(v)`` then ``solve()`` (returning (x, k, res)) for each v in
    ``values``, in the default loop and in the per-iteration loop: the same
    count and x bit for bit each round; from the third round on the default
    solve replays and captures nothing. Prints the paths, captures, replays
    and times. Returns the record."""
    loop.clear_cache()
    rec = []
    for i, v in enumerate(values):
        update(v)
        (x, k, _), secs = timed_solve(solve)
        st = dict(loop.stats)
        with per_iteration(loop):
            (x1, k1, _), secs1 = timed_solve(solve)
        check(k == k1 and torch.equal(x, x1), f"{tag}, round {i}: {k} / {k1} iterations, bits "
                                              f"{torch.equal(x, x1)}")
        if i >= 2:
            check(st["path"] == "graph" and st["captures"] == 0 and st["replays"] > 0,
                  f"{tag}, round {i}: no replay across the update: {st}")
        rec.append((secs, secs1, k, st))
    ms = [float(np.median([r[i] for r in rec[2:]])) * 1e3 for i in (0, 1)]
    print(f"[14 device loop] {tag}: rounds {len(values)}, iterations {[r[2] for r in rec]}, "
          f"paths {[r[3]['path'] for r in rec]}, captures {[r[3]['captures'] for r in rec]}, "
          f"replays {[r[3]['replays'] for r in rec]}, bytes copied in "
          f"{[r[3]['copied_bytes'] for r in rec]}; from round 3 {ms[0]:.2f} ms per solve against "
          f"{ms[1]:.2f} ms in the per-iteration loop; x bit for bit the per-iteration loop's every "
          f"round; {card}", flush=True)
    return rec


def phase14(lt, K, LG, dev, card, ops, main, laplacian_op):
    """Slice 9's path: the device-resident solve loop (``utils/loop.py``).
    Slice 1's CG and each phase-10 solve run in the per-iteration loop and
    in captured graph blocks (first while capturing, then cached): the same
    count, x bit for bit, the kernels each captured block holds, one replay
    under sync-debug "error", times, busy shares, host reads. Then the
    block length on slice 1's CG, K3-K6 in captured matvec chains, K7-K13 in
    captured routed CGs, and the shifted solves and a trust-region σ-search
    with σ on the card. Returns (records, the union of the kernels the
    captured blocks held)."""
    import importlib.util

    from linops_tpu_torch.utils import loop

    rec, held = {}, {}

    def run(tag, solve, **kw):
        r = loop_modes(loop, tag, solve, **kw)
        for n_, c_ in r["held"].items():
            held[n_] = held.get(n_, 0) + c_
        rec[tag] = r
        return r

    # --- 14a. slice 1's CG, and the block length --------------------------------
    free()
    A, H, b = main["A"], main["H"], main["b"]
    run("14a slice-1 cg(D (BᵀB) D + 2I, M = inverse L-BFGS mem 8), n = 65536, tol 1e-5",
        lambda: lt.cg(A, b, M=H, tol=1e-5, maxiter=500))
    block = loop.BLOCK
    sweep = {}
    try:
        for j in (1, 2, 4, 8, 16):
            loop.BLOCK = j
            loop.clear_cache()
            for _ in range(2):  # the first solve runs the plain loop, the second captures
                lt.cg(A, b, M=H, tol=1e-5, maxiter=500)
            (_, k, _), secs = median_solve(lambda: lt.cg(A, b, M=H, tol=1e-5, maxiter=500))
            marg = [timed_solve(lambda: lt.cg(A, b, M=H, tol=0.0, maxiter=I_LONG))[1]
                    - timed_solve(lambda: lt.cg(A, b, M=H, tol=0.0, maxiter=I_SHORT))[1]
                    for _ in range(REPS)]
            sweep[j] = (secs * 1e6 / k, float(np.median(marg)) * 1e6 / (I_LONG - I_SHORT), k)
    finally:
        loop.BLOCK = block
        loop.clear_cache()
    print("[14 device loop] 14a block length on slice 1's CG (cached graphs, medians of "
          f"{REPS}): "
          + "; ".join(f"BLOCK {j}: {w:.1f} us per useful iteration at tol 1e-5 ({k} iterations, "
                      f"{-(-k // j) * j} run), {m:.1f} us marginal (tol 0, {I_LONG} − {I_SHORT})"
                      for j, (w, m, k) in sweep.items()) + f"; {card}", flush=True)
    rec["14a block sweep"] = sweep
    rec["14a push then solve"] = push_solve_modes(lt, loop, A, b, dev, card)

    # --- 14b. K3-K6 in captured matvec chains ------------------------------------
    for name in WIN_KMAX:
        free()
        op = win_operator(lt, name, torch.float32, dev, SEED + 21)
        v = torch.ones(WIN_N, device=dev)
        for mode in ("N", "T"):
            run(f"14b matvec_chain(12, mode {mode}) on the {name} operator (n = 2^22)",
                lambda: (lt.matvec_chain(op, v, 12, mode=mode), 12, None), unit="applies")
        del op, v

    # --- 14c. routed CGs: step 1 (K7, K9-K11) and its program without bounds (K13)
    free()
    op1, b1 = ops["op1"], dev_vec(N3, dev, SEED + 41)
    run("14c cg on step 1's routed matrix (n = 2^20), tol 1e-5",
        lambda: lt.cg(op1, b1, tol=1e-5, maxiter=2000))
    pf = op1.routed._replace(comb_lo=None, comb_hi=None)
    op_f = lt.RoutedCSROperator(op1.data, symmetric=True, hermitian=True, routed=pf)
    run("14c cg on step 1's program without segment bounds (K13), tol 1e-5",
        lambda: lt.cg(op_f, b1, tol=1e-5, maxiter=2000))
    del op_f, pf, b1

    # --- 14d. the phase-10 solves -----------------------------------------------
    free()
    S = lt.ShiftedOperator(ops["op2"], 8.0)
    b = dev_vec(ops["A2"].shape[0], dev, SEED + 70)
    r = run("14d 10a gmres(30) on auto_8m + 8I, tol 1e-5",
            lambda: lt.gmres(S, b, tol=1e-5, restart=30, maxiter=20), unit="restarts")
    k = r["iters"]
    check(r["reads"] == (k + 1, k) and r["syncs_seen"] <= k and r["held"].get("small_lstsq") == 1,
          f"14d gmres: {k} restarts, reads per solve {r['reads']} (per-iteration loop, cached "
          f"blocks; {k + 1} and {k} expected), {r['syncs_seen']} synchronizing calls in a cached "
          f"solve (at most its reads), the block recorded {r['held']} (one E2 a restart)")
    run("14d 10a bicgstab on auto_8m + 8I, tol 1e-5", lambda: lt.bicgstab(S, b, tol=1e-5,
                                                                          maxiter=500))
    del S, b
    free()
    op_l = lt.opSparse(lsq_matrix(SEED + 71), format="auto")
    b = dev_vec(op_l.nrow, dev, SEED + 72)
    run("14d 10b damped lsqr on the 2^20 x 2^19 routed matrix, tol 1e-5",
        lambda: lt.lsqr(op_l, b, damp=1e-3, tol=1e-5, maxiter=500))
    del op_l, b
    free()
    A_op, Alap = laplacian_op
    n = Alap.shape[0]
    idx = np.arange(0, n, 8)
    B = lt.opRestriction(idx, n)
    Kop = lt.vcat(lt.hcat(A_op, B.T), lt.hcat(B, lt.opZeros(idx.size, idx.size,
                                                            dtype=torch.float32)))
    b = dev_vec(n + idx.size, dev, SEED + 73)
    run("14d 10c minres on the saddle-point system (K3), tol 1e-5",
        lambda: lt.minres(Kop, b, tol=1e-5, maxiter=2000))
    del Kop, B, b
    free()
    Bm = dev_vec(N3, dev, SEED + 75, k=8)
    run("14d 10d cg with 8 right-hand sides on step 1's matrix, tol 1e-5",
        lambda: lt.cg(op1, Bm, tol=1e-5, maxiter=2000))
    del Bm

    # --- 14e. shifted solves and a trust-region σ-search with σ on the card --------
    free()
    nq, mem = 1_000_000, 16
    g = torch.Generator(device=dev).manual_seed(SEED + 76)
    Bq = lt.LBFGSOperator(torch.float32, nq, mem=mem, device=dev)
    for _ in range(mem):
        s_ = torch.randn(nq, generator=g, device=dev)
        Bq.push(s_, s_ + 0.1 * torch.randn(nq, generator=g, device=dev))
    b = dev_vec(nq, dev, SEED + 77)
    sig = torch.tensor(1.0, device=dev)
    x_py = {m: lt.solve_shifted_system(Bq, b, 1.0, method=m) for m in ("compact", "ejm")}
    x_dev = {m: lt.solve_shifted_system(Bq, b, sig, method=m) for m in ("compact", "ejm")}
    for m in x_py:
        check(torch.equal(x_py[m], x_dev[m]), f"14e {m}: a σ on the card changes x")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for m in ("compact", "ejm"):
            lt.solve_shifted_system(Bq, b, sig, method=m)
        lt.solve_shifted_systems(Bq, b, torch.stack([sig, 2 * sig, 4 * sig]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_py = {m: marginal_ms(lambda: lt.solve_shifted_system(Bq, b, 1.0, method=m))
            for m in ("compact", "ejm")}
    t_dev = {m: marginal_ms(lambda: lt.solve_shifted_system(Bq, b, sig, method=m))
             for m in ("compact", "ejm")}
    print(f"[14 device loop] 14e solve_shifted_system(L-BFGS n = {nq}, mem {mem}) with σ a "
          f"tensor on the card: x bit for bit the Python σ's; compact, EJM and three σ at once "
          f"run under sync-debug error with no sync; per solve (eager events) compact "
          f"{t_py['compact'] * 1e3:.1f} us (Python σ) / {t_dev['compact'] * 1e3:.1f} us (σ on "
          f"the card), EJM {t_py['ejm'] * 1e3:.1f} / {t_dev['ejm'] * 1e3:.1f} us; {card}",
          flush=True)
    rec["14e shifted"] = {"py_ms": t_py, "dev_ms": t_dev}
    spec = importlib.util.spec_from_file_location(
        "example_04", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "examples", "torch", "04_trust_region_on_device.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    radius = 0.25 * float(torch.linalg.vector_norm(lt.solve_shifted_system(Bq, b, 0.0)))

    def tr():
        p, sigma = ex.tr_subproblem(Bq, -b, radius)
        return p, loop.stats["iterations"], sigma

    r = run(f"14e trust-region σ-search (example 04's tr_subproblem) on the n = {nq} model, "
            f"radius {radius:.3g}", tr, unit="iterations")
    check(r["iters"] >= 2, f"14e: the σ-search took {r['iters']} steps")
    Sq = lt.ShiftedOperator(Bq, 1.0)
    run(f"14e minres(ShiftedOperator(B, 1)) on the n = {nq} model, tol 1e-6",
        lambda: lt.minres(Sq, b, tol=1e-6, maxiter=200))
    # state updates between solves: a new σ (set_sigma), a push into the model
    rec["14e across σ"] = sigma_rounds(
        lt, loop, f"14e minres(ShiftedOperator(B, σ)) on the n = {nq} model across σ",
        lambda: lt.minres(Sq, b, tol=1e-6, maxiter=200), Sq.set_sigma,
        (1.0, 2.0, 4.0, 8.0, 0.5, 3.0), card)

    def push_model(_):
        s_ = torch.randn(nq, generator=g, device=dev)
        Bq.push(s_, s_ + 0.1 * torch.randn(nq, generator=g, device=dev))

    rec["14e σ-search across pushes"] = sigma_rounds(
        lt, loop, f"14e trust-region σ-search (example 04) on the n = {nq} model, a push before "
        "each", tr, push_model, range(6), card)
    del Bq, Sq, b, x_py, x_dev
    free()

    # --- 14f. a nested solve: the Schur complement of 10c's saddle point ------------
    r14f, nested = phase14f(lt, loop, K, dev, card, laplacian_op, main)
    rec.update(r14f)
    rec["14f launches"] = nested
    for n_, c_ in nested.items():
        held[n_] = held.get(n_, 0) + c_

    # --- 14h. a nested GMRES: an inexact GMRES inverse preconditioning BiCGSTAB ---
    r14h, nested_gmres = phase14h(lt, loop, dev, card, ops)
    rec["14h"] = r14h
    for n_, c_ in nested_gmres.items():
        held[n_] = held.get(n_, 0) + c_
    print(f"[14 device loop] kernels held by the captured blocks: {held}", flush=True)
    return rec, held


G1_SOURCE = "linops_tpu_torch/kernels/csrc/graph_cond.cu"
# G1 has no Pallas site: it is the device half of the reference's nested
# lax.while_loop (an inner solve inside an outer solver's compiled loop)
G1_REPLACES = "linops_tpu/ops/linalg_ops.py:391"
NESTED_TOL = 2e-4  # 14f: ‖g − S x‖/‖g‖ in f64: outer tol 1e-4 plus the inner solves' error


def phase14f(lt, loop, K, dev, card, laplacian_op, main):
    """A nested solve at full size: CG on the Schur complement S = B A⁻¹ Bᵀ
    of phase 10c's saddle point (A = I + L on 1536², BSR through K3; B every
    8th point), A⁻¹ an ``opIterativeInverse(cg, tol 1e-6, maxiter 200)``,
    outer tol 1e-4, in the per-iteration loop and in captured blocks
    (``loop_modes``): outer iterations, summed inner iterations and x the
    same; a cached solve reads ⌈I/4⌉ times; its block holds one while node
    per outer iteration, K3 in their bodies; S x = g in f64 through the plain
    backend. Then the reference's small case (an inexact cg inverse, tol 1e-2,
    maxiter 10, as the preconditioner of cg) on slice 1's graph. Returns the
    records and the launches of the captured nested block."""
    from linops_tpu_torch.kernels import graph_cond as GC

    A_op, Alap = laplacian_op
    n = Alap.shape[0]
    idx = np.arange(0, n, 8)
    p = idx.size
    B = lt.opRestriction(idx, n)
    Minv = lt.opIterativeInverse(A_op, tol=1e-6, maxiter=200, solver="cg")
    S = B @ Minv @ B.T
    check(S.capture_safe, "14f: the Schur complement is not capture-safe")
    g = dev_vec(p, dev, SEED + 160)
    inner = []

    def solve():
        Minv.reset_inner_iterations()
        out = lt.cg(S, g, tol=1e-4, maxiter=200)
        inner.append(Minv.inner_iterations)
        return out

    k3 = K.LAUNCH_SYMBOLS["bsr_matvec_windowed"]
    seen = {}

    def inspect(gr):
        body = {}
        for b_ in gr.bodies:
            for name in graph_node_names(b_)[0]:
                if f"{len(k3)}{k3}" in name:
                    body[k3] = body.get(k3, 0) + 1
        seen.update(while_nodes=while_nodes_of(gr), k3_in_bodies=body.get(k3, 0),
                    launches=dict(gr.launches))
        check(seen["while_nodes"] == loop.BLOCK and len(gr.bodies) == loop.BLOCK
              and seen["k3_in_bodies"] > 0
              and gr.launches.get("while_condition", 0) == 2 * loop.BLOCK
              and gr.launches.get("bsr_matvec_windowed", 0) > 0,
              f"14f: the cached block holds {seen}")

    tag = (f"14f nested cg on S = B (I + L)⁻¹ Bᵀ ({GRID}², n = {n}, p = {p}; inner cg tol "
           "1e-6), tol 1e-4")
    GC.reset_launch_counts()
    r = loop_modes(loop, tag, solve, unit="outer iterations", inspect=inspect)
    g1_launches = GC.launch_counts()["while_condition"]
    counts = set(inner)
    check(len(counts) == 1 and min(counts) > r["iters"],
          f"14f: summed inner iterations differ between the solves: {counts}")
    check(r["reads"][1] == -(-r["iters"] // loop.BLOCK),
          f"14f: {r['reads'][1]} reads in a cached solve of {r['iters']} outer iterations")
    check(r["wall_us_per_iter"][1] < r["wall_us_per_iter"][0],
          f"14f: captured blocks {r['wall_us_per_iter'][1]:.1f} us per outer iteration, not "
          f"faster than the per-iteration loop's {r['wall_us_per_iter'][0]:.1f}")
    # S x = g in f64: A⁻¹ by the plain backend's f64 CG to 1e-12
    x, k, _ = solve()
    d = A_op.data
    A64 = lt.BSROperator(lt.BSR(d.blocks.double(), d.block_cols, d.shape), symmetric=True,
                         backend="torch")
    idx_t = torch.as_tensor(idx, device=dev)
    bt = torch.zeros(n, dtype=torch.float64, device=dev)
    bt[idx_t] = x.double()
    y, k64, _ = lt.cg(A64, bt, tol=1e-12, maxiter=1000)
    res = float(torch.linalg.vector_norm(g.double() - y[idx_t]) / torch.linalg.vector_norm(g.double()))
    check(torch.isfinite(x).all() and tuple(x.shape) == (p,) and res <= NESTED_TOL,
          f"14f: ‖g − S x‖/‖g‖ {res:.3e} in f64 (limit {NESTED_TOL:g})")
    print(f"[14 device loop] 14f nested solve: {r['iters']} outer iterations, {min(counts)} inner "
          f"iterations summed, the same in the per-iteration loop and in captured blocks, x bit "
          f"for bit; {r['while_nodes']} while nodes a block ({seen['k3_in_bodies']} K3 nodes in "
          f"their bodies; the capture recorded {seen['launches']}); wall {r['wall_us_per_iter'][0]:.1f} "
          f"-> {r['wall_us_per_iter'][1]:.1f} us per outer iteration, device "
          f"{r['device_us_per_iter'][0]} -> {r['device_us_per_iter'][1]} us, busy {r['busy'][0]} "
          f"-> {r['busy'][1]}; reads {r['reads'][0]} -> {r['reads'][1]}; ‖g − S x‖/‖g‖ {res:.2e} "
          f"in f64 (A⁻¹ by the plain f64 CG, {k64} iterations; limit {NESTED_TOL:g}); {card}",
          flush=True)
    launches = dict(seen["launches"], while_condition=g1_launches)
    del A64, y, bt, S, Minv, B, x
    free()
    # the reference's small case on slice 1's graph
    A, b = main["A"], main["b"]
    Ms = lt.opIterativeInverse(A, tol=1e-2, maxiter=10, solver="cg")
    r_s = loop_modes(loop, "14f cg on slice 1's graph, M = opIterativeInverse(cg, tol 1e-2, "
                     "maxiter 10) (the reference's test_iterative_inverse_as_preconditioner), "
                     "tol 1e-5", lambda: lt.cg(A, b, tol=1e-5, maxiter=200, M=Ms),
                     unit="outer iterations")
    check(r_s["iters"] < 200, f"14f small case: {r_s['iters']} iterations")
    del Ms
    free()
    return {"14f": r, "14f small": r_s, "inner": min(counts), "res": res}, launches


NESTED_GMRES_TOL = 1e-4  # 14h: ‖b − S x‖/‖b‖ in f64 (outer tol 1e-5, f32)


def phase14h(lt, loop, dev, card, ops):
    """A nested GMRES at 10a's size: BiCGSTAB (tol 1e-5) on S = auto_8m + 8I
    preconditioned by ``opIterativeInverse(S, tol 1e-2, maxiter 30)`` with
    ``solver="auto"``, which takes GMRES (S is not hermitian) with one
    restart of 30 per apply: the reference's pattern
    (``tests/test_linalg_ops.py:184-196``) at 10a's size. In the
    per-iteration loop and in captured blocks (``loop_modes``): outer
    iterations, summed inner restarts and x the same; a cached solve reads
    ⌈I/4⌉ times; its block holds two while nodes per outer iteration (the
    two preconditioner applies), each body one restart with E2 and G1;
    ‖b − S x‖/‖b‖ in f64 (scipy). Returns (the record, the launches of the
    captured nested block)."""
    import scipy.sparse as sps

    from linops_tpu_torch.kernels import graph_cond as GC
    from linops_tpu_torch.kernels import small_lstsq as E2

    free()
    A2 = ops["A2"]
    n2 = A2.shape[0]
    S = lt.ShiftedOperator(ops["op2"], 8.0)
    M = lt.opIterativeInverse(S, tol=1e-2, maxiter=30)
    check(M.capture_safe and M._resolved(S) == "gmres",
          f"14h: the inverse takes {M._resolved(S)}, capture-safe {M.capture_safe}")
    b = dev_vec(n2, dev, SEED + 170)
    inner = []

    def solve():
        M.reset_inner_iterations()
        out = lt.bicgstab(S, b, tol=1e-5, maxiter=200, M=M)
        inner.append(M.inner_iterations)
        return out

    seen = {}

    def inspect(gr):
        seen.update(while_nodes=while_nodes_of(gr), launches=dict(gr.launches))
        per_block = 2 * loop.BLOCK  # two preconditioner applies an iteration
        check(seen["while_nodes"] == per_block and len(gr.bodies) == per_block
              and gr.launches.get("small_lstsq", 0) == per_block
              and gr.launches.get("while_condition", 0) == 2 * per_block,
              f"14h: the cached block holds {seen}")

    tag = (f"14h nested gmres: bicgstab on auto_8m + 8I (n = 2^19, {A2.nnz} nnz), M = "
           "opIterativeInverse(tol 1e-2, maxiter 30, auto: gmres(30), one restart), tol 1e-5")
    E2.reset_launch_counts()
    GC.reset_launch_counts()
    r = loop_modes(loop, tag, solve, unit="outer iterations", inspect=inspect)
    e2_launches = E2.launch_counts()["small_lstsq"]
    counts = set(inner)
    check(len(counts) == 1 and min(counts) >= r["iters"] and e2_launches > 0,
          f"14h: summed inner restarts {counts} over the solves, {e2_launches} E2 launches")
    check(r["reads"][1] == -(-r["iters"] // loop.BLOCK),
          f"14h: {r['reads'][1]} reads in a cached solve of {r['iters']} outer iterations")
    x, _, _ = solve()
    bh = b.double().cpu().numpy()
    S64 = A2.astype(np.float64) + 8.0 * sps.identity(n2)
    res = float(np.linalg.norm(bh - S64 @ x.double().cpu().numpy()) / np.linalg.norm(bh))
    check(torch.isfinite(x).all() and tuple(x.shape) == (n2,) and res <= NESTED_GMRES_TOL,
          f"14h: ‖b − S x‖/‖b‖ {res:.3e} in f64 (limit {NESTED_GMRES_TOL:g})")
    print(f"[14 device loop] 14h nested gmres: {r['iters']} outer iterations, {min(counts)} inner "
          f"restarts summed, the same in the per-iteration loop and in captured blocks, x bit for "
          f"bit; {r['while_nodes']} while nodes a block (the capture recorded "
          f"{seen['launches']}); wall {r['wall_us_per_iter'][0]:.1f} -> "
          f"{r['wall_us_per_iter'][1]:.1f} us per outer iteration, device "
          f"{r['device_us_per_iter'][0]} -> {r['device_us_per_iter'][1]} us, busy {r['busy'][0]} "
          f"-> {r['busy'][1]}; reads {r['reads'][0]} -> {r['reads'][1]}; ‖b − S x‖/‖b‖ {res:.2e} "
          f"in f64 (limit {NESTED_GMRES_TOL:g}); E2 launches {e2_launches} over the phase; {card}",
          flush=True)
    del S, M, b, x, S64
    free()
    return dict(r, inner=min(counts), res=res, e2_launches=e2_launches), dict(seen["launches"])


FRESH_STEPS = 8  # 14g: outer steps, each with a fresh slice-1 graph
CHAIN_STEPS = 4  # 14g: outer steps, each with a fresh 2^22 window operator


def merged_stats(sts) -> dict:
    """The ``loop.stats`` of a step's solves as one: paths, captures,
    replays, capture ms and bytes copied summed, and the bytes each copied."""
    return dict(path="/".join(dict.fromkeys(s_["path"] for s_ in sts)),
                captures=sum(s_["captures"] for s_ in sts),
                replays=sum(s_["replays"] for s_ in sts),
                capture_ms=sum(s_["capture_ms"] for s_ in sts),
                copied_bytes=sum(s_["copied_bytes"] for s_ in sts),
                copied_each=[s_["copied_bytes"] for s_ in sts])


def fresh_steps(loop, tag, build, solve, steps, card, structures=1):
    """An outer loop's traffic: each step ``build(step)`` makes a fresh
    operator graph of one structure (returning the operators a solve
    reads), then ``solve(ops)`` (returning (x, k, the ``loop.stats`` of each
    loop it ran)) runs in the default loop,
    from step 3 once more on the same graph (a cached solve of one
    operator), and in the per-iteration loop (BLOCK 1, no capture). Checks
    x and the count bit for bit against the per-iteration loop every step,
    one capture for the structure (at step 2: the signature's second solve)
    and replays with no capture from step 3 on. After the capturing step the graph it
    captured with is dropped and its memory filled by tensors of the same
    sizes (NaN, and 0 for indices), which must take some of its addresses;
    the next fresh step replays over it. ``structures``: the signatures a
    step's solves make (one capture each). Returns the record."""
    from linops_tpu_torch.core.base import capture_signature

    loop.clear_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sizes0 = dict(loop.cache_sizes())
    rec, reused, info = [], None, {}
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops = build(step)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        (x, k, sts), secs = timed_solve(lambda: solve(ops))
        st = merged_stats(sts)
        (xc, kc, stc), secs_c = (timed_solve(lambda: solve(ops)) if step >= 2
                                 else ((x, k, sts), None))
        stc = merged_stats(stc)
        with per_iteration(loop):
            (x1, k1, _), secs_1 = timed_solve(lambda: solve(ops))
        check(k == kc == k1 and torch.equal(x, x1) and torch.equal(xc, x1),
              f"14g {tag} step {step}: {k} / {kc} / {k1} iterations, bits {torch.equal(x, x1)} "
              f"{torch.equal(xc, x1)} against the per-iteration loop")
        check(step < 2 or (stc["captures"] == 0 and stc["copied_bytes"] == 0),
              f"14g {tag} step {step}: a repeated solve of one graph captured or copied: {stc}")
        if step == 1:
            check(st["captures"] == structures, f"14g {tag}: step 2 did not capture: {st}")
        if step >= 2:
            check(st["path"] == "graph" and st["captures"] == 0 and st["replays"] > 0
                  and st["copied_bytes"] > 0,
                  f"14g {tag} step {step}: a fresh graph of a cached structure did not replay "
                  f"over its copied tensors: {st}")
        if step == 2:  # the last solve's block, and every block kept
            g = loop.last_graph()
            tensors = capture_signature(tuple(ops)).tensors
            blocks = [e for e in loop._CACHE.values() if isinstance(e, loop._Graph)]
            launches = {}
            for e in blocks:
                for n_, c_ in e.launches.items():
                    launches[n_] = launches.get(n_, 0) + c_
            info.update(copy_us=copy_us(g, tensors), static_bytes=g.static_bytes,
                        held_bytes=loop._held(loop._CACHE), launches=launches)
            del g, tensors, blocks
        rec.append(dict(build_ms=build_s * 1e3, ms=secs * 1e3,
                        cached_ms=None if secs_c is None else secs_c * 1e3,
                        plain_ms=secs_1 * 1e3, k=k, path=st["path"], captures=st["captures"],
                        replays=st["replays"], copied=st["copied_bytes"],
                        copied_each=st["copied_each"], capture_ms=st["capture_ms"]))
        if step == 1:  # drop the graph the block was captured with; reuse its memory
            sig = capture_signature(tuple(ops))
            ptrs = {t.data_ptr() for t in sig.tensors if t.is_cuda}
            shapes = [(t.shape, t.dtype) for t in sig.tensors if t.is_cuda]
            del sig, ops, x, xc, x1
            torch.cuda.synchronize()
            junk = [torch.full(s_, float("nan") if dt.is_floating_point else 0, dtype=dt,
                               device="cuda") for s_, dt in shapes]
            reused = len(ptrs & {t.data_ptr() for t in junk})
            check(reused > 0, f"14g {tag}: no freed address of the captured graph was reused")
        elif step == 2:
            del junk
        else:
            del ops
    sizes = dict(loop.cache_sizes())
    # a signature per structure and block length (the per-iteration runs' BLOCK 1 too)
    check(sizes["captures"] - sizes0["captures"] == structures
          and sizes["graphs"] == structures and sizes["signatures"] == 2 * structures,
          f"14g {tag}: {sizes0} -> {sizes} over {steps} fresh steps")
    tail = rec[2:]
    med = {k_: float(np.median([r_[k_] for r_ in tail])) for k_ in
           ("ms", "cached_ms", "plain_ms", "build_ms")}
    peak = torch.cuda.max_memory_allocated()
    print(f"[14 device loop] 14g {tag}: {steps} steps, a fresh graph each; iterations "
          f"{[r_['k'] for r_ in rec]}, paths {[r_['path'] for r_ in rec]}, captures "
          f"{[r_['captures'] for r_ in rec]}, replays {[r_['replays'] for r_ in rec]}; x bit for "
          f"bit the per-iteration loop's every step; a replay over the freed graph's "
          f"addresses ({reused} of them refilled) at step 3; bytes copied in per step "
          f"{[r_['copied'] for r_ in rec]} (by each solve of a step: "
          f"{[r_['copied_each'] for r_ in rec[2:]]}; {info['copy_us']:.1f} us of device "
          f"time for one operator's); capture {rec[1]['capture_ms']:.1f} ms (step 2: "
          f"{rec[1]['ms']:.2f} ms); from "
          f"step 3 median solve {med['ms']:.3f} ms, the same graph solved again (cached, no copy) "
          f"{med['cached_ms']:.3f} ms, per-iteration loop {med['plain_ms']:.3f} ms; building a "
          f"step's graph {med['build_ms']:.2f} ms; copies held by the last solve's block "
          f"{info['static_bytes']} bytes, by all {structures} blocks {info['held_bytes']} bytes "
          f"(one set of copies per operators' key, shared); "
          f"peak device memory {peak} bytes; apply_cache_sizes {sizes0} -> {sizes}; the "
          f"blocks recorded {info['launches']}; {card}", flush=True)
    return {"steps": rec, "median": med, "peak_bytes": peak, "reused": reused, **info}


def phase14g(lt, loop, K, dev, card, main):
    """Fresh operators of one structure in an outer loop (``fresh_steps``):
    slice 1's CG at n = 65536 with a fresh graph each step (new D, new
    blocks on the same BSR pattern through ``opSparse(format="bsr")``, a
    fresh inverse L-BFGS with 8 pushes: K1 and K2 replay over the copies),
    then ``matvec_chain(12)`` N and T on a fresh 2^22 banded window operator
    each step (K3 and K4), where the copy is of 4.3 GB and the T chain's
    block shares the N chain's copies. Also two slice-1 operators solved in
    turn (``alternating``) and the window operator with its copies over the
    bound (``over_the_bound``). Returns the records and the launches the
    captured blocks recorded."""
    f32 = torch.float32
    cols, sigma, b, pair_s = main["cols"], main["sigma"], main["b"], main["pair_s"]
    bm, bn, kmax = SHAPES["8x128"]

    def slice1(step):
        g = torch.Generator(device=dev).manual_seed(SEED + 300 + step)
        blocks = torch.randn((N // bm, kmax, bm, bn), generator=g, device=dev) * (kmax * bn) ** -0.5
        d = 1.0 + torch.rand(N, generator=g, device=dev)
        B = lt.opSparse(lt.BSR(blocks, cols, (N, N)), format="bsr")
        D = lt.opDiagonal(d)
        A = D @ (B.T @ B) @ D + sigma * lt.opEye(N, dtype=f32)
        H = lt.InverseLBFGSOperator(f32, N, mem=8, device=dev)
        for s in pair_s:
            H.push(s, A * s)
        return A, H

    def cg(ops):
        x, k, _ = lt.cg(ops[0], b, M=ops[1], tol=1e-5, maxiter=500)
        return x, k, [dict(loop.stats)]

    K.reset_launch_counts()
    r1 = fresh_steps(loop, "slice-1 cg(D (BᵀB) D + 2I, M = inverse L-BFGS mem 8), n = 65536, "
                     "tol 1e-5", slice1, cg, FRESH_STEPS, card)
    counts = K.launch_counts()
    check(counts["bsr_matvec"] > 0 and counts["bsr_rmatvec"] > 0
          and r1["launches"].get("bsr_matvec", 0) > 0 and r1["launches"].get("bsr_rmatvec", 0) > 0,
          f"14g: K1/K2 launches {counts}, the captured block's {r1['launches']}")
    r_alt = alternating(loop, "slice-1 cg", slice1, cg, card)
    free()
    cols_w = torch.from_numpy(win_cols("banded")).to(dev)
    v = torch.ones(WIN_N, device=dev)

    def window(step):
        g = torch.Generator(device=dev).manual_seed(SEED + 320 + step)
        blocks = torch.randn((WIN_N // 8, WIN_KMAX["banded"], 8, 128), generator=g, device=dev)
        return (lt.BSROperator(lt.BSR(blocks, cols_w, (WIN_N, WIN_N))),)

    def chains(ops):
        y = lt.matvec_chain(ops[0], v, 12, mode="N")
        st = [dict(loop.stats)]
        y = lt.matvec_chain(ops[0], y, 12, mode="T")
        return y, 24, st + [dict(loop.stats)]

    K.reset_launch_counts()
    r2 = fresh_steps(loop, "matvec_chain(12) N then T on a fresh 2^22 banded window operator",
                     window, chains, CHAIN_STEPS, card, structures=2)
    counts = K.launch_counts()
    check(counts["bsr_matvec_windowed"] > 0 and counts["bsr_rmatvec_windowed"] > 0,
          f"14g: K3/K4 launches {counts}")
    check(all(r_["copied_each"][0] > 0 and r_["copied_each"][1] == 0 for r_ in r2["steps"][2:]),
          f"14g window: the T chain copied again what the N chain's copies hold: "
          f"{[r_['copied_each'] for r_ in r2['steps']]}")
    r_bound = over_the_bound(loop, "matvec_chain(12) N then T, 2^22 window", window, chains,
                             r2["peak_bytes"], card)
    del cols_w, v
    free()
    launches = dict(r1["launches"])
    for n_, c_ in r2["launches"].items():
        launches[n_] = launches.get(n_, 0) + c_
    return {"14g slice 1": r1, "14g window": r2, "14g alternating": r_alt,
            "14g over the bound": r_bound}, launches


def alternating(loop, tag, build, solve, card, rounds=6):
    """Two operators of one structure solved in turn (X, Y, X, Y, ...), as
    an outer loop that keeps two models does: one set of copies per
    structure, so each solve copies all of its operator's tensors in. Before
    the copies existed each operator had a block of its own that replayed
    with no copy, which a cached solve of one operator (no copy) times.
    Checks x bit for bit against the per-iteration loop and the bytes
    copied; prints ms per solve in turn against the cached solve, the two
    interleaved (each round solves its operator again right after)."""
    loop.clear_cache()
    ops = [build(200), build(201)]
    for o in ops + ops:  # plain, capture, then replays
        solve(o)
    sig = loop._walk_ops(tuple(ops[0]))
    full = sum(sig.tensors[i].numel() * sig.tensors[i].element_size() for i in sig.mirrored)
    del sig
    ms, cached, copied = [], [], []
    for r in range(rounds):
        o = ops[r % 2]
        (x, k, sts), secs = timed_solve(lambda: solve(o))
        st = merged_stats(sts)
        (_, _, sts_c), secs_c = timed_solve(lambda: solve(o))  # again: no copy
        with per_iteration(loop):
            x1, k1, _ = solve(o)
        check(k == k1 and torch.equal(x, x1) and st["path"] == "graph" and st["captures"] == 0
              and merged_stats(sts_c)["copied_bytes"] == 0,
              f"14g {tag} in turn, round {r}: {k} / {k1} iterations, bits {torch.equal(x, x1)}, "
              f"{st}, again {merged_stats(sts_c)}")
        ms.append(secs * 1e3)
        cached.append(secs_c * 1e3)
        copied.append(st["copied_bytes"])
    # every tensor but those the two share (the BSR pattern's column indices)
    check(len(set(copied)) == 1 and 0 < copied[0] <= full,
          f"14g {tag} in turn: copied {copied} of {full} bytes")
    med, med_c = float(np.median(ms)), float(np.median(cached))
    print(f"[14 device loop] 14g {tag}, two operators of one structure in turn: {rounds} solves, "
          f"each copies {copied[0]} bytes in (of {full} its operators hold; {copied}); median "
          f"{med:.3f} ms a solve against {med_c:.3f} ms for the same operator solved again right "
          f"after (no copy: what each operator's own block took before the copies existed): "
          f"{med - med_c:+.3f} ms a solve; x bit for bit the per-iteration loop's; {card}",
          flush=True)
    del ops
    loop.clear_cache()
    return {"ms": ms, "cached_ms": cached, "median": med, "cached_median": med_c,
            "copied": copied[0], "held": full}


def over_the_bound(loop, tag, build, solve, peak_with_copies, card):
    """Copies over the bound at full size: ``loop.MIRROR_SHARE`` set so that
    the operator's copies (4.3 GB for the 2^22 window operator) exceed it.
    The structure is then captured in place: the second solve of one
    operator captures blocks that copy nothing and hold no copies, the third
    replays them, and a fresh operator of the structure is a new signature
    (its first solve does not replay). x bit for bit the per-iteration
    loop's every solve; prints the peak memory against the run with
    copies."""
    loop.clear_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    saved = loop.MIRROR_SHARE
    try:
        ops = build(400)
        sig = loop._walk_ops(tuple(ops))
        need = sum(sig.tensors[i].numel() * sig.tensors[i].element_size() for i in sig.mirrored)
        del sig
        total = torch.cuda.get_device_properties(0).total_memory
        loop.MIRROR_SHARE = 0.5 * need / total
        rec = []
        for r, o in enumerate((ops, ops, ops, build(401))):
            (x, k, sts), secs = timed_solve(lambda: solve(o))
            st = merged_stats(sts)
            st["static_bytes"] = sts[-1]["static_bytes"]
            with per_iteration(loop):
                x1, k1, _ = solve(o)
            check(k == k1 and torch.equal(x, x1),
                  f"14g {tag} over the bound, solve {r}: {k} / {k1} iterations, bits "
                  f"{torch.equal(x, x1)}")
            rec.append(dict(st, ms=secs * 1e3, held=loop._held(loop._CACHE)))
            del x, x1
        check(rec[1]["captures"] > 0 and rec[1]["static_bytes"] == 0 and rec[1]["held"] == 0
              and rec[2]["replays"] > 0 and rec[2]["captures"] == 0
              and rec[2]["copied_bytes"] == 0 and rec[3]["replays"] == 0,
              f"14g {tag} over the bound: {rec}")
    finally:
        loop.MIRROR_SHARE = saved
    peak = torch.cuda.max_memory_allocated()
    print(f"[14 device loop] 14g {tag}, copies over the bound (MIRROR_SHARE "
          f"{0.5 * need / total:.4f}: {need} bytes of copies against a bound of "
          f"{0.5 * need} bytes): captured in place at the second solve ({rec[1]['capture_ms']:.1f} "
          f"ms, {rec[1]['static_bytes']} bytes held), replays at the third with "
          f"{rec[2]['copied_bytes']} bytes copied ({rec[2]['ms']:.3f} ms), a fresh operator "
          f"runs {rec[3]['path']} with {rec[3]['replays']} replays ({rec[3]['ms']:.3f} ms); x bit "
          f"for bit the per-iteration loop's; peak device memory {peak} bytes against "
          f"{peak_with_copies} with copies; {card}", flush=True)
    del ops
    loop.clear_cache()
    return {"solves": rec, "need": need, "peak_bytes": peak}


def g1_check(GC, dev, card):
    """G1 (the while node's condition kernel) against its plain version: a
    while node, captured through ``loop.device_while`` inside a block, counts
    to the limit its test sets, and to 0 when started in a frozen outer
    iteration (the loop ANDs the outer mask into its test before the node, so
    G1 gets a false ``act``); the plain version's loop counts the same. Then
    its time per launch in a CUDA graph (marginal over 60 − 10 launches), the
    plain version's by marginal events, and its bound (1 byte read, the
    4-byte condition written)."""
    import ctypes

    from linops_tpu_torch.utils import loop

    err = 0
    for limit, outer in ((7, True), (0, True), (5, False), (13, True)):
        mask = torch.tensor(outer, device=dev)
        lim = torch.tensor(limit, device=dev)

        def block(*bufs):
            loop._OUTER.append(mask)
            try:
                (c,), k_ = loop.device_while(lambda s_, c_: s_[0] < c_[0],
                                             lambda s_, c_, j: (s_[0] + 1,), bufs[:1], 50,
                                             consts=bufs[1:])
            finally:
                loop._OUTER.pop()
            return c, k_

        gr = loop._Graph(block, (torch.zeros((), dtype=torch.int64, device=dev), lim), (), "g1")
        c, k_ = (int(t) for t in gr.run())
        plain = 0
        while bool(GC.while_condition_plain(torch.tensor(outer and plain < limit))):
            plain += 1
        err = max(err, abs(c - plain), abs(k_ - plain))
        del gr
    check(err == 0, f"G1: the while node counted {err} off the plain version's loop")
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    lib = GC._lib()
    body = torch.cuda.Stream(dev)

    def graph_of(launches):
        gr = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            gr.capture_begin()
            h, bg = ctypes.c_uint64(), ctypes.c_void_p()
            check(lib.linops_while_handle(side.cuda_stream, ctypes.byref(h)) == 0, "G1 handle")
            for _ in range(launches):
                GC.set_while_condition(h.value, flag)
            # the node the handle belongs to; its condition stays 0: no body run
            check(lib.linops_while_node_begin(side.cuda_stream, h.value, body.cuda_stream,
                                              ctypes.byref(bg)) == 0, "G1 node")
            with torch.cuda.stream(body):
                GC.set_while_condition(h.value, flag)
            check(lib.linops_while_node_end(body.cuda_stream) == 0, "G1 body")
            gr.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        gr.replay()
        torch.cuda.synchronize()
        return gr

    def replay_ms(gr):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        gr.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    short, long_ = graph_of(I_SHORT), graph_of(I_LONG)
    ms = float(np.median([(replay_ms(long_) - replay_ms(short)) / (I_LONG - I_SHORT)
                          for _ in range(REPS)]))
    plain_ms = marginal_ms(lambda: GC.while_condition_plain(flag))
    bound = bound_ms(1 + 4)
    print(f"[14 device loop] G1 set_while_condition_kernel: a while node counts as its plain "
          f"version's loop (max |Δcount| {err}, limits 0-13, a loop started in a frozen outer "
          f"iteration); "
          f"{ms * 1e3:.2f} us per launch in a CUDA graph (marginal {I_LONG} − {I_SHORT}), plain "
          f"version {plain_ms * 1e3:.1f} us (events); bound {bound[0] * 1e3:.6f} us "
          f"({bound[1]}); {card}", flush=True)
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound": bound}


GRID11 = 2048  # phase 11: the reference bench's stencil grid (bench.py:306-316)
N_LSR1, MEM_LSR1 = 10 ** 6, 16  # phase 11d (bench.py:363-369)
N_DENSE11 = 4096  # phase 11e: opCholesky / opLDL
GRID_SPLU = 512  # phase 11e: phase 7's Laplacian cut for the host SuperLU factor


def host_rel(got, ref) -> float:
    got = got.double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def host_ms(fn, short, long_):
    """ms per step: the median over REPS of (t(long_) - t(short)) / (long_ - short),
    each run synchronized and timed on the host clock (for loops that read
    the device every step)."""
    def run(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(k)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run(short)
    return float(np.median([(run(long_) - run(short)) / (long_ - short) for _ in range(REPS)]))


def bits_stable(fn, times=5) -> bool:
    first = fn()
    torch.cuda.synchronize()
    return all(torch.equal(first, fn()) for _ in range(times - 1))


def phase11(lt, K, LG, dev, card, ops, main):
    """Slice 6's path through the entry points a user calls, at the reference
    bench's sizes: stencil and DIA operators (11a), spectra (11b), the
    stochastic estimators (11c), L-SR1 and the diagonal quasi-Newton family
    (11d), the linear-algebra operators and checks (11e), and the fixed-order
    sums of COO/CSR/ELL, the plain K2 and the routed combine (11f). Every
    check raises; the launch counts are set to 0 before the phase and read
    after it. Returns those counts."""
    import tempfile

    from linops_tpu_torch.sparse.routed import routed_matmat, routed_rmatmat
    from linops_tpu_torch.utils import checkpoint as ckpt

    f32 = torch.float32
    LG.reset_launch_counts()
    K.reset_launch_counts()
    t_phase = time.perf_counter()

    # --- 11a. stencil and DIA at 2048² -------------------------------------------
    free()
    g = GRID11
    n = g * g
    S = lt.laplacian_2d(g, g)
    D = lt.laplacian_2d_dia(g, g)
    L1 = lt.laplacian_1d(g)
    I1 = lt.opEye(g, dtype=f32)
    Kr = lt.kron(L1, I1) + lt.kron(I1, L1)
    check(S.coeffs.is_cuda and D.diags.is_cuda and L1.diags.is_cuda, "a builder left the card")
    L64 = five_point(g)
    x = dev_vec(n, dev, SEED + 110)
    xh = x.double().cpu().numpy()
    yN, yT = L64 @ xh, L64.T @ xh
    e11a = {}
    for tag, op in (("stencil", S), ("DIA", D), ("kron", Kr)):
        e11a[f"{tag} N"] = host_rel(lt.matvec(op, x), yN)
        e11a[f"{tag} T"] = host_rel(lt.matvec(op, x, mode="T"), yT)
    check(all(e <= 1e-6 for e in e11a.values()), f"11a: the Laplacians disagree: {e11a}")
    P6 = dev_vec(n, dev, SEED + 111, k=6).t().contiguous()  # (6, n) row panel
    e11a["stencil panel"] = host_rel(S.apply_matrix_t(P6), (L64 @ P6.double().cpu().numpy().T).T)
    e11a["DIA panel"] = host_rel(D.apply_matrix_t(P6), (L64 @ P6.double().cpu().numpy().T).T)
    check(e11a["stencil panel"] <= 1e-6 and e11a["DIA panel"] <= 1e-6,
          f"11a: the row-panel applies disagree: {e11a}")
    t11a = {}
    for tag, op in (("stencil", S), ("DIA", D)):
        t11a[f"{tag} apply"] = marginal_ms(lambda: op.apply(x))
        t11a[f"{tag} panel 6"] = marginal_ms(lambda: op.apply_matrix_t(P6))
        t11a[f"{tag} 6 applies"] = marginal_ms(lambda: [op.apply(P6[i]) for i in range(6)])
    print(f"[11a stencil/DIA] 5-point Laplacian on {g}² (n = {n}, f32): "
          + ", ".join(f"{k_} {v:.2e}" for k_, v in e11a.items())
          + " (max|Δ|/max against scipy f64, limit 1e-6; kron = L1⊗I + I⊗L1); "
          + ", ".join(f"{k_} {v * 1e3:.1f} us" for k_, v in t11a.items())
          + f" (marginal CUDA events; panel 6 = apply_matrix_t of a (6, n) panel); {card}",
          flush=True)
    del P6, Kr, L1

    # --- 11b. spectra -------------------------------------------------------------
    free()
    gen = torch.Generator(device=dev)

    def lob(iters):
        gen.manual_seed(SEED + 112)
        return lt.lobpcg(S, k=2, largest=True, tol=0.0, maxiter=iters, generator=gen)

    theta, X, res, it = lob(40)
    check(it == 40 and torch.isfinite(theta).all() and torch.isfinite(X).all(),
          f"11b lobpcg: {it} iterations, finite {bool(torch.isfinite(X).all())}")
    r64, gaps = closed_form_gaps(L64, g, theta, X)
    us_lob = host_ms(lob, 5, 25) * 1e3
    print(f"[11b spectra] lobpcg(k=2, largest, basis gram, tol 0) on the {g}² stencil: θ "
          f"{[round(float(t_), 6) for t_ in theta]}, f64 residuals {[float(f'{r:.3e}') for r in r64]}, "
          f"distance to the nearest closed-form eigenvalue {[float(f'{d:.3e}') for d in gaps]} "
          f"(limit: residual + 1e-5·θ); {us_lob:.1f} us per iteration (marginal, 25 − 5 "
          f"iterations, host clock around synchronized runs); {card}", flush=True)
    del X

    bk, bc = main["blocks"], main["cols"]
    B = lt.BSROperator(lt.BSR(bk, bc, (N, N)))
    B_plain = lt.BSROperator(lt.BSR(bk, bc, (N, N)), backend="torch")
    est = {}
    for tag, op in (("kernels", B), ("torch", B_plain)):
        gen.manual_seed(SEED + 113)
        _, s, _, sres, s_it = lt.svds(op, k=4, tol=1e-4, maxiter=150, generator=gen)
        gen.manual_seed(SEED + 114)
        ne, ne_it = lt.normest(op, tol=1e-6, maxiter=300, generator=gen)
        gen.manual_seed(SEED + 115)
        eo, ok = lt.estimate_opnorm(op, rtol=1e-3, generator=gen)
        est[tag] = {"svds": float(s[0]), "normest": ne, "opnorm": eo, "svds_it": s_it,
                    "normest_it": ne_it, "opnorm_ok": ok, "svds_res": float(sres[0])}
    kk = est["kernels"]
    vals = [kk["svds"], kk["normest"], kk["opnorm"]]
    spread = (max(vals) - min(vals)) / max(vals)
    check(kk["opnorm_ok"] and np.isfinite(vals).all() and spread <= 1e-2,
          f"11b: the estimates of ‖B‖₂ disagree: {kk}")
    dev_t = max(abs(est["kernels"][k_] - est["torch"][k_]) / est["torch"][k_]
                for k_ in ("svds", "normest", "opnorm"))
    check(dev_t <= 1e-3, f"11b: kernels and backend='torch' disagree: {est}")
    print(f"[11b spectra] ‖B‖₂ of phase 4's BSR B (8x128, n = {N}): svds(k=4, tol 1e-4) "
          f"{kk['svds']:.6f} ({kk['svds_it']} iterations, residual {kk['svds_res']:.2e}), normest "
          f"(tol 1e-6) {kk['normest']:.6f} ({kk['normest_it']} iterations), estimate_opnorm "
          f"(rtol 1e-3) {kk['opnorm']:.6f}: spread {spread:.2e} (limit 1e-2); backend='torch' "
          f"within {dev_t:.2e} (limit 1e-3)", flush=True)

    op2 = ops["op2"]
    check(op2.matrix_path("N") == "routed" and op2.matrix_path("H") == "routed",
          f"11b rsvd: the matrix applies take {op2.matrix_path('N')}/{op2.matrix_path('H')}")
    p2, p2t = op2.routed, op2.routed_t

    class PlainRouted(lt.FunctionOperator):
        def apply_matrix(self, M, mode="N"):
            if mode == "N":
                return routed_matmat(p2, M, use_kernel=False)
            return routed_rmatmat(p2t, M, use_kernel=False)

    n2 = op2.nrow
    plain2 = PlainRouted(n2, n2, lambda v: None, dtype=f32)
    svals = {}
    for tag, op in (("kernels", op2), ("plain", plain2)):
        gen.manual_seed(SEED + 116)
        launches0 = sum(LG.launch_counts().values())
        _, s, _ = lt.rsvd(op, 4, oversample=4, power_iters=1, generator=gen)
        svals[tag] = s.double().cpu().numpy()
        if tag == "plain":
            check(sum(LG.launch_counts().values()) == launches0,
                  "11b rsvd: the plain pipeline launched a kernel")
    ds = float(np.abs(svals["kernels"] - svals["plain"]).max() / svals["plain"].max())
    check(np.isfinite(svals["kernels"]).all() and ds <= 1e-4,
          f"11b rsvd: σ {svals['kernels']} against plain {svals['plain']}: {ds:.2e}")
    print(f"[11b spectra] rsvd(k=4, oversample 4, power_iters 1) on auto_8m (n = 2^19, routed, "
          f"matrix path {op2.matrix_path('N')}): σ {[round(float(v), 5) for v in svals['kernels']]}, "
          f"plain pipeline within {ds:.2e} (limit 1e-4)", flush=True)

    # --- 11c. estimators on I + L over the 2048² stencil, exact truth ------------
    free()
    A11 = S + lt.opEye(n, dtype=f32)
    check(A11.hermitian, "I + L is not flagged hermitian")
    gen.manual_seed(SEED + 117)
    tr, tr_se = lt.estimate_trace(A11, probes=36, generator=gen)
    check(abs(tr - 5 * n) < 6 * tr_se, f"11c trace {tr} against {5 * n}, stderr {tr_se}")
    kd = 64
    gen.manual_seed(SEED + 118)
    dg, dg_se = lt.estimate_diagonal(A11, probes=kd, generator=gen)
    d_err = float((dg.double() - 5.0).abs().max())
    d_lim = 6 * (4.0 / kd) ** 0.5  # six exact standard errors: four unit neighbours a row
    over = int(((dg.double() - 5.0).abs() > 6 * dg_se.double()).sum())
    check(d_err <= d_lim, f"11c diagonal: max|Δ| {d_err:.3f} > {d_lim:.3f}")
    lam64 = 1.0 + laplacian_eigenvalues(g)
    ld_true = float(np.sum(np.log(lam64)))
    gen.manual_seed(SEED + 119)
    ld, ld_se = lt.estimate_logdet(A11, probes=16, lanczos_steps=30, generator=gen)
    check(abs(ld - ld_true) < 6 * ld_se, f"11c logdet {ld} against {ld_true}, stderr {ld_se}")
    print(f"[11c estimators] I + L on {g}²: trace {tr:.1f} against 5n = {5 * n} (stderr "
          f"{tr_se:.1f}, limit 6 stderr), diagonal max|Δ| from 5 {d_err:.3f} over {kd} probes "
          f"(limit 6·sqrt(4/{kd}) = {d_lim:.3f}; {over} of {n} entries beyond 6 estimated "
          f"stderr), logdet {ld:.1f} against {ld_true:.1f} (stderr {ld_se:.1f}, limit 6 stderr)",
          flush=True)
    del A11, dg, dg_se

    A4, A4p, b4 = main["A"], main["A_plain"], main["b"]
    herm = {tag: loop_function(lt, N, N, op.apply, symmetric=True, hermitian=True, dtype=f32)
            for tag, op in (("kernels", A4), ("torch", A4p))}
    b_unit = b4 / torch.linalg.vector_norm(b4)
    fe = {tag: lt.funm_apply(op, lambda t: torch.exp(-t), b_unit, lanczos_steps=30)
          for tag, op in herm.items()}
    e_funm = rel_err(fe["kernels"], fe["torch"])
    check(torch.isfinite(fe["kernels"]).all() and e_funm <= 1e-4,
          f"11c funm_apply: kernels against backend='torch' {e_funm:.2e}")
    print(f"[11c estimators] funm_apply(exp(−A), b), A phase 4's graph (K1/K2 in its Lanczos "
          f"applies), 30 steps: kernels against backend='torch' {e_funm:.2e} (limit 1e-4)",
          flush=True)

    # --- 11d. quasi-Newton at n = 10^6, mem 16 -------------------------------------
    free()
    nq = N_LSR1
    Bq = lt.LSR1Operator(f32, nq, mem=MEM_LSR1, scaling=True)
    gq = torch.Generator(device=dev).manual_seed(SEED + 120)
    pairs = []
    for _ in range(MEM_LSR1 + 2):
        s = torch.randn(nq, generator=gq, device=dev)
        y = 2.0 * s + 0.5 * torch.randn(nq, generator=gq, device=dev)
        pairs.append((s, y))
        Bq.push(s, y)
    # the ring holds the newest MEM_LSR1 pairs, oldest at the insert slot
    held = pairs[-MEM_LSR1:]
    ins = int(Bq.state.insert)
    check(all(torch.equal(Bq.state.S[(ins + i) % MEM_LSR1], s) and
              torch.equal(Bq.state.Y[(ins + i) % MEM_LSR1], y) for i, (s, y) in enumerate(held)),
          "11d L-SR1: the memory does not hold the newest pairs in push order")
    v = torch.randn(nq, generator=gq, device=dev)
    e_lsr1 = rel_err(Bq * v, sr1_apply_recursive(held, v))
    check(e_lsr1 <= 1e-5, f"11d L-SR1: apply against the f64 SR1 recursion {e_lsr1:.2e}")
    ms_lsr1 = marginal_ms(lambda: Bq.apply(v))
    e_dqn = {}
    for cls in ("DiagonalPSB", "DiagonalAndrei", "DiagonalBFGS", "SpectralGradient"):
        if cls == "SpectralGradient":
            op_ = lt.SpectralGradient(1.0, nq, dtype=f32)
        else:
            op_ = getattr(lt, cls)(torch.ones(nq, device=dev))
        for s, y in pairs[:3]:
            op_.push(s, y)
        want = diagonal_qn_recursive(cls, pairs[:3], torch.ones(nq, device=dev))
        e_dqn[cls] = rel_err(op_.diag(), want)
    check(all(e <= 1e-5 for e in e_dqn.values()),
          f"11d diagonal QN against the f64 closed forms: {e_dqn}")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        H = main["H"]
        for tag, op, fresh in (
                ("L-SR1", Bq, lambda: lt.LSR1Operator(f32, nq, mem=MEM_LSR1, scaling=True)),
                ("L-BFGS", H, lambda: lt.InverseLBFGSOperator(f32, N, mem=8))):
            path = os.path.join(tmp, "op.npz")
            lt.save_operator(path, op)
            back = lt.load_operator_state(path, fresh())
            a, _ = ckpt._walk(op, [], [])
            b_, _ = ckpt._walk(back, [], [])
            check(len(a) == len(b_) and all(torch.equal(p, q) for p, q in zip(a, b_)),
                  f"11d: the {tag} checkpoint does not reload bit-identical")
    print(f"[11d quasi-Newton] L-SR1 n = 10^6, mem {MEM_LSR1}, y = 2s + 0.5·noise, scaling: "
          f"apply against the f64 SR1 recursion over the held pairs {e_lsr1:.2e} (limit 1e-5), "
          f"{ms_lsr1 * 1e3:.1f} us per apply (marginal CUDA events); diagonal QN after 3 pushes "
          "against the f64 closed forms: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in e_dqn.items())
          + " (limit 1e-5); L-SR1 and phase 4's inverse L-BFGS reload bit-identical from "
          f"save_operator; {card}", flush=True)
    del Bq, held, pairs

    # --- 11e. linear-algebra operators --------------------------------------------
    free()
    gd = torch.Generator(device=dev).manual_seed(SEED + 121)
    G = torch.randn(N_DENSE11, N_DENSE11, generator=gd, device=dev)
    M = G @ G.T / N_DENSE11 + torch.eye(N_DENSE11, device=dev)
    bd = torch.randn(N_DENSE11, generator=gd, device=dev)
    res_d = {}
    for tag, op in (("cholesky", lt.opCholesky(M)), ("ldl", lt.opLDL(M))):
        xd = op * bd
        res_d[tag] = float(torch.linalg.vector_norm(M.double() @ xd.double() - bd.double())
                           / torch.linalg.vector_norm(bd.double()))
    check(all(r <= 1e-4 for r in res_d.values()), f"11e dense solves: {res_d}")
    Ch = lt.opCholesky(M)
    checks = {"check_hermitian(opCholesky)": lt.check_hermitian(Ch, generator=gd),
              "check_positive_definite(opCholesky)": lt.check_positive_definite(Ch, generator=gd),
              "check_ctranspose(B)": lt.check_ctranspose(B, generator=gd),
              "check_hermitian(stencil)": lt.check_hermitian(S, generator=gd)}
    check(all(checks.values()), f"11e checks: {checks}")
    del G, M, Ch

    inv = lt.opIterativeInverse(A4, tol=1e-5, maxiter=500, solver="cg")
    xi, ki, _ = inv.solve_info(b4)
    xc, kc, _ = lt.cg(A4, b4, tol=1e-5, maxiter=500)
    dxi = rel_err(inv * b4, xc)
    check(abs(ki - kc) <= 1 and dxi <= 1e-4,
          f"11e opIterativeInverse: {ki} iterations against cg's {kc}, |Δx| {dxi:.2e}")

    Lc = laplacian(GRID_SPLU)
    t0 = time.perf_counter()
    Si = lt.opSparseInverse(Lc)
    t_lu = time.perf_counter() - t0
    bs = dev_vec(GRID_SPLU ** 2, dev, SEED + 122)
    xs = Si * bs
    check(xs.is_cuda, "opSparseInverse did not return to the card")
    bsh = bs.double().cpu().numpy()
    res_s = float(np.linalg.norm(Lc.astype(np.float64) @ xs.double().cpu().numpy() - bsh)
                  / np.linalg.norm(bsh))
    check(res_s <= 1e-5, f"11e opSparseInverse residual {res_s:.3e}")

    Tm = lt.TimedOperator(B)
    B.reset_counters()
    xb = dev_vec(N, dev, SEED + 123)
    for _ in range(5):
        Tm.matvec(xb)
    for _ in range(3):
        Tm.matvec(xb, mode="T")
    tm = Tm.timings
    check(tm["prod"][0] == 5 and tm["tprod"][0] == 3 and B.nprod == 5 and B.ntprod == 3
          and tm["prod"][1] > 0 and tm["tprod"][1] > 0, f"11e TimedOperator: {tm}")
    print(f"[11e linalg] opCholesky / opLDL of a {N_DENSE11}² SPD f32 matrix: residuals "
          f"{res_d['cholesky']:.2e} / {res_d['ldl']:.2e} (limit 1e-4); opIterativeInverse(cg, tol "
          f"1e-5) on phase 4's graph: {ki} iterations, cg {kc}, |Δx|/max {dxi:.2e}; "
          f"opSparseInverse of I + L on {GRID_SPLU}² (phase 7's operator cut from 1536², SuperLU "
          f"on the host, factor {t_lu:.2f} s): residual {res_s:.2e} (limit 1e-5); TimedOperator(B): "
          f"5 prod {tm['prod'][1] * 1e6 / 5:.1f} us, 3 tprod {tm['tprod'][1] * 1e6 / 3:.1f} us per "
          f"apply (CUDA events, one wait each); checks {checks}; {card}", flush=True)

    # --- 11f. fixed-order sums: bit-identical reruns, and the CSR apply's cost -----
    free()
    A1 = ops["A1"]
    csr = lt.opSparse(A1, format="csr")
    d1 = csr.data
    v1 = dev_vec(N3, dev, SEED + 124)
    V1 = dev_vec(N3, dev, SEED + 125, k=4)

    def atomic(transpose):  # the apply before the fixed-order sums
        rows, cols = (d1.cols, d1.rows) if transpose else (d1.rows, d1.cols)
        contrib = d1.vals * v1[cols.long()]
        return torch.zeros(N3, dtype=contrib.dtype, device=dev).index_add_(0, rows.long(),
                                                                          contrib)

    stable = {"CSR N": bits_stable(lambda: csr * v1), "CSR T": bits_stable(lambda: csr.T * v1),
              "CSR N k=4": bits_stable(lambda: csr.matmat(V1)),
              "CSR T k=4": bits_stable(lambda: csr.matmat(V1, mode="T"))}
    e_csr = rel_err(csr * v1, atomic(False))
    bk64, u64 = bk.double(), torch.randn((N // 8, 8), dtype=torch.float64, device=dev)
    stable["plain K2 f64"] = bits_stable(lambda: K.bsr_rmatvec_plain(bk64, bc, u64, N // 128))
    idx = torch.randint(0, 4096, (1 << 20,), device=dev)
    R = lt.opRestriction(idx, 4096)
    stable["restriction T"] = bits_stable(lambda: R.T * v1)
    p1 = ops["op1"].routed
    q64 = torch.randn(p1.rowid.numel() * 2, dtype=torch.float64, device=dev)
    stable["f64 routed combine"] = bits_stable(lambda: LG.tiled_combine_plain(q64, p1.rowid, 2))
    check(all(stable.values()), f"11f: a fixed-order sum changed its bits on rerun: {stable}")
    atomic_stable = bits_stable(lambda: atomic(True))
    t11f = {"CSR N": marginal_ms(lambda: csr.apply(v1)),
            "CSR T": marginal_ms(lambda: csr.apply(v1, "T")),
            "index_add_ N": marginal_ms(lambda: atomic(False)),
            "index_add_ T": marginal_ms(lambda: atomic(True))}
    print(f"[11f fixed-order sums] bit-identical over 5 reruns: {stable}; CSR n = 2^20 "
          f"({A1.nnz} nnz) against the index_add_ apply {e_csr:.2e}; the index_add_ transpose "
          f"bit-identical over 5 reruns: {atomic_stable}; "
          + ", ".join(f"{k_} {v_ * 1e3:.1f} us" for k_, v_ in t11f.items())
          + f" (marginal CUDA events); {card}", flush=True)
    del csr, d1, V1, bk64

    counts = {**LG.launch_counts(), **K.launch_counts()}
    for name in ("bsr_matvec", "bsr_rmatvec", "lane_gather", "lane_gather_mul_t_batched",
                 "lane_gather_sum", "lane_segsum", "lane_gather_mul_segsum"):
        check(counts[name] > 0, f"{name} never ran on the slice-6 path: {counts}")
    print(f"[11 slice-6 path] launches {counts}; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, {"stencil_us_per_apply": t11a["stencil apply"] * 1e3,
                    "lobpcg_us_per_iter_k2": us_lob, "lsr1_fwd_us": ms_lsr1 * 1e3,
                    "spectra": est["kernels"]}


# ----------------------------------------------------------------------------
# Slice 7: gradients through the kernels
# ----------------------------------------------------------------------------

GRAD_X_RTOL, GRAD_BLOCKS_RTOL, GRAD_BF16_RTOL = 1e-5, 1e-6, 1e-2
IMPLICIT_RTOL = 1e-4


def rel_vec(a, b) -> float:
    """‖a − b‖/‖b‖ in f64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase12(lt, K, LG, dev, card):
    """Slice 7's path: gradients through the kernel-backed applies, taken
    with ``torch.autograd`` as a user takes them. (a) K1/K2 under L = ½‖Ax −
    b‖² on phase 3's 8x128 operator, modes N and T, f32 and bf16 blocks, and
    a mixed graph; (b) K3-K6 at n = 2^22; (c) the routed 2^20 x 2^19 matrix
    of phase 10b, a 2^20 permutation and the routed values' gradients; (f)
    vmap over K1/K2 and the routed apply; (g) vmap(cg); (d) the implicit
    backward of opIterativeInverse on slice 1's graph; (e) apply_linear.
    Returns (the backward launches per kernel, the times)."""
    from linops_tpu_torch.sparse.routed import routed_matvec

    f32 = torch.float32
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    LG.reset_launch_counts()
    backward = dict.fromkeys(list(K.launch_counts()) + list(LG.launch_counts()), 0)

    def counts():
        return {**K.launch_counts(), **LG.launch_counts()}

    def reset():
        K.reset_launch_counts()
        LG.reset_launch_counts()

    def grad_launches(fn):
        """fn() with the counts set to 0 just before and read just after;
        they are added to the phase's backward launches."""
        reset()
        out = fn()
        torch.cuda.synchronize()
        c = counts()
        for k_, v_ in c.items():
            backward[k_] += v_
        return out, {k_: v_ for k_, v_ in c.items() if v_}

    # --- 12a. K1/K2 under autograd ---------------------------------------------
    free()
    bm, bn, kmax = SHAPES["8x128"]
    times = {}
    for dtype in (f32, torch.bfloat16):
        blocks, cols = make_bsr("8x128", dtype, dev, scale=(kmax * bn) ** -0.5)
        leaf = blocks.clone().requires_grad_(True)
        op = lt.BSROperator(lt.BSR(leaf, cols, (N, N)))
        op_plain = lt.BSROperator(lt.BSR(leaf, cols, (N, N)), backend="torch")
        b = dev_vec(N, dev, SEED + 90)
        for mode in ("N", "T"):
            fwd_k, bwd_k = ("bsr_matvec", "bsr_rmatvec")[::1 if mode == "N" else -1]

            def loss(o, x_, m=mode):
                r = (o @ x_ if m == "N" else o.T @ x_) - b
                return 0.5 * torch.dot(r, r)

            x = dev_vec(N, dev, SEED + 91).requires_grad_(True)
            reset()
            L = loss(op, x)
            torch.cuda.synchronize()
            c_fwd = {k_: v_ for k_, v_ in counts().items() if v_}
            (gx, gB), c_bwd = grad_launches(lambda: torch.autograd.grad(L, (x, leaf)))
            check(c_fwd == {fwd_k: 1} and c_bwd == {bwd_k: 1},
                  f"12a {mode} {dtype}: forward launches {c_fwd}, backward {c_bwd}")
            with torch.no_grad():
                xd = x.detach()
                r = (op @ xd if mode == "N" else op.T @ xd) - b
                explicit = op.T @ r if mode == "N" else op @ r
            check(torch.equal(gx, explicit),
                  f"12a {mode} {dtype}: the x-gradient is not the explicit adjoint apply bit for bit")
            gx_p, gB_p = torch.autograd.grad(loss(op_plain, x), (x, leaf))
            e_x, e_b = rel_err(gx, gx_p), rel_err(gB, gB_p)
            lim_b = GRAD_BLOCKS_RTOL if dtype == f32 else GRAD_BF16_RTOL
            check(gB.dtype == dtype and gx.dtype == f32 and torch.isfinite(gB).all(),
                  f"12a {mode} {dtype}: gradient dtypes {gx.dtype}, {gB.dtype}")
            check(e_x <= GRAD_X_RTOL and e_b <= lim_b,
                  f"12a {mode} {dtype}: against the plain backend x {e_x:.2e}, blocks {e_b:.2e}")
            print(f"[12a K1/K2 grads] L = ½‖{'A' if mode == 'N' else 'Aᵀ'}x − b‖², 8x128 kmax 8, "
                  f"n = {N}, blocks {str(dtype)[6:]}: x-gradient = explicit "
                  f"{'Aᵀ(Ax − b)' if mode == 'N' else 'A(Aᵀx − b)'} bit for bit; against the plain "
                  f"backend's autograd x {e_x:.2e} (limit {GRAD_X_RTOL:g}), blocks {e_b:.2e} (limit "
                  f"{lim_b:g}, max|Δ|/max); launches forward {c_fwd}, backward {c_bwd}", flush=True)
            if dtype == f32 and mode == "N":
                # x alone on an operator whose blocks want no gradient
                op_x, xg = lt.BSROperator(lt.BSR(blocks, cols, (N, N))), x
                times["12a forward"] = marginal_ms(lambda: loss(op_x, xg))
                times["12a forward + x-backward"] = marginal_ms(
                    lambda: torch.autograd.grad(loss(op_x, xg), xg))
                times["12a forward + x and blocks backward"] = marginal_ms(
                    lambda: torch.autograd.grad(loss(op, xg), (xg, leaf)))
                xd = xg.detach()
                times["12a explicit Aᵀ(Ax − b)"] = marginal_ms(lambda: op_x.T @ (op_x @ xd - b))
                # the card's share: device time of 20 calls from a profiler trace
                for key, fn in (("forward", lambda: loss(op_x, xg)),
                                ("forward + x-backward",
                                 lambda: torch.autograd.grad(loss(op_x, xg), xg)),
                                ("forward + x and blocks backward",
                                 lambda: torch.autograd.grad(loss(op, xg), (xg, leaf)))):
                    dev_ms, _ = device_profile(lambda f=fn: [f() for _ in range(20)])
                    times[f"12a device {key}"] = None if dev_ms is None else dev_ms / 20
                del op_x
            del gx, gB, gx_p, gB_p, L, explicit, r, x
        if dtype == f32:  # a mixed graph: the kernel's share and the diagonal's
            d = torch.linspace(1.0, 2.0, N, device=dev)
            x = dev_vec(N, dev, SEED + 92).requires_grad_(True)
            g = dev_vec(N, dev, SEED + 93)
            y = (op + lt.opDiagonal(d)) @ x
            (gx,), c_mix = grad_launches(lambda: torch.autograd.grad(y, x, g))
            with torch.no_grad():
                want = op.T @ g + d * g
            e_mix = rel_err(gx, want)
            check(e_mix <= 1e-6 and c_mix == {"bsr_rmatvec": 1},
                  f"12a mixed graph: {e_mix:.2e} from Aᵀg + d⊙g, launches {c_mix}")
            print(f"[12a K1/K2 grads] (A + opDiagonal(d)) @ x: x-gradient against Aᵀg + d⊙g "
                  f"{e_mix:.2e} (limit 1e-6); backward launches {c_mix}", flush=True)
            del x, g, y, gx, want
        del blocks, cols, leaf, op, op_plain, b
    t = times

    def us(key):
        return "not measured" if t[key] is None else f"{t[key] * 1e3:.1f} us"

    print(f"[12a K1/K2 grads] times, 8x128 f32 N, per call (marginal CUDA events; device time "
          f"from a torch.profiler trace of 20 calls): forward {us('12a forward')} (device "
          f"{us('12a device forward')}), forward + x-backward {us('12a forward + x-backward')} "
          f"(device {us('12a device forward + x-backward')}), forward + x and blocks backward "
          f"{us('12a forward + x and blocks backward')} (device "
          f"{us('12a device forward + x and blocks backward')}); the same without autograd, "
          f"explicit Aᵀ(Ax − b): {us('12a explicit Aᵀ(Ax − b)')}; {card}", flush=True)

    # --- 12b. the windowed kernels ------------------------------------------------
    for name in WIN_KMAX:
        free()
        op = win_operator(lt, name, f32, dev, SEED + 10)
        fwd_k, tr_k = win_names(op)
        u = dev_vec(WIN_N, dev, SEED + 94)
        for mode, want_k in (("N", tr_k), ("T", fwd_k)):
            x = dev_vec(WIN_N, dev, SEED + 95).requires_grad_(True)
            y = op @ x if mode == "N" else op.T @ x
            (gx,), c_bwd = grad_launches(lambda: torch.autograd.grad(y, x, u))
            with torch.no_grad():
                explicit = op.T @ u if mode == "N" else op @ u
            check(torch.equal(gx, explicit) and c_bwd == {want_k: 1},
                  f"12b {name} {mode}: equal to the explicit apply {torch.equal(gx, explicit)}, "
                  f"backward launches {c_bwd}")
            print(f"[12b window grads] {name} n = 2^22, y = {'A' if mode == 'N' else 'Aᵀ'}x: "
                  f"x-gradient = the explicit {'Aᵀ' if mode == 'N' else 'A'}g bit for bit; backward "
                  f"launches {c_bwd}", flush=True)
            del x, y, gx, explicit
        del op, u

    # --- 12c. routed ----------------------------------------------------------------
    free()
    Al = lsq_matrix(SEED + 71)
    op_l = lt.opSparse(Al, format="auto")
    check(isinstance(op_l, lt.RoutedCSROperator) and op_l.routed_t is not None,
          "12c: not a routed operator with a derived transpose")
    mrow, ncol = Al.shape
    b = dev_vec(mrow, dev, SEED + 96)
    x = dev_vec(ncol, dev, SEED + 97).requires_grad_(True)
    r = op_l @ x - b
    (gx,), c_bwd = grad_launches(lambda: torch.autograd.grad(0.5 * torch.dot(r, r), x))
    with torch.no_grad():
        explicit = op_l.T @ (op_l @ x.detach() - b)
    r_p = routed_matvec(op_l.routed, x, use_kernel=False) - b
    (gx_p,) = torch.autograd.grad(0.5 * torch.dot(r_p, r_p), x)
    e_l = rel_err(gx, gx_p)
    check(torch.equal(gx, explicit), "12c: the routed x-gradient is not Aᵀ(Ax − b) bit for bit")
    check(e_l <= GRAD_X_RTOL, f"12c: routed x-gradient against the plain pipeline {e_l:.2e}")
    check(c_bwd.get("lane_gather_mul_segsum") == 1 and c_bwd.get("lane_gather", 0) > 0
          and "lane_gather_mul_t_batched" not in c_bwd and "lane_gather_sum" not in c_bwd,
          f"12c: backward launches {c_bwd}")
    print(f"[12c routed grads] {mrow} x {ncol}, {Al.nnz} nnz, derived transpose: x-gradient of "
          f"½‖Ax − b‖² = explicit Aᵀ(Ax − b) bit for bit, against the plain pipeline's autograd "
          f"{e_l:.2e} (limit {GRAD_X_RTOL:g}); backward launches {c_bwd}", flush=True)
    del b, x, r, gx, explicit, r_p, gx_p
    # the values' gradients: the forward program's through N, the derived
    # transpose's through T, routed back by K7 and gathered by K8, against
    # autograd of the plain pipeline
    import linops_tpu_torch.sparse.routed as TR

    for mode, slot, what in (("N", 0, "forward program vals"), ("T", 1, "derived transpose vals_pre")):
        xin = dev_vec(op_l.in_dim(mode), dev, SEED + 107)
        gout = dev_vec(op_l.out_dim(mode), dev, SEED + 108)
        leaf = op_l._program_values()[slot].requires_grad_(True)
        y = op_l.apply(xin, mode)
        (gv,), c_v = grad_launches(lambda: torch.autograd.grad(y, leaf, gout))
        t_v = marginal_ms(lambda: torch.autograd.grad(op_l.apply(xin, mode), leaf, gout))
        kernel_use = TR._use_kernel
        TR._use_kernel = lambda uk, vals, x_: False if uk is None else bool(uk)
        try:
            (gv_p,) = torch.autograd.grad(op_l.apply(xin, mode), leaf, gout)
        finally:
            TR._use_kernel = kernel_use
            leaf.requires_grad_(False)
        e_v = rel_err(gv, gv_p)
        check(e_v <= GRAD_X_RTOL and c_v.get("lane_gather", 0) > 0
              and c_v.get("lane_gather_mul", 0) > 0 and torch.isfinite(gv).all(),
              f"12c value gradient {mode}: against the plain pipeline {e_v:.2e}, launches {c_v}")
        print(f"[12c routed grads] value gradient of ⟨g, {'A' if mode == 'N' else 'Aᵀ'}x⟩ "
              f"({what}, {gv.numel()} slots): against the plain pipeline's autograd {e_v:.2e} "
              f"(limit {GRAD_X_RTOL:g}, max|Δ|/max); backward launches {c_v}; forward + value "
              f"backward {t_v * 1e3:.1f} us (marginal CUDA events); {card}", flush=True)
        del xin, gout, y, gv, gv_p
    free()
    perm = np.random.default_rng(SEED + 47).permutation(1 << 20)
    P = lt.opPermutation(perm)
    pt = torch.from_numpy(perm).to(dev)
    inv = torch.empty_like(pt)
    inv[pt] = torch.arange(1 << 20, device=dev)
    x = dev_vec(1 << 20, dev, SEED + 98).requires_grad_(True)
    g = dev_vec(1 << 20, dev, SEED + 99)
    y = P @ x
    (gx,), c_perm = grad_launches(lambda: torch.autograd.grad(y, x, g))
    check(torch.equal(gx, g[inv]) and c_perm.get("lane_gather_sum") == 1,
          f"12c: permutation gradient equal to g[perm⁻¹] {torch.equal(gx, g[inv])}, "
          f"launches {c_perm}")
    print(f"[12c routed grads] opPermutation(2^20): x-gradient = g[perm⁻¹] exactly; backward "
          f"launches {c_perm}", flush=True)
    del P, x, g, y, gx

    # --- 12f. torch.func.vmap over kernel applies -------------------------------------
    blocks, cols = make_bsr("8x128", f32, dev, scale=(kmax * bn) ** -0.5)
    op = lt.BSROperator(lt.BSR(blocks, cols, (N, N)))
    V = torch.stack([dev_vec(N, dev, SEED + 110 + i) for i in range(8)])
    # N: one K1p launch, T: one K2p launch on the batch (a row panel), as the
    # reference's vmap is one batched kernel, bit for bit K1's and K2's column loops
    for mode, want in (("N", {"bsr_matmat": 1}), ("T", {"bsr_rmatmat": 1})):
        reset()
        Y = torch.func.vmap(lambda v, m=mode: op.apply(v, m))(V)
        torch.cuda.synchronize()
        c_vm = {k_: v_ for k_, v_ in counts().items() if v_}
        with torch.no_grad():
            ref = torch.stack([op.apply(v, mode) for v in V])
        check(torch.equal(Y, ref) and c_vm == want,
              f"12f vmap {mode}: bit-equal {torch.equal(Y, ref)}, launches {c_vm}")
        print(f"[12f vmap] torch.func.vmap over 8 vectors of {'A' if mode == 'N' else 'Aᵀ'}x, "
              f"8x128 n = {N}: bit for bit 8 vector applies; launches {c_vm}", flush=True)
    W = torch.stack([dev_vec(ncol, dev, SEED + 120 + i) for i in range(8)])
    reset()
    Yr = torch.func.vmap(lambda v: op_l @ v)(W)
    torch.cuda.synchronize()
    c_vr = {k_: v_ for k_, v_ in counts().items() if v_}
    with torch.no_grad():
        ref = torch.stack([op_l @ w_ for w_ in W])
    e_vr = rel_err(Yr, ref)
    check(e_vr <= 1e-6 and c_vr.get("lane_gather_sum", 0) > 0,
          f"12f vmap routed: {e_vr:.2e} from 8 vector applies, launches {c_vr}")
    print(f"[12f vmap] torch.func.vmap over 8 vectors of the 12c routed matrix (N): the matrix "
          f"kind on a row panel, against 8 vector applies {e_vr:.2e} (limit 1e-6); launches "
          f"{c_vr}", flush=True)
    del op_l, Al, W, Yr, ref, V, Y

    # --- 12g. torch.func.vmap over cg ------------------------------------------------------
    free()
    dg = torch.linspace(1.0, 2.0, N, device=dev)
    A1 = lt.opDiagonal(dg) @ (op.T @ op) @ lt.opDiagonal(dg) + 2.0 * lt.opEye(N, dtype=f32)
    B4 = torch.stack([dev_vec(N, dev, SEED + 130 + i) for i in range(4)])
    reset()
    t0 = time.perf_counter()
    xs, ks, _ = torch.func.vmap(lambda b_: lt.cg(A1, b_, tol=1e-5, maxiter=500))(B4)
    torch.cuda.synchronize()
    t_vm = time.perf_counter() - t0
    c_cg = {k_: v_ for k_, v_ in counts().items() if v_}
    seq = [lt.cg(A1, b_, tol=1e-5, maxiter=500) for b_ in B4]
    ks_seq = [k_ for _, k_, _ in seq]
    dx = max(rel_vec(xs[i], seq[i][0]) for i in range(4))
    check(all(abs(int(ks[i]) - ks_seq[i]) <= 1 for i in range(4)) and dx <= 1e-3
          and torch.isfinite(xs).all(),
          f"12g vmap(cg): iterations {ks.tolist()} against {ks_seq}, |Δx|/|x| {dx:.2e}")
    print(f"[12g vmap(cg)] 4 systems D (BᵀB) D + 2·I, n = {N}, tol 1e-5: per-member iterations "
          f"{ks.tolist()} (one by one: {ks_seq}), max |Δx|/|x| {dx:.2e} (limit 1e-3); launches "
          f"{c_cg}; {t_vm * 1e3:.1f} ms incl. first calls; {card}", flush=True)
    del op, A1, B4, xs, seq, blocks, cols

    # --- 12d. the implicit backward of opIterativeInverse ------------------------------
    free()
    blocks, cols = make_bsr("8x128", f32, dev, scale=(kmax * bn) ** -0.5)
    sigma = 2.0

    def graph(d_, backend="auto"):
        B = lt.BSROperator(lt.BSR(blocks, cols, (N, N)), backend=backend)
        D = lt.opDiagonal(d_)
        return D @ (B.T @ B) @ D + sigma * lt.opEye(N, dtype=f32)

    d = torch.linspace(1.0, 2.0, N, device=dev).requires_grad_(True)
    b = dev_vec(N, dev, SEED + 100).requires_grad_(True)
    w = dev_vec(N, dev, SEED + 101)

    def loss(backend="auto"):
        inv_ = lt.opIterativeInverse(graph(d, backend), solver="cg", tol=1e-6, maxiter=500)
        return torch.dot(w, inv_ @ b)

    inv = lt.opIterativeInverse(graph(d), solver="cg", tol=1e-6, maxiter=500)
    with torch.no_grad():
        _, k_fwd, _ = inv.solve_info(b)
        _, k_bwd, _ = inv.solve_info(w, "H")
    L = loss()
    (gd, gb), c_imp = grad_launches(lambda: torch.autograd.grad(L, (d, b)))
    with torch.no_grad():
        A = graph(d.detach())
        z = lt.cg(A, w, tol=1e-6, maxiter=500)[0]
        xs = lt.cg(A, b.detach(), tol=1e-6, maxiter=500)[0]
        M = lt.BSROperator(lt.BSR(blocks, cols, (N, N)))
        MtM = M.T @ M
        dd = d.detach()
        gd_c = -(z * (MtM @ (dd * xs)) + xs * (MtM @ (dd * z)))
    gd_p, gb_p = torch.autograd.grad(loss("torch"), (d, b))
    errs = {"d closed form": rel_vec(gd, gd_c), "b closed form": rel_vec(gb, z),
            "d plain": rel_vec(gd, gd_p), "b plain": rel_vec(gb, gb_p)}
    check(all(e <= IMPLICIT_RTOL for e in errs.values()) and c_imp.get("bsr_rmatvec", 0) > 0,
          f"12d implicit backward: {errs}, launches {c_imp}")

    def run_fwd():
        return inv @ b

    def run_both():
        return torch.autograd.grad(torch.dot(w, inv @ b), (d, b))

    reps = [(timed_solve(run_fwd)[1], timed_solve(run_both)[1]) for _ in range(REPS)]
    t_fwd = float(np.median([a for a, _ in reps]))
    t_bwd = float(np.median([bo - a for a, bo in reps]))
    times["12d forward solve"], times["12d backward"] = t_fwd * 1e3, t_bwd * 1e3
    print(f"[12d implicit backward] ⟨w, A(d)⁻¹b⟩, A(d) = D (BᵀB) D + {sigma}·I, n = {N}, "
          f"opIterativeInverse(cg, tol 1e-6): inner iterations {k_fwd} forward, {k_bwd} in the "
          f"backward solve; ‖Δ‖/‖g‖: " + ", ".join(f"{k_} {e:.2e}" for k_, e in errs.items())
          + f" (limit {IMPLICIT_RTOL:g}); backward launches {c_imp}; forward solve "
          f"{t_fwd * 1e3:.2f} ms, backward {t_bwd * 1e3:.2f} ms (host clock around synchronized "
          f"runs, median of {REPS}; backward = forward + backward − forward); {card}", flush=True)
    del inv, A, M, MtM, z, xs, gd, gb, gd_p, gb_p, gd_c, d, b, w, L

    # --- 12e. apply_linear ---------------------------------------------------------
    leaf = blocks.clone().requires_grad_(True)
    op = lt.BSROperator(lt.BSR(leaf, cols, (N, N)))
    x = dev_vec(N, dev, SEED + 102).requires_grad_(True)
    g = dev_vec(N, dev, SEED + 103)
    y = lt.apply_linear(op, x)
    (gx, gB), c_al = grad_launches(lambda: torch.autograd.grad(y, (x, leaf), g,
                                                                allow_unused=True))
    with torch.no_grad():
        want = op.T @ g
    check(torch.equal(gx, want) and gB is None and c_al == {"bsr_rmatvec": 1},
          f"12e apply_linear on BSR: equal {torch.equal(gx, want)}, blocks gradient "
          f"{gB is not None}, launches {c_al}")
    n_f = 4096
    Ad = torch.randn((n_f, n_f), generator=torch.Generator(device=dev).manual_seed(SEED + 104),
                     device=dev)
    calls = {"t": 0}

    def tprod(u_):
        calls["t"] += 1
        return Ad.T @ u_

    F = lt.FunctionOperator(n_f, n_f, lambda v_: Ad @ v_, tprod, dtype=f32)
    xf = dev_vec(n_f, dev, SEED + 105).requires_grad_(True)
    gf = dev_vec(n_f, dev, SEED + 106)
    (gxf,) = torch.autograd.grad(lt.apply_linear(F, xf), xf, gf)
    check(calls["t"] == 1 and torch.equal(gxf, Ad.T @ gf),
          f"12e apply_linear on a FunctionOperator: {calls['t']} tprod calls")
    print(f"[12e apply_linear] BSR 8x128 n = {N}: backward = one K2 ({c_al}), bit for bit "
          f"Aᵀg, no gradient into the blocks; FunctionOperator {n_f}²: backward = one call of "
          f"its tprod, bit for bit", flush=True)
    del leaf, op, x, g, y, gx, want, Ad, F, xf, gf, gxf, blocks, cols
    free()
    print(f"[12 slice-7 path] backward launches over 12a-12e "
          f"{ {k_: v_ for k_, v_ in backward.items() if v_} }; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return backward, times


# ----------------------------------------------------------------------------
# Slice 8: the distributed layer at world size 1
# ----------------------------------------------------------------------------

HALO_N, HALO_BAND = 16384, 3  # 13e: the banded matrix
HALO_PANEL = 6  # 13e: the columns of its block apply (LOBPCG's 3k at k = 2)


def phase13(lt, K, LG, dev, card, ops):
    """Slice 8's path on one card: a world of one NCCL rank. (a) the process
    group and its topology; (b) slice 1's graph and its inverse L-BFGS
    preconditioner through ``shard_operator``: the port's dryrun step, CG to
    1e-5 in captured blocks against the sharded per-iteration loop and the
    unsharded solve (iterations, x bit for bit, K1/K2 per iteration, the
    block's kernel nodes, reads per cached solve), collectives per apply, µs
    per iteration captured, per-iteration and unsharded; (c) the 2^22 banded
    and band + cluster operators sharded: K3-K6, bit for bit, and in captured
    matvec chains; (d) auto_8m replicated: N and T through K7-K12, bit for
    bit; (e) ``banded_partition`` of a band-3 matrix at n = 16384 (a 1 GiB
    dense slab) and CG on it in captured blocks, and a 6-column panel apply,
    N and T, against its column loop (within 1e-6), both timed; (f) ``stencil_partition_2d``
    of the 5-point Laplacian on 2048² against the stencil operator, and
    Chebyshev with no all-reduce, captured; (g) ``scaling_report(1)``, the
    card's copy rate and the projection from it. Every solve runs both ways
    through ``loop_modes``. Returns the launches of (b)-(d)."""
    import scipy.sparse as sps

    from linops_tpu_torch.parallel import (HaloPartitionedOperator, NamedSharding, P,
                                           banded_partition, collective_counts,
                                           initialize_distributed, make_mesh, make_mesh2d,
                                           row_sharding, runtime_info, scaling_report,
                                           shard_operator, stencil_partition_2d)
    from linops_tpu_torch.parallel.comm import gather_full
    from linops_tpu_torch.parallel.dryrun import dryrun_multichip
    from linops_tpu_torch.parallel.scaling_bench import ici_projection
    from linops_tpu_torch.utils import loop

    f32 = torch.float32
    t_phase = time.perf_counter()

    def counts():
        return {k_: v_ for k_, v_ in {**K.launch_counts(), **LG.launch_counts()}.items() if v_}

    def reset():
        K.reset_launch_counts()
        LG.reset_launch_counts()

    # --- 13a. the process group ------------------------------------------------------
    initialize_distributed()
    info = runtime_info()
    check(info["process_count"] == 1 and info["platform"] == "gpu", f"13a: {info}")
    mesh = make_mesh()
    place = row_sharding(mesh).place
    print(f"[13a init] initialize_distributed(): NCCL, {info}; mesh {mesh}", flush=True)
    launches = {}

    # --- 13b. slice 1 sharded ---------------------------------------------------------
    free()
    step = dryrun_multichip(1)
    check(np.isfinite(step["x_norm"]), f"13b dryrun: {step}")
    print(f"[13b dryrun] dryrun_multichip(1): {step}", flush=True)
    bm, bn, kmax = SHAPES["8x128"]
    blocks, cols = make_bsr("8x128", f32, dev, scale=(kmax * bn) ** -0.5)
    d = torch.linspace(1.0, 2.0, N, dtype=f32, device=dev)
    B = lt.BSROperator(lt.BSR(blocks, cols, (N, N)))
    A = lt.opDiagonal(d) @ (B.T @ B) @ lt.opDiagonal(d) + 2.0 * lt.opEye(N, dtype=f32)
    b = dev_vec(N, dev, SEED + 140)
    H = lt.InverseLBFGSOperator(f32, N, mem=8, device=dev)
    for i in range(8):
        s_ = dev_vec(N, dev, SEED + 141 + i)
        H.push(s_, A @ s_)
    A_sh, H_sh = shard_operator(A, mesh), shard_operator(H, mesh)
    b_sh = place(b)

    def solve_sh():
        x_, k_, r_ = lt.cg(A_sh, b_sh, M=H_sh, tol=1e-5, maxiter=500)
        return gather_full(x_), k_, r_

    # the per-iteration loop, unsharded and sharded: the same kernels launched
    with per_iteration(loop):
        reset()
        x_un, k_un, _ = lt.cg(A, b, M=H, tol=1e-5, maxiter=500)
        torch.cuda.synchronize()
        c_un = counts()
        reset()
        x_sh, k_sh, _ = solve_sh()
        torch.cuda.synchronize()
        c_sh = counts()
    launches["13b"] = c_sh
    coll = {"A": collective_counts(lambda: A_sh.apply(b_sh, "N")),
            "M": collective_counts(lambda: H_sh.apply(b_sh, "N"))}
    # the sharded solve in captured blocks (a sharded operator is capture-safe
    # since PR 12): per-iteration loop against the first, capturing and cached
    # solves, bit for bit
    r_sh = loop_modes(loop, f"13b slice-1 cg sharded at world size 1 (n = {N}), tol 1e-5",
                      solve_sh, phase="13")
    solve_sh()
    st_sh = dict(loop.stats)
    check(st_sh["path"] == "graph" and st_sh["captures"] == 0,
          f"13b: the sharded solve took {st_sh}")
    check(r_sh["reads"][1] == -(-k_sh // loop.BLOCK),
          f"13b: {r_sh['reads'][1]} reads in a cached sharded solve of {k_sh} iterations")
    coll_after = {"A": collective_counts(lambda: A_sh.apply(b_sh, "N")),
                  "M": collective_counts(lambda: H_sh.apply(b_sh, "N"))}
    check(coll_after == coll, f"13b: collectives per apply {coll} before the captured solves, "
                              f"{coll_after} after")
    loop.clear_cache()
    for _ in range(3):  # the unsharded signature's plain, capturing and cached solves
        x_g, k_g, _ = lt.cg(A, b, M=H, tol=1e-5, maxiter=500)
    same = torch.equal(x_sh, x_un) and torch.equal(x_g, x_un) and r_sh["bits"]
    check(k_sh == k_un == k_g == r_sh["iters"] and same and c_sh == c_un
          and c_sh.get("bsr_matvec", 0) > 0,
          f"13b: iterations {k_sh} against {k_un} ({k_g} in unsharded graph blocks, "
          f"{r_sh['iters']} in sharded ones), x bit for bit {same}, launches {c_sh} against "
          f"{c_un}")

    def cg_iter_us(op, rhs, M_):
        def run(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lt.cg(op, rhs, M=M_, tol=0.0, maxiter=iters)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e6
        run(I_SHORT)  # the plain loop (the signature's first solve)
        run(I_SHORT)  # captures the block
        return float(np.median([(run(I_LONG) - run(I_SHORT)) / (I_LONG - I_SHORT)
                                for _ in range(REPS)]))

    us_sh = cg_iter_us(A_sh, b_sh, H_sh)
    with per_iteration(loop):
        us_sh_it = cg_iter_us(A_sh, b_sh, H_sh)
    us_un = cg_iter_us(A, b, H)
    check(us_sh < us_sh_it, f"13b: sharded captured blocks {us_sh:.1f} us per iteration, not "
                            f"faster than its per-iteration loop's {us_sh_it:.1f}")
    print(f"[13b slice 1 sharded] cg(D (BᵀB) D + 2·I, M = inverse L-BFGS mem 8), n = {N}, "
          f"both through shard_operator on a 1-rank mesh: {k_sh} iterations (unsharded {k_un}), "
          f"x bit for bit the sharded per-iteration loop's and the unsharded solve's (per-"
          f"iteration loop and graph blocks); launches {c_sh} (unsharded per-iteration loop "
          f"{c_un}: {c_sh.get('bsr_matvec', 0) / max(k_sh + 1, 1):.2f} K1 and "
          f"{c_sh.get('bsr_rmatvec', 0) / max(k_sh + 1, 1):.2f} K2 per iteration); collectives "
          f"per apply {coll} (the same after the captured solves); a cached sharded solve "
          f"{st_sh['path']}, {st_sh['reads']} reads, {r_sh['kernel_nodes']} kernel nodes in its "
          f"block ({r_sh['nccl_nodes']} NCCL's); µs per iteration (host clock, marginal "
          f"{I_LONG} − {I_SHORT}, median of {REPS}): sharded captured blocks {us_sh:.1f}, sharded "
          f"per-iteration loop {us_sh_it:.1f}, unsharded captured blocks {us_un:.1f}; {card}",
          flush=True)
    del A, A_sh, H, H_sh, B, blocks, cols, x_un, x_sh, x_g, b, b_sh

    # --- 13c. the windowed operators sharded ----------------------------------------------
    for name in WIN_KMAX:
        free()
        op = win_operator(lt, name, f32, dev, SEED + 10)
        fwd_k, tr_k = win_names(op)
        op_sh = shard_operator(op, mesh)
        x = dev_vec(WIN_N, dev, SEED + 150)
        reset()
        y, yt = op_sh @ place(x), op_sh.T @ place(x)
        torch.cuda.synchronize()
        c_w = counts()
        launches[f"13c {name}"] = c_w
        same = torch.equal(gather_full(y), op @ x) and torch.equal(gather_full(yt), op.T @ x)
        check(same and c_w == {fwd_k: 1, tr_k: 1},
              f"13c {name}: bit for bit {same}, launches {c_w}")
        print(f"[13c windows sharded] {name} n = 2^22 through shard_operator: N and T bit for "
              f"bit the unsharded applies; launches {c_w}; collectives N "
              f"{collective_counts(lambda: op_sh @ place(x))}", flush=True)
        xs = place(x)
        for mode, kern in (("N", fwd_k), ("T", tr_k)):
            r = loop_modes(loop, f"13c matvec_chain(12, mode {mode}) on the sharded {name} "
                           "operator (n = 2^22)",
                           lambda: (gather_full(lt.matvec_chain(op_sh, xs, 12, mode=mode)), 12,
                                    None), unit="applies", phase="13")
            check(r["held"].get(kern, 0) > 0, f"13c {name} {mode}: the sharded chain's block "
                                              f"holds {r['held']}")
        del op, op_sh, x, xs, y, yt

    # --- 13d. auto_8m replicated ----------------------------------------------------------
    free()
    op2 = ops["op2"]
    op2_sh = shard_operator(op2, mesh)
    v = dev_vec(op2.shape[1], dev, SEED + 151)
    reset()
    y, yt = op2_sh @ place(v), op2_sh.T @ place(v)
    torch.cuda.synchronize()
    c_r = counts()
    launches["13d"] = c_r
    same = torch.equal(gather_full(y), op2 @ v) and torch.equal(gather_full(yt), op2.T @ v)
    check(same and all(c_r.get(k_, 0) > 0 for k_ in (
        "lane_gather", "lane_gather_sum", "lane_segsum", "lane_gather_mul_segsum"))
          and c_r.get("lane_gather_mul_t_batched", 0) + c_r.get("lane_gather_mul", 0) > 0,
          f"13d: bit for bit {same}, launches {c_r}")
    print(f"[13d routed replicated] auto_8m (n = 2^19, {ops['nnz2']} nnz) through shard_operator "
          f"(routing programs replicated): N and T bit for bit the unsharded applies; launches "
          f"{c_r}", flush=True)
    del op2_sh, v, y, yt

    # --- 13e. banded_partition ---------------------------------------------------------------
    free()
    rng = np.random.default_rng(SEED + 152)
    n = HALO_N
    offs = [rng.uniform(-1.0, 1.0, n - k).astype(np.float32) for k in range(1, HALO_BAND + 1)]
    diag = np.ones(n, np.float32)
    for k, o in enumerate(offs, 1):
        diag[:-k] += np.abs(o)
        diag[k:] += np.abs(o)
    S = sps.diags([diag] + offs + offs, [0] + list(range(1, HALO_BAND + 1))
                  + [-k for k in range(1, HALO_BAND + 1)], format="csr", dtype=np.float32)
    t0 = time.perf_counter()
    hop = banded_partition(S.toarray(), mesh, symmetric=True, hermitian=True)
    t_part = time.perf_counter() - t0
    bh = dev_vec(n, dev, SEED + 153)
    bh_sh = place(bh)

    def solve_h():
        x_, k_, r_ = lt.cg(hop, bh_sh, tol=1e-5, maxiter=500)
        return gather_full(x_), k_, r_

    loop_modes(loop, f"13e cg on banded_partition (n = {n}), tol 1e-5", solve_h, phase="13")
    xh, kh, _ = solve_h()
    check(loop.stats["path"] == "graph" and loop.stats["reads"] == -(-kh // loop.BLOCK),
          f"13e: a cached solve took {loop.stats}")
    xh = xh.double().cpu().numpy()
    bh64 = bh.double().cpu().numpy()
    res_h = float(np.linalg.norm(S.astype(np.float64) @ xh - bh64) / np.linalg.norm(bh64))
    check(res_h <= 1e-4 and np.isfinite(xh).all(), f"13e: f64 residual {res_h:.3e}")
    us_h = cg_iter_us(hop, bh_sh, None)
    c_h = collective_counts(lambda: hop @ bh_sh)
    # a 6-column panel through the same slabs, declared non-symmetric so that T
    # takes the transpose program: one apply against its column loop
    hop_ns = HaloPartitionedOperator(hop.A_int.to_local(), hop.A_left.to_local(),
                                     hop.A_right.to_local(), mesh)
    Ph = place(dev_vec(n, dev, SEED + 155, k=HALO_PANEL))
    panel_h = {}
    for mode in ("N", "T"):
        def cols(mode=mode):
            return torch.stack([hop_ns.apply(Ph[:, j], mode) for j in range(HALO_PANEL)], dim=1)

        err = rel_err(gather_full(hop_ns.apply_matrix(Ph, mode)), gather_full(cols()))
        c_p = collective_counts(lambda: hop_ns.apply_matrix(Ph, mode))
        panel_h[mode] = (err, marginal_ms(lambda: hop_ns.apply_matrix(Ph, mode)),
                         marginal_ms(cols), c_p)
        check(err <= 1e-6, f"13e: the {HALO_PANEL}-column panel apply in mode {mode} differs "
                           f"from its column loop by {err:.2e} (limit 1e-6)")
    print(f"[13e banded_partition] band-{HALO_BAND} SPD, n = {n}, halo {hop.halo}: a "
          f"{n}x{n} f32 interior slab ({n * n * 4 / 2**30:.2f} GiB, built in {t_part:.2f} s); "
          f"cg to 1e-5: {kh} iterations in captured blocks, x bit for bit the per-iteration "
          f"loop's, f64 residual {res_h:.2e} (limit 1e-4), {us_h:.1f} us per iteration (marginal, "
          f"captured blocks); collectives per apply {c_h}; {card}", flush=True)
    print(f"[13e banded panel] a {HALO_PANEL}-column panel through the same slabs (declared "
          f"non-symmetric): " + "; ".join(
              f"{m_}: against its column loop {e_:.2e} (limit 1e-6), {t_ * 1e3:.1f} us per block "
              f"apply, column loop {tl_ * 1e3:.1f} us (marginal CUDA events), collectives {c_}"
              for m_, (e_, t_, tl_, c_) in panel_h.items()) + f"; {card}", flush=True)
    del hop, hop_ns, Ph, S, xh, bh_sh

    # --- 13f. stencil_partition_2d --------------------------------------------------------
    free()
    g2 = 2048
    mesh2 = make_mesh2d(1, 1)
    L2 = stencil_partition_2d(torch.tensor([4.0, -1.0, -1.0, -1.0, -1.0], device=dev), g2, g2,
                              mesh2)
    L1 = lt.laplacian_2d(g2, g2, dtype=f32)
    U = dev_vec(g2 * g2, dev, SEED + 154)
    v2 = NamedSharding(mesh2, P(("gy", "gx"))).place(L2.grid_to_vec(U.reshape(g2, g2)))
    y2 = L2.vec_to_grid(L2 @ v2).reshape(-1)
    e2 = rel_err(y2, L1 @ U)
    cheb = collective_counts(lambda: lt.chebyshev(L2, v2, 0.05, 8.0, iters=30)[0])

    def solve_c():
        x_, k_, r_ = lt.chebyshev(L2, v2, 0.05, 8.0, iters=30)
        return gather_full(x_), k_, r_

    loop_modes(loop, f"13f chebyshev (30 iterations) on stencil_partition_2d ({g2}²)", solve_c,
               phase="13")
    c2 = collective_counts(lambda: L2 @ v2)
    t2 = marginal_ms(lambda: L2 @ v2)
    check(e2 <= 1e-6 and cheb["all-reduce"] == 0 and cheb["all-gather"] == 0,
          f"13f: against the stencil {e2:.2e}, chebyshev collectives {cheb}")
    print(f"[13f stencil_partition_2d] 5-point Laplacian on {g2}², a 1x1 mesh: against "
          f"laplacian_2d (the stencil operator) {e2:.2e} (limit 1e-6, max|Δ|/max); "
          f"{t2 * 1e3:.1f} us per apply (marginal CUDA events); collectives per apply {c2}; "
          f"chebyshev (30 iterations) collectives {cheb}; {card}", flush=True)
    del L2, L1, U, v2, y2

    # --- 13g. scaling report, the card's copy rate, the projection ----------------------------
    free()
    report = scaling_report(1)
    a = torch.empty(1 << 28, device=dev)
    c = torch.empty_like(a)
    copy_ms = marginal_ms(lambda: c.copy_(a))
    hbm = 2 * a.numel() * 4 / (copy_ms / 1e3)
    proj = ici_projection(n_devices=8, hbm_bps=hbm)
    del a, c
    print(f"[13g scaling] scaling_report(1): {json.dumps(report)}", flush=True)
    print(f"[13g scaling] device-to-device copy of 1 GiB: {copy_ms * 1e3:.1f} us = "
          f"{hbm / 1e9:.1f} GB/s moved (read + write; marginal CUDA events); projection at 8 "
          f"devices from it: {json.dumps(proj)}; {card}", flush=True)
    print(f"[13 slice-8 path] launches {launches}; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


DTENSOR_GMRES_MAXITER = 20  # 13h: GMRES(30)'s restarts at most, as 10a


def phase13h(lt, loop, K, LG, dev, card, ops, main, rec14):
    """DTensor vectors wherever the reference takes a sharded array, in the
    world of one NCCL rank, at full width. (a) GMRES(30) on
    ``shard_operator`` of 10a's auto_8m + 8I with b placed ``Shard(0)``,
    both ways through ``loop_modes``: x in b's placement, restarts and x bit
    for bit the unsharded 10a solve's, one read per restart and no
    synchronizing call but the reads in a cached solve, the collectives of
    one Arnoldi step (the operator's own and at most two all-reduces: the
    basis is never gathered), the captured block's kernels (E2 and the routed
    apply's K7, K9-K11, the set the per-iteration loop launched; no cuSOLVER
    kernel), wall and device µs per restart beside 14d's unsharded numbers.
    (b) 14h's nested solve on DTensor vectors: outer iterations and summed
    inner restarts 14h's, x bit for bit the unsharded solve's. (c) phase 11c's
    ``funm_apply`` on phase 4's graph through ``shard_operator`` with a
    DTensor b, bit for bit the plain call. (d) 10e's forward L-BFGS (n =
    10^6, mem 16) through ``shard_operator``: DTensor pairs pushed, the state
    (its placements kept) and the shifted solves at 10e's three σ (compact,
    EJM, all three at once) bit for bit the unsharded model's. (e) slice 1's
    CG (13b's graph) with a plain ``opDiagonal`` Jacobi M and a DTensor b,
    both ways, bit for bit the same M through ``shard_operator``. The launch
    counts are set to 0 before each part and read after it. Returns them."""
    from linops_tpu_torch.kernels import graph_cond as GC
    from linops_tpu_torch.kernels import small_lstsq as E2
    from linops_tpu_torch.parallel import collective_counts, make_mesh, row_sharding, \
        shard_operator
    from linops_tpu_torch.parallel.comm import gather_full, is_dtensor

    t_phase = time.perf_counter()
    mesh = make_mesh()
    place = row_sharding(mesh).place
    f32 = torch.float32
    mods = (K, LG, E2, GC)
    launches = {}

    def reset():
        for m_ in mods:
            m_.reset_launch_counts()

    def counts():
        return {k_: v_ for m_ in mods for k_, v_ in m_.launch_counts().items() if v_}

    def whole(solve):
        """``solve`` with x gathered, for ``loop_modes``'s bit checks; the
        DTensor it returned is kept in ``last``."""
        last = {}

        def run():
            x_, k_, r_ = solve()
            last["x"] = x_
            return gather_full(x_), k_, r_

        return run, last

    def in_place(x_, b_):
        return is_dtensor(x_) and tuple(x_.placements) == tuple(b_.placements)

    # --- 13h a. GMRES(30) on DTensor vectors ---------------------------------------------
    free()
    S = lt.ShiftedOperator(ops["op2"], 8.0)
    S_sh = shard_operator(S, mesh)
    n2 = ops["A2"].shape[0]
    b = dev_vec(n2, dev, SEED + 70)  # 10a's and 14d's b
    b_sh = place(b)

    def gm(op, v):
        return lt.gmres(op, v, tol=1e-5, restart=30, maxiter=DTENSOR_GMRES_MAXITER)

    x_un, k_un, _ = gm(S, b)
    per_apply = collective_counts(lambda: S_sh.apply(b_sh, "N"))
    one = [collective_counts(lambda: lt.gmres(S_sh, b_sh, tol=0.0, restart=m_, maxiter=1))
           for m_ in (10, 20)]
    per_step = {c_: (one[1][c_] - one[0][c_]) / 10 for c_ in one[0]}
    check(all(per_step[c_] == per_apply[c_] for c_ in per_step if c_ != "all-reduce")
          and per_apply["all-reduce"] <= per_step["all-reduce"] <= per_apply["all-reduce"] + 2,
          f"13h a: collectives per Arnoldi step {per_step}, per apply {per_apply}")
    seen = {}

    def inspect(g):
        names = graph_kernel_names(g)
        seen.update(solver=[n_ for n_ in names if SOLVER_KERNELS.search(n_)])

    solve_a, last_a = whole(lambda: gm(S_sh, b_sh))
    reset()
    r_a = loop_modes(loop, f"13h a gmres(30) on shard_operator(auto_8m + 8I) (n = {n2}), b a "
                     "DTensor, tol 1e-5", solve_a, unit="restarts", phase="13h", inspect=inspect)
    c_a = counts()
    launches["13h a"] = c_a
    k = r_a["iters"]
    held = {n_ for n_, c_ in r_a["held"].items() if c_}
    want = {"small_lstsq", "lane_gather", "lane_gather_mul_t_batched", "lane_gather_sum",
            "lane_segsum"}
    check(in_place(last_a["x"], b_sh),
          f"13h a: x placed {getattr(last_a['x'], 'placements', None)}")
    check(k == k_un and r_a["bits"] and torch.equal(gather_full(last_a["x"]), x_un),
          f"13h a: {k} restarts (unsharded {k_un}), x bit for bit both loops {r_a['bits']}, "
          f"against the unsharded 10a solve {torch.equal(gather_full(last_a['x']), x_un)}")
    check(r_a["reads"][1] == k and r_a["syncs_seen"] == r_a["reads"][1],
          f"13h a: {r_a['reads'][1]} reads and {r_a['syncs_seen']} synchronizing calls in a "
          f"cached solve of {k} restarts")
    check(want <= held and held == set(c_a) - {"while_condition"} and not seen["solver"],
          f"13h a: the captured block holds {r_a['held']} (wanted {sorted(want)}; launched in "
          f"its solves {c_a}; cuSOLVER kernels {seen['solver']})")
    d14 = rec14.get("14d 10a gmres(30) on auto_8m + 8I, tol 1e-5", {})
    print(f"[13h a dtensor gmres] gmres(30) on shard_operator(auto_8m + 8I), b placed Shard(0), "
          f"world size 1: x a DTensor in b's placement, {k} restarts (unsharded {k_un}), x bit for "
          f"bit the unsharded 10a solve's and across both loops; a cached solve {r_a['reads'][1]} "
          f"reads, {r_a['syncs_seen']} synchronizing calls; collectives per Arnoldi step "
          f"{per_step}, per apply {per_apply}; the captured block holds {r_a['held']}, no cuSOLVER "
          f"kernel, launches over its solves {c_a} (K8 "
          f"{'launched' if 'lane_gather_mul' in c_a else 'not launched'}); "
          f"wall µs per restart {r_a['wall_us_per_iter'][0]:.1f} per-iteration -> "
          f"{r_a['wall_us_per_iter'][1]:.1f} captured, device {r_a['device_us_per_iter']}, busy "
          f"{r_a['busy']}; 14d unsharded in this call: wall {d14.get('wall_us_per_iter')}, device "
          f"{d14.get('device_us_per_iter')}, busy {d14.get('busy')}; {card}", flush=True)

    # --- 13h b. the nested GMRES on DTensor vectors ----------------------------------------
    bh = dev_vec(n2, dev, SEED + 170)  # 14h's b
    bh_sh = place(bh)
    M_sh = lt.opIterativeInverse(S_sh, tol=1e-2, maxiter=30)
    M_un = lt.opIterativeInverse(S, tol=1e-2, maxiter=30)
    check(M_sh.capture_safe and M_sh._resolved(S_sh) == "gmres",
          f"13h b: the inverse takes {M_sh._resolved(S_sh)}, capture-safe {M_sh.capture_safe}")
    inner = []

    def nested():
        M_sh.reset_inner_iterations()
        out = lt.bicgstab(S_sh, bh_sh, tol=1e-5, maxiter=200, M=M_sh)
        inner.append(M_sh.inner_iterations)
        return out

    solve_b, last_b = whole(nested)
    reset()
    r_b = loop_modes(loop, "13h b nested gmres on DTensor vectors: bicgstab on "
                     "shard_operator(auto_8m + 8I), M = opIterativeInverse(tol 1e-2, maxiter 30, "
                     "auto), tol 1e-5", solve_b, unit="outer iterations", phase="13h")
    c_b = counts()
    launches["13h b"] = c_b
    x_bu, k_bu, _ = lt.bicgstab(S, bh, tol=1e-5, maxiter=200, M=M_un)
    h14 = rec14["14h"]
    check(in_place(last_b["x"], bh_sh) and len(set(inner)) == 1 and r_b["iters"] == k_bu
          == h14["iters"] and min(inner) == h14["inner"]
          and torch.equal(gather_full(last_b["x"]), x_bu) and r_b["bits"],
          f"13h b: {r_b['iters']} outer iterations (unsharded {k_bu}, 14h {h14['iters']}), "
          f"summed inner restarts {set(inner)} (14h {h14['inner']}), x bit for bit "
          f"{torch.equal(gather_full(last_b['x']), x_bu)}, both loops {r_b['bits']}")
    check(r_b["reads"][1] == -(-r_b["iters"] // loop.BLOCK) and c_b.get("small_lstsq", 0) > 0
          and c_b.get("while_condition", 0) > 0,
          f"13h b: {r_b['reads'][1]} reads in a cached solve of {r_b['iters']} outer iterations, "
          f"launches {c_b}")
    print(f"[13h b dtensor nested gmres] bicgstab on shard_operator(auto_8m + 8I) with the auto "
          f"(GMRES(30)) inverse, b a DTensor: {r_b['iters']} outer iterations, {min(inner)} inner "
          f"restarts (14h: {h14['iters']}, {h14['inner']}), x bit for bit the unsharded solve's "
          f"and across both loops; reads {r_b['reads']}; {r_b['while_nodes']} while nodes; wall "
          f"{r_b['wall_us_per_iter'][0]:.1f} -> {r_b['wall_us_per_iter'][1]:.1f} µs per outer "
          f"iteration, busy {r_b['busy']} (14h unsharded: {h14['wall_us_per_iter']}, busy "
          f"{h14['busy']}); launches {c_b}; {card}", flush=True)
    del S, S_sh, M_sh, M_un, b, b_sh, bh, bh_sh, x_un, x_bu
    free()

    # --- 13h c. funm_apply on a DTensor b ----------------------------------------------------
    A4, b4 = main["A"], main["b"]
    A4_sh = shard_operator(A4, mesh)
    herm = loop_function(lt, N, N, A4.apply, symmetric=True, hermitian=True, dtype=f32)
    herm_sh = loop_function(lt, N, N, A4_sh.apply, symmetric=True, hermitian=True, dtype=f32)
    b_unit = b4 / torch.linalg.vector_norm(b4)
    bu_sh = place(b_unit)

    def f(t):
        return torch.exp(-t)

    y_un = lt.funm_apply(herm, f, b_unit, lanczos_steps=30)
    reset()
    y_sh = lt.funm_apply(herm_sh, f, bu_sh, lanczos_steps=30)
    torch.cuda.synchronize()
    c_c = counts()
    launches["13h c"] = c_c
    coll = collective_counts(lambda: lt.funm_apply(herm_sh, f, bu_sh, lanczos_steps=30))
    check(in_place(y_sh, bu_sh) and torch.equal(gather_full(y_sh), y_un)
          and c_c.get("bsr_matvec", 0) > 0 and c_c.get("bsr_rmatvec", 0) > 0,
          f"13h c: funm_apply on a DTensor b placed {getattr(y_sh, 'placements', None)}, bit for "
          f"bit {torch.equal(gather_full(y_sh), y_un)}, launches {c_c}")
    print(f"[13h c dtensor funm_apply] funm_apply(exp(−A), b), A phase 4's graph through "
          f"shard_operator, b a DTensor, 30 Lanczos steps: a DTensor in b's placement, bit for bit "
          f"the plain call; launches {c_c}; collectives {coll}", flush=True)
    del A4_sh, herm, herm_sh, y_un, y_sh

    # --- 13h d. quasi-Newton pushes and shifted solves on sharded state ----------------------
    free()
    nq, mem = 1_000_000, 16
    g = torch.Generator(device=dev).manual_seed(SEED + 76)  # 10e's pairs
    Bq = lt.LBFGSOperator(f32, nq, mem=mem, device=dev)
    Bq_sh = shard_operator(lt.LBFGSOperator(f32, nq, mem=mem, device=dev), mesh)
    before = [str(getattr(t, "placements", None)) for t in Bq_sh.state]
    for _ in range(mem):
        s_ = torch.randn(nq, generator=g, device=dev)
        y_ = s_ + 0.1 * torch.randn(nq, generator=g, device=dev)
        Bq.push(s_, y_)
        Bq_sh.push(place(s_), place(y_))
    after = [str(getattr(t, "placements", None)) for t in Bq_sh.state]
    same = [torch.equal(gather_full(a_), b_) for a_, b_ in zip(Bq_sh.state, Bq.state)]
    check(all(same) and after == before and "Shard(dim=1)" in after[0],
          f"13h d: pushed state bit for bit {dict(zip(Bq.state._fields, same))}, placements "
          f"{before} -> {after}")
    bq = dev_vec(nq, dev, SEED + 77)
    bq_sh = place(bq)
    sigmas = (0.1, 1.0, 10.0)
    solved = {}
    for sg in sigmas:
        for method in ("compact", "ejm"):
            x_s = lt.solve_shifted_system(Bq_sh, bq_sh, sg, method=method)
            x_u = lt.solve_shifted_system(Bq, bq, sg, method=method)
            solved[(method, sg)] = in_place(x_s, bq_sh) and torch.equal(gather_full(x_s), x_u)
    X_s = lt.solve_shifted_systems(Bq_sh, bq_sh, list(sigmas))
    solved[("batch", sigmas)] = torch.equal(gather_full(X_s), lt.solve_shifted_systems(
        Bq, bq, list(sigmas)))
    check(all(solved.values()), f"13h d: shifted solves in place and bit for bit {solved}")
    print(f"[13h d dtensor quasi-newton] forward L-BFGS n = {nq}, mem {mem} through "
          f"shard_operator: {mem} DTensor pairs pushed, the state bit for bit the unsharded "
          f"model's, placements kept ({after[0]} for S); solve_shifted_system at σ = "
          f"{list(sigmas)} (compact, EJM) and solve_shifted_systems: DTensors in b's placement, "
          f"bit for bit; {card}", flush=True)
    del Bq, Bq_sh, bq, bq_sh, X_s

    # --- 13h e. CG with a plain Jacobi preconditioner on a DTensor b -------------------------
    free()
    bm, bn, kmax = SHAPES["8x128"]
    blocks, cols = make_bsr("8x128", f32, dev, scale=(kmax * bn) ** -0.5)  # 13b's graph
    d = torch.linspace(1.0, 2.0, N, dtype=f32, device=dev)
    B = lt.BSROperator(lt.BSR(blocks, cols, (N, N)))
    A = lt.opDiagonal(d) @ (B.T @ B) @ lt.opDiagonal(d) + 2.0 * lt.opEye(N, dtype=f32)
    idx = (cols.long()[..., None] * bn + torch.arange(bn, device=dev)).reshape(-1)
    colsq = torch.zeros(N, device=dev).index_add_(0, idx, (blocks * blocks).sum(dim=2).reshape(-1))
    M = lt.opDiagonal(1.0 / (d * d * colsq + 2.0))  # Jacobi of A (duplicate columns aside)
    A_sh = shard_operator(A, mesh)
    be = place(dev_vec(N, dev, SEED + 140))  # 13b's b
    solve_e, last_e = whole(lambda: lt.cg(A_sh, be, M=M, tol=1e-5, maxiter=500))
    reset()
    r_e = loop_modes(loop, f"13h e cg on shard_operator(slice 1's graph) (n = {N}), M a plain "
                     "opDiagonal (Jacobi), b a DTensor, tol 1e-5", solve_e, phase="13h")
    c_e = counts()
    launches["13h e"] = c_e
    x_m, k_m, _ = lt.cg(A_sh, be, M=shard_operator(M, mesh), tol=1e-5, maxiter=500)
    check(in_place(last_e["x"], be) and r_e["bits"] and k_m == r_e["iters"]
          and torch.equal(gather_full(x_m), gather_full(last_e["x"]))
          and c_e.get("bsr_matvec", 0) > 0 and c_e.get("bsr_rmatvec", 0) > 0,
          f"13h e: {r_e['iters']} iterations (M sharded: {k_m}), x bit for bit "
          f"{torch.equal(gather_full(x_m), gather_full(last_e['x']))}, both loops {r_e['bits']}, "
          f"launches {c_e}")
    print(f"[13h e dtensor jacobi cg] cg on shard_operator(slice 1's graph), M = opDiagonal "
          f"(plain), b a DTensor: {r_e['iters']} iterations, x in b's placement and bit for bit "
          f"the same M through shard_operator and across both loops; reads {r_e['reads']}; "
          f"launches {c_e}; {card}", flush=True)
    del A, A_sh, B, blocks, cols, M, be, x_m
    free()
    print(f"[13h dtensor path] launches {launches}; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches



# ----------------------------------------------------------------------------
# 14i: opIterativeInverse's block apply as one panel solve
# ----------------------------------------------------------------------------

PANEL_K = 8  # 14i a: the Rademacher block's columns
LOB14I_K, LOB14I_ITERS = 4, 20  # 14i b, c: LOBPCG's block and iterations per solve (tol 0)
PANEL_RTOL = 1e-5  # 14i a: each column of a panel solve against its vector apply, relative
ROUTED_14I = ("lane_gather", "lane_gather_mul_t_batched", "lane_gather_sum", "lane_segsum")


def all_launches(mods) -> dict:
    """The launch counts of every kernel module in ``mods``, by kernel."""
    out = {}
    for m_ in mods:
        out.update(m_.launch_counts())
    return out


def marginal_us(fn, short, long_, reps=REPS):
    """(host-clock µs, CUDA-event µs) per unit of work, where ``fn(n)`` runs
    n units: the median over ``reps`` of (t(long_) − t(short)) / (long_ −
    short), each call timed on both clocks between synchronizes. The event
    time is the stream's, from the call's first launch to its end, gaps for
    host reads included."""
    per = []
    for _ in range(reps):
        ts = []
        for n_ in (short, long_):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            fn(n_)
            e1.record()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0, e0.elapsed_time(e1)))
        per.append(((ts[1][0] - ts[0][0]) * 1e6 / (long_ - short),
                    (ts[1][1] - ts[0][1]) * 1e3 / (long_ - short)))
    return float(np.median([w for w, _ in per])), float(np.median([e for _, e in per]))


@contextlib.contextmanager
def loop_where(loop):
    """Panel solves with the loop's own ``where`` over the state as well
    (``device_while(keeps=False)``), the captured blocks dropped on entry
    and exit: 14i b's yardstick for ``keeps``."""
    real = loop.device_while
    loop.device_while = lambda *a, **kw: real(*a, **{**kw, "keeps": False})
    loop.clear_cache()
    try:
        yield
    finally:
        loop.device_while = real
        loop.clear_cache()


def column_loop(lt, M, **flags):
    """``M``'s block apply as the column loop the port ran before its panel
    solve (one vector apply per column, stacked): a capture-safe
    ``loop_function`` over ``M.apply``. Used only as the yardstick of 14i."""
    return loop_function(lt, M.nrow, M.ncol, lambda v: M.apply(v, "N"), dtype=M.dtype,
                         capture_safe=True, **flags)


def phase14i(lt, loop, mods, dev, card, ops):
    """``opIterativeInverse`` applies a block as one panel solve (f32).
    (a) 14h's inexact GMRES inverse M of S = auto_8m + 8I (tol 1e-2, maxiter
    30, "auto": GMRES(30), one restart) on an (n, 8) Rademacher block, and
    in ``estimate_trace`` (Hutchinson, 8 probes) with the same generator,
    against the column loop (a stack of 8 vector applies, and M behind
    ``column_loop``): restarts per column equal, each column within
    PANEL_RTOL of its vector apply, E2 launches per restart 1 (8 in the
    column loop), the panel's cached block one E2 launch and the routed
    kernels, wall and CUDA-event µs per cached block apply of both (marginal
    over 1 and 3 applies). (b) LOBPCG (k = 4, smallest, tol 0, LOB14I_ITERS
    iterations) on 11a's 2048² Laplacian with M = its CG inverse (tol 1e-2,
    maxiter 10) through ``loop_modes`` (the per-iteration loop and captured
    blocks, bit for bit): one while node per M apply and E1 in the cached
    block (4 while nodes with M's column loop, run the same way), θ within
    its residual of the closed-form eigenvalues, wall and CUDA-event µs per
    iteration of both (marginal over LOB14I_ITERS and twice as many), and of
    the panel with the loop's own ``where`` as well (``loop_where``: what
    ``device_while(keeps=True)`` saves; bit for bit). (c) (b) on
    ``stencil_partition_2d`` (a 1x1 mesh, NCCL): θ and X bit for bit the same
    arithmetic unsharded (13i a's twin), within rounding of (b)'s, one while
    node per M apply, no collective in an inner iteration. The busy shares
    and kernel µs printed beside are torch.profiler trace readings, which no
    comparison rests on. The launch counts are those of the panel path's
    runs alone (``on_panel``: set to 0 just before each, read just after),
    not of the column loop's, the yardsticks' or the collective probes'.
    Returns (record, launches)."""
    from linops_tpu_torch.kernels import small_lstsq as E2
    from linops_tpu_torch.parallel import collective_counts, make_mesh2d, stencil_partition_2d
    from linops_tpu_torch.parallel.comm import gather_full
    from linops_tpu_torch.utils import krylov

    t_phase = time.perf_counter()
    f32 = torch.float32
    rec = {}
    launches = {}

    def on_panel(fn):
        """fn() with every launch count set to 0 just before it and read just
        after, added to the panel path's launches (the column loop's runs,
        the yardsticks and the probes stay out)."""
        for m_ in mods:
            m_.reset_launch_counts()
        out = fn()
        for name, c_ in all_launches(mods).items():
            launches[name] = launches.get(name, 0) + c_
        return out

    def fmt(v, spec):
        return "not measured" if v is None else format(v, spec)

    # --- 14i a. the GMRES inverse on an (n, 8) block ---------------------------------------
    free()
    A2 = ops["A2"]
    n2 = A2.shape[0]
    S = lt.ShiftedOperator(ops["op2"], 8.0)
    M = lt.opIterativeInverse(S, tol=1e-2, maxiter=30)
    check(M._resolved(S) == "gmres", f"14i a: the inverse takes {M._resolved(S)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 190)
    B = (2 * torch.randint(0, 2, (n2, PANEL_K), generator=gen, device=dev) - 1).to(f32)

    def panel():
        return M.apply_matrix(B)

    def columns():
        return torch.stack([M.apply(B[:, j]) for j in range(PANEL_K)], dim=1)

    # launches counted in eager blocks (a replay launches nothing, a capture records once)
    loop.clear_cache()
    loop.CAPTURE = False
    try:
        X, counts, _ = on_panel(lambda: M._solve(B, "N", False))
        e2_panel = E2.launch_counts()["small_lstsq"]
        E2.reset_launch_counts()
        vec = [M.solve_info(B[:, j]) for j in range(PANEL_K)]
        e2_cols = E2.launch_counts()["small_lstsq"]
    finally:
        loop.CAPTURE = True
    loop.clear_cache()
    X_cols = torch.stack([v[0] for v in vec], dim=1)
    col_counts = [int(v[1]) for v in vec]
    errs = ((X - X_cols).norm(dim=0) / X_cols.norm(dim=0)).tolist()
    restarts = int(counts.max())
    check(counts.tolist() == col_counts and max(errs) <= PANEL_RTOL and torch.isfinite(X).all()
          and tuple(X.shape) == (n2, PANEL_K),
          f"14i a: restarts per column {counts.tolist()} (vector applies {col_counts}), "
          f"relative error per column {errs} (limit {PANEL_RTOL:g})")
    check(e2_panel == restarts and e2_cols == sum(col_counts),
          f"14i a: E2 launches {e2_panel} over {restarts} panel restarts, {e2_cols} over the "
          f"column loop's {sum(col_counts)} restarts")
    times = {}
    for name, fn in (("panel", panel), ("columns", columns)):
        # a signature's first solve (the plain loop), then its capture
        (on_panel if name == "panel" else (lambda f: f()))(lambda: (fn(), fn()))
        g_ = loop.last_graph()
        wall, event = marginal_us(lambda n_: [fn() for _ in range(n_)], 1, 3)
        trace_ms = device_profile(fn)[0]
        times[name] = dict(wall_us=wall, event_us=event,
                           trace_us=None if trace_ms is None else trace_ms * 1e3,
                           trace_busy=None if trace_ms is None else trace_ms * 1e3 / wall,
                           held=dict(g_.launches) if g_ is not None else {})
    held = times["panel"]["held"]
    check(held.get("small_lstsq") == 1 and all(held.get(n_, 0) > 0 for n_ in ROUTED_14I),
          f"14i a: the panel's cached block (one restart) recorded {held}: not one E2 launch "
          f"and the routed kernels {ROUTED_14I}")
    Mc = column_loop(lt, M)
    tr = []
    for op, run in ((M, on_panel), (Mc, lambda f: f())):
        gen.manual_seed(SEED + 191)
        tr.append(run(lambda: lt.estimate_trace(op, probes=PANEL_K, method="hutchinson",
                                                generator=gen)))
    tr_rel = abs(float(tr[0][0]) - float(tr[1][0])) / abs(float(tr[1][0]))
    check(np.isfinite(float(tr[0][0])) and tr_rel <= PANEL_RTOL,
          f"14i a: estimate_trace {float(tr[0][0])} against the column loop's {float(tr[1][0])}")
    rec["a"] = dict(restarts=counts.tolist(), errs=errs, e2=(e2_panel, e2_cols), times=times,
                    trace=(float(tr[0][0]), float(tr[1][0])))
    tp, tc = times["panel"], times["columns"]

    def timing(t_):
        return (f"wall {t_['wall_us']:.1f} us, CUDA events {t_['event_us']:.1f} us (marginal "
                f"over 1 and 3 applies); trace reading: kernels {fmt(t_['trace_us'], '.1f')} us, "
                f"busy {fmt(t_['trace_busy'], '.2f')}")

    print(f"[14i device loop] 14i a: M = opIterativeInverse(auto_8m + 8I, tol 1e-2, maxiter 30, "
          f"auto: gmres(30)) on an (n = 2^19, {PANEL_K}) Rademacher block: one panel solve, "
          f"restarts per column {counts.tolist()} = its vector applies', max relative error per "
          f"column {max(errs):.2e} (limit {PANEL_RTOL:g}); E2 launches {e2_panel} for "
          f"{restarts} restart(s) of the panel, {e2_cols} for the column loop's "
          f"{sum(col_counts)}; cached block apply: panel {timing(tp)}; column loop "
          f"{timing(tc)}; event ratio {tp['event_us'] / tc['event_us']:.3f}, wall ratio "
          f"{tp['wall_us'] / tc['wall_us']:.3f}; the panel's block recorded {held}; "
          f"estimate_trace (Hutchinson, {PANEL_K} probes) {float(tr[0][0]):.6e}, column loop "
          f"{float(tr[1][0]):.6e} (relative {tr_rel:.2e}); {card}", flush=True)
    del S, M, Mc, B, X, X_cols, vec
    free()

    # --- 14i b. LOBPCG on the 2048² Laplacian with a CG inverse as M -------------------------
    g = GRID11
    n = g * g
    L = lt.laplacian_2d(g, g)
    inner = dict(solver="cg", tol=1e-2, maxiter=10)

    def lob(op, Mop, iters=LOB14I_ITERS):
        gen.manual_seed(SEED + 192)
        return lt.lobpcg(op, k=LOB14I_K, largest=False, tol=0.0, maxiter=iters, generator=gen,
                         M=Mop)

    def inspect_with(per_iteration_nodes, tag):
        def inspect(gr):
            w = while_nodes_of(gr)
            check(w == per_iteration_nodes * loop.BLOCK and len(gr.bodies) == w
                  and gr.launches.get("while_condition", 0) == 2 * w
                  and gr.launches.get("small_eigh", 0) > 0,
                  f"{tag}: the cached block holds {w} while nodes ({len(gr.bodies)} bodies), "
                  f"recorded {gr.launches}: not {per_iteration_nodes} per iteration, or no E1")
        return inspect

    def per_iteration_us(op, Mop):
        """(wall, CUDA-event) µs per LOBPCG iteration of cached solves,
        marginal over LOB14I_ITERS and twice as many iterations."""
        for it_ in (LOB14I_ITERS, 2 * LOB14I_ITERS):  # each length's plain solve and capture
            got = [lob(op, Mop, it_)[3] for _ in range(2)]
            check(got == [it_, it_], f"14i: LOBPCG ran {got} iterations, not {it_}")
        return marginal_us(lambda it_: lob(op, Mop, it_), LOB14I_ITERS, 2 * LOB14I_ITERS)

    ML = lt.opIterativeInverse(L, **inner)
    MLc = column_loop(lt, ML, symmetric=True, hermitian=True)
    out_b = {}
    for name, Mop, per in (("panel", ML, 1), ("columns", MLc, LOB14I_K)):
        def solve(Mop=Mop):
            th, X, res, it = lob(L, Mop)
            return torch.cat([th, X.reshape(-1)]), it, res

        tag = (f"14i b lobpcg(k={LOB14I_K}, smallest, tol 0, {LOB14I_ITERS} iterations) on the "
               f"{g}² Laplacian, M = opIterativeInverse(L, cg, tol 1e-2, maxiter 10)"
               + (" behind its column loop" if name == "columns" else ""))
        out_b[name] = (on_panel if name == "panel" else (lambda f: f()))(
            lambda: loop_modes(loop, tag, solve, phase="14i",
                               inspect=inspect_with(per, f"14i b {name}")))
    # card time per iteration by CUDA events: the panel, its column loop, and
    # the panel with the loop's own where as well (keeps off), on, off, off, on
    ev = {"columns": per_iteration_us(L, MLc)}
    for name in ("keeps", "where", "where", "keeps"):
        with (loop_where(loop) if name == "where" else contextlib.nullcontext()):
            ev.setdefault(name, []).append(on_panel(lambda: per_iteration_us(L, ML)))
    with loop_where(loop):
        th_w, X_w, _, _ = lob(L, ML)
    ML.reset_inner_iterations()
    th, X, res, it = on_panel(lambda: lob(L, ML))
    inner_b = ML.inner_iterations
    th_c, _, _, it_c = lob(L, MLc)
    r64, gaps = closed_form_gaps(five_point(g), g, th, X)
    dth = float((th - th_c).abs().max() / th.abs().max())
    check(it == it_c == LOB14I_ITERS and torch.isfinite(th).all() and torch.isfinite(X).all()
          and tuple(X.shape) == (n, LOB14I_K) and dth <= PANEL_RTOL,
          f"14i b: {it} / {it_c} iterations, θ {th.tolist()} against the column loop's "
          f"{th_c.tolist()} ({dth:.2e} relative, limit {PANEL_RTOL:g})")
    check(torch.equal(th_w, th) and torch.equal(X_w, X),
          "14i b: the panel solve with the loop's own where differs from keeps")
    keeps = [float(np.median([e for _, e in ev[k_]])) for k_ in ("keeps", "where")]
    rb, rc = out_b["panel"], out_b["columns"]
    rec["b"] = dict(panel=rb, columns=rc, theta=th.tolist(), inner=inner_b,
                    event_us=dict(panel=ev["keeps"], columns=ev["columns"], where=ev["where"]))

    def loop_line(r, ev_):
        return (f"wall {r['wall_us_per_iter'][1]:.1f} us per iteration (median cached solve), "
                f"marginal wall {ev_[0]:.1f} us and CUDA events {ev_[1]:.1f} us per iteration; "
                f"trace reading: kernels {fmt(r['device_us_per_iter'][1], '.1f')} us, busy "
                f"{fmt(r['busy'][1], '.2f')}; {r['while_nodes'] // loop.BLOCK} while node(s) per "
                f"iteration")

    print(f"[14i device loop] 14i b: LOBPCG k = {LOB14I_K} on the {g}² Laplacian with M = its "
          f"CG inverse: {it} iterations, θ {[float(f'{t_:.6e}') for t_ in th]}, f64 residuals "
          f"{[float(f'{x:.3e}') for x in r64]}, distance to the nearest closed-form eigenvalue "
          f"{[float(f'{x:.3e}') for x in gaps]}; {inner_b} inner CG iterations summed over the "
          f"solve's M applies; cached blocks: panel solve {loop_line(rb, ev['keeps'][0])}; M's "
          f"column loop {loop_line(rc, ev['columns'])}; CUDA events per iteration, panel "
          f"against the column loop {ev['keeps'][0][1] / ev['columns'][1]:.3f}; the panel "
          f"without the loop's where (keeps) {[round(e, 1) for _, e in ev['keeps']]} us, with it "
          f"{[round(e, 1) for _, e in ev['where']]} us (on, off, off, on; median ratio "
          f"{keeps[1] / keeps[0]:.3f}), θ and X bit for bit; θ {dth:.2e} apart (relative); "
          f"{card}", flush=True)

    # --- 14i c. the same on stencil_partition_2d (a 1x1 mesh) -------------------------------
    L2 = stencil_partition_2d(torch.tensor([4.0, -1.0, -1.0, -1.0, -1.0], device=dev), g, g,
                              make_mesh2d(1, 1))
    twin = loop_function(lt, n, n, lambda v: L2.apply(v).to_local(), symmetric=True,
                         hermitian=True, dtype=f32, capture_safe=True)
    M2, Mt = lt.opIterativeInverse(L2, **inner), lt.opIterativeInverse(twin, **inner)

    def solve2():
        th_, X_, res_, it_ = lob(L2, M2)
        return torch.cat([gather_full(th_), gather_full(X_).reshape(-1)]), it_, res_

    r_c = on_panel(lambda: loop_modes(
        loop, f"14i c lobpcg(k={LOB14I_K}, smallest, tol 0, {LOB14I_ITERS} iterations) on "
        f"stencil_partition_2d ({g}², a 1x1 mesh), M = its CG inverse", solve2, phase="14i",
        inspect=inspect_with(1, "14i c")))
    ev_c = on_panel(lambda: per_iteration_us(L2, M2))
    th2, X2, _, it2 = on_panel(lambda: lob(L2, M2))
    th_t, X_t, _, it_t = lob(twin, Mt)
    bits = (it2 == it_t and torch.equal(gather_full(th2), th_t)
            and torch.equal(gather_full(X2), X_t))
    dth2 = float((gather_full(th2) - th).abs().max() / th.abs().max())
    Pt = torch.randn((LOB14I_K, n), generator=gen, device=dev)
    per = [collective_counts(lambda: krylov._solve_panel("cg", L2, Pt, rows=True, tol=0.0,
                                                         maxiter=m_))
           for m_ in (loop.BLOCK, 2 * loop.BLOCK)]
    coll = {c_: (per[1][c_] - per[0][c_]) / loop.BLOCK for c_ in per[0]}
    check(bits and r_c["bits"] and dth2 <= PANEL_RTOL and all(v_ == 0 for v_ in coll.values()),
          f"14i c: against the same arithmetic unsharded: {it2} / {it_t} iterations, bit for bit "
          f"{bits}; θ {dth2:.2e} from 14i b's (limit {PANEL_RTOL:g}); collectives per inner "
          f"iteration {coll}")
    rec["c"] = dict(r_c, dtheta_b=dth2, collectives=coll, event_us=ev_c)
    print(f"[14i device loop] 14i c: LOBPCG with M = the CG inverse on stencil_partition_2d "
          f"({g}², a 1x1 mesh, NCCL): θ and X bit for bit the same arithmetic unsharded "
          f"(13i a's twin), θ {dth2:.2e} from 14i b's (the halo stencil sums in another order); "
          f"collectives per inner iteration {coll}; cached blocks: {loop_line(r_c, ev_c)}; CUDA "
          f"events per iteration against 14i b's panel {ev_c[1] / ev['keeps'][0][1]:.3f}; "
          f"phase {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    del L, ML, MLc, L2, twin, M2, Mt, X, X2, X_t, X_w
    free()
    return rec, launches


# ----------------------------------------------------------------------------
# Slice 10: LOBPCG, svds and normest on the device loop, with E1
# ----------------------------------------------------------------------------

E1_SOURCE = "linops_tpu_torch/kernels/csrc/small_eigh.cu"
# E1 has no Pallas site: it replaces the jnp.linalg.eigh that XLA lowers inside
# the reference's LOBPCG loop (the Rayleigh-Ritz step; also :76, the SVQB transforms)
E1_REPLACES = "linops_tpu/utils/eig.py:130"
E1_SIZES = (1, 2, 6, 24, 96, 150)
E1_BLOCKED_SIZES = (24, 32, 33, 48, 64, 96, 100, 128, 150)  # the blocked kernels, named
E1_BLOCKED = ("blocked", "cluster")  # E1's kernels above m0: one CTA, a cluster
E1_TIMED = (2, 6, 24, 32, 48, 64, 96, 128, 150)  # the Jacobi kernel (both blocked from 24), eigh
E1_TOL = 50  # |Δλ|, ‖AV − VΛ‖₂ over eps·‖A‖₂, and max|VᴴV − I| over eps
LOB_ITERS = 40  # phase 15b: LOBPCG iterations per solve (tol 0), as phase 11b
# 15b, 15c (15e: or the eigh loop's distance): θ of a solve with eigh in E1's
# place, within this many f32 ulps of ‖A‖₂ (a rounding-level change to the
# small eigensolver moves a 40-iteration tol-0 LOBPCG's θ by a few ulps: X
# drifts inside clusters of eigenvalues 1e-6 apart)
SWAP_ULPS = 16
LOB32_K, LOB32_ITERS = 32, 8  # phase 15e: the wide block, iterations per solve
SOLVER_KERNELS = re.compile(r"syev|sytrd|stedc|ormtr|orgtr|potrf|geqrf|cusolver", re.I)


CAT_KERNEL = "CatArrayBatchedCopy"  # torch.cat's kernel: a stacked column loop shows as it
CUBLAS_KERNELS = re.compile(r"gemm|cutlass|splitKreduce|xmma", re.I)  # cuBLAS's own kernels


def block_nodes(names) -> dict:
    """A captured block's kernel nodes: all, cuBLAS's, the rest (the
    program's own), and torch.cat's among them."""
    lib = sum(bool(CUBLAS_KERNELS.search(n_)) for n_ in names)
    return {"all": len(names), "cuBLAS": lib, "own": len(names) - lib,
            "cat": sum(CAT_KERNEL in n_ for n_ in names)}


def phase13i(lt, loop, E1, K, LG, dev, card, ops, main, rec15):
    """Spectral routines, estimators and checks on distributed operators, in
    the world of one NCCL rank, at full width; each against the unsharded
    call with the same generator, bit for bit, and each output's placement
    against the reference's (blocks split by rows or replicated as GSPMD
    places them, small results replicated). (a) LOBPCG (k = 2, largest,
    gram, tol 0, LOB_ITERS iterations) on 11a's 2048² Laplacian through
    ``stencil_partition_2d``, both ways through ``loop_modes``: θ, X and the
    count bit for bit the same arithmetic as a plain operator (the halo
    stencil's local apply), θ within its residual of the closed-form
    eigenvalues, reads per cached solve 15b's, the collectives of one
    iteration (at most two all-reduces per mesh dimension), E1 and
    no cuSOLVER kernel in the block; then k = 32 for 15e's LOB32_ITERS
    iterations (E1's cluster kernel, m = 96); wall and device µs per
    iteration and the busy share beside 15b's and 15e's unsharded numbers;
    the cached block's kernel nodes other than cuBLAS's no more at k = 32
    than at k = 2 (the stencil applies a panel as one program, its exchange
    batched), and its ``torch.cat`` nodes.
    (b) svds, normest, check_ctranspose and check_hermitian of phase 4's B
    through ``shard_operator`` (K1, K2). (c) rsvd of auto_8m through
    ``shard_operator`` (its replicated program: K7, K9-K11, K12). (d) the
    estimators of 11c on I + L over 2048² through ``shard_operator``,
    within 11c's limits of the exact values. (e) the Nyström preconditioner
    of slice 1's graph ((A + Aᴴ)/2: the sketch needs the hermitian flag)
    through ``shard_operator`` as M of its CG with a plain b, both ways: x
    split by rows, bit for bit the unsharded solve's.
    The launch counts are set to 0 before the phase and read after it.
    Returns (launches, seconds)."""
    from linops_tpu_torch.parallel import (collective_counts, make_mesh, make_mesh2d,
                                           shard_operator, stencil_partition_2d)
    from linops_tpu_torch.parallel.comm import gather_full, is_dtensor
    from linops_tpu_torch.utils.eig import nystrom_preconditioner

    t_phase = time.perf_counter()
    f32 = torch.float32
    mesh = make_mesh()
    mods = (K, LG, E1)
    for m_ in mods:
        m_.reset_launch_counts()
    gen = torch.Generator(device=dev)

    def kind(t):
        """A result's placement in the reference's words."""
        if not is_dtensor(t):
            return type(t).__name__
        return "row" if any(p.is_shard() for p in t.placements) else "replicated"

    def kinds(out):
        return tuple(kind(t) for t in out)

    def same(a, b):
        """Bit for bit, a DTensor gathered first; numbers by value."""
        if isinstance(a, torch.Tensor):
            return torch.equal(gather_full(a), gather_full(b))
        return a == b

    def seeded(call, seed):
        gen.manual_seed(seed)
        return call()

    # --- 13i a. LOBPCG on the 2048² Laplacian through stencil_partition_2d ---------------
    free()
    g = GRID11
    n = g * g
    L2 = stencil_partition_2d(torch.tensor([4.0, -1.0, -1.0, -1.0, -1.0], device=dev), g, g,
                              make_mesh2d(1, 1))
    twin = loop_function(lt, n, n, lambda v: L2.apply(v).to_local(), symmetric=True,
                         hermitian=True, dtype=f32, capture_safe=True)

    def lob(op, k=2, iters=LOB_ITERS):
        gen.manual_seed(SEED + 112)  # 15b's seed
        return lt.lobpcg(op, k=k, largest=True, tol=0.0, maxiter=iters, generator=gen)

    def solve():
        th, X, res, it = lob(L2)
        return torch.cat([gather_full(th), gather_full(X).reshape(-1)]), it, res

    seen = {}

    def inspect(gr):
        names = graph_kernel_names(gr)
        seen["solver"] = sorted({n_ for n_ in names if SOLVER_KERNELS.search(n_)})
        seen["nodes"] = block_nodes(names)

    r_a = loop_modes(loop, f"13i a lobpcg(k=2, largest, gram, tol 0, {LOB_ITERS} iterations) on "
                     f"stencil_partition_2d ({g}², a 1x1 mesh), f32", solve, phase="13i",
                     inspect=inspect)
    th, X, res, it = lob(L2)
    th_t, X_t, res_t, it_t = lob(twin)
    bits_a = (it == it_t and torch.equal(gather_full(th), th_t)
              and torch.equal(gather_full(X), X_t) and torch.equal(gather_full(res), res_t))
    r64, gaps = closed_form_gaps(five_point(g), g, gather_full(th), gather_full(X))
    per_it = [collective_counts(lambda: lob(L2, iters=m_)) for m_ in (loop.BLOCK, 2 * loop.BLOCK)]
    coll_a = {c_: (per_it[1][c_] - per_it[0][c_]) / loop.BLOCK for c_ in per_it[0]}
    rec15b = rec15["15b"]
    check(kinds((th, X, res)) == ("replicated", "row", "replicated") and bits_a,
          f"13i a: placements {kinds((th, X, res))}, against the same arithmetic unsharded: "
          f"{it} / {it_t} iterations, bit for bit {bits_a}")
    check(r_a["iters"] == LOB_ITERS and r_a["bits"] and r_a["reads"][1] == rec15b["reads"][1],
          f"13i a: {r_a['iters']} iterations, both loops bit for bit {r_a['bits']}, reads per "
          f"cached solve {r_a['reads'][1]} (15b {rec15b['reads'][1]})")
    # two all-reduces per mesh dimension (the joint Gram, the residual norms) at most: on a
    # one-rank mesh DTensor may issue none; never an all-gather of a block
    check(all(v_ == 0 for c_, v_ in coll_a.items() if c_ != "all-reduce")
          and coll_a["all-reduce"] <= 4,
          f"13i a: collectives per iteration {coll_a} (at most two all-reduces per mesh "
          "dimension, nothing else)")
    check(r_a["nodes"].get("small_eigh_kernel", 0) == 4 * loop.BLOCK and not seen["solver"],
          f"13i a: the cached block holds {r_a['nodes']}, cuSOLVER kernels {seen['solver']}")
    # k = 32: E1's cluster kernel at m = 96
    E1.reset_launch_counts()
    for _ in range(2):  # the signature's first solve, then its capture
        th32, _, _, it32 = lob(L2, k=LOB32_K, iters=LOB32_ITERS)
    (th32, it32), s32 = median_solve(lambda: lob(L2, k=LOB32_K, iters=LOB32_ITERS)[::3])
    l32 = E1.launch_counts()
    check(loop.stats["replays"] > 0 and loop.stats["captures"] == 0 and it32 == LOB32_ITERS
          and l32["small_eigh_cluster"] > 0 and kind(th32) == "replicated",
          f"13i a k = {LOB32_K}: {it32} iterations, {loop.stats}, E1 launches {l32}")
    nodes2, nodes32 = seen["nodes"], block_nodes(graph_kernel_names(loop.last_graph()))
    # a block apply is one program whatever k: the block's kernels do not grow with it
    # (cuBLAS picks other kernels, split-K reductions among them, for the wider Grams)
    check(nodes32["own"] <= nodes2["own"],
          f"13i a: the cached block holds {nodes32} kernel nodes at k = {LOB32_K} and {nodes2} "
          f"at k = 2 (blocks of {loop.BLOCK} iterations)")
    d32, top32 = device_profile(lambda: lob(L2, k=LOB32_K, iters=LOB32_ITERS), top=4)
    us32 = s32 * 1e6 / it32
    dev32 = "not measured" if d32 is None else f"{d32 * 1e3 / it32:.1f} (top: " + ", ".join(
        f"{n_} {ms * 1e3 / it32:.1f}" for n_, ms in top32) + ")"
    busy32 = "not measured" if d32 is None else f"{d32 / (s32 * 1e3):.2f}"
    rec15e = rec15["15e"]
    print(f"[13i a distributed lobpcg] lobpcg(k=2, largest, gram, tol 0) on "
          f"stencil_partition_2d ({g}², n = {n}, a 1x1 mesh), world size 1: θ replicated, X split "
          f"by rows, residuals replicated; {it} iterations; θ, X, residuals bit for bit the "
          f"same stencil arithmetic as a plain operator; θ {[round(float(t_), 6) for t_ in th.full_tensor()]}, "
          f"f64 residuals {[float(f'{x:.3e}') for x in r64]}, distance to the nearest "
          f"closed-form eigenvalue {[float(f'{x:.3e}') for x in gaps]} (limit: residual + "
          f"1e-5·θ); collectives per iteration {coll_a}; a cached solve {r_a['reads'][1]} reads "
          f"(15b {rec15b['reads'][1]}); the block holds {r_a['nodes'].get('small_eigh_kernel', 0)} "
          f"E1 nodes per block of {loop.BLOCK}, no cuSOLVER kernel; wall µs per iteration "
          f"{r_a['wall_us_per_iter'][0]:.1f} per-iteration -> {r_a['wall_us_per_iter'][1]:.1f} "
          f"captured, device {r_a['device_us_per_iter']}, busy {r_a['busy']}; 15b unsharded "
          f"(laplacian_2d) in this call: wall {rec15b['wall_us_per_iter']}, device "
          f"{rec15b['device_us_per_iter']}, busy {rec15b['busy']}; k = {LOB32_K}, "
          f"{it32} iterations: {us32:.1f} us per iteration in cached blocks, device {dev32}, "
          f"busy {busy32} (15e unsharded {rec15e['e1_us']:.1f}), E1 launches {l32}; kernel "
          f"nodes per iteration in the cached block at k = 2 and {LOB32_K}: "
          + ", ".join(f"{w_} {nodes2[w_] / loop.BLOCK:.2f} and {nodes32[w_] / loop.BLOCK:.2f}"
                      for w_ in nodes2) + f"; {card}", flush=True)
    del L2, twin, X, X_t, th32

    # --- 13i b. svds, normest and the checks of phase 4's B through shard_operator ---------
    free()
    B = lt.BSROperator(lt.BSR(main["blocks"], main["cols"], (N, N)))
    B_sh = shard_operator(B, mesh)
    calls_b = {
        "svds": (lambda o: lt.svds(o, k=4, tol=1e-4, maxiter=150, generator=gen), SEED + 113),
        "normest": (lambda o: lt.normest(o, tol=1e-6, maxiter=300, generator=gen), SEED + 114),
        "check_ctranspose": (lambda o: (lt.check_ctranspose(o, gen),), SEED + 120),
        "check_hermitian": (lambda o: (lt.check_hermitian(o, gen),), SEED + 121)}
    want_b = {"svds": ("row", "replicated", "replicated", "replicated", "int"),
              "normest": ("float", "int"), "check_ctranspose": ("bool",),
              "check_hermitian": ("bool",)}
    out_b = {}
    for name, (call, seed) in calls_b.items():
        got, un = seeded(lambda: call(B_sh), seed), seeded(lambda: call(B), seed)
        out_b[name] = (kinds(got), all(same(a, b_) for a, b_ in zip(got, un)))
        check(out_b[name] == (want_b[name], True),
              f"13i b {name}: placements {kinds(got)} (the reference's {want_b[name]}), bit for "
              f"bit the unsharded call {out_b[name][1]}")
    ct = calls_b["check_ctranspose"][0](B_sh)[0]
    check(ct, "13i b: check_ctranspose of the sharded B is False")
    print(f"[13i b distributed svds] svds(k=4, tol 1e-4), normest (tol 1e-6), check_ctranspose, "
          f"check_hermitian of phase 4's B (8x128, n = {N}) through shard_operator, world size 1: "
          f"placements and bits against the unsharded calls {out_b}", flush=True)
    del B, B_sh

    # --- 13i c. rsvd of auto_8m through shard_operator (replicated program) ------------------
    free()
    op2 = ops["op2"]
    op2_sh = shard_operator(op2, mesh)
    rs = lambda o: lt.rsvd(o, 4, oversample=4, power_iters=1, generator=gen)  # noqa: E731 (11b)
    got, un = seeded(lambda: rs(op2_sh), SEED + 116), seeded(lambda: rs(op2), SEED + 116)
    bits_c = all(same(a, b_) for a, b_ in zip(got, un))
    check(kinds(got) == ("replicated",) * 3 and bits_c,
          f"13i c rsvd: placements {kinds(got)}, bit for bit the unsharded call {bits_c}")
    print(f"[13i c distributed rsvd] rsvd(k=4, oversample 4, power_iters 1) of auto_8m (n = 2^19) "
          f"through shard_operator (routing programs replicated), world size 1: U, s, V "
          f"replicated, bit for bit the unsharded call; σ "
          f"{[round(float(v), 5) for v in got[1].full_tensor()]}", flush=True)
    del op2_sh, got, un

    # --- 13i d. the estimators on I + L over 2048² through shard_operator -----------------
    free()
    A11 = lt.laplacian_2d(g, g) + lt.opEye(n, dtype=f32)
    A11_sh = shard_operator(A11, mesh)
    kd = 64
    calls_d = {"estimate_trace": (lambda o: lt.estimate_trace(o, probes=36, generator=gen),
                                  SEED + 117),
               "estimate_diagonal": (lambda o: lt.estimate_diagonal(o, probes=kd, generator=gen),
                                     SEED + 118),
               "estimate_logdet": (lambda o: lt.estimate_logdet(o, probes=16, lanczos_steps=30,
                                                                generator=gen), SEED + 119)}
    want_d = {"estimate_trace": ("float", "float"), "estimate_diagonal": ("row", "row"),
              "estimate_logdet": ("float", "float")}
    out_d = {}
    for name, (call, seed) in calls_d.items():
        got, un = seeded(lambda: call(A11_sh), seed), seeded(lambda: call(A11), seed)
        out_d[name] = got
        bits = all(same(a, b_) for a, b_ in zip(got, un))
        check(kinds(got) == want_d[name] and bits,
              f"13i d {name}: placements {kinds(got)}, bit for bit the unsharded call {bits}")
    tr, tr_se = out_d["estimate_trace"]
    dg = out_d["estimate_diagonal"][0].full_tensor()
    ld, ld_se = out_d["estimate_logdet"]
    ld_true = float(np.sum(np.log(1.0 + laplacian_eigenvalues(g))))
    d_err = float((dg.double() - 5.0).abs().max())
    d_lim = 6 * (4.0 / kd) ** 0.5
    check(abs(tr - 5 * n) < 6 * tr_se and d_err <= d_lim and abs(ld - ld_true) < 6 * ld_se,
          f"13i d: trace {tr} ± {tr_se} against {5 * n}, diagonal max|Δ| {d_err:.3f} (limit "
          f"{d_lim:.3f}), logdet {ld} ± {ld_se} against {ld_true}")
    print(f"[13i d distributed estimators] I + L on {g}² through shard_operator, world size 1: "
          f"trace {tr:.1f} against 5n = {5 * n} (stderr {tr_se:.1f}), diagonal (split by rows) "
          f"max|Δ| from 5 {d_err:.3f} (limit {d_lim:.3f}), logdet {ld:.1f} against {ld_true:.1f} "
          f"(stderr {ld_se:.1f}); each bit for bit the unsharded call with 11c's seed", flush=True)
    del A11, A11_sh, out_d, dg

    # --- 13i e. the Nyström preconditioner of slice 1's graph as M of its CG ---------------
    free()
    A, b = main["A"], main["b"]
    A_sh = shard_operator(A, mesh)
    # the sketch needs the hermitian flag, which a composition drops: (A + Aᴴ)/2
    Ah = A.hermitianized()
    nys = lambda o: nystrom_preconditioner(o, 20, generator=gen)  # noqa: E731
    P_sh = seeded(lambda: nys(shard_operator(Ah, mesh)), SEED + 122)
    P_un = seeded(lambda: nys(Ah), SEED + 122)
    check(kinds((P_sh.U, P_sh.lam)) == ("replicated",) * 2 and same(P_sh.U, P_un.U)
          and same(P_sh.lam, P_un.lam),
          f"13i e: U and lam placed {kinds((P_sh.U, P_sh.lam))}, bit for bit the unsharded sketch "
          f"{same(P_sh.U, P_un.U)} {same(P_sh.lam, P_un.lam)}")
    last = {}

    def solve_e():
        x_, k_, r_ = lt.cg(A_sh, b, M=P_sh, tol=1e-5, maxiter=500)
        last["x"] = x_
        return gather_full(x_), k_, r_

    r_e = loop_modes(loop, f"13i e cg on shard_operator(slice 1's graph) (n = {N}), b plain, M "
                     "the sharded operator's Nyström preconditioner (rank 20), tol 1e-5", solve_e,
                     phase="13i")
    x_un, k_un, _ = lt.cg(A, b, M=P_un, tol=1e-5, maxiter=500)
    check(kind(last["x"]) == "row" and r_e["iters"] == k_un and r_e["bits"]
          and torch.equal(gather_full(last["x"]), x_un)
          and r_e["reads"][1] == -(-k_un // loop.BLOCK),
          f"13i e: x placed {kind(last['x'])}, {r_e['iters']} iterations (unsharded {k_un}), "
          f"bit for bit {r_e['bits']} / {torch.equal(gather_full(last['x']), x_un)}, "
          f"{r_e['reads'][1]} reads in a cached solve")
    print(f"[13i e distributed nystrom] nystrom_preconditioner(rank 20) of shard_operator(slice "
          f"1's graph), world size 1: U and lam replicated, bit for bit the unsharded sketch; cg "
          f"with it and a plain b: x split by rows, {k_un} iterations, bit for bit the unsharded "
          f"solve's, {r_e['reads'][1]} reads in a cached solve", flush=True)
    del A_sh, Ah, P_sh, P_un

    launches = {k_: v_ for m_ in mods for k_, v_ in m_.launch_counts().items() if v_}
    seconds = time.perf_counter() - t_phase
    print(f"[13i distributed spectral path] launches {launches}; {seconds:.1f} s", flush=True)
    return launches, seconds


def eigh_ops(m, complex_=False) -> int:
    """Real operations an eigendecomposition of one Hermitian m x m matrix
    needs, whatever the method: about 9 m³ (tridiagonal reduction, implicit
    QR with vectors, back-transformation; Golub & Van Loan §8.3), 4 real for
    each complex one."""
    return 9 * m ** 3 * (4 if complex_ else 1)


def e1_errors(A, w, V):
    """(max |Δλ| against the plain version on A widened to f64/c128 over
    eps·‖A‖₂, ‖AV − VΛ‖₂ over eps·‖A‖₂, max|VᴴV − I| over eps), eps of A's
    precision; the lower triangle of A read, as eigh reads it."""
    wide = torch.complex128 if A.is_complex() else torch.float64
    eps = torch.finfo(w.dtype).eps
    Ah = A.to(wide).tril()
    Ah = Ah + Ah.tril(-1).mH
    if Ah.is_complex():
        Ah.diagonal(dim1=-2, dim2=-1).imag.zero_()
    w_ref = torch.linalg.eigh(Ah)[0].double()
    norm2 = w_ref.abs().amax(-1).clamp_min(1e-300)
    Vw = V.to(wide)
    dl = ((w.double() - w_ref).abs().amax(-1) / norm2).max() / eps
    res = (torch.linalg.matrix_norm(Ah @ Vw - Vw * w.to(wide)[..., None, :], ord=2)
           / norm2).max() / eps
    orth = (Vw.mH @ Vw - torch.eye(A.shape[-1], dtype=wide, device=A.device)).abs().max() / eps
    return float(dl), float(res), float(orth)


def hermitian(gen, dev, m, dtype, batch):
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32
    A = torch.randn((batch, m, m), generator=gen, device=dev, dtype=rdt)
    if dtype.is_complex:
        A = torch.complex(A, torch.randn((batch, m, m), generator=gen, device=dev, dtype=rdt))
    return A


def blocked_cases(gen, dev, m, dt):
    """A batch of 4 matrices of one size for the blocked kernel: random,
    diagonal (nothing to rotate), a repeated eigenvalue (Q diag(1, 1, 2, 2,
    ...) Qᴴ) and zero."""
    A = hermitian(gen, dev, m, dt, 4)
    A[1] = torch.diag(torch.randn(m, generator=gen, device=dev).to(dt))
    Q = torch.linalg.qr(hermitian(gen, dev, m, dt, 1)[0])[0]
    lam = (torch.arange(m, device=dev) // 2 + 1).to(Q.dtype)
    A[2] = (Q * lam) @ Q.mH
    A[3] = 0
    return A


def phase15a(E1, dev, card):
    """E1 against its plain version (torch.linalg.eigh) on the same inputs:
    f32, f64, c64, c128 at m in E1_SIZES through the dispatch by m, a batch
    of 2 random matrices each (not Hermitian: both read the lower triangle),
    within E1_TOL; sorted; a NaN matrix ends with NaN out. The blocked and
    cluster kernels, each named, in the four dtypes at m in E1_BLOCKED_SIZES
    (the cluster kernel's c128 to m = 128, where it fits) on a batch of mixed
    matrices (``blocked_cases``) within E1_TOL, the same bits on a rerun and
    as each matrix alone, a NaN matrix, and inside a CUDA graph (the eager
    bits, no sync). Then, in f32 at m in E1_TIMED, the Jacobi kernel's time
    and (from m = 24) both blocked kernels' per call in a CUDA graph of 20
    calls, their eager marginal events at the dispatch's choice, the plain
    version's (the library call: torch.linalg.eigh, eager, marginal events),
    and the bound: A, w and V's bytes over the memory rate against
    ``eigh_ops`` over 67 TFLOP/s. E1's gradient under autograd against
    eigh's (f64 and c128, m = 6). Both blocked kernels and eigh in f64 from
    m = 24 (printed). Returns (times by m, errors)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 150)
    worst = {}
    for dt in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        for m in E1_SIZES:
            A = hermitian(gen, dev, m, dt, 2)
            w, V, sw = E1.small_eigh(A, sweeps=True)
            torch.cuda.synchronize()
            errs = e1_errors(A, w, V)
            check(all(e <= E1_TOL for e in errs) and bool((w[:, 1:] >= w[:, :-1]).all()),
                  f"15a E1 {dt} m={m}: |Δλ|, residual, orthogonality {errs} (limit {E1_TOL})")
            worst[(str(dt)[6:], m)] = errs + (int(sw.max()),)
    A = hermitian(gen, dev, 96, torch.float32, 1)
    plain96 = e1_errors(A, *torch.linalg.eigh(A))
    A_nan = hermitian(gen, dev, 24, torch.float32, 2)
    A_nan[1, 4, 2] = float("nan")
    w, V, sw = E1.small_eigh(A_nan, sweeps=True)
    torch.cuda.synchronize()
    check(bool(torch.isnan(w[1]).all()) and int(sw[1]) == 0
          and torch.equal(w[0], E1.small_eigh(A_nan[:1])[0][0]),
          "15a E1: a NaN matrix did not end with NaN out, or changed its batch's other matrix")
    print("[15a E1] small_eigh against torch.linalg.eigh (eigenvalues: on the inputs widened "
          "to f64/c128), |Δλ|/(eps‖A‖₂), ‖AV − VΛ‖₂/(eps‖A‖₂), max|VᴴV − I|/eps, sweeps: "
          + "; ".join(f"{d_} m={m_} " + "/".join(f"{e:.1f}" for e in v[:3]) + f" ({v[3]})"
                      for (d_, m_), v in worst.items())
          + f" (limit {E1_TOL}); the plain version in f32 at m = 96: "
          + "/".join(f"{e:.1f}" for e in plain96)
          + "; a NaN matrix ends with NaN out (0 sweeps), its batch's other matrix unchanged",
          flush=True)
    for kern in E1_BLOCKED:
        blocked = {}
        for dt in (torch.float32, torch.float64, torch.complex64, torch.complex128):
            for m in E1_BLOCKED_SIZES:
                if kern == "cluster" and dt == torch.complex128 and m > 128:
                    continue  # its buffers pass the shared memory: the dispatch takes "blocked"
                A = blocked_cases(gen, dev, m, dt)
                w, V, sw = E1.small_eigh(A, sweeps=True, _kernel=kern)
                torch.cuda.synchronize()
                errs = e1_errors(A, w, V)
                check(all(e <= E1_TOL for e in errs) and bool((w[:, 1:] >= w[:, :-1]).all())
                      and int(sw.max()) < 30,
                      f"15a {kern} E1 {dt} m={m}: |Δλ|, residual, orthogonality {errs} (limit "
                      f"{E1_TOL}), sweeps {sw.tolist()}")
                w2, V2 = E1.small_eigh(A, _kernel=kern)
                w3, V3 = E1.small_eigh(A[2:3], _kernel=kern)
                check(torch.equal(w, w2) and torch.equal(V, V2) and torch.equal(w[2], w3[0])
                      and torch.equal(V[2], V3[0]),
                      f"15a {kern} E1 {dt} m={m}: other bits on a rerun or alone")
                blocked[(str(dt)[6:], m)] = errs + (sw.tolist(),)
        A_nan = hermitian(gen, dev, 64, torch.float32, 2)
        A_nan[0, 40, 3] = float("inf")
        w, V, sw = E1.small_eigh(A_nan, sweeps=True, _kernel=kern)
        torch.cuda.synchronize()
        check(bool(torch.isnan(w[0]).all() and torch.isnan(V[0]).all()) and int(sw[0]) == 0
              and torch.equal(w[1], E1.small_eigh(A_nan[1:], _kernel=kern)[0][0]),
              f"15a {kern} E1: an infinite entry did not end with NaN out")
        A = hermitian(gen, dev, 96, torch.float32, 1)
        w_e, V_e = E1.small_eigh(A, _kernel=kern)
        static = A.clone()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            w_g, V_g = E1.small_eigh(static, _kernel=kern)
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        check(torch.equal(w_g, w_e) and torch.equal(V_g, V_e),
              f"15a {kern} E1: a replay in a CUDA graph gave other bits")
        del graph
        print(f"[15a E1] the {kern} kernel (named) on batches of 4 (random, diagonal, a "
              "repeated eigenvalue, zero) against torch.linalg.eigh, |Δλ|, residual, "
              "orthogonality over eps and sweeps per matrix: "
              + "; ".join(f"{d_} m={m_} " + "/".join(f"{e:.1f}" for e in v[:3]) + f" {v[3]}"
                          for (d_, m_), v in blocked.items())
              + f" (limit {E1_TOL}); the same bits on a rerun and alone; an infinite entry "
              "ends with NaN out; a replay in a CUDA graph gives the eager bits, no sync",
              flush=True)
    grads = {}
    for dt in (torch.float64, torch.complex128):
        A = hermitian(gen, dev, 6, dt, 2)
        A = 0.5 * (A + A.mH)
        cw = torch.randn((2, 6), generator=gen, device=dev, dtype=torch.float64)
        cV = torch.randn((2, 6, 6), generator=gen, device=dev, dtype=torch.float64)

        def grad(eigh):
            A_ = A.clone().requires_grad_()
            w, V = eigh(A_)  # a loss of w and |V|²: blind to V's phases
            return torch.autograd.grad((cw * w).sum() + (cV * V.abs() ** 2).sum(), A_)[0]

        g_ref = grad(torch.linalg.eigh)
        grads[str(dt)[6:]] = float((grad(E1.small_eigh) - g_ref).abs().max() / g_ref.abs().max())
        check(grads[str(dt)[6:]] <= 1e-9, f"15a E1 {dt}: its gradient is {grads} off eigh's")
    print(f"[15a E1] gradient under autograd (eigh's backward on E1's w, V) against "
          f"torch.linalg.eigh's, max relative difference: {grads} (limit 1e-9)", flush=True)
    rows = {}
    for m in E1_TIMED:
        A = hermitian(gen, dev, m, torch.float32, 1)[0]
        w_p, V_p = torch.linalg.eigh(A)
        row = {"kernel": E1.kernel_for(m), "plain_ms": marginal_ms(lambda: torch.linalg.eigh(A)),
               "bound": bound_ms(nbytes(A, w_p, V_p), eigh_ops(m))}
        for kern in ("jacobi", *E1_BLOCKED) if m >= 24 else ("jacobi",):
            w, V, sw = E1.small_eigh(A, sweeps=True, _kernel=kern)
            row[kern] = {"ms": graph_ms(lambda: E1.small_eigh(A, _kernel=kern)),
                         "sweeps": int(sw), "max_abs_err": float((w - w_p).abs().max())}
        row["event_ms"] = marginal_ms(lambda: E1.small_eigh(A))
        row.update(row[row["kernel"]])  # the dispatch's kernel: the row's ms, sweeps, error
        rows[m] = row
    print("[15a E1] f32 per call (CUDA graph of 20: the Jacobi kernel / the blocked kernel / "
          "the cluster kernel; eager marginal events of the dispatch's choice; "
          "torch.linalg.eigh eager marginal events, the plain version and the library call; "
          "bound = 9 m³ operations over 67 TFLOP/s against the bytes of A, w and V over 3.35 "
          "TB/s): "
          + "; ".join(f"m={m} jacobi {r['jacobi']['ms'] * 1e3:.1f} us ({r['jacobi']['sweeps']} "
                      f"sweeps)"
                      + "".join(f" / {k} {r[k]['ms'] * 1e3:.1f} us ({r[k]['sweeps']} sweeps)"
                                for k in E1_BLOCKED if k in r)
                      + f", dispatch {r['kernel']} {r['event_ms'] * 1e3:.1f} us eager, eigh "
                      f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound'][0] * 1e3:.3f} us "
                      f"({r['bound'][1]}), max|Δλ| {r['max_abs_err']:.1e}"
                      for m, r in rows.items()) + f"; {card}", flush=True)
    f64 = {}
    for m in E1_TIMED[2:]:  # from m = 24: both blocked kernels against eigh in f64
        A = hermitian(gen, dev, m, torch.float64, 1)[0]
        f64[m] = {"eigh": marginal_ms(lambda: torch.linalg.eigh(A))}
        for kern in E1_BLOCKED:
            f64[m][kern] = (graph_ms(lambda: E1.small_eigh(A, _kernel=kern)),
                            int(E1.small_eigh(A, sweeps=True, _kernel=kern)[2]))
    print("[15a E1] f64 per call (CUDA graph of 20: the blocked kernel / the cluster kernel "
          "(sweeps); torch.linalg.eigh eager marginal events): "
          + "; ".join(f"m={m} " + " / ".join(f"{k} {r[k][0] * 1e3:.1f} us ({r[k][1]})"
                                             for k in E1_BLOCKED)
                      + f", eigh {r['eigh'] * 1e3:.1f} us" for m, r in f64.items())
          + f"; {card}", flush=True)
    r96 = rows[96]
    print(f"[15a E1] m = 96, f32: the cluster kernel {r96['cluster']['ms'] * 1e3:.1f} us, the "
          f"blocked kernel {r96['blocked']['ms'] * 1e3:.1f} us, the Jacobi kernel "
          f"{r96['jacobi']['ms'] * 1e3:.1f} us, torch.linalg.eigh "
          f"{r96['plain_ms'] * 1e3:.1f} us: cluster / eigh "
          f"{r96['cluster']['ms'] / r96['plain_ms']:.3f}, blocked / eigh "
          f"{r96['blocked']['ms'] / r96['plain_ms']:.3f}; {card}", flush=True)
    check(r96["cluster"]["ms"] < r96["plain_ms"],
          "15a E1: at m = 96 the dispatch's kernel is not faster than torch.linalg.eigh")
    return rows, worst


E2_SOURCE = "linops_tpu_torch/kernels/csrc/small_lstsq.cu"
# E2 has no Pallas site: it replaces the jnp.linalg.lstsq that XLA lowers in the
# reference's GMRES restart (the (m + 1) x m Hessenberg least-squares problem)
E2_REPLACES = "linops_tpu/utils/krylov.py:185"
# m of the random cases: [H | b] (and V for f64/c128) in shared memory to
# m = 168 in f32, 119 in c64 and f64, 84 in c128, past it in the global
# workspace (120 in all but f32, 128 and 256 in every type); the kernel takes
# any m
E2_SIZES = (2, 8, 30, 64, 120, 128, 256)
# f32 per-call times; 100-120 around the first design's shared-memory edge
E2_TIMED = (2, 8, 30, 64, 100, 118, 120, 128)
# f64 (V kept) beside f32 (no V); f64 takes the global workspace from m = 120
E2_F64_TIMED = (30, 64, 118, 120, 128)
E2_TOL = 50  # the residual ‖H y − b‖ over eps·‖b‖ beyond the plain version's


def lstsq_ops(m, complex_=False) -> int:
    """Real operations a least-squares solve of one (m + 1) x m matrix by
    the SVD needs: 4 r c² + 8 c³ (Golub & Van Loan §5.5), 4 real for each
    complex one."""
    return (4 * (m + 1) * m * m + 8 * m ** 3) * (4 if complex_ else 1)


def hessenbergs(gen, dev, m, dt):
    """A batch of 4 (m + 1) x m Hessenbergs and β e₁: two random, one of a
    lucky breakdown at step m // 2 (its later columns zero), one zero."""
    rdt = torch.float64 if dt in (torch.float64, torch.complex128) else torch.float32
    H = torch.randn((4, m + 1, m), generator=gen, device=dev, dtype=rdt)
    if dt.is_complex:
        H = torch.complex(H, torch.randn((4, m + 1, m), generator=gen, device=dev, dtype=rdt))
    H = torch.triu(H, -1)
    H[2, :, m // 2 + 1:] = 0
    H[3] = 0
    b = torch.zeros((4, m + 1), device=dev, dtype=dt)
    b[:, 0] = torch.rand(4, generator=gen, device=dev) + 0.5
    return H.to(dt), b


def e2_errors(E2, H, b, y, s, sweeps):
    """(‖H y − b‖ beyond the plain version's on the same inputs, over
    eps·‖b‖; max |Δσ| against LAPACK's SVD of H widened to f64/c128 (on the
    host: cuSOLVER's own strays further from it than E2 on these
    ill-conditioned inputs), over eps·σ_max; max ‖Δy‖/‖y‖ against the plain
    version on H widened; the σ limit: max(E2_TOL, 4·sqrt(sweeps·m)), the
    roundings of the rotations each column takes as a random walk), eps of
    H's precision, the worst of the batch."""
    wide = torch.complex128 if H.is_complex() else torch.float64
    eps = torch.finfo(s.dtype).eps

    def residual(y_):
        return torch.linalg.vector_norm(
            (H.to(wide) @ y_.to(wide).unsqueeze(-1)).squeeze(-1) - b.to(wide), dim=-1)

    bn = torch.linalg.vector_norm(b.to(wide), dim=-1).clamp_min(1e-300)
    excess = float(((residual(y) - residual(E2.small_lstsq_plain(H, b))) / bn).max()) / eps
    s_w = torch.linalg.svdvals(H.to(wide).cpu()).to(H.device)  # LAPACK: cuSOLVER's is looser
    ds = float(((s.double() - s_w).abs().amax(-1) / s_w[..., 0].clamp_min(1e-300)).max()) / eps
    y_w = E2.small_lstsq_plain(H.to(wide), b.to(wide))
    dy = float((torch.linalg.vector_norm(y.to(wide) - y_w, dim=-1)
                / torch.linalg.vector_norm(y_w, dim=-1).clamp_min(1e-300)).max())
    return excess, ds, dy, max(E2_TOL, 4.0 * (int(sweeps.max()) * H.shape[-1]) ** 0.5)


def phase15f(lt, loop, E2, dev, card, ops):
    """E2 against its plain version (the SVD at ``jnp.linalg.lstsq``'s
    cutoff) on the same inputs: the Hessenbergs of one 10a GMRES(30) solve
    (recorded in its per-iteration loop), then random, lucky-breakdown and
    zero Hessenbergs in f32, f64, c64 and c128 at m in E2_SIZES
    (``e2_errors``): the residual within E2_TOL·eps·‖b‖ of the plain
    version's, σ within its limit, exact zeros past a breakdown, y = 0 for
    H = 0, the same bits on a rerun and as each matrix alone. Then per call in
    f32 at m in E2_TIMED (m = 30: 10a's last Hessenberg): in a CUDA graph of
    20, eager events, the plain version and the library call
    ``torch.linalg.pinv(H, rtol = eps·(m + 1)) @ b`` (eager events), the
    bound (``lstsq_ops`` over 67 TFLOP/s against H, b and y's bytes); then
    in f64 (the form that keeps V) on the same Hessenbergs widened at m in
    E2_F64_TIMED, in a graph of 20 beside f32 (the form without V) and pinv.
    Returns the timed rows by m."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 180)
    # the main path's Hessenbergs: one 10a solve in the per-iteration loop
    free()
    S = lt.ShiftedOperator(ops["op2"], 8.0)
    b10 = dev_vec(ops["A2"].shape[0], dev, SEED + 70)
    fed = []

    def recording(H, e):
        fed.append((H.clone(), e.clone()))
        return E2.small_lstsq(H, e)

    with per_iteration(loop), small_lstsq_as(recording):
        _, k10, _ = lt.gmres(S, b10, tol=1e-5, restart=30, maxiter=20)
    del S, b10
    check(len(fed) == k10 and k10 > 0, f"15f: {len(fed)} Hessenbergs from {k10} restarts")
    H10, e10 = torch.stack([h for h, _ in fed]), torch.stack([e for _, e in fed])
    worst = {}
    y, s, sw = E2.small_lstsq(H10, e10, full=True)
    worst[("10a", 30)] = e2_errors(E2, H10, e10, y, s, sw) + (int(sw.max()),)
    for dt in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        for m in E2_SIZES:
            H, b = hessenbergs(gen, dev, m, dt)
            y, s, sw = E2.small_lstsq(H, b, full=True)
            worst[(str(dt)[6:], m)] = e2_errors(E2, H, b, y, s, sw) + (int(sw.max()),)
            check(not y[2, m // 2 + 1:].any() and not y[3].any() and not s[3].any(),
                  f"15f E2 {dt} m={m}: no exact zeros past a breakdown, or for H = 0")
            y2 = E2.small_lstsq(H, b)
            y3 = E2.small_lstsq(H[1:2], b[1:2])
            check(torch.equal(y, y2) and torch.equal(y[1], y3[0]),
                  f"15f E2 {dt} m={m}: other bits on a rerun or alone")
    torch.cuda.synchronize()
    for key, (excess, ds, _, lim, _) in worst.items():
        check(excess <= E2_TOL and ds <= lim,
              f"15f E2 {key}: residual {excess:.1f} eps·‖b‖ beyond the plain version's (limit "
              f"{E2_TOL}), |Δσ| {ds:.1f} eps·σ_max (limit {lim:.0f})")
    print("[15f E2] small_lstsq against its plain version (torch.linalg.svd at jnp.linalg.lstsq's "
          "cutoff): residual beyond the plain version's / eps·‖b‖, |Δσ| / eps·σ_max (limit), "
          "‖Δy‖/‖y‖ against the plain version on H widened to f64/c128, sweeps: "
          + "; ".join(f"{d_} m={m_} {v[0]:.1f} / {v[1]:.1f} ({v[3]:.0f}) / {v[2]:.1e} ({v[4]})"
                      for (d_, m_), v in worst.items())
          + f" (residual limit {E2_TOL}); {len(fed)} Hessenbergs of one 10a GMRES(30) solve "
          f"(key 10a); exact zeros past a lucky breakdown, y = 0 for H = 0; the same bits on a "
          f"rerun and alone; {card}", flush=True)
    rows, timed = {}, {}
    for m in E2_TIMED:
        if m == 30:
            H, b = H10[-1], e10[-1]
        else:
            H, b = (t[0] for t in hessenbergs(gen, dev, m, torch.float32))
        timed[m] = H, b
        y_p = E2.small_lstsq_plain(H, b)
        y, s, sw = E2.small_lstsq(H, b, full=True)
        eps = torch.finfo(torch.float32).eps
        rows[m] = {"ms": graph_ms(lambda: E2.small_lstsq(H, b)),
                   "event_ms": marginal_ms(lambda: E2.small_lstsq(H, b)),
                   "plain_ms": marginal_ms(lambda: E2.small_lstsq_plain(H, b)),
                   "library_ms": marginal_ms(lambda: torch.linalg.pinv(H, rtol=eps * (m + 1)) @ b),
                   "bound": bound_ms(nbytes(H, b, y), lstsq_ops(m)), "sweeps": int(sw),
                   "max_abs_err": float((y - y_p).abs().max())}
    f64 = {}
    for m in E2_F64_TIMED:
        H64, b64 = (t.double() for t in timed[m])
        _, _, sw64 = E2.small_lstsq(H64, b64, full=True)
        rtol = torch.finfo(torch.float64).eps * (m + 1)
        f64[m] = (graph_ms(lambda: E2.small_lstsq(H64, b64)), int(sw64),
                  marginal_ms(lambda: torch.linalg.pinv(H64, rtol=rtol) @ b64))
    print("[15f E2] f32 per call (a CUDA graph of 20; eager marginal events; the plain version "
          "(torch.linalg.svd) and the library call torch.linalg.pinv(H) @ b, eager marginal "
          "events; bound = 4 (m + 1) m² + 8 m³ operations over 67 TFLOP/s against H, b, y's bytes "
          "over 3.35 TB/s): "
          + "; ".join(f"m={m} {r['ms'] * 1e3:.1f} us ({r['sweeps']} sweeps), eager "
                      f"{r['event_ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, pinv "
                      f"{r['library_ms'] * 1e3:.1f} us, bound {r['bound'][0] * 1e3:.4f} us "
                      f"({r['bound'][1]}), max|Δy| against plain {r['max_abs_err']:.1e}"
                      for m, r in rows.items())
          + "; f64 (V kept) on the same Hessenbergs widened (m = 30: 10a's): "
          + "; ".join(f"m={m} {ms * 1e3:.1f} us ({sw} sweeps), {ms / rows[m]['ms']:.3f}x f32 "
                      f"(no V), pinv {pv * 1e3:.1f} us" for m, (ms, sw, pv) in f64.items())
          + f"; {card}", flush=True)
    return rows


def laplacian_eigenvalues(g):
    """The eigenvalues of the 5-point Laplacian on g², ascending (closed form)."""
    c = np.cos(np.arange(1, g + 1) * np.pi / (g + 1))
    return np.sort((4.0 - 2.0 * c[:, None] - 2.0 * c[None, :]).ravel())


def closed_form_gaps(L64, g, theta, X):
    """(f64 residuals through L64, distance of each θ to the nearest
    eigenvalue of the 5-point Laplacian on g²), checked: a Ritz value of a
    unit vector lies within its residual norm of an eigenvalue."""
    lam = laplacian_eigenvalues(g)
    Xh = X.double().cpu().numpy()
    r64 = np.linalg.norm(L64 @ Xh - Xh * theta.double().cpu().numpy(), axis=0)
    gaps = []
    for th, r in zip(theta.double().cpu().numpy(), r64):
        j = np.searchsorted(lam, th)
        gaps.append(min(abs(lam[max(j - 1, 0)] - th), abs(lam[min(j, lam.size - 1)] - th)))
        check(gaps[-1] <= r + 1e-5 * abs(th), f"lobpcg: θ {th} is {gaps[-1]:.3e} from every "
              f"eigenvalue, residual {r:.3e}")
    return r64, gaps


@contextlib.contextmanager
def small_eigh_as(fn):
    """LOBPCG's small eigendecompositions (``utils/eig.py``) through ``fn``
    in place of E1 for the block's duration."""
    from linops_tpu_torch.utils import eig as eig_mod

    kept = eig_mod.small_eigh
    eig_mod.small_eigh = fn
    try:
        yield
    finally:
        eig_mod.small_eigh = kept


@contextlib.contextmanager
def small_lstsq_as(fn):
    """GMRES's least-squares step (``utils/krylov.py``) through ``fn`` in
    place of E2 for the block's duration."""
    from linops_tpu_torch.utils import krylov

    kept = krylov.small_lstsq
    krylov.small_lstsq = fn
    try:
        yield
    finally:
        krylov.small_lstsq = kept


@contextlib.contextmanager
def per_iteration(loop):
    """The per-iteration loop (BLOCK 1, no capture), as ``loop_modes`` runs it."""
    block = loop.BLOCK
    loop.BLOCK, loop.CAPTURE = 1, False
    try:
        yield
    finally:
        loop.BLOCK, loop.CAPTURE = block, True


def eigh_wide(A):
    """The plain version on A widened to f64/c128, its results cast back:
    eigenvalues and vectors within an ulp of A's precision."""
    wide = torch.complex128 if A.is_complex() else torch.float64
    w, V = torch.linalg.eigh(A.to(wide))
    return w.to(A.real.dtype), V.to(A.dtype)


def with_eigh(loop, solve, eigh=torch.linalg.eigh):
    """One solve in the per-iteration loop with ``eigh`` in E1's place; by
    default torch.linalg.eigh (eager, cuSOLVER), as LOBPCG ran before E1:
    "the eigh loop"."""
    with per_iteration(loop), small_eigh_as(eigh):
        return solve()


def swap_ulps(got, ref, norm) -> float:
    """max |Δθ| in f32 ulps of ``norm``."""
    return float((got.double() - ref.double()).abs().max()) / (torch.finfo(torch.float32).eps
                                                               * norm)


def swap_check(tag, got, ref, it, it_ref, norm, count_slack=0, what="eigh"):
    """θ of a solve with ``what`` in E1's place (``ref``) against E1's:
    counts within ``count_slack``, |Δθ| within SWAP_ULPS f32 ulps of
    ``norm``. Returns |Δθ| in those ulps."""
    ulps = swap_ulps(got, ref, norm)
    check(abs(it - it_ref) <= count_slack and ulps <= SWAP_ULPS,
          f"{tag}: with E1 {it} iterations and θ {got.tolist()}, with {what} in its place "
          f"{it_ref} and {ref.tolist()}: {ulps:.1f} ulps of ‖A‖₂ apart (limit {SWAP_ULPS})")
    return ulps


def fed_check(tag, loop, E1, solve, calls):
    """E1 against eigh (``e1_errors``, E1_TOL) on every matrix one
    per-iteration ``solve`` gives it, which must be ``calls``. Returns the
    worst errors by m."""
    fed = []

    def recording(A):
        fed.append(A.clone())
        return E1.small_eigh(A)

    with per_iteration(loop), small_eigh_as(recording):
        solve()
    worst = {}
    for A in fed:
        m = A.shape[-1]
        errs = e1_errors(A, *E1.small_eigh(A))
        worst[m] = tuple(max(a, b) for a, b in zip(worst.get(m, (0.0,) * 3), errs))
    check(len(fed) == calls and all(e <= E1_TOL for v in worst.values() for e in v),
          f"{tag}: E1 on the {len(fed)} matrices one solve gave it ({calls} expected): {worst} "
          f"(limit {E1_TOL})")
    return worst


def worst_line(worst) -> str:
    return "{" + ", ".join(f"{m}: " + "/".join(f"{e:.1f}" for e in v)
                           for m, v in worst.items()) + "}"


def phase15b(lt, loop, E1, dev, card):
    """The slice's main path: LOBPCG (k = 2, largest, gram basis, tol 0,
    LOB_ITERS iterations) on phase 11's 2048² stencil in f32, in the
    per-iteration loop and in captured blocks (first, second and cached
    solves; ``loop_modes``): the same count, θ and X bit for bit, the cached
    block's kernel nodes holding E1 (4 per iteration) and no cuSOLVER kernel,
    a replay under sync-debug error; θ within its residual of the closed-form
    eigenvalues (weak: near θ the eigenvalues lie about 1e-6 apart); E1 on
    every matrix one solve gave it against eigh (E1_TOL); the solves with
    eigh in E1's place (the eigh loop) and with eigh on inputs widened to f64:
    the same count, θ within SWAP_ULPS f32 ulps of ‖A‖₂; and the marginal
    wall time per iteration in cached blocks (25 − 5 iterations, the method
    of phase 11b).
    E1's launch counts are set to 0 before and read after. Returns (record,
    marginal µs per iteration, E1 launches)."""
    free()
    g = GRID11
    S = lt.laplacian_2d(g, g)
    gen = torch.Generator(device=dev)

    def lob(iters=LOB_ITERS):
        gen.manual_seed(SEED + 112)
        return lt.lobpcg(S, k=2, largest=True, tol=0.0, maxiter=iters, generator=gen)

    def solve():
        th, X, res, it = lob()
        return torch.cat([th, X.reshape(-1)]), it, res

    seen = {}

    def no_solver_kernels(gr):
        names = graph_kernel_names(gr)
        bad = sorted({n_ for n_ in names if SOLVER_KERNELS.search(n_)})
        check(not bad, f"15b: the captured LOBPCG block holds library solver kernels {bad}")
        seen["nodes"] = len(names)

    E1.reset_launch_counts()
    r = loop_modes(loop, f"15b lobpcg(k=2, largest, gram, tol 0, {LOB_ITERS} iterations) on the "
                   f"{g}² stencil, f32", solve, phase="15b", inspect=no_solver_kernels)
    launches = E1.launch_counts()["small_eigh"]
    check(launches > 0, "15b: E1 never ran on the slice-10 path")
    check(r["nodes"].get("small_eigh_kernel", 0) == 4 * loop.BLOCK,
          f"15b: the cached block holds {r['nodes']}: not 4 E1 per iteration")
    th, X, res, it = lob()
    r64, gaps = closed_form_gaps(five_point(g), g, th, X)
    # E1 on the matrices the path gives it (the SVQB Grams at m = 2, the
    # Rayleigh-Ritz matrices at m = 6): two at the start, four per iteration
    calls = 4 * LOB_ITERS + 2
    worst = fed_check("15b", loop, E1, lob, calls)
    norm = float(laplacian_eigenvalues(g)[-1])
    th_e, _, _, it_e = with_eigh(loop, lob)
    ulps = swap_check("15b lobpcg", th, th_e, it, it_e, norm)
    th_w, _, _, it_w = with_eigh(loop, lob, eigh_wide)
    ulps_w = swap_check("15b lobpcg", th, th_w, it, it_w, norm, what="eigh in f64")
    us_marg = host_ms(lob, 5, 25) * 1e3
    print(f"[15b device loop] LOBPCG on the {g}² stencil: θ {[round(float(t_), 6) for t_ in th]}, "
          f"f64 residuals {[float(f'{x:.3e}') for x in r64]}, distance to the nearest closed-form "
          f"eigenvalue {[float(f'{x:.3e}') for x in gaps]} (limit: residual + 1e-5·θ); E1 on the "
          f"{calls} matrices one solve gave it, worst |Δλ|, residual, orthogonality over eps "
          f"by m: {worst_line(worst)} (limit {E1_TOL}); with torch.linalg.eigh in E1's place (the "
          f"eigh loop) {it_e} iterations, θ {[round(float(t_), 6) for t_ in th_e]}, {ulps:.1f} f32 "
          f"ulps of ‖A‖₂ from E1's, with it on inputs widened to f64 {ulps_w:.1f} (limit "
          f"{SWAP_ULPS}); cached "
          f"block: {seen['nodes']} kernel nodes, no cuSOLVER kernel; {us_marg:.1f} us per "
          f"iteration marginal in cached blocks (25 − 5 iterations, host clock; the host loop "
          f"with four cuSOLVER calls per iteration took 8967.4 us on an NVIDIA H100 80GB HBM3 "
          f"at 700 W); E1 launches on this path "
          f"{launches}; {card}", flush=True)
    return r, us_marg, launches


def phase15c(lt, loop, dev, main, spectra):
    """svds and normest of phase 4's BSR operator in captured blocks
    (``loop_modes``), with phase 11b's seeds: the same counts and bits as
    their per-iteration loop, and phase 11b's values (which ran the
    per-iteration loop, a signature's first solve). The blocks must hold E1
    and K2p (svds: the Gram operator's adjoint block apply, one panel launch;
    its forward matrix apply is the plain gather, as the reference's XLA matmat),
    K1 and K2 (normest's vector applies). svds also against the solve with
    torch.linalg.eigh in E1's place (the eigh loop): counts within 1 (its
    tol-1e-4 test may pass an iteration apart), s² within SWAP_ULPS f32 ulps
    of s₀²."""
    free()
    B = lt.BSROperator(lt.BSR(main["blocks"], main["cols"], (N, N)))
    gen = torch.Generator(device=dev)

    def svd():
        gen.manual_seed(SEED + 113)
        _, s, V, sres, it = lt.svds(B, k=4, tol=1e-4, maxiter=150, generator=gen)
        return torch.cat([s, V.reshape(-1)]), it, sres

    def ne():
        gen.manual_seed(SEED + 114)
        e, c = lt.normest(B, tol=1e-6, maxiter=300, generator=gen)
        return torch.tensor([e], dtype=torch.float64), c, None

    out = {}
    for tag, solve, ref, syms in (
            ("svds(k=4, tol 1e-4)", svd, spectra["svds"], ("rmatmat_chunk_kernel",
                                                             "small_eigh_kernel")),
            ("normest(tol 1e-6)", ne, spectra["normest"], ("bsr_matvec_kernel",
                                                           "rmatvec_chunk_kernel"))):
        r = loop_modes(loop, f"15c {tag} of phase 4's BSR B (n = {N})", solve, phase="15c")
        for sym in syms:
            check(r["nodes"].get(sym, 0) > 0, f"15c {tag}: {sym} is not in the captured block")
        x, it, _ = solve()
        got = float(x[0])
        check(abs(got - ref) <= 1e-6 * abs(ref), f"15c {tag}: {got} against phase 11b's {ref}")
        swapped = ""
        if solve is svd:
            x_e, it_e, _ = with_eigh(loop, svd)
            ulps = swap_check(f"15c {tag}", x[:4] ** 2, x_e[:4] ** 2, it, it_e,
                              float(x[0]) ** 2, count_slack=1)
            x_w, it_w, _ = with_eigh(loop, svd, eigh_wide)
            ulps_w = swap_check(f"15c {tag}", x[:4] ** 2, x_w[:4] ** 2, it, it_w,
                                float(x[0]) ** 2, count_slack=1, what="eigh in f64")
            swapped = (f"; with torch.linalg.eigh in E1's place {it_e} iterations (E1 {it}), "
                       f"s² {ulps:.1f} f32 ulps of s₀² apart; with it on inputs widened to f64 "
                       f"{it_w} iterations, {ulps_w:.1f} ulps (limit {SWAP_ULPS})")
        print(f"[15c device loop] {tag}: {got:.9f} in cached blocks, phase 11b {ref:.9f} "
              f"({'bit for bit' if got == ref else f'{abs(got - ref) / abs(ref):.1e} apart'})"
              f"{swapped}", flush=True)
        out[tag] = r
    del B
    free()
    return out


def phase15e(lt, loop, E1, dev, card):
    """LOBPCG at k = LOB32_K (largest, gram basis, tol 0, LOB32_ITERS
    iterations) on phase 11's 2048² stencil in f32, where E1 runs at m = 32
    (SVQB) and 96 (Rayleigh-Ritz): wall µs per iteration (median of REPS
    solves, host clock around synchronized solves) of the eigh loop (per
    iteration, torch.linalg.eigh) against cached captured blocks with E1,
    and E1's own time at those sizes. E1 on every matrix one solve gives it
    against eigh. θ against the solve with eigh on inputs widened to f64 in
    E1's place: within SWAP_ULPS f32 ulps of ‖A‖₂, or no farther than the
    eigh loop's θ (torch.linalg.eigh in f32, whose eigenvalues at m = 96
    are themselves some 180 eps·‖A‖₂ off, 15a). Returns the record."""
    free()
    g = GRID11
    S = lt.laplacian_2d(g, g)
    gen = torch.Generator(device=dev)

    def lob():
        gen.manual_seed(SEED + 115)
        th, X, res, it = lt.lobpcg(S, k=LOB32_K, largest=True, tol=0.0, maxiter=LOB32_ITERS,
                                   generator=gen)
        return th, it

    with per_iteration(loop), small_eigh_as(torch.linalg.eigh):
        lob()
        (th_e, it_e), s_e = median_solve(lob)
    loop.clear_cache()
    E1.reset_launch_counts()
    for _ in range(2):  # the signature's first solve, then its capture
        lob()
    (th, it), s_c = median_solve(lob)
    launches = E1.launch_counts()
    check(loop.stats["replays"] > 0 and loop.stats["captures"] == 0 and it == it_e,
          f"15e: the k = {LOB32_K} solve did not replay cached blocks: {loop.stats}")
    check(launches["small_eigh_cluster"] > 0,
          f"15e: E1's cluster kernel (m = {LOB32_K} and {3 * LOB32_K}) did not run: {launches}")
    worst = fed_check("15e", loop, E1, lob, 4 * LOB32_ITERS + 2)
    norm = float(laplacian_eigenvalues(g)[-1])
    th_w, it_w = with_eigh(loop, lob, eigh_wide)
    ulps, ulps_e = swap_ulps(th, th_w, norm), swap_ulps(th_e, th_w, norm)
    e1 = {}
    for m in (LOB32_K, 3 * LOB32_K):
        A = torch.randn((m, m), generator=gen, device=dev)
        e1[m] = (graph_ms(lambda: E1.small_eigh(A)), marginal_ms(lambda: torch.linalg.eigh(A)))
    rec = {"eigh_us": s_e * 1e6 / it, "e1_us": s_c * 1e6 / it, "e1_calls": e1, "ulps": ulps,
           "ulps_eigh_loop": ulps_e, "launches": launches}
    print(f"[15e k = {LOB32_K}] lobpcg(k={LOB32_K}, largest, gram, tol 0, {it} iterations) on the "
          f"{g}² stencil, f32: wall {rec['eigh_us']:.1f} us per iteration in the eigh loop (per "
          f"iteration, torch.linalg.eigh) -> {rec['e1_us']:.1f} us in cached blocks with E1 "
          f"({rec['e1_us'] / rec['eigh_us']:.2f}x); θ from the solve with eigh on inputs widened "
          f"to f64: E1's {ulps:.1f} f32 ulps of ‖A‖₂, the eigh loop's {ulps_e:.1f} (limit: the "
          f"larger of {SWAP_ULPS} and the eigh loop's); E1 on the matrices one solve gave it "
          f"{worst_line(worst)} (limit {E1_TOL}); per "
          f"call E1 / eigh: " + ", ".join(f"m = {m} {a * 1e3:.1f} / {b * 1e3:.1f} us"
                                          for m, (a, b) in e1.items())
          + f"; E1 launches in the first and capturing solves {launches}; {card}", flush=True)
    check(it == it_w and ulps <= max(SWAP_ULPS, ulps_e),
          f"15e: with E1 {it} iterations and θ {th.tolist()}, with eigh in f64 in its place "
          f"{it_w} and {th_w.tolist()}: {ulps:.1f} ulps of ‖A‖₂ apart, the eigh loop {ulps_e:.1f}")
    del S
    free()
    return rec


def example_checks(name, r):
    """What each ported example's result must show on the card (their own
    asserts run too): name -> (passed, what was checked)."""
    if name.startswith("01"):
        return bool(torch.isfinite(r["dense"]).all()), "finite dense(expr)"
    if name.startswith("02"):
        return r["resid"] <= 1e-10 and r["it1"] <= r["it0"] + 1, "shifted residual ≤ 1e-10, PCG ≤ CG"
    if name.startswith("03"):
        return (r["world"] == 1 and r["rel"] <= 1e-6 and r["halo_err"] <= 1e-6
                and np.isfinite(r["chain"]).all()), "world 1, csr/bsr and halo ≤ 1e-6"
    if name.startswith("04"):
        return True, "its own asserts (step inside the radius, shifted residual)"
    if name.startswith("05"):
        return r["err"] < 1e-6, "Tikhonov oracle ≤ 1e-6"
    if name.startswith("06"):
        return r["finite"] == (True, True) and r["rel"] <= 1e-2, "finite chains, bf16 ≤ 1e-2"
    if name.startswith("07"):
        est, se = r["trace"]
        return (abs(est - r["tr_true"]) <= 6 * se and r["it_nys"] < r["it_plain"]
                and r["cg_residual"] <= 1e-9 and r["opnorm"][1]), \
            "trace within 6 se, Nyström CG faster and converged, opnorm converged"
    if name.startswith("08"):
        return (r["mesh"] == (1, 1) and abs(r["theta"][0] - r["lam0"]) <= 1e-8
                and r["res"] <= 1e-10), "1 x 1 mesh, λ₀ within 1e-8, CG converged"
    if name.startswith("09"):
        return all(r[k_] <= 1e-12 for k_ in ("forward", "adjoint", "chain")) and \
            r["perm_exact"], "routed N/T/chain ≤ 1e-12, permutation exact"
    return False, "unknown example"


def phase15d(dev, card):
    """Every ported example (``examples/torch/0*.py``) through its
    ``main()`` on the card; 03 and 08 in the world of one NCCL rank that
    phase 13 started (08 on a 1 x 1 mesh). Each must run, pass its own
    asserts and ``example_checks``. Returns {example: seconds}."""
    import glob
    import importlib.util
    import io

    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "examples", "torch", "0*.py")))
    check(len(paths) == 9, f"15d: {len(paths)} ported examples, not 9")
    secs = {}
    for path in paths:
        free()
        name = os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location(f"example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            r = mod.main(dev)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if name.startswith("04"):
            r = None
        ok, what = example_checks(name, r)
        last = buf.getvalue().strip().splitlines()[-1]
        check(ok, f"15d {name}: {what} failed; its output ends: {last}")
        print(f"[15d examples] {name}: {secs[name]:.2f} s, {what}: ok; its last line: {last}",
              flush=True)
    print(f"[15d examples] all 9 ran on the card; {card}", flush=True)
    return secs


# ----------------------------------------------------------------------------
# Slice 20: a BSR operator's block transposes in one launch (K2p, K4p, K6p)
# ----------------------------------------------------------------------------

PANEL16_KS = (1, 3, 8, 12, 32)  # 16a: block widths checked
PANEL16_TIMED = (1, 8, 12, 32)  # 16a: widths timed
LOOP16_TIMED = (1, 8)  # 16a: widths whose column loop of vector applies is timed too
PANEL_TILE = 8  # the forward panel kernels' columns per tile (kPanel, csrc/bsr_common.cuh)
PLAIN16_COLS = 4  # 16a: a 2^22 operator's plain panel computed 4 columns at a time (memory)
SVDS16_ITERS = 20  # 16b: LOBPCG iterations per timed svds (tol 0), and twice as many
PANEL16_KERNELS = {  # kernel -> (source, the TPU kernel its vmap batches, 16a's case of record)
    "bsr_rmatmat": (K1_SOURCE, K2_REPLACES, "8x128 float32"),  # K2p
    "bsr_rmatmat_windowed": (WIN_SOURCE, WIN_KERNELS["bsr_rmatvec_windowed"][0],
                             "banded float32"),  # K4p
    "bsr_rmatmat_multiwin": (WIN_SOURCE, WIN_KERNELS["bsr_rmatvec_multiwin"][0],
                             "band+cluster float32"),  # K6p
}


def few_ms(fn, short=2, long_=6):
    """ms per call of a call of many ms: marginal CUDA events over ``short``
    and ``long_`` calls, the median of REPS."""
    fn()
    torch.cuda.synchronize()
    return float(np.median([(event_ms(fn, long_) - event_ms(fn, short)) / (long_ - short)
                            for _ in range(REPS)]))


def column_transposes(lt, B):
    """B with its T and H blocks as the column loop the port ran before K2p
    (a stack of vector applies, one K2 launch a column) and its N block B's
    own (K1p since phase 17's slice): 16b's yardstick, capture-safe."""
    from linops_tpu_torch.core.base import LinearOperator

    class ColumnTransposes(lt.FunctionOperator):
        def apply_matrix(self, M, mode="N"):
            return B.apply_matrix(M, "N") if mode == "N" else \
                LinearOperator.apply_matrix(self, M, mode)

    return ColumnTransposes(B.nrow, B.ncol, lambda v: B.apply(v, "N"),
                            lambda u: B.apply(u, "T"), dtype=B.dtype, capture_safe=True)


def column_plan(plan):
    """The tensors of a column plan a transpose kernel reads."""
    return plan.perm, plan.chunk_ptr, plan.chunk_col, plan.col_chunk, plan.combine_cols


def panel16_cases(lt, K, dev):
    """16a's operators, one at a time (tag, kernel name, panel(U),
    plain(U), vector(u), rows of U, blocks, the plan tensors the kernel
    reads, the CSR of Aᵀ maker, the operator or None): phase 5's 8x128 (f32,
    bf16) and 128x128 (f32) operators (K2p), the 2^22 banded (K4p) and band
    + far cluster (K6p) window operators (f32, bf16)."""
    from linops_tpu_torch.core.segsum import segment_plan

    for name, dtype in (("8x128", torch.float32), ("8x128", torch.bfloat16),
                        ("128x128", torch.float32)):
        bm, bn, _ = SHAPES[name]
        nbcol = N // bn
        blocks, cols = make_bsr(name, dtype, dev)
        plan = K.bsr_column_plan(cols, nbcol, bm * bn * blocks.element_size())
        seg = segment_plan(cols, nbcol)
        yield (f"{name} {str(dtype)[6:]}", "bsr_rmatmat",
               lambda U: K.bsr_rmatmat_kernel(blocks, cols, U, nbcol, plan=plan),
               lambda U: K.bsr_rmatmat_plain(blocks, cols, U, nbcol, plan=seg),
               lambda u: K.bsr_rmatvec_kernel(blocks, cols, u.reshape(-1, bm), nbcol,
                                              plan=plan).reshape(-1),
               N, blocks, (cols, *column_plan(plan)), lambda: csr_t_of_bsr(K, blocks, cols, nbcol),
               None)
        del blocks, cols, plan, seg
        free()
    for wname, wdt in (("banded", torch.float32), ("banded", torch.bfloat16),
                       ("band+cluster", torch.float32), ("band+cluster", torch.bfloat16)):
        op = win_operator(lt, wname, wdt, dev, SEED + 30)
        d, nbcol = op.data, WIN_N // 128
        if op.cols_local is not None:
            kern, win = "bsr_rmatmat_windowed", dict(wb=op._wb, x_pad_blocks=op._x_pad_blocks,
                                                     nbcol=nbcol)
            args = (d.blocks, op.cols_local, op.win_q)
            panel = lambda U: K.bsr_rmatmat_windowed_kernel(  # noqa: E731
                *args, U, index=(op.t_perm, op.t_ptr), **win)
            plain = lambda U: K.bsr_rmatmat_windowed_plain(  # noqa: E731
                *args, U, sum_plan=op.plain_transpose_plan(), **win)
            reads = (op.cols_local, op.win_q, op.t_perm, op.t_ptr)
        else:
            kern, win = "bsr_rmatmat_multiwin", dict(wb=op._wb, x_pad_blocks=op._x_pad_blocks_t,
                                                     nbcol=nbcol)
            args = (d.blocks, d.block_cols, op.win_q_t, op.win_valid_t)
            panel = lambda U: K.bsr_rmatmat_multiwin_kernel(  # noqa: E731
                *args, U, index=op.t_plan, **win)
            plain = lambda U: K.bsr_rmatmat_multiwin_plain(  # noqa: E731
                *args, U, sum_plan=op.plain_transpose_plan(), **win)
            reads = (d.block_cols, op.win_q_t, op.win_valid_t, *column_plan(op.t_plan))

        def pieces(U, plain=plain):  # the plain panel, PLAIN16_COLS columns at a time
            return torch.cat([plain(U[:, j:j + PLAIN16_COLS])
                              for j in range(0, U.shape[1], PLAIN16_COLS)], dim=1)

        yield (f"{wname} {str(wdt)[6:]}", kern, panel, pieces,
               lambda u, op=op: win_kernel(K, op, ub=u.reshape(-1, 8)).reshape(-1),
               d.blocks.shape[0] * 8, d.blocks, reads,
               lambda d=d, nbcol=nbcol: csr_t_of_bsr(K, d.blocks, d.block_cols, nbcol), op)
        del op, d, args, panel, plain, pieces
        free()


def panel_times(tree: str, out: str) -> int:
    """``python3 chip_smoke.py --panels TREE OUT.json``: 16a's panel
    transposes (K2p, K4p, K6p) of the package in TREE (this checkout, or
    another one such as a parent commit unpacked by ``git archive``), built
    from TREE's sources, on ``panel16_cases`` at PANEL16_TIMED: µs by
    marginal CUDA events, the bound, whether the result is its vector
    kernel's column loop bit for bit, and a digest of its bits (two trees'
    digests agree when their kernels give the same bits); one JSON object
    to OUT and a line per case. To compare two trees, run them in turns in
    one call (A, B, B, A): a card's clocks move between calls."""
    import hashlib
    import json

    sys.path.insert(0, os.path.abspath(tree))
    import linops_tpu_torch as lt
    from linops_tpu_torch.kernels import bsr_spmv as K
    from linops_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    build.build_all(["bsr_spmv", "bsr_window"])
    res = {"tree": os.path.abspath(tree), "card": card_line()}
    for tag, kern, panel, _, vector, rows, blocks, reads, _, _ in panel16_cases(lt, K, dev):
        timer = few_ms if blocks.numel() > 1 << 28 else marginal_ms
        path = getattr(K, "transpose_panel_path", lambda b: "registers")(blocks)
        for k in PANEL16_TIMED:
            g = torch.Generator(device=dev).manual_seed(SEED + 220 + k)
            U = torch.randn((rows, k), device=dev, generator=g)
            P = panel(U)
            same = torch.equal(P, torch.stack([vector(U[:, j].contiguous()) for j in range(k)],
                                              dim=1))
            ms = timer(lambda: panel(U))
            bound = bound_ms(nbytes(blocks, U, P, *reads), 2 * blocks.numel() * k)[0]
            digest = hashlib.sha256(P.float().cpu().numpy().tobytes()).hexdigest()[:16]
            res[f"{kern}|{tag}|k={k}"] = dict(us=ms * 1e3, bound_us=bound * 1e3, loop_bits=same,
                                              digest=digest, staging=path)
            print(f"[panels] {kern} {tag} k={k}: {ms * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                  f"({bound / ms:.0%}), column loop's bits {same}, digest {digest}, {path}",
                  flush=True)
            del U, P
        free()
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    bad = [key for key, r in res.items() if isinstance(r, dict) and not r["loop_bits"]]
    print(f"[panels] {len(res) - 2} cases, {card_line()}; not the column loop's bits: {bad}")
    return 1 if bad else 0


def phase16(lt, loop, mods, dev, card, main, spectra):
    """A BSR operator's block transposes in one launch (f32 unless named).
    (a) K2p, K4p and K6p (``bsr_rmatmat*_kernel``) on ``panel16_cases`` at k
    in PANEL16_KS: within KERNEL_RTOL of the plain panel (the 2^22
    operators' PLAIN16_COLS columns at a time), the same bits on a rerun,
    bit for bit the vector kernel's column loop, a row panel's transposed
    view the same bits, laid out in rows; µs per call in a CUDA graph of 20
    and by marginal CUDA events at PANEL16_TIMED, beside the column loop's
    (at LOOP16_TIMED), the plain panel's and cuSPARSE's SpMM (``spmm_time``)
    at k = 8; the bound: bytes of
    the blocks, U, the result and the plan read once (the kernels' own: the
    blocks once per column tile, ``transpose_panel_tile``) against 2 nnz k f32
    operations. The window operators' T blocks also through
    ``estimate_trace(AᵀA)`` (8 Hutchinson probes: one panel launch), within
    6 standard errors of ‖A‖_F². (b) svds(k = 4, tol 1e-4) of phase 4's B in
    cached captured blocks (``loop_modes``) and the same with B's T/H
    blocks through ``column_transposes``: s and V bit for bit both ways, s
    within 1e-4 of phase 11b's, iterations ±1; per cached block, K2p
    launches against K2's (1 against the block's width, per H block); wall
    and CUDA-event µs per iteration of both, marginal over SVDS16_ITERS and
    twice as many. (c) the Nyström sketch of slice 1's graph ((A + Aᴴ)/2,
    rank 20, 13i e's seed): one K2p launch per Bᵀ block (two: one in each
    term) and no K2, plain and through ``shard_operator`` at world size 1,
    U and λ bit for bit. (d) the gradient of ½‖Bᵀ M − Y‖² in the blocks and
    in M (8 columns) against the plain backend's autograd within
    KERNEL_RTOL: one K2p launch forward; the backward's M-gradient one N
    block (one K1p launch, since phase 17's slice), the blocks' gradient a
    gather and an outer product. Launches are counted over 16's paths alone (``on_path``:
    (a)'s estimates, (b)'s panel solves, (c), (d)); 16a's checks and the
    yardsticks stay out. Returns (kernel records, launches)."""
    from linops_tpu_torch.kernels import bsr_spmv as K
    from linops_tpu_torch.parallel import make_mesh, shard_operator
    from linops_tpu_torch.utils.eig import nystrom_preconditioner

    t_phase = time.perf_counter()
    f32 = torch.float32
    launches, rec = {}, {}

    def on_path(fn):
        for m_ in mods:
            m_.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, c_ in all_launches(mods).items():
            launches[name] = launches.get(name, 0) + c_
        return out

    # --- 16a. the panel kernels against their plain versions and column loops -------------
    for tag, kern, panel, plain, vector, rows, blocks, reads, csr_t, op in panel16_cases(
            lt, K, dev):
        errs, worst = {}, 0.0
        for k in PANEL16_KS:
            U = torch.randn((rows, k), device=dev)
            P = panel(U)
            P2 = panel(U)
            torch.cuda.synchronize()
            loop_ = torch.stack([vector(U[:, j].contiguous()) for j in range(k)], dim=1)
            Pr = panel(U.t().contiguous().t())
            ref = plain(U)
            errs[k] = rel_err(P, ref)
            check(torch.isfinite(P).all() and tuple(P.shape) == (loop_.shape[0], k)
                  and errs[k] <= KERNEL_RTOL and torch.equal(P, P2) and torch.equal(P, loop_)
                  and torch.equal(Pr, P) and Pr.t().is_contiguous(),
                  f"16a {kern} {tag} k={k}: {errs[k]:.2e} from the plain panel (limit "
                  f"{KERNEL_RTOL:g}), rerun {torch.equal(P, P2)}, column loop "
                  f"{torch.equal(P, loop_)}, row panel {torch.equal(Pr, P)} "
                  f"(in rows: {Pr.t().is_contiguous()})")
            if k == 8:
                worst = float((P - ref).abs().max())
            del U, P, P2, loop_, Pr, ref
        times = {}
        for k in PANEL16_TIMED:
            U = torch.randn((rows, k), device=dev)
            long_call = blocks.numel() > 1 << 28  # the 2^22 operators
            t_ = dict(graph=graph_ms(lambda: panel(U)),
                      events=(few_ms if long_call else marginal_ms)(lambda: panel(U)))
            if k in LOOP16_TIMED:
                t_["loop_graph"] = graph_ms(lambda: [vector(U[:, j]) for j in range(k)])
                t_["loop_events"] = (few_ms if long_call else marginal_ms)(
                    lambda: [vector(U[:, j]) for j in range(k)])
            P = panel(U)
            t_["bound"] = bound_ms(nbytes(blocks, U, P, *reads), 2 * blocks.numel() * k)
            t_["design_bound"] = bound_ms(nbytes(blocks) * -(-k // K.transpose_panel_tile(k))
                                          + nbytes(U, P, *reads), 2 * blocks.numel() * k)
            if k == 8:
                t_["plain"] = few_ms(lambda: plain(U), 1, 3) if long_call else \
                    marginal_ms(lambda: plain(U))
                t_["library"], t_["library_err"], t_["library_note"] = spmm_time(
                    csr_t, U, plain(U), few_ms if long_call else marginal_ms)
            times[k] = t_
            del U, P
        if op is not None and op.dtype == f32:  # the window operator's T block on a path:
            # estimate_trace(AᵀA) (f32: a bf16 operator's Hutchinson sums round in bf16)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 160)
            before = launches.get(kern, 0)
            tr, se = on_path(lambda: lt.estimate_trace(op.T @ op, probes=8, method="hutchinson",
                                                       generator=gen))
            fro2 = float(op.data.blocks.double().pow(2).sum())
            check(launches.get(kern, 0) - before == 1 and abs(float(tr) - fro2) <= 6 * float(se),
                  f"16a {tag}: estimate_trace(AᵀA) {float(tr)} ± {float(se)} against ‖A‖_F² "
                  f"{fro2}, {launches.get(kern, 0) - before} {kern} launches")
            times["trace"] = (float(tr), float(se), fro2)
        path = K.transpose_panel_path(blocks)
        rec[(kern, tag)] = dict(errs=errs, max_abs_err=worst, times=times, path=path)
        t8 = times[8]
        print(f"[16a panel kernels] {kern} {tag}: max|Δ|/max|y| against the plain panel "
              + ", ".join(f"k={k} {e:.2e}" for k, e in errs.items())
              + f" (limit {KERNEL_RTOL:g}); every k bit for bit the vector kernel's column loop, "
              f"the same bits on a rerun and through a row panel's view (its result in rows); "
              f"staging: {path}; "
              + "; ".join(f"k={k}: {t_['graph'] * 1e3:.1f} us in a graph of 20, "
                          f"{t_['events'] * 1e3:.1f} us by events, "
                          + (f"column loop {t_['loop_graph'] * 1e3:.1f} / "
                             f"{t_['loop_events'] * 1e3:.1f} us, " if "loop_graph" in t_ else "")
                          + f"bound {t_['bound'][0] * 1e3:.1f} us ({t_['bound'][1]}; "
                          f"blocks once per {K.transpose_panel_tile(k)} columns: "
                          f"{t_['design_bound'][0] * 1e3:.1f} us)"
                          for k, t_ in times.items() if k != "trace")
              + f"; k=8 plain {t8['plain'] * 1e3:.1f} us"
              + (f" ({PLAIN16_COLS} columns at a time)" if op is not None else "")
              + f", cuSPARSE SpMM on a CSR of Aᵀ "
              + ("null" if t8["library"] is None else f"{t8['library'] * 1e3:.1f} us")
              + f" ({t8['library_note']})"
              + (f"; estimate_trace(AᵀA, 8 probes) {times['trace'][0]:.6e} ± "
                 f"{times['trace'][1]:.2e} against ‖A‖_F² {times['trace'][2]:.6e}, one {kern} "
                 "launch" if "trace" in times else "")
              + f"; {card}", flush=True)
        del panel, plain, vector, blocks, reads, csr_t, op
        free()

    # --- 16b. svds of phase 4's B: one K2p launch per H block ------------------------------
    B = lt.BSROperator(lt.BSR(main["blocks"], main["cols"], (N, N)))
    Bc = column_transposes(lt, B)
    gen = torch.Generator(device=dev)

    def svd(op, tol=1e-4, maxiter=150):
        gen.manual_seed(SEED + 113)
        _, s_, V_, sres, it_ = lt.svds(op, k=4, tol=tol, maxiter=maxiter, generator=gen)
        return torch.cat([s_, V_.reshape(-1)]), it_, sres

    out_b = {}
    for name, op in (("panel", B), ("columns", Bc)):
        tag = (f"16b svds(k=4, tol 1e-4) of phase 4's B (n = {N})"
               + (" with its T/H blocks as the column loop" if name == "columns" else ""))
        run = on_path if name == "panel" else (lambda f: f())
        r = run(lambda op=op, tag=tag: loop_modes(loop, tag, lambda: svd(op), phase="16b"))
        x, it, _ = svd(op)
        for it_ in (SVDS16_ITERS, 2 * SVDS16_ITERS):  # each length's plain solve and capture
            got = [svd(op, 0.0, it_)[1] for _ in range(2)]
            check(got == [it_, it_], f"16b {name}: svds ran {got} iterations, not {it_}")
        r["marginal"] = marginal_us(lambda n_, op=op: svd(op, 0.0, n_), SVDS16_ITERS,
                                    2 * SVDS16_ITERS)
        out_b[name] = dict(r, x=x, it=it)
    rp, rc = out_b["panel"], out_b["columns"]
    hp, hc = rp["held"], rc["held"]
    width = hc.get("bsr_rmatvec", 0) / max(hp.get("bsr_rmatmat", 0), 1)
    s0 = float(rp["x"][0])
    check(torch.equal(rp["x"], rc["x"]) and rp["it"] == rc["it"]
          and abs(s0 - spectra["svds"]) <= 1e-4 * abs(spectra["svds"])
          and abs(rp["it"] - spectra["svds_it"]) <= 1,
          f"16b: s₀ {s0} ({rp['it']} iterations) against the column loop's {float(rc['x'][0])} "
          f"({rc['it']}) and phase 11b's {spectra['svds']} ({spectra['svds_it']})")
    check(hp.get("bsr_rmatmat", 0) > 0 and hp.get("bsr_rmatvec", 0) == 0
          and hc.get("bsr_rmatmat", 0) == 0 and width >= 2,
          f"16b: the panel's cached block recorded {hp}, the column loop's {hc}")
    rec["16b"] = dict(panel=rp, columns=rc, width=width)
    (wp, ep), (wc, ec) = rp["marginal"], rc["marginal"]
    print(f"[16b svds panels] svds(k=4, tol 1e-4) of phase 4's B: {rp['it']} iterations, s₀ "
          f"{s0:.9f} (phase 11b {spectra['svds']:.9f}), s and V bit for bit with the column "
          f"loop's T/H blocks; per cached block of {loop.BLOCK} iterations K2p "
          f"{hp.get('bsr_rmatmat', 0)} launches (one per H block) against K2's "
          f"{hc.get('bsr_rmatvec', 0)} ({width:.2f} per H block); per iteration (marginal over "
          f"{SVDS16_ITERS} and {2 * SVDS16_ITERS}): panel wall {wp:.1f} us, CUDA events "
          f"{ep:.1f} us; column loop wall {wc:.1f} us, events {ec:.1f} us (event ratio "
          f"{ep / ec:.3f}); trace readings (loop_modes): busy {rp['busy'][1]:.2f} panel, "
          f"{rc['busy'][1]:.2f} column loop; {card}", flush=True)
    del B, Bc, out_b
    free()

    # --- 16c. the Nyström sketch of slice 1's graph: one K2p launch per Bᵀ block ----------
    mesh = make_mesh()
    Ah = main["A"].hermitianized()
    sk = {}
    for name, op in (("plain", Ah), ("sharded", shard_operator(Ah, mesh))):
        before = {k_: launches.get(k_, 0) for k_ in ("bsr_rmatmat", "bsr_rmatvec")}
        gen.manual_seed(SEED + 122)  # 13i e's seed
        P = on_path(lambda op=op: nystrom_preconditioner(op, 20, generator=gen))
        sk[name] = (P.U.full_tensor() if hasattr(P.U, "full_tensor") else P.U,
                    P.lam.full_tensor() if hasattr(P.lam, "full_tensor") else P.lam)
        got = {k_: launches.get(k_, 0) - before[k_] for k_ in before}
        check(got == {"bsr_rmatmat": 2, "bsr_rmatvec": 0},
              f"16c {name}: the sketch launched {got}, not one K2p per Bᵀ block (two)")
        del P
    U_p, lam_p = sk["plain"]
    U_s, lam_s = sk["sharded"]
    check(torch.equal(U_p, U_s) and torch.equal(lam_p, lam_s) and torch.isfinite(lam_p).all(),
          "16c: the sharded sketch differs from the unsharded one")
    print(f"[16c nystrom panels] the Nyström sketch (rank 20) of slice 1's graph (A + Aᴴ)/2: "
          f"one K2p launch per Bᵀ block (2: one in each term), no K2; through shard_operator at "
          f"world size 1 the same launches and U, λ bit for bit; λ₀ {float(lam_p[0]):.6e}; "
          f"{card}", flush=True)
    del Ah, sk, U_p, U_s

    # --- 16d. the gradient of ½‖Bᵀ M − Y‖² ----------------------------------------------
    g16 = torch.Generator(device=dev).manual_seed(SEED + 161)
    M = torch.randn((N, 8), generator=g16, device=dev)
    Y = torch.randn((N, 8), generator=g16, device=dev)
    grads, calls = {}, []
    n_block = lt.BSROperator._nmat_impl
    for backend in ("auto", "torch"):
        leaf = main["blocks"].detach().clone().requires_grad_(True)
        Bg = lt.BSROperator(lt.BSR(leaf, main["cols"], (N, N)), backend=backend)
        Mg = M.clone().requires_grad_(True)
        if backend == "auto":
            loss = on_path(lambda: 0.5 * (Bg.apply_matrix(Mg, "T") - Y).pow(2).sum())
            fwd = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
            lt.BSROperator._nmat_impl = lambda *a, **kw: calls.append(1) or n_block(*a, **kw)
            try:
                grads[backend] = on_path(lambda: torch.autograd.grad(loss, (Mg, leaf)))
            finally:
                lt.BSROperator._nmat_impl = n_block
            bwd = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
        else:
            loss = 0.5 * (Bg.apply_matrix(Mg, "T") - Y).pow(2).sum()
            grads[backend] = torch.autograd.grad(loss, (Mg, leaf))
        del leaf, Bg, Mg, loss
    (gM, gB), (gM_p, gB_p) = grads["auto"], grads["torch"]
    e_M, e_B = rel_err(gM, gM_p), rel_err(gB, gB_p)
    check(fwd == {"bsr_rmatmat": 1} and bwd == {"bsr_matmat": 1} and calls == [1]
          and e_M <= KERNEL_RTOL and e_B <= KERNEL_RTOL,
          f"16d: forward launches {fwd}, backward {bwd} with {len(calls)} N blocks; gradients "
          f"{e_M:.2e} (M), {e_B:.2e} (blocks) from the plain backend's (limit {KERNEL_RTOL:g})")
    print(f"[16d panel gradient] ½‖Bᵀ M − Y‖², M (n, 8): forward launches {fwd}; backward: one "
          f"N block (K1p) for M, a gather and an outer product for the "
          f"blocks, launches {bwd or 'none'}; against the plain backend's autograd: M "
          f"{e_M:.2e}, blocks {e_B:.2e} (limit {KERNEL_RTOL:g}); {card}", flush=True)
    del grads, gM, gB, gM_p, gB_p, M, Y
    free()
    seconds = time.perf_counter() - t_phase
    print(f"[16 block transposes] launches on 16's paths {launches}; {seconds:.1f} s", flush=True)
    return rec, launches


# ----------------------------------------------------------------------------
# Slice 21: a BSR operator's forward blocks in one launch (K1p, K3p, K5p)
# ----------------------------------------------------------------------------

PANEL17_KS = (1, 3, 8, 12, 32)  # 17a: block widths checked (8 timed)
LOB17_K, LOB17_ITERS = 4, 20  # 17b: LOBPCG block and timed iterations (and twice as many)
VCG17_ITERS = 20  # 17c: vmapped CG iterations timed (tol 0), and twice as many
PANEL17_KERNELS = {  # kernel -> (source, the TPU kernel its vmap batches, 17a's case of record)
    "bsr_matmat": (K1_SOURCE, K1_REPLACES, "8x128 float32"),  # K1p
    "bsr_matmat_windowed": (WIN_SOURCE, WIN_KERNELS["bsr_matvec_windowed"][0],
                            "banded float32"),  # K3p
    "bsr_matmat_multiwin": (WIN_SOURCE, WIN_KERNELS["bsr_matvec_multiwin"][0],
                            "band+cluster float32"),  # K5p
}


def matmat_n_block(lt, B):
    """B with its N block as the port ran it before K1p (``bsr_matmat``'s
    gather and einsum, cuBLAS inside) and its T/H blocks B's own (K2p): 17b's
    yardstick, capture-safe."""
    from linops_tpu_torch.kernels import bsr_spmv as K

    d = B.data
    bn = d.block_shape[1]

    class MatmatN(lt.FunctionOperator):
        def apply_matrix(self, M, mode="N"):
            if mode != "N":
                return B.apply_matrix(M, mode)
            Y = K.bsr_matmat_plain(d.blocks, d.block_cols, M.reshape(-1, bn, M.shape[1]))
            return Y.reshape(-1, M.shape[1])[: B.nrow]

    return MatmatN(B.nrow, B.ncol, lambda v: B.apply(v, "N"), lambda u: B.apply(u, "T"),
                   dtype=B.dtype, capture_safe=True)


def panel17_cases(lt, K, dev):
    """17a's operators, one at a time (tag, kernel name, panel(X), plain(X),
    vector(x), bsr_matmat(X), rows of X, blocks, the plan tensors the
    kernel reads, the CSR of A maker, the operator or None): phase 5's 8x128
    (f32, bf16) and 128x128 (f32) operators (K1p), the 2^22 banded (K3p) and
    band + far cluster (K5p) window operators (f32)."""
    for name, dtype in (("8x128", torch.float32), ("8x128", torch.bfloat16),
                        ("128x128", torch.float32)):
        bm, bn, _ = SHAPES[name]
        blocks, cols = make_bsr(name, dtype, dev)
        yield (f"{name} {str(dtype)[6:]}", "bsr_matmat",
               lambda X: K.bsr_matmat_kernel(blocks, cols, X),
               lambda X: K._fwd_plain(K.bsr_matmat_plain, X, bn, blocks, cols),
               lambda x: K.bsr_matvec_kernel(blocks, cols, x.reshape(-1, bn)).reshape(-1),
               lambda X: K.bsr_matmat_plain(blocks, cols, X.reshape(-1, bn, X.shape[1])),
               N, blocks, (cols,), lambda: csr_of_bsr(blocks, cols, N), None)
        del blocks, cols
        free()
    for wname in ("banded", "band+cluster"):
        op = win_operator(lt, wname, torch.float32, dev, SEED + 31)
        d = op.data
        win = dict(wb=op._wb, x_pad_blocks=op._x_pad_blocks)
        if op.cols_local is not None:
            kern, args = "bsr_matmat_windowed", (d.blocks, op.cols_local, op.win_q)
            panel = lambda X: K.bsr_matmat_windowed_kernel(*args, X, **win)  # noqa: E731
            plain1 = lambda X: K._fwd_plain(  # noqa: E731
                K.bsr_matvec_windowed_plain, X, 128, *args, **win)
            reads = (op.cols_local, op.win_q)
        else:
            kern, args = "bsr_matmat_multiwin", (d.blocks, d.block_cols, op.win_q)
            panel = lambda X: K.bsr_matmat_multiwin_kernel(  # noqa: E731
                *args, X, index=op.lane_rows, **win)
            plain1 = lambda X: K._fwd_plain(  # noqa: E731
                K.bsr_matvec_multiwin_plain, X, 128, *args, **win)
            reads = (op.lane_rows, op.win_q)

        def pieces(X, plain=plain1):  # the plain panel, PLAIN16_COLS columns at a time
            return torch.cat([plain(X[:, j:j + PLAIN16_COLS])
                              for j in range(0, X.shape[1], PLAIN16_COLS)], dim=1)

        yield (f"{wname} float32", kern, panel, pieces,
               lambda x, op=op: win_kernel(K, op, xb=x.reshape(-1, 128)).reshape(-1),
               lambda X, d=d: K.bsr_matmat_plain(d.blocks, d.block_cols,
                                                 X.reshape(-1, 128, X.shape[1])),
               WIN_N, d.blocks, reads, lambda d=d: csr_of_bsr(d.blocks, d.block_cols, WIN_N), op)
        del op, d, args, panel, plain1, pieces
        free()


def phase17(lt, loop, mods, dev, card, main):
    """A BSR operator's forward blocks in one launch (f32 unless named): the
    N block on the card, a symmetric operator's T block and
    ``torch.func.vmap`` of an N vector apply, as the reference's vmapped
    K1/K3/K5 are one batched kernel. (a) K1p, K3p and K5p
    (``bsr_matmat*_kernel``) on ``panel17_cases`` at k in PANEL17_KS: within
    KERNEL_RTOL of the plain panel (the 2^22 operators' PLAIN16_COLS columns
    at a time), the same bits on a rerun, bit for bit the vector kernel's
    column loop, a row panel's transposed view the same bits, laid out in
    rows; at k = 8 µs per call in a CUDA graph of 20 and by marginal CUDA
    events beside the column loop, ``bsr_matmat`` on the same X (the N block
    before K1p), the plain panel and cuSPARSE's SpMM on a CSR of A; the
    bound: bytes of the blocks, X, the result and the plan read once (the
    kernels' own: the blocks once per tile of PANEL_TILE columns) against 2
    nnz k f32 operations. The window operators' N blocks also through
    ``estimate_trace(A Aᵀ)`` (8 probes: one forward panel launch), within 6
    standard errors of ‖A‖_F². (b) svds(k = 4, tol 1e-4) of phase 4's B in
    cached captured blocks (``loop_modes``) and the same with its N block as
    ``bsr_matmat`` (``matmat_n_block``): s within 1e-5, iterations ±1,
    launches per cached block, wall and CUDA-event µs per iteration both
    ways; LOBPCG(k = 4) on slice 2's symmetric I + L (1536², K3's plan) in
    cached blocks: K3p launches and no K3 in its block, θ within its f64
    residual of the closed-form eigenvalues, µs per iteration; the
    operator's T block the same bits and launches as its N block. (c)
    ``torch.func.vmap`` of an N vector apply of phase 5's 8x128 operator: one
    K1p launch, bit for bit the column loop; a vmapped CG over 8 right-hand
    sides of slice 1's graph: at most ⌈I/BLOCK⌉ + 1 host reads, x and counts
    bit for bit the per-iteration vmap loop's (BLOCK 1), captured and
    cached (reads, captures, replays), timed against the eager vmap blocks.
    (d) a ``FunctionOperator`` over a dense matmul: a block of 8 columns in
    one call of the function, within KERNEL_RTOL of the column loop's 8
    calls (a matrix product against 8 matrix-vector products); the same
    over DTensors split by rows at world size 1, one call, the column
    loop's placements. (e) the
    gradient of ½‖A_sym M − Y‖² (the T block of a symmetric 8x128 operator,
    8 columns) in the blocks and in M against the plain backend's autograd
    within KERNEL_RTOL: one K1p launch forward, one K2p in the backward.
    Launches are counted over 17's paths alone (``on_path``: (a)'s
    estimates, (b)'s solves, (c), (d), (e)). Returns (records, launches)."""
    from linops_tpu_torch.kernels import bsr_spmv as K

    t_phase = time.perf_counter()
    f32 = torch.float32
    launches, rec = {}, {}

    def on_path(fn):
        for m_ in mods:
            m_.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, c_ in all_launches(mods).items():
            launches[name] = launches.get(name, 0) + c_
        return out

    # --- 17a. the forward panels against their plain versions and column loops ----------
    for tag, kern, panel, plain, vector, matmat, rows, blocks, reads, csr, op in panel17_cases(
            lt, K, dev):
        errs, worst, long_call = {}, 0.0, blocks.numel() > 1 << 28  # the 2^22 operators
        for k in PANEL17_KS:
            X = torch.randn((rows, k), device=dev)
            P = panel(X)
            P2 = panel(X)
            torch.cuda.synchronize()
            loop_ = torch.stack([vector(X[:, j].contiguous()) for j in range(k)], dim=1)
            Pr = panel(X.t().contiguous().t())
            ref = plain(X)
            errs[k] = rel_err(P, ref)
            check(torch.isfinite(P).all() and tuple(P.shape) == (loop_.shape[0], k)
                  and errs[k] <= KERNEL_RTOL and torch.equal(P, P2) and torch.equal(P, loop_)
                  and torch.equal(Pr, P) and Pr.t().is_contiguous(),
                  f"17a {kern} {tag} k={k}: {errs[k]:.2e} from the plain panel (limit "
                  f"{KERNEL_RTOL:g}), rerun {torch.equal(P, P2)}, column loop "
                  f"{torch.equal(P, loop_)}, row panel {torch.equal(Pr, P)} "
                  f"(in rows: {Pr.t().is_contiguous()})")
            if k == 8:
                worst = float((P - ref).abs().max())
            del X, P, P2, loop_, Pr, ref
        k = 8
        timer = few_ms if long_call else marginal_ms
        X = torch.randn((rows, k), device=dev)
        t_ = dict(graph=graph_ms(lambda: panel(X)), events=timer(lambda: panel(X)),
                  loop_graph=graph_ms(lambda: [vector(X[:, j]) for j in range(k)]),
                  loop_events=timer(lambda: [vector(X[:, j]) for j in range(k)]),
                  matmat=timer(lambda: matmat(X)))
        P = panel(X)
        ref = plain(X)
        t_["bound"] = bound_ms(nbytes(blocks, X, P, *reads), 2 * blocks.numel() * k)
        t_["design_bound"] = bound_ms(nbytes(blocks) * -(-k // PANEL_TILE)
                                      + nbytes(X, P, *reads), 2 * blocks.numel() * k)
        t_["plain"] = few_ms(lambda: plain(X), 1, 3) if long_call else marginal_ms(lambda: plain(X))
        t_["library"], t_["library_err"], t_["library_note"] = spmm_time(csr, X, ref, timer)
        del X, P, ref
        if op is not None:  # the window operator's N block on a path: estimate_trace(A Aᵀ)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 170)
            before = launches.get(kern, 0)
            tr, se = on_path(lambda: lt.estimate_trace(op @ op.T, probes=8, method="hutchinson",
                                                       generator=gen))
            fro2 = float(op.data.blocks.double().pow(2).sum())
            check(launches.get(kern, 0) - before == 1 and abs(float(tr) - fro2) <= 6 * float(se),
                  f"17a {tag}: estimate_trace(A Aᵀ) {float(tr)} ± {float(se)} against ‖A‖_F² "
                  f"{fro2}, {launches.get(kern, 0) - before} {kern} launches")
            t_["trace"] = (float(tr), float(se), fro2)
        rec[(kern, tag)] = dict(errs=errs, max_abs_err=worst, times=t_)
        print(f"[17a forward panels] {kern} {tag}: max|Δ|/max|y| against the plain panel "
              + ", ".join(f"k={k_} {e:.2e}" for k_, e in errs.items())
              + f" (limit {KERNEL_RTOL:g}); every k bit for bit the vector kernel's column loop, "
              f"the same bits on a rerun and through a row panel's view (its result in rows); "
              f"k=8: {t_['graph'] * 1e3:.1f} us in a graph of 20, {t_['events'] * 1e3:.1f} us by "
              f"events, column loop {t_['loop_graph'] * 1e3:.1f} / "
              f"{t_['loop_events'] * 1e3:.1f} us, bsr_matmat {t_['matmat'] * 1e3:.1f} us, "
              f"bound {t_['bound'][0] * 1e3:.1f} us ({t_['bound'][1]}; blocks once per "
              f"{PANEL_TILE} columns: {t_['design_bound'][0] * 1e3:.1f} us), plain "
              f"{t_['plain'] * 1e3:.1f} us"
              + (f" ({PLAIN16_COLS} columns at a time)" if op is not None else "")
              + ", cuSPARSE SpMM on a CSR of A "
              + ("null" if t_["library"] is None else f"{t_['library'] * 1e3:.1f} us")
              + f" ({t_['library_note']})"
              + (f"; estimate_trace(A Aᵀ, 8 probes) {t_['trace'][0]:.6e} ± "
                 f"{t_['trace'][1]:.2e} against ‖A‖_F² {t_['trace'][2]:.6e}, one {kern} launch"
                 if op is not None else "")
              + f"; {card}", flush=True)
        del panel, plain, vector, matmat, blocks, reads, csr, op
        free()

    # --- 17b. blocks on the solve paths, in cached captured blocks --------------------------
    B = lt.BSROperator(lt.BSR(main["blocks"], main["cols"], (N, N)))
    Bm = matmat_n_block(lt, B)
    gen = torch.Generator(device=dev)

    def svd(op, tol=1e-4, maxiter=150):
        gen.manual_seed(SEED + 113)
        _, s_, V_, sres, it_ = lt.svds(op, k=4, tol=tol, maxiter=maxiter, generator=gen)
        return torch.cat([s_, V_.reshape(-1)]), it_, sres

    out_b = {}
    for name, op in (("panel", B), ("bsr_matmat", Bm)):
        tag = (f"17b svds(k=4, tol 1e-4) of phase 4's B (n = {N})"
               + (" with its N block as bsr_matmat" if name == "bsr_matmat" else ""))
        run = on_path if name == "panel" else (lambda f: f())
        r = run(lambda op=op, tag=tag: loop_modes(loop, tag, lambda: svd(op), phase="17b"))
        x, it, _ = svd(op)
        for it_ in (SVDS16_ITERS, 2 * SVDS16_ITERS):  # each length's plain solve and capture
            got = [svd(op, 0.0, it_)[1] for _ in range(2)]
            check(got == [it_, it_], f"17b {name}: svds ran {got} iterations, not {it_}")
        r["marginal"] = marginal_us(lambda n_, op=op: svd(op, 0.0, n_), SVDS16_ITERS,
                                    2 * SVDS16_ITERS)
        out_b[name] = dict(r, x=x, it=it)
    rp, rm = out_b["panel"], out_b["bsr_matmat"]
    hp, hm = rp["held"], rm["held"]
    ds = rel_err(rp["x"][:4], rm["x"][:4])
    check(ds <= 1e-5 and abs(rp["it"] - rm["it"]) <= 1 and hp.get("bsr_matmat", 0) > 0
          and hp.get("bsr_matvec", 0) == 0 and hm.get("bsr_matmat", 0) == 0,
          f"17b: s {ds:.2e} from bsr_matmat's N block ({rp['it']} against {rm['it']} "
          f"iterations); the cached blocks recorded {hp} (K1p) and {hm} (bsr_matmat)")
    (wp, ep), (wm, em) = rp["marginal"], rm["marginal"]
    print(f"[17b svds forward panels] svds(k=4, tol 1e-4) of phase 4's B: {rp['it']} iterations, "
          f"s within {ds:.2e} of the same solve with its N block as bsr_matmat "
          f"({rm['it']} iterations); per cached block of {loop.BLOCK} iterations K1p "
          f"{hp.get('bsr_matmat', 0)} launches, K2p {hp.get('bsr_rmatmat', 0)} (bsr_matmat's: "
          f"{ {k_: v_ for k_, v_ in hm.items() if k_.startswith('bsr')} }); per iteration "
          f"(marginal over {SVDS16_ITERS} and {2 * SVDS16_ITERS}): K1p wall {wp:.1f} us, CUDA "
          f"events {ep:.1f} us; bsr_matmat wall {wm:.1f} us, events {em:.1f} us (event ratio "
          f"{ep / em:.3f}); trace readings (loop_modes): busy {rp['busy'][1]:.2f} K1p, "
          f"{rm['busy'][1]:.2f} bsr_matmat; {card}", flush=True)
    rec["17b svds"] = dict(panel=rp, matmat=rm)
    del B, Bm, out_b
    free()

    A_il = laplacian(GRID)
    L_op = lt.opSparse(A_il, format="bsr", block_shape=(8, 128), symmetric=True, hermitian=True)
    check(L_op.cols_local is not None, "17b: slice 2's I + L got no banded window plan")
    n_il = A_il.shape[0]

    def lob(iters=LOB17_ITERS):
        gen.manual_seed(SEED + 171)
        th_, X_, res_, it_ = lt.lobpcg(L_op, k=LOB17_K, tol=0.0, maxiter=iters, generator=gen)
        return torch.cat([th_, X_.reshape(-1)]), it_, res_

    r = on_path(lambda: loop_modes(loop, f"17b lobpcg(k={LOB17_K}) on I + L ({GRID}²)",
                                   lob, phase="17b"))
    for it_ in (LOB17_ITERS, 2 * LOB17_ITERS):
        got = [lob(it_)[1] for _ in range(2)]
        check(got == [it_, it_], f"17b lobpcg ran {got} iterations, not {it_}")
    r["marginal"] = marginal_us(lambda n_: lob(n_), LOB17_ITERS, 2 * LOB17_ITERS)
    gen.manual_seed(SEED + 171)
    theta, X, res, _ = lt.lobpcg(L_op, k=LOB17_K, tol=0.0, maxiter=LOB17_ITERS, generator=gen)
    r64, gaps = closed_form_gaps(five_point(GRID), GRID, theta - 1.0, X)  # I + L: θ − 1 for L
    hl = r["held"]
    check(hl.get("bsr_matmat_windowed", 0) > 0 and hl.get("bsr_matvec_windowed", 0) == 0,
          f"17b lobpcg: the cached block recorded {hl}, not K3p alone")
    Z = dev_vec(n_il, dev, SEED + 172, k=8)
    for m_ in mods:
        m_.reset_launch_counts()
    YN = L_op.apply_matrix(Z, "N")
    cN = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
    for m_ in mods:
        m_.reset_launch_counts()
    YT = L_op.apply_matrix(Z, "T")
    cT = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
    check(torch.equal(YN, YT) and cN == cT == {"bsr_matmat_windowed": 1},
          f"17b: the symmetric T block launched {cT} (N block {cN}), bit-equal "
          f"{torch.equal(YN, YT)}")
    wl, el = r["marginal"]
    print(f"[17b lobpcg forward panels] lobpcg(k={LOB17_K}, tol 0) on I + L ({GRID}², K3's "
          f"banded plan): per cached block of {loop.BLOCK} iterations K3p "
          f"{hl.get('bsr_matmat_windowed', 0)} launches, no K3; θ − 1 "
          f"{[round(float(t_) - 1.0, 8) for t_ in theta]}, f64 residuals "
          f"{[float(f'{v:.3e}') for v in r64]}, distance to the nearest closed-form eigenvalue "
          f"{[float(f'{v:.3e}') for v in gaps]}; per iteration (marginal over {LOB17_ITERS} and "
          f"{2 * LOB17_ITERS}): wall {wl:.1f} us, CUDA events {el:.1f} us; its T block (k = 8) "
          f"bit for bit its N block, one K3p launch each; {card}", flush=True)
    rec["17b lobpcg"] = r
    del L_op, A_il, Z, YN, YT, X, theta
    free()

    # --- 17c. vmap: an N vector apply, and a vmapped CG ---------------------------------
    blocks, cols = make_bsr("8x128", f32, dev, scale=(8 * 128) ** -0.5)
    B8 = lt.BSROperator(lt.BSR(blocks, cols, (N, N)))
    V = torch.stack([dev_vec(N, dev, SEED + 173 + i) for i in range(8)])
    Yv = on_path(lambda: torch.func.vmap(lambda v: B8.apply(v, "N"))(V))
    c_v = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
    with torch.no_grad():
        ref = torch.stack([B8.apply(v, "N") for v in V])
    check(torch.equal(Yv, ref) and c_v == {"bsr_matmat": 1},
          f"17c vmap N: bit-equal {torch.equal(Yv, ref)}, launches {c_v}")
    A1 = main["A"]
    Bs = torch.stack([dev_vec(N, dev, SEED + 181 + i) for i in range(8)])

    def vcg(tol=1e-5, maxiter=500):
        xs_, ks_, _ = torch.func.vmap(lambda b_: lt.cg(A1, b_, tol=tol, maxiter=maxiter))(Bs)
        return xs_, ks_, dict(loop.stats)

    def eager(fn):  # the eager vmap blocks the members' path replaced (loop._members refused)
        members = loop._members
        loop._members = lambda *a: False
        try:
            return fn()
        finally:
            loop._members = members

    xs, ks, st = on_path(vcg)  # the signature's first solve: eager masked blocks
    xs_c, ks_c, st_c = vcg()  # its second: captured (a signature cached before: replays)
    xs_r, ks_r, st_r = vcg()  # cached: replays
    block = loop.BLOCK
    loop.BLOCK = 1
    try:
        xs1, ks1, st1 = eager(vcg)  # the per-iteration vmap loop
    finally:
        loop.BLOCK = block
    xs_e, ks_e, st_e = eager(vcg)
    top = int(ks.max())
    same = all(torch.equal(x_, xs1) for x_ in (xs, xs_c, xs_r, xs_e)) and \
        all(torch.equal(k_, ks1) for k_ in (ks, ks_c, ks_r, ks_e))
    blocks_ = -(-top // block)

    def reads_ok(r):  # an eager or capturing solve reads once before its blocks; a replay not
        return r["reads"] == blocks_ + int(r["path"] == "vmap_blocks" or r["captures"] > 0)

    check(same and st["path"] in ("vmap_blocks", "vmap_graph") and st_c["path"] == "vmap_graph"
          and st_r["path"] == "vmap_graph" and st["captures"] + st_c["captures"] <= 1
          and st_r["captures"] == 0 and all(reads_ok(r) for r in (st, st_c, st_r))
          and st_r["replays"] == blocks_ and st_e["path"] == "vmap" and st1["reads"] == top + 1,
          f"17c vmap(cg): x and counts bit-equal {same} ({ks.tolist()} against {ks1.tolist()}); "
          f"paths {st['path']}, {st_c['path']}, {st_r['path']} (eager {st_e['path']}); reads "
          f"{st['reads']}, {st_c['reads']}, {st_r['reads']} (per iteration {st1['reads']}) for "
          f"{top} iterations; captures {st_c['captures']}, {st_r['captures']}; replays "
          f"{st_r['replays']}")
    for n_ in (VCG17_ITERS, 2 * VCG17_ITERS):  # each length's first solve and capture
        vcg(0.0, n_), vcg(0.0, n_)
    w_c, e_c = marginal_us(lambda n_: vcg(0.0, n_), VCG17_ITERS, 2 * VCG17_ITERS)
    w_e, e_e = eager(lambda: marginal_us(lambda n_: vcg(0.0, n_), VCG17_ITERS,
                                         2 * VCG17_ITERS))
    print(f"[17c vmap] torch.func.vmap over 8 vectors of A x (8x128, n = {N}): one K1p launch "
          f"{c_v}, bit for bit 8 vector applies; vmap(cg) over 8 right-hand sides of slice 1's "
          f"graph: per-member iterations {ks.tolist()}; host reads in blocks of {block}: "
          f"{st['reads']} on the signature's first solve (eager blocks), {st_c['reads']} on its "
          f"second (captures {st_c['captures']}), {st_r['reads']} cached (replays "
          f"{st_r['replays']}), the per-iteration vmap loop {st1['reads']}; x and counts bit for "
          f"bit in every mode; per iteration (tol 0, marginal over {VCG17_ITERS} and "
          f"{2 * VCG17_ITERS}): captured wall {w_c:.1f} us, CUDA events {e_c:.1f} us; the eager "
          f"vmap blocks wall {w_e:.1f} us, events {e_e:.1f} us; {card}", flush=True)
    rec["17c"] = dict(reads=st_r["reads"], reads_first=st["reads"], reads_capture=st_c["reads"],
                      reads_per_iteration=st1["reads"], iters=top, replays=st_r["replays"],
                      wall_us=w_c, events_us=e_c, eager_wall_us=w_e, eager_events_us=e_e)
    del B8, V, Yv, ref, Bs, xs, xs1, xs_c, xs_r, xs_e

    # --- 17d. a FunctionOperator's block: one call of the function ----------------------
    nf = 4096
    gd = torch.Generator(device=dev).manual_seed(SEED + 175)
    Ad = torch.randn((nf, nf), generator=gd, device=dev) / nf ** 0.5
    calls = []
    F = lt.FunctionOperator(nf, nf, lambda v: calls.append(1) or Ad @ v, dtype=f32)
    Md = torch.randn((nf, 8), generator=gd, device=dev)
    Yf = on_path(lambda: F.apply_matrix(Md))
    n_block = len(calls)
    loop_f = torch.stack([F.apply(Md[:, j]) for j in range(8)], dim=1)
    e_f = rel_err(Yf, loop_f)
    check(n_block == 1 and len(calls) == 9 and e_f <= KERNEL_RTOL,
          f"17d: {n_block} calls for the block (the loop {len(calls) - n_block}), {e_f:.2e} from "
          f"the column loop")
    print(f"[17d function blocks] a FunctionOperator over a dense {nf}² matmul: a block of 8 "
          f"columns in {n_block} call of the function (the column loop: {len(calls) - n_block}), "
          f"{e_f:.2e} from the column loop (limit {KERNEL_RTOL:g}: f32 sums of {nf} terms in "
          f"cuBLAS's orders); {card}", flush=True)
    from torch.distributed.tensor import Shard, distribute_tensor

    from linops_tpu_torch.core.base import LinearOperator
    from linops_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    Ad_s = distribute_tensor(Ad, mesh, [Shard(0)])
    Md_s = distribute_tensor(Md, mesh, [Shard(0)])
    calls_s = []
    Fs = lt.FunctionOperator(nf, nf, lambda v: calls_s.append(1) or Ad_s @ v, dtype=f32)
    Ys = on_path(lambda: Fs.apply_matrix(Md_s))
    n_block_s = len(calls_s)
    loop_s = LinearOperator.apply_matrix(Fs, Md_s)
    Ys_, loop_s_ = Ys.full_tensor(), loop_s.full_tensor()
    e_s = rel_err(Ys_, loop_s_)  # a block's product is cuBLAS's gemm, a column's its gemv
    bits_s = (torch.equal(Ys_, Yf), torch.equal(Ys_, loop_s_))
    check(n_block_s == 1 and len(calls_s) == 9 and e_s <= KERNEL_RTOL
          and Ys.placements == loop_s.placements,
          f"17d DTensor: {n_block_s} calls for the block (the loop {len(calls_s) - n_block_s}), "
          f"{e_s:.2e} from the column loop, placements {Ys.placements} against "
          f"{loop_s.placements}")
    print(f"[17d function blocks] the same function over DTensors at world size 1 (A and the "
          f"block split by rows): {n_block_s} call for the block (the column loop: "
          f"{len(calls_s) - n_block_s}), {e_s:.2e} from the column loop (limit {KERNEL_RTOL:g}); "
          f"bit for bit the plain block {bits_s[0]}, the column loop {bits_s[1]}; placements "
          f"{Ys.placements} as the loop's; torch {torch.__version__}; {card}", flush=True)
    del Ad, F, Md, Yf, loop_f, Ad_s, Md_s, Fs, Ys, loop_s, Ys_, loop_s_

    # --- 17e. the gradient of ½‖A_sym M − Y‖² (a symmetric operator's T block) ---------------
    g17 = torch.Generator(device=dev).manual_seed(SEED + 176)
    M = torch.randn((N, 8), generator=g17, device=dev)
    Y = torch.randn((N, 8), generator=g17, device=dev)
    grads = {}
    for backend in ("auto", "torch"):
        leaf = blocks.detach().clone().requires_grad_(True)
        As = lt.BSROperator(lt.BSR(leaf, cols, (N, N)), symmetric=True, backend=backend)
        Mg = M.clone().requires_grad_(True)
        if backend == "auto":
            loss = on_path(lambda: 0.5 * (As.apply_matrix(Mg, "T") - Y).pow(2).sum())
            fwd = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
            grads[backend] = on_path(lambda: torch.autograd.grad(loss, (Mg, leaf)))
            bwd = {k_: v_ for k_, v_ in all_launches(mods).items() if v_}
        else:
            loss = 0.5 * (As.apply_matrix(Mg, "T") - Y).pow(2).sum()
            grads[backend] = torch.autograd.grad(loss, (Mg, leaf))
        del leaf, As, Mg, loss
    (gM, gB), (gM_p, gB_p) = grads["auto"], grads["torch"]
    e_M, e_B = rel_err(gM, gM_p), rel_err(gB, gB_p)
    check(fwd == {"bsr_matmat": 1} and bwd == {"bsr_rmatmat": 1}
          and e_M <= KERNEL_RTOL and e_B <= KERNEL_RTOL,
          f"17e: forward launches {fwd}, backward {bwd}; gradients {e_M:.2e} (M), {e_B:.2e} "
          f"(blocks) from the plain backend's (limit {KERNEL_RTOL:g})")
    print(f"[17e forward panel gradient] ½‖A_sym M − Y‖² (the T block of a symmetric 8x128 "
          f"operator), M (n, 8): forward launches {fwd}; backward launches {bwd} (the M-gradient "
          f"one K2p, the blocks' a gather and an outer product); against the plain backend's "
          f"autograd: M {e_M:.2e}, blocks {e_B:.2e} (limit {KERNEL_RTOL:g}); {card}", flush=True)
    del grads, gM, gB, gM_p, gB_p, M, Y, blocks, cols
    free()
    seconds = time.perf_counter() - t_phase
    print(f"[17 forward panels] launches on 17's paths {launches}; {seconds:.1f} s", flush=True)
    return rec, launches


def csr_of_bsr(blocks, cols, ncol):
    """A as a ``torch.sparse_csr_tensor`` with int32 indices, on the blocks'
    device: the blocks' values row by row (one copy), the column array made
    in int32 (no int64 copy of it)."""
    nbrow, kmax, bm, bn = blocks.shape
    check(blocks.numel() < 2**31, "a CSR of 2^31 or more values needs int64 indices")
    dev = blocks.device
    width = kmax * bn
    crow = torch.arange(0, nbrow * bm * width + 1, width, device=dev, dtype=torch.int32)
    col = (cols[:, None, :, None] * bn + torch.arange(bn, device=dev, dtype=torch.int32)).expand(
        nbrow, bm, kmax, bn).reshape(-1)
    vals = blocks.permute(0, 2, 1, 3).reshape(-1)
    return torch.sparse_csr_tensor(crow, col, vals, size=(nbrow * bm, ncol))


def csr_t_of_bsr(K, blocks, cols, nbcol, piece=1 << 14):
    """Aᵀ as a ``torch.sparse_csr_tensor`` with int32 indices, built once from
    the block-column index (``bsr_column_index``), ``piece`` slots at a time:
    row (c, n) of Aᵀ holds, for each slot of block column c in index order,
    the bm values blocks[slot, :, n] at columns row(slot)·bm + m."""
    nbrow, kmax, bm, bn = blocks.shape
    check(blocks.numel() < 2**31, "a CSR of 2^31 or more values needs int64 indices")
    dev = blocks.device
    perm, colptr = K.bsr_column_index(cols, nbcol)
    cp = colptr.long()
    cnt = cp[1:] - cp[:-1]
    crow = torch.zeros(nbcol * bn + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum((cnt * bm)[:, None].expand(nbcol, bn).reshape(-1), 0)
    vals = torch.empty(blocks.numel(), dtype=blocks.dtype, device=dev)
    col = torch.empty(blocks.numel(), dtype=torch.int32, device=dev)
    flat, flat_cols = blocks.reshape(-1, bm, bn), cols.reshape(-1)
    m_i, n_i = torch.arange(bm, device=dev), torch.arange(bn, device=dev)
    for p0 in range(0, perm.numel(), piece):
        slot = perm[p0:p0 + piece].long()
        c = flat_cols[slot].long()
        j = torch.arange(p0, p0 + slot.numel(), device=dev) - cp[c]  # rank in its column
        # value (j, m) of row (c, n) sits at crow[c·bn + n] + j·bm + m
        dest = ((cp[c] * (bm * bn) + j * bm)[:, None, None]
                + (cnt[c] * bm)[:, None, None] * n_i + m_i[:, None]).reshape(-1)
        vals[dest] = flat[slot].reshape(-1)
        col[dest] = ((slot // kmax) * bm)[:, None, None].add(m_i[:, None]).expand(
            -1, bm, bn).reshape(-1).int()
        del slot, c, j, dest
    del perm, colptr
    return torch.sparse_csr_tensor(crow.int(), col, vals, size=(nbcol * bn, nbrow * bm))


def library_time(what, build, v, ref):
    """ms of one cuSPARSE CSR matvec ``torch.mv(A, v)`` on the CSR that
    ``build()`` makes once, outside the timing, after a check against
    ``ref``: (ms, None), or (None, the reason) where PyTorch refuses the
    call, memory runs out or the result disagrees. Timed only here; the port
    never calls it."""
    import warnings

    A, reason = None, None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            A = build()
            e = rel_err(torch.mv(A, v), ref)
            if e <= KERNEL_RTOL:
                return marginal_ms(lambda: torch.mv(A, v)), None
            reason = f"disagrees with the plain version ({e:.2e})"
    except RuntimeError as err:  # includes torch.cuda.OutOfMemoryError
        reason = f"refused: {type(err).__name__}: {str(err).splitlines()[0][:160]}"
    finally:
        del A
        free()
    print(f"[5 times] {what}'s library call: {reason}; recorded as null", flush=True)
    return None, reason


def spmm_time(build, U, ref, timer):
    """16a's yardstick: ms of one cuSPARSE SpMM ``torch.sparse.mm(Aᵀ, U)`` on
    the CSR of Aᵀ that ``build()`` makes once, outside the timing, with U
    row-major and column-major (``U.t().contiguous().t()``), each timed by
    ``timer``; the faster is kept. A yardstick, not a check: each layout's
    max relative error against the plain panel ``ref`` is reported beside
    its time (cuSPARSE sums in f32 in an order of its own). Returns (ms,
    that layout's error, a note on both layouts), or (None, None, the
    reason) where PyTorch refuses both or memory runs out. Timed only here;
    the port never calls it."""
    import warnings

    A, runs, notes = None, {}, []
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            A = build()
            for layout, Ul in (("row-major", U), ("column-major", U.t().contiguous().t())):
                try:
                    e = rel_err(torch.sparse.mm(A, Ul), ref)
                    runs[layout] = (timer(lambda: torch.sparse.mm(A, Ul)), e)
                    notes.append(f"U {layout}: {runs[layout][0] * 1e3:.1f} us, max rel err "
                                 f"{e:.2e} against the plain panel")
                except RuntimeError as err:  # includes torch.cuda.OutOfMemoryError
                    notes.append(f"U {layout}: refused: {type(err).__name__}: "
                                 f"{str(err).splitlines()[0][:120]}")
                del Ul
    except RuntimeError as err:
        notes.append(f"the CSR of Aᵀ: {type(err).__name__}: {str(err).splitlines()[0][:120]}")
    finally:
        del A
        free()
    if not runs:
        return None, None, "; ".join(notes)
    ms, e = min(runs.values())
    return ms, e, "; ".join(notes)


def library_ms(blocks, cols, xb, ub, K):
    """(K1's, K2's) yardstick: ms of one cuSPARSE CSR matvec through
    ``torch.mv`` on a CSR of A (BSR needs square blocks there), and on a CSR
    of Aᵀ built once (as K2's column plan is built once per operator);
    None where PyTorch refuses the call or disagrees with the plain
    version."""
    nbcol = xb.shape[0]
    t1, _ = library_time("K1", lambda: csr_of_bsr(blocks, cols, xb.numel()), xb.reshape(-1),
                         K.bsr_matvec_plain(blocks, cols, xb).reshape(-1))
    t2, _ = library_time("K2", lambda: csr_t_of_bsr(K, blocks, cols, nbcol), ub.reshape(-1),
                         K.bsr_rmatvec_plain(blocks, cols, ub, nbcol).reshape(-1))
    return t1, t2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--panels"]:
        return panel_times(*sys.argv[2:4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import linops_tpu_torch as lt
    from linops_tpu_torch.kernels import bsr_spmv as K
    from linops_tpu_torch.kernels import build
    from linops_tpu_torch.kernels import lane_gather as LG
    from linops_tpu_torch.core.segsum import segment_plan

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
    from linops_tpu_torch.kernels import graph_cond as GC
    from linops_tpu_torch.kernels import small_eigh as E1
    from linops_tpu_torch.kernels import small_lstsq as E2

    sources = ("bsr_spmv", "bsr_window", "lane_gather", "small_eigh", "graph_cond", "small_lstsq")
    build.build_all(sources)  # one nvcc per source, in parallel
    K._lib(), K._win_lib(), LG._lib(), E1._lib(), GC._lib(), E2._lib()
    print("[2 build] -> sm_90a: " + ", ".join(
        f"{n}.cu " + (f"{build.build_seconds[n]:.2f} s" if build.build_seconds[n]
                      else "already built from this source hash")
        for n in sources)
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
            plan = K.bsr_column_plan(cols, nbcol, bm * bn * blocks.element_size())
            y = K.bsr_matvec_kernel(blocks, cols, xb)
            o = K.bsr_rmatvec_kernel(blocks, cols, ub, nbcol, plan=plan)
            o2 = K.bsr_rmatvec_kernel(blocks, cols, ub, nbcol, plan=plan)
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
            del blocks, cols, y, o, o2, y_plain, o_plain, y64, o64, plan

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

    def drive_main():
        """The main path, counted: build A and the preconditioner, solve (a
        structure's first solve: the cache emptied, as in a new process)."""
        lt.utils.loop.clear_cache()
        K.reset_launch_counts()
        A = graph("auto")
        H = lt.InverseLBFGSOperator(f32, N, mem=8, device=dev)
        for s in pair_s:
            H.push(s, A * s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, k, res = lt.cg(A, b, M=H, tol=1e-5, maxiter=500)
        torch.cuda.synchronize()
        return A, H, x, k, res, time.perf_counter() - t0, K.launch_counts()

    A, H, x, k, res, t_cg, launches = drive_main()
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
    win_launches, laplacian_op = phase7(lt, K, dev)
    ops = phase9(lt, K, LG, dev)
    lane_err, k8_launches, p3s = phase8(lt, LG, dev, ops)
    k1314_err, k13_launches = phase8_k13_k14(lt, LG, dev, ops)
    lane_err.update(k1314_err)

    # --- 5. times ---------------------------------------------------------------
    times = {}
    for name in SHAPES:
        bm, bn, kmax = SHAPES[name]
        nbcol = N // bn
        for dtype in (torch.float32, torch.bfloat16):
            blk, cl = make_bsr(name, dtype, dev)
            xb = torch.randn((nbcol, bn), device=dev)
            ub = torch.randn((N // bm, bm), device=dev)
            plan = K.bsr_column_plan(cl, nbcol, bm * bn * blk.element_size())
            seg_plan = segment_plan(cl, nbcol)  # the plain K2's order, built once as K2's plan
            gb = blk.numel() * blk.element_size() / 1e9
            row = {
                "K1": marginal_ms(lambda: K.bsr_matvec_kernel(blk, cl, xb)),
                "K1 plain": marginal_ms(lambda: K.bsr_matvec_plain(blk, cl, xb)),
                "K2": marginal_ms(lambda: K.bsr_rmatvec_kernel(blk, cl, ub, nbcol, plan=plan)),
                "K2 plain": marginal_ms(lambda: K.bsr_rmatvec_plain(blk, cl, ub, nbcol,
                                                                    plan=seg_plan)),
            }
            if name == "8x128" and dtype == torch.float32:  # the main path's case
                row["K1 bound"] = bound_ms(nbytes(blk, cl, xb) + N * 4, 2 * blk.numel())
                row["K2 bound"] = bound_ms(nbytes(blk, cl, ub) + nbcol * bn * 4, 2 * blk.numel())
                row["K1 library"], row["K2 library"] = library_ms(blk, cl, xb, ub, K)
            times[(name, dtype)] = row
            print(f"[5 times] {name} kmax={kmax} blocks {str(dtype)[6:]} ({gb * 1e3:.1f} MB stored): "
                  + ", ".join(f"{k} {v * 1e3:.1f} us = {gb / (v / 1e3):.0f} GB/s"
                              for k, v in row.items() if " " not in k or k.endswith("plain"))
                  + f"; {card}", flush=True)
            if "K1 bound" in row:
                libs = ", ".join(f"{k} {row[k + ' library'] * 1e3:.1f} us" if row[k + " library"]
                                 else f"{k} none" for k in ("K1", "K2"))
                print(f"[5 times] {name} f32 bounds: K1 {row['K1 bound'][0] * 1e3:.1f} us, K2 "
                      f"{row['K2 bound'][0] * 1e3:.1f} us ({row['K1 bound'][1]}); cuSPARSE CSR "
                      f"matvec through torch.mv (K1: a CSR of A; K2: a CSR of Aᵀ, built once): "
                      f"{libs}; {card}", flush=True)
            del blk, cl, xb, ub, plan, seg_plan

    def cg_iter_ms(op):
        def run(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lt.cg(op, b, M=H, tol=0.0, maxiter=iters)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3
        run(I_SHORT)  # the plain loop (the signature's first solve)
        run(I_SHORT)  # captures the block
        return float(np.median([(run(I_LONG) - run(I_SHORT)) / (I_LONG - I_SHORT)
                                for _ in range(REPS)]))

    cg_kernel, cg_plain = cg_iter_ms(A), cg_iter_ms(A_plain)
    print(f"[5 times] cg iteration (2 BSR applies, 1 L-BFGS apply; captured blocks of "
          f"{lt.utils.loop.BLOCK}, 1 host read per block), 8x128 f32: "
          f"kernels {cg_kernel * 1e3:.1f} us, plain backend {cg_plain * 1e3:.1f} us; {card}",
          flush=True)

    win_times = phase5_windows(lt, K, dev, card)
    lane_times = phase5_lanes(lt, LG, dev, ops, p3s, card)

    # the main path once more under torch.profiler (after phase 5's traces):
    # the same launch counts as phase 4's run, and those the trace counts
    free()
    (*_, k_again, _, _, counted), _, traced, tries = trace_until(drive_main, by_symbol(launches))
    check(counted == launches and k_again == k and traced == by_symbol(launches),
          f"the main path's launch counts {launches} (rerun {counted}, {k_again} iterations) "
          f"are not the kernels its trace ran {traced} ({tries} traces)")
    print(f"[4 main path] rerun under torch.profiler: {k_again} iterations, launch counts "
          f"{ {n_: c_ for n_, c_ in counted.items() if c_} } = the trace's kernels {traced} "
          f"(trace {tries} of up to {TRACE_TRIES})", flush=True)

    # --- 11. slice 6 (after the times; it runs no profiler) ---------------------
    _, slice6 = phase11(lt, K, LG, dev, card, ops, {"blocks": blocks, "cols": cols, "A": A,
                                                    "A_plain": A_plain, "H": H, "b": b})

    # --- 12. slice 7: gradients (after the times; it runs no profiler) ------------
    ad_launches, _ = phase12(lt, K, LG, dev, card)
    for name in ("bsr_matvec", "bsr_rmatvec", "bsr_matvec_windowed", "bsr_rmatvec_windowed",
                 "bsr_matvec_multiwin", "bsr_rmatvec_multiwin", "lane_gather",
                 "lane_gather_mul_segsum", "lane_gather_sum"):
        check(ad_launches[name] > 0, f"{name} never ran in a backward on the slice-7 path")

    # --- 13. slice 8: the distributed layer, world size 1 (no profiler) -----------------
    dist_launches = phase13(lt, K, LG, dev, card, ops)
    for name in ("bsr_matvec", "bsr_rmatvec", "bsr_matvec_windowed", "bsr_rmatvec_windowed",
                 "bsr_matvec_multiwin", "bsr_rmatvec_multiwin", "lane_gather",
                 "lane_gather_sum", "lane_segsum", "lane_gather_mul_segsum"):
        check(any(c_.get(name, 0) > 0 for c_ in dist_launches.values()),
              f"{name} never ran under shard_operator on the slice-8 path")

    # --- 10. slice 4 (after the times: its profiler traces come last) ---------
    slice4_launches, _ = phase10(lt, K, LG, dev, ops, laplacian_op)
    check(slice4_launches["small_lstsq"] > 0, "E2 never ran in 10a's GMRES")
    # --- 14. slice 9: the device loop (profiler traces, after phase 5) ----------
    rec14, held = phase14(lt, K, LG, dev, card, ops, {"A": A, "H": H, "b": b}, laplacian_op)
    check(held.get("small_lstsq", 0) > 0, "E2 is in no captured block of the slice-14 path")
    # --- 13h. DTensor vectors wherever the reference takes a sharded array (after 14:
    # it prints 14d's and 14h's unsharded numbers beside its own) ------------------------
    dt_launches = phase13h(lt, lt.utils.loop, K, LG, dev, card, ops, {"A": A, "b": b}, rec14)
    for name in ("small_lstsq", "while_condition", "lane_gather", "lane_gather_mul_t_batched",
                 "lane_gather_sum", "lane_segsum", "bsr_matvec", "bsr_rmatvec"):
        check(any(c_.get(name, 0) > 0 for c_ in dt_launches.values()),
              f"{name} never ran on the 13h path (DTensor vectors)")
    del laplacian_op
    _, fresh = phase14g(lt, lt.utils.loop, K, dev, card,
                        {"cols": cols, "sigma": sigma, "b": b, "pair_s": pair_s})
    for name in ("bsr_matvec", "bsr_rmatvec", "bsr_matvec_windowed", "bsr_rmatvec_windowed"):
        check(fresh.get(name, 0) > 0, f"{name} is in no captured block of the slice-13 path")
    g1 = g1_check(GC, dev, card)
    check(held.get("while_condition", 0) > 0, "G1 ran in no captured block of the slice-12 path")
    for name in ("bsr_matvec", "bsr_rmatvec", "bsr_matvec_windowed", "bsr_rmatvec_windowed",
                 "bsr_matvec_multiwin", "bsr_rmatvec_multiwin", "lane_gather",
                 "lane_gather_mul_t_batched", "lane_gather_sum", "lane_segsum",
                 "lane_gather_mul_segsum", "tiled_combine"):
        check(held.get(name, 0) > 0, f"{name} is in no captured block of the slice-9 path")
    for name in ("lane_gather", "lane_gather_mul_t_batched", "lane_gather_sum", "lane_segsum",
                 "lane_gather_mul_segsum", "bsr_matvec_windowed"):
        check(slice4_launches[name] > 0, f"{name} never ran on the slice-4 path")

    # --- 15. slice 10: LOBPCG, svds and normest on the device loop, with E1 --------
    from linops_tpu_torch.utils import loop as loop_mod

    e1_times, _ = phase15a(E1, dev, card)
    e2_times = phase15f(lt, loop_mod, E2, dev, card, ops)
    r15b, _, e1_launches = phase15b(lt, loop_mod, E1, dev, card)
    phase15c(lt, loop_mod, dev, {"blocks": blocks, "cols": cols}, slice6["spectra"])
    phase15d(dev, card)
    lob32 = phase15e(lt, loop_mod, E1, dev, card)
    # --- 13i. spectral routines, estimators and checks on distributed operators (after 15:
    # it prints 15b's and 15e's unsharded numbers beside its own) -------------------------
    l13i, s13i = phase13i(lt, loop_mod, E1, K, LG, dev, card, ops,
                          {"blocks": blocks, "cols": cols, "A": A, "b": b},
                          {"15b": r15b, "15e": lob32})
    for name in ("bsr_matvec", "bsr_rmatvec", "lane_gather", "lane_gather_mul_t_batched",
                 "lane_gather_sum", "lane_segsum", "lane_gather_mul_segsum", "small_eigh",
                 "small_eigh_cluster"):
        check(l13i.get(name, 0) > 0, f"{name} never ran on the 13i path (distributed spectra)")
    # --- 14i. opIterativeInverse's block apply as one panel solve (after 13i: its 1x1 mesh)
    r14i, l14i = phase14i(lt, loop_mod, (K, LG, E1, E2, GC), dev, card, ops)
    for name in ("small_lstsq", "while_condition", "lane_gather", "lane_gather_mul_t_batched",
                 "lane_gather_sum", "lane_segsum", "small_eigh"):
        check(l14i.get(name, 0) > 0, f"{name} never ran on the 14i path (panel solves)")
    # --- 16. a BSR operator's block transposes in one launch (K2p, K4p, K6p) --------------
    r16, l16 = phase16(lt, loop_mod, (K, LG, E1, E2, GC), dev, card,
                       {"blocks": blocks, "cols": cols, "A": A}, slice6["spectra"])
    for name in PANEL16_KERNELS:
        check(l16.get(name, 0) > 0, f"{name} never ran on the 16 path (block transposes)")
    # --- 17. a BSR operator's forward blocks in one launch (K1p, K3p, K5p) ------------------
    r17, l17 = phase17(lt, loop_mod, (K, LG, E1, E2, GC), dev, card,
                       {"blocks": blocks, "cols": cols, "A": A})
    for name in PANEL17_KERNELS:
        check(l17.get(name, 0) > 0, f"{name} never ran on the 17 path (forward blocks)")

    # the slice-1 CG by kernel: a profiled run of I_LONG iterations (its trace
    # comes after phase 5's profiler readings, as phase 10's do), its blocks
    # captured by a second run (the first runs the plain loop)
    lt.cg(A, b, M=H, tol=0.0, maxiter=I_LONG)
    lt.cg(A, b, M=H, tol=0.0, maxiter=I_LONG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lt.cg(A, b, M=H, tol=0.0, maxiter=I_LONG)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / I_LONG
    dev_ms, top = device_profile(lambda: lt.cg(A, b, M=H, tol=0.0, maxiter=I_LONG), top=4)
    check(dev_ms is not None, "the slice-1 CG's trace holds no device time")
    dev_us = dev_ms * 1e3 / I_LONG
    print(f"[5 times] cg iteration, 8x128 f32, profiled over {I_LONG} iterations: device "
          f"{dev_us:.1f} us per iteration of {wall_us:.1f} us wall (busy {dev_us / wall_us:.2f}); "
          "top: " + ", ".join(f"{k} {v * 1e3 / I_LONG:.1f} us ({v / dev_ms * 100:.0f}%)"
                             for k, v in top) + f"; {card}", flush=True)

    main_case = times[("8x128", torch.float32)]

    def entry(name, source, replaces, launches_, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}

    kernels = [
        entry("bsr_matvec", K1_SOURCE, K1_REPLACES, launches["bsr_matvec"],
              err_abs["bsr_matvec"], main_case["K1"], main_case["K1 plain"],
              main_case["K1 bound"], main_case["K1 library"]),
        entry("bsr_rmatvec", K1_SOURCE, K2_REPLACES, launches["bsr_rmatvec"],
              err_abs["bsr_rmatvec"], main_case["K2"], main_case["K2 plain"],
              main_case["K2 bound"], main_case["K2 library"]),
    ]
    for name, (replaces, shape) in WIN_KERNELS.items():
        t = win_times[shape]
        row = entry(name, WIN_SOURCE, replaces, win_launches[name], win_err[name], t[name],
                    t[name + " plain"], t[name + " bound"], t[name + " library"])
        if t[name + " library note"]:  # why library_ms is null
            row["library_note"] = t[name + " library note"]
        kernels.append(row)
    for name, replaces in LANE_KERNELS.items():
        t = lane_times[name]
        # K8: its 3-stage operator's apply; K13: the CG on step 1's program
        # without bounds (no pack builds one); K14: no path calls it
        n_launch = {"lane_gather_mul": k8_launches, "tiled_combine": k13_launches,
                    "lane_gather_mul_t": 0}.get(name, ops["launches"][name])
        row = {**entry(name, LG_SOURCE, replaces, n_launch, lane_err[name], t["ms"],
                       t["plain_ms"], (t["bound_ms"], t["bound_by"]), t["library_ms"]),
               "timing": "cuda_graph", "event_ms": t["event_ms"], "profiler_ms": t["profiler_ms"]}
        if name in LAUNCH_SOURCES:
            row["launches_from"] = LAUNCH_SOURCES[name]
        if name == "lane_segsum":  # torch.segment_reduce cannot be captured in a graph
            row["library_timing"] = "marginal CUDA events: torch.segment_reduce on the same segments"
        kernels.append(row)
    t = e1_times[6]  # f32, m = 6: the Rayleigh-Ritz step of LOBPCG at k = 2
    kernels.append({**entry("small_eigh", E1_SOURCE, E1_REPLACES, e1_launches,
                            t["max_abs_err"], t["ms"], t["plain_ms"], t["bound"], t["plain_ms"]),
                    "timing": "cuda_graph", "event_ms": t["event_ms"],
                    "shape": "f32, m = 6 (the Rayleigh-Ritz step of LOBPCG at k = 2)",
                    "launches_from": "phase 15b: LOBPCG on the 2048² stencil",
                    "replaces_note": "no pallas_call site: the jnp.linalg.eigh XLA lowers in "
                                     "the reference's LOBPCG loop; plain version and library "
                                     "call are both torch.linalg.eigh"})
    for name, kern in (("small_eigh_cluster", "cluster"), ("small_eigh_blocked", "blocked")):
        t = e1_times[96]  # f32, m = 96: the Rayleigh-Ritz step of LOBPCG at k = 32
        row = {**entry(name, E1_SOURCE, E1_REPLACES, lob32["launches"][name],
                       t[kern]["max_abs_err"], t[kern]["ms"], t["plain_ms"], t["bound"],
                       t["plain_ms"]),
               "timing": "cuda_graph",
               "shape": "f32, m = 96 (the Rayleigh-Ritz step of LOBPCG at k = 32)",
               "launches_from": "phase 15e: LOBPCG at k = 32 on the 2048² stencil",
               "replaces_note": "no pallas_call site: the jnp.linalg.eigh XLA lowers in the "
                                "reference's LOBPCG loop, for m > 24; plain version and library "
                                "call are both torch.linalg.eigh"}
        if kern == "cluster":
            row["event_ms"] = t["event_ms"]
        else:  # the dispatch takes it only where the cluster kernel does not fit
            row["launches_note"] = ("the dispatch takes the one-CTA kernel only where the "
                                    "cluster kernel's buffers pass the shared memory (c128 "
                                    "above m = 128): no main path launches it")
        kernels.append(row)
    kernels.append({**entry("while_condition", G1_SOURCE, G1_REPLACES, held["while_condition"],
                            g1["max_abs_err"], g1["ms"], g1["plain_ms"], g1["bound"], None),
                    "timing": "cuda_graph", "max_abs_err_of": "iterations a while node ran",
                    "launches_from": "phases 14f and 14h: the nested solves' captured blocks "
                                     "(two per while node: before it and at the end of its "
                                     "body)",
                    "replaces_note": "no pallas_call site: the device half of the reference's "
                                     "nested lax.while_loop (an inner solve inside the outer "
                                     "solver's compiled loop); no PyTorch call sets a graph "
                                     "condition"})
    t = e2_times[30]  # f32, (31, 30): the last Hessenberg of 10a's GMRES(30)
    kernels.append({**entry("small_lstsq", E2_SOURCE, E2_REPLACES,
                            slice4_launches["small_lstsq"] + rec14["14h"]["e2_launches"],
                            t["max_abs_err"], t["ms"], t["plain_ms"], t["bound"], t["library_ms"]),
                    "timing": "cuda_graph", "event_ms": t["event_ms"], "sweeps": t["sweeps"],
                    "shape": "f32, (31, 30): the last Hessenberg of 10a's GMRES(30)",
                    "launches_from": "phase 10a (GMRES(30) on auto_8m + 8I) and phase 14h "
                                     "(the nested GMRES's per-iteration, first and capturing "
                                     "solves)",
                    "library_call": "torch.linalg.pinv(H, rtol=eps·31) @ βe₁ (eager: it reads "
                                    "cuSOLVER's info back)",
                    "replaces_note": "no pallas_call site: the jnp.linalg.lstsq XLA lowers in the "
                                     "reference's GMRES restart; plain version: torch.linalg.svd "
                                     "at jnp.linalg.lstsq's cutoff"})
    for name, (source, replaces, case) in PANEL16_KERNELS.items():
        r_ = r16[(name, case)]
        t = r_["times"][8]
        row = {**entry(name, source, replaces, l16[name], r_["max_abs_err"], t["events"],
                       t["plain"], t["bound"], t["library"]),
               "timing": "marginal CUDA events", "graph_ms": t["graph"],
               "column_loop_ms": t["loop_events"], "column_loop_graph_ms": t["loop_graph"],
               "ms_by_k": {str(k): r_["times"][k]["events"] for k in PANEL16_TIMED},
               "bound_ms_by_k": {str(k): r_["times"][k]["bound"][0] for k in PANEL16_TIMED},
               "staging": {key[1]: v_["path"] for key, v_ in r16.items()
                           if isinstance(key, tuple) and key[0] == name},
               "shape": f"{case}, a block of k = 8 columns",
               "launches_from": "phase 16: 16a's estimate_trace of the window operators, 16b's "
                                "svds, 16c's Nyström sketches, 16d's gradient",
               "library_call": "torch.sparse.mm on a CSR of Aᵀ built once, U dense (n, 8), "
                               "row-major and column-major: the faster",
               "library_max_rel_err": t["library_err"],
               "replaces_note": "the reference applies a block in this mode as jax.vmap of the "
                                "vector kernel: one batched pallas_call of the site named"}
        if name != "bsr_rmatmat":
            row["plain_note"] = f"the plain panel {PLAIN16_COLS} columns at a time (memory)"
        if t["library_note"]:
            row["library_note"] = t["library_note"]
        kernels.append(row)
    for name, (source, replaces, case) in PANEL17_KERNELS.items():
        r_ = r17[(name, case)]
        t = r_["times"]
        kernels.append({**entry(name, source, replaces, l17[name], r_["max_abs_err"], t["events"],
                                t["plain"], t["bound"], t["library"]),
                        "timing": "marginal CUDA events", "graph_ms": t["graph"],
                        "column_loop_ms": t["loop_events"], "column_loop_graph_ms": t["loop_graph"],
                        "bsr_matmat_ms": t["matmat"], "design_bound_ms": t["design_bound"][0],
                        "shape": f"{case}, a block of k = 8 columns",
                        "launches_from": "phase 17: 17a's estimate_trace of the window operators, "
                                         "17b's svds and LOBPCG, 17c's vmap, 17e's gradient",
                        "library_call": "torch.sparse.mm on a CSR of A built once, X dense (n, 8), "
                                        "row-major and column-major: the faster",
                        "library_max_rel_err": t["library_err"],
                        "replaces_note": "the reference applies a block in this mode as jax.vmap "
                                         "of the vector kernel: one batched pallas_call of the "
                                         "site named",
                        **({"plain_note": f"the plain panel {PLAIN16_COLS} columns at a time "
                                          "(memory)"} if name != "bsr_matmat" else {}),
                        **({"library_note": t["library_note"]} if t["library_note"] else {})})
    for row in kernels:  # launches inside phase 12's backward passes, on 13h's, 13i's, 14i's, 16's and 17's paths
        row["backward_launches"] = ad_launches[row["name"]] if row["name"] in ad_launches else 0
        row["launches_13h"] = sum(c_.get(row["name"], 0) for c_ in dt_launches.values())
        row["launches_13i"] = l13i.get(row["name"], 0)
        row["launches_14i"] = l14i.get(row["name"], 0)
        row["launches_16"] = l16.get(row["name"], 0)
        row["launches_17"] = l17.get(row["name"], 0)
    tally = collections.Counter(n for n, _ in TRACES_TAKEN)
    lossy = collections.Counter((h, t) for h, t, _ in SPINS_LOST if h or t)
    missed = [(h, t) for h, t, hit in SPINS_LOST if hit is False]
    print(f"[spins] {len(SPINS_LOST)} traces, each with {SPINS} spin kernels at either end of its "
          f"window (twice as many at each retry): {sum(lossy.values())} lost some (by spins lost at the start and at the end: "
          f"{dict(lossy)}); of the {sum(hit is not None for *_, hit in SPINS_LOST)} that counted "
          f"a run's kernels, {len(missed)} missed what was wanted, {missed.count((0, 0))} of them "
          f"with every spin traced", flush=True)
    print(f"[traces] {len(TRACES_TAKEN)} runs counted by torch.profiler traces, by traces taken "
          f"(up to {TRACE_TRIES}): {dict(sorted(tally.items()))}; "
          f"{sum(not hit for _, hit in TRACES_TAKEN)} of them with no trace that counted what "
          f"was wanted (a graph with while nodes never does: a body runs as often as its inner "
          f"loop, not as its graph holds it)", flush=True)
    print(json.dumps({"kernels": kernels}))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
