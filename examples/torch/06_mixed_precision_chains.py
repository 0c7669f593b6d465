"""Precision tiers: f32-exact by default, bf16 storage for speed.

The PyTorch port of ``examples/06_mixed_precision_chains.py``: the same
block-sparse operator stored in f32 and in bf16, one apply of each, matvec
chains and power iterations on both tiers, on the CUDA device unless
``main`` is given the CPU. The port keeps f32 contractions f32-exact on
the card (``core/precision.py`` refuses TF32 for them), and a bf16-stored
operator halves the bytes each apply streams (K1 reads bf16 blocks and
accumulates in f32).

The reference's example also shows its VMEM residency hint
(``utils/residency.py``): chains over operators that fit the TPU's on-chip
memory ran from it. That is a TPU artefact with nothing to port (an H100
keeps no operator resident across kernels; its L2 serves repeated reads by
itself), so this example drops it, and quotes no TPU number.

Run: python examples/torch/06_mixed_precision_chains.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import linops_tpu_torch as lt  # noqa: E402
from linops_tpu_torch.core.base import default_device  # noqa: E402

n = 8192
nbr = n // 128


def main(device=None):
    dev = default_device(device, "example 06")
    rng = np.random.default_rng(0)
    blocks = torch.as_tensor(rng.standard_normal((nbr, 4, 128, 128)).astype(np.float32),
                             device=dev)
    cols = torch.as_tensor(rng.integers(0, nbr, size=(nbr, 4)).astype(np.int32), device=dev)

    # f32 tier: exact applies
    op32 = lt.BSROperator(lt.BSR(blocks, cols, (n, n)))
    # bf16 tier: half the stored bytes, f32 accumulation
    op16 = lt.BSROperator(lt.BSR(blocks.to(torch.bfloat16), cols, (n, n)))

    v = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)

    y32 = (op32 @ v).double()
    y16 = (op16 @ v.to(torch.bfloat16)).double()
    rel = float(torch.linalg.vector_norm(y16 - y32) / torch.linalg.vector_norm(y32))
    print(f"bf16 tier deviation from f32-exact: {rel:.2e} (~bf16 resolution)")

    # Whole chains on the device loop either way
    w32 = lt.matvec_chain(op32, v, 100)
    w16 = lt.matvec_chain(op16, v.to(torch.bfloat16), 100)
    finite = (bool(torch.isfinite(w32).all()), bool(torch.isfinite(w16).all()))
    print("chain outputs finite:", *finite)

    # Power iteration on both tiers (the bf16 estimate carries compounded
    # bf16 rounding: a few percent; use the f32 tier when the value matters)
    lam32, _ = lt.power_iteration(op32, v, iters=60)
    lam16, _ = lt.power_iteration(op16, v.to(torch.bfloat16), iters=60)
    print(f"dominant |eigenvalue|: f32 {float(abs(lam32)):.4f}  "
          f"bf16 {float(abs(lam16)):.4f}")
    return {"y32": y32, "rel": rel, "w32": w32, "finite": finite, "lam32": float(abs(lam32)),
            "lam16": float(abs(lam16))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
