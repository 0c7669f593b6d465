"""Rerun the 4-rank gloo world of ``tests/test_torch_parallel.py`` many times,
with a subset of its cases, to look for a crash that shows only now and then.

    python tests/torch_world_stress.py only|without|all REPS [--debug-malloc LIB]

``only`` runs the case ``sharded_bsr_panels`` alone, ``without`` every case
but it, ``all`` every case. ``--debug-malloc`` preloads glibc's debugging
allocator (``libc_malloc_debug.so.0``, glibc 2.34 and later) in every rank,
with ``MALLOC_CHECK_=3`` and ``MALLOC_PERTURB_=165``: a heap corruption it
sees aborts that rank. Each rank enables ``faulthandler``
(``parallel/launch.py``), so an abort leaves its Python stack in the rank's
log. One JSON line per world: its mode, wall seconds and status (``ok``, the
errors of failing cases, or the launcher's failure with each rank's tail).
Not collected by pytest; it imports no jax.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CASE = "sharded_bsr_panels"


def world(mode):
    """Run in each rank: the chosen cases; rank 0 returns {case: error}."""
    import torch.distributed as dist

    from linops_tpu_torch.parallel import make_mesh

    spec = importlib.util.spec_from_file_location("_world_cases",
                                                  os.path.join(HERE, "test_torch_parallel.py"))
    tp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tp)
    names = {"only": [CASE], "without": [n for n in tp.CASES if n != CASE],
             "all": list(tp.CASES)}[mode]
    mesh = make_mesh(tp.WORLD, device="cpu")
    errors = {}
    for name in names:
        try:
            tp.CASES[name](mesh)
        except Exception as err:  # reported, not raised: the other cases still run
            errors[name] = repr(err)[:300]
    return errors if dist.get_rank() == 0 else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("only", "without", "all"))
    ap.add_argument("reps", type=int)
    ap.add_argument("--debug-malloc", metavar="LIB")
    a = ap.parse_args()
    sys.path.insert(0, os.path.dirname(HERE))
    from linops_tpu_torch.parallel import launch

    if a.debug_malloc:
        os.environ.update(LD_PRELOAD=a.debug_malloc, MALLOC_CHECK_="3", MALLOC_PERTURB_="165")
    for rep in range(a.reps):
        t0 = time.time()
        try:
            errors = launch.run(os.path.abspath(__file__) + ":world", 4, args=(a.mode,),
                                backend="gloo", timeout=900)[0]
            status = "ok" if not errors else f"case errors {errors}"
        except Exception as err:
            status = f"failed: {str(err)[-3000:]}"
        print(json.dumps(dict(mode=a.mode, rep=rep, s=round(time.time() - t0, 1),
                              status=status)), flush=True)


if __name__ == "__main__":
    main()
