"""Run a function on every rank of a new local process group.

``run(target, n_ranks)`` starts ``n_ranks`` processes of this interpreter,
joins them into one process group (``initialize_distributed``: NCCL by
default, gloo with ``backend="gloo"``), calls ``target`` in each and returns
the per-rank results (pickled back through files in a temporary directory).
A rank that fails, or a world that outlives ``timeout``, raises here, with
the tail of each rank's output; every process started is ended.

``target`` is ``"package.module:function"`` or ``"path/to/file.py:function"``;
the function takes ``*args`` and runs after the process group is up. A rank
process is ``python -m linops_tpu_torch.parallel.launch <dir> <rank>``.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time

__all__ = ["run", "load_target"]


def load_target(target: str):
    """The function named by ``module:function`` or ``file.py:function``."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        mod_name = "_linops_launch_" + os.path.splitext(os.path.basename(where))[0]
        spec = importlib.util.spec_from_file_location(mod_name, where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def run(target: str, n_ranks: int, *, args=(), backend: str = "nccl",
        timeout: float = 600.0) -> list:
    """Results of ``target(*args)`` on ranks 0..n_ranks-1 of a new world.
    Each rank computes on one intra-op thread: the ranks share the host's
    cores."""
    from .init import _free_port

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="linops_launch_") as tmp:
        with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
            pickle.dump(dict(target=target, n_ranks=n_ranks, port=_free_port(),
                             backend=backend, args=args), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([pkg_root] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        try:
            for r in range(n_ranks):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "linops_tpu_torch.parallel.launch", tmp, str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {target} on {n_ranks} ranks outlived "
                                       f"{timeout} s\n" + _tails(tmp, n_ranks))
                if any(p.returncode not in (None, 0) for p in procs):
                    break  # a failed rank leaves the others waiting on it
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if p.returncode != 0 or not os.path.exists(path):
                raise RuntimeError(f"launch: rank {r} of {target} failed (exit "
                                   f"{p.returncode})\n" + _tails(tmp, n_ranks))
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def _tails(tmp: str, n_ranks: int, nbytes: int = 4000) -> str:
    out = []
    for r in range(n_ranks):
        path = os.path.join(tmp, f"rank{r}.log")
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                out.append(f"--- rank {r} ---\n" + f.read()[-nbytes:])
    return "\n".join(out)


def _rank_main(tmp: str, rank: int) -> None:
    import faulthandler

    import torch.distributed as dist

    from .init import initialize_distributed

    faulthandler.enable()  # a rank killed by a signal leaves its Python stack in its log
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    initialize_distributed(f"localhost:{spec['port']}", spec["n_ranks"], rank,
                           backend=spec["backend"])
    try:
        result = load_target(spec["target"])(*spec["args"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl.part"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(tmp, f"rank{rank}.pkl.part"), os.path.join(tmp, f"rank{rank}.pkl"))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
