"""Collective audits of distributed applies (counterpart of
``linops_tpu/parallel/introspect.py``).

The reference compiles a function and counts the collective instructions
in its optimized HLO. PyTorch runs eagerly, so ``collective_counts`` runs
the function once under ``comm.counting()`` and returns what it issued.
That is a count of executed collectives: a loop of k iterations counts k
times what its body issues, where the reference's count of program text
counts the body once. The contracts read the same for one apply (a halo
apply: exactly 2 ``collective-permute`` and 0 ``all-gather``; a halo block
apply of any width the same, as the reference's vmapped apply).
``hlo_collective_counts`` is the reference's text count, kept so the name
exists; it reads HLO text, which this package never produces.
"""

from __future__ import annotations

import re

from .comm import COLLECTIVE_OPS, counting

__all__ = ["collective_counts", "hlo_collective_counts", "COLLECTIVE_OPS"]


def hlo_collective_counts(hlo_text: str) -> dict:
    """Count collective instructions in optimized-HLO text. Async pairs
    (``-start``/``-done``) count once."""
    counts = {}
    for name in COLLECTIVE_OPS:
        # instruction forms: `name(`, `name-start(`, `name.N(` — count the
        # op applications, not the `-done` halves of async pairs
        pat = rf"\b{re.escape(name)}(?:-start)?(?:\.\d+)?\("
        counts[name] = len(re.findall(pat, hlo_text))
    return counts


def collective_counts(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return the collectives it issued
    on this rank, by name."""
    with counting() as counts:
        fn(*args, **kwargs)
    return counts
