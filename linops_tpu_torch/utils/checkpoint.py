"""Checkpoint and resume of operator state.

Counterpart of ``linops_tpu/utils/checkpoint.py``, with the same npz
container and the same ``__meta__`` keys (``class``, ``structure``,
``n_leaves``, ``dtypes``). An operator's leaves are the tensors of its
``_fields_tensors``, depth first in field order (child operators and
NamedTuples of tensors recursed into; ``None`` holds no leaf), less its
``_fields_index``: a kernel's index built from the other fields (K2's
column plan, K5's lane rows, K4's slot index, K6's column plan) is rebuilt
after a load, not stored.
Where the port's fields are the reference's, in the reference's order
(the quasi-Newton states, BSR, DIA, the COO/CSR/ELL formats, diagonals),
the leaves and the ``__meta__`` fingerprint (operator class names and leaf
shapes) are the reference's too, so a checkpoint written by either package
loads into the other. bf16 leaves are stored as their uint16 bits, so
every dtype round-trips bit for bit. Before saving, the ``_before_save``
hook of every operator in the graph runs (lazy quasi-Newton a-vectors are
materialized), so a checkpoint is self-contained. A load drops every
``_fields_derived`` plan, to be built again from the loaded data.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from ..core.base import LinearOperator

__all__ = ["save_operator", "load_operator_state", "op_state"]


def _saved_fields(cls):
    return tuple(f for f in cls._fields_tensors if f not in cls._fields_index)


def op_state(op: LinearOperator):
    """The operator's state: its saved tensor fields by name."""
    return {f: getattr(op, f) for f in _saved_fields(type(op))}


def _walk(x, leaves, classes):
    """Leaves (tensors) and the operator class names of the graph, depth
    first, as the reference lists them (no NamedTuple names)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
    elif isinstance(x, LinearOperator):
        classes.append(type(x).__name__)
        for f in _saved_fields(type(x)):
            _walk(getattr(x, f), leaves, classes)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _walk(v, leaves, classes)
    return leaves, classes


def _fingerprint(op: LinearOperator):
    leaves, classes = _walk(op, [], [])
    return leaves, {"classes": classes, "leaf_shapes": [list(t.shape) for t in leaves]}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_storable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().resolve_conj()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_stored(a: np.ndarray, name: str, like: torch.Tensor) -> torch.Tensor:
    if name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
        if _dtype_name(t) != name:
            raise ValueError(f"checkpoint leaf stored as {_dtype_name(t)}, expected {name}")
    return t.to(like.device)


def _run_hooks(x):
    if isinstance(x, LinearOperator):
        hook = getattr(x, "_before_save", None)
        if hook is not None:
            hook()
        for f in type(x)._fields_tensors:
            _run_hooks(getattr(x, f))
    elif isinstance(x, (tuple, list)):
        for v in x:
            _run_hooks(v)


def save_operator(path: str, op: LinearOperator) -> None:
    """Write an operator's leaves and a structure fingerprint to ``path``
    (.npz), atomically."""
    _run_hooks(op)
    leaves, structure = _fingerprint(op)
    arrays = {f"leaf_{i}": _to_storable(t) for i, t in enumerate(leaves)}
    meta = {"class": type(op).__name__, "structure": structure, "n_leaves": len(leaves),
            "dtypes": [_dtype_name(t) for t in leaves]}
    buf = io.BytesIO()
    np.savez(buf, __meta__=json.dumps(meta), **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def _rebuild(x, it):
    """x with every tensor replaced by the next of ``it``; operators are
    updated in place (their fields set, so state setters run), their
    derived plans dropped and their index rebuilt."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, LinearOperator):
        cls = type(x)
        for f in _saved_fields(cls):
            setattr(x, f, _rebuild(getattr(x, f), it))
        for f in cls._fields_derived:
            setattr(x, f, None)
        if cls._fields_index:
            x._build_index()
        return x
    if isinstance(x, (tuple, list)):
        items = [_rebuild(v, it) for v in x]
        if hasattr(x, "_fields"):
            return type(x)(*items)
        return type(x)(items)
    return x


def load_operator_state(path: str, op: LinearOperator) -> LinearOperator:
    """Restore saved leaves into an operator of the same structure (built
    the way the saved one was), each on the device of the leaf it replaces.
    Returns ``op``, updated in place."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["class"] != type(op).__name__:
            raise ValueError(f"checkpoint holds {meta['class']}, target is {type(op).__name__}")
        leaves, structure = _fingerprint(op)
        if meta["n_leaves"] != len(leaves) or meta.get("structure", structure) != structure:
            raise ValueError("checkpoint structure mismatch")
        names = meta["dtypes"]
        new = [_from_stored(z[f"leaf_{i}"], names[i], leaves[i]) for i in range(len(leaves))]
    _rebuild(op, iter(new))
    return op
