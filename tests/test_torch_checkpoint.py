"""The port's checkpoints (mirrors test_checkpoint.py): a round trip through
``save_operator`` / ``load_operator_state`` is bit-exact for L-BFGS, L-SR1,
diagonal quasi-Newton, BSR, DIA and bf16 state on the CPU; the container is
the reference's: the same state, carried across with ``convert.*`` and saved
by each package, gives the same ``__meta__`` (class, structure fingerprint,
leaf count, dtypes) and the same leaves in the same order, and each package
loads the other's checkpoint; the save hooks materialize lazy a-vectors on
every node of a graph; a structure mismatch is refused."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linops_tpu as lo
import linops_tpu_torch as lt
from linops_tpu.utils import checkpoint as ref_ckpt
from linops_tpu_torch import convert

CPU = dict(device="cpu")


def leaves_equal(a, b):
    la, _ = lt.utils.checkpoint._walk(a, [], [])
    lb, _ = lt.utils.checkpoint._walk(b, [], [])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        assert torch.equal(x, y) or (torch.isnan(x).any() and torch.equal(
            x.nan_to_num(1.0), y.nan_to_num(1.0)))


def pushed(op, rng, n, count=5):
    for _ in range(count):
        s = rng.standard_normal(n)
        op.push(torch.from_numpy(s), torch.from_numpy(2.0 * s + 0.3 * rng.standard_normal(n)))
    return op


def build(kind, rng):
    n = 48
    if kind == "lbfgs":
        return pushed(lt.LBFGSOperator(n, mem=4, **CPU), rng, n), lambda: lt.LBFGSOperator(
            n, mem=4, **CPU)
    if kind == "inverse_lbfgs":
        return pushed(lt.InverseLBFGSOperator(n, mem=3, **CPU), rng, n), \
            lambda: lt.InverseLBFGSOperator(n, mem=3, **CPU)
    if kind == "lsr1":
        return pushed(lt.LSR1Operator(n, mem=4, scaling=True, **CPU), rng, n), \
            lambda: lt.LSR1Operator(n, mem=4, scaling=True, **CPU)
    if kind == "diagonal_psb":
        op = lt.DiagonalPSB(np.ones(n), **CPU)
        return pushed(op, rng, n, 2), lambda: lt.DiagonalPSB(np.ones(n), **CPU)
    if kind == "bsr":
        def two_blocks(shift):  # block row r holds block columns r + shift, r + shift + 2 (mod 6)
            A = np.zeros((n, n))
            for r in range(n // 8):
                for c in ((r + shift) % 6, (r + shift + 2) % 6):
                    A[8 * r:8 * r + 8, 8 * c:8 * c + 8] = rng.standard_normal((8, 8))
            return lt.opSparse(A, format="bsr", block_shape=(8, 8), **CPU)

        # the fresh operator has other block columns: a load must rebuild the index
        return two_blocks(0), lambda: two_blocks(1)
    if kind == "dia":
        A = np.diag(rng.standard_normal(n)) + np.diag(rng.standard_normal(n - 3), 3)
        return lt.dia_from_dense(A, **CPU), lambda: lt.dia_from_dense(
            np.eye(n) + np.eye(n, k=3), **CPU)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["lbfgs", "inverse_lbfgs", "lsr1", "diagonal_psb", "bsr",
                                  "dia"])
def test_roundtrip_is_bit_exact(tmp_path, rng, kind):
    op, fresh = build(kind, rng)
    path = str(tmp_path / f"{kind}.npz")
    lt.save_operator(path, op)
    v = torch.from_numpy(rng.standard_normal(op.ncol))
    target = fresh()
    target.T @ v  # builds the plain transpose's plan, which the load must drop
    assert lt.load_operator_state(path, target) is target
    leaves_equal(target, op)
    assert torch.equal(target @ v, op @ v) and torch.equal(target.T @ v, op.T @ v)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
    assert set(meta) == {"class", "structure", "n_leaves", "dtypes"}
    assert meta["class"] == type(op).__name__


def _ref_fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _np(x):
    return None if x is None else np.asarray(x)


def build_both(kind, rng):
    """(reference operator, the port's operator with the same state carried
    across by ``convert.*``, fresh reference, fresh port) on the CPU in f64
    (bf16 for ``bf16_diagonal``)."""
    n = 48
    pairs = [(rng.standard_normal(n), None) for _ in range(5)]
    pairs = [(s, 2.0 * s + 0.3 * rng.standard_normal(n)) for s, _ in pairs]
    if kind in ("lbfgs", "inverse_lbfgs", "lsr1"):
        ref_cls, cls, from_ref, kw = {
            "lbfgs": (lo.LBFGSOperator, lt.LBFGSOperator, convert.lbfgs_state_from_reference,
                      dict(mem=4)),
            "inverse_lbfgs": (lo.InverseLBFGSOperator, lt.InverseLBFGSOperator,
                              convert.lbfgs_state_from_reference, dict(mem=3)),
            "lsr1": (lo.LSR1Operator, lt.LSR1Operator, convert.lsr1_state_from_reference,
                     dict(mem=4, scaling=True)),
        }[kind]
        ref = ref_cls(n, **kw)
        for s, y in pairs:
            ref.push(s, y)
        op = cls(n, **kw, **CPU)
        op.state = from_ref(_ref_fields(ref.state), **CPU)
        return ref, op, lambda: ref_cls(n, **kw), lambda: cls(n, **kw, **CPU)
    if kind == "diagonal_psb":
        ref = lo.DiagonalPSB(np.ones(n))
        for s, y in pairs[:2]:
            ref.push(s, y)
        op = convert.diagonal_qn_from_reference("DiagonalPSB", np.asarray(ref.d), **CPU)
        return ref, op, lambda: lo.DiagonalPSB(np.ones(n)), lambda: lt.DiagonalPSB(
            np.ones(n), **CPU)
    if kind == "bf16_diagonal":
        ref = lo.opDiagonal(jnp.asarray(rng.standard_normal(n), jnp.bfloat16))
        op = convert.diagonal_from_reference(np.asarray(ref.d), **CPU)
        return (ref, op, lambda: lo.opDiagonal(jnp.zeros(n, jnp.bfloat16)),
                lambda: lt.opDiagonal(torch.zeros(n, dtype=torch.bfloat16)))
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    pattern = (A != 0).astype(np.float64)
    if kind == "bsr":
        def port_bsr(r):
            d = r.data
            return convert.bsr_operator_from_reference(
                np.asarray(d.blocks), np.asarray(d.block_cols), d.shape, win_q=_np(r.win_q),
                cols_local=_np(r.cols_local), win_q_t=_np(r.win_q_t),
                win_valid_t=_np(r.win_valid_t), **CPU)

        ref = lo.opSparse(A, format="bsr", block_shape=(8, 16))
        fresh = lo.opSparse(pattern, format="bsr", block_shape=(8, 16))
        return ref, port_bsr(ref), lambda: fresh, lambda: port_bsr(fresh)
    if kind == "dia":
        A = np.diag(rng.standard_normal(n)) + np.diag(rng.standard_normal(n - 3), 3)
        ref = lo.dia_from_dense(A)
        op = convert.dia_from_reference(np.asarray(ref.diags), ref.offsets, **CPU)
        return (ref, op, lambda: lo.dia_from_dense(np.eye(n) + np.eye(n, k=3)),
                lambda: convert.dia_from_reference(np.ones_like(ref.diags), ref.offsets, **CPU))
    if kind == "csr":
        return (lo.opSparse(A, format="csr"), lt.opSparse(A, format="csr", **CPU),
                lambda: lo.opSparse(pattern, format="csr"),
                lambda: lt.opSparse(pattern, format="csr", **CPU))
    raise ValueError(kind)


def read_checkpoint(path):
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        return meta, [np.array(z[f"leaf_{i}"]) for i in range(meta["n_leaves"])]


def stored(t):
    """A port leaf as the container stores it (bf16 as its uint16 bits)."""
    return lt.utils.checkpoint._to_storable(t)


@pytest.mark.parametrize("kind", ["lbfgs", "inverse_lbfgs", "lsr1", "diagonal_psb", "bsr",
                                  "dia", "csr", "bf16_diagonal"])
def test_container_matches_the_reference(tmp_path, rng, kind):
    """The same state saved by each package: equal ``__meta__`` (class,
    structure, n_leaves, dtypes) and equal leaves in the same order (bit for
    bit, but for the a-vectors and bounds a save hook recomputes from a
    carried state, which agree to 1e-10); then each package loads the
    other's file, bit for bit, and applies as the saver does (rtol 1e-10)."""
    ref, op, fresh_ref, fresh_port = build_both(kind, rng)
    p_ref, p_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_ckpt.save_operator(p_ref, ref)
    lt.save_operator(p_port, op)
    meta_ref, leaves_ref = read_checkpoint(p_ref)
    meta_port, leaves_port = read_checkpoint(p_port)
    assert meta_port == meta_ref
    for a, b in zip(leaves_port, leaves_ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max(initial=0))
        else:
            np.testing.assert_array_equal(a, b)

    port2 = lt.load_operator_state(p_ref, fresh_port())
    got, _ = lt.utils.checkpoint._walk(port2, [], [])
    for t, b in zip(got, leaves_ref):
        np.testing.assert_array_equal(stored(t), b)
    ref2 = ref_ckpt.load_operator_state(p_port, fresh_ref())
    v = rng.standard_normal(op.ncol)
    want_ref = np.asarray(ref * v, dtype=np.float64)
    want_port = (op @ torch.from_numpy(v)).double().numpy()
    np.testing.assert_allclose((port2 @ torch.from_numpy(v)).double().numpy(), want_ref,
                               rtol=1e-10, atol=1e-12 * np.abs(want_ref).max())
    np.testing.assert_allclose(np.asarray(ref2 * v, dtype=np.float64), want_port,
                               rtol=1e-10, atol=1e-12 * np.abs(want_port).max())


def test_save_hooks_run_on_every_node(tmp_path, rng):
    n = 32
    B = pushed(lt.LSR1Operator(n, mem=3, **CPU), rng, n)
    L = pushed(lt.LBFGSOperator(n, mem=3, **CPU), rng, n)
    assert not B._a_fresh and not L._ab_fresh
    graph = B @ L + 2.0 * lt.opEye(n, dtype=torch.float64)
    path = str(tmp_path / "graph.npz")
    lt.save_operator(path, graph)
    assert B._a_fresh and L._ab_fresh  # materialized before the save
    B2 = lt.LSR1Operator(n, mem=3, **CPU)
    L2 = lt.LBFGSOperator(n, mem=3, **CPU)
    target = B2 @ L2 + 2.0 * lt.opEye(n, dtype=torch.float64)
    lt.load_operator_state(path, target)
    for f in B.state._fields:
        assert torch.equal(getattr(B2.state, f), getattr(B.state, f)), f
    assert torch.equal(B2.diag(), B.diag()) and torch.equal(L2.diag(), L.diag())


def test_structure_mismatch_rejected(tmp_path, rng):
    op, _ = build("lbfgs", rng)
    path = str(tmp_path / "a.npz")
    lt.save_operator(path, op)
    with pytest.raises(ValueError, match="structure"):
        lt.load_operator_state(path, lt.LBFGSOperator(48, mem=5, **CPU))
    with pytest.raises(ValueError, match="checkpoint holds"):
        lt.load_operator_state(path, lt.LSR1Operator(48, mem=4, **CPU))


def test_bfloat16_and_op_state(tmp_path, rng):
    d = torch.from_numpy(rng.standard_normal(20)).to(torch.bfloat16)
    op = lt.opDiagonal(d)
    path = str(tmp_path / "bf16.npz")
    lt.save_operator(path, op)
    with np.load(path) as z:
        assert z["leaf_0"].dtype == np.uint16
        assert json.loads(str(z["__meta__"]))["dtypes"] == ["bfloat16"]
    target = lt.opDiagonal(torch.zeros(20, dtype=torch.bfloat16))
    lt.load_operator_state(path, target)
    assert torch.equal(target.d, d)
    assert set(lt.op_state(op)) == {"d"}
    L, _ = build("lsr1", rng)
    assert isinstance(lt.op_state(L)["state"], lt.LSR1State)
