"""Device-resident loops: the counterparts of ``lax.while_loop`` and
``lax.fori_loop`` for the solvers of ``utils/krylov.py`` and the spectral
loops of ``utils/eig.py`` (LOBPCG) and ``utils/norm.py`` (``normest``).

The reference runs every solve as one compiled loop on the device
(``linops_tpu/utils/krylov.py:3-11``). PyTorch runs eagerly, so a plain
host loop enqueues each iteration's kernels from Python and reads its
stopping test back every iteration. Here an iteration is *masked* and the
host reads once per block of ``BLOCK`` iterations:

    act = cond(state) & (k < maxiter)          # on the device
    state = where(act, body(state, k), state)  # a frozen iteration changes nothing
    k = k + act

Over an active iteration ``where`` selects the body's value exactly, so x,
the residual and the count are bit-identical to the plain per-iteration
loop, and the count is the reference's.

On a CUDA device a block is one replay of a ``torch.cuda.CUDAGraph``
holding ``BLOCK`` masked iterations. The graph reads its loop state from
static buffers and writes it back with ``copy_``, so replays chain with
nothing on the host between them but the one read of (still active, k).
Every device value that differs between solves of one signature (the state,
``tol2``-like scalars, ``maxiter``) lives in those buffers and is never baked
into the graph. A signature is captured when it repeats, as the reference's
jit cache compiles a structure once and reuses it: the first solve of a
signature runs the plain per-iteration loop (on the capture stream, so its
lazy plans, kernel libraries and cuBLAS's workspace there exist before
anything is captured; eager masked blocks cost more host time per
iteration than the reads they save), and the next solve of that signature
captures. An operator's state fields (``_fields_state``: an L-BFGS, L-SR1
or diagonal QN state, a shift σ) are keyed by layout alone, so a push or a
new σ keeps the signature, as the reference's traced state keeps its jit
cache: the captured block owns static copies of those fields (its capture
ran with the operator's fields pointed at them), and before a solve's first
replay the loop copies in every state tensor that is not the one it copied
last (another object, or a bumped ``_version``; an address alone could be a
freed state's), so a quasi-Newton loop that pushes between solves replays
from its third solve on, and a solve with no update since copies nothing.
The operators keep value semantics: a push still makes new tensors, so a
state the caller holds (``saved = B.state``) is never written. Any other
change (a new tensor outside state, an in-place edit there) is a new
signature. The cache is a small LRU keyed by the solve's signature
(``core/base.py::capture_signature`` of every operator, the state's shapes
and dtypes, the solver's own static arguments and ``BLOCK``); it holds both
kinds of entry, a signature seen once and a captured block, and an eviction
drops the graph, its static state and its private memory pool.
``apply_cache_sizes()`` (``core/apply.py``) counts them.

On the CPU the same masked blocks run eagerly, and each signature they run
is recorded in the cache as a card's first solve records it, so the
counters mean the same on both devices. Under ``torch.func.vmap``,
when a gradient is wanted, or when an operator is not ``capture_safe`` (a
host factorization, a timer, a nested solve, a sharded operator, a
``FunctionOperator`` not declared safe), the plain per-iteration loop runs
(``host_while``; ``stats["path"]`` says which path ran). ``CAPTURE = False``
is a test hook: the card then runs eager blocks, as the CPU does.

``BLOCK`` is 4. A solve of I iterations runs ⌈I/4⌉ blocks, the last one
partly frozen, so it spends at most 3 frozen iterations of device time and
reads the host ⌈I/4⌉ + 1 times (the initial test, then once per block;
the CPU's blocks and a capturing solve), where the plain loop reads I + 1
times (a signature's first solve on the card). A replay of a cached block
does not wait for the initial test: it runs, and its read says whether
anything moved, so a cached solve reads max(⌈I/4⌉, 1) times (a solve that
starts converged spends one frozen block). The choice weighs the card's
numbers (NVIDIA H100 80GB HBM3): a read and a replay leave the card idle
some tens of µs per block, against 273 µs of device time per slice-1 CG
iteration; a longer block halves that idle share and doubles the worst-case
waste (``PERF.md`` §5-§6 give the measured values).

Launch counts stay the wrappers' own (``kernels/*.py::launch_counts``): a
wrapper counts each launch it issues, one recorded into a graph being
captured included, and a replay runs the graph's kernels without the
wrappers, so it adds nothing. Each kernel module registers its table here
(``register_launches``), and a captured block lists the launches its
capture recorded (``.launches``); a profiler trace of a replay shows them
(``chip_smoke.py`` phase 14 counts them there).
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref

import torch

BLOCK = 4  # masked iterations per block (one host read per block)
CAPTURE = True  # test hook: False runs the card's blocks eagerly, as on the CPU
_CACHE_SIZE = 8  # signatures kept (seen once, or captured), least recently used first

# what the last loop to finish did: its path ("graph", "blocks",
# "per_iteration", "vmap"), host reads, blocks run, captures, replays,
# capture milliseconds and the bytes of state copied into a captured block
# (a nested loop keeps its own)
stats: dict = {}
_active: list = []  # the stats of the loops running, innermost last

# signature -> its captured block, or None for a signature seen once
_CACHE: "collections.OrderedDict[tuple, _Graph | None]" = collections.OrderedDict()
_STREAMS: dict = {}
_LAUNCH_TABLES: list = []  # the kernel modules' launch counts (register_launches)
_last_graph = None
_captures = 0  # captures since the process started


def clear_cache() -> None:
    """Drop every captured block (and its memory pool) and every signature
    seen."""
    global _last_graph
    _CACHE.clear()
    _last_graph = None


def cache_sizes() -> dict:
    """{"signatures": cache entries (signatures seen, captured or not),
    "graphs": captured blocks kept, "captures": captures since the process
    started}: none grows over repeated solves of one signature, state
    updates between them included."""
    return {"signatures": len(_CACHE), "graphs": sum(g is not None for g in _CACHE.values()),
            "captures": _captures}


def last_graph():
    """The captured block the last loop replayed (None when it replayed
    none): ``.replay()`` runs it once more on its static buffers, and
    ``.launches`` maps each kernel its capture recorded to its launches."""
    return _last_graph


def register_launches(table: dict) -> None:
    """Register a kernel module's launch counts (kernel name -> launches,
    bumped by its wrappers), so a capture can list what it recorded."""
    _LAUNCH_TABLES.append(table)


def _bump(what: str, n=1) -> None:
    if _active:
        _active[-1][what] += n


def _read(t):
    """One host read (a device-to-host copy and its wait), counted."""
    _bump("reads")
    if hasattr(t, "full_tensor"):  # a DTensor (a sharded operator's solve)
        t = t.full_tensor()
    return t.tolist()


class _Loop:
    """The stats of one loop while it runs; published to ``stats`` when it
    ends."""

    def __init__(self, path: str):
        self.d = dict(path=path, reads=0, blocks=0, captures=0, replays=0, capture_ms=0.0,
                      state_bytes=0, iterations=None)

    def __enter__(self):
        _active.append(self.d)
        return self.d

    def __exit__(self, *exc):
        _active.remove(self.d)
        stats.clear()
        stats.update(self.d)
        return False


# ----------------------------------------------------------------------------
# Which path a loop takes
# ----------------------------------------------------------------------------


def _batched(t) -> bool:
    """Whether ``t`` carries a ``torch.func.vmap`` batch at some level."""
    F = torch._C._functorch
    while F.is_functorch_wrapped_tensor(t):
        if F.is_batchedtensor(t):
            return True
        t = F.get_unwrapped(t)
    return False


def _any_member(t) -> bool:
    """Whether any member of a vmapped boolean is true: one host read of the
    whole unwrapped batch."""
    F = torch._C._functorch
    while F.is_functorch_wrapped_tensor(t):
        t = F.get_unwrapped(t)
    return bool(_read(t.any()))


def _traced(tensors) -> bool:
    """A ``torch.func`` transform or autograd needs the loop's graph."""
    F = torch._C._functorch
    grad = torch.is_grad_enabled()
    return any(F.is_functorch_wrapped_tensor(t) or (grad and t.requires_grad)
               for t in tensors)


def _walk_ops(ops) -> tuple:
    """(the operators' part of a cache key, every tensor they hold, their
    state fields as (operator, field) pairs): one walk of each graph."""
    from ..core.base import capture_signature

    keys, tensors, states, seen = [], [], [], set()
    for op in ops:
        if op is None:
            keys.append(None)
            continue
        k, ts, st = capture_signature(op)
        keys.append(k)
        tensors += ts
        for owner, f in st:
            if (id(owner), f) not in seen:
                seen.add((id(owner), f))
                states.append((owner, f))
    return tuple(keys), tensors, states


def _path(tensors, ops) -> tuple:
    """(the path a loop takes, and for the graph path the operators' key
    part and their state fields). The blocks path walks the operators only
    under autograd: ``_remember`` takes its key after the eager run."""
    if _traced(tensors) or not all(op is None or op.capture_safe for op in ops):
        return "per_iteration", None, ()
    graph = bool(tensors) and tensors[0].is_cuda and CAPTURE
    opkey, states = None, ()
    if graph or torch.is_grad_enabled():
        opkey, leaves, states = _walk_ops(ops)
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return "per_iteration", None, ()
    return ("graph" if graph else "blocks"), opkey, states


# ----------------------------------------------------------------------------
# Captured blocks
# ----------------------------------------------------------------------------


def _stream(device):
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


@contextlib.contextmanager
def _on_capture_stream(device):
    """Run an eager loop on the capture stream (after the caller's stream's
    work; the caller's stream then waits for it). Every use of that stream
    outside a capture comes through here, so a block it frees was last used
    by work it has waited for."""
    stream = _stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def _static_like(value, leaves):
    """``value`` (a state field) rebuilt from the tensors ``leaves``."""
    if isinstance(value, torch.Tensor):
        return next(leaves)
    if value is None:
        return None
    items = [_static_like(v, leaves) for v in value]
    return type(value)(*items) if hasattr(value, "_fields") else type(value)(items)


class _State:
    """A captured block's own copy of one state field: static tensors of
    the field's layout on the block's device (a host scalar there would be
    read on the host at capture, its value baked into the graph), and which
    of the operator's tensors each last copied (a weak reference and its
    ``_version``)."""

    def __init__(self, owner, field: str, device):
        from ..core.base import state_leaves

        self.owner, self.field = owner, field
        value = getattr(owner, field)
        leaves = state_leaves(value)
        self.static = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
                       for t in leaves]
        for s, t in zip(self.static, leaves):
            s.copy_(t)
        self.value = _static_like(value, iter(self.static))
        self.last = [(weakref.ref(t), t._version) for t in leaves]
        self.nbytes = sum(t.untyped_storage().nbytes() for t in self.static)

    def refresh(self) -> int:
        """Copy in every tensor of the field that is not the one copied last;
        returns the bytes copied."""
        from ..core.base import state_leaves

        n = 0
        for i, t in enumerate(state_leaves(getattr(self.owner, self.field))):
            ref, version = self.last[i]
            if ref() is not t or version != t._version:
                self.static[i].copy_(t)
                self.last[i] = (weakref.ref(t), t._version)
                n += t.numel() * t.element_size()
        return n


@contextlib.contextmanager
def _static_state(states):
    """Point every state field at its block's static copy (past the
    operators' own ``__setattr__`` hooks, which would mark lazy state stale)
    and give the operators back their own tensors after."""
    own = [getattr(st.owner, st.field) for st in states]
    for st in states:
        object.__setattr__(st.owner, st.field, st.value)
    try:
        yield
    finally:
        moved = [st for st in states if getattr(st.owner, st.field) is not st.value]
        for st, value in zip(states, own):
            object.__setattr__(st.owner, st.field, value)
        if moved:
            raise RuntimeError(
                "a captured block replaced the state " + ", ".join(
                    f"{type(st.owner).__name__}.{st.field}" for st in moved)
                + " while capturing: state updates belong outside a solve")


class _Graph:
    """One captured function over static input buffers: ``run(args)``
    copies ``args`` in (those given), refreshes the static state and
    replays. Holds the operators it was captured with, so their ids in its
    key stay theirs, and its own copies of their state fields."""

    def __init__(self, fn, args, ops, what: str, states=()):
        global _captures
        self.ops = tuple(ops)
        self.inputs = [a.clone() for a in args]
        device = args[0].device
        self.states = [_State(owner, f, device) for owner, f in states]
        self.state_bytes = sum(st.nbytes for st in self.states)  # held by this block
        before = [dict(t) for t in _LAUNCH_TABLES]
        t0 = time.perf_counter()
        # keep_graph: the captured graph stays readable (raw_cuda_graph), so its
        # kernel nodes can be listed (chip_smoke.py counts them per block)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize(device)
        err = None
        debug = torch.cuda.get_sync_debug_mode()
        with _static_state(self.states), torch.cuda.stream(_stream(device)):
            # a host read inside the capture would bake a value into the graph:
            # any synchronizing call raises there
            torch.cuda.set_sync_debug_mode("error")
            self.graph.capture_begin()
            try:
                self.outputs = fn(*self.inputs)
            except Exception as e:
                err = e
            finally:
                torch.cuda.set_sync_debug_mode(debug)
            try:
                self.graph.capture_end()  # ends a capture the error invalidated too
            except Exception as e:
                err = err or e
                try:  # capture_end raised before handing the allocator back
                    torch._C._cuda_endAllocateToPool(device.index, self.graph.pool())
                except RuntimeError:
                    pass
        if err is None:
            self.graph.instantiate()
        else:
            del self.graph
            names = ", ".join(_describe(op) for op in ops if op is not None)
            raise RuntimeError(
                f"{what}: capturing the iteration in a CUDA graph failed on {names}: {err}. "
                "An operator whose apply reads the host is not capture-safe: a class says so "
                "with capture_safe = False, a FunctionOperator with capture_safe=False (its "
                "default)") from err
        torch.cuda.synchronize(device)
        _captures += 1
        _bump("capture_ms", (time.perf_counter() - t0) * 1e3)
        _bump("captures")
        self.launches = {k: t[k] - b.get(k, 0) for t, b in zip(_LAUNCH_TABLES, before)
                         for k in t if t[k] != b.get(k, 0)}

    def run(self, args=()):
        """Replay; with ``args`` (a solve's first replay) copy them in and
        refresh the static state first."""
        global _last_graph
        for s, a in zip(self.inputs, args):
            if a is not None:
                s.copy_(a)
        if args:
            _bump("state_bytes", sum(st.refresh() for st in self.states))
        self.replay()
        _last_graph = self
        return self.outputs

    def replay(self):
        self.graph.replay()
        _bump("replays")


def _describe(op) -> str:
    from ..core.base import LinearOperator

    leaves = []

    def walk(o):
        held = [v for f in type(o)._fields_tensors for v in _operators(getattr(o, f, None))]
        if not held:
            leaves.append(type(o).__name__)
        for c in held:
            walk(c)

    if isinstance(op, LinearOperator):
        walk(op)
        return f"{type(op).__name__} (leaves: {', '.join(dict.fromkeys(leaves))})"
    return type(op).__name__


def _operators(value):
    from ..core.base import LinearOperator

    if isinstance(value, LinearOperator):
        return [value]
    if isinstance(value, (tuple, list)):
        return [o for v in value for o in _operators(v)]
    return []


def _signature(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def _key(kind, key, opkey, tensors) -> tuple:
    return (kind, key, BLOCK, _signature(tensors), opkey)


def _lookup(key) -> tuple:
    """(whether the signature was seen, its captured block or None)."""
    if key not in _CACHE:
        return False, None
    _CACHE.move_to_end(key)
    return True, _CACHE[key]


def _store(key, g) -> None:
    _CACHE[key] = g
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)


def _remember(kind, key, ops, tensors) -> None:
    """Note a signature whose eager run built its plans (its key is taken
    now, with them): on the card its next run captures."""
    ckey = _key(kind, key, _walk_ops(ops)[0], tensors)
    if ckey in _CACHE:
        _CACHE.move_to_end(ckey)
    else:
        _store(ckey, None)


# ----------------------------------------------------------------------------
# while
# ----------------------------------------------------------------------------


def _select(act, new, old):
    out = []
    for a, b in zip(new, old):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise TypeError(f"loop body changed a state entry from {b.dtype}{tuple(b.shape)} "
                            f"to {a.dtype}{tuple(a.shape)}")
        out.append(torch.where(act, a, b))
    return tuple(out)


def _while_block(cond, body, state, consts, k, act, lim, n: int):
    for _ in range(n):
        state = _select(act, body(state, consts, k), state)
        k = k + act.to(k.dtype)
        act = cond(state, consts) & (k < lim)
    return state, k, act


def _plain_while(cond, body, state, consts, maxiter, go, path):
    """The plain loop: one host read per iteration. Under vmap (``path``
    "vmap") every member runs until all have stopped, each frozen once its
    own test fails, and the count is a per-member tensor."""
    dev = state[0].device
    j = torch.zeros((), dtype=torch.int64, device=dev)
    with _Loop(path) as st:
        if path == "vmap":
            k = torch.zeros_like(go, dtype=torch.int64)
            act = go & (k < maxiter)
            while _any_member(act):
                state = _select(act, body(state, consts, j), state)
                k = k + act.long()
                act = cond(state, consts) & (k < maxiter)
                j = j + 1
                st["blocks"] += 1
            return state, k
        k = 0
        while k < maxiter and _read(go):
            state = body(state, consts, j)
            k += 1
            j = j + 1
            go = cond(state, consts)
            st["blocks"] += 1
        st["iterations"] = k
        return state, k


def host_while(cond, body, state: tuple, maxiter: int, *, consts: tuple = ()):
    """``device_while``'s semantics in the plain loop: the host reads the
    test every iteration (for a body that reads the host itself, such as
    GMRES's restart with its SVD). Returns (state, iterations)."""
    state, consts = tuple(state), tuple(consts)
    go = cond(state, consts)
    return _plain_while(cond, body, state, consts, maxiter, go,
                        "vmap" if _batched(go) else "per_iteration")


def device_while(cond, body, state: tuple, maxiter: int, *, consts: tuple = (), ops=(),
                 key=()):
    """``state = body(state, consts, k)`` while ``cond(state, consts)``
    holds, at most ``maxiter`` times; ``k`` is the iteration's index as a
    0-dim int64 tensor on the state's device. ``consts`` are tensors the
    body reads and never changes; ``ops`` the operators it applies (their
    ``capture_signature`` keys the captured block, ``capture_safe`` picks
    the path); ``key`` the caller's static arguments the body depends on. The
    body reads no other tensor made per call: a captured block would replay
    over it.

    Returns (state, iterations): an ``int``, or under ``torch.func.vmap`` a
    per-member tensor (every member runs until all have stopped, each frozen
    once its own test fails, as ``jax.vmap`` of a ``lax.while_loop``)."""
    state, consts = tuple(state), tuple(consts)
    go = cond(state, consts)
    if _batched(go):
        return _plain_while(cond, body, state, consts, maxiter, go, "vmap")
    path, opkey, states = _path(state + consts, ops)
    if path == "per_iteration":
        return _plain_while(cond, body, state, consts, maxiter, go, path)
    dev = state[0].device
    ckey = _key("while", key, opkey, state + consts) if path == "graph" else None
    seen, g = _lookup(ckey) if path == "graph" else (False, None)
    if path == "graph" and not seen:  # a signature's first solve: the plain loop
        with _on_capture_stream(dev):
            state, count = _plain_while(cond, body, state, consts, maxiter, go, "per_iteration")
        _remember("while", key, ops, state + consts)
        return state, count
    k = torch.zeros((), dtype=torch.int64, device=dev)
    lim = torch.full((), maxiter, dtype=torch.int64, device=dev)
    act = go & (k < lim)
    with _Loop(path) as st:
        if g is None and not _read(act):  # a cached block runs first and reads after
            st["iterations"] = 0
            if path == "blocks":
                _remember("while", key, ops, state + consts)
            return state, 0
        if path == "blocks":  # the CPU (or CAPTURE off): eager blocks
            while True:
                state, k, act = _while_block(cond, body, state, consts, k, act, lim, BLOCK)
                st["blocks"] += 1
                more, count = _read(torch.stack((act.to(torch.int64), k)))
                if not more:
                    st["iterations"] = count
                    _remember("while", key, ops, state + consts)
                    return state, count
        if g is None:
            ns, nc, n = len(state), len(consts), BLOCK

            def block(*bufs):
                s_in, c_in, (k_in, a_in, l_in) = bufs[:ns], bufs[ns:ns + nc], bufs[ns + nc:]
                s_out, k_out, a_out = _while_block(cond, body, s_in, c_in, k_in, a_in, l_in, n)
                for s, s2 in zip(s_in, s_out):
                    s.copy_(s2)
                k_in.copy_(k_out)
                a_in.copy_(a_out)
                return torch.stack((a_out.to(torch.int64), k_out))

            g = _Graph(block, state + consts + (k, act, lim), ops, f"device_while{key!r}",
                       states)
            _store(ckey, g)
            status = g.run()
        else:
            status = g.run(state + consts + (k, act, lim))
        while True:
            st["blocks"] += 1
            more, count = _read(status)
            if not more:
                break
            status = g.run()
        st["iterations"] = count
        return tuple(s.clone() for s in g.inputs[:len(state)]), count


def _fori_block(body, state, consts, n: int):
    for _ in range(n):
        state = tuple(body(state, consts))
    return state


def device_fori(body, state: tuple, iters: int, *, consts: tuple = (), ops=(), key=()):
    """``state = body(state, consts)`` ``iters`` times, with no host read.
    On a CUDA device, once this signature has run before, blocks of
    ``BLOCK`` iterations replay a captured graph and the last ``iters mod
    BLOCK`` run eagerly; its first run is eager throughout. Returns the
    state."""
    state, consts = tuple(state), tuple(consts)
    path, opkey, states = _path(state + consts, ops) if iters > 0 else ("blocks", None, ())
    n = BLOCK
    ckey = _key("fori", key, opkey, state + consts) if path == "graph" else None
    seen, g = _lookup(ckey) if path == "graph" else (False, None)
    label = path if path != "graph" else "graph" if seen and iters >= n else "blocks"
    with _Loop(label) as st:
        if path != "graph":
            st["blocks"] += iters > 0
            out = _fori_block(body, state, consts, max(iters, 0))
            if path == "blocks" and iters > 0:
                _remember("fori", key, ops, state + consts)
            return out
        dev = state[0].device
        if not seen or iters < n:  # eagerly, on the capture stream
            st["blocks"] += 1
            with _on_capture_stream(dev):
                first = _fori_block(body, state, consts, 1)
                out = _fori_block(body, first, consts, iters - 1)
            if _signature(first) == _signature(state):  # type-stable: it can be captured
                _remember("fori", key, ops, state + consts)
            return out
        ns = len(state)
        if g is None:

            def block(*bufs):
                s_out = _fori_block(body, bufs[:ns], bufs[ns:], n)
                for s, s2 in zip(bufs[:ns], s_out):
                    s.copy_(s2)
                return ()

            g = _Graph(block, state + consts, ops, f"device_fori{key!r}", states)
            _store(ckey, g)
            g.run()
        else:
            g.run(state + consts)
        done = n
        st["blocks"] += 1
        while iters - done >= n:
            g.run()
            done += n
            st["blocks"] += 1
        state = tuple(s.clone() for s in g.inputs[:ns])
        return _fori_block(body, state, consts, iters - done)


def device_call(fn, args: tuple, *, ops=(), key=()):
    """``fn(*args)`` (a tuple of tensors out) as a captured graph on a CUDA
    device: replayed when this signature was captured before, captured when
    it ran before, else run eagerly on the capture stream. The outputs of a
    replay are the graph's own buffers, valid until its next replay: callers
    copy out what they keep. On the CPU, under a transform, or for operators
    that are not capture-safe, a plain call."""
    args = tuple(args)
    path, opkey, states = _path(args, ops)
    if path != "graph":
        out = tuple(fn(*args))
        if path == "blocks":
            _remember("call", key, ops, args)
        return out
    ckey = _key("call", key, opkey, args)
    seen, g = _lookup(ckey)
    if g is not None:
        return g.run(args)
    if not seen:
        with _on_capture_stream(args[0].device):
            out = tuple(fn(*args))
        _remember("call", key, ops, args)
        return out
    g = _Graph(lambda *a: tuple(fn(*a)), args, ops, f"device_call{key!r}", states)
    _store(ckey, g)
    return g.run()
