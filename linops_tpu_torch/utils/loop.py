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
drops the graph, its static state and its private memory pool. Distributed
solves have an LRU of their own (see below).
``apply_cache_sizes()`` (``core/apply.py``) counts them.

On the CPU the same masked blocks run eagerly, and each signature they run
is recorded in the cache as a card's first solve records it, so the
counters mean the same on both devices. Under ``torch.func.vmap``,
when a gradient is wanted, or when an operator is not ``capture_safe`` (a
host factorization, a timer, a nested GMRES solve, a ``FunctionOperator``
not declared safe), the plain per-iteration loop runs (``host_while``;
``stats["path"]`` says which path ran). ``CAPTURE = False`` is a test hook:
the card then runs eager blocks, as the CPU does.

Nested loops. A loop started inside a masked iteration's body (an
``opIterativeInverse`` preconditioner's inner solve) ANDs that iteration's
mask into its test, so in a frozen outer iteration it runs none and its
count is 0: the inner iterations summed over a solve are those of the
active outer iterations, as in the per-iteration loop, and the outer
``where`` discards a frozen iteration's output either way. On the CPU the
inner loop runs its own eager blocks. On the card, a loop that starts while
a block is being captured reads nothing on the host: it becomes one CUDA
conditional WHILE node of the outer graph (``_while_node``,
``kernels/graph_cond.py``) whose body is one masked block of the inner loop,
and whose condition a kernel sets from the inner test (which ANDs the outer
mask) before the node and at the end of each body run. Its count is a 0-dim
tensor on the card. The body is captured on a stream of its own (a stream
that is capturing cannot begin a second capture), its allocations routed to
a private pool the outer block holds. ``device_fori`` and ``device_call``
started inside a capture run inline.

Distributed solves. A sharded, halo or 2-D halo operator's solve runs the
same way over DTensor state: the count and the test stay plain tensors
(a test is replicated, so each rank holds it whole), a captured block's
static buffers and state copies are DTensors of the state's placements (a
``copy_`` into them moves nothing between ranks), and the key holds each
DTensor's mesh and placements. On the card a capture records DTensor's
dispatch once; a replay runs its kernels and collectives with no host work.
On the CPU gloo collectives cannot be captured: eager masked blocks, as for
any CPU solve. Every rank must decide alike whether to capture: if one rank
captured while another ran eagerly, their collectives would pair wrongly and
hang. So the cache decides by the sequence of distributed signatures alone,
which every rank shares, since every rank takes part in every distributed
solve: such signatures live in an LRU of their own (``_DIST_CACHE``), which
no rank-local solve (a check on rank 0 alone) can touch, and a distributed
signature's entry holds its operators from the first solve on (a captured
block always does), so the ids and addresses in its key cannot be reused by
new objects on one rank and not on another. A hit, a miss and an eviction
then happen on every rank at the same solve. On the card this has run at
one rank only, where NCCL lowers a collective to a copy: no capture of a
collective between ranks has run yet.

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

from ..core.base import _is_dtensor

BLOCK = 4  # masked iterations per block (one host read per block)
CAPTURE = True  # test hook: False runs the card's blocks eagerly, as on the CPU
_CACHE_SIZE = 8  # signatures kept (seen once, or captured), least recently used first

# what the last loop to finish did: its path ("graph", "blocks",
# "per_iteration", "vmap"), host reads, blocks run, captures, replays,
# capture milliseconds, the bytes of state copied into a captured block and
# the while nodes its capture recorded (a nested loop keeps its own)
stats: dict = {}
_active: list = []  # the stats of the loops running, innermost last
# the act of each masked iteration whose body is running, innermost last (None
# for a plain loop's iteration, which runs only when active): a loop started
# inside one ANDs it into its own test
_OUTER: list = []
_CAPTURING: list = []  # the captured blocks being captured, innermost last
_BODY_STREAMS: dict = {}  # (device, depth) -> the stream a while node's body is captured on

# signature -> its captured block, or a _Seen for a signature seen once
_CACHE: "collections.OrderedDict[tuple, _Graph | _Seen]" = collections.OrderedDict()
# the same for distributed solves (DTensor state or operators), apart, so a
# rank-local solve cannot evict them on one rank only
_DIST_CACHE: "collections.OrderedDict[tuple, _Graph | _Seen]" = collections.OrderedDict()
_STREAMS: dict = {}
_LAUNCH_TABLES: list = []  # the kernel modules' launch counts (register_launches)
_last_graph = None
_captures = 0  # captures since the process started


def clear_cache() -> None:
    """Drop every captured block (and its memory pool) and every signature
    seen."""
    global _last_graph
    _CACHE.clear()
    _DIST_CACHE.clear()
    _last_graph = None


def cache_sizes() -> dict:
    """{"signatures": cache entries (signatures seen, captured or not),
    "graphs": captured blocks kept, "captures": captures since the process
    started}: none grows over repeated solves of one signature, state
    updates between them included."""
    entries = list(_CACHE.values()) + list(_DIST_CACHE.values())
    return {"signatures": len(entries),
            "graphs": sum(not isinstance(g, _Seen) for g in entries),
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
                      state_bytes=0, while_nodes=0, iterations=None)

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


def _replicating(tensors):
    """A distributed solve mixes the loop's own plain tensors (the count,
    the limit) with DTensor state: inside, a plain tensor counts as
    replicated (the same on every rank, as the count and the limit are)."""
    if any(_is_dtensor(t) for t in tensors):
        from ..parallel.comm import plain_as_replicated

        return plain_as_replicated()
    return contextlib.nullcontext()


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


def _distributed(tensors) -> bool:
    return any(_is_dtensor(t) for t in tensors)


def _path(tensors, ops) -> tuple:
    """(the path a loop takes, and for the graph path the operators' key
    part, their state fields and whether the solve is distributed). The
    blocks path walks the operators only under autograd: ``_remember`` takes
    its key after the eager run."""
    if _traced(tensors) or not all(op is None or op.capture_safe for op in ops):
        return "per_iteration", None, (), False
    graph = bool(tensors) and tensors[0].is_cuda and CAPTURE
    opkey, states, dist = None, (), False
    if graph or torch.is_grad_enabled():
        opkey, leaves, states = _walk_ops(ops)
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return "per_iteration", None, (), False
        dist = _distributed(list(leaves) + list(tensors))
    return ("graph" if graph else "blocks"), opkey, states, dist


# ----------------------------------------------------------------------------
# Captured blocks
# ----------------------------------------------------------------------------


def _stream(device):
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _body_stream(device, depth: int):
    """The stream a while node's body at nesting ``depth`` is captured on
    (a stream that is capturing cannot begin another capture). Made with a
    few eager cuBLAS calls on it, so its workspace there exists before any
    capture needs it."""
    s = _BODY_STREAMS.get((device, depth))
    if s is None:
        s = _BODY_STREAMS[(device, depth)] = torch.cuda.Stream(device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            a = torch.ones((2, 2), device=device)
            torch.vdot(a[0], a[1])
            torch.mv(a, a[0])
            a @ a
        torch.cuda.current_stream(device).wait_stream(s)
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


def _static_copy(t, device):
    """An uninitialized tensor of ``t``'s layout on ``device``; for a DTensor
    a DTensor of its placements over this rank's piece, so a ``copy_`` into
    it moves nothing between ranks."""
    from ..core.base import _local

    local = _local(t)
    s = torch.empty_strided(local.shape, local.stride(), dtype=local.dtype, device=device)
    if local is t:
        return s
    from ..parallel.comm import from_local

    return from_local(s, t.device_mesh, t.placements, t.shape)


class _State:
    """A captured block's own copy of one state field: static tensors of
    the field's layout on the block's device (a host scalar there would be
    read on the host at capture, its value baked into the graph), and which
    of the operator's tensors each last copied (a weak reference and its
    ``_version``)."""

    def __init__(self, owner, field: str, device):
        from ..core.base import _local, state_leaves

        self.owner, self.field = owner, field
        value = getattr(owner, field)
        leaves = state_leaves(value)
        self.static = [_static_copy(t, device) for t in leaves]
        for s, t in zip(self.static, leaves):
            s.copy_(t)
        self.value = _static_like(value, iter(self.static))
        self.last = [(weakref.ref(t), _local(t)._version) for t in leaves]
        self.nbytes = sum(_local(t).untyped_storage().nbytes() for t in self.static)

    def refresh(self) -> int:
        """Copy in every tensor of the field that is not the one copied last;
        returns the bytes copied."""
        from ..core.base import _local, state_leaves

        n = 0
        for i, t in enumerate(state_leaves(getattr(self.owner, self.field))):
            ref, version = self.last[i]
            local = _local(t)
            if ref() is not t or version != local._version:
                self.static[i].copy_(t)
                self.last[i] = (weakref.ref(t), local._version)
                n += local.numel() * local.element_size()
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
        self.body_pools = {}  # nesting depth -> [the while node bodies' pool, captures in it]
        self.bodies = []  # the while nodes' body graphs (cudaGraph_t addresses), in capture order
        self.ops = tuple(ops)
        self.inputs = [a.clone() for a in args]
        device = self.device = args[0].device
        _body_stream(device, 0)  # made (and its cuBLAS workspace) before the capture
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
            _CAPTURING.append(self)
            try:
                self.outputs = fn(*self.inputs)
            except Exception as e:
                err = e
            finally:
                _CAPTURING.pop()
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

    def __del__(self):
        for pool, uses in getattr(self, "body_pools", {}).values():
            for _ in range(uses):  # each body's capture took one use of its pool
                torch._C._cuda_releasePool(self.device.index, pool)

    def body_memory(self, depth: int):
        """The private pool a while node's body at nesting ``depth``
        allocates from while it is captured (one per depth and captured
        block, kept until the block is dropped: the body's replays reuse its
        addresses)."""
        entry = self.body_pools.setdefault(depth, [torch.cuda.graph_pool_handle(), 0])
        entry[1] += 1
        return entry[0]

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
    from ..core.base import _distribution

    return tuple((tuple(t.shape), t.dtype, t.device) + (_distribution(t) if _is_dtensor(t) else ())
                 for t in tensors)


def _key(kind, key, opkey, tensors) -> tuple:
    return (kind, key, BLOCK, _signature(tensors), opkey)


class _Seen:
    """A signature seen once: its next solve captures. For a distributed
    solve it holds the operators, as a captured block does, so the ids and
    addresses in its key stay theirs while it is kept (see the module's
    note on ranks)."""

    __slots__ = ("ops",)

    def __init__(self, ops=()):
        self.ops = tuple(ops)


def _cache(dist: bool):
    return _DIST_CACHE if dist else _CACHE


def _lookup(key, dist: bool = False) -> tuple:
    """(whether the signature was seen, its captured block or None)."""
    cache = _cache(dist)
    if key not in cache:
        return False, None
    cache.move_to_end(key)
    g = cache[key]
    return True, None if isinstance(g, _Seen) else g


def _store(key, g, dist: bool = False) -> None:
    cache = _cache(dist)
    cache[key] = g
    cache.move_to_end(key)
    while len(cache) > _CACHE_SIZE:
        cache.popitem(last=False)


def _remember(kind, key, ops, tensors) -> None:
    """Note a signature whose eager run built its plans (its key is taken
    now, with them): on the card its next run captures."""
    opkey, leaves, _ = _walk_ops(ops)
    ckey = _key(kind, key, opkey, tensors)
    dist = _distributed(list(leaves) + list(tensors))
    if ckey in _cache(dist):
        _cache(dist).move_to_end(ckey)
    else:
        _store(ckey, _Seen(ops if dist else ()), dist)


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


def _call_body(body, state, consts, k, act):
    """``body(state, consts, k)`` with ``act`` (the iteration's mask, None
    for a plain loop's iteration) as the test a loop started inside ANDs."""
    _OUTER.append(act)
    try:
        return body(state, consts, k)
    finally:
        _OUTER.pop()


def _whole(t):
    """A loop scalar as a plain tensor: a DTensor test (replicated: every
    rank holds it whole) as its local value, so the count and the test stay
    plain tensors beside DTensor state."""
    return t.full_tensor() if _is_dtensor(t) else t


def _while_block(cond, body, state, consts, k, act, lim, n: int):
    for _ in range(n):
        state = _select(act, _call_body(body, state, consts, k, act), state)
        k = k + act.to(k.dtype)
        act = _whole(cond(state, consts)) & (k < lim)
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
                state = _select(act, _call_body(body, state, consts, j, None), state)
                k = k + act.long()
                act = cond(state, consts) & (k < maxiter)
                j = j + 1
                st["blocks"] += 1
            return state, k
        k = 0
        while k < maxiter and _read(go):
            state = _call_body(body, state, consts, j, None)
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
    once its own test fails, as ``jax.vmap`` of a ``lax.while_loop``), or
    inside a capture (a loop nested in a captured block's iteration) a 0-dim
    int64 tensor on the device, the loop then being one CUDA while node.

    Started inside a masked iteration (a nested solve in an outer loop's
    body), the loop ANDs that iteration's mask into its test: in a frozen
    outer iteration it runs no iteration."""
    state, consts = tuple(state), tuple(consts)
    outer = _OUTER[-1] if _OUTER else None
    with _replicating(state + consts + (() if outer is None else (outer,))):
        go = cond(state, consts)
        if _batched(go):
            return _plain_while(cond, body, state, consts, maxiter, go, "vmap")
        if outer is not None:
            go = go & outer
        if state[0].is_cuda and torch.cuda.is_current_stream_capturing():
            return _while_node(cond, body, state, consts, maxiter, go, ops, key)
        return _device_while(cond, body, state, consts, maxiter, go, ops, key)


def _while_node(cond, body, state, consts, maxiter, go, ops, key):
    """``device_while`` inside a capture: a CUDA conditional WHILE node
    (``kernels/graph_cond.py``) whose body is one masked block of ``BLOCK``
    iterations. Its condition is set from the loop's test by a kernel before
    the node and at the end of each body run, so the node repeats the block
    until the test fails or ``maxiter`` is reached, and nothing is read on
    the host. The state, the count and the test live in buffers made before
    the node (captured, so each replay starts them afresh). Returns (state,
    iterations as a 0-dim int64 tensor)."""
    from ..kernels import graph_cond

    if not _CAPTURING:
        raise RuntimeError(f"device_while{key!r}: a CUDA graph capture is in progress that "
                           "utils/loop.py did not start; a while node needs its block's memory")
    owner = _CAPTURING[-1]
    dev = state[0].device
    k = torch.zeros((), dtype=torch.int64, device=dev)
    lim = torch.full((), maxiter, dtype=torch.int64, device=dev)
    act = _whole(go) & (k < lim)
    bufs = tuple(s.clone() for s in state)
    depth = len(graph_cond.open_bodies())
    try:
        with graph_cond.while_node(act, _body_stream(dev, depth),
                                   owner.body_memory(depth)) as body_graph:
            owner.bodies.append(body_graph)
            s_out, k_out, a_out = _while_block(cond, body, bufs, consts, k, act, lim, BLOCK)
            for b, b2 in zip(bufs, s_out):
                b.copy_(b2)
            k.copy_(k_out)
            act.copy_(a_out)
    except Exception as e:
        names = ", ".join(_describe(op) for op in ops if op is not None)
        raise RuntimeError(f"device_while{key!r}: capturing the loop as a CUDA while node "
                           f"failed on {names}: {e}") from e
    _bump("while_nodes")
    return bufs, k


def _device_while(cond, body, state, consts, maxiter, go, ops, key):
    path, opkey, states, dist = _path(state + consts, ops)
    if path == "per_iteration":
        return _plain_while(cond, body, state, consts, maxiter, go, path)
    dev = state[0].device
    ckey = _key("while", key, opkey, state + consts) if path == "graph" else None
    seen, g = _lookup(ckey, dist) if path == "graph" else (False, None)
    if path == "graph" and not seen:  # a signature's first solve: the plain loop
        with _on_capture_stream(dev):
            state, count = _plain_while(cond, body, state, consts, maxiter, go, "per_iteration")
        _remember("while", key, ops, state + consts)
        return state, count
    k = torch.zeros((), dtype=torch.int64, device=dev)
    lim = torch.full((), maxiter, dtype=torch.int64, device=dev)
    act = _whole(go) & (k < lim)
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
            _store(ckey, g, dist)
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
    if iters > 0 and state[0].is_cuda and torch.cuda.is_current_stream_capturing():
        return _fori_block(body, state, consts, iters)  # nested in a block being captured
    path, opkey, states, dist = (_path(state + consts, ops) if iters > 0
                                 else ("blocks", None, (), False))
    n = BLOCK
    ckey = _key("fori", key, opkey, state + consts) if path == "graph" else None
    seen, g = _lookup(ckey, dist) if path == "graph" else (False, None)
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
            _store(ckey, g, dist)
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
    if args and args[0].is_cuda and torch.cuda.is_current_stream_capturing():
        return tuple(fn(*args))  # nested in a block being captured
    path, opkey, states, dist = _path(args, ops)
    if path != "graph":
        out = tuple(fn(*args))
        if path == "blocks":
            _remember("call", key, ops, args)
        return out
    ckey = _key("call", key, opkey, args)
    seen, g = _lookup(ckey, dist)
    if g is not None:
        return g.run(args)
    if not seen:
        with _on_capture_stream(args[0].device):
            out = tuple(fn(*args))
        _remember("call", key, ops, args)
        return out
    g = _Graph(lambda *a: tuple(fn(*a)), args, ops, f"device_call{key!r}", states)
    _store(ckey, g, dist)
    return g.run()
