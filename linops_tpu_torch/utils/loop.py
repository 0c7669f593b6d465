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
captures.

The signature holds the operators' structure, never their identity or
their tensors' addresses (``core/base.py::capture_signature``: classes and
static fields by value, tensors by layout, the sharing and aliasing
pattern), as the reference's jit cache keys an operator by its treedef and
its leaves' shapes and dtypes. So a fresh operator of a cached structure (a
Newton step's new Jacobian, new values on one sparse pattern, a fresh
quasi-Newton model) replays the cached block. A captured block reads static
copies of every tensor its operators hold, *mirrors* (``_Mirrors``) that the
blocks over one operators' key share (a chain's N and T blocks): its capture
ran with the operators' fields pointed at them, past the operators' own
``__setattr__`` hooks, and before
a solve's first replay the loop copies in every tensor that is not the one
it copied last (another object, or a bumped ``_version``; an address alone
could be a freed tensor's). A repeated solve of one operator therefore
copies nothing, a push or a new σ copies the state alone, an in-place edit
copies the edited tensor, and a fresh operator copies all of its tensors;
so does a solve that alternates between two operators of one structure,
each time (one set of copies per structure). The block keeps no operator
alive: once the caller drops the one it was captured with, the mirrors are
the only copies left.

The mirrors cost memory, so a new set must fit before it is made
(``_mirror_set``): the sets the blocks of both caches keep may take
``MIRROR_SHARE`` of the card's memory together (the least recently used
blocks are turned back into signatures seen once to make room), and a new
set at most ``FREE_SHARE`` of the free memory. A structure whose set does
not fit (an operator of a third of the card) is captured as blocks were
before they had copies: its blocks read the operators' tensors in place
and hold them, keyed by their identity as well (``_bound_key``), and copy
only the state, so a push still replays and a fresh operator of that
structure is a new signature. The operators keep value semantics: nothing writes a
caller's tensor, and a state the caller holds (``saved = B.state``) is
never written. The one exception is a field an apply adds into
(``_fields_written``: an iterative inverse's inner-iteration counter),
which a replay adds into its mirror and the loop copies back after the
solve. Lazy plans are built before the key is taken
(``LinearOperator._build_derived``, called by the walk), so a fresh
operator keys as one that has been applied. The cache is a small LRU keyed
by the solve's signature (the operators' key, the state's shapes and
dtypes, the solver's own static arguments and its block length); it holds
both kinds of entry, a signature seen once and a captured block, and an eviction
drops the graph, its private memory pool and, unless another block shares
them, its mirrors. Distributed solves have an LRU of their own (see below).
``apply_cache_sizes()`` (``core/apply.py``) counts them.

On the CPU the same masked blocks run eagerly, and each signature they run
is recorded in the cache as a card's first solve records it, so the
counters mean the same on both devices.

Under ``torch.func.vmap`` the loop runs as ``jax.vmap`` of a
``lax.while_loop`` compiles one loop (``_vmapped_while``): the state and the
consts are unwrapped from the vmap level to plain tensors with the members
leading, and the loop runs over them as an unbatched loop does, its
``cond`` and ``body`` each one ``torch.func.vmap`` over the members, with a
per-member count and mask (a member freezes once its own test fails) and
one host read per block (is any member active, the largest count). On the
card a signature's first solve runs eager masked blocks
(``stats["path"]`` "vmap_blocks", as on the CPU), its next captures a block
and later ones replay it ("vmap_graph"); the members' count is part of the
signature through the state's shapes. A loop nested in a member's
iteration is a while node of the captured block that repeats while any
member is active. A vmap over an operator's own data (a batch of
operators), nested vmap levels, DTensor state or a wanted gradient keep the
eager masked blocks over the batched tensors ("vmap", ``_plain_while``):
the same counts and bits, never captured. When a gradient is wanted, or when an operator is not
``capture_safe`` (a host factorization, a timer, a ``FunctionOperator`` not
declared safe), the plain per-iteration loop runs (``stats["path"]`` says
which path ran).
``CAPTURE = False`` is a test hook: the card then runs eager blocks, as the
CPU does.

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
a private pool the outer block holds. ``device_fori`` started inside a
capture runs inline.

Distributed solves. A sharded, halo or 2-D halo operator's solve runs the
same way over DTensor state: the count and the test stay plain tensors
(a test is replicated, so each rank holds it whole), a captured block's
static buffers and state copies are DTensors of the state's placements (a
``copy_`` into them moves nothing between ranks), and the key holds each
DTensor's mesh and placements. The state keeps its layout across the loop
(``_carry``): a DTensor stays in the placements it came in with, a pending
partial sum reduced at the loop's start, and a plain entry (a flag) stays
plain, so the key a solve starts with is the one it leaves in the cache.
On the card a capture records DTensor's
dispatch once; a replay runs its kernels and collectives with no host work.
On the CPU gloo collectives cannot be captured: eager masked blocks, as for
any CPU solve. Every rank must decide alike whether to capture: if one rank
captured while another ran eagerly, their collectives would pair wrongly and
hang. So the cache decides by the sequence of distributed signatures alone,
which every rank shares, since every rank takes part in every distributed
solve and a signature holds no id or address that could differ between
ranks: such signatures live in an LRU of their own (``_DIST_CACHE``), which
no rank-local solve (a check on rank 0 alone) can touch. Whether a
distributed set fits is decided by the distributed cache's sets alone,
each DTensor counted at its largest shard's size (the same on every rank),
and by the free memory of the rank with the least (an all-reduce); a
structure keyed by identity holds the tensors in its key from its first
solve on, so no new tensor takes their ids on one rank and not on another.
A hit, a miss and an eviction then happen on every rank at the same solve. On the
card this has run at one rank only, where NCCL lowers a collective to a
copy: no capture of a collective between ranks has run yet.

``BLOCK`` is 4, the default block length; a loop may name its own
(``device_while(block=...)``: GMRES takes one restart a block, since a
frozen restart costs as much as a live one). A solve of I iterations runs
⌈I/4⌉ blocks, the last one partly frozen, so it spends at most 3 frozen
iterations of device time and reads the host ⌈I/4⌉ + 1 times (the initial
test, then once per block; the CPU's blocks and a capturing solve), where
the plain loop reads I + 1 times (a signature's first solve on the card). A
replay of a cached block does not wait for the initial test: it runs, and
its read says whether anything moved, so a cached solve reads max(⌈I/4⌉, 1)
times (a solve that starts converged spends one frozen block). The choice
weighs the card's numbers (NVIDIA H100 80GB HBM3): a read and a replay leave
the card idle some tens of µs per block, against 273 µs of device time per
slice-1 CG iteration; a longer block halves that idle share and doubles the
worst-case waste (``PERF.md`` §5-§6 give the measured values).

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
import math
import time
import weakref

import torch

from ..core.base import _is_dtensor

BLOCK = 4  # masked iterations per block (one host read per block)
CAPTURE = True  # test hook: False runs the card's blocks eagerly, as on the CPU
_CACHE_SIZE = 8  # signatures kept (seen once, or captured), least recently used first
# the share of the card's memory that the mirrors of the blocks both caches
# keep may hold together, and the share of the free memory a new set may take
# (the rest is the capture's pool and the solve's own)
MIRROR_SHARE = 0.25
FREE_SHARE = 0.5

# what the last loop to finish did: its path ("graph", "blocks",
# "per_iteration", "vmap_graph", "vmap_blocks", "vmap"), host reads, blocks run, captures, replays,
# capture milliseconds, the bytes copied into a captured block's mirrors
# before its first replay, the bytes its mirrors hold and the while nodes
# its capture recorded (a nested loop keeps its own)
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
                      copied_bytes=0, static_bytes=0, while_nodes=0, iterations=None)

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


def _walk_ops(ops):
    """One walk of a solve's operators (``capture_signature``; shared
    nodes and tensors between them are seen once), its key the operators'
    items alone (() for none)."""
    from ..core.base import capture_signature

    sig = capture_signature(tuple(ops))
    return sig._replace(key=sig.key[1:])


def _distributed(tensors, ops) -> bool:
    """A solve over DTensor state, or over a distributed operator (a loop
    that keeps this rank's rows as plain state: ``parallel/comm.py::Rows``)."""
    if any(_is_dtensor(t) for t in tensors):
        return True
    from ..parallel.comm import mesh_of

    return mesh_of(tuple(ops)) is not None


def _path(tensors, ops) -> tuple:
    """(the path a loop takes, and for the graph path the operators'
    signature and whether the solve is distributed). The blocks path walks
    the operators only under autograd: ``_remember`` takes its key after
    the eager run."""
    if _traced(tensors) or not all(op is None or op.capture_safe for op in ops):
        return "per_iteration", None, False
    graph = bool(tensors) and tensors[0].is_cuda and CAPTURE
    sig, dist = None, False
    if graph or torch.is_grad_enabled():
        sig = _walk_ops(ops)
        if torch.is_grad_enabled() and any(t.requires_grad for t in sig.tensors):
            return "per_iteration", None, False
        dist = _distributed(list(sig.tensors) + list(tensors), ops)
    return ("graph" if graph else "blocks"), sig, dist


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


def _rebuilt(value, mirror_of: dict):
    """``value`` (a field's value) with each tensor it holds replaced by its
    mirror; operators and plan objects stay (they are pointed at mirrors
    field by field)."""
    if isinstance(value, torch.Tensor):
        return mirror_of.get(id(value), value)
    if isinstance(value, tuple):
        items = [_rebuilt(v, mirror_of) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    if isinstance(value, list):
        return [_rebuilt(v, mirror_of) for v in value]
    if isinstance(value, dict):
        return {k: _rebuilt(v, mirror_of) for k, v in value.items()}
    return value


class _Mirrors:
    """Captured blocks' own copies of tensors their operators hold (the
    indices ``index`` of ``Signature.tensors``: every mirrored one, or for a
    block that reads the rest in place only the state): static tensors of
    their layouts on the blocks' device (a host scalar of a state field
    lands there: in the graph it would be read on the host at capture and
    its later values never seen), and which of the operators' tensors each
    last copied (a weak reference and its ``_version``). The blocks of one
    operators' key share one set (``_mirror_set``). ``nbytes``: the memory
    they take here; ``bytes``: the same with a DTensor at its largest
    shard's size (the same on every rank, for the cache's bound)."""

    def __init__(self, sig, device, index=None):
        from ..core.base import _local

        self.index = list(sig.mirrored if index is None else index)
        self.skey = (sig.key, tuple(self.index), device)  # what blocks that share it match
        self.written = [i for i in sig.written if i in self.index]
        self.static = {}
        for i in self.index:
            t = sig.tensors[i]
            self.static[i] = _static_copy(t, device)
            self.static[i].copy_(t)
        mirror_of = self._mirror_of(sig.tensors)
        for i in self.index:  # a plan kept on a tensor (lane_gather.tiled_combine_plan)
            plan = getattr(sig.tensors[i], "_combine_plan", None)
            if plan is not None:
                self.static[i]._combine_plan = _rebuilt(plan, mirror_of)
        self.last = {i: (weakref.ref(sig.tensors[i]), _local(sig.tensors[i])._version)
                     for i in self.index}
        self.nbytes = sum(_local(s).untyped_storage().nbytes() for s in self.static.values())
        self.bytes = sum(_shard_bytes(sig.tensors[i]) for i in self.index)

    def _mirror_of(self, tensors) -> dict:
        return {id(tensors[i]): self.static[i] for i in self.index}

    def refresh(self, tensors) -> int:
        """Copy in every tensor (of a graph of this block's key, in walk
        order) that is not the one copied last; returns the bytes copied."""
        from ..core.base import _local

        n = 0
        for i in self.index:
            t = tensors[i]
            ref, version = self.last[i]
            local = _local(t)
            if ref() is not t or version != local._version:
                self.static[i].copy_(t)
                self.last[i] = (weakref.ref(t), local._version)
                n += local.numel() * local.element_size()
        return n

    def write_back(self, tensors) -> None:
        """Copy the fields an apply adds into back to the operators'."""
        from ..core.base import _local

        for i in self.written:
            t = tensors[i]
            t.copy_(self.static[i])
            self.last[i] = (weakref.ref(t), _local(t)._version)

    @contextlib.contextmanager
    def swapped(self, sig):
        """Point every field of ``sig``'s graph that holds tensors at the
        mirrors (past the operators' own ``__setattr__`` hooks, which would
        mark lazy state stale) and give the operators back their own after."""
        mirror_of = self._mirror_of(sig.tensors)
        own = [getattr(o, f) for o, f in sig.holders]
        mine = [_rebuilt(v, mirror_of) for v in own]
        for (o, f), v in zip(sig.holders, mine):
            object.__setattr__(o, f, v)
        try:
            yield
        finally:
            moved = [(o, f) for (o, f), v in zip(sig.holders, mine) if getattr(o, f) is not v]
            for (o, f), v in zip(sig.holders, own):
                object.__setattr__(o, f, v)
            if moved:
                raise RuntimeError(
                    "a captured block replaced the state " + ", ".join(
                        f"{type(o).__name__}.{f}" for o, f in moved)
                    + " while capturing: state updates belong outside a solve")


class _Graph:
    """One captured function over static input buffers: ``run(args,
    tensors)`` copies ``args`` in (those given), refreshes the mirrors from
    ``tensors`` (the walk of the solve's operators) and replays. Holds no
    operator: ``ops`` only name them in an error. The operators' tensors
    that ``mirrors`` does not copy (all of them without mirrors) are read in
    place: the block holds them (``bound``), so their addresses stay theirs."""

    def __init__(self, fn, args, ops, what: str, sig=None, mirrors=None):
        global _captures
        self.body_pools = {}  # nesting depth -> [the while node bodies' pool, captures in it]
        self.bodies = []  # the while nodes' body graphs (cudaGraph_t addresses), in capture order
        self.inputs = [a.clone() for a in args]
        device = self.device = args[0].device
        _body_stream(device, 0)  # made (and its cuBLAS workspace) before the capture
        self.mirrors = mirrors
        copied = () if mirrors is None else mirrors.static
        self.bound = [t for i, t in enumerate(sig.tensors if sig is not None else ())
                      if i not in copied]
        self.static_bytes = mirrors.nbytes if mirrors is not None else 0  # held by this block
        # per table: a kernel module first imported during the capture registers its
        # table then, and counts from 0
        before = {id(t): dict(t) for t in _LAUNCH_TABLES}
        t0 = time.perf_counter()
        # keep_graph: the captured graph stays readable (raw_cuda_graph), so its
        # kernel nodes can be listed (chip_smoke.py counts them per block)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize(device)
        err = None
        debug = torch.cuda.get_sync_debug_mode()
        swapped = mirrors.swapped(sig) if mirrors is not None else contextlib.nullcontext()
        with swapped, torch.cuda.stream(_stream(device)):
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
        self.launches = {k: t[k] - before.get(id(t), {}).get(k, 0) for t in _LAUNCH_TABLES
                         for k in t if t[k] != before.get(id(t), {}).get(k, 0)}

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

    def run(self, args=(), tensors=None):
        """Replay; with ``args`` (a solve's first replay) copy them in first,
        and with ``tensors`` refresh the mirrors from them."""
        global _last_graph
        for s, a in zip(self.inputs, args):
            if a is not None:
                s.copy_(a)
        if tensors is not None and self.mirrors is not None:
            _bump("copied_bytes", self.mirrors.refresh(tensors))
        if _active:
            _active[-1]["static_bytes"] = self.static_bytes
        self.replay()
        _last_graph = self
        return self.outputs

    def finish(self, tensors) -> None:
        """The end of a solve over ``tensors``: copy the written fields back."""
        if self.mirrors is not None and self.mirrors.written:
            self.mirrors.write_back(tensors)

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


def _key(kind, key, opkey, tensors, block: int | None = None) -> tuple:
    """A solve's cache key; ``block`` its block length (``BLOCK`` when None)."""
    return (kind, key, BLOCK if block is None else block, _signature(tensors), opkey)


class _Seen:
    """A signature seen once: its next solve captures. ``held``: for a
    distributed signature keyed by identity (``_bound_key``), the tensors
    whose ids are in the key, kept so no new tensor takes an id on one rank
    and not on another."""

    __slots__ = ("held",)

    def __init__(self, held=()):
        self.held = held


class _Unmirrored(_Seen):
    """A structure whose copies did not fit (``_mirror_set``): its blocks
    read the operators' tensors in place, each kept under ``_bound_key``."""

    __slots__ = ()


def _cache(dist: bool):
    return _DIST_CACHE if dist else _CACHE


def _bound_key(ckey, sig) -> tuple:
    """``ckey`` with the identity of every tensor a block would read in
    place (all but the state): a block that reads an operator's own tensors
    replays only over them, as blocks were keyed before they had copies."""
    from ..core.base import _local

    state = set(sig.state)
    return ("bound", ckey, tuple((id(sig.tensors[i]), _local(sig.tensors[i])._version)
                                 for i in sig.mirrored if i not in state))


def _find(kind, key, sig, tensors, dist: bool, block: int | None = None) -> tuple:
    """(the cache key of a solve on the graph path, whether it was seen, its
    captured block or None): the structure's key, or where the structure's
    copies did not fit, its ``_bound_key``."""
    cache = _cache(dist)
    ckey = _key(kind, key, sig.key, tensors, block)
    if isinstance(cache.get(ckey), _Unmirrored):
        cache.move_to_end(ckey)
        ckey = _bound_key(ckey, sig)
    return (ckey,) + _lookup(ckey, dist)


def _lookup(key, dist: bool = False) -> tuple:
    """(whether the signature was seen, its captured block or None)."""
    cache = _cache(dist)
    if key not in cache:
        return False, None
    cache.move_to_end(key)
    g = cache[key]
    return True, None if isinstance(g, _Seen) else g


def _mirrors(entry):
    return getattr(entry, "mirrors", None)


def _drop(cache, key) -> None:
    """Turn the block under ``key`` back into a signature seen once (its
    next solve captures again): its graph, its pool and, unless another
    block shares them, its mirrors go."""
    global _last_graph
    g = cache[key]
    if g is _last_graph:
        _last_graph = None
    cache[key] = _Seen(g.bound if cache is _DIST_CACHE and key[0] == "bound" else ())


def _store(key, g, dist: bool = False) -> None:
    """Keep ``g`` under ``key``, the most recently used; past the cache's
    size drop the least recently used entry."""
    global _last_graph
    cache = _cache(dist)
    cache[key] = g
    cache.move_to_end(key)
    while len(cache) > _CACHE_SIZE:
        _, old = cache.popitem(last=False)
        if old is _last_graph:
            _last_graph = None


def _shard_bytes(t) -> int:
    """The bytes of ``t``'s copy on the rank that holds the most of it: a
    DTensor's largest shard, from its global shape and placements (the same
    on every rank)."""
    if not _is_dtensor(t):
        return t.numel() * t.element_size()
    shape = list(t.shape)
    for d, p in enumerate(t.placements):
        if p.is_shard():
            shape[p.dim] = -(-shape[p.dim] // t.device_mesh.size(d))
    return math.prod(shape) * t.element_size()


def _held(cache) -> int:
    """The bytes of the mirror sets the blocks of ``cache`` hold, a set
    shared by several once."""
    sets = {id(m): m for m in map(_mirrors, cache.values()) if m is not None}
    return sum(m.bytes for m in sets.values())


def _evict(cache, room: float) -> None:
    """Turn the least recently used blocks of ``cache`` that hold mirrors
    back into signatures seen once until its sets take at most ``room``
    bytes."""
    for k in list(cache):
        if _held(cache) <= room:
            return
        if _mirrors(cache[k]) is not None:
            _drop(cache, k)


def _make_room(need: int, dist: bool, limit: float) -> bool:
    """Whether a new mirror set of ``need`` bytes fits under ``limit``
    beside the sets both caches keep, after the least recently used blocks
    made room. A distributed solve decides by the distributed cache alone
    (the same on every rank), then frees what the rank-local cache holds
    past the bound; a rank-local solve frees room in its own cache only."""
    fixed = 0 if dist else _held(_DIST_CACHE)
    if need > limit - fixed:
        return False
    _evict(_cache(dist), limit - fixed - need)
    if dist:
        _evict(_CACHE, limit - _held(_DIST_CACHE) - need)
    return True


def _mirror_limit(device) -> float:
    return MIRROR_SHARE * torch.cuda.get_device_properties(device).total_memory


def _free_bytes(device) -> int:
    """Device memory a new allocation can take: CUDA's free memory and
    what torch's allocator keeps cached unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def _free_fits(need: int, dist: bool, device, tensors, ops=()) -> bool:
    """Whether ``need`` bytes (this rank's) take at most ``FREE_SHARE`` of
    the free device memory; a distributed solve takes the answer of the
    rank with the least room (one all-reduce over the mesh of ``tensors``'
    DTensors, else of the distributed ``ops``; a mesh of one rank has
    nothing to agree on), so every rank decides alike."""
    fits = need <= FREE_SHARE * _free_bytes(device)
    if not dist:
        return fits
    import torch.distributed as tdist

    from ..parallel.comm import mesh_of

    mesh = next((t.device_mesh for t in tensors if _is_dtensor(t)), None) or \
        mesh_of(tuple(ops))
    if mesh.size() == 1:
        return fits
    flag = torch.tensor(int(fits), device=device)
    for d in range(mesh.ndim):
        tdist.all_reduce(flag, op=tdist.ReduceOp.MIN, group=mesh.get_group(d))
    return bool(flag.item())


def _mirror_set(sig, index, dist: bool, device, tensors, check: bool = True, ops=()):
    """The mirrors a new block over ``sig`` reads for the tensors ``index``:
    the set that the solve's cache's blocks of the same operators' key hold
    (the same on every rank for a distributed solve), or a new one (None for
    no index). With ``check``, None too when a new set does not fit: its
    bytes over ``MIRROR_SHARE`` of the card's memory beside the kept sets
    once the least recently used blocks made room (``_make_room``), or over
    ``FREE_SHARE`` of the free memory."""
    from ..core.base import _local

    if not index:
        return None
    skey = (sig.key, tuple(index), device)
    for m in map(_mirrors, _cache(dist).values()):
        if m is not None and m.skey == skey:
            return m
    if check:
        if not _make_room(sum(_shard_bytes(sig.tensors[i]) for i in index), dist,
                          _mirror_limit(device)):
            return None
        local = sum(_local(sig.tensors[i]).numel() * sig.tensors[i].element_size()
                    for i in index)
        if not _free_fits(local, dist, device, list(sig.tensors) + list(tensors), ops):
            return None
    return _Mirrors(sig, device, index)


def _capture(ckey, fn, args, ops, what: str, sig, dist: bool):
    """Capture ``fn`` over ``args`` into a block kept under ``ckey`` and
    replay it once (its outputs are the first block's). The block reads the
    operators' tensors from the mirrors their key shares, or, where a new
    set of them does not fit, in place: the structure is then marked
    ``_Unmirrored`` and the block kept under its ``_bound_key``, copying
    the state alone (small, so never refused: pushes still replay)."""
    dev = args[0].device
    m = None
    if ckey[0] != "bound":
        m = _mirror_set(sig, sig.mirrored, dist, dev, args, ops=ops)
        if m is None and sig.mirrored:
            _store(ckey, _Unmirrored(), dist)
            ckey = _bound_key(ckey, sig)
    if ckey[0] == "bound":
        m = _mirror_set(sig, sig.state, dist, dev, args, check=False)
    g = _Graph(fn, args, ops, what, sig, m)
    _store(ckey, g, dist)
    out = g.run((), sig.tensors)  # a shared set may hold another operator's tensors
    return g, out


def _remember(kind, key, ops, tensors, block: int | None = None) -> None:
    """Note a signature whose eager run built its plans (its key is taken
    now, with them): on the card its next run captures."""
    sig = _walk_ops(ops)
    dist = _distributed(list(sig.tensors) + list(tensors), ops)
    ckey, seen, _ = _find(kind, key, sig, tensors, dist, block)
    if not seen:
        _store(ckey, _Seen(sig.tensors if dist and ckey[0] == "bound" else ()), dist)


# ----------------------------------------------------------------------------
# while
# ----------------------------------------------------------------------------


def _carry(new, old) -> tuple:
    """The body's new state, each DTensor in the placements its entry came in
    with and each plain entry plain (``parallel/comm.py::keep_placements``),
    as a compiled loop's carry keeps its sharding: the solve's key is the
    same before and after it runs."""
    new = tuple(new)
    if any(_is_dtensor(t) for t in new):
        from ..parallel.comm import keep_placements

        return keep_placements(new, tuple(old))
    return new


def _select(act, new, old):
    """``where(act, new, old)`` entry by entry; a per-member ``act`` (B,)
    (a loop over members, ``_vmapped_while``) selects along each entry's
    leading batch dimension."""
    new = _carry(new, old)
    out = []
    for a, b in zip(new, old):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise TypeError(f"loop body changed a state entry from {b.dtype}{tuple(b.shape)} "
                            f"to {a.dtype}{tuple(a.shape)}")
        mask = act.reshape(act.shape + (1,) * (a.ndim - act.ndim)) if act.ndim else act
        out.append(torch.where(mask, a, b))
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


def _while_block(cond, body, state, consts, k, act, lim, n: int, keeps: bool = False):
    for _ in range(n):
        new = _call_body(body, state, consts, k, act)
        state = _carry(new, state) if keeps else _select(act, new, state)
        k = k + act.to(k.dtype)
        act = _whole(cond(state, consts)) & (k < lim)
    return state, k, act


def _plain_while(cond, body, state, consts, maxiter, go, path, block: int = 1):
    """The plain loop: one host read per iteration. Under vmap (``path``
    "vmap": a batch of operators, nested vmap levels, DTensor state or a
    wanted gradient, where ``_members`` refuses the members' path) every
    member runs until all have stopped, each frozen once its
    own test fails, and the count is a per-member tensor; the iterations run
    in masked blocks of ``block``, with one host read (is any member still
    active) before the first and after each block, and none past
    ``maxiter``: a member's state and count are those of a read after every
    iteration, since a frozen member stays frozen (its state, and so its
    test, no longer moves)."""
    dev = state[0].device
    j = torch.zeros((), dtype=torch.int64, device=dev)
    with _Loop(path) as st:
        if path == "vmap":
            k = torch.zeros_like(go, dtype=torch.int64)
            act = go & (k < maxiter)
            it = 0
            while it < maxiter and _any_member(act):
                for _ in range(min(block, maxiter - it)):
                    state = _select(act, _call_body(body, state, consts, j, None), state)
                    k = k + act.long()
                    act = cond(state, consts) & (k < maxiter)
                    j = j + 1
                    it += 1
                st["blocks"] += 1
            return state, k
        k = 0
        while k < maxiter and _read(go):
            state = _carry(_call_body(body, state, consts, j, None), state)
            k += 1
            j = j + 1
            go = cond(state, consts)
            st["blocks"] += 1
        st["iterations"] = k
        return state, k


def device_while(cond, body, state: tuple, maxiter: int, *, consts: tuple = (), ops=(),
                 key=(), block: int | None = None, keeps: bool = False):
    """``state = body(state, consts, k)`` while ``cond(state, consts)``
    holds, at most ``maxiter`` times; ``k`` is the iteration's index as a
    0-dim int64 tensor on the state's device. ``consts`` are tensors the
    body reads and never changes; ``ops`` the operators it applies (their
    ``capture_signature`` keys the captured block, ``capture_safe`` picks
    the path); ``key`` the caller's static arguments the body depends on;
    ``block`` the iterations of a masked block (``BLOCK`` when None). The
    body reads no other tensor made per call: a captured block would replay
    over it. ``keeps``: the body itself leaves the state of a frozen
    iteration as it was (a panel solve whose per-member masks cover every
    iteration the loop's mask freezes), so the loop's ``where`` over the
    state is skipped.

    Returns (state, iterations): an ``int``, or under ``torch.func.vmap`` a
    per-member tensor (every member runs until all have stopped, each frozen
    once its own test fails, as ``jax.vmap`` of a ``lax.while_loop``; in
    masked blocks of ``block``, one host read per block, captured on the
    card as an unbatched loop's: ``_vmapped_while``), or
    inside a capture (a loop nested in a captured block's iteration) a 0-dim
    int64 tensor on the device, the loop then being one CUDA while node.

    Started inside a masked iteration (a nested solve in an outer loop's
    body), the loop ANDs that iteration's mask into its test: in a frozen
    outer iteration it runs no iteration."""
    state, consts = tuple(state), tuple(consts)
    block = BLOCK if block is None else int(block)
    outer = _OUTER[-1] if _OUTER else None
    with _replicating(state + consts + (() if outer is None else (outer,))):
        state = _carry(state, state)  # DTensor state: pending partial sums reduced
        go = cond(state, consts)
        if _batched(go):
            if outer is not None:  # a loop inside a member's iteration (``_vmapped_while``)
                go = go & outer
            level = torch._C._functorch.maybe_get_level(go)
            if _members(state, consts, ops, level):
                return _vmapped_while(cond, body, state, consts, maxiter, go, ops, key, block,
                                      keeps, level)
            return _plain_while(cond, body, state, consts, maxiter, go, "vmap", block)
        if outer is not None:
            go = go & outer
        return _device_while(cond, body, state, consts, maxiter, go, ops, key, block, keeps)


def _while_node(cond, body, state, consts, maxiter, go, ops, key, block, keeps):
    """``device_while`` inside a capture: a CUDA conditional WHILE node
    (``kernels/graph_cond.py``) whose body is one masked block of ``block``
    iterations. Its condition is set from the loop's test by a kernel before
    the node and at the end of each body run, so the node repeats the block
    until the test fails or ``maxiter`` is reached, and nothing is read on
    the host. The state, the count and the test live in buffers made before
    the node (captured, so each replay starts them afresh). Returns (state,
    iterations as a 0-dim int64 tensor). Over members (``_vmapped_while``:
    ``go`` (B,)) the count and the test are per member and the node repeats
    while any member is active; the count comes back (B,)."""
    from ..kernels import graph_cond

    if not _CAPTURING:
        raise RuntimeError(f"device_while{key!r}: a CUDA graph capture is in progress that "
                           "utils/loop.py did not start; a while node needs its block's memory")
    owner = _CAPTURING[-1]
    dev = state[0].device
    go = _whole(go)
    k = torch.zeros(go.shape, dtype=torch.int64, device=dev)
    lim = torch.full((), maxiter, dtype=torch.int64, device=dev)
    act = go & (k < lim)
    flag = act.any() if act.ndim else act  # the node's condition
    bufs = tuple(s.clone() for s in state)
    depth = len(graph_cond.open_bodies())
    try:
        with graph_cond.while_node(flag, _body_stream(dev, depth),
                                   owner.body_memory(depth)) as body_graph:
            owner.bodies.append(body_graph)
            s_out, k_out, a_out = _while_block(cond, body, bufs, consts, k, act, lim, block,
                                               keeps)
            for b, b2 in zip(bufs, s_out):
                b.copy_(b2)
            k.copy_(k_out)
            act.copy_(a_out)
            if flag is not act:
                flag.copy_(a_out.any())
    except Exception as e:
        names = ", ".join(_describe(op) for op in ops if op is not None)
        raise RuntimeError(f"device_while{key!r}: capturing the loop as a CUDA while node "
                           f"failed on {names}: {e}") from e
    _bump("while_nodes")
    return bufs, k


def _device_while(cond, body, state, consts, maxiter, go, ops, key, block, keeps):
    """The loop outside a capture: masked blocks of ``block`` iterations,
    one host read after each, of (is the loop active, its count). On the
    card a signature's first solve runs the per-iteration loop on the
    capture stream, its next one captures a block and replays it ("graph");
    on the CPU (or with ``CAPTURE`` off) the blocks run eagerly ("blocks").
    Inside a capture (a loop nested in a captured block's iteration) it is a
    while node (``_while_node``). Returns (state, iterations as an int).

    Over members (``_vmapped_while``: the members leading in every state
    and const entry, ``go`` (B,)) the count and the mask are per member,
    each member frozen once its own test fails (``_select``), and a block's
    read is of (is any member active, the largest count); a signature's
    first solve on the card runs eager masked blocks on the capture stream,
    not the per-iteration loop; the paths are "vmap_blocks" and "vmap_graph"
    (the key leads with "vmap"; the signature holds the members' count
    through the state's shapes); the count comes back per member, (B,)
    int64."""
    if state[0].is_cuda and torch.cuda.is_current_stream_capturing():
        return _while_node(cond, body, state, consts, maxiter, go, ops, key, block, keeps)
    members = go.ndim > 0
    path, sig, dist = _path(state + consts, ops)
    if path == "per_iteration":  # never over members (``_members`` refuses them)
        return _plain_while(cond, body, state, consts, maxiter, go, path)
    dev = state[0].device
    if members:
        key = ("vmap",) + tuple(key)
    ckey, seen, g = (_find("while", key, sig, state + consts, dist, block) if path == "graph"
                     else (None, False, None))
    if path == "graph" and not seen and not members:  # a first solve: the plain loop
        with _on_capture_stream(dev):
            state, count = _plain_while(cond, body, state, consts, maxiter, go, "per_iteration")
        _remember("while", key, ops, state + consts, block)
        return state, count
    k = torch.zeros(go.shape, dtype=torch.int64, device=dev)
    lim = torch.full((), maxiter, dtype=torch.int64, device=dev)
    act = _whole(go) & (k < lim)

    def status(a, k_):
        if members:
            return torch.stack((a.any().to(torch.int64), k_.max()))
        return torch.stack((a.to(torch.int64), k_))

    eager = path == "blocks" or not seen
    name = ("vmap_" if members else "") + ("blocks" if eager else "graph")
    where = _on_capture_stream(dev) if path == "graph" and eager else contextlib.nullcontext()
    with _Loop(name) as st, where:
        if g is None and not _read(act.any()):  # a cached block runs first and reads after
            st["iterations"] = 0
            if eager:
                _remember("while", key, ops, state + consts, block)
            return state, (k if members else 0)
        if eager:
            while True:
                state, k, act = _while_block(cond, body, state, consts, k, act, lim, block,
                                             keeps)
                st["blocks"] += 1
                more, top = _read(status(act, k))
                if not more:
                    st["iterations"] = top
                    _remember("while", key, ops, state + consts, block)
                    return state, (k if members else top)
        ns, nc = len(state), len(consts)
        if g is None:
            n = block

            def block_fn(*bufs):
                s_in, c_in, (k_in, a_in, l_in) = bufs[:ns], bufs[ns:ns + nc], bufs[ns + nc:]
                s_out, k_out, a_out = _while_block(cond, body, s_in, c_in, k_in, a_in, l_in, n,
                                                   keeps)
                for s_, s2 in zip(s_in, s_out):
                    s_.copy_(s2)
                k_in.copy_(k_out)
                a_in.copy_(a_out)
                return status(a_out, k_out)

            g, out = _capture(ckey, block_fn, state + consts + (k, act, lim), ops,
                              f"device_while{key!r}", sig, dist)
        else:
            out = g.run(state + consts + (k, act, lim), sig.tensors)
        while True:
            st["blocks"] += 1
            more, top = _read(out)
            if not more:
                break
            out = g.run()
        g.finish(sig.tensors)
        st["iterations"] = top
        state = tuple(s_.clone() for s_ in g.inputs[:ns])
        return state, (g.inputs[ns + nc].clone() if members else top)


# ----------------------------------------------------------------------------
# while under vmap: the members as a leading batch dimension
# ----------------------------------------------------------------------------


def _members(state, consts, ops, level: int) -> bool:
    """Whether a loop under ``torch.func.vmap`` can run over its members as
    plain tensors (``_vmapped_while``): every state and const entry plain or
    batched at ``level`` alone (one vmap level: a nested vmap's tensors
    keep the eager path), none a DTensor, no gradient wanted, and the
    operators ``capture_safe`` with plain tensors (a vmap over an operator's
    own data, a batch of operators, keeps the eager path)."""
    F = torch._C._functorch
    grad = torch.is_grad_enabled()
    for t in state + consts:
        if F.is_functorch_wrapped_tensor(t):
            if not F.is_batchedtensor(t) or F.maybe_get_level(t) != level:
                return False
            t = F.get_unwrapped(t)
            if F.is_functorch_wrapped_tensor(t):
                return False
        if _is_dtensor(t) or (grad and t.requires_grad):
            return False
    if not all(op is None or op.capture_safe for op in ops):
        return False
    return not any(F.is_functorch_wrapped_tensor(t) or (grad and t.requires_grad)
                   for t in _walk_ops(ops).tensors)


def _unbatched(t, level: int, size: int):
    """``t`` as a plain tensor with the members leading: its batch at
    ``level`` moved to dimension 0, or a plain ``t`` copied for each of the
    ``size`` members."""
    F = torch._C._functorch
    if F.is_functorch_wrapped_tensor(t):
        v, bdim = F._unwrap_batched(t, level)
        if bdim is not None:
            return v.movedim(bdim, 0)
        t = v
    return t.expand((size,) + tuple(t.shape)).clone()


def _vmapped_while(cond, body, state, consts, maxiter, go, ops, key, block, keeps, level):
    """``device_while`` under ``torch.func.vmap``, as ``jax.vmap`` of a
    ``lax.while_loop`` compiles one loop: the state and the consts are
    unwrapped from the vmap level to plain tensors with the members leading
    (``_unbatched``), and the loop runs over them as an unbatched loop runs
    (``_device_while``), its ``cond`` and ``body`` each one
    ``torch.func.vmap`` over the members; the results are wrapped at the
    caller's level again, the count a per-member tensor."""
    F = torch._C._functorch
    v, bdim = F._unwrap_batched(go, level)
    size = v.shape[bdim]
    state = tuple(_unbatched(t, level, size) for t in state)
    consts = tuple(_unbatched(t, level, size) for t in consts)
    go = v.movedim(bdim, 0)

    def vcond(s, c):
        return torch.func.vmap(cond)(s, c)

    def vbody(s, c, k):
        act = _OUTER[-1]  # the block's per-member mask (``_call_body``)

        def one(s_, c_, k_, a_):  # a member's mask is the test a loop inside it ANDs
            return _call_body(body, s_, c_, k_, a_)

        return torch.func.vmap(one)(s, c, k, act)

    state, k = _device_while(vcond, vbody, state, consts, maxiter, go, ops, key, block, keeps)
    return tuple(F._add_batch_dim(t, 0, level) for t in state), F._add_batch_dim(k, 0, level)


def _fori_block(body, state, consts, n: int):
    for _ in range(n):
        state = _carry(body(state, consts), state)
    return state


def device_fori(body, state: tuple, iters: int, *, consts: tuple = (), ops=(), key=()):
    """``state = body(state, consts)`` ``iters`` times, with no host read.
    On a CUDA device, once this signature has run before, blocks of
    ``BLOCK`` iterations replay a captured graph and the last ``iters mod
    BLOCK`` run eagerly; its first run is eager throughout. Returns the
    state."""
    state, consts = tuple(state), tuple(consts)
    state = _carry(state, state)  # DTensor state: pending partial sums reduced
    if iters > 0 and state[0].is_cuda and torch.cuda.is_current_stream_capturing():
        return _fori_block(body, state, consts, iters)  # nested in a block being captured
    path, sig, dist = _path(state + consts, ops) if iters > 0 else ("blocks", None, False)
    n = BLOCK
    ckey, seen, g = (_find("fori", key, sig, state + consts, dist, n) if path == "graph"
                     else (None, False, None))
    label = path if path != "graph" else "graph" if seen and iters >= n else "blocks"
    with _Loop(label) as st:
        if path != "graph":
            st["blocks"] += iters > 0
            out = _fori_block(body, state, consts, max(iters, 0))
            if path == "blocks" and iters > 0:
                _remember("fori", key, ops, state + consts, n)
            return out
        dev = state[0].device
        if not seen or iters < n:  # eagerly, on the capture stream
            st["blocks"] += 1
            with _on_capture_stream(dev):
                first = _fori_block(body, state, consts, 1)
                out = _fori_block(body, first, consts, iters - 1)
            if _signature(first) == _signature(state):  # type-stable: it can be captured
                _remember("fori", key, ops, state + consts, n)
            return out
        ns = len(state)
        if g is None:

            def block(*bufs):
                s_out = _fori_block(body, bufs[:ns], bufs[ns:], n)
                for s, s2 in zip(bufs[:ns], s_out):
                    s.copy_(s2)
                return ()

            g, _ = _capture(ckey, block, state + consts, ops, f"device_fori{key!r}", sig, dist)
        else:
            g.run(state + consts, sig.tensors)
        done = n
        st["blocks"] += 1
        while iters - done >= n:
            g.run()
            done += n
            st["blocks"] += 1
        g.finish(sig.tensors)
        state = tuple(s.clone() for s in g.inputs[:ns])
        return _fori_block(body, state, consts, iters - done)
