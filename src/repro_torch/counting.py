"""Counting the cost of a step op by op: the counter under the port's dry
run (``launch/dryrun.py``), the counterpart of the HLO walk in
``repro/launch/hlo_analysis.py``.

The reference walks XLA's optimized HLO with loop trip counts.  The port
runs eager, so there is no HLO: ``CostCounter`` is a ``TorchDispatchMode``
that sees every aten op the step dispatches, on ``meta`` tensors (the dry
run: shapes, no data, nothing allocated) or on the card (the same count
of a real call).  It keeps

* **FLOPs**, from the formulas ``torch.utils.flop_counter`` registers for
  aten ops (matrix products, convolutions, attention), plus the work each
  hand-written kernel reports (``count_kernel``);
* **HBM bytes**: every op reads its tensor inputs and writes its outputs
  (eager ops do not fuse).  A view costs nothing; an in-place scatter
  into a buffer (a cache's slice, ``index_put_``) costs twice what it
  writes, never the whole buffer (``hlo_analysis._inplace_update_bytes``);
  a broadcast input is read once.  CPU tensors are not counted;
* **live and peak bytes**: every storage an op creates is live until its
  last reference goes (``StorageWeakRef``; a tensor's finalizer says when
  to look);
* **kernel calls and kernel work**, per kernel;
* **trip counts**: ``trip(n)`` counts a loop body once and adds it n
  times, as ``HloModule.cost`` multiplies a ``while`` body by its trip
  count; the bytes the body leaves alive (its outputs, what autograd
  saves for the backward) are counted n times too, and the peak they
  reach.  ``trip_scan`` and ``trip_map`` run a per-token recurrence or a
  chunk loop that way on meta, differentiably: the body's backward is
  counted n times as well.

It sits below the kernels and the models, which call ``count_kernel``
and ``tripping``; the rates and the roofline are ``launch/cost.py``'s.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
#: In-place scatters: they write what their non-destination operands
#: carry, at most, and read as much (2x, as ``_inplace_update_bytes``).
_SCATTERS = frozenset({
    _aten.index_put_, _aten._index_put_impl_, _aten.index_copy_,
    _aten.index_add_, _aten.scatter_, _aten.scatter_add_,
    _aten.scatter_reduce_, _aten.masked_scatter_, _aten.put_,
    _aten.index_fill_, _aten.masked_fill_})
#: Allocations that write nothing.
_EMPTY = frozenset({_aten.empty, _aten.empty_strided, _aten.empty_like,
                    _aten.new_empty, _aten.new_empty_strided})
#: In-place ops that overwrite their destination without reading it.
_OVERWRITES = frozenset({_aten.copy_, _aten.fill_, _aten.zero_,
                         _aten.normal_, _aten.uniform_, _aten.random_,
                         _aten.bernoulli_, _aten.exponential_})

_ACTIVE: List["CostCounter"] = []


def active() -> Optional["CostCounter"]:
    """The innermost counter that is counting, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def count_kernel(name: str, flops: float, nbytes: float) -> None:
    """Record one call of the hand-written kernel ``name`` and its work,
    if a counter is counting; nothing otherwise.  Each wrapper calls it
    where it launches its kernel (cuda) and in its meta branch."""
    ctr = active()
    if ctr is not None:
        ctr.kernel(name, flops, nbytes)


def tripping(t: torch.Tensor) -> bool:
    """Whether a loop over ``t`` should run under trip counts: ``t`` is a
    meta tensor and a counter is counting."""
    return bool(_ACTIVE) and t.device.type == "meta"


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op moves for ``t``: its elements times their size, a
    broadcast (zero-stride) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments,
    a step's inputs), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:        # no recursive closure: its cycle would hold them
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


_COMPOSITE: Dict[object, bool] = {}


def _composite(func) -> bool:
    """Whether ``func`` is made of other aten ops (a
    CompositeImplicitAutograd kernel), cached per op."""
    known = _COMPOSITE.get(func)
    if known is None:
        known = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        _COMPOSITE[func] = known
    return known


def _counted(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


class _Store:
    """A storage the counter holds live: its weak reference, the bytes
    it stands for (a trip's copies included) and how many tracked tensors
    still view it."""
    __slots__ = ("ref", "nbytes", "views")

    def __init__(self, ref: StorageWeakRef, nbytes: int) -> None:
        self.ref, self.nbytes, self.views = ref, nbytes, 0


class CostCounter(TorchDispatchMode):
    """Counts the ops of the calls under ``with CostCounter() as c:``.

    Loops over meta tensors run under trip counts (``tripping``).
    ``track(tree)`` declares the tensors that live before the
    call (parameters, caches, the batch): they count in ``live`` and
    ``peak`` from the start, and ``base`` is their sum, so ``peak - base``
    is what the call itself adds.
    """

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_calls: Dict[str, int] = {}
        self.kernel_flops: Dict[str, float] = {}
        self.kernel_bytes: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.base = 0
        self._mult = [1]
        self._bwd = [1]
        self._stores: Dict[int, _Store] = {}
        self._pinned: set = set()
        self._pending: List[int] = []
        self._orphans: Dict[int, None] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._scopes: List[List[int]] = []
        self._once: List[set] = []

    # ------------------------------------------------------------ mode
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    @property
    def mult(self) -> int:
        """How many times an op counts now: the trip scopes around it,
        and in a backward the tripped bodies' backward scopes (not in a
        forward the backward runs, such as ``torch.utils.checkpoint``'s
        recompute: that runs under grad mode, the backward without)."""
        if self._bwd and not torch.is_grad_enabled():
            return self._mult[-1] * self._bwd[-1]
        return self._mult[-1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (_composite(func)
                and func._overloadpacket not in flop_counter.flop_registry):
            # a composite op (``matmul``, ``to``, ``reshape``: they reach
            # the mode whole under inference mode) counts as the ops it
            # is made of, as under grad mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._sweep()
        m = self.mult
        fn = flop_counter.flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += m * fn(*args, **kwargs, out_val=out)
        self.bytes += m * self._op_bytes(func, args, kwargs, out)
        for t in tensors(out):
            if _counted(t):
                self._hold(t)
        return out

    # ----------------------------------------------------------- bytes
    def _op_bytes(self, func, args, kwargs, out) -> int:
        schema = func._schema.arguments
        written, read = [], []
        for i, a in enumerate(schema):
            val = args[i] if i < len(args) else kwargs.get(a.name)
            ts = [t for t in tensors(val) if _counted(t)]
            if a.alias_info is not None and a.alias_info.is_write:
                written += [(t, a.name == "out") for t in ts]
            else:
                read += ts
        if written:
            packet = func._overloadpacket
            if packet in _SCATTERS:
                return 2 * sum(tensor_bytes(t) for t in read)
            total = sum(tensor_bytes(t) for t in read)
            for t, is_out in written:
                total += tensor_bytes(t)
                if not is_out and packet not in _OVERWRITES:
                    total += tensor_bytes(t)        # read, then written
            return total
        if func._overloadpacket in _EMPTY:
            return 0
        ins = {t.untyped_storage()._cdata for t in read}
        fresh = [t for t in tensors(out) if _counted(t)
                 and t.untyped_storage()._cdata not in ins]
        if not fresh:
            return 0                                # a view
        return (sum(tensor_bytes(t) for t in read)
                + sum(tensor_bytes(t) for t in fresh))

    # ------------------------------------------------------ live bytes
    def track(self, *trees) -> int:
        """Count the storages of ``trees``' tensors as live from now on,
        for as long as the caller holds them; returns their bytes."""
        added = 0
        for t in tensors(trees):
            if not _counted(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._pinned or key in self._stores:
                continue
            self._pinned.add(key)
            added += st.nbytes()
        self.live += added
        self.base += added
        self.peak = max(self.peak, self.live)
        return added

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._pinned:
            return
        store = self._stores.get(key)
        if store is None:
            store = _Store(StorageWeakRef(st), st.nbytes())
            self._stores[key] = store
            self.live += store.nbytes
            self.peak = max(self.peak, self.live)
            for scope in self._scopes:
                scope.append(key)
        store.views += 1
        self._orphans.pop(key, None)
        tid = id(t)
        old = self._refs.get(tid)
        if old is not None and old() is t:
            store.views -= 1            # this tensor is already counted
            return
        self._refs[tid] = weakref.ref(t, self._gone(key, tid))

    def _gone(self, key: int, tid: int):
        def callback(ref, pending=self._pending, refs=self._refs):
            if refs.get(tid) is ref:
                del refs[tid]
            pending.append(key)
        return callback

    def _sweep(self) -> None:
        """Free the storages no tensor or autograd record holds any
        more: those whose last tracked tensor went since the last sweep,
        and the ones still held then (an autograd record, a view made
        below the dispatcher), looked at again each time."""
        while self._pending:
            key = self._pending.pop()
            store = self._stores.get(key)
            if store is None:
                continue
            store.views -= 1
            if store.views <= 0:
                self._orphans[key] = None
        for key in list(self._orphans):
            store = self._stores[key]
            if store.ref.expired():
                del self._orphans[key]
                del self._stores[key]
                self.live -= store.nbytes

    # --------------------------------------------------------- kernels
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        m = self.mult
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + m
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + m * flops
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0.0) + m * nbytes
        self.flops += m * flops
        self.bytes += m * nbytes

    def add_bytes(self, nbytes: float) -> None:
        self.bytes += self.mult * nbytes

    # ----------------------------------------------------------- trips
    def push(self, n: int) -> None:
        """Open a tripped body's backward scope: ops in it count n times
        more."""
        self._bwd.append(self._bwd[-1] * n)

    def pop(self) -> None:
        self._bwd.pop()

    @contextlib.contextmanager
    def trip(self, n: int):
        """The body runs once and counts n times: its ops, kernel calls
        and the bytes it leaves alive.  Those bytes (Δ, the live bytes it
        added, less what ``once`` marks) are counted n - 1 more times, on
        the storages it made that are still alive, and the peak is the
        body's own plus them (the loop's last turn starts (n - 1)·Δ above
        the first) plus the ``once`` storages (the previous turn's)."""
        self._sweep()
        start, outer_peak = self.live, self.peak
        self.peak = self.live
        self._mult.append(self._mult[-1] * n)
        self._scopes.append([])
        self._once.append(set())
        try:
            yield self
        finally:
            made = self._scopes.pop()
            once = self._once.pop()
            self._mult.pop()
            self._sweep()
            body_peak = self.peak
            delta = self.live - start
            kept, replaced = [], 0
            for k in dict.fromkeys(made):
                store = self._stores.get(k)
                if store is None:
                    continue
                if k in once:
                    replaced += store.nbytes
                else:
                    kept.append(store)
            delta -= replaced
            extra = 0
            if delta > 0 and n > 1 and kept:
                extra = (n - 1) * delta
                held = sum(s.nbytes for s in kept)
                left = extra
                for s in kept[:-1]:
                    part = extra * s.nbytes // held
                    s.nbytes += part
                    left -= part
                kept[-1].nbytes += left
                self.live += extra
            # past the first turn, the previous turn's carry is alive
            # while the next is made
            prev = replaced if n > 1 else 0
            self.peak = max(outer_peak, body_peak + extra + prev)

    def once(self, t: torch.Tensor) -> None:
        """``t``, made in the innermost trip's body, stands for one tensor
        of the loop, not n (a carry each turn replaces)."""
        if self._once and _counted(t):
            self._once[-1].add(t.untyped_storage()._cdata)


# ----------------------------------------------------------------------
# Loops under trip counts, differentiable
# ----------------------------------------------------------------------

def _grad_bytes(g) -> int:
    return 0 if g is None else tensor_bytes(g)


class _Turns:
    """What a tripped loop's backward needs to know of one input: the
    turns the tripped body ran (their weights: how many of the loop's
    turns each stands for) and which of them sent it a gradient."""
    __slots__ = ("weights", "got")

    def __init__(self, weights: Sequence[int]) -> None:
        self.weights = tuple(weights)
        self.got = [False] * len(weights)

    def missing_sums(self) -> int:
        """Gradient sums the loop makes for this input and the tripped
        backward did not.  The loop sums each turn's gradient into the
        others'; the tripped turns' arrive last turn first, and a turn's
        sum is counted ``weight`` times when something is already there."""
        loop = sum(w for w, g in zip(self.weights, self.got) if g)
        made, held = 0, False
        for w, g in reversed(list(zip(self.weights, self.got))):
            if g:
                made += w if held else 0
                held = True
        return max(0, loop - 1) - made


class _Use(torch.autograd.Function):
    """A loop input as one turn reads it: ``x.select(1, index)`` (a slice
    of a sequence; its backward the loop's ``select_backward``) or ``x``
    itself (a weight every turn reads).  Its backward notes that the turn
    sent the input a gradient."""

    @staticmethod
    def forward(ctx, turns, turn, index, x):
        ctx.turns, ctx.turn, ctx.index = turns, turn, index
        ctx.shape = tuple(x.shape)
        ctx.set_materialize_grads(False)
        return x.view_as(x) if index is None else x.select(1, index)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None
        ctx.turns.got[ctx.turn] = True
        if ctx.index is not None:
            g = _aten.select_backward(g, ctx.shape, 1, ctx.index)
        return None, None, None, g


class _Enter(torch.autograd.Function):
    """Identity on a loop's inputs.  Its backward runs after the body's:
    it closes the backward scope that ``_Exit`` opened (``close``), and
    charges the gradient sums the loop makes and the tripped backward did
    not (``_Turns.missing_sums``; 3x the gradient's bytes each: two reads,
    one write)."""

    @staticmethod
    def forward(ctx, ctr, close, turns, *xs):
        ctx.ctr, ctx.close, ctx.turns = ctr, close, turns
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.close:
            ctx.ctr.pop()
        for g, turns in zip(grads, ctx.turns):
            if turns is not None and g is not None:
                ctx.ctr.add_bytes(3 * turns.missing_sums() * tensor_bytes(g))
        return (None, None, None) + grads


class _Exit(torch.autograd.Function):
    """Identity on a loop body's outputs.  Its backward runs before the
    body's and opens a scope that counts it ``n`` times."""

    @staticmethod
    def forward(ctx, ctr, n, *ys):
        ctx.ctr, ctx.n = ctr, n
        ctx.set_materialize_grads(False)
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *grads):
        ctx.ctr.push(ctx.n)
        return (None, None) + grads


class _Repeat(torch.autograd.Function):
    """``stack`` (or ``cat``) along ``dim`` of a loop's outputs, from the
    ones its tripped body made, ``ys[i]`` standing for ``counts[i]`` turns
    in a row: the loop's op on as many parts, so the same bytes.  Its
    backward hands each made output its own slice of the gradient (a
    view, as the loop's ``stack``/``cat`` backward does), not a sum over
    the turns it stands for."""

    @staticmethod
    def forward(ctx, counts, dim, cat, *ys):
        ctx.dim, ctx.cat, ctx.k = dim, cat, len(ys)
        ctx.set_materialize_grads(False)
        parts, ctx.at = [], []
        for y, c in zip(ys, counts):
            ctx.at.append(sum(p.shape[dim] for p in parts) if cat
                          else len(parts))
            parts += [y] * c
        ctx.sizes = [y.shape[dim] if cat else 1 for y in ys]
        return torch.cat(parts, dim) if cat else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * (3 + ctx.k)
        outs = tuple(g.narrow(ctx.dim, at, size) if ctx.cat
                     else g.select(ctx.dim, at)
                     for at, size in zip(ctx.at, ctx.sizes))
        return (None, None, None) + outs


class _Chunk(torch.autograd.Function):
    """The first of ``x.split(chunk)``'s n pieces, through the same split
    op; its backward is the split's: one ``cat`` of n chunk gradients."""

    @staticmethod
    def forward(ctx, x, chunk, n):
        ctx.n = n
        ctx.set_materialize_grads(False)
        return x.split(chunk)[0]

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        return torch.cat([g] * ctx.n), None, None


def trip_scan(step: Callable, carry: torch.Tensor,
              xs: Sequence[torch.Tensor], consts: Sequence[torch.Tensor] = ()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``for t in range(n): carry, y_t = step(carry, *[x[:, t] for x in
    xs], *consts)``, then ``(carry, stack(y_t, dim=1))``, counted as the
    loop is; outputs have the loop's shapes.  A counter must be counting
    (``tripping``).

    Without autograd one step runs under ``trip(n)``; its carry replaces
    the last (counted live once), its y is kept n times.  Under autograd
    the first step's backward (its incoming carry needs no gradient) and
    the last's (its carry gets none) differ from the others', so three
    steps run: the first and last once, a middle one under
    ``trip(n - 2)`` whose backward counts n - 2 times; the gradient sums
    of every input are charged as the loop makes them."""
    ctr = active()
    n = xs[0].shape[1]
    ins = list(xs) + list(consts)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in [carry] + ins)):
        if n == 0:
            return carry, torch.stack([], dim=1)
        with ctr.trip(n):
            carry, y = step(carry, *[x[:, 0] for x in xs], *consts)
            ctr.once(carry)
        return carry, _Repeat.apply((n,), 1, False, y)
    if n < 4:
        ys = []
        for t in range(n):
            carry, y = step(carry, *[x[:, t] for x in xs], *consts)
            ys.append(y)
        return carry, torch.stack(ys, dim=1)
    turns = [_Turns((1, n - 2, 1)) for _ in ins]
    ins = _Enter.apply(ctr, False, turns, *ins)

    def turn(i, t, carry):
        return step(carry, *[_Use.apply(turns[j], i, t if j < len(xs)
                                        else None, x)
                             for j, x in enumerate(ins)])

    carry, y1 = turn(0, 0, carry)
    carry, = _Enter.apply(ctr, True, [None], carry)
    with ctr.trip(n - 2):
        carry, y2 = turn(1, 1, carry)
        carry, y2 = _Exit.apply(ctr, n - 2, carry, y2)
    carry, y3 = turn(2, n - 1, carry)
    return carry, _Repeat.apply((1, n - 2, 1), 1, False, y1, y2, y3)


def trip_map(fn: Callable, x: torch.Tensor, chunk: int,
             consts: Sequence[torch.Tensor] = ()
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``outs = [fn(c, *consts) for c in x.split(chunk)]``, each ``(y,
    aux)`` with ``aux`` a dict of 0-d tensors, then ``(cat(y), {key:
    stack(aux[key])})``, counted as the loop is, with one turn run under
    ``trip(n)`` (``consts``: the tensors every turn reads, their gradient
    sums charged as the loop makes them).  ``x.shape[0]`` must be a
    multiple of ``chunk``."""
    ctr = active()
    n = x.shape[0] // chunk
    xc = _Chunk.apply(x, chunk, n)
    turns = [_Turns((n,)) for _ in consts]
    consts = _Enter.apply(ctr, True, turns, *consts)
    with ctr.trip(n):
        y, aux = fn(xc, *[_Use.apply(tr, 0, None, c)
                          for tr, c in zip(turns, consts)])
        keys = list(aux)
        y, *vals = _Exit.apply(ctr, n, y, *[aux[key] for key in keys])
    return (_Repeat.apply((n,), 0, True, y),
            {key: _Repeat.apply((n,), 0, False, v)
             for key, v in zip(keys, vals)})
