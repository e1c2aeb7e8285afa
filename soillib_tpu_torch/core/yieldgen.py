"""Generator utilities: the `soil::yield` equivalent, Python-native
(counterpart of `soillib_tpu/core/yieldgen.py`).

The reference ships a C++20 coroutine generator, `soil::yield_t`
(util/yield.hpp:24-247): a strict-typed, move-only, single-pass value
generator with cached peeking (`operator bool` / `operator()`,
yield.hpp:160-189), exception propagation out of the coroutine body
(yield.hpp:119-121, 184-186), an iterator adapter (yield.hpp:191-241),
and a `make_yield(...)` helper that packs multiple yielded values into
a tuple (yield.hpp:55-64). Python generators already are coroutine value
generators, so `yield_t` is a thin wrapper that adds exactly the semantics
`yield_t` has and bare generators lack: peek-without-consume, optional
strict typing, and single-pass single-owner handles.

Three behaviours differ from the JAX package's on purpose (its faults):
- `move()` takes a peeked value with it; the moved-from handle is empty
  and raises on any use (the JAX package's kept the peeked value and
  could hand one item out twice);
- a value of the wrong type is not consumed silently: the handle keeps
  the TypeError and raises it again at every later peek or take, and
  `value_type` may be a tuple of types;
- `prefetch(depth=d)` has `d` transfers in flight beyond the item it
  hands out (the JAX package's had d - 1).

`prefetch` is the reason for this layer on a GPU: a generator of host
arrays (e.g. `soil.util.iter_tiff` tiles) becomes a generator of tensors
on the card, the next `depth` host-to-device copies already running on a
side CUDA stream from pinned host memory while the caller computes on
the current item.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from soillib_tpu_torch.core.device import _device

__all__ = ["yield_t", "make_yield", "prefetch"]

_SENTINEL = object()


def make_yield(*args):
    """Pack yielded values like the reference's `make_yield` helper
    (util/yield.hpp:55-64): one argument passes through unchanged,
    several pack into a tuple (for ``for a, b in y:`` unpacking)."""
    if len(args) == 1:
        return args[0]
    return tuple(args)


def _type_name(value_type) -> str:
    if isinstance(value_type, tuple):
        return " or ".join(_type_name(t) for t in value_type)
    return getattr(value_type, "__name__", repr(value_type))


class yield_t:
    """Single-pass strict generator handle (util/yield.hpp:24-247).

    Wraps any iterable/generator. Usage mirrors the reference:

        y = soil.yield_t(gen(), value_type=tuple)
        while y:            # operator bool: peek, cache
            a, b = y()      # operator(): take cached value
        # or, equivalently, single-pass iteration:
        for a, b in soil.yield_t(gen()):
            ...

    Exceptions raised inside the generator propagate to the caller at
    the peek/take site (retrieve_value, yield.hpp:181-187).
    """

    __slots__ = ("_it", "_value", "_has_value", "_done", "_consumed",
                 "_error", "value_type")

    def __init__(self, iterable: Iterable, value_type=None):
        self._it: Optional[Iterator] = iter(iterable)
        self._value: Any = _SENTINEL
        self._has_value = False
        self._done = False
        self._consumed = False
        self._error: Optional[TypeError] = None
        self.value_type = value_type

    # -- handle state -------------------------------------------------
    def _require_live(self):
        if self._it is None:
            raise RuntimeError(
                "yield_t handle was moved or destroyed; a coroutine "
                "handle is single-owner (util/yield.hpp:141-158)")
        if self._consumed:
            raise RuntimeError(
                "yield_t is single-pass and already ran to completion; "
                "construct a new one to iterate again")

    def _retrieve(self):
        """Advance the underlying generator once and cache the value
        (retrieve_value, yield.hpp:178-188)."""
        if self._error is not None:
            raise self._error
        if self._has_value or self._done:
            return
        self._require_live()
        try:
            v = next(self._it)           # actual coroutine call here
        except StopIteration:
            self._done = True
            self._consumed = True
            return
        if self.value_type is not None and not isinstance(v,
                                                          self.value_type):
            self._error = TypeError(
                f"yield_t is strict-typed: expected "
                f"{_type_name(self.value_type)}, generator yielded "
                f"{type(v).__name__}")
            raise self._error
        self._value = v
        self._has_value = True

    # -- operator bool / operator() ----------------------------------
    def __bool__(self) -> bool:
        self._retrieve()
        return not self._done

    def __call__(self):
        self._retrieve()
        if self._done:
            raise StopIteration("yield_t coroutine has completed")
        self._has_value = False
        v, self._value = self._value, _SENTINEL
        return v

    # -- iterator adapter (yield.hpp:191-241) ------------------------
    def __iter__(self):
        # Querying a finished handle is legal (operator bool just reads
        # h_.done()); starting a fresh iteration over a consumed handle
        # raises instead of silently yielding nothing.
        if self._consumed:
            raise RuntimeError(
                "yield_t is single-pass and already ran to completion; "
                "construct a new one to iterate again")
        while self:
            yield self()

    # -- move semantics (yield.hpp:141-158) --------------------------
    def move(self) -> "yield_t":
        """Transfer ownership, a peeked value included, to a new handle;
        this one becomes empty, like the reference's move constructor
        (yield.hpp:143), and raises on any later use."""
        self._require_live()
        out = yield_t.__new__(yield_t)
        out._it, self._it = self._it, None
        out._value, self._value = self._value, _SENTINEL
        out._has_value, self._has_value = self._has_value, False
        out._done, self._done = self._done, False
        out._consumed, out._error = self._consumed, self._error
        self._error = None
        out.value_type = self.value_type
        return out

    def close(self):
        """Destroy the handle early (~yield_t, yield.hpp:145-148)."""
        it, self._it = self._it, None
        self._value, self._has_value, self._done = _SENTINEL, False, False
        if it is not None and hasattr(it, "close"):
            it.close()


def _map_leaves(item, fn):
    """fn over the leaves of nested tuples, lists and dicts."""
    if isinstance(item, tuple):
        return tuple(_map_leaves(v, fn) for v in item)
    if isinstance(item, list):
        return [_map_leaves(v, fn) for v in item]
    if isinstance(item, dict):
        return {k: _map_leaves(v, fn) for k, v in item.items()}
    return fn(item)


def _host_tensor(x):
    """A numpy array as a CPU tensor (shared memory where numpy allows
    writes); anything else unchanged."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x if x.flags.writeable else x.copy())
    return x


class _SideStream:
    """Host-to-device copies on a side CUDA stream: each tensor leaf is
    staged in pinned host memory and copied with non_blocking=True, and
    an event marks the item's copies. `take` makes the consumer's stream
    wait on that event and marks each tensor used there
    (`record_stream`), so the allocator cannot hand its memory out again
    before the consumer's work on it is done."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def _copy(self, x):
        x = _host_tensor(x)
        if isinstance(x, torch.Tensor) and x.device.type == "cpu":
            if not x.is_pinned():
                x = x.pin_memory()
            return x.to(self.device, non_blocking=True)
        return x

    def put(self, item):
        with torch.cuda.stream(self.stream):
            out = _map_leaves(item, self._copy)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, sent):
        out, done = sent
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)

        def mark(x):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                x.record_stream(consumer)
            return x

        return _map_leaves(out, mark)


def prefetch(iterable: Iterable, depth: int = 2,
             put: Optional[Callable[[Any], Any]] = None,
             device="cuda") -> Iterator:
    """Device-prefetching iterator: yield items with the next `depth`
    host-to-device transfers already started.

    Tensor and numpy leaves of nested structures (tuples of arrays,
    (name, array) pairs, dicts) are moved to `device`; other leaves pass
    through. On the card the copies run on a side stream from pinned
    memory (see `_SideStream`), so they overlap the caller's work on the
    current item; with device="cpu" items pass through, numpy leaves
    wrapped as CPU tensors. `put` overrides the transfer (its results are
    handed out as they are).
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    take = None
    if put is None:
        dev = _device(device)
        if dev.type == "cuda":
            side = _SideStream(dev)
            put, take = side.put, side.take
        else:
            def put(item):
                return _map_leaves(item, _host_tensor)

    it = iter(iterable)
    window: collections.deque = collections.deque()
    try:
        for item in it:
            window.append(put(item))
            if len(window) > depth:
                sent = window.popleft()
                yield take(sent) if take else sent
        while window:
            sent = window.popleft()
            yield take(sent) if take else sent
    finally:
        if hasattr(it, "close"):
            it.close()
