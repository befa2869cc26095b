"""The order between the shards of a mesh: each shard's ops on a stream of
its own, on its own card, and events between the shards' streams where one
shard reads, or stores into, what another wrote.

On a TPU the JAX package's shards run one program each, and the halo
kernels (K12, K13) order themselves with an entry barrier: a shard announces
itself to both neighbours before it copies into their memory.  Here every
shard of a CUDA mesh gets a ``torch.cuda.Stream`` on its device (eight
shards on one card get eight streams), and ``ShardOrder`` stands in for the
barrier:

* ``on(r)``: shard r's ops run under its device and its stream (and its
  buffers are allocated there, so the caching allocator ties them to it);
  ``each(fn)`` runs ``fn(r)`` so for every shard;
* ``marks()``: an event on every shard's stream that covers all the work the
  shard has been given so far (recorded only where it was given work since
  its last one);
* ``wait(r, marks, s)``: shard r's stream waits on shard s's mark before it
  reads what s wrote (read after write) or stores into a buffer that s reads
  (write after read);
* ``hold(x, r)``: the caching allocator keeps ``x``'s memory until shard r's
  stream has passed this point, for a buffer allocated on one shard's stream
  that another shard reads or stores into;
* ``fetch(x, r)``: ``x`` on shard r's device, read on r's stream and held
  for it (``x`` itself where the devices agree, else a copy of its rows
  across cards);
* ``scope()``: the outermost call that works on the shards makes each
  shard's stream wait on the caller's current stream of its device at its
  entry, and the caller's current stream of every device wait on every
  shard's last mark at its exit, so the caller sees finished work.

A consumer loop takes its marks before any shard of the loop is given new
work, so a shard waits on its neighbours' previous phase and not on their
current one: the shards of one phase run concurrently.

On the CPU the streams are None and the record and wait calls (``_record``,
``_wait``) are made all the same and do nothing, so a test can swap a
recorder in for them.  The orders are shared: ``order_for(devices)`` gives one
object (and one set of streams) for each tuple of devices, the mesh's and
that of any list of shard tensors on them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.profiling import span


class Mark(NamedTuple):
    """Shard ``shard``'s stream after its first ``ops`` ops: the CUDA event
    recorded there, None on the CPU or before the shard's first op."""

    shard: int
    ops: int
    event: Optional[object]


class ShardOrder:
    """The streams and events of the shards on ``devices`` (one
    ``torch.device`` a shard, in rank order, all of one type)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types ({sorted(str(d) for d in self.devices)}): "
                             "its shards must be on one device (the CPU) or on CUDA cards")
        self.cuda = types == {"cuda"}
        k = len(self.devices)
        if self.cuda:
            _check_cards(self.devices)
            self.streams = tuple(torch.cuda.Stream(device=d) for d in self.devices)
        else:
            self.streams = (None,) * k
        self._ops = [0] * k
        self._marks = [Mark(r, 0, None) for r in range(k)]
        self._waited = {}  # (r, s) -> the mark of s that r last waited on
        self._depth = 0

    # -- the record and wait calls (a test may swap a recorder in) --------------

    def _record(self, s: int) -> Mark:
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record(self.streams[s])
        return Mark(s, self._ops[s], event)

    def _wait(self, r: int, mark: Mark) -> None:
        if self.cuda and mark.event is not None:
            self.streams[r].wait_event(mark.event)

    # -- the order -------------------------------------------------------------

    @contextlib.contextmanager
    def on(self, r: int, count: bool = True):
        """Shard ``r``'s op: its device and its stream are current.  The op
        counts once it has been issued, so a mark taken inside it (by a
        nested call) leaves it to the next mark.  ``count=False`` for what
        gives the stream no work (an allocation, which the caching allocator
        ties to the current stream)."""
        try:
            if not self.cuda:
                yield
            else:
                with torch.cuda.device(self.devices[r]), torch.cuda.stream(self.streams[r]):
                    yield
        finally:
            if count:
                self._ops[r] += 1

    def each(self, fn) -> list:
        """``fn(r)`` for each shard ``r``, on the shard's stream."""
        out = []
        for r in range(len(self.devices)):
            with self.on(r):
                out.append(fn(r))
        return out

    def marks(self) -> Tuple[Mark, ...]:
        """A mark of every shard covering all its ops so far."""
        with span("order.sync"):
            for s, mark in enumerate(self._marks):
                if mark.ops != self._ops[s]:
                    self._marks[s] = self._record(s)
            return tuple(self._marks)

    def wait(self, r: int, marks: Sequence[Mark], *shards: int) -> None:
        """Shard ``r``'s stream waits on the marks of ``shards`` (its own,
        ranks past the mesh's ends, and a mark it already waited on are
        skipped)."""
        with span("order.sync"):
            for s in shards:
                if s != r and 0 <= s < len(marks) and self._waited.get((r, s)) is not marks[s]:
                    self._wait(r, marks[s])
                    self._waited[(r, s)] = marks[s]

    def hold(self, x: Optional[torch.Tensor], r: int) -> None:
        """Keep ``x``'s memory from reuse until shard ``r``'s stream has passed
        this point (``Tensor.record_stream``)."""
        if x is not None and self.cuda:
            with span("order.sync"):
                x.record_stream(self.streams[r])

    def fetch(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """``x`` on shard ``r``'s device, for ``r``'s op (inside ``on(r)``, after
        its wait on the shard that wrote ``x``), held for ``r``'s stream: ``x``
        itself where the devices agree, else a contiguous copy made on
        ``r``'s stream (its rows: every index of its first axis holds
        contiguous elements)."""
        with span("order.sync"):
            return self._fetch(x, r)

    def _fetch(self, x: torch.Tensor, r: int) -> torch.Tensor:
        dev = self.devices[r]
        self.hold(x, r)
        if x.device == dev:
            return x
        from ..kernels import _build

        out = torch.empty(x.shape, dtype=x.dtype, device=dev)
        if x.is_contiguous() or x.dim() < 2:
            if not x.is_contiguous():
                raise ValueError(f"a copy across cards moves rows of contiguous elements, "
                                 f"got strides {x.stride()}")
            rows, pitch = 1, x.numel() * x.element_size()
        else:
            if not x[0].is_contiguous():
                raise ValueError(f"a copy across cards moves rows of contiguous elements, "
                                 f"got strides {x.stride()} for shape {tuple(x.shape)}")
            rows, pitch = x.shape[0], x.stride(0) * x.element_size()
        width = x.numel() // max(rows, 1) * x.element_size()
        lib = _build.load_library()
        err = lib.fs_copy_rows(out.data_ptr(), width, x.data_ptr(), pitch, width, rows,
                               self.streams[r].cuda_stream)
        _build.check(lib, err, f"copy onto {dev}")
        return out

    @contextlib.contextmanager
    def scope(self):
        """Work on the shards between the caller's streams: the outermost scope
        orders the shards' streams after the caller's current streams at its
        entry, and the caller's after the shards' at its exit."""
        if self._depth:
            self._depth += 1
            try:
                yield self
            finally:
                self._depth -= 1
            return
        self._depth = 1
        if self.cuda:
            with span("order.sync"):
                for d, stream in zip(self.devices, self.streams):
                    stream.wait_stream(torch.cuda.current_stream(d))
        try:
            yield self
        finally:
            self._depth = 0
            with span("order.sync"):
                marks = self.marks()
                if self.cuda:
                    for d in dict.fromkeys(self.devices):
                        caller = torch.cuda.current_stream(d)
                        for mark in marks:
                            if mark.event is not None:
                                caller.wait_event(mark.event)


_orders: Dict[Tuple[torch.device, ...], ShardOrder] = {}


def order_for(devices: Sequence) -> ShardOrder:
    """The ``ShardOrder`` of shards on ``devices`` (made once for each tuple of
    devices)."""
    key = tuple(torch.device(d) for d in devices)
    order = _orders.get(key)
    if order is None:
        order = _orders[key] = ShardOrder(key)
    return order


def order_of(xs: Sequence[torch.Tensor]) -> ShardOrder:
    """The order of shards that hold the tensors ``xs`` (one a shard)."""
    return order_for([x.device for x in xs])


# Devices whose current device the library was checked to see, and pairs of
# cards with peer access on.
_checked: set = set()
_peers: set = set()


def _check_cards(devices: Sequence[torch.device]) -> None:
    """Once a device: the kernel library's runtime sees the device PyTorch
    makes current.  Once a pair of distinct neighbouring cards: peer access
    both ways, or an error where the pair cannot reach each other."""
    from ..kernels import _build

    lib = None
    for d in dict.fromkeys(devices):
        if d in _checked:
            continue
        lib = lib or _build.load_library()
        with torch.cuda.device(d):
            seen = lib.fs_current_device()
        if seen != d.index:
            raise RuntimeError(f"the kernel library sees device {seen} where PyTorch made "
                               f"{d} current")
        _checked.add(d)
    for a, b in zip(devices, devices[1:]):
        if a == b or (a, b) in _peers:
            continue
        for x, y in ((a, b), (b, a)):
            if not torch.cuda.can_device_access_peer(x, y):
                raise RuntimeError(f"{x} cannot access {y}'s memory (no peer access): "
                                   "neighbouring shards on distinct cards need it, and there "
                                   "is no copying fallback")
        lib = lib or _build.load_library()
        for x, y in ((a, b), (b, a)):
            _build.check(lib, lib.fs_enable_peer(x.index, y.index),
                         f"peer access from {x} to {y}")
        _peers.update({(a, b), (b, a)})
