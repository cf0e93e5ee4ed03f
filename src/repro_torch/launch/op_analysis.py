"""Per-rank cost of a step from the ops it dispatches (the port's
counterpart of ``repro/launch/hlo_analysis.py``, which walks XLA's
compiled HLO).

:class:`Counter` is a ``TorchDispatchMode``: every aten op a step runs
under it, forward and backward, on real or meta tensors, is counted for
this rank:

* **FLOPs** from ``torch.utils.flop_counter``'s formulas: mm, bmm, addmm,
  baddbmm, convolution and their backwards (and the fused attention ops,
  which the port does not call). Elementwise ops and reductions count 0;
  XLA's count includes them, so a JAX report's FLOPs run a little higher.
* **Bytes**: each op's tensor inputs read plus its outputs written, each
  tensor at the elements it holds (a broadcast dim counted once). View and
  metadata ops cost 0, and so do ``empty`` and its kin. An indexed read
  (``embedding``, ``index_select``, ``index``, ``gather``) costs the rows
  it reads and its indices, not the table; a write into a slice
  (``copy_`` on a view, ``index_put_``, ``index_copy_``) costs the slice,
  read and written; ``fill_`` / ``zero_`` the tensor once. These mirror
  the JAX analyzer's rules for gathers and in-place updates.
* **Collectives**: each c10d op by kind (JAX's names: all-reduce,
  all-gather, reduce-scatter, all-to-all) at the bytes of its result, as
  ``roofline.collective_stats`` counts XLA's; a group of one rank counts
  nothing.
* **Peak live bytes**: each storage an op creates, from its creation until
  it is freed, on top of what existed before the counter started. A
  booked kernel call's storages count from the booking's end, those that
  outlive it only (its outputs): on CPU tensors its plain version's
  temporaries are not the kernel's. Under rematerialization
  (``models/remat.py``) the products a region keeps count until the
  recompute in the backward lets them go, and the recomputed values from
  their creation, as they are held.

A rematerialized step (``models/remat.py``) is counted as it runs: the
ops of the recompute in the backward are dispatched again and counted,
and a booked kernel in a region (K11) books once more; a product that a
dots region kept is answered by ``remat.matmul``'s dispatch mode, entered
after the counter and so above it, without reaching the counter: it is
not counted twice.

A hand kernel's cost is booked by its wrapper inside
``kernels/_build.booking``, which calls :func:`kernel` here while a counter
is open (the module registers its hooks with ``_build`` on import): the
counter adds the booked FLOPs and bytes and ignores the ops dispatched in
the body (the plain version on CPU tensors, the output allocation on
meta ones). A launch through ``kernels/_build.launch`` while a counter is
active and outside a booking raises (:func:`check_launch`), so no kernel
can run uncounted.

    with Counter() as c:
        step(...)
    c.flops, c.bytes, c.collective_bytes, c.peak_bytes
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Iterator

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import _build

aten = torch.ops.aten

# ops that allocate or describe and move nothing
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten._reshape_alias,
         aten.lift_fresh, aten.detach, aten.alias}
# indexed reads (the table is the first argument): the table is not counted
_INDEXED_READ = {aten.embedding, aten.index_select, aten.index, aten.gather}
# writes into a slice of their first argument: the slice moves, not the
# tensor (the written values' position in the arguments)
_SLICE_WRITE = {aten.copy_: 1, aten.index_put_: 2, aten._index_put_impl_: 2,
                aten.index_copy_: 3}
_WRITE_ONLY = {aten.fill_, aten.zero_}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the c10d ops the port's collectives dispatch (``common/runtime.py``) and
# their kinds; the result is each op's first argument
_C10D = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_base_": "all-to-all"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` holds: a dim of stride 0 (a broadcast)
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> Iterator[torch.Tensor]:
    for leaf in tree_flatten(x)[0]:
        if isinstance(leaf, torch.Tensor):
            yield leaf


def _group_size(args) -> int:
    for a in args:
        if (isinstance(a, torch.ScriptObject)
                and "ProcessGroup" in str(a._type())):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


class Counter(TorchDispatchMode):
    """FLOPs, bytes, collective bytes by kind and peak live bytes of the
    ops dispatched under it (see the module's docstring). ``ops`` holds
    per op name ``[calls, flops, bytes]``; ``kernels`` per booked kernel
    ``[calls, flops, bytes]``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self.collective_count = {k: 0 for k in COLLECTIVES}
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.kernels: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.live_bytes = 0
        self.peak_bytes = 0
        self._booking = 0
        self._storages = WeakIdKeyDictionary()
        self._booked = WeakIdKeyDictionary()  # made in the open booking

    def __enter__(self):
        _build.counter_opened(+1)
        try:
            return super().__enter__()
        except BaseException:
            _build.counter_opened(-1)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _build.counter_opened(-1)

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective.values())

    def collective_stats(self) -> Dict[str, int]:
        """``roofline.collective_stats``' keys: ``<kind>_bytes``,
        ``<kind>_count`` and ``total_bytes``."""
        out = {f"{k}_bytes": v for k, v in self.collective.items()}
        out.update({f"{k}_count": v for k, v in
                    self.collective_count.items()})
        out["total_bytes"] = self.collective_bytes
        return out

    def totals(self) -> Dict[str, int]:
        """FLOPs, bytes and :meth:`collective_stats` in one mapping."""
        return {"flops": self.flops, "bytes": self.bytes,
                **self.collective_stats()}

    # -- storages --------------------------------------------------------

    def _freed(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _add(self, st) -> None:
        nbytes = st.nbytes()
        self._storages[st] = nbytes
        weakref.finalize(st, self._freed, nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _track(self, out, inputs) -> None:
        seen = [t.untyped_storage() for t in inputs]
        for t in _tensors(out):
            st = t.untyped_storage()
            if (st in self._storages or st in self._booked
                    or any(st is s for s in seen)):
                continue
            if self._booking:
                self._booked[st] = True
            else:
                self._add(st)

    def _booking_closed(self) -> None:
        """The storages made in the booking that outlive it."""
        for st in list(self._booked.keys()):
            self._add(st)
        self._booked.clear()

    # -- costs -----------------------------------------------------------

    def _op_bytes(self, func, args, out) -> int:
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return 0
        if packet in _INDEXED_READ:
            rest = list(_tensors(args[1:]))
            return (sum(tensor_bytes(t) for t in rest)
                    + sum(tensor_bytes(t) for t in _tensors(out)))
        if packet in _SLICE_WRITE:
            values = args[_SLICE_WRITE[packet]]
            others = [t for i, a in enumerate(args[1:], 1)
                      if i != _SLICE_WRITE[packet] for t in _tensors(a)]
            return (2 * tensor_bytes(values)
                    + sum(tensor_bytes(t) for t in others))
        if packet in _WRITE_ONLY:
            return tensor_bytes(args[0])
        return (sum(tensor_bytes(t) for t in _tensors(args))
                + sum(tensor_bytes(t) for t in _tensors(out)))

    def _collective(self, func, args) -> None:
        kind = _C10D.get(func._opname)
        if kind is None:
            raise NotImplementedError(f"uncounted collective {func}")
        if _group_size(args) == 1:
            return
        self.collective[kind] += sum(tensor_bytes(t)
                                     for t in _tensors(args[0]))
        self.collective_count[kind] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = list(_tensors((args, kwargs)))
        self._track(out, inputs)
        if self._booking:
            return out
        self.n_ops += 1
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        flops = 0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
        nbytes = self._op_bytes(func, args, out)
        self.flops += flops
        self.bytes += nbytes
        rec = self.ops[str(func)]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out


def _active():
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, Counter)]


@contextlib.contextmanager
def kernel(name: str, flops: int, nbytes: int):
    """Book one call of hand kernel ``name`` at ``flops`` and ``nbytes`` on
    every active :class:`Counter`; the ops dispatched in the body are not
    counted. Without a counter, nothing."""
    counters = _active()
    for c in counters:
        c.flops += int(flops)
        c.bytes += int(nbytes)
        rec = c.kernels[name]
        rec[0] += 1
        rec[1] += int(flops)
        rec[2] += int(nbytes)
        c._booking += 1
    try:
        yield
    finally:
        for c in counters:
            c._booking -= 1
            if not c._booking:
                c._booking_closed()


def check_launch(name: str) -> None:
    """Raise if a counter is active and ``name`` is launched outside a
    :func:`kernel` booking (its cost would go uncounted)."""
    for c in _active():
        if not c._booking:
            raise RuntimeError(f"kernel {name} launched under an op counter "
                               "without a booking (_build.booking)")


_build.register_counter(kernel, check_launch)
