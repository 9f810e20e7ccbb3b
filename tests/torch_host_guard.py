"""A guard that makes every host read raise, for the port's device-program
tests (tests/test_torch_graph_runner.py, test_torch_channels.py,
test_torch_parallel.py): what a CUDA-graph capture needs, checked on the
CPU, where a read costs nothing and so would pass unseen. Also a count of
the aten operations a block dispatches."""

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HOST_READS = ("item", "tolist", "__bool__", "__int__", "__index__", "__float__")
# aten ops that read a tensor on the host (on a card: a synchronizing copy),
# reached from C++ as well, e.g. indexing by a 0-d tensor; and lift_fresh, a
# tensor made from host data (torch.tensor, or a Python value written into a
# tensor: on a card a host -> device copy, which a graph cannot capture)
HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "equal",
            "allclose", "unique_dim", "_unique2", "unique_consecutive", "lift_fresh",
            "lift_fresh_copy"}
MASKED = {"index", "index_put", "index_put_", "_index_put_impl_"}  # a bool index is a nonzero


class _NoHostOps(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_OPS:
            raise AssertionError(f"host read: aten.{name}")
        if name in MASKED and any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                                  for i in args[1]):
            raise AssertionError(f"host read: aten.{name} with a mask")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_reads():
    """Every Tensor method that reads a value to the host raises, and so does
    every aten op that does, for the enclosed code (the collectives of
    torch.distributed pass: they read nothing to the host on the CPU)."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    for name in HOST_READS:
        def refuse(self, *a, _name=name, **k):
            raise AssertionError(f"host read: Tensor.{_name}")

        setattr(torch.Tensor, name, refuse)
    try:
        with _NoHostOps():
            yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


class CountOps(TorchDispatchMode):
    """Counts the aten operations dispatched in the enclosed code (views
    and metadata included): on a card, roughly the launches of a block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))
