"""The taken-only strategy for the branch seam (stream.pipeline._branch):
a host `if` that does on the CPU what a captured step's IF nodes do on a
card (kernels/graph_cond.py). The taken side alone runs; when the branch is
not taken, the untaken side writes into output buffers that the taken body
would have allocated, poisoned first (NaN, or a sentinel for integers and
flags) so that any output the untaken side fails to write shows. To make
those buffers it runs the taken body on copies of the operands, whose
in-place writes land in the copies. Used by tests/test_torch_cond_nodes.py
in its own process and by tests/test_torch_parallel.py inside each rank
(imports no JAX)."""

import contextlib
import functools

import torch

from tempestsdr_tpu_torch.kernels import graph_cond
from tempestsdr_tpu_torch.stream import pipeline as tpipe

POISON_INT = -7777


def _site(fn) -> str:
    """A branch's name: its taken body's (any:<name> for a gated one)."""
    if isinstance(fn, functools.partial):
        if fn.func is tpipe._both:
            return "any:" + _site(fn.args[1])
        return _site(fn.func)
    return fn.__name__


def _map(fn, tree):
    if isinstance(tree, tuple):
        vals = [_map(fn, t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def _poison(x: torch.Tensor) -> None:
    if x.dtype == torch.bool:
        x.fill_(True)
    elif x.is_floating_point():
        x.fill_(float("nan"))
    else:
        x.fill_(POISON_INT)


class TakenOnly:
    """The branch seam's host-if strategy (see the module docstring); seen
    maps each branch to the sides it took."""

    def __init__(self):
        self.seen: dict[str, set] = {}

    def __call__(self, pred, true_fn, false_fn, operands):
        taken = bool(pred)
        self.seen.setdefault(_site(true_fn), set()).add(taken)
        if taken:
            return graph_cond._owned(true_fn(*operands), operands)
        if false_fn is None:  # the branch writes in place only
            return ()
        scratch = _map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, operands)
        out = graph_cond._owned(true_fn(*scratch), scratch)
        for x in graph_cond._leaves(out):
            _poison(x)
        graph_cond._write_into(out, false_fn(*operands))
        return out


@contextlib.contextmanager
def taken_only(strategy):
    """pipeline._branch is `strategy` inside."""
    select = tpipe._branch
    tpipe._branch = strategy
    try:
        yield
    finally:
        tpipe._branch = select
