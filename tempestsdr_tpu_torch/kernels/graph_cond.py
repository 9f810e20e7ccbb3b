"""CUDA-graph IF nodes for the step's branches (csrc/graph_cond.cu).

The JAX step branches with lax.cond and XLA runs only the taken branch. The
port captures its step into a CUDA graph (stream/graph.py); while it does,
stream.pipeline._cond hands each branch to branch_nodes' Branches.if_else,
which captures it as a pair of IF nodes: one set kernel reads the 0-d bool
predicate and sets both nodes' conditions, the taken body is captured into
the first node, and the other body into the second, where it writes into
the taken body's outputs (code after the nodes reads fixed addresses). A
branch without an untaken side (false_fn None: the taken body writes in
place and returns nothing) is one IF node. So a replay runs only the taken
body.

A body is captured by a stream of its own (cudaStreamBeginCaptureToGraph;
made with the CUDA runtime, since one of torch's pooled streams may be the
very stream the parent graph is captured on) and allocates from a
caching-allocator pool of its own (torch.cuda.MemPool), which lives as
long as the graph. A body may run kernels, copies and fills; no host read,
event or stream switch (a conditional body may hold none).

The nodes are made only inside branch_nodes(device); a branch captured
outside it raises, as does a torch without MemPool, a failed build or a
failed CUDA call: nothing falls back to capturing both bodies.

census() counts a captured graph's parent nodes, IF nodes and body nodes
(cuGraphGetNodes does not enter a conditional node's body graphs, so the
bodies are the ones Branches recorded as it made them).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref

import torch

CONDITIONAL_NODE = 13  # CUgraphNodeType CU_GRAPH_NODE_TYPE_CONDITIONAL

_LIB = None
_ACTIVE = threading.local()  # .branches: the Branches of this thread's capture


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("graph_cond")
        lib.tsdr_cond_handles.restype = ctypes.c_int
        lib.tsdr_cond_handles.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_ulonglong)]
        lib.tsdr_cond_begin.restype = ctypes.c_int
        lib.tsdr_cond_begin.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_void_p)]
        lib.tsdr_cond_end.restype = ctypes.c_int
        lib.tsdr_cond_end.argtypes = [ctypes.c_void_p]
        lib.tsdr_stream_create.restype = ctypes.c_int
        lib.tsdr_stream_create.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        lib.tsdr_stream_destroy.restype = ctypes.c_int
        lib.tsdr_stream_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, tuple):
        vals = [_rebuild(t, it) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return next(it)


def _owned(out, operands):
    """The taken body's outputs, each in storage of its own: an output that
    shares storage with an operand or with an earlier output is cloned, so
    the other body can write every output without touching an operand or
    another output."""
    seen = {x.untyped_storage().data_ptr() for x in _leaves(operands)
            if isinstance(x, torch.Tensor)}
    owned = []
    for x in _leaves(out):
        if not isinstance(x, torch.Tensor):
            raise TypeError("a taken body returns tensors only")
        if x.untyped_storage().data_ptr() in seen:
            x = x.clone()
        seen.add(x.untyped_storage().data_ptr())
        owned.append(x)
    return _rebuild(out, iter(owned))


def _write_into(out, values) -> None:
    for dst, src in zip(_leaves(out), _leaves(values), strict=True):
        if isinstance(src, torch.Tensor):
            dst.copy_(src)
        else:
            dst.fill_(src)


class Branches:
    """One capture's branch nodes: the stream that captures their bodies,
    the memory pool the bodies allocate from (keep it as long as the graph),
    and the body graphs it made (`bodies`, each a cudaGraph_t, for census)."""

    def __init__(self, device):
        if not hasattr(torch.cuda, "MemPool") or not hasattr(torch.cuda, "use_mem_pool"):
            raise RuntimeError(f"torch {torch.__version__} has no torch.cuda.MemPool: "
                               "the branch nodes' bodies cannot get a memory pool")
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.pool = torch.cuda.MemPool()
        lib = _lib()  # built and loaded before the capture starts
        handle = ctypes.c_void_p()
        _check(lib.tsdr_stream_create(self.device.index, ctypes.byref(handle)),
               "making the bodies' stream")
        weakref.finalize(self, lib.tsdr_stream_destroy, handle.value)
        self.stream = torch.cuda.ExternalStream(handle.value, device=self.device)
        self.bodies: list[int] = []

    def if_else(self, pred: torch.Tensor, true_fn, false_fn, operands: tuple):
        """Capture `true_fn(*operands)` under an IF node on pred and
        `false_fn(*operands)` under one on not pred, the latter writing its
        values (tensors or numbers) into the former's outputs; returns those
        outputs. With false_fn None, true_fn returns no tensor and the
        branch is one IF node. pred is a 0-d tensor on the capturing
        stream's device."""
        if pred.numel() != 1:
            raise ValueError(f"a branch node takes a 0-d predicate, got {tuple(pred.shape)}")
        lib = _lib()
        main = torch.cuda.current_stream(self.device)
        p = pred if pred.dtype == torch.bool else pred != 0
        handles = (ctypes.c_ulonglong * 2)()
        _check(lib.tsdr_cond_handles(main.cuda_stream, p.data_ptr(), int(false_fn is not None),
                                     handles), "making the branch's conditional handles")
        out = self._body(main, handles[0], lambda: _owned(true_fn(*operands), operands))
        if false_fn is not None:
            self._body(main, handles[1], lambda: _write_into(out, false_fn(*operands)))
        elif any(isinstance(x, torch.Tensor) for x in _leaves(out)):
            raise ValueError("a branch without an untaken side returns no tensor")
        return out

    def _body(self, main, handle, fn):
        lib = _lib()
        body = ctypes.c_void_p()
        _check(lib.tsdr_cond_begin(main.cuda_stream, handle, self.stream.cuda_stream,
                                   ctypes.byref(body)), "adding an IF node")
        try:
            with torch.cuda.stream(self.stream), torch.cuda.use_mem_pool(self.pool, self.device):
                res = fn()
        except BaseException:
            lib.tsdr_cond_end(self.stream.cuda_stream)
            raise
        _check(lib.tsdr_cond_end(self.stream.cuda_stream), "capturing an IF node's body")
        self.bodies.append(body.value)
        return res


@contextlib.contextmanager
def branch_nodes(device):
    """Within: every branch the step captures on this thread is made of IF
    nodes (Branches.if_else). Yields the Branches."""
    branches = Branches(device)
    prev = getattr(_ACTIVE, "branches", None)
    _ACTIVE.branches = branches
    try:
        yield branches
    finally:
        _ACTIVE.branches = prev


def capturing(pred: torch.Tensor) -> bool:
    """Whether pred's branch is being captured: a CUDA tensor while the
    current stream captures."""
    return pred.is_cuda and torch.cuda.is_current_stream_capturing()


def if_else(pred, true_fn, false_fn, operands: tuple):
    """The branch as IF nodes of the capture under way; raises outside
    branch_nodes(), so a captured step never runs both bodies."""
    branches = getattr(_ACTIVE, "branches", None)
    if branches is None:
        raise RuntimeError("a branch of the step was captured outside branch_nodes(): "
                           "capture the step through stream.graph's runners")
    return branches.if_else(pred, true_fn, false_fn, operands)


class _Driver:
    """cuGraphGetNodes and cuGraphNodeGetType through libcuda."""

    def __init__(self):
        self.cu = ctypes.CDLL("libcuda.so.1")

    def nodes(self, graph: int) -> list:
        count = ctypes.c_size_t(0)
        _check(self.cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(count)),
               "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * count.value)()
        _check(self.cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes, ctypes.byref(count)),
               "cuGraphGetNodes")
        return list(nodes)

    def node_type(self, node) -> int:
        t = ctypes.c_int(-1)
        _check(self.cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
               "cuGraphNodeGetType")
        return t.value


def census(graph: int, bodies, driver=None) -> dict:
    """Nodes of a captured graph (a cudaGraph_t) whose branch bodies are
    `bodies` (Branches.bodies): parent_nodes (the graph's own, IF nodes
    included), if_nodes (those of them that are conditional), body_nodes
    (in every body, an IF node nested in a body counted there) and
    all_nodes, their sum."""
    driver = driver or _Driver()
    parent = driver.nodes(graph)
    if_nodes = sum(driver.node_type(n) == CONDITIONAL_NODE for n in parent)
    body_nodes = sum(len(driver.nodes(b)) for b in bodies)
    return dict(parent_nodes=len(parent), if_nodes=if_nodes, body_nodes=body_nodes,
                all_nodes=len(parent) + body_nodes)
