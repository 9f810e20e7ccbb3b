"""A group of torch.distributed ranks on this host, started once and given
work many times: RankPool(n) spawns n processes ("spawn" start method, so a
parent with threads or a loaded runtime is safe), each of which joins the
process group once and then runs the functions the parent sends it.

    with RankPool(4, init_method="file:///tmp/rdv") as pool:
        per_rank = pool.run(fn, *args)   # fn(*args) on every rank

fn must be importable by its module path (pickled by reference) and its
arguments and result picklable. A rank whose function raises ends, and the
parent then stops every rank and raises with that rank's traceback; nothing
is passed over.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback


def _serve(rank, world, backend, init_method, threads, inbox, outbox):
    import torch
    import torch.distributed as dist

    from .distributed import init_distributed

    torch.set_num_threads(threads)
    init_distributed(init_method, world, rank, backend=backend)
    try:
        while True:
            job = inbox.get()
            if job is None:
                return
            fn, args = job
            try:
                outbox.put((rank, True, fn(*args)))
            except Exception:  # noqa: BLE001 — reported to the parent, which fails the run
                outbox.put((rank, False, traceback.format_exc()))
                raise
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` ranks of one process group on this host. backend: "gloo"
    (CPU ranks, or ranks sharing one card) or "nccl" (one rank per card).
    init_method: a rendezvous every rank can reach, e.g. "file:///path" (a
    file that does not exist yet) or "tcp://localhost:PORT". timeout_s
    bounds each collect()."""

    def __init__(self, world: int, *, init_method: str, backend: str = "gloo",
                 timeout_s: float = 600.0):
        import torch

        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        # this process's intra-op threads shared among the ranks, not each
        # rank's pool on every core
        threads = max(1, torch.get_num_threads() // world)
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(target=_serve, name=f"rank{r}", daemon=True,
                                   args=(r, world, backend, init_method, threads,
                                         self._inboxes[r], self._outbox))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def submit(self, fn, *args) -> None:
        """Start fn(*args) on every rank; collect() returns the results."""
        for box in self._inboxes:
            box.put((fn, args))

    def collect(self) -> list:
        """The results of the last submit, by rank. Raises if a rank failed
        or died, after stopping every rank."""
        results = {}
        deadline = time.monotonic() + self.timeout_s
        while len(results) < self.world:
            try:
                rank, ok, value = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in self._procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    self.terminate()
                    raise RuntimeError(f"ranks {dead or 'all'} ended without a result"
                                       + ("" if dead else " (timed out)"))
                continue
            if not ok:  # the other ranks may wait on it in a collective
                self.terminate()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        return [results[r] for r in range(self.world)]

    def run(self, fn, *args) -> list:
        """fn(*args) on every rank; the results by rank."""
        self.submit(fn, *args)
        return self.collect()

    def terminate(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)

    def close(self) -> None:
        """Stop every rank and check that each ended cleanly."""
        for box in self._inboxes:
            box.put(None)
        for p in self._procs:
            p.join(timeout=60)
        bad = [(p.name, p.exitcode) for p in self._procs if p.exitcode != 0]
        if bad:
            self.terminate()
            raise RuntimeError(f"ranks did not end cleanly: {bad}")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.terminate()
