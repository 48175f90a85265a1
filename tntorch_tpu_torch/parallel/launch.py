"""Several ranks from one command: the port's counterpart of the JAX
package's virtual devices (``--xla_force_host_platform_device_count``).

JAX is single-controller: one process sees every device. PyTorch runs one
process per rank, each running the same program (SPMD). `run` spawns
``world`` processes, each of which joins one process group (a
``FileStore`` rendezvous in a temporary directory), runs ``fn(*args)`` and
sends its result back; `Group` keeps the ranks for several calls. Programs
started by ``torchrun`` need neither: every function of `parallel` needs
only an initialized default process group.

The backend and the device are the caller's and are never switched:
``backend="nccl"`` without a card raises here, and NCCL's own refusal of
two ranks on one card surfaces from the ranks. If a rank raises, dies or
outlives the call's ``timeout``, every rank is killed and the call raises
with that rank's traceback: nothing hangs and nothing is swallowed.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from tntorch_tpu_torch.utils import default_device

# How often a waiting caller looks for ranks that died without a word
_POLL = 0.2


class RankError(RuntimeError):
    """A rank of a `Group` raised or died; the message holds its traceback."""


def _host(x):
    """``x`` with every tensor in it moved to the CPU (a DTensor: its local
    shard), so that the result crosses to the caller without CUDA IPC."""
    if isinstance(x, torch.Tensor):
        local = x.to_local() if hasattr(x, "to_local") else x
        return local.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _serve(rank, world, backend, device, store, timeout, tasks, results):
    """A rank's process: join the group, then run each task sent, until
    None comes."""
    faulthandler.enable()  # a rank that crashes prints where
    try:
        card = None
        if device == "cuda":
            card = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(card)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout),
                                device_id=card if backend == "nccl" else None)
    except Exception:  # reported to the caller, which raises it
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ready", None))
    try:
        while (task := tasks.get()) is not None:
            fn, args = task
            try:
                # pickled here, so that an unpicklable result is this rank's error
                reply = ("ok", pickle.dumps(_host(fn(*args))))
            except Exception:  # reported to the caller, which raises it
                reply = ("error", traceback.format_exc())
            results.put((rank, *reply))
    finally:
        dist.destroy_process_group()


class Group:
    """``world`` ranks, spawned once, each in one process group of backend
    ``backend`` on ``device`` ("cpu", or "cuda": rank r on card r modulo
    the card count; default: the package's, the card), for several
    `run` calls::

        with Group(4, "gloo", device="cpu") as g:
            outs = g.run(fn, x)      # fn(x) on every rank; their results

    ``fn`` is a function that the ranks can import (defined at a module's
    top level) and ``args`` are picklable. Each rank's result comes back
    with its tensors on the CPU (a DTensor's local shard). ``timeout``
    (seconds) bounds the start and each call. A failing call closes the
    group."""

    def __init__(self, world: int, backend: str, device=None, timeout: float = 600.0):
        device = torch.device(device or default_device()).type
        if world < 1:
            raise ValueError(f"world must be at least 1, got {world}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for and there is no CUDA card: "
                               "pass device='cpu' to run the ranks on the CPU")
        if backend == "nccl" and device != "cuda":
            raise RuntimeError("backend 'nccl' needs the ranks on CUDA cards; on the CPU, "
                               "pass backend='gloo'")
        self.world, self.backend, self.device, self.timeout = world, backend, device, timeout
        self._procs = None

    def __enter__(self):
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        store = os.path.join(self._dir.name, "store")
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(rank, self.world, self.backend, self.device, store,
                                         self.timeout, self._tasks[rank], self._results))
                       for rank in range(self.world)]
        for p in self._procs:
            p.start()
        try:
            self._gather("ready", self.timeout, "start")
        except BaseException:
            self._kill()
            raise
        return self

    def __exit__(self, *exc):
        self.close()

    def run(self, fn, *args, timeout: float = None) -> list:
        """``fn(*args)`` on every rank; the ranks' results, in rank order."""
        if self._procs is None:
            raise RuntimeError("the group is closed")
        for q in self._tasks:
            q.put((fn, args))
        try:
            replies = self._gather("ok", self.timeout if timeout is None else timeout,
                                   getattr(fn, "__name__", "the call"))
        except BaseException:
            self._kill()
            raise
        return [pickle.loads(replies[r]) for r in range(self.world)]

    def _gather(self, want, timeout, what):
        """One reply of kind ``want`` from every rank within ``timeout``
        seconds; raises `RankError` on a rank's error or death and
        ``TimeoutError`` past the limit."""
        replies, deadline = {}, time.monotonic() + timeout
        while len(replies) < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(self.world)) - set(replies))
                raise TimeoutError(f"{what}: ranks {late} did not answer within {timeout} s")
            try:
                rank, kind, payload = self._results.get(timeout=min(_POLL, left))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in replies and p.exitcode is not None]
                if dead:
                    raise RankError(f"{what}: rank {dead[0]} exited with code "
                                    f"{self._procs[dead[0]].exitcode} without a reply")
                continue
            if kind == "error":
                raise RankError(f"{what}: rank {rank} raised:\n{payload}")
            assert kind == want, kind
            replies[rank] = payload
        return replies

    def close(self):
        """Stop the ranks (each leaves its process group) and wait for
        them; kill those that do not stop within the timeout."""
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + self.timeout
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        self._kill()

    def _kill(self):
        for p in self._procs or ():
            if p.is_alive():
                p.kill()
            p.join()
        for q in (self._results, *self._tasks):
            q.close()
            q.cancel_join_thread()  # the ranks are gone: drop what was never read
        with contextlib.suppress(OSError):
            self._dir.cleanup()
        self._procs = None


# The collectives that `counting_collectives` records: those of
# torch.distributed, and the functional ones that DTensor issues
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "scatter", "gather", "send", "recv")
_FUNCTIONAL = ("all_reduce", "all_gather_tensor", "all_gather_tensor_autograd",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast", "permute_tensor")


def _elements(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    return sum(t.numel() for t in x) if isinstance(x, (list, tuple)) else 0


@contextlib.contextmanager
def counting_collectives():
    """Within the block, each collective this process issues through
    ``torch.distributed`` (or its functional collectives, which DTensor's
    redistributions use) is appended to the yielded list as (name,
    elements of its first argument: the reduced, broadcast or gathered
    tensor, or the list it gathers into); a functional one's name starts
    with "functional"."""
    import torch.distributed._functional_collectives as funcol

    calls, saved = [], []

    def spy(module, name, label):
        real = getattr(module, name)

        def counted(*args, **kwargs):
            first = args[0] if args else next(iter(kwargs.values()), None)
            calls.append((label, _elements(first)))
            return real(*args, **kwargs)

        saved.append((module, name, real))
        setattr(module, name, counted)

    for name in _COLLECTIVES:
        if hasattr(dist, name):
            spy(dist, name, name)
    for name in _FUNCTIONAL:
        if hasattr(funcol, name):
            spy(funcol, name, f"functional {name}")
    try:
        yield calls
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def run(fn, world: int, backend: str, device=None, timeout: float = 600.0, args=()) -> list:
    """``fn(*args)`` on ``world`` fresh ranks of one process group (see
    `Group`); the ranks' results, in rank order."""
    with Group(world, backend, device, timeout) as group:
        return group.run(fn, *args)
