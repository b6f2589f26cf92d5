"""Run one function on N ranks of a fresh process group, on this machine.

    results = run_ranks(fn, world=2, args=(...), device="cpu")

Each rank is a child process (the `spawn` start method, which CUDA needs)
that joins a group at tcp://localhost:<a free port> through
`multihost.maybe_initialize_distributed`, calls fn(rank, *args), leaves the
group and hands back fn's (picklable) result; `run_ranks` returns them in
rank order. Every init and collective of the group waits at most `timeout`
seconds, and the parent waits at most `join_timeout` seconds for all
children: on a timeout or a failed child it kills the rest and raises, so a
rank that misses a collective fails the call instead of hanging it.

`fn` must be importable by a child: a module-level function. It is loaded
from its module's file, so a function in a test file runs without that file
being on the child's path; that module's top level is run in every child,
so it should import nothing heavy. `device` 'cuda' gives rank r the card
r mod the cards it sees (`multihost._local_card` with LOCAL_RANK = r);
children load the CUDA libraries the parent built (`ops/_build.py` finds
them by the hash of the sources), and build nothing.
"""
from __future__ import annotations

import importlib.util
import inspect
import multiprocessing as mp
import os
import queue
import socket
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from st_dadk_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _load(module: str, path: str, name: str) -> Callable:
    mod = sys.modules.get(module)
    if mod is None or getattr(mod, "__file__", None) != path:
        spec = importlib.util.spec_from_file_location(
            f"_rank_fn_{abs(hash(path))}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _child(rank: int, world: int, port: int, backend: Optional[str],
           device: str, timeout: float, init: str, target, args,
           out) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if init == "torchrun":
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          WORLD_SIZE=str(world), RANK=str(rank))
    elif init == "jax":
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                          JAX_NUM_PROCESSES=str(world),
                          JAX_PROCESS_ID=str(rank))
    try:
        import torch
        torch.set_num_threads(1)
        from st_dadk_tpu_torch.parallel import multihost
        explicit = (f"localhost:{port}", world, rank) \
            if init == "explicit" else ()
        if not multihost.maybe_initialize_distributed(
                *explicit, backend=backend, device=device, timeout=timeout):
            raise RuntimeError(f"no process group joined ({init!r})")
        try:
            result = _load(*target)(rank, *args)
            multihost.sync_processes("run_ranks_end")
        finally:
            multihost.shutdown()
        out.put((rank, True, result))
    except BaseException:        # the parent raises with this traceback
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
              backend: Optional[str] = None, device: str = "cpu",
              timeout: float = DEFAULT_TIMEOUT,
              join_timeout: float = 240.0, init: str = "explicit"
              ) -> List[Any]:
    """fn(rank, *args) on `world` ranks of one new group; the results in
    rank order (module docstring). `init` is how a child finds the group:
    'explicit' arguments, torchrun's environment ('torchrun') or JAX's
    ('jax'), each through `maybe_initialize_distributed`."""
    target = (fn.__module__, os.path.abspath(inspect.getfile(fn)),
              fn.__qualname__)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(r, world, port, backend,
                                              device, timeout, init, target,
                                              tuple(args), out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + join_timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(results)} of "
                                   f"{world} ranks gave no result within "
                                   f"{join_timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} died "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
