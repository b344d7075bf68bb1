"""Gloo ranks for the port's mesh tests (tests/test_torch_mesh.py and the
other multi-process files).

`run_ranks` spawns one process a rank, joins them into a gloo process
group through a ``file://`` store in the test's temporary directory (no
ports, so xdist workers cannot clash), runs one function of a module that
imports neither JAX nor the JAX package (tests/torch_mesh_cases.py) on
every rank, and returns each rank's result.  A hard timeout kills the
ranks and fails the test, so a rank that waits on a collective forever
cannot run the suite into its limit.  The JAX references are computed in
the pytest process, never in a rank.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

import multiprocessing

TIMEOUT = 120.0
FORBIDDEN = ("jax", "differential_equations_resnet_tpu")


def _rank_main(rank, world_size, store, call, out, init):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        if init:
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world_size)
        else:
            args = (rank, world_size) + tuple(args)
        result = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        loaded = [m for m in FORBIDDEN if m in sys.modules]
        payload = ({"error": f"rank {rank} imported {loaded}"} if loaded
                   else {"result": result})
    except BaseException:  # noqa: BLE001 - reported by the parent
        payload = {"error": f"rank {rank}:\n{traceback.format_exc()}"}
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def run_ranks(fn, world_size: int, directory, *args, timeout: float = TIMEOUT,
              init: bool = True):
    """``fn(*args)`` on ``world_size`` spawned gloo ranks; the list of their
    results, by rank.  With ``init=False`` the ranks join no group here and
    call ``fn(rank, world_size, *args)``, which joins one itself.  Raises
    `AssertionError` with every failing rank's traceback, or when the ranks
    outlive ``timeout`` seconds (they are killed first)."""
    directory = os.fspath(directory)
    store = os.path.join(directory, "store")
    if os.path.exists(store):
        os.remove(store)
    outs = [os.path.join(directory, f"rank{r}.pkl") for r in range(world_size)]
    # The function and its arguments go through a file: through the
    # process's own arguments a large pickle would block each start until
    # the child has imported torch, so the ranks would start one by one.
    call = os.path.join(directory, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, store, call, outs[r], init),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"ranks {hung} of {world_size} still ran after {timeout} s: killed")
    payloads = []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            raise AssertionError(f"rank {r} exited with code {procs[r].exitcode} and no result")
        with open(out, "rb") as f:
            payloads.append(pickle.load(f))
    errors = [p["error"] for p in payloads if "error" in p]
    if errors:
        raise AssertionError("\n".join(errors))
    return [p["result"] for p in payloads]
