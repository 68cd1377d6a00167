"""The ranks of a mesh: one process per mesh device, joined by
``torch.distributed`` (the port's stand-in for the devices ``jax.make_mesh``
lays out in one JAX process).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``'s
``spawn`` method (CUDA cannot fork), joins them into one ``gloo`` group
through a ``FileStore`` in a fresh temporary directory (no TCP port, so
runs that start together never collide), and runs ``fn(rank, world,
*args)`` in each.  Rank ``r`` sits at the row-major coordinate of the mesh
shape, as ``jax.make_mesh`` orders its devices (``launch/mesh.py``).

Every rank's return value comes back to the caller, in rank order,
through a file in that directory.  A rank that raises writes its
traceback there and the caller raises it; a rank that dies or outlives
``timeout_s`` stops every rank, and the caller raises with what it knows.
The group is joined with the same timeout, so a rank stuck in a collective
fails there with its own traceback instead of hanging its caller.
``timeout_s=None`` sets no deadline (a training run of any length,
``launch/train.py --mesh``): the caller waits until every rank ends or one
fails or dies, and a collective waits as long as torch's default for a
process group (30 minutes).

On the CPU each rank runs one thread.  On ``cuda`` every rank uses card
0: ``gloo`` is the backend because NCCL refuses two ranks on one card
(``distributed/collectives.py`` copies each operand to the host).

The rank programs the tests, ``launch/train.py --mesh`` and
``chip_smoke.py`` run live in this package (``distributed/programs.py``),
so that ``spawn`` can import them in the child.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

BACKEND = "gloo"
DEFAULT_TIMEOUT_S = 300.0
# What the caller waits beyond the group's timeout, for a rank that fails
# in a collective to write its traceback.
GRACE_S = 30.0
# This rank's collective timeout (``None``: torch's default), for the
# mesh's groups (``launch/mesh.py``) as for the world's.
GROUP_TIMEOUT: Optional[datetime.timedelta] = None


def _rank_main(fn: Callable, rank: int, world: int, root: str,
               timeout_s: Optional[float], device: str) -> None:
    """A rank's body: read the arguments, join the group, run ``fn``,
    write its result (or its traceback) under ``root``, leave the
    group."""
    import torch.distributed as dist
    global GROUP_TIMEOUT
    try:
        args = torch.load(os.path.join(root, "args.pt"), weights_only=False)
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(0)
        if timeout_s is not None:
            GROUP_TIMEOUT = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(
            BACKEND, init_method=f"file://{os.path.join(root, 'store')}",
            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(root, f"rank{rank}.pt.tmp"))
        os.replace(os.path.join(root, f"rank{rank}.pt.tmp"),
                   os.path.join(root, f"rank{rank}.pt"))
    except BaseException:  # noqa: BLE001 — handed to the caller
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class RankError(RuntimeError):
    """A rank failed, died or outlived its time; the message holds the
    failing ranks' tracebacks."""


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *,
          device: str = "cpu",
          timeout_s: Optional[float] = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks; returns the
    ranks' results in rank order.  ``fn`` and ``args`` must pickle (a
    module-level function of this package).  ``device``: ``"cpu"`` or
    ``"cuda"`` (all ranks on card 0).  ``timeout_s``: the ranks' deadline
    and the group's collective timeout; ``None`` for no deadline."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="repro_ranks_")
    dev = torch.device(device).type
    procs = []
    try:
        # Every rank reads the arguments from one file: handing them to
        # each process at its start took ~13 s for 1.4 MB of arrays and
        # 8 ranks (torch 2.13 on 8 CPU cores), against 4 s for none.
        torch.save(tuple(args), os.path.join(root, "args.pt"))
        for r in range(world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                fn, r, world, root, timeout_s, dev))
            p.start()
            procs.append(p)
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s + GRACE_S
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or (deadline is not None and
                          time.monotonic() > deadline):
                break
            time.sleep(0.05)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(root, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"--- rank {r}\n{f.read()}")
            elif r not in alive and p.exitcode != 0:
                errors.append(f"--- rank {r} died (exit code {p.exitcode})")
        if alive and not errors:
            errors.append(f"ranks {alive} still running after "
                          f"{timeout_s + GRACE_S:.0f} s: stopped")
        if errors:
            raise RankError(f"{len(errors)} of {world} ranks failed:\n" +
                            "\n".join(errors))
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
