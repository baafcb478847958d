"""Multi-process bootstrap: one process a GPU, over ``torch.distributed``.

The reference launches one process per GPU with a MASTER_ADDR/PORT
rendezvous (train_caption.py:27-28, :207-216) and NCCL between them; so does
the port.  Launch N ranks with ``torchrun``, which ships with PyTorch:

  torchrun --nproc_per_node N -m grit_tpu_torch.train_caption exp.name=run1 ...

``maybe_initialize()`` at CLI start reads the variables ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
or the JAX package's (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``), pins the rank's card, and starts the process group: NCCL for
a CUDA device, gloo for the CPU, or the backend the caller names.  Without
such variables it does nothing, and every helper here is then the one-process
identity.

``run_ranks`` starts N ranks as ``torchrun`` would, on one host, joins them
with a deadline and returns what each returned: the tests, the dry run and
chip_smoke.py use it.

grit_tpu's ``align_compile`` has no counterpart: it realigns ranks around
XLA's compiles, and nothing here compiles at the first call.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def _rendezvous() -> tuple[int, int, int, str] | None:
    """(rank, world, local rank, init method) from the environment, or None."""
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        rank = int(env.get("RANK", "0"))
        return rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank)), "env://"
    if env.get("COORDINATOR_ADDRESS") and env.get("NUM_PROCESSES"):
        rank = int(env.get("PROCESS_ID", "0"))
        return (rank, int(env["NUM_PROCESSES"]), int(env.get("LOCAL_RANK", rank)),
                f"tcp://{env['COORDINATOR_ADDRESS']}")
    return None


def maybe_initialize(device="cuda", *, backend: str | None = None,
                     timeout: datetime.timedelta = TIMEOUT) -> tuple[int, int]:
    """Start the process group if the environment configures a rendezvous ->
    (rank, world).  For a CUDA ``device`` the rank's card (``LOCAL_RANK``)
    becomes the current device first.  ``backend`` defaults to ``nccl`` for
    CUDA and ``gloo`` for the CPU; two ranks on one card must pass ``gloo``
    (NCCL refuses a card twice)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    found = _rendezvous()
    if found is None:
        return 0, 1
    rank, world, local_rank, init = found
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init, rank=rank, world_size=world, timeout=timeout)
    return rank, world


def rank_device(device) -> torch.device:
    """``device``, a bare ``cuda`` made the rank's card (``LOCAL_RANK``; 0
    without a launcher)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """Wait until every rank arrives (the reference's ``dist.barrier``).
    ``name`` says where, for the reader: the group's barriers are ordered by
    call, not named."""
    if world_size() > 1:
        dist.barrier()


def sync_hosts(name: str = "barrier") -> None:
    """grit_tpu's device barrier; one process group serves both here."""
    barrier(name)


def allgather_pyobj(obj) -> list:
    """Every rank's ``obj``, in rank order (the reference's pickled all_gather,
    engine/utils.py:102-142): COCO evaluation merges and the exchange of the
    rank-specialised evaluation's scores."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# launching ranks on one host
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world: int, *, args: tuple = (), kwargs: dict | None = None,
              device: str = "cpu", backend: str | None = None, local_ranks=None,
              deadline: float = 300.0, threads: int = 1, paths=()) -> list:
    """Run ``target`` (``"module:function"``) in ``world`` fresh Python
    processes, one a rank, with the variables ``torchrun`` sets and this
    process's TF32 settings; each calls ``maybe_initialize(device,
    backend=backend)`` and then ``target(*args, **kwargs)`` -> the ranks'
    return values (pickled: keep them on the host), in rank order.

    ``local_ranks``: each rank's card (default: rank r on card r; two ranks
    on one card give ``[0, 0]`` and ``backend="gloo"``).  ``threads``: the
    CPU threads of each rank.  ``paths``: directories put before the
    repository root on the ranks' ``sys.path``.  Past ``deadline`` seconds,
    or as soon as one rank fails, every rank is killed and this raises with
    the end of each rank's output."""
    root = Path(__file__).resolve().parents[2]
    work = Path(tempfile.mkdtemp(prefix="grit_ranks_"))
    # the ranks compute with this process's fp32 settings (TF32 in cuBLAS and cuDNN)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    (work / "args.pkl").write_bytes(pickle.dumps((target, device, backend, threads, tf32,
                                                  args, kwargs or {})))
    port = str(free_port())
    local_ranks = list(range(world)) if local_ranks is None else list(local_ranks)
    pythonpath = os.pathsep.join([*map(str, paths), str(root),
                                  os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(local_ranks[r]), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port, "OMP_NUM_THREADS": str(threads),
               "PYTHONPATH": pythonpath}
        log = open(work / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "from grit_tpu_torch.parallel.distributed import "
             f"rank_main; rank_main({str(work)!r})"],
            env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT), log))
    end = time.monotonic() + deadline
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [p for p, _ in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    try:
        codes = [p.returncode for p, _ in procs]
        if any(codes):
            tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                              + (work / f"rank{r}.log").read_text()[-3000:]
                              for r, c in enumerate(codes))
            raise RuntimeError(f"run_ranks({target}, {world}): a rank failed or the "
                               f"{deadline:.0f} s deadline passed\n{tails}")
        return [pickle.loads((work / f"rank{r}.out").read_bytes()) for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def rank_main(work: str) -> None:
    """The body of one rank that ``run_ranks`` started."""
    import importlib

    target, device, backend, threads, tf32, args, kwargs = pickle.loads(
        Path(work, "args.pkl").read_bytes())
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rank_, _ = maybe_initialize(device, backend=backend)
    module, fn = target.split(":")
    try:
        out = getattr(importlib.import_module(module), fn)(*args, **kwargs)
        Path(work, f"rank{rank_}.out").write_bytes(pickle.dumps(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
