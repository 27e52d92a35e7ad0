"""Process-group bootstrap, data-parallel placement and a local launcher.

Counterpart of ``dewi_tpu/parallel/runtime.py``.  The reference
bootstraps multi-host JAX (``jax.distributed.initialize``); the port runs
one process per device under ``torch.distributed``:

* :func:`initialize_runtime` calls ``init_process_group`` (``nccl`` for
  CUDA, ``gloo`` for the CPU) with explicit arguments, or when it finds a
  multi-process environment (torchrun's ``WORLD_SIZE > 1``, or the
  reference's ``DEWI_NUM_PROCESSES`` and coordinator variables); otherwise
  it does nothing.  A failed initialization raises: a rank that silently
  ran alone would answer from its shard only.
* :func:`launch_local` starts ``world_size`` ranks on this host (start
  method ``spawn``, a ``file://`` rendezvous in a temporary directory) and
  returns rank 0's value.  It is the port's counterpart of a mesh over
  every local device: the tests, the example and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh, make_mesh

# Seconds a collective (and the rendezvous) may wait before it raises.
DEFAULT_TIMEOUT_S = 600.0

_COORDINATOR_ENV_VARS = (
    "COORDINATOR_ADDRESS",
    "JAX_COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _coordinator() -> Optional[str]:
    for var in _COORDINATOR_ENV_VARS:
        if os.environ.get(var):
            return os.environ[var]
    return None


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       backend: Optional[str] = None,
                       timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group (a no-op when single-process).

    With explicit arguments, ``init_process_group`` at
    ``coordinator_address`` (``host:port`` or a URL) as rank ``process_id``
    of ``num_processes``.  With none, it initializes only when a
    multi-process environment is found: torchrun's variables (``env://``),
    or ``DEWI_NUM_PROCESSES > 1`` with ``DEWI_PROCESS_ID`` and one of
    ``COORDINATOR_ADDRESS``/``JAX_COORDINATOR_ADDRESS``/
    ``MEGASCALE_COORDINATOR_ADDRESS``.  Safe to call again once joined.
    Unlike the reference, a failure raises.
    """
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    td = datetime.timedelta(seconds=float(timeout))
    if coordinator_address or (num_processes and num_processes > 1):
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("initialize_runtime needs coordinator_address, num_processes "
                             "and process_id together")
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=td)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://", timeout=td)
    elif int(os.environ.get("DEWI_NUM_PROCESSES", "1")) > 1:
        address = _coordinator()
        pid = os.environ.get("DEWI_PROCESS_ID")
        if address is None or pid is None:
            raise ValueError("DEWI_NUM_PROCESSES > 1 needs DEWI_PROCESS_ID and a coordinator "
                             f"address in one of {', '.join(_COORDINATOR_ENV_VARS)}")
        dist.init_process_group(backend, init_method=_init_method(address),
                                world_size=int(os.environ["DEWI_NUM_PROCESSES"]),
                                rank=int(pid), timeout=td)


def device_summary() -> Dict[str, Any]:
    """Topology snapshot for logs and metrics (the reference's keys)."""
    joined = dist.is_available() and dist.is_initialized()
    gpu = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "n_devices": dist.get_world_size() if joined else 1,
        "n_local_devices": torch.cuda.device_count() if gpu else 1,
        "platform": "gpu" if gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if gpu else "cpu",
    }


def shard_batch(batch: Any, mesh: Mesh, pad_value: Any = 0) -> Tuple[torch.Tensor, int]:
    """This rank's rows of a host batch padded to a multiple of the data
    axis: ``(rows on the mesh's device, original length)``."""
    n_data = mesh.shape[DATA_AXIS]
    arr = np.asarray(batch)
    n = arr.shape[0]
    rem = (-n) % n_data
    if rem:
        arr = np.concatenate([arr, np.full((rem,) + arr.shape[1:], pad_value, arr.dtype)])
    per = arr.shape[0] // n_data
    r = mesh.data_index
    return torch.from_numpy(np.ascontiguousarray(arr[r * per:(r + 1) * per])).to(mesh.device), n


def default_mesh() -> Mesh:
    """Every rank on the data axis (the standard DEWI layout)."""
    return make_mesh()


# ---- local launcher ---------------------------------------------------------


def _rank_main(rank: int, world_size: int, tmp: str, backend: str, timeout: float,
               threads: Optional[int], out: Any) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    if threads:
        torch.set_num_threads(int(threads))
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        value = fn(*args)
        out.put((rank, True, value if rank == 0 else None))
    except BaseException:  # noqa: BLE001 -- the traceback goes to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs: Sequence[Any]) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def launch_local(fn: Callable[..., Any], world_size: int, args: Sequence[Any] = (),
                 backend: str = "gloo", timeout: float = 120.0,
                 threads: Optional[int] = None) -> Any:
    """Run ``fn(*args)`` on ``world_size`` ranks of this host; rank 0's value.

    Each rank is a ``spawn``-ed process that joins a process group of
    ``backend`` through a ``file://`` rendezvous (``RANK``, ``LOCAL_RANK``
    and ``WORLD_SIZE`` set), so ``make_mesh()`` inside ``fn`` spans the
    ranks.  ``fn`` must be importable by name (a module-level function) and
    its value picklable.  ``timeout`` bounds the whole launch and every
    collective: on expiry every rank is killed and ``TimeoutError`` raised;
    a rank's exception is raised here as ``RuntimeError`` with its
    traceback, after the other ranks are killed.  ``threads`` sets each
    rank's ``torch.set_num_threads``.  For ``nccl``, build the kernel
    library (``ops._build.load_library``) first, so the ranks load one
    build instead of each compiling.
    """
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dewi_launch_")
    # The call travels through a file: a process's spawn arguments are
    # written into a pipe that the child drains only after its imports, so
    # large arguments there would start the ranks one after another.
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, tmp, backend, float(timeout), threads, results))
             for r in range(world_size)]
    deadline = time.monotonic() + float(timeout)
    done: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch_local: {world_size - len(done)} of {world_size} "
                                   f"ranks did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        raise RuntimeError(f"launch_local: rank {r} exited with code "
                                           f"{p.exitcode} before it reported")
                continue
            if not ok:
                raise RuntimeError(f"launch_local: rank {rank} failed:\n{value}")
            done[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 5.0))
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return done[0]


__all__ = ["initialize_runtime", "device_summary", "shard_batch", "default_mesh",
           "launch_local", "default_backend", "DEFAULT_TIMEOUT_S"]
