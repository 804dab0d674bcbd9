"""Meshes of processes on ``torch.distributed`` — the counterpart of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every
process of the group, one device a process, with the reference's axis
names: ``clients`` (the client-sharded rollout engine), ``("clients",
"model")`` (the 2-D training engine) and ``("data", "model")`` /
``("pod", "data", "model")`` (the production meshes).  The builders are
functions, never module constants, so importing this module starts no
process group.

The process group comes from ``torchrun``'s environment when one is set
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); without one it is a world of
one through a ``FileStore`` in a temporary directory (removed when the
process exits), so nothing listens on a port.  Its backend is NCCL on
the card and gloo only when the caller passes ``device="cpu"``; with no
GPU and no explicit CPU choice the builders raise, as
``kernels.dispatch.resolve_device`` does.

:func:`run_cpu_ranks` spawns k CPU processes that join one gloo group
through a ``FileStore`` and runs a function in each — how the tests and
the CLI try a mesh of k processes on one machine:

  python -m repro_torch.launch.train --engine mesh2d --model-shards 2 \\
      --clients 1 --cpu-ranks 2
"""
from __future__ import annotations

import atexit
import math
import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

from repro_torch.core.collective import MeshAxis
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["init_process_group", "make_mesh", "make_production_mesh",
           "make_client_mesh", "make_train_mesh", "client_axes",
           "n_clients_of", "model_shards_of", "mesh_axis", "run_cpu_ranks"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
#: run_cpu_ranks: each rank's torch threads (the ranks share the
#: machine's cores) and the seconds before the parent gives up on them
RANK_THREADS, RANK_TIMEOUT = 1, 600.0


def init_process_group(device=None) -> torch.device:
    """Join (or start) the default process group; returns this process's
    device.  NCCL for CUDA, gloo for ``device="cpu"``; an existing group
    is kept."""
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", device.index or 0))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        tmp = tempfile.mkdtemp(prefix="repro_pg_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
    return device


def make_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over every process of
    the group (joined first, :func:`init_process_group`)."""
    device = init_process_group(device)
    shape, names = tuple(int(s) for s in shape), tuple(names)
    need, world = math.prod(shape), dist.get_world_size()
    if need != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {need} "
                         f"processes, have {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, clients: int = None,
                         model: int = None, device=None):
    """The 2-D training mesh: ``clients=`` / ``model=`` give an explicit
    ``("clients", "model")`` mesh of that shape; the defaults keep the
    reference's ``("data", "model")`` (16, 16) and ``("pod", "data",
    "model")`` (2, 16, 16) meshes, whose client axis is ``("pod",
    "data")``."""
    if clients is not None or model is not None:
        if multi_pod:
            raise ValueError("multi_pod composes the pod axis with the "
                             "default data x model shape; pass clients=/"
                             "model= without multi_pod")
        return make_mesh((int(clients or 1), int(model or 1)),
                         ("clients", "model"), device)
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_train_mesh(clients: int = None, model_shards: int = 1,
                    device=None):
    """The ``(clients, model)`` mesh of the 2-D training engine;
    ``model_shards=1`` is the column-free layout, bit-exact with the
    stacked engine.  ``clients=None`` takes every process divided by
    ``model_shards``."""
    m = int(model_shards)
    if m < 1:
        raise ValueError(f"model_shards must be >= 1, got {model_shards}")
    init_process_group(device)
    world = dist.get_world_size()
    c = (world // m) if clients is None else int(clients)
    if c * m > world or c < 1:
        c = max(c, 1)
        raise ValueError(f"mesh ({c} clients x {m} model shards) needs "
                         f"{c * m} processes, have {world}")
    return make_mesh((c, m), ("clients", "model"), device)


def make_client_mesh(n_shards: int = None, device=None):
    """1-D mesh over the ``clients`` axis for the client-sharded rollout;
    defaults to every process."""
    init_process_group(device)
    n = dist.get_world_size() if n_shards is None else int(n_shards)
    return make_mesh((n,), ("clients",), device)


def client_axes(mesh) -> tuple:
    """Mesh axes that together form the FL client axis."""
    names = tuple(mesh.mesh_dim_names or ())
    if "clients" in names:
        return ("clients",)
    return tuple(a for a in ("pod", "data") if a in names)


def _size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def n_clients_of(mesh) -> int:
    return math.prod(_size(mesh, a) for a in client_axes(mesh))


def model_shards_of(mesh) -> int:
    """Size of the ``model`` axis (1 when the mesh has none)."""
    return _size(mesh, "model") if "model" in (mesh.mesh_dim_names or ()) \
        else 1


def mesh_axis(mesh, names) -> MeshAxis:
    """The :class:`~repro_torch.core.collective.MeshAxis` of ``names`` on
    ``mesh`` — what the port passes where the reference names an axis."""
    return MeshAxis(mesh, names)


# ---------------------------------------------------------------------------
# k CPU ranks on one machine
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, store_path, args, results):
    torch.set_num_threads(RANK_THREADS)
    try:
        dist.init_process_group("gloo",
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        results.put(("ok", rank, fn(rank, world, *args)))
    except BaseException:
        # the parent stops the other ranks, which may wait in a collective
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_cpu_ranks(fn, world: int, *args) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned CPU processes
    joined in one gloo group (a ``FileStore`` in a temporary directory);
    returns the results by rank.  Gloo takes CUDA tensors too, so ``fn``
    may put its mesh on the card: several processes then share one card,
    which NCCL refuses.  ``fn`` and ``args`` must pickle (a
    module-level function) and results should be numpy or plain Python.
    A rank that raises stops every rank and raises here with its
    traceback; so does a rank that dies, or RANK_TIMEOUT seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, store, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, waited = {}, 0.0
        try:
            while len(out) < world:
                try:
                    status, rank, value = results.get(timeout=1.0)
                except queue.Empty:
                    waited += 1.0
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if waited > RANK_TIMEOUT:
                        raise RuntimeError(
                            f"CPU ranks timed out after {RANK_TIMEOUT} s")
                    if not dead:
                        continue
                    try:    # a rank that raised has queued its traceback
                        status, rank, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"CPU ranks died: exit codes {dead}") from None
                if status == "error":
                    raise RuntimeError(f"rank {rank} raised:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(world)]
