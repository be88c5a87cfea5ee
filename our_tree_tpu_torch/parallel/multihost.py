"""Process bootstrap of the multi-device layer (``our_tree_tpu.parallel.multihost``).

One process is one rank and one device (SPMD): every rank runs the same
program on its own shard, and ``parallel/dist.py``'s functions talk over
``torch.distributed``. This module joins a process to its world:

    from our_tree_tpu_torch.parallel import dist, multihost
    multihost.initialize("host0:8476", num_processes=N, process_id=i)
    mesh = multihost.global_mesh()          # every rank of the world
    local = dist.shard_rows(words, mesh, words=True)
    out = dist.ctr_crypt_sharded(local, ctr_be, rk, nr, mesh)

or, under ``python -m torch.distributed.run --nproc-per-node N ...`` (part of
PyTorch), ``multihost.initialize_from_env()``. The transport is NCCL between
cards and gloo between CPU ranks. ``backend="gloo"`` on a card is the caller's
choice for ranks that share one card (NCCL takes no two ranks on one
device); ``dist.py`` then stages each collective through host memory. The
transport is never switched because something failed.

The JAX package's ``cpu_devices_per_process`` has no counterpart: a rank is
one device, so the CPU rehearsal of an N-device mesh is N processes with
``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from . import dist

#: This process's rank device, set by ``initialize``.
_STATE: dict = {"device": None}


def _init_method(coordinator: str) -> str:
    """``"host:port"`` as a TCP rendezvous; a URL (``file://``, ``tcp://``)
    as it is."""
    if "://" in coordinator:
        return coordinator
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be 'host:port' or a URL, got {coordinator!r}")
    return f"tcp://{host}:{port}"


def initialize(coordinator: str, num_processes: int, process_id: int, device=None,
               backend: str | None = None) -> torch.device:
    """Join the world as rank ``process_id`` of ``num_processes``; once per
    process. Returns this rank's device.

    Args:
      coordinator: ``"host:port"`` of rank 0's rendezvous, or a ``file://``
        URL that every rank can reach (no port to race for).
      device: ``"cuda"`` (the default: ``cuda:{process_id % device count}``,
        raising without a card), an explicit ``"cuda:i"``, or ``"cpu"``.
      backend: ``"nccl"`` (the default on a card) or ``"gloo"`` (the default
        on the CPU; on a card, for ranks that share it). NCCL on the CPU
        raises.
    """
    if tdist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized: initialize() joins a "
                           "world once per process (multihost.shutdown() leaves it)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU rank")
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"a rank runs on 'cuda' or 'cpu', got {dev}")
    be = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if be not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {be!r}")
    if be == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries card tensors only: a CPU rank takes backend='gloo'")
    tdist.init_process_group(be, init_method=_init_method(coordinator),
                             world_size=int(num_processes), rank=int(process_id))
    _STATE["device"] = dev
    return dev


def initialize_from_env(device=None, backend: str | None = None) -> torch.device:
    """``initialize`` from the environment ``python -m torch.distributed.run``
    sets: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (the card is ``cuda:{LOCAL_RANK
    % device count}``), ``MASTER_ADDR`` and ``MASTER_PORT``."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"not under python -m torch.distributed.run: {missing} unset")
    rank = int(env["RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    return initialize(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                      rank, device=dev, backend=backend)


def rank_device() -> torch.device:
    """This rank's device: the one ``initialize`` set, else (a world made
    elsewhere) the card of its rank under NCCL, the CPU under gloo."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    if tdist.is_initialized() and tdist.get_backend() == "nccl":
        return torch.device("cuda", tdist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def shutdown() -> None:
    """Leave the world (every rank calls it) and forget its meshes."""
    if tdist.is_initialized():
        tdist.destroy_process_group()
    dist.forget_meshes()
    _STATE["device"] = None


def global_mesh(axis: str = dist.AXIS) -> dist.Mesh:
    """The mesh over every rank of the world."""
    return dist.make_mesh(None, axis)


def host_local_to_global(arr, mesh: dist.Mesh, axis: str = dist.AXIS) -> torch.Tensor:
    """This rank's contiguous shard (a tensor, or a numpy array: uint32 words
    become the int32 tensor of the same bits) on its device, after checking
    with a gather of shapes that every rank of ``mesh`` passed the same
    shape; a mismatch raises on every rank. The SPMD counterpart of
    assembling a global array from per-host shards: the sharded functions
    take the local shard as it is."""
    del axis  # one axis: the mesh's
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        a = np.ascontiguousarray(arr)
        t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())
    t = t.to(mesh.device)
    if t.dim() > 8:
        raise ValueError(f"at most 8 dimensions, got {t.dim()}")
    shape = torch.full((1, 9), -1, dtype=torch.int64, device=mesh.device)
    shape[0, 0] = t.dim()
    shape[0, 1:1 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    shapes = dist.gather_for_verification(shape, mesh)
    if not bool((shapes == shapes[0]).all()):
        got = [tuple(int(v) for v in row[1:1 + int(row[0])]) for row in shapes.cpu()]
        raise ValueError(f"ranks passed different local shapes {got}: every rank's shard must "
                         "have the same shape")
    return t
