"""Production mesh construction, and the process group under it.

Defined as functions (never module-level constants) so importing this module
never touches ``torch.distributed`` state: the tests and the serving path
see no process group at all; only a sharded entry point starts one.

``start_group`` is the counterpart of the JAX package's device setup: an
NCCL group on the card, gloo on the CPU (both from the ``torchrun``
environment, or a group of one rank when ``WORLD_SIZE`` is unset), and the
``fake`` backend of a given world size for the dry-run, whose collectives
move nothing (it stands in for ``--xla_force_host_platform_device_count``;
the backend is registered by importing a module of torch's testing package,
which ``tests/test_torch_dryrun.py`` pins).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_group(device: str = "cuda", fake_world: int = 0) -> None:
    """Start the default process group unless one is up: ``fake`` of
    ``fake_world`` ranks (rank 0) when it is given, else ``nccl`` for
    ``device`` ``cuda`` or ``gloo`` for the CPU.  Without ``WORLD_SIZE`` in
    the environment (no ``torchrun``) the group is one rank on a free
    localhost port."""
    if dist.is_initialized():
        return
    if fake_world:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=fake_world)
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "WORLD_SIZE" not in os.environ:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)


def mesh_device_type() -> str:
    """The device type a mesh over the current group lives on."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh
    over the first ranks of the current group, which must have at least
    that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(mesh_device_type(), torch.arange(n).view(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model: int | None = None) -> DeviceMesh:
    """Small (data, model) mesh over whatever ranks exist (CPU tests, smoke
    runs)."""
    n = dist.get_world_size()
    model = model or 1
    return init_device_mesh(mesh_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))
