"""Meshes of the port (`repro.launch.mesh`).

The model half: the production meshes of the LLM scaffold as
`torch.distributed.device_mesh.DeviceMesh`es, one rank a device.

    single pod: (data=16, model=16), 256 ranks
    multi-pod:  (pod=2, data=16, model=16), 512 ranks; the "pod" axis
                carries only data parallelism and its gradient sums

A mesh needs the default process group.  Where none exists, a world of
one starts over an in-memory `dist.HashStore` (no port, no network);
where the environment names a larger world (`WORLD_SIZE`, `RANK`, as
`torchrun` sets them), that world starts from the environment.  The
backend is NCCL for a CUDA mesh and gloo for a CPU mesh; a CUDA mesh
without NCCL raises, it never falls back to the CPU.  `AbstractMesh`
holds axis names and sizes alone, for the sharding rules at production
size where no such world exists (`jax.sharding.AbstractMesh`).

The campaign half: a `CampaignMesh` is a frozen list of `torch.device`s
with one axis, "campaign", the devices a sharded replay campaign
(`core.sim_engine.SimEngine(mesh=...)`) splits its trace axis across.
Entries may repeat: `devices=["cuda:0"] * 3` runs a three-shard
campaign on one card, `["cpu"] * 3` on the host, which is how a ragged
multi-shard campaign is exercised with a single device.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


# ----------------------------------------------------------- model meshes
@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks (what `param_spec`, `sanitize`
    and the `*_shardings` specs read)."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def world_size() -> int:
    """Ranks of the default process group, or of the one the environment
    names before it starts (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_main_rank() -> bool:
    """Rank 0 of the default process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        resolve_device("cuda")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch "
                               "build lacks; pass device='cpu' for a CPU "
                               "mesh")
        return "nccl"
    if device_type != "cpu":
        raise ValueError(f"a mesh lives on 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    return "gloo"


def _ensure_world(device_type: str) -> None:
    """Start the default process group for `device_type` if there is none:
    from the environment when it names a world of several ranks, else a
    world of one over a `dist.HashStore`.  An existing group must serve
    the device type's backend; a world of the "fake" backend (the dry
    run's, `launch.dryrun.fake_world`) serves any device type."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        return
    backend = _backend(device_type)
    if dist.is_initialized():
        if backend not in dist.get_backend():
            raise RuntimeError(f"the process group's backend "
                               f"{dist.get_backend()!r} cannot serve a "
                               f"{device_type} mesh ({backend} needed)")
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if world_size() > 1:
        dist.init_process_group(backend)             # env:// (torchrun)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` over every rank of the world (`jax.make_
    mesh`); a world of another size raises a `ValueError` naming the
    ranks needed."""
    n = math.prod(shape)
    have = world_size()
    if have != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} ranks "
                         f"(one a device); the world has {have}")
    device_type = torch.device(device).type
    _ensure_world(device_type)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device: str | torch.device = "cuda") -> DeviceMesh:
    """The (1, 1) mesh with the production axis names, in a world of
    one."""
    return make_mesh((1, 1), ("data", "model"), device)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's shards: the current CUDA device of a
    CUDA mesh, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -------------------------------------------------------- campaign meshes
@dataclasses.dataclass(frozen=True)
class CampaignMesh:
    """One-axis mesh: shard i of a campaign runs on `devices[i]`."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a campaign mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("campaign",)

    @property
    def shape(self) -> dict[str, int]:
        return {"campaign": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_campaign_mesh(n_devices: int | None = None,
                       devices=None) -> CampaignMesh:
    """1-D "campaign" mesh for sharded replay campaigns: the trace axis
    of a campaign partitions across it, every other axis stays on each
    device.  Defaults to every visible CUDA device (raises without
    one); `devices` takes an explicit list, repeats allowed;
    `n_devices` clamps either to a prefix (n_devices=1 is the
    degenerate mesh the parity tests hold to the unsharded engine)."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"n_devices must lie in [1, {len(devs)}], got "
                             f"{n_devices}")
        devs = devs[:n_devices]
    return CampaignMesh(tuple(devs))
