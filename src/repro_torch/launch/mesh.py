"""The campaign mesh of the port (the campaign part of
`repro.launch.mesh`): the devices a sharded replay campaign
(`core.sim_engine.SimEngine(mesh=...)`) splits its trace axis across.

A `CampaignMesh` is a frozen list of `torch.device`s with one axis,
"campaign".  Entries may repeat: `devices=["cuda:0"] * 3` runs a
three-shard campaign on one card, `["cpu"] * 3` on the host, which is
how a ragged multi-shard campaign is exercised with a single device.
The production and smoke meshes of the LLM scaffold are not ported
(ROADMAP queue A, "LLM scaffold, what PR 16-17 left").
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


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
