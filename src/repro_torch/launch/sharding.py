"""Campaign sharding of the port (the campaign part of
`repro.launch.sharding`): a replay campaign's trace axis partitions
over the campaign mesh (`launch.mesh.make_campaign_mesh`), and
everything else (timing tables, scenario rows, policy knobs) is
replicated, i.e. copied to each shard's device.  The model sharding
rules of the LLM scaffold are not ported (ROADMAP queue A, "LLM
scaffold, what PR 16-17 left").
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import CampaignMesh


def campaign_spec() -> tuple[str, ...]:
    """Partition the leading (trace) axis over "campaign"; every other
    axis is replicated."""
    return ("campaign",)


@dataclasses.dataclass(frozen=True)
class CampaignSharding:
    """`campaign_spec` on a mesh: row block i of a [T]-leading tensor
    lives on `mesh.devices[i]`."""

    mesh: CampaignMesh
    spec: tuple[str, ...] = campaign_spec()

    def slices(self, t: int) -> list[slice]:
        """The row block of each device; T must be a multiple of the
        device count."""
        k = self.mesh.size
        if t % k:
            raise ValueError(f"the trace axis ({t}) must be a multiple of "
                             f"the campaign mesh's {k} devices")
        tl = t // k
        return [slice(i * tl, (i + 1) * tl) for i in range(k)]


def campaign_sharding(mesh: CampaignMesh) -> CampaignSharding:
    return CampaignSharding(mesh)


def tree_map(fn, tree):
    """`fn` over every tensor leaf of a tuple / list / dict /
    NamedTuple tree (None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def shard_campaign(mesh: CampaignMesh, tree) -> list:
    """Split every [T, ...]-leading tensor of a per-stream tree into one
    row block per mesh device, placed on that device: a list of
    `mesh.size` trees.  T must be a multiple of the device count (the
    engine's `_shard_pad` handles a ragged T)."""
    t = int(tree_leaves(tree)[0].shape[0])
    sl = campaign_sharding(mesh).slices(t)
    return [tree_map(lambda x, s=s, d=d: x[s].to(d), tree)
            for s, d in zip(sl, mesh.devices)]
