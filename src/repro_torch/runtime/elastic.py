"""Elastic scaling: re-mesh planning and resharding (port of
`repro.runtime.elastic`).

When nodes fail or join, the data-parallel axis is resized (the model
axis is pinned by the TP layout).  `plan_mesh` chooses the largest valid
(data, model) grid for the surviving device count; `make_mesh_for`
builds it over the world of ranks that remain (`launch.mesh.make_mesh`:
the world must have that many ranks), and a restore places the
checkpointed leaves under the new mesh's shardings: the checkpoint
format is mesh-agnostic (`repro_torch.checkpoint`).
"""

from __future__ import annotations

import torch

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh


def plan_mesh(n_devices: int, model_parallel: int = 16,
              pod_size: int | None = None):
    """Largest usable mesh: data = floor(n/model); multi-pod keeps whole
    pods only (a partially-dead pod is drained to keep the pod axis
    uniform)."""
    if pod_size:
        pods = n_devices // pod_size
        data = pod_size // model_parallel
        if pods >= 2:
            return ("pod", "data", "model"), (pods, data, model_parallel)
        n_devices = pods * pod_size if pods else n_devices
    data = max(1, n_devices // model_parallel)
    if data * model_parallel > n_devices:
        data -= 1
    mp = model_parallel if data >= 1 else n_devices
    return ("data", "model"), (max(data, 1), mp)


def make_mesh_for(n_devices: int, model_parallel: int = 16,
                  pod_size: int | None = None,
                  device: str | torch.device = "cuda"):
    axes, shape = plan_mesh(n_devices, model_parallel, pod_size)
    return make_mesh(shape, axes, device)


def reshard_state(state, cfg, new_mesh, params_shape):
    """A params-like tree (`DTensor` or whole leaves) placed on `new_mesh`
    under `param_shardings`: each `DTensor` leaf is gathered on its own
    mesh (every rank of it takes part), then each rank keeps its new
    block."""
    sh = SH.param_shardings(cfg, new_mesh, params_shape)
    return SH.tree_map_with_path(
        lambda path, x: SH.place(SH.gather(x), SH.at(sh, path)), state)
