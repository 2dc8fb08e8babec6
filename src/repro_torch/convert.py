"""Carry the JAX reference's state across into the port's objects.

Every function takes plain numpy arrays (or Python numbers) as the
reference produces them — `np.asarray(jax_array)` — so the port can
compute on exactly the reference's inputs without importing it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.aldram import TimingTable
from repro_torch.core.charge import ChargeConstants
from repro_torch.core.dram_sim import Trace
from repro_torch.core.faults import FaultScenario, FaultSpec
from repro_torch.core.thermal import SCN_COLS, ThermalScenario
from repro_torch.core.variation import Population
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF


def population(cells: np.ndarray,
               device: str | torch.device = "cuda") -> Population:
    """[modules, chips, banks, K, 5] cells (`Population.cells`)."""
    cells = np.asarray(cells, np.float32)
    if cells.ndim != 5 or cells.shape[-1] != 5:
        raise ValueError(f"cells must be [modules, chips, banks, K, 5], "
                         f"got {cells.shape}")
    return Population(torch.tensor(cells, device=resolve_device(device)))


def trace(arrival: np.ndarray, bank: np.ndarray, row: np.ndarray,
          is_write: np.ndarray,
          device: str | torch.device = "cuda") -> Trace:
    """One [N] trace or a batched [T, N] trace."""
    dev = resolve_device(device)
    return Trace(torch.tensor(np.asarray(arrival, np.float32), device=dev),
                 torch.tensor(np.asarray(bank, np.int32), device=dev),
                 torch.tensor(np.asarray(row, np.int32), device=dev),
                 torch.tensor(np.asarray(is_write, bool), device=dev))


def charge_constants(fields: Mapping[str, float]) -> ChargeConstants:
    """`ChargeConstants` from the reference's field values (e.g.
    `dataclasses.asdict(constants)`); every field must be given."""
    return ChargeConstants(**{k: float(v) for k, v in fields.items()})


def timing_table(temp_bins, params: np.ndarray, safe_trefi_read: np.ndarray,
                 safe_trefi_write: np.ndarray,
                 params_module: np.ndarray | None = None,
                 region_index: np.ndarray | None = None,
                 params_bank: np.ndarray | None = None) -> TimingTable:
    """A module-level ([modules, bins, 4]), per-bank ([modules, bins,
    banks, 4] with its module-envelope table) or region-compressed
    (the [modules, bins, U, 4] unique store with its int32 [modules,
    bins, banks, regions] index map, module-envelope and per-bank
    tables) `TimingTable`."""
    def f32(x):
        return None if x is None else np.asarray(x, np.float32)

    return TimingTable(
        tuple(float(t) for t in temp_bins), f32(params),
        f32(safe_trefi_read), f32(safe_trefi_write),
        params_module=f32(params_module),
        region_index=(None if region_index is None
                      else np.asarray(region_index, np.int32)),
        params_bank=f32(params_bank))


def scenario(row: np.ndarray, name: str = "scenario") -> ThermalScenario:
    """A `ThermalScenario` from the reference's [SCN_COLS] scenario row
    (`ThermalScenario.as_row()` / one row of `stack_scenarios`)."""
    r = np.asarray(row, np.float32)
    if r.shape != (SCN_COLS,):
        raise ValueError(f"scenario row must be [{SCN_COLS}], got {r.shape}")
    return ThermalScenario(name, *(float(x) for x in r))


def fault_spec(spec) -> FaultSpec:
    """The port's `FaultSpec` from the reference's (`faults.FaultSpec`:
    its scenario rows, field by field, and its seed), so `pack()` is
    equal."""
    return FaultSpec(
        scenarios=tuple(FaultScenario(**dataclasses.asdict(s))
                        for s in spec.scenarios),
        seed=int(spec.seed))


def model_params(tree: Mapping, cfg, dtype=torch.float32,
                 device: str | torch.device = "cuda") -> dict:
    """The port's params from the reference's param tree (nested dicts of
    numpy arrays, `jax.tree.map(np.asarray, params)`) for config `cfg`:
    the same tree, leaf for leaf, each leaf checked against the shape
    `transformer.init_params` gives it.  Weights become `dtype`; norm
    scales stay float32."""
    dev = resolve_device(device)
    want = TF.init_params(torch.Generator(), cfg, device="meta")

    def conv(ref, shape_tree, path):
        if isinstance(shape_tree, dict):
            keys = sorted(ref) if isinstance(ref, Mapping) else type(ref)
            if keys != sorted(shape_tree):
                raise ValueError(f"params{path}: keys {keys}, expected "
                                 f"{sorted(shape_tree)}")
            return {k: conv(ref[k], shape_tree[k], f"{path}.{k}")
                    for k in shape_tree}
        arr = np.asarray(ref, np.float32)
        if arr.shape != tuple(shape_tree.shape):
            raise ValueError(f"params{path}: shape {arr.shape}, expected "
                             f"{tuple(shape_tree.shape)}")
        dt = torch.float32 if path.endswith(".scale") else dtype
        return torch.tensor(arr, dtype=dt, device=dev)

    return conv(tree, want, "")
