"""Fleet recalibration service: closed-loop AL-DRAM serving over a
simulated fleet-month (port of `repro.fleet`).

The paper's profile->table->deploy flow is one-shot; this package makes
it a long-running loop:

  * `drift`   — parameterized aging/VRT model that moves `Population`
                cell parameters toward the weak side over simulated
                days (tail cells fastest),
  * `monitor` — ECC-style error observation: margin scrub of the
                drifted cells under the DEPLOYED table rows, and the
                correctable/uncorrectable event model for the served
                traffic,
  * `recal`   — `FleetEngine`, interleaving serving epochs (ONE
                SimEngine replay dispatch each) with error-driven /
                periodic re-profiling, online guardband updates
                (`core.guardband.tighten_rows`/`relax_rows`), and
                fault injection (module failures, slow-to-recalibrate
                stragglers).
"""

from repro_torch.fleet.drift import DriftConfig, DriftModel
from repro_torch.fleet.monitor import ECCConfig, ErrorMonitor
from repro_torch.fleet.recal import (FleetEngine, FleetResult, FleetSpec,
                                     frontier, run_policies)

__all__ = ["DriftConfig", "DriftModel", "ECCConfig", "ErrorMonitor",
           "FleetEngine", "FleetResult", "FleetSpec", "frontier",
           "run_policies"]
