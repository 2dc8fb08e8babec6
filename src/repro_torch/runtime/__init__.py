"""Runtime utilities of the port (counterpart of `repro.runtime`): the
region-table compressor, straggler detection, heartbeats and the
fault-tolerant checkpoint loop."""
