"""Data pipelines of the port (counterpart of `repro.data`)."""
