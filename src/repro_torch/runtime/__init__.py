"""Runtime utilities of the port (counterpart of `repro.runtime`)."""
