"""Training of the port (counterpart of `repro.train`)."""
