"""Serving engine of the port (`repro.serve`)."""
