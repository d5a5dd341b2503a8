"""Serving steps of the port (counterpart of `repro.launch`)."""
