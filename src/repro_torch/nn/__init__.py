"""The port's functional NN layers (counterparts of `repro.nn`): plain
functions on tensors with parameters as nested dicts."""
