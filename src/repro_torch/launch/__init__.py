"""Serving and training steps of the port (counterpart of
`repro.launch`)."""
