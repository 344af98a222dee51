"""Training (port of ``repro.train``)."""
