"""Training (the port's copy of ``repro.train``): in-situ analog SGD."""
