"""Training (the port's copy of ``repro.train``): in-situ analog SGD,
with periodic carry and pulse-train writes, and the numeric baseline
(``train_loop``, ``optimizer``)."""
