"""The LM workload of the port: config dataclasses, the dense model's
layers and transformer, and carrying the reference's parameters across
(``weights``)."""
