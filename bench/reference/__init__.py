"""Plain float32 PyTorch references, one file per model family, written from
the architecture that each configuration file states (``bench/configs``).
They import nothing of the program: they take the configuration's ``run``
sizes, the weights by name and the token sequences, and return logits."""
