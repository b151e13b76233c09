"""Plain float32 PyTorch references, one file per architecture, written from
the architecture that each configuration file states (``bench/configs``),
which names its file under ``"reference"``.  Each has ``forward`` (the
token sequences to the last hidden states), ``logits`` and ``counts`` (the
work of one token, ``bench/work.py``'s ``Counts``).  They import nothing of
the program: they take the configuration's ``run`` sizes, the weights by
name and the token sequences."""
