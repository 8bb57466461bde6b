"""Training substrate in PyTorch: optimizers, the train step and loop,
checkpointing, fault tolerance.

Counterpart of ``repro.train`` (``elastic.py`` is still to port).
"""
