"""Training substrate in PyTorch: the composable optimizer library.

Counterpart of ``repro.train`` (its trainer loop and checkpointing are not
ported yet).
"""
