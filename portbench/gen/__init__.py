"""The benchmark's inputs, drawn from its seed."""
