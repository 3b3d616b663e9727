"""Atomic, checksummed, asynchronous checkpoints (``checkpointer``)."""
