"""The LM's deterministic synthetic data stream (``pipeline``)."""
