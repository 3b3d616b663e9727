"""Launch helpers: the device mesh of sharded spectral inference."""
