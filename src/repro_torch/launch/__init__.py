"""Launch helpers: the device mesh of sharded spectral inference
(``mesh``) and the LM's continuous-batching server (``serve``)."""
