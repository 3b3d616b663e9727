"""Launch helpers: the device mesh of sharded spectral inference
(``mesh``), the spectral-CNN serving front end (``spectral_serve``) and
the LM's continuous-batching server (``serve``)."""
