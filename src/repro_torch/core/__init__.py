"""Core: tile geometry and spectral transform (``spectral``), pruning
(``sparse``), layer/graph descriptions (``dataflow``), the fused-kernel
configuration record (``autotune``) and the compile-once plan
(``plan``)."""
