"""Core: tile geometry and spectral transform (``spectral``), pruning
(``sparse``), layer/graph descriptions (``dataflow``), Alg 1 on the
H100 and its cost model (``autotune``), Alg 2 (``scheduler``) and the
compile-once plan (``plan``)."""
