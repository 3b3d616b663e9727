"""Models: the spectral CNN forward pass (``cnn``), the dense LM
(``config``, ``attention``, ``transformer``, ``api``) and the shared
layers (``layers``)."""
