"""Models: the spectral VGG16 forward pass (``cnn``) and shared layer
initializers (``layers``)."""
