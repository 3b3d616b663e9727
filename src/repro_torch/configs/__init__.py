"""Model presets (``vgg16_spectral``)."""
