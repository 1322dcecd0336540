"""Utilities: logging, batch samplers and serving-raster positions, image metrics, npz checkpoints."""
