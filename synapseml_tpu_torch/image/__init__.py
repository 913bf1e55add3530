"""Image utilities (the port's counterpart of the JAX package's ``image/``;
JVM ``image/`` package analog): Superpixel clustering (SLIC) for image
LIME/SHAP, SuperpixelTransformer, UnrollImage, ImageSetAugmenter. All of
it is host numpy, as in the JAX package."""

from .superpixel import slic_segments, grid_segments, Superpixel, SuperpixelTransformer
from .unroll import UnrollImage, ImageSetAugmenter

__all__ = ["slic_segments", "grid_segments", "Superpixel", "SuperpixelTransformer",
           "UnrollImage", "ImageSetAugmenter"]
