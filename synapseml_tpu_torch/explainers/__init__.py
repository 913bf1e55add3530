"""Responsible-AI explainers: the port's counterpart of the JAX package's
``explainers/`` (SURVEY §2.7 explainers/, 23 files in reference).

LIME + KernelSHAP for tabular/vector/text/image, ICE/PDP, with all local
surrogate regressions solved as batched linear algebra through the
bucketed runner (solvers.py): on the card one captured graph per bucket."""

from .base import LocalExplainerBase
from .solvers import batched_lasso, batched_lstsq, solve_batched
from .lime import ImageLIME, TabularLIME, TextLIME, VectorLIME
from .shap import ImageSHAP, TabularSHAP, TextSHAP, VectorSHAP
from .ice import ICETransformer


class LocalExplainer:
    """Factory matching the reference's LocalExplainer object
    (explainers/LocalExplainer.scala:12-32)."""

    class LIME:
        tabular = TabularLIME
        vector = VectorLIME
        image = ImageLIME
        text = TextLIME

    class KernelSHAP:
        tabular = TabularSHAP
        vector = VectorSHAP
        image = ImageSHAP
        text = TextSHAP


__all__ = ["LocalExplainerBase", "LocalExplainer", "TabularLIME", "VectorLIME",
           "TextLIME", "ImageLIME", "TabularSHAP", "VectorSHAP", "TextSHAP",
           "ImageSHAP", "ICETransformer", "batched_lasso", "batched_lstsq",
           "solve_batched"]
