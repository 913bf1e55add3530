"""Featurization (SURVEY §2.7 featurize/, 9 files in reference).

Auto-featurization (Featurize), missing-value cleaning, value indexing, count
selection, type conversion, and text featurization (TextFeaturizer, MultiNGram,
PageSplitter).

The port's copy of the JAX package's ``featurize/__init__.py`` (host code;
the port imports nothing of that package).
"""

from .clean import CleanMissingData, CleanMissingDataModel
from .convert import DataConversion
from .featurize import Featurize, FeaturizeModel
from .indexer import IndexToValue, ValueIndexer, ValueIndexerModel
from .select import CountSelector, CountSelectorModel
from .text import MultiNGram, PageSplitter, TextFeaturizer, TextFeaturizerModel

__all__ = ["Featurize", "FeaturizeModel", "CleanMissingData", "CleanMissingDataModel",
           "ValueIndexer", "ValueIndexerModel", "IndexToValue", "CountSelector",
           "CountSelectorModel", "DataConversion", "TextFeaturizer",
           "TextFeaturizerModel", "MultiNGram", "PageSplitter"]
