from .gbdt import LightGBMClassificationModel, LightGBMClassifier  # noqa: F401
