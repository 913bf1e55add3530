from .gbdt import (  # noqa: F401
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)
