"""AutoML (SURVEY §2.7 automl/, 800 LoC in reference): hyperparameter spaces,
TuneHyperparameters (random/grid search with elastic successive-halving
cross-validation — see automl/scheduler.py and docs/automl.md), and
FindBestModel.

The port's copy of the JAX package's ``automl/__init__.py`` (host code; the
port imports nothing of that package).
"""

from .hyperparams import (DiscreteHyperParam, GridSpace, HyperparamBuilder,
                          RandomSpace, RangeHyperParam)
from .scheduler import (BracketState, ElasticHalvingScheduler,
                        GangCandidatePool, RungSpec, plan_rungs)
from .tune import FindBestModel, FindBestModelResult, TuneHyperparameters, TuneHyperparametersModel

__all__ = ["DiscreteHyperParam", "RangeHyperParam", "HyperparamBuilder",
           "GridSpace", "RandomSpace", "TuneHyperparameters",
           "TuneHyperparametersModel", "FindBestModel", "FindBestModelResult",
           "RungSpec", "plan_rungs", "BracketState",
           "ElasticHalvingScheduler", "GangCandidatePool"]
