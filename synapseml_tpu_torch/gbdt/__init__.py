from .grower import Forest, GrowerConfig, TreeArrays, forest_predict, grow_tree, stack_trees  # noqa: F401
from .objectives import METRICS, Objective, get_objective, make_grouped, ndcg_at_k  # noqa: F401
from .boosting import Booster, BoosterConfig, train_booster  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .stream import StreamedDataset, predict_streamed, train_booster_streamed  # noqa: F401
