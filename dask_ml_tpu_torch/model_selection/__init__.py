"""Model selection: splits, grid and randomized search, and the adaptive
searches. Counterpart of ``dask_ml_tpu/model_selection``."""
from ._hyperband import HyperbandSearchCV
from ._incremental import IncrementalSearchCV, InverseDecaySearchCV
from ._params import ParameterGrid, ParameterSampler
from ._search import GridSearchCV, RandomizedSearchCV, check_cv
from ._split import KFold, ShuffleSplit, train_test_split
from ._successive_halving import SuccessiveHalvingSearchCV

__all__ = ["GridSearchCV", "HyperbandSearchCV", "IncrementalSearchCV",
           "InverseDecaySearchCV", "KFold", "ParameterGrid",
           "ParameterSampler", "RandomizedSearchCV", "ShuffleSplit",
           "SuccessiveHalvingSearchCV", "check_cv", "train_test_split"]
