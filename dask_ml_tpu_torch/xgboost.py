"""XGBoost bridge.

Counterpart of ``dask_ml_tpu/xgboost.py``: the reference re-exports
dask-xgboost, which upstream deprecated for ``xgboost.dask``. xgboost is
not installed, so importing the module works and using any symbol
raises with the upstream guidance.
"""


def __getattr__(name):
    if name in ("train", "predict", "XGBClassifier", "XGBRegressor"):
        raise ImportError(
            f"dask_ml_tpu_torch.xgboost.{name} requires the 'xgboost' "
            "package, which is not installed in this environment. Upstream "
            "dask-ml deprecated this bridge in favor of xgboost's native "
            "distributed API; use that with torch tensors via DMatrix."
        )
    raise AttributeError(name)
