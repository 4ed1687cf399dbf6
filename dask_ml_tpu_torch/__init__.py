"""dask_ml_tpu_torch — the PyTorch/CUDA port of ``dask_ml_tpu``.

The same sklearn-contract estimators, with the same names, parameters
and fitted attributes, running on an NVIDIA H100 through kernels written
by hand for Hopper (``csrc/``, bound in ``ops/fused.py``). Entry points
place data on ``config.device``, which is ``"cuda"`` unless the caller
asks for the CPU (``with config.set(device="cpu"): ...``).

Layers, each the counterpart of the JAX package's module of that name:
- ``config``, ``base``, ``parallel/sharded.py``, ``utils/validation.py``
- ``ops/`` — masked reductions, pairwise distances, the fused kernels
  (``fused.py``) and their build (``_build.py``)
- ``models/`` — GLM solvers and estimators, KMeans
- ``linear_model``, ``cluster``, ``metrics`` — sklearn-parity namespaces
- ``convert`` — carry a fitted JAX estimator's parameters across

Ported so far: in-memory binary LogisticRegression, LinearRegression
and PoissonRegression (lbfgs, gradient_descent, proximal_grad) and
in-memory KMeans. ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

__all__ = ["cluster", "config", "convert", "linear_model", "metrics",
           "__version__"]
