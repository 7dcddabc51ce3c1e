"""PyTorch + CUDA port of srl_zoo_tpu for NVIDIA Hopper GPUs.

The JAX package ``srl_zoo_tpu`` is the reference this package is held
against; nothing here imports it or JAX. This slice ports the inference
path: ``inference.StateEncoder``, the ``serve`` HTTP endpoint, state export
(``evaluation.predict_dataset``) and KNN-MSE (``evaluation.knn``), with
hand-written CUDA kernels under ``csrc/``.
"""
