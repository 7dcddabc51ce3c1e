"""Kernels and their plain PyTorch versions."""

from srl_zoo_tpu_torch.ops.pairwise import pairwise_sqdist  # noqa: F401
