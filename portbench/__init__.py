"""The benchmark of srl_zoo_tpu_torch (README.md)."""
