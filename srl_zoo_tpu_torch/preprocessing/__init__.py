"""Offline dataset preprocessing (port of ``srl_zoo_tpu/preprocessing``)."""
