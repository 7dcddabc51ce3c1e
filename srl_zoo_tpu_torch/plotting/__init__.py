"""Plotting (port of ``srl_zoo_tpu/plotting``): the representation scatter,
the ground-truth correlation heatmap and the loss curves, drawn on the
host with numpy and OpenCV (``raster.py``)."""
