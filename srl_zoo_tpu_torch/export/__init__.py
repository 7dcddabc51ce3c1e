"""Export surfaces: hand a trained run of the port to torch-only consumers
(``torch_export``)."""

__all__ = ["build_torch_encoder", "export_torch_encoder"]


def __getattr__(name):
    # lazy: `python -m srl_zoo_tpu_torch.export.torch_export` must not
    # import the submodule when the package is imported (runpy warns)
    if name in __all__:
        from srl_zoo_tpu_torch.export import torch_export
        return getattr(torch_export, name)
    raise AttributeError(name)
