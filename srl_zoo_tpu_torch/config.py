"""Experiment configuration read from (and written to) ``exp_config.json``.

Port of ``srl_zoo_tpu/config.py`` ``SRLConfig``, cut to the fields the
encode path reads. The JSON keys and their defaults are the JAX package's,
so a run folder written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

VALID_MODELS = ("custom_cnn", "resnet", "mlp", "linear")
# where each model type that this slice does not run waits (ROADMAP.md A)
_PENDING_MODELS = {
    "resnet": "ROADMAP.md queue A item 'Config 5' (ResNet-18)",
    "mlp": "ROADMAP.md queue A item 'DenseEncoder / LinearEncoder'",
    "linear": "ROADMAP.md queue A item 'DenseEncoder / LinearEncoder'",
}


@dataclasses.dataclass(frozen=True)
class SRLConfig:
    state_dim: int = 2
    model_type: str = "custom_cnn"
    losses: Tuple[Tuple[str, float], ...] = (("autoencoder", 1.0),)
    img_height: int = 224
    img_width: int = 224
    multi_view: bool = False
    normalize_mode: str = "tf"
    compute_dtype: str = "float32"
    data_folder: str = ""

    def __post_init__(self):
        if self.model_type not in VALID_MODELS:
            raise ValueError(f"Unknown model type '{self.model_type}'. "
                             f"Valid: {', '.join(VALID_MODELS)}")
        if self.model_type in _PENDING_MODELS:
            raise NotImplementedError(
                f"model type '{self.model_type}' is not ported yet: "
                f"{_PENDING_MODELS[self.model_type]}")
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute dtype '{self.compute_dtype}' is not ported yet: "
                "ROADMAP.md queue A item 'bfloat16 compute'")
        if self.normalize_mode not in ("tf", "image_net"):
            raise ValueError(f"Unknown normalize mode '{self.normalize_mode}'"
                             " (expected 'tf' or 'image_net')")

    @property
    def loss_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.losses)

    @property
    def use_vae(self) -> bool:
        return "vae" in self.loss_names

    @property
    def use_triplet(self) -> bool:
        return "triplet" in self.loss_names

    @property
    def n_channels(self) -> int:
        """Encoder input channels: two stacked views for multi-view SRL, but
        3 for triplet, whose embedding net runs per view."""
        return 6 if self.multi_view and not self.use_triplet else 3

    @property
    def img_shape(self) -> Tuple[int, int, int]:
        return (self.img_height, self.img_width, self.n_channels)

    def to_exp_config(self) -> Dict:
        return {
            "data-folder": self.data_folder,
            "model-type": self.model_type,
            "state-dim": self.state_dim,
            "losses": {name: w for name, w in self.losses},
            "multi-view": self.multi_view,
            "normalize-mode": self.normalize_mode,
            "compute-dtype": self.compute_dtype,
            "img-shape": list(self.img_shape),
        }

    def save(self, log_folder: str) -> str:
        os.makedirs(log_folder, exist_ok=True)
        path = os.path.join(log_folder, "exp_config.json")
        with open(path, "w") as f:
            json.dump(self.to_exp_config(), f, indent=2)
        return path

    @classmethod
    def from_exp_config(cls, cfg: Dict) -> "SRLConfig":
        losses = tuple((k, float(v)) for k, v in cfg["losses"].items())
        img_shape = cfg.get("img-shape", [224, 224, 3])
        return cls(
            state_dim=int(cfg["state-dim"]),
            model_type=cfg.get("model-type", "custom_cnn"),
            losses=losses,
            img_height=int(img_shape[0]),
            img_width=int(img_shape[1]),
            multi_view=bool(cfg.get("multi-view", False)),
            normalize_mode=cfg.get("normalize-mode", "tf"),
            compute_dtype=cfg.get("compute-dtype", "float32"),
            data_folder=cfg.get("data-folder", ""),
        )

    @classmethod
    def load(cls, log_folder: str) -> "SRLConfig":
        with open(os.path.join(log_folder, "exp_config.json")) as f:
            return cls.from_exp_config(json.load(f))
