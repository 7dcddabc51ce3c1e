"""Experiment configuration read from (and written to) ``exp_config.json``.

Port of ``srl_zoo_tpu/config.py``: ``--losses name[:weight[:split_dim]]``
parsing, SRL-split slices, ``SRLConfig`` with every field of the JAX
package, and the ``exp_config.json`` contract. The JSON keys and their
defaults are the JAX package's, so a run folder written by either package
loads in the other with equal fields. A file without ``bn-momentum`` was
recorded before that key existed and trained at flax's 0.99.

Every loss of the zoo trains, on every model type (custom_cnn, resnet,
mlp, linear) at either compute dtype (float32, bfloat16), with every
``--device-cache`` mode (data/device_cache.py says which of them a
process group of several ranks takes).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

VALID_LOSSES = (
    "autoencoder", "vae", "dae", "perceptual", "priors", "forward",
    "inverse", "reward", "triplet", "episode-prior", "reward-prior",
    "supervised", "random",
)
VALID_MODELS = ("custom_cnn", "resnet", "mlp", "linear")
VALID_DTYPES = ("float32", "bfloat16")
# losses that need a decoder head
RECONSTRUCTION_LOSSES = ("autoencoder", "vae", "dae", "perceptual")
# losses whose formulas consume the next state s'
NEXT_STATE_LOSSES = ("priors", "forward", "inverse", "reward")


def parse_loss_arguments(loss_args: List[str], state_dim: int
                         ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """``name[:weight[:split_dim]]`` tokens -> (losses, split_dims): loss
    name -> weight (default 1.0) and loss name -> declared split size (-1 =
    share the previous slice / no split)."""
    losses: Dict[str, float] = {}
    split_dims: Dict[str, int] = {}
    for token in loss_args:
        parts = token.split(":")
        name = parts[0]
        if name not in VALID_LOSSES:
            raise ValueError(f"Unknown loss '{name}'. Valid losses: "
                             f"{', '.join(VALID_LOSSES)}")
        if name in losses:
            raise ValueError(f"Duplicate loss '{name}' in --losses")
        if len(parts) > 3:
            raise ValueError(f"Malformed loss token '{token}' "
                             "(expected name[:weight[:split_dim]])")
        losses[name] = float(parts[1]) if len(parts) >= 2 and parts[1] \
            else 1.0
        split_dims[name] = int(parts[2]) if len(parts) >= 3 else -1
    declared = [d for d in split_dims.values() if d >= 0]
    if declared and sum(declared) != state_dim:
        raise ValueError(
            f"Declared split dimensions {declared} sum to {sum(declared)} "
            f"but --state-dim is {state_dim}")
    return losses, split_dims


def compute_split_slices(losses: Dict[str, float], split_dims: Dict[str, int],
                         state_dim: int) -> Dict[str, Tuple[int, int]]:
    """Per-loss ``(start, size)`` of the state vector. With no declared
    split every loss sees the full state; otherwise losses are laid out in
    order and a ``-1`` inherits the previous loss's slice."""
    if not any(d >= 0 for d in split_dims.values()):
        return {name: (0, state_dim) for name in losses}
    slices: Dict[str, Tuple[int, int]] = {}
    offset = 0
    prev: Tuple[int, int] = (0, state_dim)
    for name in losses:
        dim = split_dims.get(name, -1)
        if dim >= 0:
            slices[name] = prev = (offset, dim)
            offset += dim
        else:
            slices[name] = prev
    if offset != state_dim:
        raise ValueError(
            f"Declared split dimensions sum to {offset} but state_dim is "
            f"{state_dim}: {dict(split_dims)}")
    return slices


@dataclasses.dataclass(frozen=True)
class SRLConfig:
    state_dim: int = 2
    model_type: str = "custom_cnn"
    losses: Tuple[Tuple[str, float], ...] = (("autoencoder", 1.0),)
    split_dims: Tuple[Tuple[str, int], ...] = (("autoencoder", -1),)
    n_actions: int = 4
    n_reward_classes: int = 3
    img_height: int = 224
    img_width: int = 224
    multi_view: bool = False
    batch_size: int = 32
    epochs: int = 30
    learning_rate: float = 5e-3
    grad_accum: int = 1
    seed: int = 1
    val_size: float = 0.2
    training_set_size: int = -1
    l1_reg: float = 0.0
    l2_reg: float = 0.0
    beta: float = 1.0
    occlusion_percentage: float = 0.5
    noise_type: str = "occlusion"
    noise_std: float = 0.2
    balanced_sampling: bool = False
    normalize_mode: str = "tf"
    compute_dtype: str = "float32"
    inverse_model_type: str = "linear"
    episode_prior_optimizer: str = "shared"
    path_to_dae: str = ""
    pretrained_weights: str = ""
    data_folder: str = ""
    log_folder: str = ""
    num_cpu: int = 4
    device_cache: str = "auto"
    stream_overlap: bool = False
    hybrid_rotation: bool = True
    # BatchNorm running-average momentum on the flax convention
    # (ra = m*ra + (1-m)*batch): 0.9 is torch's momentum 0.1
    bn_momentum: float = 0.9

    def __post_init__(self):
        if self.model_type not in VALID_MODELS:
            raise ValueError(f"Unknown model type '{self.model_type}'. "
                             f"Valid: {', '.join(VALID_MODELS)}")
        if self.compute_dtype not in VALID_DTYPES:
            raise ValueError(f"Unknown compute dtype '{self.compute_dtype}'"
                             f". Valid: {', '.join(VALID_DTYPES)}")
        if self.device_cache not in ("auto", "on", "off", "hybrid",
                                     "sharded"):
            raise ValueError(f"Unknown device_cache mode "
                             f"'{self.device_cache}' (expected auto/on/off/"
                             "hybrid/sharded)")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")
        if self.episode_prior_optimizer not in ("shared", "separate"):
            raise ValueError(
                f"Unknown episode_prior_optimizer "
                f"'{self.episode_prior_optimizer}' (expected shared/separate)")
        if not 0.0 <= self.bn_momentum < 1.0:
            raise ValueError(f"bn_momentum must be in [0, 1), got "
                             f"{self.bn_momentum}")
        if self.normalize_mode not in ("tf", "image_net"):
            raise ValueError(f"Unknown normalize mode '{self.normalize_mode}'"
                             " (expected 'tf' or 'image_net')")
        if self.normalize_mode == "image_net" and self.use_decoder:
            # the decoder's tanh output lives in [-1, 1], the "tf" range
            raise ValueError(
                "Reconstruction losses require normalize_mode='tf' (the "
                "decoder's tanh output range); got 'image_net'")
        recon_slices = {n: self.slices[n] for n in self.loss_names
                        if n in RECONSTRUCTION_LOSSES}
        if len(set(recon_slices.values())) > 1:
            raise ValueError(
                "Multiple reconstruction losses must share one state slice "
                f"(got {recon_slices}); give later ones split dim -1")

    # ---- derived helpers ---------------------------------------------------
    @property
    def loss_dict(self) -> Dict[str, float]:
        return dict(self.losses)

    @property
    def split_dict(self) -> Dict[str, int]:
        return dict(self.split_dims)

    @property
    def loss_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.losses)

    @property
    def slices(self) -> Dict[str, Tuple[int, int]]:
        return compute_split_slices(self.loss_dict, self.split_dict,
                                    self.state_dim)

    @property
    def use_decoder(self) -> bool:
        return any(n in RECONSTRUCTION_LOSSES for n in self.loss_names)

    @property
    def use_vae(self) -> bool:
        return "vae" in self.loss_names

    @property
    def use_forward(self) -> bool:
        return "forward" in self.loss_names

    @property
    def use_inverse(self) -> bool:
        return "inverse" in self.loss_names

    @property
    def use_reward(self) -> bool:
        return "reward" in self.loss_names

    @property
    def use_triplet(self) -> bool:
        return "triplet" in self.loss_names

    @property
    def use_episode_prior(self) -> bool:
        return "episode-prior" in self.loss_names

    @property
    def use_priors(self) -> bool:
        return "priors" in self.loss_names

    @property
    def use_dae(self) -> bool:
        return "dae" in self.loss_names

    @property
    def use_supervised(self) -> bool:
        return "supervised" in self.loss_names

    @property
    def only_random_features(self) -> bool:
        """``--losses random`` alone: the run keeps its initial weights."""
        return self.loss_names == ("random",)

    @property
    def needs_next_obs(self) -> bool:
        return any(n in NEXT_STATE_LOSSES for n in self.loss_names)

    @property
    def recon_slice(self) -> Tuple[int, int]:
        """The one state slice the decoder reads (checked in __post_init__)."""
        return next(self.slices[n] for n in self.loss_names
                    if n in RECONSTRUCTION_LOSSES)

    @property
    def stack_views(self) -> bool:
        """Whether the encoder's input stacks both camera views on the
        channel axis: multi-view SRL without triplet, whose embedding net
        runs per view instead."""
        return self.multi_view and not self.use_triplet

    @property
    def needs_second_view(self) -> bool:
        """Whether training reads the second view's frames (``frames_2``):
        stacked into the input, or as the triplet's positive."""
        return self.multi_view or self.use_triplet

    @property
    def n_channels(self) -> int:
        """Encoder input channels: 6 when both views are stacked, else 3."""
        return 6 if self.stack_views else 3

    @property
    def img_shape(self) -> Tuple[int, int, int]:
        return (self.img_height, self.img_width, self.n_channels)

    def replace(self, **kw) -> "SRLConfig":
        return dataclasses.replace(self, **kw)

    # ---- exp_config.json contract -----------------------------------------
    def to_exp_config(self) -> Dict:
        return {
            "batch-size": self.batch_size,
            "beta": self.beta,
            "data-folder": self.data_folder,
            "epochs": self.epochs,
            "learning-rate": self.learning_rate,
            "grad-accum": self.grad_accum,
            "training-set-size": self.training_set_size,
            "log-folder": self.log_folder,
            "model-type": self.model_type,
            "seed": self.seed,
            "state-dim": self.state_dim,
            "losses": {name: w for name, w in self.losses},
            "split-dimensions": {name: d for name, d in self.split_dims},
            "n-actions": self.n_actions,
            "n-reward-classes": self.n_reward_classes,
            "multi-view": self.multi_view,
            "balanced-sampling": self.balanced_sampling,
            "l1-reg": self.l1_reg,
            "l2-reg": self.l2_reg,
            "occlusion-percentage": self.occlusion_percentage,
            "noise-type": self.noise_type,
            "noise-std": self.noise_std,
            "normalize-mode": self.normalize_mode,
            "compute-dtype": self.compute_dtype,
            "inverse-model-type": self.inverse_model_type,
            "episode-prior-optimizer": self.episode_prior_optimizer,
            "path-to-dae": self.path_to_dae,
            "pretrained-weights": self.pretrained_weights,
            "img-shape": list(self.img_shape),
            "val-size": self.val_size,
            "num-cpu": self.num_cpu,
            "device-cache": self.device_cache,
            "stream-overlap": self.stream_overlap,
            "hybrid-rotation": self.hybrid_rotation,
            "bn-momentum": self.bn_momentum,
        }

    def save(self, log_folder: str) -> str:
        os.makedirs(log_folder, exist_ok=True)
        path = os.path.join(log_folder, "exp_config.json")
        with open(path, "w") as f:
            # no sort_keys: the order of the losses dict is the split layout
            json.dump(self.to_exp_config(), f, indent=2)
        return path

    @classmethod
    def from_exp_config(cls, cfg: Dict) -> "SRLConfig":
        losses = tuple((k, float(v)) for k, v in cfg["losses"].items())
        raw_splits = cfg.get("split-dimensions", {})
        split_dims = tuple((k, int(raw_splits.get(k, -1))) for k, _ in losses)
        img_shape = cfg.get("img-shape", [224, 224, 3])
        return cls(
            state_dim=int(cfg["state-dim"]),
            model_type=cfg.get("model-type", "custom_cnn"),
            losses=losses,
            split_dims=split_dims,
            n_actions=int(cfg.get("n-actions", 4)),
            n_reward_classes=int(cfg.get("n-reward-classes", 3)),
            img_height=int(img_shape[0]),
            img_width=int(img_shape[1]),
            multi_view=bool(cfg.get("multi-view", False)),
            batch_size=int(cfg.get("batch-size", 32)),
            epochs=int(cfg.get("epochs", 30)),
            learning_rate=float(cfg.get("learning-rate", 5e-3)),
            grad_accum=int(cfg.get("grad-accum", 1)),
            seed=int(cfg.get("seed", 1)),
            val_size=float(cfg.get("val-size", 0.2)),
            training_set_size=int(cfg.get("training-set-size", -1)),
            l1_reg=float(cfg.get("l1-reg", 0.0)),
            l2_reg=float(cfg.get("l2-reg", 0.0)),
            beta=float(cfg.get("beta", 1.0)),
            occlusion_percentage=float(cfg.get("occlusion-percentage", 0.5)),
            noise_type=cfg.get("noise-type", "occlusion"),
            noise_std=float(cfg.get("noise-std", 0.2)),
            balanced_sampling=bool(cfg.get("balanced-sampling", False)),
            normalize_mode=cfg.get("normalize-mode", "tf"),
            compute_dtype=cfg.get("compute-dtype", "float32"),
            inverse_model_type=cfg.get("inverse-model-type", "linear"),
            episode_prior_optimizer=cfg.get("episode-prior-optimizer",
                                            "shared"),
            path_to_dae=cfg.get("path-to-dae", ""),
            pretrained_weights=cfg.get("pretrained-weights", ""),
            data_folder=cfg.get("data-folder", ""),
            log_folder=cfg.get("log-folder", ""),
            num_cpu=int(cfg.get("num-cpu", 4)),
            device_cache=cfg.get("device-cache", "auto"),
            stream_overlap=bool(cfg.get("stream-overlap", False)),
            hybrid_rotation=bool(cfg.get("hybrid-rotation", True)),
            # configs recorded before the key existed trained at flax 0.99
            bn_momentum=float(cfg.get("bn-momentum", 0.99)),
        )

    @classmethod
    def load(cls, log_folder: str) -> "SRLConfig":
        with open(os.path.join(log_folder, "exp_config.json")) as f:
            return cls.from_exp_config(json.load(f))


def build_config(args, losses: Dict[str, float], split_dims: Dict[str, int],
                 n_actions: int, n_reward_classes: int,
                 img_shape: Optional[Tuple[int, int, int]] = None
                 ) -> SRLConfig:
    """An SRLConfig from the train CLI's parsed arguments."""
    h, w = (img_shape[0], img_shape[1]) if img_shape else (224, 224)
    return SRLConfig(
        state_dim=args.state_dim,
        model_type=args.model_type,
        losses=tuple(losses.items()),
        split_dims=tuple(split_dims.items()),
        n_actions=n_actions,
        n_reward_classes=n_reward_classes,
        img_height=h,
        img_width=w,
        multi_view=args.multi_view,
        batch_size=args.batch_size,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        grad_accum=args.grad_accum,
        seed=args.seed,
        val_size=args.val_size,
        training_set_size=args.training_set_size,
        l1_reg=args.l1_reg,
        l2_reg=args.l2_reg,
        beta=args.beta,
        occlusion_percentage=args.occlusion_percentage,
        noise_type=args.noise_type,
        noise_std=args.noise_std,
        balanced_sampling=args.balanced_sampling,
        compute_dtype=args.dtype,
        inverse_model_type=args.inverse_model_type,
        episode_prior_optimizer=args.episode_prior_optimizer,
        path_to_dae=args.path_to_dae,
        pretrained_weights=args.pretrained_weights,
        device_cache=args.device_cache,
        stream_overlap=args.stream_overlap,
        hybrid_rotation=not args.no_hybrid_rotation,
        bn_momentum=args.bn_momentum,
        data_folder=args.data_folder,
        log_folder=args.log_folder,
        num_cpu=args.num_cpu,
    )
