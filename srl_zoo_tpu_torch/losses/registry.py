"""Weighted loss assembly (port of ``srl_zoo_tpu/losses/registry.py``
``compute_total_loss`` / ``recompose_epoch_means``) for every loss of the
zoo and the l1/l2 regularizers, added in the JAX package's order. Each
loss reads its SRL-splits slice of the state. The episode prior adds its
discriminator's loss at weight 1 and its encoder's at the loss's weight;
``random`` trains nothing and reports 0.

``compute_total_loss`` returns ``(total, metrics)``; ``metrics`` holds each
term, ``total``, ``_n_valid`` (the batch's valid-row count, by which the
learner weights its epoch means) and, for the pair terms of the priors and
the episode prior, ``_w/<term>`` (their pair counts, which weight those
terms instead), all as 0-d tensors on the device.

In a process group (training/train_step.py) every input but the
reconstruction and its target is the global batch's, and ``rows`` joins
the ranks' per-sample pixel errors into the global batch's before their
mean: each term is then one sum over the global batch over its global
count, the same value on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.losses import functions as F
from srl_zoo_tpu_torch.models.srl_modules import slice_state as _sl

PRIOR_TERMS = ("priors/temporal", "priors/causality",
               "priors/proportionality", "priors/repeatability")


def compute_total_loss(cfg: SRLConfig, outputs: Dict[str, torch.Tensor],
                       target_obs: torch.Tensor,
                       valid: Optional[torch.Tensor],
                       params: Iterable[torch.Tensor],
                       batch: Optional[Dict[str, torch.Tensor]] = None,
                       rows: Optional[Callable] = None):
    """``outputs`` of SRLModules.forward, with the train step's
    ``disc_logits_d`` / ``disc_logits_e`` (episode prior) and
    ``feat_recon`` / ``feat_target`` (perceptual) beside them; the clean
    normalized frames the decoder reconstructs, the (B,) 0/1 validity mask
    of a padded eval batch (None = all rows count), the model's parameters
    and the batch's device tensors the losses read (``actions``,
    ``reward_classes``, ``rewards``, ``gt_states``, the priors' and the
    episode prior's partners, masks and labels). ``rows`` maps the (B,)
    per-sample pixel errors of this process's rows to the global batch's
    (the identity by default)."""
    weights = cfg.loss_dict
    slices = cfg.slices
    batch = batch or {}
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=target_obs.device)
    state = outputs["state"]
    next_state = outputs.get("next_state")

    def add(name: str, value: torch.Tensor) -> None:
        nonlocal total
        metrics[name] = value
        total = total + weights[name] * value

    if "autoencoder" in weights:
        add("autoencoder", F.autoencoder_loss(outputs["recon"], target_obs,
                                              valid, rows))
    if "dae" in weights:
        add("dae", F.dae_loss(outputs["recon"], target_obs, valid, rows))
    if "vae" in weights:
        sl = slices["vae"]
        add("vae", F.vae_loss(outputs["recon"], target_obs,
                              _sl(outputs["mu"], sl),
                              _sl(outputs["logvar"], sl), cfg.beta, valid,
                              rows))
    if "perceptual" in weights:
        add("perceptual", F.perceptual_similarity_loss(
            outputs["feat_recon"], outputs["feat_target"], valid))
    if "priors" in weights:
        sl = slices["priors"]
        value, terms = F.robotic_priors_loss(
            _sl(state, sl), _sl(next_state, sl),
            batch["same_action_partners"], batch["same_action_mask"],
            batch["dissimilar_partners"], batch["dissimilar_mask"], valid)
        metrics.update(terms)
        add("priors", value)
    if "forward" in weights:
        add("forward", F.forward_model_loss(
            outputs["forward_pred"], _sl(next_state, slices["forward"]),
            valid))
    if "inverse" in weights:
        add("inverse", F.inverse_model_loss(outputs["inverse_logits"],
                                            batch["actions"], valid))
    if "reward" in weights:
        add("reward", F.reward_model_loss(outputs["reward_logits"],
                                          batch["reward_classes"], valid))
    if "triplet" in weights:
        sl = slices["triplet"]
        # the anchor is mu, as the positive and negative are: a VAE's
        # sample would put noise on one branch of each distance
        add("triplet", F.triplet_loss(_sl(outputs["mu"], sl),
                                      _sl(outputs["pos_state"], sl),
                                      _sl(outputs["neg_state"], sl),
                                      valid=valid))
    if "episode-prior" in weights:
        partners = batch["episode_partners"]
        pair_valid = None if valid is None else valid * valid[partners]
        d_loss, e_loss = F.episode_prior_losses(
            outputs["disc_logits_d"], outputs["disc_logits_e"],
            batch["episode_labels"], pair_valid)
        metrics["episode-prior/discriminator"] = d_loss
        metrics["episode-prior"] = e_loss
        total = total + d_loss + weights["episode-prior"] * e_loss
        n_pairs = pair_valid.sum() if pair_valid is not None else \
            torch.tensor(float(partners.shape[0]), device=target_obs.device)
        metrics["_w/episode-prior"] = n_pairs
        metrics["_w/episode-prior/discriminator"] = n_pairs
    if "reward-prior" in weights:
        add("reward-prior", F.reward_prior_loss(
            _sl(state, slices["reward-prior"]), batch["rewards"], valid))
    if "supervised" in weights:
        add("supervised", F.supervised_loss(
            _sl(state, slices["supervised"]), batch["gt_states"], valid))
    if "random" in weights:
        metrics["random"] = torch.zeros((), device=target_obs.device)
    if cfg.l1_reg > 0 or cfg.l2_reg > 0:
        params = list(params)
    if cfg.l1_reg > 0:
        metrics["l1_reg"] = F.l1_regularization(params)
        total = total + cfg.l1_reg * metrics["l1_reg"]
    if cfg.l2_reg > 0:
        metrics["l2_reg"] = F.l2_regularization(params)
        total = total + cfg.l2_reg * metrics["l2_reg"]
    metrics["total"] = total
    metrics["_n_valid"] = (valid.sum() if valid is not None else
                           torch.tensor(float(state.shape[0]),
                                        device=target_obs.device))
    return total, metrics


def recompose_epoch_means(cfg: SRLConfig,
                          means: Dict[str, float]) -> Dict[str, float]:
    """Rebuild the composite metrics of an epoch (``priors``, ``total``)
    from its exactly averaged components, with the arithmetic
    compute_total_loss uses per batch: a composite mixes row and pair
    denominators, so no one weighting of its per-batch values is exact.
    The episode prior's discriminator counts at weight 1."""
    out = dict(means)
    if all(t in out for t in PRIOR_TERMS):
        out["priors"] = float(sum(out[t] for t in PRIOR_TERMS))
    total = 0.0
    for name, w in cfg.loss_dict.items():
        if name == "episode-prior":
            total += out["episode-prior/discriminator"] + \
                w * out["episode-prior"]
        elif name in out:
            total += w * out[name]
    if cfg.l1_reg > 0 and "l1_reg" in out:
        total += cfg.l1_reg * out["l1_reg"]
    if cfg.l2_reg > 0 and "l2_reg" in out:
        total += cfg.l2_reg * out["l2_reg"]
    out["total"] = float(total)
    return out
