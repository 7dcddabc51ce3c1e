"""Loss functions (port of ``srl_zoo_tpu/losses/functions.py``): the
autoencoder's and the denoising autoencoder's pixel MSE, the beta-VAE, the
four robotic priors, the forward / inverse / reward heads, the triplet
loss, the reward prior, the episode prior's adversarial pair, the
perceptual similarity in a frozen DAE's features, the supervised MSE to
ground-truth states, and the l1/l2 parameter regularizers. The reductions
are the JAX package's: a mean over each sample's elements, then a mean
over the valid rows of the batch; the pair terms of the priors and the
episode prior average over their valid pairs.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# every loss reads its inputs at least in float32, as the JAX losses cast
# theirs: half types go up, float64 (a reference run) stays
from srl_zoo_tpu_torch.models.precision import at_least_f32 as _f32


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def _batch_mean(per_sample: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the batch axis, over the valid rows when a mask is given
    (the padded rows of a partial eval batch must not count)."""
    if valid is None:
        return per_sample.mean()
    return _masked_mean(per_sample, valid)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a finite gradient at 0 (a
    wall-blocked agent gives next_state == state exactly)."""
    return torch.sqrt(x.square().sum(-1) + 1e-12)


def mse(a: torch.Tensor, b: torch.Tensor,
        valid: Optional[torch.Tensor] = None,
        rows: Optional[Callable] = None) -> torch.Tensor:
    """Mean over the batch of each sample's mean squared error. ``rows``
    maps the (B,) per-sample errors of a process's rows to the global
    batch's before the mean (training/train_step.py in a process group)."""
    sq = (_f32(a) - _f32(b)).square()
    per_sample = sq.reshape(sq.shape[0], -1).mean(dim=1)
    return _batch_mean(per_sample if rows is None else rows(per_sample),
                       valid)


def autoencoder_loss(recon: torch.Tensor, target: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     rows: Optional[Callable] = None) -> torch.Tensor:
    """Pixel MSE between the reconstruction and the clean normalized
    frame (reference: autoEncoderLoss)."""
    return mse(recon, target, valid, rows)


def dae_loss(recon: torch.Tensor, clean_target: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             rows: Optional[Callable] = None) -> torch.Tensor:
    """Pixel MSE between the reconstruction of the corrupted frame and
    the clean frame (reference: daeLoss)."""
    return mse(recon, clean_target, valid, rows)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)): a mean over the latent dims, then over the
    batch (reference: kullbackLeiblerLoss)."""
    mu, logvar = _f32(mu), _f32(logvar)
    per_sample = -0.5 * (1.0 + logvar - mu.square() - logvar.exp()).mean(-1)
    return _batch_mean(per_sample, valid)


def vae_loss(recon: torch.Tensor, target: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, beta: float,
             valid: Optional[torch.Tensor] = None,
             rows: Optional[Callable] = None) -> torch.Tensor:
    """beta-VAE: pixel MSE + beta * KL on the VAE's slice (reference:
    vaeLoss)."""
    return mse(recon, target, valid, rows) + beta * kl_divergence(
        mu, logvar, valid)


def robotic_priors_loss(state: torch.Tensor, next_state: torch.Tensor,
                        same_action_partners: torch.Tensor,
                        same_action_mask: torch.Tensor,
                        dissimilar_partners: torch.Tensor,
                        dissimilar_mask: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The four robotic priors (reference: roboticPriorsLoss), with ds =
    s' - s and one partner j per row:

      temporal     = E[ |ds|^2 ]
      causality    = E[ exp(-|s_i - s_j|^2) ]   (same action, other reward)
      proportional = E[ (|ds_i| - |ds_j|)^2 ]    (same action)
      repeatable   = E[ exp(-|s_i - s_j|^2) |ds_i - ds_j|^2 ]  (same action)

    A pair counts only when both of its rows are valid. Returns (sum of the
    four, {term: value} with each pair term's pair count under
    ``_w/<term>``, the weight of its epoch mean)."""
    s = _f32(state)
    ds = _f32(next_state) - s
    if valid is not None:
        same_action_mask = same_action_mask * valid * \
            valid[same_action_partners]
        dissimilar_mask = dissimilar_mask * valid * valid[dissimilar_partners]
    temporal = _batch_mean(ds.square().sum(-1), valid)
    causality = _masked_mean(
        torch.exp(-(s - s[dissimilar_partners]).square().sum(-1)),
        dissimilar_mask)
    s_p = s[same_action_partners]
    ds_p = ds[same_action_partners]
    proportionality = _masked_mean(
        (_safe_norm(ds) - _safe_norm(ds_p)).square(), same_action_mask)
    sim = torch.exp(-(s - s_p).square().sum(-1))
    repeatability = _masked_mean(sim * (ds - ds_p).square().sum(-1),
                                 same_action_mask)
    terms = {
        "priors/temporal": temporal,
        "priors/causality": causality,
        "priors/proportionality": proportionality,
        "priors/repeatability": repeatability,
        "_w/priors/causality": dissimilar_mask.sum(),
        "_w/priors/proportionality": same_action_mask.sum(),
        "_w/priors/repeatability": same_action_mask.sum(),
    }
    return temporal + causality + proportionality + repeatability, terms


def forward_model_loss(pred_next: torch.Tensor, next_state: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE on the predicted next state slice (reference: forwardModelLoss)."""
    return mse(pred_next, next_state, valid)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(_f32(logits), dim=-1)
    per_sample = -logp.gather(1, labels.long()[:, None])[:, 0]
    return _batch_mean(per_sample, valid)


def inverse_model_loss(logits: torch.Tensor, actions: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the discrete actions (reference:
    inverseModelLoss)."""
    return _cross_entropy(logits, actions, valid)


def reward_model_loss(logits: torch.Tensor, reward_classes: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the reward classes (reference: rewardModelLoss)."""
    return _cross_entropy(logits, reward_classes, valid)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, margin: float = 1.0,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """max(0, d(a, p) - d(a, n) + margin) with euclidean d, whose gradient
    stays finite where a == p (reference: tripletLoss; the anchor and the
    positive are two camera views of one frame, the negative a distant
    frame)."""
    a = _f32(anchor)
    d_pos = _safe_norm(a - _f32(positive))
    d_neg = _safe_norm(a - _f32(negative))
    return _batch_mean(torch.clamp_min(d_pos - d_neg + margin, 0.0), valid)


def reward_prior_loss(state: torch.Tensor, rewards: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minus the mean over the state dims of the squared covariance of each
    dim with the reward, over the valid rows (reference:
    rewardPriorLoss)."""
    s, r = _f32(state), _f32(rewards)
    if valid is None:
        w = torch.full_like(r, 1.0 / r.shape[0])
    else:
        w = valid / valid.sum().clamp_min(1.0)
    s_c = s - (w[:, None] * s).sum(0, keepdim=True)
    r_c = r - (w * r).sum()
    cov = (w[:, None] * s_c * r_c[:, None]).sum(0)
    return -cov.square().mean()


def episode_prior_losses(disc_logits_d: torch.Tensor,
                         disc_logits_e: torch.Tensor, labels: torch.Tensor,
                         pair_valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(discriminator loss, encoder loss) of the adversarial episode prior
    (reference: episodePriorLoss): the BCE of the discriminator's logits
    on detached states against the same-episode labels, and the BCE of a
    gradient-frozen discriminator's logits against the flipped labels,
    each over the valid pairs."""
    def bce(logits, y):
        logits = _f32(logits)
        per_pair = (logits.clamp_min(0) - logits * y
                    + torch.log1p(torch.exp(-logits.abs())))
        return _batch_mean(per_pair, pair_valid)
    return bce(disc_logits_d, labels), bce(disc_logits_e, 1.0 - labels)


def perceptual_similarity_loss(feat_recon: torch.Tensor,
                               feat_target: torch.Tensor,
                               valid: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """MSE in a frozen pretrained DAE's feature space (reference:
    perceptualSimilarityLoss with --path-to-dae)."""
    return mse(feat_recon, feat_target, valid)


def supervised_loss(state: torch.Tensor, gt_states: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE to the ground-truth states (reference: models/supervised.py)."""
    return mse(state, gt_states, valid)


def l1_regularization(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Mean |p| over every element of every parameter (not the buffers:
    the JAX ``params`` tree holds no BatchNorm statistics). |p| is taken
    as ``where(p >= 0, p, -p)``: its gradient at 0 is 1, as ``jnp.abs``'s
    is, where ``torch.abs``'s is 0. The zero-initialized biases then get
    the same first update in both packages."""
    params = list(params)
    total = sum(torch.where(p >= 0, p, -p).sum() for p in params)
    return total / sum(p.numel() for p in params)


def l2_regularization(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Mean p^2 over every element of every parameter."""
    params = list(params)
    total = sum(p.square().sum() for p in params)
    return total / sum(p.numel() for p in params)
