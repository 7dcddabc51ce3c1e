"""The losses and heads of configs 2-4 (beta-VAE, robotic priors, SRL
splits with forward / inverse / reward heads) against the JAX package, on
the CPU.

Inputs come from numpy with a seed. Tolerances, each with its reason:

* loss values within 1e-6 relative and their gradients within 1e-5 of
  each input's largest gradient: the same elementwise formulas, reduced
  over a few hundred f32 elements in another order;
* heads on bridged JAX weights within 1e-6 of the largest output (one or
  three small f32 products);
* a converted JAX config-4 run folder: states and head outputs within
  1e-4 absolute (f32 convolutions sum in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu.losses import functions as JF
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.losses import functions as F


B, D = 16, 6
SPLITS = (("autoencoder", 1.0, 4), ("inverse", 2.0, 2), ("forward", 1.0, 1),
          ("reward", 1.0, 1))


def _floats(seed, **shapes):
    rng = np.random.RandomState(seed)
    return {k: (0.5 * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _pairs(seed):
    """Partners and 0/1 masks as the loader ships them, some masked."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in ("same_action", "dissimilar"):
        out[f"{name}_partners"] = rng.randint(0, B, B).astype(np.int32)
        out[f"{name}_mask"] = (rng.rand(B) < 0.7).astype(np.float32)
    return out


def _case(name, seed):
    """(float inputs, other inputs, jax fn, port fn) of one loss."""
    rng = np.random.RandomState(seed + 1)
    if name == "kl_divergence":
        return (_floats(seed, mu=(B, D), logvar=(B, D)), {},
                JF.kl_divergence, F.kl_divergence)
    if name == "vae_loss":
        return (_floats(seed, recon=(B, 8, 8, 3), target=(B, 8, 8, 3),
                        mu=(B, D), logvar=(B, D)), {"beta": 0.5},
                JF.vae_loss, F.vae_loss)
    if name == "robotic_priors_loss":
        fl = _floats(seed, state=(B, D), next_state=(B, D))
        fl["next_state"][3] = fl["state"][3]  # a wall-blocked step: ds = 0
        return (fl, _pairs(seed), lambda **kw: JF.robotic_priors_loss(**kw),
                lambda **kw: F.robotic_priors_loss(**kw))
    if name == "forward_model_loss":
        return (_floats(seed, pred_next=(B, D), next_state=(B, D)), {},
                JF.forward_model_loss, F.forward_model_loss)
    if name == "inverse_model_loss":
        return (_floats(seed, logits=(B, 4)),
                {"actions": rng.randint(0, 4, B).astype(np.int32)},
                JF.inverse_model_loss, F.inverse_model_loss)
    return (_floats(seed, logits=(B, 3)),
            {"reward_classes": rng.randint(0, 3, B).astype(np.int32)},
            JF.reward_model_loss, F.reward_model_loss)


def _split(value):
    """(scalar total, {term: value}) of a loss that may return terms."""
    return value if isinstance(value, tuple) else (value, {})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", [
    "kl_divergence", "vae_loss", "robotic_priors_loss", "forward_model_loss",
    "inverse_model_loss", "reward_model_loss"])
def test_loss_matches_jax(name, masked):
    floats, other, jax_fn, port_fn = _case(name, 20)
    valid = None
    if masked:
        valid = np.ones(B, np.float32)
        valid[-2:] = 0.0
    names = sorted(floats)

    def jax_total(*args):
        kw = dict(zip(names, args))
        kw.update({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                   for k, v in other.items()})
        total, terms = _split(jax_fn(
            **kw, valid=None if valid is None else jnp.asarray(valid)))
        return total, terms

    (want, want_terms), want_grads = jax.value_and_grad(
        jax_total, argnums=tuple(range(len(names))), has_aux=True)(
        *[jnp.asarray(floats[k]) for k in names])
    tensors = {k: torch.from_numpy(floats[k]).requires_grad_()
               for k in names}
    kw = dict(tensors)
    kw.update({k: torch.from_numpy(v).long() if isinstance(v, np.ndarray)
               and v.dtype == np.int32 else
               torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in other.items()})
    got, terms = _split(port_fn(
        **kw, valid=None if valid is None else torch.from_numpy(valid)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert set(terms) == set(want_terms)
    for k, v in want_terms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    got.backward()
    for k, g in zip(names, want_grads):
        grad = tensors[k].grad.numpy()
        assert np.isfinite(grad).all(), k
        scale = max(float(np.abs(np.asarray(g)).max()), 1e-30)
        assert np.abs(grad - np.asarray(g)).max() <= 1e-5 * scale, k


# ---------------------------------------------------------------------------
# heads, and a JAX config-4 run folder, from bridged weights
# ---------------------------------------------------------------------------

def _config4(mlp: bool) -> JaxConfig:
    return JaxConfig(state_dim=8, img_height=32, img_width=32, batch_size=B,
                     losses=tuple((n, w) for n, w, _ in SPLITS),
                     split_dims=tuple((n, d) for n, _, d in SPLITS),
                     n_actions=4, n_reward_classes=3,
                     inverse_model_type="mlp" if mlp else "linear")


@pytest.fixture(scope="module", params=[False, True], ids=["linear", "mlp"])
def config4_state(request):
    """A JAX config-4 model (its init) and the port model with its
    bridged weights."""
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    from srl_zoo_tpu.training.state import create_train_state
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    jcfg = _config4(request.param)
    state = jax.jit(lambda k: create_train_state(jcfg, k)[1])(
        jax.random.PRNGKey(6))
    sd, skipped = bridge.state_dict_from_jax(
        jax.device_get(state.params), jax.device_get(state.batch_stats))
    assert skipped == []
    model = SRLModules(SRLConfig.from_exp_config(jcfg.to_exp_config()))
    model.load_state_dict(sd)
    return jcfg, JaxModules(jcfg), state, model.eval()


def test_heads_match_jax(config4_state):
    jcfg, jmodel, state, model = config4_state
    rng = np.random.RandomState(21)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    for name, head in (("forward", "forward_model"),
                       ("inverse", "inverse_model"),
                       ("reward", "reward_model")):
        width = jcfg.slices[name][1]
        s, s2 = rng.randn(2, B, width).astype(np.float32)
        second = rng.randint(0, 4, B).astype(np.int32) \
            if name == "forward" else s2
        want = jmodel.apply(variables, jnp.asarray(s), jnp.asarray(second),
                            method=lambda m, a, b, h=head: getattr(m, h)(a, b))
        got = getattr(model, head)(torch.from_numpy(s),
                                   torch.from_numpy(second)).detach().numpy()
        assert got.shape == want.shape, head
        err = np.abs(got - np.asarray(want)).max()
        assert err <= 1e-6 * np.abs(np.asarray(want)).max(), (head, err)


def test_jax_config4_run_converts_and_matches(config4_state, tmp_path):
    from srl_zoo_tpu.training import checkpoint as jax_ckpt
    from srl_zoo_tpu_torch.checkpoint import load_srl_model
    jcfg, jmodel, state, _ = config4_state
    run = str(tmp_path / "run")
    jcfg.save(run)
    jax_ckpt.save_srl_model(run, state.params, state.batch_stats)
    path, skipped = bridge.convert_run(run)
    assert skipped == [] and os.path.exists(path)
    _, model = load_srl_model(run, torch.device("cpu"))
    frames = np.random.RandomState(22).randint(0, 256, (6, 32, 32, 3))
    obs = (frames / 127.5 - 1.0).astype(np.float32)
    nxt = obs[::-1].copy()
    actions = np.arange(6, dtype=np.int32) % 4
    want = jmodel.apply({"params": state.params,
                         "batch_stats": state.batch_stats},
                        jnp.asarray(obs), jnp.asarray(nxt),
                        jnp.asarray(actions), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(obs), torch.from_numpy(nxt),
                    torch.from_numpy(actions))
    for k in ("state", "next_state", "forward_pred", "inverse_logits",
              "reward_logits", "recon"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
