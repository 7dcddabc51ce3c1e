"""The inputs that the harness hands a training cell's reference
(harness/train_cell.py ``reference_step``), built out of the dataset from
the rows a probe step read, by the zoo's pairing of a frame with its
successor in its episode.

At the tests' size, for config 4's losses (BASELINE.json "SRL Splits":
``autoencoder:1:100 inverse:2:50 forward:1:25 reward:1:25``, a
configuration of these tests and no cell), the harness's next frames,
actions and reward classes are those that the port's step read. At an
episode's last frame the zoo and the port part: the zoo pairs it with
nothing, the port's loader with the next row."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import core, data, train_cell
from portbench.tests.helpers import TINY, tiny_cell

CONFIG4 = {"losses": ["autoencoder:1:100", "inverse:2:50", "forward:1:25",
                      "reward:1:25"]}


class Transitions:
    """A reference that reads every input of a transition."""
    INPUTS = ("obs", "next", "actions", "reward_classes")


def _u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames of the port's "tf"-normalized ones (x * 2/255 - 1)."""
    return torch.round((x.double() + 1.0) * 127.5).to(torch.uint8)


def test_every_reference_names_inputs_the_harness_builds():
    manifest = core.load_manifest()
    built = {"obs", "pos", "neg", "next", "actions", "reward_classes"}
    for c in manifest["configs"]:
        arch = core.load_arch(core.load_config(manifest, c["name"])["arch"])
        assert arch.INPUTS and set(arch.INPUTS) <= built, c["name"]


def test_config4_inputs_are_what_the_port_read(tmp_path, monkeypatch):
    """The probe's validation pass and three train steps of config 4,
    each step's next frames, actions and reward classes recorded where
    the port's step takes them (``train_step._draws``), against the
    harness's of the same rows."""
    from srl_zoo_tpu_torch.training import train_step as ts
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    cell = tiny_cell("cnn_ae.resident", **CONFIG4)
    # the learner's own weights: the inputs do not depend on them
    cfg = train_cell.srl_config(cell, str(tmp_path))
    dataset = data.make_dataset(cell.config, cell.seed, cell.device)
    learner = SRL4robotics(cfg, log_folder=str(tmp_path), device=cell.device)
    assert cfg.needs_next_obs and cfg.use_reward and cfg.use_inverse
    seen = {True: [], False: []}
    orig = ts._draws

    def draws(model, images, tensors, valid, generator, corruption):
        seen[model.training].append(
            (images[1].detach().clone(),
             {k: v.detach().clone() for k, v in tensors.items()},
             valid.detach().clone() > 0))
        return orig(model, images, tensors, valid, generator, corruption)
    monkeypatch.setattr(ts, "_draws", draws)
    got = train_cell.probe(learner, dataset, cfg)
    reads = dataclasses.replace(cell, arch=Transitions)
    for train, steps in ((True, got["steps"]), (False, got["eval_steps"])):
        assert len(seen[train]) == len(steps) > 0
        for (next_obs, tensors, valid), rows in zip(seen[train], steps):
            assert (valid.numpy() == rows["valid"]).all()
            real = rows["rows"][rows["valid"]]
            # the stated rule: within an episode the successor is i + 1
            assert (train_cell.successors(dataset, real) == real + 1).all()
            step = train_cell.reference_step(reads, dataset, rows)
            assert torch.equal(step["obs"], torch.from_numpy(
                dataset.frames[real]))
            assert torch.equal(step["next"], _u8(next_obs[valid]))
            assert torch.equal(step["actions"], tensors["actions"][valid])
            assert torch.equal(step["reward_classes"],
                               tensors["reward_classes"][valid])


@pytest.fixture
def dataset():
    cfg = dict(core.load_config(core.load_manifest(), "cnn_ae_224"), **TINY)
    return data.make_dataset(cfg, 11, torch.device("cpu"))


def test_an_episodes_last_frame_has_no_successor(dataset):
    """Row 95 ends the first episode of 96 and row 383 the dataset: the
    zoo pairs neither with a successor, so a reference of transitions is
    handed row 10 alone; the port's loader pairs them with rows 96 and
    383 (``min(i + 1, N - 1)``), but never trains on them (its
    ``training_indices`` leave them out)."""
    from srl_zoo_tpu_torch.data.loader import DataLoader
    rows = np.array([10, 95, 383])
    assert train_cell.successors(dataset, rows).tolist() == [11, -1, -1]
    loader = DataLoader(dataset, rows, 3, shuffle=False, wraparound=False,
                        next_obs=True)
    batch = next(iter(loader))
    assert batch["reward_classes"].tolist() == \
        dataset.reward_classes[[11, 96, 383]].tolist()
    assert not np.isin(rows[1:], dataset.training_indices()).any()
    probe = {"rows": rows, "neg_rows": None, "valid": np.ones(3, bool)}
    cell = tiny_cell("cnn_ae.resident")
    step = train_cell.reference_step(
        dataclasses.replace(cell, arch=Transitions), dataset, probe)
    assert torch.equal(step["obs"], torch.from_numpy(dataset.frames[[10]]))
    assert torch.equal(step["next"], torch.from_numpy(dataset.frames[[11]]))
    assert step["actions"].tolist() == [int(dataset.actions[10])]
    classes = np.searchsorted(np.unique(dataset.rewards), dataset.rewards)
    assert step["reward_classes"].tolist() == [int(classes[11])]
    assert step["reward_classes"].dtype == torch.int64
    # a reference of frames alone keeps every real row
    plain = train_cell.reference_step(cell, dataset, probe)
    assert list(plain) == ["obs"] and plain["obs"].shape[0] == 3


def test_padding_rows_are_left_out(dataset):
    rows = {"rows": np.array([3, 4, 0, 0]), "neg_rows": None,
            "valid": np.array([True, True, False, False])}
    cell = dataclasses.replace(tiny_cell("cnn_ae.resident"),
                               arch=Transitions)
    step = train_cell.reference_step(cell, dataset, rows)
    assert step["actions"].tolist() == dataset.actions[[3, 4]].tolist()
    assert torch.equal(step["next"], torch.from_numpy(dataset.frames[[4, 5]]))


def test_the_references_of_the_cells_get_what_they_got_before(dataset):
    """The autoencoder reads its anchors' frames; the triplet its
    anchors' two views and its negatives' frames, a black frame for a
    negative that is no row of the dataset; padding rows left out."""
    rows = {"rows": np.array([3, 95, 0]), "neg_rows": np.array([50, -1, 7]),
            "valid": np.array([True, True, False])}
    dataset.frames_2 = dataset.frames[::-1].copy()
    ae = train_cell.reference_step(tiny_cell("cnn_ae.resident"), dataset,
                                   rows)
    assert list(ae) == ["obs"]
    assert torch.equal(ae["obs"], torch.from_numpy(dataset.frames[[3, 95]]))
    tri = train_cell.reference_step(tiny_cell("resnet_triplet.resident"),
                                    dataset, rows)
    assert list(tri) == ["obs", "pos", "neg"]
    assert torch.equal(tri["obs"], ae["obs"])
    assert torch.equal(tri["pos"], torch.from_numpy(
        dataset.frames_2[[3, 95]]))
    assert torch.equal(tri["neg"][0], torch.from_numpy(dataset.frames[50]))
    assert not tri["neg"][1].any()
