"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, under the committed limits. The faults the cells
can have: a step that returns its state unchanged, half of the batch (the
image's rows) left out with the mean taken over the rest, and an answer
(a rendered frame) altered where it is produced. Each cell runs on one
card, so no exchange between cards can be left out."""

import dataclasses

import pytest

from benchmark import harness
from benchmark.tests.conftest import SEED, TRAIN_CELLS, tiny_config, tiny_mix

from priordepth_gaussiansplatting_torch.ops import losses
from priordepth_gaussiansplatting_torch.train import step as step_lib

SPEC = harness.load_spec()
CELLS = {w["name"]: w for w in SPEC["workloads"] + TRAIN_CELLS}


def _run(workload: str, config: str, mix: str) -> dict:
    return harness.run_cell(SPEC, CELLS[workload], SEED, 0.5, False, 0.0,
                            device="cpu", cfg=tiny_config(config),
                            mix=tiny_mix(mix))


TRAIN = [("m360-mean-3m.train", "m360-mean-3m"),
         ("tandt-truck-1.7m.train", "tandt-truck-1.7m")]
RENDER = [("m360-mean-3m.render", "m360-mean-3m"),
          ("tandt-truck-1.7m.render", "tandt-truck-1.7m")]


@pytest.mark.parametrize("workload, config", TRAIN)
def test_a_sound_training_run_is_correct(workload, config):
    assert _run(workload, config, "train_steady")["correct"]


@pytest.mark.parametrize("workload, config", RENDER)
def test_a_sound_render_run_is_correct(workload, config):
    assert _run(workload, config, "render_closed")["correct"]


@pytest.mark.parametrize("workload, config", TRAIN)
def test_a_step_returning_its_state_unchanged(workload, config, monkeypatch):
    real = step_lib.make_train_step

    def make(*args, **kwargs):
        fns = real(*args, **kwargs)

        def step(state, opt_state, *rest):
            _, _, metrics = fns.step(state, opt_state, *rest)
            return state, opt_state, metrics

        return dataclasses.replace(fns, step=step)

    monkeypatch.setattr(step_lib, "make_train_step", make)
    out = _run(workload, config, "train_steady")
    assert not out["correct"]
    assert out["checked"]["change_gap"]["value"] > 0.99


@pytest.mark.parametrize("workload, config", TRAIN)
def test_half_of_the_batch_left_out(workload, config, monkeypatch):
    l1, ssim = losses.l1_loss, losses.ssim

    def top(x):
        return x[:, :x.shape[1] // 2]

    monkeypatch.setattr(losses, "l1_loss", lambda a, b: l1(top(a), top(b)))
    monkeypatch.setattr(losses, "ssim", lambda a, b: ssim(top(a), top(b)))
    assert not _run(workload, config, "train_steady")["correct"]


@pytest.mark.parametrize("workload, config", RENDER)
def test_a_frame_altered_where_it_is_produced(workload, config, monkeypatch):
    real = step_lib.eval_image

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        img = res["render"].clone()
        img[:, 10:14, 20:24] = 1.0 - img[:, 10:14, 20:24]
        return dict(res, render=img)

    monkeypatch.setattr(step_lib, "eval_image", altered)
    assert not _run(workload, config, "render_closed")["correct"]

