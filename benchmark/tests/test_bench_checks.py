"""The correctness checks on the CPU at small sizes: the program passes,
the control (the reference in the precision below the configuration's,
put in the program's place) fails, and a run whose timed path is broken
underneath comes out not correct. The harness's look for a card is
skipped (`harness.run_cell` on the CPU); everything else runs as on the
card. On the card, `card_device` runs a small cell there."""

import pytest
import torch

import _tiny
from _tiny import harness


@pytest.fixture
def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def _over(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("cell", ["north-star.generate", "paper63.generate"])
def test_generate_control_fails_program_passes(cell):
    wl, cfg = _tiny.generate_cell(cell, n_bands=3)
    driver = harness.load_module("drivers", wl["driver"])
    ctx = _tiny.ctx(cell, wl, cfg)
    state = driver.run(ctx).pop("state")
    program = driver.check(ctx, state)
    assert all(v <= lim for _, v, lim in program), program
    assert _over(driver.control(ctx, state), wl["limits"])


def test_train_control_fails_program_passes():
    wl, cfg = _tiny.train_cell()
    driver = harness.load_module("drivers", "train")
    ctx = _tiny.ctx("north-star.train", wl, cfg)
    state = driver.run(ctx).pop("state")
    program = driver.check(ctx, state)
    assert all(v <= lim for _, v, lim in program), program
    assert _over(driver.control(ctx, state), wl["limits"])


def _altered(orig):
    """The window body with every answer's first band off by 0.1%."""
    def broken(self, *args, **kwargs):
        out = orig(self, *args, **kwargs).clone()
        out[:, 0] = out[:, 0] * 1.001
        return out
    return broken


@pytest.mark.parametrize("cell", ["north-star.generate", "paper63.generate"])
def test_generate_answer_altered_is_not_correct(monkeypatch, cell):
    from synference_tpu_torch import sed

    monkeypatch.setattr(sed.BatchSEDSimulator, "photometry_zsorted_device",
                        _altered(
                            sed.BatchSEDSimulator.photometry_zsorted_device))
    wl, cfg = _tiny.generate_cell(cell)
    result, _ = _tiny.run(cell, wl, cfg)
    assert result["correct"] is False
    assert result["checks"]["flux_rel_p99"]["value"] > 1e-4


def test_generate_unsorted_draw_is_not_correct(monkeypatch):
    from synference_tpu_torch import library

    orig = library.LibraryGenerator._draw_sorted

    def unsorted(self, n, batch_size, seed):
        theta, *rest = orig(self, n, batch_size, seed)
        return (theta.flip(0), *rest)

    monkeypatch.setattr(library.LibraryGenerator, "_draw_sorted", unsorted)
    wl, cfg = _tiny.generate_cell()
    result, _ = _tiny.run("north-star.generate", wl, cfg)
    assert result["correct"] is False
    assert result["checks"]["z_order_breaks"]["value"] > 0


def test_train_state_left_unchanged_is_not_correct(monkeypatch):
    from synference_tpu_torch import train

    monkeypatch.setattr(train, "_optimizer_step", lambda *a, **k: None)
    wl, cfg = _tiny.train_cell()
    result, _ = _tiny.run("north-star.train", wl, cfg)
    assert result["correct"] is False
    assert result["checks"]["change3_leaf_gap"]["value"] > 0.5


def test_train_half_batch_is_not_correct(monkeypatch):
    from synference_tpu_torch import train

    orig = train._npe_loss

    def half_batch(flow):
        loss = orig(flow)

        def fn(p, tb, xb):
            if tb.ndim == 3:  # a training step's (K, B, ·) minibatch
                half = tb.shape[1] // 2
                return loss(p, tb[:, :half], xb[:, :half])
            return loss(p, tb, xb)
        return fn

    monkeypatch.setattr(train, "_npe_loss", half_batch)
    wl, cfg = _tiny.train_cell()
    result, _ = _tiny.run("north-star.train", wl, cfg)
    assert result["correct"] is False
    assert result["checks"]["step_loss_gap"]["value"] > 1e-3


@pytest.mark.cuda
def test_small_generate_cell_on_the_card(card_device):
    wl, cfg = _tiny.generate_cell()
    result, checks = harness.run_cell(
        "north-star.generate", 7, 0.5, False, card_device,
        __import__("time").perf_counter(), workload=wl, config=cfg,
        per_layer=[], end_to_end=harness.cell_metrics(
            harness.bench_spec(), "north-star.generate")[0])
    assert result["correct"], checks
