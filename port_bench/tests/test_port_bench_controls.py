"""The comparison that decides ``correct`` fails what it has to fail.

On the CPU, at a size a test run holds: a whole run of each cell with its
timed path broken underneath (the look for a card skipped) comes out not
correct, and so does the control (the reference in bfloat16 put in the
program's place). The ``gpu`` tests run the controls on the card at each
cell's own size (``python -m pytest -m gpu port_bench/tests`` there)."""
from __future__ import annotations

import numpy as np
import pytest

import pb_tiny
from benchlib import runner, spec


def _run(name, control=None, seconds=0.5):
    return runner.run_cell(pb_tiny.tiny_cell(name), pb_tiny.SEED, seconds,
                           False, device="cpu", control=control)


@pytest.mark.parametrize("name", pb_tiny.CELLS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", pb_tiny.CELLS)
def test_bf16_control_is_not_correct(name):
    out = _run(name, control="bf16")
    assert not out["correct"], out["checks"]


SERVE = [n for n in pb_tiny.CELLS if "serve" in n]


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_not_correct(name, monkeypatch):
    """An answer altered where it is produced: one score of every call."""
    from repro_torch.serving.engine import InferenceEngine

    real = InferenceEngine.score_batch

    def altered(self, requests, **kw):
        out = real(self, requests, **kw)
        out[0] = out[0].copy()
        out[0][0] += 1e-3
        return out

    monkeypatch.setattr(InferenceEngine, "score_batch", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    """Half of each call's requests answered by the other half's scores."""
    from repro_torch.serving.engine import InferenceEngine

    real = InferenceEngine.score_batch

    def half(self, requests, **kw):
        h = len(requests) // 2
        out = real(self, requests[:h], **kw)
        return out + [np.resize(out[i % h], r[2].shape[0])
                      for i, r in enumerate(requests[h:])]

    monkeypatch.setattr(InferenceEngine, "score_batch", half)
    assert not _run(name)["correct"]


def test_unchanged_state_is_not_correct(monkeypatch):
    """A training step that returns its state unchanged."""
    from repro_torch.train import pipeline

    monkeypatch.setattr(pipeline.JitBackend, "run",
                        lambda self, p, s, b: (p, s, pipeline.RoundMetrics(
                            examples=sum(len(x["label"]) for x in b),
                            losses=[0.69], labels=[b[0]["label"]],
                            scores=[np.full(len(b[0]["label"]), 0.5)])))
    out = _run("deepffm-100m.train-online")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > 0.5


def test_half_the_microbatch_left_out_is_not_correct(monkeypatch):
    """Each step's loss over half of its microbatch, the mean taken over
    that half."""
    from repro_torch.core import ffm

    real = ffm.bce_loss

    def half(logits, labels):
        b = logits.shape[0] // 2
        return real(logits[:b], labels[:b])

    monkeypatch.setattr(ffm, "bce_loss", half)
    assert not _run("deepffm-100m.train-online")["correct"]


# -- on the card, at each cell's own size -------------------------------------

@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' own "
                    "sizes")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("name", pb_tiny.CELLS)
def test_control_on_the_card_is_not_correct(name, control, card):
    cell = spec.load_cell(pb_tiny.ROOT / "BENCHMARK.json", name)
    if control == "tf32" and cell.config["model"] != "deepffm":
        pytest.skip("no matrix product in the plain FFM: TF32 changes nothing")
    out = runner.run_cell(cell, pb_tiny.SEED, 4.0, False, device=card,
                          control=control)  # a short window: the sample
    assert not out["correct"], out["checks"]
