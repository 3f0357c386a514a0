"""The control, the reference carried in float32 in the program's place,
fails the check that the program's answers pass; on the card at the
cells' own size too."""
import pytest
import torch

from portbench import control

from .helpers import CPU, SEED, small


@pytest.mark.parametrize("cell", ["taxi-groupby-c1", "ssb-q1-c1"])
def test_control_fails_at_two_shards(cell):
    _, cfg, mix = small(cell)
    r = control.control_readings(cfg, dict(mix, check_share=1.0),
                                 SEED, CPU, per_client=6)
    assert r["correct"] is False
    assert r["checks"]["wrong_answers"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["taxi-groupby-c1", "ssb-q1-c1"])
def test_control_fails_at_full_size(card, cell):
    _, cfg, mix = small(cell, shards=None)
    for seed in (SEED, SEED + 1, SEED + 2):
        r = control.control_readings(cfg, mix, seed, card, per_client=100)
        assert r["correct"] is False
        assert r["checks"]["wrong_answers"] > 0
        torch.cuda.empty_cache()
