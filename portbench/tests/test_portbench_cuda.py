"""The tiny cells on the card, through the port's CUDA kernels. Skips
without a card; on the card: python -m pytest --noconftest -m cuda portbench/tests"""

import pytest

from portbench.tests.tiny import tiny_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("name", ["sift1m_ivfpq.batch256", "openai1536_ivfpq.filtered256",
                                  "sift1m_ivfpq.build"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, name, trace):
    import lancedb_tpu_torch
    from portbench import run

    result, lines = run.run_cell(tiny_cell(name), 2**31 + 99, 1.0, trace, card,
                                 lancedb_tpu_torch.connect)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert result["device"]["busy_s"] > 0 and "breakdown" in result
