"""The GPU-against-reference comparisons of ``chip_smoke.py`` phase (e),
as tests. They need the card and skip elsewhere; on the card:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests``."""

import pytest

import chip_smoke


@pytest.fixture
def gpu():
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]


@pytest.mark.gpu
def test_segment_add_matches_float64(gpu):
    assert chip_smoke.compare_segment_add(gpu)


@pytest.mark.gpu
def test_chamfer_matches_float64(gpu):
    assert chip_smoke.compare_chamfer(gpu)


@pytest.mark.gpu
def test_multihot_matches_explicit_gather(gpu):
    assert chip_smoke.compare_multihot(gpu)
