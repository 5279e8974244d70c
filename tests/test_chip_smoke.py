"""chip_smoke.py: its phases at a tiny size (the card run uses the same
functions at full size), and its refusal to run without a GPU."""

import pytest

import chip_smoke


def test_main_refuses_without_gpu(capsys, gpu_absent):
    assert chip_smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def gpu_absent():
    import jax
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")


@pytest.mark.parametrize("platform", ["cpu",
                                      pytest.param("gpu",
                                                   marks=pytest.mark.gpu)])
def test_smoke_phases_tiny(platform, request, tmp_path):
    if platform == "gpu":
        request.getfixturevalue("gpu")
    w = chip_smoke.make_worlds(str(tmp_path), 96, chr21_bp=120_000,
                               easy_bp=60_000)
    runs = chip_smoke.phase_multigenome(w, threads=2, batch=64)
    assert runs["queued"]["stats"].get("iters", 0) > 0
    assert runs["fixed"]["stats"]["tiers"]
    chip_smoke.phase_aln2sam(w)
    chip_smoke.phase_single_and_precalc(w, 2, batch=64, modes=("-S",))
    s = chip_smoke.phase_trace(
        w, 2, batch=64,
        device_prefix="/device:GPU" if platform == "gpu" else "/host:CPU")
    assert s["iters"] > 0 and s["n_ops"] > 0 and s["top"]
    assert 0.0 <= s["idle_share"] <= 1.0
