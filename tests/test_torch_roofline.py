"""The port's roofline terms (``repro_torch.launch.roofline``):
``model_flops`` equal to the reference's for every configuration, and
``kernel_roofline``, ``roofline_terms`` and ``peak_hbm_bandwidth`` under
the H100's data-sheet rates."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JREGISTRY               # noqa: E402
from repro.launch import roofline as jroof                    # noqa: E402
from repro_torch.configs import REGISTRY                      # noqa: E402
from repro_torch.launch import roofline                       # noqa: E402


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_model_flops_match_the_reference(name):
    for kind, tokens in (("train", 8 * 2048), ("serve", 8 * 512)):
        assert roofline.model_flops(REGISTRY[name], tokens, kind) == \
            jroof.model_flops(JREGISTRY[name], tokens, kind)


def test_kernel_roofline_and_terms_under_the_h100_rates():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert roofline.peak_hbm_bandwidth("cuda") == 3.35e12
    assert roofline.peak_hbm_bandwidth("gpu") == 3.35e12
    assert roofline.peak_hbm_bandwidth("cpu") == 4e10
    assert roofline.peak_hbm_bandwidth("tpu") == 4e10     # unknown: the CPU
    want_none = 3.35e12 if torch.cuda.is_available() else 4e10
    assert roofline.peak_hbm_bandwidth(None) == want_none
    r = roofline.kernel_roofline(4.0e9, 2e-3, "cuda")
    assert r["achieved_gbs"] == pytest.approx(2000.0)
    assert r["peak_gbs"] == pytest.approx(3350.0)
    assert r["frac_of_peak"] == pytest.approx(2e12 / 3.35e12)
    assert roofline.kernel_roofline(1.0, 0.0, "cuda")["frac_of_peak"] == 0.0
    t = roofline.roofline_terms(989e12, 3.35e12 / 2, 450e9 / 4, chips=4)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(0.25)
    assert t["dominant"] == "compute" and t["bound_s"] == t["compute_s"]
    t = roofline.roofline_terms(0.0, 6.7e12, 0.0, chips=1)
    assert t["dominant"] == "memory" and t["bound_s"] == pytest.approx(2.0)
