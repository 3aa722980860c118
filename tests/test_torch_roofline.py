"""The port's roofline (``repro_torch.launch.roofline``): its record's
fields against the reference's ``Roofline``, the three terms and the
bottleneck of a hand-made ``Analysis`` on the H100's constants, and no
constant of the reference's TPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as r_roofline  # noqa: E402
from repro_torch.launch import op_analysis as oa  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402


def _analysis(by_class: dict, hbm_bytes: float) -> oa.Analysis:
    return oa.Analysis(flops=sum(by_class.values()), hbm_bytes=hbm_bytes, flops_by_class=dict(by_class))


def test_fields_are_a_superset_of_the_reference():
    ref = {f.name for f in dataclasses.fields(r_roofline.Roofline)}
    got = {f.name for f in dataclasses.fields(roofline.Roofline)}
    assert ref <= got and got - ref == {"flops_by_class"}
    rl = roofline.analyze(_analysis({oa.F32_CORE: 1.0}, 1.0), 1, 1.0)
    assert set(rl.to_json()) == got


def test_compute_term_sums_each_class_over_its_peak():
    # one second of each class, two of float32 CUDA-core work
    by_class = {oa.BF16_TC: 989e12, oa.F32_GEMM: 67e12, oa.TF32X3: 495e12 / 3, oa.F32_CORE: 2 * 67e12}
    rl = roofline.analyze(_analysis(by_class, 3 * 3.35e12), 1, 2.0 * sum(by_class.values()))
    assert rl.compute_s == pytest.approx(5.0, rel=1e-12)
    assert rl.memory_s == pytest.approx(3.0, rel=1e-12)
    assert rl.collective_s == 0.0 and rl.collective_bytes == 0.0
    assert rl.collective_counts == {} and rl.collective_bytes_by_kind == {}
    assert rl.bottleneck == "compute" and rl.useful_flops_ratio == pytest.approx(2.0)
    assert rl.flops_by_class == by_class


def test_memory_bottleneck_and_chips_in_the_useful_ratio():
    rl = roofline.analyze(_analysis({oa.BF16_TC: 989e12}, 10 * 3.35e12), 4, 989e12)
    assert rl.bottleneck == "memory" and rl.memory_s == pytest.approx(10.0)
    assert rl.useful_flops_ratio == pytest.approx(0.25)
    assert roofline.analyze(oa.Analysis(), 1, 0.0).useful_flops_ratio == 0.0


def test_kernel_bound_is_the_larger_term():
    by_bytes = oa.KernelCost(flops=67e9, bytes=2 * 3.35e9, cls=oa.F32_CORE)  # 2 ms vs 1 ms
    assert roofline.kernel_bound_s(by_bytes) == (pytest.approx(2e-3), "bytes")
    by_ops = oa.KernelCost(flops=3 * 495e9, bytes=3.35e9, cls=oa.TF32X3)  # 1 ms vs 9 ms
    assert roofline.kernel_bound_s(by_ops) == (pytest.approx(9e-3), "operations")
    assert roofline.kernel_bound_s(by_ops, roofline.PEAK_FLOPS_F32)[0] == pytest.approx(3 * 495e9 / 67e12)


def test_constants_are_the_h100s_not_the_tpus():
    numbers = {v for k, v in vars(roofline).items() if k.isupper() and isinstance(v, (int, float))}
    numbers |= set(roofline.PEAK_BY_CLASS.values())
    for tpu in (r_roofline.PEAK_FLOPS_BF16, r_roofline.HBM_BW, r_roofline.ICI_LINK_BW):
        assert tpu not in numbers
    assert (roofline.HBM_BW, roofline.PEAK_FLOPS_BF16, roofline.PEAK_FLOPS_TF32) == (3.35e12, 989e12, 495e12)
    assert (roofline.PEAK_FLOPS_F32, roofline.NVLINK_BW) == (67e12, 450e9)
    assert set(roofline.PEAK_BY_CLASS) == set(oa.FLOP_CLASSES)
