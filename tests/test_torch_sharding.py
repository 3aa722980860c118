"""The port's logical-axis sharding rules (``repro_torch.distributed.
sharding``) against the reference's: the four spec cases and the
divisibility property of ``tests/test_sharding.py``, each resolved by
both packages through one duck-typed mesh (the reference's ``spec_for``
reads only ``mesh.shape``), plus the serving rules and a tree of specs.
"""

import types

import numpy as np
import pytest
from _hypo import given, settings, st

torch = pytest.importorskip("torch")

from repro.distributed import sharding as r_shd  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402


def _mesh(**axes):
    return types.SimpleNamespace(shape=dict(axes))


def _both(shape, axes, mesh, mode="train", multi_pod=False):
    """The port's spec and the reference's, for one shape."""
    got = shd.spec_for(shape, axes, shd.make_rules(mode, multi_pod), mesh)
    want = r_shd.spec_for(shape, axes, r_shd.make_rules(mode, multi_pod), mesh)
    assert got == tuple(want)
    return got


def test_spec_resolution_basic():
    assert _both((4096, 14336), ("embed", "mlp"), _mesh(data=16, model=16)) == ("data", "model")


def test_spec_drops_non_divisible():
    # 12 heads don't divide 16 → dropped; 8960 d_ff divides → kept
    spec = _both((12, 8960), ("kv_heads", "mlp"), _mesh(data=16, model=16))
    assert spec == (None, "model")


def test_spec_no_duplicate_mesh_axis():
    spec = _both((64, 32), ("embed", "embed"), _mesh(data=16, model=16))
    assert spec == ("data", None)  # second use dropped


def test_multi_pod_batch_axes():
    spec = _both((256, 4096), ("batch", None), _mesh(pod=2, data=16, model=16), multi_pod=True)
    assert spec[0] == ("pod", "data")


@settings(max_examples=20, deadline=None)
@given(
    dim=st.integers(1, 4096),
    axis=st.sampled_from(["embed", "mlp", "heads", "vocab", None]),
)
def test_spec_always_divides(dim, axis):
    """Whatever the dim, the resolved sharding divides it exactly, and
    equals the reference's."""
    mesh = _mesh(data=16, model=16)
    part = _both((dim,), (axis,), mesh)[0]
    if part is None:
        return
    size = 1
    for a in (part if isinstance(part, tuple) else (part,)):
        size *= mesh.shape[a]
    assert dim % size == 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_serving_rules_match_reference(multi_pod):
    """The serving rules, and the arena / stream-batch specs they give on
    a port LocalMesh (the engine tiles its arena by the first)."""
    assert shd.make_serving_rules(multi_pod) == r_shd.make_serving_rules(multi_pod)
    assert shd.make_rules("decode", multi_pod) == r_shd.make_rules("decode", multi_pod)
    mesh = make_local_mesh(2, 4, devices=("cpu",) * 8)
    rules = shd.make_serving_rules()
    assert shd.spec_for((36, 1, 90, 119, 36), ("grating",) + (None,) * 4, rules, mesh) == (
        "model", None, None, None, None,
    )
    assert shd.spec_for((6, 1, 60), ("stream_batch", None, None), rules, mesh) == ("data", None, None)
    assert shd.spec_for((5, 1, 60), ("stream_batch", None, None), rules, mesh) == (None, None, None)
    assert shd._axis_size(mesh, ("data", "model")) == 8 and shd._axis_size(mesh, None) == 1


def test_tree_specs_match_reference():
    mesh = _mesh(data=4, model=2)
    params = {"w": np.zeros((8, 6)), "blocks": [torch.zeros(4, 3), np.zeros(5)]}
    axes = {"w": ("embed", "mlp"), "blocks": [("embed", "heads"), ("vocab",)]}
    got = shd.tree_specs(params, axes, shd.make_rules(), mesh)
    want = r_shd.tree_specs(
        {"w": params["w"], "blocks": [np.zeros((4, 3)), params["blocks"][1]]},
        axes, r_shd.make_rules(), mesh,
    )
    assert got["w"] == tuple(want["w"]) == ("data", "model")
    assert [tuple(s) for s in got["blocks"]] == [tuple(s) for s in want["blocks"]]
    assert shd.is_axes_leaf(("embed", None)) and not shd.is_axes_leaf(["embed"])
