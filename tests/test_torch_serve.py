"""The port's VideoSearchServer against the reference server, the
serving invariants inside the port, the device contract of the entry
points, and the import isolation of the port and of ``chip_smoke.py``.

Small geometry: frames 20x24, kernels 7x9x4 (O <= 3), 16-frame windows,
40-frame streams.  The reference runs its Pallas kernels in interpret
mode, the port its plain torch versions (``device="cpu"``).  Scores
agree to relative L2 <= 1e-5 (<= 1e-3 with bf16 gratings); peak frames
exactly, except where the reference's own two best scores lie within
1e-5 relative (counted).  Inside the port the rungs agree bitwise.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)
# full float32 in any matmul / convolution a test reaches (cuDNN defaults to TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro.core import fidelity as r_fid  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro_torch.core import fidelity as t_fid  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.resilience import TenantQuarantined  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_HW = (20, 24)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


TENANTS = [
    ("alpha", "ideal", 3),
    ("beta", "physical", 2),
    ("gamma", "slm_quantize", 3),
]


def _pipe(mod, name):
    return {
        "ideal": mod.ideal,
        "physical": mod.physical,
        "slm_quantize": lambda: mod.pipeline(mod.SLMQuantize()),
    }[name]()


@pytest.fixture
def setup(rng):
    kernels = {n: rng.randn(o, 1, 7, 9, 4).astype(np.float32) for n, _, o in TENANTS}
    a = rng.rand(1, 1, 20, 24, 40).astype(np.float32)
    b = rng.rand(2, 1, 20, 24, 40).astype(np.float32)
    c = rng.rand(1, 1, 20, 24, 40).astype(np.float32)
    # beta and gamma (same encode semantics, one pool group) share clip a
    # (dedup); alpha stacks b and c
    requests = [("alpha", b), ("gamma", a), ("beta", a), ("alpha", c)]
    return kernels, requests


def _servers(kernels, store="float32"):
    kw = dict(window_frames=16, chunk_windows=2, readout_topk=2, grating_dtype=store)
    ref = r_serve.VideoSearchServer(frame_hw=FRAME_HW, cfg=r_serve.VideoSearchConfig(use_pallas=True, **kw))
    port = t_serve.VideoSearchServer(frame_hw=FRAME_HW, cfg=t_serve.VideoSearchConfig(device="cpu", **kw))
    for name, fid, _ in TENANTS:
        ref.add_tenant(name, kernels[name], fidelity=_pipe(r_fid, fid))
        port.add_tenant(name, kernels[name], fidelity=_pipe(t_fid, fid))
    return ref, port


@pytest.mark.parametrize("pooled", [True, False])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_search_batch_matches_reference(pooled, store, setup):
    kernels, requests = setup
    tol = 1e-5 if store == "float32" else 1e-3
    ref, port = _servers(kernels, store)
    got = port.search_batch(requests, pooled=pooled)
    want = ref.search_batch(requests, pooled=pooled)
    excused = 0
    for g, w in zip(got, want):
        assert g["tenant"] == w["tenant"] and g["windows"] == w["windows"]
        assert g["scores"].shape == w["scores"].shape
        assert rel_l2(g["scores"], w["scores"]) < tol
        ts = np.asarray(w["topk_scores"])
        near = np.abs(ts[..., 0] - ts[..., 1]) <= 1e-5 * np.abs(ts[..., 0])
        excused += int(near.sum())
        assert np.array_equal(np.asarray(g["peak_frame"])[~near], np.asarray(w["peak_frame"])[~near])
    assert excused <= 1
    m = port.metrics()
    assert m["queries"] == len(requests)
    assert m["frames_total"] == ref.metrics()["frames_total"]
    assert m["windows_total"] == ref.metrics()["windows_total"]
    if pooled:
        assert m["pooled_dispatches"] == 1 and m["dedup"]["rows_saved"] == 1
    else:
        assert m["sequential_dispatches"] == 3


def test_rungs_and_readouts_agree_bitwise(setup):
    kernels, requests = setup
    _, port = _servers(kernels)
    pooled = port.search_batch(requests)
    seq = port.search_batch(requests, pooled=False)
    stitched = port.search_batch(requests, return_volume=True)
    undeduped = port.search_batch(requests, dedup=False)
    single = [port.search(clip, tenant=t) for t, clip in requests]
    for rows in (seq, stitched, undeduped, single):
        for a, b in zip(pooled, rows):
            assert np.array_equal(a["scores"], b["scores"])
            assert np.array_equal(a["peak_frame"], b["peak_frame"])
    for s in stitched:
        vol = s["volume"]
        flat = vol.reshape(vol.shape[0], vol.shape[1], -1)
        assert np.array_equal(torch.amax(flat, -1).numpy(), s["scores"])
        assert np.array_equal((torch.argmax(flat, -1) % vol.shape[-1]).numpy(), s["peak_frame"])
    assert pooled[0]["topk_scores"].shape == (2, 3, 2)


def test_bounded_buffer_server_matches_unbounded(setup):
    kernels, requests = setup
    _, port = _servers(kernels)
    cfg = t_serve.VideoSearchConfig(
        device="cpu", window_frames=16, chunk_windows=2, max_buffer_windows=1
    )
    small = t_serve.VideoSearchServer(frame_hw=FRAME_HW, cfg=cfg)
    for name, fid, _ in TENANTS:
        small.add_tenant(name, kernels[name], fidelity=_pipe(t_fid, fid))
    for a, b in zip(port.search_batch(requests), small.search_batch(requests)):
        assert np.array_equal(a["scores"], b["scores"])
        assert np.array_equal(a["peak_frame"], b["peak_frame"])


def test_guard_quarantines_only_the_poisoned_request(setup):
    kernels, requests = setup
    _, port = _servers(kernels)
    clean = port.search_batch(requests)
    bad = requests[3][1].copy()
    bad[0, 0, 3, 4, 10] = np.nan
    out = port.search_batch(requests[:3] + [("beta", bad)])
    assert isinstance(out[3], TenantQuarantined) and out[3].tenant == "beta"
    for a, b in zip(clean[:3], out[:3]):
        assert np.array_equal(a["scores"], b["scores"])
    assert port.metrics()["quarantined"] == 1
    with pytest.raises(TenantQuarantined):
        port.search(bad, tenant="beta")


def test_tenant_management_and_validation(setup, rng):
    kernels, requests = setup
    _, port = _servers(kernels)
    assert sorted(port.tenants) == ["alpha", "beta", "gamma"]
    with pytest.raises(KeyError):
        port.search_batch([("nobody", requests[0][1])])
    with pytest.raises(ValueError):
        port.search_batch([("alpha", np.zeros((1, 1, 21, 24, 40), np.float32))])
    with pytest.raises(ValueError):
        port.search_batch([("alpha", np.zeros((1, 1, 20, 24, 3), np.float32))])
    with pytest.raises(ValueError):
        port.add_tenant("huge", rng.randn(1, 1, 30, 9, 4).astype(np.float32))
    port.search_batch(requests)
    before = port.metrics()["frames_total"]
    port.remove_tenant("alpha")
    assert port.metrics()["frames_total"] == before  # retired traffic stays
    with pytest.raises(KeyError):
        port.remove_tenant("alpha")
    assert port.metrics()["cache"]["entries"] == 2


def test_entry_points_need_a_device(setup):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.VideoSearchServer(frame_hw=FRAME_HW)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.VideoSearchConfig()
    # a CPU server's default mesh would lie on the card
    with pytest.raises(ValueError, match="device type 'cpu'"):
        t_serve.VideoSearchConfig(device="cpu", mesh_shape=(1, 1))
    server = t_serve.VideoSearchServer(
        kernels=setup[0]["alpha"], frame_hw=FRAME_HW,
        cfg=t_serve.VideoSearchConfig(device="cpu", window_frames=16),
    )
    clip = setup[1][0][1]
    out = server.search(clip)
    assert out["scores"].shape == (clip.shape[0], 3) and np.isfinite(out["scores"]).all()
    assert server.metrics()["device"] == "cpu"


def test_serve_main_runs_on_cpu(capsys):
    t_serve.main(["--device", "cpu", "--frames", "24"])
    out = capsys.readouterr().out
    assert "events-physical (physical)" in out and "on cpu" in out


_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_module")
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
assert not bad, bad
new = ("repro_torch.kernels.conv3d.kernel", "repro_torch.kernels.conv3d.ops",
       "repro_torch.kernels.conv3d.ref", "repro_torch.data.kth_synthetic",
       "repro_torch.core.hybrid", "repro_torch.distributed.fault",
       "repro_torch.optim.adamw", "repro_torch.optim.schedule",
       "repro_torch.optim.compression", "repro_torch.launch.train_hybrid",
       "repro_torch.checkpoint.checkpoint", "repro_torch.launch.replica",
       "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
       "repro_torch.models.zamba", "repro_torch.configs.zamba2_2_7b",
       "repro_torch.models.moe", "repro_torch.models.mla",
       "repro_torch.configs.arctic_480b", "repro_torch.configs.deepseek_v2_lite_16b",
       "repro_torch.models.whisper", "repro_torch.models.vlm",
       "repro_torch.configs.whisper_tiny", "repro_torch.configs.internvl2_2b",
       "repro_torch.launch.train", "repro_torch.launch.specs", "repro_torch.data.tokens")
assert all(m in sys.modules for m in new), [m for m in new if m not in sys.modules]
print("isolated", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isolated" in proc.stdout


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(os.path.join(REPO, "chip_smoke.py"), REPO), (str(lone), str(tmp_path))]
    for script, cwd in runs:
        proc = subprocess.run(
            [sys.executable, script], capture_output=True, text=True, cwd=cwd,
            env=env, timeout=120,
        )
        if torch.cuda.is_available() and cwd == REPO:
            continue
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
