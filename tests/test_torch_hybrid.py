"""The port's hybrid 3-D CNN inference path (``core/hybrid.py``, the
synthetic-KTH data and ``HybridClassifierServer``) against the JAX
reference's: the same numpy inputs and parameters go through both
packages, on the CPU (``device="cpu"``).  On the CPU the ``digital``
route runs kernel B4's plain version and the STHC routes kernel B1's;
``chip_smoke.py`` holds the kernels against those on the card.

Tolerances: logits and conv outputs by relative L2, 1e-5 for the exact
routes (direct and ideal spectral correlation in float32) and 1e-4 for
the physical stages (the SLM quantizer rounds a few values across a
level when the two frameworks' FFTs differ in the last bit).  Class
predictions must be equal except where the reference's own top-two
logits lie within 1e-4 of their scale (a near-tie either side may
break), and the count of such ties is asserted small.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests elsewhere must not starve
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import sthc_kth as r_kth_cfg  # noqa: E402
from repro.core import hybrid as r_hybrid  # noqa: E402
from repro.core.sthc import STHC as R_STHC, STHCConfig as R_STHCConfig  # noqa: E402
from repro.data import kth_synthetic as r_kth  # noqa: E402
from repro.launch.serve import HybridClassifierServer as R_Server  # noqa: E402
from repro.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import sthc_kth as t_kth_cfg  # noqa: E402
from repro_torch.core import hybrid as t_hybrid  # noqa: E402
from repro_torch.core.sthc import STHC as T_STHC, STHCConfig as T_STHCConfig  # noqa: E402
from repro_torch.data import kth_synthetic as t_kth  # noqa: E402
from repro_torch.launch.serve import HybridClassifierServer as T_Server  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_SPEC = dict(height=20, width=24, frames=10)
EXACT, PHYSICAL = 1e-5, 1e-4
TIE = 1e-4
IMPLS = ("digital", "spectral", "sthc_physical", "sthc_ideal")
STACKS = [name for name, _ in r_kth_cfg.fidelity_stacks()]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tol(impl):
    return PHYSICAL if impl == "sthc_physical" else EXACT


def _stack(pkg_cfg, name):
    return dict(pkg_cfg.fidelity_stacks())[name]


def _ref_params(cfg, seed=0):
    return {k: np.asarray(v) for k, v in r_hybrid.init_params(jax.random.PRNGKey(seed), cfg).items()}


def _both(cfg_kw=None, seed=0):
    """A reference config and parameters, and the port's twins."""
    kw = cfg_kw or {}
    r_cfg = r_hybrid.HybridConfig(**kw) if kw else r_kth_cfg.smoke_config()
    t_cfg = t_hybrid.HybridConfig(**kw) if kw else t_kth_cfg.smoke_config()
    params = _ref_params(r_cfg, seed)
    return r_cfg, params, t_cfg, interop.hybrid_params_from_numpy(params, t_cfg, device="cpu")


def _clips(seed, n, cfg, frames=None):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 1, cfg.height, cfg.width, frames or cfg.frames).astype(np.float32)


def _near_ties(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    scale = np.max(np.abs(logits), axis=-1)
    return (top2[:, 1] - top2[:, 0]) <= TIE * scale


# -- data ------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_kth_splits_bitwise_equal_reference(split):
    r_x, r_y = r_kth.make_split(split, r_kth.VideoSpec(**SMOKE_SPEC))
    t_x, t_y = t_kth.make_split(split, t_kth.VideoSpec(**SMOKE_SPEC))
    assert t_x.dtype == r_x.dtype and t_y.dtype == r_y.dtype
    assert np.array_equal(t_x.view(np.int32), r_x.view(np.int32))
    assert np.array_equal(t_y, r_y)
    r_b = list(r_kth.batches(r_x, r_y, 16, np.random.RandomState(3), epochs=2))
    t_b = list(t_kth.batches(t_x, t_y, 16, np.random.RandomState(3), epochs=2))
    assert len(t_b) == len(r_b) > 0
    for a, b in zip(t_b, r_b):
        assert np.array_equal(a["video"], b["video"]) and np.array_equal(a["label"], b["label"])


@pytest.mark.parametrize("label", range(4))
def test_kth_render_clip_matches_reference_at_paper_spec(label):
    for subject, scenario in ((1, 0), (17, 3)):
        r = r_kth.render_clip(label, subject, scenario, r_kth.VideoSpec())
        t = t_kth.render_clip(label, subject, scenario, t_kth.VideoSpec())
        assert t.shape == (60, 80, 16)
        assert np.array_equal(t.view(np.int32), r.view(np.int32))


# -- network ---------------------------------------------------------------


def test_max_pool3d_matches_reference_on_nan_and_neg_inf():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 9, 10, 7).astype(np.float32)
    x[0, 0, 0, 0, 0] = np.nan
    x[1, 2, 4:8, 4:8, 2:4] = -np.inf  # one whole window
    x[1, 1, 8, 9, 6] = np.nan  # in the cropped tail: dropped by both
    want = np.asarray(r_hybrid.max_pool3d(jnp.asarray(x), (4, 4, 2)))
    got = t_hybrid.max_pool3d(torch.from_numpy(x), (4, 4, 2)).numpy()
    assert got.shape == want.shape == (2, 3, 2, 2, 3)
    assert np.isnan(got).sum() == 1 and np.isneginf(got).sum() == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_reference(impl):
    r_cfg, params, t_cfg, model = _both()
    x = _clips(1, 4, r_cfg)
    want = np.asarray(r_hybrid.forward(params, jnp.asarray(x), r_cfg, impl=impl))
    got = t_hybrid.forward(model, torch.from_numpy(x), t_cfg, impl=impl)
    assert got.shape == (4, t_cfg.num_classes)
    assert _rel_l2(got.detach().numpy(), want) <= _tol(impl)
    assert torch.equal(model(torch.from_numpy(x), impl=impl), got)


@pytest.mark.parametrize("stack", STACKS)
def test_forward_with_caller_sthc_matches_reference(stack):
    r_cfg, params, t_cfg, model = _both()
    x = _clips(2, 4, r_cfg)
    r_sthc = R_STHC(R_STHCConfig(fidelity=_stack(r_kth_cfg, stack)))
    t_sthc = T_STHC(T_STHCConfig(fidelity=_stack(t_kth_cfg, stack), device="cpu"))
    want = np.asarray(r_hybrid.forward(params, jnp.asarray(x), r_cfg, impl="sthc", sthc=r_sthc))
    got = t_hybrid.forward(model, x, t_cfg, impl="sthc", sthc=t_sthc).detach().numpy()
    assert _rel_l2(got, want) <= (EXACT if stack == "digital" else PHYSICAL)


@pytest.mark.parametrize("impl", ["digital", "spectral", "sthc_physical"])
def test_conv_layer_stream_matches_reference(impl):
    r_cfg, params, t_cfg, model = _both()
    x = _clips(3, 2, r_cfg, frames=31)
    want = np.asarray(r_hybrid.conv_layer_stream(params, jnp.asarray(x), r_cfg, impl=impl))
    got = t_hybrid.conv_layer_stream(model, torch.from_numpy(x), t_cfg, impl=impl).detach().numpy()
    assert got.shape == want.shape == (2, 3, 14, 16, 28)
    assert _rel_l2(got, want) <= _tol(impl)


def test_conv_layer_stream_spectral_ignores_caller_sthc():
    _, _, t_cfg, model = _both()
    x = torch.from_numpy(_clips(4, 1, t_cfg, frames=25))
    physical = T_STHC(T_STHCConfig(fidelity=t_kth_cfg.fidelity_stacks()[-2][1], device="cpu"))
    plain = t_hybrid.conv_layer_stream(model, x, t_cfg, impl="spectral")
    given = t_hybrid.conv_layer_stream(model, x, t_cfg, impl="spectral", sthc=physical)
    assert torch.equal(plain, given)


def test_conv_layer_stream_digital_matches_spectral():
    """The reference's own streaming check: the overlap-save ideal stream
    against one-shot direct correlation, to 2e-4 of the largest value."""
    cfg_kw = dict(height=16, width=18, frames=8, num_kernels=2, k_h=5, k_w=6, k_t=3,
                  pool_window=(4, 4, 2), hidden=8)
    _, _, t_cfg, model = _both(cfg_kw, seed=1)
    x = torch.from_numpy(_clips(1, 1, t_cfg, frames=25))
    ref = t_hybrid.conv_layer_stream(model, x, t_cfg, impl="digital").detach()
    got = t_hybrid.conv_layer_stream(model, x, t_cfg, impl="spectral").detach()
    np.testing.assert_allclose(got, ref, atol=2e-4 * float(torch.max(torch.abs(ref))) + 1e-5)


@pytest.mark.parametrize("impl", ["digital", "spectral"])
def test_loss_fn_matches_reference(impl):
    r_cfg, params, t_cfg, model = _both()
    x = _clips(5, 8, r_cfg)
    y = np.arange(8, dtype=np.int32) % 4
    r_loss, r_aux = r_hybrid.loss_fn(params, {"video": jnp.asarray(x), "label": jnp.asarray(y)}, r_cfg, impl)
    t_loss, t_aux = t_hybrid.loss_fn(model, {"video": x, "label": y}, t_cfg, impl)
    assert abs(t_loss.item() - float(r_loss)) <= EXACT * abs(float(r_loss))
    assert float(t_aux["accuracy"]) == float(r_aux["accuracy"])
    assert t_aux["loss"].item() == t_loss.item()


def test_impl_errors():
    _, _, t_cfg, model = _both()
    x = torch.from_numpy(_clips(6, 1, t_cfg))
    for fn in (t_hybrid.conv_layer, t_hybrid.conv_layer_stream):
        with pytest.raises(ValueError, match="unknown conv impl"):
            fn(model, x, t_cfg, impl="optical")
        with pytest.raises(ValueError, match="requires an explicit STHC"):
            fn(model, x, t_cfg, impl="sthc")


def test_default_correlators_are_shared_and_record_once():
    _, _, t_cfg, model = _both(seed=3)
    x = _clips(7, 2, t_cfg)
    first = t_hybrid._DEFAULT_STHC.get("sthc_physical", torch.device("cpu"))
    assert t_hybrid._DEFAULT_STHC.get("sthc_physical", torch.device("cpu")) is first
    assert first.config.device == "cpu"
    cache = first._cache
    a = t_hybrid.predict(model, x, t_cfg, impl="sthc_physical")
    misses = cache.misses
    b = t_hybrid.predict(model, x, t_cfg, impl="sthc_physical")
    assert cache.misses == misses  # the second call found the grating recorded
    assert torch.equal(a, b)


def test_hybrid_imports_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.path.join(REPO, "src"))
    code = (
        "import torch, repro_torch.core.hybrid as h\n"
        "assert not torch.cuda.is_available()\n"
        "assert h._DEFAULT_STHC._sthc == {}\n"
        "try:\n"
        "    h.init_params(h.HybridConfig())\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "refused: no CUDA device" in proc.stdout


def test_hybrid_params_from_numpy_checks_names_and_shapes():
    r_cfg, params, t_cfg, _ = _both()
    with pytest.raises(ValueError, match="params hold"):
        interop.hybrid_params_from_numpy({k: v for k, v in params.items() if k != "fc2_b"}, t_cfg, "cpu")
    bad = dict(params, fc1_w=params["fc1_w"].T.copy())
    with pytest.raises(ValueError, match="fc1_w"):
        interop.hybrid_params_from_numpy(bad, t_cfg, "cpu")


def test_init_params_he_scales():
    cfg = t_kth_cfg.config()
    m = t_hybrid.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tuple(m.fc1_w.shape) == (cfg.pooled_features, cfg.hidden)
    assert abs(m.conv_w.std().item() - (2.0 / 9600) ** 0.5) < 0.02 * (2.0 / 9600) ** 0.5
    assert all(p.requires_grad for p in m.parameters())  # trainable
    assert float(m.conv_b.abs().sum() + m.fc2_b.abs().sum()) == 0.0


# -- trained weights (the reference trains, as tests/test_system.py) --------


@pytest.fixture(scope="module")
def trained():
    spec = r_kth.VideoSpec(height=20, width=24, frames=10)
    kw = dict(height=20, width=24, frames=10, k_h=7, k_w=9, k_t=4,
              num_kernels=4, pool_window=(4, 4, 2), hidden=32)
    cfg = r_hybrid.HybridConfig(**kw)
    x_train, y_train = r_kth.make_split("train", spec)
    x_val, y_val = r_kth.make_split("val", spec)
    params = r_hybrid.init_params(jax.random.PRNGKey(0), cfg)
    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.01)
    opt = adamw_init(opt_cfg, params)

    @jax.jit
    def step(params, opt, batch):
        (_, aux), g = jax.value_and_grad(
            lambda p: r_hybrid.loss_fn(p, batch, cfg), has_aux=True
        )(params)
        params, opt, _ = adamw_update(opt_cfg, params, g, opt)
        return params, opt, aux

    for batch in r_kth.batches(x_train, y_train, 32, np.random.RandomState(0), epochs=8):
        params, opt, _ = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = {k: np.asarray(v) for k, v in params.items()}
    t_cfg = t_hybrid.HybridConfig(**kw)
    model = interop.hybrid_params_from_numpy(np_params, t_cfg, device="cpu")
    return cfg, np_params, t_cfg, model, x_val, y_val


def _assert_predictions_match(got, want, logits):
    ties = _near_ties(logits)
    assert ties.sum() <= 2, ties.sum()
    assert np.array_equal(got[~ties], want[~ties])


@pytest.mark.parametrize("impl", IMPLS + ("sthc",))
def test_trained_predictions_match_reference(trained, impl):
    cfg, params, t_cfg, model, x_val, y_val = trained
    r_sthc = t_sthc = None
    if impl == "sthc":  # the ablation's middle stack: quantized, ± channels, IHB band
        r_sthc = R_STHC(R_STHCConfig(fidelity=_stack(r_kth_cfg, "+ihb_envelope")))
        t_sthc = T_STHC(T_STHCConfig(fidelity=_stack(t_kth_cfg, "+ihb_envelope"), device="cpu"))
    logits = np.asarray(r_hybrid.forward(params, jnp.asarray(x_val), cfg, impl=impl, sthc=r_sthc))
    want = np.asarray(r_hybrid.predict(params, jnp.asarray(x_val), cfg, impl=impl, sthc=r_sthc))
    got = t_hybrid.predict(model, torch.from_numpy(x_val), t_cfg, impl=impl, sthc=t_sthc).numpy()
    assert got.shape == y_val.shape
    _assert_predictions_match(got, want, logits)
    if impl == "digital":
        assert float(np.mean(got == y_val)) > 0.45  # learned: chance is 0.25


@pytest.mark.parametrize("physical", [False, True])
def test_server_classify_matches_reference(trained, physical):
    cfg, params, t_cfg, model, x_val, _ = trained
    r_srv = R_Server({k: jnp.asarray(v) for k, v in params.items()}, cfg, physical=physical)
    t_srv = T_Server(model, t_cfg, physical=physical, device="cpu")
    want = r_srv.classify(jnp.asarray(x_val))
    got = t_srv.classify(x_val)
    impl = "sthc_physical" if physical else "spectral"
    logits = np.asarray(r_hybrid.forward(params, jnp.asarray(x_val), cfg, impl=impl))
    _assert_predictions_match(got, want, logits)
    if not physical:  # the ideal server is predict(impl='spectral') inside the port
        ideal = t_hybrid.predict(model, torch.from_numpy(x_val), t_cfg, impl="spectral")
        assert np.array_equal(got, ideal.numpy())


def test_server_classify_stream_matches_reference(trained):
    cfg, params, t_cfg, model, x_val, _ = trained
    ot = t_cfg.conv_out_shape[2]
    clips = np.concatenate([x_val[:4], x_val[4:8], x_val[8:12]], axis=-1)[..., : t_cfg.frames + 2 * ot]
    r_srv = R_Server({k: jnp.asarray(v) for k, v in params.items()}, cfg, physical=False)
    t_srv = T_Server(model, t_cfg, physical=False, device="cpu")
    want = r_srv.classify_stream(jnp.asarray(clips))
    got = t_srv.classify_stream(clips)
    assert got.shape == want.shape == (4, 3)
    assert np.array_equal(got, want)


def test_server_classify_stream_matches_per_segment():
    """Each training-length segment of the streamed conv classifies as a
    one-shot classify of that sub-clip (ideal mode)."""
    kw = dict(height=16, width=18, frames=8, num_kernels=2, k_h=5, k_w=6, k_t=3,
              pool_window=(4, 4, 2), hidden=8)
    _, _, t_cfg, model = _both(kw)
    server = T_Server(model, t_cfg, physical=False, device="cpu")
    ot = t_cfg.conv_out_shape[2]
    n_seg = 3
    clips = _clips(0, 2, t_cfg, frames=t_cfg.frames + (n_seg - 1) * ot)
    preds = server.classify_stream(clips)
    assert preds.shape == (2, n_seg)
    for s in range(n_seg):
        sub = clips[..., s * ot : s * ot + t_cfg.frames]
        np.testing.assert_array_equal(preds[:, s], server.classify(sub))


def test_server_rejects_a_short_stream_before_device_work():
    _, _, t_cfg, model = _both()
    server = T_Server(model, t_cfg, physical=False, device="cpu")
    misses = server.sthc._cache.misses
    with pytest.raises(ValueError, match="shorter than one classification window"):
        server.classify_stream(_clips(0, 1, t_cfg, frames=t_cfg.frames - 1))
    assert server.sthc._cache.misses == misses  # no stream grating was recorded
