"""Training the hybrid 3-D CNN in the port (``repro_torch.launch.train_hybrid``,
``core/hybrid.py``'s ``loss_fn`` and ``repro_torch.optim``) against the
reference's own recipe, ``benchmarks/accuracy.py`` and
``benchmarks/ablation.py``, imported from the repo root as
``examples/video_classification.py`` imports them.  Both packages start
from the same numpy weights (``hybrid.init_params(PRNGKey(0))``) and see
the same batches, at ``accuracy.run``'s reduced size (20×24×10 clips, 4
kernels of 7×9×4, pool (4, 4, 2), hidden 32) on the CPU.

Bounds, fixed before the first run:
- one step: the loss within 1e-6 relative; each leaf's gradient within
  relative L2 1e-5 on ``digital`` and 1e-4 on ``spectral`` (the two
  packages' FFTs differ by about 2e-7);
- the port's ``max_pool3d`` splits a tied window's gradient where the
  reference's pool gives it to one element, so the test asserts on the
  batches used that every window with a positive max has it at exactly
  one position (ReLU's zeros are the only ties);
- ``train_hybrid``, 2 epochs (12 steps): each step's loss within 1e-4
  relative, the final parameters within relative L2 1e-3 per leaf, the
  test split's ``spectral`` predictions equal outside near-ties (the
  top two logits within 1e-4 of their scale) and the accuracy within one
  clip;
- ``evaluate``'s confusion matrix equal to the reference's on the same
  weights; ``accuracy_rows`` and ``ablation_rows`` the reference's rows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the reference's benchmarks package

from benchmarks import ablation as r_ablation  # noqa: E402
from benchmarks import accuracy as r_accuracy  # noqa: E402
from repro.configs import sthc_kth as r_kth_cfg  # noqa: E402
from repro.core import engine as r_engine  # noqa: E402
from repro.core import hybrid as r_hybrid  # noqa: E402
from repro.data import kth_synthetic as r_kth  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import sthc_kth as t_kth_cfg  # noqa: E402
from repro_torch.core import hybrid as t_hybrid  # noqa: E402
from repro_torch.launch import train_hybrid as t_train  # noqa: E402

REDUCED = dict(height=20, width=24, frames=10, k_h=7, k_w=9, k_t=4,
               num_kernels=4, pool_window=(4, 4, 2), hidden=32)
LOSS_RTOL = 1e-6
GRAD_RTOL = {"digital": 1e-5, "spectral": 1e-4}
STEP_LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-3
TIE = 1e-4
EPOCHS = 2


@pytest.fixture(autouse=True)
def _fresh_reference_cache():
    """The reference's jitted ``evaluate`` records the default
    correlators' gratings while tracing, with concrete kernels, so its
    process-wide grating cache keeps traced values: a second evaluation of
    the same weights in one process would read a leaked tracer.  Each
    test starts and ends with that cache empty."""
    r_engine.default_cache().clear()
    yield
    r_engine.default_cache().clear()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _init(r_cfg):
    return {k: np.asarray(v) for k, v in r_hybrid.init_params(jax.random.PRNGKey(0), r_cfg).items()}


def _model(params, t_cfg):
    return interop.hybrid_params_from_numpy(params, t_cfg, device="cpu")


@pytest.fixture(scope="module")
def setup():
    r_cfg, t_cfg = r_hybrid.HybridConfig(**REDUCED), t_hybrid.HybridConfig(**REDUCED)
    assert t_cfg == t_train.reduced_config()
    x, y = r_kth.make_split("train", r_kth.VideoSpec(20, 24, 10))
    batches = list(r_kth.batches(x, y, 32, np.random.RandomState(0), epochs=EPOCHS))
    return r_cfg, t_cfg, _init(r_cfg), batches


@pytest.fixture(scope="module")
def trained(setup):
    """Both packages' 2-epoch runs from the same weights: per-step losses
    and final parameters.  The reference's losses are read inside its
    jitted step by a debug callback around its ``hybrid.loss_fn``."""
    r_cfg, t_cfg, p0, _ = setup
    r_losses = []
    loss_fn = r_accuracy.hybrid.loss_fn

    def spy(p, batch, cfg, impl="digital"):
        loss, aux = loss_fn(p, batch, cfg, impl)
        jax.debug.callback(lambda v: r_losses.append(float(v)), loss)
        return loss, aux

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_accuracy.hybrid, "loss_fn", spy)
        r_params = r_accuracy.train_hybrid(r_cfg, epochs=EPOCHS)
    r_params = {k: np.asarray(v) for k, v in r_params.items()}
    model = _model(p0, t_cfg)
    t_losses = [float(aux["loss"]) for _, aux in t_train.train_steps(t_cfg, model, epochs=EPOCHS)]
    return r_params, r_losses, model, t_losses


def _pool_windows(y, window):
    ph, pw, pt = window
    B, O, H, W, T = y.shape
    nh, nw, nt = H // ph, W // pw, T // pt
    y = y[..., : nh * ph, : nw * pw, : nt * pt].reshape(B, O, nh, ph, nw, pw, nt, pt)
    return y.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(B, O, nh * nw * nt, -1)


# -- one step -------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["spectral", "digital"])
def test_one_step_loss_and_gradients_match_reference(setup, impl):
    r_cfg, t_cfg, p0, batches = setup
    batch = batches[0]
    (r_loss, r_aux), r_grads = jax.value_and_grad(
        lambda p: r_hybrid.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, r_cfg, impl),
        has_aux=True,
    )({k: jnp.asarray(v) for k, v in p0.items()})
    model = _model(p0, t_cfg)
    loss, aux = t_hybrid.loss_fn(model, batch, t_cfg, impl)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert abs(loss.item() - float(r_loss)) <= LOSS_RTOL * abs(float(r_loss))
    assert float(aux["accuracy"]) == float(r_aux["accuracy"])
    assert set(names) == set(r_grads)
    for name, g in zip(names, grads):
        assert g.shape == r_grads[name].shape
        assert _rel_l2(g.numpy(), r_grads[name]) <= GRAD_RTOL[impl], name
    assert float(grads[names.index("conv_w")].abs().max()) > 0  # through the conv layer


@pytest.mark.parametrize("impl", ["spectral", "digital"])
def test_relu_zeroes_the_pool_ties(setup, trained, impl):
    """Every pool window whose max is positive has it at exactly one
    position on the batches used, at the initial and the trained
    weights, so the port's tie-splitting ``amax`` backward and the
    reference's one-element ``reduce_window`` backward agree; the ties
    that do occur are ReLU's zeros."""
    _, t_cfg, p0, batches = setup
    zero_ties = 0
    with torch.no_grad():
        for model in (_model(p0, t_cfg), trained[2]):
            for batch in batches:
                y = torch.relu(t_hybrid.conv_layer(model, batch["video"], t_cfg, impl=impl))
                win = _pool_windows(y, t_cfg.pool_window)
                top = win.amax(dim=-1, keepdim=True)
                count = (win == top).sum(dim=-1)
                positive = top[..., 0] > 0
                assert positive.any()
                assert bool(torch.all(count[positive] == 1))
                zero_ties += int((count[~positive] > 1).sum())
    assert zero_ties > 0


def test_sthc_routes_keep_the_graph_on_the_cpu(setup):
    """A grating recorded without a graph (``predict`` caches it) is not
    handed to a grad-mode call: the STHC route trains through the plain
    MAC on the CPU, to the spectral route's conv gradient."""
    _, t_cfg, p0, batches = setup
    model = _model(p0, t_cfg)
    batch = {k: v[:8] for k, v in batches[0].items()}
    t_hybrid.predict(model, batch["video"], t_cfg, impl="sthc_ideal")
    grads = {}
    for impl in ("sthc_ideal", "spectral"):
        loss, _ = t_hybrid.loss_fn(model, batch, t_cfg, impl)
        (grads[impl],) = torch.autograd.grad(loss, [model.conv_w])
    assert float(grads["sthc_ideal"].abs().max()) > 0
    assert _rel_l2(grads["sthc_ideal"].numpy(), grads["spectral"].numpy()) <= GRAD_RTOL["spectral"]


def test_stmul_wrappers_refuse_a_graph_on_the_card():
    """On a CUDA input that requires a gradient, in grad mode, the stmul
    wrappers raise before launching (their kernels have no backward);
    under ``no_grad`` they would launch."""
    from types import SimpleNamespace

    from repro_torch.kernels.stmul import ops as stmul_ops

    card = SimpleNamespace(device=torch.device("cuda"), requires_grad=False)
    graph = SimpleNamespace(device=torch.device("cuda"), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        stmul_ops._on_cuda(card, graph)
    assert stmul_ops._on_cuda(card, card)
    with torch.no_grad():
        assert stmul_ops._on_cuda(card, graph)
    assert not stmul_ops._on_cuda(torch.zeros(1, requires_grad=True))


# -- train_hybrid -----------------------------------------------------------------


def test_train_steps_match_reference(trained):
    r_params, r_losses, model, t_losses = trained
    steps = EPOCHS * (192 // 32)
    assert len(t_losses) == len(r_losses) == steps
    rel = np.abs(np.asarray(t_losses) - r_losses) / np.abs(r_losses)
    assert rel.max() <= STEP_LOSS_RTOL, rel
    for name, p in model.named_parameters():
        assert _rel_l2(p.detach().numpy(), r_params[name]) <= PARAM_RTOL, name


def test_train_hybrid_is_train_steps_with_logging(setup, trained):
    """``train_hybrid`` trains given parameters in place exactly as
    ``train_steps`` does, logging steps 0, 20, ... in the reference's
    format; without parameters it draws them on the requested device."""
    _, t_cfg, p0, _ = setup
    lines = []
    model = t_train.train_hybrid(t_cfg, epochs=EPOCHS, params=_model(p0, t_cfg), log=lines.append)
    for (name, p), (_, q) in zip(model.named_parameters(), trained[2].named_parameters()):
        assert torch.equal(p, q), name
    assert len(lines) == 1 and lines[0].startswith("  step 0 loss ")
    assert lines[0].split()[3] == f"{trained[3][0]:.3f}"
    fresh = t_train.train_hybrid(t_cfg, epochs=1, device="cpu")
    assert fresh.conv_w.device.type == "cpu" and fresh.conv_w.requires_grad


def test_trained_test_predictions_match_reference(setup, trained):
    r_cfg, t_cfg, _, _ = setup
    r_params, _, model, _ = trained
    x, y = r_kth.make_split("test", r_kth.VideoSpec(20, 24, 10))
    logits = np.asarray(r_hybrid.forward(r_params, jnp.asarray(x), r_cfg, impl="spectral"))
    want = np.argmax(logits, axis=-1)
    got = t_hybrid.predict(model, x, t_cfg, impl="spectral").numpy()
    top2 = np.sort(logits, axis=-1)[:, -2:]
    ties = (top2[:, 1] - top2[:, 0]) <= TIE * np.max(np.abs(logits), axis=-1)
    assert ties.sum() <= 2
    assert np.array_equal(got[~ties], want[~ties])
    assert abs(int(np.sum(got == y)) - int(np.sum(want == y))) <= 1


@pytest.mark.parametrize("impl", ["spectral", "digital", "sthc_physical"])
def test_evaluate_confusion_matrix_matches_reference(setup, trained, impl):
    r_cfg, t_cfg, _, _ = setup
    r_params = trained[0]
    r_acc, r_conf = r_accuracy.evaluate(r_cfg, {k: jnp.asarray(v) for k, v in r_params.items()},
                                        "test", impl)
    t_acc, t_conf = t_train.evaluate(t_cfg, _model(r_params, t_cfg), "test", impl)
    assert t_conf.shape == (4, 4) and t_conf.sum() == 144
    assert np.array_equal(t_conf, np.asarray(r_conf))
    assert t_acc == r_acc


# -- the rows of accuracy.run and ablation.run ------------------------------------


def _fields(row):
    name, us, derived = row.split(",", 2)
    if "=" not in derived:
        return name, us, {"value": float(derived)}
    return name, us, {k: float(v) for k, v in (f.split("=") for f in derived.split(";"))}


def test_accuracy_rows_match_reference(setup):
    r_cfg, t_cfg, p0, _ = setup
    want = r_accuracy.run(epochs=EPOCHS, full_geometry=False, log=lambda *_: None)
    model = t_train.train_hybrid(t_cfg, epochs=EPOCHS, params=_model(p0, t_cfg))
    log = []
    got = t_train.accuracy_rows(t_cfg, model, 12.5, log=log.append)
    assert len(got) == len(want) == 5
    assert got[0] == "accuracy_val_digital,12500000," + want[0].split(",")[2]
    assert got[1:] == want[1:]
    assert log[0].startswith("confusion matrix") and len(log) == 5


def test_ablation_rows_match_reference():
    """ablation.run at its smoke size (``sthc_kth.smoke_config()``, 2
    epochs) against the port's rows on the same weights: every stack's
    accuracy within one clip and relative error within its printed
    digit; the shared cache holds one grating per stack in both."""
    want = r_ablation.run(epochs=EPOCHS, full_geometry=False, log=lambda *_: None)
    r_cfg, t_cfg = r_kth_cfg.smoke_config(), t_kth_cfg.smoke_config()
    model = t_train.train_hybrid(t_cfg, epochs=EPOCHS, params=_model(_init(r_cfg), t_cfg))
    got = t_train.ablation_rows(t_cfg, model, log=lambda *_: None)
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    stacks = [name for name, _ in t_kth_cfg.fidelity_stacks()]
    assert [r.split(",")[0] for r in got[1 : 1 + len(stacks)]] == [f"ablation_{n}" for n in stacks]
    for g, w in zip(got, want):
        name, _, gf = _fields(g)
        _, _, wf = _fields(w)
        if name == "ablation_cache":
            n = len(stacks)
            assert gf["entries"] == wf["entries"] == n and gf["misses"] == wf["misses"] == n
            assert gf["hits"] == n * 9  # one lookup per test batch (the reference's jit: one)
            continue
        for key in ("acc", "value"):
            if key in wf:
                assert abs(gf[key] - wf[key]) <= 1 / 144 + 1e-9, (name, gf, wf)
        if "rel_err" in wf:
            assert abs(gf["rel_err"] - wf["rel_err"]) <= 1e-4, (name, gf, wf)


def test_cli_smoke_prints_the_rows(capsys):
    t_train.main(["--smoke", "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "  step 0 loss " in out and "name,us_per_call,derived" in out
    for name in ("accuracy_test_hybrid_physical", "ablation_+ihb_envelope", "ablation_cache",
                 "paper_reference_test_hybrid,0,0.5972"):
        assert name in out


# -- the examples --------------------------------------------------------------------

_RUN_ISOLATED = """
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
assert not bad, bad
print("isolated")
"""


@pytest.mark.parametrize("example,args,expect", [
    ("quickstart_torch.py", [], "gradient flows through the optical layer: True"),
    ("video_classification_torch.py", ["--fast", "--epochs", "2"], "accuracy_test_hybrid_physical"),
])
def test_example_runs_on_cpu_without_jax_or_reference(example, args, expect):
    # one intra-op thread, as this file's process: the suite runs workers side by side
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_ISOLATED, os.path.join(REPO, "examples", example),
         *args, "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert expect in proc.stdout and "isolated" in proc.stdout
