"""B4's implicit-GEMM route and C3D at its published widths on the card.

Each of C3D's eight layer shapes at a batch of 2 clips (and the tap
gather at 128 filters), with its one-voxel border, bias and ReLU,
against the plain correlation in float64: within CONV_RTOL (relative L2
1e-5, the bound B4 is held to in float32; the 3xTF32 kernel reads
0.8–1.9e-6 on an H100), which one pass of TF32 (cuDNN's, ~3e-4) does
not meet.  Then the whole network at
its published widths served on 4 clips, against the plain reference
(``models/c3d_ref.py``, float32, TF32 off): logits within 1e-4 of the
largest, every convolution launched on the ``igemm`` route.

No JAX here: this file runs on a host with a card, where the reference
package is not installed (``python -m pytest --noconftest
tests/test_torch_c3d_card.py``).  Elsewhere it skips.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.conv3d import kernel as t_kernel  # noqa: E402
from repro_torch.launch.serve import C3DClassifierServer  # noqa: E402
from repro_torch.models import c3d, c3d_ref  # noqa: E402

CONV_RTOL = 1e-5
LAYERS = [("conv1a", 3, 64, 112, 16), ("conv2a", 64, 128, 56, 16), ("conv3a", 128, 256, 28, 8),
          ("conv3b", 256, 256, 28, 8), ("conv4a", 256, 512, 14, 4), ("conv4b", 512, 512, 14, 4),
          ("conv5a", 512, 512, 7, 2), ("conv5b", 512, 512, 7, 2),
          ("gather_bn128", 3, 128, 20, 8)]  # not C3D's: the tap gather at 128 filters


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


@pytest.mark.card
@pytest.mark.parametrize("name,c,o,side,frames", LAYERS, ids=[n for n, *_ in LAYERS])
def test_igemm_layer_matches_the_plain_correlation(card, name, c, o, side, frames):
    gen = torch.Generator(device=card).manual_seed(len(name) * 1000 + c)
    x = torch.rand(2, side, side, frames, c, generator=gen, device=card)
    w = torch.randn(o, c, 3, 3, 3, generator=gen, device=card) * (2.0 / (c * 27)) ** 0.5
    b = torch.randn(o, generator=gen, device=card) * 0.01
    before = dict(t_kernel.conv3d_cuda.route_launches)
    got = t_kernel.conv3d_cuda(x, w, pad=1, bias=b, relu=True, channels_last=True)
    assert t_kernel.conv3d_cuda.route_launches["igemm"] == before["igemm"] + 1
    xn = x.permute(0, 4, 1, 2, 3)
    want = F.relu(F.conv3d(xn.double(), w.double(), b.double(), padding=1)).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape and _rel(got, want) <= CONV_RTOL
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        one_pass = F.relu(F.conv3d(xn, w, b, padding=1)).permute(0, 2, 3, 4, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert _rel(one_pass, want) > CONV_RTOL  # the bound is the split's, not TF32's
    plain_layout = t_kernel.conv3d_cuda(xn.contiguous(), w, pad=1, bias=b, relu=True)
    assert torch.equal(plain_layout, got.permute(0, 4, 1, 2, 3))


@pytest.mark.card
def test_c3d_at_published_widths_matches_the_reference(card):
    cfg = configs.get_config("c3d-sports1m")
    gen = torch.Generator(device=card).manual_seed(38)
    params = c3d.init_params(cfg, gen, device=card, bias_std=0.01)
    clips = torch.rand(4, cfg.in_channels, cfg.height, cfg.width, cfg.frames, generator=gen, device=card)
    server = C3DClassifierServer(params, device=card)
    kept = {}
    head = server._head
    server._head = lambda f: kept.setdefault("logits", head(f))
    before = t_kernel.conv3d_cuda.route_launches["igemm"]
    preds = server.classify(clips)
    assert t_kernel.conv3d_cuda.route_launches["igemm"] == before + len(cfg.convs())
    want = c3d_ref.forward(params.state_dict(), clips, cfg).double()
    got = kept["logits"].double()
    scale = want.abs().amax(-1).median()
    assert float((got - want).abs().max() / scale) <= 1e-4
    gap = want.amax(-1) - want.gather(-1, torch.as_tensor(preds, device=card)[:, None])[:, 0]
    assert float(gap.max() / scale) <= 1e-4
