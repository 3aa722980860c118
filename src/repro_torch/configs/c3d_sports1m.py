"""C3D, the digital 3-D CNN the paper's correlator is set against (Tran et
al., "Learning Spatiotemporal Features with 3D Convolutional Networks",
ICCV 2015, arXiv:1412.0767, section 3.3 and Fig. 3; the released Caffe
model, C3D v1.0 on Sports-1M).

Eight 3x3x3 convolutions, stride 1, a zero border of one voxel, each
followed by ReLU, in five stages: conv1a 64, conv2a 128, conv3a/b 256,
conv4a/b 512, conv5a/b 512 filters.  After each stage a max pool whose
window is its stride: 1x2x2 (frames x rows x columns) after stage 1,
2x2x2 after the others, rounding up (Caffe's pooling), so pool5 takes
7x7x2 to 4x4x1 and 512 x 4 x 4 x 1 = 8,192 features reach fc6.  fc6 and
fc7 have 4,096 units with ReLU, fc8 the 487 Sports-1M classes.  Input
clips of 3 channels, 16 frames of 112 x 112.  80.0 M parameters.

``config()`` is the published network, ``smoke_config()`` the same
structure at a size a CPU test holds.
"""

from __future__ import annotations

import dataclasses

KERNEL = 3  # every convolution's taps on each axis; a zero border of KERNEL // 2


@dataclasses.dataclass(frozen=True)
class C3DConfig:
    height: int = 112
    width: int = 112
    frames: int = 16
    in_channels: int = 3
    # filters of each stage's convolutions (conv1a; conv2a; conv3a, 3b; ...)
    stages: tuple[tuple[int, ...], ...] = ((64,), (128,), (256, 256), (512, 512), (512, 512))
    # each stage's max-pool window, (rows, columns, frames); stride = window
    pools: tuple[tuple[int, int, int], ...] = ((2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))
    fc: tuple[int, ...] = (4096, 4096)
    num_classes: int = 487

    def convs(self) -> list[tuple[str, int, int]]:
        """(name, input channels, filters) of each convolution in order:
        conv1a, conv2a, conv3a, conv3b, ..."""
        out, c = [], self.in_channels
        for i, widths in enumerate(self.stages):
            for j, o in enumerate(widths):
                out.append((f"conv{i + 1}{'ab'[j]}", c, o))
                c = o
        return out

    def pooled_shape(self) -> tuple[int, int, int]:
        """(rows, columns, frames) after the last pool (ceil rounding)."""
        h, w, t = self.height, self.width, self.frames
        for ph, pw, pt in self.pools:
            h, w, t = -(-h // ph), -(-w // pw), -(-t // pt)
        return h, w, t

    @property
    def features(self) -> int:
        """Inputs of the first fully connected layer (8,192 published)."""
        h, w, t = self.pooled_shape()
        return self.stages[-1][-1] * h * w * t

    def fcs(self) -> list[tuple[str, int, int]]:
        """(name, inputs, outputs) of fc6, fc7, fc8."""
        dims = (self.features, *self.fc, self.num_classes)
        return [(f"fc{6 + i}", a, b) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def config() -> C3DConfig:
    return C3DConfig()


def smoke_config() -> C3DConfig:
    """The published structure at 16x16 pixels, 8 frames and narrow layers
    (the igemm route's channel rules kept: 64 or 128 filters over 32-channel
    multiples or 3 channels)."""
    return C3DConfig(
        height=16, width=16, frames=8,
        stages=((64,), (64,), (64, 64), (128, 128), (128, 128)),
        fc=(64, 64), num_classes=10,
    )
