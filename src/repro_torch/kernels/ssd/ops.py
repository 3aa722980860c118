"""Public wrappers of the SSD kernel (port of ``repro.kernels.ssd.ops``).

``ssd`` is the operator the Mamba-2 model calls.  With ``impl='kernel'``
it routes by the tensor's device: a CUDA tensor launches the
hand-written kernel of ``kernel.py`` (or raises), a CPU tensor runs its
plain version, :func:`ref.ssd_chunked_ref`.  ``impl='chunked'`` runs the
plain chunked form on either device and alone takes ``initial_state``
(the reference's ``impl='jnp'``).  There is no fallback from one route
to the other.

The kernel route is a ``torch.autograd.Function``, as the flash op is:
its backward recomputes :func:`ref.ssd_chunked_ref` under autograd and
returns its gradients for x, dt, A, B and C.  There is no backward
kernel (the reference's Pallas SSD has none either), so a Mamba-2 loss
gets the same gradients by either route.

A ``meta`` tensor takes a third route: outputs of the right shapes and
dtypes on ``meta`` and no arithmetic (the dry run's).  Under
``launch.op_analysis.OpCounter`` the kernel route's forward counts as
one op, ``ssd``, by its own formula on every device, and its backward's
ops under the bucket ``ssd_bwd(plain)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd import ref as _ref
from repro_torch.launch import op_analysis

Tensor = torch.Tensor

IMPLS = ("kernel", "chunked")


def _shape(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, chunk: int) -> dict:
    Bb, L, H, P = x.shape
    return dict(Bb=Bb, L=L, H=H, G=B.shape[2], P=P, N=B.shape[3], chunk=chunk)


@op_analysis.counted_kernel("ssd", _shape)
def _forward(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, chunk: int):
    """The scan of inputs padded to a chunk multiple: the kernel on a CUDA
    tensor, the plain version on a CPU one, shapes alone on ``meta``."""
    if x.device.type == "cuda":
        return _kernel.ssd_chunked_cuda(
            x.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(), C.contiguous(), chunk,
        )
    if x.device.type == "cpu":
        return _ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "meta":
        Bb, _, H, P = x.shape
        return x.new_empty(x.shape), x.new_empty((Bb, H, P, B.shape[3]))
    raise ValueError(f"ssd has no kernel for device {x.device}")


def pad_to_chunk(x: Tensor, dt: Tensor, B: Tensor, C: Tensor, chunk: int):
    """x, dt, B, C padded along L to a multiple of ``chunk`` with zeros
    (dt = 0: unit decay, zero input), as :func:`ssd` hands them on."""
    pad = (-x.shape[1]) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    return x, dt, B, C


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gS):
        with torch.enable_grad(), op_analysis.bucket("ssd_bwd(plain)"):
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, S = _ref.ssd_chunked_ref(*leaves, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, S), leaves, (gy, gS))
        return (*grads, None)


def ssd(
    x: Tensor,
    dt: Tensor,
    A: Tensor,
    B: Tensor,
    C: Tensor,
    *,
    chunk: int = 128,
    impl: str = "kernel",
    initial_state: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Chunked selective-SSM scan.  See :func:`ref.ssd_scan_ref` for the
    semantics; all inputs float32.

    Pads L up to a chunk multiple; padded steps use dt = 0 (unit decay,
    zero input) so results are exact, and y is cropped back to L.
    Returns (y (Bb, L, H, P), final state (Bb, H, P, N)).
    """
    L = x.shape[1]
    x, dt, B, C = pad_to_chunk(x, dt, B, C, chunk)
    if impl == "kernel":
        if initial_state is not None:
            raise NotImplementedError(
                "initial_state is only supported by impl='chunked' (used for "
                "sequence-parallel composition); the kernel starts from 0."
            )
        y, S = _SSD.apply(x, dt, A, B, C, chunk)
    elif impl == "chunked":
        y, S = _ref.ssd_chunked_ref(
            x, dt, A, B, C, chunk=chunk, initial_state=initial_state
        )
    else:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return y[:, :L], S


def ssd_decode_step(
    S: Tensor, x_t: Tensor, dt_t: Tensor, A: Tensor, B_t: Tensor, C_t: Tensor
) -> tuple[Tensor, Tensor]:
    """Single-token decode: advance the SSM state by one step.

    S: (Bb, H, P, N); x_t: (Bb, H, P); dt_t: (Bb, H); B_t, C_t: (Bb, G, N).
    Returns (S', y_t (Bb, H, P)).  O(1) per token; plain torch on both
    devices (the reference has no kernel for it either).
    """
    rep = x_t.shape[1] // B_t.shape[1]
    b_t = B_t.repeat_interleave(rep, dim=1)  # (Bb, H, N)
    c_t = C_t.repeat_interleave(rep, dim=1)
    a_t = torch.exp(dt_t * A[None, :])  # (Bb, H)
    S = S * a_t[..., None, None] + (dt_t[..., None] * x_t)[..., None] * b_t[
        ..., None, :
    ]
    y_t = torch.einsum("bhpn,bhn->bhp", S, c_t)
    return S, y_t
