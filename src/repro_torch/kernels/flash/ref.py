"""Plain torch version of the flash-attention forward (port of
``repro.kernels.flash.ref``): the port's blockwise online-softmax
attention, itself the reference's arithmetic (q scaled in its dtype
before a float32-accumulated dot, −1e30 masks, p cast to v's dtype
before the p·v dot).  It is the kernel's plain version on the CPU and
its yardstick of correctness on the card."""

from __future__ import annotations

from repro_torch.models.common import blockwise_attention


def flash_ref(q, k, v, *, causal=True, softmax_scale=None):
    return blockwise_attention(q, k, v, causal=causal, softmax_scale=softmax_scale)
