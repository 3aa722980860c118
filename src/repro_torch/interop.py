"""State carried across from the JAX reference.

:func:`fused_grating_from_numpy` builds a port
:class:`~repro_torch.core.engine.FusedGrating` from a reference
grating's fields passed as numpy arrays plus its metadata, so a test can
hold port *queries* against reference queries on the very same recorded
grating, apart from record parity.  Tenant kernel sets are numpy on both
sides and need no conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import FusedGrating


def _to_torch(arr, device) -> torch.Tensor | None:
    """A numpy array as a tensor; bfloat16 arrays (numpy's extension
    dtype) travel as their 16-bit patterns."""
    if arr is None:
        return None
    arr = np.array(arr)  # a writable copy torch can wrap
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def fused_grating_from_numpy(fields: dict, device: str = "cpu") -> FusedGrating:
    """Rebuild a recorded grating from its fields.

    ``fields`` maps the reference ``FusedGrating``'s field names to
    numpy arrays (``effective``, ``stacked``, ``eff_re``, ``eff_im``,
    ``kernel_scale``, ``echo_gain``; absent or None where the reference
    held None) and to its metadata (``fft_shape``, ``out_shape``,
    ``ker_shape``, ``encode``, ``slm_bits``, ``pseudo_negative``,
    ``storage_dtype``).
    """
    return FusedGrating(
        stacked=_to_torch(fields.get("stacked"), device),
        effective=_to_torch(fields.get("effective"), device),
        fft_shape=tuple(int(n) for n in fields["fft_shape"]),
        out_shape=tuple(int(n) for n in fields["out_shape"]),
        kernel_scale=_to_torch(fields["kernel_scale"], device),
        echo_gain=_to_torch(fields["echo_gain"], device),
        encode=bool(fields.get("encode", False)),
        slm_bits=int(fields.get("slm_bits", 8)),
        ker_shape=(
            None
            if fields.get("ker_shape") is None
            else tuple(int(n) for n in fields["ker_shape"])
        ),
        pseudo_negative=bool(fields.get("pseudo_negative", False)),
        eff_re=_to_torch(fields.get("eff_re"), device),
        eff_im=_to_torch(fields.get("eff_im"), device),
        storage_dtype=str(fields.get("storage_dtype", "float32")),
    )
