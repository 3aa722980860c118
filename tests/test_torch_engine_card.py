"""The fused readout on the card: one pooled, fused ``query_stream_many``
at the video-search geometry (60×80 frames, four tenants of 9 kernels of
30×40×8 in two pool groups, 64-frame windows four to a chunk, top-1,
eight 1024-frame streams) runs from its first launch to its readback
without a call that waits for the device, and its window chunks reuse
the position base built in the warm-up.

No JAX here: this file runs on a host with a card, where the reference
package is not installed (``python -m pytest --noconftest
tests/test_torch_engine_card.py``).  Elsewhere it skips.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fidelity  # noqa: E402
from repro_torch.core.engine import QueryEngine  # noqa: E402
from repro_torch.core.sthc import STHCConfig  # noqa: E402

FRAME_HW = (60, 80)
KERNELS = (9, 1, 30, 40, 8)
WINDOW = 64
CHUNK = 4
FRAMES = 1024
REQUESTS = 8


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_pooled_fused_search_never_waits_for_the_card():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pipes = [
        fidelity.ideal(),
        fidelity.ideal(),
        fidelity.physical(),
        fidelity.pipeline(fidelity.SLMQuantize()),
    ]
    gratings = []
    for pipe in pipes:
        rec = QueryEngine(STHCConfig(fidelity=pipe, device="cuda"))
        kernels = torch.randn(KERNELS, generator=gen, device="cuda")
        gratings.append(rec.record(kernels, FRAME_HW + (WINDOW,)))
    engine = QueryEngine(
        STHCConfig(fidelity=fidelity.ideal(), device="cuda", osave_chunk_windows=CHUNK)
    )
    shape = (1, KERNELS[1]) + FRAME_HW + (FRAMES,)
    reqs = [
        (gratings[i % len(gratings)], torch.rand(shape, generator=gen, device="cuda"))
        for i in range(REQUESTS)
    ]
    run = dict(dedup=False, readout_k=1)
    with torch.no_grad():
        warm = engine.query_stream_many(reqs, **run)
        torch.cuda.synchronize()
        before = engine.pool_stats()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dets = engine.query_stream_many(reqs, **run)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    after = engine.pool_stats()
    plan = engine.stream_plan_for(gratings[0], FRAMES)
    # one geometry, built in the warm-up; two pool groups, not encoded
    # {A, B} and encoded {C, D}, of five window chunks each
    assert after["readout_index_builds"] == before["readout_index_builds"] == 1
    hits = after["readout_index_hits"] - before["readout_index_hits"]
    assert hits == 2 * plan.n_padded // plan.chunk == 10
    for w, d in zip(warm, dets):
        assert torch.equal(w.scores.cpu(), d.scores.cpu())
        assert torch.equal(w.index.cpu(), d.index.cpu())
