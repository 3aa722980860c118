"""Fused weight-stationary spectral query engine — the STHC hot path
(port of ``repro.core.engine``).

* **Record** folds everything static — the pseudo-negative combine
  ``G⁺ − G⁻``, the per-output-channel kernel de-quantization scale and
  the photon-echo gain — into one *effective* grating.
* **Query** computes one forward ``rfftn`` per clip, one
  channel-contracted MAC against the effective grating (the B1 CUDA
  kernel under ``use_pallas``, a torch einsum otherwise) and one
  ``irfftn``; only the per-example de-scaling is left at query time.
* **Stream** (``query_stream``) pushes long clips through overlap-save
  coherence windows with a stream-global SLM scale; a chunk's windows
  are stacked on the batch axis, so one ``rfftn`` and one kernel launch
  cover a whole chunk.  ``osave_max_buffer_windows`` feeds longer
  streams through a :class:`~repro_torch.core.spectral_conv.StreamCursor`
  at constant peak memory, equal to one-shot: a numpy or CPU stream
  stays on the host there, and only each segment crosses to the device.
* **Pooled serving** (``query_many`` / ``query_stream_many``) packs the
  resident gratings of a pool group into one ``(ΣO, C, FH, FW, FTr)``
  arena and answers a mixed-tenant batch with one FFT, one grouped MAC
  (kernel B2) and one IFFT per window chunk; clips that hash equal
  collapse onto one physical row reading the union of their tenants'
  O-slices (clip-dedup).
* **Mesh serving** (``mesh=`` on both pooled calls) shards a group over a
  :class:`~repro_torch.launch.mesh.LocalMesh`: the arena is packed in
  equal tiles, one per model shard, with no tenant straddling two; the
  stream rows are split over the data axis; each shard runs the
  single-device body on its rows and its tile, and the outputs are
  placed side by side — a concatenation, so every answer is bitwise the
  single-device one.
* **Fused readout** (``readout_k``) collapses every window chunk to the
  K best (score, position) pairs per (row, kernel) with kernel B3; the
  states merge associatively, so the result is bitwise the stitched
  volume's max / argmax.
* **Cache** — :class:`GratingCache` memoizes recordings by kernel
  content hash plus the record-relevant config.

The reference's ``jit`` (static compositions) needs no counterpart here;
``lax.map`` over chunks is a Python loop and ``vmap`` over windows is the
stacked batch axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import fidelity as fidelity_mod
from repro_torch.core import optics, pseudo_negative, spectral_conv
from repro_torch.kernels.stmul import ops as stmul_ops
from repro_torch.kernels.stmul import ref as stmul_ref

if TYPE_CHECKING:  # sthc imports this module
    from repro_torch.core.sthc import STHCConfig

Tensor = torch.Tensor

_FFT_AXES = (-3, -2, -1)

# Sentinel for an unfilled / poisoned top-K slot (int32 max).
TOPK_EMPTY_IDX = stmul_ref.TOPK_EMPTY_IDX


def as_tensor(x, device, dtype: torch.dtype = torch.float32) -> Tensor:
    """A numpy array or tensor as a ``dtype`` tensor on ``device``."""
    if isinstance(x, np.ndarray):
        if not (x.flags.writeable and x.flags.c_contiguous):
            x = np.array(x)  # torch wraps only writable, contiguous buffers
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def staged_to_device(x, device) -> Tensor:
    """A numpy or CPU clip as a float32 tensor on ``device``, staged on the
    card through pinned memory: each call takes its own buffer from
    PyTorch's caching host allocator and copies it with
    ``non_blocking=True`` on the current stream.  The allocator records
    the copy's event and hands the buffer out again only once the copy has
    ended, so concurrent callers share no buffer and none is rewritten
    while a copy reads it.  A clip already on the device, or a device
    that is the host, goes through ``as_tensor``."""
    host = isinstance(x, np.ndarray) or (isinstance(x, Tensor) and x.device.type == "cpu")
    if not host or torch.device(device).type != "cuda":
        return as_tensor(x, device)
    src = as_tensor(x, "cpu")
    staged = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    staged.copy_(src)
    return staged.to(device, non_blocking=True)


def host_stream(x, device) -> Tensor:
    """A stream as a float32 tensor where it lives: a numpy array or a
    CPU tensor stays on the host (without a copy when it is float32
    already), any other tensor goes to ``device``.  The engine moves a
    host stream to ``device`` whole, or one cursor segment at a time."""
    if isinstance(x, np.ndarray) or (isinstance(x, Tensor) and x.device.type == "cpu"):
        return as_tensor(x, "cpu")
    return as_tensor(x, device)


def stack_streams(xs: Sequence[Tensor], device) -> Tensor:
    """Concatenate streams on the batch axis where they live: on the host
    when every one is there, else on ``device``."""
    if not all(x.device.type == "cpu" for x in xs):
        xs = [as_tensor(x, device) for x in xs]
    return xs[0] if len(xs) == 1 else torch.cat(list(xs), dim=0)


class _SegmentUploader:
    """Moves cursor segments of a host stream to the device: each segment
    is staged in one of two pinned host buffers and copied with
    ``non_blocking=True`` on the current stream, so the copy of segment
    i + 1 overlaps the kernels of segment i.  A buffer is refilled only
    after the event recorded behind its last copy has completed.  A
    segment already on the device, or a device that is the host, passes
    through ``as_tensor``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: list[Tensor | None] = [None, None]
        self._done: list = [None, None]
        self._next = 0

    def __call__(self, seg: Tensor) -> Tensor:
        if self.device.type != "cuda" or seg.device.type != "cpu":
            return as_tensor(seg, self.device)
        i, self._next = self._next, 1 - self._next
        if self._done[i] is not None:
            self._done[i].synchronize()  # the last copy out of buffer i has ended
        n = seg.numel()
        if self._bufs[i] is None or self._bufs[i].numel() < n:
            self._bufs[i] = torch.empty(n, dtype=torch.float32, pin_memory=True)
        staged = self._bufs[i][:n].view(seg.shape)
        staged.copy_(seg)
        out = staged.to(self.device, non_blocking=True)
        self._done[i] = torch.cuda.Event()
        self._done[i].record()
        return out


def _nbytes(t: Tensor | None) -> int:
    return 0 if t is None else int(t.numel()) * int(t.element_size())


@dataclasses.dataclass
class FusedGrating:
    """Recorded state of the atomic medium, packed for fused queries.

    Attributes:
      stacked: (S, O, C, FH, FW, FTr) complex64 — the raw ± gratings
        (unfused reference path only); None when there is no ± split or
        serving dropped it.
      effective: (O, C, FH, FW, FTr) complex64 — the effective grating
        (f32 storage); None under bf16 storage.
      eff_re / eff_im: split real/imag bf16 planes of the effective
        grating (half-precision storage, up-cast to f32 at the MAC).
      storage_dtype: 'float32' | 'bfloat16'.
      fft_shape / out_shape: FFT grid and valid-region crop.
      kernel_scale: (O, 1, 1, 1, 1) de-quantization scale (folded).
      echo_gain: scalar echo-efficiency factor (folded).
      encode: queries pass through the SLM model.
      slm_bits: SLM bit depth for query encoding.
      ker_shape: (kh, kw, kt) of the recorded kernels.
      pseudo_negative: the recording split ± channels.
    """

    stacked: Tensor | None
    effective: Tensor | None
    fft_shape: tuple[int, int, int]
    out_shape: tuple[int, int, int]
    kernel_scale: Tensor
    echo_gain: Tensor
    encode: bool = False
    slm_bits: int = 8
    ker_shape: tuple[int, int, int] | None = None
    pseudo_negative: bool = False
    eff_re: Tensor | None = None
    eff_im: Tensor | None = None
    storage_dtype: str = "float32"

    @property
    def effective_c(self) -> Tensor:
        """The query-ready complex64 effective grating, whichever layout
        stores it (bf16 planes up-cast here)."""
        if self.effective is not None:
            return self.effective
        return torch.complex(self.eff_re.float(), self.eff_im.float())

    @property
    def planes(self) -> tuple[Tensor, Tensor]:
        """(re, im) planes in the storage dtype — what the arena packs."""
        if self.effective is None:
            return self.eff_re, self.eff_im
        return self.effective.real, self.effective.imag

    @property
    def n_out(self) -> int:
        eff = self.effective if self.effective is not None else self.eff_re
        return int(eff.shape[0])

    @property
    def channels(self) -> int:
        eff = self.effective if self.effective is not None else self.eff_re
        return int(eff.shape[1])

    @property
    def nbytes(self) -> int:
        """Device footprint of the recorded state (cache accounting)."""
        return (
            _nbytes(self.effective)
            + _nbytes(self.eff_re)
            + _nbytes(self.eff_im)
            + _nbytes(self.stacked)
        )


@dataclasses.dataclass(frozen=True)
class GratingPool:
    """A packed cross-tenant arena of effective gratings (one pool group).

    Attributes:
      re / im: contiguous split planes (ΣO_pad, C, FH, FW, FTr) in the
        members' storage dtype.
      o_start: per-member first-row offset (members pack back to back:
        the CUDA grouped kernel reads any row offset, so slots need no
        O-tile alignment).
      n_out: rows each pooled query reads per request (widest member).
      members: strong references to the member gratings (keeps the
        identity-keyed pool cache sound).
      shards: equal-height arena tiles the packing respects (mesh
        serving): ``shards > 1`` bins the members into ``shards`` tiles
        of ``shard_rows`` rows (greedy least-loaded, deterministic), each
        member slot wholly inside one tile, so a tenant's O-slice lives
        on one model shard.
    """

    re: Tensor
    im: Tensor
    o_start: tuple[int, ...]
    n_out: int
    members: tuple[FusedGrating, ...]
    shards: int = 1

    @property
    def shard_rows(self) -> int:
        """Arena rows per tile (all of them when unsharded)."""
        return int(self.re.shape[0]) // int(self.shards)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.re) + _nbytes(self.im)


@dataclasses.dataclass(frozen=True)
class _DedupLayout:
    """Row layout of one pool-group dispatch after clip-dedup.

    Attributes:
      uniq: group-local request index owning each physical clip copy.
      uniq_of: per group-local request — which physical copy serves it.
      row_of: per physical copy — its arena start row.
      o_off: per group-local request — offset of its tenant's O-slice
        inside its physical row's span.
      n_out: rows every physical row reads (the widest span).
    """

    uniq: list[int]
    uniq_of: list[int]
    row_of: list[int]
    o_off: list[int]
    n_out: int


def _dedup_members(
    gratings: list[FusedGrating],
) -> tuple[list[FusedGrating], list[int]]:
    """Unique member gratings (identity, first-seen order) + each
    request's member slot."""
    members: list[FusedGrating] = []
    index: dict[int, int] = {}
    slot_of: list[int] = []
    for g in gratings:
        slot = index.get(id(g))
        if slot is None:
            slot = index[id(g)] = len(members)
            members.append(g)
        slot_of.append(slot)
    return members, slot_of


def _bin_members(slots: list[int], shards: int) -> tuple[list[int], int]:
    """Greedy least-loaded binning of member slot widths into ``shards``
    tiles: each member's tile (first-seen order, ties to the lowest tile,
    so the identity-keyed pool cache stays sound) and the tile height
    (the largest load)."""
    load = [0] * shards
    bin_of = []
    for s in slots:
        b = min(range(shards), key=lambda i: (load[i], i))
        bin_of.append(b)
        load[b] += s
    return bin_of, max(load) if load else 0


def _build_pool(members: list[FusedGrating], shards: int = 1) -> GratingPool:
    """Pack member gratings' planes back to back into one contiguous
    arena.  Unsharded, zero tail rows keep every ``o_start + n_out`` read
    in bounds; with ``shards > 1`` the members are binned into
    ``shards`` tiles of ``shard_rows`` rows each (zero-filled to one
    height), no slot straddling two tiles."""
    c = members[0].channels
    for g in members[1:]:
        if g.channels != c:
            raise ValueError(
                "pool members disagree on input channels: "
                f"{[m.channels for m in members]}"
            )
    planes = [g.planes for g in members]
    slots = [int(re.shape[0]) for re, _ in planes]
    n_out = max(slots)
    feat = tuple(planes[0][0].shape[1:])
    dtype = planes[0][0].dtype
    device = planes[0][0].device
    res, ims = [], []
    o_start = [0] * len(members)

    def fill(rows: int) -> None:
        if rows > 0:
            zeros = torch.zeros((rows,) + feat, dtype=dtype, device=device)
            res.append(zeros)
            ims.append(zeros)

    def place(i: int, row: int) -> int:
        res.append(planes[i][0])
        ims.append(planes[i][1])
        o_start[i] = row
        return row + slots[i]

    if shards <= 1:
        row = 0
        for i in range(len(members)):
            row = place(i, row)
        fill(max(o + n_out for o in o_start) - row)
    else:
        bin_of, shard_rows = _bin_members(slots, shards)
        for b in range(shards):
            row = b * shard_rows
            for i, tile in enumerate(bin_of):
                if tile == b:
                    row = place(i, row)
            fill((b + 1) * shard_rows - row)
    return GratingPool(
        re=torch.cat(res, dim=0),
        im=torch.cat(ims, dim=0),
        o_start=tuple(o_start),
        n_out=n_out,
        members=tuple(members),
        shards=max(1, int(shards)),
    )


def clip_key(x) -> tuple:
    """Content fingerprint of a clip batch (SHA-1 of the full bytes +
    shape + dtype): two requests whose clips hash equal are the same
    stream, answered from one physical row.  The whole buffer is
    digested, never a sample: a false "same clip" would answer one
    tenant with another's stream.  A C-contiguous numpy array is hashed
    in place; a tensor costs one copy to the host (a device→host copy
    for a CUDA clip)."""
    if isinstance(x, Tensor):
        arr = x.detach().cpu().contiguous().numpy()
    else:
        arr = np.ascontiguousarray(x)
    return (hashlib.sha1(arr).hexdigest(), tuple(arr.shape), str(arr.dtype))


_HASH_WORKERS = 8  # threads digesting distinct clips in one call


def clip_keys_for(arrays) -> list:
    """Per-array clip identities, hashed once per distinct object.  More
    than one distinct clip is digested on a small thread pool
    (``hashlib`` releases the GIL while it digests a large buffer); the
    keys are bitwise the serial ones."""
    arrays = list(arrays)
    distinct = list({id(x): x for x in arrays}.values())
    if len(distinct) > 1:
        with ThreadPoolExecutor(min(len(distinct), _HASH_WORKERS)) as pool:
            keys = list(pool.map(clip_key, distinct))
    else:
        keys = [clip_key(x) for x in distinct]
    memo = {id(x): k for x, k in zip(distinct, keys)}
    return [memo[id(x)] for x in arrays]


def _unique_clips(keys: list) -> tuple[list[int], list[int]]:
    """The first request of each distinct clip key, in order, and which
    of them serves each request (a None key is always its own clip)."""
    uniq: list[int] = []
    uniq_of: list[int] = []
    by_key: dict[tuple, int] = {}
    for j, k in enumerate(keys):
        u = by_key.get(k) if k is not None else None
        if u is None:
            u = len(uniq)
            uniq.append(j)
            if k is not None:
                by_key[k] = u
        uniq_of.append(u)
    return uniq, uniq_of


def _stream_scale(x: Tensor) -> Tensor:
    """Stream-global SLM scale per example (B, 1, 1, 1, 1), bit for bit
    what ``QueryEngine._encode`` derives."""
    a = torch.amax(torch.clamp(x, min=0.0), dim=(1, 2, 3, 4), keepdim=True)
    return torch.where(a > 0, a, torch.ones_like(a))


def _pad_arena(
    pool_re: Tensor, pool_im: Tensor, max_row: int, n_out: int
) -> tuple[Tensor, Tensor]:
    """Zero-pad arena rows so every ``[row, row + n_out)`` read stays in
    bounds (dedup union spans can read past the pool's tail)."""
    need = int(max_row) + int(n_out) - int(pool_re.shape[0])
    if need <= 0:
        return pool_re, pool_im
    pad = torch.zeros(
        (need,) + tuple(pool_re.shape[1:]), dtype=pool_re.dtype, device=pool_re.device
    )
    return torch.cat([pool_re, pad]), torch.cat([pool_im, pad])


def _pool_select(
    pool_re: Tensor, pool_im: Tensor, rows: Sequence[int], n_out: int
) -> Tensor:
    """Per-row O-slices of the arena as one complex64 tensor
    (B, n_out, C, FH, FW, FTr), planes up-cast to f32."""
    r = torch.as_tensor(list(rows), dtype=torch.long, device=pool_re.device)
    idx = r[:, None] + torch.arange(int(n_out), device=pool_re.device)[None, :]
    return torch.complex(pool_re[idx].float(), pool_im[idx].float())


def _presel_query_dense(
    x: Tensor,
    sel: Tensor,
    fft_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
) -> Tensor:
    """Pooled MAC on pre-selected per-row slices ``sel`` (B, O, C, ...)
    for a batch ``x`` of W·B clips (W windows of the same B rows, stacked
    window-major): one ``rfftn``, one einsum, one ``irfftn``."""
    B = sel.shape[0]
    xhat = torch.fft.rfftn(x, s=fft_shape, dim=_FFT_AXES)
    xhat = xhat.reshape((-1, B) + tuple(xhat.shape[1:]))
    with spectral_conv.full_precision():
        yhat = torch.einsum("wbcxyz,bocxyz->wboxyz", xhat, sel)
    yhat = yhat.reshape((-1,) + tuple(yhat.shape[2:]))
    y = torch.fft.irfftn(yhat, s=fft_shape, dim=_FFT_AXES)
    return y[..., : out_shape[0], : out_shape[1], : out_shape[2]]


def _pooled_query_dense(
    x: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    rows: Sequence[int],
    n_out: int,
    fft_shape: tuple[int, int, int],
    out_shape: tuple[int, int, int],
) -> Tensor:
    """Dense pooled query: offset-gather + einsum."""
    sel = _pool_select(pool_re, pool_im, rows, n_out)
    return _presel_query_dense(x, sel, fft_shape, out_shape)


# ---------------------------------------------------------------------------
# Fused detection readout — the streaming top-K state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopKDetections:
    """Per (clip row, output kernel), the K best correlation peaks of a
    stream.  ``index`` holds global flat positions in the C-order
    ``(H', W', T'valid)`` volume, so ``peak_scores()`` / ``peak_index()``
    equal the stitched volume's ``amax`` / ``argmax`` bitwise;
    ``TOPK_EMPTY_IDX`` marks a slot with no detection."""

    scores: Tensor  # (B, O, K) float32, descending
    index: Tensor  # (B, O, K) int32
    out_shape: tuple[int, int, int]

    @property
    def k(self) -> int:
        return int(self.scores.shape[-1])

    def peak_scores(self) -> Tensor:
        return self.scores[..., 0]

    def peak_index(self) -> Tensor:
        return self.index[..., 0]

    def positions(self) -> tuple[Tensor, Tensor, Tensor]:
        """(t, h, w) of every slot, each (B, O, K)."""
        Hp, Wp, Tv = self.out_shape
        t = self.index % Tv
        hw = self.index // Tv
        return t, hw // Wp, hw % Wp

    def __getitem__(self, sl) -> "TopKDetections":
        return TopKDetections(self.scores[sl], self.index[sl], self.out_shape)


def _segment_plan(
    seg: spectral_conv.StreamSegment, plan: spectral_conv.StreamPlan, kt: int
) -> spectral_conv.StreamPlan:
    """The plan of one cursor segment, at the parent pass's chunk width.

    A short tail segment would plan fewer windows per chunk; it is padded
    to the parent's width instead (the surplus windows are cropped or
    masked), so every FFT of a chunked pass runs at the batch size of the
    one-shot pass — on the CPU a lone transform rounds differently from
    the same transform inside a batch, and chunked must equal one-shot
    bit for bit."""
    p = spectral_conv.stream_plan(seg.frames, kt, plan.block_t, plan.chunk)
    if p.chunk == plan.chunk:
        return p
    n_padded = -(-p.n_blocks // plan.chunk) * plan.chunk
    pad_t = max((n_padded - 1) * p.step + p.block_t - seg.frames, 0)
    return dataclasses.replace(p, chunk=plan.chunk, n_padded=n_padded, pad_t=pad_t)


def _rebase_topk_index(idx: Tensor, nv_local: int, t0: int, nv_total: int) -> Tensor:
    """Rebase segment-local flat positions into the stream-global
    volume; sentinel slots stay sentinels."""
    hw = idx // nv_local
    t = idx % nv_local
    return torch.where(
        idx == TOPK_EMPTY_IDX, idx, (hw * nv_total + t0 + t).to(idx.dtype)
    )


def _merge_topk_states(states: "list[tuple[Tensor, Tensor]]", k: int) -> tuple[Tensor, Tensor]:
    """Exact associative merge of (scores, index) top-K states."""
    return stmul_ops.merge_topk(states, int(k))


def _segments_rebase_merge(
    seg_s, seg_i, *, k: int, nv_locals: tuple, t0s: tuple, nv_total: int
) -> tuple[Tensor, Tensor]:
    """Rebase every cursor segment's local top-K state into the
    stream-global index space and merge."""
    states = [
        (s, _rebase_topk_index(i, nv, t0, nv_total))
        for s, i, nv, t0 in zip(seg_s, seg_i, nv_locals, t0s)
    ]
    return _merge_topk_states(states, int(k))


class QueryEngine:
    """Record-once / query-many executor for one :class:`STHCConfig`."""

    _max_pools = 8  # LRU bound on memoized cross-tenant arenas

    def __init__(self, config: "STHCConfig"):
        self.config = config
        self.device = torch.device(config.device)
        self._pools: OrderedDict[tuple, GratingPool] = OrderedDict()  # guarded-by: _pools_lock
        # row-padded arena views for dedup union spans that overhang the
        # pool tail, keyed (pool id, rows needed); entries pin the pool
        self._padded: OrderedDict[tuple, tuple] = OrderedDict()  # guarded-by: _pools_lock
        # the arena tiles placed on a mesh, keyed (pool id, mesh); entries
        # pin the pool.  A server owns one mesh per replica, so it stays small
        self._mesh_arenas: OrderedDict[tuple, tuple] = OrderedDict()  # guarded-by: _pools_lock
        self._pools_lock = threading.Lock()
        # clip-dedup accounting: offered = clip rows requested,
        # dispatched = physical rows after collapsing equal clips
        self._pooled_dispatches = 0  # guarded-by: _pools_lock
        self._pooled_rows_offered = 0  # guarded-by: _pools_lock
        self._pooled_rows_dispatched = 0  # guarded-by: _pools_lock

    def pool_stats(self) -> dict:
        """Pooled-executor counters: clip rows the dedup collapsed."""
        with self._pools_lock:
            offered = self._pooled_rows_offered
            dispatched = self._pooled_rows_dispatched
            return {
                "dispatches": self._pooled_dispatches,
                "rows_offered": offered,
                "rows_dispatched": dispatched,
                "rows_saved": offered - dispatched,
            }

    def _count_pooled(self, offered: int, dispatched: int) -> None:
        with self._pools_lock:
            self._pooled_dispatches += 1
            self._pooled_rows_offered += int(offered)
            self._pooled_rows_dispatched += int(dispatched)

    def _as_input(self, x) -> Tensor:
        return as_tensor(x, self.device)

    # -- record -----------------------------------------------------------

    def record(self, kernels, signal_shape: tuple[int, int, int]) -> FusedGrating:
        """Write a kernel stack (O, C, kh, kw, kt) for signals (H, W, T)
        through the config's fidelity pipeline: ``prepare_kernels``
        hooks on the time-domain kernels, ``shape_spectrum`` hooks on the
        kernel's own kt-point grid, ``fold_gain`` hooks and the
        quantizer scale folded into the effective grating; a
        :class:`~repro_torch.core.fidelity.PseudoNegative` stage records
        ± halves and folds ``G⁺ − G⁻``."""
        cfg = self.config
        pipe = cfg.fidelity
        kernels = self._as_input(kernels)
        ker_shape = tuple(int(n) for n in kernels.shape[-3:])
        fft_shape = spectral_conv.fft_shape_for(signal_shape, ker_shape)
        out_shape = spectral_conv.valid_shape(signal_shape, ker_shape)
        kt = ker_shape[-1]

        quant = pipe.get(fidelity_mod.SLMQuantize)
        pn = pipe.has(fidelity_mod.PseudoNegative)
        bits = pipe.resolved_bits(cfg.slm)
        if quant is not None:
            # shared per-output-channel quantizer range (± halves share it,
            # so they subtract exactly)
            scale = torch.amax(torch.abs(kernels), dim=(1, 2, 3, 4), keepdim=True)
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        else:
            scale = torch.ones(
                (kernels.shape[0], 1, 1, 1, 1), dtype=kernels.dtype, device=self.device
            )
        ctx = fidelity_mod.StageContext(
            kt=kt,
            slm=cfg.slm,
            atoms=cfg.atoms,
            storage_interval_s=cfg.storage_interval_s,
            bits=bits,
            signed=not pn,
            kernel_scale=scale,
        )
        h_t = None  # None ≡ all-ones transfer: skip the band-limit FFTs
        for stage in pipe:
            h_t = stage.shape_spectrum(h_t, ctx)

        def prep(k):
            for stage in pipe:
                k = stage.prepare_kernels(k, ctx)
            return k

        def band(k):
            if h_t is None:
                return k
            spec = torch.fft.fft(k, dim=-1) * h_t.reshape((1,) * (k.ndim - 1) + (-1,))
            return torch.real(torch.fft.ifft(spec, dim=-1))

        if pn:
            k_plus, k_minus = pseudo_negative.split(kernels)
            g_plus = spectral_conv.make_grating(band(prep(k_plus)), fft_shape)
            g_minus = spectral_conv.make_grating(band(prep(k_minus)), fft_shape)
            stacked = torch.stack([g_plus, g_minus]) if cfg.keep_stacked else None
            effective = g_plus - g_minus
        else:
            stacked = None
            effective = spectral_conv.make_grating(band(prep(kernels)), fft_shape)

        if quant is not None:
            effective = effective * scale
        gain = None
        for stage in pipe:
            gain = stage.fold_gain(gain, ctx)
        if gain is not None:
            effective = effective * gain
        store = cfg.grating_dtype
        if store == "bfloat16":
            eff_re = effective.real.to(torch.bfloat16)
            eff_im = effective.imag.to(torch.bfloat16)
            effective, stacked = None, None
        else:
            eff_re = eff_im = None
        return FusedGrating(
            stacked=stacked,
            effective=effective,
            fft_shape=tuple(fft_shape),
            out_shape=tuple(out_shape),
            kernel_scale=scale,
            echo_gain=(
                torch.ones((), device=self.device) if gain is None else gain
            ),
            encode=pipe.encodes_query,
            slm_bits=bits,
            ker_shape=ker_shape,
            pseudo_negative=pn,
            eff_re=eff_re,
            eff_im=eff_im,
            storage_dtype=store,
        )

    # -- query (fused hot path) --------------------------------------------

    def query(self, grating: FusedGrating, x) -> Tensor:
        """Diffract clips x (B, C, H, W, T) off a recorded grating: one
        ``rfftn``, one MAC, one ``irfftn``.  Returns (B, O, *out_shape)."""
        x = self._as_input(x)
        query = self._query_fn()
        if not grating.encode:
            return query(x, grating.effective_c, grating.fft_shape, grating.out_shape)
        with tracing.span("engine.encode"):
            enc, x_scale = self._encode(x, grating.slm_bits)
        y = query(enc, grating.effective_c, grating.fft_shape, grating.out_shape)
        return y * x_scale

    def query_unfused(self, grating: FusedGrating, x) -> Tensor:
        """The two-query ± reference path: one FFT + MAC + IFFT per
        pseudo-negative grating, combine and de-scale in the epilogue."""
        if not grating.pseudo_negative:
            return self.query(grating, x)
        if grating.stacked is None:
            raise ValueError(
                "grating was recorded without the stacked ± tensors; the "
                "unfused reference path needs them"
            )
        x = self._as_input(x)
        query = self._query_fn()
        if grating.encode:
            enc, x_scale = self._encode(x, grating.slm_bits)
        else:
            enc, x_scale = x, None
        y_plus = query(enc, grating.stacked[0], grating.fft_shape, grating.out_shape)
        y_minus = query(enc, grating.stacked[1], grating.fft_shape, grating.out_shape)
        y = pseudo_negative.combine(y_plus, y_minus)
        k_scale = grating.kernel_scale[:, 0, 0, 0, 0]
        y = y * k_scale[None, :, None, None, None]
        if x_scale is not None:
            y = y * x_scale
        return y * grating.echo_gain

    # -- query (streaming / overlap-save) ----------------------------------

    def query_stream(
        self,
        grating: FusedGrating,
        x,
        *,
        chunk_windows: int | None = None,
        max_buffer_windows: int | None = None,
        readout_k: int | None = None,
    ) -> "Tensor | TopKDetections":
        """Stream clips x (B, C, H, W, T) through a window-geometry grating
        (recorded at ``(H, W, block_t)``) with overlap-save and a
        stream-global SLM scale.

        ``chunk_windows`` windows run per step as one batch (default
        ``config.osave_chunk_windows``); streams needing more than
        ``max_buffer_windows`` windows (default
        ``config.osave_max_buffer_windows``) go through the stream
        cursor; ``readout_k`` returns :class:`TopKDetections` instead of
        the (B, O, H−kh+1, W−kw+1, T−kt+1) volume."""
        if grating.ker_shape is None:
            raise ValueError("grating lacks ker_shape; re-record before streaming")
        x = host_stream(x, self.device)
        kh, kw, kt = grating.ker_shape
        oh, ow, _ = grating.out_shape
        frame_hw = (oh + kh - 1, ow + kw - 1)
        if tuple(x.shape[-3:-1]) != frame_hw:
            raise ValueError(
                f"clip spatial dims {tuple(x.shape[-3:-1])} do not match "
                f"the recorded frame size {frame_hw}"
            )
        plan = self.stream_plan_for(grating, x.shape[-1], chunk_windows)
        mbw = self._max_buffer_windows(max_buffer_windows)
        effective = grating.effective_c
        query = self._query_fn()

        def window_fn(win, win_out):
            return query(win, effective, grating.fft_shape, win_out)

        static = dict(
            ker_shape=grating.ker_shape,
            encode=grating.encode,
            slm_bits=grating.slm_bits,
            k=readout_k,
        )
        out_shape = (oh, ow, plan.n_valid)
        if mbw is None or plan.n_blocks <= mbw:
            out = self._osave(self._as_input(x), window_fn, None, plan=plan, **static)
            if readout_k is not None:
                return TopKDetections(out[0], out[1], out_shape)
            return out
        cursor = spectral_conv.stream_cursor(x.shape[-1], kt, plan.block_t, plan.chunk, mbw)
        x_scale = self._host_scale(x) if grating.encode else None
        upload = _SegmentUploader(self.device)
        outs, nv_locals, t0s = [], [], []
        for seg in cursor:
            seg_plan = _segment_plan(seg, plan, kt)
            outs.append(
                self._osave(
                    upload(x[..., seg.t0 : seg.t1]), window_fn, x_scale, plan=seg_plan, **static
                )
            )
            nv_locals.append(seg_plan.n_valid)
            t0s.append(seg.out_t0)
        if readout_k is not None:
            s, i = _segments_rebase_merge(
                [o[0] for o in outs],
                [o[1] for o in outs],
                k=int(readout_k),
                nv_locals=tuple(nv_locals),
                t0s=tuple(t0s),
                nv_total=plan.n_valid,
            )
            return TopKDetections(s, i, out_shape)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def _max_buffer_windows(self, override: int | None) -> int | None:
        mbw = override if override is not None else self.config.osave_max_buffer_windows
        return None if mbw is None else max(int(mbw), 1)

    def _host_scale(self, x: Tensor) -> Tensor:
        """The stream-global SLM scale, taken where the stream lives (a max
        is exact, so it is bitwise the device's), on the device."""
        return _stream_scale(x).to(self.device)

    def stream_plan_for(
        self, grating: FusedGrating, n_frames: int, chunk_windows: int | None = None
    ) -> spectral_conv.StreamPlan:
        """The overlap-save plan a streaming query of ``n_frames`` frames
        runs under, derived from the grating's recorded geometry."""
        kt = grating.ker_shape[-1]
        block_t = grating.out_shape[-1] + kt - 1
        if chunk_windows is None:
            chunk_windows = self.config.osave_chunk_windows
        return spectral_conv.stream_plan(n_frames, kt, block_t, chunk_windows)

    def _osave(self, x, window_fn, x_scale, *, plan, ker_shape, encode, slm_bits, k):
        """The overlap-save driver shared by every streaming path.

        Encodes (stream-global scale; ``x_scale`` carries a precomputed
        one when ``x`` is a cursor segment), pads the time axis, and per
        chunk stacks the chunk's windows on the batch axis — window-major,
        (chunk·B, C, H, W, block_t) — so ``window_fn`` runs one FFT, one
        MAC launch and one IFFT per chunk.  ``k=None`` stitches the
        volume; otherwise every chunk collapses to a (B, O, k) top-K state
        and the states fold into one.  Both routes compute each window
        chunk identically, so fused scores are bitwise the stitched ones.
        """
        kh, kw, _ = ker_shape
        H, W = x.shape[-3:-1]
        with tracing.span("engine.encode"):
            if encode:
                x, x_scale = self._encode(x, slm_bits, x_scale)
            else:
                x_scale = None
            if plan.pad_t:
                x = torch.nn.functional.pad(x, (0, plan.pad_t))
        B = x.shape[0]
        win_out = (H - kh + 1, W - kw + 1, plan.step)
        readout = self._readout_fn() if k is not None else None
        blocks, states = [], []
        for c0 in range(0, plan.n_padded, plan.chunk):
            with tracing.span("engine.chunk"):
                starts = [(c0 + j) * plan.step for j in range(plan.chunk)]
                win = torch.cat([x[..., s : s + plan.block_t] for s in starts], dim=0)
                y = window_fn(win, win_out)
                y = y.reshape((plan.chunk, B) + tuple(y.shape[1:]))
                if k is None:
                    blocks.append(y)
                else:
                    with tracing.span("engine.readout"):
                        states.append(
                            self._chunk_topk(y, starts, plan, win_out, x_scale, readout, k)
                        )
        if k is not None:
            with tracing.span("engine.readout"):
                return self._fold_chunk_states(states, k)
        with tracing.span("engine.stitch"):
            y = spectral_conv.stitch_windows(torch.stack(blocks), plan)
            if x_scale is not None:
                y = y * x_scale
        return y

    # -- query (fused detection readout) ------------------------------------

    def _readout_fn(self):
        """The per-chunk top-K reduction: kernel B3 under ``use_pallas``,
        else one dense ``topk_select`` — bitwise-equal states."""
        use_pallas = bool(self.config.use_pallas)

        def readout(vals, gidx, k):
            return stmul_ops.topk_readout(vals, gidx, k, use_pallas=use_pallas)

        return readout

    def _chunk_topk(self, win, starts, plan, win_out, x_scale, readout, k):
        """Collapse one window chunk (chunk, B, O, H', W', step) to the
        (B, O, k) state: de-scale, synthesize each element's global flat
        position in the (H', W', n_valid) stream volume, mask the
        outputs past ``n_valid`` to −inf / the sentinel, and reduce."""
        Hp, Wp, step = win_out
        nv = plan.n_valid
        dev = win.device
        if x_scale is not None:
            win = win * x_scale[None]
        t_glob = (
            torch.as_tensor(starts, dtype=torch.long, device=dev)[:, None]
            + torch.arange(step, device=dev)[None, :]
        )  # (chunk, step)
        hw = (
            torch.arange(Hp, device=dev)[:, None] * Wp
            + torch.arange(Wp, device=dev)[None, :]
        )
        gidx = hw[None, :, :, None] * nv + t_glob[:, None, None, :]
        valid = t_glob < nv
        gidx = torch.where(valid[:, None, None, :], gidx, TOPK_EMPTY_IDX).to(torch.int32)
        win = torch.where(
            valid[:, None, None, None, None, :],
            win,
            torch.full((), float("-inf"), dtype=win.dtype, device=dev),
        )
        B, O = win.shape[1], win.shape[2]
        flat = torch.movedim(win, 0, 2).reshape(B, O, -1)
        return readout(flat, gidx.reshape(-1), k)

    @staticmethod
    def _fold_chunk_states(states, k):
        """Per-chunk (B, O, k) states → one exact (B, O, k) top-K."""
        s = torch.cat([st[0] for st in states], dim=-1)
        i = torch.cat([st[1] for st in states], dim=-1)
        return _merge_topk_states([(s, i)], k)

    # -- query (pooled cross-tenant batch) ----------------------------------

    def query_many(
        self,
        requests: "Sequence[tuple[FusedGrating, object]]",
        *,
        clip_keys: "Sequence[tuple | None] | None" = None,
        dedup: bool = True,
        mesh=None,
    ) -> list[Tensor]:
        """Answer a mixed-tenant clip batch with one dispatch per pool
        group: one forward FFT over the stacked clips, one pooled MAC in
        which every row reads its own tenant's O-slice (kernel B2 under
        ``use_pallas``), one inverse FFT.  Rows whose clips hash equal
        collapse onto one physical row (``dedup``).

        ``mesh`` (a :class:`~repro_torch.launch.mesh.LocalMesh`) shards
        each group: the arena in tiles over the model axis, the physical
        clip rows over the data axis; every shard contracts its rows with
        its whole tile, and each answer is bitwise the single-device
        one.  Returns outputs in request order, each (B_i, O_i,
        *out_shape)."""
        requests = [(g, self._as_input(x)) for g, x in requests]
        groups = self._group_requests(requests)
        keys = self._clip_ids(requests, clip_keys, dedup)
        results: list[Tensor | None] = [None] * len(requests)
        shards = int(mesh.shape["model"]) if mesh is not None else 1
        for idxs in groups.values():
            gratings = [requests[i][0] for i in idxs]
            members, slot_of = _dedup_members(gratings)
            pool = self._pool_for(members, shards)
            xs = [requests[i][1] for i in idxs]
            gkeys = [keys[i] for i in idxs]
            if mesh is not None:
                lay = self._mesh_layout(pool, slot_of, gkeys)
            else:
                lay = self._dedup_layout(pool, gratings, slot_of, gkeys)
            ux = [xs[j] for j in lay.uniq]
            x = ux[0] if len(ux) == 1 else torch.cat(ux, dim=0)
            nbs = [int(xj.shape[0]) for xj in ux]
            rows = [r for u, nb in enumerate(nbs) for r in [lay.row_of[u]] * nb]
            self._count_pooled(sum(int(xj.shape[0]) for xj in xs), sum(nbs))
            if mesh is not None:
                y = self._mesh_oneshot(x, pool, mesh, gratings[0])
            else:
                y = self._pooled_dispatch(x, pool, rows, gratings[0], n_out=lay.n_out)
            ub0 = np.concatenate([[0], np.cumsum(nbs)])
            for j, i in enumerate(idxs):
                b0 = int(ub0[lay.uniq_of[j]])
                nb = int(xs[j].shape[0])
                oo = lay.o_off[j]
                results[i] = y[b0 : b0 + nb, oo : oo + gratings[j].n_out]
        return results  # type: ignore[return-value]

    def _clip_ids(self, requests, clip_keys, dedup) -> list:
        """Per-request clip identities for the dedup grouping (passed in,
        or hashed here once per array object)."""
        if not dedup:
            return [None] * len(requests)
        if clip_keys is not None:
            if len(clip_keys) != len(requests):
                raise ValueError(
                    f"clip_keys has {len(clip_keys)} entries for "
                    f"{len(requests)} requests"
                )
            return list(clip_keys)
        return clip_keys_for([x for _, x in requests])

    def _dedup_layout(
        self,
        pool: GratingPool,
        gratings: list[FusedGrating],
        slot_of: list[int],
        keys: list,
    ) -> _DedupLayout:
        """Collapse group rows with content-equal clips onto shared
        physical rows, each reading the union span of the member slices
        requested for its clip; ``n_out`` is the widest span."""
        uniq, uniq_of = _unique_clips(keys)
        span_lo: list = [None] * len(uniq)
        span_hi = [0] * len(uniq)
        for j, u in enumerate(uniq_of):
            s = pool.o_start[slot_of[j]]
            e = s + gratings[j].n_out
            span_lo[u] = s if span_lo[u] is None else min(span_lo[u], s)
            span_hi[u] = max(span_hi[u], e)
        n_out = max(hi - lo for lo, hi in zip(span_lo, span_hi))
        o_off = [pool.o_start[slot_of[j]] - span_lo[uniq_of[j]] for j in range(len(uniq_of))]
        return _DedupLayout(uniq=uniq, uniq_of=uniq_of, row_of=span_lo, o_off=o_off, n_out=n_out)

    def query_stream_many(
        self,
        requests: "Sequence[tuple[FusedGrating, object]]",
        *,
        chunk_windows: int | None = None,
        max_buffer_windows: int | None = None,
        clip_keys: "Sequence[tuple | None] | None" = None,
        dedup: bool = True,
        readout_k: int | None = None,
        mesh=None,
    ) -> "list[Tensor] | list[TopKDetections]":
        """Pooled :meth:`query_stream`: mixed-tenant long clips sharing the
        window geometry stack on the batch axis and every window chunk
        runs one pooled FFT + MAC + IFFT against the group arena, with
        clip-dedup, the stream cursor and the fused readout as in
        :meth:`query_many` / :meth:`query_stream`.  Each request's output
        equals ``query_stream(grating_i, x_i)``.  ``mesh`` shards every
        group as in :meth:`query_many`, window chunks and cursor segments
        included; volumes and top-K states are bitwise the single-device
        ones."""
        requests = [(g, host_stream(x, self.device)) for g, x in requests]
        groups = self._group_requests(requests, stream=True)
        keys = self._clip_ids(requests, clip_keys, dedup)
        results: list = [None] * len(requests)
        shards = int(mesh.shape["model"]) if mesh is not None else 1
        for idxs in groups.values():
            gratings = [requests[i][0] for i in idxs]
            g0 = gratings[0]
            if g0.ker_shape is None:
                raise ValueError("grating lacks ker_shape; re-record before streaming")
            with tracing.span("engine.layout"):
                members, slot_of = _dedup_members(gratings)
                pool = self._pool_for(members, shards)
                xs = [requests[i][1] for i in idxs]
                kh, kw, kt = g0.ker_shape
                oh, ow, _ = g0.out_shape
                frame_hw = (oh + kh - 1, ow + kw - 1)
                if tuple(xs[0].shape[-3:-1]) != frame_hw:
                    raise ValueError(
                        f"clip spatial dims {tuple(xs[0].shape[-3:-1])} do not "
                        f"match the recorded frame size {frame_hw}"
                    )
                gkeys = [keys[i] for i in idxs]
                if mesh is not None:
                    lay = self._mesh_layout(pool, slot_of, gkeys)
                else:
                    lay = self._dedup_layout(pool, gratings, slot_of, gkeys)
                ux = [xs[j] for j in lay.uniq]
                nbs = [int(xj.shape[0]) for xj in ux]
                ub0 = [0]
                for nb in nbs:
                    ub0.append(ub0[-1] + nb)
                rows = [r for u, nb in enumerate(nbs) for r in [lay.row_of[u]] * nb]
                splits = [
                    (ub0[lay.uniq_of[j]], int(xs[j].shape[0]), lay.o_off[j], gratings[j].n_out)
                    for j in range(len(idxs))
                ]
                self._count_pooled(sum(int(xj.shape[0]) for xj in xs), sum(nbs))
                x = stack_streams(ux, self.device)
                plan = self.stream_plan_for(g0, x.shape[-1], chunk_windows)
                mbw = self._max_buffer_windows(max_buffer_windows)
                chunked = mbw is not None and plan.n_blocks > mbw
                static = dict(
                    ker_shape=g0.ker_shape, encode=g0.encode, slm_bits=g0.slm_bits, k=readout_k
                )
                if mesh is not None:
                    run = self._mesh_stream_fn(pool, mesh, g0.fft_shape, static)
                else:
                    max_row = max(lay.row_of) if lay.row_of else 0
                    pool_re, pool_im = self._padded_arena(pool, max_row, lay.n_out)
                    upload = _SegmentUploader(self.device) if chunked else self._as_input

                    def run(xs_, x_scale, p):
                        window_fn = self._pooled_window_fn(
                            pool_re, pool_im, rows, lay.n_out, g0.fft_shape, p.chunk
                        )
                        return self._osave(upload(xs_), window_fn, x_scale, plan=p, **static)

            stream_out = (oh, ow, plan.n_valid)
            if not chunked:
                out = run(x, None, plan)
                if readout_k is None:
                    outs = [out[b0 : b0 + nb, oo : oo + o] for b0, nb, oo, o in splits]
                else:
                    outs = [
                        TopKDetections(
                            out[0][b0 : b0 + nb, oo : oo + o],
                            out[1][b0 : b0 + nb, oo : oo + o],
                            stream_out,
                        )
                        for b0, nb, oo, o in splits
                    ]
            else:
                cursor = spectral_conv.stream_cursor(x.shape[-1], kt, plan.block_t, plan.chunk, mbw)
                x_scale = self._host_scale(x) if g0.encode else None
                seg_outs, nv_locals, t0s = [], [], []
                for seg in cursor:
                    seg_plan = _segment_plan(seg, plan, kt)
                    seg_outs.append(run(x[..., seg.t0 : seg.t1], x_scale, seg_plan))
                    nv_locals.append(seg_plan.n_valid)
                    t0s.append(seg.out_t0)
                if readout_k is None:
                    out = torch.cat(seg_outs, dim=-1)
                    outs = [out[b0 : b0 + nb, oo : oo + o] for b0, nb, oo, o in splits]
                else:
                    outs = []
                    for b0, nb, oo, o in splits:
                        s, i = _segments_rebase_merge(
                            [so[0][b0 : b0 + nb, oo : oo + o] for so in seg_outs],
                            [so[1][b0 : b0 + nb, oo : oo + o] for so in seg_outs],
                            k=int(readout_k),
                            nv_locals=tuple(nv_locals),
                            t0s=tuple(t0s),
                            nv_total=plan.n_valid,
                        )
                        outs.append(TopKDetections(s, i, stream_out))
            for j, i in enumerate(idxs):
                results[i] = outs[j]
        return results

    def _pooled_window_fn(self, pool_re, pool_im, rows, n_out, fft_shape, chunk):
        """The per-chunk pooled FFT + MAC + IFFT over a window-major batch
        of ``chunk`` windows × ``len(rows)`` rows: the grouped kernel B2
        under ``use_pallas`` (row offsets repeated per window), else the
        dense einsum against the row slices gathered once."""
        if self.config.use_pallas:
            rows_w = list(rows) * chunk

            def window_fn(win, win_out):
                return stmul_ops.query_grating_pooled(
                    win, pool_re, pool_im, rows_w, n_out, fft_shape, win_out
                )

            return window_fn
        sel = _pool_select(pool_re, pool_im, rows, n_out)

        def window_fn(win, win_out):
            return _presel_query_dense(win, sel, fft_shape, win_out)

        return window_fn

    def _group_requests(self, requests, stream: bool = False) -> dict:
        """Pool-group the requests: same FFT geometry + encode semantics
        + storage dtype + clip geometry share one arena / dispatch."""
        groups: dict[tuple, list[int]] = {}
        for i, (g, x) in enumerate(requests):
            if x.ndim != 5:
                raise ValueError(
                    f"request {i}: clips must be (B, C, H, W, T), got "
                    f"shape {tuple(x.shape)}"
                )
            if int(x.shape[1]) != g.channels:
                raise ValueError(
                    f"request {i}: clip has {x.shape[1]} channels; the "
                    f"grating was recorded with {g.channels}"
                )
            key = (
                g.fft_shape,
                g.out_shape,
                g.ker_shape if stream else None,
                bool(g.encode),
                int(g.slm_bits) if g.encode else -1,
                g.storage_dtype,
                tuple(x.shape[1:]),
                str(x.dtype),
            )
            groups.setdefault(key, []).append(i)
        return groups

    def _pool_for(self, members: list[FusedGrating], shards: int = 1) -> GratingPool:
        """Fetch or build the packed arena for this member list, memoized
        per (member identity, shard count) — gratings are immutable once
        recorded, and one member set tiled differently is another arena —
        with a small LRU bound."""
        key = (tuple(id(g) for g in members), int(shards))
        with self._pools_lock:
            pool = self._pools.get(key)
            if pool is not None:
                self._pools.move_to_end(key)
                return pool
        pool = _build_pool(members, shards)
        with self._pools_lock:
            self._pools[key] = pool
            while len(self._pools) > self._max_pools:
                self._pools.popitem(last=False)
        return pool

    def _padded_arena(
        self, pool: GratingPool, max_row: int, n_out: int
    ) -> tuple[Tensor, Tensor]:
        """The pool planes row-padded for ``[row, row + n_out)`` reads,
        memoized per (pool, rows needed)."""
        need = int(max_row) + int(n_out) - int(pool.re.shape[0])
        if need <= 0:
            return pool.re, pool.im
        key = (id(pool), int(max_row) + int(n_out))
        with self._pools_lock:
            hit = self._padded.get(key)
            if hit is not None:
                self._padded.move_to_end(key)
                return hit[1], hit[2]
        re, im = _pad_arena(pool.re, pool.im, max_row, n_out)
        with self._pools_lock:
            self._padded[key] = (pool, re, im)
            while len(self._padded) > self._max_pools:
                self._padded.popitem(last=False)
        return re, im

    # -- mesh-sharded execution (query_many / query_stream_many mesh=) -----

    def _mesh_layout(self, pool: GratingPool, slot_of: list[int], keys: list) -> _DedupLayout:
        """Row layout of a mesh dispatch: full-arena fan-out.  Every
        physical row reads the whole tiled arena (each model shard its
        own tile), so a request's answer is the slice at its member's
        absolute ``o_start``, and clip-dedup keeps only the collapse onto
        unique clips."""
        uniq, uniq_of = _unique_clips(keys)
        return _DedupLayout(
            uniq=uniq,
            uniq_of=uniq_of,
            row_of=[0] * len(uniq),
            o_off=[pool.o_start[slot_of[j]] for j in range(len(uniq_of))],
            n_out=int(pool.re.shape[0]),
        )

    def _mesh_arena(self, pool: GratingPool, mesh) -> tuple:
        """The arena's tiles placed on the mesh: the pool's ``shards``
        tiles over the model axis, tile ``mi`` on device
        ``(di, mi)`` of every data row (each holds its own copy; on the
        arena's own device it is a view).  Memoized per (pool, mesh), so
        the tiles move once per membership, not per dispatch."""
        key = (id(pool), mesh)
        with self._pools_lock:
            hit = self._mesh_arenas.get(key)
            if hit is not None:
                self._mesh_arenas.move_to_end(key)
                return hit[1]
        d, m = mesh.data_ranks, mesh.shape["model"]
        if pool.shards != m:
            raise ValueError(f"a pool of {pool.shards} tiles on a mesh of {m} model shards")
        s = pool.shard_rows
        tiles = tuple(
            tuple(
                (
                    pool.re[mi * s : (mi + 1) * s].to(mesh.device(di, mi)),
                    pool.im[mi * s : (mi + 1) * s].to(mesh.device(di, mi)),
                )
                for mi in range(m)
            )
            for di in range(d)
        )
        with self._pools_lock:
            self._mesh_arenas[key] = (pool, tiles)
            while len(self._mesh_arenas) > self._max_pools:
                self._mesh_arenas.popitem(last=False)
        return tiles

    @staticmethod
    def _mesh_dispatch(mesh, tiles, x, x_scale, per_row: int, upload, body):
        """Run one physical batch over the mesh.  The rows are zero-padded
        to a multiple of the data axis (a pad row's scale is 1) and data
        row ``di`` takes ``b_local`` of them; ``body(x_l, scale_l, tile_re,
        tile_im)`` runs shard ``(di, mi)`` on its device and returns a
        tensor, or a tuple of them, of (b_local, tile rows, ...), placed
        at ``[di * b_local, mi * tile rows]`` of one output on the mesh's
        first device.

        ``per_row`` is the transforms one row gives a forward FFT.  On a
        mesh with a CPU device, when a shard's FFT would be a lone
        transform while the unsharded one batches several, the shard
        takes a zero companion row, dropped from its output: a lone FFT
        on the CPU rounds differently from the same transform in a batch
        (ROADMAP C.14).  cuFFT shows no such batch dependence, so a card
        shard never pays for the companion."""
        d, m = mesh.data_ranks, mesh.shape["model"]
        b = int(x.shape[0])
        bl = -(-b // d)
        if d * bl > b:
            x = torch.cat([x, x.new_zeros((d * bl - b,) + tuple(x.shape[1:]))])
            if x_scale is not None:
                x_scale = torch.cat(
                    [x_scale, x_scale.new_ones((d * bl - b,) + tuple(x_scale.shape[1:]))]
                )
        on_cpu = any(dev.type == "cpu" for row in mesh.devices for dev in row)
        companion = on_cpu and bl * per_row == 1 < b * per_row
        out, single = None, True
        for di in range(d):
            xl = x[di * bl : (di + 1) * bl]
            sl = None if x_scale is None else x_scale[di * bl : (di + 1) * bl]
            if companion:
                xl = torch.cat([xl, torch.zeros_like(xl)])
                sl = None if sl is None else torch.cat([sl, torch.ones_like(sl)])
            placed: dict = {}
            for mi in range(m):
                dev = mesh.device(di, mi)
                ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
                with ctx:
                    if dev not in placed:
                        placed[dev] = (upload(xl, dev), None if sl is None else sl.to(dev))
                    tre, tim = tiles[di][mi]
                    ys = body(*placed[dev], tre, tim)
                single = isinstance(ys, Tensor)
                ys = (ys,) if single else ys
                s = int(tre.shape[0])
                if out is None:
                    out = tuple(
                        torch.empty(
                            (d * bl, m * s) + tuple(y.shape[2:]),
                            dtype=y.dtype,
                            device=mesh.device(0, 0),
                        )
                        for y in ys
                    )
                for o, y in zip(out, ys):
                    o[di * bl : (di + 1) * bl, mi * s : (mi + 1) * s] = y[:bl]
        return out[0] if single else out

    def _mesh_stream_fn(self, pool: GratingPool, mesh, fft_shape, static: dict):
        """The sharded overlap-save pass of one pool group: ``run(x,
        x_scale, plan)`` runs the single-device ``_osave`` body on every
        shard — encode, one ``rfftn`` per window chunk, B2 through
        ``pooled_query_shard`` (or the dense gather at offset 0), the
        ``irfftn``, the stitch or the fused B3 top-K — and returns the
        group's (rows, arena rows, ...) output.  Host rows reach each
        device through pinned buffers, one uploader per device."""
        tiles = self._mesh_arena(pool, mesh)
        uploaders: dict = {}

        def upload(t, dev):
            if dev not in uploaders:
                uploaders[dev] = _SegmentUploader(dev)
            return uploaders[dev](t)

        def run(x, x_scale, plan):
            def body(xl, sl, tre, tim):
                if self.config.use_pallas:

                    def window_fn(win, win_out):
                        return stmul_ops.pooled_query_shard(win, tre, tim, fft_shape, win_out)

                else:
                    window_fn = self._pooled_window_fn(
                        tre, tim, [0] * int(xl.shape[0]), int(tre.shape[0]), fft_shape, plan.chunk
                    )
                return self._osave(xl, window_fn, sl, plan=plan, **static)

            per_row = plan.chunk * int(x.shape[1])
            return self._mesh_dispatch(mesh, tiles, x, x_scale, per_row, upload, body)

        return run

    def _mesh_oneshot(self, x: Tensor, pool: GratingPool, mesh, proto: FusedGrating) -> Tensor:
        """The sharded one-shot dispatch: encode the whole batch (as the
        single-device dispatch does), then per shard one FFT, B2 through
        ``pooled_query_shard`` (or the dense gather at offset 0), one
        IFFT and the de-scale."""
        x_scale = None
        if proto.encode:
            x, x_scale = self._encode(x, proto.slm_bits)
        use_pallas = self.config.use_pallas

        def body(xl, sl, tre, tim):
            if use_pallas:
                y = stmul_ops.pooled_query_shard(xl, tre, tim, proto.fft_shape, proto.out_shape)
            else:
                y = _pooled_query_dense(
                    xl, tre, tim, [0] * int(xl.shape[0]), int(tre.shape[0]),
                    proto.fft_shape, proto.out_shape,
                )
            return y if sl is None else y * sl

        tiles = self._mesh_arena(pool, mesh)
        return self._mesh_dispatch(
            mesh, tiles, x, x_scale, int(x.shape[1]), lambda t, dev: t.to(dev), body
        )

    def _pooled_dispatch(
        self,
        x: Tensor,
        pool: GratingPool,
        rows: list[int],
        proto: FusedGrating,
        n_out: int | None = None,
    ) -> Tensor:
        """One pooled FFT + MAC + IFFT (+ the group's encode epilogue)."""
        if n_out is None:
            n_out = pool.n_out
        max_row = max(rows) if rows else 0
        pool_re, pool_im = self._padded_arena(pool, max_row, n_out)
        if self.config.use_pallas:
            query = stmul_ops.query_grating_pooled
        else:
            query = _pooled_query_dense
        if not proto.encode:
            return query(x, pool_re, pool_im, rows, n_out, proto.fft_shape, proto.out_shape)
        enc, x_scale = self._encode(x, proto.slm_bits)
        y = query(enc, pool_re, pool_im, rows, n_out, proto.fft_shape, proto.out_shape)
        return y * x_scale

    # -- internals ---------------------------------------------------------

    def _encode(
        self, x: Tensor, bits: int, x_scale: Tensor | None = None
    ) -> tuple[Tensor, Tensor]:
        """SLM front end: non-negative clip, one scale per example
        (``x_scale`` overrides it for a segment of a longer stream),
        quantized at ``bits``.  Returns (encoded, x_scale)."""
        x = torch.clamp(x, min=0.0)
        if x_scale is None:
            x_scale = _stream_scale(x)
        return optics.quantize_unit(x / x_scale, bits), x_scale

    def _query_fn(self):
        """Single-grating FFT + MAC + IFFT: kernel B1 under
        ``use_pallas``, the einsum path otherwise."""
        cfg = self.config
        if not cfg.use_pallas:
            return spectral_conv.query_grating
        version = cfg.stmul_version

        def query(x, grating, fft_shape, out_shape):
            return stmul_ops.query_grating_pallas(
                x, grating, fft_shape, out_shape, version=version
            )

        return query


# ---------------------------------------------------------------------------
# Grating cache — record once across calls
# ---------------------------------------------------------------------------


def _grating_checksum(grating: FusedGrating) -> float:
    """Σ|re| + Σ|im| over the stored planes in f32 (NaN poisons it)."""
    re, im = grating.planes
    total = torch.sum(torch.abs(re.float())) + torch.sum(torch.abs(im.float()))
    return float(total)


class _InFlight:
    """Per-key record-in-progress marker: waiters block on ``event`` and
    pick up ``grating`` even when it was not admitted to the cache."""

    __slots__ = ("event", "grating")

    def __init__(self):
        self.event = threading.Event()
        self.grating: FusedGrating | None = None


class GratingCache:
    """Content-addressed LRU cache of recorded gratings.

    Keyed on the kernel bytes (SHA-1), kernel shape/dtype, the signal
    shape and the record-relevant config: the fidelity fingerprint, the
    device models, the storage interval, whether the ± stack is kept,
    the storage dtype and the torch device the grating lives on.
    Query-side knobs do not key.  The LRU budget is ``max_entries`` and
    optionally ``max_bytes``; a grating larger than ``max_bytes`` is
    served uncached.  ``verify=True`` checksums every hit and
    re-records a corrupted entry.
    """

    def __init__(
        self,
        max_entries: int = 8,
        max_bytes: int | None = None,
        verify: bool = False,
    ):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.verify = verify
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.shared = 0  # in-flight results never admitted; guarded-by: _lock
        self.integrity_failures = 0  # verify=True mismatches; guarded-by: _lock
        self._entries: OrderedDict[tuple, FusedGrating] = OrderedDict()  # guarded-by: _lock
        self._sums: dict[tuple, float] = {}  # insertion checksums; guarded-by: _lock
        self._nbytes = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        # concurrent misses for one key wait on the first recorder
        self._inflight: dict[tuple, _InFlight] = {}  # guarded-by: _lock

    @staticmethod
    def key_for(kernels, signal_shape: tuple[int, int, int], config) -> tuple:
        """Cache key of a kernel stack under a config."""
        if isinstance(kernels, Tensor):
            arr = kernels.detach().cpu().contiguous().numpy()
        else:
            arr = np.ascontiguousarray(kernels)
        digest = hashlib.sha1(arr.tobytes()).hexdigest()
        store = config.grating_dtype
        record_cfg = (
            config.fidelity.fingerprint(),
            config.slm,
            config.atoms,
            config.storage_interval_s,
            (
                config.keep_stacked
                if config.fidelity.has(fidelity_mod.PseudoNegative)
                and store == "float32"
                else True
            ),
            store,
            str(config.device),
        )
        return (digest, tuple(arr.shape), str(arr.dtype), tuple(signal_shape), record_cfg)

    def get_or_record(
        self,
        engine: QueryEngine,
        kernels,
        signal_shape: tuple[int, int, int],
        key: tuple | None = None,
        admit=None,
    ) -> FusedGrating:
        """Fetch the grating for ``kernels``, recording on a miss.

        ``key`` lets long-lived callers hash the kernel bytes once;
        ``admit`` (``() -> bool``) is consulted under the cache lock just
        before a fresh grating is inserted — False serves it uncached.

        Kernels that require a gradient, in grad mode, bypass the cache
        (as the reference's traced kernels do): their grating carries the
        graph back to them, and a cached copy recorded without one would
        cut it for every later caller."""
        if isinstance(kernels, Tensor) and kernels.requires_grad and torch.is_grad_enabled():
            return engine.record(kernels, signal_shape)
        if key is None:
            key = self.key_for(kernels, signal_shape, engine.config)
        while True:
            with self._lock:
                hit = self._entries.get(key)
                expect = self._sums.get(key)
                if hit is not None and not self.verify:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return hit
                pending = None
                if hit is None:
                    pending = self._inflight.get(key)
                    if pending is None:
                        self._inflight[key] = pending = _InFlight()
                        break  # this thread records
            if hit is not None:
                if self._checksum_ok(hit, expect):
                    with self._lock:
                        if self._entries.get(key) is hit:
                            self.hits += 1
                            self._entries.move_to_end(key)
                    return hit
                with self._lock:
                    if self._entries.get(key) is hit:
                        self._entries.pop(key)
                        self._sums.pop(key, None)
                        self._nbytes -= hit.nbytes
                        self.integrity_failures += 1
                continue
            pending.event.wait()
            if pending.grating is not None:
                with self._lock:
                    if key in self._entries:
                        self.hits += 1
                        self._entries.move_to_end(key)
                    else:
                        self.shared += 1
                return pending.grating
        try:
            grating = engine.record(kernels, signal_shape)
            chk = _grating_checksum(grating) if self.verify else None
            pending.grating = grating
            with self._lock:
                self.misses += 1
                if admit is not None and not admit():
                    return grating
                if self.max_bytes is not None and grating.nbytes > self.max_bytes:
                    return grating
                if key in self._entries:
                    self._nbytes -= self._entries.pop(key).nbytes
                    self._sums.pop(key, None)
                self._entries[key] = grating
                if chk is not None:
                    self._sums[key] = chk
                self._nbytes += grating.nbytes
                while self._entries and self._over_budget():
                    evicted_key, evicted = self._entries.popitem(last=False)
                    self._sums.pop(evicted_key, None)
                    self._nbytes -= evicted.nbytes
                    self.evictions += 1
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            pending.event.set()
        return grating

    @staticmethod
    def _checksum_ok(grating: FusedGrating, expect: float | None) -> bool:
        """NaN-safe comparison (a NaN fresh sum reads as a mismatch)."""
        if expect is None:
            return True
        fresh = _grating_checksum(grating)
        return abs(fresh - expect) <= 1e-3 * max(abs(expect), 1.0)

    def discard(self, key: tuple | None) -> bool:
        """Invalidate one entry (tenant removal)."""
        if key is None:
            return False
        with self._lock:
            grating = self._entries.pop(key, None)
            if grating is None:
                return False
            self._sums.pop(key, None)
            self._nbytes -= grating.nbytes
            return True

    def _over_budget(self) -> bool:  # holds-lock: _lock
        if len(self._entries) > self.max_entries:
            return True
        return self.max_bytes is not None and self._nbytes > self.max_bytes

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def stats(self) -> dict:
        """Counter / footprint snapshot for serving metrics."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "shared": self.shared,
                "entries": len(self._entries),
                "bytes": self._nbytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "verify": self.verify,
                "integrity_failures": self.integrity_failures,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._sums.clear()
            self._nbytes = 0
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.shared = 0
            self.integrity_failures = 0


_DEFAULT_CACHE = GratingCache()


def default_cache() -> GratingCache:
    """Process-wide grating cache shared by STHC and serving."""
    return _DEFAULT_CACHE
