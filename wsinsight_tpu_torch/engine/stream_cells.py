"""Streaming banded cell inference: prediction maps never leave the card wholesale.

Counterpart of wsinsight_tpu/engine/stream_cells.py. The host-canvas engine
(engine/cells.py + engine/stitch.py) copies every resized map channel into
host canvases and post-processes from there; most of those bytes (the
K-channel type maps) exist only to produce K numbers per instance. This
engine keeps the maps in device-resident slide-space BANDS and moves
per-pixel data across the link only where the host needs it:

  down per band:  a packed foreground bitmask plus, per foreground pixel,
                  the u8 separation energy (or the device's integer basin),
                  per watershed tile window
  up   per band:  the band-local instance id of each foreground pixel
  down per band:  per-instance type-prob sums + pixel counts (tiny)

Pipeline per band (bands are one watershed-tile row high, aligned with the
host-canvas finalize tiling, so the per-tile math is the host-canvas
device-ridge path's):

  1. each batch's maps are post-processed and scattered into the band
     buffers on the device (``scatter_fused``, on the main thread's stream),
  2. when the y-sorted patch stream has passed a band, it is handed to a
     flusher thread with a CUDA event marking its last scatter; the flusher
     works on its own stream, which waits for that event,
  3. the flusher computes each tile window's energy on the device and
     fetches it into pinned host memory, then runs the sequential tail
     (threshold, seeds, watershed, contours) exactly as ops/hv_postproc
     does, while the main thread dispatches the next forwards,
  4. the instance ids go back up, where an index_add against the
     still-resident type maps yields per-instance class sums, fetched
     without waiting and read at ``finalize``.

Every device -> host copy is read only after its own CUDA event has been
waited for. A failing device program raises: the engine does not fall back
to another transfer or basin mode. Slides whose bands would not fit the
HBM budget, or whose band overflows the per-band instance cap, run on the
host-canvas engine instead (engine/cells.run_cell_inference).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Iterator, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import tqdm

from ..ops.hv_device import make_blur3_core, make_energy_core
from ..ops.hv_postproc import (
    extract_instance_labels,
    extract_instance_labels_from_proposal,
)
from ..parallel.mesh import resolve_device
from ..uri_path import URIPath
from ..utils.profiling import hot_stage as _stage
from ..utils.workers import governed_workers
from .data import Batch, PatchBatchSource
from .stitch import make_map_postprocess

logger = logging.getLogger(__name__)

# One tiling geometry, shared by the stitcher, the HBM admission check, and
# the engine dispatch: these must describe the SAME buffers.
STREAM_TILE = 2048
STREAM_PAD = 64

# Per-band instance cap for the device segment-sum buffer ((cap, K) f32,
# 24 MB at K=6). ~1M instances per 2048-row band is beyond any real tissue
# density; if it is ever hit, StreamingCapacityError reroutes the slide to
# the host-canvas engine (engine/cells.py).
_MAX_IDS = 1 << 20

# Tile windows dispatched ahead of the flusher's watershed loop.
_WINDOWS_AHEAD = 4


class StreamingCapacityError(RuntimeError):
    """The banded engine's static capacity was exceeded for this slide."""


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def _d2h_mbps(device: torch.device) -> float:
    """Device -> host rate (MB/s) of ``device``, probed once per device.

    Decides the default basin mode: the device marker proposal ships about
    twice the window bytes of the sparse-energy wire but removes the host's
    integer-basin stage. On a fat link the extra bytes cost well under a
    millisecond and device mode wins (the host CPU is the contended
    resource); on a thin link the bytes dominate and the host basin wins.
    Times one 4 MB copy into (pinned, on CUDA) host memory after a first
    copy that warms the allocator and the link.
    """
    x = torch.zeros(4 << 20, dtype=torch.uint8, device=device)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=device.type == "cuda")
    for add in (1, 2):
        y = x + add
        _synchronize(device)
        t0 = time.perf_counter()
        host.copy_(y, non_blocking=True)
        _synchronize(device)
        dt = time.perf_counter() - t0
    return (4 << 20) / 1e6 / max(dt, 1e-6)


def _bucket(n: int, floor: int, step: int = 4) -> int:
    """Smallest floor * step^j >= n (static-shape buckets, as the JAX
    package's jit cache needs; the wire keeps them)."""
    cap = floor
    while cap < n:
        cap *= step
    return cap


class _HostCopy:
    """Device -> host copies of ``tensors``, started on the current stream
    into pinned memory and waited for (their CUDA event) only when read."""

    __slots__ = ("_host", "_event")

    def __init__(self, *tensors: torch.Tensor):
        if tensors[0].device.type != "cuda":
            self._host, self._event = list(tensors), None
            return
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self._host, tensors):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        # on the stream the copies went to: the current one of their device
        self._event.record(torch.cuda.current_stream(tensors[0].device))

    def numpy(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host -> device copy of ``arr``: pinned and non-blocking on CUDA (the
    caching host allocator keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _PendingBand(NamedTuple):
    """One flushed band awaiting its deferred class-sums copy (see finalize)."""

    sums: _HostCopy    # (id_cap, K) f32 sums and (id_cap,) f32 counts, in flight
    local_next: int    # 1 + number of band-local instance ids
    records: list      # (local_id, box[4] int64, poly (M,2) int64) per cell


class BandedCellStitcher:
    """Device-banded accumulate + streaming finalize on ``device`` (the card
    unless the caller asks for the CPU, ``parallel.mesh.resolve_device``)."""

    def __init__(
        self,
        n_classes: int,
        slide_width: int,
        slide_height: int,
        slide_patch_size: int,
        slide_halo_size: int,
        slide_mpp: float,
        model_mpp: float,
        min_object_size: int = 20,
        tile_size: int = STREAM_TILE,
        padding_size: int = STREAM_PAD,
        num_flushers: int = 1,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.k = n_classes
        self.w = slide_width
        self.h = slide_height
        self.s = slide_patch_size
        self.halo = slide_halo_size
        self.alpha = model_mpp / slide_mpp
        self.min_object_size = int(min_object_size)
        self.tile = int(tile_size)
        self.pad = int(padding_size)

        s, m = self.s, self.pad
        # buffer rows cover [y0 - pad - s, y0 + band_h + pad + s) so every
        # patch that intersects the banded context fits without clipping;
        # cols cover [-s, W + s) for the same reason.
        self.band_h = self.tile
        self.buf_h = self.band_h + 2 * m + 2 * s
        self.buf_w = self.w + 2 * s

        self._bands: dict[int, tuple] = {}  # band index -> (np, hv, tp) device bufs
        # band index -> [_PendingBand]; filled by the flusher threads
        self._band_results: dict[int, list] = {}
        self._build_kernels()
        # Background flushers overlap the sequential host tail with the main
        # thread's forward/scatter dispatch. Results stay deterministic
        # whatever the thread count: each band is flushed by exactly one
        # worker into its own _band_results slot and bands are merged in
        # index order at finalize. The bounded queue is the HBM
        # backpressure: at most (num_flushers + queue size) popped band
        # buffers are alive beyond the active set (see streaming_fits).
        self.num_flushers = max(1, int(num_flushers))
        self._flush_q: "queue.Queue[tuple | None]" = queue.Queue(maxsize=self.num_flushers + 1)
        self._flush_err: list[BaseException] = []
        self._closing = False
        self._flushers = [
            threading.Thread(target=self._flush_worker, daemon=True, name=f"stream-flush-{i}")
            for i in range(self.num_flushers)
        ]
        for t in self._flushers:
            t.start()

    # -- device programs ----------------------------------------------------
    def _build_kernels(self) -> None:
        mode = os.getenv("WSINSIGHT_STREAM_ENERGY", "u8")
        if mode not in ("u8", "u16", "f32"):
            mode = "u8"
        # Sparse window transfer: ship the u8 energy only at FOREGROUND
        # raster positions (the host rebuilds positions from the bitmask it
        # gets anyway), cutting window D2H from ~1.125 B/px to ~0.125 +
        # fg_fraction B/px. The host zeroes background energy regardless.
        self._sparse_windows = mode == "u8" and os.getenv(
            "WSINSIGHT_STREAM_SPARSE", "1") not in ("0", "")
        # Device marker proposal: the window program ships fg + boundary
        # bitmasks and the integer watershed basin instead of raw energy.
        # Only with the integer tail (it IS the integer basin) and the sparse
        # transfer (the basin gather needs the fg count cap). Unset, the link
        # probe picks it: device mode on fat links, the host basin on thin.
        basin = os.getenv("WSINSIGHT_STREAM_BASIN", "")
        if basin not in ("host", "device"):
            basin = "device" if _d2h_mbps(self.device) >= 250.0 else "host"
        self._basin_device = (
            self._sparse_windows
            and basin == "device"
            and os.getenv("WSINSIGHT_HV_BASIN", "int") not in ("f32", "float32", "float")
        )
        (
            self._scatter_fused,
            self._window_stage,
            self._class_sums_sparse,
            self._window_counts,
            self._window_stage_sparse,
            self._class_sums_from_fg,
            self._window_stage_proposal,
        ) = _cached_kernels(self.s, self.k, float(self.alpha), mode, self.device)

    # -- banding ------------------------------------------------------------
    def _band_origin(self, b: int) -> int:
        return b * self.band_h

    def _buffer_top(self, b: int) -> int:
        return self._band_origin(b) - self.pad - self.s

    def _bands_for_patch(self, y_w: int) -> list[int]:
        """Bands whose READ region [y0 - pad, y1 + pad) the patch overlaps.

        Restricting assignment to the read region (tile windows + class-sum
        interior) keeps every buffer write inside the buffer.
        """
        out = []
        lo = max(0, (y_w - self.pad) // self.band_h - 1)
        hi = min(self._n_bands(), (y_w + self.s + self.pad) // self.band_h + 1)
        for b in range(lo, hi):
            y0 = self._band_origin(b)
            y1 = min(y0 + self.band_h, self.h)
            if y_w + self.s > y0 - self.pad and y_w < y1 + self.pad:
                out.append(b)
        return out

    def _n_bands(self) -> int:
        return max(1, -(-self.h // self.band_h))

    def _get_band(self, b: int):
        if b not in self._bands:
            shape, kw = (self.buf_h, self.buf_w), dict(dtype=torch.bfloat16, device=self.device)
            self._bands[b] = (
                torch.zeros(shape, **kw),
                torch.zeros((*shape, 2), **kw),
                torch.zeros((*shape, self.k), **kw),
            )
        return self._bands[b]

    # -- accumulate ---------------------------------------------------------
    @torch.inference_mode()
    def accumulate_batch(self, pred_dict: dict, batch_coords: np.ndarray, n_valid=None):
        """Post-process one batch's (B, C, h, w) maps (either key convention,
        as ``TileRemapStitcher.device_postprocess`` takes them) into the band
        buffers on the device; hand bands the stream has passed to the
        flushers. Returns without waiting for the device."""
        maps = (pred_dict.get("np", pred_dict.get("nuclei_binary_map")),
                pred_dict.get("hv", pred_dict.get("hv_map")),
                pred_dict.get("tp", pred_dict.get("nuclei_type_map")))
        if any(m is None for m in maps):
            raise KeyError(f"prediction maps missing from {sorted(pred_dict)}")
        with _stage("stream.accumulate"):
            self._accumulate(maps, batch_coords, n_valid)

    def _accumulate(self, maps: tuple, batch_coords: np.ndarray, n_valid) -> None:
        np_logits, hv, tp_logits = (torch.as_tensor(m, device=self.device) for m in maps)

        coords = np.asarray(batch_coords, np.int64)[:, :2] + self.halo
        n = len(coords) if n_valid is None else min(int(n_valid), len(coords))

        # group patches by destination band
        groups: dict[int, list[int]] = {}
        max_y = -1
        for i in range(n):
            y_w, x_w = int(coords[i, 1]), int(coords[i, 0])
            max_y = max(max_y, y_w)
            if x_w < -self.s or x_w > self.w or y_w < -self.s or y_w > self.h:
                logger.warning(f"patch at ({x_w},{y_w}) outside the banded range; skipped")
                continue
            for b in self._bands_for_patch(y_w):
                groups.setdefault(b, []).append(i)

        bsz = len(coords)
        for b, idxs in sorted(groups.items()):
            # (rows, cols, valid) of each patch in the band's buffer: the
            # JAX package's packed (3, B) upload; here the slices are taken
            # on the host
            rcv = np.zeros((3, bsz), np.int32)
            top = self._buffer_top(b)
            for i in idxs:
                rcv[0, i] = int(coords[i, 1]) - top
                rcv[1, i] = int(coords[i, 0]) + self.s
                rcv[2, i] = 1
            bufs = self._get_band(b)
            with _stage("accumulate.scatter_dispatch"):
                self._bands[b] = self._scatter_fused(*bufs, np_logits, hv, tp_logits, rcv)

        # hand bands the sorted stream has fully passed to the flushers
        for b in sorted(self._bands):
            if self._buffer_top(b) + self.buf_h <= max_y:
                self._enqueue_flush(b)

    # -- streaming finalize ---------------------------------------------------
    def _window_specs(self, b: int) -> tuple[list, np.ndarray, tuple]:
        """Tile-window geometry for band b: (specs, starts, sizes).

        One spec per tile: (x0, x1, wy0, wx0, r0, c0, wh, ww), context-
        padded and clipped like the host-canvas path. `starts`/`sizes` append
        the band-INTERIOR row used by the sparse count fetch.
        """
        y0 = self._band_origin(b)
        y1 = min(y0 + self.band_h, self.h)
        top = self._buffer_top(b)
        specs = []
        for x0 in range(0, self.w, self.tile):
            x1 = min(x0 + self.tile, self.w)
            wy0, wy1 = max(0, y0 - self.pad), min(self.h, y1 + self.pad)
            wx0, wx1 = max(0, x0 - self.pad), min(self.w, x1 + self.pad)
            specs.append((x0, x1, wy0, wx0, wy0 - top, wx0 + self.s, wy1 - wy0, wx1 - wx0))
        interior = (y0 - top, self.s, y1 - y0, self.w)
        sizes = tuple((sp[6], sp[7]) for sp in specs) + ((interior[2], interior[3]),)
        starts = np.array([(sp[4], sp[5]) for sp in specs] + [(interior[0], interior[1])],
                          np.int32)
        return specs, starts, sizes

    def _enqueue_flush(self, b: int) -> None:
        if self._flush_err:
            raise self._flush_err[0]
        with _stage("flush.enqueue", n=b) as span:
            bufs = self._bands.pop(b)
            # The band's foreground counts are dispatched NOW, on the main
            # thread's stream, and their copy started, so they have usually
            # landed when a flusher picks the band up.
            counts = None
            if self._sparse_windows and self._band_origin(b) < self.h:
                _, starts, sizes = self._window_specs(b)
                with _stage("flush.counts_dispatch"):
                    counts = _HostCopy(self._window_counts(bufs[0], starts, sizes))
            ready = None  # the band's last scatter, for the flusher's stream to wait on
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
        # the band's span on the flusher is a child of this one
        self._flush_q.put((b, bufs, counts, ready, span.id))

    def _flush_worker(self) -> None:
        stream = None
        ctx = contextlib.ExitStack()
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(stream))
        with ctx, torch.inference_mode():
            while True:
                job = self._flush_q.get()
                try:
                    if job is None:
                        return
                    if not self._closing:  # close() abandons queued work
                        self._flush_band(*job)
                except BaseException as e:  # surfaced on the main thread
                    self._flush_err.append(e)
                finally:
                    self._flush_q.task_done()

    def _flush_band(self, b: int, bufs: tuple, counts: _HostCopy | None = None,
                    ready: "torch.cuda.Event | None" = None, parent: int | None = None) -> None:
        """Flush band b (span ``flush.band``, a child of the band's
        ``flush.enqueue``, counting the band's instances)."""
        with _stage("flush.band", parent=parent) as span:
            span.n = self._flush_band_instances(b, bufs, counts, ready)

    def _flush_band_instances(self, b: int, bufs: tuple, counts: _HostCopy | None,
                              ready: "torch.cuda.Event | None") -> int:
        """Band b's instances into ``_band_results``; returns their number."""
        np_b, hv_b, tp_b = bufs
        y0 = self._band_origin(b)
        y1 = min(y0 + self.band_h, self.h)
        if y1 <= y0:
            return 0
        if ready is not None:
            # This thread's stream waits for the band's last scatter; the
            # buffers, made on the main stream, are marked used on this one
            # so the caching allocator keeps them until its work is done.
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in bufs:
                t.record_stream(stream)
        top = self._buffer_top(b)

        band_labels = np.zeros((y1 - y0, self.w), np.int32)
        band_records: list[tuple] = []  # (local_id, box, poly)
        local_next = 1

        # Tile windows are dispatched a few ahead of the watershed loop with
        # their copies started, so windows i+1..i+d cross the link while the
        # host watersheds window i. The depth bounds the window temps alive.
        specs, _, _ = self._window_specs(b)

        # Sparse mode: the (n_tiles + 1) foreground counts, dispatched at
        # enqueue time, decide each window's gather cap (and let empty
        # windows skip dispatch and fetch); the last, the band INTERIOR's,
        # sizes the class-sums id upload below.
        fg_counts = None
        band_fg = None
        if self._sparse_windows and counts is not None:
            with _stage("flush.window_counts"):
                (fg_counts,) = counts.numpy()
            # Assembled from the window bitmask interiors as they land: the
            # SAME foreground definition the device recomputes, so the id
            # upload below rides fg raster order with no index lane.
            band_fg = np.zeros((y1 - y0, self.w), bool)

        def dispatch_window(i):
            x0, x1, wy0, wx0, r0, c0, wh, ww = specs[i]
            with _stage("flush.window_dispatch"):
                if fg_counts is not None:
                    cnt = int(fg_counts[i])
                    if cnt == 0:  # no foreground: skip dispatch AND fetch
                        return (x0, x1, wy0, wx0, "empty", None)
                    cap = _bucket(cnt, 4096, step=2)
                    if self._basin_device:
                        kind, out = "proposal", self._window_stage_proposal(
                            np_b, hv_b, r0, c0, int(wh), int(ww), cap)
                    else:
                        kind, out = "sparse", self._window_stage_sparse(
                            np_b, hv_b, r0, c0, int(wh), int(ww), cap)
                    staged = (out,)
                else:
                    dense = self._window_stage(np_b, hv_b, r0, c0, int(wh), int(ww))
                    kind, staged = "dense", dense if isinstance(dense, tuple) else (dense,)
                fetch = _HostCopy(*staged)
            return (x0, x1, wy0, wx0, kind, fetch)

        tile_idx = deque(range(len(specs)))
        windows: deque = deque()
        while tile_idx and len(windows) < _WINDOWS_AHEAD:
            windows.append(dispatch_window(tile_idx.popleft()))

        while windows:
            x0, x1, wy0, wx0, kind, fetch = windows.popleft()
            if tile_idx:
                windows.append(dispatch_window(tile_idx.popleft()))
            if kind == "empty":  # no foreground (sparse mode): nothing to do
                continue
            wh = min(self.h, y1 + self.pad) - wy0
            ww = min(self.w, x1 + self.pad) - wx0
            with _stage("flush.window_fetch_d2h"):
                staged = fetch.numpy()
                boundary_win = basin_win = None
                if kind == "proposal":
                    # [fg bits | boundary bits | basin lo | basin hi @ fg]:
                    # the device already ran energy -> boundary -> integer
                    # basin; the host only unpacks and scatters.
                    buf = staged[0]
                    pw = (ww + 7) // 8
                    nb = wh * pw
                    np_win = np.unpackbits(buf[:nb].reshape(wh, pw), axis=1)[:, :ww].astype(bool)
                    boundary_win = np.unpackbits(
                        buf[nb : 2 * nb].reshape(wh, pw), axis=1)[:, :ww].astype(bool)
                    pos = np.flatnonzero(np_win)
                    cap = (buf.size - 2 * nb) // 2
                    lo = buf[2 * nb : 2 * nb + pos.size].astype(np.int32)
                    hi = buf[2 * nb + cap : 2 * nb + cap + pos.size].astype(np.int32)
                    basin_win = np.zeros((wh, ww), np.float32)
                    basin_win.ravel()[pos] = -(lo | (hi << 8)).astype(np.float32)
                elif kind == "sparse":  # [bitmask rows | fg energy]
                    buf = staged[0]
                    pw = (ww + 7) // 8
                    np_win = np.unpackbits(buf[: wh * pw].reshape(wh, pw), axis=1)[
                        :, :ww].astype(bool)
                    pos = np.flatnonzero(np_win)
                    # u8 fixed point straight through: the integer tail
                    # (ops/hv_postproc) consumes e*255 natively.
                    energy_win = np.zeros((wh, ww), np.uint8)
                    energy_win.ravel()[pos] = buf[wh * pw : wh * pw + pos.size]
                elif len(staged) == 1:  # fused u8 plane: [bitmask | energy]
                    fused = staged[0]
                    pack_w = fused.shape[1] - ww
                    energy_win = np.ascontiguousarray(fused[:, pack_w:])
                    np_win = np.unpackbits(fused[:, :pack_w], axis=1)[:, :ww].astype(bool)
                else:
                    np_u8, energy_win = staged
                    if energy_win.dtype == np.uint16:
                        energy_win = energy_win.astype(np.float32) / 65535.0
                    ww = energy_win.shape[1]
                    # bool foreground from the packed device bitmask; the
                    # downstream threshold (>= 0.5) is an identity on bools
                    np_win = np.unpackbits(np_u8, axis=1)[:, :ww].astype(bool)

            interior = (slice(y0 - wy0, y1 - wy0), slice(x0 - wx0, x1 - wx0))
            if band_fg is not None:  # fg raster map for the id-only upload
                band_fg[:, x0:x1] = np_win[interior]
            with _stage("flush.extract_instances"):
                if kind == "proposal":
                    labels, ids, boxes, polys = extract_instance_labels_from_proposal(
                        np_win, boundary_win, basin_win, interior, self.min_object_size)
                else:
                    labels, ids, boxes, polys = extract_instance_labels(
                        np_win, energy_win, interior, self.min_object_size)
            if ids.size == 0:
                continue
            # relabel tile-locals into band-locals, drop degenerate contours
            with _stage("flush.remap_records"):
                keep = np.array([p is not None for p in polys], bool)
                n_keep = int(keep.sum())
                remap = np.zeros(int(labels.max()) + 1, np.int32)
                new_ids = np.arange(local_next, local_next + n_keep, dtype=np.int64)
                remap[ids[keep]] = new_ids
                boxes_k = boxes[keep].astype(np.int64)
                boxes_k[:, 0] += x0
                boxes_k[:, 1] += y0
                shift = np.array([x0, y0], np.int64)
                for j, i in enumerate(np.flatnonzero(keep)):
                    band_records.append(
                        (int(new_ids[j]), boxes_k[j], polys[i].astype(np.int64) + shift))
                local_next += n_keep
                band_labels[:, x0:x1] = remap[labels]

        if not band_records:
            return 0
        if local_next >= _MAX_IDS:
            raise StreamingCapacityError(
                f"band {b}: {local_next} instances exceeds the device segment cap")

        # Per-instance class sums from the device-resident type maps: only
        # the FOREGROUND pixels' ids go up, bucketed; only (id_cap, K) sums
        # come down.
        with _stage("flush.class_sums"):
            id_cap = min(_bucket(local_next, 1024), _MAX_IDS)
            if band_fg is not None:
                # Id-ONLY upload: the device recomputes the interior fg
                # positions from its own NP band (the same u8 >= 128
                # definition as the window bitmasks band_fg came from), so
                # the upload is the band-local id per fg pixel in raster
                # order, u16 when they fit. Unlabeled fg pixels carry id 0,
                # whose row is discarded like background.
                n_fg = int(fg_counts[-1])
                fg_ids = band_labels[band_fg]
                if fg_ids.size != n_fg:  # definitions drifted: fail loudly
                    raise RuntimeError(f"band {b}: host fg {fg_ids.size} != device fg {n_fg}")
                cap = _bucket(max(n_fg, 1), 4096, step=2)
                dtype = np.uint16 if local_next <= 0xFFFF else np.int32
                ids_up = np.zeros((cap,), dtype)
                ids_up[:n_fg] = fg_ids.astype(dtype)
                sums, sum_counts = self._class_sums_from_fg(
                    tp_b, np_b, _upload(ids_up, self.device),
                    (y0 - top, self.s, y1 - y0, self.w), id_cap)
            else:
                fg_y, fg_x = np.nonzero(band_labels)
                n_fg = fg_y.size
                cap = _bucket(n_fg, 4096)
                # Packed upload: ONE (2, cap) i32 array, row 0 the linear
                # buffer index, row 1 the band-local id. Padding points at
                # id 0 / pixel (0, 0), discarded like background.
                pix = np.zeros((2, cap), np.int32)
                pix[0, :n_fg] = (fg_y + (y0 - top)).astype(np.int64) * self.buf_w + (fg_x + self.s)
                pix[1, :n_fg] = band_labels[fg_y, fg_x]
                sums, sum_counts = self._class_sums_sparse(tp_b, _upload(pix, self.device),
                                                           id_cap)
            # Not read here: the copy lands while later bands flush and is
            # read at finalize.
            pending = _PendingBand(_HostCopy(sums, sum_counts), local_next, band_records)
        self._band_results.setdefault(b, []).append(pending)
        return len(band_records)

    @staticmethod
    def _assemble_band(pending: _PendingBand):
        """Resolve one band's deferred class sums into per-cell rows."""
        sums, counts = (np.array(a[1 : pending.local_next]) for a in pending.sums.numpy())
        counts[counts == 0] = 1.0
        means = (sums / counts[:, None]).astype(np.float32)
        for local_id, box, poly in pending.records:
            yield (
                np.array([box[0], box[1], box[2], box[3]], np.int32).reshape(1, -1),
                means[local_id - 1].reshape(1, -1),
                poly.astype(np.int32),
            )

    def finalize(self) -> tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
        """Flush the remaining bands, wait for every flusher, and return
        aligned lists of (1, 4) [x, y, w, h] boxes, (1, K) class
        probabilities and (M, 2) polygons, band by band."""
        with _stage("finalize.join"):
            for b in sorted(self._bands):
                self._enqueue_flush(b)
            self._flush_q.join()
        if self._flush_err:
            raise self._flush_err[0]
        with _stage("finalize.assemble"):
            results = [
                r
                for b in sorted(self._band_results)
                for pending in self._band_results[b]
                for r in self._assemble_band(pending)
            ]
        if not results:
            return [], [], []
        inst, probs, polys = zip(*results)
        return list(inst), list(probs), list(polys)

    def close(self) -> None:
        """End every flusher before returning. Each flusher ends on the one
        stop token it takes, so there is one per flusher, whatever
        ``is_alive`` says: on a loaded host ``is_alive`` has been seen to
        read False for a live flusher, which then never got its token. A
        flusher finishes the band it holds and drops the queued ones, so the
        wait is bounded by one band's flush. A second call does nothing."""
        if self._closing:
            return
        self._closing = True  # workers drop queued jobs instead of flushing
        self._bands.clear()
        for _ in self._flushers:
            self._flush_q.put(None)
        for t in self._flushers:
            t.join()


@functools.lru_cache(maxsize=16)
def _cached_kernels(s: int, k: int, alpha: float, energy_mode: str, device: torch.device):
    """The seven device programs, in the JAX package's order, as functions
    on tensors of ``device``: scatter_fused, window_stage,
    class_sums_sparse, window_counts, window_stage_sparse,
    class_sums_from_fg, window_stage_proposal.

    The JAX package's are XLA programs; here they are torch ops. Their
    outputs are the JAX package's wire byte for byte, so the host half is
    the same code. Every threshold is taken in float32: bf16 -> f32 x 255,
    rounded half to even, to uint8.
    """
    core = make_map_postprocess(s, alpha)
    energy_core = make_energy_core(21)
    blur3 = make_blur3_core()
    bit_weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=device)

    def postprocess(np_logits, hv, tp_logits):
        np_res, hv_res, tp_res = core(np_logits, hv, tp_logits)
        # bands store bf16: half the HBM of f32 at ~1e-3 relative error
        return (np_res.to(torch.bfloat16), hv_res.to(torch.bfloat16),
                tp_res.to(torch.bfloat16))

    def scatter_fused(np_b, hv_b, tp_b, np_logits, hv, tp_logits, rcv):
        """postprocess + scatter of one batch into one band's buffers, in
        place: patch i+1 overwrites patch i where they overlap, and rows
        with rcv[2] == 0 write nothing. ``rcv`` is the host's (3, B)
        (rows, cols, valid)."""
        np_p, hv_p, tp_p = postprocess(np_logits, hv, tp_logits)
        for i in np.flatnonzero(rcv[2]):
            r, c = int(rcv[0, i]), int(rcv[1, i])
            np_b[r : r + s, c : c + s] = np_p[i]
            hv_b[r : r + s, c : c + s] = hv_p[i]
            tp_b[r : r + s, c : c + s] = tp_p[i]
        return np_b, hv_b, tp_b

    def _fg(np_win):
        # The shared foreground definition: u8-quantised NP prob >= 128,
        # exactly the comparison the host makes after unpacking the bitmask.
        return torch.round(np_win.float() * 255.0).to(torch.uint8) >= 128

    def _energy(hv_b, r0, c0, wh, ww):
        return energy_core(hv_b[r0 : r0 + wh, c0 : c0 + ww].float()[None])[0]

    def _quantize(energy, levels):
        return torch.round(torch.clamp(energy, 0.0, 1.0) * float(levels))

    def _packbits(mask):
        # jnp.packbits(mask, axis=1): MSB first, the last byte zero-padded
        h, w = mask.shape
        bits = F.pad(mask.to(torch.uint8), (0, -w % 8)).view(h, -1, 8)
        return (bits * bit_weights).sum(-1, dtype=torch.uint8)

    def _compact_indices(flat_mask, cap):
        # Raster-order indices of True entries, zero-padded to cap (JAX's
        # cumsum + drop-scatter, with the drop slot at index cap), without
        # the host sync of torch.nonzero.
        pos = torch.cumsum(flat_mask, 0) - 1
        tgt = torch.where(flat_mask & (pos < cap), pos, cap)
        src = torch.arange(flat_mask.numel(), device=flat_mask.device)
        out = torch.zeros(cap + 1, dtype=torch.int64, device=flat_mask.device)
        return out.scatter_(0, tgt, src)[:cap]

    def _ids_long(ids):
        # the u16 wire arrives as torch.uint16; read its bits as int16
        if ids.dtype == torch.uint16:
            return ids.view(torch.int16).long() & 0xFFFF
        return ids.long()

    def _segment_sums(tp_vals, ids, id_cap):
        sums = torch.zeros((id_cap, k), dtype=torch.float32, device=tp_vals.device)
        sums.index_add_(0, ids, tp_vals)
        counts = torch.zeros((id_cap,), dtype=torch.float32, device=tp_vals.device)
        counts.index_add_(0, ids, torch.ones(ids.shape, dtype=torch.float32,
                                             device=tp_vals.device))
        return sums, counts

    def window_stage(np_b, hv_b, r0, c0, wh, ww):
        """Dense window: [packed fg bitmask | u8 energy] in one u8 plane, or
        (bitmask, energy) for u16 / f32 energy."""
        energy = _energy(hv_b, r0, c0, wh, ww)
        np_bits = _packbits(_fg(np_b[r0 : r0 + wh, c0 : c0 + ww]))
        if energy_mode == "u8":
            return torch.cat([np_bits, _quantize(energy, 255).to(torch.uint8)], dim=1)
        if energy_mode == "u16":
            # int32 -> int16 keeps the low 16 bits: the u16 wire's bytes
            energy = _quantize(energy, 65535).to(torch.int32).to(torch.int16).view(torch.uint16)
        return np_bits, energy

    def class_sums_sparse(tp_b, pix, id_cap):
        """Per-instance class sums from the packed (2, cap) (linear buffer
        index, local id) upload."""
        tp_vals = tp_b.reshape(-1, k)[pix[0].long()].float()
        return _segment_sums(tp_vals, pix[1].long(), id_cap)

    def window_counts(np_b, starts, sizes):
        """Foreground pixel counts ((n,) i32) of the windows at the host's
        ``starts`` (n, 2) of ``sizes``."""
        return torch.stack([
            _fg(np_b[r : r + wh, c : c + ww]).sum(dtype=torch.int32)
            for (r, c), (wh, ww) in zip(np.asarray(starts).tolist(), sizes)
        ])

    def window_stage_sparse(np_b, hv_b, r0, c0, wh, ww, cap):
        """[packed fg bitmask rows | u8 energy at fg raster positions]."""
        e_u8 = _quantize(_energy(hv_b, r0, c0, wh, ww), 255).to(torch.uint8)
        fg = _fg(np_b[r0 : r0 + wh, c0 : c0 + ww])
        idx = _compact_indices(fg.reshape(-1), cap)
        return torch.cat([_packbits(fg).reshape(-1), e_u8.reshape(-1)[idx]])

    def window_stage_proposal(np_b, hv_b, r0, c0, wh, ww, cap):
        """[fg bits | boundary bits | basin u16 lo | basin u16 hi @ fg].

        The device marker proposal: foreground, boundary (e_u8 >= 102, the
        0.4 cutoff) and the integer watershed basin. Every value is an exact
        integer <= 4080 in f32, so the host tail is the host integer path's
        (ops/hv_postproc._integer_basin) bit for bit.
        """
        energy = _energy(hv_b, r0, c0, wh, ww)
        fg = _fg(np_b[r0 : r0 + wh, c0 : c0 + ww])
        # f32 integers 0..255, background zeroed (the canonical u8 plane)
        e_u8 = torch.where(fg, _quantize(energy, 255), 0.0)
        boundary = e_u8 >= 102.0
        blur = blur3(torch.where(fg, 255.0 - e_u8, 0.0)[None])[0]  # integers 0..4080
        idx = _compact_indices(fg.reshape(-1), cap)
        vals = blur.reshape(-1)[idx].to(torch.int32)
        lo = (vals & 255).to(torch.uint8)
        hi = (vals >> 8).to(torch.uint8)
        return torch.cat([_packbits(fg).reshape(-1), _packbits(boundary).reshape(-1), lo, hi])

    def class_sums_from_fg(tp_b, np_b, ids, interior, id_cap):
        """Per-instance class sums with an id-ONLY upload: ``ids`` holds the
        band-local id of each interior fg pixel in raster order (u16 or
        i32, zero-padded); the positions are recomputed here from the NP
        band with the host bitmask's definition."""
        off_r, off_c, ih, iw = interior
        fg = _fg(np_b[off_r : off_r + ih, off_c : off_c + iw])
        idx = _compact_indices(fg.reshape(-1), ids.shape[0])
        tp_vals = tp_b[idx // iw + off_r, idx % iw + off_c, :].float()
        return _segment_sums(tp_vals, _ids_long(ids), id_cap)

    return (scatter_fused, window_stage, class_sums_sparse, window_counts,
            window_stage_sparse, class_sums_from_fg, window_stage_proposal)


def pick_num_flushers(stitch_workers: int | None) -> int:
    """Flusher thread count: the caller's stitch-worker knob, bounded.

    More flushers pin more popped band buffers on the device
    (streaming_fits accounts for this), so the cap stays small; on a
    many-core host the watershed tail parallelises across bands.
    """
    if stitch_workers is None:
        return min(4, max(1, (os.cpu_count() or 1) // 2))
    return max(1, min(int(stitch_workers), 8))


def streaming_fits(
    slide_width: int, n_classes: int, slide_patch_size: int,
    tile_size: int = STREAM_TILE, padding: int = STREAM_PAD,
    budget_bytes: int | None = None,
    num_flushers: int = 1,
) -> bool:
    """Whether the engine's peak band working set fits the device budget
    (WSINSIGHT_STREAM_HBM_BYTES, 6 GiB by default, as in the JAX package).

    Peak device-resident band buffers = ~3 active bands (the write window of
    the sorted stream) + the flush queue (num_flushers + 1) + num_flushers
    in-flight flushes, all in bf16 channels.
    """
    if budget_bytes is None:
        budget_bytes = int(os.getenv("WSINSIGHT_STREAM_HBM_BYTES", 6 * (1 << 30)))
    buf_h = tile_size + 2 * padding + 2 * slide_patch_size
    buf_w = slide_width + 2 * slide_patch_size
    per_band = buf_h * buf_w * (3 + n_classes) * 2
    peak_bands = 3 + (num_flushers + 1) + num_flushers
    return peak_bands * per_band <= budget_bytes


def make_banded_stitcher(
    engine,
    slide_width: int,
    slide_height: int,
    mpp: float,
    halo_size_px: int,
    min_object_size: int = 20,
    num_flushers: int = 1,
) -> BandedCellStitcher:
    """The banded stitcher of one slide at ``mpp``, on the engine's device,
    with the host-canvas stitcher's geometry (``cells.slide_geometry``)."""
    from .cells import slide_geometry

    cfg = engine.config
    slide_patch_size, slide_halo_size = slide_geometry(engine, mpp, halo_size_px)
    return BandedCellStitcher(
        n_classes=cfg.num_classes,
        slide_width=slide_width,
        slide_height=slide_height,
        slide_patch_size=slide_patch_size,
        slide_halo_size=slide_halo_size,
        slide_mpp=mpp,
        model_mpp=cfg.spacing_um_px,
        min_object_size=min_object_size,
        num_flushers=num_flushers,
        device=engine.device,
    )


def stream_slide(
    engine,
    stitcher: BandedCellStitcher,
    src: PatchBatchSource,
    it: Iterator[Batch] | None = None,
) -> None:
    """One slide's y-sorted patches through ``engine`` into ``stitcher``'s
    bands. Nothing here waits for the device: the bands flush on the
    stitcher's threads while the next forwards run. ``it`` is an iterator
    of ``src`` already started."""
    with tqdm.tqdm(total=src.num_batches, desc="Inference", position=1, leave=False) as bar:
        for i, batch in enumerate(iter(src) if it is None else it):
            with _stage("stream.batch", n=i):
                pred = engine.dispatch(engine.put(batch.images))
                pred = {k: v for k, v in pred.items() if k != "tissue_types"}
                stitcher.accumulate_batch(pred, batch.coords, n_valid=batch.n_valid)
                bar.update(1)


def run_streaming_cell_inference(
    engine,
    *,
    wsi_path: URIPath,
    patch_path: URIPath,
    use_hdf5_images: bool,
    slide_width: int,
    slide_height: int,
    mpp: float,
    halo_size_px: int,
    batch_size: int,
    num_workers: int,
    min_object_size: int = 20,
    stitch_workers: int | None = None,
) -> tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Banded streaming counterpart of engine.cells.run_cell_inference."""
    from .cells import _cell_wire

    cfg = engine.config
    stitcher = make_banded_stitcher(engine, slide_width, slide_height, mpp, halo_size_px,
                                    min_object_size, pick_num_flushers(stitch_workers))
    src = None
    try:
        src = PatchBatchSource(
            wsi_path=wsi_path,
            patch_path=patch_path,
            use_hdf5_images=use_hdf5_images,
            batch_size=engine.pad_batch(batch_size),
            num_threads=governed_workers(num_workers or 4),
            order_by_y=True,  # banding needs the stream sorted by slide row
            wire=_cell_wire(),
            decode_scale=1,  # cell models take full-res patches (no resize)
        )
        stream_slide(engine, stitcher, src)
        inst, probs, polys = stitcher.finalize()
    finally:
        # On any failure (StreamingCapacityError rerouting to the host-canvas
        # engine included) the producer thread must stop and the flushers
        # must exit so the band buffers are released.
        if src is not None:
            src.close()
        stitcher.close()

    if not inst:
        return np.zeros((0, 4), np.int32), np.zeros((0, cfg.num_classes), np.float32), []
    return np.concatenate(inst, axis=0), np.concatenate(probs, axis=0), polys
