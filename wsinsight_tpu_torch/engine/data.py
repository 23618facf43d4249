"""Host-side patch pipeline: threaded decode feeding padded uint8 batches.

Replaces the reference's torch Dataset + DataLoader worker processes (reference:
wsinsight/modellib/data.py:149-314, run_inference.py:288-299). Differences by
design:

* patches are decoded by a thread pool into numpy batches (the native reader
  decodes a shard of a batch per call with the GIL released, and the Python
  tile path releases it inside zlib/cv2, so threads scale without the
  spawn/pickle overhead of worker processes),
* transform math (resize/normalize) moves to the card (ops/preprocess.py and
  kernel K1), so workers only decode uint8 pixels,
* the final batch is padded to full batch size with a validity count, so the
  forward sees one shape.

Counterpart of wsinsight_tpu/engine/data.py. A batch decodes in one native
call per shard where the slide's level has a native reader
(``TpuSlide.has_native``), and per patch through ``read_region_array``
otherwise; the slide's ``reads`` counts which. The input options are the JAX
source's: ``host_resize`` (PIL-exact resize in the decode threads),
``wire="yuv420"`` (batches packed as planar YUV 4:2:0, rank 3) and
``decode_scale=2`` (DCT half-resolution decode of JPEG pages, with the YUV
wire). ``PatchBatchSource.from_coords`` takes the coordinates in memory; the
HDF5 constructor reads them from a patch file and then runs the same code.
``h5py`` is imported only where a patch file is read.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import numpy.typing as npt

from ..uri_path import URIPath
from ..utils.profiling import hot_stage
from ..wsi import get_wsi_cls


def read_patch_coords(path) -> tuple[npt.NDArray[np.int_], npt.NDArray | None, int]:
    """Read /coords + attrs -> ((N,4) [minx,miny,w,h], tile_dim, patch_size).

    Mirrors the reference loader incl. the patch_level==0 assertion
    (reference: modellib/data.py:22-63).
    """
    import h5py

    with h5py.File(path, mode="r") as f:
        coords = f["/coords"][()]
        meta = f["/coords"].attrs
        if "patch_level" not in meta.keys():
            raise KeyError(
                "Could not find required key 'patch_level' in hdf5 of patch coordinates."
            )
        if meta["patch_level"] != 0:
            raise NotImplementedError(
                f"This script is designed for patch_level=0 but got {meta['patch_level']}"
            )
        if coords.ndim != 2 or coords.shape[1] != 2:
            raise ValueError(f"expected (N, 2) coords, got {coords.shape}")
        if "patch_size" not in meta.keys():
            raise KeyError("expected key 'patch_size' in attrs of coords dataset")
        patch_size = int(meta["patch_size"])
        tile_dim = meta["tile_dim"] if "tile_dim" in meta.keys() else None
    return _with_size(coords, patch_size), tile_dim, patch_size


def _with_size(coords: npt.NDArray[np.int_], patch_size: int) -> npt.NDArray[np.int_]:
    """(N, 2) top-left corners -> (N, 4) [minx, miny, w, h]."""
    return np.concatenate((coords, np.full_like(coords, patch_size)), axis=1)


@dataclass
class Batch:
    # (B, H, W, 3), or (B, H*3/2, W) on the YUV 4:2:0 wire; zero-padded past n_valid
    images: npt.NDArray[np.uint8]
    coords: npt.NDArray[np.int64]  # (B, 4)
    n_valid: int


class PatchBatchSource:
    """Iterate padded uint8 batches for one slide's patch set."""

    def __init__(
        self,
        wsi_path: URIPath | None,
        patch_path: URIPath,
        use_hdf5_images: bool,
        batch_size: int = 32,
        num_threads: int = 8,
        prefetch: int = 2,
        shuffle_seed: int | None = None,
        order_by_y: bool = False,
        host_resize: tuple[int, int] | None = None,
        wire: str | None = None,
        decode_scale: int | None = None,
    ):
        """The source of one slide's patch file (``/coords``, and ``/images``
        when ``use_hdf5_images`` and the file has them)."""
        coords, tile_dim, patch_size = read_patch_coords(
            patch_path.materialize() if isinstance(patch_path, URIPath) else patch_path
        )
        if coords.size == 0:
            raise ValueError(f"No patches were found in {patch_path}")
        self._setup(wsi_path, patch_path, coords, tile_dim, patch_size, use_hdf5_images,
                    batch_size, num_threads, prefetch, shuffle_seed, order_by_y,
                    host_resize, wire, decode_scale)

    @classmethod
    def from_coords(
        cls,
        wsi_path: URIPath | str,
        coords: npt.NDArray[np.int_],
        patch_size: int,
        batch_size: int = 32,
        num_threads: int = 8,
        prefetch: int = 2,
        shuffle_seed: int | None = None,
        order_by_y: bool = False,
        tile_dim: npt.NDArray[np.int_] | None = None,
        host_resize: tuple[int, int] | None = None,
        wire: str | None = None,
        decode_scale: int | None = None,
    ) -> "PatchBatchSource":
        """The source of a plan held in memory: (N, 2) top-left level-0
        ``coords`` (a ``PatchPlan``'s) of ``patch_size`` px patches, decoded
        from the slide at ``wsi_path``."""
        coords = np.asarray(coords, np.int32).reshape(-1, 2)
        if coords.size == 0:
            raise ValueError(f"No patches were given for {wsi_path}")
        src = cls.__new__(cls)
        src._setup(wsi_path, None, _with_size(coords, int(patch_size)), tile_dim,
                   int(patch_size), False, batch_size, num_threads, prefetch,
                   shuffle_seed, order_by_y, host_resize, wire, decode_scale)
        return src

    def _setup(self, wsi_path, patch_path, coords, tile_dim, patch_size, use_hdf5_images,
               batch_size, num_threads, prefetch, shuffle_seed, order_by_y,
               host_resize, wire, decode_scale) -> None:
        self.patch_path = patch_path
        self.wsi_path = wsi_path
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.coords, self.tile_dim, self.patch_size = coords, tile_dim, patch_size

        self._order = np.arange(len(self.coords))
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(self._order)
        elif order_by_y:
            # banded/streaming consumers need patches in slide-row order
            self._order = np.lexsort((self.coords[:, 0], self.coords[:, 1]))

        # Optional decode-thread resize (PIL bilinear, the reference's own
        # CPU transform, torchvision Resize on PIL images). Only applied when
        # it shrinks the patch: the point is to cut host->device bytes on
        # hosts with a thin transfer link (WSINSIGHT_HOST_RESIZE=1); an
        # upscale would inflate them. The device's exact resize reproduces
        # PIL bit for bit, so moving the resize here changes where the work
        # runs, not the numbers.
        self._host_resize: tuple[int, int] | None = None
        if host_resize is not None:
            oh, ow = int(host_resize[0]), int(host_resize[1])
            if oh * ow < int(self.patch_size) ** 2:
                self._host_resize = (oh, ow)

        # Optional thin-link wire format: batches packed as planar YUV 4:2:0
        # (1.5 B/px against RGB's 3 B/px), for hosts whose device link bounds
        # the pipeline (WSINSIGHT_WIRE=yuv420). The engine's step rebuilds
        # RGB on the device (ops/preprocess.yuv420_to_rgb, chosen by the
        # batch's rank). Lossy in chroma, so opt-in; it needs even H and W,
        # otherwise this source stays on the exact RGB wire.
        self._wire = None
        if wire == "yuv420":
            ih, iw = self._host_resize or (int(self.patch_size), int(self.patch_size))
            if ih % 2 == 0 and iw % 2 == 0:
                self._wire = "yuv420"

        self._use_hdf5_images = use_hdf5_images
        self._h5 = None
        self._images = None
        self._slide = None
        self._h5_lock = threading.Lock()
        self._h5_tls = threading.local()
        self._tls_files: list = []
        self._stop = threading.Event()
        self._producers: list[threading.Thread] = []
        self._open_sources()

        # Optional DCT half-resolution decode (WSINSIGHT_DECODE_SCALE=2, JPEG
        # pages and the YUV wire only): the native reader decodes tiles at
        # 1/2 through a 4x4 IDCT (a quarter of the pixels) and the wire ships
        # (ceil(ps/2) rounded even)^2 planes; the device preprocess resizes
        # from there. Lossy (DCT downsample and the wire's chroma), so opt-in.
        # Where the page is not JPEG, or has no native reader (a build without
        # libjpeg), the probe finds no half-scale reader and the source stays
        # at full resolution; ``decode_scale`` says which ran.
        self._decode_scale = 1
        self._half = None
        if decode_scale is None:
            try:
                decode_scale = int(os.getenv("WSINSIGHT_DECODE_SCALE", "1") or 1)
            except ValueError:
                decode_scale = 1
        if (
            decode_scale == 2
            and self._wire == "yuv420"
            and not self._use_hdf5_images
            and getattr(self._slide, "has_native", None) is not None
            and self._slide.has_native(0, 2)
        ):
            hs = -(-int(self.patch_size) // 2)
            hs += hs % 2  # even, for the YUV packer
            probe = self._slide.read_patches_array(self.coords[:1, :2], 0, (hs, hs),
                                                   scale_denom=2)
            if probe is not None:
                self._decode_scale = 2
                self._half = (hs, hs)
                self._host_resize = None  # decode already shrank the patch

    @property
    def decode_scale(self) -> int:
        """1, or 2 where the DCT half-resolution decode runs."""
        return self._decode_scale

    @property
    def wire(self) -> str | None:
        """"yuv420" where batches ship packed, else None (RGB)."""
        return self._wire

    def _open_sources(self) -> None:
        if self._use_hdf5_images:
            import h5py

            p = self.patch_path
            local = p.materialize() if isinstance(p, URIPath) else p
            self._h5 = h5py.File(local, "r")
        if self._use_hdf5_images and "/images" in self._h5:
            imgs = self._h5["/images"]
            if imgs.ndim == 4 and imgs.shape[0] == len(self.coords):
                self._images = imgs
            else:
                self._use_hdf5_images = False
        else:
            self._use_hdf5_images = False
        if not self._use_hdf5_images:
            if self.wsi_path is None:
                raise FileNotFoundError("no /images cache and no wsi_path given")
            self._slide = get_wsi_cls()(self.wsi_path)

    def __len__(self) -> int:
        return len(self.coords)

    @property
    def num_batches(self) -> int:
        return -(-len(self.coords) // self.batch_size)

    def _thread_images(self):
        """Per-thread /images dataset (own h5py handle, no shared lock).

        A single shared handle serializes all decode threads on one lock —
        exactly when the /images cache should be fastest. The reference gets
        the same isolation from per-worker handles in worker_init (reference:
        modellib/data.py:198-236).
        """
        tl = self._h5_tls
        ds = getattr(tl, "images", None)
        if ds is None:
            import h5py

            p = self.patch_path
            local = p.materialize() if isinstance(p, URIPath) else p
            f = h5py.File(local, "r")
            ds = f["/images"]
            tl.file = f
            tl.images = ds
            with self._h5_lock:
                self._tls_files.append(f)
        return ds

    def _fetch_one(self, idx: int) -> np.ndarray:
        with hot_stage("decode.shard", n=1):
            return self._read_one(idx)

    def _read_one(self, idx: int) -> np.ndarray:
        if self._use_hdf5_images:
            try:
                arr = self._thread_images()[idx]
            except Exception:
                with self._h5_lock:  # fallback: shared handle, serialized
                    arr = self._images[idx]
            if arr.shape[0] == 3 and arr.shape[-1] != 3:
                arr = np.transpose(arr, (1, 2, 0))
            arr = np.ascontiguousarray(arr[:, :, :3], dtype=np.uint8)
            return self._maybe_resize(arr)
        minx, miny, w, h = self.coords[idx]
        if self._decode_scale == 2:
            # The half-scale mode after a native decode error: read the
            # even-snapped full-resolution window and area-downsample it, an
            # antialiased 2x reduction like the DCT half decode (the mode is
            # lossy by contract).
            import cv2

            hs = self._half[0]
            arr = self._slide.read_region_array(
                (int(minx) & ~1, int(miny) & ~1), 0, (2 * hs, 2 * hs)
            )
            return cv2.resize(arr, (hs, hs), interpolation=cv2.INTER_AREA)
        fast = getattr(self._slide, "read_region_array", None)
        if fast is not None:
            return self._maybe_resize(fast((int(minx), int(miny)), 0, (int(w), int(h))))
        region = self._slide.read_region(
            location=(int(minx), int(miny)), level=0, size=(int(w), int(h))
        )
        return self._maybe_resize(np.asarray(region.convert("RGB"), dtype=np.uint8))

    def _maybe_resize(self, arr: np.ndarray) -> np.ndarray:
        if self._host_resize is None:
            return arr
        from ..native import pil_resize_native

        return pil_resize_native(arr, self._host_resize)

    @property
    def image_hw(self) -> tuple[int, int]:
        """(H, W) of the images this source yields (after host resize or the
        half-scale decode); on the YUV wire they ship as (H*3/2, W)."""
        if self._half is not None:
            return self._half
        if self._host_resize is not None:
            return self._host_resize
        return (self.patch_size, self.patch_size)

    def _start_batch(self, pool: ThreadPoolExecutor, indices: np.ndarray):
        """Submit one batch's decode work; return a finish() -> Batch closure.

        Splitting submit from collect lets the producer keep two batches in
        flight: batch k+1's shards decode (GIL-free) while batch k is being
        assembled / waiting on the bounded queue, so the decode pool never
        idles across the per-batch join barrier.
        """
        native_collect = self._submit_batch_native(pool, indices)
        futures = None
        if native_collect is None and len(indices) > 0:
            futures = [pool.submit(self._fetch_one, i) for i in indices]

        def finish() -> Batch:
            ih, iw = self.image_hw
            native = native_collect() if native_collect is not None else None
            if native is not None and len(indices) == self.batch_size:
                images = native  # full batch decoded straight into its buffer
            else:
                shape = (
                    (self.batch_size, ih * 3 // 2, iw)  # pre-packed shards
                    if native is not None and native.ndim == 3
                    else (self.batch_size, ih, iw, 3)
                )
                images = np.zeros(shape, np.uint8)
                if native is not None:
                    images[: len(indices)] = native
                else:
                    per_patch = (
                        [f.result() for f in futures]
                        if futures is not None
                        # a shard's native decode failed mid-batch
                        else [self._fetch_one(i) for i in indices]
                    )
                    for slot, arr in enumerate(per_patch):
                        images[slot] = arr
            if self._wire is not None and images.ndim == 4:
                from ..native import rgb_to_yuv420

                packed = rgb_to_yuv420(images)
                if packed is not None:
                    images = packed  # (B, H*3/2, W): halves the H2D bytes
            coords = np.zeros((self.batch_size, 4), np.int64)
            coords[: len(indices)] = self.coords[indices]
            return Batch(images=images, coords=coords, n_valid=len(indices))

        return finish

    def _submit_batch_native(self, pool: ThreadPoolExecutor, indices: np.ndarray):
        """Submit a whole batch's decode as GIL-free native calls, where the
        slide's level 0 has a native reader.

        The batch is sharded across the decode pool (``min(threads, n // 4)``
        shards): each native call releases the GIL and writes its slice of
        one contiguous buffer (decode, then the host resize and the wire
        packing of that slice), so threads scale on multi-core hosts (the
        shared C++ tile LRU is mutex-protected, decode runs unlocked).
        Returns a collect() closure yielding the decoded batch, or None at
        submit time where there is no native reader, or at collect time
        where a shard's decode failed (the caller then decodes per patch).
        """
        if self._use_hdf5_images or self._slide is None:
            return None
        has_native = getattr(self._slide, "has_native", None)
        if has_native is None or not has_native(0, self._decode_scale):
            return None
        n = len(indices)
        if n == 0:
            return None
        from ..native import pil_resize_native, rgb_to_yuv420

        ps = int(self.patch_size)
        dec_scale = self._decode_scale
        dec_hw = self._half if dec_scale == 2 else (ps, ps)
        out = np.empty((n, dec_hw[0], dec_hw[1], 3), np.uint8)
        coords = self.coords[indices, :2]
        resize_to = self._host_resize
        rgb = out
        if resize_to is not None:
            rgb = np.empty((n, resize_to[0], resize_to[1], 3), np.uint8)
        final = rgb
        if self._wire is not None:
            # pack per shard, so the (GIL-free) conversion runs in the decode
            # threads instead of serializing on the producer
            final = np.empty((n, rgb.shape[1] * 3 // 2, rgb.shape[2]), np.uint8)

        def shard(a: int, b: int):
            with hot_stage("decode.shard", n=b - a):
                r = self._slide.read_patches_array(
                    coords[a:b], 0, (dec_hw[1], dec_hw[0]), out[a:b], scale_denom=dec_scale
                )
                if r is None:
                    return None
                if resize_to is not None:
                    pil_resize_native(out[a:b], resize_to, out=rgb[a:b])
                if final is not rgb and rgb_to_yuv420(rgb[a:b], out=final[a:b]) is None:
                    return None
                return True

        n_shards = min(self.num_threads, max(1, n // 4))
        bounds = np.linspace(0, n, n_shards + 1, dtype=int)
        futures = [pool.submit(shard, a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

        def collect() -> np.ndarray | None:
            results = [f.result() for f in futures]
            return None if any(r is None for r in results) else final

        return collect

    def __iter__(self) -> Iterator[Batch]:
        """Yield batches; decode runs ahead of the consumer by `prefetch`."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        splits = [
            self._order[i : i + self.batch_size]
            for i in range(0, len(self._order), self.batch_size)
        ]

        def put_or_stop(item) -> bool:
            # Bounded put that honors close(): an abandoned iterator (e.g.
            # the one-batch stain sample) must not leave this thread blocked
            # forever — on ANY put, including the terminal None/error.
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                from collections import deque

                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    # Two batches in flight: batch k+1's shards decode while
                    # batch k assembles / waits on the bounded queue.
                    pending: deque = deque()
                    for indices in splits:
                        pending.append(self._start_batch(pool, indices))
                        if len(pending) >= 2 and not put_or_stop(pending.popleft()()):
                            return
                    while pending:
                        if not put_or_stop(pending.popleft()()):
                            return
                put_or_stop(None)
            except BaseException as err:  # propagate to consumer
                put_or_stop(err)

        t = threading.Thread(target=producer, daemon=True)
        self._producers.append(t)
        t.start()
        while True:
            with hot_stage("decode.wait"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()

    def device_prefetch(
        self, put, depth: int = 2, it: "Iterator[Batch] | None" = None
    ) -> "Iterator[Batch]":
        """Iterate batches whose `.images` are ALREADY in flight to the device.

        `put` is an async host->device transfer (ClassifierEngine.put);
        issuing it `depth` batches ahead of the consumer
        keeps transfers streaming while the device computes and the decode
        threads fill the next batch — on thin tunnel links the transfer is
        the dominant per-batch cost, so this overlap sets the pipeline rate
        to max(decode, H2D, compute) instead of their sum.
        """
        from collections import deque

        q: deque = deque()
        if it is None:
            it = iter(self)
        exhausted = False
        while True:
            while not exhausted and len(q) <= max(0, depth):
                b = next(it, None)
                if b is None:
                    exhausted = True
                    break
                q.append(Batch(images=put(b.images), coords=b.coords, n_valid=b.n_valid))
            if not q:
                return
            yield q.popleft()

    def close(self) -> None:
        self._stop.set()
        # Join producers BEFORE closing handles: a decode thread still inside
        # the native reader while close() frees it would be a use-after-free
        # (the C++ side also pins pages per call). Every producer is joined,
        # not only those is_alive() reports: on a loaded host it has been
        # seen to read False for a live thread.
        for t in self._producers:
            if t is not threading.current_thread():
                t.join(timeout=30)
        self._producers.clear()
        for f in self._tls_files:
            try:
                f.close()
            except Exception:
                pass
        self._tls_files.clear()
        if self._h5 is not None:
            try:
                self._h5.close()
            except Exception:
                pass
        if self._slide is not None and hasattr(self._slide, "close"):
            self._slide.close()
