"""Host-side patch pipeline: threaded decode feeding padded uint8 batches.

Replaces the reference's torch Dataset + DataLoader worker processes (reference:
wsinsight/modellib/data.py:149-314, run_inference.py:288-299). Differences by
design:

* patches are decoded by a thread pool into numpy batches (the in-house TIFF
  reader releases the GIL inside zlib/cv2, so threads scale without the
  spawn/pickle overhead of worker processes),
* transform math (resize/normalize) moves to the card (ops/preprocess.py and
  kernel K1), so workers only decode uint8 pixels,
* the final batch is padded to full batch size with a validity count, so the
  forward sees one shape.

Counterpart of wsinsight_tpu/engine/data.py. Every patch decodes through the
slide's ``read_region_array`` (the JAX package's per-patch path): the native
whole-batch reader is not ported, and this source does not look for it. The
options that wait for ROADMAP.md Queue 1 item 5 (``host_resize``,
``wire="yuv420"``, ``decode_scale=2``) raise. ``PatchBatchSource.from_coords``
takes the coordinates in memory; the HDF5 constructor reads them from a patch
file and then runs the same code. ``h5py`` is imported only where a patch file
is read.
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

from ..errors import not_ported
from ..uri_path import URIPath
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


def _refuse_unported(host_resize, wire, decode_scale) -> None:
    if host_resize is not None:
        raise NotImplementedError(not_ported("host_resize (WSINSIGHT_HOST_RESIZE)", 5))
    if wire is not None:
        raise NotImplementedError(not_ported(f"wire={wire!r} (WSINSIGHT_WIRE)", 5))
    if decode_scale is None:
        decode_scale = os.getenv("WSINSIGHT_DECODE_SCALE", "1") or "1"
    if str(decode_scale) != "1":
        raise NotImplementedError(not_ported(f"decode_scale={decode_scale} (WSINSIGHT_DECODE_SCALE)", 5))


@dataclass
class Batch:
    images: npt.NDArray[np.uint8]  # (B, P, P, 3), zero-padded past n_valid
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
        _refuse_unported(host_resize, wire, decode_scale)
        coords, tile_dim, patch_size = read_patch_coords(
            patch_path.materialize() if isinstance(patch_path, URIPath) else patch_path
        )
        if coords.size == 0:
            raise ValueError(f"No patches were found in {patch_path}")
        self._setup(wsi_path, patch_path, coords, tile_dim, patch_size, use_hdf5_images,
                    batch_size, num_threads, prefetch, shuffle_seed, order_by_y)

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
                   shuffle_seed, order_by_y)
        return src

    def _setup(self, wsi_path, patch_path, coords, tile_dim, patch_size, use_hdf5_images,
               batch_size, num_threads, prefetch, shuffle_seed, order_by_y) -> None:
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
        if self._use_hdf5_images:
            try:
                arr = self._thread_images()[idx]
            except Exception:
                with self._h5_lock:  # fallback: shared handle, serialized
                    arr = self._images[idx]
            if arr.shape[0] == 3 and arr.shape[-1] != 3:
                arr = np.transpose(arr, (1, 2, 0))
            return np.ascontiguousarray(arr[:, :, :3], dtype=np.uint8)
        minx, miny, w, h = self.coords[idx]
        fast = getattr(self._slide, "read_region_array", None)
        if fast is not None:
            return fast((int(minx), int(miny)), 0, (int(w), int(h)))
        region = self._slide.read_region(
            location=(int(minx), int(miny)), level=0, size=(int(w), int(h))
        )
        return np.asarray(region.convert("RGB"), dtype=np.uint8)

    def _start_batch(self, pool: ThreadPoolExecutor, indices: np.ndarray):
        """Submit one batch's decode work; return a finish() -> Batch closure.

        Splitting submit from collect lets the producer keep TWO batches in
        flight: batch k+1's patches decode (GIL-free inside zlib/cv2) while
        batch k is being assembled / waiting on the bounded queue, so the
        decode pool never idles across the per-batch join barrier.
        """
        futures = [pool.submit(self._fetch_one, i) for i in indices]

        def finish() -> Batch:
            ps = self.patch_size
            images = np.zeros((self.batch_size, ps, ps, 3), np.uint8)
            for slot, f in enumerate(futures):
                images[slot] = f.result()
            coords = np.zeros((self.batch_size, 4), np.int64)
            coords[: len(indices)] = self.coords[indices]
            return Batch(images=images, coords=coords, n_valid=len(indices))

        return finish

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
                    # Two batches in flight: batch k+1's patches decode while
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
        # Join producers BEFORE closing handles: a decode thread may still be
        # reading the slide or the patch file.
        for t in self._producers:
            if t.is_alive() and t is not threading.current_thread():
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
