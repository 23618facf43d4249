"""Time builds of K1's CUDA source side by side on one card.

    python -m wsinsight_tpu_torch.ops.k1_variants [NAME=PATH[@BAND,CHUNK]] ...

Each argument names one build of a ``fused_preprocess.cu``: this checkout's
(an empty PATH) or another version of it, e.g. an older commit's file
unpacked by ``git archive``. ``@BAND,CHUNK`` launches a build with that many
output rows per CTA and input rows per staged chunk instead of ``_plan``'s
defaults (two names may share a PATH). With no argument, this checkout's
alone. Builds that export ``wsi_fused_preprocess_bands`` get ``_plan``'s
launch; older ones (the first port's ``wsi_fused_preprocess``) get that
port's row tiles. The wrapper's checks are not run, and launches here are
not counted in ``fused_preprocess.launches``.

For each shape below (B=256, float32 and bfloat16), every build is held bit
for bit against the plain version (``fused_preprocess_reference``) and its
bare C entry point is timed with CUDA events over 20 launches into a
preallocated output, in turns (first to last, then last to first; the mean
of the two). Prints the card's name and power limit, each build's registers
and spills, a line per shape and build with the bytes moved per second and
the share of the bound (input read once, output written once, at the H100
SXM's 3.35 TB/s), and last one JSON object; exits 1 if a build is not
bit-identical.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import cuda_build
from .fused_preprocess import (
    _SOURCE,
    _affine,
    _band,
    _device_band,
    _plan,
    bind,
    fused_preprocess_reference,
    launch,
)
from .k2_variants import build, cuda_ms

# (H, OH) of square patches: the zoo's 350 -> 224 (the classifier's main
# path), 175 -> 224 (upsampling), 350 -> 299 (an odd output width) and the
# identity 224 -> 224.
SHAPES = ((350, 224), (175, 224), (350, 299), (224, 224))
BATCH = 256
BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
MEAN = (0.7238, 0.5716, 0.6779)  # breast-tumor-resnet34.tcga-brca
STD = (0.112, 0.1459, 0.1036)


@functools.lru_cache(maxsize=64)
def _tile_plan_v1(h: int, w: int, oh: int, ow: int) -> tuple[int, int]:
    """The first port's launch plan: (output rows per CTA, most input rows a
    CTA stages), the largest row tile under 64 KB of shared memory."""
    start, ntaps, _ = _band(h, oh)
    end = start + ntaps
    for tile in (32, 16, 8, 4, 2, 1):
        rows = max(int(end[r : r + tile].max() - start[r : r + tile].min())
                   for r in range(0, oh, tile))
        if 16 + rows * (w * 3 + ow * 3) <= 64 * 1024 or tile == 1:
            return tile, rows
    raise AssertionError


def _bind_any(lib: ctypes.CDLL) -> ctypes.CDLL:
    if hasattr(lib, "wsi_fused_preprocess_bands"):
        return bind(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wsi_fused_preprocess.argtypes = [
        ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32,
        ctypes.POINTER(ctypes.c_float), i32, i32, ptr,
    ]  # ..., affine, tile rows, staged rows, stream
    lib.wsi_fused_preprocess.restype = i32
    return lib


def _launch_v1(lib, x, out, scale, shift) -> None:
    b, h, w, _ = x.shape
    _, oh, ow, _ = out.shape
    hs, hn, hw_ = _device_band(w, ow, x.device)
    vs, vn, vw = _device_band(h, oh, x.device)
    err = lib.wsi_fused_preprocess(
        x.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), b, h, w, oh, ow,
        hs.data_ptr(), hn.data_ptr(), hw_.data_ptr(), hw_.shape[1],
        vs.data_ptr(), vn.data_ptr(), vw.data_ptr(), vw.shape[1],
        _affine(scale, shift), *_tile_plan_v1(h, w, oh, ow),
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"launch failed: {lib.wsi_cuda_error_string(err).decode()}")


def parse(args: list[str]) -> dict[str, tuple[Path, tuple[int, int] | None]]:
    this = cuda_build.CSRC_DIR / _SOURCE
    variants = {}
    for arg in args or ["this="]:
        name, _, rest = arg.partition("=")
        path, _, rows = rest.partition("@")
        band = tuple(int(v) for v in rows.split(",")) if rows else None
        variants[name] = (Path(path) if path else this, band)
    return variants


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k1_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    variants = parse(argv)
    sources = {}  # one nvcc per distinct source
    for name, (path, _) in variants.items():
        sources.setdefault(path.resolve(), name)
    built = build({name: path for path, name in sources.items()}, bind=_bind_any)
    libs = {v: built[sources[p.resolve()]] for v, (p, _) in variants.items()}
    std = np.asarray(STD, np.float32)
    scale, shift = 1.0 / (255.0 * std), -np.asarray(MEAN, np.float32) / std
    rng = np.random.default_rng(0)
    results, failed, plans = [], [], {}
    for h, oh in SHAPES:
        x = torch.from_numpy(rng.integers(0, 256, (BATCH, h, h, 3), dtype=np.uint8)).to("cuda")
        for dt in (torch.bfloat16, torch.float32):
            want = fused_preprocess_reference(x, (oh, oh), scale, shift, dt)
            nbytes = x.numel() + want.numel() * want.element_size()
            outs, calls = {}, {}
            for v, lib in libs.items():
                outs[v] = torch.empty_like(want)
                if hasattr(lib, "wsi_fused_preprocess_bands"):
                    band = variants[v][1]
                    plans[v] = _plan(h, h, oh, oh, *band) if band else _plan(h, h, oh, oh)
                    calls[v] = (lambda lib=lib, o=outs[v], p=plans[v]:
                                launch(lib, x, o, scale, shift, p))
                else:
                    plans[v] = _tile_plan_v1(h, h, oh, oh)
                    calls[v] = lambda lib=lib, o=outs[v]: _launch_v1(lib, x, o, scale, shift)
                calls[v]()
                torch.cuda.synchronize()
                if not torch.equal(outs[v], want):
                    share = float((outs[v] != want).float().mean())
                    failed.append(f"{v} {h}->{oh} {str(dt)[6:]}: {share:.3g} of elements differ")
            order = list(calls)
            times = {v: [] for v in order}
            for v in order + order[::-1]:
                times[v].append(cuda_ms(calls[v]))
            for v in order:
                ms = sum(times[v]) / len(times[v])
                bound_ms = nbytes / BYTES_PER_S * 1e3
                plan = plans[v]
                results.append({"build": v, "shape": f"{h}->{oh}", "b": BATCH,
                                "dtype": str(dt)[6:], "ms": ms, "ms_each": times[v],
                                "bound_ms": bound_ms, "gb_s": nbytes / ms / 1e6,
                                "plan": list(plan), "identical": torch.equal(outs[v], want)})
                print(f"  {h}->{oh} B={BATCH} {str(dt)[6:]} {v} {tuple(plan)}: {ms * 1e3:.1f} us"
                      f" ({', '.join(f'{t * 1e3:.1f}' for t in times[v])}),"
                      f" {nbytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of the"
                      f" {bound_ms * 1e3:.1f} us bound")
            del want, outs, calls
        del x
        torch.cuda.empty_cache()
    for f in failed:
        print(f"  FAIL: {f}", file=sys.stderr)
    print(json.dumps({"card": card, "builds": {v: str(p) for v, (p, _) in variants.items()},
                      "rows": results}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
