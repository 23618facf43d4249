"""Driver ``cell_stream``: whole slides through the port's default cell path,
the banded streaming engine, as ``run_streaming_cell_inference`` runs it
after reading a patch file.

Set-up writes (once per checkout) or reads the traffic's seeded slide with
its drawn nuclei, plans it as the window will, makes the weights on the card from the seed, and builds
``CellEngine`` on them. The nuclei head is set to read the drawn nuclei
(``nuclei_head``, after ``chip_smoke.py``'s ``sam_heads_from_drawn``) and
the HV head is zeroed, so the slide has instances to post-process; then a
few batches warm the path. In the window each slide is opened anew:
``plan_slide`` -> ``PatchBatchSource.from_coords`` ->
``make_banded_stitcher`` -> ``stream_slide`` -> ``finalize``. A slide is
started while ``--seconds`` is not out, and the window closes when the last
one's instances are returned.

Every later slide of the window is the first one again, so its instances
are held against the first's: a slide whose boxes differ, or whose type
probabilities lie further than PROB_TOL from the first's, counts as
failed (as does a first slide with no instances).

The check takes, from the window's first slide, the maps of two of its
batches drawn from the seed as the engine's step returned them and the instances ``finalize``
returned over a square of patches, and holds them against the plain
reference (the same patches decoded by the reference, the SAM encoder and
the three decoders in float32, the instances of the maps)."""

from __future__ import annotations

import time

import numpy as np

from .. import slides
from ..common import (Spans, Tracer, Weights, free_cache, peak_bytes, reset_peak,
                      seeded_state_dict, sync, warm_libraries)

HEADS = ("nuclei_binary_map_decoder", "hv_map_decoder", "nuclei_type_maps_decoder")
# A slide of the window fails where its instances are not the first slide's
# (the same slide, weights and batches): other boxes, or a type probability
# further from the first slide's than the port's bar for probabilities.
PROB_TOL = 1e-3


def _probe_coords(coords: np.ndarray, n: int) -> np.ndarray:
    step = max(1, len(coords) // n)
    return coords[np.arange(0, len(coords), step)[:n]]


def make_weights(ctx, registry_cfg, path: str, nuclei, coords, heads: dict | None = None) -> dict:
    """The seeded state dict on the card, with its heads set as
    ``randomize_cell_model`` and ``sam_heads_from_drawn`` set them, from
    the reference's own forward: the type head scaled to unit-scale logits
    on seeded noise; the nuclei head's first two blocks carrying Fisher's
    discriminant of the drawn nuclei in decoder0's features over probe
    patches spread over the plan, scaled to a spread of 4 and cut at the
    drawn nuclei's share, its last 1x1 their difference as the foreground
    logit; the HV head zeroed, so that each foreground component is one
    nucleus. ``heads`` (the head leaves a first call set) are put back as
    they are instead. The reference's part is the set-up span
    ``calibrate``."""
    import torch

    from wsinsight_tpu_torch.models import create_model

    from ..reference.cellvit import SamCellViT, fisher_head, normalize
    from ..reference.tiff import TiledTiff

    dev, w = ctx.device, ctx.config["widths"]
    with torch.device("meta"):
        meta = create_model(registry_cfg.architecture, registry_cfg.num_classes,
                            halo_size=registry_cfg.halo_size_pixels,
                            img_size=registry_cfg.patch_size_pixels)
    sd = seeded_state_dict(meta, ctx.seed, dev)
    if heads is not None:
        for key, value in heads.items():
            sd[key].copy_(value)
        return sd
    ref = SamCellViT(sd, w)
    img, halo = registry_cfg.patch_size_pixels, registry_cfg.halo_size_pixels
    s = img - 2 * halo
    with torch.no_grad(), ctx.setup_spans("calibrate"):
        for key in HEADS:
            sd[f"{key}.decoder0_header.2.bias"].zero_()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(ctx.seed) + 1)
        noise = torch.randn((2, img, img, 3), generator=gen, device=dev)
        tp = ref.logits(noise, 0)[2]
        sd[f"{HEADS[2]}.decoder0_header.2.weight"].div_(tp.std().clamp(min=1e-6))

        probe = _probe_coords(coords, ctx.config["nuclei_head"]["probe_patches"])
        patches = TiledTiff(path).read_patches(probe, img)
        mask = slides.nuclei_mask(ctx.traffic["slide"]["side"], nuclei)
        feats, inside = [], []
        for i in range(0, len(probe), 8):
            f = ref.decoder0_features(normalize(torch.from_numpy(patches[i:i + 8]).to(dev)))
            feats.append(f[:, :, halo:halo + s, halo:halo + s].permute(0, 2, 3, 1).reshape(
                -1, f.shape[1]))
        for x, y in probe:
            x0, y0 = int(x) + halo, int(y) + halo
            crop = np.zeros((s, s), bool)
            ys, xs = slice(max(0, y0), y0 + s), slice(max(0, x0), x0 + s)
            part = mask[ys, xs].astype(bool)
            crop[ys.start - y0:ys.start - y0 + part.shape[0],
                 xs.start - x0:xs.start - x0 + part.shape[1]] = part
            inside.append(crop.ravel())
        direction, scale, thr = fisher_head(torch.cat(feats),
                                            torch.from_numpy(np.concatenate(inside)).to(dev))
        del feats
        head = f"{HEADS[0]}.decoder0_header"
        for blk in (0, 1):
            sd[f"{head}.{blk}.conv.weight"].zero_()
            sd[f"{head}.{blk}.conv.bias"].zero_()
            sd[f"{head}.{blk}.bn.weight"].fill_(float(np.sqrt(1.0 + 1e-5)))
        wk = direction * scale
        sd[f"{head}.0.conv.weight"][0, :len(wk), 1, 1] = wk
        sd[f"{head}.0.conv.weight"][1, :len(wk), 1, 1] = -wk
        sd[f"{head}.0.conv.bias"][0] = -thr * scale
        sd[f"{head}.0.conv.bias"][1] = thr * scale
        sd[f"{head}.1.conv.weight"][0, 0, 1, 1] = 1.0
        sd[f"{head}.1.conv.weight"][1, 1, 1, 1] = 1.0
        sd[f"{head}.2.weight"].zero_()
        sd[f"{head}.2.bias"].zero_()
        sd[f"{head}.2.weight"][1, 0, 0, 0] = 1.0
        sd[f"{head}.2.weight"][1, 1, 0, 0] = -1.0
        sd[f"{HEADS[1]}.decoder0_header.2.weight"].zero_()
        sd[f"{HEADS[1]}.decoder0_header.2.bias"].zero_()
        sync(dev)
    return sd


def _plan(path: str, cfg):
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath

    plan, sctx, *_ = plan_slide(URIPath(path), None, None, None, cfg.patch_size_pixels,
                                cfg.spacing_um_px, cfg.halo_size_pixels, object_based=True,
                                object_detection="end2end")  # the CLI's defaults
    dims = sctx.slide.dimensions
    sctx.slide.close()
    return plan.coords, dims



def setup(ctx) -> dict:
    with ctx.setup_spans("port_imports"):
        import torch

        from wsinsight_tpu_torch.engine.cells import CellEngine
        from wsinsight_tpu_torch.zoo import get_registered_model

    registry_cfg = get_registered_model(ctx.config["registry_name"]).config
    with ctx.setup_spans("inputs"):
        path, nuclei = slides.slide(ctx.traffic["slide"])
    with ctx.setup_spans("plan"):  # also warms the plan path that every slide of the window runs
        coords, dims = _plan(path, registry_cfg)
    with ctx.setup_spans("libraries"):
        warm_libraries(ctx.device)
    sd = make_weights(ctx, registry_cfg, path, nuclei, coords)
    heads = {k: v.clone() for k, v in sd.items() if k.split(".")[0] in HEADS
             and ".decoder0_header." in k}
    with ctx.setup_spans("engine"), torch.device(ctx.device):
        engine = CellEngine(Weights(registry_cfg, sd),
                            mixed_precision=ctx.config["precision"] == "bfloat16",
                            device=ctx.device)
    del sd
    free_cache(ctx.device)
    state = {"engine": engine, "cfg": registry_cfg, "path": path, "nuclei": nuclei,
             "coords": coords, "dims": dims, "heads": heads}
    # warm-up: the first rows of the plan, in slide-row order, to their instances
    order = np.lexsort((coords[:, 0], coords[:, 1]))
    warm = coords[order[:ctx.config["batch"] * ctx.traffic["warmup_batches"]]]
    with ctx.setup_spans("warm_up"):
        _slide(state, ctx, Spans(), warm_coords=warm)
    return state


def _slide(state: dict, ctx, spans: Spans, warm_coords=None, capture=None) -> dict:
    """One slide through the streaming engine; ``capture`` (a set of batch
    indices) keeps those batches' maps as the step returned them."""
    from wsinsight_tpu_torch.engine.data import PatchBatchSource
    from wsinsight_tpu_torch.engine.stream_cells import make_banded_stitcher, stream_slide

    engine, cfg, config = state["engine"], state["cfg"], ctx.config
    if warm_coords is None:
        with spans("plan"):
            coords, dims = _plan(state["path"], cfg)
    else:
        coords, dims = warm_coords, state["dims"]
    mpp = ctx.traffic["slide"]["mpp"]
    kept, batch_coords = {}, []
    plain_put, plain_dispatch = engine.put, engine.dispatch

    def put(images):
        with spans("put"):
            return plain_put(images)

    def dispatch(images):
        with spans("dispatch"):
            out = plain_dispatch(images)
        i = len(batch_coords) - 1
        if capture is not None and i in capture:
            kept[i] = {k: v.clone() for k, v in out.items() if k != "tissue_types"}
        return out

    def batches(it):
        while True:
            with spans("decode_wait"):
                b = next(it, None)
            if b is None:
                return
            batch_coords.append((b.coords[:b.n_valid, :2].copy(), b.n_valid))
            yield b

    t0 = time.perf_counter()
    bst = make_banded_stitcher(engine, dims[0], dims[1], mpp, cfg.halo_size_pixels,
                               num_flushers=config["flushers"])
    src = PatchBatchSource.from_coords(state["path"], coords, cfg.patch_size_pixels,
                                       engine.pad_batch(config["batch"]),
                                       num_threads=config["decode_threads"], order_by_y=True,
                                       decode_scale=1)
    engine.put, engine.dispatch = put, dispatch
    try:
        with spans("stream"):
            stream_slide(engine, bst, src, it=batches(iter(src)))
        with spans("finalize"):
            boxes, probs, _ = bst.finalize()
    finally:
        engine.put, engine.dispatch = plain_put, plain_dispatch
        src.close()
        bst.close()
    k = cfg.num_classes
    return {"patches": len(coords), "seconds": time.perf_counter() - t0,
            "boxes": np.concatenate(boxes).astype(np.int64) if boxes else np.zeros((0, 4), int),
            "probs": np.concatenate(probs) if probs else np.zeros((0, k), np.float32),
            "batches": batch_coords, "kept": kept, "coords": coords}


def window(state: dict, ctx) -> dict:
    """Slides back to back until ``--seconds`` is out; the first one's
    captured batches and instances are kept for the check, and with
    ctx.trace the slide ``traced_slide`` is traced."""
    from wsinsight_tpu_torch.utils.profiling import hot_stage_report

    rng = np.random.default_rng([ctx.seed, 1])
    capture = set(rng.choice(ctx.config["check"]["batch_of_first"],
                             ctx.config["check"]["batches"], replace=False).tolist())
    spans, results = Spans(), []
    tracer = Tracer(ctx.trace, spans, ctx.device)
    sync(ctx.device)
    reset_peak(ctx.device)
    hot_stage_report(reset=True)
    t0 = time.perf_counter()
    while not results or time.perf_counter() - t0 < ctx.seconds:
        traced = len(results) == ctx.traffic["traced_slide"]
        if traced:
            tracer.begin()
        out = _slide(state, ctx, spans, capture=None if results else capture)
        if traced:
            tracer.end()
        if results:
            out = {k: out[k] for k in ("patches", "seconds", "boxes", "probs")}
        results.append(out)
    window_s = time.perf_counter() - t0
    stages = hot_stage_report(reset=True)
    gaps = [_instance_gap(results[0], r) for r in results[1:]]
    failed = (not len(results[0]["boxes"])) + sum(g > PROB_TOL for g in gaps)
    return {"window_s": window_s, "slides": results, "patches": sum(r["patches"] for r in results),
            "spans": spans, "trace": tracer.trace, "hot_stages": stages,
            "peak_bytes": peak_bytes(ctx.device), "attempted": len(results), "failed": failed,
            "instance_gaps": gaps}


def _instance_gap(first: dict, other: dict) -> float:
    """How far ``other``'s instances lie from ``first``'s, both of the same
    slide: infinite where their boxes differ, else the widest gap of a type
    probability between the same boxes."""
    if first["boxes"].shape != other["boxes"].shape:
        return float("inf")
    a, b = (np.lexsort(tuple(r["probs"].T[::-1]) + tuple(r["boxes"].T[::-1]))
            for r in (first, other))
    if not np.array_equal(first["boxes"][a], other["boxes"][b]):
        return float("inf")
    return float(np.abs(first["probs"][a] - other["probs"][b]).max(initial=0.0))


def free(state: dict, ctx) -> None:
    """Drop the program's state on the card before the reference runs."""
    state.pop("engine", None)
    free_cache(ctx.device)


def _region(coords: np.ndarray, step: int, side: int, rng) -> np.ndarray:
    """The top-left corner of a side x side square of plan patches, all in
    the plan, drawn from ``rng``."""
    have = {(int(x), int(y)) for x, y in coords}
    corners = [(x, y) for x, y in have
               if all((x + i * step, y + j * step) in have
                      for i in range(side) for j in range(side))]
    if not corners:
        raise RuntimeError(f"the plan holds no {side} x {side} square of patches")
    corners.sort()
    return np.array(corners[int(rng.integers(0, len(corners)))])


def check(state: dict, run: dict, ctx, control: str | None = None) -> dict:
    """The numbers of the window's first slide: over two captured batches,
    the mean gaps of the nuclei and the type probabilities to the
    reference's (the configuration's limits compare these) and the share of
    pixels whose nuclei decision (p >= 0.5) differs; over a square of
    patches, ``compare``'s numbers of the instances finalize returned. With
    ``control="fp8"`` the reference in fp8 stands in for the program."""
    import torch

    from ..reference.cellvit import SamCellViT, maps
    from ..reference.instances import compare, instances
    from ..reference.tiff import TiledTiff

    cfg, dev = state["cfg"], ctx.device
    img, halo = cfg.patch_size_pixels, cfg.halo_size_pixels
    s = img - 2 * halo
    slide = run["slides"][0]
    sd = make_weights(ctx, cfg, state["path"], state["nuclei"], state["coords"], state["heads"])
    ref = SamCellViT(sd, ctx.config["widths"])
    ctl = SamCellViT(sd, ctx.config["widths"], "fp8") if control == "fp8" else None
    tiff = TiledTiff(state["path"])
    out = {}

    # the captured batches' maps
    flips = total = 0
    tp_gap = np_gap = 0.0
    n_px = 0
    for i, kept in sorted(slide["kept"].items()):
        xy, n = slide["batches"][i]
        patches = tiff.read_patches(xy, img)
        r_np, _, r_tp = maps(ref, patches, halo, dev)
        if ctl is not None:
            p_np, _, p_tp = maps(ctl, patches, halo, dev)
        else:
            p_np = torch.softmax(kept["nuclei_binary_map"][:n].float(), 1)[:, 1].cpu()
            p_tp = torch.softmax(kept["nuclei_type_map"][:n].float(), 1).cpu()
        flips += int(((p_np >= 0.5) != (r_np >= 0.5)).sum())
        np_gap += float((p_np - r_np).abs().sum())
        total += p_np.numel()
        tp_gap += float((p_tp - r_tp).abs().sum())
        n_px += p_tp.numel()
    out["np_flip_pct"] = 100.0 * flips / max(1, total)
    out["np_mean_gap"] = np_gap / max(1, total)
    out["tp_mean_gap"] = tp_gap / max(1, n_px)

    # the instances over a square of patches
    side = ctx.config["check"]["square_patches"]
    corner = _region(slide["coords"], s, side, np.random.default_rng([ctx.seed, 2]))
    grid = np.array([(corner[0] + i * s, corner[1] + j * s)
                     for j in range(side) for i in range(side)])
    patches = tiff.read_patches(grid, img)
    area = (int(corner[0]) + halo, int(corner[1]) + halo, side * s, side * s)
    k = cfg.num_classes
    canvases = []
    for model in (ref, ctl) if ctl is not None else (ref,):
        r_np, _, r_tp = maps(model, patches, halo, dev)
        np_map = np.zeros((side * s, side * s), np.float32)
        tp_map = np.zeros((k, side * s, side * s), np.float32)
        for (x, y), a, t in zip(grid, r_np.numpy(), r_tp.numpy()):
            oy, ox = int(y - corner[1]), int(x - corner[0])
            np_map[oy:oy + s, ox:ox + s] = a
            tp_map[:, oy:oy + s, ox:ox + s] = t
        canvases.append(instances(np_map, tp_map, area[:2], ctx.config["min_object_size"],
                                  ctx.config["check"]["logit_margin"]))
    if ctl is not None:
        got_boxes, got_probs = canvases[1]["boxes"], canvases[1]["probs"]
    else:
        got_boxes, got_probs = slide["boxes"], slide["probs"]
    out.update(compare(got_boxes, got_probs, canvases[0], area, ctx.config["watershed_tile"]))
    gaps = run["instance_gaps"]
    out["slides_other_boxes"] = sum(g == float("inf") for g in gaps)
    out["slides_prob_gap"] = max((g for g in gaps if g != float("inf")), default=0.0)
    return out
