"""Driver ``classifier_resident``: the classifier engine's step over batches
already decoded, as a deployment runs it once decode keeps up.

Set-up takes B x ``batches`` patches, drawn from the seed, of the traffic's
seeded slide as the port's ``plan_slide`` plans it and its
``PatchBatchSource`` decodes them, and holds them in host memory (the
plan's decoded patches are cached beside the slide on a checkout's first
run, so later runs read rather than decode them); it makes the weights on
the card from the seed, builds ``ClassifierEngine`` on them and warms it.
The window is one ``classify_slide(engine, src, it=...)`` whose iterator
cycles the held batches until ``--seconds`` is out: its two-deep window,
``device_prefetch``'s ``put`` two batches ahead and the ``.cpu()`` of the
probabilities, as the CLI runs them. The window closes when the last
batch's probabilities are on the host.

The check compares the probabilities of batches drawn from the seed, as the
window returned them, with the plain reference (PIL resize, float32
ResNet, softmax) over the same patches, decoded by the reference itself."""

from __future__ import annotations

import time

import numpy as np

from .. import slides
from ..common import (Spans, Tracer, Weights, free_cache, peak_bytes, reset_peak,
                      seeded_state_dict, sync, warm_libraries)


class _Fetched:
    """The step's device output; ``cpu()`` (the probabilities' fetch)
    notes its host time."""

    __slots__ = ("out", "times")

    def __init__(self, out, times):
        self.out, self.times = out, times

    def cpu(self):
        host = self.out.cpu()
        self.times.append(time.perf_counter())
        return host


def _reference_cfg(config: dict, registry_cfg) -> dict:
    transform = {t.name: t.arguments for t in registry_cfg.transform}
    return {"resize": int(transform["Resize"]["size"]), "mean": transform["Normalize"]["mean"],
            "std": transform["Normalize"]["std"], "layers": config["widths"]["layers"]}


def make_weights(ctx, registry_cfg, path: str, probe_coords: np.ndarray) -> dict:
    """The seeded state dict on the card, its head set to read the cosine of
    each class's weights with the pooled features (each row scaled to
    1 / (its norm x the features' root mean square norm over the patches at
    ``probe_coords``, read by the reference)) and shifted so that each
    class's mean over them is 0: the probabilities do not saturate, and a
    rounding error of the features moves them by the same amount for every
    seed. The reference's part is the set-up span ``calibrate``."""
    import torch

    from wsinsight_tpu_torch.models import create_model

    from ..reference import classifier
    from ..reference.tiff import TiledTiff

    with torch.device("meta"):
        meta = create_model(registry_cfg.architecture, registry_cfg.num_classes)
    sd = seeded_state_dict(meta, ctx.seed, ctx.device)
    ref = _reference_cfg(ctx.config, registry_cfg)
    with torch.no_grad(), ctx.setup_spans("calibrate"):
        probe = TiledTiff(path).read_patches(probe_coords, registry_cfg.patch_size_pixels)
        x = classifier.preprocess(probe, ref["resize"], ref["mean"], ref["std"], ctx.device)
        feats = classifier.resnet_features(x, sd, ref["layers"])
        w = sd["fc.weight"]
        w.div_(w.norm(dim=1, keepdim=True) * feats.square().sum(1).mean().sqrt())
        sd["fc.bias"].copy_(-(feats @ w.T).mean(0))
        sync(ctx.device)
    return sd


def _decode_plan(path: str, registry_cfg, config: dict) -> dict:
    """Every patch that ``plan_slide`` plans on the slide, decoded by the
    port's ``PatchBatchSource``: {"coords": (N, 4), "images": (N, H, W, 3)}."""
    from wsinsight_tpu_torch.engine.data import PatchBatchSource
    from wsinsight_tpu_torch.patchlib import plan_slide
    from wsinsight_tpu_torch.uri_path import URIPath

    plan, sctx, *_ = plan_slide(URIPath(path), None, None, None, registry_cfg.patch_size_pixels,
                                registry_cfg.spacing_um_px)
    sctx.slide.close()
    src = PatchBatchSource.from_coords(path, plan.coords, registry_cfg.patch_size_pixels,
                                       config["batch"], num_threads=config["decode_threads"],
                                       decode_scale=1)
    coords, images = [], []
    try:
        for batch in src:
            coords.append(batch.coords[:batch.n_valid])
            images.append(batch.images[:batch.n_valid])
    finally:
        src.close()
    return {"coords": np.concatenate(coords), "images": np.concatenate(images)}


def setup(ctx) -> dict:
    with ctx.setup_spans("port_imports"):
        import torch

        from wsinsight_tpu_torch.engine import ClassifierEngine
        from wsinsight_tpu_torch.engine.data import Batch, PatchBatchSource
        from wsinsight_tpu_torch.zoo import get_registered_model

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    registry_cfg = get_registered_model(config["registry_name"]).config
    with ctx.setup_spans("inputs"):
        path, _ = slides.slide(traffic["slide"])
        pool = slides.cached("decoded", {"slide": traffic["slide"], "decode_scale": 1,
                                         "patch_size": registry_cfg.patch_size_pixels,
                                         "spacing": registry_cfg.spacing_um_px},
                             lambda: _decode_plan(path, registry_cfg, config))
        b, k = config["batch"], traffic["batches"]
        n = len(pool["coords"])
        if n < b * k:
            raise RuntimeError(f"the slide plans {n} patches, fewer than {b} x {k}")
        rng = np.random.default_rng(ctx.seed)
        chosen = np.sort(rng.choice(n, b * k, replace=False))
        batches = [Batch(images=np.ascontiguousarray(pool["images"][idx]),
                         coords=np.array(pool["coords"][idx]), n_valid=b)
                   for idx in chosen.reshape(k, b)]
        src = PatchBatchSource.from_coords(path, pool["coords"][chosen, :2],
                                           registry_cfg.patch_size_pixels, b, num_threads=1)
        src.close()  # classify_slide reads only its batch count; the batches come from ``it``
    with ctx.setup_spans("libraries"):
        warm_libraries(dev)
    sd = make_weights(ctx, registry_cfg, path, batches[0].coords[:16, :2])
    with ctx.setup_spans("engine"), torch.device(dev):
        engine = ClassifierEngine(Weights(registry_cfg, sd),
                                  mixed_precision=config["precision"] == "bfloat16", device=dev)
    del sd
    free_cache(dev)
    state = {"engine": engine, "src": src, "batches": batches, "path": path,
             "registry_cfg": registry_cfg}
    with ctx.setup_spans("warm_up"):
        _run(state, ctx, warm=traffic["warmup_batches"])
    return state


def _run(state: dict, ctx, seconds: float | None = None, warm: int = 0) -> dict:
    """One classify_slide over the held batches: ``warm`` of them, or as
    many as ``seconds`` allows; with ctx.trace, a torch.profiler trace from
    trace_start_s to trace_end_s of the window."""
    from wsinsight_tpu_torch.engine.runner import classify_slide

    engine, batches = state["engine"], state["batches"]
    spans, puts, fetches, order = Spans(), [], [], []
    plain_put, plain_dispatch = engine.put, engine.dispatch
    traffic = ctx.traffic
    tracer = Tracer(ctx.trace and not warm, spans, ctx.device)

    def put(images):
        with spans("put"):
            t0 = time.perf_counter()
            out = plain_put(images)
            puts.append(time.perf_counter() - t0)
        return out

    def dispatch(images):
        with spans("dispatch"):
            return _Fetched(plain_dispatch(images), fetches)

    def feed():
        i = 0
        while (i < warm) if warm else (time.perf_counter() - t0 < seconds):
            now = time.perf_counter() - t0
            if now >= traffic["trace_end_s"]:
                tracer.end()
            elif now >= traffic["trace_start_s"]:
                tracer.begin()
            order.append(i % len(batches))
            yield batches[i % len(batches)]
            i += 1

    engine.put, engine.dispatch = put, dispatch
    try:
        sync(ctx.device)
        if not warm:
            reset_peak(ctx.device)
        t0 = time.perf_counter()
        _, probs = classify_slide(engine, state["src"], it=feed())
        window_s = time.perf_counter() - t0
        tracer.end()
    finally:
        engine.put, engine.dispatch = plain_put, plain_dispatch
    return {"window_s": window_s, "probs": probs, "order": order, "puts": puts,
            "fetches": fetches, "spans": spans, "trace": tracer.trace}


def window(state: dict, ctx) -> dict:
    run = _run(state, ctx, seconds=ctx.seconds)
    probs, b = run["probs"], ctx.config["batch"]
    run["patches"] = len(run["order"]) * b
    run["peak_bytes"] = peak_bytes(ctx.device)
    rows_ok = np.isfinite(probs).all(axis=1) & (np.abs(probs.sum(axis=1) - 1.0) <= 1e-3)
    run["attempted"] = run["patches"]
    run["failed"] = int(run["patches"] - rows_ok.sum())
    return run


def free(state: dict, ctx) -> None:
    """Drop the program's state on the card before the reference runs."""
    state.pop("engine", None)
    free_cache(ctx.device)


def sample(run: dict, ctx) -> list[int]:
    """Positions (in the window's order) of the batches the check compares."""
    rng = np.random.default_rng([ctx.seed, 1])
    n = len(run["order"])
    return sorted(rng.choice(n, min(n, ctx.config["check"]["batches"]), replace=False).tolist())


def reference_probs(state: dict, ctx, positions, order, precision: str) -> np.ndarray:
    from ..reference import classifier
    from ..reference.tiff import TiledTiff

    cfg = state["registry_cfg"]
    tiff = TiledTiff(state["path"])
    sd = make_weights(ctx, cfg, state["path"], state["batches"][0].coords[:16, :2])
    ref = _reference_cfg(ctx.config, cfg)
    out = []
    for pos in positions:
        batch = state["batches"][order[pos]]
        patches = tiff.read_patches(batch.coords[:batch.n_valid, :2], cfg.patch_size_pixels)
        out.append(classifier.probabilities(patches, sd, ref, ctx.device, precision))
    return np.concatenate(out)


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    diff = np.abs(got.astype(np.float64) - want)
    return {"max_abs_dp": float(diff.max()), "mean_abs_dp": float(diff.mean())}


def check(state: dict, run: dict, ctx, control: str | None = None) -> dict:
    """The numbers compared: the window's probabilities (or, with
    ``control="fp8"``, the reference's own in fp8) against the reference's
    in float32, over the sampled batches."""
    b = ctx.config["batch"]
    positions = sample(run, ctx)
    want = reference_probs(state, ctx, positions, run["order"], "float32")
    if control == "fp8":
        got = reference_probs(state, ctx, positions, run["order"], "fp8")
    else:
        got = np.concatenate([run["probs"][p * b:(p + 1) * b] for p in positions])
    return compare(got, want)
