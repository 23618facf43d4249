"""The port's banded streaming cell engine against the JAX package's.

The same inputs, made from a numpy seed, go through the JAX package's
``engine/stream_cells.py`` and the port's: its seven device programs fed the
same bf16 band buffers, and ``BandedCellStitcher`` as a whole on a 512 px
slide of 64 px patches (tiles of 128 with 32 px of context, K = 3, as
tests/test_cells.py's streaming tests), in every energy, sparse and basin
mode, against the JAX stitcher and against the port's host-canvas stitcher
(quantized transfer, device ridge). The port runs on the CPU.

Tolerances: bitmasks, counts and the proposal's boundary and basin bytes
are integer recipes on the same foreground definition, held identical; the
energy is f32 shifted adds in both packages whose sums XLA may reorder, so
u8 energies are held within one level on at most 1e-3 of pixels, f32
within 1e-5 (the ridge's bar, tests/test_torch_cells_host.py) and u16 within
one level (1e-5 is 0.66 of a u16 level, so any pixel may round apart); the
band buffers within one bf16 ulp (the maps differ in the last f32 bits
before the cast); class sums within 1e-6 relative (another summation
order), counts exact. Instances: identical boxes and polygons, probabilities
within 1e-5 of the JAX stitcher's (bf16 ulps averaged over each nucleus) and
within 5e-3 of the host-canvas engine's (its uint8 transfer; the JAX
package's own bar, tests/test_cells.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ENV = ("WSINSIGHT_STREAM_ENERGY", "WSINSIGHT_STREAM_SPARSE", "WSINSIGHT_STREAM_BASIN",
       "WSINSIGHT_HV_BASIN", "WSINSIGHT_DEVICE_RIDGE", "WSINSIGHT_CELL_TRANSFER",
       "WSINSIGHT_STREAM_CELLS", "WSINSIGHT_STREAM_HBM_BYTES")
SIDE, S, K, TILE, PAD = 512, 64, 3, 128, 32
EPS = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _nucleus(np_map, hv, cy, cx, r):
    yy, xx = np.mgrid[:S, :S].astype(np.float32)
    inside = np.hypot(yy - cy, xx - cx) < r
    np_map[inside] = 1.0
    hv[0][inside] = ((xx - cx) / r)[inside]
    hv[1][inside] = ((yy - cy) / r)[inside]


def _slide_preds(seed=0):
    """(coords (N, 4) sorted by row, [(np, hv, tp) logits of each patch]):
    two touching nuclei per patch in the top half, one on alternating
    patches below it, and an empty bottom band of patches, so that the
    watershed splits, single components and empty windows all occur."""
    rng = np.random.default_rng(seed)
    coords, preds = [], []
    for y0 in range(0, SIDE, S):
        for x0 in range(0, SIDE, S):
            np_map = np.zeros((S, S), np.float32)
            hv = np.zeros((2, S, S), np.float32)
            if y0 < SIDE // 2:
                _nucleus(np_map, hv, 26, 24, 12)
                _nucleus(np_map, hv, 28, 44, 11)
            elif y0 < SIDE - S and (x0 // S + y0 // S) % 2 == 0:
                _nucleus(np_map, hv, 32, 32, 14)
            np_logits = np.stack([np.log1p(-np_map + EPS), np.log(np_map + EPS)])
            tp = np.stack([1.0 - np_map, np_map * 0.7, np_map * 0.3])
            tp_logits = np.log(tp + EPS) + rng.normal(0, 1e-3, (K, S, S))
            coords.append([x0, y0, S, S])
            preds.append((np_logits, hv, tp_logits.astype(np.float32)))
    return np.asarray(coords, np.int64), preds


SLIDE = _slide_preds()
COMMON = dict(n_classes=K, slide_width=SIDE, slide_height=SIDE, slide_patch_size=S,
              slide_halo_size=0, slide_mpp=0.25, model_mpp=0.25, min_object_size=20)


def _feed(accumulate, bs=4):
    coords, preds = SLIDE
    for i0 in range(0, len(coords), bs):
        sel = slice(i0, i0 + bs)
        batch = {key: np.stack([p[j] for p in preds[sel]]) for j, key in enumerate("np hv tp".split())}
        accumulate(batch, coords[sel])


def _ordered(out):
    boxes = np.concatenate(out[0])
    order = np.lexsort((boxes[:, 3], boxes[:, 2], boxes[:, 0], boxes[:, 1]))
    return boxes[order], np.concatenate(out[1])[order], [out[2][i] for i in order]


def _assert_same_instances(got, want, prob_atol):
    for out in (got, want):
        assert len(out[0]) == len(out[1]) == len(out[2])
    assert len(got[0]) == len(want[0]) > 0
    gb, gp, gpoly = _ordered(got)
    wb, wp, wpoly = _ordered(want)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_allclose(gp, wp, atol=prob_atol, rtol=0)
    for a, b in zip(gpoly, wpoly):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The seven device programs
# ---------------------------------------------------------------------------

BUF_H, BUF_W = TILE + 2 * PAD + 2 * S, SIDE + 2 * S


def _bands(seed=3):
    """Band buffers as bf16 numpy-f32 values: NP from smoothed noise (many
    pixels at the 0.5 cut), HV from drawn nuclei plus noise, TP random."""
    import cv2

    rng = np.random.default_rng(seed)
    np_b = cv2.GaussianBlur(rng.random((BUF_H, BUF_W)).astype(np.float32), (0, 0), 4)
    np_b = (np_b - np_b.min()) / (np_b.max() - np_b.min())
    hv_b = np.zeros((BUF_H, BUF_W, 2), np.float32)
    for y0 in range(0, BUF_H - S + 1, S):
        for x0 in range(0, BUF_W - S + 1, S):
            np_p, hv_p = np.zeros((S, S), np.float32), np.zeros((2, S, S), np.float32)
            _nucleus(np_p, hv_p, *rng.uniform(16, 48, 2), rng.uniform(8, 14))
            hv_b[y0 : y0 + S, x0 : x0 + S] = hv_p.transpose(1, 2, 0)
    hv_b += rng.normal(0, 0.02, hv_b.shape).astype(np.float32)
    tp_b = rng.random((BUF_H, BUF_W, K)).astype(np.float32)
    # round to bf16 once, so both packages start from the same values
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (np_b, hv_b, tp_b))


def _programs(mode, alpha=1.0):
    from wsinsight_tpu.engine.stream_cells import _cached_kernels as jax_kernels
    from wsinsight_tpu_torch.engine.stream_cells import _cached_kernels as port_kernels

    return jax_kernels(S, K, alpha, mode), port_kernels(S, K, alpha, mode, torch.device("cpu"))


def _jnp_bf16(t):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _assert_levels(got, want, max_share=1e-3):
    """Integer energies within one level, on at most ``max_share`` of pixels."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= max_share, (d.max(), (d > 0).mean())


def _assert_bf16_ulp(got, want):
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    assert (np.abs(got - want) <= ulp).all(), float(np.abs(got - want).max())


# windows: an interior tile with context on every side, the left edge, and
# the band interior's full row (the class sums' and counts' extent)
WINDOWS = ((PAD, S + TILE - PAD, TILE + 2 * PAD, TILE + 2 * PAD),
           (PAD, S, TILE + 2 * PAD, TILE + PAD),
           (PAD + S // 2, S, TILE, SIDE))


def test_scatter_fused_matches_jax():
    """Post-process (softmax, antialiased resize 80 -> 64, HV x alpha, TP
    renormalised) and scatter of overlapping patches into bf16 bands: the
    later patch wins the overlap, an invalid row writes nothing."""
    rng = np.random.default_rng(4)
    b, h = 5, 80
    logits = (rng.normal(0, 2, (b, 2, h, h)).astype(np.float32),
              rng.normal(0, 0.5, (b, 2, h, h)).astype(np.float32),
              rng.normal(0, 1, (b, K, h, h)).astype(np.float32))
    rcv = np.array([[0, 20, 40, 150, 250], [0, 30, 60, 300, 500], [1, 1, 1, 0, 1]], np.int32)
    (jax_scatter, *_), (port_scatter, *_) = _programs("u8", alpha=1.25)
    bands = _bands()
    want = jax_scatter(*(_jnp_bf16(t) for t in bands), *logits, rcv)
    got = port_scatter(*(t.clone() for t in bands), *(torch.from_numpy(x) for x in logits), rcv)
    for g, w, t in zip(got, want, bands):
        _assert_bf16_ulp(g.float().numpy(), w)
        assert not torch.equal(g, t)  # the patches landed
    # row 3 is invalid: its region, which no valid patch covers, keeps the
    # band's values
    for g, t in zip(got, bands):
        assert torch.equal(g[150:214, 300:364], t[150:214, 300:364])


@pytest.mark.parametrize("mode", ["u8", "u16", "f32"])
@pytest.mark.parametrize("window", range(len(WINDOWS)))
def test_window_stage_matches_jax(mode, window):
    r0, c0, wh, ww = WINDOWS[window]
    (_, jax_stage, *_), (_, port_stage, *_) = _programs(mode)
    np_b, hv_b, _ = _bands()
    want = jax_stage(_jnp_bf16(np_b), _jnp_bf16(hv_b), r0, c0, wh, ww)
    got = port_stage(np_b, hv_b, r0, c0, wh, ww)
    pw = (ww + 7) // 8
    if mode == "u8":
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape == (wh, pw + ww) and got.dtype == np.uint8
        np.testing.assert_array_equal(got[:, :pw], want[:, :pw])
        _assert_levels(got[:, pw:], want[:, pw:])
        return
    (want_bits, want_e), (got_bits, got_e) = (np.asarray(a) for a in want), got
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    got_e = got_e.numpy()
    assert got_e.dtype == want_e.dtype and got_e.shape == want_e.shape == (wh, ww)
    if mode == "u16":
        _assert_levels(got_e, want_e, max_share=1.0)
    else:
        np.testing.assert_allclose(got_e, want_e, atol=1e-5, rtol=0)


def test_window_counts_match_jax():
    jax_p, port_p = _programs("u8")
    np_b, _, _ = _bands()
    starts = np.array([w[:2] for w in WINDOWS], np.int32)
    sizes = tuple(w[2:] for w in WINDOWS)
    want = np.asarray(jax_p[3](_jnp_bf16(np_b), starts, sizes))
    got = port_p[3](np_b, starts, sizes).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all() and (got < [w[2] * w[3] for w in WINDOWS]).all()


@pytest.mark.parametrize("window", range(len(WINDOWS)))
def test_sparse_and_proposal_windows_match_jax(window):
    """[bitmask | fg energy] and [fg bits | boundary bits | basin lo | hi]:
    the bits and the basin bytes identical, the energy within one level."""
    r0, c0, wh, ww = WINDOWS[window]
    jax_p, port_p = _programs("u8")
    np_b, hv_b, _ = _bands()
    args_j, args_p = (_jnp_bf16(np_b), _jnp_bf16(hv_b)), (np_b, hv_b)
    nb = wh * ((ww + 7) // 8)
    n_fg = int(np.asarray(jax_p[3](args_j[0], np.array([[r0, c0]], np.int32), ((wh, ww),)))[0])
    cap = 4096
    while cap < n_fg:
        cap *= 2
    want = np.asarray(jax_p[4](*args_j, r0, c0, wh, ww, cap))
    got = port_p[4](*args_p, r0, c0, wh, ww, cap).numpy()
    assert got.shape == want.shape == (nb + cap,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:nb], want[:nb])
    _assert_levels(got[nb : nb + n_fg], want[nb : nb + n_fg])
    np.testing.assert_array_equal(got[nb + n_fg :], want[nb + n_fg :])  # zero padding

    want = np.asarray(jax_p[6](*args_j, r0, c0, wh, ww, cap))
    got = port_p[6](*args_p, r0, c0, wh, ww, cap).numpy()
    assert got.shape == want.shape == (2 * nb + 2 * cap,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ids_dtype", [np.uint16, np.int32])
def test_class_sums_match_jax(ids_dtype):
    """Both class-sum programs: the packed (index, id) upload and the
    id-only upload (u16 and i32 ids), against the JAX package's."""
    jax_p, port_p = _programs("u8")
    np_b, _, tp_b = _bands()
    off_r, off_c, ih, iw = interior = (PAD + S // 2, S, TILE, SIDE)
    fg = np.round(np_b.float().numpy() * 255).astype(np.uint8)[
        off_r : off_r + ih, off_c : off_c + iw] >= 128
    fy, fx = np.nonzero(fg)
    ids = np.random.default_rng(5).integers(0, 300, fy.size).astype(np.int32)  # some id 0
    cap, id_cap = 65536, 1024
    assert fy.size <= cap
    pix = np.zeros((2, cap), np.int32)
    pix[0, : fy.size] = (fy + off_r) * BUF_W + (fx + off_c)
    pix[1, : fy.size] = ids
    ids_up = np.zeros((cap,), ids_dtype)
    ids_up[: fy.size] = ids.astype(ids_dtype)
    for (jax_out, port_out) in (
        (jax_p[2](_jnp_bf16(tp_b), pix, id_cap), port_p[2](tp_b, torch.from_numpy(pix), id_cap)),
        (jax_p[5](_jnp_bf16(tp_b), _jnp_bf16(np_b), ids_up, interior, id_cap),
         port_p[5](tp_b, np_b, torch.from_numpy(ids_up), interior, id_cap)),
    ):
        (want_sums, want_counts), (got_sums, got_counts) = jax_out, port_out
        np.testing.assert_allclose(got_sums.numpy()[1:], np.asarray(want_sums)[1:], rtol=1e-6)
        np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
        assert got_counts.numpy()[1:].sum() == (ids > 0).sum()


# ---------------------------------------------------------------------------
# The stitcher as a whole
# ---------------------------------------------------------------------------

MODES = {  # name -> (environment, whether sparse windows, whether the device basin)
    "dense_u8": ({"WSINSIGHT_STREAM_SPARSE": "0"}, False, False),
    "dense_u16": ({"WSINSIGHT_STREAM_ENERGY": "u16"}, False, False),
    "dense_f32": ({"WSINSIGHT_STREAM_ENERGY": "f32"}, False, False),
    "sparse": ({"WSINSIGHT_STREAM_BASIN": "host"}, True, False),
    "proposal": ({"WSINSIGHT_STREAM_BASIN": "device"}, True, True),
}


@pytest.fixture(scope="module")
def host_canvas():
    """The port's host-canvas stitcher over the slide: quantized transfer,
    the device ridge (on the CPU)."""
    from wsinsight_tpu_torch.engine.stitch import TileRemapStitcher

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WSINSIGHT_DEVICE_RIDGE", "1")
        st = TileRemapStitcher(transfer_dtype="quantized", device="cpu", **COMMON)
        _feed(st.accumulate_batch)
        out = st.finalize(tile_size=TILE, padding_size=PAD, num_workers=1)
        st.close()
    return out


def _run_banded(cls, **kw):
    st = cls(tile_size=TILE, padding_size=PAD, **COMMON, **kw)
    try:
        _feed(st.accumulate_batch)
        return st, st.finalize()
    finally:
        st.close()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_banded_stitcher_matches_jax_and_host_canvas(monkeypatch, host_canvas, mode):
    from wsinsight_tpu.engine.stream_cells import BandedCellStitcher as JaxStitcher
    from wsinsight_tpu_torch.engine.stream_cells import BandedCellStitcher

    env, sparse, device_basin = MODES[mode]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setenv("WSINSIGHT_STREAM_WARMUP", "0")  # the JAX stitcher's compile thread
    st, got = _run_banded(BandedCellStitcher, num_flushers=2, device="cpu")
    assert (st._sparse_windows, st._basin_device) == (sparse, device_basin)
    jst, want = _run_banded(JaxStitcher, num_flushers=2)
    assert (jst._sparse_windows, jst._basin_device) == (sparse, device_basin)
    assert len(got[0]) == 2 * 32 + 12  # two per patch in the top half, one on alternate ones
    _assert_same_instances(got, want, prob_atol=1e-5)
    _assert_same_instances(got, host_canvas, prob_atol=5e-3)


# ---------------------------------------------------------------------------
# Behaviour
# ---------------------------------------------------------------------------


def test_flusher_error_surfaces_on_main_thread():
    from wsinsight_tpu_torch.engine.stream_cells import BandedCellStitcher

    st = BandedCellStitcher(tile_size=TILE, padding_size=PAD, device="cpu", **COMMON)
    try:
        def bad_flush(*args):
            raise RuntimeError("flush boom")

        st._flush_band = bad_flush
        _feed(st.accumulate_batch, bs=64)  # one batch: every band flushes at finalize
        with pytest.raises(RuntimeError, match="flush boom"):
            st.finalize()
    finally:
        st.close()
    assert not any(t.is_alive() for t in st._flushers)


@pytest.mark.parametrize("program", ["_window_stage_sparse", "_window_stage_proposal",
                                     "_window_counts", "_class_sums_from_fg"])
def test_failing_device_program_raises(monkeypatch, program):
    """A device program that fails raises out of the stitcher: no quiet
    fall back to dense windows, the host basin or the packed upload (the
    JAX package falls back, tests/test_cells.py::
    test_sparse_window_backend_fallback_is_silent_and_identical)."""
    from wsinsight_tpu_torch.engine.stream_cells import BandedCellStitcher

    monkeypatch.setenv("WSINSIGHT_STREAM_BASIN",
                       "device" if program == "_window_stage_proposal" else "host")
    st = BandedCellStitcher(tile_size=TILE, padding_size=PAD, device="cpu", **COMMON)
    try:
        def boom(*args):
            raise RuntimeError(f"{program} failed on this device")

        setattr(st, program, boom)
        with pytest.raises(RuntimeError, match=f"{program} failed"):
            _feed(st.accumulate_batch)
            st.finalize()
        assert st._sparse_windows  # no mode was given up
        assert st._basin_device is (program == "_window_stage_proposal")
    finally:
        st.close()


def test_probe_picks_the_basin(monkeypatch):
    """Unset, WSINSIGHT_STREAM_BASIN follows the link probe (250 MB/s); the
    float basin (WSINSIGHT_HV_BASIN=f32) or dense windows turn the device
    proposal off."""
    import wsinsight_tpu_torch.engine.stream_cells as sc

    assert sc._d2h_mbps(torch.device("cpu")) > 0
    rate = {"value": 1e4}
    monkeypatch.setattr(sc, "_d2h_mbps", lambda device: rate["value"])
    kw = dict(tile_size=TILE, padding_size=PAD, device="cpu", **COMMON)
    for value, env, want in ((1e4, {}, True), (100.0, {}, False),
                             (1e4, {"WSINSIGHT_HV_BASIN": "f32"}, False),
                             (1e4, {"WSINSIGHT_STREAM_SPARSE": "0"}, False)):
        rate["value"] = value
        with monkeypatch.context() as mp:
            for var, v in env.items():
                mp.setenv(var, v)
            st = sc.BandedCellStitcher(**kw)
            st.close()
        assert st._basin_device is want, (value, env)


def test_streaming_fits_budget(monkeypatch):
    """The JAX package's admission rule and 6 GiB default: 3 + (n + 1) + n
    bf16 bands of (3 + K) channels."""
    from wsinsight_tpu.engine.stream_cells import streaming_fits as jax_fits
    from wsinsight_tpu_torch.engine.stream_cells import pick_num_flushers, streaming_fits

    # (l)'s geometry: an 8,192 px slide, SAM-H's 164 px patches, K = 6
    per_band = (2048 + 128 + 2 * 164) * (8192 + 2 * 164) * 9 * 2
    for n in (1, 4, 8):
        assert streaming_fits(8192, 6, 164, num_flushers=n) == (
            (4 + 2 * n) * per_band <= 6 << 30) == jax_fits(8192, 6, 164, num_flushers=n)
    monkeypatch.setenv("WSINSIGHT_STREAM_HBM_BYTES", str(per_band * 6))
    assert streaming_fits(8192, 6, 164, num_flushers=1)
    assert not streaming_fits(8192, 6, 164, num_flushers=2)
    for workers in (None, 0, 1, 3, 20):
        from wsinsight_tpu.engine.stream_cells import pick_num_flushers as jax_pick

        assert pick_num_flushers(workers) == jax_pick(workers)


def test_many_flushers_give_the_same_instances():
    """More flushers than bands and cores, with the interpreter switching
    threads every microsecond: the same instances, in the same order, as
    one flusher (each band is flushed by one worker into its own slot and
    bands merge in index order); every flusher exits at close."""
    import os
    import sys

    from wsinsight_tpu_torch.engine.stream_cells import BandedCellStitcher

    _, one = _run_banded(BandedCellStitcher, num_flushers=1, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        st, many = _run_banded(BandedCellStitcher, num_flushers=(os.cpu_count() or 4) + 4,
                               device="cpu")
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in st._flushers)
    for a, b in zip(one, many):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_each_band_has_one_flush_span(monkeypatch):
    """With spans on, each band enqueued has exactly one ``flush.band`` on a
    flusher, whose parent is the band's ``flush.enqueue`` on the main
    thread and which starts after it ends; the flushers' stages nest in
    it; the bands' instance counts sum to the instances finalize returns."""
    import collections
    import threading

    from wsinsight_tpu_torch.engine.stream_cells import BandedCellStitcher
    from wsinsight_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_PROF_ENABLED", True)
    monkeypatch.setattr(profiling, "_BUF", collections.deque(maxlen=profiling._CAPACITY))
    _, got = _run_banded(BandedCellStitcher, num_flushers=2, device="cpu")
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    enqueued = {s.id: s for s in spans if s.name == "flush.enqueue"}
    bands = [s for s in spans if s.name == "flush.band"]
    main = threading.get_native_id()
    assert len(enqueued) > 1 and {s.thread for s in enqueued.values()} == {main}
    assert sorted(s.parent for s in bands) == sorted(enqueued)
    assert sorted(s.n for s in enqueued.values()) == list(range(len(enqueued)))  # band indices
    for band in bands:
        assert band.thread != main and band.start_ns >= enqueued[band.parent].end_ns
    assert sum(s.n for s in bands) == len(got[0]) > 0
    extracts = [s for s in spans if s.name == "flush.extract_instances"]
    assert extracts and all(by_id[s.parent].name == "flush.band" for s in extracts)
    scatters = [s for s in spans if s.name == "accumulate.scatter_dispatch"]
    assert scatters and all(by_id[s.parent].name == "stream.accumulate" for s in scatters)
    joins = [s for s in spans if s.name == "finalize.join"]
    assert len(joins) == 1 and [by_id[s.parent].name for s in enqueued.values()].count(
        "finalize.join") >= 1
