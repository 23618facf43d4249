"""The port's devices, replicas and multi-host runs against the JAX package.

The engines and the DGI run on repeated CPU devices (``["cpu", "cpu"]``,
``["cpu"] * 8``), the port's counterpart of the 8 virtual CPU devices that
tests/conftest.py gives the JAX package: the split over replicas must give
the one-device results (within 1e-6; bit for bit block by block), and the
JAX package's over its mesh within the parity bars. Multi-host runs start two CPU processes under one
coordinator on a free local port."""

import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from test_torch_engine import _make_model  # noqa: E402
from wsinsight_tpu.engine.cells import CellEngine as JaxCellEngine  # noqa: E402
from wsinsight_tpu.engine.runner import ClassifierEngine as JaxEngine  # noqa: E402
from wsinsight_tpu.insightlib import gnn as jax_gnn  # noqa: E402
from wsinsight_tpu.insightlib.cme import train_dgi_multi as jax_train  # noqa: E402
from wsinsight_tpu.zoo import load_local_model as jax_load_local  # noqa: E402
from wsinsight_tpu.zoo import make_random_local_model as jax_make_random  # noqa: E402
from wsinsight_tpu_torch.engine import CellEngine, ClassifierEngine  # noqa: E402
from wsinsight_tpu_torch.insightlib import gnn, stats  # noqa: E402
from wsinsight_tpu_torch.insightlib.cme import prepare_slide_graph, train_dgi_multi  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402
from wsinsight_tpu_torch.parallel import multihost  # noqa: E402
from wsinsight_tpu_torch.parallel.mesh import device_batch_size, resolve_devices  # noqa: E402
from wsinsight_tpu_torch.zoo import load_local_model  # noqa: E402

MAPS = ("nuclei_binary_map", "hv_map", "nuclei_type_map", "tissue_types")
_ENV = ("WSINSIGHT_PALLAS_PREPROCESS", "WSINFER_FORCE_CPU", "WSINSIGHT_WIRE",
        "WSINSIGHT_HOST_RESIZE", "WSINSIGHT_PRECISION", "JAX_COORDINATOR_ADDRESS",
        "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


def test_resolve_devices(monkeypatch):
    """Every visible card by default, cut by max_devices; a list as given
    (a device may repeat); device= the one-device form; the CPU under
    WSINFER_FORCE_CPU; no CUDA and no CPU asked for raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert resolve_devices() == cards
    assert resolve_devices(max_devices=2) == cards[:2]
    assert resolve_devices(device="cuda:2") == cards[2:]
    assert resolve_devices(["cuda:0", "cuda:0"]) == [cards[0]] * 2
    assert resolve_devices(["cpu"] * 8, max_devices=4) == [torch.device("cpu")] * 4
    assert device_batch_size(30, cards) == 30 and device_batch_size(31, cards) == 33
    with pytest.raises(RuntimeError, match="3 CUDA"):
        resolve_devices(["cuda:3"])
    with pytest.raises(ValueError, match="not both"):
        resolve_devices(["cpu"], device="cpu")
    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    assert resolve_devices() == [torch.device("cpu")]
    monkeypatch.delenv("WSINFER_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_devices()


@pytest.fixture(scope="module")
def two_class(tmp_path_factory):
    return _make_model(tmp_path_factory.mktemp("m2"), 2)


@pytest.mark.parametrize("stain", [False, True], ids=["plain", "stain"])
def test_classifier_replicas_match_one_device_and_jax(two_class, stain):
    """ClassifierEngine on two CPU replicas: 8 patches, 7 valid (the padded
    row dropped), within 1e-6 of one device, stain matrices on both
    replicas; without stains within 2e-4 of the JAX engine on its 8 devices."""
    x = np.random.default_rng(1).integers(0, 256, size=(8, 96, 96, 3), dtype=np.uint8)
    stains = {}
    if stain:
        w = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]], np.float32)
        stains = dict(w_est=w, w_def=w[::-1].copy())
    handle = load_local_model(*two_class)
    one = ClassifierEngine(handle, device="cpu", **stains).run_batch(x, 7)
    engine = ClassifierEngine(handle, devices=["cpu", "cpu"], **stains)
    assert engine.n_devices == 2 and engine.pad_batch(7) == 8 and len(engine.models) == 2
    assert engine.models[0] is not engine.models[1]
    blocks = engine.put(x)
    assert [tuple(b.shape) for b in blocks] == [(4, 96, 96, 3)] * 2
    got = engine.dispatch(blocks).numpy()[:7]
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, one, atol=1e-6)
    if not stain:
        jax_engine = JaxEngine(jax_load_local(*two_class))
        assert jax_engine.n_devices == 8
        np.testing.assert_allclose(got, jax_engine.run_batch(x, 7), atol=2e-4)
    with pytest.raises(ValueError, match="does not split"):
        engine.put(x[:7])


@pytest.fixture(scope="module")
def jax_cell_model(tmp_path_factory):
    """One JAX-authored CellViT-256 checkpoint (flax init, seed 0), 64 px."""
    return jax_make_random("cellvit-256", 6, tmp_path_factory.mktemp("cellvit256"),
                           patch_size_pixels=64)


def test_cell_engine_replicas_match_one_device_and_jax(jax_cell_model):
    """CellEngine on two CPU replicas, 8 patches (7 valid): bit for bit one
    device's maps of the same two row blocks, and within 1e-5 of one
    device's batch of 8 (the CPU's matmuls block differently at 4 and 8
    rows: 2.5e-6 on logits of about 1); within the cell path's parity bar
    of the JAX CellEngine on its 8 devices."""
    cfg, weights = jax_cell_model
    x = np.random.default_rng(2).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    handle = load_local_model(cfg, weights)
    one_engine = CellEngine(handle, device="cpu")
    one = one_engine.run_batch(x)
    halves = [one_engine.run_batch(x[:4]), one_engine.run_batch(x[4:])]
    engine = CellEngine(handle, devices=["cpu", "cpu"])
    assert engine.n_devices == 2 and engine.pad_batch(7) == 8
    got = engine.run_batch(x)
    jax_engine = JaxCellEngine(jax_load_local(cfg, weights))
    assert jax_engine.n_devices == 8
    want = jax_engine.run_batch(x)
    for key in MAPS:
        assert got[key].shape == one[key].shape, key
        torch.testing.assert_close(got[key], torch.cat([h[key] for h in halves]), rtol=0,
                                   atol=0, msg=key)
        np.testing.assert_allclose(got[key][:7].numpy(), one[key][:7].numpy(), atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(got[key][:7].numpy(), np.asarray(want[key])[:7],
                                   atol=1e-3, rtol=1e-4, err_msg=key)


def _cells(n, seed, step=10.0):
    """A model-output table's cells (px) on a jittered grid, three classes."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(n) * step, np.arange(n) * step)
    cx = xs.ravel() + rng.uniform(-2, 2, n * n)
    cy = ys.ravel() + rng.uniform(-2, 2, n * n)
    p = rng.dirichlet(np.ones(3), n * n)
    return pd.DataFrame({"minx": np.round(cx - 4, 2), "miny": np.round(cy - 4, 2),
                         "width": 8, "height": 8, "prob_tumor": p[:, 0],
                         "prob_immune": p[:, 1], "prob_other": p[:, 2]})


def test_dgi_over_eight_devices_matches_jax_mesh(monkeypatch):
    """train_dgi_multi over 3 graphs: the port on ["cpu"] * 8 (the batch
    padded by repetition to 8) against the JAX package on its 8-device mesh,
    from the same flax init, 20 epochs: weights within 1e-4 relative,
    embeddings within 1e-4. On one device nothing is padded, so the graphs
    weigh alike (not 3:3:2) and the weights differ."""
    slides = [prepare_slide_graph(_cells(n, seed), mpp_um_per_px=0.25, max_edge_len_um=4.0)
              for n, seed in ((12, 0), (10, 1), (11, 2))]
    scaler = stats.StandardScaler().fit(np.vstack([s["X"] for s in slides]))
    for s in slides:
        s["X_normalized"] = scaler.transform(s["X"]).astype(np.float32)
    assert len(jax.local_devices()) == 8
    jax_params, want_z = jax_train(slides, hidden=16, out_dim=8, epochs=20)
    g = jax_gnn.pad_graph(slides[0]["X_normalized"], slides[0]["edge_index"], 200, 1600)
    init = jax_gnn.DGI(hidden=16, out_dim=8).init(
        jax.random.PRNGKey(0), g.x, g.x, g.edges, g.edge_mask, g.node_mask)["params"]
    state = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, init))

    class FlaxInitDGI(gnn.DGI):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.load_state_dict(state, strict=True)

    monkeypatch.setattr(gnn, "DGI", FlaxInitDGI)
    got_state, got_z = train_dgi_multi(slides, hidden=16, out_dim=8, epochs=20,
                                       devices=["cpu"] * 8)
    want_state = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_params))
    for name, value in got_state.items():
        want = want_state[name].numpy()
        np.testing.assert_allclose(value.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
        assert not np.array_equal(value.numpy(), state[name].numpy()), name  # it trained
    for a, b in zip(got_z, want_z):
        np.testing.assert_allclose(a, b, atol=1e-4)
    # one device, no padding: another weighting of the graphs, other weights
    one_state, _ = train_dgi_multi(slides, hidden=16, out_dim=8, epochs=20, device="cpu")
    assert any(not torch.allclose(one_state[k], got_state[k], rtol=1e-4) for k in got_state)


def test_shard_slides_round_robin(monkeypatch):
    monkeypatch.setattr(multihost, "process_info", lambda: (1, 3))
    assert multihost.shard_slides_for_host(list(range(10))) == [1, 4, 7]
    # single process: identity
    monkeypatch.setattr(multihost, "process_info", lambda: (0, 1))
    assert multihost.shard_slides_for_host(list(range(3))) == [0, 1, 2]
    # union over hosts covers every slide exactly once
    shards = []
    for idx in range(3):
        monkeypatch.setattr(multihost, "process_info", lambda idx=idx: (idx, 3))
        shards += multihost.shard_slides_for_host(list(range(10)))
    assert sorted(shards) == list(range(10))


@pytest.mark.parametrize("missing", ["JAX_NUM_PROCESSES", "JAX_PROCESS_ID"])
def test_coordinator_needs_count_and_rank(monkeypatch, missing):
    """A coordinator without the process count or rank is a usage error
    naming both variables; outside a group the process is (0, 1)."""
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.delenv(missing)
    with pytest.raises(multihost.MultiHostUsageError, match="JAX_NUM_PROCESSES.*JAX_PROCESS_ID"):
        multihost.maybe_initialize_distributed()
    assert multihost.process_info() == (0, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_infer(i, n, port, results, cfg, weights, wsi_dir):
    """One process of a multi-host `infer` run of the port's CLI on the CPU."""
    env = {k: v for k, v in os.environ.items() if k not in _ENV}
    env.update(WSINFER_FORCE_CPU="1", JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(i),
               PYTHONPATH=os.pathsep.join([os.getcwd(), env.get("PYTHONPATH", "")]))
    code = (
        "from click.testing import CliRunner\n"
        "from wsinsight_tpu_torch.cli.cli import cli\n"
        "from wsinsight_tpu_torch.parallel.multihost import process_info\n"
        f"res = CliRunner().invoke(cli, ['infer', '-i', {str(wsi_dir)!r}, "
        f"'-o', {str(results)!r}, '--config', {str(cfg)!r}, "
        f"'--model-path', {str(weights)!r}, '-b', '8'], catch_exceptions=False)\n"
        "assert res.exit_code == 0, res.output\n"
        "print('PROC', *process_info(), 'OK')\n"
    )
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_two_process_infer_equals_one(tmp_path, monkeypatch):
    """Two processes of the port's `infer` under one coordinator share one
    results directory: each slide is classified once, by its round-robin
    process, and the CSVs equal a single process's exactly."""
    import shutil

    from wsinsight_tpu_torch.cli.cli import cli
    from wsinsight_tpu_torch.wsi.tiff import write_pyramidal_tiff
    from wsinsight_tpu_torch.zoo import make_random_local_model

    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    wsi_dir = tmp_path / "slides"
    wsi_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in ("s_a", "s_b", "s_c", "s_d"):
        img = np.full((384, 384, 3), 140, np.uint8)
        img += rng.integers(0, 40, size=img.shape, dtype=np.uint8)
        write_pyramidal_tiff(str(wsi_dir / f"{name}.tif"), img, tile=(128, 128),
                             compression="deflate", mpp=0.25)
    cfg, weights = make_random_local_model("resnet34", 2, tmp_path, seed=3,
                                           class_names=["Other", "Tumor"],
                                           patch_size_pixels=128, resize_size=64)
    results = tmp_path / "results"
    args = ["-i", str(wsi_dir), "-o", str(results), "--config", str(cfg),
            "--model-path", str(weights)]
    res = CliRunner().invoke(cli, ["patch", *args], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    results_mh = tmp_path / "results_mh"
    shutil.copytree(results, results_mh)
    res = CliRunner().invoke(cli, ["infer", *args, "-b", "8"], catch_exceptions=False)
    assert res.exit_code == 0, res.output

    port = _free_port()
    procs = [_launch_infer(i, 2, port, results_mh, cfg, weights, wsi_dir) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"stdout:{out[-1500:]} stderr:{err[-1500:]}"
        outs.append(out)
    assert "PROC 0 2 OK" in outs[0] and "PROC 1 2 OK" in outs[1]
    # each process classified its own two slides (the others' CSVs did not
    # exist when it started, so a second writer would have logged them)
    assert [o.count("skipping") for o in outs] == [0, 0]

    ref_dir, mh_dir = results / "model-outputs-csv", results_mh / "model-outputs-csv"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in mh_dir.iterdir()) == names and len(names) == 4
    for name in names:
        assert (mh_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
