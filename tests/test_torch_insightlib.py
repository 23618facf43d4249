"""The port's analytics (H-Plot, CME with DGI training, native Leiden, the
scikit-learn stand-ins) and their CLI against the JAX package.

Same CSVs, graphs and seeds through both packages. Host stages (H-Plot, the
graph build, the Voronoi merge, Leiden) are held identical; the DGI, on the
same flax-initialised params, per step within 1e-5 relative (loss and
gradients) and within 1e-4 after 10 Adam steps; the port's stand-ins for
scikit-learn to scikit-learn's own output. The port runs on the CPU."""

import filecmp
import json

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from wsinsight_tpu.insightlib import gnn as jax_gnn  # noqa: E402
from wsinsight_tpu.insightlib.cme import prepare_slide_graph as jax_prepare  # noqa: E402
from wsinsight_tpu.insightlib.cme import train_dgi_multi as jax_train  # noqa: E402
from wsinsight_tpu_torch.insightlib import gnn, stats  # noqa: E402
from wsinsight_tpu_torch.insightlib.cme import prepare_slide_graph, train_dgi_multi  # noqa: E402
from wsinsight_tpu_torch.models.convert import flax_params_to_state_dict  # noqa: E402


def _grid_cells(n=20, step=10.0, tumor_radius=55.0, seed=0):
    """A model-output CSV's cells (px): a tumour disk, an immune ring, other
    cells outside, on a jittered grid with seeded probabilities."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(n) * step, np.arange(n) * step)
    cx = xs.ravel() + rng.uniform(-2, 2, n * n)
    cy = ys.ravel() + rng.uniform(-2, 2, n * n)
    center = (n - 1) * step / 2
    d = np.hypot(cx - center, cy - center)
    is_tumor = d < tumor_radius
    is_immune = (d >= tumor_radius) & (d < tumor_radius + 40)
    p_t = np.where(is_tumor, 0.8, 0.05) + rng.uniform(0, 0.1, n * n)
    p_i = np.where(is_immune, 0.8, 0.05) + rng.uniform(0, 0.1, n * n)
    return pd.DataFrame({
        "minx": np.round(cx - 4, 2), "miny": np.round(cy - 4, 2), "width": 8, "height": 8,
        "prob_tumor": p_t, "prob_immune": p_i, "prob_other": 1.0 - np.maximum(p_t, p_i),
    })


def _results(tmp_path, name, df):
    results = tmp_path / name
    (results / "model-outputs-csv").mkdir(parents=True)
    df.to_csv(results / "model-outputs-csv" / "purple.csv", index=False)
    return results


def _same_tree(a, b):
    """Every file under a (but the caches) is under b with the same bytes."""
    files = sorted(p.relative_to(a) for p in a.rglob("*")
                   if p.is_file() and p.suffix != ".joblib")
    assert files
    for rel in files:
        assert (b / rel).exists(), rel
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel
    return files


def test_hplot_tables_match_jax(purple_slide, tmp_path):
    """hplot_generation of both packages on the same CSV: the per-slide cells,
    layers and metrics and both cohort tables byte-identical."""
    from wsinsight_tpu.insightlib import hplot_generation as jax_hplot
    from wsinsight_tpu.uri_path import URIPath as JaxURIPath
    from wsinsight_tpu_torch.insightlib import hplot_generation
    from wsinsight_tpu_torch.uri_path import URIPath

    df = _grid_cells()
    kw = dict(base_type_list=["tumor"], target_type_list=["immune"],
              max_neighbor_distance_um=4.0, hplot_range_min=-2, hplot_range_max=3,
              num_workers=1)
    jr, pr = _results(tmp_path, "jax", df), _results(tmp_path, "port", df)
    assert jax_hplot(wsi_paths=[JaxURIPath(str(purple_slide))],
                     results_dir=JaxURIPath(str(jr)), **kw) == []
    assert hplot_generation(wsi_paths=[URIPath(str(purple_slide))],
                            results_dir=URIPath(str(pr)), **kw) == []
    files = _same_tree(jr, pr)
    assert {str(f) for f in files} >= {"hplot-outputs.csv", "hmetrics-outputs.csv",
                                        "hplot-outputs-csv/hmetrics/purple.json"}
    assert json.loads((pr / "hplot-outputs-csv/hmetrics/purple.json").read_text())["valid"] in (
        True, False)


def test_voronoi_merge_matches_jax():
    """The capped-Voronoi region merge of both packages on the same labelled
    cells and Delaunay edges: the same region table."""
    from wsinsight_tpu.insightlib.helpers import delaunay_triangulation
    from wsinsight_tpu.insightlib.voronoi import merge_same_label_by_shared_edges_iterative as jm
    from wsinsight_tpu_torch.insightlib.voronoi import merge_same_label_by_shared_edges_iterative

    df = _grid_cells(n=12, seed=1)
    labels = np.random.default_rng(2).integers(0, 3, len(df))
    for k in range(3):
        df[f"cme_{k}"] = (labels == k).astype(np.float32)
    centers = np.stack([df.minx + 4, df.miny + 4], 1).astype(np.float32)
    edges = delaunay_triangulation(centers, 20.0)
    kw = dict(cme_clustering_k=3, mpp=0.25, max_radius_um=3.0,
              kept_idx=np.arange(len(df)))
    want = jm(df.copy(), edges.copy(), **kw)
    got = merge_same_label_by_shared_edges_iterative(df.copy(), edges.copy(), **kw)
    assert len(want) > 3
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def _planted_graph():
    """tests/test_insightlib.py's planted partition: 4 blocks of 80 nodes,
    dense inside, 6 edges across."""
    rng = np.random.default_rng(3)
    blocks, bs = 4, 80
    pairs = []
    for b in range(blocks):
        base = b * bs
        for i in range(bs):
            pairs.append((base + i, base + (i + 1) % bs))
            for j in rng.integers(0, bs, size=10):
                if int(j) != i:
                    pairs.append((base + i, base + int(j)))
    for _ in range(6):
        a, b2 = rng.integers(0, blocks, size=2)
        pairs.append((int(a) * bs + int(rng.integers(bs)), int(b2) * bs + int(rng.integers(bs))))
    return np.array(pairs, np.int64), blocks * bs


@pytest.mark.parametrize("resolution,seed", [(1.0, 0), (4.0, 3)])
def test_leiden_native_matches_jax(resolution, seed):
    from wsinsight_tpu.native import leiden_native as jax_leiden
    from wsinsight_tpu_torch.native import leiden_native

    edges, n = _planted_graph()
    want_labels, want_mod = jax_leiden(edges, n, resolution, seed)
    labels, mod = leiden_native(edges, n, resolution, seed)
    np.testing.assert_array_equal(labels, want_labels)
    assert abs(mod - want_mod) <= 1e-9
    if resolution == 1.0:
        assert len(np.unique(labels)) == 4


@pytest.fixture(scope="module")
def dgi_setup(tmp_path_factory):
    """One slide graph built by both packages from the same cells, its
    z-scored features, and flax DGI params (the JAX package's init)."""
    df = _grid_cells(n=14, seed=4)
    want = jax_prepare(df, mpp_um_per_px=0.25, max_edge_len_um=4.0)
    got = prepare_slide_graph(df, mpp_um_per_px=0.25, max_edge_len_um=4.0)
    for key in ("X", "edge_index", "kept_idx"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    pd.testing.assert_frame_equal(got["edges_df"], want["edges_df"])
    x = stats.StandardScaler().fit(got["X"]).transform(got["X"])
    slide = dict(got, X_normalized=x)
    g = jax_gnn.pad_graph(x, got["edge_index"], 200, 1600)
    model = jax_gnn.DGI(hidden=16, out_dim=8)
    params = model.init(jax.random.PRNGKey(0), g.x, g.x, g.edges, g.edge_mask, g.node_mask)
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    return slide, g, model, params


def _torch_batch(g, perm):
    x = torch.from_numpy(g.x)[None]
    return (x, x[:, perm], torch.from_numpy(g.edges.astype(np.int64))[None],
            torch.from_numpy(g.edge_mask)[None], torch.from_numpy(g.node_mask)[None],
            torch.from_numpy(g.loss_mask)[None])


def test_dgi_steps_match_jax(dgi_setup):
    """From the same flax-initialised params, each of 10 Adam steps: loss and
    gradients within 1e-5 relative; the params after 10 steps within 1e-4;
    embed_full_graph of the same params identical."""
    slide, g, jax_model, params = dgi_setup
    opt = optax.adam(1e-3)
    jax_step = jax_gnn.make_dgi_train_step(jax_model, opt)
    opt_state = opt.init(params)

    def jax_loss(p, xc):
        return jax_model.apply({"params": p}, g.x, xc, g.edges, g.edge_mask, g.node_mask,
                               g.loss_mask)

    model = gnn.DGI(g.x.shape[1], hidden=16, out_dim=8)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    torch_opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = gnn.make_dgi_train_step(model, torch_opt)
    rng = np.random.default_rng(5)
    jp = params
    n_real = int(g.node_mask.sum())
    for _ in range(10):
        perm = np.arange(len(g.x))
        perm[:n_real] = rng.permutation(n_real)
        xc = g.x[perm]
        want_loss, want_grads = jax.value_and_grad(jax_loss)(jp, xc)
        loss = step(*_torch_batch(g, perm))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        want_g = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=1e-5,
                                       atol=1e-5 * float(want_g[name].abs().max()), err_msg=name)
        jp, opt_state, _ = jax_step(jp, opt_state, g.x[None], xc[None], g.edges[None],
                                    g.edge_mask[None], g.node_mask[None], g.loss_mask[None])
    want_sd = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_sd[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    host = jax.tree_util.tree_map(np.asarray, jp)
    want_z = jax_gnn.embed_full_graph(host, slide["X_normalized"], slide["edge_index"])
    got_z = gnn.embed_full_graph(flax_params_to_state_dict(host), slide["X_normalized"],
                                 slide["edge_index"])
    np.testing.assert_array_equal(got_z, want_z)


def test_dgi_training_matches_jax(dgi_setup, monkeypatch):
    """train_dgi_multi of both packages from the same initial params (the
    port's DGI given the flax init) and seed (the same corruption
    permutations), 20 epochs: embeddings within atol 1e-4 + rtol 1e-3."""
    slide, _, _, _ = dgi_setup
    _, want = jax_train([slide], hidden=16, out_dim=8, epochs=20)
    # the JAX package initialises from PRNGKey(seed) at these shapes
    g = jax_gnn.pad_graph(slide["X_normalized"], slide["edge_index"], 200, 1600)
    init = jax_gnn.DGI(hidden=16, out_dim=8).init(
        jax.random.PRNGKey(0), g.x, g.x, g.edges, g.edge_mask, g.node_mask)["params"]
    state = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, init))

    class FlaxInitDGI(gnn.DGI):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.load_state_dict(state, strict=True)

    monkeypatch.setattr(gnn, "DGI", FlaxInitDGI)
    _, got = train_dgi_multi([slide], hidden=16, out_dim=8, epochs=20, device="cpu")
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=1e-3)
    assert np.abs(want[0]).max() > 0.1


def test_cli_hplot_and_cme_write_jax_files(purple_slide, tmp_path, monkeypatch):
    """Both CLIs' `hplot` and `cme` on the same CSV write the same files,
    byte for byte. The port's `cme` is fed the JAX run's DGI embeddings
    (its own training starts from other seeded weights), so the graph
    build, z-score, Leiden sweep, per-cell CSV and Voronoi regions are
    held identical."""
    import joblib

    import wsinsight_tpu_torch.insightlib.cme as port_cme
    from wsinsight_tpu.cli.cli import cli as jax_cli
    from wsinsight_tpu_torch.cli.cli import cli

    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    df = _grid_cells(n=16, seed=6)
    jr, pr = _results(tmp_path, "jax", df), _results(tmp_path, "port", df)
    slides = str(purple_slide.parent)
    hplot = ["hplot", "-i", slides, "--hplot-base-types", "tumor", "--hplot-target-types",
             "immune", "--hplot-max-neighbor-distance", "4", "-n", "1"]
    cme = ["cme", "-i", slides, "--cme-epochs", "3", "--cme-max-edge-len-um", "4",
           "--cme-max-cell-radius-um", "3", "--cme-cellular", "--cme-annotation"]
    for args in (hplot, cme):
        res = CliRunner().invoke(jax_cli, [*args, "-o", str(jr)])
        assert res.exit_code == 0, res.output
    z_list = joblib.load(jr / "dgi-embeddings.joblib")
    monkeypatch.setattr(port_cme, "train_dgi_multi", lambda slides, **kw: (None, z_list))
    for args in (hplot, cme):
        res = CliRunner().invoke(cli, [*args, "-o", str(pr)])
        assert res.exit_code == 0, res.output
    files = {str(f) for f in _same_tree(jr, pr)}
    assert {"cme-outputs-csv/cells/purple.csv", "cme-outputs-csv/cmes/purple.csv",
            "hplot-outputs.csv"} <= files
    cells = pd.read_csv(pr / "cme-outputs-csv/cells/purple.csv")
    cme_cols = [c for c in cells.columns if c.startswith("cme_")]
    kept = cells[cme_cols].notna().all(axis=1)
    np.testing.assert_array_equal(cells.loc[kept, cme_cols].to_numpy().sum(1), 1.0)
    # the port's caches are plain pickles that joblib reads as well
    assert len(joblib.load(pr / "dgi-embeddings.joblib")) == 1


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, s, (n, 8)) for c, s, n in
                           ((0, 0.3, 150), (3, 0.5, 170), (-3, 0.4, 90))]).astype(np.float32)


def test_kneighbors_graph_matches_sklearn():
    from sklearn.neighbors import kneighbors_graph

    z = _blobs()
    z[7] = z[3]  # a duplicate point: scikit-learn's rule for dropping the query itself
    want = kneighbors_graph(z, 15, mode="connectivity", include_self=False)
    assert (stats.kneighbors_graph(z, 15) != want).nnz == 0


def test_nmi_and_silhouette_match_sklearn():
    from sklearn.metrics import normalized_mutual_info_score, silhouette_score

    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 4, 300), rng.integers(0, 6, 300)
    assert stats.normalized_mutual_info_score(a, b) == pytest.approx(
        normalized_mutual_info_score(a, b), abs=1e-12)
    assert stats.normalized_mutual_info_score(a, a) == pytest.approx(1.0)
    z = _blobs(2)
    labels = (z[:, 0] > 1).astype(int) + 2 * (z[:, 1] < -1)
    np.random.seed(3)
    want = silhouette_score(z, labels, sample_size=200)
    np.random.seed(3)
    assert stats.silhouette_score(z, labels, sample_size=200) == pytest.approx(want, abs=1e-6)


def test_standard_scaler_matches_sklearn():
    from sklearn.preprocessing import StandardScaler

    x = np.random.default_rng(4).normal(3, 2, (500, 12)).astype(np.float32)
    x[:, 3] = 5.0  # a constant feature: scale 1
    want = StandardScaler().fit(x)
    got = stats.StandardScaler().fit(x)
    np.testing.assert_array_equal(got.scale_, want.scale_)
    np.testing.assert_array_equal(got.transform(x), want.transform(x))


def test_pca_and_kmeans_match_sklearn():
    """PCA scores (full SVD, svd_flip's signs) within 1e-4 of the largest
    score of scikit-learn's (its float32 SVD against the port's float64 one);
    KMeans finds scikit-learn's partition of three blobs."""
    from sklearn.cluster import KMeans
    from sklearn.decomposition import PCA
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(5)
    f = rng.normal(0, 1, (60, 48)).astype(np.float32) @ rng.normal(0, 1, (48, 48)).astype(
        np.float32)
    want = PCA(n_components=10).fit_transform(f)
    got = stats.pca_fit_transform(f, 10)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    z = _blobs(6)
    want_km = KMeans(3, n_init="auto", random_state=0).fit_predict(z)
    assert adjusted_rand_score(want_km, stats.kmeans_labels(z, 3)) == 1.0


def test_cme_hoptimus_branch_writes_khop_features(purple_slide, tmp_path):
    """cme_generation with the foundation branch (a stub extractor over blank
    crops) and cellular outputs: the port writes the k-hop block's feature
    columns and the CMEs. The JAX package assigns the whole feature matrix,
    foundation block included, to the k-hop columns and raises there; its
    graph and features are the port's."""
    from wsinsight_tpu.insightlib import cme_generation as jax_cme
    from wsinsight_tpu.insightlib.foundation import stub_extractor as jax_stub
    from wsinsight_tpu.uri_path import URIPath as JaxURIPath
    from wsinsight_tpu_torch.insightlib import cme_generation
    from wsinsight_tpu_torch.insightlib.foundation import stub_extractor
    from wsinsight_tpu_torch.uri_path import URIPath

    df = _grid_cells(n=12, seed=7)
    jr, pr = _results(tmp_path, "jax", df), _results(tmp_path, "port", df)
    kw = dict(max_edge_len_um=4.0, epochs=2, use_hoptimus=True, cme_cellular=True,
              cme_clustering_k=0, cme_clustering_resolutions=[0.5, 1.0], pca_dim=8)
    with pytest.raises(ValueError, match="equal len"):
        jax_cme(wsi_paths=[JaxURIPath(str(purple_slide))], results_dir=JaxURIPath(str(jr)),
                feature_extractor=jax_stub(16), **kw)
    cme_generation(wsi_paths=[URIPath(str(purple_slide))], results_dir=URIPath(str(pr)),
                   feature_extractor=stub_extractor(16), device="cpu", **kw)
    cells = pd.read_csv(pr / "cme-outputs-csv/cells/purple.csv")
    feats = [c for c in cells.columns if c.startswith("feature_raw_k")]
    assert len(feats) == 3 * 3  # hops 0-2 x the three classes
    import joblib

    want = joblib.load(jr / "slide-graphs.joblib")["slides"][0]
    import pickle

    with open(pr / "slide-graphs.joblib", "rb") as fh:
        got = pickle.load(fh)["slides"][0]
    assert got["X"].shape == want["X"].shape == (len(want["kept_idx"]), 9 + 8)
    np.testing.assert_array_equal(got["X"][:, :9], want["X"][:, :9])
    # the foundation block: the port's float64 PCA against scikit-learn's float32 one
    np.testing.assert_allclose(got["X"][:, 9:], want["X"][:, 9:], rtol=1e-4,
                               atol=1e-4 * np.abs(want["X"][:, 9:]).max())
    kept = cells.loc[want["kept_idx"], feats].to_numpy(np.float32)
    np.testing.assert_array_equal(kept, want["X"][:, :9])


def _failing_extractor(images):
    raise RuntimeError("window_attention: the kernel did not launch")


@pytest.mark.parametrize("extractor,error", [
    (_failing_extractor, RuntimeError),  # the port's ViT or K2 failing on the card
    (None, ImportError),  # no converted weights and no timm: the default extractor
])
def test_cme_hoptimus_extractor_failure_raises(purple_slide, tmp_path, monkeypatch,
                                               extractor, error):
    """A failure of the foundation block raises out of cme_generation; it
    does not skip the slide. Only the host graph build is guarded."""
    import sys

    from wsinsight_tpu_torch.insightlib import cme_generation
    from wsinsight_tpu_torch.uri_path import URIPath

    monkeypatch.setenv("WSINFER_FORCE_CPU", "1")
    monkeypatch.delenv("WSINSIGHT_MODEL_DIR", raising=False)
    monkeypatch.setitem(sys.modules, "timm", None)  # `import timm` raises ImportError
    pr = _results(tmp_path, "port", _grid_cells(n=12, seed=7))
    with pytest.raises(error):
        cme_generation(wsi_paths=[URIPath(str(purple_slide))], results_dir=URIPath(str(pr)),
                       max_edge_len_um=4.0, epochs=2, use_hoptimus=True, cme_cellular=True,
                       feature_extractor=extractor, device="cpu")
    assert not (pr / "slide-graphs.joblib").exists()


@pytest.mark.parametrize("n,cap", [(3000, 1024), (600, 1024)])
def test_sample_subgraph_matches_jax(n, cap):
    """The halo-aware subgraph sampler draws the JAX package's subgraph from
    the same generator state: nodes, edges, masks and the generator after
    it (a graph above the node cap, with edges subsampled, and one below)."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 60 * np.sqrt(n), (n, 2)).astype(np.float32)
    from wsinsight_tpu.insightlib.helpers import delaunay_triangulation
    from wsinsight_tpu_torch.insightlib.cme import drop_isolated, to_edge_index

    ei, kept = drop_isolated(to_edge_index(delaunay_triangulation(pts, 200.0)), n)
    x = rng.standard_normal((len(kept), 6)).astype(np.float32)
    r_jax, r_port = np.random.default_rng(9), np.random.default_rng(9)
    want = jax_gnn.sample_subgraph(x, ei, cap, 2048, r_jax)
    got = gnn.sample_subgraph(x, ei, cap, 2048, r_port)
    for key in ("x", "edges", "node_mask", "edge_mask", "loss_mask"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert r_jax.integers(1 << 30) == r_port.integers(1 << 30)
