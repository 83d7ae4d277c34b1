"""The PyTorch port's CLI (``python -m hnsw_nsg_tpu_torch.cli``) on the
CPU (``--device cpu``): tests/test_cli.py's eight cases at their sizes,
then the artifacts across the two packages, ``utils/metrics.py`` and
``utils/native.py``.

Every artifact the port writes loads in the JAX package's readers, and
the JAX package's writers' files load in the port. Files compared byte
for byte, where both packages run the same computation: ``convert``'s
.bin, .tsv and int8 .bin (and the scale it prints), ``calculate-recall``'s
printed line, ``build-knn --method exact`` on integer-valued rows, and
every writer of ``utils/io.py``; the native reader and writer against
numpy's on fvecs, ivecs and bvecs. Index files (.npz) are compared array
by array: a zip member carries the time it was written."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu import cli as jcli  # noqa: E402
from hnsw_nsg_tpu.models.hnsw import HNSWIndex as JHNSW  # noqa: E402
from hnsw_nsg_tpu.models.hybrid import HybridHNSWNSG as JHybrid  # noqa: E402
from hnsw_nsg_tpu.utils import io as jio  # noqa: E402
from hnsw_nsg_tpu.utils import metrics as jmetrics  # noqa: E402
from hnsw_nsg_tpu_torch.cli import main  # noqa: E402
from hnsw_nsg_tpu_torch.models.hnsw import HNSWIndex  # noqa: E402
from hnsw_nsg_tpu_torch.utils import io, metrics, native  # noqa: E402

CPU = ["--device", "cpu"]


def run(argv, capsys=None):
    main(argv + CPU)
    return capsys.readouterr().out if capsys is not None else None


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """tests/test_cli.py's data: 1200 x 12 around 8 centres, 16 queries,
    their exact top-10."""
    d = tmp_path_factory.mktemp("torch_cliwork")
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((8, 12)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 8, 1200)]
         + rng.standard_normal((1200, 12))).astype(np.float32)
    q = (centers[rng.integers(0, 8, 16)]
         + rng.standard_normal((16, 12))).astype(np.float32)
    io.write_fvecs(str(d / "base.fvecs"), x)
    io.write_fvecs(str(d / "query.fvecs"), q)
    full = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.argsort(full, axis=1)[:, :10].astype(np.int32)
    io.write_gt(str(d / "gt.ivecs"), gt)
    return d


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def artifacts(workdir):
    """build-clusters then build-nsg, as test_full_cluster_pipeline runs
    them; shared by the search cases."""
    prefix = str(workdir / "artifacts")
    main(["build-clusters", str(workdir / "base.fvecs"),
          "4", "2", "12", "20", "5", "6", "8", prefix,
          "--kmeans-iters", "8"] + CPU)
    main(["build-nsg", prefix, "16", "10", "60"] + CPU)
    return prefix


def test_full_cluster_pipeline(workdir, artifacts, capsys):
    prefix = artifacts
    assert os.path.exists(os.path.join(prefix, "centroids.fvecs"))
    assert os.path.exists(os.path.join(prefix, "mapping", "mapping_0"))
    assert os.path.exists(os.path.join(prefix, "nsg_graph", "nsg_0.nsg"))
    capsys.readouterr()
    out = _last_json(run(["search-clusters", prefix,
                          str(workdir / "query.fvecs"),
                          "--gt", str(workdir / "gt.ivecs"), "--k", "10",
                          "--nprobe", "3", "--local", "nsg"], capsys))
    assert out["recall"] > 0.8, out
    # the JAX package's readers take every artifact, with the same values
    reps = jio.read_centroids(os.path.join(prefix, "centroids.fvecs"))
    assert reps.shape == (4, 3, 12)
    np.testing.assert_array_equal(
        reps, io.read_centroids(os.path.join(prefix, "centroids.fvecs")))
    sizes = 0
    for ci in range(4):
        m = jio.read_mapping(os.path.join(prefix, "mapping", f"mapping_{ci}"))
        xs = jio.read_fvecs(os.path.join(prefix, "cluster_data",
                                         f"cluster_{ci}.fvecs"))
        g = jio.read_knn_graph(os.path.join(prefix, "nndescent",
                                            f"nndescent_{ci}.graph"))
        adj, ep, _ = jio.read_nsg(os.path.join(prefix, "nsg_graph",
                                               f"nsg_{ci}.nsg"))
        assert len(m) == len(xs) == len(g) == len(adj) and 0 <= ep < len(m)
        assert g.max() < len(m) and adj.max() < len(m)
        sizes += len(m)
    assert sizes == 1200


def test_search_clusters_ablation_axes(workdir, artifacts, capsys):
    """router x local x rank_by (the experiment_feature ablation programs:
    cluster_hnsw_hnsw_search.cpp, sort_by_min_dist.cpp)."""
    for extra in (
        ["--local", "hnsw"],
        ["--router", "hnsw", "--local", "flat"],
        ["--rank-by", "min_dist", "--local", "flat"],
    ):
        capsys.readouterr()
        out = _last_json(run(["search-clusters", artifacts,
                              str(workdir / "query.fvecs"),
                              "--gt", str(workdir / "gt.ivecs"), "--k", "10",
                              "--nprobe", "3"] + extra, capsys))
        assert out["recall"] > 0.7, (extra, out)


def _sweep(out):
    return [l.split("\t") for l in out.strip().splitlines()[1:]]


def test_hnsw_cli(workdir, capsys, tmp_path):
    out_idx = str(tmp_path / "h.npz")
    run(["build-hnsw", str(workdir / "base.fvecs"), out_idx,
         "--M", "12", "--efc", "60", "--batch", "600"])
    capsys.readouterr()
    search = ["search-hnsw", None, str(workdir / "query.fvecs"),
              "--gt", str(workdir / "gt.ivecs"), "--k", "10",
              "--efs", "20,80"]
    search[1] = out_idx
    rows = _sweep(run(search, capsys))
    assert float(rows[-1][1]) > 0.9  # recall at ef=80
    # the JAX package loads the port's file; the port its re-saved copy
    jidx = JHNSW.load(out_idx)
    tidx = HNSWIndex.load(out_idx, device="cpu")
    assert jidx.n == tidx.n == 1200
    np.testing.assert_array_equal(np.asarray(jidx.adj0[:1200]),
                                  tidx.adj0[:1200].numpy())
    resaved = str(tmp_path / "h_jax.npz")
    jidx.save(resaved)
    a, b = np.load(out_idx), np.load(resaved)
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        if f == "meta":    # meta[1], the arena's capacity: the JAX package
            keep = [0, 2, 3, 4, 5, 6]    # rounds it up to a power of two
            np.testing.assert_array_equal(a[f][keep], b[f][keep])
        else:
            np.testing.assert_array_equal(a[f], b[f])
    search[1] = resaved
    assert _sweep(run(search, capsys))[-1][1] == rows[-1][1]


def _bytes_equal(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_converters(workdir, tmp_path, capsys):
    """The port's files equal the JAX CLI's byte for byte."""
    src = str(workdir / "base.fvecs")
    outs = []
    for tag, cli in (("t", main), ("j", jcli.main)):
        binp, tsvp, i8 = (str(tmp_path / f"{tag}{n}")
                          for n in ("a.bin", "a.tsv", "b.bin"))
        extra = CPU if tag == "t" else []
        cli(["convert", src, binp] + extra)
        cli(["convert", binp, tsvp] + extra)
        capsys.readouterr()
        cli(["convert", src, i8, "--int8"] + extra)
        outs.append((binp, tsvp, i8, capsys.readouterr().out))
    (tb, tt, ti, tout), (jb, jt, ji, jout) = outs
    for a, b in ((tb, jb), (tt, jt), (ti, ji)):
        _bytes_equal(a, b)
    assert tout.replace(str(tmp_path / "t"), "") == jout.replace(
        str(tmp_path / "j"), "")
    x = io.read_bin(tb)
    np.testing.assert_allclose(x, io.read_fvecs(src), rtol=1e-6)
    np.testing.assert_allclose(io.read_tsv(tt), x, atol=1e-4)
    v = io.read_bin(ti, np.int8)
    assert v.dtype == np.int8 and v.shape == x.shape


def test_calculate_recall(workdir, tmp_path, capsys):
    gt = io.read_gt(str(workdir / "gt.ivecs"))
    res = str(tmp_path / "res.ivecs")
    io.write_ivecs(res, gt[:, :10].astype(np.int32))
    capsys.readouterr()
    argv = ["calculate-recall", res, str(workdir / "gt.ivecs"), "--k", "10"]
    out = run(argv, capsys)
    assert json.loads(out) == {"recall": 1.0}
    jcli.main(argv)
    assert capsys.readouterr().out == out          # the same line
    # a partial result: the JAX package averages in f32, the port in f64
    part = gt[:, :10].astype(np.int32).copy()
    part[::3, 5:] = -7
    io.write_ivecs(res, part)
    got = json.loads(run(argv, capsys))["recall"]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)["recall"]
    assert abs(got - want) < 1e-6 and got == 13 / 16


def test_hybrid_cli(workdir, capsys, tmp_path):
    """build-hybrid / search-hybrid (test_hnsw_nsg_search.cpp:369-395: M/efC
    and NSG L/R/C, then a search_L sweep), plain and on int8 records
    (--accel)."""
    prefix = str(tmp_path / "hyb")
    run(["build-hybrid", str(workdir / "base.fvecs"), prefix,
         "--M", "8", "--efc", "40", "--L", "20", "--R", "12", "--C", "60"])
    assert os.path.exists(prefix + "_hnsw.npz")
    assert os.path.exists(prefix + "_nsg.npz")
    capsys.readouterr()
    sweeps = []
    for extra in ([], ["--accel"]):
        result = str(tmp_path / "hyb_sweep.json")
        out = run(["search-hybrid", prefix, str(workdir / "query.fvecs"),
                   "--gt", str(workdir / "gt.ivecs"), "--k", "10",
                   "--search-ls", "20,60", "--result", result] + extra,
                  capsys)
        assert "search_L" in out
        sweeps.append(json.load(open(result)))
        assert sweeps[-1][-1]["recall"] >= 0.85, (extra, sweeps[-1])
    # the JAX package loads both files; the port its re-saved copy
    jhyb = JHybrid.load(prefix)
    assert jhyb.hnsw.n == 1200 and jhyb.nsg is not None
    np.testing.assert_array_equal(np.asarray(jhyb.nsg.adj),
                                  np.load(prefix + "_nsg.npz")["adj"])
    jprefix = str(tmp_path / "hyb_jax")
    jhyb.save(jprefix)
    out = run(["search-hybrid", jprefix, str(workdir / "query.fvecs"),
               "--gt", str(workdir / "gt.ivecs"), "--k", "10",
               "--search-ls", "60"], capsys)
    assert float(_sweep(out)[-1][1]) == pytest.approx(sweeps[0][-1]["recall"],
                                                      abs=1e-4)


def test_build_knn_cli(workdir, tmp_path, capsys):
    """build-knn (efanna test_nndescent.cpp's argv): the cluster-join and
    exact methods write readable .graph files whose edges overlap the exact
    graph; on integer-valued rows the exact method's file equals the JAX
    CLI's byte for byte."""
    out_ivf = str(tmp_path / "knn_ivf.graph")
    out_exact = str(tmp_path / "knn_exact.graph")
    run(["build-knn", str(workdir / "base.fvecs"), out_exact, "10",
         "--method", "exact"])
    run(["build-knn", str(workdir / "base.fvecs"), out_ivf, "10",
         "--method", "ivf", "--n-clusters", "6", "--probes", "4"])
    capsys.readouterr()
    g_ex = jio.read_knn_graph(out_exact)
    g_iv = jio.read_knn_graph(out_ivf)
    assert g_ex.shape == g_iv.shape == (1200, 10)
    ov = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(g_iv, g_ex)])
    assert ov >= 0.85, ov
    xi = np.round(2 * io.read_fvecs(str(workdir / "base.fvecs")))
    ipath = str(tmp_path / "int.fvecs")
    io.write_fvecs(ipath, xi)
    t_out, j_out = str(tmp_path / "t.graph"), str(tmp_path / "j.graph")
    run(["build-knn", ipath, t_out, "10", "--method", "exact"])
    jcli.main(["build-knn", ipath, j_out, "10", "--method", "exact"])
    _bytes_equal(t_out, j_out)


def test_build_resumability(workdir, capsys):
    """Re-running build-clusters / build-nsg skips existing per-cluster
    artifacts (sift_1m.cpp:308-341's exists_test): a crashed build resumes
    where it stopped."""
    prefix = str(workdir / "artifacts_resume")
    argv = ["build-clusters", str(workdir / "base.fvecs"),
            "4", "2", "12", "20", "5", "6", "8", prefix,
            "--kmeans-iters", "8"]
    run(argv)
    capsys.readouterr()
    os.remove(os.path.join(prefix, "nndescent", "nndescent_1.graph"))
    assert run(argv, capsys).count("exists, skipped") == 3
    assert os.path.exists(
        os.path.join(prefix, "nndescent", "nndescent_1.graph"))
    run(["build-nsg", prefix, "16", "10", "60"])
    capsys.readouterr()
    assert run(["build-nsg", prefix, "16", "10", "60"],
               capsys).count("exists, skipped") == 4


def test_cli_without_a_card_and_device_raises(workdir, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["build-knn", str(workdir / "base.fvecs"),
              str(tmp_path / "g.graph"), "10", "--method", "exact"])


# -- the io writers, both packages --------------------------------------------

def test_io_writers_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(3)
    f = rng.standard_normal((7, 5)).astype(np.float32)
    adj = rng.integers(-1, 50, (9, 6)).astype(np.int32)
    cases = [
        ("write_fvecs", (f,)), ("write_ivecs", (adj,)),
        ("write_bvecs", (rng.integers(0, 256, (4, 9)).astype(np.uint8),)),
        ("write_gt", (adj.clip(0),)), ("write_nsg", (adj, 3)),
        ("write_knn_graph", (adj,)),
        ("write_centroids", (rng.standard_normal((3, 2, 4)),)),
        ("write_mapping", (np.arange(11),)), ("write_bin", (f,)),
        ("write_tsv", (f,)),
    ]
    for name, args in cases:
        a, b = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        getattr(io, name)(a, *args)
        getattr(jio, name)(b, *args)
        _bytes_equal(a, b)


# -- utils/metrics.py ---------------------------------------------------------

def test_stopwatch_and_timed():
    w = metrics.StopW()
    assert 0.0 <= w.seconds() < 5 and w.micros() >= 0
    w.reset()
    x = torch.arange(10.0)
    with metrics.timed(sync={"a": [x, (x + 1,)]}) as t:
        y = x * 2
    assert t.elapsed >= 0 and float(y.sum()) == 90.0
    with metrics.timed() as t2:
        pass
    assert t2.elapsed >= 0


def test_device_memory_stats_on_the_cpu_is_all_unknown():
    want = jmetrics.device_memory_stats()
    assert want == {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                    "bytes_limit": -1}
    assert metrics.device_memory_stats("cpu") == want
    if not torch.cuda.is_available():
        assert metrics.device_memory_stats() == want


def test_trace_writes_a_profile(tmp_path):
    with metrics.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert os.listdir(tmp_path / "tr")


# -- utils/native.py ----------------------------------------------------------

@pytest.fixture
def native_build(tmp_path, monkeypatch):
    """The native library built into a temporary ``_build/``."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ on this host: the native reader cannot build")
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available(), "the native library did not build"
    assert native.library_path().startswith(str(tmp_path / "_build"))
    return tmp_path


@pytest.mark.parametrize("kind", ["fvecs", "ivecs", "bvecs"])
def test_native_reader_and_writer_match_numpy(native_build, kind):
    rng = np.random.default_rng(5)
    arr = {"fvecs": rng.standard_normal((33, 7)).astype(np.float32),
           "ivecs": rng.integers(-9, 9, (33, 7)).astype(np.int32),
           "bvecs": rng.integers(0, 256, (33, 7)).astype(np.uint8)}[kind]
    size = arr.dtype.itemsize
    numpy_file = str(native_build / f"np.{kind}")
    native_file = str(native_build / f"nat.{kind}")
    getattr(io, f"write_{kind}")(numpy_file, arr)
    assert native.write_xvecs(native_file, arr, size)
    _bytes_equal(native_file, numpy_file)
    got = native.read_xvecs(numpy_file, arr.dtype, size)
    assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
    assert getattr(io, f"read_{kind}")(native_file).tobytes() == arr.tobytes()
    # a malformed file: the native path declines, numpy gives the error
    with open(native_file, "ab") as f:
        f.write(b"\0")
    assert native.read_xvecs(native_file, arr.dtype, size) is None
    with pytest.raises(ValueError, match="not a multiple"):
        getattr(io, f"read_{kind}")(native_file)
