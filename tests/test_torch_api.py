"""The hnswlib-compatible API of the PyTorch port on the CPU: the cases
of tests/test_api.py that the ported part covers, the same calls through
both packages (labels equal, distances allclose 1e-5, saved files
byte-equal), pickle and LazyIndex. Range search, multivector documents
and slot replacement are in tests/test_torch_extensions.py."""

import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu import api as japi  # noqa: E402
from hnsw_nsg_tpu.ops.distance import normalize as j_normalize  # noqa: E402
from hnsw_nsg_tpu_torch import api as tapi  # noqa: E402
from hnsw_nsg_tpu_torch.api import BFIndex, Index, LazyIndex  # noqa: E402
from hnsw_nsg_tpu_torch.ops.distance import normalize  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(17)
    return rng.standard_normal((400, 16)).astype(np.float32)


def _index(small, space="l2", n=400, **kw):
    p = Index(space=space, dim=16, device="cpu")
    p.init_index(max_elements=500, **{"M": 8, "ef_construction": 40, **kw})
    p.add_items(small[:n])
    return p


class TestIndex:
    def test_basic_flow(self, small):
        p = Index(space="l2", dim=16, device="cpu")
        p.init_index(max_elements=500, M=8, ef_construction=48)
        p.set_ef(40)
        p.add_items(small)
        labels, dists = p.knn_query(small[:50], k=1)
        assert (labels[:, 0] == np.arange(50)).mean() > 0.95
        assert dists.shape == (50, 1) and labels.dtype == np.int64
        assert p._index.data.device.type == "cpu"
        assert p.get_current_count() == p.element_count == 400
        assert p.get_max_elements() == p.max_elements == 500

    def test_uninitialized_raises(self, small):
        p = Index(space="l2", dim=16, device="cpu")
        with pytest.raises(RuntimeError, match="init_index"):
            p.add_items(small)

    def test_bad_space(self):
        for cls in (Index, BFIndex, LazyIndex):
            with pytest.raises(ValueError, match="not available"):
                cls(space="hamming", dim=8)

    def test_wrong_dim(self, small):
        p = Index(space="l2", dim=16, device="cpu")
        p.init_index(100)
        with pytest.raises(ValueError, match="dimensionality"):
            p.add_items(np.zeros((3, 8), np.float32))

    def test_cosine_space(self, small):
        p = _index(small, "cosine", M=16, ef_construction=80)
        labels, dists = p.knn_query(small[:20] * 7.0, k=1, ef=40)
        assert (labels[:, 0] == np.arange(20)).mean() > 0.9
        assert np.abs(dists).max() < 1e-3

    def test_labels_persistence_roundtrip(self, small, tmp_path):
        p = Index(space="l2", dim=16, device="cpu")
        p.init_index(500, M=8, ef_construction=40)
        ids = np.arange(5000, 5400)
        p.add_items(small, ids)
        path = str(tmp_path / "idx.npz")
        p.save_index(path)
        q = Index(space="l2", dim=16, device="cpu")
        q.load_index(path)
        assert q.get_current_count() == 400
        l1, _ = p.knn_query(small[:10], k=3, ef=30)
        l2, _ = q.knn_query(small[:10], k=3, ef=30)
        np.testing.assert_array_equal(l1, l2)
        assert set(q.get_ids_list()) == set(ids.tolist())
        np.testing.assert_allclose(q.get_items([5007])[0], small[7],
                                   rtol=1e-6)

    def test_load_index_sniffs_the_native_npz(self, small, tmp_path):
        p = _index(small, n=200)
        path = str(tmp_path / "native.npz")
        p._index.save(path)
        q = Index(space="l2", dim=16, device="cpu")
        q.load_index(path, max_elements=300)
        assert q.get_current_count() == 200 and q.max_elements == 300
        l1, _ = p.knn_query(small[:10], k=3, ef=30)
        l2, _ = q.knn_query(small[:10], k=3, ef=30)
        np.testing.assert_array_equal(l1, l2)

    def test_filter(self, small):
        p = _index(small)
        labels, _ = p.knn_query(small[:5], k=5, ef=50,
                                filter=lambda l: l % 2 == 0)
        assert (labels % 2 == 0).all()

    def test_mark_and_unmark_deleted(self, small):
        p = _index(small)
        p.mark_deleted(3)
        labels, _ = p.knn_query(small[:8], k=3, ef=40)
        assert 3 not in labels
        p.unmark_deleted(3)
        labels, _ = p.knn_query(small[3:4], k=1, ef=40)
        assert labels[0, 0] == 3

    def test_replace_without_allow_raises(self, small):
        p = _index(small, n=10)
        with pytest.raises(RuntimeError, match="allow_replace_deleted"):
            p.add_items(small[10:20], replace_deleted=True)

    def test_k_too_large_raises(self, small):
        p = Index(space="l2", dim=16, device="cpu")
        p.init_index(100)
        p.add_items(small[:5])
        with pytest.raises(RuntimeError, match="contiguous 2D array"):
            p.knn_query(small[:1], k=10)

    def test_capacity_error_message(self, small):
        p = Index(space="l2", dim=16, device="cpu")
        p.init_index(100)
        with pytest.raises(RuntimeError,
                           match="exceeds the specified limit"):
            p.add_items(small[:101])
        p.resize_index(150)
        p.add_items(small[:101])
        assert p.get_current_count() == 101

    def test_ef_above_the_fast_kernel_width(self, small):
        """set_ef above 512 (the warp-per-query kernel's L) is an ordinary
        call; on the CPU it takes the plain composition."""
        p = _index(small)
        p.set_ef(600)
        labels, _ = p.knn_query(small[:10], k=5)
        assert (labels[:, 0] == np.arange(10)).all()

    @pytest.mark.parametrize("space", ["l2", "cosine"])
    def test_pickle_round_trip(self, small, space):
        p = _index(small, space, M=8, ef_construction=40)
        p.set_ef(33)
        p.mark_deleted(5)
        state = p.__getstate__()
        assert state["device"] == "cpu"
        assert not any(isinstance(v, torch.Tensor)
                       for v in state["index"].values())
        assert not any(isinstance(v, torch.Tensor)
                       for v in state["index"]["adj_up"])
        q = pickle.loads(pickle.dumps(p))
        assert (q.space, q.dim, q.ef) == (space, 16, 33)
        assert q._index.num_deleted == 1 and q._index.device.type == "cpu"
        l1, d1 = p.knn_query(small[:20], k=4)
        l2, d2 = q.knn_query(small[:20], k=4)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(d1, d2)
        empty = pickle.loads(pickle.dumps(Index("ip", 4, device="cpu")))
        assert empty._index is None and empty.space == "ip"


class TestAgainstTheJaxPackage:
    """The same calls through both packages. The two add_items calls are
    batches that the JAX package pads nothing in, so both build one
    graph."""

    @pytest.fixture(scope="class")
    def pair(self, small):
        out = []
        for mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
            p = mod.Index("l2", 16, **kw)
            p.init_index(500, M=8, ef_construction=32, random_seed=7)
            p.add_items(small[:64], np.arange(100, 164), batch_size=64)
            p.add_items(small[64:320], np.arange(164, 420), batch_size=256)
            out.append(p)
        return out

    def test_knn_query_matches(self, small, pair):
        jp, tp = pair
        jl, jd = jp.knn_query(small[300:364], k=5, ef=40)
        tl, td = tp.knn_query(small[300:364], k=5, ef=40)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, **TOL)
        jl, _ = jp.knn_query(small[:16], k=3, filter=lambda l: l % 2 == 1)
        tl, _ = tp.knn_query(small[:16], k=3, filter=lambda l: l % 2 == 1)
        np.testing.assert_array_equal(tl, jl)

    def test_saved_index_bytes_equal_and_cross_load(self, small, pair,
                                                    tmp_path):
        jp, tp = pair
        pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
        jp.save_index(str(pj))
        tp.save_index(str(pt))
        assert pj.read_bytes() == pt.read_bytes()
        back = Index("l2", 16, device="cpu")
        back.load_index(str(pj))
        l1, _ = back.knn_query(small[:32], k=5, ef=40)
        l2, _ = jp.knn_query(small[:32], k=5, ef=40)
        np.testing.assert_array_equal(l1, l2)

    @pytest.mark.parametrize("space", ["l2", "ip", "cosine"])
    def test_bf_index_matches(self, small, space):
        out = []
        for mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
            bf = mod.BFIndex(space, 16, **kw)
            bf.init_index(500)
            bf.add_items(small, np.arange(1000, 1400))
            bf.delete_vector(1003)
            out.append(bf.knn_query(small[:40] * 3.0, k=6))
        (jl, jd), (tl, td) = out
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)

    def test_normalize_matches(self, small):
        x = np.concatenate([small[:50], np.zeros((1, 16), np.float32)])
        got = normalize(x)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(j_normalize(x)),
                                   rtol=1e-6, atol=1e-7)
        t = normalize(torch.from_numpy(x).to(torch.bfloat16))
        assert t.dtype == torch.bfloat16


class TestBFIndex:
    def test_exact_and_delete(self, small):
        bf = BFIndex(space="l2", dim=16, device="cpu")
        bf.init_index(500)
        bf.add_items(small)
        labels, dists = bf.knn_query(small[:10], k=1)
        np.testing.assert_array_equal(labels[:, 0], np.arange(10))
        bf.delete_vector(0)
        labels, _ = bf.knn_query(small[:1], k=1)
        assert labels[0, 0] != 0

    def test_bf_as_oracle(self, small):
        p = _index(small, M=16, ef_construction=100)
        bf = BFIndex(space="l2", dim=16, device="cpu")
        bf.init_index(500)
        bf.add_items(small)
        q = np.random.default_rng(0).standard_normal((32, 16)).astype(
            np.float32)
        lh, _ = p.knn_query(q, k=10, ef=100)
        lb, _ = bf.knn_query(q, k=10)
        hits = sum(len(np.intersect1d(lh[i], lb[i])) for i in range(32))
        assert hits / (32 * 10) >= 0.95

    def test_limit_and_save_load(self, small, tmp_path):
        bf = BFIndex("l2", 16, device="cpu")
        with pytest.raises(RuntimeError, match="not initialized"):
            bf.add_items(small)
        bf.init_index(100)
        with pytest.raises(RuntimeError,
                           match="exceeds the specified limit"):
            bf.add_items(small)
        bf.add_items(small[:100])
        path = str(tmp_path / "bf.npz")
        bf.save_index(path)
        back = BFIndex("l2", 16, device="cpu")
        back.load_index(path)
        np.testing.assert_array_equal(back.knn_query(small[:5], k=2)[0],
                                      bf.knn_query(small[:5], k=2)[0])


class TestLazyIndex:
    def test_deferred_init_and_growth(self, small):
        p = LazyIndex("l2", 16, max_elements=100, device="cpu", M=8,
                      ef_construction=40)
        with pytest.raises(RuntimeError, match="empty"):
            p.knn_query(small[:1])
        p.add_items(small[:80])
        assert p.get_max_elements() == 100
        p.add_items(small[80:300])               # grows past its first size
        assert p.get_current_count() == 300 and p.max_elements >= 300
        labels, _ = p.knn_query(small[:30], k=1, ef=40)
        assert (labels[:, 0] == np.arange(30)).mean() > 0.95
