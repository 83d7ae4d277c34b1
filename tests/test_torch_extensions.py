"""The search extensions, slot replacement and the while-loop beam of the
PyTorch port vs the JAX package on the CPU: the same numpy data from a
seed goes through both. On integer-valued data every product and sum is
exact, so ids, distances, hop and evaluation counts must be EQUAL:
``beam_search``, ``filter_epsilon``, ``topk_distinct_docs``,
``epsilon_search``, ``multivector_search``, ``Index.epsilon_query`` and
``knn_doc_query`` on one graph carried across by ``save``/``load``, and
``replace_point`` on 10 slots (adjacency row for row). Then the
counterparts of tests/test_extensions.py and
tests/test_api.py::test_replace_deleted on the port alone."""

import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu import api as japi  # noqa: E402
from hnsw_nsg_tpu.models import beam as jbeam  # noqa: E402
from hnsw_nsg_tpu.models import extensions as jext  # noqa: E402
from hnsw_nsg_tpu.models.hnsw import HNSWIndex as JHNSW  # noqa: E402
from hnsw_nsg_tpu.ops import knn_graph_exact as j_knn_exact  # noqa: E402
from hnsw_nsg_tpu.ops import squared_norms as j_sq  # noqa: E402
from hnsw_nsg_tpu_torch import api as tapi  # noqa: E402
from hnsw_nsg_tpu_torch.models import beam as tbeam  # noqa: E402
from hnsw_nsg_tpu_torch.models import extensions as text  # noqa: E402
from hnsw_nsg_tpu_torch.models.hnsw import HNSWIndex  # noqa: E402
from hnsw_nsg_tpu_torch.ops import knn_graph_exact, squared_norms  # noqa: E402,E501
from hnsw_nsg_tpu_torch.utils.params import HNSWConfig  # noqa: E402

N, D, R = 1500, 16, 12
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))       # a writable copy


@pytest.fixture(scope="module")
def graphed():
    """Integer-valued rows (every distance exact in f32), their exact kNN
    graph from the JAX package, both packages' norms, integer queries and
    one init row per query."""
    rng = np.random.default_rng(13)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (24, D)).astype(np.float32)
    adj = np.asarray(j_knn_exact(x, R, query_block=N))
    init = np.broadcast_to(adj[0], (24, R)).copy()
    return x, q, adj, init


def _jax_args(x, q, adj, init):
    jx = jnp.asarray(x)
    return jnp.asarray(q), jx, j_sq(jx), jnp.asarray(adj), jnp.asarray(init)


def _torch_args(x, q, adj, init):
    tx = _t(x)
    return _t(q), tx, squared_norms(tx), _t(adj), _t(init)


def _equal(jout, tout):
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# -- the while-loop beam ------------------------------------------------------

@pytest.mark.parametrize("expand,max_hops", [(1, 512), (2, 512), (1, 7),
                                             (2, 5), (3, 9)])
def test_beam_search_matches_jax(graphed, expand, max_hops):
    """Ids, distances, hops and evaluations equal; (2, 5) and (3, 9) stop
    on the largest hop count, before every query converged."""
    jr = jbeam.beam_search(*_jax_args(*graphed), width=32, max_hops=max_hops,
                           expand=expand)
    tr = tbeam.beam_search(*_torch_args(*graphed), width=32,
                           max_hops=max_hops, expand=expand)
    _equal(jr, tr)
    assert int(np.asarray(jr.hops).max()) <= max_hops + expand - 1


def test_random_fill_ids():
    gen = torch.Generator().manual_seed(4)
    a = tbeam.random_fill_ids(gen, 50, (8, 30))
    gen.manual_seed(4)
    b = tbeam.random_fill_ids(gen, 50, (8, 30))
    assert a.dtype == torch.int32 and a.shape == (8, 30)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 50
    assert len(torch.unique(a)) > 40


# -- the extensions, function by function ------------------------------------

def test_filter_epsilon_matches_jax():
    rng = np.random.default_rng(2)
    d = np.sort(rng.integers(0, 20, (16, 24)).astype(np.float32), axis=1)
    i = rng.integers(-1, 500, (16, 24)).astype(np.int32)
    _equal(jext.filter_epsilon(jnp.asarray(d), jnp.asarray(i), 9.0),
           text.filter_epsilon(_t(d), _t(i), 9.0))


def test_topk_distinct_docs_matches_jax():
    """Rows with repeated documents, equal distances and PAD slots; the
    stable sort keeps the JAX package's lax.top_k order among ties."""
    rng = np.random.default_rng(3)
    d = np.sort(rng.integers(0, 6, (32, 40)).astype(np.float32), axis=1)
    i = rng.integers(-1, 300, (32, 40)).astype(np.int32)
    docs = (np.arange(300) // 3).astype(np.int32)
    for k in (5, 40):
        _equal(jext.topk_distinct_docs(jnp.asarray(d), jnp.asarray(i),
                                       jnp.asarray(docs), k),
               text.topk_distinct_docs(_t(d), _t(i), _t(docs), k))


def test_epsilon_search_matches_jax(graphed):
    args = dict(epsilon=150.0, max_candidates=64)
    _equal(jext.epsilon_search(*_jax_args(*graphed), **args),
           text.epsilon_search(*_torch_args(*graphed), **args))


def test_multivector_search_matches_jax(graphed):
    docs = np.arange(N) // 3
    ja, ta = _jax_args(*graphed), _torch_args(*graphed)
    _equal(jext.multivector_search(*ja, jnp.asarray(docs), k=5, width=48),
           text.multivector_search(*ta, _t(docs), k=5, width=48))


# -- the API and slot replacement on one graph carried across ----------------

HN, HM, HEFC = 1024, 8, 32


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """An HNSW graph of integer-valued rows written to the .npz both
    packages read (built by the port: the JAX build would spend ~20 s
    compiling); each test loads it into both."""
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (HN, D)).astype(np.float32)
    q = rng.integers(-4, 5, (32, D)).astype(np.float32)
    new = rng.integers(-4, 5, (10, D)).astype(np.float32)
    t = HNSWIndex(D, HN, HNSWConfig(M=HM, ef_construction=HEFC),
                  device="cpu")
    t.add_items(x)
    path = str(tmp_path_factory.mktemp("ext") / "g.npz")
    t.save(path)
    return x, q, new, path


def test_index_epsilon_query_matches_jax(carried):
    _, q, _, path = carried
    ji = japi.Index("l2", D)
    ji.load_index(path)
    ti = tapi.Index("l2", D, device="cpu")
    ti.load_index(path)
    for eps in (120.0, 170.0):
        jl, jd, jc = ji.epsilon_query(q, eps, max_candidates=48)
        tl, td, tc = ti.epsilon_query(q, eps, max_candidates=48)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tc, jc)
        assert tc.sum() > 0


def test_knn_doc_query_matches_jax(carried):
    _, q, _, path = carried
    docs = np.arange(HN, dtype=np.int64) // 4
    out = []
    for mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
        m = mod.MultiVectorIndex("l2", D, **kw)
        m.load_index(path)
        m._docs = docs.copy()              # the documents of the loaded rows
        out.append(m.knn_doc_query(q, k=6, ef=40))
    (jdocs, jd), (tdocs, td) = out
    np.testing.assert_array_equal(tdocs, jdocs)
    np.testing.assert_array_equal(td, jd)
    for row in tdocs:
        assert len(np.unique(row[row >= 0])) == (row >= 0).sum()


def test_replace_point_matches_jax(carried):
    """Ten slots replaced in turn in both packages: every level's adjacency
    equal row for row, and the data, labels and delete marks."""
    x, _, new, path = carried
    j = JHNSW.load(path)
    t = HNSWIndex.load(path, device="cpu")
    slots = [int(s) for s in np.random.default_rng(8).choice(HN, 10,
                                                           replace=False)]
    for idx in (j, t):
        for s in slots[::2]:
            idx.mark_deleted(s)
    for s, v, lab in zip(slots, new, range(5000, 5010)):
        j.replace_point(s, v, lab)
        t.replace_point(s, v, lab)
    np.testing.assert_array_equal(t.adj0[:HN].numpy(),
                                  np.asarray(j.adj0)[:HN])
    assert len(t.adj_up) == len(j.adj_up) > 0
    for ta, ja in zip(t.adj_up, j.adj_up):
        np.testing.assert_array_equal(ta[:HN].numpy(), np.asarray(ja)[:HN])
    np.testing.assert_array_equal(t.data[:HN].numpy(),
                                  np.asarray(j.data)[:HN])
    np.testing.assert_array_equal(t.labels, j.labels[: len(t.labels)])
    assert t.num_deleted == j.num_deleted == 0
    assert t.adj0_d is None and t._records is None and t.check_integrity()


def test_api_replace_deleted_matches_jax(carried):
    """The same deletes and replacing adds through both APIs (one graph
    carried across): equal graphs, labels and search results."""
    x, q, new, path = carried
    out = []
    for mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
        p = mod.Index("l2", D, **kw)
        p.load_index(path, allow_replace_deleted=True)
        for lab in range(0, 40, 4):
            p.mark_deleted(lab)
        p.add_items(new, np.arange(7000, 7010), replace_deleted=True)
        labels, dists = p.knn_query(q, k=5, ef=32)
        out.append((np.asarray(p._index.adj0)[:HN], labels, dists,
                    sorted(p.get_ids_list())))
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)


def test_allow_replace_deleted_survives_pickle(carried):
    *_, path = carried
    p = tapi.Index("l2", D, device="cpu")
    p.load_index(path, allow_replace_deleted=True)
    back = pickle.loads(pickle.dumps(p))
    back.mark_deleted(3)
    back.add_items(np.zeros((1, D), np.float32), [9999],
                   replace_deleted=True)
    assert back.get_current_count() == HN and 3 not in back.get_ids_list()


# -- counterparts of tests/test_extensions.py ----------------------------------

@pytest.fixture(scope="module")
def normal_graphed():
    """tests/test_extensions.py's fixture: 1500 x 16 N(0, 1) rows (seed 13)
    and their exact 12-NN graph."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    xt = _t(x)
    return x, knn_graph_exact(xt, 12, query_block=1500), squared_norms(xt)


def test_epsilon_search_matches_exact(normal_graphed):
    x, adj, norms = normal_graphed
    rng = np.random.default_rng(1)
    q = x[:8] + rng.standard_normal((8, 16)).astype(np.float32) * 0.1
    eps = 8.0
    init = adj[0][None].expand(8, -1)
    d, i, counts = text.epsilon_search(_t(q), _t(x), norms, adj, init,
                                       epsilon=eps, max_candidates=256)
    d, i, counts = d.numpy(), i.numpy(), counts.numpy()
    full = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    for qi in range(8):
        exact = set(np.nonzero(full[qi] <= eps)[0].tolist())
        got = set(i[qi][i[qi] >= 0].tolist())
        assert counts[qi] == len(got)
        if exact:
            assert len(got & exact) / len(exact) > 0.9
        for iv, dv in zip(i[qi], d[qi]):
            if iv >= 0:
                assert full[qi, iv] <= eps + 1e-3
                np.testing.assert_allclose(dv, full[qi, iv], rtol=1e-4,
                                           atol=1e-3)


def test_filter_epsilon_counts():
    fd, fi, c = text.filter_epsilon(torch.tensor([[1.0, 2.0, 3.0]]),
                                    torch.tensor([[10, 20, 30]]), 2.5)
    assert int(c[0]) == 2
    assert fi[0].tolist() == [10, 20, -1]


def test_topk_distinct_docs():
    # vector ids 0..5 belong to docs [0, 0, 1, 1, 2, 2]
    dd, docs, vecs = text.topk_distinct_docs(
        torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5, 0.6]]),
        torch.tensor([[0, 1, 2, 3, 4, 5]]), torch.tensor([0, 0, 1, 1, 2, 2]),
        3)
    assert docs[0].tolist() == [0, 1, 2]
    assert vecs[0].tolist() == [0, 2, 4]   # the best vector of each doc
    np.testing.assert_allclose(dd[0].numpy(), [0.1, 0.3, 0.5], rtol=1e-6)


def test_multivector_search(normal_graphed):
    x, adj, norms = normal_graphed
    doc_ids = torch.arange(1500) // 3        # 3 vectors a document
    dd, docs, vecs = text.multivector_search(
        _t(x[30:38]), _t(x), norms, adj, adj[0][None].expand(8, -1),
        doc_ids, k=5, width=64)
    docs = docs.numpy()
    for r in range(8):
        v = docs[r][docs[r] >= 0]
        assert len(np.unique(v)) == len(v)
    assert docs[0, 0] == 10                  # the query vector's own doc


class TestApiLayer:
    """tests/test_extensions.py's API cases (slow there), on the port at
    a smaller size."""

    def test_index_epsilon_query(self):
        rng = np.random.default_rng(21)
        x = rng.standard_normal((1200, 16)).astype(np.float32)
        idx = tapi.Index("l2", 16, device="cpu")
        idx.init_index(max_elements=len(x), M=12, ef_construction=60)
        idx.add_items(x)
        q = x[:4]
        eps = 6.0
        labels, dists, counts = idx.epsilon_query(q, epsilon=eps,
                                                  max_candidates=128)
        full = ((q[:, None, :] - x[None]) ** 2).sum(-1)
        for r in range(4):
            got = set(labels[r][labels[r] >= 0].tolist())
            exact = set(np.nonzero(full[r] <= eps)[0].tolist())
            assert int(counts[r]) == len(got)
            assert len(got & exact) / max(len(exact), 1) > 0.85
            for lbl in labels[r]:
                if lbl >= 0:
                    assert full[r, lbl] <= eps + 1e-3
        assert all(r in set(labels[r].tolist()) for r in range(4))

    def test_multivector_index(self):
        rng = np.random.default_rng(22)
        x = rng.standard_normal((1200, 16)).astype(np.float32)
        doc_ids = np.arange(1200) // 4
        idx = tapi.MultiVectorIndex("l2", 16, device="cpu")
        idx.init_index(max_elements=1200, M=12, ef_construction=60)
        idx.add_items(x, doc_ids)
        docs, dists = idx.knn_doc_query(x[40:44], k=5, ef=64)
        assert docs.shape == (4, 5)
        for r in range(4):
            v = docs[r][docs[r] >= 0]
            assert len(np.unique(v)) == len(v)
        assert docs[0, 0] == 10 and dists[0, 0] < 1e-5


def test_replace_deleted():
    """tests/test_api.py::test_replace_deleted (bindings_test_replace.py's
    shape) on the port."""
    small = np.random.default_rng(17).standard_normal((400, 16)).astype(
        np.float32)
    p = tapi.Index(space="l2", dim=16, device="cpu")
    p.init_index(500, allow_replace_deleted=True)
    p.add_items(small[:300])
    for lab in range(10):
        p.mark_deleted(lab)
    new = small[300:310]
    p.add_items(new, np.arange(1000, 1010), replace_deleted=True)
    assert p.get_current_count() == 300      # slots reused
    labels, _ = p.knn_query(new, k=1, ef=40)
    assert (labels[:, 0] >= 1000).mean() > 0.8
    for lab in range(10):
        assert lab not in p.get_ids_list()
