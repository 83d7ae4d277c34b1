"""The port's entry points put numpy input on the card unless the caller
asks for the CPU. With a card visible each lands on ``cuda``; on a torch
without CUDA each raises, and none ever returns CPU tensors."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu_torch import api  # noqa: E402
from hnsw_nsg_tpu_torch.models import cnns  # noqa: E402
from hnsw_nsg_tpu_torch.models import hnsw  # noqa: E402
from hnsw_nsg_tpu_torch.models import hybrid  # noqa: E402
from hnsw_nsg_tpu_torch.models import nndescent  # noqa: E402
from hnsw_nsg_tpu_torch.models import nsg  # noqa: E402
from hnsw_nsg_tpu_torch.models import rptree  # noqa: E402
from hnsw_nsg_tpu_torch.models import spill  # noqa: E402
from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf  # noqa: E402
from hnsw_nsg_tpu_torch.utils import io as io_utils  # noqa: E402
from hnsw_nsg_tpu_torch.utils.device import resolve_device  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import (  # noqa: E402
    CNNSConfig, HNSWConfig, NNDescentConfig, NSGBuildConfig)


def _data(n=600, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _knn(x, k=8):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.argsort(d2, axis=1, kind="stable")[:, :k].astype(np.int32)


def _build_cnns(tmp_path):
    idx = cnns.build_cnns(_data(), CNNSConfig(n_clusters=4, m=2,
                                              kmeans_iters=2))
    return [idx.data_c, idx.ids_c, idx.reps]


def _load_cnns(tmp_path):
    p = str(tmp_path / "c.npz")
    cnns.build_cnns(_data(), CNNSConfig(n_clusters=4, m=2, kmeans_iters=2),
                    device="cpu").save(p)
    idx = cnns.CNNSIndex.load(p)
    return [idx.data_c, idx.ids_c, idx.reps]


def _build_cnns_nsg(tmp_path):
    idx = cnns.build_cnns(_data(), CNNSConfig(
        n_clusters=4, m=2, kmeans_iters=2, nsg=NSGBuildConfig(L=8, R=4, C=16)),
        local_index="nsg")
    return [idx.data_c, idx.ids_c, idx.reps, idx.flat_adj]


def _spill_index(tmp_path):
    idx = cnns.build_cnns(_data(), CNNSConfig(n_clusters=4, m=2,
                                              kmeans_iters=2))
    sp = spill.SpillCNNSIndex(idx, 1 << 20)
    d, i = sp.search(_data(4), k=2, nprobe=2)   # a group lands on the card
    return [d, i, sp.reps]


def _knn_graph(tmp_path):
    return [knn_graph_ivf(_data(), 8, n_clusters=4, probes=2,
                          as_device=True)]


def _build_nsg(tmp_path):
    x = _data(300)
    idx = nsg.build_nsg(x, _knn(x), NSGBuildConfig(L=16, R=8, C=40))
    return [idx.data, idx.adj]


def _load_nsg(tmp_path):
    x = _data(300)
    p = str(tmp_path / "g.npz")
    np.savez(p, adj=_knn(x), ep=0, metric="l2")
    idx = nsg.NSGIndex.load(p, x)
    return [idx.data, idx.adj]


def _load_nsg_reference_format(tmp_path):
    x = _data(300)
    p = str(tmp_path / "g.nsg")
    io_utils.write_nsg(p, _knn(x), 0, 8)
    idx = nsg.NSGIndex.load_reference_format(p, x)
    return [idx.data, idx.adj]


def _hnsw_arrays(idx):
    return [idx.data, idx.norms, idx.adj0, *idx.adj_up]


def _small_hnsw(device="cpu"):
    idx = hnsw.HNSWIndex(8, 300, HNSWConfig(M=4, ef_construction=16),
                         device=device)
    idx.add_items(_data(300))
    return idx


def _hnsw_index(tmp_path):
    return _hnsw_arrays(_small_hnsw(device=None))


def _hnsw_load(tmp_path):
    p = str(tmp_path / "h.npz")
    _small_hnsw().save(p)
    return _hnsw_arrays(hnsw.HNSWIndex.load(p))


def _hnsw_load_hnswlib_format(tmp_path):
    p = str(tmp_path / "h.bin")
    _small_hnsw().save_hnswlib_format(p)
    return _hnsw_arrays(hnsw.HNSWIndex.load_hnswlib_format(p))


def _hybrid_index(tmp_path):
    h = hybrid.HybridHNSWNSG(8, 300, HNSWConfig(M=4, ef_construction=16),
                             NSGBuildConfig(L=16, R=8, C=40))
    h.add_points(_data(300))
    h.build_nsg_layer()
    return [*_hnsw_arrays(h.hnsw), h.nsg.data, h.nsg.adj]


def _hybrid_load(tmp_path):
    h = hybrid.HybridHNSWNSG(8, 300, HNSWConfig(M=4, ef_construction=16),
                             NSGBuildConfig(L=16, R=8, C=40), device="cpu")
    h.add_points(_data(300))
    h.build_nsg_layer()
    h.save(str(tmp_path / "hy"))
    back = hybrid.HybridHNSWNSG.load(str(tmp_path / "hy"))
    return [*_hnsw_arrays(back.hnsw), back.nsg.data, back.nsg.adj]


def _api_index(tmp_path):
    p = api.Index("l2", 8)
    p.init_index(300, M=4, ef_construction=16)
    p.add_items(_data(300))
    return _hnsw_arrays(p._index)


def _api_load_index(tmp_path):
    path = str(tmp_path / "a.bin")
    _small_hnsw().save_hnswlib_format(path)
    p = api.Index("l2", 8)
    p.load_index(path)
    return _hnsw_arrays(p._index)


def _api_unpickle(tmp_path):
    import pickle

    src = api.Index("l2", 8, device="cpu")
    src.init_index(300, M=4, ef_construction=16)
    src.add_items(_data(300))
    state = src.__getstate__()
    state["device"] = None              # as a pickle made on the card has it
    p = api.Index.__new__(api.Index)
    p.__setstate__(pickle.loads(pickle.dumps(state)))
    return _hnsw_arrays(p._index)


def _api_lazy_index(tmp_path):
    p = api.LazyIndex("l2", 8, max_elements=300, M=4, ef_construction=16)
    p.add_items(_data(100))
    return _hnsw_arrays(p._index)


def _api_bf_index(tmp_path):
    bf = api.BFIndex("l2", 8)
    bf.init_index(300)
    bf.add_items(_data(300))
    labels, _ = bf.knn_query(_data(4), k=2)   # the query resolves the device
    assert labels.shape == (4, 2)
    return []


def _nn_descent(tmp_path):
    nndescent.nn_descent(_data(), NNDescentConfig(K=4, L=8, iters=1, S=2,
                                                  R=4))
    return []


def _knn_graph_rp(tmp_path):
    rptree.knn_graph_rp(_data(), 4, n_trees=1, leaf_size=128)
    return []


def _graph_add(tmp_path):
    x = _data()
    nndescent.graph_add(x[:500], _knn(x[:500], 4), x[500:])
    return []


def _api_multivector(tmp_path):
    p = api.MultiVectorIndex("l2", 8)
    p.init_index(300, M=4, ef_construction=16)
    p.add_items(_data(300), np.arange(300) // 3)
    docs, _ = p.knn_doc_query(_data(4), k=2)
    assert docs.shape == (4, 2)
    return _hnsw_arrays(p._index)


ENTRY_POINTS = {
    "build_cnns": _build_cnns,
    "CNNSIndex.load": _load_cnns,
    "build_cnns(local_index='nsg')": _build_cnns_nsg,
    "SpillCNNSIndex": _spill_index,
    "knn_graph_ivf": _knn_graph,
    "build_nsg": _build_nsg,
    "NSGIndex.load": _load_nsg,
    "NSGIndex.load_reference_format": _load_nsg_reference_format,
    "HNSWIndex": _hnsw_index,
    "HNSWIndex.load": _hnsw_load,
    "HNSWIndex.load_hnswlib_format": _hnsw_load_hnswlib_format,
    "HybridHNSWNSG": _hybrid_index,
    "HybridHNSWNSG.load": _hybrid_load,
    "api.Index": _api_index,
    "api.Index.load_index": _api_load_index,
    "api.Index unpickled": _api_unpickle,
    "api.LazyIndex": _api_lazy_index,
    "api.BFIndex": _api_bf_index,
    "api.MultiVectorIndex": _api_multivector,
    "nn_descent": _nn_descent,
    "knn_graph_rp": _knn_graph_rp,
    "graph_add": _graph_add,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_numpy_input_defaults_to_the_card(tmp_path, entry):
    call = ENTRY_POINTS[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(tmp_path)
        return
    for t in call(tmp_path):
        assert t.device.type == "cuda", (entry, t.device)


def test_resolve_device_keeps_what_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
