"""kNN-graph construction three ways (reference: the efanna_graph programs
test_nndescent.cpp / test_kdtree_graph.cpp building the .graph file that
seeds NSG, CNNS/efanna_graph/).

The large-N path is the cluster join (models/knn_ivf.py): k-means slabs,
each cluster joined against its M nearest slabs by one kernel pass
(``csrc/cluster_join.cu``), contiguous slab reads instead of
nn-descent's scattered gathers.

    python -m hnsw_nsg_tpu_torch.examples.example_knn_graph [device]
"""

import sys

import numpy as np
import torch

from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf
from hnsw_nsg_tpu_torch.models.nsg import build_nsg
from hnsw_nsg_tpu_torch.models.rptree import knn_graph_rp
from hnsw_nsg_tpu_torch.ops import knn_graph_exact, recall
from hnsw_nsg_tpu_torch.utils.device import resolve_device
from hnsw_nsg_tpu_torch.utils.params import NSGBuildConfig

device = resolve_device(sys.argv[1] if len(sys.argv) > 1 else None)
rng = np.random.default_rng(3)
centers = rng.standard_normal((20, 32)).astype(np.float32)
x = (centers[rng.integers(0, 20, 20_000)]
     + rng.standard_normal((20_000, 32))).astype(np.float32)

gt = knn_graph_exact(torch.from_numpy(x).to(device), 10, query_block=4096)

adj_ivf = knn_graph_ivf(x, 10, n_clusters=20, probes=6, device=device)
adj_rp = knn_graph_rp(x, 10, n_trees=8, device=device)

print(f"cluster-join graph quality: {recall(adj_ivf, gt):.4f}")
print(f"rp-tree      graph quality: {recall(adj_rp, gt):.4f}")
assert recall(adj_ivf, gt) > 0.9

# the graph seeds an NSG build exactly like the efanna .graph file does
sub = x[:5000]
adj_sub = knn_graph_ivf(sub, 10, n_clusters=8, probes=4, device=device)
nsg = build_nsg(sub, adj_sub, NSGBuildConfig(L=20, R=14, C=100),
                device=device)
print("NSG over the joined graph: mean degree",
      float((nsg.adj >= 0).sum(1).float().mean()))
