"""Full CNNS pipeline (reference: CNNS/tests/cluster_IVF_nndescent.cpp +
nndescent_nsg.cpp + cluster_hnsw_nsg_search.cpp, as a library flow).

    python -m hnsw_nsg_tpu_torch.examples.example_cnns_pipeline [device]
"""

import sys

import numpy as np
import torch

from hnsw_nsg_tpu_torch.models.cnns import build_cnns
from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
from hnsw_nsg_tpu_torch.utils.device import resolve_device
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig

device = resolve_device(sys.argv[1] if len(sys.argv) > 1 else None)
rng = np.random.default_rng(5)
centers = rng.standard_normal((30, 64)).astype(np.float32) * 3
x = (centers[rng.integers(0, 30, 30000)]
     + rng.standard_normal((30000, 64))).astype(np.float32)
q = (centers[rng.integers(0, 30, 100)]
     + rng.standard_normal((100, 64))).astype(np.float32)

idx = build_cnns(x, CNNSConfig(n_clusters=32, m=4, kmeans_iters=10),
                 device=device)
dists, ids = idx.search(q, k=10, nprobe=4)

_, gt = brute_force_topk(torch.from_numpy(q).to(device),
                         torch.from_numpy(x).to(device), 10)
print("recall@10:", recall(ids, gt))
