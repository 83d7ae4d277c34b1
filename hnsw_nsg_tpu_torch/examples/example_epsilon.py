"""Epsilon (range) search (reference: examples/cpp/
example_epsilon_search.cpp + stop_condition.h:218-275).

    python -m hnsw_nsg_tpu_torch.examples.example_epsilon [device]
"""

import sys

import numpy as np
import torch

from hnsw_nsg_tpu_torch.models.extensions import epsilon_search
from hnsw_nsg_tpu_torch.ops import knn_graph_exact, squared_norms
from hnsw_nsg_tpu_torch.utils.device import resolve_device

device = resolve_device(sys.argv[1] if len(sys.argv) > 1 else None)
rng = np.random.default_rng(4)
x = rng.standard_normal((5000, 16)).astype(np.float32)
xd = torch.from_numpy(x).to(device)
adj = knn_graph_exact(xd, 16)
norms = squared_norms(xd)

q = x[:4] + 0.05 * rng.standard_normal((4, 16)).astype(np.float32)
init = adj[0][None].expand(4, -1)

dists, ids, counts = epsilon_search(
    torch.from_numpy(q).to(device), xd, norms, adj, init,
    epsilon=4.0, max_candidates=128,
)
for i in range(4):
    print(f"query {i}: {int(counts[i])} points within epsilon")
