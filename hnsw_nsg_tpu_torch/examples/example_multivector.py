"""Multivector document retrieval (reference: examples/cpp/
example_multivector_search.cpp + stop_condition.h:10-215).

    python -m hnsw_nsg_tpu_torch.examples.example_multivector [device]
"""

import sys

import numpy as np
import torch

from hnsw_nsg_tpu_torch.models.extensions import multivector_search
from hnsw_nsg_tpu_torch.ops import knn_graph_exact, squared_norms
from hnsw_nsg_tpu_torch.utils.device import resolve_device

device = resolve_device(sys.argv[1] if len(sys.argv) > 1 else None)
rng = np.random.default_rng(3)
n_docs, vecs_per_doc, dim = 500, 4, 32
x = rng.standard_normal((n_docs * vecs_per_doc, dim)).astype(np.float32)
doc_ids = np.repeat(np.arange(n_docs), vecs_per_doc)

xd = torch.from_numpy(x).to(device)
adj = knn_graph_exact(xd, 16)
norms = squared_norms(xd)
q = xd[:8]  # queries near docs 0 and 1
init = adj[0][None].expand(8, -1)

dists, docs, vecs = multivector_search(
    q, xd, norms, adj, init, torch.from_numpy(doc_ids).to(device), k=5
)
print("top docs for query 0:", docs[0].cpu().numpy())
print("their best vectors:", vecs[0].cpu().numpy())
