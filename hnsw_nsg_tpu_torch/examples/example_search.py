"""Basic build + query flow (reference: examples/python/example_search.py).

    python -m hnsw_nsg_tpu_torch.examples.example_search [device]
"""

import os
import sys
import tempfile

import numpy as np

from hnsw_nsg_tpu_torch.api import Index

device = sys.argv[1] if len(sys.argv) > 1 else None
dim = 64
num_elements = 10000

data = np.random.default_rng(0).standard_normal(
    (num_elements, dim)
).astype(np.float32)

p = Index(space="l2", dim=dim, device=device)
p.init_index(max_elements=num_elements, ef_construction=100, M=16)
p.add_items(data, np.arange(num_elements))
p.set_ef(50)

labels, distances = p.knn_query(data[:100], k=1)
print("self-recall:", (labels[:, 0] == np.arange(100)).mean())

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "example_index.npz")
    p.save_index(path)
    q = Index(space="l2", dim=dim, device=device)
    q.load_index(path)
q.set_ef(50)  # ef is a runtime knob; it is not persisted (same as hnswlib)
labels2, _ = q.knn_query(data[:100], k=1)
assert (labels == labels2).all()
print("save/load OK")
