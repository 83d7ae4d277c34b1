"""Delete + replace flow (reference: examples/python/
example_replace_deleted.py).

    python -m hnsw_nsg_tpu_torch.examples.example_replace_deleted [device]
"""

import sys

import numpy as np

from hnsw_nsg_tpu_torch.api import Index

device = sys.argv[1] if len(sys.argv) > 1 else None
dim = 16
num_elements = 2000

rng = np.random.default_rng(2)
data = rng.standard_normal((num_elements, dim)).astype(np.float32)

p = Index(space="l2", dim=dim, device=device)
p.init_index(
    max_elements=num_elements, ef_construction=80, M=16,
    allow_replace_deleted=True,
)
p.add_items(data, np.arange(num_elements))

for label in range(100):
    p.mark_deleted(label)

new_data = rng.standard_normal((100, dim)).astype(np.float32)
p.add_items(new_data, np.arange(5000, 5100), replace_deleted=True)

print("count unchanged (slots reused):", p.get_current_count())
labels, _ = p.knn_query(new_data[:10], k=1, ef=50)
print("new points findable:", (labels[:, 0] >= 5000).mean())
