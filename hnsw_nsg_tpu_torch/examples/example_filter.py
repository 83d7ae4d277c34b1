"""Filtered search (reference: examples/python/example_filter.py).

    python -m hnsw_nsg_tpu_torch.examples.example_filter [device]
"""

import sys

import numpy as np

from hnsw_nsg_tpu_torch.api import Index

device = sys.argv[1] if len(sys.argv) > 1 else None
dim = 16
num_elements = 5000

data = np.random.default_rng(1).standard_normal(
    (num_elements, dim)
).astype(np.float32)

p = Index(space="l2", dim=dim, device=device)
p.init_index(max_elements=num_elements, ef_construction=80, M=16)
p.add_items(data)

# only even labels are acceptable
labels, distances = p.knn_query(
    data[:5], k=10, ef=100, filter=lambda label: label % 2 == 0
)
assert (labels % 2 == 0).all()
print("filtered results all even:", labels[0])
