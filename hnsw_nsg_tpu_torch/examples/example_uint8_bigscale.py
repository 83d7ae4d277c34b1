"""uint8 vector space at big-data scale (reference: the sift_1b.cpp
uint8/bigann flow, hnswlib/tests/cpp/sift_1b.cpp:243-344, and the
L2SpaceI integer space, hnswlib/hnswlib/space_l2.h:294-323).

uint8 vectors are stored shift-by-128 as int8 slabs in the CNNS layout;
distances run as exact s8 x s8 -> s32 integer products on the card's
int8 tensor cores (``scan_i8_kernel``), 4x less memory than f32 slabs.
L2 distances are shift-invariant, so results are exact against uint8
arithmetic.

    python -m hnsw_nsg_tpu_torch.examples.example_uint8_bigscale [device]
"""

import sys

import numpy as np
import torch

from hnsw_nsg_tpu_torch.models.cnns import build_cnns
from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall
from hnsw_nsg_tpu_torch.utils.device import resolve_device
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig

device = resolve_device(sys.argv[1] if len(sys.argv) > 1 else None)
rng = np.random.default_rng(11)
centers = rng.integers(40, 215, (30, 64))
x = np.clip(
    centers[rng.integers(0, 30, 50_000)]
    + rng.normal(0, 18, (50_000, 64)), 0, 255,
).round().astype(np.uint8)
q = np.clip(
    centers[rng.integers(0, 30, 100)]
    + rng.normal(0, 18, (100, 64)), 0, 255,
).round().astype(np.uint8)

# build with int8 slabs: the uint8 rows go to the card as they are
idx = build_cnns(
    x, CNNSConfig(n_clusters=48, m=4, kmeans_iters=10),
    slab_dtype=torch.int8, device=device,
)
assert idx.data_c.dtype == torch.int8 and idx.qshift == 128.0

# uint8 queries are taken as their values
dists, ids = idx.search(q, k=10, nprobe=6)
_, gt = brute_force_topk(torch.from_numpy(q).float().to(device),
                         torch.from_numpy(x).float().to(device), 10)
r = recall(ids, gt)
print(f"uint8/int8 recall@10 = {r:.4f}")
assert r > 0.9

# distances are exact integer L2^2 (no bf16 rounding)
d0 = float(dists[0, 0])
ref = float(((q[0].astype(np.int64)
              - x[int(ids[0, 0])].astype(np.int64)) ** 2).sum())
assert abs(d0 - ref) < 1e-3, (d0, ref)
print("integer distances exact; index bytes/vector =",
      idx.data_c.shape[1] * idx.data_c.shape[2] // idx.maxc)
