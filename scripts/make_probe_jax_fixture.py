"""Write ``tests/data/probe_jax_ref.npz``: integer-valued inputs of the
per-query probe path and what the JAX package's ``_flat_probe_search``
returns on them, on the CPU.

    JAX_PLATFORMS=cpu python scripts/make_probe_jax_fixture.py

Every value is an integer of at most 4 in magnitude, so each product, sum
and norm is exact in any order: the port's plain version and its kernel
on the card must return these distances and ids bit for bit.
``tests/test_torch_probe_scan.py`` holds the file to the JAX package, and
``tests/test_torch_cuda.py`` the kernel to the file (the card's machine
has no JAX). The inputs hold dead rows and an all-dead cluster, PAD probe
slots, a query with no live slot, a query that probes one cluster twice,
and rows repeated within and across slabs (exact ties).
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "tests" / "data" / "probe_jax_ref.npz"
QN, C, MAXC, D, NPR, VMAX = 37, 12, 96, 128, 3, 4
# (metric, k): the kernel's register list (k <= 32) and its buffers
CASES = [(m, k) for m in ("l2", "ip") for k in (1, 10, 32, 200)]


def inputs(seed: int = 23):
    rng = np.random.default_rng(seed)
    x = rng.integers(-VMAX, VMAX + 1, (C, MAXC, D)).astype(np.int8)
    q = rng.integers(-VMAX, VMAX + 1, (QN, D)).astype(np.float32)
    x[1, 3] = x[0, 0]
    x[:, MAXC // 2] = x[0, 0]
    q[2] = x[0, 0]                             # exact hits
    ids = rng.permutation(C * MAXC).reshape(C, MAXC).astype(np.int32)
    ids[rng.random((C, MAXC)) < 0.15] = -1
    ids[C - 1] = -1
    visit = np.stack([rng.permutation(C)[:NPR] for _ in range(QN)]).astype(
        np.int32)
    visit[rng.random((QN, NPR)) < 0.15] = -1
    visit[0] = -1
    visit[1, :2] = 0
    return dict(q=q, slabs=x, ids=ids, visit=visit)


def jax_outputs(arrays, metric: str, k: int):
    """The JAX package's ``_flat_probe_search`` on bf16 slabs of the
    arrays: (f32 [Q, k], int32 [Q, k]) as numpy."""
    import jax.numpy as jnp

    from hnsw_nsg_tpu.models.cnns import _flat_probe_search
    from hnsw_nsg_tpu.ops.distance import squared_norms

    data_c = jnp.asarray(arrays["slabs"].astype(np.float32)).astype(
        jnp.bfloat16)
    d, i = _flat_probe_search(
        jnp.asarray(arrays["q"]), jnp.asarray(arrays["visit"]), data_c,
        jnp.asarray(arrays["ids"]), squared_norms(data_c), k, metric)
    return np.asarray(d), np.asarray(i)


def main():
    arrays = inputs()
    out = dict(arrays)
    for metric, k in CASES:
        out[f"d_{metric}_{k}"], out[f"i_{metric}_{k}"] = jax_outputs(
            arrays, metric, k)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, {len(CASES)} cases)")


if __name__ == "__main__":
    main()
