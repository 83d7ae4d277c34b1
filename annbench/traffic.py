"""The one traffic generator: it reads a mix's parameters from its data
file (``annbench/traffic/<name>.json``) and turns them into requests.

The loop is closed: one client, each request issued when the ids of the
one before it have reached the host. The pool's rows go in an order
drawn from the seed, cut into consecutive batches and sent over and over.

Keys of a mix:

* ``batch``: queries a request (the pool is a whole number of batches);
* ``k``: neighbours asked for a query;
* ``warmup_requests``: requests made in set-up, before the window;
* ``trace_requests``: requests the traced run profiles.
"""

from __future__ import annotations

import numpy as np
import torch

KEYS = {"batch", "k", "warmup_requests", "trace_requests"}


def validate(traffic: dict, pool: int) -> None:
    unknown = set(traffic) - KEYS - {"why"}
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    if pool % int(traffic["batch"]):
        raise ValueError(f"pool {pool} is no whole number of batches of "
                         f"{traffic['batch']}")


def batches(traffic: dict, pool: int, seed: int, device) -> list[torch.Tensor]:
    """Pool rows of each distinct batch [batch] (int64, on ``device``),
    in the order the requests send them: request r sends batch
    ``r % len(batches)``."""
    validate(traffic, pool)
    order = np.random.default_rng([int(seed), 3]).permutation(pool)
    b = int(traffic["batch"])
    rows = torch.from_numpy(order).to(device)
    return [rows[s : s + b] for s in range(0, pool, b)]
