"""Configuration: typed dataclasses + a string-keyed Parameters map.

The reference uses a string->string map with typed Get/Set
(CNNS/efanna_graph/include/efanna2e/parameters.h:15-57) plus raw constructor
arguments. We provide dataclass configs mirroring SURVEY.md §2.8's parameter
table (the defaults below are the defaults observed in the reference), and a
``Parameters`` compatibility shim with the same Get/Set semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Any


class Parameters:
    """String-keyed parameter map, API-compatible with efanna2e::Parameters."""

    def __init__(self, **kwargs):
        self._params: dict[str, str] = {}
        for k, v in kwargs.items():
            self.set(k, v)

    def set(self, name: str, value: Any) -> None:
        self._params[name] = str(value)

    def get(self, name: str, ty=str, default=None):
        if name not in self._params:
            if default is not None:
                return default
            raise KeyError(f"Invalid parameter name: {name}")
        v = self._params[name]
        if ty is bool:
            return v in ("True", "true", "1")
        return ty(v)

    # C++-style aliases
    Set = set
    Get = get


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """hnswlib/hnswlib/hnswalg.h:89-144 defaults."""
    M: int = 16
    ef_construction: int = 200
    ef: int = 10
    random_seed: int = 100
    allow_replace_deleted: bool = False
    # frontier nodes expanded per lockstep hop during construction beams;
    # >1 trades a few extra distance evals for proportionally fewer
    # sequential hops (a knob of the batched beam, no hnswlib equivalent)
    insert_expand: int = 4
    # maintain the level-0 link-distance cache (hnsw.adj0_d). Off by
    # default, as in the JAX package: the reverse-edge round recomputes
    # the existing links' distances with one gathered pass. Kept as an
    # option for workloads where the recompute dominates (very wide
    # links or dims).
    link_dist_cache: bool = False

    @property
    def maxM0(self) -> int:
        return 2 * self.M

    @property
    def mult(self) -> float:
        import math
        return 1.0 / math.log(max(self.M, 2))


@dataclasses.dataclass(frozen=True)
class NNDescentConfig:
    """CNNS/tests/cluster_IVF_nndescent.cpp:103-107 defaults."""
    K: int = 100     # output graph degree
    L: int = 100     # pool size during build
    iters: int = 10
    S: int = 10      # new-neighbor sample size
    R: int = 100     # reverse-edge sample cap


@dataclasses.dataclass(frozen=True)
class NSGBuildConfig:
    """CNNS/tests/nndescent_nsg.cpp:38-40 defaults."""
    L: int = 40      # build-time beam width
    R: int = 50      # max out-degree (range)
    C: int = 500     # prune candidate scan cap


@dataclasses.dataclass(frozen=True)
class NSGSearchConfig:
    L_search: int = 100   # beam width (>= K)
    K_search: int = 100


@dataclasses.dataclass(frozen=True)
class CNNSConfig:
    """CNNS pipeline routing params (cluster_IVF_nndescent.cpp:92-100,
    cluster_hnsw_nsg_search.cpp:33-37)."""
    n_clusters: int = 64
    m: int = 4            # extra representatives per cluster
    nprobe: int = 8
    k: int = 100
    kmeans_iters: int = 20
    # Fill dead slab-padding slots with replicas of boundary points
    # (each point's nearest OTHER slab). The probe kernel scans the full
    # padded slab width regardless, so replication raises recall-per-probe
    # at zero extra scan cost and zero extra memory; duplicates are removed
    # in the final top-k merge. Flat local index only.
    replicate: bool = False
    nndescent: NNDescentConfig = NNDescentConfig()
    nsg: NSGBuildConfig = NSGBuildConfig()
