"""hnsw_nsg_tpu_torch — the PyTorch/CUDA port of hnsw_nsg_tpu.

The layout and function names follow the JAX package (``ops/``,
``models/``, ``utils/``), so each function's counterpart is found under
the same path there. Ported so far:

  * the CNNS flat search path: ``models.cnns.build_cnns`` and
    ``CNNSIndex.search``, on the grouped cluster scan
    (``csrc/grouped_scan.cu``, bound in ``ops/cluster_scan.py``);
  * the graph path: ``models.knn_ivf.knn_graph_ivf`` (the cluster join,
    ``csrc/cluster_join.cu``), ``models.nsg.build_nsg`` and
    ``NSGIndex.search`` over the lockstep beam of ``models.beam``, whose
    every hop runs the fused merge+select (``csrc/merge_select.cu``,
    bound in ``ops/merge_select.py``);
  * HNSW (``models.hnsw.HNSWIndex``: batched insert, routed or descended
    entry, deletes, filters, hnswlib's file format), the hybrid index
    (``models.hybrid.HybridHNSWNSG``: HNSW upper levels routing into an
    NSG base layer) and the hnswlib-compatible ``api.Index``,
    ``LazyIndex`` and ``BFIndex``, on the same beam and kernel;
  * the search extensions (``models.extensions``: range search, top-k
    distinct documents; ``api.Index.epsilon_query``,
    ``api.MultiVectorIndex``), slot replacement
    (``HNSWIndex.replace_point``, ``allow_replace_deleted``) and the
    small-N graph builders (``models.nndescent``: ``nn_descent``,
    ``graph_add``; ``models.rptree``: ``knn_graph_rp``), which the hybrid
    index builds its kNN graph with between 8,192 and 200,000 points;
  * the sharded indexes (``parallel.mesh``: a mesh of devices, one
    controller running every shard, top-k merges on its first device),
    the entry points of ``__graft_entry__.py`` (``entry``), the command
    line (``cli``),
    ``utils.metrics``, ``utils.native`` and the ``examples``: every module
    of the JAX package but its JAX-only compile cache.

Importing the package loads no GPU library; the kernels are compiled at
the first launch on a CUDA tensor.
"""
