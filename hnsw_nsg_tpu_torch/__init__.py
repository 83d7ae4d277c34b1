"""hnsw_nsg_tpu_torch — the PyTorch/CUDA port of hnsw_nsg_tpu.

The layout and function names follow the JAX package (``ops/``,
``models/``, ``utils/``), so each function's counterpart is found under
the same path there. This slice holds the CNNS flat search path:
``models.cnns.build_cnns`` and ``CNNSIndex.search``, with the grouped
cluster scan as a hand-written CUDA kernel for Hopper
(``csrc/grouped_scan.cu``, bound in ``ops/cluster_scan.py``).

Importing the package loads no GPU library; the kernel is compiled at
its first launch on a CUDA tensor.
"""
