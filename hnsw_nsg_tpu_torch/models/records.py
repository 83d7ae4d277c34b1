"""Packed int8 neighbour-record graph, the traversal layout at HBM scale
(counterpart of hnsw_nsg_tpu/models/records.py).

The analogue of the reference's ``OptimizeGraph`` repack
(CNNS/src/nsg/index_nsg.cpp:570-682): ONE gathered row carries everything
a frontier expansion needs, the node's R neighbours' int8-quantized
vectors, their ids and their exact f32 squared norms. An expansion then
moves one row of S x 512 bytes (4 KB at R=30, d<=128) instead of R
scattered data rows plus separate id and norm loads. Traversal distances
use the FastL2 form d = ||x||^2 - 2<q, x> with the dot over the int8
vector and the bf16-rounded query, and the norm exact.

Row layout (int32 words, row = S x 128 words, S a multiple of 8), kept
exactly as in the JAX package so that the rows compare byte for byte:

  [ R x nw vec words | R ids | R norm-bits | pad ]     nw = ceil(d/4)

Vector packing is "split-quarter": word w of neighbour r stores dims
{w, nw+w, 2nw+w, 3nw+w} in its 4 bytes (byte k, little-endian, holds dim
k*nw + w). Here the gathered words are viewed as int8, so byte 4w + k is
dim k*nw + w, and the query is laid out in the same order: one f32
product (TF32 off, ``ops.distance.f32_dots``) over all 4 nw bytes takes
the place of the JAX package's four bf16 einsums. Every product is exact
and only the summation order differs, so on integer-valued data the two
give the same distances.

Scale: one global symmetric scale (max|x|/127), held as an f32 value.
Quantization rounds half to even and clips to +-127. Traversal ranking is
approximate for arbitrary f32 data; callers re-rank exactly
(``inline_graph.rerank_exact``).

Each hop calls ``fused_merge_select`` (the CUDA kernel on the card), on
the expand-first skeleton of ``beam.beam_search_chunked``: one host check
a chunk, converged queries compacted out to exactly the live rows.

Not carried over, none of which changes a result: the ``lax.scan`` chunk
program, the power-of-two compaction buckets, ``_scatter_final`` and
``_compact_batch`` as compiled programs (plain indexing does both), the
``use_kernel`` switch (the tensors' device decides), the fill's sliding
last chunk, and the quantized store as int32 (it is int8 here).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.distance import PAD_DIST, PAD_ID, f32_dots
from .beam import BeamResult, _start, run_chunks


class RecordGraph(NamedTuple):
    """The packed rows and how to read them."""

    rows: torch.Tensor   # [N, S, 128] int32
    scale: float         # dequantization scale (an f32 value)
    r: int               # neighbours per record
    d: int               # vector dims

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def s(self) -> int:
        return self.rows.shape[1]

    def nbytes(self) -> int:
        return self.rows.numel() * 4


def _layout(r: int, d: int):
    nw = -(-d // 4)
    need = r * nw + 2 * r
    s = 8 * (-(-need // 1024))
    return nw, s


def _f32(scale: float) -> float:
    return float(np.float32(scale))


def quantize_rows(x: torch.Tensor, scale: float, nw: int) -> torch.Tensor:
    """Quantize vectors to the split-quarter layout: [B, 4, nw] int8, dim
    k*nw + w at [:, k, w] (zero past d). The division is a true f32
    division by a tensor (a scalar divisor may become a multiplication by
    its reciprocal on the card)."""
    b, d = x.shape
    s = torch.full((), _f32(scale), dtype=torch.float32, device=x.device)
    qv = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    if 4 * nw > d:
        qv = torch.nn.functional.pad(qv, (0, 4 * nw - d))
    return qv.reshape(b, 4, nw)


def _pack(data_q, norms, adj, nw: int, s: int) -> torch.Tensor:
    """Record rows [B, S, 128] int32 for adjacency rows adj [B, R]."""
    b, r = adj.shape
    ok = adj >= 0
    safe = torch.where(ok, adj, 0).long()
    q4 = data_q[safe].masked_fill(~ok[:, :, None, None], 0)  # [B, R, 4, nw]
    # byte k of word w is quarter k: [B, R, nw, 4] int8 read as int32
    words = q4.transpose(2, 3).contiguous().view(torch.int32)
    ids = torch.where(ok, adj, PAD_ID).to(torch.int32)
    nb = torch.where(ok, norms[safe], PAD_DIST).view(torch.int32)
    pad = torch.zeros((b, s * 128 - r * nw - 2 * r), dtype=torch.int32,
                      device=adj.device)
    return torch.cat([words.reshape(b, r * nw), ids, nb, pad],
                     1).view(b, s, 128)


def build_record_graph(
    data: torch.Tensor,
    adj: torch.Tensor,
    norms: torch.Tensor,
    scale: float | None = None,
    chunk: int = 1 << 16,
) -> RecordGraph:
    """Derive the packed record layout from (data, padded adjacency), on
    the data's device. adj: [N, R] int32 (PAD_ID-padded); callers with
    fatter adjacency slice to the closest R neighbours first (the engines
    store rows in degree order)."""
    n, d = data.shape
    adj = adj.to(device=data.device, dtype=torch.int32)
    r = adj.shape[1]
    nw, s = _layout(r, d)
    if scale is None:
        scale = float(data.float().abs().max()) / 127.0
    scale = _f32(max(scale, 1e-30))
    data_q = quantize_rows(data, scale, nw)
    rows = torch.empty((n, s, 128), dtype=torch.int32, device=data.device)
    for st in range(0, n, chunk):
        e = min(st + chunk, n)
        rows[st:e] = _pack(data_q, norms, adj[st:e], nw, s)
    return RecordGraph(rows=rows, scale=scale, r=r, d=d)


def update_record_rows(rows, data_q, norms, adj_rows, row_ids, nw: int):
    """Repack a scattered set of record rows in place (and return them):
    the incremental maintenance behind construction-time acceleration.
    row_ids [B] int32 (PAD_ID entries dropped); adj_rows [B, R] the new
    adjacency of those rows."""
    keep = row_ids >= 0
    rows[row_ids[keep].long()] = _pack(data_q, norms, adj_rows[keep], nw,
                                       rows.shape[1])
    return rows


def _split_query(q: torch.Tensor, d: int, nw: int) -> torch.Tensor:
    """[Q, d] -> [Q, 4, nw] bf16, dim k*nw + w at [:, k, w]."""
    qf = q.float()
    if 4 * nw > d:
        qf = torch.nn.functional.pad(qf, (0, 4 * nw - d))
    return qf.reshape(q.shape[0], 4, nw).to(torch.bfloat16)


def _byte_order(q_split: torch.Tensor) -> torch.Tensor:
    """[Q, 4, nw] -> [Q, 4 nw] with element 4w + k = quarter k, word w: the
    order of a record's vector bytes."""
    return q_split.transpose(1, 2).reshape(q_split.shape[0], -1)


def _record_dists(q_w, rows_g, scale: float, r: int, nw: int, metric: str):
    """rows_g [Q, E, S, 128] gathered records -> (dists [Q, E*R] f32, ids
    [Q, E*R] int32). q_w [Q, 4 nw]: the bf16-rounded query in byte order
    (f32 or bf16)."""
    qn, e = rows_g.shape[:2]
    flat = rows_g.reshape(qn, e, -1)
    vec = flat[..., : r * nw].view(torch.int8)     # no copy: a strided view
    dots = f32_dots(vec.reshape(qn, e * r, 4 * nw), q_w[:, None, :])[..., 0]
    ids = flat[..., r * nw : r * nw + r].reshape(qn, -1)
    if metric in ("ip", "cosine"):
        cd = 1.0 - scale * dots
    else:
        nb = flat[..., r * nw + r : r * nw + 2 * r].reshape(qn, -1)
        cd = nb.view(torch.float32) - (2.0 * scale) * dots
    return torch.where(ids >= 0, cd, PAD_DIST), ids


def beam_search_records(
    queries: torch.Tensor,
    data: torch.Tensor,
    norms: torch.Tensor,
    g: RecordGraph,
    init_ids: torch.Tensor,
    width: int,
    metric: str = "l2",
    max_hops: int = 512,
    expand: int = 1,
    chunk_hops: int = 32,
    min_compact: int = 256,
) -> BeamResult:
    """Lockstep best-first search over the packed record layout.

    Semantics match ``beam.beam_search_chunked`` (hnswlib
    searchBaseLayerST / NSG Search): sorted top-``width`` retset, expand
    the closest unexpanded, merge, until every slot is expanded. The
    initial candidates are scored exactly (f32 gathered distances); hop
    distances are FastL2-form f32 from int8 dots with exact norms, so
    callers re-rank with ``inline_graph.rerank_exact``."""
    init_ids = init_ids.to(torch.int32)
    state = _start(queries, data, norms, init_ids, width, metric, expand)[1:]
    r = g.r
    nw, _ = _layout(r, g.d)
    # upcast once here, not every hop (bf16 values are exact in f32)
    q_w = _byte_order(_split_query(queries, g.d, nw)).float()

    def hop(q, sel_ids, sel_valid):
        rows_g = g.rows[sel_ids.clamp(min=0).long()]      # [Q, E, S, 128]
        cd, ci = _record_dists(q, rows_g, g.scale, r, nw, metric)
        ci = torch.where(sel_valid[:, :, None], ci.view(*sel_ids.shape, r),
                         PAD_ID).view(ci.shape)
        return torch.where(ci >= 0, cd, PAD_DIST), ci

    return run_chunks(q_w, state, hop, width, max_hops, expand, chunk_hops,
                      min_compact)
