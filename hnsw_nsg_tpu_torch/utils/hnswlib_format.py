"""Byte-compatible reader/writer for hnswlib's binary index format.

Format (hnswlib/hnswlib/hnswalg.h:685-713 saveIndex, loadIndex :716-822):
header PODs (size_t offsetLevel0, max_elements, cur_element_count,
size_data_per_element, label_offset, offsetData; int32 maxlevel; uint32
enterpoint; size_t maxM, maxM0, M; double mult; size_t ef_construction),
then the level-0 arena (per node: [uint16 link_count, uint16 flags,
maxM0 x uint32 ids], vector f32 payload, uint64 label), then per node a
uint32 linkListSize followed by that many bytes of upper-level link blocks
([uint16 count, uint16 pad, maxM x uint32] per level).

The deleted mark is bit 0 of the flags uint16 (DELETE_MARK, hnswalg.h delete
machinery :853-937). dim is derived from the arena stride, so indices built
by the reference load without extra metadata.

Both directions are fully vectorized (the only per-node Python work is the
offset walk over the variable-length tail, which the format's sequential
length prefixes force).

A copy of hnsw_nsg_tpu/utils/hnswlib_format.py (numpy and struct only):
the files it writes are byte-equal to that module's on the same arrays.
"""

from __future__ import annotations

import struct

import numpy as np

PAD_ID = -1
_HEADER = struct.Struct("<QQQQQQiIQQQdQ")


def _parse_tail(tail: bytes, n: int, size_links_per: int, max_m: int):
    """Parse the per-node [u32 linkListSize][blocks...] tail.

    The length prefixes chain sequentially, so a light Python walk collects
    the offsets; everything else (block extraction, count masking, per-level
    scatter) is vectorized numpy.
    """
    offs_l = []
    lls_l = []
    pos = 0
    for _ in range(n):
        offs_l.append(pos)
        v = int.from_bytes(tail[pos : pos + 4], "little")
        lls_l.append(v)
        pos += 4 + v
    offs = np.asarray(offs_l, np.int64)
    lls = np.asarray(lls_l, np.int64)

    levels = (lls // size_links_per).astype(np.int32)
    nz = np.nonzero(lls)[0]
    adj_up: list[np.ndarray] = []
    if len(nz) == 0:
        return levels, adj_up

    tb = np.frombuffer(tail, dtype=np.uint8)
    lv = levels[nz].astype(np.int64)
    total = int(lv.sum())
    node_rep = np.repeat(np.arange(len(nz)), lv)
    block_in_node = np.arange(total) - np.repeat(np.cumsum(lv) - lv, lv)
    block_starts = (offs[nz] + 4)[node_rep] + block_in_node * size_links_per
    byte_idx = block_starts[:, None] + np.arange(size_links_per)[None, :]
    blocks = tb[byte_idx]  # [total, size_links_per]
    cnts = blocks[:, 0:2].copy().view(np.uint16)[:, 0]
    # node ids fit int32 (tableint <= max_elements), so view + in-place
    # masked fill avoids int64 temporaries
    rows = blocks[:, 4:].copy().view(np.int32).reshape(total, max_m)
    rows[np.arange(max_m)[None, :] >= cnts[:, None]] = PAD_ID

    n_levels = int(levels.max())
    for l in range(1, n_levels + 1):
        a = np.full((n, max_m), PAD_ID, np.int32)
        sel = block_in_node == (l - 1)
        a[nz[node_rep[sel]]] = rows[sel]
        adj_up.append(a)
    return levels, adj_up


def read_hnswlib_index(path: str):
    """-> dict with data [n, dim] f32, labels [n] i64, levels [n] i32,
    adj0 [n, maxM0] i32 (PAD_ID padded), adj_up list of [n, maxM] i32,
    deleted [n] bool, plus meta (M, maxM0, ef_construction, mult,
    enterpoint, maxlevel, max_elements)."""
    with open(path, "rb") as f:
        hdr = f.read(_HEADER.size)
        (offset_level0, max_elements, n, stride, label_off, data_off,
         maxlevel, enterpoint, max_m, max_m0, m, mult, efc) = \
            _HEADER.unpack(hdr)
        arena = np.frombuffer(f.read(n * stride), dtype=np.uint8)
        arena = arena.reshape(n, stride)
        tail = f.read()

    dim = (label_off - data_off) // 4
    counts = arena[:, 0:2].copy().view(np.uint16)[:, 0]
    flags = arena[:, 2:4].copy().view(np.uint16)[:, 0]
    adj0 = arena[:, 4 : 4 + max_m0 * 4].copy().view(np.int32).reshape(
        n, max_m0
    )
    adj0[np.arange(max_m0)[None, :] >= counts[:, None]] = PAD_ID
    data = arena[:, data_off : data_off + dim * 4].copy().view(
        np.float32
    ).reshape(n, dim)
    labels = arena[:, label_off : label_off + 8].copy().view(
        np.int64
    )[:, 0]
    deleted = (flags & 1).astype(bool)

    size_links_per = max_m * 4 + 4
    levels, adj_up = _parse_tail(tail, n, size_links_per, max_m)

    if enterpoint == 0xFFFFFFFF:  # unsigned wrap of the empty-index -1
        enterpoint = PAD_ID
    return {
        "data": data, "labels": labels, "levels": levels, "adj0": adj0,
        "adj_up": adj_up, "deleted": deleted,
        "M": m, "maxM": max_m, "maxM0": max_m0, "ef_construction": efc,
        "mult": mult, "enterpoint": enterpoint, "maxlevel": maxlevel,
        "max_elements": max_elements,
    }


def write_hnswlib_index(
    path: str, data, labels, levels, adj0, adj_up, deleted,
    m: int, ef_construction: int, enterpoint: int, maxlevel: int,
    mult: float | None = None,
):
    """Write an index loadable by the reference's loadIndex."""
    data = np.ascontiguousarray(data, np.float32)
    n, dim = data.shape
    max_m, max_m0 = m, 2 * m
    if mult is None:
        mult = 1.0 / np.log(max(m, 2))
    size_links0 = 4 + max_m0 * 4
    data_off = size_links0
    label_off = data_off + dim * 4
    stride = label_off + 8
    size_links_per = max_m * 4 + 4

    if n == 0:
        with open(path, "wb") as f:
            f.write(_HEADER.pack(
                0, 0, 0, stride, label_off, data_off,
                int(maxlevel), int(enterpoint) & 0xFFFFFFFF,
                max_m, max_m0, m, float(mult), ef_construction,
            ))
        return

    arena = np.zeros((n, stride), np.uint8)
    # ascontiguousarray: device arrays can come back F-ordered, and
    # .view(np.uint8) below requires a contiguous last axis
    adj0 = np.ascontiguousarray(np.asarray(adj0)[:, :max_m0])
    counts = (adj0 >= 0).sum(axis=1).astype(np.uint16)
    flags = np.where(np.asarray(deleted), 1, 0).astype(np.uint16)
    arena[:, 0:2] = counts[:, None].view(np.uint8).reshape(n, 2)
    arena[:, 2:4] = flags[:, None].view(np.uint8).reshape(n, 2)
    links = np.ascontiguousarray(
        np.where(adj0 >= 0, adj0, 0), np.uint32
    )
    if adj0.shape[1] < max_m0:
        links = np.pad(links, ((0, 0), (0, max_m0 - adj0.shape[1])))
    arena[:, 4 : 4 + max_m0 * 4] = links.view(np.uint8).reshape(n, -1)
    arena[:, data_off : data_off + dim * 4] = data.view(np.uint8).reshape(
        n, -1
    )
    arena[:, label_off:] = np.asarray(labels, np.int64)[:, None].view(
        np.uint8
    ).reshape(n, 8)

    # tail: per node u32 linkListSize + level blocks, assembled vectorized
    levels = np.clip(np.asarray(levels, np.int64), 0, None)
    lls = levels * size_links_per
    offs = 4 * np.arange(n, dtype=np.int64) + np.concatenate(
        [[0], np.cumsum(lls)[:-1]]
    )
    tail = np.zeros(int(4 * n + lls.sum()), np.uint8)
    hdr_idx = offs[:, None] + np.arange(4)[None, :]
    tail[hdr_idx] = lls.astype("<u4")[:, None].view(np.uint8).reshape(n, 4)

    nz = np.nonzero(levels)[0]
    if len(nz):
        lv = levels[nz]
        total = int(lv.sum())
        node_rep = np.repeat(np.arange(len(nz)), lv)
        block_in_node = np.arange(total) - np.repeat(np.cumsum(lv) - lv, lv)
        blocks = np.zeros((total, size_links_per), np.uint8)
        nodes = nz[node_rep]
        for l in range(1, int(levels.max()) + 1):
            sel = block_in_node == (l - 1)
            row = (
                np.asarray(adj_up[l - 1])[nodes[sel]][:, :max_m]
                if l - 1 < len(adj_up)
                else np.full((int(sel.sum()), max_m), PAD_ID, np.int32)
            )
            if row.shape[1] < max_m:
                row = np.pad(row, ((0, 0), (0, max_m - row.shape[1])),
                             constant_values=PAD_ID)
            cnt = (row >= 0).sum(axis=1).astype(np.uint16)
            blocks[sel, 0:2] = cnt[:, None].view(np.uint8).reshape(-1, 2)
            blocks[sel, 4:] = np.where(row >= 0, row, 0).astype(
                np.uint32
            ).view(np.uint8).reshape(-1, max_m * 4)
        block_starts = (offs[nz] + 4)[node_rep] + block_in_node * size_links_per
        byte_idx = block_starts[:, None] + np.arange(size_links_per)[None, :]
        tail[byte_idx] = blocks

    with open(path, "wb") as f:
        f.write(_HEADER.pack(
            0, n, n, stride, label_off, data_off,
            # empty index: enterpoint is PAD_ID (-1); the reference stores
            # the unsigned wrap, so mask before packing as u32
            int(maxlevel), int(enterpoint) & 0xFFFFFFFF,
            max_m, max_m0, m, float(mult), ef_construction,
        ))
        f.write(arena.tobytes())
        f.write(tail.tobytes())
