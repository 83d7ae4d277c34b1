"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the paths that run them (CNNS search, kNN graph, NSG).

Every test here is marked ``cuda`` and skips where no card is visible.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu_torch.api import Index  # noqa: E402
from hnsw_nsg_tpu_torch.models import cnns  # noqa: E402
from hnsw_nsg_tpu_torch.models.hnsw import HNSWIndex  # noqa: E402
from hnsw_nsg_tpu_torch.models.hybrid import HybridHNSWNSG  # noqa: E402
from hnsw_nsg_tpu_torch.models.kmeans import kmeans  # noqa: E402
from hnsw_nsg_tpu_torch.models.knn_ivf import knn_graph_ivf  # noqa: E402
from hnsw_nsg_tpu_torch.models.nsg import build_nsg  # noqa: E402
from hnsw_nsg_tpu_torch.models.spill import SpillCNNSIndex  # noqa: E402
from hnsw_nsg_tpu_torch.ops import cluster_scan as cs  # noqa: E402
from hnsw_nsg_tpu_torch.ops import merge_select as ms  # noqa: E402
from hnsw_nsg_tpu_torch.ops import brute_force_topk, recall  # noqa: E402
from hnsw_nsg_tpu_torch.ops.topk import init_retset  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import (  # noqa: E402
    CNNSConfig, HNSWConfig, NSGBuildConfig)
from hnsw_nsg_tpu_torch.utils.synth import (  # noqa: E402
    MERGE_STATE_KINDS, adversarial_merge_state, make_data)

PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.int8, torch.int8), (torch.bfloat16, torch.int8)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, qdt, sdt, metric, c, cap, maxc, d, qn):
    rng = np.random.default_rng(seed)

    def vals(shape, dt):
        if dt == torch.int8:
            return torch.from_numpy(
                rng.integers(-128, 128, shape).astype(np.int8))
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dt)

    qc, slabs = vals((qn, d), qdt), vals((c, maxc, d), sdt)
    valid = torch.from_numpy(rng.random((c, maxc)) < 0.8)
    valid[-1] = False                         # an all-pad cluster
    if metric == "l2":
        base, scale = (slabs.float() ** 2).sum(-1), 2.0
    else:
        base, scale = torch.ones((c, maxc)), 1.0
    bias = torch.where(valid, base, float("inf"))
    qidx = torch.from_numpy(rng.integers(0, qn, (c, cap)).astype(np.int32))
    qidx[torch.from_numpy(rng.random((c, cap)) < 0.2)] = -1
    return qc, qidx, slabs, bias, scale


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", [(8, 40, 300, 72, 200),     # ragged tiles
                                   (4, 16, 64, 960, 50)])     # large d
@pytest.mark.parametrize("qdt,sdt", PAIRS)
def test_kernel_matches_plain_version(card, qdt, sdt, shape, metric):
    """vals equal within f32 summation order (rtol 1e-5, atol 1e-3 at
    |bias| ~ 2d; exact for int8 x int8); a returned slot may differ from
    the plain version's only in a tie within that tolerance."""
    qc, qidx, slabs, bias, scale = _case(15, qdt, sdt, metric, *shape)
    args = [t.to(card) for t in (qc, qidx, slabs, bias)]
    before = cs.launches
    kv, ki = cs.grouped_cluster_topk_gq(*args, 10, scale)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    rv, _ = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, 10,
                                                 scale)
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    assert torch.equal(torch.isinf(kv[live]), torch.isinf(rv[live]))
    exact = qdt == sdt == torch.int8
    tol = dict(rtol=0.0, atol=0.0) if exact else dict(
        rtol=1e-5, atol=1e-3 if metric == "l2" else 1e-4)
    if sdt == torch.int8 and not exact:
        tol["atol"] = 0.5                     # |bias| ~ 7e5: f32 ulp 0.06
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    own = torch.gather(full, 2, ki.long())
    torch.testing.assert_close(own[fin], rv[fin], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,sdt", PAIRS)
@pytest.mark.parametrize("name,c,cap,maxc,d,qn,k", [
    ("main path", 6, 32, 300, 128, 200, 20),   # k = 2k of a replicated index
    ("cap > 32", 4, 80, 200, 64, 300, 32),     # several row blocks a cluster
    ("d = 100", 4, 32, 150, 100, 100, 10),     # rows off 16 bytes and
    ("odd d", 3, 20, 130, 37, 60, 5),          # odd d: plain-load copies
    ("d = 200", 3, 32, 140, 200, 80, 10),      # two d chunks
    # k > 32: the general kernels (tensor cores for the bf16-query pairs)
    ("k = 33", 4, 32, 300, 128, 200, 33),
    ("k = 64, cap > 32", 4, 80, 200, 64, 300, 64),
    ("k = 100, d = 100", 4, 40, 260, 100, 100, 100),
    ("k = 200, odd d", 3, 20, 300, 37, 60, 200),
    ("k = 256, d = 200", 3, 32, 300, 200, 80, 256),
    ("k = maxc, d = 960", 3, 32, 150, 960, 40, 150),
])
def test_scan_kernel_shapes(card, name, c, cap, maxc, d, qn, k, qdt, sdt):
    """The shapes the tensor-core kernels treat apart (and the same for
    the other pairs, on the same pipeline), with a cluster that has
    fewer live rows than k, an all-pad cluster and an all-pad query list.
    vals within f32 summation order (rtol 1e-5, atol 1e-3; exact for
    int8 x int8; atol 0.5 at an int8 slab's |bias| ~ 7e5); a returned
    slot that differs from the plain version's scores its value. Prints
    the count of ids that differ (near-ties)."""
    qc, qidx, slabs, bias, scale = _case(c * 100 + d, qdt, sdt, "l2", c,
                                         cap, maxc, d, qn)
    bias[1, 7:] = float("inf")                 # 7 live rows < k (k >= 10)
    qidx[0, :] = -1
    args = [t.to(card) for t in (qc, qidx, slabs, bias)]
    kern = cs.scan_kernel(qdt, sdt, d, k)
    before = cs.launches_by_kernel[kern]
    kv, ki = cs.grouped_cluster_topk_gq(*args, k, scale)
    torch.cuda.synchronize()
    assert cs.launches_by_kernel[kern] == before + 1
    rv, ri = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                  scale)
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    assert torch.equal(torch.isinf(kv[live]), torch.isinf(rv[live]))
    exact = qdt == sdt == torch.int8
    tol = dict(rtol=0.0, atol=0.0) if exact else dict(rtol=1e-5, atol=1e-3)
    if sdt == torch.int8 and not exact:
        tol["atol"] = 0.5
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    own = torch.gather(full, 2, ki.long())
    torch.testing.assert_close(own[fin], rv[fin], **tol)
    print(f"{kern} {name} {qdt}x{sdt}: near-tie ids "
          f"{int((ki[fin] != ri[fin]).sum())}/{int(fin.sum())}")
    if exact:
        assert torch.equal(ki[fin], ri[fin])
    else:
        assert (ki[fin] == ri[fin]).float().mean() >= 0.99


@pytest.mark.cuda
def test_scan_kernel_unaligned_bf16_views(card):
    """bf16 tensors that start 2 bytes off a 16-byte boundary take the
    plain-load path and give the same result."""
    qc, qidx, slabs, bias, scale = _case(31, torch.bfloat16, torch.bfloat16,
                                         "l2", 4, 32, 100, 64, 70)
    dev = [t.to(card) for t in (qc, qidx, slabs, bias)]
    want = cs.grouped_cluster_topk_gq(*dev, 10, scale)
    off = []
    for t in (dev[0], dev[2]):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        off.append(view)
    got = cs.grouped_cluster_topk_gq(off[0], dev[1], off[1], dev[3], 10,
                                     scale)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wrappers_share_the_kernel(card):
    qc, qidx, slabs, bias, scale = _case(16, torch.bfloat16, torch.bfloat16,
                                         "l2", 6, 24, 200, 48, 90)
    args = [t.to(card) for t in (qc, qidx, slabs, bias)]
    want = cs.grouped_cluster_topk_gq(*args, 10, scale)
    before = cs.launches
    got = cs.grouped_cluster_topk_gq_dblk(*args, 10, scale)
    qv = cs._gather_queries(args[0], args[1]).contiguous()
    got2 = cs.grouped_cluster_topk(qv, args[2], args[3], 10, scale)
    assert cs.launches == before + 2
    for a, b in ((got, want), (got2, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    qc, qidx, slabs, bias, scale = _case(17, torch.float32, torch.float32,
                                         "l2", 4, 8, 64, 16, 20)
    qc, qidx, slabs, bias = (t.to(card) for t in (qc, qidx, slabs, bias))
    with pytest.raises(TypeError):
        cs.grouped_cluster_topk_gq(qc, qidx.long(), slabs, bias, 10, scale)
    with pytest.raises(ValueError):
        cs.grouped_cluster_topk_gq(qc, qidx, slabs.transpose(1, 2)
                                   .contiguous().transpose(1, 2), bias, 10,
                                   scale)
    with pytest.raises(ValueError):           # mixed devices
        cs.grouped_cluster_topk_gq(qc.cpu(), qidx, slabs, bias, 10, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("sdt,k", [(torch.bfloat16, 10),
                                   (torch.int8, 10), (torch.int8, 40)])
def test_bf16_scan_past_the_tensor_core_width(card, sdt, k):
    """A bf16 query (with a bf16 or an int8 slab) with d above MAX_D_BF16
    runs on the wide kernels, the query streamed through the ring (f32
    sums of exact products in another order: rtol 1e-5, atol 1e-2 at
    |bias| ~ 2d, 0.5 at an int8 slab's |bias| ~ 7e5); a slot that differs
    scores its value."""
    d = cs.MAX_D_BF16 + 8
    qc, qidx, slabs, bias, scale = _case(41, torch.bfloat16, sdt,
                                         "l2", 4, 20, 96, d, 50)
    kern = cs.scan_kernel(torch.bfloat16, sdt, d, k)
    assert kern == ("scan_wide" if k <= cs.MAX_K else "scan_general_wide")
    before = cs.launches_by_kernel[kern]
    kv, ki = cs.grouped_cluster_topk_gq(
        *(t.to(card) for t in (qc, qidx, slabs, bias)), k, scale)
    torch.cuda.synchronize()
    assert cs.launches_by_kernel[kern] == before + 1
    rv, _ = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                 scale)
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    assert torch.equal(torch.isinf(kv[live]), torch.isinf(rv[live]))
    tol = dict(rtol=1e-5, atol=0.5 if sdt == torch.int8 else 1e-2)
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    torch.testing.assert_close(torch.gather(full, 2, ki.long())[fin],
                               rv[fin], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
def test_search_on_card_matches_cpu(card, tmp_path, slab_dtype):
    """The whole flat path on the card vs the same index on the CPU:
    ids equal in f32; in bf16 at least 99% (near-ties may swap)."""
    x, q = make_data(30000, 32, 512, "l2", seed=1)
    cpu_idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=30, m=4, kmeans_iters=6, replicate=True),
        slab_dtype=slab_dtype, device="cpu")
    cpu_idx.save(str(tmp_path / "i.npz"))
    gpu_idx = cnns.CNNSIndex.load(str(tmp_path / "i.npz"))
    cpu_idx = cnns.CNNSIndex.load(str(tmp_path / "i.npz"), device="cpu")
    for group in (False, True):
        before = cs.launches
        gd, gi = gpu_idx.search(torch.from_numpy(q).to(card), k=10,
                                nprobe=3, group=group)
        assert gi.device.type == "cuda"
        assert (cs.launches > before) == group
        cd, ci = cpu_idx.search(torch.from_numpy(q), k=10, nprobe=3,
                                group=group)
        gi, gd = gi.cpu(), gd.cpu()
        if slab_dtype == torch.float32:
            assert torch.equal(gi, ci)
        else:
            assert (gi == ci).float().mean() >= 0.99
        same = gi == ci
        torch.testing.assert_close(gd[same], cd[same], rtol=1e-5, atol=1e-3)
        assert recall(gi, ci) >= 0.99


@pytest.mark.cuda
def test_build_on_card_keeps_every_point(card):
    x, _ = make_data(20000, 16, 8, "l2", seed=2)
    idx = cnns.build_cnns(x, CNNSConfig(n_clusters=20, m=2, kmeans_iters=4,
                                        replicate=True),
                          slab_dtype=torch.bfloat16, device=card)
    assert idx.data_c.device.type == idx.reps.device.type == "cuda"
    ids = idx.ids_c.cpu().numpy()
    members = np.concatenate([row[:s] for row, s in zip(ids, idx.sizes)])
    np.testing.assert_array_equal(np.sort(members), np.arange(len(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
def test_nsg_local_search_on_card_matches_cpu(card, tmp_path, slab_dtype):
    """An nsg-local index built on the CPU, loaded on the card and on the
    CPU: the same ids through both routers (the beams' merge+select kernel
    on the card), distances within rtol 1e-5, atol 1e-3."""
    x, q = make_data(20000, 32, 256, "l2", seed=3)
    idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=20, m=3, kmeans_iters=6,
                      nsg=NSGBuildConfig(L=24, R=16, C=100)),
        local_index="nsg", slab_dtype=slab_dtype, device="cpu")
    idx.save(str(tmp_path / "n.npz"))
    gpu_idx = cnns.CNNSIndex.load(str(tmp_path / "n.npz"))
    cpu_idx = cnns.CNNSIndex.load(str(tmp_path / "n.npz"), device="cpu")
    for router in ("flat", "hnsw"):
        before = ms.launches
        gd, gi = gpu_idx.search(torch.from_numpy(q).to(card), k=10,
                                nprobe=4, l_search=64, router=router)
        assert gi.device.type == "cuda" and ms.launches > before
        cd, ci = cpu_idx.search(torch.from_numpy(q), k=10, nprobe=4,
                                l_search=64, router=router)
        assert torch.equal(gi.cpu(), ci)
        torch.testing.assert_close(gd.cpu(), cd, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.bfloat16, torch.int8])
def test_spill_search_on_card_matches_resident(card, slab_dtype):
    """The spill search on the card (groups copied from pinned host memory)
    equals the resident per-query search of the same index: distances
    equal (the same products of the same slabs), ids equal except inside
    runs of equal distance (the uint8 index's integer distances tie, and
    the two searches merge tied candidates in another order), every group
    within the budget; the slab copies live in pinned memory."""
    x, q = make_data(40000, 32, 512, "l2", seed=4,
                     uint8=slab_dtype == torch.int8)
    idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=40, m=4, kmeans_iters=6, replicate=True),
        slab_dtype=slab_dtype, device=card)
    qd = torch.from_numpy(q).to(card)
    rd, ri = idx.search(qd, k=10, nprobe=3, group=False)
    budget = 16 * idx.data_c[0].numel() * idx.data_c.element_size()
    sp = SpillCNNSIndex(idx, budget)
    assert sp.data_h.is_pinned()
    del idx
    sd, si = sp.search(qd, k=10, nprobe=3)
    assert si.device.type == "cuda"
    assert torch.equal(sd, rd)
    tied = torch.zeros_like(sd, dtype=torch.bool)
    tied[:, 1:] |= sd[:, 1:] == sd[:, :-1]
    tied[:, :-1] |= sd[:, :-1] == sd[:, 1:]
    assert torch.equal(si[~tied], ri[~tied])
    if slab_dtype == torch.bfloat16:
        assert torch.equal(si, ri)
    assert sp.stats.transfer_rounds >= 2
    assert sp.stats.peak_group_bytes <= budget


def _merge_state(seed, q, l, c, n_ids=500, fill=0.7):
    """tests/test_merge_select.py:_random_state, made with numpy: a sorted
    partly expanded retset and candidates with repeats, PADs and ties."""
    rng = np.random.default_rng(seed)
    ni = int(rng.integers(4, int(l * fill) + 4))
    ids = torch.from_numpy(rng.choice(n_ids, (q, ni)).astype(np.int32))
    d = torch.from_numpy(rng.random((q, ni)).astype(np.float32))
    r_d, r_i, r_e = init_retset(d, ids, l)
    r_e = r_e | torch.from_numpy(rng.random((q, l)) < 0.5)
    c_i = rng.choice(n_ids, (q, c)).astype(np.int32)
    c_i[rng.random((q, c)) < 0.15] = -1
    c_d = rng.random((q, c)).astype(np.float32)
    c_d[:, : c // 4] = 0.5
    return [r_d, r_i, r_e, torch.from_numpy(c_d), torch.from_numpy(c_i)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,l,c,expand", [
    (64, 128, 30, 1), (64, 128, 120, 4), (37, 64, 30, 2), (16, 256, 60, 8),
    (40, 500, 50, 1), (29, 24, 50, 1), (8, 512, 400, 3)])
def test_merge_select_kernel_bit_identical(card, q, l, c, expand):
    state = _merge_state(q * 7 + l + c, q, l, c)
    want = ms.merge_select_reference(*state, expand)
    before = ms.launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), expand)
    torch.cuda.synchronize()
    assert ms.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("l,c,expand", [
    (40, 50, 1), (100, 50, 4), (500, 50, 1), (500, 120, 4), (40, 120, 4),
    (100, 120, 1), (102, 50, 2)])               # 102: the unaligned-row path
@pytest.mark.parametrize("kind", MERGE_STATE_KINDS)
def test_merge_select_kernel_adversarial_states(card, kind, l, c, expand):
    """States that a hash table can get wrong (colliding ids, id 0, ids
    near 2**31 - 1, all candidates one retset id or one new id, an all-PAD
    retset): the kernel equals the plain version on all five outputs."""
    state = [torch.from_numpy(a) for a in adversarial_merge_state(
        kind, l * 7 + c + expand, 37, l, c)]
    want = ms.merge_select_reference(*state, expand)
    got = ms.fused_merge_select(*(t.to(card) for t in state), expand)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_merge_select_kernel_unaligned_views(card):
    """Rows that do not start on 16 bytes (a slice of a larger buffer made
    contiguous at an odd offset) take the scalar path and stay exact."""
    state = _merge_state(5, 33, 100, 50)
    want = ms.merge_select_reference(*state, 2)
    dev = []
    for t in state:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        dev.append(view)
    got = ms.fused_merge_select(*dev, 2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("l,c", [(ms.MAX_L + 1, 50), (64, ms.MAX_C + 1)])
def test_merge_select_raises_past_the_kernel_limits(card, l, c):
    """Past the warp-per-query kernel's L and C the general kernel is
    launched, and all five outputs equal the plain version's; so it is
    past the general kernel's former limits (L = 16384, C = 4096), where
    the wrapper raised. What the wrapper still raises on is a malformed
    call, and then it launches nothing."""
    state = _merge_state(1, 4, l, c)
    want = ms.merge_select_reference(*state, 1)
    before, g_before = ms.launches, ms.general_launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), 1)
    torch.cuda.synchronize()
    assert ms.launches == before + 1
    assert ms.general_launches == g_before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    wide = _merge_state(1, 2, 16385 if l > 64 else 64,
                        50 if l > 64 else 4097, n_ids=40000)
    want = ms.merge_select_reference(*wide, 1)
    got = ms.fused_merge_select(*(t.to(card) for t in wide), 1)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError):       # expand above L
        ms.fused_merge_select(*(t.to(card) for t in wide), 16386)
    assert ms.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("q,l,c,expand", [
    (6, 20000, 50, 1),       # past the former L limit, in shared memory
    (3, 40000, 64, 2),       # past shared memory: the arrays in scratch
    (4, 30000, 32, 3),       # the same
    (2, 300, 16000, 4)])     # C past shared memory
def test_merge_select_general_kernel_any_width(card, q, l, c, expand):
    from hnsw_nsg_tpu_torch.ops._build import load_library
    assert (load_library().merge_select_general_scratch(l, c) > 0) == (
        l > 25000 or c > 10000)
    state = _merge_state(q + l + c, q, l, c, n_ids=3 * l + c)
    want = ms.merge_select_reference(*state, expand)
    g_before = ms.general_launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), expand)
    torch.cuda.synchronize()
    assert ms.general_launches == g_before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("q,l,c,expand", [
    (33, 1025, 50, 1), (16, 2048, 128, 4), (9, 4096, 128, 1),
    (20, 200, 1025, 4), (5, 4096, 2048, 8), (12, 1100, 32, 1100),
    # the HNSW search's widths past the warp kernel (ef = 2048), the
    # general kernel's block of ceil(max(L, C) / 8) threads
    (24, 1025, 32, 1), (24, 2048, 32, 1), (24, 2048, 50, 1),
    (24, 4096, 32, 1), (24, 4096, 50, 1), (7, 2048, 50, 2048)])
def test_merge_select_general_kernel_bit_identical(card, q, l, c, expand):
    state = _merge_state(q + l + c, q, l, c, n_ids=3 * l)
    want = ms.merge_select_reference(*state, expand)
    g_before = ms.general_launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), expand)
    torch.cuda.synchronize()
    assert ms.general_launches == g_before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("l,c,expand", [
    (1025, 50, 1), (2048, 128, 4), (200, 1025, 2), (1025, 32, 1),
    (2048, 32, 1), (2048, 50, 1), (4096, 32, 1), (4096, 50, 1),
    (200, 1025, 4), (2048, 50, 2048),
    (30000, 32, 3)])          # L = 30000: the arrays in global scratch
@pytest.mark.parametrize("kind", MERGE_STATE_KINDS)
def test_merge_select_general_kernel_adversarial_states(card, kind, l, c,
                                                        expand):
    state = [torch.from_numpy(a) for a in adversarial_merge_state(
        kind, l * 7 + c + expand, 11, l, c)]
    want = ms.merge_select_reference(*state, expand)
    g_before = ms.general_launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), expand)
    torch.cuda.synchronize()
    assert ms.general_launches == g_before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [513, 600, 800, 1000, 1024])
@pytest.mark.parametrize("c,expand", [(32, 1), (32, 4), (128, 1), (128, 4),
                                      (32, "L")])
@pytest.mark.parametrize("kind", (*MERGE_STATE_KINDS, "random"))
def test_merge_select_warp_kernel_32_slots(card, kind, l, c, expand):
    """L = 513..1024 runs the warp-per-query kernel at 32 retset slots a
    lane (not the general kernel), bit for bit equal to the plain version
    on all five outputs, on adversarial and random states. expand = L
    takes the frontier's loop past one ballot of 32 and fills the select
    slots past those taken with PAD_ID and false."""
    if expand == "L":
        expand = l
    if kind == "random":
        state = _merge_state(l + c + expand, 24, l, c, n_ids=3 * l)
    else:
        state = [torch.from_numpy(a) for a in adversarial_merge_state(
            kind, l * 5 + c + expand, 21, l, c)]
    want = ms.merge_select_reference(*state, expand)
    before, g_before = ms.launches, ms.general_launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), expand)
    torch.cuda.synchronize()
    assert ms.launches == before + 1 and ms.general_launches == g_before
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("l,c", [(1024, 1024), (1025, 32), (1024, 1025)])
def test_merge_select_kernel_boundary(card, l, c):
    """The warp kernel takes L <= 1024 and C <= 1024; one past either runs
    the general kernel. All five outputs equal the plain version's."""
    state = _merge_state(l + 3 * c, 10, l, c, n_ids=2 * l + c)
    want = ms.merge_select_reference(*state, 3)
    g_before = ms.general_launches
    got = ms.fused_merge_select(*(t.to(card) for t in state), 3)
    torch.cuda.synchronize()
    assert ms.general_launches == g_before + (l > 1024 or c > 1024)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_merge_select_kernel_all_pad_and_converged(card):
    r_d, r_i, r_e, c_d, c_i = _merge_state(3, 8, 64, 16)
    c_d.fill_(3.4e37)
    c_i.fill_(-1)
    for flags in (r_e, torch.ones_like(r_e)):
        state = [r_d, r_i, flags, c_d, c_i]
        want = ms.merge_select_reference(*state, 4)
        got = ms.fused_merge_select(*(t.to(card) for t in state), 4)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    assert not got[4].any() and bool((got[3] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mm,k,metric", [(128, 4, "l2"), (1024, 4, "l2"),
                                         (4224, 52, "l2"), (512, 6, "ip")])
def test_cluster_join_kernel_matches_plain(card, dtype, mm, k, metric):
    """vals allclose (f32 sums of exact products in another order); ids
    equal where finite, or a near-tie whose slot scores the same."""
    rng = np.random.default_rng(mm + k)
    c, maxc, d = 5, 70, 48
    qv = torch.from_numpy(rng.standard_normal((c, maxc, d)).astype(
        np.float32)).to(dtype)
    st = torch.from_numpy(rng.standard_normal((c, mm, d)).astype(
        np.float32)).to(dtype)
    valid = torch.from_numpy(rng.random((c, mm)) < 0.8)
    valid[-1, k // 2:] = False          # fewer finite buckets than k
    if metric == "l2":
        base, scale = (st.float() ** 2).sum(-1), 2.0
    else:
        base, scale = torch.ones((c, mm)), 1.0
    bias = torch.where(valid, base, float("inf"))
    rv, ri = cs.cluster_join_topk(qv, st, bias, k, scale)
    before = cs.join_launches
    by_kernel = cs.join_launches_by_kernel[cs.JOIN_KERNELS[dtype]]
    kv, ki = cs.cluster_join_topk(qv.to(card), st.to(card), bias.to(card),
                                  k, scale)
    torch.cuda.synchronize()
    assert cs.join_launches == before + 1
    assert cs.join_launches_by_kernel[cs.JOIN_KERNELS[dtype]] == by_kernel + 1
    kv, ki = kv.cpu(), ki.cpu()
    fin = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(kv), fin)
    tol = dict(rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - scale * cs.f32_dots(qv, st)
    own = torch.gather(full, 2, ki.long())
    torch.testing.assert_close(own[fin], rv[fin], **tol)
    assert (ki[fin] == ri[fin]).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("c,maxc,mm,d,k,metric,sparse_last,rows", [
    (3, 150, 1600, 128, 8, "l2", None, 128),   # group 8, g = 200: ragged tile
    (2, 130, 1024, 960, 10, "l2", None, 128),  # d = 960: the query streams
    (3, 96, 512, 100, 10, "l2", None, 128),    # d padded to 104
    (3, 200, 2048, 64, 16, "l2", None, 128),   # maxc not a multiple of 128
    (2, 128, 8192, 128, 64, "l2", None, 128),  # k = 64
    (3, 64, 512, 128, 20, "l2", 5, 128),       # sparse last cluster: inf tail
    (2, 32, 2048, 128, 20, "ip", None, 128),   # ip, group 4
    # k > 64 (a kNN graph of k > 62): 128 rows while the heaps fit
    # (k <= 110, 80 when the query streams), 64 above, the heaps in global
    # scratch past k = 285 (279)
    (2, 150, 8192, 128, 65, "l2", 40, 128),    # sparse last: 40 < k finite
    (3, 150, 8192, 128, 102, "l2", 40, 128),
    (2, 100, 16384, 128, 202, "l2", 60, 64),
    (2, 130, 4096, 960, 102, "l2", None, 64),  # the query streams
    (3, 96, 4096, 100, 102, "l2", None, 128),  # d padded to 104
    (2, 70, 8192, 64, 450, "l2", 30, 64),      # heaps in global scratch
    (2, 70, 8192, 960, 300, "l2", None, 64),   # the same, streamed query
])
def test_cluster_join_bf16_tensor_cores(card, c, maxc, mm, d, k, metric,
                                        sparse_last, rows):
    """The tensor-core kernel vs the plain version on the same bf16
    inputs, at every k: vals allclose where finite (f32 sums of exact
    products in another order; atol 1e-3 at |bias| ~ 2d, 5e-3 at d = 960),
    the +inf pattern and its buckets equal, ids equal except at near-ties,
    whose slot must score the plain value within the tolerance."""
    rng = np.random.default_rng(c * maxc + mm + d + k)
    qv = torch.from_numpy(rng.standard_normal((c, maxc, d)).astype(
        np.float32)).to(torch.bfloat16)
    st = torch.from_numpy(rng.standard_normal((c, mm, d)).astype(
        np.float32)).to(torch.bfloat16)
    sizes = rng.integers(mm // 2, mm + 1, c)
    if sparse_last is not None:
        sizes[-1] = sparse_last
    valid = torch.from_numpy(np.arange(mm)[None, :] < sizes[:, None])
    if metric == "l2":
        base, scale = (st.float() ** 2).sum(-1), 2.0
    else:
        base, scale = torch.ones((c, mm)), 1.0
    bias = torch.where(valid, base, float("inf"))
    rv, ri = cs.cluster_join_topk_reference(qv, st, bias, k, scale)
    before = cs.join_launches
    mma = cs.join_launches_by_kernel["join_mma_kernel"]
    assert cs.join_block_rows(d, k, torch.bfloat16) == rows
    kv, ki = cs.cluster_join_topk(qv.to(card), st.to(card), bias.to(card),
                                  k, scale)
    torch.cuda.synchronize()
    assert cs.join_launches == before + 1
    assert cs.join_launches_by_kernel["join_mma_kernel"] == mma + 1
    kv, ki = kv.cpu(), ki.cpu()
    fin = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(kv), fin)
    assert torch.equal(ki[~fin], ri[~fin])
    tol = dict(rtol=1e-5, atol=5e-3 if d > 512 else 1e-3)
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    mism = (ki != ri) & fin
    full = bias[:, None, :] - scale * cs.f32_dots(qv, st)
    own = torch.gather(full, 2, ki.long())
    torch.testing.assert_close(own[mism], rv[mism], **tol)
    assert int(mism.sum()) <= max(2, int(fin.sum()) // 100)


@pytest.mark.cuda
def test_knn_graph_on_card_repeats(card):
    """Two kNN graphs of the same card data are equal (k-means sums in a
    fixed order; the join's merge order does not depend on timing)."""
    x, _ = make_data(20000, 32, 8, "l2", seed=5)
    xd = torch.from_numpy(x).to(card)
    a1 = knn_graph_ivf(xd, 16, n_clusters=20, probes=4, as_device=True)
    a2 = knn_graph_ivf(xd, 16, n_clusters=20, probes=4, as_device=True)
    assert a1.device.type == "cuda" and torch.equal(a1, a2)


@pytest.mark.cuda
def test_kmeans_on_card_is_deterministic(card):
    x, _ = make_data(60000, 32, 8, "l2", seed=4)
    xd = torch.from_numpy(x).to(card)
    c1, a1 = kmeans(xd, 64, iters=5, seed=0)
    c2, a2 = kmeans(xd, 64, iters=5, seed=0)
    assert torch.equal(a1, a2) and torch.equal(c1, c2)


@pytest.mark.cuda
def test_nsg_build_and_search_on_card(card):
    """kNN graph, NSG build and search on the card, launching both new
    kernels; the graph is connected and recall@10 is high."""
    x, q = make_data(20000, 32, 256, "l2", seed=3)
    xd, qd = torch.from_numpy(x).to(card), torch.from_numpy(q).to(card)
    j0, m0 = cs.join_launches, ms.launches
    adj = knn_graph_ivf(xd, 24, n_clusters=20, probes=6, as_device=True)
    assert adj.device.type == "cuda" and cs.join_launches > j0
    idx = build_nsg(xd, adj, NSGBuildConfig(L=24, R=16, C=120))
    assert idx.adj.device.type == "cuda" and ms.launches > m0
    m1 = ms.launches
    _, ids = idx.search(qd, k=10, l_search=64)
    assert ms.launches > m1
    _, gt = brute_force_topk(qd, xd, 10)
    assert recall(ids, gt) >= 0.9


@pytest.mark.cuda
def test_hnsw_two_card_builds_of_one_seed_are_one_graph(card):
    """The reverse-edge round picks, among proposals that collide on one
    (destination, column), the last in flattened order: two card builds
    of a seed are the same graph at every level, and it is the CPU's
    levels and enterpoint too."""
    x, _ = make_data(6000, 32, 8, "l2", seed=6)
    built = []
    for dev in (None, None, "cpu"):
        idx = HNSWIndex(32, 6000, HNSWConfig(M=8, ef_construction=48),
                        device=dev)
        idx.add_items(x, batch_size=2048)
        built.append(idx)
    a, b, c = built
    assert a.adj0.device.type == "cuda"
    assert torch.equal(a.adj0, b.adj0) and len(a.adj_up) == len(b.adj_up)
    assert all(torch.equal(u, v) for u, v in zip(a.adj_up, b.adj_up))
    assert a.check_integrity()
    np.testing.assert_array_equal(a.levels, c.levels)
    assert (a.ep, a.max_level) == (c.ep, c.max_level)


@pytest.fixture(scope="module")
def hnsw_file(tmp_path_factory):
    """One graph built on the CPU and its queries, as an .npz."""
    if not torch.cuda.is_available():      # made before `card` can skip
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, q = make_data(5000, 32, 256, "l2", seed=7)
    idx = HNSWIndex(32, 5000, HNSWConfig(M=8, ef_construction=48),
                    device="cpu")
    idx.add_items(x, batch_size=2048)
    path = str(tmp_path_factory.mktemp("hnsw") / "h.npz")
    idx.save(path)
    return path, q


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "deleted", "filtered", "ef=600",
                                  "ef=1100"])
def test_hnsw_query_on_card_matches_cpu(card, hnsw_file, mode):
    """One graph (built on the CPU, carried by the .npz) searched on the
    card and on the CPU: labels equal at >= 99.9% of the slots (f32 sums
    in another order may swap a near-tie), distances allclose 1e-4. ef=600
    runs merge+select's warp kernel at 32 slots a lane, ef=1100 its
    general kernel."""
    path, q = hnsw_file
    gpu, cpu = HNSWIndex.load(path), HNSWIndex.load(path, device="cpu")
    assert gpu.data.device.type == "cuda"
    kw = dict(k=10, ef={"ef=600": 600, "ef=1100": 1100}.get(mode, 64))
    if mode == "deleted":
        for lab in range(0, 400, 3):
            gpu.mark_deleted(lab)
            cpu.mark_deleted(lab)
    if mode == "filtered":
        kw["filter_ids"] = np.arange(5000) % 4 != 1
    m0, g0 = ms.launches, ms.general_launches
    for entry in ("routed", "descend"):
        gl, gd = gpu.knn_query(q, entry=entry, **kw)
        cl, cd = cpu.knn_query(q, entry=entry, **kw)
        same = gl == cl
        assert same.mean() >= 0.999
        np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)
    if mode in ("plain", "ef=600", "ef=1100"):
        assert ms.launches > m0            # the beam ran the kernel
        assert (ms.general_launches > g0) == (mode == "ef=1100")
    else:
        assert ms.launches == m0           # the filtered beam is plain ops


@pytest.mark.cuda
def test_api_and_hybrid_default_to_the_card(card):
    x, q = make_data(9000, 16, 64, "l2", seed=8)
    p = Index("l2", 16)
    p.init_index(9000, M=8, ef_construction=40)
    p.add_items(x)
    idx = p._index
    assert {idx.data.device.type, idx.adj0.device.type,
            idx.adj_up[0].device.type} == {"cuda"}
    labels, dists = p.knn_query(x[:64], k=1, ef=40)
    assert isinstance(labels, np.ndarray)
    assert (labels[:, 0] == np.arange(64)).mean() >= 0.95
    h = HybridHNSWNSG(16, 9000, HNSWConfig(M=8, ef_construction=40),
                      NSGBuildConfig(L=24, R=16, C=100))
    h.add_points(x)
    _, gt = brute_force_topk(torch.from_numpy(q).to(card),
                             torch.from_numpy(x).to(card), 10)
    # the default build at 8,192 < N <= 200,000 (rp-trees + nn-descent),
    # then one from a passed graph
    m0 = ms.launches
    stats = {}
    h.build_nsg_layer(stats=stats)
    assert {"rp_trees", "nndescent"} <= set(stats) and ms.launches > m0
    for knn in (None, knn_graph_ivf(h.hnsw.data[: h.n], 34, n_clusters=12,
                                    probes=4, as_device=True)):
        if knn is not None:
            h.build_nsg_layer(knn_adj=knn)
        assert h.nsg.adj.device.type == h.hnsw.data.device.type == "cuda"
        hl, _ = h.search_knn(q, k=10, l_search=64)
        assert recall(hl, gt) >= 0.9


# -- the general scan (k > 32), the join past k = 64, and the records ------

@pytest.mark.cuda
@pytest.mark.parametrize("qdt,sdt", PAIRS)
@pytest.mark.parametrize("k", [33, 64, 100, 200, 256, "maxc"])
def test_general_scan_kernel_matches_plain(card, qdt, sdt, k):
    """k > 32 runs a general kernel (on bf16 tensor cores for a bf16 query
    with a bf16 or int8 slab, on s8 tensor cores for int8 x int8, in exact
    FMAs on the same pipeline for f32): vals
    within f32 summation
    order (rtol 1e-5, atol 1e-3; exact for int8 x int8; atol 0.5 at an
    int8 slab's |bias| ~ 7e5); ids equal except where a near-tie swaps,
    and a returned slot scores its value. The +inf tail comes back with
    the plain version's slots."""
    c, cap, maxc, d, qn = 5, 40, 260, 72, 150
    k = maxc if k == "maxc" else k
    qc, qidx, slabs, bias, scale = _case(k + 31, qdt, sdt, "l2", c, cap,
                                         maxc, d, qn)
    bias[1, 20:] = float("inf")               # fewer live slots than k
    rv, ri = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                  scale)
    kern = cs.scan_kernel(qdt, sdt, d, k)
    assert kern in ("scan_general_mma", "scan_general_i8", "scan_general_f32",
                    "scan_general_wide")
    before, k0 = cs.launches, cs.launches_by_kernel[kern]
    kv, ki = cs.grouped_cluster_topk_gq(
        *(t.to(card) for t in (qc, qidx, slabs, bias)), k, scale)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    assert cs.launches_by_kernel[kern] == k0 + 1
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    assert torch.equal(torch.isinf(kv[live]), torch.isinf(rv[live]))
    exact = qdt == sdt == torch.int8
    tol = dict(rtol=0.0, atol=0.0) if exact else dict(rtol=1e-5, atol=1e-3)
    if sdt == torch.int8 and not exact:
        tol["atol"] = 0.5
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    torch.testing.assert_close(torch.gather(full, 2, ki.long())[fin],
                               rv[fin], **tol)
    inf = live & torch.isinf(rv)
    assert torch.equal(ki[inf], ri[inf])
    print(f"{kern} k={k} {qdt}x{sdt}: near-tie ids "
          f"{int((ki[fin] != ri[fin]).sum())}/{int(fin.sum())}")
    if exact:
        assert torch.equal(ki[live], ri[live])
    else:
        assert (ki[fin] == ri[fin]).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,sdt,k,in_scratch", [
    # int8 x int8 on s8 tensor cores at d <= 128: past k = 306 (its query
    # tile is half SQ8's)
    (torch.int8, torch.int8, 500, True),
    (torch.int8, torch.int8, 306, False),
    (torch.int8, torch.int8, 307, True),
    # the f32 pipeline's at d = 32: past k = 250, as bf16's
    (torch.float32, torch.float32, 250, False),
    (torch.float32, torch.float32, 251, True),
    (torch.float32, torch.float32, 500, True),
    # the tensor-core kernel's at d <= 128: past k = 250 (bf16 slabs),
    # k = 298 (int8 slabs, whose ring stages are smaller)
    (torch.bfloat16, torch.bfloat16, 250, False),
    (torch.bfloat16, torch.bfloat16, 251, True),
    (torch.bfloat16, torch.bfloat16, 500, True),
    (torch.bfloat16, torch.int8, 298, False),
    (torch.bfloat16, torch.int8, 299, True),
])
def test_general_scan_kernel_large_k_in_scratch(card, qdt, sdt, k,
                                                in_scratch):
    """k on both sides of what shared memory holds of the rows' buffers:
    past it they go to global scratch. vals within the tolerances above;
    a returned slot scores its value."""
    from hnsw_nsg_tpu_torch.ops._build import load_library

    c, cap, maxc, d, qn = 3, 40, 900, 32, 60
    qc, qidx, slabs, bias, scale = _case(77, qdt, sdt, "l2", c, cap, maxc,
                                         d, qn)
    codes = (cs._DTYPE_CODE[qdt], cs._DTYPE_CODE[sdt])
    assert (load_library().grouped_scan_general_scratch(
        c, cap, d, k, *codes) > 0) == in_scratch
    rv, ri = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                  scale)
    kv, ki = cs.grouped_cluster_topk_gq(
        *(t.to(card) for t in (qc, qidx, slabs, bias)), k, scale)
    torch.cuda.synchronize()
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    tol = dict(rtol=1e-5, atol=0.5 if sdt == torch.int8 else 1e-3)
    torch.testing.assert_close(kv[live], rv[live], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    torch.testing.assert_close(torch.gather(full, 2, ki.long())[fin],
                               rv[fin], **tol)
    assert (ki[live] == ri[live]).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, "maxc"])
def test_sq8_search_on_card_keeps_pad_dist(card, tmp_path, k):
    """F-R2 on the card: an SQ8 index (int8 slabs of non-integral data)
    with qscale >= 2 returns PAD_DIST, not inf, in the unfilled slots of
    a search past one cluster's fill, at k = 32 (scan_mma) and k = maxc
    = 40 (scan_general_mma); its ids equal the CPU search's but for
    near-ties."""
    from hnsw_nsg_tpu_torch.ops.distance import PAD_DIST

    x, q = make_data(300, 16, 8, "l2", seed=5)
    x, q = x * 100, q * 100
    cpu_idx = cnns.build_cnns(x, CNNSConfig(n_clusters=16, m=2,
                                            kmeans_iters=4),
                              slab_dtype=torch.int8, device="cpu")
    assert cpu_idx.qscale >= 2.0 and cpu_idx.maxc > 32
    k = cpu_idx.maxc if k == "maxc" else k
    cpu_idx.save(str(tmp_path / "s.npz"))
    gpu_idx = cnns.CNNSIndex.load(str(tmp_path / "s.npz"))
    kern = cs.scan_kernel(torch.bfloat16, torch.int8, 16, k)
    before = cs.launches_by_kernel[kern]
    gd, gi = gpu_idx.search(torch.from_numpy(q).to(card), k=k, nprobe=1,
                            group=True)
    assert cs.launches_by_kernel[kern] > before
    cd, ci = cpu_idx.search(torch.from_numpy(q), k=k, nprobe=1, group=True)
    gd, gi = gd.cpu(), gi.cpu()
    pad = gi < 0
    assert pad.any()
    assert bool((gd[pad] == float(PAD_DIST)).all())
    assert bool(torch.isfinite(gd).all())
    assert torch.equal(pad, ci < 0)
    assert (gi == ci).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mm,k", [(2048, 65), (4224, 102), (8192, 200),
                                  (1024, 450)])          # k = 450: scratch
def test_general_join_kernel_matches_plain(card, dtype, mm, k):
    """k > 64 in f32 runs the general join kernel, in bf16 the tensor-core
    kernel: vals allclose (f32 sums of exact products in another order:
    rtol 1e-5, atol 1e-3 at |bias| ~ 2d), the +inf pattern and its buckets
    equal, ids equal but for near-ties whose slot scores the plain
    value."""
    rng = np.random.default_rng(mm + k)
    c, maxc, d = 3, 45, 40
    qv = torch.from_numpy(rng.standard_normal((c, maxc, d)).astype(
        np.float32)).to(dtype)
    st = torch.from_numpy(rng.standard_normal((c, mm, d)).astype(
        np.float32)).to(dtype)
    valid = torch.from_numpy(rng.random((c, mm)) < 0.8)
    valid[-1, k // 2:] = False          # fewer finite buckets than k
    bias = torch.where(valid, (st.float() ** 2).sum(-1), float("inf"))
    rv, ri = cs.cluster_join_topk(qv, st, bias, k, 2.0)
    name = cs.JOIN_KERNELS[dtype]
    before, g0 = cs.join_launches, cs.join_launches_by_kernel[name]
    kv, ki = cs.cluster_join_topk(qv.to(card), st.to(card), bias.to(card),
                                  k, 2.0)
    torch.cuda.synchronize()
    assert cs.join_launches == before + 1
    assert cs.join_launches_by_kernel[name] == g0 + 1
    kv, ki = kv.cpu(), ki.cpu()
    fin = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(kv), fin)
    assert torch.equal(ki[~fin], ri[~fin])
    tol = dict(rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - 2.0 * cs.f32_dots(qv, st)
    torch.testing.assert_close(torch.gather(full, 2, ki.long())[fin],
                               rv[fin], **tol)
    assert (ki[fin] == ri[fin]).float().mean() >= 0.99


# -- the f32 join (join_f32_kernel) and the general merge+select ---------


def _f32_join_case(seed, c, maxc, mm, d, integer=False):
    rng = np.random.default_rng(seed)
    if integer:   # every product and f32 sum exact: equal bits expected
        qv = rng.integers(-6, 7, (c, maxc, d)).astype(np.float32)
        st = rng.integers(-6, 7, (c, mm, d)).astype(np.float32)
    else:
        qv = rng.standard_normal((c, maxc, d)).astype(np.float32)
        st = rng.standard_normal((c, mm, d)).astype(np.float32)
    qv, st = torch.from_numpy(qv), torch.from_numpy(st)
    valid = torch.from_numpy(rng.random((c, mm)) < 0.8)
    bias = torch.where(valid, (st ** 2).sum(-1), float("inf"))
    return qv, st, bias


def _check_f32_join(card, qv, st, bias, k, exact=False):
    """join_f32_kernel against the plain version on the same inputs: the
    +inf pattern and every id equal (the +inf entries' buckets too), vals
    within f32 summation order (rtol 1e-5, atol 1e-3 at |bias| ~ 2d), or
    equal when every sum is exact."""
    rv, ri = cs.cluster_join_topk_reference(qv, st, bias, k, 2.0)
    before = cs.join_launches_by_kernel["join_f32_kernel"]
    kv, ki = cs.cluster_join_topk(qv.to(card), st.to(card), bias.to(card),
                                  k, 2.0)
    torch.cuda.synchronize()
    assert cs.join_launches_by_kernel["join_f32_kernel"] == before + 1
    kv, ki = kv.cpu(), ki.cpu()
    fin = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(kv), fin)
    assert torch.equal(ki, ri)
    if exact:
        assert torch.equal(kv, rv)
    else:
        torch.testing.assert_close(kv[fin], rv[fin], rtol=1e-5, atol=1e-3)
    return fin


@pytest.mark.cuda
@pytest.mark.parametrize("group,mm,k,d", [
    (1, 99, 1, 37), (2, 512, 10, 37), (4, 1024, 10, 37),
    (8, 16896, 52, 37), (8, 4096, 1, 37), (4, 16896, 102, 37),
    (1, 2700, 107, 37), (1, 2725, 108, 37),      # the query resident
    (8, 16896, 52, 200), (1, 3500, 140, 200),    # the query streamed
    (1, 3525, 141, 200)])
@pytest.mark.parametrize("integer", [False, True])
def test_f32_join_kernel_matches_plain(card, group, mm, k, d, integer):
    """Every bucket width, k = 1 to 141. Beside the resident query tile
    (d <= 128) k = 107 is the last whose heaps fit shared memory and 108
    the first in global scratch; beside a streamed one (d > 128) 140 and
    141. maxc = 150 is not a multiple of the 128-row tile, d = 37 and 200
    not of the 16-wide d chunk."""
    assert cs.join_group(mm, k) == group
    assert cs.join_block_rows(d, k, torch.float32) == 128
    from hnsw_nsg_tpu_torch.ops._build import load_library
    assert (load_library().cluster_join_scratch(2, 150, d, k, 0) > 0) == (
        k > (107 if d <= 128 else 140))
    qv, st, bias = _f32_join_case(mm + k + d, 2, 150, mm, d, integer)
    _check_f32_join(card, qv, st, bias, k, exact=integer)


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows", [(4, 300), (52, 1400)])
@pytest.mark.parametrize("integer", [False, True])
def test_f32_join_kernel_dead_slices(card, k, rows, integer):
    """Stacks of 8 slabs (group 8: bucket b of slab e is slot e * rows +
    b; 3 or 11 tiles of 128 buckets) with +inf tails: (tile, e) slices
    wholly +inf (skipped), partly +inf, and in the second cluster +inf for
    every e in all but two buckets, whose rows end in (+inf, b) entries,
    lowest b first."""
    qv, st, bias = _f32_join_case(7 + k, 3, 140, 8 * rows, 64, integer)
    assert cs.join_group(8 * rows, k) == 8
    slab = bias.view(3, 8, rows)
    slab[0] = (st[0] ** 2).sum(-1).view(8, rows)
    for e, size in enumerate([rows, 0, 128, 5, 256, 0, 200, 130]):
        slab[0, e, size:] = float("inf")
    slab[1] = float("inf")
    slab[1, 3, :2] = 1.0
    fin = _check_f32_join(card, qv, st, bias, k, exact=integer)
    assert fin[0].all() and not fin[1, :, 2:].any()


@pytest.mark.cuda
def test_cnns_search_at_its_default_k_on_card(card, tmp_path):
    """CNNSIndex.search(k=100), the entry point's default, on the card
    through the general kernel, against the same index on the CPU."""
    x, q = make_data(20000, 32, 256, "l2", seed=9)
    cpu_idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=20, m=4, kmeans_iters=5, replicate=True),
        slab_dtype=torch.float32, device="cpu")
    cpu_idx.save(str(tmp_path / "i.npz"))
    gpu_idx = cnns.CNNSIndex.load(str(tmp_path / "i.npz"))
    g0 = cs.launches_by_kernel["scan_general_f32"]   # f32 slabs, k = 100
    gd, gi = gpu_idx.search(torch.from_numpy(q).to(card), nprobe=3,
                            group=True)
    assert (cs.launches_by_kernel["scan_general_f32"] > g0
            and tuple(gi.shape) == (256, 100))
    cd, ci = cpu_idx.search(torch.from_numpy(q), nprobe=3, group=True)
    assert (gi.cpu() == ci).float().mean() >= 0.99
    torch.testing.assert_close(gd.cpu(), cd, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_knn_graph_and_nsg_past_the_join_limit(card):
    """knn_graph_ivf(x, 70) (join k = 72, past the former k = 64 limit of
    the tensor-core join) and an NSG with L = 60 build on the card through
    the tensor-core join kernel."""
    x, q = make_data(30000, 32, 128, "l2", seed=10)
    xd = torch.from_numpy(x).to(card)
    g0 = cs.join_launches_by_kernel["join_mma_kernel"]
    adj = knn_graph_ivf(xd, 70, as_device=True)
    assert tuple(adj.shape) == (30000, 70)
    assert cs.join_launches_by_kernel["join_mma_kernel"] > g0
    idx = build_nsg(xd, adj[:, :70], NSGBuildConfig(L=60, R=24, C=200))
    _, ids = idx.search(torch.from_numpy(q).to(card), k=10, l_search=64)
    _, gt = brute_force_topk(torch.from_numpy(q).to(card), xd, 10)
    assert recall(ids, gt) >= 0.9


def _records_case(seed, n=3000, d=20, r=14, nq=64):
    """Integer-valued data (every int8 and bf16 product and f32 sum exact),
    its exact r-NN graph and random initial ids."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-6, 7, (n, d)).astype(np.float32)
    q = rng.integers(-6, 7, (nq, d)).astype(np.float32)
    _, knn = brute_force_topk(torch.from_numpy(x), torch.from_numpy(x),
                              r + 1)
    init = rng.integers(0, n, (nq, 8)).astype(np.int32)
    return x, q, knn[:, 1:].to(torch.int32), init


@pytest.mark.cuda
def test_beam_search_records_on_card_equals_cpu(card):
    """On integer-valued data the records beam gives the same ids, dists,
    hops and evals on the card as on the CPU, and launches merge+select."""
    from hnsw_nsg_tpu_torch.models.records import (beam_search_records,
                                                   build_record_graph)

    x, q, adj, init = _records_case(21)
    out = []
    for dev in ("cpu", card):
        xt = torch.from_numpy(x).to(dev)
        norms = (xt * xt).sum(1)
        g = build_record_graph(xt, adj.to(dev), norms, scale=1.0)
        m0 = ms.launches
        res = beam_search_records(torch.from_numpy(q).to(dev), xt, norms, g,
                                  torch.from_numpy(init).to(dev), width=32,
                                  max_hops=128)
        assert (ms.launches > m0) == (dev != "cpu")
        out.append([t.cpu() for t in (g.rows, *res)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["derived", "insert"])
def test_record_rows_on_card_equal_cpu_at_a_real_scale(card, scale):
    """Float data packed at the scale build_record_graph derives
    (max|x| / 127) or at the accelerated insert's (1.25 max|x| / 127):
    quantize_rows rounds x / scale alike on the card and the CPU (a
    division, not a reciprocal), so with the same norms the rows are
    equal byte for byte."""
    from hnsw_nsg_tpu_torch.models.records import (_layout,
                                                   build_record_graph,
                                                   quantize_rows)

    x, _ = make_data(3000, 36, 1, "l2", seed=23)
    xt = torch.from_numpy(x)
    _, knn = brute_force_topk(xt, xt, 15)
    adj = knn[:, 1:].to(torch.int32)
    norms = (xt * xt).sum(1)     # one summation order for both devices
    s = None if scale == "derived" else \
        1.25 * float(np.abs(x[:1000]).max()) / 127.0
    out = []
    for dev in ("cpu", card):
        g = build_record_graph(xt.to(dev), adj.to(dev), norms.to(dev),
                               scale=s)
        q = quantize_rows(xt.to(dev), g.scale, _layout(g.r, g.d)[0])
        out.append((q.cpu(), g.rows.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.cuda
def test_hnsw_records_query_launches_merge_select(card, hnsw_file):
    """build_accel + knn_query on the card: merge+select launched on the
    records path, labels equal to the CPU's at >= 99.9% of the slots
    (exact re-rank of the same retsets), distances allclose 1e-4."""
    path, q = hnsw_file
    gpu, cpu = HNSWIndex.load(path), HNSWIndex.load(path, device="cpu")
    for idx in (gpu, cpu):
        idx.build_accel()
    m0 = ms.launches
    gl, gd = gpu.knn_query(q, k=10, ef=64)
    assert ms.launches > m0
    cl, cd = cpu.knn_query(q, k=10, ef=64)
    same = gl == cl
    assert same.mean() >= 0.999
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hnsw_accel_insert_on_card(card):
    """add_items(accel=True) on the card keeps rows equal to a fresh pack
    of the final graph, and recall stays within 0.02 of a plain insert."""
    from hnsw_nsg_tpu_torch.models.records import build_record_graph

    x, q = make_data(6000, 32, 128, "l2", seed=11)
    _, gt = brute_force_topk(torch.from_numpy(q).to(card),
                             torch.from_numpy(x).to(card), 10)
    got = []
    for accel in (True, False):
        idx = HNSWIndex(32, 6000, HNSWConfig(M=8, ef_construction=48))
        idx.add_items(x, batch_size=2048, accel=accel)
        if accel:
            g = idx._records
            fresh = build_record_graph(idx.data, idx.adj0[:, : g.r],
                                       idx.norms, scale=g.scale)
            assert torch.equal(fresh.rows, g.rows)
        labels, _ = idx.knn_query(q, k=10, ef=64)
        got.append(recall(labels, gt.cpu()))
    assert got[0] >= got[1] - 0.02


# -- the f32 scan on the ring pipeline (scan_f32, scan_general_f32) --------

def _int_case(seed, c, cap, maxc, d, qn, dtype=torch.float32, lo=-6,
              hi=7, metric="l2", dup=False):
    """Integer-valued rows in [lo, hi) (f32 rows in [-6, 6], or int8 rows
    as uint8 data shifted by 128 gives them): every product and every sum
    is exact whatever the order, so the kernels and the plain version
    agree bit for bit. L2 bias (slab norms) or ip bias 1, +inf on ~20% of
    the slots and the last cluster; ~20% pad query slots, cluster 1 with
    7 live rows, the query list of cluster 0 all pad. dup: every odd slab
    row repeats the row before it, so equal values must come back lowest
    slot first; a narrow [lo, hi) makes ties everywhere. Returns (qc,
    qidx, slabs, bias, scale)."""
    np_dt = np.int8 if dtype == torch.int8 else np.float32
    rng = np.random.default_rng(seed)
    qc = torch.from_numpy(rng.integers(lo, hi, (qn, d)).astype(np_dt))
    slabs = torch.from_numpy(rng.integers(lo, hi, (c, maxc, d)).astype(np_dt))
    if dup:
        slabs[:, 1::2] = slabs[:, 0:maxc - 1:2]
    valid = torch.from_numpy(rng.random((c, maxc)) < 0.8)
    valid[-1] = False
    valid[1, 7:] = False
    if metric == "l2":
        base, scale = (slabs.double() ** 2).sum(-1).float(), 2.0
    else:
        base, scale = torch.ones((c, maxc)), 1.0
    bias = torch.where(valid, base, float("inf"))
    qidx = torch.from_numpy(rng.integers(0, qn, (c, cap)).astype(np.int32))
    qidx[torch.from_numpy(rng.random((c, cap)) < 0.2)] = -1
    qidx[0, :] = -1
    return qc, qidx, slabs, bias, scale


# the ring pipeline's exact pairs: (widest d, heap kernel, general kernel)
_EXACT_PAIRS = {torch.float32: ("MAX_D_F32", "scan_f32", "scan_general_f32"),
                torch.int8: ("MAX_D_I8", "scan_i8", "scan_general_i8")}


def _check_exact(card, qc, qidx, slabs, bias, k, scale):
    """Launch an exact pair (f32 on integer data, or int8 x int8) on the
    card and hold it to the plain version: the pair's kernels up to its
    widest d, the wide ones (the query streamed) past it; torch.equal on vals
    and ids of every live row (the k <= 32 kernels give slot 0 in the
    +inf tail, the general ones the plain version's slots). Returns the
    plain version's vals on the live rows."""
    dt, d = qc.dtype, qc.shape[1]
    max_d, heap, general = _EXACT_PAIRS[dt]
    want_kern = ((heap, general) if d <= getattr(cs, max_d)
                 else ("scan_wide", "scan_general_wide"))[k > cs.MAX_K]
    kern = cs.scan_kernel(dt, dt, d, k)
    assert kern == want_kern
    before = cs.launches_by_kernel[kern]
    kv, ki = cs.grouped_cluster_topk_gq(
        *(t.to(card) for t in (qc, qidx, slabs, bias)), k, scale)
    torch.cuda.synchronize()
    assert cs.launches_by_kernel[kern] == before + 1
    rv, ri = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                  scale)
    live = qidx >= 0
    kv, ki, rv, ri = kv.cpu()[live], ki.cpu()[live], rv[live], ri[live]
    assert torch.equal(kv, rv)
    if k <= cs.MAX_K:
        ri = torch.where(torch.isinf(rv), 0, ri)
    assert torch.equal(ki, ri)
    return rv


@pytest.mark.cuda
@pytest.mark.parametrize("name,c,cap,maxc,d,qn,k", [
    ("bench-like", 4, 32, 300, 128, 200, 10),
    ("main path k = 20", 4, 32, 300, 128, 200, 20),
    ("k = 32", 4, 32, 300, 128, 200, 32),
    ("k = 33", 4, 32, 300, 128, 200, 33),
    ("k = 200", 3, 32, 600, 128, 200, 200),
    ("d % 4 != 0, maxc % 64 != 0", 3, 20, 130, 50, 60, 10),
    ("d % 4 != 0, k = 100", 3, 20, 300, 37, 60, 100),
    ("d = 65: two chunks", 3, 32, 200, 65, 80, 10),
    ("d = 129: past the narrow tile", 3, 32, 200, 129, 80, 32),
    ("d = 129, k = 33", 3, 32, 200, 129, 80, 33),
    ("d = 960 = MAX_D_F32", 2, 32, 150, 960, 40, 10),
    ("d = 960, k = maxc", 2, 32, 150, 960, 40, 150),
    ("d = 968: the streamed mode", 2, 32, 150, 968, 40, 10),
    ("cap = 80", 4, 80, 200, 64, 300, 32),
    ("cap = 80, k = 64", 4, 80, 200, 64, 300, 64),
    ("maxc < 64", 3, 32, 40, 16, 50, 10),
    ("maxc < 64, k = maxc", 3, 32, 40, 16, 50, 40),
    ("k = 251: buffers in scratch", 2, 40, 600, 32, 100, 251),
    ("d = 128, k = 235: buffers in scratch", 2, 32, 600, 128, 100, 235),
    ("duplicate rows", 3, 32, 200, 128, 80, 10),
    ("duplicate rows, k = 64", 3, 32, 200, 128, 80, 64),
])
def test_f32_scan_equals_plain_on_integer_data(card, name, c, cap, maxc, d,
                                               qn, k):
    """f32 x f32 on the card launches scan_f32 (k <= 32) or
    scan_general_f32 up to d = MAX_D_F32 and the wide kernels past it,
    and on integer-valued data gives the plain version's vals and ids,
    torch.equal on every live row; in the +inf tail the general kernels
    give the plain version's slots, the k <= 32 kernels slot 0."""
    qc, qidx, slabs, bias, scale = _int_case(
        c * 1000 + d + k, c, cap, maxc, d, qn, dup="duplicate" in name)
    rv = _check_exact(card, qc, qidx, slabs, bias, k, scale)
    assert bool(torch.isinf(rv).any())   # the +inf tail ran


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100])
def test_f32_scan_unaligned_views(card, k):
    """f32 tensors that start 4 bytes off a 16-byte boundary take the
    plain-load copies and give the same bits as aligned ones."""
    qc, qidx, slabs, bias, scale = _case(37, torch.float32, torch.float32,
                                         "l2", 4, 32, 200, 64, 70)
    dev = [t.to(card) for t in (qc, qidx, slabs, bias)]
    want = cs.grouped_cluster_topk_gq(*dev, k, scale)
    off = []
    for t in (dev[0], dev[2]):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        off.append(view)
    got = cs.grouped_cluster_topk_gq(off[0], dev[1], off[1], dev[3], k,
                                     scale)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- int8 x int8 on s8 tensor cores (scan_i8, scan_general_i8) -------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,c,cap,maxc,d,qn,k,metric", [
    ("k = 1", 4, 32, 300, 128, 200, 1, "l2"),
    ("bench-like k = 10", 4, 32, 300, 128, 200, 10, "l2"),
    ("main path k = 20", 4, 32, 300, 128, 200, 20, "l2"),
    ("k = 32", 4, 32, 300, 128, 200, 32, "l2"),
    ("k = 33", 4, 32, 300, 128, 200, 33, "l2"),
    ("k = 100", 3, 32, 600, 128, 200, 100, "l2"),
    ("k = 200", 3, 32, 600, 128, 200, 200, "l2"),
    ("k = maxc, maxc % 64 != 0", 3, 32, 130, 128, 60, 130, "l2"),
    ("ip, maxc % 64 != 0", 3, 32, 130, 128, 60, 10, "ip"),
    ("ip, k = 100", 3, 32, 300, 128, 60, 100, "ip"),
    ("d = 100: rows off 16 bytes", 3, 32, 200, 100, 80, 10, "l2"),
    ("d = 100, k = 100", 3, 32, 200, 100, 80, 100, "l2"),
    ("d = 960", 2, 32, 150, 960, 40, 10, "l2"),
    ("d = 960, k = 20", 2, 32, 150, 960, 40, 20, "l2"),
    ("d = 960, k = 200", 2, 32, 300, 960, 40, 200, "l2"),
    ("d = MAX_D_I8", 2, 32, 100, 3840, 40, 10, "l2"),
    ("d = MAX_D_I8, k = 33", 2, 32, 100, 3840, 40, 33, "l2"),
    ("d = MAX_D_I8, k = maxc", 2, 32, 100, 3840, 40, 100, "l2"),
    ("d = MAX_D_I8 + 8: streamed", 2, 32, 100, 3848, 40, 10, "l2"),
    ("d = MAX_D_I8 + 8, k = 100: streamed", 2, 32, 150, 3848, 40, 100,
     "l2"),
    ("cap = 80", 4, 80, 200, 128, 300, 10, "l2"),
    ("cap = 80, k = 32", 4, 80, 200, 128, 300, 32, "l2"),
    ("cap = 80, k = 100", 4, 80, 200, 128, 300, 100, "l2"),
    ("cap = 80, d = 960, k = 10", 2, 80, 150, 960, 100, 10, "l2"),
    ("maxc < 64", 3, 32, 40, 16, 50, 10, "l2"),
    ("k = 307: buffers in scratch", 2, 40, 600, 32, 100, 307, "l2"),
])
def test_i8_scan_equals_plain(card, name, c, cap, maxc, d, qn, k, metric):
    """int8 x int8 on the card launches scan_i8 (k <= 32) or
    scan_general_i8 up to d = MAX_D_I8 and the wide kernels past it,
    and gives the plain version's vals and ids, torch.equal on every live
    row: the s32 sums are exact in any order and each distance is rounded
    as the plain version rounds it."""
    qc, qidx, slabs, bias, scale = _int_case(
        c * 1000 + d + k, c, cap, maxc, d, qn, torch.int8, -128, 128,
        metric)
    _check_exact(card, qc, qidx, slabs, bias, k, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,k,lo,hi,dup", [
    ("duplicate rows", 128, 10, -128, 128, True),
    ("duplicate rows, k = 64", 128, 64, -128, 128, True),
    ("duplicate rows, d = 960, k = 20", 960, 20, -128, 128, True),
    ("values in -1..1", 128, 10, -1, 2, False),
    ("values in -1..1, k = 32", 128, 32, -1, 2, False),
    ("values in -1..1, k = 100", 128, 100, -1, 2, False),
    ("values in 0..1, d = 100, k = 200", 100, 200, 0, 2, True),
])
def test_i8_scan_exact_ties_go_to_the_lowest_slot(card, name, d, k, lo, hi,
                                                  dup):
    """Exact ties, as uint8 data has them everywhere: repeated slab rows,
    and values so narrow that most distances tie. Both kernels must give
    the plain version's (stable sort) ids, lowest slot first."""
    c, cap, maxc, qn = 3, 40, 400, 100
    qc, qidx, slabs, bias, scale = _int_case(d * 7 + k, c, cap, maxc, d, qn,
                                             torch.int8, lo, hi, dup=dup)
    _check_exact(card, qc, qidx, slabs, bias, k, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,sdt,d,k,in_scratch", [
    # the streamed general kernel: 3 ring stages with the query's chunk
    # beside the slab's leave the rows' buffers shared memory up to
    # k = 288 (int8 x int8), 264 (SQ8), 216 (bf16 and f32)
    (torch.int8, torch.int8, cs.MAX_D_I8 + 8, 288, False),
    (torch.int8, torch.int8, cs.MAX_D_I8 + 8, 289, True),
    (torch.bfloat16, torch.int8, cs.MAX_D_BF16 + 16, 264, False),
    (torch.bfloat16, torch.int8, cs.MAX_D_BF16 + 16, 265, True),
    (torch.bfloat16, torch.bfloat16, cs.MAX_D_BF16 + 8, 216, False),
    (torch.bfloat16, torch.bfloat16, cs.MAX_D_BF16 + 8, 217, True),
    (torch.bfloat16, torch.bfloat16, cs.MAX_D_BF16 + 8, 500, True),
    (torch.float32, torch.float32, cs.MAX_D_F32 + 8, 216, False),
    (torch.float32, torch.float32, cs.MAX_D_F32 + 8, 217, True),
])
def test_cuda_core_scan_large_k_in_scratch(card, qdt, sdt, d, k,
                                           in_scratch):
    """The general kernel past each pair's width (scan_general_wide, which
    replaced the CUDA-core general kernel) keeps its rows' buffers in
    shared memory while they fit beside its larger ring stages and in
    global scratch past that; vals as the plain version's (exact for int8
    x int8, rtol 1e-5 and atol 1e-2 at |bias| ~ 2d, 0.5 at an int8 slab's
    |bias| ~ 7e5), a returned slot scores its value."""
    from hnsw_nsg_tpu_torch.ops._build import load_library

    c, cap, maxc, qn = 2, 40, 600, 60
    qc, qidx, slabs, bias, scale = _case(91 + k, qdt, sdt, "l2", c, cap,
                                         maxc, d, qn)
    assert cs.scan_kernel(qdt, sdt, d, k) == "scan_general_wide"
    codes = (cs._DTYPE_CODE[qdt], cs._DTYPE_CODE[sdt])
    assert (load_library().grouped_scan_general_scratch(
        c, cap, d, k, *codes) > 0) == in_scratch
    before = cs.launches_by_kernel["scan_general_wide"]
    kv, ki = cs.grouped_cluster_topk_gq(
        *(t.to(card) for t in (qc, qidx, slabs, bias)), k, scale)
    torch.cuda.synchronize()
    assert cs.launches_by_kernel["scan_general_wide"] == before + 1
    rv, _ = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                 scale)
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    tol = (dict(rtol=0.0, atol=0.0) if qdt == sdt == torch.int8
           else dict(rtol=1e-5, atol=0.5 if sdt == torch.int8 else 1e-2))
    torch.testing.assert_close(kv[live], rv[live], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    torch.testing.assert_close(torch.gather(full, 2, ki.long())[fin],
                               rv[fin], **tol)


# the streamed mode of each pair, past its width: a d whose rows start on
# 16 bytes (cp.async copies) and one whose rows do not (plain loads)
_WIDE_D = {(torch.float32, torch.float32): (968, 961),
           (torch.bfloat16, torch.bfloat16): (1928, 1930),
           (torch.bfloat16, torch.int8): (1936, 1930),
           (torch.int8, torch.int8): (3856, 3850)}


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,sdt", PAIRS)
@pytest.mark.parametrize("name,cap,maxc,k,aligned", [
    ("k = 10", 32, 150, 10, True),
    ("rows off 16 bytes", 32, 150, 10, False),
    ("rows off 16 bytes, k = 100", 32, 150, 100, False),
    ("cap > 32", 80, 150, 32, True),
    ("cap > 32, k = 64", 80, 150, 64, True),
    ("k = maxc", 32, 100, 100, True),
    ("all-pad row blocks", 64, 150, 10, True),
    ("all-pad row blocks, k = 33", 64, 150, 33, True),
])
def test_wide_scan_streams_the_query(card, qdt, sdt, name, cap, maxc, k,
                                     aligned):
    """Past each pair's width the wide kernels stream the query's d chunks
    through the ring. f32 (on integer data) and int8 x int8 give the plain
    version's vals and ids, torch.equal (_check_exact); a bf16 query with
    a bf16 or int8 slab its vals within f32 summation order (rtol 1e-5,
    atol 1e-2 at |bias| ~ 2d; 0.5 at an int8 slab's |bias| ~ 7e5), a slot
    that differs scoring its value. Each case has an all-pad query list,
    a cluster with 7 live slots and an all-pad cluster; the all-pad row
    blocks case a whole block of 32 pad rows in cluster 1."""
    d = _WIDE_D[qdt, sdt][0 if aligned else 1]
    c, qn = 3, 100
    exact = qdt == sdt and qdt != torch.bfloat16
    if exact:
        qc, qidx, slabs, bias, scale = _int_case(
            d + k + cap, c, cap, maxc, d, qn, qdt,
            *((-128, 128) if qdt == torch.int8 else (-6, 7)))
    else:
        qc, qidx, slabs, bias, scale = _case(d + k + cap, qdt, sdt, "l2", c,
                                             cap, maxc, d, qn)
        bias[1, 7:] = float("inf")
        qidx[0, :] = -1
    if "all-pad" in name:
        qidx[1, 32:] = -1
    if exact:
        _check_exact(card, qc, qidx, slabs, bias, k, scale)
        return
    kern = cs.scan_kernel(qdt, sdt, d, k)
    assert kern == ("scan_wide" if k <= cs.MAX_K else "scan_general_wide")
    before = cs.launches_by_kernel[kern]
    kv, ki = cs.grouped_cluster_topk_gq(
        *(t.to(card) for t in (qc, qidx, slabs, bias)), k, scale)
    torch.cuda.synchronize()
    assert cs.launches_by_kernel[kern] == before + 1
    rv, ri = cs.grouped_cluster_topk_gq_reference(qc, qidx, slabs, bias, k,
                                                  scale)
    kv, ki = kv.cpu(), ki.cpu()
    live = (qidx >= 0)[:, :, None].expand_as(rv)
    fin = live & torch.isfinite(rv)
    assert torch.equal(torch.isinf(kv[live]), torch.isinf(rv[live]))
    tol = dict(rtol=1e-5, atol=0.5 if sdt == torch.int8 else 1e-2)
    torch.testing.assert_close(kv[fin], rv[fin], **tol)
    full = bias[:, None, :] - scale * cs._dots_reference(
        cs._gather_queries(qc, qidx), slabs)
    torch.testing.assert_close(torch.gather(full, 2, ki.long())[fin],
                               rv[fin], **tol)
    print(f"{kern} {name} {qdt}x{sdt} d={d}: near-tie ids "
          f"{int((ki[fin] != ri[fin]).sum())}/{int(fin.sum())}")


@pytest.mark.cuda
def test_uint8_cnns_search_on_card_equals_cpu(card, tmp_path):
    """A uint8 CNNS index (int8 slabs shifted by 128, exact integer
    arithmetic end to end) searched on the card through scan_i8 (k=10)
    and scan_general_i8 (k=100) gives the CPU search's ids and distances,
    torch.equal, and the distances are the exact squared L2 distances of
    the uint8 rows."""
    x, q = make_data(20000, 128, 256, "l2", seed=0, uint8=True)
    cpu_idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=20, m=4, kmeans_iters=5, replicate=True),
        slab_dtype=torch.int8, device="cpu")
    assert cpu_idx.qshift == 128.0 and cpu_idx.qscale == 1.0
    cpu_idx.save(str(tmp_path / "u8.npz"))
    gpu_idx = cnns.CNNSIndex.load(str(tmp_path / "u8.npz"))
    cpu_idx = cnns.CNNSIndex.load(str(tmp_path / "u8.npz"), device="cpu")
    assert torch.equal(gpu_idx._route(torch.from_numpy(q - 128).to(card),
                                      3).cpu(),
                       cpu_idx._route(torch.from_numpy(q - 128), 3))
    for k, kern in ((10, "scan_i8"), (100, "scan_general_i8")):
        before = cs.launches_by_kernel[kern]
        gd, gi = gpu_idx.search(torch.from_numpy(q).to(card), k=k, nprobe=3,
                                group=True)
        assert cs.launches_by_kernel[kern] > before
        cd, ci = cpu_idx.search(torch.from_numpy(q), k=k, nprobe=3,
                                group=True)
        gd, gi = gd.cpu(), gi.cpu()
        assert torch.equal(gi, ci) and torch.equal(gd, cd)
        ok = gi >= 0
        assert bool(ok.all())
        ex = ((torch.from_numpy(x).double()[gi]
               - torch.from_numpy(q).double()[:, None, :]) ** 2).sum(-1)
        assert torch.equal(gd.double(), ex)


# -- the search extensions, slot replacement and the small-N builders ------

def _carried_graph(tmp_path, n=3000, d=16, seed=3):
    """An HNSW graph of integer-valued rows (every distance exact) built on
    the card and written to the .npz both devices read."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    q = rng.integers(-4, 5, (256, d)).astype(np.float32)
    idx = HNSWIndex(d, n, HNSWConfig(M=8, ef_construction=40))
    idx.add_items(x)
    path = str(tmp_path / "g.npz")
    idx.save(path)
    return x, q, path


@pytest.mark.cuda
def test_extensions_on_card_equal_cpu(card, tmp_path):
    """epsilon_query and knn_doc_query on one graph, on the card and on the
    CPU: equal labels, distances and counts (integer-valued rows), and the
    card's beams launched merge+select."""
    from hnsw_nsg_tpu_torch.api import MultiVectorIndex

    x, q, path = _carried_graph(tmp_path)
    out = []
    for dev in (None, "cpu"):
        p = Index("l2", 16, device=dev)
        p.load_index(path)
        m = MultiVectorIndex("l2", 16, device=dev)
        m.load_index(path)
        m._docs = np.arange(len(x), dtype=np.int64) // 4
        m0 = ms.launches
        out.append((*p.epsilon_query(q, 150.0, max_candidates=128),
                    *m.knn_doc_query(q, k=10, ef=64)))
        if dev is None:
            assert p._index.data.device.type == "cuda"
            assert ms.launches > m0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[0][2].sum() > 0


@pytest.mark.cuda
def test_replace_point_on_card_equals_cpu(card, tmp_path):
    """Ten replacing adds through the API on both devices: every level's
    adjacency equal row for row (integer-valued rows), the deleted labels
    gone, the new points found."""
    x, q, path = _carried_graph(tmp_path)
    new = np.random.default_rng(9).integers(-4, 5, (10, 16)).astype(
        np.float32)
    graphs = []
    for dev in (None, "cpu"):
        p = Index("l2", 16, device=dev)
        p.load_index(path, allow_replace_deleted=True)
        for lab in range(0, 100, 10):
            p.mark_deleted(lab)
        p.add_items(new, np.arange(9000, 9010), replace_deleted=True)
        assert p.get_current_count() == len(x)
        assert not set(range(0, 100, 10)) & set(p.get_ids_list())
        labels, _ = p.knn_query(new, k=1, ef=64)
        assert (labels[:, 0] >= 9000).mean() >= 0.9
        idx = p._index
        graphs.append([a[: idx.n].cpu().numpy()
                       for a in (idx.adj0, *idx.adj_up)])
    for a, b in zip(*graphs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_small_n_builders_on_card(card):
    """nn_descent, knn_graph_rp (refined) and graph_add with numpy input run
    on the card by default; their recalls against the exact graph come
    within 0.02 of the same calls on the CPU (the generators differ), and
    graph_add's beams launch merge+select's warp kernel."""
    from hnsw_nsg_tpu_torch.models.nndescent import graph_add, nn_descent
    from hnsw_nsg_tpu_torch.models.rptree import knn_graph_rp
    from hnsw_nsg_tpu_torch.ops import knn_graph_exact
    from hnsw_nsg_tpu_torch.utils.params import NNDescentConfig

    x = np.random.default_rng(3).standard_normal((6000, 24)).astype(
        np.float32)
    gt = knn_graph_exact(torch.from_numpy(x).to(card), 10).cpu().numpy()
    base = knn_graph_exact(torch.from_numpy(x[:5000]).to(card),
                           10).cpu().numpy()
    cfg = NNDescentConfig(K=10, L=24, iters=4, S=8, R=8)
    rec = {}
    for dev in (None, "cpu"):
        torch.cuda.reset_peak_memory_stats()
        a = nn_descent(x, cfg, seed=1, device=dev)
        b = knn_graph_rp(x, 10, n_trees=4, leaf_size=256, seed=2,
                         refine=cfg, device=dev)
        if dev is None:
            assert torch.cuda.max_memory_allocated() > x.nbytes
        m0 = ms.launches_by_shape.copy()
        _, c = graph_add(x[:5000], base, x[5000:], seed=7, device=dev)
        if dev is None:
            grown = ms.launches_by_shape - m0
            assert grown and all(ms_l <= ms.MAX_L for _, ms_l, _, _ in grown)
        rec[dev] = [recall(a, gt), recall(b, gt), recall(c[5000:], gt[5000:])]
    for r_card, r_cpu in zip(rec[None], rec["cpu"]):
        assert abs(r_card - r_cpu) <= 0.02, rec


@pytest.mark.cuda
def test_sharded_indexes_on_card_equal_cpu(card):
    """The sharded indexes on a mesh of four logical shards of the card
    give the CPU mesh's results: the CNNS search on the f32 scan kernels
    (integer-valued rows: every product exact, distances equal), the graph
    search on merge+select (equal), the flat search and the kNN build step
    (ids equal on integer rows outside ties)."""
    from hnsw_nsg_tpu_torch.parallel import mesh as tm

    rng = np.random.default_rng(15)
    centers = rng.integers(-8, 9, (30, 24))
    x = (centers[rng.integers(0, 30, 6000)]
         + rng.integers(-2, 3, (6000, 24))).astype(np.float32)
    q = (centers[rng.integers(0, 30, 64)]
         + rng.integers(-2, 3, (64, 24))).astype(np.float32)
    idx = cnns.build_cnns(x, CNNSConfig(n_clusters=30, m=2, kmeans_iters=8),
                          device="cpu")
    cpu4 = tm.make_mesh(4, devices=["cpu"] * 4)
    gpu4 = tm.make_mesh(4, devices=["cuda"] * 4)
    before = cs.launches_by_kernel["scan_f32"]
    want = tm.ShardedCNNSIndex.build(cpu4, idx).search(q, 10, nprobe=8)
    got = tm.ShardedCNNSIndex.build(gpu4, idx).search(q, 10, nprobe=8)
    assert cs.launches_by_kernel["scan_f32"] > before
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert (got[1].cpu() == want[1]).float().mean() > 0.99

    datas = [x[i * 1500 : (i + 1) * 1500] for i in range(4)]
    adjs = [knn_graph_ivf(d_, 10, device="cpu") for d_ in datas]
    before = ms.launches
    g_want = tm.ShardedGraphIndex.build_from_shards(
        cpu4, datas, adjs).search(q, 10, l_search=32, nprobe=2)
    g_got = tm.ShardedGraphIndex.build_from_shards(
        gpu4, datas, adjs).search(q, 10, l_search=32, nprobe=2)
    assert ms.launches > before
    for a, b in zip(g_got, g_want):
        assert torch.equal(a.cpu(), b)

    f_want = tm.ShardedFlatIndex.build(cpu4, x).search(q, 10)
    f_got = tm.ShardedFlatIndex.build(gpu4, x).search(q, 10)
    assert torch.equal(f_got[0].cpu(), f_want[0])
    adj_want = tm.sharded_knn_build_step(cpu4, x, 8)
    adj_got = tm.sharded_knn_build_step(gpu4, x, 8)
    d_w = ((x[adj_want.numpy()] - x[:, None]) ** 2).sum(-1)
    d_g = ((x[adj_got.cpu().numpy()] - x[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(d_g, d_w)


@pytest.mark.cuda
def test_entry_dryrun_and_metrics_on_card(card, tmp_path):
    from hnsw_nsg_tpu_torch import entry
    from hnsw_nsg_tpu_torch.utils import metrics

    fn, args = entry.entry()
    assert all(a.is_cuda for a in args)
    d_gpu, i_gpu = fn(*args)
    fn_c, args_c = entry.entry("cpu")
    d_cpu, i_cpu = fn_c(*args_c)
    assert (i_gpu.cpu() == i_cpu).float().mean() > 0.99
    entry.dryrun_multichip(4, devices=["cuda"] * 4)
    stats = metrics.device_memory_stats()
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"] < (
        stats["bytes_limit"])
    with metrics.timed(sync=d_gpu) as t:
        fn(*args)
    assert t.elapsed > 0


# ---- the flat router's kernel (ops/route.py, csrc/route.cu) ---------------

def _route_ints(seed, qn, c, m1, d, dups=True):
    """Integer-valued bf16 queries [qn, d] and reps [c, m1, d] with |x| <= 8:
    every product and f32 sum is exact in any order, so the kernel's
    distances are the plain version's bit for bit. Some reps repeat an
    earlier one (equal distances at two columns: the lower must win) and
    one query row is NaN (every distance NaN: columns in order after the
    padding ones)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 9, (qn, d)).astype(np.float32)
    reps = rng.integers(-8, 9, (c, m1, d)).astype(np.float32)
    if dups:
        flat = reps.reshape(c * m1, d)
        src = rng.integers(0, c * m1, c * m1 // 4)
        dst = rng.integers(0, c * m1, c * m1 // 4)
        flat[dst] = flat[src]
        q[: qn // 8] = flat[rng.integers(0, c * m1, qn // 8)]   # exact hits
    q[min(7, qn - 1), 0] = np.nan
    return torch.from_numpy(q), torch.from_numpy(reps)


def _route_kernel_vs_plain(card, q, reps, metric, n_rep, n_valid=None,
                           route_m=None):
    """rep columns of route_topk on the card and of the plain version on
    the CPU, on _route_operands' operands; asserts the launches."""
    from hnsw_nsg_tpu_torch.ops import route

    full = reps
    if route_m is not None:
        reps = reps[:, :route_m]
    c, m1, _ = reps.shape
    n_real = c * m1 if n_valid is None else n_valid * m1
    flat, bias, scale = cnns._route_operands(full, metric, route_m)
    qb = q.to(torch.bfloat16)
    want = route.route_topk(qb, flat, bias, n_rep, n_real, scale)
    before, by = route.launches, dict(route.launches_by_kernel)
    got = route.route_topk(qb.to(card), flat.to(card), bias.to(card), n_rep,
                           n_real, scale)
    torch.cuda.synchronize()
    assert route.launches_by_kernel["route_topk"] == by.get("route_topk",
                                                            0) + 1
    assert route.launches - before in (1, 2)
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [100, 128, 960, 3072])
@pytest.mark.parametrize("n_rep", [1, 10, 15, 32, 33, 100])
def test_route_kernel_equals_plain_on_integers(card, metric, d, n_rep):
    """Exact distances: the kernel's columns equal the plain version's
    bit for bit, ties to the lower column, NaN rows after the padding
    columns; 300 queries (not a multiple of the 128-row tile), several
    column splits and their merge, 6 of 140 clusters padding."""
    q, reps = _route_ints(d + n_rep, 300, 140, 5, d)
    got, want = _route_kernel_vs_plain(card, q, reps, metric, n_rep,
                                       n_valid=134)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name,qn,c,m1,d,n_rep,n_valid,route_m", [
    ("padding returned", 200, 20, 5, 64, 33, 3, None),   # 15 real columns
    ("padding, heaps", 130, 20, 5, 128, 25, 4, None),    # 20 real columns
    ("no real column", 50, 8, 5, 32, 12, 0, None),
    ("one tile, one split", 1000, 20, 5, 128, 10, None, None),
    ("route_m", 260, 40, 5, 128, 6, 37, 2),
    ("d = 8", 129, 300, 5, 8, 15, None, None),
    ("odd d", 257, 60, 3, 37, 40, 55, None),
    ("one query", 1, 50, 5, 200, 10, 48, None),
])
def test_route_kernel_shapes(card, metric, name, qn, c, m1, d, n_rep,
                             n_valid, route_m):
    got, want = _route_kernel_vs_plain(card, *_route_ints(qn + d, qn, c,
                                                          m1, d),
                                       metric, n_rep, n_valid, route_m)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_valid,route_m,rank_by", [
    (None, None, "hits"), (37, None, "hits"), (37, 3, "hits"),
    (37, None, "min_dist")])
def test_route_on_card_equals_cpu_route(card, metric, n_valid, route_m,
                                        rank_by):
    """_route_clusters on the card (the kernel, on operands made once per
    reps tensor) and on the CPU (the plain path) visit the same clusters
    on integer-valued data, a second call reusing the kept operands."""
    from hnsw_nsg_tpu_torch.ops import route

    q, reps = _route_ints(5, 700, 40, 5, 96)
    q[7] = 0.0                      # no NaN row: _rank_rep_hits takes any
    cpu = cnns._route_clusters(q, reps, 6, metric, rank_by, route_m,
                               n_valid)
    before = dict(cnns.route_counts)
    kernels = route.launches_by_kernel["route_topk"]
    q_card, reps_card = q.to(card), reps.to(card)
    for _ in range(2):
        got = cnns._route_clusters(q_card, reps_card, 6, metric, rank_by,
                                   route_m, n_valid)
        assert torch.equal(got.cpu(), cpu)
    assert list(cnns._operands[reps_card]) == [(route_m, metric)]
    assert route.launches_by_kernel["route_topk"] == kernels + 2
    assert cnns.route_counts["plain"] == before.get("plain", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,qn,c,d,n_rep,n_valid,nprobe,metric", [
    ("sift1m batch8k", 8192, 1152, 128, 10, 1152, 2, "l2"),
    ("dbpedia batch8k", 8192, 1280, 3072, 15, 976, 3, "ip"),
])
def test_route_kernel_at_the_bench_shapes(card, name, qn, c, d, n_rep,
                                          n_valid, nprobe, metric):
    """Gaussian data at the benchmark's router shapes: the kernel (f32
    sums of exact bf16 products in the tensor cores' order) against the
    plain version on the card (cuBLAS f32): equal visits in >= 99.9% of
    queries, and every rep that one of them takes and the other does not
    lies within 1e-5 |q| |r| of the n_rep-th distance (float64)."""
    from hnsw_nsg_tpu_torch.ops import route

    gen = torch.Generator(device=card)
    gen.manual_seed(21)
    q = torch.randn((qn, d), generator=gen, device=card)
    reps = torch.randn((c, 5, d), generator=gen, device=card)
    if metric == "ip":
        q = q / q.norm(dim=1, keepdim=True)
        reps = reps / reps.norm(dim=2, keepdim=True)
    flat, bias, scale = cnns._route_operands(reps, metric, None)
    qb = q.to(torch.bfloat16)
    got = route.route_topk(qb, flat, bias, n_rep, n_valid * 5, scale)
    want = route.route_topk_reference(qb, flat, bias, n_rep, n_valid * 5,
                                      scale)
    visit_k = cnns._rank_rep_hits(got, 5, nprobe, "hits")
    visit_p = cnns._rank_rep_hits(want, 5, nprobe, "hits")
    same = (visit_k == visit_p).all(1).float().mean().item()
    assert same >= 0.999, same
    rows = (~(got.sort(1).values == want.sort(1).values).all(1)
            ).nonzero()[:, 0]
    if rows.numel():
        g, w = got[rows], want[rows]
        qd, fd = qb[rows].double(), flat.double()
        exact = bias.double()[None] - scale * (qd @ fd.T)
        kth = torch.gather(exact, 1, w).max(1).values
        tol = (1e-5 * qd.norm(dim=1) * fd.norm(dim=1).max())[:, None]
        for a, b in ((g, w), (w, g)):
            only = ~(a[:, :, None] == b[:, None, :]).any(2)
            off = (torch.gather(exact, 1, a) - kth[:, None]).abs()
            assert bool((off <= tol)[only].all())
    print(f"route {name}: {same:.5f} equal visits, {rows.numel()} rows "
          f"with another rep set")


@pytest.mark.cuda
def test_route_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from hnsw_nsg_tpu_torch.ops import route

    q = torch.zeros((4, 16), dtype=torch.bfloat16, device=card)
    reps = torch.zeros((10, 16), dtype=torch.bfloat16, device=card)
    bias = torch.zeros(10, device=card)
    for args, err in (
            ((q.float(), reps, bias, 3, 10), TypeError),
            ((q, reps.float(), bias, 3, 10), TypeError),
            ((q, reps, bias.double(), 3, 10), TypeError),
            ((q[:, :8], reps, bias, 3, 10), ValueError),
            ((q, reps, bias[:9], 3, 10), ValueError),
            ((q, reps, bias, 0, 10), ValueError),
            ((q, reps, bias, 11, 10), ValueError),
            ((q, reps, bias, 3, 11), ValueError),
            ((q.cpu(), reps, bias, 3, 10), ValueError),
            ((q.t().contiguous().t(), reps, bias, 3, 10), ValueError),
            ((q[None], reps, bias, 3, 10), ValueError)):
        with pytest.raises(err):
            route.route_topk(*args, 1.0)


# ---- the per-query probe path's kernel (ops/probe_scan.py,
# csrc/probe_scan.cu) ----------------------------------------------------

def _probe_ints(seed, qn, c, maxc, d, npr, metric, vmax=4):
    """Integer-valued bf16 slabs [c, maxc, d] and queries [qn, d] with
    |x| <= vmax, so that every product, sum and norm is exact in any
    order and the kernel's distances are the plain version's bit for bit;
    dead rows and an all-dead cluster, PAD slots, a query with no live
    slot, a query that probes one cluster twice, and repeated rows within
    and across slabs (exact ties). Returns probe_topk's arguments but k,
    on the CPU."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-vmax, vmax + 1, (c, maxc, d)).astype(np.float32)
    q = rng.integers(-vmax, vmax + 1, (qn, d)).astype(np.float32)
    x[1 % c, min(3, maxc - 1)] = x[0, 0]
    x[:, maxc // 2] = x[0, 0]
    q[min(2, qn - 1)] = x[0, 0]               # exact hits
    data_c = torch.from_numpy(x).to(torch.bfloat16)
    ids = rng.permutation(c * maxc).reshape(c, maxc).astype(np.int32)
    ids[rng.random((c, maxc)) < 0.15] = -1
    ids[c - 1] = -1
    visit = torch.from_numpy(np.stack(
        [rng.permutation(c)[:npr] for _ in range(qn)])).long()
    visit[rng.random((qn, npr)) < 0.15] = -1
    visit[0] = -1
    if npr > 1 and qn > 1:
        visit[1, :2] = 0
    qc = torch.from_numpy(q).to(torch.bfloat16)
    l2 = metric == "l2"
    return (qc, visit, data_c, torch.from_numpy(ids),
            cnns.squared_norms(data_c) if l2 else None,
            cnns.squared_norms(torch.from_numpy(q)) if l2 else None)


def _probe_kernel_vs_plain(card, args, k, metric):
    """probe_topk on the card and the plain version on the CPU; asserts
    the two launches."""
    from hnsw_nsg_tpu_torch.ops import probe_scan

    want = probe_scan.probe_topk_reference(*args, k, metric)
    before = dict(probe_scan.launches_by_kernel)
    got = probe_scan.probe_topk(*(None if t is None else t.to(card)
                                  for t in args), k, metric)
    torch.cuda.synchronize()
    for name in ("probe_scan", "probe_merge"):
        assert probe_scan.launches_by_kernel[name] == before.get(name, 0) + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    return (got[0].cpu(), got[1].cpu()), want


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1, 10, 20, 200])
@pytest.mark.parametrize("d,npr", [(128, 1), (128, 2), (3072, 3), (37, 4),
                                   (8, 2)])
def test_probe_kernel_equals_plain_on_integers(card, metric, k, d, npr):
    """Exact distances: the kernel's dists and ids equal the plain
    version's bit for bit, ties by (probe slot, row), a repeated cluster's
    rows twice, PAD past the live rows; 37 queries, every d chunk, row
    split and top-k kind (a list at k <= 32, buffers above)."""
    args = _probe_ints(d + k + npr, 37, 12, 300 if d < 3072 else 96, d, npr,
                       metric)
    (gd, gi), (wd, wi) = _probe_kernel_vs_plain(card, args, k, metric)
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    assert torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("name,qn,c,maxc,d,npr,k,metric", [
    ("odd d: plain loads", 33, 9, 70, 37, 3, 10, "l2"),
    ("rows on 8 bytes", 20, 7, 64, 100, 2, 33, "ip"),
    ("two d chunks, rows on 4 bytes", 9, 5, 40, 1030, 2, 5, "l2"),
    ("d chunk of 1000", 17, 6, 50, 1000, 3, 12, "ip"),
    ("k past every row", 11, 6, 9, 64, 3, 40, "l2"),
    ("k past every row, a list", 11, 6, 9, 64, 2, 25, "ip"),
    ("one row a slab", 15, 8, 1, 16, 4, 3, "l2"),
    ("one query", 1, 30, 500, 128, 4, 10, "ip"),
    ("maxc past 1024 rows an item", 6, 4, 3000, 64, 2, 20, "l2"),
    ("k = 1000", 5, 4, 3000, 32, 3, 1000, "l2"),
    ("k = maxc npr", 7, 5, 40, 24, 3, 120, "ip"),
])
def test_probe_kernel_shapes(card, name, qn, c, maxc, d, npr, k, metric):
    args = _probe_ints(qn + d + k, qn, c, maxc, d, npr, metric)
    (gd, gi), (wd, wi) = _probe_kernel_vs_plain(card, args, k, metric)
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32)), name
    assert torch.equal(gi, wi), name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 40])
def test_probe_kernel_long_runs_of_one_cluster(card, k):
    """Every query probes the same clusters, one of them twice: runs of
    70 and 140 pairs, read a pass for every 4 pairs, and one run of 3."""
    qc, visit, data_c, ids_c, cn, qn = _probe_ints(4, 70, 9, 130, 96, 4,
                                                   "ip")
    visit[:] = torch.tensor([5, 2, 5, 7])
    visit[:3, 3] = 1
    args = (qc, visit, data_c, ids_c, cn, qn)
    (gd, gi), (wd, wi) = _probe_kernel_vs_plain(card, args, k, "ip")
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    assert torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,k", [(m, k) for m in ("l2", "ip")
                                      for k in (1, 10, 32, 200)])
def test_probe_kernel_equals_the_jax_packages_flat_probe_search(card, metric,
                                                                k):
    """On the integer inputs of tests/data/probe_jax_ref.npz,
    _flat_probe_search on the card (bf16 slabs: the kernel, launched once)
    returns the JAX package's _flat_probe_search's distances and ids bit
    for bit, as the file holds them; tests/test_torch_probe_scan.py holds
    the file to the JAX package on the CPU (this machine needs no JAX)."""
    from hnsw_nsg_tpu_torch.ops import probe_scan

    f = np.load(pathlib.Path(__file__).parent / "data" / "probe_jax_ref.npz")
    data_c = torch.from_numpy(f["slabs"].astype(np.float32)).to(
        torch.bfloat16).to(card)
    before = dict(probe_scan.launches_by_kernel)
    gd, gi = cnns._flat_probe_search(
        torch.from_numpy(f["q"]).to(card),
        torch.from_numpy(f["visit"]).to(card), data_c,
        torch.from_numpy(f["ids"]).to(card), cnns.squared_norms(data_c), k,
        metric)
    for name in ("probe_scan", "probe_merge"):
        assert probe_scan.launches_by_kernel[name] == before.get(name, 0) + 1
    want_d, want_i = f[f"d_{metric}_{k}"], f[f"i_{metric}_{k}"]
    assert np.array_equal(gd.cpu().numpy().view(np.int32),
                          want_d.view(np.int32))
    assert np.array_equal(gi.cpu().numpy(), want_i)


@pytest.mark.cuda
def test_probe_kernel_takes_int32_visits_and_all_pad(card):
    qc, visit, data_c, ids_c, cn, qn = _probe_ints(3, 10, 6, 50, 32, 3,
                                                   "l2")
    visit[4:] = -1
    args = (qc, visit.int(), data_c, ids_c, cn, qn)
    (gd, gi), (wd, wi) = _probe_kernel_vs_plain(card, args, 10, "l2")
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    assert bool((gi[4:] == -1).all()) and bool((gd[4:] == cnns.PAD_DIST).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,c,d,npr,metric", [
    ("sift1m batch512", 40, 128, 2, "l2"),
    ("dbpedia batch512", 24, 3072, 3, "ip"),
])
def test_probe_kernel_at_the_bench_shapes(card, name, c, d, npr, metric):
    """Gaussian data at the benchmark's per-query shapes (512 queries,
    slabs of 2056 rows, kk = 20; fewer clusters): the kernel (f32 sums of
    exact bf16 products, another order) against the plain version on the
    card (cuBLAS f32): distances within 1e-5 |q| |x| (l2: + |q|^2 +
    |x|^2, the norms' own sums) of the exact float64 ones and of each
    other, ids equal but where the two took another of near-tied rows,
    each such row within twice that of the 20th distance. The near-ties
    are counted and printed."""
    from hnsw_nsg_tpu_torch.ops import probe_scan

    gen = torch.Generator(device=card)
    gen.manual_seed(23)
    qn, maxc, k = 512, 2056, 20
    x = torch.randn((c, maxc, d), generator=gen, device=card)
    q = torch.randn((qn, d), generator=gen, device=card)
    if metric == "ip":
        x = x / x.norm(dim=2, keepdim=True)
        q = q / q.norm(dim=1, keepdim=True)
    data_c, qc = x.to(torch.bfloat16), q.to(torch.bfloat16)
    del x
    ids_c = torch.arange(c * maxc, device=card, dtype=torch.int32).reshape(
        c, maxc)
    ids_c[:, -7:] = -1
    visit = torch.rand((qn, c), generator=gen, device=card).argsort(1)[
        :, :npr]
    l2 = metric == "l2"
    cn = cnns.squared_norms(data_c) if l2 else None
    qn2 = cnns.squared_norms(q) if l2 else None
    args = (qc, visit, data_c, ids_c, cn, qn2, k, metric)
    gd, gi = probe_scan.probe_topk(*args)
    wd, wi = probe_scan.probe_topk_reference(*args)
    # the exact distance of every returned id, float64
    flat = data_c.reshape(c * maxc, d).double()
    qd = qc.double()

    def exact(ids):
        xs = flat[ids.long().clamp(min=0)]
        dots = (xs * qd[:, None, :]).sum(2)
        if l2:
            return (xs * xs).sum(2) - 2 * dots + (q.double() ** 2).sum(1)[
                :, None]
        return 1 - dots

    qnrm, xnrm = qd.norm(dim=1)[:, None], flat.norm(dim=1).max()
    scale = qnrm * xnrm + (qnrm ** 2 + xnrm ** 2 if l2 else 0)
    tol = 1e-5 * scale
    assert bool(((gd - exact(gi)).abs() <= tol).all())
    assert bool(((wd - exact(wi)).abs() <= tol).all())
    same = gi == wi
    assert bool(((gd - wd).abs()[same] <= 2 * tol.expand_as(same)[same]).all())
    rows = (~same).any(1).nonzero()[:, 0]
    kth = torch.maximum(gd[:, -1], wd[:, -1])[:, None]
    for a, b, ad in ((gi, wi, gd), (wi, gi, wd)):
        only = ~(a[:, :, None] == b[:, None, :]).any(2)
        assert bool(((kth - ad).abs() <= 2 * tol)[only].all())
    print(f"probe {name}: {int((~same).sum())} ids of {same.numel()} in "
          f"{rows.numel()} queries at another place (near-ties)")


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.bfloat16, torch.float32,
                                        torch.int8])
def test_flat_probe_search_on_card_takes_the_kernel_for_bf16(card,
                                                             slab_dtype):
    """_flat_probe_search on the card: bf16 slabs launch the kernel (two
    launches a block of queries, the pairs counted "kernel"), f32 and
    int8 slabs the plain version (counted "plain", no launch); the search
    equals the CPU's within near-ties."""
    from hnsw_nsg_tpu_torch.ops import probe_scan

    args = _probe_ints(9, 50, 8, 120, 64, 3, "l2")
    qf = args[0].float()
    data_c = args[2].to(slab_dtype)
    cn = cnns.squared_norms(data_c)
    before = dict(cnns.probe_counts)
    launched = dict(probe_scan.launches_by_kernel)
    got = cnns._flat_probe_search(qf.to(card), args[1].to(card),
                                  data_c.to(card), args[3].to(card),
                                  cn.to(card), 10, "l2", q_block=32)
    kernel = slab_dtype == torch.bfloat16
    key = "kernel" if kernel else "plain"
    assert cnns.probe_counts[key] == before.get(key, 0) + 150
    assert probe_scan.launches_by_kernel["probe_scan"] == launched.get(
        "probe_scan", 0) + (2 if kernel else 0)
    want = cnns._flat_probe_search(qf, args[1], data_c, args[3], cn, 10,
                                   "l2", q_block=32)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_probe_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from hnsw_nsg_tpu_torch.ops import probe_scan

    qc, visit, data_c, ids_c, cn, qn = (
        t.to(card) for t in _probe_ints(1, 8, 4, 16, 32, 2, "l2"))
    ok = dict(qc=qc, visit=visit, data_c=data_c, ids_c=ids_c, cnorms=cn,
              qnorm=qn, k=5, metric="l2")
    for bad, err in ((dict(qc=qc.t().contiguous().t()), ValueError),
                     (dict(data_c=data_c.transpose(0, 1).contiguous()
                           .transpose(0, 1)), ValueError),
                     (dict(visit=visit.cpu()), ValueError),
                     (dict(qc=qc.float()), TypeError),
                     (dict(data_c=data_c.float()), TypeError)):
        with pytest.raises(err):
            probe_scan.probe_topk(**{**ok, **bad})
