"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``cuda`` and skips where no card is visible.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_nsg_tpu_torch.models import cnns  # noqa: E402
from hnsw_nsg_tpu_torch.ops import cluster_scan as cs  # noqa: E402
from hnsw_nsg_tpu_torch.ops import recall  # noqa: E402
from hnsw_nsg_tpu_torch.utils.params import CNNSConfig  # noqa: E402
from hnsw_nsg_tpu_torch.utils.synth import make_data  # noqa: E402

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
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
def test_search_on_card_matches_cpu(card, tmp_path, slab_dtype):
    """The whole flat path on the card vs the same index on the CPU:
    ids equal in f32; in bf16 at least 99% (near-ties may swap)."""
    x, q = make_data(30000, 32, 512, "l2", seed=1)
    cpu_idx = cnns.build_cnns(
        x, CNNSConfig(n_clusters=30, m=4, kmeans_iters=6, replicate=True),
        slab_dtype=slab_dtype)
    cpu_idx.save(str(tmp_path / "i.npz"))
    gpu_idx = cnns.CNNSIndex.load(str(tmp_path / "i.npz"), device=card)
    cpu_idx = cnns.CNNSIndex.load(str(tmp_path / "i.npz"))
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
