"""The device generator repeats for a seed and differs across seeds."""

import torch

from annbench import datagen

CFG = {"normalize": False}


def test_same_seed_same_rows_and_queries():
    a = datagen.mixture(CFG, 3000, 16, 256, 2**31 + 17, "cpu")
    b = datagen.mixture(CFG, 3000, 16, 256, 2**31 + 17, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_other_seed_other_rows():
    a, qa = datagen.mixture(CFG, 3000, 16, 256, 1, "cpu")
    b, qb = datagen.mixture(CFG, 3000, 16, 256, 2, "cpu")
    assert not torch.equal(a, b) and not torch.equal(qa, qb)


def test_every_centre_owns_the_same_rows():
    gen = torch.Generator().manual_seed(5)
    lab = datagen._balanced(3000, 8, gen, "cpu")
    assert torch.bincount(lab, minlength=8).tolist() == [375] * 8


def test_normalized_rows_have_unit_norm():
    x, q = datagen.mixture(dict(CFG, normalize=True), 2000, 64, 128, 9,
                           "cpu")
    assert torch.allclose(x.norm(dim=1), torch.ones(2000), atol=1e-5)
    assert torch.allclose(q.norm(dim=1), torch.ones(128), atol=1e-5)


def test_rows_are_drawn_in_chunks_alike(monkeypatch):
    # the chunking of the draw is fixed, so the reference's second draw
    # after the window repeats the first
    monkeypatch.setattr(datagen, "_CHUNK_ELEMS", 16 * 100)
    a = datagen.mixture(CFG, 1000, 16, 64, 4, "cpu")
    b = datagen.mixture(CFG, 1000, 16, 64, 4, "cpu")
    assert torch.equal(a[0], b[0])
