"""A run whose timed path is broken underneath comes out not correct:
once for each fault a search cell can have (one card: no exchange
between chips to leave out)."""

import pytest
import torch

from annbench import checks, harness, spec


class Broken:
    """The configuration's system with its search broken as ``how`` says."""

    def __init__(self, system, how: str):
        self._s, self.how = system, how
        self.build, self.counters = system.build, system.counters
        self._last = None

    def search(self, index, queries, k, config):
        if self.how == "worse_tail":
            # a selection that keeps the 10 nearest and fills ranks 11 to
            # k with the candidates past k: ids and distances agree and
            # stay nearest first
            d, i = self._s.search(index, queries, 2 * k, config)
            return (torch.cat([d[:, :10], d[:, k + 10:]], 1),
                    torch.cat([i[:, :10], i[:, k + 10:]], 1))
        if self.how == "half":
            # half of the batch left out: the first half's answers stand
            # in for the rest
            h = queries.shape[0] // 2
            d, i = self._s.search(index, queries[:h], k, config)
            return torch.cat([d, d]), torch.cat([i, i])
        d, i = self._s.search(index, queries, k, config)
        if self.how == "padded_tail":
            # ranks 11 to k left empty, as a merge that drops them would
            return (torch.cat([d[:, :10], torch.full_like(d[:, 10:], 3.4e37)],
                              1),
                    torch.cat([i[:, :10], torch.full_like(i[:, 10:], -1)], 1))
        if self.how == "unsorted":
            # the first two ranks swapped: the row is no longer nearest
            # first
            return d[:, [1, 0, *range(2, k)]], i[:, [1, 0, *range(2, k)]]
        if self.how == "stale":
            # the state returned unchanged: every request gets the answer
            # of the request before it
            prev, self._last = self._last, (d, i)
            return prev if prev is not None else (d, i)
        return d, i


@pytest.mark.parametrize("how,workload,d,check", [
    ("stale", "sift1m-cnns-bf16.batch8k", None, "recall_at_k"),
    ("half", "sift1m-cnns-bf16.batch8k", None, "recall_at_k"),
    ("unsorted", "sift1m-cnns-bf16.batch8k", None, "unsorted"),
    ("worse_tail", "dbpedia-openai3-cnns-bf16.k100", 1024, "recall_at_k"),
    ("padded_tail", "dbpedia-openai3-cnns-bf16.k100", 1024, "recall_at_k"),
])
def test_a_broken_search_is_not_correct(tiny_cell, how, workload, d, check):
    cell = tiny_cell(workload, d=d)
    system = Broken(spec.load_module("systems", "cnns"), how)
    res = harness.run(cell, 21, 0.5, False, "cpu", 0.0, system=system)
    assert res["correct"] is False
    failed = [c for c, v in res["checks"].items() if not checks.holds(v)]
    assert check in failed, res["checks"]


def test_an_answer_altered_in_the_scan_is_not_correct(tiny_cell,
                                                      monkeypatch):
    # one id of every list slot's top-k replaced where the grouped scan
    # produces it, so that id no longer belongs to its distance
    from hnsw_nsg_tpu_torch.models import cnns
    real = cnns._scan_lists

    def altered(*args, **kwargs):
        td, gi = real(*args, **kwargs)
        gi = gi.clone()
        gi[..., 0] = torch.where(gi[..., 0] >= 0, (gi[..., 0] + 1) % 20000,
                                 gi[..., 0])
        return td, gi

    monkeypatch.setattr(cnns, "_scan_lists", altered)
    cell = tiny_cell("sift1m-cnns-bf16.batch8k")
    res = harness.run(cell, 22, 0.5, False, "cpu", 0.0)
    assert res["correct"] is False
    assert res["checks"]["dist_gap"]["value"] > \
        res["checks"]["dist_gap"]["limit"]


def test_the_sound_search_is_correct(tiny_cell):
    cell = tiny_cell("sift1m-cnns-bf16.batch8k")
    res = harness.run(cell, 21, 0.5, False, "cpu", 0.0)
    assert res["correct"] is True
