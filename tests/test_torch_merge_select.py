"""Fused merge+select of the PyTorch port vs the JAX package: the port's
plain version (the path CPU tensors take) must be bit-identical to JAX's
merge_select_reference and to its Pallas kernel in interpret mode, on
the same numpy inputs."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_nsg_tpu.ops import merge_select as jms  # noqa: E402
from hnsw_nsg_tpu.ops import topk as jtopk  # noqa: E402
from hnsw_nsg_tpu_torch.ops import merge_select as tms  # noqa: E402
from hnsw_nsg_tpu_torch.ops import topk as ttopk  # noqa: E402
from hnsw_nsg_tpu_torch.ops.distance import PAD_DIST, PAD_ID  # noqa: E402
from hnsw_nsg_tpu_torch.utils.synth import (  # noqa: E402
    MERGE_STATE_KINDS, adversarial_merge_state)

NAMES = ("dists", "ids", "expanded", "sel_ids", "sel_valid")


def _random_state(rng, q, l, c, n_ids=500, fill=0.7):
    """tests/test_merge_select.py:_random_state in numpy: a mid-search
    retset (sorted, partly expanded, PAD tail) and a candidate block with
    duplicates (vs the retset and internal), PADs and forced ties."""
    ni = rng.integers(4, int(l * fill) + 4)
    ids = rng.choice(n_ids, size=(q, ni), replace=True).astype(np.int32)
    d = rng.random((q, ni)).astype(np.float32)
    r_d, r_i, r_e = (np.array(a) for a in jtopk.init_retset(
        jnp.asarray(d), jnp.asarray(ids), l))
    r_e = r_e | (rng.random((q, l)) < 0.5)
    c_i = rng.choice(n_ids, size=(q, c), replace=True).astype(np.int32)
    c_i[rng.random((q, c)) < 0.15] = PAD_ID
    c_d = rng.random((q, c)).astype(np.float32)
    c_d[:, : c // 4] = np.float32(0.5)
    return r_d, r_i, r_e, c_d, c_i


def _both(state, expand):
    jstate = [jnp.asarray(a) for a in state]
    tstate = [torch.from_numpy(np.array(a)) for a in state]
    want_ref = jms.merge_select_reference(*jstate, expand)
    want_kernel = jms.fused_merge_select(*jstate, expand, block=8,
                                         interpret=True)
    got = tms.fused_merge_select(*tstate, expand)
    return got, want_ref, want_kernel


def _assert_identical(got, *wants):
    for want in wants:
        for name, a, b in zip(NAMES, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("l,c,expand", [
    (128, 30, 1), (128, 120, 4), (64, 30, 2), (128, 8, 1), (256, 60, 8),
    # an HNSW search at ef = 1024: the card's warp kernel at 32 slots a lane
    (1024, 32, 1), (1024, 128, 4),
    # past L = 1024, the card's general kernel: ef = 2048, and L = 1025
    (2048, 32, 1), (1025, 50, 1),
])
def test_plain_version_bit_identical_to_jax(l, c, expand):
    rng = np.random.default_rng(l * 1000 + c + expand)
    state = _random_state(rng, 16, l, c)
    before = tms.launches
    _assert_identical(*_both(state, expand))
    assert tms.launches == before        # CPU tensors never launch


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("c", [50, 120])
@pytest.mark.parametrize("l", [40, 100, 500])
@pytest.mark.parametrize("kind", MERGE_STATE_KINDS)
def test_adversarial_states_bit_identical_to_jax(kind, l, c, expand):
    """States that a hash- or filter-based membership test can get wrong
    (ids that collide modulo 1024 and 2048, id 0 and ids near 2**31 - 1,
    candidates that all repeat a retset id or one new id, an all-PAD
    retset): the port on the CPU equals JAX's merge_select_reference on
    all five outputs. The card tests run the same states kernel vs plain."""
    state = adversarial_merge_state(kind, l * 7 + c + expand, 5, l, c)
    want = jms.merge_select_reference(*(jnp.asarray(a) for a in state),
                                      expand)
    got = tms.fused_merge_select(*(torch.from_numpy(a) for a in state),
                                 expand)
    _assert_identical(got, want)


def test_all_pad_candidates_noop():
    rng = np.random.default_rng(0)
    r_d, r_i, r_e, _, _ = _random_state(rng, 8, 64, 16)
    c_d = np.full((8, 16), PAD_DIST, np.float32)
    c_i = np.full((8, 16), PAD_ID, np.int32)
    got, *wants = _both((r_d, r_i, r_e, c_d, c_i), 1)
    _assert_identical(got, *wants)
    np.testing.assert_array_equal(got[1].numpy(), r_i)


def test_converged_query_selects_nothing():
    rng = np.random.default_rng(1)
    r_d, r_i, r_e, c_d, c_i = _random_state(rng, 8, 64, 16)
    r_e = np.ones_like(r_e)
    c_d = np.full_like(c_d, PAD_DIST)
    c_i = np.full_like(c_i, PAD_ID)
    got, *wants = _both((r_d, r_i, r_e, c_d, c_i), 4)
    _assert_identical(got, *wants)
    assert not got[4].any()
    assert (got[3] == PAD_ID).all()


def test_odd_query_count():
    rng = np.random.default_rng(2)
    state = _random_state(rng, 11, 64, 16)
    _assert_identical(*_both(state, 2))


@pytest.mark.parametrize("l,c", [(24, 50), (500, 50)])
def test_build_shapes(l, c):
    """The search beam (L < C) and the build's collect pool (L = 500)."""
    rng = np.random.default_rng(l + c)
    state = _random_state(rng, 6, l, c, n_ids=2000)
    _assert_identical(*_both(state, 1))


def test_merge_into_retset_sorted_matches_jax():
    rng = np.random.default_rng(3)
    r_d, r_i, r_e, c_d, c_i = _random_state(rng, 9, 32, 40)
    want = jtopk.merge_into_retset_sorted(*(jnp.asarray(a) for a in (
        r_d, r_i, r_e, c_d, c_i)))
    got = ttopk.merge_into_retset_sorted(*(torch.from_numpy(a) for a in (
        r_d, r_i, r_e, c_d, c_i)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_init_and_internal_dups_match_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 30, (7, 40)).astype(np.int32)
    d = rng.random((7, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        ttopk.mask_internal_dups(torch.from_numpy(ids)).numpy(),
        np.asarray(jtopk.mask_internal_dups(jnp.asarray(ids))))
    got = ttopk.init_retset(torch.from_numpy(d), torch.from_numpy(ids), 24)
    want = jtopk.init_retset(jnp.asarray(d), jnp.asarray(ids), 24)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
