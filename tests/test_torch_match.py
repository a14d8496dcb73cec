"""Port parity: descriptor matching, dense and streamed.

Match indices must equal the JAX package's exactly. The streamed matcher's
plain PyTorch version (what ``reduce_one_way`` runs on CPU tensors) is held
against the JAX streamed matcher in interpret mode at multi-block sizes,
with invalid rows and duplicated rows that exercise the tie rules.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift3d_tpu.features.match import nn_match as jnn_match
from sift3d_tpu.ops.pallas_match import nn_match_streamed as jstreamed

from sift3d_tpu_torch.features.match import nn_match, ssd_matrix
from sift3d_tpu_torch.ops.cuda_match import (NUM_SMS, match_plan,
                                             merge_top2, nn_match_streamed,
                                             reduce_one_way,
                                             reduce_one_way_plain)

torch.set_num_threads(1)


def _descriptors(rng, n):
    d = rng.random((n, 768)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _plant(rng, d1, d2, pairs, noise=0.004):
    for i, j in pairs:
        d2[j] = d1[i] + rng.normal(0, noise, 768).astype(np.float32)
        d2[j] /= np.linalg.norm(d2[j])


@pytest.fixture(scope="module")
def sets():
    """Multi-block sets with planted matches, duplicated target and query
    rows (exact SSD ties), a query equal to a target, and invalid rows."""
    rng = np.random.default_rng(3)
    d1 = _descriptors(rng, 200)
    d2 = _descriptors(rng, 170)
    _plant(rng, d1, d2, [(i, (i * 7 + 3) % 170) for i in range(60)])
    d2[150] = d2[10]             # duplicate target of a planted match
    d2[160] = d2[100]
    d1[190] = d1[5]              # duplicate query
    d2[165] = d1[40]             # exact copy: SSD 0 (up to rounding)
    v1 = np.ones(200, bool)
    v1[[7, 77, 199]] = False
    v2 = np.ones(170, bool)
    v2[[3, 130]] = False
    return d1, d2, v1, v2


def _jax_dense(d1, d2, v1=None, v2=None):
    return np.asarray(jnn_match(
        jnp.asarray(d1), jnp.asarray(d2), 0.8,
        valid1=None if v1 is None else jnp.asarray(v1),
        valid2=None if v2 is None else jnp.asarray(v2)))


@pytest.mark.parametrize("masked", [False, True])
def test_dense_matches_jax(sets, masked):
    d1, d2, v1, v2 = sets
    if not masked:
        v1 = v2 = None
    want = _jax_dense(d1, d2, v1, v2)
    got = nn_match(torch.as_tensor(d1), torch.as_tensor(d2), 0.8,
                   valid1=None if v1 is None else torch.as_tensor(v1),
                   valid2=None if v2 is None else torch.as_tensor(v2)).numpy()
    assert (want >= 0).sum() >= 40
    np.testing.assert_array_equal(got, want)


def test_ssd_matrix_f64_matches_jax(sets):
    from sift3d_tpu.features.match import ssd_matrix as jssd
    d1, d2, _, _ = sets
    want = np.asarray(jssd(jnp.asarray(d1[:50]), jnp.asarray(d2[:40]),
                           jnp.float64))
    got = ssd_matrix(torch.as_tensor(d1[:50]), torch.as_tensor(d2[:40]),
                     torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_streamed_plain_matches_jax_interpret(sets, masked):
    d1, d2, v1, v2 = sets
    if not masked:
        v1 = v2 = None
    want = np.asarray(jstreamed(
        jnp.asarray(d1), jnp.asarray(d2), 0.8,
        valid1=None if v1 is None else jnp.asarray(v1),
        valid2=None if v2 is None else jnp.asarray(v2),
        block1=64, block2=64, interpret=True))
    got = nn_match_streamed(
        torch.as_tensor(d1), torch.as_tensor(d2), 0.8,
        valid1=None if v1 is None else torch.as_tensor(v1),
        valid2=None if v2 is None else torch.as_tensor(v2)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_dense(d1, d2, v1, v2))


def test_streamed_block_size_invariant(sets):
    """Ties inside a block and across blocks resolve to the same (best,
    second, first index) at any target block size."""
    d1, d2, v1, v2 = (torch.as_tensor(a) for a in sets)
    inf = float("inf")
    qsq = torch.where(v1, torch.sum(d1 * d1, 1), inf)
    tsq = torch.where(v2, torch.sum(d2 * d2, 1), inf)
    ref = reduce_one_way_plain(d2, d1, tsq, qsq, block=512)
    for block in (1, 7, 64):
        got = reduce_one_way_plain(d2, d1, tsq, qsq, block=block)
        np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
    # The duplicated query (row 190 == row 5) loses every tie to row 5.
    assert not (ref[2].numpy() == 190).any()
    assert (ref[2].numpy() == 5).any()


def test_all_invalid_rows_unmatched(sets):
    d1, d2, _, _ = sets
    v2 = torch.zeros(d2.shape[0], dtype=torch.bool)
    t1, t2 = torch.as_tensor(d1), torch.as_tensor(d2)
    best, second, idx = reduce_one_way(
        t1, t2, torch.sum(t1 * t1, 1), torch.full((d2.shape[0],), np.inf))
    assert torch.isinf(best).all() and (idx == 0).all()
    assert (nn_match_streamed(t1, t2, 0.8, valid2=v2) == -1).all()
    assert (nn_match(t1, t2, 0.8, valid2=v2) == -1).all()


# Target-range starts over the 170 targets of ``sets``: the duplicated
# targets (150 = 10, 160 = 100) fall in different ranges, and [130, 131)
# and [3, 4) hold only an invalid target.
SPLITS = {
    1: [0],
    2: [0, 101],
    3: [0, 130, 131],
    7: [0, 3, 4, 50, 101, 150, 161],
}


@pytest.mark.parametrize("n_ranges", sorted(SPLITS))
def test_streamed_split_merge(sets, n_ranges):
    """The kernel's target split in plain PyTorch: each range reduced alone,
    the partials folded by merge_top2, equals the unsplit reduction."""
    d1, d2, v1, v2 = (torch.as_tensor(a) for a in sets)
    inf = float("inf")
    qsq = torch.where(v1, torch.sum(d1 * d1, 1), inf)
    tsq = torch.where(v2, torch.sum(d2 * d2, 1), inf)
    bounds = SPLITS[n_ranges]
    assert len(bounds) == n_ranges
    want = reduce_one_way_plain(d1, d2, qsq, tsq)
    got = reduce_one_way_plain(d1, d2, qsq, tsq, block=64, bounds=bounds)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    # The duplicates never win over their first copy.
    assert not np.isin(got[2].numpy(), [150, 160]).any()
    assert np.isin(got[2].numpy(), [10, 100]).any()


def test_merge_top2_all_invalid_range_keeps_index_zero():
    """A range with no finite SSD (+inf, +inf, 0) neither takes the lead
    nor moves the second; all-invalid everywhere stays (+inf, +inf, 0)."""
    inf = float("inf")
    t = torch.tensor
    empty = (t([inf, inf]), t([inf, inf]), t([0, 0], dtype=torch.int32))
    live = (t([1.0, inf]), t([2.0, inf]), t([7, 0], dtype=torch.int32))
    tie = (t([1.0, 3.0]), t([5.0, 4.0]), t([9, 4], dtype=torch.int32))
    b0, b1, i0 = merge_top2([empty, live, empty, tie])
    np.testing.assert_array_equal(b0.numpy(), [1.0, 3.0])
    np.testing.assert_array_equal(b1.numpy(), [1.0, 4.0])
    np.testing.assert_array_equal(i0.numpy(), [7, 4])


@pytest.mark.parametrize("nq,nt", [(146, 153), (700, 650), (2500, 2300),
                                   (10000, 10000), (3, 0), (1, 1)])
def test_match_plan_fills_card(nq, nt):
    """Query tiles x target ranges reaches 2 x NUM_SMS blocks where the
    tiles allow it, and the ranges cover the target tiles in order."""
    side, per, ranges = match_plan(nq, nt)
    q_tiles, t_tiles = -(-nq // side), -(-nt // side)
    assert side in (32, 128) and ranges >= 1
    assert (ranges - 1) * per < max(t_tiles, 1) <= ranges * per
    if q_tiles * t_tiles >= 2 * NUM_SMS:
        assert q_tiles * ranges >= 2 * NUM_SMS
    else:
        assert ranges == max(t_tiles, 1)
    # Range r starts at target row r * side * per.
    assert len(range(0, max(nt, 1), side * per)) == ranges
