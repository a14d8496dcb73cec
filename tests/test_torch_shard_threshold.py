"""Port parity: the sharded extrema threshold each volume on its own.

The port's ``parallel.level_extrema_sharded`` normalises the relative
peak threshold by each volume's DoG max (an ``all_reduce(MAX)`` over the
spatial axis of a (B,) vector), as the one-device detector
(``features.extrema.level_extrema``, reference sift.c:1162-1169) does.
The JAX package's sharded form takes one max over the whole local
(B_local, ...) block instead, so a volume beside a brighter one loses its
extrema there. On a batch whose volume 1 is scaled by 10, the port at
world size 1 (a one-rank gloo mesh) is held to JAX's one-device detector
volume by volume (rows, counts and totals exactly), and the input is
checked to show the difference: JAX's sharded count of volume 0 is below
its one-device count. The card check builds the same batch
(``chip_smoke.f3_batch``), held here to this one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sift3d_tpu.features.extrema import level_extrema as jlevel_extrema
from sift3d_tpu.parallel import level_extrema_sharded as jextrema_sharded
from sift3d_tpu.parallel import make_mesh as jmake_mesh

from sift3d_tpu_torch.features.extrema import level_extrema
from sift3d_tpu_torch.parallel import level_extrema_sharded, make_mesh

from chip_smoke import f3_batch
from tests.conftest import make_blob_volume

torch.set_num_threads(1)

SHAPE = (16, 12, 20)
B = 2
PEAK_THRESH, CAPACITY = 0.1, 64
SCALE = 10.0                         # volume 1's factor


@pytest.fixture(scope="module")
def batch():
    """prev, cur, nxt (B, nz, ny, nx): the ``ext_z`` inputs of
    ``tests/test_torch_parallel.py`` at B = 2, volume 1 scaled."""
    levels = []
    for base in (1, 3, 5):
        v = np.stack([make_blob_volume(SHAPE, seed=base + 10 * b)
                      for b in range(B)])
        v[1] *= SCALE
        levels.append(v)
    return levels


@pytest.fixture(scope="module")
def jax_one_device(batch):
    """JAX's one-device ``level_extrema`` of each volume."""
    out = []
    for b in range(B):
        zyx, count, total = jlevel_extrema(
            *(jnp.asarray(v[b]) for v in batch), PEAK_THRESH, CAPACITY)
        out.append((np.asarray(zyx)[:int(count)], int(count), int(total)))
    return out


@pytest.mark.parametrize("shard_dim", ["z", "y", "x"])
def test_level_extrema_sharded_thresholds_each_volume(batch, jax_one_device,
                                                      shard_dim):
    # The input shows the difference: JAX's shared threshold drops
    # volume 0's extrema.
    f = jax.jit(lambda p, c, n: jextrema_sharded(
        p, c, n, PEAK_THRESH, CAPACITY,
        jmake_mesh(jax.devices()[:1], data=1, space=1), shard_dim=shard_dim))
    j_count = np.asarray(f(*(jnp.asarray(v) for v in batch))[1])
    one = [c for _, c, _ in jax_one_device]
    assert j_count[0] < one[0] and j_count[1] == one[1], (j_count, one)

    m = make_mesh(device="cpu")
    try:
        rows, count, total = level_extrema_sharded(
            *(torch.as_tensor(v) for v in batch), PEAK_THRESH, CAPACITY, m,
            shard_dim=shard_dim)
    finally:
        dist.destroy_process_group()
    p_rows, p_count, p_total = level_extrema(
        *(torch.as_tensor(v) for v in batch), PEAK_THRESH, CAPACITY)
    for b, (zyx, c, t) in enumerate(jax_one_device):
        assert int(count[b]) == c and int(total[b]) == t, (b, count, total)
        np.testing.assert_array_equal(rows[rows[:, 0] == b, 1:].numpy(), zyx)
    assert torch.equal(rows, p_rows) and torch.equal(count, p_count)
    assert torch.equal(total, p_total)
    assert count[0] > 0


def test_card_check_builds_this_batch(batch):
    """``chip_smoke.f3_batch``, the card's copy of this input (its blob
    volumes cannot come from the conftest, which imports JAX), is this
    batch bit for bit."""
    got = f3_batch(torch.device("cpu"))
    assert len(got) == len(batch)
    for g, v in zip(got, batch):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), v)
