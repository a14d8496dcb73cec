"""The torch blob generator repeats from its seed."""

import torch

from portbench import volumes


def test_same_seed_same_volumes():
    big = 2 ** 31 + 12345
    a = volumes.blob_volumes(2, (24, 28, 32), 12,
                             volumes.generator(big, "cpu"), "cpu")
    b = volumes.blob_volumes(2, (24, 28, 32), 12,
                             volumes.generator(big, "cpu"), "cpu")
    c = volumes.blob_volumes(2, (24, 28, 32), 12,
                             volumes.generator(big + 1, "cpu"), "cpu")
    assert a.shape == (2, 24, 28, 32) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert float(a.max()) > 0.2 and float(a.min()) >= 0.0


def test_chunking_does_not_change_the_volumes():
    g = lambda: volumes.generator(3, "cpu")  # noqa: E731
    a = volumes.blob_volumes(3, (20, 20, 20), 10, g(), "cpu")
    b = volumes.blob_volumes(3, (20, 20, 20), 10, g(), "cpu",
                             chunk_voxels=8000 * 3)
    assert torch.allclose(a, b, atol=1e-6)


def _whole_volume(vols_shape, nblob, gen, aniso=2.0, sig_lo=1.5,
                  sig_hi=4.0, amp_lo=0.3):
    """The blob model evaluated on every voxel of every volume."""
    n, shape = vols_shape[0], vols_shape[1:]
    dims = torch.tensor(shape, dtype=torch.float32)
    u = torch.rand((n, nblob, 8), generator=gen)
    g = torch.randn((n, nblob, 3, 3), generator=gen)
    centre = 4.0 + u[..., :3] * (dims - 8.0)
    sig0 = sig_lo + u[..., 3] * (sig_hi - sig_lo)
    sig = torch.stack([sig0, sig0 * (1 + u[..., 4] * (aniso - 1)),
                       sig0 * (1 + u[..., 5] * (aniso - 1))], -1)
    amp = amp_lo + u[..., 6] * (1 - amp_lo)
    Q = torch.linalg.qr(g.double())[0].float()
    Sinv = Q @ torch.diag_embed(1 / sig ** 2) @ Q.transpose(-1, -2)
    r = 5 * sig.amax(-1)
    grid = torch.meshgrid(*[torch.arange(m, dtype=torch.float32)
                            for m in shape], indexing="ij")
    out = torch.zeros(vols_shape)
    for v in range(n):
        for j in range(nblob):
            d = [grid[a] - centre[v, j, a] for a in range(3)]
            q = sum(Sinv[v, j, a, b] * d[a] * d[b] for a in range(3)
                    for b in range(3))
            inside = (d[0].abs() <= r[v, j]) & (d[1].abs() <= r[v, j]) & \
                (d[2].abs() <= r[v, j])
            out[v] += torch.where(inside, torch.exp(-0.5 * q), 0.0) * \
                amp[v, j]
    return out


def test_boxes_equal_the_whole_volume():
    """Evaluating each blob in its box gives the model evaluated on every
    voxel, on a volume larger than the widest box."""
    a = volumes.blob_volumes(2, (90, 100, 96), 7, volumes.generator(5, "cpu"),
                             "cpu")
    b = _whole_volume((2, 90, 100, 96), 7, volumes.generator(5, "cpu"))
    assert torch.allclose(a, b, atol=1e-6)


def test_pairs():
    src, ref = volumes.pairs(2, (16, 16, 16), 6, 3,
                             volumes.generator(1, "cpu"), "cpu")
    assert torch.equal(ref, torch.roll(src, 3, dims=-1))
