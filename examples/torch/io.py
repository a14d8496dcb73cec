"""Image IO round trip.

The PyTorch port's counterpart of ``examples/io.py`` (the reference's
examples/ioC.c): read an image, print its dimensions and units, and write
it back in another format. Like every entry point of the port it runs on
the card unless ``main`` is given another device, and refuses to start
without one.

Usage: python examples/torch/io.py in.nii.gz out.dcm
"""

import sys

from sift3d_tpu_torch.dtypes import resolve_device
from sift3d_tpu_torch.io import im_read, im_write


def main(in_path: str, out_path: str, device=None) -> int:
    resolve_device(device)
    vol = im_read(in_path)
    nz, ny, nx = vol.data.shape[:3]
    print(f"dims (x, y, z): ({nx}, {ny}, {nz})  channels: {vol.nc}")
    print(f"units (mm): {vol.units}")
    im_write(out_path, vol)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
