"""OSCD regional-reference generator (JAX ``tools/oscd_process.py``;
reference OSCDProcess.py).

For each scene directory ``{name}/ImagePair`` under ``--in-path``: reads
``{name}-cm.tif`` (coded 1 unchanged / 2 changed, binarized at > 1,
OSCDProcess.py:57), grows each connected component's bounding box by
``--region-expand`` px (``building_process.expand_regions``) and writes
``{name}-region.tif`` with PIL (OSCDProcess.py:59-78). Host code.

Run: ``python -m fcdgan_tpu_torch.tools.oscd_process --in-path /OSCD-10m-Dataset``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .building_process import expand_regions


def run(in_path: str, ext: str = ".tif", region_expand: int = 10) -> list:
    """Write each scene's region raster; returns their paths, in the order
    ``os.listdir`` gives the scene directories."""
    from PIL import Image

    written = []
    for name in [x for x in os.listdir(in_path) if os.path.isdir(os.path.join(in_path, x))]:
        cur = os.path.join(in_path, name, "ImagePair")
        if not os.path.isdir(cur):
            continue
        refs = [x for x in os.listdir(cur) if x.split("-")[-1] == "cm.tif"]
        if len(refs) != 1:
            raise ValueError(f"Reference {cur} cannot be found")
        ref = np.array(Image.open(os.path.join(cur, refs[0])))
        region = np.zeros_like(ref, dtype=np.uint8)
        region[ref > 1] = 255
        out = os.path.join(cur, "{}-region{}".format(name, ext))
        Image.fromarray(expand_regions(region, region_expand)).save(out)
        written.append(out)
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in-path", required=True)
    ap.add_argument("--region-expand", type=int, default=10)
    a = ap.parse_args(argv)
    return run(a.in_path, region_expand=a.region_expand)


if __name__ == "__main__":
    main()
