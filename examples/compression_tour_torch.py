#!/usr/bin/env python
"""Compression tour on the PyTorch port: every scheme against the data
shape it is built for.

Prints a ratio/validity table (encode host-side, decode on ``device``,
the card unless ``--device cpu`` is asked, bit-exact check vs the NumPy
oracle) plus what the advisor would have picked. The same columns and the
same table as examples/compression_tour.py:

    python examples/compression_tour_torch.py [log2_n] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import giddy_tpu_torch as gtt
from giddy_tpu_torch.advisor import suggest
from giddy_tpu_torch.datagen import gen_column

SCHEMES = [
    "nbit", "for", "delta", "delta2", "xordelta", "alp", "dict", "rle",
    "rpe", "model", "bitmap", "dzbf", "dzbv", "patched", "cascade", "raw",
]


def main(log2_n: int = 20, device: torch.device | str = "cuda") -> None:
    n = 1 << log2_n
    rng = np.random.default_rng(7)
    print(f"{'scheme':9s} {'home-turf data':28s} {'ratio':>7s}  {'advisor top pick'}")
    for scheme in SCHEMES:
        v = gen_column(scheme, n, rng)
        col = gtt.encode(v, scheme)
        out = gtt.decode(col, device=device)
        # a tensor on device; a column decoded in group chunks comes back as NumPy
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        ref = gtt.decode_ref(col)
        np.testing.assert_array_equal(
            out.view(np.uint32), ref.view(np.uint32), err_msg=scheme
        )
        top = suggest(v, device=device)[0]
        desc = {
            "nbit": "9-bit ints", "for": "narrow-range timestamps",
            "delta": "sorted timestamps",
            "delta2": "regularly-sampled timestamps",
            "xordelta": "slow-varying float32",
            "alp": "decimal float32 prices",
            "dict": "40-value vocabulary", "rle": "long status runs",
            "rpe": "long status runs", "model": "linear-trend ints",
            "bitmap": "4 distinct values", "dzbf": "low-byte ints",
            "dzbv": "mixed-width ints", "patched": "ints + rare outliers",
            "cascade": "runs of dictionary codes", "raw": "uniform random",
        }[scheme]
        print(f"{scheme:9s} {desc:28s} {col.ratio:6.1f}x  {top[0]} ({top[1]:.1f}x)")
    print("all schemes decoded bit-exact vs the oracle")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("log2_n", nargs="?", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(args.log2_n, args.device)
