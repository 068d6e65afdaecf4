"""Bake the three 256-entry matplotlib colour tables the frame renderer
uses (Blues, coolwarm, plasma) into tpuvof/colormaps.npz, so rendering
frames needs no matplotlib at run time.

    python scripts/make_colormaps.py
"""
from __future__ import annotations

import os

import numpy as np

NAMES = ("Blues", "coolwarm", "plasma")
OUT = os.path.join(os.path.dirname(__file__), "..", "tpuvof", "colormaps.npz")


def lut(name: str) -> np.ndarray:
    """(256, 3) float32 RGB table of a matplotlib colormap."""
    import matplotlib

    cmap = matplotlib.colormaps[name]
    return np.asarray(cmap(np.linspace(0.0, 1.0, 256)))[:, :3].astype(
        np.float32)


def main() -> None:
    np.savez_compressed(OUT, **{n: lut(n) for n in NAMES})
    print(f"wrote {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
