"""Output artifacts and checkpointing (layer L4).

Rendered frames are written as PNG with the standard library alone
(`write_png`); matplotlib and PIL are imported only for the extras that
need them (the -s contourf figure, the vector overlay, --gif, and the
optimization figures), and `optional_import` names the missing package
when one is absent.

Reference outputs: PNG frames via matplotlib contourf (2dvof.py:563-571),
per-opt GUI screenshots (diff_vof.py:554), VTK volumes via pyevtk
(3dvof.py:624-627). Checkpoint/resume does not exist in the reference
(SURVEY.md §5) — here the state pytree round-trips through npz, a strict
superset of reference behavior.

The VTK writer is self-contained (pyevtk is not available in this image):
legacy VTK STRUCTURED_POINTS, binary big-endian f32 — readable by ParaView
/ VisIt exactly like the reference's .vtr output.
"""
from __future__ import annotations

import importlib
import json
import struct
import zlib
from dataclasses import asdict

import numpy as np

from .config import SimConfig
from .state import State

__all__ = [
    "optional_import",
    "write_png",
    "save_frame_png",
    "save_contour_png",
    "save_side_by_side_png",
    "save_grad_png",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_3d",
    "load_checkpoint_3d",
    "write_vtk",
]


def save_side_by_side_png(path: str, F_current, F_target):
    """The in-optimization current-vs-target buffer (diff_vof.py:448-454,
    526-554: get_field_to_buf stacks the evolving F beside Ftarget in one
    window each epoch)."""
    plt = _plt("the optimization figures")

    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, (title, field) in zip(
        axes, (("current F", F_current), ("target", F_target))
    ):
        ax.imshow(np.asarray(field).T, origin="lower", cmap=plt.cm.Blues,
                  vmin=0, vmax=1)
        ax.set_title(title)
        ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_grad_png(path: str, grad):
    """Gradient-field rendering (test/diff_fct.py:370-375: F.grad scaled
    into a display buffer beside the optimization view); diverging colormap
    centered on zero so sign structure is visible."""
    plt = _plt("the optimization figures")

    g = np.asarray(grad)
    lim = np.abs(g).max() or 1.0
    plt.figure(figsize=(5, 5))
    plt.axis("off")
    plt.imshow(g.T, origin="lower", cmap=plt.cm.coolwarm, vmin=-lim, vmax=lim)
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def optional_import(module: str, feature: str):
    """Import an optional package for one feature, or raise an ImportError
    that names the package and the feature."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = module.split(".")[0]
        raise ImportError(
            f"{feature} needs the optional package {package!r}, which is "
            f"not installed; run without {feature} or install {package}"
        ) from e


def _plt(feature: str):
    """pyplot for file output WITHOUT globally switching the backend:
    matplotlib.use('Agg') after pyplot exists closes every open figure,
    which killed a live viewer/paint window whenever a frame was saved.
    savefig renders through Agg regardless of the GUI backend, so only
    force Agg when matplotlib is not yet loaded (headless safety)."""
    import sys

    matplotlib = optional_import("matplotlib", feature)
    if "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def write_png(path: str, img) -> None:
    """Write an (h, w, 3) uint8 image as an 8-bit RGB PNG using only the
    standard library (zlib + struct): one IHDR, one IDAT, filter type 0
    on every row."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def save_frame_png(path: str, rgb, arrows=None):
    """Write an RGB frame (optionally with the arrow overlay) to a PNG.
    Without arrows no plotting package is touched."""
    rgb = np.asarray(rgb)
    # frame arrays are (x, y); images are (row=y downward, col=x)
    img = np.transpose(rgb, (1, 0, 2))[::-1]
    if arrows is None:
        write_png(path, np.round(np.clip(img, 0.0, 1.0) * 255.0))
        return
    plt = _plt("the vectors view overlay")
    h, w = img.shape[:2]
    fig = plt.figure(figsize=(w / 100, h / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    # the arrows use y-up coordinates, so draw the y-up (UNflipped) rows
    # with origin='lower' — flipping twice mirrored the background against
    # the velocity overlay
    ax.imshow(np.clip(img[::-1], 0, 1), extent=[0, 1, 0, 1],
              origin="lower")
    begin, incre = arrows
    ax.quiver(
        begin[:, 0], begin[:, 1], incre[:, 0], incre[:, 1],
        angles="xy", scale_units="xy", scale=1.0, color="black", width=0.002,
    )
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.axis("off")
    fig.savefig(path)
    plt.close(fig)


def save_contour_png(path: str, F, Lx: float, Ly: float):
    """The reference's -s figure: plt.contourf(F.T, cmap=Blues), figure size
    (5, Ly/Lx*5), axes off (2dvof.py:563-571)."""
    plt = _plt("the -s contourf figure")

    Fnp = np.asarray(F)
    fx, fy = 5, Ly / Lx * 5
    plt.figure(figsize=(fx, fy))
    plt.axis("off")
    plt.contourf(Fnp.T, cmap=plt.cm.Blues)
    plt.savefig(path)
    plt.close()


def save_checkpoint(path: str, cfg: SimConfig, state: State, istep: int):
    """npz checkpoint of the full state pytree + step counter + config echo."""
    np.savez_compressed(
        path,
        F=np.asarray(state.F),
        u=np.asarray(state.u),
        v=np.asarray(state.v),
        p=np.asarray(state.p),
        istep=np.int64(istep),
        config=json.dumps(
            {
                "grid": asdict(cfg.grid),
                "fluid": asdict(cfg.fluid),
                "num": asdict(cfg.num),
            }
        ),
    )


def load_checkpoint(path: str):
    """Returns (state, istep, config_dict). The caller decides whether the
    config matches its own (a mismatch is surfaced, not silently adopted)."""
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        state = State(
            F=jnp.asarray(z["F"]),
            u=jnp.asarray(z["u"]),
            v=jnp.asarray(z["v"]),
            p=jnp.asarray(z["p"]),
        )
        return state, int(z["istep"]), json.loads(str(z["config"]))


def save_checkpoint_3d(path: str, g, state, istep: int):
    """3-D twin of save_checkpoint: the five-field State3D + step counter
    + grid echo — the failure-recovery artifact for the long 200^3
    flagship runs (the reference's 3dvof.py has no restart mechanism;
    re-running from step 0 at 200^3 x many-thousand steps is the
    alternative)."""
    np.savez_compressed(
        path,
        F=np.asarray(state.F),
        u=np.asarray(state.u),
        v=np.asarray(state.v),
        w=np.asarray(state.w),
        p=np.asarray(state.p),
        istep=np.int64(istep),
        grid=json.dumps(asdict(g)),
    )


def load_checkpoint_3d(path: str):
    """Returns (State3D, istep, grid_dict); the caller validates the grid
    against its own (cf. load_checkpoint)."""
    import jax.numpy as jnp

    from .state import State3D

    with np.load(path, allow_pickle=False) as z:
        state = State3D(
            F=jnp.asarray(z["F"]),
            u=jnp.asarray(z["u"]),
            v=jnp.asarray(z["v"]),
            w=jnp.asarray(z["w"]),
            p=jnp.asarray(z["p"]),
        )
        return state, int(z["istep"]), json.loads(str(z["grid"]))


def frames_to_gif(frame_paths, out_path: str, fps: int = 20):
    """Assemble PNG frames into a GIF — the in-framework replacement for the
    Taichi CLI video/gif tools the reference README delegates to
    (README.md:39-45)."""
    Image = optional_import("PIL.Image", "--gif")

    frames = [Image.open(p).convert("P") for p in sorted(frame_paths)]
    if not frames:
        raise ValueError("no frames to assemble")
    frames[0].save(
        out_path,
        save_all=True,
        append_images=frames[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return out_path


def write_vtk(path: str, point_data: dict, spacing=(1.0, 1.0, 1.0)):
    """Legacy-format VTK STRUCTURED_POINTS volume (binary, big-endian f32).

    `point_data` maps field name -> 3-D array. Equivalent artifact to the
    reference's gridToVTK dump (3dvof.py:624-627).
    """
    first = next(iter(point_data.values()))
    nx, ny, nz = first.shape
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"tpuvof volume\n")
        f.write(b"BINARY\n")
        f.write(b"DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n".encode())
        f.write(b"ORIGIN 0 0 0\n")
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n".encode())
        f.write(f"POINT_DATA {nx * ny * nz}\n".encode())
        for name, arr in point_data.items():
            arr = np.asarray(arr, dtype=np.float32)
            if arr.shape != (nx, ny, nz):
                raise ValueError(f"field {name} shape {arr.shape} != {(nx, ny, nz)}")
            f.write(f"SCALARS {name} float 1\n".encode())
            f.write(b"LOOKUP_TABLE default\n")
            # VTK wants x varying fastest; arrays are indexed [x, y, z]
            f.write(arr.transpose(2, 1, 0).astype(">f4").tobytes())
            f.write(b"\n")
    return path
