"""Frames without plotting packages: the baked colour tables, the
standard-library PNG writer, and the serial CLI run with matplotlib and
PIL blocked."""
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from tpuvof import cli
from tpuvof.io_utils import optional_import, save_frame_png, write_png
from tpuvof.viz import _luts


def read_png(path):
    """Decode an 8-bit RGB, non-interlaced PNG whose rows all use filter
    type 0 (what write_png emits) — enough to check the writer."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    assert (depth, ctype, interlace) == (8, 2, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("name", ["Blues", "coolwarm", "plasma"])
def test_baked_colour_tables_equal_matplotlib(name):
    cm = pytest.importorskip("matplotlib").colormaps[name]
    want = np.asarray(cm(np.linspace(0.0, 1.0, 256)))[:, :3].astype(
        np.float32)
    got = _luts()[name]
    assert got.shape == (256, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (64, 48)])
def test_png_round_trip(tmp_path, h, w):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_png_writer_rejects_non_rgb(tmp_path):
    with pytest.raises(ValueError, match="h, w, 3"):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))


def test_frame_png_orientation(tmp_path):
    """Frames are (x, y) arrays; the image has y up: row 0 of the PNG is
    the frame's last y column."""
    rgb = np.zeros((3, 2, 3), np.float32)
    rgb[0, 1] = (1.0, 0.0, 0.0)  # x=0, top y
    path = tmp_path / "f.png"
    save_frame_png(str(path), rgb)
    img = read_png(str(path))
    assert img.shape == (2, 3, 3)
    assert tuple(img[0, 0]) == (255, 0, 0) and img[1].sum() == 0


def test_optional_import_names_the_package_and_feature(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="--gif needs .*'PIL'"):
        optional_import("PIL.Image", "--gif")


def test_serial_cli_runs_without_matplotlib_or_pil(tmp_path, monkeypatch):
    """The default serial run with PNG frames on needs neither package;
    the extras that do (--gif here) fail with a message naming it."""
    for mod in ("matplotlib", "matplotlib.pyplot", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    rc = cli.main(["-ic", "1", "--nx", "16", "--steps", "4",
                   "--frame-every", "2", "--outdir", str(tmp_path)])
    assert rc == 0
    frames = sorted(f for f in os.listdir(tmp_path) if f.endswith(".png"))
    assert len(frames) == 2
    assert read_png(str(tmp_path / frames[0])).shape == (32, 32, 3)
    with pytest.raises(ImportError, match="PIL"):
        cli.main(["-ic", "1", "--nx", "16", "--steps", "2",
                  "--frame-every", "2", "--gif",
                  "--outdir", str(tmp_path / "g")])
