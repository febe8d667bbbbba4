"""The standard-library PNG writer round-trips exactly."""

import struct
import zlib

import numpy as np
import pytest

from nvsf_tpu.lib.tools import write_png


def _read_png(path):
    """Minimal decoder for what write_png emits: 8-bit, unfiltered rows."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and b"IEND" in chunks
    ch = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * ch)
    assert (rows[:, 0] == 0).all()
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("shape", [(5, 7), (4, 9, 3), (3, 2, 4)])
def test_write_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(_read_png(path), img)
