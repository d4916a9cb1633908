"""Image encode + file output.

The reference never touches image files: its second render pass blits the
HDR accumulation texture to an sRGB swapchain surface and the sRGB encode is
the surface format's job (``sample_framebuffer.wgsl:38-41``; there is no
gamma in shader code — SURVEY.md item 12). Headless, the present
pass becomes: gamma-encode (γ=2.0, RTiOW's convention, per the BASELINE
parity goal), quantize to u8, and write PPM (P6) or PNG.

PNG encoding uses only the Python stdlib (zlib + struct) — no external
image dependency.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np


def gamma_encode(img: np.ndarray, gamma=2.0, exposure: float = 1.0) -> np.ndarray:
    """Clamp to [0,1] and apply the transfer function.

    ``gamma`` is a float exponent (2.0 ⇒ sqrt, RTiOW's convention), the
    string ``"srgb"`` for the piecewise sRGB encode (the inverse EOTF /
    OETF: linear → encoded) — the transfer the reference effectively uses
    by presenting through an sRGB surface format (``lib.rs:1105-1107``),
    so ``--gamma srgb`` output compares pixel-exactly with the live
    reference window — or ``"aces"`` for a filmic tonemap (extension):
    the Narkowicz 2015 rational fit of the ACES RRT+ODT applied to the
    UNCLIPPED linear radiance, then sRGB-encoded. Emissive scenes
    (cornell/light) produce radiance well above 1.0 that every other
    mode hard-clips; ACES rolls those highlights off smoothly instead.

    ``exposure`` is a linear pre-transfer scale (1.0 = neutral, 2.0 =
    +1 stop) applied to the radiance before any encode — the standard
    companion to a filmic tonemap. Display-side only: the HDR sinks
    (write_image ``.pfm``/``.npy``) always carry unscaled radiance.
    """
    img = np.asarray(img, np.float32)
    if exposure != 1.0:
        img = img * np.float32(exposure)
    if gamma == "aces":
        x = np.maximum(img, 0.0)
        tone = x * (np.float32(2.51) * x + np.float32(0.03)) / (
            x * (np.float32(2.43) * x + np.float32(0.59)) + np.float32(0.14)
        )
        return gamma_encode(tone, "srgb")
    img = np.clip(img, 0.0, 1.0)
    if gamma == "srgb":
        lo = img * np.float32(12.92)
        hi = np.float32(1.055) * img ** np.float32(1.0 / 2.4) - np.float32(0.055)
        return np.where(img <= 0.0031308, lo, hi)
    gamma = float(gamma)
    if gamma == 2.0:
        return np.sqrt(img)
    if gamma == 1.0:
        return img
    return img ** np.float32(1.0 / gamma)


def to_u8(img: np.ndarray, gamma=2.0, exposure: float = 1.0) -> np.ndarray:
    """[H,W,3] float radiance → [H,W,3] u8 with gamma/sRGB encode."""
    enc = gamma_encode(img, gamma, exposure)
    return (enc * 255.0 + 0.5).astype(np.uint8)


def parse_gamma(value):
    """CLI ``--gamma`` values: a float exponent, 'srgb', or 'aces'."""
    if isinstance(value, str) and value.strip().lower() in ("srgb", "aces"):
        return value.strip().lower()
    try:
        g = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"gamma must be a float, 'srgb', or 'aces', got {value!r}"
        )
    if g <= 0:
        raise ValueError(f"gamma must be positive, got {g}")
    return g


def write_ppm(path, u8: np.ndarray) -> None:
    """Binary PPM (P6)."""
    h, w, c = u8.shape
    assert c == 3 and u8.dtype == np.uint8
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def read_ppm(path) -> np.ndarray:
    """Read binary PPM (P6) — used by tests to round-trip output."""
    data = pathlib.Path(path).read_bytes()
    fields = []
    pos = 0
    while len(fields) < 4:
        # tokens separated by whitespace; '#' comments run to end of line
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    assert magic == b"P6" and maxval == 255
    return np.frombuffer(data[pos : pos + w * h * 3], np.uint8).reshape(h, w, 3)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(u8: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib zlib; filter type 0 per scanline)."""
    h, w, c = u8.shape
    assert c == 3 and u8.dtype == np.uint8
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)], axis=1
    ).tobytes()
    idat = zlib.compress(raw, level=6)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", idat)
        + _png_chunk(b"IEND", b"")
    )


def write_png(path, u8: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (see ``encode_png``)."""
    with open(path, "wb") as f:
        f.write(encode_png(u8))


def read_png(path) -> np.ndarray:
    """Minimal PNG reader for our own writer's output (tests only)."""
    data = pathlib.Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bits, color = struct.unpack(">IIBB", payload[:10])
            assert bits == 8 and color == 2
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 3 + 1)
    assert (raw[:, 0] == 0).all(), "only filter 0 supported"
    return raw[:, 1:].reshape(h, w, 3)


def write_pfm(path, img: np.ndarray) -> None:
    """Write float32 data as Portable FloatMap (PFM) — the HDR sink.

    ``PF`` for [H, W, 3] color, ``Pf`` for [H, W] grayscale (e.g. a
    depth AOV); scale ``-1.0`` = little-endian; rows bottom-to-top per
    the format. Raw linear values — no transfer function, no quantize —
    so a renderer's radiance (or any float AOV) roundtrips exactly.
    """
    img = np.ascontiguousarray(np.asarray(img, np.float32))
    if img.ndim == 3 and img.shape[2] == 3:
        magic = b"PF"
    elif img.ndim == 2:
        magic = b"Pf"
    else:
        raise ValueError(f"PFM needs [H,W,3] or [H,W], got {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n-1.0\n" % (w, h))
        f.write(img[::-1].tobytes())  # bottom-up row order


def read_pfm(path) -> np.ndarray:
    """Read a PFM written by write_pfm (little-endian only)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        if scale >= 0:
            raise ValueError("big-endian PFM not supported")
        chans = 3 if magic == b"PF" else 1
        data = np.frombuffer(f.read(w * h * chans * 4), "<f4")
    img = data.reshape((h, w, 3) if chans == 3 else (h, w))
    return img[::-1].copy()


def write_image(path, img: np.ndarray, gamma: float = 2.0,
                exposure: float = 1.0) -> None:
    """Write float radiance by extension: .ppm/.png (gamma-encoded u8)
    or the HDR sinks .pfm/.npy (raw linear float32, gamma and exposure
    ignored — compositing gets the untouched radiance)."""
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    if suffix == ".pfm":
        write_pfm(path, np.asarray(img, np.float32))
        return
    if suffix == ".npy":
        np.save(path, np.asarray(img, np.float32))
        return
    u8 = to_u8(np.asarray(img), gamma, exposure)
    if suffix == ".ppm":
        write_ppm(path, u8)
    elif suffix == ".png":
        write_png(path, u8)
    else:
        raise ValueError(f"unsupported image extension: {path.suffix!r}")
