"""Image IO (a copy of svgf_tpu/utils/image.py, which is NumPy; the port
imports nothing of svgf_tpu). PNG and Radiance HDR without external deps,
plus a PIL-backed `read_image` dispatch for JPEG & friends (the reference
loads LDR and HDR float images through stb_image, ImageLoader.cpp:28-127),
and the `psnr`/`ssim` image metrics."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """Write an (H, W, 3|4) float [0,1] or uint8 array as a PNG."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = to_uint8(a)
    if a.ndim == 2:
        a = a[..., None].repeat(3, axis=-1)
    h, w, c = a.shape
    assert c in (3, 4)
    color_type = 2 if c == 3 else 6

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB/RGBA, no interlace) -> uint8 (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = ct = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ct, comp, filt, inter = struct.unpack(">IIBBBBB", body)
            assert depth == 8 and inter == 0 and ct in (2, 6)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    c = 3 if ct == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, w, c), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ft = raw[r * (stride + 1)]
        line = np.frombuffer(
            raw[r * (stride + 1) + 1 : (r + 1) * (stride + 1)], np.uint8
        ).astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = line.copy()
            for i in range(c, stride):
                cur[i] = (cur[i] + cur[i - c]) & 0xFF
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - c] if i >= c else 0
                b = prev[i]
                cc = prev[i - c] if i >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ft}")
        out[r] = cur.astype(np.uint8).reshape(w, c)
        prev = cur
    return out


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr) — the reference's float/HDR path (ImageLoader.cpp:67-95,
# via stb_image's HDR loader). RGBE decode matches stb: c * 2^(e-136).
# ---------------------------------------------------------------------------


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 (linear radiance)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    assert res[0] == b"-Y" and res[2] == b"+X", f"unsupported orientation {res}"
    h, w = int(res[1]), int(res[3])
    pos = eol + 1

    out = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if w < 8 or w > 0x7FFF or data[pos] != 2 or data[pos + 1] != 2:
            # flat (old-style) scanline
            row = np.frombuffer(data[pos : pos + 4 * w], np.uint8).reshape(w, 4)
            out[y] = row
            pos += 4 * w
            continue
        assert (data[pos + 2] << 8 | data[pos + 3]) == w, "RLE width mismatch"
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                n = data[pos]
                if n > 128:  # run
                    out[y, x : x + n - 128, c] = data[pos + 1]
                    x += n - 128
                    pos += 2
                else:  # literal
                    out[y, x : x + n, c] = np.frombuffer(
                        data[pos + 1 : pos + 1 + n], np.uint8
                    )
                    x += n
                    pos += 1 + n
    img = _rgbe_to_float(out)
    # NaN/inf scrub (reference ImageLoader.cpp:121-127)
    return np.nan_to_num(img, nan=0.0, posinf=0.0, neginf=0.0)


def write_hdr(path: str, img) -> None:
    """Write (H, W, 3) float32 as an uncompressed Radiance .hdr."""
    a = np.asarray(img, np.float32)[..., :3]
    h, w = a.shape[:2]
    m = a.max(axis=-1)
    e = np.zeros((h, w), np.int32)
    valid = m >= 1e-32
    _, e_v = np.frexp(np.where(valid, m, 1.0))
    scale = np.ldexp(1.0, -e_v + 8).astype(np.float32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(a * scale[..., None], 0, 255).astype(np.uint8)
    e = np.where(valid, e_v + 128, 0)
    rgbe[..., 3] = e.astype(np.uint8)
    rgbe[~valid] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_image(path: str, *, as_float: bool = False) -> np.ndarray:
    """Load any supported image (reference LoadImage dispatch,
    ImageLoader.cpp:28-95): .hdr -> float32 (H,W,3); PNG via the built-in
    reader; JPEG/anything else via PIL when available. as_float converts
    LDR images to [0,1] float32."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".png":
        img = read_png(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover
            raise ValueError(
                f"{path}: format {ext!r} needs PIL (not available)"
            ) from e
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGBA" if im.mode in ("RGBA", "LA", "P") else "RGB"))
    if as_float:
        return img.astype(np.float32) / 255.0
    return img


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over float images in [0, peak]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004), 8x8 uniform windows, per channel.

    Plain-numpy implementation for the gallery-parity report (PARITY.md);
    matches the standard constants C1=(0.01*peak)^2, C2=(0.03*peak)^2.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2

    def blocks(x):
        h, w, c = x.shape
        hb, wb = h // 8, w // 8
        return x[: hb * 8, : wb * 8].reshape(hb, 8, wb, 8, c)

    ab, bb = blocks(a), blocks(b)
    mu_a = ab.mean(axis=(1, 3))
    mu_b = bb.mean(axis=(1, 3))
    va = ab.var(axis=(1, 3))
    vb = bb.var(axis=(1, 3))
    cov = (ab * bb).mean(axis=(1, 3)) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    )
    return float(s.mean())
