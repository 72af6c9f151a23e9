"""Image output: OpenEXR and PNG, written and read with the standard
library and numpy.

Port of wave_tracer_tpu/render/output.py. EXR: single-part scanline
images, ZIP (16 scanlines a block) or no compression, half or float
channels stored in alphabetical order, string metadata attributes; files
are byte-compatible with the JAX package's in both directions. PNG: an
8-bit encoder (grey, grey+alpha, RGB, RGBA; filter 0, zlib) and a decoder
of non-interlaced 8-bit files (grey, grey+alpha, RGB, RGBA and palette,
filters 0-4) for bitmap textures.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2

MAGIC = 20000630


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" \
        + struct.pack("<i", len(data)) + data


def _reorder_zip(data: bytes) -> bytes:
    """EXR zip predictor: delta-encode, then interleave halves."""
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    d = np.empty_like(arr)
    d[0] = arr[0]
    d[1:] = (arr[1:] - arr[:-1] + 128 + 256) & 0xFF
    # split into two halves, interleaved
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = d[0::2]
    out[half:] = d[1::2]
    return out.tobytes()


def _unreorder_unzip(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[0::2] = arr[:half]
    inter[1::2] = arr[half:]
    out = np.cumsum(inter.astype(np.int64) - 128, dtype=np.int64) \
        + 128 * np.arange(1, n + 1) - 128 * np.arange(n) * 0
    # delta decode: b[i] = b[i-1] + (inter[i] - 128)
    dec = np.empty(n, np.uint8)
    acc = 0
    # vectorized cumulative sum implementation
    deltas = inter.astype(np.int64)
    deltas[1:] -= 128
    dec = (np.cumsum(deltas) & 0xFF).astype(np.uint8)
    return dec.tobytes()


def write_exr(path: str, img: np.ndarray, channel_names=None,
              half: bool = True, compress: bool = True,
              metadata: dict | None = None):
    """Write (H, W) or (H, W, C) float image as scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"],
                         4: ["R", "G", "B", "A"]}.get(
            C, [f"ch{i}" for i in range(C)])
    # channels must be stored alphabetically
    order = np.argsort(channel_names)
    ptype = _PIXELTYPE_HALF if half else _PIXELTYPE_FLOAT
    pixsize = 2 if half else 4

    chlist = b""
    for ci in order:
        chlist += channel_names[ci].encode() + b"\0" \
            + struct.pack("<iiii", ptype, 0, 1, 1)
    chlist += b"\0"

    compression = 3 if compress else 0   # 3 = ZIP (16 scanlines)
    block = 16 if compress else 1

    hdr = struct.pack("<i", MAGIC) + struct.pack("<i", 2)
    hdr += _attr("channels", "chlist", chlist)
    hdr += _attr("compression", "compression", bytes([compression]))
    hdr += _attr("dataWindow", "box2i",
                 struct.pack("<4i", 0, 0, W - 1, H - 1))
    hdr += _attr("displayWindow", "box2i",
                 struct.pack("<4i", 0, 0, W - 1, H - 1))
    hdr += _attr("lineOrder", "lineOrder", b"\0")
    hdr += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    hdr += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    hdr += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    for k, v in (metadata or {}).items():
        sv = str(v).encode() + b"\0"
        hdr += _attr(str(k), "string", struct.pack("<i", len(sv) - 1)
                     if False else sv)
    hdr += b"\0"

    dtype = np.float16 if half else np.float32
    if half:
        # clamp to the finite half range: a few hot fireflies otherwise
        # overflow to inf in the cast
        img = np.clip(img, -65504.0, 65504.0)
    blocks = []
    for y0 in range(0, H, block):
        y1 = min(y0 + block, H)
        rows = []
        for y in range(y0, y1):
            for ci in order:
                rows.append(img[y, :, ci].astype(dtype).tobytes())
        raw = b"".join(rows)
        if compress:
            comp = zlib.compress(_reorder_zip(raw), 6)
            if len(comp) >= len(raw):
                comp = raw
        else:
            comp = raw
        blocks.append((y0, comp))

    num_blocks = len(blocks)
    offset_table_size = 8 * num_blocks
    data_start = len(hdr) + offset_table_size
    offsets = []
    pos = data_start
    payloads = []
    for y0, comp in blocks:
        offsets.append(pos)
        payload = struct.pack("<i", y0) + struct.pack("<i", len(comp)) + comp
        payloads.append(payload)
        pos += len(payload)

    with open(path, "wb") as f:
        f.write(hdr)
        for o in offsets:
            f.write(struct.pack("<Q", o))
        for p in payloads:
            f.write(p)


def read_exr(path: str):
    """Minimal reader for files written by write_exr (+ uncompressed/ZIP
    scanline EXRs with half/float channels). Returns (img, channel_names)."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 0

    def take(n):
        nonlocal off
        out = buf[off:off + n]
        off += n
        return out

    magic, version = struct.unpack("<ii", take(8))
    assert magic == MAGIC, "not an EXR file"

    chans = []
    compression = 0
    dw = (0, 0, 0, 0)
    while True:
        # attribute name
        e = buf.index(b"\0", off)
        name = buf[off:e].decode()
        off = e + 1
        if name == "":
            break
        e = buf.index(b"\0", off)
        typ = buf[off:e].decode()
        off = e + 1
        (size,) = struct.unpack("<i", take(4))
        data = take(size)
        if name == "channels":
            p = 0
            while data[p] != 0:
                e2 = data.index(b"\0", p)
                cname = data[p:e2].decode()
                p = e2 + 1
                ptype, _, _, _ = struct.unpack("<iiii", data[p:p + 16])
                p += 16
                chans.append((cname, ptype))
        elif name == "compression":
            compression = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", data)

    W = dw[2] - dw[0] + 1
    H = dw[3] - dw[1] + 1
    C = len(chans)
    block = {0: 1, 2: 1, 3: 16}.get(compression)
    if block is None:
        raise ValueError(f"unsupported compression {compression}")
    num_blocks = (H + block - 1) // block
    take(8 * num_blocks)  # offset table

    img = np.zeros((H, W, C), np.float32)
    for _ in range(num_blocks):
        (y0,) = struct.unpack("<i", take(4))
        (sz,) = struct.unpack("<i", take(4))
        comp = take(sz)
        y1 = min(y0 + block, H)
        rowbytes = sum(2 if pt == _PIXELTYPE_HALF else 4
                       for _, pt in chans) * W
        want = rowbytes * (y1 - y0)
        raw = comp if len(comp) == want else _unreorder_unzip(
            zlib.decompress(comp))
        p = 0
        for y in range(y0, y1):
            for ci, (cname, ptype) in enumerate(chans):
                n = W * (2 if ptype == _PIXELTYPE_HALF else 4)
                dt = np.float16 if ptype == _PIXELTYPE_HALF else np.float32
                img[y, :, ci] = np.frombuffer(raw[p:p + n], dt)
                p += n
    names = [c for c, _ in chans]
    return img, names


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels (8-bit samples); 3 is a palette index
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data \
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img01: np.ndarray) -> bytes:
    """8-bit PNG bytes from a [0,1] float image (H, W) or (H, W, C),
    C in 1-4 (grey, grey+alpha, RGB, RGBA)."""
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    H, W = arr.shape[:2]
    C = 1 if arr.ndim == 2 else arr.shape[-1]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           arr.reshape(H, W * C)], axis=1)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img01: np.ndarray):
    """8-bit PNG file from a [0,1] float image (see encode_png)."""
    with open(path, "wb") as f:
        f.write(encode_png(img01))


def _unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 none, 1 sub, 2 up, 3 average,
    4 Paeth) of H rows of `stride` bytes; returns (H, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < H * (stride + 1):
        raise ValueError("truncated image data")
    data = data[:H * (stride + 1)].reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ft, cur = int(data[y, 0]), data[y, 1:]
        if ft == 0:
            row = cur.copy()
        elif ft == 1:
            row = np.cumsum(cur.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            row = cur + prev
        elif ft in (3, 4):
            row = bytearray(cur.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"bad filter type {ft}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """uint8 array (H, W, C) of a non-interlaced 8-bit PNG: C = 1 grey,
    2 grey+alpha, 3 RGB, 4 RGBA; a palette image expands to RGB (RGBA
    where it has transparency). Other PNGs, and damaged files, raise
    ValueError."""
    try:
        return _decode_png(data)
    except (zlib.error, struct.error) as e:
        raise ValueError(f"damaged PNG: {e}") from e


def _decode_png(data: bytes) -> np.ndarray:
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    off, hdr, plte, trns, idat = 8, None, None, None, []
    while off + 8 <= len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        tag, body = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}): only "
                         f"non-interlaced 8-bit images are read")
    C = _PNG_CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), H, W * C,
                    C).reshape(H, W, C)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:min(len(trns), len(plte))] = trns[:len(plte)]
            return np.concatenate([plte, alpha[:, None]], axis=1)[idx]
        return plte[idx]
    return img


def read_png(path: str) -> np.ndarray:
    """decode_png of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read())
