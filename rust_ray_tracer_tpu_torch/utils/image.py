"""PNG output and the image-texture decoders, in pure numpy + zlib.

Counterpart of ``rust_ray_tracer_tpu/utils/image.py``:

  * ``encode_png`` and ``save_png`` (``image.py:27-56``). The reference
    writes each pixel at ``(x, height-1-y)`` (the reference's
    ``src/main.rs:105-109``); here the renderer produces a top-down
    [H, W, 3] array and :func:`save_png` applies the same vertical flip;
  * the decoders an ``ImageTexture`` falls back to where PIL is not
    installed (``image.py:59-787``, copied): :func:`decode_png` (8-bit
    RGB and RGBA, filters 0-4), :func:`decode_jpeg` (baseline and
    progressive Huffman), :func:`decode_bmp` (uncompressed 8/24/32-bit),
    :func:`decode_gif` (the first frame) and :func:`decode_tiff` (8-bit
    strips: none, PackBits or LZW), and :func:`decode_image`, which picks
    one by the file's magic bytes as the reference's ``image`` crate
    guesses formats. Each returns uint8 [H, W, 3].
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got shape {rgb.shape}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # filter byte 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, rgb: np.ndarray, flip_vertical: bool = True) -> None:
    """Save [H, W, 3] u8. ``flip_vertical=True`` replicates the
    reference's ``put_pixel(x, height-1-y)`` convention (main.rs:108)."""
    img = np.asarray(rgb)
    if flip_vertical:
        img = img[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """Minimal PNG decoder for 8-bit RGB/RGBA with filters 0-4 (used by
    golden-image tests and ImageTexture loading without PIL)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    bit_depth = color_type = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    assert bit_depth == 8 and color_type in (2, 6), "only 8-bit RGB(A)"
    nch = 3 if color_type == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 1:
            cur = line.copy()
            for i in range(nch, stride):
                cur[i] = (cur[i] + cur[i - nch]) & 0xFF
        elif filt == 2:
            cur = (line + prev) & 0xFF
        elif filt == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - nch] if i >= nch else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif filt == 4:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                cc = prev[i - nch] if i >= nch else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, nch)[..., :3]


# ---------------------------------------------------------------------------
# JPEG decoder (pure numpy) — the PIL-free fallback for ImageTexture
# (models/scene.py). The reference reads textures with the `image` crate
# (texture.rs:84-131); this covers the same practical surface: baseline
# sequential (SOF0/1) AND progressive (SOF2) Huffman JPEG, 8-bit,
# greyscale or YCbCr with 4:4:4 / 4:2:2 / 4:2:0 sampling, restart
# markers, spectral selection + successive approximation. Decoding is
# scan→coefficient-buffer→vectorized IDCT; arithmetic-coded and
# hierarchical JPEGs raise ValueError (caller degrades to the
# reference's solid-yellow missing-texture behaviour).
# ---------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# orthonormal 8-point DCT-II basis; IDCT(block) = A.T @ block @ A
_DCT_A = np.array([[np.cos((2 * j + 1) * i * np.pi / 16)
                    * (np.sqrt(0.125) if i == 0 else 0.5)
                    for j in range(8)] for i in range(8)])


class _Bits:
    """MSB-first bit reader over entropy-coded data (FF00 unstuffed).
    Reads past the end yield 0 (truncated final MCU — matches libjpeg's
    fill-with-zero behaviour for slightly short streams)."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.bit = 0

    def read(self) -> int:
        if self.pos >= len(self.d):
            return 0
        b = self.d[self.pos]
        v = (b >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.pos += 1
        return v

    def receive(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read()
        return v

    def align(self) -> None:
        if self.bit:
            self.bit = 0
            self.pos += 1


def _extend(v: int, n: int) -> int:
    """JPEG F.2.2.1 sign extension."""
    return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v


def _huff_table(bits_counts, symbols):
    """code -> symbol dict keyed by (length, code)."""
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits_counts[length - 1]):
            table[(length, code)] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _huff_decode(bits: _Bits, table) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | bits.read()
        sym = table.get((length, code))
        if sym is not None:
            return sym
    raise ValueError("bad huffman code")


def _jpeg_scan_payload(data: bytes, j: int):
    """Entropy-coded bytes from ``j`` to the next non-RST marker:
    FF00 unstuffed, split into segments at RSTn markers. Returns
    (segments, index of the terminating marker's 0xFF)."""
    segments = []
    cur = bytearray()
    n = len(data)
    while j < n - 1:
        b = data[j]
        if b == 0xFF:
            nxt = data[j + 1]
            if nxt == 0x00:
                cur.append(0xFF)
                j += 2
                continue
            if 0xD0 <= nxt <= 0xD7:
                segments.append(bytes(cur))
                cur = bytearray()
                j += 2
                continue
            break
        cur.append(b)
        j += 1
    segments.append(bytes(cur))
    return segments, j


def _decode_block(zz, bits, dc_tbl, ac_tbl, pred, cid, ss, se, ah, al,
                  state):
    """Decode one 8x8 block's contribution from the current scan into
    the zigzag-order coefficient vector ``zz`` (JPEG F.2.2 / G.2;
    progressive successive-approximation refinement follows the
    libjpeg jdphuff.c structure)."""
    if ss == 0:                                   # DC band
        if ah == 0:
            s = _huff_decode(bits, dc_tbl)
            pred[cid] += _extend(bits.receive(s), s)
            zz[0] = pred[cid] << al
        else:                                     # DC refinement: one bit
            if bits.read():
                zz[0] |= 1 << al
        if se == 0:
            return
        k = 1
    else:
        k = ss

    if ah == 0:                                   # AC first pass
        if state["eobrun"] > 0:
            state["eobrun"] -= 1
            return
        while k <= se:
            rs = _huff_decode(bits, ac_tbl)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r == 15:                       # ZRL: 16 zeros
                    k += 16
                    continue
                state["eobrun"] = (1 << r) - 1    # EOBn run
                if r:
                    state["eobrun"] += bits.receive(r)
                break
            k += r
            if k > se:
                raise ValueError("AC overflow")
            zz[k] = _extend(bits.receive(s), s) << al
            k += 1
    else:                                         # AC refinement
        bit = 1 << al

        def correct(kk):
            # correction bit for an already-nonzero coefficient
            if bits.read() and not (zz[kk] & bit):
                zz[kk] += bit if zz[kk] > 0 else -bit

        if state["eobrun"] > 0:
            state["eobrun"] -= 1
            for kk in range(k, se + 1):
                if zz[kk]:
                    correct(kk)
            return
        while k <= se:
            rs = _huff_decode(bits, ac_tbl)
            r, s = rs >> 4, rs & 15
            newval = 0
            if s == 0:
                if r < 15:                        # EOBn: finish corrections
                    state["eobrun"] = (1 << r) - 1
                    if r:
                        state["eobrun"] += bits.receive(r)
                    for kk in range(k, se + 1):
                        if zz[kk]:
                            correct(kk)
                    return
                # r == 15, s == 0: skip 16 zero-history coefficients
            else:
                newval = bit if bits.read() else -bit
            while k <= se:
                if zz[k]:
                    correct(k)
                else:
                    if r == 0:
                        if newval:
                            zz[k] = newval
                        k += 1
                        break
                    r -= 1
                k += 1


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline or progressive Huffman JPEG to uint8 [H, W, 3].

    All scans accumulate into per-component zigzag coefficient buffers
    (progressive = partial bands/bits per scan; baseline = one full
    scan), then one vectorized dequantize+IDCT produces the planes.
    """
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    qt = {}
    huff_dc, huff_ac = {}, {}
    comps = None
    h = w = 0
    restart_interval = 0
    scans = []   # (sel, order, ss, se, ah, al, segments, rst, dc_snap, ac_snap)
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        i += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        seg_len = (data[i] << 8) | data[i + 1]
        seg = data[i + 2:i + seg_len]
        if marker == 0xDB:                       # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                j += 1
                if pq:
                    tbl = np.frombuffer(seg[j:j + 128],
                                        dtype=">u2").astype(np.int32)
                    j += 128
                else:
                    tbl = np.frombuffer(seg[j:j + 64],
                                        dtype=np.uint8).astype(np.int32)
                    j += 64
                qt[tq] = tbl
        elif marker in (0xC0, 0xC1, 0xC2):       # SOF0/1 baseline, SOF2 prog
            h = (seg[1] << 8) | seg[2]
            w = (seg[3] << 8) | seg[4]
            nc = seg[5]
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError("unsupported JPEG coding process")
        elif marker == 0xC4:                     # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                counts = list(seg[j + 1:j + 17])
                n = sum(counts)
                syms = list(seg[j + 17:j + 17 + n])
                (huff_ac if tc else huff_dc)[th] = _huff_table(counts,
                                                               syms)
                j += 17 + n
        elif marker == 0xDD:                     # DRI
            restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:                     # SOS
            ns = seg[0]
            sel = {}
            order = []
            for c in range(ns):
                cid = seg[1 + 2 * c]
                sel[cid] = (seg[2 + 2 * c] >> 4, seg[2 + 2 * c] & 15)
                order.append(cid)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            segments, j = _jpeg_scan_payload(data, i + seg_len)
            # Huffman tables may be redefined between scans: snapshot
            scans.append((sel, order, ss, se, ah, al, segments,
                          restart_interval, dict(huff_dc), dict(huff_ac)))
            i = j
            continue
        i += seg_len
    if comps is None or not scans:
        raise ValueError("incomplete JPEG")

    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    by_id = {c["id"]: ci for ci, c in enumerate(comps)}
    for c in comps:
        c["bx"] = mcux * c["h"]                  # padded (interleaved) dims
        c["by"] = mcuy * c["v"]
        compw = -(-w * c["h"] // hmax)           # component resolution
        comph = -(-h * c["v"] // vmax)
        c["nbx"] = -(-compw // 8)                # actual block dims
        c["nby"] = -(-comph // 8)                # (non-interleaved scans)
    coefs = [np.zeros((c["by"], c["bx"], 64), np.int32) for c in comps]

    for sel, order, ss, se, ah, al, segments, rst, hdc, hac in scans:
        pred = {cid: 0 for cid in order}
        state = {"eobrun": 0, "seg": 0, "bits": _Bits(segments[0])}

        def _restart():
            state["seg"] += 1
            state["bits"] = _Bits(segments[state["seg"]])
            state["eobrun"] = 0
            for cid in pred:
                pred[cid] = 0

        n_unit = 0
        if len(order) == 1:
            # non-interleaved: raster over the component's own blocks
            cid = order[0]
            ci = by_id[cid]
            c = comps[ci]
            dc_t, ac_t = sel[cid]
            dct = hdc.get(dc_t)
            act = hac.get(ac_t)
            co = coefs[ci]
            for byy in range(c["nby"]):
                for bxx in range(c["nbx"]):
                    if rst and n_unit and n_unit % rst == 0:
                        _restart()
                    n_unit += 1
                    _decode_block(co[byy, bxx], state["bits"], dct, act,
                                  pred, cid, ss, se, ah, al, state)
        else:
            # interleaved MCU order
            for my in range(mcuy):
                for mx in range(mcux):
                    if rst and n_unit and n_unit % rst == 0:
                        _restart()
                    n_unit += 1
                    for cid in order:
                        ci = by_id[cid]
                        c = comps[ci]
                        dc_t, ac_t = sel[cid]
                        co = coefs[ci]
                        for byo in range(c["v"]):
                            for bxo in range(c["h"]):
                                _decode_block(
                                    co[my * c["v"] + byo,
                                       mx * c["h"] + bxo],
                                    state["bits"], hdc.get(dc_t),
                                    hac.get(ac_t), pred, cid,
                                    ss, se, ah, al, state)

    # dequantize + vectorized IDCT + assemble planes
    full = []
    for ci, c in enumerate(comps):
        deq = np.zeros((c["by"], c["bx"], 64), np.float32)
        deq[..., _ZIGZAG] = coefs[ci] * qt[c["tq"]]
        blocks = deq.reshape(c["by"], c["bx"], 8, 8)
        px = np.einsum("ij,yxjk,kl->yxil", _DCT_A.T, blocks,
                       _DCT_A) + 128.0
        plane = px.transpose(0, 2, 1, 3).reshape(c["by"] * 8, c["bx"] * 8)
        ry, rx = vmax // c["v"], hmax // c["h"]
        if ry > 1 or rx > 1:
            plane = np.repeat(np.repeat(plane, ry, axis=0), rx, axis=1)
        full.append(plane[:h, :w])

    if len(full) == 1:
        y = full[0]
        rgb = np.stack([y, y, y], axis=-1)
    else:
        y, cb, cr = full[0], full[1] - 128.0, full[2] - 128.0
        r = y + 1.402 * cr
        g = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# BMP / GIF / TIFF decoders — the rest of the reference's `image`-crate
# texture surface (texture.rs:84-107 reads any format the crate guesses;
# the crate ships PNG/JPEG/BMP/GIF/TIFF decoders). Pure numpy, subset
# chosen to cover what those formats' common writers emit: BMP 8/24/32-bit
# uncompressed, GIF87a/89a first frame (LZW, interlace, local palettes),
# TIFF 8-bit grey/palette/RGB(A) in strips with none/PackBits/LZW
# compression and horizontal-differencing predictor.
# ---------------------------------------------------------------------------


def decode_bmp(data: bytes) -> np.ndarray:
    """Decode an uncompressed 8/24/32-bit BMP to uint8 [H, W, 3]."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    (off,) = struct.unpack("<I", data[10:14])
    (hsz,) = struct.unpack("<I", data[14:18])
    if hsz == 12:                                # BITMAPCOREHEADER
        w, h = struct.unpack("<hh", data[18:22])
        (bpp,) = struct.unpack("<H", data[24:26])
        comp, clr_used, pal_off, pal_stride = 0, 0, 26, 3
    else:                                        # BITMAPINFOHEADER+
        w, h = struct.unpack("<ii", data[18:26])
        (bpp,) = struct.unpack("<H", data[28:30])
        (comp,) = struct.unpack("<I", data[30:34])
        (clr_used,) = struct.unpack("<I", data[46:50])
        pal_off, pal_stride = 14 + hsz, 4
    if comp not in (0, 3) or (comp == 3 and bpp != 32):
        raise ValueError(f"unsupported BMP compression {comp}")
    if comp == 3:
        # BI_BITFIELDS: masks live right after a 40-byte INFOHEADER, or
        # at the same absolute offset (54) inside a V4/V5 header. We only
        # handle the standard BGRA layout — raise otherwise so the caller
        # degrades to the solid-yellow fallback instead of silently
        # swapping channels.
        rm, gm, bm = struct.unpack("<III", data[54:66])
        if (rm, gm, bm) != (0x00FF0000, 0x0000FF00, 0x000000FF):
            raise ValueError(
                f"unsupported BMP bitfield masks {rm:#x}/{gm:#x}/{bm:#x}")
    top_down = h < 0
    h = abs(h)
    stride = (w * bpp // 8 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h, stride)
    if bpp == 24:
        img = rows[:, :w * 3].reshape(h, w, 3)[..., ::-1]    # BGR -> RGB
    elif bpp == 32:
        img = rows[:, :w * 4].reshape(h, w, 4)[..., 2::-1]   # BGRA -> RGB
    elif bpp == 8:
        npal = clr_used or 256
        pal = np.frombuffer(data, np.uint8, npal * pal_stride,
                            pal_off).reshape(npal, pal_stride)
        img = pal[rows[:, :w]][..., 2::-1]                   # BGR(A) -> RGB
    else:
        raise ValueError(f"unsupported BMP bpp {bpp}")
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _lzw_gif(data: bytes, min_code: int) -> list:
    """GIF LZW (LSB-first packing, variable 3..12-bit codes)."""
    clear = 1 << min_code
    end = clear + 1
    total_bits = len(data) * 8
    bitpos = 0
    width = min_code + 1
    table = [(i,) for i in range(clear)] + [(), ()]
    out = []
    prev = None

    def read_code():
        nonlocal bitpos
        v = 0
        for k in range(width):
            if bitpos >= total_bits:
                return end
            v |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << k
            bitpos += 1
        return v

    while True:
        code = read_code()
        if code == clear:
            del table[clear + 2:]
            width = min_code + 1
            prev = None
            continue
        if code == end:
            break
        if code < len(table) and code not in (clear, end):
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + (prev[0],)
        else:
            raise ValueError("bad LZW code")
        out.extend(entry)
        if prev is not None and len(table) < 4096:
            table.append(prev + (entry[0],))
            if len(table) == (1 << width) and width < 12:
                width += 1
        prev = entry
    return out


def decode_gif(data: bytes) -> np.ndarray:
    """Decode the first frame of a GIF87a/89a to uint8 [H, W, 3]."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    w, h = struct.unpack("<HH", data[6:10])
    flags = data[10]
    pos = 13
    gpal = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gpal = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3
    while pos < len(data):
        b = data[pos]
        if b == 0x3B:                            # trailer
            break
        if b == 0x21:                            # extension: skip sub-blocks
            pos += 2
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
            continue
        if b != 0x2C:
            raise ValueError(f"bad GIF block 0x{b:02x}")
        left, top, iw, ih = struct.unpack("<HHHH", data[pos + 1:pos + 9])
        iflags = data[pos + 9]
        pos += 10
        pal = gpal
        if iflags & 0x80:                        # local color table
            n = 2 << (iflags & 7)
            pal = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
            pos += n * 3
        min_code = data[pos]
        pos += 1
        chunks = []
        while data[pos]:
            sz = data[pos]
            chunks.append(data[pos + 1:pos + 1 + sz])
            pos += 1 + sz
        pos += 1
        idx = np.asarray(_lzw_gif(b"".join(chunks), min_code)[:iw * ih],
                         np.int32).reshape(ih, iw)
        if iflags & 0x40:                        # interlaced row order
            order = (list(range(0, ih, 8)) + list(range(4, ih, 8))
                     + list(range(2, ih, 4)) + list(range(1, ih, 2)))
            deint = np.zeros_like(idx)
            deint[order] = idx
            idx = deint
        if pal is None:
            raise ValueError("GIF frame has no palette")
        canvas = np.zeros((h, w, 3), np.uint8)
        canvas[top:top + ih, left:left + iw] = pal[idx]
        return canvas                            # first frame only
    raise ValueError("no image data in GIF")


def _packbits(d: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(d):
        n = d[i]
        i += 1
        if n < 128:
            out += d[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += bytes([d[i]]) * (257 - n)
            i += 1
    return bytes(out)


def _lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW: MSB-first packing, 9..12-bit codes, EarlyChange=1
    (code width bumps one code EARLIER than GIF — TIFF6 spec p.61)."""
    clear, end = 256, 257
    total_bits = len(data) * 8
    bitpos = 0
    width = 9
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    prev = None

    def read_code():
        nonlocal bitpos
        v = 0
        for _ in range(width):
            if bitpos >= total_bits:
                return end
            v = (v << 1) | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1)
            bitpos += 1
        return v

    while True:
        code = read_code()
        if code == clear:
            del table[258:]
            width = 9
            prev = None
            continue
        if code == end:
            break
        if code < len(table) and code not in (clear, end):
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
        else:
            raise ValueError("bad TIFF LZW code")
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        if len(table) == (1 << width) - 1 and width < 12:  # EarlyChange
            width += 1
        prev = entry
    return bytes(out)


def decode_tiff(data: bytes) -> np.ndarray:
    """Decode an 8-bit grey/palette/RGB(A) strip TIFF (compression
    none/PackBits/LZW, predictor 1/2, either byte order) to [H, W, 3]."""
    if data[:4] == b"II*\x00":
        en = "<"
    elif data[:4] == b"MM\x00*":
        en = ">"
    else:
        raise ValueError("not a TIFF")
    (ifd,) = struct.unpack(en + "I", data[4:8])
    (n,) = struct.unpack(en + "H", data[ifd:ifd + 2])
    tags = {}
    for k in range(n):
        e = ifd + 2 + 12 * k
        tag, typ, cnt = struct.unpack(en + "HHI", data[e:e + 8])
        size = {1: 1, 2: 1, 3: 2, 4: 4}.get(typ, 0) * cnt
        voff = e + 8 if 0 < size <= 4 else struct.unpack(
            en + "I", data[e + 8:e + 12])[0]
        if typ == 1:
            vals = tuple(data[voff:voff + cnt])
        elif typ == 3:
            vals = struct.unpack(en + f"{cnt}H", data[voff:voff + 2 * cnt])
        elif typ == 4:
            vals = struct.unpack(en + f"{cnt}I", data[voff:voff + 4 * cnt])
        else:
            continue
        tags[tag] = vals
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (8,) * spp)
    comp = tags.get(259, (1,))[0]
    photo = tags.get(262, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    planar = tags.get(284, (1,))[0]
    if any(b != 8 for b in bps) or planar != 1:
        raise ValueError("only 8-bit chunky TIFF supported")
    raw = bytearray()
    for o, cnt_ in zip(tags[273], tags[279]):
        chunk = bytes(data[o:o + cnt_])
        if comp == 1:
            raw += chunk
        elif comp == 32773:
            raw += _packbits(chunk)
        elif comp == 5:
            raw += _lzw_tiff(chunk)
        else:
            raise ValueError(f"unsupported TIFF compression {comp}")
    img = np.frombuffer(bytes(raw), np.uint8,
                        h * w * spp).reshape(h, w, spp).astype(np.int32)
    if predictor == 2:                           # horizontal differencing
        img = np.cumsum(img, axis=1) & 0xFF
    img = img.astype(np.uint8)
    if photo == 3:                               # palette (RGB 16-bit/chan)
        cmap = np.asarray(tags[320], np.int32)
        npal = cmap.size // 3
        pal = (cmap.reshape(3, npal).T // 257).astype(np.uint8)
        return np.ascontiguousarray(pal[img[..., 0]])
    if spp == 1:
        g = 255 - img[..., 0] if photo == 0 else img[..., 0]
        return np.stack([g, g, g], axis=-1)
    return np.ascontiguousarray(img[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Sniff + decode any supported texture format to uint8 [H, W, 3] —
    the PIL-free equivalent of the `image` crate's format guessing that
    the reference relies on (texture.rs:84-107)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return decode_tiff(data)
    raise ValueError("unrecognized image format")
