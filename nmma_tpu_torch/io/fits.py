"""Minimal numpy FITS binary-table I/O and HEALPix pixel indexing.

Port of ``nmma_tpu/io/fits.py`` (a numpy copy; the port keeps its own). It
replaces the reference's astropy/healpy/ligo.skymap dependencies for the sky
map uses nmma has: reading a (multi-order) GW sky map's BINTABLE columns and
locating the pixel that holds a sky position
(``inclination_prior_from_fits``, nmma/em/prior.py:80-171, and
``get_skymap_idx``, nmma/em/utils.py:814-837), and reading an m4opt
limiting-magnitude map. Only the FITS features those files use are
implemented: 2880-byte header blocks, BINTABLE extensions, big-endian
scalar and vector numeric columns. Everything here runs on the host.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880

_TFORM_DTYPES = {
    "L": ("u1", 1), "B": ("u1", 1), "I": (">i2", 2), "J": (">i4", 4),
    "K": (">i8", 8), "E": (">f4", 4), "D": (">f8", 8),
}


def _read_header(fh):
    """Read one FITS header: -> dict of cards (strings unquoted)."""
    cards = {}
    while True:
        block = fh.read(_BLOCK)
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" not in card[8:10]:
                continue
            s = card[10:].strip()
            if s.startswith("'"):
                # unquote BEFORE stripping the '/' comment: a legal
                # quoted value may contain a slash ('1 / sr'); doubled
                # quotes escape a literal quote
                buf, j = [], 1
                while j < len(s):
                    if s[j] == "'":
                        if j + 1 < len(s) and s[j + 1] == "'":
                            buf.append("'")
                            j += 2
                            continue
                        break
                    buf.append(s[j])
                    j += 1
                val = "".join(buf).strip()
            else:
                val = s.split("/")[0].strip()
                if val == "T":
                    val = True
                elif val == "F":
                    val = False
                else:
                    try:
                        val = int(val)
                    except ValueError:
                        try:
                            val = float(val)
                        except ValueError:
                            pass
            cards[key] = val
        if done:
            break
    return cards


def _skip_data(fh, header):
    bitpix = abs(int(header.get("BITPIX", 8)))
    naxes = int(header.get("NAXIS", 0))
    n = 1 if naxes else 0
    for i in range(1, naxes + 1):
        n *= int(header[f"NAXIS{i}"])
    nbytes = n * bitpix // 8
    nbytes += int(header.get("PCOUNT", 0))
    fh.seek((nbytes + _BLOCK - 1) // _BLOCK * _BLOCK, 1)


def read_bintable(path, hdu=1):
    """Read BINTABLE extension ``hdu``: -> (dict col->array, header).

    Vector columns ('10D') come back as [n_rows, 10] arrays. Matches the
    subset of astropy.table semantics the skymap reader needs.
    """
    with open(path, "rb") as fh:
        header = _read_header(fh)          # primary HDU
        _skip_data(fh, header)
        for _ in range(hdu - 1):
            header = _read_header(fh)
            _skip_data(fh, header)
        header = _read_header(fh)
        if header.get("XTENSION", "").strip() != "BINTABLE":
            raise ValueError(f"HDU {hdu} is not a BINTABLE")

        n_rows = int(header["NAXIS2"])
        row_bytes = int(header["NAXIS1"])
        n_fields = int(header["TFIELDS"])
        names, dtypes, repeats, codes = [], [], [], []
        for i in range(1, n_fields + 1):
            tform = str(header[f"TFORM{i}"]).strip()
            j = 0
            while j < len(tform) and tform[j].isdigit():
                j += 1
            repeat = int(tform[:j]) if j else 1
            code = tform[j]
            if code not in _TFORM_DTYPES:
                raise ValueError(f"unsupported TFORM {tform!r}")
            dt, _ = _TFORM_DTYPES[code]
            names.append(str(header.get(f"TTYPE{i}", f"col{i}")).strip())
            dtypes.append(dt)
            repeats.append(repeat)
            codes.append(code)

        rec_dtype = np.dtype({
            "names": names,
            "formats": [(dt, (r,)) if r > 1 else dt
                        for dt, r in zip(dtypes, repeats)]})
        if rec_dtype.itemsize != row_bytes:
            raise ValueError(
                f"row size mismatch: dtype {rec_dtype.itemsize} vs "
                f"NAXIS1 {row_bytes}")
        raw = fh.read(n_rows * row_bytes)
        rec = np.frombuffer(raw, dtype=rec_dtype, count=n_rows)
        cols = {}
        for n, tform_code in zip(names, codes):
            arr = np.ascontiguousarray(
                rec[n].astype(rec[n].dtype.newbyteorder("=")))
            if tform_code == "L":
                # FITS logical stores ASCII 'T'(84)/'F'(70): both bytes
                # are truthy as raw u1 — decode to real booleans
                arr = arr == ord("T")
            cols[n] = arr
        return cols, header


def _pad_block(b: bytes) -> bytes:
    pad = (-len(b)) % _BLOCK
    return b + b" " * pad


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20.13E}"
    else:
        body = f"{key:<8}= '{value}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80).encode("ascii")


def write_bintable(path, columns: dict, extra_header: dict | None = None):
    """Write {name: array} as a single-extension BINTABLE FITS file.

    Scalar columns from 1-D arrays; vector columns from 2-D [rows, k].
    Enough of the format for round-trip tests and for emitting skymap-like
    products (the reference writes these via astropy).
    """
    names = list(columns.keys())
    arrays = [np.asarray(columns[n]) for n in names]
    n_rows = len(arrays[0])

    code_for = {"i8": "K", "i4": "J", "i2": "I", "f8": "D", "f4": "E",
                "u1": "B"}
    tforms, enc = [], []
    for a in arrays:
        kind = a.dtype.str.lstrip("<>=|")
        if kind not in code_for:
            a = a.astype(np.float64)
            kind = "f8"
        repeat = a.shape[1] if a.ndim == 2 else 1
        tforms.append(f"{repeat}{code_for[kind]}")
        enc.append(a.astype(a.dtype.newbyteorder(">")))

    rec_dtype = np.dtype({
        "names": names,
        "formats": [(e.dtype.str, (e.shape[1],)) if e.ndim == 2
                    else e.dtype.str for e in enc]})
    rec = np.zeros(n_rows, dtype=rec_dtype)
    for n, e in zip(names, enc):
        rec[n] = e

    prim = b"".join([
        _card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True), b"END".ljust(80)])
    cards = [
        _card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
        _card("NAXIS", 2), _card("NAXIS1", rec_dtype.itemsize),
        _card("NAXIS2", n_rows), _card("PCOUNT", 0), _card("GCOUNT", 1),
        _card("TFIELDS", len(names))]
    for i, (n, tf) in enumerate(zip(names, tforms), start=1):
        cards += [_card(f"TTYPE{i}", n), _card(f"TFORM{i}", tf)]
    for k, v in (extra_header or {}).items():
        cards.append(_card(k, v))
    cards.append(b"END".ljust(80))
    ext = b"".join(cards)

    with open(path, "wb") as fh:
        fh.write(_pad_block(prim))
        fh.write(_pad_block(ext))
        data = rec.tobytes()
        fh.write(data + b"\x00" * ((-len(data)) % _BLOCK))


# -- HEALPix nested indexing (healpy-free) ----------------------------------

def nside2order(nside: int) -> int:
    order = int(round(np.log2(nside)))
    if 2 ** order != nside:
        raise ValueError(f"nside {nside} is not a power of 2")
    return order


def uniq2nest(uniq):
    """NUNIQ -> (order, nested index); ligo.skymap.moc.uniq2nest."""
    uniq = np.asarray(uniq, dtype=np.int64)
    # uniq = 4^(order+1) + nest with nest < 12*4^order, so the top set
    # bit is at position 2*order+2 or 2*order+3
    bitlen = np.frompyfunc(lambda v: int(v).bit_length(), 1, 1)(uniq)
    order = (bitlen.astype(np.int64) - 3) // 2
    nest = uniq - (np.int64(1) << (2 * (order + 1)))
    return order, nest


def _interleave(x, y):
    """Spread x into even bits, y into odd bits (z-order curve)."""
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)

    def spread(v):
        v &= np.uint64(0xFFFFFFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
        return v

    return (spread(x) | (spread(y) << np.uint64(1))).astype(np.int64)


def ang2pix_nest(nside, theta, phi):
    """HEALPix NESTED pixel for colatitude theta / longitude phi [rad].

    Standard HEALPix geometry (Gorski et al. 2005, the ang2pix_nest
    algorithm); matches healpy.ang2pix(nside, theta, phi, nest=True).
    """
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2 * np.pi) / (0.5 * np.pi)     # in [0, 4)

    # equatorial belt
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    order = nside2order(nside)
    ifp = jp >> order
    ifm = jm >> order
    face_eq = np.where(ifp == ifm, (ifp & 3) + 4,
                       np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
    ix_eq = jm & (nside - 1)
    iy_eq = nside - (jp & (nside - 1)) - 1

    # polar caps
    ntt = np.minimum(tt.astype(np.int64), 3)
    tp = tt - ntt
    tmp = nside * np.sqrt(3.0 * (1.0 - za))
    jp_p = np.minimum(np.floor(tp * tmp).astype(np.int64), nside - 1)
    jm_p = np.minimum(np.floor((1.0 - tp) * tmp).astype(np.int64),
                      nside - 1)
    north = z >= 0
    face_po = np.where(north, ntt, ntt + 8)
    ix_po = np.where(north, nside - jm_p - 1, jp_p)
    iy_po = np.where(north, nside - jp_p - 1, jm_p)

    eq = za <= 2.0 / 3.0
    face = np.where(eq, face_eq, face_po)
    ix = np.where(eq, ix_eq, ix_po)
    iy = np.where(eq, iy_eq, iy_po)
    return face * nside * nside + _interleave(ix, iy)


def ang2pix_ring(nside, theta, phi):
    """HEALPix RING pixel for colatitude theta / longitude phi [rad].

    Standard HEALPix geometry (Gorski et al. 2005, the ang2pix_ring
    algorithm); matches healpy.ang2pix(nside, theta, phi, nest=False).
    """
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)          # [0, 4)

    # equatorial belt |z| <= 2/3
    temp1 = nside * (0.5 + tt)
    temp2 = nside * z * 0.75
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ip = np.mod((jp + jm - nside + kshift + 1) // 2, 4 * nside)
    pix_eq = 2 * nside * (nside - 1) + (ir - 1) * 4 * nside + ip

    # polar caps
    tp = tt - np.floor(tt)
    tmp = nside * np.sqrt(np.maximum(3.0 * (1.0 - za), 0.0))
    jp_p = np.floor(tp * tmp).astype(np.int64)
    jm_p = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir_p = jp_p + jm_p + 1
    ip_p = np.mod(np.floor(tt * ir_p).astype(np.int64), 4 * ir_p)
    pix_north = 2 * ir_p * (ir_p - 1) + ip_p
    pix_south = 12 * nside * nside - 2 * ir_p * (ir_p + 1) + ip_p

    return np.where(za <= 2.0 / 3.0, pix_eq,
                    np.where(z > 0, pix_north, pix_south))


def skymap_pixel_index(ra_deg, dec_deg, nside, ordering="NESTED"):
    """Pixel index for (RA, Dec) in degrees (utils.py:814-837).

    ``ordering`` follows the FITS header keyword: NESTED (default) or
    RING — indexing a RING map with a nested index reads a different
    sky location entirely.
    """
    theta = np.radians(90.0 - np.asarray(dec_deg, dtype=np.float64))
    phi = np.radians(np.asarray(ra_deg, dtype=np.float64))
    order = str(ordering).strip().upper()
    if order.startswith("RING"):
        return ang2pix_ring(nside, theta, phi)
    if order.startswith("NEST"):
        return ang2pix_nest(nside, theta, phi)
    raise ValueError(f"unknown HEALPix ORDERING {ordering!r}")


def detection_limit_from_m4opt_fits(path, ra_deg, dec_deg):
    """Limiting magnitude at (ra, dec) from an m4opt LIMMAG HEALPix map.

    Counterpart of ``detection_limit_from_m4opt_fits_file``
    (nmma/em/utils.py:199-210): read the binary-table LIMMAG column,
    index the (implicit-ordering) HEALPix map at the sky position.
    """
    columns, header = read_bintable(path)
    key = next((k for k in columns if k.upper() == "LIMMAG"), None)
    if key is None:
        raise ValueError(f"no LIMMAG column in {path!r} "
                         f"(columns: {sorted(columns)})")
    limmag = np.asarray(columns[key], dtype=np.float64).ravel()
    nside = int(header.get("NSIDE", 0))
    if nside <= 0:
        raise ValueError(f"missing NSIDE in {path!r}")
    idx = skymap_pixel_index(ra_deg, dec_deg, nside,
                             ordering=header.get("ORDERING", "NESTED"))
    return float(limmag[idx])
