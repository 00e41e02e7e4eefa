"""GWF (IGWD binary frame, LIGO-T970130 v8) reader + minimal writer.

A copy of ``nmma_tpu/gw/gwf.py`` for the port (numpy and the standard
library only), so that files written by either package read in the other.

The reference reads detector frame files through bilby_pipe -> gwpy ->
frameCPP (``nmma/gw/gw_inputs.py:4``). This is a pure-Python stdlib
implementation of the frame format for the common offline case: pulling
a strain channel (FrProcData / FrAdcData / FrSimData) out of a ``.gwf``
file into a :class:`nmma_tpu_torch.gw.strain.StrainSeries`.

The format is self-describing: every file carries FrSH ("struct header")
and FrSE ("struct element") dictionary records that name each structure
class and list its elements with their types (``"INT_8U[nDim]"``,
``"PTR_STRUCT(FrVect *)"``, ...). The reader is dictionary-driven — it
learns the layout of FrameH / FrProcData / FrVect from the file itself
and only hardcodes the primitive wire types, so it tolerates the
inter-version field additions (v6 vs v8) that break fixed-layout
parsers. FrVect compression modes 0 (raw), 1 (gzip) and 3
(differentiate + gzip) are supported; zero-suppress modes raise with a
pointer to re-export.

The writer emits spec-compliant version-8 files (header block, FrSH/FrSE
dictionaries, FrameH + FrProcData + FrVect instances, FrEndOfFile) and
exists both for round-trip tests and to export strain for frameCPP-based
consumers. The implementation is validated against the published spec
and by round trips, not against frameCPP-produced files.
"""

from __future__ import annotations

import gzip
import struct as _struct
import zlib
from pathlib import Path

import numpy as np

from .strain import StrainSeries

_MAGIC = b"IGWD\x00"

# FrVect type codes (spec table 10) -> numpy dtypes (little-endian base)
_VECT_DTYPES = {
    0: "i1",    # FR_VECT_C
    1: "i2",    # FR_VECT_2S
    2: "f8",    # FR_VECT_8R
    3: "f4",    # FR_VECT_4R
    4: "i4",    # FR_VECT_4S
    5: "i8",    # FR_VECT_8S
    6: "c8",    # FR_VECT_8C
    7: "c16",   # FR_VECT_16C
    9: "u2",    # FR_VECT_2U
    10: "u4",   # FR_VECT_4U
    11: "u8",   # FR_VECT_8U
    12: "u1",   # FR_VECT_1U
}
_DTYPE_VECT = {"f8": 2, "f4": 3, "i4": 4, "i8": 5, "i2": 1,
               "u2": 9, "u4": 10, "u8": 11, "c8": 6, "c16": 7}

_PRIM_FMT = {
    "CHAR": ("b", 1), "CHAR_U": ("B", 1),
    "INT_2S": ("h", 2), "INT_2U": ("H", 2),
    "INT_4S": ("i", 4), "INT_4U": ("I", 4),
    "INT_8S": ("q", 8), "INT_8U": ("Q", 8),
    "REAL_4": ("f", 4), "REAL_8": ("d", 8),
}


class _Cursor:
    def __init__(self, buf, offset, end, endian):
        self.buf = buf
        self.pos = offset
        self.end = end
        self.endian = endian

    def prim(self, code):
        fmt, size = _PRIM_FMT[code]
        if self.pos + size > self.end:
            raise EOFError("structure truncated")
        (val,) = _struct.unpack_from(self.endian + fmt, self.buf, self.pos)
        self.pos += size
        return val

    def string(self):
        n = self.prim("INT_2U")
        raw = self.buf[self.pos:self.pos + n]
        self.pos += n
        return raw.split(b"\x00", 1)[0].decode("latin-1")

    def raw(self, n):
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def _parse_header(buf):
    if buf[:5] != _MAGIC:
        raise ValueError("not an IGWD frame file (bad magic)")
    major = buf[5]
    # endianness probe: INT_2 written as 0x1234 at offset 12
    (probe,) = _struct.unpack_from("<H", buf, 12)
    endian = "<" if probe == 0x1234 else ">"
    return major, endian


def _struct_header(buf, pos, endian, version):
    """(total_length, class, instance, body_offset)."""
    (length,) = _struct.unpack_from(endian + "Q", buf, pos)
    (cls,) = _struct.unpack_from(endian + "H", buf, pos + 8)
    if version >= 8:
        (inst,) = _struct.unpack_from(endian + "I", buf, pos + 10)
        body = pos + 14
    else:
        (inst,) = _struct.unpack_from(endian + "H", buf, pos + 10)
        body = pos + 12
    return length, cls, inst, body


def _parse_elements(cur, elements, version=8):
    """Decode one structure instance by walking its FrSE element list."""
    # pointer instance width is version-dependent: v8 stores
    # INT_2U class + INT_4U instance, v6 INT_2U + INT_2U (frame spec
    # LIGO-T970130 §4.3.2) — decoding v6 pointers as 6 bytes desyncs
    # every later field in the structure
    inst_t = "INT_4U" if version >= 8 else "INT_2U"
    out = {}
    for name, type_str in elements:
        base, _, dim = type_str.partition("[")
        base = base.strip()
        count = None
        if dim:
            dim = dim.rstrip("]").strip()
            count = int(dim) if dim.isdigit() else int(out.get(dim, 0))
        if base.startswith("PTR_STRUCT"):
            vals = [(cur.prim("INT_2U"), cur.prim(inst_t))
                    for _ in range(count if count is not None else 1)]
        elif base == "STRING":
            vals = [cur.string()
                    for _ in range(count if count is not None else 1)]
        elif base in _PRIM_FMT:
            if count is not None and base in ("CHAR", "CHAR_U"):
                vals = [cur.raw(count)]
            else:
                vals = [cur.prim(base)
                        for _ in range(count if count is not None else 1)]
        else:
            # unknown element type: cannot continue within this struct
            break
        out[name] = vals[0] if count is None else vals
    return out


def _decompress_vect(v, endian):
    """FrVect dict -> numpy array (handles compress 0/1/3, +256 swap)."""
    compress = int(v.get("compress", 0))
    vtype = int(v.get("type", 2))
    n_data = int(v.get("nData", 0))
    payload = v.get("data", b"")
    if isinstance(payload, list):
        payload = payload[0]
    # the +256 flag marks vect data written on the OPPOSITE-endian
    # machine relative to the file's own byte order (frame libraries
    # byte-swap such vects on read); without the flag the data follow
    # the file header's endianness. The base code is mod 256.
    code = compress & 0xFF
    if compress & 256:
        byte_order = "<" if endian == ">" else ">"
    else:
        byte_order = endian
    dtype = np.dtype(byte_order + _VECT_DTYPES.get(vtype, "f8"))
    if code == 0:
        arr = np.frombuffer(payload, dtype=dtype, count=n_data)
    elif code in (1, 3):
        try:
            rawbytes = zlib.decompress(payload)
        except zlib.error:
            rawbytes = gzip.decompress(payload)
        arr = np.frombuffer(rawbytes, dtype=dtype, count=n_data)
        if code == 3:
            # differentiate-then-gzip: integrate back in a type that
            # preserves the stored differences (int64 for integer vects;
            # float vects must accumulate as float — an int cast zeroes
            # sub-unity strain differences)
            acc = np.float64 if dtype.base.kind in "fc" else np.int64
            arr = np.cumsum(arr.astype(acc)).astype(dtype.base)
    else:
        raise NotImplementedError(
            f"FrVect compression mode {code} (zero-suppress family) is "
            "not supported offline; re-export the frame uncompressed or "
            "gzip-compressed")
    return np.asarray(arr)


def _scan(path):
    """Parse every structure in the file.

    Returns (version, endian, dictionaries, instances, frame_assoc):
    ``dictionaries``: class -> {"name": str, "elements": [(name, type)]},
    ``instances``: (class, instance) -> parsed dict,
    ``frame_assoc``: (class, instance) -> index of owning FrameH (stream
    order; frames are written header-first).
    """
    buf = Path(path).read_bytes()
    version, endian = _parse_header(buf)
    pos = 40
    dicts = {1: {"name": "FrSH",
                 "elements": [("name", "STRING"), ("class", "INT_2U"),
                              ("comment", "STRING")]},
             2: {"name": "FrSE",
                 "elements": [("name", "STRING"), ("class", "STRING"),
                              ("comment", "STRING")]}}
    instances = {}
    frame_assoc = {}
    frame_idx = -1
    pending_sh = None
    while pos + 12 <= len(buf):
        length, cls, inst, body = _struct_header(buf, pos, endian, version)
        if length < 12 or pos + length > len(buf):
            break
        cur = _Cursor(buf, body, pos + length, endian)
        if cls == 1:                                   # FrSH
            sh = _parse_elements(cur, dicts[1]["elements"], version)
            pending_sh = sh
            dicts.setdefault(int(sh.get("class", 0)),
                             {"name": sh.get("name", "?"), "elements": []})
            dicts[int(sh.get("class", 0))]["name"] = sh.get("name", "?")
        elif cls == 2 and pending_sh is not None:      # FrSE
            se = _parse_elements(cur, dicts[2]["elements"], version)
            target = int(pending_sh.get("class", 0))
            if se.get("name") not in ("chkSum",):
                dicts[target]["elements"].append(
                    (se.get("name", "?"), se.get("class", "INT_4U")))
        else:
            spec = dicts.get(cls)
            if spec is not None and spec["elements"]:
                try:
                    parsed = _parse_elements(cur, spec["elements"],
                                             version)
                except (EOFError, _struct.error):
                    parsed = {}
                instances[(cls, inst)] = parsed
                if spec["name"] == "FrameH":
                    frame_idx += 1
                frame_assoc[(cls, inst)] = frame_idx
        pos += length
    return version, endian, dicts, instances, frame_assoc


def gwf_channels(path):
    """List the channel names stored in a frame file."""
    _, _, dicts, instances, _ = _scan(path)
    names = []
    for (cls, _), inst in instances.items():
        sname = dicts.get(cls, {}).get("name", "")
        if sname in ("FrProcData", "FrAdcData", "FrSimData") and \
                inst.get("name"):
            names.append(inst["name"])
    return sorted(set(names))


def read_gwf(path, channel=None):
    """Read one channel from a ``.gwf`` file -> :class:`StrainSeries`.

    Follows the FrProcData/FrAdcData ``data`` pointer to its FrVect
    chain, decompresses, and stitches multi-frame files when contiguous.
    """
    version, endian, dicts, instances, frame_assoc = _scan(path)
    name_by_class = {c: d["name"] for c, d in dicts.items()}
    vect_class = next((c for c, n in name_by_class.items()
                       if n == "FrVect"), None)

    frames = sorted(
        ((frame_assoc[key], inst) for key, inst in instances.items()
         if name_by_class.get(key[0]) == "FrameH"),
        key=lambda t: t[0])
    frame_gps = {
        idx: (float(inst.get("GTimeS", 0))
              + 1e-9 * float(inst.get("GTimeN", 0)))
        for idx, inst in frames}

    candidates = []
    for key, inst in instances.items():
        sname = name_by_class.get(key[0])
        if sname not in ("FrProcData", "FrAdcData", "FrSimData"):
            continue
        if channel is not None and inst.get("name") != channel:
            continue
        candidates.append((key, inst))
    if not candidates:
        avail = gwf_channels(path)
        raise ValueError(
            f"channel {channel!r} not found in {path}; available: {avail}")
    if channel is None and len({i.get("name")
                                for _, i in candidates}) > 1:
        raise ValueError(
            f"multiple channels in {path}: {gwf_channels(path)}; "
            "pass channel=")

    segments = []
    for key, inst in candidates:
        ptr = inst.get("data", (0, 0))
        if isinstance(ptr, list):
            ptr = ptr[0]
        gps = frame_gps.get(frame_assoc.get(key, -1), 0.0)
        t_off = float(inst.get("timeOffset", 0.0))
        while ptr and ptr != (0, 0):
            v = instances.get((ptr[0], ptr[1]))
            if v is None and vect_class is not None:
                v = instances.get((vect_class, ptr[1]))
            if v is None:
                break
            arr = _decompress_vect(v, endian)
            dx = v.get("dx", [1.0])
            dx0 = float(dx[0] if isinstance(dx, list) else dx)
            sx = v.get("startX", [0.0])
            sx0 = float(sx[0] if isinstance(sx, list) else sx)
            segments.append((gps + t_off + sx0, dx0, arr))
            nxt = v.get("next", (0, 0))
            ptr = nxt[0] if isinstance(nxt, list) else nxt

    if not segments:
        raise ValueError(f"no FrVect data resolved for channel "
                         f"{channel!r} in {path}")
    segments.sort(key=lambda s: s[0])
    t0, dx0, first = segments[0]
    parts = [np.asarray(first)]
    t_next = t0 + len(first) * dx0
    for start, dx, arr in segments[1:]:
        if abs(dx - dx0) > 1e-12 * dx0 or abs(start - t_next) > 0.5 * dx0:
            raise ValueError(
                "non-contiguous or mixed-rate FrVect segments; read "
                "frames individually")
        parts.append(np.asarray(arr))
        t_next += len(arr) * dx
    data = np.concatenate(parts) if len(parts) > 1 else parts[0]
    return StrainSeries(data.astype(np.float64, copy=False), t0, 1.0 / dx0)


# ---------------------------------------------------------------------------
# Writer (spec v8): dictionaries + FrameH/FrProcData/FrVect/FrEndOfFile
# ---------------------------------------------------------------------------
_W_CLASSES = {"FrameH": 3, "FrProcData": 4, "FrVect": 5, "FrEndOfFile": 6}

_W_DEFS = {
    "FrameH": [
        ("name", "STRING"), ("run", "INT_4S"), ("frame", "INT_4U"),
        ("dataQuality", "INT_4U"), ("GTimeS", "INT_4U"),
        ("GTimeN", "INT_4U"), ("dt", "REAL_8"), ("ULeapS", "INT_4S"),
        ("type", "PTR_STRUCT(FrSH *)"), ("user", "PTR_STRUCT(FrVect *)"),
        ("detectSim", "PTR_STRUCT(FrDetector *)"),
        ("detectProc", "PTR_STRUCT(FrDetector *)"),
        ("history", "PTR_STRUCT(FrHistory *)"),
        ("rawData", "PTR_STRUCT(FrRawData *)"),
        ("procData", "PTR_STRUCT(FrProcData *)"),
        ("simData", "PTR_STRUCT(FrSimData *)"),
        ("event", "PTR_STRUCT(FrEvent *)"),
        ("simEvent", "PTR_STRUCT(FrSimEvent *)"),
        ("summaryData", "PTR_STRUCT(FrSummary *)"),
        ("auxData", "PTR_STRUCT(FrVect *)"),
        ("auxTable", "PTR_STRUCT(FrTable *)"),
    ],
    "FrProcData": [
        ("name", "STRING"), ("comment", "STRING"), ("type", "INT_2U"),
        ("subType", "INT_2U"), ("timeOffset", "REAL_8"),
        ("tRange", "REAL_8"), ("fShift", "REAL_8"), ("phase", "REAL_4"),
        ("fRange", "REAL_8"), ("BW", "REAL_8"), ("nAuxParam", "INT_2U"),
        ("auxParam", "REAL_8[nAuxParam]"),
        ("auxParamNames", "STRING[nAuxParam]"),
        ("data", "PTR_STRUCT(FrVect *)"),
        ("aux", "PTR_STRUCT(FrVect *)"),
        ("table", "PTR_STRUCT(FrTable *)"),
        ("history", "PTR_STRUCT(FrHistory *)"),
        ("next", "PTR_STRUCT(FrProcData *)"),
    ],
    "FrVect": [
        ("name", "STRING"), ("compress", "INT_2U"), ("type", "INT_2U"),
        ("nData", "INT_8U"), ("nBytes", "INT_8U"),
        ("data", "CHAR[nBytes]"), ("nDim", "INT_4U"),
        ("nx", "INT_8U[nDim]"), ("dx", "REAL_8[nDim]"),
        ("startX", "REAL_8[nDim]"), ("unitX", "STRING[nDim]"),
        ("unitY", "STRING"), ("next", "PTR_STRUCT(FrVect *)"),
    ],
    "FrEndOfFile": [
        ("nFrames", "INT_4U"), ("nBytes", "INT_8U"),
        ("seekTOC", "INT_8U"), ("chkSumFrHeader", "INT_4U"),
        ("chkSum", "INT_4U"), ("chkSumFile", "INT_4U"),
    ],
}


class _Writer:
    def __init__(self):
        self.parts = []
        self.counters = {}

    def _string(self, s):
        raw = s.encode("latin-1") + b"\x00"
        return _struct.pack("<H", len(raw)) + raw

    def _element(self, type_str, value, fields):
        base, _, dim = type_str.partition("[")
        base = base.strip()
        if dim:
            dim = dim.rstrip("]").strip()
            n = int(dim) if dim.isdigit() else int(fields.get(dim, 0))
            if base in ("CHAR", "CHAR_U"):
                payload = value if isinstance(value, bytes) else bytes(n)
                return payload[:n].ljust(n, b"\x00")
            items = list(value or [])[:n]
            items += [0 if base != "STRING" else ""] * (n - len(items))
            return b"".join(self._element(base, it, fields)
                            for it in items)
        if base.startswith("PTR_STRUCT"):
            cls, inst = value if value else (0, 0)
            return _struct.pack("<HI", cls, inst)
        if base == "STRING":
            return self._string(value or "")
        fmt, _ = _PRIM_FMT[base]
        return _struct.pack("<" + fmt, value if value is not None
                            else (0.0 if fmt in "fd" else 0))

    def struct(self, cls, body):
        inst = self.counters.get(cls, 0)
        self.counters[cls] = inst + 1
        # trailing per-structure checksum (v8); zero = not computed
        body = body + _struct.pack("<I", 0)
        header = _struct.pack("<QHI", 14 + len(body), cls, inst)
        self.parts.append(header + body)
        return inst

    def fr_sh(self, name, cls):
        return self.struct(1, self._string(name)
                           + _struct.pack("<H", cls)
                           + self._string("-"))

    def fr_se(self, name, type_str):
        return self.struct(2, self._string(name) + self._string(type_str)
                           + self._string("-"))

    def instance(self, struct_name, fields):
        cls = _W_CLASSES[struct_name]
        body = b"".join(
            self._element(t, fields.get(n), fields)
            for n, t in _W_DEFS[struct_name])
        return self.struct(cls, body)


def write_gwf(path, channels, name="nmma_tpu_torch", run=0, compress="gzip"):
    """Write ``{channel: StrainSeries}`` as a version-8 GWF file.

    All series must share a time span; one frame is written covering it.
    ``compress`` is ``"raw"`` or ``"gzip"`` (FrVect modes 0 / 1).
    """
    series = dict(channels)
    if not series:
        raise ValueError("no channels to write")
    spans = {(s.t0, s.duration) for s in series.values()}
    if len(spans) != 1:
        raise ValueError("all channels must share t0 and duration")
    t0, duration = spans.pop()
    gps_s = int(t0)
    gps_n = int(round((t0 - gps_s) * 1e9))

    w = _Writer()
    # reserve the dictionary instances (classes 1 and 2 exist implicitly)
    for sname, cls in _W_CLASSES.items():
        w.fr_sh(sname, cls)
        for ename, etype in _W_DEFS[sname]:
            w.fr_se(ename, etype)
        w.fr_se("chkSum", "INT_4U")

    frame_body_index = len(w.parts)
    vect_ptrs = []
    proc_ptrs = []
    for ch_name, s in series.items():
        data = np.ascontiguousarray(np.asarray(s.data))
        code = _DTYPE_VECT.get(
            {"float64": "f8", "float32": "f4", "int32": "i4",
             "int64": "i8", "int16": "i2"}.get(data.dtype.name))
        if code is None:
            data = data.astype(np.float64)
            code = 2
        payload = data.astype(data.dtype.newbyteorder("<")).tobytes()
        mode = 0
        if compress == "gzip":
            comp = zlib.compress(payload, 6)
            if len(comp) < len(payload):
                payload, mode = comp, 1
        vect_inst = w.instance("FrVect", {
            "name": ch_name, "compress": mode, "type": code,
            "nData": len(data), "nBytes": len(payload), "data": payload,
            "nDim": 1, "nx": [len(data)],
            "dx": [1.0 / s.sample_rate], "startX": [0.0],
            "unitX": ["s"], "unitY": "strain", "next": (0, 0)})
        vect_ptrs.append((_W_CLASSES["FrVect"], vect_inst))
    # FrProcData instance numbers are sequential from the writer's
    # per-class counter, so the linked list can be chained predictively:
    # spec-compliant readers (frameCPP/gwpy) walk FrameH.procData ->
    # next to find EVERY channel — without the chain only the first
    # channel of a multi-channel file is reachable
    proc_cls = _W_CLASSES["FrProcData"]
    first_proc = w.counters.get(proc_cls, 0)
    n_proc = len(series)
    for i, (ch_name, s) in enumerate(series.items()):
        nxt = (proc_cls, first_proc + i + 1) if i < n_proc - 1 else (0, 0)
        proc_inst = w.instance("FrProcData", {
            "name": ch_name, "comment": "written by nmma_tpu_torch",
            "type": 1, "subType": 0, "timeOffset": 0.0,
            "tRange": duration, "fShift": 0.0, "phase": 0.0,
            "fRange": 0.0, "BW": 0.0, "nAuxParam": 0,
            "auxParam": [], "auxParamNames": [],
            "data": vect_ptrs[i], "aux": (0, 0), "table": (0, 0),
            "history": (0, 0),
            "next": nxt})
        proc_ptrs.append((proc_cls, proc_inst))
    # real readers walk FrameH.procData -> FrProcData.next (chained
    # above); our reader additionally scans all instances:
    frame_fields = {
        "name": name, "run": run, "frame": 0, "dataQuality": 0,
        "GTimeS": gps_s, "GTimeN": gps_n, "dt": duration, "ULeapS": 18,
        "procData": proc_ptrs[0] if proc_ptrs else (0, 0)}
    frame_inst_part = len(w.parts)
    w.instance("FrameH", frame_fields)
    # move the FrameH record before its procData/vect records (frames are
    # written header-first; the reader associates structures to the most
    # recent FrameH)
    frame_part = w.parts.pop(frame_inst_part)
    w.parts.insert(frame_body_index, frame_part)

    # EOF record: body = 6 fields (32 B) + chkSum (4 B), header = 14 B
    eof_len = 14 + 32 + 4
    n_bytes = 40 + sum(len(p) for p in w.parts) + eof_len
    w.instance("FrEndOfFile", {
        "nFrames": 1, "nBytes": n_bytes, "seekTOC": 0,
        "chkSumFrHeader": 0, "chkSum": 0, "chkSumFile": 0})

    header = (
        _MAGIC
        + bytes([8, 1, 2, 4, 8, 4, 8])
        + _struct.pack("<H", 0x1234)
        + _struct.pack("<I", 0x12345678)
        + _struct.pack("<Q", 0x123456789ABCDEF)
        + _struct.pack("<f", np.float32(np.pi))
        + _struct.pack("<d", np.pi)
        + b"AZ")
    assert len(header) == 40
    Path(path).write_bytes(header + b"".join(w.parts))
    return str(path)
