"""
Point-cloud ingest (port of ``nimrud_tpu/archive/io.py``).

Loads .npy / .npz / delimited ASCII (xyz, csv, txt, pts, asc) / PLY /
LAS clouds.  ASCII parses through the port's C++ host runtime
(``ops.native.parse_ascii``: commas, semicolons or whitespace, ``#``
comments), which raises on a file without data or with a field that is
not a number -- the reference falls back to ``np.loadtxt`` where its
native loader is missing.  Dataset-style loaders (cloud file + sidecar
label file, the Semantic3D / Oakland convention the reference's
dainty_loader served) live in :func:`load_labeled`.
"""

import os

import numpy as np

from nimrud_tpu_torch.ops import native

ASCII_SUFFIXES = (".txt", ".csv", ".xyz", ".pts", ".asc")

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path):
    """
    PLY vertex loader (ascii / binary little- and big-endian): returns a
    float32 (N, n_props) array of the vertex element's scalar properties
    in file order (x, y, z first by convention).  List properties (face
    indices) are skipped -- this is a point-cloud reader.
    """
    with open(path, "rb") as handle:
        if handle.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertices = None
        props = []
        in_vertex = False
        while True:
            line = handle.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            words = line.decode("ascii", "replace").split()
            if not words:
                continue
            if words[0] == "format":
                fmt = words[1]
            elif words[0] == "element":
                in_vertex = words[1] == "vertex"
                if in_vertex:
                    n_vertices = int(words[2])
            elif words[0] == "property" and in_vertex:
                if words[1] == "list":
                    raise ValueError(
                        f"{path}: list property on vertex element")
                props.append((words[2], _PLY_DTYPES[words[1]]))
            elif words[0] == "end_header":
                break
        if n_vertices is None:
            raise ValueError(f"{path}: no vertex element")

        if fmt == "ascii":
            rows = np.loadtxt(
                handle, dtype=np.float32, max_rows=n_vertices, ndmin=2)
            return rows[:, : len(props)].astype(np.float32)
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(name, endian + kind) for name, kind in props])
        raw = np.frombuffer(
            handle.read(dtype.itemsize * n_vertices), dtype=dtype,
            count=n_vertices)
        out = np.empty((n_vertices, len(props)), np.float32)
        for i, (name, _) in enumerate(props):
            out[:, i] = raw[name].astype(np.float32)
        return out


def save_ply(path, points, binary=True):
    """Write an (N, 3+) float32 cloud as a PLY vertex element (columns
    beyond xyz stored as prop_3, prop_4, ...)."""
    points = np.asarray(points, dtype=np.float32)
    names = ["x", "y", "z"] + [
        f"prop_{i}" for i in range(3, points.shape[1])]
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {len(points)}"]
    header += [f"property float {name}" for name in names[:points.shape[1]]]
    header.append("end_header")
    with open(path, "wb") as handle:
        handle.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            handle.write(
                np.ascontiguousarray(points, "<f4").tobytes())
        else:
            np.savetxt(handle, points, fmt="%.6f")


# ASPRS LAS point-record layouts (formats 0-3 are LAS 1.0-1.3; 6-8 are
# the LAS 1.4 records).  Waveform formats (4/5/9/10) load as their base
# layout with the waveform block left in the record padding.
_LAS_BASE_03 = [
    ("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
    ("returns", "u1"), ("classification", "u1"), ("scan_angle", "i1"),
    ("user_data", "u1"), ("point_source", "<u2")]
_LAS_BASE_6P = [
    ("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
    ("returns", "u1"), ("flags", "u1"), ("classification", "u1"),
    ("user_data", "u1"), ("scan_angle", "<i2"), ("point_source", "<u2"),
    ("gps_time", "<f8")]
_LAS_GPS = [("gps_time", "<f8")]
_LAS_RGB = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_LAS_POINT_FIELDS = {
    0: _LAS_BASE_03,
    1: _LAS_BASE_03 + _LAS_GPS,
    2: _LAS_BASE_03 + _LAS_RGB,
    3: _LAS_BASE_03 + _LAS_GPS + _LAS_RGB,
    4: _LAS_BASE_03 + _LAS_GPS,
    5: _LAS_BASE_03 + _LAS_GPS + _LAS_RGB,
    6: _LAS_BASE_6P,
    7: _LAS_BASE_6P + _LAS_RGB,
    8: _LAS_BASE_6P + _LAS_RGB + [("nir", "<u2")],
    9: _LAS_BASE_6P,
    10: _LAS_BASE_6P + _LAS_RGB + [("nir", "<u2")],
}


def load_las(path, *, with_classification=False):
    """
    ASPRS LAS loader (versions 1.0-1.4, point formats 0-10;
    LAZ-compressed files are rejected with a clear error).  Returns a
    float32 (N, C) array with columns ``x, y, z, intensity`` plus
    ``r, g, b`` (and ``nir``) when the point format carries color --
    coordinates are descaled to world units (scale * record + offset;
    recentering for fp32 health happens at the FlexCloud/CloudArchive
    layer, same as every other ingest path).

    ``with_classification=True`` additionally returns the int32 ASPRS
    classification codes (formats 0-5 mask off the three flag bits).
    """
    import struct

    with open(path, "rb") as handle:
        header = handle.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"{path} is not a LAS file")
        minor = header[25]
        point_offset, = struct.unpack_from("<I", header, 96)
        fmt_byte = header[104]
        if fmt_byte & 0x80:
            raise ValueError(
                f"{path} is LAZ-compressed; decompress to .las first")
        fmt = fmt_byte & 0x3F
        if fmt not in _LAS_POINT_FIELDS:
            raise ValueError(f"{path}: unsupported point format {fmt}")
        rec_len, = struct.unpack_from("<H", header, 105)
        count, = struct.unpack_from("<I", header, 107)
        scale = struct.unpack_from("<3d", header, 131)
        offset = struct.unpack_from("<3d", header, 155)
        if count == 0 and minor >= 4 and len(header) >= 255:
            count, = struct.unpack_from("<Q", header, 247)

        fields = list(_LAS_POINT_FIELDS[fmt])
        base_len = np.dtype(fields).itemsize
        if rec_len < base_len:
            raise ValueError(
                f"{path}: record length {rec_len} < format {fmt} "
                f"minimum {base_len}")
        if rec_len > base_len:
            fields.append(("extra_bytes", f"V{rec_len - base_len}"))
        dtype = np.dtype(fields)

        handle.seek(point_offset)
        raw = np.frombuffer(
            handle.read(rec_len * count), dtype=dtype, count=count)

    columns = [
        raw["X"] * scale[0] + offset[0],
        raw["Y"] * scale[1] + offset[1],
        raw["Z"] * scale[2] + offset[2],
        raw["intensity"],
    ]
    for name in ("red", "green", "blue", "nir"):
        if name in raw.dtype.names:
            columns.append(raw[name])
    cloud = np.stack(
        [np.asarray(c, np.float64) for c in columns], axis=1
    ).astype(np.float32)
    if not with_classification:
        return cloud
    classification = raw["classification"].astype(np.int32)
    if fmt <= 5:
        classification &= 0x1F          # upper 3 bits are flags
    return cloud, classification


def save_las(path, points, *, classification=None, scale=None):
    """
    Write an (N, >=3) cloud as LAS 1.2: point format 0, or format 2
    when columns 4-6 carry RGB (column 3, if present, is stored as
    intensity).  ``classification`` optionally stores int per-point
    codes (values above 31 are clipped -- format 0-5 classification is
    5 bits).  ``scale`` defaults to 1e-3 world units (mm resolution).
    """
    import struct

    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    has_rgb = points.shape[1] >= 7
    fmt = 2 if has_rgb else 0
    fields = _LAS_POINT_FIELDS[fmt]
    dtype = np.dtype(fields)
    offset = points[:, :3].min(axis=0) if n else np.zeros(3)
    if scale is None:
        scale = 1e-3
    scale = np.broadcast_to(np.asarray(scale, np.float64), 3)

    record = np.zeros(n, dtype=dtype)
    quantized = np.round((points[:, :3] - offset) / scale)
    if n and np.abs(quantized).max() > 2**31 - 1:
        raise ValueError("cloud span exceeds int32 at this scale; "
                         "pass a coarser `scale`")
    record["X"], record["Y"], record["Z"] = quantized.astype(np.int64).T
    if points.shape[1] >= 4:
        record["intensity"] = np.clip(points[:, 3], 0, 65535)
    if has_rgb:
        for i, name in enumerate(("red", "green", "blue")):
            record[name] = np.clip(points[:, 4 + i], 0, 65535)
    if classification is not None:
        record["classification"] = np.clip(
            np.asarray(classification, np.int64), 0, 31)

    header_size = 227
    header = bytearray(header_size)
    header[:4] = b"LASF"
    header[24], header[25] = 1, 2
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, header_size)   # point data offset
    header[104] = fmt
    struct.pack_into("<H", header, 105, dtype.itemsize)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale)
    struct.pack_into("<3d", header, 155, *offset)
    lo = points[:, :3].min(axis=0) if n else np.zeros(3)
    hi = points[:, :3].max(axis=0) if n else np.zeros(3)
    # header order is max-x, min-x, max-y, min-y, max-z, min-z
    struct.pack_into(
        "<6d", header, 179, hi[0], lo[0], hi[1], lo[1], hi[2], lo[2])
    with open(path, "wb") as handle:
        handle.write(bytes(header))
        handle.write(record.tobytes())


def load_ascii(path, impl="native"):
    """Delimited ASCII -> float32 (rows, cols) through
    ``ops.native.parse_ascii`` (``impl="numpy"``: its NumPy twin)."""
    with open(path, "rb") as handle:
        text = handle.read()
    try:
        return native.parse_ascii(text, impl=impl)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None


def load_points(source):
    """
    Load a point cloud from an array, .npy/.npz file, or ASCII file.
    Returns a float32 2-D array (rows = points, first 3 columns = XYZ).
    """
    if isinstance(source, np.ndarray):
        cloud = source
    else:
        path = os.fspath(source)
        suffix = os.path.splitext(path)[1].lower()
        if suffix == ".npy":
            cloud = np.load(path)
        elif suffix == ".npz":
            archive = np.load(path)
            cloud = archive[list(archive.keys())[0]]
        elif suffix == ".ply":
            cloud = load_ply(path)
        elif suffix == ".las":
            cloud = load_las(path)
        elif suffix in ASCII_SUFFIXES:
            cloud = load_ascii(path)
        else:
            raise ValueError(f"unsupported point cloud format: {suffix}")
    cloud = np.asarray(cloud, dtype=np.float32)
    if cloud.ndim != 2 or cloud.shape[1] < 3:
        raise ValueError(
            f"point cloud must be (N, >=3), got {cloud.shape}")
    return cloud


def load_labeled(cloud_path, labels_path=None, *, null_label=None):
    """
    Dataset-convention loader: a cloud file plus a sidecar per-point
    label file (the Semantic3D ``.labels`` / Oakland convention; the
    reference's dainty_loader handled the cloud half only).

    ``labels_path`` defaults to the cloud path with a ``.labels``
    suffix.  ``null_label``, if given, is remapped to the archive's
    NULL_LABEL (999) -- Semantic3D uses 0 for "unlabeled".

    For ``.las`` clouds with no sidecar file, the labels are the LAS
    point records' own ASPRS classification codes.

    Returns ``(cloud float32 (N, C), labels int32 (N,))``.
    """
    path = os.fspath(cloud_path) if not isinstance(
        cloud_path, np.ndarray) else None
    if (path is not None and labels_path is None
            and os.path.splitext(path)[1].lower() == ".las"):
        cloud, labels = load_las(path, with_classification=True)
        if null_label is not None:
            from nimrud_tpu_torch.archive.store import NULL_LABEL
            labels = np.where(labels == null_label, NULL_LABEL, labels)
        return cloud, labels.astype(np.int32)
    cloud = load_points(cloud_path)
    if labels_path is None:
        base = os.path.splitext(os.fspath(cloud_path))[0]
        labels_path = base + ".labels"
    labels = np.loadtxt(labels_path, dtype=np.int64, ndmin=1)
    if labels.ndim > 1:
        labels = labels[:, 0]
    if labels.shape[0] != cloud.shape[0]:
        raise ValueError(
            f"label count {labels.shape[0]} != point count "
            f"{cloud.shape[0]}")
    if null_label is not None:
        from nimrud_tpu_torch.archive.store import NULL_LABEL
        labels = np.where(labels == null_label, NULL_LABEL, labels)
    return cloud, labels.astype(np.int32)


def save_ascii(path, array, delimiter=","):
    np.savetxt(path, array, delimiter=delimiter, fmt="%.6f")
