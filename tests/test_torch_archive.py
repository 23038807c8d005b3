"""
The port's cloud archive and ingest (``nimrud_tpu_torch.archive``)
against the JAX package's on the same inputs, on the CPU: the cases of
``tests/test_archive.py``, each run through both packages with equal
outputs (the archives' files, manifests and assets, the loaded arrays),
and an archive written by one package opened by the other.  ASCII goes
through the port's C++ host runtime (``ops.native.parse_ascii``).
"""

import json
import os

import numpy as np
import pytest

from nimrud_tpu.archive import io as jio
from nimrud_tpu.archive import store as jstore

from nimrud_tpu_torch.archive import io as tio
from nimrud_tpu_torch.archive import store as tstore


def _archives(tmp_path, source, **kwargs):
    """The same archive built by both packages: (reference, port)."""
    ref = jstore.CloudArchive.create(tmp_path / "ref", source, name="a",
                                     **kwargs)
    port = tstore.CloudArchive.create(tmp_path / "port", source, name="a",
                                      **kwargs)
    return ref, port


def _same_archive(ref, port):
    assert ref.manifest == port.manifest
    np.testing.assert_array_equal(ref.points, port.points)
    for name in ref.list_assets():
        for a, b in zip(ref.get_asset(name), port.get_asset(name)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_create_open_roundtrip(tmp_path):
    cloud = np.random.default_rng(10).random((500, 3)).astype(
        np.float32) * 10
    ref, port = _archives(tmp_path, cloud)
    _same_archive(ref, port)
    reopened = tstore.CloudArchive.open(tmp_path / "port")
    assert reopened.manifest["name"] == "a"
    assert np.allclose(reopened.take(), cloud, atol=1e-5)
    # either package opens the other's archive
    _same_archive(jstore.CloudArchive.open(tmp_path / "port"),
                  tstore.CloudArchive.open(tmp_path / "ref"))
    with pytest.raises(FileExistsError):
        tstore.CloudArchive.create(tmp_path / "port", cloud)
    tstore.CloudArchive.create(tmp_path / "port", cloud, overwrite=True)


def test_extra_columns_recentering_and_natural_voxels(tmp_path):
    rng = np.random.default_rng(11)
    cloud = np.hstack([rng.random((100, 3)) + [500_000, 4_000_000, 100],
                       rng.random((100, 2))])
    ref, port = _archives(tmp_path, cloud)
    _same_archive(ref, port)
    data, _, _ = port.get_asset("source_attributes")
    assert np.allclose(data, cloud[:, 3:], atol=1e-6)
    assert np.linalg.norm(port.points.mean(0)) < 10
    np.testing.assert_array_equal(port.take(), ref.take())

    base = rng.random((50, 3)) * 10
    dup = np.vstack([base, base + 1e-4])
    keep = tstore.natural_voxel_indices(dup, 0.5)
    np.testing.assert_array_equal(keep,
                                  jstore.natural_voxel_indices(dup, 0.5))
    assert len(keep) < len(dup)
    ref, port = (jstore.CloudArchive.create(tmp_path / "vr", dup, voxel=0.5),
                 tstore.CloudArchive.create(tmp_path / "vp", dup, voxel=0.5))
    assert port.manifest["num_points"] == len(keep)
    np.testing.assert_array_equal(port.points, ref.points)


def test_assets_intersection_and_null_labels(tmp_path):
    rng = np.random.default_rng(12)
    ref, port = _archives(tmp_path, rng.random((200, 3)))
    feats = rng.random((100, 4)).astype(np.float32)
    labels = np.full(150, tstore.NULL_LABEL, np.int32)
    labels[:80] = rng.integers(0, 3, 80)
    for arc in (ref, port):
        arc.add_asset("feats", feats, np.arange(100), meta={"scales": [1]})
        arc.add_asset("labels", labels, np.arange(150) + 50)
    _same_archive(ref, port)
    for a, b in zip(ref.intersection(["feats", "labels"]),
                    port.intersection(["feats", "labels"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.labeled_indices(),
                                  ref.labeled_indices())
    assert tstore.NULL_LABEL == jstore.NULL_LABEL == 999
    with pytest.raises(ValueError):
        port.add_asset("feats", feats, np.arange(100))
    port.add_asset("feats", feats * 2, np.arange(100), overwrite=True)
    port.remove_asset("feats")
    assert "feats" not in tstore.CloudArchive.open(
        tmp_path / "port").list_assets()


def test_ascii_ingest(tmp_path):
    cloud = np.random.default_rng(13).random((50, 4)) * 10
    path = tmp_path / "cloud.csv"
    np.savetxt(path, cloud, delimiter=",", fmt="%.6f")
    loaded = tio.load_points(path)
    assert loaded.shape == (50, 4) and loaded.dtype == np.float32
    np.testing.assert_array_equal(loaded, jio.load_points(path))
    np.testing.assert_array_equal(tio.load_ascii(path, impl="numpy"),
                                  loaded)
    path2 = tmp_path / "cloud.xyz"
    np.savetxt(path2, cloud[:, :3], fmt="%.6f")
    np.testing.assert_array_equal(tio.load_points(path2),
                                  jio.load_points(path2))
    with pytest.raises(ValueError):
        tio.load_points(str(tmp_path / "cloud.laz"))
    empty = tmp_path / "empty.txt"
    empty.write_text("# header only\n")
    with pytest.raises(ValueError, match="no data"):
        tio.load_points(empty)
    tio.save_ascii(tmp_path / "out.csv", cloud)
    jio.save_ascii(tmp_path / "ref.csv", cloud)
    assert (tmp_path / "out.csv").read_bytes() \
        == (tmp_path / "ref.csv").read_bytes()


def test_ply_roundtrip_and_big_endian(tmp_path):
    cloud = np.random.default_rng(4).random((500, 5)).astype(
        np.float32) * 10
    for binary in (True, False):
        tio.save_ply(tmp_path / "p.ply", cloud, binary=binary)
        jio.save_ply(tmp_path / "r.ply", cloud, binary=binary)
        assert (tmp_path / "p.ply").read_bytes() \
            == (tmp_path / "r.ply").read_bytes()
        np.testing.assert_array_equal(tio.load_ply(tmp_path / "p.ply"),
                                      jio.load_ply(tmp_path / "p.ply"))
    np.testing.assert_array_equal(tio.load_points(tmp_path / "p.ply"),
                                  jio.load_points(tmp_path / "p.ply"))
    path = tmp_path / "be.ply"
    header = (b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"property ushort intensity\nend_header\n")
    rec = np.zeros(2, dtype=[("x", ">f4"), ("y", ">f4"), ("z", ">f4"),
                             ("i", ">u2")])
    rec["x"], rec["y"], rec["z"] = [1.5, 4.0], [2.5, 5.0], [3.5, 6.0]
    rec["i"] = [7, 260]
    path.write_bytes(header + rec.tobytes())
    got = tio.load_ply(path)
    np.testing.assert_array_equal(got, jio.load_ply(path))
    assert np.array_equal(got[:, 3], [7, 260])


def test_load_labeled_semantic3d_convention(tmp_path):
    rng = np.random.default_rng(5)
    cloud = rng.random((200, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 200)
    np.savetxt(tmp_path / "scan.txt", cloud, fmt="%.6f")
    np.savetxt(tmp_path / "scan.labels", labels, fmt="%d")
    got = tio.load_labeled(tmp_path / "scan.txt", null_label=0)
    want = jio.load_labeled(tmp_path / "scan.txt", null_label=0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].dtype == np.int32
    assert (got[1][labels == 0] == tstore.NULL_LABEL).all()
    np.savetxt(tmp_path / "short.labels", labels[:100], fmt="%d")
    with pytest.raises(ValueError):
        tio.load_labeled(tmp_path / "scan.txt", tmp_path / "short.labels")


def test_las_roundtrip_rgb_and_garbage(tmp_path):
    rng = np.random.default_rng(6)
    cloud = np.column_stack([
        rng.random((300, 3)) * 50 + [1000.0, 2000.0, 30.0],
        rng.integers(0, 65536, 300)]).astype(np.float64)
    classes = rng.integers(0, 8, 300).astype(np.int32)
    tio.save_las(tmp_path / "p.las", cloud, classification=classes)
    jio.save_las(tmp_path / "r.las", cloud, classification=classes)
    assert (tmp_path / "p.las").read_bytes() \
        == (tmp_path / "r.las").read_bytes()
    got, got_cls = tio.load_las(tmp_path / "p.las", with_classification=True)
    assert np.allclose(got[:, :3], cloud[:, :3], atol=1e-3)
    np.testing.assert_array_equal(got_cls, classes)
    for a, b in zip(tio.load_labeled(tmp_path / "p.las", null_label=0),
                    jio.load_labeled(tmp_path / "p.las", null_label=0)):
        np.testing.assert_array_equal(a, b)
    rgb = np.column_stack([rng.random((100, 3)) * 10,
                           rng.integers(0, 65536, (100, 4))]).astype(
        np.float64)
    tio.save_las(tmp_path / "rgb.las", rgb, scale=1e-4)
    got = tio.load_las(tmp_path / "rgb.las")
    assert got.shape == (100, 7)
    np.testing.assert_array_equal(got, jio.load_las(tmp_path / "rgb.las"))
    bad = tmp_path / "bad.las"
    bad.write_bytes(b"NOPE" + b"\0" * 400)
    with pytest.raises(ValueError, match="not a LAS"):
        tio.load_las(bad)
    laz = bytearray(b"LASF" + b"\0" * 371)
    laz[104] = 0x80 | 1
    (tmp_path / "c.las").write_bytes(bytes(laz))
    with pytest.raises(ValueError, match="LAZ"):
        tio.load_las(tmp_path / "c.las")


def test_manifest_is_json(tmp_path):
    arc = tstore.CloudArchive.create(tmp_path / "m", np.zeros((3, 3)))
    with open(os.path.join(arc.root, "manifest.json")) as handle:
        assert json.load(handle)["num_points"] == 3
