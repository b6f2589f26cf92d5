"""The port's native CSV ingest (st_dadk_tpu_torch.dataio.native, on
native/ingest.cpp built by g++ at first use) against its plain version, the
numpy reader `read_kaust_csv`: the cases of tests/test_native_ingest.py,
and `load_kaust_csv_single`, which reads through the native loader first."""
import numpy as np
import pytest

from st_dadk_tpu_torch.dataio import kaust as tk
from st_dadk_tpu_torch.dataio.native import load_csv_native
from st_dadk_tpu_torch.ops import _build
from torch_threads import worker_threads  # noqa: F401


def _write(path, header, rows):
    path.write_text(header + "\n" + "\n".join(rows) + "\n")
    return path


def _toy(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(50, 2)).round(6)
    rows = [f"{coords[s, 0]},{coords[s, 1]},{t},{rng.normal():.6f}"
            for t in range(1, 8) for s in range(50) if rng.uniform() < 0.8]
    return _write(tmp_path / "toy.csv", "x,y,t,z", rows), len(rows)


def test_synthetic_csv_matches_numpy_reader(tmp_path):
    csv, n = _toy(tmp_path)
    z_n, c_n, rows = load_csv_native(csv)
    z_p, c_p, rows_p = tk.read_kaust_csv(csv)
    assert rows == rows_p == n
    assert c_n.dtype == np.float64
    np.testing.assert_array_equal(c_n, c_p)            # same site order
    np.testing.assert_array_equal(z_n, z_p)            # NaN holes alike
    assert _build.host_library_path("ingest").exists()


def test_quoted_header_and_id_column(tmp_path):
    csv = _write(tmp_path / "q.csv", '"id_train","x","y","z"',
                 ["1,0.5,0.25,1.5", "2,0.75,0.1,-2.0"])
    z, coords, n = load_csv_native(csv)
    assert n == 2 and z.shape == (1, 2)
    np.testing.assert_array_equal(coords, [[0.5, 0.25], [0.75, 0.1]])
    np.testing.assert_array_equal(z[0], np.float32([1.5, -2.0]))


def test_float64_distinct_sites(tmp_path):
    """Sites distinct only beyond float32 stay distinct, their coords the
    exact doubles of the file."""
    x0 = 0.123456789012345
    x1 = x0 + 1e-12
    assert np.float32(x0) == np.float32(x1) and x0 != x1
    csv = _write(tmp_path / "p.csv", "x,y,z",
                 [f"{x0!r},0.5,1.0", f"{x1!r},0.5,2.0"])
    z, coords, n = load_csv_native(csv)
    assert n == 2 and z.shape == (1, 2)
    assert coords[0, 0] == x0 and coords[1, 0] == x1
    np.testing.assert_array_equal(coords, tk.read_kaust_csv(csv)[1])


def test_trailing_empty_field(tmp_path):
    csv = _write(tmp_path / "t.csv", "x,y,t,z",
                 ["0.1,0.2,3,", "0.5,0.6,4,1.25"])
    z, coords, n = load_csv_native(csv)
    assert n == 2 and z.shape == (4, 2)
    assert np.isnan(z[2, 0]) and z[3, 1] == np.float32(1.25)
    np.testing.assert_array_equal(coords, [[0.1, 0.2], [0.5, 0.6]])


def test_many_columns(tmp_path):
    extras = ",".join(f"c{i}" for i in range(20))
    vals = ",".join(str(i) for i in range(20))
    csv = _write(tmp_path / "w.csv", extras + ",x,y,z",
                 [vals + ",0.5,0.25,7.0", vals + ",0.75,0.1,-3.0"])
    z, coords, n = load_csv_native(csv)
    assert n == 2 and z.shape == (1, 2)
    np.testing.assert_array_equal(coords, [[0.5, 0.25], [0.75, 0.1]])
    np.testing.assert_array_equal(z[0], np.float32([7.0, -3.0]))
    for a, b in zip((z, coords, n), tk.read_kaust_csv(csv)):
        np.testing.assert_array_equal(a, b)


def test_refused_file_raises_with_the_loaders_reason(tmp_path):
    """No second reader: a file the native loader refuses raises, with its
    reason, from the loader and from `load_kaust_csv_single`."""
    with pytest.raises(FileNotFoundError):
        load_csv_native(tmp_path / "absent.csv")
    with pytest.raises(FileNotFoundError):
        tk.load_kaust_csv_single(tmp_path / "absent.csv", verbose=False)
    bad = _write(tmp_path / "bad.csv", "a,b", ["1,2"])
    with pytest.raises(ValueError, match="no x or no y column"):
        tk.load_kaust_csv_single(bad, verbose=False)
    headless = tmp_path / "headless.csv"
    headless.write_text("x,y,z")
    with pytest.raises(ValueError, match="no header line"):
        load_csv_native(headless)


@pytest.mark.parametrize("normalize", [False, True])
def test_load_kaust_csv_single_reads_native_as_numpy(tmp_path, monkeypatch,
                                                     normalize):
    """`load_kaust_csv_single` through the native loader gives what it
    gives with the numpy reader in the loader's place, bit for bit."""
    csv, _ = _toy(tmp_path, seed=3)
    native = tk.load_kaust_csv_single(csv, normalize=normalize,
                                      verbose=False)
    monkeypatch.setattr(tk, "load_csv_native", tk.read_kaust_csv)
    plain = tk.load_kaust_csv_single(csv, normalize=normalize, verbose=False)
    for a, b in zip(native[:2], plain[:2]):
        np.testing.assert_array_equal(a, b)
    assert native[2] == plain[2]


def test_stand_in_field_matches_numpy_reader():
    """The bench workload's stand-in field (1000 sites x 100 times)."""
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    path = bench_data_file()
    z_n, c_n, rows = load_csv_native(path)
    z_p, c_p, rows_p = tk.read_kaust_csv(path)
    assert rows == rows_p and z_n.shape == (100, 1000)
    np.testing.assert_array_equal(c_n, c_p)
    np.testing.assert_array_equal(z_n, z_p)
