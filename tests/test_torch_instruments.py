"""Port parity, the measured-filter loaders: `load_filters_svo_ascii` and
`load_filters_hdf5` of the port against the JAX package's on files this test
writes (SVO ascii files, the `FilterSet.to_hdf5` layout, per-filter groups
and a flat shared-λ layout). The curves are host numpy in both packages:
codes, wavelengths and transmissions must be equal exactly.
"""

import importlib.util

import numpy as np
import pytest

from synference_tpu import instruments as jins
from synference_tpu_torch import instruments as tins

needs_h5py = pytest.mark.skipif(importlib.util.find_spec("h5py") is None,
                                reason="needs h5py")


def _equal(port, ref):
    assert port.codes == ref.codes
    for a, b in zip(port.filters, ref.filters):
        np.testing.assert_array_equal(a.lam, b.lam)
        np.testing.assert_array_equal(a.transmission, b.transmission)


def _curve(center, width, n=80, seed=0):
    rng = np.random.default_rng(seed)
    lam = np.linspace(center - width, center + width, n)
    trans = np.clip(1.0 - ((lam - center) / width) ** 8, 0, None)
    return lam, trans + 0.01 * rng.standard_normal(n)  # some negatives


def test_svo_ascii(tmp_path):
    for i, (name, c, w) in enumerate((("JWST_NIRCam.F200W", 2e4, 2300.0),
                                      ("JWST_NIRCam.F444W", 4.4e4, 5000.0))):
        lam, trans = _curve(c, w, seed=i)
        order = np.random.default_rng(i).permutation(lam.size)  # unsorted
        np.savetxt(tmp_path / f"{name}.dat",
                   np.column_stack([lam[order], trans[order]]),
                   header="SVO filter profile")
    for arg in (str(tmp_path), str(tmp_path / "*.dat")):
        port, ref = tins.load_filters_svo_ascii(arg), \
            jins.load_filters_svo_ascii(arg)
        _equal(port, ref)
        assert port.codes == ["JWST/NIRCam.F200W", "JWST/NIRCam.F444W"]
        assert all((f.transmission >= 0).all() for f in port.filters)
        assert all((np.diff(f.lam) > 0).all() for f in port.filters)
    files = sorted(str(p) for p in tmp_path.glob("*.dat"))
    _equal(tins.load_filters_svo_ascii(files, codes=["A", "B"]),
           jins.load_filters_svo_ascii(files, codes=["A", "B"]))
    with pytest.raises(ValueError, match="codes must match"):
        tins.load_filters_svo_ascii(files, codes=["A"])
    with pytest.raises((FileNotFoundError, OSError)):
        tins.load_filters_svo_ascii(str(tmp_path / "none"))


@needs_h5py
@pytest.mark.parametrize("layout", ["own", "groups", "flat"])
def test_hdf5_layouts(tmp_path, layout):
    import h5py

    path = str(tmp_path / f"{layout}.h5")
    codes = ["JWST/NIRCam.F150W", "JWST/NIRCam.F277W", "HST/WFC3_IR.F160W"]
    curves = [_curve(1.5e4 + 6e3 * i, 2e3, seed=i) for i in range(3)]
    with h5py.File(path, "w") as f:
        if layout == "own":
            fs = tins.FilterSet([tins.Filter(code=c, lam=lam, transmission=t)
                                 for c, (lam, t) in zip(codes, curves)])
            fs.to_hdf5(f)
        elif layout == "groups":
            for i, (c, (lam, t)) in enumerate(zip(codes, curves)):
                g = f.create_group(f"band{i}")
                g.create_dataset("wavelength", data=lam)
                g.create_dataset("transmission", data=t)
                g.attrs["filter_code"] = c
            nested = f.create_group("Euclid").create_group("NISP.H")
            nested.create_dataset("t", data=curves[0][1])
            f.create_dataset("lam", data=curves[0][0])
            codes = codes + ["Euclid/NISP.H"]
        else:
            f.create_dataset("new_lam", data=curves[0][0])
            for c, (_, t) in zip(["F1", "F2", "F3"], curves):
                f.create_dataset(c, data=t)
            codes = ["F1", "F2", "F3"]
    port, ref = tins.load_filters_hdf5(path), jins.load_filters_hdf5(path)
    _equal(port, ref)
    assert sorted(port.codes) == sorted(codes)
    sub = codes[::-1][:2]
    _equal(tins.load_filters_hdf5(path, codes=sub),
           jins.load_filters_hdf5(path, codes=sub))
    with pytest.raises(KeyError):
        tins.load_filters_hdf5(path, codes=["nope"])


@needs_h5py
def test_hdf5_without_curves_raises(tmp_path):
    import h5py

    path = str(tmp_path / "empty.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("notes", data=np.arange(3))
    with pytest.raises(ValueError, match="no filter curves"):
        tins.load_filters_hdf5(path)
