"""The port's native host library and what uses it, held against the JAX
package's own native library and the pure-Python codec on the CPU.

``braintpu_torch/native`` builds ``nifti_native.cpp`` with g++ into
``braintpu_torch/_build/`` at first use.  Native decode is bit-equal to the
Python decode and to the reference's ``braintpu.native`` for every dtype,
gzipped and plain; the batch decode works and garbage raises; ``write_gz``
files read back through the reference's codec (byte-equal to the
reference's writer); ``edt_sq`` equals scipy's squared EDT and the
reference's; the case loader names its route; ``CasePrefetcher`` keeps
order, can be reused and broken out of; and every caller keeps its Python
route when the library is unavailable.
"""

import gzip
import struct
import time

import numpy as np
import pytest
import torch
from scipy import ndimage

from braintpu import native as jax_native
from braintpu.io import brats as jax_brats
from braintpu.io import nifti as jax_nifti

from braintpu_torch import native
from braintpu_torch.features import boxops
from braintpu_torch.infer.engine import InferenceEngine, ModelBundle
from braintpu_torch.io import brats, nifti
from braintpu_torch.models import unet3d
from braintpu_torch.train.synthetic import write_synth_case

PORT = native.SOURCE.parent.parent

_AFFINE = np.array([[-1.0, 0, 0, 90.0], [0, 1.0, 0, -126.0], [0, 0, 1.5, -72.0], [0, 0, 0, 1.0]])


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _write(path, dtype, shape=(9, 7, 5), seed=0, slope=1.0, inter=0.0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        data = rng.integers(max(info.min, -30000), min(info.max, 30000), shape).astype(dtype)
    else:
        data = rng.normal(120.0, 40.0, shape).astype(dtype)
    img = nifti.NiftiImage(data, _AFFINE, scl_slope=slope, scl_inter=inter)
    nifti.save(img, path)
    return data


@pytest.fixture
def built():
    if not native.native_available():
        pytest.fail(f"the native library did not build here: {native.build_error()}")
    return native


@pytest.fixture
def ref_native(built):
    """The reference's native library.  It builds in place, unguarded, on its
    first use in a checkout; a test process that loads it while another
    worker's build is writing it marks it failed, so retry for a while."""
    for _ in range(60):
        if jax_native.native_available():
            return jax_native
        jax_native._build_failed = False
        time.sleep(1.0)
    pytest.fail("the reference's native library did not load")


def test_library_builds_into_the_build_dir_under_a_source_hash(built):
    path = native.library_path()
    assert path.parent == PORT / "_build" and path.exists()
    assert path.name.startswith("libbraintpu_nifti-") and path.suffix == ".so"
    assert native.build_error() is None
    assert not list((PORT / "native").glob("*.so")), "a library in the package directory"


def test_a_failed_build_is_reported_and_every_caller_keeps_its_python_route(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_log", "g++: not here")
    assert not native.native_available() and native.build_error() == "g++: not here"
    with pytest.raises(IOError, match="unavailable"):
        native.read_nifti_f32(tmp_path / "x.nii.gz")
    data = _write(tmp_path / "v.nii.gz", np.int16)
    raw = (tmp_path / "v.nii.gz").read_bytes()
    assert raw[9] == 255  # Python's gzip writer (OS byte "unknown")
    vol, _, _ = nifti.load_f32(tmp_path / "v.nii.gz")
    np.testing.assert_array_equal(vol, data)
    mask = np.random.default_rng(0).random((7, 8, 9)) > 0.3
    assert np.array_equal(boxops.edt(mask), ndimage.distance_transform_edt(mask))
    case = write_synth_case(tmp_path / "in", "BraTS-SYN-00004-000", seed=4, shape=(20, 18, 16))
    assert brats.load_case_volumes(brats.find_cases(case)[0]).route == "python"


def test_build_failure_keeps_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build_native()
    assert not list((tmp_path / "build").glob("*")), "a partial library was left behind"


@pytest.mark.parametrize("gz", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint8, np.int32,
                                   np.int8, np.uint16, np.uint32])
def test_native_decode_bit_equal_to_python_and_reference(ref_native, tmp_path, dtype, gz):
    path = tmp_path / ("v.nii.gz" if gz else "v.nii")
    data = _write(path, dtype, seed=3)
    got, aff, zooms = native.read_nifti_f32(path)
    img = nifti.load(path)
    py = img.get_fdata(dtype=np.float32)
    ref, ref_aff, ref_zooms = jax_native.read_nifti_f32(path)
    assert got.dtype == np.float32 and got.shape == data.shape
    assert np.array_equal(_bits(got), _bits(py)) and np.array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(aff, ref_aff)
    np.testing.assert_allclose(aff, img.affine, atol=1e-5)
    assert zooms == ref_zooms and zooms == pytest.approx((1.0, 1.0, 1.5))


@pytest.mark.parametrize("dtype", [np.int16, np.uint8])
def test_native_decode_applies_the_scaling_as_the_python_codec(ref_native, tmp_path, dtype):
    path = tmp_path / "s.nii.gz"
    _write(path, dtype, seed=4, slope=0.37, inter=-12.5)
    got, _, _ = native.read_nifti_f32(path)
    py = nifti.load(path).get_fdata(dtype=np.float32)
    assert np.array_equal(_bits(got), _bits(py))
    assert np.array_equal(_bits(got), _bits(jax_native.read_nifti_f32(path)[0]))


def test_batch_decode_and_garbage_raises(ref_native, tmp_path):
    paths, datas = [], []
    for i in range(4):
        paths.append(tmp_path / f"m{i}.nii.gz")
        datas.append(_write(paths[-1], np.float32, shape=(12, 10, 8), seed=i))
    vols = native.read_batch_f32(paths)
    assert len(vols) == 4
    for v, d, p in zip(vols, datas, paths):
        assert np.array_equal(_bits(v), _bits(d))
        assert np.array_equal(_bits(v), _bits(jax_native.read_batch_f32([p])[0]))
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"not a nifti at all")
    with pytest.raises(IOError):
        native.read_nifti_f32(bad)
    with pytest.raises(IOError):
        native.read_batch_f32([paths[0], bad])
    with pytest.raises(IOError, match="cannot open"):
        native.read_nifti_f32(tmp_path / "missing.nii.gz")


def test_native_rejects_a_header_that_lies_about_its_datatype(built, tmp_path):
    """datatype float64 over an int16 payload: refused, not over-read."""
    p = tmp_path / "evil.nii.gz"
    nifti.save(np.arange(64, dtype=np.int16).reshape(4, 4, 4), p, affine=np.eye(4))
    raw = bytearray(gzip.decompress(p.read_bytes()))
    struct.pack_into("<h", raw, 70, 64)
    p.write_bytes(gzip.compress(bytes(raw)))
    with pytest.raises(IOError, match="malformed"):
        native.read_batch_f32([p])


def test_load_header_matches_the_reference(tmp_path):
    path = tmp_path / "h.nii.gz"
    data = _write(path, np.int16, shape=(6, 5, 4))
    shape, aff, zooms = nifti.load_header(path)
    rshape, raff, rzooms = jax_nifti.load_header(path)
    assert shape == rshape == data.shape
    np.testing.assert_array_equal(aff, raff)
    np.testing.assert_allclose(aff, _AFFINE, atol=1e-5)
    assert zooms == rzooms == pytest.approx((1.0, 1.0, 1.5))


@pytest.mark.parametrize("shape", [(9, 7, 5), (240, 240, 40)])  # the second spans 4 MB chunks
def test_write_gz_reads_back_through_the_reference_and_matches_its_bytes(ref_native, tmp_path, shape):
    data = np.random.default_rng(1).integers(0, 900, shape).astype(np.int16)
    nifti.save(data, tmp_path / "port.nii.gz", affine=_AFFINE)
    jax_nifti.save(data, tmp_path / "ref.nii.gz", affine=_AFFINE)
    port_bytes = (tmp_path / "port.nii.gz").read_bytes()
    assert port_bytes == (tmp_path / "ref.nii.gz").read_bytes()
    members = gzip.decompress(port_bytes)
    assert len(members) == 352 + data.nbytes
    img = jax_nifti.load(tmp_path / "port.nii.gz")
    np.testing.assert_array_equal(np.asarray(img.dataobj), data)
    np.testing.assert_allclose(img.affine, _AFFINE, atol=1e-5)
    payload = b"abc" * 2_000_000  # 6 MB: two gzip members
    native.write_gz(tmp_path / "p.gz", payload)
    assert gzip.decompress((tmp_path / "p.gz").read_bytes()) == payload
    jax_native.write_gz(tmp_path / "r.gz", payload)
    assert (tmp_path / "p.gz").read_bytes() == (tmp_path / "r.gz").read_bytes()


@pytest.mark.parametrize("shape,p", [((17, 23, 19), 0.3), ((40, 36, 30), 0.05), ((1, 9, 12), 0.5),
                                     ((12, 1, 1), 0.2)])
def test_edt_sq_equals_scipy_and_the_reference(ref_native, shape, p):
    mask = np.random.default_rng(sum(shape)).random(shape) > p
    mask.flat[0] = False  # at least one background voxel
    want = ndimage.distance_transform_edt(mask)
    got = native.edt_sq(mask)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.round(want ** 2).astype(np.int32))
    np.testing.assert_array_equal(got, jax_native.edt_sq(mask))
    assert np.array_equal(np.sqrt(got), want)  # bit for bit
    assert np.array_equal(boxops.edt(mask), want)
    # a non-bool mask: nonzero is foreground, as for scipy
    weights = mask * np.float32(0.5)
    np.testing.assert_array_equal(native.edt_sq(weights), got)
    with pytest.raises(ValueError, match="3-D"):
        native.edt_sq(mask[0])


def test_boxops_edt_takes_scipy_off_unit_sampling_and_rank(built, monkeypatch):
    mask = np.random.default_rng(2).random((8, 9, 10)) > 0.3
    calls = []
    real = native.edt_sq
    monkeypatch.setattr(native, "edt_sq", lambda m: calls.append(m.shape) or real(m))
    np.testing.assert_array_equal(boxops.edt(mask, sampling=(1.0, 1.0, 2.0)),
                                  ndimage.distance_transform_edt(mask, sampling=(1.0, 1.0, 2.0)))
    np.testing.assert_array_equal(boxops.edt(mask[0]), ndimage.distance_transform_edt(mask[0]))
    assert calls == []
    boxops.edt(mask, sampling=(1, 1, 1))
    assert calls == [(8, 9, 10)]


# ---------------------------------------------------------------------------
# Case loading, the prefetcher, the rename
# ---------------------------------------------------------------------------


def _cases(tmp_path, n=3):
    for i in range(n):
        write_synth_case(tmp_path, f"BraTS-SYN-0000{i}-000", seed=i, shape=(20 + i, 18, 16))
    cases = brats.find_cases(tmp_path)
    assert len(cases) == n
    return cases


def test_case_loader_routes_are_bit_equal_and_match_the_reference(built, tmp_path, monkeypatch):
    case = _cases(tmp_path, 1)[0]
    fast = brats.load_case_volumes(case)
    slow = brats.load_case_volumes_python(case)
    assert (fast.route, slow.route) == ("native", "python")
    data, affine, zooms = fast  # unpacks as the reference's triple
    assert np.array_equal(_bits(data), _bits(slow[0]))
    np.testing.assert_array_equal(affine, slow[1])
    assert zooms == slow[2]
    ref = jax_brats.load_case_volumes(jax_brats.find_cases(tmp_path)[0])
    assert np.array_equal(_bits(data), _bits(ref[0]))
    np.testing.assert_array_equal(affine, ref[1])

    def unavailable(paths):
        raise IOError("forced")

    monkeypatch.setattr(native, "read_batch_f32", unavailable)
    again = brats.load_case_volumes(case)
    assert again.route == "python" and np.array_equal(_bits(again[0]), _bits(data))


def test_case_loader_raises_on_a_shape_mismatch_on_both_routes(built, tmp_path):
    case = _cases(tmp_path, 1)[0]
    nifti.save(np.zeros((5, 5, 5), np.float32), case.modality_paths["t2"], affine=_AFFINE)
    for load in (brats.load_case_volumes, brats.load_case_volumes_native,
                 brats.load_case_volumes_python):
        with pytest.raises(ValueError, match="shape mismatch"):
            load(case)


def test_prefetcher_keeps_order_is_reusable_and_can_be_broken_out_of(built, tmp_path):
    cases = _cases(tmp_path)
    pf = brats.CasePrefetcher(cases, depth=2)
    assert len(pf) == 3
    for _ in range(2):  # a second pass over the same prefetcher
        got = list(pf)
        assert [c.case_id for c, _ in got] == [c.case_id for c in cases]
        for (c, loaded), case in zip(got, cases):
            assert np.array_equal(loaded[0], brats.load_case_volumes(case)[0])
            assert loaded.route == "native"
    for case, _ in pf:
        break
    assert case.case_id == cases[0].case_id
    assert [c.case_id for c, _ in pf] == [c.case_id for c in cases]


def test_prefetcher_raises_a_decode_error_at_its_case(tmp_path):
    cases = _cases(tmp_path)
    cases[1].modality_paths["t1"].write_bytes(b"garbage")
    it = iter(brats.CasePrefetcher(cases))
    assert next(it)[0].case_id == cases[0].case_id
    with pytest.raises((OSError, ValueError)):
        next(it)


def test_rename_gzips_through_native_like_the_reference(ref_native, tmp_path):
    data = np.arange(6 * 5 * 4, dtype=np.int16).reshape(6, 5, 4)
    for side in ("port", "ref"):
        (tmp_path / side).mkdir()
        nifti.save(data, tmp_path / side / "BraTS-GLI-00001-000-t1n.nii", affine=_AFFINE)
    assert brats.rename_brats2025_folder(tmp_path / "port") == \
        jax_brats.rename_brats2025_folder(tmp_path / "ref") == \
        [("BraTS-GLI-00001-000-t1n.nii", "BraTS-GLI-00001-000_t1.nii.gz")]
    out = tmp_path / "port" / "BraTS-GLI-00001-000_t1.nii.gz"
    assert out.read_bytes() == (tmp_path / "ref" / out.name).read_bytes()
    np.testing.assert_array_equal(np.asarray(nifti.load(out).dataobj), data)


def test_engine_reports_the_decode_route(built, tmp_path):
    case = _cases(tmp_path, 1)[0]
    cfg = unet3d.UNetConfig(base_features=4, max_features=8, num_pool=2,
                            compute_dtype=torch.float32)
    eng = InferenceEngine(models=[ModelBundle.from_folds(cfg, [unet3d.init_params(cfg, 0)])],
                          mode="fullconv", tta=False, device="cpu")
    _, info = eng.predict_case(case)
    assert info["decode_route"] == "native"
    _, info = eng.predict_case(case, loaded=brats.load_case_volumes_python(case))
    assert info["decode_route"] == "python"
    data, affine, zooms = brats.load_case_volumes(case)
    _, info = eng.predict_case(case, loaded=(data, affine, zooms))
    assert info["decode_route"] == "caller"
