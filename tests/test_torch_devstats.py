"""The port's device feature statistics (``braintpu_torch/features/devstats.py``)
against the reference's ``compute_*`` (JAX on the CPU) and the host numpy
route, on the CPU.

The port runs with ``device="cpu"``; the tolerances are those of the
reference's own ``tests/test_devstats.py`` against the host.  The steps run
under ``BRAINTPU_DEVICE_FEATURES=all`` on a CPU context and are held to the
port's host route.  Routing (the group grammar, ``auto`` on a CPU context and
under a device claim, the per-case pinned route, the pipeline's claim), the
EDT's independence of its chunk size and empty masks complete the file.
"""

import threading

import numpy as np
import pytest
import torch
from scipy import ndimage

from braintpu.features import devstats as ref_ds
from braintpu_torch.features import devstats as ds
from braintpu_torch.features import (FeatureContext, analyze_morphology,
                                     analyze_normal_structures, analyze_sequence_findings)
from braintpu_torch.features.context import brain_mask_from, intensity_stats, tumor_masks_from_seg
from braintpu_torch.features.step2_mass_effect import analyze_mass_effect
from braintpu_torch.features.step5_quality import assess_image_quality, detect_artifacts

MODS = ("t1", "t1ce", "t2", "flair")


def synth(seed=0, shape=(24, 28, 20), labels=(0, 1, 2, 3)):
    """Random volumes with a zero background and random labels (the
    reference test's generator)."""
    rng = np.random.default_rng(seed)
    mods = {m: np.abs(rng.normal(300 + 40 * i, 80, shape)).astype(np.float32)
            for i, m in enumerate(MODS)}
    for m in mods:
        mods[m][:3] = 0
    seg = rng.choice(labels, size=shape).astype(np.int32)
    seg[:6] = 0
    return mods, seg


def synth_tumor_blob(seed=0, shape=(24, 28, 20)):
    """Volumes with one compact nested tumor (dilations have real geometry)."""
    rng = np.random.default_rng(seed)
    mods = {m: np.abs(rng.normal(300 + 40 * i, 80, shape)).astype(np.float32)
            for i, m in enumerate(MODS)}
    for m in mods:
        mods[m][:3] = 0
        mods[m][-3:] = 0
    seg = np.zeros(shape, np.int32)
    seg[6:14, 8:18, 6:14] = 2
    seg[8:12, 10:16, 8:12] = 1
    seg[9:11, 12:14, 9:11] = 3
    return mods, seg


def assert_stats_close(got: dict, want: dict, context: str):
    assert got["voxel_count"] == want["voxel_count"], context
    if want["voxel_count"] == 0:
        assert got["mean"] is None, context
        return
    for k in ("mean", "std", "min", "max", "median", "q25", "q75"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-3,
                                   err_msg=f"{context}:{k}")


# ---------------------------------------------------------------------------
# Each compute_* against the reference's and the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,labels", [
    (0, (0, 1, 2, 3)),
    (1, (0, 2, 4)),
    (2, (0,)),
    (3, (0, 2, 3, 7)),  # a foreign label: WT only, not 'normal'
    (4, (-1, 0, 1, 3)),  # a negative label: in no region, not 'normal'
])
def test_case_stats_match_reference_and_host(seed, labels):
    mods, seg = synth(seed, labels=labels)
    brain = brain_mask_from(mods["t1"])
    got = ds.compute_case_stats(mods, seg, brain, device="cpu")
    want = ref_ds.compute_case_stats(mods, seg, brain)
    masks = tumor_masks_from_seg(seg)
    for region in ds.REGIONS:
        for m, data in mods.items():
            assert_stats_close(got[region][m], want[region][m], f"ref {region}/{m}")
            assert_stats_close(got[region][m], intensity_stats(data, masks[region]),
                               f"host {region}/{m}")
    for m, data in mods.items():
        assert_stats_close(got["normal"][m], want["normal"][m], f"ref normal/{m}")
        assert_stats_close(got["normal"][m], intensity_stats(data, brain_mask_from(data) & (seg == 0)),
                           f"host normal/{m}")
        g, w = got["quality"][m], want["quality"][m]
        assert g["n_brain"] == w["n_brain"] and g["zeros_in_brain"] == w["zeros_in_brain"]
        np.testing.assert_allclose(g["mean"], w["mean"], rtol=1e-4)
        np.testing.assert_allclose(g["std"], w["std"], rtol=1e-3)
        assert abs(g["bg_count"] - w["bg_count"]) <= 2  # p10 f32 boundary
        np.testing.assert_allclose(g["bg_std"], w["bg_std"], rtol=5e-2)
        assert abs(g["outliers"] - w["outliers"]) <= 2


def test_quality_stats_match_reference_and_host():
    mods, _ = synth(5)
    brain = brain_mask_from(mods["t1"])
    got = ds.compute_quality_stats(mods, brain, device="cpu")
    want = ref_ds.compute_quality_stats(mods, brain)
    for m, data in mods.items():
        g, w, bv = got[m], want[m], data[brain]
        assert g["n_brain"] == w["n_brain"] == bv.size
        np.testing.assert_allclose(g["mean"], w["mean"], rtol=1e-4)
        np.testing.assert_allclose(g["mean"], bv.mean(), rtol=1e-4)
        np.testing.assert_allclose(g["std"], bv.std(), rtol=1e-3)
        bg = ~brain & (data > 0) & (data < np.percentile(data[data > 0], 10))
        assert abs(g["bg_count"] - int(bg.sum())) <= 2
        assert abs(g["bg_count"] - w["bg_count"]) <= 2
        np.testing.assert_allclose(g["bg_std"], data[bg].std(), rtol=5e-2)
        assert g["zeros_in_brain"] == w["zeros_in_brain"] == int(((data == 0) & brain).sum())
        q01, q25, q75, q99 = np.percentile(bv, [1, 25, 75, 99])
        iqr = q75 - q25
        host_out = int((bv > q99 + 3 * iqr).sum() + (bv < q01 - 3 * iqr).sum())
        assert abs(g["outliers"] - host_out) <= 2 and abs(g["outliers"] - w["outliers"]) <= 2


def test_mass_effect_stats_match_reference_and_host():
    mods, seg = synth_tumor_blob(5)
    t1, wt = mods["t1"], seg > 0
    brain = brain_mask_from(t1)
    got = ds.compute_mass_effect_stats(t1, wt, brain, device="cpu")
    want = ref_ds.compute_mass_effect_stats(t1, wt, brain)
    for k in ("per_x_brain", "per_x_tumor"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["per_x_brain"], brain.sum(axis=(1, 2)))
    np.testing.assert_allclose(got["csf_threshold"], want["csf_threshold"], rtol=1e-5)
    np.testing.assert_allclose(got["csf_threshold"], np.percentile(t1[brain], 15), rtol=1e-5)
    csf = (t1 < np.float32(got["csf_threshold"])) & (t1 > 0) & ~wt
    mid = t1.shape[0] // 2
    assert got["csf_left"] == int(csf[:mid].sum()) and got["csf_right"] == int(csf[mid:].sum())
    expanded = ndimage.binary_dilation(wt, iterations=10)
    peri, distant = expanded & ~wt & brain, brain & ~expanded
    assert got["peri_count"] == want["peri_count"] == int(peri.sum())
    assert got["distant_count"] == want["distant_count"] == int(distant.sum())
    for k, mask in (("peri_std", peri), ("distant_std", distant)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        np.testing.assert_allclose(got[k], float(t1[mask].std()), rtol=1e-4)


def test_artifact_stats_match_reference_and_host():
    mods, seg = synth_tumor_blob(11)
    t1, wt = mods["t1"], seg > 0
    brain = brain_mask_from(t1)
    got = ds.compute_artifact_stats(mods, brain, wt, device="cpu")
    want = ref_ds.compute_artifact_stats(mods, brain, wt)
    coords = np.nonzero(brain)
    center = np.array([c.mean() for c in coords])
    dist = np.sqrt(sum((coords[i] - center[i]) ** 2 for i in range(3)))
    inner, outer = t1[brain][dist < dist.max() * 0.3], t1[brain][dist > dist.max() * 0.7]
    assert abs(got["inner_count"] - inner.size) <= 2
    assert abs(got["outer_count"] - outer.size) <= 2
    for k, host in (("inner_mean", inner.mean()), ("outer_mean", outer.mean())):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
        np.testing.assert_allclose(got[k], host, rtol=1e-3)
    for m, data in mods.items():
        bg = ~brain & (data > 0)
        g, w = got[f"bg_{m}"], want[f"bg_{m}"]
        assert g["count"] == w["count"] == int(bg.sum())
        np.testing.assert_allclose(g["mean"], data[bg].mean(), rtol=1e-5)
        np.testing.assert_allclose(g["std"], w["std"], rtol=1e-4)
        np.testing.assert_allclose(g["std"], data[bg].std(), rtol=1e-4)
    for k in ("per_z_zero", "per_z_brain", "edge_max"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["per_z_brain"], brain.sum(axis=(0, 1)))
    edge = wt & ~ndimage.binary_erosion(wt, iterations=2)
    assert got["gibbs_edge_count"] == want["gibbs_edge_count"] == int(edge.sum())
    tf = t1.astype(float)
    g = np.sqrt(sum(ndimage.sobel(tf, axis=a) ** 2 for a in range(3)))
    np.testing.assert_allclose(got["gibbs_grad_mean"], g[edge].mean(), rtol=1e-4)
    np.testing.assert_allclose(got["gibbs_grad_mean"], want["gibbs_grad_mean"], rtol=1e-4)
    np.testing.assert_allclose(got["gibbs_grad_std"], g[edge].std(), rtol=1e-3)


def test_morphology_stats_match_reference_and_host():
    mods, seg = synth_tumor_blob(19)
    t1ce, wt = mods["t1ce"], seg > 0
    got = ds.compute_morphology_stats(t1ce, wt, device="cpu")
    want = ref_ds.compute_morphology_stats(t1ce, wt)
    surface = wt & ~ndimage.binary_erosion(wt)
    signed = ndimage.distance_transform_edt(wt) - ndimage.distance_transform_edt(~wt)
    gm = np.sqrt(sum(gr ** 2 for gr in np.gradient(signed)))[surface]
    peri = ndimage.binary_dilation(wt, iterations=5) & ~wt
    outer = ndimage.binary_dilation(wt) & ~wt
    for k in ("surface_count", "peri_count", "inner_count", "outer_count"):
        assert got[k] == want[k], k
    assert got["surface_count"] == int(surface.sum()) and got["peri_count"] == int(peri.sum())
    assert got["outer_count"] == int(outer.sum())
    for k, host, rtol in (("grad_mean", gm.mean(), 1e-5), ("grad_std", gm.std(), 1e-4),
                          ("wt_t1ce_mean", t1ce[wt].mean(), 1e-5),
                          ("peri_t1ce_mean", t1ce[peri].mean(), 1e-5),
                          ("outer_mean", t1ce[outer].mean(), 1e-5),
                          ("outer_std", t1ce[outer].std(), 1e-4),
                          ("inner_mean", t1ce[surface].mean(), 1e-5)):
        np.testing.assert_allclose(got[k], host, rtol=rtol, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_parenchyma_stats_match_reference_and_host():
    mods, seg = synth_tumor_blob(31)
    t1, flair, wt = mods["t1"], mods["flair"], seg > 0
    brain = brain_mask_from(t1)
    got = ds.compute_parenchyma_stats(t1, flair, brain, wt, device="cpu")
    want = ref_ds.compute_parenchyma_stats(t1, flair, brain, wt)
    normal = brain & ~wt
    bd = ndimage.distance_transform_edt(brain)
    deep = normal & (bd > np.percentile(bd[brain], 60))
    cort = normal & (bd < np.percentile(bd[brain], 40))
    assert got["normal_count"] == want["normal_count"] == int(normal.sum())
    assert got["brain_count"] == want["brain_count"] == int(brain.sum())
    # the float64 depth field equals the host's, so the bands do too
    assert got["deep_count"] == int(deep.sum()) and got["cortical_count"] == int(cort.sum())
    assert abs(got["deep_count"] - want["deep_count"]) <= 3
    assert abs(got["cortical_count"] - want["cortical_count"]) <= 3
    for k, host in (("deep_t1_mean", t1[deep].mean()), ("cortical_t1_mean", t1[cort].mean()),
                    ("cortical_flair_mean", flair[cort].mean())):
        np.testing.assert_allclose(got[k], host, rtol=1e-3)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)


def test_edt_exact_vs_scipy_and_the_same_bits_at_two_chunk_sizes():
    rng = np.random.default_rng(3)
    for shape in [(12, 15, 9), (31, 8, 17)]:
        mask = rng.random(shape) > 0.7
        mask[0, 0, 0] = False  # a background voxel
        t = torch.from_numpy(mask)
        big = ds._edt_sq(t)  # one chunk per pass
        small = ds._edt_sq(t, temp_bytes=4 * 31 * 31 * 3)  # a few rows per chunk
        assert torch.equal(big, small)
        np.testing.assert_allclose(np.sqrt(big.numpy()), ndimage.distance_transform_edt(mask),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(ds._edt(t).numpy(), ndimage.distance_transform_edt(mask),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# Empty and no-tumour masks
# ---------------------------------------------------------------------------


def test_empty_segmentation_and_empty_masks():
    mods, seg = synth(4)
    seg[:] = 0
    got = ds.compute_case_stats(mods, seg, device="cpu")
    for region in ds.REGIONS:
        for m in mods:
            assert got[region][m]["voxel_count"] == 0 and got[region][m]["mean"] is None
    assert got["normal"]["t1"]["voxel_count"] > 0
    shape = (16, 18, 14)
    zeros = {m: np.zeros(shape, np.float32) for m in MODS}
    empty = np.zeros(shape, bool)
    art = ds.compute_artifact_stats(zeros, empty, empty, device="cpu")
    assert art["inner_count"] == art["outer_count"] == art["gibbs_edge_count"] == 0
    assert np.isfinite(art["gibbs_grad_mean"]) and np.isfinite(art["gibbs_grad_std"])
    assert art["per_z_brain"].sum() == 0 and all(art[f"bg_{m}"]["count"] == 0 for m in MODS)
    mor = ds.compute_morphology_stats(zeros["t1ce"], empty, device="cpu")
    assert mor["surface_count"] == mor["peri_count"] == 0
    par = ds.compute_parenchyma_stats(zeros["t1"], zeros["flair"], empty, empty, device="cpu")
    assert par["brain_count"] == par["deep_count"] == 0


@pytest.mark.parametrize("step", ["mass", "morph", "artifacts"])
def test_no_tumour_steps_under_device_flag(step, monkeypatch):
    mods, _ = synth_tumor_blob(9)
    seg = np.zeros(mods["t1"].shape, np.int32)
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "all")
    ctx = FeatureContext.from_arrays(mods, seg, device="cpu")
    if step == "mass":
        assert analyze_mass_effect(ctx)["midline_shift"]["severity"] == "No tumor detected"
    elif step == "morph":
        res = analyze_morphology(ctx)
        assert res["border_regularity"]["classification"] == "No tumor"
        assert res["margin_definition"]["classification"] == "No tumor"
    else:
        assert detect_artifacts(ctx)["details"]["gibbs_ringing"] == {"detected": False}


# ---------------------------------------------------------------------------
# Each step: the device route (on the CPU) against the port's host route
# ---------------------------------------------------------------------------


def _both(fn, mods, seg, monkeypatch):
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "0")
    host = fn(FeatureContext.from_arrays(mods, seg, device="cpu"))
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "all")
    ctx = FeatureContext.from_arrays(mods, seg, device="cpu")
    assert ctx._use_device_stats("stats") and ctx._use_device_stats("parenchyma")
    return host, fn(ctx)


def test_step1_under_device_flag(monkeypatch):
    mods, seg = synth(3)
    host, dev = _both(analyze_sequence_findings, mods, seg, monkeypatch)

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()}
        return round(d, 1) if isinstance(d, float) else d

    assert strip(dev["region_signal_analysis"]) == strip(host["region_signal_analysis"])
    assert dev["contrast_enhancement"]["pattern"] == host["contrast_enhancement"]["pattern"]
    assert dev["t2_flair_mismatch"] == host["t2_flair_mismatch"]


def test_step2_under_device_flag(monkeypatch):
    mods, seg = synth_tumor_blob(7)
    host, dev = _both(analyze_mass_effect, mods, seg, monkeypatch)
    hm, dm = host["midline_shift"], dev["midline_shift"]
    np.testing.assert_allclose(dm["shift_mm"], hm["shift_mm"], atol=1e-6)
    assert (dm["severity"], dm["tumor_hemisphere"]) == (hm["severity"], hm["tumor_hemisphere"])
    hv, dv = host["ventricular_compression"], dev["ventricular_compression"]
    np.testing.assert_allclose(dv["asymmetry_ratio"], hv["asymmetry_ratio"], atol=2e-3)
    assert dv["severity"] == hv["severity"]
    if hv["tumor_to_ventricle_distance_mm"] is not None:
        np.testing.assert_allclose(dv["tumor_to_ventricle_distance_mm"],
                                   hv["tumor_to_ventricle_distance_mm"], atol=0.5)
    hs, dsf = host["sulcal_effacement"], dev["sulcal_effacement"]
    np.testing.assert_allclose(dsf["variance_ratio"], hs["variance_ratio"], rtol=1e-3)
    assert dsf["severity"] == hs["severity"]
    assert dev["herniation_risk"]["mass_effect_score"] == \
        host["herniation_risk"]["mass_effect_score"]


def test_step4_under_device_flag(monkeypatch):
    mods, seg = synth_tumor_blob(23)
    host, dev = _both(analyze_morphology, mods, seg, monkeypatch)
    hb, db = host["border_regularity"], dev["border_regularity"]
    np.testing.assert_allclose(db["regularity_score"], hb["regularity_score"], rtol=1e-4)
    assert db["classification"] == hb["classification"]
    assert db["surface_voxel_count"] == hb["surface_voxel_count"]
    hm, dm = host["margin_definition"], dev["margin_definition"]
    for k in ("margin_sharpness", "contrast_ratio"):
        np.testing.assert_allclose(dm[k], hm[k], rtol=1e-3, atol=1e-5)
    assert dm["classification"] == hm["classification"]
    hs, dsd = host["shape_descriptors"], dev["shape_descriptors"]
    np.testing.assert_allclose(dsd["surface_area_mm2"], hs["surface_area_mm2"], rtol=1e-6)
    np.testing.assert_allclose(dsd["sphericity"], hs["sphericity"], rtol=1e-6)


def test_step5_under_device_flag(monkeypatch):
    mods, seg = synth_tumor_blob(13)
    host, dev = _both(assess_image_quality, mods, seg, monkeypatch)
    assert dev["overall_quality"] == host["overall_quality"]
    for name in host["sequences"]:
        h, d = host["sequences"][name], dev["sequences"][name]
        assert (d["quality"], d["issues"]) == (h["quality"], h["issues"])
        np.testing.assert_allclose(d["snr_estimate"], h["snr_estimate"], rtol=5e-2)
        np.testing.assert_allclose(d["mean_intensity"], h["mean_intensity"], rtol=1e-4)
    host, dev = _both(detect_artifacts, mods, seg, monkeypatch)
    assert (dev["artifacts_detected"], dev["severity"]) == \
        (host["artifacts_detected"], host["severity"])
    for key in ("intensity_inhomogeneity", "motion_ghosting", "susceptibility",
                "wrap_around", "gibbs_ringing"):
        assert dev["details"][key]["detected"] == host["details"][key]["detected"], key
    hr = host["details"]["intensity_inhomogeneity"].get("ratio")
    if hr is not None:
        np.testing.assert_allclose(dev["details"]["intensity_inhomogeneity"]["ratio"], hr,
                                   rtol=1e-3)


def test_step6_under_device_flag(monkeypatch):
    mods, seg = synth_tumor_blob(37)
    host, dev = _both(analyze_normal_structures, mods, seg, monkeypatch)
    hp, dp = host["parenchyma"], dev["parenchyma"]
    np.testing.assert_allclose(dp["periventricular_assessment"]["hyperintensity_ratio"],
                               hp["periventricular_assessment"]["hyperintensity_ratio"],
                               rtol=1e-3)
    np.testing.assert_allclose(dp["gray_white_differentiation"]["ratio"],
                               hp["gray_white_differentiation"]["ratio"], rtol=1e-3)
    assert dp["gray_white_differentiation"]["assessment"] == \
        hp["gray_white_differentiation"]["assessment"]
    assert dp["overall_assessment"] == hp["overall_assessment"]
    np.testing.assert_allclose(dp["normal_brain_volume_cm3"], hp["normal_brain_volume_cm3"])


# ---------------------------------------------------------------------------
# Volumes, routing, the pipeline's claim
# ---------------------------------------------------------------------------


def test_device_volumes_narrow_upload_and_shared_kernels():
    mods, seg = synth(14)
    int_mods = {k: np.round(v * 10).astype(np.float32) for k, v in mods.items()}
    brain = brain_mask_from(int_mods["t1"])
    dv = ds.DeviceVolumes(int_mods, seg, brain, device="cpu")
    assert dv._raw.dtype == torch.int16 and dv._seg_raw.dtype == torch.int8
    assert dv.data.dtype == torch.float32 and dv.seg.dtype == torch.int64
    np.testing.assert_array_equal(dv.modality("t1").numpy(), int_mods["t1"])
    np.testing.assert_array_equal(dv.seg.numpy(), seg)
    assert dv.block_until_uploaded() is dv
    frac = dict(int_mods, t1=int_mods["t1"] + 0.5)  # not integral: stays f32
    assert ds.DeviceVolumes(frac, seg, brain, device="cpu")._raw.dtype == torch.float32
    wide = ds.DeviceVolumes(int_mods, seg * 100, brain, device="cpu")
    assert wide._seg_raw.dtype == torch.int16
    wt = tumor_masks_from_seg(seg)["wt"]
    # the shared volumes give exactly what per-call uploads give
    assert ds.compute_case_stats(int_mods, seg, brain, dev=dv) == \
        ds.compute_case_stats(int_mods, seg, brain, device="cpu")
    a = ds.compute_artifact_stats(int_mods, brain, wt, dev=dv)
    b = ds.compute_artifact_stats(int_mods, brain, wt, device="cpu")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k] if not isinstance(a[k], dict)
                                                 else list(a[k].values())),
                                      np.asarray(b[k] if not isinstance(b[k], dict)
                                                 else list(b[k].values())), err_msg=k)


def test_group_grammar(monkeypatch):
    for val, want in (("0", set()), ("off", set()), ("", set()), ("1", set(ds.GROUPS)),
                      ("all", set(ds.GROUPS)), ("artifacts, parenchyma", {"artifacts", "parenchyma"}),
                      ("artifacts,bogus", {"artifacts"})):
        monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", val)
        assert ds.device_feature_groups("cpu") == want, val
        assert ds.device_features_enabled(device="cpu") == bool(want)
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "artifacts")
    assert ds.device_features_enabled("artifacts", "cpu")
    assert not ds.device_features_enabled("stats", "cpu")


def test_auto_takes_the_measured_set_only_on_an_idle_card(monkeypatch):
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES", raising=False)  # 'auto'
    monkeypatch.setattr(ds, "MEASURED_WIN_GROUPS", frozenset({"morph", "parenchyma"}))
    assert ds.device_feature_groups("cuda") == {"morph", "parenchyma"}
    assert ds.device_feature_groups(torch.device("cuda", 0)) == {"morph", "parenchyma"}
    assert ds.device_feature_groups("cpu") == frozenset()  # a CPU context: the host
    with ds.device_claim():
        assert ds.device_busy()
        assert ds.device_feature_groups("cuda") == frozenset()
    assert not ds.device_busy()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ds.device_feature_groups(None) == frozenset()  # no card present
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ds.device_feature_groups(None) == {"morph", "parenchyma"}
    mods, seg = synth(13)
    assert not FeatureContext.from_arrays(mods, seg, device="cpu")._use_device_stats()


def test_named_groups_without_a_card_raise(monkeypatch):
    """No hidden fallback: a device route with no card raises, as
    resolve_device does, and nothing retries on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "stats")
    mods, seg = synth(13)
    ctx = FeatureContext.from_arrays(mods, seg)  # device None: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctx.region_stats("wt", "t1")
    ctx = FeatureContext.from_arrays(mods, seg)
    ctx.start_device_upload()  # the upload thread fails; the error comes back
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctx.device_volumes()


def test_pinned_route_and_background_upload(monkeypatch):
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "artifacts")
    mods, seg = synth(12)
    ctx = FeatureContext.from_arrays(mods, seg, device="cpu")
    builds = []
    orig = ds.DeviceVolumes.__init__

    def counting(self, *a, **kw):
        builds.append(1)
        orig(self, *a, **kw)

    monkeypatch.setattr(ds.DeviceVolumes, "__init__", counting)
    ctx.start_device_upload()
    assert ctx._device_route == {"artifacts"} and ctx._device_upload is not None
    # the route stays pinned for the case whatever the flag says later
    monkeypatch.setenv("BRAINTPU_DEVICE_FEATURES", "0")
    assert ctx._use_device_stats("artifacts") and not ctx._use_device_stats("stats")
    first = ctx.device_volumes()
    assert ctx._device_upload is None and ctx.device_volumes() is first
    ctx.artifact_stats()
    ctx.mass_effect_stats()
    ctx.morphology_stats()
    ctx.parenchyma_stats()
    ctx._dev_stats()
    assert sum(builds) == 1  # one upload per case, every kernel shares it
    # a claimed device pins the host route for the whole case under 'auto'
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES")
    monkeypatch.setattr(ds, "MEASURED_WIN_GROUPS", frozenset(ds.GROUPS))
    busy = FeatureContext.from_arrays(mods, seg, device="cuda")
    with ds.device_claim():
        busy.start_device_upload()
    assert busy._device_route == frozenset() and busy._device_upload is None
    assert not busy._use_device_stats("stats")


def test_run_cases_claims_the_device_during_segmentation(tmp_path, monkeypatch):
    from braintpu_torch.pipeline import Pipeline, PipelineConfig
    from braintpu_torch.train.synthetic import write_synth_case

    cases = [write_synth_case(tmp_path / "in", f"BraTS-SYN-0000{i}-000", seed=i,
                              shape=(40, 44, 36)) for i in (1, 2)]
    seen, routes = [], []

    class Engine:
        output_convention = "internal"
        device = torch.device("cpu")

        def predict_case(self, case, output_path=None, loaded=None):
            seen.append((ds.device_busy(), threading.current_thread().name))
            seg = np.zeros(loaded[0].shape[1:], np.uint8)
            seg[10:20, 10:20, 10:20] = 2
            return seg, {"total_s": 0.0, "volumes_cm3": {}, "case_id": case.case_id}

    real = FeatureContext.start_device_upload

    def spy(self):
        real(self)
        routes.append((self.device, self._device_route))

    monkeypatch.setattr(FeatureContext, "start_device_upload", spy)
    monkeypatch.setattr(ds, "MEASURED_WIN_GROUPS", frozenset(ds.GROUPS))
    monkeypatch.delenv("BRAINTPU_DEVICE_FEATURES", raising=False)
    results = Pipeline(Engine(), PipelineConfig(output_root=tmp_path / "out",
                                                generate_pdf=False)).run_cases(cases)
    assert all(r.succeeded for r in results)
    assert [busy for busy, _ in seen] == [True, True]
    assert all(name.startswith("seg") for _, name in seen)
    assert not ds.device_busy()
    # the engine's CPU device keeps 'auto' on the host, claim or no claim
    assert routes == [(torch.device("cpu"), frozenset())] * 2
