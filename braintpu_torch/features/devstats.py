"""On-device batched masked-intensity statistics for the feature layer.

The port's counterpart of the reference's ``features/devstats.py``: the
upstream feature code computes each region × sequence intensity summary as
a separate host pass (``data[mask]`` gather + ``np.percentile`` per pair,
about 16 per case in step 1) and step 5 adds about 16 more masked
reductions.  Here each kernel group replaces its host passes with ordinary
PyTorch ops on tensors that live on one device:

* **moments** (count / mean / std / min / max) for every tumor region ×
  modality from label segment sums (``index_add_`` over the folded labels:
  the masks NCR/ED/ET/TC/WT are unions of labels, so one pass yields every
  region's sums at once) and per-label masked extremes;
* **exact masked quantiles** from ONE ascending ``torch.sort`` per
  modality row: for any mask, ``cumsum(mask[perm])`` gives each element's
  rank within the subset, so the subset's k-th order statistic is a
  ``torch.searchsorted`` into that cumulative count, with
  ``np.percentile``'s linear rule;
* the normal-brain reference and the step-5 quality reductions from the
  same sort; the mass-effect, artifact, morphology and parenchyma
  reductions of steps 2, 4, 5 and 6 (cross dilations and erosions, the
  Sobel magnitude, the brute-force min-plus squared EDT, ``np.gradient``).

Label semantics match the host masks (``context.tumor_masks_from_seg``):
labels above 4 count toward WT (host ``seg > 0``) but never toward
NCR/ED/ET/TC and are not "normal" background; negative labels are in no
region and not "normal" either.

Sums run in float64 (the reference sums in f32; over 8.9 M voxels f32
accumulation drifts from numpy's pairwise sums), quantile interpolation
uses numpy's ``_lerp`` in float64, and thresholds that the host compares in
f32 are compared in f32 here too, so counts match the host's.

Routing is per kernel group (``BRAINTPU_DEVICE_FEATURES``, see
:func:`device_feature_groups`).  ``auto`` resolves to
:data:`MEASURED_WIN_GROUPS` only for a feature context whose device is a
CUDA card, and to the host route otherwise.  An error inside a device group
propagates: nothing retries on the host.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "GROUPS",
    "MEASURED_WIN_GROUPS",
    "REGIONS",
    "DeviceVolumes",
    "compute_artifact_stats",
    "compute_case_stats",
    "compute_mass_effect_stats",
    "compute_morphology_stats",
    "compute_parenchyma_stats",
    "compute_quality_stats",
    "device_busy",
    "device_claim",
    "device_feature_groups",
    "device_features_enabled",
]

#: region name → segmentation labels composing it.  Label 5 is the
#: fold-bucket for labels ABOVE 4 (negatives fold into bucket 6): host
#: ``wt = seg > 0`` includes >4 labels, the named regions exclude them.
REGIONS = {
    "ncr": (1,),
    "ed": (2,),
    "et": (3, 4),
    "tc": (1, 3, 4),
    "wt": (1, 2, 3, 4, 5),
}

_QS = (0.25, 0.5, 0.75)
_BRAIN_QS = (0.01, 0.25, 0.75, 0.99)
_NUM_LABELS = 7  # 0..4 + foreign-label bucket 5 + negative-label bucket 6
_NEG_BUCKET = 6
_SINGLE_LABELS = (1, 2)  # labels consumed as single-label regions

#: kernel groups routable to the device independently
#: (``BRAINTPU_DEVICE_FEATURES`` takes a comma list of them).
GROUPS = ("stats", "mass", "morph", "artifacts", "parenchyma")

#: groups with a measured win on the H100 — the set ``auto`` resolves to for
#: a feature context on a CUDA card.  ``chip_smoke.py`` phase 13a times the
#: seed-200 case at 240x240x155 through ``run_all_steps`` under the host
#: route and under each group alone (min of 2), and phase 10 the served
#: pair under this set against the host route; on an H100 each group beat
#: the host route alone (PERF.md, "Feature statistics on the card").
MEASURED_WIN_GROUPS = frozenset(GROUPS)


def _on_card(device) -> bool:
    """Whether a context's device is a CUDA card (``None``: the card when
    one is present, as ``resolve_device`` reads it)."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# -- device-busy gate ---------------------------------------------------------
#
# In the overlapped pipeline (Pipeline.run_cases) case N's feature steps run
# WHILE case N+1's segmentation occupies the card: a feature kernel launched
# then queues behind the segmentation's kernels.  The segmentation span claims
# the device; 'auto' routing resolves to the host while any claim is held.
# Explicit BRAINTPU_DEVICE_FEATURES settings override.

_device_claims = 0
_device_claims_lock = threading.Lock()


@contextlib.contextmanager
def device_claim():
    """Mark the device busy for the duration (held by segmentation spans)."""
    global _device_claims
    with _device_claims_lock:
        _device_claims += 1
    try:
        yield
    finally:
        with _device_claims_lock:
            _device_claims -= 1


def device_busy() -> bool:
    """True while any segmentation span holds a device claim."""
    return _device_claims > 0


def device_feature_groups(device=None) -> frozenset:
    """Resolve ``BRAINTPU_DEVICE_FEATURES`` to the set of device groups.

    Values: ``0``/``off`` → none; ``1``/``all`` → every group; ``auto``
    (the default) → :data:`MEASURED_WIN_GROUPS` when ``device`` is a CUDA
    card and no segmentation holds a :func:`device_claim`, else none; or an
    explicit comma list of group names (unknown names are ignored).  Read
    per call.
    """
    val = os.environ.get("BRAINTPU_DEVICE_FEATURES", "auto").strip().lower()
    if val in ("0", "off", "none", ""):
        return frozenset()
    if val in ("1", "all", "on"):
        return frozenset(GROUPS)
    if val == "auto":
        if device_busy():
            return frozenset()  # don't queue behind an in-flight segmentation
        return MEASURED_WIN_GROUPS if _on_card(device) else frozenset()
    return frozenset(g.strip() for g in val.split(",")) & frozenset(GROUPS)


def device_features_enabled(group: Optional[str] = None, device=None) -> bool:
    """Whether device feature kernels are active (for ``group``, or any)."""
    groups = device_feature_groups(device)
    return (group in groups) if group is not None else bool(groups)


def _narrow_labels(seg: np.ndarray) -> np.ndarray:
    """Rounded labels in the narrowest integer dtype that holds them."""
    seg_i = np.round(np.asarray(seg)).astype(np.int32)
    for narrow in (np.int8, np.int16):
        cand = seg_i.astype(narrow)
        if np.array_equal(cand.astype(np.int32), seg_i):
            return cand
    return seg_i


class DeviceVolumes:
    """One-per-case device residency of the raw case volumes.

    Uploads the (M, X, Y, Z) modality stack, the segmentation and the brain
    mask ONCE; every kernel wrapper below accepts ``dev=`` and slices
    device-resident views.  The stack travels as int16 when that is exact
    (BraTS voxels are integer-valued) and widens to f32 on the device at
    first use; the segmentation travels as the narrowest integer dtype that
    holds its labels (int8 for BraTS) and widens to int64 (the index dtype
    of ``index_add_`` and of tensor indexing).

    On a card the host arrays are staged in pinned memory and copied on a
    side stream, with an event recorded after the copies: the constructor
    returns at once, :meth:`block_until_uploaded` waits on the event, and
    every accessor makes the current stream wait on it before its tensor is
    used.
    """

    def __init__(
        self,
        modalities: Dict[str, np.ndarray],
        seg: Optional[np.ndarray] = None,
        brain_mask: Optional[np.ndarray] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mods = list(modalities)
        stack = np.stack([np.asarray(modalities[m], np.float32) for m in self.mods])
        with np.errstate(invalid="ignore"):  # NaN/overflow just fail the check
            as_i16 = stack.astype(np.int16)
        host = {"raw": as_i16 if np.array_equal(as_i16.astype(np.float32), stack) else stack}
        if seg is not None:
            host["seg"] = _narrow_labels(seg)
        if brain_mask is not None:
            host["brain"] = np.asarray(brain_mask).astype(bool)
        self._uploaded = None
        self._pinned = None
        if self.device.type == "cuda":
            pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                      for k, v in host.items()}
            # allocated on the current stream, written on the side stream:
            # the accessors order every use after the event below
            dev = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                   for k, v in pinned.items()}
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for k, t in dev.items():
                    t.copy_(pinned[k], non_blocking=True)
                self._uploaded = torch.cuda.Event()
                self._uploaded.record(stream)
            self._pinned = pinned  # the copies read it until the event
        else:
            dev = {k: torch.from_numpy(v) for k, v in host.items()}
        self._raw = dev["raw"]
        self._seg_raw = dev.get("seg")
        self._brain = dev.get("brain")
        self._data: Optional[torch.Tensor] = None
        self._seg: Optional[torch.Tensor] = None

    def _ready(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self._uploaded is not None:
            torch.cuda.current_stream(self.device).wait_event(self._uploaded)
        return t

    def block_until_uploaded(self) -> "DeviceVolumes":
        """Wait for the host→device copies (background-upload support)."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
            self._pinned = None
        return self

    @property
    def data(self) -> torch.Tensor:
        """(M, X, Y, Z) float32 modality stack, widened on the device once."""
        if self._data is None:
            raw = self._ready(self._raw)
            self._data = raw if raw.dtype == torch.float32 else raw.float()
        return self._data

    @property
    def seg(self) -> Optional[torch.Tensor]:
        """int64 segmentation labels, widened on the device once."""
        if self._seg is None and self._seg_raw is not None:
            self._seg = self._ready(self._seg_raw).long()
        return self._seg

    @property
    def brain(self) -> Optional[torch.Tensor]:
        return self._ready(self._brain)

    def modality(self, name: str) -> torch.Tensor:
        return self.data[self.mods.index(name)]

    @property
    def wt(self) -> torch.Tensor:
        """Whole-tumor mask (seg > 0), matching context.tumor_masks['wt']."""
        return self.seg > 0


def _host(raw):
    """Tensors (in nested dicts) → numpy, one device→host copy each."""
    if isinstance(raw, dict):
        return {k: _host(v) for k, v in raw.items()}
    return raw.cpu().numpy()


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``np.percentile``'s linear interpolation (numpy's ``_lerp``): exact
    ``a`` when ``a == b``, whatever ``t``."""
    diff = b - a
    return torch.where(t >= 0.5, b - diff * (1 - t), a + diff * t)


def _masked_quantiles(sorted_vals: torch.Tensor, cum: torch.Tensor, n: torch.Tensor,
                      qs: Sequence[float]) -> torch.Tensor:
    """Quantiles (float64, one per ``qs``) of the masked subset from a
    shared global sort.

    ``sorted_vals`` (V,) ascending; ``cum`` (V,) int32 = cumulative count of
    subset members in sort order; ``n`` = subset size (0-d tensor).  The
    subset's 0-based rank-``r`` element sits at the first index where
    ``cum == r + 1`` (``searchsorted``'s default left side).  Indices are
    clamped into range, so an empty subset gives a value that callers
    ignore (its count is 0).
    """
    V = sorted_vals.shape[0]
    q = torch.tensor(qs, dtype=torch.float64, device=sorted_vals.device)
    pos = (n - 1).clamp(min=0).to(torch.float64) * q
    lo = torch.floor(pos)
    frac = pos - lo
    i_lo = torch.searchsorted(cum, lo.to(torch.int32) + 1).clamp_(max=V - 1)
    i_hi = torch.searchsorted(cum, torch.ceil(pos).to(torch.int32) + 1).clamp_(max=V - 1)
    return _lerp(sorted_vals[i_lo].double(), sorted_vals[i_hi].double(), frac)


def _tail_percentile(sorted_vals: torch.Tensor, nz_count: torch.Tensor,
                     pct: float) -> torch.Tensor:
    """Percentile of the strictly positive values of one ascending row:
    positives are the sort's tail, so it reads straight off the sort."""
    V = sorted_vals.shape[0]
    pos = (nz_count - 1).clamp(min=0).to(torch.float64) * (pct / 100.0)
    base = V - nz_count
    lo = torch.floor(pos)
    i_lo = (base + lo.long()).clamp(max=V - 1)
    i_hi = (base + torch.ceil(pos).long()).clamp(max=V - 1)
    return _lerp(sorted_vals[i_lo].double(), sorted_vals[i_hi].double(), pos - lo)


def _cum(member: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(member, 0, dtype=torch.int32)


def _moments(x: torch.Tensor, mask: torch.Tensor):
    """Two-pass masked count / float64 mean / float64 centered sum of
    squares (raw Σx² − n·mean² cancels at MRI intensity scales)."""
    n = mask.sum()
    x64 = x.double()
    s = torch.where(mask, x64, 0.0).sum()
    mean = s / n.clamp(min=1)
    css = torch.where(mask, (x64 - mean) ** 2, 0.0).sum()
    return n, s, mean, css


def _masked_mean_std(x: torch.Tensor, mask: torch.Tensor):
    n, _, mean, css = _moments(x, mask)
    return n, mean, torch.sqrt(css / n.clamp(min=1))


@torch.no_grad()
def _case_stats_kernel(data: torch.Tensor, seg: torch.Tensor, brain: torch.Tensor,
                       brain_pct: float = 5.0) -> Dict:
    """data (M, V) f32, seg (V,) int64, brain (V,) bool → stat tensors.

    One upload and one sort per modality row serve region moments and
    quantiles, the normal-brain reference AND the step-5 quality
    reductions.
    """
    M, V = data.shape
    dev = data.device
    # labels above 4 fold into bucket 5 (count toward WT like host
    # ``seg > 0``); negatives fold into bucket 6, in no region and not in
    # the seg == 0 'normal' reference
    seg = torch.where(seg < 0, _NEG_BUCKET, torch.where(seg > 4, 5, seg))
    label_count = torch.bincount(seg, minlength=_NUM_LABELS)  # int64 (L,)
    d64 = data.double()
    sums = torch.zeros(M, _NUM_LABELS, dtype=torch.float64, device=dev).index_add_(1, seg, d64)
    lm = sums / label_count.clamp(min=1)
    csss = torch.zeros_like(sums).index_add_(1, seg, (d64 - lm[:, seg]) ** 2)
    del d64
    # per-label extremes as masked reductions (an empty label gives ±inf, the
    # identity the union's min/max needs): a float scatter min/max would be
    # a compare-and-swap loop on seven addresses
    member = [seg == lab for lab in range(_NUM_LABELS)]
    mins = torch.stack([torch.where(m, data, float("inf")).amin(dim=1) for m in member], 1)
    maxs = torch.stack([torch.where(m, data, float("-inf")).amax(dim=1) for m in member], 1)
    del member

    unions = {name: labs for name, labs in REGIONS.items() if len(labs) > 1}
    union_n = {name: label_count[list(labs)].sum() for name, labs in unions.items()}
    union_labels = {name: torch.tensor(labs, device=dev) for name, labs in unions.items()}
    nz_count = (data > 0).sum(dim=1)  # (M,)
    background = seg == 0
    n_brain = brain.sum()
    rows = {k: [] for k in ("label_q1", "label_q2", *(f"union_{u}" for u in unions),
                            "normal_count", "normal_sum", "normal_css", "normal_min",
                            "normal_max", "normal_q", "brain_threshold", "q_mean", "q_std",
                            "q_bg_count", "q_bg_std", "q_zeros_in_brain", "q_outliers")}
    for mi in range(M):
        d = data[mi]
        vals, perm = torch.sort(d)
        seg_sorted = seg[perm]
        for lab in _SINGLE_LABELS:
            rows[f"label_q{lab}"].append(_masked_quantiles(
                vals, _cum(seg_sorted == lab), label_count[lab], _QS))
        for name in unions:
            member = torch.isin(seg_sorted, union_labels[name])
            rows[f"union_{name}"].append(
                _masked_quantiles(vals, _cum(member), union_n[name], _QS))

        # normal-brain reference: data > 5th pct of nonzero AND seg == 0;
        # the host compares in f32 (np.percentile of f32 data is f32)
        thr = _tail_percentile(vals, nz_count[mi], brain_pct).to(data.dtype)
        normal = (d > thr) & background
        n_n, n_s, _, n_css = _moments(d, normal)
        rows["normal_count"].append(n_n)
        rows["normal_sum"].append(n_s)
        rows["normal_css"].append(n_css)
        rows["normal_min"].append(torch.where(normal, d, float("inf")).min())
        rows["normal_max"].append(torch.where(normal, d, float("-inf")).max())
        rows["normal_q"].append(_masked_quantiles(vals, _cum(normal[perm]), n_n, _QS))
        rows["brain_threshold"].append(thr)

        # step-5 quality reductions under the (t1-derived) brain mask
        _, _, q_mean, q_css = _moments(d, brain)
        rows["q_mean"].append(q_mean)
        rows["q_std"].append(torch.sqrt(q_css / n_brain.clamp(min=1)))
        q01, q25, q75, q99 = _masked_quantiles(vals, _cum(brain[perm]), n_brain, _BRAIN_QS)
        p10 = _tail_percentile(vals, nz_count[mi], 10.0).to(data.dtype)
        bg = ~brain & (d > 0) & (d < p10)
        bg_n, _, _, bg_css = _moments(d, bg)
        rows["q_bg_count"].append(bg_n)
        rows["q_bg_std"].append(torch.sqrt(bg_css / bg_n.clamp(min=1)))
        rows["q_zeros_in_brain"].append(((d == 0) & brain).sum())
        iqr = q75 - q25  # the host's list percentiles are float64
        d64 = d.double()
        rows["q_outliers"].append(((d64 > q99 + 3 * iqr) & brain).sum()
                                  + ((d64 < q01 - 3 * iqr) & brain).sum())
    out = {k: torch.stack(v) for k, v in rows.items()}
    return {
        "label_count": label_count,
        "label_sum": sums,
        "label_css": csss,
        "label_min": mins,
        "label_max": maxs,
        "label_q": {lab: out.pop(f"label_q{lab}") for lab in _SINGLE_LABELS},
        "union_q": {name: out.pop(f"union_{name}") for name in unions},
        "q_n_brain": n_brain,
        **out,
    }


def _summary(count, total, css, mn, mx, q) -> Dict:
    """``css`` is the CENTERED sum of squares Σ(x − mean)²."""
    n = int(count)
    if n == 0:
        return {
            "mean": None, "std": None, "min": None, "max": None,
            "median": None, "q25": None, "q75": None, "voxel_count": 0,
        }
    mean = float(total) / n
    var = max(float(css) / n, 0.0)
    return {
        "mean": mean,
        "std": float(np.sqrt(var)),
        "min": float(mn),
        "max": float(mx),
        "median": float(q[1]),
        "q25": float(q[0]),
        "q75": float(q[2]),
        "voxel_count": n,
    }


def _stack_tensor(modalities: Dict[str, np.ndarray], mods, device) -> torch.Tensor:
    return torch.from_numpy(
        np.stack([np.asarray(modalities[m], np.float32) for m in mods])).to(device)


def _mask_tensor(mask, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(mask).astype(bool)).to(device)


def compute_case_stats(
    modalities: Dict[str, np.ndarray],
    seg: np.ndarray,
    brain_mask: Optional[np.ndarray] = None,
    dev: Optional[DeviceVolumes] = None,
    device=None,
) -> Dict[str, Dict[str, Dict]]:
    """One device pass → {region | 'normal' | 'quality'} → {modality} → stats.

    Regions and 'normal' use the dict schema of
    :func:`braintpu_torch.features.context.intensity_stats`; 'quality'
    carries the step-5 SNR-block reductions.  ``brain_mask`` is the
    (t1-derived) host brain mask for the quality block; when omitted, an
    all-false mask is used and the quality outputs are meaningless.  Pass
    ``dev`` (device-resident volumes) to skip the uploads; else the arrays
    go to ``device`` (``None``: the card).
    """
    if dev is not None:
        mods = dev.mods
        data = dev.data.reshape(dev.data.shape[0], -1)
        segf = dev.seg.reshape(-1)
        brain = (dev.brain.reshape(-1) if dev.brain is not None
                 else torch.zeros(segf.shape, dtype=torch.bool, device=segf.device))
    else:
        device = resolve_device(device)
        mods = list(modalities)
        data = _stack_tensor(modalities, mods, device).reshape(len(mods), -1)
        segf = torch.from_numpy(np.round(np.asarray(seg)).astype(np.int64).ravel()).to(device)
        brain = (torch.zeros(segf.shape, dtype=torch.bool, device=device) if brain_mask is None
                 else _mask_tensor(np.asarray(brain_mask).ravel(), device))
    raw = _host(_case_stats_kernel(data, segf, brain))

    out: Dict[str, Dict[str, Dict]] = {}
    for name, labs in REGIONS.items():
        count = sum(int(raw["label_count"][l]) for l in labs)
        out[name] = {}
        for mi, m in enumerate(mods):
            total = sum(float(raw["label_sum"][mi, l]) for l in labs)
            mn = min(raw["label_min"][mi, l] for l in labs)
            mx = max(raw["label_max"][mi, l] for l in labs)
            # pooled centered sum of squares across the union's labels:
            # css_U = Σ_l [css_l + n_l (mean_l − mean_U)²] — exact and
            # stable, unlike raw-Σx² recombination
            if count > 0:
                mean_u = total / count
                css = sum(
                    float(raw["label_css"][mi, l])
                    + float(raw["label_count"][l])
                    * (float(raw["label_sum"][mi, l]) / max(float(raw["label_count"][l]), 1.0)
                       - mean_u) ** 2
                    for l in labs
                )
            else:
                css = 0.0
            q = raw["label_q"][labs[0]][mi] if len(labs) == 1 else raw["union_q"][name][mi]
            out[name][m] = _summary(count, total, css, mn, mx, q)
    out["normal"] = {
        m: _summary(raw["normal_count"][mi], raw["normal_sum"][mi], raw["normal_css"][mi],
                    raw["normal_min"][mi], raw["normal_max"][mi], raw["normal_q"][mi])
        for mi, m in enumerate(mods)
    }
    out["quality"] = {
        m: {
            "n_brain": int(raw["q_n_brain"]),
            "mean": float(raw["q_mean"][mi]),
            "std": float(raw["q_std"][mi]),
            "bg_count": int(raw["q_bg_count"][mi]),
            "bg_std": float(raw["q_bg_std"][mi]),
            "zeros_in_brain": int(raw["q_zeros_in_brain"][mi]),
            "outliers": int(raw["q_outliers"][mi]),
        }
        for mi, m in enumerate(mods)
    }
    return out


def _cross(m: torch.Tensor, erode: bool) -> torch.Tensor:
    """One binary dilation (or erosion) of a bool volume by the 6-connected
    cross, scipy semantics with ``border_value=0``: a voxel's ±1 neighbour
    along each axis ORs into it (ANDs into it; outside the volume counts as
    background, so the two border planes of every axis erode away)."""
    out = m.clone()
    for axis in range(3):
        n = m.shape[axis]
        below, above = m.narrow(axis, 0, n - 1), m.narrow(axis, 1, n - 1)
        if erode:
            out.narrow(axis, 1, n - 1).logical_and_(below)
            out.narrow(axis, 0, n - 1).logical_and_(above)
            out.select(axis, 0).zero_()
            out.select(axis, n - 1).zero_()
        else:
            out.narrow(axis, 1, n - 1).logical_or_(below)
            out.narrow(axis, 0, n - 1).logical_or_(above)
    return out


def _dilate(m: torch.Tensor, iterations: int) -> torch.Tensor:
    for _ in range(iterations):
        m = _cross(m, erode=False)
    return m


@torch.no_grad()
def _mass_effect_kernel(t1: torch.Tensor, wt: torch.Tensor, brain: torch.Tensor,
                        dilate_iters: int = 10, csf_pct: float = 15.0) -> Dict:
    """Step-2 mass-effect reductions: per-sagittal-slab brain/tumor counts
    (midline shift), the 15th-pct CSF threshold of ``t1[brain]``
    (ventricular compression), left/right CSF counts, and the
    peritumoral-vs-distant intensity spread after a 10× cross dilation of
    the tumor (sulcal effacement)."""
    X = t1.shape[0]
    vals, perm = torch.sort(t1.reshape(-1))
    nb = brain.sum()
    # the host's np.percentile of f32 data at a scalar q is f32
    thr = _masked_quantiles(vals, _cum(brain.reshape(-1)[perm]), nb,
                            (csf_pct / 100.0,))[0].to(t1.dtype)
    csf = (t1 < thr) & (t1 > 0) & ~wt
    mid = X // 2
    expanded = _dilate(wt, dilate_iters)
    peri_n, _, peri_std = _masked_mean_std(t1, expanded & ~wt & brain)
    dist_n, _, dist_std = _masked_mean_std(t1, brain & ~expanded)
    return {
        "per_x_brain": brain.sum(dim=(1, 2)),
        "per_x_tumor": wt.sum(dim=(1, 2)),
        "csf_threshold": thr,
        "csf_left": csf[:mid].sum(),
        "csf_right": csf[mid:].sum(),
        "peri_count": peri_n,
        "peri_std": peri_std,
        "distant_count": dist_n,
        "distant_std": dist_std,
    }


def compute_mass_effect_stats(
    t1: np.ndarray,
    wt_mask: np.ndarray,
    brain_mask: np.ndarray,
    dev: Optional[DeviceVolumes] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Step-2 reductions as numpy scalars/arrays.  The per-x slab counts
    come back as exact integer vectors so the host keeps its float64
    center-of-mass arithmetic bit for bit."""
    if dev is not None:
        args = (dev.modality("t1"), dev.wt, dev.brain)
    else:
        device = resolve_device(device)
        args = (torch.from_numpy(np.asarray(t1, np.float32)).to(device),
                _mask_tensor(wt_mask, device), _mask_tensor(brain_mask, device))
    raw = _host(_mass_effect_kernel(*args))
    return {
        "per_x_brain": np.asarray(raw["per_x_brain"], np.int64),
        "per_x_tumor": np.asarray(raw["per_x_tumor"], np.int64),
        "csf_threshold": float(raw["csf_threshold"]),
        "csf_left": int(raw["csf_left"]),
        "csf_right": int(raw["csf_right"]),
        "peri_count": int(raw["peri_count"]),
        "peri_std": float(raw["peri_std"]),
        "distant_count": int(raw["distant_count"]),
        "distant_std": float(raw["distant_std"]),
    }


def _conv1d_sym(x: torch.Tensor, w, axis: int) -> torch.Tensor:
    """Correlate with a 3-tap kernel along one axis, 'reflect' boundary
    (scipy's default; for one voxel of padding it repeats the edge)."""
    n = x.shape[axis]
    i = torch.arange(n, device=x.device)
    prev = x.index_select(axis, (i - 1).clamp(min=0))
    nxt = x.index_select(axis, (i + 1).clamp(max=n - 1))
    return w[0] * prev + w[1] * x + w[2] * nxt


def _sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """|∇x| with scipy.ndimage.sobel semantics: per-axis derivative
    [-1,0,1] × smoothing [1,2,1] on the other two axes, reflect edges."""
    total = torch.zeros_like(x)
    for d_axis in range(3):
        g = _conv1d_sym(x, (-1.0, 0.0, 1.0), d_axis)
        for s_axis in range(3):
            if s_axis != d_axis:
                g = _conv1d_sym(g, (1.0, 2.0, 1.0), s_axis)
        total += g * g
    return torch.sqrt(total)


@torch.no_grad()
def _artifact_kernel(mods: torch.Tensor, brain: torch.Tensor, wt: torch.Tensor) -> Dict:
    """Step-5 artifact-detector reductions.  ``mods`` (M, X, Y, Z) f32 with
    t1 first: bias-field inner/outer shell means, per-modality background
    moments, susceptibility per-z zero counts, wrap-around edge maxima, and
    the Gibbs edge-gradient stats (2× cross erosion + full-volume Sobel
    magnitude)."""
    t1 = mods[0]
    X, Y, Z = t1.shape
    dev = t1.device
    nb = brain.sum().clamp(min=1).double()
    ix = torch.arange(X, dtype=torch.float64, device=dev)[:, None, None]
    iy = torch.arange(Y, dtype=torch.float64, device=dev)[None, :, None]
    iz = torch.arange(Z, dtype=torch.float64, device=dev)[None, None, :]
    cx = brain.sum(dim=(1, 2)).double().mul(ix[:, 0, 0]).sum() / nb
    cy = brain.sum(dim=(0, 2)).double().mul(iy[0, :, 0]).sum() / nb
    cz = brain.sum(dim=(0, 1)).double().mul(iz[0, 0, :]).sum() / nb
    dist = torch.sqrt((ix - cx) ** 2 + (iy - cy) ** 2 + (iz - cz) ** 2)
    max_dist = torch.where(brain, dist, float("-inf")).max()
    in_n, in_mean, _ = _masked_mean_std(t1, brain & (dist < max_dist * 0.3))
    out_n, out_mean, _ = _masked_mean_std(t1, brain & (dist > max_dist * 0.7))

    bg = [_masked_mean_std(mods[mi], ~brain & (mods[mi] > 0)) for mi in range(mods.shape[0])]

    m = 5
    edge = wt & ~_cross(_cross(wt, erode=True), erode=True)
    e_n, e_mean, e_std = _masked_mean_std(_sobel_magnitude(t1), edge)
    return {
        "inner_count": in_n, "inner_mean": in_mean,
        "outer_count": out_n, "outer_mean": out_mean,
        "bg_count": torch.stack([b[0] for b in bg]),
        "bg_mean": torch.stack([b[1] for b in bg]),
        "bg_std": torch.stack([b[2] for b in bg]),
        "per_z_zero": ((t1 == 0) & brain).sum(dim=(0, 1)),
        "per_z_brain": brain.sum(dim=(0, 1)),
        "edge_max": torch.stack([t1[:m].max(), t1[-m:].max(), t1[:, :m].max(),
                                 t1[:, -m:].max()]),
        "gibbs_edge_count": e_n, "gibbs_grad_mean": e_mean, "gibbs_grad_std": e_std,
    }


def compute_artifact_stats(
    modalities: Dict[str, np.ndarray],
    brain_mask: np.ndarray,
    wt_mask: np.ndarray,
    dev: Optional[DeviceVolumes] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """The step-5 artifact reductions; t1 must be the first modality in
    ``modalities`` iteration order."""
    if dev is not None:
        mods = dev.mods
        data, brain, wt = dev.data, dev.brain, dev.wt
    else:
        device = resolve_device(device)
        mods = list(modalities)
        data = _stack_tensor(modalities, mods, device)
        brain, wt = _mask_tensor(brain_mask, device), _mask_tensor(wt_mask, device)
    if mods[0] != "t1":
        raise ValueError(f"the artifact kernel expects t1 first, got {mods}")
    raw = _host(_artifact_kernel(data, brain, wt))
    out: Dict[str, np.ndarray] = {
        "inner_count": int(raw["inner_count"]),
        "inner_mean": float(raw["inner_mean"]),
        "outer_count": int(raw["outer_count"]),
        "outer_mean": float(raw["outer_mean"]),
        "per_z_zero": np.asarray(raw["per_z_zero"], np.int64),
        "per_z_brain": np.asarray(raw["per_z_brain"], np.int64),
        "edge_max": np.asarray(raw["edge_max"]),
        "gibbs_edge_count": int(raw["gibbs_edge_count"]),
        "gibbs_grad_mean": float(raw["gibbs_grad_mean"]),
        "gibbs_grad_std": float(raw["gibbs_grad_std"]),
    }
    for mi, mname in enumerate(mods):
        out[f"bg_{mname}"] = {
            "count": int(raw["bg_count"][mi]),
            "mean": float(raw["bg_mean"][mi]),
            "std": float(raw["bg_std"][mi]),
        }
    return out


_EDT_INF = 1e9  # finite "far" sentinel: f32-safe under += (i-j)^2 terms
#: the (chunk, n, n) temporary of one min-plus pass: 1 GiB, so a row of
#: n = 240 takes 4,660 rows per chunk (8 chunks for the x pass of a
#: 240x240x155 volume) and a pass peaks near 1 GiB above its input
_EDT_TEMP_BYTES = 1 << 30


def _edt_sq_pass(f: torch.Tensor, axis: int, temp_bytes: int = _EDT_TEMP_BYTES) -> torch.Tensor:
    """One exact min-plus pass of the separable squared EDT:
    ``out[i] = min_j f[j] + (i-j)²`` along ``axis`` (Felzenszwalb's
    decomposition, evaluated brute force).  Rows go in chunks that bound
    the (chunk, n, n) temporary by ``temp_bytes``; every output element is
    the same min over the same sums whatever the chunk, so the bits do not
    depend on it."""
    n = f.shape[axis]
    moved = f.movedim(axis, -1)
    lead = moved.shape[:-1]
    rows = moved.reshape(-1, n)
    R = rows.shape[0]
    idx = torch.arange(n, dtype=f.dtype, device=f.device)
    d2 = (idx[:, None] - idx[None, :]) ** 2  # (j, i)
    chunk = max(1, min(R, temp_bytes // max(4 * n * n, 1)))
    out = torch.empty_like(rows)
    for s in range(0, R, chunk):
        out[s:s + chunk] = (rows[s:s + chunk, :, None] + d2).amin(dim=1)
    return out.reshape(*lead, n).movedim(-1, axis)


def _edt_sq(mask: torch.Tensor, temp_bytes: int = _EDT_TEMP_BYTES) -> torch.Tensor:
    """Exact squared Euclidean distance (unit spacing, f32) from each True
    voxel to the nearest False voxel — ``ndimage.distance_transform_edt``
    semantics (0 on background).  The terms stay whole numbers below 3·n²,
    exact in f32."""
    f = torch.where(mask, _EDT_INF, 0.0).float()
    for axis in range(3):
        f = _edt_sq_pass(f, axis, temp_bytes)
    return f


def _edt(mask: torch.Tensor) -> torch.Tensor:
    """float64 EDT: the square root of the exact squared distances, as the
    host's ``edt`` (native or scipy) gives it."""
    return torch.sqrt(_edt_sq(mask).double())


def _np_gradient_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.gradient`` along one axis, unit spacing: central differences
    in the interior, one-sided at the two boundary planes."""
    n = a.shape[axis]
    interior = (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) * 0.5
    first = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    last = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)


@torch.no_grad()
def _morphology_kernel(t1ce: torch.Tensor, wt: torch.Tensor) -> Dict:
    """Step-4 border/margin reductions: the erosion surface count (shared
    by the surface-area formula), contour regularity (signed distance =
    EDT(wt) − EDT(~wt), np.gradient magnitude on surface voxels), and
    margin sharpness (5×-dilated peritumoral T1ce contrast + inner/outer
    border means)."""
    surface = wt & ~_cross(wt, erode=True)
    signed = _edt(wt) - _edt(~wt)
    gm = torch.sqrt(sum(_np_gradient_axis(signed, a) ** 2 for a in range(3)))
    _, g_mean, g_std = _masked_mean_std(gm, surface)
    del signed, gm
    peri = _dilate(wt, 5) & ~wt
    outer = _cross(wt, erode=False) & ~wt
    _, wt_mean, _ = _masked_mean_std(t1ce, wt)
    p_n, p_mean, _ = _masked_mean_std(t1ce, peri)
    i_n, i_mean, i_std = _masked_mean_std(t1ce, surface)
    o_n, o_mean, o_std = _masked_mean_std(t1ce, outer)
    return {
        "surface_count": surface.sum(),
        "grad_mean": g_mean, "grad_std": g_std,
        "wt_t1ce_mean": wt_mean,
        "peri_count": p_n, "peri_t1ce_mean": p_mean,
        "inner_count": i_n, "inner_mean": i_mean, "inner_std": i_std,
        "outer_count": o_n, "outer_mean": o_mean, "outer_std": o_std,
    }


def compute_morphology_stats(
    t1ce: np.ndarray,
    wt_mask: np.ndarray,
    dev: Optional[DeviceVolumes] = None,
    device=None,
) -> Dict[str, float]:
    """The step-4 border/margin reductions."""
    if dev is not None:
        args = (dev.modality("t1ce"), dev.wt)
    else:
        device = resolve_device(device)
        args = (torch.from_numpy(np.asarray(t1ce, np.float32)).to(device),
                _mask_tensor(wt_mask, device))
    raw = _host(_morphology_kernel(*args))
    out = {k: float(v) for k, v in raw.items()}
    for k in ("surface_count", "peri_count", "inner_count", "outer_count"):
        out[k] = int(raw[k])
    return out


@torch.no_grad()
def _parenchyma_kernel(t1: torch.Tensor, flair: torch.Tensor, brain: torch.Tensor,
                       wt: torch.Tensor) -> Dict:
    """Step-6 parenchyma reductions: the brain depth field EDT(brain), its
    masked 40th/60th percentiles (one shared sort), and the
    deep-white-matter / cortical-band t1 and flair means.  The ventricle
    mask needs connected-component labeling and stays on the host."""
    bd = _edt(brain)
    vals, perm = torch.sort(bd.reshape(-1))
    nb = brain.sum()
    thr40, thr60 = _masked_quantiles(vals, _cum(brain.reshape(-1)[perm]), nb, (0.40, 0.60))
    normal = brain & ~wt
    deep_wm = normal & (bd > thr60)
    cortical = normal & (bd < thr40)
    d_n, d_t1_mean, _ = _masked_mean_std(t1, deep_wm)
    c_n, c_t1_mean, _ = _masked_mean_std(t1, cortical)
    _, c_fl_mean, _ = _masked_mean_std(flair, cortical)
    return {
        "normal_count": normal.sum(),
        "brain_count": nb,
        "deep_count": d_n, "deep_t1_mean": d_t1_mean,
        "cortical_count": c_n, "cortical_t1_mean": c_t1_mean,
        "cortical_flair_mean": c_fl_mean,
    }


def compute_parenchyma_stats(
    t1: np.ndarray,
    flair: np.ndarray,
    brain_mask: np.ndarray,
    wt_mask: np.ndarray,
    dev: Optional[DeviceVolumes] = None,
    device=None,
) -> Dict[str, float]:
    """The step-6 parenchyma reductions."""
    if dev is not None:
        args = (dev.modality("t1"), dev.modality("flair"), dev.brain, dev.wt)
    else:
        device = resolve_device(device)
        args = (torch.from_numpy(np.asarray(t1, np.float32)).to(device),
                torch.from_numpy(np.asarray(flair, np.float32)).to(device),
                _mask_tensor(brain_mask, device), _mask_tensor(wt_mask, device))
    raw = _host(_parenchyma_kernel(*args))
    out = {k: float(v) for k, v in raw.items()}
    for k in ("normal_count", "brain_count", "deep_count", "cortical_count"):
        out[k] = int(raw[k])
    return out


def compute_quality_stats(
    modalities: Dict[str, np.ndarray], brain_mask: np.ndarray, device=None
) -> Dict[str, Dict[str, float]]:
    """Standalone step-5 quality reductions (shares the case-stats pass).

    Prefer :meth:`FeatureContext._dev_stats`, which computes regions,
    normal reference and quality in one device pass per case.
    """
    zeros = np.zeros(np.asarray(brain_mask).shape, np.int32)
    return compute_case_stats(modalities, zeros, brain_mask, device=device)["quality"]
