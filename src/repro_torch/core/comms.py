"""Communication cost: byte-exact accounting and upload compression
(``repro.core.comms`` ported).

* **Accounting.** Exact integer byte counts for what crosses the edge↔fog
  link in a round: parameter uploads (possibly compressed), the fog node's
  re-dispatch, per-upload metadata and, optionally, newly labeled samples.
  It is host arithmetic over leaf shapes and the run's participation
  record, the reference's ledger number for number.

* **Codecs**, applied to per-device parameter DELTAS (w_i − w_dispatched)
  before the stacked Eq. 1 reduce of ``EdgeEngine.run_rounds_fused``:

    - ``int8``: per-tensor stochastic rounding (scale = max|x|/127), one
      byte a value plus a float32 scale a tensor.  The uniform draw is an
      argument (``quantize_int8_stochastic(x, u)``): the reference's
      ``bernoulli(key, p)`` is ``uniform(key) < p``, so a caller that
      passes the reference's uniforms gets its codes bit for bit;
    - ``topk``: exactly ``ceil(fraction·n)`` entries a tensor, ties broken
      by position as ``lax.top_k`` breaks them;
    - ``compute_dtype="bfloat16"``: the values cross the wire rounded to
      bfloat16 (round to nearest even, as XLA's convert).

  The engine hands the wire payload itself to the fused-aggregation
  kernel: int8 codes with their scales, bfloat16 values, or float32
  values (``encode_rows``).

* **Error feedback**: the residual eᵢ ← (Δᵢ + eᵢ) − C(Δᵢ + eᵢ) rides in
  ``EngineState.residual`` across rounds and chained calls, updated only
  where the device uploaded.

* **Tiers** of a fog topology (``core.topology``): ``tier_report`` splits
  the ledger into the edge→fog link (every round) and the fog→cloud link
  (sync rounds only, one ``fog_compression``-coded delta a group), with
  the ``cross_tier_reduction`` headline.  ``fog_compression`` is ignored
  without a topology, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.sharding import rand_rows
from repro_torch.tree import tree_leaves, tree_map

COMPRESSIONS = ("none", "int8", "topk")
COMPUTE_DTYPES = ("float32", "bfloat16")

# Wire-format constants (bytes): float32 payload values, per-tensor flat
# indices at the narrowest sufficient width (``index_bytes``), one float32
# scale a quantized tensor, and three int32 scalars of metadata an upload
# (device id, round index, labeled count n_i).
VALUE_BYTES = 4
SCALE_BYTES = 4
METADATA_BYTES_PER_UPLOAD = 12
LABEL_BYTES = 4  # int32 class label riding with an uploaded sample

def index_bytes(n: int) -> int:
    """Width of one top-k flat index for an n-element tensor."""
    return 2 if n < 2**16 else 4


@dataclass(frozen=True)
class CommsConfig:
    """Communication policy of an experiment (the reference's fields and
    defaults).

    ``compression`` ``"none" | "int8" | "topk"`` (default ``"none"``, byte
    accounting only); ``topk_fraction`` in (0, 1] (default 0.05), the
    share of each tensor a top-k upload keeps (at least one entry);
    ``error_feedback`` (default True) carries the compression residual
    across rounds, updated on actual uploads only; ``upload_samples``
    (default False) also bills each newly labeled sample to the uplink;
    ``fog_compression`` is the fog→cloud codec of a fog topology (ignored
    without one); ``compute_dtype`` ``"float32" | "bfloat16"`` is the wire
    width of uploaded values (bfloat16 is itself lossy, so it runs the
    delta form and error feedback even at ``compression="none"``)."""

    compression: str = "none"
    topk_fraction: float = 0.05
    error_feedback: bool = True
    upload_samples: bool = False
    fog_compression: str = "none"
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"unknown compute_dtype {self.compute_dtype!r}: "
                f"use {' | '.join(COMPUTE_DTYPES)}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(
                f"unknown compression {self.compression!r}: "
                f"use {' | '.join(COMPRESSIONS)}")
        if self.fog_compression not in COMPRESSIONS:
            raise ValueError(
                f"unknown fog_compression {self.fog_compression!r}: "
                f"use {' | '.join(COMPRESSIONS)}")
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction}")

    @property
    def lossy(self) -> bool:
        """True when uploads go through a codec: a real compression or a
        bfloat16 wire."""
        return self.compression != "none" or self.compute_dtype != "float32"


# ------------------------------------------------------------- byte counts
def _numel(leaf) -> int:
    return int(np.prod(leaf.shape, dtype=np.int64))


def leaf_bytes(leaf) -> int:
    """Exact serialized size of one uncompressed tensor."""
    return _numel(leaf) * leaf.dtype.itemsize


def param_bytes(params) -> int:
    """Exact serialized size of one full (uncompressed) model."""
    return sum(leaf_bytes(l) for l in tree_leaves(params))


def topk_k(n: int, fraction: float) -> int:
    """Entries a top-k upload keeps for an n-element tensor (≥1, ≤n)."""
    return max(1, min(n, math.ceil(fraction * n)))


def value_bytes(cfg: Optional[CommsConfig]) -> int:
    """Wire width of one uploaded value: 2 under a bfloat16 wire, else 4."""
    if cfg is not None and cfg.compute_dtype == "bfloat16":
        return 2
    return VALUE_BYTES


def upload_bytes(cfg: Optional[CommsConfig], params) -> int:
    """Exact uplink bytes of ONE device's model or delta upload (metadata
    billed separately): the values at the wire width for ``none``; a byte
    a value plus a scale a tensor for ``int8``; index + value a kept entry
    for ``topk``."""
    leaves = tree_leaves(params)
    vb = value_bytes(cfg)
    if cfg is None or cfg.compression == "none":
        if vb != VALUE_BYTES:
            return sum(_numel(l) * vb for l in leaves)
        return sum(leaf_bytes(l) for l in leaves)
    if cfg.compression == "int8":
        return sum(_numel(l) + SCALE_BYTES for l in leaves)
    sizes = [_numel(l) for l in leaves]
    return sum(topk_k(n, cfg.topk_fraction) * (index_bytes(n) + vb)
               for n in sizes)


def compression_ratio(cfg: Optional[CommsConfig], params) -> float:
    """Uncompressed / compressed uplink payload size."""
    return param_bytes(params) / upload_bytes(cfg, params)


def sample_bytes(image_shape: Sequence[int], dtype=np.float32) -> int:
    """Wire size of one labeled sample upload (payload + int32 label)."""
    return (int(np.prod(image_shape, dtype=np.int64))
            * np.dtype(dtype).itemsize + LABEL_BYTES)


# ----------------------------------------------------------------- codecs
def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def quantize_int8_rows(x: torch.Tensor, u: torch.Tensor):
    """Stochastic int8 rounding of each row of ``x [D, ...]`` with its own
    scale: ``(q int8 [D, ...], scale float32 [D])``.  ``u`` holds one
    uniform draw in [0, 1) per value; a value rounds up where ``u`` is
    below its fractional part.  The maths is float32 (bfloat16 input is
    upcast); the scale floors ``max|x|`` at 1e-12, and a row holding any
    non-finite value gets a NaN scale (its codes are those of the row with
    the non-finite values set to 0)."""
    xr = _rows(x).float()
    finite = torch.isfinite(xr)
    safe = torch.where(finite, xr, torch.zeros((), device=xr.device))
    scale = torch.clamp(safe.abs().amax(dim=1), min=1e-12) / 127.0
    scaled = safe.div_(scale[:, None])
    lo = torch.floor(scaled)
    up = _rows(u) < scaled.sub_(lo)
    del scaled, safe
    q = lo.add_(up).clamp_(-127, 127).to(torch.int8).reshape(x.shape)
    scale = torch.where(finite.all(dim=1), scale,
                        torch.full_like(scale, float("nan")))
    return q, scale


def quantize_int8_stochastic(x: torch.Tensor, u: torch.Tensor):
    """One tensor, one scale: ``(q int8, scale float32 0-d)``; see
    ``quantize_int8_rows``.  Round trip: ``|x − q·scale| ≤ scale``."""
    q, scale = quantize_int8_rows(x.reshape(1, -1), u.reshape(1, -1))
    return q.reshape(x.shape), scale[0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q · scale`` in float32; ``scale`` 0-d (one tensor) or ``[D]`` (one
    per row of ``q [D, ...]``)."""
    s = scale.float()
    return q.float() * s.reshape(s.shape + (1,) * (q.dim() - s.dim()))


def topk_mask_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask (``x``'s dtype) keeping exactly ``k`` largest-magnitude
    entries of each row of ``x [D, ...]``, ties at the k-th magnitude to
    the lowest flat positions (``lax.top_k``'s order): everything above
    the k-th largest magnitude, then the first ``k − count_above`` entries
    equal to it, by a running count along the row."""
    a = _rows(x).abs()
    kth = torch.topk(a, k, dim=1, sorted=False).values.amin(dim=1,
                                                           keepdim=True)
    above = a > kth
    tied = a == kth
    del a
    room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    keep = above | (tied & (torch.cumsum(tied, dim=1, dtype=torch.int32)
                            <= room))
    return keep.to(x.dtype).reshape(x.shape)


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """``topk_mask_rows`` over one whole tensor (flat top-k)."""
    return topk_mask_rows(x.reshape(1, -1), k).reshape(x.shape)


def wire_cast(cfg: Optional[CommsConfig], x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through the wire dtype and back (identity on a float32
    wire)."""
    if cfg is not None and cfg.compute_dtype == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def encode_rows(cfg: CommsConfig, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
    """One stacked leaf ``x [D, ...]`` (one upload a row) as it crosses the
    wire: ``(payload, scales)``.  ``int8``: codes and float32 scales
    ``[D]``, from uniforms drawn from ``generator`` (at the global shape
    in a sharded fleet, ``launch.sharding.rand_rows``).  Otherwise the values
    (top-k masked for ``topk``) at the wire dtype, and ``scales`` None."""
    if cfg.compression == "int8":
        u = rand_rows(x.shape, generator=generator, device=x.device)
        return quantize_int8_rows(x, u)
    if cfg.compression == "topk":
        k = topk_k(_rows(x).shape[1], cfg.topk_fraction)
        x = x * topk_mask_rows(x, k)
    if cfg.compute_dtype == "bfloat16":
        return x.to(torch.bfloat16), None
    return x, None


def decode_rows(payload: torch.Tensor, scales) -> torch.Tensor:
    """What the fog node reconstructs from ``encode_rows``'s output, in
    float32."""
    if scales is not None:
        return dequantize_int8(payload, scales)
    return payload.float()


def compress_tree(cfg: CommsConfig, tree, generator=None):
    """The configured codec over ONE device's tree, leaf by leaf: returns
    the tree the fog node reconstructs (int8 leaves dequantized to
    float32, the others at their own dtype)."""
    if not cfg.lossy:
        return tree

    def one(leaf):
        payload, scales = encode_rows(cfg, leaf.unsqueeze(0), generator)
        if scales is not None:
            return dequantize_int8(payload, scales)[0]
        return payload[0].to(leaf.dtype)

    return tree_map(one, tree)


# Two runs of one deterministic codec on inputs that differ by at most eps
# (the card and the CPU, or this package and the reference) may leave
# residuals further apart than eps only where the codec jumps.  A check
# lets at most this share of a leaf's entries (at least one) lie beyond
# its bar.
SPLIT_SHARE = 1e-2


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step at ``|x|`` (8 significand bits): 2^(⌊log2|x|⌋−7);
    0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, torch.zeros_like(x, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                   e - 8))


def codec_splits(cfg: CommsConfig, x: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, eps) -> torch.Tensor:
    """Entries where two runs of the codec may split: one run's stacked
    codec input ``x [D, ...]`` lies within ``eps`` (a bound on the two
    runs' input difference: a float, or a tensor of one bound an entry) of
    a point where the codec jumps, and the two residuals ``a`` and ``b``
    are no further apart than that jump plus ``eps``.  Bool, shaped like
    ``x``.

    * top-k: ``|x|`` within ``eps`` plus the row's largest ``eps`` of its
      row's k-th largest magnitude (both may move), so one side may send
      the entry and the other not: one residual holds the whole value, the
      other 0 (jump ``|x|``);
    * bfloat16 wire: ``x`` within ``eps`` of a rounding tie, the midpoint
      of two neighbouring bfloat16 values, so the two sides may round to
      either (jump one bfloat16 step of ``x``).

    int8 draws its rounding at random (no two runs compare entry by entry)
    and a float32 wire has no jump: neither has a split."""
    x = x.float()
    eps = torch.as_tensor(eps, dtype=torch.float32).expand_as(x)
    gap = (a.float() - b.float()).abs()
    near = torch.zeros_like(x, dtype=torch.bool)
    jump = torch.zeros_like(x)
    ulp = _bf16_ulp(x)
    if cfg.compression == "topk":
        mag = _rows(x).abs()
        k = topk_k(mag.shape[1], cfg.topk_fraction)
        kth = torch.topk(mag, k, dim=1).values[:, -1:]
        e = _rows(eps)
        at = ((mag - kth).abs() <= e + e.amax(dim=1, keepdim=True)
              ).reshape(x.shape)
        near |= at
        jump = torch.where(at, x.abs(), jump)
    if cfg.compute_dtype == "bfloat16":
        rounded = x.to(torch.bfloat16).float()
        at = ((x - rounded).abs() - ulp / 2).abs() <= eps
        near |= at
        jump = jump + torch.where(near, ulp, torch.zeros_like(ulp))
    return near & (gap <= jump + eps)


def residual_gaps(cfg: CommsConfig, x: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, *, tol: float, eps):
    """Two runs' residual leaves ``a``, ``b`` (after the codec's input
    ``x`` of one run; ``eps`` as in ``codec_splits``): ``(max |a − b|,
    entries beyond tol, of those codec splits, entries beyond tol that are
    neither a split nor within eps)``.  Off a split the codec sends the
    same on both sides, so the residuals differ by the inputs' difference
    alone.  A check holds the last to 0 and the second to at most
    ``split_budget`` of the leaf."""
    gap = (a.float() - b.float()).abs()
    far = gap > tol
    split = far & codec_splits(cfg, x, a, b, eps)
    bad = far & ~split & (gap > torch.as_tensor(eps, dtype=torch.float32))
    return (float(gap.max()) if gap.numel() else 0.0, int(far.sum()),
            int(split.sum()), int(bad.sum()))


def split_budget(n: int) -> int:
    """The most entries of an ``n``-entry leaf that may lie beyond a
    check's tolerance (``SPLIT_SHARE``, at least one)."""
    return max(1, math.ceil(SPLIT_SHARE * n))


# --------------------------------------------------------- host reporting
def comms_report(cfg: Optional[CommsConfig], params_template, upload_mask, *,
                 agg_accs=None, n_labeled=None,
                 image_shape: Optional[Sequence[int]] = None,
                 start_labeled: int = 0) -> Dict[str, Any]:
    """Byte-exact per-round and cumulative comms telemetry of a multi-round
    run.

    ``upload_mask [rounds, D]`` is the participation record; ``agg_accs
    [rounds]`` pairs each round's aggregated accuracy with the cumulative
    uplink; ``n_labeled [rounds, D]`` cumulative counts drive the
    sample-upload bill under ``upload_samples`` (new labels = the diff,
    from ``start_labeled``).  Downlink counts one full model a device a
    round (the fog node re-dispatches to everyone)."""
    mask = np.asarray(upload_mask, np.float64)
    rounds, D = mask.shape
    pbytes = param_bytes(params_template)
    ubytes = upload_bytes(cfg, params_template)
    sbytes = sample_bytes(image_shape) if image_shape is not None else 0
    upload_samples = cfg is not None and cfg.upload_samples
    if upload_samples and (n_labeled is None or image_shape is None):
        raise ValueError(
            "upload_samples accounting needs n_labeled records and "
            "image_shape")

    per_round = []
    cum_up = 0
    cum_down = 0
    prev_labeled = None
    for t in range(rounds):
        uploads = int(mask[t].sum())
        model_up = uploads * ubytes
        meta_up = uploads * METADATA_BYTES_PER_UPLOAD
        new_labels = 0
        if n_labeled is not None:
            now = np.asarray(n_labeled, np.int64)[t]
            before = (np.full_like(now, start_labeled)
                      if prev_labeled is None else prev_labeled)
            new_labels = int((now - before).sum())
            prev_labeled = now
        sample_up = new_labels * sbytes if upload_samples else 0
        uplink = model_up + meta_up + sample_up
        downlink = D * pbytes
        cum_up += uplink
        cum_down += downlink
        per_round.append({
            "round": t,
            "uploads": uploads,
            "model_upload_bytes": model_up,
            "metadata_bytes": meta_up,
            "sample_upload_bytes": sample_up,
            "new_labels": new_labels,
            "uplink_bytes": uplink,
            "downlink_bytes": downlink,
            "cumulative_uplink_bytes": cum_up,
            "cumulative_uplink_mb": cum_up / 1e6,
        })

    report = {
        "compression": "none" if cfg is None else cfg.compression,
        "compute_dtype": "float32" if cfg is None else cfg.compute_dtype,
        "error_feedback": bool(cfg is not None and cfg.error_feedback
                               and cfg.lossy),
        "param_bytes": pbytes,
        "upload_bytes_per_device": ubytes,
        "metadata_bytes_per_upload": METADATA_BYTES_PER_UPLOAD,
        "compression_ratio": pbytes / ubytes,
        "rounds": per_round,
        "uplink_bytes_total": cum_up,
        "downlink_bytes_total": cum_down,
        "uplink_mb_total": cum_up / 1e6,
        "downlink_mb_total": cum_down / 1e6,
    }
    if agg_accs is not None:
        accs = np.asarray(agg_accs, np.float64)
        report["accuracy_vs_bytes"] = [
            {"round": t,
             "cumulative_uplink_bytes":
                 per_round[t]["cumulative_uplink_bytes"],
             "cumulative_uplink_mb": per_round[t]["cumulative_uplink_mb"],
             "accuracy": float(accs[t])}
            for t in range(rounds)]
    return report


STATIC_FIELDS = ("compression", "compute_dtype", "error_feedback",
                 "param_bytes", "upload_bytes_per_device",
                 "compression_ratio")


def attach_round_comms(reports, summary) -> None:
    """Give each round report, in place, its ``"comms"`` entry: the static
    codec facts plus that round's byte counts."""
    static = {k: summary[k] for k in STATIC_FIELDS}
    for rep, entry in zip(reports, summary["rounds"]):
        rep["comms"] = {**static, **entry}


def tier_report(cfg: Optional[CommsConfig], params_template, upload_mask,
                topology, *, start_round: int = 0) -> Dict[str, Any]:
    """Per-tier byte accounting of a fog-topology run.

    * edge→fog, every round: each uploading device ships its
      (edge-codec) delta plus metadata to its fog node; with an
      ``uplink_scale`` profile the report also prices these bytes in
      relative cost units (accounting only);
    * fog→cloud, only on sync rounds (``(t + 1) % local_steps == 0`` at
      absolute indices from ``start_round``): each of the G groups ships
      ONE delta coded with ``cfg.fog_compression``, plus metadata, and
      the cloud re-dispatches one model a group.

    ``flat_cross_tier_uplink_bytes`` is what the same participation
    record would have shipped straight to the cloud (edge codec);
    ``cross_tier_reduction`` divides it by the fog→cloud bytes (``inf``
    when nothing synced)."""
    from repro_torch.core.topology import sync_schedule

    mask = np.asarray(upload_mask, np.float64)
    rounds, D = mask.shape
    topology.validate_for(D)
    sync = np.asarray(sync_schedule(topology, rounds, start_round),
                      np.float64)
    G = topology.num_groups
    pbytes = param_bytes(params_template)
    ubytes = upload_bytes(cfg, params_template)
    fog_cfg = (CommsConfig(compression=cfg.fog_compression,
                           topk_fraction=cfg.topk_fraction)
               if cfg is not None else None)
    fbytes = upload_bytes(fog_cfg, params_template)
    scale = (np.asarray(topology.uplink_scale, np.float64)[topology.ids]
             if topology.uplink_scale is not None else None)

    per_round = []
    cum_edge = 0
    cum_cloud = 0
    for t in range(rounds):
        uploads = int(mask[t].sum())
        edge_up = uploads * (ubytes + METADATA_BYTES_PER_UPLOAD)
        synced = bool(sync[t] > 0)
        cloud_up = G * (fbytes + METADATA_BYTES_PER_UPLOAD) if synced else 0
        cum_edge += edge_up
        cum_cloud += cloud_up
        rec = {
            "round": t,
            "uploads": uploads,
            "fog_sync": synced,
            "edge_fog_uplink_bytes": edge_up,
            "fog_cloud_uplink_bytes": cloud_up,
            "fog_edge_downlink_bytes": D * pbytes,
            "cloud_fog_downlink_bytes": G * pbytes if synced else 0,
            "cumulative_edge_fog_bytes": cum_edge,
            "cumulative_fog_cloud_bytes": cum_cloud,
        }
        if scale is not None:
            rec["edge_fog_uplink_cost"] = float(
                (mask[t] * scale).sum()
                * (ubytes + METADATA_BYTES_PER_UPLOAD))
        per_round.append(rec)

    flat_cloud = int(mask.sum()) * (ubytes + METADATA_BYTES_PER_UPLOAD)
    return {
        "num_groups": G,
        "local_steps": int(topology.local_steps),
        "sync_rounds": int(sync.sum()),
        "edge_compression": "none" if cfg is None else cfg.compression,
        "fog_compression": "none" if cfg is None else cfg.fog_compression,
        "fog_upload_bytes_per_group": fbytes,
        "rounds": per_round,
        "edge_fog_bytes_total": cum_edge,
        "fog_cloud_bytes_total": cum_cloud,
        "flat_cross_tier_uplink_bytes": flat_cloud,
        "cross_tier_reduction": (flat_cloud / cum_cloud
                                 if cum_cloud else float("inf")),
    }


TIER_STATIC_FIELDS = ("num_groups", "local_steps", "edge_compression",
                      "fog_compression", "fog_upload_bytes_per_group")


def attach_round_tiers(reports, summary) -> None:
    """Give each round report, in place, its ``"tiers"`` entry: the static
    topology facts plus that round's per-tier byte counts."""
    static = {k: summary[k] for k in TIER_STATIC_FIELDS}
    for rep, entry in zip(reports, summary["rounds"]):
        rep["tiers"] = {**static, **entry}


def tier_telemetry(round_reports) -> Optional[Dict[str, Any]]:
    """Experiment-level per-tier telemetry from round reports that carry
    ``"tiers"`` entries: the static facts, the per-tier totals and
    ``cross_tier_reduction``, edge→fog bytes over fog→cloud bytes (``inf``
    when no round synced)."""
    rounds = [r for r in round_reports if "tiers" in r]
    if not rounds:
        return None
    last = rounds[-1]["tiers"]
    edge = last["cumulative_edge_fog_bytes"]
    cloud = last["cumulative_fog_cloud_bytes"]
    return {
        "num_groups": last["num_groups"],
        "local_steps": last["local_steps"],
        "edge_compression": last["edge_compression"],
        "fog_compression": last["fog_compression"],
        "sync_rounds": sum(1 for r in rounds if r["tiers"]["fog_sync"]),
        "edge_fog_bytes_total": edge,
        "fog_cloud_bytes_total": cloud,
        "cross_tier_reduction": (edge / cloud if cloud else float("inf")),
        "bytes_per_round": [
            {"round": r["round"],
             "edge_fog_uplink_bytes": r["tiers"]["edge_fog_uplink_bytes"],
             "fog_cloud_uplink_bytes": r["tiers"]["fog_cloud_uplink_bytes"],
             "fog_sync": r["tiers"]["fog_sync"]}
            for r in rounds],
    }


def experiment_telemetry(round_reports) -> Optional[Dict[str, Any]]:
    """Experiment-level comms telemetry from round reports that carry
    ``"comms"`` entries: bytes a round, totals, compression ratio and the
    accuracy-vs-bytes trajectory (the ``run_experiment`` contract)."""
    rounds = [r for r in round_reports if "comms" in r]
    if not rounds:
        return None
    last = rounds[-1]["comms"]
    return {
        "compression": last["compression"],
        "compute_dtype": last.get("compute_dtype", "float32"),
        "error_feedback": last["error_feedback"],
        "compression_ratio": last["compression_ratio"],
        "param_bytes": last["param_bytes"],
        "upload_bytes_per_device": last["upload_bytes_per_device"],
        "uplink_bytes_per_round": [r["comms"]["uplink_bytes"]
                                   for r in rounds],
        "downlink_bytes_per_round": [r["comms"]["downlink_bytes"]
                                     for r in rounds],
        "uplink_bytes_total": last["cumulative_uplink_bytes"],
        "uplink_mb_total": last["cumulative_uplink_mb"],
        "downlink_bytes_total": sum(r["comms"]["downlink_bytes"]
                                    for r in rounds),
        "accuracy_vs_bytes": [
            {"round": r["round"],
             "accuracy": r.get("aggregated_acc"),
             "cumulative_uplink_bytes":
                 r["comms"]["cumulative_uplink_bytes"],
             "cumulative_uplink_mb": r["comms"]["cumulative_uplink_mb"]}
            for r in rounds],
    }


def single_round_report(cfg: Optional[CommsConfig], params_template,
                        uploaded_ids: Sequence[int], num_devices: int, *,
                        new_labels: int = 0,
                        image_shape: Optional[Sequence[int]] = None
                        ) -> Dict[str, Any]:
    """One round's accounting for the host fog paths: the same flat dict
    ``attach_round_comms`` puts on each round of a multi-round run."""
    mask = np.zeros((1, num_devices), np.float32)
    mask[0, list(uploaded_ids)] = 1.0
    n_lab = None
    if new_labels:
        # the spread over devices does not change the totals
        n_lab = np.zeros((1, num_devices), np.int64)
        n_lab[0, 0] = new_labels
    summary = comms_report(cfg, params_template, mask, n_labeled=n_lab,
                           image_shape=image_shape)
    static = {k: summary[k] for k in STATIC_FIELDS}
    return {**static, **summary["rounds"][0]}
