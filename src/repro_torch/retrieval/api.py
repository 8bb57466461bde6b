"""One Index API: declarative specs, a build factory, ``.npz`` persistence.

Counterpart of ``repro.retrieval.api`` for exact and IVF search:

* :class:`IndexSpec` / :class:`ShardSpec` — frozen, JSON round-trippable
  recipes, with the same JSON as ``repro``'s (backends are written with
  ``repro``'s names, ``jnp``/``pallas``, and read back as the port's).
* :func:`build_index` — registry → pipeline → scorer → IVF, for
  :class:`CompressedIndex`, the float :class:`DenseIndex` and
  :class:`IVFIndex` (``spec.ivf``), wrapped in a :class:`SegmentedIndex`
  for ``spec.mutable``.  Sharded specs raise ``NotImplementedError``
  naming the slice of the port that adds them.
* :func:`save_index` / :func:`load_index` / :func:`load_index_meta` — the
  ``.npz`` artifacts, read and written with numpy alone: ``__meta__`` is a
  0-d JSON string (no pickle), ``pipeline:{i}:{key}`` arrays hold each
  stage's state, ``storage`` the encoded documents (1-bit words as
  uint32), and an IVF index adds ``centroids``, ``lists`` and ``labels``
  (version 1).  A :class:`SegmentedIndex` adds its mutable layer —
  ``main_gids``, ``tombstones``, ``seg:{i}:storage|gids|labels`` and
  ``drift:sum``, with the allocator and drift scalars under
  ``__meta__["segmented"]`` (version 2).  ``repro.retrieval.api.
  load_index`` reads what :func:`save_index` writes, and
  :func:`load_index` reads ``repro``'s — the one way fitted state crosses
  between the packages.  Chunked (v3) directories wait for the storage
  slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.registry import (build_method, build_pipeline_from_spec,
                                       pipeline_spec)
from repro_torch.retrieval.index import (CompressedIndex, DenseIndex,
                                         storage_tensor)
from repro_torch.retrieval.ivf import IVFFlatIndex, IVFIndex
from repro_torch.retrieval.scorers import OneBitScorer
from repro_torch.retrieval.segments import SegmentedIndex, _Segment
from repro_torch.utils import (SHARD_SLICE, STORAGE_SLICE, DeviceLike,
                               backend_to_repro, check_backend,
                               resolve_device)

ARTIFACT_FORMAT = "repro-index"
#: immutable indexes write version 1, a SegmentedIndex version 2
ARTIFACT_VERSION = 1
SEGMENTED_NPZ_VERSION = 2

#: artifact kinds ``repro`` writes and the port cannot load yet
_LATER_KINDS = {"ShardedCompressedIndex": SHARD_SLICE,
                "ShardedIVFIndex": SHARD_SLICE}

#: stage-descriptor type: ``(transform class name, constructor kwargs)``
StageSpec = Tuple[str, dict]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Placement for sharded search — kept so specs round-trip; building a
    sharded index waits for slice 5 of the port."""

    doc_axis: Union[str, Tuple[str, ...]] = "model"
    query_axis: Optional[str] = None
    shards: Optional[int] = None
    replicas: int = 1

    def __post_init__(self):
        if self.shards is not None and int(self.shards) < 1:
            raise ValueError(f"shards must be ≥ 1, got {self.shards}")
        if int(self.replicas) < 1:
            raise ValueError(f"replicas must be ≥ 1, got {self.replicas}")

    def to_dict(self) -> dict:
        axis = (list(self.doc_axis) if isinstance(self.doc_axis, tuple)
                else self.doc_axis)
        return {"doc_axis": axis, "query_axis": self.query_axis,
                "shards": self.shards, "replicas": self.replicas}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardSpec":
        axis = d.get("doc_axis", "model")
        if isinstance(axis, list):
            axis = tuple(axis)
        return cls(doc_axis=axis, query_axis=d.get("query_axis"),
                   shards=d.get("shards"),
                   replicas=int(d.get("replicas", 1)))


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Declarative index recipe — everything :func:`build_index` needs.

    Exactly one of ``method`` (a registry name, or ``"dense"`` for a float
    index) / ``stages`` (explicit ``(class name, kwargs)`` descriptors)
    selects the compression recipe.  ``backend`` takes the port's names
    (auto/torch/kernel) or ``repro``'s (auto/jnp/pallas), stored as the
    port's.  The remaining fields mirror ``repro``'s spec so that JSON
    round-trips between the packages.
    """

    method: Optional[str] = None
    stages: Optional[Tuple[StageSpec, ...]] = None
    dim: int = 128
    sim: str = "ip"
    backend: str = "auto"
    pre: bool = True
    post: bool = True
    ivf: Optional[Tuple[int, int]] = None
    shard: Optional[ShardSpec] = None
    kmeans_iters: int = 15
    mutable: bool = False
    ivf_residual: bool = False
    kmeans_init: str = "random"
    balanced_lists: bool = False

    def __post_init__(self):
        if (self.method is None) == (self.stages is None):
            raise ValueError("IndexSpec needs exactly one of method= "
                             "(registry name) or stages= (descriptor list)")
        if self.stages is not None:
            object.__setattr__(
                self, "stages",
                tuple((str(n), _freeze(c if isinstance(c, dict)
                                       else _thaw(c)))
                      for n, c in self.stages))
        if self.ivf is not None:
            nlist, nprobe = self.ivf
            if nlist < 1 or nprobe < 1:
                raise ValueError(f"ivf=(nlist, nprobe) must be ≥ 1, "
                                 f"got {self.ivf}")
            object.__setattr__(self, "ivf", (int(nlist), int(nprobe)))
        if self.sim not in ("ip", "l2", "cos"):
            raise ValueError(f"unknown sim {self.sim!r}")
        object.__setattr__(self, "backend", check_backend(self.backend))
        if self.kmeans_init not in ("random", "++"):
            raise ValueError(f"unknown kmeans_init {self.kmeans_init!r}")
        if self.ivf_residual and self.ivf is None:
            raise ValueError("ivf_residual=True needs ivf=(nlist, nprobe)")

    def build_pipeline(self) -> Optional[CompressionPipeline]:
        """Unfitted pipeline for this recipe; ``None`` for a dense index."""
        if self.stages is not None:
            return build_pipeline_from_spec(
                [(n, _thaw(c)) for n, c in self.stages])
        if self.method == "dense":
            return None
        return build_method(self.method, self.dim, pre=self.pre,
                            post=self.post)

    def to_dict(self) -> dict:
        """``repro``-compatible dict (backend under ``repro``'s name)."""
        d = dataclasses.asdict(self)
        d["backend"] = backend_to_repro(self.backend)
        if self.shard is not None:
            d["shard"] = self.shard.to_dict()
        if self.stages is not None:
            d["stages"] = [[n, _thaw(c)] for n, c in self.stages]
        if self.ivf is not None:
            d["ivf"] = list(self.ivf)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        d = dict(d)
        if d.get("shard") is not None:
            d["shard"] = ShardSpec.from_dict(d["shard"])
        if d.get("stages") is not None:
            d["stages"] = tuple((n, c) for n, c in d["stages"])
        if d.get("ivf") is not None:
            d["ivf"] = tuple(d["ivf"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "IndexSpec":
        return cls.from_dict(json.loads(s))


# dicts freeze to a tagged tuple so that thawing is unambiguous (an empty
# dict and an empty list must round-trip to themselves, not each other)
_DICT_TAG = "__frozen_dict__"


def _freeze(obj: Any):
    """dict/list → nested hashable tuples (so specs stay hashable)."""
    if isinstance(obj, dict):
        return (_DICT_TAG,
                tuple(sorted((k, _freeze(v)) for k, v in obj.items())))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj: Any):
    """Inverse of :func:`_freeze`."""
    if (isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _DICT_TAG):
        return {k: _thaw(v) for k, v in obj[1]}
    if isinstance(obj, tuple):
        return [_thaw(v) for v in obj]
    return obj


def build_index(spec: IndexSpec, docs, queries_sample=None, *,
                rng: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """Compose registry → pipeline → scorer on ``device`` (``None``: CUDA).

    Returns an :class:`IVFIndex` for ``spec.ivf``, else a
    :class:`CompressedIndex`, or a :class:`DenseIndex` for
    ``method="dense"`` — wrapped in a :class:`SegmentedIndex` for
    ``spec.mutable``.  ``queries_sample`` feeds the two-population
    statistics.
    """
    if spec.shard is not None:
        raise NotImplementedError(f"sharded indexes wait for {SHARD_SLICE}")
    dev = resolve_device(device)
    pipeline = spec.build_pipeline()
    if spec.ivf is not None:
        nlist, nprobe = spec.ivf
        idx = IVFIndex.build(docs, queries_sample, pipeline, nlist=nlist,
                             nprobe=nprobe, sim=spec.sim,
                             backend=spec.backend,
                             kmeans_iters=spec.kmeans_iters,
                             residual=spec.ivf_residual,
                             kmeans_init=spec.kmeans_init,
                             balanced=spec.balanced_lists, rng=rng,
                             device=dev)
    elif pipeline is None:
        idx = DenseIndex(docs, sim=spec.sim, device=dev,
                         backend=spec.backend)
    else:
        idx = CompressedIndex.build(docs, queries_sample, pipeline,
                                    sim=spec.sim, backend=spec.backend,
                                    rng=rng, device=dev)
    idx.spec = spec
    if spec.mutable:
        idx = SegmentedIndex(idx, spec=spec)
    return idx


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _flatten_pipeline_sd(pipe_sd: dict, arrays: dict) -> list[bool]:
    """Stage states → ``pipeline:{i}:{key}`` arrays; returns fitted flags."""
    fitted = []
    for i, stage in enumerate(pipe_sd["stages"]):
        fitted.append(bool(stage["fitted"]))
        for k, v in stage["state"].items():
            arrays[f"pipeline:{i}:{k}"] = _numpy(v)
    return fitted


def _gather_pipeline_sd(data, types: Sequence[str],
                        fitted: Sequence[bool]) -> dict:
    per_stage: list[dict] = [{} for _ in types]
    for key in data.files:
        if not key.startswith("pipeline:"):
            continue
        _, i_str, k = key.split(":", 2)
        per_stage[int(i_str)][k] = data[key]
    return {"types": list(types),
            "stages": [{"name": t, "state": st, "fitted": bool(f)}
                       for t, st, f in zip(types, per_stage, fitted)]}


def _storage_numpy(storage, scorer) -> np.ndarray:
    """Encoded rows as ``repro`` stores them: 1-bit words as uint32."""
    arr = _numpy(storage)
    return arr.view(np.uint32) if isinstance(scorer, OneBitScorer) else arr


def save_index(index, path: str) -> None:
    """Write the ``.npz`` artifact (spec + state) — version 1 for an
    immutable index, version 2 for a :class:`SegmentedIndex` (its delta
    segments, tombstones, allocator and drift statistics too), readable by
    ``repro.retrieval.api.load_index`` and by :func:`load_index`."""
    if not isinstance(index, (SegmentedIndex, DenseIndex, CompressedIndex,
                              IVFIndex)):
        raise TypeError(f"don't know how to save {type(index).__name__}")
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {
        "format": ARTIFACT_FORMAT, "format_version": ARTIFACT_VERSION,
        "spec": index.spec.to_dict() if index.spec is not None else None,
    }
    if isinstance(index, SegmentedIndex):
        _collect_index(index.main, arrays, meta)
        meta["main_kind"] = meta["kind"]
        meta["kind"] = "SegmentedIndex"
        meta["format_version"] = SEGMENTED_NPZ_VERSION
        sd = index.state_dict()
        arrays["main_gids"] = np.asarray(sd["main_gids"], np.int32)
        arrays["tombstones"] = np.asarray(sd["tombstones"], np.int64)
        for i, seg in enumerate(sd["segments"]):
            arrays[f"seg:{i}:storage"] = _storage_numpy(seg["storage"],
                                                        index.scorer)
            arrays[f"seg:{i}:gids"] = np.asarray(seg["gids"], np.int32)
            if seg["labels"] is not None:
                arrays[f"seg:{i}:labels"] = np.asarray(seg["labels"],
                                                       np.int32)
        drift = sd["drift"]
        if drift["sum"] is not None:
            arrays["drift:sum"] = _numpy(drift["sum"])
        meta["segmented"] = {
            "next_gid": int(sd["next_gid"]),
            "n_segments": len(sd["segments"]),
            "n_live": len(index),
            "drift": {"n_added": int(drift["n_added"]),
                      "norm_sum": float(drift["norm_sum"])},
            "drift_threshold": index.drift_threshold,
            "max_delta_fraction": index.max_delta_fraction,
        }
    else:
        _collect_index(index, arrays, meta)
    arrays["__meta__"] = np.asarray(json.dumps(meta, sort_keys=True))
    np.savez(path, **arrays)


def _collect_index(index, arrays: dict, meta: dict) -> None:
    """Fill ``arrays``/``meta`` with one core index's state (the whole of
    a version-1 artifact, the main layer of a version-2 one)."""
    meta["kind"] = type(index).__name__
    if isinstance(index, DenseIndex):
        if len(index) == 0:
            raise ValueError("cannot save an empty index")
        arrays["storage"] = _numpy(index.docs)
        meta["stages"] = []
        meta["stage_fitted"] = []
        meta["index"] = {"sim": index.sim, "n_docs": len(index)}
    else:
        sd = index.state_dict()
        if sd["storage"] is None:
            raise ValueError("cannot save an empty index")
        meta["stages"] = pipeline_spec(index.pipeline)
        meta["stage_fitted"] = _flatten_pipeline_sd(sd["pipeline"], arrays)
        arrays["storage"] = _storage_numpy(sd["storage"], index.scorer)
        meta["index"] = {
            "sim": index.sim, "backend": backend_to_repro(index.backend),
            "n_docs": int(sd["n_docs"]), "dim": int(sd["dim"]),
            "version": int(sd["version"]),
            "scorer_extra": sd["scorer_extra"],
        }
        if isinstance(index, IVFIndex):
            arrays["centroids"] = _numpy(sd["centroids"])
            arrays["lists"] = _numpy(sd["lists"])
            if sd["labels"] is not None:
                arrays["labels"] = np.asarray(sd["labels"])
            meta["index"].update({
                "nlist": int(sd["nlist"]),
                "nlist_requested": int(sd["nlist_requested"]),
                "nprobe": int(sd["nprobe"]),
                "residual": bool(sd["residual"]),
                "kmeans_init": str(sd["kmeans_init"]),
                "balanced": bool(sd["balanced"]),
                "kmeans_iters": int(index.kmeans_iters),
            })


def _parse_meta(data, path: str) -> dict:
    """Validate and decode the artifact's JSON header."""
    if "__meta__" not in data.files:
        raise ValueError(f"{path} is not a {ARTIFACT_FORMAT} artifact "
                         "(no __meta__ entry)")
    meta = json.loads(data["__meta__"].item())
    if meta.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: unknown artifact format "
                         f"{meta.get('format')!r}")
    version = meta.get("format_version", 0)
    if version not in (ARTIFACT_VERSION, SEGMENTED_NPZ_VERSION):
        raise NotImplementedError(
            f"{path}: artifact version {version} is not readable yet — the "
            f"port reads versions {ARTIFACT_VERSION} and "
            f"{SEGMENTED_NPZ_VERSION} (.npz); chunked (v3) artifacts wait "
            f"for {STORAGE_SLICE}")
    return meta


def _check_npz(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: chunked (v3) artifact directories wait for "
            f"{STORAGE_SLICE}")


def load_index(path: str, *, backend: Optional[str] = None,
               expect: Optional[type] = None, device: DeviceLike = None):
    """Reconstruct an index from a version-1 or version-2 ``.npz``
    artifact on ``device`` (``None``: CUDA) — written by this package or
    by ``repro``.

    No corpus, no re-fit, no re-encode.  ``backend`` overrides the stored
    scorer backend; ``expect`` asserts the artifact kind.
    """
    dev = resolve_device(device)
    _check_npz(path)
    with np.load(path, allow_pickle=False) as data:
        meta = _parse_meta(data, path)
        kind = meta["kind"]
        if kind == "SegmentedIndex":
            main = _load_core(meta["main_kind"], meta, data, path, backend,
                              dev)
            if meta.get("spec") is not None:
                main.spec = IndexSpec.from_dict(meta["spec"])
            idx = _wrap_segmented(main, meta, data)
        else:
            idx = _load_core(kind, meta, data, path, backend, dev)
    if meta.get("spec") is not None:
        idx.spec = IndexSpec.from_dict(meta["spec"])
    if expect is not None and not isinstance(idx, expect):
        raise TypeError(f"{path} holds a {kind}, expected "
                        f"{expect.__name__} — use api.load_index for "
                        "kind-dispatching loads")
    return idx


def _load_core(kind: str, meta: dict, data, path: str,
               backend: Optional[str], device: torch.device):
    """One core (non-segmented) index from the artifact's arrays."""
    m = meta["index"]
    if kind == "DenseIndex":
        return DenseIndex(data["storage"], sim=m["sim"], device=device,
                          backend=backend or "auto")
    if kind == "CompressedIndex":
        pipeline = (build_pipeline_from_spec(meta["stages"])
                    if meta["stages"] else CompressionPipeline([]))
        idx = CompressedIndex(pipeline, sim=m["sim"],
                              backend=backend or m["backend"], device=device)
        return idx.load_state_dict({
            "pipeline": _gather_pipeline_sd(
                data, [n for n, _ in meta["stages"]], meta["stage_fitted"]),
            "storage": data["storage"],
            "scorer_extra": m.get("scorer_extra", {}),
            "n_docs": m["n_docs"], "dim": m["dim"],
            "version": m.get("version", 0)})
    if kind in ("IVFIndex", "IVFFlatIndex"):
        return _rebuild_ivf(meta, data, backend, kind, device)
    if kind in _LATER_KINDS:
        raise NotImplementedError(f"{path} holds a {kind}, which waits for "
                                  f"{_LATER_KINDS[kind]}")
    raise ValueError(f"{path}: unknown index kind {kind!r}")


def _wrap_segmented(main, meta: dict, data) -> SegmentedIndex:
    """Restore the mutable layer (segments, tombstones, allocator, drift)
    around a loaded main, as ``repro`` does."""
    seg_info = meta["segmented"]
    idx = SegmentedIndex(
        main, drift_threshold=seg_info.get("drift_threshold", 0.35),
        max_delta_fraction=seg_info.get("max_delta_fraction", 0.25))
    segments = []
    for i in range(seg_info["n_segments"]):
        lkey = f"seg:{i}:labels"
        labels = (np.asarray(data[lkey], np.int32)
                  if lkey in data.files else None)
        segments.append(_Segment(
            storage_tensor(data[f"seg:{i}:storage"], main.device),
            np.asarray(data[f"seg:{i}:gids"], np.int32), labels))
    next_gid = int(seg_info["next_gid"])
    tomb = np.zeros(next_gid, bool)
    tomb[np.asarray(data["tombstones"], np.int64)] = True
    drift_m = seg_info["drift"]
    return idx._restore(
        main_gids=np.asarray(data["main_gids"], np.int32), tomb=tomb,
        next_gid=next_gid, segments=segments,
        drift_sd={"n_added": drift_m["n_added"],
                  "norm_sum": drift_m["norm_sum"],
                  "sum": (data["drift:sum"]
                          if "drift:sum" in data.files else None)})


def _rebuild_ivf(meta: dict, data, backend: Optional[str], kind: str,
                 device: torch.device) -> IVFIndex:
    """The IVF index an artifact describes, with its state loaded."""
    m = meta["index"]
    if kind == "IVFFlatIndex":
        idx = IVFFlatIndex(nlist=m["nlist_requested"], nprobe=m["nprobe"],
                           sim=m["sim"], kmeans_iters=m["kmeans_iters"],
                           device=device)
    else:
        pipeline = (build_pipeline_from_spec(meta["stages"])
                    if meta["stages"] else CompressionPipeline([]))
        idx = IVFIndex(pipeline, nlist=m["nlist_requested"],
                       nprobe=m["nprobe"], sim=m["sim"],
                       backend=backend or m["backend"],
                       kmeans_iters=m["kmeans_iters"],
                       residual=bool(m.get("residual", False)),
                       kmeans_init=str(m.get("kmeans_init", "random")),
                       balanced=bool(m.get("balanced", False)),
                       device=device)
    idx.load_state_dict({
        "pipeline": _gather_pipeline_sd(data, [n for n, _ in meta["stages"]],
                                        meta["stage_fitted"]),
        "storage": data["storage"],
        "centroids": data["centroids"],
        "lists": data["lists"],
        "labels": data["labels"] if "labels" in data.files else None,
        "scorer_extra": m.get("scorer_extra", {}),
        "nlist": m["nlist"], "nlist_requested": m["nlist_requested"],
        "nprobe": m["nprobe"], "n_docs": m["n_docs"], "dim": m["dim"],
        "residual": bool(m.get("residual", False)),
        "kmeans_init": str(m.get("kmeans_init", "random")),
        "balanced": bool(m.get("balanced", False)),
        "version": m.get("version", 0)})
    return idx


def npz_member_nbytes(path: str) -> dict[str, int]:
    """{member name: array nbytes} for an ``.npz`` without reading data —
    only each member's ``.npy`` header is parsed."""
    out: dict[str, int] = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            name = info.filename
            if not name.endswith(".npy"):
                continue
            with zf.open(info) as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0
                        if version[0] == 1
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(f)
            out[name[:-len(".npy")]] = \
                int(np.prod(shape, dtype=np.int64)) * int(dtype.itemsize)
    return out


def _is_seg_storage(name: str) -> bool:
    return name.startswith("seg:") and name.endswith(":storage")


def load_index_meta(path: str) -> dict:
    """An artifact's identity header without materialising any arrays.

    The same fields and fingerprint as ``repro``'s ``load_index_meta`` for
    a version-1 or version-2 artifact: ``encoded_nbytes`` is the document
    storage (the main layer and any delta segments), ``aux_nbytes``
    everything else but the header.
    """
    _check_npz(path)
    with np.load(path, allow_pickle=False) as data:
        meta = _parse_meta(data, path)
    sizes = npz_member_nbytes(path)
    encoded = sizes.get("storage", 0) + sum(
        v for k, v in sizes.items() if _is_seg_storage(k))
    aux = sum(v for k, v in sizes.items() if k != "__meta__") - encoded
    m = meta.get("index") or {}
    seg = meta.get("segmented")
    return {
        "format_version": meta.get("format_version"),
        "artifact_version": meta.get("format_version"),
        "kind": meta["kind"],
        "spec": meta.get("spec"),
        "n_docs": seg["n_live"] if seg is not None else m.get("n_docs"),
        "dim": m.get("dim"),
        "index_version": m.get("version", 0),
        "mutable": seg is not None,
        "encoded_nbytes": int(encoded),
        "aux_nbytes": int(aux),
        "fingerprint": hashlib.sha256(
            json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16],
    }
