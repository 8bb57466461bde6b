"""One Index API: declarative specs, a build factory, ``.npz`` persistence.

Counterpart of ``repro.retrieval.api`` for exact and IVF search:

* :class:`IndexSpec` / :class:`ShardSpec` — frozen, JSON round-trippable
  recipes, with the same JSON as ``repro``'s (backends are written with
  ``repro``'s names, ``jnp``/``pallas``, and read back as the port's).
* :func:`build_index` — registry → pipeline → scorer → IVF, for
  :class:`CompressedIndex`, the float :class:`DenseIndex` and
  :class:`IVFIndex` (``spec.ivf``), wrapped in a :class:`SegmentedIndex`
  for ``spec.mutable``; ``spec.shard`` wraps the result over the mesh
  its :class:`ShardSpec` describes (:class:`ShardedCompressedIndex`,
  :class:`ShardedIVFIndex`, under a ``SegmentedIndex`` too).
* :func:`save_index` / :func:`load_index` / :func:`load_index_meta` — the
  artifacts, read and written with numpy alone.  An ``.npz``: ``__meta__``
  is a 0-d JSON string (no pickle), ``pipeline:{i}:{key}`` arrays hold
  each stage's state, ``storage`` the encoded documents (1-bit words as
  uint32), and an IVF index adds ``centroids``, ``lists`` and ``labels``
  (version 1).  A :class:`SegmentedIndex` adds its mutable layer —
  ``main_gids``, ``tombstones``, ``seg:{i}:storage|gids|labels`` and
  ``drift:sum``, with the allocator and drift scalars under
  ``__meta__["segmented"]`` (version 2).  ``save_index(..., chunked=True)``
  writes an IVF index (plain or segmented) as a chunked v3 directory
  (:mod:`repro_torch.storage.format`: per-list chunks, the same meta in
  ``manifest.json``, the rest in ``aux.npz``), which ``load_index`` serves
  fully resident or from a byte-budgeted hot tier (``resident=``).
  ``repro.retrieval.api.load_index`` reads what :func:`save_index`
  writes, and :func:`load_index` reads ``repro``'s — the one way fitted
  state crosses between the packages.  A sharded index saves its
  unsharded state under kind ``Sharded*`` with its ``doc_axis`` /
  ``query_axis`` and the spec; ``load_index`` places it again, and
  ``load_index(path, shard=ShardSpec(...))`` serves a single-host
  artifact sharded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.core.registry import (build_method, build_pipeline_from_spec,
                                       pipeline_spec)
from repro_torch.retrieval.index import (CompressedIndex, DenseIndex,
                                         storage_tensor)
from repro_torch.retrieval.ivf import (IVFFlatIndex, IVFIndex,
                                       artifact_rows, build_padded_lists,
                                       port_rows)
from repro_torch.retrieval.scorers import OneBitScorer
from repro_torch.retrieval.segments import SegmentedIndex, _Segment
from repro_torch.retrieval.sharded import (ShardedCompressedIndex,
                                           ShardedIVFIndex)
from repro_torch.storage.format import (ArtifactError, ChunkReader,
                                        ChunkWriter, is_chunked_artifact,
                                        npz_member_nbytes)
from repro_torch.storage.store import MmapStore
from repro_torch.utils import (DeviceLike, backend_to_repro, check_backend,
                               resolve_device)

ARTIFACT_FORMAT = "repro-index"
#: the newest version read: an immutable .npz is version 1, a
#: SegmentedIndex's .npz version 2, a chunked directory version 3
ARTIFACT_VERSION = 3
NPZ_VERSION = 1
SEGMENTED_NPZ_VERSION = 2

#: ``resident="auto"`` loads fully resident up to this encoded size, and
#: tiers (MmapStore at this budget) beyond it
AUTO_RESIDENT_BYTES = 1 << 30

#: the sharded kinds, as artifacts name them
_SHARDED_KINDS = ("ShardedCompressedIndex", "ShardedIVFIndex")

#: stage-descriptor type: ``(transform class name, constructor kwargs)``
StageSpec = Tuple[str, dict]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Placement for the sharded indexes — the *one* placement surface.

    ``doc_axis`` names the mesh axis (or axes) the document storage is
    split over; ``shards`` is how many shards that axis gets (``None``:
    every device the replica count leaves available, one on a named
    device).  ``replicas`` adds read-scaling replica groups: storage is
    replicated over the query axis while queries are split over it.
    ``query_axis`` names that axis (``"data"`` whenever ``replicas > 1``).
    The mesh is derived from the spec (:meth:`build_mesh`, the device rule
    of :mod:`repro_torch.parallel.placement`); JSON as ``repro``'s.
    """

    doc_axis: Union[str, Tuple[str, ...]] = "model"
    query_axis: Optional[str] = None
    shards: Optional[int] = None
    replicas: int = 1

    def __post_init__(self):
        if self.shards is not None and int(self.shards) < 1:
            raise ValueError(f"shards must be ≥ 1, got {self.shards}")
        if int(self.replicas) < 1:
            raise ValueError(f"replicas must be ≥ 1, got {self.replicas}")

    @property
    def effective_query_axis(self) -> Optional[str]:
        """The query/replica mesh axis, or ``None`` for replicated queries."""
        if self.query_axis is not None:
            return self.query_axis
        return "data" if self.replicas > 1 else None

    def build_mesh(self, devices=None):
        """The mesh this spec describes: ``devices`` ``None`` (every CUDA
        device), one named device holding every shard, or a list."""
        from repro_torch.parallel.placement import mesh_from_spec
        return mesh_from_spec(self, devices=devices)

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
        if self.ivf_residual:
            if self.ivf is None:
                raise ValueError("ivf_residual=True needs ivf=(nlist, "
                                 "nprobe)")
            if self.shard is not None or self.mutable:
                raise ValueError("ivf_residual=True is single-host / "
                                 "immutable only (the residual re-encode "
                                 "is incompatible with shared-storage "
                                 "promotion and delta layers)")

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


def _lead_device(mesh) -> torch.device:
    """The mesh's first device: where a sharded index keeps its unsharded
    state, routes and merges."""
    return mesh.devices.flat[0]


def _resolve_mesh(shard: ShardSpec, mesh, where: str, device: DeviceLike):
    """Spec-derived mesh on ``device``, honouring (but deprecating) an
    explicit one."""
    if mesh is not None:
        warnings.warn(
            f"{where}(mesh=...) is deprecated: placement now comes from "
            "the ShardSpec (shards=/replicas=) and the mesh is derived "
            "from it — the explicit mesh is still honoured for now",
            DeprecationWarning, stacklevel=3)
        return mesh
    return shard.build_mesh(device)


def build_index(spec: IndexSpec, docs, queries_sample=None, *, mesh=None,
                rng: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """Compose registry → pipeline → scorer → IVF → sharding on ``device``.

    Returns an :class:`IVFIndex` for ``spec.ivf``, else a
    :class:`CompressedIndex`, or a :class:`DenseIndex` for
    ``method="dense"``; with ``spec.shard`` a :class:`ShardedIVFIndex` or
    :class:`ShardedCompressedIndex` over the mesh the spec describes on
    ``device`` (``None``: every CUDA device; a named device holds every
    shard) — ``mesh=`` still works but is deprecated.  Wrapped in a
    :class:`SegmentedIndex` for ``spec.mutable``.  ``queries_sample``
    feeds the two-population statistics.
    """
    pipeline = spec.build_pipeline()
    if spec.shard is not None:
        shard = spec.shard
        mesh = _resolve_mesh(shard, mesh, "build_index", device)
        pipe = pipeline if pipeline is not None else CompressionPipeline([])
        if spec.ivf is not None:
            nlist, nprobe = spec.ivf
            idx = ShardedIVFIndex.build(
                docs, queries_sample, pipe, mesh=mesh, nlist=nlist,
                nprobe=nprobe, sim=spec.sim, backend=spec.backend,
                kmeans_iters=spec.kmeans_iters, doc_axis=shard.doc_axis,
                query_axis=shard.effective_query_axis, rng=rng)
        else:
            idx = ShardedCompressedIndex.build(
                docs, queries_sample, pipe, mesh, sim=spec.sim,
                backend=spec.backend, doc_axis=shard.doc_axis,
                query_axis=shard.effective_query_axis, rng=rng)
    elif spec.ivf is not None:
        dev = resolve_device(device)
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
        idx = DenseIndex(docs, sim=spec.sim, device=resolve_device(device),
                         backend=spec.backend)
    else:
        idx = CompressedIndex.build(docs, queries_sample, pipeline,
                                    sim=spec.sim, backend=spec.backend,
                                    rng=rng, device=resolve_device(device))
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


def save_index(index, path: str, *, chunked: bool = False) -> None:
    """Write the ``.npz`` artifact (spec + state) — version 1 for an
    immutable index, version 2 for a :class:`SegmentedIndex` (its delta
    segments, tombstones, allocator and drift statistics too), readable by
    ``repro.retrieval.api.load_index`` and by :func:`load_index`.

    ``chunked=True`` writes the v3 tiered layout instead: a directory with
    per-inverted-list chunks streamed to disk list by list, which
    :func:`load_index` can serve with a byte-budgeted hot tier
    (``resident=``).  IVF indexes only (plain or under a
    :class:`SegmentedIndex`); a store-backed index *must* be saved chunked
    — it has no resident storage to pack into an ``.npz``.
    """
    if not isinstance(index, (SegmentedIndex, DenseIndex, CompressedIndex,
                              IVFIndex, ShardedCompressedIndex,
                              ShardedIVFIndex)):
        raise TypeError(f"don't know how to save {type(index).__name__}")
    if chunked:
        return _save_index_chunked(index, path)
    main = index.main if isinstance(index, SegmentedIndex) else index
    if getattr(main, "store", None) is not None:
        raise ValueError(
            "store-backed (tiered) index cannot be packed into a .npz — "
            "save_index(..., chunked=True) streams it to a v3 artifact, "
            "or reload with resident='all' first")
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {
        "format": ARTIFACT_FORMAT, "format_version": NPZ_VERSION,
        "spec": index.spec.to_dict() if index.spec is not None else None,
    }
    if isinstance(index, SegmentedIndex):
        _collect_index(index.main, arrays, meta)
        _collect_mutable(index, arrays, meta)
        meta["format_version"] = SEGMENTED_NPZ_VERSION
    else:
        _collect_index(index, arrays, meta)
    arrays["__meta__"] = np.asarray(json.dumps(meta, sort_keys=True))
    np.savez(path, **arrays)


def _collect_mutable(seg: SegmentedIndex, arrays: dict, meta: dict) -> None:
    """A SegmentedIndex's mutable layer — segments, tombstones, allocator,
    drift — into ``arrays``/``meta`` (a v2 ``.npz`` or a v3 ``aux.npz``
    alike), after its main's own entries."""
    meta["main_kind"] = meta["kind"]
    meta["kind"] = "SegmentedIndex"
    st = seg._state
    arrays["main_gids"] = np.asarray(seg._main_gids, np.int32)
    arrays["tombstones"] = np.flatnonzero(st.tomb).astype(np.int64)
    for i, s in enumerate(st.segments):
        arrays[f"seg:{i}:storage"] = _storage_numpy(s.storage, seg.scorer)
        arrays[f"seg:{i}:gids"] = np.asarray(s.gids, np.int32)
        if s.labels is not None:
            arrays[f"seg:{i}:labels"] = np.asarray(s.labels, np.int32)
    drift = seg.drift.state_dict()
    if drift["sum"] is not None:
        arrays["drift:sum"] = _numpy(drift["sum"])
    meta["segmented"] = {
        "next_gid": int(st.next_gid),
        "n_segments": len(st.segments),
        "n_live": len(seg),
        "drift": {"n_added": int(drift["n_added"]),
                  "norm_sum": float(drift["norm_sum"])},
        "drift_threshold": seg.drift_threshold,
        "max_delta_fraction": seg.max_delta_fraction,
    }


def _chunked_header(ivf: IVFIndex, seg: Optional[SegmentedIndex],
                    spec) -> tuple[dict, dict]:
    """(meta, aux arrays) of a v3 artifact — the header fields a v2
    ``.npz`` writes, as ``repro``'s ``_chunked_header`` lays them out."""
    aux: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {
        "format": ARTIFACT_FORMAT, "format_version": ARTIFACT_VERSION,
        "spec": spec.to_dict() if spec is not None else None,
        "kind": type(ivf).__name__,
    }
    meta["stages"] = pipeline_spec(ivf.pipeline)
    meta["stage_fitted"] = _flatten_pipeline_sd(ivf.pipeline.state_dict(),
                                                aux)
    aux["centroids"] = _numpy(ivf.centroids)
    meta["index"] = {
        "sim": ivf.sim, "backend": backend_to_repro(ivf.backend),
        "n_docs": int(ivf._n_docs), "dim": int(ivf._dim),
        "version": int(ivf._version),
        "scorer_extra": ivf.scorer.extra_state(),
        "nlist": int(ivf.nlist),
        "nlist_requested": int(ivf._nlist_requested),
        "nprobe": int(ivf.nprobe),
        "residual": bool(ivf.residual),
        "kmeans_init": str(ivf.kmeans_init),
        "balanced": bool(ivf.balanced),
        "kmeans_iters": int(ivf.kmeans_iters),
    }
    if seg is not None:
        _collect_mutable(seg, aux, meta)
    return meta, aux


def _write_chunked(path: str, meta: dict, aux: dict, rows_iter, *,
                   storage_dtype, storage_width: int, n_lists: int) -> dict:
    """Stream ``(rows, ids)`` per list into a v3 artifact directory; rows
    are written in the artifact's dtype (1-bit words as uint32)."""
    writer = ChunkWriter(path, storage_dtype=storage_dtype,
                         storage_width=storage_width)
    n = 0
    for rows, ids in rows_iter:
        writer.write_list(artifact_rows(np.asarray(rows)), ids)
        n += 1
    if n != n_lists:
        raise ValueError(f"chunk stream yielded {n} lists, expected "
                         f"{n_lists}")
    return writer.finish(meta, aux)


def _rows_layout(ivf: IVFIndex) -> tuple[np.dtype, int]:
    """The artifact dtype and width of an IVF index's rows."""
    if ivf.store is not None:
        return ivf.store.storage_dtype, ivf.store.storage_width
    return (artifact_rows(_numpy(ivf.storage[:0])).dtype,
            int(ivf.storage.shape[1]))


def _save_index_chunked(index, path: str) -> None:
    seg = index if isinstance(index, SegmentedIndex) else None
    ivf = seg.main if seg is not None else index
    if not isinstance(ivf, IVFIndex):
        raise TypeError(
            "chunked (v3) artifacts lay out per-IVF-list storage — "
            f"{type(index).__name__} has no inverted lists; save it "
            "without chunked=True")
    if ivf.centroids is None or (ivf.storage is None and ivf.store is None):
        raise ValueError("cannot save an empty index")
    meta, aux = _chunked_header(ivf, seg, index.spec)
    dtype, width = _rows_layout(ivf)
    _write_chunked(path, meta, aux,
                   ((rows, ids) for _, rows, ids in ivf.iter_lists()),
                   storage_dtype=dtype, storage_width=width,
                   n_lists=ivf.nlist)


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
        core = index.ivf if isinstance(index, ShardedIVFIndex) else index
        sd = core.state_dict()
        if sd["storage"] is None:
            raise ValueError("cannot save an empty index")
        meta["stages"] = pipeline_spec(core.pipeline)
        meta["stage_fitted"] = _flatten_pipeline_sd(sd["pipeline"], arrays)
        arrays["storage"] = _storage_numpy(sd["storage"], core.scorer)
        meta["index"] = {
            "sim": core.sim, "backend": backend_to_repro(core.backend),
            "n_docs": int(sd["n_docs"]), "dim": int(sd["dim"]),
            "version": int(sd.get("version", 0)),
            "scorer_extra": sd["scorer_extra"],
        }
        if isinstance(index, (ShardedCompressedIndex, ShardedIVFIndex)):
            meta["index"]["doc_axis"] = list(index.doc_axes)
            meta["index"]["query_axis"] = index.query_axis
        if isinstance(core, IVFIndex):
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
                "kmeans_iters": int(core.kmeans_iters),
            })


def _validate_header(meta: dict, path: str) -> None:
    if meta.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: unknown artifact format "
                         f"{meta.get('format')!r}")
    if meta.get("format_version", 0) > ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact version {meta['format_version']} is newer "
            f"than this build ({ARTIFACT_VERSION})")


def _parse_meta(data, path: str) -> dict:
    """Validate and decode the artifact's JSON header."""
    if "__meta__" not in data.files:
        raise ValueError(f"{path} is not a {ARTIFACT_FORMAT} artifact "
                         "(no __meta__ entry)")
    meta = json.loads(data["__meta__"].item())
    _validate_header(meta, path)
    return meta


def _resolve_resident(resident: Union[str, int],
                      encoded_nbytes: int) -> Optional[int]:
    """``None`` = load fully resident; an int = MmapStore byte budget."""
    if isinstance(resident, str):
        if resident == "all":
            return None
        if resident == "auto":
            return (None if encoded_nbytes <= AUTO_RESIDENT_BYTES
                    else AUTO_RESIDENT_BYTES)
        raise ValueError(f"resident must be 'auto', 'all', or a byte "
                         f"budget, got {resident!r}")
    if isinstance(resident, bool) or int(resident) < 0:
        raise ValueError(f"resident byte budget must be ≥ 0, "
                         f"got {resident!r}")
    return int(resident)


def load_index(path: str, *, backend: Optional[str] = None,
               expect: Optional[type] = None, device: DeviceLike = None,
               resident: Union[str, int] = "auto",
               shard: Optional[ShardSpec] = None, mesh=None):
    """Reconstruct an index from an artifact on ``device`` (``None``:
    CUDA) — written by this package or by ``repro``.

    No corpus, no re-fit, no re-encode.  ``backend`` overrides the stored
    scorer backend; ``expect`` asserts the artifact kind.  ``resident``
    governs a chunked (v3) artifact's residency, as in ``repro``:

    * ``"all"`` — every inverted list materialised into row-major storage
      and rebuilt lists, bit for bit what the ``.npz`` load gives (fused
      kernel capable, no store);
    * an ``int`` — byte budget of an :class:`~repro_torch.storage.store.
      MmapStore` hot tier: the encoded lists stay on disk behind an
      ``np.memmap`` and searches stream through the store, with the same
      bits at any budget;
    * ``"auto"`` (default) — ``"all"`` when the encoded storage fits
      ``AUTO_RESIDENT_BYTES``, else a tier at that budget.

    ``.npz`` (v1/v2) artifacts ignore ``resident``; under ``shard=`` it is
    forced to ``"all"`` (per-shard storage must be resident to be placed).

    Sharded artifacts derive their mesh from the embedded spec on
    ``device`` (the device rule of :mod:`repro_torch.parallel.placement`:
    ``None`` every CUDA device, a named device holding every shard);
    ``shard=ShardSpec(...)`` overrides it, and wraps a *single-host*
    artifact (``.npz`` or chunked) over the mesh it describes, so one
    artifact serves both deployments.  ``mesh=`` is still honoured but
    deprecated.
    """
    if mesh is not None:
        warnings.warn(
            "load_index(mesh=...) is deprecated: sharded artifacts derive "
            "their mesh from the embedded ShardSpec, and single-host "
            "artifacts shard with shard=ShardSpec(...) — the explicit "
            "mesh is still honoured for now", DeprecationWarning,
            stacklevel=2)
    if is_chunked_artifact(path):
        if shard is None and mesh is None:
            return _load_index_chunked(path, backend=backend, expect=expect,
                                       resident=resident,
                                       device=resolve_device(device))
        # sharding needs resident per-shard rows — materialise, then wrap
        if shard is None:
            shard = ShardSpec(doc_axis=mesh.axis_names[-1])
        if mesh is None:
            mesh = shard.build_mesh(device)
        idx = _load_index_chunked(path, backend=backend, expect=None,
                                  resident="all",
                                  device=_lead_device(mesh))
        idx = _shard_loaded(idx, shard, mesh)
        if expect is not None and not isinstance(idx, expect):
            raise TypeError(f"{path} loaded as {type(idx).__name__}, "
                            f"expected {expect.__name__}")
        return idx
    with np.load(path, allow_pickle=False) as data:
        meta = _parse_meta(data, path)
        kind = meta["kind"]
        core_kind = meta.get("main_kind", kind)
        if core_kind in _SHARDED_KINDS or shard is not None:
            if mesh is None:
                sh = (_artifact_shard(meta, shard)
                      if core_kind in _SHARDED_KINDS else shard)
                mesh = sh.build_mesh(device)
            dev = _lead_device(mesh)
        else:
            dev = resolve_device(device)
        main = _load_core(core_kind, meta, data, path, backend, dev,
                          mesh=mesh, shard=shard)
        if kind == "SegmentedIndex":
            if meta.get("spec") is not None:
                main.spec = IndexSpec.from_dict(meta["spec"])
            idx = _wrap_segmented(main, meta, data)
        else:
            idx = main
    if meta.get("spec") is not None:
        idx.spec = IndexSpec.from_dict(meta["spec"])
    if shard is not None and not _is_sharded(idx):
        idx = _shard_loaded(idx, shard, mesh)
    _check_kind(idx, expect, path, kind)
    return idx


def _check_kind(idx, expect: Optional[type], path: str, kind: str) -> None:
    if expect is not None and not isinstance(idx, expect):
        raise TypeError(f"{path} holds a {kind}, expected "
                        f"{expect.__name__} — use api.load_index for "
                        "kind-dispatching loads")


def _load_index_chunked(path: str, *, backend: Optional[str],
                        expect: Optional[type], resident: Union[str, int],
                        device: torch.device):
    """Load a v3 chunked artifact at the requested residency."""
    reader = ChunkReader(path)
    meta = reader.meta
    _validate_header(meta, path)
    kind = meta["kind"]
    main_kind = meta.get("main_kind", kind)
    if main_kind not in ("IVFIndex", "IVFFlatIndex"):
        raise ValueError(f"{path}: chunked artifact holds unsupported "
                         f"kind {main_kind!r}")
    m = meta["index"]
    budget = _resolve_resident(resident, reader.encoded_nbytes)
    ivf = _make_ivf(meta, backend, main_kind, device)
    with reader.load_aux() as aux:
        sd = _ivf_sd_common(meta, aux)
        if budget is None:
            # fully resident: scatter the chunks back into row-major
            # storage — bit for bit the .npz load (lists rebuilt from the
            # same labels), fused-kernel capable, no store attached
            storage = np.empty((m["n_docs"], reader.storage_width),
                               reader.storage_dtype)
            labels = np.empty(m["n_docs"], np.int32)
            filled = 0
            for lid, rows, ids in reader.iter_lists():
                storage[ids] = rows
                labels[ids] = lid
                filled += int(ids.shape[0])
            if filled != m["n_docs"]:
                raise ArtifactError(
                    f"{path}: chunks hold {filled} rows, header says "
                    f"{m['n_docs']}")
            reader.close()
            ivf.load_state_dict({
                **sd, "storage": port_rows(storage),
                "lists": build_padded_lists(labels, int(m["nlist"])),
                "labels": labels})
        else:
            ivf.load_state_dict({**sd, "storage": None, "lists": None,
                                 "labels": None})
            ivf.store = MmapStore(reader, budget)
        if meta.get("spec") is not None:
            ivf.spec = IndexSpec.from_dict(meta["spec"])
        if kind == "SegmentedIndex":
            idx = _wrap_segmented(ivf, meta, aux)
            if ivf.store is not None:
                # delta rows route to these lists on every probe that can
                # reach them — keep the write-hot head unevictable
                for s in idx._state.segments:
                    if s.labels is not None:
                        ivf.store.pin(np.unique(s.labels).tolist())
        else:
            idx = ivf
    if meta.get("spec") is not None:
        idx.spec = IndexSpec.from_dict(meta["spec"])
    _check_kind(idx, expect, path, kind)
    return idx


def _load_core(kind: str, meta: dict, data, path: str,
               backend: Optional[str], device: torch.device, *, mesh=None,
               shard: Optional[ShardSpec] = None):
    """One core (non-segmented) index from the artifact's arrays; a
    sharded kind is placed over ``mesh`` (whose lead device is
    ``device``)."""
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
    if kind == "ShardedCompressedIndex":
        sh = _artifact_shard(meta, shard)
        pipeline = (build_pipeline_from_spec(meta["stages"])
                    if meta["stages"] else CompressionPipeline([]))
        idx = ShardedCompressedIndex(
            pipeline, mesh, sim=m["sim"], backend=backend or m["backend"],
            doc_axis=sh.doc_axis, query_axis=sh.effective_query_axis)
        return idx.load_state_dict({
            "pipeline": _gather_pipeline_sd(
                data, [n for n, _ in meta["stages"]], meta["stage_fitted"]),
            "storage": data["storage"],
            "scorer_extra": m.get("scorer_extra", {}),
            "n_docs": m["n_docs"], "dim": m["dim"]})
    if kind == "ShardedIVFIndex":
        sh = _artifact_shard(meta, shard)
        ivf = _rebuild_ivf(meta, data, backend, "IVFIndex", device)
        return ShardedIVFIndex(ivf, mesh, doc_axis=sh.doc_axis,
                               query_axis=sh.effective_query_axis)
    raise ValueError(f"{path}: unknown index kind {kind!r}")


# ---------------------------------------------------------------------------
# sharding a loaded single-host index
# ---------------------------------------------------------------------------


def _is_sharded(idx) -> bool:
    if isinstance(idx, (ShardedCompressedIndex, ShardedIVFIndex)):
        return True
    return isinstance(idx, SegmentedIndex) and isinstance(
        idx.main, (ShardedCompressedIndex, ShardedIVFIndex))


def _spec_with_shard(spec: Optional[IndexSpec],
                     shard: ShardSpec) -> Optional[IndexSpec]:
    if spec is None:
        return None
    return dataclasses.replace(spec, shard=shard)


def _derived_shard(m: dict) -> ShardSpec:
    """ShardSpec equivalent to what a pre-spec sharded artifact stored."""
    axis = m.get("doc_axis", "model")
    if isinstance(axis, list):
        axis = tuple(axis)
    if isinstance(axis, tuple) and len(axis) == 1:
        axis = axis[0]
    return ShardSpec(doc_axis=axis, query_axis=m.get("query_axis"))


def _artifact_shard(meta: dict, shard: Optional[ShardSpec]) -> ShardSpec:
    """The placement a sharded artifact loads with: an explicit ``shard=``
    wins, then the spec embedded in the artifact, then a spec derived from
    the stored axis names (old artifacts)."""
    if shard is not None:
        return shard
    sp = meta.get("spec") or {}
    if sp.get("shard"):
        return ShardSpec.from_dict(sp["shard"])
    return _derived_shard(meta["index"])


def _shard_loaded(idx, shard: ShardSpec, mesh=None):
    """Wrap a loaded single-host index over ``mesh`` (default: the mesh
    ``shard`` describes over the CUDA devices).

    The one seam that lets a single-host artifact (``.npz`` or chunked,
    mutable or not) serve sharded: the main fans out over the doc shards,
    a SegmentedIndex's delta layer stays on the lead device, and rankings
    stay bit-identical to the single-host index.
    """
    if mesh is None:
        mesh = shard.build_mesh()
    if isinstance(idx, SegmentedIndex):
        st = idx._state
        main = _shard_loaded(idx.main, shard, mesh)
        out = SegmentedIndex(main, spec=_spec_with_shard(idx.spec, shard),
                             drift_threshold=idx.drift_threshold,
                             max_delta_fraction=idx.max_delta_fraction)
        return out._restore(main_gids=idx._main_gids, tomb=st.tomb,
                            next_gid=st.next_gid, segments=st.segments,
                            drift_sd=idx.drift.state_dict())
    if isinstance(idx, IVFIndex):
        if idx.store is not None:
            raise ValueError(
                "shard= needs a fully resident index — store-backed "
                "storage cannot be placed; load with resident='all'")
        out = ShardedIVFIndex(idx, mesh, doc_axis=shard.doc_axis,
                              query_axis=shard.effective_query_axis)
    elif isinstance(idx, CompressedIndex):
        out = ShardedCompressedIndex.from_index(
            idx, mesh, doc_axis=shard.doc_axis,
            query_axis=shard.effective_query_axis)
    else:
        raise TypeError(
            f"shard= cannot wrap a {type(idx).__name__} — sharding covers "
            "CompressedIndex, IVFIndex, and their mutable wrappers")
    out.spec = _spec_with_shard(idx.spec, shard)
    return out


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


def _make_ivf(meta: dict, backend: Optional[str], kind: str,
              device: torch.device) -> IVFIndex:
    """The (unloaded) IVF shell an artifact header describes."""
    m = meta["index"]
    if kind == "IVFFlatIndex":
        return IVFFlatIndex(nlist=m["nlist_requested"], nprobe=m["nprobe"],
                            sim=m["sim"], kmeans_iters=m["kmeans_iters"],
                            device=device)
    pipeline = (build_pipeline_from_spec(meta["stages"])
                if meta["stages"] else CompressionPipeline([]))
    return IVFIndex(pipeline, nlist=m["nlist_requested"],
                    nprobe=m["nprobe"], sim=m["sim"],
                    backend=backend or m["backend"],
                    kmeans_iters=m["kmeans_iters"],
                    residual=bool(m.get("residual", False)),
                    kmeans_init=str(m.get("kmeans_init", "random")),
                    balanced=bool(m.get("balanced", False)),
                    device=device)


def _ivf_sd_common(meta: dict, data) -> dict:
    """The storage-independent part of an IVF ``load_state_dict`` dict,
    shared by the ``.npz`` and chunked loads (``data`` only needs
    ``.files`` and ``[]``: an ``aux.npz`` handle works)."""
    m = meta["index"]
    return {
        "pipeline": _gather_pipeline_sd(data, [n for n, _ in meta["stages"]],
                                        meta["stage_fitted"]),
        "centroids": data["centroids"],
        "scorer_extra": m.get("scorer_extra", {}),
        "nlist": m["nlist"], "nlist_requested": m["nlist_requested"],
        "nprobe": m["nprobe"], "n_docs": m["n_docs"], "dim": m["dim"],
        "residual": bool(m.get("residual", False)),
        "kmeans_init": str(m.get("kmeans_init", "random")),
        "balanced": bool(m.get("balanced", False)),
        "version": m.get("version", 0)}


def _rebuild_ivf(meta: dict, data, backend: Optional[str], kind: str,
                 device: torch.device) -> IVFIndex:
    """The IVF index an ``.npz`` artifact describes, with its state."""
    idx = _make_ivf(meta, backend, kind, device)
    return idx.load_state_dict({
        **_ivf_sd_common(meta, data),
        "storage": data["storage"],
        "lists": data["lists"],
        "labels": data["labels"] if "labels" in data.files else None})


def _is_seg_storage(name: str) -> bool:
    return name.startswith("seg:") and name.endswith(":storage")


def load_index_meta(path: str) -> dict:
    """An artifact's identity header without materialising any arrays.

    The same fields and fingerprint as ``repro``'s ``load_index_meta``:
    ``encoded_nbytes`` is the document storage (the main layer and any
    delta segments), ``aux_nbytes`` everything else an index holds
    resident (for a chunked artifact the aux members plus the list ids),
    ``artifact_version`` the on-disk version (1/2 ``.npz``, 3 chunked).
    """
    if is_chunked_artifact(path):
        reader = ChunkReader(path)       # manifest only — map stays closed
        meta = reader.meta
        _validate_header(meta, path)
        aux_sizes = npz_member_nbytes(os.path.join(path, "aux.npz"))
        seg_storage = sum(v for k, v in aux_sizes.items()
                          if _is_seg_storage(k))
        encoded = reader.encoded_nbytes + seg_storage
        aux = (sum(aux_sizes.values()) - seg_storage
               + int(reader.manifest["ids_nbytes"]))
    else:
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
