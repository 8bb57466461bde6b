"""One Index API: declarative specs, a build factory, ``.npz`` persistence.

Counterpart of ``repro.retrieval.api`` for exact and IVF search:

* :class:`IndexSpec` / :class:`ShardSpec` — frozen, JSON round-trippable
  recipes, with the same JSON as ``repro``'s (backends are written with
  ``repro``'s names, ``jnp``/``pallas``, and read back as the port's).
* :func:`build_index` — registry → pipeline → scorer → IVF, for
  :class:`CompressedIndex`, the float :class:`DenseIndex` and
  :class:`IVFIndex` (``spec.ivf``).  Sharded and mutable specs raise
  ``NotImplementedError`` naming the slice of the port that adds them.
* :func:`save_index` / :func:`load_index` / :func:`load_index_meta` — the
  version-1 ``.npz`` artifact, read and written with numpy alone:
  ``__meta__`` is a 0-d JSON string (no pickle), ``pipeline:{i}:{key}``
  arrays hold each stage's state, ``storage`` the encoded documents (1-bit
  words as uint32), and an IVF index adds ``centroids``, ``lists`` and
  ``labels``.  ``repro.retrieval.api.load_index`` reads what
  :func:`save_index` writes, and :func:`load_index` reads ``repro``'s —
  the one way fitted state crosses between the packages.
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
from repro_torch.retrieval.index import CompressedIndex, DenseIndex
from repro_torch.retrieval.ivf import IVFFlatIndex, IVFIndex
from repro_torch.retrieval.scorers import OneBitScorer
from repro_torch.utils import (DeviceLike, backend_to_repro, check_backend,
                               resolve_device)

ARTIFACT_FORMAT = "repro-index"
#: the one artifact version this slice reads and writes: immutable .npz
ARTIFACT_VERSION = 1

_MUTABLE_SLICE = "slice 4 of the port (mutable, tiered and served indexes)"
_SHARD_SLICE = "slice 5 of the port (sharded search)"
#: artifact kinds ``repro`` writes and the port cannot load yet
_LATER_KINDS = {
    "SegmentedIndex": _MUTABLE_SLICE,
    "ShardedCompressedIndex": _SHARD_SLICE, "ShardedIVFIndex": _SHARD_SLICE,
}

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
    ``method="dense"``.  ``queries_sample`` feeds the two-population
    statistics.
    """
    if spec.shard is not None:
        raise NotImplementedError(f"sharded indexes wait for {_SHARD_SLICE}")
    if spec.mutable:
        raise NotImplementedError(f"mutable indexes wait for {_MUTABLE_SLICE}")
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


def save_index(index, path: str) -> None:
    """Write the version-1 ``.npz`` artifact (spec + state) — readable by
    ``repro.retrieval.api.load_index`` and by :func:`load_index`."""
    if not isinstance(index, (DenseIndex, CompressedIndex, IVFIndex)):
        raise TypeError(f"don't know how to save {type(index).__name__}")
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {
        "format": ARTIFACT_FORMAT, "format_version": ARTIFACT_VERSION,
        "spec": index.spec.to_dict() if index.spec is not None else None,
        "kind": type(index).__name__,
    }
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
        storage = _numpy(sd["storage"])
        if isinstance(index.scorer, OneBitScorer):
            storage = storage.view(np.uint32)    # repro's word dtype
        arrays["storage"] = storage
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
    arrays["__meta__"] = np.asarray(json.dumps(meta, sort_keys=True))
    np.savez(path, **arrays)


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
    if version != ARTIFACT_VERSION:
        raise NotImplementedError(
            f"{path}: artifact version {version} is not readable yet — the "
            f"port reads version {ARTIFACT_VERSION} (.npz); mutable (v2) "
            f"and chunked (v3) artifacts wait for {_MUTABLE_SLICE}")
    return meta


def _check_npz(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: chunked (v3) artifact directories wait for "
            f"{_MUTABLE_SLICE}")


def load_index(path: str, *, backend: Optional[str] = None,
               expect: Optional[type] = None, device: DeviceLike = None):
    """Reconstruct an index from a version-1 ``.npz`` artifact on
    ``device`` (``None``: CUDA) — written by this package or by ``repro``.

    No corpus, no re-fit, no re-encode.  ``backend`` overrides the stored
    scorer backend; ``expect`` asserts the artifact kind.
    """
    dev = resolve_device(device)
    _check_npz(path)
    with np.load(path, allow_pickle=False) as data:
        meta = _parse_meta(data, path)
        kind = meta["kind"]
        m = meta["index"]
        if kind == "DenseIndex":
            idx = DenseIndex(data["storage"], sim=m["sim"], device=dev,
                             backend=backend or "auto")
        elif kind == "CompressedIndex":
            pipeline = (build_pipeline_from_spec(meta["stages"])
                        if meta["stages"] else CompressionPipeline([]))
            idx = CompressedIndex(pipeline, sim=m["sim"],
                                  backend=backend or m["backend"],
                                  device=dev)
            idx.load_state_dict({
                "pipeline": _gather_pipeline_sd(
                    data, [n for n, _ in meta["stages"]],
                    meta["stage_fitted"]),
                "storage": data["storage"],
                "scorer_extra": m.get("scorer_extra", {}),
                "n_docs": m["n_docs"], "dim": m["dim"],
                "version": m.get("version", 0)})
        elif kind in ("IVFIndex", "IVFFlatIndex"):
            idx = _rebuild_ivf(meta, data, backend, kind, dev)
        elif kind in _LATER_KINDS:
            raise NotImplementedError(
                f"{path} holds a {kind}, which waits for "
                f"{_LATER_KINDS[kind]}")
        else:
            raise ValueError(f"{path}: unknown index kind {kind!r}")
    if meta.get("spec") is not None:
        idx.spec = IndexSpec.from_dict(meta["spec"])
    if expect is not None and not isinstance(idx, expect):
        raise TypeError(f"{path} holds a {kind}, expected "
                        f"{expect.__name__} — use api.load_index for "
                        "kind-dispatching loads")
    return idx


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


def load_index_meta(path: str) -> dict:
    """An artifact's identity header without materialising any arrays.

    The same fields and fingerprint as ``repro``'s ``load_index_meta`` for
    a version-1 artifact: ``encoded_nbytes`` is the document storage,
    ``aux_nbytes`` everything else but the header.
    """
    _check_npz(path)
    with np.load(path, allow_pickle=False) as data:
        meta = _parse_meta(data, path)
    sizes = npz_member_nbytes(path)
    encoded = sizes.get("storage", 0)
    aux = sum(v for k, v in sizes.items() if k != "__meta__") - encoded
    m = meta.get("index") or {}
    return {
        "format_version": meta.get("format_version"),
        "artifact_version": meta.get("format_version"),
        "kind": meta["kind"],
        "spec": meta.get("spec"),
        "n_docs": m.get("n_docs"),
        "dim": m.get("dim"),
        "index_version": m.get("version", 0),
        "mutable": False,
        "encoded_nbytes": int(encoded),
        "aux_nbytes": int(aux),
        "fingerprint": hashlib.sha256(
            json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16],
    }
