"""Chunked (v3) artifact layout: per-IVF-list chunks + JSON manifest.

Counterpart of ``repro.storage.format`` (numpy only): the port writes and
reads the same bytes.

The v1/v2 ``.npz`` artifact is monolithic: ``load_index`` materialises
every array, so the host must hold the whole encoded storage even when
Zipf-skewed traffic only ever touches a hot subset of the inverted
lists.  The v3 layout makes each inverted list independently
addressable so the cold tail can stay on disk:

    kb_v3/                     (one directory per artifact)
      manifest.json            identity header + per-list chunk table
      chunks.bin               per-list [storage rows | ids], 64-B aligned
      aux.npz                  everything always-resident: pipeline state,
                               router centroids, delta segments, drift

``manifest.json`` carries the same ``meta`` dict a v2 artifact embeds in
``__meta__`` plus a chunk table ``[offset, storage_nbytes, ids_nbytes,
n_rows, crc32]`` per list.  Chunks are written list-by-list
(:class:`ChunkWriter` — peak save RSS stays O(largest list), never
O(corpus)) and read back through one ``np.memmap`` per artifact
(:class:`ChunkReader` — a list read is a slice of the map, not a file
materialisation).  Every chunk carries a CRC-32; a corrupted list fails
loudly with :class:`ArtifactError` naming the list id instead of
returning silently wrong rankings.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Iterator, Optional

import numpy as np

#: chunk offsets are aligned so a mapped list starts on a cache-line
#: boundary (cheap: ≤ 63 pad bytes per list)
CHUNK_ALIGN = 64

MANIFEST_NAME = "manifest.json"
CHUNKS_NAME = "chunks.bin"
AUX_NAME = "aux.npz"


class ArtifactError(RuntimeError):
    """A saved artifact is structurally broken (missing member, bad
    checksum, truncated chunk) — as opposed to merely unknown/newer."""


def is_chunked_artifact(path: str) -> bool:
    """Is ``path`` a v3 chunked-artifact directory?"""
    return os.path.isdir(path) and \
        os.path.isfile(os.path.join(path, MANIFEST_NAME))


def npz_member_nbytes(path: str) -> dict[str, int]:
    """{member name: array nbytes} for an ``.npz`` without reading data.

    Parses only each member's ``.npy`` header (dtype + shape) through the
    zip directory, so meta queries on a multi-GB artifact stay O(headers).
    """
    out: dict[str, int] = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            name = info.filename
            if not name.endswith(".npy"):
                continue
            with zf.open(info) as f:
                version = np.lib.format.read_magic(f)
                # savez writes 1.0 headers; 2.0/3.0 share one layout
                read = (np.lib.format.read_array_header_1_0
                        if version[0] == 1
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(f)
            out[name[:-len(".npy")]] = \
                int(np.prod(shape, dtype=np.int64)) * int(dtype.itemsize)
    return out


def _align(n: int, align: int = CHUNK_ALIGN) -> int:
    return -(-n // align) * align


class ChunkWriter:
    """Stream per-list chunks to ``chunks.bin``, one list at a time.

    Usage::

        w = ChunkWriter(path, storage_dtype=..., storage_width=...)
        for rows, ids in per_list_rows():     # any order-stable iterator
            w.write_list(rows, ids)
        w.finish(meta, aux_arrays)            # aux.npz + manifest.json

    Nothing larger than one list's rows is ever held for the chunk
    member; ``aux_arrays`` (pipeline state, centroids, segments) are the
    small always-resident side and go through ``np.savez``.
    """

    def __init__(self, path: str, *, storage_dtype, storage_width: int,
                 ids_dtype=np.int32, align: int = CHUNK_ALIGN):
        self.path = path
        self.storage_dtype = np.dtype(storage_dtype)
        self.storage_width = int(storage_width)
        self.ids_dtype = np.dtype(ids_dtype)
        self.align = int(align)
        self.chunks: list[dict] = []
        os.makedirs(path, exist_ok=True)
        self._f = open(os.path.join(path, CHUNKS_NAME), "wb")
        self._pos = 0
        self._finished = False

    def write_list(self, rows: np.ndarray, ids: np.ndarray) -> None:
        """Append one inverted list: (n, w) encoded rows + (n,) doc ids."""
        rows = np.ascontiguousarray(rows, dtype=self.storage_dtype)
        ids = np.ascontiguousarray(ids, dtype=self.ids_dtype)
        if rows.ndim != 2 or rows.shape[1] != self.storage_width:
            raise ValueError(f"list rows must be (n, {self.storage_width}), "
                             f"got {rows.shape}")
        if ids.shape != (rows.shape[0],):
            raise ValueError(f"ids must be ({rows.shape[0]},), "
                             f"got {ids.shape}")
        offset = _align(self._pos, self.align)
        if offset != self._pos:
            self._f.write(b"\0" * (offset - self._pos))
        stor_b = rows.tobytes()
        ids_b = ids.tobytes()
        crc = zlib.crc32(ids_b, zlib.crc32(stor_b))
        self._f.write(stor_b)
        self._f.write(ids_b)
        self._pos = offset + len(stor_b) + len(ids_b)
        self.chunks.append({"offset": offset,
                            "storage_nbytes": len(stor_b),
                            "ids_nbytes": len(ids_b),
                            "n_rows": int(rows.shape[0]),
                            "crc32": crc})

    def finish(self, meta: dict, aux_arrays: dict) -> dict:
        """Write ``aux.npz`` + ``manifest.json``; returns the manifest."""
        if self._finished:
            raise RuntimeError("ChunkWriter.finish called twice")
        self._f.close()
        self._finished = True
        aux_path = os.path.join(self.path, AUX_NAME)
        np.savez(aux_path, **{k: np.asarray(v)
                              for k, v in aux_arrays.items()})
        manifest = {
            "format": meta.get("format", "repro-index"),
            "format_version": meta.get("format_version", 3),
            "meta": meta,
            "storage_dtype": self.storage_dtype.str,
            "storage_width": self.storage_width,
            "ids_dtype": self.ids_dtype.str,
            "align": self.align,
            "n_lists": len(self.chunks),
            "max_len": max((c["n_rows"] for c in self.chunks), default=0),
            "encoded_nbytes": sum(c["storage_nbytes"] for c in self.chunks),
            "ids_nbytes": sum(c["ids_nbytes"] for c in self.chunks),
            "aux_nbytes": sum(npz_member_nbytes(aux_path).values()),
            "chunks": [[c["offset"], c["storage_nbytes"], c["ids_nbytes"],
                        c["n_rows"], c["crc32"]] for c in self.chunks],
        }
        with open(os.path.join(self.path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, sort_keys=True)
            f.write("\n")
        return manifest


class ChunkReader:
    """Memory-mapped view over a v3 artifact's per-list chunks.

    ``read_list`` returns zero-copy views into the map (the caller copies
    on admission to a hot tier); ``verify=True`` checks the chunk's
    CRC-32 and raises :class:`ArtifactError` naming the list id on
    mismatch.  The manifest is parsed eagerly (it is the identity
    header); the map itself is opened lazily on the first list read.
    """

    def __init__(self, path: str):
        self.path = path
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(mpath):
            raise ArtifactError(f"{path}: no {MANIFEST_NAME} — not a "
                                "chunked artifact directory")
        with open(mpath) as f:
            self.manifest = json.load(f)
        self.meta = self.manifest["meta"]
        self.storage_dtype = np.dtype(self.manifest["storage_dtype"])
        self.storage_width = int(self.manifest["storage_width"])
        self.ids_dtype = np.dtype(self.manifest["ids_dtype"])
        self.n_lists = int(self.manifest["n_lists"])
        self.max_len = int(self.manifest["max_len"])
        self.encoded_nbytes = int(self.manifest["encoded_nbytes"])
        self.aux_nbytes = int(self.manifest["aux_nbytes"])
        self.chunks = [tuple(c) for c in self.manifest["chunks"]]
        self._mm: Optional[np.memmap] = None

    def _map(self) -> np.ndarray:
        if self._mm is None:
            cpath = os.path.join(self.path, CHUNKS_NAME)
            if not os.path.isfile(cpath):
                raise ArtifactError(f"{self.path}: missing {CHUNKS_NAME}")
            size = os.path.getsize(cpath)
            need = max((off + sb + ib for off, sb, ib, _, _ in self.chunks),
                       default=0)
            if size < need:
                raise ArtifactError(
                    f"{self.path}: {CHUNKS_NAME} truncated "
                    f"({size} bytes < {need} in manifest)")
            self._mm = (np.memmap(cpath, dtype=np.uint8, mode="r")
                        if size else np.zeros(0, np.uint8))
        return self._mm

    def list_nbytes(self, list_id: int) -> int:
        """Encoded storage bytes of one list (ids excluded — they are the
        same ids a resident index keeps in its padded list table)."""
        return self.chunks[list_id][1]

    def read_list(self, list_id: int, verify: bool = True
                  ) -> tuple[np.ndarray, np.ndarray]:
        """One inverted list → ``(rows (n, w), ids (n,))`` mmap views."""
        if not 0 <= list_id < self.n_lists:
            raise IndexError(f"list id {list_id} out of range "
                             f"[0, {self.n_lists})")
        off, stor_b, ids_b, n_rows, crc = self.chunks[list_id]
        mm = self._map()
        raw = mm[off: off + stor_b + ids_b]
        if verify and zlib.crc32(raw.tobytes()) != crc:
            raise ArtifactError(
                f"{self.path}: checksum mismatch on inverted list "
                f"{list_id} (chunk at offset {off}, {stor_b + ids_b} "
                "bytes) — artifact is corrupt, rebuild or restore it")
        rows = np.frombuffer(raw[:stor_b], dtype=self.storage_dtype) \
            .reshape(n_rows, self.storage_width)
        ids = np.frombuffer(raw[stor_b:], dtype=self.ids_dtype)
        return rows, ids

    def iter_lists(self, verify: bool = True
                   ) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        for lid in range(self.n_lists):
            rows, ids = self.read_list(lid, verify=verify)
            yield lid, rows, ids

    def load_aux(self):
        """The always-resident side (``np.load`` handle over aux.npz)."""
        apath = os.path.join(self.path, AUX_NAME)
        if not os.path.isfile(apath):
            raise ArtifactError(f"{self.path}: missing {AUX_NAME}")
        return np.load(apath, allow_pickle=False)

    def close(self) -> None:
        self._mm = None
