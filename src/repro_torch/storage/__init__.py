"""Tiered index storage: chunked artifacts + byte-budgeted list stores.

Counterpart of ``repro.storage``, a numpy-only copy that the port keeps
for itself so it installs without ``repro``.  An IVF index can serve from
disk with a byte-budgeted hot tier instead of holding its whole encoded
storage in memory.

* :mod:`repro_torch.storage.format` — the chunked (v3) artifact layout:
  per-inverted-list chunks with a JSON manifest (offsets, lengths, CRC-32
  per list), streamed to disk list by list and read back through one
  ``np.memmap``.
* :mod:`repro_torch.storage.store` — the :class:`ListStore` tier protocol
  with :class:`ResidentStore` (always hot) and :class:`MmapStore` (LRU hot
  tier, frequency-aware admission, pinning, hit/miss/eviction counters).

The container keeps the artifact's own dtypes, byte for byte as ``repro``
writes them: 1-bit words are ``uint32`` on disk and in what the stores
return.  The port holds those words as int32 views with the same bytes;
the IVF layer views the rows so on its side of the boundary
(:func:`repro_torch.retrieval.ivf.port_rows` / ``artifact_rows``).
``MmapStore.get`` may return read-only views into the map: consumers copy
them before they reach torch.

Front door: ``save_index(index, path, chunked=True)`` writes the v3 layout
and ``load_index(path, resident="auto"|"all"|budget_bytes)`` decides
residency (see :mod:`repro_torch.retrieval.api`).
"""

from repro_torch.storage.format import (ArtifactError, ChunkReader,
                                        ChunkWriter, is_chunked_artifact,
                                        npz_member_nbytes)
from repro_torch.storage.store import ListStore, MmapStore, ResidentStore

__all__ = [
    "ArtifactError", "ChunkReader", "ChunkWriter", "is_chunked_artifact",
    "npz_member_nbytes",
    "ListStore", "MmapStore", "ResidentStore",
]
