"""The comparison that decides ``correct``.

The program's answers (each query row's ids and scores, as they reached
the host) are held against the plain reference (``portbench.reference``)
on the same documents and queries:

- ``faults``: rows that break the guarantees on their own: an id out of
  range or repeated, a score not finite, a row not in (score desc, id
  asc) order, or the wrong length.  Exact: limit 0.
- ``gap_max`` / ``gap_share``: at each rank r, how far the reference's
  score of the document the program put there lies below the reference's
  own r-th best; the widest such gap, and the share of (row, rank) with
  any gap.
- ``score_err_max`` / ``score_differ_share``: how far the score the
  program reported lies from the reference's score of the same document;
  the widest, and the share that differ at all.

A configuration whose ``reference`` is ``"independent"`` is refitted by
the reference from the documents alone, and the program's stored codes
are held against the reference's:

- ``code_differ_median``: the share of stored codes that differ from the
  reference's encode of every document, each column up to the sign of
  its PCA direction, in the median column.

One whose fit the reference can only follow from the program's own state
(``"program_state"``: PCA-245 keeps ~100 directions of a nearly isotropic
noise subspace, which no second fit reproduces) has every fitted piece
held against the reference's own fit of it, and the search is then
worked out again with the reference's means, the program's projection
and rotation (once checked), and the reference's list assignment:

- ``mean_err``: the widest distance of a fitted mean (each CenterNorm's
  documents' and queries' means, the PCA's mean) from the reference's
  float64 mean of the same input, over the RMS norm of that input's rows;
- ``pca_capture_loss``: |1 − tr(Wᵀ C W) / (sum of C's top-d eigenvalues)|,
  C the reference's covariance of the centered, normalized documents;
- ``rotation_orth_err``: the largest entry of |RᵀR − I|;
- ``itq_gain_short``: the share of the reference's own ITQ gain (10
  rounds on 65,536 of the same rows) that the program's rotation falls
  short of, by ITQ's objective Σ|XR| over every document: 1 − (Σ|XR| −
  Σ|X|) / (Σ|XR_ref| − Σ|X|);
- ``code_bits_differ``: the share of stored sign bits that differ from the
  reference's encode of every document through the checked stages;
- ``kmeans_inertia_excess``: the k-means loss of the program's centroids
  over every document, against that of the reference's own k-means++ and
  Lloyd fit (on 100,000 rows), less 1;
- ``label_differ``: the share of documents whose list differs from the
  reference's capacity-aware assignment to the program's centroids.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import plain

#: a difference counts below this share of the score's magnitude
REL_EPS = 1e-9


def row_faults(scores: np.ndarray, ids: np.ndarray, k: int,
               n_docs: int) -> bool:
    if scores.shape != (k,) or ids.shape != (k,):
        return True
    if not np.all(np.isfinite(scores)):
        return True
    if np.any(ids < 0) or np.any(ids >= n_docs):
        return True
    if np.unique(ids).size != k:
        return True
    ds = np.diff(scores.astype(np.float64))
    if np.any(ds > 0):
        return True
    ties = ds == 0
    return bool(np.any(np.diff(ids)[ties] < 0))


def code_differ_median(prog: torch.Tensor, ref_state: plain.State) -> float:
    """The median over columns of the share of stored codes that differ
    from the reference's, each column taken up to the sign of its
    direction (a PCA vector is fitted up to its sign, and a code c then
    reads as levels − c).  The median, since two PCA vectors whose
    eigenvalues lie within a few tenths of a percent of each other turn
    within their plane between any two fits, and their columns then
    differ by a tenth or more on some seeds."""
    ref = ref_state.storage
    prog = prog.to(ref.device)
    if prog.shape != ref.shape:
        return 1.0
    prog = prog.to(ref.dtype)
    flipped = (~ref if ref.dtype == torch.bool
               else int(ref_state.quant[1]["levels"]) - ref)
    same = (prog != ref).float().mean(0)
    other = (prog != flipped).float().mean(0)
    return float(torch.minimum(same, other).median())


def _dist(prog: torch.Tensor, ref: torch.Tensor, rms: float) -> float:
    return float(torch.linalg.vector_norm(prog.to(ref) - ref)) / rms


def _stage_checks(cfg: dict, state: plain.State, docs: torch.Tensor,
                  queries_fit: torch.Tensor, build_seed: int
                  ) -> tuple[dict, plain.State]:
    """The stage-by-stage numbers, and the state the reference searches
    with: its own means, the program's projection and rotation, its own
    codes and lists."""
    ref = plain.REFERENCE
    g = torch.Generator(device=docs.device).manual_seed(build_seed)
    means, out, stages = [], {}, []
    x, q = docs, queries_fit
    for name, pst in state.stages:
        if name == "CenterNorm":
            st = {"mean_docs": plain._mean(x, ref),
                  "mean_queries": plain._mean(q, ref)}
            means += [_dist(pst["mean_docs"], st["mean_docs"],
                            plain.mean_sq_norm(x) ** 0.5),
                      _dist(pst["mean_queries"], st["mean_queries"],
                            plain.mean_sq_norm(q) ** 0.5)]
        elif name == "PCA":
            mean, cov = plain.covariance(x, ref)
            means.append(_dist(pst["mean"], mean,
                               plain.mean_sq_norm(x) ** 0.5))
            w = pst["W"].to(torch.float64)
            top = torch.linalg.eigvalsh(cov).flip(0)[: w.shape[1]].sum()
            out["pca_capture_loss"] = float(abs(
                1.0 - torch.trace(w.T @ cov @ w) / top))
            st = {"mean": mean, "W": w}
            del cov
        elif name == "LearnedRotation":
            r = pst["R"].to(torch.float64)
            eye = torch.eye(r.shape[0], dtype=r.dtype, device=r.device)
            out["rotation_orth_err"] = float((r.T @ r - eye).abs().max())
            own = plain.fit_rotation(x, g, ref)["R"]
            base = plain.abs_sum(x, eye)
            gain = plain.abs_sum(x, r) - base
            out["itq_gain_short"] = 1.0 - gain / (plain.abs_sum(x, own)
                                                  - base)
            st = {"R": r}
        else:
            raise ValueError(f"no check for stage {name!r}")
        stages.append((name, st))
        x = plain._transformed([(name, st)], x, ref)
        q = plain.apply_stage(name, st, q, "queries", ref)
    out["mean_err"] = max(means) if means else 0.0
    codes = plain.encode(state.quant, x)
    out["code_bits_differ"] = float(
        (codes != state.storage.to(codes.dtype)).float().mean())
    checked = plain.State(stages=stages, quant=state.quant, storage=codes,
                          dim=state.dim)
    ivf = cfg.get("ivf")
    if ivf is not None:
        prog_c = state.centroids.to(torch.float64)
        own_c = plain.fit_router(x, int(ivf["nlist"]),
                                 int(ivf["kmeans_iters"]), g, ref)
        out["kmeans_inertia_excess"] = (plain.inertia(x, prog_c)
                                        / plain.inertia(x, own_c) - 1.0)
        labels = plain.assign_balanced(x, prog_c, ref)
        out["label_differ"] = float(
            (labels != state.labels.to(labels.device)).float().mean())
        checked.centroids, checked.labels = prog_c, labels
    return out, checked


def check(cfg: dict, docs: torch.Tensor, queries_fit: torch.Tensor,
          q_raw: torch.Tensor, ks, scores: list, ids: list,
          build_seed: int, state: plain.State | None = None) -> dict:
    """Every number for the answers ``(scores[i], ids[i])`` of the raw
    query rows ``q_raw`` at depths ``ks``; ``state`` is the program's
    fitted state (its codes, and where the configuration's reference
    follows it, every fitted piece)."""
    n_docs = int(docs.shape[0])
    ks = [int(k) for k in ks]
    faults = sum(row_faults(np.asarray(s), np.asarray(i), k, n_docs)
                 for s, i, k in zip(scores, ids, ks))
    out = {"faults": float(faults)}
    if cfg.get("reference") == "program_state":
        stage_out, ref_state = _stage_checks(cfg, state, docs, queries_fit,
                                             build_seed)
        out.update(stage_out)
    else:
        ref_state = plain.build(cfg, docs, queries_fit, build_seed)
        if state is not None:
            out["code_differ_median"] = code_differ_median(
                state.storage, ref_state)
    nprobe = cfg["ivf"]["nprobe"] if cfg.get("ivf") else None
    searcher = plain.Searcher(ref_state, plain.REFERENCE, nprobe=nprobe)
    kmax = max(ks)
    dev = docs.device
    ref_top, _ = searcher.search(q_raw, kmax)
    prog_ids = torch.zeros((len(ks), kmax), dtype=torch.long)
    prog_s = torch.zeros((len(ks), kmax), dtype=torch.float64)
    valid = torch.zeros((len(ks), kmax), dtype=torch.bool)
    for r, (s, i, k) in enumerate(zip(scores, ids, ks)):
        i = np.asarray(i)[:k]
        n = i.shape[0]
        prog_ids[r, :n] = torch.from_numpy(np.clip(i, 0, n_docs - 1)
                                           .astype(np.int64))
        prog_s[r, :n] = torch.from_numpy(np.asarray(s)[:n]
                                         .astype(np.float64))
        valid[r, :n] = True
    prog_ids, prog_s, valid = prog_ids.to(dev), prog_s.to(dev), valid.to(dev)
    ref_of = searcher.score_of(q_raw, prog_ids)
    mag = 1.0 + ref_top.abs()
    gap = torch.where(valid & torch.isfinite(ref_top), ref_top - ref_of, 0.0)
    err = torch.where(valid, (prog_s - ref_of).abs(), 0.0)
    n_valid = max(int(valid.sum()), 1)
    out["gap_max"] = float(gap.clamp(min=0).max())
    out["gap_share"] = float((gap > REL_EPS * mag).sum()) / n_valid
    out["score_err_max"] = float(err.max())
    out["score_differ_share"] = float((err > REL_EPS * mag).sum()) / n_valid
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the configuration's
    compared numbers; a number missing or above its limit fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, checks
