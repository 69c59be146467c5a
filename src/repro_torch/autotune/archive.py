"""Persistent Pareto archive over (rel-accuracy, SQ, measured latency); a
numpy-only copy of ``repro.autotune.archive``.

Every candidate policy the search evaluates is offered to the archive;
only non-dominated points survive.  The archive is the durable artifact
of a ReLeQ run: JSON-checkpointed, warm-startable (a new search resumes
against the frontier of every previous run), and the thing ``deploy.py``
pulls winners from.  Its JSON is the reference's, so either package
warm-starts from the other's file.

Dominance is *weak dominance with one strict improvement* over a fixed
objective tuple (maximize ``acc``, minimize ``sq`` and ``latency``).
Two consequences keep insertion **order-independent**:

- points are identified by (bits, objectives): the same candidate
  re-measured to different numbers is a distinct point and the dominated
  one is pruned; exact re-insertions are idempotent;
- equal-objective points with different bits are mutually non-dominated
  and both survive (no arbitrary tie-break, which would make the final
  set depend on arrival order).

``core/pareto.py``'s exhaustive enumeration remains the small-network
oracle: ``from_enumeration`` ingests its points, and on enumerable nets
the 2-objective archive frontier equals ``pareto_frontier`` exactly.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

# objective name -> sense (+1 maximize, -1 minimize)
OBJECTIVE_SENSE = {"acc": 1.0, "sq": -1.0, "latency": -1.0}


@dataclass(frozen=True)
class ArchiveEntry:
    """One non-dominated candidate: canonical bits + measured objectives."""

    bits: tuple           # canonical ((name, bits), ...) sorted by name
    acc: float            # relative accuracy (maximize)
    sq: float             # State of Quantization (minimize)
    latency: float | None = None   # measured s/decode-step (minimize)
    reward: float | None = None    # shaped reward at evaluation time
    meta: tuple = ()      # ((key, value), ...) provenance, not compared

    def bits_dict(self) -> dict:
        return {n: b for n, b in self.bits}

    def objective(self, name: str) -> float:
        return getattr(self, name)

    def key(self) -> tuple:
        """Identity: bits + objective values (reward/meta excluded)."""
        return (self.bits, self.acc, self.sq, self.latency)


def dominates(a: ArchiveEntry, b: ArchiveEntry, objectives) -> bool:
    """a weakly dominates b with at least one strict improvement."""
    strict = False
    for name in objectives:
        s = OBJECTIVE_SENSE[name]
        va, vb = s * a.objective(name), s * b.objective(name)
        if va < vb:
            return False
        if va > vb:
            strict = True
    return strict


class ParetoArchive:
    """Dominance-pruned archive with JSON checkpointing and warm-start."""

    def __init__(self, objectives=("acc", "sq", "latency")):
        objectives = tuple(objectives)
        unknown = set(objectives) - set(OBJECTIVE_SENSE)
        if unknown or not objectives:
            raise ValueError(f"objectives={objectives!r}")
        self.objectives = objectives
        self._entries: dict[tuple, ArchiveEntry] = {}
        self.offered = 0
        self.accepted = 0

    # ------------------------------------------------------------- mutate
    def add(self, bits_by_name: dict, *, acc: float, sq: float,
            latency: float | None = None, reward: float | None = None,
            meta: dict | None = None) -> bool:
        """Offer a point; -> True iff it joins the archive (non-dominated).

        Dominated incumbents are pruned; exact duplicates are idempotent.
        """
        if "latency" in self.objectives and latency is None:
            raise ValueError("this archive ranks latency; none given "
                             "(use objectives=('acc', 'sq') without it)")
        entry = ArchiveEntry(
            bits=tuple(sorted((str(n), int(b))
                              for n, b in bits_by_name.items())),
            acc=float(acc), sq=float(sq),
            latency=None if latency is None else float(latency),
            reward=None if reward is None else float(reward),
            meta=tuple(sorted((meta or {}).items())))
        self.offered += 1
        key = entry.key()
        if key in self._entries:
            return False  # idempotent re-offer
        for old in self._entries.values():
            if dominates(old, entry, self.objectives):
                return False
        self._entries = {k: e for k, e in self._entries.items()
                         if not dominates(entry, e, self.objectives)}
        self._entries[key] = entry
        self.accepted += 1
        return True

    def merge(self, other: "ParetoArchive") -> int:
        """Warm-start composition: offer every entry of ``other``."""
        added = 0
        for e in other.entries():
            added += self.add(e.bits_dict(), acc=e.acc, sq=e.sq,
                              latency=e.latency, reward=e.reward,
                              meta=dict(e.meta))
        return added

    # -------------------------------------------------------------- query
    def entries(self) -> list[ArchiveEntry]:
        return sorted(self._entries.values(),
                      key=lambda e: (e.sq, -e.acc, e.bits))

    def __len__(self) -> int:
        return len(self._entries)

    def objective_set(self) -> set:
        return {tuple(e.objective(o) for o in self.objectives)
                for e in self._entries.values()}

    def select(self, mode: str = "knee", *, acc_floor: float = 0.95):
        """Pick a deployment winner from the frontier.

        - ``accuracy``: highest rel-accuracy (ties -> cheapest),
        - ``efficiency``: lowest SQ among entries with acc >= acc_floor,
        - ``latency``: lowest measured latency with acc >= acc_floor,
        - ``knee``: max (acc - sq), the paper's "desired region" utility,
        - ``reward``: highest recorded shaped reward.
        """
        entries = self.entries()
        if not entries:
            return None
        if mode == "accuracy":
            return max(entries, key=lambda e: (e.acc, -e.sq))
        ok = [e for e in entries if e.acc >= acc_floor] or entries
        if mode == "efficiency":
            return min(ok, key=lambda e: (e.sq, -e.acc))
        if mode == "latency":
            with_lat = [e for e in ok if e.latency is not None]
            if with_lat:
                return min(with_lat, key=lambda e: (e.latency, e.sq))
            return min(ok, key=lambda e: (e.sq, -e.acc))
        if mode == "reward":
            with_r = [e for e in entries if e.reward is not None]
            if with_r:
                return max(with_r, key=lambda e: e.reward)
            mode = "knee"
        if mode == "knee":
            return max(entries, key=lambda e: (e.acc - e.sq, -e.sq))
        raise ValueError(f"select mode {mode!r}")

    # ---------------------------------------------------------- persist
    def to_dict(self) -> dict:
        return {
            "objectives": list(self.objectives),
            "entries": [{
                "bits": {n: b for n, b in e.bits},
                "acc": e.acc, "sq": e.sq, "latency": e.latency,
                "reward": e.reward, "meta": dict(e.meta),
            } for e in self.entries()],
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        os.replace(tmp, path)  # atomic checkpoint: never a torn archive

    @classmethod
    def from_dict(cls, d: dict) -> "ParetoArchive":
        arch = cls(objectives=tuple(d["objectives"]))
        for e in d["entries"]:
            arch.add(e["bits"], acc=e["acc"], sq=e["sq"],
                     latency=e.get("latency"), reward=e.get("reward"),
                     meta=e.get("meta") or {})
        return arch

    @classmethod
    def load(cls, path: str) -> "ParetoArchive":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def warm_start(cls, path: str | None,
                   objectives=("acc", "sq", "latency")) -> "ParetoArchive":
        """Load ``path`` if it exists, else a fresh archive — so searches
        resume and compose across runs with one call.

        A loaded archive whose objectives differ from the requested ones
        (e.g. a latency-ranked checkpoint resumed without a latency
        evaluator) is re-ranked under the requested objectives; entries
        missing a now-required objective are dropped (they cannot be
        compared) rather than crashing the search mid-run."""
        objectives = tuple(objectives)
        if path and os.path.exists(path):
            loaded = cls.load(path)
            if loaded.objectives == objectives:
                return loaded
            arch = cls(objectives=objectives)
            for e in loaded.entries():
                if "latency" in objectives and e.latency is None:
                    continue
                arch.add(e.bits_dict(), acc=e.acc, sq=e.sq,
                         latency=e.latency, reward=e.reward,
                         meta=dict(e.meta))
            return arch
        return cls(objectives=objectives)

    # ------------------------------------------------------------ oracle
    @classmethod
    def from_enumeration(cls, points, latency_fn=None) -> "ParetoArchive":
        """Ingest ``core.pareto.enumerate_space`` output (the small-network
        oracle).  ``latency_fn(bits_by_name)`` optionally adds the third
        objective; without it the archive ranks (acc, sq) only — exactly
        the frontier ``core.pareto.pareto_frontier`` extracts."""
        objectives = ("acc", "sq", "latency") if latency_fn else ("acc", "sq")
        arch = cls(objectives=objectives)
        for p in points:
            arch.add(p["bits"], acc=p["acc"], sq=p["quant"],
                     latency=latency_fn(p["bits"]) if latency_fn else None)
        return arch
