"""The measured-dispatch cache (DESIGN.md 17.2), the counterpart of
``repro/tune/cache.py``.

One JSON document mapping dispatch keys -- ``platform|op|shape-bucket|dtype``
-- to the implementation that won a measured race (:mod:`repro_torch.tune.
bench`).  Shapes are bucketed to the next power of two per dimension so one
measurement covers the whole neighbourhood of problem sizes it is
representative for, instead of re-racing every (1124, 16) vs (1097, 16)
validation split.

Staleness is handled at load time, not read time: the file carries a
``schema_version`` and a ``config_hash`` (hash of the environment fields
that make timings comparable: platform, torch and CUDA versions, the
card).  A loaded file whose stamps do not match the CURRENT schema/config
contributes no entries; the cache starts empty and refills.  A stale winner
can therefore never leak into a decision -- the worst case is always "fall
back to the static heuristic", never "trust a measurement taken somewhere
else".
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Mapping, Sequence

# bump when the key format or entry layout changes incompatibly
SCHEMA_VERSION = 1


def shape_bucket(shape: Sequence[int]) -> str:
    """Per-dimension next-power-of-two bucket, e.g. (1124, 16) -> "2048x16".

    Zero-size dims bucket as 0 (degenerate, but keyable)."""
    out = []
    for d in shape:
        d = int(d)
        out.append(str(1 << (d - 1).bit_length() if d > 0 else 0))
    return "x".join(out)


def make_key(platform: str, op: str, bucket: str, dtype: str = "") -> str:
    """The cache key: ``platform|op|shape-bucket|dtype``."""
    return f"{platform}|{op}|{bucket}|{dtype}"


def config_hash(config: Mapping) -> str:
    """Short stable hash of (schema version, config) -- the like-for-like
    stamp."""
    blob = json.dumps({"schema_version": SCHEMA_VERSION, **dict(config)},
                      sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


class DispatchCache:
    """key -> {winner, timings, candidates, source} with staleness stamps.

    ``config`` names the environment the measurements were taken in; its
    hash is written into the file and checked on load.  Entries are plain
    JSON values throughout, so ``save``/``load`` round-trips are exact
    (floats survive via repr round-tripping -- binary64-exact in json).
    """

    def __init__(self, config: Mapping | None = None):
        self.config = dict(config or {})
        self.entries: dict[str, dict] = {}
        self.stats = {"hits": 0, "misses": 0, "fills": 0, "stale_dropped": 0}

    # -- access ------------------------------------------------------------

    def config_hash(self) -> str:
        return config_hash(self.config)

    def get(self, key: str) -> dict | None:
        rec = self.entries.get(key)
        self.stats["hits" if rec is not None else "misses"] += 1
        return rec

    def put(self, key: str, winner: str, *, timings: Mapping | None = None,
            candidates: Sequence[str] | None = None,
            source: str = "measured") -> dict:
        rec = {"winner": str(winner),
               "timings": dict(timings) if timings is not None else None,
               "candidates": list(candidates) if candidates is not None
               else None,
               "source": source}
        self.entries[key] = rec
        self.stats["fills"] += 1
        return rec

    # -- persistence -------------------------------------------------------

    def to_dict(self) -> dict:
        return {"schema_version": SCHEMA_VERSION,
                "config": self.config,
                "config_hash": self.config_hash(),
                "entries": self.entries}

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)          # atomic: readers never see a torn file

    @classmethod
    def load(cls, path: str, *, config: Mapping | None = None
             ) -> "DispatchCache":
        """Cache for the CURRENT ``config``; the file's entries are adopted
        only when its schema-version and config-hash stamps match -- anything
        else self-invalidates to an empty cache (stats count the drop)."""
        cache = cls(config)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cache
        if not isinstance(doc, dict):
            return cache
        stale = (doc.get("schema_version") != SCHEMA_VERSION
                 or doc.get("config_hash") != cache.config_hash())
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            return cache
        if stale:
            cache.stats["stale_dropped"] += len(entries)
            return cache
        cache.entries = {str(k): dict(v) for k, v in entries.items()
                         if isinstance(v, dict) and "winner" in v}
        return cache
