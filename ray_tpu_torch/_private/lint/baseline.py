"""Baseline pinning: existing debt is recorded, only NEW violations fail.

The baseline maps violation fingerprints (rule|path|scope|snippet —
line-number-free, so edits above a pinned site don't unpin it) to
occurrence counts. ``diff_against_baseline`` returns the violations in
excess of the pinned count per fingerprint, plus the stale entries
whose debt has since been paid (surfaced so the baseline shrinks over
time instead of fossilizing).
"""

from __future__ import annotations

import collections
import json

BASELINE_VERSION = 1


def make_baseline(violations) -> dict:
    counts = collections.Counter(v.fingerprint for v in violations)
    return {
        "version": BASELINE_VERSION,
        "note": (
            "Pinned pre-existing tpulint violations. Regenerate with "
            "`python -m ray_tpu_torch._private.lint ray_tpu_torch --update-baseline` "
            "after paying down debt; never regenerate to hide NEW "
            "violations."
        ),
        "entries": {fp: counts[fp] for fp in sorted(counts)},
    }


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"this tpulint expects {BASELINE_VERSION}"
        )
    return data


def diff_against_baseline(violations, baseline: dict):
    """(new_violations, stale_fingerprints)."""
    allowed = dict(baseline.get("entries", {}))
    by_fp: dict[str, list] = collections.defaultdict(list)
    for v in violations:
        by_fp[v.fingerprint].append(v)
    new = []
    for fp, vs in by_fp.items():
        excess = len(vs) - allowed.get(fp, 0)
        if excess > 0:
            # The later occurrences (by line) are the "new" ones; which
            # physical site is new is unknowable from counts alone, but
            # the report must name real locations.
            vs.sort(key=lambda v: v.line)
            new.extend(vs[-excess:])
    stale = [fp for fp, n in allowed.items()
             if len(by_fp.get(fp, ())) < n]
    new.sort(key=lambda v: (v.path, v.line, v.rule))
    return new, sorted(stale)
