"""Drift and parity audit of two JSON documents, by ULP or tolerance.

    python -m repro_torch.obs.diff a.json b.json --max-ulp 0
    python -m repro_torch.obs.diff port.json jax.json --rtol 1e-5

The port's copy of `repro.obs.diff`.  It walks two parsed JSON documents
(``repro.sim.sweep/v1`` records, ``repro.sim.state/v1`` carries, any
JSON tree): non-numeric values (scenario configs, schema tags, round
indices) must match exactly, and runtime metadata that differs between
runs (timings, engine and driver, provenance) is skipped by default
(`DEFAULT_IGNORE`).  Numeric paths are judged one of two ways:

- **ULP mode** (the default): each path's largest ULP distance, on the
  float32 grid when both values are exactly float32 and on the float64
  grid otherwise (`ulp_distance`); passes when every path is within
  ``--max-ulp`` (0: bit for bit).  This is how two runs of the port
  are held to each other, e.g. a killed and resumed run against an
  uninterrupted one.
- **Tolerance mode** (``--rtol`` and/or ``--atol``): each path's worst
  absolute gap ``|a - b|`` and relative gap ``|a - b| / |b|`` are
  reported, and a path passes when every element has ``|a - b| <= atol
  + rtol * |b|`` (numpy's `allclose`, ``b`` the second document).  Two
  platforms' float arithmetic differs in its last bits, so this is how
  a port document is judged against a JAX one.

NaN against NaN and +0 against -0 count as equal in both modes.  Exit
code 0 iff there is no structural mismatch and every path passes.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# keys whose subtrees legitimately differ between runs (timings, engine
# and driver metadata, provenance), skipped unless --no-default-ignore
DEFAULT_IGNORE = frozenset({
    "seconds", "drive_seconds", "rounds_per_sec", "n_traces", "exec",
    "dispatches", "warmup", "driver", "jax_backend", "device_count",
    "timestamp", "run_id", "provenance",
})


def _ulp32(x, y) -> np.ndarray:
    xi = x.view(np.int32).astype(np.int64)
    yi = y.view(np.int32).astype(np.int64)
    # sign-magnitude -> ordered integers: negatives map to -(magnitude)
    xi = np.where(xi < 0, -(xi & 0x7FFFFFFF), xi)
    yi = np.where(yi < 0, -(yi & 0x7FFFFFFF), yi)
    return np.abs(xi - yi)


def _ulp64(x, y) -> np.ndarray:
    # the same ordering on the float64 bit patterns, assembled in uint64
    # (magnitudes are <= 2^63 - 1, so |mx - my| and mx + my both fit)
    # and saturated into int64
    mask = np.int64(0x7FFFFFFFFFFFFFFF)
    xi = x.view(np.int64)
    yi = y.view(np.int64)
    mx = (xi & mask).astype(np.uint64)
    my = (yi & mask).astype(np.uint64)
    same_sign = (xi < 0) == (yi < 0)
    d = np.where(same_sign, np.maximum(mx, my) - np.minimum(mx, my),
                 mx + my)
    return np.minimum(
        d, np.uint64(np.iinfo(np.int64).max)).astype(np.int64)


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise ULP distance (int64); NaN against NaN and +0 against
    -0 are 0.  On the float32 bit patterns when both values are exactly
    float32, on the float64 ones otherwise (a float64 pair that differs
    below float32's precision must not read as equal)."""
    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    with np.errstate(over="ignore"):    # past float32's range -> inf,
        x32 = x.astype(np.float32)      # i.e. not float32-exact
        y32 = y.astype(np.float32)
    exact32 = (((x32.astype(np.float64) == x) | np.isnan(x))
               & ((y32.astype(np.float64) == y) | np.isnan(y)))
    d = np.where(exact32, _ulp32(x32, y32), _ulp64(x, y))
    return np.where(np.isnan(x) & np.isnan(y), 0, d)


def gaps(a, b) -> Tuple[np.ndarray, np.ndarray]:
    """Elementwise ``(|a - b|, |a - b| / |b|)`` in float64; a pair that
    is equal (NaN with NaN, inf with inf of one sign included) has gap
    0, and a nonzero gap over ``b == 0`` is relative inf."""
    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    same = (x == y) | (np.isnan(x) & np.isnan(y))
    with np.errstate(invalid="ignore", divide="ignore"):
        ab = np.where(same, 0.0, np.abs(x - y))
        ab = np.where(np.isnan(ab), np.inf, ab)
        rel = np.where(ab == 0, 0.0, ab / np.abs(y))
    return ab, rel


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _flat_numeric(v) -> bool:
    return isinstance(v, list) and v and all(_is_num(x) for x in v)


class DiffResult:
    """Accumulated comparison: per path, the largest ULP distance and
    the worst absolute and relative gaps (and, for a tolerance, whether
    every element was within it), plus structural errors."""

    def __init__(self, rtol: Optional[float] = None,
                 atol: Optional[float] = None):
        self.tolerance = rtol is not None or atol is not None
        self.rtol = 0.0 if rtol is None else float(rtol)
        self.atol = 0.0 if atol is None else float(atol)
        self.ulps: Dict[str, int] = {}
        self.abs_gap: Dict[str, float] = {}
        self.rel_gap: Dict[str, float] = {}
        self.outside: Dict[str, int] = {}
        self.errors: List[str] = []

    @property
    def max_ulp(self) -> int:
        return max(self.ulps.values(), default=0)

    def bitwise_paths(self) -> List[str]:
        return sorted(p for p, u in self.ulps.items() if u == 0)

    def failing_paths(self) -> List[str]:
        """Tolerance mode: the paths with an element outside it."""
        return sorted(p for p, n in self.outside.items() if n)

    def verdict(self, max_ulp: int = 0) -> bool:
        if self.errors:
            return False
        if self.tolerance:
            return not self.failing_paths()
        return self.max_ulp <= max_ulp


def _record(out: DiffResult, path: str, a, b) -> None:
    """Compare two numeric scalars or flat lists at `path`."""
    both_int = (
        (isinstance(a, int) and isinstance(b, int)) or
        (isinstance(a, list) and isinstance(b, list)
         and all(isinstance(x, int) for x in a)
         and all(isinstance(x, int) for x in b)))
    if both_int:
        if a != b:
            out.errors.append(f"{path}: integer mismatch {a!r} != {b!r}")
        else:
            out.ulps[path] = max(out.ulps.get(path, 0), 0)
            out.abs_gap.setdefault(path, 0.0)
            out.rel_gap.setdefault(path, 0.0)
            out.outside.setdefault(path, 0)
        return
    u = int(np.max(ulp_distance(a, b)))
    out.ulps[path] = max(out.ulps.get(path, 0), u)
    ab, rel = gaps(a, b)
    out.abs_gap[path] = max(out.abs_gap.get(path, 0.0), float(np.max(ab)))
    out.rel_gap[path] = max(out.rel_gap.get(path, 0.0), float(np.max(rel)))
    y = np.abs(np.asarray(b, np.float64))
    with np.errstate(invalid="ignore"):
        bad = int(np.sum(~((ab == 0) | (ab <= out.atol + out.rtol * y))))
    out.outside[path] = out.outside.get(path, 0) + bad


def diff_trees(a, b, path: str = "$", out: Optional[DiffResult] = None,
               ignore: frozenset = DEFAULT_IGNORE,
               rtol: Optional[float] = None,
               atol: Optional[float] = None) -> DiffResult:
    """Walk two parsed JSON trees; numeric leaves accumulate their
    distances, everything else must match exactly.  Dict keys in
    `ignore` are skipped wherever they appear.  `rtol`/`atol` select
    the tolerance mode's verdict (`DiffResult.verdict`)."""
    out = DiffResult(rtol, atol) if out is None else out
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k in ignore:
                continue
            if k not in a or k not in b:
                side = "first" if k not in a else "second"
                out.errors.append(
                    f"{path}.{k}: missing from the {side} document")
                continue
            diff_trees(a[k], b[k], f"{path}.{k}", out, ignore)
        return out
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            out.errors.append(f"{path}: length {len(a)} != {len(b)}")
            return out
        if _flat_numeric(a) and _flat_numeric(b):
            _record(out, path, a, b)
            return out
        for i, (x, y) in enumerate(zip(a, b)):
            diff_trees(x, y, f"{path}[{i}]", out, ignore)
        return out
    if _is_num(a) and _is_num(b):
        _record(out, path, a, b)
        return out
    if type(a) is not type(b):
        out.errors.append(
            f"{path}: type mismatch {type(a).__name__} vs "
            f"{type(b).__name__}")
        return out
    if a != b:
        out.errors.append(f"{path}: {a!r} != {b!r}")
    return out


def report(res: DiffResult, max_ulp: int = 0) -> Tuple[List[str], bool]:
    """Human-readable verdict lines and pass/fail."""
    lines = []
    n = len(res.ulps)
    n_bit = len(res.bitwise_paths())
    lines.append(f"compared {n} numeric paths: {n_bit} bitwise-equal, "
                 f"max ULP {res.max_ulp}")
    for p in sorted(res.ulps):
        if res.ulps[p] > 0:
            line = f"  {p}: max ULP {res.ulps[p]}"
            if res.tolerance:
                line += (f", max abs {res.abs_gap[p]:.3e}, max rel "
                         f"{res.rel_gap[p]:.3e}"
                         + (f", {res.outside[p]} outside"
                            if res.outside[p] else ""))
            lines.append(line)
    for e in res.errors:
        lines.append(f"  STRUCTURAL {e}")
    ok = res.verdict(max_ulp)
    if res.errors:
        why = f"{len(res.errors)} structural mismatches"
    elif res.tolerance:
        bad = res.failing_paths()
        why = (f"every path within rtol {res.rtol:g}, atol {res.atol:g}"
               if not bad else
               f"{len(bad)} paths outside rtol {res.rtol:g}, atol "
               f"{res.atol:g}")
    else:
        why = f"max ULP {res.max_ulp} <= {max_ulp} allowed"
    lines.append(f"{'PASS' if ok else 'FAIL'}: {why}")
    return lines, ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="ULP- or tolerance-aware parity audit of two JSON "
                    "documents")
    ap.add_argument("a", help="first JSON document")
    ap.add_argument("b", help="second JSON document (the reference of "
                              "--rtol)")
    ap.add_argument("--max-ulp", type=int, default=0,
                    help="ULP mode: the largest ULP distance allowed on "
                         "any numeric path (default 0 = bit for bit)")
    ap.add_argument("--rtol", type=float, default=None,
                    help="tolerance mode: |a - b| <= atol + rtol |b| on "
                         "every element, each path's worst gaps reported")
    ap.add_argument("--atol", type=float, default=None,
                    help="tolerance mode's absolute term (default 0)")
    ap.add_argument("--ignore", action="append", default=[],
                    metavar="KEY",
                    help="additional dict key to skip (repeatable)")
    ap.add_argument("--no-default-ignore", action="store_true",
                    help="compare runtime metadata (timings, engine "
                         "info, provenance) too")
    args = ap.parse_args(argv)

    ignore = (frozenset() if args.no_default_ignore else DEFAULT_IGNORE)
    ignore = ignore | frozenset(args.ignore)
    with open(args.a) as f:
        doc_a = json.load(f)
    with open(args.b) as f:
        doc_b = json.load(f)
    res = diff_trees(doc_a, doc_b, ignore=ignore, rtol=args.rtol,
                     atol=args.atol)
    lines, ok = report(res, args.max_ulp)
    for line in lines:
        print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
