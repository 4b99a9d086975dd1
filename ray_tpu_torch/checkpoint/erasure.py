"""Chunk-level k+m erasure coding for checkpoint shards.

Replication keeps whole copies (2x bytes for one-failure tolerance);
erasure coding stores k data chunks plus m parity chunks ((k+m)/k x
bytes, any-m-failure tolerance — k=4,m=2 survives two lost nodes at
1.5x). The codec is systematic: data chunks are stored verbatim (the
content-addressed dedup ledger is untouched) and only the parity chunks
are computed, so the read path pays nothing while every group member
survives.

Arithmetic is GF(2^8): addition IS xor, multiplication goes through
log/exp tables and vectorizes with ``np.take`` over a per-coefficient
256-entry product table — pure python/numpy, no native codec
dependency. Parity rows come from a Cauchy matrix (every square
submatrix invertible), so reconstruction of any <= m missing members is
a small k x k solve regardless of which members died. With m=1 the
single parity row degenerates to the plain xor of the data chunks.

Chunks in a group may have different true lengths (the tail chunk of a
shard is short); encoding zero-pads to the group max and the manifest
records true lengths so reconstruction can trim.
"""

from __future__ import annotations

import numpy as np

# GF(2^8) with the usual primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d).
_GF_EXP = np.zeros(512, dtype=np.uint8)
_GF_LOG = np.zeros(256, dtype=np.int32)


def _build_tables() -> None:
    x = 1
    for i in range(255):
        _GF_EXP[i] = x
        _GF_LOG[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    # Doubled table lets gf_mul index log(a)+log(b) without a mod.
    _GF_EXP[255:510] = _GF_EXP[0:255]


_build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[_GF_LOG[a] + _GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf(256) inverse of 0")
    return int(_GF_EXP[255 - _GF_LOG[a]])


def _mul_table(c: int) -> np.ndarray:
    """256-entry table t where t[v] = c*v, for vectorized row scaling."""
    if c == 0:
        return np.zeros(256, dtype=np.uint8)
    if c == 1:
        return np.arange(256, dtype=np.uint8)
    t = _GF_EXP[(_GF_LOG[1:] + _GF_LOG[c]) % 255]
    return np.concatenate(([np.uint8(0)], t))


def _scale_xor(acc: np.ndarray, c: int, vec: np.ndarray) -> None:
    """acc ^= c * vec (in place), vectorized over bytes."""
    if c == 0:
        return
    if c == 1:
        np.bitwise_xor(acc, vec, out=acc)
        return
    np.bitwise_xor(acc, np.take(_mul_table(c), vec), out=acc)


def parity_rows(k: int, m: int) -> list[list[int]]:
    """Cauchy parity matrix rows: row j, col i = 1/(x_j + y_i) with
    x_j = j and y_i = m + i (all 2^8 elements distinct for k+m <= 256).
    Every square submatrix of a Cauchy matrix is invertible, so the
    systematic code [I; C] is MDS for any loss pattern."""
    if k < 1 or m < 0 or k + m > 256:
        raise ValueError(f"unsupported erasure geometry k={k} m={m}")
    return [[gf_inv(j ^ (m + i)) for i in range(k)] for j in range(m)]


def parse_spec(spec: str) -> tuple[int, int] | None:
    """Parse CKPT_ERASURE="k,m". Empty/0 disables; returns (k, m)."""
    spec = (spec or "").strip()
    if not spec or spec in ("0", "off", "none"):
        return None
    try:
        k_s, _, m_s = spec.partition(",")
        k, m = int(k_s), int(m_s or 1)
    except ValueError:
        raise ValueError(f"CKPT_ERASURE must be 'k,m', got {spec!r}")
    if k < 2 or m < 1 or k + m > 256:
        raise ValueError(f"CKPT_ERASURE out of range: k={k} m={m}")
    return k, m


def _as_padded(datas: list[bytes], width: int) -> list[np.ndarray]:
    out = []
    for d in datas:
        a = np.frombuffer(d, dtype=np.uint8)
        if len(a) < width:
            a = np.concatenate([a, np.zeros(width - len(a), dtype=np.uint8)])
        out.append(a)
    return out


def encode(datas: list[bytes], m: int) -> list[bytes]:
    """Compute m parity chunks over k data chunks (zero-padded to the
    longest member). Row 0 of the Cauchy matrix is not all-ones, but for
    m=1 the code is still a single-erasure parity; callers never need to
    care which matrix generated the bytes."""
    k = len(datas)
    rows = parity_rows(k, m)
    width = max((len(d) for d in datas), default=0)
    padded = _as_padded(datas, width)
    out = []
    for j in range(m):
        acc = np.zeros(width, dtype=np.uint8)
        for i in range(k):
            _scale_xor(acc, rows[j][i], padded[i])
        out.append(acc.tobytes())
    return out


def _solve(mat: list[list[int]], rhs: list[np.ndarray]) -> list[np.ndarray]:
    """Gauss-Jordan over GF(2^8); mat is k x k of ints, rhs k byte
    vectors. k is small (<= 16 in practice) so the O(k^3) python loop is
    nothing next to the byte work, which stays vectorized."""
    k = len(mat)
    a = [row[:] for row in mat]
    b = [v.copy() for v in rhs]
    for col in range(k):
        piv = next((r for r in range(col, k) if a[r][col]), None)
        if piv is None:
            raise ValueError("singular erasure matrix (bad survivor set)")
        if piv != col:
            a[col], a[piv] = a[piv], a[col]
            b[col], b[piv] = b[piv], b[col]
        inv = gf_inv(a[col][col])
        a[col] = [gf_mul(inv, v) for v in a[col]]
        b[col] = np.take(_mul_table(inv), b[col])
        for r in range(k):
            if r != col and a[r][col]:
                c = a[r][col]
                a[r] = [x ^ gf_mul(c, y) for x, y in zip(a[r], a[col])]
                _scale_xor(b[r], c, b[col])
    return b


def reconstruct(
    k: int,
    m: int,
    present: dict[int, bytes],
    want: list[int],
    lens: list[int] | None = None,
) -> dict[int, bytes]:
    """Recover missing DATA members from any k surviving members.

    ``present`` maps member index -> bytes, where indices 0..k-1 are
    data chunks and k..k+m-1 are parity chunks. ``want`` lists the data
    indices to recover. ``lens`` (optional) gives true data lengths for
    trimming the zero padding.
    """
    if len(present) < k:
        raise ValueError(
            f"need {k} survivors to reconstruct, have {len(present)}"
        )
    rows = parity_rows(k, m)
    use = sorted(present)[:k]
    width = max(len(present[i]) for i in use)
    vecs = _as_padded([present[i] for i in use], width)
    mat = []
    for idx in use:
        if idx < k:
            mat.append([1 if c == idx else 0 for c in range(k)])
        else:
            mat.append(rows[idx - k])
    datas = _solve(mat, vecs)
    out = {}
    for w in want:
        if not 0 <= w < k:
            raise ValueError(f"can only reconstruct data members, got {w}")
        raw = datas[w].tobytes()
        if lens is not None:
            raw = raw[: lens[w]]
        out[w] = raw
    return out


def recover_member(
    k: int,
    m: int,
    present: dict[int, bytes],
    member: int,
    lens: list[int] | None = None,
) -> bytes:
    """Recover ANY single lost member — data (index < k) or parity
    (index >= k) — from >= k survivors. A lost parity member is
    recovered by first solving for any missing data rows, then
    re-encoding its matrix row over the full data set."""
    if member < k:
        return reconstruct(k, m, present, [member], lens)[member]
    if not k <= member < k + m:
        raise ValueError(f"member {member} out of range for k={k} m={m}")
    missing = [i for i in range(k) if i not in present]
    rec = reconstruct(k, m, present, missing, None) if missing else {}
    rows = [bytes(present.get(i, rec.get(i))) for i in range(k)]
    return encode(rows, m)[member - k]


def plan_groups(hashes: list[str], k: int) -> list[list[str]]:
    """Split an ordered chunk list into parity groups of k data members.
    The tail group may be smaller than k (it still gets m parity chunks
    — slightly richer protection for slightly worse ratio on the tail)."""
    seen: set[str] = set()
    uniq = [h for h in hashes if not (h in seen or seen.add(h))]
    return [uniq[i : i + k] for i in range(0, len(uniq), k)]
