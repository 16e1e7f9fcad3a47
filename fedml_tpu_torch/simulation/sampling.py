"""Client sampling: the engine's pure per-round sampler and shuffles.

:func:`sample_clients` is what the simulation engines use. It is a pure
function of ``(seed, round_idx)``: each round draws from a fresh
``np.random.default_rng([seed, round])`` stream, so prefetch workers,
concurrent engines, and checkpoint-resumed runs all see identical cohorts
without sharing any global RNG state. The integer population is passed
straight to ``Generator.choice`` — a 1M-client registry never materializes
a Python ``range`` list the way the reference sampler did.

This module is a verbatim numpy copy of ``fedml_tpu/simulation/sampling.py``:
cohorts and per-client shuffles must be bit-identical between the two
packages, and the port imports nothing from the JAX package.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np


def sample_clients(
    seed: int, round_idx: int, client_num_in_total: int,
    client_num_per_round: int,
) -> np.ndarray:
    """Sampled cohort for one round, pure in ``(seed, round_idx)``.

    Full participation short-circuits to ``arange`` (bit-compatible with
    the reference there). Otherwise the per-round generator is seeded by
    the SeedSequence fold-in of (seed, round) — two runs of the same
    config draw identical cohorts, and no process-global stream is read
    or advanced.
    """
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total)
    n = min(client_num_per_round, client_num_in_total)
    rng = np.random.default_rng([int(seed), int(round_idx)])
    return rng.choice(int(client_num_in_total), n, replace=False)


# ---------------------------------------------------------------------------
# Vectorized per-client permutation streams
# ---------------------------------------------------------------------------
#
# The simulator shuffles every sampled client's local dataset with its own
# ``np.random.default_rng([seed, round, cid]).permutation(n)`` stream, so the
# shuffle is independent of cohort order (the bucketed schedule packs the
# same cohort in a different order) and of everything else that consumes RNG.
# Constructing 10k Generators per round costs ~200 ms of host time — almost
# entirely SeedSequence entropy mixing and PCG64 state init, not the 7
# uint32 draws an 8-sample permutation needs.  ``client_permutations`` below
# reimplements exactly that stream family as bulk numpy array arithmetic —
# SeedSequence pool mixing, PCG64 (XSL-RR 128/64) seeding and stepping, the
# Generator's buffered 32-bit lemire/masked-rejection draw, and the
# Fisher-Yates loop of ``Generator.permutation`` — across all clients at
# once.  It is BIT-EXACT: every call self-checks a sample of lanes against
# the real numpy path and falls back wholesale (with a warning) on any
# mismatch, so a future numpy stream change degrades to the slow path
# instead of silently changing histories.

_SS_INIT_A = 0x43B0D7E5
_SS_MULT_A = 0x931E8875
_SS_INIT_B = 0x8B51F9DD
_SS_MULT_B = 0x58F38DED
_SS_MIX_L = 0xCA01F9DD
_SS_MIX_R = 0x4973F715
_U32 = np.uint32
_U64 = np.uint64
_MASK32 = _U64(0xFFFFFFFF)
# PCG64's 128-bit LCG multiplier, split into 64-bit limbs
_PCG_MULT_HI = _U64(2549297995355413924)
_PCG_MULT_LO = _U64(4865540595714422341)


def _hashmix_consts(n_calls: int) -> np.ndarray:
    """The (deterministic, value-independent) hash-constant schedule consumed
    by ``n_calls`` successive SeedSequence ``hashmix`` invocations."""
    hc = np.empty(n_calls + 1, dtype=_U32)
    c = _SS_INIT_A
    for i in range(n_calls + 1):
        hc[i] = c
        c = (c * _SS_MULT_A) & 0xFFFFFFFF
    return hc


def _seedseq_pool(entropy: np.ndarray) -> np.ndarray:
    """Vectorized ``SeedSequence.mix_entropy`` (pool_size=4) over lanes.

    ``entropy``: (L, W) uint32 — W entropy words per lane, W <= 4.
    Returns the mixed pool, (L, 4) uint32.
    """
    L, W = entropy.shape
    assert W <= 4
    n_hash = 4 + 12  # pool fill + pairwise mix
    hcs = _hashmix_consts(n_hash)
    k = 0

    def hashmix(value: np.ndarray) -> np.ndarray:
        nonlocal k
        v = value ^ hcs[k]
        v = (v * hcs[k + 1]).astype(_U32)
        k += 1
        return v ^ (v >> _U32(16))

    def mix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        r = (x * _U32(_SS_MIX_L) - y * _U32(_SS_MIX_R)).astype(_U32)
        return r ^ (r >> _U32(16))

    zeros = np.zeros(L, dtype=_U32)
    pool = [hashmix(entropy[:, i] if i < W else zeros) for i in range(4)]
    for i_src in range(4):
        for i_dst in range(4):
            if i_src != i_dst:
                pool[i_dst] = mix(pool[i_dst], hashmix(pool[i_src]))
    return np.stack(pool, axis=1)


def _seedseq_state64(pool: np.ndarray) -> np.ndarray:
    """Vectorized ``SeedSequence.generate_state(4, uint64)``: (L, 4) uint64
    from the mixed (L, 4) uint32 pool."""
    L = pool.shape[0]
    out32 = np.empty((L, 8), dtype=_U32)
    hc = _SS_INIT_B
    for i_dst in range(8):
        data = pool[:, i_dst % 4] ^ _U32(hc)
        hc = (hc * _SS_MULT_B) & 0xFFFFFFFF
        data = (data * _U32(hc)).astype(_U32)
        out32[:, i_dst] = data ^ (data >> _U32(16))
    w = out32.astype(_U64)
    return w[:, 0::2] | (w[:, 1::2] << _U64(32))


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of a 64x64->128 multiply, via 32-bit limbs."""
    a0, a1 = a & _MASK32, a >> _U64(32)
    b0, b1 = b & _MASK32, b >> _U64(32)
    t = a1 * b0 + ((a0 * b0) >> _U64(32))
    w1 = (t & _MASK32) + a0 * b1
    return a1 * b1 + (t >> _U64(32)) + (w1 >> _U64(32))


class _VecPCG64:
    """Lanes of PCG64 (XSL-RR 128/64) with the Generator's buffered 32-bit
    draw, as numpy array state. Bit-compatible with ``np.random.PCG64``."""

    __slots__ = ("st_hi", "st_lo", "inc_hi", "inc_lo", "has32", "cached32")

    def __init__(self, seed_words: np.ndarray):
        # seed_words: (L, 4) uint64 from SeedSequence.generate_state(4)
        is_hi, is_lo = seed_words[:, 0], seed_words[:, 1]
        iq_hi, iq_lo = seed_words[:, 2], seed_words[:, 3]
        self.inc_hi = (iq_hi << _U64(1)) | (iq_lo >> _U64(63))
        self.inc_lo = (iq_lo << _U64(1)) | _U64(1)
        # state = 0; step(); state += initstate; step()
        self.st_hi, self.st_lo = self.inc_hi.copy(), self.inc_lo.copy()
        lo = self.st_lo + is_lo
        self.st_hi = self.st_hi + is_hi + (lo < self.st_lo)
        self.st_lo = lo
        self._step(slice(None))
        L = seed_words.shape[0]
        self.has32 = np.zeros(L, dtype=bool)
        self.cached32 = np.zeros(L, dtype=_U32)

    def _step(self, sel) -> None:
        a_hi, a_lo = self.st_hi[sel], self.st_lo[sel]
        lo = a_lo * _PCG_MULT_LO
        hi = (a_hi * _PCG_MULT_LO + a_lo * _PCG_MULT_HI
              + _mulhi64(a_lo, _PCG_MULT_LO))
        lo2 = lo + self.inc_lo[sel]
        hi = hi + self.inc_hi[sel] + (lo2 < lo)
        self.st_hi[sel], self.st_lo[sel] = hi, lo2
    def next64(self, sel) -> np.ndarray:
        """Advance the selected lanes and return their XSL-RR outputs."""
        self._step(sel)
        hi, lo = self.st_hi[sel], self.st_lo[sel]
        rot = hi >> _U64(58)
        v = hi ^ lo
        return (v >> rot) | (v << ((_U64(64) - rot) & _U64(63)))

    def next32(self, idx: np.ndarray) -> np.ndarray:
        """The Generator's buffered ``next_uint32`` for the indexed lanes:
        serve the cached high half when present, else draw 64 bits and cache
        the high half. Returns one uint32 per entry of ``idx`` (an int index
        array; lanes may repeat across calls but not within one)."""
        out = np.empty(idx.shape[0], dtype=_U32)
        has = self.has32[idx]
        t = np.nonzero(has)[0]
        if t.size:
            it = idx[t]
            out[t] = self.cached32[it]
            self.has32[it] = False
        f = np.nonzero(~has)[0]
        if f.size:
            i_f = idx[f]
            v = self.next64(i_f)
            out[f] = (v & _MASK32).astype(_U32)
            self.cached32[i_f] = (v >> _U64(32)).astype(_U32)
            self.has32[i_f] = True
        return out


def _entropy_words(seed: int, round_idx: int,
                   client_ids: np.ndarray) -> Optional[np.ndarray]:
    """(L, 3) uint32 entropy, or None when any word falls outside uint32
    (SeedSequence would split it into multiple words — take the slow path)."""
    s, r = int(seed), int(round_idx)
    if not (0 <= s < 2**32 and 0 <= r < 2**32):
        return None
    cids = np.asarray(client_ids, dtype=np.int64)
    if cids.size and (cids.min() < 0 or cids.max() >= 2**32):
        return None
    ent = np.empty((cids.size, 3), dtype=_U32)
    ent[:, 0] = _U32(s)
    ent[:, 1] = _U32(r)
    ent[:, 2] = cids.astype(_U32)
    return ent


def _vec_permutations(bg: _VecPCG64, sizes_desc: np.ndarray,
                      cap: Optional[int] = None) -> np.ndarray:
    """Fisher-Yates per lane; bit-exact with ``Generator.permutation(n)``
    (masked-rejection ``random_interval``).

    ``sizes_desc`` MUST be sorted descending (lanes active at step i are
    then a prefix, so each step indexes a slice instead of a boolean mask).
    Returns a (L, max_n) int64 matrix; row i holds
    ``permutation(sizes_desc[i])`` left-justified (columns past the size
    are zero). ``cap`` trims the output width (the draws are still consumed
    for the full permutation).
    """
    L = sizes_desc.shape[0]
    max_n = int(sizes_desc[0]) if L else 0
    if L == 0 or max_n == 0:
        return np.zeros((L, cap if cap is not None else max_n),
                        dtype=np.int64)
    arr = np.broadcast_to(np.arange(max_n, dtype=np.int64),
                          (L, max_n)).copy()
    lanes = np.arange(L)
    neg = -sizes_desc  # ascending, for prefix-count searches
    for i in range(max_n - 1, 0, -1):
        # lanes with size > i form the prefix [0, K)
        K = int(np.searchsorted(neg, -i, side="left"))
        if K == 0:
            continue
        mask = _U32((1 << int(i).bit_length()) - 1)
        rows = lanes[:K]
        jv = (bg.next32(rows) & mask).astype(np.int64)
        bad = np.nonzero(jv > i)[0]
        while bad.size:  # masked rejection, redrawing only rejected lanes
            v = (bg.next32(rows[bad]) & mask).astype(np.int64)
            acc = v <= i
            jv[bad[acc]] = v[acc]
            bad = bad[~acc]
        tmp = arr[rows, jv]
        arr[rows, jv] = arr[:K, i]
        arr[:K, i] = tmp
    np.putmask(arr, np.arange(max_n)[None, :] >= sizes_desc[:, None], 0)
    return arr[:, :cap] if cap is not None and cap < max_n else arr[:, : cap if cap is not None else max_n]


def _loop_perm_matrix(seed: int, round_idx: int, client_ids: np.ndarray,
                      sizes: np.ndarray, cap: Optional[int]) -> np.ndarray:
    """Reference path: one real ``default_rng`` per client."""
    L = sizes.shape[0]
    max_n = int(sizes.max()) if L else 0
    width = max_n if cap is None else min(cap, max_n)
    out = np.zeros((L, width), dtype=np.int64)
    for i, (c, n) in enumerate(zip(np.asarray(client_ids), sizes)):
        p = np.random.default_rng(
            [int(seed), int(round_idx), int(c)]).permutation(int(n))
        out[i, : min(int(n), width)] = p[:width]
    return out


_VEC_PERM_OK = True  # latched False after any self-check mismatch


def client_permutations(seed: int, round_idx: int,
                        client_ids: Sequence[int] | np.ndarray,
                        sizes: Sequence[int] | np.ndarray,
                        cap: Optional[int] = None) -> np.ndarray:
    """Per-client dataset shuffles for one round, as one (C, width) matrix.

    Row i is bit-identical to
    ``np.random.default_rng([seed, round_idx, client_ids[i]])
    .permutation(sizes[i])`` (zero-padded past ``sizes[i]``; trimmed to
    ``cap`` columns when given). Vectorized over the cohort — ~100x faster
    than constructing per-client Generators at 10k clients — with a per-call
    spot check against the real numpy stream; any divergence (e.g. a numpy
    upgrade changing stream internals) latches a permanent fallback to the
    reference loop so results never silently change.
    """
    global _VEC_PERM_OK
    cids = np.asarray(client_ids, dtype=np.int64)
    ns = np.asarray(sizes, dtype=np.int64)
    if not _VEC_PERM_OK:
        return _loop_perm_matrix(seed, round_idx, cids, ns, cap)
    ent = _entropy_words(seed, round_idx, cids)
    if ent is None:
        return _loop_perm_matrix(seed, round_idx, cids, ns, cap)
    # sort lanes by size descending so the Fisher-Yates steps touch prefixes
    # (streams are per-lane, so lane order never changes the bits)
    order = np.argsort(-ns, kind="stable")
    bg = _VecPCG64(_seedseq_state64(_seedseq_pool(ent[order])))
    sorted_out = _vec_permutations(bg, ns[order], cap)
    out = np.empty_like(sorted_out)
    out[order] = sorted_out
    # spot-check a few lanes (ends + middle) against the real stream
    L = cids.size
    if L:
        probe = sorted({0, L // 2, L - 1})
        width = out.shape[1]
        ok = True
        for lane in probe:
            n = min(int(ns[lane]), width)
            ref = np.random.default_rng(
                [int(seed), int(round_idx), int(cids[lane])]
            ).permutation(int(ns[lane]))[:n]
            if not np.array_equal(out[lane, :n], ref):
                ok = False
                break
        if not ok:
            _VEC_PERM_OK = False
            warnings.warn(
                "vectorized client-permutation stream diverged from "
                "np.random.default_rng — falling back to the per-client "
                "Generator loop (results stay bit-exact, packing slows "
                "down). This usually means a numpy upgrade changed PCG64/"
                "SeedSequence internals.", RuntimeWarning, stacklevel=2)
            return _loop_perm_matrix(seed, round_idx, cids, ns, cap)
    return out


def client_permutation_list(seed: int, round_idx: int,
                            client_ids: Sequence[int] | np.ndarray,
                            sizes: Sequence[int] | np.ndarray,
                            ) -> List[np.ndarray]:
    """Ragged view of :func:`client_permutations`: one exact-length
    ``permutation(sizes[i])`` array per client (the ``perms=`` shape
    ``FederatedData.pack_client_index`` consumes)."""
    ns = np.asarray(sizes, dtype=np.int64)
    mat = client_permutations(seed, round_idx, client_ids, ns)
    return [mat[i, : int(n)] for i, n in enumerate(ns)]
