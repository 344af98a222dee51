"""Dynamic Reseeding Hash-based Mapping (DRHM) — paper §3.5, Eq. (3)/(4).

Port of ``repro.core.drhm``.  The paper maps partial-product TAGs onto
NeuraMem units with

    H_l(TAG, gamma) = ((TAG << k) >> k) * gamma  mod N          (lower-k bits)
    H_h(TAG, gamma) = ((TAG >> k) << k) * gamma  mod N          (upper-k bits)

reseeding ``gamma`` after every computed row so no sparsity pattern can pin
a hot spot onto one unit.  At pod scale the same function becomes an
ownership map (which shard owns a row, which serving lane owns a request);
its bijective form over padded domains (odd multiplier modulo 2^m) doubles
as a permutation with an exact inverse.

The host parts (``drhm_permutation``, ``coprime_gamma``, the shard and
request-routing planners, ``mix64``) are numpy, bit for bit the
reference's.  The tensor parts (``drhm_hash`` and the mapping variants
kept for the paper's Figure 12/13 comparison) run in torch, which has no
usable uint32 arithmetic: they compute in int64 and keep the low 32 bits
of every product (``_mul32``), which is the reference's uint32
wraparound.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Dict, Union

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def reseed(generator: torch.Generator) -> torch.Tensor:
    """Draw a fresh odd gamma in [3, 2³¹) (odd ⇒ bijective mod any power of
    two) from ``generator``: a 0-d int64 tensor."""
    g = torch.randint(1, 2 ** 30, (), generator=generator, dtype=torch.int64)
    return g * 2 + 1


def _u32(a: Union[torch.Tensor, int]) -> torch.Tensor:
    """``a`` as uint32 values held in int64 (negative ints wrap)."""
    return torch.as_tensor(a).to(torch.int64) & _MASK32


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a · b) mod 2³² for uint32 values in int64, without leaving int64:
    b splits into 16-bit halves, so no partial product reaches 2⁴⁸."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def drhm_hash(tags: torch.Tensor, gamma, n_bins: int,
              k: int = 16) -> torch.Tensor:
    """Lower-k-bit DRHM hash (paper Eq. 3), high-bits variant: the
    product's HIGH bits (Fibonacci multiplicative hashing), as the
    reference takes them, since Eq. 3 as written degenerates on
    power-of-two strides.  int32 bins."""
    t = _u32(tags) & ((1 << k) - 1)
    prod = _mul32(t, _u32(gamma))
    shift = 32 - max(1, int(np.ceil(np.log2(max(n_bins, 2)))))
    return ((prod >> shift) % n_bins).to(torch.int32)


def drhm_hash_upper(tags: torch.Tensor, gamma, n_bins: int,
                    k: int = 16) -> torch.Tensor:
    """Upper-k-bit DRHM hash (paper Eq. 4) — kept for the design-space
    study."""
    t = ((_u32(tags) >> k) << k) & _MASK32
    return (_mul32(t, _u32(gamma)) % n_bins).to(torch.int32)


def drhm_permutation(n: int, gamma: int) -> np.ndarray:
    """Bijective DRHM permutation of [0, n): requires gcd(gamma, n) == 1.

    perm[i] = (i * gamma) mod n.  Host-side (used by shard planners)."""
    assert math.gcd(n, gamma) == 1, f"gamma {gamma} not coprime to {n}"
    idx = np.arange(n, dtype=np.uint64)
    return ((idx * np.uint64(gamma)) % np.uint64(n)).astype(np.int64)


_GAMMA_PRIMES = (2654435761, 40503, 2246822519, 3266489917, 668265263)


def coprime_gamma(n: int, seed: int = 0) -> int:
    """Pick a large multiplier coprime to n (bijectivity for any pad size)."""
    for i in range(len(_GAMMA_PRIMES)):
        g = _GAMMA_PRIMES[(seed + i) % len(_GAMMA_PRIMES)] | 1
        if math.gcd(n, g) == 1:
            return g
    g = 3
    while math.gcd(n, g) != 1:
        g += 2
    return g


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


# ---------------------------------------------------------------------------
# Mapping variants for the paper's Figure 12/13 comparison
# ---------------------------------------------------------------------------

def ring_map(tags: torch.Tensor, n_bins: int, **_) -> torch.Tensor:
    """Round-robin / ring mapping (paper: Takenaka et al.)."""
    return (torch.as_tensor(tags) % n_bins).to(torch.int32)


def modular_map(tags: torch.Tensor, n_bins: int, prime: int = 2654435761,
                **_) -> torch.Tensor:
    """Prime-multiplier modular hashing (paper: Bhullar et al.) — fixed
    seed."""
    t = _mul32(_u32(tags), _u32(prime % (1 << 32)))
    return (t % n_bins).to(torch.int32)


def random_map(tags: torch.Tensor, n_bins: int,
               lookup: torch.Tensor = None, **_) -> torch.Tensor:
    """Ideal random mapping via an explicit lookup table (the paper's
    strawman; materialized for benchmarking only)."""
    assert lookup is not None, "random_map requires a lookup table"
    return torch.as_tensor(lookup)[torch.as_tensor(tags).to(torch.int64)]


def drhm_map(tags: torch.Tensor, n_bins: int, gamma=None, k: int = 16,
             **_) -> torch.Tensor:
    assert gamma is not None
    return drhm_hash(tags, gamma, n_bins, k=k)


MAPPINGS: Dict[str, Callable] = {
    "ring": ring_map,
    "modular": modular_map,
    "random": random_map,
    "drhm": drhm_map,
}


# ---------------------------------------------------------------------------
# Balance statistics (hot-spot metrics for Fig 12/13 + property tests)
# ---------------------------------------------------------------------------

def bin_counts(assignment: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32 load of each of ``n_bins`` bins (ids outside are dropped, as
    ``segment_sum`` drops them)."""
    a = torch.as_tensor(assignment).to(torch.int64).reshape(-1)
    a = a[(a >= 0) & (a < n_bins)]
    return torch.bincount(a, minlength=n_bins).to(torch.int32)


def imbalance(assignment: torch.Tensor, n_bins: int) -> torch.Tensor:
    """max/mean bin load — 1.0 is perfect balance (the paper's hot-spot
    metric)."""
    c = bin_counts(assignment, n_bins).to(torch.float32)
    return c.max() / torch.clamp(c.mean(), min=1e-9)


def _kstats():
    """The kernel-stats registry IF it is already imported: ``core`` sits
    below ``sparse`` in the layer order, so it must not import it; whoever
    reads the stats imported the module first."""
    return sys.modules.get("repro_torch.sparse.stats")


def bin_balance_snapshot(assignment, n_bins: int) -> dict:
    """Host-side bin-load summary (+ a ``drhm.imbalance`` sample): benches
    and the cluster router leave a balance trail per reseed epoch."""
    c = np.bincount(np.asarray(assignment, np.int64), minlength=int(n_bins))
    mean = float(c.mean()) if c.size else 0.0
    snap = {"n_bins": int(n_bins), "max": int(c.max(initial=0)),
            "mean": mean,
            "imbalance": float(c.max(initial=0)) / max(mean, 1e-9)}
    st = _kstats()
    if st is not None:
        st.record_value("drhm.imbalance", snap["imbalance"])
        st.record_value("drhm.bin_max", snap["max"])
    return snap


# ---------------------------------------------------------------------------
# Shard planner: DRHM as a distribution policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DRHMShardPlan:
    """Host-side plan assigning ``n_ids`` row ids to ``n_shards`` equally
    sized shards through the DRHM bijective permutation.

    ``perm[i]`` = position of row i in the hash-shuffled order; shard of
    row i = perm[i] // rows_per_shard.  The permutation is a bijection, so
    every shard holds exactly ``n_pad / n_shards`` rows."""

    gamma: int
    n_ids: int
    n_pad: int
    n_shards: int
    perm: np.ndarray      # (n_pad,) destination slot of each (padded) row id
    inv_perm: np.ndarray  # (n_pad,) row id occupying each slot

    @property
    def rows_per_shard(self) -> int:
        return self.n_pad // self.n_shards

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        return self.perm[ids] // self.rows_per_shard

    def slot_of(self, ids: np.ndarray) -> np.ndarray:
        """Slot within the owning shard."""
        return self.perm[ids] % self.rows_per_shard


def plan_row_sharding(n_ids: int, n_shards: int,
                      gamma: int) -> DRHMShardPlan:
    n_pad = ((max(n_ids, n_shards) + n_shards - 1) // n_shards) * n_shards
    g = gamma | 1
    if math.gcd(n_pad, g) != 1:
        g = coprime_gamma(n_pad, seed=gamma % 5)
    perm = drhm_permutation(n_pad, g)
    st = _kstats()
    if st is not None:
        st.record_count("drhm.shard_plans")
        st.record_value("drhm.shard_n_pad", n_pad)
    return DRHMShardPlan(gamma=g, n_ids=n_ids, n_pad=n_pad,
                         n_shards=n_shards, perm=perm,
                         inv_perm=invert_permutation(perm))


# ---------------------------------------------------------------------------
# Request routing: DRHM one level up (traffic instead of partial products)
# ---------------------------------------------------------------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def mix64(z) -> np.ndarray:
    """splitmix64 finalizer (host numpy, wrapping) — the stream the serving
    sampler draws from (``sparse.sampler._mix64``).  Pre-conditions request
    TAGs before the γ-seeded bin permutation, so adversarial seed values
    cannot choose their bin by construction."""
    z = np.asarray(z, np.uint64)
    with np.errstate(over="ignore"):
        z = z + _SM_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _SM_M1
        z = (z ^ (z >> np.uint64(27))) * _SM_M2
        return z ^ (z >> np.uint64(31))


def route_gamma(seed: int, epoch: int) -> int:
    """The reseed sequence for request routing: γ_k = odd(mix64(seed, k)).
    Odd ⇒ coprime to any power-of-two bin count ⇒ every epoch's bin→lane
    map stays an exact-balance bijection."""
    g = int(mix64(np.uint64(int(seed) % (1 << 32)) * np.uint64(0x51ED2701)
                  ^ np.uint64(int(epoch))))
    return (g & 0xFFFFFFFF) | 1


def plan_request_routing(n_bins: int, n_lanes: int, seed: int = 0,
                         epoch: int = 0) -> DRHMShardPlan:
    """Bin→lane ownership for request routing: the row-sharding
    permutation applied to a padded bin space.  Each lane owns exactly
    ``n_bins / n_lanes`` bins; a new epoch (a new γ) re-permutes which bins
    a lane owns, so a seed stream that piles onto one lane under γ_k
    spreads under γ_{k+1}."""
    st = _kstats()
    if st is not None:
        st.record_count("drhm.route_plans")
        if epoch:
            st.record_count("drhm.route_reseeds")
    return plan_row_sharding(n_bins, n_lanes, route_gamma(seed, epoch))
