"""Shared-prefix KV store for the online serving tier — pure host logic
(the PyTorch port's copy of ``distkeras_tpu.serving.prefix_cache``).

Identical prompt prefixes (system prompts, few-shot headers) recompute
K/V from scratch on every admission; this store eliminates that cost
the way SGLang-style radix caching does, scoped down to the repo's
compile-bucket discipline: entries are EXACT token prefixes, and the
stepper inserts each finished prefill at its full prefix length plus
every power-of-two truncation below it. The pow2 ladder is what makes
unrelated requests that share only a HEADER (not the whole prompt)
find each other — request B's lookup walks stored lengths descending
and lands on the longest pow2 prefix of the shared header, the same
O(log T) granularity the compiled prefill buckets already impose.

No tensors here: values are host numpy per-stage ``(p, H, Dh)`` K/V rows,
the store is LRU-bounded by BYTES (a serving host's real budget), and
every operation is lock-guarded because ``stats()`` is read from
server connection threads while the engine thread admits.

Admission is TWO-TOUCH (TinyLFU-style ghost list): a prefix is only
fetched from the device and stored once it has missed twice, so
one-shot novel prompts — the traffic that can never hit — cost zero
transfers and zero LRU churn; a genuinely shared header is cached from
its second appearance on.

Limits, stated plainly: exact-prefix keying cannot reuse the middle of
a longer cached entry (that takes a radix tree), and cached rows cost
one device->host fetch at insert plus one host->device copy at hit —
the win is real when the reused prefix out-lengths the suffix, which
is exactly the system-prompt / few-shot-header traffic shape.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time

import numpy as np

from distkeras_tpu_torch import faults

# the digest hash width: 4 bytes is plenty for membership HINTS (a
# collision only costs one wasted peer fetch, which the requester's
# ctx-equality check then degrades to a miss) and keeps a 64-entry
# digest under ~700 JSON bytes on every health reply
DIGEST_HASH_BYTES = 4
# how many (most-recently-used) keys a digest advertises: routing only
# needs the hot set, and the cap bounds health-reply growth no matter
# how large the store's byte budget is
DIGEST_CAP = 64


def key_hash(tokens) -> int:
    """The fleet-wide digest hash of one exact token prefix: truncated
    blake2b over the store's canonical key bytes. Stable across
    processes and builds (golden-pinned in tests) — both sides of a
    peer fetch must compute the identical value or page-aware routing
    silently never matches."""
    key = np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
    return int.from_bytes(
        hashlib.blake2b(key, digest_size=DIGEST_HASH_BYTES).digest(),
        "big",
    )


def ladder_hashes(tokens, min_len: int = 8) -> list[tuple[int, int]]:
    """``(prefix_len, key_hash)`` for every pow2 rung of ``tokens`` —
    what the fleet router matches against replica digests to find the
    sibling already holding a prompt's prefix pages. Longest rung
    last (callers walk it reversed for longest-match)."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    return [
        (p, key_hash(tokens[:p]))
        for p in _pow2_ladder(int(tokens.size), min_len=min_len)
    ]


def _pow2_ladder(n: int, min_len: int = 8) -> list[int]:
    """The insert lengths for a prefix of ``n`` positions: every power
    of two in ``[min_len, n]``. Pow2-ONLY keys keep the restore-copy
    program shapes O(log T) (an exact-length key would compile a copy
    program per distinct prompt length) and keep unique-suffix traffic
    from polluting the LRU with entries no other request can ever hit;
    ``min_len`` drops rungs too short to be worth a device round-trip."""
    lens = []
    p = 1
    while p <= n:
        if p >= min_len:
            lens.append(p)
        p <<= 1
    return lens


class PrefixStore:
    """Exact-prefix-keyed, byte-bounded LRU store of per-stage K/V rows.

    ``insert(tokens, kv)`` stores ``kv`` (list of per-stage ``(k, v)``
    numpy arrays, first axis = ``len(tokens)`` cache positions) under
    the token key; ``lookup(tokens)`` returns ``(p, kv)`` for the
    longest stored prefix of ``tokens`` (or None). Hits refresh LRU
    order; inserts evict least-recently-used entries until the byte
    budget holds. An entry that alone exceeds the budget is refused
    (counted ``oversize_rejected``) rather than flushing the store.
    """

    def __init__(self, max_bytes: int = 64 << 20, seen_capacity: int = 4096,
                 registry=None):
        """``registry``: an ``obs.MetricsRegistry`` to register the
        store's counters and size gauges in (the engine passes its own
        so the ``metrics`` verb scrapes them); None builds a private
        one. ``counters`` stays dict-shaped (a ``CounterGroup``)."""
        from distkeras_tpu_torch.obs import MetricsRegistry

        self.max_bytes = int(max_bytes)
        if self.max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.registry = registry if registry is not None else MetricsRegistry()
        # key -> (prefix_len, kv, nbytes); insertion/access order = LRU
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._len_counts: collections.Counter = collections.Counter()
        self._bytes = 0
        # two-touch admission ghost list (TinyLFU-style): a rung is only
        # worth its device->host fetch once it has MISSED twice — a
        # one-shot novel prompt's rungs are marked here and never
        # fetched, so no-reuse traffic costs zero transfers and zero
        # LRU churn. Bounded keys-only LRU.
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self.seen_capacity = int(seen_capacity)
        # content generation: bumped on every insert/evict/clear and
        # NEVER reset (the digest memo keys on it, and a sibling's
        # staleness check needs it monotonic for the store's lifetime)
        self._gen = 0
        self._gen_t = time.monotonic()  # when _gen last moved
        self._digest_memo: tuple[int, dict] | None = None
        self._lock = threading.Lock()
        # the old counter dict as a CounterGroup over typed registry
        # counters (``serving_prefix_cache_<key>``): existing call
        # sites, ``reset_counters``, and the bench's summed snapshots
        # all keep working while the values become scrapeable
        self.counters = self.registry.group(
            "serving_prefix_cache",
            (
                "hits",
                "misses",
                "inserts",
                "evictions",
                "oversize_rejected",
                "hit_tokens",  # prefill positions served from store
            ),
        )
        self.registry.gauge(
            "serving_prefix_cache_entries", fn=lambda: len(self._entries)
        )
        self.registry.gauge(
            "serving_prefix_cache_bytes", fn=lambda: self._bytes
        )

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    # -- read face ----------------------------------------------------------

    def lookup(self, tokens):
        """Longest stored exact prefix of ``tokens``: ``(p, kv)`` with
        ``p <= tokens.size``, or None. Counts one hit or one miss. The
        injection seam stands in for a real fetch failure (a remote
        store, a corrupted entry); the engine degrades it to a miss."""
        faults.fire("prefix_cache.fetch", n=int(np.asarray(tokens).size))
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            for p in sorted(self._len_counts, reverse=True):
                if p > tokens.size:
                    continue
                key = self._key(tokens[:p])
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.counters["hits"] += 1
                    self.counters["hit_tokens"] += p
                    return p, entry[1]
            self.counters["misses"] += 1
            return None

    def coverage(self, tokens) -> int:
        """Longest stored exact prefix length of ``tokens`` — a PROBE,
        not a lookup: no hit/miss counters, no LRU refresh, no fault
        seam. What the peer-fetch path asks before dialing a sibling
        ("is the fetch even worth it?") without polluting the local
        traffic ledger."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            for p in sorted(self._len_counts, reverse=True):
                if p > tokens.size:
                    continue
                if self._key(tokens[:p]) in self._entries:
                    return p
        return 0

    def peek(self, tokens):
        """``lookup`` minus the side effects: longest stored prefix as
        ``(p, kv)`` or None, with no counters, no LRU refresh, and no
        ``prefix_cache.fetch`` seam. The ``kv.fetch`` serving half
        reads through this so remote traffic neither inflates the
        local hit rate nor keeps entries alive that local traffic
        has abandoned."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            for p in sorted(self._len_counts, reverse=True):
                if p > tokens.size:
                    continue
                entry = self._entries.get(self._key(tokens[:p]))
                if entry is not None:
                    return p, entry[1]
        return None

    def digest(self, cap: int = DIGEST_CAP) -> dict:
        """Compact content summary for fleet page-aware routing (rides
        every ``health`` reply): ``gen`` (the monotonic content
        generation), ``n`` (entries), and ``h`` — the sorted truncated
        key hashes of the ``cap`` most-recently-used entries. Routers
        match a prompt's pow2 ladder (:func:`ladder_hashes`) against
        ``h``; a hash hit is a HINT (collisions cost one refused
        fetch), membership of the hot set only. Memoized on ``gen`` so
        idle health polls cost one int compare."""
        with self._lock:
            memo = self._digest_memo
            if memo is not None and memo[0] == self._gen and (
                len(memo[1]["h"]) == min(cap, len(self._entries))
            ):
                return memo[1]
            keys = list(self._entries.keys())[-int(cap):]
            out = {
                "gen": self._gen,
                "n": len(self._entries),
                "h": sorted(
                    int.from_bytes(
                        hashlib.blake2b(
                            k, digest_size=DIGEST_HASH_BYTES
                        ).digest(),
                        "big",
                    )
                    for k in keys
                ),
            }
            self._digest_memo = (self._gen, out)
            return out

    # -- write face ---------------------------------------------------------

    def insert(self, tokens, kv) -> bool:
        """Store ``kv`` under the exact token key; returns False when the
        key already exists (LRU refreshed) or the entry can never fit."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p = tokens.size
        if p < 1:
            return False
        nbytes = sum(int(k.nbytes) + int(v.nbytes) for k, v in kv)
        with self._lock:
            key = self._key(tokens)
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            if nbytes > self.max_bytes:
                self.counters["oversize_rejected"] += 1
                return False
            self._entries[key] = (p, kv, nbytes)
            self._len_counts[p] += 1
            self._bytes += nbytes
            self._gen += 1
            self._gen_t = time.monotonic()
            self.counters["inserts"] += 1
            while self._bytes > self.max_bytes:
                _, (ep, _, eb) = self._entries.popitem(last=False)
                self._len_counts[ep] -= 1
                if not self._len_counts[ep]:
                    del self._len_counts[ep]
                self._bytes -= eb
                self._gen += 1
                self.counters["evictions"] += 1
        return True

    def missing_rungs(self, tokens) -> list[int]:
        """The pow2 ladder lengths of ``tokens`` worth inserting NOW:
        not yet stored AND on their second-or-later miss (two-touch
        admission — the first miss only marks the ghost list). Empty
        list = nothing to fetch from the device. No hit/miss counters,
        no entry-LRU refresh."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        out = []
        with self._lock:
            for p in _pow2_ladder(tokens.size):
                key = self._key(tokens[:p])
                if key in self._entries:
                    continue
                if key in self._seen:
                    self._seen.move_to_end(key)
                    out.append(p)
                else:
                    self._seen[key] = None
                    if len(self._seen) > self.seen_capacity:
                        self._seen.popitem(last=False)
        return out

    def insert_prefixes(self, tokens, kv) -> int:
        """Insert ``tokens``'s pow2 ladder rungs (copies — slices must
        not pin the parent buffer against the byte bound). ``kv`` rows
        may cover just the longest rung. Returns entries added."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        have = kv[0][0].shape[0]
        added = 0
        for p in _pow2_ladder(min(tokens.size, have)):
            sub = (
                kv
                if p == have
                else [(k[:p].copy(), v[:p].copy()) for k, v in kv]
            )
            if self.insert(tokens[:p], sub):
                added += 1
        return added

    # -- maintenance / observability ----------------------------------------

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._len_counts.clear()
            self._seen.clear()
            self._bytes = 0
            self._gen += 1
            self._gen_t = time.monotonic()

    def digest_age(self) -> float:
        """Seconds since the store's content generation last moved —
        how stale the advertised digest can possibly be. Rides the
        ``serving_kv_fabric_digest_age_seconds`` gauge and the dkt_top
        fabric column."""
        return time.monotonic() - self._gen_t

    def reset_counters(self):
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
            out["max_bytes"] = self.max_bytes
            out["enabled"] = True
        looks = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / looks if looks else 0.0
        return out


class DevicePrefixIndex:
    """Block-granular DEVICE-RESIDENT prefix sharing for the paged KV
    cache — the layer in front of the host ladder above.

    Where :class:`PrefixStore` round-trips K/V through host memory
    (device->host fetch at insert, host->device copy at hit, pow2-rung
    granularity), this index maps page-aligned token prefixes straight
    to the page ids that already hold their K/V in the device pool: an
    admission that hits shares those pages into its own page table
    (refcount++, zero bytes moved) and prefills only the divergent
    tail. Granularity is one PAGE (``page_size`` tokens) instead of the
    pow2 ladder, so a 3-page shared header reuses all 3 pages, not just
    the 2-page rung below it.

    Entries hold REFERENCES: inserting a chain retains every page in it
    via the allocator, so the pages outlive the slot that prefilled
    them; evicting an entry (bounded LRU) releases them back. Pages in
    the index are immutable by construction — only FULL pages strictly
    below an admission's prefill frontier are ever registered, and the
    owning slot writes exclusively at or past that frontier.

    The host :class:`PrefixStore` keeps its roles: the serialization /
    transfer format between engines and the fleet router's affinity
    key. This index is intra-engine reuse only (page ids are meaning-
    less outside their pool, and a stepper rebuild clears it).
    """

    def __init__(self, allocator, max_entries: int = 1024):
        self.allocator = allocator
        self.page_size = int(allocator.page_size)
        self.max_entries = int(max_entries)
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        # key -> tuple of page ids covering tokens[:len(pages)*ps];
        # insertion/access order = LRU. One entry per page-multiple
        # prefix length, so lookup can find the LONGEST shared header
        # even when full prompts diverge after it.
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._len_counts: collections.Counter = collections.Counter()
        # page -> how many ENTRIES reference it: a page whose allocator
        # refcount equals this is held by the index alone (reclaimable)
        self._page_refs: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hit_pages = 0
        self.inserts = 0
        self.evictions = 0
        self.reclaims = 0

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def lookup(self, tokens) -> tuple[int, list[int]] | None:
        """Longest page-aligned stored prefix of ``tokens``:
        ``(n_positions, pages)`` with the pages ALREADY retained for
        the caller (refcount bumped under the index lock, so an
        eviction racing the admission cannot free them in between), or
        None. The caller owns the returned references — it must
        ``free`` them on release like pages it allocated."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        with self._lock:
            for m in sorted(self._len_counts, reverse=True):
                if m * ps > tokens.size:
                    continue
                key = self._key(tokens[: m * ps])
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self.hit_pages += m
                    self.allocator.share(entry)
                    return m * ps, list(entry)
            self.misses += 1
            return None

    def insert(self, tokens, pages) -> int:
        """Register ``tokens``'s page-aligned prefixes against the
        slot's (leading) ``pages``: one entry per page-multiple length
        ``1..len(pages)``, each retaining its chain. Returns entries
        added. Over-capacity evicts LRU entries (their refs released)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        n = min(len(pages), tokens.size // ps)
        added = 0
        evict: list[tuple[int, ...]] = []
        with self._lock:
            for m in range(1, n + 1):
                key = self._key(tokens[: m * ps])
                if key in self._entries:
                    self._entries.move_to_end(key)
                    continue
                chain = tuple(int(p) for p in pages[:m])
                self.allocator.share(chain)
                self._entries[key] = chain
                self._len_counts[m] += 1
                self._page_refs.update(chain)
                self.inserts += 1
                added += 1
            while len(self._entries) > self.max_entries:
                evict.append(self._pop_lru_locked())
        for chain in evict:  # release outside the index lock
            self.allocator.free(chain, reason="prefix_index_evict")
        return added

    def _pop_lru_locked(self) -> tuple[int, ...]:
        """Drop the LRU entry's bookkeeping; caller frees the chain
        (outside the lock) and holds the lock here."""
        _, old = self._entries.popitem(last=False)
        self._len_counts[len(old)] -= 1
        if not self._len_counts[len(old)]:
            del self._len_counts[len(old)]
        for p in old:
            self._page_refs[p] -= 1
            if not self._page_refs[p]:
                del self._page_refs[p]
        self.evictions += 1
        return old

    def reclaimable(self) -> int:
        """Pages that would return to the FREE LIST if the whole index
        were dropped: held by the index alone (allocator refcount ==
        this index's reference count). The admission gate counts these
        as available — cached prefixes must never starve live traffic."""
        with self._lock:
            return sum(
                1
                for p, n in self._page_refs.items()
                if self.allocator.refcount(p) == n
            )

    def reclaim(self, n_pages: int) -> int:
        """Evict LRU entries until at least ``n_pages`` pages actually
        return to the free list (or the index is empty) — the pool-
        pressure path: a full pool sheds cached prefixes before it
        refuses an admission. Returns pages freed."""
        freed = 0
        while freed < n_pages:
            with self._lock:
                if not self._entries:
                    break
                chain = self._pop_lru_locked()
                self.reclaims += 1
            freed += self.allocator.free(
                chain, reason="prefix_index_reclaim"
            )
        return freed

    def reset_counters(self) -> None:
        """Zero the hit/miss/insert ledgers (bench pass discipline);
        entries and their references are untouched."""
        with self._lock:
            self.hits = self.misses = self.hit_pages = 0
            self.inserts = self.evictions = self.reclaims = 0

    def clear(self) -> None:
        """Release every entry (e.g. before the pool is torn down)."""
        with self._lock:
            chains = list(self._entries.values())
            self._entries.clear()
            self._len_counts.clear()
            self._page_refs.clear()
        for chain in chains:
            self.allocator.free(chain, reason="prefix_index_clear")

    def stats(self) -> dict:
        with self._lock:
            looks = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / looks if looks else 0.0,
                "hit_pages": self.hit_pages,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "reclaims": self.reclaims,
            }
