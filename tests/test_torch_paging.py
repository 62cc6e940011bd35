"""The port's paged-KV host layer against the JAX package's: the
``PageAllocator``, the ``DevicePrefixIndex`` and the host ``PrefixStore``.

Every case runs one operation sequence (seeded with ``default_rng`` where
it is random) through both packages' classes, records what each returns
— page ids, refcounts, ``stats()``, hits, misses, inserts, evictions,
bytes, ``digest()`` — and holds the two records equal, besides the
semantics the JAX package's own tests pin (``tests/test_paging.py`` and
the ``PrefixStore`` cases of ``tests/test_serving.py``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import distkeras_tpu.faults as jfaults
import distkeras_tpu.obs as jobs
import distkeras_tpu.serving.engine as jengine
import distkeras_tpu.serving.paging as jpaging
import distkeras_tpu.serving.prefix_cache as jprefix
import distkeras_tpu.serving.scheduler as jsched
import distkeras_tpu_torch.faults as pfaults
import distkeras_tpu_torch.obs as pobs
import distkeras_tpu_torch.serving.engine as pengine
import distkeras_tpu_torch.serving.paging as ppaging
import distkeras_tpu_torch.serving.prefix_cache as pprefix
import distkeras_tpu_torch.serving.scheduler as psched

PKGS = {
    "jax": SimpleNamespace(
        PageAllocator=jpaging.PageAllocator,
        DevicePrefixIndex=jprefix.DevicePrefixIndex,
        PrefixStore=jprefix.PrefixStore, prefix=jprefix,
        PoolExhaustedError=jsched.PoolExhaustedError,
        FaultPlan=jfaults.FaultPlan, FlightRecorder=jobs.FlightRecorder,
        bucket_pow2=jengine._bucket_pow2,
    ),
    "torch": SimpleNamespace(
        PageAllocator=ppaging.PageAllocator,
        DevicePrefixIndex=pprefix.DevicePrefixIndex,
        PrefixStore=pprefix.PrefixStore, prefix=pprefix,
        PoolExhaustedError=psched.PoolExhaustedError,
        FaultPlan=pfaults.FaultPlan, FlightRecorder=pobs.FlightRecorder,
        bucket_pow2=pengine._bucket_pow2,
    ),
}


def both(scenario):
    """Run ``scenario(ns)`` against each package; their records must be
    equal. Returns the port's record."""
    got = {name: scenario(ns) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _kv(p, stages=2, nh=2, hd=4, fill=1.0):
    return [
        (
            np.full((p, nh, hd), fill, np.float32),
            np.full((p, nh, hd), -fill, np.float32),
        )
        for _ in range(stages)
    ]


def _refs(a):
    return [a.refcount(p) for p in range(a.num_pages)]


# ------------------------------------------------------------ allocator


def test_alloc_free_roundtrip_and_sentinel():
    def run(ns):
        a = ns.PageAllocator(num_pages=8, page_size=4)
        assert a.total_pages == 7  # page 0 is the null sentinel
        pages = a.alloc(3)
        assert len(pages) == 3 and 0 not in pages
        assert a.pages_in_use == 3 and a.free_pages == 4
        assert all(a.refcount(p) == 1 for p in pages)
        rec = [pages, _refs(a), a.stats()]
        assert a.free(pages) == 3
        assert a.pages_in_use == 0 and a.free_pages == 7
        assert a.utilization() == 0.0
        return rec + [a.alloc(2), a.stats()]

    both(run)


def test_alloc_is_all_or_nothing_and_typed():
    def run(ns):
        a = ns.PageAllocator(num_pages=5, page_size=4, retry_after_ms=17.0)
        first = a.alloc(2)
        with pytest.raises(ns.PoolExhaustedError) as ei:
            a.alloc(3)  # only 2 free
        err = ei.value
        assert err.code == "overloaded"
        assert err.retry_after_ms == 17.0
        assert err.retry_after == pytest.approx(0.017)
        # all-or-nothing: the failed call allocated NOTHING
        assert a.pages_in_use == 2 and a.free_pages == 2
        assert a.exhaustions == 1
        rec = [first, str(err), a.stats()]
        assert a.alloc(2) and a.free_pages == 0
        return rec + [a.stats()]

    both(run)


def test_share_and_free_refcounts():
    def run(ns):
        a = ns.PageAllocator(num_pages=6, page_size=4)
        pages = a.alloc(2)
        a.share(pages)  # a second holder
        assert all(a.refcount(p) == 2 for p in pages)
        assert a.shared_pages == 2
        rec = [pages, _refs(a), a.stats()]
        assert a.free(pages) == 0  # still held by the first holder
        assert a.pages_in_use == 2 and a.shared_pages == 0
        assert a.free(pages) == 2  # last holder: back to the free list
        assert a.pages_in_use == 0
        return rec + [_refs(a), a.stats()]

    both(run)


def test_double_free_raises_and_mutates_nothing():
    def run(ns):
        a = ns.PageAllocator(num_pages=4, page_size=4)
        (p,) = a.alloc(1)
        a.free([p])
        before = (_refs(a), a.stats())
        with pytest.raises(RuntimeError, match="double free"):
            a.free([p])
        with pytest.raises(RuntimeError, match="double free"):
            a.free([0])  # the sentinel is never freeable
        assert (_refs(a), a.stats()) == before
        assert a.free_pages == 3
        return [p, before, a.alloc(3)]

    both(run)


def test_share_unallocated_raises():
    def run(ns):
        a = ns.PageAllocator(num_pages=4, page_size=4)
        (p,) = a.alloc(1)
        a.free([p])
        with pytest.raises(RuntimeError, match="share"):
            a.share([p])
        return [p, _refs(a)]

    both(run)


def test_cow_transfers_the_reference():
    def run(ns):
        a = ns.PageAllocator(num_pages=6, page_size=4)
        (p,) = a.alloc(1)
        a.share([p])  # two holders of p
        new = a.cow(p)  # the second holder privatizes
        assert new != p
        assert a.refcount(p) == 1 and a.refcount(new) == 1
        assert a.cow_copies == 1 and a.pages_in_use == 2
        a.note_cow(p, new)
        return [p, new, _refs(a), a.stats()]

    assert both(run)[3]["cow_copies"] == 2


def test_cow_on_exhausted_pool_is_typed_and_clean():
    def run(ns):
        a = ns.PageAllocator(num_pages=3, page_size=4)
        p1, p2 = a.alloc(2)
        a.share([p1])
        with pytest.raises(ns.PoolExhaustedError):
            a.cow(p1)  # no free page for the copy
        # the failed CoW dropped no reference and copied nothing
        assert a.refcount(p1) == 2 and a.cow_copies == 0
        return [p1, p2, _refs(a), a.stats()]

    both(run)


def test_allocator_records_pool_events():
    def run(ns):
        rec = ns.FlightRecorder(capacity=64)
        a = ns.PageAllocator(num_pages=4, page_size=4, recorder=rec)
        pages = a.alloc(2)
        with pytest.raises(ns.PoolExhaustedError):
            a.alloc(5)
        a.share((pages[0],))
        a.cow(pages[0])
        a.free(pages)
        events = [
            (e["kind"], {k: v for k, v in e.items()
                         if k not in ("kind", "ts", "seq", "t", "mono")})
            for e in rec.snapshot()
        ]
        kinds = [k for k, _ in events]
        for want in ("kv.page_alloc", "kv.pool_exhausted", "kv.page_free",
                     "kv.cow_fork"):
            assert want in kinds, (want, kinds)
        return events

    both(run)


def test_kv_alloc_seam_leaves_the_allocator_as_it_was():
    def run(ns):
        a = ns.PageAllocator(num_pages=8, page_size=4)
        held = a.alloc(3)
        before = (_refs(a), a.stats())
        plan = ns.FaultPlan().arm(
            "kv.alloc", exc=ns.PoolExhaustedError("injected"), times=1
        )
        with plan:
            with pytest.raises(ns.PoolExhaustedError, match="injected"):
                a.alloc(2)
        assert plan.fired("kv.alloc") == 1
        # the seam fires before any state change: not even the
        # exhaustion counter moved
        assert (_refs(a), a.stats()) == before
        return [held, before, a.alloc(2), a.stats()]

    both(run)


def test_property_interleaved_admit_release_fork_accounting():
    """Any seeded interleaving of admit (alloc), fork (share + alloc), CoW
    and release (free): ``pages_in_use`` is the number of distinct pages
    live holders reference and every refcount is its number of holders —
    and both packages hand out the same page ids at every step."""

    def run(ns):
        rng = np.random.default_rng(0)
        a = ns.PageAllocator(num_pages=64, page_size=4)
        holders: list[list[int]] = []
        log = []
        for _ in range(400):
            op = int(rng.integers(0, 4))
            if op == 0:  # admit: fresh private pages
                n = int(rng.integers(1, 6))
                try:
                    holders.append(a.alloc(n))
                    log.append(("alloc", list(holders[-1])))
                except ns.PoolExhaustedError:
                    assert a.free_pages < n
                    log.append(("exhausted", n))
            elif op == 1 and holders:  # fork: share a prefix + fresh tail
                src = holders[int(rng.integers(0, len(holders)))]
                k = int(rng.integers(0, len(src) + 1))
                shared = src[:k]
                a.share(shared)
                try:
                    fresh = a.alloc(int(rng.integers(0, 3)))
                except ns.PoolExhaustedError:
                    a.free(shared)
                    continue
                holders.append(list(shared) + fresh)
                log.append(("fork", list(holders[-1])))
            elif op == 2 and holders:  # CoW-privatize one shared page
                h = holders[int(rng.integers(0, len(holders)))]
                shared = [p for p in h if a.refcount(p) > 1]
                if shared:
                    old = shared[0]
                    try:
                        new = a.cow(old)
                    except ns.PoolExhaustedError:
                        continue
                    h[h.index(old)] = new
                    log.append(("cow", old, new))
            elif op == 3 and holders:  # release a holder
                a.free(holders.pop(int(rng.integers(0, len(holders)))))
            live, refs = set(), {}
            for h in holders:
                live.update(h)
                for p in h:
                    refs[p] = refs.get(p, 0) + 1
            assert a.pages_in_use == len(live)
            for p, r in refs.items():
                assert a.refcount(p) == r, f"page {p}"
        log.append(("final", _refs(a), a.stats()))
        for h in holders:
            a.free(h)
        assert a.pages_in_use == 0 and a.free_pages == a.total_pages
        return log

    both(run)


# --------------------------------------------------- pow2 table buckets


def test_pow2_bucketing_boundaries():
    """Page-table buckets round to powers of two at the exact boundaries,
    clamped to the cap — the step's and the chunk's program keys."""

    def run(ns):
        cap = 1 << 10
        got = [ns.bucket_pow2(n, cap) for n in (0, 1, 2, 3, 4, 5, 7, 8, 9)]
        assert got == [0, 1, 2, 4, 4, 8, 8, 8, 16]
        assert ns.bucket_pow2(1000, 64) == 64  # clamped to the cap
        return got + [ns.bucket_pow2(n, 32) for n in range(0, 70)]

    both(run)


# ------------------------------------------------- device prefix index


def _mk(ns, n_pages=32, ps=4, max_entries=8):
    a = ns.PageAllocator(num_pages=n_pages, page_size=ps)
    return a, ns.DevicePrefixIndex(a, max_entries=max_entries)


def test_index_lookup_longest_page_aligned_prefix():
    def run(ns):
        a, idx = _mk(ns)
        toks = np.arange(20, dtype=np.int32)
        pages = a.alloc(4)  # covers 16 positions at ps=4
        idx.insert(toks[:17], pages)  # target 17 -> 4 full pages
        # a prompt sharing 11 positions hits the 2-page (8-token) chain
        probe = np.concatenate([toks[:11], np.array([99, 98], np.int32)])
        n, got = idx.lookup(probe)
        assert n == 8 and got == pages[:2]
        # the hit RETAINED the chain for the caller
        assert a.refcount(pages[0]) >= 3  # owner + index + caller
        rec = [pages, got, _refs(a)]
        a.free(got)
        assert idx.stats()["hits"] == 1
        return rec + [idx.stats(), a.stats()]

    both(run)


def test_index_holds_pages_across_owner_release():
    def run(ns):
        a, idx = _mk(ns)
        toks = np.arange(12, dtype=np.int32)
        pages = a.alloc(3)
        idx.insert(toks, pages)
        a.free(pages)  # the admitting slot evicts
        assert a.pages_in_use == 3  # the index's references keep them
        assert idx.reclaimable() == 3
        n, got = idx.lookup(toks)
        assert n == 12
        assert idx.reclaimable() == 0  # the caller holds them too now
        a.free(got)
        idx.clear()
        assert a.pages_in_use == 0  # every reference accounted for
        return [pages, got, idx.stats()]

    both(run)


def test_index_eviction_releases_references():
    def run(ns):
        a, idx = _mk(ns, n_pages=64)
        for i in range(12):  # 12 one-page entries into an 8-entry index
            toks = (np.arange(4) + 100 * i).astype(np.int32)
            pages = a.alloc(1)
            idx.insert(toks, pages)
            a.free(pages)  # the owner releases; the index holds them
        st = idx.stats()
        assert st["entries"] == 8 and st["evictions"] == 4
        assert a.pages_in_use == 8  # evicted chains went back
        rec = [st, _refs(a)]
        idx.clear()
        assert a.pages_in_use == 0
        return rec

    both(run)


def test_index_insert_registers_every_page_multiple():
    """A 3-page insert is findable at 1-, 2- and 3-page granularity, and
    a sub-page probe never hits."""

    def run(ns):
        a, idx = _mk(ns)
        toks = np.arange(12, dtype=np.int32)
        pages = a.alloc(3)
        assert idx.insert(toks, pages) == 3
        hits = []
        for m in (3, 2, 1):
            n, got = idx.lookup(toks[: m * 4])
            assert n == m * 4, m
            hits.append(got)
            a.free(got)
        assert idx.lookup(toks[:3]) is None
        return [pages, hits, idx.stats()]

    both(run)


def test_index_reclaim_under_pressure_matches():
    """Seeded inserts over a small pool, then reclaim: the same entries
    go, the same pages come back, in both packages."""

    def run(ns):
        rng = np.random.default_rng(3)
        a, idx = _mk(ns, n_pages=40, max_entries=64)
        for _ in range(6):
            n = int(rng.integers(1, 5))
            toks = rng.integers(0, 8192, n * 4 + 1).astype(np.int64)
            pages = a.alloc(n)
            idx.insert(toks[:-1], pages)
            a.free(pages)
        rec = [idx.reclaimable(), a.stats(), idx.stats()]
        freed = idx.reclaim(5)
        assert freed >= 5
        rec += [freed, idx.reclaimable(), a.stats(), idx.stats(),
                _refs(a)]
        return rec

    both(run)


# ------------------------------------------------------ host prefix store


def test_prefix_store_hit_miss_and_longest_prefix():
    def run(ns):
        ps = ns.PrefixStore(max_bytes=1 << 20)
        toks = np.arange(100, 112, dtype=np.int32)
        assert ps.lookup(toks) is None  # miss on empty
        ps.insert(toks[:4], _kv(4, fill=4.0))
        ps.insert(toks[:8], _kv(8, fill=8.0))
        p, kv = ps.lookup(toks)  # the longest stored prefix wins
        assert p == 8 and kv[0][0][0, 0, 0] == 8.0
        p2, _ = ps.lookup(toks[:6])  # the len-8 entry is too long
        assert p2 == 4
        assert ps.lookup(np.arange(50, 62, dtype=np.int32)) is None
        st = ps.stats()
        assert st["hits"] == 2 and st["misses"] == 2
        assert st["hit_tokens"] == 12 and st["entries"] == 2
        assert 0 < st["hit_rate"] < 1
        return [p, p2, st, ps.digest()]

    both(run)


def test_prefix_store_lru_eviction_and_byte_bound():
    def run(ns):
        entry_bytes = sum(k.nbytes + v.nbytes for k, v in _kv(4))
        ps = ns.PrefixStore(max_bytes=int(entry_bytes * 2.5))  # fits 2
        a = np.arange(0, 4, dtype=np.int32)
        b = np.arange(10, 14, dtype=np.int32)
        c = np.arange(20, 24, dtype=np.int32)
        ps.insert(a, _kv(4))
        ps.insert(b, _kv(4))
        assert ps.lookup(a) is not None  # refresh a: b is now LRU
        ps.insert(c, _kv(4))  # over budget -> evicts b
        assert ps.stats()["evictions"] == 1
        assert ps.lookup(b) is None
        assert ps.lookup(a) is not None and ps.lookup(c) is not None
        assert ps.stats()["bytes"] <= ps.max_bytes
        # an entry that can never fit is refused, not a store flush
        assert not ps.insert(np.arange(64, dtype=np.int32), _kv(64))
        assert ps.stats()["oversize_rejected"] == 1
        assert ps.stats()["entries"] == 2
        return [ps.stats(), ps.digest()]

    both(run)


def test_prefix_store_two_touch_admission():
    """``missing_rungs`` is two-touch admission: a rung's first miss only
    marks the ghost list, the second asks for the insert; the ghost list
    is bounded."""

    def run(ns):
        ps = ns.PrefixStore(max_bytes=1 << 20)
        toks = np.arange(300, 320, dtype=np.int32)  # rungs 8, 16
        r1 = ps.missing_rungs(toks)
        r2 = ps.missing_rungs(toks)
        assert r1 == [] and r2 == [8, 16]
        added = ps.insert_prefixes(toks, _kv(toks.size))
        assert ps.missing_rungs(toks) == []  # stored now
        ps2 = ns.PrefixStore(max_bytes=1 << 20, seen_capacity=4)
        a = np.arange(0, 8, dtype=np.int32)
        assert ps2.missing_rungs(a) == []
        for i in range(1, 4):  # 3 floods x 2 rungs = 6 marks > 4
            ps2.missing_rungs(np.arange(i * 50, i * 50 + 16,
                                        dtype=np.int32))
        assert ps2.missing_rungs(a) == []  # a's mark was evicted
        return [r2, added, ps.stats(), ps.digest()]

    both(run)


def test_prefix_store_pow2_ladder_shares_headers():
    """``insert_prefixes`` stores the pow2 truncations, so two prompts
    sharing only a HEADER still find each other."""

    def run(ns):
        ps = ns.PrefixStore(max_bytes=1 << 20)
        header = np.arange(200, 216, dtype=np.int32)  # 16 tokens
        a = np.concatenate([header, [7, 8, 9]]).astype(np.int32)
        added = ps.insert_prefixes(a, _kv(a.size))
        b = np.concatenate([header, [1, 2, 3, 4]]).astype(np.int32)
        p, _ = ps.lookup(b)
        assert p == 16
        assert ps.insert_prefixes(a, _kv(a.size)) == 0
        return [added, p, ps.stats(), ps.digest()]

    both(run)


def test_prefix_store_fetch_seam_fires_in_lookup():
    def run(ns):
        ps = ns.PrefixStore(max_bytes=1 << 20)
        toks = np.arange(40, dtype=np.int32)
        ps.insert_prefixes(toks, _kv(40))
        with ns.FaultPlan().arm("prefix_cache.fetch", times=1) as plan:
            with pytest.raises(Exception):
                ps.lookup(toks)
            p, _ = ps.lookup(toks)  # the seam fired once
        assert plan.fired("prefix_cache.fetch") == 1 and p == 32
        return [p, ps.stats()]

    both(run)


def test_key_hash_digest_and_ladder_equal_across_packages():
    """``key_hash`` hashes the int32 token bytes, so the port's int64
    context rows and JAX's int32 ones give the same value, and a store
    filled the same way advertises the same ``digest()``."""
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 8192, 300)
    for n in (1, 7, 64, 255, 300):
        want = jprefix.key_hash(toks[:n].astype(np.int32))
        assert pprefix.key_hash(toks[:n].astype(np.int64)) == want
        assert pprefix.key_hash(toks[:n].astype(np.int32)) == want
    assert pprefix.ladder_hashes(toks) == jprefix.ladder_hashes(toks)
    assert pprefix._pow2_ladder(300) == jprefix._pow2_ladder(300)

    def run(ns):
        ps = ns.PrefixStore(max_bytes=1 << 16)
        for i in range(12):
            t = rng_toks[i]
            ps.missing_rungs(t)
            ps.insert_prefixes(t, _kv(t.size, nh=1, hd=2))
        return [ps.digest(), ps.digest(cap=3), ps.stats()]

    rng_toks = [np.random.default_rng(i).integers(0, 8192, 40 + 9 * i)
                for i in range(12)]
    got = both(run)
    assert got[0]["n"] > 0 and len(got[1]["h"]) == 3
