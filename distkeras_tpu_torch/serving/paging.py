"""Host-side page allocator for the block-paged KV cache — pure logic
(the PyTorch port's copy of ``distkeras_tpu.serving.paging``).

The paged ``DecodeStepper`` keeps every slot's K/V in fixed-size pages
of a device-resident pool (``(num_pages, page_size, H, Dh)`` per stage)
instead of a contiguous ``(num_slots, seq_len)`` row per slot. This
module owns the HOST half of that design: which pages are free, which
slot (or prefix-index entry) holds which pages, and how many holders
each page has. No tensors here — the device face (the gather-based
attention programs) lives in ``engine.py`` and asks this allocator for
page ids.

Semantics, stated precisely:

- Page ids are indices into the device pools. Page 0 is the NULL
  SENTINEL: it is never allocated, and the device programs use it to
  pad the (pow2-bucketed) page-table rows of inactive or short slots —
  writes to it land nowhere that is read unmasked, so any garbage it
  accumulates is unreachable.
- ``alloc(n)`` hands out ``n`` private pages (refcount 1) or raises a
  typed, retriable :class:`~distkeras_tpu_torch.serving.scheduler.
  PoolExhaustedError` — the serving tier's ``overloaded`` — WITHOUT
  allocating anything (all-or-nothing, so a failed admission has
  nothing to roll back).
- ``share(pages)`` increments refcounts: copy-on-write prefix sharing
  hands the SAME physical pages to another holder. A shared page is
  immutable by convention — the engine only ever writes pages it holds
  with refcount 1 (fresh allocations), which is what makes sharing
  sound without device-side locks.
- ``free(pages)`` decrements; a page returns to the free list when its
  last holder lets go. Freeing a page that has no holders raises
  (double-free is a bookkeeping bug, never silent).
- ``cow(page)`` is the copy-on-write step: allocate one private page,
  drop one reference on the shared source, return the new id. The
  caller copies the device rows; the allocator only moves the
  bookkeeping (and counts it — ``cow_copies`` is how often divergence
  actually cost a copy).

Failure injection: every allocation path fires the ``kv.alloc`` seam
(``faults.py``) BEFORE touching state, so chaos tests can make
exhaustion and allocator failure happen on demand; an armed seam that
raises leaves the allocator exactly as it was.
"""

from __future__ import annotations

import threading

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.serving.scheduler import PoolExhaustedError


class PageAllocator:
    """Free-list page allocator with refcounts (see module docstring).

    Thread-safe: admissions run on the scheduler thread while
    ``stats()`` / the engine's gauges read from server connection
    threads. ``recorder``: an optional ``obs.FlightRecorder`` — page
    grants, frees, CoW copies, and exhaustion land on the tape so a
    post-mortem bundle shows the pool at the moment of a trip.
    """

    def __init__(self, num_pages: int, page_size: int, recorder=None,
                 retry_after_ms: float = 50.0):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1; got {page_size}")
        if self.num_pages < 2:  # page 0 is the null sentinel
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved); got "
                f"{num_pages}"
            )
        self.recorder = recorder
        self.retry_after_ms = float(retry_after_ms)
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are re-issued first
        # (their device rows are the likeliest still resident in cache)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = [0] * self.num_pages
        self._ref[0] = 1  # the sentinel is permanently held
        self.cow_copies = 0
        self.exhaustions = 0

    # -- capacity -----------------------------------------------------------

    @property
    def total_pages(self) -> int:
        """Allocatable pages (the sentinel excluded)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return self.num_pages - 1 - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one holder."""
        with self._lock:
            return sum(1 for r in self._ref[1:] if r > 1)

    def utilization(self) -> float:
        """``pages_in_use / total_pages`` — the ``kv_page_util`` gauge."""
        with self._lock:
            used = self.num_pages - 1 - len(self._free)
        return used / max(1, self.num_pages - 1)

    # -- the allocation faces ----------------------------------------------

    def alloc(self, n: int, reason: str = "admit") -> list[int]:
        """``n`` private pages (refcount 1), all-or-nothing. Raises
        ``PoolExhaustedError`` (typed ``overloaded``, with a
        ``retry_after_ms`` hint) when the free list cannot cover it."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        # the injection seam fires BEFORE any state change: an armed
        # raise leaves the pool exactly as it was
        faults.fire("kv.alloc", n=n, reason=reason)
        with self._lock:
            if n > len(self._free):
                self.exhaustions += 1
                free = len(self._free)
            else:
                pages = self._free[-n:] if n else []
                del self._free[len(self._free) - n:]
                for p in pages:
                    self._ref[p] = 1
                free = None
        if free is not None:
            if self.recorder is not None:
                self.recorder.record(
                    "kv.pool_exhausted", needed=n, free=free,
                    reason=reason,
                )
            raise PoolExhaustedError(
                f"KV page pool exhausted: need {n} pages, {free} free "
                f"of {self.total_pages}",
                retry_after_ms=self.retry_after_ms,
            )
        if self.recorder is not None and n:
            self.recorder.record(
                "kv.page_alloc", n=n, free=len(self._free),
                reason=reason,
            )
        return pages

    def share(self, pages) -> None:
        """Add one holder to each page (CoW prefix sharing / fork)."""
        with self._lock:
            for p in pages:
                if self._ref[p] < 1:
                    raise RuntimeError(
                        f"cannot share unallocated page {p}"
                    )
                self._ref[p] += 1

    def free(self, pages, reason: str = "release") -> int:
        """Drop one holder from each page; pages whose last holder left
        return to the free list. Returns how many actually freed.
        Double-free raises — silent refcount drift is how a 'freed'
        page gets overwritten while another slot still attends it."""
        pages = [int(p) for p in pages]  # materialize: iterated twice
        freed = 0
        with self._lock:
            for p in pages:
                if p == 0 or self._ref[p] < 1:
                    raise RuntimeError(
                        f"double free of page {p} (refcount "
                        f"{self._ref[p]})"
                    )
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
                    freed += 1
            free_now = len(self._free)
        if self.recorder is not None and pages:
            self.recorder.record(
                "kv.page_free", n=len(list(pages)), freed=freed,
                free=free_now, reason=reason,
            )
        return freed

    def cow(self, page: int, reason: str = "fork") -> int:
        """Copy-on-write: allocate a private replacement for shared
        ``page``, transfer this holder's reference to it, return the
        new id. The CALLER copies the device rows old -> new."""
        new = self.alloc(1, reason=reason)[0]
        self.free([page], reason=reason)
        self.note_cow(page, new, reason=reason)
        return new

    def note_cow(self, src: int, dst: int, reason: str = "fork") -> None:
        """Count (and tape) a divergence copy whose page bookkeeping
        the caller already did — e.g. a fork's partial frontier page,
        copied into a freshly allocated private page."""
        with self._lock:
            self.cow_copies += 1
        if self.recorder is not None:
            self.recorder.record(
                "kv.cow_fork", src=int(src), dst=int(dst),
                reason=reason,
            )

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref[int(page)]

    def reset_counters(self) -> None:
        """Zero the cumulative ledgers (``cow_copies``/``exhaustions``
        — bench pass discipline); allocation state is untouched."""
        with self._lock:
            self.cow_copies = 0
            self.exhaustions = 0

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            used = self.num_pages - 1 - len(self._free)
            shared = sum(1 for r in self._ref[1:] if r > 1)
        return {
            "page_size": self.page_size,
            "total_pages": self.num_pages - 1,
            "pages_in_use": used,
            "pages_free": self.num_pages - 1 - used,
            "shared_pages": shared,
            "page_util": round(used / max(1, self.num_pages - 1), 4),
            "cow_copies": self.cow_copies,
            "exhaustions": self.exhaustions,
        }
