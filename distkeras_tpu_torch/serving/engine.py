"""The serving runtime's device face (PyTorch port of
``distkeras_tpu.serving.engine``: the dense bank, the block-paged pool,
the prefix cache and speculative decode).

- ``DecodeStepper``: a bank of ``num_slots`` sequence slots over a causal
  LM. Per slot: one row of the (B, T) token buffer and either one row of
  each block's (B, T, H, Dh) K/V caches (dense) or a page table into each
  block's (num_pages, page_size, H, Dh) pool (``paged=True``), plus a
  host-side length. Admission restores the longest prefix-cache hit (the
  host ``PrefixStore`` ladder, or — paged — shared pages of the
  ``DevicePrefixIndex``), then prefills the rest of positions
  ``0..len-2`` (whole prompt, or chunk by chunk under the scheduler's
  budget); ``step(active)`` embeds each slot's last token at its OWN
  position, attends one row against its caches or gathered pages and
  appends the greedy or sampled token — inactive slots freeze.
  ``step_async`` enqueues the same step and hands back a handle whose
  ``collect()`` is the one host sync. ``fork_slot`` (paged) makes a slot a
  copy-on-write continuation of another (shared history pages, one page
  copy) for n > 1 completions; ``swap_out``/``swap_in`` move a slot's
  state to the host and back for a QoS preemption. With a draft source
  (``speculative=``: ``NgramDrafter`` or ``ModelDrafter``) the scheduler
  drives ``spec_step`` instead: up to ``draft_k`` proposals per slot, one
  verify call over the ``draft_k + 1`` candidate positions, and 1 to
  ``draft_k + 1`` accepted tokens per slot. Greedy slot output is the solo
  ``CachedSequenceGenerator`` decode, token for token, on every admission
  path and with or without a drafter; a sampled stream is the plain
  sampled stream. The caches, pools and the token buffer are updated in
  place. The ``stepper.step``/``stepper.prefill``/``stepper.verify``
  fault seams fire before any work, and a failed call advances nothing;
  a paged admission the pool cannot cover raises the typed
  ``PoolExhaustedError`` before any slot state changes.
- ``ServingEngine``: continuous-batching generate plus windowed batch
  scoring (``predict``), driven by a scheduler thread (the overlapped loop
  by default) and watched by a supervisor thread that restarts a dead or
  wedged scheduler with a rebuilt stepper, with the JAX engine's books: a
  metrics ``registry`` (the batcher's counters, occupancy gauges, per-phase
  latency histograms, the overlap ledger), a ``compile_ledger``, a flight
  ``recorder``, a metrics ``history`` ring, optional ``slos``, a
  ``trace_collector`` and a JSONL ``metrics_path``; ``metrics_snapshot``/
  ``timeseries``/``postmortem`` answer the server's verbs. ``from_bundle``
  boots from a quantized serving bundle.

Every LayerNorm on these paths goes through ``LayerNorm.forward``, so with
``attach_fused_layernorm`` the CUDA LayerNorm kernel runs on every
prefill, chunk and decode step (2 per block + the final one). A model
carrying an attention hook (``attach_flash_attention``) is refused by the
cached generator, and the engine then serves ``predict`` only — JAX's
behaviour, kept.

Every LayerNorm of the verify goes through the same hook, 2 per block +
the final one per window (and per draft step of a hooked draft model).

``kv_dtype`` (bf16 or f16 caches and pools) rounds K/V into the cache
dtype on every write and reads them back as f32, so attention accumulates
in f32 as in the JAX package; host K/V rows (prefix-store entries, swap
state) keep the cache dtype, a bf16 row as its uint16 bit pattern (numpy
has no bfloat16), 2 bytes an element, the same bits as JAX's.

A request's ``sampling.grammar`` makes its slot constrained: the stepper
compiles a ``sampling.TokenMaskCompiler`` state at admission, builds the
(B, V) additive ``0 / -inf`` mask of the next position from it before
each step, and runs the masked variant of the program (``step[masked]``,
``paged_step[pbt,masked]``, ``verify[c,masked]``,
``paged_verify[c,pbt,masked]``), which adds it to the logits before
temperature, top-k and top-p; an all-``-inf`` row forces EOS instead.
Constrained slots never draft, and their state advances at collect,
before the next dispatch.

Disaggregation: ``ServingEngine(role="prefill")`` admits and prefills a
prompt and hands back the slot as a ``kv_transfer`` frame (``prefill``);
``role="decode"`` (or a unified engine) admits such a frame through
``swap_in`` and decodes it (``resume``), token-identical to an
uninterrupted decode on one engine. Each engine carries a random 32-bit
``kv_epoch`` (new on every supervisor restart) and a ``PeerFabric``:
``submit(kv_peers=)`` pulls a sibling's cached prefix rows before
admission, ``serve_prefix`` answers such a pull from the host prefix
store, refusing a stale epoch typed.

Tensor-parallel decode: ``ServingEngine(mesh="tp:N")`` (and
``DecodeStepper(mesh=)``) serves one model over a ``ServingMesh``
(``parallel.mesh.serving_mesh``) from ONE process and one scheduler
thread, as the JAX engine drives N devices from one controller. The
stepper keeps its own per-shard copies of the split weights
(``parallel.tensor_parallel.shard_decode_params``: attention heads and
the MLP in Megatron's column/row pairs, MoE experts on their expert axis)
and one K/V tensor per shard and block, ``num_heads / N`` heads each.
Every program runs its replicated work once on the home device (the
context rows, the sampler, the embedding, every LayerNorm, the head) and
its sharded work once per shard on the shard's device (q/k/v, the K/V
writes and the attention over the shard's heads, the row products), the
row products summed on home in shard order. Host bookkeeping (page
tables, refcounts, prefix entries, sampler state) does not change with
the mesh, and host K/V rows (prefix-store entries, swaps, DKTX frames)
keep the full-head layout, so they cross geometries. Greedy output equals
solo decode token for token on every admission path.

Not ported yet (and absent from the signatures, so passing one fails
loudly): CUDA graphs around the decode step.
"""

from __future__ import annotations

import math
import os
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.kernels.build import (
    add_build_observer,
    remove_build_observer,
)
from distkeras_tpu_torch.networking import RetryPolicy
from distkeras_tpu_torch.obs import (
    FAST_WINDOW,
    CompileLedger,
    FlightRecorder,
    MetricsHistory,
    MetricsRegistry,
    SloEvaluator,
    TraceCollector,
    dump_postmortem,
    latest_postmortem,
)
from distkeras_tpu_torch.parallel.mesh import serving_mesh
from distkeras_tpu_torch.parallel.tensor_parallel import (
    decode_param_specs,
    shard_decode_params,
)
from distkeras_tpu_torch.predictors import (
    CachedSequenceGenerator,
    ModelPredictor,
    resolve_kv_dtype,
)
from distkeras_tpu_torch.serving import kv_transfer
from distkeras_tpu_torch.serving.resilience import as_shed_gate
from distkeras_tpu_torch.serving import sampling as _sp
from distkeras_tpu_torch.serving.paging import PageAllocator
from distkeras_tpu_torch.serving.prefix_cache import (
    DevicePrefixIndex,
    PrefixStore,
)
# the tenant-label bound, defined once in ``qos`` (the engine's latency
# histograms and the scheduler's counters fold by it)
from distkeras_tpu_torch.serving.qos import (  # noqa: F401 — re-exported
    MAX_TENANT_LABELS,
    OTHER_TENANTS,
    fold_tenant,
)
from distkeras_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    EngineStoppedError,
    InternalError,
    PeerError,
    ServeRequest,
    ServingError,
    StaleEpochError,
    WindowedBatcher,
    WrongRoleError,
)
from distkeras_tpu_torch.utils.device import check_model_device


def _bucket_pow2(n: int, cap: int) -> int:
    """Round ``n`` up to a power of two, clamped to ``cap`` — the JAX
    package's program-key bucket, which the compile ledger's keys use. n
    <= 0 stays 0: a one-token prompt has nothing to prefill."""
    if n <= 0:
        return 0
    return min(1 << (n - 1).bit_length(), cap)


def host_rows(t: torch.Tensor) -> np.ndarray:
    """K/V rows as host numpy in their own dtype: f32 and f16 as
    themselves, bf16 as its uint16 bit pattern (numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def rows_tensor(a: np.ndarray, dtype=None) -> torch.Tensor:
    """Host K/V rows (``host_rows``' format) as a CPU tensor, bit for bit,
    cast to ``dtype`` when given."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if dtype is None or t.dtype == dtype else t.to(dtype)


class _WarmScope(threading.local):
    """Per-thread "inside a stepper warmup" depth: a kernel build that a
    warmup triggers is recorded with ``trigger="warmup"``. ``ledger``: the
    compile ledger of the engine this thread works for (its scheduler
    loop, its predict window, a stepper warm-up): a kernel build is a
    process-wide event that every engine hears, and it is a mint on the
    ledger of the engine whose thread ran it only — one replica's build
    is never another replica's storm."""

    depth = 0
    ledger = None


_WARM_SCOPE = _WarmScope()


def in_warmup() -> bool:
    """True on a thread that is inside ``DecodeStepper.warmup`` or
    ``warm_prefill_buckets``."""
    return _WARM_SCOPE.depth > 0


class NgramDrafter:
    """Model-free draft source: prompt lookup. Proposes the ``k`` tokens
    that followed the most recent earlier occurrence of the sequence's
    current suffix (longest match first, ``ngram_max`` down to
    ``ngram_min`` tokens) — a pure host function of each slot's sequence
    so far, with no model and no device state. A slot whose suffix recurs
    nowhere proposes nothing, and an iteration where no slot proposes
    falls back to the plain step.

    Accidental matches in incompressible traffic drag every active slot
    through a verify to accept one token, so the drafter throttles on
    feedback (``sync``): a slot whose proposals were all rejected
    ``cold_after`` windows in a row stops proposing for ``retry_every``
    windows, then probes again."""

    name = "ngram"
    wants_sequences = True  # the batcher passes prompt+emitted per slot

    def __init__(self, ngram_max=3, ngram_min=2, k=None, cold_after=3,
                 retry_every=16):
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max; got "
                f"{ngram_min}, {ngram_max}"
            )
        self.cold_after = int(cold_after)
        self.retry_every = int(retry_every)
        self._streak = None  # per-slot consecutive all-rejected windows
        self._pause = None  # per-slot windows left to sit out
        self._proposed = None  # slots that proposed in the live round
        del k  # accepted for symmetry; the stepper passes k per call

    def bind(self, stepper):
        b = stepper.num_slots
        self._streak = np.zeros(b, np.int64)
        self._pause = np.zeros(b, np.int64)
        self._proposed = np.zeros(b, bool)

    def warmup(self):
        pass

    def admit(self, slot, prompt):
        self._streak[slot] = 0
        self._pause[slot] = 0

    def release(self, slot):
        self._streak[slot] = 0
        self._pause[slot] = 0

    def invalidate(self, mask):
        pass

    def sync(self, active, toks, counts, lens0):
        """Acceptance feedback: ``counts[i] - 1`` of slot i's proposals
        were accepted this window. All-rejected windows build the throttle
        streak; any acceptance resets it."""
        del toks, lens0
        judged = np.asarray(active, bool) & self._proposed
        rejected = judged & (np.asarray(counts) <= 1)
        self._streak[judged & ~rejected] = 0
        self._streak[rejected] += 1
        cold = self._streak >= self.cold_after
        self._pause[cold] = self.retry_every
        self._streak[cold] = 0

    def propose(self, active, k, seqs):
        """(B, k) int32 proposals and (B,) counts. Slots without an
        earlier occurrence of their suffix (or without a sequence), and
        slots sitting out a pause, get count 0. ``seqs[i]`` is a 1-D
        sequence or a zero-copy ``(prompt, emitted)`` pair."""
        b = active.shape[0]
        dtoks = np.zeros((b, k), np.int32)
        dcnt = np.zeros((b,), np.int32)
        self._proposed[:] = False
        if seqs is None:
            return dtoks, dcnt
        from numpy.lib.stride_tricks import sliding_window_view

        for i in np.flatnonzero(active):
            if self._pause[i] > 0:
                self._pause[i] -= 1
                continue
            s = seqs[i]
            if s is None:
                continue
            if isinstance(s, tuple):
                prompt, toks = s
                s = (
                    np.concatenate([prompt, np.asarray(toks, prompt.dtype)])
                    if len(toks) else np.asarray(prompt)
                )
            if s.size < self.ngram_min + 1:
                continue
            ln = s.size
            for n in range(min(self.ngram_max, ln - 1),
                           self.ngram_min - 1, -1):
                pat = s[ln - n:]
                # windows ending before the suffix itself; the LAST
                # earlier occurrence wins (most recent context)
                hits = np.flatnonzero(
                    (sliding_window_view(s, n)[: ln - n] == pat).all(1)
                )
                if hits.size:
                    j = int(hits[-1])
                    cont = s[j + n : j + n + k]
                    dtoks[i, : cont.size] = cont
                    dcnt[i] = cont.size
                    self._proposed[i] = True
                    break
        return dtoks, dcnt


class ModelDrafter:
    """Draft source backed by a small draft LM: the draft model runs its
    own quiet slot bank (a nested plain ``DecodeStepper`` with the same
    slots, scratch-padded so over-draft writes land past the real
    positions, its fault seams silent and its programs off the compile
    ledger), admitted and released in lockstep with the target's slots.
    Each round proposes ``k`` greedy draft tokens through ``k + 1`` draft
    steps — the extra step writes the draft's K/V at the last proposed
    position, so a fully accepted window leaves no hole in the draft's
    cache — and ``sync`` rolls the draft's context row and length back to
    the accepted sequence after the verify. A draft-side failure never
    fails a request: the slot stops proposing until its next admission.
    The draft's prompt prefill runs whole, on the scheduler thread, the
    iteration its slot turns decodable (a draft worth serving is many
    times smaller than the target)."""

    name = "draft_lm"
    wants_sequences = False

    def __init__(self, model):
        self.model = model
        self._st = None
        self._valid = None

    def bind(self, stepper):
        """(Re)build the nested draft bank against ``stepper``'s geometry
        — called from ``DecodeStepper.__init__``, the supervisor's
        rebuilds included."""
        tgt = stepper
        if self.model.input_shape[0] != tgt.max_len:
            raise ValueError(
                "draft and target must be built to the same sequence "
                f"length; got {self.model.input_shape[0]} vs {tgt.max_len}"
            )
        self._st = DecodeStepper(
            self.model, num_slots=tgt.num_slots, temperature=0.0,
            device=tgt.device, kv_dtype=tgt.kv_dtype,
            scratch=_bucket_pow2(tgt.draft_k, tgt.max_len) + 2, _quiet=True,
        )
        if self._st._gen._emb.vocab_size != tgt._gen._emb.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary; got "
                f"{self._st._gen._emb.vocab_size} vs "
                f"{tgt._gen._emb.vocab_size}"
            )
        self._st.on_compile = lambda: (
            tgt.on_compile() if tgt.on_compile is not None else None
        )
        self._valid = np.zeros(tgt.num_slots, bool)

    def warmup(self):
        self._st.warmup()

    def admit(self, slot, prompt):
        self._st.admit(slot, prompt)
        self._valid[slot] = True

    def release(self, slot):
        self._valid[slot] = False
        self._st.release(slot)

    def invalidate(self, mask):
        """A draft-side failure: these slots stop proposing (the engine
        decodes them one token per iteration)."""
        self._valid[np.asarray(mask, bool)] = False

    def propose(self, active, k, seqs):
        del seqs
        act = np.asarray(active, bool) & self._valid
        b = act.shape[0]
        dtoks = np.zeros((b, k), np.int32)
        if not act.any():
            return dtoks, np.zeros((b,), np.int32)
        toks = [self._st.step(act) for _ in range(k + 1)]
        for j in range(k):  # the k+1-th step's proposal is discarded
            dtoks[act, j] = np.asarray(toks[j])[act]
        return dtoks, np.where(act, k, 0).astype(np.int32)

    def sync(self, active, toks, counts, lens0):
        """Roll the draft bank back to the verified truth: the accepted
        tokens over the draft's proposals (only the target's correction
        differs) and the draft lengths reset to the target's."""
        act = np.asarray(active, bool) & self._valid
        if not act.any():
            return
        self._st.write_segment(act, toks, counts, lens0)
        self._st._lens[act] = lens0[act] + counts[act]


class _InflightStep:
    """One enqueued-but-uncollected decode step: the stepper, the active
    mask it was issued with, and its (B,) token vector. On the card the
    vector is copied into a pinned host buffer behind the step on the
    current stream, and an event is recorded after the copy: ``ready()``
    is ``event.query()`` and ``collect()`` is ``event.synchronize()`` and
    a read of the buffer. On CPU tensors the step already ran, so
    ``ready()`` is True. ``collect()`` also applies the host bookkeeping
    a successful step implies (the ``_lens``/``_spos`` advance), so
    nothing advances until the step is known good. Single consumer,
    collect once (the scheduler thread)."""

    __slots__ = ("_stepper", "active", "_host", "_event")

    def __init__(self, stepper, active, toks):
        self._stepper = stepper
        self.active = active
        self._event = None
        if toks.is_cuda:
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = toks

    def ready(self) -> bool:
        """True when ``collect`` would not block."""
        if self._event is None or self._host is None:
            return True
        return self._event.query()

    def collect(self) -> np.ndarray:
        """The step's tokens (THE host sync point), then the host
        bookkeeping. Whatever the device deferred raises here, and then
        nothing has advanced — the "a failed call advanced nothing"
        contract the blame probes rely on."""
        if self._host is None:
            raise RuntimeError("decode step already collected")
        if self._event is not None:
            self._event.synchronize()
        toks = self._host.numpy().copy()
        self._host = self._event = None
        st, active = self._stepper, self.active
        st._lens[active] = np.minimum(st._lens[active] + 1, st._lens_cap)
        # the RNG counter mirrors the length discipline: replay through
        # blame probes is this line
        st._spos[active] += 1
        if st._grammar:
            # before the next dispatch builds its mask from this state
            st._advance_grammar(toks.reshape(-1, 1), np.where(active, 1, 0))
        return toks


class DecodeStepper:
    """Slot-bank decode over a ``zoo.transformer_lm``-shaped model, on a
    dense bank (per slot one (T, H, Dh) row of each block's caches) or on
    a block-paged pool.

    ``prefix_cache``: an optional ``prefix_cache.PrefixStore``. When set,
    ``begin_admit`` restores the longest cached prefix's K/V rows into the
    slot before any prefill compute (a bucketed host->device copy, program
    key ``restore`` dense or ``paged_restore[pbk,pbt]`` paged), and every
    finished prefill publishes its missing pow2 ladder rungs (two-touch
    admission: the device->host fetch runs only for rungs missed before,
    and only up to the longest). A failing lookup or insert degrades to a
    miss: ``prefix_fetch_failures`` counts it, the recorder tapes its
    exception class, the request never sees it.

    ``paged``: per block a ``(num_pages, page_size, H, Dh)`` K/V pool in
    place of the dense caches, host page tables per slot
    (``paging.PageAllocator`` owns the free list and refcounts, page 0 is
    the null sentinel) and a ``DevicePrefixIndex`` of page-aligned prompt
    prefixes. Admission reserves the pages the request can touch (prompt
    plus ``max_new``; None reserves to capacity), sharing the full pages
    of the longest device-index hit (refcount, zero bytes moved) unless
    the host ladder reaches further; exhaustion raises the typed,
    retriable ``PoolExhaustedError`` before any slot state changes. The
    decode step (key ``paged_step[pbt]``, ``pbt`` the pow2 bucket of the
    longest OCCUPIED table) gathers each slot's pages into its logical row
    and attends over ``pbt * page_size`` positions; every prefill chunk,
    a whole prefix from 0 included, runs ``paged_chunk[cb,pbt]`` at the
    fixed extent ``pbt = _max_pages_bucket``. ``num_pages`` None sizes the
    pool to the dense bank's bytes plus the sentinel. ``recorder``: an
    ``obs.FlightRecorder`` for page grants, frees, exhaustion and prefix
    errors.

    ``compile_ledger``: an ``obs.CompileLedger`` (the engine's, shared by
    every stepper generation) on which the first call of each program of
    this stepper is recorded as a mint: ``ctx_row``, ``admit[pb]``,
    ``chunk[cb]``, ``restore`` (one mint per pow2 bucket, told apart by
    its signature) and ``step[plain]`` dense; ``ctx_row``,
    ``paged_chunk[cb,pbt]``, ``paged_restore[pbk,pbt]`` and
    ``paged_step[pbt]`` paged — the JAX package's keys and pow2 buckets.
    ``on_compile``: called right before such a first call (the engine's
    watchdog extends its wedge grace through it).

    ``speculative``: a draft source (``NgramDrafter``, ``ModelDrafter`` or
    any object with their protocol). The scheduler then drives
    ``spec_step``: up to ``draft_k`` proposals per active slot, one verify
    call scoring all ``c = _kb + 1`` candidate positions against the live
    caches (key ``verify[c]`` dense, ``paged_verify[c,pbt]`` paged at the
    fixed extent), and the accepted window: greedy slots the longest
    argmax-agreeing prefix plus the target's correction, sampled slots
    (``spec_mode="rejection"``, the default) the drafts equal to the
    plain step's position-keyed draws. ``spec_mode="strict"`` refuses any
    sampling config. ``scratch``: masked positions padded onto the time
    axis so verify and over-draft writes land past the real sequence
    (default ``_kb + 1`` when speculative, else 0); paged, ``pages_for``
    reserves the verify window too. ``_quiet``: silent fault seams and no
    compile ledger — the nested draft bank of a ``ModelDrafter``.

    ``kv_dtype``: the dtype of the dense caches or the paged pools (None:
    f32; a draft bank inherits its target's). Host rows of a prefix hit
    or a swap keep it (``host_rows``).

    ``mesh``: a tensor-parallel serving mesh, ``"tp:N"``, an int or a
    ``ServingMesh`` (``parallel.mesh.serving_mesh``; a spec draws on every
    CUDA card, or on the one CPU device when the model lives there). It is
    resolved first, and ``num_heads % N`` is checked, before anything is
    allocated: a bad mesh raises ``ValueError`` here, never at a step. The
    stepper then shards its OWN copy of the weights
    (``parallel.tensor_parallel.shard_decode_params``; the model's
    parameters are untouched) and keeps, per block, one K/V tensor per
    shard holding ``num_heads / N`` heads (``_kv``). The model lives on
    the mesh's home device (``devices[0]``), which is ``device``: the
    context rows, the sampler, the embedding, every LayerNorm and the head
    run there once a program, and the per-shard work on each shard's
    device (``predictors.CachedSequenceGenerator._stage``). Host
    bookkeeping is the solo bank's; host K/V rows join the shards' heads.
    ``mesh_spec``/``mesh_devices``/``kv_shard_bytes()`` report the
    geometry. A ``ModelDrafter``'s bank stays solo. ``mesh=None`` leaves
    every program bit for bit as it was.

    Grammar: a slot admitted with ``sampling.grammar`` (``begin_admit``'s
    ``eos_id`` feeds the forced-EOS fallback) is constrained. A step or
    verify with a constrained ACTIVE slot runs the masked variant of its
    program (keys ``step[masked]``, ``paged_step[pbt,masked]``,
    ``verify[c,masked]``, ``paged_verify[c,pbt,masked]``); ``warmup()``
    runs only the unmasked ones, ``warm_constrained_buckets()`` the masked
    ones. ``constrained_masks`` counts mask rows applied,
    ``mask_exhaustions`` the rows that allowed nothing (forced EOS, a
    ``sampling.mask_exhausted`` recorder event)."""

    def __init__(self, model, num_slots=8, temperature=0.0, seed=0,
                 top_k=None, top_p=None, kv_dtype=None, device=None,
                 compile_ledger=None, prefix_cache=None, paged=False,
                 page_size=16, num_pages=None, recorder=None,
                 speculative=None, draft_k=4, spec_mode="rejection",
                 scratch=None, mesh=None, _quiet=False):
        # the generator's model-family validation, block parsing and
        # per-stage bodies, reused wholesale
        self._gen = CachedSequenceGenerator(
            model, temperature=temperature, seed=seed, top_k=top_k,
            top_p=top_p, kv_dtype=kv_dtype, device=device,
        )
        # the serving mesh, resolved FIRST (before any allocation): a bad
        # mesh fails the boot, never the first step
        self.mesh = None
        self._nh = self._gen.num_heads
        if mesh is not None:
            self.mesh = serving_mesh(mesh, device=self._gen.device)
            ways = self.mesh.size
            if self._nh % ways:
                raise ValueError(
                    f"cannot shard {self._nh} attention heads over mesh "
                    f"'tp:{ways}': the model axis must divide num_heads — "
                    f"pick a mesh that divides the head count or serve "
                    f"this bundle solo"
                )
            if self.mesh.home != self._gen.device:
                raise ValueError(
                    f"the model lives on {self._gen.device} but the "
                    f"serving mesh's home device is {self.mesh.home}; "
                    f"build the model on the mesh's first device"
                )
            # the stepper's OWN per-shard copies: the model's parameters
            # (and the predict path reading them) stay untouched
            self._params = shard_decode_params(model, self.mesh)
            self._gen.shard(self._params, decode_param_specs(
                model, ways), self.mesh.devices)
            self._devices = list(self.mesh.devices)
        else:
            self._params = None
            self._devices = [self._gen.device]
        self.kv_dtype = self._gen.kv_dtype
        # host K/V rows' numpy dtype (bf16 rides as its uint16 bits)
        self._host_dt = host_rows(torch.zeros(0, dtype=self.kv_dtype)).dtype
        self.device = self._gen.device
        self.model = model
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1; got {num_slots}")
        self.max_len = int(model.input_shape[0])
        self.drafter = speculative if speculative else None
        self.draft_k = int(draft_k)
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1; got {draft_k}")
        self._kb = _bucket_pow2(self.draft_k, self.max_len)
        self.spec_mode = spec_mode
        if self.drafter is not None:
            self.spec_mode = _sp.check_spec_sampling(
                spec_mode, temperature, top_k, top_p
            )
        if scratch is None:
            scratch = self._kb + 1 if self.drafter is not None else 0
        self._tp = self.max_len + int(scratch)  # padded time axis
        # a plain stepper keeps the max_len cap; a scratch-padded one may
        # walk into the pad
        self._lens_cap = self.max_len + max(0, int(scratch) - 1)
        self._quiet = bool(_quiet)
        b, t = self.num_slots, self._tp
        self._hd = self._gen.head_dim
        self._ctx = torch.zeros((b, t), dtype=torch.int64, device=self.device)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.recorder = recorder
        if self.paged:
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1; got {page_size}")
            pages_per_slot = -(-t // self.page_size)
            if num_pages is None:
                # the dense bank's bytes, plus the null sentinel
                num_pages = b * pages_per_slot + 1
            self._kv_alloc = PageAllocator(
                int(num_pages), self.page_size, recorder=recorder,
            )
            # the table bucket that covers a full-capacity slot: every
            # step bucket is <= this, and every chunk runs at it
            self._max_pages_bucket = max(
                1, 1 << (pages_per_slot - 1).bit_length()
            )
            self._kv = self._new_kv((int(num_pages), self.page_size))
            self._caches = None
            self._pools = self._solo_view()
            self._tables: list[list[int]] = [[] for _ in range(b)]
            self.prefix_index = DevicePrefixIndex(self._kv_alloc)
            t_ext = self._max_pages_bucket * self.page_size
        else:
            self._kv_alloc = None
            self.prefix_index = None
            self._pools = None
            self._kv = self._new_kv((b, t))
            self._caches = self._solo_view()
            t_ext = t
        self._lens = np.ones((b,), np.int64)  # host mirror; >= 1 always
        self._rows = torch.arange(b, device=self.device)
        # position index over the longest attention extent (the paged
        # gather can run past max_len up to a whole bucket of pages)
        self._t_idx = torch.arange(t_ext, device=self.device)
        # per-slot sampler state, passed to every step as data; the
        # emitted-position counter is what the counter RNG keys on
        self.default_sampling = _sp.SamplingParams(
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
        self._temps = np.zeros((b,), np.float32)
        self._topk = np.zeros((b,), np.int64)  # 0 = disabled
        self._topp = np.ones((b,), np.float32)  # 1.0 = disabled
        self._seeds = np.zeros((b,), np.int64)
        self._spos = np.zeros((b,), np.int64)
        self._slot_params: list = [None] * b  # what each slot samples under
        self._grammar: dict = {}  # slot -> incremental grammar mask state
        self._mask_compiler = _sp.TokenMaskCompiler(self._gen._emb.vocab_size)
        self.constrained_masks = 0  # mask rows applied
        self.mask_exhaustions = 0  # rows that allowed nothing: forced EOS
        for i in range(b):
            self.set_sampling(i, None)
        self.prefix_cache = prefix_cache
        # prefix-store failures degrade to misses (the cache is an
        # optimisation, not a dependency); this counts them
        self.prefix_fetch_failures = 0
        # in-progress admissions: slot -> pending prompt / next position
        self._pending: dict[int, np.ndarray] = {}
        self._prefill_pos: dict[int, int] = {}
        # the nested draft bank records no mints: its programs belong to
        # the drafter, not to the serving path
        self.ledger = None if self._quiet else compile_ledger
        self.on_compile = None
        self._warming = False  # True inside warmup(): mints off-path
        # (program key, signature) pairs run on this bank
        self._called: set[tuple] = set()
        # speculation's books: prompts kept for draft admission, slots with
        # a draft admitted, the proposal cache that keeps a blame probe
        # from re-advancing the draft bank, and the counters stats() reads
        self._spec_prompts: dict[int, np.ndarray] = {}
        self._spec_admitted: set[int] = set()
        self._spec_pending = None  # (lens snapshot, dtoks, dcnt)
        self.spec_verify_steps = 0
        self.spec_fallback_steps = 0
        self.spec_drafted_tokens = 0
        if self.drafter is not None:
            self.drafter.bind(self)

    @property
    def speculative(self) -> bool:
        return self.drafter is not None

    @property
    def wants_sequences(self) -> bool:
        """True when the draft source reads each slot's host sequence so
        far (prompt + emitted); the batcher then builds them."""
        return self.drafter is not None and self.drafter.wants_sequences

    def _fire(self, site, **ctx):
        """A fault seam, silent on a quiet (nested draft) stepper: seams
        armed against live traffic must not trip on the draft's steps."""
        if not self._quiet:
            faults.fire(site, **ctx)

    # -- the serving mesh ----------------------------------------------------

    @property
    def mesh_spec(self):
        """``"tp:N"`` under a serving mesh, None solo: the geometry
        ``health``, ``stats`` and the fleet's replica books carry."""
        return None if self.mesh is None else f"tp:{self.mesh.size}"

    @property
    def mesh_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _new_kv(self, lead):
        """Per block, the (K, V) pair of zero tensors of each shard:
        ``lead + (heads per shard, head_dim)`` on the shard's device (the
        JAX package's ``PartitionSpec(None, None, "model")``)."""
        shape = (*lead, self._nh // len(self._devices), self._hd)

        def zeros():
            return [torch.zeros(shape, dtype=self.kv_dtype, device=d)
                    for d in self._devices]

        return [(zeros(), zeros()) for _ in self._gen._blocks]

    def _solo_view(self):
        """``_caches``/``_pools``, the per-block (K, V) of a solo bank (the
        tensors the programs write); None under a mesh, whose K/V is
        ``_kv``'s per-shard lists."""
        if self.mesh is not None:
            return None
        return [(ks[0], vs[0]) for ks, vs in self._kv]

    def _on_shards(self, *ts):
        """``ts`` on each shard's device, one tuple per shard: how tables,
        positions and masks reach the shards (solo, and where a shard
        lives on home, the same tensors)."""
        if len(self._devices) == 1:
            return [ts]
        return [tuple(t.to(d) for t in ts) for d in self._devices]

    def _join_heads(self, parts):
        """Per-shard (..., H/N, Dh) rows joined on home into the full
        (..., H, Dh) layout host rows keep."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts], dim=-2)

    def _split_heads(self, rows):
        """Full-head (..., H, Dh) rows on home cut into each shard's heads,
        on its device."""
        if len(self._devices) == 1:
            return [rows]
        h = self._nh // len(self._devices)
        return [rows[..., i * h:(i + 1) * h, :].to(d)
                for i, d in enumerate(self._devices)]

    # -- host inputs and program mints --------------------------------------

    def _to_dev(self, arr) -> torch.Tensor:
        """A host array on the stepper's device. On the card it goes
        through pinned memory with ``non_blocking=True``: a copy from
        pageable memory synchronizes the stream, which would make every
        admission wait for the decode step in flight."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run(self, key, fn, *args, signature=()):
        """Run one stepper program. Its first call on this stepper (per
        ``signature``, for a key that covers several shapes) is a mint:
        the ``on_compile`` hook fires before it, and the call is timed to
        the end of its device work and recorded on the ledger."""
        ident = (key, signature)
        if ident in self._called:
            return fn(*args)
        hook = self.on_compile
        if hook is not None:
            hook()
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._called.add(ident)
        led = self.ledger
        if led is not None:
            try:
                led.record_mint(key, time.perf_counter() - t0,
                                signature=signature, warming=self._warming)
            except Exception:  # noqa: BLE001 — observability boundary
                pass
        return out

    def _warm(self, fn):
        """Run ``fn`` with this stepper's mints (and, on this thread, any
        kernel build) recorded as ``trigger="warmup"``."""
        self._warming = True
        _WARM_SCOPE.depth += 1
        owner, _WARM_SCOPE.ledger = _WARM_SCOPE.ledger, self.ledger
        try:
            fn()
        finally:
            _WARM_SCOPE.ledger = owner
            _WARM_SCOPE.depth -= 1
            self._warming = False

    def _buckets(self, prefix) -> list:
        """The buckets of the ``prefix[...]`` programs run on this bank,
        as ints or int tuples (for ``paged_stats``; a masked variant
        shares its unmasked twin's bucket)."""
        out = []
        for key, _ in self._called:
            if key.startswith(prefix + "["):
                vals = tuple(int(v) for v in key[len(prefix) + 1:-1]
                             .split(",") if v != "masked")
                out.append(vals[0] if len(vals) == 1 else vals)
        return sorted(set(out))

    # -- observability --------------------------------------------------------

    def kv_bytes_total(self) -> int:
        """Bytes of every K/V pool (paged) or cache bank (dense), over
        every shard: the same at every mesh size for one config."""
        return sum(t.numel() * t.element_size()
                   for ks, vs in self._kv for t in (*ks, *vs))

    def kv_shard_bytes(self) -> int:
        """K/V bytes RESIDENT PER SHARD — the number a capacity planner
        compares against one device's memory."""
        return self.kv_bytes_total() // self.mesh_devices

    def paged_stats(self) -> dict:
        """Pool, allocator and device-prefix-index observability for the
        engine's ``stats()`` (``{"enabled": False}`` when dense)."""
        if not self.paged:
            return {"enabled": False}
        out = {"enabled": True}
        out.update(self._kv_alloc.stats())
        # the pool's total bytes do not depend on the mesh; what tp:N
        # changes is how many land on each shard
        out["mesh"] = self.mesh_spec
        out["kv_bytes_total"] = self.kv_bytes_total()
        out["kv_shard_bytes"] = self.kv_shard_bytes()
        out["device_prefix"] = self.prefix_index.stats()
        out["compiled_step_buckets"] = self._buckets("paged_step")
        out["compiled_chunk_buckets"] = self._buckets("paged_chunk")
        return out

    # -- per-slot sampler state ---------------------------------------------

    def set_sampling(self, slot, params, eos_id=None):
        """Bind ``params`` (None = the engine default) to ``slot``, reset
        its emitted-position counter (admission is the replay boundary)
        and compile a fresh grammar mask state when the params carry one
        (``eos_id`` feeds its forced-EOS fallback)."""
        p = params if params is not None else self.default_sampling
        self._bind_params(slot, p)
        self._seeds[slot] = p.seed
        self._spos[slot] = 0
        self._grammar.pop(slot, None)
        if p.grammar is not None:
            self._grammar[slot] = self._mask_compiler.compile(
                p.grammar, eos_id=eos_id)

    def _build_tmask(self, active):
        """The (B, V) additive grammar mask of this step: None when no
        ACTIVE slot is constrained (the unmasked program runs). A row that
        allows nothing falls back to the request's eos (or, without one,
        to no constraint), counted and recorded — never a hang."""
        if not self._grammar:
            return None
        rows = [i for i in self._grammar if active[i]]
        if not rows:
            return None
        v = self._gen._emb.vocab_size
        tm = np.zeros((self.num_slots, v), np.float32)
        for i in rows:
            st = self._grammar[i]
            allow = np.asarray(st.mask(), bool)
            if not allow.any():
                self.mask_exhaustions += 1
                if self.recorder is not None:
                    self.recorder.record(
                        "sampling.mask_exhausted", slot=i,
                        pos=int(self._spos[i]),
                    )
                eos = st.eos_id
                allow = np.zeros(v, bool)
                if eos is not None and 0 <= int(eos) < v:
                    allow[int(eos)] = True  # forced-EOS fallback
                else:
                    allow[:] = True  # no eos known: unconstrained
            tm[i] = np.where(allow, 0.0, -np.inf)
            self.constrained_masks += 1
        return tm

    def _advance_grammar(self, toks, counts):
        """Consume the emitted tokens into each constrained slot's mask
        state (``toks`` (B, w) with ``counts[i]`` real entries)."""
        for i, st in self._grammar.items():
            for j in range(int(counts[i])):
                st.advance(int(toks[i, j]))

    def _bind_params(self, slot, p):
        """The per-slot sampler arrays of ``p`` (seed and counter
        aside)."""
        self._slot_params[slot] = p
        self._temps[slot] = p.temperature
        self._topk[slot] = 0 if p.top_k is None else p.top_k
        self._topp[slot] = 1.0 if p.top_p is None else p.top_p

    # -- page pool ------------------------------------------------------------

    def pages_for(self, prompt_len: int, max_new: int) -> int:
        """Pages a request needs end to end (prompt plus decode budget,
        plus the verify window when speculative, page-rounded): what
        admission reserves and the scheduler gates on."""
        need = int(prompt_len) + int(max_new)
        if self.drafter is not None:
            need += self._kb + 1  # verify writes walk into the scratch
        need = min(need, self._tp)
        return max(1, -(-need // self.page_size))

    @property
    def can_fork(self) -> bool:
        """Whether n-parallel completions can be scheduled here
        (``fork_slot`` needs the paged copy-on-write machinery)."""
        return self.paged

    def fork_pages_for(self, prompt_len: int, max_new: int) -> int:
        """FRESH pages one fork of a just-prefilled slot allocates (the
        full history pages below its write frontier are shared): what the
        scheduler adds per extra completion when it gates a group's
        admission on the pool."""
        need = self.pages_for(prompt_len, max_new)
        frontier = (max(1, int(prompt_len)) - 1) // self.page_size
        return max(0, need - frontier)

    @property
    def available_pages(self) -> int:
        """What admission can obtain: the free list plus the pages the
        device prefix index holds alone (reclaimed under pressure, so
        cached prefixes never starve live traffic)."""
        if not self.paged:
            return 1 << 30
        return self._kv_alloc.free_pages + self.prefix_index.reclaimable()

    @property
    def total_pages(self) -> int:
        return self._kv_alloc.total_pages if self.paged else 1 << 30

    def _alloc_pages(self, n: int, reason: str) -> list[int]:
        """Allocate, shedding LRU device-prefix entries first when the
        free list is short: exhaustion means LIVE demand exceeds the
        pool, not that the cache filled it."""
        deficit = n - self._kv_alloc.free_pages
        if deficit > 0:
            self.prefix_index.reclaim(deficit)
        return self._kv_alloc.alloc(n, reason=reason)

    def _record_prefix_error(self, op: str, exc: BaseException, slot):
        """A degraded prefix lookup or insert: counted, and its exception
        class taped (a store failing every call would otherwise look like
        a cold one)."""
        self.prefix_fetch_failures += 1
        if self.recorder is not None:
            self.recorder.record(
                "prefix_cache.error", op=op, error=type(exc).__name__,
                detail=repr(exc)[:200], slot=slot,
            )

    # -- admission ----------------------------------------------------------

    def admit(self, slot: int, prompt, sampling=None, max_new=None,
              eos_id=None) -> None:
        """One-shot admission: ``begin_admit`` plus the whole prefill."""
        left = self.begin_admit(slot, prompt, sampling=sampling,
                                max_new=max_new, eos_id=eos_id)
        while left > 0:
            left = self.prefill_chunk(slot, left)

    @torch.no_grad()
    def begin_admit(self, slot: int, prompt, sampling=None,
                    max_new=None, eos_id=None) -> int:
        """Start admitting ``prompt`` into ``slot``: (paged) reserve its
        page table, bind its sampling, write its context row, restore the
        longest prefix-cache hit, and return the prefill positions still
        to compute (0 = ready to decode). ``max_new`` bounds the paged
        reservation (None reserves to capacity); ``eos_id`` feeds a
        grammar's forced-EOS fallback. The ``stepper.prefill``
        seam fires first, and a ``PoolExhaustedError`` leaves the slot
        (sampler state included) as it was."""
        self._fire("stepper.prefill", slot=slot)
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = prompt.size
        if not 1 <= plen <= self.max_len:
            raise ValueError(
                f"prompt length {plen} outside [1, {self.max_len}]"
            )
        target = plen - 1  # prefill covers positions 0..plen-2
        start, host_hit = 0, None
        if self.paged:
            start, host_hit = self._reserve_pages(slot, prompt, plen,
                                                  max_new)
        elif self.prefix_cache is not None and target >= 1:
            host_hit = self._lookup_store(prompt[:target], slot)
        self.set_sampling(slot, sampling, eos_id=eos_id)
        row = np.zeros((self.max_len,), np.int64)
        row[:plen] = prompt
        self._run("ctx_row", self._write_row, slot, row)
        if host_hit is not None:
            start, kv = host_hit
            self._restore_prefix(slot, kv)
        self._pending[slot] = prompt
        self._prefill_pos[slot] = start
        if self.drafter is not None:
            # kept for draft admission once the slot turns decodable; the
            # proposal cache is stale once the slot composition changes
            self._spec_prompts[slot] = prompt
            self._spec_pending = None
        self._lens[slot] = plen
        if start >= target:
            self._finish_admit(slot)
            return 0
        return target - start

    def _lookup_store(self, tokens, slot):
        """The host ladder's longest hit, or None (a failing lookup is a
        miss)."""
        try:
            return self.prefix_cache.lookup(tokens)
        except Exception as e:  # noqa: BLE001 — cache is best-effort
            self._record_prefix_error("lookup", e, slot)
            return None

    def _reserve_pages(self, slot, prompt, plen, max_new):
        """Paged admission's first act: choose the prefix source (device
        index or host ladder: the longer coverage wins), build the slot's
        table (shared full pages + fresh private ones) and reserve all it
        can write. Exhaustion raises with every reference taken here
        released and no slot state touched. Returns ``(prefill_start,
        host_hit_or_None)``; the caller restores a host hit once the
        table exists."""
        target = plen - 1
        mnew = (self.max_len - plen) if max_new is None else int(max_new)
        need = self.pages_for(plen, max(1, mnew))
        if self._tables[slot]:
            # re-admission without release() (direct drives); the
            # scheduler always releases first
            self._free_slot_pages(slot)
        start, shared = 0, []
        if target >= self.page_size:
            hit = self.prefix_index.lookup(prompt[:target])
            if hit is not None:
                start, shared = hit  # already retained for this slot
        host_hit = None
        if self.prefix_cache is not None and target >= 1:
            host_hit = self._lookup_store(prompt[:target], slot)
        if host_hit is not None and host_hit[0] <= start:
            host_hit = None  # the device index covers at least the rung
        if host_hit is not None and shared:
            # a restore WRITES positions [0, p): shared (immutable) pages
            # cannot back them, so the table goes all-private
            self._kv_alloc.free(shared, reason="admit_host_override")
            start, shared = 0, []
        try:
            fresh = self._alloc_pages(need - len(shared), "admit")
        except Exception:
            if shared:
                self._kv_alloc.free(shared, reason="admit_abort")
            raise
        self._tables[slot] = shared + fresh
        return start, host_hit

    def _free_slot_pages(self, slot):
        pages = self._tables[slot]
        self._tables[slot] = []
        if pages:
            self._kv_alloc.free(pages, reason="release")

    def _write_row(self, slot, row):
        self._ctx[slot, : self.max_len] = self._to_dev(row)

    # -- copy-on-write forks and the preemption swap -------------------------

    @torch.no_grad()
    def fork_slot(self, src: int, dst: int, max_new=None,
                  completion=1) -> None:
        """Copy-on-write fork: ``dst`` becomes a divergent continuation of
        the DECODING slot ``src`` (``dst`` must be free). Full pages
        strictly below the write frontier (position ``len - 1``, where the
        next step's K/V lands) are shared into ``dst``'s table (refcount,
        zero bytes); a partial frontier page is copied on the device (key
        ``page_cow``) and counted by ``note_cow``; the rest of ``dst``'s
        budget (``max_new``; None reserves to capacity) is fresh private
        pages. The context row (key ``ctx_row_copy``) and host length are
        copied, so both slots decode from the same sequence state, and a
        greedy fork is its source's solo decode. ``dst`` copies ``src``'s
        sampling params and emitted-position counter but samples under
        ``seed_for_completion(seed, completion)``; a grammar state is
        cloned, so each completion walks it alone. On a speculative
        stepper ``dst`` is marked draft-admitted and invalidated (the draft
        bank holds no K/V for what ``src`` decoded). A fork the pool cannot
        cover raises ``PoolExhaustedError`` before anything changes."""
        if not self.paged:
            raise ValueError("fork_slot requires paged=True")
        if src in self._pending or not self._tables[src]:
            raise ValueError(f"slot {src} is not a decodable admitted slot")
        if self._tables[dst]:
            raise ValueError(f"slot {dst} already holds pages")
        ln = int(self._lens[src])
        ps = self.page_size
        mnew = (self.max_len - ln) if max_new is None else int(max_new)
        need = self.pages_for(ln, max(1, mnew))
        frontier = (ln - 1) // ps  # the page the next K/V write lands in
        shared = list(self._tables[src][:frontier])
        self._kv_alloc.share(shared)
        try:
            fresh = self._alloc_pages(max(0, need - frontier), "fork")
        except Exception:
            if shared:
                self._kv_alloc.free(shared, reason="fork_abort")
            raise
        table = shared + fresh
        if (ln - 1) % ps != 0 and frontier < len(self._tables[src]):
            # the frontier page holds positions frontier * ps .. len - 2 of
            # the shared history: copy it so src and dst can diverge
            src_pg = self._tables[src][frontier]
            self._run("page_cow", self._page_copy, src_pg, table[frontier])
            self._kv_alloc.note_cow(src_pg, table[frontier])
        self._tables[dst] = table
        self._run("ctx_row_copy", self._row_copy, src, dst)
        self._lens[dst] = ln
        self._bind_params(dst, self._slot_params[src]
                          or self.default_sampling)
        self._seeds[dst] = _sp.seed_for_completion(
            self._slot_params[dst].seed, completion)
        self._spos[dst] = self._spos[src]
        if src in self._grammar:
            self._grammar[dst] = self._grammar[src].clone()
        else:
            self._grammar.pop(dst, None)
        if self.drafter is not None:
            sp = self._spec_prompts.get(src)
            if sp is not None:
                self._spec_prompts[dst] = sp
            self._spec_admitted.add(dst)
            self.drafter.invalidate(np.arange(self.num_slots) == dst)
            self._spec_pending = None

    def _page_copy(self, src_pg, dst_pg):
        for ks, vs in self._kv:
            for pool in (*ks, *vs):
                pool[dst_pg] = pool[src_pg]

    def _row_copy(self, src, dst):
        self._ctx[dst] = self._ctx[src]

    def swap_out(self, slot: int) -> dict:
        """A DECODABLE slot's live state on the host — the first half of a
        preemption. The K/V of its written positions ``0 .. len-2`` per
        block in the ``PrefixStore`` row format (``(p, H, Dh)`` numpy in
        the cache dtype, ``host_rows``: bit-exact, one device->host copy),
        the context row, the host length and the sampler and grammar state
        the position-keyed RNG and the mask continue from: JAX's dict.
        Read-only: the ``kv.swap`` seam fires first, and the caller
        releases the slot only after a successful swap-out."""
        self._fire("kv.swap", slot=slot, direction="out")
        if slot in self._pending:
            raise ValueError(
                f"slot {slot} is mid-prefill; only decodable slots can be "
                "swapped out"
            )
        ln = int(self._lens[slot])
        if ln > self.max_len:
            raise ValueError(
                f"slot {slot} context ({ln}) has walked past the prompt row "
                f"({self.max_len}); not swappable"
            )
        p = ln - 1  # written cache positions
        if p < 1:
            empty = np.zeros((0, self._nh, self._hd), self._host_dt)
            kv = [(empty, empty.copy()) for _ in self._gen._blocks]
        else:
            kv = self._fetch_rows(slot, p)
        return {
            "len": ln,
            "ctx": self._ctx[slot, :ln].cpu().numpy().astype(np.int32),
            "kv": kv,
            "spos": int(self._spos[slot]),
            "seed": int(self._seeds[slot]),
            "params": self._slot_params[slot],
            "grammar": self._grammar.get(slot),
            "spec_prompt": self._spec_prompts.get(slot),
        }

    @torch.no_grad()
    def swap_in(self, slot: int, state: dict, max_new=None) -> None:
        """Restore a swapped-out request into a FREE slot: resume is
        re-reserve + restore. Paged, the whole page budget (``len`` plus
        ``max_new`` positions, the total the original admission reserved,
        all private) is reserved first, and exhaustion raises the typed
        ``PoolExhaustedError`` before any slot state changes. Then the
        context row is written and the host K/V rows go back through the
        prefix restore's bucketed programs (``restore`` /
        ``paged_restore[pbk,pbt]``); the host length and the sampler
        counter resume where ``swap_out`` left them, so the next step
        computes what an uninterrupted decode would. On a speculative
        stepper the slot is marked draft-admitted and invalidated. The
        ``kv.swap`` seam fires first."""
        self._fire("kv.swap", slot=slot, direction="in")
        ln = int(state["len"])
        remaining = (self.max_len - ln) if max_new is None else int(max_new)
        if self.paged:
            if self._tables[slot]:
                self._free_slot_pages(slot)
            need = self.pages_for(ln, max(1, remaining))
            self._tables[slot] = self._alloc_pages(need, "swap_in")
        row = np.zeros((self.max_len,), np.int64)
        row[:ln] = state["ctx"]
        self._run("ctx_row", self._write_row, slot, row)
        if state["kv"][0][0].shape[0] >= 1:
            self._restore_prefix(slot, state["kv"])
        self._lens[slot] = ln
        p = state["params"] if state["params"] is not None \
            else self.default_sampling
        self._bind_params(slot, p)
        self._seeds[slot] = int(state["seed"])
        self._spos[slot] = int(state["spos"])
        if state.get("grammar") is not None:
            self._grammar[slot] = state["grammar"]
        else:
            self._grammar.pop(slot, None)
        self._pending.pop(slot, None)
        self._prefill_pos.pop(slot, None)
        if self.drafter is not None:
            if state.get("spec_prompt") is not None:
                self._spec_prompts[slot] = state["spec_prompt"]
            self._spec_admitted.add(slot)
            self.drafter.invalidate(np.arange(self.num_slots) == slot)
            self._spec_pending = None

    @torch.no_grad()
    def prefill_chunk(self, slot: int, budget: int) -> int:
        """Prefill up to ``budget`` more positions of ``slot``'s prompt;
        returns positions remaining (0 = ready to decode). Dense: a chunk
        that covers the whole prefix from 0 runs the full-prefill body
        (dense causal attention over the prefix, key ``admit[pb]``); a
        mid-prompt chunk runs the generator's ``_stage_chunk`` against the
        slot's cache rows (key ``chunk[cb]``). Paged: every chunk runs the
        gather/scatter chunk (key ``paged_chunk[cb,pbt]``). As in the JAX
        package, a chunk whose pow2 bucket would run past the cache (dense)
        or the slot's reserved pages (paged) shrinks to the largest pow2
        that fits. The ``stepper.prefill`` seam fires first."""
        self._fire("stepper.prefill", slot=slot)
        prompt = self._pending.get(slot)
        if prompt is None:
            return 0  # released underneath us
        target = prompt.size - 1
        pos = self._prefill_pos[slot]
        n = min(int(budget), target - pos)
        if n > 0:
            if not self.paged and pos == 0 and n == target:
                pb = _bucket_pow2(target, self.max_len - 1)
                self._run(f"admit[{pb}]", self._prefill_full, slot, prompt)
            else:
                cb = _bucket_pow2(n, self.max_len)
                room = (
                    len(self._tables[slot]) * self.page_size - pos
                    if self.paged else self._tp - pos
                )
                if cb > room:
                    cb = 1 << (room.bit_length() - 1)  # largest pow2 <= room
                    n = min(n, cb)
                if self.paged:
                    pbt = self._max_pages_bucket
                    self._run(f"paged_chunk[{cb},{pbt}]",
                              self._prefill_paged, slot, prompt, pos, n)
                else:
                    self._run(f"chunk[{cb}]", self._prefill_mid, slot,
                              prompt, pos, n)
            pos += n
            self._prefill_pos[slot] = pos
        if pos >= target:
            self._finish_admit(slot)
            return 0
        return target - pos

    def _slot_caches(self, slot):
        """Per block, each shard's (1, T, H/N, Dh) views of one slot's
        cache rows: writes through them land in the bank."""
        return [
            ([k[slot : slot + 1] for k in ks], [v[slot : slot + 1] for v in vs])
            for ks, vs in self._kv
        ]

    def _prefill_full(self, slot, prompt):
        pp = prompt.size - 1
        toks = self._to_dev(prompt[None, :pp])
        x = self._gen.embed(toks, torch.arange(pp, device=self.device))
        self._gen._prefill(self._slot_caches(slot), x)

    def _prefill_mid(self, slot, prompt, pos, n):
        toks = self._to_dev(prompt[None, pos : pos + n])
        positions = torch.arange(pos, pos + n, device=self.device)
        x = self._gen.embed(toks, positions)
        qmask = self._t_idx[None, : self._tp] <= positions[:, None]
        for (blk, moe), (ck, cv) in zip(self._gen._stages,
                                        self._slot_caches(slot)):
            x = self._gen._stage_chunk(blk, moe, x, ck, cv, pos, qmask)

    def _table_row(self, slot, pbt) -> np.ndarray:
        """Slot ``slot``'s page table padded to ``pbt`` entries with the
        sentinel page 0."""
        row = np.zeros((pbt,), np.int64)
        pages = self._tables[slot]
        row[: len(pages)] = pages
        return row

    def _prefill_paged(self, slot, prompt, pos, n):
        """Positions ``pos..pos+n-1`` of ``slot``'s prompt: gather the
        slot's pages into its logical (1, pbt * ps) row, run the
        generator's ``_stage_chunk`` against it (the dense chunk's math),
        then scatter the chunk's K/V rows back to their pages."""
        gen, ps = self._gen, self.page_size
        hd = self._hd
        pbt = self._max_pages_bucket
        tg = pbt * ps
        trow = self._table_row(slot, pbt)
        positions = np.arange(pos, pos + n)
        fpos = trow[np.minimum(positions // ps, pbt - 1)] * ps + positions % ps
        ints = self._to_dev(np.concatenate([prompt[pos : pos + n], trow, fpos]))
        toks, trow_d, fpos_d = ints[:n], ints[n : n + pbt], ints[n + pbt :]
        pos_d = torch.arange(pos, pos + n, device=self.device)
        x = gen.embed(toks[None], pos_d)
        qmask = self._t_idx[None, :tg] <= pos_d[:, None]
        at = self._on_shards(trow_d, fpos_d)
        for (blk, moe), (ks, vs) in zip(gen._stages, self._kv):
            rk = [pk[a[0]].reshape(1, tg, -1, hd) for pk, a in zip(ks, at)]
            rv = [pv[a[0]].reshape(1, tg, -1, hd) for pv, a in zip(vs, at)]
            x = gen._stage_chunk(blk, moe, x, rk, rv, pos, qmask)
            # index_put_ picks an arbitrary winner among duplicate indices
            # on CUDA. ``fpos`` holds n distinct (page, offset) pairs of
            # this slot's own private pages: the chunk covers no padding
            # (n real positions), starts at or past any shared prefix, and
            # the shrink rule in prefill_chunk keeps pos + n within the
            # slot's table. Only a warm-up with an empty table maps several
            # positions onto the sentinel page, whose contents nothing
            # reads unmasked.
            for pool, rows, a in (*zip(ks, rk, at), *zip(vs, rv, at)):
                pool.view(-1, pool.shape[2], hd)[a[1]] = rows[0, pos : pos + n]

    def _finish_admit(self, slot):
        """Admission complete: drop the pending state, register (paged)
        the prompt's full pages strictly below the write frontier in the
        device index (zero bytes moved: the slot only writes at or past
        position ``target`` from here on), and publish the finished
        prefix's missing pow2 ladder rungs to the host store — fetching
        device->host only up to the longest missing rung, and nothing
        when none is missing. A store failure never fails the request."""
        prompt = self._pending.pop(slot, None)
        self._prefill_pos.pop(slot, None)
        if prompt is None:
            return  # released underneath us; nothing to publish
        target = prompt.size - 1
        if self.paged and target >= 1:
            m = target // self.page_size
            if m >= 1:
                self.prefix_index.insert(prompt[:target],
                                         self._tables[slot][:m])
        store = self.prefix_cache
        if store is None or target < 1:
            return
        try:
            missing = store.missing_rungs(prompt[:target])
            if missing:
                store.insert_prefixes(
                    prompt[:target], self._fetch_rows(slot, max(missing))
                )
        except Exception as e:  # noqa: BLE001 — cache is best-effort
            self._record_prefix_error("insert", e, slot)

    @torch.no_grad()
    def _fetch_rows(self, slot, p):
        """Per-block host ``(k, v)`` rows of ``slot``'s positions
        ``0..p-1``, every shard's heads joined (the solo layout host rows
        keep, whatever the mesh), in one device->host copy."""
        hd = self._hd
        if self.paged:
            npg = -(-p // self.page_size)
            idx = self._to_dev(np.asarray(self._tables[slot][:npg], np.int64))
            at = self._on_shards(idx)

            def part(pools):
                return self._join_heads([
                    pool[a[0]].reshape(-1, pool.shape[2], hd)[:p]
                    for pool, a in zip(pools, at)])
        else:
            def part(banks):
                return self._join_heads([bank[slot, :p] for bank in banks])
        rows = torch.stack([torch.stack([part(ks), part(vs)])
                            for ks, vs in self._kv])
        host = host_rows(rows)
        return [(host[si, 0], host[si, 1]) for si in range(host.shape[0])]

    @torch.no_grad()
    def _restore_prefix(self, slot, kv):
        """Copy a cache hit's host K/V rows into the slot, bucketed to a
        power of two (bucket padding past the real prefix lands at
        positions >= the frontier, overwritten before it is attended)."""
        p = kv[0][0].shape[0]
        pb = min(_bucket_pow2(p, self.max_len), self.max_len)
        dt = self._host_dt
        host = np.zeros((2, len(kv), pb, self._nh, self._hd), dt)
        for si, (k, v) in enumerate(kv):
            if k.dtype != dt:
                # rows of another cache dtype (a store shared across
                # engines): rounded into this one
                k = host_rows(rows_tensor(k, self.kv_dtype))
                v = host_rows(rows_tensor(v, self.kv_dtype))
            host[0, si, :p] = k
            host[1, si, :p] = v
        if self.paged:
            pbt = self._max_pages_bucket  # the fixed extent, like chunks
            self._run(f"paged_restore[{pb},{pbt}]", self._restore_paged,
                      slot, host, pbt)
        else:
            self._run("restore", self._restore_dense, slot, host,
                      signature=host.shape)

    def _kv_to_dev(self, host) -> torch.Tensor:
        """Host K/V rows on the device in the cache dtype, bit for bit
        (bf16 crosses as its int16 bits)."""
        if host.dtype == np.uint16:
            return self._to_dev(host.view(np.int16)).view(torch.bfloat16)
        return self._to_dev(host)

    def _restore_dense(self, slot, host):
        pb = host.shape[2]
        for i, rows in enumerate(self._split_heads(self._kv_to_dev(host))):
            for si, (ks, vs) in enumerate(self._kv):
                ks[i][slot, :pb] = rows[0, si]
                vs[i][slot, :pb] = rows[1, si]

    def _restore_paged(self, slot, host, pbt):
        ps, hd = self.page_size, self._hd
        pb = host.shape[2]
        trow = self._table_row(slot, pbt)
        pvec = np.arange(pb)
        # a host hit holds an all-private table, so positions inside it
        # are distinct (page, offset) pairs of this slot's pages; padding
        # past the table maps to the sentinel page
        fpos = self._to_dev(trow[np.minimum(pvec // ps, pbt - 1)] * ps
                            + pvec % ps)
        parts = self._split_heads(self._kv_to_dev(host))
        for i, ((f,), rows) in enumerate(zip(self._on_shards(fpos), parts)):
            for si, (ks, vs) in enumerate(self._kv):
                pk, pv = ks[i], vs[i]
                pk.view(-1, pk.shape[2], hd)[f] = rows[0, si]
                pv.view(-1, pv.shape[2], hd)[f] = rows[1, si]

    def release(self, slot: int) -> None:
        self._lens[slot] = 1  # keep pos = lens-1 in range while parked
        self._pending.pop(slot, None)
        self._prefill_pos.pop(slot, None)
        self.set_sampling(slot, None)
        if self.paged:
            # a quarantined or evicted slot gives its pages back now;
            # shared prefix pages live on through the index's references
            self._free_slot_pages(slot)
        self._spec_prompts.pop(slot, None)
        if slot in self._spec_admitted:
            self._spec_admitted.discard(slot)
            self._spec_pending = None
            self.drafter.release(slot)

    @torch.no_grad()
    def warmup(self) -> None:
        """All-inactive steps off the serving path: build the kernels the
        step runs (their first use) and pay the step's first-call costs
        without touching the slot bank — every write is masked (paged:
        sent to the sentinel page) and no host bookkeeping advances.
        Paged, every pow2 ``paged_step`` bucket up to ``_max_pages_bucket``
        runs once, so no step mints on the serving path whatever the
        longest table. It does not go through ``step``, so it never fires
        an armed ``stepper.step`` seam. Speculative, the verify runs once
        too (every write masked) and the drafter warms its own programs, so
        a supervisor restart never mints a verify on the serving path.
        Only the unmasked programs run here: grammar traffic is the rare
        case, and ``warm_constrained_buckets`` warms its variants. Mints
        record ``trigger="warmup"``; declaring the warm set complete
        (``compile_ledger.mark_warmed()``) is the harness's call."""
        active = np.zeros(self.num_slots, bool)

        def warm():
            if not self.paged:
                self._run("step[plain]", self._step_dev, active,
                          self._lens.copy())
            else:
                pbt = 1
                while True:
                    self._run(f"paged_step[{pbt}]", self._step_dev, active,
                              self._lens.copy(), pbt)
                    if pbt >= self._max_pages_bucket:
                        break
                    pbt <<= 1
            if self.drafter is not None:
                self._run_verify(
                    active, self._lens.copy(),
                    np.zeros((self.num_slots, self._kb), np.int64),
                    np.zeros((self.num_slots,), np.int64),
                )
                self.drafter.warmup()

        self._warm(warm)

    @torch.no_grad()
    def warm_prefill_buckets(self) -> None:
        """Run every pow2 chunk bucket (``chunk[cb]`` and ``admit[pb]``
        dense, ``paged_chunk[cb,pbt]`` paged) and ``ctx_row`` once off the
        serving path, through slot 0, without autograd (a chunk written into
        the caches under grad mode would leave them with a graph, and a later
        device->host fetch of their rows would fail). Only safe on an IDLE bank: slot 0's
        context row (and, dense, its cache rows) are overwritten by the
        next admission before anything attends them; paged buckets run
        only while slot 0 holds no table (the writes then land on the
        sentinel page)."""

        def warm():
            zeros = np.zeros(self.max_len, np.int64)
            self._run("ctx_row", self._write_row, 0, zeros)
            pbt = self._max_pages_bucket if self.paged else None
            cb = 1
            while True:
                n = min(cb, self.max_len)
                if not self.paged:
                    self._run(f"chunk[{n}]", self._prefill_mid, 0, zeros,
                              0, n)
                elif not self._tables[0]:
                    self._run(f"paged_chunk[{n},{pbt}]",
                              self._prefill_paged, 0, zeros, 0, n)
                if cb >= self.max_len:
                    break
                cb <<= 1
            if self.paged:
                return  # paged admission runs the chunk family alone
            pb, buckets = 1, set()
            while True:
                buckets.add(min(pb, self.max_len - 1))
                if pb >= self.max_len - 1:
                    break
                pb <<= 1
            for pb in sorted(b for b in buckets if b >= 1):
                self._run(f"admit[{pb}]", self._prefill_full, 0,
                          zeros[: pb + 1])

        self._warm(warm)

    @torch.no_grad()
    def warm_restore_buckets(self) -> None:
        """Run every pow2 prefix-restore bucket (``restore`` dense,
        ``paged_restore[pbk,pbt]`` paged) once off the serving path,
        through slot 0: which bucket a hit needs depends on the traffic.
        Buckets: every power of two up to ``max_len`` and the
        ``max_len``-clamped value. Dense, only safe on an IDLE bank (slot
        0's cache rows take zeros); paged, only while slot 0 holds no
        table (the writes land on the sentinel page). Also mints
        ``ctx_row`` when it has not run and slot 0 is free, and, paged, the
        fork's ``page_cow`` and ``ctx_row_copy`` (each copying the sentinel
        page or slot 0's row onto itself), so neither a swap-in nor a fork
        mints on the serving path."""

        def warm():
            nh, hd = self._nh, self._hd
            pb, buckets = 1, set()
            while True:
                buckets.add(min(pb, self.max_len))
                if pb >= self.max_len:
                    break
                pb <<= 1
            for p in sorted(buckets):
                if self.paged and self._tables[0]:
                    continue
                kv = [(np.zeros((p, nh, hd), self._host_dt),
                       np.zeros((p, nh, hd), self._host_dt))
                      for _ in self._gen._blocks]
                self._restore_prefix(0, kv)
            occupied = (
                bool(self._tables[0]) if self.paged
                else (int(self._lens[0]) > 1 or 0 in self._pending)
            )
            if ("ctx_row", ()) not in self._called and not occupied:
                self._run("ctx_row", self._write_row, 0,
                          np.zeros(self.max_len, np.int64))
            if self.paged:
                # the fork's copies, onto themselves: the sentinel page and
                # slot 0's context row are unchanged
                self._run("page_cow", self._page_copy, 0, 0)
                self._run("ctx_row_copy", self._row_copy, 0, 0)

        self._warm(warm)

    @torch.no_grad()
    def warm_constrained_buckets(self) -> None:
        """Run the grammar-masked programs once off the serving path, every
        write masked (an all-inactive bank): ``step[masked]`` dense, every
        pow2 ``paged_step[pbt,masked]`` up to ``_max_pages_bucket`` paged
        (the step's bucket tracks the longest OCCUPIED table, so which one a
        constrained mix needs depends on the traffic), and, speculative,
        the verify at its one extent masked and unmasked. ``warmup()`` runs
        none of these, so harnesses serving grammar traffic call this
        before ``mark_warmed()``."""
        active = np.zeros(self.num_slots, bool)
        tmask = np.zeros((self.num_slots, self._gen._emb.vocab_size),
                         np.float32)

        def warm():
            if not self.paged:
                self._run("step[masked]", self._step_dev, active,
                          self._lens.copy(), None, tmask)
            else:
                pbt = 1
                while True:
                    self._run(f"paged_step[{pbt},masked]", self._step_dev,
                              active, self._lens.copy(), pbt, tmask)
                    if pbt >= self._max_pages_bucket:
                        break
                    pbt <<= 1
            if self.drafter is not None:
                cand = np.zeros((self.num_slots, self._kb), np.int64)
                cnt = np.zeros((self.num_slots,), np.int64)
                for tm in (None, tmask):
                    self._run_verify(active, self._lens.copy(), cand, cnt,
                                     tm)

        self._warm(warm)

    # -- decode -------------------------------------------------------------

    def step(self, active) -> np.ndarray:
        """Advance every active slot one token; returns the (B,) tokens
        appended (entries for inactive slots are meaningless). Dispatch
        plus immediate collect of :meth:`step_async`, so the sequential
        loop and the overlapped one run the same code in the same order."""
        return self.step_async(active).collect()

    def step_async(self, active) -> _InflightStep:
        """Enqueue one decode step without waiting for it. The host inputs
        are snapshot (``self._lens.copy()``, the sampler arrays and, paged,
        the page tables) and copied through pinned memory, the step is
        enqueued on the CURRENT stream, and the token vector rides the
        returned handle; the ``_lens``/``_spos`` advance waits for its
        ``collect()``.

        Every stepper call stays on the current stream, and that is what
        keeps the overlapped loop correct: the step rewrites every active
        slot's cache entry and context entry at the slot's own position,
        so an admission or prefill of another slot enqueued while the step
        is in flight is right only because the stream orders it behind the
        step.

        A constrained active slot makes it the masked program, with the
        mask of each constrained slot's next position (the grammar states
        advanced at the previous collect).

        The ``stepper.step`` seam fires first, before any device work or
        host bookkeeping, so a failed call leaves the bank as it was."""
        active = np.asarray(active, bool)
        self._fire("stepper.step", active=active)
        tmask = self._build_tmask(active)
        tag = "" if tmask is None else ",masked"
        if self.paged:
            pbt = self._table_bucket()
            toks = self._run(f"paged_step[{pbt}{tag}]", self._step_dev,
                             active, self._lens.copy(), pbt, tmask)
        else:
            toks = self._run("step[plain]" if tmask is None
                             else "step[masked]", self._step_dev, active,
                             self._lens.copy(), None, tmask)
        return _InflightStep(self, active, toks)

    def _table_bucket(self) -> int:
        """Pow2 bucket covering every OCCUPIED slot's table — the step's
        program key. Occupied, not active, so a blame probe's mask runs
        the same program."""
        m = max(len(t) for t in self._tables)
        return _bucket_pow2(max(1, m), self._max_pages_bucket)

    def _tables_array(self, pbt) -> np.ndarray:
        """The (B, pbt) page tables a paged step or verify takes, padded
        with the sentinel page 0. A warm-up's bucket may be shorter than a
        live table; its rows are all inactive and write the sentinel."""
        tables = np.zeros((self.num_slots, pbt), np.int64)
        for i, pages in enumerate(self._tables):
            tables[i, : min(len(pages), pbt)] = pages[:pbt]
        return tables

    def write_targets(self, active, lens, c=None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Where a paged program writes each row's new K/V: ``(page,
        offset)`` host arrays, (B,) for the step, (B, c) for a verify
        window of ``c`` candidates. An active row writes at its own
        positions — ``lens - 1`` for the step, ``lens - 1 .. lens - 2 + c``
        for a verify — in the pages of its table that cover them: the page
        of ``lens - 1`` and the scratch pages reserved past it, pages it
        holds alone (shared pages are full pages below every holder's
        write frontier). An inactive row writes the sentinel page 0."""
        ps = self.page_size
        lens = np.asarray(lens, np.int64)
        if c is None:
            pos = np.clip(lens - 1, 0, self._tp - 1)
        else:
            pos = (np.clip(lens - 1, 0, self.max_len - 1)[:, None]
                   + np.arange(c)[None, :])
        page = np.zeros(pos.shape, np.int64)
        for i in np.flatnonzero(active):
            # past the table's end: the sentinel
            ext = np.asarray(self._tables[i] + [0], np.int64)
            page[i] = ext[np.minimum(pos[i] // ps, len(ext) - 1)]
        return page, pos % ps

    @torch.no_grad()
    def _step_dev(self, active, lens, pbt=None, tmask=None) -> torch.Tensor:
        """The decode step over host snapshots ``active``/``lens`` (paged
        when ``pbt``, the table bucket, is given; masked when ``tmask``,
        the (B, V) additive grammar mask, is); returns the (B,) token
        vector on the device. K/V are written in the cache dtype and read
        as f32."""
        gen = self._gen
        b, t = self.num_slots, self._tp
        hd = self._hd
        rows = self._rows
        sampled = bool((self._temps > 0.0).any())
        head = [active.astype(np.int64), lens, self._topk, self._seeds,
                self._spos]
        if pbt is not None:
            head += list(self.write_targets(active, lens))
            tables = self._tables_array(pbt)
            ints = self._to_dev(np.concatenate([np.stack(head).ravel(),
                                                tables.ravel()]))
            tables = ints[len(head) * b :].view(b, pbt)
            ints = ints[: len(head) * b].view(len(head), b)
            t_ext = pbt * self.page_size
        else:
            ints = self._to_dev(np.stack(head))
            t_ext = t
        act = ints[0].bool()
        pos = torch.clamp(ints[1] - 1, 0, t - 1)  # (B,) per-slot position
        x = gen.embed(self._ctx[rows, pos], pos)
        keep = act[:, None, None]
        t_mask = (self._t_idx[None, :t_ext] <= pos[:, None])[:, None, :]
        at = self._on_shards(rows, pos, keep, t_mask, *(
            () if pbt is None else (ints[5], ints[6], tables)))
        for (blk, moe), (ks, vs) in zip(gen._stages, self._kv):

            def attend(i, q, k_new, v_new):
                rows_, pos_, keep_, tm, *paged_at = at[i]
                if pbt is None:
                    ck, cv = ks[i], vs[i]
                    ck[rows_, pos_] = torch.where(keep_, k_new.to(ck.dtype),
                                                  ck[rows_, pos_])
                    cv[rows_, pos_] = torch.where(keep_, v_new.to(cv.dtype),
                                                  cv[rows_, pos_])
                else:
                    page, off, tab = paged_at
                    pk, pv = ks[i], vs[i]
                    # index_put_ picks an arbitrary winner among duplicate
                    # indices on CUDA: the active rows' (page, offset)
                    # targets are distinct pages each holds alone
                    # (``write_targets``), and every inactive row writes the
                    # sentinel page, whose contents nothing reads unmasked
                    pk[page, off] = k_new.to(pk.dtype)
                    pv[page, off] = v_new.to(pv.dtype)
                    ck = pk[tab].reshape(b, t_ext, -1, hd)
                    cv = pv[tab].reshape(b, t_ext, -1, hd)
                scores = torch.einsum("bhd,bthd->bht", q,
                                      ck.to(q.dtype)) / math.sqrt(hd)
                scores = scores.masked_fill(~tm, float("-inf"))
                w = torch.softmax(scores, dim=-1)
                return torch.einsum("bht,bthd->bhd", w, cv.to(w.dtype))

            x = gen._stage(blk, moe, x, attend)
        logit = gen._head(gen._final_ln(x))  # (B, V)
        if tmask is not None:
            logit = logit + self._to_dev(tmask)  # grammar: 0 / -inf rows
        if sampled:
            floats = self._to_dev(np.stack([self._temps, self._topp]))
            nxt = _sp.sample_tokens(
                logit, floats[0], ints[2], floats[1], ints[3], ints[4],
                filtered=bool((self._topk > 0).any()
                              or (self._topp < 1.0).any()),
            )
        else:
            nxt = torch.argmax(logit, dim=-1)
        wpos = torch.clamp(pos + 1, 0, t - 1)
        write = act & (pos + 1 <= t - 1)
        self._ctx[rows, wpos] = torch.where(write, nxt, self._ctx[rows, wpos])
        return nxt

    # -- speculative decode (draft -> verify -> rollback) -------------------

    def spec_step(self, active, seqs=None):
        """One speculative advance: draft up to ``draft_k`` tokens per
        active slot, verify all ``_kb + 1`` candidate positions against
        the live caches in one call, accept the window. Returns ``(toks,
        counts, used_verify)``: row i's first ``counts[i]`` entries of
        ``toks`` (B, _kb + 1) are the tokens slot i emits (1 to
        ``_kb + 1``). Rejected K/V sits at positions at or past the new
        frontier and is rewritten before anything attends it.

        An iteration where no active slot proposed runs the plain step
        (counted in ``spec_fallback_steps``). A drafter failure
        (admission or proposal) never fails a request: the slots are
        invalidated and decode goes on at the plain pace. Proposals are
        cached against a ``_lens`` snapshot, so a blame probe that
        retries a crashed verify on a subset re-verifies the same drafts.
        The ``stepper.verify`` seam fires after the proposals and before
        any device work."""
        active = np.asarray(active, bool)
        k = self._kb
        drafter = self.drafter
        # draft admission for slots that just turned decodable
        for i in np.flatnonzero(active):
            i = int(i)
            if i not in self._spec_admitted:
                self._spec_admitted.add(i)
                try:
                    drafter.admit(i, self._spec_prompts.get(i))
                except Exception:  # noqa: BLE001 — the draft is best-effort
                    drafter.invalidate(np.arange(self.num_slots) == i)
        pend = self._spec_pending
        if pend is not None and np.array_equal(pend[0][active],
                                               self._lens[active]):
            _, dtoks, dcnt = pend  # a blame probe's retry: the same drafts
        else:
            try:
                dtoks, dcnt = drafter.propose(active, self.draft_k, seqs)
            except Exception:  # noqa: BLE001 — the draft is best-effort
                drafter.invalidate(active)
                dtoks = np.zeros((self.num_slots, self.draft_k), np.int32)
                dcnt = np.zeros((self.num_slots,), np.int32)
            if dtoks.shape[1] < k:
                # pad to the pow2 bucket; dcnt masks the padding out
                dtoks = np.concatenate(
                    [dtoks, np.zeros((self.num_slots, k - dtoks.shape[1]),
                                     dtoks.dtype)], axis=1)
            if self._grammar:
                # constrained slots never draft: a future position's mask
                # is unknown before the tokens leading to it exist. They
                # emit candidate 0 alone (or the plain step on fallback);
                # zeroed before the proposal cache, so a blame probe's
                # retry sees the same drafts
                for i in self._grammar:
                    dtoks[i] = 0
                    dcnt[i] = 0
            self._spec_pending = (self._lens.copy(), dtoks, dcnt)
        if int(dcnt[active].sum()) == 0:
            self.spec_fallback_steps += 1
            toks = self.step(active)
            return (np.asarray(toks).reshape(-1, 1),
                    np.where(active, 1, 0).astype(np.int64), False)
        self._fire("stepper.verify", active=active)
        c = k + 1
        lens0 = self._lens.copy()
        res = self._run_verify(active, lens0, dtoks, dcnt,
                               self._build_tmask(active)).cpu().numpy()
        t_out, n_new = res[:, :c], res[:, c]
        counts = np.where(active, n_new, 0).astype(np.int64)
        self._lens[active] = np.minimum(
            self._lens[active] + counts[active], self._lens_cap
        )
        self._spos[active] += counts[active]
        if self._grammar:
            self._advance_grammar(t_out, counts)
        self.spec_verify_steps += 1
        self.spec_drafted_tokens += int(dcnt[active].sum())
        drafter.sync(active, t_out, counts, lens0)
        return t_out, counts, True

    def _run_verify(self, active, lens, dtoks, dcnt, tmask=None
                    ) -> torch.Tensor:
        """The verify program under its key: ``verify[c]`` dense,
        ``paged_verify[c,pbt]`` paged at the fixed extent (a window
        amortizes over c candidates, like a prefill chunk); ``,masked``
        appended when a grammar mask ``tmask`` rides along."""
        c = self._kb + 1
        tag = "" if tmask is None else ",masked"
        if self.paged:
            pbt = self._max_pages_bucket
            return self._run(f"paged_verify[{c},{pbt}{tag}]",
                             self._verify_dev, active, lens, dtoks, dcnt,
                             pbt, tmask)
        return self._run(f"verify[{c}{tag}]", self._verify_dev, active,
                         lens, dtoks, dcnt, None, tmask)

    @torch.no_grad()
    def _verify_dev(self, active, lens, dtoks, dcnt, pbt=None, tmask=None
                    ) -> torch.Tensor:
        """The verify window over host snapshots (paged when ``pbt`` is
        given): candidate j of row i is the token at ``lens[i] - 1 + j`` —
        the slot's last real token, then the proposals. Each block scatters
        the C candidates' K/V per row (inactive rows frozen: dense rows
        rewrite their own values, paged rows write the sentinel page) and
        attends them under a (B, H, C, T) causal mask; the window sampler
        picks the accepted tokens, which are written into the context rows
        at ``cpos + 1``. A grammar mask ``tmask`` applies to candidate 0
        alone (constrained slots never draft). Returns the (B, C + 1)
        device tensor of the window's tokens and, in the last column, the
        counts."""
        gen = self._gen
        b, c = self.num_slots, self._kb + 1
        hd = self._hd
        rows = self._rows
        sampled = bool((self._temps > 0.0).any())
        pos = np.clip(np.asarray(lens, np.int64) - 1, 0, self.max_len - 1)
        head = [active.astype(np.int64), pos, self._topk, self._seeds,
                self._spos, np.asarray(dcnt, np.int64)]
        parts = [np.stack(head).ravel(), np.asarray(dtoks, np.int64).ravel()]
        if pbt is not None:
            page, off = self.write_targets(active, lens, c)
            parts += [page.ravel(), off.ravel(),
                      self._tables_array(pbt).ravel()]
            t_ext = pbt * self.page_size
        else:
            t_ext = self._tp
        ints = self._to_dev(np.concatenate(parts))
        n_head = len(head) * b
        hv = ints[:n_head].view(len(head), b)
        dt = ints[n_head : n_head + b * (c - 1)].view(b, c - 1)
        if pbt is not None:
            o = n_head + b * (c - 1)
            page_d = ints[o : o + b * c].view(b, c)
            off_d = ints[o + b * c : o + 2 * b * c].view(b, c)
            tables_d = ints[o + 2 * b * c :].view(b, pbt)
        act, pos_d = hv[0].bool(), hv[1]
        cpos = pos_d[:, None] + torch.arange(c, device=self.device)[None, :]
        rows2 = rows[:, None]
        chunk = torch.cat([self._ctx[rows, pos_d][:, None], dt], dim=1)
        x = gen.embed(chunk, cpos)  # (B, C, d)
        keep = act[:, None, None, None]
        t_mask = (self._t_idx[None, None, :t_ext]
                  <= cpos[:, :, None])[:, None]  # (B, 1, C, T)
        at = self._on_shards(rows2, cpos, keep, t_mask, *(
            () if pbt is None else (page_d, off_d, tables_d)))
        for (blk, moe), (ks, vs) in zip(gen._stages, self._kv):

            def attend(i, q, k_new, v_new):
                rows_, cpos_, keep_, tm, *paged_at = at[i]
                if pbt is None:
                    # each row's C positions are distinct, and an inactive
                    # row rewrites its own values
                    ck, cv = ks[i], vs[i]
                    ck[rows_, cpos_] = torch.where(
                        keep_, k_new.to(ck.dtype), ck[rows_, cpos_])
                    cv[rows_, cpos_] = torch.where(
                        keep_, v_new.to(cv.dtype), cv[rows_, cpos_])
                else:
                    page, off, tab = paged_at
                    pk, pv = ks[i], vs[i]
                    # index_put_ picks an arbitrary winner among duplicate
                    # indices on CUDA: an active row's C targets are
                    # distinct (page, offset) pairs of pages it holds alone
                    # (``write_targets``); inactive rows write the sentinel
                    # page, whose contents nothing reads unmasked
                    pk[page, off] = k_new.to(pk.dtype)
                    pv[page, off] = v_new.to(pv.dtype)
                    ck = pk[tab].reshape(b, t_ext, -1, hd)
                    cv = pv[tab].reshape(b, t_ext, -1, hd)
                scores = torch.einsum("bchd,bthd->bhct", q,
                                      ck.to(q.dtype)) / math.sqrt(hd)
                scores = scores.masked_fill(~tm, float("-inf"))
                w = torch.softmax(scores, dim=-1)
                return torch.einsum("bhct,bthd->bchd", w, cv.to(w.dtype))

            x = gen._stage(blk, moe, x, attend)
        logit = gen._head(gen._final_ln(x))  # (B, C, V)
        if tmask is not None:
            # candidate 0 is a constrained slot's one emission
            logit = torch.cat([logit[:, :1] + self._to_dev(tmask)[:, None],
                               logit[:, 1:]], dim=1)
        dcnt_d = hv[5]
        if sampled:
            floats = self._to_dev(np.stack([self._temps, self._topp]))
            out, n_new = _sp.spec_window_tokens(
                logit, dt, dcnt_d, floats[0], hv[2], floats[1], hv[3], hv[4],
                filtered=bool((self._topk > 0).any()
                              or (self._topp < 1.0).any()),
            )
        else:
            out, n_new = _sp.greedy_window_tokens(logit, dt, dcnt_d)
        # the accepted tokens at cpos + 1 <= max_len - 1 + c < _tp: the
        # scratch absorbs the overrun
        wpos = cpos + 1
        wkeep = act[:, None] & (
            torch.arange(c, device=self.device)[None, :] < n_new[:, None]
        )
        self._ctx[rows2, wpos] = torch.where(wkeep, out,
                                             self._ctx[rows2, wpos])
        return torch.cat([out, n_new[:, None]], dim=1)

    def write_segment(self, active, toks, counts, lens0) -> None:
        """Write each active row's first ``counts[i]`` tokens of ``toks``
        at positions ``lens0[i] .. lens0[i] + counts[i] - 1`` of its
        context row (key ``accept_segment``) — how a draft bank is rolled
        back to the verified truth after a window. Positions past the
        padded axis are dropped."""
        toks = np.asarray(toks, np.int64)
        cw = toks.shape[1]
        keep = (np.asarray(active, bool)[:, None]
                & (np.arange(cw)[None, :] < np.asarray(counts)[:, None]))
        wpos = np.asarray(lens0, np.int64)[:, None] + np.arange(cw)[None, :]
        keep &= wpos < self._tp
        r, j = np.nonzero(keep)
        self._run("accept_segment", self._segment_dev,
                  np.concatenate([r, wpos[r, j], toks[r, j]]), r.size)

    def _segment_dev(self, ints, n):
        ints = self._to_dev(ints)
        # one write per (row, position): distinct indices
        self._ctx[ints[:n], ints[n : 2 * n]] = ints[2 * n :]


class ServingEngine:
    """The in-process serving runtime: continuous-batching decode plus
    windowed batch scoring over one model, driven by a dedicated scheduler
    thread and watched by a supervisor thread.

    ``generate`` is synchronous (submit + wait); ``submit`` returns the
    ``ServeRequest`` handle. ``stop(drain=True)`` refuses new work and
    completes everything already admitted or queued before returning.
    ``prefill_chunk``: per-iteration prefill token budget — "auto" picks
    ``max(16, seq_len // 8)``, an int sets it, None disables chunking.
    ``device=None`` means CUDA; the model must already live there.

    Cache knobs, with the JAX engine's defaults and meanings:
    ``prefix_cache`` (True builds a ``PrefixStore`` of
    ``prefix_cache_bytes`` on this engine's registry, an instance is used
    as it is and may be shared across engines, falsy turns reuse off),
    ``paged`` (block-paged K/V pools with page-gated admission and
    device-resident prefix sharing; see ``DecodeStepper``), ``page_size``
    and ``num_pages`` (None: the dense bank's bytes plus the sentinel).
    With ``paged`` the scheduler admits only what the pool covers (the
    head of the queue waits for evictions), a request that can never fit
    is a ``ValueError`` at ``submit``, and exhaustion reaches the client
    as the typed, retriable ``overloaded`` with ``retry_after_ms``.

    Speculative knobs, with the JAX engine's defaults and meanings:
    ``speculative`` (``"ngram"``: the prompt-lookup ``NgramDrafter``,
    suffixes up to ``ngram_max`` tokens; ``"draft"``: a ``ModelDrafter``
    over ``draft_bundle``, a serving-bundle path or a model on this
    engine's device; ``True``: ``"draft"`` when a bundle is given, else
    ``"ngram"``; or a drafter instance), ``draft_k`` (proposals per
    window: each iteration emits 1 to ``draft_k + 1`` tokens per slot)
    and ``spec_mode`` (``"rejection"`` serves sampled requests through the
    same windows, every token the plain sampled stream's; ``"strict"``
    refuses any sampling, engine-wide or per request). A restart rebuilds
    the stepper with the same drafter, which re-binds to it.

    QoS knob, with the JAX engine's meaning: ``qos``, an optional
    ``qos.QosPolicy``. None keeps the single FIFO. A policy makes the queue
    priority classes with per-tenant weighted fair queuing, and
    (``preempt=True``) lets a higher-priority request displace the
    lowest-priority decoding slot by swapping its KV out to the host and
    freeing its pages; resume is restore + re-reserve, token-identical
    across the boundary. Requests carry ``tenant``/``priority`` through
    ``submit``. A restart's rebuilt scheduler keeps the policy.

    Self-healing knobs, with the JAX engine's defaults and meanings:
    ``quarantine_steps`` (iterations a blamed slot sits out),
    ``overlap`` (True: the overlapped loop; False: dispatch and wait),
    ``watchdog_interval`` (seconds without a scheduler heartbeat before
    the supervisor declares it wedged, fails its in-flight requests typed
    and restarts it with a rebuilt stepper), ``watchdog_grace`` (seconds
    after each scheduler launch, and after each program mint or kernel
    build, during which wedge detection stays disarmed; default
    ``max(2, watchdog_interval)``; dead-thread detection is never
    graced), ``max_restarts`` (the lifetime restart budget: exhausted =
    the engine stays ``degraded`` and ``submit`` raises ``InternalError``)
    and ``restart_backoff`` (the base of the full-jitter delay between
    restarts, ``networking.RetryPolicy``'s schedule).

    The watchdog covers HOST wedges: a stuck lock, a pathological sleep,
    the fault seams' ``delay``. A scheduler hung inside a CUDA call is not
    cured by abandoning its thread — the device and its stream are shared
    with the next generation — so that case ends in ``degraded`` once the
    budget is spent, and nothing here tries more.

    A restart rebuilds the stepper from the same config (a paged engine
    gets a fresh pool and an empty device prefix index, a mesh the same
    shards); the host prefix store is kept.

    ``mesh``: tensor-parallel decode over a serving mesh (``"tp:N"``, an
    int or a ``ServingMesh``; see ``DecodeStepper``), resolved at load: an
    unknown spec, a mesh wider than the device pool or a head count it
    does not divide fails the boot (never a demotion to predict-only).
    Greedy replies equal the solo engine's on every admission path. The
    geometry rides ``health()`` (``mesh``, ``kv_shard_bytes``),
    ``stats()`` (``mesh``, ``paged.mesh``) and the gauges
    ``serving_mesh_devices`` and ``serving_kv_shard_bytes``. ``predict``
    reads the model's own weights on its device.

    ``kv_dtype``: the dtype of the K/V caches or pools (None: f32;
    ``torch.bfloat16`` halves them and the host rows of prefix entries and
    swaps; see ``DecodeStepper``). ``shed``: adaptive load shedding at the
    admission door, as in the JAX engine. False (the default) leaves the
    door as it is; True builds a ``resilience.AdmissionController`` with
    defaults, a dict passes its constructor kwargs, an instance is used as
    it is. Its brownout ladder reads this engine's ``burn_verdict``, its
    CoDel side the admitted requests' queue sojourns, and its refusals
    are typed ``overloaded`` with the gate's ``retry_after_ms``. Its state
    rides ``health()["shed"]`` and the ``serving_shed_rung`` gauge; the
    gate survives supervisor restarts.

    Books, as in the JAX engine: a flight recorder of events (armed
    fault-seam firings, blame, quarantine, watchdog trips, restarts,
    program mints, grammar exhaustions; ``flight_recorder=False`` turns it
    off, ``recorder_capacity`` bounds it), a span ring of ``trace_ring``
    spans, a metrics history a snapshot every ``history_interval``
    seconds, ``history_capacity`` deep, for the ``timeseries`` verb
    (``history=False`` turns it off), and a ``compile_ledger`` shared by
    every stepper generation. ``postmortem_dir`` is where a trip's bundle
    is written (None keeps it in memory for the ``postmortem`` verb);
    ``slos`` (a list of ``obs.SloSpec``) grade this registry at most every
    ``slo_interval`` seconds, their verdicts ride ``health``;
    ``metrics_path`` adds a JSONL sink (``serving_submit``/
    ``serving_complete`` events and drained trace spans).

    Disaggregation, with the JAX engine's meanings: ``role`` is
    ``"unified"`` (prefill and decode), ``"prefill"`` (``prefill`` only:
    plain ``generate`` is refused typed ``wrong_role``) or ``"decode"``
    (``resume`` and plain ``generate``; ``prefill`` is refused). The
    transfer ledger (``transfer_snapshot``: frames and bytes each way,
    errors, the in-flight count) rides ``health``/``stats`` and the
    ``serving_transfer_*`` metrics. ``kv_epoch`` and ``peer_fabric`` are
    the KV fabric's identity and transport (no socket opens until used).
    """

    def __init__(self, model, num_slots=8, queue_capacity=64,
                 temperature=0.0, seed=0, top_k=None, top_p=None,
                 kv_dtype=None, predict_batch=64, predict_window=0.005,
                 prefill_chunk="auto", prefix_cache=True,
                 prefix_cache_bytes=64 << 20, quarantine_steps=64,
                 watchdog_interval=10.0, watchdog_grace=None,
                 max_restarts=3, restart_backoff=0.05, metrics_path=None,
                 speculative=None, draft_bundle=None, draft_k=4,
                 ngram_max=3, spec_mode="rejection", flight_recorder=True,
                 recorder_capacity=2048, postmortem_dir=None, slos=None,
                 slo_interval=5.0, paged=False, page_size=16,
                 num_pages=None, qos=None, history=True,
                 history_interval=1.0, history_capacity=600,
                 trace_ring=8192, overlap=True, shed=False, role="unified",
                 mesh=None, device=None):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role must be 'unified', 'prefill', or "
                             f"'decode'; got {role!r}")
        self.role = str(role)
        self.model = model
        self.device = check_model_device(model, device)
        # a config error, raised here rather than demoting the engine
        kv_dtype = resolve_kv_dtype(kv_dtype)
        drafter = self._resolve_drafter(speculative, draft_bundle, ngram_max,
                                        self.device)
        self.spec_mode = spec_mode
        if drafter is not None:
            # a config error, not a model limitation: raised here rather
            # than demoting the engine to predict-only below
            self.spec_mode = _sp.check_spec_sampling(
                spec_mode, temperature, top_k, top_p
            )
        # the engine-owned books (per engine, so in-process fleets keep
        # per-replica registries and span rings)
        self.registry = MetricsRegistry()
        self.trace_collector = TraceCollector(capacity=trace_ring,
                                              on_drop=self._on_trace_drop)
        self.registry.gauge(
            "serving_trace_collector_dropped",
            fn=lambda: self.trace_collector.dropped_total,
        )
        self.recorder = (FlightRecorder(capacity=recorder_capacity)
                         if flight_recorder else None)
        if self.recorder is not None:
            self.recorder.register_gauges(self.registry, "serving")
        # the compile ledger outlives stepper generations: a rebuilt
        # stepper's first calls are attributed as rewarms
        self.compile_ledger = CompileLedger(
            registry=self.registry, recorder=self.recorder,
            prefix="serving", inflight_fn=self._inflight_estimate,
        )
        self.history = (
            MetricsHistory(self.metrics_snapshot, interval=history_interval,
                           capacity=history_capacity)
            if history else None
        )
        self.postmortem_dir = postmortem_dir
        self.last_postmortem = None
        self.last_postmortem_path = None
        self._stepper = None
        self._decode_err = None
        store = None
        if prefix_cache:
            store = (
                prefix_cache
                if isinstance(prefix_cache, PrefixStore)
                else PrefixStore(max_bytes=prefix_cache_bytes,
                                 registry=self.registry)
            )
        self.prefix_store = store
        if store is not None:
            # fabric staleness: seconds since the store's content (and so
            # its advertised digest) last moved
            self.registry.gauge("serving_kv_fabric_digest_age_seconds",
                                fn=store.digest_age)
        # the serving mesh, resolved LOUDLY at load: an unknown spec or a
        # mesh wider than the device pool fails the boot, not a step
        self._mesh = (None if mesh is None
                      else serving_mesh(mesh, device=self.device))
        # everything a supervisor restart needs to rebuild the device face
        # (a fresh bank or pool and device prefix index; the host prefix
        # store is the same object, so it SURVIVES restarts, and the
        # drafter re-binds to each rebuilt stepper)
        self._stepper_cfg = dict(
            num_slots=num_slots, temperature=temperature, seed=seed,
            top_k=top_k, top_p=top_p, kv_dtype=kv_dtype, device=self.device,
            compile_ledger=self.compile_ledger, prefix_cache=store,
            paged=paged, page_size=page_size, num_pages=num_pages,
            recorder=self.recorder, speculative=drafter, draft_k=draft_k,
            spec_mode=self.spec_mode, mesh=self._mesh,
        )
        try:
            self._stepper = DecodeStepper(model, **self._stepper_cfg)
            self._stepper.on_compile = self._extend_grace
        except ValueError as e:
            if self._mesh is not None:
                # a mesh asked for sharded decode: demoting to predict-only
                # would hide a config error (heads the mesh does not
                # divide), so the boot fails
                raise
            # non-LM models (and hooked ones) still serve predict;
            # generate replies with this error
            self._decode_err = e
        if self._stepper is not None and prefill_chunk == "auto":
            prefill_chunk = max(16, self._stepper.max_len // 8)
        # the gate rides the batcher config, so a restart's rebuilt batcher
        # keeps it: its sojourn history and rung are evidence about the
        # host, not about one batcher
        self.shed_gate = as_shed_gate(shed, burn_fn=self.burn_verdict)
        if self.shed_gate is not None:
            self.registry.gauge("serving_shed_rung",
                                fn=lambda: self.shed_gate.state()["rung"])
        self._batcher_cfg = dict(
            queue_capacity=queue_capacity, prefill_chunk=prefill_chunk,
            quarantine_steps=quarantine_steps, registry=self.registry,
            recorder=self.recorder, qos=qos, overlap=overlap,
            shed_gate=self.shed_gate,
        )
        self.qos = qos
        self.batcher = (
            None
            if self._stepper is None
            else ContinuousBatcher(self._stepper, **self._batcher_cfg)
        )
        self._predictor = ModelPredictor(
            model, batch_size=int(predict_batch), device=self.device
        )
        self._predict_batcher = WindowedBatcher(
            self._run_predict_batch, max_batch=int(predict_batch),
            max_wait=float(predict_window),
        )
        self.metrics = None
        if metrics_path is not None:
            from distkeras_tpu_torch.utils.profiling import MetricsLogger

            self.metrics = MetricsLogger(metrics_path)
        self._thread = None
        self._stop_evt = threading.Event()
        self._started = False
        # supervisor state: the scheduler loop stamps _heartbeat every
        # iteration; the supervisor watches it and the thread's liveness
        self.watchdog_interval = float(watchdog_interval)
        self.watchdog_grace = (
            max(2.0, self.watchdog_interval)
            if watchdog_grace is None
            else float(watchdog_grace)
        )
        self._grace_until = 0.0
        self.max_restarts = int(max_restarts)
        self._restart_delays = RetryPolicy(
            max_attempts=self.max_restarts + 1,
            base_delay=float(restart_backoff), max_delay=2.0, seed=seed,
        )
        self._supervisor = None
        self._crash_evt = threading.Event()  # crash boundary -> supervisor
        self._heartbeat = time.monotonic()
        self._restarts = 0
        self._watchdog_trips = 0
        self._failed = False  # permanently degraded (see _failed_reason)
        self._failed_reason = None
        self._last_crash = None
        #: wall seconds of the last restart: backoff, rebuild, warmup
        self.last_restart = None
        reg = self.registry
        reg.gauge("serving_engine_restarts", fn=lambda: self._restarts)
        reg.gauge("serving_engine_watchdog_trips",
                  fn=lambda: self._watchdog_trips)
        reg.gauge("serving_engine_degraded", fn=lambda: self._failed)
        reg.gauge(
            "serving_engine_prefix_fetch_failures",
            fn=lambda: (
                0 if self._stepper is None
                else self._stepper.prefix_fetch_failures
            ),
        )
        # the decode geometry: the devices this replica's decode spans (1
        # solo) and the K/V bytes resident on each, what a capacity
        # planner compares against one device's memory
        reg.gauge("serving_mesh_devices", fn=lambda: (
            None if self._stepper is None else self._stepper.mesh_devices))
        reg.gauge("serving_kv_shard_bytes", fn=lambda: (
            None if self._stepper is None
            else self._stepper.kv_shard_bytes()))
        # grammar masks applied and forced-EOS fallbacks, read from the
        # live stepper generation
        for name, attr in (("serving_constrained_masks", "constrained_masks"),
                           ("serving_mask_exhaustions", "mask_exhaustions")):
            reg.gauge(name, fn=lambda attr=attr: (
                0 if self._stepper is None
                else getattr(self._stepper, attr)))
        # the disaggregation books: the role as a stable id (0 unified, 1
        # prefill, 2 decode), the transfer ledger and the transfers in
        # flight (prefills admitted but not yet encoded)
        reg.gauge("serving_engine_role_id",
                  fn=lambda: {"unified": 0, "prefill": 1,
                              "decode": 2}[self.role])
        self._transfer_pending = 0
        # prefills run on the server's connection threads at once
        self._transfer_lock = threading.Lock()
        reg.gauge("serving_transfer_pending",
                  fn=lambda: self._transfer_pending)
        self.transfer_sends = reg.counter("serving_transfer_sends",
                                          fresh=True)
        self.transfer_recvs = reg.counter("serving_transfer_recvs",
                                          fresh=True)
        self.transfer_errors = reg.counter("serving_transfer_errors",
                                           fresh=True)
        self.transfer_bytes_out = reg.counter("serving_transfer_bytes_out",
                                              fresh=True)
        self.transfer_bytes_in = reg.counter("serving_transfer_bytes_in",
                                             fresh=True)
        # the KV fabric's identity and transport: a RANDOM 32-bit epoch,
        # minted anew by every supervisor restart (a restarted engine never
        # collides with its predecessor's promises), and the pooled peer
        # clients (no socket until a fetch or a push)
        self.kv_epoch = int.from_bytes(os.urandom(4), "big")
        self.peer_fabric = kv_transfer.PeerFabric(registry=self.registry)
        if paged:
            # page-pool gauges, read from the live stepper generation (a
            # supervisor restart rebuilds the pool)
            def pool_gauge(read):
                def fn():
                    st = self._stepper
                    return None if st is None else read(st._kv_alloc)
                return fn

            for name, read in (
                ("total", lambda a: a.total_pages),
                ("in_use", lambda a: a.pages_in_use),
                ("shared", lambda a: a.shared_pages),
            ):
                reg.gauge(f"serving_kv_pages_{name}", fn=pool_gauge(read))
            reg.gauge("serving_kv_cow_copies",
                      fn=pool_gauge(lambda a: a.cow_copies))
            reg.gauge("serving_kv_page_util",
                      fn=pool_gauge(lambda a: round(a.utilization(), 4)))
        reg.gauge(
            "serving_engine_heartbeat_age_seconds",
            fn=lambda: (
                time.monotonic() - self._heartbeat
                if self._started and self.batcher is not None else None
            ),
        )
        # per-phase request latency histograms, observed in ``wait``
        self._lat_hists = {
            phase: reg.histogram(f"serving_request_{phase}_seconds")
            for phase in ("queue_wait", "prefill", "decode", "ttft", "total")
        }
        self._tenant_lat_hists: dict[tuple, object] = {}
        self._tenants_seen: set[str] = set()
        self.slo = None
        if slos:
            self.slo = SloEvaluator(
                slos, self.metrics_snapshot, interval=slo_interval,
                registry=reg, recorder=self.recorder, prefix="serving",
            )

    @staticmethod
    def _resolve_drafter(speculative, draft_bundle, ngram_max, device):
        """The draft source the speculative knobs name (None: off)."""
        if not speculative:
            if draft_bundle is not None:
                raise ValueError(
                    "draft_bundle is only meaningful with speculative "
                    "decoding enabled; pass speculative='draft'"
                )
            return None
        if hasattr(speculative, "propose") and hasattr(speculative, "bind"):
            return speculative  # any object with the drafter protocol
        if speculative is True:
            speculative = "draft" if draft_bundle is not None else "ngram"
        if speculative == "ngram":
            return NgramDrafter(ngram_max=ngram_max)
        if speculative == "draft":
            if draft_bundle is None:
                raise ValueError(
                    "speculative='draft' needs draft_bundle= (a serving-"
                    "bundle path or a model instance)"
                )
            if isinstance(draft_bundle, str):
                from distkeras_tpu_torch.utils.serialization import (
                    load_serving_bundle,
                )

                draft_bundle = load_serving_bundle(draft_bundle,
                                                   device=device)
            return ModelDrafter(draft_bundle)
        raise ValueError(
            f"speculative must be falsy, True, 'ngram', 'draft', or a "
            f"drafter instance; got {speculative!r}"
        )

    @classmethod
    def from_bundle(cls, path: str, **kwargs) -> "ServingEngine":
        """Boot from a quantized serving bundle on disk
        (``utils.serialization.load_serving_bundle`` validates structure,
        shapes and dtypes first); the model is loaded onto ``device``."""
        from distkeras_tpu_torch.utils.serialization import (
            load_serving_bundle,
        )

        model = load_serving_bundle(path, device=kwargs.get("device"))
        return cls(model, **kwargs)

    def _on_trace_drop(self):
        if self.recorder is not None:
            self.recorder.record(
                "trace.drops", capacity=self.trace_collector.capacity
            )

    def _inflight_estimate(self):
        """Requests queued or slotted, for the compile ledger's per-mint
        stamp (unlocked reads: a torn read is fine for a blast radius)."""
        batcher = self.batcher
        if batcher is None:
            return None
        return len(batcher._queue) + sum(
            s is not None for s in batcher._slots
        )

    def start(self) -> "ServingEngine":
        if self._started:
            return self
        self._started = True
        if self.recorder is not None:
            faults.add_observer(self.recorder.fault_observer)
        add_build_observer(self._on_build)
        self._predict_batcher.start()
        if self.batcher is not None:
            self._launch_scheduler(self.batcher)
            self._supervisor = threading.Thread(
                target=self._supervise, name="serving-supervisor",
                daemon=True,
            )
            self._supervisor.start()
        return self

    def _on_build(self, names, seconds):
        """Kernel build observer: a first-use ``nvcc`` build stalls the
        thread that needs the kernel, so the wedge detector's grace is
        pushed out before it starts (every engine's: a sibling may wait on
        the build lock), and a build that this engine's own thread ran is
        a ``build[<kernels>]`` mint on its compile ledger."""
        self._extend_grace()
        if seconds is not None and (
                _WARM_SCOPE.ledger is self.compile_ledger):
            self.compile_ledger.record_mint(
                f"build[{','.join(names)}]", seconds, warming=in_warmup()
            )

    def _extend_grace(self):
        """A program is about to mint (stepper ``on_compile``, a kernel
        build, each scheduler launch): push the wedge detector's grace
        window out so the mint is never read as a wedged scheduler.
        Dead-thread detection is unaffected."""
        self._grace_until = max(
            self._grace_until, time.monotonic() + self.watchdog_grace
        )

    def _launch_scheduler(self, batcher):
        self._heartbeat = time.monotonic()
        self._grace_until = self._heartbeat + self.watchdog_grace
        self._thread = threading.Thread(
            target=self._loop, args=(batcher,), name="serving-engine",
            daemon=True,
        )
        self._thread.start()

    def _loop(self, batcher):
        """The scheduler thread: admit/step/evict until stopped; in drain
        mode, exit once everything in flight completed. A crash that
        escapes the batcher's blame machinery wakes the supervisor, which
        dumps the post-mortem while the in-flight table still holds the
        crash-time state, fails every pending request TYPED
        (``InternalError``) and restarts the loop with a rebuilt stepper.
        ``batcher`` is bound at thread start: a superseded
        (restart-replaced) loop notices and exits instead of driving the
        new generation's state."""
        _WARM_SCOPE.ledger = self.compile_ledger
        try:
            while True:
                if self.batcher is not batcher:
                    return  # superseded by a supervisor restart
                self._heartbeat = time.monotonic()
                faults.fire("scheduler.loop", busy=not batcher.idle)
                progressed = batcher.step()
                if self._stop_evt.is_set() and batcher.idle:
                    return
                if not progressed:
                    if self._stop_evt.is_set():
                        return
                    batcher.wait_for_work()
        except Exception as e:  # noqa: BLE001 — scheduler crash boundary
            self._last_crash = repr(e)
            self._record("engine.crash", error=repr(e)[:200])
            if self.metrics is not None:
                self.metrics.log(event="serving_engine_crash", error=repr(e))
            self._crash_evt.set()  # wake the supervisor immediately

    # -- supervisor ---------------------------------------------------------

    def _supervise(self):
        """Watchdog: a dead scheduler thread (crash boundary fired) or a
        wedged one (no heartbeat for ``watchdog_interval`` outside the
        grace window) trips a restart. A wedged thread cannot be killed:
        it is ABANDONED — its batcher is stopped (in-flight requests fail
        typed) and replaced, and the zombie exits at its next iteration
        through the superseded check. The history ring's cadence rides
        this poll loop, so the time series keeps ticking through a
        wedge."""
        poll = max(0.01, min(0.05, self.watchdog_interval / 4))
        while not self._stop_evt.is_set():
            self._crash_evt.wait(timeout=poll)
            self._crash_evt.clear()
            if self._stop_evt.is_set():
                return
            if self.history is not None:
                self.history.maybe_snap()  # cadence-guarded
            th = self._thread
            if th is None or self._failed:
                continue
            now = time.monotonic()
            dead = not th.is_alive()
            wedged = (
                now - self._heartbeat > self.watchdog_interval
                and now > self._grace_until  # mints are not wedges
            )
            if not dead and not wedged:
                continue
            self._watchdog_trips += 1
            self._record(
                "engine.watchdog_trip", dead=dead, wedged=wedged,
                restarts=self._restarts,
                heartbeat_age=round(now - self._heartbeat, 3),
                last_crash=self._last_crash,
            )
            if self.metrics is not None:
                self.metrics.log(event="serving_watchdog_trip", dead=dead,
                                 wedged=wedged, restarts=self._restarts)
            # dump BEFORE the restart tears the old batcher down: the
            # bundle's in-flight table is the state at trip time
            self._safe_dump("watchdog_trip", {
                "dead": dead, "wedged": wedged,
                "last_crash": self._last_crash,
            })
            self._restart(dead)

    def _record(self, event, **fields):
        if self.recorder is not None:
            self.recorder.record(event, **fields)

    def _degrade(self, reason):
        self._failed = True
        self._failed_reason = reason
        self._record("engine.degraded", reason=reason)
        self._safe_dump("degraded", {"reason": reason})

    def _restart(self, dead):
        """Fail everything the old scheduler generation held (typed),
        then rebuild the stepper, warm it HERE on the supervisor thread
        (so the first live iteration serves rather than mints), and swap
        it in under the restart budget with full-jitter backoff. An
        exhausted budget degrades the engine for good (its bundle dumped
        before the requests fail)."""
        t0 = time.monotonic()
        exhausted = self._restarts >= self.max_restarts
        if exhausted:
            self._degrade(
                f"scheduler restart budget exhausted "
                f"({self._restarts}/{self.max_restarts})"
            )
        self.batcher.stop(error=InternalError(
            "scheduler " + ("crashed" if dead else "wedged")
            + "; in-flight request aborted by the supervisor"
        ))
        if exhausted:
            if self.metrics is not None:
                self.metrics.log(event="serving_restart_budget_exhausted",
                                 restarts=self._restarts)
            return
        if self._stop_evt.wait(self._restart_delays.delay(self._restarts)):
            return  # shutdown arrived during the backoff
        try:
            stepper = DecodeStepper(self.model, **self._stepper_cfg)
            stepper.on_compile = self._extend_grace
            t_warm = time.monotonic()
            stepper.warmup()
            warm_s = time.monotonic() - t_warm
        except Exception as e:  # noqa: BLE001 — rebuild is last-resort
            self._last_crash = repr(e)
            self._degrade(f"stepper rebuild failed: {e!r}")
            return
        # published before the restart count, which readers poll
        self.last_restart = {"seconds": time.monotonic() - t0,
                             "warmup_seconds": warm_s}
        self._restarts += 1
        self._stepper = stepper
        # a new scheduler generation is a new KV epoch: a sibling routing
        # on the old digest is refused typed ``stale_epoch``
        self.kv_epoch = int.from_bytes(os.urandom(4), "big")
        batcher = ContinuousBatcher(stepper, **self._batcher_cfg)
        self.batcher = batcher
        self._launch_scheduler(batcher)
        self._record("engine.restarted", restarts=self._restarts)
        if self.metrics is not None:
            self.metrics.log(event="serving_engine_restarted",
                             restarts=self._restarts)

    def stop(self, drain=True):
        """Shutdown. ``drain=True``: stop admissions, finish queued and
        in-flight requests, then stop; ``drain=False``: fail them."""
        self._stop_evt.set()
        self._crash_evt.set()  # wake the supervisor so it can exit
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
            self._supervisor = None
        batcher = self.batcher
        if batcher is not None:
            if drain:
                batcher.drain()
            else:
                batcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if batcher is not None and (not drain or not batcher.idle):
            # fail anything the loop left behind (hard stop, or a drain
            # whose scheduler thread was already dead)
            batcher.stop()
        self._predict_batcher.close()
        self.peer_fabric.close()  # pooled peer sockets do not leak
        remove_build_observer(self._on_build)
        if self.recorder is not None:
            faults.remove_observer(self.recorder.fault_observer)
        self.drain_traces()  # the tail of the span ring is not lost

    # -- generate -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None, deadline=None,
               trace=None, sampling=None, tenant=None, priority=0,
               stream=False, kv_peers=None,
               _prefill_only=False) -> ServeRequest:
        """Queue one generate request; ``sampling`` is a
        ``SamplingParams`` or its wire dict (None = the engine default);
        ``n > 1`` schedules n completions through copy-on-write forks
        (paged engines; a dense one refuses with ``ValueError``).
        ``trace``: an ``obs.TraceContext`` (the scheduler then keeps the
        request's event ledger). ``tenant``/``priority``: the QoS identity
        (default tenant "default", priority 0); without a ``qos`` policy
        they only label metrics, with one they pick the WFQ share and the
        priority class (higher = more urgent, may preempt). ``stream``:
        the scheduler pushes each iteration's tokens into the request's
        chunk FIFO (``req.next_chunk``).

        ``kv_peers``: a router's page-affinity hints, ``[{"endpoint":
        [host, port], "epoch": E, "len": n}, ...]``. Before admission any
        peer promising more coverage than the local prefix store holds is
        dialed (``kv.fetch``) and its validated rows inserted locally, so
        admission's prefix restore hits. Fail-soft: every failure leaves
        the store as it was and admission recomputes, token-identical."""
        if self.role == "prefill" and not _prefill_only:
            raise WrongRoleError(
                "this engine serves role 'prefill': plain generate is not "
                "served here; send prompts through the prefill verb"
            )
        batcher = self.batcher
        if batcher is None:
            raise EngineStoppedError(
                f"model does not support generate: {self._decode_err}"
            )
        if not self._started:
            raise EngineStoppedError("engine not started")
        if self._failed:
            raise InternalError(f"engine is degraded: {self._failed_reason}")
        sampling = _sp.SamplingParams.from_wire(sampling)
        if sampling is not None and self._stepper.speculative:
            # strict mode refuses sampled requests through the same check
            # the constructors use; rejection mode serves them
            _sp.check_spec_sampling(self.spec_mode, sampling.temperature,
                                    sampling.top_k, sampling.top_p)
        if kv_peers:
            # before the request enters the batcher: the scheduler thread's
            # admission reads the store after this thread's insert
            self._peer_prefetch(prompt, kv_peers)
        req = ServeRequest(
            prompt, max_new_tokens, eos_id=eos_id, deadline=deadline,
            trace=trace, sampling=sampling, tenant=tenant,
            priority=priority, stream=stream, prefill_only=_prefill_only,
        )
        return self._admit(req)

    def _admit(self, req: ServeRequest) -> ServeRequest:
        """The admission ``submit`` and ``resume`` share: the batcher's
        submit (a batcher a restart stopped under us reads as ``internal``,
        not as a drain) and the ``serving_submit`` JSONL record."""
        batcher = self.batcher
        try:
            try:
                return batcher.submit(req)
            except EngineStoppedError:
                if self._stop_evt.is_set():
                    raise
                raise InternalError(
                    "scheduler restarting after a failure; retry shortly"
                ) from None
        finally:
            if self.metrics is not None:
                load = batcher.load()
                self.metrics.log(
                    event="serving_submit", request_id=req.id,
                    prompt_len=int(req.prompt.size),
                    max_new_tokens=req.max_new_tokens,
                    queue_depth=load["queue_depth"],
                    active_slots=load["active_slots"],
                )

    def generate(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                 timeout=None, trace=None, sampling=None, tenant=None,
                 priority=0) -> np.ndarray:
        """The full sequence (prompt + generated, eos-trimmed); with
        ``sampling.n > 1``, the list of n such sequences."""
        req = self.submit(prompt, max_new_tokens, eos_id=eos_id,
                          deadline=deadline, trace=trace, sampling=sampling,
                          tenant=tenant, priority=priority)
        return self.wait(req, timeout)

    def wait(self, req: ServeRequest, timeout=None) -> np.ndarray:
        """Block on a submitted request, then run its completion
        bookkeeping: the latency histograms (tenant-labeled twins of
        ``ttft``/``total`` for a named tenant), the ``serving_complete``
        JSONL record and, for a traced request, the span drain."""
        try:
            return req.result(timeout)
        finally:
            if req.done:
                self._complete(req)

    def _complete(self, req):
        lat = req.latency()
        for phase, hist in self._lat_hists.items():
            if lat[phase] is not None:
                hist.observe(lat[phase])
        if req.tenant != "default":
            # the tenant is a client-chosen wire string: past
            # MAX_TENANT_LABELS distinct names the rest share one label
            tenant = fold_tenant(self._tenants_seen, req.tenant)
            for phase in ("ttft", "total"):
                if lat[phase] is None:
                    continue
                key = (tenant, phase)
                h = self._tenant_lat_hists.get(key)
                if h is None:
                    h = self._tenant_lat_hists[key] = self.registry.histogram(
                        f"serving_request_{phase}_seconds",
                        labels={"tenant": tenant},
                    )
                h.observe(lat[phase])
        if self.metrics is not None:
            self.metrics.log(
                event="serving_complete", request_id=req.id,
                tokens=len(req.tokens),
                error=None if req.error is None else req.error.code,
                **{k: v for k, v in lat.items() if v is not None},
            )
            if req.trace is not None:
                self.drain_traces()

    # -- disaggregated prefill/decode ---------------------------------------

    def prefill(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                sampling=None, tenant=None, priority=0, timeout=None):
        """The prefill worker's half: admit and prefill ``prompt``, then
        serialize the finished slot (its ``swap_out`` state) into one
        ``kv_transfer`` frame and free the slot; ``resume`` on another
        engine decodes it. Returns ``(blob, meta)``, ``meta`` the JSON-able
        summary the wire reply carries.

        The ``kv.transfer`` seam fires (direction "send") before the wait;
        any failure fails only this request, typed (a ``ServingError`` as
        itself, anything else ``internal``), counts in
        ``serving_transfer_errors`` and lands on the tape as
        ``kv.transfer.error`` naming the exception class."""
        if self.role == "decode":
            raise WrongRoleError(
                "this engine serves role 'decode': it resumes transferred "
                "slots, it does not prefill for export"
            )
        sampling = _sp.SamplingParams.from_wire(sampling)
        req = self.submit(prompt, max_new_tokens, eos_id=eos_id,
                          deadline=deadline, sampling=sampling,
                          tenant=tenant, priority=priority,
                          _prefill_only=True)
        with self._transfer_lock:
            self._transfer_pending += 1
        try:
            faults.fire("kv.transfer", direction="send", request_id=req.id)
            self.wait(req, timeout)  # raises the typed failure, if any
            blob = kv_transfer.encode_state(
                req.export, prompt_len=int(req.prompt.size),
                sampling=sampling, eos_id=req.eos_id,
            )
        except Exception as e:  # noqa: BLE001 — transfer boundary
            self.transfer_errors.inc()
            self._record("kv.transfer.error", op="send", request_id=req.id,
                         error=type(e).__name__, detail=repr(e)[:200])
            if isinstance(e, ServingError):
                raise
            raise InternalError(f"kv transfer send failed: {e!r}") from e
        finally:
            with self._transfer_lock:
                self._transfer_pending -= 1
            req.export = None  # the host K/V rows go with the frame
        self.transfer_sends.inc()
        self.transfer_bytes_out.inc(len(blob))
        meta = {"len": int(req.prompt.size),
                "prompt_len": int(req.prompt.size), "bytes": len(blob),
                "version": kv_transfer.VERSION}
        self._record("kv.transfer.send", request_id=req.id, bytes=len(blob),
                     tokens=int(req.prompt.size))
        return blob, meta

    def _check_frame(self, state) -> None:
        """A transfer state must fit this engine's model: one K/V stage a
        block, each ``(rows, heads, head_dim)`` with at most ``len - 1``
        rows, and a context inside the prompt row. A frame that does not
        fit is a typed ``KvTransferError``; nothing is admitted."""
        st = self._stepper
        ln = int(state["len"])
        want = (st._nh, st._hd)
        kv = state["kv"]
        bad = (len(kv) != len(st._gen._blocks) or ln > st.max_len
               or any(k.ndim != 3 or tuple(k.shape[1:]) != want
                      or k.shape[0] > ln - 1 or k.shape != v.shape
                      for k, v in kv))
        if bad:
            raise kv_transfer.KvTransferError(
                f"transfer frame does not fit this model: len {ln}, "
                f"stages {[tuple(k.shape) for k, _ in kv]}; the engine "
                f"holds {len(st._gen._blocks)} blocks of {want} rows and "
                f"{st.max_len} positions"
            )

    def resume(self, state, max_new_tokens, eos_id=None, deadline=None,
               trace=None, tenant=None, priority=0,
               stream=False) -> ServeRequest:
        """The decode worker's half: admit a transferred slot — a
        ``kv_transfer`` frame (bytes) or a decoded state dict — and decode
        it to completion. Returns the ``ServeRequest`` (``wait`` for the
        sequence; ``stream=True`` for the chunk FIFO). The resumed stream
        is token-identical to an uninterrupted decode of the same prompt
        and params on one engine. Admission goes through the batcher's
        swap-in (``req._swap``), so a paged engine reserves its pages
        there.

        The ``kv.transfer`` seam fires (direction "recv") before the frame
        is decoded; a corrupt, truncated or ill-fitting frame raises the
        typed ``KvTransferError`` (nothing admitted), and every failure
        lands on the tape naming its class."""
        if self.role == "prefill":
            raise WrongRoleError(
                "this engine serves role 'prefill': transferred slots "
                "resume on a decode worker"
            )
        if self.batcher is None:
            raise EngineStoppedError(
                f"model does not support generate: {self._decode_err}"
            )
        try:
            faults.fire("kv.transfer", direction="recv")
            nbytes = None
            if isinstance(state, (bytes, bytearray, memoryview)):
                nbytes = len(state)
                state = kv_transfer.decode_state(bytes(state))
            self._check_frame(state)
            sampling = state.get("sampling")
            plen = int(state["prompt_len"])
            ln = int(state["len"])
            ctx = np.asarray(state["ctx"], np.int32)
            emitted = [int(t) for t in ctx[plen:ln]]
            grammar = None
            if sampling is not None and sampling.grammar is not None:
                # grammar state is a pure function of (spec, eos, consumed
                # tokens): recompiled and replayed, never carried
                grammar = self._stepper._mask_compiler.compile(
                    sampling.grammar, eos_id=state.get("eos_id"))
                for t in emitted:
                    grammar.advance(t)
            req = ServeRequest(
                ctx[:plen], max_new_tokens,
                eos_id=state.get("eos_id") if eos_id is None else eos_id,
                deadline=deadline, trace=trace, sampling=sampling,
                tenant=tenant, priority=priority, stream=stream,
            )
            req.tokens.extend(emitted)
            # the stepper-format swap dict the batcher's resume hands to
            # swap_in: what a QoS preemption parks on the request
            req._swap = {
                "len": ln, "ctx": ctx[:ln], "kv": state["kv"],
                "spos": int(state["spos"]), "seed": int(state["seed"]),
                "params": sampling, "grammar": grammar,
                "spec_prompt": state.get("spec_prompt"),
            }
            self._admit(req)
        except Exception as e:  # noqa: BLE001 — transfer boundary
            self.transfer_errors.inc()
            self._record("kv.transfer.error", op="recv",
                         error=type(e).__name__, detail=repr(e)[:200])
            if isinstance(e, ServingError):
                raise
            raise InternalError(f"kv transfer receive failed: {e!r}") from e
        self.transfer_recvs.inc()
        if nbytes is not None:
            self.transfer_bytes_in.inc(nbytes)
        self._record("kv.transfer.recv", request_id=req.id, bytes=nbytes,
                     tokens=ln)
        return req

    # -- fleet KV fabric ----------------------------------------------------

    def _peer_prefetch(self, prompt, kv_peers) -> None:
        """Best-effort peer prefix fetch ahead of one admission: for every
        hint promising more coverage than the local store holds, pull the
        sibling's rows over the fabric and insert them (pow2 ladder, no
        two-touch gate: they were proven hot on the sibling). A fetch only
        adds to the cache, so success and every failure alike decode
        token-identically. Never raises: each failure is counted in
        ``fetch_degraded`` and recorded."""
        store = self.prefix_store
        fab = self.peer_fabric
        if store is None:
            return
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        have = store.coverage(tokens)
        for peer in kv_peers:
            try:
                ep = peer.get("endpoint")
                want = int(peer.get("len") or 0)
                epoch = peer.get("epoch")
            except (AttributeError, TypeError, ValueError):
                continue  # a malformed hint is never worth a request
            if ep is None or want <= have:
                continue  # the local store already covers this promise
            try:
                state = fab.fetch(ep, tokens[:want], epoch=epoch)
            except Exception as e:  # noqa: BLE001 — fail-soft boundary
                fab.counters["fetch_degraded"] += 1
                self._record("kv.peer.degraded", op="fetch",
                             endpoint=list(ep), error=type(e).__name__,
                             detail=str(e)[:200])
                continue
            if state is None:
                # a clean typed miss: the digest aged out on the sibling
                fab.counters["fetch_degraded"] += 1
                self._record("kv.peer.degraded", op="fetch",
                             endpoint=list(ep), error="miss",
                             detail="peer no longer holds pages")
                continue
            p = int(state["len"])
            if p > have:
                store.insert_prefixes(tokens[:p], state["kv"])
                have = max(have, store.coverage(tokens))
                self._record("kv.peer.fetch", endpoint=list(ep), tokens=p)
            if have >= want:
                return  # the longest promise is covered

    def serve_prefix(self, tokens, epoch=None):
        """The serving half of ``kv.fetch``: the longest locally cached
        prefix of ``tokens`` as a DKTX frame, read from the HOST prefix
        store only (one locked read; the device pools belong to the
        scheduler thread). The epoch gate runs first: an epoch this engine
        no longer serves is refused typed ``stale_epoch``. Returns
        ``(blob, reply_header)``; a miss is ``(None, {"ok": True, "hit":
        False})``."""
        fab = self.peer_fabric
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        faults.fire("kv.peer", direction="serve", tokens=int(tokens.size))
        if epoch is not None and int(epoch) != int(self.kv_epoch):
            fab.counters["stale_refusals"] += 1
            self._record("kv.peer.stale", asked=int(epoch),
                         current=int(self.kv_epoch))
            raise StaleEpochError(
                f"kv epoch {int(epoch)} is not current (this engine serves "
                f"epoch {self.kv_epoch}): the digest you routed on predates "
                f"a restart or rollover"
            )
        store = self.prefix_store
        if store is None:
            raise PeerError("this replica serves no prefix cache")
        hit = store.peek(tokens)
        if hit is None:
            fab.counters["fetch_miss"] += 1
            return None, {"ok": True, "hit": False}
        p, kv = hit
        blob = kv_transfer.encode_prefix(tokens[:p], kv, epoch=self.kv_epoch)
        fab.counters["fetch_served"] += 1
        fab.counters["bytes_out"] += len(blob)
        self._record("kv.peer.serve", tokens=int(p), bytes=len(blob))
        return blob, {"ok": True, "hit": True, "len": int(p),
                      "epoch": int(self.kv_epoch)}

    def fabric_snapshot(self) -> dict:
        """The fabric ledger: peer counters, breakers, the retry budget,
        this engine's KV epoch and the prefix digest siblings route on."""
        out = self.peer_fabric.snapshot()
        out["epoch"] = int(self.kv_epoch)
        if self.prefix_store is not None:
            out["digest"] = self.prefix_store.digest()
        return out

    def transfer_snapshot(self) -> dict:
        """The transfer ledger: frames sent/received/errored, bytes both
        ways and the transfers in flight."""
        return {
            "pending": self._transfer_pending,
            "sends": self.transfer_sends.value,
            "recvs": self.transfer_recvs.value,
            "errors": self.transfer_errors.value,
            "bytes_out": self.transfer_bytes_out.value,
            "bytes_in": self.transfer_bytes_in.value,
        }

    # -- predict ------------------------------------------------------------

    def _run_predict_batch(self, x):
        _WARM_SCOPE.ledger = self.compile_ledger
        return self._predictor.predict(Dataset({"features": x}))["prediction"]

    def predict(self, x, timeout=None) -> np.ndarray:
        """Batch scoring: rows accumulate into the current window and run
        as one ``ModelPredictor`` forward."""
        if not self._started:
            raise EngineStoppedError("engine not started")
        return self._predict_batcher.submit(x).result(timeout)

    # -- observability ------------------------------------------------------

    def drain_traces(self) -> int:
        """Flush the trace collector into the ``MetricsLogger`` (one
        ``trace_span`` line per span); no-op without ``metrics_path``."""
        if self.metrics is None:
            return 0
        return self.trace_collector.drain_to(self.metrics)

    def metrics_snapshot(self) -> list:
        """JSON-able samples of every registered metric — the payload of
        the server's ``metrics`` verb."""
        return self.registry.snapshot()

    def timeseries(self, window=None, names=None, points=30) -> dict:
        """The ``timeseries`` verb's payload: windowed digests of every
        series plus the burn-rate verdict when SLOs are configured.
        Raises ``ValueError`` with ``history=False``."""
        if self.history is None:
            raise ValueError(
                "metrics history disabled (ServingEngine(history="
                "False)); the timeseries verb has nothing to serve"
            )
        self.history.maybe_snap()  # a query is its own cadence
        out = self.history.digest(
            window=FAST_WINDOW if window is None else float(window),
            names=names, points=int(points),
        )
        out["ok"] = True
        out["burn"] = self.burn_verdict()
        return out

    def burn_verdict(self) -> dict | None:
        """Multi-window burn-rate verdict over the SLO specs (None
        without both ``slos`` and ``history``)."""
        if self.history is None or self.slo is None:
            return None
        self.history.maybe_snap()
        return self.history.burn(self.slo.specs)

    def _safe_dump(self, reason, detail):
        try:
            self.dump_postmortem(reason, detail=detail)
        except Exception as e:  # noqa: BLE001 — observability boundary
            if self.metrics is not None:
                self.metrics.log(event="postmortem_dump_failed",
                                 reason=reason, error=repr(e))

    def dump_postmortem(self, reason: str, detail=None):
        """Dump this engine's post-mortem bundle (the ``obs`` schema):
        recorder ring, metrics, the in-flight request table with trace
        ids and their spans, the config, armed fault seams, the SLO
        verdict. Kept for the ``postmortem`` verb; written to
        ``postmortem_dir`` when set. Returns ``(bundle, path)``."""
        batcher = self.batcher
        in_flight = [] if batcher is None else batcher.inflight_snapshot()
        trace_spans = []
        for row in in_flight:
            if row["trace_id"] is not None:
                trace_spans.extend(
                    self.trace_collector.spans_for(row["trace_id"])
                )
        cfg = dict(self._batcher_cfg)
        cfg.pop("registry", None)
        cfg.pop("recorder", None)
        gate = cfg.pop("shed_gate", None)
        if gate is not None:
            cfg["shed"] = gate.state()
        cfg.update(
            model=type(self.model).__name__,
            num_slots=(
                None if self._stepper is None else self._stepper.num_slots
            ),
            speculative=(
                self._stepper is not None and self._stepper.speculative
            ),
            device=str(self.device),
            watchdog_interval=self.watchdog_interval,
            watchdog_grace=self.watchdog_grace,
            max_restarts=self.max_restarts,
        )
        bundle, path = dump_postmortem(
            self.postmortem_dir, "serving_engine", reason,
            recorder=self.recorder, metrics=self.metrics_snapshot(),
            in_flight=in_flight, config=cfg,
            trace_spans=trace_spans,
            slo=None if self.slo is None else self.slo.evaluate(),
            detail=detail,
        )
        self.last_postmortem = bundle
        self.last_postmortem_path = path
        if self.metrics is not None:
            self.metrics.log(event="postmortem_dumped", reason=reason,
                             path=path)
        return bundle, path

    def postmortem(self):
        """Latest bundle for the ``postmortem`` verb: the in-memory last
        dump, else the newest file in ``postmortem_dir``;
        ``(bundle_or_None, path_or_None)``."""
        if self.last_postmortem is not None:
            return self.last_postmortem, self.last_postmortem_path
        if self.postmortem_dir is not None:
            return latest_postmortem(self.postmortem_dir)
        return None, None

    def health(self) -> dict:
        """Liveness summary: ``status`` is ``serving`` (scheduler
        heartbeating), ``degraded`` (scheduler dead or restarting, or the
        restart budget exhausted) or ``draining``; plus occupancy, the
        heartbeat age, the quarantined-slot count, the restart ledger,
        the overlap ledger and, with SLOs, their verdict."""
        batcher = self.batcher
        if self._stop_evt.is_set():
            status = "draining"
        elif batcher is None:
            status = "serving"  # predict-only engines have no scheduler
        else:
            th = self._thread
            now = time.monotonic()
            healthy = (
                self._started
                and not self._failed
                and th is not None
                and th.is_alive()
                and (
                    now - self._heartbeat <= self.watchdog_interval
                    # a stale heartbeat inside the mint/launch grace is
                    # the supervisor's definition of fine
                    or now <= self._grace_until
                )
            )
            status = "serving" if healthy else "degraded"
        out = {
            "status": status,
            "device": str(self.device),
            "generate_enabled": batcher is not None,
            # the role rides health: a router learns each replica's role
            # from the poll that gates rotation
            "role": self.role,
            "restarts": self._restarts,
            "max_restarts": self.max_restarts,
            "restart_budget_exhausted": self._failed,
            "watchdog_trips": self._watchdog_trips,
            "quarantined_slots": (
                0 if batcher is None else len(batcher._quarantined)
            ),
            "transfer": self.transfer_snapshot(),
            # the fabric's routing surface: the KV epoch, the prefix digest
            # (gen-memoized) and the peer ledger's summary
            "kv_fabric": {
                "epoch": int(self.kv_epoch),
                "digest": (None if self.prefix_store is None
                           else self.prefix_store.digest()),
                "peer": {k: self.peer_fabric.counters[k] for k in (
                    "fetches", "fetch_ok", "fetch_degraded", "fetch_served",
                    "fetch_miss", "pushes", "push_ok", "push_degraded",
                    "stale_refusals", "bytes_in", "bytes_out")},
            },
        }
        if batcher is not None:
            out.update(batcher.load())
            if self._stepper.speculative:
                # mean tokens emitted per verify window (1.0: drafts never
                # agree; draft_k + 1: the ceiling); None before the first
                w = batcher.counters["spec_windows"]
                out["speculative_tokens_per_window"] = (
                    round(batcher.counters["spec_tokens"] / w, 2)
                    if w else None
                )
            if self._stepper.paged:
                # the paged tier's capacity signal: KV pages in use
                out["kv_page_util"] = round(
                    self._stepper._kv_alloc.utilization(), 4
                )
            # K/V bytes per device, for the router's books and the
            # autoscaler (``mesh`` rides ``batcher.load()``)
            out["kv_shard_bytes"] = self._stepper.kv_shard_bytes()
            if self.history is not None:
                # the autoscaler's windowed signals over the engine's own
                # ring, snapped here so a router poll never reads a stale
                # one: admissions that hit an exhausted page pool in the
                # last minute, and the queue's depth growth (req/s)
                self.history.maybe_snap()
                out["pool_exhausted_rate"] = self.history.rate(
                    "serving_scheduler_pool_exhausted", window=60.0
                )
                out["queue_depth_trend"] = self.history.trend(
                    "serving_scheduler_queue_depth", window=60.0
                )
            out["overlap"] = {
                "enabled": batcher.overlap,
                **batcher.overlap_ledger.snapshot(),
            }
        if self.shed_gate is not None:
            # the brownout rung, whether the CoDel side sheds, and the
            # sojourn EWMA behind the retry hints
            out["shed"] = self.shed_gate.state()
        out["heartbeat_age"] = (
            None if batcher is None or not self._started
            else time.monotonic() - self._heartbeat
        )
        if self.slo is not None:
            verdict = self.slo.maybe_evaluate()
            out["slo"] = verdict["slo"]
            out["slo_violations"] = verdict["violations"]
            if self.history is not None:
                b = self.burn_verdict()
                out["burn"] = b["burn"]
                out["burn_violations"] = b["violations"]
        if self._last_crash is not None:
            out["last_crash"] = self._last_crash
        return out

    def stats(self) -> dict:
        out = {
            "model": type(self.model).__name__,
            "num_params": int(self.model.num_params()),
            "generate_enabled": self.batcher is not None,
        }
        if self.batcher is not None:
            out.update(self.batcher.stats())
            out["prefix_fetch_failures"] = (
                self._stepper.prefix_fetch_failures
            )
            out["paged"] = self._stepper.paged_stats()
        out["restarts"] = self._restarts
        out["watchdog_trips"] = self._watchdog_trips
        out["status"] = self.health()["status"]
        out["role"] = self.role
        out["transfer"] = self.transfer_snapshot()
        out["kv_fabric"] = self.fabric_snapshot()
        # every runtime mint with its trigger, seconds and the storm count
        out["compiles"] = self.compile_ledger.snapshot()
        out["prefix_cache"] = (
            self.prefix_store.stats()
            if self.prefix_store is not None
            else {"enabled": False}
        )
        return out
