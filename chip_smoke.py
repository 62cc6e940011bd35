#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

Run from the repository root: ``python3 chip_smoke.py`` (optionally
``--out FILE`` to also write the results as JSON). It needs one CUDA card,
the CUDA toolkit (``nvcc``) and this checkout; it imports nothing of JAX.

Phases, each fatal on failure (exit code 1, no result line):

1. Device: CUDA required (exit 2 without it); prints the card's name and
   power limit; builds every kernel of the serving path from
   ``distkeras_tpu_torch/kernels/csrc`` with nvcc (one process per source,
   all started together).
2. Kernels vs their plain PyTorch versions on the card, at the shapes the
   serving path gives them: ``layernorm_fwd`` (tolerance 1e-5 absolute in
   f32; 1e-2 absolute + 1e-2 relative in bf16/f16, one rounding step; on
   each of its paths — 16-byte chunks at D = 512 and 96, one-element
   chunks at D = 510 and for a view with a storage offset, the block
   kernel above D = 1024 — a second launch bit-equal) and
   ``flash_fwd`` (f32: O to 2e-5, lse to 1e-5 absolute, at D = 64 and a
   D = 128 row; bf16 at (8, 512, 8, 64) causal: O within 2^-7 * (sum
   p|v| + |ref|) elementwise, the rounding of P and of the output, lse to
   1e-5; a second launch bit-equal), with the device time (CUDA-graph
   replay) and the eager per-call time (CUDA events) of the kernel, the
   plain version and — for context only, never on the port's path — the
   PyTorch library call computing the same function.
2b. The training kernels vs their plain versions on the card, at the
   shapes the training step gives them: ``adam_fused`` over the 110
   leaves of the d512/L8 model, and over ``resnet18``'s 62 and
   ``mnist_cnn``'s 12 (phase 7's tables), and over the member-stacked
   tables phase 9 launches once per joint step — 4 x ``mnist_cnn``'s 12
   and 2 x d512/L8's 110 (|dp|, |dm|, |dv| <= 1e-6 absolute),
   ``flash_bwd_dq``/``flash_bwd_dkv`` (dQ, dK, dV within 1e-4 * max(1,
   max|ref|) in f32 at (8, 512, 8, 64) causal and not and (2, 200, 8, 64);
   in bf16 at (8, 512, 8, 64) causal within 2^-7 * (sum |x||y| + |ref|)
   elementwise, the rounding of P/dS and of the output; a second launch
   bit-equal) and ``layernorm_bwd`` (dx to 1e-5 absolute in f32, one bf16
   step in bf16; dgamma/dbeta to 1e-4 of their largest magnitude and
   bit-equal between two launches; D = 512 on the 16-byte vector path,
   (37, 510) and (3, 96) on the element path), timed as in phase 2.
   Then the f32 flash kernels on query rows with an infinite element
   (every score -inf): the forward gives them O = 0 and lse = -inf as
   JAX's kernel does, and the backward dQ = 0 there, dQ and dV finite and
   within 1e-4 * max(1, max|ref|), dK NaN exactly where the plain
   version's is (0 * inf).
2c. The fused SGD kernels vs their plain versions on the card over the
   same 110 leaves: ``sgd_fused`` (B1) in f32 and bf16, and
   ``sgd_momentum_fused`` (B2) in f32 with momentum 0.9 plain and Nesterov
   and in bf16 with Nesterov, two steps each, and ``sgd_fused`` in f32
   over ``cifar10_cnn``'s 16 and ``higgs_mlp``'s 6 leaves (phase 7's
   tables) and over 4 x ``higgs_mlp``'s 6 (phase 9's replicas): bit-equal
   (the same operation order, every step rounded), timed as in phase 2,
   each row with its share of the bound. B2 Nesterov in f16,
   and in bf16 on leaves that are views at a 1-element offset (p, g and m
   off the 16-byte grid), are held bit-equal untimed. Then, measurement
   only, ``adam_fused`` (B3) with bf16 parameters at the 110 leaves, beside
   ``torch.optim.Adam(fused=True)`` (whose moments are bf16 there).
   ``--phase2c-only`` builds the kernels and runs phases 2b and 2c alone.
3. Predict: a ``ServingEngine`` on ``transformer_lm(8192, 512, 512, 8, 8)``
   (random weights from a seed) with the flash and LayerNorm hooks answers
   ``predict`` on 8 full 512-token sequences; the logits must agree with
   the same model's plain path to 1e-4, exactly 8 flash and 17 LayerNorm
   launches must have served it, and ``generate`` must be refused (a model
   with an attention hook is predict-only, as in the JAX package).
4. Generate: an engine with the LayerNorm hook serves 16 concurrent
   requests (prompts of 16-256 tokens through chunked prefill, 32-64 new
   tokens, 12 greedy and 4 sampled); all must finish, sampled requests must
   replay identically, every greedy token must be the argmax of the
   teacher-forced logits (or tie with it within 1e-4), and those logits
   must agree between the kernel and the plain path to 1e-4. Token
   agreement with solo ``CachedSequenceGenerator`` decode and tokens/s are
   printed.
5. Train: ``SingleTrainer`` with ``pallas_adam`` on the d512/L8 model with
   the flash and LayerNorm hooks, one shuffled epoch of the in-repo corpus
   (``loaders.text_corpus(seq_len=512)``: 136 windows, 17 steps of batch 8,
   device-resident), then the same model from the same seed with no hooks
   and ``adam`` (the plain path on the card). Every loss must be finite,
   the last below the first, every step's loss within 1e-3 (relative) of
   the plain path's, the caller's model unchanged, and the kernels launched
   exactly 17 x (17 LN forward, 17 LN backward, 8 flash forward, 8 dQ, 8
   dK/dV, 1 Adam). Samples/s and tokens/s are printed.
6a. Async, simulated mode: DOWNPOUR and ADAG with ``pallas_sgd`` (B1),
   DynSGD and AEASGD with ``FusedSGD`` at momentum 0.9 (B2; AEASGD with
   Nesterov) and EAMSGD with its own ``sgd``-Nesterov, each on a fresh
   d512/L8 model with the flash and LN hooks, 2 workers, window 4, batch
   8, one shuffled device-resident epoch of the corpus (16 steps, 4
   commits), then the same trainer with no hooks and ``sgd`` at the same
   momentum (the plain path). Every step's loss within 1e-3 (relative) of
   the plain path's, the final centers within 1e-4, 4 updates on both
   paths (DynSGD's version equal to them), no worker failure, the kernels
   launched exactly 16 x (17 LN forward, 17 LN backward, 8 flash forward,
   8 dQ, 8 dK/dV) plus 16 of the SGD kernel, none on the plain path, and
   DOWNPOUR's loss falling.
6b. Async, threads mode: DOWNPOUR + ``pallas_sgd`` with 2 worker threads
   on the card: both commit, 4 updates, no failure, exact launches for 20
   steps (the warm-up window included), one B1 table per worker. Prints
   tokens/s (over ``train()``, and over the worker threads after the
   warm-up window), the per-window host split (pull, window, commit) and
   the device's idle share (a second run under the profiler).

7. The BASELINE configs: ``benchmarks.py``'s configs 2-5 at their smoke
   rows and full width — DOWNPOUR/``mnist_cnn`` (8 workers, adam 2.5e-4,
   bf16), AEASGD/``higgs_mlp`` (4 workers, sgd 0.02, rho 10, f32),
   ADAG/``cifar10_cnn`` (4 workers, sgd 0.05, bf16, BatchNorm momentum
   0.9), DynSGD/``resnet18`` at (64, 64, 3) with 10 classes (4 workers,
   adam 1e-3, bf16) — each over one shuffled epoch of its synthetic data
   (the port's loaders, ``split(0.9, seed=7)``), window 4, simulated
   mode, seed 0, cuDNN deterministic. The kernel path (``pallas_adam``:
   B3, ``pallas_sgd``: B1) against the plain path from the same seed
   (B3's plain version ``adam_step_plain``; ``sgd``): per-step losses
   within 1e-3 relative, centers and the aggregated BatchNorm buffers
   within 1e-4, equal update counts, no worker failure, exactly one B3
   or B1 launch per step on the kernel path and none on the plain path.
   The Adam configs also run ``"adam"`` (optax's operation order) and
   print its distance. Prints samples/s, the window split and the
   held-out accuracy (``AccuracyEvaluator``) per config.

8. Checkpoint and resume. 8a: phase 5's trainer over two epochs, run
   twice uninterrupted (is the card path deterministic?), then one epoch
   with ``checkpoint_dir`` and, in a new trainer with ``metrics_path``
   and ``profile_dir``, resumed to epoch 2. The resumed parameters must
   equal the uninterrupted runs' bit for bit when those two are
   bit-identical (else stay within their own distance, and the ops
   PyTorch flags as nondeterministic are named); the resumed epoch must
   launch exactly 17 x (17, 17, 8, 8, 8, 1) of (LN forward, LN backward,
   flash forward, dQ, dK/dV, Adam); the JSONL must hold its
   ``train_end`` row and the profiler trace must name those six
   kernels. Prints the checkpoint's bytes and the save and restore
   seconds. 8b: configs 3 (AEASGD/``higgs_mlp``, ``pallas_sgd``) and 5
   (DynSGD/``resnet18``, ``pallas_adam``) as in phase 7, one epoch with
   ``checkpoint_dir``, then resumed to two epochs on the kernel path and,
   from a copy of the checkpoint, on the plain path: the center, the
   replicas and the BatchNorm buffers round-trip the checkpoint bit for
   bit, exactly twice the first epoch's commits with no duplicate, every
   worker restored with a commit seq > 0, DynSGD's version restored, one
   B1/B3 launch per step on the kernel path and none on the plain path,
   kernel and plain resumes within phase 7's bars.

9. The streaming and native data layer, the member trainers and commit
   compression (cuDNN deterministic). 9a: config 5's smoke training rows
   written to 4 uint8 shards with ``ShardWriter`` and preprocessed per
   shard with ``.map``; DynSGD/``resnet18`` with ``pallas_adam`` from
   ``open_shards`` (one shard per worker) against B3's plain version,
   phase 7's bars, its samples/s printed beside phase 7's in-memory run;
   the same shards through ``SingleTrainer`` with prefetch 2 and 0
   (bit-identical); config 6: the native library built and loaded, its
   parse of ``digits.csv`` equal to the csv module's bit for bit, and
   ``digits_mlp`` one epoch with ``pallas_adam`` against the plain path.
   9b: ``EnsembleTrainer`` (4 ``mnist_cnn`` members, config 2's data,
   adam 2.5e-4, batch 32, window 4, bf16) and ``AveragingTrainer`` (4
   ``higgs_mlp`` replicas, config 3's data, sgd 0.02, batch 64, window 4,
   2 epochs), each threaded and vmapped, each on the kernel and the plain
   path: per-member losses within 1e-3 relative and weights within 1e-4
   between the paths and between vmapped and threaded; exactly one B3/B1
   launch per joint step vmapped, one per member and step threaded. 9c:
   ``EnsembleTrainer(vmapped=True)`` with 2 d512/L8 members carrying the
   flash and LayerNorm hooks, ``pallas_adam``, batch 8, one window of 4:
   per-step losses within 1e-3 relative of the plain path (no hooks, B3's
   plain version), exactly 2 x 4 x (17, 17, 8, 8, 8) of B7/B8/B4/B5/B6
   and 4 of B3. 9d: config 2 with ``compress="int8"`` and
   ``pull_compress="bfloat16"``, config 3 with ``compress="topk:0.05"``,
   kernel against plain path under phase 7's bars, commit bytes per window
   printed against the uncompressed run (at least 3x / 4x fewer); a
   config-2 checkpoint after epoch 1 carries every worker's residual bit
   for bit and the kernel and plain resumes keep phase 8b's contract;
   with one worker (whose simulated schedule a resume keeps) the resumed
   compressed run is bit-identical to an uninterrupted one.

10. The socket parameter-server tier (cuDNN deterministic). 10a: config 2
   as in phase 7's kernel path with ``remote_ps=True`` (every pull and
   commit over a loopback socket): the center bit for bit phase 7's, 16
   commits, 56 B3 launches; samples/s beside phase 7's and the wire bytes
   per pull and per commit. 10b: a second OS process (CUDA hidden) hosts a
   ``SocketParameterServer`` over config 2's initial center; one DOWNPOUR
   worker runs its windows on the card against it through
   ``RemoteParameterServerClient``; the center read back over the wire
   bit for bit the one-worker in-process run's. 10c: phase 6a's hooked
   d512/L8 DOWNPOUR (B1) and DynSGD (B2) with ``remote_ps=True``: centers
   and losses bit for bit phase 6a's, launches exactly 16 x (17, 17, 8, 8,
   8) of B7/B8/B4/B5/B6 plus 16 of B1/B2; then DOWNPOUR with int8 commits
   and bf16 pulls over the socket, per-step losses within 1e-3 relative
   of phase 6a's plain path; wire bytes and the window split beside the
   in-process runs'. 10d: config 3 in threads with ``remote_ps``, a warm
   standby and ``worker_retries=2``, unfaulted and with the primary killed
   at half the expected commits: exactly one promotion
   (``primary-lost``), at least one client failover, a promotion
   post-mortem and the unfaulted run's commit ledger; the kill-to-promotion
   seconds and the B1 launches (60 unfaulted: 56 steps and the 4-step
   warm-up window).

11. The serving TCP front on the d512/L8 LM, over loopback. 11a: an
   LN-hooked 8-slot engine behind a ``ServingServer`` takes phase 4's
   16-request mix from 8 client threads (one ``ServingClient`` each):
   every reply equal to phase 4's in-process output, greedy and sampled,
   B7 launched and B4 not; tokens/s over the wire beside phase 4's. 11b:
   four of the mix through ``generate_stream``: the chunks concatenate to
   the unstreamed sequence; TTFT and inter-chunk p50/p99 on the host
   clock. 11e: a traced generate's timeline complete with queue, prefill
   and decode spans; ``metrics`` (JSON and Prometheus), ``timeseries``,
   ``health`` and ``stats`` answer; ``stop`` drains a request still in
   flight. 11c: a flash+LN-hooked engine scores phase 3's (8, 512) batch
   in process and over the wire: the (8, 512, 8192) f32 replies bit-equal,
   exactly 17 B7 and 8 B4 launches for the wire forward; the wall time
   beside phase 3's and the host split (reply encode, loopback, decode).
   11d: ``quantize_model`` -> ``save_serving_bundle`` ->
   ``ServingEngine.from_bundle`` on the card; four greedy wire generates
   equal to an in-process ``CachedSequenceGenerator`` on the quantized
   model; the bundle bytes beside ``serialize_model``'s f32 bytes.
12. The self-healing scheduler on phase 4's LN-hooked 8-slot engine and
   16-request mix. 12a: the mix under ``overlap=False``, then
   ``overlap=True``: every reply equal to phase 4's; per mode tokens/s,
   ``serving_overlap_efficiency``, the bubble's p50/p99 from
   ``serving_step_bubble_seconds`` and B7 launches per emitted token; B4
   not launched. 12b: 15 of the mix and a poison request whose slot makes
   ``stepper.step`` raise, in both modes: the poison fails typed, the 15
   equal phase 4's; quarantines, blame probes and the wall of the failed
   step and its probes; then a ``stepper.prefill`` seam fails one
   admission alone. 12c: one engine behind a ``ServingServer`` with a 1 s
   watchdog: a ``scheduler.loop`` crash mid-decode, a 5 s wedge, another
   crash: each request fails typed, the engine restarts (trip-to-serving
   time, the rebuilt stepper's warmup time), four greedy requests equal
   phase 4's, the zombie exits; ``memory_allocated`` after the three
   restarts within one 134 MB cache bank of the start; then a crash with
   the budget spent: ``degraded`` in the wire ``health``, ``submit``
   refused typed. 12d: the compile ledger after 12a (warmup and serving
   mints, keys, seconds), then ``warm_prefill_buckets`` and
   ``mark_warmed`` and the mix again: 0 storms.
13. Paged KV pools and the prefix cache on phase 4's LN-hooked LM, each
   engine fresh. 13a: phase 4's mix on ``paged=True``: every greedy token
   the argmax of its teacher-forced plain logits within LOGIT_TOL, the
   sampled requests replaying identically, no pool exhaustion, B7 launched
   and B4 not, the pages left in use after the mix exactly the device
   index's; tokens/s beside phase 4's and the token agreement with phase
   4's replies and with solo decode. 13b: shared-header traffic (one
   192-token system prompt, 16 distinct 16-64-token suffixes, 32 new
   tokens, 4 sampled; one request first, the other 15 once its first
   chunk arrives) on a dense engine without a store, a dense one with the
   default store and a paged one, in turns: 13a's token bars, and paged at
   least 15 device-index hits of 12 shared pages; per mode the prefill
   positions computed, store and index books, the peak of shared pages,
   TTFT p50/p99 and tokens/s. 13c: phase 4's mix on a 61-page pool: all 16
   complete, no exhaustion (gating waits), at most 60 pages in use; a
   request that never fits a 16-page pool refused ``ValueError`` at
   ``submit``; behind a ``ServingServer``, an injected ``kv.alloc``
   exhaustion comes back ``overloaded`` with ``retry_after_ms``, a
   retrying client gets its reply, the requests beside it are unaffected.
   13d: a scheduler crash on 13b's paged engine: a fresh paged stepper
   (empty device index), the host store's entries kept, the old pool freed
   (``memory_allocated`` grows by less than one 134.7 MB pool), a header
   request after it a host-ladder hit. 13e: the warm-up's six
   ``paged_step`` mints, then the warm set, ``mark_warmed`` and 13b's
   paged traffic again: 0 storms.
14. Speculative decode on phase 4's LN-hooked LM, ``draft_k=4`` (verify
   windows of 5 candidates), each engine fresh; on every drive B7 launches
   exactly what its stepper programs imply (17 per target verify or step,
   16 per target prefill chunk, 2L+1 per step and 2L per prefill of an
   L-block hooked draft) and B4 none. 14a: the n-gram drafter on phase 4's
   mix: 13a's token bars; token agreement with phase 4's replies, the
   drafted, accepted and rejected tokens, verify and fallback steps, mean
   tokens per window, tokens/s beside phase 4's. 14b: templated traffic
   (16 prompts, each a 32-token span from ``default_rng(14)`` repeated 4-6
   times and a distinct 8-token tail, 64 new tokens, 4 sampled) on a plain
   and an n-gram engine in turns: the same bars and books. 14c: a
   self-draft (a second hooked copy of the target) on the mix's 12 greedy
   requests: every window accepts all 4 proposals (as many windows as a
   full acceptance takes, no fallback) and the replies equal phase 4's;
   the small draft ``transformer_lm(8192, 512, 256, 4, 2, seed=1)``,
   hooked, on the whole mix: 14a's bars. 14d: 14b's mix with n-gram on a
   paged engine: the token bars, 0 exhaustions, ``pages_for`` reserving
   the 5-position verify window, the pages in use after the mix exactly
   the device index's, the warm-up minting the paged verify. 14e: a
   ``stepper.verify`` seam on one request's windows fails it alone
   (typed), 15 of 14b's mix equal 14b's n-gram replies; a scheduler crash
   on a small-draft engine: a rebuilt speculative stepper, the drafter
   re-bound, a request after it right; the warm-ups minted ``verify[5]``;
   0 storms after the warm set and ``mark_warmed``. 14f:
   ``SpeculativeGenerator`` with the self-draft and the small draft on 4
   prompts equals ``CachedSequenceGenerator``'s greedy decode; rounds per
   row.
15. QoS, KV swap, copy-on-write forks and beam search on phase 4's
   LN-hooked LM, each engine fresh, every drive launching B7 exactly what
   its program calls imply and B4 never. 15a: 8 priority-0 requests
   (prompts 128-256 tokens from ``default_rng(15)``, 192 new, 2 sampled)
   fill a paged bank; once all 8 decode, 4 priority-2 requests (prompts
   32-64, 32 new) arrive; with ``QosPolicy(preempt=True)`` and without a
   policy, in turns (policy, plain, plain, policy): every priority-2
   request finishes before any priority-0 one, at least 4 preemptions,
   all resumed, none aborted, 0 storms after the warm set and
   ``mark_warmed``; every reply equal across the four turns and 13a's
   token bars; swap-out and swap-in host wall and bytes a swap, the
   priority-2 TTFT p50 with and without the policy, tokens/s beside 13a's.
   15b: tenants ``gold`` (weight 3) and ``bronze`` (weight 1) each submit
   16 requests (prompts 32-64, 64 new) at once: gold's share of the tokens
   emitted while both had a request waiting for admission at least 0.6
   (and without a policy, for comparison). 15c: 4 requests of n = 4
   (temperature 0.8, seeds 150-153, prompts 64-200, 48 new) on a paged
   engine: completion j equal to an independent admission under
   ``seed_for_completion(seed, j)``, 12 forked slots, CoW copies equal to
   the forks with a partial frontier page, each group's peak pages below n
   x ``pages_for``; the shared and fresh pages a fork, a ``page_cow``'s
   device time. 15d: a paged n-gram engine (``draft_k=4``) with the policy:
   an n = 2 group and six of 15a's requests fill the bank, a priority-2
   request preempts a speculative slot: replies equal 15a's and 15c's.
   15e: a ``kv.swap`` seam on ``out`` aborts one preemption (replies
   unchanged), one on ``in`` fails the preempted request alone, typed
   ``internal``; ``stop()`` with a request swapped out fails it typed and
   the books pair; behind a ``ServingServer`` an n = 3 generate equals
   15c's completions, and tenant and priority reach the in-flight
   snapshot. 15f: ``BeamSearchGenerator`` on 4 prompts of 64 tokens, 32
   steps: width 1 equals greedy cached decode, width 4 the unhooked plain
   path's sequences with scores within 1e-4 relative, B7 17 a step plus 16
   for the prefill; tokens/s at widths 1 and 4.
16. bf16 K/V caches, grammar masks and load shedding on phase 4's
   LN-hooked LM, 8 slots, each engine fresh, every drive launching B7
   exactly what its program calls imply and B4 never. 16a: phase 4's mix
   on dense (whole-prompt admission) and paged engines with f32 and
   ``kv_dtype=torch.bfloat16`` caches in turns (f32, bf16, bf16, f32):
   bf16 greedy tokens agree with f32's on at least 0.9 of the positions,
   each is the argmax of the bf16 cached path's own teacher-forced logits
   within 1e-4, sampled replays equal, ``kv_bytes_total`` exactly half;
   on dense and paged steppers a 200-token prompt's prefix-store entry
   (uint16 rows, half the f32 bytes) restores bit for bit and a swap-out /
   swap-in round-trips bit for bit, the restored and resumed slots
   decoding the tokens of the slots they copy; tokens/s beside f32's.
   16b: a 16-request mix, 8 constrained (``allow``, ``sequence`` with and
   without ``loop``, ``choice``, ``fsm``; greedy and sampled; eos 8191) on
   dense, paged (with a constrained sampled ``n = 3`` request) and n-gram
   speculative engines warmed with ``warm_constrained_buckets`` before
   ``mark_warmed``: every constrained token inside its grammar (a host walk
   written apart from ``TokenMaskCompiler``), the unconstrained replies
   equal to their replies served alone, sampled constrained replays equal,
   the three engines' replies equal, 0 storms, masked programs minted in
   the warm-up only; a constrained slot swapped out and back in equals its
   twin, a dead-end grammar forces eos and records
   ``sampling.mask_exhausted``, and a constrained request over a
   ``ServingServer`` equals the in-process reply. 16c: ``shed={"target_ms":
   50, "interval_ms": 500}`` under a burst of 48 priority-0 requests (64
   new) and a trickle of priority-0 arrivals: the gate latches (rung >= 1),
   sheds are typed ``overloaded`` with ``retry_after_ms`` in [25, 5000], 8
   priority-1 requests equal a gate-less engine's replies, no other request
   fails, the rung returns to 0 after the burst (``health()["shed"]`` and
   ``serving_shed_rung`` agree), a declared rung-2 brownout clamps a reply
   to an exact prefix, and a shed over the wire carries the gate's own
   ``retry_after_ms``.
17. Disaggregated prefill/decode and the KV fabric on phase 4's LN-hooked
   LM, 8 slots, each engine fresh behind its own ``ServingServer`` on
   loopback, every drive launching B7 exactly what its program calls
   imply (16 a prefill chunk, 17 a decode step) and B4 never. 17a: phase
   4's mix through a ``role="prefill"`` and a ``role="decode"`` engine,
   relayed (``prefill``, then ``kv.transfer`` from the caller) and pushed
   (``prefill`` with ``push_to``), from 8 client threads, dense (whole-
   prompt admission) and paged, f32 and bf16 caches: every reply equal to
   a unified engine's of the same layout and ``kv_dtype`` over the wire,
   the prefill engine never stepping and the decode engine never
   prefilling, each frame its rows' bytes plus a header; frame bytes,
   encode, wire, decode, export and resume ms a request, TTFT on the
   prefill and the decode side, tokens/s of the pair beside the unified
   engine's. 17b: engine A serves 13b's shared-header traffic (no fetch);
   fresh engines B serve it with ``kv_peers`` naming A: one fetch of the
   128-token rung, fewer prefill positions, A's replies; after A's
   scheduler restarts (a new KV epoch) a fetch at the old epoch is refused
   typed ``stale_epoch`` on the wire, and a stale hint, a dead endpoint
   and an open breaker (no retry budget spent, A never dialed) each
   degrade with A's replies. 17c: a frame with one byte flipped is a typed
   ``kv_transfer`` (nothing admitted) in process and over the wire,
   ``wrong_role`` holds both ways over the wire, the ``kv.transfer`` seam
   fails a send and a receive typed, and a hand-off after them equals the
   unified engine's reply.
18. The serving fleet and its autoscaler on phase 4's LN-hooked LM, 8
   slots a replica, every replica behind its own ``ServingServer`` and all
   behind one ``FleetRouter`` on loopback (0.1 s health sweep, 2 s dial),
   every drive launching B7 exactly what the program calls of every
   replica imply and B4 never. 18a: a 2-replica ``FleetController``
   (replicas sharing the LM's weights) serves phase 4's mix from 8 client
   threads, every reply equal to phase 4's, on both replicas; tokens/s
   beside phase 11's single engine over the wire; 13b's shared-header
   traffic (two requests in turn, then 14 from 8 threads) all served by
   one replica, the prefill positions its store saved. 18c: under 4
   client threads looping over the mix, ``rollover`` to an f32 copy of
   the weights read from a ``serialize_model`` file: 0 failed requests,
   every reply equal to phase 4's, device memory after minus before the
   new replicas' weights (less than one 134 MB bank: the old banks left
   the card), the mix after equal. 18b: the mix again (four of it
   streamed); after the third reply the replica that served request 0 is
   killed (``shutdown(drain=False)``): every request equal to phase 4's
   or typed (streams that had emitted chunks typed), the ejection in the
   router's books, no client hung; with both replicas dead a request
   fails typed ``unavailable`` within the 2 s dial budget. 18d: an ``Autoscaler``
   (``min_replicas=1``, ``max_replicas=3``, ticked by hand) over one
   replica with 16 queue places: a 16-request burst's tick scales up, the
   new replica warmed and ``mark_warmed`` before it joins and with 0
   storms after serving a second burst; two idle ticks scale down under a
   request stream that loses nothing; a killed replica is reaped and
   replaced in one tick; a ``BundlePublisher`` on a
   ``DeltaParameterServer`` holding the LM's center publishes an int8
   bundle after 2 commits and a ``ContinuousDeployer`` rolls the fleet to
   it on a hold tick: 4 replies equal a solo engine's on that bundle.
   18e: one ``role="prefill"`` and two ``role="decode"`` replicas (dense,
   whole-prompt admission): the mix pushed and four of it stream-relayed
   equal a unified engine's, the push and relay ledgers pair (16 pushed,
   4 relayed); a decode replica is killed hard (listener closed, engine
   stopped, open connections reset) while a streamed request's transfer
   is held in it: the router resends the frame to the sibling (a
   ``transfer_retries``), the tokens identical, and a pushed generate
   after the kill too.
   After phase 18 the card holds less than one bank more than before it.
19. The mixture-of-experts family and blockwise attention.
   ``moe_transformer_lm(8192, 512, 512, 8, 8, num_experts=8)`` (phase 4's
   LM with an 8-expert switch MoE after every block: 168,117,248
   parameters in 134 leaves) from seed 0. 19a: an LN-hooked engine serves
   phase 4's mix, dense then paged; every greedy reply equals the same
   model's solo ``CachedSequenceGenerator`` decode (no-drop routing on
   both), the sampled ones replay, B7 exactly what the program calls
   imply (17 a step, 16 a prefill chunk) and B4 never; tokens/s beside
   phase 4's dense LM. A predict-only engine with both hooks answers 8 x
   512 through exactly 17 B7 and 8 B4 launches (the capacity-dropped
   forward); its logits equal the plain path's to 1e-4 at every position
   routed alike on both paths (at least 99% of them). 19b: an n-gram
   engine (``draft_k=4``) on phase 4's mix and a plain engine on 14b's
   templated 16-request mix through 32-position prefill chunks, with 19a's
   bars. 19c: ``SingleTrainer`` with the flash and LN hooks and
   ``pallas_adam``, ``aux_loss_weight=0.01``, 4 steps of 8 x 512
   successor tokens from ``default_rng(19)``, then the plain path with
   ``adam``: per-step losses within 1e-3 relative, exactly 4 x (17, 17,
   8, 8, 8, 1) launches, none on the plain path, every saved
   ``aux_loss`` detached. 19d: ``blockwise_attention`` (512-key blocks)
   against ``dense_attention`` at (1, 8192, 8, 64) f32, causal and not:
   within 3e-5 and a lower ``max_memory_allocated`` peak, both times and
   peaks printed; ``attach_blockwise_attention(block_size=128)`` on phase
   4's LM's 8 x 512 forward within 1e-4 of the unhooked one.
20. Synchronous data parallelism on phase 5's trainer configuration
   (``pallas_adam``, both hooks, device-resident, seed 0), 4 steps of a
   global batch of 8 x 512 from the corpus, in two windows. 20a: one
   NCCL rank (a ``TCPStore`` on a free localhost port),
   ``SynchronousDistributedTrainer`` replicated and with
   ``shard_opt_state=True``: losses and parameters bit for bit
   ``SingleTrainer``'s, exactly 4 x (17, 17, 8, 8, 8, 1) launches each;
   the step and the collective's share of it printed. 20b: two rank
   processes on the one card over gloo (NCCL refuses two ranks on one
   device; gloo stages CUDA tensors through the host), started with the
   ``DKT_*`` env (``--sync-rank-out DIR`` is the rank mode), 4 rows a
   rank, replicated and ZeRO-1: the ranks bit-equal, losses within 1e-5
   relative and parameters within 1e-4 of 20a, the same launches on each
   rank; the host-staged all-reduce and all-gather times printed. 20c:
   config 4's ``cifar10_cnn(bn_momentum=0.9)`` with ``pallas_sgd`` in
   f32, the two ranks at 16 rows against one at 32: moving statistics
   within rtol 1e-4 / atol 1e-5 and weights within 1e-4 (the CPU test's
   bars), B1 once a step on each rank.
21. Tensor and sequence parallelism: two gloo rank processes on the card
   (``--tpsp-rank-out DIR`` is the rank mode), against the port's one-rank
   ``SingleTrainer`` on the same batches. The gloo exchange path the
   backend chooses (``parallel.mesh.HOST_STAGED``) is printed. 21a:
   ``SynchronousDistributedTrainer(model_parallel=2)`` on phase 5's
   configuration, each rank holding its shards (bytes printed): losses
   within 1e-3 relative, gathered parameters within 1e-4 (20b's bar),
   exactly 4 x (17, 17, 8, 8, 8, 1) launches on each rank. 21b and 21c:
   ``SequenceParallelTrainer`` ring and Ulysses (blockwise inner) at seq
   2, T = 512, the same bars against ``SingleTrainer`` on dense attention
   (the exchanges replace the flash hook), 4 x (17, 17, 1) launches on
   each rank; the exchanges' bytes and times a step printed. 21d: tensor parallelism on config 4's CNN, model 2,
   ``pallas_sgd``, against one rank within 20c's bars. ``--phase21-only``
   builds the kernels and runs phase 21 alone.
22. The expert mesh and pipeline parallelism: two gloo rank processes on
   the card (``--p22-rank-out DIR`` is the rank mode), 4 steps of phase
   5's global 8 x 512 batches with ``pallas_adam`` and both hooks, against
   the port's one-rank ``SingleTrainer``. 22a:
   ``SynchronousDistributedTrainer(expert_parallel=2)`` on phase 19's MoE
   LM, each rank holding half of the expert bytes (printed); 22b: the
   same MoE LM under pure data parallelism at 4 rows a rank, routing the
   global batch. Both: the first step's routing (every token's expert, or
   dropped) equal to one rank's in every MoE layer, losses within 1e-4
   relative, parameters within 1e-4, exactly 4 x (17, 17, 8, 8, 8, 1)
   launches on each rank. 22c: ``PipelineParallelTrainer`` at S = 2 with
   4 microbatches on phase 5's LM (4 blocks a rank), the same bars, and
   exactly 4 x the lockstep schedule's launches on each rank (every stage
   runs its 4 blocks at each of the 5 ticks, forward and backward: 20
   flash forward, dQ and dK/dV, 41 LayerNorm forward and backward, 1
   Adam); the exchanges' bytes and times a step, timed alone, and their
   share of the step printed. ``--phase22-only`` builds the kernels and
   runs phase 22 alone.
23. The serving mesh: ``ServingEngine(mesh="tp:N")`` with its N shards on
   the one card (``serving_mesh(..., devices=[cuda:0] * N)``), held
   against the solo engine. 23a: tp:2 on phase 4's mix with phase 4's LM,
   dense and paged: replies equal solo's (a greedy reply may leave solo's
   only at a tie, solo's top two cached-path logits within 1e-5 relative;
   the ties are counted), sampled replays identical, B7 exactly what the
   programs imply (17 a decode step, 16 a prefill chunk: the LayerNorms
   run once on the home device, not once a shard), ``mesh`` on health,
   stats and the gauges, ``kv_shard_bytes * 2 == kv_bytes_total``. Then a
   dense step with 8 busy slots at tp:1, tp:2 and tp:4: wall (median of
   three turns) and B7 a step (17 at each N); its device time and kernels
   under ``--profile``.
   23c: speculative verify at tp:2 with a ``ModelDrafter`` of 14c's small
   draft, six greedy requests, verify steps on solo and tp:2, replies
   equal. 23d: a DKTX frame from a solo ``role="prefill"`` engine decoded
   by a tp:2 ``role="decode"`` engine, equal to a solo unified engine's
   reply. 23b: tp:4 on phase 19's MoE LM (2 experts a shard), paged, four
   greedy requests and an n=2 fork, 23a's bars. ``--phase23-only`` builds
   the kernels and runs phase 23 alone.
24. The 3-D composition and the example twins. 24a:
   ``pipeline_apply(param_specs=)`` over a 2 x 2 x 2 ``Grid3D`` of eight
   gloo rank processes on the one card (``--p24-rank-out DIR`` is the rank
   mode), ``tests/test_3d_mesh.py``'s blocks and specs, against
   ``pipeline_apply`` on one rank: outputs within 1e-5, the data-summed
   gradients within 2e-4, the rank layout row-major and each rank holding
   JAX's shard shapes. 24b: every ``examples/*_torch.py`` twin of a JAX
   example as a subprocess on CUDA at a small size (``P24_LANES`` at a
   time; the sync modes and the LM's ``--seq-parallel 2`` at two gloo
   ranks sharing the card), its result lines asserted (``real_digits``
   above 0.9, the LM's decode counting upward and its speculative decode
   EXACT), its wall split into start-up, the twin and the training it
   prints, and the kernel launches of its process and its rank processes
   counted into the kernels line (the LM twin must launch B3-B8, its rank
   processes B3, B7 and B8). ``--phase24-only`` builds the kernels and
   runs phase 24 alone.
25. The chaos soaks and the operator tools (``tools/*_torch.py``) as a
   user runs them, each held to its own acceptance bar. 25a:
   ``soak_serving_torch.run_soak`` in process on phase 4's
   ``transformer_lm(8192, 512, 512, 8, 8)`` with the LayerNorm hook
   (paged, self-draft speculative, the storm phase, 4 clients, 10 s);
   25b: ``run_disagg_soak`` at its default model; 25c: the training
   soak's phases in a subprocess, the ledger phase at full scale and the
   training phase at smoke scale (its DOWNPOUR launches B1; the full
   training phase's accuracy floor needs a device per worker); 25d:
   ``soak_fleet_torch.py --smoke`` and ``--fabric --smoke`` as
   subprocesses whose replicas load the kernels this process built; 25e: ``dkt_top_torch.py --once`` and ``dkt_postmortem_torch.py
   --host`` against 25a's live server (the latter after its first
   watchdog trip) and ``dkt_top_torch.py --ps`` against 25c's standby.
   25c and 25d start together after 25a and run beside 25b.
   Each part prints its wall, fired faults by site, restarts, watchdog
   trips and the supervisors' late wakes, and the B1/B4/B7 launches it
   added (every process of a part writes its counts through
   ``DKT_LAUNCH_COUNTS_DIR``). ``--phase25-only`` builds the kernels and
   runs phase 25 alone.
27. The graft entry points (``graft_entry_torch.py``), riding on phase
   24's launches. 27a: every step of ``dryrun_multichip(8)``
   (``multichip_steps``: sync-DP, ZeRO-1, TP, the ring, Ulysses, the ring
   in a data group, the pipeline, pipe x data, the 3-D grid, EP and the
   ring-attached LM window) inside 24a's eight gloo rank processes, each
   step held against the same step on one rank within 1e-4 in the rank,
   on seeded inputs (``multichip_inputs``: JAX's shapes and weights), and
   the replicated results equal on every rank (``check_multichip``).
   27b: ``dryrun_multichip(1)`` (one NCCL rank) and
   ``dryrun_multiprocess(2)`` (two gloo ranks sharing the card: a sync-DP
   run with equal digests, then a commit over TCP to rank 0's socket PS),
   in a lane beside 24b's twins, each rank's start-up split. 27c:
   ``entry()``'s forward on the card, its output shape printed. They
   launch none of B1-B8 (plain "sgd"/"adam", no flash or LayerNorm hook,
   as JAX's dryrun). ``--phase27-only`` builds the kernels and runs 24a
   with 27a, then 27b and 27c.

``--import-seconds ROOT...`` times ``import distkeras_tpu_torch`` from
each checkout in fresh interpreters and exits (two commits compared in
one call).

``--profile`` adds where the time goes: the MoE LM's decode step beside
the dense LM's (19a), the decode step's device time at tp:1/2/4 (23), a
decode step (dense, paged, on
bf16 caches and grammar-masked), a
verify window with 8 busy slots, a swap-out, a swap-in and a fork of a
300-token slot, a predict forward, a training step, an async window and a
config-5 DynSGD/``resnet18`` window (host wall, device time by category,
idle share, top kernels).

The last lines are the kernels JSON, the ``nvidia-smi`` name/power line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense peaks: f32 on the CUDA cores, TF32 and bf16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

LN_TOL_F32 = 1e-5
LN_TOL_BF16 = 1e-2
FLASH_TOL_O = 2e-5
FLASH_TOL_LSE = 1e-5
LOGIT_TOL = 1e-4
ADAM_TOL = 1e-6  # same operation order; only pow() for c1/c2 may differ
FLASH_BWD_TOL = 1e-4  # times max(1, max|ref|): f32, summation order
BWD_16BIT_ROUNDING = 2.0 ** -8  # bf16's unit roundoff (8 significant bits)
LN_BWD_TOL_DX = 1e-5
LN_BWD_TOL_DGB = 1e-4  # times max|ref|: sums over 4096 rows, other order
TRAIN_LOSS_RTOL = 1e-3  # kernel vs plain path, per step, over 17 steps
TRAIN_STEPS = 17
# phase 6: 136 corpus windows over 2 workers, batch 8, window 4 -> 2
# windows of 4 steps each
ASYNC_STEPS = 16
ASYNC_COMMITS = 4
ASYNC_LR = 0.02  # plain SGD; DOWNPOUR's loss must fall at this rate
ASYNC_LR_MOMENTUM = 0.002  # momentum 0.9: the same effective step
# kernel vs plain center after 16 steps: the paths differ only in the flash
# and LN kernels' summation order (per-step losses agree to ~1e-7 relative
# in phase 5); a missed or doubled commit moves weights by a whole window
ASYNC_CENTER_TOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.monotonic()


def log(msg):
    """A result line, stamped with the seconds since the script started
    (the per-phase walls a cut is chosen from)."""
    print(f"[{time.monotonic() - _T0:7.1f} s] {msg}", flush=True)


def ab_turns(a, b):
    """The fresh-engine turns of an A/B comparison (12a, 14b, 15a, 16a).
    They ran A, B, B, A before phase 25 was added, and are cut to A, B to
    make room for it (PERF.md section 4, "Cut:"). Both paths still run, with every
    bar; a ratio is then one turn's against the other's."""
    return (a, b)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


#: fresh interpreters ``--import-seconds`` times for each root
IMPORT_RUNS = 5


def import_seconds(root):
    """Seconds a fresh interpreter takes to ``import distkeras_tpu_torch``
    from ``root`` once torch is loaded (what every rank process and twin
    pays on top of ``import torch``), ``IMPORT_RUNS`` times."""
    code = ("import sys, time\n"
            f"sys.path.insert(0, {os.path.abspath(root)!r})\n"
            "import torch\n"
            "t = time.perf_counter()\n"
            "import distkeras_tpu_torch\n"
            "print(time.perf_counter() - t)\n")
    out = []
    for _ in range(IMPORT_RUNS):
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=120)
        check(proc.returncode == 0, f"import from {root}: {proc.stderr}")
        out.append(float(proc.stdout.split()[-1]))
    return out


def call_time_ms(fn, iters=50, warmup=5):
    """Eager time per call: CUDA events around ``iters`` back-to-back calls.
    Where the host cannot enqueue as fast as the card runs (small shapes),
    this is the host's per-call cost, which is what the eager path pays."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters=20, reps=5, stream=None):
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed ``reps`` times between CUDA events — the host is out of the
    measurement, so this is what the card spends on the call's kernels.
    ``stream``: capture there (an autograd backward must be captured on
    the stream its forward ran on)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


#: calls of an optimizer's plain version per captured graph and per eager
#: timing: each call is a few hundred kernels over the whole table and
#: takes milliseconds, so 4 calls time it as well as 20 do at a fifth of
#: the capture (the cut that pays for phase 2c's added rows)
PLAIN_OPTIMIZER_ITERS = 4


def timings(kernel, plain, library, library_stream=None, plain_iters=None):
    """Device and eager per-call times of the kernel, its plain version
    and the library call (each a zero-argument callable; a library call
    that is an autograd backward names the stream its forward ran on).
    ``plain_iters``: calls of the plain version per graph and per eager
    timing (default: as the kernel's)."""
    out = {}
    for key, fn, stream in (("", kernel, None), ("plain_", plain, None),
                            ("library_", library, library_stream)):
        kw = {"iters": plain_iters} if key == "plain_" and plain_iters else {}
        out[f"{key}ms"] = device_time_ms(fn, stream=stream, **kw)
        out[f"{key}call_ms"] = call_time_ms(fn, **kw)
    return out


def backward_call(torch, forward, inputs, grad_out):
    """A library backward to time: ``forward(*inputs)`` recorded once on a
    stream of its own; the returned call runs its backward again (graph
    kept) and the stream is returned for the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward(*inputs)
    torch.cuda.current_stream().wait_stream(stream)

    def call():
        torch.autograd.grad(out, inputs, grad_out, retain_graph=True)

    return call, stream


def rotating(sets):
    """Cycle through input sets so repeated launches read cold-ish memory
    (the sets together exceed the 50 MB L2 where the inputs are large)."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]

    return nxt


#: bytes the input sets of one timed call rotate through at least: twice
#: the 50 MB L2, so a small optimizer table is read from HBM each launch,
#: as a training step (whose forward and backward pass in between) finds it
COLD_BYTES = 100e6


def cold_sets(nbytes):
    """How many copies of a call's inputs keep them out of the L2."""
    return max(1, math.ceil(COLD_BYTES / nbytes))


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 2


def check_layernorm(torch, F):
    """layernorm_fwd vs its plain version on each of its paths — 16-byte
    chunks (the main path's D = 512), one-element chunks (D = 510, and x a
    view with a storage offset), the block kernel (D > 1024) — in f32,
    bf16 and f16; a second launch must give the same bits. The path is the
    launcher's own rule (``fwd_path``). At (8, 512), the decode and
    prefill shape, the eager time of the hook as decode calls it
    (``fused_layer_norm`` under ``no_grad``) is timed too."""
    from distkeras_tpu_torch.ops.fused_layernorm import (
        _reference_layer_norm,
        fused_layer_norm,
        fwd_path,
        layernorm_fwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (n, d), dtype, offset, path, timed in [
        ((8, 512), torch.float32, 0, "vector", True),
        ((512, 512), torch.float32, 0, "vector", True),
        ((4096, 512), torch.float32, 0, "vector", True),
        ((4096, 512), torch.bfloat16, 0, "vector", True),
        ((3, 96), torch.float32, 0, "vector", True),
        ((8, 512), torch.float16, 0, "vector", False),
        ((37, 510), torch.float32, 0, "scalar", True),
        ((37, 510), torch.bfloat16, 0, "scalar", False),
        ((8, 512), torch.float32, 1, "scalar", True),
        ((2, 2048), torch.float32, 0, "block", False),
        ((3, 2050), torch.float16, 0, "block", False),
    ]:
        isz = torch.tensor([], dtype=dtype).element_size()
        nsets = max(1, min(16, (96 << 20) // (n * d * isz)))
        sets = []
        for _ in range(nsets):
            base = torch.empty(n * d + offset, device="cuda", dtype=dtype)
            base[offset:] = (torch.randn(n * d, device="cuda", generator=gen)
                             * 2 + 0.5).to(dtype)
            sets.append(base[offset:].view(n, d))
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        b = 0.1 * torch.randn(d, device="cuda", generator=gen)
        x = sets[0]
        took = fwd_path(x, g, b, torch.empty_like(x))
        y = layernorm_fwd(x, g, b, 1e-5)
        again = layernorm_fwd(x, g, b, 1e-5)
        ref = _reference_layer_norm(x, g, b, 1e-5)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs()
        max_err = float(err.max())
        if dtype == torch.float32:
            ok = max_err <= LN_TOL_F32
        else:
            ok = bool((err <= LN_TOL_BF16 + LN_TOL_BF16
                       * ref.float().abs()).all())
        deterministic = torch.equal(y, again)
        ok = ok and deterministic and took == path
        dname = str(dtype).replace("torch.", "")
        row = {
            "shape": [n, d], "dtype": dname, "storage_offset": offset,
            "path": took, "max_abs_err": max_err,
            "deterministic": deterministic, "ok": ok,
        }
        if timed:
            nxt = rotating(sets)
            gl, bl = g.to(dtype), b.to(dtype)
            row.update(timings(
                lambda: layernorm_fwd(nxt(), g, b, 1e-5),
                lambda: _reference_layer_norm(nxt(), g, b, 1e-5),
                lambda: F.layer_norm(nxt(), (d,), gl, bl, 1e-5),
            ))
            if (n, d, offset) == (8, 512, 0) and dtype == torch.float32:
                # the host bounds these: three rounds in turns, medians
                eager = {"layernorm_fwd": lambda: layernorm_fwd(
                             nxt(), g, b, 1e-5),
                         "fused_layer_norm_no_grad": lambda: fused_layer_norm(
                             nxt(), g, b, 1e-5),
                         "F.layer_norm": lambda: F.layer_norm(
                             nxt(), (d,), gl, bl, 1e-5)}
                reads = {k: [] for k in eager}
                with torch.no_grad():
                    for _ in range(3):
                        for k, fn in eager.items():
                            reads[k].append(call_time_ms(fn, iters=200))
                row["eager_call_ms_median"] = {
                    k: sorted(r)[1] for k, r in reads.items()}
            bound_ms, bound_by = bound(2 * n * d * isz + 2 * d * 4, 8 * n * d,
                                       "float32" if isz == 4 else "bfloat16")
            row.update(bound_ms=bound_ms, bound_by=bound_by)
        log(f"layernorm_fwd {row}")
        check(ok, f"layernorm_fwd disagrees with its plain version, differs "
                  f"between two launches or took another path: {row}")
        rows.append(row)
        del sets, x, y, again, ref
    return rows


def fwd_16bit_tolerance(torch, q, k, v, causal, ref_o):
    """Elementwise tolerance of the 16-bit forward's O: the kernel rounds P
    to the input type before P V (at most 2^-8 of each term, so 2^-8 *
    sum p |v| over the keys, p normalized) and O is rounded like the
    reference's (one ulp, 2^-7 * |ref|); twice the first term covers the
    f32 sums' order."""
    from distkeras_tpu_torch.ops.flash_attention import _scores

    p = torch.softmax(_scores(q, k, causal), dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())
    return BWD_16BIT_ROUNDING * (2 * pv + 2 * ref_o.float().abs()) + 1e-6


def check_flash(torch, F):
    """flash_fwd vs the plain forward: f32 O within FLASH_TOL_O and lse
    within FLASH_TOL_LSE absolute; bf16 O within the elementwise bound of
    ``fwd_16bit_tolerance``, lse within FLASH_TOL_LSE; a second launch
    must give the same bits. Bound: the path the kernel takes — 3xTF32 on
    the tensor cores in f32 (three products per FLOP at the TF32 peak),
    one bf16 pass in bf16 — with the CUDA-core f32 figure beside it."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_fwd,
        flash_fwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (b, t, h, d), causal, dtype in [
        ((8, 512, 8, 64), True, torch.float32),
        ((8, 512, 8, 64), False, torch.float32),
        ((2, 1, 8, 64), True, torch.float32),
        ((2, 200, 8, 64), True, torch.float32),
        ((2, 512, 8, 64), False, torch.float32),
        ((8, 512, 8, 64), True, torch.bfloat16),
        ((8, 512, 4, 128), True, torch.float32),
    ]:
        per = 3 * b * t * h * d * 4
        nsets = max(1, min(8, (96 << 20) // per))
        sets = [
            tuple(torch.randn(b, t, h, d, device="cuda", generator=gen)
                  .to(dtype) for _ in range(3))
            for _ in range(nsets)
        ]
        q, k, v = sets[0]
        o, lse = flash_fwd(q, k, v, causal)
        o2, lse2 = flash_fwd(q, k, v, causal)
        ro, rlse = _reference_flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        deterministic = torch.equal(o, o2) and torch.equal(lse, lse2)
        diff_o = (o.float() - ro.float()).abs()
        err_o = float(diff_o.max())
        err_lse = float((lse - rlse).abs().max())
        if dtype == torch.float32:
            ratio_o = err_o / FLASH_TOL_O
        else:
            ratio_o = float((diff_o / fwd_16bit_tolerance(
                torch, q, k, v, causal, ro)).max())
        ok = deterministic and ratio_o <= 1.0 and err_lse <= FLASH_TOL_LSE
        nxt = rotating(sets)
        hsets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
        hnxt = rotating(hsets)
        times = timings(
            lambda: flash_fwd(*nxt(), causal),
            lambda: _reference_flash_fwd(*nxt(), causal),
            lambda: F.scaled_dot_product_attention(*hnxt(), is_causal=causal),
        )
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        nbytes = 4 * b * t * h * d * q.element_size() + b * h * t * 4
        flops = 4 * d * pairs
        if dtype == torch.float32:
            dname = "float32"
            bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
            path = "3xTF32 mma.sync: 3 x FLOPs at the TF32 peak"
        else:
            dname = "bfloat16"
            bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
            path = "bf16 mma.sync: FLOPs at the bf16 peak"
        row = {
            "shape": [b, t, h, d], "causal": causal, "dtype": dname,
            "max_abs_err": max(err_o, err_lse), "err_o": err_o,
            "err_lse": err_lse, "o_err_over_tolerance": ratio_o,
            "deterministic": deterministic, "ok": ok, **times,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_path": path,
            "cuda_core_bound_ms": bound(nbytes, flops, "float32")[0],
        }
        log(f"flash_fwd {row}")
        check(ok, f"flash_fwd disagrees with its plain version or differs "
                  f"between two launches: {row}")
        rows.append(row)
        del sets, hsets, q, k, v, o, o2, ro
    return rows


# ----------------------------------------------------------------- phase 2b


def check_adam(torch, shapes, model=None, dname="float32"):
    """adam_fused vs its plain version over one model's leaf shapes, from
    step count 4 (so c1/c2 are not the first step's); ``dname`` the
    parameters' and gradients' dtype (the moments stay f32)."""
    from distkeras_tpu_torch.ops.pallas_kernels import (
        _TableCache,
        adam_fused,
        adam_step_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(scale, fn=torch.randn):
        return [fn(s, device="cuda", generator=gen) * scale for s in shapes]

    dtype = getattr(torch, dname)
    params = [p.to(dtype) for p in rand(0.05)]
    grads = [g.to(dtype) for g in rand(1e-3)]
    ms = rand(1e-4)
    vs = [v * v for v in rand(1e-3)]
    hyper = (1e-3, 0.9, 0.999, 1e-8)

    def state():
        return ([p.clone() for p in params], [m.clone() for m in ms],
                [v.clone() for v in vs],
                torch.tensor([4, 0], dtype=torch.int32, device="cuda"))

    kp, km, kv, ks = state()
    table = _TableCache()
    adam_fused(kp, grads, km, kv, ks, *hyper, table)
    rp, rm, rv, rs = state()
    adam_step_plain(rp, grads, rm, rv, rs, *hyper)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(kp + km + kv, rp + rm + rv))
    steps = (ks.tolist(), rs.tolist())
    ok = err <= ADAM_TOL and steps == ([5, 0], [5, 0])
    n = sum(p.numel() for p in params)
    # p read and written, g read, f32 m and v read and written
    nbytes = (3 * params[0].element_size() + 16) * n
    # timed over enough copies (each with its own table) to miss the L2
    gsets = [grads] + [[g.clone() for g in grads]
                       for _ in range(cold_sets(nbytes) - 1)]
    ksets = [(kp, grads, km, kv, ks, *hyper, table)] + [
        (*state()[:1], g, *state()[1:], *hyper, _TableCache())
        for g in gsets[1:]]
    psets = [(rp, grads, rm, rv, rs, *hyper)] + [
        (*state()[:1], g, *state()[1:], *hyper) for g in gsets[1:]]
    libs = []
    for g in gsets:
        lp = [p.clone().requires_grad_() for p in params]
        for p, gl in zip(lp, g):
            p.grad = gl
        libs.append(torch.optim.Adam(lp, lr=1e-3, fused=True,
                                     capturable=True))
    for args, lib in zip(ksets, libs):  # tables and library state made
        adam_fused(*args)  # before the graph capture
        lib.step()
    knxt, pnxt, lnxt = rotating(ksets), rotating(psets), rotating(libs)
    times = timings(
        lambda: adam_fused(*knxt()),
        lambda: adam_step_plain(*pnxt()),
        lambda: lnxt().step(),
        plain_iters=PLAIN_OPTIMIZER_ITERS,
    )
    bound_ms, bound_by = bound(nbytes, 14 * n, "float32")
    row = {
        "shape": [len(shapes), n], "dtype": dname, "max_abs_err": err,
        "model": model, "input_sets": len(ksets), "steps_after": steps,
        "table_builds": table.builds,
        "grad_pointer_uploads": table.grad_uploads, "ok": ok,
        **times, "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / times["ms"],
        # torch's fused Adam keeps its moments in the parameters' dtype
        "library_moments": dname,
    }
    log(f"adam_fused {row}")
    check(ok, f"adam_fused disagrees with its plain version: {row}")
    del params, grads, ms, vs, kp, km, kv, rp, rm, rv, ksets, psets, libs
    return row


def sgd_library_call(torch, params, grads, lr, mu, nesterov):
    """The library step computing B1/B2's function, for context only:
    ``torch._foreach_add_`` without momentum; with it ``torch.optim.SGD``,
    fused where this torch offers ``fused=True`` for SGD, else foreach."""
    if mu == 0.0:
        return (lambda: torch._foreach_add_(params, grads, alpha=-lr)), \
            "torch._foreach_add_"
    lp = [p.clone().requires_grad_() for p in params]
    for p, g in zip(lp, grads):
        p.grad = g
    try:
        opt = torch.optim.SGD(lp, lr=lr, momentum=mu, nesterov=nesterov,
                              fused=True)
        name = "torch.optim.SGD(fused=True)"
    except (RuntimeError, TypeError, ValueError):
        opt = torch.optim.SGD(lp, lr=lr, momentum=mu, nesterov=nesterov,
                              foreach=True)
        name = "torch.optim.SGD(foreach=True)"
    opt.step()  # the momentum buffers exist before the capture
    return opt.step, name


SGD_CASES = ((0.0, False, "float32"), (0.9, False, "float32"),
             (0.9, True, "float32"), (0.0, False, "bfloat16"),
             (0.9, True, "bfloat16"))


def offset_views(torch, ts, offset):
    """Each tensor copied into a buffer of its own at an element offset: a
    contiguous view whose pointer is off the 16-byte grid for offset 1."""
    if not offset:
        return [t.clone() for t in ts]
    return [torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
            [offset:].view(t.shape).copy_(t) for t in ts]


def check_sgd(torch, shapes, model=None, cases=SGD_CASES, offset=0,
              timed=True):
    """sgd_fused (B1) and sgd_momentum_fused (B2) vs their plain versions
    over one model's leaf shapes (by default: f32 with momentum 0, 0.9 and
    0.9 Nesterov, and one bf16 set of each kernel). Bit-equal: the same
    operation order, each step rounded (``__f*_rn``), the same final
    rounding to bf16 and f16. ``offset`` 1 puts every p, g and m of the
    kernel's launch off the 16-byte grid (its scalar path); ``timed``
    False checks without timing."""
    from distkeras_tpu_torch.ops.pallas_kernels import (
        _TableCache,
        sgd_fused,
        sgd_momentum_fused,
        sgd_momentum_step_plain,
        sgd_step_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(23)
    n = sum(math.prod(s) for s in shapes)
    rows = {"sgd_fused": [], "sgd_momentum_fused": []}
    lr = 0.02
    for mu, nesterov, dname in cases:
        dtype = getattr(torch, dname)
        params = [(torch.randn(s, device="cuda", generator=gen) * 0.05)
                  .to(dtype) for s in shapes]
        grads = [(torch.randn(s, device="cuda", generator=gen) * 1e-2)
                 .to(dtype) for s in shapes]
        ms = [torch.randn(s, device="cuda", generator=gen) * 1e-2
              for s in shapes]
        kp, km = offset_views(torch, params, offset), offset_views(
            torch, ms, offset)
        kg = offset_views(torch, grads, offset) if offset else grads
        rp, rm = [p.clone() for p in params], [m.clone() for m in ms]
        tables = _TableCache()
        if mu == 0.0:
            kname = "sgd_fused"
            kernel_fn = lambda: sgd_fused(kp, kg, lr, tables)  # noqa: E731
            plain_fn = lambda: sgd_step_plain(rp, grads, lr)  # noqa: E731
        else:
            kname = "sgd_momentum_fused"
            kernel_fn = lambda: sgd_momentum_fused(  # noqa: E731
                kp, kg, km, lr, mu, nesterov, tables)
            plain_fn = lambda: sgd_momentum_step_plain(  # noqa: E731
                rp, grads, rm, lr, mu, nesterov)
        for _ in range(2):  # two steps: the momenta feed back
            kernel_fn()
            plain_fn()
        torch.cuda.synchronize()
        if mu == 0.0:
            km, rm = [], []
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(kp + km, rp + rm))
        equal = all(torch.equal(a, b) for a, b in zip(kp + km, rp + rm))
        misaligned = all(t.data_ptr() % 16 for t in kp + kg + km)
        isz = torch.tensor([], dtype=dtype).element_size()
        nbytes = 3 * isz * n + (8 * n if mu else 0)
        row = {
            "shape": [len(shapes), n], "dtype": dname, "model": model,
            "momentum": mu, "nesterov": nesterov, "storage_offset": offset,
            "max_abs_err": err, "bit_equal": equal,
            "ok": equal and (misaligned or not offset),
            "table_builds": tables.builds,
            "grad_pointer_uploads": tables.grad_uploads,
        }
        if not timed:
            log(f"{kname} {row}")
            check(row["ok"], f"{kname} differs from its plain version: "
                             f"{row}")
            rows[kname].append(row)
            del params, grads, ms, kp, km, kg, rp, rm
            continue
        # timed over enough copies (each with its own table) to miss the L2
        sets = [(kp, kg, km, tables, rp, rm)] + [
            ([p.clone() for p in params], [g.clone() for g in grads],
             [m.clone() for m in ms], _TableCache(),
             [p.clone() for p in params], [m.clone() for m in ms])
            for _ in range(cold_sets(nbytes) - 1)]
        libs = [sgd_library_call(torch, st[0], st[1], lr, mu, nesterov)
                for st in sets]
        nxt, lnxt = rotating(sets), rotating([f for f, _ in libs])
        if mu == 0.0:
            def kernel_fn():
                p_, g_, _, t_, _, _ = nxt()
                sgd_fused(p_, g_, lr, t_)

            def plain_fn():
                _, g_, _, _, p_, _ = nxt()
                sgd_step_plain(p_, g_, lr)
        else:
            def kernel_fn():
                p_, g_, m_, t_, _, _ = nxt()
                sgd_momentum_fused(p_, g_, m_, lr, mu, nesterov, t_)

            def plain_fn():
                _, g_, _, _, p_, m_ = nxt()
                sgd_momentum_step_plain(p_, g_, m_, lr, mu, nesterov)
        for _ in sets:  # every table built before the graph capture
            kernel_fn()
        times = timings(kernel_fn, plain_fn, lambda: lnxt()(),
                        plain_iters=PLAIN_OPTIMIZER_ITERS)
        lib_name = libs[0][1]
        flops = (2 + (2 if mu else 0) + (2 if nesterov else 0)) * n
        bound_ms, bound_by = bound(nbytes, flops, "float32")
        row.update(input_sets=len(sets), **times, library=lib_name,
                   bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / times["ms"])
        log(f"{kname} {row}")
        check(row["ok"], f"{kname} differs from its plain version: {row}")
        rows[kname].append(row)
        del params, grads, ms, kp, km, kg, rp, rm, sets, libs
    return rows


def run_phase2c(torch, lm_shapes):
    """Phases 2b and 2c: ``adam_fused`` (B3) and ``sgd_fused`` /
    ``sgd_momentum_fused`` (B1, B2) against their plain versions at the
    LM's leaves (``lm_shapes``), at BASELINE configs 2-5's (phase 7) and at
    the member-stacked tables (phase 9). Returns (B3 rows, {kernel: B1/B2
    rows})."""
    adam_rows = [check_adam(torch, lm_shapes, "transformer_lm d512/L8")]
    sgd_rows = check_sgd(torch, lm_shapes, "transformer_lm d512/L8")
    # B1/B2 in f16, and on leaves that are views at a 1-element offset
    # (p, g and m off the 16-byte grid: the scalar path), checked untimed
    for kname, rows in check_sgd(
            torch, lm_shapes, "transformer_lm d512/L8",
            cases=((0.9, True, "float16"),), timed=False).items():
        sgd_rows[kname] += rows
    for kname, rows in check_sgd(
            torch, lm_shapes, "transformer_lm d512/L8, 1-element offset",
            cases=((0.9, True, "bfloat16"),), offset=1,
            timed=False).items():
        sgd_rows[kname] += rows
    # measurement only: B3 with bf16 parameters at the LM's leaves
    adam_rows.append(check_adam(torch, lm_shapes, "transformer_lm d512/L8",
                                "bfloat16"))
    # B3 and B1 at the leaf tables of BASELINE configs 2-5 (phase 7)
    zoo_shapes = baseline_leaf_shapes()
    for mname in ("resnet18", "mnist_cnn"):
        adam_rows.append(check_adam(torch, zoo_shapes[mname], mname))
    for mname in ("cifar10_cnn", "higgs_mlp"):
        sgd_rows["sgd_fused"] += check_sgd(
            torch, zoo_shapes[mname], mname,
            cases=((0.0, False, "float32"),))["sgd_fused"]
    # the member-stacked tables of phase 9, one launch over every member's
    # leaves: 4 x mnist_cnn and 2 x d512/L8 (Ensemble), 4 x higgs_mlp
    # (Averaging)
    adam_rows.append(check_adam(torch, zoo_shapes["mnist_cnn"] * 4,
                                "4 x mnist_cnn, vmapped members"))
    adam_rows.append(check_adam(torch, lm_shapes * 2,
                                "2 x transformer_lm d512/L8, vmapped members"))
    sgd_rows["sgd_fused"] += check_sgd(
        torch, zoo_shapes["higgs_mlp"] * 4, "4 x higgs_mlp, vmapped replicas",
        cases=((0.0, False, "float32"),))["sgd_fused"]
    return adam_rows, sgd_rows


def bf16_bwd_tolerances(torch, q, k, v, do, lse, delta, causal, refs):
    """Elementwise tolerances of the 16-bit backward: the kernel rounds P
    and dS to the input type before the second product (at most 2^-8 of
    each term, so 2^-8 * sum |x||y| over the reduced index) and the output
    is rounded like the reference's (one ulp, 2^-7 * |ref|); twice the
    first term covers the f32 sums' order."""
    from distkeras_tpu_torch.ops.flash_attention import _reference_p_ds

    p, ds = _reference_p_ds(q, k, v, do, lse, delta, causal)
    ads = ds.abs()
    sums = {
        "dq": torch.einsum("bhqk,bkhd->bqhd", ads, k.float().abs()),
        "dk": torch.einsum("bhqk,bqhd->bkhd", ads, q.float().abs()),
        "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()),
    }
    return {n: BWD_16BIT_ROUNDING * (2 * sums[n] + 2 * refs[n].float().abs())
            + 1e-6 for n in sums}


def check_flash_bwd(torch, F):
    """flash_bwd_dq / flash_bwd_dkv vs the plain backward, on the forward
    kernel's O and lse (what the training step hands them): f32 within
    FLASH_BWD_TOL * max(1, max|ref|), bf16 within the elementwise bound of
    ``bf16_bwd_tolerances``; a second launch must give the same bits (no
    atomics). Bound: the path the kernels take — 3xTF32 on the tensor
    cores in f32 (three products per FLOP at the TF32 peak), one bf16 pass
    in bf16 — with the CUDA-core f32 figure beside it."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_bwd_dkv,
        _reference_flash_bwd_dq,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )

    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    gen = torch.Generator(device="cuda").manual_seed(17)
    for (b, t, h, d), causal, dtype in [
        ((8, 512, 8, 64), True, torch.float32),
        ((8, 512, 8, 64), False, torch.float32),
        ((2, 200, 8, 64), True, torch.float32),
        ((8, 512, 8, 64), True, torch.bfloat16),
    ]:
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        o, lse = flash_fwd(q, k, v, causal)
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq2, delta2 = flash_bwd_dq(q, k, v, o, lse, do, causal)
        dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta2, causal)
        rdq, rdelta = _reference_flash_bwd_dq(q, k, v, o, lse, do, causal)
        rdk, rdv = _reference_flash_bwd_dkv(q, k, v, do, lse, rdelta, causal)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, a2) for a, a2 in (
            (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
        refs = {"dq": rdq, "dk": rdk, "dv": rdv, "delta": rdelta}
        got = {"dq": dq, "dk": dk, "dv": dv, "delta": delta}
        if dtype == torch.float32:
            tols = {n: FLASH_BWD_TOL * max(1.0, float(r.abs().max()))
                    for n, r in refs.items()}
        else:
            tols = bf16_bwd_tolerances(torch, q, k, v, do, lse, rdelta,
                                       causal, refs)
            tols["delta"] = FLASH_BWD_TOL * max(1.0, float(rdelta.abs().max()))
        errs = {}
        for n in refs:
            diff = (got[n].float() - refs[n].float()).abs()
            errs[n] = (float(diff.max()), float((diff / tols[n]).max()))
        ok = deterministic and all(ratio <= 1.0 for _, ratio in errs.values())
        # the library call: SDPA's backward (dQ, dK, dV at once), timed
        # for context only
        library, lib_stream = backward_call(
            torch,
            lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, is_causal=causal),
            tuple(x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v)),
            do.transpose(1, 2).contiguous(),
        )

        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        io = b * t * h * d * q.element_size()
        stats = b * h * t * 4
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        for kname, kernel_fn, plain_fn, nbytes, flops, kerr in (
            ("flash_bwd_dq",
             lambda: flash_bwd_dq(q, k, v, o, lse, do, causal),
             lambda: _reference_flash_bwd_dq(q, k, v, o, lse, do, causal),
             6 * io + 2 * stats, 6 * d * pairs, ("dq", "delta")),
            ("flash_bwd_dkv",
             lambda: flash_bwd_dkv(q, k, v, do, lse, delta, causal),
             lambda: _reference_flash_bwd_dkv(q, k, v, do, lse, rdelta,
                                              causal),
             6 * io + 2 * stats, 8 * d * pairs, ("dk", "dv")),
        ):
            times = timings(kernel_fn, plain_fn, library, lib_stream)
            if dtype == torch.float32:
                bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
                path = "3xTF32 mma.sync: 3 x FLOPs at the TF32 peak"
            else:
                bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
                path = "bf16 mma.sync: FLOPs at the bf16 peak"
            row = {
                "shape": [b, t, h, d], "causal": causal, "dtype": dname,
                "max_abs_err": max(errs[e][0] for e in kerr),
                "errs": {e: errs[e] for e in kerr},
                "deterministic": deterministic, "ok": ok, **times,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_path": path,
                "cuda_core_bound_ms": bound(nbytes, flops, "float32")[0],
            }
            log(f"{kname} {row}")
            rows[kname].append(row)
        check(ok, f"flash backward disagrees with its plain version or "
                  f"differs between two launches: {dname} {errs} "
                  f"deterministic={deterministic}")
        del q, k, v, do, o, lse, library
    return rows


def infinite_q_rows(torch, causal, rows, gen, grad=False):
    """q, k, v (and dO) of shape (2, 130, 4, 64) f32: every key's first
    component negative and each (b, t, h) of ``rows`` a query (+inf, 0,
    ..., 0), whose every score is inf * (negative) + 0 = -inf."""
    ts = [torch.randn(2, 130, 4, 64, device="cuda", generator=gen)
          for _ in range(4 if grad else 3)]
    ts[1][..., 0] = -ts[1][..., 0].abs() - 0.5
    for b, t, h in rows:
        ts[0][b, t, h] = 0.0
        ts[0][b, t, h, 0] = float("inf")
    return ts


def check_flash_infinite_rows(torch):
    """The f32 flash kernels on rows with an infinite q element, held to
    the JAX kernels' answers (their blocks run the guarded split): the
    forward gives each such row O = 0 and lse = -inf, everything finite,
    the other rows within FLASH_TOL_O / FLASH_TOL_LSE; on the forward's
    output the backward gives those rows dQ = 0, dQ and dV finite and
    within FLASH_BWD_TOL of the plain version, and dK NaN exactly where
    the plain version's is (that row's dS = 0 times the infinity). The
    backward's rows lie in the last query tile, which every key tile
    visits under causal masking too."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_bwd,
        _reference_flash_fwd,
        flash_bwd,
        flash_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(29)
    out = []
    for causal in (True, False):
        empty = [(0, 5, 1), (1, 129, 3)]
        q, k, v = infinite_q_rows(torch, causal, empty, gen)
        o, lse = flash_fwd(q, k, v, causal)
        ro, rlse = _reference_flash_fwd(q, k, v, causal)
        keep = torch.ones(o.shape[:3], dtype=torch.bool, device="cuda")
        rows_ok = True
        for b, t, h in empty:
            rows_ok &= bool((o[b, t, h] == 0).all()) and \
                float(lse[b, h, t, 0]) == float("-inf")
            keep[b, t, h] = False
        err_o = float((o - ro).abs()[keep].max())
        lkeep = keep.transpose(1, 2).unsqueeze(-1)
        err_lse = float((lse - rlse).abs()[lkeep].max())
        fwd_ok = (rows_ok and bool(torch.isfinite(o).all())
                  and err_o <= FLASH_TOL_O and err_lse <= FLASH_TOL_LSE)

        last = [(0, 128, 1), (1, 129, 3)]
        q, k, v, do = infinite_q_rows(torch, causal, last, gen, grad=True)
        o, lse = flash_fwd(q, k, v, causal)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal)
        rdq, rdk, rdv = _reference_flash_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        zero_rows = all(bool((dq[b, t, h] == 0).all()) for b, t, h in last)
        nan_where = torch.equal(torch.isnan(dk), torch.isnan(rdk)) and \
            bool(torch.isnan(rdk).any()) and not bool(torch.isinf(dk).any())
        fin = torch.isfinite(rdk)
        errs = {}
        for name, a, r in (("dq", dq, rdq), ("dv", dv, rdv),
                           ("dk", dk[fin], rdk[fin])):
            tol = FLASH_BWD_TOL * max(1.0, float(r.abs().max()))
            errs[name] = (float((a - r).abs().max()), tol)
        bwd_ok = (zero_rows and nan_where and bool(torch.isfinite(dq).all())
                  and bool(torch.isfinite(dv).all())
                  and all(e <= t for e, t in errs.values()))
        row = {"causal": causal, "fwd_rows_zero_and_lse_neg_inf": rows_ok,
               "fwd_err_o": err_o, "fwd_err_lse": err_lse,
               "bwd_dq_rows_zero": zero_rows,
               "bwd_dk_nan_where_plain": nan_where, "bwd_errs": errs,
               "ok": fwd_ok and bwd_ok}
        log(f"flash f32 infinite q element {row}")
        check(row["ok"], f"flash kernels on an infinite q element: {row}")
        out.append(row)
    return out


def check_layernorm_bwd(torch, F):
    from distkeras_tpu_torch.ops.fused_layernorm import (
        _reference_layer_norm_bwd,
        layernorm_bwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(19)
    for (n, d), dtype in [
        ((8, 512), torch.float32), ((4096, 512), torch.float32),
        ((4096, 512), torch.bfloat16), ((3, 96), torch.float32),
        ((37, 510), torch.float32),
    ]:
        isz = torch.tensor([], dtype=dtype).element_size()
        nsets = max(1, min(16, (96 << 20) // (2 * n * d * isz)))
        sets = [tuple((torch.randn(n, d, device="cuda", generator=gen) * 2
                       + 0.5).to(dtype) for _ in range(2))
                for _ in range(nsets)]
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        x, dy = sets[0]
        dx, dg, db = layernorm_bwd(x, g, dy, 1e-5)
        rdx, rdg, rdb = _reference_layer_norm_bwd(x, g, dy, 1e-5)
        again = layernorm_bwd(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        ex = (dx.float() - rdx.float()).abs()
        if dtype == torch.float32:
            ok = float(ex.max()) <= LN_BWD_TOL_DX
        else:
            ok = bool((ex <= LN_TOL_BF16 + LN_TOL_BF16 * rdx.float().abs()).all())
        egb = [float((a - r).abs().max()) / max(1e-30, float(r.abs().max()))
               for a, r in ((dg, rdg), (db, rdb))]
        deterministic = torch.equal(again[1], dg) and torch.equal(again[2], db)
        ok = ok and max(egb) <= LN_BWD_TOL_DGB and deterministic
        nxt = rotating(sets)
        library, lib_stream = backward_call(
            torch,
            lambda a, b_, c: F.layer_norm(a, (d,), b_, c, 1e-5),
            (x.detach().clone().requires_grad_(),
             g.to(dtype).requires_grad_(),
             torch.zeros(d, device="cuda", dtype=dtype, requires_grad=True)),
            dy,
        )

        def kernel_call():
            xx, dd = nxt()
            return layernorm_bwd(xx, g, dd, 1e-5)

        def plain_call():
            xx, dd = nxt()
            return _reference_layer_norm_bwd(xx, g, dd, 1e-5)

        times = timings(kernel_call, plain_call, library, lib_stream)
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        bound_ms, bound_by = bound(3 * n * d * isz + 3 * d * 4, 16 * n * d,
                                   dname)
        row = {
            "shape": [n, d], "dtype": dname,
            "max_abs_err": float(ex.max()), "dgamma_dbeta_rel_err": egb,
            "deterministic": deterministic, "ok": ok, **times,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"layernorm_bwd {row}")
        check(ok, f"layernorm_bwd disagrees with its plain version: {row}")
        rows.append(row)
    return rows


# ------------------------------------------------------------- phases 3, 4


def detach_hooks(model):
    from distkeras_tpu_torch.models.layers import LayerNorm
    from distkeras_tpu_torch.models.sequential import walk_layers
    from distkeras_tpu_torch.parallel.ring_attention import (
        detach_ring_attention,
    )

    detach_ring_attention(model)
    for layer in walk_layers(model):
        if isinstance(layer, LayerNorm):
            layer.norm_fn = None


def forward(torch, model, seqs):
    with torch.no_grad():
        return model(torch.as_tensor(seqs, device="cuda")).float()


def run_predict(torch, np, lm):
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving.engine import ServingEngine
    from distkeras_tpu_torch.serving.scheduler import EngineStoppedError

    check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    eng = ServingEngine(lm, num_slots=8).start()
    try:
        check(not eng.health()["generate_enabled"],
              "hooked model must be predict-only")
        try:
            eng.submit(np.arange(4), 4)
            raise SmokeFailure("generate was not refused on a hooked model")
        except EngineStoppedError:
            pass
        x = np.random.default_rng(3).integers(0, 8192, (8, 512)).astype(np.int32)
        eng.predict(x[:1], timeout=600)  # the batcher thread's first GEMMs
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        y = eng.predict(x, timeout=600)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
    finally:
        eng.stop()
    check(y.shape == (8, 512, 8192) and np.isfinite(y).all(),
          f"predict output malformed: {y.shape}")
    check({k: n for k, n in counts.items() if n}
          == {"layernorm_fwd": 17, "flash_fwd": 8},
          f"predict did not run through the kernels: {counts}")
    detach_hooks(lm)
    plain = forward(torch, lm, x).cpu().numpy()
    err = float(np.abs(y - plain).max())
    log(f"predict: 8x512 in {secs:.3f} s, launches {counts}, "
        f"max |kernel - plain| logits {err:.3e}")
    check(err <= LOGIT_TOL, f"predict logits disagree with the plain path: {err}")
    return {"seconds": secs, "launches": counts, "max_abs_err": err}


def phase4_mix(np):
    """Phase 4's 16 requests: prompts of 16-256 tokens, 32-64 new tokens,
    every fourth one sampled (the last two of those top-k/top-p
    filtered)."""
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(16):
        prompt = rng.integers(0, 8192, int(rng.integers(16, 257))).astype(np.int32)
        n_new = int(rng.integers(32, 65))
        sampling = None
        if i % 4 == 3:  # 4 sampled, 2 of them filtered
            sampling = {"temperature": 0.8, "seed": 100 + i}
            if i >= 8:
                sampling.update(top_k=50, top_p=0.9)
        reqs.append((prompt, n_new, sampling))
    return reqs


def run_generate(torch, np, lm):
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving.engine import ServingEngine

    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    reqs = phase4_mix(np)
    eng = ServingEngine(lm, num_slots=8).start()
    try:
        eng._stepper.warmup()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        handles = [eng.submit(p, n, sampling=s) for p, n, s in reqs]
        outs = [eng.wait(h, timeout=600) for h in handles]
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
        replay = [
            eng.generate(p, n, sampling=s, timeout=600)
            for p, n, s in reqs if s is not None
        ]
        stats = eng.stats()
    finally:
        eng.stop()
    n_tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
    check(all(len(o) == len(p) + n for o, (p, n, _) in zip(outs, reqs)),
          "a request did not finish with its max_new_tokens")
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"generate did not run through the LN kernel alone: {counts}")
    sampled = [o for o, (_, _, s) in zip(outs, reqs) if s is not None]
    check(all((a == b).all() for a, b in zip(sampled, replay)),
          "sampled requests did not replay identically")
    # teacher-forced logits on the kernel path vs the plain path, and every
    # greedy token = argmax (or a tie within LOGIT_TOL)
    greedy = [(o, p, n) for o, (p, n, s) in zip(outs, reqs) if s is None]
    worst_err, worst_gap = 0.0, 0.0
    kernel_logits = []
    for o, p, n in greedy:
        kernel_logits.append(forward(torch, lm, o[None])[0].cpu().numpy())
    detach_hooks(lm)
    for (o, p, n), kl in zip(greedy, kernel_logits):
        pl = forward(torch, lm, o[None])[0].cpu().numpy()
        worst_err = max(worst_err, float(np.abs(kl - pl).max()))
        gen_pos = np.arange(len(p) - 1, len(o) - 1)
        chosen = kl[gen_pos, o[gen_pos + 1]]
        worst_gap = max(worst_gap, float((kl[gen_pos].max(-1) - chosen).max()))
    check(worst_err <= LOGIT_TOL,
          f"teacher-forced logits disagree kernel vs plain: {worst_err}")
    check(worst_gap <= LOGIT_TOL,
          f"a greedy token is not the argmax of its logits (gap {worst_gap})")
    attach_fused_layernorm(lm)
    solo = CachedSequenceGenerator(lm)
    agree = total = 0
    for o, p, n in greedy:
        s = solo.generate(p[None], n)[0]
        agree += int((s[len(p):] == o[len(p):]).sum())
        total += n
    res = {
        "requests": len(reqs), "tokens": n_tokens, "seconds": secs,
        "tokens_per_s": n_tokens / secs, "launches": counts,
        "teacher_forced_max_abs_err": worst_err,
        "max_argmax_gap": worst_gap,
        "solo_token_agreement": agree / total,
        "steps": stats["steps"], "prefill_chunks": stats["prefill_chunks"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
    }
    log(f"generate: {res}")
    return res, reqs, outs


# ------------------------------------------------------------------ phase 5


def make_lm(zoo):
    return zoo.transformer_lm(vocab_size=8192, seq_len=512, d_model=512,
                              num_heads=8, depth=8, seed=0)


def train_once(torch, lm, optimizer, ds):
    from distkeras_tpu_torch.trainers import SingleTrainer

    trainer = SingleTrainer(
        lm, optimizer, "next_token_crossentropy",
        metrics=["next_token_accuracy"], batch_size=8, window=4,
        learning_rate=1e-3, seed=0, device_resident=True,
    )
    t0 = time.monotonic()
    result = trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    return trainer, result, time.monotonic() - t0


def run_train(torch, np, zoo):
    """SingleTrainer on the kernel path, then on the plain path."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    check(len(ds) == 8 * TRAIN_STEPS, f"corpus windows: {len(ds)}")
    lm = make_lm(zoo)
    check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    kernels.reset_launch_counts()
    trainer, result, secs = train_once(torch, lm, "pallas_adam", ds)
    counts = kernels.launch_counts()
    hist = trainer.get_history()
    unchanged = all(torch.equal(before[k], v)
                    for k, v in lm.state_dict().items())
    del lm, before, result
    plain_lm = make_lm(zoo)
    kernels.reset_launch_counts()
    plain_trainer, plain_result, plain_secs = train_once(
        torch, plain_lm, "adam", ds)
    plain_counts = kernels.launch_counts()
    plain_hist = plain_trainer.get_history()
    del plain_lm, plain_result
    torch.cuda.empty_cache()

    per_step = {"layernorm_fwd": 17, "layernorm_bwd": 17, "flash_fwd": 8,
                "flash_bwd_dq": 8, "flash_bwd_dkv": 8, "adam_fused": 1}
    expected = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    losses = [r["loss"] for r in hist]
    plain_losses = [r["loss"] for r in plain_hist]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    windows = trainer.history.get_timings()
    steady = windows[1:]  # the first window pays cuBLAS/allocator warm-up
    steady_sps = sum(n for n, _ in steady) / sum(t for _, t in steady)
    res = {
        "steps": len(hist), "seconds": secs, "plain_seconds": plain_secs,
        "samples_per_s": trainer.history.samples_per_second(),
        "tokens_per_s": trainer.history.samples_per_second() * 512,
        "steady_samples_per_s": steady_sps,
        "steady_tokens_per_s": steady_sps * 512,
        "plain_samples_per_s": plain_trainer.history.samples_per_second(),
        "window_seconds": [t for _, t in windows],
        "first_loss": losses[0], "last_loss": losses[-1],
        "first_accuracy": hist[0]["next_token_accuracy"],
        "last_accuracy": hist[-1]["next_token_accuracy"],
        "max_rel_loss_diff_vs_plain": rel,
        "adam_table_builds": trainer.optimizer._tables.builds,
        "adam_grad_pointer_uploads": trainer.optimizer._tables.grad_uploads,
        "launches": counts,
        "plain_launches": plain_counts, "caller_unchanged": unchanged,
        "losses": losses, "plain_losses": plain_losses,
    }
    log(f"train: { {k: v for k, v in res.items() if 'losses' not in k} }")
    check(len(hist) == TRAIN_STEPS and len(plain_hist) == TRAIN_STEPS,
          f"expected {TRAIN_STEPS} steps, got {len(hist)}, {len(plain_hist)}")
    check(all(np.isfinite(losses)) and all(np.isfinite(plain_losses)),
          f"a loss is not finite: {losses} {plain_losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(rel <= TRAIN_LOSS_RTOL,
          f"kernel-path losses differ from the plain path by {rel:.3e}")
    check(unchanged, "train() changed the caller's model")
    launched = {k: n for k, n in counts.items() if n}
    check(launched == expected,
          f"training did not run through the kernels: {launched} != {expected}")
    check(set(plain_counts.values()) == {0},
          f"the plain path launched a kernel: {plain_counts}")
    return res


# ------------------------------------------------------------ phases 6a, 6b


def async_runs():
    """Phase 6a's runs: (trainer, kernel-path optimizer, plain-path
    optimizer, learning rate, the fused SGD kernel expected per step)."""
    from functools import partial

    from distkeras_tpu_torch.ops.optimizers import Sgd
    from distkeras_tpu_torch.ops.pallas_kernels import FusedSGD

    def fused(nesterov):
        return partial(FusedSGD, momentum=0.9, nesterov=nesterov)

    def plain(nesterov):
        return partial(Sgd, momentum=0.9, nesterov=nesterov)

    return [
        ("DOWNPOUR", "pallas_sgd", "sgd", ASYNC_LR, "sgd_fused"),
        ("ADAG", "pallas_sgd", "sgd", ASYNC_LR, "sgd_fused"),
        ("DynSGD", fused(False), plain(False), ASYNC_LR_MOMENTUM,
         "sgd_momentum_fused"),
        ("AEASGD", fused(True), plain(True), ASYNC_LR_MOMENTUM,
         "sgd_momentum_fused"),
        # EAMSGD installs its own "sgd" with Nesterov momentum 0.9
        ("EAMSGD", "sgd", "sgd", ASYNC_LR_MOMENTUM, None),
    ]


def train_async(torch, zoo, name, optimizer, lr, ds, hooked, mode, **kw):
    """One async trainer run on a fresh d512/L8 model (seed 0), the kernel
    path (flash + LN hooks) or the plain one (``kw`` adds trainer options);
    the launch counts are set to 0 just before ``train`` and read just
    after it. Returns the trainer,
    the initial center, the seconds of ``train``, the counts and, in
    threads mode, the seconds from the threads' start to their join (after
    the warm-up window; None otherwise)."""
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = make_lm(zoo)
    if hooked:
        check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
        check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    start = dict(zip(lm._leaf_order(), lm.get_weights()))
    trainer = getattr(dk, name)(
        lm, optimizer, "next_token_crossentropy",
        metrics=["next_token_accuracy"], learning_rate=lr, batch_size=8,
        num_epoch=1, num_workers=2, communication_window=4, mode=mode,
        device_resident=True, seed=0, **kw,
    )
    spans = []
    run_threads = trainer._run_threads

    def timed_threads(*args):
        t = time.monotonic()
        run_threads(*args)
        torch.cuda.synchronize()
        spans.append(time.monotonic() - t)

    trainer._run_threads = timed_threads
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = kernels.launch_counts()
    return trainer, start, secs, counts, (spans[0] if spans else None)


def async_step_launches(steps, sgd_kernel):
    """The launches ``steps`` async training steps of the hooked model
    must make."""
    per_step = {"layernorm_fwd": 17, "layernorm_bwd": 17, "flash_fwd": 8,
                "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    if sgd_kernel is not None:
        per_step[sgd_kernel] = 1
    return {k: steps * n for k, n in per_step.items()}


def window_split(np, workers):
    """Mean pull / window / commit host seconds over every worker's
    windows."""
    return {key: float(np.mean([s[key] for w in workers for s in w.splits]))
            for key in ("pull", "window", "commit")}


def run_async_simulated(torch, np, zoo, ds):
    """Phase 6a: each async trainer in simulated mode on the kernel path,
    then on the plain path (no hooks, ``sgd`` at the same momentum).
    Returns the results and the kernel path's final centers (phase 10c
    holds its socket runs to them)."""
    out, centers = {}, {}
    for name, kopt, popt, lr, sgd_kernel in async_runs():
        runs = {}
        for path, hooked, opt in (("kernel", True, kopt),
                                  ("plain", False, popt)):
            trainer, start, secs, counts, _ = train_async(
                torch, zoo, name, opt, lr, ds, hooked, "simulated")
            ps = trainer.parameter_server
            runs[path] = {
                "losses": [r["loss"] for r in trainer.get_history()],
                "center": ps.get_params(), "num_updates": ps.num_updates,
                "tag": ps.pull()[1], "failures": trainer.failures,
                "counts": counts, "seconds": secs,
                "optimizer": type(trainer.optimizer).__name__,
                "split": window_split(np, trainer.workers),
            }
            del trainer
            torch.cuda.empty_cache()
        k, p = runs["kernel"], runs["plain"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
        center_err = max(float(np.abs(k["center"][n] - p["center"][n]).max())
                         for n in start)
        moved = max(float(np.abs(p["center"][n] - start[n]).max())
                    for n in start)
        expected = async_step_launches(ASYNC_STEPS, sgd_kernel)
        launched = {c: n for c, n in k["counts"].items() if n}
        res = {
            "learning_rate": lr, "optimizer": k["optimizer"],
            "plain_optimizer": p["optimizer"], "steps": len(k["losses"]),
            "num_updates": k["num_updates"], "max_rel_loss_diff": rel,
            "center_max_abs_err": center_err, "center_max_moved": moved,
            "launches": launched, "seconds": k["seconds"],
            "plain_seconds": p["seconds"], "first_loss": k["losses"][0],
            "last_loss": k["losses"][-1], "losses": k["losses"],
            "plain_losses": p["losses"], "window_split_s": k["split"],
        }
        log(f"async {name}: { {a: b for a, b in res.items() if 'losses' not in a} }")
        check(len(k["losses"]) == len(p["losses"]) == ASYNC_STEPS,
              f"{name}: expected {ASYNC_STEPS} steps per path")
        check(all(np.isfinite(k["losses"] + p["losses"])),
              f"{name}: a loss is not finite")
        check(k["failures"] == [] == p["failures"],
              f"{name}: worker failures {k['failures']} {p['failures']}")
        check(k["num_updates"] == p["num_updates"] == ASYNC_COMMITS,
              f"{name}: num_updates {k['num_updates']} / {p['num_updates']}")
        if name == "DynSGD":
            check(k["tag"] == k["num_updates"] and p["tag"] == p["num_updates"],
                  f"DynSGD version != num_updates: {k['tag']}, {p['tag']}")
        check(rel <= TRAIN_LOSS_RTOL,
              f"{name}: kernel-path losses differ from the plain path by {rel}")
        check(center_err <= ASYNC_CENTER_TOL,
              f"{name}: final centers differ by {center_err}")
        check(launched == expected,
              f"{name} did not run through the kernels: {launched} != {expected}")
        check(set(p["counts"].values()) == {0},
              f"{name}: the plain path launched a kernel: {p['counts']}")
        if name == "DOWNPOUR":
            # each worker's last window against its first
            ls = np.array(k["losses"]).reshape(2, 2, 4).mean(-1)
            check((ls[:, -1] < ls[:, 0]).all(),
                  f"DOWNPOUR's loss did not fall: {k['losses']}")
        out[name] = res
        centers[name] = k["center"]
    return out, centers


def run_async_threads(torch, np, zoo, ds):
    """Phase 6b: DOWNPOUR + pallas_sgd with 2 worker threads on the card:
    both commit, nothing fails, exact launches (the warm-up window
    included), one B1 table per worker; tokens/s, the per-window host
    split and the device idle share (a second run under the profiler)."""
    trainer, _, secs, counts, span = train_async(
        torch, zoo, "DOWNPOUR", "pallas_sgd", ASYNC_LR, ds, True, "threads")
    ps = trainer.parameter_server
    workers = trainer.workers
    expected = async_step_launches(ASYNC_STEPS + 4, "sgd_fused")
    launched = {c: n for c, n in counts.items() if n}
    splits = window_split(np, workers)
    tokens = ASYNC_STEPS * 8 * 512
    res = {
        "seconds": secs, "tokens_per_s": tokens / secs,
        "threads_seconds": span, "threads_tokens_per_s": tokens / span,
        "commits": {w.worker_id: len(w.splits) for w in workers},
        "num_updates": ps.num_updates, "failures": trainer.failures,
        "table_builds": trainer.optimizer._tables.builds,
        "grad_pointer_uploads": trainer.optimizer._tables.grad_uploads,
        "window_split_s": splits, "launches": launched,
        "losses": [r["loss"] for r in trainer.get_history()],
    }
    del trainer, workers
    torch.cuda.empty_cache()
    log(f"async threads: {res}")
    check(res["failures"] == [], f"worker failures: {res['failures']}")
    check(all(n > 0 for n in res["commits"].values())
          and len(res["commits"]) == 2, f"a worker did not commit: {res}")
    check(res["num_updates"] == ASYNC_COMMITS,
          f"num_updates {res['num_updates']} != {ASYNC_COMMITS}")
    check(launched == expected,
          f"threads run did not run through the kernels: {launched} != "
          f"{expected}")
    check(res["table_builds"] == 2,
          f"B1 tables built {res['table_builds']} times for 2 workers")
    check(all(np.isfinite(res["losses"])), "a loss is not finite")
    prof = device_profile(torch, lambda: train_async(
        torch, zoo, "DOWNPOUR", "pallas_sgd", ASYNC_LR, ds, True,
        "threads"), 1)
    res["device"] = prof
    if prof["device_ms"] is not None:
        busy = prof["device_ms"] / 1e3
        copies = prof["device_ms_by_category"].get("memcpy", 0.0) / 1e3
        res["device_idle_share"] = 1 - busy / secs
        res["compute_idle_share"] = 1 - (busy - copies) / secs
    log(f"async threads device: idle {res.get('device_idle_share')}, "
        f"kernels-only idle {res.get('compute_idle_share')}, "
        f"{ {k: v for k, v in prof.items() if k != 'top_kernels'} }")
    return res


# ------------------------------------------------------------------ phase 7


#: BASELINE configs 2-5 as ``benchmarks.py`` defines them at smoke scale
#: (``_cfg2``-``_cfg5``, ``_mnist_data``/``_higgs_data``/``_cifar_data``/
#: ``_imagenet_data``): trainer, zoo function and arguments, data recipe,
#: worker optimizer (the kernel path's), learning rate, batch size,
#: workers, extra trainer arguments and the compute dtype ``_shared``
#: gives an accelerator.
BASELINE = (
    {"id": 2, "trainer": "DOWNPOUR", "model": ("mnist_cnn", {}),
     "data": "mnist", "optimizer": "adam", "lr": 2.5e-4, "batch": 32,
     "workers": 8, "extra": {}, "dtype": "bfloat16"},
    {"id": 3, "trainer": "AEASGD", "model": ("higgs_mlp", {}),
     "data": "higgs", "optimizer": "sgd", "lr": 0.02, "batch": 64,
     "workers": 4, "extra": {"rho": 10.0}, "dtype": None},
    {"id": 4, "trainer": "ADAG", "model": ("cifar10_cnn",
                                           {"bn_momentum": 0.9}),
     "data": "cifar", "optimizer": "sgd", "lr": 0.05, "batch": 32,
     "workers": 4, "extra": {}, "dtype": "bfloat16"},
    {"id": 5, "trainer": "DynSGD", "model": ("resnet18", {
        "num_classes": 10, "input_shape": (64, 64, 3), "bn_momentum": 0.9}),
     "data": "imagenet", "optimizer": "adam", "lr": 1e-3, "batch": 32,
     "workers": 4, "extra": {}, "dtype": "bfloat16"},
)
BASELINE_LOSS_RTOL = 1e-3  # kernel vs plain path, per step
BASELINE_CENTER_TOL = 1e-4  # final centers, absolute
BASELINE_STATE_TOL = 1e-4  # aggregated BatchNorm buffers, absolute


def baseline_data(kind):
    """(train, test, post-transformers) of one config, the port's loaders
    and transformers with ``benchmarks.py``'s smoke-scale arguments."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.transformers import (
        LabelIndexTransformer,
        MinMaxTransformer,
        OneHotTransformer,
    )

    classes, post = 10, []
    if kind == "mnist":
        ds = loaders.synthetic_mnist(
            n=2048, seed=0, flat=False, spatial=True, protos_per_class=4,
            label_noise=0.1, noise=1.2)
    elif kind == "higgs":
        ds, classes = loaders.synthetic_higgs(n=4096, seed=1), 2
    elif kind == "cifar":
        ds = loaders.synthetic_cifar10(n=2048, seed=2, protos_per_class=3,
                                       label_noise=0.1)
    else:
        ds = loaders.synthetic_imagenet(n=768, num_classes=10, size=64,
                                        seed=3, label_noise=0.1)
        post = [LabelIndexTransformer(10)]
    if kind != "higgs":
        ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = OneHotTransformer(classes, output_col="label_onehot").transform(ds)
    train, test = ds.split(0.9, seed=7)
    return train, test, post


def plain_adam(lr):
    """The plain path's optimizer for the Adam configs: B3's plain version
    (``adam_step_plain``, plain PyTorch ops on the card) behind the
    fused-apply protocol. ``"adam"`` (optax's operation order) rounds the
    update differently from B3 on 1-4% of the elements per step, and
    these networks carry that to 2e-3 of the loss within an epoch, so it
    is run beside the two paths and its distance printed, not held to
    the bars."""
    import torch

    from distkeras_tpu_torch.ops.pallas_kernels import (
        FusedAdam,
        adam_step_plain,
    )

    class PlainFusedAdam(FusedAdam):
        def fused_apply(self, params, grads, state):
            ms, vs, step = state
            with torch.no_grad():
                adam_step_plain(params, grads, ms, vs, step,
                                self.learning_rate, self.b1, self.b2,
                                self.eps)
            return params, state

    return PlainFusedAdam(lr)


def baseline_trainer(cfg, optimizer, num_epoch=1, device=None,
                     mode="simulated", **kw):
    """One config's trainer on a fresh model (seed 0): window 4, simulated
    mode unless ``mode`` says otherwise, ``num_epoch`` epochs; ``kw`` adds
    trainer options."""
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import zoo

    name, model_kw = cfg["model"]
    model = getattr(zoo, name)(seed=0, device=device, **model_kw)
    return getattr(dk, cfg["trainer"])(
        model, optimizer, "categorical_crossentropy",
        learning_rate=cfg["lr"], batch_size=cfg["batch"],
        num_epoch=num_epoch, num_workers=cfg["workers"],
        communication_window=4, mode=mode, label_col="label_onehot",
        compute_dtype=cfg["dtype"], seed=0, device=device, **cfg["extra"],
        **kw,
    )


def train_baseline(torch, cfg, optimizer, train, **kw):
    """One config's trainer on a fresh model (seed 0) over one shuffled
    epoch (``kw`` adds trainer options); the launch counts are set to 0
    just before ``train`` and read just after. Returns the trainer, the
    result model, the seconds and the counts."""
    from distkeras_tpu_torch import kernels

    trainer = baseline_trainer(cfg, optimizer, **kw)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    result = trainer.train(train, shuffle=True)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return trainer, result, secs, kernels.launch_counts()


def warm_baseline(torch, cfg, train):
    """One untimed window of the config's model in training mode (cuDNN
    and cuBLAS load their kernels for these shapes), so that neither
    timed path pays the first use."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.optimizers import Sgd
    from distkeras_tpu_torch.utils.rng import RngSeq
    from distkeras_tpu_torch.workers import (
        WorkerCore,
        iter_windows,
        stack_window,
    )

    name, kw = cfg["model"]
    model = getattr(zoo, name)(seed=0, **kw)
    core = WorkerCore(model, Sgd(cfg["lr"]), "categorical_crossentropy",
                      compute_dtype=cfg["dtype"])
    cols = ["features", "label_onehot"]
    batches = next(iter_windows(train, cfg["batch"], cols, 4))
    xs, ys = (torch.from_numpy(a).cuda()
              for a in stack_window(batches, *cols))
    core.window(model, core.init_opt_state(list(model.parameters())),
                RngSeq(0), xs, ys)
    torch.cuda.synchronize()


def baseline_accuracy(model, test, post):
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.predictors import ModelPredictor

    pred = ModelPredictor(model, batch_size=256).predict(test)
    for t in post:
        pred = t.transform(pred)
    return AccuracyEvaluator(
        label_col="label",
        **({"prediction_col": "prediction_index"} if post else {}),
    ).evaluate(pred)


def run_distance(np, a, b):
    """Largest per-step relative loss difference, center difference and
    aggregated-buffer difference between two runs of one config."""
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    cen = max(float(np.abs(a["center"][n] - b["center"][n]).max())
              for n in b["center"])
    st = max((float(np.abs(a["buffers"][n] - b["buffers"][n]).max())
              for n in b["buffers"]), default=0.0)
    return rel, cen, st


def run_baseline(torch, np, smi):
    """Phase 7: BASELINE configs 2-5 through the async trainers, each on
    the kernel path (``pallas_adam``/``pallas_sgd``) and on the plain path
    (B3's plain version / ``sgd``) from the same seed, cuDNN
    deterministic. Per-step losses within 1e-3 relative, centers and the
    aggregated BatchNorm buffers within 1e-4, equal update counts, no
    worker failure, one B3/B1 launch per step on the kernel path and none
    on the plain one. The Adam configs also run ``"adam"``, whose distance
    is printed."""
    kernel_name = {"adam": "adam_fused", "sgd": "sgd_fused"}
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, launches, centers = {}, {}, {}
    try:
        for cfg in BASELINE:
            train, test, post = baseline_data(cfg["data"])
            warm_baseline(torch, cfg, train)
            opt = cfg["optimizer"]
            paths = [("kernel", f"pallas_{opt}"),
                     ("plain", plain_adam(cfg["lr"]) if opt == "adam"
                      else "sgd")]
            if opt == "adam":
                paths.append(("adam", "adam"))
            runs = {}
            for path, optimizer in paths:
                trainer, result, secs, counts = train_baseline(
                    torch, cfg, optimizer, train)
                ps = trainer.parameter_server
                workers = trainer.workers
                runs[path] = {
                    "losses": [r["loss"] for r in trainer.get_history()],
                    "center": ps.get_params(), "num_updates": ps.num_updates,
                    "failures": trainer.failures, "counts": counts,
                    "seconds": secs,
                    "samples_per_s": trainer.history.samples_per_second(),
                    "buffers": {n: b.detach().cpu().numpy() for n, b in
                                result.named_buffers()},
                    "split": window_split(np, workers),
                    "accuracy": baseline_accuracy(result, test, post),
                }
                del trainer, result, workers, ps
                torch.cuda.empty_cache()
            k, p = runs["kernel"], runs["plain"]
            rel, cen, st = run_distance(np, k, p)
            steps = len(k["losses"])
            kname = kernel_name[opt]
            expected = {kname: steps}
            launched = {c: n for c, n in k["counts"].items() if n}
            res = {
                "trainer": cfg["trainer"], "model": cfg["model"][0],
                "optimizer": f"pallas_{opt}", "compute_dtype": cfg["dtype"],
                "workers": cfg["workers"], "steps": steps,
                "num_updates": k["num_updates"], "max_rel_loss_diff": rel,
                "center_max_abs_err": cen, "buffers_max_abs_err": st,
                "buffers": len(k["buffers"]), "launches": launched,
                "seconds": k["seconds"], "plain_seconds": p["seconds"],
                "samples_per_s": k["samples_per_s"],
                "plain_samples_per_s": p["samples_per_s"],
                "window_split_s": k["split"], "accuracy": k["accuracy"],
                "plain_accuracy": p["accuracy"],
                "first_loss": k["losses"][0], "last_loss": k["losses"][-1],
                "losses": k["losses"], "plain_losses": p["losses"],
            }
            if "adam" in runs:
                a_rel, a_cen, a_st = run_distance(np, k, runs["adam"])
                res["vs_adam"] = {
                    "max_rel_loss_diff": a_rel, "center_max_abs_err": a_cen,
                    "buffers_max_abs_err": a_st,
                    "accuracy": runs["adam"]["accuracy"]}
            log(f"baseline config {cfg['id']}: "
                f"{ {a: b for a, b in res.items() if 'losses' not in a} }")
            log(f"baseline config {cfg['id']} ({cfg['trainer']} / "
                f"{cfg['model'][0]}): {res['samples_per_s']:.1f} samples/s, "
                f"window split {res['window_split_s']}, held-out accuracy "
                f"{res['accuracy']:.4f} on {smi}")
            tag = f"config {cfg['id']}"
            check(all(len(r["losses"]) == steps for r in runs.values())
                  and steps > 0, f"{tag}: step counts differ")
            check(all(np.isfinite(r["losses"]).all() for r in runs.values()),
                  f"{tag}: a loss is not finite")
            check(all(r["failures"] == [] for r in runs.values()),
                  f"{tag}: worker failures")
            check(len({r["num_updates"] for r in runs.values()}) == 1,
                  f"{tag}: update counts differ")
            check(rel <= BASELINE_LOSS_RTOL,
                  f"{tag}: kernel-path losses differ from the plain path "
                  f"by {rel}")
            check(cen <= BASELINE_CENTER_TOL,
                  f"{tag}: final centers differ by {cen}")
            check(st <= BASELINE_STATE_TOL,
                  f"{tag}: aggregated BatchNorm buffers differ by {st}")
            check(launched == expected,
                  f"{tag} did not run through {kname} once per step: "
                  f"{launched} != {expected}")
            check(all(set(r["counts"].values()) == {0}
                      for path, r in runs.items() if path != "kernel"),
                  f"{tag}: the plain path launched a kernel")
            out[f"config{cfg['id']}"] = res
            centers[cfg["id"]] = k["center"]
            for c, n in launched.items():
                launches[c] = launches.get(c, 0) + n
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return out, launches, centers


# ------------------------------------------------------------------ phase 8


#: what each of the resumed LM epoch's kernels is called in a profiler
#: trace (its ``__global__`` function)
TRACE_KERNELS = {"layernorm_fwd": "ln_fwd_", "layernorm_bwd": "ln_bwd_",
                 "flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                 "adam_fused": "adam_fused_kernel"}
LM_STEP_LAUNCHES = {"layernorm_fwd": 17, "layernorm_bwd": 17, "flash_fwd": 8,
                    "flash_bwd_dq": 8, "flash_bwd_dkv": 8, "adam_fused": 1}
RESUME_CONFIGS = (3, 5)  # phase 8b: AEASGD/higgs_mlp, DynSGD/resnet18


def lm_trainer(zoo, num_epoch, make=None, device=None, **kw):
    """Phase 5's trainer (``pallas_adam``, batch 8, window 4, lr 1e-3,
    seed 0, device-resident) over ``num_epoch`` epochs, on a fresh
    d512/L8 model (``make(zoo)``) with the flash and LayerNorm hooks."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.trainers import SingleTrainer

    lm = (make or make_lm)(zoo)
    attach_flash_attention(lm)
    attach_fused_layernorm(lm)
    return SingleTrainer(
        lm, "pallas_adam", "next_token_crossentropy",
        metrics=["next_token_accuracy"], batch_size=8, window=4,
        learning_rate=1e-3, seed=0, device_resident=True,
        num_epoch=num_epoch, device=device, **kw,
    )


def state_copy(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def max_distance(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.values(), b.values()))


def timed(record, fn):
    """``fn`` with the seconds of each call appended to ``record``."""
    def call(*args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        record.append(time.monotonic() - t0)
        return out
    return call


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def nondeterministic_ops(torch, trainer, ds):
    """The ops PyTorch itself flags as nondeterministic on one epoch of
    ``trainer`` (``use_deterministic_algorithms(warn_only=True)``)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train(ds, shuffle=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def trace_kernel_names(prof_dir):
    """The device kernels named in the Chrome trace(s) under ``prof_dir``."""
    names = set()
    for name in os.listdir(prof_dir):
        with open(os.path.join(prof_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        names.update(e.get("name", "") for e in events
                     if str(e.get("cat", "")).lower() == "kernel")
    return names


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_resume_lm(torch, np, zoo, ds, make=None, device=None):
    """Phase 8a: the LM trainer checkpointed after epoch 1 and resumed to
    epoch 2 in a new trainer (with ``metrics_path`` and ``profile_dir``),
    against two uninterrupted 2-epoch runs."""
    import shutil
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.utils.checkpoint import Checkpointer
    from distkeras_tpu_torch.utils.profiling import read_metrics

    steps = len(ds) // 8
    tmp = tempfile.mkdtemp(prefix="dkt_resume_lm_")
    try:
        full = []
        for _ in range(2):
            result = lm_trainer(zoo, 2, make, device).train(ds, shuffle=True)
            full.append(state_copy(result))
            del result
        runs_distance = max_distance(full[0], full[1])
        ck = os.path.join(tmp, "ck")
        first = lm_trainer(zoo, 1, make, device, checkpoint_dir=ck)
        save_s = []
        first.checkpointer.save = timed(save_s, first.checkpointer.save)
        first.train(ds, shuffle=True)
        sync(torch)
        ck_bytes = dir_bytes(ck)
        del first
        metrics, prof = os.path.join(tmp, "m.jsonl"), os.path.join(tmp, "prof")
        resumed = lm_trainer(zoo, 2, make, device, checkpoint_dir=ck,
                             metrics_path=metrics, profile_dir=prof)
        restore_s = []
        resumed._restore_latest = timed(restore_s, resumed._restore_latest)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        result = resumed.train(ds, shuffle=True, resume=True)
        sync(torch)
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
        got = state_copy(result)
        rows = read_metrics(metrics)
        traced = trace_kernel_names(prof) if device is None else None
        steps_ck = Checkpointer(ck).all_steps()
        hist = resumed.get_history()
        del result, resumed
        res = {
            "runs_distance": runs_distance,
            "resumed_distance": [max_distance(got, f) for f in full],
            "checkpoint_bytes": ck_bytes, "save_seconds": save_s,
            "restore_seconds": restore_s, "resumed_seconds": secs,
            "resumed_steps": len(hist), "checkpoint_steps": steps_ck,
            "launches": counts, "metrics_rows": [r["event"] for r in rows],
        }
        if runs_distance > 0:
            res["nondeterministic_ops"] = nondeterministic_ops(
                torch, lm_trainer(zoo, 1, make, device), ds)
        del full, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"resume lm: {res}")
    expected = {k: steps * n for k, n in LM_STEP_LAUNCHES.items()}
    launched = {k: n for k, n in counts.items() if n}
    check(res["resumed_steps"] == steps,
          f"the resumed run trained {res['resumed_steps']} steps, not {steps}")
    if runs_distance == 0:
        check(res["resumed_distance"] == [0.0, 0.0],
              "the resumed run is not bit-identical to the uninterrupted "
              f"ones: {res['resumed_distance']}")
    else:
        check(max(res["resumed_distance"]) <= runs_distance,
              f"the resumed run is {res['resumed_distance']} from the "
              f"uninterrupted ones, which are {runs_distance} apart "
              f"(nondeterministic: {res['nondeterministic_ops']})")
    check(launched == expected,
          f"the resumed epoch did not run through the kernels: {launched} "
          f"!= {expected}")
    check(res["metrics_rows"] == ["train_end"]
          and rows[0]["num_updates"] == steps,
          f"metrics rows: {res['metrics_rows']}")
    check(steps_ck == [1, 2], f"checkpoints {steps_ck}")
    if traced is not None:
        missing = [k for k, sub in TRACE_KERNELS.items()
                   if not any(sub in n for n in traced)]
        check(not missing, f"the profiler trace does not name {missing}")
    return res


def run_resume_baseline(torch, np, cfg, train, device=None):
    """Phase 8b for one BASELINE config: one epoch on the kernel path with
    ``checkpoint_dir``, then resumed to two epochs on the kernel path and,
    from a copy of the same checkpoint, on the plain path."""
    import shutil
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.utils.checkpoint import Checkpointer

    opt = cfg["optimizer"]
    kname = {"adam": "adam_fused", "sgd": "sgd_fused"}[opt]
    plain = plain_adam(cfg["lr"]) if opt == "adam" else "sgd"
    tag = f"resume config {cfg['id']}"
    tmp = tempfile.mkdtemp(prefix="dkt_resume_cfg_")
    try:
        ck = os.path.join(tmp, "ck")
        first = baseline_trainer(cfg, f"pallas_{opt}", 1, device,
                                 checkpoint_dir=ck)
        save_s = []
        first.checkpointer.save = timed(save_s, first.checkpointer.save)
        kernels.reset_launch_counts()
        first.train(train, shuffle=True)
        sync(torch)
        first_counts = kernels.launch_counts()
        ck_bytes = dir_bytes(ck)
        ps = first.parameter_server
        n1, steps1 = ps.num_updates, len(first.get_history())
        # the checkpoint holds the first run's end state, bit for bit
        _, trees, meta = Checkpointer(ck).restore()
        center = ps.get_params()
        center_equal = all(np.array_equal(trees["center"][n], center[n])
                           for n in center)
        replicas_equal = buffers_equal = True
        for w in first.workers:
            snap = trees["workers"][str(w.worker_id)]
            replicas_equal &= int(snap["seq"]) == w._seq and all(
                np.array_equal(snap["params"][n], p.detach().cpu().numpy())
                for n, p in zip(w._names, w._params))
            buffers_equal &= all(
                np.array_equal(snap["state"][n], b.detach().cpu().numpy())
                for n, b in w._model.named_buffers())
        n_buffers = len(dict(first.workers[0]._model.named_buffers()))
        saved_version = meta["ps_meta"].get("version")
        del first, ps, trees
        shutil.copytree(ck, os.path.join(tmp, "ck_plain"))
        runs = {}
        for path, optimizer, d in (("kernel", f"pallas_{opt}", ck),
                                   ("plain", plain,
                                    os.path.join(tmp, "ck_plain"))):
            t = baseline_trainer(cfg, optimizer, 2, device, checkpoint_dir=d)
            restore_s = []
            t._restore_latest = timed(restore_s, t._restore_latest)
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            result = t.train(train, shuffle=True, resume=True)
            sync(torch)
            secs = time.monotonic() - t0
            ps = t.parameter_server
            runs[path] = {
                "counts": kernels.launch_counts(), "seconds": secs,
                "restore_seconds": restore_s,
                "losses": [r["loss"] for r in t.get_history()],
                "num_updates": ps.num_updates,
                "num_duplicates": ps.num_duplicates,
                "version": ps._meta.get("version"),
                "start_seqs": [w._start_seq for w in t.workers],
                "restored": all(w._restore_point is not None
                                for w in t.workers),
                "failures": t.failures, "center": ps.get_params(),
                "buffers": {n: b.detach().cpu().numpy()
                            for n, b in result.named_buffers()},
            }
            del t, result, ps
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k, p = runs["kernel"], runs["plain"]
    rel, cen, st = run_distance(np, k, p)
    res = {
        "trainer": cfg["trainer"], "model": cfg["model"][0],
        "first_updates": n1, "first_steps": steps1,
        "checkpoint_bytes": ck_bytes, "save_seconds": save_s,
        "first_launches": {c: n for c, n in first_counts.items() if n},
        "center_roundtrip_bit_equal": center_equal,
        "replicas_roundtrip_bit_equal": replicas_equal,
        "buffers_roundtrip_bit_equal": buffers_equal, "buffers": n_buffers,
        "saved_version": saved_version,
        **{f"{path}_{key}": r[key] for path, r in runs.items()
           for key in ("num_updates", "num_duplicates", "version",
                       "start_seqs", "restored", "seconds",
                       "restore_seconds")},
        "resumed_steps": len(k["losses"]),
        "launches": {c: n for c, n in k["counts"].items() if n},
        "plain_launches": {c: n for c, n in p["counts"].items() if n},
        "max_rel_loss_diff": rel, "center_max_abs_err": cen,
        "buffers_max_abs_err": st,
    }
    log(f"{tag}: {res}")
    check(first_counts == {**{c: 0 for c in first_counts}, kname: steps1},
          f"{tag}: the first epoch did not launch {kname} once per step")
    check(center_equal and replicas_equal and buffers_equal,
          f"{tag}: the checkpoint does not round-trip bit for bit")
    for path, r in runs.items():
        check(r["num_updates"] == 2 * n1 and r["num_duplicates"] == 0,
              f"{tag} ({path}): {r['num_updates']} updates after the "
              f"resume, not exactly twice {n1}")
        check(r["restored"] and all(s > 0 for s in r["start_seqs"]),
              f"{tag} ({path}): workers not restored: {r['start_seqs']}")
        check(r["failures"] == [], f"{tag} ({path}): {r['failures']}")
        if cfg["trainer"] == "DynSGD":
            check(saved_version == n1 and r["version"] == 2 * n1,
                  f"{tag} ({path}): DynSGD version {saved_version} -> "
                  f"{r['version']}, not {n1} -> {2 * n1}")
    check(len(k["losses"]) == len(p["losses"]) > 0,
          f"{tag}: resumed step counts differ")
    check(res["launches"] == {kname: len(k["losses"])},
          f"{tag}: the resumed kernel path did not launch {kname} once per "
          f"step: {res['launches']}")
    check(res["plain_launches"] == {},
          f"{tag}: the plain path launched {res['plain_launches']}")
    check(rel <= BASELINE_LOSS_RTOL and cen <= BASELINE_CENTER_TOL
          and st <= BASELINE_STATE_TOL,
          f"{tag}: kernel and plain resumes differ: losses {rel}, center "
          f"{cen}, buffers {st}")
    return res


def run_resume(torch, np, zoo, ds):
    """Phase 8: 8a (the LM) and 8b (configs 3 and 5, cuDNN
    deterministic); returns the results and the launches of the resumed
    runs on the kernel path."""
    lm = run_resume_lm(torch, np, zoo, ds)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"lm": lm}
    try:
        for cfg in BASELINE:
            if cfg["id"] in RESUME_CONFIGS:
                train, _, _ = baseline_data(cfg["data"])
                out[f"config{cfg['id']}"] = run_resume_baseline(
                    torch, np, cfg, train)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    launches = {}
    for r in out.values():
        for c, n in r["launches"].items():
            launches[c] = launches.get(c, 0) + n
    return out, launches


# ------------------------------------------------------------------ phase 9


#: vmapped vs threaded member training, per step and on the weights: the
#: phase 7 bars (the two paths run the same per-member arithmetic; the
#: Averaging mean sums in another order on the host than on the card)
MEMBER_LOSS_RTOL = 1e-3
MEMBER_WEIGHT_TOL = 1e-4
#: phase 9b's runs: (trainer, config whose model/data/optimizer it takes,
#: member count, epochs)
MEMBER_RUNS = (("EnsembleTrainer", 2, 4, 1), ("AveragingTrainer", 3, 4, 2))


def stream_prep(chunk):
    """Config 5's preprocessing per loaded shard (``StreamingDataset.map``):
    the phase 7 transformers on the chunk's uint8 pixels."""
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.data.transformers import (
        MinMaxTransformer,
        OneHotTransformer,
    )

    ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(Dataset(chunk))
    ds = OneHotTransformer(10, output_col="label_onehot").transform(ds)
    return {k: ds[k] for k in ds.columns}


def write_config5_shards(np, out_dir, shards=4):
    """Config 5's smoke training rows (phase 7's split of
    ``synthetic_imagenet`` 64 x 64, 768 rows) written with ``ShardWriter``
    as ``examples/imagenet_resnet.py`` writes them: uint8 pixels, one
    shard per chunk."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.streaming import ShardWriter

    raw = loaders.synthetic_imagenet(n=768, num_classes=10, size=64, seed=3,
                                     label_noise=0.1)
    train, _ = raw.split(0.9, seed=7)
    bounds = np.linspace(0, len(train), shards + 1).astype(int)
    with ShardWriter(out_dir) as writer:
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            writer.add({"features": train["features"][lo:hi].astype(np.uint8),
                        "label": train["label"][lo:hi]})
    return len(train)


def path_runs(torch, np, make, paths):
    """Run ``make(optimizer)`` -> (trainer, train thunk) on each
    (path, optimizer); the launch counts set to 0 just before each train
    and read just after."""
    from distkeras_tpu_torch import kernels

    runs = {}
    for path, optimizer in paths:
        trainer, go = make(optimizer)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        result = go()
        sync(torch)
        runs[path] = {
            "trainer": trainer, "result": result,
            "seconds": time.monotonic() - t0,
            "counts": {c: n for c, n in kernels.launch_counts().items()
                       if n},
            "samples_per_s": trainer.history.samples_per_second(),
        }
    return runs


def add_counts(total, counts):
    """Add one run's launch counts into ``total``."""
    for c, n in counts.items():
        total[c] = total.get(c, 0) + n
    return total


def model_state(result):
    """(weights by leaf-order name, buffers) of a trained model."""
    return ({n: w for n, w in zip(result._leaf_order(), result.get_weights())},
            {n: b.detach().cpu().numpy() for n, b in result.named_buffers()})


def history_distance(np, a, b, members=1):
    """Largest per-step relative loss difference, member by member."""
    worst = 0.0
    for i in range(members):
        ha = [r["loss"] for r in a.get_history(i if members > 1 else None)]
        hb = [r["loss"] for r in b.get_history(i if members > 1 else None)]
        check(len(ha) == len(hb) > 0, "step counts differ between paths")
        worst = max(worst, max(abs(x - y) / abs(y) for x, y in zip(ha, hb)))
    return worst


def models_distance(np, a, b):
    """Largest weight and buffer difference over lists of models."""
    wd = bd = 0.0
    for x, y in zip(a, b, strict=True):
        (wx, bx), (wy, by) = model_state(x), model_state(y)
        wd = max(wd, max(float(np.abs(wx[n] - wy[n]).max()) for n in wy))
        bd = max([bd] + [float(np.abs(bx[n] - by[n]).max()) for n in by])
    return wd, bd


def run_streaming(torch, np, smi, phase7):
    """9a: config 5 from shards (DynSGD/``resnet18``, kernel and plain
    path, phase 7's bars), the same shards through ``SingleTrainer`` with
    prefetch 2 and 0 (bit-identical), and config 6 through the native CSV
    reader."""
    import shutil
    import tempfile

    from distkeras_tpu_torch.data import native
    from distkeras_tpu_torch.data.streaming import open_shards

    cfg = next(c for c in BASELINE if c["id"] == 5)
    tmp = tempfile.mkdtemp(prefix="dkt_shards_")
    out = {}
    try:
        rows = write_config5_shards(np, tmp)
        stream = open_shards(tmp).map(stream_prep)
        check(len(stream) == rows and len(stream._paths) == 4,
              f"config 5 shards: {len(stream)} rows in "
              f"{len(stream._paths)} shards")

        def dynsgd(optimizer):
            t = baseline_trainer(cfg, optimizer)
            return t, lambda: t.train(stream, shuffle=True)

        runs = path_runs(torch, np, dynsgd,
                         (("kernel", "pallas_adam"),
                          ("plain", plain_adam(cfg["lr"]))))
        k, p = runs["kernel"], runs["plain"]
        kt, pt = k["trainer"], p["trainer"]
        steps = len(kt.get_history())
        rel = history_distance(np, kt, pt)
        (kw, kb), (pw, pb) = model_state(k["result"]), model_state(p["result"])
        cen = max(float(np.abs(kw[n] - pw[n]).max()) for n in pw)
        st = max(float(np.abs(kb[n] - pb[n]).max()) for n in pb)
        res = {
            "shards": 4, "rows": rows, "steps": steps,
            "num_updates": kt.parameter_server.num_updates,
            "max_rel_loss_diff": rel, "center_max_abs_err": cen,
            "buffers_max_abs_err": st, "launches": k["counts"],
            "samples_per_s": k["samples_per_s"],
            "plain_samples_per_s": p["samples_per_s"],
            "in_memory_samples_per_s": phase7["samples_per_s"],
            "seconds": k["seconds"],
        }
        log(f"stream config 5: {res}")
        log(f"stream config 5 (DynSGD / resnet18 from 4 shards): "
            f"{res['samples_per_s']:.1f} samples/s streamed against "
            f"{res['in_memory_samples_per_s']:.1f} in memory (phase 7) on "
            f"{smi}")
        check(kt.failures == [] and pt.failures == [],
              "stream config 5: worker failures")
        check(kt.parameter_server.num_updates
              == pt.parameter_server.num_updates == 8,
              "stream config 5: not 8 commits on both paths")
        check(rel <= BASELINE_LOSS_RTOL and cen <= BASELINE_CENTER_TOL
              and st <= BASELINE_STATE_TOL,
              f"stream config 5: kernel and plain paths differ: losses "
              f"{rel}, center {cen}, buffers {st}")
        check(k["counts"] == {"adam_fused": steps} and p["counts"] == {},
              f"stream config 5: launches {k['counts']} / {p['counts']}")
        out["config5"] = res
        launches = dict(k["counts"])

        # the same shards through SingleTrainer's prefetcher
        from distkeras_tpu_torch.models import zoo
        from distkeras_tpu_torch.trainers import SingleTrainer

        def single(prefetch):
            name, kw = cfg["model"]
            t = SingleTrainer(
                getattr(zoo, name)(seed=0, **kw), "pallas_adam",
                "categorical_crossentropy", learning_rate=cfg["lr"],
                batch_size=cfg["batch"], window=4, prefetch=prefetch,
                label_col="label_onehot", compute_dtype=cfg["dtype"], seed=0)
            return t, lambda: t.train(stream, shuffle=True)

        runs = path_runs(torch, np, single, (("prefetch2", 2),
                                             ("prefetch0", 0)))
        a, b = runs["prefetch2"], runs["prefetch0"]
        wd, bd = models_distance(np, [a["result"]], [b["result"]])
        sres = {"steps": len(a["trainer"].get_history()),
                "launches": a["counts"], "samples_per_s": a["samples_per_s"],
                "prefetch0_samples_per_s": b["samples_per_s"],
                "weights_max_abs_err": wd, "buffers_max_abs_err": bd}
        log(f"stream single trainer: {sres}")
        check(wd == 0 and bd == 0 and a["counts"] == b["counts"]
              == {"adam_fused": sres["steps"]},
              f"stream single trainer: prefetch 2 and 0 differ: {sres}")
        out["single_prefetch"] = sres
        add_counts(launches, a["counts"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # config 6: the real digits through the native reader
    import csv as csvmod

    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.transformers import (
        MinMaxTransformer,
        OneHotTransformer,
    )

    check(native.available(), "the native data library did not build")
    path = os.path.join(HERE, "distkeras_tpu_torch", "data", "digits.csv")
    t0 = time.monotonic()
    parsed, had_header = native.read_csv(path)
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    with open(path, newline="") as f:
        reader = csvmod.reader(f)
        next(reader)
        python = np.asarray([[float(v) for v in row] for row in reader],
                            np.float32)
    python_s = time.monotonic() - t0
    check(had_header and parsed.dtype == python.dtype
          and np.array_equal(parsed, python),
          "digits.csv: the native parse differs from the csv module's")
    ds = MinMaxTransformer(0, 1, o_min=0, o_max=16)(loaders.digits(flat=True))
    ds = OneHotTransformer(10, output_col="label_onehot")(ds)
    train, test = ds.split(0.9, seed=7)

    def digits(optimizer):
        from distkeras_tpu_torch.models import zoo
        from distkeras_tpu_torch.trainers import SingleTrainer

        t = SingleTrainer(zoo.digits_mlp(seed=0), optimizer,
                          "categorical_crossentropy", learning_rate=1e-3,
                          batch_size=32, label_col="label_onehot", seed=0)
        return t, lambda: t.train(train, shuffle=True)

    runs = path_runs(torch, np, digits, (("kernel", "pallas_adam"),
                                         ("plain", plain_adam(1e-3))))
    k, p = runs["kernel"], runs["plain"]
    steps = len(k["trainer"].get_history())
    rel = history_distance(np, k["trainer"], p["trainer"])
    wd, _ = models_distance(np, [k["result"]], [p["result"]])
    dres = {"rows": int(parsed.shape[0]), "native_parse_s": native_s,
            "csv_module_parse_s": python_s, "steps": steps,
            "launches": k["counts"], "max_rel_loss_diff": rel,
            "weights_max_abs_err": wd,
            "accuracy": baseline_accuracy(k["result"], test, []),
            "samples_per_s": k["samples_per_s"]}
    log(f"config 6 (digits_mlp, native CSV): {dres} on {smi}")
    check(rel <= BASELINE_LOSS_RTOL and wd <= BASELINE_CENTER_TOL,
          f"config 6: kernel and plain paths differ: {rel}, {wd}")
    check(k["counts"] == {"adam_fused": steps} and p["counts"] == {},
          f"config 6: launches {k['counts']} / {p['counts']}")
    out["config6"] = dres
    return out, add_counts(launches, k["counts"])


def member_trainer(cfg, cls_name, members, epochs, optimizer, vmapped,
                   **kw):
    """A member trainer over config ``cfg``'s model (seed 0), optimizer
    settings, batch and compute dtype, window 4."""
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import zoo

    name, model_kw = cfg["model"]
    count = ("num_models" if cls_name == "EnsembleTrainer"
             else "num_workers")
    return getattr(dk, cls_name)(
        getattr(zoo, name)(seed=0, **model_kw), optimizer,
        "categorical_crossentropy", learning_rate=cfg["lr"],
        batch_size=cfg["batch"], num_epoch=epochs, window=4,
        label_col="label_onehot", compute_dtype=cfg["dtype"], seed=0,
        vmapped=vmapped, **{count: members}, **kw)


def run_members(torch, np, smi):
    """9b: ``EnsembleTrainer`` (config 2's ``mnist_cnn``, ``pallas_adam``)
    and ``AveragingTrainer`` (config 3's ``higgs_mlp``, ``pallas_sgd``),
    each threaded and vmapped, each on the kernel and the plain path."""
    out, launches = {}, {}
    for cls_name, cfg_id, members, epochs in MEMBER_RUNS:
        cfg = next(c for c in BASELINE if c["id"] == cfg_id)
        train, _, _ = baseline_data(cfg["data"])
        opt = cfg["optimizer"]
        kname = {"adam": "adam_fused", "sgd": "sgd_fused"}[opt]
        plain = plain_adam(cfg["lr"]) if opt == "adam" else "sgd"
        runs = {}
        for mode, vmapped in (("threaded", False), ("vmapped", True)):
            def make(optimizer, vmapped=vmapped):
                t = member_trainer(cfg, cls_name, members, epochs, optimizer,
                                   vmapped)
                return t, lambda: t.train(train, shuffle=True)

            for path, r in path_runs(torch, np, make,
                                     (("kernel", f"pallas_{opt}"),
                                      ("plain", plain))).items():
                runs[f"{mode}_{path}"] = r
        ensemble = cls_name == "EnsembleTrainer"

        def models(r):
            return r["result"] if ensemble else [r["result"]]

        steps = len(runs["vmapped_kernel"]["trainer"].get_history(0))
        res = {"trainer": cls_name, "model": cfg["model"][0],
               "members": members, "epochs": epochs, "optimizer":
               f"pallas_{opt}", "steps_per_member": steps}
        for a, b, tag in (("threaded_kernel", "threaded_plain", "threaded"),
                          ("vmapped_kernel", "vmapped_plain", "vmapped"),
                          ("vmapped_kernel", "threaded_kernel",
                           "vmapped_vs_threaded")):
            rel = history_distance(np, runs[a]["trainer"], runs[b]["trainer"],
                                   members)
            wd, bd = models_distance(np, models(runs[a]), models(runs[b]))
            res[tag] = {"max_rel_loss_diff": rel, "weights_max_abs_err": wd,
                        "buffers_max_abs_err": bd}
            check(rel <= MEMBER_LOSS_RTOL and wd <= MEMBER_WEIGHT_TOL
                  and bd <= BASELINE_STATE_TOL,
                  f"{cls_name} {tag}: losses {rel}, weights {wd}, "
                  f"buffers {bd}")
        for name, r in runs.items():
            res[f"{name}_samples_per_s"] = r["samples_per_s"]
            res[f"{name}_seconds"] = r["seconds"]
            res[f"{name}_launches"] = r["counts"]
        expected = {"vmapped_kernel": {kname: steps},
                    "threaded_kernel": {kname: members * steps},
                    "vmapped_plain": {}, "threaded_plain": {}}
        for name, want in expected.items():
            check(runs[name]["counts"] == want,
                  f"{cls_name} {name}: launches {runs[name]['counts']} != "
                  f"{want}")
        log(f"members {cls_name}: {res}")
        log(f"members {cls_name} ({members} x {cfg['model'][0]}): vmapped "
            f"{res['vmapped_kernel_samples_per_s']:.1f} samples/s, threaded "
            f"{res['threaded_kernel_samples_per_s']:.1f} on {smi}")
        out[cls_name] = res
        for name in ("vmapped_kernel", "threaded_kernel"):
            add_counts(launches, runs[name]["counts"])
        del runs
        torch.cuda.empty_cache()
    return out, launches


def run_member_lm(torch, np, zoo, ds, smi):
    """9c: ``EnsembleTrainer(vmapped=True)``, 2 d512/L8 members with the
    flash and LayerNorm hooks and ``pallas_adam``, batch 8 x 512, one
    window of 4 joint steps, against the same run with no hooks and B3's
    plain version."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.trainers import EnsembleTrainer

    data = ds.take(64)  # 2 members x 4 batches of 8

    def make(optimizer):
        lm = make_lm(zoo)
        if optimizer == "pallas_adam":
            attach_flash_attention(lm)
            attach_fused_layernorm(lm)
        t = EnsembleTrainer(
            lm, optimizer, "next_token_crossentropy",
            metrics=["next_token_accuracy"], batch_size=8, window=4,
            num_models=2, vmapped=True, learning_rate=1e-3, seed=0)
        return t, lambda: t.train(data)

    runs = path_runs(torch, np, make, (("kernel", "pallas_adam"),
                                       ("plain", plain_adam(1e-3))))
    k, p = runs["kernel"], runs["plain"]
    rel = history_distance(np, k["trainer"], p["trainer"], 2)
    steps = len(k["trainer"].get_history(0))
    expected = {c: 2 * steps * n for c, n in LM_STEP_LAUNCHES.items()}
    expected["adam_fused"] = steps
    losses = [r["loss"] for r in k["trainer"].get_history()]
    # the joint windows' own time (the train() wall above also holds the
    # two members' builds): per member dt / 2, so the sum is the joint time
    window_s = sum(dt for _, dt in k["trainer"].history.get_timings())
    res = {"members": 2, "steps_per_member": steps,
           "window_seconds": window_s,
           "window_tokens_per_s": 2 * steps * 8 * 512 / window_s,
           "max_rel_loss_diff": rel, "launches": k["counts"],
           "plain_launches": p["counts"], "seconds": k["seconds"],
           "plain_seconds": p["seconds"],
           "tokens_per_s": k["samples_per_s"] * 512,
           "plain_tokens_per_s": p["samples_per_s"] * 512,
           "losses": losses}
    log(f"member LM: {res} on {smi}")
    check(steps == 4 and np.isfinite(losses).all(),
          f"member LM: {steps} steps, losses {losses}")
    check(rel <= TRAIN_LOSS_RTOL,
          f"member LM: kernel and plain paths differ by {rel}")
    check(k["counts"] == expected and p["counts"] == {},
          f"member LM: launches {k['counts']} != {expected} (plain "
          f"{p['counts']})")
    del runs
    torch.cuda.empty_cache()
    return res, dict(k["counts"])


def payload_bytes(tree):
    """Bytes of the arrays in a (nested) commit payload."""
    if isinstance(tree, dict):
        return sum(payload_bytes(v) for v in tree.values())
    import numpy as np

    return int(np.asarray(tree).nbytes)


def counting_commits(ps_cls, record):
    """Patch ``ps_cls.commit`` to add each payload's bytes to ``record``;
    returns the original for restoring."""
    orig = ps_cls.commit

    def commit(self, delta, *args, **kw):
        record.append(payload_bytes(delta))
        return orig(self, delta, *args, **kw)

    ps_cls.commit = commit
    return orig


#: phase 9d: (config, compression options)
COMPRESSED = ((2, {"compress": "int8", "pull_compress": "bfloat16"}),
              (3, {"compress": "topk:0.05"}))


def run_compressed(torch, np, smi):
    """9d: configs 2 and 3 with compressed commits (and config 2 with bf16
    pulls) in simulated mode, kernel and plain path, beside the
    uncompressed kernel run's commit bytes; then config 2's compressed
    checkpoint and resume."""
    from distkeras_tpu_torch.parameter_servers import ParameterServer

    out, launches = {}, {}
    for cfg_id, comp in COMPRESSED:
        cfg = next(c for c in BASELINE if c["id"] == cfg_id)
        train, _, _ = baseline_data(cfg["data"])
        opt = cfg["optimizer"]
        kname = {"adam": "adam_fused", "sgd": "sgd_fused"}[opt]
        plain = plain_adam(cfg["lr"]) if opt == "adam" else "sgd"
        sizes = {}

        def make(spec):
            path, optimizer, kw = spec
            t = baseline_trainer(cfg, optimizer, **kw)
            record = sizes.setdefault(path, [])

            def go():
                orig = counting_commits(ParameterServer, record)
                try:
                    return t.train(train, shuffle=True)
                finally:
                    ParameterServer.commit = orig
            return t, go

        specs = (("kernel", ("kernel", f"pallas_{opt}", comp)),
                 ("plain", ("plain", plain, comp)),
                 ("raw", ("raw", f"pallas_{opt}", {})))
        runs = path_runs(torch, np, make, specs)
        k, p, r = runs["kernel"], runs["plain"], runs["raw"]
        rel = history_distance(np, k["trainer"], p["trainer"])
        (kw, kb), (pw, pb) = model_state(k["result"]), model_state(p["result"])
        cen = max(float(np.abs(kw[n] - pw[n]).max()) for n in pw)
        st = max([0.0] + [float(np.abs(kb[n] - pb[n]).max()) for n in pb])
        raw_rel = history_distance(np, k["trainer"], r["trainer"])
        steps = len(k["trainer"].get_history())
        commits = k["trainer"].parameter_server.num_updates
        res = {"trainer": cfg["trainer"], "model": cfg["model"][0], **comp,
               "steps": steps, "num_updates": commits,
               "max_rel_loss_diff": rel, "center_max_abs_err": cen,
               "buffers_max_abs_err": st,
               "commit_bytes_per_window": float(np.mean(sizes["kernel"])),
               "raw_commit_bytes_per_window": float(np.mean(sizes["raw"])),
               "vs_uncompressed_max_rel_loss_diff": raw_rel,
               "launches": k["counts"], "samples_per_s": k["samples_per_s"],
               "raw_samples_per_s": r["samples_per_s"],
               "last_loss": k["trainer"].get_history()[-1]["loss"],
               "raw_last_loss": r["trainer"].get_history()[-1]["loss"]}
        res["commit_bytes_ratio"] = (res["raw_commit_bytes_per_window"]
                                     / res["commit_bytes_per_window"])
        log(f"compressed config {cfg_id}: {res}")
        log(f"compressed config {cfg_id} ({comp}): "
            f"{res['commit_bytes_per_window']:.0f} commit bytes per window "
            f"against {res['raw_commit_bytes_per_window']:.0f} uncompressed "
            f"({res['commit_bytes_ratio']:.2f}x fewer) on {smi}")
        tag = f"compressed config {cfg_id}"
        check(all(x["trainer"].failures == [] for x in runs.values()),
              f"{tag}: worker failures")
        check(len(sizes["kernel"]) == len(sizes["plain"]) == commits
              == p["trainer"].parameter_server.num_updates > 0,
              f"{tag}: commit counts differ")
        check(rel <= BASELINE_LOSS_RTOL and cen <= BASELINE_CENTER_TOL
              and st <= BASELINE_STATE_TOL,
              f"{tag}: kernel and plain paths differ: losses {rel}, center "
              f"{cen}, buffers {st}")
        check(k["counts"] == {kname: steps} and p["counts"] == {},
              f"{tag}: launches {k['counts']} / {p['counts']}")
        check(res["commit_bytes_ratio"] > (3.0 if comp["compress"] == "int8"
                                           else 4.0),
              f"{tag}: commits only {res['commit_bytes_ratio']:.2f}x "
              "smaller")
        out[f"config{cfg_id}"] = res
        for run in (k, r):
            add_counts(launches, run["counts"])
        del runs
        torch.cuda.empty_cache()
    resume, resume_launches = run_compressed_resume(torch, np)
    out["resume"] = resume
    return out, add_counts(launches, resume_launches)


def run_compressed_resume(torch, np):
    """9d's checkpoint: config 2 compressed, one epoch with
    ``checkpoint_dir`` — every worker's ``q_residual`` in the checkpoint,
    bit-equal to the live one — then resumed to two epochs on the kernel
    and, from a copy, the plain path under phase 8b's contract (twice the
    commits, every worker restored with its residual, the two resumes
    within phase 7's bars). Then the same with one worker, whose simulated
    schedule is the same resumed or not: the resumed run must be
    bit-identical to an uninterrupted two-epoch run."""
    import shutil
    import tempfile

    from distkeras_tpu_torch.utils.checkpoint import Checkpointer

    cfg = next(c for c in BASELINE if c["id"] == 2)
    comp = dict(COMPRESSED)[2]
    train, _, _ = baseline_data(cfg["data"])
    plain = plain_adam(cfg["lr"])
    tag = "compressed resume config 2"
    tmp = tempfile.mkdtemp(prefix="dkt_resume_q8_")
    try:
        ck = os.path.join(tmp, "ck")
        first = baseline_trainer(cfg, "pallas_adam", 1, checkpoint_dir=ck,
                                 **comp)
        first.train(train, shuffle=True)
        sync(torch)
        n1 = first.parameter_server.num_updates
        _, trees, _ = Checkpointer(ck).restore()
        residuals_equal = all(
            set(trees["workers"][str(w.worker_id)]["q_residual"])
            == set(w._q_residual) and all(
                np.array_equal(
                    trees["workers"][str(w.worker_id)]["q_residual"][n], v)
                for n, v in w._q_residual.items())
            for w in first.workers)
        nonzero = all(any(np.abs(v).max() > 0 for v in w._q_residual.values())
                      for w in first.workers)
        del first, trees
        shutil.copytree(ck, os.path.join(tmp, "ck_plain"))

        def resumed(spec):
            optimizer, d = spec
            t = baseline_trainer(cfg, optimizer, 2, checkpoint_dir=d, **comp)
            return t, lambda: t.train(train, shuffle=True, resume=True)

        runs = path_runs(torch, np, resumed,
                         (("kernel", ("pallas_adam", ck)),
                          ("plain", (plain, os.path.join(tmp, "ck_plain")))))
        k, p = runs["kernel"], runs["plain"]
        rel = history_distance(np, k["trainer"], p["trainer"])
        wd, bd = models_distance(np, [k["result"]], [p["result"]])
        steps = len(k["trainer"].get_history())

        # one worker: resumed against uninterrupted, bit for bit
        one = {**cfg, "workers": 1}
        whole = baseline_trainer(one, "pallas_adam", 2, **comp)
        a = whole.train(train, shuffle=True)
        ck1 = os.path.join(tmp, "one")
        baseline_trainer(one, "pallas_adam", 1, checkpoint_dir=ck1,
                         **comp).train(train, shuffle=True)
        again = baseline_trainer(one, "pallas_adam", 2, checkpoint_dir=ck1,
                                 **comp)
        b = again.train(train, shuffle=True, resume=True)
        sync(torch)
        one_w, one_b = models_distance(np, [a], [b])
        tail = [r["loss"] for r in whole.get_history()]
        tail = tail[len(tail) - len(again.get_history()):]
        one_losses_equal = tail == [r["loss"] for r in again.get_history()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"first_updates": n1, "residuals_roundtrip_bit_equal":
           residuals_equal, "residuals_nonzero": nonzero,
           "resumed_steps": steps,
           **{f"{path}_{key}": val for path, r in runs.items()
              for key, val in (
                  ("num_updates", r["trainer"].parameter_server.num_updates),
                  ("num_duplicates",
                   r["trainer"].parameter_server.num_duplicates),
                  ("restored", all(w._restore_point is not None
                                   and w._start_seq > 0
                                   and w._q_residual is not None
                                   for w in r["trainer"].workers)))},
           "launches": k["counts"], "plain_launches": p["counts"],
           "max_rel_loss_diff": rel, "weights_max_abs_err": wd,
           "buffers_max_abs_err": bd,
           "one_worker_resumed_vs_uninterrupted": {
               "losses_equal": one_losses_equal, "weights_max_abs_err": one_w,
               "buffers_max_abs_err": one_b,
               "resumed_steps": len(again.get_history())}}
    log(f"{tag}: {res}")
    check(residuals_equal and nonzero,
          f"{tag}: the checkpoint does not carry every worker's residual")
    for path, r in runs.items():
        ps = r["trainer"].parameter_server
        check(ps.num_updates == 2 * n1 and ps.num_duplicates == 0,
              f"{tag} ({path}): {ps.num_updates} updates, not 2 x {n1}")
        check(res[f"{path}_restored"] and r["trainer"].failures == [],
              f"{tag} ({path}): workers not restored with their residual")
    check(rel <= BASELINE_LOSS_RTOL and wd <= BASELINE_CENTER_TOL
          and bd <= BASELINE_STATE_TOL,
          f"{tag}: kernel and plain resumes differ: {rel}, {wd}, {bd}")
    check(k["counts"] == {"adam_fused": steps} and p["counts"] == {},
          f"{tag}: launches {k['counts']} / {p['counts']}")
    check(one_losses_equal and one_w == 0 and one_b == 0,
          f"{tag}: one worker's resumed run is not bit-identical to the "
          f"uninterrupted one: {res['one_worker_resumed_vs_uninterrupted']}")
    return res, dict(k["counts"])


def run_phase9(torch, np, zoo, ds, smi, baseline):
    """Phase 9 (9a-9d), cuDNN deterministic as in phases 7 and 8b; returns
    the results and the kernel launches of its main-path runs."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, launches = {}, {}
    subphases = (
        ("9a", "streaming",
         lambda: run_streaming(torch, np, smi, baseline["config5"])),
        ("9b", "members", lambda: run_members(torch, np, smi)),
        ("9c", "member_lm", lambda: run_member_lm(torch, np, zoo, ds, smi)),
        ("9d", "compressed", lambda: run_compressed(torch, np, smi)),
    )
    try:
        for label, key, fn in subphases:
            t0 = time.monotonic()
            out[key], counts = fn()
            out[key]["seconds_total"] = time.monotonic() - t0
            log(f"phase {label} ({key}) in {out[key]['seconds_total']:.1f} s")
            add_counts(launches, counts)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return out, launches


# ----------------------------------------------------------------- phase 10


#: phase 10b's parameter-server process: a port ``SocketParameterServer``
#: over the center in the file argv[1], on a loopback port it prints, until
#: a client sends the stop action (or an hour passes)
PS_PROCESS = """
import sys
from distkeras_tpu_torch.parameter_servers import (
    DeltaParameterServer, SocketParameterServer)
from distkeras_tpu_torch.utils.serialization import load_params
srv = SocketParameterServer(DeltaParameterServer(load_params(sys.argv[1])),
                            host="127.0.0.1")
srv.start()
print(srv.port, flush=True)
srv.ps.stopped.wait(3600)
srv.stop()
"""


def wire_per_op(workers):
    """Bytes per pull and per commit the workers' socket clients moved (both
    directions: action byte, length prefixes, frames, status byte)."""
    out = {}
    for verb in ("pull", "commit"):
        nbytes = sum(w.ps.wire_bytes[verb] for w in workers)
        ops = sum(w.ps.wire_ops[verb] for w in workers)
        out[verb] = nbytes / ops if ops else None
    return out


def centers_equal(np, a, b):
    return a.keys() == b.keys() and all(
        a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n]) for n in a)


def run_remote_config2(torch, np, smi, phase7, center7):
    """10a: config 2 as in phase 7's kernel path, with ``remote_ps=True``:
    every pull and commit crosses a loopback socket. The center must be
    phase 7's bit for bit, 16 commits, 56 B3 launches."""
    cfg = next(c for c in BASELINE if c["id"] == 2)
    train, _, _ = baseline_data(cfg["data"])
    trainer, _, secs, counts = train_baseline(
        torch, cfg, "pallas_adam", train, remote_ps=True)
    ps = trainer.parameter_server
    launched = {c: n for c, n in counts.items() if n}
    res = {
        "num_updates": ps.num_updates, "failures": trainer.failures,
        "center_bit_equal_phase7": centers_equal(np, ps.get_params(),
                                                 center7),
        "launches": launched, "seconds": secs,
        "samples_per_s": trainer.history.samples_per_second(),
        "phase7_samples_per_s": phase7["samples_per_s"],
        "wire_bytes_per": wire_per_op(trainer.workers),
        "window_split_s": window_split(np, trainer.workers),
        "phase7_window_split_s": phase7["window_split_s"],
    }
    log(f"remote config 2: {res}")
    log(f"remote config 2: {res['samples_per_s']:.1f} samples/s over the "
        f"socket against {res['phase7_samples_per_s']:.1f} in process "
        f"(phase 7); wire bytes per pull / commit "
        f"{res['wire_bytes_per']['pull']:.0f} / "
        f"{res['wire_bytes_per']['commit']:.0f} on {smi}")
    check(res["failures"] == [], f"10a: worker failures {res['failures']}")
    check(res["num_updates"] == 16, f"10a: {res['num_updates']} commits")
    check(res["center_bit_equal_phase7"],
          "10a: the remote_ps center differs from phase 7's")
    check(launched == {"adam_fused": 56},
          f"10a: launches {launched} != 56 of adam_fused")
    return res, launched


def run_ps_process(torch, np, smi):
    """10b: the parameter server in its own OS process, as dist-keras runs
    it apart from its Spark executors. A second process (CUDA hidden)
    hosts a port ``SocketParameterServer`` over config 2's initial center;
    this process runs one DOWNPOUR worker's windows on the card against it
    through ``RemoteParameterServerClient``. The center read back over the
    wire must be bit for bit the one-worker in-process simulated run's."""
    import select
    import shutil
    import socket
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.parameter_servers import (
        RemoteParameterServerClient,
    )
    from distkeras_tpu_torch.utils.device import local_devices
    from distkeras_tpu_torch.utils.serialization import save_params

    cfg = dict(next(c for c in BASELINE if c["id"] == 2), workers=1)
    train, _, _ = baseline_data(cfg["data"])
    ref = baseline_trainer(cfg, "pallas_adam")
    start = dict(zip(ref.model._leaf_order(), ref.model.get_weights()))
    ref.train(train, shuffle=True)
    want = ref.parameter_server.get_params()
    trainer = baseline_trainer(cfg, "pallas_adam")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    proc = None
    try:
        path = os.path.join(tmp, "center.dkt")
        save_params(path, start)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [HERE] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        proc = subprocess.Popen([sys.executable, "-c", PS_PROCESS, path],
                                stdout=subprocess.PIPE, env=env, cwd=HERE,
                                text=True)
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        check(ready, "10b: the parameter-server process did not start")
        port = int(proc.stdout.readline())
        client = RemoteParameterServerClient("127.0.0.1", port)
        # the trainer's own worker template, its PS the remote client
        trainer.parameter_server = client
        worker = trainer.allocate_worker(trainer._make_core(), 0,
                                         local_devices(trainer.device)[0])
        part = train.shuffle(trainer.seed).partition(1)[0]
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        worker.train(part, trainer.batch_size, num_epoch=1,
                     shuffle_seed=trainer.seed)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = {c: n for c, n in kernels.launch_counts().items() if n}
        got, _ = client.pull()
        res = {
            "center_bit_equal_in_process": centers_equal(np, got, want),
            "commits": len(worker.splits),
            "in_process_commits": ref.parameter_server.num_updates,
            "launches": counts, "seconds": secs,
            "steps": len(worker.records),
            "wire_bytes_per": wire_per_op([worker]),
            "window_split_s": window_split(np, [worker]),
            "ps_pid": proc.pid,
        }
        client.close()
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"s")  # the stop action
        res["ps_exit_code"] = proc.wait(timeout=60)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"ps process config 2: {res}")
    log(f"ps process config 2: one worker on the card, the PS in process "
        f"{res['ps_pid']}: {res['commits']} commits in "
        f"{res['seconds']:.2f} s, window split {res['window_split_s']} "
        f"on {smi}")
    check(res["center_bit_equal_in_process"],
          "10b: the center over the wire differs from the in-process run's")
    check(res["commits"] == res["in_process_commits"] > 0,
          f"10b: {res['commits']} commits against "
          f"{res['in_process_commits']}")
    check(counts == {"adam_fused": res["steps"]},
          f"10b: launches {counts} for {res['steps']} steps")
    check(res["ps_exit_code"] == 0,
          f"10b: the PS process exited with {res['ps_exit_code']}")
    return res, counts


def remote_lm_runs():
    """Phase 10c's socket runs of phase 6a's trainers: (trainer,
    kernel-path optimizer, learning rate, fused SGD kernel, compression
    options)."""
    return [(name, kopt, lr, kname, {})
            for name, kopt, _, lr, kname in async_runs()
            if name in ("DOWNPOUR", "DynSGD")] + [
        ("DOWNPOUR", "pallas_sgd", ASYNC_LR, "sgd_fused",
         {"compress": "int8", "pull_compress": "bfloat16"})]


def wire_breakdown(np, center, reps=3):
    """Host seconds (best of ``reps``) of what one uncompressed pull of
    ``center`` costs on each side of a loopback socket: the in-process
    pull's copy, the DKT1 encode, the loopback transfer of the frame
    (``networking.send_data`` to ``recv_data``) and the decode."""
    import socket
    import threading

    from distkeras_tpu_torch import networking
    from distkeras_tpu_torch.utils.serialization import (
        deserialize_params,
        serialize_params,
    )

    def best(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return min(times), out

    copy_s, _ = best(lambda: {k: np.copy(v) for k, v in center.items()})
    encode_s, blob = best(lambda: serialize_params(center))
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    sender = networking.connect("127.0.0.1", listener.getsockname()[1],
                                timeout=30)
    receiver, _ = listener.accept()
    try:
        def transfer():
            got = {}
            t = threading.Thread(
                target=lambda: got.update(data=networking.recv_data(
                    receiver)))
            t.start()
            networking.send_data(sender, blob)
            t.join(timeout=60)
            return got["data"]

        loopback_s, data = best(transfer)
    finally:
        for sock in (sender, receiver, listener):
            sock.close()
    decode_s, _ = best(lambda: deserialize_params(data))
    return {"bytes": len(blob), "copy": copy_s, "encode": encode_s,
            "loopback": loopback_s, "decode": decode_s}


def run_remote_lm(torch, np, zoo, ds, smi, phase6a, centers6a):
    """10c: phase 6a's hooked d512/L8 DOWNPOUR (B1) and DynSGD (B2) with
    ``remote_ps=True``: centers bit-identical to phase 6a's in-process
    runs, launches exactly 16 x (17, 17, 8, 8, 8) of B7/B8/B4/B5/B6 plus 16
    of B1/B2; then DOWNPOUR with int8 commits and bf16 pulls over the
    socket on the kernel path and on the plain path (no hooks, ``sgd``,
    the same compression), per-step losses within 1e-3 relative of each
    other (the distance to phase 6a's uncompressed plain path, which the
    bf16 pulls move by about bf16's rounding, is printed). Prints wire
    bytes per pull/commit, the window split beside the in-process run's
    and where an uncompressed pull's host time goes."""
    out, launches = {}, {}
    for name, opt, lr, kname, comp in remote_lm_runs():
        key = name + ("_int8_bf16" if comp else "")
        trainer, _, secs, counts, _ = train_async(
            torch, zoo, name, opt, lr, ds, True, "simulated",
            remote_ps=True, **comp)
        ps = trainer.parameter_server
        losses = [r["loss"] for r in trainer.get_history()]
        launched = {c: n for c, n in counts.items() if n}
        ref = phase6a[name]
        res = {
            "num_updates": ps.num_updates, "failures": trainer.failures,
            "steps": len(losses), "launches": launched, "seconds": secs,
            "in_process_seconds": ref["seconds"],
            "wire_bytes_per": wire_per_op(trainer.workers),
            "window_split_s": window_split(np, trainer.workers),
            "in_process_window_split_s": ref["window_split_s"],
        }
        if comp:
            del trainer
            torch.cuda.empty_cache()
            trainer, _, _, pcounts, _ = train_async(
                torch, zoo, name, "sgd", lr, ds, False, "simulated",
                remote_ps=True, **comp)
            plain = [r["loss"] for r in trainer.get_history()]
            res.update(comp)
            res["plain_launches"] = {c: n for c, n in pcounts.items() if n}
            res["max_rel_loss_diff_vs_plain"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses, plain))
            res["max_rel_loss_diff_vs_uncompressed_plain"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses,
                                                    ref["plain_losses"]))
        else:
            res["center_bit_equal_phase6a"] = centers_equal(
                np, ps.get_params(), centers6a[name])
            res["losses_equal_phase6a"] = losses == ref["losses"]
        del trainer, ps
        torch.cuda.empty_cache()
        log(f"remote lm {key}: {res}")
        log(f"remote lm {key}: wire bytes per pull / commit "
            f"{res['wire_bytes_per']['pull']:.0f} / "
            f"{res['wire_bytes_per']['commit']:.0f}; window split "
            f"{res['window_split_s']} over the socket against "
            f"{res['in_process_window_split_s']} in process on {smi}")
        tag = f"10c {key}"
        check(res["failures"] == [], f"{tag}: worker failures")
        check(res["num_updates"] == ASYNC_COMMITS
              and res["steps"] == ASYNC_STEPS,
              f"{tag}: {res['num_updates']} commits, {res['steps']} steps")
        check(all(np.isfinite(losses)), f"{tag}: a loss is not finite")
        check(launched == async_step_launches(ASYNC_STEPS, kname),
              f"{tag}: launches {launched}")
        if comp:
            check(res["max_rel_loss_diff_vs_plain"] <= TRAIN_LOSS_RTOL,
                  f"{tag}: losses differ from the plain path by "
                  f"{res['max_rel_loss_diff_vs_plain']}")
            check(res["plain_launches"] == {},
                  f"{tag}: the plain path launched {res['plain_launches']}")
        else:
            check(res["center_bit_equal_phase6a"]
                  and res["losses_equal_phase6a"],
                  f"{tag}: the remote_ps run differs from phase 6a's")
        out[key] = res
        add_counts(launches, launched)
    out["wire_breakdown_s"] = wire_breakdown(np, centers6a["DOWNPOUR"])
    log(f"remote lm: one uncompressed pull's host seconds "
        f"{out['wire_breakdown_s']} on {smi}")
    return out, launches


def failover_run(torch, cfg, train, kill_at=None):
    """Config ``cfg`` in threads mode with ``remote_ps``, a warm standby
    and ``worker_retries=2``; ``kill_at``: kill the primary once it has
    applied that many commits. Returns the trainer, the launch counts,
    the seconds and the kill instant (``time.monotonic``)."""
    import threading

    from distkeras_tpu_torch import kernels

    trainer = baseline_trainer(cfg, "pallas_sgd", mode="threads",
                               remote_ps=True, standby=True,
                               worker_retries=2)
    killed = {}

    def killer():
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and "done" not in killed:
            svc = trainer.service
            if (svc is not None and not svc.killed
                    and trainer.parameter_server.num_updates >= kill_at):
                # stamped before the call: the standby may promote
                # before kill() returns
                killed["at"] = time.monotonic()
                svc.kill()
                return
            time.sleep(0.001)

    thread = None
    if kill_at is not None:
        thread = threading.Thread(target=killer, daemon=True)
        thread.start()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    try:
        trainer.train(train, shuffle=True)
        torch.cuda.synchronize()
    finally:
        killed["done"] = True
        if thread is not None:
            thread.join(timeout=10)
    secs = time.monotonic() - t0
    counts = {c: n for c, n in kernels.launch_counts().items() if n}
    return trainer, counts, secs, killed.get("at")


def run_failover(torch, np, smi):
    """10d: config 3 (AEASGD, ``higgs_mlp``, 4 workers, ``pallas_sgd``) in
    threads with ``remote_ps``, a warm standby and ``worker_retries=2``,
    unfaulted and with the primary killed at half the expected commits.
    The faulted run must finish with exactly one promotion
    (``primary-lost``), at least one client failover, a post-mortem bundle,
    and the unfaulted run's commit ledger (update count, every worker's
    last commit seq)."""
    cfg = next(c for c in BASELINE if c["id"] == 3)
    train, _, _ = baseline_data(cfg["data"])
    expected = 16
    runs = {}
    for label, kill_at in (("unfaulted", None), ("faulted", expected // 2)):
        trainer, counts, secs, kill = failover_run(torch, cfg, train,
                                                   kill_at)
        ps = trainer.active_parameter_server()
        sb = trainer.standby_service
        runs[label] = {
            "ledger": {"num_updates": ps.num_updates,
                       "seen_seq": {str(k): int(v) for k, v in
                                    sorted(ps._seen_seq.items())}},
            "num_duplicates": ps.num_duplicates,
            "promotions": list(trainer.ps_promotions),
            "failovers": trainer.ps_failovers,
            "failures": list(trainer.failures), "launches": counts,
            "seconds": secs,
            "kill_to_promotion_s": (None if kill is None or not sb.promoted
                                    else sb.promoted_at - kill),
            "postmortem": (None if sb.last_postmortem is None else
                           {k: sb.last_postmortem[k] for k in
                            ("reason", "detail")}),
            "center_finite": all(np.isfinite(v).all()
                                 for v in ps.get_params().values()),
        }
        del trainer, ps, sb
    clean, fault = runs["unfaulted"], runs["faulted"]
    res = {**runs, "ledgers_equal": clean["ledger"] == fault["ledger"]}
    log(f"failover config 3: {res}")
    log(f"failover config 3: kill -> promotion "
        f"{fault['kill_to_promotion_s']} s, {fault['failovers']} client "
        f"failovers, B1 launches {clean['launches']} unfaulted / "
        f"{fault['launches']} faulted on {smi}")
    check(clean["promotions"] == [] and clean["failures"] == []
          and clean["ledger"]["num_updates"] == expected,
          f"10d: the unfaulted run {clean}")
    check(clean["launches"] == {"sgd_fused": 60},
          f"10d: unfaulted launches {clean['launches']} != 56 steps + the "
          "4-step warm-up of sgd_fused")
    check(fault["kill_to_promotion_s"] is not None,
          "10d: the primary was not killed, or the standby never promoted")
    check(len(fault["promotions"]) == 1
          and fault["promotions"][0]["reason"] == "primary-lost",
          f"10d: promotions {fault['promotions']}")
    check(fault["failovers"] >= 1, "10d: no client failed over")
    check(res["ledgers_equal"],
          f"10d: ledgers differ: {clean['ledger']} != {fault['ledger']}")
    check(fault["postmortem"] is not None
          and fault["postmortem"]["reason"] == "promotion",
          "10d: no promotion post-mortem bundle")
    check(clean["center_finite"] and fault["center_finite"],
          "10d: a center is not finite")
    check(fault["launches"].get("sgd_fused", 0) >= 60,
          f"10d: faulted launches {fault['launches']}")
    launches = add_counts(dict(clean["launches"]), fault["launches"])
    return res, launches


def run_phase10(torch, np, zoo, ds, smi, phase7, centers7, phase6a,
                centers6a):
    """Phase 10 (10a-10d), the socket parameter-server tier on the card,
    cuDNN deterministic as in phase 7; returns the results and the kernel
    launches of its main-path runs."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, launches = {}, {}
    subphases = (
        ("10a", "remote_config2", lambda: run_remote_config2(
            torch, np, smi, phase7["config2"], centers7[2])),
        ("10b", "ps_process", lambda: run_ps_process(torch, np, smi)),
        ("10c", "remote_lm", lambda: run_remote_lm(
            torch, np, zoo, ds, smi, phase6a, centers6a)),
        ("10d", "failover", lambda: run_failover(torch, np, smi)),
    )
    try:
        for label, key, fn in subphases:
            t0 = time.monotonic()
            out[key], counts = fn()
            out[key]["seconds_total"] = time.monotonic() - t0
            log(f"phase {label} ({key}) in {out[key]['seconds_total']:.1f} s")
            add_counts(launches, counts)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return out, launches


# ----------------------------------------------------------------- phase 11


def quantiles_ms(np, xs):
    if not xs:
        return {"p50": None, "p99": None}
    arr = np.asarray(xs) * 1e3
    return {"p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99))}


def fan_out(jobs, threads):
    """Run ``jobs`` (callables) on ``threads`` threads, round-robin, one
    ``ServingClient`` per thread as a user fans out; returns the results
    in job order and raises the first failure."""
    import threading

    out = [None] * len(jobs)
    errs = []

    def work(t):
        try:
            for j in range(t, len(jobs), threads):
                out[j] = jobs[j]()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ths = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
    if errs:
        raise errs[0]
    check(not any(th.is_alive() for th in ths), "a client thread hung")
    return out


def run_wire_generate(torch, np, lm, smi, gen, gen_reqs, gen_outs):
    """11a, 11b and 11e on one LN-hooked 8-slot engine behind a
    ``ServingServer``: phase 4's mix from 8 client threads, four of it
    streamed, then the obs verbs and a ``stop`` that drains a request
    still in flight."""
    import threading

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.obs import parse_prometheus, timeline_complete
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingEngine,
        ServingServer,
    )

    detach_hooks(lm)
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    # request 0 comes three times (11a, 11b, 11e): no prefix store, so the
    # third is not a host-ladder hit and the replies stay phase 4's path
    eng = ServingEngine(lm, num_slots=8, prefix_cache=False)
    srv = ServingServer(eng).start()
    clients = [ServingClient(srv.host, srv.port, timeout=600,
                             connect_timeout=2) for _ in range(8)]
    res = {}
    try:
        eng._stepper.warmup()
        # 11a: the 16-request mix over the wire
        jobs = [
            (lambda c, p=p, n=n, s=s: c.generate(p, n, sampling=s))
            for p, n, s in gen_reqs
        ]
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        outs = fan_out([
            (lambda j=j: jobs[j](clients[j % 8])) for j in range(len(jobs))
        ], 8)
        secs = time.monotonic() - t0
        counts_a = kernels.launch_counts()
        check(all(np.array_equal(a, b) for a, b in zip(outs, gen_outs)),
              "11a: a wire reply differs from phase 4's in-process output")
        check(counts_a["layernorm_fwd"] > 0 and counts_a["flash_fwd"] == 0,
              f"11a: wire generate did not run through the LN kernel "
              f"alone: {counts_a}")
        n_tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, gen_reqs))
        res["generate"] = {
            "requests": len(outs), "tokens": n_tokens, "seconds": secs,
            "tokens_per_s": n_tokens / secs,
            "in_process_tokens_per_s": gen["tokens_per_s"],
            "launches": counts_a,
        }
        log(f"11a wire generate: {len(outs)} requests from 8 client "
            f"threads, {n_tokens / secs:.1f} tokens/s over the wire vs "
            f"{gen['tokens_per_s']:.1f} in process (phase 4), all equal "
            f"to phase 4's outputs, launches {counts_a} on {smi}")
        # 11b: four of the mix streamed, from four threads
        picks = [0, 1, 2, 3]  # request 3 is sampled

        def stream(j):
            p, n, s = gen_reqs[j]
            st = clients[j].generate_stream(p, n, sampling=s)
            chunks = list(st)
            return st, chunks

        kernels.reset_launch_counts()
        streams = fan_out([(lambda j=j: stream(j)) for j in picks], 4)
        counts_b = kernels.launch_counts()
        gaps = []
        for j, (st, chunks) in zip(picks, streams):
            full = np.concatenate([gen_reqs[j][0], *chunks])
            check(np.array_equal(full, gen_outs[j])
                  and np.array_equal(st.sequence, gen_outs[j]),
                  f"11b: streamed chunks of request {j} differ from the "
                  f"unstreamed sequence")
            gaps += st.inter_token_s
        ttft = [st.ttft_s for st, _ in streams]
        res["stream"] = {
            "requests": picks, "chunks": [len(c) for _, c in streams],
            "ttft_ms": [t * 1e3 for t in ttft],
            "inter_chunk_ms": quantiles_ms(np, gaps), "launches": counts_b,
        }
        log(f"11b streams: TTFT {[round(t * 1e3, 3) for t in ttft]} ms, "
            f"inter-chunk p50/p99 {res['stream']['inter_chunk_ms']} ms "
            f"(host clock) on {smi}")
        # 11e: a traced generate, the obs verbs, stop draining work
        c = clients[0]
        p, n, _ = gen_reqs[0]
        traced = c.generate(p, n, trace=True)
        spans = c.last_trace["spans"]
        names = {sp["name"] for sp in spans}
        check(np.array_equal(traced, gen_outs[0])
              and timeline_complete(spans)
              and {"serving.queue", "serving.prefill", "serving.decode",
                   "server.generate"} <= names,
              f"11e: traced timeline incomplete: {sorted(names)}")
        samples = c.metrics()
        prom = parse_prometheus(c.metrics(prometheus=True))
        ts = c.timeseries(window=60)
        health, stats = c.health(), c.stats()
        check(any(x["name"] == "serving_scheduler_completed"
                  and x["value"] >= 21 for x in samples)
              and any(name == "serving_scheduler_completed_total"
                      for name, _, _ in prom)
              and ts["ok"] and health["status"] == "serving"
              and stats["open_connections"] == len(clients),
              "11e: the metrics/timeseries/health/stats verbs misanswered")
        for cl in clients[2:]:
            cl.close()  # idle connections would hold the drain's grace
        long_p = np.arange(16, dtype=np.int32)
        held = {}

        def long_generate():
            held["out"] = clients[1].generate(long_p, 256)

        th = threading.Thread(target=long_generate)
        th.start()
        deadline = time.monotonic() + 60
        while (eng.stats()["active_slots"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.001)
        t_stop = time.monotonic()
        check(c.stop()["stopping"], "11e: stop was not acknowledged")
        th.join(timeout=120)
        srv.shutdown()
        drain_s = time.monotonic() - t_stop
        check("out" in held and len(held["out"]) == 16 + 256,
              "11e: stop did not drain the request in flight")
        res["obs"] = {
            "spans": sorted(names), "metrics_samples": len(samples),
            "prometheus_lines": len(prom),
            "timeseries_series": len(ts["series"]),
            "stop_drain_s": drain_s,
        }
        log(f"11e obs: timeline {sorted(names)}, {len(samples)} metric "
            f"samples, {len(prom)} Prometheus lines, {len(ts['series'])} "
            f"series; stop drained a 256-token request in {drain_s:.3f} s "
            f"on {smi}")
    finally:
        for cl in clients:
            cl.close()
        srv.shutdown()
    detach_hooks(lm)
    return res, [counts_a, counts_b]


def run_wire_predict(torch, np, lm, smi, pred):
    """11c: phase 3's batch through a flash+LN-hooked engine, in process
    and over the wire; bit-equal, one forward's launches, and the host
    split of the wire call."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingEngine,
        ServingServer,
    )

    detach_hooks(lm)
    check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    eng = ServingEngine(lm, num_slots=8)
    srv = ServingServer(eng).start()
    try:
        x = np.random.default_rng(3).integers(0, 8192, (8, 512)).astype(np.int32)
        eng.predict(x[:1], timeout=600)
        t0 = time.monotonic()
        y_in = eng.predict(x, timeout=600)
        in_s = time.monotonic() - t0
        with ServingClient(srv.host, srv.port, timeout=600,
                           connect_timeout=2) as c:
            c.predict(x[:1])
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            y = c.predict(x)
            wire_s = time.monotonic() - t0
            counts = kernels.launch_counts()
    finally:
        srv.shutdown()
    detach_hooks(lm)
    check(y.shape == (8, 512, 8192) and y.dtype == np.float32,
          f"11c: wire predict malformed: {y.shape} {y.dtype}")
    check(np.array_equal(y, y_in),
          "11c: wire predict differs from the in-process predict")
    check({k: n for k, n in counts.items() if n}
          == {"layernorm_fwd": 17, "flash_fwd": 8},
          f"11c: wire predict did not run one hooked forward: {counts}")
    split = wire_breakdown(np, {"prediction": y_in}, reps=1)
    res = {
        "seconds": wire_s, "in_process_seconds": in_s,
        "phase3_seconds": pred["seconds"], "reply_bytes": split["bytes"],
        "host_split_s": {k: split[k] for k in ("encode", "loopback",
                                               "decode")},
        "launches": counts,
    }
    log(f"11c wire predict: 8x512 -> {y.shape} ({y.nbytes} bytes) in "
        f"{wire_s:.3f} s vs {in_s:.3f} s in process ({pred['seconds']:.3f} "
        f"s in phase 3), bit-equal, launches {counts}; host split of the "
        f"{split['bytes']}-byte reply: encode {split['encode']:.3f} s, "
        f"loopback {split['loopback']:.3f} s, decode {split['decode']:.3f} "
        f"s on {smi}")
    return res, counts


def run_wire_bundle(torch, np, lm, smi, gen_reqs):
    """11d: ``quantize_model`` -> ``save_serving_bundle`` ->
    ``ServingEngine.from_bundle`` on the card; greedy generate over the
    wire against an in-process ``CachedSequenceGenerator`` on the
    quantized model."""
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.quantization import (
        count_quantized,
        quantize_model,
    )
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingEngine,
        ServingServer,
    )
    from distkeras_tpu_torch.utils.serialization import (
        save_serving_bundle,
        serialize_model,
    )

    detach_hooks(lm)
    f32_bytes = len(serialize_model(lm))
    greedy = [r for r in gen_reqs if r[2] is None][:4]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm_int8.dkt")
        t0 = time.monotonic()
        save_serving_bundle(path, quantize_model(lm.copy()))
        save_s = time.monotonic() - t0
        bundle_bytes = os.path.getsize(path)
        t0 = time.monotonic()
        eng = ServingEngine.from_bundle(path, num_slots=8)
        load_s = time.monotonic() - t0
    model = eng.model
    check(count_quantized(model) == 8 * 4 + 8 * 2 + 1,
          f"11d: {count_quantized(model)} quantized weights")
    check(attach_fused_layernorm(model) == 17, "LN hook not on 17 norms")
    srv = ServingServer(eng).start()
    clients = [ServingClient(srv.host, srv.port, timeout=600,
                             connect_timeout=2) for _ in range(4)]
    try:
        eng._stepper.warmup()
        kernels.reset_launch_counts()
        outs = fan_out([
            (lambda j=j: clients[j].generate(greedy[j][0], greedy[j][1]))
            for j in range(len(greedy))
        ], 4)
        counts = kernels.launch_counts()
    finally:
        for cl in clients:
            cl.close()
        srv.shutdown()
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"11d: bundle generate did not run through the LN kernel: {counts}")
    solo = CachedSequenceGenerator(model)
    for (p, n, _), o in zip(greedy, outs):
        check(np.array_equal(o, solo.generate(p[None], n)[0]),
              "11d: a bundle-served decode differs from the quantized solo "
              "decode")
    res = {"bundle_bytes": bundle_bytes, "f32_model_bytes": f32_bytes,
           "ratio": f32_bytes / bundle_bytes, "save_s": save_s,
           "load_s": load_s, "requests": len(outs), "launches": counts}
    log(f"11d int8 bundle: {bundle_bytes} bytes vs {f32_bytes} for "
        f"serialize_model's f32 frame ({f32_bytes / bundle_bytes:.2f}x), "
        f"saved in {save_s:.3f} s, booted in {load_s:.3f} s; "
        f"{len(outs)} greedy wire decodes equal the quantized solo decode, "
        f"launches {counts} on {smi}")
    return res, counts


def run_phase11(torch, np, lm, smi, pred, gen, gen_reqs, gen_outs):
    """Phase 11, the serving TCP front on the card; returns the results
    and the launch counts of each subphase's main path."""
    out = {}
    t0 = time.monotonic()
    out["wire_generate"], counts = run_wire_generate(
        torch, np, lm, smi, gen, gen_reqs, gen_outs)
    out["wire_predict"], c_pred = run_wire_predict(torch, np, lm, smi, pred)
    out["bundle"], c_bundle = run_wire_bundle(torch, np, lm, smi, gen_reqs)
    out["seconds_total"] = time.monotonic() - t0
    return out, [*counts, c_pred, c_bundle]


# ----------------------------------------------------------------- phase 12

#: phase 12's cache bank: 8 blocks x (K, V) x 8 slots x 512 positions x 8
#: heads x 64 x 4 bytes
BANK_BYTES = 8 * 2 * 8 * 512 * 8 * 64 * 4


def hooked_engine(lm, **kw):
    """Phase 4's engine: the LN-hooked d512/L8 LM on 8 slots, warmed."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import ServingEngine

    detach_hooks(lm)
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    eng = ServingEngine(lm, num_slots=8, **kw).start()
    eng._stepper.warmup()
    return eng


def serve_mix(eng, reqs):
    """Submit ``reqs`` at once, wait for every reply; returns (replies or
    the error each raised, seconds)."""
    t0 = time.monotonic()
    handles = [eng.submit(p, n, sampling=s) for p, n, s in reqs]
    outs = []
    for h in handles:
        try:
            outs.append(eng.wait(h, timeout=600))
        except Exception as e:  # noqa: BLE001 — the caller checks each
            outs.append(e)
    return outs, time.monotonic() - t0


def bubble_ms(np, eng):
    hist = eng.batcher.overlap_ledger.bubble
    return {q: (None if hist.quantile(v) is None else hist.quantile(v) * 1e3)
            for q, v in (("p50", 0.5), ("p99", 0.99))}


def run_loop_ab(torch, np, lm, smi, gen_reqs, gen_outs):
    """12a: phase 4's mix on a fresh sequential or overlapped engine, in
    turns (``ab_turns``), so both modes see the same card state. A fresh
    engine per run: the overlap ledger measures iteration wall collect to
    collect, so an idle gap between two runs on one engine would count as
    bubble. 12d reads the compile ledger
    of the last overlapped engine."""
    from distkeras_tpu_torch import kernels

    runs = {False: [], True: []}
    counts_all = []
    keep = None
    try:
        for overlap in ab_turns(False, True):
            eng = hooked_engine(lm, overlap=overlap)
            try:
                kernels.reset_launch_counts()
                outs, secs = serve_mix(eng, gen_reqs)
                counts = kernels.launch_counts()
                led = eng.batcher.overlap_ledger
                run = {"iterations": led.iterations,
                       "overlap_efficiency": led.efficiency,
                       "bubble_ms": bubble_ms(np, eng)}
            finally:
                if overlap and keep is None:
                    keep = eng
                else:
                    eng.stop()
            check(all(isinstance(o, np.ndarray) and np.array_equal(o, w)
                      for o, w in zip(outs, gen_outs)),
                  f"12a: a reply under overlap={overlap} differs from "
                  f"phase 4's")
            check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
                  f"12a: overlap={overlap} did not run through B7 alone: "
                  f"{counts}")
            tokens = sum(len(o) - len(p)
                         for o, (p, _, _) in zip(outs, gen_reqs))
            run.update(tokens=tokens, seconds=secs,
                       tokens_per_s=tokens / secs,
                       b7_per_token=counts["layernorm_fwd"] / tokens)
            runs[overlap].append(run)
            counts_all.append(counts)
    except BaseException:
        if keep is not None:
            keep.stop()
        raise
    res = {}
    for overlap, rs in runs.items():
        res["overlap" if overlap else "sequential"] = {
            "runs": rs,
            "tokens_per_s": sum(x["tokens_per_s"] for x in rs) / len(rs),
        }
        log(f"12a overlap={overlap}: "
            f"{[round(x['tokens_per_s'], 1) for x in rs]} tokens/s, "
            f"overlap efficiency {[x['overlap_efficiency'] for x in rs]}, "
            f"bubble p50/p99 {[x['bubble_ms'] for x in rs]} ms, "
            f"{[round(x['b7_per_token'], 3) for x in rs]} B7 launches per "
            f"token, every reply equal to phase 4's on {smi}")
    # 12d: the ledger after 12a, then the warm set and a storm-free rerun
    eng = keep
    try:
        before = eng.compile_ledger.snapshot()
        mints = eng.compile_ledger.mints()
        t0 = time.monotonic()
        eng._stepper.warm_prefill_buckets()
        warm_s = time.monotonic() - t0
        eng.compile_ledger.mark_warmed()
        kernels.reset_launch_counts()
        outs, _ = serve_mix(eng, gen_reqs)
        counts = kernels.launch_counts()
        after = eng.compile_ledger.snapshot()
    finally:
        eng.stop()
    check(all(isinstance(o, np.ndarray) and np.array_equal(o, w)
              for o, w in zip(outs, gen_outs)),
          "12d: a reply after mark_warmed differs from phase 4's")
    check(after["storms"] == 0,
          f"12d: {after['storms']} compile storms after mark_warmed: "
          f"{after['recent']}")
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"12d: the rerun did not run through B7 alone: {counts}")
    counts_all.append(counts)
    res["compiles"] = {
        "after_12a": {k: before[k] for k in ("total", "warmup", "serving",
                                              "seconds")},
        "keys": [(m["key"], m["trigger"], m["seconds"]) for m in mints],
        "warm_prefill_buckets_s": warm_s,
        "after_mark_warmed": {k: after[k] for k in ("total", "warmup",
                                                     "serving", "storms")},
    }
    log(f"12d compile ledger: after 12a {res['compiles']['after_12a']}, "
        f"mints {res['compiles']['keys']}; warm_prefill_buckets "
        f"{warm_s:.3f} s; after mark_warmed and the mix again "
        f"{res['compiles']['after_mark_warmed']} on {smi}")
    return res, counts_all


def run_poison(torch, np, lm, smi, gen_reqs, gen_outs):
    """12b: 15 of the mix and a poison request whose slot makes every
    step raise, in both loop modes; then a failed admission."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.obs import TraceContext
    from distkeras_tpu_torch.serving import InternalError

    res, counts_all = {}, []
    poison_prompt = np.arange(64, dtype=np.int32) % 8192
    for overlap in (False, True):
        eng = hooked_engine(lm, overlap=overlap)
        try:
            bad = None

            def poisoned(ctx):
                slots = eng.batcher._slots  # the scheduler thread's own
                return any(r is bad and ctx["active"][i]
                           for i, r in enumerate(slots))

            plan = FaultPlan().arm("stepper.step", times=None, when=poisoned)
            kernels.reset_launch_counts()
            with plan:
                t0 = time.monotonic()
                handles = [eng.submit(p, n, sampling=s)
                           for p, n, s in gen_reqs[:15]]
                # submitted last: the newest admission, the prime suspect
                bad = eng.submit(poison_prompt, 32, trace=TraceContext.new())
                outs = [eng.wait(h, timeout=600) for h in handles]
                try:
                    eng.wait(bad, timeout=600)
                    failed = None
                except InternalError as e:
                    failed = str(e)
                secs = time.monotonic() - t0
            counts = kernels.launch_counts()
            stats = eng.stats()
            health = eng.health()
        finally:
            eng.stop()
        check(failed is not None and "blamed" in failed,
              f"12b: the poison request did not fail blamed: {failed}")
        check(all(np.array_equal(o, w) for o, w in zip(outs, gen_outs[:15])),
              f"12b: a survivor differs from phase 4's (overlap={overlap})")
        check(stats["quarantines"] == 1 and stats["internal_errors"] == 1
              and health["status"] == "serving",
              f"12b: poison books wrong: {stats['quarantines']} quarantines,"
              f" {stats['internal_errors']} internal, {health['status']}")
        check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
              f"12b: did not run through B7 alone: {counts}")
        blame = [ev for ev in bad.events if ev["name"] == "scheduler.blame"]
        r = {
            "quarantines": stats["quarantines"],
            "blame_probes": stats["blame_probes"],
            "step_failures": stats["step_failures"],
            "probe_wall_ms": sum((ev["t1"] - ev["t0"]) for ev in blame) * 1e3,
            "seconds": secs, "fired": plan.fired("stepper.step"),
            "launches": counts,
        }
        res["overlap" if overlap else "sequential"] = r
        counts_all.append(counts)
        log(f"12b poison overlap={overlap}: failed typed, 15 survivors equal "
            f"phase 4's; quarantines {r['quarantines']}, blame probes "
            f"{r['blame_probes']}, failed step + probes "
            f"{r['probe_wall_ms']:.3f} ms, mix {secs:.3f} s on {smi}")
    # a stepper.prefill seam on one admission
    eng = hooked_engine(lm)
    try:
        kernels.reset_launch_counts()
        with FaultPlan().arm("stepper.prefill", times=1) as plan:
            first = eng.submit(poison_prompt, 8)
            greedy = [(i, r) for i, r in enumerate(gen_reqs)
                      if r[2] is None][:4]
            handles = [eng.submit(p, n) for _, (p, n, _) in greedy]
            outs = [eng.wait(h, timeout=600) for h in handles]
        try:
            eng.wait(first, timeout=600)
            failed = None
        except InternalError as e:
            failed = str(e)
        counts = kernels.launch_counts()
        stats = eng.stats()
    finally:
        eng.stop()
    check(failed is not None and "prefill failed" in failed
          and plan.fired("stepper.prefill") == 1,
          f"12b: the seamed admission did not fail alone: {failed}")
    check(all(np.array_equal(o, gen_outs[i])
              for o, (i, _) in zip(outs, greedy))
          and stats["prefill_failures"] == 1 and stats["quarantines"] == 0,
          "12b: the admissions beside the failed one went wrong")
    counts_all.append(counts)
    res["prefill_failure"] = {"prefill_failures": stats["prefill_failures"],
                              "launches": counts}
    log(f"12b stepper.prefill: one admission failed typed, 4 beside it "
        f"equal phase 4's, launches {counts} on {smi}")
    return res, counts_all


def run_watchdog(torch, np, lm, smi, gen_reqs, gen_outs):
    """12c on one engine behind a ``ServingServer``: a dead scheduler, a
    wedged one, a third restart, then a crash with the budget spent; the
    cache banks of the abandoned generations are freed."""
    import gc
    import threading

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import (
        InternalError,
        ServingClient,
        ServingServer,
    )

    def wait_for(cond, what, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.002)
        check(False, f"12c: timed out waiting for {what}")

    greedy = [(i, r) for i, r in enumerate(gen_reqs) if r[2] is None][:4]
    torch.cuda.synchronize()
    # request 0 and the greedy four come back after every restart, and a
    # store would survive the restarts: none, so no reply is a ladder hit
    eng = hooked_engine(lm, watchdog_interval=1.0, prefix_cache=False)
    srv = ServingServer(eng).start()
    counts_all = []
    try:
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        trips = []
        for kind in ("dead", "wedged", "dead"):
            p, n, _ = gen_reqs[0]
            if kind == "dead":
                plan = FaultPlan().arm("scheduler.loop", times=1, after=20,
                                       when=lambda ctx: ctx["busy"])
            else:
                plan = FaultPlan().arm("scheduler.loop", action="delay",
                                       delay=5.0, times=1, after=20,
                                       when=lambda ctx: ctx["busy"])
            with plan:
                req = eng.submit(p, n)
                try:
                    eng.wait(req, timeout=600)
                    err = None
                except InternalError as e:
                    err = str(e)
                wait_for(lambda: eng.health()["restarts"] == len(trips) + 1
                         and eng.health()["status"] == "serving",
                         "the restart")
                t_serving = time.time()
            check(err is not None and (
                "crashed" if kind == "dead" else "wedged") in err,
                f"12c: the {kind} scheduler's request did not fail typed: "
                f"{err}")
            check(0 < len(req.tokens) < n,
                  f"12c: the {kind} trip was not mid-decode")
            trip = [e for e in eng.recorder.snapshot()
                    if e["kind"] == "engine.watchdog_trip"][-1]
            trips.append({
                "kind": kind, "tokens_before": len(req.tokens),
                "trip_to_serving_s": t_serving - trip["ts"],
                "restart_s": eng.last_restart["seconds"],
                "warmup_s": eng.last_restart["warmup_seconds"],
            })
            log(f"12c {kind}: request failed typed after "
                f"{len(req.tokens)} tokens; trip to serving "
                f"{trips[-1]['trip_to_serving_s']:.3f} s, rebuilt stepper "
                f"warmed in {trips[-1]['warmup_s']:.3f} s on {smi}")
            if kind == "wedged":
                wait_for(lambda: sum(t.name == "serving-engine"
                                     for t in threading.enumerate()) == 1,
                         "the zombie scheduler to exit", timeout=30)
            else:
                kernels.reset_launch_counts()
                outs = [eng.generate(p, n, timeout=600)
                        for _, (p, n, _) in greedy]
                counts = kernels.launch_counts()
                check(all(np.array_equal(o, gen_outs[i])
                          for o, (i, _) in zip(outs, greedy)),
                      "12c: a decode after the restart differs from phase 4's")
                check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
                      f"12c: the restarted engine skipped B7: {counts}")
                counts_all.append(counts)
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check(mem1 - mem0 <= BANK_BYTES,
              f"12c: {mem1 - mem0} bytes more after 3 restarts than at the "
              f"start (one bank is {BANK_BYTES})")
        with FaultPlan().arm("scheduler.loop", times=None):
            eng.submit(gen_reqs[0][0], 4)
            wait_for(lambda: eng.health()["restart_budget_exhausted"],
                     "the budget to run out")
        with ServingClient(srv.host, srv.port, timeout=60,
                           connect_timeout=2) as c:
            wire = c.health()
        check(wire["status"] == "degraded"
              and wire["restart_budget_exhausted"]
              and wire["restarts"] == 3 and wire["watchdog_trips"] == 4,
              f"12c: the wire health after the budget: {wire}")
        try:
            eng.submit(gen_reqs[0][0], 4)
            refused = None
        except InternalError as e:
            refused = str(e)
        check(refused is not None and "budget exhausted" in refused,
              f"12c: submit on a degraded engine was not refused: {refused}")
    finally:
        srv.shutdown()
    res = {"trips": trips, "memory_growth_bytes": mem1 - mem0,
           "bank_bytes": BANK_BYTES, "wire_status": wire["status"]}
    log(f"12c: 3 restarts, memory {mem1 - mem0:+d} bytes against a "
        f"{BANK_BYTES}-byte bank; then the budget ran out and the wire health "
        f"says {wire['status']} on {smi}")
    return res, counts_all


def run_phase12(torch, np, lm, smi, gen_reqs, gen_outs):
    """Phase 12, the self-healing scheduler on the card; returns the results
    and the launch counts of each subphase's main path."""
    out = {}
    t0 = time.monotonic()
    out["loop_ab"], c_a = run_loop_ab(torch, np, lm, smi, gen_reqs, gen_outs)
    out["poison"], c_b = run_poison(torch, np, lm, smi, gen_reqs, gen_outs)
    out["watchdog"], c_c = run_watchdog(torch, np, lm, smi, gen_reqs,
                                        gen_outs)
    detach_hooks(lm)
    out["seconds_total"] = time.monotonic() - t0
    counts = [*c_a, *c_b, *c_c]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ----------------------------------------------------------------- phase 13

#: phase 13's pool at its default size: 8 slots x 32 pages of 16 positions
#: and the null sentinel, 8 blocks x (K, V) x 16 positions x 8 heads x 64 x
#: 4 bytes a page
POOL_BYTES = 257 * 8 * 2 * 16 * 8 * 64 * 4


def shared_header_mix(np):
    """13b's traffic: one 192-token system prompt and 16 requests of the
    header plus a distinct 16-64-token suffix, 32 new tokens each, every
    fourth one sampled."""
    rng = np.random.default_rng(13)
    header = rng.integers(0, 8192, 192)
    reqs = []
    for i in range(16):
        suffix = rng.integers(0, 8192, int(rng.integers(16, 65)))
        sampling = ({"temperature": 0.8, "seed": 200 + i}
                    if i % 4 == 3 else None)
        reqs.append((np.concatenate([header, suffix]).astype(np.int32), 32,
                     sampling))
    return header, reqs


def argmax_gap(torch, np, lm, outs, reqs):
    """The largest gap between the best teacher-forced plain logit and the
    chosen token's, over every greedy token of ``outs`` (the LN hook is
    detached for the plain forward and attached again after)."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    detach_hooks(lm)
    worst = 0.0
    for o, (p, _, s) in zip(outs, reqs):
        if s is not None:
            continue
        lg = forward(torch, lm, o[None])[0].cpu().numpy()
        pos = np.arange(len(p) - 1, len(o) - 1)
        worst = max(worst, float((lg[pos].max(-1) - lg[pos, o[pos + 1]]).max()))
    attach_fused_layernorm(lm)
    return worst


def token_agreement(np, outs, refs, reqs):
    """Share of the generated tokens equal to ``refs``'s."""
    same = total = 0
    for o, r, (p, _, _) in zip(outs, refs, reqs):
        same += int((o[len(p):] == r[len(p):]).sum())
        total += len(o) - len(p)
    return same / total


def check_replies(torch, np, lm, eng, outs, reqs, tag):
    """13's token bars: every request finished with its tokens, every
    greedy token is the argmax of its teacher-forced plain logits within
    LOGIT_TOL, and the sampled requests replay identically on ``eng``.
    Returns the argmax gap."""
    check(all(isinstance(o, np.ndarray) and len(o) == len(p) + n
              for o, (p, n, _) in zip(outs, reqs)),
          f"{tag}: a request did not finish with its max_new_tokens: "
          f"{[o for o in outs if not isinstance(o, np.ndarray)][:2]}")
    replay = [(o, eng.generate(p, n, sampling=s, timeout=600))
              for o, (p, n, s) in zip(outs, reqs) if s is not None]
    check(all(np.array_equal(a, b) for a, b in replay),
          f"{tag}: a sampled request did not replay identically")
    gap = argmax_gap(torch, np, lm, outs, reqs)
    check(gap <= LOGIT_TOL,
          f"{tag}: a greedy token is not the argmax of its plain logits "
          f"(gap {gap})")
    return gap


def pool_watch(eng):
    """A ``stepper.step`` seam that never fires and records the pool's
    pages in use and shared pages at every step."""
    from distkeras_tpu_torch.faults import FaultPlan

    seen = {"in_use": 0, "shared": 0}

    def note(ctx):
        alloc = eng._stepper._kv_alloc
        seen["in_use"] = max(seen["in_use"], alloc.pages_in_use)
        seen["shared"] = max(seen["shared"], alloc.shared_pages)
        return False

    return FaultPlan().arm("stepper.step", times=None, when=note), seen


def run_paged_mix(torch, np, lm, smi, gen, gen_reqs, gen_outs):
    """13a: phase 4's mix on a paged engine."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    eng = hooked_engine(lm, paged=True)
    try:
        kernels.reset_launch_counts()
        outs, secs = serve_mix(eng, gen_reqs)
        counts = kernels.launch_counts()
        gap = check_replies(torch, np, lm, eng, outs, gen_reqs, "13a")
        stats = eng.stats()
        st = eng._stepper
        in_use, held = st._kv_alloc.pages_in_use, st.prefix_index.reclaimable()
    finally:
        eng.stop()
    check(stats["paged"]["exhaustions"] == 0,
          f"13a: {stats['paged']['exhaustions']} pool exhaustions")
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"13a: the paged mix did not run through B7 alone: {counts}")
    check(in_use == held,
          f"13a: {in_use} pages in use after the mix, the index holds {held}")
    solo = CachedSequenceGenerator(lm)
    greedy = [i for i, r in enumerate(gen_reqs) if r[2] is None]
    solo_outs = [solo.generate(gen_reqs[i][0][None], gen_reqs[i][1])[0]
                 for i in greedy]
    tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, gen_reqs))
    res = {
        "tokens": tokens, "seconds": secs, "tokens_per_s": tokens / secs,
        "phase4_tokens_per_s": gen["tokens_per_s"],
        "ratio_to_phase4": tokens / secs / gen["tokens_per_s"],
        "max_argmax_gap": gap, "launches": counts,
        "agreement_phase4": token_agreement(np, outs, gen_outs, gen_reqs),
        "agreement_solo": token_agreement(
            np, [outs[i] for i in greedy], solo_outs,
            [gen_reqs[i] for i in greedy]),
        "pages_in_use_after": in_use, "index_pages": held,
        "steps": stats["steps"], "paged": stats["paged"],
    }
    log(f"13a paged mix: {res['tokens_per_s']:.1f} tokens/s against "
        f"{gen['tokens_per_s']:.1f} dense (phase 4) = "
        f"{res['ratio_to_phase4']:.3f}x; token agreement "
        f"{res['agreement_phase4']:.4f} with phase 4, "
        f"{res['agreement_solo']:.4f} with solo decode; argmax gap {gap:.2e};"
        f" exhaustions 0; {in_use} pages held by the index after the mix; "
        f"step buckets {stats['paged']['compiled_step_buckets']}, launches "
        f"{counts} on {smi}")
    return res, counts


def serve_header_mix(eng, reqs, **kw):
    """13b's arrival: the first request alone, the other 15 once its
    first chunk arrives (``kw`` rides every ``submit``). Returns
    (replies, seconds, requests)."""
    t0 = time.monotonic()
    p, n, s = reqs[0]
    first = eng.submit(p, n, sampling=s, stream=True, **kw)
    first.next_chunk(timeout=600)
    handles = [first] + [eng.submit(p, n, sampling=s, **kw)
                         for p, n, s in reqs[1:]]
    outs = [eng.wait(h, timeout=600) for h in handles]
    return outs, time.monotonic() - t0, handles


def run_header_modes(torch, np, lm, smi):
    """13b: the shared-header traffic on a dense engine without a store,
    a dense engine with the default store, and a paged engine (device
    index and store), in turns. The paged engine is returned alive for
    13d and 13e."""
    from distkeras_tpu_torch import kernels

    header, reqs = shared_header_mix(np)
    modes = (("dense_no_store", {"prefix_cache": False}),
             ("dense_store", {}), ("paged", {"paged": True}))
    res, counts_all, keep = {}, [], None
    try:
        for mode, kw in modes:
            eng = hooked_engine(lm, **kw)
            plan, seen = pool_watch(eng) if mode == "paged" else (None, None)
            try:
                kernels.reset_launch_counts()
                if plan is not None:
                    with plan:
                        outs, secs, handles = serve_header_mix(eng, reqs)
                else:
                    outs, secs, handles = serve_header_mix(eng, reqs)
                counts = kernels.launch_counts()
                stats = eng.stats()
                gap = check_replies(torch, np, lm, eng, outs, reqs,
                                    f"13b {mode}")
            finally:
                if mode == "paged":
                    keep = eng
                else:
                    eng.stop()
            check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
                  f"13b {mode}: did not run through B7 alone: {counts}")
            ttft = [h.latency()["ttft"] for h in handles]
            tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
            store = stats["prefix_cache"]
            r = {
                "prefill_positions": stats["prefill_tokens"],
                "prompt_positions": sum(len(p) - 1 for p, _, _ in reqs),
                "store": ({k: store[k] for k in ("hits", "inserts",
                                                 "hit_tokens")}
                          if store["enabled"] else "off"),
                "ttft_ms": quantiles_ms(np, ttft), "seconds": secs,
                "tokens_per_s": tokens / secs, "max_argmax_gap": gap,
                "launches": counts,
            }
            if mode == "paged":
                dp = stats["paged"]["device_prefix"]
                r["index"] = {"hits": dp["hits"], "hit_pages": dp["hit_pages"]}
                r["peak_shared_pages"] = seen["shared"]
                r["peak_pages_in_use"] = seen["in_use"]
                r["exhaustions"] = stats["paged"]["exhaustions"]
                check(dp["hits"] >= 15 and dp["hit_pages"] == 12 * dp["hits"],
                      f"13b paged: device index {dp['hits']} hits, "
                      f"{dp['hit_pages']} pages (want >= 15, 12 a hit)")
            res[mode] = r
            counts_all.append(counts)
            log(f"13b {mode}: {r['prefill_positions']} prefill positions of "
                f"{r['prompt_positions']}; store {r['store']}"
                + (" (the host ladder reuses only its 128-token rung: keys "
                   "are powers of two)" if mode != "dense_no_store" else "")
                + (f"; index {r['index']}, peak shared pages "
                   f"{r['peak_shared_pages']}" if mode == "paged" else "")
                + f"; TTFT p50/p99 {r['ttft_ms']} ms; "
                f"{r['tokens_per_s']:.1f} tokens/s on {smi}")
    except BaseException:
        if keep is not None:
            keep.stop()
        raise
    res["prefill_ratio_no_store_to_paged"] = (
        res["dense_no_store"]["prefill_positions"]
        / res["paged"]["prefill_positions"])
    log(f"13b: the paged engine computed "
        f"{res['prefill_ratio_no_store_to_paged']:.2f}x fewer prefill "
        f"positions than the dense engine without a store")
    return res, counts_all, keep, reqs


def run_pool_pressure(torch, np, lm, smi, gen_reqs):
    """13c: phase 4's mix on a 61-page pool (three of the mix's largest
    requests), a request that never fits a smaller pool, then an injected
    exhaustion over the wire."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.serving import (
        PoolExhaustedError,
        ServingClient,
        ServingEngine,
        ServingError,
        ServingServer,
    )

    num_pages = 1 + 3 * 20  # pages_for(256, 64) = 20 at page_size 16
    eng = hooked_engine(lm, paged=True, num_pages=num_pages)
    plan, seen = pool_watch(eng)
    try:
        kernels.reset_launch_counts()
        with plan:
            outs, secs = serve_mix(eng, gen_reqs)
        counts = kernels.launch_counts()
        check(eng._stepper.pages_for(256, 64) == 20,
              "13c: pages_for(256, 64) is not 20")
        gap = check_replies(torch, np, lm, eng, outs, gen_reqs, "13c")
        stats = eng.stats()
        # the wire: a retry=False client meets the injected exhaustion, a
        # retrying one gets its reply on the retry, the requests decoding
        # beside them are untouched
        srv = ServingServer(eng).start()
        greedy = [i for i, r in enumerate(gen_reqs) if r[2] is None]
        beside = [eng.submit(gen_reqs[i][0], gen_reqs[i][1])
                  for i in greedy[:3]]
        deadline = time.monotonic() + 600
        while (not all(len(h.tokens) for h in beside)
               and time.monotonic() < deadline):
            time.sleep(0.002)
        wp, wn, _ = gen_reqs[greedy[3]]
        with ServingClient(srv.host, srv.port, timeout=600, retry=False,
                           connect_timeout=2) as c:
            with FaultPlan().arm("kv.alloc", times=1, exc=PoolExhaustedError(
                    "injected", retry_after_ms=25.0)) as p1:
                try:
                    c.generate(wp, wn)
                    wire_err = None
                except ServingError as e:
                    wire_err = e
        with ServingClient(
            srv.host, srv.port, timeout=600, connect_timeout=2,
            retry=RetryPolicy(max_attempts=3, base_delay=0.01, seed=0),
        ) as c:
            with FaultPlan().arm("kv.alloc", times=1, exc=PoolExhaustedError(
                    "injected", retry_after_ms=25.0)) as p2:
                retried = c.generate(wp, wn)
        beside_outs = [eng.wait(h, timeout=600) for h in beside]
        srv.shutdown()
        wire_stats = eng.stats()
    finally:
        eng.stop()
    check(stats["completed"] == len(gen_reqs) + 4
          and stats["internal_errors"] == 0,
          f"13c: {stats['completed']} completed, {stats['internal_errors']} "
          f"internal errors under pool pressure")
    check(stats["paged"]["exhaustions"] == 0,
          f"13c: {stats['paged']['exhaustions']} exhaustions: gating "
          f"should have waited")
    check(seen["in_use"] <= num_pages - 1,
          f"13c: {seen['in_use']} pages in use on a {num_pages - 1}-page pool")
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"13c: the mix did not run through B7 alone: {counts}")
    check(wire_err is not None and wire_err.code == "overloaded"
          and getattr(wire_err, "retry_after", None) == 0.025
          and p1.fired("kv.alloc") == 1,
          f"13c: the injected exhaustion did not come back overloaded with "
          f"retry_after_ms: {wire_err!r}")
    # the resubmitted prompts may share their pages from the device index,
    # so they are held to the argmax bar, and their agreement with the
    # mix's replies is reported
    again = [(retried, gen_reqs[greedy[3]])] + [
        (o, gen_reqs[i]) for o, i in zip(beside_outs, greedy[:3])]
    again_gap = argmax_gap(torch, np, lm, [o for o, _ in again],
                           [r for _, r in again])
    check(p2.fired("kv.alloc") == 1 and len(retried) == len(wp) + wn,
          "13c: the retrying client did not get its reply")
    check(all(len(o) == len(r[0]) + r[1] for o, r in again)
          and again_gap <= LOGIT_TOL and wire_stats["internal_errors"] == 0,
          f"13c: a request beside the injected exhaustion was affected "
          f"(gap {again_gap})")
    again_agree = token_agreement(
        np, [o for o, _ in again],
        [outs[greedy[3]]] + [outs[i] for i in greedy[:3]],
        [r for _, r in again])
    # a request that can never fit a 16-page pool is refused at submit
    small = ServingEngine(lm, num_slots=8, paged=True, num_pages=17).start()
    try:
        try:
            small.submit(np.arange(256, dtype=np.int32), 64)  # 20 pages
            refused = None
        except ValueError as e:
            refused = str(e)
    finally:
        small.stop()
    check(refused is not None and "KV pages" in refused,
          f"13c: a never-fitting request was not refused: {refused}")
    tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, gen_reqs))
    res = {
        "num_pages": num_pages, "peak_pages_in_use": seen["in_use"],
        "peak_shared_pages": seen["shared"], "seconds": secs,
        "tokens_per_s": tokens / secs, "mean_batch_occupancy":
        stats["mean_batch_occupancy"], "max_argmax_gap": gap,
        "exhaustions": stats["paged"]["exhaustions"],
        "wire_error": {"code": wire_err.code,
                       "retry_after_ms": wire_err.retry_after * 1e3},
        "refused": refused, "launches": counts,
        "after_injection_agreement_with_mix": again_agree,
    }
    log(f"13c pool pressure: 16 requests on {num_pages - 1} pages, peak "
        f"{seen['in_use']} in use, mean batch occupancy "
        f"{res['mean_batch_occupancy']:.2f}, {res['tokens_per_s']:.1f} "
        f"tokens/s, 0 exhaustions; injected exhaustion over the wire -> "
        f"{res['wire_error']}, the retrying client got its reply (the four "
        f"after it agree {again_agree:.4f} with the mix); refused at "
        f"submit: {refused!r} on {smi}")
    return res, counts


def run_paged_restart(torch, np, lm, smi, eng, reqs):
    """13d: a scheduler crash on 13b's paged engine: the supervisor
    rebuilds a paged stepper (fresh pool, empty device index), the host
    store keeps its entries, the old pool is freed, and a header request
    after the restart hits the host ladder."""
    import gc

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import InternalError

    store = eng.prefix_store
    old = eng._stepper
    entries = store.stats()["entries"]
    index_before = old.prefix_index.stats()["entries"]
    del old
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    p, n, _ = reqs[0]
    with FaultPlan().arm("scheduler.loop", times=1, after=20,
                         when=lambda ctx: ctx["busy"]):
        req = eng.submit(p, n)
        try:
            eng.wait(req, timeout=600)
            err = None
        except InternalError as e:
            err = str(e)
    deadline = time.monotonic() + 60
    while (not (eng.health()["restarts"] == 1
                and eng.health()["status"] == "serving")
           and time.monotonic() < deadline):
        time.sleep(0.002)
    st = eng._stepper
    check(err is not None and "crashed" in err,
          f"13d: the crashed scheduler's request did not fail typed: {err}")
    check(eng.health()["restarts"] == 1 and st.paged
          and st.prefix_index.stats()["entries"] == 0
          and st._kv_alloc.pages_in_use == 0,
          "13d: the supervisor did not rebuild a fresh paged stepper")
    check(eng.prefix_store is store and store.stats()["entries"] == entries,
          f"13d: the host store lost entries: {store.stats()['entries']} "
          f"of {entries}")
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    check(mem1 - mem0 < POOL_BYTES,
          f"13d: {mem1 - mem0} bytes more after the restart (one pool is "
          f"{POOL_BYTES}): the old pool was not freed")
    hits = store.stats()["hits"]
    q, m, _ = reqs[1]
    kernels.reset_launch_counts()
    out = eng.generate(q, m, timeout=600)
    counts = kernels.launch_counts()
    gap = argmax_gap(torch, np, lm, [out], [reqs[1]])
    check(store.stats()["hits"] == hits + 1,
          "13d: the header request after the restart missed the host ladder")
    check(gap <= LOGIT_TOL and len(out) == len(q) + m,
          f"13d: the request after the restart is wrong (gap {gap})")
    res = {"store_entries": entries, "index_entries_before": index_before,
           "memory_growth_bytes": mem1 - mem0, "pool_bytes": POOL_BYTES,
           "restart_s": eng.last_restart["seconds"],
           "warmup_s": eng.last_restart["warmup_seconds"],
           "max_argmax_gap": gap, "launches": counts}
    log(f"13d restart: a paged stepper rebuilt in {res['restart_s']:.3f} s "
        f"(warmup {res['warmup_s']:.3f} s), the store kept {entries} "
        f"entries, the index went from {index_before} entries to 0, memory "
        f"{mem1 - mem0:+d} bytes against a {POOL_BYTES}-byte pool, the header "
        f"request after it hit the host ladder on {smi}")
    return res, counts


def run_paged_ledger(torch, np, lm, smi, eng, reqs):
    """13e: the warm-up mints, then the warm set, ``mark_warmed`` and 13b's
    paged traffic again: no storm."""
    from distkeras_tpu_torch import kernels

    led = eng.compile_ledger
    # the engine's first stepper and 13d's rebuilt one each warmed these
    warm = [m["key"] for m in led.mints() if m["trigger"] == "warmup"
            and m["key"].startswith("paged_step[")]
    first_gen = warm[:6]
    check(warm == 2 * [f"paged_step[{b}]" for b in (1, 2, 4, 8, 16, 32)],
          f"13e: the warm-ups minted {warm}")
    st = eng._stepper
    t0 = time.monotonic()
    st.warm_prefill_buckets()
    st.warm_restore_buckets()
    warm_s = time.monotonic() - t0
    led.mark_warmed()
    kernels.reset_launch_counts()
    outs, secs, _ = serve_header_mix(eng, reqs)
    counts = kernels.launch_counts()
    after = led.snapshot()
    gap = argmax_gap(torch, np, lm, outs, reqs)
    check(after["storms"] == 0,
          f"13e: {after['storms']} compile storms after mark_warmed: "
          f"{after['recent']}")
    check(gap <= LOGIT_TOL, f"13e: a greedy token off its argmax ({gap})")
    res = {"warmup_step_mints": first_gen, "warm_set_s": warm_s,
           "after_mark_warmed": {k: after[k] for k in ("total", "warmup",
                                                        "serving", "storms")},
           "seconds": secs, "launches": counts}
    log(f"13e compile ledger: warm-up minted {first_gen}; warm_prefill and "
        f"warm_restore buckets in {warm_s:.3f} s; after mark_warmed and 13b's "
        f"paged traffic again {res['after_mark_warmed']} on {smi}")
    return res, counts


def run_phase13(torch, np, lm, smi, gen, gen_reqs, gen_outs):
    """Phase 13, paged KV pools and the prefix cache on the card; returns
    the results and the launch counts of each subphase's main path."""
    out = {}
    t0 = time.monotonic()
    out["paged_mix"], c_a = run_paged_mix(torch, np, lm, smi, gen, gen_reqs,
                                          gen_outs)
    out["shared_header"], c_b, eng, reqs = run_header_modes(torch, np, lm,
                                                            smi)
    try:
        out["pool_pressure"], c_c = run_pool_pressure(torch, np, lm, smi,
                                                      gen_reqs)
        out["restart"], c_d = run_paged_restart(torch, np, lm, smi, eng, reqs)
        out["ledger"], c_e = run_paged_ledger(torch, np, lm, smi, eng, reqs)
    finally:
        eng.stop()
    detach_hooks(lm)
    out["seconds_total"] = time.monotonic() - t0
    counts = [c_a, *c_b, c_c, c_d, c_e]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ----------------------------------------------------------------- phase 14

#: B7 launches per call of each stepper program, for a model of L blocks
#: with the LayerNorm hook: ln1 and ln2 per block, plus the final norm
#: where the program computes logits
LN_PER_CALL = {"_step_dev": lambda n: 2 * n + 1,
               "_verify_dev": lambda n: 2 * n + 1,
               "_prefill_full": lambda n: 2 * n,
               "_prefill_mid": lambda n: 2 * n,
               "_prefill_paged": lambda n: 2 * n}


def block_count(model):
    """The transformer blocks of an LM (an MoE stage adds no LayerNorm)."""
    return sum(type(layer).__name__ == "TransformerBlock"
               for layer in model.layers)


class ProgramCalls:
    """Counts the calls of each ``DecodeStepper`` program body per model
    while active, so a drive's exact B7 launch count follows from them:
    ``ln_launches()``. Targets and draft banks are told apart by their
    model."""

    def __init__(self):
        self.calls = {}
        self.blocks = {}  # id(model) -> its block count (no reference kept)
        self._orig = {}

    def __enter__(self):
        import functools

        from distkeras_tpu_torch.serving.engine import DecodeStepper

        for name in LN_PER_CALL:
            orig = getattr(DecodeStepper, name)
            self._orig[name] = orig

            def wrap(orig=orig, name=name):
                @functools.wraps(orig)
                def call(st, *a, **kw):
                    key = (id(st.model), name)
                    self.calls[key] = self.calls.get(key, 0) + 1
                    self.blocks[id(st.model)] = block_count(st.model)
                    return orig(st, *a, **kw)
                return call

            setattr(DecodeStepper, name, wrap())
        return self

    def __exit__(self, *exc):
        from distkeras_tpu_torch.serving.engine import DecodeStepper

        for name, orig in self._orig.items():
            setattr(DecodeStepper, name, orig)

    def of(self, model, name):
        return self.calls.get((id(model), name), 0)

    def ln_launches(self, models):
        """The B7 launches the counted calls make on ``models`` (hooked)."""
        return sum(self.of(m, name) * per(block_count(m))
                   for m in models for name, per in LN_PER_CALL.items())

    def ln_launches_all(self):
        """The B7 launches the counted calls make on every model that ran
        (each hooked): a fleet's replicas may each hold their own copy."""
        return sum(n * LN_PER_CALL[name](self.blocks[mid])
                   for (mid, name), n in self.calls.items())


def templated_mix(np):
    """14b's traffic: 16 prompts, each one 32-token span from
    ``default_rng(14)`` repeated 4-6 times and a distinct 8-token tail, 64
    new tokens each, every fourth one sampled."""
    rng = np.random.default_rng(14)
    reqs = []
    for i in range(16):
        span = rng.integers(0, 8192, 32)
        tail = rng.integers(0, 8192, 8)
        prompt = np.concatenate([np.tile(span, int(rng.integers(4, 7))),
                                 tail]).astype(np.int32)
        sampling = ({"temperature": 0.8, "seed": 300 + i}
                    if i % 4 == 3 else None)
        reqs.append((prompt, 64, sampling))
    return reqs


def spec_books(stats):
    """The speculative books of ``stats()`` a phase 14 line prints."""
    s = stats["speculative"]
    if not s["enabled"]:
        return s
    return {k: s[k] for k in ("draft_source", "windows", "verify_steps",
                              "fallback_steps", "drafted_tokens",
                              "accepted_draft_tokens",
                              "rejected_draft_tokens", "emitted_tokens",
                              "mean_tokens_per_window")}


def drive_spec(torch, np, lm, tag, reqs, models, base_rate=None, probe=None,
               **kw):
    """One fresh LN-hooked engine (``hooked_engine(lm, **kw)``) serving
    ``reqs``: the token bars of ``check_replies``, B7 launches exactly what
    the program calls on ``models`` imply, B4 none. ``probe(engine)`` reads
    more off the engine before it stops. Returns (result, launches,
    outputs, engine stats, the probe's value)."""
    from distkeras_tpu_torch import kernels

    eng = hooked_engine(lm, **kw)
    try:
        kernels.reset_launch_counts()
        with ProgramCalls() as calls:
            outs, secs = serve_mix(eng, reqs)
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        extra = None if probe is None else probe(eng)
        gap = check_replies(torch, np, lm, eng, outs, reqs, tag)
        stats = eng.stats()
    finally:
        eng.stop()
    want = calls.ln_launches(models)
    check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
          f"{tag}: B7 launches {counts['layernorm_fwd']}, the program calls "
          f"imply {want}; B4 {counts['flash_fwd']}")
    tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
    res = {"tokens": tokens, "seconds": secs, "tokens_per_s": tokens / secs,
           "ratio_to_base": (None if base_rate is None
                             else tokens / secs / base_rate),
           "max_argmax_gap": gap,
           "launches": counts, "speculative": spec_books(stats),
           "program_calls": {f"{'target' if mid == id(lm) else 'draft'}"
                             f".{name}": n
                             for (mid, name), n in calls.calls.items()},
           "steps": stats["steps"]}
    return res, counts, outs, stats, extra


def run_spec_ngram_mix(torch, np, lm, smi, gen, gen_reqs, gen_outs):
    """14a: the n-gram drafter on phase 4's mix, dense."""
    res, counts, outs, _, _ = drive_spec(
        torch, np, lm, "14a", gen_reqs, [lm], gen["tokens_per_s"],
        speculative="ngram", draft_k=4)
    res["agreement_phase4"] = token_agreement(np, outs, gen_outs, gen_reqs)
    res["phase4_tokens_per_s"] = gen["tokens_per_s"]
    log(f"14a n-gram, phase 4's mix: {res['tokens_per_s']:.1f} tokens/s "
        f"against phase 4's {gen['tokens_per_s']:.1f} in this call = "
        f"{res['ratio_to_base']:.3f}x; agreement with phase 4's replies "
        f"{res['agreement_phase4']:.4f}; argmax gap "
        f"{res['max_argmax_gap']:.2e}; books {res['speculative']}; B7 "
        f"{counts['layernorm_fwd']} = the program calls' {res['program_calls']}"
        f" on {smi}")
    return res, counts


def run_spec_templated(torch, np, lm, smi, reqs):
    """14b: templated traffic on a plain and an n-gram engine, in turns
    (``ab_turns``), each engine fresh."""
    runs, counts_all, outs_by = {"plain": [], "ngram": []}, [], {}
    for mode in ab_turns("plain", "ngram"):
        kw = {"speculative": "ngram", "draft_k": 4} if mode == "ngram" else {}
        res, counts, outs, _, _ = drive_spec(torch, np, lm, f"14b {mode}",
                                             reqs, [lm], **kw)
        runs[mode].append(res)
        counts_all.append(counts)
        outs_by.setdefault(mode, outs)
    plain = sum(r["tokens_per_s"] for r in runs["plain"]) / len(runs["plain"])
    spec = sum(r["tokens_per_s"] for r in runs["ngram"]) / len(runs["ngram"])
    out = {"plain": runs["plain"], "ngram": runs["ngram"],
           "plain_tokens_per_s": plain, "ngram_tokens_per_s": spec,
           "ratio": spec / plain,
           "agreement_ngram_plain": token_agreement(
               np, outs_by["ngram"], outs_by["plain"], reqs)}
    for mode in ("plain", "ngram"):
        log(f"14b templated, {mode}: tokens/s "
            f"{[round(r['tokens_per_s'], 1) for r in runs[mode]]}; books "
            f"{runs[mode][0]['speculative'] if mode == 'ngram' else '-'}; "
            f"argmax gap {max(r['max_argmax_gap'] for r in runs[mode]):.2e}")
    log(f"14b: n-gram / plain tokens/s {out['ratio']:.3f}x (means of the "
        f"turns {spec:.1f} / {plain:.1f}); token agreement n-gram vs plain "
        f"{out['agreement_ngram_plain']:.4f} on {smi}")
    return out, counts_all, outs_by["ngram"]


def small_draft(zoo):
    """14c's small draft: ``transformer_lm(8192, 512, 256, 4, 2, seed=1)``
    with the LayerNorm hook."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    d = zoo.transformer_lm(vocab_size=8192, seq_len=512, d_model=256,
                           num_heads=4, depth=2, seed=1)
    check(attach_fused_layernorm(d) == 5, "LN hook not on the draft's 5")
    return d


def self_draft(zoo):
    """14c's self-draft: a second LN-hooked copy of the target (the same
    seed, so the same weights)."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    d = make_lm(zoo)
    check(attach_fused_layernorm(d) == 17, "LN hook not on the copy's 17")
    return d


def run_spec_model_drafts(torch, np, lm, smi, zoo, gen, gen_reqs, gen_outs):
    """14c: model drafters. The self-draft on phase 4's 12 greedy requests
    (every full window accepts every proposal; the tokens equal phase 4's
    plain engine's), the small draft on the whole mix (14a's bars); B7
    exactly 17 per target verify or step, 16 per target prefill chunk, and
    per draft step and prefill what the draft's depth gives."""
    out, counts_all = {}, []
    greedy = [i for i, r in enumerate(gen_reqs) if r[2] is None]
    g_reqs = [gen_reqs[i] for i in greedy]
    d = self_draft(zoo)
    res, counts, outs, _, _ = drive_spec(
        torch, np, lm, "14c self", g_reqs, [lm, d],
        gen["tokens_per_s"], speculative="draft", draft_bundle=d, draft_k=4)
    spec = res["speculative"]
    full = sum(-(-n // 5) for _, n, _ in g_reqs)
    check(spec["fallback_steps"] == 0 and spec["windows"] == full,
          f"14c self: {spec['windows']} windows and {spec['fallback_steps']}"
          f" fallbacks; all-accepted windows would be {full} and 0")
    same = all(np.array_equal(o, gen_outs[i]) for o, i in zip(outs, greedy))
    check(same, "14c self: a greedy reply differs from phase 4's plain one")
    res["full_windows_expected"] = full
    out["self_draft"] = res
    counts_all.append(counts)
    log(f"14c self-draft: every window accepted all 4 proposals ({full} "
        f"windows, mean {spec['mean_tokens_per_window']} tokens a window, "
        f"below 5 only where a budget ended one), replies equal phase 4's; "
        f"{res['tokens_per_s']:.1f} tokens/s = {res['ratio_to_base']:.3f}x "
        f"phase 4's; B7 {counts['layernorm_fwd']} = {res['program_calls']} "
        f"on {smi}")
    del d
    d = small_draft(zoo)
    res, counts, outs, _, _ = drive_spec(
        torch, np, lm, "14c small", gen_reqs, [lm, d],
        gen["tokens_per_s"], speculative="draft", draft_bundle=d, draft_k=4)
    res["agreement_phase4"] = token_agreement(np, outs, gen_outs, gen_reqs)
    out["small_draft"] = res
    counts_all.append(counts)
    log(f"14c small draft (d256/L2): books {res['speculative']}; "
        f"{res['tokens_per_s']:.1f} tokens/s = {res['ratio_to_base']:.3f}x "
        f"phase 4's; agreement with phase 4's replies "
        f"{res['agreement_phase4']:.4f}; argmax gap "
        f"{res['max_argmax_gap']:.2e}; B7 {counts['layernorm_fwd']} = "
        f"{res['program_calls']} on {smi}")
    return out, counts_all, d


def run_spec_paged(torch, np, lm, smi, reqs, spec_outs):
    """14d: 14b's mix with the n-gram drafter on a paged engine: 13a's token
    bars, 0 exhaustions, ``pages_for`` reserving the verify window, the
    pages in use after the mix exactly the device index's, and the paged
    verify minted by the warm-up."""
    def probe(eng):
        st = eng._stepper
        return ([(len(p), n, st.pages_for(len(p), n)) for p, n, _ in reqs],
                [m["key"] for m in eng.compile_ledger.mints()
                 if m["trigger"] == "warmup"],
                st._kv_alloc.pages_in_use, st.prefix_index.reclaimable(),
                st._max_pages_bucket)

    res, counts, outs, stats, (reserve, mints, in_use, held, pbt) = (
        drive_spec(torch, np, lm, "14d", reqs, [lm], probe=probe,
                   speculative="ngram", draft_k=4, paged=True))
    check(stats["paged"]["exhaustions"] == 0,
          f"14d: {stats['paged']['exhaustions']} pool exhaustions")
    # the padded axis: 512 + 4 (the k bucket) + 1 positions
    check(all(n_pages == -(-min(plen + n + 5, 517) // 16)
              for plen, n, n_pages in reserve),
          f"14d: pages_for does not reserve the verify window: {reserve[:3]}")
    check(in_use == held,
          f"14d: {in_use} pages in use after the mix, the index holds {held}")
    check(f"paged_verify[5,{pbt}]" in mints,
          f"14d: the warm-up did not mint paged_verify[5,{pbt}]: {mints}")
    res.update(agreement_dense=token_agreement(np, outs, spec_outs, reqs),
               pages_in_use_after=in_use, index_pages=held,
               pages_for=reserve[:4], warmup_mints=mints,
               paged=stats["paged"])
    log(f"14d paged n-gram, 14b's mix: {res['tokens_per_s']:.1f} tokens/s; "
        f"books {res['speculative']}; 0 exhaustions; pages_for(plen, 64) "
        f"reserves plen + 64 + 5 positions ({reserve[:2]}); {in_use} pages "
        f"in use after the mix, all the index's; warm-up mints "
        f"{mints}; agreement with the dense n-gram replies "
        f"{res['agreement_dense']:.4f} on {smi}")
    return res, counts


def run_spec_faults(torch, np, lm, smi, d, reqs, spec_outs):
    """14e: a ``stepper.verify`` seam on one request's windows (it alone
    fails typed, 15 of 14b's mix equal 14b's n-gram replies); a scheduler
    crash on a small-draft engine (the supervisor rebuilds a speculative
    stepper, the drafter re-binds, a request after it is right); the
    compile ledger (the warm-ups minted ``verify[5]``; 0 storms after the
    warm set and ``mark_warmed``)."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import InternalError

    out, counts_all = {}, []
    poison_prompt = np.tile(np.arange(1, 33, dtype=np.int32), 4)
    eng = hooked_engine(lm, speculative="ngram", draft_k=4)
    try:
        bad = None

        def poisoned(ctx):
            slots = eng.batcher._slots  # the scheduler thread's own
            return any(r is bad and ctx["active"][i]
                       for i, r in enumerate(slots))

        plan = FaultPlan().arm("stepper.verify", times=None, when=poisoned)
        kernels.reset_launch_counts()
        with plan:
            handles = [eng.submit(p, n, sampling=s) for p, n, s in reqs[:15]]
            bad = eng.submit(poison_prompt, 32)
            outs = [eng.wait(h, timeout=600) for h in handles]
            try:
                eng.wait(bad, timeout=600)
                failed = None
            except InternalError as e:
                failed = str(e)
        counts = kernels.launch_counts()
        stats = eng.stats()
    finally:
        eng.stop()
    check(failed is not None and "blamed" in failed,
          f"14e: the poisoned request did not fail blamed: {failed}")
    check(all(np.array_equal(o, w) for o, w in zip(outs, spec_outs[:15])),
          "14e: a request beside the poisoned one differs from 14b's")
    check(stats["quarantines"] == 1 and stats["internal_errors"] == 1,
          f"14e: {stats['quarantines']} quarantines, "
          f"{stats['internal_errors']} internal errors")
    out["verify_seam"] = {"fired": plan.fired("stepper.verify"),
                          "blame_probes": stats["blame_probes"],
                          "step_failures": stats["step_failures"],
                          "launches": counts}
    counts_all.append(counts)
    log(f"14e stepper.verify: the poisoned request failed typed, 15 beside "
        f"it equal 14b's; seam fired {out['verify_seam']['fired']}, blame "
        f"probes {stats['blame_probes']} on {smi}")
    eng = hooked_engine(lm, speculative="draft", draft_bundle=d, draft_k=4)
    try:
        drafter = eng._stepper.drafter
        bank = drafter._st
        p, n, _ = reqs[0]
        with FaultPlan().arm("scheduler.loop", times=1, after=10,
                             when=lambda ctx: ctx["busy"]):
            req = eng.submit(p, n)
            try:
                eng.wait(req, timeout=600)
                err = None
            except InternalError as e:
                err = str(e)
        deadline = time.monotonic() + 60
        while (not (eng.health()["restarts"] == 1
                    and eng.health()["status"] == "serving")
               and time.monotonic() < deadline):
            time.sleep(0.002)
        st = eng._stepper
        check(err is not None and "crashed" in err,
              f"14e: the crashed scheduler's request did not fail typed: "
              f"{err}")
        check(eng.health()["restarts"] == 1 and st.speculative
              and st.drafter is drafter and drafter._st is not bank
              and drafter._st.num_slots == st.num_slots,
              "14e: the supervisor did not rebuild a speculative stepper "
              "with the drafter re-bound")
        q, m, _ = reqs[1]
        kernels.reset_launch_counts()
        after = eng.generate(q, m, timeout=600)
        counts = kernels.launch_counts()
        gap = argmax_gap(torch, np, lm, [after], [reqs[1]])
        check(gap <= LOGIT_TOL and len(after) == len(q) + m,
              f"14e: the request after the restart is wrong (gap {gap})")
        led = eng.compile_ledger
        warm = [mm["key"] for mm in led.mints()
                if mm["trigger"] == "warmup" and "verify" in mm["key"]]
        check(warm == ["verify[5]", "verify[5]"],
              f"14e: the warm-ups minted {warm}, not verify[5] twice")
        st.warm_prefill_buckets()
        st.warm_restore_buckets()
        led.mark_warmed()
        kernels.reset_launch_counts()
        outs, secs = serve_mix(eng, reqs[:8])
        counts2 = kernels.launch_counts()
        snap = led.snapshot()
        gap2 = argmax_gap(torch, np, lm, outs, reqs[:8])
        spec = spec_books(eng.stats())
    finally:
        eng.stop()
    check(snap["storms"] == 0,
          f"14e: {snap['storms']} compile storms after mark_warmed: "
          f"{snap['recent']}")
    check(gap2 <= LOGIT_TOL, f"14e: a greedy token off its argmax ({gap2})")
    out["restart"] = {"restart_s": eng.last_restart["seconds"],
                      "warmup_s": eng.last_restart["warmup_seconds"],
                      "max_argmax_gap": gap,
                      "equal_to_14b": bool(np.array_equal(after,
                                                          spec_outs[1])),
                      "launches": counts}
    out["ledger"] = {"warmup_verify_mints": warm,
                     "after_mark_warmed": {k: snap[k] for k in (
                         "total", "warmup", "serving", "storms")},
                     "speculative": spec, "launches": counts2}
    counts_all += [counts, counts2]
    log(f"14e restart: a speculative stepper rebuilt in "
        f"{out['restart']['restart_s']:.3f} s (warmup "
        f"{out['restart']['warmup_s']:.3f} s, the verify and the draft bank "
        f"included), the drafter re-bound, the request after it right "
        f"(equal to 14b's: {out['restart']['equal_to_14b']}); warm-up mints "
        f"{warm}; after mark_warmed and 8 requests "
        f"{out['ledger']['after_mark_warmed']} on {smi}")
    return out, counts_all


def run_spec_generator(torch, np, lm, smi, d):
    """14f: ``SpeculativeGenerator`` with the self-draft (the target
    itself) and the small draft on 4 prompts: the output equals
    ``CachedSequenceGenerator``'s greedy decode; rounds per row."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.predictors import (
        CachedSequenceGenerator,
        SpeculativeGenerator,
    )

    prompts = np.stack([r[0][:72] for r in templated_mix(np)[:4]])
    want = CachedSequenceGenerator(lm).generate(prompts, 32)
    out, counts_all = {}, []
    for name, draft in (("self", lm), ("small", d)):
        gen = SpeculativeGenerator(lm, draft, k=4)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        got = gen.generate(prompts, 32)
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
        check(np.array_equal(got, want),
              f"14f {name}: the output differs from the greedy decode")
        check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
              f"14f {name}: did not run through B7 alone: {counts}")
        out[name] = {"rounds": gen.last_rounds.tolist(), "seconds": secs,
                     "tokens_per_s": 4 * 32 / secs, "launches": counts}
        counts_all.append(counts)
        log(f"14f SpeculativeGenerator {name}-draft: equal to greedy decode, "
            f"rounds per row {out[name]['rounds']} for 32 tokens, "
            f"{out[name]['tokens_per_s']:.1f} tokens/s on {smi}")
    return out, counts_all


def run_phase14(torch, np, lm, smi, zoo, gen, gen_reqs, gen_outs):
    """Phase 14, speculative decode on the card; returns the results and
    the launch counts of each subphase's main path."""
    out = {}
    t0 = time.monotonic()
    out["ngram_mix"], c_a = run_spec_ngram_mix(torch, np, lm, smi, gen,
                                               gen_reqs, gen_outs)
    reqs = templated_mix(np)
    out["templated"], c_b, spec_outs = run_spec_templated(torch, np, lm, smi,
                                                          reqs)
    out["model_drafts"], c_c, d = run_spec_model_drafts(
        torch, np, lm, smi, zoo, gen, gen_reqs, gen_outs)
    out["paged"], c_d = run_spec_paged(torch, np, lm, smi, reqs, spec_outs)
    out["faults"], c_e = run_spec_faults(torch, np, lm, smi, d, reqs,
                                         spec_outs)
    out["generator"], c_f = run_spec_generator(torch, np, lm, smi, d)
    del d
    detach_hooks(lm)
    out["seconds_total"] = time.monotonic() - t0
    counts = [c_a, *c_b, *c_c, c_d, *c_e, *c_f]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ----------------------------------------------------------------- phase 15


def qos_mix(np):
    """15a's traffic: 8 priority-0 requests (prompts 128-256 tokens from
    ``default_rng(15)``, 192 new tokens, the fourth and eighth sampled) and
    4 priority-2 ones (prompts 32-64 tokens, 32 new)."""
    rng = np.random.default_rng(15)
    lo = []
    for i in range(8):
        p = rng.integers(0, 8192, int(rng.integers(128, 257))).astype(np.int32)
        lo.append((p, 192, {"temperature": 0.8, "seed": 400 + i}
                   if i % 4 == 3 else None))
    hi = [(rng.integers(0, 8192, int(rng.integers(32, 65))).astype(np.int32),
           32, None) for _ in range(4)]
    return lo, hi


def state_bytes(state):
    """Host bytes of one ``swap_out`` state (K/V rows and context row)."""
    return int(state["ctx"].nbytes + sum(k.nbytes + v.nbytes
                                         for k, v in state["kv"]))


def swap_meter(eng):
    """Wrap the engine's stepper ``swap_out``/``swap_in``: the host wall of
    each call and the bytes each state holds."""
    st = eng._stepper
    book = {"out_s": [], "in_s": [], "bytes": [], "tokens": []}
    out0, in0 = st.swap_out, st.swap_in

    def swap_out(slot):
        t0 = time.perf_counter()
        state = out0(slot)
        book["out_s"].append(time.perf_counter() - t0)
        book["bytes"].append(state_bytes(state))
        book["tokens"].append(int(state["len"]))
        return state

    def swap_in(slot, state, max_new=None):
        t0 = time.perf_counter()
        in0(slot, state, max_new=max_new)
        book["in_s"].append(time.perf_counter() - t0)

    st.swap_out, st.swap_in = swap_out, swap_in
    return book


def qos_engine(lm, **kw):
    """A fresh LN-hooked 8-slot paged engine with every program a swap-in
    or a fork runs warmed, and the warm set declared."""
    eng = hooked_engine(lm, paged=True, prefix_cache=False, **kw)
    eng._stepper.warm_prefill_buckets()
    eng._stepper.warm_restore_buckets()
    eng.compile_ledger.mark_warmed()
    return eng


def wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.0005)


def serve_qos(eng, lo, hi, groups=()):
    """Submit ``groups`` and ``lo`` at once (priority 0, tenant "batch"),
    then ``hi`` (priority 2, tenant "live") once every lo request is
    decoding and every group forked; returns (lo, hi and group handles,
    seconds)."""
    t0 = time.monotonic()
    gh = [eng.submit(p, n, sampling=s) for p, n, s in groups]
    lh = [eng.submit(p, n, sampling=s, tenant="batch", priority=0)
          for p, n, s in lo]
    wait_for(lambda: all(h.tokens or h.done for h in lh)
             and all(all(c for c in h.completions) or h.done for h in gh),
             "every priority-0 request to decode")
    hh = [eng.submit(p, n, sampling=s, tenant="live", priority=2)
          for p, n, s in hi]
    return lh, hh, gh, t0


def results(eng, handles):
    """Each handle's reply, or the error it raised."""
    outs = []
    for h in handles:
        try:
            outs.append(eng.wait(h, timeout=600))
        except Exception as e:  # noqa: BLE001 — the caller checks each
            outs.append(e)
    return outs


def same_replies(np, outs, refs):
    """True when every reply equals its reference (a prefix of it, when
    the reply is shorter: deterministic decode makes a shorter budget's
    reply an exact prefix of the longer one's)."""
    return all(isinstance(o, np.ndarray) and np.array_equal(o, r[: len(o)])
               for o, r in zip(outs, refs))


def qos_books(stats):
    return {k: stats[k] for k in ("preemptions", "resumes", "preempt_aborted",
                                  "swap_in_failures", "swapped_failed",
                                  "swapped_tokens", "forked_slots")}


def paired(books):
    return books["preemptions"] == (books["resumes"]
                                    + books["swap_in_failures"]
                                    + books["swapped_failed"])


def run_preemption(torch, np, lm, smi, paging):
    """15a: 8 priority-0 requests fill the bank, 4 priority-2 ones arrive
    once all 8 decode; with ``QosPolicy(preempt=True)`` and without a
    policy, in turns (``ab_turns``), each engine fresh."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.serving import QosPolicy

    lo, hi = qos_mix(np)
    reqs = lo + hi
    runs = {"qos": [], "plain": []}
    counts_all, refs = [], None
    for mode in ab_turns("qos", "plain"):
        eng = qos_engine(lm, qos=QosPolicy(preempt=True)
                         if mode == "qos" else None)
        meter = swap_meter(eng)
        try:
            kernels.reset_launch_counts()
            with ProgramCalls() as calls:
                lh, hh, _, t0 = serve_qos(eng, lo, hi)
                outs = results(eng, lh + hh)
                secs = time.monotonic() - t0
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if refs is None:
                gap = check_replies(torch, np, lm, eng, outs, reqs,
                                    f"15a {mode}")
            stats = eng.stats()
        finally:
            eng.stop()
        want = calls.ln_launches([lm])
        check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
              f"15a {mode}: B7 {counts['layernorm_fwd']}, the program calls "
              f"imply {want}; B4 {counts['flash_fwd']}")
        if refs is None:
            refs = outs
        check(same_replies(np, outs, refs) and all(
            len(o) == len(r) for o, r in zip(outs, refs)),
              f"15a {mode}: a reply differs from the first run's")
        books = qos_books(stats)
        lo_done = min(h.finished for h in lh)
        hi_done = max(h.finished for h in hh)
        if mode == "qos":
            check(hi_done < lo_done,
                  "15a: a priority-0 request finished before a priority-2 one")
            check(books["preemptions"] >= 4
                  and books["preemptions"] == books["resumes"]
                  and books["preempt_aborted"] == 0,
                  f"15a: preemption books {books}")
            check(stats["compiles"]["storms"] == 0,
                  f"15a: {stats['compiles']['storms']} storms after the warm "
                  f"set")
        counts_all.append(counts)
        tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
        ttft = sorted(h.latency()["ttft"] for h in hh)
        runs[mode].append({
            "seconds": secs, "tokens": tokens, "tokens_per_s": tokens / secs,
            "hi_ttft_p50_s": (ttft[1] + ttft[2]) / 2,
            "hi_last_finish_minus_first_lo_finish_s": hi_done - lo_done,
            "books": books, "launches": counts,
            "swap_out_ms": [s * 1e3 for s in meter["out_s"]],
            "swap_in_ms": [s * 1e3 for s in meter["in_s"]],
            "swap_bytes": meter["bytes"], "swap_tokens": meter["tokens"],
            "steps": stats["steps"], "storms": stats["compiles"]["storms"],
            "exhaustions": stats["paged"]["exhaustions"],
        })
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    q, p = runs["qos"], runs["plain"]
    res = {
        "turns": runs, "max_argmax_gap": gap,
        "qos_tokens_per_s": mean([r["tokens_per_s"] for r in q]),
        "plain_tokens_per_s": mean([r["tokens_per_s"] for r in p]),
        "paged_mix_tokens_per_s_13a": paging["paged_mix"]["tokens_per_s"],
        "hi_ttft_p50_qos_s": [r["hi_ttft_p50_s"] for r in q],
        "hi_ttft_p50_plain_s": [r["hi_ttft_p50_s"] for r in p],
        "swap_out_ms_mean": mean(q[0]["swap_out_ms"]),
        "swap_in_ms_mean": mean(q[0]["swap_in_ms"]),
        "swap_bytes_mean": mean(q[0]["swap_bytes"]),
    }
    log(f"15a preemption: {[r['books']['preemptions'] for r in q]} "
        f"preemptions = resumes, 0 aborts, 0 storms; priority-2 TTFT p50 "
        f"{res['hi_ttft_p50_qos_s']} s with the "
        f"policy, {res['hi_ttft_p50_plain_s']} s without (in turns); swap-out"
        f" {res['swap_out_ms_mean']:.2f} ms, swap-in "
        f"{res['swap_in_ms_mean']:.2f} ms host wall, "
        f"{res['swap_bytes_mean'] / 1e6:.2f} MB a swap "
        f"({q[0]['swap_tokens']} tokens); tokens/s {res['qos_tokens_per_s']:.1f}"
        f" with the policy, {res['plain_tokens_per_s']:.1f} without, 13a's "
        f"paged mix {res['paged_mix_tokens_per_s_13a']:.1f}; replies equal "
        f"in every turn, argmax gap {gap:.2e}; B7 "
        f"{[c['layernorm_fwd'] for c in counts_all]} on {smi}")
    return res, counts_all, refs


def wfq_mix(np):
    """15b's traffic: 16 requests each of tenants ``gold`` and ``bronze``,
    interleaved, prompts 32-64 tokens from ``default_rng(151)``, 64 new."""
    rng = np.random.default_rng(151)
    return [(rng.integers(0, 8192, int(rng.integers(32, 65))).astype(np.int32),
             64, None, t) for _ in range(16) for t in ("gold", "bronze")]


def run_wfq(torch, np, lm, smi):
    """15b: gold (weight 3) and bronze (weight 1) each submit 16 requests
    at once, with the policy and without one; gold's share of the tokens
    emitted while both tenants were backlogged (each had a request waiting
    for admission)."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import QosPolicy

    reqs = wfq_mix(np)
    out, counts_all = {}, []
    for mode in ("qos", "plain"):
        qos = (QosPolicy(weights={"gold": 3.0, "bronze": 1.0}, preempt=False)
               if mode == "qos" else None)
        eng = hooked_engine(lm, qos=qos)
        handles, snaps = [], []

        def note(ctx):
            # the scheduler thread, at each step dispatch: per tenant the
            # tokens emitted so far and whether a request still waits in
            # the queue (not yet admitted): the tenant is backlogged
            row = {}
            for h in handles:
                t = row.setdefault(h.tenant, [0, False])
                t[0] += len(h.tokens)
                t[1] = t[1] or h.started is None
            snaps.append(row)
            return False

        try:
            kernels.reset_launch_counts()
            with ProgramCalls() as calls, FaultPlan().arm(
                    "stepper.step", times=None, when=note):
                t0 = time.monotonic()
                handles.extend(eng.submit(p, n, sampling=s, tenant=t)
                               for p, n, s, t in reqs)
                outs = results(eng, handles)
                secs = time.monotonic() - t0
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            gap = argmax_gap(torch, np, lm, outs, [r[:3] for r in reqs])
        finally:
            eng.stop()
        want = calls.ln_launches([lm])
        check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
              f"15b {mode}: B7 {counts['layernorm_fwd']}, the program calls "
              f"imply {want}")
        check(all(isinstance(o, np.ndarray) and len(o) == len(p) + n
                  for o, (p, n, _, _) in zip(outs, reqs))
              and gap <= LOGIT_TOL, f"15b {mode}: token bars (gap {gap})")
        both = {"gold": 0, "bronze": 0}
        for a, b in zip(snaps, snaps[1:]):
            if all(a.get(t, [0, False])[1] for t in both):
                for t in both:
                    both[t] += b[t][0] - a[t][0]
        share = both["gold"] / max(1, sum(both.values()))
        out[mode] = {"gold_share_backlogged": share, "tokens_backlogged": both,
                     "tokens_per_s": sum(n for _, n, _, _ in reqs) / secs,
                     "seconds": secs, "max_argmax_gap": gap,
                     "launches": counts}
        counts_all.append(counts)
    check(out["qos"]["gold_share_backlogged"] >= 0.6,
          f"15b: gold's share {out['qos']['gold_share_backlogged']:.3f} < 0.6")
    log(f"15b WFQ: gold's share of the tokens emitted while both tenants "
        f"were backlogged {out['qos']['gold_share_backlogged']:.3f} with "
        f"weights 3:1 ({out['qos']['tokens_backlogged']}), "
        f"{out['plain']['gold_share_backlogged']:.3f} without a policy; "
        f"tokens/s {out['qos']['tokens_per_s']:.1f} / "
        f"{out['plain']['tokens_per_s']:.1f} on {smi}")
    return out, counts_all


def group_mix(np):
    """15c's traffic: 4 requests of n = 4 completions, temperature 0.8,
    seeds 150-153, prompts 64-200 tokens from ``default_rng(152)``, 48
    new."""
    rng = np.random.default_rng(152)
    return [(rng.integers(0, 8192, int(rng.integers(64, 201))).astype(np.int32),
             48, {"temperature": 0.8, "seed": 150 + i, "n": 4})
            for i in range(4)]


def run_groups(torch, np, lm, smi):
    """15c: n = 4 completions through copy-on-write forks on a paged
    engine, against independent admissions under the derived seeds."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving.sampling import seed_for_completion

    groups = group_mix(np)
    eng = qos_engine(lm)
    st = eng._stepper
    handles, peak = [], {}

    def note(ctx):
        for h in handles:
            pages = {p for i, r in enumerate(eng.batcher._slots) if r is h
                     for p in st._tables[i]}
            peak[h.id] = max(peak.get(h.id, 0), len(pages))
        return False

    try:
        kernels.reset_launch_counts()
        with ProgramCalls() as calls, FaultPlan().arm(
                "stepper.step", times=None, when=note):
            t0 = time.monotonic()
            handles.extend(eng.submit(p, n, sampling=s) for p, n, s in groups)
            outs = results(eng, handles)
            secs = time.monotonic() - t0
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        stats = eng.stats()
        singles = [(p, n, {"temperature": 0.8,
                           "seed": seed_for_completion(s["seed"], j)})
                   for p, n, s in groups for j in range(4)]
        single_outs, _ = serve_mix(eng, singles)
        # one page_cow between two free pages (a copy of a page onto
        # itself is skipped), the engine idle
        a, b = st._kv_alloc.alloc(2, reason="probe")
        cow_ms = device_time_ms(lambda: st._page_copy(a, b))
        st._kv_alloc.free([a, b], reason="probe")
    finally:
        eng.stop()
    want = calls.ln_launches([lm])
    check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
          f"15c: B7 {counts['layernorm_fwd']}, the program calls imply "
          f"{want}; B4 {counts['flash_fwd']}")
    check(all(isinstance(o, list) and len(o) == 4 for o in outs),
          f"15c: a group did not return 4 sequences: {outs[:1]}")
    flat = [c for o in outs for c in o]
    check(all(np.array_equal(a, b) for a, b in zip(flat, single_outs)),
          "15c: a completion differs from its independent admission")
    partial = sum(3 for p, _, _ in groups if (len(p) - 1) % 16)
    check(stats["forked_slots"] == 12,
          f"15c: serving_forked_slots {stats['forked_slots']} != 12")
    check(stats["paged"]["cow_copies"] == partial,
          f"15c: {stats['paged']['cow_copies']} CoW copies, {partial} forks "
          f"had a partial frontier page")
    per = {h.id: 4 * st.pages_for(len(p), n)
           for h, (p, n, _) in zip(handles, groups)}
    check(all(peak[k] < per[k] for k in per),
          f"15c: a group's peak pages {peak} not below n x pages_for {per}")
    res = {
        "seconds": secs, "tokens": sum(len(c) - len(p) for o, (p, _, _)
                                       in zip(outs, groups) for c in o),
        "forked_slots": stats["forked_slots"],
        "cow_copies": stats["paged"]["cow_copies"],
        "forks_with_partial_frontier": partial,
        "per_fork_shared_pages": [(len(p) - 1) // 16 for p, _, _ in groups],
        "per_fork_fresh_pages": [st.fork_pages_for(len(p), n)
                                 for p, n, _ in groups],
        "group_peak_pages": [peak[h.id] for h in handles],
        "n_times_pages_for": [per[h.id] for h in handles],
        "page_cow_device_ms": cow_ms, "launches": counts,
    }
    res["tokens_per_s"] = res["tokens"] / secs
    log(f"15c groups: 16 completions equal their independent admissions; "
        f"forked slots 12, CoW copies {res['cow_copies']} (= forks with a "
        f"partial frontier page); per fork shared pages "
        f"{res['per_fork_shared_pages']}, fresh "
        f"{res['per_fork_fresh_pages']}; group peak pages "
        f"{res['group_peak_pages']} against n x pages_for "
        f"{res['n_times_pages_for']}; page_cow {cow_ms * 1e3:.2f} us device; "
        f"{res['tokens_per_s']:.1f} tokens/s on {smi}")
    return res, counts, outs


def run_spec_fork_swap(torch, np, lm, smi, lo_refs, group_outs):
    """15d: on a paged n-gram engine (``draft_k=4``) with the policy, an
    n = 2 group and six of 15a's priority-0 requests (64 new) fill the
    bank, one of 15a's priority-2 requests preempts a speculative slot:
    every reply equals 15a's and 15c's non-speculative engines'."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.serving import QosPolicy

    lo, hi = qos_mix(np)
    lo6 = [(p, 64, s) for p, _, s in lo[:6]]
    g0 = group_mix(np)[0]
    group = (g0[0], g0[1], {**g0[2], "n": 2})
    eng = qos_engine(lm, qos=QosPolicy(preempt=True), speculative="ngram",
                     draft_k=4)
    try:
        kernels.reset_launch_counts()
        with ProgramCalls() as calls:
            lh, hh, gh, _ = serve_qos(eng, lo6, hi[:1], [group])
            outs = results(eng, lh + hh + gh)
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        stats = eng.stats()
    finally:
        eng.stop()
    want = calls.ln_launches([lm])
    check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
          f"15d: B7 {counts['layernorm_fwd']}, the program calls imply "
          f"{want}")
    books = qos_books(stats)
    check(same_replies(np, outs[:7], lo_refs[:6] + lo_refs[8:9]),
          "15d: a reply differs from 15a's")
    check(isinstance(outs[7], list) and same_replies(
        np, outs[7], group_outs[0][:2]), "15d: the group differs from 15c's")
    check(books["preemptions"] >= 1 and paired(books)
          and books["forked_slots"] == 1, f"15d: books {books}")
    res = {"books": books, "speculative": spec_books(stats),
           "launches": counts}
    log(f"15d fork and swap under speculation: replies equal 15a's and "
        f"15c's; books {books}; speculative {res['speculative']} on {smi}")
    return res, counts


def run_qos_faults(torch, np, lm, smi, lo_refs, group_outs):
    """15e: ``kv.swap`` seams on each direction, a stop with a request
    swapped out, and the n-completion reply and QoS header over TCP."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import (
        EngineStoppedError,
        InternalError,
        QosPolicy,
        ServingClient,
        ServingServer,
    )

    lo, hi = qos_mix(np)
    lo8 = [(p, 64, s) for p, _, s in lo]
    refs = lo_refs[:8] + lo_refs[8:9]
    res, counts_all = {}, []
    for direction in ("out", "in"):
        eng = qos_engine(lm, qos=QosPolicy(preempt=True))
        plan = FaultPlan(seed=0).arm(
            "kv.swap", times=1,
            when=lambda ctx, d=direction: ctx.get("direction") == d)
        try:
            kernels.reset_launch_counts()
            with ProgramCalls() as calls, plan:
                lh, hh, _, _ = serve_qos(eng, lo8, hi[:1])
                outs = results(eng, lh + hh)
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            stats = eng.stats()
        finally:
            eng.stop()
        want = calls.ln_launches([lm])
        check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
              f"15e {direction}: B7 {counts['layernorm_fwd']}, the program "
              f"calls imply {want}")
        books = qos_books(stats)
        if direction == "out":
            check(same_replies(np, outs, refs) and books["preempt_aborted"]
                  == 1 and books["preemptions"] >= 1 and paired(books),
                  f"15e out: an aborted swap-out changed a reply, or books "
                  f"{books}")
        else:
            failed = [i for i, o in enumerate(outs)
                      if not isinstance(o, np.ndarray)]
            check(len(failed) == 1 and isinstance(outs[failed[0]],
                                                  InternalError)
                  and same_replies(np, [o for i, o in enumerate(outs)
                                        if i not in failed],
                                   [r for i, r in enumerate(refs)
                                    if i not in failed])
                  and books["swap_in_failures"] == 1 and paired(books),
                  f"15e in: {[type(o).__name__ for o in outs]}, books {books}")
        res[direction] = {"books": books, "fired": plan.fired("kv.swap")}
        counts_all.append(counts)
    # stop with a request swapped out
    eng = qos_engine(lm, qos=QosPolicy(preempt=True))
    try:
        lh, hh, _, _ = serve_qos(eng, lo8, hi[:1])
        wait_for(lambda: any(h._swap is not None for h in lh),
                 "a swapped-out request")
        swapped = next(h for h in lh if h._swap is not None)
    finally:
        eng.stop(drain=False)
    books = qos_books(eng.batcher.stats())
    try:
        swapped.result(0)
        typed = False
    except EngineStoppedError:
        typed = True
    check(typed and swapped._swap is None and paired(books)
          and books["swapped_failed"] >= 1,
          f"15e stop: typed {typed}, books {books}")
    res["stop"] = {"books": books}
    # the wire: n = 3 and the QoS header
    eng = qos_engine(lm)
    seen = []
    submit0 = eng.batcher.submit

    def spy(req):
        out = submit0(req)
        seen.extend((r["tenant"], r["priority"])
                    for r in eng.batcher.inflight_snapshot())
        return out

    eng.batcher.submit = spy
    srv = ServingServer(eng).start()
    p, n, s = group_mix(np)[0]
    try:
        kernels.reset_launch_counts()
        with ServingClient(srv.host, srv.port, connect_timeout=5) as c:
            wire = c.generate(p, n, sampling={**s, "n": 3}, tenant="gold",
                              priority=1)
        counts = kernels.launch_counts()
    finally:
        srv.shutdown()
        eng.stop()
    check(isinstance(wire, list) and len(wire) == 3
          and all(np.array_equal(a, b) for a, b in zip(wire, group_outs[0])),
          "15e wire: the n = 3 reply differs from 15c's in-process group")
    check(("gold", 1) in seen, f"15e wire: the snapshot showed {seen}")
    counts_all.append(counts)
    res["wire"] = {"n": len(wire), "snapshot": sorted(set(seen))}
    log(f"15e faults: an aborted swap-out ({res['out']['books']}) left every"
        f" reply equal; a failed swap-in failed its request alone, typed "
        f"internal ({res['in']['books']}); stop() with a request swapped out "
        f"failed it typed ({res['stop']['books']}); n = 3 over TCP equal "
        f"15c's, tenant/priority in the snapshot {res['wire']['snapshot']} "
        f"on {smi}")
    return res, counts_all


def run_beam(torch, np, lm, smi):
    """15f: ``BeamSearchGenerator`` on the LN-hooked LM, 4 prompts of 64
    tokens from ``default_rng(153)``, 32 steps."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.predictors import (
        BeamSearchGenerator,
        CachedSequenceGenerator,
    )

    prompts = np.random.default_rng(153).integers(0, 8192, (4, 64))
    steps, blocks = 32, len(lm.layers) - 3
    detach_hooks(lm)
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    greedy = CachedSequenceGenerator(lm).generate(prompts, steps)
    res, counts_all, outs = {}, [], {}
    for width in (1, 4):
        gen = BeamSearchGenerator(lm, beam_width=width)
        gen.generate(prompts, 2)  # first-call costs off the clock
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        outs[width] = gen.generate(prompts, steps)
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
        want = steps * (2 * blocks + 1) + 2 * blocks
        check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
              f"15f width {width}: B7 {counts['layernorm_fwd']}, want {want}")
        res[width] = {"seconds": secs, "tokens_per_s": 4 * steps / secs,
                      "scores": gen.last_scores.tolist(), "launches": counts}
        counts_all.append(counts)
    check(np.array_equal(outs[1], greedy),
          "15f: beam_width=1 differs from greedy cached decode")
    detach_hooks(lm)
    plain = BeamSearchGenerator(lm, beam_width=4)
    plain_out = plain.generate(prompts, steps)
    attach_fused_layernorm(lm)
    rel = float(np.max(np.abs(np.asarray(res[4]["scores"])
                              - plain.last_scores)
                       / np.abs(plain.last_scores)))
    check(np.array_equal(outs[4], plain_out) and rel <= 1e-4,
          f"15f: width 4 differs from the plain path (scores rel {rel})")
    res["scores_max_rel_err"] = rel
    log(f"15f beam search: width 1 = greedy decode, width 4 = the plain "
        f"path's sequences (scores within {rel:.1e} relative); B7 "
        f"{want} a generate (17 a step + 16 for the prefill); tokens/s "
        f"{res[1]['tokens_per_s']:.1f} at width 1, "
        f"{res[4]['tokens_per_s']:.1f} at width 4 on {smi}")
    return res, counts_all


def run_phase15(torch, np, lm, smi, paging):
    """Phase 15, QoS, KV swap, CoW forks and beam search on the card;
    returns the results and the launch counts of each subphase's main
    path."""
    out = {}
    t0 = time.monotonic()
    out["preemption"], c_a, refs = run_preemption(torch, np, lm, smi, paging)
    out["wfq"], c_b = run_wfq(torch, np, lm, smi)
    out["groups"], c_c, group_outs = run_groups(torch, np, lm, smi)
    out["spec_fork_swap"], c_d = run_spec_fork_swap(torch, np, lm, smi, refs,
                                                    group_outs)
    out["faults"], c_e = run_qos_faults(torch, np, lm, smi, refs, group_outs)
    out["beam"], c_f = run_beam(torch, np, lm, smi)
    detach_hooks(lm)
    out["seconds_total"] = time.monotonic() - t0
    counts = [*c_a, *c_b, c_c, c_d, *c_e, *c_f]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ----------------------------------------------------------------- phase 16


KV16_TOKEN_AGREEMENT = 0.9  # bf16 vs f32 greedy tokens (JAX's own bar)
GRAMMAR_EOS = 8191
# the shed gate's CoDel knobs: the defaults JAX's tests drive
SHED_TARGET_MS, SHED_INTERVAL_MS = 50.0, 500.0


def cached_forced_logits(torch, np, gen, seq, plen, chunked):
    """Teacher-forced logits at positions ``plen - 1 .. len(seq) - 2``
    through ``gen``'s cached bodies, K/V in its ``kv_dtype``, the way the
    engine computed them: the prompt prefix by ``_prefill`` (its own f32
    K/V, the dense whole-prompt admission) or, ``chunked``, by
    ``_stage_chunk`` like every other position (cache K/V read back)."""
    dev = gen.device
    t = len(seq) - 1
    toks = torch.as_tensor(np.asarray(seq[:t], np.int64), device=dev)[None]
    caches = gen.new_caches(1, t)
    start = 0 if chunked else plen - 1
    with torch.no_grad():
        if start >= 1:
            gen._prefill(caches, gen.embed(toks[:, :start],
                                           torch.arange(start, device=dev)))
        pos = torch.arange(start, t, device=dev)
        x = gen.embed(toks[:, start:], pos)
        qmask = torch.arange(t, device=dev)[None, :] <= pos[:, None]
        for (blk, moe), (ck, cv) in zip(gen._stages, caches):
            x = gen._stage_chunk(blk, moe, x, ck, cv, start, qmask)
        lg = gen._head(gen._final_ln(x))[0]
    return lg[plen - 1 - start:].float().cpu().numpy()


def kv_argmax_gap(torch, np, lm, outs, reqs, kv_dtype, chunked):
    """The largest gap between the best teacher-forced logit of the
    ``kv_dtype`` cached path (plain LayerNorm) and the chosen token's, over
    every greedy token of ``outs``."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    detach_hooks(lm)
    gen = CachedSequenceGenerator(lm, kv_dtype=kv_dtype)
    worst = 0.0
    for o, (p, _, s) in zip(outs, reqs):
        if s is not None:
            continue
        lg = cached_forced_logits(torch, np, gen, o, len(p), chunked)
        nxt = o[len(p):]
        worst = max(worst, float((lg.max(-1)
                                  - lg[np.arange(len(nxt)), nxt]).max()))
    attach_fused_layernorm(lm)
    return worst


def run_kv_dtype_mix(torch, np, lm, smi, gen_reqs):
    """16a: phase 4's 16-request mix on fresh dense and paged engines with
    f32 and bf16 caches, in turns (``ab_turns``) per layout. Dense
    engines admit each prompt whole (``prefill_chunk=None``), so the
    teacher-forced reference runs their prefill; paged ones chunk."""
    from distkeras_tpu_torch import kernels

    out, counts_all = {}, []
    for layout in ("dense", "paged"):
        kw = ({"prefill_chunk": None} if layout == "dense"
              else {"paged": True})
        runs = {"float32": [], "bfloat16": []}
        outs = {}
        for dtn in ab_turns("float32", "bfloat16"):
            dt = getattr(torch, dtn)
            eng = hooked_engine(lm, kv_dtype=dt, prefix_cache=False, **kw)
            try:
                kernels.reset_launch_counts()
                with ProgramCalls() as calls:
                    o, secs = serve_mix(eng, gen_reqs)
                    torch.cuda.synchronize()
                counts = kernels.launch_counts()
                kv_bytes = eng._stepper.kv_bytes_total()
                replay = [(a, eng.generate(p, n, sampling=s, timeout=600))
                          for a, (p, n, s) in zip(o, gen_reqs)
                          if s is not None]
            finally:
                eng.stop()
            want = calls.ln_launches([lm])
            check(counts["layernorm_fwd"] == want
                  and counts["flash_fwd"] == 0,
                  f"16a {layout} {dtn}: B7 {counts['layernorm_fwd']}, the "
                  f"program calls imply {want}")
            check(all(isinstance(a, np.ndarray) and len(a) == len(p) + n
                      for a, (p, n, _) in zip(o, gen_reqs)),
                  f"16a {layout} {dtn}: a request did not finish")
            check(all(np.array_equal(a, b) for a, b in replay),
                  f"16a {layout} {dtn}: a sampled request did not replay")
            if dtn in outs:
                check(all(np.array_equal(a, b)
                          for a, b in zip(o, outs[dtn])),
                      f"16a {layout} {dtn}: replies differ between turns")
            outs[dtn] = o
            tokens = sum(len(a) - len(p) for a, (p, _, _) in zip(o, gen_reqs))
            runs[dtn].append({"seconds": secs, "tokens_per_s": tokens / secs,
                              "kv_bytes_total": kv_bytes,
                              "launches": counts})
            counts_all.append(counts)
        check(runs["bfloat16"][0]["kv_bytes_total"] * 2
              == runs["float32"][0]["kv_bytes_total"],
              f"16a {layout}: kv_bytes_total {runs['bfloat16'][0]} is not "
              f"half of {runs['float32'][0]}")
        greedy = [i for i, r in enumerate(gen_reqs) if r[2] is None]
        agree = token_agreement(
            np, [outs["bfloat16"][i] for i in greedy],
            [outs["float32"][i] for i in greedy],
            [gen_reqs[i] for i in greedy])
        check(agree >= KV16_TOKEN_AGREEMENT,
              f"16a {layout}: bf16/f32 greedy agreement {agree:.4f}")
        gap = kv_argmax_gap(torch, np, lm, outs["bfloat16"], gen_reqs,
                            torch.bfloat16, chunked=layout == "paged")
        check(gap <= LOGIT_TOL,
              f"16a {layout}: a bf16 greedy token is not the argmax of the "
              f"bf16 path's teacher-forced logits (gap {gap})")
        mean = lambda rs: sum(r["tokens_per_s"] for r in rs) / len(rs)  # noqa: E731
        out[layout] = {
            "turns": runs, "f32_tokens_per_s": mean(runs["float32"]),
            "bf16_tokens_per_s": mean(runs["bfloat16"]),
            "bf16_over_f32": mean(runs["bfloat16"]) / mean(runs["float32"]),
            "greedy_agreement": agree, "max_argmax_gap": gap,
            "kv_bytes_total": {k: v[0]["kv_bytes_total"]
                               for k, v in runs.items()},
        }
        log(f"16a {layout}: bf16 {out[layout]['bf16_tokens_per_s']:.1f} "
            f"tokens/s against f32 {out[layout]['f32_tokens_per_s']:.1f} "
            f"(in turns; {out[layout]['bf16_over_f32']:.3f}x); greedy "
            f"agreement {agree:.4f}; bf16 argmax gap {gap:.2e}; "
            f"kv_bytes_total {out[layout]['kv_bytes_total']} on {smi}")
    return out, counts_all


def admit_chunked(st, slot, prompt, budget=128, **kw):
    """``begin_admit`` plus ``prefill_chunk(budget)`` until decodable."""
    left = st.begin_admit(slot, prompt, **kw)
    while left > 0:
        left = st.prefill_chunk(slot, budget)


def run_kv_rows(torch, np, lm, smi):
    """16a's host rows: on dense and paged 8-slot steppers with bf16 and
    f32 caches, a 200-token prompt admitted in 128-position chunks; its
    prefix-store entry (two-touch insert, then a 128-token hit restored
    into another slot, the paged device index cleared so the host rows are
    the source) and a swap-out / swap-in of a decoding slot round-trip bit
    for bit, the bf16 rows hold half the f32 bytes, and the restored and
    resumed slots decode the tokens of the slot they copy."""
    from distkeras_tpu_torch.serving import PrefixStore
    from distkeras_tpu_torch.serving.engine import DecodeStepper

    prompt = np.random.default_rng(161).integers(0, 8192, 200)
    out = {}
    for layout in ("dense", "paged"):
        books = {}
        for dtn in ("bfloat16", "float32"):
            store = PrefixStore(max_bytes=256 << 20)
            st = DecodeStepper(lm, num_slots=8, paged=layout == "paged",
                               kv_dtype=getattr(torch, dtn),
                               prefix_cache=store)
            admit_chunked(st, 0, prompt, max_new=24)  # first touch: no insert
            st.release(0)
            if st.paged:
                st.prefix_index.clear()  # the same programs again
            admit_chunked(st, 0, prompt, max_new=24)  # inserts the ladder
            hit = store.lookup(prompt[:-1])
            check(hit is not None and hit[0] == 128,
                  f"16a rows {layout} {dtn}: no 128-token hit ({hit})")
            if st.paged:
                st.prefix_index.clear()  # the host rows, not shared pages
            admit_chunked(st, 1, prompt, max_new=24)  # restores the hit
            back = st._fetch_rows(1, 128)
            exact = all(np.array_equal(k, bk) and np.array_equal(v, bv)
                        for (k, v), (bk, bv) in zip(hit[1], back))
            act = np.zeros(8, bool)
            act[[0, 1]] = True
            both = [st.step(act) for _ in range(16)]
            restored_same = all(t[0] == t[1] for t in both)
            state = st.swap_out(1)
            st.release(1)
            st.swap_in(2, state, max_new=8)
            again = st.swap_out(2)
            swap_exact = all(
                np.array_equal(k, k2) and np.array_equal(v, v2)
                for (k, v), (k2, v2) in zip(state["kv"], again["kv"]))
            act = np.zeros(8, bool)
            act[[0, 2]] = True
            after = [st.step(act) for _ in range(8)]
            resumed_same = all(t[0] == t[2] for t in after)
            books[dtn] = {
                "entry_bytes": store.stats()["bytes"],
                "row_dtype": str(hit[1][0][0].dtype),
                "swap_bytes": state_bytes(state),
                "restore_bit_exact": exact, "restored_equals": restored_same,
                "swap_bit_exact": swap_exact, "resumed_equals": resumed_same,
            }
            del st
        b, f = books["bfloat16"], books["float32"]
        check(b["row_dtype"] == "uint16" and f["row_dtype"] == "float32",
              f"16a rows {layout}: row dtypes {b['row_dtype']}, "
              f"{f['row_dtype']}")
        check(b["entry_bytes"] * 2 == f["entry_bytes"],
              f"16a rows {layout}: store bytes {b['entry_bytes']} vs "
              f"{f['entry_bytes']}")
        check(all(v for k, v in b.items() if isinstance(v, bool))
              and all(v for k, v in f.items() if isinstance(v, bool)),
              f"16a rows {layout}: {books}")
        out[layout] = books
        log(f"16a rows {layout}: prefix entry {b['entry_bytes']} bytes bf16 "
            f"/ {f['entry_bytes']} f32, swap state {b['swap_bytes']} / "
            f"{f['swap_bytes']} bytes; restore and swap bit-exact, replies "
            f"equal on {smi}")
    return out


GRAMMARS = (
    {"kind": "allow", "tokens": list(range(100, 150)) + [7000, 7001]},
    {"kind": "sequence", "steps": [[10, 11], [12], [13, 14, 15], [16]]},
    {"kind": "sequence", "steps": [[20, 21, 22], [23]], "loop": True},
    {"kind": "choice", "sequences": [[300, 301, 302], [300, 303],
                                     [304, 305, 306, 307], [308]]},
    {"kind": "fsm", "start": "s",
     "states": {"s": {"400": "a", "401": "s"}, "a": {"402": "b"},
                "b": {"403": "s", "404": "b"}},
     "accept": ["b"]},
)


def grammar_walk_ok(spec, toks, eos=GRAMMAR_EOS):
    """A host walk of ``spec`` over the emitted ``toks``, written apart from
    ``TokenMaskCompiler``: True when every token is one the spec allows
    where it stands, and an eos only where the spec may finish (and last)."""
    kind = spec["kind"]
    toks = [int(t) for t in toks]
    state = spec.get("start")
    for j, t in enumerate(toks):
        if kind == "allow":
            ok = t in spec["tokens"] or t == eos
        elif kind == "sequence":
            steps, done = spec["steps"], j >= len(spec["steps"])
            if done and not spec.get("loop"):
                ok = t == eos
            else:
                ok = t in steps[j % len(steps)] or (t == eos and done)
        elif kind == "choice":
            live = [q for q in spec["sequences"] if q[:j] == toks[:j]]
            ok = (any(len(q) > j and q[j] == t for q in live)
                  or (t == eos and any(len(q) == j for q in live)))
        else:
            edges = spec["states"].get(state, {})
            if str(t) in edges:
                ok, state = True, edges[str(t)]
            else:
                ok = t == eos and state in spec["accept"]
        if not ok:
            return False
        if t == eos:
            return j == len(toks) - 1
    return True


def grammar_mix(np):
    """16b's traffic: 16 requests, prompts 16-128 tokens from
    ``default_rng(162)``, 32 new; the even ones constrained (each grammar
    kind, every other one sampled, eos 8191), the odd ones not (every
    fourth sampled)."""
    rng = np.random.default_rng(162)
    reqs = []
    for i in range(16):
        p = rng.integers(0, 8192, int(rng.integers(16, 129))).astype(np.int32)
        if i % 2 == 0:
            s = {"grammar": GRAMMARS[(i // 2) % len(GRAMMARS)]}
            if i % 4 == 2:
                s.update(temperature=0.9, seed=500 + i)
        else:
            s = {"temperature": 0.8, "seed": 600 + i} if i % 4 == 3 else None
        reqs.append((p, 32, s))
    return reqs


def serve_eos(eng, reqs):
    """Submit ``reqs`` at once, constrained ones with ``GRAMMAR_EOS``; the
    replies (or the error each raised)."""
    hs = [eng.submit(p, n, sampling=s,
                     eos_id=GRAMMAR_EOS if s and "grammar" in s else None)
          for p, n, s in reqs]
    return results(eng, hs)


def grammar_engine(lm, **kw):
    """A fresh LN-hooked engine with every program family warmed, the
    masked ones included, and the warm set declared."""
    eng = hooked_engine(lm, prefix_cache=False, **kw)
    st = eng._stepper
    st.warm_prefill_buckets()
    st.warm_restore_buckets()
    st.warm_constrained_buckets()
    eng.compile_ledger.mark_warmed()
    return eng


def run_grammar_mix(torch, np, lm, smi):
    """16b: the 16-request mix (8 constrained) on fresh dense, paged and
    n-gram speculative engines, the paged one with a constrained sampled
    ``n = 3`` request too; then the unconstrained 8 alone on the same
    engine."""
    from distkeras_tpu_torch import kernels

    reqs = grammar_mix(np)
    free = [i for i, (_, _, s) in enumerate(reqs)
            if s is None or "grammar" not in s]
    group = (reqs[0][0], 24, {"grammar": GRAMMARS[0], "temperature": 1.0,
                              "seed": 77, "n": 3})
    out, counts_all, ref = {}, [], None
    for mode in ("dense", "paged", "ngram"):
        kw = {"dense": {}, "paged": {"paged": True},
              "ngram": {"speculative": "ngram", "draft_k": 4}}[mode]
        eng = grammar_engine(lm, **kw)
        mix = reqs + ([group] if mode == "paged" else [])
        try:
            kernels.reset_launch_counts()
            with ProgramCalls() as calls:
                t0 = time.monotonic()
                outs = serve_eos(eng, mix)
                secs = time.monotonic() - t0
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            alone = serve_eos(eng, [reqs[i] for i in free])
            replay = [(o, eng.generate(p, n, sampling=s, timeout=600,
                                       eos_id=GRAMMAR_EOS))
                      for o, (p, n, s) in zip(outs, mix)
                      if s and "grammar" in s and "temperature" in s]
            led = eng.compile_ledger
            snap = led.snapshot()
            masked = [r for r in led.tail(led.total) if "masked" in r["key"]]
            st = eng.stats()
            masks = next(m["value"] for m in eng.metrics_snapshot()
                          if m["name"] == "serving_constrained_masks")
        finally:
            eng.stop()
        want = calls.ln_launches([lm])
        check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
              f"16b {mode}: B7 {counts['layernorm_fwd']}, the program calls "
              f"imply {want}")
        check(all(isinstance(o, (np.ndarray, list)) for o in outs),
              f"16b {mode}: a request failed: "
              f"{[o for o in outs if isinstance(o, Exception)][:2]}")
        bad = [i for i, (o, (p, _, s)) in enumerate(zip(outs, mix))
               if s and "grammar" in s and not all(
                   grammar_walk_ok(s["grammar"], c[len(p):])
                   for c in (o if isinstance(o, list) else [o]))]
        check(not bad, f"16b {mode}: requests {bad} left their grammar")
        check(all(np.array_equal(outs[i], a) for i, a in zip(free, alone)),
              f"16b {mode}: an unconstrained reply changed with "
              f"constrained neighbours")
        check(all(_same_reply(np, a, b) for a, b in replay),
              f"16b {mode}: a sampled constrained request did not replay")
        check(snap["storms"] == 0 and masked
              and all(r["trigger"] == "warmup" for r in masked),
              f"16b {mode}: storms {snap['storms']}, masked mints "
              f"{[(r['key'], r['trigger']) for r in masked]}")
        if ref is None:
            ref = outs
        else:
            check(all(_same_reply(np, a, b) for a, b in zip(outs, ref)),
                  f"16b {mode}: replies differ from the dense engine's")
        tokens = sum(sum(len(c) - len(p) for c in (o if isinstance(o, list)
                                                   else [o]))
                     for o, (p, _, _) in zip(outs, mix))
        out[mode] = {
            "seconds": secs, "tokens": tokens, "tokens_per_s": tokens / secs,
            "constrained_masks": masks,
            "launches": counts, "masked_mints": [r["key"] for r in masked],
            "storms": snap["storms"],
            "speculative": spec_books(st) if mode == "ngram" else None,
        }
        counts_all.append(counts)
        log(f"16b {mode}: {tokens} tokens in {secs:.2f} s "
            f"({tokens / secs:.1f} tokens/s); every constrained token in its "
            f"grammar (host walk), unconstrained replies equal alone, "
            f"sampled replays equal, 0 storms, masked mints "
            f"{out[mode]['masked_mints']} in warm-up on {smi}")
    return out, counts_all, reqs, ref


def _same_reply(np, a, b):
    if isinstance(a, list) or isinstance(b, list):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)
                and all(np.array_equal(x, y) for x, y in zip(a, b)))
    return np.array_equal(a, b)


def run_grammar_edges(torch, np, lm, smi, reqs, ref):
    """16b's edges: a constrained slot swapped out and back in equals its
    uninterrupted decode; a dead-end grammar forces EOS and records
    ``sampling.mask_exhausted``; one constrained request over a
    ``ServingServer`` equals the in-process reply."""
    from distkeras_tpu_torch.obs import FlightRecorder
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingServer,
    )
    from distkeras_tpu_torch.serving.engine import DecodeStepper
    from distkeras_tpu_torch.serving.sampling import SamplingParams

    detach_hooks(lm)
    attach_fused_layernorm(lm)
    p, _, s = reqs[8]  # the fsm grammar, greedy
    rec = FlightRecorder()
    st = DecodeStepper(lm, num_slots=8, paged=True, recorder=rec)
    sp = SamplingParams(**s)
    for slot in (0, 1):
        st.admit(slot, p, sampling=sp, max_new=32, eos_id=GRAMMAR_EOS)
    act = np.zeros(8, bool)
    act[[0, 1]] = True
    toks = [st.step(act) for _ in range(2)]
    state = st.swap_out(1)
    st.release(1)
    st.swap_in(3, state, max_new=30)
    act[[1, 3]] = [False, True]
    toks += [st.step(act) for _ in range(3)]
    swapped_ok = all(t[0] == (t[1] if i < 2 else t[3])
                     for i, t in enumerate(toks))
    check(state["grammar"] is not None and swapped_ok,
          "16b: a constrained slot swapped out and back in diverged")
    dead = SamplingParams(grammar={"kind": "choice",
                                   "sequences": [[9000, 9001]]})
    st.admit(5, p, sampling=dead, max_new=4, eos_id=GRAMMAR_EOS)
    act = np.zeros(8, bool)
    act[5] = True
    forced = int(st.step(act)[5])
    events = [e for e in rec.snapshot()
              if e["kind"] == "sampling.mask_exhausted"]
    check(forced == GRAMMAR_EOS and events and st.mask_exhaustions >= 1,
          f"16b: dead-end grammar gave {forced}, events {events}")
    del st
    eng = grammar_engine(lm)
    srv = ServingServer(eng).start()
    try:
        with ServingClient(srv.host, srv.port, connect_timeout=5) as c:
            wire = c.generate(reqs[4][0], 32, sampling=reqs[4][2],
                              eos_id=GRAMMAR_EOS)
    finally:
        srv.shutdown()
        eng.stop()
    check(np.array_equal(wire, ref[4]),
          "16b: the constrained reply over the wire differs")
    res = {"swap_equal": swapped_ok, "forced_eos": forced,
           "mask_exhausted_events": len(events), "wire_equal": True}
    log(f"16b edges: a constrained slot swapped out after 2 tokens and back "
        f"in equals its twin; the dead-end grammar forced eos "
        f"{GRAMMAR_EOS} with {len(events)} sampling.mask_exhausted event(s);"
        f" the sequence grammar over TCP equals in process on {smi}")
    return res


def shed_mix(np):
    """16c's traffic from ``default_rng(163)``: a burst of 48 priority-0
    requests (prompts 16-48 tokens, 64 new), a trickle of priority-0 ones
    (16 tokens, 16 new) and 8 priority-1 ones (prompts 16-48, 32 new)."""
    rng = np.random.default_rng(163)

    def req(lo, hi, n):
        return (rng.integers(0, 8192, int(rng.integers(lo, hi))).astype(
            np.int32), n, None)

    burst = [req(16, 49, 64) for _ in range(48)]
    trickle = [req(16, 17, 16) for _ in range(64)]
    hi = [req(16, 49, 32) for _ in range(8)]
    return burst, trickle, hi


def run_shed(torch, np, lm, smi):
    """16c: ``ServingEngine(shed=...)`` under a burst the bank cannot drain
    within the CoDel interval: the gate latches, priority-0 arrivals are
    shed typed ``overloaded`` with the gate's hint, priority 1 rides
    through with the gate-less engine's replies; a declared rung-2
    brownout clamps to a prefix; the rung returns to 0; one shed over the
    wire.

    The trickle's prompts arrive in turn, 25 ms apart, until 8 are shed or
    the whole burst is admitted: the gate latches at the first admission
    that comes a full CoDel interval after the first late one, so how many
    arrivals that takes depends on the card's step time, not on the length
    of the trickle list."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingServer,
        ShedError,
    )

    burst, trickle, hi = shed_mix(np)
    plain = hooked_engine(lm, prefix_cache=False)
    try:
        refs = results(plain, [plain.submit(p, n) for p, n, _ in hi])
    finally:
        plain.stop()
    eng = hooked_engine(lm, prefix_cache=False, queue_capacity=512,
                        shed={"target_ms": SHED_TARGET_MS,
                              "interval_ms": SHED_INTERVAL_MS,
                              "burn_interval": 0.0})
    gate = eng.shed_gate
    sheds, rungs, kept, kept_reqs = [], [], [], []
    try:
        kernels.reset_launch_counts()
        with ProgramCalls() as calls:
            t0 = time.monotonic()
            bh = [eng.submit(p, n, priority=0) for p, n, _ in burst]
            hh = []
            for i in itertools.count():
                p, n, _ = trickle[i % len(trickle)]
                time.sleep(0.025)
                rungs.append((time.monotonic() - t0, gate.rung()))
                try:
                    kept.append(eng.submit(p, n, priority=0))
                    kept_reqs.append((p, n, None))
                except ShedError as e:
                    sheds.append(e.retry_after_ms)
                if not hh and gate.rung() >= 1:
                    hh = [eng.submit(p2, n2, priority=1) for p2, n2, _ in hi]
                if (len(sheds) >= 8 or all(h.started for h in bh)
                        or time.monotonic() - t0 > 120.0):
                    break
            if not hh:
                hh = [eng.submit(p2, n2, priority=1) for p2, n2, _ in hi]
            outs = results(eng, bh + kept + hh)
            secs = time.monotonic() - t0
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = max(r for _, r in rungs)
        # the rung returns to 0 once two intervals pass with no admission
        time.sleep(2.1 * SHED_INTERVAL_MS / 1e3)
        rung_after = gate.rung()
        fresh = eng.generate(hi[0][0], 4, priority=0, timeout=600)
        gauge = next(m["value"] for m in eng.metrics_snapshot()
                     if m["name"] == "serving_shed_rung")
        health_rung = eng.health()["shed"]["rung"]
        # a declared rung-2 brownout: priority 1 is clamped to a prefix
        gate.burn_fn = lambda: "spiking"
        clamped = eng.generate(hi[0][0], 32, priority=1, timeout=600)
        brown = (eng.health()["shed"]["rung"], gauge_of(eng))
        # a shed over the wire, with the gate's own hint
        gate.burn_fn = lambda: "burning"
        srv = ServingServer(eng, retry_after_ms=1.0).start()
        try:
            with ServingClient(srv.host, srv.port, retry=False,
                               connect_timeout=5) as c:
                try:
                    c.generate(hi[1][0], 4, priority=0)
                    wire = None
                except Exception as e:  # noqa: BLE001 — checked below
                    wire = (getattr(e, "code", None),
                            getattr(e, "retry_after", 0.0) * 1e3,
                            gate.retry_after_ms())
        finally:
            srv.shutdown()
        gate.burn_fn = eng.burn_verdict
        stats = eng.stats()
        state = gate.state()
    finally:
        eng.stop()
    want = calls.ln_launches([lm])
    check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
          f"16c: B7 {counts['layernorm_fwd']}, the program calls imply {want}")
    check(peak >= 1 and sheds, f"16c: the gate never shed (peak rung {peak})")
    check(all(25.0 <= h <= 5000.0 for h in sheds),
          f"16c: retry hints out of [25, 5000] ms: {sheds}")
    check(all(isinstance(o, np.ndarray) and len(o) == len(p) + n
              for o, (p, n, _) in zip(outs, burst + kept_reqs + hi)),
          "16c: a request other than the shed ones failed")
    check(all(np.array_equal(o, r) for o, r in zip(outs[-len(hi):], refs)),
          "16c: a priority-1 reply differs from the gate-less engine's")
    check(rung_after == 0 and gauge == health_rung == 0,
          f"16c: rung after the burst {rung_after}, gauge {gauge}, health "
          f"{health_rung}")
    check(len(clamped) == len(hi[0][0]) + 8
          and np.array_equal(clamped, refs[0][: len(clamped)])
          and brown == (2, 2),
          f"16c: the rung-2 clamp {len(clamped)} tokens, rungs {brown}")
    check(wire is not None and wire[0] == "overloaded"
          and abs(wire[1] - wire[2]) < 1e-6 and 25.0 <= wire[1] <= 5000.0,
          f"16c: the wire shed {wire}")
    check(stats["shed_overloaded"] == len(sheds) + 1
          and stats["shed_clamped"] == 1,
          f"16c: books {stats['shed_overloaded']} / {stats['shed_clamped']}")
    ttft = sorted(h.latency()["ttft"] for h in hh)
    res = {
        "sheds": len(sheds), "retry_after_ms": sheds, "peak_rung": peak,
        "rung_timeline": rungs, "admitted_trickle": len(kept),
        "seconds": secs, "hi_ttft_p50_s": ttft[len(ttft) // 2],
        "rung_after": rung_after, "gate_state": state, "wire": wire,
        "launches": counts,
    }
    log(f"16c shedding: peak rung {peak}, {len(sheds)} priority-0 arrivals "
        f"shed typed overloaded (retry_after_ms {min(sheds):.1f}-"
        f"{max(sheds):.1f}), {len(kept)} admitted; 8 priority-1 replies equal"
        f" the gate-less engine's (TTFT p50 {res['hi_ttft_p50_s']:.3f} s); "
        f"rung 0 after the burst; a rung-2 clamp gave an 8-token prefix; the"
        f" wire shed {wire}; {secs:.2f} s on {smi}")
    return res, counts


def gauge_of(eng):
    return next(m["value"] for m in eng.metrics_snapshot()
                if m["name"] == "serving_shed_rung")


def run_phase16(torch, np, lm, smi, gen_reqs):
    """Phase 16, bf16 K/V caches, grammar masks and load shedding on the
    card; returns the results and the launch counts of each subphase's
    main path."""
    out = {}
    t0 = time.monotonic()
    out["kv_dtype"], c_a = run_kv_dtype_mix(torch, np, lm, smi, gen_reqs)
    out["kv_rows"] = run_kv_rows(torch, np, lm, smi)
    out["grammar"], c_b, reqs, ref = run_grammar_mix(torch, np, lm, smi)
    out["grammar_edges"] = run_grammar_edges(torch, np, lm, smi, reqs, ref)
    out["shed"], c_c = run_shed(torch, np, lm, smi)
    detach_hooks(lm)
    out["seconds_total"] = time.monotonic() - t0
    counts = [*c_a, *c_b, c_c]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ------------------------------------------------------------------ phase 17


class TransferTap:
    """While active, the host wall of each ``kv_transfer.encode_state`` and
    ``decode_state`` call, of each ``DecodeStepper.swap_out`` (the export)
    and ``swap_in`` (the resume), of the server's ``prefill`` and
    ``kv.transfer`` handlers (keyed by the caller's ``request_id``), and
    each finished request's ``latency()`` by engine."""

    def __init__(self):
        self.seconds = {"encode": [], "decode": [], "swap_out": [],
                        "swap_in": []}
        self.server = {}  # (verb, request_id) -> seconds
        self.latency = {}  # id(engine) -> [(prefill_only, latency)]
        self._orig = []

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._orig.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        from distkeras_tpu_torch.serving import kv_transfer
        from distkeras_tpu_torch.serving.engine import (
            DecodeStepper,
            ServingEngine,
        )
        from distkeras_tpu_torch.serving.server import ServingServer

        def timed(key):
            def make(orig):
                def call(*a, **kw):
                    t0 = time.perf_counter()
                    try:
                        return orig(*a, **kw)
                    finally:
                        self.seconds[key].append(time.perf_counter() - t0)
                return call
            return make

        def handler(verb):
            def make(orig):
                def call(srv, header, payload, *a):
                    t0 = time.perf_counter()
                    try:
                        return orig(srv, header, payload, *a)
                    finally:
                        self.server[(verb, header.get("request_id"))] = (
                            time.perf_counter() - t0)
                return call
            return make

        def complete(orig):
            def call(eng, req):
                self.latency.setdefault(id(eng), []).append(
                    (req.prefill_only, req.latency()))
                return orig(eng, req)
            return call

        for name in ("encode_state", "decode_state"):
            self._wrap(kv_transfer, name, timed(name.split("_")[0]))
        for name in ("swap_out", "swap_in"):
            self._wrap(DecodeStepper, name, timed(name))
        self._wrap(ServingServer, "_prefill", handler("prefill"))
        self._wrap(ServingServer, "_transfer", handler("kv.transfer"))
        self._wrap(ServingEngine, "_complete", complete)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._orig):
            setattr(owner, name, orig)

    def lat(self, eng, key, prefill_only=False):
        return [lat[key] for po, lat in self.latency.get(id(eng), [])
                if po == prefill_only and lat[key] is not None]


def frame_payload_bytes(st, prompt_len):
    """A prefill frame's payload on stepper ``st``: the context row and each
    block's K and V rows of the ``prompt_len - 1`` written positions (at
    d512/L8 in f32, 32,768 bytes a position)."""
    row = st._nh * st._hd * st.kv_dtype.itemsize
    return 4 * prompt_len + 2 * len(st._gen._blocks) * (prompt_len - 1) * row


def wire_clients(srv, n=8):
    from distkeras_tpu_torch.serving import ServingClient

    return [ServingClient(srv.host, srv.port, timeout=600, connect_timeout=2)
            for _ in range(n)]


def wire_mix(np, srv, reqs):
    """The mix as ``generate`` from 8 client threads (one client each)."""
    clients = wire_clients(srv)
    try:
        t0 = time.monotonic()
        outs = fan_out([
            (lambda j=j: clients[j % 8].generate(reqs[j][0], reqs[j][1],
                                                 sampling=reqs[j][2]))
            for j in range(len(reqs))], 8)
        return outs, time.monotonic() - t0
    finally:
        for c in clients:
            c.close()


def handoff_mix(np, pre_srv, dec_srv, reqs, pushed):
    """17a's drive: the mix from 8 client threads through a prefill server
    and a decode server, relayed (``prefill``, then ``kv.transfer`` from
    the caller) or pushed (``prefill`` with ``push_to``). Returns (replies,
    seconds, one row a request: frame bytes and client round trips)."""
    from distkeras_tpu_torch.utils.serialization import (
        deserialize_params,
        serialize_params,
    )

    cps, cds = wire_clients(pre_srv), wire_clients(dec_srv)

    def job(j):
        p, n, s = reqs[j]
        hdr = {"verb": "prefill", "max_new_tokens": n, "request_id": j}
        if s is not None:
            hdr["sampling"] = s
        if pushed:
            hdr["push_to"] = [dec_srv.host, dec_srv.port]
        t0 = time.perf_counter()
        reply, body = cps[j % 8]._roundtrip(hdr, serialize_params(p))
        row = {"bytes": reply["transfer"]["bytes"],
               "prefill_rt_s": time.perf_counter() - t0}
        if pushed:
            check(reply.get("pushed") is True,
                  f"17a: request {j} was not pushed: "
                  f"{reply.get('push_error')} {reply.get('push_detail')}")
            return np.asarray(deserialize_params(body)), row
        t1 = time.perf_counter()
        reply, body = cds[j % 8]._roundtrip(
            {"verb": "kv.transfer", "max_new_tokens": n, "request_id": j},
            bytes(body))
        row["transfer_rt_s"] = time.perf_counter() - t1
        return np.asarray(deserialize_params(body)), row

    try:
        t0 = time.monotonic()
        res = fan_out([(lambda j=j: job(j)) for j in range(len(reqs))], 8)
        secs = time.monotonic() - t0
    finally:
        for c in cps + cds:
            c.close()
    return [r[0] for r in res], secs, [r[1] for r in res]


def counted(torch, lm, tag, fn):
    """Run ``fn`` with the launch counts reset and the stepper programs
    counted; B7 must have launched exactly what the programs imply (16 a
    prefill chunk, 17 a decode step of the hooked d512/L8) and B4 never.
    Returns (fn's result, counts)."""
    from distkeras_tpu_torch import kernels

    kernels.reset_launch_counts()
    with ProgramCalls() as calls:
        out = fn()
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = calls.ln_launches([lm])
    check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
          f"{tag}: B7 {counts['layernorm_fwd']} (B4 {counts['flash_fwd']}), "
          f"the program calls imply {want} B7")
    return out, counts


def same_outs(np, a, b):
    return len(a) == len(b) and all(
        isinstance(x, np.ndarray) and np.array_equal(x, y)
        for x, y in zip(a, b))


def run_handoff(torch, np, lm, smi, gen_reqs):
    """17a: phase 4's mix through a ``role="prefill"`` and a
    ``role="decode"`` engine, relayed and pushed, against a unified engine
    of the same layout and ``kv_dtype`` on the same admission path (dense
    admits each prompt whole, paged chunks), each behind its own
    ``ServingServer``; dense with f32 caches and paged with bf16. The dense f32
    servers are returned alive for 17c."""
    from distkeras_tpu_torch.serving import ServingServer

    res, counts_all, keep = {}, [], None
    try:
        # dense f32 and paged bf16: each layout and each cache dtype once
        # (all four pairs ran before phase 25; two were cut to make room)
        for layout, dtn in (("dense", "float32"), ("paged", "bfloat16")):
            tag = f"17a {layout} {dtn}"
            kw = dict({"prefill_chunk": None} if layout == "dense"
                      else {"paged": True},
                      kv_dtype=getattr(torch, dtn), prefix_cache=False)
            srvs = [ServingServer(hooked_engine(lm, role=role,
                                                **kw)).start()
                    for role in ("unified", "prefill", "decode")]
            uni, pre, dec = (s.engine for s in srvs)
            try:
                r, counts = handoff_config(torch, np, lm, tag, srvs,
                                           gen_reqs)
            finally:
                if layout == "dense" and dtn == "float32":
                    keep = srvs
                else:
                    for s in srvs:
                        s.shutdown()
            check(pre.stats()["steps"] == 0
                  and dec.stats()["prefill_chunks"] == 0,
                  f"{tag}: the prefill engine took a decode step or the "
                  f"decode engine prefilled: {pre.stats()['steps']} "
                  f"steps, {dec.stats()['prefill_chunks']} chunks")
            res[f"{layout}_{dtn}"] = r
            counts_all += counts
            log(f"{tag}: replies equal the unified engine's, relayed "
                f"and pushed; frame {r['frame_bytes']['max']} bytes at "
                f"prompt {r['frame_bytes']['max_prompt']} (mix total "
                f"{r['frame_bytes']['total']}); encode p50 "
                f"{r['encode_ms']['p50']:.2f} ms, wire p50 "
                f"{r['wire_ms']['p50']:.2f} ms, decode p50 "
                f"{r['decode_ms']['p50']:.2f} ms, export swap-out p50 "
                f"{r['swap_out_ms']['p50']:.2f} ms, resume swap-in p50 "
                f"{r['swap_in_ms']['p50']:.2f} ms a request; TTFT p50 "
                f"prefill side {r['ttft_ms']['prefill_side']['p50']:.1f}"
                f" + decode side "
                f"{r['ttft_ms']['decode_side']['p50']:.1f} ms "
                f"(unified {r['ttft_ms']['unified']['p50']:.1f} ms); "
                f"tokens/s unified {r['tokens_per_s']['unified']:.1f}, "
                f"relayed {r['tokens_per_s']['relayed']:.1f}, pushed "
                f"{r['tokens_per_s']['pushed']:.1f}; supervisors held "
                f"off {r['supervisor_blind_s']} s on {smi}")
    except BaseException:
        for s in keep or ():
            s.shutdown()
        raise
    return res, counts_all, keep


def handoff_config(torch, np, lm, tag, srvs, reqs):
    """One 17a configuration: the unified engine, then the pair relayed,
    then pushed; every reply equal to the unified engine's."""
    uni, pre, dec = (s.engine for s in srvs)
    runs, counts_all, rows, taps = {}, [], {}, {}
    for mode in ("unified", "relayed", "pushed"):
        with TransferTap() as tap:
            if mode == "unified":
                (outs, secs), counts = counted(
                    torch, lm, f"{tag} {mode}",
                    lambda: wire_mix(np, srvs[0], reqs))
            else:
                (outs, secs, rows[mode]), counts = counted(
                    torch, lm, f"{tag} {mode}",
                    lambda: handoff_mix(np, srvs[1], srvs[2], reqs,
                                        mode == "pushed"))
        taps[mode] = tap
        counts_all.append(counts)
        check(all(isinstance(o, np.ndarray) and len(o) == len(p) + n
                  for o, (p, n, _) in zip(outs, reqs)),
              f"{tag} {mode}: a request did not finish")
        if mode != "unified":
            check(same_outs(np, outs, runs["unified"]["outs"]),
                  f"{tag} {mode}: a reply differs from the unified engine's")
        tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
        runs[mode] = {"outs": outs, "seconds": secs,
                      "tokens_per_s": tokens / secs, "launches": counts}
    # frames: one a request and mode, the payload exactly the rows'
    frames = [r["bytes"] for m in ("relayed", "pushed") for r in rows[m]]
    for r, (p, _, _) in zip(rows["relayed"], reqs):
        extra = r["bytes"] - frame_payload_bytes(dec._stepper, len(p))
        check(0 < extra < 1024,
              f"{tag}: a {len(p)}-token frame of {r['bytes']} bytes is not "
              f"its payload plus a header")
    big = max(range(len(reqs)), key=lambda j: len(reqs[j][0]))
    rel, push = taps["relayed"], taps["pushed"]
    wire = [r["prefill_rt_s"] - rel.server[("prefill", j)]
            + r["transfer_rt_s"] - rel.server[("kv.transfer", j)]
            for j, r in enumerate(rows["relayed"])]
    both = lambda key: rel.seconds[key] + push.seconds[key]  # noqa: E731
    check(len(both("encode")) == len(both("decode")) == 2 * len(reqs),
          f"{tag}: {len(both('encode'))} frames encoded, "
          f"{len(both('decode'))} decoded for {2 * len(reqs)} hand-offs")
    return {
        "frame_bytes": {"total": sum(frames) // 2, "max": rows["relayed"][
            big]["bytes"], "max_prompt": len(reqs[big][0]),
            "per_request": [r["bytes"] for r in rows["relayed"]]},
        "encode_ms": quantiles_ms(np, both("encode")),
        "decode_ms": quantiles_ms(np, both("decode")),
        "swap_out_ms": quantiles_ms(np, both("swap_out")),
        "swap_in_ms": quantiles_ms(np, both("swap_in")),
        "wire_ms": quantiles_ms(np, wire),
        "ttft_ms": {
            "prefill_side": quantiles_ms(
                np, rel.lat(pre, "total", True) + push.lat(pre, "total",
                                                           True)),
            "decode_side": quantiles_ms(
                np, rel.lat(dec, "ttft") + push.lat(dec, "ttft")),
            "unified": quantiles_ms(np, taps["unified"].lat(uni, "ttft")),
        },
        "tokens_per_s": {m: runs[m]["tokens_per_s"] for m in runs},
        "seconds": {m: runs[m]["seconds"] for m in runs},
        "launches": {m: runs[m]["launches"] for m in runs},
        # the supervisors' own late wakes (a stall of the whole process)
        "supervisor_blind_s": [
            e["seconds"] for eng in (uni, pre, dec)
            for e in eng.recorder.snapshot()
            if e["kind"] == "engine.watchdog_blind"],
    }, counts_all


def run_fabric(torch, np, lm, smi):
    """17b: engine A serves 13b's shared-header mix (its host store then
    holds the header's pow2 rungs) behind a ``ServingServer``; fresh
    engines B serve the mix with ``kv_peers`` pointing at A: fetched, then
    after A's scheduler restarted with the old epoch (typed
    ``stale_epoch``), a dead endpoint and an open breaker. Every B's
    replies equal A's, which fetched nothing."""
    import threading

    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import ServingClient, ServingServer
    from distkeras_tpu_torch.utils.serialization import serialize_params

    header, reqs = shared_header_mix(np)
    a = hooked_engine(lm)
    sa = ServingServer(a).start()
    ep = (sa.host, sa.port)
    out, counts_all = {}, []
    try:
        (ref, secs, _), counts = counted(
            torch, lm, "17b never-fetched",
            lambda: serve_header_mix(a, reqs))
        counts_all.append(counts)
        cover = a.prefix_store.coverage(header)
        check(cover == 128, f"17b: A covers {cover} header positions, not "
                            f"its 128-token rung")
        out["never_fetched"] = {
            "prefill_positions": a.stats()["prefill_tokens"],
            "prompt_positions": sum(len(p) - 1 for p, _, _ in reqs),
            "seconds": secs}
        served = lambda: {k: a.peer_fabric.counters[k] for k in (  # noqa: E731
            "fetch_served", "fetch_miss", "stale_refusals", "bytes_out")}

        def drive(tag, hint, prep=None):
            b = hooked_engine(lm)
            try:
                if prep is not None:
                    prep(b)
                a0 = served()
                (outs, secs, _), counts = counted(
                    torch, lm, f"17b {tag}",
                    lambda: serve_header_mix(b, reqs, kv_peers=[hint]))
                counts_all.append(counts)
                check(same_outs(np, outs, ref),
                      f"17b {tag}: a reply differs from the never-fetched "
                      f"engine's")
                fab = b.peer_fabric.snapshot()
                tape = [e for e in b.recorder.snapshot()
                        if e["kind"] == "kv.peer.degraded"]
                a1 = served()
                return {"prefill_positions": b.stats()["prefill_tokens"],
                        "seconds": secs, "fabric": {k: fab[k] for k in (
                            "fetches", "fetch_ok", "fetch_degraded",
                            "fetch_retries", "breaker_skips", "bytes_in")},
                        "budget": fab["budget"],
                        "degraded_errors": sorted({e["error"]
                                                   for e in tape}),
                        "peer_served": {k: a1[k] - a0[k] for k in a1}}
            finally:
                b.stop()

        hint = {"endpoint": ep, "epoch": int(a.kv_epoch), "len": cover}
        r = out["fetched"] = drive("fetched", hint)
        f = r["fabric"]
        check(f["fetch_ok"] == f["fetches"] == 1 and f["fetch_degraded"] == 0
              and f["bytes_in"] == r["peer_served"]["bytes_out"] > 0,
              f"17b fetched: fabric {f}, peer {r['peer_served']}")
        check(r["prefill_positions"]
              <= out["never_fetched"]["prefill_positions"] - cover,
              f"17b fetched: {r['prefill_positions']} prefill positions, "
              f"the never-fetched engine "
              f"{out['never_fetched']['prefill_positions']}")
        # restart A's scheduler (the seam fires on A's loop thread only)
        old = int(a.kv_epoch)
        with FaultPlan(seed=0).arm(
                "scheduler.loop", times=1,
                when=lambda ctx: threading.current_thread() is a._thread):
            wait_for(lambda: a.health()["restarts"] >= 1
                     and a.health()["status"] == "serving", "A's restart")
        check(int(a.kv_epoch) != old, "17b: the restart kept the KV epoch")
        with ServingClient(*ep, timeout=60, connect_timeout=2) as c:
            reply, _ = c._roundtrip({"verb": "kv.fetch", "epoch": old},
                                    serialize_params(header[:cover]),
                                    raise_on_error=False)
        check(reply.get("error") == "stale_epoch",
              f"17b: a fetch at the old epoch replied {reply}")
        out["restart_seconds"] = a.last_restart
        budget0 = {}

        def open_breaker(b):
            br = b.peer_fabric.breaker(ep)
            br.open_secs = 3600.0  # no half-open probe inside the drive
            for _ in range(5):
                br.record_failure()
            check(br.state == "open", f"17b: the breaker is {br.state}")
            budget0.update(b.peer_fabric.budget.snapshot())

        for tag, h, err, prep in (
                ("stale_epoch", dict(hint, epoch=old), "StaleEpochError",
                 None),
                ("dead_endpoint", dict(hint, endpoint=dead_endpoint()),
                 "PeerError", None),
                ("open_breaker", dict(hint, epoch=int(a.kv_epoch)),
                 "PeerError", open_breaker)):
            r = out[tag] = drive(tag, h, prep)
            f = r["fabric"]
            check(f["fetch_ok"] == 0 and f["fetches"] >= 1
                  and f["fetch_degraded"] == f["fetches"]
                  and r["degraded_errors"] == [err],
                  f"17b {tag}: fabric {f}, tape {r['degraded_errors']}")
        r = out["stale_epoch"]
        check(r["peer_served"]["stale_refusals"]
              == r["fabric"]["fetches"],
              f"17b stale_epoch: {r['peer_served']} for "
              f"{r['fabric']['fetches']} fetches")
        r = out["open_breaker"]
        check(r["fabric"]["breaker_skips"] == r["fabric"]["fetches"]
              and r["fabric"]["fetch_retries"] == 0
              and r["budget"] == budget0
              and not any(r["peer_served"].values()),
              f"17b open_breaker: {r['fabric']}, budget {r['budget']}, "
              f"peer {r['peer_served']}")
    finally:
        sa.shutdown()
    log(f"17b: never-fetched {out['never_fetched']['prefill_positions']} "
        f"prefill positions of {out['never_fetched']['prompt_positions']}; "
        f"fetched from the peer {out['fetched']['prefill_positions']} "
        f"({out['fetched']['fabric']['bytes_in']} bytes in, "
        f"{out['fetched']['seconds']:.2f} s against "
        f"{out['never_fetched']['seconds']:.2f} s); stale epoch, dead "
        f"endpoint and open breaker degrade with the same replies; A's "
        f"restart {out['restart_seconds']} on {smi}")
    return out, counts_all


def dead_endpoint():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return ("127.0.0.1", port)


def run_failures(torch, np, lm, smi, srvs, reqs):
    """17c on 17a's dense f32 servers: a frame with one byte flipped is a
    typed ``kv_transfer`` and admits nothing, in process and over the
    wire; ``wrong_role`` holds both ways over the wire; the
    ``kv.transfer`` seam fails a send and a receive typed; a clean
    hand-off after them equals the unified engine's reply."""
    from distkeras_tpu_torch.faults import FaultPlan, InjectedFault
    from distkeras_tpu_torch.serving import KvTransferError, ServingError
    from distkeras_tpu_torch.utils.serialization import serialize_params

    uni, pre, dec = (s.engine for s in srvs)
    p, n, sp = reqs[3]  # sampled: the frame carries its params
    res = {}

    def drive():
        blob, _ = pre.prefill(p, n, sampling=sp)
        flipped = bytearray(blob)
        flipped[len(blob) // 2] ^= 0x10
        before = dec.stats()["submitted"]
        try:
            dec.resume(bytes(flipped), n)
            check(False, "17c: a flipped frame resumed")
        except KvTransferError:
            pass
        cp, cd = wire_clients(srvs[1], 1)[0], wire_clients(srvs[2], 1)[0]
        try:
            reply, _ = cd._roundtrip(
                {"verb": "kv.transfer", "max_new_tokens": n},
                bytes(flipped), raise_on_error=False)
            res["flipped_wire"] = reply.get("error")
            check(dec.stats()["submitted"] == before
                  and reply.get("error") == "kv_transfer",
                  f"17c: a flipped frame over the wire replied {reply}; "
                  f"submitted {before} -> {dec.stats()['submitted']}")
            for c, verb, code in ((cp, "generate", "wrong_role"),
                                  (cd, "prefill", "wrong_role")):
                reply, _ = c._roundtrip(
                    {"verb": verb, "max_new_tokens": n},
                    serialize_params(p), raise_on_error=False)
                res[f"{verb}_on_wrong_role"] = reply.get("error")
                check(reply.get("error") == code,
                      f"17c: {verb} on the wrong role replied {reply}")
        finally:
            cp.close()
            cd.close()
        for direction in ("send", "recv"):
            plan = FaultPlan(seed=0).arm(
                "kv.transfer", times=1,
                when=lambda ctx, d=direction: ctx.get("direction") == d)
            try:
                with plan:
                    if direction == "send":
                        pre.prefill(p, n, sampling=sp)
                    else:
                        dec.resume(blob, n)
                check(False, f"17c: the {direction} seam did not fail")
            except ServingError as e:
                res[f"seam_{direction}"] = e.code
            check(plan.fired("kv.transfer") == 1,
                  f"17c: the {direction} seam fired "
                  f"{plan.fired('kv.transfer')} times")
        tape = [e["error"] for e in dec.recorder.snapshot()
                if e["kind"] == "kv.transfer.error"]
        check(tape[-1] == InjectedFault.__name__,
              f"17c: the decode tape names {tape[-1:]}")
        check(res["seam_send"] == "internal",
              f"17c: the send seam failed {res['seam_send']}")
        out = dec.wait(dec.resume(pre.prefill(p, n, sampling=sp)[0], n))
        return out, uni.generate(p, n, sampling=sp, timeout=600)

    (out, want), counts = counted(torch, lm, "17c", drive)
    check(np.array_equal(out, want),
          "17c: the hand-off after the failures differs from the unified "
          "engine's reply")
    res["errors"] = {"prefill": pre.transfer_snapshot()["errors"],
                     "decode": dec.transfer_snapshot()["errors"]}
    log(f"17c: flipped frame, wrong role both ways and the kv.transfer seam "
        f"both ways all typed: {res} on {smi}")
    return res, [counts]


def run_phase17(torch, np, lm, smi, gen_reqs):
    """Phase 17, disaggregated prefill/decode and the KV fabric on the
    card; returns the results and the launch counts of each drive."""
    out = {}
    t0 = time.monotonic()
    out["handoff"], c_a, srvs = run_handoff(torch, np, lm, smi, gen_reqs)
    try:
        out["fabric"], c_b = run_fabric(torch, np, lm, smi)
        out["failures"], c_c = run_failures(torch, np, lm, smi, srvs,
                                            gen_reqs)
    finally:
        for s in srvs:
            s.shutdown()
    detach_hooks(lm)
    out["seconds_total"] = time.monotonic() - t0
    counts = [*c_a, *c_b, *c_c]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ------------------------------------------------------------------ phase 18

#: the fleet router's knobs on the card: a 0.1 s health sweep, a 2 s dial
ROUTER_KW = {"health_interval": 0.1, "connect_timeout": 2.0}


def counted_all(torch, tag, fn):
    """``counted`` over every model that ran (replicas loaded from a file or
    a bundle hold their own copy): B7 must have launched exactly what the
    stepper programs imply, summed over every engine, and B4 never."""
    from distkeras_tpu_torch import kernels

    kernels.reset_launch_counts()
    with ProgramCalls() as calls:
        out = fn()
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = calls.ln_launches_all()
    check(counts["layernorm_fwd"] == want and counts["flash_fwd"] == 0,
          f"{tag}: B7 {counts['layernorm_fwd']} (B4 {counts['flash_fwd']}), "
          f"the program calls imply {want} B7")
    return out, counts


def card_replicas(lm, **kw):
    """A ``FleetController`` factory for the card: phase 4's engine (8
    slots, its step buckets warmed) behind its own ``ServingServer``.
    ``bundle`` is the hooked LM itself (the replicas share its weights),
    the path of an f32 model file (``.f32``, ``serialize_model``) or of an
    int8 serving bundle; a loaded model gets the LN hook before the
    replica joins the router."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import local_replica_factory
    from distkeras_tpu_torch.utils.serialization import deserialize_model

    boot = local_replica_factory(num_slots=8, **kw)

    def factory(bundle):
        if isinstance(bundle, str) and bundle.endswith(".f32"):
            with open(bundle, "rb") as f:
                bundle = deserialize_model(f.read())
        rep = boot(bundle)
        if rep.engine.model is not lm:
            check(attach_fused_layernorm(rep.engine.model) == 17,
                  "18: LN hook not on a replica's 17 norms")
        rep.engine._stepper.warmup()
        return rep

    return factory


def fleet_mix(np, ep, reqs, threads=8, streams=(), on_done=None):
    """``reqs`` through the router at ``ep`` from ``threads`` client
    threads (one client each, no client retries: what the router does is
    what the caller sees); the indices in ``streams`` go as
    ``generate_stream``. Returns one row a request — ``out`` (the reply)
    or ``err`` (the exception), ``served_by``, the chunks a stream had
    emitted — and the seconds. ``on_done(j)`` runs after each request."""
    import threading

    from distkeras_tpu_torch.serving import ServingClient

    rows = [None] * len(reqs)

    def work(t):
        with ServingClient(ep[0], ep[1], timeout=120, connect_timeout=2,
                           retry=False) as c:
            for j in range(t, len(reqs), threads):
                p, n, s = reqs[j]
                row = {"chunks": 0}
                try:
                    if j in streams:
                        st = c.generate_stream(p, n, sampling=s)
                        for _ in st:
                            row["chunks"] += 1
                        row["out"], row["served_by"] = st.sequence, \
                            st.served_by
                    else:
                        row["out"] = c.generate(p, n, sampling=s)
                        row["served_by"] = c.last_served_by
                except Exception as e:  # noqa: BLE001 — the caller checks
                    row["err"] = e
                rows[j] = row
                if on_done is not None:
                    on_done(j)

    t0 = time.monotonic()
    ths = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in ths), "18: a client hung")
    return rows, time.monotonic() - t0


def replies(np, rows, refs, tag):
    """Every row a reply equal to its reference."""
    bad = [j for j, (r, ref) in enumerate(zip(rows, refs))
           if "err" in r or not np.array_equal(r["out"], ref)]
    check(not bad, f"{tag}: requests {bad} failed or differ from the "
                   f"reference: {[rows[j].get('err') for j in bad][:3]}")


def mix_tokens(rows, reqs):
    return sum(len(r["out"]) - len(p) for r, (p, _, _) in zip(rows, reqs)
               if "out" in r)


def fleet_books(ctl):
    """The router's counters a phase 18 line reads."""
    st = ctl.router.stats()
    return {k: st[k] for k in (
        "forwards", "affinity_routed", "spilled", "digest_routed",
        "least_loaded_routed", "failovers", "ejections", "rejoins",
        "fleet_overloaded", "unavailable")}


def device_bytes(torch):
    """Bytes of live tensors on the card, after a collection and with the
    cuBLAS workspaces of finished threads dropped."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def model_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(model.parameters(), model.buffers()))


def run_fleet_affinity(torch, np, lm, smi, front, gen_reqs, gen_outs):
    """18a: a 2-replica ``FleetController`` (replicas sharing the hooked
    LM, each with the default host prefix store) serves phase 4's mix from
    8 client threads, each reply equal to phase 4's; then 13b's
    shared-header traffic: the first two requests one after the other
    (the store's two touches put the header's rungs in the replica's
    digest), the other 14 from 8 threads — every one served by one
    replica. Returns the results, the counts and the live controller."""
    from distkeras_tpu_torch.serving import FleetController

    ctl = FleetController(lm, replicas=2, factory=card_replicas(lm),
                          router_kw=ROUTER_KW).start()
    res, counts_all = {}, []
    try:
        def steps():
            return [(r.engine.batcher.counters["steps"],
                     r.engine.batcher.counters["occupancy_sum"])
                    for r in ctl.replicas]

        s0 = steps()
        (rows, secs), counts = counted(
            torch, lm, "18a mix", lambda: fleet_mix(np, ctl.endpoint,
                                                    gen_reqs))
        counts_all.append(counts)
        replies(np, rows, gen_outs, "18a mix")
        tokens = mix_tokens(rows, gen_reqs)
        per = {}
        for r in rows:
            key = "%s:%s" % tuple(r["served_by"])
            per[key] = per.get(key, 0) + 1
        check(len(per) == 2, f"18a: the mix landed on {per}, not on both")
        # each replica's decode steps and mean busy slots a step in the mix
        busy = [{"steps": n1 - n0,
                 "mean_occupancy": (o1 - o0) / max(1, n1 - n0)}
                for (n0, o0), (n1, o1) in zip(s0, steps())]
        wire = front["wire_generate"]["generate"]["tokens_per_s"]
        res["mix"] = {"tokens": tokens, "seconds": secs,
                      "tokens_per_s": tokens / secs,
                      "single_engine_wire_tokens_per_s": wire,
                      "requests_per_replica": per, "replica_steps": busy,
                      "launches": counts, "router": fleet_books(ctl)}
        log(f"18a mix: 16 requests from 8 client threads through the "
            f"router, all equal to phase 4's; {tokens / secs:.1f} tokens/s "
            f"on 2 replicas vs {wire:.1f} on one engine over the wire "
            f"(phase 11); per replica {per}, steps and mean busy slots "
            f"{busy}; launches {counts} on {smi}")

        header, hreqs = shared_header_mix(np)
        prefill0 = sum(r.engine.stats()["prefill_tokens"]
                       for r in ctl.replicas)

        def digest_ready():
            return any((row.get("kv_fabric") or {}).get("digest_n")
                       for row in ctl.router.replicas())

        def drive():
            first, s1 = fleet_mix(np, ctl.endpoint, hreqs[:2], threads=1)
            wait_for(digest_ready, "the header's rungs in a digest",
                     timeout=10)
            rest, s2 = fleet_mix(np, ctl.endpoint, hreqs[2:])
            return first + rest, s1 + s2

        (hrows, hsecs), counts = counted(torch, lm, "18a header", drive)
        counts_all.append(counts)
        bad = [j for j, r in enumerate(hrows) if "err" in r
               or len(r["out"]) != len(hreqs[j][0]) + hreqs[j][1]]
        check(not bad, f"18a header: requests {bad} failed or came short")
        homes = {tuple(r["served_by"]) for r in hrows}
        check(len(homes) == 1, f"18a header: served by {homes}, not one "
                               f"replica")
        outs = [r["out"] for r in hrows]
        gap = argmax_gap(torch, np, lm, outs, hreqs)
        check(gap <= LOGIT_TOL, f"18a header: a greedy token is not the "
                                f"argmax of its plain logits (gap {gap})")
        sampled = [j for j, (_, _, s) in enumerate(hreqs) if s is not None]
        again, _ = fleet_mix(np, ctl.endpoint, [hreqs[j] for j in sampled],
                             threads=4)
        replies(np, again, [outs[j] for j in sampled], "18a header replay")
        prefill = sum(r.engine.stats()["prefill_tokens"]
                      for r in ctl.replicas) - prefill0
        prompt = sum(len(p) - 1 for p, _, _ in hreqs)
        books = fleet_books(ctl)
        res["header"] = {
            "served_by": ["%s:%s" % h for h in homes],
            "prompt_positions": prompt, "prefill_positions": prefill,
            "prefill_positions_saved": prompt - prefill,
            "seconds": hsecs, "tokens_per_s": mix_tokens(hrows, hreqs) / hsecs,
            "max_argmax_gap": gap, "launches": counts, "router": books}
        log(f"18a header: 16 shared-header requests all served by "
            f"{res['header']['served_by'][0]} (affinity "
            f"{books['affinity_routed']}, digest {books['digest_routed']} "
            f"over the whole 18a); {prefill} of {prompt} prompt positions "
            f"prefilled ({prompt - prefill} saved by the replica's store); "
            f"argmax gap {gap:.2e}; launches {counts} on {smi}")
    except BaseException:
        ctl.stop()
        raise
    return res, counts_all, ctl


def run_fleet_rollover(torch, np, lm, smi, ctl, gen_reqs, gen_outs, tmp):
    """18c: while 4 client threads loop over phase 4's mix through the
    router, ``rollover`` walks both replicas over to an f32 copy of the
    weights read from a file (``serialize_model``): no request fails,
    every reply equals phase 4's, the replaced replicas' K/V banks leave
    the card (device memory after minus before is the new replicas' own
    weights), and the mix after the walk equals phase 4's."""
    import threading

    from distkeras_tpu_torch.utils.serialization import serialize_model

    path = os.path.join(tmp, "lm.f32")
    with open(path, "wb") as f:
        f.write(serialize_model(lm))
    mem0 = device_bytes(torch)
    stop = threading.Event()
    live = {"ok": 0, "bad": []}
    lock = threading.Lock()

    def traffic(t):
        from distkeras_tpu_torch.serving import ServingClient

        with ServingClient(*ctl.endpoint, timeout=120, connect_timeout=2,
                           retry=False) as c:
            j = t
            while not stop.is_set():
                p, n, s = gen_reqs[j % len(gen_reqs)]
                try:
                    ok = np.array_equal(c.generate(p, n, sampling=s),
                                        gen_outs[j % len(gen_reqs)])
                    err = None if ok else "differs"
                except Exception as e:  # noqa: BLE001 — counted
                    err = repr(e)
                with lock:
                    if err is None:
                        live["ok"] += 1
                    else:
                        live["bad"].append((j % len(gen_reqs), err))
                j += 4

    def drive():
        ths = [threading.Thread(target=traffic, args=(t,)) for t in range(4)]
        for th in ths:
            th.start()
        try:
            time.sleep(0.5)
            ledger = ctl.rollover(path)
            time.sleep(0.5)
        finally:
            stop.set()
            for th in ths:
                th.join(timeout=120)
        check(not any(th.is_alive() for th in ths), "18c: a client hung")
        return ledger

    ledger, counts = counted_all(torch, "18c rollover", drive)
    check(not live["bad"] and live["ok"] > 0,
          f"18c: {len(live['bad'])} requests failed or differ during the "
          f"rollover ({live['bad'][:3]}), {live['ok']} ok")
    check(len(ledger["replaced"]) == 2, f"18c: ledger {ledger}")
    mem1 = device_bytes(torch)
    new_bytes = sum(model_bytes(r.engine.model) for r in ctl.replicas)
    left = mem1 - mem0 - new_bytes
    check(left < BANK_BYTES,
          f"18c: {left} bytes left on the card by the replaced replicas "
          f"(one bank is {BANK_BYTES})")
    (rows, secs), counts_b = counted_all(
        torch, "18c after", lambda: fleet_mix(np, ctl.endpoint, gen_reqs))
    replies(np, rows, gen_outs, "18c after the rollover")
    res = {"seconds": ledger["seconds"], "live_requests_ok": live["ok"],
           "live_failed": 0, "memory_before": mem0, "memory_after": mem1,
           "new_replica_weight_bytes": new_bytes,
           "bytes_left_by_replaced": left,
           "mix_after_tokens_per_s": mix_tokens(rows, gen_reqs) / secs,
           "launches": counts}
    log(f"18c rollover to the f32 file in {ledger['seconds']} s under live "
        f"traffic: {live['ok']} requests equal to phase 4's, 0 failed; "
        f"device memory {mem1 - mem0:+d} bytes = the new replicas' own "
        f"weights {new_bytes} {left:+d} (the old replicas' banks released); "
        f"the mix after equal to phase 4's; launches {counts} on {smi}")
    return res, [counts, counts_b]


def run_fleet_failover(torch, np, lm, smi, ctl, gen_reqs, gen_outs):
    """18b: phase 4's mix (its first four streamed) from 8 threads; after
    the third reply the replica that served request 0 last is killed
    (``shutdown(drain=False)``). Every request completes equal to phase
    4's or fails typed (a stream that had emitted chunks fails typed), the
    ejection shows in the router's books; then with the other replica
    killed too (and ejected) a request fails typed ``unavailable`` at
    once. No client hangs."""
    import threading

    from distkeras_tpu_torch.serving import ServingClient, ServingError

    with ServingClient(*ctl.endpoint, timeout=120, connect_timeout=2,
                       retry=False) as c:
        p, n, s = gen_reqs[0]
        c.generate(p, n, sampling=s)
        home_ep = tuple(c.last_served_by)
    home = next(r for r in ctl.replicas if tuple(r.endpoint) == home_ep)
    other = next(r for r in ctl.replicas if r is not home)
    done, killers = [0], []
    lock = threading.Lock()

    def on_done(j):
        with lock:
            done[0] += 1
            if done[0] == 3:
                th = threading.Thread(target=home.stop,
                                      kwargs={"drain": False})
                th.start()
                killers.append(th)

    (rows, secs), counts = counted_all(
        torch, "18b failover",
        lambda: fleet_mix(np, ctl.endpoint, gen_reqs, streams=(0, 1, 2, 3),
                          on_done=on_done))
    ok = typed = streamed_typed = 0
    codes = {}
    for j, r in enumerate(rows):
        if "err" in r:
            e = r["err"]
            check(isinstance(e, ServingError) and bool(e.code),
                  f"18b: request {j} failed untyped: {e!r}")
            typed += 1
            codes[e.code] = codes.get(e.code, 0) + 1
            streamed_typed += int(j < 4 and r["chunks"] > 0)
        else:
            check(np.array_equal(r["out"], gen_outs[j]),
                  f"18b: request {j} completed with a different reply")
            ok += 1
    wait_for(lambda: any(tuple(row["endpoint"]) == home_ep
                         and row["state"] == "ejected"
                         for row in ctl.router.replicas()),
             "the killed replica's ejection", timeout=10)
    books = fleet_books(ctl)
    check(books["ejections"] >= 1, f"18b: no ejection in the books {books}")
    th = threading.Thread(target=other.stop, kwargs={"drain": False})
    th.start()
    killers.append(th)
    wait_for(lambda: all(row["state"] == "ejected"
                         for row in ctl.router.replicas()),
             "the second replica's ejection", timeout=10)
    t0 = time.monotonic()
    try:
        with ServingClient(*ctl.endpoint, timeout=60, connect_timeout=2,
                           retry=False) as c:
            c.generate(gen_reqs[1][0], 4)
        err = None
    except ServingError as e:
        err = e
    dead_s = time.monotonic() - t0
    check(err is not None and err.code == "unavailable" and dead_s <= 2.0,
          f"18b: with both replicas dead the client got {err!r} after "
          f"{dead_s:.2f} s (want typed unavailable within the 2 s dial "
          f"budget)")
    for th in killers:
        th.join(timeout=30)
    res = {"completed_equal": ok, "failed_typed": typed,
           "error_codes": codes,
           "streams_failed_after_chunks": streamed_typed,
           "seconds": secs, "router": fleet_books(ctl),
           "all_dead_unavailable_s": dead_s, "launches": counts}
    log(f"18b failover: home {home_ep[0]}:{home_ep[1]} killed after 3 "
        f"replies; {ok} requests equal to phase 4's, {typed} failed typed "
        f"{codes} ({streamed_typed} streams after emitting chunks), none "
        f"untyped, "
        f"no client hung; books {res['router']}; both dead: typed "
        f"unavailable in {dead_s * 1e3:.1f} ms; launches {counts} on {smi}")
    return res, [counts]


def run_fleet_autoscale(torch, np, lm, smi, gen_reqs, gen_outs, tmp):
    """18d: an ``Autoscaler`` (``min_replicas=1``, ``max_replicas=3``,
    ticked by hand, ``up_threshold=0.5``) over a 1-replica fleet with 16
    queue places a replica: a burst of 16 requests fills two thirds of it
    and a tick scales up (the replica
    warmed and ``mark_warmed`` before it joins, 0 storms on its ledger
    after a second burst reached it); two idle ticks scale down under a
    request stream that loses nothing; a killed replica is reaped and
    replaced in one tick; then a ``BundlePublisher`` on a
    ``DeltaParameterServer`` holding the LM's center publishes an int8
    bundle after 2 commits and a ``ContinuousDeployer`` rolls the fleet to
    it on a hold tick: replies equal a solo engine's on that bundle."""
    import threading

    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.quantization import quantize_model
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.serving import (
        AutoscalePolicy,
        Autoscaler,
        BundlePublisher,
        ContinuousDeployer,
        FleetController,
        ServingEngine,
    )
    from distkeras_tpu_torch.utils.serialization import save_serving_bundle

    ctl = FleetController(lm, replicas=1,
                          factory=card_replicas(lm, queue_capacity=16),
                          router_kw=ROUTER_KW).start()
    # ticks come by hand seconds apart, all inside the one 60 s window of
    # the replicas' queue-depth slope, which then still holds the bursts:
    # the idle row's "no rising queue" test is left to the CPU tests
    # the burst fills 16 of a replica's 24 places (8 slots and 16 queue
    # places: the queue must hold the whole burst before the scheduler
    # admits it, or the replica refuses some typed ``overloaded``)
    sc = Autoscaler(ctl, AutoscalePolicy(
        min_replicas=1, max_replicas=3, up_threshold=0.5,
        down_threshold=0.25, up_ticks=1, down_ticks=2, up_cooldown=0.0,
        down_cooldown=0.0, trend_slope=1e3))
    res, counts_all = {}, []
    try:
        def in_flight():
            return sum(r["in_flight"] for r in ctl.router.replicas())

        def burst_then_scale():
            box = {}
            th = threading.Thread(target=lambda: box.update(
                rows=fleet_mix(np, ctl.endpoint, gen_reqs, threads=16)[0]))
            th.start()
            wait_for(lambda: in_flight() >= 14, "the burst in flight",
                     timeout=30)
            d = sc.tick()
            while d.action == "hold" and th.is_alive():
                d = sc.tick()  # the books moved between the wait and tick
            th.join(timeout=300)
            rows2, _ = fleet_mix(np, ctl.endpoint, gen_reqs, threads=16)
            return d, box["rows"], rows2

        (d, rows1, rows2), counts = counted_all(torch, "18d scale-up",
                                                burst_then_scale)
        counts_all.append(counts)
        check(d.action == "scale_up" and len(ctl.replicas) == 2,
              f"18d: the burst's tick was {d.action} ({d.reason}), "
              f"{len(ctl.replicas)} replicas")
        replies(np, rows1, gen_outs, "18d burst")
        replies(np, rows2, gen_outs, "18d second burst")
        new = ctl.replicas[-1]
        led = new.engine.compile_ledger
        served_new = sum(tuple(r["served_by"]) == tuple(new.endpoint)
                         for r in rows2)
        check(led.warmed and led.storms == 0 and served_new > 0,
              f"18d: the new replica (warmed {led.warmed}) has "
              f"{led.storms} storms after serving {served_new} requests")
        res["scale_up"] = {"reason": d.reason, "utilization": d.utilization,
                           "new_replica_requests": served_new,
                           "storms": led.storms,
                           "warmup_mints": led.warmup_mints,
                           "launches": counts}
        log(f"18d scale-up: tick at utilization {d.utilization} "
            f"({d.reason}); the new replica warmed ({led.warmup_mints} "
            f"warm-up mints) before joining, then served {served_new} of "
            f"the second burst with 0 storms; both bursts equal phase 4's "
            f"on {smi}")

        def idle_down():
            stop, box = threading.Event(), {"rows": []}

            def trickle():  # one request at a time: the fleet stays idle
                j = 0
                while not stop.is_set():
                    rows, _ = fleet_mix(np, ctl.endpoint, [gen_reqs[j % 16]],
                                        threads=1)
                    box["rows"].append((j % 16, rows[0]))
                    j += 1

            th = threading.Thread(target=trickle)
            th.start()
            try:
                wait_for(lambda: len(box["rows"]) >= 2, "the trickle",
                         timeout=120)
                ds = [sc.tick() for _ in range(2)]
                n = len(box["rows"])
                wait_for(lambda: len(box["rows"]) >= n + 2,
                         "the trickle after the scale-down", timeout=120)
            finally:
                stop.set()
                th.join(timeout=120)
            return ds, box["rows"]

        (ds, trickled), counts = counted_all(torch, "18d scale-down",
                                             idle_down)
        counts_all.append(counts)
        check(ds[-1].action == "scale_down" and len(ctl.replicas) == 1,
              f"18d: idle ticks {[(x.action, x.reason) for x in ds]}, "
              f"{len(ctl.replicas)} replicas")
        replies(np, [r for _, r in trickled],
                [gen_outs[j] for j, _ in trickled], "18d scale-down")
        res["scale_down"] = {"requests_during": len(trickled), "failed": 0,
                             "launches": counts}
        log(f"18d scale-down: two idle ticks drained and stopped a replica; "
            f"{len(trickled)} requests during it, all equal to phase 4's; "
            f"launches {counts} on {smi}")

        victim = ctl.replicas[0]
        killer = threading.Thread(target=victim.stop,
                                  kwargs={"drain": False})
        killer.start()
        wait_for(lambda: not victim.alive(), "the victim's death", timeout=10)
        reaps0 = sc._counters["reaps"]
        d, counts = counted_all(torch, "18d reap", sc.tick)
        counts_all.append(counts)
        killer.join(timeout=30)
        check(d.reason == "below_min" and sc._counters["reaps"] == reaps0 + 1
              and len(ctl.replicas) == 1 and victim not in ctl.replicas,
              f"18d: the kill's tick was {d.action} ({d.reason}), "
              f"{len(ctl.replicas)} replicas")
        res["reap"] = {"reason": d.reason, "replicas": len(ctl.replicas)}
        log(f"18d reap: a killed replica was reaped and replaced in one "
            f"tick; launches {counts} on {smi}")

        center = {n: t for n, t in lm.named_parameters()}
        ps = DeltaParameterServer(center)
        del center

        def build(center, meta, path):
            m = lm.copy()
            own = dict(m.named_parameters())
            with torch.no_grad():
                for name, a in center.items():
                    own[name].copy_(torch.from_numpy(np.asarray(a)))
            save_serving_bundle(path, quantize_model(m))

        pub = BundlePublisher(ps, build, os.path.join(tmp, "bundles"),
                              every=2)
        sc.deployer = ContinuousDeployer(ctl, pub, timeout=120)
        rng = np.random.default_rng(18)
        for _ in range(2):
            ps.commit({n: (1e-3 * rng.standard_normal(p.shape)).astype(
                np.float32) for n, p in lm.named_parameters()})
        latest = pub.latest()
        check(latest is not None and latest["version"] == 2
              and pub.publish_errors == 0,
              f"18d: publisher after 2 commits: {latest}, "
              f"{pub.publish_errors} errors")
        greedy = [r for r in gen_reqs if r[2] is None][:4]

        def deploy():
            d = sc.tick()
            rows, _ = fleet_mix(np, ctl.endpoint, greedy, threads=4)
            return d, rows

        (d, rows), counts = counted_all(torch, "18d deploy", deploy)
        counts_all.append(counts)
        pub.close()
        check(d.action == "hold" and sc.last_deploy is not None
              and sc.last_deploy["version"] == 2,
              f"18d: the deploy tick was {d.action} ({d.reason}), last "
              f"deploy {sc.last_deploy}")
        solo = ServingEngine.from_bundle(latest["path"], num_slots=8)
        check(attach_fused_layernorm(solo.model) == 17,
              "18d: LN hook not on the solo engine's 17 norms")
        solo.start()
        try:
            refs = [solo.generate(p, n, timeout=600) for p, n, _ in greedy]
        finally:
            solo.stop()
        replies(np, rows, refs, "18d after the deploy")
        res["deploy"] = {"version": 2, "bundle_bytes":
                         os.path.getsize(latest["path"]),
                         "rollover_seconds":
                         sc.last_deploy["ledger"]["seconds"],
                         "launches": counts}
        res["autoscaler"] = {k: sc._counters[k] for k in (
            "ticks", "scale_ups", "scale_downs", "holds", "reaps",
            "deploys", "errors")}
        check(res["autoscaler"]["errors"] == 0,
              f"18d: autoscaler errors {res['autoscaler']}")
        log(f"18d deploy: 2 commits published bundle v2 "
            f"({res['deploy']['bundle_bytes']} bytes, int8); a hold tick "
            f"rolled the fleet in {res['deploy']['rollover_seconds']} s; "
            f"4 replies equal a solo engine's on the bundle; autoscaler "
            f"{res['autoscaler']} on {smi}")
    finally:
        ctl.stop()
    return res, counts_all


def run_fleet_disagg(torch, np, lm, smi, gen_reqs):
    """18e: a ``role="prefill"`` and two ``role="decode"`` replicas (dense,
    whole-prompt admission, no store) behind a ``FleetRouter``: phase 4's
    mix pushed (``generate``) from 8 threads and its first four streamed
    (relayed) equal a unified engine's of the same layout, the push and
    relay ledgers pair with the counts of the drive; then a decode
    replica is killed hard (listener closed, engine stopped, connections
    reset) while request 0's streamed transfer is in it: the router
    resends the frame to the sibling, whose tokens are identical, and a
    pushed generate after the kill is too."""
    import socket
    import threading

    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import FleetRouter, ServingServer

    kw = {"prefill_chunk": None, "prefix_cache": False}
    uni = hooked_engine(lm, **kw)
    try:
        refs, _ = serve_mix(uni, gen_reqs)
    finally:
        uni.stop()
    srvs = [ServingServer(hooked_engine(lm, role=role, **kw)).start()
            for role in ("prefill", "decode", "decode")]
    router = FleetRouter(endpoints=[(s.host, s.port) for s in srvs],
                         **ROUTER_KW).start()
    res, counts_all, killer, killed = {}, [], None, None
    try:
        for s in srvs:
            check(router.wait_in_rotation((s.host, s.port)),
                  "18e: a replica never joined")

        def drive():
            pushed, s1 = fleet_mix(np, (router.host, router.port), gen_reqs)
            streamed, s2 = fleet_mix(np, (router.host, router.port),
                                     gen_reqs[:4], threads=4,
                                     streams=(0, 1, 2, 3))
            return pushed, streamed, s1

        (pushed, streamed, secs), counts = counted(torch, lm, "18e mix",
                                                   drive)
        counts_all.append(counts)
        replies(np, pushed, refs, "18e pushed")
        replies(np, streamed, refs[:4], "18e streamed")
        st = router.stats()
        ledger = {k: st[k] for k in (
            "disagg_routed", "peer_sends", "peer_ok", "peer_typed",
            "peer_degraded", "transfer_sends", "transfer_ok",
            "transfer_typed", "transfer_retries")}
        check(ledger["disagg_routed"] == 20 and ledger["peer_sends"] == 16
              and ledger["peer_ok"] == 16 and ledger["transfer_sends"] == 4
              and ledger["transfer_ok"] == 4,
              f"18e: ledgers {ledger} (want 20 routed, 16 pushed ok, 4 "
              f"relayed ok)")
        pre = srvs[0].engine.stats()
        check(pre["steps"] == 0, f"18e: the prefill replica took "
                                 f"{pre['steps']} decode steps")
        res["mix"] = {"tokens_per_s": mix_tokens(pushed, gen_reqs) / secs,
                      "ledger": ledger, "launches": counts}
        log(f"18e mix: 16 pushed and 4 stream-relayed replies equal a "
            f"unified engine's; ledgers {ledger}; pushed "
            f"{res['mix']['tokens_per_s']:.1f} tokens/s on {smi}")

        # a hard kill mid-transfer: request 0's streamed hop 2 is held in
        # the ``net.delay`` seam of the decode replica it lands on; that
        # replica's listener closes, its engine stops and its open
        # connections reset (what a killed process leaves), so the
        # router's forward dies under it and the same frame goes to the
        # sibling
        dec_ports, hit = {s.port for s in srvs[1:]}, []

        def held(ctx):
            if ctx["verb"] != "kv.transfer" or ctx["port"] not in dec_ports:
                return False
            hit[:] = hit or [ctx["port"]]
            return True

        plan = FaultPlan().arm("net.delay", action="delay", delay=1.0,
                               times=1, when=held)
        ep = (router.host, router.port)

        def again():
            nonlocal killer, killed
            box = {}
            with plan:
                th = threading.Thread(target=lambda: box.update(
                    rows=fleet_mix(np, ep, [gen_reqs[0]], threads=1,
                                   streams=(0,))[0]))
                th.start()
                wait_for(lambda: plan.fired("net.delay") == 1,
                         "the transfer held in the seam", timeout=60)
                killed = next(s for s in srvs if s.port == hit[0])
                killer = threading.Thread(target=killed.shutdown,
                                          kwargs={"drain": False})
                killer.start()
                wait_for(lambda: not killed._accept_thread.is_alive(),
                         "the decode replica's listener to close",
                         timeout=10)
                for conn in list(killed._conns):
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                th.join(timeout=120)
            rows2, _ = fleet_mix(np, ep, [gen_reqs[0]], threads=1)
            return box["rows"] + rows2

        rows, counts = counted(torch, lm, "18e failover", again)
        counts_all.append(counts)
        replies(np, rows, [refs[0], refs[0]], "18e failover")
        sibling = next(s for s in srvs[1:] if s is not killed)
        check(all(tuple(r["served_by"]) == (sibling.host, sibling.port)
                  for r in rows),
              f"18e: after the kill served by "
              f"{[r['served_by'] for r in rows]}, not the sibling")
        st = router.stats()
        after = {k: st[k] for k in ledger}
        check(after["transfer_retries"] >= 1
              and after["transfer_sends"] == after["transfer_ok"]
              + after["transfer_typed"] and after["transfer_typed"] == 0
              and after["peer_sends"] == after["peer_ok"]
              + after["peer_typed"] + after["peer_degraded"],
              f"18e: after the kill the ledgers are {after} (want a retried "
              f"transfer, none typed, both ledgers paired)")
        res["failover"] = {"ledger": after, "launches": counts}
        log(f"18e failover: decode :{killed.port} killed with request 0's "
            f"transfer in it; the stream went to the sibling with "
            f"identical tokens, a pushed generate after it too; ledgers "
            f"{after}; launches {counts} on {smi}")
    finally:
        router.shutdown()
        for s in srvs:
            if s is not killed:
                s.shutdown()
        if killer is not None:
            killer.join(timeout=30)
    return res, counts_all


def run_phase18(torch, np, lm, smi, front, gen_reqs, gen_outs):
    """Phase 18, the serving fleet and its autoscaler on the card; returns
    the results and the launch counts of each drive."""
    import tempfile

    out = {}
    t0 = time.monotonic()
    detach_hooks(lm)
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    mem0 = device_bytes(torch)
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        out["affinity"], c_a, ctl = run_fleet_affinity(
            torch, np, lm, smi, front, gen_reqs, gen_outs)
        try:
            out["rollover"], c_c = run_fleet_rollover(
                torch, np, lm, smi, ctl, gen_reqs, gen_outs, tmp)
            out["failover"], c_b = run_fleet_failover(
                torch, np, lm, smi, ctl, gen_reqs, gen_outs)
        finally:
            ctl.stop()
        del ctl
        out["autoscale"], c_d = run_fleet_autoscale(
            torch, np, lm, smi, gen_reqs, gen_outs, tmp)
    out["disagg"], c_e = run_fleet_disagg(torch, np, lm, smi, gen_reqs)
    detach_hooks(lm)
    mem1 = device_bytes(torch)
    out["bytes_left"] = mem1 - mem0
    check(mem1 - mem0 < BANK_BYTES,
          f"18: {mem1 - mem0} bytes left on the card after every fleet "
          f"stopped (one bank is {BANK_BYTES})")
    out["seconds_total"] = time.monotonic() - t0
    counts = [*c_a, *c_c, *c_b, *c_d, *c_e]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    log(f"18: {out['bytes_left']:+d} bytes on the card after every fleet "
        f"stopped; phase 18 in {out['seconds_total']:.1f} s on {smi}")
    return out, counts


# ------------------------------------------------------------------ phase 19

#: the full-width MoE LM: phase 4's LM with an 8-expert switch MoE after
#: every block (168,117,248 f32 parameters in 134 leaves, from the JAX
#: builder)
MOE_LM = dict(vocab_size=8192, seq_len=512, d_model=512, num_heads=8,
              depth=8, num_experts=8)
MOE_PARAMS = 168_117_248
MOE_LEAVES = 134
MOE_TRAIN_STEPS = 4
MOE_TRAIN_WINDOW = 2
BLOCKWISE_SHAPE = (1, 8192, 8, 64)
BLOCKWISE_TOL = 3e-5  # f32, another summation order over 8192 keys


def make_moe(zoo):
    return zoo.moe_transformer_lm(**MOE_LM, seed=0)


def moe_routes(torch, model):
    """Forward hooks recording, per MoE layer, every token's routed expert
    and whether the capacity kept it; returns (the record, the handles)."""
    from distkeras_tpu_torch.parallel.expert_parallel import MoE, _route

    rec = []

    def hook(layer, args, out):
        x = args[0]
        tokens = x.reshape(-1, x.shape[-1])
        s, e = tokens.shape[0], layer.num_experts
        cap = max(1, int(layer.capacity_factor * s / e))
        idx, pos, _, _ = _route(tokens.float() @ layer.router, cap)
        kept = pos < cap
        rec.append(torch.where(kept, idx, -1).reshape(x.shape[:-1]))

    handles = [l.register_forward_hook(hook) for l in model.layers
               if isinstance(l, MoE)]
    return rec, handles


def routed_forward(torch, model, seqs):
    """The model's forward on ``seqs`` and, per (row, position), the
    routing of every MoE layer at it ((B, T, L): expert, or -1 dropped)."""
    rec, handles = moe_routes(torch, model)
    try:
        y = forward(torch, model, seqs)
    finally:
        for h in handles:
            h.remove()
    return y, torch.stack(rec, dim=-1)


def same_route_prefix(torch, ra, rb):
    """(B, T) True where two forwards routed every token at and before
    that position of the row alike (expert and kept, in every layer): a
    causal row's logits there depend on nothing that routed differently."""
    same = (ra == rb).all(dim=-1)
    return torch.cumprod(same.int(), dim=1).bool()


def moe_replies(np, outs, reqs, refs, tag):
    """The 19a/19b bars: every request finished with its tokens, every
    greedy reply equals the solo cached decode's."""
    check(all(isinstance(o, np.ndarray) and len(o) == len(p) + n
              for o, (p, n, _) in zip(outs, reqs)),
          f"{tag}: a request did not finish with its max_new_tokens: "
          f"{[o for o in outs if not isinstance(o, np.ndarray)][:2]}")
    bad = [i for i, (o, (_, _, s)) in enumerate(zip(outs, reqs))
           if s is None and not np.array_equal(o, refs[i])]
    check(not bad, f"{tag}: greedy replies {bad} differ from solo decode")


def solo_refs(moe, reqs):
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    solo = CachedSequenceGenerator(moe)
    return {i: solo.generate(p[None], n)[0]
            for i, (p, n, s) in enumerate(reqs) if s is None}


def serve_moe(torch, np, moe, tag, reqs, refs, **kw):
    """A fresh LN-hooked engine on the MoE LM serving ``reqs``: B7 exactly
    what the program calls imply, B4 none, the greedy replies equal to
    ``refs``, the sampled ones replayed identically."""
    eng = hooked_engine(moe, **kw)
    try:
        (outs, secs), counts = counted(torch, moe, tag,
                                       lambda: serve_mix(eng, reqs))
        moe_replies(np, outs, reqs, refs, tag)
        replay = [(o, eng.generate(p, n, sampling=s, timeout=600))
                  for o, (p, n, s) in zip(outs, reqs) if s is not None]
        check(all(np.array_equal(a, b) for a, b in replay),
              f"{tag}: a sampled request did not replay identically")
        stats = eng.stats()
    finally:
        eng.stop()
    tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
    return {"tokens": tokens, "seconds": secs, "tokens_per_s": tokens / secs,
            "steps": stats["steps"], "prefill_chunks": stats["prefill_chunks"],
            "speculative": spec_books(stats),
            "launches": counts}, counts


def run_moe_serving(torch, np, moe, smi, gen, gen_reqs):
    """19a: phase 4's mix on the MoE LM, dense then paged; the predict
    forward with both hooks."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import ServingEngine

    detach_hooks(moe)
    check(attach_fused_layernorm(moe) == 17, "19a: LN hook not on 17 norms")
    t0 = time.monotonic()
    refs = solo_refs(moe, gen_reqs)
    solo_s = time.monotonic() - t0
    out, counts = {"solo_seconds": solo_s}, []
    for paged in (False, True):
        tag = "19a " + ("paged" if paged else "dense")
        res, c = serve_moe(torch, np, moe, tag, gen_reqs, refs, paged=paged)
        res["ratio_to_phase4"] = res["tokens_per_s"] / gen["tokens_per_s"]
        out["paged" if paged else "dense"] = res
        counts.append(c)
        log(f"{tag}: {res['tokens_per_s']:.1f} tokens/s against phase 4's "
            f"dense LM {gen['tokens_per_s']:.1f} = "
            f"{res['ratio_to_phase4']:.3f}x; greedy replies = solo decode; "
            f"{res['steps']} steps, {res['prefill_chunks']} prefill chunks; "
            f"B7 {c['layernorm_fwd']} = the program calls' on {smi}")
    # predict: the capacity-dropped forward under both hooks
    check(attach_flash_attention(moe) == 8, "19a: flash hook not on 8 blocks")
    x = np.random.default_rng(19).integers(0, 8192, (8, 512)).astype(np.int32)
    eng = ServingEngine(moe, num_slots=8, predict_batch=8).start()
    try:
        check(not eng.health()["generate_enabled"],
              "19a: a flash-hooked MoE model must be predict-only")
        eng.predict(x[:1], timeout=600)
        from distkeras_tpu_torch import kernels

        kernels.reset_launch_counts()
        t1 = time.monotonic()
        y = eng.predict(x, timeout=600)
        torch.cuda.synchronize()
        secs = time.monotonic() - t1
        pc = kernels.launch_counts()
    finally:
        eng.stop()
    check({k: n for k, n in pc.items() if n}
          == {"layernorm_fwd": 17, "flash_fwd": 8},
          f"19a predict did not run through the kernels: {pc}")
    counts.append(pc)
    check(y.shape == (8, 512, 8192) and np.isfinite(y).all(),
          f"19a predict output malformed: {y.shape}")
    # the same forward on both paths, with its routing: a near-tie router
    # logit may route a token otherwise on the two paths, and a causal
    # row's logits are compared up to its first such token
    yk, rk = routed_forward(torch, moe, x)
    detach_hooks(moe)
    yp, rp = routed_forward(torch, moe, x)
    same = same_route_prefix(torch, rk, rp)
    kerr = float(np.abs(y - yk.cpu().numpy()).max())
    diff = (yk - yp).abs().amax(dim=-1)
    share = float(same.float().mean())
    err = float(diff[same].max()) if share > 0 else float("inf")
    out["predict"] = {"seconds": secs, "launches": pc,
                      "max_abs_err_vs_plain": err,
                      "engine_vs_forward_max_abs_err": kerr,
                      "same_route_share": share}
    log(f"19a predict 8x512 (MoE, flash + LN): {secs:.3f} s, launches {pc}; "
        f"max |kernel - plain| logits {err:.3e} over {share:.4f} of the "
        f"positions (routed alike on both paths); engine vs forward "
        f"{kerr:.3e} on {smi}")
    check(kerr <= LOGIT_TOL, f"19a: the engine's predict is not the "
          f"model's forward: {kerr}")
    check(err <= LOGIT_TOL and share >= 0.99,
          f"19a predict logits disagree with the plain path: {err} over "
          f"{share} of the positions")
    return out, counts, refs


def run_moe_spec_chunked(torch, np, moe, smi, gen_reqs, refs):
    """19b: an n-gram speculative engine on phase 4's mix, and 8 of the
    templated mix's requests through 32-position prefill chunks."""
    out, counts = {}, []
    res, c = serve_moe(torch, np, moe, "19b n-gram", gen_reqs, refs,
                       speculative="ngram", draft_k=4)
    out["ngram"] = res
    counts.append(c)
    log(f"19b n-gram on phase 4's mix: {res['tokens_per_s']:.1f} tokens/s; "
        f"greedy replies = solo decode; books {res['speculative']}; B7 "
        f"{c['layernorm_fwd']} = the program calls' on {smi}")
    # the first 8 of the 16 templated requests (the rest were cut to make
    # room for phase 25; every prompt still spans 5-7 chunks)
    reqs = templated_mix(np)[:8]
    trefs = solo_refs(moe, reqs)
    res, c = serve_moe(torch, np, moe, "19b chunked", reqs, trefs,
                       prefill_chunk=32)
    out["chunked"] = res
    counts.append(c)
    log(f"19b chunked ({len(reqs)} requests, 136-200-token prompts in "
        f"32-position "
        f"chunks): {res['tokens_per_s']:.1f} tokens/s, "
        f"{res['prefill_chunks']} chunks; greedy replies = solo decode; "
        f"B7 {c['layernorm_fwd']} = the program calls' on {smi}")
    return out, counts


def moe_train_once(torch, np, zoo, hooked):
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.trainers import SingleTrainer

    rng = np.random.default_rng(19)
    starts = rng.integers(0, 8192, 8 * MOE_TRAIN_STEPS)
    x = ((starts[:, None] + np.arange(512)[None, :]) % 8192).astype(np.int32)
    moe = make_moe(zoo)
    if hooked:
        check(attach_flash_attention(moe) == 8, "19c: flash hook not on 8")
        check(attach_fused_layernorm(moe) == 17, "19c: LN hook not on 17")
    trainer = SingleTrainer(
        moe, "pallas_adam" if hooked else "adam", "next_token_crossentropy",
        metrics=["next_token_accuracy"], batch_size=8,
        window=MOE_TRAIN_WINDOW, learning_rate=1e-3, seed=0,
        device_resident=True, aux_loss_weight=0.01)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    res = trainer.train(Dataset({"features": x, "label": x}))
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    aux = [float(l.aux_loss) for l in res.layers
           if type(l).__name__ == "MoE"]
    check(not any(l.aux_loss.requires_grad for l in res.layers
                  if type(l).__name__ == "MoE"),
          "19c: a saved aux_loss carries autograd history")
    return trainer, secs, kernels.launch_counts(), aux


def run_moe_train(torch, np, zoo, smi):
    """19c: ``SingleTrainer`` on the MoE LM with the flash and LN hooks and
    pallas_adam, then the plain path; losses per step within
    TRAIN_LOSS_RTOL, the kernels launched exactly per step."""
    trainer, secs, counts, aux = moe_train_once(torch, np, zoo, True)
    plain, plain_secs, plain_counts, _ = moe_train_once(torch, np, zoo,
                                                        False)
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in trainer.get_history()]
    plain_losses = [r["loss"] for r in plain.get_history()]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    expected = {k: MOE_TRAIN_STEPS * n for k, n in LM_STEP_LAUNCHES.items()}
    def step_ms(t):
        # the second window: the first pays the cuBLAS/allocator warm-up
        return t.history.get_timings()[1][1] / MOE_TRAIN_WINDOW * 1e3

    res = {"steps": len(losses), "seconds": secs,
           "plain_seconds": plain_secs, "step_ms": step_ms(trainer),
           "plain_step_ms": step_ms(plain),
           "losses": losses, "plain_losses": plain_losses,
           "max_rel_loss_diff_vs_plain": rel, "aux_losses": aux,
           "launches": counts, "plain_launches": plain_counts}
    log(f"19c train (MoE, 4 steps of 8 x 512): step {res['step_ms']:.1f} ms "
        f"(plain path {res['plain_step_ms']:.1f}; second window); losses "
        f"{losses}; max rel diff vs plain "
        f"{rel:.2e}; aux losses {[round(a, 4) for a in aux]}; launches "
        f"{ {k: n for k, n in counts.items() if n} } on {smi}")
    check(len(losses) == len(plain_losses) == MOE_TRAIN_STEPS,
          f"19c: expected {MOE_TRAIN_STEPS} steps, got {len(losses)}")
    check(all(np.isfinite(losses + plain_losses)),
          f"19c: a loss is not finite: {losses} {plain_losses}")
    check(rel <= TRAIN_LOSS_RTOL,
          f"19c: kernel-path losses differ from the plain path by {rel:.3e}")
    check({k: n for k, n in counts.items() if n} == expected,
          f"19c: launches {counts} != {expected}")
    check(set(plain_counts.values()) == {0},
          f"19c: the plain path launched a kernel: {plain_counts}")
    return res, counts


def peak_run(torch, fn):
    """(fn's result, ms by CUDA events, peak bytes above the live ones)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated() - base


def run_blockwise(torch, np, lm, smi):
    """19d: ``blockwise_attention`` against ``dense_attention`` at (1,
    8192, 8, 64), causal and not, with both times and peaks; then
    ``attach_blockwise_attention`` on the full-width LM's forward."""
    from distkeras_tpu_torch.parallel import (
        attach_blockwise_attention,
        blockwise_attention,
        dense_attention,
    )

    dev = next(lm.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn(BLOCKWISE_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    out = {}
    for causal in (False, True):
        for _ in range(2):  # the second call of each is the one kept
            ref, dense_ms, dense_peak = peak_run(
                torch, lambda: dense_attention(q, k, v, causal=causal))
            blk, blk_ms, blk_peak = peak_run(
                torch, lambda: blockwise_attention(q, k, v, causal=causal))
        err = float((blk - ref).abs().max())
        del ref, blk
        tag = "causal" if causal else "full"
        out[tag] = {"max_abs_err": err, "dense_ms": dense_ms,
                    "blockwise_ms": blk_ms, "dense_peak_bytes": dense_peak,
                    "blockwise_peak_bytes": blk_peak}
        log(f"19d blockwise {tag} at {BLOCKWISE_SHAPE}, block 512: max "
            f"|blockwise - dense| {err:.3e}; {blk_ms:.2f} ms against dense "
            f"{dense_ms:.2f}; peak {blk_peak / 2**20:.0f} MiB against "
            f"{dense_peak / 2**20:.0f} on {smi}")
        check(err <= BLOCKWISE_TOL, f"19d {tag}: blockwise differs from "
              f"dense by {err}")
        check(blk_peak < dense_peak, f"19d {tag}: blockwise peaked at "
              f"{blk_peak} bytes, dense at {dense_peak}")
    del q, k, v
    detach_hooks(lm)
    x = np.random.default_rng(20).integers(0, 8192, (8, 512))
    ref = forward(torch, lm, x)
    check(attach_blockwise_attention(lm, block_size=128) == 8,
          "19d: blockwise hook not on 8 blocks")
    try:
        got = forward(torch, lm, x)
    finally:
        detach_hooks(lm)
    err = float((got - ref).abs().max())
    out["lm_forward_max_abs_err"] = err
    log(f"19d attach_blockwise_attention(block 128) on the d512/L8 LM's "
        f"8 x 512 forward: max |hooked - unhooked| logits {err:.3e}")
    check(err <= LOGIT_TOL, f"19d: the blockwise-hooked forward differs "
          f"from the unhooked one by {err}")
    torch.cuda.empty_cache()
    return out


def profile_moe_step(torch, np, moe, lm, steps=20):
    """``--profile``: the MoE LM's decode step beside the dense LM's (8
    busy slots, LN-hooked, dense banks), walls in turns, device times."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving.engine import DecodeStepper

    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 8192, 64) for _ in range(8)]
    steppers = {}
    for name, m in (("moe", moe), ("dense", lm)):
        detach_hooks(m)
        attach_fused_layernorm(m)
        steppers[name] = DecodeStepper(m, num_slots=8)
        for i, p in enumerate(prompts):
            steppers[name].admit(i, p)
    active = np.ones(8, bool)
    calls = {n: (lambda st=st: st.step(active)) for n, st in steppers.items()}
    walls = {n: [] for n in calls}
    for r in range(3):
        for n in (list(calls)[r % 2:] + list(calls)[: r % 2]):
            fn = calls[n]
            fn()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            walls[n].append((time.monotonic() - t0) / steps * 1e3)
    out = {}
    for n, fn in calls.items():
        prof = device_profile(torch, fn, steps)
        prof["wall_ms"] = float(np.median(walls[n]))
        if prof["device_ms"] is not None:
            prof["device_idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
        out[n] = prof
        log(f"19a profile {n} decode step: " + str(
            {k: v for k, v in prof.items() if k != "top_kernels"}))
        for kk in prof["top_kernels"]:
            log(f"  {kk}")
    del steppers
    gc.collect()
    return out


def run_phase19(torch, np, lm, zoo, smi, gen, gen_reqs, profile=False):
    """Phase 19, the MoE transformer family and blockwise attention on the
    card; returns the results and the launch counts of each drive."""
    t0 = time.monotonic()
    moe = make_moe(zoo)
    n_params, n_leaves = moe.num_params(), len(list(moe.parameters()))
    log(f"moe_transformer_lm d512/L8/E8: {n_params} parameters in "
        f"{n_leaves} leaves")
    check((n_params, n_leaves) == (MOE_PARAMS, MOE_LEAVES),
          f"19: the MoE LM has {n_params} parameters in {n_leaves} leaves")
    out = {"parameters": n_params}
    out["serving"], c_a, refs = run_moe_serving(torch, np, moe, smi, gen,
                                                gen_reqs)
    out["speculative_chunked"], c_b = run_moe_spec_chunked(
        torch, np, moe, smi, gen_reqs, refs)
    if profile:
        out["profile"] = profile_moe_step(torch, np, moe, lm)
    detach_hooks(moe)
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    out["train"], c_c = run_moe_train(torch, np, zoo, smi)
    out["blockwise"] = run_blockwise(torch, np, lm, smi)
    out["seconds_total"] = time.monotonic() - t0
    counts = [*c_a, *c_b, c_c]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ------------------------------------------------------------------ phase 20


SYNC_STEPS = 4
SYNC_WINDOW = 2  # step times come from the second window (the first warms)
SYNC_LOSS_RTOL = 1e-5  # 20b's losses vs 20a's, relative
SYNC_PARAM_TOL = 1e-4  # 20b's parameters vs 20a's, max absolute
BN_STATS_RTOL, BN_STATS_ATOL = 1e-4, 1e-5  # 20c moving statistics
BN_WEIGHT_TOL = 1e-4  # 20c weights, absolute
BN_LR, BN_GLOBAL_BATCH = 0.05, 32  # config 4's sgd rate; 20c's batch
SYNC_RANKS = 2
SYNC_RANK_TIMEOUT = 240  # seconds a 20b/20c rank may take, spawn included


def sync_corpus():
    """Phase 5's corpus cut to 20a's 4 steps of 8 x 512."""
    from distkeras_tpu_torch.data import loaders

    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    return ds.take(8 * SYNC_STEPS)


def sync_lm_run(torch, zoo, cls, ds, batch_size=8, flash=True, **kw):
    """Phase 5's trainer configuration (``pallas_adam``, both hooks,
    device-resident, seed 0) on a fresh d512/L8 LM, two windows of 2 steps
    (``flash=False``: dense attention instead of the flash hook); the
    launch counts are set to 0 just before ``train`` and read just after.
    Returns (trainer, result, counts, seconds)."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = make_lm(zoo)
    check(not flash or attach_flash_attention(lm) == 8,
          "20: flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "20: LN hook not on 17 norms")
    trainer = cls(lm, "pallas_adam", "next_token_crossentropy",
                  metrics=["next_token_accuracy"], batch_size=batch_size,
                  window=SYNC_WINDOW, learning_rate=1e-3, seed=0,
                  device_resident=True, **kw)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    result = trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    return trainer, result, kernels.launch_counts(), time.monotonic() - t0


def bn_data():
    """Config 4's data recipe (phase 7) at 4 steps of 20c's global batch."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.transformers import (
        MinMaxTransformer,
        OneHotTransformer,
    )

    ds = loaders.synthetic_cifar10(n=BN_GLOBAL_BATCH * SYNC_STEPS, seed=2,
                                   protos_per_class=3, label_noise=0.1)
    ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return OneHotTransformer(10, output_col="label_onehot").transform(ds)


def bn_run(torch, cls, batch_size, cudnn=True, **kw):
    """Config 4's ``cifar10_cnn(bn_momentum=0.9)`` with ``pallas_sgd``
    (B1) over 20c's data, f32, with cuDNN's deterministic algorithms: by
    default cuDNN picks other convolution algorithms at 16 rows than at
    32, whose f32 rounding four SGD steps at 0.05 carry to 3.4e-4 in a
    moving mean (2.8e-6 with these algorithms, and 1.8e-7 between two
    runs at 32 rows either way, on an H100 80GB HBM3 at 700 W).
    ``cudnn=False`` runs ATen's own convolutions instead of cuDNN's.
    Returns (result, counts)."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.models import zoo

    model = zoo.cifar10_cnn(bn_momentum=0.9, seed=0)
    trainer = cls(model, "pallas_sgd", "categorical_crossentropy",
                  learning_rate=BN_LR, batch_size=batch_size,
                  label_col="label_onehot", window=SYNC_STEPS, seed=0, **kw)
    deterministic = torch.backends.cudnn.deterministic
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.enabled = cudnn
    try:
        kernels.reset_launch_counts()
        result = trainer.train(bn_data(), shuffle=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.enabled = enabled
    return result, kernels.launch_counts()


def state_host(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def step_ms(trainer):
    """A step's wall in the second window (the first pays the warm-up)."""
    return trainer.history.get_timings()[1][1] / SYNC_WINDOW * 1e3


def collective_ms(torch, np, mesh, model, zero=False, reps=3):
    """Mean time of one step's collectives on this group, between CUDA
    events on the current stream: the gradient bucket's all-reduce (pack,
    all-reduce, divide), or with ``zero`` the ZeRO-1 all-gather and
    write-back."""
    from distkeras_tpu_torch.parallel.mesh import ZeroShards, all_reduce_mean

    params = list(model.parameters())
    if zero:
        shards = ZeroShards(params, mesh)
        call = shards.gather
    else:
        grads = [torch.ones_like(p) for p in params]
        mets = [torch.zeros((), device=mesh.device)] * 2

        def call():
            all_reduce_mean([*grads, *mets], mesh)
    call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def sync_rank_main(out_dir):
    """A 20b/20c rank: joins the gloo group from the ``DKT_*`` env (two
    processes on the one card), trains phase 5's LM replicated and with
    ZeRO-1 at 4 rows a rank, then config 4's CNN at 16 a rank, and writes
    its parameters, losses, launch counts and collective times."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import SynchronousDistributedTrainer as Sync
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(multihost.initialize(timeout=SYNC_RANK_TIMEOUT),
          "20b: the rank did not join a group")
    rank = multihost.process_id()
    ds = sync_corpus()
    arrays, info = {}, {"launches": {}, "seconds": {}, "step_ms": {}}
    for tag, zero in (("replicated", False), ("zero", True)):
        t, res, counts, secs = sync_lm_run(torch, zoo, Sync, ds, batch_size=4,
                                           shard_opt_state=zero)
        arrays.update({f"{tag}/{k}": v for k, v in state_host(res).items()})
        arrays[f"{tag}/loss"] = np.array([h["loss"] for h in t.get_history()])
        info["launches"][tag], info["seconds"][tag] = counts, secs
        info["step_ms"][tag] = step_ms(t)
        if zero:
            info["gather_ms"] = collective_ms(torch, np, t.mesh, res, True)
        else:
            info["all_reduce_ms"] = collective_ms(torch, np, t.mesh, res)
        del t, res
        torch.cuda.empty_cache()
    res, counts = bn_run(torch, Sync, BN_GLOBAL_BATCH // SYNC_RANKS)
    arrays.update({f"bn/{k}": v for k, v in state_host(res).items()})
    info["launches"]["bn"] = counts
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multihost.shutdown()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_sync_one_rank(torch, np, zoo, smi, ds):
    """20a: one NCCL rank over a TCPStore on a free localhost port, against
    phase 5's ``SingleTrainer`` at the same batch, data and seed — bit
    for bit, replicated and with ZeRO-1 (whose one slice is the whole
    leaf: the fused Adam runs on the slice buffers and the all-gather
    writes them back)."""
    import datetime

    import torch.distributed as dist

    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch import SynchronousDistributedTrainer as Sync

    ref, ref_res, _, _ = sync_lm_run(torch, zoo, SingleTrainer, ds)
    ref_losses = [h["loss"] for h in ref.get_history()]
    ref_params = [p.detach().clone() for p in ref_res.parameters()]
    ref_step_ms = step_ms(ref)
    del ref, ref_res
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    out, counts = {"reference_losses": ref_losses,
                   "reference_step_ms": ref_step_ms}, []
    try:
        for tag, zero in (("replicated", False), ("zero", True)):
            t, res, c, secs = sync_lm_run(torch, zoo, Sync, ds,
                                          shard_opt_state=zero)
            check(t.mesh.group is not None and t.num_workers == 1,
                  "20a: the trainer did not take the NCCL group")
            losses = [h["loss"] for h in t.get_history()]
            same = all(torch.equal(a, b)
                       for a, b in zip(res.parameters(), ref_params))
            ms = step_ms(t)
            coll = collective_ms(torch, np, t.mesh, res, zero)
            out[tag] = {"losses": losses, "seconds": secs,
                        "step_ms": ms, "collective_ms": coll,
                        "collective_share": coll / ms,
                        "bit_equal_losses": losses == ref_losses,
                        "bit_equal_params": same, "launches": c}
            out[f"{tag}_params"] = {n: p.detach().clone()
                                    for n, p in res.named_parameters()}
            counts.append(c)
            del t, res
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    expected = {k: SYNC_STEPS * n for k, n in LM_STEP_LAUNCHES.items()}
    for tag in ("replicated", "zero"):
        r = out[tag]
        log(f"20a {tag} (1 NCCL rank, 4 steps of 8 x 512): step "
            f"{r['step_ms']:.1f} ms (SingleTrainer {ref_step_ms:.1f}; second "
            f"window), {'all-gather' if tag == 'zero' else 'all-reduce'}"
            f" {r['collective_ms']:.2f} ms = {100 * r['collective_share']:.1f}"
            f"% of the step; losses {r['losses']}; bit-equal to "
            f"SingleTrainer: losses {r['bit_equal_losses']}, parameters "
            f"{r['bit_equal_params']}; launches "
            f"{ {k: n for k, n in r['launches'].items() if n} } on {smi}")
        check(r["bit_equal_losses"] and r["bit_equal_params"],
              f"20a {tag}: not bit-equal to SingleTrainer: {r['losses']} vs "
              f"{ref_losses}")
        check({k: n for k, n in r["launches"].items() if n} == expected,
              f"20a {tag}: launches {r['launches']} != {expected}")
    return out, counts


def run_rank_pair(np, flag, tag, timeout, ranks=SYNC_RANKS):
    """Two rank processes of this script (``ranks`` of them) on the one
    card, joined in a gloo group through the ``DKT_*`` env (NCCL refuses
    two ranks on one device), each started with ``flag DIR`` and writing
    ``rank{r}.npz`` and ``rank{r}.json`` there. Returns (arrays, infos,
    wall seconds); fails if a rank does not exit 0 within ``timeout``."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=HERE)
    env = dict(os.environ, DKT_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               DKT_NUM_PROCESSES=str(ranks), DKT_BACKEND="gloo")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), flag, out_dir],
        env=dict(env, DKT_PROCESS_ID=str(r)), cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    deadline = t0 + timeout
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    try:
        for r, (p, text) in enumerate(zip(procs, logs)):
            check(p.returncode == 0,
                  f"{tag} rank {r} exited {p.returncode}:\n{text[-3000:]}")
        arrays = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                  for r in range(ranks)]
        infos = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                infos.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return arrays, infos, wall


def run_sync_two_ranks(torch, np, smi, one_rank):
    """20b and 20c: two rank processes on the one card over gloo (NCCL
    refuses two ranks on one device), launched with the ``DKT_*`` env;
    20c's reference, one rank at the global batch, runs here first."""
    from distkeras_tpu_torch import SingleTrainer

    bn_ref, bn_ref_counts = bn_run(torch, SingleTrainer, BN_GLOBAL_BATCH)
    bn_ref = state_host(bn_ref)
    ranks, infos, wall = run_rank_pair(np, "--sync-rank-out", "20b",
                                       SYNC_RANK_TIMEOUT)
    check(ranks[0].keys() == ranks[1].keys(), "20b: the ranks' keys differ")
    unequal = [k for k in ranks[0]
               if not np.array_equal(ranks[0][k], ranks[1][k])]
    check(not unequal, f"20b: the ranks differ in {unequal[:5]}")
    rank0 = ranks[0]
    res = {"wall_s": wall, "rank_infos": infos}
    for tag in ("replicated", "zero"):
        losses = rank0[f"{tag}/loss"]
        ref = np.array(one_rank[tag]["losses"])
        rel = float(np.max(np.abs(losses - ref) / np.abs(ref)))
        dist_ = max(float(np.max(np.abs(rank0[f"{tag}/{n}"]
                                        - p.cpu().numpy())))
                    for n, p in one_rank[f"{tag}_params"].items())
        res[tag] = {"losses": losses.tolist(), "max_rel_loss_vs_20a": rel,
                    "max_param_distance_vs_20a": dist_}
        check(rel <= SYNC_LOSS_RTOL,
              f"20b {tag}: losses differ from 20a by {rel:.3e}")
        check(dist_ <= SYNC_PARAM_TOL,
              f"20b {tag}: parameters differ from 20a by {dist_:.3e}")
    expected = {k: SYNC_STEPS * n for k, n in LM_STEP_LAUNCHES.items()}
    for info in infos:
        for tag in ("replicated", "zero"):
            got = {k: n for k, n in info["launches"][tag].items() if n}
            check(got == expected,
                  f"20b {tag}: a rank's launches {got} != {expected}")
        check(info["launches"]["bn"].get("sgd_fused", 0) == SYNC_STEPS,
              f"20c: a rank's launches {info['launches']['bn']}")
    stats_ok, weights_ok, worst = True, True, {}
    for k, ref in bn_ref.items():
        got = rank0[f"bn/{k}"]
        d = float(np.max(np.abs(got - ref)))
        worst[k] = d
        if k.endswith((".mean", ".var")):
            stats_ok &= bool(np.allclose(got, ref, rtol=BN_STATS_RTOL,
                                         atol=BN_STATS_ATOL))
        else:
            weights_ok &= d <= BN_WEIGHT_TOL
    res["bn"] = {"max_abs_diff": max(worst.values()),
                 "stats_ok": stats_ok, "weights_ok": weights_ok,
                 "reference_launches": bn_ref_counts}
    ar = [i["all_reduce_ms"] for i in infos]
    ga = [i["gather_ms"] for i in infos]
    step = [i["step_ms"]["replicated"] for i in infos]
    zstep = [i["step_ms"]["zero"] for i in infos]
    res.update(all_reduce_ms=ar, gather_ms=ga, step_ms=step,
               zero_step_ms=zstep)
    log(f"20b (2 gloo ranks on one card, 4 steps of 2 x 4 x 512): the ranks "
        f"bit-equal; vs 20a: losses within "
        f"{res['replicated']['max_rel_loss_vs_20a']:.2e} / "
        f"{res['zero']['max_rel_loss_vs_20a']:.2e} (replicated / ZeRO-1), "
        f"parameters within "
        f"{res['replicated']['max_param_distance_vs_20a']:.2e} / "
        f"{res['zero']['max_param_distance_vs_20a']:.2e}; step "
        f"{step} / {zstep} ms, gradient all-reduce (host-staged) "
        f"{ar} ms, ZeRO all-gather {ga} ms; ranks' wall {wall:.1f} s on "
        f"{smi}")
    log(f"20c (cifar10_cnn, 2 ranks x 16 vs 1 x 32, pallas_sgd): max "
        f"|diff| {res['bn']['max_abs_diff']:.2e}, stats within "
        f"rtol {BN_STATS_RTOL} / atol {BN_STATS_ATOL}: {stats_ok}, weights "
        f"within {BN_WEIGHT_TOL}: {weights_ok} on {smi}")
    check(stats_ok, f"20c: moving statistics differ: {worst}")
    check(weights_ok, f"20c: weights differ: {worst}")
    counts = [i["launches"][tag] for i in infos
              for tag in ("replicated", "zero", "bn")]
    return res, counts


def run_phase20(torch, np, zoo, smi):
    """Phase 20, synchronous data parallelism: 20a at one NCCL rank, 20b and
    20c across two processes on the card. Returns the results and the
    launch counts of each drive."""
    t0 = time.monotonic()
    ds = sync_corpus()
    one, c_a = run_sync_one_rank(torch, np, zoo, smi, ds)
    two, c_b = run_sync_two_ranks(torch, np, smi, one)
    for tag in ("replicated", "zero"):
        one.pop(f"{tag}_params")
    out = {"one_rank": one, "two_ranks": two,
           "seconds_total": time.monotonic() - t0}
    counts = [*c_a, *c_b]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ------------------------------------------------------------------ phase 21


TPSP_LOSS_RTOL = 1e-3  # 21a-21c losses vs the one-rank SingleTrainer
TPSP_RANK_TIMEOUT = 360  # seconds a phase-21 rank may take, spawn included
SP_STEP_LAUNCHES = {"layernorm_fwd": 17, "layernorm_bwd": 17,
                    "adam_fused": 1}  # the ring / Ulysses replace flash


def sp_lm_run(torch, zoo, ds, mode, inner="dense"):
    """``SequenceParallelTrainer`` on phase 5's LM (both hooks attached by
    the caller: the ring or Ulysses replaces the flash hook), ``pallas_adam``,
    the global 8 x 512 batch, two windows of 2 steps; the launch counts are
    set to 0 just before ``train`` and read just after."""
    from distkeras_tpu_torch import SequenceParallelTrainer, kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = make_lm(zoo)
    check(attach_flash_attention(lm) == 8, "21: flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "21: LN hook not on 17 norms")
    trainer = SequenceParallelTrainer(
        lm, "pallas_adam", "next_token_crossentropy",
        metrics=["next_token_accuracy"], batch_size=8, window=SYNC_WINDOW,
        learning_rate=1e-3, seed=0, sp_mode=mode, sp_inner=inner)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    result = trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    check(all(l.attention_fn is None for l in lm.modules()
              if hasattr(l, "attention_fn")),
          "21: the caller's model kept an attention hook")
    return trainer, result, kernels.launch_counts(), time.monotonic() - t0


def timed_ms(torch, np, group, call, reps=5):
    """Mean host time of ``call()`` on this group, the card synced and the
    ranks met around it."""
    call()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        group.barrier()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times))


def exchange_ms(torch, np, group, kind, shape, reps=5):
    """Mean host time of one exchange of an f32 tensor of ``shape`` on
    this group, the card synced around it: a ring hop
    (``DataMesh.send_recv_``) or an all-to-all of n rows
    (``DataMesh.all_to_all_``), on the path the group's backend takes."""
    x = torch.randn(shape, device=group.device)
    out = torch.empty_like(x)
    if kind == "ring":
        def call():
            group.send_recv_(out, x, 1)
    else:
        def call():
            group.all_to_all_(out, x)
    return timed_ms(torch, np, group, call, reps)


def exchange_plan(mode, n=SYNC_RANKS, b=8, t=512, h=8, d=64, layers=8):
    """(kind, shape, calls) of the exchanges one training step of phase
    5's LM makes at ``n`` sequence ranks: the ring hops a (2, B, T/n, H,
    D) K/V block n-1 times a layer forward and again backward; Ulysses
    all-to-alls the stacked (3, B, T/n, H, D) q/k/v and the (B, T, H/n, D)
    output (as n rows) once each a layer forward and again backward."""
    if mode == "ring":
        return [("ring", (2, b, t // n, h, d), 2 * layers * (n - 1))]
    return [("a2a", (n, 3, b, t // n, h // n, d), 2 * layers),
            ("a2a", (n, b, t // n, h // n, d), 2 * layers)]


def tpsp_rank_main(out_dir):
    """A phase-21 rank: joins the gloo group from the ``DKT_*`` env (two
    processes on the one card) and runs 21a (tensor parallelism on phase
    5's LM), 21b and 21c (sequence parallelism, ring and Ulysses) and 21d
    (tensor parallelism on config 4's CNN), then times the exchanges
    alone; writes its results, launch counts and times."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import SynchronousDistributedTrainer as Sync
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.parallel import multihost
    from distkeras_tpu_torch.parallel import tensor_parallel as tp
    from distkeras_tpu_torch.parallel.mesh import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(multihost.initialize(timeout=TPSP_RANK_TIMEOUT),
          "21: the rank did not join a group")
    rank = multihost.process_id()
    ds = sync_corpus()
    arrays = {}
    info = {"launches": {}, "seconds": {}, "step_ms": {}}

    def keep(tag, trainer, res, counts, secs):
        arrays.update({f"{tag}/{k}": v for k, v in state_host(res).items()})
        arrays[f"{tag}/loss"] = np.array(
            [h["loss"] for h in trainer.get_history()])
        info["launches"][tag], info["seconds"][tag] = counts, secs
        info["step_ms"][tag] = step_ms(trainer)

    t, res, counts, secs = sync_lm_run(torch, zoo, Sync, ds,
                                       model_parallel=SYNC_RANKS)
    check(t.mesh.shape == {"data": 1, "model": SYNC_RANKS},
          f"21a: mesh {t.mesh.shape}")
    keep("tp", t, res, counts, secs)
    lm = make_lm(zoo)
    whole = sum(p.numel() * p.element_size() for p in lm.parameters())
    split = tp.attach_model_group(lm, t.mesh)
    info["param_bytes"] = {
        "whole": whole, "leaves_split": split,
        "leaves": len(list(lm.parameters())),
        "held": sum(p.numel() * p.element_size() for p in lm.parameters())}
    del t, res, lm
    torch.cuda.empty_cache()
    for tag, mode, inner in (("ring", "ring", "dense"),
                             ("ulysses", "ulysses", "blockwise")):
        t, res, counts, secs = sp_lm_run(torch, zoo, ds, mode, inner)
        keep(tag, t, res, counts, secs)
        del t, res
        torch.cuda.empty_cache()
    for tag, cudnn in (("bn", False), ("bn_cudnn", True)):
        res, counts = bn_run(torch, Sync, BN_GLOBAL_BATCH, cudnn=cudnn,
                             model_parallel=SYNC_RANKS)
        arrays.update({f"{tag}/{k}": v for k, v in state_host(res).items()})
        info["launches"][tag] = counts
    seq = make_grid(1, SYNC_RANKS, "seq", data_axis=False).inner
    info["backend"] = seq.backend
    info["exchanges"] = {}
    for mode in ("ring", "ulysses"):
        rows = []
        for kind, shape, calls in exchange_plan(mode):
            ms = exchange_ms(torch, np, seq, kind, shape)
            nbytes = 4 * int(np.prod(shape))
            # a ring hop sends the whole block, an all-to-all all rows but
            # the rank's own
            sent = nbytes if kind == "ring" else nbytes * (SYNC_RANKS - 1) \
                // SYNC_RANKS
            rows.append({"kind": kind, "shape": list(shape), "calls": calls,
                         "ms": ms, "bytes_sent": sent,
                         "staged": seq.stages("send_recv" if kind == "ring"
                                              else "all_to_all",
                                              torch.empty(0,
                                                          device=seq.device))})
        info["exchanges"][mode] = {
            "rows": rows,
            "bytes_per_step": sum(r["bytes_sent"] * r["calls"] for r in rows),
            "ms_per_step": sum(r["ms"] * r["calls"] for r in rows)}
    seq.release()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multihost.shutdown()
    return 0


def run_phase21(torch, np, zoo, smi):
    """Phase 21, tensor and sequence parallelism: two gloo rank processes
    on the card (NCCL refuses two ranks on one device) against the port's
    one-rank ``SingleTrainer`` on the same batches. Returns the results
    and the launch counts of each drive."""
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.parallel.mesh import HOST_STAGED

    t0 = time.monotonic()
    path = {op: ("pinned host buffers" if op in HOST_STAGED.get("gloo", ())
                 else "CUDA tensors to gloo")
            for op in ("send_recv", "all_to_all", "all_gather",
                       "all_reduce")}
    log(f"21: gloo exchange path, chosen by the backend: {path}")
    ds = sync_corpus()
    refs = {}
    for flash in (True, False):
        # the sequence-parallel runs replace the flash hook by their
        # exchanges: their reference is one rank on dense attention
        ref, ref_res, _, _ = sync_lm_run(torch, zoo, SingleTrainer, ds,
                                         flash=flash)
        refs[flash] = (np.array([h["loss"] for h in ref.get_history()]),
                       state_host(ref_res), step_ms(ref))
        del ref, ref_res
    ref_losses, ref_params, ref_step = refs[True]
    bn_refs = {tag: state_host(bn_run(torch, SingleTrainer, BN_GLOBAL_BATCH,
                                      cudnn=cudnn)[0])
               for tag, cudnn in (("bn", False), ("bn_cudnn", True))}
    torch.cuda.empty_cache()
    ranks, infos, wall = run_rank_pair(np, "--tpsp-rank-out", "21",
                                       TPSP_RANK_TIMEOUT)
    check(ranks[0].keys() == ranks[1].keys(), "21: the ranks' keys differ")
    unequal = [k for k in ranks[0]
               if not np.array_equal(ranks[0][k], ranks[1][k])]
    check(not unequal, f"21: the ranks differ in {unequal[:5]}")
    rank0 = ranks[0]
    out = {"gloo_path": path, "backend": infos[0]["backend"], "wall_s": wall,
           "reference_losses": ref_losses.tolist(),
           "reference_step_ms": ref_step, "rank_infos": infos}
    lm_expected = {k: SYNC_STEPS * n for k, n in LM_STEP_LAUNCHES.items()}
    sp_expected = {k: SYNC_STEPS * n for k, n in SP_STEP_LAUNCHES.items()}
    def distances(tag, flash):
        losses, params, _ = refs[flash]
        got = rank0[f"{tag}/loss"]
        rel = float(np.max(np.abs(got - losses) / np.abs(losses)))
        far = max(float(np.max(np.abs(rank0[f"{tag}/{k}"] - v)))
                  for k, v in params.items())
        return rel, far

    failures = []
    for tag, name, expected, flash in (("tp", "21a", lm_expected, True),
                                       ("ring", "21b", sp_expected, False),
                                       ("ulysses", "21c", sp_expected, False)):
        rel, far = distances(tag, flash)
        out[tag] = {"losses": rank0[f"{tag}/loss"].tolist(),
                    "reference": "flash" if flash else "dense",
                    "max_rel_loss": rel, "max_param_distance": far,
                    "vs_other_reference": distances(tag, not flash),
                    "step_ms": [i["step_ms"][tag] for i in infos],
                    "launches": infos[0]["launches"][tag]}
        if rel > TPSP_LOSS_RTOL:
            failures.append(f"{name}: losses differ from SingleTrainer's by "
                            f"{rel:.3e}")
        if far > SYNC_PARAM_TOL:
            failures.append(f"{name}: parameters differ from SingleTrainer's"
                            f" by {far:.3e}")
        for info in infos:
            got = {k: n for k, n in info["launches"][tag].items() if n}
            if got != expected:
                failures.append(f"{name}: a rank's launches {got} != "
                                f"{expected}")
    for info in infos:
        for tag in ("bn", "bn_cudnn"):
            got = {k: n for k, n in info["launches"][tag].items() if n}
            if got != {"sgd_fused": SYNC_STEPS}:
                failures.append(f"21d: a rank's launches {got}")
    for tag, ref_state in bn_refs.items():
        stats_ok, weights_ok, worst = True, True, {}
        for k, ref in ref_state.items():
            got = rank0[f"{tag}/{k}"]
            worst[k] = float(np.max(np.abs(got - ref)))
            if k.endswith((".mean", ".var")):
                stats_ok &= bool(np.allclose(got, ref, rtol=BN_STATS_RTOL,
                                             atol=BN_STATS_ATOL))
            else:
                weights_ok &= worst[k] <= BN_WEIGHT_TOL
        out[tag] = {"max_abs_diff": max(worst.values()),
                    "stats_ok": stats_ok, "weights_ok": weights_ok,
                    "worst": worst}
    stats_ok, weights_ok = out["bn"]["stats_ok"], out["bn"]["weights_ok"]
    pb = infos[0]["param_bytes"]
    out["param_bytes"] = [i["param_bytes"] for i in infos]
    log(f"21a (TP, data 1 x model 2, 4 steps of 8 x 512): losses within "
        f"{out['tp']['max_rel_loss']:.2e} of SingleTrainer (flash hook), "
        f"parameters within {out['tp']['max_param_distance']:.2e} (dense "
        f"reference: {out['tp']['vs_other_reference']}); each rank holds "
        f"{pb['held']} of {pb['whole']} parameter bytes "
        f"({pb['leaves_split']} of {pb['leaves']} leaves split); step "
        f"{out['tp']['step_ms']} ms (SingleTrainer {ref_step:.1f}); "
        f"launches a rank {out['tp']['launches']} on {smi}")
    for tag, name in (("ring", "21b"), ("ulysses", "21c")):
        ex = infos[0]["exchanges"][tag]
        out[tag]["exchanges"] = [i["exchanges"][tag] for i in infos]
        log(f"{name} (SP {tag}{', blockwise inner' if tag == 'ulysses' else ''}"
            f", seq 2, T 512): losses within {out[tag]['max_rel_loss']:.2e}"
            f" of SingleTrainer (dense attention), parameters within "
            f"{out[tag]['max_param_distance']:.2e} (flash reference: "
            f"{out[tag]['vs_other_reference']}); step "
            f"{out[tag]['step_ms']} ms; exchanges a step "
            f"{ex['bytes_per_step']} bytes sent a rank, "
            f"{ex['ms_per_step']:.1f} ms timed alone "
            f"({[(r['kind'], r['calls'], round(r['ms'], 3)) for r in ex['rows']]}"
            f" calls x ms); launches a rank {out[tag]['launches']} on {smi}")
    log(f"21d (TP cifar10_cnn, model 2 vs 1 rank, pallas_sgd, ATen's "
        f"convolutions): max |diff| {out['bn']['max_abs_diff']:.2e}, stats "
        f"within rtol {BN_STATS_RTOL} / atol {BN_STATS_ATOL}: {stats_ok}, "
        f"weights within {BN_WEIGHT_TOL}: {weights_ok}; with cuDNN's "
        f"deterministic algorithms on both sides: max |diff| "
        f"{out['bn_cudnn']['max_abs_diff']:.2e} on {smi}")
    check(not failures, "; ".join(failures))
    check(stats_ok, f"21d: moving statistics differ: {out['bn']['worst']}")
    check(weights_ok, f"21d: weights differ: {out['bn']['worst']}")
    out["seconds_total"] = time.monotonic() - t0
    counts = [i["launches"][tag] for i in infos
              for tag in ("tp", "ring", "ulysses", "bn", "bn_cudnn")]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ------------------------------------------------------------------ phase 22


P22_RTOL = 1e-4  # 22a-22c losses vs one rank, relative
P22_PARAM_TOL = 1e-4  # 22a-22c parameters vs one rank, max absolute
#: 22b vs one rank once a routing tie has flipped: 4 rows a rank change
#: the GEMMs' rounding (router logits 1e-5 apart), a token whose top two
#: logits are closer than that can take the other expert, and Adam moves
#: the entries whose gradient that flips by up to lr a step
P22B_FIRST_RTOL = 1e-5  # the first step's loss, before any update
P22B_RTOL = 1e-3  # every step's loss (phase 21's bar)
P22B_PARAM_TOL = 2 * 1e-3 * SYNC_STEPS  # trained parameters, max absolute
P22_RANK_TIMEOUT = 360  # seconds a phase-22 rank may take, spawn included
PIPE_MICRO = 4  # 22c's microbatches
PIPE_TICKS = PIPE_MICRO + SYNC_RANKS - 1  # the lockstep GPipe schedule
#: 22c's launches a step on each rank: every stage runs its 4 blocks at
#: every tick of the lockstep schedule, forward and backward, and the
#: final LayerNorm once
PIPE_STEP_LAUNCHES = {
    "flash_fwd": PIPE_TICKS * 4, "flash_bwd_dq": PIPE_TICKS * 4,
    "flash_bwd_dkv": PIPE_TICKS * 4, "layernorm_fwd": PIPE_TICKS * 8 + 1,
    "layernorm_bwd": PIPE_TICKS * 8 + 1, "adam_fused": 1}


def first_routes(torch, model, rec):
    """Forward hooks on the MoE layers of ``model`` (the trainer's copy
    carries them) recording each layer's routing of the first forward,
    global over the layer's data group — per token its expert, or -1
    where the capacity drops it — with the rank's router logits and the
    capacity."""
    from distkeras_tpu_torch.parallel.expert_parallel import MoE, route_global

    moe = [l for l in model.layers if isinstance(l, MoE)]

    def hook(layer, args, out):
        if len(rec) >= len(moe):
            return
        x = args[0]
        data = layer.data_group
        if data is not None and data.num_workers <= 1:
            data = None
        with torch.no_grad():
            logits = x.reshape(-1, x.shape[-1]).float() @ layer.router
            idx, pos, _, cap, _ = route_global(logits, layer.capacity_factor,
                                               data)
        rec.append((torch.where(pos < cap, idx, -1).reshape(x.shape[:-1])
                    .cpu().numpy(), logits.cpu().numpy(), cap))

    for layer in moe:
        layer.register_forward_hook(hook)


def p22_run(torch, zoo, cls, ds, moe, batch_size=8, **kw):
    """Phase 5's trainer configuration (``pallas_adam``, both hooks, seed
    0, two windows of 2 steps) on a fresh MoE LM (``moe``) or d512/L8 LM;
    the launch counts are set to 0 just before ``train`` and read just
    after. Returns (trainer, result, counts, seconds, first routes)."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    model = make_moe(zoo) if moe else make_lm(zoo)
    check(attach_flash_attention(model) == 8, "22: flash hook not on 8")
    check(attach_fused_layernorm(model) == 17, "22: LN hook not on 17")
    routes = []
    if moe:
        first_routes(torch, model, routes)
    trainer = cls(model, "pallas_adam", "next_token_crossentropy",
                  metrics=["next_token_accuracy"], batch_size=batch_size,
                  window=SYNC_WINDOW, learning_rate=1e-3, seed=0, **kw)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    result = trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    return (trainer, result, kernels.launch_counts(),
            time.monotonic() - t0, routes)


def pipe_exchanges(torch, np, group, b=8, t=512, d=512):
    """(kind, bytes a rank sends, calls a step, ms alone) of 22c's
    exchanges: the ring hop of one f32 microbatch activation (b/M rows)
    at every tick but the last, forward and backward; the all-gather of
    the (M, b/M, t, d) outputs over the pipe group; the all-reduce of the
    pre-block layers' (b, t, d) input gradient (the copy's backward)."""
    mb = b // PIPE_MICRO
    hop = torch.randn(mb, t, d, device=group.device)
    hop_out = torch.empty_like(hop)
    outs = torch.randn(b, t, d, device=group.device)
    gathered = torch.empty(group.num_workers * outs.numel(),
                           device=group.device)
    grad = torch.randn(b, t, d, device=group.device)
    n = group.num_workers
    rows = [
        ("ring hop", hop.numel() * 4, 2 * (PIPE_TICKS - 1),
         timed_ms(torch, np, group, lambda: group.send_recv_(hop_out, hop))),
        ("output all-gather", outs.numel() * 4, 1,
         timed_ms(torch, np, group,
                  lambda: group.all_gather_(gathered, outs))),
        ("input-gradient all-reduce", grad.numel() * 4 * (n - 1) // n, 1,
         timed_ms(torch, np, group, lambda: group.all_reduce_(grad))),
    ]
    return [{"kind": k, "bytes_sent": nb, "calls": c, "ms": ms}
            for k, nb, c, ms in rows]


def check_routes(np, out, tag, name, ranks, ref, cap):
    """The first step's routing of every MoE layer (B, T, layers): (1) the
    ranks' kept mask is one rank's routing rule applied to the ranks' own
    logits put together in global token order (the global batch's
    capacity and queue places, bit for bit); (2) against the one-rank run:
    22a's ranks hold every row and route exactly alike; in 22b every
    token whose top-1 expert differs from the one-rank run's has its top
    two router logits there closer than twice the layer's largest logit
    difference between the two runs (a rounding tie), and through (1)
    every other difference (a kept token dropped, or the reverse) follows
    from such a tie's shift of its expert's queue. Returns the
    failures."""
    import torch

    from distkeras_tpu_torch.parallel.expert_parallel import _route

    failures = []
    mine = [r[f"{tag}/routes"] for r in ranks]
    logits = [r[f"{tag}/logits"] for r in ranks]
    if tag == "ep":
        routes, glob = mine[0], logits[0]
        if not all(np.array_equal(m, mine[0]) for m in mine[1:]):
            failures.append(f"{name}: the ranks route differently")
    else:
        routes = np.concatenate(mine)
        glob = np.concatenate(logits, axis=1)
    rule_ok = True
    for layer in range(glob.shape[0]):
        idx, pos, _, _ = _route(torch.from_numpy(glob[layer]), cap)
        want = np.where(pos.numpy() < cap, idx.numpy(), -1)
        rule_ok &= bool(np.array_equal(want, routes[..., layer].reshape(-1)))
    if not rule_ok:
        failures.append(f"{name}: the ranks' routing is not one rank's rule "
                        "on their logits (global capacity and places)")
    ref_routes, ref_logits = ref["routes"], ref["logits"]
    differ = routes != ref_routes
    ties, untied = 0, 0
    for layer in range(ref_logits.shape[0]):
        flips = np.nonzero(np.argmax(glob[layer], axis=1)
                           != np.argmax(ref_logits[layer], axis=1))[0]
        if not len(flips):
            continue
        drift = float(np.max(np.abs(glob[layer] - ref_logits[layer])))
        top2 = np.sort(ref_logits[layer][flips], axis=1)[:, -2:]
        tied = (top2[:, 1] - top2[:, 0]) <= 2 * drift
        ties += int(np.sum(tied))
        untied += int(np.sum(~tied))
    out[tag].update({"routing_rule_exact": rule_ok,
                     "routes_differing": int(np.sum(differ)),
                     "routing_ties": ties,
                     "max_logit_drift": float(np.max(np.abs(
                         glob - ref_logits))),
                     "dropped": int(np.sum(ref_routes < 0)),
                     "tokens_routed": int(ref_routes.size),
                     "capacity": cap})
    if untied or (tag == "ep" and differ.any()):
        failures.append(f"{name}: the first step's routing differs from one "
                        f"rank's at {int(np.sum(differ))} of {differ.size} "
                        f"(token, layer) places; {untied} top-1 experts "
                        "differ beyond a rounding tie")
    return failures


def p22_rank_main(out_dir):
    """A phase-22 rank: joins the gloo group from the ``DKT_*`` env (two
    processes on the one card) and runs 22a (``expert_parallel=2`` on the
    MoE LM), 22b (pure data parallelism on it) and 22c
    (``PipelineParallelTrainer`` at S = 2 on phase 5's LM), then times
    22c's exchanges alone; writes its results, launch counts and times."""
    import numpy as np
    import torch

    from distkeras_tpu_torch import PipelineParallelTrainer
    from distkeras_tpu_torch import SynchronousDistributedTrainer as Sync
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.parallel import expert_parallel as ep
    from distkeras_tpu_torch.parallel import multihost
    from distkeras_tpu_torch.parallel.mesh import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(multihost.initialize(timeout=P22_RANK_TIMEOUT),
          "22: the rank did not join a group")
    rank = multihost.process_id()
    ds = sync_corpus()
    arrays = {}
    info = {"launches": {}, "seconds": {}, "step_ms": {}}

    def keep(tag, trainer, res, counts, secs, routes):
        arrays.update({f"{tag}/{k}": v for k, v in state_host(res).items()})
        arrays[f"{tag}/loss"] = np.array(
            [h["loss"] for h in trainer.get_history()])
        if routes:
            arrays[f"{tag}/routes"] = np.stack([r[0] for r in routes], -1)
            arrays[f"{tag}/logits"] = np.stack([r[1] for r in routes])
            info["capacity"] = routes[0][2]
        info["launches"][tag], info["seconds"][tag] = counts, secs
        info["step_ms"][tag] = step_ms(trainer)

    run = p22_run(torch, zoo, Sync, ds, True, expert_parallel=SYNC_RANKS,
                  device_resident=True)
    check(run[0].mesh.shape == {"data": 1, "expert": SYNC_RANKS},
          f"22a: mesh {run[0].mesh.shape}")
    keep("ep", *run)
    grid = run[0].mesh
    del run
    moe = make_moe(zoo)

    def expert_bytes():
        return sum(l.wi.numel() * 4 + l.wo.numel() * 4 for l in moe.layers
                   if isinstance(l, ep.MoE))

    whole = expert_bytes()
    ep.attach_expert_mesh(moe, grid)
    info["expert_bytes"] = {"whole": whole, "held": expert_bytes()}
    del moe, grid
    torch.cuda.empty_cache()
    run = p22_run(torch, zoo, Sync, ds, True, batch_size=8 // SYNC_RANKS,
                  device_resident=True)
    check(run[0].mesh.shape == {"data": SYNC_RANKS},
          f"22b: mesh {run[0].mesh.shape}")
    keep("dp", *run)
    del run
    torch.cuda.empty_cache()
    run = p22_run(torch, zoo, PipelineParallelTrainer, ds, False,
                  num_micro=PIPE_MICRO)
    check(run[0].mesh.shape == {"pipe": SYNC_RANKS},
          f"22c: mesh {run[0].mesh.shape}")
    keep("pipe", *run)
    del run
    torch.cuda.empty_cache()
    pipe = make_grid(1, SYNC_RANKS, "pipe", data_axis=False).inner
    info["backend"] = pipe.backend
    rows = pipe_exchanges(torch, np, pipe)
    info["exchanges"] = {
        "rows": rows,
        "bytes_per_step": sum(r["bytes_sent"] * r["calls"] for r in rows),
        "ms_per_step": sum(r["ms"] * r["calls"] for r in rows)}
    pipe.release()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multihost.shutdown()
    return 0


def run_phase22(torch, np, zoo, smi):
    """Phase 22, the expert mesh and pipeline parallelism: two gloo rank
    processes on the card (NCCL refuses two ranks on one device) against
    the port's one-rank ``SingleTrainer`` on the same batches. Returns the
    results and the launch counts of each drive."""
    from distkeras_tpu_torch import SingleTrainer

    t0 = time.monotonic()
    ds = sync_corpus()
    refs = {}
    for tag, moe in (("moe", True), ("lm", False)):
        t, res, counts, _, routes = p22_run(torch, zoo, SingleTrainer, ds,
                                            moe, device_resident=True)
        refs[tag] = {"loss": np.array([h["loss"] for h in t.get_history()]),
                     "params": state_host(res), "step_ms": step_ms(t),
                     "routes": (np.stack([r[0] for r in routes], -1)
                                if routes else None),
                     "logits": (np.stack([r[1] for r in routes])
                                if routes else None)}
        del t, res
    torch.cuda.empty_cache()
    ranks, infos, wall = run_rank_pair(np, "--p22-rank-out", "22",
                                       P22_RANK_TIMEOUT)
    check(ranks[0].keys() == ranks[1].keys(), "22: the ranks' keys differ")
    unequal = [k for k in ranks[0] if not k.startswith("dp/")
               and not np.array_equal(ranks[0][k], ranks[1][k])]
    unequal += [k for k in ranks[0] if k.startswith("dp/")
                and not k.endswith(("/routes", "/logits"))
                and not np.array_equal(ranks[0][k], ranks[1][k])]
    check(not unequal, f"22: the ranks differ in {unequal[:5]}")
    rank0 = ranks[0]
    out = {"backend": infos[0]["backend"], "wall_s": wall,
           "rank_infos": infos,
           "reference_step_ms": {k: v["step_ms"] for k, v in refs.items()}}
    failures = []
    expected = {
        "ep": {k: SYNC_STEPS * n for k, n in LM_STEP_LAUNCHES.items()},
        "dp": {k: SYNC_STEPS * n for k, n in LM_STEP_LAUNCHES.items()},
        "pipe": {k: SYNC_STEPS * n for k, n in PIPE_STEP_LAUNCHES.items()},
    }
    for tag, name, ref_tag in (("ep", "22a", "moe"), ("dp", "22b", "moe"),
                               ("pipe", "22c", "lm")):
        ref = refs[ref_tag]
        got = rank0[f"{tag}/loss"]
        rel = np.abs(got - ref["loss"]) / np.abs(ref["loss"])
        trained = [k for k in ref["params"] if not k.endswith("aux_loss")]
        far = max(float(np.max(np.abs(rank0[f"{tag}/{k}"] - ref["params"][k])))
                  for k in trained)
        aux_far = max([float(np.max(np.abs(rank0[f"{tag}/{k}"] - v)))
                       for k, v in ref["params"].items()
                       if k.endswith("aux_loss")], default=0.0)
        out[tag] = {"losses": got.tolist(),
                    "reference_losses": ref["loss"].tolist(),
                    "max_rel_loss": float(np.max(rel)),
                    "first_rel_loss": float(rel[0]),
                    "max_param_distance": far,
                    "max_aux_loss_distance": aux_far,
                    "step_ms": [i["step_ms"][tag] for i in infos],
                    "launches": infos[0]["launches"][tag]}
        rtol, ptol = ((P22B_RTOL, P22B_PARAM_TOL) if tag == "dp"
                      else (P22_RTOL, P22_PARAM_TOL))
        if tag == "dp" and rel[0] > P22B_FIRST_RTOL:
            failures.append(f"{name}: the first step's loss differs from "
                            f"one rank's by {rel[0]:.3e}")
        if np.max(rel) > rtol:
            failures.append(f"{name}: losses differ from one rank's by "
                            f"{np.max(rel):.3e}")
        if far > ptol or (tag != "dp" and aux_far > ptol):
            failures.append(f"{name}: parameters differ from one rank's by "
                            f"{far:.3e} (aux_loss buffers {aux_far:.3e})")
        for info in infos:
            launched = {k: n for k, n in info["launches"][tag].items() if n}
            if launched != expected[tag]:
                failures.append(f"{name}: a rank's launches {launched} != "
                                f"{expected[tag]}")
        if ref["routes"] is not None:
            failures += check_routes(np, out, tag, name, ranks, ref,
                                     infos[0]["capacity"])
    eb = [i["expert_bytes"] for i in infos]
    out["expert_bytes"] = eb
    if any(e["held"] * SYNC_RANKS != e["whole"] for e in eb):
        failures.append(f"22a: a rank holds {eb} expert bytes")
    ex = infos[0]["exchanges"]
    out["pipe"]["exchanges"] = [i["exchanges"] for i in infos]
    pipe_step = max(out["pipe"]["step_ms"])
    out["pipe"]["exchange_share"] = ex["ms_per_step"] / pipe_step
    for tag, name, what in (("ep", "22a", "EP, data 1 x expert 2"),
                            ("dp", "22b", "pure DP 2, global routing")):
        o = out[tag]
        log(f"{name} ({what}, MoE LM, 4 steps of 8 x 512): losses within "
            f"{o['max_rel_loss']:.2e} of SingleTrainer (first step "
            f"{o['first_rel_loss']:.2e}), trained parameters within "
            f"{o['max_param_distance']:.2e} (aux_loss buffers "
            f"{o['max_aux_loss_distance']:.2e}); first step's routing: the "
            f"global rule exact on the ranks' logits: "
            f"{o['routing_rule_exact']}, {o['routes_differing']} of "
            f"{o['tokens_routed']} (token, layer) places differ from one "
            f"rank's, {o['routing_ties']} top-1 flips at rounding ties (logits "
            f"{o['max_logit_drift']:.2e} apart), {o['dropped']} dropped at "
            f"capacity {o['capacity']}; step {o['step_ms']} ms "
            f"(SingleTrainer {refs['moe']['step_ms']:.1f}); launches a rank "
            f"{o['launches']} on {smi}")
    log(f"22a: a rank holds {eb[0]['held']} of {eb[0]['whole']} expert "
        f"bytes")
    log(f"22c (pipeline S 2, {PIPE_MICRO} microbatches, d512/L8, 4 blocks a "
        f"rank): losses within {out['pipe']['max_rel_loss']:.2e} of "
        f"SingleTrainer, parameters within "
        f"{out['pipe']['max_param_distance']:.2e}; step "
        f"{out['pipe']['step_ms']} ms (SingleTrainer "
        f"{refs['lm']['step_ms']:.1f}); exchanges a step "
        f"{ex['bytes_per_step']} bytes sent a rank, {ex['ms_per_step']:.1f} "
        f"ms timed alone ({[(r['kind'], r['bytes_sent'], r['calls'], round(r['ms'], 3)) for r in ex['rows']]}"
        f" kind, bytes, calls, ms), {out['pipe']['exchange_share']:.1%} of "
        f"the step; launches a rank {out['pipe']['launches']} on {smi}")
    check(not failures, "; ".join(failures))
    out["seconds_total"] = time.monotonic() - t0
    counts = [i["launches"][tag] for i in infos
              for tag in ("ep", "dp", "pipe")]
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in counts[0]}
    return out, counts


# ------------------------------------------------------------------ phase 23

#: the meshes phase 23 serves on, every shard on the one card
P23_WAYS = (2, 4)
#: a greedy reply may leave solo's only where solo's top two logits are
#: this close (relative): the mesh's partial sums round differently
P23_TIE_RTOL = 1e-5
P23_STEPS = 20  # decode steps a wall averages over (a profile: half)


def p23_mesh(torch, n):
    from distkeras_tpu_torch.parallel.mesh import serving_mesh

    return serving_mesh(f"tp:{n}", devices=[torch.device("cuda", 0)] * n)


def p23_compare(torch, np, lm, got, want, reqs, tag):
    """``got`` against solo's replies ``want``: equal, or (greedy only)
    leaving solo at one position where solo's top two cached-path logits
    are within ``P23_TIE_RTOL`` relative and ``got`` took the second. An n
    > 1 reply is a list of completions. Returns the number of such ties."""
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    gen, ties = None, 0
    for g, w, (p, n, s) in zip(got, want, reqs):
        gs, ws = (g, w) if isinstance(w, list) else ([g], [w])
        check(len(gs) == len(ws), f"{tag}: {len(gs)} completions, solo "
              f"{len(ws)}")
        for a, b in zip(gs, ws):
            check(isinstance(a, np.ndarray) and len(a) == len(b),
                  f"{tag}: a reply did not finish: {a!r:.200}")
            if np.array_equal(a, b):
                continue
            check(s is None, f"{tag}: a sampled reply differs from solo's")
            j = int(np.flatnonzero(a != b)[0])
            gen = gen or CachedSequenceGenerator(lm)
            lg = cached_forced_logits(torch, np, gen, b[: j + 1], j,
                                      False)[-1]
            top = np.argsort(lg)[::-1][:2]
            gap = float(lg[top[0]] - lg[top[1]])
            check(int(b[j]) == int(top[0]) and int(a[j]) == int(top[1])
                  and gap <= P23_TIE_RTOL * abs(float(lg[top[0]])),
                  f"{tag}: a greedy reply leaves solo's at position {j} "
                  f"(token {a[j]} for {b[j]}), not at a tie (top two "
                  f"{top.tolist()}, gap {gap:.3e})")
            ties += 1
    return ties


def p23_serve(torch, np, lm, reqs, tag, mesh=None, **kw):
    """The mix on a ``ServingEngine`` (8 slots, ``mesh``): replies, under
    a mesh the sampled ones replayed, health, stats and gauges, with B7
    counted against the programs run (``counted``). Returns (that,
    counts)."""
    from distkeras_tpu_torch.serving import ServingEngine

    eng = ServingEngine(lm, num_slots=8, mesh=mesh, prefix_cache=False,
                        watchdog_interval=60.0, **kw).start()
    try:
        def drive():
            outs, secs = serve_mix(eng, reqs)
            replay = [eng.generate(p, n, sampling=s, timeout=600)
                      for p, n, s in reqs if s is not None and mesh]
            return outs, replay, secs

        (outs, replay, secs), counts = counted(torch, lm, tag, drive)
        gauges = {g["name"]: g["value"] for g in eng.metrics_snapshot()
                  if g["kind"] == "gauge"}
        res = {"outs": outs, "seconds": secs, "health": eng.health(),
               "stats": eng.stats(), "gauges": gauges,
               "kv_bytes_total": eng._stepper.kv_bytes_total()}
    finally:
        eng.stop()
    sampled = [o for o, (_, _, s) in zip(outs, reqs) if s is not None]
    check(all(np.array_equal(a, b) for a, b in zip(sampled, replay)),
          f"{tag}: a sampled request did not replay identically")
    return res, counts


def p23_geometry(res, n, tag):
    """The geometry surfaces of a tp:n engine's ``p23_serve`` result."""
    h, st, g = res["health"], res["stats"], res["gauges"]
    spec = f"tp:{n}"
    check(h["mesh"] == spec and st["mesh"] == spec,
          f"{tag}: health/stats report {h['mesh']}/{st['mesh']}")
    check(h["kv_shard_bytes"] * n == res["kv_bytes_total"],
          f"{tag}: {h['kv_shard_bytes']} K/V bytes a shard of "
          f"{res['kv_bytes_total']}")
    check(g["serving_mesh_devices"] == n
          and g["serving_kv_shard_bytes"] == h["kv_shard_bytes"],
          f"{tag}: the gauges read {g['serving_mesh_devices']}, "
          f"{g['serving_kv_shard_bytes']}")
    if st["paged"]["enabled"]:
        check(st["paged"]["mesh"] == spec, f"{tag}: paged_stats mesh "
              f"{st['paged']['mesh']}")


def p23_step_times(torch, np, lm, smi, profile=False):
    """Per-step wall of a dense decode step with 8 busy slots (64-token
    prompts) at tp:1, tp:2 and tp:4 on the one card, the median of three
    turns, and B7's launches in one step; ``profile`` adds each step's
    device time and kernels (``torch.profiler``; timing only, so under
    ``--profile``)."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.serving.engine import DecodeStepper

    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 8192, 64) for _ in range(8)]
    active = np.ones(8, bool)
    steppers = {}
    for n in (1, *P23_WAYS):
        st = DecodeStepper(lm, num_slots=8,
                           mesh=None if n == 1 else p23_mesh(torch, n))
        for i, p in enumerate(prompts):
            st.admit(i, p)
        st.step(active)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        st.step(active)
        torch.cuda.synchronize()
        steppers[n] = (st, kernels.launch_counts()["layernorm_fwd"])

    def wall_ms(st):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(P23_STEPS):
            st.step(active)
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / P23_STEPS * 1e3

    walls = {n: [] for n in steppers}
    order = list(steppers)
    for r in range(3):
        for n in order[r:] + order[:r]:
            walls[n].append(wall_ms(steppers[n][0]))
    out = {}
    for n, (st, ln) in steppers.items():
        row = out[f"tp:{n}"] = {
            "wall_ms": float(np.median(walls[n])), "wall_ms_turns": walls[n],
            "b7_per_step": ln, "kv_bytes_total": st.kv_bytes_total(),
            "kv_shard_bytes": st.kv_shard_bytes()}
        dev = None
        if profile:
            dev = device_profile(torch, lambda st=st: st.step(active),
                                 P23_STEPS // 2)
            row.update(device_ms=dev["device_ms"], kernels=dev["kernels"],
                       device_ms_by_category=dev["device_ms_by_category"],
                       top_kernels=dev["top_kernels"][:5])
        log(f"23 step tp:{n} (dense, 8 busy slots, d512/L8): wall "
            f"{row['wall_ms']:.3f} ms (turns "
            f"{[round(w, 3) for w in walls[n]]}), "
            + (f"device {dev['device_ms']} ms "
               f"({dev['device_ms_by_category']}), {dev['kernels']} kernels "
               "a step, " if dev else "")
            + f"B7 {ln} a step, K/V {st.kv_shard_bytes()} bytes a shard of "
            f"{st.kv_bytes_total()} on {smi}")
        for k in (dev["top_kernels"][:3] if dev else ()):
            log(f"  {k}")
    for n in steppers:
        check(out[f"tp:{n}"]["b7_per_step"] == 17,
              f"23: B7 launched {out[f'tp:{n}']['b7_per_step']} times in "
              f"a tp:{n} decode step (17 solo)")
        check(out[f"tp:{n}"]["kv_bytes_total"] == out["tp:1"][
            "kv_bytes_total"], "23: the K/V total changes with the mesh")
    del steppers
    return out


def run_phase23(torch, np, zoo, smi, profile=False):
    """Phase 23, the serving mesh: ``ServingEngine(mesh="tp:N")`` with its
    N shards on the one card (``devices=[cuda:0] * N``, the port's
    counterpart of JAX's virtual devices), held against the solo engine;
    ``profile``: the per-step device times too. Returns the results and
    the launch counts of each drive."""
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import ModelDrafter, ServingEngine
    from distkeras_tpu_torch.serving.sampling import SamplingParams

    t0 = time.monotonic()
    out, launches = {}, []
    lm = make_lm(zoo)
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    reqs = phase4_mix(np)
    # 23a: tp:2 on phase 4's mix, dense and paged
    t_a = time.monotonic()
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        solo, c0 = p23_serve(torch, np, lm, reqs, f"23a solo {kind}",
                             paged=paged)
        tp2, c2 = p23_serve(torch, np, lm, reqs, f"23a tp:2 {kind}",
                            mesh=p23_mesh(torch, 2), paged=paged)
        launches += [c0, c2]
        ties = p23_compare(torch, np, lm, tp2["outs"], solo["outs"], reqs,
                           f"23a tp:2 {kind}")
        p23_geometry(tp2, 2, f"23a tp:2 {kind}")
        check(solo["health"]["mesh"] is None, "23a: solo reports a mesh")
        n_tok = sum(len(o) - len(p) for o, (p, _, _) in zip(solo["outs"],
                                                            reqs))
        out[f"23a_{kind}"] = {
            "ties": ties, "tokens": n_tok,
            "solo_tokens_per_s": n_tok / solo["seconds"],
            "tp2_tokens_per_s": n_tok / tp2["seconds"],
            "kv_shard_bytes": tp2["health"]["kv_shard_bytes"],
            "kv_bytes_total": tp2["kv_bytes_total"],
            "b7": {"solo": c0["layernorm_fwd"], "tp:2": c2["layernorm_fwd"]}}
        log(f"23a ({kind}, phase 4's 16 requests): tp:2 replies equal solo's "
            f"({ties} greedy ties), sampled replays identical, B7 as the "
            f"programs imply ({out[f'23a_{kind}']['b7']}), mesh tp:2 on "
            f"health/stats/gauges, K/V {tp2['health']['kv_shard_bytes']} "
            f"bytes a shard of {tp2['kv_bytes_total']}; tokens/s solo "
            f"{out[f'23a_{kind}']['solo_tokens_per_s']:.1f}, tp:2 "
            f"{out[f'23a_{kind}']['tp2_tokens_per_s']:.1f} on {smi}")
    t_s = time.monotonic()
    out["steps"] = p23_step_times(torch, np, lm, smi, profile)
    t_c = time.monotonic()
    # 23c: speculative verify at tp:2 with a small model drafter; the
    # draft bank stays solo
    draft = small_draft(zoo)
    spec_reqs = [r for r in reqs if r[2] is None][:6]
    spec = {}
    for tag, mesh in (("solo", None), ("tp:2", p23_mesh(torch, 2))):
        eng = ServingEngine(lm, num_slots=8, mesh=mesh, prefix_cache=False,
                            speculative=ModelDrafter(draft), draft_k=4,
                            watchdog_interval=60.0).start()
        try:
            (outs, _), counts = counted_all(
                torch, f"23c {tag}", lambda eng=eng: serve_mix(eng, spec_reqs))
            spec[tag] = (outs, eng._stepper.spec_verify_steps)
        finally:
            eng.stop()
        launches.append(counts)
        check(spec[tag][1] > 0, f"23c: the {tag} engine ran no verify")
    ties = p23_compare(torch, np, lm, spec["tp:2"][0], spec["solo"][0],
                       spec_reqs, "23c")
    out["23c"] = {"verify_steps": {k: v[1] for k, v in spec.items()},
                  "ties": ties}
    log(f"23c (ModelDrafter d256/L2, draft_k 4, 6 greedy requests): tp:2 "
        f"replies equal solo's ({ties} ties), verify steps "
        f"{out['23c']['verify_steps']} on {smi}")
    # 23d: a DKTX frame from a solo prefill engine into a tp:2 decode one
    t_d = time.monotonic()
    p, n, _ = reqs[0]
    pre = ServingEngine(lm, num_slots=2, role="prefill", prefix_cache=False,
                        watchdog_interval=60.0).start()
    dec = ServingEngine(lm, num_slots=2, role="decode", prefix_cache=False,
                        mesh=p23_mesh(torch, 2),
                        watchdog_interval=60.0).start()
    uni = ServingEngine(lm, num_slots=2, prefix_cache=False,
                        watchdog_interval=60.0).start()
    try:
        def handoff():
            frame = pre.prefill(p, n)[0]
            return (dec.wait(dec.resume(frame, n), timeout=600),
                    uni.generate(p, n, timeout=600), len(frame))

        (got, want, nbytes), counts = counted_all(torch, "23d", handoff)
    finally:
        for e in (pre, dec, uni):
            e.stop()
    launches.append(counts)
    ties = p23_compare(torch, np, lm, [got], [want], [(p, n, None)], "23d")
    out["23d"] = {"frame_bytes": nbytes, "ties": ties}
    log(f"23d: a {nbytes}-byte DKTX frame from a solo prefill engine "
        f"decodes on a tp:2 engine as on a solo unified one ({ties} ties) "
        f"on {smi}")
    del lm, draft
    gc.collect()
    torch.cuda.empty_cache()
    # 23b: tp:4 on the MoE LM, paged, greedy and an n = 2 fork
    t_b = time.monotonic()
    moe = make_moe(zoo)
    check(attach_fused_layernorm(moe) == 17, "LN hook not on the MoE's 17")
    moe_reqs = [r for r in reqs if r[2] is None][:4] + [
        (reqs[3][0], 32, SamplingParams(temperature=0.9, seed=123, n=2))]
    solo, c0 = p23_serve(torch, np, moe, moe_reqs, "23b solo", paged=True)
    tp4, c4 = p23_serve(torch, np, moe, moe_reqs, "23b tp:4",
                        mesh=p23_mesh(torch, 4), paged=True)
    launches += [c0, c4]
    ties = p23_compare(torch, np, moe, tp4["outs"], solo["outs"], moe_reqs,
                       "23b")
    p23_geometry(tp4, 4, "23b")
    out["23b"] = {"ties": ties,
                  "kv_shard_bytes": tp4["health"]["kv_shard_bytes"],
                  "kv_bytes_total": tp4["kv_bytes_total"],
                  "forked_slots": tp4["stats"]["forked_slots"],
                  "b7": {"solo": c0["layernorm_fwd"],
                         "tp:4": c4["layernorm_fwd"]}}
    check(out["23b"]["forked_slots"] >= 1, "23b: the n=2 group never forked")
    log(f"23b (MoE LM d512/L8, 8 experts, 2 a shard, paged, 4 greedy + an "
        f"n=2 fork): tp:4 replies equal solo's ({ties} ties), B7 "
        f"{out['23b']['b7']}, K/V {out['23b']['kv_shard_bytes']} bytes a "
        f"shard of {out['23b']['kv_bytes_total']} on {smi}")
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds_total"] = time.monotonic() - t0
    out["seconds"] = {"setup": t_a - t0, "23a": t_s - t_a,
                      "steps": t_c - t_s, "23c": t_d - t_c, "23d": t_b - t_d,
                      "23b": time.monotonic() - t_b}
    log(f"23: seconds {out['seconds']}")
    out["launches"] = {k: sum(c.get(k, 0) for c in launches)
                       for k in launches[0]}
    return out, launches


# ------------------------------------------------------------------ phase 24

#: 24a: the 3-D grid (pipe x data x model) and tests/test_3d_mesh.py's
#: blocks, specs, batch and microbatches
P24_GRID = (2, 2, 2)
P24_DEPTH, P24_D, P24_HID, P24_BATCH, P24_MICRO = 4, 8, 16, 8, 2
P24_OUT_TOL = 1e-5  # JAX's own test's bars, f32, another summation order
P24_GRAD_TOL = 2e-4
P24_RANK_TIMEOUT = 240  # seconds a phase-24 rank may take, spawn included
P24_TWIN_TIMEOUT = 300  # seconds a twin may take
#: twins run at once, each lane's processes on cores / lanes threads
P24_LANES = 4
P24_LEAVES = ("w_in", "w_out", "b")
#: the kernels the language-model twin runs (B3-B8)
P24_LM_KERNELS = ("adam_fused", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                  "layernorm_fwd", "layernorm_bwd")
#: those its sequence-parallel rank processes run (the ring takes the
#: flash hook's place)
P24_SP_KERNELS = ("adam_fused", "layernorm_fwd", "layernorm_bwd")


def p24_inputs(np):
    """tests/test_3d_mesh.py's blocks (seeds 0 and 2) stacked, and its
    inputs (seeds 1 and 3)."""
    out = {}
    for tag, seed, x_seed in (("fwd", 0, 1), ("grad", 2, 3)):
        rng = np.random.default_rng(seed)
        blocks = [{
            "w_in": (rng.standard_normal((P24_D, P24_HID)) * 0.3).astype(
                np.float32),
            "w_out": (rng.standard_normal((P24_HID, P24_D)) * 0.3).astype(
                np.float32),
            "b": np.zeros(P24_D, np.float32)} for _ in range(P24_DEPTH)]
        for k in P24_LEAVES:
            out[f"{tag}/{k}"] = np.stack([b[k] for b in blocks])
        out[f"{tag}/x"] = np.random.default_rng(x_seed).standard_normal(
            (P24_BATCH, P24_D)).astype(np.float32)
    return out


def p24_apply(torch, np, grid):
    """``pipeline_apply(param_specs=)`` on ``grid`` (a ``Grid3D``): the
    forward output, and the rank's stage gradients of sum(out ** 2)
    summed over its data group, with the stage's shapes."""
    from distkeras_tpu_torch.parallel import pipeline_parallel as pp
    from distkeras_tpu_torch.parallel.tensor_parallel import PartitionSpec

    P = PartitionSpec
    specs = {"w_in": P("pipe", None, "model"),
             "w_out": P("pipe", "model", None), "b": P("pipe")}
    model = grid.model
    inputs = p24_inputs(np)

    def block_tp(p, h):
        part = torch.tanh(model.copy_in(h) @ p["w_in"]) @ p["w_out"]
        return h + model.reduce_out(part) + p["b"]

    def run(tag):
        stacked = {k: torch.from_numpy(inputs[f"{tag}/{k}"]).to(grid.device)
                   for k in P24_LEAVES}
        stage = pp.shard_stacked_params(stacked, grid, param_specs=specs)
        for v in stage.values():
            v.requires_grad_()
        x = torch.from_numpy(inputs[f"{tag}/x"]).to(grid.device)
        out = pp.pipeline_apply(stage, x, block_tp, grid,
                                num_micro=P24_MICRO, batch_axis="data",
                                param_specs=specs)
        return stage, out

    res = {"coords": np.array([grid.pipe.rank, grid.data.rank, model.rank])}
    stage, out = run("fwd")
    res["out"] = out.detach().cpu().numpy()
    for k in P24_LEAVES:
        res["shape/" + k] = np.array(stage[k].shape)
    stage, out = run("grad")
    out.square().sum().backward()
    for k in P24_LEAVES:
        res["grad/" + k] = grid.data.all_reduce_(stage[k].grad).cpu().numpy()
    return res


def p24_rank_main(out_dir):
    """A 24a rank: joins the gloo group of 8 from the ``DKT_*`` env (every
    rank on the one card), runs the 3-D composition on the 2 x 2 x 2
    grid, then 27a's steps, and writes its outputs, gradients, shapes,
    step records and seconds."""
    import numpy as np
    import torch

    from distkeras_tpu_torch.parallel import multihost
    from distkeras_tpu_torch.parallel.mesh import make_grid_3d

    torch.backends.cuda.matmul.allow_tf32 = False
    check(multihost.initialize(timeout=P24_RANK_TIMEOUT),
          "24a: the rank did not join a group")
    rank = multihost.process_id()
    t0 = time.monotonic()
    grid = make_grid_3d(*P24_GRID)
    res = p24_apply(torch, np, grid)
    torch.cuda.synchronize()
    info = {"seconds": time.monotonic() - t0, "backend": grid.world.backend,
            "device": str(grid.device)}
    grid.release()
    # 27a: dryrun_multichip(8)'s steps in the same eight processes
    import graft_entry_torch

    t1 = time.monotonic()
    info["multichip"] = graft_entry_torch.multichip_steps()
    info["multichip_s"] = time.monotonic() - t1
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    multihost.shutdown()
    return 0


def p24_shard(a, leaf, p, m):
    """The shard of a whole stacked leaf at pipe index p, model index m
    (JAX's ``shard_shape`` placement)."""
    per = P24_DEPTH // P24_GRID[0]
    cut = P24_HID // P24_GRID[2]
    a = a[p * per:(p + 1) * per]
    if leaf == "w_in":
        return a[:, :, m * cut:(m + 1) * cut]
    if leaf == "w_out":
        return a[:, m * cut:(m + 1) * cut, :]
    return a


def run_p24a(torch, np, smi):
    """24a: the 3-D composition over 8 gloo rank processes on the card,
    against ``pipeline_apply`` on one rank (a 1 x 1 x 1 grid); returns its
    results and 27a's (the dryrun's steps in the same ranks)."""
    from distkeras_tpu_torch.parallel.mesh import make_grid_3d

    ref = p24_apply(torch, np, make_grid_3d(1, 1, 1))
    n = int(np.prod(P24_GRID))
    ranks, infos, wall = run_rank_pair(np, "--p24-rank-out", "24a",
                                       P24_RANK_TIMEOUT, ranks=n)
    coords = np.stack([r["coords"] for r in ranks])
    check(np.array_equal(coords, np.stack(np.unravel_index(
        np.arange(n), P24_GRID), -1)), f"24a: rank layout {coords.tolist()}")
    out_err = max(float(np.max(np.abs(r["out"] - ref["out"])))
                  for r in ranks)
    grad_err = max(
        float(np.max(np.abs(r["grad/" + k] - p24_shard(
            ref["grad/" + k], k, r["coords"][0], r["coords"][2]))))
        for r in ranks for k in P24_LEAVES)
    want = {"w_in": [P24_DEPTH // 2, P24_D, P24_HID // 2],
            "w_out": [P24_DEPTH // 2, P24_HID // 2, P24_D],
            "b": [P24_DEPTH // 2, P24_D]}
    out = {"grid": list(P24_GRID), "ranks": n, "wall_s": wall,
           "rank_seconds": [i["seconds"] for i in infos],
           "backend": infos[0]["backend"], "device": infos[0]["device"],
           "max_out_err": out_err, "max_grad_err": grad_err,
           "shard_shapes": want}
    log(f"24a (pipeline x data x tensor, {P24_GRID[0]} x {P24_GRID[1]} x "
        f"{P24_GRID[2]} = {n} {infos[0]['backend']} ranks on "
        f"{infos[0]['device']}): outputs within {out_err:.2e} and data-"
        f"summed gradients within {grad_err:.2e} of one rank's; wall "
        f"{wall:.1f} s (the ranks' own work at most "
        f"{max(out['rank_seconds']):.2f} s) on {smi}")
    check(out_err <= P24_OUT_TOL, f"24a: outputs {out_err:.3e} from one "
          f"rank's (bar {P24_OUT_TOL})")
    check(grad_err <= P24_GRAD_TOL, f"24a: gradients {grad_err:.3e} from "
          f"one rank's (bar {P24_GRAD_TOL})")
    for r in ranks:
        got = {k: r["shape/" + k].tolist() for k in P24_LEAVES}
        check(got == want, f"24a: a rank holds {got}, not {want}")
    return out, run_p27a(infos, wall, smi)


def run_p27a(infos, wall, smi):
    """27a: ``dryrun_multichip(8)``'s steps, run by 24a's rank processes:
    every rank ran every step within ``ONE_RANK_TOL`` of one rank, and the
    replicated results agree (``check_multichip``)."""
    import graft_entry_torch as ge

    try:
        steps = ge.check_multichip([i["multichip"] for i in infos])
    except RuntimeError as e:
        raise SmokeFailure(f"27a: {e}") from e
    rows = {step: {"max_err": max(max(r["err"].values()) for r in recs),
                   "max_rank_s": max(r["seconds"] for r in recs),
                   "replicated": recs[0]["replicated"]}
            for step, recs in steps.items()}
    secs = [i["multichip_s"] for i in infos]
    for step, row in rows.items():
        log(f"27a {step}: within {row['max_err']:.2e} of one rank (bar "
            f"{ge.ONE_RANK_TOL}) on every rank, replicated {row['replicated']}"
            f", {row['max_rank_s']:.3f} s a rank at most")
    log(f"27a (dryrun_multichip(8) in 24a's {len(infos)} "
        f"{infos[0]['backend']} ranks on {infos[0]['device']}): "
        f"{len(rows)} steps in {max(secs):.2f} s a rank at most, inside 24a's "
        f"launch wall {wall:.1f} s, on {smi}")
    return {"ranks": len(infos), "steps": rows, "rank_seconds": secs,
            "launch_wall_s": wall}


def p27_rank_times(res):
    """A dryrun rank's start-up, split, as one log string."""
    return ", ".join(
        f"rank {r}: spawn {t['spawn_s']:.1f} s, import torch "
        f"{t['import_torch_s']:.1f} s, the port {t['import_port_s']:.1f} s, "
        f"join {t['join_s']:.1f} s ({t['backend']}), steps "
        f"{t['steps_s']:.1f} s" for r, t in enumerate(res["ranks"]))


def run_p27b(smi):
    """27b: ``dryrun_multichip(1)`` (the one-card topology, one NCCL
    rank) and ``dryrun_multiprocess(2)``, one after the other (a
    lane beside 24b's twins)."""
    import graft_entry_torch as ge

    out = {}
    t0 = time.monotonic()
    res = ge.dryrun_multichip(1)
    wall = time.monotonic() - t0
    check(list(res["steps"]) == ge.multichip_step_names(1),
          f"27b: steps {list(res['steps'])}")
    (times,) = res["ranks"]
    check(times["backend"] == "nccl" and times["device"] == "cuda:0",
          f"27b: the one rank ran on {times['backend']} {times['device']}")
    errs = {step: max(rec["err"].values())
            for step, (rec,) in res["steps"].items()}
    out["multichip1"] = {"wall_s": wall, "ranks": res["ranks"],
                         "max_err": errs}
    log(f"27b dryrun_multichip(1): {len(errs)} steps, max error "
        f"{max(errs.values()):.2e} of one rank's, wall {wall:.1f} s ("
        f"{p27_rank_times(res)}) on {smi}")
    t0 = time.monotonic()
    res = ge.dryrun_multiprocess(2)
    wall = time.monotonic() - t0
    out["multiproc"] = dict(res, wall_s=wall)
    log(f"27b dryrun_multiprocess(2): digests {res['digests']} equal, "
        f"commits {res['commits']}, wall {wall:.1f} s (rank seconds "
        f"{res['times']}) on {smi}")
    return out


def run_p27c(torch, smi):
    """27c: ``entry()``'s forward on the card."""
    import graft_entry_torch as ge

    t0 = time.monotonic()
    fn, (model, x) = ge.entry()
    out = fn(model, x)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(out.device.type == "cuda" and tuple(out.shape) == (8, 10),
          f"27c: entry output {tuple(out.shape)} on {out.device}")
    # the zero batch through zero biases: every class at 1/10
    err = float((out - 0.1).abs().max())
    check(err <= 1e-6, f"27c: the zero batch's output {err:.2e} from 0.1")
    log(f"27c entry(): output {tuple(out.shape)} on {out.device}, "
        f"{wall:.2f} s (model built, one forward) on {smi}")
    return {"shape": list(out.shape), "wall_s": wall, "max_err_uniform": err}


def p24_value(out, marker):
    check(marker in out, f"no {marker!r} line")
    return float(out.rsplit(marker, 1)[1].split()[0])


def p24_counting(out):
    rows = [json.loads(line.split(":", 1)[1]) for line in out.splitlines()
            if line.startswith("greedy decode:")]
    check(len(rows) == 3, f"{len(rows)} decode rows")
    for toks in rows:
        check(toks[-5:] == list(range(toks[-5], toks[-5] + 5)),
              f"the decode does not count upward: {toks}")
    return rows


def p24_ranked(out, what="sync"):
    check(f"{what}: 2 rank processes over gloo on the card" in out,
          "no rank-launch line")


def p24_digits(out):
    acc = p24_value(out, "REAL holdout accuracy")
    check(acc > 0.9, f"REAL holdout accuracy {acc} <= 0.9")
    return acc


def p24_lm(out):
    check("serving int8 weight-only (13 quantized matrices)" in out
          and "decoding from the RELOADED copy" in out, "no bundle lines")
    rows = p24_counting(out)
    line = next(l for l in out.splitlines()
                if l.startswith("speculative decode"))
    check("(EXACT vs greedy)" in line, line)
    return {"decode": rows, "speculative": line}


def p24_lm_ranks(out):
    p24_ranked(out, "seq-parallel")
    return {"decode": p24_counting(out)}


#: the lines where a twin prints its own training seconds: the trainers'
#: ``trained ... in X s``, ``<mode>: X s,``, the sequence-parallel
#: ``...: X s (`` and the comparison's ``<scheme>: round 1  t=X s``
P24_TRAIN_LINE = re.compile(
    r"^(?:trained(?: .*)? in |(?:single|sync|downpour): |sequence-parallel "
    r"training at .*: |  \w+: round \d+  t=)([0-9.]+) ?s", re.M)


def p24_long_context(out):
    line = next(l for l in out.splitlines() if l.startswith("long-context"))
    check("ring attention on 2 blocks" in line, line)
    return p24_value(line, "test accuracy:")


def p24_twins(tmp):
    """(name, twin, arguments, read, processes) of every twin 24b runs on
    CUDA at a small size; ``read(stdout)`` checks the result lines and
    returns the result; ``processes`` counts the twin's and its rank
    processes."""

    def comparison(out):
        p24_ranked(out, "  SyncDP")
        with open(os.path.join(tmp, "exp", "optimizer_comparison.json")) as f:
            res = json.load(f)["results"]
        check(len(res) == 7, f"{len(res)} schemes")
        return {r["optimizer"]: r["final_accuracy"] for r in res}

    def digits_sync(out):
        p24_ranked(out)
        return p24_digits(out)

    def mnist_sync(out):
        p24_ranked(out)
        return p24_value(out, "test accuracy:")

    # the longest first, so that the lanes finish together
    return [
        ("optimizer_comparison --workers 2", "optimizer_comparison",
         ["--n", "2048", "--rounds", "1", "--workers", "2", "--out",
          os.path.join(tmp, "exp")], comparison, 3),
        ("mnist sync --workers 2 --zero", "mnist",
         ["sync", "--workers", "2", "--zero", "--n", "2048", "--epochs",
          "1"], mnist_sync, 3),
        ("real_digits sync --workers 2", "real_digits",
         ["sync", "--workers", "2", "--epochs", "4"], digits_sync, 3),
        ("language_model --seq-parallel 2 --remat", "language_model",
         ["--seq", "32", "--rows", "256", "--epochs", "2", "--seq-parallel",
          "2", "--remat"], p24_lm_ranks, 3),
        ("real_digits single --int8", "real_digits", ["--int8"],
         lambda out: [p24_digits(out), p24_value(
             out, "int8 serving copy: REAL holdout accuracy")], 1),
        ("diabetes_regression single", "diabetes_regression", [],
         lambda out: p24_value(out, "REAL holdout R^2"), 1),
        ("cifar10", "cifar10",
         ["--n", "1024", "--epochs", "1", "--workers", "2"],
         lambda out: p24_value(out, "test accuracy:"), 1),
        ("higgs_workflow", "higgs_workflow",
         ["--n", "4096", "--epochs", "1", "--workers", "2"],
         lambda out: p24_value(out, "test accuracy:"), 1),
        ("language_model --int8 --save-bundle --speculative",
         "language_model", ["--epochs", "2", "--int8", "--save-bundle",
                            os.path.join(tmp, "lm.dkt"), "--speculative"],
         p24_lm, 1),
        ("long_context", "long_context",
         ["--seq", "512", "--rows", "128", "--epochs", "1"],
         p24_long_context, 1),
    ]


#: what a twin's process runs: ``import torch`` and a first CUDA tensor,
#: timed, then the twin through runpy, timed, and no JAX loaded after
P24_WRAPPER = """import time
t0 = time.perf_counter()
import json, runpy, sys
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
sys.path.insert(0, {here!r})
sys.argv = [{script!r}, *{args!r}]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    print("P24_TIMES", json.dumps(dict(torch_import_s=t1 - t0,
          cuda_init_s=t2 - t1, script_s=time.perf_counter() - t2)),
          flush=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "distkeras_tpu")]
assert not bad, bad
"""


def run_p24b(smi, beside=None):
    """24b: each example twin as a subprocess on CUDA (no ``--cpu``),
    ``P24_LANES`` at a time, its result lines asserted; returns the rows
    and the kernel launches each twin made, its rank processes' included
    (every process writes its counts through ``DKT_LAUNCH_COUNTS_DIR``).
    A row splits the twin's wall: ``startup_s`` (the interpreter, ``import
    torch``, the first CUDA context and the exit), ``script_s`` (the twin
    itself) and ``train_s`` (the training seconds the twin prints).
    ``beside``: a function run in a lane of its own while the twins run;
    its result is returned third."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from distkeras_tpu_torch.kernels import ENV_COUNTS_DIR

    tmp = tempfile.mkdtemp(prefix="twins_", dir=HERE)
    # the lanes share the host's cores
    env = dict(os.environ, OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // P24_LANES)))

    def run(i, twin, args):
        script = os.path.join(HERE, "examples", f"{twin}_torch.py")
        code = P24_WRAPPER.format(here=HERE, script=script, args=args)
        counts_dir = os.path.join(tmp, f"counts{i}")
        os.mkdir(counts_dir)
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=tmp,
            env=dict(env, **{ENV_COUNTS_DIR: counts_dir}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            out, err = proc.communicate(timeout=P24_TWIN_TIMEOUT)
        except subprocess.TimeoutExpired:
            # the twin's group: its rank processes go with it
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        wall = time.monotonic() - t0
        counts = []
        for name in os.listdir(counts_dir):
            with open(os.path.join(counts_dir, name)) as f:
                counts.append(json.load(f))
        return proc.returncode, out, err, wall, counts

    rows, counts = [], []
    lane = ThreadPoolExecutor(1)
    side = lane.submit(beside) if beside is not None else None
    try:
        twins = p24_twins(tmp)
        with ThreadPoolExecutor(P24_LANES) as ex:
            done = list(ex.map(lambda it: run(it[0], it[1][1], it[1][2]),
                               enumerate(twins)))
        for (name, _, _, read, n_procs), (rc, out, err, wall, procs) in zip(
                twins, done):
            check(rc == 0, f"24b {name} exited {rc}:\n{out[-2000:]}\n"
                  f"{err[-3000:]}")
            times = json.loads(next(
                l for l in out.splitlines()
                if l.startswith("P24_TIMES")).split(" ", 1)[1])
            try:
                result = read(out)
            except (SmokeFailure, StopIteration) as e:
                raise SmokeFailure(
                    f"24b {name}: {e!r}\n{out[-2000:]}") from e
            check(len(procs) == n_procs, f"24b {name}: launch counts from "
                  f"{len(procs)} processes, not {n_procs}")
            launched = {k: sum(c[k] for c in procs) for k in procs[0]}
            trained = [float(v) for v in P24_TRAIN_LINE.findall(out)]
            check(trained, f"24b {name}: no training-seconds line")
            rows.append({"twin": name, "wall_s": wall,
                         "startup_s": wall - times["script_s"], **times,
                         "train_s": sum(trained), "result": result,
                         "processes": len(procs),
                         "launches": {k: n for k, n in launched.items()
                                      if n}})
            counts.append(launched)
            log(f"24b {name}: {wall:.1f} s wall = {rows[-1]['startup_s']:.1f}"
                f" s start-up (import torch {times['torch_import_s']:.1f} s, "
                f"first CUDA context {times['cuda_init_s']:.1f} s) + "
                f"{times['script_s']:.1f} s the twin (training "
                f"{rows[-1]['train_s']:.1f} s as it prints), result "
                f"{result}, launches {rows[-1]['launches']} from "
                f"{len(procs)} processes on {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        lane.shutdown(wait=True)
    lm = next(r for r in rows if r["twin"].startswith("language_model --int8"))
    missing = [k for k in P24_LM_KERNELS if not lm["launches"].get(k)]
    check(not missing, f"24b: the language-model twin never launched "
          f"{missing}: {lm['launches']}")
    sp = next(r for r in rows
              if r["twin"].startswith("language_model --seq-parallel"))
    missing = [k for k in P24_SP_KERNELS if not sp["launches"].get(k)]
    check(not missing, f"24b: the language model's rank processes never "
          f"launched {missing}: {sp['launches']}")
    return rows, counts, None if side is None else side.result()


def run_phase24(torch, np, zoo, smi, twins=True):
    """Phase 24: the 3-D composition (24a) and the example twins (24b),
    and phase 27 on their launches: 27a in 24a's ranks, 27b in a lane
    beside the twins, 27c after. ``twins=False``: 24a, 27b and 27c
    alone. Returns phase 24's results and launch counts (27 launches no
    kernel), and phase 27's results."""
    t0 = time.monotonic()
    out, p27 = {}, {}
    out["24a"], p27["27a"] = run_p24a(torch, np, smi)
    torch.cuda.empty_cache()
    counts = []
    if twins:
        out["24b"], counts, p27["27b"] = run_p24b(smi, lambda: run_p27b(smi))
    else:
        p27["27b"] = run_p27b(smi)
    p27["27c"] = run_p27c(torch, smi)
    out["seconds_total"] = time.monotonic() - t0
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in (counts[0] if counts else ())}
    return out, counts, p27


# ---------------------------------------------------------------- phase 25

#: the operator tools' twins (``tools/*_torch.py``) phase 25 drives
TOOLS = os.path.join(HERE, "tools")
#: 25a's soak at full width: ``transformer_lm(8192, 512, 512, 8, 8)``
P25_SERVE_SECONDS = 10.0
P25_CLIENTS = 4
#: the kernels whose launches each part of phase 25 reports
P25_KERNELS = ("sgd_fused", "flash_fwd", "layernorm_fwd")
P25_TIMEOUT = 300  # seconds a soak subprocess may take

#: a tool process started ahead of its target: it pays ``import torch``
#: and the tool's imports while the phase runs, then waits for ``go`` (a
#: file holding the tool's arguments) and runs the tool's ``main``
P25_TOOL_WAITER = """import os, sys, time
sys.path.insert(0, {tools!r})
sys.path.insert(0, {here!r})
import torch
import {tool} as tool
deadline = time.monotonic() + {timeout}
while not os.path.exists({go!r}):
    if time.monotonic() > deadline:
        sys.exit("{tool}: no target within {timeout} s")
    time.sleep(0.01)
code = tool.main(open({go!r}).read().split())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "distkeras_tpu")]
assert not bad, bad
sys.exit(code)
"""

#: 25c's training soak, through the tool's own phases (``run_soak`` and
#: ``main`` without their one-size switch): the ledger phase at full scale
#: (4 workers x 40 windows) and the training phase at smoke scale, with
#: every parameter server's port written to ``ports`` as it starts (the
#: target of 25e's ``dkt_top_torch.py --ps``). The full-scale training
#: phase's convergence floor needs each worker on a device of its own (the
#: JAX tool forces 8 virtual CPU devices for it); on one card, as on one JAX
#: device, threads-mode workers run in lockstep and miss it (PERF.md, §7)
P25_TRAIN_WRAPPER = """import json, os, sys, time
sys.path.insert(0, {here!r})
sys.path.insert(0, {tools!r})
from distkeras_tpu_torch import parameter_servers as ps
start, stop, started = (ps.SocketParameterServer.start,
                        ps.SocketParameterServer.stop, [])
def recording(self, *a, **k):
    out = start(self, *a, **k)
    started.append(self)
    with open({ports!r}, "a") as f:
        f.write(f"{{self.port}}\\n")
    return out
def holding(self, *a, **k):
    # the ledger phase's standby stays up until 25e has scraped it
    if len(started) > 1 and self is started[1]:
        t = time.monotonic()
        while (not os.path.exists({scraped!r})
               and time.monotonic() - t < 60):
            time.sleep(0.01)
    return stop(self, *a, **k)
ps.SocketParameterServer.start = recording
ps.SocketParameterServer.stop = holding
import soak_training_torch as st
device = st.check_device(False)
ledger = st.run_ledger_phase(workers=4, windows=40, seed=0)
training = st.run_training_phase(seed=0, smoke=True, device=device)
summary = {{"phases": {{"ledger": ledger, "training": training}},
           "ok": bool(ledger["ok"] and training["ok"])}}
json.dump(summary, sys.stdout, indent=2, default=str)
print()
sys.exit(0 if summary["ok"] else 1)
"""


def p25_go(path, args):
    """Hand a waiting tool process its arguments (atomically)."""
    with open(path + ".tmp", "w") as f:
        f.write(" ".join(str(a) for a in args))
    os.replace(path + ".tmp", path)


def p25_spawn(code, cwd, env, out_path):
    """A subprocess in a process group of its own, its stdout and stderr to
    files (a long soak summary must not fill a pipe)."""
    out = open(out_path, "w")
    err = open(out_path + ".err", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=out, stderr=err, text=True,
                            start_new_session=True)
    proc._p25_files = (out, err, out_path)
    return proc


def p25_wait(proc, timeout, what):
    """Wait for ``proc``; past ``timeout`` its whole group goes. Returns
    (returncode, stdout, stderr)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        log(f"{what}: killed after {timeout} s")
    out, err, path = proc._p25_files
    out.close()
    err.close()
    with open(path) as f:
        stdout = f.read()
    with open(path + ".err") as f:
        stderr = f.read()
    return proc.returncode, stdout, stderr


def p25_counts(counts_dir):
    """Summed launch counts of every process that wrote one there."""
    total = {}
    files = os.listdir(counts_dir)
    for name in files:
        with open(os.path.join(counts_dir, name)) as f:
            for k, n in json.load(f).items():
                total[k] = total.get(k, 0) + n
    return total, len(files)


def p25_watchdog(engines):
    """What the engines' supervisors saw: trips (with the scheduler's
    innermost frames for a wedge) and their own late wakes."""
    trips, blind = [], []
    for eng in engines:
        for e in eng.recorder.snapshot():
            if e["kind"] == "engine.watchdog_trip":
                trips.append({k: e.get(k) for k in
                              ("dead", "wedged", "heartbeat_age",
                               "last_crash", "stack")})
            elif e["kind"] == "engine.watchdog_blind":
                blind.append(e["seconds"])
    return {"trips": trips, "blind_s": blind}


def p25_servers():
    """Record every ``ServingServer`` started until the returned ``undo``
    runs (25a's and 25b's engines are made inside the soaks)."""
    from distkeras_tpu_torch.serving import server as server_mod

    seen = []
    start = server_mod.ServingServer.start

    def recording(self, *a, **k):
        out = start(self, *a, **k)
        seen.append(self)
        return out

    server_mod.ServingServer.start = recording

    def undo():
        server_mod.ServingServer.start = start

    return seen, undo


def run_p25a(torch, zoo, tmp, waiters):
    """25a: ``soak_serving_torch.run_soak`` in process at full width
    (paged, self-draft speculative, the storm phase, 4 clients); while it
    runs, 25e's ``dkt_top_torch.py --once`` scrapes its server and, after
    the first watchdog trip, ``dkt_postmortem_torch.py --host`` reads the
    trip's bundle through the ``postmortem`` verb."""
    import threading

    import soak_serving_torch

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = make_lm(zoo)
    attach_fused_layernorm(lm)
    servers, undo = p25_servers()
    tools_done = threading.Event()

    def point_tools():
        """Once the soak's server is up: dkt_top now; dkt_postmortem at
        the first trip (its bundle is then on the server). The server's
        shutdown waits (at most a minute) until both tools have exited:
        a trip late in the soak must still find the server."""
        try:
            while not servers:
                time.sleep(0.01)
            srv = servers[0]
            shutdown = srv.shutdown

            def held(*a, **k):
                tools_done.wait(timeout=60)
                return shutdown(*a, **k)

            srv.shutdown = held
            p25_go(waiters["top"][1], ["127.0.0.1", srv.port, "--once"])
            while srv.engine.stats()["watchdog_trips"] < 1:
                time.sleep(0.02)
            p25_go(waiters["pm"][1],
                   ["--host", "127.0.0.1", "--port", srv.port])
            for name in ("top", "pm"):
                waiters[name][0].wait(timeout=60)
        finally:
            tools_done.set()

    pointer = threading.Thread(target=point_tools, daemon=True)
    pointer.start()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    try:
        summary = soak_serving_torch.run_soak(
            model=lm, clients=P25_CLIENTS, duration=P25_SERVE_SECONDS,
            seed=0)
    finally:
        undo()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    del lm
    torch.cuda.empty_cache()
    return summary, wall, launches, servers[0].engine


def p25_tools(waiters):
    """25e's replies from 25a's server: a scrape of the live server's
    table, and the trip's incident timeline."""
    tools = {}
    for name, marker in (("top", "serving_scheduler_completed"),
                         ("pm", "reason=watchdog_trip")):
        rc, out, err = p25_wait(waiters[name][0], 60, f"25e {name}")
        check(rc == 0 and marker in out,
              f"25e {name} exited {rc}:\n{out[-2000:]}\n{err[-2000:]}")
        tools[name] = {"rc": rc, "lines": len(out.splitlines())}
    return tools


def p25_serving_bars(summary, tag):
    """The serving soak's own acceptance bar, every item named."""
    check(summary["ok"], f"{tag}: the soak's bar failed: "
          + json.dumps({k: summary.get(k) for k in (
              "hung", "typed_errors", "untyped_errors", "untyped_samples",
              "corrupt_outputs",
              "divergent_replays", "grammar_violations", "trace_incomplete",
              "postmortems", "postmortems_naming_seam", "qos", "storm",
              "shed", "compiles")}, default=str)[:4000])


def run_phase25(torch, np, zoo, smi):
    """Phase 25: the chaos soaks and operator tools as a user runs them,
    on the card. 25a ``soak_serving_torch.run_soak`` at full width in
    process; 25b ``run_disagg_soak`` at its default model; 25c the
    training soak's ledger phase at full scale and its training phase at
    smoke scale, in a subprocess; 25d
    ``soak_fleet_torch.py --smoke`` and ``--fabric --smoke`` as
    subprocesses (their replicas load the kernels this process built);
    25e ``dkt_top_torch.py --once`` and ``dkt_postmortem_torch.py --host``
    against 25a's live server and ``dkt_top_torch.py --ps`` against 25c's
    parameter server. 25c and 25d start together after 25a and run beside
    25b. Each part holds its tool's own bar. Returns the results and each
    part's launch counts."""
    import shutil
    import tempfile
    import threading

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.kernels import ENV_COUNTS_DIR

    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import soak_serving_torch

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="soaks_", dir=HERE)
    env = dict(os.environ)
    out, counts = {}, []
    waiters, procs = {}, {}
    try:
        # the three tool processes start now: their `import torch` runs
        # while 25a warms
        for name, tool in (("top", "dkt_top_torch"),
                           ("pm", "dkt_postmortem_torch"),
                           ("ps", "dkt_top_torch")):
            go = os.path.join(tmp, f"go_{name}")
            code = P25_TOOL_WAITER.format(tools=TOOLS, here=HERE, tool=tool,
                                          go=go, timeout=P25_TIMEOUT)
            waiters[name] = (p25_spawn(code, tmp, env,
                                       os.path.join(tmp, f"tool_{name}")), go)

        summary, wall, launches, eng = run_p25a(torch, zoo, tmp, waiters)
        p25_serving_bars(summary, "25a")
        tools = p25_tools(waiters)
        check(launches.get("layernorm_fwd", 0) > 0,
              f"25a: B7 never launched: {launches}")
        out["25a"] = {
            "wall_s": wall, "model": "transformer_lm(8192, 512, 512, 8, 8)",
            "completed": summary["completed"],
            "sampled_completed": summary["sampled_completed"],
            "typed_errors": summary["typed_errors"],
            "fired_by_site": summary["fired_by_site"],
            "engine": summary["engine"], "qos": summary["qos"],
            "storm": {k: summary["storm"][k] for k in
                      ("attempts", "ok", "typed", "accounting_exact")},
            "sheds": summary["shed"]["gate"]["sheds"],
            "speculative": summary["speculative"],
            "postmortems": summary["postmortems"],
            "compiles": {k: summary["compiles"][k] for k in
                         ("total", "serving", "rewarms", "storms")},
            "overlap_efficiency": summary["overlap"].get("efficiency"),
            "watchdog": p25_watchdog([eng]), "tools": tools,
            "launches": {k: launches.get(k, 0) for k in P25_KERNELS},
        }
        counts.append(launches)
        log(f"25a serving soak, transformer_lm d512/L8: {wall:.1f} s, "
            f"completed {summary['completed']} greedy + "
            f"{summary['sampled_completed']} sampled, typed "
            f"{summary['typed_errors']}, fired {summary['fired_by_site']}, "
            f"engine {summary['engine']}, storm "
            f"{out['25a']['storm']}, sheds {out['25a']['sheds']}, watchdog "
            f"{out['25a']['watchdog']}, launches {out['25a']['launches']}; "
            f"25e dkt_top --once and dkt_postmortem --host on its server: "
            f"{tools} on {smi}")

        # 25c and 25d run as processes of their own, all at once and
        # beside 25b (the host has the cores; each keeps its own counts)
        cdir = os.path.join(tmp, "counts_c")
        os.mkdir(cdir)
        ports = os.path.join(tmp, "ps_ports")
        scraped = os.path.join(tmp, "ps_scraped")
        code = P25_TRAIN_WRAPPER.format(here=HERE, tools=TOOLS, ports=ports,
                                        scraped=scraped)
        # wall clocks: a part's wall runs to its summary's last write
        started = {"25c": time.time()}
        procs["25c"] = p25_spawn(code, tmp,
                                 dict(env, **{ENV_COUNTS_DIR: cdir}),
                                 os.path.join(tmp, "soak_training"))

        def point_ps():
            """dkt_top --ps at the ledger phase's standby (it serves the
            metrics action as a standby and after its promotion), which
            stays up until the scrape is over."""
            proc = procs["25c"]
            while proc.poll() is None:
                if os.path.exists(ports):
                    with open(ports) as f:
                        lines = f.read().split()
                    if len(lines) >= 2:
                        p25_go(waiters["ps"][1],
                               ["127.0.0.1", lines[1], "--once", "--ps"])
                        try:
                            waiters["ps"][0].wait(timeout=60)
                        finally:
                            open(scraped, "w").close()
                        return
                time.sleep(0.005)

        pointer = threading.Thread(target=point_ps, daemon=True)
        pointer.start()
        fleet_args = {"fleet": ["--smoke"], "fabric": ["--fabric", "--smoke"]}
        script = os.path.join(TOOLS, "soak_fleet_torch.py")
        for part, args in fleet_args.items():
            ddir = os.path.join(tmp, f"counts_{part}")
            os.mkdir(ddir)
            code = (f"import runpy, sys\nsys.argv = [{script!r}, "
                    f"*{args!r}]\nrunpy.run_path({script!r}, "
                    f"run_name='__main__')\n")
            started[part] = time.time()
            procs[part] = p25_spawn(code, tmp,
                                    dict(env, **{ENV_COUNTS_DIR: ddir}),
                                    os.path.join(tmp, f"soak_{part}"))

        servers, undo = p25_servers()
        kernels.reset_launch_counts()
        t1 = time.monotonic()
        try:
            summary = soak_serving_torch.run_disagg_soak(seed=0)
        finally:
            undo()
        wall = time.monotonic() - t1
        launches = kernels.launch_counts()
        check(summary["ok"], "25b: the disagg soak's bar failed: "
              + json.dumps(summary, default=str)[:4000])
        check(launches.get("layernorm_fwd", 0) > 0,
              f"25b: B7 never launched: {launches}")
        out["25b"] = {
            "wall_s": wall, "completed": summary["completed"],
            "streamed_completed": summary["streamed_completed"],
            "completed_after_kill": summary["completed_after_kill"],
            "typed_errors": summary["typed_errors"],
            "fired_by_site": summary["fired_by_site"],
            "router": summary["router"],
            "watchdog": p25_watchdog([s.engine for s in servers]),
            "launches": {k: launches.get(k, 0) for k in P25_KERNELS},
        }
        counts.append(launches)
        log(f"25b disagg soak: {wall:.1f} s, completed "
            f"{summary['completed']} ({summary['streamed_completed']} "
            f"streamed), after the kills {summary['completed_after_kill']}, "
            f"fired {summary['fired_by_site']}, router {summary['router']}, "
            f"watchdog {out['25b']['watchdog']}, launches "
            f"{out['25b']['launches']} on {smi}")
        torch.cuda.empty_cache()

        rc, stdout, stderr = p25_wait(procs["25c"], P25_TIMEOUT, "25c")
        wall = os.path.getmtime(procs["25c"]._p25_files[2]) - started["25c"]
        check(rc == 0, f"25c the training soak exited {rc}:\n"
              f"{stdout[-3000:]}\n{stderr[-3000:]}")
        summary = json.loads(stdout)
        launched, nprocs = p25_counts(cdir)
        check(launched.get("sgd_fused", 0) > 0,
              f"25c: B1 never launched: {launched}")
        rc, top, err = p25_wait(waiters["ps"][0], 60, "25e ps")
        check(rc == 0 and "training_ps_commits" in top,
              f"25e dkt_top --ps exited {rc}:\n{top[-2000:]}\n{err[-2000:]}")
        ledger, training = (summary["phases"]["ledger"],
                            summary["phases"]["training"])
        out["25c"] = {
            "wall_s": wall, "ledger": {k: ledger[k] for k in (
                "applied_updates", "expected_updates", "exactly_once",
                "promote_reason", "fired_by_site", "postmortem_names_seam")},
            "training": {k: training[k] for k in (
                "expected_updates", "accuracy_clean", "accuracy_faulted",
                "ledger_match")},
            "failovers": training["faulted"]["failovers"],
            "promotions": len(training["faulted"]["promotions"]),
            "ps_scrape_lines": len(top.splitlines()),
            "processes": nprocs,
            "launches": {k: launched.get(k, 0) for k in P25_KERNELS},
        }
        counts.append(launched)
        log(f"25c training soak (ledger 4 x 40, training smoke): {wall:.1f} "
            f"s, ledger {out['25c']['ledger']}, training "
            f"{out['25c']['training']}, failovers {out['25c']['failovers']}, "
            f"launches {out['25c']['launches']}; 25e dkt_top --ps on the "
            f"standby: {out['25c']['ps_scrape_lines']} lines on {smi}")

        # 25d: the fleet and fabric smokes, their replicas processes too
        for part, args in fleet_args.items():
            rc, stdout, stderr = p25_wait(procs[part], P25_TIMEOUT,
                                          f"25d {part}")
            wall = os.path.getmtime(procs[part]._p25_files[2]) - started[part]
            check(rc == 0, f"25d soak_fleet_torch.py {' '.join(args)} exited "
                  f"{rc}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
            summary = json.loads(stdout)
            launched, nprocs = p25_counts(os.path.join(tmp, f"counts_{part}"))
            check(launched.get("layernorm_fwd", 0) > 0,
                  f"25d {part}: B7 never launched: {launched}")
            if part == "fleet":
                row = {k: summary[k] for k in (
                    "completed", "typed_errors", "fired_by_site", "kill",
                    "autoscale", "deploy", "ejections", "postmortems",
                    "compile_storms")}
                row["replaced"] = len(summary["rollover"]["replaced"])
                row["hedges"] = summary["resilience"]["hedges"]
            else:
                row = {ph: {k: summary[ph].get(k) for k in (
                    "completed", "typed_errors", "peer", "router",
                    "pairing_balanced", "probe_identical")}
                    for ph in ("fetch", "push")}
            row.update(wall_s=wall, processes_counted=nprocs,
                       launches={k: launched.get(k, 0) for k in P25_KERNELS})
            out[f"25d_{part}"] = row
            counts.append(launched)
            log(f"25d {part} smoke: {wall:.1f} s, {json.dumps(row)} on "
                f"{smi}")
    finally:
        for proc in [w[0] for w in waiters.values()] + list(procs.values()):
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds_total"] = time.monotonic() - t0
    out["launches"] = {k: sum(c.get(k, 0) for c in counts)
                       for k in kernels.LAUNCHES}
    return out, counts


def baseline_leaf_shapes():
    """The parameter shapes of configs 2-5's models (built on the CPU: only
    their leaf tables matter to phases 2b/2c)."""
    from distkeras_tpu_torch.models import zoo

    out = {}
    for cfg in BASELINE:
        name, kw = cfg["model"]
        model = getattr(zoo, name)(seed=0, device="cpu", **kw)
        out[name] = [p.shape for p in model.parameters()]
    return out


#: (category, substrings of the kernel names that fall in it), first match
#: wins: the port's kernels by name, then the matrix products and copies
KERNEL_CATEGORIES = (
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nchwToNhwc",
              "nhwcToNchw", "implicit_convolve")),
    ("flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("layernorm", ("ln_fwd_", "ln_bwd_")),
    ("adam_fused", ("adam_fused_kernel",)),
    ("sgd_fused", ("sgd_fused_kernel", "sgd_momentum_fused_kernel")),
    ("gemm", ("gemm", "splitKreduce")),
    ("memcpy", ("Memcpy", "Memset")),
)


def device_profile(torch, fn, calls):
    """``torch.profiler`` over ``calls`` calls of ``fn``: device kernel
    time per call (ms), kernels per call, and the top kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [a for a in prof.key_averages()
            if getattr(a, "device_type", None) == cuda]

    def dev_us(a):
        return getattr(a, "self_device_time_total", 0.0)

    top = sorted(kern, key=dev_us, reverse=True)[:10]
    by_category = {}
    for a in kern:
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in a.key for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + dev_us(a) / calls / 1e3
    return {
        "device_ms": sum(dev_us(a) for a in kern) / calls / 1e3 if kern else None,
        "device_ms_by_category": by_category,
        "kernels": sum(a.count for a in kern) / calls,
        "top_kernels": [
            {"name": a.key[:80], "per_call": a.count / calls,
             "device_us_per_call": dev_us(a) / calls}
            for a in top
        ],
    }


def profile_train_step(torch, np, lm, window=4, windows=3):
    """One training step as ``SingleTrainer`` runs it (flash + LN hooks,
    pallas_adam, batch 8 x 512): windows of 4 steps ending in the one host
    read of their metrics; per-step wall and device time."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam
    from distkeras_tpu_torch.utils.rng import RngSeq
    from distkeras_tpu_torch.workers import WorkerCore, _metrics_to_records

    model = lm.copy()
    attach_flash_attention(model)
    attach_fused_layernorm(model)
    core = WorkerCore(model, FusedAdam(1e-3), "next_token_crossentropy",
                      metrics=["next_token_accuracy"])
    opt_state = core.init_opt_state(list(model.parameters()))
    rng = RngSeq(0)
    xs = torch.as_tensor(np.random.default_rng(4).integers(
        0, 8192, (window, 8, 512)), device="cuda")

    def run_window():
        _, mets = core.window(model, opt_state, rng, xs, xs)
        _metrics_to_records(mets)

    run_window()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(windows):
        run_window()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / (windows * window) * 1e3
    prof = device_profile(torch, run_window, windows)
    prof["device_ms"] = (None if prof["device_ms"] is None
                         else prof["device_ms"] / window)
    prof["kernels"] /= window
    prof["device_ms_by_category"] = {
        c: ms / window for c, ms in prof["device_ms_by_category"].items()}
    for k in prof["top_kernels"]:
        k["per_call"] /= window
        k["device_us_per_call"] /= window
    del model, core, opt_state
    return {"wall_ms": wall, **prof}


def profile_train_epoch(torch, np, lm):
    """Phase 5's kernel-path epoch once more, on a warm process: per-window
    wall times, with the Python collector's runs and the Adam table builds
    counted, to tell a slow window's cause."""
    import gc

    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    model = lm.copy()
    attach_flash_attention(model)
    attach_fused_layernorm(model)
    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    runs = []
    for collector in (True, False):
        gc.collect()
        if not collector:
            gc.disable()
        before = sum(st["collections"] for st in gc.get_stats())
        try:
            trainer, _, secs = train_once(torch, model, "pallas_adam", ds)
        finally:
            gc.enable()
        runs.append({
            "gc_enabled": collector, "seconds": secs,
            "window_seconds": [t for _, t in trainer.history.get_timings()],
            "gc_collections": sum(st["collections"] for st in gc.get_stats())
            - before,
            "adam_table_builds": trainer.optimizer._tables.builds,
            "adam_grad_pointer_uploads": trainer.optimizer._tables.grad_uploads,
        })
    log(f"profile train_epoch_again: {runs}")
    return runs


def profile_async_window(torch, np, zoo, windows=3):
    """One async window as a ``DOWNPOURWorker`` runs it (flash + LN hooks,
    pallas_sgd, 4 steps of 8 x 512, device-resident): pull (center copy +
    H2D), the window, the commit (delta on the card, D2H, PS add) — host
    wall, the split, device time and the top kernels per window."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.pallas_kernels import FusedSGD
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.workers import DOWNPOURWorker, WorkerCore

    lm = make_lm(zoo)
    attach_flash_attention(lm)
    attach_fused_layernorm(lm)
    core = WorkerCore(lm, FusedSGD(ASYNC_LR), "next_token_crossentropy",
                      metrics=["next_token_accuracy"])
    ps = DeltaParameterServer(dict(zip(lm._leaf_order(), lm.get_weights())))
    worker = DOWNPOURWorker(core, ps, 0, "features", "label", 4)
    worker.stage_resident(loaders.text_corpus(seq_len=512, vocab_size=8192))
    full = itertools.cycle(list(worker.iter_index_windows(1, 8, 0))[:4])

    def run_window():
        worker.begin_window_indexed(next(full))
        worker.finish_window()

    run_window()  # the replica, its table and cuBLAS warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(windows):
        run_window()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / windows * 1e3
    splits = worker.splits[1:1 + windows]
    prof = device_profile(torch, run_window, windows)
    out = {"wall_ms": wall, **prof,
           "split_ms": {k: 1e3 * float(np.mean([s[k] for s in splits]))
                        for k in ("pull", "window", "commit")}}
    del worker, core, ps, lm
    torch.cuda.empty_cache()
    return out


def profile_resnet_window(torch, np, windows=3):
    """One DynSGD/``resnet18`` window as config 5 runs it (pallas_adam,
    bf16, 4 streamed steps of 32 x 64 x 64 x 3): host wall and its split,
    device ms by category (convolutions, B3, PS copies, GEMMs, other), the
    BatchNorm layers' own device time (their 20 forwards and backwards at
    the window's shapes, profiled alone; the elementwise and reduction
    kernels they launch fall under "other" in the window) and the idle
    share."""
    from distkeras_tpu_torch.models import layers as tl
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.models.sequential import walk_layers
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam
    from distkeras_tpu_torch.parameter_servers import DynSGDParameterServer
    from distkeras_tpu_torch.workers import DynSGDWorker, WorkerCore

    name, kw = BASELINE[3]["model"]
    model = getattr(zoo, name)(seed=0, **kw)
    core = WorkerCore(model, FusedAdam(1e-3), "categorical_crossentropy",
                      compute_dtype="bfloat16")
    ps = DynSGDParameterServer(dict(zip(model._leaf_order(),
                                        model.get_weights())))
    worker = DynSGDWorker(core, ps, 0, "features", "label_onehot", 4)
    train, _, _ = baseline_data("imagenet")
    full = itertools.cycle(list(worker.iter_window_batches(train, 32, 1, 0))
                           [:4])

    def run_window():
        worker.begin_window(next(full))
        worker.finish_window()

    run_window()  # the replica, its table and cuDNN warm
    seen = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: seen.append((mod.momentum, inp[0].shape,
                                           inp[0].dtype)))
        for layer in walk_layers(worker._model)
        if isinstance(layer, tl.BatchNorm)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(windows):
        run_window()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / windows * 1e3
    for h in hooks:
        h.remove()
    splits = worker.splits[1:1 + windows]
    prof = device_profile(torch, run_window, windows)
    per_step = seen[:len(hooks)]
    bns, xs = [], []
    for momentum, shape, dtype in per_step:
        bn = tl.BatchNorm(momentum=momentum)
        bn.init(None, tuple(shape[1:]))
        bns.append(bn.to("cuda").train())
        xs.append(torch.randn(shape, device="cuda", dtype=dtype,
                              requires_grad=True))

    def bn_step():
        outs = [bn(x) for bn, x in zip(bns, xs)]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    bn_prof = device_profile(torch, bn_step, 4)
    out = {"wall_ms": wall, **prof,
           "batchnorm_layers": len(per_step),
           "batchnorm_device_ms_per_window": (
               None if bn_prof["device_ms"] is None
               else 4 * bn_prof["device_ms"]),
           "split_ms": {k: 1e3 * float(np.mean([s[k] for s in splits]))
                        for k in ("pull", "window", "commit")}}
    del worker, core, ps, model, bns, xs
    torch.cuda.empty_cache()
    return out


class FixedProposals:
    """A drafter that proposes ``k`` tokens (all 1) for every active slot,
    so every ``spec_step`` runs the verify (the profile's window)."""

    name = "fixed"
    wants_sequences = False

    def bind(self, stepper):
        pass

    def warmup(self):
        pass

    def admit(self, slot, prompt):
        pass

    def release(self, slot):
        pass

    def invalidate(self, mask):
        pass

    def sync(self, active, toks, counts, lens0):
        pass

    def propose(self, active, k, seqs):
        import numpy as np

        return (np.ones((len(active), k), np.int32),
                np.where(active, k, 0).astype(np.int32))


def profile_swap_fork(torch, np, lm, calls=5):
    """A 300-token slot of the LN-hooked LM on a paged 8-slot stepper
    (warmed): ``swap_out``, ``swap_in`` of that state into a free slot, and
    a ``fork_slot`` (18 shared pages, one CoW copy of the partial frontier
    page): host wall per call (synchronized), device time, bytes moved,
    idle share."""
    from distkeras_tpu_torch.serving.engine import DecodeStepper

    st = DecodeStepper(lm, num_slots=8, paged=True)
    st.warmup()
    st.warm_restore_buckets()
    st.admit(0, np.random.default_rng(16).integers(0, 8192, 300), max_new=64)
    state = st.swap_out(0)
    nbytes = state_bytes(state)

    def swap_in():
        st.release(1)
        st.swap_in(1, state, max_new=64)

    def fork():
        st.release(2)
        st.fork_slot(0, 2, max_new=64)

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    out = {}
    for name, fn, moved in (("swap_out_300", lambda: st.swap_out(0), nbytes),
                            ("swap_in_300", swap_in, nbytes),
                            ("fork_300", fork, None)):
        out[name] = {"wall_ms": wall_ms(fn), "bytes": moved,
                     **device_profile(torch, fn, calls)}
    out["fork_300"]["cow_copies"] = st._kv_alloc.cow_copies
    out["fork_300"]["shared_pages"] = (300 - 1) // st.page_size
    del st
    return out


def profile_paths(torch, np, lm, zoo, steps=20):
    """Where the time goes (``--profile``): a decode step with 8 busy slots
    on the LayerNorm-hooked model (dense, paged, on bf16 caches, and
    grammar-masked), a verify window of 5
    candidates on the same 8 slots, one predict forward (8 x 512) with both
    hooks, one training step and one async window — host wall per call
    (synchronized), device kernel time per call, the device's idle share,
    and the kernels that take the most device time."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving.engine import DecodeStepper
    from distkeras_tpu_torch.serving.sampling import SamplingParams

    def wall_ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / calls * 1e3

    attach_fused_layernorm(lm)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 8192, 64) for _ in range(8)]
    # the dense step, the same step on the paged pool (8 slots reserved
    # to capacity, so the tables bucket to 32 pages: the dense step's
    # 512-position extent) and a verify window of 5 candidates (every call
    # verifies 4 fixed proposals per slot), their walls taken in turns
    gc.collect()
    st = DecodeStepper(lm, num_slots=8)
    pst = DecodeStepper(lm, num_slots=8, paged=True)
    vst = DecodeStepper(lm, num_slots=8, speculative=FixedProposals(),
                        draft_k=4)
    vst.warmup()
    # the same step on bf16 caches, and the grammar-masked step (every
    # slot constrained to half the vocabulary)
    bst = DecodeStepper(lm, num_slots=8, kv_dtype=torch.bfloat16)
    mst = DecodeStepper(lm, num_slots=8)
    mst.warm_constrained_buckets()
    half = SamplingParams(grammar={"kind": "allow",
                                   "tokens": list(range(0, 8192, 2))})
    for i, p in enumerate(prompts):
        for s in (st, pst, vst, bst):
            s.admit(i, p)
        mst.admit(i, p, sampling=half)
    active = np.ones(8, bool)
    out = {}
    calls = {"dense": lambda: st.step(active),
             "paged": lambda: pst.step(active),
             "verify": lambda: vst.spec_step(active),
             "bf16": lambda: bst.step(active),
             "masked": lambda: mst.step(active)}
    # three rounds, each starting one kind later: the host's pace drifts
    # between calls, so a wall is the median of its turns
    walls = {kind: [] for kind in calls}
    kinds = list(calls)
    for r in range(3):
        for kind in kinds[r:] + kinds[:r]:
            walls[kind].append(wall_ms(calls[kind], steps))
    prof = {kind: {"wall_ms": float(np.median(walls[kind])),
                   "wall_ms_turns": walls[kind],
                   **device_profile(torch, calls[kind], steps)}
            for kind in calls}
    # the masked step's own host work: the mask rows and their copy
    tmask = mst._build_tmask(active)
    t0 = time.perf_counter()
    for _ in range(steps):
        mst._build_tmask(active)
    prof["masked"]["build_tmask_ms"] = (time.perf_counter() - t0) / steps * 1e3
    prof["masked"]["mask_to_device_ms"] = wall_ms(
        lambda: mst._to_dev(tmask), steps)
    decode, paged, verify = prof["dense"], prof["paged"], prof["verify"]
    paged["table_bucket"] = pst._table_bucket()
    verify["verify_steps"] = vst.spec_verify_steps
    prof["bf16"]["kv_bytes_total"] = bst.kv_bytes_total()
    decode["kv_bytes_total"] = st.kv_bytes_total()
    prof["masked"]["constrained_masks"] = mst.constrained_masks
    del st, pst, vst, bst, mst
    gc.collect()
    swap_fork = profile_swap_fork(torch, np, lm)
    attach_flash_attention(lm)
    x = torch.as_tensor(rng.integers(0, 8192, (8, 512)), device="cuda")

    def fwd():
        with torch.no_grad():
            lm(x)

    predict = {"wall_ms": wall_ms(fwd, 5), **device_profile(torch, fwd, 5)}
    detach_hooks(lm)
    train = profile_train_step(torch, np, lm)
    out["train_epoch_again"] = profile_train_epoch(torch, np, lm)
    async_window = profile_async_window(torch, np, zoo)
    resnet_window = profile_resnet_window(torch, np)
    for name, r in (("decode_step", decode), ("paged_decode_step", paged),
                    ("verify_window", verify),
                    ("decode_step_bf16", prof["bf16"]),
                    ("masked_decode_step", prof["masked"]),
                    *swap_fork.items(),
                    ("predict_forward", predict),
                    ("train_step", train), ("async_window", async_window),
                    ("resnet18_dynsgd_window", resnet_window)):
        if r["device_ms"] is not None:
            r["device_idle_share"] = 1 - r["device_ms"] / r["wall_ms"]
        out[name] = r
        log(f"profile {name}: " + str({k: v for k, v in r.items()
                                         if k != "top_kernels"}))
        for k in r["top_kernels"]:
            log(f"  {k}")
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write results here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a decode step and a predict forward")
    ap.add_argument("--sync-rank-out", default=None,
                    help=argparse.SUPPRESS)  # phase 20b's rank processes
    ap.add_argument("--tpsp-rank-out", default=None,
                    help=argparse.SUPPRESS)  # phase 21's rank processes
    ap.add_argument("--phase21-only", action="store_true",
                    help="build the kernels and run phase 21 alone")
    ap.add_argument("--p22-rank-out", default=None,
                    help=argparse.SUPPRESS)  # phase 22's rank processes
    ap.add_argument("--phase22-only", action="store_true",
                    help="build the kernels and run phase 22 alone")
    ap.add_argument("--phase23-only", action="store_true",
                    help="build the kernels and run phase 23 alone")
    ap.add_argument("--p24-rank-out", default=None,
                    help=argparse.SUPPRESS)  # 24a's rank processes
    ap.add_argument("--phase24-only", action="store_true",
                    help="build the kernels and run phase 24 alone")
    ap.add_argument("--phase25-only", action="store_true",
                    help="build the kernels and run phase 25 alone")
    ap.add_argument("--phase27-only", action="store_true",
                    help="build the kernels and run phase 27 alone (24a "
                         "with 27a, then 27b and 27c)")
    ap.add_argument("--phase2c-only", action="store_true",
                    help="build the kernels and run phases 2b and 2c "
                         "(the fused optimizers) alone")
    ap.add_argument("--import-seconds", nargs="+", metavar="ROOT",
                    help="time `import distkeras_tpu_torch` from each "
                         "checkout ROOT in turn, in fresh interpreters, "
                         "and exit")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import distkeras_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(distkeras_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: imported the port from {pkg_dir}, not from "
              f"this checkout", file=sys.stderr)
        return 1
    if args.sync_rank_out:
        return sync_rank_main(args.sync_rank_out)
    if args.tpsp_rank_out:
        return tpsp_rank_main(args.tpsp_rank_out)
    if args.p22_rank_out:
        return p22_rank_main(args.p22_rank_out)
    if args.p24_rank_out:
        return p24_rank_main(args.p24_rank_out)
    if args.import_seconds:
        rows = []
        for root in args.import_seconds:
            vals = import_seconds(root)
            rows.append({"root": root, "seconds": vals,
                         "median_s": sorted(vals)[len(vals) // 2]})
            log(f"import distkeras_tpu_torch from {root}: median "
                f"{rows[-1]['median_s']:.3f} s of {vals}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"imports": rows}, f, indent=1)
        return 0
    import numpy as np
    import torch.nn.functional as F

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.kernels import build
    from distkeras_tpu_torch.models import zoo

    # full f32 matmuls, no TF32 anywhere (the reference precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.monotonic()
    build.build()
    log(f"kernels built from {build.CSRC} in {time.monotonic() - t0:.1f} s")
    for kname, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{kname}] {line.strip()}")

    if args.phase2c_only:
        t2 = time.monotonic()
        lm_shapes = [p.shape for p in make_lm(zoo).parameters()]
        adam_rows, sgd_rows = run_phase2c(torch, lm_shapes)
        log(f"phases 2b-2c in {time.monotonic() - t2:.1f} s on {smi}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "adam_fused": adam_rows,
                           **sgd_rows}, f, indent=1)
        return 0
    if args.phase21_only:
        tpsp, _ = run_phase21(torch, np, zoo, smi)
        log(f"phase 21 in {tpsp['seconds_total']:.1f} s, launches "
            f"{tpsp['launches']} on {smi}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "phase21": tpsp}, f, indent=1)
        return 0
    if args.phase22_only:
        epp, _ = run_phase22(torch, np, zoo, smi)
        log(f"phase 22 in {epp['seconds_total']:.1f} s, launches "
            f"{epp['launches']} on {smi}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "phase22": epp}, f, indent=1)
        return 0
    if args.phase23_only:
        mesh, _ = run_phase23(torch, np, zoo, smi, profile=args.profile)
        log(f"phase 23 in {mesh['seconds_total']:.1f} s, launches "
            f"{mesh['launches']} on {smi}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "phase23": mesh}, f, indent=1)
        return 0
    if args.phase25_only:
        soaks, _ = run_phase25(torch, np, zoo, smi)
        log(f"phase 25 in {soaks['seconds_total']:.1f} s, launches "
            f"{soaks['launches']} on {smi}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "phase25": soaks}, f, indent=1)
        return 0
    if args.phase24_only or args.phase27_only:
        twins, _, entries = run_phase24(torch, np, zoo, smi,
                                        twins=args.phase24_only)
        log(f"phase 24 in {twins['seconds_total']:.1f} s, launches "
            f"{twins['launches']} on {smi}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "phase24": twins,
                           "phase27": entries}, f, indent=1)
        return 0

    ln_rows = check_layernorm(torch, F)
    flash_rows = check_flash(torch, F)

    lm = make_lm(zoo)
    log(f"transformer_lm d512/L8: {lm.num_params()} parameters in "
        f"{len(list(lm.parameters()))} leaves")
    lm_shapes = [p.shape for p in lm.parameters()]
    adam_rows, sgd_rows = run_phase2c(torch, lm_shapes)
    fbwd_rows = check_flash_bwd(torch, F)
    inf_rows = check_flash_infinite_rows(torch)
    lnb_rows = check_layernorm_bwd(torch, F)
    torch.cuda.empty_cache()

    pred = run_predict(torch, np, lm)
    gen, gen_reqs, gen_outs = run_generate(torch, np, lm)
    log(f"generate: {gen['requests']} requests, "
        f"{gen['tokens_per_s']:.1f} tokens/s on {smi}")
    train = run_train(torch, np, zoo)
    log(f"train: {train['steps']} steps, {train['samples_per_s']:.1f} "
        f"samples/s = {train['tokens_per_s']:.0f} tokens/s (steady "
        f"{train['steady_tokens_per_s']:.0f} tokens/s) on {smi}")
    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    async_sim, async_centers = run_async_simulated(torch, np, zoo, ds)
    async_thr = run_async_threads(torch, np, zoo, ds)
    log(f"async threads: {async_thr['threads_tokens_per_s']:.0f} tokens/s "
        f"after the warm-up ({async_thr['tokens_per_s']:.0f} over train()), "
        f"window split {async_thr['window_split_s']} on {smi}")
    t7 = time.monotonic()
    baseline, baseline_launches, baseline_centers = run_baseline(
        torch, np, smi)
    log(f"baseline configs 2-5 in {time.monotonic() - t7:.1f} s")
    t8 = time.monotonic()
    resume, resume_launches = run_resume(torch, np, zoo, ds)
    lm_resume = resume["lm"]
    log(f"resume: LM checkpoint {lm_resume['checkpoint_bytes']} bytes, "
        f"save {lm_resume['save_seconds']} s, restore "
        f"{lm_resume['restore_seconds']} s on {smi}; phase 8 in "
        f"{time.monotonic() - t8:.1f} s")
    t9 = time.monotonic()
    members, member_launches = run_phase9(torch, np, zoo, ds, smi, baseline)
    log(f"phase 9 in {time.monotonic() - t9:.1f} s")
    t10 = time.monotonic()
    socket_tier, socket_launches = run_phase10(
        torch, np, zoo, ds, smi, baseline, baseline_centers, async_sim,
        async_centers)
    del baseline_centers, async_centers
    log(f"phase 10 in {time.monotonic() - t10:.1f} s")
    front, front_launches = run_phase11(torch, np, lm, smi, pred, gen,
                                        gen_reqs, gen_outs)
    log(f"phase 11 in {front['seconds_total']:.1f} s on {smi}")
    healing, healing_launches = run_phase12(torch, np, lm, smi, gen_reqs,
                                            gen_outs)
    log(f"phase 12 in {healing['seconds_total']:.1f} s, launches "
        f"{healing['launches']} on {smi}")
    paging, paging_launches = run_phase13(torch, np, lm, smi, gen, gen_reqs,
                                          gen_outs)
    log(f"phase 13 in {paging['seconds_total']:.1f} s, launches "
        f"{paging['launches']} on {smi}")
    spec, spec_launches = run_phase14(torch, np, lm, smi, zoo, gen,
                                      gen_reqs, gen_outs)
    log(f"phase 14 in {spec['seconds_total']:.1f} s, launches "
        f"{spec['launches']} on {smi}")
    qos, qos_launches = run_phase15(torch, np, lm, smi, paging)
    log(f"phase 15 in {qos['seconds_total']:.1f} s, launches "
        f"{qos['launches']} on {smi}")
    knobs, knobs_launches = run_phase16(torch, np, lm, smi, gen_reqs)
    log(f"phase 16 in {knobs['seconds_total']:.1f} s, launches "
        f"{knobs['launches']} on {smi}")
    disagg, disagg_launches = run_phase17(torch, np, lm, smi, gen_reqs)
    log(f"phase 17 in {disagg['seconds_total']:.1f} s, launches "
        f"{disagg['launches']} on {smi}")
    fleet, fleet_launches = run_phase18(torch, np, lm, smi, front, gen_reqs,
                                        gen_outs)
    log(f"phase 18 in {fleet['seconds_total']:.1f} s, launches "
        f"{fleet['launches']} on {smi}")
    moe, moe_launches = run_phase19(torch, np, lm, zoo, smi, gen, gen_reqs,
                                    profile=args.profile)
    log(f"phase 19 in {moe['seconds_total']:.1f} s, launches "
        f"{moe['launches']} on {smi}")
    sync, sync_launches = run_phase20(torch, np, zoo, smi)
    log(f"phase 20 in {sync['seconds_total']:.1f} s, launches "
        f"{sync['launches']} on {smi}")
    tpsp, tpsp_launches = run_phase21(torch, np, zoo, smi)
    log(f"phase 21 in {tpsp['seconds_total']:.1f} s, launches "
        f"{tpsp['launches']} on {smi}")
    epp, epp_launches = run_phase22(torch, np, zoo, smi)
    log(f"phase 22 in {epp['seconds_total']:.1f} s, launches "
        f"{epp['launches']} on {smi}")
    mesh, mesh_launches = run_phase23(torch, np, zoo, smi,
                                      profile=args.profile)
    log(f"phase 23 in {mesh['seconds_total']:.1f} s, launches "
        f"{mesh['launches']} on {smi}")
    twins, twin_launches, entries = run_phase24(torch, np, zoo, smi)
    log(f"phase 24 in {twins['seconds_total']:.1f} s (phase 27 riding on "
        f"it), launches {twins['launches']} on {smi}")
    soaks, soak_launches = run_phase25(torch, np, zoo, smi)
    log(f"phase 25 in {soaks['seconds_total']:.1f} s, launches "
        f"{soaks['launches']} on {smi}")
    profile = profile_paths(torch, np, lm, zoo) if args.profile else None

    phases = [pred["launches"], gen["launches"], train["launches"],
              async_thr["launches"], baseline_launches, resume_launches,
              member_launches, socket_launches, *front_launches,
              *healing_launches, *paging_launches, *spec_launches,
              *qos_launches, *knobs_launches, *disagg_launches,
              *fleet_launches, *moe_launches, *sync_launches,
              *tpsp_launches, *epp_launches, *mesh_launches,
              *twin_launches, *soak_launches,
              *(r["launches"] for r in async_sim.values())]
    launches = {k: sum(c.get(k, 0) for c in phases) for k in kernels.LAUNCHES}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")

    def entry(kname, source, replaces, rows, main_shape):
        main = next(r for r in rows if r["shape"] == main_shape
                    and r.get("dtype", "float32") == "float32")
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "jax": replaces.split("/")[-1],
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err": max(r["max_abs_err"] for r in rows),
            "ok": all(r["ok"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main_shape,
            "shapes": rows,
        }

    kline = {"kernels": [
        entry("layernorm_fwd",
              "distkeras_tpu_torch/kernels/csrc/layernorm_fwd.cu",
              "distkeras_tpu/ops/fused_layernorm.py:113", ln_rows, [8, 512]),
        entry("flash_fwd", "distkeras_tpu_torch/kernels/csrc/flash_fwd.cu",
              "distkeras_tpu/ops/flash_attention.py:123", flash_rows,
              [8, 512, 8, 64]),
        entry("layernorm_bwd",
              "distkeras_tpu_torch/kernels/csrc/layernorm_bwd.cu",
              "distkeras_tpu/ops/fused_layernorm.py:135", lnb_rows,
              [4096, 512]),
        entry("flash_bwd_dq", "distkeras_tpu_torch/kernels/csrc/flash_bwd.cu",
              "distkeras_tpu/ops/flash_attention.py:285",
              fbwd_rows["flash_bwd_dq"], [8, 512, 8, 64]),
        entry("flash_bwd_dkv",
              "distkeras_tpu_torch/kernels/csrc/flash_bwd.cu",
              "distkeras_tpu/ops/flash_attention.py:295",
              fbwd_rows["flash_bwd_dkv"], [8, 512, 8, 64]),
        entry("adam_fused", "distkeras_tpu_torch/kernels/csrc/adam_fused.cu",
              "distkeras_tpu/ops/pallas_kernels.py:168", adam_rows,
              adam_rows[0]["shape"]),
        entry("sgd_fused", "distkeras_tpu_torch/kernels/csrc/sgd_fused.cu",
              "distkeras_tpu/ops/pallas_kernels.py:98", sgd_rows["sgd_fused"],
              sgd_rows["sgd_fused"][0]["shape"]),
        entry("sgd_momentum_fused",
              "distkeras_tpu_torch/kernels/csrc/sgd_fused.cu",
              "distkeras_tpu/ops/pallas_kernels.py:120",
              sgd_rows["sgd_momentum_fused"],
              sgd_rows["sgd_momentum_fused"][0]["shape"]),
    ]}
    check(not any(m in ("jax", "distkeras_tpu", "ml_dtypes")
                  or m.startswith(("jax.", "distkeras_tpu.", "ml_dtypes."))
                  for m in sys.modules),
          "JAX, the JAX package or ml_dtypes was imported")
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "device": device,
                       "kernels": kline["kernels"], "predict": pred,
                       "generate": gen, "train": train,
                       "async_simulated": async_sim,
                       "async_threads": async_thr, "baseline": baseline,
                       "resume": resume, "phase9": members,
                       "phase10": socket_tier, "phase11": front,
                       "phase12": healing, "phase13": paging,
                       "phase14": spec, "phase15": qos,
                       "phase16": knobs, "phase17": disagg,
                       "phase18": fleet, "phase19": moe,
                       "phase20": sync, "phase21": tpsp,
                       "phase22": epp, "phase23": mesh,
                       "phase24": twins, "phase25": soaks,
                       "phase27": entries,
                       "profile": profile,
                       "flash_infinite_q": inf_rows},
                      f, indent=1)
    print(json.dumps(kline), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    except Exception:  # noqa: BLE001 — any phase failing fails the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
