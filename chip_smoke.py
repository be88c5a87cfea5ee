#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``our_tree_tpu_torch`` (never the JAX package) through its seven
paths, AES-128-CTR over one 256 MiB buffer with the bench chain, the
ECB/CBC/CFB128 block-mode path over the same size, the measured roofline
(the ceiling probe ``harness.ceiling`` and the serve bench's cost and
profile sections that use its figure), the multi-key CTR serve path
(``serve.bench``, the JAX package's two documented drives at the full
ladder), the sweep harness (``harness.bench``, with ARC4 and the native C
tier), the mixed ``ctr,gcm,gcm-open,cbc`` serve path (the JAX package's
documented mixed-mode drive, and its auth-failure rehearsal) and AES-GCM
through the models API (``aead.gcm``: ``gcm_seal``/``gcm_open`` over 256
MiB, on ``ghash_at``) and chunked transfers with the wire worker
(``serve.transfer``, ``python -m our_tree_tpu_torch.serve.worker`` and its
status endpoint) and the rc4 serve mode with its sessions and the serve
side's fault seams and journal (``serve.session``, the session acceptance
drive with a hung lane, the journal round trip, the worker's ``ss``
frames) and engine selection with the port's entry (``entry()``, the bench's
probe stage and device lock, the device key schedules, the native serve
engine, ``ot_bench``) and the routing tier (``python -m
our_tree_tpu_torch.route.bench``, a consistent-hash router in front of port
workers on this card), and holds
every kernel of those paths against its plain torch version on the card. Phases, in order; any failure raises and the exit code
is not 0:

1. the card's name and power limit; build the kernels (one ``nvcc`` per
   source, in parallel), print ``ptxas -v`` per kernel;
2. kernel vs plain version: ``ctr_gen`` at every counter wrap in each form
   (auto, group forced, block forced), its block form also at N in {1, 2,
   31, 33, 4096} and the auto form either side of its crossing, and both ECB
   kernels, for nr 10/12/14 at N in {1, 31, 33, 1000, 2^20, 2^24 + 7} (the
   last a 256 MiB launch with a ragged tail; from 2^20 up, and every
   kernel's 2^20-block cases below, with ``LARGE_BITS`` = 128 only, every
   key size at the smaller N), encrypt in each form (auto,
   group forced, block forced), and the encrypt block form at N in {1, 2,
   31, 33, 4096}; ``ctr_mk``
   for nr 10/12/14, K in {1, 3, 8, 64}, N in {1, 31, 33, 1000, 4096, 2^20},
   with one slot, runs of 1-300 blocks, a random slot per block and unused
   zero schedules, and its K = 1 entry over counters from every wrap nonce,
   every case in the auto form and in each form forced (group, block);
   ``cbc_mk`` (multi-key CBC decrypt) for nr 10/12/14, K in {1, 3, 8, 64},
   N in {1, 31, 33, 1000, 4096, 2^20}, with one slot, runs of 1-300 blocks
   and a random slot per block, the upper half of each stack the unused
   all-zero schedule, and at every rung of the serve ladder (32 to 4,096
   blocks) with K = 8 in the same three patterns;
   ``seq_encrypt`` (chained CBC and CFB128) for nr 10/12/14, S in {1, 3,
   4096} streams, N in {1, 2, 33, 4096} blocks (up to 33 blocks against the
   whole plain loop, at 4,096 against every plain step at once), each case
   in every form (auto, thread, lanes4, lanes8, lanes16);
   ``chain`` in its four regimes at N in {1, 31, 4097, 2^20 + 3} words and
   at 64 MiB, and its 65,536-step latency chain over one word (mismatching
   words must be 0); ``arc4_prga`` for S in {1, 7, 32, 33, 4096} streams x {1,
   255, 4096, 2^16, 2^17} bytes, each as keystream, fused XOR and a resume
   across two calls, against the first S rows of one timed plain run a
   length on 4,096 streams, from random permutations and again from the
   states on which the kernel's lookahead corrections fire often
   (``tests/arc4_states.py``) (mismatching bytes must be 0), and for S in {1,
   7, 32} at 2^20 bytes (the sweep's length) its first 2^17 bytes against
   that plain run and the rest against a resume from them (the plain
   version's depth is cut to 2^17 bytes: its per-byte loop takes about 31 s
   there over both kinds of states, 61 s at 2^18 and about 100 s a kind at
   2^20, which would take the script past 1,080 s);
3. NIST SP800-38A F.5.1 CTR KAT and a chunked ``crypt_ctr`` resume; F.1,
   F.2 and F.3.13 (ECB, CBC, CFB128) in both directions through ``AES`` on
   the card, whose engine must be the CUDA one (each CBC/CFB128 encrypt one
   ``seq_encrypt`` launch), F.2.1 and F.3.13 through the chained
   kernel's own entries, and F.2.1/F.2.3/F.2.5 and F.3.13 through each of
   its forms; F.5.1 in slot 3 of 8 through the multi-key serve
   seam, and F.2.2, F.2.4 and F.2.6 (CBC decrypt) in slot 3 of 8 through the
   multi-key CBC seam (``cbc_mk``);
4. the CTR main path: ``bench.run`` at 256 MiB, iters 5, reps 3; the digest
   must be 0xa612a647, the reference's digest for this chain, and every
   ``ctr_gen`` launch in the group form; then at 1 GiB (BASELINE.json's
   buffer, the root ``bench.py``'s other defaults), whose digest must be
   0x3fee5832, the reference's (docs/PERF.md:22), counted the same way;
5. the block-mode path at 256 MiB: ECB encrypt and decrypt (round trip, each
   kernel equal to its plain version), the parallel CBC and CFB128 decrypts
   (equal to their plain versions), the sequential CBC and CFB128 encrypts of
   the first 4,096 recovered blocks (they give back the input), and
   ``cbc_encrypt_words_batch`` with 4,096 streams of 64 blocks: each of
   these three exactly one ``seq_encrypt`` launch and no other; and
   byte-granular CFB128 through ``AES`` in chunks carried across calls from
   iv_off 5, both directions, equal to the CPU's, with one block-form ECB
   launch for each partial step that needs a keystream block;
6. the hex CLI on the card decrypts the F.1.2 vector;
7. the ceiling probe: ``harness.ceiling.main`` in this process (counted:
   ``chain`` launched, nothing else), then ``python -m
   our_tree_tpu_torch.harness.ceiling`` at its defaults, whose JSON line
   (the reference's keys) is printed; then each regime's kernel alone at
   64 MiB (CUDA events over at least a second of launches, the SM clock,
   power and temperature sampled by ``nvidia-smi`` meanwhile) and its SASS
   per element: each compute regime must hold about chain x ilp LOP3s per
   element, and ``compute-ilp8`` must reach 10 % of the table's integer
   rate. Printed: the measured integer instruction rate as results per
   clock per SM at the sampled and at the maximum clock beside the table's
   64, the streaming rate beside 3.35 TB/s, the logical-op rate by the
   reference's count, and the ``ctr_mk`` ceiling these imply;
8. the serve path: ``serve.bench`` drive A (``--requests 500
   --mixed-sizes``: 16 B-64 KiB, 4 tenants x 2 keys, ladder 32-4,096 blocks,
   one lane) and drive B (``--requests 300 --tenant-heavy --min-coalesce
   0.5``: 24 tenants, 16 B-1 KiB, so 32-block groups straddle slots); each
   with 0 lost, failed and mismatching, 0 kernel-library builds after
   warmup, the CUDA engine, ``ctr_mk`` launches equal to its engine calls
   and no other kernel launched, its launches by form (every rung's auto
   form, and no other, served); latency, goodput, the stage split and the
   first traffic dispatch beside the p50; then drive A's mix once more in a
   fresh process (``python -m our_tree_tpu_torch.serve.bench``), where
   warmup meets the card first: warmup must count the library load and the
   kernel's first launch, traffic none; then drive D, the mixed-mode drive
   (``--requests 300 --concurrency 16 --modes ctr,gcm,gcm-open,cbc --sizes
   16,64,256,1024,4096,16384``): 0 lost, failed and mismatching probes of
   any mode (a ``gcm`` probe pins its tag against the host GCM), 0
   ``auth-failed``, 0 builds after warmup, ``cbc_mk`` launches equal to the
   ``cbc`` engine calls (the warmed rungs plus one per ``cbc`` batch), one
   ``ghash_at`` call for each ``gcm`` and ``gcm-open`` engine call (likewise
   the warmed rungs plus one a batch), ``ctr_mk`` launches equal to the
   ``ctr``, ``gcm`` and ``gcm-open`` engine calls, no other kernel, per-mode
   p50/p99, dispatches and card time a dispatch printed; D in a fresh
   process, whose warmup must count two more first launches than A's
   (``cbc_mk<10>``, ``ghash_at``) and whose traffic counts none; and the
   auth-failure rehearsal (``OT_FAULTS=tag_mismatch:1``, ``--requests 100
   --modes gcm,gcm-open --sizes 256,1024``, counted): exactly one
   ``auth-failed`` answer, a ``gcm-open`` one, rc 0, 0 lost;
9. the card's dependent-issue latency (the 65,536-step chain over one
   word, cycles per dependent LOP3 at the sampled clock); per kernel at its
   path's shape (256 MiB; ``ctr_mk`` at the 4,096-block rung in each form,
   and at 256 MiB with K = 8 in each form and with its K = 1 entry;
   ``seq_encrypt`` as the batch of 4,096 streams x 64 blocks, as the two
   single-stream encrypts of 4,096 blocks and as the sweep's cbc-batch
   launch of 32 x 65,536 blocks, each in turns against its parent kernel
   (``SEQ_PARENT_SOURCE``, built beside the kernels: the new kernel must be
   faster in every turn at one stream and no slower in the median of turns
   at the other two), with its bound restated for the form that runs (the
   larger of the block's dependent path, counted from the circuits at the
   measured integer and shuffle latencies, and the issue floor of the warps
   each sub-partition holds, by pipe from the SASS; the former SASS-depth
   bound beside it), and every form at 1 to 16,384 streams (the auto form's
   crossings); the one-block ECB launch;
   ``chain`` in each regime at 64 MiB): time per launch (CUDA events, the SM
   clock sampled), the plain version's time, the least time the card could
   take at the table's rates (the bytes the function moves over the HBM rate
   or the operations it needs over 64 results per clock per SM, the larger)
   at the maximum and at the sampled clock, and at the probe's measured
   rates; for the latency-bound launches (the sequential encrypts, the
   rungs, one block) also the latency bound, the dependent path of a
   thread's circuit counted in its SASS times the measured latency; the
   kernel's own SASS instruction count beside the operations (for
   ``ctr_mk`` an upper bound), for both ECB kernels also their round loop's
   (integer instructions, opcode histogram, dependency depth), and the
   forward kernels' counts beside their counts from before the decrypt
   kernel's redesign (``FORWARD_SASS``), which it must leave as they were;
   both ``ctr_mk`` forms at 32 to 2^24 blocks, one slot and a random slot
   per block (the auto form's threshold table); a shared-memory load's
   latency by a dependent-load chase, a shuffle's latency by a
   dependent-shuffle chase, and the shared-memory issue rate of 1,
   2 and 4 warps of an SM (``CHASE_SOURCE``, built beside the kernels), and
   ``arc4_prga`` at its timing shapes (32 x 2^20 bytes, the rc4-batch rows'
   launch; 1 x 2^20; 4,096 x 2^16): time, plain time, the table and
   measured-rate bounds, and the latency bound, the larger of the issue
   bound of the kernel's word-per-byte layout (five shared-memory accesses
   a byte at the measured rate for the warps each SM holds) and one
   dependent integer step a byte (a share above 100 % fails the phase);
   beside it, as diagnostics, the step's recurrence as written (two
   dependent LDS and two dependent integer steps a byte) and the compiled
   main loop's longest path;
   ``cbc_mk`` at the 4,096-block rung with K = 8 (card time in a CUDA graph)
   and at 256 MiB with K = 8 in runs of 1-300: time, plain time, the
   measured-rate bound, the latency bound (the inverse round circuit's own
   dependent steps, the inverse S-box circuit's depth read from
   ``aes_inv_bitslice.cuh`` plus the linear layers', at the measured
   cycles a dependent step; the compiled path beside it as a diagnostic),
   share and SASS a block; where a launch's time goes, at the 4,096- and
   32-block rungs: the launch floor (``EMPTY_SOURCE``, an empty kernel at
   the launch's grid and shared memory, built beside the kernels), the
   stamped instantiation's phases per warp (prologue, loads, rounds,
   store; median and largest) and their sum beside the card time, and the
   issue diagnostic (integer SASS a block at one a cycle) beside the
   integer pipe's rate for one warp (its integer-pipe SASS at 2 cycles
   each, IMAD on the FMA pipe beside them); the one-block
   ECB encrypt launch in each form; both encrypt forms from 1 to 2^20
   blocks (the crossing, ``kEcbBlockFormMax``), and ``ctr_gen``'s one-block
   tail launch (``crypt_ctr`` ending mid-block) in each form, its block
   form's SASS, ``crypt_ctr`` in chunks ending mid-block, counted (block-form
   launches only, equal to the CPU's), both ``ctr_gen`` forms from 1 to 2^20 blocks (the crossing,
   ``kCtrGenBlockFormMax``) and ``ctr_gen`` at 256 MiB beside its time
   before the block form (``CTR_GEN_256MIB_MS``); and the block form beside
   ``ecb_decrypt_kernel`` (32 blocks a thread) from 4,096 blocks to 2^24,
   where a group form would pay; ``ctr_mk``'s group form at the seal's
   launch (2^24 + 1 blocks, K = 1, all-zero slots), the K = 1 entry (2^24
   blocks) and 256 MiB at K = 8 in runs of 1-300: each equal to the plain
   version, its card time in CUDA graphs against its bound. The finished
   redesigns' comparisons (the design variants of ``cbc_mk`` and the ECB
   block form, ``ctr_mk``'s parent kernel and design steps, PRs 11 and 14)
   are findings in PERF.md and are no longer built or timed here;
10. the sweep harness, ``python -m our_tree_tpu_torch.harness.bench`` in
   processes of its own with ``OT_ARC4_PREP=native``: ``--timing device
   --iters 5 --keybits 128`` over ecb, ecb-dec, ctr, cbc-dec and rc4 at 1,
   16 and 256 MiB; cbc and cfb128 at 64 KiB; cbc-batch and rc4-batch with 32
   streams at 32 MiB; ecb, ctr and rc4 at 16 and 256 MiB with ``--timing
   e2e`` (staging included); the same three on ``--backend c``; rc4 at 1 MiB with
   ``OT_ARC4_PREP=device``; gated on every self-test, parity and XOR line,
   no ``# degraded:`` line, each unit's kernel launched (the harness's
   ``# launches:`` lines); a two-rank gloo world sharing the card (``python
   -m torch.distributed.run --nproc-per-node 2 -m
   our_tree_tpu_torch.harness.bench --dist-backend gloo --workers 1,2
   --sizes-mb 1,16 --modes ecb,ecb-dec,ctr,cbc-dec,cbc-batch,rc4-batch``),
   whose shard-invariance lines must pass and whose every unit must launch
   its kernel on both ranks; and ``--workers 2`` without a world refused,
   naming that launch; each row's GB/s is printed beside the CTR chain's;
11. AES-GCM: ``ghash_scan`` against ``ghash_scan_plain`` (zero mismatching
   words) at N in {1, 2, 31, 33, 4096} rows with K 1/8/64 and at 65,537
   with K = 8 (random slots, keep, y0 and inject, and x ^ inject given
   without it), ``ghash_at`` at random named rows of the same inputs against
   the plain rows and ``ghash_scan``'s (and ``ghash_at_plain`` itself at
   4,096 rows), and through the seam ``gcm_crypt_ghash_words`` (CUDA
   engine against the plain engine on the card, ``out`` and every row of
   ``ys``, and with ``rows`` each request's last row) at every serve rung
   with K = 8 in the batcher's layout, sealing and opening, AES-128/192/256;
   the SP 800-38D KATs (``tests/golden/gcm_kats.json``) through
   ``gcm_seal``/``gcm_open`` on the card, each tampered tag refused, and a
   7-byte IV against the host GCM; then the main path, counted:
   ``gcm_seal`` and ``gcm_open`` over 256 MiB (``default_rng(1337)``, key
   ``bytes(range(16))``, a 96-bit IV, 20 bytes of AAD) and over 256 MiB + 5
   bytes, each one ``ctr_mk`` and one ``ghash_at`` call and nothing else,
   open giving the plaintext back, the ciphertext equal to the CTR seam's
   under the inc32 counters, the tag equal to an independent formulation on
   the card (chunked matrix powers in float32 matmuls, ``ghash_by_powers``);
   the every-row seam's GHASH rows at every 32,768th block against the same
   formulation, and its launches counted (one ``ctr_mk``, one
   ``ghash_scan``); times: ``ghash_at`` and ``ghash_scan`` at 2^24 + 1 rows
   (K = 1) and at the 4,096 rung with K = 8 (CUDA events and a CUDA graph),
   the plain versions (at the seal's shape ``ghash_by_powers``), the seal's
   ``ctr_mk`` launch alone on the seal's arrays and its share of the
   dispatch; the GCM serve dispatch at each rung of the ladder (32 to 4,096
   blocks) with K = 8 in the batcher's layout (``serve.batcher`` and
   ``serve.keycache``), its tags and ciphertexts against the host GCM and
   ``ghash_at`` against its plain rows, then ``ctr_mk``, ``ghash_at`` and
   ``ghash_scan`` each in a CUDA graph in 12 alternating turns (``ctr_mk``
   beside its launch floor), and the dispatch through the seam; the SASS
   of a product (both pipes); bounds for the work itself (a
   row's bytes at phase 7's stream rate, one 128 x 128 GF(2) product a row
   at the int8 tensor-core rate) and the latency bound (the dependent
   path's products at the product's SASS depth); and the seal's dispatch on
   the card in GB/s;
12. chunked transfers and the wire worker, the JAX package's transfer
   drive size (docs/SERVING.md, STREAM_r01): (a) a ``Server`` in this
   process (modes ``ctr,cbc``, the default ladder, 128- and 256-bit keys
   warmed, transfers on with an in-memory ledger), counted: a 64 MiB
   AES-128 CTR payload (``default_rng(1337)``, key ``bytes(range(16))``,
   nonce f0..ff) through ``Server.submit``, 1,024 chunks, equal to
   ``AES.crypt_ctr`` on the card (``ctr_gen``, an independent kernel), with
   ``ctr_mk`` launches equal to its engine calls, every one in the block
   form, and no other kernel; a 16 MiB AES-256 CBC decrypt, 256 chunks,
   equal to ``AES``'s parallel CBC decrypt on the card, with ``cbc_mk``
   launches equal to its engine calls and no other kernel; an oversized
   ``gcm`` submit answering ``transfer-unsupported``; 0 lost, 0 builds after
   warmup; each transfer's wall, GB/s, chunks and dispatches a second;
   (b) ``python -m our_tree_tpu_torch.serve.worker --device cuda --modes
   ctr,cbc,gcm,gcm-open --port 0 --status-port 0`` with ``OT_TRACE_DIR`` in
   a temporary directory and ``OT_INCIDENT_AUTH_SPIKE=1``, over the wire:
   one request of each mode at 16, 1,024 and 16,384 bytes against the plain
   versions on the CPU (every ``gcm`` tag against the host GCM), their
   latencies printed; a 4 MiB ``ctr`` frame (transferred transparently) and
   a 64 MiB ``tx`` transfer against ``AES.crypt_ctr`` on the card; the
   resume drill on a second worker (``OT_FAULTS=transfer_abort:1@chunk=1023``,
   ``--transfer-window 1``): the typed abort carries the token, the resume's
   begin-ack lists chunks 0-1022, exactly one chunk is sent again, and the
   splice is byte-identical; a tampered ``gcm-open`` answering
   ``auth-failed`` with no plaintext, after which ``/incidentz`` lists
   exactly one ``auth-spike`` bundle that validates; ``/metrics`` parsing
   as Prometheus text with ``serve_transfer_`` counters and
   ``serve_auth_failed``; ``/healthz`` with 0 steady builds and a
   ``transfers`` section; SIGTERM, and each worker's EXIT line with ``lost:
   0`` and rc 0;
13. the rc4 sessions: (a) the JAX package's session acceptance drive
   (``docs/SERVING.md``, ``SESSION_r01.json``) in a child process with
   ``OT_FAULTS=lane_hang:1 OT_DISPATCH_DEADLINE=2``: ``--requests 200
   --concurrency 16 --modes ctr,gcm,rc4 --sizes 16,64,256,1024,4096,16384
   --lanes 2 --sessions 32 --session-chunks 8 --min-session-hit-rate 0.9
   --min-session-replays 1`` at the JAX server's session defaults; gated: rc
   0, 0 lost, failed or mismatching, every one of the 256 chunks equal to the
   host PRGA, 0 steady builds, exactly one quarantine (the watchdog's), at
   least one replay, hit rate >= 0.9, ``arc4_prga`` launches equal to the
   ``rc4-prep`` engine calls (two warmups and the prefetch dispatches; the
   hung call never reaches its kernel), ``ctr_mk`` launches equal to the
   ``ctr`` and ``gcm`` engine calls, ``ghash_at`` calls to the ``gcm`` ones,
   and no kernel but these and the XOR's torch elementwise kernel; printed:
   the p50s by mode, the prefetch dispatches, the card time of an
   ``rc4-prep`` and of an ``rc4`` dispatch; (b) ``arc4_prga`` at the refill's
   launch shapes (8 x 4,096 bytes, the served one, and 2 x 2,048), against
   ``prga_plain`` and the host PRGA, timed in a CUDA graph (and the whole
   refill, ``prep_batch_words``), beside its bounds and its latency bound
   (phase 9's, a share above 100 % fails the phase);
   (c) the journal round trip in this process, counted (``--lanes 2
   --retries 1 --journal J``): ``OT_FAULTS=lane_fail:2@lane=1`` quarantines
   lane 1 and writes one failure row, a second run starts lane 1 quarantined
   (``journal:1``), ``--unquarantine lane:1`` clears the row, a third run
   starts both lanes healthy; (d) ``python -m our_tree_tpu_torch.serve.worker
   --modes ctr,rc4``: two sessions' ``open``, four ``data`` each and
   ``close`` over loopback, every chunk equal to the host PRGA, a ``data``
   on a closed session answering ``bad-request``, ``/healthz`` with its
   ``sessions`` section, EXIT ``lost: 0`` and rc 0;
15. engine selection and the port's entry (``selection_phase``; it runs
   before 14): (a) ``entry()`` on the card, ``fn(*args)`` equal to the plain
   version and to the native C CTR on the same bytes, exactly one
   ``ctr_gen`` launch; (b) ``python -m our_tree_tpu_torch.bench`` in a child
   with ``OT_BENCH_ENGINE=probe`` and its own ``OT_ENGINE_RANKING``: digest
   0xa612a647 on ``cuda``, the file holding ``cuda`` and ``ttable`` under
   ``cuda:<card name>``, ``cuda`` first, at 256 MiB; a second child on
   ``auto`` reporting ``engine=cuda``; in this process, ``cuda`` dropped in a
   temporary ranking, ``resolve_engine("auto", "cuda")`` raising; (c) each
   child with a marker path of its own (this process holds none), leaving
   no marker behind; a child with ``OT_FAULTS=lock_busy`` exiting non-zero,
   naming the holder, printing no line; (d) the device key schedules of
   1,000 random keys of each size equal to the host ones; (e) drive A's mix
   and drive D's mix with ``--engine native``, counted: 0 lost, failed or
   mismatching, no ``ctr_mk`` launch for ``ctr``, ``ctr_mk`` and
   ``ghash_at`` launches equal to the GCM engine calls, ``cbc_mk`` launches
   to the ``cbc`` calls; p50 and goodput with the host CPU's model; a
   worker with ``--engine native --native-threads 4``, one exchange in each
   mode against the plain versions; (f) ``ot_bench --backend=c`` rows, then
   ``--backend=gpu`` through the embedded interpreter, whose lines equal a
   direct ``python -m our_tree_tpu_torch.harness.bench`` run on the same
   arguments (without ``python3-config`` a line says so and the ``c`` rows
   still run);
16. the rest of observability (``observability_phase``; it runs after 15
   and before 14): (a) drive D's mix in this process with ``OT_TRACE_DIR``
   set, ``OT_TRACE_MAX_MB`` sized from drive D's requests and batches so
   that the trace rotates and keeps every segment (the snapshot stream
   rotates too: the poller flushes it every 20 ms until it has), a pulse
   tick every 0.5 s and ``--status-port``, whose ``/alertz`` (200, no row)
   and ``/healthz`` (with ``capacity``) a thread polls during the drive;
   gated as drive D and with 0 alerts; (b) ``python -m
   our_tree_tpu_torch.obs.report <run> --check --trace-json`` rc 0 with
   Chrome JSON that loads, every ``lane-dispatch`` span closed, ``python -m
   our_tree_tpu_torch.obs.pulse <run> --check`` rc 0; (c) the alert drill
   in a child (``DRILL_ENV``: ``OT_FAULTS=dispatch_slow OT_SLOW_S=0.4``, a
   tick every 50 ms over 1 s and 2 s windows; ``DRILL_DRIVE``: a ``ctr``
   server with one lane, 32-64 blocks, a 0.2 s watchdog, 60 requests one
   at a time, ``--slo`` drive A's line): ``burn_rate`` fired,
   ``pulse_alerts{rule=burn_rate,severity=page}`` >= 1, exactly one
   incident bundle that validates, ``obs.report --incidents --check`` rc 0,
   0 lost, exit 1 from the SLO gate alone; (d) the SLO gate green (phase
   8's fresh drive A runs with ``--slo`` drive A's line at
   ``SLO_CARD_TOLERANCE`` and exits 0) and red (``slo.gate`` of the drill
   against drive A: 1, naming ``alerts_total``), ``obs.history --check``
   over drive A, the fresh drive A, the drill's healthy twin (its flags,
   no fault) and the drill: red on the drill alone, naming
   ``errors_total``; (e) drive A's mix with ``OT_PULSE=0`` and ``1`` (a
   tick every 50 ms) in turns, twice each, p50 and goodput side by side,
   a tick's cost at the end-of-drive registry, and the fresh drive A's
   ``# compile:`` line: its 2 warmup builds (the library load, the first
   ``ctr_mk<10>`` launch) at the canary rung, 0 steady. A ``{"pulse":
   ...}`` line before the ``kernels`` line carries the phase's figures;
17. the routing tier (``route_phase``; after 16, before 14): five
   ``route.bench`` drives in child processes (``ROUTE_DRIVES``), each
   spawning port workers with ``--device cuda``: (a) the acceptance drive,
   3 workers, 1,500 requests at 250 a second, mixed sizes, 12 tenants, with
   the affinity A/B (affinity's keycache hit ratio above random routing's),
   also the fleet-causal drive (``OT_TRACE_SAMPLE=0.25``, ``--status-port
   0``, waterfalls complete on 0.99 of the sampled requests and within 5 %
   on 0.95, then ``obs.report --min-join-frac 0.9`` over its trace rc 0);
   (b) the backend kill (``OT_FAULTS=backend_hang:1@backend=1``: exactly one
   quarantine and one release, a redispatch, zero errors); (c) ``ctr``,
   ``gcm``, ``gcm-open`` and ``cbc`` through the router, every mode's probes
   verified (each ``gcm`` tag against the host GCM); (d) the elasticity
   drive (a scale-up and a scale-down, one roll through the canary
   handoff, a router replica killed, a stale pooled socket redispatched,
   zero errors, no alert); (e) the mid-transfer kill drive (STREAM_r01's
   cookbook flags: 64 MiB transfers riding mixed traffic, a worker
   SIGKILLed at +2 s, a hung lane, a lost chunk result, the resume drill;
   zero errors and lost, bit-exact, a chunk redispatched, one quarantine,
   the drill byte-identical). Each drive: rc 0, 0 lost at the router and in
   every worker's EXIT line (a SIGKILLed worker has none and is skipped,
   said so), 0 builds after warmup, in every worker ``ctr_mk`` launches
   equal to its ``ctr``, ``gcm`` and ``gcm-open`` engine calls, ``ghash_at``
   calls to its ``gcm`` and ``gcm-open`` ones and ``cbc_mk`` launches to its
   ``cbc`` ones (the EXIT line's diagnostic keys, printed a worker) and no
   other kernel, and no CUDA context in the router's process; the
   per-backend dispatch table, the workers' times to READY, p50/p99,
   goodput and the stage p50s of the complete waterfalls (the router's
   stages and the worker's own) are printed; a failed drive's record (its
   given-up requests with every attempt, the client's failovers, each
   router's outcomes by back end, the fleet events around it) is logged
   before its artifact is removed. The ``kernels`` line's ``ctr_mk``,
   ``ghash_at`` and ``cbc_mk`` gain ``route`` (their launches by drive).
   ``python3 chip_smoke.py --route-only d 5`` builds the kernels and runs
   drive (d) alone five times in a row (any drives, comma separated);
18. multi-device (``multidevice_phase``; after 17, before 14), in child
   processes so that no process group outlives its step: (a) a world of one
   on NCCL (``dryrun_multichip(1)`` in a world of its own, then one joined
   through ``multihost.initialize``) and (b) worlds of 2 and 4 gloo ranks
   (``python -m torch.distributed.run``), every rank launching its kernels
   on this card, each running ``dryrun_multichip`` at its tiny shapes and
   then the full-width steps: CTR over the 256 MiB headline buffer (the
   bench's key, nonce and data), ECB, CBC and CFB128 decrypts over it, the
   CBC batch of 4,096 streams x 64 blocks, ARC4 over rc4-batch's 32 x 2^20
   bytes and the all-to-all over 64 MiB; each step's gathered output equal
   to the unsharded call on the card, byte for byte, and each rank one
   launch of the step's kernel (``ctr_gen``, ``ecb_decrypt``,
   ``ecb_encrypt``, ``seq_encrypt``, ``arc4_prga``) and no other. Printed:
   each step's wall and the collectives' share, each rank's launches, the
   sharded CTR's GB/s beside phase 4's headline. The ``kernels`` line's
   ``ctr_gen``, ``ecb_encrypt``, ``ecb_decrypt``, ``seq_encrypt`` and
   ``arc4_prga`` gain ``sharded`` (their launches over every world and
   rank) and ``sharded_by_world``. No run spans two cards: the machine
   has one, and NCCL takes no two ranks on one device;
14. drive C, drive A's mix at 10,000 requests with ``--profile-window 1:2``
   and ``--ceiling-gbps`` at the probe's ``ctr_mk`` ceiling, gated as A,
   with a ``torch``-tier profile section that validates, cross-check rows
   equal to the window's dispatches, a cost row per warmed rung and
   ``ctr_mk`` kernels in the exported trace, whose kernel time over the
   window is the card's busy share under the profiler, and ``python -m
   our_tree_tpu_torch.obs.report <run> --profile --check`` reads the capture
   back (rc 0: the summary joined with the cost records, every slowest
   exemplar a whole span chain). It comes last, so that the profiler
   touches none of the timings before it.

Phases 4, 5, 7, each drive of 8 (D and the rehearsal included), the seal
and the open of 11, each transfer of 12 (a), each run of 13 (c), 15 (a)
and each native drive of 15 (e), and 14 run with every launch count set to
0 just before and read just after (13
(a) reads the child's own count, the bench's ``launches`` section), and each run of phase 10 counts its own
launches by unit: each path must have launched each of its kernels.
A ``{"phase_wall_s": {...}, "total_s": ...}`` line before the ``kernels``
line gives each phase's wall seconds (``start-up`` is the time before
phase 1). Standard output ends with the ``kernels`` JSON line (``ctr_gen``,
``ecb_encrypt`` with its one-block launch, ``ecb_decrypt``, ``seq_encrypt``
with its ``single_stream`` encrypts, its ``turns`` against the parent
kernel, its ``forms_table`` and ``launches_by_form``,
``ctr_mk`` with its ``k1_entry``, its ``seal_shape``, its
``group_form_study`` and its ``block_form``, ``cbc_mk`` with its
256 MiB row and the group-form table, ``chain``,
``arc4_prga`` with its ``single`` and ``wide`` shapes, the harness rows and
its ``session`` (the drive's launches, engine calls and card times, and the
refill's launch shapes under ``prefetch_shapes``),
``ghash_scan`` at the 4,096 rung with K = 8 with its ``seal_rows``, ``ghash_at`` at the seal's shape with its ``rung``,
``seal_256MiB`` and ``gcm_serve``: the per-rung GCM dispatch table and the
GCM launches of drive D and the rehearsal; ``ctr_mk`` and ``cbc_mk`` each
with the ``transfer`` of phase 12 (a): chunks, launches, wall, GB/s, and
under ``ctr_mk`` the worker's figures), the
``nvidia-smi`` name/power-limit line and ``{"ok": true, "device": {...}}``;
``ecb_encrypt`` carries its launches by form, the one-block launch by form
and its block form (``ecb_encrypt_block_kernel``, with the crossing table),
``cbc_mk`` its breakdown and 32-block rung, ``ctr_gen`` its one-block tail
by form, its launches by form and its block form (``ctr_gen_block_kernel``,
with the crossing table); ``ctr_gen`` also carries phase 15's ``selection``
(``entry()``'s launches, the probe's GB/s by engine), and ``ctr_mk``,
``ghash_at`` and ``cbc_mk`` the native drives' launches under theirs.
Without a card,
or without the rest of the repo beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import atexit
import contextlib
import datetime
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_BYTES = 256 << 20
#: The ceiling probe's buffer, its default (``OT_VPU_BYTES``): above the 50 MB L2.
PROBE_BYTES = 64 << 20
#: Least seconds of back-to-back launches per timed kernel, so that the clock
#: sampler (every 100 ms) sees it.
SAMPLED_S = 1.0
#: Drive A's mix, profiled: enough requests that the drive outlasts its
#: window (1 s in, 2 s long) with the profiler running.
PROFILED_REQUESTS = 10000
MAIN_DIGEST = 0xA612A647
#: The main path at BASELINE.json's 1 GiB buffer and the reference's digest
#: of its chain there (docs/PERF.md:22).
GIB_BYTES = 1 << 30
GIB_DIGEST = 0x3FEE5832
#: Phase 18: the gloo worlds (every rank on this card; the world of one runs
#: on NCCL), each world's time limit, and the full-width steps' shapes: phase
#: 5's CBC batch, rc4-batch's streams and bytes, the all-to-all's bytes.
GLOO_WORLDS = (2, 4)
MULTI_TIMEOUT = 300
BATCH_STREAMS, BATCH_BLOCKS = 4096, 64
ARC4_BATCH = (32, 1 << 20)
A2A_BYTES = 64 << 20
#: The kernel each full-width step launches once a rank (None: no kernel).
MULTI_STEP_KERNEL = {"ctr": "ctr_gen", "ecb-dec": "ecb_decrypt", "cbc-dec": "ecb_decrypt",
                     "cfb128-dec": "ecb_encrypt", "cbc-batch": "seq_encrypt",
                     "arc4-batch": "arc4_prga", "all-to-all": None}
MULTI_KERNELS = ("ctr_gen", "ecb_encrypt", "ecb_decrypt", "seq_encrypt", "arc4_prga")
#: Phase 10's modes under two ranks.
MULTI_SWEEP_MODES = "ecb,ecb-dec,ctr,cbc-dec,cbc-batch,rc4-batch"
#: H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer add/logic/shift results per clock per SM on compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction table).
INT_OPS_PER_CLK_PER_SM = 64
#: Two-input gates of the Boyar-Peralta forward S-box (32 AND, 83 XOR).
BP_SBOX_GATES = 115
#: XORs of one column's MixColumns, the fewest known (Maximov, "AES
#: MixColumn with 92 XOR gates", IACR ePrint 2019/833).
MIXCOLUMN_XORS = 92
#: The forward kernels' integer SASS at nr 10 as compiled before the decrypt
#: kernel's redesign (per group of 32 blocks, or per block for the one-block
#: forms), printed beside this build's: a decrypt-only change leaves them.
FORWARD_SASS = {"ctr_gen": 21432, "ecb_encrypt": 22324, "ctr_mk_block": 2575, "seq_encrypt": 2637}
#: The dependent steps of the per-block inverse round's linear layers as
#: csrc/aes_block_inv.cuh writes them, a step one funnel shift or one
#: function of at most three registers (a LOP3, constant masks as
#: immediates): InvShiftRows 3 (the rotates; two selects of disjoint rows;
#: one more), the pre-transform a ^= 4(a ^ a_(r+2)) 4 (the shifts; a XORed
#: with the select; 4(.) renamed, up to four inputs: two), MixColumns with
#: AddRoundKey 5 (the shifts; t; the shifts of t; the select; the last XOR,
#: the other terms joined meanwhile). The last round has InvShiftRows and
#: AddRoundKey (1); the whitening key is 1 more. The inverse S-box's depth is
#: read from its generated program (``inv_sbox_depth``).
INV_ROUND_LINEAR_STEPS = {"inv_shift_rows": 3, "inv_mixcolumns_pretransform": 4,
                          "mixcolumns_addroundkey": 5}
INV_LAST_ROUND_LINEAR_STEPS = {"inv_shift_rows": 3, "addroundkey": 1}
#: Drive D, the mixed-mode serve drive: the JAX package's documented
#: ``--modes ctr,gcm,gcm-open,cbc`` drive (docs/SERVING.md).
DRIVE_D = ["--requests", "300", "--concurrency", "16", "--modes", "ctr,gcm,gcm-open,cbc",
           "--sizes", "16,64,256,1024,4096,16384"]
#: The auth-failure rehearsal (docs/SERVING.md), run with
#: ``OT_FAULTS=tag_mismatch:1``: exactly one request answers ``auth-failed``.
DRIVE_AUTH = ["--requests", "100", "--modes", "gcm,gcm-open", "--sizes", "256,1024"]
#: The GCM modes and the kernels each mode's engine call launches.
GCM_SERVE_MODES = ("gcm", "gcm-open")
BLOCK_IV = "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"
#: Phase 11 (AES-GCM): the GHASH scan's random cases, and the 256 MiB seal's
#: key, 96-bit IV and 20 bytes of AAD.
GHASH_SIZES = (1, 2, 31, 33, 4096, 65537)
#: One 128 x 128 GF(2) product as a matrix product: 16,384 multiplies and
#: 16,384 adds, the least work of a GHASH row whatever its formulation; and
#: the card's fastest rate for such operations, the int8 tensor cores
#: (NVIDIA H100 SXM data sheet, dense).
GF_PRODUCT_INT8_OPS = 2 * 128 * 128
INT8_OPS_PER_S = 1.979e15
GCM_KEY = bytes(range(16))
GCM_IV = bytes.fromhex("cafebabefacedbaddecaf888")
GCM_AAD = bytes(range(20))
SEQ_BLOCKS = 4096
#: Phase 2's ARC4 cases: streams x bytes, every pair. The plain version runs
#: once a length, on ARC4_PLAIN_STREAMS streams; a launch on S streams is
#: held against its first S rows (the streams are independent). 2^20 bytes
#: is the harness's length (rc4-batch: 32 streams; rc4 with the keystream on
#: the card: one), 2^16 that of the wide timing shape. The longest plain run
#: is 2^17 bytes a stream: the plain version's per-byte loop takes about 15 s
#: a kind there, and the sweep's length is held through a resume.
ARC4_STREAMS = (1, 7, 32, 33, 4096)
ARC4_LENGTHS = (1, 255, 4096, 1 << 16, 1 << 17)
ARC4_PLAIN_STREAMS = max(ARC4_STREAMS)
#: The sweep's length: launches on ARC4_LONG_STREAMS streams are held
#: against the plain run at the longest of ARC4_LENGTHS for its bytes, and
#: against a resume from there for the rest (the plain version's per-byte
#: loop takes about 100 s at this length).
ARC4_LONG = 1 << 20
ARC4_LONG_STREAMS = (1, 7, 32)
#: Phase 9's timing shapes, (streams, bytes): the rc4-batch rows' launch
#: (the head of the kernels entry), one stream, and 4,096 streams (one warp
#: on each of 128 SMs).
ARC4_TIMED = {"path": (32, 1 << 20), "single": (1, 1 << 20), "wide": (4096, 1 << 16)}
#: Integer operations of one PRGA step that the function needs: three adds
#: and three masks (x + 1, y + a, a + b, each & 255). Its five shared-memory
#: accesses are neither device-memory bytes nor table operations; the latency
#: bound counts them.
ARC4_OPS_PER_BYTE = 6
#: The latency bound of one stream, the larger of two figures. The issue
#: bound of the kernel's word-per-byte layout: each byte needs three loads
#: and two stores in shared memory (the state is indexed by data, so it
#: cannot live in registers), one warp-wide access each, at the SM's
#: measured rate for the warps it holds at the launch's shape
#: (``smem_issue``). It is this layout's floor, not the function's: a layout
#: of four bytes a word could load the consecutive m[x] four at a time. And
#: the one integer step that must wait for the byte before, y + a, at the
#: measured dependent-issue latency.
ARC4_ACCESSES_PER_BYTE = 5
ARC4_DEPENDENT_STEPS = 1
#: The step's dependent recurrence from one byte to the next as the step is
#: written (the next byte's load of m[x] after this byte's stores, which wait
#: on b): the load of a = m[x], the add y + a, one address step, the load of
#: b = m[y]. A diagnostic since the lookahead schedule (the kernel runs
#: under it), printed beside the bound.
ARC4_WRITTEN_STEP = {"lds": 2, "int": 2}
#: Warps of one SM the issue-rate probe runs (``smem_issue``).
SMEM_RATE_WARPS = (1, 2, 4)
#: The sweep harness's rows (phase 10): each mode's kernel, by mode.
HARNESS_KERNEL = {"ecb": "ecb_encrypt", "ecb-dec": "ecb_decrypt", "ctr": "ctr_gen",
                  "cbc-dec": "ecb_decrypt", "cbc": "seq_encrypt", "cfb128": "seq_encrypt",
                  "cbc-batch": "seq_encrypt", "rc4-batch": "arc4_prga"}
#: The dependent shared-memory load chase (phase 9): one thread walks a
#: cycle of shared-memory addresses, each load's address the previous load's
#: value, timed with the SM's cycle counter; and the shared-memory issue
#: rate (``smem_issue``: independent warp-wide accesses from 1 to 4 warps of
#: one SM), the rate of the ARC4 kernel's issue bound. Built with their own
#: nvcc beside the kernels' build; measurement probes, not kernels of the
#: port.
CHASE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void smem_chase(int steps, unsigned* out, long long* cycles) {
  __shared__ unsigned s[1024];
  const unsigned base = (unsigned)__cvta_generic_to_shared(s);
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = base + 4u * ((i * 97u + 1u) % 1024u);
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned j = base;
  const long long t0 = clock64();
#pragma unroll 32
  for (int k = 0; k < steps; ++k) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(j));
  const long long t1 = clock64();
  out[0] = j;
  cycles[0] = t1 - t0;
}

extern "C" int ot_smem_chase(int steps, void* out, void* cycles) {
  smem_chase<<<1, 32>>>(steps, static_cast<unsigned*>(out), static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}

// The shared-memory issue rate: each warp of one block runs independent
// warp-wide accesses in the ARC4 step's mix, three loads and two stores,
// every lane in its own bank, each store's value loaded 40 accesses before;
// its cycles are timed with the SM's cycle counter.
__global__ void smem_issue(int reps, unsigned* out, long long* cycles) {
  __shared__ unsigned s[4 * 64 * 32];
  volatile unsigned* p = s + (threadIdx.x >> 5) * 64 * 32 + (threadIdx.x & 31);
  for (int k = 0; k < 64; ++k) p[32 * k] = threadIdx.x + k;
  unsigned r[48];
#pragma unroll
  for (int k = 0; k < 48; ++k) r[k] = k;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      r[3 * g] = p[32 * (3 * g)];
      r[3 * g + 1] = p[32 * (3 * g + 1)];
      r[3 * g + 2] = p[32 * (3 * g + 2)];
      p[32 * (48 + (2 * g) % 16)] = r[3 * ((g + 8) % 16)];
      p[32 * (48 + (2 * g + 1) % 16)] = r[3 * ((g + 8) % 16) + 1];
    }
  }
  const long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < 48; ++k) acc ^= r[k];
  out[threadIdx.x] = acc;
  if ((threadIdx.x & 31) == 0) cycles[threadIdx.x >> 5] = t1 - t0;
}

extern "C" int ot_smem_issue(int reps, int warps, void* out, void* cycles) {
  if (warps < 1 || warps > 4) return (int)cudaErrorInvalidValue;
  smem_issue<<<1, 32 * warps>>>(reps, static_cast<unsigned*>(out),
                                static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}

// A shuffle's latency: one warp, each shuffle's value the one before it
// read from the next lane, timed with the SM's cycle counter.
__global__ void shfl_chase(int steps, unsigned* out, long long* cycles) {
  unsigned v = threadIdx.x * 0x9E3779B9u;
  const int src = (threadIdx.x + 1) & 31;
  const long long t0 = clock64();
#pragma unroll 32
  for (int k = 0; k < steps; ++k) v = __shfl_sync(0xFFFFFFFFu, v, src);
  const long long t1 = clock64();
  out[threadIdx.x] = v;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

extern "C" int ot_shfl_chase(int steps, void* out, void* cycles) {
  shfl_chase<<<1, 32>>>(steps, static_cast<unsigned*>(out), static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}
"""
#: ``seq_encrypt``'s lane forms by name: Q, the lanes a column (4Q lanes a
#: stream, ``csrc/aes_lanes.cuh``).
SEQ_LANES_Q = {"lanes4": 1, "lanes8": 2, "lanes16": 4}
#: Phase 9's ``seq_encrypt`` forms table: every form at these stream counts,
#: 64 blocks a stream (the auto form's crossings, ``csrc/seq_form.cuh``).
SEQ_FORM_STREAMS = (1, 32, 1024, 2048, 4096, 8192, 16384)
#: Phase 9's turns of ``seq_encrypt`` against its parent kernel: rounds of
#: parent, new, new, parent; each timing a CUDA graph of about SEQ_TURN_S.
SEQ_TURNS = 3
SEQ_TURN_S = 0.1
#: ``seq_encrypt``'s kernel before its lane forms, as it was (one thread a
#: stream, 32 a thread block, ``aes_block::chain_stream``), built with its own
#: nvcc beside the kernels only so that phase 9 can time the new kernel
#: against it in turns; a probe, not a kernel of the port.
SEQ_PARENT_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "aes_block.cuh"

namespace {

constexpr int kThreads = 32;

template <int NR, int CFB>
__global__ void __launch_bounds__(kThreads)
seq_parent_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  const uint4* __restrict__ iv, uint4* __restrict__ iv_out,
                  const uint32_t* __restrict__ rk, int s, long long n) {
  __shared__ uint32_t kp[8 * (NR + 1)];
  if (threadIdx.x <= NR) aes_block::round_key_planes(rk, threadIdx.x, kp + 8 * threadIdx.x);
  __syncthreads();
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= s) return;
  iv_out[j] = aes_block::chain_stream<NR, CFB>(in + j * n, out + j * n, n, iv[j], kp);
}

template <int NR, int CFB>
int launch(const void* in, void* out, const void* iv, void* iv_out, const void* rk, int s,
           long long n, cudaStream_t st) {
  seq_parent_kernel<NR, CFB><<<(s + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), static_cast<const uint4*>(iv),
      static_cast<uint4*>(iv_out), static_cast<const uint32_t*>(rk), s, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ot_seq_parent(const void* in, void* out, const void* iv, void* iv_out,
                             const void* rk, int s, long long n, int cfb, int nr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  switch (nr * 2 + cfb) {
    case 20: return launch<10, 0>(in, out, iv, iv_out, rk, s, n, st);
    case 21: return launch<10, 1>(in, out, iv, iv_out, rk, s, n, st);
    case 24: return launch<12, 0>(in, out, iv, iv_out, rk, s, n, st);
    case 25: return launch<12, 1>(in, out, iv, iv_out, rk, s, n, st);
    case 28: return launch<14, 0>(in, out, iv, iv_out, rk, s, n, st);
    case 29: return launch<14, 1>(in, out, iv, iv_out, rk, s, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
#: The launch floor (phase 9): a kernel that does nothing, with cbc_mk's
#: parameters, launched at a given grid, block and dynamic shared memory and
#: replayed in a CUDA graph as the kernels are timed. Built with its own nvcc
#: beside the kernels; a measurement probe, not a kernel of the port.
EMPTY_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void empty_kernel(const uint4*, uint4*, const uint4*, const int32_t*, const uint32_t*,
                             long long, int) {}

extern "C" int ot_empty(int grid, int threads, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  empty_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0);
  return (int)cudaGetLastError();
}
"""
#: Turns of a timing in turns (phase 11's GCM serve dispatch), the order
#: reversed every other turn: one launch's card time varies by a few percent
#: from one measurement to the next.
VARIANT_TURNS = 12
#: Phase 2's ECB block-form sizes (one block a thread): one block, ragged
#: warps, and a serve rung's worth.
ECB_BLOCK_SIZES = (1, 2, 31, 33, 4096)
#: Phase 9's ECB and ctr_gen crossing tables: both forms at each size.
ECB_FORM_SIZES = (1, 32, 1024, 1 << 14, 1 << 16, 1 << 18, 1 << 20)
#: Phase 2's ctr_gen block-form sizes (one block a thread), as ECB's.
CTR_BLOCK_SIZES = (1, 2, 31, 33, 4096)
#: Phase 9's crypt_ctr chunks: calls that end mid-block (a one-block tail
#: each), one that drains a partial block first, and a 33-byte one with a
#: whole block between.
CTR_TAIL_CHUNKS = (7, 16, 33, 5, 100)
#: ctr_gen's time at 256 MiB before its block form (PERF.md's kernel table,
#: NVIDIA H100 80GB HBM3, 700 W), printed beside this run's: the main path
#: keeps the group form.
CTR_GEN_256MIB_MS = 0.7052
#: Phase 5's byte-granular CFB128 run: chunks carried across calls from
#: iv_off 5, as the reference's aes_crypt_cfb128 resume and the hex CLI's
#: --iv-off give it; every step that needs a keystream block alone is one
#: block-form ECB launch (AES._ecb1).
CFB_IV_OFF = 5
CFB_CHUNKS = (1, 15, 16, 17, 40)
#: cbc_mk's card time at the 4,096-block rung, K = 8, in its former form
#: (PERF.md's kernel table), printed beside the breakdown.
CBC_MK_FORMER_US = 4.204
#: Phase 2's ECB sizes: ragged tails around one group and one thread block,
#: 16 MiB, and a 256 MiB launch whose last group holds 7 blocks.
ECB_SIZES = (1, 31, 33, 1000, 1 << 20, (1 << 24) + 7)
#: Phase 2 holds its largest shapes (2^20 blocks and up, seq_encrypt's 4,096
#: streams of 4,096 blocks) against the plain versions for this key size
#: only, and every key size at the smaller shapes: the time goes to the
#: routing tier's drives (phase 17).
LARGE_BITS = 128
SP800_PT = ("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
            "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
SP800_IV = "000102030405060708090a0b0c0d0e0f"
#: NIST SP800-38A F.1.1/3/5 and F.2.1/3/5: key, ECB ciphertext, CBC ciphertext.
SP800_ECB_CBC = {
    128: ("2b7e151628aed2a6abf7158809cf4f3c",
          "3ad77bb40d7a3660a89ecaf32466ef97f5d3d58503b9699de785895a96fdbaaf"
          "43b1cd7f598ece23881b00e3ed0306887b0c785e27e8ad3f8223207104725dd4",
          "7649abac8119b246cee98e9b12e9197d5086cb9b507219ee95db113a917678b2"
          "73bed6b8e3c1743b7116e69e222295163ff1caa1681fac09120eca307586e1a7"),
    192: ("8e73b0f7da0e6452c810f32b809079e562f8ead2522c6b7b",
          "bd334f1d6e45f25ff712a214571fa5cc974104846d0ad3ad7734ecb3ecee4eef"
          "ef7afd2270e2e60adce0ba2face6444e9a4b41ba738d6c72fb16691603c18e0e",
          "4f021db243bc633d7178183a9fa071e8b4d9ada9ad7dedf4e5e738763f69145a"
          "571b242012fb7ae07fa9baac3df102e008b0e27988598881d920a9e64f5615cd"),
    256: ("603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4",
          "f3eed1bdb5d2a03c064b5a7e3db181f8591ccb10d410ed26dc5ba74a31362870"
          "b6ed21b99ca6f4f9f153e7b1beafed1d23304b7a39f9f3ff067d8d8f9e24ecc7",
          "f58c4c04d6e5f1ba779eabfb5f7bfbd69cfc4e967edb808d679f777bc6702c7d"
          "39f23369a9d9bacfa530e26304231461b2eb05e2c39be9fcda6c19078c6a9d1b"),
}
#: NIST SP800-38A F.3.13, CFB128-AES128 encrypt.
SP800_CFB128 = ("3b3fd92eb72dad20333449f8e83cfb4ac8a64537a0b3a93fcde3cdad9f1ce58b"
                "26751f67a3cbb140b1808cf187a4f4dfc04b05357c5d1c0eeac4c66f9ff7f2e6")
WRAP_NONCES = [
    "000102030405060708090a0bfffffffb",   # 32-bit carry after 5 blocks
    "0001020304050607fffffffffffffff9",   # 64-bit carry after 7 blocks
    "fffffffffffffffffffffffffffffff0",   # 128-bit wrap after 16 blocks
    "ffffffffffffffffffffffffffffffff",   # 128-bit wrap after 1 block
    "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff",   # the bench nonce
]


#: The script's start: every log line leads with the seconds since it, so a
#: run's output is its own timeline against the time limit.
T_START = time.perf_counter()


def tests_module(name: str):
    """A helper module of ``tests/`` (not a package), loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(*a) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def run_group(argv: list, timeout: float, env=None):
    """Run ``argv`` in a session of its own (a launcher and the ranks it
    spawns), output captured; past ``timeout`` the whole session is killed.
    Returns (the completed process, wall seconds)."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\n[killed after {timeout} s]"
    return (subprocess.CompletedProcess(argv, proc.returncode, out, err),
            time.perf_counter() - t0)


def cfb_steps(iv_off: int, chunks) -> list:
    """The launches a chunked byte-granular CFB128 run makes, in order, as
    ``AES._cfb_impl`` walks it: ("partial", 1) for each step that starts at
    offset 0 with fewer than 16 bytes left in its call (one block through
    ``AES._ecb1``), ("bulk", n) for each run of n whole blocks."""
    n, steps = iv_off, []
    for size in chunks:
        pos = 0
        while pos < size:
            if n == 0 and size - pos >= 16:
                steps.append(("bulk", (size - pos) // 16))
                pos += (size - pos) // 16 * 16
                continue
            if n == 0:
                steps.append(("partial", 1))
            take = min(16 - n, size - pos)
            pos += take
            n = (n + take) & 15
    return steps


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def sass(so_path: str) -> str:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout


def ctr_ops_per_group(nr: int) -> tuple[float, dict]:
    """Integer operations AES-CTR needs for one group of 32 blocks in bit
    planes, counted from the function, not from the compiled kernel.

    Two-input gates: 16 nr S-boxes, nr - 1 MixColumns of four columns,
    nr + 1 AddRoundKeys of 128 XORs, the counter planes (a full adder of 5
    gates for each of bits 0..4 of the in-group index, whose carry differs by
    lane; above that one XOR and one AND per bit, as the group's high bits
    are the same for all 32 lanes), the keystream XORed into the data (128),
    and four 32x32 bit transposes as swap networks (5 stages of 16 pairs,
    each 4 logic gates and 2 shifts). A LOP3 evaluates any function of three
    inputs, so one instruction stands for at most two two-input gates; that
    fusion is credited in full (gates / 2). Shifts count one each. Moves,
    masks, address and loop arithmetic are not counted. The four NOTs of an
    S-box fold into neighbouring gates."""
    gates = {
        "sbox": 16 * nr * BP_SBOX_GATES,
        "mixcolumns": 4 * (nr - 1) * MIXCOLUMN_XORS,
        "addroundkey": 128 * (nr + 1),
        "counter": 5 * 5 + 2 * (128 - 5),
        "data_xor": 128,
        "transpose": 4 * 5 * 16 * 4,
    }
    shifts = 4 * 5 * 16 * 2
    return sum(gates.values()) / 2 + shifts, {**gates, "shifts": shifts}


def ecb_ops_per_group(nr: int, decrypt: bool) -> tuple[float, dict]:
    """Integer operations ECB needs for one group of 32 blocks in bit planes,
    by ``ctr_ops_per_group``'s rule (two-input gates / 2 for LOP3 fusion,
    shifts one each, NOTs folded, moves and address arithmetic not counted):
    16 nr S-boxes, nr - 1 MixColumns or InvMixColumns of four columns, nr + 1
    AddRoundKeys of 128 XORs and eight 32x32 transposes (four in, four out).

    Both directions count the same. Encrypt S-boxes are Boyar-Peralta's 115
    gates. The inverse S-box is credited with the same 115: A^-1 on either
    side of that core (linear) and the 0x05 constant (NOTs) fold into its
    top and bottom linear layers, as the decrypt kernel's dedicated circuit
    does (22 and 17 steps of 3-input XOR around the same 62-gate middle).
    InvMixColumns is credited with MixColumns' 92 XORs, a deliberately low
    figure: its matrix is the denser of the two, and the bound must not
    count work the function may not need. The kernel's own form (113 steps
    of 2- or 3-input XOR a column, the key included) is not counted."""
    gates = {
        "sbox": 16 * nr * BP_SBOX_GATES,
        "inv_mixcolumns" if decrypt else "mixcolumns": 4 * (nr - 1) * MIXCOLUMN_XORS,
        "addroundkey": 128 * (nr + 1),
        "transpose": 8 * 5 * 16 * 4,
    }
    shifts = 8 * 5 * 16 * 2
    return sum(gates.values()) / 2 + shifts, {**gates, "shifts": shifts}


_SASS_SKIP = ("NOP", "EXIT", "BRA", "BAR", "RET", "S2R", "S2UR", "CS2R", "BSSY", "BSYNC",
              "WARPSYNC", "DEPBAR")


def sass_function(text: str, kernel: str, targs) -> tuple[list, list]:
    """The instructions [(address, opcode base, text)] of ``kernel``<targs>
    (one int template argument, or a tuple of them) in the compiled SASS
    (``cuobjdump -sass``) and its backward branches [(target, address)], the
    loops."""
    targs = (targs,) if isinstance(targs, int) else tuple(targs)
    mangled = kernel + "I" + "".join(f"Li{a}E" for a in targs) + "E"
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs if f.startswith("_ZN") and mangled in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise RuntimeError(f"expected one SASS function {kernel}<{targs}>, found {len(body)}")
    ins = []
    back = []
    for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body[0]):
        addr, t = int(a, 16), t.strip()
        op = t.split()[1] if t.startswith("@") else t.split()[0]
        ins.append((addr, op.split(".")[0], t))
        m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", t)
        if m and m.group(1) is not None and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    return ins, back


def _is_int_op(base: str) -> bool:
    return not (base in _SASS_SKIP or base.startswith(("LD", "ST", "U", "ATOM", "RED")))


def sass_int_ops_per_thread(text: str, kernel: str, nr: int) -> tuple[int, dict]:
    """Integer instructions one thread of ``kernel``<nr> executes, read
    from the compiled SASS: the straight-line code counts once, the round
    loop's body (the one backward branch) nr - 1 times. Returns the count
    and the opcode histogram of that stream."""
    ins, back = sass_function(text, kernel, nr)
    if len(back) != 1:
        raise RuntimeError(f"expected one backward branch (the round loop), found {back}")
    lo, hi = back[0]
    hist: dict = {}
    total = 0
    for addr, base, _t in ins:
        if not _is_int_op(base):
            continue
        k = nr - 1 if lo <= addr <= hi else 1
        hist[base] = hist.get(base, 0) + k
        total += k
    return total, dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def sass_mk_per_thread(text: str, nr: int, kernel: str = "ctr_mk_kernel", targs=None) -> dict:
    """``ctr_mk_kernel``<nr>'s integer SASS by key form. The kernel has one
    rolled round loop per key form (its largest loops) and small set-up
    loops: four (the mixed word form, the most instructions; of
    the other three the select form reads the most from shared memory, the
    uniform word form the least, and the uniform mask form is the last).
    Per group, a form runs its loop body
    nr - 1 times plus straight-line code; the straight-line code holds every
    form's first and last rounds, and the set-up loops are counted once, so
    ``*_group`` is an upper bound for one group of that form.
    ``uniform_group`` and ``mixed_group`` are the forms a uniform and a
    mixed warp take at K up to the mask cap.
    ``targs``: the kernel's template arguments, if not (nr,)."""
    ins, back = sass_function(text, kernel, nr if targs is None else targs)
    loops = []
    for lo, hi in back:
        body = [(a, b) for a, b, _t in ins if lo <= a <= hi]
        loops.append({"range": (lo, hi), "int": sum(_is_int_op(b) for _a, b in body),
                      "lds": sum(b == "LDS" for _a, b in body)})
    loops.sort(key=lambda lp: -lp["int"])
    forms = 4 if kernel == "ctr_mk_kernel" else 2
    if len(loops) < forms:
        raise RuntimeError(f"expected {forms} round loops in {kernel}<{nr}>, found {back}")
    loops = loops[:forms]
    if forms == 4:
        rest = sorted(loops[1:], key=lambda lp: -lp["lds"])
        named = {"mixed_words": loops[0], "select_masks": rest[0], "uniform_masks": rest[1],
                 "uniform_words": rest[2]}
    else:
        mixed, uniform = sorted(loops, key=lambda lp: -lp["lds"])
        named = {"mixed_words": mixed, "uniform_words": uniform}
    outside = sum(_is_int_op(b) for a, b, _t in ins
                  if not any(lp["range"][0] <= a <= lp["range"][1] for lp in loops))
    out = {"outside_round_loops": outside}
    for name, lp in named.items():
        out[f"{name}_round"] = lp["int"]
        out[f"{name}_group"] = lp["int"] * (nr - 1) + outside
    out["uniform_group"] = out["uniform_masks_group" if forms == 4 else "uniform_words_group"]
    out["mixed_group"] = out["select_masks_group" if forms == 4 else "mixed_words_group"]
    # The prologue: from entry to the warp's first vote (the slot and counter
    # loads, the key prologue, the clamps and, in the parent, the offsets).
    vote = next((a for a, b, _t in ins if b == "VOTE"), None)
    pro = [(b, t) for a, b, t in ins if vote is not None and a < vote]
    out["prologue_to_vote"] = {
        "integer": sum(_is_int_op(b) for b, _t in pro),
        "global_loads": sum(b == "LDG" for b, _t in pro),
        "global_loads_128": sum(b == "LDG" and ".128" in t for b, t in pro),
        "shared_stores": sum(b == "STS" for b, _t in pro),
        "instructions": len(pro)}
    out["votes"] = sum(b == "VOTE" for _a, b, _t in ins)
    return out


def sass_chain_per_element(text: str, chain: int, ilp: int) -> dict:
    """LOP3s and integer instructions one element of
    ``chain_kernel<chain, ilp>`` costs, read from the compiled SASS: the body
    of the grid-stride loop (the one backward branch), which the source keeps
    rolled so that one trip is one element."""
    ins, back = sass_function(text, "chain_kernel", (chain, ilp))
    if len(back) != 1:
        raise RuntimeError(f"expected one backward branch in chain_kernel<{chain},{ilp}>, "
                           f"found {back}")
    lo, hi = back[0]
    body = [b for a, b, _t in ins if lo <= a <= hi]
    return {"lop3": sum(b == "LOP3" for b in body), "int": sum(_is_int_op(b) for b in body),
            "instructions": len(body)}


def _sass_dst_srcs(base: str, text: str) -> tuple[list, list]:
    """(general registers written, registers read) of one SASS instruction:
    the first operand is the destination when it is a register (its width
    from a .64/.128/.WIDE suffix); RZ, predicates and uniform registers are
    not counted."""
    if text.startswith("@"):
        text = text.split(None, 1)[1]
    parts = text.split(None, 1)
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    dst = []
    if ops and re.match(r"R\d+\b", ops[0]):
        opcode = parts[0]
        width = 4 if ".128" in opcode else 2 if (".64" in opcode or ".WIDE" in opcode
                                                 or ops[0].endswith(".64")) else 1
        r0 = int(re.match(r"R(\d+)", ops[0]).group(1))
        dst = list(range(r0, r0 + width))
        ops = ops[1:]
    srcs = []
    for o in ops:
        for m in re.finditer(r"\bR(\d+)(\.64)?", o):
            r = int(m.group(1))
            srcs += [r, r + 1] if m.group(2) else [r]
    return dst, srcs


def sass_dep_depth(ins: list, lo: int, hi: int) -> int:
    """The longest chain of dependent integer instructions among the SASS
    instructions at addresses [lo, hi] (one pass in program order, register
    def-use): the dependency depth of one trip through a loop body. Values
    live on entry, and loaded values, start at depth 0."""
    depth: dict = {}
    best = 0
    for addr, base, text in ins:
        if not lo <= addr <= hi:
            continue
        dst, srcs = _sass_dst_srcs(base, text)
        d = max((depth.get(r, 0) for r in srcs), default=0) + 1 if _is_int_op(base) else 0
        for r in dst:
            depth[r] = d
        best = max(best, d)
    return best


def sass_round_loops(text: str, kernel: str, targs) -> list:
    """The innermost loops of ``kernel``<targs> (loops that hold no other
    loop), largest first: [{"range", "int", "depth", "hist"}], ``int`` the
    integer instructions of one trip, ``depth`` its dependency depth
    (``sass_dep_depth``) and ``hist`` its integer opcodes by count. In the
    AES kernels the largest is the rolled round loop, one round a trip."""
    ins, back = sass_function(text, kernel, targs)
    inner = [(lo, hi) for lo, hi in back
             if not any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in back)]

    def hist(lo, hi):
        h: dict = {}
        for a, b, _t in ins:
            if lo <= a <= hi and _is_int_op(b):
                h[b] = h.get(b, 0) + 1
        return dict(sorted(h.items(), key=lambda kv: -kv[1]))

    loops = [{"range": (lo, hi), "int": sum(_is_int_op(b) for a, b, _t in ins if lo <= a <= hi),
              "depth": sass_dep_depth(ins, lo, hi), "hist": hist(lo, hi)} for lo, hi in inner]
    if not loops:
        raise RuntimeError(f"no loop in {kernel}<{targs}>")
    return sorted(loops, key=lambda lp: -lp["int"])


def seq_lane_path(nr: int, q: int) -> dict:
    """The dependent path of one block in a lane form of ``seq_encrypt``
    with ``q`` lanes a column, counted from its circuits (``aes_lanes.cuh``).
    A round: SubBytes' register lookup, 8 integer steps (the selector's
    LOP3 and IMAD.HI, one PRMT, five levels of bit selects, log2 q of them
    each after a shuffle); ShiftRows, a shuffle and two PRMTs; MixColumns
    with AddRoundKey, 5 steps (rot8, t, t's sign bytes, xtime's half, the
    XOR of all). The last round ends with AddRoundKey's XOR instead of
    MixColumns, and a block starts with the whitening XOR (CBC's P ^ C in
    the same LOP3; CFB128's P ^ E in the last one). Returns the integer
    steps and the shuffles."""
    lanes = q.bit_length() - 1
    sub_bytes, shift_rows, mix_columns = 8, 2, 5
    alu = (nr - 1) * (sub_bytes + shift_rows + mix_columns) + sub_bytes + shift_rows + 1 + 1
    return {"alu_steps": alu, "shuffles": nr * (lanes + 1)}


def sass_seq_lanes(text: str, nr: int, cfb: int, q: int) -> dict:
    """A lane form's SASS (``seq_lanes_kernel``<nr, cfb, q>) for one block:
    the instructions of its block loop (its one loop; the rounds are
    unrolled) of one warp by pipe, ``alu`` the integer pipe, ``fma`` the
    IMADs on the FMA pipe, ``shfl`` the shuffles; the loop's dependency
    depth (``sass_dep_depth``, a shuffle counted as one step); its memory
    reads by opcode; and ``table_reads``, the kernel's reads that a table
    in memory would need (local or shared memory, or constant memory at a
    register's offset), which must be none."""
    ins, back = sass_function(text, "seq_lanes_kernel", (nr, cfb, q))
    if len(back) != 1:
        raise RuntimeError(f"expected one loop (the blocks) in seq_lanes_kernel, found {back}")
    lo, hi = back[0]
    out = {"alu": 0, "fma": 0, "shfl": 0, "loads": {}, "table_reads": {}}
    for a, base, t in ins:
        if base in ("LDL", "LDS") or (base == "LDC" and re.search(r"c\[0x[0-9a-f]+\]\[R", t)):
            out["table_reads"][base] = out["table_reads"].get(base, 0) + 1
        if not lo <= a <= hi:
            continue
        if base.startswith("LD"):
            out["loads"][base] = out["loads"].get(base, 0) + 1
        elif _is_int_op(base):
            out["shfl" if base == "SHFL" else "fma" if base == "IMAD" else "alu"] += 1
    out["depth"] = sass_dep_depth(ins, lo, hi)
    return out


def sass_block_kernel(text: str, kernel: str, targs, nr: int) -> dict:
    """A one-block-a-thread kernel's integer SASS for one block: if its
    round loop is rolled (a loop of at least 100 integer instructions), the
    loop nr - 1 times and the rest once, and the loop's dependency depth
    nr - 1 times as its path (``sass_round_loops``); if the rounds are
    unrolled, every instruction once (a set-up loop, such as the key-plane
    prologue, counted once: its one trip at K = 8) and the whole function's
    dependency depth (``sass_dep_depth``) as its path. ``fma``: those of
    them that issue on the FMA pipe (IMAD in all its forms), the rest on the
    integer pipe. Returns {"int", "fma", "depth", "rolled", "hist",
    "round_loop"}."""
    ins, back = sass_function(text, kernel, targs)
    loops = sass_round_loops(text, kernel, targs) if back else []
    rolled = bool(loops) and loops[0]["int"] >= 100
    lo, hi = loops[0]["range"] if rolled else (1, 0)
    hist: dict = {}
    for a, b, _t in ins:
        if _is_int_op(b):
            hist[b] = hist.get(b, 0) + (nr - 1 if lo <= a <= hi else 1)
    return {"int": sum(hist.values()), "fma": hist.get("IMAD", 0),
            "depth": (loops[0]["depth"] * (nr - 1) if rolled
                      else sass_dep_depth(ins, 0, ins[-1][0])),
            "rolled": rolled, "hist": dict(sorted(hist.items(), key=lambda kv: -kv[1])),
            "round_loop": loops[0] if rolled else None}


class SmiSampler:
    """``nvidia-smi`` reading the SM clock, power draw and temperature every
    100 ms in a child process (line-buffered through ``stdbuf`` where there
    is one), each sample stamped with nvidia-smi's own timestamp, so a late
    read does not shift it; ``between`` summarises the samples of a host
    wall-clock interval. ``close`` ends the child."""

    def __init__(self):
        self.samples: list = []
        cmd = ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,temperature.gpu",
               "--format=csv,noheader,nounits", "-lms", "100"]
        if shutil.which("stdbuf"):
            cmd = ["stdbuf", "-oL", *cmd]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                     text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            try:
                t = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((t, float(parts[1]), float(parts[2]), float(parts[3])))
            except (ValueError, IndexError):
                continue

    def between(self, t0: float, t1: float) -> dict:
        """Median SM clock (MHz), mean and peak power (W), peak temperature
        (C) of the samples in [t0, t1] (``time.time()`` seconds); raises if
        there are none."""
        deadline = time.time() + 3.0  # wait for the first sample after t1 to be read
        while time.time() < deadline and not (self.samples and self.samples[-1][0] >= t1):
            time.sleep(0.05)
        sel = [s for s in list(self.samples) if t0 <= s[0] <= t1]
        if not sel:
            raise RuntimeError(f"no nvidia-smi sample in a {t1 - t0:.3f} s window "
                               f"({len(self.samples)} samples in all)")
        return {"samples": len(sel), "clock_mhz": statistics.median(s[1] for s in sel),
                "power_w_mean": round(statistics.fmean(s[2] for s in sel), 2),
                "power_w_max": max(s[2] for s in sel), "temp_c_max": max(s[3] for s in sel)}

    def close(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def trace_kernels(path: str, t0_us: int, t1_us: int) -> dict:
    """The CUDA kernels and copies of an exported ``torch.profiler`` trace,
    clipped to the window [t0_us, t1_us] (epoch µs; the trace's times are
    ``baseTimeNanoseconds`` plus each event's ``ts``): count and µs per
    category, and the ``ctr_mk`` kernels (either form) among them."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    out = {"kernel_us": 0.0, "kernels": 0, "ctr_mk_kernels": 0, "memcpy_us": 0.0, "memcpys": 0,
           "kernels_in_trace": 0, "ctr_mk_in_trace": 0}
    for ev in doc.get("traceEvents", []):
        cat = ev.get("cat")
        if cat not in ("kernel", "gpu_memcpy") or "dur" not in ev:
            continue
        start = base_us + float(ev["ts"])
        end = start + float(ev["dur"])
        mk = cat == "kernel" and re.search(r"ctr_mk_(?:block_)?kernel", ev.get("name", "")) is not None
        out["kernels_in_trace"] += cat == "kernel"
        out["ctr_mk_in_trace"] += mk
        dur = min(end, t1_us) - max(start, t0_us)
        if dur <= 0:
            continue
        if cat == "kernel":
            out["kernel_us"] += dur
            out["kernels"] += 1
            out["ctr_mk_kernels"] += mk
        else:
            out["memcpy_us"] += dur
            out["memcpys"] += 1
    return out


def sass_weighted_path(ins: list, lo: int, hi: int, lds_cycles: float, alu_cycles: float) -> float:
    """The longest dependent path through the SASS instructions at [lo, hi]
    (one trip of a loop), in cycles: a shared-memory load (LDS) is ready
    ``lds_cycles`` after its address and after the issue of every earlier
    shared-memory store (a thread's shared-memory accesses stay in order), an
    integer instruction ``alu_cycles`` after its inputs; a store issues when
    its address and value are ready. Values live on entry start at 0."""
    ready: dict = {}
    last_store = 0.0
    best = 0.0
    for addr, base, text in ins:
        if not lo <= addr <= hi:
            continue
        dst, srcs = _sass_dst_srcs(base, text)
        start = max((ready.get(r, 0.0) for r in srcs), default=0.0)
        if base == "STS":
            last_store = max(last_store, start)
            continue
        if base == "LDS":
            done = max(start, last_store) + lds_cycles
        elif _is_int_op(base):
            done = start + alu_cycles
        else:
            continue
        for r in dst:
            ready[r] = done
        best = max(best, done)
    return best


def cpu_model() -> str:
    """The host CPU as ``lscpu`` names it (vendor, model name, family and
    model numbers, cores), for the native tier's rows; a virtual machine may
    report its model name as unknown."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return "not read"
    fields = {k.strip(): v for k, v in (ln.split(":", 1) for ln in out.splitlines() if ":" in ln)}
    keys = ("Vendor ID", "Model name", "CPU family", "Model", "CPU(s)", "Flags")
    got = {k: fields[k].strip() for k in keys if k in fields}
    if "Flags" in got:
        got["Flags"] = "aes" if " aes " in f" {got['Flags']} " else "no aes"
    return "; ".join(f"{k} {v}" for k, v in got.items()) or "not read"


def harness_rows(out: str) -> list[dict]:
    """The sweep's result rows: {row, bytes, times_us, gbps} (``gbps`` from
    its ``# derived:`` line, None for n/a), and for RC4 the keygen µs."""
    rows: list[dict] = []
    for line in out.splitlines():
        if re.match(r"(GPU AES-\d+ |C AES-\d+ |RC4)[^,]*, \d+, \d+,", line):
            parts = [p.strip() for p in line.split(",") if p.strip()]
            rows.append({"row": ", ".join(parts[:3]), "bytes": int(parts[1]),
                         "times_us": [int(p) for p in parts[3:]], "gbps": None})
        elif line.startswith("Generated a new key in") and rows:
            rows[-1]["keygen_us"] = int(line.split()[-1].rstrip(","))
        elif rows and re.fullmatch(r"(\d+, )*\d+,", line.strip()):
            rows[-1]["times_us"] = [int(p) for p in line.strip().rstrip(",").split(", ")]
        elif line.startswith("# derived:") and rows:
            m = re.match(r"# derived: ([0-9.e+-]+) GB/s", line)
            rows[-1]["gbps"] = float(m.group(1)) if m else None
    return rows


def mk_ops_per_group(nr: int) -> tuple[float, dict]:
    """Operations multi-key CTR needs for one group of 32 blocks: the ECB
    encrypt count (``ecb_ops_per_group``) plus the keystream XORed into the
    data (128 gates). Every group is credited as uniform: the per-block key
    planes of a mixed group (four transposes a round) are the cost of this
    layout, not work the function needs, so the bound is deliberately
    low."""
    ops, parts = ecb_ops_per_group(nr, decrypt=False)
    return ops + 128 / 2, {**parts, "data_xor": 128}


def cbc_mk_ops_per_group(nr: int) -> tuple[float, dict]:
    """Operations multi-key CBC decrypt needs for one group of 32 blocks: the
    ECB decrypt count (``ecb_ops_per_group``) plus the PREV stream XORed into
    the output (128 gates); every group credited as uniform, as for
    ``ctr_mk``."""
    ops, parts = ecb_ops_per_group(nr, decrypt=True)
    return ops + 128 / 2, {**parts, "prev_xor": 128}


def inv_sbox_depth(header: str) -> int:
    """The dependent depth of the inverse S-box circuit, read from its
    generated program in ``aes_inv_bitslice.cuh``: every statement (one
    XOR, XNOR or AND of two or three signals, one LOP3) one step past the
    deepest signal it reads; x[0..7] at depth 0."""
    body = header.split("(inv_sbox)", 1)[1].split("END GENERATED (inv_sbox)", 1)[0]
    depth = {f"x[{i}]": 0 for i in range(8)}
    for stmt in re.findall(r"const uint32_t (.*?);", body, re.S):
        parts, cur, level = [], "", 0
        for ch in stmt:
            level += (ch == "(") - (ch == ")")
            if ch == "," and level == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        for part in parts:
            name, expr = (t.strip() for t in part.split("=", 1))
            ins = [t for t in re.findall(r"x\[\d\]|\b[a-z]\w*\b", expr)
                   if t not in ("xor3", "xnor3")]
            depth[name] = 1 + max(depth[t] for t in ins)
    return max(depth[f"o{i}"] for i in range(8))


def sass_ghash(text: str) -> dict:
    """The GHASH kernels' SASS (``csrc/ghash.cu``), both pipes: ``product``,
    one field product as the rows launch runs it a row (the innermost loop
    of ``ghash_rows_kernel<128>`` holding the IMAD.WIDEs, 144 a product, its
    counts divided by the products a trip; the row's load, flip and store
    included); ``compose``, the carry launch's loop with the most IMAD.WIDE
    (a composition: two products sharing a prepared multiplier). Each as
    integer instructions (``int``), those on the FMA pipe (``fma``: IMAD in
    all its forms), those on the integer pipe (``int_pipe``), IMAD.WIDE, and
    dependency depth."""
    out = {}
    for key, kernel, per in (("product", "ghash_rows_kernel", 144), ("compose", "ghash_carry_kernel",
                                                                     288)):
        ins, _back = sass_function(text, kernel, 128)
        wide = lambda lp: sum(1 for a, _b, t in ins  # noqa: E731
                              if lp["range"][0] <= a <= lp["range"][1] and "IMAD.WIDE" in t)
        lp = max(sass_round_loops(text, kernel, 128), key=wide)
        trips = max(1, round(wide(lp) / per))
        fma = lp["hist"].get("IMAD", 0)
        out[key] = {"int": lp["int"] / trips, "fma": fma / trips,
                    "int_pipe": (lp["int"] - fma) / trips, "imad_wide": wide(lp) / trips,
                    "depth": lp["depth"] / trips, "per_loop_trip": trips,
                    "hist": dict(list(lp["hist"].items())[:12])}
    return out


#: Phase 12: chunked transfers and the wire worker. The JAX package's transfer
#: drive size (docs/SERVING.md, STREAM_r01): a 64 MiB payload; the CBC
#: transfer 16 MiB under AES-256; the request sizes of the worker's one-frame
#: exchanges; the resume drill's abort at the last chunk's admission.
TRANSFER_BYTES = 64 << 20
TRANSFER_CBC_BYTES = 16 << 20
WORKER_SIZES = (16, 1024, 16384)
WORKER_MODES = ("ctr", "cbc", "gcm", "gcm-open")
#: Seconds a worker may take to print its READY line (torch's import, the
#: kernel library's load and warmup of four modes' ladders), and the longest
#: wait on any other line or frame.
WORKER_READY_S = 300
WORKER_WAIT_S = 120
#: One Prometheus text sample: a name, optional labels, a value.
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="[^"]*",?)*\})? '
                         r'(\S+)$')


class _Worker:
    """One ``python -m our_tree_tpu_torch.serve.worker`` process: its
    stdout lines through a reader thread, its stderr in a file, SIGTERM and a
    bounded wait to stop it, and a kill at exit whatever happens."""

    def __init__(self, argv: list, env: dict, err_path: str):
        import queue as queue_mod

        self.err_path = err_path
        self._err = open(err_path, "w", encoding="utf-8")
        self.proc = subprocess.Popen([sys.executable, "-m", "our_tree_tpu_torch.serve.worker",
                                      *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=self._err, text=True)
        atexit.register(self.kill)
        self._lines = queue_mod.Queue()
        self._empty = queue_mod.Empty
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for text in self.proc.stdout:
            self._lines.put(text)
        self._lines.put(None)

    def err_tail(self) -> str:
        if not self._err.closed:
            self._err.flush()
        with open(self.err_path, encoding="utf-8", errors="replace") as fh:
            return fh.read()[-3000:]

    def line(self, timeout_s: float) -> dict:
        try:
            text = self._lines.get(timeout=timeout_s)
        except self._empty:
            raise SystemExit(f"the worker printed no line within {timeout_s} s: "
                             f"{self.err_tail()}") from None
        if text is None:
            raise SystemExit(f"the worker exited (rc {self.proc.poll()}): {self.err_tail()}")
        return json.loads(text)

    def stop(self) -> tuple[dict, int]:
        """SIGTERM, the EXIT line and the return code."""
        self.proc.terminate()
        line = self.line(WORKER_WAIT_S)
        rc = self.proc.wait(WORKER_WAIT_S)
        self._err.close()
        return line, rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


async def _wire_request(port: int, header: dict, payload: bytes):
    """One request frame on its own connection: (header, body, seconds)."""
    from our_tree_tpu_torch.serve import wire

    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(wire.encode_frame(header, payload))
        await writer.drain()
        h, body = await asyncio.wait_for(wire.read_frame(reader), WORKER_WAIT_S)
    finally:
        writer.close()
    return h, body, time.perf_counter() - t0


async def _wire_tx(port: int, header: dict, payload: bytes, step: int):
    """One ``tx`` exchange: begin, the begin-ack, every chunk the ack does
    not list, then the out frames to the done frame. (ack, {i: out bytes},
    done, chunks sent, seconds)."""
    from our_tree_tpu_torch.serve import wire

    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(wire.encode_frame(header))
        await writer.drain()
        ack, _ = await asyncio.wait_for(wire.read_frame(reader), WORKER_WAIT_S)
        if ack.get("tx") != "begin-ack":
            return ack, {}, ack, 0, time.perf_counter() - t0
        view, sent = memoryview(payload), 0
        for i in range(ack["chunks"]):
            if i in ack["acked"]:
                continue
            writer.write(wire.encode_frame({"tx": "chunk", "i": i}, view[i * step:(i + 1) * step]))
            await writer.drain()
            sent += 1
        outs = {}
        while True:
            h, body = await asyncio.wait_for(wire.read_frame(reader), WORKER_WAIT_S)
            if h.get("tx") == "out":
                outs[h["i"]] = body
            else:
                return ack, outs, h, sent, time.perf_counter() - t0
    finally:
        writer.close()


async def _http_get(port: int, path: str) -> tuple[int, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), WORKER_WAIT_S)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


def prometheus_errors(text: str) -> list:
    """Lines of ``text`` that are not Prometheus exposition text (a ``#
    TYPE`` line of a known type, a comment, or a sample whose value parses)."""
    bad = []
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge", "histogram"):
                bad.append(ln)
        elif ln.startswith("#"):
            continue
        else:
            m = PROM_SAMPLE.match(ln)
            try:
                float(m.group(3)) if m else float("x")
            except ValueError:
                bad.append(ln)
    return bad


def transfer_phase(card: str, reset_counts, counts, form_counts, device: str = "cuda") -> dict:
    """Phase 12: (a) a ``Server`` in this process with modes ``ctr,cbc``, the
    default ladder and transfers on: the 64 MiB AES-128 CTR transfer and the
    16 MiB AES-256 CBC transfer through ``Server.submit``, each counted
    (every launch count set to 0 just before and read just after), an
    oversized ``gcm`` submit; (b) the worker process over the wire: one
    request of each mode and size, a 4 MiB frame, the 64 MiB ``tx``
    transfer, the resume drill on a second worker, a tampered ``gcm-open``
    and its ``auth-spike`` bundle, ``/metrics`` and ``/healthz``, SIGTERM.
    Returns the ``transfer`` entries of ``ctr_mk`` and ``cbc_mk``."""
    import numpy as np

    from our_tree_tpu_torch.aead import gcm as agcm
    from our_tree_tpu_torch.aead import ghash as aghash
    from our_tree_tpu_torch.models.aes import AES, AES_DECRYPT
    from our_tree_tpu_torch.obs import incident
    from our_tree_tpu_torch.ops import cuda_aes
    from our_tree_tpu_torch.serve.queue import ERR_TRANSFER_MODE
    from our_tree_tpu_torch.serve.server import Server, ServerConfig

    rng = np.random.default_rng(1337)
    payload = rng.integers(0, 256, TRANSFER_BYTES, dtype=np.uint8)
    key, nonce = bytes(range(16)), bytes.fromhex(BLOCK_IV)
    cbc_key, cbc_iv = bytes(range(32)), bytes(range(16, 32))
    cbc_ct = rng.integers(0, 256, TRANSFER_CBC_BYTES, dtype=np.uint8)
    oracle = AES(key, device=device)
    want_ctr = np.asarray(oracle.crypt_ctr(0, np.frombuffer(nonce, np.uint8),
                                           np.zeros(16, np.uint8), payload)[0])
    want_cbc = np.asarray(AES(cbc_key, device=device).crypt_cbc(
        AES_DECRYPT, np.frombuffer(cbc_iv, np.uint8), cbc_ct)[0])
    out: dict = {}

    # (a) In process, counted.
    server = Server(ServerConfig(device=device, modes=("ctr", "cbc"), warmup_key_bits=(128, 256)))

    async def counted(mode, submit):
        calls0 = dict(server.pool.stats()["engine_calls_by_mode"])
        batches0 = server.batches
        reset_counts()
        t0 = time.perf_counter()
        resp = await submit()
        wall = time.perf_counter() - t0
        got, forms = counts(), form_counts()["ctr_mk"]
        calls = server.pool.stats()["engine_calls_by_mode"].get(mode, 0) - calls0.get(mode, 0)
        return resp, wall, got, forms, calls, server.batches - batches0

    async def drive_a():
        await server.start()
        try:
            ctr = await counted("ctr", lambda: server.submit("tenant", key, nonce, payload))
            cbc = await counted("cbc", lambda: server.submit("tenant", cbc_key, b"", cbc_ct,
                                                             mode="cbc", iv=cbc_iv))
            gcm = await server.submit("tenant", key, b"", payload[:1 << 20], mode="gcm",
                                      iv=bytes(12))
            return ctr, cbc, gcm
        finally:
            await server.stop()

    ctr, cbc, gcm = asyncio.run(drive_a())
    stats = server.stats()
    for name, mode, res, want, size in (("ctr_mk", "ctr", ctr, want_ctr, TRANSFER_BYTES),
                                        ("cbc_mk", "cbc", cbc, want_cbc, TRANSFER_CBC_BYTES)):
        resp, wall, got, forms, calls, batches = res
        chunks = size // (16 * server.rungs[-1])
        checks = {
            "ok": resp.ok,
            f"{chunks} chunks": resp.ok and resp.transfer["chunks"] == resp.transfer["sent"]
            == chunks,
            "equal to the card's independent path": resp.ok and np.array_equal(
                np.asarray(resp.payload), want),
            f"{name} launches == engine calls": got[name] == calls == batches > 0,
            "no other kernel": all(v == 0 for n, v in got.items() if n != name),
        }
        if name == "ctr_mk":
            checks["every ctr_mk launch in the block form"] = forms.get("block", 0) == got[
                name] and all(v == 0 for f, v in forms.items() if f != "block")
        log(f"transfer ({mode}, {size >> 20} MiB, AES-{8 * (len(key) if mode == 'ctr' else 32)}, "
            f"in process): {chunks} chunks, {wall:.4f} s wall, {size / wall / 1e9:.4f} GB/s, "
            f"{batches / wall:.1f} dispatches/s, {name} launches {got[name]} "
            f"({forms if name == 'ctr_mk' else 'one form'}), engine calls {calls}; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"the in-process {mode} transfer failed: {checks}, launches {got}")
        out[name] = {"chunks": chunks, "chunk_blocks": server.rungs[-1], "bytes": size,
                     "launches": got[name], "engine_calls": calls, "wall_s": wall,
                     "gbps": size / wall / 1e9, "dispatches_per_s": batches / wall,
                     "key_bits": 128 if mode == "ctr" else 256, "card": card}
    checks = {"oversized gcm: transfer-unsupported": not gcm.ok and gcm.error == ERR_TRANSFER_MODE,
              "0 lost": stats["queue"]["lost"] == 0,
              "0 builds after warmup": stats["compiles"]["steady"] == 0,
              "buffer empty, ledger done": stats["transfers"]["held_bytes"] == 0
              and stats["transfers"]["ledger_live"] == 0}
    log(f"transfer server (in process): queue {stats['queue']}, compiles {stats['compiles']}, "
        f"transfers {stats['transfers']}; oversized gcm answered {gcm.error}")
    if not all(checks.values()):
        raise SystemExit(f"the in-process transfer server failed: {checks}")

    # (b) Through the worker process.
    trace_root = tempfile.mkdtemp(prefix="ot_worker_")
    env = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
    env.update(OT_TRACE_DIR=trace_root, OT_INCIDENT_AUTH_SPIKE="1")
    drill_env = {**env, "OT_FAULTS": f"transfer_abort:1@chunk={TRANSFER_BYTES // 65536 - 1}"}
    drill_env.pop("OT_TRACE_DIR")
    base = ["--device", device, "--port", "0", "--status-port", "0"]
    t0 = time.perf_counter()
    # Both workers start together; the drill's admits one chunk at a time, so
    # the abort at the last chunk's admission follows every earlier ack.
    worker = _Worker([*base, "--modes", ",".join(WORKER_MODES)], env,
                     os.path.join(trace_root, "worker.err"))
    drill = _Worker([*base, "--transfer-window", "1"], drill_env,
                    os.path.join(trace_root, "drill.err"))
    try:
        ready = worker.line(WORKER_READY_S)
        ready_s = time.perf_counter() - t0
        drill_ready = drill.line(WORKER_READY_S)
        log(f"worker READY after {ready_s:.1f} s: {ready}; drill worker {drill_ready}")
        port, sport = ready["port"], ready["status_port"]
        step = 16 * 4096
        plain = AES(key, device="cpu")
        lat: dict = {}
        bad = []

        async def drive_b():
            wrng = np.random.default_rng(2026)
            for size in WORKER_SIZES:
                pt = wrng.integers(0, 256, size, dtype=np.uint8)
                n16, iv16, iv12 = wrng.bytes(16), wrng.bytes(16), wrng.bytes(12)
                aad = wrng.bytes(20)
                ct, tag = aghash.np_gcm_seal(key, iv12, aad, pt.tobytes())
                reqs = {
                    "ctr": ({"t": "w", "k": key.hex(), "n": n16.hex()}, pt,
                            plain.crypt_ctr(0, np.frombuffer(n16, np.uint8),
                                            np.zeros(16, np.uint8), pt)[0]),
                    "cbc": ({"t": "w", "k": key.hex(), "m": "cbc", "iv": iv16.hex()}, pt,
                            plain.crypt_cbc(AES_DECRYPT, np.frombuffer(iv16, np.uint8), pt)[0]),
                    "gcm": ({"t": "w", "k": key.hex(), "m": "gcm", "iv": iv12.hex(),
                             "a": aad.hex()}, pt,
                            np.frombuffer(agcm.gcm_seal(key, iv12, aad, pt.tobytes(),
                                                        device="cpu")[0], np.uint8)),
                    "gcm-open": ({"t": "w", "k": key.hex(), "m": "gcm-open", "iv": iv12.hex(),
                                  "a": aad.hex(), "tg": tag.hex()}, np.frombuffer(ct, np.uint8),
                                 pt),
                }
                for mode in WORKER_MODES:
                    h, frame_pt, want = reqs[mode]
                    got_h, body, dt = await _wire_request(port, h, frame_pt.tobytes())
                    lat[(mode, size)] = dt
                    ok = got_h.get("ok") and body == np.asarray(want, np.uint8).tobytes()
                    if mode == "gcm":
                        ok = ok and got_h.get("tg") == tag.hex() and body == ct
                    if not ok:
                        bad.append((mode, size, got_h))
            big = payload[:wire_max]
            h, body, dt_4m = await _wire_request(port, {"t": "w", "k": key.hex(),
                                                        "n": nonce.hex()}, big.tobytes())
            four = h.get("ok") and body == want_ctr[:wire_max].tobytes()
            begin = {"tx": "begin", "t": "w", "k": key.hex(), "n": nonce.hex(),
                     "tid": "transfer-64", "total": TRANSFER_BYTES}
            tx = await _wire_tx(port, begin, payload.tobytes(), step)
            d_begin = {**begin, "tid": "drill"}
            first = await _wire_tx(drill_ready["port"], d_begin, payload.tobytes(), step)
            second = await _wire_tx(drill_ready["port"], d_begin, payload.tobytes(), step)
            # The tampered open: auth-failed, no plaintext, one auth-spike bundle.
            pt = wrng.integers(0, 256, 1024, dtype=np.uint8)
            iv12 = wrng.bytes(12)
            ct, tag = aghash.np_gcm_seal(key, iv12, b"", pt.tobytes())
            th, tbody, _ = await _wire_request(port, {"t": "w", "k": key.hex(), "m": "gcm-open",
                                                      "iv": iv12.hex(),
                                                      "tg": bytes([tag[0] ^ 1, *tag[1:]]).hex()},
                                               ct)
            inc = await _http_get(sport, "/incidentz")
            met = await _http_get(sport, "/metrics")
            hz = await _http_get(sport, "/healthz")
            return four, dt_4m, tx, first, second, (th, tbody), inc, met, hz

        from our_tree_tpu_torch.serve import wire as wire_mod

        wire_max = wire_mod.MAX_PAYLOAD
        four, dt_4m, tx, first, second, tamper, inc, met, hz = asyncio.run(drive_b())
        for mode in WORKER_MODES:
            log(f"worker {mode}: " + ", ".join(
                f"{size} B {1e3 * lat[(mode, size)]:.3f} ms" for size in WORKER_SIZES)
                + f" (one request on its own connection, client wall); card: {card}")
        ack, outs, done, sent, tx_s = tx
        tx_ok = (done.get("ok") and sorted(outs) == list(range(TRANSFER_BYTES // step))
                 and b"".join(outs[i] for i in sorted(outs)) == want_ctr.tobytes())
        log(f"worker 4 MiB frame: {dt_4m:.4f} s, {wire_max / dt_4m / 1e9:.4f} GB/s; 64 MiB tx: "
            f"{sent} chunks up, {len(outs)} out, {tx_s:.4f} s, "
            f"{TRANSFER_BYTES / tx_s / 1e9:.4f} GB/s (upload, dispatch and download); done "
            f"{done.get('transfer')}; card: {card}")
        ack1, outs1, done1, sent1, s1 = first
        ack2, outs2, done2, sent2, s2 = second
        last = TRANSFER_BYTES // step - 1
        spliced = b"".join({**outs1, **outs2}[i] for i in range(last + 1)) \
            if len({**outs1, **outs2}) == last + 1 else b""
        drill_checks = {
            "the abort is typed and carries the token": done1.get("error") == "transfer-abort"
            and done1.get("tid") == "drill" and (done1.get("transfer") or {}).get("token") == "drill",
            "the resume acks chunks 0-1022": ack2.get("acked") == list(range(last)),
            "exactly one chunk re-sent": sent2 == 1 and (done2.get("transfer") or {}).get(
                "sent") == 1 and sorted(outs2) == [last],
            "the splice is byte-identical": done2.get("ok") and spliced == want_ctr.tobytes(),
        }
        log(f"resume drill (OT_FAULTS=transfer_abort:1@chunk={last}, --transfer-window 1): "
            f"first {sent1} chunks up, {len(outs1)} out, {done1.get('error')} in {s1:.3f} s; "
            f"resume acked {len(ack2.get('acked', []))}, {sent2} re-sent, {len(outs2)} out in "
            f"{s2:.3f} s, done {done2.get('transfer')}")
        th, tbody = tamper
        icode, ibody = inc
        idoc = json.loads(ibody) if icode == 200 else {}
        bundles = idoc.get("bundles", [])
        bundle = (incident.load_bundle(os.path.join(idoc["run_dir"], bundles[0]["file"]))
                  if len(bundles) == 1 else None)
        mcode, mbody = met
        hcode, hbody = hz
        hdoc = json.loads(hbody) if hcode == 200 else {}
        prom_bad = prometheus_errors(mbody)
        worker_exit, rc = worker.stop()
        drill_exit, drill_rc = drill.stop()
        err_tails = (worker.err_tail(), drill.err_tail())
    finally:
        worker.kill()
        drill.kill()
        shutil.rmtree(trace_root, ignore_errors=True)
    checks = {
        "every one-frame request equal to the plain version (gcm tags the host GCM's)": not bad,
        "the 4 MiB frame transferred transparently": bool(four),
        "the 64 MiB tx transfer equal to the card's independent path": bool(tx_ok),
        **drill_checks,
        "tampered open: auth-failed, no plaintext": th.get("error") == "auth-failed"
        and tbody == b"",
        "one auth-spike bundle that validates": len(bundles) == 1
        and bundles[0]["reason"] == "auth-spike" and bundles[0]["valid"]
        and incident.validate_bundle(bundle) == [],
        "/metrics is Prometheus text": mcode == 200 and not prom_bad,
        "/metrics carries the transfer counters and serve_auth_failed": "serve_transfer_" in mbody
        and "serve_auth_failed_total" in mbody,
        "/healthz: 0 steady builds, a transfers section": hcode == 200
        and hdoc["compiles"]["steady"] == 0 and "transfers" in hdoc,
        "EXIT: lost 0, rc 0": worker_exit.get("lost") == 0 and rc == 0
        and worker_exit.get("kind") == "ot-serve-worker-exit",
        "drill EXIT: lost 0, rc 0": drill_exit.get("lost") == 0 and drill_rc == 0,
    }
    log(f"worker: /healthz status {hdoc.get('status')}, compiles {hdoc.get('compiles')}, "
        f"transfers {hdoc.get('transfers')}; /incidentz {[(b['reason'], b['valid']) for b in bundles]}; "
        f"EXIT {worker_exit} rc {rc}; drill EXIT {drill_exit} rc {drill_rc}")
    if not all(checks.values()):
        raise SystemExit(f"the worker phase failed: {checks}; bad requests {bad[:4]}; "
                         f"Prometheus lines refused {prom_bad[:4]}; stderr {err_tails}")
    out["worker"] = {"ready_s": ready_s, "tx_64MiB_s": tx_s,
                     "tx_64MiB_gbps": TRANSFER_BYTES / tx_s / 1e9, "frame_4MiB_s": dt_4m,
                     "latency_ms": {f"{m}:{s}": 1e3 * lat[(m, s)] for m, s in lat},
                     "drill": {"acked": len(ack2.get("acked", [])), "resent": sent2}}
    return out



#: The JAX package's session acceptance drive (``docs/SERVING.md``, artifact
#: ``SESSION_r01.json``), run with ``OT_FAULTS=lane_hang:1
#: OT_DISPATCH_DEADLINE=2`` in its environment, at the JAX server's session
#: defaults (window 65,536 B, quantum 4,096 B, 8 prefetch slots, 8 MiB
#: budget, 16 sessions a tenant).
SESSION_DRIVE = ["--requests", "200", "--concurrency", "16", "--modes", "ctr,gcm,rc4",
                 "--sizes", "16,64,256,1024,4096,16384", "--lanes", "2", "--sessions", "32",
                 "--session-chunks", "8", "--min-session-hit-rate", "0.9",
                 "--min-session-replays", "1"]
#: The journal round trip's drive (``--retries 1``: a second failed dispatch
#: of lane 1 quarantines it) and its faults.
JOURNAL_DRIVE = ["--requests", "60", "--sizes", "256,1024", "--lanes", "2", "--retries", "1"]
JOURNAL_FAULTS = "lane_fail:2@lane=1"
#: The worker's sessions: (sid, chunk sizes), each chunk through ``ss data``.
WORKER_SESSIONS = {1: (16, 4096, 1008, 256), 2: (2048, 48, 4096, 16)}
#: The session refill's launch shapes: the served one (8 sessions x the
#: 4,096-byte quantum) and the CPU tests' (2 x 2,048).
PREFETCH_SHAPES = {"served": (8, 4096), "tests": (2, 2048)}


def session_phase(card: str, reset_counts, counts, device: str = "cuda") -> dict:
    """Phase 13: (a) the session acceptance drive in a child process with its
    faults armed, gated on the bench's line; (c) the journal round trip in
    this process, counted; (d) a worker with ``--modes ctr,rc4`` over the
    wire. Returns the figures for the ``arc4_prga`` entry's ``session``."""
    import numpy as np

    from our_tree_tpu_torch.models import arc4
    from our_tree_tpu_torch.serve import bench as serve_bench

    out: dict = {}
    # (a) The drive, in a child: the hung lane's worker thread sleeps on in
    # it, and the faults stay out of this process.
    crash = tempfile.mkdtemp(prefix="ot_session_crash_")
    env = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
    env.update(OT_FAULTS="lane_hang:1", OT_DISPATCH_DEADLINE="2", OT_CRASH_DIR=crash)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.serve.bench",
                              "--device", device, *SESSION_DRIVE], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        dumps = sorted(os.listdir(crash))
    finally:
        shutil.rmtree(crash, ignore_errors=True)
    wall = time.perf_counter() - t0
    try:
        line = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        line = None
    if res.returncode != 0 or line is None:
        raise SystemExit(f"the session drive: rc {res.returncode}, out {res.stdout[-3000:]!r}, "
                         f"err {res.stderr[-3000:]!r}")
    for text in res.stdout.strip().splitlines()[:-1]:
        log(f"session drive: {text}")
    per, sess = line["per_mode"], line["sessions"]
    calls, lat, launches = per["engine_calls"], per["latency"], line["launches"]
    load_sess = line["load"]["sessions"]
    q_lane = [r for r in line["lanes"]["per_lane"] if r["state"] != "healthy"
              or any(t["why"] == "dispatch-timeout" for t in r["transitions"])]
    checks = {
        "rc 0": res.returncode == 0,
        "CUDA engine": device != "cuda" or line["engine"].startswith("cuda"),
        "0 lost, 0 failed": line["lost"] == 0 and line["errors"] == {}
        and line["ok"] == line["requests"] == 200 + 32 * 8,
        "0 mismatches": line["mismatches"] == 0 and line["verified"] >= 256,
        "every chunk equal to the host PRGA": load_sess.get("verified") == 256
        and not load_sess.get("mismatches") and not load_sess.get("chunk_failed"),
        "32 sessions opened and closed": sess["opened"] == sess["closed"] == 32
        and sess["chunks"] == 256,
        "0 steady builds": line["recompiles"] == 0,
        "exactly one quarantine, by the watchdog": line["quarantines"] == 1 and len(q_lane) == 1
        and any(t["why"] == "dispatch-timeout" for t in q_lane[0]["transitions"]),
        "at least one replay": sess["replays"] >= 1,
        "hit rate >= 0.9": sess["hit_rate"] is not None and sess["hit_rate"] >= 0.9,
        "arc4_prga launches == rc4-prep engine calls (warmup + prefetches)":
        launches.get("arc4_prga") == calls.get("rc4-prep")
        == 2 + sess["prefetch_dispatches"],
        "ctr_mk launches == ctr and gcm engine calls": launches.get("ctr_mk")
        == calls.get("ctr", 0) + calls.get("gcm", 0) > 0,
        "ghash_at calls == gcm engine calls": launches.get("ghash_at") == calls.get("gcm") > 0,
        # The XOR is a torch elementwise kernel, not a wrapper of the port.
        "no kernel but ctr_mk, ghash_at, arc4_prga and the XOR's elementwise kernel":
        set(launches) == {"ctr_mk", "ghash_at", "arc4_prga"},
        "the hang left its stack dump": len(dumps) >= 1,
    }
    if device != "cuda":  # a rehearsal on the CPU launches nothing
        for name in ("arc4_prga launches == rc4-prep engine calls (warmup + prefetches)",
                     "ctr_mk launches == ctr and gcm engine calls",
                     "ghash_at calls == gcm engine calls"):
            checks[name] = set(launches.values()) == {0}
    dev_us = per["device_us_per_dispatch"]
    log(f"session drive (OT_FAULTS=lane_hang:1 OT_DISPATCH_DEADLINE=2 {' '.join(SESSION_DRIVE)}): "
        f"rc {res.returncode}, {wall:.1f} s wall with start-up; p50 by mode "
        + ", ".join(f"{m} {v['p50_ms']} ms (p99 {v['p99_ms']})" for m, v in lat.items())
        + f"; prefetch dispatches {sess['prefetch_dispatches']}, hit rate {sess['hit_rate']}, "
        f"replays {sess['replays']}, quarantines {line['quarantines']}; card a dispatch: rc4-prep "
        f"{dev_us.get('rc4-prep')} µs, rc4 {dev_us.get('rc4')} µs, ctr {dev_us.get('ctr')} µs, "
        f"gcm {dev_us.get('gcm')} µs; engine calls {calls}; launches {launches}; card: {card}")
    if not all(checks.values()):
        raise SystemExit(f"the session drive failed: {checks}")
    out["drive"] = {"argv": SESSION_DRIVE, "faults": "lane_hang:1", "dispatch_deadline_s": 2,
                    "wall_s": wall, "p50_ms": {m: v["p50_ms"] for m, v in lat.items()},
                    "p99_ms": {m: v["p99_ms"] for m, v in lat.items()},
                    "prefetch_dispatches": sess["prefetch_dispatches"],
                    "hit_rate": sess["hit_rate"], "replays": sess["replays"],
                    "quarantines": line["quarantines"], "launches": launches,
                    "engine_calls": calls, "device_us_per_dispatch": dev_us, "card": card}

    # (c) The journal round trip, in this process and counted: faults
    # quarantine lane 1 and write a row; the next run adopts it; the release
    # edit clears it; the last run starts healthy.
    from our_tree_tpu_torch.resilience import faults

    jdir = tempfile.mkdtemp(prefix="ot_journal_")
    jpath = os.path.join(jdir, "serve_journal.jsonl")
    argv = ["--device", device, *JOURNAL_DRIVE, "--journal", jpath]

    def run(faults_spec=""):
        if faults_spec:
            os.environ["OT_FAULTS"] = faults_spec
        faults.reset()
        reset_counts()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = serve_bench.main(argv)
        finally:
            os.environ.pop("OT_FAULTS", None)
            faults.reset()
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), counts()

    def rows():
        with open(jpath, encoding="utf-8") as fh:
            return [json.loads(t) for t in fh][1:]

    try:
        rc1, l1, c1 = run(JOURNAL_FAULTS)
        rows1 = rows()
        rc2, l2, c2 = run()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_release = serve_bench.main(["--journal", jpath, "--unquarantine", "lane:1"])
        released = buf.getvalue().strip()
        rows3 = rows()
        rc4, l4, c4 = run()
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    lane1 = [r["per_lane"][1] for r in (l1["lanes"], l2["lanes"], l4["lanes"])]
    checks = {
        "rc 0 each": rc1 == rc2 == rc4 == rc_release == 0,
        "0 lost, 0 failed each": all(ln["lost"] == 0 and ln["errors"] == {} for ln in (l1, l2, l4)),
        "run 1 quarantines lane 1": l1["quarantines"] == 1
        and any(t["to"] == "quarantined" for t in lane1[0]["transitions"]),
        "run 1 writes one failure row": rows1 == [{"unit": "lane:1", "failed": True,
                                                   "reason": "PolicyExhausted"}],
        "run 2 starts lane 1 quarantined (journal:1)": lane1[1]["transitions"][0]["to"]
        == "quarantined" and lane1[1]["transitions"][0]["why"] == "journal:1",
        "the release clears the row": released == "# unquarantine: lane:1: cleared 1 failure "
        "row(s)" and rows3 == [],
        "run 3 starts both lanes healthy": l4["quarantines"] == 0 and all(
            r["state"] == "healthy" and not r["transitions"] for r in l4["lanes"]["per_lane"]),
        "ctr_mk launches == engine calls, no other kernel": all(
            c["ctr_mk"] == (ln["engine_calls"] if device == "cuda" else 0)
            and all(v == 0 for k, v in c.items() if k != "ctr_mk")
            for c, ln in ((c1, l1), (c2, l2), (c4, l4))),
    }
    log(f"journal round trip ({JOURNAL_FAULTS} then none, {' '.join(JOURNAL_DRIVE)}): run 1 lane 1 "
        f"{[(t['to'], t['why']) for t in lane1[0]['transitions']]}, rows {rows1}; run 2 lane 1 "
        f"{[(t['to'], t['why']) for t in lane1[1]['transitions']]}; release: {released!r}; run 3 "
        f"states {[r['state'] for r in l4['lanes']['per_lane']]}; ctr_mk launches "
        f"{[c['ctr_mk'] for c in (c1, c2, c4)]}; card: {card}")
    if not all(checks.values()):
        raise SystemExit(f"the journal round trip failed: {checks}")

    # (d) A worker with --modes ctr,rc4: two sessions over the wire, each
    # chunk against the host PRGA, a data frame on a closed session.
    trace_root = tempfile.mkdtemp(prefix="ot_session_worker_")
    wenv = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
    worker = _Worker(["--device", device, "--modes", "ctr,rc4", "--port", "0", "--status-port",
                      "0"], wenv, os.path.join(trace_root, "worker.err"))
    try:
        ready = worker.line(WORKER_READY_S)
        keys = {sid: bytes(range(sid, sid + 16)) for sid in WORKER_SESSIONS}
        wrng = np.random.default_rng(4242)
        chunks = {sid: [wrng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
                  for sid, sizes in WORKER_SESSIONS.items()}

        async def drive_d():
            reader, writer = await asyncio.open_connection("127.0.0.1", ready["port"])
            from our_tree_tpu_torch.serve import wire

            async def ask(h, body=b""):
                writer.write(wire.encode_frame(h, body))
                await writer.drain()
                return await asyncio.wait_for(wire.read_frame(reader), WORKER_WAIT_S)

            try:
                answers = [await ask({"ss": "open", "t": "w", "sid": sid, "k": k.hex()})
                           for sid, k in keys.items()]
                for i in range(4):
                    for sid in WORKER_SESSIONS:
                        answers.append(await ask({"ss": "data", "t": "w", "sid": sid},
                                                 chunks[sid][i].tobytes()))
                answers += [await ask({"ss": "close", "t": "w", "sid": sid}) for sid in keys]
                closed = await ask({"ss": "data", "t": "w", "sid": 1}, bytes(16))
            finally:
                writer.close()
            hz = await _http_get(ready["status_port"], "/healthz")
            return answers, closed, hz

        answers, closed, hz = asyncio.run(drive_d())
        exit_line, rc = worker.stop()
        err_tail = worker.err_tail()
    finally:
        worker.kill()
        shutil.rmtree(trace_root, ignore_errors=True)
    states = {sid: (0, 0, arc4.key_schedule(k)) for sid, k in keys.items()}
    bad = []
    datas = iter(answers[2:-2])
    for i in range(4):
        for sid in WORKER_SESSIONS:
            h, body = next(datas)
            ks, states[sid] = arc4.keystream_np(states[sid], chunks[sid][i].size)
            if not (h.get("ok") and body == (chunks[sid][i] ^ ks).tobytes()):
                bad.append((sid, i, h))
    hcode, hbody = hz
    hdoc = json.loads(hbody) if hcode == 200 else {}
    checks = {
        "opens and closes ok": all(h.get("ok") for h, _ in answers[:2] + answers[-2:]),
        "every chunk equal to the host PRGA": not bad,
        "data on a closed session: bad-request": closed[0].get("error") == "bad-request"
        and closed[1] == b"",
        "/healthz has its sessions section": "sessions" in hdoc
        and hdoc["compiles"]["steady"] == 0,
        "EXIT: lost 0, rc 0, sessions 2 opened and closed": exit_line.get("lost") == 0 and rc == 0
        and (exit_line.get("sessions") or {}).get("opened") == 2
        and exit_line["sessions"].get("closed") == 2,
    }
    log(f"session worker (--modes ctr,rc4): {len(answers)} ss answers, bad {bad[:3]}; closed-sid "
        f"answer {closed[0]}; /healthz sessions {hdoc.get('sessions')}; EXIT {exit_line} rc {rc}; "
        f"card: {card}")
    if not all(checks.values()):
        raise SystemExit(f"the session worker failed: {checks}; stderr {err_tail}")
    out["worker"] = {"sessions": len(WORKER_SESSIONS), "chunks": sum(map(len, chunks.values())),
                     "healthz_sessions": hdoc.get("sessions")}
    return out


#: Phase 15's native-engine drives: A's mix and D's mix on ``--engine native``.
NATIVE_DRIVE_A = ["--requests", "500", "--mixed-sizes", "--engine", "native"]
NATIVE_DRIVE_D = [*DRIVE_D, "--engine", "native"]
#: Keys of each size phase 15 (d) expands on the card.
SCHEDULE_KEYS = 1000
#: ``ot_bench`` arguments of phase 15 (f): the C rows and the gpu dispatch.
OT_BENCH_C = ["--backend=c", "--sizes=1,16", "--threads=1,8", "--iters=3", "--modes=ecb,ctr"]
OT_BENCH_GPU = ["--sizes=1", "--threads=1", "--iters=2", "--keybits=128", "--modes=ctr"]


def _masked_sweep(out: str) -> list[str]:
    """The sweep's lines with the times masked: a row's fields after its
    worker count, a keygen line's time, a line of times alone, a ``#
    derived:`` line whole."""
    lines = []
    for line in out.strip().splitlines():
        if line.startswith("# derived:"):
            line = "# derived:"
        elif m := re.match(r"^([^,]*[A-Za-z][^,]*, \d+, \d+,|Generated [^,]* in )(.*)$", line):
            line = m.group(1) + re.sub(r"[\d.e+-]+", "N", m.group(2))
        elif re.fullmatch(r"[\d.e+\-, ]+", line):
            line = re.sub(r"[\d.e+-]+", "N", line)
        lines.append(line)
    return lines


def selection_phase(card: str, reset_counts, counts, device: str = "cuda") -> dict:
    """Phase 15, engine selection and the port's entry: (a) ``entry()``; (b)
    the bench's probe stage in a child, the ``auto`` child and a dropped
    ``cuda`` in this process; (c) the device lock's children; (d) the device
    key schedules; (e) the native serve engine's drives and worker; (f)
    ``ot_bench``. Returns the launches for the ``kernels`` line. This
    process holds no device-lock marker, and every child gets a marker path
    of its own."""
    import numpy as np
    import sysconfig

    import torch

    from our_tree_tpu_torch import entry as entry_mod
    from our_tree_tpu_torch.models import aes
    from our_tree_tpu_torch.ops import cuda_aes, keyschedule
    from our_tree_tpu_torch.runtime import native
    from our_tree_tpu_torch.serve import bench as serve_bench
    from our_tree_tpu_torch.utils import packing, ranking

    t_phase = time.perf_counter()
    out: dict = {}
    cpu = cpu_model()
    tmp = tempfile.mkdtemp(prefix="ot_selection_")
    atexit.register(shutil.rmtree, tmp, True)

    # (a) entry(): one ctr_gen launch, equal to the plain version and to the
    # native C CTR on the same bytes.
    fn, args = entry_mod.entry(device)
    reset_counts()
    got = fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    launched = counts()
    words, ctr_be, rk = args
    plain = cuda_aes.ctr_crypt_words_fused_plain(words, ctr_be, rk, 10)
    data = packing.np_words_to_bytes(packing.words_numpy(words).reshape(-1))
    c_out, _ = native.NativeAES(entry_mod.KEY).ctr(np.frombuffer(entry_mod.NONCE, np.uint8),
                                                    np.asarray(data))
    want_launches = {n: int(n == "ctr_gen" and device == "cuda") for n in launched}
    checks = {
        "equal to the plain version": torch.equal(got, plain),
        "equal to the native C CTR": packing.np_words_to_bytes(
            packing.words_numpy(got).reshape(-1)).tobytes() == c_out.tobytes(),
        "one ctr_gen launch and nothing else": launched == want_launches,
    }
    log(f"entry(): fn(*args) over {tuple(words.shape)} words, {len(data)} bytes: launches "
        f"{ {k: v for k, v in launched.items() if v} }, equal to the plain version and the "
        f"native C CTR {checks}; card: {card}")
    if not all(checks.values()):
        raise SystemExit(f"phase 15 (a), entry(): {checks}")
    out["entry_launches"] = launched["ctr_gen"]

    # (b) and (c): the bench in children, each with its own ranking file and
    # marker path.
    rank_path = os.path.join(tmp, "engine_ranking.json")

    def bench_child(engine, busy, extra=None):
        env = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
        env.update(OT_BENCH_ENGINE=engine, OT_ENGINE_RANKING=rank_path,
                   OT_BENCH_BUSY_FILE=busy, **(extra or {}))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.bench"], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        try:
            line = json.loads(res.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            line = None
        for text in res.stderr.strip().splitlines():
            if text.startswith("#"):
                log(f"bench ({engine}): {text}")
        return res, line, wall

    probe_gbps: dict = {}
    if device == "cuda":
        key = aes.rank_key(device)
        busy = os.path.join(tmp, "gpu_busy_probe")
        res, line, wall = bench_child("probe", busy)
        os.environ["OT_ENGINE_RANKING"] = rank_path
        try:
            stored = ranking.load(key)
            probe_gbps = {r["engine"]: r["gbps"] for r in (stored or {}).get("ranking", [])}
        finally:
            del os.environ["OT_ENGINE_RANKING"]
        res2, line2, wall2 = bench_child("auto", os.path.join(tmp, "gpu_busy_auto"))
        checks = {
            "probe child rc 0": res.returncode == 0 and line is not None,
            f"digest {MAIN_DIGEST:#010x}": line is not None
            and f"digest={MAIN_DIGEST:#010x}" in line["metric"],
            "the headline on cuda": line is not None and "engine=cuda," in line["metric"],
            "the file holds cuda and ttable under the card's key, cuda first":
            stored is not None and [r["engine"] for r in stored["ranking"]] == ["cuda", "ttable"]
            and stored["source"] == "bench-probe" and stored["bytes"] == 256 << 20,
            "the auto child reports engine=cuda": res2.returncode == 0 and line2 is not None
            and "engine=cuda," in line2["metric"]
            and f"digest={MAIN_DIGEST:#010x}" in line2["metric"],
            "a normal child leaves no marker": not os.path.exists(busy)
            and not os.path.exists(os.path.join(tmp, "gpu_busy_auto")),
        }
        # cuda dropped in a temporary ranking: auto raises on the card.
        drop_path = os.path.join(tmp, "dropped.json")
        os.environ["OT_ENGINE_RANKING"] = drop_path
        try:
            ranking.store(key, {"cuda": 50.0, "ttable": 1.0}, "phase-15", 1)
            ranking.drop_engines(key, ["cuda"], reason="phase 15: a dropped kernel engine")
            try:
                aes.resolve_engine("auto", device)
                raised = None
            except RuntimeError as e:
                raised = str(e)
        finally:
            del os.environ["OT_ENGINE_RANKING"]
        checks["auto raises with cuda dropped"] = raised is not None and "phase 15" in raised
        log(f"bench probe child ({wall:.1f} s with start-up): {line}; ranking under {key!r}: "
            f"{stored}; auto child ({wall2:.1f} s): {line2}; with cuda dropped auto raised: "
            f"{raised!r}; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"phase 15 (b), the probe: {checks}; probe stderr "
                             f"{res.stderr[-2000:]!r}; auto stderr {res2.stderr[-2000:]!r}")
        out["probe"] = {"gbps": probe_gbps, "bytes": stored["bytes"], "headline": line,
                        "auto": line2, "wall_s": wall, "auto_wall_s": wall2}

        # (c) lock_busy: the child waits out 0.3 x OT_BENCH_DEADLINE, names the
        # holder, exits non-zero and prints no line.
        busy_c = os.path.join(tmp, "gpu_busy_c")
        res3, line3, wall3 = bench_child("auto", busy_c, {"OT_FAULTS": "lock_busy",
                                                          "OT_BENCH_DEADLINE": "10"})
        checks = {"non-zero exit": res3.returncode != 0,
                  "no GB/s line": "GB/s" not in res3.stdout and line3 is None,
                  "names the holder": "held by injected lock_busy" in res3.stderr,
                  "no marker left": not os.path.exists(busy_c)}
        log(f"bench under OT_FAULTS=lock_busy: rc {res3.returncode}, stdout {res3.stdout!r}, "
            f"{wall3:.1f} s; {checks}")
        if not all(checks.values()):
            raise SystemExit(f"phase 15 (c), the lock: {checks}; stderr {res3.stderr[-2000:]!r}")

    # (d) The device key schedules against the host ones.
    sched_bad = {}
    for bits in (128, 192, 256):
        rng = np.random.default_rng(bits)
        keys = rng.integers(0, 256, (SCHEDULE_KEYS, bits // 8), dtype=np.uint8)
        kw = packing.words_tensor(np.stack([packing.np_bytes_to_words(k) for k in keys]),
                                  device)
        nr, enc = keyschedule.expand_key_enc_device(kw, bits)
        _, dec = keyschedule.expand_key_dec_device(kw, bits)
        enc, dec = packing.words_numpy(enc), packing.words_numpy(dec)
        bad = 0
        for i, k in enumerate(keys):
            bad += int(not np.array_equal(enc[i], keyschedule.expand_key_enc(k.tobytes())[1]))
            bad += int(not np.array_equal(dec[i], keyschedule.expand_key_dec(k.tobytes())[1]))
        sched_bad[bits] = bad
    log(f"device key schedules on {device}: {SCHEDULE_KEYS} random keys of each size, "
        f"mismatching encrypt or decrypt schedules by key size {sched_bad}")
    if any(sched_bad.values()):
        raise SystemExit(f"phase 15 (d), the device key schedules: {sched_bad}")

    # (e) The native serve engine: A's and D's mixes, counted, then a worker.
    drives = {}
    for name, argv in (("native A", NATIVE_DRIVE_A), ("native D", NATIVE_DRIVE_D)):
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_bench.main(["--device", device, *argv])
        wall = time.perf_counter() - t0
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        got = counts()
        calls = line["per_mode"]["engine_calls"]
        gcm = sum(calls.get(m, 0) for m in GCM_SERVE_MODES)
        on_card = device == "cuda"
        checks = {
            "rc 0": rc == 0, "the native engine": line["engine"] == aes.NATIVE_ENGINE,
            "0 lost": line["lost"] == 0,
            "0 failed": line["errors"] == {} and line["ok"] == line["requests"],
            "0 mismatches": line["mismatches"] == 0 and line["verified"] > 0,
            "0 steady builds": line["recompiles"] == 0,
            "no ctr_mk launch for ctr": got["ctr_mk"] == (gcm if on_card else 0),
            "ghash_at calls == GCM engine calls": got["ghash_at"] == (gcm if on_card else 0),
            "cbc_mk launches == cbc engine calls": got["cbc_mk"] == (
                calls.get("cbc", 0) if on_card else 0),
            "no other kernel": all(v == 0 for n, v in got.items()
                                   if n not in ("ctr_mk", "ghash_at", "cbc_mk")),
        }
        if "--modes" in argv:
            checks["every mode served"] = all(calls.get(m, 0) > 0
                                              for m in ("ctr", "gcm", "gcm-open", "cbc"))
        lat = line["per_mode"]["latency"]
        log(f"serve {name} ({' '.join(argv)}): p50 {line['p50_ms']} ms, p99 {line['p99_ms']} ms, "
            f"goodput {line['goodput_gbps']} GB/s; by mode "
            + ", ".join(f"{m} p50 {v['p50_ms']} ms" for m, v in lat.items())
            + f"; engine calls {calls}; launches {got}; {wall:.1f} s wall; host CPU: {cpu}; "
            f"card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"phase 15 (e), serve {name}: {checks}")
        drives[name] = {"p50_ms": line["p50_ms"], "p99_ms": line["p99_ms"],
                        "goodput_gbps": line["goodput_gbps"], "engine_calls": calls,
                        "launches": got, "wall_s": wall}
    out["native_drives"] = drives

    from our_tree_tpu_torch.aead import gcm as agcm
    from our_tree_tpu_torch.aead import ghash as aghash
    from our_tree_tpu_torch.models.aes import AES, AES_DECRYPT

    wkey = bytes(range(16))
    wenv = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
    worker = _Worker(["--device", device, "--engine", "native", "--native-threads", "4",
                      "--modes", "ctr,cbc,gcm,gcm-open", "--port", "0", "--status-port", "0"],
                     wenv, os.path.join(tmp, "worker.err"))
    try:
        ready = worker.line(WORKER_READY_S)
        wrng = np.random.default_rng(15)
        pt = wrng.integers(0, 256, 4096, dtype=np.uint8)
        n16, iv16, iv12, aad = wrng.bytes(16), wrng.bytes(16), wrng.bytes(12), wrng.bytes(20)
        ct, tag = aghash.np_gcm_seal(wkey, iv12, aad, pt.tobytes())
        plain_ctx = AES(wkey, device="cpu")
        reqs = {
            "ctr": ({"t": "w", "k": wkey.hex(), "n": n16.hex()}, pt, plain_ctx.crypt_ctr(
                0, np.frombuffer(n16, np.uint8), np.zeros(16, np.uint8), pt)[0].tobytes()),
            "cbc": ({"t": "w", "k": wkey.hex(), "m": "cbc", "iv": iv16.hex()}, pt,
                    plain_ctx.crypt_cbc(AES_DECRYPT, np.frombuffer(iv16, np.uint8),
                                        pt)[0].tobytes()),
            "gcm": ({"t": "w", "k": wkey.hex(), "m": "gcm", "iv": iv12.hex(), "a": aad.hex()},
                    pt, agcm.gcm_seal(wkey, iv12, aad, pt.tobytes(), device="cpu")[0]),
            "gcm-open": ({"t": "w", "k": wkey.hex(), "m": "gcm-open", "iv": iv12.hex(),
                          "a": aad.hex(), "tg": tag.hex()}, np.frombuffer(ct, np.uint8),
                         pt.tobytes()),
        }

        async def exchange():
            got_w = {}
            for mode, (h, body, want) in reqs.items():
                got_h, got_b, _ = await _wire_request(ready["port"], h, body.tobytes())
                got_w[mode] = bool(got_h.get("ok")) and got_b == bytes(want) and (
                    mode != "gcm" or got_h.get("tg") == tag.hex())
            return got_w

        answers = asyncio.run(exchange())
        exit_line, rc = worker.stop()
    finally:
        worker.kill()
    checks = {"READY on the native engine": ready.get("engine") == aes.NATIVE_ENGINE,
              "each mode's exchange equal to the plain versions": all(answers.values())
              and len(answers) == 4,
              "EXIT lost 0, rc 0": exit_line.get("lost") == 0 and rc == 0}
    log(f"native worker (--engine native --native-threads 4): {answers}; EXIT {exit_line} rc "
        f"{rc}; {checks}")
    if not all(checks.values()):
        raise SystemExit(f"phase 15 (e), the native worker: {checks}; {worker.err_tail()}")

    # (f) ot_bench: the C rows, then the gpu dispatch through the embedded
    # interpreter against a direct harness run on the same arguments.
    exe = native.ot_bench_path()
    res = subprocess.run([str(exe), *OT_BENCH_C], capture_output=True, text=True, timeout=600)
    c_rows = harness_rows(res.stdout)
    log(f"ot_bench {' '.join(OT_BENCH_C)}: rc {res.returncode}; "
        + "; ".join(f"{r['row']}: {r['times_us']} µs" for r in c_rows)
        + f"; host CPU: {cpu}")
    arg = dict(a[2:].split("=", 1) for a in OT_BENCH_C)
    want_rows = (len(arg["sizes"].split(",")) * len(arg["threads"].split(","))
                 * len(arg["modes"].split(",")))
    if res.returncode != 0 or len(c_rows) != want_rows:
        raise SystemExit(f"phase 15 (f), ot_bench --backend=c: rc {res.returncode}, "
                         f"{res.stdout[-2000:]!r} {res.stderr[-2000:]!r}")
    out["ot_bench_c"] = c_rows
    if not native.ot_bench_embeds(exe):
        log("python3-config --embed does not answer on this machine: ot_bench is built without "
            "the embedded interpreter, and its --backend=gpu rows are not run")
        out["ot_bench_gpu"] = "not run: no python3-config"
    else:
        env = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
        env["PYTHONPATH"] = os.pathsep.join([ROOT, sysconfig.get_paths()["purelib"]] + (
            [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))
        res_g = subprocess.run([str(exe), "--backend=gpu", f"--device={device}", *OT_BENCH_GPU],
                               capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
        direct_argv = ["--backend", "gpu", "--device", device]
        for a in OT_BENCH_GPU:
            flag, val = a[2:].split("=", 1)
            direct_argv += [{"sizes": "--sizes-mb", "threads": "--workers"}.get(
                flag, f"--{flag}"), val]
        res_d = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.bench",
                                *direct_argv], capture_output=True, text=True, env=env,
                               timeout=600, cwd=ROOT)
        g_rows = harness_rows(res_g.stdout)
        checks = {"rc 0": res_g.returncode == 0 and res_d.returncode == 0,
                  "GPU rows": any(r["row"].startswith("GPU AES-128 CTR") for r in g_rows),
                  "lines equal a direct harness run": _masked_sweep(res_g.stdout)
                  == _masked_sweep(res_d.stdout)}
        log(f"ot_bench --backend=gpu {' '.join(OT_BENCH_GPU)}: "
            + "; ".join(f"{r['row']}: {r['times_us']} µs, {r['gbps']} GB/s" for r in g_rows)
            + f"; {checks}; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"phase 15 (f), ot_bench --backend=gpu: {checks}; "
                             f"{res_g.stdout[-1500:]!r} {res_g.stderr[-1500:]!r} "
                             f"{res_d.stdout[-1500:]!r}")
        out["ot_bench_gpu"] = g_rows
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15 (engine selection and entry): {out['wall_s']:.1f} s wall; card: {card}")
    return out


#: Phase 16's SLO bands for drive A's mix run twice on one card in one call,
#: in this process and in a fresh one: the host loop sets these latencies,
#: and the same drive's figures have moved up to 1.5x between runs (PERF.md
#: §6), the cost rows' card windows and the single stages more.
SLO_CARD_TOLERANCE = ("p50_ms=1.0,p95_ms=1.0,p99_ms=2.0,goodput_gbps=0.6,stage_p95_us=3.0,"
                      "cost_gbps=0.9")
#: The alert drill, the JAX package's (``tests/test_pulse.py:429-441``)
#: through the bench: every dispatch slowed 0.4 s past a 0.2 s watchdog, a
#: pulse tick every 50 ms over 1 s and 2 s windows, one event enough; closed
#: loop with one request in flight, as the JAX drill submits, so each
#: request fails in a batch of its own (the burn rate counts failed batches
#: over requests: about 20 in every window, against the page's 8) and the
#: drive (about 0.2 s a request) outlasts the slow window. An open loop at
#: 20 a second coalesced requests behind the failing canaries: 5 failed
#: batches a second over 20 requests, a burn of 5, which paged only on the
#: drive's tail and missed it when the tail was short.
DRILL_ENV = {"OT_FAULTS": "dispatch_slow", "OT_SLOW_S": "0.4", "OT_PULSE_EVERY_S": "0.05",
             "OT_PULSE_FAST_S": "1.0", "OT_PULSE_SLOW_S": "2.0", "OT_PULSE_MIN_EVENTS": "1",
             "OT_METRICS_FLUSH_S": "0.05"}
DRILL_DRIVE = ["--requests", "60", "--sizes", "64", "--bucket-min", "32", "--bucket-max", "64",
               "--lanes", "1", "--retries", "1", "--dispatch-deadline", "0.2",
               "--concurrency", "1"]
#: Phase 16 (e)'s drive: drive A's mix.
PULSE_COST_DRIVE = ["--requests", "500", "--mixed-sizes"]
#: Trace bytes a request (``request-queued``, its keycache counters) and a
#: batch (``batch-formed``, ``lane-dispatch``, two in-flight gauges, the
#: watchdog's arm) write, from the event sizes of a CPU run of drive D's
#: mix: phase 16 (a) sizes ``OT_TRACE_MAX_MB`` from drive D's counts so the
#: trace rotates (above a quarter of the cap) and keeps every segment
#: (under the whole cap).
OBS_TRACE_BYTES = (320, 960)
#: Environment phase 16 sets and restores.
OBS_ENV = ("OT_TRACE_DIR", "OT_TRACE_RUN", "OT_TRACE_MAX_MB", "OT_PULSE", "OT_PULSE_EVERY_S",
           "OT_METRICS_FLUSH_S")


def trace_now_us() -> int:
    return time.time_ns() // 1000


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(port: int, path: str):
    """(status, JSON body) of one GET on the status endpoint; (None, None)
    while nothing listens."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, None
    except (OSError, ValueError):
        return None, None


class StatusPoller(threading.Thread):
    """Phase 16 (a)'s observer while the drive runs: GETs ``/alertz`` and
    ``/healthz`` every 20 ms and keeps each one's last answer (a GET that
    found the endpoint already stopped at the drive's end is no answer and
    replaces none), and until the snapshot stream has rotated flushes the
    metrics registry at the same cadence (the drive lasts about a second;
    the flusher's own cadence is ``OT_METRICS_FLUSH_S``)."""

    def __init__(self, port: int, run_dir: str):
        super().__init__(daemon=True, name="phase16-poll")
        self.port, self.run_dir = port, run_dir
        self.alertz = self.healthz = None
        self.polls = 0
        self._halt = threading.Event()

    def run(self):
        import glob

        from our_tree_tpu_torch.obs import metrics

        while not self._halt.wait(0.02):
            if len(glob.glob(os.path.join(self.run_dir, "metrics-*.jsonl"))) < 2:
                metrics.flush_now()
            code, doc = _get_json(self.port, "/alertz")
            if code is None:
                continue
            self.polls += 1
            self.alertz = (code, doc)
            health = _get_json(self.port, "/healthz")
            if health[0] is not None:
                self.healthz = health

    def stop(self):
        self._halt.set()
        self.join(10)


def observability_phase(card: str, serve_drive, line_a: dict, line_d: dict, fresh_a: dict,
                        device: str = "cuda") -> dict:
    """Phase 16, the rest of observability over the serve drives: (a) drive
    D traced and rotated, its status endpoint polled; (b) the run read
    offline (``obs.report --check --trace-json``, ``obs.pulse --check``);
    (c) the ``dispatch_slow`` alert drill in a child; (d) the SLO gate green
    (phase 8's fresh drive A against drive A) and red (the drill), and the
    history ledger over the phase's artifacts; (e) drive A's mix with pulse
    off and on, alternating, and the fresh drive A's build line. Returns the
    ``pulse`` entry and the launches of (a) and (e) for the ``kernels``
    line."""
    import glob

    from our_tree_tpu_torch.obs import export, history, incident, slo
    from our_tree_tpu_torch.serve import bench as serve_bench

    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="ot_obs_")
    saved = {k: os.environ.get(k) for k in OBS_ENV}
    dev_args = [] if device == "cuda" else ["--device", device]
    out: dict = {}
    try:
        # (a) Drive D traced: the cap from drive D's requests and batches.
        est = (OBS_TRACE_BYTES[0] * line_d["requests"]
               + OBS_TRACE_BYTES[1] * line_d["batches"]["batches"])
        cap_mb = 2.0 * est / (1 << 20)
        run_a = os.path.join(scratch, "a", "obs-a")
        os.environ.update({"OT_TRACE_DIR": os.path.join(scratch, "a"), "OT_TRACE_RUN": "obs-a",
                           "OT_TRACE_MAX_MB": f"{cap_mb:.6f}", "OT_PULSE_EVERY_S": "0.5",
                           "OT_METRICS_FLUSH_S": "0.05"})
        os.environ.pop("OT_PULSE", None)
        port = free_port()
        poller = StatusPoller(port, run_a)
        poller.start()
        t0 = time.perf_counter()
        try:
            line, got, _forms = serve_drive("16 (a)", [*DRIVE_D, "--status-port", str(port)])
        finally:
            poller.stop()
        wall_a = time.perf_counter() - t0
        for k in ("OT_TRACE_DIR", "OT_TRACE_RUN", "OT_TRACE_MAX_MB", "OT_METRICS_FLUSH_S"):
            os.environ.pop(k, None)
        trace_files = sorted(glob.glob(os.path.join(run_a, "trace-*.jsonl")))
        metric_files = sorted(glob.glob(os.path.join(run_a, "metrics-*.jsonl")))
        a_code, a_doc = poller.alertz or (None, None)
        h_code, h_doc = poller.healthz or (None, None)
        checks = {
            "alerts 0": (line["alerts"] or {}).get("total") == 0,
            "/alertz 200 with no row": a_code == 200 and a_doc["total"] == 0
            and a_doc["alerts"] == [],
            "/healthz with capacity": h_code == 200 and "capacity" in (h_doc or {}),
            "the trace rotated, every segment kept": len(trace_files) >= 2 and any(
                re.search(r"trace-\d+-[0-9a-f]+\.jsonl$", f) for f in trace_files),
            "the snapshots rotated": len(metric_files) >= 2,
        }
        log(f"phase 16 (a) drive D traced (OT_TRACE_MAX_MB {cap_mb:.4f} from an estimated "
            f"{est} trace bytes): {len(trace_files)} trace and {len(metric_files)} snapshot "
            f"segment(s), {sum(os.path.getsize(f) for f in trace_files)} trace bytes; status "
            f"polled {poller.polls} times, /alertz {a_code} total "
            f"{(a_doc or {}).get('total')} frames {(a_doc or {}).get('frames')}, /healthz "
            f"{h_code} capacity {json.dumps((h_doc or {}).get('capacity'))}; pulse "
            f"{json.dumps(line['alerts'])}; p50 {line['p50_ms']} ms; launches {got}; "
            f"{wall_a:.1f} s wall; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"phase 16 (a): {checks}")
        out["launches_a"] = got
        out["a"] = {"trace_segments": len(trace_files), "metrics_segments": len(metric_files),
                    "trace_max_mb": cap_mb, "alertz_frames": a_doc["frames"],
                    "capacity": h_doc["capacity"]}

        # (b) The run read offline.
        env = {k: v for k, v in os.environ.items() if k not in OBS_ENV}
        env["OT_PULSE_EVERY_S"] = "0.5"
        chrome = os.path.join(scratch, "a.trace.json")
        rep = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.obs.report", run_a,
                              "--check", "--trace-json", chrome], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        rpl = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.obs.pulse", run_a,
                              "--check"], cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=300)
        run = export.load_run(run_a)
        dispatch = [s for s in run.spans.values() if s.name == "lane-dispatch"]
        try:
            with open(chrome) as fh:
                n_events = len(json.load(fh)["traceEvents"])
        except (OSError, ValueError, KeyError):
            n_events = None
        try:
            replay = json.loads(rpl.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            replay = {}
        checks = {
            "report --check rc 0": rep.returncode == 0,
            "the Chrome JSON loads": bool(n_events),
            "every lane-dispatch span closed": bool(dispatch) and all(
                s.end_ts is not None for s in dispatch),
            "pulse --check rc 0 (replay == live)": rpl.returncode == 0
            and replay.get("fired") == replay.get("live_fired") == {},
        }
        log(f"phase 16 (b) offline: report --check rc {rep.returncode}, {len(run.spans)} spans "
            f"({len(dispatch)} lane-dispatch, {len(run.orphans())} orphaned), "
            f"{len(run.violations)} violations, {len(run.snapshots)} snapshots; Chrome trace "
            f"{n_events} events; pulse replay rc {rpl.returncode}: {replay.get('frames')} "
            f"frames, fired {replay.get('fired')}, live {replay.get('live_fired')}")
        if not all(checks.values()):
            raise SystemExit(f"phase 16 (b): {checks}; report {rep.stderr[-1500:]!r}; pulse "
                             f"{rpl.stdout[-1500:]!r}")

        # (d) first half: drive A's line as the SLO baseline and the drill's
        # healthy twin (its flags without the fault) for the history ledger.
        hist = os.path.join(scratch, "hist")
        os.makedirs(hist)
        paths = {name: os.path.join(hist, f"SERVE_r0{i}.json") for i, name in
                 enumerate(("a", "fresh_a", "twin", "drill"), 1)}
        with open(paths["a"], "w") as fh:
            json.dump(line_a, fh)
        with open(paths["fresh_a"], "w") as fh:
            json.dump(fresh_a["line"], fh)
        twin, _, _ = serve_drive("16 (d) twin", [*DRILL_DRIVE, "--artifact", paths["twin"]])

        # (c) The alert drill in a child: a fresh incident recorder and faults.
        env_c = {**env, **DRILL_ENV, "OT_TRACE_DIR": os.path.join(scratch, "c"),
                 "OT_TRACE_RUN": "obs-c", "OT_CRASH_DIR": os.path.join(scratch, "crash")}
        t0 = time.perf_counter()
        drill = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.serve.bench",
                                *DRILL_DRIVE, *dev_args, "--slo", paths["a"], "--artifact",
                                paths["drill"]], cwd=ROOT, env=env_c, capture_output=True,
                               text=True, timeout=300)
        wall_c = time.perf_counter() - t0
        run_c = os.path.join(scratch, "c", "obs-c")
        try:
            with open(paths["drill"]) as fh:
                art = json.load(fh)
            d_line = json.loads(drill.stdout.strip().splitlines()[-1])
        except (OSError, ValueError, IndexError) as e:
            raise SystemExit(f"phase 16 (c): no artifact or line ({e}); rc {drill.returncode}, "
                             f"err {drill.stderr[-2000:]!r}")
        bundles = incident.list_bundles(run_c)
        inc = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.obs.report", run_c,
                              "--incidents", "--check"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        fails = [ln for ln in drill.stderr.splitlines() if ln.startswith("# FAIL")]
        page = art["metrics"]["counters"].get("pulse_alerts{rule=burn_rate,severity=page}", 0)
        checks = {
            "burn_rate fired": (art["alerts"] or {}).get("fired", {}).get("burn_rate", 0) >= 1,
            "pulse_alerts{rule=burn_rate,severity=page} >= 1": page >= 1,
            "exactly one bundle": len(bundles) == 1,
            "the bundle validates": len(bundles) == 1 and incident.validate_bundle(
                incident.load_bundle(bundles[0])) == [],
            "report --incidents --check rc 0": inc.returncode == 0,
            "0 lost": d_line["lost"] == 0,
            "exit 1 from the SLO gate alone": drill.returncode == 1 and len(fails) == 1
            and "SLO regression" in fails[0] and d_line.get("slo") == "fail",
        }
        reasons = [incident.load_bundle(b).get("reason") for b in bundles]
        log(f"phase 16 (c) drill ({' '.join(f'{k}={v}' for k, v in DRILL_ENV.items())} "
            f"{' '.join(DRILL_DRIVE)}): rc {drill.returncode}, alerts "
            f"{json.dumps(art['alerts']['fired'] if art['alerts'] else None)} over "
            f"{(art['alerts'] or {}).get('frames')} frames, pulse_alerts page {page}, errors "
            f"{d_line['errors']}, lost {d_line['lost']}, bundles {reasons}, report --incidents "
            f"rc {inc.returncode}; {wall_c:.1f} s wall with start-up; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"phase 16 (c): {checks}; stderr {drill.stderr[-2000:]!r}")

        # (d) The SLO gate green (phase 8's fresh drive A) and red (the drill),
        # then the history ledger over the four artifacts.
        buf = io.StringIO()
        red_rc = slo.gate(paths["a"], art, None, out=buf)
        named = sorted({m.group(1) for m in re.finditer(r"REGRESSION (\S+?):", buf.getvalue())})
        hout, herr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(hout), contextlib.redirect_stderr(herr):
            hist_rc = history.main(["--root", hist, "--check", "--tolerance",
                                    "goodput_gbps=0.9,utilization=0.9"])
        regress = [ln for ln in herr.getvalue().splitlines() if "REGRESSION" in ln]
        checks = {
            "green: the fresh drive A's --slo rc 0": fresh_a["rc"] == 0
            and fresh_a["line"].get("slo") == "pass",
            "red: slo.gate(drive A, the drill) rc 1": red_rc == 1,
            "red names alerts_total or a latency": bool(
                set(named) & {"alerts_total", "p50_ms", "p95_ms", "p99_ms"}),
            "history renders the four artifacts": all(
                os.path.basename(p) in hout.getvalue() for p in paths.values()),
            "history --check red on the drill alone": hist_rc == 1 and bool(regress) and all(
                "SERVE_r04.json" in ln for ln in regress)
            and any("errors_total" in ln for ln in regress),
            "twin healthy": twin["lost"] == 0 and twin["errors"] == {}
            and (twin["alerts"] or {}).get("total") == 0,
        }
        log(f"phase 16 (d) SLO: green rc {fresh_a['rc']} (tolerance {SLO_CARD_TOLERANCE}), red "
            f"rc {red_rc} naming {named}; history --check rc {hist_rc}: "
            + " | ".join(ln.split('REGRESSION ')[-1] for ln in regress))
        if not all(checks.values()):
            raise SystemExit(f"phase 16 (d): {checks}; slo {buf.getvalue()[-1500:]!r}; history "
                             f"{herr.getvalue()[-1500:]!r}")

        # (e) Pulse's cost: drive A's mix, pulse off and on, two turns each.
        turns = []
        # The on turns tick every 50 ms, 40 times the default cadence, so a
        # tick's cost shows inside a drive of a second or two.
        os.environ["OT_PULSE_EVERY_S"] = "0.05"
        for i, on in enumerate((0, 1, 0, 1)):
            os.environ["OT_PULSE"] = str(on)
            ln, got_e, _ = serve_drive(f"16 (e) pulse={on} #{i // 2 + 1}", PULSE_COST_DRIVE)
            turns.append({"pulse": on, "p50_ms": ln["p50_ms"], "p99_ms": ln["p99_ms"],
                          "goodput_gbps": ln["goodput_gbps"], "ctr_mk": got_e["ctr_mk"],
                          "frames": (ln["alerts"] or {}).get("frames"),
                          "alerts": (ln["alerts"] or {}).get("total")})
        os.environ.pop("OT_PULSE", None)
        off = [t for t in turns if not t["pulse"]]
        on_ = [t for t in turns if t["pulse"]]
        comp = fresh_a["compile"]
        checks = {
            "pulse off: no alerts section": all(t["alerts"] is None for t in off),
            "pulse on: 0 alerts": all(t["alerts"] == 0 for t in on_),
            "fresh A: 2 warmup builds by rung": comp["count"] == 2
            == fresh_a["line"]["compiles"]["warmup"] and comp["rungs"]
            and all(r != "0" for r in comp["rungs"]),
            "fresh A: 0 steady": fresh_a["line"]["compiles"]["steady"] == 0,
        }
        d50 = statistics.median(t["p50_ms"] for t in on_) - statistics.median(
            t["p50_ms"] for t in off)
        # A tick's own cost at the end-of-drive registry: the snapshot holds
        # the registry's lock; the frame and the rules run outside it.
        from our_tree_tpu_torch.obs import metrics, pulse

        eng = pulse.PulseEngine(emit=False)
        snap_us, tick_us = [], []
        for _ in range(200):
            t0 = time.perf_counter()
            snap = metrics.snapshot()
            t1 = time.perf_counter()
            eng.observe(pulse.frame_from_snapshot(snap, trace_now_us()))
            t2 = time.perf_counter()
            snap_us.append((t1 - t0) * 1e6)
            tick_us.append((t2 - t0) * 1e6)
        tick = {"snapshot_us_p50": statistics.median(snap_us),
                "tick_us_p50": statistics.median(tick_us), "series": sum(
                    len(snap[k]) for k in ("counters", "gauges", "hists"))}
        log("phase 16 (e) pulse cost, drive A's mix in turns (off, on, off, on): "
            + "; ".join(f"pulse={t['pulse']} p50 {t['p50_ms']} ms p99 {t['p99_ms']} ms goodput "
                        f"{t['goodput_gbps']} GB/s frames {t['frames']}" for t in turns)
            + f"; median p50 on - off {d50:+.3f} ms; a tick at the end-of-drive registry "
            f"({tick['series']} series): snapshot (the lock held) {tick['snapshot_us_p50']:.1f} "
            f"µs, whole tick {tick['tick_us_p50']:.1f} µs (median of 200); fresh A's build line: "
            f"{comp['text']}; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"phase 16 (e): {checks}")
        out["turns"] = turns
        out["launches_e"] = [t["ctr_mk"] for t in turns]
        out["pulse"] = {
            "a": {"alerts": line["alerts"]["total"], "frames": line["alerts"]["frames"],
                  "alertz": a_code, "trace_segments": len(trace_files),
                  "metrics_segments": len(metric_files)},
            "replay_ok": rpl.returncode == 0, "report_check_rc": rep.returncode,
            "drill": {"fired": art["alerts"]["fired"], "page_alerts": page,
                      "bundles": reasons, "incidents_check_rc": inc.returncode},
            "slo": {"green_rc": fresh_a["rc"], "red_rc": red_rc, "red_named": named,
                    "drill_bench_rc": drill.returncode},
            "history_rc": hist_rc,
            "compile": {"fresh_a": comp, "steady": fresh_a["line"]["compiles"]["steady"]},
            "pulse_cost": {"turns": turns, "median_p50_delta_ms": d50, "every_s": 0.05,
                           **tick},
        }
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(scratch, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    out["pulse"]["wall_s"] = out["wall_s"]
    log(f"phase 16 (observability): {out['wall_s']:.1f} s wall; card: {card}")
    return out


#: Phase 17: the routing tier, ``python -m our_tree_tpu_torch.route.bench``
#: in a child process a drive, each spawning its own port workers (``python
#: -m our_tree_tpu_torch.serve.worker --device cuda``) on this card. (a) The
#: acceptance drive (docs/SERVING.md, the routing tier's cookbook) at its
#: published size with the affinity A/B; (b) the backend-kill drive
#: (ROUTE_r01's flags, without its ``--slo`` baseline, which is the JAX
#: package's on another device); (c) the AEAD modes through the router
#: (ROUTE_r03's configuration); (d) the elasticity drive (ROUTE_r04's flags,
#: without ``--max-wire-p50-us 973``: the measured wire p50 is printed in
#: its place). (d)'s timeline is moved for the card, every gate kept: a port
#: worker comes ready in 9-12 s, and the autoscaler's one growth (decided by
#: the static triad, anywhere in the drive's first 13 s on the card) joins
#: 9-12 s after its decision, so the pool_stale fault is armed at +30 s
#: (not +6), after the join, and the drive is 8,000 requests at 150 a
#: second (not 4,000) so that traffic still flows then; the roll starts at
#: +34 s (not +28) and the settle window is 60 s (not 45). The router kill
#: stays at +14 s. (a) is also the fleet-causal drive (docs/SERVING.md,
#: the cookbook's sampled cross-process tracing: ``OT_TRACE_SAMPLE=0.25``,
#: ``--status-port 0``, waterfalls gated complete on 0.99 and within 5 % on
#: 0.95, then ``obs.report --min-join-frac 0.9``); (c) sends ``cbc`` too;
#: (e) is the mid-transfer kill drive (STREAM_r01's cookbook flags, with
#: its CI step's sizing: ``--worker-lanes 2 --dispatch-deadline 2``, so the
#: hung lane fails over inside its worker before the router's 5 s attempt
#: timeout). Each drive: (argv, environment, time limit in seconds);
#: ``{scratch}`` in either stands for the phase's temporary directory.
ROUTE_DRIVES = {
    "a": (["--backends", "3", "--requests", "1500", "--arrival-rate", "250", "--mixed-sizes",
           "--tenants", "12", "--ab", "--status-port", "0", "--min-waterfall-complete", "0.99",
           "--min-stage-sum-ok", "0.95"],
          {"OT_TRACE_SAMPLE": "0.25", "OT_TRACE_DIR": "{scratch}/a_trace"}, 240),
    "b": (["--backends", "3", "--requests", "1500", "--arrival-rate", "250", "--mixed-sizes",
           "--attempt-timeout", "1.5", "--gossip-every", "0.25", "--require-zero-errors",
           "--expect-quarantines", "1", "--expect-releases", "1", "--min-redispatch", "1"],
          {"OT_FAULTS": "backend_hang:1@backend=1"}, 180),
    "c": (["--backends", "3", "--requests", "600", "--modes", "ctr,gcm,gcm-open,cbc", "--sizes",
           "16,64,256,1024,4096,16384", "--attempt-timeout", "1.5", "--gossip-every", "0.25"],
          {}, 180),
    "d": (["--autoscale", "--backends", "1", "--fleet-max", "2", "--fleet-policy", "headroom",
           "--requests", "8000", "--arrival-rate", "150", "--sizes", "1024,4096,16384",
           "--worker-queue-depth", "8", "--deadline", "60", "--up-depth", "0.5",
           "--down-depth", "0.0", "--settle-ticks", "3", "--down-settle-ticks", "100",
           "--cooldown", "3.0", "--poll-every", "0.2", "--roll-after", "34", "--routers", "1",
           "--kill-router-after", "14", "--drive-faults", "pool_stale:1@backend=0",
           "--drive-faults-after", "30", "--settle-timeout", "60", "--require-zero-errors",
           "--min-scale-ups", "1", "--min-scale-downs", "1", "--expect-rolls", "1",
           "--min-client-failovers", "1", "--min-redispatch", "1"], {}, 300),
    "e": (["--backends", "2", "--requests", "600", "--arrival-rate", "120", "--sizes",
           "1024,16384,262144", "--bucket-max", "262144", "--transfer-sizes", "67108864",
           "--transfer-every", "64", "--transfer-ledger", "{scratch}/tx.jsonl",
           "--kill-backend-after", "2.0", "--worker-faults", "lane_hang:1", "--resume-drill",
           "--min-chunk-redispatch", "1", "--require-zero-errors", "--expect-quarantines", "1",
           "--worker-lanes", "2", "--dispatch-deadline", "2"],
          {"OT_FAULTS": "chunk_lost:1"}, 240),
}
#: Drives whose trace directory (``OT_TRACE_DIR``) ``python -m
#: our_tree_tpu_torch.obs.report`` reads after the drive, with these flags;
#: it must exit 0.
ROUTE_REPORTED = {"a": ["--min-join-frac", "0.9"]}
#: The serve kernels a worker of each drive's modes may launch, by the engine
#: calls (mode) each launch stands for; any other kernel launched fails.
ROUTE_KERNEL_CALLS = {"ctr_mk": ("ctr", "gcm", "gcm-open"), "ghash_at": ("gcm", "gcm-open"),
                      "cbc_mk": ("cbc",)}
#: The modes drive (c) sends, each of whose probes must verify.
ROUTE_AEAD_MODES = ("ctr", "gcm", "gcm-open", "cbc")


#: Fleet events within this many seconds of a given-up request are logged
#: with a failed drive's record.
EVIDENCE_WINDOW_S = 15.0


def route_evidence(name: str, doc: dict) -> None:
    """Log a failed phase 17 drive's record from its artifact, before the
    scratch directory that holds it is removed: the request errors; each
    request the failover client gave up on (its detail, every attempt's
    peer, outcome and seconds, and its time since the drive began); the
    client's failovers and backpressure retries; each router's attempt
    outcomes by back end and its redispatches; each worker's exit; and
    the fleet events within ``EVIDENCE_WINDOW_S`` of a given-up request
    (all of them when none was recorded)."""
    load = doc.get("load") or {}
    log(f"route {name} record: errors {load.get('errors')}, requests {load.get('requests')}, "
        f"ok {load.get('ok')}")
    client = (doc.get("routers") or {}).get("client") or {}
    if client:
        log(f"route {name} record: client failovers {client.get('failovers')}, "
            f"backpressure_retries {client.get('backpressure_retries')}, peers "
            f"{client.get('peers')}, attempt timeout {client.get('attempt_timeout_s')} s")
    if client:
        log(f"route {name} record: client attempts by outcome {client.get('attempt_outcomes')}; "
            f"slow attempts (+s since the drive began, peer, outcome, s) "
            f"{client.get('slow_attempts')}")
    gave_up = client.get("failures") or []
    for f in gave_up:
        log(f"route {name} record: gave up at +{f['t_s']} s after {f['wall_s']} s (deadline "
            f"{f['deadline_s']} s): {f['detail']}; attempts " + ", ".join(
                f"{p} {o} {t} s" for p, o, t in f["attempts"]))
    router = doc.get("router") or {}
    log(f"route {name} record: router redispatches {router.get('redispatches')}, shed retries "
        f"{router.get('shed_retries')}, quarantine events {router.get('quarantine_events')}; by "
        f"back end " + "; ".join(
            f"{b}: dispatches {st.get('dispatches')} failures {st.get('failures')} timeouts "
            f"{st.get('timeouts')} redispatches_in {st.get('redispatches_in')} pool "
            f"{st.get('pool')} state {st.get('state')}"
            for b, st in (router.get("backends") or {}).items()))
    for r in (doc.get("routers") or {}).get("docs") or []:
        log(f"route {name} record: replica {r.get('name')} killed {r.get('killed')} rc "
            f"{r.get('rc')} accepted {r.get('accepted')} answered {r.get('answered')} "
            f"redispatches {r.get('redispatches')} by back end {r.get('backends')}")
    for w in doc.get("workers") or []:
        log(f"route {name} record: worker {w.get('name')} rc {w.get('rc')} lost {w.get('lost')} "
            f"engine calls {w.get('diag_engine_calls')}")
    fleet = doc.get("fleet") or {}
    t0 = fleet.get("t0")
    for ev in fleet.get("events") or []:
        at = ev["t_s"] - t0 if t0 is not None else None
        if at is None or not gave_up or any(
                abs(at - f["t_s"]) <= EVIDENCE_WINDOW_S for f in gave_up):
            log(f"route {name} record: fleet event {ev.get('kind')} worker {ev.get('worker')} "
                f"size {ev.get('size')} epoch {ev.get('epoch')}"
                + (f" at +{at:.1f} s" if at is not None else ""))


def route_phase(card: str, device: str = "cuda", drives=None) -> dict:
    """Phase 17: each drive of ``ROUTE_DRIVES`` through the routing tier in a
    child process, its artifact written to a temporary file and read back.
    Gates, every drive: rc 0 (the bench's own gates: zero lost at the router
    and in every worker's EXIT line, bit-exact probes, zero builds after
    warmup across the fleet, and each drive's fault, elasticity and
    waterfall gates); no request error; every worker, both arms of the A/B
    included, drained with rc 0 and lost 0, but for a worker the drive
    SIGKILLed, which has no EXIT line and is skipped, and said so; in each
    worker ``ctr_mk`` launches equal to its ``ctr``, ``gcm`` and ``gcm-open``
    engine calls, ``ghash_at`` calls equal to its ``gcm`` and ``gcm-open``
    ones, ``cbc_mk`` launches equal to its ``cbc`` ones, and no other kernel
    (on the CPU: no launch at all); the router's process made no CUDA
    context. (a) must show affinity's keycache hit ratio above random
    routing's and complete waterfalls, and ``obs.report --min-join-frac
    0.9`` over its trace must exit 0; (c) every mode's probes verified; (d)
    no alert fired; (e) a chunk redispatched, every transfer served, the
    resume drill byte-identical with only unacked chunks re-sent, no bytes
    held and no live ledger entry. A failed drive's record is logged
    (``route_evidence``) before the temporary directory is removed. Returns
    each drive's line, its workers' launches and the phase's wall."""
    t_phase = time.perf_counter()
    drives = ROUTE_DRIVES if drives is None else drives
    scratch = tempfile.mkdtemp(prefix="ot_route_")
    out = {"drives": {}}
    try:
        for name, (argv, env, limit) in drives.items():
            art = os.path.join(scratch, f"{name}.json")
            argv = [a.replace("{scratch}", scratch) for a in argv]
            env = {k: v.replace("{scratch}", scratch) for k, v in env.items()}
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "our_tree_tpu_torch.route.bench", *argv, "--device",
                 device, "--artifact", art], cwd=ROOT, capture_output=True, text=True,
                timeout=limit, env={**os.environ, **env})
            wall = time.perf_counter() - t0
            try:
                line = json.loads(res.stdout.strip().splitlines()[-1])
                doc = json.load(open(art, encoding="utf-8"))
            except (IndexError, ValueError, OSError) as e:
                raise SystemExit(f"phase 17 ({name}): no line or artifact ({e}); rc "
                                 f"{res.returncode}; stderr {res.stderr[-3000:]!r}")
            every = list(doc["workers"]) + list((doc.get("control") or {}).get("workers") or [])
            killed = [w for w in every if w.get("killed")]
            workers = [w for w in every if not w.get("killed")]
            if killed:
                log(f"route {name}: the worker checks skip {len(killed)} worker(s) SIGKILLed by "
                    f"the drive ({doc.get('killed_backend')}, rc "
                    f"{[w.get('rc') for w in killed]}), which print no EXIT line")
            bad_launch = []
            launches = {}
            per_worker = []
            for i, w in enumerate(workers):
                calls = w.get("diag_engine_calls") or {}
                got = w.get("diag_launches") or {}
                for kname, n in got.items():
                    launches[kname] = launches.get(kname, 0) + n
                per_worker.append(f"{w.get('name') or f'#{i}'}: launches "
                                  f"{ {k: n for k, n in got.items() if n} } engine calls {calls}")
                # On the card each serve kernel once an engine call of its
                # modes and no other kernel; on the CPU no launch at all.
                want = {k: sum(calls.get(m, 0) for m in ROUTE_KERNEL_CALLS.get(k, ()))
                        if device == "cuda" else 0 for k in got}
                if not got or got != want:
                    bad_launch.append((w.get("name"), calls, got))
            checks = {
                "rc 0": res.returncode == 0,
                "0 lost": line.get("lost") == 0,
                "0 request errors": not line.get("errors"),
                "probes bit-exact": line.get("mismatches") == 0
                and doc["load"].get("verified", 0) > 0,
                "0 builds after warmup": line.get("recompiles") == 0,
                "every worker drained, rc 0, lost 0": bool(workers) and all(
                    w.get("rc") == 0 and w.get("lost") == 0 for w in workers),
                "launches = engine calls, no other kernel": not bad_launch,
                "router made no CUDA context": line.get("router_cuda_initialized") in (False, None),
            }
            if name == "a":
                checks["affinity's keycache hit ratio above random's"] = (
                    line["keycache_hit_ratio"] > line.get("keycache_hit_ratio_random", 1.0))
            if name == "c":
                modes = doc["load"].get("modes") or {}
                checks["every mode's probes verified"] = all(
                    (modes.get(m) or {}).get("verified", 0) > 0 for m in ROUTE_AEAD_MODES)
                log(f"route c: verified probes by mode (each gcm probe's ciphertext and tag "
                    f"against the host GCM) " + ", ".join(
                        f"{m} {v.get('verified')}/{v.get('requests')}" for m, v in modes.items()))
            if name == "d":
                checks["no alert fired"] = not (doc.get("alerts") or {}).get("total")
            if name == "e":
                tx = (doc.get("transfers") or {}).get("router") or {}
                resume = doc.get("resume") or {}
                checks.update({
                    "a chunk redispatched": line.get("chunk_redispatches", 0) >= 1,
                    "every transfer served": (line.get("transfers") or {}).get("ok")
                    == (line.get("transfers") or {}).get("requests", -1) > 0,
                    "resume drill byte-identical, only unacked re-sent": line.get("resume")
                    == "pass" and bool(resume.get("byte_identical"))
                    and bool(resume.get("resent_only_unacked")),
                    "no bytes held, no live ledger entry": tx.get("held_bytes") == 0
                    and tx.get("ledger_live") == 0})
                log(f"route e: transfers {line.get('transfers')}, chunk redispatches "
                    f"{line.get('chunk_redispatches')}, resume {resume.get('first')} then "
                    f"{resume.get('second')}, killed {doc.get('killed_backend')}")
            if name in ROUTE_REPORTED:
                rep = subprocess.run(
                    [sys.executable, "-m", "our_tree_tpu_torch.obs.report", env["OT_TRACE_DIR"],
                     *ROUTE_REPORTED[name]], cwd=ROOT, capture_output=True, text=True,
                    timeout=300)
                joined = [ln.strip() for ln in rep.stdout.splitlines()
                          if ln.startswith("fleet join")]
                checks[f"obs.report {' '.join(ROUTE_REPORTED[name])} rc 0"] = rep.returncode == 0
                log(f"route {name}: obs.report rc {rep.returncode}: {joined}"
                    + (f"; stderr {rep.stderr[-600:]!r}" if rep.returncode else ""))
            wf = doc.get("waterfall") or {}
            stage_p50 = {st: v.get("p50_us") for st, v in (wf.get("stages") or {}).items()}
            tail = [ln for ln in res.stdout.splitlines() if ln.startswith("#")]
            for ln in tail:
                log(f"route {name}: {ln}")
            log(f"route {name} ({' '.join(argv)}{' ' + str(env) if env else ''}): rc "
                f"{res.returncode}, {wall:.1f} s wall; p50 {line.get('p50_ms')} ms, p99 "
                f"{line.get('p99_ms')} ms, goodput {line.get('goodput_gbps')} GB/s; waterfalls "
                f"complete {wf.get('complete')}/{wf.get('sampled')}, stage sum within 5 % on "
                f"{wf.get('sum_within_tol_frac')}; stage p50s of the complete waterfalls "
                f"{stage_p50} us; workers' launches {launches}; per worker "
                f"{'; '.join(per_worker)}; checks {checks}; card: {card}")
            if not all(checks.values()):
                route_evidence(name, doc)
                raise SystemExit(f"phase 17 ({name}): {checks}; bad launches {bad_launch}; stderr "
                                 f"{res.stderr[-3000:]!r}")
            out["drives"][name] = {"line": line, "launches": launches, "wall_s": wall,
                                   "workers": len(workers), "stage_p50_us": stage_p50}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 17 (routing tier): {out['wall_s']:.1f} s wall; card: {card}")
    return out


def multi_rank(transport: str, out_dir: str) -> int:
    """One rank of phase 18, in a child process: ``transport`` ``nccl`` is
    the world of one (``dryrun_multichip(1)`` in a world of its own, then a
    world of one joined through ``multihost.initialize``), ``gloo`` a rank
    under ``python -m torch.distributed.run`` on this card. Runs
    ``dryrun_multichip`` and the full-width steps, each counted, timed and
    gathered against the unsharded call, and writes ``rank<r>.json``."""
    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.distributed as tdist

    from our_tree_tpu_torch import bench, entry
    from our_tree_tpu_torch.models import aes, arc4
    from our_tree_tpu_torch.ops import cuda_aes, cuda_arc4
    from our_tree_tpu_torch.parallel import dist, multihost
    from our_tree_tpu_torch.utils import packing

    wrappers = {"ctr_gen": cuda_aes.ctr_crypt_words_fused, "ecb_encrypt": cuda_aes.encrypt_words,
                "ecb_decrypt": cuda_aes.decrypt_words, "seq_encrypt": cuda_aes.seq_encrypt,
                "arc4_prga": cuda_arc4.prga}
    t0 = time.perf_counter()
    store = None
    if transport == "nccl":
        entry.dryrun_multichip(1)  # no world yet: one of its own, on NCCL
        store = tempfile.mkdtemp(prefix="ot_multi_")
        multihost.initialize(f"file://{os.path.join(store, 'store')}", 1, 0)
    else:
        multihost.initialize_from_env(device="cuda", backend="gloo")
        entry.dryrun_multichip(tdist.get_world_size())
    mesh = multihost.global_mesh()
    dev = mesh.device
    # The transport's first collective sets it up (NCCL makes its
    # communicator): outside the timed steps.
    dist.gather_for_verification(torch.zeros(4, dtype=torch.int32, device=dev), mesh)
    rec = {"world": mesh.size, "rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
           "dryrun_s": time.perf_counter() - t0, "steps": {}}

    def step(name, run, want, rows):
        """``run()`` gives this rank's output shard: counted, timed, then
        gathered and compared with the unsharded call's ``want``."""
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        dist.reset_collectives()
        t0 = time.perf_counter()
        local = run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        whole = dist.gather_for_verification(local, mesh, rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll = dist.COLLECTIVES
        rec["steps"][name] = {"wall_s": wall, "call_s": t1 - t0, "collective_s": coll["seconds"],
                              "collective_share": coll["seconds"] / wall,
                              "collectives": {k: v["calls"] for k, v in coll["by_name"].items()},
                              "launches": launches, "equal": bool(torch.equal(whole, want))}
        return local

    def words_of(hexbytes):
        return packing.words_tensor(packing.np_bytes_to_words(
            np.frombuffer(bytes.fromhex(hexbytes), np.uint8)), dev)

    # CTR over the 256 MiB headline buffer: the bench's key, nonce and data.
    host = np.random.default_rng(bench.SEED).integers(0, 256, MAIN_BYTES, dtype=np.uint8)
    words = packing.words_tensor(packing.np_bytes_to_words(host), dev).reshape(-1, 4)
    del host
    n = words.shape[0]
    a = aes.AES(bench.KEY, device=dev)
    ctr = packing.words_tensor(packing.np_bytes_to_words(
        np.frombuffer(bench.NONCE, np.uint8)).byteswap(), dev)
    local = dist.shard_rows(words, mesh, words=True)
    want = aes.ctr_crypt_words(words, ctr, a.rk_enc, a.nr)
    step("ctr", lambda: dist.ctr_crypt_sharded(local, ctr, a.rk_enc, a.nr, mesh), want, n)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        dist.ctr_crypt_sharded(local, ctr, a.rk_enc, a.nr, mesh)
    stop.record()
    stop.synchronize()
    rec["ctr_ms"] = start.elapsed_time(stop) / 20
    rec["ctr_gbps"] = local.numel() * 4 / rec["ctr_ms"] / 1e6

    # The decrypts over the same buffer: ECB, and the CBC and CFB128 halos.
    iv = words_of(BLOCK_IV)
    want = aes.ecb_decrypt_words(words, a.rk_dec, a.nr)
    step("ecb-dec", lambda: dist.ecb_crypt_sharded(local, a.rk_dec, a.nr, mesh, encrypt=False),
         want, n)
    chained = dist.shard_rows(words, mesh, words=True, chained=True)
    want = aes.cbc_decrypt_words(words, iv, a.rk_dec, a.nr)[0]
    step("cbc-dec", lambda: dist.cbc_decrypt_sharded(chained, iv, a.rk_dec, a.nr, mesh), want, n)
    want = aes.cfb128_decrypt_words(words, iv, a.rk_enc, a.nr)[0]
    step("cfb128-dec", lambda: dist.cfb128_decrypt_sharded(chained, iv, a.rk_enc, a.nr, mesh),
         want, n)
    del want, words, local, chained
    torch.cuda.empty_cache()

    # Phase 5's CBC batch: 4,096 streams of 64 blocks.
    gen = torch.Generator(dev).manual_seed(5)
    bw = torch.randint(-2**31, 2**31, (BATCH_STREAMS, BATCH_BLOCKS, 4), dtype=torch.int32,
                       device=dev, generator=gen)
    bivs = torch.randint(-2**31, 2**31, (BATCH_STREAMS, 4), dtype=torch.int32, device=dev,
                         generator=gen)
    want = aes.cbc_encrypt_words_batch(bw, bivs, a.rk_enc, a.nr)[0]
    step("cbc-batch", lambda: dist.cbc_encrypt_batch_sharded(
        dist.shard_rows(bw, mesh), dist.shard_rows(bivs, mesh), a.rk_enc, a.nr, mesh)[0],
         want, BATCH_STREAMS)

    # rc4-batch's keystreams: 32 streams of 2^20 bytes.
    rng = np.random.default_rng(7)
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(ARC4_BATCH[0])]
    states = arc4.ARC4.batch_states(keys, dev)
    want = arc4.keystream_scan_batch(states, ARC4_BATCH[1])[1]
    step("arc4-batch", lambda: dist.arc4_prep_batch_sharded(
        dist.shard_rows(states, mesh), ARC4_BATCH[1], mesh)[1], want, ARC4_BATCH[0])

    # The all-to-all over 64 MiB: round-robin rows in, the contiguous range out.
    g = torch.randint(-2**31, 2**31, (A2A_BYTES // 16, 4), dtype=torch.int32, device=dev,
                      generator=gen)
    cyclic = g[mesh.rank::mesh.size].contiguous()
    step("all-to-all", lambda: dist.block_cyclic_to_contiguous(cyclic, mesh), g, g.shape[0])

    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(rec, fh)
    multihost.shutdown()
    if store is not None:
        shutil.rmtree(store, ignore_errors=True)
    return 0


def multidevice_phase(card: str, headline_gbps: float) -> dict:
    """Phase 18: the world of one on NCCL and the gloo worlds of
    ``GLOO_WORLDS`` ranks on this card, each in child processes
    (``multi_rank``). Gates, every world and rank: rc 0, every step's gathered
    output equal to the unsharded call's, each step one launch of its
    kernel and no other. Returns each world's ranks' records and the
    kernels' launches by world."""
    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="ot_multi_")
    me = os.path.join(ROOT, "chip_smoke.py")
    worlds = {"1 nccl": (1, [sys.executable, me, "--multi-rank", "nccl"])}
    for n in GLOO_WORLDS:
        worlds[f"{n} gloo"] = (n, [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                   "--nproc-per-node", str(n), me, "--multi-rank", "gloo"])
    out = {"worlds": {}, "launches_by_world": {}}
    try:
        for name, (n, argv) in worlds.items():
            d = os.path.join(scratch, name.replace(" ", "_"))
            os.makedirs(d)
            res, wall = run_group(argv + [d], MULTI_TIMEOUT)
            ranks = []
            for r in range(n):
                try:
                    with open(os.path.join(d, f"rank{r}.json"), encoding="utf-8") as fh:
                        ranks.append(json.load(fh))
                except (OSError, ValueError) as e:
                    raise SystemExit(f"phase 18 ({name}): rank {r} wrote no record ({e}); rc "
                                     f"{res.returncode}; stderr {res.stderr[-4000:]!r}")
            bad = []
            for r in ranks:
                for step_name, st in r["steps"].items():
                    kernel = MULTI_STEP_KERNEL[step_name]
                    want = {k: int(k == kernel) for k in st["launches"]}
                    if not st["equal"] or st["launches"] != want:
                        bad.append((r["rank"], step_name, st["equal"], st["launches"]))
            checks = {"rc 0": res.returncode == 0,
                      "every step on every rank": all(set(r["steps"]) == set(MULTI_STEP_KERNEL)
                                                      for r in ranks),
                      "gathered equal to unsharded, one launch of the step's kernel": not bad,
                      "transport": all(r["backend"] == name.split()[1] for r in ranks)}
            for step_name in MULTI_STEP_KERNEL:
                walls = [r["steps"][step_name]["wall_s"] for r in ranks if step_name in r["steps"]]
                shares = [r["steps"][step_name]["collective_share"] for r in ranks
                          if step_name in r["steps"]]
                if walls:
                    log(f"multi-device {name} {step_name}: wall {max(walls) * 1e3:.2f} ms "
                        f"(slowest rank), collectives {100 * min(shares):.1f}-"
                        f"{100 * max(shares):.1f} % of it; launches by rank "
                        + "; ".join(f"r{r['rank']} " + str({k: v for k, v in
                                    r['steps'][step_name]['launches'].items() if v})
                                    for r in ranks) + f"; card: {card}")
            gbps = [r["ctr_gbps"] for r in ranks]
            log(f"multi-device {name}: {wall:.1f} s wall (dryrun_multichip and start-up "
                f"{max(r['dryrun_s'] for r in ranks):.1f} s); sharded CTR "
                + ", ".join(f"r{r['rank']} {g:.2f} GB/s ({r['ctr_ms']:.4f} ms a shard)"
                            for r, g in zip(ranks, gbps))
                + f" beside phase 4's headline {headline_gbps} GB/s; checks {checks}; card: {card}")
            if not all(checks.values()):
                raise SystemExit(f"phase 18 ({name}): {checks}; bad {bad[:8]}; stderr "
                                 f"{res.stderr[-3000:]!r}")
            out["worlds"][name] = {"ranks": ranks, "wall_s": wall}
            out["launches_by_world"][name] = {
                k: sum(st["launches"][k] for r in ranks for st in r["steps"].values())
                for k in MULTI_KERNELS}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 18 (multi-device): {out['wall_s']:.1f} s wall; launches by world "
        f"{out['launches_by_world']}; no run across cards (one card; NCCL takes no two ranks "
        f"on one device); card: {card}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from our_tree_tpu_torch import bench
    from our_tree_tpu_torch.harness import ceiling
    from our_tree_tpu_torch.models import aes, arc4
    from our_tree_tpu_torch.ops import bitslice, cuda_aes, cuda_arc4, cuda_ghash
    from our_tree_tpu_torch.ops.keyschedule import (dec_schedule_from_enc, expand_key_dec,
                                                    expand_key_enc)
    from our_tree_tpu_torch.runtime import cuda_build
    from our_tree_tpu_torch.utils import packing

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    wrappers = {"ctr_gen": cuda_aes.ctr_crypt_words_fused,
                "ecb_encrypt": cuda_aes.encrypt_words,
                "ecb_decrypt": cuda_aes.decrypt_words,
                "ctr_mk": cuda_aes.ctr_scattered_multikey,
                "ctr_mk_k1": cuda_aes.ctr_crypt_words_explicit,
                "cbc_mk": cuda_aes.cbc_scattered_multikey,
                "chain": ceiling.chain,
                "seq_encrypt": cuda_aes.seq_encrypt,
                "arc4_prga": cuda_arc4.prga,
                "ghash_scan": cuda_ghash.ghash_scan,
                "ghash_at": cuda_ghash.ghash_at}
    mk_wrappers = {"ctr_mk": cuda_aes.ctr_scattered_multikey,
                   "ctr_mk_k1": cuda_aes.ctr_crypt_words_explicit,
                   "ecb_encrypt": cuda_aes.encrypt_words,
                   "ctr_gen": cuda_aes.ctr_crypt_words_fused,
                   "seq_encrypt": cuda_aes.seq_encrypt}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for fn in mk_wrappers.values():
            fn.form_launches = {form: 0 for form in fn.form_launches}

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def form_counts():
        """``ctr_mk``, ECB encrypt, ``ctr_gen`` and ``seq_encrypt`` launches
        by the form that ran, per wrapper."""
        return {name: dict(fn.form_launches) for name, fn in mk_wrappers.items()}

    # Each phase's wall time, printed on one line before the kernels line.
    walls: dict = {}
    mark = {"name": "start-up", "t": T_START}

    def phase(name: str | None) -> None:
        now = time.perf_counter()
        walls[mark["name"]] = round(now - mark["t"], 1)
        mark.update(name=name, t=now)

    # 1. Build.
    phase("1")
    t0 = time.perf_counter()
    lib_path = str(cuda_build.library_path())
    # Phase 9's probes (the shared-memory chase and the empty kernel) build
    # beside the kernels, at once, one nvcc each.
    probe_dir = tempfile.mkdtemp(prefix="ot_probes_")
    atexit.register(shutil.rmtree, probe_dir, True)
    probe_builds = {}
    for name, source in (("chase", CHASE_SOURCE), ("empty", EMPTY_SOURCE),
                         ("seq_parent", SEQ_PARENT_SOURCE)):
        cu, so = os.path.join(probe_dir, f"{name}.cu"), os.path.join(probe_dir, f"{name}.so")
        with open(cu, "w", encoding="utf-8") as fh:
            fh.write(source)
        probe_builds[name] = (so, subprocess.Popen(
            [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", cuda_build.ARCH, "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{cuda_build.CSRC}",
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    cuda_build.load()
    for name, (so, proc) in probe_builds.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise SystemExit(f"the {name} probe did not build:\n{err[-3000:]}")
    chase_so, empty_so, seq_parent_so = (probe_builds[k][0]
                                         for k in ("chase", "empty", "seq_parent"))
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(lib_path)} (and the "
        f"shared-memory and shuffle chases, the empty kernel and seq_encrypt's parent kernel)")
    ptxas = cuda_build.ptxas_kernels()
    for name, info in sorted(ptxas.items()):
        log(f"ptxas: {name}: {info}")
    missing = [f"{kernel}<{nr}>" for kernel in ("cbc_mk_block_kernel", "ecb_encrypt_block_kernel",
                                                "ctr_gen_block_kernel")
               for nr in (10, 12, 14) if f"{kernel}<{nr}>" not in ptxas]
    missing += [k for k in ("cbc_mk_stamped_kernel<10>", "ghash_map_kernel<128,0>",
                            "ghash_map_kernel<128,1>", "ghash_carry_kernel<128>",
                            "ghash_rows_kernel<128>") if k not in ptxas]
    if missing:
        raise SystemExit(f"the kernels built without {missing}")

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def graph_ms(fn, reps=100):
        """Card time per call of ``fn`` with the host out of the way: ``reps``
        calls captured in one CUDA graph, replayed, timed with CUDA events.
        Each launch still pays the card's own launch cost; the host's issue
        time, which paces back-to-back launches of a kernel of a few µs,
        does not enter."""
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        stop.record()
        stop.synchronize()
        del graph
        return start.elapsed_time(stop) / (5 * reps)

    def random_words(n, seed):
        return torch.randint(-2**31, 2**31, (n, 4), dtype=torch.int32, device=dev,
                             generator=torch.Generator(dev).manual_seed(seed))

    def tensors(n, key, hexnonce, seed):
        nr, rk = expand_key_enc(key)
        ctr = packing.np_bytes_to_words(np.frombuffer(bytes.fromhex(hexnonce), np.uint8)).byteswap()
        return random_words(n, seed), packing.words_tensor(ctr, dev), packing.words_tensor(rk, dev), nr

    def diff(got, want):
        """(mismatching words, largest absolute difference of the u32 values)."""
        torch.cuda.synchronize()
        d = (got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)
        return int((got != want).sum()), int(d.abs().max()) if d.numel() else 0

    def compare(w, ctr, rk, nr, forms=cuda_aes.CTR_GEN_FORMS):
        """Mismatching words of ``ctr_gen`` in each of ``forms`` against the
        plain version, by form."""
        want = cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr)
        return {form: diff(cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr, form=form), want)[0]
                for form in forms}

    def schedules(key):
        nr, rk = expand_key_enc(key)
        return nr, packing.words_tensor(rk, dev), packing.words_tensor(expand_key_dec(key)[1], dev)

    phase("2")
    # 2. Kernels vs plain versions on the card.
    mismatches = 0
    cases = block_cases = 0
    for bits in (128, 192, 256):
        key = np.random.default_rng(bits).integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
        for hexnonce in WRAP_NONCES:
            for n in (1, 31, 33, 1000, 1 << 20):
                if n == 1 << 20 and (hexnonce != WRAP_NONCES[1] or bits != LARGE_BITS):
                    continue  # 16 MiB once, across a 64-bit carry
                by_form = compare(*tensors(n, key, hexnonce, seed=n + bits))
                mismatches += sum(by_form.values())
                cases += 1
                if any(by_form.values()):
                    log(f"MISMATCH ctr_gen bits={bits} nonce={hexnonce} n={n}: {by_form} words")
            # The block form at its own sizes, and both sides of the crossing
            # in the auto form.
            lib_c = cuda_build.load()
            top = next(n for n in (1 << j for j in range(25)) if lib_c.ot_ctr_gen_form(2 * n, 0) == 1)
            for n, forms in [(n, ("block",)) for n in CTR_BLOCK_SIZES] + [
                    (top, ("auto",)), (top + 1, ("auto",))]:
                by_form = compare(*tensors(n, key, hexnonce, seed=3 * n + bits), forms=forms)
                mismatches += sum(by_form.values())
                block_cases += 1
                if any(by_form.values()):
                    log(f"MISMATCH ctr_gen bits={bits} nonce={hexnonce} n={n}: {by_form} words")
    log(f"ctr_gen vs plain: {cases} cases in each form (auto, group forced, block forced) at N in "
        f"(1, 31, 33, 1000; 2^20 with AES-{LARGE_BITS} only), {block_cases} more (the block form at N in {CTR_BLOCK_SIZES}, "
        f"the auto form at {top} and {top + 1} blocks, either side of the crossing), every "
        f"counter wrap: {mismatches} mismatching words")
    if mismatches:
        raise SystemExit("ctr_gen disagrees with its plain version")
    ecb_mismatches = {"ecb_encrypt": 0, "ecb_decrypt": 0}
    ecb_form_mismatches = {form: 0 for form in cuda_aes.ECB_FORMS}
    for bits in (128, 192, 256):
        nr, rk, rk_dec = schedules(np.random.default_rng(bits).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes())
        for n in ECB_SIZES:
            if n >= 1 << 20 and bits != LARGE_BITS:
                continue
            w = random_words(n, seed=3 * n + bits)
            want = bitslice.encrypt_words(w, rk, nr)
            for form in cuda_aes.ECB_FORMS:
                m, _ = diff(cuda_aes.encrypt_words(w, rk, nr, form=form), want)
                ecb_mismatches["ecb_encrypt"] += m
                ecb_form_mismatches[form] += m
                if m:
                    log(f"MISMATCH ecb_encrypt {form} form bits={bits} n={n}: {m} words")
            m, _ = diff(cuda_aes.decrypt_words(w, rk_dec, nr), bitslice.decrypt_words(w, rk_dec, nr))
            ecb_mismatches["ecb_decrypt"] += m
            if m:
                log(f"MISMATCH ecb_decrypt bits={bits} n={n}: {m} words")
            del w, want
        # The block form (one block a thread) at its own sizes.
        for n in ECB_BLOCK_SIZES:
            w = random_words(n, seed=5 * n + bits)
            m, _ = diff(cuda_aes.encrypt_words(w, rk, nr, form="block"),
                        bitslice.encrypt_words(w, rk, nr))
            ecb_mismatches["ecb_encrypt"] += m
            ecb_form_mismatches["block"] += m
            if m:
                log(f"MISMATCH ecb_encrypt block form bits={bits} n={n}: {m} words")
    log(f"ECB kernels vs plain: {len(ECB_SIZES) + 2 * sum(n < 1 << 20 for n in ECB_SIZES)} cases "
        f"each (nr 10/12/14, N in {ECB_SIZES}, from 2^20 up with AES-{LARGE_BITS} only), "
        f"encrypt in each form (auto, group forced, block forced), and the block form at N in "
        f"{ECB_BLOCK_SIZES}: mismatching words {ecb_mismatches}, encrypt by form "
        f"{ecb_form_mismatches}")
    if any(ecb_mismatches.values()):
        raise SystemExit("an ECB kernel disagrees with its plain version")

    def mk_stack(bits, k, seed):
        """(nr, (k, 4*(nr+1)) schedules of k random keys on the card)."""
        rng = np.random.default_rng(seed)
        rows = [expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
                for _ in range(k)]
        return rows[0][0], packing.words_tensor(np.stack([r for _, r in rows]), dev)

    def slot_runs(n, k, lengths, seed):
        """(n,) int32 slots on the card: runs of lengths drawn from
        ``lengths`` (a range or a menu), each on a random slot."""
        rng = np.random.default_rng(seed)
        parts, total = [], 0
        while total < n:
            part = rng.choice(lengths, size=(n - total) // int(np.mean(lengths)) + 16)
            parts.append(part)
            total += int(part.sum())
        runs = np.concatenate(parts)
        sl = np.repeat(rng.integers(0, k, runs.size), runs)[:n].astype(np.int32)
        return torch.from_numpy(sl).to(dev)

    mk_mismatch, mk_cases = 0, 0
    mk_form_mismatch = {form: 0 for form in cuda_aes.MK_FORMS}
    for bits in (128, 192, 256):
        for k in (1, 3, 8, 64):
            nr, rks = mk_stack(bits, k, seed=bits * k)
            zero_rks = rks.clone()
            zero_rks[(k + 1) // 2:] = 0
            for n in (1, 31, 33, 1000, 4096, 1 << 20):
                if n == 1 << 20 and bits != LARGE_BITS:
                    continue
                rng = np.random.default_rng(n * k + bits)
                patterns = {
                    "one slot": (rks, torch.full((n,), k - 1, dtype=torch.int32, device=dev)),
                    "runs 1-300": (rks, slot_runs(n, k, np.arange(1, 301), seed=n + k)),
                    "random per block": (rks, torch.from_numpy(
                        rng.integers(0, k, n).astype(np.int32)).to(dev)),
                    "zero schedules": (zero_rks, torch.from_numpy(
                        rng.integers(0, k, n).astype(np.int32)).to(dev)),
                }
                w, c = random_words(n, seed=5 * n + k), random_words(n, seed=7 * n + k)
                for name, (r, sl) in patterns.items():
                    want = cuda_aes.ctr_scattered_multikey_plain(w, c, r, sl, nr)
                    for form in cuda_aes.MK_FORMS:
                        m, _ = diff(cuda_aes.ctr_scattered_multikey(w, c, r, sl, nr, form=form),
                                    want)
                        mk_mismatch += m
                        mk_form_mismatch[form] += m
                        if m:
                            log(f"MISMATCH ctr_mk {form} form bits={bits} K={k} n={n} {name}: "
                                f"{m} words")
                    mk_cases += 1
    k1_mismatch, k1_cases = 0, 0
    for bits in (128, 192, 256):
        nr, rk, _ = schedules(np.random.default_rng(bits + 1).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes())
        for hexnonce in WRAP_NONCES:
            for n in (1, 33, 1000, 1 << 20):
                if n == 1 << 20 and (hexnonce != WRAP_NONCES[1] or bits != LARGE_BITS):
                    continue
                ctr = packing.words_tensor(packing.np_ctr_le_blocks(
                    bytes.fromhex(hexnonce), np.arange(n)), dev)
                w = random_words(n, seed=11 * n + bits)
                want = cuda_aes.ctr_crypt_words_explicit_plain(w, ctr, rk, nr)
                for form in cuda_aes.MK_FORMS:
                    m, _ = diff(cuda_aes.ctr_crypt_words_explicit(w, ctr, rk, nr, form=form), want)
                    k1_mismatch += m
                    mk_form_mismatch[form] += m
                    if m:
                        log(f"MISMATCH ctr_mk K=1 entry, {form} form, bits={bits} "
                            f"nonce={hexnonce} n={n}: {m} words")
                k1_cases += 1
    log(f"ctr_mk vs plain: {mk_cases} cases (2^20 blocks with AES-{LARGE_BITS} only), "
        f"{mk_mismatch} mismatching words; its K = 1 entry "
        f"(ctr_crypt_words_explicit): {k1_cases} cases, {k1_mismatch} mismatching words; every "
        f"case in each form (auto, group forced, block forced), mismatching words by form "
        f"{mk_form_mismatch}; launches by form {form_counts()}")
    if mk_mismatch or k1_mismatch:
        raise SystemExit("ctr_mk disagrees with its plain version")

    def dec_stack(bits, k, seed):
        """(nr, (k, 4*(nr+1)) decrypt schedules of k random keys on the card,
        the upper half of them the unused all-zero schedule)."""
        nr, rks = mk_stack(bits, k, seed)
        dec = np.stack([dec_schedule_from_enc(nr, r) for r in packing.words_numpy(rks)])
        dec[(k + 1) // 2:] = 0
        return nr, packing.words_tensor(dec, dev)

    def cbc_patterns(n, k, seed):
        """The three slot patterns over the used half of a k-slot stack."""
        used = (k + 1) // 2
        rng = np.random.default_rng(seed)
        return {"one slot": torch.full((n,), used - 1, dtype=torch.int32, device=dev),
                "runs 1-300": slot_runs(n, used, np.arange(1, 301), seed=seed),
                "random per block": torch.from_numpy(
                    rng.integers(0, used, n).astype(np.int32)).to(dev)}

    def cbc_check(name, bits, k, n, seed):
        """cbc_mk against its plain version on random ciphertext and PREV
        words in the three patterns: (cases, mismatching words)."""
        nr, rks = dec_stack(bits, k, seed)
        w, prev = random_words(n, seed=seed + 1), random_words(n, seed=seed + 2)
        bad = 0
        for pattern, sl in cbc_patterns(n, k, seed + 3).items():
            m, _ = diff(cuda_aes.cbc_scattered_multikey(w, prev, rks, sl, nr),
                        cuda_aes.cbc_scattered_multikey_plain(w, prev, rks, sl, nr))
            bad += m
            if m:
                log(f"MISMATCH cbc_mk {name} bits={bits} K={k} n={n} {pattern}: {m} words")
        return 3, bad

    cbc_cases = cbc_bad = 0
    for bits in (128, 192, 256):
        for k in (1, 3, 8, 64):
            for n in (1, 31, 33, 1000, 4096, 1 << 20):
                if n == 1 << 20 and bits != LARGE_BITS:
                    continue
                c, m = cbc_check("", bits, k, n, seed=bits + 100 * k + n)
                cbc_cases, cbc_bad = cbc_cases + c, cbc_bad + m
    rung_cases = rung_bad = 0
    serve_rungs = (32, 64, 128, 256, 512, 1024, 2048, 4096)
    for rung in serve_rungs:
        c, m = cbc_check("rung", 128, 8, rung, seed=7 * rung)
        rung_cases, rung_bad = rung_cases + c, rung_bad + m
    log(f"cbc_mk vs plain: {cbc_cases} cases (nr 10/12/14, K in 1, 3, 8, 64, N in 1, 31, 33, "
        f"1000, 4096, and 2^20 with AES-{LARGE_BITS} only; one slot, runs 1-300, random per block; the upper half of each stack "
        f"unused and zero), {cbc_bad} mismatching words; at the serve ladder's rungs "
        f"{serve_rungs} with K = 8: {rung_cases} cases, {rung_bad} mismatching words")
    if cbc_bad or rung_bad:
        raise SystemExit("cbc_mk disagrees with its plain version")
    # seq_encrypt, the chained CBC/CFB128 kernel, against its plain version
    # (the per-block loop). Up to 33 blocks the loop runs whole. At 4,096
    # blocks the loop's 4,096 launch-bound plain steps would take about a
    # minute a case, so every step of it is taken at once from the kernel's
    # own previous block, C_i = E(P_i ^ C_(i-1)) or P_i ^ E(C_(i-1)) for all
    # i in one batched plain encrypt; from C_(-1) = IV on, by induction, the
    # outputs equal the whole loop's exactly when every step agrees.
    def seq_plain_steps(w, ivs, out, rk, nr, cfb):
        prev = torch.cat([ivs[:, None], out[:, :-1]], dim=1)
        if cfb:
            return w ^ bitslice.encrypt_words(prev.reshape(-1, 4), rk, nr).reshape(w.shape)
        return bitslice.encrypt_words((w ^ prev).reshape(-1, 4), rk, nr).reshape(w.shape)

    # Each case runs in every form (and auto): the first form's output is
    # held against the plain version (the whole loop, or its every step),
    # every other form's against the same words, so each form agrees with
    # the plain version exactly when its words equal the first's.
    seq_mismatch, seq_cases = {f: 0 for f in cuda_aes.SEQ_FORMS}, 0
    for bits in (128, 192, 256):
        nr, rk, _ = schedules(np.random.default_rng(bits + 2).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes())
        for cfb in (False, True):
            for s_n, n in ((s_n, n) for s_n in (1, 3, SEQ_BLOCKS) for n in (1, 2, 33, SEQ_BLOCKS)):
                if s_n == n == SEQ_BLOCKS and bits != LARGE_BITS:
                    continue
                w = random_words(s_n * n, seed=s_n + 13 * n + bits).reshape(s_n, n, 4)
                ivs = random_words(s_n, seed=s_n + bits + cfb)
                want = None
                for form in cuda_aes.SEQ_FORMS:
                    out, iv_out = cuda_aes.seq_encrypt(w, ivs, rk, nr, cfb, form=form)
                    if want is None and n <= 33:
                        want = cuda_aes.seq_encrypt_plain(w, ivs, rk, nr, cfb)
                    elif want is None:
                        want = seq_plain_steps(w, ivs, out, rk, nr, cfb), out[:, -1]
                    m = diff(out, want[0])[0] + diff(iv_out, want[1])[0]
                    seq_mismatch[form] += m
                    if m:
                        log(f"MISMATCH seq_encrypt form {form} bits={bits} "
                            f"{'cfb128' if cfb else 'cbc'} S={s_n} N={n}: {m} words")
                    del out
                seq_cases += 1
                del w, want
    log(f"seq_encrypt vs plain: {seq_cases} cases (nr 10/12/14, CBC and CFB128, S in 1, 3, "
        f"{SEQ_BLOCKS}, N in 1, 2, 33, {SEQ_BLOCKS}; S = N = {SEQ_BLOCKS} with AES-{LARGE_BITS} "
        f"only), in each form: mismatching words by form {seq_mismatch}")
    if any(seq_mismatch.values()):
        raise SystemExit("seq_encrypt disagrees with its plain version")
    chain_words = ceiling.words(PROBE_BYTES)
    chain_mismatch, chain_cases = 0, 0
    for name, c, i in ceiling.REGIMES:
        for n in (1, 31, 4097, (1 << 20) + 3, chain_words):
            x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                              generator=torch.Generator(dev).manual_seed(n + 10 * i + c))
            m, _ = diff(ceiling.chain(x, c, i), ceiling.chain_plain(x, c, i))
            chain_mismatch += m
            chain_cases += 1
            if m:
                log(f"MISMATCH chain {name} n={n}: {m} words")
    lat_x = torch.tensor([0x2468ACE], dtype=torch.int32, device=dev)
    m, _ = diff(ceiling.chain(lat_x, *ceiling.LATENCY[1:]), ceiling.chain_plain(lat_x, *ceiling.LATENCY[1:]))
    chain_mismatch += m
    chain_cases += 1
    log(f"chain vs plain: {chain_cases} cases (four regimes, n up to {chain_words}, and the "
        f"{ceiling.LATENCY[1]}-step latency chain over one word), {chain_mismatch} mismatching words")
    if chain_mismatch:
        raise SystemExit("chain disagrees with its plain version")
    # arc4_prga against prga_plain: the keystream, the fused XOR and a resume
    # across two calls (a third of the bytes, then the rest), for every
    # streams x bytes pair. The plain version runs once a length on 4,096
    # streams (timed for the kernels line); a launch on S streams is held
    # against its first S rows.
    collision_states = tests_module("arc4_states").collision_states

    def arc4_states(s_n, seed, kind="random"):
        if kind == "collisions":
            return arc4.state_from_numpy(collision_states(s_n, seed), dev)
        rng = np.random.default_rng(seed)
        m = np.stack([rng.permutation(256) for _ in range(s_n)])
        return arc4.state_from_numpy((rng.integers(0, 256, s_n), rng.integers(0, 256, s_n), m),
                                     dev)

    def byte_diff(got, want):
        """(mismatching elements, largest absolute difference among them)."""
        ne = got != want
        bad = int(ne.sum())
        if not bad:
            return 0, 0
        return bad, int((got[ne].to(torch.int64) - want[ne].to(torch.int64)).abs().max())

    arc4_bad, arc4_cases, arc4_inputs = 0, 0, {}
    for n, kind in ((n, kind) for n in ARC4_LENGTHS for kind in ("random", "collisions")):
        st = arc4_states(ARC4_PLAIN_STREAMS, seed=31 + n, kind=kind)
        data = torch.randint(0, 256, (ARC4_PLAIN_STREAMS, n), dtype=torch.uint8, device=dev,
                             generator=torch.Generator(dev).manual_seed(n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_st, want = cuda_arc4.prga_plain(st, n)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        want_x = data ^ want
        err = 0
        for s_n in ARC4_STREAMS:
            st_s, data_s, cut = st[:s_n], data[:s_n], n // 3
            got_st, got = cuda_arc4.prga(st_s, n)
            f_st, fused = cuda_arc4.prga(st_s, n, data_s)
            mid, first = cuda_arc4.prga(st_s, cut, data_s[:, :cut].contiguous())
            end, second = cuda_arc4.prga(mid, n - cut, data_s[:, cut:].contiguous())
            torch.cuda.synchronize()
            diffs = [byte_diff(got, want[:s_n]), byte_diff(fused, want_x[:s_n]),
                     byte_diff(first, want_x[:s_n, :cut]), byte_diff(second, want_x[:s_n, cut:])]
            bad = (sum(m for m, _ in diffs)
                   + sum(byte_diff(x, want_st[:s_n])[0] for x in (got_st, f_st, end)))
            err = max([err] + [e for _, e in diffs])
            arc4_bad += bad
            arc4_cases += 1
            if bad:
                log(f"MISMATCH arc4_prga S={s_n} bytes={n} ({kind} states): {bad} bytes or "
                    "state words")
            del got, fused, first, second
        if kind == "random":
            arc4_inputs[n] = {"states": st, "plain_ms": plain_s * 1e3, "max_abs_err": err}
        else:
            arc4_inputs[n]["max_abs_err"] = max(arc4_inputs[n]["max_abs_err"], err)
        if n == ARC4_LENGTHS[-1] and kind == "random":
            long_want = want[:max(ARC4_LONG_STREAMS)].clone()
        del data, want, want_x, want_st
    # The sweep's length: the first bytes against the plain run, the rest
    # against a resume from them.
    deep = ARC4_LENGTHS[-1]
    for s_n in ARC4_LONG_STREAMS:
        st_s = arc4_inputs[deep]["states"][:s_n]
        got_st, got = cuda_arc4.prga(st_s, ARC4_LONG)
        mid, first = cuda_arc4.prga(st_s, deep)
        end, rest = cuda_arc4.prga(mid, ARC4_LONG - deep)
        torch.cuda.synchronize()
        diffs = [byte_diff(got[:, :deep], long_want[:s_n]), byte_diff(first, long_want[:s_n]),
                 byte_diff(got[:, deep:], rest)]
        bad = sum(m for m, _ in diffs) + byte_diff(got_st, end)[0]
        arc4_bad += bad
        arc4_cases += 1
        if bad:
            log(f"MISMATCH arc4_prga S={s_n} bytes={ARC4_LONG}: {bad} bytes or state words")
        del got, first, rest
    arc4_inputs[ARC4_LONG] = {**arc4_inputs[deep], "plain_bytes": deep}
    del long_want
    torch.cuda.empty_cache()
    log(f"arc4_prga vs plain: {arc4_cases} cases (S in {ARC4_STREAMS} x bytes in {ARC4_LENGTHS}, "
        f"from random permutations and from collision states, "
        f"against the plain version's first S of {ARC4_PLAIN_STREAMS} streams, each keystream, "
        f"fused XOR and a resume across two calls; S in {ARC4_LONG_STREAMS} x {ARC4_LONG} bytes, "
        f"the first {ARC4_LENGTHS[-1]} against the plain run, the rest against a resume): "
        f"{arc4_bad} mismatching bytes or state words; "
        f"the plain version on {ARC4_PLAIN_STREAMS} streams "
        f"{ {n: round(v['plain_ms'], 1) for n, v in arc4_inputs.items()} } ms by length")
    if arc4_bad:
        raise SystemExit("arc4_prga disagrees with its plain version")

    phase("3")
    # 3. KATs and chunked resume through the AES context on the card.
    kat_key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    ctr0 = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
    pt = bytes.fromhex(SP800_PT)
    ct = ("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
          "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")
    ctx = aes.AES(kat_key)
    if ctx.engine != aes.CUDA_ENGINE:
        raise SystemExit(f"AES on the card resolved to {ctx.engine}")
    out = ctx.crypt_ctr(0, ctr0.copy(), np.zeros(16, np.uint8), pt)[0]
    if out.tobytes().hex() != ct:
        raise SystemExit("NIST SP800-38A F.5.1 CTR KAT failed")
    log("NIST SP800-38A F.5.1 CTR-AES128 KAT: pass")
    data = np.random.default_rng(7).integers(0, 256, 1 + 15 + 16 + 17 + 1_000_003, dtype=np.uint8)
    state = (0, ctr0.copy(), np.zeros(16, np.uint8))
    parts, pos = [], 0
    for size in (1, 15, 16, 17, 1_000_003):
        o, *state = ctx.crypt_ctr(*state, data[pos: pos + size])
        parts.append(o)
        pos += size
    cpu = aes.AES(kat_key, device="cpu").crypt_ctr(0, ctr0.copy(), np.zeros(16, np.uint8), data)
    if not (np.array_equal(np.concatenate(parts), cpu[0]) and state[0] == cpu[1]
            and np.array_equal(state[1], cpu[2]) and np.array_equal(state[2], cpu[3])):
        raise SystemExit("chunked crypt_ctr on the card differs from one shot on the CPU")
    log("chunked crypt_ctr resume (1, 15, 16, 17, 1000003 bytes): equal to CPU one-shot")
    iv = np.frombuffer(bytes.fromhex(SP800_IV), np.uint8)
    seq_before = cuda_aes.seq_encrypt.launches
    for bits, (key_hex, ecb_hex, cbc_hex) in SP800_ECB_CBC.items():
        kctx = aes.AES(bytes.fromhex(key_hex))
        if kctx.engine != aes.CUDA_ENGINE:
            raise SystemExit(f"AES-{bits} on the card resolved to {kctx.engine}")
        checks = [
            kctx.crypt_ecb(aes.AES_ENCRYPT, pt).tobytes().hex() == ecb_hex,
            kctx.crypt_ecb(aes.AES_DECRYPT, bytes.fromhex(ecb_hex)).tobytes().hex() == SP800_PT,
            kctx.crypt_cbc(aes.AES_ENCRYPT, iv, pt)[0].tobytes().hex() == cbc_hex,
            kctx.crypt_cbc(aes.AES_DECRYPT, iv, bytes.fromhex(cbc_hex))[0].tobytes().hex() == SP800_PT,
        ]
        if bits == 128:
            checks += [
                ctx.crypt_cfb128(aes.AES_ENCRYPT, 0, iv, pt)[0].tobytes().hex() == SP800_CFB128,
                ctx.crypt_cfb128(aes.AES_DECRYPT, 0, iv,
                                 bytes.fromhex(SP800_CFB128))[0].tobytes().hex() == SP800_PT,
            ]
        if not all(checks):
            raise SystemExit(f"NIST SP800-38A KAT failed for AES-{bits}: {checks}")
    # The three CBC encrypts and the CFB128 encrypt each ran the chained kernel
    # once; F.2.1 and F.3.13 once more through its entries, straight.
    kat_seq = cuda_aes.seq_encrypt.launches - seq_before
    nr, rk, _ = schedules(kat_key)
    pt_w = packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(pt, np.uint8)), dev)
    iv_w = packing.words_tensor(packing.np_bytes_to_words(iv), dev)
    straight = {
        "F.2.1": (cuda_aes.cbc_encrypt_words_seq, SP800_ECB_CBC[128][2]),
        "F.3.13": (cuda_aes.cfb128_encrypt_words_seq, SP800_CFB128),
    }

    def kat_hex(ct_w, iv_out):
        got = packing.np_words_to_bytes(packing.words_numpy(ct_w).reshape(-1)).tobytes().hex()
        new_iv = packing.np_words_to_bytes(packing.words_numpy(iv_out).reshape(-1)).tobytes().hex()
        return got if got[-32:] == new_iv else f"{got} (new IV {new_iv})"

    for name, (fn, want_hex) in straight.items():
        if kat_hex(*fn(pt_w.reshape(4, 4), iv_w, rk, nr)) != want_hex:
            raise SystemExit(f"NIST SP800-38A {name} through seq_encrypt failed")
    # And the CBC (F.2.1, F.2.3, F.2.5) and CFB128 (F.3.13) encrypts through
    # each form of the chained kernel.
    kat_forms = {}
    for form in cuda_aes.SEQ_FORMS[1:]:
        for bits, (key_hex, _ecb_hex, cbc_hex) in SP800_ECB_CBC.items():
            nr_k, rk_k, _ = schedules(bytes.fromhex(key_hex))
            got = kat_hex(*cuda_aes.seq_encrypt(pt_w.reshape(1, 4, 4), iv_w.reshape(1, 4), rk_k,
                                                nr_k, False, form=form))
            kat_forms[f"{form} CBC-AES{bits}"] = got == cbc_hex
        got = kat_hex(*cuda_aes.seq_encrypt(pt_w.reshape(1, 4, 4), iv_w.reshape(1, 4), rk, nr,
                                            True, form=form))
        kat_forms[f"{form} CFB128-AES128"] = got == SP800_CFB128
    if not all(kat_forms.values()):
        raise SystemExit(f"NIST SP800-38A through the seq_encrypt forms failed: {kat_forms}")
    kat_launches = 6 + 4 * len(cuda_aes.SEQ_FORMS[1:])
    if kat_seq != 4 or cuda_aes.seq_encrypt.launches - seq_before != kat_launches:
        raise SystemExit(f"the CBC/CFB128 KATs made {kat_seq} seq_encrypt launches, not 4 (and "
                         f"{cuda_aes.seq_encrypt.launches - seq_before} in all, not {kat_launches})")
    log("NIST SP800-38A F.1 and F.2 (ECB, CBC; 128/192/256, both directions) and F.3.13 "
        "(CFB128-AES128, both directions) through AES on the card: pass; its CBC and CFB128 "
        f"encrypts made {kat_seq} seq_encrypt launches (one a call); F.2.1 and F.3.13 through "
        "cbc_encrypt_words_seq and cfb128_encrypt_words_seq (the chained kernel), ciphertext and "
        f"new IV: pass; F.2.1/F.2.3/F.2.5 and F.3.13 through each seq_encrypt form "
        f"({', '.join(cuda_aes.SEQ_FORMS[1:])}): pass")
    # F.5.1 in slot 3 of 8 through the serve seam, other tenants interleaved
    # and slots 6-7 empty.
    others = [np.random.default_rng(29 + i).integers(0, 256, 16, dtype=np.uint8).tobytes()
              for i in range(5)]
    rows = [expand_key_enc(k)[1] for k in others[:3] + [kat_key] + others[3:]]
    rks8 = packing.words_tensor(np.stack(rows + [np.zeros_like(rows[0])] * 2), dev)
    kat_slots = np.array([3, 0, 1, 3, 4, 3, 5, 2, 3, 0], np.int32)
    kat_ctr = np.random.default_rng(30).integers(0, 2**32, (10, 4), dtype=np.uint64).astype(np.uint32)
    kat_ctr[kat_slots == 3] = packing.np_ctr_le_blocks(ctr0.tobytes(), np.arange(4))
    kat_data = np.random.default_rng(31).integers(0, 256, (10, 16), dtype=np.uint8)
    kat_data[kat_slots == 3] = np.frombuffer(pt, np.uint8).reshape(4, 16)
    out = aes.ctr_crypt_words_scattered_multikey(
        packing.words_tensor(packing.np_bytes_to_words(kat_data.reshape(-1)), dev),
        packing.words_tensor(kat_ctr.reshape(-1), dev), rks8,
        torch.from_numpy(kat_slots).to(dev), 10, aes.CUDA_ENGINE)
    got = packing.np_words_to_bytes(packing.words_numpy(out)).reshape(10, 16)
    if got[kat_slots == 3].tobytes().hex() != ct:
        raise SystemExit("NIST SP800-38A F.5.1 in slot 3 of 8 failed")
    log("NIST SP800-38A F.5.1 CTR-AES128 in slot 3 of 8 (ctr_crypt_words_scattered_multikey, "
        "CUDA engine): pass")
    # F.2.2, F.2.4 and F.2.6 in slot 3 of 8 through the multi-key CBC seam:
    # the KAT's ciphertext, its PREV stream (IV, then the ciphertext shifted)
    # among other tenants' blocks, slots 6-7 empty.
    cbc_before = cuda_aes.cbc_scattered_multikey.launches
    for bits, (key_hex, _ecb_hex, cbc_hex) in SP800_ECB_CBC.items():
        kat_k = bytes.fromhex(key_hex)
        nr_k, rk_k = expand_key_enc(kat_k)
        others = [np.random.default_rng(37 + bits + i).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes() for i in range(5)]
        rows = [dec_schedule_from_enc(*expand_key_enc(k)) for k in others[:3]]
        rows += [dec_schedule_from_enc(nr_k, rk_k)]
        rows += [dec_schedule_from_enc(*expand_key_enc(k)) for k in others[3:]]
        rks8 = packing.words_tensor(np.stack(rows + [np.zeros_like(rows[0])] * 2), dev)
        ct_b = np.frombuffer(bytes.fromhex(cbc_hex), np.uint8)
        cbc_data = np.random.default_rng(bits).integers(0, 256, (10, 16), dtype=np.uint8)
        cbc_prev = np.random.default_rng(bits + 1).integers(0, 256, (10, 16), dtype=np.uint8)
        cbc_data[kat_slots == 3] = ct_b.reshape(4, 16)
        cbc_prev[kat_slots == 3] = np.concatenate([iv, ct_b[:48]]).reshape(4, 16)
        out = aes.cbc_decrypt_words_scattered_multikey(
            packing.words_tensor(packing.np_bytes_to_words(cbc_data.reshape(-1)), dev),
            packing.words_tensor(packing.np_bytes_to_words(cbc_prev.reshape(-1)), dev), rks8,
            torch.from_numpy(kat_slots).to(dev), nr_k, aes.CUDA_ENGINE)
        got = packing.np_words_to_bytes(packing.words_numpy(out)).reshape(10, 16)
        if got[kat_slots == 3].tobytes().hex() != SP800_PT:
            raise SystemExit(f"NIST SP800-38A CBC-AES{bits} decrypt in slot 3 of 8 failed")
    if cuda_aes.cbc_scattered_multikey.launches - cbc_before != 3:
        raise SystemExit("the CBC KATs through the multi-key seam were not one cbc_mk launch each")
    log("NIST SP800-38A F.2.2, F.2.4, F.2.6 (CBC-AES128/192/256 decrypt) in slot 3 of 8 "
        "(cbc_decrypt_words_scattered_multikey, CUDA engine, one cbc_mk launch each): pass")

    phase("4")
    # 4. The CTR main path, counted.
    reset_counts()
    line = bench.run(device=dev, nbytes=MAIN_BYTES, iters=5, reps=3)
    ctr_counts = counts()
    ctr_forms = form_counts()["ctr_gen"]
    log(json.dumps(line))
    if f"digest={MAIN_DIGEST:#010x}" not in line["metric"]:
        raise SystemExit(f"main path digest is not {MAIN_DIGEST:#010x}: {line['metric']}")
    if ctr_counts["ctr_gen"] <= 0:
        raise SystemExit("the CTR main path launched no ctr_gen kernel")
    if ctr_forms != {"group": ctr_counts["ctr_gen"], "block": 0}:
        raise SystemExit(f"the CTR main path's ctr_gen launches were not all in the group form: "
                         f"{ctr_forms}")
    ctr_gbps = line["value"]
    log(f"CTR main path: {line['value']} GB/s median (min {line['value_min']}, max "
        f"{line['value_max']}, {line['reps']} reps), launches {ctr_counts}, ctr_gen by form "
        f"{ctr_forms}; card: {card}")
    # The main path at BASELINE.json's 1 GiB, counted, on the reference's digest.
    reset_counts()
    line_gib = bench.run(device=dev, nbytes=GIB_BYTES, iters=5, reps=3)
    gib_counts = counts()
    log(json.dumps(line_gib))
    if f"digest={GIB_DIGEST:#010x}" not in line_gib["metric"]:
        raise SystemExit(f"main path digest at 1 GiB is not {GIB_DIGEST:#010x}: "
                         f"{line_gib['metric']}")
    if gib_counts["ctr_gen"] <= 0 or any(v for k, v in gib_counts.items() if k != "ctr_gen"):
        raise SystemExit(f"the 1 GiB main path's launches were not ctr_gen's alone: {gib_counts}")
    main_gib = {"bytes": GIB_BYTES, "gbps": line_gib["value"], "gbps_min": line_gib["value_min"],
                "gbps_max": line_gib["value_max"], "reps": line_gib["reps"],
                "digest": f"{GIB_DIGEST:#010x}", "launches": gib_counts["ctr_gen"]}
    log(f"CTR main path at 1 GiB: {line_gib['value']} GB/s median (min {line_gib['value_min']}, "
        f"max {line_gib['value_max']}), digest {GIB_DIGEST:#010x}, {gib_counts['ctr_gen']} "
        f"ctr_gen launches, beside {ctr_gbps} GB/s at 256 MiB; card: {card}")

    phase("5")
    # 5. The block-mode path at 256 MiB, counted.
    nr, rk, rk_dec = schedules(bench.KEY)
    host = np.random.default_rng(bench.SEED).integers(0, 256, MAIN_BYTES, dtype=np.uint8)
    words = packing.words_tensor(packing.np_bytes_to_words(host), dev).reshape(-1, 4)
    ivw = packing.words_tensor(packing.np_bytes_to_words(
        np.frombuffer(bytes.fromhex(BLOCK_IV), np.uint8)), dev)
    eng = aes.CUDA_ENGINE
    reset_counts()
    t0 = time.perf_counter()
    ecb_ct = aes.ecb_encrypt_words(words, rk, nr, eng)
    ecb_pt = aes.ecb_decrypt_words(ecb_ct, rk_dec, nr, eng)
    cbc_pt, cbc_iv = aes.cbc_decrypt_words(words, ivw, rk_dec, nr, eng)
    cfb_pt, cfb_iv = aes.cfb128_decrypt_words(words, ivw, rk, nr, eng)
    seq_calls = {}

    def sequential(name, fn, *args):
        """One sequential encrypt, its launches counted on their own: one
        seq_encrypt launch and no ECB launch."""
        before = counts()
        res = fn(*args)
        seq_calls[name] = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        return res

    cbc_re, _ = sequential("cbc_encrypt_words", aes.cbc_encrypt_words, cbc_pt[:SEQ_BLOCKS], ivw,
                           rk, nr, eng)
    cfb_re, _ = sequential("cfb128_encrypt_words", aes.cfb128_encrypt_words,
                           cfb_pt[:SEQ_BLOCKS], ivw, rk, nr, eng)
    streams = words[:SEQ_BLOCKS * 64].reshape(SEQ_BLOCKS, 64, 4)
    stream_ivs = words[-SEQ_BLOCKS:].contiguous()
    batch_ct, batch_iv = sequential("cbc_encrypt_words_batch", aes.cbc_encrypt_words_batch,
                                    streams, stream_ivs, rk, nr, eng)
    # Byte-granular CFB128 through AES on the card, in chunks carried across
    # calls from iv_off 5: each partial step that needs a keystream block is
    # one block-form ECB launch; a run of whole blocks is one seq_encrypt
    # launch (encrypt) or one ECB launch in its auto form (decrypt).
    cfb_ctx, cfb_cpu = aes.AES(bench.KEY), aes.AES(bench.KEY, device="cpu")
    cfb_bytes = host[:sum(CFB_CHUNKS)]
    steps = cfb_steps(CFB_IV_OFF, CFB_CHUNKS)
    lib_forms = cuda_build.load()
    cfb_runs = {}
    for mode in (aes.AES_ENCRYPT, aes.AES_DECRYPT):
        before, before_forms = counts(), form_counts()["ecb_encrypt"]
        state = state_cpu = (CFB_IV_OFF, np.frombuffer(bytes.fromhex(BLOCK_IV), np.uint8))
        outs, pos, same = [], 0, True
        for size in CFB_CHUNKS:
            o, *state = cfb_ctx.crypt_cfb128(mode, *state, cfb_bytes[pos: pos + size])
            o_cpu, *state_cpu = cfb_cpu.crypt_cfb128(mode, *state_cpu, cfb_bytes[pos: pos + size])
            same &= bool(np.array_equal(o, o_cpu) and state[0] == state_cpu[0]
                         and np.array_equal(state[1], state_cpu[1]))
            pos += size
        got = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        forms = {f: v - before_forms[f] for f, v in form_counts()["ecb_encrypt"].items()}
        want_forms = {"group": 0, "block": sum(n for kind, n in steps if kind == "partial")}
        for kind, n in steps:
            if kind == "bulk" and mode == aes.AES_DECRYPT:
                want_forms[cuda_aes.ECB_FORMS[lib_forms.ot_ecb_encrypt_form(n, 0)]] += 1
        bulk = sum(kind == "bulk" for kind, _n in steps)
        cfb_runs["encrypt" if mode == aes.AES_ENCRYPT else "decrypt"] = {
            "equal to the CPU": same, "launches": got, "ecb_encrypt by form": forms,
            "expected by form": want_forms,
            "seq_encrypt as expected": got.get("seq_encrypt", 0) == (
                bulk if mode == aes.AES_ENCRYPT else 0)}
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    block_counts = counts()
    block_forms = form_counts()["ecb_encrypt"]
    block_seq_forms = form_counts()["seq_encrypt"]
    log(f"byte-granular CFB128 from iv_off {CFB_IV_OFF} in chunks {CFB_CHUNKS} through AES on the "
        f"card: steps {steps}; {cfb_runs}; card: {card}")
    if not all(r["equal to the CPU"] and r["ecb_encrypt by form"] == r["expected by form"]
               and r["seq_encrypt as expected"] for r in cfb_runs.values()):
        raise SystemExit(f"byte-granular CFB128 on the card: {cfb_runs}")
    log(f"block-mode path at {MAIN_BYTES >> 20} MiB: {path_s:.3f} s, launches {block_counts}, "
        f"ecb_encrypt by form {block_forms}, seq_encrypt by form {block_seq_forms}; the "
        f"sequential encrypts' own launches {seq_calls}")
    if block_counts["ecb_encrypt"] <= 0 or block_counts["ecb_decrypt"] <= 0 or min(
            block_forms.values()) <= 0:
        raise SystemExit(f"the block-mode path did not launch both ECB kernels, encrypt in both "
                         f"forms: {block_counts}, encrypt by form {block_forms}")
    if any(c != {"seq_encrypt": 1} for c in seq_calls.values()):
        raise SystemExit(f"a sequential encrypt did not make exactly one seq_encrypt launch and "
                         f"nothing else: {seq_calls}")
    checks = {
        "ecb round trip": bool(torch.equal(ecb_pt, words)),
        "ecb_encrypt == plain": diff(ecb_ct, bitslice.encrypt_words(words, rk, nr))[0] == 0,
        "ecb_decrypt == plain": diff(ecb_pt, bitslice.decrypt_words(ecb_ct, rk_dec, nr))[0] == 0,
        "cbc_decrypt == plain": diff(cbc_pt, aes.cbc_decrypt_words(
            words, ivw, rk_dec, nr, aes.PLAIN_ENGINE)[0])[0] == 0,
        "cfb128_decrypt == plain": diff(cfb_pt, aes.cfb128_decrypt_words(
            words, ivw, rk, nr, aes.PLAIN_ENGINE)[0])[0] == 0,
        "decrypt ivs": bool(torch.equal(cbc_iv, words[-1]) and torch.equal(cfb_iv, words[-1])),
        f"cbc_encrypt of {SEQ_BLOCKS} recovered blocks": bool(torch.equal(cbc_re, words[:SEQ_BLOCKS])),
        f"cfb128_encrypt of {SEQ_BLOCKS} recovered blocks": bool(torch.equal(cfb_re, words[:SEQ_BLOCKS])),
    }
    # The batch's streams decrypt back in one ECB call: P = D(C) ^ C_prev.
    prev = torch.cat([stream_ivs[:, None], batch_ct[:, :-1]], dim=1)
    back = cuda_aes.decrypt_words(batch_ct.reshape(-1, 4), rk_dec, nr).reshape(batch_ct.shape) ^ prev
    checks[f"cbc_encrypt_words_batch {SEQ_BLOCKS} x 64"] = bool(
        torch.equal(back, streams) and torch.equal(batch_iv, batch_ct[:, -1]))
    log(f"block-mode checks: {checks}")
    if not all(checks.values()):
        raise SystemExit(f"block-mode path check failed: {checks}")

    phase("6")
    # 6. The hex CLI on the card: F.1.2, ECB-AES128 decrypt.
    key_hex, ecb_hex, _ = SP800_ECB_CBC[128]
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.decrypt", key_hex,
                          ecb_hex[:32]], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0 or res.stdout.strip() != SP800_PT[:32]:
        raise SystemExit(f"CLI on the card: rc {res.returncode}, out {res.stdout!r}, "
                         f"err {res.stderr[-2000:]!r}")
    log(f"CLI on the card: decrypt F.1.2 block 1 -> {res.stdout.strip()}: pass")

    phase("7")
    # 7. The ceiling probe: its entry point counted in this process, the CLI
    # in its own, then each regime's kernel alone with the clock sampled.
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ceiling.main([])
    probe_counts = counts()
    probe_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or probe_counts["chain"] <= 0 or any(
            v for n, v in probe_counts.items() if n != "chain"):
        raise SystemExit(f"the ceiling probe's path: rc {rc}, launches {probe_counts}")
    log(f"ceiling probe in this process: launches {probe_counts}")
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.ceiling"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    try:
        cli_line = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        cli_line = None
    if res.returncode != 0 or cli_line is None:
        raise SystemExit(f"the ceiling probe's CLI: rc {res.returncode}, out "
                         f"{res.stdout[-2000:]!r}, err {res.stderr[-2000:]!r}")
    for text in res.stdout.strip().splitlines()[:-1]:
        log(f"probe CLI: {text}")
    log(json.dumps(cli_line))
    keys = {"chain", "ilp", "sec", "t_ops_per_s", "mem_gb_per_s"}
    if not (cli_line["platform"] == probe_line["platform"] == "gpu"
            and cli_line["device_kind"] == torch.cuda.get_device_name(0)
            and cli_line["bytes"] == PROBE_BYTES
            and all(set(cli_line[n]) == keys for n, _c, _i in ceiling.REGIMES)):
        raise SystemExit(f"the ceiling probe's line lacks the reference's keys: {cli_line}")

    sass_text = sass(lib_path)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_ops_per_ms = sm_count * INT_OPS_PER_CLK_PER_SM * clock_mhz * 1e3
    sampler = SmiSampler()
    atexit.register(sampler.close)  # the child ends with the script, however it ends

    def sampled_ms(fn):
        """(ms per launch, the sampler's summary) of back-to-back launches of
        ``fn`` lasting at least ``SAMPLED_S``."""
        reps = max(int(SAMPLED_S * 1e3 / events_ms(fn, 3)), 10)
        t0 = time.time()
        ms = events_ms(fn, reps)
        return ms, sampler.between(t0, time.time())

    x = torch.arange(chain_words, dtype=torch.int32, device=dev)
    regimes = {}
    for name, c, i in ceiling.REGIMES:
        ms, clocks = sampled_ms(lambda c=c, i=i: ceiling.chain(x, c, i))
        regimes[name] = {"chain": c, "ilp": i, "ms": ms, "smi": clocks,
                         **sass_chain_per_element(sass_text, c, i)}
    stream_bytes_per_s = 8 * chain_words / (regimes["stream"]["ms"] / 1e3)
    for name, r in regimes.items():
        per_s = r["int"] * chain_words / (r["ms"] / 1e3)
        r["int_per_clk_per_sm"] = per_s / (sm_count * r["smi"]["clock_mhz"] * 1e6)
        r["int_per_clk_per_sm_at_max"] = per_s / (sm_count * clock_mhz * 1e6)
        r["lop3_per_clk_per_sm"] = r["int_per_clk_per_sm"] * r["lop3"] / r["int"]
        r["t_ops_per_s"] = chain_words * ceiling.ops_per_word(r["chain"], r["ilp"]) / (
            r["ms"] / 1e3) / 1e12
        log(f"probe {name} (chain {r['chain']}, ilp {r['ilp']}) alone: {r['ms']:.4f} ms per "
            f"{PROBE_BYTES >> 20} MiB launch; SASS per element {r['lop3']} LOP3 of {r['int']} "
            f"integer ({r['instructions']} in the loop); {r['int_per_clk_per_sm']:.2f} integer "
            f"results/clk/SM at the sampled {r['smi']['clock_mhz']:.0f} MHz "
            f"({r['int_per_clk_per_sm_at_max']:.2f} at the {clock_mhz:.0f} MHz maximum; LOP3 "
            f"{r['lop3_per_clk_per_sm']:.2f}) against the table's {INT_OPS_PER_CLK_PER_SM}; "
            f"{r['t_ops_per_s']:.3f} T logical ops/s by the reference's count; "
            f"{8 * chain_words / (r['ms'] / 1e3) / 1e12:.4f} TB/s moved; nvidia-smi "
            f"{r['smi']}; card: {card}")
    for name, r in regimes.items():
        if r["chain"] == 1:
            continue
        steps = r["chain"] * r["ilp"]
        if not steps <= r["lop3"] <= 1.1 * steps + 4 * r["ilp"] + 8:
            raise SystemExit(f"chain_kernel<{r['chain']},{r['ilp']}> holds {r['lop3']} LOP3 per "
                             f"element, not about {steps}: it no longer measures the chain")
    if regimes["compute-ilp8"]["int_per_clk_per_sm"] < 0.1 * INT_OPS_PER_CLK_PER_SM:
        raise SystemExit("compute-ilp8 ran under 10 % of the table's integer rate: the probe "
                         "is broken")
    top = max((r for r in regimes.values() if r["chain"] > 1),
              key=lambda r: r["int"] / r["ms"])
    int_per_s = top["int"] * chain_words / (top["ms"] / 1e3)
    measured = {"int_results_per_clk_per_sm": top["int_per_clk_per_sm"],
                "at_max_clock": top["int_per_clk_per_sm_at_max"],
                "sampled_clock_mhz": top["smi"]["clock_mhz"], "from": f"chain_kernel<"
                f"{top['chain']},{top['ilp']}>", "int_per_s": int_per_s,
                "stream_bytes_per_s": stream_bytes_per_s}
    mk_ops10 = mk_ops_per_group(10)[0]
    ceiling_gbps = 1 / max(1 / stream_bytes_per_s, mk_ops10 / (52 * 32) / int_per_s) / 1e9
    log(f"measured: {int_per_s / 1e12:.4f} T integer instructions/s = "
        f"{measured['int_results_per_clk_per_sm']:.2f} results/clk/SM at the sampled "
        f"{measured['sampled_clock_mhz']:.0f} MHz, {measured['at_max_clock']:.2f} at the "
        f"{clock_mhz:.0f} MHz maximum (table: {INT_OPS_PER_CLK_PER_SM}), from {measured['from']}; "
        f"stream {stream_bytes_per_s / 1e12:.4f} TB/s ({100 * stream_bytes_per_s / HBM_BYTES_PER_S:.1f} "
        f"% of the data sheet's {HBM_BYTES_PER_S / 1e12:.2f}); ctr_mk ceiling (nr 10, "
        f"{mk_ops10} operations per 52 x 32 bytes) {ceiling_gbps:.2f} GB/s of modeled traffic; "
        f"card: {card}")

    def measured_bound(ops: float, nbytes: float) -> tuple[float, str]:
        """The least time at the measured rates: (ms, what bounds it)."""
        ops_ms, bytes_ms = ops / int_per_s * 1e3, nbytes / stream_bytes_per_s * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    phase("8")
    # 8. The serve path: the JAX package's two documented drives, counted.
    from our_tree_tpu_torch.serve import bench as serve_bench

    def log_first_dispatch(name, line):
        first, d = line["device"]["first_dispatch"], line["device"]
        log(f"serve {name} first traffic dispatch (rung {first['rung']}): window "
            f"{first['window_us']} µs = worker wait {first['worker_wait_us']} + staging "
            f"{first['staging_us']} + card {first['device_us']} + host rest "
            f"{first['host_us']} µs; all dispatches' p50: window {d['window_p50_us']} µs, "
            f"card {d['device_p50_us']} µs; card: {card}")

    def serve_drive(name, argv, auth_failed=0):
        """One serve.bench drive in this process, counted and gated;
        ``auth_failed`` requests may answer ``auth-failed`` (the rehearsal),
        each a ``gcm-open`` one."""
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_bench.main(argv)
        wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for text in lines[:-1]:
            log(f"serve {name}: {text}")
        line = json.loads(lines[-1])
        got = counts()
        forms = form_counts()["ctr_mk"]
        rung_forms = {r: cuda_aes.MK_FORMS[cuda_build.load().ot_ctr_mk_form(r, 0)]
                      for r in line["config"]["rungs"]}
        dev_stats = line["device"]
        stages = {st: (v["p50_us"], v["p95_us"]) for st, v in line["stages"].items()}
        log(f"serve {name} ({' '.join(argv)}): p50 {line['p50_ms']} ms, p95 {line['p95_ms']} ms, "
            f"p99 {line['p99_ms']} ms, goodput {line['goodput_gbps']} GB/s, "
            f"{dev_stats['dispatches_per_s']} dispatches/s, coalesce "
            f"{line['coalesce_efficiency']}, slot fill {line['slot_fill']}, occupancy "
            f"{line['occupancy']}; stages (p50, p95) µs {stages}; lanes busy "
            f"{dev_stats['busy_s']} s = staging {dev_stats['staging_s']} s + card "
            f"{dev_stats['device_s']} s (device share {dev_stats['device_share']}) + rest, fence "
            f"{dev_stats['fence_s']} s; launches {got}; ctr_mk launches by form {forms} (the auto "
            f"form of each rung: {rung_forms}); {wall:.1f} s wall; card: {card}")
        log_first_dispatch(name, line)
        checks = {
            "rc 0": rc == 0,
            "CUDA engine": line["engine"] == aes.CUDA_ENGINE,
            "0 lost": line["lost"] == 0,
            "0 failed": line["errors"] == ({"auth-failed": auth_failed} if auth_failed else {})
            and line["ok"] == line["requests"] - auth_failed,
            "0 mismatches": line["mismatches"] == 0 and line["verified"] > 0,
            "0 steady builds": line["recompiles"] == 0,
            "ctr_mk forms sum to its launches": sum(forms.values()) == got["ctr_mk"],
            "each rung's auto form served": all(
                forms[f] > 0 for f in set(rung_forms.values())) and all(
                forms[f] == 0 for f in forms if f not in rung_forms.values()),
        }
        per = line["per_mode"]
        if "--modes" not in argv:
            checks["ctr_mk launches == engine calls"] = got["ctr_mk"] == line["engine_calls"] > 0
            checks["no other kernel"] = all(v == 0 for n, v in got.items() if n != "ctr_mk")
        else:
            # A mixed-mode drive: each mode's engine calls are its kernels'
            # launches (a GCM call one ctr_mk launch and one ghash_at call);
            # a cbc or GCM engine call is a warmed rung or one batch.
            modes = argv[argv.index("--modes") + 1].split(",")
            gcm = [m for m in modes if m in GCM_SERVE_MODES]
            calls, disp, lat = per["engine_calls"], per["dispatches"], per["latency"]
            rungs_n = len(line["config"]["rungs"])
            used = ["ctr_mk"] + (["ghash_at"] if gcm else []) + (["cbc_mk"] if "cbc" in modes
                                                                  else [])
            checks.update({
                "every mode served": set(line["modes"]) == set(modes) and all(
                    lat[m]["ok"] == lat[m]["requests"] - (auth_failed if m == "gcm-open" else 0)
                    > 0 and lat[m]["verified"] > 0 for m in modes),
                "ctr_mk launches == ctr and GCM engine calls": got["ctr_mk"] == sum(
                    calls.get(m, 0) for m in ("ctr", *gcm)) > 0,
                "one ghash_at call a GCM engine call": got["ghash_at"] == sum(
                    calls[m] for m in gcm),
                "cbc_mk launches == cbc engine calls": got["cbc_mk"] == calls.get("cbc", 0),
                "one cbc_mk launch a cbc batch, one ctr_mk and one ghash_at a GCM batch": all(
                    calls[m] == rungs_n + disp[m] > rungs_n for m in modes if m != "ctr"),
                "engine calls by mode sum": sum(calls.values()) == line["engine_calls"],
                "the bench's launch section": line["launches"] == {n: got[n] for n in used},
                "no other kernel": all(v == 0 for n, v in got.items() if n not in used),
                "auth failures as asked": per["auth_failed"] == (
                    {"gcm-open": auth_failed} if auth_failed else {}),
            })
            if "gcm" in modes:
                # The loadgen counts a gcm probe whose tag differs from the
                # host GCM's as a mismatch.
                checks["every gcm probe's ciphertext and tag equal the host GCM's"] = (
                    lat["gcm"]["verified"] > 0 and line["mismatches"] == 0)
            for m in modes:
                log(f"serve {name} mode {m}: {lat[m]['requests']} requests, p50 "
                    f"{lat[m]['p50_ms']} ms, p95 {lat[m]['p95_ms']} ms, p99 {lat[m]['p99_ms']} "
                    f"ms, {int(disp[m])} dispatches, {calls[m]} engine calls, card "
                    f"{per['device_us_per_dispatch'][m]} µs a dispatch, window p50 "
                    f"{per['window_p50_us'][m]} µs; card: {card}")
        if "--min-coalesce" in argv:
            checks["coalesce >= 0.5"] = line["coalesce_efficiency"] >= 0.5
        if not all(checks.values()):
            raise SystemExit(f"serve drive {name} failed: {checks}")
        return line, got, forms

    line_a, counts_a, forms_a = serve_drive("A", ["--requests", "500", "--mixed-sizes"])
    line_b, counts_b, forms_b = serve_drive("B", ["--requests", "300", "--tenant-heavy",
                                          "--min-coalesce", "0.5"])
    # Drive A's mix in a fresh process: there the lane's warmup is the first
    # contact with the card (context, library load, first ctr_mk<10> launch).
    # It is phase 16 (d)'s green SLO pair too: gated against drive A's line.
    slo_dir = tempfile.mkdtemp(prefix="ot_slo_")
    atexit.register(shutil.rmtree, slo_dir, True)
    slo_base = os.path.join(slo_dir, "drive_a.json")
    with open(slo_base, "w") as fh:
        json.dump(line_a, fh)
    argv = ["--requests", "500", "--mixed-sizes", "--slo", slo_base, "--slo-tolerance",
            SLO_CARD_TOLERANCE]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.serve.bench", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    try:
        line = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        line = None
    if res.returncode != 0 or line is None:
        raise SystemExit(f"serve bench in a fresh process: rc {res.returncode}, "
                         f"out {res.stdout[-2000:]!r}, err {res.stderr[-2000:]!r}")
    checks = {"CUDA engine": line["engine"] == aes.CUDA_ENGINE, "0 lost": line["lost"] == 0,
              "0 failed": line["errors"] == {} and line["ok"] == line["requests"],
              "0 mismatches": line["mismatches"] == 0 and line["verified"] > 0,
              "warmup counted the library load and the first launch":
                  line["compiles"]["warmup"] >= 2,
              "0 steady": line["compiles"]["steady"] == 0}
    log(f"serve A in a fresh process: p50 {line['p50_ms']} ms, p99 {line['p99_ms']} ms, "
        f"builds/loads/first launches: warmup {line['compiles']['warmup']}, steady "
        f"{line['compiles']['steady']}; {wall:.1f} s wall with start-up; card: {card}")
    log_first_dispatch("A (fresh process)", line)
    for text in res.stdout.splitlines():
        if text.startswith(("# slo:", "# compile:", "# pulse:")):
            log(f"serve A in a fresh process: {text}")
    if not all(checks.values()):
        raise SystemExit(f"serve bench in a fresh process failed: {checks}")
    warmup_a = line["compiles"]["warmup"]
    comp_text = next((t for t in res.stdout.splitlines() if t.startswith("# compile:")), "")
    fresh_a = {"rc": res.returncode, "line": line, "compile": {
        "text": comp_text, "count": sum(v["count"] for v in line["compiles_by_rung"].values()),
        "rungs": {r: v["count"] for r, v in line["compiles_by_rung"].items()},
        "seconds": sum(v["total_us"] for v in line["compiles_by_rung"].values()) / 1e6}}

    # Drive D, the mixed ctr,gcm,gcm-open,cbc drive, counted; then in a fresh
    # process, where warmup must count two first launches more than A's
    # (cbc_mk<10> and ghash_at).
    line_d, counts_d, forms_d = serve_drive("D", DRIVE_D)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.serve.bench", *DRIVE_D],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    try:
        line = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        line = None
    if res.returncode != 0 or line is None:
        raise SystemExit(f"serve drive D in a fresh process: rc {res.returncode}, "
                         f"out {res.stdout[-2000:]!r}, err {res.stderr[-2000:]!r}")
    checks = {"CUDA engine": line["engine"] == aes.CUDA_ENGINE, "0 lost": line["lost"] == 0,
              "0 failed": line["errors"] == {} and line["ok"] == line["requests"],
              "0 mismatches": line["mismatches"] == 0 and line["verified"] > 0,
              "warmup counted the first launches of cbc_mk and ghash_at":
                  line["compiles"]["warmup"] == warmup_a + 2,
              "0 steady": line["compiles"]["steady"] == 0,
              "cbc_mk launched": line["launches"]["cbc_mk"] == line["per_mode"]["engine_calls"][
                  "cbc"] > 0,
              "ghash_at called once a GCM engine call": line["launches"]["ghash_at"] == sum(
                  line["per_mode"]["engine_calls"][m] for m in GCM_SERVE_MODES) > 0,
              "every gcm tag equal to the host GCM's": line["mismatches"] == 0
              and line["per_mode"]["latency"]["gcm"]["verified"] > 0,
              "0 auth failures": line["per_mode"]["auth_failed"] == {}}
    log(f"serve D in a fresh process: p50 {line['p50_ms']} ms, p99 {line['p99_ms']} ms, by mode "
        + ", ".join(f"{m} p50 {v['p50_ms']} p99 {v['p99_ms']} ms"
                    for m, v in line["per_mode"]["latency"].items())
        + f"; builds/loads/first launches: warmup {line['compiles']['warmup']} (A's "
        f"{warmup_a}), steady {line['compiles']['steady']}; launches {line['launches']}; "
        f"{wall:.1f} s wall with start-up; card: {card}")
    if not all(checks.values()):
        raise SystemExit(f"serve drive D in a fresh process failed: {checks}")
    gcm_calls_d = {m: line_d["per_mode"]["engine_calls"][m] for m in GCM_SERVE_MODES}
    log(f"serve D, the GCM modes: engine calls {gcm_calls_d} (each one ctr_mk launch in the "
        f"block form and one ghash_at call of two grid launches); launches {counts_d}; ctr_mk "
        f"by form {forms_d}; card: {card}")

    # The auth-failure rehearsal: OT_FAULTS=tag_mismatch:1 fails one gcm-open
    # request's tag check at the finisher; the run still exits 0, nothing lost.
    from our_tree_tpu_torch.resilience import faults

    os.environ["OT_FAULTS"] = "tag_mismatch:1"
    faults.reset()
    try:
        line_auth, counts_auth, _ = serve_drive("rehearsal", DRIVE_AUTH, auth_failed=1)
    finally:
        del os.environ["OT_FAULTS"]
        faults.reset()
    log(f"serve rehearsal (OT_FAULTS=tag_mismatch:1 {' '.join(DRIVE_AUTH)}): errors "
        f"{line_auth['errors']}, lost {line_auth['lost']}, auth_failed "
        f"{line_auth['per_mode']['auth_failed']}, launches {counts_auth}; card: {card}")

    phase("9")
    # 9. Each kernel at its path's shape: time, plain time, both bounds.
    kernels = []

    def timing(name, kernel_fn, plain_fn, got, want, fn_ops, parts, nbytes, nblocks, sass_ops,
               plain_reps=2, nr=10, sass_upper_bound=False):
        """Time one kernel (at least ``SAMPLED_S`` of launches, the SM clock
        sampled) and its plain version at one shape; the entry fields of the
        ``kernels`` line. Bounds: the table rate at the maximum clock
        (``bound_ms``) and at the sampled one, and the probe's measured
        rates (``bound_ms_measured``). ``sass_upper_bound``: ``sass_ops``
        over-counts the stream (``sass_mk_per_thread``), so it is reported
        as a bound and no share of the kernel's time is read from it."""
        m, max_err = diff(got, want)
        if m:
            raise SystemExit(f"{name} vs plain at the path's shape: {m} mismatching words")
        ms, clocks = sampled_ms(kernel_fn)
        plain_ms = events_ms(plain_fn, plain_reps)
        groups = -(-nblocks // 32)
        ops_ms = groups * fn_ops / int_ops_per_ms
        sass_ms = groups * sass_ops / int_ops_per_ms
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        sampled_mhz = clocks["clock_mhz"]
        at_sampled = max(ops_ms * clock_mhz / sampled_mhz, bytes_ms)
        meas_ms, meas_by = measured_bound(groups * fn_ops, nbytes)
        size = f"{nblocks * 16 >> 20} MiB" if nblocks * 16 >= 1 << 20 else f"{nblocks} blocks"
        log(f"{name} at {size}: {ms:.4f} ms/launch ({nblocks * 16 / ms / 1e6:.2f} GB/s), plain "
            f"{plain_ms:.2f} ms; ptxas {ptxas.get(name.split()[0] + '_kernel<' + str(nr) + '>')}; "
            f"card: {card}")
        log(f"{name} bound: {fn_ops} operations per group of 32 blocks ({parts}) x {groups} groups / "
            f"({sm_count} SMs x {INT_OPS_PER_CLK_PER_SM}/clk x {clock_mhz:.0f} MHz) = "
            f"{ops_ms:.4f} ms; bytes {bytes_ms:.4f} ms; kernel at "
            f"{100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound at the maximum clock, "
            f"{100 * at_sampled / ms:.1f} % of {at_sampled:.4f} ms at the sampled "
            f"{sampled_mhz:.0f} MHz (nvidia-smi {clocks})")
        log(f"{name} bound at the measured rates ({int_per_s / 1e12:.4f} T integer "
            f"instructions/s, {stream_bytes_per_s / 1e12:.4f} TB/s): {meas_ms:.4f} ms "
            f"({meas_by}), kernel at {100 * meas_ms / ms:.1f} %")
        sass_meas_ms = groups * sass_ops / int_per_s * 1e3
        if sass_upper_bound:
            log(f"{name} own stream: at most {sass_ops} SASS integer instructions per group, "
                f"at most {sass_ops / fn_ops:.3f}x the operations")
        else:
            log(f"{name} own stream: {sass_ops} SASS integer instructions per group, "
                f"{sass_ops / fn_ops:.3f}x the operations ({sass_ms:.4f} ms at the table rate, "
                f"kernel at {100 * sass_ms / ms:.1f} % of that at the maximum clock, "
                f"{100 * sass_ms * clock_mhz / sampled_mhz / ms:.1f} % at the sampled clock; "
                f"{sass_meas_ms:.4f} ms at the measured rate, kernel at "
                f"{100 * sass_meas_ms / ms:.1f} %)")
        sass_key = ("sass_instructions_per_group_upper_bound" if sass_upper_bound
                    else "sass_instructions_per_group")
        return {"mismatches": m, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "bound_ms_at_sampled_clock": at_sampled, "sampled_clock_mhz": sampled_mhz,
                "bound_ms_measured": meas_ms, "bound_by_measured": meas_by,
                "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"],
                "ops_per_group": fn_ops, sass_key: sass_ops}

    def measure(name, source, replaces, kernel_fn, plain_fn, got, want, fn_ops, parts,
                nbytes, launches):
        sass_ops, hist = sass_int_ops_per_thread(sass_text, f"{name}_kernel", nr)
        entry = timing(name, kernel_fn, plain_fn, got, want, fn_ops, parts, nbytes,
                       MAIN_BYTES // 16, sass_ops, nr=nr)
        log(f"{name} top opcodes {list(hist.items())[:8]}")
        if name.startswith("ecb_"):
            loop = sass_round_loops(sass_text, f"{name}_kernel", nr)[0]
            entry["sass_round_loop"] = loop
            log(f"{name} round loop (one round a trip): {loop['int']} integer instructions, "
                f"dependency depth {loop['depth']}, opcodes {loop['hist']}; ptxas "
                f"{ptxas.get(f'{name}_kernel<{nr}>')}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, **entry, "library_ms": None})

    w, ctr, rk_ctr, nr = tensors(MAIN_BYTES // 16, bench.KEY, WRAP_NONCES[4], seed=1337)
    measure("ctr_gen", "our_tree_tpu_torch/csrc/ctr_gen.cu", "our_tree_tpu/ops/pallas_aes.py:601",
            lambda: cuda_aes.ctr_crypt_words_fused(w, ctr, rk_ctr, nr),
            lambda: cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk_ctr, nr),
            cuda_aes.ctr_crypt_words_fused(w, ctr, rk_ctr, nr),
            cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk_ctr, nr),
            *ctr_ops_per_group(nr), 2 * w.numel() * 4 + 4 * 4 + rk_ctr.numel() * 4,
            ctr_counts["ctr_gen"])
    out = cuda_aes.ctr_crypt_words_fused(w, ctr, rk_ctr, nr)
    sum_ms = events_ms(lambda: bench.u32_sum(out), 10)
    log(f"chain step besides the kernel: digest sum {sum_ms:.4f} ms at {MAIN_BYTES >> 20} MiB")
    del w, out
    ecb_bytes = 2 * words.numel() * 4 + rk.numel() * 4
    measure("ecb_encrypt", "our_tree_tpu_torch/csrc/ecb.cu", "our_tree_tpu/ops/pallas_aes.py:259",
            lambda: cuda_aes.encrypt_words(words, rk, nr),
            lambda: bitslice.encrypt_words(words, rk, nr),
            ecb_ct, bitslice.encrypt_words(words, rk, nr),
            *ecb_ops_per_group(nr, decrypt=False), ecb_bytes, block_counts["ecb_encrypt"])
    measure("ecb_decrypt", "our_tree_tpu_torch/csrc/ecb.cu", "our_tree_tpu/ops/pallas_aes.py:259",
            lambda: cuda_aes.decrypt_words(ecb_ct, rk_dec, nr),
            lambda: bitslice.decrypt_words(ecb_ct, rk_dec, nr),
            ecb_pt, bitslice.decrypt_words(ecb_ct, rk_dec, nr),
            *ecb_ops_per_group(nr, decrypt=True), ecb_bytes, block_counts["ecb_decrypt"])
    # The card's dependent-issue latency: the 65,536-step chain over one word,
    # each step a LOP3 that waits on the one before; a 128-step launch over
    # the same word, timed in a CUDA graph, stands for the launch's share.
    _lat_name, lat_chain, lat_ilp = ceiling.LATENCY
    lat_ms, lat_smi = sampled_ms(lambda: ceiling.chain(lat_x, lat_chain, lat_ilp))
    lat_short_ms = graph_ms(lambda: ceiling.chain(lat_x, 128, 1))
    lat_loop = sass_round_loops(sass_text, "chain_kernel", (lat_chain, lat_ilp))[0]
    lat_cycles = lat_ms * 1e-3 * lat_smi["clock_mhz"] * 1e6 / lat_chain
    log(f"dependent-issue latency: chain_kernel<{lat_chain},{lat_ilp}> over one word "
        f"{lat_ms * 1e3:.3f} us/launch at the sampled {lat_smi['clock_mhz']:.0f} MHz = "
        f"{lat_cycles:.4f} cycles a dependent LOP3 (its SASS run: {lat_loop['int']} integer "
        f"instructions, dependency depth {lat_loop['depth']}); a 128-step launch in a CUDA graph "
        f"{lat_short_ms * 1e3:.3f} us, {100 * lat_short_ms / lat_ms:.2f} % of it; nvidia-smi "
        f"{lat_smi}; card: {card}")
    if lat_short_ms >= 0.05 * lat_ms or lat_loop["depth"] < 128:
        raise SystemExit("the latency chain is too short against its launch, or its SASS is not "
                         "one dependent LOP3 a step")

    # A shared-memory load's latency: the dependent-load chase, one thread,
    # its own cycle counter.
    import ctypes

    chase = ctypes.CDLL(chase_so)
    chase.ot_smem_chase.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chase.ot_smem_chase.restype = ctypes.c_int
    chase_steps = 1 << 20
    chase_out = torch.zeros(1, dtype=torch.int32, device=dev)
    chase_cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    per_load = []
    for _ in range(3):
        if chase.ot_smem_chase(chase_steps, chase_out.data_ptr(), chase_cycles.data_ptr()):
            raise SystemExit("the shared-memory chase did not launch")
        torch.cuda.synchronize()
        per_load.append(int(chase_cycles.item()) / chase_steps)
    lds_cycles = min(per_load)
    log(f"shared-memory load latency: {lds_cycles:.3f} cycles a dependent LDS (chase of "
        f"{chase_steps} loads, best of {per_load}); dependent integer step {lat_cycles:.4f} "
        f"cycles; card: {card}")
    # A shuffle's latency (seq_encrypt's lane forms): the dependent-shuffle
    # chase, one warp, its own cycle counter.
    chase.ot_shfl_chase.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chase.ot_shfl_chase.restype = ctypes.c_int
    shfl_out = torch.zeros(32, dtype=torch.int32, device=dev)
    per_shfl = []
    for _ in range(3):
        if chase.ot_shfl_chase(chase_steps, shfl_out.data_ptr(), chase_cycles.data_ptr()):
            raise SystemExit("the shuffle chase did not launch")
        torch.cuda.synchronize()
        per_shfl.append(int(chase_cycles.item()) / chase_steps)
    shfl_cycles = min(per_shfl)
    log(f"shuffle latency: {shfl_cycles:.3f} cycles a dependent SHFL (chase of {chase_steps} "
        f"shuffles, best of {per_shfl}); card: {card}")
    # The shared-memory issue rate: warp-wide accesses a cycle of one SM, at
    # 1, 2 and 4 warps (the best of three launches each).
    chase.ot_smem_issue.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chase.ot_smem_issue.restype = ctypes.c_int
    issue_reps = 1 << 14
    issue_out = torch.zeros(32 * max(SMEM_RATE_WARPS), dtype=torch.int32, device=dev)
    issue_cycles = torch.zeros(max(SMEM_RATE_WARPS), dtype=torch.int64, device=dev)
    smem_rate = {}
    for w in SMEM_RATE_WARPS:
        rates = []
        for _ in range(3):
            if chase.ot_smem_issue(issue_reps, w, issue_out.data_ptr(), issue_cycles.data_ptr()):
                raise SystemExit("the shared-memory issue probe did not launch")
            torch.cuda.synchronize()
            rates.append(w * issue_reps * 80 / int(issue_cycles[:w].max()))
        smem_rate[w] = max(rates)
    log("shared-memory issue rate (independent warp-wide accesses, 3 loads to 2 stores): " + ", ".join(
        f"{w} warp{'s' if w > 1 else ''} {r:.4f} a cycle" for w, r in smem_rate.items())
        + f" of one SM; card: {card}")

    def arc4_bound_cycles(s_n: int) -> dict:
        """The ARC4 kernel's latency bound a byte at ``s_n`` streams (one
        warp a block of 32): the issue bound of the word-per-byte layout at
        the measured rate for the warps each SM holds, and the dependent
        step; the larger bounds."""
        warps = -(-(-(-s_n // 32)) // sm_count)
        if warps not in smem_rate:
            raise SystemExit(f"no shared-memory issue rate measured at {warps} warps an SM")
        issue = ARC4_ACCESSES_PER_BYTE * warps / smem_rate[warps]
        dep = ARC4_DEPENDENT_STEPS * lat_cycles
        return {"warps_per_sm": warps, "smem_accesses_per_cycle": smem_rate[warps],
                "issue_cycles_per_byte": issue, "dependent_cycles_per_byte": dep,
                "bound_cycles_per_byte": max(issue, dep),
                "bound_by": "shared-memory issue" if issue >= dep else "dependent step"}

    def latency_ms(depth: int, mhz: float) -> float:
        """The latency bound: ``depth`` dependent integer instructions at the
        measured cycles each, at the SM clock sampled while the kernel ran."""
        return depth * lat_cycles / (mhz * 1e3)

    # The one-block ECB launch the sequential encrypts used to make per block.
    one = cbc_pt[:1].contiguous()

    def host_issue_ms(fn):
        """The host's time to issue one launch: 200 launches, no sync."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        issue = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        return issue

    def in_turns(fns, turns=VARIANT_TURNS, reps=100):
        """Each of ``fns`` (the first is the kernel) timed by ``graph_ms``
        (``reps`` calls a graph) in ``turns`` turns, the order reversed every
        other turn: per variant the median, least and quartiles (ms), the
        turns in which the kernel was the faster of the two, and the times."""
        times = {name: [] for name in fns}
        for turn in range(turns):
            for name in (list(fns) if turn % 2 == 0 else list(reversed(list(fns)))):
                times[name].append(graph_ms(fns[name], reps))
        kernel = times[next(iter(fns))]
        out = {}
        for name, v in times.items():
            q = statistics.quantiles(v, n=4)
            out[name] = {"median_ms": statistics.median(v), "min_ms": min(v), "q1_ms": q[0],
                         "q3_ms": q[2], "kernel_faster_turns": sum(
                             a < b for a, b in zip(kernel, v)), "times_ms": v}
        return out

    def turns_line(res):
        return "; ".join(f"{k} median {v['median_ms'] * 1e3:.3f} us (least "
                         f"{v['min_ms'] * 1e3:.3f}, quartiles {v['q1_ms'] * 1e3:.3f}-"
                         f"{v['q3_ms'] * 1e3:.3f}, kernel faster in {v['kernel_faster_turns']} of "
                         f"{VARIANT_TURNS})" for k, v in res.items())

    # One block by form: the auto form (the block form, as AES._ecb1 takes
    # it), and each form forced. The latency bound is the forward cipher's
    # dependent path as the group form's round loop gives it (the same bound
    # for both forms: it is the function's), the roofline bound one block's
    # share of a group's operations or its 32 bytes and the schedule.
    ecb_depth = sass_block_kernel(sass_text, "ecb_encrypt_kernel", nr, nr)["depth"]
    ecb_loop = sass_round_loops(sass_text, "ecb_encrypt_kernel", nr)[0]
    ecb_blk = sass_block_kernel(sass_text, "ecb_encrypt_block_kernel", nr, nr)
    one_roof, one_by = measured_bound(ecb_ops_per_group(nr, decrypt=False)[0] / 32,
                                      32 + 4 * rk.numel())
    one_ops_ms = ecb_ops_per_group(nr, decrypt=False)[0] / 32 / int_ops_per_ms
    one_bytes_ms = (32 + 4 * rk.numel()) / HBM_BYTES_PER_S * 1e3
    one_forms = {}
    for form in cuda_aes.ECB_FORMS:
        fn = lambda form=form: cuda_aes.encrypt_words(one, rk, nr, form=form)  # noqa: E731
        host_us = 1e3 * host_issue_ms(fn)
        one_ms, one_smi = sampled_ms(fn)
        one_card_ms = graph_ms(fn)
        one_lat = latency_ms(ecb_depth, one_smi["clock_mhz"])
        one_forms[form] = {
            "form": cuda_aes.ECB_FORMS[cuda_build.load().ot_ecb_encrypt_form(1, cuda_aes.ECB_FORMS.index(form))],
            "ms": one_ms, "card_ms_graph": one_card_ms, "host_issue_ms": host_us / 1e3,
            "sampled_clock_mhz": one_smi["clock_mhz"], "roofline_bound_ms": one_roof,
            "latency_bound_ms": one_lat, "dependent_instructions": ecb_depth,
            "share_of_larger_bound": max(one_lat, one_roof) / one_card_ms}
        log(f"one-block ecb_encrypt launch, form {form} (runs the {one_forms[form]['form']} "
            f"form): host issue {host_us:.2f} us, {one_ms * 1e3:.2f} us back to back at the "
            f"sampled {one_smi['clock_mhz']:.0f} MHz, {one_card_ms * 1e3:.3f} us of card per "
            f"launch in a CUDA graph; latency bound {ecb_depth} x {lat_cycles:.3f} cycles = "
            f"{one_lat * 1e3:.4f} us (the group form's round loop: {ecb_loop['int']} integer "
            f"instructions, depth {ecb_loop['depth']}), roofline bound {one_roof * 1e3:.6f} us "
            f"({one_by}); the graph's launch at "
            f"{100 * one_forms[form]['share_of_larger_bound']:.1f} % of the larger; card: {card}")
    log(f"ecb_encrypt_block_kernel<{nr}> SASS: {ecb_blk['int']} integer instructions a block "
        f"({'rolled' if ecb_blk['rolled'] else 'unrolled'} rounds), dependency depth "
        f"{ecb_blk['depth']}, opcodes {list(ecb_blk['hist'].items())[:8]}; ptxas "
        f"{ptxas.get(f'ecb_encrypt_block_kernel<{nr}>')}")
    # The crossing: both forms from 1 block to 2^20, in a CUDA graph (card
    # time) and back to back; kEcbBlockFormMax is the largest size at which
    # the block form is the faster in the graph.
    lib = cuda_build.load()
    ecb_table = []
    for n in ECB_FORM_SIZES:
        w_n = words[:n]
        row = {"n_blocks": n, "auto_form": cuda_aes.ECB_FORMS[lib.ot_ecb_encrypt_form(n, 0)]}
        for form in ("group", "block"):
            fn = lambda w_n=w_n, form=form: cuda_aes.encrypt_words(w_n, rk, nr, form=form)  # noqa: E731
            reps = max(3, int(0.2 / (events_ms(fn, 1) / 1e3)))
            row[f"{form}_ms"] = events_ms(fn, reps)
            row[f"{form}_card_ms_graph"] = graph_ms(fn)
        row["roofline_bound_ms"] = measured_bound(n / 32 * ecb_ops_per_group(nr, decrypt=False)[0],
                                                  32 * n + 4 * rk.numel())[0]
        row["faster"] = "block" if row["block_card_ms_graph"] < row["group_card_ms_graph"] else "group"
        ecb_table.append(row)
        log(f"ecb_encrypt forms at {n} blocks: in a CUDA graph group "
            f"{row['group_card_ms_graph'] * 1e3:.3f} us, block {row['block_card_ms_graph'] * 1e3:.3f} "
            f"us; back to back group {row['group_ms'] * 1e3:.3f} us, block "
            f"{row['block_ms'] * 1e3:.3f} us (faster in the graph: {row['faster']}; auto: "
            f"{row['auto_form']}); roofline bound {row['roofline_bound_ms'] * 1e3:.4f} us; card: "
            f"{card}")
    log(f"ecb_encrypt auto form picks the faster form at every size of the table: "
        f"{all(r['auto_form'] == r['faster'] for r in ecb_table)}")
    ecb_entry = next(e for e in kernels if e["name"] == "ecb_encrypt")
    ecb_entry["one_block"] = one_forms["auto"]
    ecb_entry["one_block_by_form"] = one_forms
    ecb_entry["launches_by_form"] = block_forms
    ecb_entry["block_form"] = {
        "name": "ecb_encrypt_block_kernel", "route": "cuda",
        "source": "our_tree_tpu_torch/csrc/ecb.cu", "replaces": "our_tree_tpu/ops/pallas_aes.py:259",
        "launches": block_forms["block"], "max_abs_err": 0, "ms": one_forms["block"]["ms"],
        "card_ms_graph": one_forms["block"]["card_ms_graph"],
        "plain_ms": events_ms(lambda: bitslice.encrypt_words(one, rk, nr), 20),
        "bound_ms": max(one_ops_ms, one_bytes_ms),
        "bound_by": "operations" if one_ops_ms >= one_bytes_ms else "bytes",
        "bound_ms_measured": one_roof, "latency_bound_ms": one_forms["block"]["latency_bound_ms"],
        "library_ms": None, "shape": "one block (AES._ecb1, a partial step of byte-granular CFB128)",
        "sass_int_per_block": ecb_blk["int"], "sass_depth": ecb_blk["depth"],
        "rolled_rounds": ecb_blk["rolled"], "forms_table": ecb_table}
    m, _ = diff(cuda_aes.encrypt_words(one, rk, nr, form="block"), bitslice.encrypt_words(one, rk, nr))
    if m:
        raise SystemExit(f"ecb_encrypt block form vs plain at one block: {m} mismatching words")
    # ctr_gen's one-block tail launch: a crypt_ctr call that ends mid-block
    # makes its last keystream block with one ctr_gen launch over one block
    # (models/aes.py AES.crypt_ctr), in the auto form (the block form) and
    # in each form forced. The latency bound is the group form's round loop
    # times the rounds (the function's path, the same for both forms).
    tail_depth = sass_round_loops(sass_text, "ctr_gen_kernel", nr)[0]["depth"] * (nr - 1)
    tail_roof, tail_by = measured_bound(ctr_ops_per_group(nr)[0] / 32, 32 + 16 + 4 * rk_ctr.numel())
    tail_forms = {}
    for form in cuda_aes.CTR_GEN_FORMS:
        tail = lambda form=form: cuda_aes.ctr_crypt_words_fused(one, ctr, rk_ctr, nr, form=form)  # noqa: E731
        m, _ = diff(tail(), cuda_aes.ctr_crypt_words_fused_plain(one, ctr, rk_ctr, nr))
        if m:
            raise SystemExit(f"ctr_gen ({form} form) vs plain at one block: {m} mismatching words")
        tail_ms, tail_smi = sampled_ms(tail)
        tail_card = graph_ms(tail)
        tail_lat = latency_ms(tail_depth, tail_smi["clock_mhz"])
        tail_forms[form] = {
            "form": cuda_aes.CTR_GEN_FORMS[cuda_build.load().ot_ctr_gen_form(
                1, cuda_aes.CTR_GEN_FORMS.index(form))],
            "ms": tail_ms, "card_ms_graph": tail_card, "host_issue_ms": host_issue_ms(tail),
            "sampled_clock_mhz": tail_smi["clock_mhz"], "latency_bound_ms": tail_lat,
            "dependent_instructions": tail_depth, "roofline_bound_ms": tail_roof,
            "share_of_larger_bound": max(tail_lat, tail_roof) / tail_card}
        log(f"one-block ctr_gen launch (crypt_ctr's tail), form {form} (runs the "
            f"{tail_forms[form]['form']} form): host issue "
            f"{tail_forms[form]['host_issue_ms'] * 1e3:.2f} us, {tail_ms * 1e3:.2f} us back to "
            f"back, {tail_card * 1e3:.3f} us of card in a CUDA graph; latency bound {tail_depth} x "
            f"{lat_cycles:.3f} cycles = {tail_lat * 1e3:.4f} us, roofline bound "
            f"{tail_roof * 1e3:.6f} us ({tail_by}); at "
            f"{100 * tail_forms[form]['share_of_larger_bound']:.1f} % of the larger; card: {card}")
    ctr_blk = sass_block_kernel(sass_text, "ctr_gen_block_kernel", nr, nr)
    log(f"ctr_gen_block_kernel<{nr}> SASS: {ctr_blk['int']} integer instructions a block "
        f"({'rolled' if ctr_blk['rolled'] else 'unrolled'} rounds; {ctr_blk['fma']} of them IMAD "
        f"on the FMA pipe), dependency depth {ctr_blk['depth']}; ptxas "
        f"{ptxas.get(f'ctr_gen_block_kernel<{nr}>')}")
    # The crossing: both forms from 1 block to 2^20, in a CUDA graph (card
    # time) and back to back; kCtrGenBlockFormMax is the largest size at which
    # the block form is the faster in the graph.
    ctr_table = []
    for n in ECB_FORM_SIZES:
        w_n = words[:n]
        row = {"n_blocks": n,
               "auto_form": cuda_aes.CTR_GEN_FORMS[cuda_build.load().ot_ctr_gen_form(n, 0)]}
        for form in ("group", "block"):
            fn = lambda w_n=w_n, form=form: cuda_aes.ctr_crypt_words_fused(  # noqa: E731
                w_n, ctr, rk_ctr, nr, form=form)
            reps = max(3, int(0.2 / (events_ms(fn, 1) / 1e3)))
            row[f"{form}_ms"] = events_ms(fn, reps)
            row[f"{form}_card_ms_graph"] = graph_ms(fn)
        row["roofline_bound_ms"] = measured_bound(n / 32 * ctr_ops_per_group(nr)[0],
                                                  32 * n + 16 + 4 * rk_ctr.numel())[0]
        row["faster"] = "block" if row["block_card_ms_graph"] < row["group_card_ms_graph"] else "group"
        ctr_table.append(row)
        log(f"ctr_gen forms at {n} blocks: in a CUDA graph group "
            f"{row['group_card_ms_graph'] * 1e3:.3f} us, block {row['block_card_ms_graph'] * 1e3:.3f} "
            f"us; back to back group {row['group_ms'] * 1e3:.3f} us, block "
            f"{row['block_ms'] * 1e3:.3f} us (faster in the graph: {row['faster']}; auto: "
            f"{row['auto_form']}); roofline bound {row['roofline_bound_ms'] * 1e3:.4f} us; card: "
            f"{card}")
    log(f"ctr_gen auto form picks the faster form at every size of the table: "
        f"{all(r['auto_form'] == r['faster'] for r in ctr_table)}")
    # crypt_ctr's tail path, counted: chunks that end mid-block through
    # AES.crypt_ctr on the card, equal to the CPU's; each partial tail (and
    # each short bulk run) is one block-form launch.
    tail_ctx, tail_cpu = aes.AES(bench.KEY, device=dev), aes.AES(bench.KEY, device="cpu")
    tail_data = np.random.default_rng(7).integers(0, 256, sum(CTR_TAIL_CHUNKS), dtype=np.uint8)
    tail_st = tail_st_cpu = (0, np.frombuffer(bytes.fromhex(WRAP_NONCES[4]), np.uint8),
                             np.zeros(16, np.uint8))
    reset_counts()
    tail_pos, tail_same = 0, True
    for size in CTR_TAIL_CHUNKS:
        o, *tail_st = tail_ctx.crypt_ctr(*tail_st, tail_data[tail_pos:tail_pos + size])
        o_cpu, *tail_st_cpu = tail_cpu.crypt_ctr(*tail_st_cpu, tail_data[tail_pos:tail_pos + size])
        tail_same &= bool(np.array_equal(o, o_cpu) and tail_st[0] == tail_st_cpu[0]
                          and np.array_equal(tail_st[1], tail_st_cpu[1])
                          and np.array_equal(tail_st[2], tail_st_cpu[2]))
        tail_pos += size
    torch.cuda.synchronize()
    tail_path_forms = form_counts()["ctr_gen"]
    log(f"crypt_ctr in chunks {CTR_TAIL_CHUNKS} on the card: equal to the CPU's "
        f"{tail_same}; ctr_gen launches by form {tail_path_forms}; card: {card}")
    if not tail_same or tail_path_forms["group"] or not tail_path_forms["block"]:
        raise SystemExit(f"crypt_ctr's tail path failed: equal {tail_same}, forms {tail_path_forms}")
    ctr_entry = next(e for e in kernels if e["name"] == "ctr_gen")
    ctr_entry["one_block_tail"] = tail_forms["auto"]
    ctr_entry["one_block_tail_by_form"] = tail_forms
    ctr_entry["launches_by_form"] = ctr_forms
    ctr_entry["former_256MiB_ms"] = CTR_GEN_256MIB_MS
    ctr_entry["within_2_percent_of_former_256MiB"] = abs(
        ctr_entry["ms"] / CTR_GEN_256MIB_MS - 1) <= 0.02
    one_ctr_ops_ms = ctr_ops_per_group(nr)[0] / 32 / int_ops_per_ms
    one_ctr_bytes_ms = (32 + 16 + 4 * rk_ctr.numel()) / HBM_BYTES_PER_S * 1e3
    ctr_entry["block_form"] = {
        "name": "ctr_gen_block_kernel", "route": "cuda",
        "source": "our_tree_tpu_torch/csrc/ctr_gen.cu",
        "replaces": "our_tree_tpu/ops/pallas_aes.py:601",
        "launches": tail_path_forms["block"],
        "launches_path": f"AES.crypt_ctr in chunks {CTR_TAIL_CHUNKS} (the CTR main path: "
                         f"{ctr_forms['block']})",
        "max_abs_err": 0, "ms": tail_forms["block"]["ms"],
        "card_ms_graph": tail_forms["block"]["card_ms_graph"],
        "plain_ms": events_ms(lambda: cuda_aes.ctr_crypt_words_fused_plain(one, ctr, rk_ctr, nr), 20),
        "bound_ms": max(one_ctr_ops_ms, one_ctr_bytes_ms),
        "bound_by": "operations" if one_ctr_ops_ms >= one_ctr_bytes_ms else "bytes",
        "bound_ms_measured": tail_roof, "latency_bound_ms": tail_forms["block"]["latency_bound_ms"],
        "library_ms": None,
        "shape": "one block (AES.crypt_ctr's tail)",
        "sass_int_per_block": ctr_blk["int"], "sass_fma_per_block": ctr_blk["fma"],
        "sass_depth": ctr_blk["depth"], "rolled_rounds": ctr_blk["rolled"],
        "forms_table": ctr_table}
    log(f"ctr_gen at 256 MiB (group form): {ctr_entry['ms']:.4f} ms a launch against "
        f"{CTR_GEN_256MIB_MS} before its block form: within 2 %: "
        f"{ctr_entry['within_2_percent_of_former_256MiB']}; card: {card}")

    # seq_encrypt: the two sequential encrypts of phase 5 (one stream of
    # 4,096 blocks), the batch (4,096 streams of 64 blocks) and the sweep's
    # cbc-batch launch (32 streams of 65,536 blocks), each one launch in the
    # form the auto form picks. Each is timed in turns against the parent
    # kernel (SEQ_PARENT_SOURCE, one thread a stream); its bound is the larger
    # of its form's dependent path and its issue floor (seq_bound), the
    # thread form's SASS depth beside it as the former bound.
    seq_int, seq_depth, seq_loop = {}, {}, {}
    seq_pipes = {}
    for c in (0, 1):
        blk = sass_block_kernel(sass_text, "seq_encrypt_kernel", (nr, c), nr)
        seq_int[c], seq_depth[c], seq_loop[c] = blk["int"], blk["depth"], blk["round_loop"]
        seq_pipes[("thread", c)] = {"alu": blk["int"] - blk["fma"], "fma": blk["fma"], "shfl": 0}
        for form, q in SEQ_LANES_Q.items():
            seq_pipes[(form, c)] = sass_seq_lanes(sass_text, nr, c, q)
    log(f"seq_encrypt SASS (nr {nr}): thread form round loop {seq_loop[0]['int']} (CBC) / "
        f"{seq_loop[1]['int']} (CFB128) integer instructions, dependency depth "
        f"{seq_loop[0]['depth']} / {seq_loop[1]['depth']}; about {seq_int[0]} / {seq_int[1]} "
        f"integer instructions a block; ptxas {ptxas.get(f'seq_encrypt_kernel<{nr},0>')} / "
        f"{ptxas.get(f'seq_encrypt_kernel<{nr},1>')}")
    for (form, c), p in seq_pipes.items():
        log(f"seq_encrypt {form} form, {'CFB128' if c else 'CBC'}, a block of one warp: "
            f"{p['alu']} integer-pipe, {p['fma']} FMA-pipe (IMAD) and {p['shfl']} shuffle "
            f"instructions" + (f", dependency depth {p['depth']} (SASS)" if "depth" in p else "")
            + (f"; memory reads in the block loop {p['loads']}" if "loads" in p else ""))
        if p.get("table_reads"):
            raise SystemExit(f"seq_encrypt {form}: the block loop reads {p['table_reads']} "
                             f"(local, shared or constant memory: a table)")
    shfl_cycles_seq = shfl_cycles

    def seq_bound(form: str, c: int, s_n: int, n: int, mhz: float) -> dict:
        """The latency bound of ``s_n`` streams of ``n`` blocks in ``form``:
        n times the larger of the block's dependent path (the lane forms: the
        circuit's integer steps at the measured dependent latency and its
        shuffles at the measured shuffle latency; the thread form: its SASS
        depth) and the issue floor of the warps each sub-partition holds (a
        warp instruction every 2 cycles on the integer pipe and on the FMA
        pipe; the shuffles' rate is not counted)."""
        p = seq_pipes[(form, c)]
        if form == "thread":
            path = {"sass_depth": seq_depth[c]}
            path_cycles = seq_depth[c] * lat_cycles
            warps = -(-s_n // 32)
        else:
            path = seq_lane_path(nr, SEQ_LANES_Q[form])
            path_cycles = path["alu_steps"] * lat_cycles + path["shuffles"] * shfl_cycles_seq
            warps = -(-s_n // (8 // SEQ_LANES_Q[form]))
        per_smsp = max(1, -(-warps // (4 * sm_count)))
        issue_cycles = per_smsp * 2 * max(p["alu"], p["fma"])
        cycles = max(path_cycles, issue_cycles)
        return {"form": form, "path": path, "path_cycles_per_block": path_cycles,
                "warps": warps, "warps_per_subpartition": per_smsp,
                "issue_cycles_per_block": issue_cycles,
                "bound_by": "dependent path" if path_cycles >= issue_cycles else "issue",
                "bound_ms": n * cycles / (mhz * 1e3), "sampled_clock_mhz": mhz,
                "former_bound_ms": latency_ms(n * seq_depth[c], mhz)}

    parent = ctypes.CDLL(seq_parent_so)
    vp = ctypes.c_void_p
    parent.ot_seq_parent.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, vp]
    parent.ot_seq_parent.restype = ctypes.c_int

    def seq_parent(w, ivs, cfb, out, iv_out):
        rc = parent.ot_seq_parent(w.data_ptr(), out.data_ptr(), ivs.data_ptr(), iv_out.data_ptr(),
                                  rk.data_ptr(), w.shape[0], w.shape[1], int(cfb), nr,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"seq_encrypt's parent kernel did not launch: cudaError {rc}")

    def turn_ms(fn) -> float:
        """Card ms a call of ``fn``: calls captured in one CUDA graph lasting
        about SEQ_TURN_S, replayed once to warm it, then timed once."""
        reps = max(1, min(200, int(SEQ_TURN_S * 1e3 / events_ms(fn, 1))))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        del graph
        return start.elapsed_time(stop) / reps

    first = cbc_pt[:SEQ_BLOCKS].contiguous()
    sweep_streams = words[:32 * 65536].reshape(32, 65536, 4)
    sweep_ivs = words[-32:].contiguous()
    seq_shapes = {"single_cbc": (first.reshape(1, -1, 4), ivw.reshape(1, 4), False),
                  "single_cfb128": (first.reshape(1, -1, 4), ivw.reshape(1, 4), True),
                  "batch": (streams, stream_ivs, False),
                  "sweep_cbc_batch": (sweep_streams, sweep_ivs, False)}
    seq_turns, seq_turn_fail = {}, []
    for label, (w_t, iv_t, cfb) in seq_shapes.items():
        s_n, n = w_t.shape[0], w_t.shape[1]
        out_p, iv_p = torch.empty_like(w_t), torch.empty_like(iv_t)
        seq_parent(w_t, iv_t, cfb, out_p, iv_p)
        got, got_iv = cuda_aes.seq_encrypt(w_t, iv_t, rk, nr, cfb)
        m = diff(got, out_p)[0] + diff(got_iv, iv_p)[0]
        del got, got_iv
        form = cuda_aes.seq_encrypt_form(s_n)
        times = {"parent": [], "new": []}
        for _ in range(SEQ_TURNS):
            for who in ("parent", "new", "new", "parent"):
                if who == "parent":
                    times[who].append(turn_ms(lambda: seq_parent(w_t, iv_t, cfb, out_p, iv_p)))
                else:
                    times[who].append(turn_ms(lambda: cuda_aes.seq_encrypt(w_t, iv_t, rk, nr, cfb)))
        med = {k: statistics.median(v) for k, v in times.items()}
        won_every_turn = all(max(times["new"][2 * t:2 * t + 2]) < min(times["parent"][2 * t:2 * t + 2])
                             for t in range(SEQ_TURNS))
        ms, clocks = sampled_ms(lambda: cuda_aes.seq_encrypt(w_t, iv_t, rk, nr, cfb))
        b = seq_bound(form, int(cfb), s_n, n, clocks["clock_mhz"])
        seq_turns[label] = {"streams": s_n, "blocks_per_stream": n, "mode": "cfb128" if cfb else "cbc",
                            "form": form, "mismatching_words_vs_parent": m, "ms": times,
                            "median_ms": med, "new_over_parent": med["new"] / med["parent"],
                            "new_faster_in_every_turn": won_every_turn,
                            "back_to_back_ms": ms, "us_per_block": 1e3 * med["new"] / n,
                            "bound": b, "share_of_bound": b["bound_ms"] / med["new"]}
        log(f"seq_encrypt {label} ({s_n} x {n} blocks, {'CFB128' if cfb else 'CBC'}, form {form}): "
            f"parent {med['parent']:.5f} ms, new {med['new']:.5f} ms a launch (medians of "
            f"{2 * SEQ_TURNS} CUDA-graph timings each, in turns parent, new, new, parent), "
            f"new/parent {med['new'] / med['parent']:.4f}, faster in every turn {won_every_turn}; "
            f"{1e3 * med['new'] / n:.4f} us a block step; bound {b['bound_ms']:.5f} ms "
            f"({b['bound_by']}: path {b['path_cycles_per_block']:.1f} cycles a block "
            f"{b['path']}, issue {b['issue_cycles_per_block']} cycles a block at "
            f"{b['warps_per_subpartition']} warp(s) a sub-partition, at "
            f"{clocks['clock_mhz']:.0f} MHz), kernel at {100 * b['bound_ms'] / med['new']:.1f} %; "
            f"the former bound (the thread form's SASS depth, {n} x {seq_depth[int(cfb)]} x "
            f"{lat_cycles:.3f} cycles) {b['former_bound_ms']:.5f} ms; outputs equal to the "
            f"parent's: {m == 0}; card: {card}")
        if m:
            seq_turn_fail.append(f"{label}: {m} words differ from the parent's")
        if label.startswith("single") and not won_every_turn:
            seq_turn_fail.append(f"{label}: not faster than the parent in every turn {times}")
        if not label.startswith("single") and med["new"] > med["parent"]:
            seq_turn_fail.append(f"{label}: slower than the parent in the median of turns {med}")
        del out_p, iv_p
    del sweep_streams
    if seq_turn_fail:
        raise SystemExit("seq_encrypt against its parent: " + "; ".join(seq_turn_fail))
    # Every form at 1 to 16,384 streams of 64 blocks (the auto form's
    # crossings, seq_form.cuh), each the card time of a CUDA graph.
    seq_table = []
    for s_n in SEQ_FORM_STREAMS:
        w_t = words[:s_n * 64].reshape(s_n, 64, 4)
        iv_t = words[-s_n:].contiguous()
        row = {"streams": s_n, "auto_form": cuda_aes.seq_encrypt_form(s_n)}
        for form in cuda_aes.SEQ_FORMS[1:]:
            row[f"{form}_ms"] = turn_ms(
                lambda form=form: cuda_aes.seq_encrypt(w_t, iv_t, rk, nr, False, form=form))
        row["fastest"] = min(cuda_aes.SEQ_FORMS[1:], key=lambda f: row[f"{f}_ms"])
        seq_table.append(row)
        log(f"seq_encrypt forms at {s_n} streams x 64 blocks (CBC): " + ", ".join(
            f"{f} {row[f + '_ms'] * 1e3:.2f} us" for f in cuda_aes.SEQ_FORMS[1:])
            + f" (fastest {row['fastest']}; auto {row['auto_form']}); card: {card}")
    log(f"seq_encrypt auto form picks the fastest form at every size of the table: "
        f"{all(r['auto_form'] == r['fastest'] for r in seq_table)}")
    single = {}
    for mode, label in (("cbc_encrypt", "single_cbc"), ("cfb128_encrypt", "single_cfb128")):
        t = seq_turns[label]
        single[mode] = {"ms": t["median_ms"]["new"], "parent_ms": t["median_ms"]["parent"],
                        "us_per_block": t["us_per_block"], "form": t["form"],
                        "latency_bound_ms": t["bound"]["bound_ms"],
                        "former_latency_bound_ms": t["bound"]["former_bound_ms"],
                        "share_of_bound": t["share_of_bound"],
                        "dependent_instructions_per_block": seq_depth[int(label.endswith("cfb128"))],
                        "sampled_clock_mhz": t["bound"]["sampled_clock_mhz"]}
    batch_got = cuda_aes.seq_encrypt(streams, stream_ivs, rk, nr, False)
    batch_want = cuda_aes.seq_encrypt_plain(streams, stream_ivs, rk, nr, False)
    m, batch_err = diff(batch_got[0], batch_want[0])
    m += diff(batch_got[1], batch_want[1])[0]
    if m:
        raise SystemExit(f"seq_encrypt vs plain at the batch's shape: {m} mismatching words")
    batch_ms, batch_smi = sampled_ms(
        lambda: aes.cbc_encrypt_words_batch(streams, stream_ivs, rk, nr, eng))
    batch_plain_ms = events_ms(lambda: cuda_aes.seq_encrypt_plain(streams, stream_ivs, rk, nr,
                                                                  False), 1)
    n_batch = streams.shape[0] * streams.shape[1]
    seq_ops = n_batch / 32 * mk_ops_per_group(nr)[0]
    seq_bytes = 2 * streams.numel() * 4 + 2 * stream_ivs.numel() * 4 + rk.numel() * 4
    seq_ops_ms, seq_bytes_ms = seq_ops / int_ops_per_ms, seq_bytes / HBM_BYTES_PER_S * 1e3
    seq_meas, seq_meas_by = measured_bound(seq_ops, seq_bytes)
    batch_b = seq_bound(seq_turns["batch"]["form"], 0, streams.shape[0], streams.shape[1],
                        batch_smi["clock_mhz"])
    log(f"cbc_encrypt_words_batch, {SEQ_BLOCKS} streams x 64 blocks (one seq_encrypt launch, "
        f"form {batch_b['form']}): {batch_ms:.4f} ms back to back, {1e3 * batch_ms / 64:.4f} us per "
        f"step of {SEQ_BLOCKS} blocks; plain {batch_plain_ms:.2f} ms; roofline bound "
        f"{max(seq_ops_ms, seq_bytes_ms):.6f} ms at the table rates, {seq_meas:.6f} ms "
        f"({seq_meas_by}) at the measured ones; latency bound {batch_b['bound_ms']:.4f} ms "
        f"({batch_b['bound_by']}), kernel at {100 * batch_b['bound_ms'] / batch_ms:.1f} %; the "
        f"former bound 64 x {seq_depth[0]} x {lat_cycles:.3f} cycles = "
        f"{batch_b['former_bound_ms']:.4f} ms; card: {card}")
    del batch_got, batch_want
    kernels.append({
        "name": "seq_encrypt", "route": "cuda", "source": "our_tree_tpu_torch/csrc/seq.cu",
        "replaces": "our_tree_tpu/ops/pallas_aes.py:259", "launches": block_counts["seq_encrypt"],
        "launches_by_form": block_seq_forms,
        "max_abs_err": batch_err, "ms": batch_ms, "plain_ms": batch_plain_ms,
        "bound_ms": max(seq_ops_ms, seq_bytes_ms),
        "bound_by": "operations" if seq_ops_ms >= seq_bytes_ms else "bytes",
        "bound_ms_at_sampled_clock": max(seq_ops_ms * clock_mhz / batch_smi["clock_mhz"],
                                         seq_bytes_ms),
        "sampled_clock_mhz": batch_smi["clock_mhz"], "bound_ms_measured": seq_meas,
        "bound_by_measured": seq_meas_by,
        "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"],
        "latency_bound_ms": batch_b["bound_ms"], "latency_bound": batch_b,
        "former_latency_bound_ms": batch_b["former_bound_ms"],
        "dependent_issue_cycles": lat_cycles, "shuffle_latency_cycles": shfl_cycles_seq,
        "dependent_instructions_per_block": seq_depth[0], "library_ms": None,
        "shape": f"{SEQ_BLOCKS} CBC streams x 64 blocks (cbc_encrypt_words_batch); the "
                 f"single-stream encrypts of {SEQ_BLOCKS} blocks under 'single_stream'; the "
                 f"parent kernel in turns under 'turns', the forms under 'forms_table'",
        "sass_round_loop": {"cbc": seq_loop[0], "cfb128": seq_loop[1]},
        "sass_int_per_block": {"cbc": seq_int[0], "cfb128": seq_int[1]},
        "sass_by_pipe": {f"{form},{'cfb128' if c else 'cbc'}": p
                         for (form, c), p in seq_pipes.items()},
        "single_stream": single, "turns": seq_turns, "forms_table": seq_table})

    # ctr_mk's group form at three shapes: (S) the seal's launch, 2^24 + 1
    # blocks, K = 1, an all-zero slot vector; (E) the K = 1 entry, 2^24
    # blocks, no slot vector; (M) 256 MiB, K = 8 in runs of 1-300. The
    # kernel alone: equal to the plain version, its card time (the median of
    # 5 CUDA graphs), back to back at the sampled clock, against its bound.
    # Its redesign's comparisons with the parent's kernel and its own steps
    # one at a time (PR 14) are findings in PERF.md and are not rerun.
    def ctr_mk_study(w_m, c_m, s_m, rk1s):
        n_s = (1 << 24) + 1
        w_s, c_s = random_words(n_s, seed=61), random_words(n_s, seed=62)
        shapes = {"S": (w_s, c_s, rk1s, torch.zeros(n_s, dtype=torch.int32, device=dev)),
                  "E": (w_m, c_m, rk1s, None), "M": (w_m, c_m, rks8, s_m)}
        labels = {"S": "the seal's launch, 2^24 + 1 blocks, K = 1, all-zero slots",
                  "E": "the K = 1 entry, 2^24 blocks, no slot vector",
                  "M": "256 MiB, K = 8, runs of 1-300"}
        bad, out = 0, {}
        for key, (w_k, c_k, rks_k, sl) in shapes.items():
            if sl is None:
                def kernel(w_k=w_k, c_k=c_k, rks_k=rks_k):
                    return cuda_aes.ctr_crypt_words_explicit(w_k, c_k, rks_k[0], 10, form="group")
                want = cuda_aes.ctr_crypt_words_explicit_plain(w_k, c_k, rks_k[0], 10)
            else:
                def kernel(w_k=w_k, c_k=c_k, rks_k=rks_k, sl=sl):
                    return cuda_aes.ctr_scattered_multikey(w_k, c_k, rks_k, sl, 10, form="group")
                want = cuda_aes.ctr_scattered_multikey_plain(w_k, c_k, rks_k, sl, 10)
            m, err = diff(kernel(), want)
            bad += m
            if m:
                log(f"MISMATCH ctr_mk group form at ({key}) {labels[key]}: {m} words")
            del want
            card_ms = statistics.median(graph_ms(kernel, 5) for _ in range(5))
            ms, clocks = sampled_ms(kernel)
            n, k = w_k.shape[0], rks_k.shape[0]
            nbytes = 48 * n + (4 * n if sl is not None else 0) + 4 * k * 44
            bound, bound_by = measured_bound(-(-n // 32) * mk_ops, nbytes)
            out[key] = {"shape": labels[key], "n_blocks": n, "k": k, "ms": ms,
                        "sampled_clock_mhz": clocks["clock_mhz"], "card_ms_graph": card_ms,
                        "bound_ms_measured": bound, "bound_by_measured": bound_by,
                        "share_of_bound": bound / card_ms, "mismatching_words": m,
                        "max_abs_err": err}
            log(f"ctr_mk group form at ({key}) {labels[key]}: {card_ms:.4f} ms card (median of 5 "
                f"CUDA graphs), {ms:.4f} ms back to back ({n * 16 / ms / 1e6:.2f} GB/s), bound "
                f"{bound:.4f} ms ({bound_by}, measured rates): {100 * bound / card_ms:.1f} %; "
                f"card: {card}")
        if bad:
            raise SystemExit("a ctr_mk group-form launch disagrees with its plain version")
        del shapes, w_s, c_s
        return {"shapes": out, "sass": {"kernel": mk}}

    # ctr_mk: the serve path's shape (the 4,096-block rung, K = 8, drive B's
    # pattern of 1-64-block requests on random slots) in each form, then 256
    # MiB with K = 8 in runs of 1-300 blocks in each form and with its K = 1
    # entry; then both forms at every size from 32 blocks to 2^24, one slot
    # and a random slot per block (the auto form's threshold table; the ladder's
    # rungs also with the plain version's time and drives A and B's batches).
    mk = sass_mk_per_thread(sass_text, nr)
    mk_loops = sass_round_loops(sass_text, "ctr_mk_kernel", nr)[:4]
    mk_group_depth = (nr - 1) * min(lp["depth"] for lp in mk_loops)
    blk = sass_block_kernel(sass_text, "ctr_mk_block_kernel", nr, nr)
    blk_int, blk_depth, blk_loop = blk["int"], blk["depth"], blk["round_loop"]
    log(f"ctr_mk SASS (nr {nr}): group form {mk}, round-loop dependency depths "
        f"{[lp['depth'] for lp in mk_loops]}; block form round loop {blk_loop['int']} integer "
        f"instructions, depth {blk_loop['depth']}, about {blk_int} a block; ptxas "
        f"{ptxas.get(f'ctr_mk_kernel<{nr}>')} / {ptxas.get(f'ctr_mk_block_kernel<{nr}>')}")
    fwd = {e["name"]: e["sass_instructions_per_group"] for e in kernels
           if e["name"] in ("ctr_gen", "ecb_encrypt")}
    fwd.update(ctr_mk_block=blk_int, seq_encrypt=seq_int[0])
    log("forward kernels' integer SASS at nr 10 (this build; before the decrypt redesign): "
        + ", ".join(f"{k} {fwd[k]} ({v}, {'same' if fwd[k] == v else 'differs'})"
                    for k, v in FORWARD_SASS.items())
        + "; per group for ctr_gen and ecb_encrypt, per block for ctr_mk_block and seq_encrypt")
    mk_ops, mk_parts = mk_ops_per_group(nr)
    nr8, rks8 = mk_stack(128, 8, seed=8)
    rung = 4096
    w_r, c_r = random_words(rung, seed=41), random_words(rung, seed=42)
    s_r = slot_runs(rung, 8, np.array([1, 4, 16, 64]), seed=43)
    mixed_groups = int((s_r.reshape(-1, 32) != s_r.reshape(-1, 32)[:, :1]).any(dim=1).sum())
    log(f"ctr_mk serve-shape slots: {mixed_groups} of {rung // 32} groups mixed")
    sass_r = (mk["mixed_group"] * mixed_groups + mk["uniform_group"] * (rung // 32 - mixed_groups)
              ) // (rung // 32)
    mk_bytes = lambda n, k, slots: 48 * n + 4 * n * slots + 4 * k * 4 * (nr8 + 1)  # noqa: E731

    def mk_fn(w, c, sl, form):
        return lambda: cuda_aes.ctr_scattered_multikey(w, c, rks8, sl, nr8, form=form)

    def with_latency(e, depth, fn):
        """Add the card time per launch in a CUDA graph and the latency bound
        (one thread's dependent path) to an entry; the share of the larger
        bound is read against the graph's card time."""
        e["card_ms_graph"] = graph_ms(fn)
        e["latency_bound_ms"] = latency_ms(depth, e["sampled_clock_mhz"])
        e["dependent_instructions"] = depth
        e["share_of_larger_bound"] = (max(e["bound_ms_measured"], e["latency_bound_ms"])
                                      / e["card_ms_graph"])
        return e

    want_r = cuda_aes.ctr_scattered_multikey_plain(w_r, c_r, rks8, s_r, nr8)
    entry = with_latency(timing(
        "ctr_mk", mk_fn(w_r, c_r, s_r, "group"),
        lambda: cuda_aes.ctr_scattered_multikey_plain(w_r, c_r, rks8, s_r, nr8),
        mk_fn(w_r, c_r, s_r, "group")(), want_r, mk_ops, mk_parts, mk_bytes(rung, 8, 1), rung,
        sass_r, plain_reps=5, sass_upper_bound=True), mk_group_depth, mk_fn(w_r, c_r, s_r, "group"))
    block_r = with_latency(timing(
        "ctr_mk_block", mk_fn(w_r, c_r, s_r, "block"),
        lambda: cuda_aes.ctr_scattered_multikey_plain(w_r, c_r, rks8, s_r, nr8),
        mk_fn(w_r, c_r, s_r, "block")(), want_r, mk_ops, mk_parts, mk_bytes(rung, 8, 1), rung,
        32 * blk_int, plain_reps=5, sass_upper_bound=True), blk_depth, mk_fn(w_r, c_r, s_r, "block"))
    for form, e in (("group", entry), ("block", block_r)):
        e["host_issue_ms"] = host_issue_ms(mk_fn(w_r, c_r, s_r, form))
        log(f"ctr_mk {form} form at the {rung}-block rung: host issue "
            f"{e['host_issue_ms'] * 1e3:.2f} us per launch, {e['ms'] * 1e3:.2f} us per launch back "
            f"to back, {e['card_ms_graph'] * 1e3:.2f} us of card per launch in a CUDA graph; "
            f"latency bound {e['dependent_instructions']} x {lat_cycles:.3f} cycles = "
            f"{e['latency_bound_ms'] * 1e3:.4f} us, roofline bound "
            f"{e['bound_ms_measured'] * 1e3:.4f} us; kernel at "
            f"{100 * e['share_of_larger_bound']:.1f} % of the larger (graph time); card: {card}")
    n_big = MAIN_BYTES // 16
    w_b, c_b = random_words(n_big, seed=51), random_words(n_big, seed=52)
    s_b = slot_runs(n_big, 8, np.arange(1, 301), seed=53)
    mixed_b = int((s_b.reshape(-1, 32) != s_b.reshape(-1, 32)[:, :1]).any(dim=1).sum())
    sass_b = (mk["mixed_group"] * mixed_b + mk["uniform_group"] * (n_big // 32 - mixed_b)
              ) // (n_big // 32)
    want_b = cuda_aes.ctr_scattered_multikey_plain(w_b, c_b, rks8, s_b, nr8)
    bulk = timing("ctr_mk K=8 runs 1-300", mk_fn(w_b, c_b, s_b, "group"),
                  lambda: cuda_aes.ctr_scattered_multikey_plain(w_b, c_b, rks8, s_b, nr8),
                  mk_fn(w_b, c_b, s_b, "group")(), want_b, mk_ops, mk_parts,
                  mk_bytes(n_big, 8, 1), n_big, sass_b, sass_upper_bound=True)
    block_bulk = timing("ctr_mk_block K=8 runs 1-300", mk_fn(w_b, c_b, s_b, "block"),
                        lambda: cuda_aes.ctr_scattered_multikey_plain(w_b, c_b, rks8, s_b, nr8),
                        mk_fn(w_b, c_b, s_b, "block")(), want_b, mk_ops, mk_parts,
                        mk_bytes(n_big, 8, 1), n_big, 32 * blk_int, sass_upper_bound=True)
    log(f"ctr_mk at 256 MiB, K = 8 in runs of 1-300 ({mixed_b} of {n_big // 32} groups mixed): "
        f"group form {bulk['ms']:.4f} ms, block form {block_bulk['ms']:.4f} ms: the block form "
        f"{'beats' if block_bulk['ms'] < bulk['ms'] else 'does not beat'} the mixed group form; "
        f"card: {card}")
    del want_b
    rk1 = rks8[0].contiguous()
    k1 = timing("ctr_mk K=1 entry",
                lambda: cuda_aes.ctr_crypt_words_explicit(w_b, c_b, rk1, nr8),
                lambda: cuda_aes.ctr_crypt_words_explicit_plain(w_b, c_b, rk1, nr8),
                cuda_aes.ctr_crypt_words_explicit(w_b, c_b, rk1, nr8),
                cuda_aes.ctr_crypt_words_explicit_plain(w_b, c_b, rk1, nr8),
                mk_ops, mk_parts, mk_bytes(n_big, 1, 0), n_big, mk["uniform_group"],
                sass_upper_bound=True)
    lib = cuda_build.load()
    table = []
    ladder = line_a["config"]["rungs"]
    for n in sorted({*ladder, 32, 128, 512, 1024, 2048, 4096, 1 << 16, 1 << 17, 1 << 18, 1 << 19,
                     1 << 20, 1 << 24}):
        w_n, c_n = w_b[:n], c_b[:n]
        for pattern in ("uniform", "mixed"):
            sl = (torch.full((n,), 3, dtype=torch.int32, device=dev) if pattern == "uniform" else
                  torch.randint(0, 8, (n,), dtype=torch.int32, device=dev,
                                generator=torch.Generator(dev).manual_seed(n)))
            row = {"n_blocks": n, "slots": pattern,
                   "auto_form": cuda_aes.MK_FORMS[lib.ot_ctr_mk_form(n, 0)]}
            if n in ladder:  # drives A and B: traffic batches at this rung (warmup adds one each)
                row["drive_batches"] = sum(ln["occupancy"].get(str(n), {}).get("batches", 0)
                                           for ln in (line_a, line_b))
                row["plain_ms"] = events_ms(lambda: cuda_aes.ctr_scattered_multikey_plain(
                    w_n, c_n, rks8, sl, nr8), 2)
            for form in ("group", "block"):
                fn = mk_fn(w_n, c_n, sl, form)
                reps = max(3, int(0.2 / (events_ms(fn, 1) / 1e3)))
                row[f"{form}_ms"] = events_ms(fn, reps)
                if n <= 1 << 19:  # launches of tens of µs: back to back, the host paces them
                    row[f"{form}_card_ms_graph"] = graph_ms(fn)
            row["roofline_bound_ms"] = measured_bound(-(-n // 32) * mk_ops, mk_bytes(n, 8, 1))[0]
            row["latency_bound_ms"] = {"group": latency_ms(mk_group_depth, lat_smi["clock_mhz"]),
                                       "block": latency_ms(blk_depth, lat_smi["clock_mhz"])}
            key = "card_ms_graph" if n <= 1 << 19 else "ms"
            row["faster"] = "block" if row[f"block_{key}"] < row[f"group_{key}"] else "group"
            table.append(row)
            log(f"ctr_mk forms at {n} blocks, K = 8, {pattern} slots: group {row['group_ms']:.4f} "
                f"ms, block {row['block_ms']:.4f} ms back to back; in a CUDA graph group "
                f"{row.get('group_card_ms_graph', float('nan')):.4f} ms, block "
                f"{row.get('block_card_ms_graph', float('nan')):.4f} ms (faster: {row['faster']}; auto: "
                f"{row['auto_form']}); roofline bound {row['roofline_bound_ms']:.6f} ms"
                + (f"; plain {row['plain_ms']:.2f} ms, {row['drive_batches']} traffic batches in "
                   f"drives A and B" if "plain_ms" in row else "") + f"; card: {card}")
    study = ctr_mk_study(w_b, c_b, s_b, rks8[:1].contiguous())
    del w_b, c_b, s_b
    forms_ab = {f: forms_a[f] + forms_b[f] for f in forms_a}
    kernels.append({
        "name": "ctr_mk", "route": "cuda", "source": "our_tree_tpu_torch/csrc/ctr_mk.cu",
        "replaces": "our_tree_tpu/ops/pallas_aes.py:767",
        "launches": counts_a["ctr_mk"] + counts_b["ctr_mk"], **entry, "library_ms": None,
        "shape": f"{rung} blocks, K = 8, drive B's request pattern ({mixed_groups} of "
                 f"{rung // 32} groups mixed), the group form (ctr_mk_kernel)",
        "launches_by_form": forms_ab,
        "sass_by_key_form": mk,
        "seal_shape": {"ms": study["shapes"]["S"]["card_ms_graph"],
                       "ms_back_to_back": study["shapes"]["S"]["ms"],
                       "bound_ms": study["shapes"]["S"]["bound_ms_measured"],
                       "bound_by": study["shapes"]["S"]["bound_by_measured"],
                       "share": study["shapes"]["S"]["share_of_bound"],
                       "shape": study["shapes"]["S"]["shape"]},
        "group_form_study": study,
        "at_256MiB_k8_runs": {**bulk, "library_ms": None},
        "k1_entry": {"entry": "ops/cuda_aes.py:ctr_crypt_words_explicit",
                     "counterpart_of": "_ctr_kernel",
                     "replaces": "our_tree_tpu/ops/pallas_aes.py:476",
                     "shape": "256 MiB", **k1, "library_ms": None},
        "block_form": {"name": "ctr_mk_block_kernel", "route": "cuda",
                       "source": "our_tree_tpu_torch/csrc/ctr_mk.cu",
                       "replaces": "our_tree_tpu/ops/pallas_aes.py:767",
                       "launches": forms_ab["block"], **block_r, "library_ms": None,
                       "shape": f"{rung} blocks, K = 8, drive B's request pattern",
                       "sass_round_loop": blk_loop, "sass_int_per_block": blk_int,
                       "at_256MiB_k8_runs": {**block_bulk, "library_ms": None},
                       "forms_table": table},
    })

    # cbc_mk: the serve path's shape (the 4,096-block rung, K = 8, drive B's
    # pattern of 1-64-block runs on random slots; the rung's ciphertext and
    # PREV words random), then 256 MiB with K = 8 in runs of 1-300. The
    # latency bound is the inverse round circuit's own dependent steps (the
    # inverse S-box circuit's depth, read from its generated program, plus
    # the linear layers' steps, INV_ROUND_LINEAR_STEPS); the compiled round
    # loop's longest path is printed beside it, a diagnostic.
    with open(os.path.join(ROOT, "our_tree_tpu_torch", "csrc", "aes_inv_bitslice.cuh"),
              encoding="utf-8") as fh:
        sbox_depth = inv_sbox_depth(fh.read())
    round_steps = sbox_depth + sum(INV_ROUND_LINEAR_STEPS.values())
    last_steps = sbox_depth + sum(INV_LAST_ROUND_LINEAR_STEPS.values())
    cbc_depth = 1 + (nr8 - 1) * round_steps + last_steps
    cbc_sass = sass_block_kernel(sass_text, "cbc_mk_block_kernel", nr8, nr8)
    cbc_int, cbc_sass_depth = cbc_sass["int"], cbc_sass["depth"]
    cbc_ops, cbc_parts = cbc_mk_ops_per_group(nr8)
    cbc_ins, _ = sass_function(sass_text, "cbc_mk_block_kernel", nr8)
    lo, hi = cbc_sass["round_loop"]["range"] if cbc_sass["rolled"] else (0, cbc_ins[-1][0])
    imads = [t for a, b, t in cbc_ins if b == "IMAD" and lo <= a <= hi]
    log(f"cbc_mk SASS (nr {nr8}): rounds {'rolled' if cbc_sass['rolled'] else 'unrolled'}"
        + (f", round loop {cbc_sass['round_loop']['int']} integer instructions, dependency "
           f"depth {cbc_sass['round_loop']['depth']}" if cbc_sass["rolled"] else "")
        + f", opcodes {cbc_sass['hist']}; about {cbc_int} integer instructions a block; ptxas "
        f"{ptxas.get(f'cbc_mk_block_kernel<{nr8}>')}; the circuit's dependent steps: inverse "
        f"S-box depth {sbox_depth} + linear layers {INV_ROUND_LINEAR_STEPS} = {round_steps} a "
        f"round, last round {last_steps}, whitening 1: {cbc_depth} at nr {nr8} (the compiled "
        f"path: {cbc_sass_depth})")
    log(f"cbc_mk IMAD in the {'round loop' if cbc_sass['rolled'] else 'kernel'} ({len(imads)}): "
        + " | ".join(imads[:40]))
    rksd8 = packing.words_tensor(np.stack([dec_schedule_from_enc(nr8, r)
                                           for r in packing.words_numpy(rks8)]), dev)

    def cbc_fn(w, p, sl):
        return lambda: cuda_aes.cbc_scattered_multikey(w, p, rksd8, sl, nr8)

    def cbc_plain(w, p, sl):
        return lambda: cuda_aes.cbc_scattered_multikey_plain(w, p, rksd8, sl, nr8)

    cbc_r = with_latency(timing(
        "cbc_mk_block", cbc_fn(w_r, c_r, s_r), cbc_plain(w_r, c_r, s_r), cbc_fn(w_r, c_r, s_r)(),
        cbc_plain(w_r, c_r, s_r)(), cbc_ops, cbc_parts, mk_bytes(rung, 8, 1), rung,
        32 * cbc_int, plain_reps=5, sass_upper_bound=True), cbc_depth, cbc_fn(w_r, c_r, s_r))
    cbc_r["host_issue_ms"] = host_issue_ms(cbc_fn(w_r, c_r, s_r))
    cbc_r["sass_path_latency_ms"] = latency_ms(cbc_sass_depth, cbc_r["sampled_clock_mhz"])
    log(f"cbc_mk at the {rung}-block rung, K = 8: host issue {cbc_r['host_issue_ms'] * 1e3:.2f} "
        f"us per launch, {cbc_r['ms'] * 1e3:.2f} us per launch back to back, "
        f"{cbc_r['card_ms_graph'] * 1e3:.3f} us of card per launch in a CUDA graph; plain "
        f"{cbc_r['plain_ms']:.2f} ms; roofline bound {cbc_r['bound_ms_measured'] * 1e3:.4f} us "
        f"({cbc_r['bound_by_measured']}, measured rates); latency bound {cbc_depth} dependent "
        f"steps x {lat_cycles:.3f} cycles at {cbc_r['sampled_clock_mhz']:.0f} MHz = "
        f"{cbc_r['latency_bound_ms'] * 1e3:.4f} us (the compiled path: "
        f"{cbc_r['sass_path_latency_ms'] * 1e3:.4f} us); kernel at "
        f"{100 * cbc_r['share_of_larger_bound']:.1f} % of the larger (graph time); {cbc_int} "
        f"integer SASS a block; card: {card}")
    # Where a launch's time goes, at the 4,096- and 32-block rungs: the
    # launch floor (the empty kernel at the launch's grid, 128 threads a
    # thread block and its dynamic shared memory, in a CUDA graph), the
    # stamped instantiation's phases per warp (SM cycles at the sampled
    # clock: the key-plane prologue to its barrier, the block's loads, the
    # rounds, the store until visible), their sum beside the card time, and
    # the issue diagnostic: the integer SASS a block at one instruction a
    # cycle, a count of the compiled code (not a bound), beside the latency
    # bound.
    empty = ctypes.CDLL(empty_so)
    empty.ot_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.ot_empty.restype = ctypes.c_int
    cbc_smem = 8 * 8 * (nr8 + 1) * 4

    def empty_fn(grid):
        def fn():
            if empty.ot_empty(grid, 128, cbc_smem, torch.cuda.current_stream().cuda_stream):
                raise SystemExit("the empty kernel did not launch")
        return fn

    mhz = cbc_r["sampled_clock_mhz"]
    issue_ms = cbc_int / (mhz * 1e3)
    # The integer pipe's rate for one warp: 16 lanes a clock a sub-partition
    # (the table's 64 a clock an SM over its 4), so a LOP3 or SHF every 2
    # cycles; IMAD issues on the FMA pipe beside it. With one warp a
    # sub-partition, the rounds cannot run faster than that.
    pipe_ms = 2 * (cbc_int - cbc_sass["fma"]) / (mhz * 1e3)
    a1 = {}
    for n_r in (rung, 32):
        grid = -(-n_r // 128)
        floor_ms = statistics.median(graph_ms(empty_fn(grid)) for _ in range(5))
        prod = cbc_fn(w_r[:n_r], c_r[:n_r], s_r[:n_r])
        card_ms = cbc_r["card_ms_graph"] if n_r == rung else graph_ms(prod)
        stamps = torch.zeros((-(-n_r // 32), 8), dtype=torch.int64, device=dev)
        out_s = torch.empty_like(w_r[:n_r])
        runs = []
        for i in range(40):
            stamps.zero_()
            rc = lib.ot_cbc_mk_stamped(w_r.data_ptr(), out_s.data_ptr(), c_r.data_ptr(),
                                       s_r.data_ptr(), rksd8.data_ptr(), ctypes.c_longlong(n_r),
                                       8, nr8, stamps.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"ot_cbc_mk_stamped launch failed: cudaError {rc}")
            torch.cuda.synchronize()
            if i >= 10:  # warm launches only
                a = stamps.cpu().numpy()
                runs.append(a[a[:, 0] != 0])
        m, _ = diff(out_s, prod())
        if m:
            raise SystemExit(f"the stamped cbc_mk disagrees with the kernel: {m} mismatching words")
        a = np.concatenate(runs)
        cyc = {"prologue": a[:, 1] - a[:, 0], "loads": a[:, 2] - a[:, 1],
               "rounds": a[:, 3] - a[:, 2], "store": a[:, 4] - a[:, 3],
               "entry_to_store_visible": a[:, 4] - a[:, 0]}
        phases = {k: {"median_us": float(np.median(v)) / mhz, "max_us": float(v.max()) / mhz,
                      "median_cycles": float(np.median(v)), "max_cycles": int(v.max())}
                  for k, v in cyc.items()}
        skew = [int(r[:, 5].max() - r[:, 5].min()) for r in runs]
        span = [int(r[:, 6].max() - r[:, 5].min()) for r in runs]
        parts = ("prologue", "loads", "rounds", "store")
        total = floor_ms * 1e3 + sum(phases[k]["median_us"] for k in parts)
        a1[n_r] = {"floor_ms": floor_ms, "grid": grid, "smem_bytes": cbc_smem, "card_ms_graph": card_ms,
                   "phases": phases, "warps": int(a.shape[0] // len(runs)), "launches": len(runs),
                   "start_skew_ns_median": float(np.median(skew)),
                   "span_ns_median": float(np.median(span)),
                   "sum_floor_and_median_phases_us": total,
                   "issue_diagnostic_ms": issue_ms, "integer_pipe_ms": pipe_ms,
                   "above_floor_plus_diagnostic_us": (card_ms - floor_ms - issue_ms) * 1e3,
                   "above_floor_plus_integer_pipe_us": (card_ms - floor_ms - pipe_ms) * 1e3}
        log(f"cbc_mk launch floor at the {n_r}-block rung: the empty kernel, {grid} thread blocks "
            f"x 128 threads, {cbc_smem} B dynamic shared memory, {floor_ms * 1e3:.3f} us per launch "
            f"in a CUDA graph (median of 5); card: {card}")
        log(f"cbc_mk stamped breakdown at the {n_r}-block rung (K = 8, {a1[n_r]['warps']} warps x "
            f"{len(runs)} launches, SM cycles at {mhz:.0f} MHz), median / largest across warps: "
            + "; ".join(f"{k} {v['median_us']:.3f} / {v['max_us']:.3f} us" for k, v in phases.items())
            + f"; warps' start skew {a1[n_r]['start_skew_ns_median']:.0f} ns and first start to "
            f"last end {a1[n_r]['span_ns_median']:.0f} ns (global timer, median over launches); "
            f"card: {card}")
        log(f"cbc_mk at the {n_r}-block rung: floor {floor_ms * 1e3:.3f} + prologue "
            f"{phases['prologue']['median_us']:.3f} + loads {phases['loads']['median_us']:.3f} + "
            f"rounds {phases['rounds']['median_us']:.3f} + store {phases['store']['median_us']:.3f} "
            f"= {total:.3f} us beside {card_ms * 1e3:.3f} us of card in a CUDA graph (the former "
            f"form: {CBC_MK_FORMER_US} us at the 4,096-block rung); issue diagnostic (a count of the "
            f"compiled code, not a bound): {cbc_int} integer SASS a block x 1 cycle at {mhz:.0f} "
            f"MHz = {issue_ms * 1e3:.4f} us, beside the latency bound "
            f"{cbc_r['latency_bound_ms'] * 1e3:.4f} us ({cbc_depth} circuit steps); card time above "
            f"floor plus diagnostic {a1[n_r]['above_floor_plus_diagnostic_us']:.3f} us; at the "
            f"integer pipe's rate for one warp ({cbc_int - cbc_sass['fma']} integer-pipe "
            f"instructions x 2 cycles, {cbc_sass['fma']} IMAD on the FMA pipe beside them) "
            f"{pipe_ms * 1e3:.4f} us, card time above floor plus that "
            f"{a1[n_r]['above_floor_plus_integer_pipe_us']:.3f} us; card: {card}")
    w_c, p_c = random_words(n_big, seed=61), random_words(n_big, seed=62)
    s_c = slot_runs(n_big, 8, np.arange(1, 301), seed=63)
    cbc_bulk = timing("cbc_mk_block K=8 runs 1-300", cbc_fn(w_c, p_c, s_c),
                      cbc_plain(w_c, p_c, s_c), cbc_fn(w_c, p_c, s_c)(),
                      cbc_plain(w_c, p_c, s_c)(), cbc_ops, cbc_parts,
                      mk_bytes(n_big, 8, 1), n_big, 32 * cbc_int, sass_upper_bound=True)
    cbc_bulk["latency_bound_ms"] = latency_ms(cbc_depth, cbc_bulk["sampled_clock_mhz"])
    cbc_bulk["share_of_larger_bound"] = (max(cbc_bulk["bound_ms_measured"],
                                             cbc_bulk["latency_bound_ms"]) / cbc_bulk["ms"])
    log(f"cbc_mk at 256 MiB, K = 8 in runs of 1-300: {cbc_bulk['ms']:.4f} ms, plain "
        f"{cbc_bulk['plain_ms']:.2f} ms; roofline bound {cbc_bulk['bound_ms_measured']:.4f} ms "
        f"({cbc_bulk['bound_by_measured']}, measured rates), latency bound "
        f"{cbc_bulk['latency_bound_ms'] * 1e3:.4f} us; kernel at "
        f"{100 * cbc_bulk['share_of_larger_bound']:.1f} % of the larger; card: {card}")
    # Where a group form would pay: the block form beside ecb_decrypt_kernel,
    # the same inverse circuit 32 blocks a thread (one key and no PREV XOR, so
    # a lower estimate of what a group form of cbc_mk would take).
    group_table = []
    for n in (4096, 1 << 16, 1 << 20, n_big):
        w_n, p_n, s_n = w_c[:n], p_c[:n], s_c[:n]
        row = {"n_blocks": n}
        for label, fn in (("cbc_mk_block", cbc_fn(w_n, p_n, s_n)),
                          ("ecb_decrypt_group", lambda w_n=w_n: cuda_aes.decrypt_words(
                              w_n, rk_dec, nr))):
            reps = max(3, int(0.2 / (events_ms(fn, 1) / 1e3)))
            row[f"{label}_ms"] = events_ms(fn, reps)
            if n <= 1 << 16:
                row[f"{label}_card_ms_graph"] = graph_ms(fn)
        key = "card_ms_graph" if n <= 1 << 16 else "ms"
        row["faster"] = ("block" if row[f"cbc_mk_block_{key}"] < row[f"ecb_decrypt_group_{key}"]
                         else "group")
        group_table.append(row)
        log(f"cbc_mk block form vs the group layout (ecb_decrypt_kernel) at {n} blocks: "
            f"{row['cbc_mk_block_ms']:.4f} vs {row['ecb_decrypt_group_ms']:.4f} ms back to back"
            + (f", {row['cbc_mk_block_card_ms_graph'] * 1e3:.3f} vs "
               f"{row['ecb_decrypt_group_card_ms_graph'] * 1e3:.3f} us in a CUDA graph"
               if n <= 1 << 16 else "") + f" (faster: {row['faster']}); card: {card}")
    del w_c, p_c, s_c
    kernels.append({
        "name": "cbc_mk", "route": "cuda", "source": "our_tree_tpu_torch/csrc/cbc_mk.cu",
        "replaces": "our_tree_tpu/models/aes.py:595",
        "counterpart_of": "the bitsliced jnp circuit _multikey_cbc_bitslice "
                          "(our_tree_tpu/models/aes.py:595-606), not a Pallas kernel",
        "launches": counts_d["cbc_mk"], **cbc_r, "library_ms": None,
        "shape": f"{rung} blocks, K = 8, drive B's request pattern, cbc_mk_block_kernel",
        "dependent_steps": {"inv_sbox_depth": sbox_depth, "round": round_steps,
                            "last_round": last_steps, "total": cbc_depth,
                            "linear_layers": INV_ROUND_LINEAR_STEPS},
        "dependent_issue_cycles": lat_cycles, "sass_round_loop": cbc_sass["round_loop"],
        "rolled_rounds": cbc_sass["rolled"], "sass_hist": cbc_sass["hist"],
        "sass_int_per_block": cbc_int, "sass_path_dependent_instructions": cbc_sass_depth,
        "rung32_card_ms_graph": a1[32]["card_ms_graph"], "breakdown": a1,
        "issue_diagnostic_ms": issue_ms, "integer_pipe_ms": pipe_ms,
        "sass_fma_per_block": cbc_sass["fma"],
        "at_256MiB_k8_runs": {**cbc_bulk, "library_ms": None},
        "group_layout_table": group_table})

    # chain: each regime at the probe's 64 MiB, timed alone in phase 7.
    chain_entries = {}
    for name, r in regimes.items():
        c, i = r["chain"], r["ilp"]
        m, max_err = diff(ceiling.chain(x, c, i), ceiling.chain_plain(x, c, i))
        if m:
            raise SystemExit(f"chain {name} vs plain at {PROBE_BYTES >> 20} MiB: {m} words")
        # Operations: the reference's logical count with a LOP3 credited with
        # two, as for the AES kernels; bytes: one word read, one written.
        ops = chain_words * ceiling.ops_per_word(c, i) / 2
        ops_ms, bytes_ms = ops / int_ops_per_ms, 8 * chain_words / HBM_BYTES_PER_S * 1e3
        meas_ms, meas_by = measured_bound(ops, 8 * chain_words)
        sampled_mhz = r["smi"]["clock_mhz"]
        chain_entries[name] = {
            "chain": c, "ilp": i, "mismatches": m, "max_abs_err": max_err, "ms": r["ms"],
            "plain_ms": events_ms(lambda c=c, i=i: ceiling.chain_plain(x, c, i), 2),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_at_sampled_clock": max(ops_ms * clock_mhz / sampled_mhz, bytes_ms),
            "sampled_clock_mhz": sampled_mhz, "bound_ms_measured": meas_ms,
            "bound_by_measured": meas_by,
            "sass_per_element": {k: r[k] for k in ("lop3", "int", "instructions")},
            "int_results_per_clk_per_sm": r["int_per_clk_per_sm"],
            "int_results_per_clk_per_sm_at_max_clock": r["int_per_clk_per_sm_at_max"],
            "t_ops_per_s": r["t_ops_per_s"], "smi": r["smi"]}
        e = chain_entries[name]
        log(f"chain {name} at {PROBE_BYTES >> 20} MiB: {r['ms']:.4f} ms/launch, plain "
            f"{e['plain_ms']:.2f} ms; bound {e['bound_ms']:.4f} ms ({e['bound_by']}; kernel at "
            f"{100 * e['bound_ms'] / r['ms']:.1f} %), at the sampled clock "
            f"{e['bound_ms_at_sampled_clock']:.4f} ms, at the measured rates {meas_ms:.4f} ms "
            f"({meas_by}); ptxas {ptxas.get(f'chain_kernel<{c},{i}>')}; card: {card}")
    head = chain_entries["compute-ilp8"]
    kernels.append({
        "name": "chain", "route": "cuda", "source": "our_tree_tpu_torch/csrc/chain.cu",
        "replaces": "scripts/vpu_ceiling.py:47", "launches": probe_counts["chain"],
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "bound_ms_at_sampled_clock", "sampled_clock_mhz",
                                "bound_ms_measured", "bound_by_measured")},
        "library_ms": None,
        "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"],
        "shape": f"{PROBE_BYTES >> 20} MiB, the compute-ilp8 regime; every regime under "
                 "'regimes'",
        "measured": measured, "probe_line": cli_line, "regimes": chain_entries})

    # arc4_prga at its timing shapes: time per launch, bounds and share.
    arc4_loops = sass_round_loops(sass_text, "arc4_prga_kernel", 32)
    arc4_ins, _ = sass_function(sass_text, "arc4_prga_kernel", 32)
    for lp in arc4_loops:
        lo, hi = lp["range"]
        lp["lds"] = sum(b == "LDS" for a, b, _t in arc4_ins if lo <= a <= hi)
        lp["sts"] = sum(b == "STS" for a, b, _t in arc4_ins if lo <= a <= hi)
        lp["keystream_words"] = not any(b == "LDG" for a, b, _t in arc4_ins if lo <= a <= hi) and any(
            b == "STG" and ".U8" not in t for a, b, t in arc4_ins if lo <= a <= hi)
    # The main loop: the PRGA loop (three loads to two stores in shared
    # memory; the state's copy loops hold other mixes) with the most bytes a
    # trip that stores keystream words and reads no data (the unfused path).
    prga_loops = [lp for lp in arc4_loops if lp["sts"] and 2 * lp["lds"] == 3 * lp["sts"]]
    if not prga_loops:
        raise SystemExit(f"arc4_prga_kernel has no loop of three LDS to two STS: {arc4_loops}")
    group = max(prga_loops, key=lambda lp: (lp["lds"], lp["keystream_words"], -lp["int"]))
    bytes_per_trip = group["lds"] // 3
    # The diagnostics beside the bound: the step's recurrence as written
    # (ARC4_WRITTEN_STEP) and the longest path through the compiled loop.
    written_cycles = ARC4_WRITTEN_STEP["lds"] * lds_cycles + ARC4_WRITTEN_STEP["int"] * lat_cycles
    sass_path = sass_weighted_path(arc4_ins, *group["range"], lds_cycles, lat_cycles)
    sass_cycles = sass_path / bytes_per_trip
    log(f"arc4_prga SASS: main loop {bytes_per_trip} bytes a trip, {group['int']} integer "
        f"instructions, {group['lds']} LDS, {group['sts']} STS, opcodes {group['hist']}; its "
        f"longest dependent path {sass_path:.1f} cycles a trip = {sass_cycles:.2f} cycles a byte "
        f"(diagnostic); the step's recurrence as written {ARC4_WRITTEN_STEP['lds']} x "
        f"{lds_cycles:.2f} (a dependent LDS) + {ARC4_WRITTEN_STEP['int']} x {lat_cycles:.3f} (a "
        f"dependent integer step) = {written_cycles:.2f} cycles a byte (diagnostic); ptxas "
        f"{ptxas.get('arc4_prga_kernel<32>')}")
    log("arc4_prga main loop SASS: " + " | ".join(
        t for a, _b, t in arc4_ins if group["range"][0] <= a <= group["range"][1]))
    arc4_shapes = {}
    for label, (s_n, n) in ARC4_TIMED.items():
        st = arc4_inputs[n]["states"][:s_n]
        ms, clocks = sampled_ms(lambda st=st, n=n: cuda_arc4.prga(st, n))
        nbytes = s_n * n + 2 * s_n * 258 * 4  # keystream written, state read and written
        ops = ARC4_OPS_PER_BYTE * s_n * n
        ops_ms, bytes_ms = ops / int_ops_per_ms, nbytes / HBM_BYTES_PER_S * 1e3
        meas_ms, meas_by = measured_bound(ops, nbytes)
        mhz = clocks["clock_mhz"]
        bc = arc4_bound_cycles(s_n)
        lat_b = n * bc["bound_cycles_per_byte"] / (mhz * 1e3)
        arc4_shapes[label] = {
            "streams": s_n, "bytes_per_stream": n, "ms": ms,
            "plain_ms": arc4_inputs[n]["plain_ms"], "plain_streams": ARC4_PLAIN_STREAMS,
            "plain_bytes_per_stream": arc4_inputs[n].get("plain_bytes", n),
            "max_abs_err": arc4_inputs[n]["max_abs_err"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_measured": meas_ms, "bound_by_measured": meas_by,
            "latency_bound_ms": lat_b, "latency_bound": bc,
            "larger_bound_ms": max(meas_ms, lat_b),
            "share_of_larger_bound": max(meas_ms, lat_b) / ms,
            "cycles_per_byte": ms * mhz * 1e3 / n,
            "written_step_latency_ms": n * written_cycles / (mhz * 1e3),
            "sass_path_latency_ms": n * sass_cycles / (mhz * 1e3),
            "sampled_clock_mhz": mhz, "library_ms": None}
        e = arc4_shapes[label]
        log(f"arc4_prga {label} at {s_n} x {n} bytes: {ms:.4f} ms/launch ({s_n * n / ms / 1e6:.3f} "
            f"GB/s of keystream, {e['cycles_per_byte']:.2f} cycles a byte); plain "
            f"{e['plain_ms']:.1f} ms (on {ARC4_PLAIN_STREAMS} streams of "
            f"{e['plain_bytes_per_stream']} bytes, the first {s_n} of them these); bound "
            f"{e['bound_ms']:.5f} ms ({e['bound_by']}, table rates), {meas_ms:.5f} ms at the "
            f"measured rates ({meas_by}); latency bound {n} x max(word-per-byte issue "
            f"{ARC4_ACCESSES_PER_BYTE} "
            f"x {bc['warps_per_sm']} warp(s) / {bc['smem_accesses_per_cycle']:.4f} = "
            f"{bc['issue_cycles_per_byte']:.2f}, dependent step {ARC4_DEPENDENT_STEPS} x "
            f"{lat_cycles:.3f} = {bc['dependent_cycles_per_byte']:.2f}) cycles at {mhz:.0f} MHz = "
            f"{lat_b:.4f} ms ({bc['bound_by']}); kernel at "
            f"{100 * e['share_of_larger_bound']:.1f} % of the larger of the measured-rate and "
            f"latency bounds; diagnostics: the step as written {e['written_step_latency_ms']:.4f} "
            f"ms, the compiled loop's path {e['sass_path_latency_ms']:.4f} ms; nvidia-smi "
            f"{clocks}; card: {card}")
        if e["share_of_larger_bound"] > 1:
            raise SystemExit(f"arc4_prga {label} runs under its bound: the bound is wrong")
    head = arc4_shapes["path"]
    arc4_entry = {
        "name": "arc4_prga", "route": "cuda", "source": "our_tree_tpu_torch/csrc/arc4.cu",
        "replaces": "our_tree_tpu/models/arc4.py:59",
        "counterpart_of": "the XLA scans keystream_scan/keystream_scan_batch "
                          "(our_tree_tpu/models/arc4.py:59-94), not a Pallas kernel",
        "launches": None,
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "plain_streams", "bound_ms",
                                "bound_by", "bound_ms_measured", "bound_by_measured",
                                "latency_bound_ms", "latency_bound", "larger_bound_ms",
                                "share_of_larger_bound", "cycles_per_byte",
                                "written_step_latency_ms", "sass_path_latency_ms",
                                "sampled_clock_mhz", "library_ms")},
        "shape": "{0} streams x {1} bytes (rc4-batch's launch); 'single' and 'wide' below".format(
            *ARC4_TIMED["path"]),
        "single": arc4_shapes["single"], "wide": arc4_shapes["wide"],
        "lds_latency_cycles": lds_cycles, "dependent_issue_cycles": lat_cycles,
        "smem_accesses_per_cycle_by_warps": smem_rate,
        "written_step_cycles_per_byte": written_cycles, "sass_path_cycles_per_byte": sass_cycles,
        "sass_main_loop": {k: group[k] for k in ("int", "lds", "sts", "depth", "hist")}}
    kernels.append(arc4_entry)

    phase("10")
    # 10. The sweep harness (harness.bench) in processes of its own, as a user
    # runs it: the device rows with the native keystream prep, the sequential
    # and batch rows, the same rows on the native C tier, the keystream on the
    # card, and the refusal of a second worker.
    harness_env = {**os.environ, "OT_ARC4_PREP": "native"}

    def harness(name, argv, env=None, expect_rc=0):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.bench", *argv],
                             cwd=ROOT, capture_output=True, text=True, timeout=900,
                             env=env or harness_env)
        wall = time.perf_counter() - t0
        if (res.returncode == 0) != (expect_rc == 0):
            raise SystemExit(f"harness {name}: rc {res.returncode}, out {res.stdout[-2000:]!r}, "
                             f"err {res.stderr[-3000:]!r}")
        launches = {}
        for ln in res.stderr.splitlines():
            m = re.match(r"# launches: (\S+) (\{.*\})$", ln)
            if m:
                launches[m.group(1)] = json.loads(m.group(2))
        for text in res.stdout.strip().splitlines():
            log(f"harness {name}: {text}")
        return res, launches, wall

    common = ["--workers", "1", "--iters", "5", "--keybits", "128", "--timing", "device"]
    runs = {
        "device rows": (["--sizes-mb", "1,16,256", "--modes", "ecb,ecb-dec,ctr,cbc-dec,rc4"],
                        None),
        "sequential rows": (["--sizes-mb", "0.0625", "--modes", "cbc,cfb128"], None),
        "batch rows": (["--sizes-mb", "32", "--modes", "cbc-batch,rc4-batch", "--streams",
                        "32"], None),
        "e2e rows": (["--sizes-mb", "16,256", "--modes", "ecb,ctr,rc4", "--timing", "e2e"], None),
        "c backend rows": (["--backend", "c", "--sizes-mb", "1,16,256", "--modes", "ecb,ctr,rc4"],
                           None),
        "rc4 keystream on the card": (["--sizes-mb", "1", "--modes", "rc4"],
                                      {**os.environ, "OT_ARC4_PREP": "device"}),
    }
    harness_checks, harness_launches, harness_table = {}, {}, []
    for name, (argv, env) in runs.items():
        res, launches, wall = harness(name, common + argv, env)
        out = res.stdout
        verdicts = [ln for ln in out.splitlines()
                    if re.search(r"passed|FAILED|MISMATCH", ln)]
        harness_checks[f"{name}: every check line passed"] = all(
            "passed" in ln for ln in verdicts)
        harness_checks[f"{name}: no degraded line"] = "# degraded:" not in out + res.stderr
        if "rc4" in argv[argv.index("--modes") + 1].split(","):
            harness_checks[f"{name}: ARC4 self-test"] = all(
                f"ARC4 test #{i}: passed" in out for i in (1, 2, 3))
        if "rc4-batch" in argv[argv.index("--modes") + 1]:
            harness_checks[f"{name}: batch parity"] = "RC4-batch parity vs single-stream: passed" in out
        units = {u: c for u, c in launches.items()}
        harness_launches[name] = units
        if "--backend" not in argv:
            for unit, cnt in units.items():
                mode = unit.split(":")[0]
                want = "arc4_prga" if (mode == "rc4" and env is not None) else HARNESS_KERNEL.get(mode)
                if want is not None:
                    harness_checks[f"{name}: {unit} launched {want}"] = cnt.get(want, 0) > 0
        for row in harness_rows(out):
            row["run"] = name
            harness_table.append(row)
            gb = row["gbps"]
            keygen = (f", keygen {row['bytes'] / row['keygen_us'] / 1e3:.4g} GB/s"
                      if row.get("keygen_us") else "")
            log(f"harness row [{name}] {row['row']}: {gb if gb is not None else 'n/a'} GB/s"
                f"{keygen} beside the CTR chain's {ctr_gbps} GB/s; "
                + (f"CPU: {cpu_model()}" if "--backend" in argv else f"card: {card}"))
        log(f"harness {name}: {wall:.1f} s wall; launches by unit {units}")
    # Two gloo ranks sharing the card: every row on both ranks, a row of two
    # workers sharded over them, rank 0 printing.
    t0 = time.perf_counter()
    res, _ = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "our_tree_tpu_torch.harness.bench",
                        "--dist-backend", "gloo", "--workers", "1,2", "--sizes-mb", "1,16",
                        "--modes", MULTI_SWEEP_MODES, "--iters", "3"], 600, harness_env)
    wall = time.perf_counter() - t0
    for text in res.stdout.strip().splitlines():
        log(f"harness two ranks: {text}")
    rank_launches = {}
    # The ranks share one stderr, so their lines can interleave: scan, not match lines.
    for m in re.finditer(r"# launches(?: rank (\d+))?: (\S+) (\{[^{}]*\})", res.stderr):
        rank_launches.setdefault(int(m.group(1) or 0), {})[m.group(2)] = json.loads(m.group(3))
    invariance = ("Shard invariance [1, 2]: passed", "CBC-batch shard invariance [1, 2]: passed",
                  "RC4-batch shard invariance [1, 2]: passed")
    harness_checks["two ranks: rc 0"] = res.returncode == 0
    harness_checks["two ranks: shard-invariance lines passed"] = all(
        ln in res.stdout.splitlines() for ln in invariance) and not re.search(
        r"FAILED|MISMATCH", res.stdout)
    harness_checks["two ranks: every unit launched its kernel on both ranks"] = (
        sorted(rank_launches) == [0, 1] and all(
            cnt.get(HARNESS_KERNEL[unit.split(":")[0]], 0) > 0
            for units in rank_launches.values() for unit, cnt in units.items()
            if unit.split(":")[0] in HARNESS_KERNEL))
    harness_launches["two ranks"] = rank_launches
    log(f"harness two ranks: {wall:.1f} s wall; launches by rank and unit {rank_launches}; "
        f"rc {res.returncode}" + (f"; stderr {res.stderr[-2000:]!r}" if res.returncode else ""))
    res, _, _ = harness("two workers without a world", common + ["--workers", "2", "--sizes-mb",
                                                                 "1", "--modes", "ecb"],
                        expect_rc=1)
    harness_checks["--workers 2 without a world refused, naming the launch"] = (
        "torch.distributed.run --nproc-per-node 2" in res.stderr and "Multi-device" in res.stderr)
    log(f"harness checks: {harness_checks}")
    if not all(harness_checks.values()):
        raise SystemExit(f"the sweep harness failed: {harness_checks}")
    arc4_entry["launches"] = (
        sum(c.get("arc4_prga", 0) for c in harness_launches["batch rows"].values())
        + sum(c.get("arc4_prga", 0) for c in harness_launches["rc4 keystream on the card"].values()))
    arc4_entry["harness"] = {"rows": harness_table, "launches_by_unit": harness_launches,
                             "ctr_chain_gbps": ctr_gbps, "native_tier_cpu": cpu_model()}

    phase("11")
    # 11. AES-GCM through the models API (aead/gcm.py): the GHASH scan kernel
    # against its plain version (random layouts, and the serve rungs through
    # the seam in both directions), the SP 800-38D KATs, the 256 MiB seal and
    # open (and 256 MiB + 5 bytes) counted, their ciphertext against the CTR
    # seam and their tag and rows against an independent formulation, and
    # the kernel's and the seal's times.
    from our_tree_tpu_torch.aead import gcm as agcm
    from our_tree_tpu_torch.aead import ghash as aghash
    from our_tree_tpu_torch.ops import gf

    def ghash_inputs(n, k, seed, rung_layout=False):
        """(x, hkeys, slots, keep, y0, inject) on the card: random, with keep's
        bit 1 set on some rows (it must not count); or with ``rung_layout``
        the serve batcher's GCM layout (requests of 0-40 blocks, each a J0
        row and its payload, keep 0 at both, inject at the first payload
        row, y0 zero)."""
        rng = np.random.default_rng(seed)
        u = lambda *shape: rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)  # noqa: E731
        x, hk = u(n, 4), u(k, 4)
        if rung_layout:
            inj, keep, slots, y0 = np.zeros((n, 4), np.uint32), np.ones(n, np.int32), \
                np.zeros(n, np.int32), np.zeros(4, np.uint32)
            off = 0
            while off < n:
                m = min(int(rng.integers(0, 41)) + 1, n - off)
                keep[off:off + 2] = 0
                slots[off:off + m] = rng.integers(0, k)
                if m > 1:
                    inj[off + 1] = u(4)
                off += m
        else:
            inj, slots, y0 = u(n, 4), rng.integers(0, k, n).astype(np.int32), u(4)
            keep = rng.integers(0, 4, n).astype(np.int32)
            keep[rng.random(n) < 0.8] = 1
        t = lambda a: packing.words_tensor(a, dev)  # noqa: E731
        return (t(x), t(hk), torch.from_numpy(slots).to(dev), torch.from_numpy(keep).to(dev),
                t(y0), t(inj))

    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

    class GhashCall:
        """One GHASH call's inputs on the card, with the wrappers as
        functions of no arguments (so each can be captured in a CUDA graph).
        The parent's kernel and the design variants of the GHASH redesign
        (PR 13) are findings in PERF.md and are not rerun."""

        def __init__(self, x, hk, sl, kp, y0, inj, rows):
            self.args = (x, hk, sl, kp, y0)
            self.inj, self.rows = inj, [int(r) for r in rows]
            n, k = x.shape[0], hk.shape[0]
            self.n, self.k = n, k
            self.rows_t = torch.tensor(self.rows, dtype=torch.int64, device=dev)
            self.out = torch.empty_like(x)
            self.out_at = torch.empty((len(self.rows), 4), dtype=torch.int32, device=dev)

        def scan(self):
            return cuda_ghash.ghash_scan(*self.args, inject=self.inj)

        def at(self):
            return cuda_ghash.ghash_at(*self.args, self.rows_t, inject=self.inj)

    def named_rows(n, seed):
        """Sorted random named rows of N rows: the first, the last, up to 40
        more and one of them twice."""
        rng = np.random.default_rng(seed)
        rows = sorted({0, n - 1, *rng.integers(0, n, min(n, 40)).tolist()})
        return sorted(rows + rows[len(rows) // 2:len(rows) // 2 + 1])

    gh_bad, gh_cases, gh_err, gh_plain_ms = 0, 0, 0, {}
    at_bad, at_cases = 0, 0
    for n in GHASH_SIZES:
        for k in ((8,) if n > 4096 else (1, 8, 64)):
            x, hk, sl, kp, y0, inj = ghash_inputs(n, k, seed=100 * n + k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_ghash.ghash_scan_plain(x, hk, sl, kp, y0, inject=inj)
            torch.cuda.synchronize()
            gh_plain_ms[(n, k)] = (time.perf_counter() - t0) * 1e3
            got_scan = cuda_ghash.ghash_scan(x, hk, sl, kp, y0, inject=inj)
            for got in (got_scan, cuda_ghash.ghash_scan(x ^ inj, hk, sl, kp, y0)):
                m, e = diff(got, want)
                gh_bad, gh_err, gh_cases = gh_bad + m, max(gh_err, e), gh_cases + 1
                if m:
                    log(f"MISMATCH ghash_scan n={n} k={k}: {m} words")
            call = GhashCall(x, hk, sl, kp, y0, inj, named_rows(n, seed=n + k))
            got_at = call.at()
            # ghash_at against ghash_at_plain (ghash_scan_plain's rows: the
            # plain loop above, not run again), and against ghash_scan.
            m = diff(got_at, want[call.rows_t])[0] + diff(got_at, got_scan[call.rows_t])[0]
            at_bad, at_cases = at_bad + m, at_cases + 1
            if m:
                log(f"MISMATCH ghash_at n={n} k={k}: {m} words")
    # ghash_at_plain itself, at the smaller sizes.
    x, hk, sl, kp, y0, inj = ghash_inputs(4096, 8, seed=4097)
    rows = named_rows(4096, seed=5)
    m = diff(cuda_ghash.ghash_at(x, hk, sl, kp, y0, rows, inject=inj),
             cuda_ghash.ghash_at_plain(x, hk, sl, kp, y0, rows, inject=inj))[0]
    at_bad, at_cases = at_bad + m, at_cases + 1
    log(f"ghash_scan vs plain: {gh_cases} cases (N in {GHASH_SIZES}, K 1/8/64, 8 at 65,537; "
        f"random slots, keep, y0, inject, and x ^ inject without it): {gh_bad} mismatching "
        f"words; ghash_at at random named rows (up to 42, one twice) against the plain rows and "
        f"ghash_scan's: {at_cases} cases, {at_bad} mismatching words; the plain row loop {gh_plain_ms[(65537, 8)]:.0f} ms at 65,537 rows; "
        f"card: {card}")
    # The serve rungs through the seam, K = 8 in the batcher's layout, both
    # directions, nr 10/12/14: the CUDA engine (ctr_mk, ghash_scan) against
    # the plain engine on the same card.
    seam_bad, seam_cases = 0, 0
    for bits in (128, 192, 256):
        rng = np.random.default_rng(bits)
        keys = [rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes() for _ in range(8)]
        mats = [agcm._key_material(key_) for key_ in keys]
        rks_g = packing.words_tensor(np.stack([m_[1] for m_ in mats]), dev)
        hm_g = np.stack([m_[3] for m_ in mats])
        for rung in serve_rungs:
            x, _hk, sl, kp, _y0, inj = ghash_inputs(rung, 8, seed=rung + bits, rung_layout=True)
            ctr_g = random_words(rung, seed=rung + bits)
            # Each request's last row, as the gcm serve modes will name them.
            starts = torch.nonzero(kp == 0).flatten().tolist()
            last_rows = sorted({r - 1 for r in starts if r > 0} | {rung - 1})
            for direction in (agcm.SEAL, agcm.OPEN):
                args = (x, ctr_g, rks_g, sl, hm_g, inj, kp, mats[0][0])
                got = agcm.gcm_crypt_ghash_words(*args, aes.CUDA_ENGINE, direction)
                want = agcm.gcm_crypt_ghash_words(*args, aes.PLAIN_ENGINE, direction)
                got_r = agcm.gcm_crypt_ghash_words(*args, aes.CUDA_ENGINE, direction,
                                                   rows=last_rows)
                m = (diff(got[0], want[0])[0] + diff(got[1], want[1])[0]
                     + diff(got_r[0], want[0])[0]
                     + diff(got_r[1], want[1][torch.tensor(last_rows, device=dev)])[0])
                seam_bad, seam_cases = seam_bad + m, seam_cases + 1
                if m:
                    log(f"MISMATCH gcm seam bits={bits} rung={rung} {direction}: {m} words")
    log(f"gcm_crypt_ghash_words (CUDA engine vs plain engine on the card) at the serve rungs "
        f"{serve_rungs}, K = 8 in the batcher's layout, seal and open, AES-128/192/256, every "
        f"row and with rows = each request's last row (ghash_at): {seam_cases} cases, "
        f"{seam_bad} mismatching words of out and ys")
    if gh_bad or seam_bad or at_bad:
        raise SystemExit("a GHASH kernel disagrees with its plain version")
    with open(os.path.join(ROOT, "tests", "golden", "gcm_kats.json"), encoding="utf-8") as fh:
        gcm_kats = json.load(fh)["kats"]
    for kat in gcm_kats:
        key_, iv_, aad_, pt_ = (bytes.fromhex(kat[f]) for f in ("key", "iv", "aad", "pt"))
        ct_, tag_ = agcm.gcm_seal(key_, iv_, aad_, pt_)
        if (ct_.hex(), tag_.hex()) != (kat["ct"], kat["tag"]) or \
                agcm.gcm_open(key_, iv_, aad_, ct_, tag_) != pt_:
            raise SystemExit(f"NIST SP 800-38D {kat['name']} failed on the card")
        opened = "raised"
        try:
            opened = agcm.gcm_open(key_, iv_, aad_, ct_, tag_[:-1] + bytes([tag_[-1] ^ 1]))
        except agcm.TagMismatchError:
            pass
        if opened != "raised":
            raise SystemExit(f"a tampered tag of {kat['name']} was not refused")
    odd_iv = bytes(range(7))
    odd = agcm.gcm_seal(GCM_KEY, odd_iv, GCM_AAD, bytes(range(200)) * 5)
    if odd != aghash.np_gcm_seal(GCM_KEY, odd_iv, GCM_AAD, bytes(range(200)) * 5):
        raise SystemExit("gcm_seal with a 56-bit IV differs from the host GCM")
    log(f"NIST SP 800-38D: {len(gcm_kats)} KATs through gcm_seal/gcm_open on the card: pass, "
        f"each tampered tag refused (TagMismatchError, no plaintext); a 7-byte IV over 1,000 "
        f"bytes equal to the host GCM")

    def ghash_by_powers(h, blocks, span_c=64, span_s=512):
        """GHASH over (L, 4) int32 block words on the card by matrix powers,
        independent of the kernel: M = gf128_mul_matrix_words(h) (host ints),
        chunks of C blocks contribute [M^C ... M^1] times their bits, runs of
        S chunks [G^(S-1) ... G^0] times the chunks' (G = M^C), and the runs
        chain sequentially, Y <- G^S Y + run; float32 products of 0/1 values
        (sums below 2^24, exact), mod 2. Zero blocks are put first, which
        leaves Y at zero, so the sequence is whole runs. Returns (the leading
        zero blocks, Y after each run as an int)."""
        span = span_c * span_s
        m = torch.from_numpy(gf.gf128_mul_matrix_words(h).astype(np.float32)).to(dev)
        mod2 = lambda a, b: torch.remainder(a @ b, 2)  # noqa: E731
        pw = [m]
        for _ in range(span_c - 1):
            pw.append(mod2(pw[-1], m))
        w1 = torch.cat(pw[::-1], dim=1).t().contiguous()
        gp = [torch.eye(128, device=dev)]
        for _ in range(span_s - 1):
            gp.append(mod2(gp[-1], pw[-1]))
        w2 = torch.cat(gp[::-1], dim=1).t().contiguous()
        g_s = mod2(gp[-1], pw[-1])
        pad = -blocks.shape[0] % span
        seq = torch.cat([torch.zeros((pad, 4), dtype=torch.int32, device=dev), blocks])
        y, ys_runs = torch.zeros(128, device=dev), []
        for r in range(seq.shape[0] // span):
            bits = cuda_ghash.bits_of(seq[r * span:(r + 1) * span]).to(torch.float32)
            c = torch.remainder(bits.reshape(span_s, span_c * 128) @ w1, 2)
            d = torch.remainder(c.reshape(1, -1) @ w2, 2)[0]
            y = torch.remainder(g_s @ y + d, 2)
            ys_runs.append(y)
        ys_w = packing.words_numpy(cuda_ghash.words_of(torch.stack(ys_runs).to(torch.int64)))
        return pad, [gf.block_to_int(packing.np_words_to_bytes(w).tobytes()) for w in ys_w]

    nr_m, rk_m, h_m, hmat_m = agcm._key_material(GCM_KEY)
    j0_m = aghash.j0_from_iv(h_m, GCM_IV)
    ek_j0 = aghash.np_aes_encrypt_block(nr_m, rk_m, j0_m)
    y_aad = aghash.ghash_int(h_m, aghash.pad16(GCM_AAD))
    gcm_host = np.random.default_rng(1337).integers(0, 256, MAIN_BYTES + 5, dtype=np.uint8)
    gcm_runs, gcm_tags = {}, {}
    for extra in (0, 5):
        pt_ = gcm_host[:MAIN_BYTES + extra].tobytes()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ct_, tag_ = agcm.gcm_seal(GCM_KEY, GCM_IV, GCM_AAD, pt_)
        seal_s = time.perf_counter() - t0
        seal_counts = counts()
        reset_counts()
        t0 = time.perf_counter()
        back = agcm.gcm_open(GCM_KEY, GCM_IV, GCM_AAD, ct_, tag_)
        open_s = time.perf_counter() - t0
        open_counts = counts()
        nfull = len(pt_) // 16
        ctr_w = packing.words_tensor(aghash.np_gcm_ctr_blocks(
            j0_m, np.arange(1, nfull + 1, dtype=np.uint32)), dev)
        ks = aes.ctr_crypt_words_scattered(
            packing.words_tensor(packing.np_bytes_to_words(gcm_host[:16 * nfull]), dev).reshape(
                -1, 4), ctr_w, packing.words_tensor(rk_m, dev), nr_m, aes.CUDA_ENGINE)
        same_ctr = packing.np_words_to_bytes(packing.words_numpy(ks).reshape(-1)).tobytes() == \
            ct_[:16 * nfull]
        del ks, ctr_w
        seq_words = packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(
            aghash.pad16(GCM_AAD) + aghash.pad16(ct_) + aghash.length_block(len(GCM_AAD), len(ct_)),
            np.uint8)), dev).reshape(-1, 4)
        _pad, run_ys = ghash_by_powers(h_m, seq_words)
        del seq_words
        indep_tag = bytes(np.frombuffer(gf.int_to_block(run_ys[-1]), np.uint8) ^ ek_j0)
        checks = {
            "open returns the plaintext": back == pt_,
            "ciphertext = the CTR seam under inc32": same_ctr,
            "tag = the matrix-power formulation's": indep_tag == tag_,
            "seal: one ctr_mk and one ghash_at call, nothing else": seal_counts == {
                **{n_: 0 for n_ in seal_counts}, "ctr_mk": 1, "ghash_at": 1},
            "open: one ctr_mk and one ghash_at call, nothing else": open_counts == seal_counts,
        }
        log(f"gcm_seal/gcm_open at {len(pt_)} bytes on the card: seal {seal_s:.3f} s, open "
            f"{open_s:.3f} s wall (host staging included); launches seal {seal_counts}, open "
            f"{open_counts}; checks {checks}; card: {card}")
        if not all(checks.values()):
            raise SystemExit(f"gcm at {len(pt_)} bytes failed: {checks}")
        gcm_runs[extra] = {"seal_s": seal_s, "open_s": open_s, "seal_launches": seal_counts,
                           "open_launches": open_counts}
        gcm_tags[extra] = tag_.hex()
        del ct_, back, pt_
    # The seal's dispatch on the card: the seam on the 256 MiB seal's arrays
    # (staged), its rows held at every run's end against the formulation
    # above, its time; then ghash_scan alone on the same rows.
    words_m, ctr_m, inj_m, keep_m, nfull_m = agcm._gcm_arrays(
        j0_m, gcm_host[:MAIN_BYTES].tobytes(), y_aad)
    n_m = nfull_m + 1
    seam_args = (packing.words_tensor(words_m, dev).reshape(n_m, 4),
                 packing.words_tensor(ctr_m, dev).reshape(n_m, 4),
                 packing.words_tensor(rk_m[None], dev),
                 torch.zeros(n_m, dtype=torch.int32, device=dev),
                 torch.from_numpy(hmat_m[None].astype(np.int32)).to(dev),
                 packing.words_tensor(inj_m, dev).reshape(n_m, 4),
                 packing.words_tensor(keep_m, dev), nr_m, aes.CUDA_ENGINE, agcm.SEAL)
    del words_m, ctr_m, inj_m
    seam_fn = lambda: agcm.gcm_crypt_ghash_words(*seam_args)  # noqa: E731
    out_m, ys_m = seam_fn()
    blocks_m = torch.cat([packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(
        aghash.pad16(GCM_AAD), np.uint8)), dev).reshape(-1, 4), out_m[1:]])
    pad_m, run_ys = ghash_by_powers(h_m, blocks_m)
    del blocks_m
    a_blocks = len(aghash.pad16(GCM_AAD)) // 16
    rows_checked, rows_bad, rows_err = 0, 0, 0
    for r, y_int in enumerate(run_ys):
        j = (r + 1) * 64 * 512 - pad_m - a_blocks  # the seam's row after that run
        if 1 <= j <= nfull_m:
            m, e = diff(ys_m[j], packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(
                gf.int_to_block(y_int), np.uint8)), dev))
            rows_checked, rows_bad, rows_err = rows_checked + 1, rows_bad + m, max(rows_err, e)
    last = gf.block_to_int(packing.np_words_to_bytes(packing.words_numpy(ys_m[nfull_m])).tobytes())
    tag_from_rows = agcm._finish_tag(last, h_m, b"", len(GCM_AAD), MAIN_BYTES,
                                     packing.np_words_to_bytes(packing.words_numpy(out_m[0])))
    log(f"the seal's rows (ghash_scan at {n_m} rows) against the matrix-power formulation: "
        f"{rows_checked} rows (one each {64 * 512} blocks), {rows_bad} mismatching words; the "
        f"tag finished from the last row {'equals' if tag_from_rows.hex() == gcm_tags[0] else 'DIFFERS FROM'} "
        f"gcm_seal's")
    if rows_bad or rows_checked < 500 or tag_from_rows.hex() != gcm_tags[0]:
        raise SystemExit("the seal's GHASH rows differ from the independent formulation")
    del out_m, ys_m
    # The seal's dispatch as gcm_seal makes it (the seam with rows = the last
    # full block's: ctr_mk, then ghash_at), and the every-row seam, on the
    # seal's arrays.
    seal_fn = lambda: agcm.gcm_crypt_ghash_words(*seam_args, rows=[nfull_m])  # noqa: E731
    seam_ms = events_ms(seal_fn, 5)
    seam_every_ms = events_ms(seam_fn, 5)
    seal_gbps = MAIN_BYTES / seam_ms / 1e6
    # The seal's ctr_mk launch alone, on the seal's arrays (the seam's first
    # call, as it makes it): its share of the dispatch.
    seal_mk_fn = lambda: cuda_aes.ctr_scattered_multikey(  # noqa: E731
        seam_args[0], seam_args[1], seam_args[2], seam_args[3], nr_m)
    seal_mk_ms = events_ms(seal_mk_fn, 5)
    seal_mk_graph = graph_ms(seal_mk_fn, reps=5)
    mk_entry = next(e for e in kernels if e["name"] == "ctr_mk")
    mk_entry["seal_shape"].update({
        "launches_a_seal": gcm_runs[0]["seal_launches"]["ctr_mk"],
        "launches_an_open": gcm_runs[0]["open_launches"]["ctr_mk"],
        "seal_arrays_ms": seal_mk_ms, "seal_arrays_card_ms_graph": seal_mk_graph,
        "seal_dispatch_ms": seam_ms, "share_of_seal_dispatch": seal_mk_ms / seam_ms})
    log(f"the seal's ctr_mk launch on the seal's arrays: {seal_mk_ms:.4f} ms back to back "
        f"({seal_mk_graph:.4f} in a CUDA graph), {100 * seal_mk_ms / seam_ms:.1f} % of the seal's "
        f"dispatch ({seam_ms:.4f} ms); launches a seal "
        f"{gcm_runs[0]['seal_launches']['ctr_mk']}, an open "
        f"{gcm_runs[0]['open_launches']['ctr_mk']}; card: {card}")
    # The GHASH call alone on the seal's rows: the input words stand for x
    # (the time does not depend on the data), with the seal's inject.
    seal_call = GhashCall(seam_args[0], agcm._h_words(hmat_m[None], dev), seam_args[3],
                          seam_args[6], torch.zeros(4, dtype=torch.int32, device=dev),
                          seam_args[5], [nfull_m])
    m = diff(seal_call.at(), seal_call.scan()[seal_call.rows_t])[0]
    if m:
        raise SystemExit(f"at the seal's shape ghash_at and ghash_scan disagree: {m} words")
    at_ms, at_clocks = sampled_ms(seal_call.at)
    at_graph = graph_ms(seal_call.at, reps=5)
    gh_ms, gh_clocks = sampled_ms(seal_call.scan)
    gh_ms_graph = graph_ms(seal_call.scan, reps=5)
    # The plain version at the seal's shape: the same row's GHASH by
    # ghash_by_powers (chunked matrix powers in float32 matmuls, a PyTorch
    # formulation independent of the kernel), timed on the seal's blocks.
    blocks_p = torch.cat([packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(
        aghash.pad16(GCM_AAD), np.uint8)), dev).reshape(-1, 4),
        agcm.gcm_crypt_ghash_words(*seam_args[:-1], agcm.SEAL, rows=[1])[0][1:]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _pad, run_ys = ghash_by_powers(h_m, blocks_p)
    torch.cuda.synchronize()
    at_plain_ms = (time.perf_counter() - t0) * 1e3
    last_at = gf.block_to_int(packing.np_words_to_bytes(packing.words_numpy(
        seal_fn()[1][0])).tobytes())
    if last_at != run_ys[-1]:
        raise SystemExit("ghash_at's seal row differs from the matrix-power formulation")
    del blocks_p
    # The rung: 4,096 rows, K = 8, the batcher's layout; ghash_at at each
    # request's last row.
    x_r4, hk_r4, sl_r4, kp_r4, y0_r4, inj_r4 = ghash_inputs(4096, 8, seed=4096, rung_layout=True)
    starts = torch.nonzero(kp_r4 == 0).flatten().tolist()
    rung_call = GhashCall(x_r4, hk_r4, sl_r4, kp_r4, y0_r4, inj_r4,
                          sorted({r - 1 for r in starts if r > 0} | {4095}))
    rung_ms, rung_clocks = sampled_ms(rung_call.scan)
    rung_graph = graph_ms(rung_call.scan)
    rung_at_ms, rung_at_clocks = sampled_ms(rung_call.at)
    rung_at_graph = graph_ms(rung_call.at)
    rung_plain_ms = events_ms(lambda: cuda_ghash.ghash_scan_plain(
        x_r4, hk_r4, sl_r4, kp_r4, y0_r4, inject=inj_r4), 1)
    rung_at_plain_ms = events_ms(lambda: cuda_ghash.ghash_at_plain(
        x_r4, hk_r4, sl_r4, kp_r4, y0_r4, rung_call.rows_t, inject=inj_r4), 1)
    want_r4 = cuda_ghash.ghash_scan_plain(x_r4, hk_r4, sl_r4, kp_r4, y0_r4, inject=inj_r4)
    m, e = diff(rung_call.scan(), want_r4)
    m += diff(rung_call.at(), want_r4[rung_call.rows_t])[0]
    if m:
        raise SystemExit("a GHASH kernel disagrees with its plain version at the 4,096 rung")
    # SASS: the product as the rows launch's row loop runs it (one product a
    # row; 144 IMAD.WIDE a product), both pipes.
    gs = sass_ghash(sass_text)
    log(f"ghash SASS, the product: {gs['product']}; a composition {gs['compose']}; ptxas "
        f"{ {k_: v for k_, v in ptxas.items() if k_.startswith('ghash')} }")

    def ghash_bounds(n, k, row_bytes, ms, clocks, path_products):
        """The least time for the work itself, whatever the formulation: the
        bytes (``row_bytes`` a row, the keys and y0) at the table's HBM rate
        and at phase 7's measured stream rate, and the operations (one
        128 x 128 GF(2) product a row as 2 x 16,384 int8 operations) at the
        table's int8 tensor-core rate; the share against the larger. The
        latency bound: the new formulation's dependent path, its products
        in a chain (``path_products``) at the product's SASS dependency
        depth, at the measured cycles a dependent step."""
        nbytes = row_bytes * n + 16 * k + 16
        ops_ms = n * GF_PRODUCT_INT8_OPS / INT8_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bytes_meas_ms = nbytes / stream_bytes_per_s * 1e3
        depth = path_products * gs["product"]["depth"]
        lat = latency_ms(depth, clocks["clock_mhz"])
        meas = max(ops_ms, bytes_meas_ms)
        return {"rows_per_thread": cuda_ghash.plan(n, k)[0],
                "thread_blocks": cuda_ghash.plan(n, k)[1],
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "bound_ms_measured": meas,
                "bound_by_measured": "operations" if ops_ms >= bytes_meas_ms else "bytes",
                "ops_bound_ms": ops_ms, "bytes_bound_ms_measured_rate": bytes_meas_ms,
                "latency_bound_ms": lat, "dependent_products": path_products,
                "dependent_instructions": depth,
                "share_of_larger_bound": max(meas, lat) / ms,
                "sampled_clock_mhz": clocks["clock_mhz"],
                "sass_per_product": gs["product"],
                "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"]}

    def path_products(n, k, named):
        """Products in a chain on the scan's dependent path: a chunk's rows,
        the block scan's compositions (5 shuffle levels, up to 3 warps, 1),
        the carry launch's chain (its blocks a thread, composed then
        applied, the scan, y0), then the rows again (every row) or the named
        row's composition and application."""
        rows, blocks = cuda_ghash.plan(n, k)
        per = -(-blocks // 128)
        scan = rows + 9 + per + 9 + 1 + per
        return scan + (2 if named else 1 + rows)

    main_b = ghash_bounds(n_m, 1, 56, gh_ms, gh_clocks, path_products(n_m, 1, False))
    at_b = ghash_bounds(n_m, 1, 40, at_ms, at_clocks, path_products(n_m, 1, True))
    rung_b = ghash_bounds(4096, 8, 56, rung_graph, rung_clocks, path_products(4096, 8, False))
    rung_at_b = ghash_bounds(4096, 8, 40, rung_at_graph, rung_at_clocks,
                             path_products(4096, 8, True))
    for label, ms, b in (("ghash_at at the seal's shape", at_ms, at_b),
                         ("ghash_scan at the seal's shape", gh_ms, main_b),
                         ("ghash_scan at the 4,096 rung (graph)", rung_graph, rung_b),
                         ("ghash_at at the 4,096 rung (graph)", rung_at_graph, rung_at_b)):
        log(f"{label}: {ms * 1e3:.3f} us, {b['rows_per_thread']} rows a thread in "
            f"{b['thread_blocks']} thread blocks; bounds: operations {b['ops_bound_ms'] * 1e3:.3f} "
            f"us (2 x 16,384 int8 a row at {INT8_OPS_PER_S / 1e12:.0f} TOPS), bytes "
            f"{b['bytes_bound_ms_measured_rate'] * 1e3:.3f} us at the measured stream rate, "
            f"latency {b['latency_bound_ms'] * 1e3:.3f} us ({b['dependent_products']} products "
            f"in a chain, {b['dependent_instructions']} dependent steps); at "
            f"{100 * b['share_of_larger_bound']:.1f} % of the larger; card: {card}")
    log(f"the seal on the card at 256 MiB (the seam with rows: ctr_mk then ghash_at, staged "
        f"arrays): {seam_ms:.4f} ms, {seal_gbps:.2f} GB/s, ghash_at {100 * at_ms / seam_ms:.1f} % "
        f"of it; the every-row seam (ctr_mk then ghash_scan) {seam_every_ms:.4f} ms; ghash_at "
        f"{at_ms:.4f} ms back to back ({at_graph:.4f} in a CUDA graph), ghash_scan {gh_ms:.4f} ms "
        f"({gh_ms_graph:.4f}); plain at this shape (ghash_by_powers) {at_plain_ms:.1f} ms; card: "
        f"{card}")
    # The GCM serve dispatch at each rung of the serve ladder (drive D's),
    # K = 8 in the batcher's layout: eight tenants, one request each with 20
    # bytes of AAD and a 96-bit IV, filling the rung with their J0 rows, laid
    # out by serve.batcher and keycache (mode "gcm") and staged on the card.
    # The seam's result is held against the host GCM (each request's tag
    # finished from its named row) and ghash_at against ghash_at_plain and
    # ghash_scan's rows; then ctr_mk alone, ghash_at alone (on ctr_mk's
    # output, the batch's rows) and ghash_scan on the same inputs, each in a
    # CUDA graph, in alternating turns, beside each call's launch floor (the
    # empty kernel at each of its grid launches' grid and shared memory,
    # summed), and the whole dispatch through the seam back to back.
    from our_tree_tpu_torch.serve import batcher as sbatcher
    from our_tree_tpu_torch.serve import keycache as skeycache
    from our_tree_tpu_torch.serve import queue as squeue

    empty_g = ctypes.CDLL(empty_so)
    empty_g.ot_empty.argtypes = [ci, ci, ci, vp]
    empty_g.ot_empty.restype = ci

    def floor_ms_of(shapes):
        """The launch floor of a call: the empty kernel at each launch's
        (grid, shared memory), 128 threads a block, summed."""
        total = 0.0
        for grid, smem in shapes:
            def fn(grid=grid, smem=smem):
                if empty_g.ot_empty(grid, 128, smem, torch.cuda.current_stream().cuda_stream):
                    raise SystemExit("the empty kernel did not launch")
            total += graph_ms(fn)
        return total

    ladder = sbatcher.bucket_ladder(sbatcher.DEFAULT_MIN_BLOCKS, sbatcher.DEFAULT_MAX_BLOCKS)
    rng_g = np.random.default_rng(1515)
    gkeys = [rng_g.bytes(16) for _ in range(8)]
    kc_g = skeycache.KeyCache()
    gcm_rungs = []
    for rung_g in ladder:
        n_req = rung_g // 8 - 1
        reqs = []
        for i, key_g in enumerate(gkeys):
            iv_g = rng_g.bytes(12)
            reqs.append(squeue.Request(
                id=i, tenant=f"t{i}", key=key_g, nonce=b"", future=None, mode="gcm", iv=iv_g,
                aad=rng_g.bytes(20), j0=iv_g + b"\x00\x00\x00\x01",
                payload=rng_g.integers(0, 256, 16 * n_req, dtype=np.uint8)))
        (bg,) = sbatcher.form_batches(reqs, ladder, skeycache.key_digest, 8)
        sched_g = kc_g.stacked(bg.keys, 8, mode="gcm")
        bg.materialise(sched=sched_g)
        if bg.bucket != rung_g or len(bg.slots) != 8:
            raise SystemExit(f"the GCM table's batch at rung {rung_g} formed as {bg.label}")
        t = lambda a: packing.words_tensor(a, dev)  # noqa: E731
        w_g, c_g, r_g = t(bg.words).reshape(-1, 4), t(bg.ctr_words).reshape(-1, 4), t(sched_g.rks)
        s_g = t(bg.slot_index)
        i_g, k_g = t(bg.inject_words).reshape(-1, 4), t(bg.seg_keep)
        rows_g = torch.from_numpy(bg.rows).to(dev)
        hk_g, y0_g = agcm._h_words(sched_g.hmats, dev), torch.zeros(4, dtype=torch.int32,
                                                                   device=dev)
        out_g, ys_g = agcm.gcm_crypt_ghash_words(w_g, c_g, r_g, s_g, sched_g.hmats, i_g, k_g, 10,
                                                 rows=rows_g)
        out_n, ys_n = packing.words_numpy(out_g).reshape(-1), packing.words_numpy(ys_g)
        bad_tags = 0
        for (off, n_b), si, req, y in zip(bg.req_spans, range(8), bg.requests, ys_n):
            tag = agcm._finish_tag(gf.block_to_int(packing.np_words_to_bytes(y).tobytes()),
                                   sched_g.h_ints[si], b"", len(req.aad), 16 * n_b,
                                   packing.np_words_to_bytes(out_n[4 * (off - 1):4 * off]))
            ct_w, tag_w = aghash.np_gcm_seal(req.key, req.iv, req.aad, req.payload.tobytes())
            bad_tags += (tag != tag_w) + (packing.np_words_to_bytes(
                out_n[4 * off:4 * (off + n_b)]).tobytes() != ct_w)
        mk_fn = lambda: cuda_aes.ctr_scattered_multikey(w_g, c_g, r_g, s_g, 10)  # noqa: E731
        ct_g = mk_fn()
        at_fn = lambda: cuda_ghash.ghash_at(ct_g, hk_g, s_g, k_g, y0_g, rows_g,  # noqa: E731
                                            inject=i_g)
        scan_fn = lambda: cuda_ghash.ghash_scan(ct_g, hk_g, s_g, k_g, y0_g,  # noqa: E731
                                                inject=i_g)
        want_g = cuda_ghash.ghash_at_plain(ct_g, hk_g, s_g, k_g, y0_g, rows_g, inject=i_g)
        m_g = diff(at_fn(), want_g)[0] + diff(scan_fn()[rows_g], want_g)[0] + diff(ys_g, want_g)[0]
        if bad_tags or m_g:
            raise SystemExit(f"the GCM dispatch at rung {rung_g}: {bad_tags} tags or ciphertexts "
                             f"differ from the host GCM's, {m_g} GHASH words from the plain rows")
        turns_g = in_turns({"ghash_at": at_fn, "ctr_mk": mk_fn, "ghash_scan": scan_fn})
        row_g = {"rung": rung_g, "k": 8, "requests": 8, "blocks_a_request": n_req,
                 "named_rows": int(bg.rows.size), "ctr_mk_form": cuda_aes.MK_FORMS[
                     cuda_build.load().ot_ctr_mk_form(rung_g, 0)]}
        # The GHASH calls' floors came from the launch-shape queries of the
        # design-variant build (PR 13), not rerun; ctr_mk's one launch keeps
        # its floor.
        for name, launches, shapes in (("ctr_mk", 1, [(-(-rung_g // 128), 8 * 8 * 11 * 4)]),
                                       ("ghash_at", 2, None), ("ghash_scan", 3, None)):
            row_g[name] = {"card_ms_graph": turns_g[name]["median_ms"],
                           "q1_ms": turns_g[name]["q1_ms"], "q3_ms": turns_g[name]["q3_ms"],
                           "launches_a_call": launches,
                           "floor_ms_graph": floor_ms_of(shapes) if shapes else None}
        row_g["ghash_at_faster_than_ghash_scan_turns"] = turns_g["ghash_scan"][
            "kernel_faster_turns"]
        row_g["dispatch_ms"] = events_ms(lambda: agcm.gcm_crypt_ghash_words(
            w_g, c_g, r_g, s_g, sched_g.hmats, i_g, k_g, 10, rows=rows_g), 20)
        gcm_rungs.append(row_g)
        log(f"GCM serve dispatch at the {rung_g} rung (K = 8, {n_req} blocks a request, "
            f"{row_g['named_rows']} named rows; CUDA graph medians of {VARIANT_TURNS} alternating "
            f"turns, launch floors beside): ctr_mk ({row_g['ctr_mk_form']} form) "
            f"{row_g['ctr_mk']['card_ms_graph'] * 1e3:.3f} us (floor "
            f"{row_g['ctr_mk']['floor_ms_graph'] * 1e3:.3f}), ghash_at "
            f"{row_g['ghash_at']['card_ms_graph'] * 1e3:.3f} us (2 launches), ghash_scan "
            f"{row_g['ghash_scan']['card_ms_graph'] * 1e3:.3f} us (3 launches); ghash_at faster in "
            f"{row_g['ghash_at_faster_than_ghash_scan_turns']} of {VARIANT_TURNS}; the dispatch "
            f"through the seam back to back {row_g['dispatch_ms'] * 1e3:.3f} us; card: {card}")
        del w_g, c_g, ct_g, i_g
    # The every-row seam's path, counted: the seam without rows, as a caller
    # that wants every row makes it.
    reset_counts()
    seam_fn()
    torch.cuda.synchronize()
    every_counts = counts()
    if every_counts != {**{n_: 0 for n_ in every_counts}, "ctr_mk": 1, "ghash_scan": 1}:
        raise SystemExit(f"the every-row seam launched {every_counts}")
    kernels.append({
        "name": "ghash_scan", "route": "cuda", "source": "our_tree_tpu_torch/csrc/ghash.cu",
        "replaces": "our_tree_tpu/aead/gcm.py:118",
        "counterpart_of": "the XLA lax.scan of _gcm_fused_jit (our_tree_tpu/aead/gcm.py:118-143) "
                          "and of ghash_words (:94-104), not a Pallas kernel",
        "launches": every_counts["ghash_scan"],
        "launches_path": "the every-row seam (gcm_crypt_ghash_words without rows) at 256 MiB",
        "max_abs_err": max(gh_err, rows_err, e), "ms": rung_ms, "card_ms_graph": rung_graph,
        "plain_ms": rung_plain_ms, **rung_b, "library_ms": None,
        "shape": "4,096 rows, K = 8, the serve batcher's GCM layout (kernel and plain version on "
                 "the same inputs)",
        "grid_launches_per_call": 3, "sass": gs,
        "plain_ms_65537_rows": gh_plain_ms[(65537, 8)],
        "seal_rows": {"ms": gh_ms, "card_ms_graph": gh_ms_graph, **main_b, "library_ms": None,
                      "shape": f"{n_m} rows, K = 1 (the 256 MiB seal: J0 row, then the "
                               f"ciphertext), held against the matrix-power formulation",
                      "plain_ms": "not measured (a row loop of several launches a row)"},
        "every_row_seam_256MiB_ms": seam_every_ms,
        "tag_formulation": "chunked matrix powers in float32 matmuls (64-block chunks, runs of "
                           "512 chunks), host gf128_mul_matrix_words",
    })
    kernels.append({
        "name": "ghash_at", "route": "cuda", "source": "our_tree_tpu_torch/csrc/ghash.cu",
        "replaces": "our_tree_tpu/aead/gcm.py:118",
        "counterpart_of": "the XLA lax.scan of _gcm_fused_jit (our_tree_tpu/aead/gcm.py:118-143) "
                          "and of ghash_words (:94-104) where one row is read, not a Pallas kernel",
        "launches": gcm_runs[0]["seal_launches"]["ghash_at"], "max_abs_err": 0,
        "ms": at_ms, "card_ms_graph": at_graph, "plain_ms": at_plain_ms,
        "plain": "ghash_by_powers on the seal's blocks (the row's GHASH by chunked matrix "
                 "powers in float32 matmuls; the row loop ghash_at_plain would take minutes)",
        **at_b, "library_ms": None,
        "shape": f"{n_m} rows, K = 1, one named row (the 256 MiB seal's last full block)",
        "grid_launches_per_call": 2,
        "rung": {"ms": rung_at_ms, "card_ms_graph": rung_at_graph, "plain_ms": rung_at_plain_ms,
                 **rung_at_b, "named_rows": len(rung_call.rows),
                 "shape": "4,096 rows, K = 8, the batcher's layout, each request's last row"},
        "seal_256MiB": {"seam_ms": seam_ms, "gbps": seal_gbps, "ghash_at_share": at_ms / seam_ms,
                        "launches": gcm_runs[0]["seal_launches"], "wall": gcm_runs,
                        "tag": gcm_tags[0], "tag_plus5": gcm_tags[5]},
        "gcm_serve": {"rungs": gcm_rungs,
                      "drive_d": {"engine_calls": gcm_calls_d, "ghash_at_calls": counts_d[
                          "ghash_at"], "ctr_mk_launches": counts_d["ctr_mk"],
                          "ctr_mk_launches_by_form": forms_d},
                      "rehearsal": {"errors": line_auth["errors"], "lost": line_auth["lost"],
                                    "ghash_at_calls": counts_auth["ghash_at"]}},
    })
    del seam_args, seal_call

    phase("12")
    # 12. Chunked transfers and the wire worker: in this process, counted,
    # then through worker processes over the wire.
    tx_entries = transfer_phase(card, reset_counts, counts, form_counts)
    for entry in kernels:
        if entry["name"] in ("ctr_mk", "cbc_mk"):
            entry["transfer"] = tx_entries[entry["name"]]
            if entry["name"] == "ctr_mk":
                entry["transfer"]["worker"] = tx_entries["worker"]

    phase("13")
    # 13. The rc4 sessions on the card: the session acceptance drive, the
    # journal round trip and a worker's ss exchanges (session_phase); then
    # arc4_prga at the refill's launch shapes.
    sess_entries = session_phase(card, reset_counts, counts)
    prefetch = {}
    for label, (s_n, n) in PREFETCH_SHAPES.items():
        prng = np.random.default_rng(s_n * n)
        m = np.stack([arc4.key_schedule(prng.bytes(16)) for _ in range(s_n)])
        xy = prng.integers(0, 256, 2 * s_n)
        m_words = torch.from_numpy(m.reshape(-1).astype(np.int32)).to(dev)
        xy_words = torch.from_numpy(xy.astype(np.int32)).to(dev)
        states = torch.cat([xy_words[:s_n, None], xy_words[s_n:, None],
                            m_words.reshape(s_n, 256)], 1).contiguous()
        rows = arc4.prep_batch_words(m_words, xy_words, n)
        t0 = time.perf_counter()
        p_state, p_ks = cuda_arc4.prga_plain(states, n)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bad = int((rows[:, :258] != p_state).sum()) + int(
            (rows[:, 258:].contiguous().view(torch.uint8) != p_ks).sum())
        host = rows.cpu().numpy().view(np.uint32)
        for i in range(s_n):
            ks, (x2, y2, m2) = arc4.keystream_np((int(xy[i]), int(xy[s_n + i]), m[i]), n)
            bad += int(host[i, 258:].astype("<u4").tobytes() != ks.tobytes())
            bad += int((host[i, 0], host[i, 1]) != (x2, y2)) + int((host[i, 2:258] != m2).sum())
        if bad:
            raise SystemExit(f"arc4_prga at the prefetch shape {s_n} x {n}: {bad} mismatches")
        ms = graph_ms(lambda st=states, n=n: cuda_arc4.prga(st, n))
        refill_ms = graph_ms(lambda mw=m_words, xw=xy_words, n=n: arc4.prep_batch_words(mw, xw, n))
        ev_ms, clocks = sampled_ms(lambda st=states, n=n: cuda_arc4.prga(st, n))
        nbytes = s_n * n + 2 * s_n * 258 * 4
        ops = ARC4_OPS_PER_BYTE * s_n * n
        ops_ms, bytes_ms = ops / int_ops_per_ms, nbytes / HBM_BYTES_PER_S * 1e3
        meas_ms, meas_by = measured_bound(ops, nbytes)
        mhz = clocks["clock_mhz"]
        bc = arc4_bound_cycles(s_n)
        lat_b = n * bc["bound_cycles_per_byte"] / (mhz * 1e3)
        prefetch[label] = {
            "streams": s_n, "bytes_per_stream": n, "ms": ms, "refill_ms": refill_ms,
            "events_ms": ev_ms, "plain_ms": plain_ms, "max_abs_err": 0,
            "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes", "bound_ms_measured": meas_ms, "bound_by_measured": meas_by,
            "latency_bound_ms": lat_b, "latency_bound": bc, "latency_bound_ms_at_max_clock":
            n * bc["bound_cycles_per_byte"] / (clock_mhz * 1e3),
            "share_of_latency_bound": lat_b / ms, "cycles_per_byte": ms * mhz * 1e3 / n,
            "written_step_latency_ms": n * written_cycles / (mhz * 1e3),
            "sampled_clock_mhz": mhz, "library_ms": None}
        log(f"arc4_prga at the prefetch shape '{label}' ({s_n} x {n} bytes): {ms:.5f} ms a launch "
            f"in a CUDA graph ({ev_ms:.5f} ms back to back), the refill "
            f"(prep_batch_words: the launch and its row assembly) {refill_ms:.5f} ms; plain "
            f"{plain_ms:.1f} ms; bound {prefetch[label]['bound_ms']:.6f} ms "
            f"({prefetch[label]['bound_by']}), {meas_ms:.6f} ms at the measured rates; latency "
            f"bound {n} x {bc['bound_cycles_per_byte']:.2f} cycles ({bc['bound_by']}) at "
            f"{mhz:.0f} MHz = {lat_b:.5f} ms "
            f"({prefetch[label]['latency_bound_ms_at_max_clock']:.5f} ms at {clock_mhz:.0f} MHz), "
            f"kernel at {100 * lat_b / ms:.1f} % of it ({prefetch[label]['cycles_per_byte']:.2f} "
            f"cycles a byte; the step as written "
            f"{prefetch[label]['written_step_latency_ms']:.5f} ms, a diagnostic); 0 mismatching "
            f"against prga_plain and the host PRGA; nvidia-smi {clocks}; card: {card}")
        if lat_b > ms:
            raise SystemExit(f"arc4_prga at the prefetch shape '{label}' runs under its latency "
                             "bound: the bound is wrong")
    drive = sess_entries["drive"]
    arc4_entry["session"] = {
        "launches": drive["launches"]["arc4_prga"],
        "rc4_prep_engine_calls": drive["engine_calls"]["rc4-prep"],
        "prefetch_dispatches": drive["prefetch_dispatches"],
        "refill_device_us": drive["device_us_per_dispatch"].get("rc4-prep"),
        "xor_device_us": drive["device_us_per_dispatch"].get("rc4"),
        "prefetch_shapes": prefetch, "drive": drive, "worker": sess_entries["worker"]}

    phase("15")
    # 15. Engine selection and the port's entry (it runs before 14, which
    # stays last): entry(), the probe, the lock, the device key schedules,
    # the native serve engine and ot_bench.
    sel = selection_phase(card, reset_counts, counts)
    for entry in kernels:
        if entry["name"] == "ctr_gen":
            entry["selection"] = {"entry_launches": sel["entry_launches"],
                                  "probe_gbps": sel["probe"]["gbps"],
                                  "probe_bytes": sel["probe"]["bytes"]}
        elif entry["name"] in ("ctr_mk", "ghash_at", "cbc_mk"):
            entry["selection"] = {"native_drive_launches": {
                name: d["launches"][entry["name"]] for name, d in sel["native_drives"].items()}}

    phase("16")
    # 16. The rest of observability over the serve drives (before 14, which
    # stays last): drive D traced and rotated with its status endpoint
    # polled, the run read offline, the alert drill, the SLO gate green and
    # red, the history ledger, pulse's cost and the warmup's build line.
    obs = observability_phase(card, serve_drive, line_a, line_d, fresh_a)
    for entry in kernels:
        if entry["name"] == "ctr_mk":
            entry["observability"] = {"drive_d_traced_launches": obs["launches_a"]["ctr_mk"],
                                      "pulse_cost_drive_a_launches": obs["launches_e"]}
        elif entry["name"] == "ghash_at":
            entry["observability"] = {"drive_d_traced_launches": obs["launches_a"]["ghash_at"]}
        elif entry["name"] == "cbc_mk":
            entry["observability"] = {"drive_d_traced_launches": obs["launches_a"]["cbc_mk"]}

    # 17. The routing tier on the card (before 14, which stays last): the
    # route bench's acceptance drive, the backend kill, the AEAD modes and the
    # elasticity drive, each spawning port workers on this card.
    phase("17")
    route = route_phase(card)
    for entry in kernels:
        if entry["name"] in ROUTE_KERNEL_CALLS:
            entry["route"] = {name: d["launches"].get(entry["name"], 0)
                              for name, d in route["drives"].items()}

    # 18. Multi-device (before 14, which stays last): a world of one on NCCL
    # and gloo worlds of 2 and 4 ranks on this card, in child processes.
    phase("18")
    multi = multidevice_phase(card, ctr_gbps)
    for entry in kernels:
        if entry["name"] in MULTI_KERNELS:
            by_world = {w: c[entry["name"]] for w, c in multi["launches_by_world"].items()}
            entry["sharded"] = sum(by_world.values())
            entry["sharded_by_world"] = by_world
        if entry["name"] == "ctr_gen":
            entry["main_path_1gib"] = main_gib
            entry["sharded_ctr_gbps"] = {w: [r["ctr_gbps"] for r in d["ranks"]]
                                         for w, d in multi["worlds"].items()}

    phase("14")
    # 14. Drive A's mix once more, profiled (torch tier) and costed against
    # the ceiling the probe implies; its summary, trace and records land in
    # a temporary run layout, removed after. It runs last: the profiler's
    # hooks must not touch the timings above.
    from our_tree_tpu_torch.obs import profiler

    trace_root = tempfile.mkdtemp(prefix="ot_profile_")
    os.environ["OT_TRACE_DIR"] = trace_root
    try:
        line_c, _, _ = serve_drive("C", ["--requests", str(PROFILED_REQUESTS), "--mixed-sizes",
                                      "--profile-window", "1:2",
                                      "--ceiling-gbps", f"{ceiling_gbps:.6f}"])
        prof = line_c["profile"] or {}
        cap = prof.get("capture") or {}
        xrows = (prof.get("crosscheck") or {}).get("rows", [])
        cost_rungs = [r["rung"] for r in line_c["cost"]["rows"]]
        tk = (trace_kernels(os.path.join(trace_root, cap["run"], cap["torch_dir"], "trace.json"),
                            cap["t0_us"], cap["t1_us"]) if cap.get("torch_dir") else {})
        # The offline reading of the card's capture (PR 19): the report joins
        # the torch tier's summary with the cost records, and every slowest
        # exemplar must resolve to a whole span chain.
        rep_c = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.obs.report",
                                os.path.join(trace_root, cap.get("run", "")), "--profile",
                                "--check"], cwd=ROOT, capture_output=True, text=True,
                               timeout=300)
    finally:
        del os.environ["OT_TRACE_DIR"]
        os.environ.pop("OT_TRACE_RUN", None)
        shutil.rmtree(trace_root, ignore_errors=True)
    window_disp = sum(r["dispatches"] for r in cap.get("rungs", []))
    checks = {
        "profile section": bool(cap),
        "tier torch": cap.get("tier") == "torch",
        "summary valid": profiler.validate_summary(cap) == [],
        "crosscheck rows = window's dispatches": [
            (r["rung"], r["dispatches"]) for r in xrows] == [
            (r["rung"], r["dispatches"]) for r in cap.get("rungs", [])] and window_disp > 0,
        "crosscheck rows modeled": all(r["modeled_dispatch_bytes"] for r in xrows),
        "a cost row per warmed rung": cost_rungs == line_c["config"]["rungs"],
        "trace holds ctr_mk kernels": tk.get("ctr_mk_in_trace", 0) > 0,
        "obs.report --profile --check rc 0": rep_c.returncode == 0,
    }
    prof_text = rep_c.stdout.partition("\nprofile ")[2]
    log(f"serve C obs.report --profile --check: rc {rep_c.returncode}; profile "
        + " | ".join(t.strip() for t in prof_text.splitlines())[:1500]
        + (f"; stderr {rep_c.stderr[-600:]!r}" if rep_c.returncode else "") + f"; card: {card}")
    if tk:
        busy = tk["kernel_us"] / (cap["t1_us"] - cap["t0_us"])
        log(f"serve C profiled window: {cap['seconds']} s, {window_disp} dispatches; trace: "
            f"{tk['ctr_mk_kernels']} ctr_mk of {tk['kernels']} kernels in the window "
            f"({tk['ctr_mk_in_trace']} of {tk['kernels_in_trace']} in the whole trace), kernel "
            f"time {tk['kernel_us'] / 1e3:.3f} ms, copies {tk['memcpys']} taking "
            f"{tk['memcpy_us'] / 1e3:.3f} ms; card busy share {100 * busy:.2f} % (idle "
            f"{100 * (1 - busy):.2f} %) under the profiler; lanes' card time in the window "
            f"{cap['device_us'] / 1e3:.3f} ms of {cap['busy_us'] / 1e3:.3f} ms busy; card: {card}")
        for r in xrows:
            log(f"serve C window rung {r['rung']}: {r['dispatches']} dispatches, "
                f"{r['window_gbps']} GB/s moved, utilization {r['utilization']} of "
                f"{ceiling_gbps:.2f} GB/s")
    log(f"serve C cost rows: " + "; ".join(
        f"r{r['rung']} {r['dispatches']} disp {r['achieved_gbps']} GB/s util {r['utilization']}"
        for r in line_c["cost"]["rows"]) + f"; device utilization {line_c['device']['utilization']}")
    if not all(checks.values()):
        raise SystemExit(f"serve drive C's profile failed: {checks}")

    phase(None)
    walls.pop(None, None)
    print(json.dumps({"pulse": obs["pulse"]}), flush=True)
    print(json.dumps({"phase_wall_s": walls, "total_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def route_only(names: str, repeat: int) -> int:
    """``python3 chip_smoke.py --route-only d [REPEAT]``: build the kernels,
    then run phase 17's drives named in ``names`` (comma separated) alone,
    ``repeat`` times in a row, stopping at the first failure, whose record
    ``route_evidence`` logs. Prints one JSON line of the passes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from our_tree_tpu_torch.runtime import cuda_build

    card = smi("name,power.limit")
    t0 = time.perf_counter()
    cuda_build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s; card: {card}")
    drives = {n: ROUTE_DRIVES[n] for n in names.split(",")}
    walls = []
    for i in range(repeat):
        res = route_phase(card, drives=drives)
        walls.append({n: round(d["wall_s"], 1) for n, d in res["drives"].items()})
        log(f"route-only pass {i + 1} of {repeat}: {walls[-1]}")
    print(json.dumps({"route_only": names, "passes": len(walls), "walls_s": walls}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-rank"]:
        sys.exit(multi_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--route-only"]:
        sys.exit(route_only(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 1))
    sys.exit(main())
