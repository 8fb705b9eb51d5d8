#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is swallowed):

1. device  — the card's name and power limit, as ``nvidia-smi`` reports
   them.
2. build   — every kernel of the serving and training paths (the sLSTM
   cell's too), compiled from
   ``src/repro_torch/kernels/csrc`` by ``nvcc`` (one process per source,
   all started together).
3. kernels — the paged decode-attention kernel held against its plain
   PyTorch version on the card, in f32 (tol 1e-5) and bf16 (atol 3.2e-2, see
   ``tests/test_torch_paged_attention_card.py`` for why), at the serving
   shapes (one split of 4 pages) and at one long-context shape (a
   256-page table: 32 splits of 8 pages a row, gated to at least two CTAs
   per (row, kv head)); timed per call with CUDA events (warm-up, then
   the median of 25 samples of 10 launches; host overhead between
   launches included) and on the device alone with ``torch.profiler``
   (the split kernel plus, for several splits, the combine), beside the
   plain version,
   ``scaled_dot_product_attention`` on the gathered cache (a yardstick
   only; the port never calls it) and the least time the card could take
   (HBM 3.35 TB/s, and 67 TFLOP/s f32 FMA or 989 TFLOP/s bf16 by the
   operands' type; the larger bound). Every bound in this script is
   ``repro_torch.roofline.kernels.kernel_cost`` over the HBM rate and the
   kernel's own peak rate (:func:`bound_ms`).
4. spectral kernels — the four kernels of the hybrid checkpoint path
   (``csrc/spectral_lossy.cu``) held against their plain versions on the
   card, f32 with TF32 off, at the main path's shape (the packed moment
   buffer of full-width ``smollm-135m``: both moments of every parameter,
   each leaf padded to 8-block tiles, ~1.05 M blocks of 256) and at edge
   shapes (a block count that is no multiple of a CTA's 64 rows, all-zero
   blocks, 1e-20-scaled payloads with subnormal energies, eps >= 1).
   Gates: y of the DCT and x of the inverse allclose (rtol 1e-5, atol
   1e-5 x the block's RMS); on the kernel's own y, counts equal to the
   plain histogram and energies rtol 1e-5; q and scale bitwise for the
   same y and t. Each kernel is timed per call (CUDA events) and on the
   device (profiler) beside its plain version, its bound, and — for the
   two DCT kernels — one ``torch.matmul`` of the same f32 product (matmul
   only, a yardstick). How many per-leaf thresholds the all-kernel path
   and the all-plain path pick differently is recorded, not gated (the
   kernel and cuBLAS sum the DCT in different orders).
5. single-tensor spectral kernels — ``dct_hist_coarse`` and
   ``hist_refine`` (the lossy stage of the SYNC and ASYNC placements, one
   leaf at a time) held against their plain versions at the shape of each
   of the 22 moment leaves of full-width ``smollm-135m`` (8 to 110,592
   blocks) and at edge shapes (8 blocks, 1001 -> 1008 blocks, 1e-20-scaled
   and 1 %-sparse payloads). Gates: y of the DCT as in 4, and bitwise
   ``dct_hist_coarse_tiled``'s; ``dct_hist_coarse``'s histogram equal to
   ``dct_hist_coarse_tiled``'s tile rows summed (counts exactly, energies
   rtol 1e-6 of the rows summed in f64); on the kernel's own y, counts
   equal and energies rtol 1e-5; the thresholds of the
   card's two-level route equal to the CPU's flat route; and
   ``spectral_compress`` on the card bitwise equal (q and scale) to
   ``spectral_compress`` of the same leaf on the CPU; ``hist_refine``'s
   membership table deciding none of the 2^31 non-negative f32 bit
   patterns differently from the kernel's ``bin_index``, and its output
   the same bits over 5 calls and from two calls at once on two worker
   threads' streams (at ``embed``). Each kernel is timed
   at the ``embed`` leaf (as in 4; ``torch.matmul`` of the same f32
   product is the DCT's yardstick) and summed over the 22 leaves of one
   save.
6. roofline — the flat 512-bin pair (``dct_hist_tiled``, ``dct_hist``)
   held against its plain version and against the two-level kernels on
   the card, at the edge shapes of 4, at ``benchmarks/kernel_roofline.py``'s
   256 and 4096 standard-normal blocks (seed 0), at the ``embed``
   moment leaf in four payload kinds (1e-20 and 1 %-sparse included) and
   at the packed moment buffer of 4 (the main shape of its table row).
   Gates: y (and ``dct_hist_coarse``'s) bitwise equal to
   ``dct_hist_coarse_tiled``'s; on the kernel's own y, counts equal to the
   plain version's (an element on a bin edge
   where the kernel's log2f and ``ref.bin_index`` could round apart may
   move, and is counted and printed) and energies rtol 1e-5; the single
   histogram equal to the tile rows summed (energies rtol 1e-6); every 16
   flat bins equal to the coarse kernel's bin, and the 16 inside a tile's
   coarse bin to the refine kernel's counts; the flat threshold bitwise
   equal to the two-level kernels' (``dct_hist_coarse`` + ``hist_refine``)
   at eps 1e-3, 1e-2, 1e-1 and 1.5. Then the roofline of all nine kernels:
   launch counts set to 0, ``kernel_report(..., measure=True)`` of each
   kernel at its table shape (paged attention at the serving shape, the
   tiled spectral kernels at the packed buffer, the single-tensor ones at
   ``embed``, the flat pair at the packed buffer, at 4096 blocks and, the
   single one, at ``embed``), one JSON line each, counts read. Last, the
   flat pair's reports (per-call ms and bound) beside its device time (as
   in 4), its plain version and ``torch.matmul``, and the flat/two-level
   ratios: kernel 9 against 6 + 7 at ``embed``,
   kernel 8 against 2 + 3 at the packed buffer (not gated: the 3x gate of
   ``kernel_roofline`` is about one-hot binning on a TPU's MXU).
7. serve   — the port's ``serve_loop("smollm-135m", smoke=False)``: full
   published widths (30 layers, d_model 576, 9 query / 3 KV heads, d_ff
   1536, vocab 49152), bf16 random weights from seed 0, 16 requests of 32
   new tokens over a 17-page pool (requests queue on pages). The same
   traffic runs four times: with no in-situ task and with the default
   async ``serve_snapshot`` plan (persisting its chain under ``build/``),
   each once stepping eagerly (``cuda_graph=False``) and once replaying
   the decode step's CUDA graph (the default); tok/s of all four are
   printed. Asserts: the four runs decode the same token streams; all
   served, pool empty at exit, snapshots published, each chain restores
   bit-identically to what was emitted at its step, and in the graphed
   run with snapshots the kernel ran once per layer per decode step
   (launches counted under replay). Then a graphed and an eager engine
   step 8 times from one state and their logits must be the same bits;
   one full-width decode step runs twice from one state — through the
   kernel and through the plain version — and the logits are compared
   (atol 0.125: a few bf16 steps of attention difference carried through
   30 layers; logits are O(1)); and ten decode steps of each engine are
   profiled: host wall per step, aten ops, device busy time and idle
   share, the busiest device ops.

8. stream  — the streamed in-situ path at full width, graphed. (a) A
   cold replica in a child process (``tools/torch_hydrate_smoke.py
   --replica --full``, JAX-free) listens on a port the OS picks; the
   serve phase's traffic runs through ``serve_loop`` with
   ``default_serve_plan(snapshot_to=...)`` pointed at it. The replica
   hydrates a graphed engine (``from_snapshot``) from the first
   restorable chain with in-flight requests, stays attached
   (``follow``) and decodes its requests to completion. Gates: every
   replica token equals the producer's at the same position of the same
   request; no prefill after hydration; the engine's buffers keep their
   addresses through ``_apply_snapshot``; the replica's paged-attention
   launches are its steps x 30 and the producer's its decode steps x 30
   (counts set to 0 before, read after); no failed mirror send. Printed:
   ``ingest_s``, ``restore_s``, the first replay, and a warm hydrate +
   step against re-prefilling the same requests + step. (b) 6 graphed
   ``train_loop`` steps (4 x 4096 tokens) with a HYBRID checkpoint every
   2 steps mirrored over ``tcp://`` to a ``consume_loop`` thread that
   steers the task to every=3 after its first frame (a SYNC task at
   step 1 waits for the message, so the change lands at a known step).
   Gates: the steering applied, saves at 0 and 3, kernels 2-4 twice (counts
   set to 0 before, read after), no failed mirror send, every consumed
   file sha256-equal to the producer's, the consumed step 3 restored on
   the card with params bitwise as emitted and moments within
   ``error_bound(eps)``, ``dequant_idct`` once per lossy leaf. (c)
   ``serve_loop(engine_kind="dense")`` and ``"paged"`` on the same
   traffic, both graphed: every request served; tok/s and equal tokens
   printed (no order gated); the first decode step of a dense and a
   paged engine from the same admissions within atol 0.125 (bf16:
   information, not a fault gate). (d) The same traffic in f32 (config
   and weights cast) through the dense 4-slot engine and a 4-row paged
   engine, both graphed: every stream equal token for token.
9. train   — the port's ``train_loop("smollm-135m", smoke=False)``:
   published widths at 10 of its 30 layers (``SMOLLM_TRAIN_LAYERS``, cut
   for the time limit; phases 9 and 10 only), batch 4 x 4096 tokens
   (``train_4k``'s length,
   its global batch of 256 cut to 4 for one card), bf16 state from seed
   0, each step a replay of the captured train step (the default). First
   the bare loop (no in-situ task), 3 steps from seed 0, eagerly twice
   and graphed once: the graphed losses must be bitwise the eager ones if
   the two eager runs are bitwise equal, else within their spread. Then,
   in HYBRID placement, 11 steps with no checkpoint task bound (what the
   in-situ work costs), then 11 steps with a checkpoint every 5 steps
   under ``build/`` (launch counts are set to 0 just before and read just
   after: kernels 2-4 once per save), then a direct restore of the newest
   step (kernel 5 once per lossy leaf) whose params must equal bitwise
   the state emitted at that step and whose moments must be within
   ``error_bound(eps)`` relative L2 per leaf, then a second run that
   resumes from it. Also: the device stage alone on the trained state,
   and one train step's device profile, eager and replayed, each with
   its peak memory (and what the graph's pool keeps).
10. train (sync/async ckpt) — the same graphed loop, 6 steps with a
   checkpoint every 5 steps (saves at 0 and 5) in SYNC and then in ASYNC
   placement: the lossy stage runs per leaf on the checkpoint's workers
   through the single-tensor kernels. Launch counts are set to 0 just
   before each run and read just after: 22 each of ``dct_hist_coarse``,
   ``hist_refine`` and ``threshold_quant`` per save, none of the tiled
   pair. Then a restore of step 5 (params bitwise as emitted, moments
   within ``error_bound(eps)``). Printed beside the HYBRID run's numbers:
   step time, the checkpoint's loop-blocking seconds, its worker seconds,
   raw/stored bytes and the restore time; the p_o/p_i allocator's choice
   from the measured SYNC and ASYNC save costs. Then HYBRID, SYNC and
   ASYNC eagerly (``cuda_graph=False``), 3 steps and one save each: the
   losses the graphed runs', the step time beside theirs, and the
   loop-blocking of the step-0 save beside that of theirs.
11. insitu — the legacy in-situ engine path, the checkpoint write layouts
   and the examples. (a) ``run_pipeline`` drives a ``PipelineRuntime``
   whose HYBRID task's device stage is ``ops.spectral_compress`` over an
   ``embed``-sized CUDA tensor (110,592 blocks, 3 firings), and
   ``run_workflow`` an ``InSituEngine`` with a SYNC and an ASYNC task that
   compress the hand-off on the card on their own thread's stream. Gates:
   q and scale of each firing bitwise equal to a ``Session`` run of the
   equivalent plan on the same inputs (and across the three placements);
   kernels 6, 7 and 4 once a firing and no other kernel (counts set to 0
   before each run, read after); SYNC results from the loop thread, ASYNC
   ones from ``insitu-*`` workers; the engine's report has the session
   report's keys. (b) The full-width ``smollm-135m`` state (params, AdamW
   moments filled from seed 1) saved through a HYBRID
   ``CheckpointManager`` with ``shard_count=4``, again with ``format=1``,
   and its moments and count once more with ``leaf_parallel=False,
   chunk_parallel=False``: one dispatch of kernels 2-4 a save; more than
   one shard; each v1 file byte for byte the bytes at its offset in the
   shards; the serial save's blobs equal to the fanned-out save's; both
   layouts restore with every leaf but the moments bitwise and moments
   within ``error_bound(eps)``, 22 ``dequant_idct`` launches each. Printed:
   each save's wall, loop-blocking and worker seconds, and each restore's
   seconds. (c) ``examples/torch_quickstart.py`` and
   ``examples/torch_compression_demo.py`` as child processes on the card:
   exit 0, the three placements' lines, "weights bit-exact = True". The
   phase must take at most 90 s.
12. moe — the MoE family. (b) The paged decode-attention kernel at
   ``moonshot-v1-16b-a3b``'s heads (16 kv heads of 128, one query head
   each; B = 8, the serving table of 4 pages and a 256-page one) against
   its plain version: bf16 at page 16 (atol 3.2e-2) and f32 at pages 16
   and 8 (1e-5), the split kernel taking the heads in groups
   (``head_group``; its shared-memory bytes equal to the source's); timed
   per call and on the device beside the plain version, SDPA on the
   gathered cache and the bound. At smollm's shapes the plan keeps one
   group, and forcing three groups of one (the same pages a round) gives
   the same output bits. (c)
   Both MoE archs at smoke size in f32: the dense 4-slot engine and a
   4-row paged engine decode the serve traffic token for token, and 8
   replayed paged decode steps equal the eager ones bitwise. (a)
   ``serve_loop("moonshot-v1-16b-a3b", smoke=False)``: 48 layers at the
   published widths (28.3 G parameters, 56.6 GB in bf16, drawn on the
   card's generator from seed 0) on the serve traffic (16 requests x 32
   new tokens, page 16, a 17-page pool), eager and graphed with no
   in-situ task and graphed with the default async ``serve_snapshot``
   plan (the eager run with snapshots was cut for the time limit): the
   three runs decode the same streams, every request is served and the
   pool empty at exit, the graphed run's chain (persisted under ``build/``, beside
   a probe of what was emitted) restores bit-identically (the bytes a
   firing publishes printed, raw, zlib base and zlib delta), and each run
   launches the kernel 48 times a decode step. Then a graphed and an eager engine step 8 times
   from one state (logits the same bits) while the graphed one publishes
   a SYNC chain; a replica built in process with
   ``PagedServingEngine.from_snapshot`` from that chain decodes the 8
   in-flight requests token for token over 6 steps with no prefill; one
   decode step driven by the plain attention with the kernel held against
   it at each of the 48 layers on that layer's inputs (atol 3.2e-2), and
   the logits of a kernel step beside those of the plain step and of the
   attention computed with f32 internals (printed: at 48 MoE layers the
   plain version's own bf16 rounding moves logits by up to 0.25, so no
   logit bound is gated); and the graphed decode step profiled, the
   eager one's host wall beside it. Printed: tok/s of the
   three runs, peak memory, the weights' draw seconds, the decode step's
   host wall, device busy time and idle share. The phase must take at
   most 150 s.
13. hybrid — the hybrid family (``hymba-1.5b``: parallel attention and
   SSM heads, SWA rings on 29 layers, 3 global layers). (a) The paged
   decode-attention kernel at hymba's heads (25 query heads over 5 kv
   heads of 64: one CTA holds all 25, more than its 16 warps; B = 8, the
   serving table of 4 pages and a 256-page one) against its plain
   version in bf16 (atol 3.2e-2) and f32 (1e-5), one head group (its
   shared-memory bytes equal to the source's), timed per call and on
   the device beside the plain version, SDPA on the gathered cache and
   the bound. (b) The smoke config in f32 with 40-token prompts past its
   32-token window and 32 new tokens (the ring wraps in prefill and again
   in decode): the dense 4-slot engine and a 4-row paged engine token for
   token; a graphed and an eager 8-row paged engine from one state decode
   the same tokens, the graphed one publishing a SYNC chain; a replica
   restored from it at step 12 into a captured engine decodes in
   lockstep with no prefill. (c) ``serve_loop("hymba-1.5b",
   smoke=False)``: 32 layers at the published widths (1.66 G parameters,
   3.33 GB in bf16, drawn on the card's generator from seed 0) on the
   serve traffic, eager and graphed bare and graphed with the default
   async ``serve_snapshot`` plan (the eager run with snapshots cut, as in
   12): the three runs decode the same streams,
   every request served and the pool empty, the graphed run's chain
   restores bit-identically, and each run launches the kernel 3 times (the
   global layers) a decode step. Printed: the bytes a firing
   publishes of ``pool`` and of ``state`` (raw, zlib base, zlib delta);
   a graphed and an eager engine of 8 rows: two steps with the same
   logits bits, then one decode step with the kernel held against the
   plain attention at the 3 global layers on their inputs (atol 3.2e-2);
   the graphed decode step profiled and the eager one's host wall. Then 8 requests of
   1000-token prompts and 64 new tokens (max_len 1088, the SWA rings of
   1024 slots wrapping in decode, the kernel over ~66 pages a row): the
   graphed engine = an eager one's tokens over the first 8 steps, the
   kernel against the plain attention at the global layers of one step,
   and the rest of the run at 3 launches a step. The phase must take at
   most 150 s.
14. xlstm — the xLSTM family (``xlstm-1.3b``: 6 super-blocks of 7 mLSTM
   layers and one sLSTM layer; no attention, no page pool, and 5.65 GB of
   per-row recurrent state at 8 rows, all of it rewritten every step, in
   place). Only the sLSTM cell's forward kernel lies on its path (the
   recurrent product beside it is ``torch.bmm``): every kernel's launch
   count is set to 0 at the start of the phase, and at its end that one
   reads above 0 and every other 0. (a) The
   smoke config in f32 and a variant with 8 blocks and one sLSTM per 4
   (three mLSTM layers a super-block), 32-token prompts and 32 new
   tokens: the dense 4-slot engine and a 4-row paged engine token for
   token; a graphed and an eager 8-row paged engine from one state decode
   the same tokens, the graphed one publishing a SYNC chain of state
   leaves only; a replica restored from it at step 12 into a captured
   engine decodes in lockstep with no prefill. (b)
   ``serve_loop("xlstm-1.3b", smoke=False)``: 48 blocks at the published
   widths (3.61 G parameters, 7.21 GB in bf16, drawn on the card's
   generator from seed 0) on the serve traffic, eager and graphed bare and
   graphed with an async ``serve_snapshot`` plan sized for its payload
   (one worker, a staging ring of one, frames stored raw, every frame a
   base, one chain kept under ``build/``; the default plan holds up to
   six 5.65 GB firings in flight and a chain in memory, and is measured
   by ``tools/torch_xlstm_serve_plan.py``): the three runs decode the
   same streams, every request served and every reserved page back; the chain restores
   bit-identically to the sha256 digests (per 256 MiB) of every leaf of
   the firing it ends at, taken as that firing was published. Printed:
   tok/s, peak memory on the card, the host's ``MemAvailable`` and RSS,
   firings published and dropped, the loop-blocking and drain seconds,
   each firing's raw and stored bytes, the frames on disk, zlib's base and
   delta of 64 MiB of ``c`` (bytes, seconds, and a whole firing's seconds
   at that rate); the weights' draw seconds; the graphed decode step
   profiled (busy ms, idle share, top ops) and the eager step's host wall.
   (c) 2 requests of 1024-token prompts (8 mLSTM chunks of 128, 1024 sLSTM
   steps a layer) prefilled once; an eager engine from that state decodes
   the same tokens as the graphed one over 8 steps. The phase must take
   at most 150 s.
15. frontend — the frontend families (``internvl2-26b``, vlm: 48
   layers, d_model 6144, 48 query heads over 8 kv heads of 128; and
   ``musicgen-medium``, audio: 48 layers, d_model 1536, MHA of 24 heads of
   64), the dense backbone behind a stub that prepends precomputed patch
   or frame embeddings in training; serving is token-only. (a) The paged
   decode-attention kernel at both head shapes (B = 8, page 16, the
   serving table of 4 pages and a 256-page one) against its plain
   version in bf16 (atol 3.2e-2) and f32 (1e-5), every head group's
   shared-memory bytes equal to the source's; timed per call and on the
   device (from a profiler window that recorded the launches it divides
   by: launches recorded are printed beside launches made) beside the
   plain version, SDPA on the gathered cache and the bound; hymba's
   heads timed the same way. (b) Both smoke configs in f32: the dense
   4-slot engine and a 4-row paged engine token for token; a graphed and
   an eager 8-row paged engine from one state decode the same tokens, the
   graphed one publishing a SYNC chain; a replica restored from it into a
   captured engine decodes in lockstep with no prefill; internvl's 8
   requests behind a registered shared prefix decode the tokens of the
   same prompts unshared; a smoke ``forward`` with a prefix on the card
   against the same call on the CPU (rtol/atol 1e-4). (c)
   ``serve_loop("internvl2-26b", smoke=False)`` (19.9 G parameters, 39.7
   GB in bf16, drawn on the card's generator from seed 0) on the serve
   traffic, eager and graphed bare and graphed with the default async
   ``serve_snapshot`` plan: the runs decode the same streams, every
   request served and the pool empty, each run launches the kernel 48
   times a decode step, the chain restores bit-identically. (d)
   ``serve_loop("musicgen-medium", smoke=False)`` graphed bare (its eager
   run cut for the phase's time), with the same gates. After each of (c)
   and (d) the weights are drawn once more for a graphed and an eager
   engine of 8 rows: two steps with the same logits bits, then one
   decode step with the kernel held against the plain attention at all
   48 layers on their inputs; the graphed decode step profiled, the eager
   one's host wall. (e) ``train_loop("musicgen-medium", smoke=False)``
   eagerly, then graphed, 2 steps each (4 x 4096 tokens and 64 prefix
   frames a row, bf16, seed 0, no checkpoint task): the graphed losses
   equal the eager ones bit for bit, finite; every forward ran on 4 x
   4160 positions; no kernel launched. Printed: capture seconds, step
   medians, the replayed step's device busy ms and idle share, peak
   memory, the model FLOPs a step over the median step as a share of 989
   TFLOP/s. The phase must take at most 150 s.
16. family_train — the train path of the hybrid, xLSTM and MoE/MLA
   families, through ``tools/torch_family_train.py``'s ``run`` (module
   docstring there; the full depths run there, not here). First the two
   sLSTM cell kernels (``csrc/slstm.cu``: ``slstm_cell`` and
   ``slstm_cell_bwd``) against their plain versions at ``xlstm-1.3b``'s
   full width (4 rows x 2048, bf16 weights and h) on every step of one
   layer's 4096, forward and backward, each kernel call repeated by the
   plain version on its inputs (max |d| over max |plain| within 1e-5, h
   and the bf16 gate cotangents within 2^-8); then ``SLSTMScan`` on the
   kernels against the plain time loop under autograd, the loop summing
   r_gates' gradient in f32 (relative L2: h and the final state 1e-2, the
   gradients of the layer's input, ``w_gates``, ``r_gates`` and
   ``b_gates`` 2e-2; the control, the loop summing it in bf16, logged);
   each kernel timed per call and on the device beside its plain version,
   the recurrent ``bmm`` and its bound (those launches are not the
   path's). (a)
   ``train_loop("hymba-1.5b", smoke=False)`` at full width and 4 of its
   32 layers (``FAMILY_HYMBA``: a global layer 0, then 3 sliding-window
   layers; ``configs.get`` patched for the call; 4 x 4096 tokens, bf16,
   seed 0 on the card's generator): 2 steps eagerly, then 2 graphed with
   a HYBRID checkpoint that saves at step 0 (frames raw) and a SYNC probe
   keeping the state emitted there, then a second graphed ``train_loop``
   on the same directory that logs "resumed from step 0" and takes 1
   step.
   Gates: the graphed losses equal the eager ones bit for bit, all
   finite; the restored params and count equal those emitted at step 0
   bit for bit and each moment leaf is within ``error_bound(1e-2)``
   (or, below the selectors' absolute energy slack of 1e-30, within an
   error norm of 1e-15; checked on the card); kernels 2-4 once a packed
   group of the save (``ops.GROUP_BYTES``), kernel 5 once a restored
   moment leaf, no other
   kernel (counts set to 0 before each run, read after); after the
   resume, kernels 2-5 against their plain versions (``spectral_check``,
   the spectral phase's tolerances) on the packed buffer of the save's
   largest group and of its largest leaf past ``ops.GROUP_BYTES`` where
   one is, made from the moments emitted at step 0 (those launches not
   counted). Printed: step
   seconds and medians, capture seconds, peak memory, the last replay's
   device busy ms and idle share (a SYNC task opens the profiler window
   after the step-0 save and closes it at the last step), model FLOPs
   over the median step as a share of 989 TFLOP/s, the save's groups,
   loop blocking and bytes raw and stored, the restore's seconds and
   worst moment error. (b) ``xlstm-1.3b`` at full width in one
   super-block (8 blocks: 7 mLSTM, 1 sLSTM), the same runs and gates
   with one eager step (the graphed losses equal it over that step) and
   its resumed step eager (a capture there takes ~60 s). (c) The smoke
   configs of ``moonshot-v1-16b-a3b`` and ``deepseek-v3-671b`` (smoke
   shape, bf16):
   3 steps eagerly and 3 graphed, each run with a HYBRID save at step 0,
   and the resume; the same gates, and the eager losses within 2e-2 (the
   MoE family's bf16 bound) of the port's own CPU run of the same seed.
   The phase must take at most 280 s.
17. fault — a host drop detected, restored and resumed:
   ``tools/torch_fault_killpoint.py``'s ``run_scenario`` (module
   docstring there; full depth runs there) on full-width ``smollm-135m``
   at 2 of its 30 layers (``FAULT_LAYERS``; widths unchanged), 4 x 4096
   tokens, in a world-size-1 NCCL group: a golden run of 9 graphed steps;
   the same run with the ``fault`` preset (hosts 0 and 1 beat on a clock
   advancing 1 s a step, host 1 stops at step 4, grace 2.5 s) and HYBRID
   v2 checkpoints every 2 steps with the mesh geometry, halted when host
   1 is declared failed; ``Session.restore(elastic=True)`` onto a
   ``DeviceMesh`` of the surviving rank (``plan_elastic_remesh``), each
   leaf placed under ``state_shardings``, and a resume to step 8 (one
   captured step serves the three runs). Gates: host 1 failed, host 0
   alive, detection at or after step 4, the restored step at or before
   it, the resume reaches step 8, every resumed loss within
   ``max(0.05, 0.02 |golden|)`` of golden, the failure run's losses
   equal golden bit for bit up to the halt; the restored state against
   the state emitted at its step (params and count bitwise, moments
   within ``error_bound(1e-2)``); kernels 2-4 once a packed group a save
   and kernel 5 once a moment leaf in the restore, no other kernel;
   kernels 2-5 against their plain versions on the restored save's
   largest packed group (``spectral_check``, those launches not
   counted). The phase must take at most 30 s.
18. shard — the train step sharded across processes:
   ``tools/torch_shard_step.py``'s ``run_pair("smoke")`` (module
   docstring there; full depth runs there): two child processes in a
   gloo world of two on the card's device 0 (NCCL refuses two ranks on
   one device; the collectives stage through host buffers), full-width
   ``smollm-135m`` at 2 of its 30 layers (``SHARD_LAYERS``), 4 x 4096
   tokens, eager. (a) ``jit_train_step`` on a (1, 2) ('data', 'model')
   mesh under the default rules, 2 steps under
   ``tools/torch_fault_killpoint.py``'s ``CHECK_STEP`` (rate 1.0 from the first step, f32 masters, eps 1.0:
   every update moves the parameters): losses, gradient norms, the
   gathered params, masters and moments against one process's
   ``make_train_step`` on the card on the same batches (loss atol 1e-5,
   grad norm rtol 1e-3, each param / master leaf's change from the
   initial state within 0.1 / 0.03 of the one process's change, relative
   L2, which must be nonzero; moments 5 % of the leaf's largest |value|;
   bitwise recorded). (b) a (2, 1, 1) ('pod', 'data', 'model') mesh under
   ``int8`` with error feedback, 2 steps: on every leaf the ring's output
   bit for bit against ``int8_ring_mean_plain`` of both pods' inputs, and
   (n - 1) x numel int8 bytes on the wire. (c) a HYBRID save of (a)'s
   gathered state, masters included, by rank 0 (kernels 2-4 once a
   packed group),
   ``restore(elastic=True)`` on both ranks (kernel 5 once a moment leaf
   each; the plan (1, 2) -> (1, 2), merge 1), the restore against the
   saved state (params bitwise, moments within ``error_bound(1e-2)``),
   one resumed sharded step; kernels 2-5 against their plain versions
   on the save's largest packed group (``spectral_check``, not counted).
   The phase must take at most 45 s.
19. dryrun — ``launch/dryrun.py``'s lowering on fake tensors (rank 0 of a
   ``fake`` process group, device ``cuda``, no kernel launched) held
   against the card: the train phase's configuration (``smollm-135m`` at
   10 of 30 layers, 4 x 4096 tokens, bf16) on a (1, 1) mesh, lowered
   through its depth variants (1 and 2 layers) fitted to 10, and the
   serve decode (30 layers, the serve phase's 8 rows, a 64-position
   cache) at full depth; then one eager ``ShardedTrainStep`` on a (1, 1)
   ``DeviceMesh`` of an NCCL world of one and one eager ``make_decode``
   step on the card. Gate: each predicted per-rank peak within 15 % of
   ``torch.cuda.max_memory_allocated`` over its step (above what was
   allocated before its state was made). Printed: the ratio, the counted
   FLOPs beside ``roofline.model_flops``. The phase must take at most 30
   s.

The last lines are the card line, one JSON object with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 3.2e-2
LOGIT_ATOL = 0.125
SERVE = dict(n_requests=16, max_new=32, num_pages=17, page_size=16, slots=4)
EPS = 1e-2                          # the checkpoint's lossy_eps
FLAT_EPS = (1e-3, 1e-2, 1e-1, 1.5)  # the flat/two-level threshold gate
ROOFLINE_ITERS = 10                 # timed calls per kernel_report
# the train phases' runs, cut from 20 and 10 steps for the time limit
# (PERF.md section 4): still 3 HYBRID saves (0, 5, 10) and 2 SYNC/ASYNC
# saves (0, 5)
TRAIN = dict(steps=11, ckpt_every=5, resume_steps=5)
PLACEMENTS = dict(steps=6, ckpt_every=5)      # the SYNC/ASYNC runs
# the train phases' eager comparison runs, cut from 5 and 10 steps for the
# time limit (PERF.md §4): bare steps, and the placements' eager reruns
# (a checkpoint every ckpt_every: one save, at step 0)
EAGER = dict(bare_steps=3, placement_steps=3)
INSITU = dict(steps=3, shard_count=4)          # the insitu phase
INSITU_BUDGET_S = 90.0
MOE_BUDGET_S = 150.0
# the full-width family phases' serve runs: (plan, graphed); the eager run
# with snapshots was cut for the time limit (PERF.md section 4)
SERVE_RUNS = (("bare", False), ("bare", True), ("plan", True))
HYBRID_BUDGET_S = 150.0
XLSTM_BUDGET_S = 150.0
# the train and train (sync/async) phases run smollm-135m at 10 of its 30
# layers (widths unchanged) for the time limit (PERF.md section 4); the
# spectral, single-tensor and roofline phases keep the full-width shapes
SMOLLM_TRAIN_LAYERS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_profile(fn, n: int) -> dict:
    """Run ``fn`` n times under ``torch.profiler``: wall time, the device's
    busy time (sum of kernel and copy time on the card) and each device
    op's time, per call. Device numbers are None when the profiler saw no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, launches = {}, {}
    host_ops = 0
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            host_ops += e.count
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                ops[e.key] = us / 1e3 / n
                launches[e.key] = e.count
    busy = sum(ops.values())
    return {"wall_ms": wall * 1e3 / n, "host_aten_ops": host_ops / n,
            "device_busy_ms": busy if ops else None,
            "device_idle_share": (1 - busy / (wall * 1e3 / n)) if ops
            else None,
            "top": sorted(ops.items(), key=lambda kv: -kv[1])[:8],
            "per_launch_ms": {k: ms * n / launches[k]
                              for k, ms in ops.items()},
            "launches": launches}


def host_wall_ms(fn, n: int) -> float:
    """Host wall ms per call of ``fn`` over n calls, without the profiler
    (whose tracing of each kernel of a graph replay inflates the wall)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def kernel_device_ms(fn, syms, n: int = 3) -> tuple[float | None, dict]:
    """Device ms of one call of ``fn``, which launches each kernel named in
    ``syms`` once: the sum of their mean times per recorded launch, and
    per kernel (ms per launch, launches recorded of the n that ran). The
    profiler has recorded fewer launches than ran (1 or 2 of 3 for a 5 ms
    kernel on the H100), which a window's sum over n calls would report
    as time not spent."""
    prof = device_profile(fn, n)
    ops = {op: (ms, prof["launches"][op])
           for op, ms in prof["per_launch_ms"].items()
           if any(sym in op for sym in syms)}
    return sum(ms for ms, _ in ops.values()) or None, ops


def bound_ms(name: str, *args) -> tuple[float, str]:
    """Least time of kernel ``name`` on these arguments on one H100 and
    what bounds it: ``kernel_report``'s roofline time (its ``kernel_cost``
    over the HBM rate and the peak rate of the kernel's arithmetic,
    whichever is larger)."""
    from repro_torch.roofline.kernels import kernel_report

    rep = kernel_report(None, args, name=name)
    return rep.roofline_s * 1e3, ("operations" if rep.bound == "compute"
                                  else "bytes")


def time_ms(fn, *, warmup: int = 5, samples: int = 25, reps: int = 10):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _paged_case(gen, *, b, hq, n_kv, d, ps, pps, lengths, dtype, dev):
    """Random q, pages, a permuted table and ``lengths``, drawn on the
    generator's device."""
    import torch

    num_pages = b * pps + 1
    on = dict(generator=gen, device=gen.device)
    k = torch.randn((num_pages, ps, n_kv, d), **on)
    v = torch.randn((num_pages, ps, n_kv, d), **on)
    q = torch.randn((b, 1, hq, d), **on)
    table = (1 + torch.randperm(b * pps, **on)).reshape(b, pps)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            table.to(dev, torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _sdpa_call(q, k, v, table, length):
    """One ``scaled_dot_product_attention`` over the gathered cache (GQA
    by ``enable_gqa``), as a timing yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as A

    kg = A.gather_pages(k, table).transpose(1, 2)     # (B, N, S, D)
    vg = A.gather_pages(v, table).transpose(1, 2)
    qh = q.transpose(1, 2)                            # (B, Hq, 1, D)
    pos = torch.arange(kg.shape[2], device=q.device)
    mask = (pos[None, :] < length[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)


def kernel_phase(serve_table_width: int) -> dict:
    import torch
    from repro_torch.kernels import paged_attention as PK

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    ps = SERVE["page_size"]
    shapes = {"serve": _serve_shape(serve_table_width),
              "long": _serve_shape(4096 // ps)}
    out: dict = {"max_err_f32": 0.0, "max_err_bf16": 0.0}
    for name, shp in shapes.items():
        full = shp["ps"] * shp["pps"]
        lengths = [0, 1, ps, ps + 1, full, full, full // 2 + 3, full - 1]
        for dtype in (torch.float32, torch.bfloat16):
            args = _paged_case(gen, lengths=lengths, dtype=dtype, dev=dev,
                               **shp)
            got = PK.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = PK.paged_decode_attention_plain(*args)
            err = (got.float() - ref.float()).abs().max().item()
            if not math.isfinite(err):
                raise AssertionError(f"{name} {dtype}: non-finite output")
            tol = (F32_TOL if dtype == torch.float32
                   else dict(rtol=0.0, atol=BF16_ATOL))
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            key = "max_err_f32" if dtype == torch.float32 else "max_err_bf16"
            out[key] = max(out[key], err)
            log(f"kernel {name} {str(dtype)[6:]}: max |kernel - plain| "
                f"= {err:.3e} (lengths {lengths})")
        # timing: bf16 (the serving dtype), every row at full length
        args = _paged_case(gen, lengths=[full] * shp["b"],
                           dtype=torch.bfloat16, dev=dev, **shp)
        ref = PK.paged_decode_attention_plain(*args)
        err = (PK.paged_decode_attention(*args).float()
               - ref.float()).abs().max().item()
        k_ms = time_ms(lambda: PK.paged_decode_attention(*args))
        p_ms = time_ms(lambda: PK.paged_decode_attention_plain(*args))
        lib_ms = time_ms(_sdpa_call(*args))
        b_ms, b_by = bound_ms("paged_decode_attention", *args)
        # the split kernel and, for more than one split, the combine
        dev_ms, dev_ops = kernel_device_ms(
            lambda: PK.paged_decode_attention(*args),
            ("paged_decode_kernel", "paged_combine_kernel"), 20)
        splits, per = PK.split_plan(shp["pps"], ps, shp["b"], shp["n_kv"])
        if name == "long":     # at least two CTAs per (row, kv head)
            assert shp["b"] * splits >= 2 * shp["b"] * shp["n_kv"], splits
        out[name] = {"shape": dict(shp, len=full, dtype="bfloat16"),
                     "splits": splits, "pages_per_split": per,
                     "max_abs_err": err, "ms": k_ms, "device_ms": dev_ms,
                     "device_ops": dev_ops, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel {name} timing (bf16, B={shp['b']}, len={full}, "
            f"{splits} splits of {per} pages): kernel {k_ms:.4f} ms per "
            f"call (device {dev_ms} ms: {dev_ops}), plain {p_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return out


# ---------------------------------------------------------------------------
# spectral kernel phase
# ---------------------------------------------------------------------------

def moment_rows(cfg) -> tuple[list[str], list[int], list[int]]:
    """The hybrid save's packed buffer for ``cfg``: (leaf keys, elements,
    rows) of every moment leaf (mu then nu, JAX flatten order), each padded
    to the 8-block histogram tile."""
    from repro_torch.core import pytree
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.models import transformer

    keys, sizes, rows = [], [], []
    for grp in ("mu", "nu"):
        for path, s in pytree.flatten_with_path(transformer.param_spec(cfg)):
            n = math.prod(s.shape)
            nb = -(-n // 256)
            keys.append(pytree.keystr((grp,) + path))
            sizes.append(n)
            rows.append(nb + (-nb) % K.HIST_TILE)
    return keys, sizes, rows


def _spectral_payload(gen, sizes, rows, dev, kind="moments"):
    """Packed (rows, 256) f32 buffer, leaf by leaf: moment-like values (mu
    ~ N(0, 1e-3), nu ~ |N(0, 1e-6)|^2-ish) or an edge class."""
    import torch

    buf = torch.zeros((sum(rows), 256), device=dev)
    flat = buf.view(-1)
    off = 0
    for i, (n, r) in enumerate(zip(sizes, rows)):
        v = torch.randn(n, generator=gen, device=dev)
        if kind == "tiny":
            v = v * 1e-20
        elif kind == "zeros":
            v = v * (torch.arange(n, device=dev) // 256 % 3 != 0)
        elif i >= len(sizes) // 2:
            v = (v * 1e-3) ** 2                   # nu: positive, small
        else:
            v = v * 1e-3                          # mu
        flat[off:off + n] = v
        off += r * 256
    return buf


def _leaf_bounds(rows):
    out, off = [], 0
    for r in rows:
        out.append((off // 8, (off + r) // 8))
        off += r
    return out


def _block_rms(x):
    import torch
    return torch.sqrt(torch.mean(x.double() ** 2, dim=1, keepdim=True)).float()


def _check_close(name, got, want, rows_of):
    """allclose with rtol 1e-5 and atol 1e-5 x the block's RMS."""
    tol = 1e-5 * _block_rms(rows_of) + 1e-5 * want.abs()
    err = (got - want).abs()
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements off (max err "
                             f"{err.max().item():.3e})")
    return err.max().item()


def spectral_check(xb, rows, eps, label):
    """Every kernel against its plain version on one packed buffer, with
    the thresholds the path computes. Returns the max errors and the
    kernel path's intermediate results."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K

    bounds = _leaf_bounds(rows)
    n_rows = torch.tensor(rows, device=xb.device)
    y, cnt, eng = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    y_p = ref.dct_blocks(xb)
    err_y = _check_close(f"{label} dct y", y, y_p, y_p)
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), 16, rounding_mode="floor")
    cnt_p, eng_p = K._tile_sums(a * a, coarse, 32, 8)
    del a, coarse
    if not torch.equal(cnt, cnt_p):
        raise AssertionError(f"{label} coarse counts differ "
                             f"({int((cnt != cnt_p).sum())} of {cnt.numel()})")
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    err_e = ((eng - eng_p).abs() / eng_p.abs().clamp(min=1e-38)).max().item()
    c, cc, base, budget = ref.select_coarse(ops._segment_rows(eng, bounds), eps)
    block_cc = torch.repeat_interleave(cc.to(torch.int32), n_rows)
    fcnt, feng = K.hist_refine_tiled(y, block_cc)
    fcnt_p, feng_p = K.hist_refine_tiled_plain(y, block_cc)
    if not torch.equal(fcnt, fcnt_p):
        raise AssertionError(f"{label} refine counts differ")
    torch.testing.assert_close(feng, feng_p, rtol=1e-5, atol=0.0)
    t_leaf = ref.select_fine(ops._segment_rows(feng, bounds), c, cc, base,
                             budget)
    t = torch.repeat_interleave(t_leaf, n_rows)
    q, s = K.threshold_quant(y, t)
    q_p, s_p = K.threshold_quant_plain(y, t)
    if not (torch.equal(q, q_p) and torch.equal(s, s_p)):
        raise AssertionError(f"{label} q/scale differ from the plain version")
    err_q = max((q.int() - q_p.int()).abs().max().item(),
                (s - s_p).abs().max().item())
    x = K.dequant_idct(q, s)
    x_p = K.dequant_idct_plain(q, s)
    err_x = _check_close(f"{label} dequant_idct", x, x_p,
                         ref.dequantize_blocks(q, s))
    # the all-plain path's per-leaf thresholds (cuBLAS y, plain histograms)
    a_p = torch.abs(y_p)
    _, eng_pp = K._tile_sums(a_p * a_p, torch.div(
        ref.bin_index(a_p), 16, rounding_mode="floor"), 32, 8)
    del a_p
    c2, cc2, b2, bu2 = ref.select_coarse(ops._segment_rows(eng_pp, bounds),
                                         eps)
    _, feng_pp = K.hist_refine_tiled_plain(
        y_p, torch.repeat_interleave(cc2.to(torch.int32), n_rows))
    t_plain = ref.select_fine(ops._segment_rows(feng_pp, bounds), c2, cc2,
                              b2, bu2)
    differ = int((t_plain != t_leaf).sum())
    return {"y": y, "t": t, "q": q, "s": s, "t_leaf": t_leaf,
            "err": {"dct_hist_coarse_tiled": err_y,
                    "hist_refine_tiled": (feng - feng_p).abs().max().item(),
                    "threshold_quant": err_q, "energy_rel": err_e,
                    "dequant_idct": err_x},
            "thresholds_differing": differ, "leaves": len(rows),
            "dropped_all": bool((q == 0).all().item())}


def spectral_phase() -> dict:
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = moment_rows(cfg)
    nb = sum(rows)
    log(f"spectral main shape: {len(rows)} moment leaves, {sum(sizes)} "
        f"elements, {nb} blocks ({nb * 1024 / 1e9:.3f} GB f32)")
    xb = _spectral_payload(gen, sizes, rows, dev)
    main = spectral_check(xb, rows, EPS, "main")
    log(f"spectral main: max err y {main['err']['dct_hist_coarse_tiled']:.3e}"
        f", energy rel {main['err']['energy_rel']:.3e}, x "
        f"{main['err']['dequant_idct']:.3e}; per-leaf thresholds differing "
        f"kernel vs plain path: {main['thresholds_differing']} of "
        f"{main['leaves']}")

    # edge shapes: a block count no CTA multiple, zero blocks, subnormal
    # energies, eps >= 1 (drop everything)
    edge_rows = [8, 16, 1000, 24]            # 1048 blocks: 16 CTAs + 24 rows
    edge_sizes = [8 * 256 - 5, 16 * 256, 1000 * 256 - 100, 17 * 256]
    edges = {}
    for kind, eps in (("moments", EPS), ("zeros", EPS), ("tiny", EPS),
                      ("moments", 1.5)):
        xe = _spectral_payload(gen, edge_sizes, edge_rows, dev, kind)
        res = spectral_check(xe, edge_rows, eps, f"edge {kind} eps {eps}")
        if eps >= 1 and not res["dropped_all"]:
            raise AssertionError("eps >= 1 kept coefficients")
        edges[f"{kind}/eps={eps}"] = {
            "err": res["err"], "thresholds_differing":
                res["thresholds_differing"]}
        log(f"spectral edge {kind} eps {eps}: max err {res['err']}, "
            f"thresholds differing {res['thresholds_differing']}")
    # quantiser and inverse at a block count that is no tile multiple
    yo = torch.randn((1001, 256), generator=gen, device=dev)
    yo[::7] = 0
    to = torch.rand(1001, generator=gen, device=dev)
    qo, so = K.threshold_quant(yo, to)
    if not (torch.equal(qo, K.threshold_quant_plain(yo, to)[0])
            and torch.equal(so, K.threshold_quant_plain(yo, to)[1])):
        raise AssertionError("threshold_quant differs at 1001 blocks")
    _check_close("dequant_idct 1001", K.dequant_idct(qo, so),
                 K.dequant_idct_plain(qo, so), ref.dequantize_blocks(qo, so))

    # timings at the main shape
    y, t, q, s = main["y"], main["t"], main["q"], main["s"]
    block_cc = torch.full((nb,), 20, dtype=torch.int32, device=dev)
    dt_ = ref.dct_tensor(dev).T.contiguous()
    d_ = ref.dct_tensor(dev)
    yq = ref.dequantize_blocks(q, s)
    calls = {
        "dct_hist_coarse_tiled": (
            lambda: K.dct_hist_coarse_tiled(xb),
            lambda: K.dct_hist_coarse_tiled_plain(xb),
            lambda: torch.matmul(xb, dt_), "dct_coarse_tiled_kernel"),
        "hist_refine_tiled": (
            lambda: K.hist_refine_tiled(y, block_cc),
            lambda: K.hist_refine_tiled_plain(y, block_cc), None,
            "hist_refine_kernel"),
        "threshold_quant": (
            lambda: K.threshold_quant(y, t),
            lambda: K.threshold_quant_plain(y, t), None,
            "threshold_quant_kernel"),
        "dequant_idct": (
            lambda: K.dequant_idct(q, s),
            lambda: K.dequant_idct_plain(q, s),
            lambda: torch.matmul(yq, d_), "dequant_idct_kernel"),
    }
    bounds = {
        "dct_hist_coarse_tiled": bound_ms("dct_hist_coarse_tiled", xb),
        "hist_refine_tiled": bound_ms("hist_refine_tiled", y, block_cc),
        "threshold_quant": bound_ms("threshold_quant", y, t),
        "dequant_idct": bound_ms("dequant_idct", q, s),
    }
    timing = {}
    for name, (kern, plain, lib, sym) in calls.items():
        k_ms = time_ms(kern, warmup=2, samples=5, reps=3)
        p_ms = time_ms(plain, warmup=1, samples=3, reps=1)
        l_ms = (time_ms(lib, warmup=2, samples=5, reps=3)
                if lib is not None else None)
        dev_ms, _ = kernel_device_ms(kern, (sym,))
        b_ms, b_by = bounds[name]
        timing[name] = {"ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                        "library_ms": l_ms, "bound_ms": b_ms,
                        "bound_by": b_by}
        log(f"spectral {name}: kernel {k_ms:.4f} ms per call (device "
            f"{dev_ms} ms), plain {p_ms:.4f} ms, library {l_ms} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    out = {"blocks": nb, "elements": sum(sizes), "leaves": len(rows),
           "max_abs_err": {k: main["err"][k] for k in (
               "dct_hist_coarse_tiled", "hist_refine_tiled",
               "threshold_quant", "dequant_idct")},
           "energy_rel_err": main["err"]["energy_rel"],
           "thresholds_differing": main["thresholds_differing"],
           "edges": edges, "timing": timing}
    del main, xb, y, t, q, s, yq
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# single-tensor spectral kernel phase
# ---------------------------------------------------------------------------

def _leaf_payload(gen, n, dev, kind):
    """One leaf's values: moment-like (``mu`` ~ N(0, 1e-3), ``nu`` its
    square-ish) or an edge class."""
    import torch

    v = torch.randn(n, generator=gen, device=dev)
    if kind == "tiny":
        return v * 1e-20
    if kind == "sparse":
        return v * (torch.rand(n, generator=gen, device=dev) < 0.01)
    if kind == "nu":
        return (v * 1e-3) ** 2
    return v * 1e-3


def _rel_err(got, want):
    import torch

    return ((got - want).abs() / want.abs().clamp(min=1e-38)).max().item()


def single_tensor_check(x, eps, label):
    """``dct_hist_coarse`` and ``hist_refine`` against their plain versions
    on one leaf, the card's two-level thresholds against the CPU's flat
    ones, and ``spectral_compress`` on the card against the CPU's."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K

    xb = ops._pad_blocks(ref.blockize(x)[0], K.HIST_TILE)
    nb = xb.shape[0]
    y, cnt, eng = K.dct_hist_coarse(xb)
    y2, cnt2, eng2 = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    # kernel 6 is kernel 2's tile rows summed: y and counts bitwise, the
    # energies to rtol 1e-6 of the rows summed in f64 (each is a double sum
    # of the same f32 rows, in its own order, rounded once)
    if not torch.equal(y, y2):
        raise AssertionError(f"{label}: dct_hist_coarse y is not "
                             f"dct_hist_coarse_tiled's")
    cnt_s, eng_s = K._sum_rows(cnt2, eng2)
    del y2, cnt2, eng2
    if not torch.equal(cnt, cnt_s):
        raise AssertionError(f"{label}: dct_hist_coarse counts are not "
                             f"dct_hist_coarse_tiled's rows summed")
    torch.testing.assert_close(eng, eng_s, rtol=1e-6, atol=0.0)
    y_p = ref.dct_blocks(xb)
    err_y = _check_close(f"{label} dct y", y, y_p, y_p)
    del y_p
    a = torch.abs(y)
    coarse = torch.div(ref.bin_index(a), 16, rounding_mode="floor")
    cnt_p, eng_p = K._sum_rows(*K._tile_sums(a * a, coarse, 32, 8))
    del a, coarse
    if not torch.equal(cnt, cnt_p):
        raise AssertionError(f"{label} dct_hist_coarse counts differ: "
                             f"{cnt.tolist()} vs {cnt_p.tolist()}")
    torch.testing.assert_close(eng, eng_p, rtol=1e-5, atol=0.0)
    c, cc, base, budget = ref.select_coarse(eng, eps)
    fcnt, feng = K.hist_refine(y, cc)
    fcnt_p, feng_p = K.hist_refine_plain(
        y, K._per_block(cc, nb, torch.int32, y.device))
    if not torch.equal(fcnt, fcnt_p):
        raise AssertionError(f"{label} hist_refine counts differ")
    torch.testing.assert_close(feng, feng_p, rtol=1e-5, atol=0.0)
    t = ref.select_fine(feng, c, cc, base, budget)
    # the CPU's route on the same leaf: the flat selector, the CPU product
    x_cpu = x.cpu()
    y_cpu, t_cpu = ops.select_flat(xb.cpu(), eps)
    y_differ = int((y.cpu() != y_cpu).sum())
    del y_cpu
    thresholds_differ = int(not torch.equal(t.cpu(), t_cpu))
    if thresholds_differ:
        raise AssertionError(f"{label}: card threshold {t.item()!r} != CPU "
                             f"flat threshold {t_cpu.item()!r}")
    card = ops.spectral_compress(x, eps)
    cpu = ops.spectral_compress(x_cpu, eps)
    if not (torch.equal(card.q.cpu(), cpu.q)
            and torch.equal(card.scale.cpu(), cpu.scale)):
        raise AssertionError(
            f"{label}: spectral_compress on the card differs from the CPU's "
            f"(q {int((card.q.cpu() != cpu.q).sum())}, scale "
            f"{int((card.scale.cpu() != cpu.scale).sum())} differing)")
    return {"blocks": nb, "err_y": err_y,
            "energy_rel": _rel_err(eng, eng_p),
            "rows_energy_rel": _rel_err(eng, eng_s),
            "refine_energy_rel": _rel_err(feng, feng_p),
            "refine_abs_err": (feng - feng_p).abs().max().item(),
            "y_differing_vs_cpu": y_differ,
            "thresholds_differing": thresholds_differ,
            "dropped_all": bool((card.q == 0).all().item()),
            "xb": xb, "y": y, "cc": cc}


def refine_gates(y, cc) -> dict:
    """``hist_refine``'s membership table against ``bin_index`` over all
    2^31 non-negative f32 patterns (0 decided differently), and its bits:
    the same over 5 calls, and from two calls at once on two worker
    threads, each on its own stream."""
    import threading

    import torch
    from repro_torch.kernels import spectral_lossy as K

    dev = y.device
    t0 = time.perf_counter()
    bad = K.refine_table_errors(dev)
    check_s = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"hist_refine: the membership table decides "
                             f"{bad} of 2^31 patterns differently from "
                             f"bin_index")
    bits = lambda: torch.cat(K.hist_refine(y, cc)).view(torch.int32)  # noqa: E731
    first = bits().clone()
    for i in range(4):
        if not torch.equal(bits(), first):
            raise AssertionError(f"hist_refine: call {i + 2} gave other bits")
    outs, errors = [None, None], []
    streams = [torch.cuda.Stream(dev) for _ in outs]
    main = torch.cuda.current_stream(dev)
    for s in streams:
        s.wait_stream(main)

    def work(i):
        try:
            with torch.cuda.stream(streams[i]):
                outs[i] = bits().clone()
            streams[i].synchronize()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    if not all(torch.equal(o.to(first.device), first) for o in outs):
        raise AssertionError("hist_refine: two worker streams gave other bits")
    table = (K._refine_table(dev).cpu().long() & 0xFFFFFFFF).view(2, -1)
    return {"table_patterns_off": bad, "table_check_s": check_s,
            "same_bits_calls": 5, "same_bits_streams": 2,
            "table_lo": table[0].tolist(), "table_hi": table[1].tolist()}


def single_tensor_phase() -> dict:
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = moment_rows(cfg)
    leaves, per_save = {}, {"dct_hist_coarse": {}, "hist_refine": {}}
    embed = None
    for key, n in zip(keys, sizes):
        x = _leaf_payload(gen, n, dev, "nu" if key.startswith("['nu']")
                          else "mu")
        res = single_tensor_check(x, EPS, key)
        xb, y, cc = res.pop("xb"), res.pop("y"), res.pop("cc")
        nb = xb.shape[0]
        bounds = {"dct_hist_coarse": bound_ms("dct_hist_coarse", xb),
                  "hist_refine": bound_ms("hist_refine", y, cc)}
        block_cc = K._per_block(cc, nb, torch.int32, dev).contiguous()
        calls = {
            "dct_hist_coarse": (lambda: K.dct_hist_coarse(xb),
                                lambda: K.dct_hist_coarse_plain(xb)),
            "hist_refine": (lambda: K.hist_refine(y, cc),
                            lambda: K.hist_refine_plain(y, block_cc)),
        }
        for name, (kern, plain) in calls.items():
            row = per_save[name]
            row["ms"] = row.get("ms", 0.0) + time_ms(kern, warmup=2,
                                                     samples=3, reps=3)
            row["plain_ms"] = row.get("plain_ms", 0.0) + time_ms(
                plain, warmup=1, samples=3, reps=1)
            row["bound_ms"] = row.get("bound_ms", 0.0) + bounds[name][0]
        leaves[key] = res
        log(f"single {key}: {nb} blocks, max err y {res['err_y']:.3e}, "
            f"energy rel {res['energy_rel']:.3e} / refine "
            f"{res['refine_energy_rel']:.3e}, y differing vs CPU "
            f"{res['y_differing_vs_cpu']}, thresholds differing "
            f"{res['thresholds_differing']}")
        if key == "['mu']['embed']['embedding']":
            embed = (xb, y, cc, block_cc, bounds)
        else:
            del xb, y
    # edge shapes
    edges = {}
    for label, n, kind in (("8 blocks", 8 * 256, "mu"),
                           ("1001 blocks", 1001 * 256 - 5, "mu"),
                           ("1e-20", 1001 * 256 - 5, "tiny"),
                           ("1% sparse", 1001 * 256 - 5, "sparse")):
        x = _leaf_payload(gen, n, dev, kind)
        res = single_tensor_check(x, EPS, f"edge {label}")
        for k in ("xb", "y", "cc"):
            res.pop(k)
        edges[label] = res
        log(f"single edge {label}: {res}")

    # the refine kernel's membership table and its bits (gates)
    xb, y, cc, block_cc, bounds = embed
    refine_bits = refine_gates(y, cc)
    log(f"single hist_refine gates: {refine_bits}")

    # timings at the embed leaf (the main path's largest call)
    dt_ = ref.dct_tensor(dev).T.contiguous()
    calls = {
        "dct_hist_coarse": (lambda: K.dct_hist_coarse(xb),
                            lambda: K.dct_hist_coarse_plain(xb),
                            lambda: torch.matmul(xb, dt_),
                            ("dct_coarse_range_kernel",
                             "coarse_total_kernel")),
        "hist_refine": (lambda: K.hist_refine(y, cc),
                        lambda: K.hist_refine_plain(y, block_cc), None,
                        ("refine_range_kernel", "refine_total_kernel")),
    }
    timing = {}
    for name, (kern, plain, lib, syms) in calls.items():
        k_ms = time_ms(kern, warmup=2, samples=5, reps=3)
        p_ms = time_ms(plain, warmup=1, samples=3, reps=1)
        l_ms = (time_ms(lib, warmup=2, samples=5, reps=3)
                if lib is not None else None)
        dev_ms, dev_ops = kernel_device_ms(kern, syms)
        b_ms, b_by = bounds[name]
        timing[name] = {"ms": k_ms, "device_ms": dev_ms,
                        "device_ops": dev_ops, "plain_ms": p_ms,
                        "library_ms": l_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "per_save": per_save[name]}
        log(f"single {name} at embed ({xb.shape[0]} blocks): kernel "
            f"{k_ms:.4f} ms per call (device {dev_ops}), plain {p_ms:.4f} "
            f"ms, library {l_ms} ms, bound {b_ms:.4f} ms ({b_by}); summed "
            f"over one save's 22 leaves: {per_save[name]}")
    out = {"leaves": leaves, "edges": edges, "timing": timing,
           "embed_blocks": xb.shape[0], "refine_gates": refine_bits,
           "max_abs_err": {
               "dct_hist_coarse": max(r["err_y"] for r in leaves.values()),
               "hist_refine": max(r["refine_abs_err"]
                                  for r in leaves.values())},
           "thresholds_differing": sum(r["thresholds_differing"]
                                       for r in leaves.values())}
    del embed, xb, y
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# roofline phase
# ---------------------------------------------------------------------------

def _flat_counts_gate(label, cnt, cnt_p, a, bins):
    """The flat kernel's counts against the plain version's: equal, except
    that an element on a bin edge, where the kernel's log2f and
    ``ref.bin_index`` could round apart, may sit one bin over. Such moves
    are counted, printed, and allowed up to the edge elements found (in
    f64, within 1e-4 of a bin's width from an edge)."""
    import torch
    from repro_torch.kernels import ref

    if torch.equal(cnt, cnt_p):
        return 0
    moved = int((cnt - cnt_p).abs().sum().item()) // 2
    pos = (torch.log2(a.double().clamp(min=1e-38)) - ref.LOG2_LO
           ) * ref._BIN_SCALE
    edge = (a > 0) & ((pos - pos.round()).abs() < 1e-4)
    log(f"{label}: {moved} elements in another flat bin than ref.bin_index "
        f"puts them; {int(edge.sum())} elements sit on a bin edge: "
        f"{a[edge][:8].tolist()} (bins {bins[edge][:8].tolist()})")
    if moved > int(edge.sum()):
        raise AssertionError(f"{label}: flat counts differ from the plain "
                             f"version's beyond the bin-edge elements")
    return moved


def flat_check(xb, label):
    """The flat pair against its plain version and the two-level kernels
    on one input (see the module docstring, phase 6)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import spectral_lossy as K

    y8, cnt8, eng8 = K.dct_hist_tiled(xb)
    y9, cnt9, eng9 = K.dct_hist(xb)
    y2, cnt2, _ = K.dct_hist_coarse_tiled(xb)
    torch.cuda.synchronize()
    if not (torch.equal(y8, y2) and torch.equal(y9, y2)):
        raise AssertionError(f"{label}: the flat pair's y is not the coarse "
                             f"kernel's")
    y_p = ref.dct_blocks(xb)
    err_y = _check_close(f"{label} flat y", y8, y_p, y_p)
    del y_p
    a = torch.abs(y8)
    bins = ref.bin_index(a)
    cnt_p, eng_p = K._tile_sums(a * a, bins, ref.NBINS, K.HIST_TILE)
    moved = _flat_counts_gate(label, cnt8, cnt_p, a, bins)
    same = cnt8 == cnt_p
    torch.testing.assert_close(eng8[same], eng_p[same], rtol=1e-5, atol=0.0)
    del a, bins
    cnt_s, eng_s = K._sum_rows(cnt8, eng8)
    if not torch.equal(cnt9, cnt_s):
        raise AssertionError(f"{label}: dct_hist counts are not its tile "
                             f"rows summed")
    torch.testing.assert_close(eng9, eng_s, rtol=1e-6, atol=0.0)
    n_tiles = cnt8.shape[0]
    if not torch.equal(cnt8.view(n_tiles, ref.NBINS_COARSE,
                                 ref.NBINS_FINE).sum(-1), cnt2):
        raise AssertionError(f"{label}: 16 flat bins differ from their "
                             f"coarse bin")
    c_tile = cnt2.argmax(1).to(torch.int32)
    fcnt, _ = K.hist_refine_tiled(y8, c_tile.repeat_interleave(K.HIST_TILE))
    idx = (c_tile[:, None].long() * ref.NBINS_FINE
           + torch.arange(ref.NBINS_FINE, device=xb.device))
    if not torch.equal(cnt8.gather(1, idx), fcnt):
        raise AssertionError(f"{label}: flat bins inside a coarse bin differ "
                             f"from the refine kernel's counts")
    y6, _, ce = K.dct_hist_coarse(xb)
    if not torch.equal(y6, y2):
        raise AssertionError(f"{label}: dct_hist_coarse y is not "
                             f"dct_hist_coarse_tiled's")
    thresholds = {}
    for eps in FLAT_EPS:
        c, cc, base, budget = ref.select_coarse(ce, eps)
        _, fe = K.hist_refine(y6, cc)
        t_two = ref.select_fine(fe, c, cc, base, budget)
        t_flat = ref.threshold_from_histogram(eng9, eps)
        if not torch.equal(t_two, t_flat):
            raise AssertionError(f"{label} eps {eps}: flat threshold "
                                 f"{t_flat.item()!r} != two-level "
                                 f"{t_two.item()!r}")
        thresholds[eps] = t_flat.item()
    return {"blocks": xb.shape[0], "err_y": err_y,
            "energy_rel": _rel_err(eng8[same], eng_p[same]),
            "single_energy_rel": _rel_err(eng9, eng_s),
            "moved": moved, "thresholds": thresholds}


def _serve_shape(table_width: int) -> dict:
    return dict(b=8, hq=9, n_kv=3, d=64, ps=SERVE["page_size"],
                pps=table_width)


def _in_turns(a, b) -> tuple[float, float]:
    """Per-call ms of two callables timed in turns (a, b, b, a)."""
    ta = [time_ms(a, warmup=2, samples=5, reps=3)]
    tb = [time_ms(b, warmup=2, samples=5, reps=3) for _ in range(2)]
    ta.append(time_ms(a, warmup=2, samples=5, reps=3))
    return statistics.mean(ta), statistics.mean(tb)


def roofline_phase(serve_table_width: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.roofline.kernels import kernel_report

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    cfg = configs.get("smollm-135m")
    keys, sizes, rows = moment_rows(cfg)
    n_embed = sizes[keys.index("['mu']['embed']['embedding']")]

    # 1. the flat pair against its plain version and the two-level kernels
    checks = {}
    edge_rows = [8, 16, 1000, 24]
    edge_sizes = [8 * 256 - 5, 16 * 256, 1000 * 256 - 100, 17 * 256]
    for kind in ("moments", "zeros", "tiny"):
        checks[f"edge {kind}"] = flat_check(
            _spectral_payload(gen, edge_sizes, edge_rows, dev, kind),
            f"flat edge {kind}")
    bench = {}
    for nb in (256, 4096):              # benchmarks/kernel_roofline.py
        bench[nb] = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (nb, ref.BLOCK)).astype(np.float32)).to(dev)
        checks[f"kernel_roofline {nb}"] = flat_check(bench[nb],
                                                     f"flat {nb} blocks")
    for kind in ("mu", "nu", "tiny", "sparse"):
        x = _leaf_payload(gen, n_embed, dev, kind)
        xe = ops._pad_blocks(ref.blockize(x)[0], K.HIST_TILE)
        checks[f"embed {kind}"] = flat_check(xe, f"flat embed {kind}")
    for label, res in checks.items():
        log(f"flat {label}: {res}")
    xe = ops._pad_blocks(ref.blockize(_leaf_payload(gen, n_embed, dev, "mu")
                                      )[0], K.HIST_TILE)

    # 2. every kernel on the roofline, counted from a fresh start
    xb = _spectral_payload(gen, sizes, rows, dev)
    checks["packed"] = flat_check(xb, "flat packed")
    log(f"flat packed: {checks['packed']}")
    nb = xb.shape[0]
    y = K.dct_hist_coarse_tiled(xb)[0]
    block_cc = torch.full((nb,), 20, dtype=torch.int32, device=dev)
    t = torch.full((nb,), 1e-4, dtype=torch.float32, device=dev)
    q, s = K.threshold_quant(y, t)
    ye, _, ce = K.dct_hist_coarse(xe)
    cc_e = ref.select_coarse(ce, EPS)[1]
    gen_cpu = torch.Generator().manual_seed(1234)
    shp = _serve_shape(serve_table_width)
    full = shp["ps"] * shp["pps"]
    paged = _paged_case(gen_cpu, lengths=[full] * shp["b"],
                        dtype=torch.bfloat16, dev=dev, **shp)
    cases = [
        ("paged_decode_attention", "serve", PK.paged_decode_attention, paged),
        ("dct_hist_coarse_tiled", "packed", K.dct_hist_coarse_tiled, (xb,)),
        ("hist_refine_tiled", "packed", K.hist_refine_tiled, (y, block_cc)),
        ("threshold_quant", "packed", K.threshold_quant, (y, t)),
        ("dequant_idct", "packed", K.dequant_idct, (q, s)),
        ("dct_hist_coarse", "embed", K.dct_hist_coarse, (xe,)),
        ("hist_refine", "embed", K.hist_refine, (ye, cc_e)),
        ("dct_hist_tiled", "packed", K.dct_hist_tiled, (xb,)),
        ("dct_hist", "packed", K.dct_hist, (xb,)),
        ("dct_hist_tiled", "4096", K.dct_hist_tiled, (bench[4096],)),
        ("dct_hist", "4096", K.dct_hist, (bench[4096],)),
        ("dct_hist", "embed", K.dct_hist, (xe,)),
    ]
    torch.cuda.synchronize()
    K.reset_launches()
    PK.paged_decode_attention.launches = 0
    reports = []
    for name, shape, fn, args in cases:
        rep = kernel_report(fn, args, name=name, measure=True,
                            iters=ROOFLINE_ITERS)
        reports.append({"shape": shape, **rep.to_dict()})
        log(json.dumps({"roofline": reports[-1]}))
    launches = {k.__name__: k.launches for k in K.KERNELS}
    launches["paged_decode_attention"] = PK.paged_decode_attention.launches
    for name, _, _, _ in cases:
        want = (1 + ROOFLINE_ITERS) * sum(c[0] == name for c in cases)
        assert launches[name] == want, (name, launches)
    log(f"roofline launches: {launches}")

    # 3. the flat pair's reports beside its device time, its plain
    #    version and the library product, and against the two-level pair
    dt_ = ref.dct_tensor(dev).T.contiguous()
    placed = {(r["name"], r["shape"]): r for r in reports}
    timing = {}
    for name, fn, syms in (
            ("dct_hist_tiled", K.dct_hist_tiled, ("dct_flat_tiled_kernel",)),
            ("dct_hist", K.dct_hist, ("dct_flat_range_kernel",
                                      "flat_total_kernel"))):
        plain = getattr(K, f"{name}_plain")
        shapes = {"packed": xb, "4096": bench[4096]}
        if name == "dct_hist":
            shapes["embed"] = xe
        for label, x in shapes.items():
            rep = placed[name, label]
            k_ms = rep["measured_s"] * 1e3
            b_ms = rep["roofline_s"] * 1e3
            b_by = "operations" if rep["bound"] == "compute" else "bytes"
            p_ms = time_ms(lambda: plain(x), warmup=1, samples=3, reps=1)
            l_ms = time_ms(lambda: torch.matmul(x, dt_), warmup=2, samples=5,
                           reps=3)
            # a 0.04 ms launch at 4096 blocks went unrecorded in a 3-call
            # window: the short shape gets a window of 20 calls
            dev_ms, dev_ops = kernel_device_ms(
                lambda: fn(x), syms, n=20 if label == "4096" else 3)
            timing.setdefault(name, {})[label] = {
                "blocks": x.shape[0], "ms": k_ms, "device_ms": dev_ms,
                "device_ops": dev_ops, "plain_ms": p_ms, "library_ms": l_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"roofline {name} at {label} ({x.shape[0]} blocks): kernel "
                f"{k_ms:.4f} ms per call (device {dev_ops}), plain "
                f"{p_ms:.4f} ms, torch.matmul {l_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
    flat_e, two_e = _in_turns(
        lambda: K.dct_hist(xe),
        lambda: (K.dct_hist_coarse(xe), K.hist_refine(ye, cc_e)))
    flat_p, two_p = _in_turns(
        lambda: K.dct_hist_tiled(xb),
        lambda: (K.dct_hist_coarse_tiled(xb),
                 K.hist_refine_tiled(y, block_cc)))
    ratios = {"embed": {"flat_ms": flat_e, "two_level_ms": two_e,
                        "flat_over_two_level": flat_e / two_e,
                        "kernels": "dct_hist vs dct_hist_coarse + "
                                   "hist_refine"},
              "packed": {"flat_ms": flat_p, "two_level_ms": two_p,
                         "flat_over_two_level": flat_p / two_p,
                         "kernels": "dct_hist_tiled vs dct_hist_coarse_tiled"
                                    " + hist_refine_tiled"}}
    log(f"flat / two-level on the card (per call, timed in turns): embed "
        f"{flat_e:.4f} / {two_e:.4f} ms = {flat_e / two_e:.3f}x; packed "
        f"{flat_p:.4f} / {two_p:.4f} ms = {flat_p / two_p:.3f}x")
    out = {"checks": checks, "reports": reports, "launches": launches,
           "timing": timing, "ratios": ratios,
           "max_abs_err": max(r["err_y"] for r in checks.values())}
    del xb, y, q, s, t, xe, ye, bench
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def _serve_wall_s(run: dict) -> float:
    """The serve loop's wall seconds (its tokens over its tok/s)."""
    return sum(len(r.out) for r in run["requests"]) / run["tok_per_s"]


def serve_phase(chain_dir: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.core.session import (Every, InSituPlan, Placement,
                                          TaskSpec)
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.launch.serve import default_serve_plan, serve_loop
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serving import snapshot as S
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine, make_paged_decode

    cfg = configs.get("smollm-135m")
    eager_dir = chain_dir.with_name(chain_dir.name + "_eager")
    for d in (chain_dir, eager_dir):
        if d.exists():
            shutil.rmtree(d)

    def snapshot_plan(directory: Path, emitted: dict) -> InSituPlan:
        # the default plan, persisted on disk, plus a probe on the same
        # stream that keeps what was emitted at each firing (to check the
        # restore); the probe runs SYNC, a D2H copy on the loop every 4
        # steps, so that it never holds ring slots the snapshot task
        # competes for
        base = InSituPlan.from_dict(
            default_serve_plan(snapshot_dir=str(directory)))
        probe = TaskSpec(name="probe", stream="kv_pages", trigger=Every(4),
                         placement=Placement.SYNC,
                         sink=lambda step, p: emitted.__setitem__(
                             step, S._flatten(p["cache"])))
        return InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                          workers=base.workers,
                          staging_capacity=base.staging_capacity)

    lines: list[str] = []

    def serve_log(msg: str) -> None:
        lines.append(msg)
        log(f"serve: {msg}")

    # the same traffic four times: with no in-situ task bound (what the
    # snapshots cost; the first run also warms the full-width shapes up)
    # and with the snapshot plan, each stepping eagerly and replaying the
    # captured decode graph; all four must decode the same tokens
    runs = {}
    for graph in (False, True):
        runs["bare", graph] = serve_loop(
            "smollm-135m", smoke=False, device="cuda", seed=0,
            plan={"streams": ["kv_pages"]}, log=lambda _: None,
            cuda_graph=graph, **SERVE)
        assert all(r.done for r in runs["bare", graph]["requests"])
    emitted_eager: dict[int, dict] = {}
    runs["plan", False] = serve_loop(
        "smollm-135m", smoke=False, device="cuda", seed=0,
        plan=snapshot_plan(eager_dir, emitted_eager), cuda_graph=False,
        log=lambda m: log(f"serve (eager): {m}"), **SERVE)
    bare = runs["bare", True]

    emitted: dict[int, dict] = {}
    PK.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = serve_loop("smollm-135m", smoke=False, device="cuda",
                     plan=snapshot_plan(chain_dir, emitted), seed=0,
                     log=serve_log, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.paged_decode_attention.launches
    runs["plan", True] = out
    tok_s = {f"{'graph' if g else 'eager'}_{k}": r["tok_per_s"]
             for (k, g), r in runs.items()}
    log(f"serve: tok/s {tok_s}")
    for (k, g), r in runs.items():
        rep = r["session_report"]
        log(f"serve: {'graph' if g else 'eager'}_{k}: wall "
            f"{_serve_wall_s(r):.3f} s = admissions "
            f"{r['telemetry'].total('serve/admit'):.3f} + decode "
            f"steps {rep['step_compute_s']:.3f} + hand-off dispatch "
            f"{rep['handoff_dispatch_s']:.3f} + sync stall "
            f"{rep['sync_stall_s']:.3f} + the rest")
    streams = {key: [r.out for r in run["requests"]]
               for key, run in runs.items()}
    for key, got in streams.items():
        assert got == streams["plan", True], (
            f"serve run {key} decoded other tokens than the graphed run "
            f"with snapshots")
    log(f"serve: the four runs decode the same {SERVE['n_requests']} token "
        f"streams ({sum(map(len, streams['plan', True]))} tokens)")

    reqs = out["requests"]
    decode_steps = len(out["telemetry"].spans("step/compute"))
    served = sum(1 for r in reqs if r.done)
    assert served == SERVE["n_requests"], f"served {served}/{len(reqs)}"
    for r in reqs:
        assert len(r.out) == r.max_new, f"request {r.rid}: {len(r.out)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in r.out), r.rid
    pool = next(m for m in (re.match(r"page pool: (\d+)/(\d+)", ln)
                            for ln in lines) if m)
    assert int(pool.group(1)) == 0, f"page pool not empty at exit: {pool[0]}"
    rep = out["session_report"]
    snap = rep["tasks"]["kv_snapshot"]
    assert rep["n_errors"] == 0, rep["errors"]
    assert snap["publishes"] > 0, "no snapshot published"
    assert launches == decode_steps * cfg.n_layers, (
        f"kernel launches {launches} != {decode_steps} decode steps x "
        f"{cfg.n_layers} layers")

    for directory, kept in ((chain_dir, emitted), (eager_dir, emitted_eager)):
        store = S.SnapshotStore(str(directory))
        step, leaves = store.restore("kv_pages")
        want = kept[step]
        assert list(leaves) == list(want), "restored leaf keys differ"
        for key, arr in leaves.items():
            assert arr.shape == want[key].shape, key
            if not np.array_equal(arr.reshape(-1).view(np.uint8),
                                  want[key].reshape(-1).view(np.uint8)):
                raise AssertionError(f"{directory.name}: restored leaf {key} "
                                     f"differs at step {step}")
        log(f"serve: {directory.name} restores bit-identically to the "
            f"payload emitted at step {step} ({len(leaves)} leaves, "
            f"{sum(a.nbytes for a in leaves.values())} bytes)")

    # a graphed engine and an eager one from one state: 8 full-width
    # steps whose logits must be the same bits
    params = P.materialize(torch.Generator().manual_seed(0),
                           transformer.param_spec(cfg), "cuda")
    engines = {}
    for graph in (True, False):
        e = engines[graph] = PagedServingEngine(
            cfg, params, num_pages=33, page_size=16, max_reqs=8,
            prompt_len=16, max_len=64, device="cuda", cuda_graph=graph)
        rng = np.random.default_rng(5)
        for i in range(8):
            assert e.admit(Request(i, rng.integers(0, cfg.vocab_size, 16),
                                   max_new=32))
    eng, eng_eager = engines[True], engines[False]
    for _ in range(8):
        eng.step()
        eng_eager.step()
        if not torch.equal(eng.logits, eng_eager.logits):
            raise AssertionError("graphed and eager decode logits differ")
    log("serve: 8 full-width decode steps (8 rows), graph replay and eager "
        "step: logits bitwise equal")

    # one full-width decode step from one state, kernel vs plain version

    def one_step(decode):
        pool = tree_map(lambda t: t.clone(), eng.pool)
        logits, *_ = decode(eng.params, pool, eng.state,
                            eng.page_table.clone(), eng.tokens.clone(),
                            eng.lengths.clone())
        return logits[:, -1, :cfg.vocab_size].float()

    with_kernel = one_step(make_paged_decode(cfg, 16))
    with_plain = one_step(make_paged_decode(
        cfg, 16, attend=PK.paged_decode_attention_plain))
    diff = (with_kernel - with_plain).abs().max().item()
    agree = (with_kernel.argmax(-1) == with_plain.argmax(-1)).float().mean()
    torch.testing.assert_close(with_kernel, with_plain, rtol=0.0,
                               atol=LOGIT_ATOL)
    log(f"serve: one full-width decode step, kernel vs plain attention: "
        f"max |dlogit| = {diff:.4e} (logit range "
        f"{with_plain.min().item():.3f}..{with_plain.max().item():.3f}), "
        f"argmax agreement {agree.item():.3f}")

    # where a full-width decode step's time goes (8 active rows, no
    # in-situ work): host wall per step against device busy time, graph
    # replay beside the eager step
    profiles = {}
    for name, e in (("graph", eng), ("eager", eng_eager)):
        decode = profiles[name] = device_profile(e.step, 10)
        decode["wall_ms_unprofiled"] = host_wall_ms(e.step, 10)
        decode["device_idle_share_unprofiled"] = (
            1 - decode["device_busy_ms"] / decode["wall_ms_unprofiled"])
        log(f"serve: decode step ({name}, 8 rows, full width): "
            f"{decode['wall_ms']:.2f} ms wall under the profiler, "
            f"{decode['wall_ms_unprofiled']:.3f} without, "
            f"{decode['host_aten_ops']:.0f} aten ops on the host, device "
            f"busy {decode['device_busy_ms']} ms, idle share "
            f"{decode['device_idle_share']} "
            f"({decode['device_idle_share_unprofiled']} of the wall "
            f"without the profiler)")
        for op, ms in decode["top"]:
            log(f"serve:   {ms * 1e3:9.1f} us/step  {op[:90]}")
        decode["paged_launches_recorded"] = sum(
            c for op, c in decode["launches"].items()
            if "paged_decode_kernel" in op)
        log(f"serve: the profiler recorded "
            f"{decode['paged_launches_recorded']} paged-attention launches "
            f"of the {10 * cfg.n_layers} that ran")
    decode = profiles["graph"]
    loop = {k: rep[k] for k in ("step_compute_s", "handoff_dispatch_s",
                                "handoff_materialize_s", "sync_stall_s",
                                "staging_backpressure_s",
                                "async_overlapped_s")}

    return {"tok_per_s": out["tok_per_s"], "wall_s": wall,
            "tok_per_s_without_insitu": bare["tok_per_s"],
            "tok_per_s_by_run": tok_s,
            "step_compute_s_without_insitu":
                bare["session_report"]["step_compute_s"],
            "loop_by_run": {
                f"{'graph' if g else 'eager'}_{k}": {
                    "wall_s": _serve_wall_s(r),
                    "admit_s": r["telemetry"].total("serve/admit"),
                    **{m: r["session_report"][m] for m in (
                        "step_compute_s", "handoff_dispatch_s",
                        "sync_stall_s")}}
                for (k, g), r in runs.items()},
            "loop": loop, "decode_profile": decode,
            "decode_profile_eager": profiles["eager"],
            "requests": served, "decode_steps": decode_steps,
            "launches": launches, "snapshots": snap["publishes"],
            "snapshot_drops": rep["drops"].get("kv_snapshot", 0),
            "effective_compression_x": snap["effective_compression_x"],
            "logit_max_abs_diff": diff,
            "argmax_agreement": agree.item()}


# ---------------------------------------------------------------------------
# stream phase
# ---------------------------------------------------------------------------

@functools.cache
def _load_tool(name: str):
    """A module of ``tools/`` by path (the tools are scripts, not a
    package), loaded once."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _family_tool():
    """``tools/torch_family_train.py``: the one definition of the restore
    check (``check_restored``), the checkpoint's loop blocking
    (``ckpt_blocking_s``), the launch counts (``launches`` /
    ``reset_launches``) and the depth cuts (``config_as``) every phase
    uses."""
    return _load_tool("torch_family_train")


def _sha256(path: Path) -> str:
    import hashlib

    return hashlib.sha256(path.read_bytes()).hexdigest()


def stream_phase(build: Path) -> dict:
    import threading

    import numpy as np
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.configs import base as configs
    from repro_torch.core import pytree, transport
    from repro_torch.core.session import (InSituPlan, Placement, TaskSpec,
                                          When)
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.launch import consume
    from repro_torch.launch import train as T
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.pages import PagedServingEngine

    cfg = configs.get("smollm-135m")
    result: dict = {}

    # 1. a cold replica in a child process hydrates from the live chain
    #    the graphed producer mirrors to it, and decodes in lockstep
    hs = _load_tool("torch_hydrate_smoke")
    PK.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out, res = hs.run_pair(device="cuda", full=True, seed=0, serve=SERVE,
                           log=lambda m: log(f"stream (hydrate): {m}"))
    pair_s = time.perf_counter() - t0
    producer_launches = PK.paged_decode_attention.launches
    failures = hs.check(out, res, device="cuda")
    assert not failures, failures
    decode_steps = len(out["telemetry"].spans("step/compute"))
    assert producer_launches == decode_steps * cfg.n_layers, (
        producer_launches, decode_steps)
    snap = out["session_report"]["tasks"]["kv_snapshot"]
    result["hydrate"] = {
        **{k: v for k, v in res.items() if k != "records"},
        "requests_compared": len(res["records"]),
        "tokens_compared": sum(len(r["tokens"]) for r in res["records"]),
        "producer_launches": producer_launches,
        "producer_decode_steps": decode_steps,
        "producer_tok_per_s": out["tok_per_s"],
        "mirror_frames": snap["mirror_frames"],
        "mirror_failures": snap["mirror_failures"],
        "mirror_mb": snap["transport"]["bytes"] / 1e6,
        "pair_wall_s": pair_s}
    h = result["hydrate"]
    log(f"stream: replica hydrated at step {h['step']} with "
        f"{h['active_requests']} in-flight requests from "
        f"{h['frames_ingested']} frames (then followed "
        f"{h['frames_followed']} more); its {h['steps']} graphed steps "
        f"decode the producer's {h['tokens_compared']} tokens exactly, no "
        f"prefill, buffers unmoved, {h['launches']} paged launches "
        f"(= {h['steps']} x {cfg.n_layers}); producer mirrored "
        f"{h['mirror_frames']} frames ({h['mirror_mb']:.2f} MB), "
        f"{h['mirror_failures']} failures")
    log(f"stream: ingest_s {h['ingest_s']:.4f}, restore_s (replay + "
        f"rebuild + capture) {h['restore_s']:.4f}, first replay "
        f"{h['first_replay_s'] * 1e3:.3f} ms, first token "
        f"{h['first_token_s']:.4f} s; warm: hydrate + step "
        f"{h['ttft_hydrate_s'] * 1e3:.3f} ms vs re-prefill + step "
        f"{h['ttft_reprefill_s'] * 1e3:.3f} ms")

    # 2. HYBRID checkpoints of the graphed train loop mirrored over tcp://
    #    to a consumer that steers the task to every=3 after its first
    #    frame. A SYNC hold on step 1 waits for that message, so the
    #    cadence change lands at a known step: saves at 0 (every=2), then
    #    3 (every=3) instead of 0, 2, 4.
    ck, consumed = build / "stream_ckpt", build / "stream_consumed"
    for d in (ck, consumed):
        if d.exists():
            shutil.rmtree(d)
    source = transport.StreamSource(port=0)
    crep: dict = {}
    consumer = threading.Thread(target=lambda: crep.update(
        consume.consume_loop(
            source, out_dir=str(consumed),
            steer=[{"task": "checkpoint", "every": 3}], idle_timeout_s=5.0,
            start_grace_s=600.0,      # the first save follows a capture
            log=lambda m: log(f"stream (consumer): {m}"))))
    t0 = time.perf_counter()
    consumer.start()
    sess: dict = {}
    emitted: dict = {}

    def hold(step, payload):
        deadline = time.monotonic() + 300
        while not sess["s"]._steering:
            assert time.monotonic() < deadline, "no steering arrived"
            sess["s"].poll_steering()
            time.sleep(0.005)

    def keep(step, payload):
        emitted["step"] = step
        emitted["state"] = {pytree.keystr(p): np.array(a) for p, a in
                            pytree.flatten_with_path(payload)}

    base = T.default_train_plan(insitu_mode="hybrid", ckpt_dir=str(ck),
                                ckpt_every=2, device="cuda")
    base["tasks"]["checkpoint"]["options"]["mirror"] = source.address
    base = InSituPlan.from_dict(base)
    plan = InSituPlan(
        streams=base.streams, workers=base.workers,
        staging_capacity=base.staging_capacity,
        tasks=[*base.tasks,
               TaskSpec(name="hold", stream="grads",
                        trigger=When(lambda st: st == 1),
                        placement=Placement.SYNC, sink=hold),
               TaskSpec(name="probe", stream="train_state",
                        trigger=When(lambda st: st == 3),
                        placement=Placement.SYNC, sink=keep)])
    K.reset_launches()
    run = T.train_loop("smollm-135m", smoke=False, steps=6, plan=plan,
                       device="cuda", seed=0,
                       on_session=lambda s: sess.update(s=s),
                       log=lambda m: log(f"stream (train): {m}"))
    torch.cuda.synchronize()
    consumer.join(120)
    source.close()
    mirror_wall = time.perf_counter() - t0
    assert not consumer.is_alive(), "the consumer did not drain"
    save_launches = {k.__name__: k.launches for k in K.KERNELS}
    rep = run["session_report"]
    assert rep["n_errors"] == 0, rep["errors"]
    assert np.isfinite(run["losses"]).all(), run["losses"]
    cmds = rep["steering"]["commands"]
    assert [c["applied"] for c in cmds] == [{"every": 3}], cmds
    assert rep["checkpoint"]["kept_steps"] == [0, 3], rep["checkpoint"]
    for name in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                 "threshold_quant"):
        assert save_launches[name] == 2, (name, save_launches)
    mstats = dict(sess["s"].checkpoint.mirror_stats)
    assert mstats["failures"] == 0 and mstats["steps"] == 2, mstats
    assert crep["errors"] == [] and crep["steering_sent"][0]["reached"] == 1
    n_files = 0
    for step in (0, 3):
        name = f"step_{step:09d}"
        mine = sorted(p.name for p in (ck / name).iterdir())
        assert sorted(p.name for p in (consumed / name).iterdir()) == mine
        for f in mine:
            assert _sha256(ck / name / f) == _sha256(consumed / name / f), f
            n_files += 1
    assert crep["by_codec"] == {"file": n_files}, crep["by_codec"]
    # the consumed copy of step 3 restores on the card: params bitwise as
    # emitted, moments within the codec's bound
    n_lossy = len(moment_rows(cfg)[2])
    template = T.init_state(cfg, 1, T.StepConfig().opt, device="cuda")
    K.reset_launches()
    t0 = time.perf_counter()
    restored = ser.read_state(str(consumed / "step_000000003"), template,
                              "cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = K.dequant_idct.launches
    assert restore_launches == n_lossy, (restore_launches, n_lossy)
    assert emitted.get("step") == 3, emitted.get("step")
    worst = _family_tool().check_restored(
        restored, emitted["state"], "consumed step 3")["worst_rel_l2"]
    del restored, template, emitted
    torch.cuda.empty_cache()
    result["mirror"] = {
        "losses": run["losses"], "steering": cmds,
        "kept_steps": rep["checkpoint"]["kept_steps"],
        "save_launches": save_launches, "restore_launches": restore_launches,
        "mirror_stats": mstats, "files": n_files,
        "frames": crep["frames"], "mb": crep["bytes"] / 1e6,
        "consumer_frames_per_s": crep["frames"] / mirror_wall,
        "wall_s": mirror_wall, "restore_s": restore_s,
        "moments_worst_rel_l2": worst}
    m = result["mirror"]
    log(f"stream: train loop (6 graphed HYBRID steps) mirrored "
        f"{m['frames']} checkpoint frames ({m['mb']:.1f} MB, "
        f"{m['consumer_frames_per_s']:.2f} frames/s over {mirror_wall:.1f} "
        f"s); steering {cmds[0]['applied']} applied, saves at "
        f"{m['kept_steps']}; consumed shards sha256-equal ({n_files} files); "
        f"restore of the consumed step 3 {restore_s:.2f} s, params bitwise, "
        f"moments worst rel L2 {worst:.4e}, {restore_launches} dequant_idct "
        f"launches; kernels 2-4 {save_launches['dct_hist_coarse_tiled']}/"
        f"{save_launches['hist_refine_tiled']}/"
        f"{save_launches['threshold_quant']}")

    # 3. the dense fixed-slot baseline against the paged engine: the same
    #    traffic, both graphed; then both engines' first decode step from
    #    the same admissions (the logit tolerance of the serve phase)
    runs = {}
    for kind in ("dense", "paged"):
        runs[kind] = serve_loop("smollm-135m", smoke=False, device="cuda",
                                seed=0, engine_kind=kind,
                                plan={"streams": ["kv_pages"]},
                                log=lambda _: None, **SERVE)
        assert all(r.done and len(r.out) == r.max_new
                   for r in runs[kind]["requests"]), kind
    pairs = list(zip(runs["dense"]["requests"], runs["paged"]["requests"]))
    equal = sum(a == b for ra, rb in pairs for a, b in zip(ra.out, rb.out))
    same_streams = sum(ra.out == rb.out for ra, rb in pairs)
    params = P.materialize(torch.Generator().manual_seed(0),
                           transformer.param_spec(cfg), "cuda")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 16) for _ in range(4)]
    dense = ServingEngine(cfg, params, slots=4, prompt_len=16, max_len=64,
                          device="cuda")
    paged = PagedServingEngine(cfg, params, num_pages=17, page_size=16,
                               max_reqs=4, prompt_len=16, max_len=64,
                               device="cuda")
    for e in (dense, paged):
        for i, pr in enumerate(prompts):
            assert e.admit(Request(i, pr, max_new=8))
        e.step()
    a = dense.logits[:, -1, :cfg.vocab_size].float()
    b = paged.logits[:, -1, :cfg.vocab_size].float()
    diff = (a - b).abs().max().item()
    torch.testing.assert_close(a, b, rtol=0.0, atol=LOGIT_ATOL)
    result["dense_vs_paged"] = {
        "tok_per_s": {k: r["tok_per_s"] for k, r in runs.items()},
        "equal_tokens": equal,
        "tokens": sum(len(r.out) for r in runs["dense"]["requests"]),
        "equal_streams": same_streams,
        "first_step_logit_max_abs_diff": diff,
        "first_step_argmax_agreement":
            (a.argmax(-1) == b.argmax(-1)).float().mean().item()}
    d = result["dense_vs_paged"]
    log(f"stream: dense vs paged, same traffic, both graphed: tok/s "
        f"{d['tok_per_s']['dense']:.1f} / {d['tok_per_s']['paged']:.1f}, "
        f"{d['equal_tokens']}/{d['tokens']} tokens equal "
        f"({d['equal_streams']}/{SERVE['n_requests']} whole streams); first "
        f"decode step max |dlogit| {diff:.4e}, argmax agreement "
        f"{d['first_step_argmax_agreement']:.3f}")
    del dense, paged, params
    torch.cuda.empty_cache()

    # 4. the same comparison in f32, gated token for token
    result["dense_vs_paged_f32"] = dense_vs_paged_f32(cfg)
    return result


def dense_vs_paged_f32(cfg) -> dict:
    """The serve traffic through the dense 4-slot engine and a 4-row paged
    engine, both graphed, from the same f32 weights: in f32 dense = paged
    must hold token for token, as the JAX package and the CPU test hold
    it (bf16 rounding flips near-tied greedy tokens; f32 must not)."""
    import numpy as np
    import torch
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.pages import PagedServingEngine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = P.cast_tree(P.materialize(torch.Generator().manual_seed(0),
                                         transformer.param_spec(cfg), "cuda"),
                           torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 16)
               for _ in range(SERVE["n_requests"])]
    streams32 = {}
    t0 = time.perf_counter()
    for kind in ("dense", "paged"):
        reqs = [Request(i, pr, max_new=SERVE["max_new"])
                for i, pr in enumerate(prompts)]
        if kind == "dense":
            eng = ServingEngine(cfg32, params32, slots=SERVE["slots"],
                                prompt_len=16, max_len=64, device="cuda")
        else:
            eng = PagedServingEngine(cfg32, params32,
                                     num_pages=SERVE["num_pages"],
                                     page_size=SERVE["page_size"],
                                     max_reqs=SERVE["slots"], prompt_len=16,
                                     max_len=64, device="cuda")
        assert eng._graph is not None, kind
        eng.run(reqs, max_steps=1024)
        assert all(r.done and len(r.out) == r.max_new for r in reqs), kind
        streams32[kind] = [r.out for r in reqs]
        del eng
    f32_s = time.perf_counter() - t0
    equal32 = sum(a == b for ra, rb in zip(streams32["dense"],
                                            streams32["paged"])
                  for a, b in zip(ra, rb))
    n32 = sum(len(r) for r in streams32["dense"])
    out = {
        "equal_tokens": equal32, "tokens": n32, "wall_s": f32_s,
        "equal_streams": sum(a == b for a, b in zip(streams32["dense"],
                                                    streams32["paged"]))}
    log(f"stream: dense vs paged in f32, both graphed: {equal32}/{n32} "
        f"tokens equal ({out['equal_streams']}/"
        f"{SERVE['n_requests']} streams) in {f32_s:.1f} s")
    assert streams32["dense"] == streams32["paged"], (
        "f32 dense and paged engines decoded different tokens")
    del params32
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def _per_step(report: dict, steps: int, tm=None) -> dict:
    """The loop's seconds from a session report; ``step_s`` is the mean
    step (the first, warming up, included), ``step_median_s`` the median
    of the ``step/compute`` spans of telemetry ``tm``."""
    keys = ("step_compute_s", "handoff_dispatch_s", "handoff_materialize_s",
            "sync_stall_s", "staging_backpressure_s", "async_overlapped_s")
    out = {k: report[k] for k in keys} | {
        "step_s": report["step_compute_s"] / steps}
    if tm is not None:
        out["step_median_s"] = statistics.median(
            sp.dt for sp in tm.spans("step/compute"))
    return out


def train_phase(ckpt_dir: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.configs import base as configs
    from repro_torch.core import pytree
    from repro_torch.core.session import (InSituPlan, Placement, TaskSpec,
                                          When)
    from repro_torch.data.pipeline import batch_spec_for, synth_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m")
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    steps, every = TRAIN["steps"], TRAIN["ckpt_every"]
    newest = (steps - 1) // every * every
    n_saves = (steps - 1) // every + 1
    _, sizes, rows = moment_rows(cfg)
    n_lossy = len(rows)

    # 0. the bare loop (no in-situ task) from seed 0, a few steps: eager twice
    #    and graphed once; the graphed losses are bitwise the eager ones
    #    where two eager runs are, else within their spread
    short = {}
    for name, graph in (("eager", False), ("eager_again", False),
                        ("graph", True)):
        run = T.train_loop("smollm-135m", smoke=False,
                           steps=EAGER["bare_steps"],
                           plan={"streams": ["grads", "train_state"]},
                           device="cuda", seed=0, cuda_graph=graph,
                           log=lambda m: None)
        short[name] = run["losses"]
        assert np.isfinite(run["losses"]).all(), (name, run["losses"])
        short[f"{name}_step_median_s"] = statistics.median(
            sp.dt for sp in run["telemetry"].spans("step/compute"))
    eager_spread = max(abs(a - b) for a, b in zip(short["eager"],
                                                  short["eager_again"]))
    graph_off = max(abs(a - b) for a, b in zip(short["eager"],
                                                short["graph"]))
    short["eager_bitwise"] = short["eager"] == short["eager_again"]
    if short["eager_bitwise"]:
        assert short["graph"] == short["eager"], short
    else:
        assert graph_off <= eager_spread, short
    short.update(eager_spread=eager_spread, graph_off=graph_off)
    log(f"train: {EAGER['bare_steps']} bare steps from seed 0, losses "
        f"eager {short['eager']}, "
        f"eager again {short['eager_again']}, graphed {short['graph']}: "
        f"eager runs {'bitwise equal' if short['eager_bitwise'] else 'apart'}"
        f" (max |dloss| {eager_spread}), graph vs eager max |dloss| "
        f"{graph_off}; median step s eager "
        f"{short['eager_step_median_s']:.4f} / graphed "
        f"{short['graph_step_median_s']:.4f}")

    # 1. the same steps with no checkpoint task bound (analytics only)
    t0 = time.perf_counter()
    bare = T.train_loop("smollm-135m", smoke=False, steps=steps,
                        insitu_mode="hybrid", device="cuda", seed=0,
                        log=lambda m: log(f"train (no ckpt): {m}"))
    torch.cuda.synchronize()
    bare_wall = time.perf_counter() - t0
    assert np.isfinite(bare["losses"]).all(), bare["losses"]
    bare_rep = bare["session_report"]
    assert bare_rep["n_errors"] == 0, bare_rep["errors"]

    # 2. HYBRID checkpoints every `every` steps, plus a probe that keeps
    #    the state emitted at the newest save's step
    emitted: dict = {}

    def keep(step, payload):
        emitted["step"] = step
        emitted["state"] = {pytree.keystr(p): np.array(a) for p, a in
                            pytree.flatten_with_path(payload)}

    base = InSituPlan.from_dict(T.default_train_plan(
        insitu_mode="hybrid", ckpt_dir=str(ckpt_dir), ckpt_every=every,
        device="cuda"))
    probe = TaskSpec(name="probe", stream="train_state",
                     trigger=When(lambda st: st == newest),
                     placement=Placement.SYNC, sink=keep)
    plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                      workers=base.workers,
                      staging_capacity=base.staging_capacity)
    K.reset_launches()
    t0 = time.perf_counter()
    out = T.train_loop("smollm-135m", smoke=False, steps=steps, plan=plan,
                       device="cuda", seed=0,
                       log=lambda m: log(f"train (hybrid ckpt): {m}"))
    torch.cuda.synchronize()
    ckpt_wall = time.perf_counter() - t0
    save_launches = {k.__name__: k.launches for k in K.KERNELS}
    rep = out["session_report"]
    assert rep["n_errors"] == 0, rep["errors"]
    assert np.isfinite(out["losses"]).all(), out["losses"]
    ck = rep["checkpoint"]
    assert ck["saves"] == n_saves and ck["last_step"] == newest, ck
    for name in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                 "threshold_quant"):
        assert save_launches[name] == n_saves, (name, save_launches)
    assert save_launches["dequant_idct"] == 0, save_launches
    probe_s = sum(sp.dt for sp in out["telemetry"].spans("insitu-sync/probe"))
    device_stage_enqueue_s = out["telemetry"].total("insitu-device/")

    # 3. restore the newest step directly: params bitwise, moments within
    #    the codec's bound per leaf
    template = T.init_state(cfg, 1, T.StepConfig().opt, device="cuda")
    K.reset_launches()
    t0 = time.perf_counter()
    restored = ser.read_state(str(ckpt_dir / f"step_{newest:09d}"), template,
                              "cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = K.dequant_idct.launches
    assert restore_launches == n_lossy, (restore_launches, n_lossy)
    assert emitted.get("step") == newest, emitted.get("step")
    worst = _family_tool().check_restored(
        restored, emitted["state"], f"step {newest}")["worst_rel_l2"]
    log(f"train: restored step {newest} in {restore_s:.2f}s: params bitwise, "
        f"moments worst rel L2 {worst:.4e} (bound "
        f"{ref.error_bound(EPS):.4e}), {restore_launches} dequant_idct "
        f"launches")

    # 4. the device stage alone, on the restored (trained) state
    policy = lambda k: "'mu'" in k or "'nu'" in k
    stage_ms = time_ms(lambda: ops.spectral_compress_tree(restored, EPS,
                                                          policy),
                       warmup=1, samples=3, reps=1)

    # 5. a second run resumes from the newest step
    lines: list[str] = []
    K.reset_launches()
    res = T.train_loop("smollm-135m", smoke=False,
                       steps=TRAIN["resume_steps"], insitu_mode="hybrid",
                       ckpt_dir=str(ckpt_dir), ckpt_every=every,
                       device="cuda", seed=0, log=lines.append)
    torch.cuda.synchronize()
    assert f"resumed from step {newest}" in lines, lines
    assert np.isfinite(res["losses"]).all(), res["losses"]
    assert res["session_report"]["n_errors"] == 0
    resume_launches = {k.__name__: k.launches for k in K.KERNELS}
    assert resume_launches["dequant_idct"] == n_lossy, resume_launches
    log(f"train: resumed from step {newest}; losses {res['losses']}")

    # 6. one full-width train step's device profile (no in-situ work),
    #    eager and replayed from its CUDA graph, with peak memory
    state = T.init_state(cfg, 0, T.StepConfig().opt, device="cuda")
    step_fn = T.make_train_step(cfg, T.StepConfig())
    spec = batch_spec_for(cfg, T.FULL_SHAPE)
    host_batch = synth_batch(spec, 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch.items()}
    step_fn(state, batch)
    torch.cuda.reset_peak_memory_stats()
    # one eager step: ~290,000 aten ops a step make its profile slow
    # (EAGER, the time limit)
    prof = device_profile(lambda: step_fn(state, batch), 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph_step = T.graph_train_step(cfg, T.StepConfig(), state, batch)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_step(host_batch)
    prof_graph = device_profile(lambda: graph_step(host_batch), 2)
    peak_graph_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # keeps only the live graph's pool
    held_gb = (torch.cuda.memory_reserved() - before) / 1e9
    for name, pr, peak in (("eager", prof, peak_gb),
                           ("graph", prof_graph, peak_graph_gb)):
        log(f"train: step ({name}, 4 x 4096 tokens, full width): "
            f"{pr['wall_ms']:.1f} ms wall, {pr['host_aten_ops']:.0f} aten "
            f"ops, device busy {pr['device_busy_ms']} ms, idle share "
            f"{pr['device_idle_share']}, peak memory {peak:.2f} GB")
        for op, ms in pr["top"]:
            log(f"train:   {ms:9.2f} ms/step  {op[:90]}")
    log(f"train: capture (2 warm-up steps + capture) {capture_s:.2f} s; the "
        f"graph's pool holds {held_gb:.2f} GB for the loop's life")
    del graph_step

    with_ckpt = _per_step(rep, steps, out["telemetry"])
    without = _per_step(bare_rep, steps, bare["telemetry"])
    blocking = _family_tool().ckpt_blocking_s(out["telemetry"])
    result = {
        "ckpt_blocking_s": blocking,
        "ckpt_blocking_s_per_save": blocking / n_saves,
        "ckpt_blocking_s_first_save": _family_tool().ckpt_blocking_s(
            out["telemetry"], first_save=True),
        "losses_without_ckpt": bare["losses"], "losses": out["losses"],
        "resume_losses": res["losses"],
        "step_s_without_ckpt": without["step_s"],
        "step_s_with_ckpt": with_ckpt["step_s"],
        "step_median_s_without_ckpt": without["step_median_s"],
        "step_median_s_with_ckpt": with_ckpt["step_median_s"],
        "wall_s_without_ckpt": bare_wall, "wall_s_with_ckpt": ckpt_wall,
        "loop": with_ckpt, "loop_without_ckpt": without,
        "probe_sync_s": probe_s,
        "device_stage_enqueue_s": device_stage_enqueue_s,
        "device_stage_ms": stage_ms,
        "saves": ck["saves"], "raw_bytes": ck["raw_bytes"],
        "stored_bytes": ck["stored_bytes"],
        "effective_compression_x": ck["raw_bytes"] / ck["stored_bytes"],
        "save_launches": save_launches, "restore_launches": restore_launches,
        "resume_launches": resume_launches, "restore_s": restore_s,
        "moments_worst_rel_l2": worst, "step_profile": prof,
        "peak_memory_gb": peak_gb, "step_profile_graph": prof_graph,
        "peak_memory_gb_graph": peak_graph_gb,
        "graph_pool_reserved_gb": held_gb, "graph_capture_s": capture_s,
        "bare_steps": short,
    }
    log(f"train: step {without['step_s'] * 1e3:.1f} ms without the "
        f"checkpoint task, {with_ckpt['step_s'] * 1e3:.1f} ms with it (median "
        f"{without['step_median_s'] * 1e3:.1f} / "
        f"{with_ckpt['step_median_s'] * 1e3:.1f}); "
        f"loop-blocking handoff dispatch {with_ckpt['handoff_dispatch_s']:.3f}"
        f" s, sync stall {with_ckpt['sync_stall_s']:.3f} s (probe "
        f"{probe_s:.3f} s of it), device stage alone {stage_ms:.2f} ms; "
        f"checkpoint {ck['raw_bytes']} -> {ck['stored_bytes']} bytes "
        f"({result['effective_compression_x']:.2f}x) over {ck['saves']} saves")
    del state, restored, template
    torch.cuda.empty_cache()
    return result


def placements_phase(ckpt_root: Path, hybrid: dict) -> dict:
    """SYNC and ASYNC checkpoints of the full-width training run."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.configs import base as configs
    from repro_torch.core import pytree
    from repro_torch.core.allocator import Allocator
    from repro_torch.core.session import (InSituPlan, Placement, TaskSpec,
                                          When)
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m")
    steps, every = PLACEMENTS["steps"], PLACEMENTS["ckpt_every"]
    newest = (steps - 1) // every * every
    n_saves = (steps - 1) // every + 1
    n_lossy = len(moment_rows(cfg)[2])
    out = {}
    for mode in ("sync", "async"):
        ckpt_dir = ckpt_root / mode
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        emitted: dict = {}

        def keep(step, payload):
            emitted["step"] = step
            emitted["state"] = {pytree.keystr(p): np.array(a) for p, a in
                                pytree.flatten_with_path(payload)}

        base = InSituPlan.from_dict(T.default_train_plan(
            insitu_mode=mode, ckpt_dir=str(ckpt_dir), ckpt_every=every,
            device="cuda"))
        probe = TaskSpec(name="probe", stream="train_state",
                         trigger=When(lambda st: st == newest),
                         placement=Placement.SYNC, sink=keep)
        plan = InSituPlan(streams=base.streams, tasks=[*base.tasks, probe],
                          workers=base.workers,
                          staging_capacity=base.staging_capacity)
        K.reset_launches()
        t0 = time.perf_counter()
        run = T.train_loop("smollm-135m", smoke=False, steps=steps,
                           plan=plan, device="cuda", seed=0,
                           log=lambda m, mode=mode: log(f"train ({mode} "
                                                        f"ckpt): {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in K.KERNELS}
        rep = run["session_report"]
        assert rep["n_errors"] == 0, rep["errors"]
        assert np.isfinite(run["losses"]).all(), run["losses"]
        ck = rep["checkpoint"]
        assert ck["saves"] == n_saves and ck["last_step"] == newest, ck
        for name in ("dct_hist_coarse", "hist_refine", "threshold_quant"):
            assert launches[name] == n_lossy * n_saves, (mode, launches)
        for name in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                     "dequant_idct"):
            assert launches[name] == 0, (mode, launches)
        tm = run["telemetry"]
        blocking = _family_tool().ckpt_blocking_s(tm)
        worker_s = tm.total("insitu-async/checkpoint")

        template = T.init_state(cfg, 1, T.StepConfig().opt, device="cuda")
        K.reset_launches()
        t0 = time.perf_counter()
        restored = ser.read_state(str(ckpt_dir / f"step_{newest:09d}"),
                                  template, "cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert K.dequant_idct.launches == n_lossy, K.dequant_idct.launches
        assert emitted.get("step") == newest, emitted.get("step")
        worst = _family_tool().check_restored(
            restored, emitted["state"], f"{mode} step {newest}")[
                "worst_rel_l2"]
        del restored, template, emitted
        torch.cuda.empty_cache()
        loop = _per_step(rep, steps, tm)
        out[mode] = {
            "losses": run["losses"], "wall_s": wall,
            "step_s": loop["step_s"], "step_median_s": loop["step_median_s"],
            "loop": loop,
            "ckpt_blocking_s": blocking,
            "ckpt_blocking_s_per_save": blocking / n_saves,
            "ckpt_blocking_s_first_save": _family_tool().ckpt_blocking_s(
                tm, first_save=True),
            "ckpt_worker_s": worker_s,
            "probe_sync_s": tm.total("insitu-sync/probe"),
            "saves": ck["saves"], "raw_bytes": ck["raw_bytes"],
            "stored_bytes": ck["stored_bytes"],
            "effective_compression_x": ck["raw_bytes"] / ck["stored_bytes"],
            "launches": launches, "restore_s": restore_s,
            "restore_launches": n_lossy, "moments_worst_rel_l2": worst}
        log(f"train ({mode} ckpt): step {loop['step_s'] * 1e3:.1f} ms "
            f"(median {loop['step_median_s'] * 1e3:.1f}), wall {wall:.2f} s; "
            f"the checkpoint held the loop {blocking:.3f} s over {n_saves} "
            f"saves ({blocking / n_saves:.3f} s per save; sync stall "
            f"{loop['sync_stall_s']:.3f} s, handoff dispatch "
            f"{loop['handoff_dispatch_s']:.3f} s, probe "
            f"{out[mode]['probe_sync_s']:.3f} s of the stall), worker "
            f"seconds {worker_s:.3f}; {ck['raw_bytes']} -> "
            f"{ck['stored_bytes']} bytes "
            f"({out[mode]['effective_compression_x']:.2f}x); restore of "
            f"step {newest} {restore_s:.2f} s, moments worst rel L2 "
            f"{worst:.4e}; launches {launches}")
    sync, asyn = out["sync"], out["async"]
    assert sync["ckpt_blocking_s"] > asyn["ckpt_blocking_s"], (
        "the SYNC checkpoint held the loop no longer than the ASYNC one")
    log(f"train placements (ckpt every {every} of {steps} steps; HYBRID "
        f"every {TRAIN['ckpt_every']} of {TRAIN['steps']}): median step s "
        f"sync {sync['step_median_s']:.4f} / async "
        f"{asyn['step_median_s']:.4f} / hybrid "
        f"{hybrid['step_median_s_with_ckpt']:.4f} (no ckpt "
        f"{hybrid['step_median_s_without_ckpt']:.4f}); wall s sync "
        f"{sync['wall_s']:.2f} / async {asyn['wall_s']:.2f}; "
        f"loop-blocking s per save "
        f"sync {sync['ckpt_blocking_s_per_save']:.4f} / async "
        f"{asyn['ckpt_blocking_s_per_save']:.4f} / hybrid "
        f"{hybrid['ckpt_blocking_s_per_save']:.4f}; compression sync "
        f"{sync['effective_compression_x']:.3f}x / async "
        f"{asyn['effective_compression_x']:.3f}x / hybrid "
        f"{hybrid['effective_compression_x']:.3f}x; restore s sync "
        f"{sync['restore_s']:.2f} / async {asyn['restore_s']:.2f} / hybrid "
        f"{hybrid['restore_s']:.2f}")
    # the paper's allocator (Table I, F1, F6) on the measured costs
    p_total = os.cpu_count() or 8
    al = Allocator(p_total=p_total,
                   handoff_s=asyn["ckpt_blocking_s_per_save"])
    al.observe_app(p_total, hybrid["step_s_without_ckpt"])
    al.observe_task(p_total, sync["ckpt_blocking_s_per_save"])
    al.observe_task(2, asyn["ckpt_worker_s"] / n_saves)
    choice = al.plan(n_steps=steps, every=every)
    out["allocator"] = {"mode": choice.mode, "p_app": choice.p_app,
                        "p_insitu": choice.p_insitu,
                        "predicted_total_s": choice.predicted_total_s,
                        "detail": choice.detail}
    log(f"allocator (p_total {p_total}): {out['allocator']}")

    # the same placements stepping eagerly, EAGER["placement_steps"] steps
    # with a checkpoint every 5 (the first of the graphed runs' saves):
    # what the graph changed in each, within this run, the loop-blocking
    # of the step-0 save on both sides (the eager runs make no other); the
    # losses are the graphed runs' (bitwise where two eager runs are, else
    # within their spread)
    spread = hybrid["bare_steps"]
    graphed = {"hybrid": hybrid["losses"], "sync": sync["losses"],
               "async": asyn["losses"]}
    out["eager"] = {}
    steps = EAGER["placement_steps"]
    eager_saves = (steps - 1) // every + 1
    for mode in ("hybrid", "sync", "async"):
        ckpt_dir = ckpt_root / f"eager_{mode}"
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        t0 = time.perf_counter()
        run = T.train_loop("smollm-135m", smoke=False, steps=steps,
                           insitu_mode=mode, ckpt_dir=str(ckpt_dir),
                           ckpt_every=every, device="cuda", seed=0,
                           cuda_graph=False, log=lambda m: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = run["session_report"]
        assert rep["n_errors"] == 0, rep["errors"]
        assert rep["checkpoint"]["saves"] == eager_saves, rep["checkpoint"]
        want = graphed[mode][:steps]
        off = max(abs(a - b) for a, b in zip(run["losses"], want))
        if spread["eager_bitwise"]:
            assert run["losses"] == want, (mode, run["losses"], want)
        else:
            assert off <= spread["eager_spread"], (mode, run["losses"], want)
        tm = run["telemetry"]
        loop = _per_step(rep, steps, tm)
        blocking = _family_tool().ckpt_blocking_s(tm)
        out["eager"][mode] = {
            "losses": run["losses"], "wall_s": wall,
            "step_median_s": loop["step_median_s"], "loop": loop,
            "ckpt_blocking_s_per_save": blocking / eager_saves,
            "ckpt_blocking_s_first_save": _family_tool().ckpt_blocking_s(
                tm, first_save=True),
            "ckpt_worker_s": tm.total("insitu-async/checkpoint"),
            "graph_loss_max_abs_diff": off}
    eager = out["eager"]
    log(f"train placements, eager (ckpt every {every} of {steps} steps): "
        f"median step s hybrid {eager['hybrid']['step_median_s']:.4f} / "
        f"sync {eager['sync']['step_median_s']:.4f} / async "
        f"{eager['async']['step_median_s']:.4f}; loop-blocking s of the "
        f"step-0 save, eager / graph: "
        + " / ".join(f"{m} {eager[m]['ckpt_blocking_s_first_save']:.4f} / "
                     f"{g['ckpt_blocking_s_first_save']:.4f}"
                     for m, g in (("hybrid", hybrid), ("sync", sync),
                                  ("async", asyn)))
        + f"; worker s async "
        f"{eager['async']['ckpt_worker_s']:.3f}; losses equal to the "
        f"graphed runs' (max |dloss| "
        f"{max(e['graph_loss_max_abs_diff'] for e in eager.values())})")
    return out


# ---------------------------------------------------------------------------
# insitu phase
# ---------------------------------------------------------------------------

def _host_qs(q, scale) -> tuple:
    """(q, scale) as host numpy, for bitwise comparisons."""
    import numpy as np

    return tuple(np.asarray(a.cpu().numpy() if hasattr(a, "cpu") else a)
                 for a in (q, scale))


def _same_qs(a: tuple, b: tuple) -> bool:
    import numpy as np

    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def _single_launches(K, want: int) -> dict:
    """Launch counts of the spectral kernels, gated to ``want`` launches
    of each single-tensor kernel (6, 7 and 4) and none of the others."""
    launches = {k.__name__: k.launches for k in K.KERNELS}
    for name, n in launches.items():
        single = name in ("dct_hist_coarse", "hist_refine", "threshold_quant")
        assert n == (want if single else 0), (name, launches, want)
    return launches


def legacy_path(embed_shape: tuple) -> dict:
    """(a) ``run_pipeline`` and ``run_workflow`` on the card, each against
    a ``Session`` run of the equivalent plan on the same inputs."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core import (Every, InSituEngine, InSituMode,
                                  InSituPlan, InSituTask, PipelineRuntime,
                                  PipelineTask, Placement, Session, TaskSpec,
                                  host, run_pipeline, run_workflow)
    from repro_torch.kernels import ops
    from repro_torch.kernels import spectral_lossy as K

    dev = torch.device("cuda")
    steps = INSITU["steps"]
    gen = torch.Generator(device=dev).manual_seed(21)
    xs = [torch.randn(embed_shape, generator=gen, device=dev) * (1 + i)
          for i in range(steps)]
    main_thread = threading.main_thread().name
    out: dict = {"steps": steps, "blocks": math.prod(embed_shape) // 256}

    def app(i):
        return {"x": lambda: xs[i]}

    # HYBRID: the device stage compresses on the loop's stream; the sink
    # gets the host Compressed of the hand-off
    got: dict = {}

    def hybrid_sink(tag):
        def sink(step, c):
            got[(tag, step)] = _host_qs(c.q, c.scale)
            return step
        return sink

    def device_stage(step, x):
        return ops.spectral_compress(x, EPS)

    rt = PipelineRuntime([PipelineTask(
        "hybrid", "x", sink=hybrid_sink("pipeline"),
        device_stage=device_stage, placement=Placement.HYBRID)],
        workers=2, staging_capacity=2)
    K.reset_launches()
    t0 = time.perf_counter()
    tm = run_pipeline(steps, app, rt)
    torch.cuda.synchronize()
    out["run_pipeline_s"] = time.perf_counter() - t0
    out["run_pipeline_launches"] = _single_launches(K, steps)
    assert not rt.errors, rt.errors[:1]
    assert len(tm.spans("step/compute")) == steps
    assert len(tm.spans("insitu-device/hybrid")) == steps
    sess = Session(InSituPlan(
        streams=["x"], tasks=[TaskSpec(
            name="hybrid", stream="x", sink=hybrid_sink("session"),
            device_stage=device_stage, placement=Placement.HYBRID)],
        workers=2, staging_capacity=2), raise_on_error=True)
    sess.run(steps, app)
    for i in range(steps):
        assert _same_qs(got[("pipeline", i)], got[("session", i)]), i

    # SYNC + ASYNC: the task compresses the host payload on the card, on
    # its thread's own stream (the loop's for SYNC, a worker's for ASYNC)
    def compress(step, payload):
        with host.worker_stream(dev):
            c = ops.spectral_compress(host.to_device(payload, dev), EPS)
            return _host_qs(c.q, c.scale)

    tasks = [InSituTask("sync", "x", compress, mode=InSituMode.SYNC),
             InSituTask("async", "x", compress, mode=InSituMode.ASYNC)]
    eng = InSituEngine(tasks, p_i=2, staging_capacity=2)
    K.reset_launches()
    t0 = time.perf_counter()
    run_workflow(steps, app, eng)
    torch.cuda.synchronize()
    out["run_workflow_s"] = time.perf_counter() - t0
    out["run_workflow_launches"] = _single_launches(K, 2 * steps)
    assert not eng.errors, eng.errors[:1]
    assert len(eng.results) == 2 * steps
    for r in eng.results:
        if r.task == "sync":
            assert r.worker == main_thread, r.worker
        else:
            assert r.worker.startswith("insitu-"), r.worker
    sess2 = Session(InSituPlan(
        streams=["x"], tasks=[
            TaskSpec(name=t.name, stream="x", sink=compress,
                     trigger=Every(1), placement=t.mode) for t in tasks],
        workers=2, staging_capacity=2), raise_on_error=True)
    sess2.run(steps, app)
    want = {(r.task, r.step): r.result for r in sess2.results}
    assert len(want) == 2 * steps
    for r in eng.results:
        assert _same_qs(r.result, want[(r.task, r.step)]), (r.task, r.step)
        # every placement compresses the same input to the same bits
        assert _same_qs(r.result, got[("pipeline", r.step)]), (r.task,
                                                                r.step)
    rep, srep = eng.report(), sess2.report()
    assert set(rep) == set(srep), sorted(set(rep) ^ set(srep))
    assert rep["tasks"] == srep["tasks"], (rep["tasks"], srep["tasks"])
    out["report"] = {k: rep[k] for k in (
        "step_compute_s", "handoff_s", "sync_stall_s", "async_overlapped_s",
        "n_results", "n_errors")}
    del xs, got
    torch.cuda.empty_cache()
    return out


def _leaf_bytes(d: Path) -> dict:
    """keystr -> the stored bytes of each leaf of a checkpoint directory."""
    from repro_torch.checkpoint import serialization as ser

    files: dict = {}
    out = {}
    for key, e in ser.read_manifest(str(d))["leaves"].items():
        if e["file"] not in files:
            files[e["file"]] = (d / e["file"]).read_bytes()
        off = e.get("offset", 0)
        out[key] = files[e["file"]][off:off + e["bytes"]]
    return out


def checkpoint_writes(ckpt_root: Path, n_lossy: int) -> dict:
    """(b) HYBRID saves of the full-width state in both layouts, and the
    serial encode, each restored or compared byte for byte. The serial
    save (no leaf or chunk fan-out: one zlib thread) takes the moments and
    the step count only: the same 22 lossy leaves and one dispatch of
    kernels 2-4, without the 270 MB of bf16 params whose single-threaded
    encode would not fit the phase's budget."""
    import torch
    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        serialization as ser)
    from repro_torch.configs import base as configs
    from repro_torch.core import host, pytree
    from repro_torch.core.runtime import Placement
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.launch import train as T

    cfg = configs.get("smollm-135m")
    state = T.init_state(cfg, 0, T.StepConfig().opt, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for grp, scale in (("mu", 1e-3), ("nu", 1e-6)):   # moments of a run
        for t in pytree.leaves(state[grp]):
            r = torch.randn(t.shape, generator=gen, device="cuda") * scale
            t.copy_(r.abs() if grp == "nu" else r)
    torch.cuda.synchronize()
    if ckpt_root.exists():
        shutil.rmtree(ckpt_root)
    out: dict = {}
    mgrs = {}
    moments = {k: state[k] for k in ("mu", "nu", "count")}
    for name, kw, tree in (
            ("v2", {"shard_count": INSITU["shard_count"]}, state),
            ("v1", {"format": 1}, state),
            ("v2_serial", {"shard_count": INSITU["shard_count"],
                           "leaf_parallel": False, "chunk_parallel": False},
             moments)):
        mgr = CheckpointManager(CheckpointConfig(
            str(ckpt_root / name), mode=Placement.HYBRID, every=1, **kw))
        K.reset_launches()
        t0 = time.perf_counter()
        mgr.save(0, tree)
        mgr.wait_idle()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in K.KERNELS}
        mgr.finish()
        assert not mgr.runtime.errors, mgr.runtime.errors[:1]
        for k, n in launches.items():
            tiled = k in ("dct_hist_coarse_tiled", "hist_refine_tiled",
                          "threshold_quant")
            assert n == (1 if tiled else 0), (name, launches)
        rep = mgr.reports[-1]
        tm = mgr.telemetry
        out[name] = {"wall_s": wall,
                     "blocking_s": _family_tool().ckpt_blocking_s(tm),
                     "worker_s": tm.total("insitu-async/checkpoint"),
                     "raw_bytes": rep.raw_bytes,
                     "stored_bytes": rep.stored_bytes, "launches": launches}
        mgrs[name] = mgr
    d2, d1, ds = (ckpt_root / n / "step_000000000"
                  for n in ("v2", "v1", "v2_serial"))
    man2, man1 = ser.read_manifest(str(d2)), ser.read_manifest(str(d1))
    files = sorted({e["file"] for e in man2["leaves"].values()})
    assert len(files) > 1, files
    assert man1["format"] == 1 and man2["format"] == 2
    shards = {f: (d2 / f).read_bytes() for f in files}
    for key, e in man2["leaves"].items():
        e1 = man1["leaves"][key]
        assert e1["file"] == ser._fname(key), key
        blob = (d1 / e1["file"]).read_bytes()
        assert blob == shards[e["file"]][e["offset"]:e["offset"] + e["bytes"]
                                         ], key
    serial, fanned = _leaf_bytes(ds), _leaf_bytes(d2)
    assert len(serial) == n_lossy + 1, len(serial)
    for key, blob in serial.items():
        assert blob == fanned[key], key
    out["shard_files"] = len(files)
    out["shard_mb"] = [len(shards[f]) / 1e6 for f in files]
    out["leaves"] = len(man2["leaves"])
    emitted = {pytree.keystr(p): host.to_numpy(t.cpu())
               for p, t in pytree.flatten_with_path(state)}
    for name in ("v2", "v1"):
        K.reset_launches()
        t0 = time.perf_counter()
        step, restored = mgrs[name].restore(state)
        torch.cuda.synchronize()
        out[name]["restore_s"] = time.perf_counter() - t0
        assert step == 0
        assert K.dequant_idct.launches == n_lossy, K.dequant_idct.launches
        out[name]["restore_launches"] = K.dequant_idct.launches
        out[name]["moments_worst_rel_l2"] = _family_tool().check_restored(
            restored, emitted, name)["worst_rel_l2"]
        del restored
    del state, emitted
    torch.cuda.empty_cache()
    return out


def run_examples() -> dict:
    """(c) The port's quickstart and compression demo as child processes on
    the card (their default device)."""
    out = {}
    for script, gate in (
            ("torch_quickstart.py",
             lambda ls: [ln.split(":")[0].strip() for ln in ls
                         if ": wall=" in ln and ln.endswith("results=5")]
             == ["sync", "async", "hybrid"]),
            ("torch_compression_demo.py",
             lambda ls: "  restored step 100: weights bit-exact = True"
             in ls)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                             capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = run.stdout.splitlines()
        for ln in lines:
            log(f"insitu (example {script}): {ln}")
        assert run.returncode == 0, (script, run.returncode,
                                     run.stderr[-3000:])
        assert gate(lines), (script, lines)
        out[script] = {"wall_s": wall, "lines": lines}
    return out


def insitu_phase(ckpt_root: Path) -> dict:
    """The legacy in-situ engine path, the checkpoint write layouts and the
    examples on the card (see the module docstring, phase 11)."""
    from repro_torch.configs import base as configs
    from repro_torch.models import transformer

    cfg = configs.get("smollm-135m")
    embed = tuple(transformer.param_spec(cfg)["embed"]["embedding"].shape)
    n_lossy = len(moment_rows(cfg)[2])
    t0 = time.perf_counter()
    legacy = legacy_path(embed)
    legacy["wall_s"] = time.perf_counter() - t0
    log(f"insitu (legacy): run_pipeline HYBRID {legacy['steps']} firings "
        f"over {embed} ({legacy['blocks']} blocks) in "
        f"{legacy['run_pipeline_s']:.3f} s, run_workflow SYNC + ASYNC "
        f"{2 * legacy['steps']} firings in {legacy['run_workflow_s']:.3f} s; "
        f"q and scale bitwise the Session runs' and equal across "
        f"placements; kernels 6/7/4 once a firing "
        f"({legacy['run_workflow_launches']['dct_hist_coarse']} in the "
        f"workflow); SYNC on the loop thread, ASYNC on insitu-* workers")
    t0 = time.perf_counter()
    ck = checkpoint_writes(ckpt_root, n_lossy)
    ck["wall_s"] = time.perf_counter() - t0
    for name in ("v2", "v1", "v2_serial"):
        c = ck[name]
        restore = (f", restore {c['restore_s']:.3f} s ({c['restore_launches']}"
                   f" dequant_idct, moments worst rel L2 "
                   f"{c['moments_worst_rel_l2']:.4e})"
                   if "restore_s" in c else "")
        log(f"insitu (checkpoint {name}): save wall {c['wall_s']:.3f} s, "
            f"loop-blocking {c['blocking_s']:.4f} s, worker "
            f"{c['worker_s']:.3f} s, {c['raw_bytes']} -> "
            f"{c['stored_bytes']} bytes{restore}")
    log(f"insitu (checkpoint): {ck['shard_files']} shards "
        f"({', '.join(f'{mb:.1f}' for mb in ck['shard_mb'])} MB) of "
        f"{ck['leaves']} leaves; every v1 file equals its v2 bytes; the "
        f"serial encode of the moments wrote the same blobs")
    t0 = time.perf_counter()
    examples = run_examples()
    walls = {k: round(v["wall_s"], 3) for k, v in examples.items()}
    log(f"insitu (examples): exit 0, walls {walls} s")
    return {"legacy": legacy, "checkpoint": ck, "examples": examples,
            "examples_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# moe phase
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"


def _free_cuda(empty: bool = True) -> None:
    """Drop what the last run left: an engine and its captured step hold
    each other (the graph's body is a bound method), so their 56.6 GB of
    weights go only with a collection. ``empty=False`` keeps the freed
    blocks cached for the next run's weights, which have the same
    sizes."""
    import gc
    import torch

    gc.collect()
    torch.cuda.synchronize()
    if empty:
        torch.cuda.empty_cache()


def _one_step(cfg, eng, attend):
    """One decode step of ``eng``'s state through ``attend``, on copies
    of its pool and state; the last position's logits in f32."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.serving.pages import make_paged_decode

    clone = lambda t: tree_map(lambda x: x.clone(), t)
    logits, *_ = make_paged_decode(cfg, eng.page_size, attend=attend)(
        eng.params, clone(eng.pool), clone(eng.state),
        eng.page_table.clone(), eng.tokens.clone(), eng.lengths.clone())
    return logits[:, -1, :cfg.vocab_size].float()


def _kernel_against_plain(cfg, eng, n_paged: int) -> tuple:
    """One decode step driven by the plain attention, the kernel held
    against it at each of the ``n_paged`` layers that attend over the
    pages, on that layer's own inputs (atol BF16_ATOL). Returns the
    per-layer errors and the step's logits through the plain attention
    and through the kernel."""
    from repro_torch.kernels import paged_attention as PK

    layer_err = []

    def plain_and_kernel(q, k, v, table, length):
        ref = PK.paged_decode_attention_plain(q, k, v, table, length)
        got = PK.paged_decode_attention(q, k, v, table, length)
        layer_err.append((got.float() - ref.float()).abs().max().item())
        return ref

    with_plain = _one_step(cfg, eng, plain_and_kernel)
    assert len(layer_err) == n_paged, layer_err
    assert max(layer_err) <= BF16_ATOL, layer_err
    return layer_err, with_plain, _one_step(cfg, eng,
                                            PK.paged_decode_attention)


def _kernel_checks(cfg, eng, n_paged: int) -> dict:
    """:func:`_kernel_against_plain` at the ``n_paged`` layers that attend
    over the pages: the per-layer errors, and the step's logits through
    the kernel against those through the plain attention."""
    err, with_plain, with_kernel = _kernel_against_plain(cfg, eng, n_paged)
    return {"layer_attention_max_abs_err": err,
            "logits_max_abs_kernel_plain":
                (with_kernel - with_plain).abs().max().item(),
            "argmax_agreement": (with_kernel.argmax(-1)
                                 == with_plain.argmax(-1)).float()
            .mean().item()}


def _published_bytes(emitted: dict, hints: dict) -> dict:
    """What the snapshot plan publishes a firing, by part of the payload
    (``pool``: the global layers' pages; ``state``: SWA rings and SSM
    state; the rest: tables, lengths, tokens, meta): the raw bytes, and
    the zlib frames of the last firing the probe kept, as a base and as a
    delta against the firing before it (what ``SnapshotStore.publish``
    encodes; the pool's chunks one (layer, page) slab, as the engine's
    ``chunk_hints`` give them)."""
    from repro_torch.core import codecs, delta

    steps = sorted(emitted)
    last, prev = emitted[steps[-1]], emitted[steps[-2]]
    out: dict = {}
    pool = codecs.codec_pool()
    for key, arr in last.items():
        part = ("pool" if key.startswith("['pool']") else "state"
                if key.startswith("['state']") else "rest")
        chunk = int(hints.get(key, codecs.DEFAULT_CHUNK))
        base, _ = delta.encode(arr, None, codec="zlib", chunk_bytes=chunk,
                               pool=pool)
        dlt, _ = delta.encode(arr, prev[key], codec="zlib",
                              chunk_bytes=chunk, pool=pool)
        row = out.setdefault(part, {"raw": 0, "base": 0, "delta": 0})
        row["raw"] += arr.nbytes
        row["base"] += len(base)
        row["delta"] += len(dlt)
    out["firings"] = [steps[-2], steps[-1]]
    return out


def _serve_runs(tag: str, arch: str, runs, build: Path, n_paged: int
                ) -> dict:
    """``serve_loop(arch, smoke=False)`` on SERVE's traffic, once for each
    ``(plan, graphed)`` of ``runs``; plan "plan" is the default async
    ``serve_snapshot`` plan, its chain persisted under ``build/`` beside a
    probe of what was emitted. Gates: the runs decode the same streams,
    every request served and every page back, each run's kernel launches
    = its decode steps x ``n_paged``, and the chain restores
    bit-identically."""
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.core.session import Every, InSituPlan, Placement, \
        TaskSpec
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.launch.serve import default_serve_plan, serve_loop
    from repro_torch.serving import snapshot as S

    cfg = configs.get(arch)
    chain = build / f"smoke_{tag}_chain"
    res, emitted, lines, out = {}, {}, [], {}
    for key in runs:
        name = f"{'graph' if key[1] else 'eager'}_{key[0]}"
        if key[0] == "plan":
            if chain.exists():
                shutil.rmtree(chain)
            base = InSituPlan.from_dict(
                default_serve_plan(snapshot_dir=str(chain)))
            probe = TaskSpec(name="probe", stream="kv_pages",
                             trigger=Every(4), placement=Placement.SYNC,
                             sink=lambda step, p: emitted.__setitem__(
                                 step, S._flatten(p["cache"])))
            plan = InSituPlan(streams=base.streams,
                              tasks=[*base.tasks, probe],
                              workers=base.workers,
                              staging_capacity=base.staging_capacity)
        else:
            plan = {"streams": ["kv_pages"]}
        torch.cuda.reset_peak_memory_stats()
        PK.paged_decode_attention.launches = 0
        r = res[name] = serve_loop(arch, smoke=False, device="cuda", seed=0,
                                   plan=plan, cuda_graph=key[1],
                                   log=lines.append, **SERVE)
        torch.cuda.synchronize()
        rep = r["session_report"]
        steps = len(r["telemetry"].spans("step/compute"))
        launches = PK.paged_decode_attention.launches
        assert launches == steps * n_paged, (
            f"{tag} {name}: kernel launches {launches} != {steps} decode "
            f"steps x {n_paged} layers")
        assert rep["n_errors"] == 0, rep["errors"]
        out[name] = {"tok_per_s": r["tok_per_s"],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "wall_s": _serve_wall_s(r),
                     "admit_s": r["telemetry"].total("serve/admit"),
                     "step_compute_s": rep["step_compute_s"],
                     "decode_steps": steps, "launches": launches}
        if key[0] == "plan":
            out[name].update(
                snapshots=rep["tasks"]["kv_snapshot"]["publishes"],
                snapshot_drops=rep["drops"].get("kv_snapshot", 0))
            assert out[name]["snapshots"] > 0, "no snapshot"
        log(f"{tag}: serve {name}: {r['tok_per_s']:.1f} tok/s, wall "
            f"{out[name]['wall_s']:.2f} s = admissions "
            f"{out[name]['admit_s']:.2f} + decode steps "
            f"{rep['step_compute_s']:.2f} + hand-off dispatch "
            f"{rep['handoff_dispatch_s']:.2f} + the rest; {launches} "
            f"kernel launches = {steps} steps x {n_paged}; peak "
            f"{out[name]['peak_gib']:.2f} GiB")
        _free_cuda(empty=False)
    streams = {k: [q.out for q in r["requests"]] for k, r in res.items()}
    first = next(iter(streams.values()))
    for name, got in streams.items():
        assert got == first, f"{tag}: serve run {name} decoded other tokens"
    for r in res.values():
        for q in r["requests"]:
            assert q.done and len(q.out) == q.max_new, q.rid
            assert all(0 <= t < cfg.vocab_size for t in q.out), q.rid
    pools = [m for m in (re.match(r"page pool: (\d+)/", ln) for ln in lines)
             if m]
    assert len(pools) == len(runs) and all(
        int(m.group(1)) == 0 for m in pools), "page pool not empty at exit"
    log(f"{tag}: the {len(runs)} runs decode the same "
        f"{SERVE['n_requests']} streams; every request served, every page "
        f"back")
    if emitted:
        step, leaves = S.SnapshotStore(str(chain)).restore("kv_pages")
        want = emitted[step]
        assert list(leaves) == list(want), "restored leaf keys differ"
        for key, arr in leaves.items():
            if not np.array_equal(arr.reshape(-1).view(np.uint8),
                                  want[key].reshape(-1).view(np.uint8)):
                raise AssertionError(f"{chain.name}: restored leaf {key} "
                                     f"differs at step {step}")
        out["restored"] = {"step": step,
                           "bytes": sum(a.nbytes for a in leaves.values())}
        del leaves, want
        hints = {k: int(np.prod(a.shape[2:])) * a.itemsize
                 for k, a in emitted[step].items()
                 if k.startswith("['pool']")}
        out["published_bytes"] = _published_bytes(emitted, hints)
        emitted.clear()
        log(f"{tag}: the graphed run's chain restores bit-identically to "
            f"what was emitted at step {step} ({out['restored']['bytes']} "
            f"bytes); bytes a firing (raw / zlib base / zlib delta): "
            f"{out['published_bytes']}")
    del res
    _free_cuda()
    return out


def _draw_full(tag: str, cfg) -> tuple:
    """``cfg``'s full-width weights from seed 0 on the card's generator
    (``params.weight_generator``), timed: ``(params, {"weight_draw_s",
    "weight_bytes"})``."""
    import torch
    from repro_torch.core.pytree import leaves as tree_leaves
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = P.materialize(P.weight_generator(cfg, 0, torch.device("cuda"),
                                              False),
                           transformer.param_spec(cfg), "cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"{tag}: drew {n_bytes / 1e9:.2f} GB of weights ({cfg.n_params()} "
        f"parameters) on the card's generator in {draw_s:.2f} s")
    return params, {"weight_draw_s": draw_s, "weight_bytes": n_bytes}


def _full_engines(tag: str, cfg, params, n_paged: int) -> dict:
    """A graphed and an eager full-width engine with 8 rows admitted: two
    steps with the same logits bits, then the kernel against the plain
    attention at each of the ``n_paged`` layers that attend over the pages
    (on that layer's inputs), and where a decode step's time goes."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    geo = dict(num_pages=33, page_size=16, max_reqs=8, prompt_len=16,
               max_len=64)
    engines = {}
    for graph in (True, False):
        e = engines[graph] = PagedServingEngine(cfg, params, device="cuda",
                                                cuda_graph=graph, **geo)
        rng = np.random.default_rng(5)
        for i in range(8):
            assert e.admit(Request(i, rng.integers(0, cfg.vocab_size, 16),
                                   max_new=40))
    eng, eng_eager = engines[True], engines[False]
    for _ in range(2):
        eng.step()
        eng_eager.step()
        assert torch.equal(eng.logits, eng_eager.logits), (
            f"{tag}: graphed and eager decode logits differ")
    checks = _kernel_checks(cfg, eng, n_paged)
    log(f"{tag}: 2 full-width decode steps (8 rows), graph replay and "
        f"eager step: logits bitwise equal; one more: the kernel against the "
        f"plain attention at each of the {n_paged} paged layers, max "
        f"{max(checks['layer_attention_max_abs_err']):.3e} (<= "
        f"{BF16_ATOL}); "
        f"logits max |kernel - plain| "
        f"{checks['logits_max_abs_kernel_plain']:.3e}, argmax agreement "
        f"{checks['argmax_agreement']}")
    prof = device_profile(eng.step, 5)
    prof["wall_ms_unprofiled"] = host_wall_ms(eng.step, 5)
    prof["device_idle_share_unprofiled"] = (
        1 - prof["device_busy_ms"] / prof["wall_ms_unprofiled"]
        if prof["device_busy_ms"] else None)
    prof["paged_launches_recorded"] = sum(
        c for op, c in prof["launches"].items()
        if "paged_decode_kernel" in op)
    prof["eager_wall_ms"] = host_wall_ms(eng_eager.step, 5)
    log(f"{tag}: decode step (graph, 8 rows, full width): "
        f"{prof['wall_ms_unprofiled']:.3f} ms host wall (eager "
        f"{prof['eager_wall_ms']:.3f}), device busy {prof['device_busy_ms']} "
        f"ms, idle share {prof['device_idle_share_unprofiled']}, "
        f"{prof['host_aten_ops']:.0f} aten ops, kernel launches recorded "
        f"{prof['paged_launches_recorded']} of {5 * n_paged} made")
    for op, ms in prof["top"][:6]:
        log(f"{tag}:   {ms * 1e3:9.1f} us/step  {op[:90]}")
    prof.pop("launches")
    prof.pop("per_launch_ms")
    del engines, eng, eng_eager
    _free_cuda()
    return {**checks, "decode_profile": prof}


def _moe_engines(cfg, params, chain: Path) -> dict:
    """A graphed and an eager full-width engine from one state (8 rows
    admitted): 8 steps whose logits must be the same bits, the graphed
    one publishing a SYNC snapshot chain; a replica built in process from
    that chain decodes the in-flight requests token for token with no
    prefill; one decode step through the kernel against the plain
    attention; and where a decode step's time goes."""
    import numpy as np
    import torch
    from repro_torch.core.session import InSituPlan, Session
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.serving import snapshot as S
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    if chain.exists():
        shutil.rmtree(chain)
    geo = dict(num_pages=33, page_size=16, max_reqs=8, prompt_len=16,
               max_len=64)
    engines = {}
    for graph in (True, False):
        e = engines[graph] = PagedServingEngine(cfg, params, device="cuda",
                                                cuda_graph=graph, **geo)
        rng = np.random.default_rng(5)
        for i in range(8):
            assert e.admit(Request(i, rng.integers(0, cfg.vocab_size, 16),
                                   max_new=48))
    eng, eng_eager = engines[True], engines[False]
    plan = InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {"kv_snapshot": {
            "stream": "kv_pages", "preset": "serve_snapshot", "every": 4,
            "placement": "sync",
            "options": {"base_every": 8, "codec": "none",
                        "directory": str(chain)}}}})
    with Session(plan, raise_on_error=True) as session:
        for step in range(8):
            eng.step()
            eng_eager.step()
            if not torch.equal(eng.logits, eng_eager.logits):
                raise AssertionError(f"moe: graphed and eager decode logits "
                                     f"differ at step {step}")
            session.emit("kv_pages", step + 1, eng.snapshot_payload)
    log("moe: 8 full-width decode steps (8 rows), graph replay and eager "
        "step: logits bitwise equal")

    t0 = time.perf_counter()
    step, leaves = S.SnapshotStore(str(chain)).restore("kv_pages")
    replica = PagedServingEngine.from_snapshot(cfg, params, leaves,
                                               device="cuda")
    hydrate_s = time.perf_counter() - t0
    assert step == 8, step         # the state after the 8th step
    live = [a for a in replica.active if a is not None]
    assert [r.out for r in live] == [r.out for r in eng.active], \
        "replica restored other requests"
    pre = replica.prefill_tokens
    for _ in range(6):
        eng.step()
        replica.step()
    for a, b in zip(eng.active, live):
        assert a.out == b.out, f"replica diverged on request {a.rid}"
    assert replica.prefill_tokens == pre, "replica prefilled"
    log(f"moe: replica from_snapshot of the chain's step {step} "
        f"({hydrate_s:.2f} s, graph captured) decodes the 8 in-flight "
        f"requests token for token over 6 steps, no prefill")
    del replica, live
    _free_cuda()

    def plain_f32(q, k, v, table, length):
        return PK.paged_decode_attention_plain(
            q.float(), k.float(), v.float(), table, length).to(q.dtype)

    # one full-width step driven by the plain attention, the kernel held
    # against it at every layer on that layer's own inputs
    layer_err, with_plain, with_kernel = _kernel_against_plain(
        cfg, eng, cfg.n_layers)
    with_f32 = _one_step(cfg, eng, plain_f32)
    spread = {name: {"max_abs": (x - y).abs().max().item(),
                     "argmax_agreement":
                         (x.argmax(-1) == y.argmax(-1)).float().mean().item()}
              for name, x, y in (("kernel_plain", with_kernel, with_plain),
                                 ("kernel_plain_f32", with_kernel, with_f32),
                                 ("plain_plain_f32", with_plain, with_f32))}
    log(f"moe: one full-width decode step: the kernel against the plain "
        f"attention at each of the {cfg.n_layers} layers, max "
        f"{max(layer_err):.3e} (<= {BF16_ATOL}); the step's logits "
        f"(range {with_plain.min().item():.2f}..{with_plain.max().item():.2f}"
        f"), max |dlogit| and argmax agreement: {spread}")

    # the graphed step profiled; the eager one's host wall beside it (its
    # device work is the same kernels)
    prof = device_profile(eng.step, 5)
    prof["wall_ms_unprofiled"] = host_wall_ms(eng.step, 5)
    prof["device_idle_share_unprofiled"] = (
        1 - prof["device_busy_ms"] / prof["wall_ms_unprofiled"])
    prof["paged_launches_recorded"] = sum(
        c for op, c in prof["launches"].items()
        if "paged_decode_kernel" in op)
    prof["eager_wall_ms"] = host_wall_ms(eng_eager.step, 5)
    log(f"moe: decode step (graph, 8 rows, full width): "
        f"{prof['wall_ms_unprofiled']:.3f} ms host wall (eager "
        f"{prof['eager_wall_ms']:.3f}), device busy {prof['device_busy_ms']} "
        f"ms, idle share {prof['device_idle_share_unprofiled']}, "
        f"{prof['host_aten_ops']:.0f} aten ops")
    for op, ms in prof["top"][:5]:
        log(f"moe:   {ms * 1e3:9.1f} us/step  {op[:90]}")
    prof.pop("launches")
    prof.pop("per_launch_ms")
    return {"layer_attention_max_abs_err": max(layer_err),
            "logit_spread": spread, "replica_hydrate_s": hydrate_s,
            "decode_profile": prof}


def _moe_serve(build: Path) -> dict:
    """(a): full-width serving of moonshot-v1-16b-a3b on SERVE's traffic,
    three runs (:data:`SERVE_RUNS`) through :func:`_serve_runs`, then the
    engine checks."""
    from repro_torch.configs import base as configs

    cfg = configs.get(MOE_ARCH)
    out = _serve_runs("moe", MOE_ARCH, SERVE_RUNS, build, cfg.n_layers)
    params, draw = _draw_full("moe", cfg)
    checks = _moe_engines(cfg, params, build / "smoke_moe_replica")
    del params
    _free_cuda()
    return {**out, **draw, **checks}


def _moe_kernel() -> dict:
    """(b): kernel 1 at moonshot's heads (16 kv heads of 128, one query
    head each), and head groups changing no bit at smollm's."""
    import torch
    from repro_torch.kernels import paged_attention as PK

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(4321)   # the cases drawn on the
    out: dict = {}                                  # card: 0.5 GB at 256 pages
    shapes = {"serve": dict(b=8, hq=16, n_kv=16, d=128, ps=16, pps=4),
              "long": dict(b=8, hq=16, n_kv=16, d=128, ps=16, pps=256)}
    _, c_bytes = PK._entry()
    for name, shp in shapes.items():
        full = shp["ps"] * shp["pps"]
        lengths = [0, 1, 16, 17, full, full, full // 2 + 3, full - 1]
        for dtype, ps in ((torch.bfloat16, 16), (torch.float32, 16),
                          (torch.float32, 8))[:3 if name == "serve" else 2]:
            case = dict(shp, ps=ps)
            args = _paged_case(gen, lengths=[min(n, ps * shp["pps"])
                                             for n in lengths],
                               dtype=dtype, dev=dev, **case)
            got = PK.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = PK.paged_decode_attention_plain(*args)
            tol = (F32_TOL if dtype == torch.float32
                   else dict(rtol=0.0, atol=BF16_ATOL))
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            err = (got.float() - ref.float()).abs().max().item()
            splits, per = PK.split_plan(shp["pps"], ps, shp["b"], 16)
            n_h = PK.head_group(16, 1, 128, 128, ps, args[0].element_size(),
                                per)
            assert c_bytes(n_h, 1, 128, 128, ps, args[0].element_size(),
                           per) == PK.smem_bytes(
                n_h, 1, 128, 128, ps, args[0].element_size(), per)
            out[f"{name}_{str(dtype)[6:]}_ps{ps}"] = {
                "max_abs_err": err, "splits": splits, "per": per,
                "heads_per_cta": n_h}
            log(f"moe kernel {name} {str(dtype)[6:]} page {ps}: {splits} "
                f"splits of {per} pages x {16 // n_h} groups of {n_h} kv "
                f"heads, max |kernel - plain| = {err:.3e}")
        args = _paged_case(gen, lengths=[full] * shp["b"],
                           dtype=torch.bfloat16, dev=dev, **shp)
        ref = PK.paged_decode_attention_plain(*args)
        err = (PK.paged_decode_attention(*args).float()
               - ref.float()).abs().max().item()
        k_ms = time_ms(lambda: PK.paged_decode_attention(*args))
        p_ms = time_ms(lambda: PK.paged_decode_attention_plain(*args))
        lib_ms = time_ms(_sdpa_call(*args))
        b_ms, b_by = bound_ms("paged_decode_attention", *args)
        dev_ms, dev_ops = kernel_device_ms(
            lambda: PK.paged_decode_attention(*args),
            ("paged_decode_kernel", "paged_combine_kernel"), 10)
        out[name] = {"shape": dict(shp, len=full, dtype="bfloat16"),
                     "max_abs_err": err, "ms": k_ms, "device_ms": dev_ms,
                     "device_ops": dev_ops, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by,
                     "heads_per_cta": out[f"{name}_bfloat16_ps16"][
                         "heads_per_cta"]}
        log(f"moe kernel {name} timing (bf16, B=8, len={full}): kernel "
            f"{k_ms:.4f} ms per call (device {dev_ms} ms), plain "
            f"{p_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
    # smollm's heads: one group by the plan; every group that fits gives
    # the same bits
    for width in (4, 256):
        shp = _serve_shape(width)
        full = shp["ps"] * width
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_case(gen, lengths=[0, 1, 17, full // 2, full - 1,
                                             full, full, 3],
                               dtype=dtype, dev=dev, **shp)
            _, per = PK.split_plan(width, shp["ps"], shp["b"], 3)
            elem = args[0].element_size()
            assert PK.head_group(3, 3, 64, 64, shp["ps"], elem, per) == 3
            assert (PK.staging(1, 3, 64, 64, shp["ps"], elem, per)[0]
                    == PK.staging(3, 3, 64, 64, shp["ps"], elem, per)[0])
            bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16
                                    else torch.int32)
            first = bits(PK.paged_decode_attention(*args)).clone()
            assert torch.equal(bits(PK.paged_decode_attention(*args, n_h=1)),
                               first), ("head groups changed bits", width)
    log("moe kernel: smollm's shapes keep one group of 3 kv heads; three "
        "groups of one (the same pages a round) give the same output bits "
        "(bf16, f32, 4 and 256 pages)")
    return out


def _moe_smoke() -> dict:
    """(c): both archs at smoke size in f32: the dense engine and a paged
    engine decode SERVE's traffic token for token, and the paged decode
    step replayed equals the eager step bitwise."""
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.pages import PagedServingEngine

    out = {}
    for arch in (MOE_ARCH, "deepseek-v3-671b"):
        cfg = dataclasses.replace(configs.get(arch, smoke=True),
                                  dtype="float32")
        params = P.cast_tree(P.materialize(torch.Generator().manual_seed(0),
                                           transformer.param_spec(cfg),
                                           "cuda"), torch.float32)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, 16)
                   for _ in range(SERVE["n_requests"])]
        streams = {}
        for kind in ("dense", "paged"):
            reqs = [Request(i, pr, max_new=SERVE["max_new"])
                    for i, pr in enumerate(prompts)]
            if kind == "dense":
                eng = ServingEngine(cfg, params, slots=SERVE["slots"],
                                    prompt_len=16, max_len=64, device="cuda")
            else:
                eng = PagedServingEngine(
                    cfg, params, num_pages=SERVE["num_pages"],
                    page_size=SERVE["page_size"], max_reqs=SERVE["slots"],
                    prompt_len=16, max_len=64, device="cuda")
            assert eng._graph is not None, kind
            eng.run(reqs, max_steps=1024)
            assert all(r.done and len(r.out) == r.max_new for r in reqs)
            streams[kind] = [r.out for r in reqs]
        assert streams["dense"] == streams["paged"], (
            f"{arch}: f32 dense and paged engines decoded different tokens")
        engines = {}
        for graph in (True, False):
            e = engines[graph] = PagedServingEngine(
                cfg, params, num_pages=33, page_size=16, max_reqs=8,
                prompt_len=16, max_len=64, device="cuda", cuda_graph=graph)
            rng = np.random.default_rng(5)
            for i in range(8):
                assert e.admit(Request(i, rng.integers(0, cfg.vocab_size,
                                                       16), max_new=32))
        for _ in range(8):
            engines[True].step()
            engines[False].step()
            assert torch.equal(engines[True].logits, engines[False].logits), (
                f"{arch}: replayed and eager decode steps differ")
        out[arch] = {"tokens": sum(map(len, streams["dense"]))}
        log(f"moe smoke {arch} (f32): dense and paged engines decode "
            f"{out[arch]['tokens']} tokens token for token; 8 replayed "
            f"decode steps bitwise the eager ones")
        del engines, eng, params
        _free_cuda()
    return out


def moe_phase(build: Path) -> dict:
    """The MoE family on the card (see the module docstring, phase 12)."""
    _free_cuda()
    t0 = time.perf_counter()
    kern = _moe_kernel()
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoke = _moe_smoke()
    smoke_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = _moe_serve(build)
    serve_s = time.perf_counter() - t0
    log(f"moe phase parts: kernel {kernel_s:.1f} s, smoke {smoke_s:.1f} s, "
        f"full-width serve {serve_s:.1f} s")
    return {"kernel": kern, "smoke": smoke, "serve": serve,
            "part_s": {"kernel": kernel_s, "smoke": smoke_s,
                       "serve": serve_s}}


# ---------------------------------------------------------------------------
# hybrid phase
# ---------------------------------------------------------------------------

HYBRID_ARCH = "hymba-1.5b"
# the long run: rings of 1024 slots wrap in decode; 68 pages a row
HYBRID_LONG = dict(n_requests=8, prompt=1000, max_new=64, max_len=1088)


def _hybrid_kernel() -> dict:
    """(a): kernel 1 at hymba's heads (25 query heads over 5 kv heads of
    64: one CTA holds all 25, more than its 16 warps)."""
    import torch
    from repro_torch.kernels import paged_attention as PK

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2323)
    out: dict = {}
    shapes = {"serve": dict(b=8, hq=25, n_kv=5, d=64, ps=16, pps=4),
              "long": dict(b=8, hq=25, n_kv=5, d=64, ps=16, pps=256)}
    _, c_bytes = PK._entry()
    for name, shp in shapes.items():
        full = shp["ps"] * shp["pps"]
        lengths = [0, 1, 16, 17, full, full, full // 2 + 3, full - 1]
        splits, per = PK.split_plan(shp["pps"], 16, shp["b"], 5)
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_case(gen, lengths=lengths, dtype=dtype, dev=dev,
                               **shp)
            got = PK.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = PK.paged_decode_attention_plain(*args)
            tol = (F32_TOL if dtype == torch.float32
                   else dict(rtol=0.0, atol=BF16_ATOL))
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            err = (got.float() - ref.float()).abs().max().item()
            elem = args[0].element_size()
            n_h = PK.head_group(5, 5, 64, 64, 16, elem, per)
            assert n_h == 5, n_h
            assert c_bytes(n_h, 5, 64, 64, 16, elem, per) == PK.smem_bytes(
                n_h, 5, 64, 64, 16, elem, per)
            out[f"{name}_{str(dtype)[6:]}"] = {
                "max_abs_err": err, "splits": splits, "per": per,
                "heads_per_cta": n_h * 5}
            log(f"hybrid kernel {name} {str(dtype)[6:]}: {splits} splits of "
                f"{per} pages, one group of 5 kv heads (25 query heads a "
                f"CTA), max |kernel - plain| = {err:.3e}")
        args = _paged_case(gen, lengths=[full] * shp["b"],
                           dtype=torch.bfloat16, dev=dev, **shp)
        ref = PK.paged_decode_attention_plain(*args)
        err = (PK.paged_decode_attention(*args).float()
               - ref.float()).abs().max().item()
        k_ms = time_ms(lambda: PK.paged_decode_attention(*args))
        p_ms = time_ms(lambda: PK.paged_decode_attention_plain(*args))
        lib_ms = time_ms(_sdpa_call(*args))
        b_ms, b_by = bound_ms("paged_decode_attention", *args)
        dev_ms, dev_ops = kernel_device_ms(
            lambda: PK.paged_decode_attention(*args),
            ("paged_decode_kernel", "paged_combine_kernel"), 10)
        out[name] = {"shape": dict(shp, len=full, dtype="bfloat16"),
                     "max_abs_err": err, "ms": k_ms, "device_ms": dev_ms,
                     "device_ops": dev_ops, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "splits": splits,
                     "pages_per_split": per}
        log(f"hybrid kernel {name} timing (bf16, B=8, len={full}): kernel "
            f"{k_ms:.4f} ms per call (device {dev_ms} ms), plain "
            f"{p_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
    return out


def _smoke_in_lockstep(tag: str, cfg, params, prompts, geo: dict,
                       chain: Path, check_leaves) -> dict:
    """A recurrent family at smoke size on SERVE's traffic (``prompts``,
    ``geo`` the engines' prompt_len and max_len): the dense 4-slot engine
    = a 4-row paged engine token for token; a graphed and an eager 8-row
    paged engine from one state decode the same tokens, the graphed one
    publishing a SYNC chain under ``chain`` (``check_leaves`` gets its
    restored leaves); a replica restored from it into a captured engine
    decodes in lockstep, with no prefill."""
    import torch
    from repro_torch.core.session import InSituPlan, Session
    from repro_torch.serving import snapshot as S
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.pages import PagedServingEngine

    pages = -(-(geo["prompt_len"] + SERVE["max_new"]) // 16)
    streams = {}
    for kind in ("dense", "paged"):
        reqs = [Request(i, pr, max_new=SERVE["max_new"])
                for i, pr in enumerate(prompts)]
        if kind == "dense":
            eng = ServingEngine(cfg, params, slots=SERVE["slots"],
                                device="cuda", **geo)
        else:
            eng = PagedServingEngine(cfg, params,
                                     num_pages=SERVE["slots"] * pages + 1,
                                     page_size=16, max_reqs=SERVE["slots"],
                                     device="cuda", **geo)
        assert eng._graph is not None, kind
        eng.run(reqs, max_steps=1024)
        assert all(r.done and len(r.out) == r.max_new for r in reqs)
        streams[kind] = [r.out for r in reqs]
    assert streams["dense"] == streams["paged"], (
        f"{tag}: f32 dense and paged engines decoded different tokens")
    del eng

    if chain.exists():
        shutil.rmtree(chain)
    engines, reqs = {}, {}
    for graph in (True, False):
        e = engines[graph] = PagedServingEngine(
            cfg, params, num_pages=8 * pages + 1, page_size=16, max_reqs=8,
            device="cuda", cuda_graph=graph, **geo)
        reqs[graph] = [Request(i, prompts[i], max_new=SERVE["max_new"])
                       for i in range(8)]
        for r in reqs[graph]:
            assert e.admit(r)
    eng, eng_eager = engines[True], engines[False]
    plan = InSituPlan.from_dict({
        "streams": ["kv_pages"],
        "tasks": {"kv_snapshot": {
            "stream": "kv_pages", "preset": "serve_snapshot", "every": 4,
            "placement": "sync",
            "options": {"base_every": 8, "codec": "none",
                        "directory": str(chain)}}}})
    bitwise = True
    with Session(plan, raise_on_error=True) as session:
        for step in range(12):
            eng.step()
            eng_eager.step()
            bitwise &= torch.equal(eng.logits, eng_eager.logits)
            session.emit("kv_pages", step + 1, eng.snapshot_payload)
    step, leaves = S.SnapshotStore(str(chain)).restore("kv_pages")
    assert step == 12, step
    check_leaves(leaves)
    replica = PagedServingEngine.from_snapshot(cfg, params, leaves,
                                               device="cuda")
    assert replica._graph is not None
    live = [a for a in replica.active if a is not None]
    pre = replica.prefill_tokens
    while any(a is not None for a in eng.active):
        for e in (eng, eng_eager, replica):
            e.step()
        bitwise &= torch.equal(eng.logits, eng_eager.logits)
    want = [r.out for r in reqs[True]]
    assert all(r.done for r in reqs[True] + reqs[False] + live)
    assert [r.out for r in reqs[False]] == want, (
        f"{tag}: graphed and eager paged engines decoded different tokens")
    assert [r.out for r in live] == want, f"{tag}: the replica left lockstep"
    assert replica.prefill_tokens == pre, "replica prefilled"
    del engines, eng, eng_eager, replica, leaves
    _free_cuda()
    shutil.rmtree(chain, ignore_errors=True)
    return {"tokens": sum(map(len, streams["dense"])),
            "graph_eager_logits_bitwise": bitwise, "restored_step": step}


def _hybrid_smoke(chain: Path) -> dict:
    """(b): hymba at smoke size in f32, 40-token prompts past its 32-token
    window and 32 new tokens (the ring wraps in prefill and again in
    decode), through :func:`_smoke_in_lockstep`."""
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get(HYBRID_ARCH, smoke=True),
                              dtype="float32")
    assert cfg.swa_window == 32
    params = P.cast_tree(P.materialize(torch.Generator().manual_seed(0),
                                       transformer.param_spec(cfg), "cuda"),
                         torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 40)
               for _ in range(SERVE["n_requests"])]

    def check_leaves(leaves):
        assert any(k.startswith("['state']['ssm_swa']") for k in leaves)

    out = _smoke_in_lockstep("hybrid", cfg, params, prompts,
                             dict(prompt_len=40, max_len=80), chain,
                             check_leaves)
    log(f"hybrid smoke (f32, window 32, 40-token prompts + 32 new): dense "
        f"and paged engines decode {out['tokens']} tokens token for token; "
        f"graphed = eager over {SERVE['max_new'] - 1} decode steps of 8 "
        f"rows (logits bitwise: {out['graph_eager_logits_bitwise']}); a "
        f"SYNC chain restored at step {out['restored_step']} into a "
        f"captured replica decodes the 8 requests in lockstep, no prefill")
    del params
    _free_cuda()
    return out


def _hybrid_serve(build: Path) -> dict:
    """(c): full-width serving of hymba-1.5b on SERVE's traffic, three
    runs (:data:`SERVE_RUNS`) through :func:`_serve_runs` (the kernel at
    its 3 global layers), then the engine checks and the long run."""
    from repro_torch.configs import base as configs

    cfg = configs.get(HYBRID_ARCH)
    out = _serve_runs("hybrid", HYBRID_ARCH, SERVE_RUNS, build,
                      cfg.n_global_layers)
    params, draw = _draw_full("hybrid", cfg)
    checks = _full_engines("hybrid", cfg, params, cfg.n_global_layers)
    long = _hybrid_long(cfg, params)
    del params
    _free_cuda()
    return {**out, **draw, **checks, "long": long}


def _hybrid_long(cfg, params) -> dict:
    """8 requests of 1000-token prompts and 64 new tokens at full width
    (max_len 1088, 68 pages a row): the SWA rings of 1024 slots wrap in
    decode, and the global layers' kernel reads ~63-67 pages a row. The
    graphed engine runs them to the end (launches = steps x global
    layers); an eager engine from the same admissions decodes the same
    tokens over the first 8 steps; the kernel is held against the plain
    attention at each global layer of one step."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    L = HYBRID_LONG
    max_len = L["max_len"]
    assert L["prompt"] + L["max_new"] > cfg.swa_window   # the ring wraps
    assert max_len > cfg.swa_window                      # rings of 1024
    geo = dict(num_pages=L["n_requests"] * (max_len // 16) + 1,
               page_size=16, max_reqs=L["n_requests"],
               prompt_len=L["prompt"], max_len=max_len)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, L["prompt"])
               for _ in range(L["n_requests"])]
    engines, reqs = {}, {}
    t0 = time.perf_counter()
    for graph in (True, False):
        e = engines[graph] = PagedServingEngine(cfg, params, device="cuda",
                                                cuda_graph=graph, **geo)
        reqs[graph] = [Request(i, p, max_new=L["max_new"])
                       for i, p in enumerate(prompts)]
        for r in reqs[graph]:
            assert e.admit(r)
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    eng, eng_eager = engines[True], engines[False]
    assert eng.state["swa_kv"]["k"].shape[2] == cfg.swa_window
    bitwise = True
    for _ in range(8):
        eng.step()
        eng_eager.step()
        bitwise &= torch.equal(eng.logits, eng_eager.logits)
    assert [r.out for r in reqs[True]] == [r.out for r in reqs[False]], (
        "hybrid long: graphed and eager engines decoded different tokens")
    del engines[False], eng_eager
    _free_cuda()
    checks = _kernel_checks(cfg, eng, cfg.n_global_layers)
    PK.paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while any(a is not None for a in eng.active):
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = PK.paged_decode_attention.launches
    assert launches == steps * cfg.n_global_layers, (launches, steps)
    for r in reqs[True]:
        assert r.done and len(r.out) == L["max_new"], r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out), r.rid
    log(f"hybrid long (8 x {L['prompt']} + {L['max_new']} tokens, "
        f"max_len {max_len}): admissions {admit_s:.2f} s for both engines; "
        f"graphed = eager tokens over 8 steps (logits bitwise: {bitwise}); "
        f"the kernel against the plain attention at the global layers "
        f"{checks['layer_attention_max_abs_err']}; {steps} more replayed "
        f"steps in {run_s:.2f} s, {launches} launches = {steps} x "
        f"{cfg.n_global_layers}; the rings wrapped at {cfg.swa_window}")
    del engines, eng
    _free_cuda()
    return {"max_len": max_len, "admit_s_both_engines": admit_s,
            "graph_eager_logits_bitwise": bitwise, "steps": steps,
            "launches": launches, "replayed_steps_s": run_s,
            "ms_per_step": run_s * 1e3 / max(steps, 1), **checks}


def hybrid_phase(build: Path) -> dict:
    """The hybrid family on the card (see the module docstring, phase
    13)."""
    _free_cuda()
    t0 = time.perf_counter()
    kern = _hybrid_kernel()
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoke = _hybrid_smoke(build / "smoke_hybrid_replica")
    smoke_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = _hybrid_serve(build)
    serve_s = time.perf_counter() - t0
    log(f"hybrid phase parts: kernel {kernel_s:.1f} s, smoke {smoke_s:.1f} "
        f"s, full-width serve {serve_s:.1f} s")
    return {"kernel": kern, "smoke": smoke, "serve": serve,
            "part_s": {"kernel": kernel_s, "smoke": smoke_s,
                       "serve": serve_s}}


# ---------------------------------------------------------------------------
# xlstm phase
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-1.3b"
# the long prefill: 8 mLSTM chunks of 128 and 1024 sLSTM steps a request
XLSTM_LONG = dict(n_requests=2, prompt=1024, max_new=32, steps=8)
XLSTM_C_KEY = "['state']['mlstm']['c']"
DIGEST_PIECE = 256 << 20          # bytes a sha256 covers in a leaf's digest
ZLIB_PROBE = 64 << 20             # bytes of c the zlib rate is measured on


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _rss_gib() -> dict:
    """This process's resident set now and at its peak."""
    import resource

    now = None
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                now = int(ln.split()[1]) / 2**20
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return {"rss_gib": now, "peak_rss_gib": peak}


def _leaf_digest(arr, pool) -> list:
    """sha256 of each DIGEST_PIECE-byte piece of a leaf's bytes, hashed on
    ``pool``'s threads (hashlib releases the GIL on large buffers)."""
    import hashlib

    import numpy as np

    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    pieces = [raw[i:i + DIGEST_PIECE] for i in range(0, raw.size,
                                                     DIGEST_PIECE)]
    return list(pool.map(lambda p: hashlib.sha256(p).hexdigest(), pieces))


def _xlstm_cfgs(smoke_cfg) -> dict:
    """The smoke config and its 8-block variant with one sLSTM per 4
    (three mLSTM layers a super-block), both in f32."""
    per3 = dataclasses.replace(
        smoke_cfg, n_layers=8,
        xlstm=dataclasses.replace(smoke_cfg.xlstm, slstm_every=4))
    return {name: dataclasses.replace(c, dtype="float32")
            for name, c in (("smoke", smoke_cfg), ("per3", per3))}


def _xlstm_smoke(chain: Path) -> dict:
    """(a): the smoke config and its 8-block variant in f32, 32-token
    prompts (two mLSTM chunks of 16) and 32 new tokens, through
    :func:`_smoke_in_lockstep`; the chain holds state leaves only."""
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    out = {}
    for name, cfg in _xlstm_cfgs(configs.get(XLSTM_ARCH, smoke=True)).items():
        params = P.cast_tree(P.materialize(
            torch.Generator().manual_seed(0), transformer.param_spec(cfg),
            "cuda"), torch.float32)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, 32)
                   for _ in range(SERVE["n_requests"])]

        def check_leaves(leaves, cfg=cfg):
            assert not any(k.startswith("['pool']") for k in leaves)
            assert leaves[XLSTM_C_KEY].shape[:3] == (
                cfg.n_layers // cfg.xlstm.slstm_every,
                cfg.xlstm.slstm_every - 1, 8)

        out[name] = _smoke_in_lockstep(
            f"xlstm {name}", cfg, params, prompts,
            dict(prompt_len=32, max_len=64), chain / name, check_leaves)
        log(f"xlstm smoke {name} ({cfg.n_layers} blocks, "
            f"{cfg.xlstm.slstm_every - 1} mLSTM a super-block, f32, "
            f"32-token prompts + 32 new): dense and paged engines decode "
            f"{out[name]['tokens']} tokens token for token; graphed = eager "
            f"over {SERVE['max_new'] - 1} decode steps of 8 rows (logits "
            f"bitwise: {out[name]['graph_eager_logits_bitwise']}); a SYNC "
            f"chain of state leaves only, restored at step "
            f"{out[name]['restored_step']} into a captured replica, decodes "
            f"the 8 requests in lockstep, no prefill")
        del params
        _free_cuda()
    return out


def _xlstm_snapshot_plan(chain: Path) -> dict:
    """``default_serve_plan``'s async plan changed for a 5.65 GB payload
    (the default bounds no host memory): its chain on disk, one chain
    kept, one worker and a staging ring of one, so at most two firings
    are in flight (each holds a pinned host copy of the whole state) and
    the rest drop; frames stored raw (``codec="none"``), as zlib at the host's rate would take
    a minute a firing (measured on a slice: ``zlib_probe``); and every
    frame a base (``base_every=1``): the state changes everywhere each
    step, so a delta frame is all SELF chunks, as large as a base, and
    would only make a restore read two frames."""
    from repro_torch.launch.serve import default_serve_plan

    if chain.exists():
        shutil.rmtree(chain)
    plan = default_serve_plan(snapshot_dir=str(chain), codec="none",
                              base_every=1, p_i=1)
    plan["staging_capacity"] = 1
    plan["tasks"]["kv_snapshot"]["options"]["keep_chains"] = 1
    return plan


def _zlib_probe(published: dict) -> dict:
    """zlib (the default plan's codec) on ZLIB_PROBE bytes of ``c`` from
    the last two published firings: base and delta frame sizes and
    seconds on the codec pool, and the seconds a whole firing's ``c``
    would take at that rate."""
    from repro_torch.core import codecs, delta

    steps = sorted(published)
    new = published[steps[-1]]["c_probe"]
    old = published[steps[-2]]["c_probe"] if len(steps) > 1 else None
    pool = codecs.codec_pool()
    t0 = time.perf_counter()
    base, _ = delta.encode(new, None, codec="zlib", pool=pool)
    base_s = time.perf_counter() - t0
    out = {"probe_bytes": new.nbytes, "base_bytes": len(base),
           "base_s": base_s,
           "c_base_firing_s_at_this_rate":
               base_s * published[steps[-1]]["c_bytes"] / new.nbytes}
    if old is not None:
        t0 = time.perf_counter()
        dlt, st = delta.encode(new, old, codec="zlib", pool=pool)
        delta_s = time.perf_counter() - t0
        out.update({"delta_bytes": len(dlt), "delta_s": delta_s,
                    "delta_chunks": {"copy": st.n_copy, "xor": st.n_xor,
                                     "self": st.n_self},
                    "c_delta_firing_s_at_this_rate":
                        delta_s * published[steps[-1]]["c_bytes"]
                        / new.nbytes})
    return out


def _xlstm_serve(build: Path) -> dict:
    """(b): full-width serving of xlstm-1.3b on SERVE's traffic, three
    runs (:data:`SERVE_RUNS`), the chain checked against the digests of
    the published firings; then the decode step profiled."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.launch.serve import serve_loop
    from repro_torch.serving import snapshot as S

    cfg = configs.get(XLSTM_ARCH)
    chain = build / "smoke_xlstm_chain"
    published: dict = {}
    hasher = ThreadPoolExecutor(max_workers=8, thread_name_prefix="digest")
    publish = S.SnapshotStore.publish

    def recording_publish(store, stream, step, tree, **kw):
        t0 = time.perf_counter()
        rec = publish(store, stream, step, tree, **kw)
        publish_s = time.perf_counter() - t0
        if rec.kind in ("base", "delta"):
            leaves = store._streams[stream].last_leaves
            c = leaves[XLSTM_C_KEY]
            published[step] = {
                "kind": rec.kind, "raw_bytes": rec.raw_bytes,
                "stored_bytes": rec.stored_bytes, "publish_s": publish_s,
                "digests": {k: _leaf_digest(a, hasher)
                            for k, a in leaves.items()},
                "c_bytes": c.nbytes,
                "c_probe": c.reshape(-1)[:ZLIB_PROBE // 4].copy()}
        return rec

    runs, lines, peak, mem, tail = {}, [], {}, {}, {}
    launches_before = _family_tool().launches()
    t_runs = time.perf_counter()
    for key in SERVE_RUNS:
        graph = key[1]
        name = f"{'graph' if graph else 'eager'}_{key[0]}"
        plan = (_xlstm_snapshot_plan(chain) if key[0] == "plan"
                else {"streams": ["kv_pages"]})
        mem[name] = {"mem_available_gib_before": _mem_available_gib()}
        torch.cuda.reset_peak_memory_stats()
        S.SnapshotStore.publish = recording_publish
        try:
            runs[key] = serve_loop(
                XLSTM_ARCH, smoke=False, device="cuda", seed=0, plan=plan,
                cuda_graph=graph, log=lines.append, **SERVE)
        finally:
            S.SnapshotStore.publish = publish
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        mem[name].update(_rss_gib())
        mem[name]["mem_available_gib_after"] = _mem_available_gib()
        r = runs[key]
        rep = r["session_report"]
        parts = (r["telemetry"].total("serve/admit"), rep["step_compute_s"],
                 rep["handoff_dispatch_s"], rep["sync_stall_s"])
        tail[name] = _serve_wall_s(r) - sum(parts)
        log(f"xlstm: serve {name}: {r['tok_per_s']:.1f} tok/s, wall "
            f"{_serve_wall_s(r):.2f} s = admissions {parts[0]:.2f} + decode "
            f"steps {parts[1]:.2f} + hand-off dispatch {parts[2]:.2f} + "
            f"sync stall {parts[3]:.2f} + the rest {tail[name]:.2f} (with "
            f"snapshots: the session's end waiting for the firings in "
            f"flight); peak {peak[name]:.2f} GiB on the card; host "
            f"{mem[name]}")
        _free_cuda(empty=False)
    hasher.shutdown()
    launches = {k: v - launches_before[k]
                for k, v in _family_tool().launches().items()}
    streams = {k: [r.out for r in run["requests"]] for k, run in runs.items()}
    for key, got in streams.items():
        assert got == streams["plan", True], (
            f"xlstm serve run {key} decoded other tokens than the graphed run "
            f"with snapshots")
    out = runs["plan", True]
    for r in out["requests"]:
        assert r.done and len(r.out) == r.max_new, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out), r.rid
    pools = [m for m in (re.match(r"page pool: (\d+)/", ln) for ln in lines)
             if m]
    assert len(pools) == len(SERVE_RUNS) and all(
        int(m.group(1)) == 0 for m in pools), "reserved pages not returned"
    rep = out["session_report"]
    snap = rep["tasks"]["kv_snapshot"]
    assert rep["n_errors"] == 0, rep["errors"]
    assert snap["publishes"] > 0 and published, "no snapshot published"
    decode_steps = len(out["telemetry"].spans("step/compute"))
    eager = runs["bare", False]
    eager_step_ms = (eager["session_report"]["step_compute_s"] * 1e3
                     / len(eager["telemetry"].spans("step/compute")))
    log(f"xlstm: the three runs decode the same {SERVE['n_requests']} "
        f"streams; {decode_steps} decode steps in the graphed run with "
        f"snapshots; kernel launches over the runs {launches}")

    runs_s = time.perf_counter() - t_runs
    frames = sorted((p.name, p.stat().st_size)
                    for p in (chain / "kv_pages").iterdir())
    t0 = time.perf_counter()
    step, leaves = S.SnapshotStore(str(chain)).restore("kv_pages")
    restore_s = time.perf_counter() - t0
    assert step in published, (step, sorted(published))
    want = published[step]["digests"]
    assert list(leaves) == list(want), "restored leaf keys differ"
    assert not any(k.startswith("['pool']") for k in leaves)
    with ThreadPoolExecutor(max_workers=8) as pool:
        for key, arr in leaves.items():
            if _leaf_digest(arr, pool) != want[key]:
                raise AssertionError(f"{chain.name}: restored leaf {key} "
                                     f"differs at step {step}")
    restored = {"step": step, "restore_s": restore_s,
                "bytes": sum(a.nbytes for a in leaves.values()),
                "state_bytes": sum(a.nbytes for k, a in leaves.items()
                                   if k.startswith("['state']")),
                "c_bytes": leaves[XLSTM_C_KEY].nbytes}
    del leaves
    zlib_probe = _zlib_probe(published)
    firings = {s: {k: v for k, v in p.items()
                   if k not in ("digests", "c_probe")}
               for s, p in sorted(published.items())}
    published.clear()
    shutil.rmtree(chain, ignore_errors=True)
    log(f"xlstm: the graphed run's chain restores bit-identically (sha256 of "
        f"every {DIGEST_PIECE >> 20} MiB of every leaf) to the firing "
        f"published at step {step}: {restored}; published firings "
        f"{firings}; frames on disk {frames}; zlib on {ZLIB_PROBE >> 20} MiB "
        f"of c: {zlib_probe}")
    tok_s = {f"{'graph' if g else 'eager'}_{k}": r["tok_per_s"]
             for (k, g), r in runs.items()}
    log(f"xlstm: tok/s {tok_s}")
    return {"tok_per_s_by_run": tok_s, "peak_gib_by_run": peak,
            "host_memory_by_run": mem,
            "wall_s_by_run": {f"{'graph' if g else 'eager'}_{k}":
                              _serve_wall_s(r) for (k, g), r in runs.items()},
            "admit_s_by_run": {f"{'graph' if g else 'eager'}_{k}":
                               r["telemetry"].total("serve/admit")
                               for (k, g), r in runs.items()},
            "step_compute_s_by_run": {
                f"{'graph' if g else 'eager'}_{k}":
                    r["session_report"]["step_compute_s"]
                for (k, g), r in runs.items()},
            "loop_blocking_s": rep["handoff_dispatch_s"]
            + rep["sync_stall_s"],
            "handoff_dispatch_s": rep["handoff_dispatch_s"],
            "rest_s_by_run": tail,
            "decode_steps": decode_steps, "launches": launches,
            "eager_step_ms": eager_step_ms,
            "snapshot": {k: snap[k] for k in (
                "publishes", "bases", "deltas", "noops", "raw_bytes",
                "stored_bytes", "codec", "keep_chains")},
            "snapshot_drops": rep["drops"].get("kv_snapshot", 0),
            "published_firings": firings, "frames": frames,
            "restored": restored, "zlib_probe": zlib_probe,
            "runs_s": runs_s}


def _xlstm_engine(cfg, params, eager_step_ms: float) -> dict:
    """A graphed full-width engine with 8 rows admitted: where a decode
    step's time goes (the eager step's host wall is the eager serve
    run's, ``eager_step_ms``: its step computes all 8 rows too)."""
    import numpy as np
    from repro_torch.core.pytree import leaves
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    eng = PagedServingEngine(cfg, params, num_pages=33, page_size=16,
                             max_reqs=8, prompt_len=16, max_len=64,
                             device="cuda")
    rng = np.random.default_rng(5)
    for i in range(8):
        assert eng.admit(Request(i, rng.integers(0, cfg.vocab_size, 16),
                                 max_new=40))
    eng.step()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(eng.state))
    prof = device_profile(eng.step, 3)
    prof["wall_ms_unprofiled"] = host_wall_ms(eng.step, 5)
    prof["device_idle_share_unprofiled"] = (
        1 - prof["device_busy_ms"] / prof["wall_ms_unprofiled"]
        if prof["device_busy_ms"] else None)
    prof["eager_wall_ms"] = eager_step_ms
    log(f"xlstm: decode step (graph, 8 rows, full width, "
        f"{state_bytes} bytes of state): {prof['wall_ms_unprofiled']:.3f} "
        f"ms host wall (eager {eager_step_ms:.3f}, the eager serve run's "
        f"mean), device busy {prof['device_busy_ms']} ms, idle share "
        f"{prof['device_idle_share_unprofiled']}, "
        f"{prof['host_aten_ops']:.0f} aten ops")
    for op, ms in prof["top"][:6]:
        log(f"xlstm:   {ms * 1e3:9.1f} us/step  {op[:90]}")
    prof.pop("launches")
    prof.pop("per_launch_ms")
    del eng
    _free_cuda()
    return {"decode_profile": prof, "state_bytes": state_bytes}


def _xlstm_long(cfg, params) -> dict:
    """(c): 2 requests of 1024-token prompts (8 mLSTM chunks of 128, 1024
    sLSTM steps a layer) prefilled once in a graphed engine; an eager
    engine hydrated from that state; both decode the same tokens over 8
    steps (logits bitwise)."""
    import numpy as np
    import torch
    from repro_torch.serving import snapshot as S
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    L = XLSTM_LONG
    max_len = -(-(L["prompt"] + L["max_new"]) // 16) * 16
    geo = dict(num_pages=L["n_requests"] * (max_len // 16) + 1,
               page_size=16, max_reqs=L["n_requests"],
               prompt_len=L["prompt"], max_len=max_len)
    rng = np.random.default_rng(7)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, L["prompt"]),
                    max_new=L["max_new"]) for i in range(L["n_requests"])]
    eng = PagedServingEngine(cfg, params, device="cuda", **geo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        assert eng.admit(r)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    eager = PagedServingEngine.from_snapshot(
        cfg, params, S._flatten(eng.snapshot_payload()["cache"]),
        device="cuda", cuda_graph=False)
    assert eager.prefill_tokens == eng.prefill_tokens
    bitwise = True
    for _ in range(L["steps"]):
        eng.step()
        eager.step()
        bitwise &= torch.equal(eng.logits, eager.logits)
    got = [a.out for a in eager.active if a is not None]
    assert got == [r.out for r in reqs], (
        "xlstm long: graphed and eager engines decoded different tokens")
    assert all(len(r.out) == L["steps"] + 1 for r in reqs)
    log(f"xlstm long ({L['n_requests']} x {L['prompt']}-token prompts): "
        f"prefill {prefill_s:.2f} s for both; an eager engine from that "
        f"state = the graphed one over {L['steps']} steps (logits bitwise: "
        f"{bitwise})")
    del eng, eager
    _free_cuda()
    return {"prompt": L["prompt"], "n_requests": L["n_requests"],
            "prefill_s": prefill_s, "steps": L["steps"],
            "graph_eager_logits_bitwise": bitwise}


def xlstm_phase(build: Path) -> dict:
    """The xLSTM family on the card (see the module docstring, phase 14).
    Only the sLSTM cell's forward kernel runs on its path: every count is
    set to 0 first; after, it must be above 0 and every other 0."""
    from repro_torch.configs import base as configs

    _free_cuda()
    _family_tool().reset_launches()
    t0 = time.perf_counter()
    smoke = _xlstm_smoke(build / "smoke_xlstm_replica")
    smoke_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = _xlstm_serve(build)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = configs.get(XLSTM_ARCH)
    params, draw = _draw_full("xlstm", cfg)
    t1 = time.perf_counter()
    engine = _xlstm_engine(cfg, params, serve["eager_step_ms"])
    engine_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    long = _xlstm_long(cfg, params)
    long_s = time.perf_counter() - t1
    del params
    _free_cuda()
    checks_s = time.perf_counter() - t0
    launches = _family_tool().launches()
    others = _family_tool().ckpt_launches(launches)
    assert not any(others.values()), (
        f"xlstm: a kernel ran on the xLSTM path: {launches}")
    assert launches["slstm_cell"] > 0 and launches["slstm_cell_bwd"] == 0, (
        f"xlstm: the sLSTM cell's launches {launches}")
    log(f"xlstm phase parts: smoke {smoke_s:.1f} s, full-width serve "
        f"{serve_s:.1f} s, the step profiled and the long prefill "
        f"{checks_s:.1f} s ({engine_s:.1f} + {long_s:.1f}); kernel launches "
        f"over the phase: {launches}")
    return {"smoke": smoke, "serve": serve, **draw, **engine, "long": long,
            "launches": launches,
            "part_s": {"smoke": smoke_s, "serve": serve_s,
                       "checks": checks_s, "engine": engine_s,
                       "long": long_s}}


# ---------------------------------------------------------------------------
# frontend phase
# ---------------------------------------------------------------------------

FRONTEND_SERVE_ARCH = "internvl2-26b"
FRONTEND_TRAIN_ARCH = "musicgen-medium"
FRONTEND_BUDGET_S = 150.0
# kernel 1 at the frontend families' heads, and at hymba's (whose device
# ms whole-smoke windows never recorded): query heads, kv heads, head dim
FRONTEND_HEADS = {"internvl2-26b": dict(hq=48, n_kv=8, d=128),
                  "musicgen-medium": dict(hq=24, n_kv=24, d=64),
                  "hymba-1.5b": dict(hq=25, n_kv=5, d=64)}
# the musicgen-medium serve runs (plan, graphed): the graphed bare run only
# (its eager run was cut for the phase's 150 s; the engine checks hold an
# eager step against the graphed one: PERF.md section 4)
FRONTEND_AUDIO_RUNS = (("bare", True),)
# the musicgen-medium train runs, eager then graphed: steps each, cut from
# 3 for the phase's 150 s (the graphed run's replays after its first are
# profiled)
FRONTEND_TRAIN = dict(steps=2)
# a smoke forward with a prefix, f32, on the card against the CPU
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)


def _recorded_device_ms(fn, launches_made: dict, n: int = 20,
                        tries: int = 3) -> dict:
    """Device ms of one call of ``fn`` from a profiler window that recorded
    launches of every kernel of ``launches_made`` (symbol -> launches a
    call): the sum of each kernel's device time over the launches that
    window recorded. A window that recorded none of some kernel is run
    again, up to ``tries`` windows; ``device_ms`` is None if none did."""
    for attempt in range(1, tries + 1):
        ms, ops = kernel_device_ms(fn, tuple(launches_made), n)
        recorded = {sym: sum(c for op, (_, c) in ops.items() if sym in op)
                    for sym in launches_made}
        if all(recorded.values()):
            break
    return {"device_ms": ms if all(recorded.values()) else None,
            "recorded": recorded,
            "made": {sym: per * n for sym, per in launches_made.items()},
            "windows": attempt, "device_ops": ops}


def _frontend_kernel() -> dict:
    """(a): kernel 1 at internvl2-26b's heads (48 query heads over 8 kv
    heads of 128) and musicgen-medium's (24 over 24 of 64): B = 8, page
    16, the serving table of 4 pages and a 256-page one, held against the
    plain version in bf16 and f32, the head group's shared memory equal to
    the source's; timed per call and on the device beside the plain
    version, SDPA on the gathered cache and the bound. hymba's heads are
    timed the same way (the hybrid phase holds them)."""
    import torch
    from repro_torch.kernels import paged_attention as PK

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2525)
    _, c_bytes = PK._entry()
    out: dict = {}
    for arch, heads in FRONTEND_HEADS.items():
        hq, n_kv, d = heads["hq"], heads["n_kv"], heads["d"]
        group = hq // n_kv
        row = out[arch] = {}
        for name, pps in (("serve", 4), ("long", 256)):
            shp = dict(b=8, hq=hq, n_kv=n_kv, d=d, ps=16, pps=pps)
            full = 16 * pps
            splits, per = PK.split_plan(pps, 16, 8, n_kv)
            lengths = [0, 1, 16, 17, full, full, full // 2 + 3, full - 1]
            for dtype in ((torch.bfloat16, torch.float32)
                          if arch != "hymba-1.5b" else ()):
                args = _paged_case(gen, lengths=lengths, dtype=dtype,
                                   dev=dev, **shp)
                got = PK.paged_decode_attention(*args)
                torch.cuda.synchronize()
                ref = PK.paged_decode_attention_plain(*args)
                tol = (F32_TOL if dtype == torch.float32
                       else dict(rtol=0.0, atol=BF16_ATOL))
                torch.testing.assert_close(got.float(), ref.float(), **tol)
                err = (got.float() - ref.float()).abs().max().item()
                elem = args[0].element_size()
                for g in range(1, n_kv + 1):
                    if n_kv % g == 0:
                        a = (g, group, d, d, 16, elem, per)
                        assert c_bytes(*a) == PK.smem_bytes(*a), a
                n_h = PK.head_group(n_kv, group, d, d, 16, elem, per)
                smem = PK.smem_bytes(n_h, group, d, d, 16, elem, per)
                ctas = 8 * splits * (n_kv // n_h)
                row[f"{name}_{str(dtype)[6:]}"] = {
                    "max_abs_err": err, "splits": splits, "per": per,
                    "kv_heads_per_cta": n_h, "smem_bytes": smem,
                    "ctas": ctas}
                log(f"frontend kernel {arch} {name} {str(dtype)[6:]}: "
                    f"{splits} splits of {per} pages x {n_kv // n_h} "
                    f"groups of {n_h} kv heads ({n_h * group} query heads "
                    f"and {smem} B of shared memory a CTA, {ctas} CTAs), "
                    f"max |kernel - plain| = {err:.3e}")
            args = _paged_case(gen, lengths=[full] * 8,
                               dtype=torch.bfloat16, dev=dev, **shp)
            ref = PK.paged_decode_attention_plain(*args)
            err = (PK.paged_decode_attention(*args).float()
                   - ref.float()).abs().max().item()
            call = lambda: PK.paged_decode_attention(*args)
            k_ms = time_ms(call)
            p_ms = time_ms(lambda: PK.paged_decode_attention_plain(*args))
            lib_ms = time_ms(_sdpa_call(*args))
            b_ms, b_by = bound_ms("paged_decode_attention", *args)
            made = {"paged_decode_kernel": 1}
            if splits > 1:
                made["paged_combine_kernel"] = 1
            devt = _recorded_device_ms(call, made)
            row[name] = {"shape": dict(shp, len=full, dtype="bfloat16"),
                         "max_abs_err": err, "ms": k_ms,
                         "device_ms": devt["device_ms"],
                         "launches_recorded": devt["recorded"],
                         "launches_made": devt["made"],
                         "profiler_windows": devt["windows"],
                         "device_ops": devt["device_ops"], "plain_ms": p_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "splits": splits,
                         "pages_per_split": per}
            log(f"frontend kernel {arch} {name} timing (bf16, B=8, "
                f"len={full}): kernel {k_ms:.4f} ms per call (device "
                f"{devt['device_ms']} ms: launches recorded "
                f"{devt['recorded']} of {devt['made']} made, "
                f"{devt['windows']} window(s)), plain {p_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return out


def _frontend_smoke(build: Path) -> dict:
    """(b): both archs at smoke size in f32 through
    :func:`_smoke_in_lockstep`; for internvl, 8 requests behind a
    registered shared prefix decode the tokens of the same prompts
    unshared; a smoke ``forward`` with a prefix on the card against the
    same call on the CPU (:data:`FORWARD_TOL`)."""
    import numpy as np
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request
    from repro_torch.serving.pages import PagedServingEngine

    def check_leaves(leaves):
        assert sorted(k for k in leaves if k.startswith("['pool']")) == \
            ["['pool']['kv']['k']", "['pool']['kv']['v']"], list(leaves)
        assert not any(k.startswith("['state']") for k in leaves)

    out = {}
    for arch in (FRONTEND_SERVE_ARCH, FRONTEND_TRAIN_ARCH):
        cfg = dataclasses.replace(configs.get(arch, smoke=True),
                                  dtype="float32")
        cpu_params = P.cast_tree(P.materialize(
            torch.Generator().manual_seed(0), transformer.param_spec(cfg),
            "cpu"), torch.float32)
        params = tree_map(lambda t: t.to("cuda"), cpu_params)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, 16)
                   for _ in range(SERVE["n_requests"])]
        row = _smoke_in_lockstep(arch, cfg, params, prompts,
                                 dict(prompt_len=16, max_len=64),
                                 build / f"smoke_{cfg.family}_replica",
                                 check_leaves)
        brng = np.random.default_rng(1)
        toks = brng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        pre = brng.standard_normal((2, cfg.frontend_tokens, cfg.d_model)
                                   ).astype(np.float32)
        on_card, _, mask = transformer.forward(
            params, cfg, torch.from_numpy(toks).cuda(),
            prefix_embeds=torch.from_numpy(pre).cuda())
        on_cpu, _, _ = transformer.forward(
            cpu_params, cfg, torch.from_numpy(toks),
            prefix_embeds=torch.from_numpy(pre))
        assert tuple(on_card.shape[:2]) == (2, cfg.frontend_tokens + 16)
        assert float(mask[:, :cfg.frontend_tokens].sum()) == 0.0
        torch.testing.assert_close(on_card.cpu(), on_cpu, **FORWARD_TOL)
        row["forward_card_cpu_max_abs"] = (on_card.cpu()
                                           - on_cpu).abs().max().item()
        if arch == FRONTEND_SERVE_ARCH:
            prefix = rng.integers(0, cfg.vocab_size, 16)
            asks = [np.concatenate([prefix,
                                    rng.integers(0, cfg.vocab_size, 8)])
                    for _ in range(8)]
            streams = {}
            for shared in (True, False):
                eng = PagedServingEngine(cfg, params, num_pages=4 * 4 + 2,
                                         page_size=16, max_reqs=4,
                                         prompt_len=24, max_len=64,
                                         device="cuda")
                if shared:
                    eng.register_prefix(prefix)
                reqs = [Request(i, p, max_new=SERVE["max_new"])
                        for i, p in enumerate(asks)]
                eng.run(reqs, max_steps=1024)
                assert all(r.done and len(r.out) == r.max_new for r in reqs)
                streams[shared] = [r.out for r in reqs]
                if shared:
                    row["prefix_stats"] = eng.prefix_stats()
            assert row["prefix_stats"]["hits"] == len(asks), row
            assert streams[True] == streams[False], (
                f"{arch}: the shared-prefix streams differ from the "
                f"unshared ones")
            del eng
        log(f"frontend smoke {arch} (f32): dense and paged engines decode "
            f"{row['tokens']} tokens token for token; graphed = eager over "
            f"8 rows (logits bitwise: {row['graph_eager_logits_bitwise']}); "
            f"a SYNC chain restored at step {row['restored_step']} into a "
            f"captured replica decodes in lockstep, no prefill; forward "
            f"with a {cfg.frontend_tokens}-embedding prefix, card against "
            f"CPU: max |dlogit| {row['forward_card_cpu_max_abs']:.3e} "
            f"(tolerance {FORWARD_TOL})"
            + (f"; shared prefix {row['prefix_stats']}, the streams equal "
               f"the unshared ones" if "prefix_stats" in row else ""))
        out[arch] = row
        del params, cpu_params
        _free_cuda()
    return out


def _frontend_serve(build: Path) -> dict:
    """(c) and (d): full-width internvl2-26b in :data:`SERVE_RUNS` and
    musicgen-medium in :data:`FRONTEND_AUDIO_RUNS` through
    :func:`_serve_runs`, each then through :func:`_full_engines` (all 48
    layers attend over the pages)."""
    import torch
    from repro_torch.configs import base as configs

    out = {}
    for part, tag, arch, runs in (
            ("vlm", "frontend", FRONTEND_SERVE_ARCH, SERVE_RUNS),
            ("audio", "frontend audio", FRONTEND_TRAIN_ARCH,
             FRONTEND_AUDIO_RUNS)):
        cfg = configs.get(arch)
        row = out[part] = _serve_runs(tag, arch, runs, build, cfg.n_layers)
        torch.cuda.reset_peak_memory_stats()
        params, draw = _draw_full(tag, cfg)
        row.update(draw, **_full_engines(tag, cfg, params, cfg.n_layers),
                   engines_peak_gib=torch.cuda.max_memory_allocated()
                   / 2**30)
        del params
        _free_cuda()
    return out


def _frontend_train() -> dict:
    """(e): ``train_loop("musicgen-medium", smoke=False)`` eager, then
    graphed, from seed 0 with no checkpoint task; every batch carries its
    64 prefix frames. Gates: the graphed losses are the eager ones bit for
    bit, finite; every forward of the step ran on prefix + tokens; no
    kernel launched. The graphed run's replays after its first are
    profiled (a SYNC task on the ``grads`` stream starts and stops the
    window)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import base as configs
    from repro_torch.core.session import Every, InSituPlan, Placement, \
        TaskSpec
    from repro_torch.launch import train as T
    from repro_torch.models import transformer
    from repro_torch.roofline.analysis import PEAK_FLOPS_BF16, model_flops

    cfg = configs.get(FRONTEND_TRAIN_ARCH)
    steps = FRONTEND_TRAIN["steps"]
    seq = T.FULL_SHAPE.seq_len + cfg.frontend_tokens
    want_shape = (T.FULL_SHAPE.global_batch, seq, cfg.padded_vocab)
    shapes: list = []
    forward = transformer.forward

    def recording(*args, **kw):
        out = forward(*args, **kw)
        shapes.append((tuple(out[0].shape),
                       kw.get("prefix_embeds") is not None))
        return out

    runs: dict = {}
    _family_tool().reset_launches()
    transformer.forward = recording
    try:
        for name, graph in (("eager", False), ("graph", True)):
            window: dict = {}

            def hook(step, _payload, graph=graph, window=window):
                if not graph:
                    return
                torch.cuda.synchronize()
                if step == 0:
                    window["prof"] = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    window["prof"].start()
                    window["t0"] = time.perf_counter()
                elif step == steps - 1:
                    window["wall_s"] = time.perf_counter() - window["t0"]
                    window["prof"].stop()

            plan = InSituPlan(streams=["grads", "train_state"], tasks=[
                TaskSpec(name="window", stream="grads", trigger=Every(1),
                         placement=Placement.SYNC, sink=hook)])
            lines: list = []
            shapes.clear()
            _free_cuda()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run = T.train_loop(FRONTEND_TRAIN_ARCH, smoke=False, steps=steps,
                               plan=plan, device="cuda", seed=0,
                               cuda_graph=graph, log=lines.append)
            torch.cuda.synchronize()
            row = runs[name] = {
                "losses": run["losses"], "wall_s": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "step_s": [sp.dt for sp in
                           run["telemetry"].spans("step/compute")],
                "forward_shapes": sorted(set(shapes))}
            row["step_median_s"] = statistics.median(row["step_s"])
            assert np.isfinite(run["losses"]).all(), (name, run["losses"])
            assert run["session_report"]["n_errors"] == 0
            assert shapes and all(s == (want_shape, True)
                                  for s in shapes), (name, set(shapes))
            cap = [float(m.group(1)) for m in
                   (re.match(r"captured the train step in ([\d.]+)s", ln)
                    for ln in lines) if m]
            if graph:
                assert len(cap) == 1, lines
                row["capture_s"] = cap[0]
                n = steps - 1
                ops, busy = {}, 0.0
                for e in window["prof"].key_averages():
                    if str(getattr(e, "device_type", "")).endswith("CUDA"):
                        us = getattr(e, "self_device_time_total", None)
                        if us is None:
                            us = getattr(e, "self_cuda_time_total", 0)
                        if us:
                            ops[e.key] = us / 1e3 / n
                busy = sum(ops.values())
                wall_ms = window["wall_s"] * 1e3 / n
                row.update(
                    profiled_steps=n, window_wall_ms=wall_ms,
                    device_busy_ms=busy if ops else None,
                    device_idle_share=(1 - busy / wall_ms) if ops else None,
                    top=sorted(ops.items(), key=lambda kv: -kv[1])[:6])
            log(f"frontend train {name}: {steps} steps of "
                f"{T.FULL_SHAPE.global_batch} x ({cfg.frontend_tokens} + "
                f"{T.FULL_SHAPE.seq_len}) tokens, losses {run['losses']}, "
                f"step/compute s {row['step_s']}, peak "
                f"{row['peak_gib']:.2f} GiB"
                + (f", capture {row['capture_s']:.2f} s" if graph else ""))
            del run
    finally:
        transformer.forward = forward
    g = runs["graph"]
    assert g["losses"] == runs["eager"]["losses"], (
        f"frontend train: graphed losses {g['losses']} != eager "
        f"{runs['eager']['losses']}")
    launches = _family_tool().launches()
    assert not any(launches.values()), (
        f"frontend train: a kernel ran on the train path: {launches}")
    shape = configs.ShapeConfig("train_4k_b4_prefix", "train", seq,
                                T.FULL_SHAPE.global_batch)
    flops = model_flops(cfg, shape)
    share = flops / g["step_median_s"] / PEAK_FLOPS_BF16
    log(f"frontend train: graphed losses = eager bit for bit over {steps} "
        f"steps; every forward ran on {want_shape} logits (prefix + "
        f"tokens); kernel launches {launches}; graphed step median "
        f"{g['step_median_s']:.4f} s, device busy {g['device_busy_ms']} ms "
        f"a replay, idle share {g['device_idle_share']} "
        f"({g['profiled_steps']} replays profiled); model FLOPs a step "
        f"(roofline.model_flops at {shape.global_batch} x {seq} tokens) "
        f"{flops:.4e}, over the median step: {share:.4f} of 989 TFLOP/s "
        f"bf16")
    for op, ms in g["top"]:
        log(f"frontend train:   {ms:9.2f} ms/step  {op[:90]}")
    return {"runs": runs, "launches": launches, "model_flops": flops,
            "model_flops_share_of_bf16_peak": share, "seq": seq}


def frontend_phase(build: Path) -> dict:
    """The frontend families on the card (see the module docstring, phase
    15)."""
    _free_cuda()
    part_s = {}
    t0 = time.perf_counter()
    kern = _frontend_kernel()
    part_s["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoke = _frontend_smoke(build)
    part_s["smoke"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = _frontend_serve(build)
    part_s["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = _frontend_train()
    part_s["train"] = time.perf_counter() - t0
    log(f"frontend phase parts: " + ", ".join(f"{k} {v:.1f} s"
                                              for k, v in part_s.items()))
    return {"kernel": kern, "smoke": smoke, "serve": serve, "train": train,
            "part_s": part_s}


# ---------------------------------------------------------------------------
# family_train phase
# ---------------------------------------------------------------------------

FAMILY_BUDGET_S = 280.0
FAMILY_FULL = dict(eager_steps=2, graph_steps=2)      # (a)
FAMILY_SMOKE = dict(eager_steps=3, graph_steps=3)     # (c)
# depth cut for the time limit (PERF.md section 4): hymba-1.5b's step
# takes ~30 s at 32 layers, ~0.94 s a layer (its full depth runs in
# tools/torch_family_train.py). 4 layers, one of them global (layer 0,
# then 3 sliding-window layers): the full model's 3 global layers of 32
# kept at 4 layers would make 3 of the 4 global
FAMILY_HYMBA = dict(n_layers=4, n_global_layers=1)
# (b) one super-block: 7 mLSTM + 1 sLSTM; one eager step (12-18 s) and a
# resumed step run eagerly (a capture takes ~60 s there: two eager
# warm-up steps of the 4096-step sLSTM loop and the recording)
FAMILY_XLSTM_BLOCKS = 8
FAMILY_XLSTM = dict(eager_steps=1, graph_steps=2, resume_graph=False)
FAMILY_MOE_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
# the card's smoke-config bf16 losses against the port's CPU run: the MoE
# family's bf16 bound (tests/test_torch_moe.py)
FAMILY_CPU_LOSS_ATOL = 2e-2


def _family_kernel_check(xb, rows, label) -> dict:
    """Kernels 2-5 against their plain versions (``spectral_check``, the
    spectral phase's tolerances) on a packed buffer of a family's save."""
    res = spectral_check(xb, rows, EPS, label)
    return {"blocks": sum(rows), "leaves": res["leaves"], "err": res["err"],
            "thresholds_differing": res["thresholds_differing"]}


#: the sLSTM cell kernels against their plain versions on the same inputs,
#: step by step: both do the same IEEE f32 operations in the same order
#: (the kernel rounds each product and sum on its own, as the plain
#: version's separate ops do) with the same expf / tanhf, so they should
#: agree to the bit; a few f32 ulps are allowed (max |d| over max |plain|),
#: and h, stored in bf16, one bf16 rounding (2^-8)
SLSTM_STEP_TOL = 1e-5
SLSTM_H_TOL = 2.0 ** -8
#: SLSTMScan on the kernels against the plain time loop under autograd, on
#: one layer's 4096 steps, relative L2 of each output and gradient: the
#: backward's recurrent products differ in their operands' layouts (cuBLAS
#: may pick other kernels) and the loop adds h's two cotangents in bf16,
#: 2e-2. The loop takes r_gates in f32 and casts it at each step
#: (``slstm_loop``'s ``r_dtype``): the same forward, and autograd sums
#: the 4096 steps' dR in f32, as the scan's one product does, where a
#: bf16 sum would round its running total 4096 times (that reading, the
#: control, is logged beside the gated one)
SLSTM_E2E_TOL = {"h": 1e-2, "c": 1e-2, "n": 1e-2, "m": 1e-2, "x": 2e-2,
                 "w_gates": 2e-2, "r_gates": 2e-2, "b_gates": 2e-2}


def _rel_l2(got, want) -> float:
    import torch

    d = torch.linalg.vector_norm((got.float() - want.float()).reshape(-1))
    n = torch.linalg.vector_norm(want.float().reshape(-1))
    return float(d / n) if float(n) > 0 else float(d)


def _rel_max(got, want):
    """max |got - want| over max(max |want|, 1e-30), on the card."""
    import torch

    return (torch.amax(torch.abs(got.float() - want.float()))
            / torch.clamp(torch.amax(torch.abs(want.float())), min=1e-30))


def _slstm_kernel() -> dict:
    """Both sLSTM cell kernels against their plain versions at
    ``xlstm-1.3b``'s full width (d 2048, 4 heads of 512) on one layer's
    4096 steps, 4 rows (the train phase's 4 x 4096 tokens), bf16 weights
    and h as in training: every step of a forward and of a backward run
    on the kernels, each call repeated by the plain version on the same
    inputs (:data:`SLSTM_STEP_TOL`); then ``SLSTMScan`` on the kernels
    against the plain time loop under autograd (``models/xlstm.py::
    slstm_loop``): h, the final state and the gradients of the layer's
    normalised input and of ``w_gates``, ``r_gates``, ``b_gates``
    (:data:`SLSTM_E2E_TOL`). Each kernel and the recurrent product timed
    at those shapes. Launches made here are not the path's."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.kernels import slstm as SK
    from repro_torch.launch import train as T
    from repro_torch.models import xlstm as X

    cfg = configs.get(XLSTM_ARCH)
    b, l = T.FULL_SHAPE.global_batch, T.FULL_SHAPE.seq_len
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, scale=1.0: torch.randn(
        shape, generator=gen, device=dev) * scale
    x = rnd(b, l, d).to(bf)
    w = rnd(d, 4 * d, scale=d ** -0.5).to(bf)
    bias = rnd(4 * d, scale=0.1)
    rg = rnd(4, nh, dh, dh, scale=dh ** -0.5).to(bf)
    w_out = rnd(b, l, d)
    gx = (x @ w + bias).contiguous()
    r = X._recurrent_weights(rg)
    f32 = dict(dtype=torch.float32, device=dev)

    # (1) every step of a forward, kernel and plain version on its inputs
    slots = torch.empty((3, l + 1, b, nh, dh), **f32)
    slots[0, 0].zero_()
    slots[1, 0].zero_()
    slots[2, 0].fill_(-1e30)
    pre = torch.empty((b, l, 4 * d), **f32)
    hs = torch.empty((b, l, d), dtype=bf, device=dev)
    h0 = torch.zeros((b, nh, dh), dtype=bf, device=dev)
    plain = [torch.empty((b, nh, dh), **f32) for _ in range(3)] + [
        torch.empty((b, 4 * d), **f32), torch.empty((b, d), dtype=bf,
                                                    device=dev)]
    err_f = torch.zeros(5, **f32)
    args_at = {}
    for t in range(l):
        hp = h0 if t == 0 else hs[:, t - 1].view(b, nh, dh)
        gr = torch.bmm(hp.transpose(0, 1), r)
        ins = (gx[:, t], gr, slots[0, t], slots[1, t], slots[2, t])
        outs = (slots[0, t + 1], slots[1, t + 1], slots[2, t + 1],
                pre[:, t], hs[:, t])
        SK.slstm_cell(*ins, *outs)
        SK.slstm_cell_plain(*ins, *plain)
        err_f = torch.maximum(err_f, torch.stack(
            [_rel_max(o, p) for o, p in zip(outs, plain)]))
        if t == l // 2:
            args_at["fwd"] = (ins, outs, hp)
    # ... and of a backward, from a random cotangent of h
    dhs = rnd(b, l, d).to(bf)
    carry = [torch.zeros((b, nh, dh), **f32) for _ in range(3)]
    dgx = torch.empty_like(pre)
    dgr = torch.empty((nh, l, b, 4 * dh), dtype=bf, device=dev)
    pl_carry = [torch.empty_like(c) for c in carry]
    pl_out = [torch.empty((b, 4 * d), **f32),
              torch.empty((nh, b, 4 * dh), dtype=bf, device=dev)]
    err_b = torch.zeros(5, **f32)
    rt = r.transpose(1, 2)
    dhr = None
    for t in reversed(range(l)):
        ins = (pre[:, t], slots[0, t], slots[1, t], slots[2, t], dhs[:, t],
               dhr)
        for pc, c in zip(pl_carry, carry):
            pc.copy_(c)
        SK.slstm_cell_bwd_plain(*ins, *pl_carry, *pl_out)
        if t == l // 2:
            args_at["bwd"] = (ins, [c.clone() for c in carry],
                              (dgx[:, t], dgr[:, t]))
        SK.slstm_cell_bwd(*ins, *carry, dgx[:, t], dgr[:, t])
        err_b = torch.maximum(err_b, torch.stack(
            [_rel_max(o, p) for o, p in zip(
                carry + [dgx[:, t], dgr[:, t]], pl_carry + pl_out)]))
        dhr = torch.bmm(dgr[:, t], rt)
    err_f, err_b = err_f.tolist(), err_b.tolist()
    names_f = ("c", "n", "m", "pre", "h")
    names_b = ("dc", "dn", "dm", "dpre", "dgr")
    step = {"slstm_cell": dict(zip(names_f, err_f)),
            "slstm_cell_bwd": dict(zip(names_b, err_b))}
    for name, e in zip(names_f, err_f):
        assert e <= (SLSTM_H_TOL if name == "h" else SLSTM_STEP_TOL), (
            f"slstm_cell {name}: {e} (step errors {step})")
    for name, e in zip(names_b, err_b):
        assert e <= (SLSTM_H_TOL if name == "dgr" else SLSTM_STEP_TOL), (
            f"slstm_cell_bwd {name}: {e} (step errors {step})")
    log(f"slstm kernels against their plain versions, every step of one "
        f"layer's {l} at full width (max |d| / max |plain|): {step}")

    # (2) SLSTMScan on the kernels against the plain loop's autograd, dR
    # summed in f32; then the control, the loop with dR summed in bf16
    e2e = {}
    res = []
    for how in ("scan", "loop", "control"):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, rg, bias)]
        g = leaves[0] @ leaves[1] + leaves[3]
        z = torch.zeros((b, nh, dh), **f32)
        st = {"c": z, "n": z, "m": z - 1e30, "h": h0}
        if how == "scan":
            h, c, n, m = X.SLSTMScan.apply(
                g, X._recurrent_weights(leaves[2]), z, z, z - 1e30, h0)
        elif how == "loop":
            h, st = X.slstm_loop(
                cfg, g, X._recurrent_weights(leaves[2].float()), st,
                r_dtype=bf)
        else:
            h, st = X.slstm_loop(cfg, g, X._recurrent_weights(leaves[2]), st)
        if how != "scan":
            c, n, m = st["c"], st["n"], st["m"]
        grads = torch.autograd.grad((h.float() * w_out).sum(), leaves)
        res.append([t.detach() for t in (h, c, n, m)] + list(grads))
        del leaves, g, h, c, n, m, st, grads
    names = ("h", "c", "n", "m", "x", "w_gates", "r_gates", "b_gates")
    for name, got, want in zip(names, res[0], res[1]):
        e2e[name] = _rel_l2(got, want)
    control = _rel_l2(res[0][6], res[2][6])
    del res
    for name, e in e2e.items():
        assert e <= SLSTM_E2E_TOL[name], (name, e2e)
    log(f"slstm: SLSTMScan on the kernels against the plain loop's autograd "
        f"(relative L2, dR summed in f32): {e2e}; the control, r_gates "
        f"against the loop with dR summed in bf16: {control}")

    # (3) times at the main path's shapes (step l / 2)
    ins, outs, hp = args_at["fwd"]
    fwd = lambda: SK.slstm_cell(*ins, *outs)
    fwd_plain = lambda: SK.slstm_cell_plain(*ins, *plain)
    bins, bcarry, bouts = args_at["bwd"]
    bwd = lambda: SK.slstm_cell_bwd(*bins, *bcarry, *bouts)
    bwd_plain = lambda: SK.slstm_cell_bwd_plain(*bins, *pl_carry, *pl_out)
    bmm = lambda: torch.bmm(hp.transpose(0, 1), r)
    timing = {}
    for name, fn, fn_plain, args, sym in (
            ("slstm_cell", fwd, fwd_plain, ins + outs, "slstm_fwd_kernel"),
            ("slstm_cell_bwd", bwd, bwd_plain, bins + tuple(bcarry) + bouts,
             "slstm_bwd_kernel")):
        dev_ms, _ = kernel_device_ms(fn, [sym], n=20)
        bms, by = bound_ms(name, *args)
        timing[name] = {"ms": time_ms(fn), "device_ms": dev_ms,
                        "plain_ms": time_ms(fn_plain), "bound_ms": bms,
                        "bound_by": by, "library_ms": None}
    bmm_ms = time_ms(bmm)
    for name in timing:
        timing[name]["bmm_ms"] = bmm_ms
    log(f"slstm kernel times (ms a call at {b} rows x {d}; the recurrent "
        f"bmm {bmm_ms:.4f} ms): {timing}")
    SK.reset_launches()
    return {"shape": {"rows": b, "steps": l, "d": d, "heads": nh,
                      "dtype": "bfloat16"},
            "step_max_rel_err": step, "scan_rel_l2": e2e,
            "control_r_gates_rel_l2": control, "timing": timing,
            "max_abs_err": max(max(err_f), max(err_b))}


def family_train_phase(build: Path) -> dict:
    """The hybrid, xLSTM and MoE/MLA families' train path (see the module
    docstring, phase 16), through ``tools/torch_family_train.py``'s
    ``run``; first the sLSTM cell kernels against their plain versions
    (:func:`_slstm_kernel`)."""
    import numpy as np
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as T

    tool = _family_tool()
    root = build / "smoke_family_ckpt"
    out: dict = {"part_s": {}}
    total: dict = {}
    _free_cuda()
    t0 = time.perf_counter()
    out["slstm_kernel"] = _slstm_kernel()
    out["part_s"]["slstm_kernel"] = time.perf_counter() - t0

    def one(name, arch, **kw):
        t0 = time.perf_counter()
        res = out[name] = tool.run(arch, ckpt_dir=str(root / name),
                                  tag=f"family {name}", log=log,
                                  kernel_check=_family_kernel_check, **kw)
        assert "largest group" in res["kernel_check"], res["kernel_check"]
        out["part_s"][name] = time.perf_counter() - t0
        for k, n in res["launches"].items():
            total[k] = total.get(k, 0) + n
        return res

    _free_cuda()
    hcfg = dataclasses.replace(configs.get(HYBRID_ARCH), **FAMILY_HYMBA)
    with tool.config_as(HYBRID_ARCH, hcfg):
        one("hymba", HYBRID_ARCH, **FAMILY_FULL)
    _free_cuda()
    xcfg = dataclasses.replace(configs.get(XLSTM_ARCH),
                               n_layers=FAMILY_XLSTM_BLOCKS)
    with tool.config_as(XLSTM_ARCH, xcfg):
        one("xlstm", XLSTM_ARCH, **FAMILY_XLSTM)
    for arch in FAMILY_MOE_ARCHS:
        _free_cuda()
        name = arch.split("-")[0]
        res = one(name, arch, smoke=True, save_eager=True, **FAMILY_SMOKE)
        t0 = time.perf_counter()
        cpu = T.train_loop(arch, smoke=True, steps=FAMILY_SMOKE["eager_steps"],
                           plan={"streams": ["grads", "train_state"]},
                           device="cpu", seed=0, log=lambda m: None)
        out["part_s"][name + "_cpu"] = time.perf_counter() - t0
        card = res["runs"]["eager"]["losses"]
        diff = float(np.max(np.abs(np.asarray(card) - cpu["losses"])))
        res["cpu_losses"], res["cpu_max_abs_diff"] = cpu["losses"], diff
        assert diff <= FAMILY_CPU_LOSS_ATOL, (arch, card, cpu["losses"])
        log(f"family {name}: card losses {card}, the port's CPU run "
            f"{cpu['losses']}: max |d| {diff:.3e} (atol "
            f"{FAMILY_CPU_LOSS_ATOL})")
    for k in ("dct_hist_coarse_tiled", "hist_refine_tiled",
              "threshold_quant", "dequant_idct"):
        assert total[k] > 0, (k, total)
    assert total["paged_decode_attention"] == 0, total
    assert total["slstm_cell"] > 0 and total["slstm_cell_bwd"] > 0, total
    assert total["slstm_cell"] == out["xlstm"]["launches"]["slstm_cell"]
    out["launches"] = total
    log(f"family_train phase parts: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["part_s"].items())
        + f"; launches {total}")
    return out


# ---------------------------------------------------------------------------
# fault phase
# ---------------------------------------------------------------------------

FAULT_BUDGET_S = 30.0
# depth cut for the time limit (PERF.md section 4): smollm-135m at 2 of
# its 30 layers, widths unchanged (tools/torch_fault_killpoint.py runs
# all 30)
FAULT_LAYERS = 2
FAULT_SCENARIO = dict(steps=9, fail_at=4, ckpt_every=2, grace_s=2.5)


def fault_phase(build: Path) -> dict:
    """A host drop detected, restored and resumed (see the module
    docstring, phase 17), through ``tools/torch_fault_killpoint.py``'s
    ``run_scenario``."""
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as T

    tool = _load_tool("torch_fault_killpoint")
    cfg = dataclasses.replace(configs.get("smollm-135m"),
                              n_layers=FAULT_LAYERS)
    _free_cuda()
    with tool.world_of_one(str(build), "nccl"):
        out = tool.run_scenario(
            cfg, "cuda", **FAULT_SCENARIO,
            ckpt_dir=str(build / "smoke_fault_ckpt"), shape=T.FULL_SHAPE,
            kernel_check=_family_kernel_check,
            log=lambda m: log(f"fault: {m}"))
    assert "largest group" in out["kernel_check"], out["kernel_check"]
    total: dict = {}
    for part in ("save_launches", "restore_launches", "resume_launches"):
        for k, n in out[part].items():
            total[k] = total.get(k, 0) + n
    saves = out["saves"] + out["resume_saves"]
    for k in tool.SAVE_KERNELS:
        assert total[k] == saves * out["groups"], (k, total)
    assert total["dequant_idct"] == out["moment_leaves"], total
    assert sum(total.values()) == (3 * saves * out["groups"]
                                   + out["moment_leaves"]), total
    out["launches"] = total
    log(f"fault phase parts: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["part_s"].items())
        + f"; detected at step {out['detect_step']}, restored step "
        f"{out['restored_step']} on {out['new_shape']} (merge "
        f"{out['merge_factor']}) in {out['restore_s']:.2f} s; resumed "
        f"gaps {out['loss_gaps']}; launches {total}")
    return out


# ---------------------------------------------------------------------------
# shard phase
# ---------------------------------------------------------------------------

SHARD_BUDGET_S = 45.0
# depth cut for the time limit (PERF.md section 4): smollm-135m at 2 of
# its 30 layers, widths unchanged (tools/torch_shard_step.py runs all 30)
SHARD_LAYERS = 2


def shard_phase() -> dict:
    """The train step sharded across two processes on the card (see the
    module docstring, phase 18), through ``tools/torch_shard_step.py``'s
    ``run_pair``; the children's launch counts summed here."""
    tool = _load_tool("torch_shard_step")
    _free_cuda()
    r0, r1 = tool.run_pair("smoke", layers=SHARD_LAYERS,
                           timeout_s=2 * SHARD_BUDGET_S,
                           log=lambda m: log(m))
    a, b = r0["a"], r0["b"]
    assert a["loss_max_abs"] <= tool.ONE_LOSS_ATOL, a
    for r in (r0, r1):
        ring = r["b"]["ring"]
        assert ring["leaves"] > 0 and ring["differ"] == [], ring
        assert r["b"]["wire"]["bytes"]["int8"] == r["b"]["int8_bytes_want"]
        assert r["c"]["plan"] == [[1, 2], [1, 2], 1], r["c"]
    assert "largest group" in r0["kernel_check"], r0["kernel_check"]
    groups, n_lossy = r0["groups"], r0["moment_leaves"]
    total = dict(r0["save_launches"])
    for r in (r0, r1):
        for part in ("restore_launches", "c"):
            got = r[part] if part != "c" else r["c"]["resume_launches"]
            for k, n in got.items():
                total[k] = total.get(k, 0) + n
    for k in _load_tool("torch_fault_killpoint").SAVE_KERNELS:
        assert total[k] == groups, (k, total)
    assert total["dequant_idct"] == 2 * n_lossy, total
    assert sum(total.values()) == 3 * groups + 2 * n_lossy, total
    out = {"ranks": [r0, r1], "launches": total}
    log(f"shard phase parts (rank 0): " + ", ".join(
        f"{k} {v:.1f} s" for k, v in r0["part_s"].items())
        + f"; (a) bitwise {a['bitwise']}, loss |d| {a['loss_max_abs']:.2e}"
        f", staged {r0['a_wire']['bytes']['staged']} B; (b) ring {b['ring']['leaves']}"
        f" leaves bitwise, int8 {b['wire']['bytes']['int8']} B, staged "
        f"{b['step_staged']} B by the steps; (c) restore "
        f"{r0['restore_s']:.2f}"
        f" s, resumed loss {r0['c']['resumed_loss']:.5f}; launches {total}")
    return out


# ---------------------------------------------------------------------------
# dryrun phase
# ---------------------------------------------------------------------------

DRYRUN_BUDGET_S = 30.0
#: the predicted per-rank peak against max_memory_allocated of one eager
#: step on the card
DRYRUN_PEAK_TOL = 0.15
#: the serve decode: the serve phase's 8 rows, a cache of 64 positions
#: (its 16-token prompts and 32 new tokens fit)
DRYRUN_DECODE = dict(rows=8, max_len=64)


def dryrun_phase(build: Path) -> dict:
    """The dry run's lowering on fake tensors held against the card (see
    the module docstring, phase 19): the train phase's configuration and
    the serve decode lowered on a (1, 1) mesh, then one eager step of
    each on the card, the predicted peak against the measured one."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.data.pipeline import batch_spec_for, synth_batch
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as T
    from repro_torch.models import params as P_lib
    from repro_torch.models import transformer
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.serving import engine, kvcache

    tcfg = dataclasses.replace(configs.get("smollm-135m"),
                               n_layers=SMOLLM_TRAIN_LAYERS)
    dcfg = configs.get("smollm-135m")
    dshape = configs.ShapeConfig("serve_decode", "decode",
                                 DRYRUN_DECODE["max_len"],
                                 DRYRUN_DECODE["rows"])
    out: dict = {"part_s": {}}
    t0 = time.perf_counter()
    # the depth variants (1 and 2 layers) fitted to 10: the full depth's
    # lowering would take most of the phase's time
    pred = {"train": D.lower_cell(tcfg, T.FULL_SHAPE, 1,
                                  mesh_lib.make_host_mesh, depth="variants"),
            "decode": D.lower_cell(dcfg, dshape, 1, mesh_lib.make_host_mesh,
                                   depth="full")}
    out["part_s"]["lower"] = time.perf_counter() - t0

    dev = torch.device("cuda")
    meas: dict = {}
    t0 = time.perf_counter()
    _free_cuda()
    with _load_tool("torch_fault_killpoint").world_of_one(str(build),
                                                          "nccl"):
        mesh = mesh_lib.make_host_mesh()
        step, st_sh, b_sh, _ = T.jit_train_step(tcfg, mesh, T.StepConfig(),
                                                T.FULL_SHAPE)
        base = torch.cuda.memory_allocated()
        state = T.init_state(tcfg, torch.Generator(dev).manual_seed(0),
                             T.StepConfig().opt, device=dev)
        state = distribute_tree(state, mesh, st_sh)
        host_batch = synth_batch(batch_spec_for(tcfg, T.FULL_SHAPE), 0)
        batch = distribute_tree({k: torch.from_numpy(host_batch[k]).to(dev)
                                 for k in b_sh}, mesh, b_sh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        meas["train"] = torch.cuda.max_memory_allocated() - base
        assert math.isfinite(loss), loss
        del state, batch, metrics
    _free_cuda()
    base = torch.cuda.memory_allocated()
    params = P_lib.materialize(torch.Generator(dev).manual_seed(0),
                               transformer.param_spec(dcfg), dev)
    cache = kvcache.init_cache(dcfg, dshape.global_batch, dshape.seq_len,
                               device=dev)
    tokens = torch.zeros((dshape.global_batch, 1), dtype=torch.int32,
                         device=dev)
    lengths = torch.full((dshape.global_batch,), 16, dtype=torch.int32,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, _, _ = engine.make_decode(dcfg)(params, cache, tokens, lengths)
    torch.cuda.synchronize()
    meas["decode"] = torch.cuda.max_memory_allocated() - base
    assert bool(torch.isfinite(logits.float()).all())
    del params, cache, logits
    _free_cuda()
    out["part_s"]["card"] = time.perf_counter() - t0
    for name, cfg, shape in (("train", tcfg, T.FULL_SHAPE),
                             ("decode", dcfg, dshape)):
        p = pred[name]
        ratio = p["peak_bytes"] / meas[name]
        out[name] = {"predicted_peak_bytes": p["peak_bytes"],
                     "measured_peak_bytes": meas[name], "ratio": ratio,
                     "argument_bytes": p["argument_bytes"],
                     "counted_flops": p["flops"],
                     "model_flops": model_flops(cfg, shape),
                     "bytes_accessed": p["bytes"], "depth": p["depth"],
                     "lower_s": p["lower_s"]}
        log(f"dryrun {name} ({cfg.n_layers} layers, {shape.global_batch} x "
            f"{shape.seq_len}, mesh (1, 1), {p['depth']}): predicted peak "
            f"{p['peak_bytes'] / 2**30:.3f} GiB, measured "
            f"{meas[name] / 2**30:.3f} GiB (max_memory_allocated of one "
            f"eager step): ratio {ratio:.4f}; counted FLOPs "
            f"{p['flops']:.4e} beside model_flops "
            f"{out[name]['model_flops']:.4e}; lowered in "
            f"{p['lower_s']:.1f} s")
        assert abs(ratio - 1) <= DRYRUN_PEAK_TOL, (name, out[name])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    card = device_line()
    log(card)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(["paged_attention", "spectral_lossy", "slstm"])
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in built.items())})")
    for name in built:
        ptxas = _build.target(name).with_suffix(".log").read_text()
        for ln in ptxas.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"build {name}: {ln.strip()}")

    t_phases = t0 = time.perf_counter()
    kern = kernel_phase(serve_table_width=4)
    log(f"kernel phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    spec = spectral_phase()
    log(f"spectral kernel phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    single = single_tensor_phase()
    log(f"single-tensor spectral kernel phase: "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    roof = roofline_phase(serve_table_width=4)
    log(f"roofline phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve = serve_phase(ROOT / "build" / "smoke_chain")
    log(f"serve phase: {time.perf_counter() - t0:.1f}s, "
        f"{serve['tok_per_s']:.1f} tok/s")
    t0 = time.perf_counter()
    stream = stream_phase(ROOT / "build")
    log(f"stream phase: {time.perf_counter() - t0:.1f}s")
    from repro_torch.configs import base as configs
    family_tool = _family_tool()
    smollm_cut = dataclasses.replace(configs.get("smollm-135m"),
                                     n_layers=SMOLLM_TRAIN_LAYERS)
    with family_tool.config_as("smollm-135m", smollm_cut):
        t0 = time.perf_counter()
        train = train_phase(ROOT / "build" / "smoke_ckpt")
        log(f"train phase: {time.perf_counter() - t0:.1f}s "
            f"(smollm-135m at {SMOLLM_TRAIN_LAYERS} layers)")
        t0 = time.perf_counter()
        placements = placements_phase(
            ROOT / "build" / "smoke_ckpt_placements", train)
        log(f"train (sync/async ckpt) phase: "
            f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    insitu = insitu_phase(ROOT / "build" / "smoke_insitu")
    insitu["phase_s"] = time.perf_counter() - t0
    log(f"insitu phase: {insitu['phase_s']:.1f}s")
    assert insitu["phase_s"] <= INSITU_BUDGET_S, insitu["phase_s"]
    t0 = time.perf_counter()
    moe = moe_phase(ROOT / "build")
    moe["phase_s"] = time.perf_counter() - t0
    log(f"moe phase: {moe['phase_s']:.1f}s")
    assert moe["phase_s"] <= MOE_BUDGET_S, moe["phase_s"]
    t0 = time.perf_counter()
    hybrid = hybrid_phase(ROOT / "build")
    hybrid["phase_s"] = time.perf_counter() - t0
    log(f"hybrid phase: {hybrid['phase_s']:.1f}s")
    assert hybrid["phase_s"] <= HYBRID_BUDGET_S, hybrid["phase_s"]
    t0 = time.perf_counter()
    xlstm = xlstm_phase(ROOT / "build")
    xlstm["phase_s"] = time.perf_counter() - t0
    log(f"xlstm phase: {xlstm['phase_s']:.1f}s")
    assert xlstm["phase_s"] <= XLSTM_BUDGET_S, xlstm["phase_s"]
    t0 = time.perf_counter()
    frontend = frontend_phase(ROOT / "build")
    frontend["phase_s"] = time.perf_counter() - t0
    log(f"frontend phase: {frontend['phase_s']:.1f}s")
    assert frontend["phase_s"] <= FRONTEND_BUDGET_S, frontend["phase_s"]
    t0 = time.perf_counter()
    fam = family_train_phase(ROOT / "build")
    fam["phase_s"] = time.perf_counter() - t0
    log(f"family_train phase: {fam['phase_s']:.1f}s")
    assert fam["phase_s"] <= FAMILY_BUDGET_S, fam["phase_s"]
    t0 = time.perf_counter()
    fault = fault_phase(ROOT / "build")
    fault["phase_s"] = time.perf_counter() - t0
    log(f"fault phase: {fault['phase_s']:.1f}s")
    assert fault["phase_s"] <= FAULT_BUDGET_S, fault["phase_s"]
    t0 = time.perf_counter()
    shard = shard_phase()
    shard["phase_s"] = time.perf_counter() - t0
    log(f"shard phase: {shard['phase_s']:.1f}s")
    assert shard["phase_s"] <= SHARD_BUDGET_S, shard["phase_s"]
    t0 = time.perf_counter()
    dry = dryrun_phase(ROOT / "build")
    dry["phase_s"] = time.perf_counter() - t0
    log(f"dryrun phase: {dry['phase_s']:.1f}s")
    assert dry["phase_s"] <= DRYRUN_BUDGET_S, dry["phase_s"]
    all_s = time.perf_counter() - t_phases
    log(f"all phases: {all_s:.1f}s")

    main_path = kern["serve"]
    record = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:76",
        "tpu_kernel": "src/repro/kernels/paged_attention.py:76",
        "launches": serve["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "max_err_f32": kern["max_err_f32"],
        "max_err_bf16": kern["max_err_bf16"],
        "ms": main_path["ms"],
        "kernel_ms": main_path["ms"],
        "device_ms": main_path["device_ms"],
        "plain_ms": main_path["plain_ms"],
        "library_ms": main_path["library_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "shape": main_path["shape"],
        "long_context": kern["long"],
        "at_moonshot": {k: moe["kernel"][k] for k in ("serve", "long")},
        "at_hymba": {k: hybrid["kernel"][k] for k in ("serve", "long")},
        "at_hymba_recorded_window": frontend["kernel"]["hymba-1.5b"],
        "at_internvl": {k: frontend["kernel"]["internvl2-26b"][k]
                        for k in ("serve", "long")},
        "at_musicgen": {k: frontend["kernel"]["musicgen-medium"][k]
                        for k in ("serve", "long")},
        "launches_by_path": {
            "serve": serve["launches"],
            "stream_producer": stream["hydrate"]["producer_launches"],
            "stream_replica": stream["hydrate"]["launches"],
            "moe_serve": moe["serve"]["graph_plan"]["launches"],
            "hybrid_serve": hybrid["serve"]["graph_plan"]["launches"],
            "hybrid_long": hybrid["serve"]["long"]["launches"],
            "xlstm_serve": xlstm["launches"]["paged_decode_attention"],
            "frontend_serve": frontend["serve"]["vlm"]["graph_plan"][
                "launches"],
            "frontend_audio_serve": frontend["serve"]["audio"]["graph_bare"][
                "launches"],
            "frontend_train": frontend["train"]["launches"][
                "paged_decode_attention"],
            "family_train": fam["launches"]["paged_decode_attention"],
            "fault": fault["launches"]["paged_decode_attention"],
            "shard": shard["launches"]["paged_decode_attention"]},
    }
    records = [record]
    tpu = "src/repro/kernels/spectral_lossy.py"
    for name, line, launches in (
            ("dct_hist_coarse_tiled", 335,
             train["save_launches"]["dct_hist_coarse_tiled"]),
            ("hist_refine_tiled", 386,
             train["save_launches"]["hist_refine_tiled"]),
            ("threshold_quant", 436, train["save_launches"]["threshold_quant"]),
            ("dequant_idct", 488, train["resume_launches"]["dequant_idct"])):
        tm = spec["timing"][name]
        ick = insitu["checkpoint"]
        by_path = ({"train_resume": launches, "stream_consumed_restore":
                    stream["mirror"]["restore_launches"],
                    "insitu_restores": sum(ick[n]["restore_launches"]
                                           for n in ("v2", "v1"))}
                   if name == "dequant_idct" else
                   {"train_hybrid": launches, "stream_mirrored_train":
                    stream["mirror"]["save_launches"][name],
                    "insitu_saves": sum(ick[n]["launches"][name]
                                        for n in ("v2", "v1", "v2_serial"))})
        if name == "threshold_quant":
            by_path["insitu_legacy"] = sum(
                insitu["legacy"][k][name]
                for k in ("run_pipeline_launches", "run_workflow_launches"))
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_lossy.cu",
            "replaces": f"{tpu}:{line}", "tpu_kernel": f"{tpu}:{line}",
            "launches": launches,
            "launches_per": "restore" if name == "dequant_idct" else "save",
            "launches_by_path": by_path,
            "max_abs_err": spec["max_abs_err"][name],
            "ms": tm["ms"], "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"], "plain_ms": tm["plain_ms"],
            "library_ms": tm["library_ms"],
            "library_call": ("torch.matmul, f32, TF32 off (matmul only)"
                             if tm["library_ms"] is not None else None),
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "shape": {"blocks": spec["blocks"], "block": 256,
                      "dtype": "float32", "leaves": spec["leaves"]},
        })
    for name, line in (("dct_hist_coarse", 184), ("hist_refine", 245)):
        tm = single["timing"][name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_lossy.cu",
            "replaces": f"{tpu}:{line}", "tpu_kernel": f"{tpu}:{line}",
            "launches": placements["async"]["launches"][name],
            "launches_per": "ASYNC training run with 2 saves (22 per save)",
            "launches_by_run": {m: placements[m]["launches"][name]
                                for m in ("sync", "async")},
            "launches_by_path": {
                "insitu_run_pipeline":
                    insitu["legacy"]["run_pipeline_launches"][name],
                "insitu_run_workflow":
                    insitu["legacy"]["run_workflow_launches"][name]},
            "max_abs_err": single["max_abs_err"][name],
            "ms": tm["ms"], "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"], "plain_ms": tm["plain_ms"],
            "library_ms": tm["library_ms"],
            "library_call": ("torch.matmul, f32, TF32 off (matmul only)"
                             if tm["library_ms"] is not None else None),
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "per_save": tm["per_save"],
            "shape": {"blocks": single["embed_blocks"], "block": 256,
                      "dtype": "float32", "leaf": "['mu']['embed']"},
        })
    for name, line in (("dct_hist_tiled", 299), ("dct_hist", 133)):
        main_shape = "packed" if name == "dct_hist_tiled" else "embed"
        tm = roof["timing"][name]
        at = ", ".join(r["shape"] for r in roof["reports"]
                       if r["name"] == name)
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_lossy.cu",
            "replaces": f"{tpu}:{line}", "tpu_kernel": f"{tpu}:{line}",
            "launches": roof["launches"][name],
            "launches_per": (f"roofline phase: kernel_report at {at}, "
                             f"1 + {ROOFLINE_ITERS} calls each"),
            "max_abs_err": roof["max_abs_err"],
            **{k: tm[main_shape][k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")},
            "kernel_ms": tm[main_shape]["ms"],
            "library_call": "torch.matmul, f32, TF32 off (matmul only)",
            "shape": {"blocks": tm[main_shape]["blocks"], "block": 256,
                      "dtype": "float32", "at": main_shape},
            "at": tm,
            "flat_over_two_level": roof["ratios"],
        })
    log(json.dumps({"serve": serve}))
    log(json.dumps({"stream": stream}))
    log(json.dumps({"spectral": {k: v for k, v in spec.items()
                                 if k != "timing"}}))
    log(json.dumps({"train": train}))
    log(json.dumps({"single_tensor": {k: v for k, v in single.items()
                                      if k != "timing"}}))
    log(json.dumps({"train_placements": placements}))
    log(json.dumps({"insitu": insitu}))
    log(json.dumps({"moe": moe}))
    log(json.dumps({"hybrid": hybrid}))
    log(json.dumps({"xlstm": xlstm}))
    log(json.dumps({"frontend": frontend}))
    log(json.dumps({"family_train": fam}))
    log(json.dumps({"fault": fault}))
    log(json.dumps({"shard": shard}))
    log(json.dumps({"dryrun": dry}))
    log(json.dumps({"roofline": {k: v for k, v in roof.items()
                                 if k != "reports"}}))
    for rec in records[1:]:
        rec["launches_by_path"] = {**rec.get("launches_by_path", {}),
                                   "xlstm_serve": xlstm["launches"][
                                       rec["name"]],
                                   "frontend_train": frontend["train"][
                                       "launches"][rec["name"]],
                                   "family_train": fam["launches"][
                                       rec["name"]],
                                   "fault": fault["launches"][rec["name"]],
                                   "shard": shard["launches"][rec["name"]]}
    sk = fam["slstm_kernel"]
    for name in ("slstm_cell", "slstm_cell_bwd"):
        tm = sk["timing"][name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slstm.cu",
            "replaces": "src/repro/models/xlstm.py:276",
            "tpu_kernel": None,
            "replaces_note": ("no Pallas kernel: the JAX package's sLSTM "
                              "step (_slstm_step), plain jnp fused by XLA"),
            "launches": fam["launches"][name],
            "launches_per": "family_train's xlstm runs (one super-block: "
                            "1 eager + 2 graphed steps, 1 resumed)",
            "launches_by_path": {
                "family_train": fam["launches"][name],
                "xlstm_serve": xlstm["launches"][name]},
            "max_abs_err": max(sk["step_max_rel_err"][name].values()),
            "error_measure": "max |kernel - plain| over max |plain|, every "
                             "step of one layer's 4096",
            "scan_rel_l2": sk["scan_rel_l2"],
            **{k: tm[k] for k in ("ms", "device_ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "bmm_ms")},
            "kernel_ms": tm["ms"],
            "shape": sk["shape"],
        })
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
