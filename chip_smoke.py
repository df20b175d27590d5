#!/usr/bin/env python3
"""Drive the evr_tpu_torch port on one NVIDIA GPU and check it end to end.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit; it imports neither JAX nor the ``evr_tpu``
package. Phases, each fatal on failure:

1. the card: name and power limit (``nvidia-smi``); TF32 off for matmuls and
   cuDNN, so fp32 comparisons are full fp32;
2. build: every kernel of the main paths compiled from ``ops/csrc``; the
   SASS of the K1, K2, K9, K5a and K5b libraries (``cuobjdump -sass``) must
   hold ``HGMMA`` instructions, the wgmma products of ``csrc/gemm_sm90.cuh``,
   and in the K6 and K1 libraries each function of the bf16 attention
   forward (``attn_sm90_kernel``, ``csrc/attn_sm90.cuh``, head dims 16, 64
   and 80) must hold its own, as must each function of K5a's bf16 attention
   backward in the K5a library (``attn_bwd_q_kernel``,
   ``attn_bwd_kv_kernel``, ``csrc/attn_bwd_sm90.cuh``, head dims 16, 64 and
   80), and each function
   of K3's int8 GEMM in the K3 library (``gemm_s8_kernel``,
   ``csrc/gemm_s8_sm90.cuh``) must hold ``IGMMA`` instructions; ptxas's
   register and spill lines are printed, and its "wgmma serialised" notes
   for the int8 GEMM; each function of K7's ring walk in the K7 library
   (``adc_ring_kernel``, S 32, 64, 96, 128) must hold the TMA unit's bulk
   copies (``UBLKCP``), whose counts are printed with ``UTMALDG``'s;
3. the bf16 GEMM under K1, K2, K9 and K5 alone (``gemm_bf16``) at ViT-H-14's
   four vision GEMMs (65,792 rows), ViT-B/32's vision and text GEMMs, a
   ragged M, one tile and the tiny tower's four (N 64, 192 and 256: the
   narrow 64-wide tile), against ``torch.matmul`` in fp32 rounded once,
   and in K5's layouts (Aᵀ from a [K, M] array, Wᵀ from W's [in, out]
   array; bf16 or fp32 out) at the ten backward products of
   ViT-L/14@336px's training shape and its text shape, ViT-Tiny-Test's text
   training shape (W 64: the 64-wide tile in every layout), a ragged K and
   split weight gradients, against the fp32 product of the same inputs, each
   timed
   against ``torch.matmul`` on the same layout; the int8 GEMM under K3a and
   K3b alone (``gemm_s8``) at the four K3 products of ViT-B/32's vision and
   text shapes, ViT-L/14@336px's T 577, ViT-H-14, the tiny tower and a
   ragged M: its int32 sums equal to ``torch._int_mm``'s and the plain
   version's, each epilogue bit-equal to the plain version's (exact GELU
   within GEMM_S8_GELU_STEPS fp32 steps), timed against ``torch._int_mm``
   with and without its K-major copy of the weights; then kernel parity: K1
   (``fused_attn_block``), K2 (``fused_mlp_block``), K3a
   and K3b (``fused_attn_block_q``, ``fused_mlp_block_q``: the int8 halves)
   against their plain PyTorch versions at the ViT-B/32 main-path shapes,
   vision (B=256, T=50, W=768, H=12) and text (B=16, T=77, W=512, H=8,
   causal) and a ragged batch (B=3, T=50, W=768: 150 rows, K1 and K2), in
   bfloat16 and float32; K1's attention core alone (``attn_forward``) at
   the vision, text, ViT-L/14@336px and ViT-H-14 shapes and at two key rows
   of 1,000 (head dims 64 and 80, one causal), bf16 and fp32; and K1, K2,
   K3a and K3b at the
   ViT-L/14@336px training shape (B=32, T=577, W=1024, H=16) and at
   ViT-H-14's vision shape (B=32, T=257, W=1280, H=16: head dim 80, exact
   GELU), and K3a and K3b at the tiny tower's shapes; K4 (``fused_topk``) against
   its plain version on 1,048,576 index rows of 512 in int8, bf16 and fp32
   (rows equal, scores bit-equal), and, each with a negative control that
   the row check rejects, k above a 10-row range, tied rows across a tile's
   and a block's boundary in a second index, and indexes of 1,000 and 1,025
   rows;
   K5a and K5b (``fused_attn_block_bwd``, ``fused_mlp_block_bwd``: the block
   backward) against theirs at the training shape and at ViT-L/14's causal
   text shape (B=16, T=77, W=768, H=12), and K5a at head dim 80 (B=4,
   T=577, W=1280, H=16), bf16 and fp32, every output; K5a's attention
   backward alone (``attn_backward``, bf16) at the training, causal text and
   head-dim-80 shapes, at ViT-H-14's T=257 and at a causal key row of 1,000:
   o and each of dq, dk and dv against its plain version, and a second call
   bit-equal to the first; K5a and K5b at ViT-Tiny-Test's geometry (W 64,
   head dim 16: T 17, 77 causal and 577), bf16 and fp32, within the same
   bands, a second call bit-equal, and the attention backward alone at head
   dim 16 (W 256, H 16);
4. main path, bf16 weights: ``EmbeddingEngine("ViT-B/32", device="cuda")``
   with seeded random weights embeds 1,024 synthetic frames of four videos
   at batch 256, the data root is written, ``ServingContext`` boots from it
   and ``create_app`` answers /api/search requests: six text queries, each
   one uncached dispatch of the one-call ``TextSearcher`` (every text block,
   then ``cosine_topk``), and two with a negative query (two pooled-row text
   encodes each, then ``FrameIndex.search``); the exact launch counts of K1
   and K2 over that run, and the kernel path's embeddings and top-10
   rankings against the plain versions' on the same frames and queries;
   then phase 13's searchers and phase 14's routes over that root;
5. main path, int8: the same with ``params_dtype="int8"`` (K3) and an int8
   index under ``search_impl="pallas"``: the launch counts of K3a and K3b,
   ``cosine_topk`` once per searcher dispatch and never in the index, K4
   once per negative-query request; phases 13 and 14 over that root;
   then ``auto_params_dtype`` gates a float32 engine over that data root;
6. main path, training: ``python -m evr_tpu_torch.tools.finetune`` (its
   ``main``) fine-tunes ViT-L/14@336px at full width from
   ``--init-checkpoint``, a reference file of the seeded weights, with an
   EMA, on a synthetic caption set (96 train and 32 val images, batch 32,
   bf16, one epoch: 3 steps and 1 validation batch); the launch counts of
   K1, K2, K5a and K5b (and none of the plain backward), finite losses,
   the first step's loss equal to the same params' in memory, frozen leaves
   bit-unchanged and trainable ones moved in the final checkpoint; then
   ``best_model.pt`` served (``from_checkpoint``, the EMA): 256 frames of
   336² through K1/K2 at T 577 and six ``TextSearcher`` queries, launches
   exact, embeddings bit-equal to the Trainer's in-memory EMA's; then one
   step from the same params and batch through the kernels and through
   their plain versions (``attn_impl="plain_grad"``), held together within
   bands that a gradient perturbed to cosine 0.99 fails; the step time;
7. times: each kernel, its plain version and a PyTorch library computation
   of the same function, by CUDA events at the main-path shapes; K5a split
   into its attention backward alone (``attn_backward``, beside its bound
   and the backward of SDPA), its five GEMMs and the rest; K4 split into
   ``prepared_queries``, the scan, the selection and ``_merge``, and K4 on
   bf16 and fp32 rows and at Q = 5 and 32; K1's attention core alone (``attn_forward``) at ViT-H-14,
   ViT-L/14@336px, ViT-B/32 vision and text shapes against SDPA; encode
   frames/s and the p50 of a text query, bf16 and int8;
8. the ANN tiers: K7 (``adc_list_scores`` on gathered blocks, and
   ``adc_probe_scores`` on lists in place at repeated ids, the ring walk at S
   32, 64 and 128 and the direct walk, each new case with a negative control)
   against its plain version, bit for bit, its plan against
   ``ops.adc.adc_plan``, and a list id out of range faulting in a child
   process for each walk (phase 3); the bf16 data root of phase 4 served under
   ``search_impl="ivf"`` at a full probe (served events equal to the exact
   path's) and ``"ivfpq"`` with the int8 host store (the top-1 of perturbed
   corpus frames equal to the exact path's), each /api/search p50; then
   ``IVFPQIndex.build_device`` over 4,194,304 seeded clustered unit rows of
   512 (2,048 lists, S = 64, K = 256), built twice (identical codes),
   searched by 8 queries at nprobe 32 with ``adc_impl="pallas"`` (K7) and
   ``"xla"`` (same rows), recall@10 with and without an int8 re-rank of 50,
   the query p50 of both, K7's launches over those searches against the
   count expected (one a chunk of probes whose 17 bytes a row fit
   ``ivf.CHUNK_BYTES``), K7 on the search's own lists and probed ids, a
   ``torch.profiler`` split of the nprobe-32 query, the query with an id
   read-back and a full probe chunked as the gathered copy was, each in
   turns with the search as it is, and K7's times (the call in place by
   CUDA events and its launch's device time, and the parent's form: the
   probed lists gathered, then scored);
   then ``tools.index_tool`` ``build --streamed --host-store`` and
   ``query`` over a 262,144-row ``.npy``, its rows equal to a direct search,
   and ``query --query ... --checkpoint`` with phase 13's ViT-B/32 file;
9. the flash route: K6 (``flash_attention``: K6a ``flash_attention_full``,
   K6b ``flash_attention_blocked``) against its plain version at ViT-H-14's
   vision (B=256, H=16, T=257, d=80) and causal text (B=16, T=77, d=64)
   shapes, ViT-B/32's vision shape (T=50) and the padded route of an
   explicit ``block_q`` (B=32, T=257), bf16 and fp32 (phase 3); then
   ``EmbeddingEngine(cfg=get_model_config("ViT-H-14", attn_impl="flash"))``
   with seeded random weights serves the path of phase 4 (K6a 31 launches
   per encode batch, K6b 23 per text encode, K1 and K2 none; embeddings and
   rankings against ``attn_impl="flash_plain"``); the same weights train
   three ``make_train_step`` steps (batch 32, bf16, ``freeze_layers=8``): K6
   in every block's forward, the plain recompute backward, frozen leaves
   unchanged, a K6 step against a plain step within bands; K6's times; and
   the served path again with int8 block linears under "flash" (K6 launches
   as before, no K1-K3), unit embeddings and rankings against
   ``"flash_plain"`` within the int8 bands;
10. ViT-H-14 under its default configuration: ``EmbeddingEngine("ViT-H-14",
   params=..., device="cuda")`` with no ``cfg`` (``attn_impl="auto"``) serves
   the path of phase 4 through K1 and K2 at head dim 80 (vision, T=257,
   W=1280, exact GELU) and 64 (text), 31 launches of each per encode batch
   and 23 per text encode, K6 none, against ``attn_impl="plain"``; then with
   int8 weights through K3a and K3b, against the int8 plain route (phase 3
   holds K1, K2, K3a and K3b to their plain versions at that vision shape,
   and K5a at head dim 80, T=577; phase 7 times them there);
11. the exported ops no tower calls, as in the JAX package: K8
   (``ops.fused_layer_norm``) on 12,800 x 768, 65,792 x 1280 and 1,000 x 100
   rows, bf16 and fp32, with and without the quickGELU tail, against its
   plain version, timed against ``F.layer_norm``; K9
   (``ops.block_fused.fused_block_merged``) at ViT-B/32's vision and text
   shapes and ViT-H-14's vision shape, bf16 and fp32, bit-equal to
   ``fused_block_apply`` (K1 then K2), timed at each of those shapes
   against that pair, its plain version and the library composition. Their
   launches are counted over their own phases;
12. ViT-Tiny-Test (W 64, four heads of 16, T 17 and 77): K1, K2, K3a, K3b,
   K6a, K6b and K9 against their plain versions, bf16 and fp32; then
   ``EmbeddingEngine("ViT-Tiny-Test", device="cuda")`` with seeded random
   weights encodes 1,024 frames and the text queries through K1/K2 (bf16
   weights), K3a/K3b (int8 weights) and K6a/K6b (``attn_impl="flash"``),
   each route's launches counted, its unit embeddings against the plain
   route's within row cosine 0.999. Then int8 encode against bf16 at
   ViT-B/32 and ViT-H-14, and the share of K3's K-major weight copies;
13. checkpoints and the one-call searchers: a ViT-B/32 reference file of
   seeded weights and a classifier head (``save_reference_checkpoint``)
   served by ``EmbeddingEngine.from_checkpoint`` with bf16 and with int8
   weights, its 1,024 frame embeddings bit-equal to an engine built from the
   params in memory, ``classify`` on the card within 1e-5 of the plain head
   on the CPU; and, over phase 4's and phase 5's data roots,
   ``TextSearcher`` against the two-step path within the ranking bands
   (scores within 1e-5 under one query vector), the uncached text-query p50
   of both, 16 threads of single queries unbatched and under a 4 ms window
   (fewer dispatches than queries, bucket sizes, rows within the bands of
   the unbatched ones, and the check rejecting rows handed to the wrong
   query), and ``ImageSearcher`` finding 8 indexed frames as their own
   top-1 in one dispatch;
14. every route of the app over phase 4's and phase 5's roots, seeded
   metadata (OCR text with Vietnamese accents, objects, tags, captions) and a
   transcript per video written over them: /api/search with every method of
   ``SEARCH_METHODS`` and temporal, a Vietnamese query, a negative query (K4
   on the int8 root), image queries (each indexed frame its own top-1) and a
   hybrid query, each held to the same request through a twin engine on the
   plain route within the served ranking bands (metadata-decided events the
   same frames, metadata-only events equal), each check rejecting its
   negative control, the ranked and the set check a near miss too (the text
   vector turned to a row cosine of 0.999 toward the cut frame); the
   launches of K1/K2 (bf16) and K3a/K3b and K4 (int8) over those requests
   equal to what their dispatches imply; each method's p50 over 15
   requests, the methods in turns, every cache emptied before each, under
   50 ms, and the hybrid request's stages; the UI, a two-file SPA dist,
   events, frame and video files with Range and a traversal attempt,
   available videos, models and the active model, stats, transcribe (501,
   then a ``CallableTranscriber``), upload without a file (400) and the status
   of an unknown job (404); the UMAP route over the 1,024 frames, again from the cache
   and again after the cache is emptied (the same bytes); ``viz.umap`` on
   20,000 seeded clustered rows of 512 (the sparse tier), its share of
   kept nearest neighbours above PCA's, a random layout's below;
15. ingest and the upload routes at ViT-B/32's full width: seeded 1280 x 720,
   25 fps videos written with cv2 (a one-minute one with a hard cut every
   24-48 frames, two of 24 s) uploaded through the port's app on fresh data
   roots, with bf16 weights (the long one async, its stages polled through
   /api/upload-status/<id>; a short one with ``sync=1``) and with int8 weights
   and an int8 index under ``search_impl="pallas"`` (async); after each
   /api/search finds the new video, its rows are held to a plain-route twin
   over the same saved frames (row cosine and ranking bands, each with a
   control that must fail), and the launches of K1/K2 or K3a/K3b over the
   upload equal 11 an encode batch; K4 once in a negative query on the int8
   index; the long ingest split into decode + scene detection, frame
   extraction, staging and encode; ``embed_folder`` over 1,024 saved 1280 x
   720 JPEGs on the native pipelined path (an undecodable one skipped by
   index), against the stager alone and ``encode_staged_images`` alone, its
   rows equal to the latter's; cv2's JPEG decode against PIL's; an upload of
   bytes that are no video ending its job in "error";
16. the benchmark harness and the trainer variants: ``tools.evaluate.main``
   over 250 seeded 500 x 375 JPEGs with 5 captions each and a perturbed
   ViT-B/32 reference file (bf16, K1/K2; JSON, CSV and the three-sheet
   workbook, read back), each model's image and caption rows held to a
   plain-route twin over the same staged pixels and tokens (row cosine, each
   t2i / i2t rank within the served band of the twin's ground-truth score,
   R@K and MRR within the share of queries with a candidate in the band;
   rows off by cosine 0.999 and two images swapped must fail); ``--excel``
   on a multi-GT test set (P@K), ``--classification-dirs`` over three class
   folders of 64 JPEGs (the file's head, a probe, then ``--zeroshot``),
   ``tools.ab_compare`` and ``tools.diagnose`` (exit 0), K1/K2 launches equal
   to their encode batches; a ``ModelComparison`` over int8 weights
   (K3a/K3b) against its plain twin in the int8 bands; ``ProgressiveTrainer``
   at ViT-L/14@336px (both towers at full width, batch 32, bf16) through
   phases 1-3, two steps each, and ``CatLIPTrainer`` there, against
   ``plain_grad`` twins (losses, each phase's first step bit-still, each
   trainable leaf's update by cosine, an update turned to cosine 0.99
   rejected), K1/K2/K5a/K5b 24 launches a step in every phase; and
   ``ProjectionTrainer`` at ViT-B/32 (frozen CLIP), its ``encode_projected``
   through K1/K2 against a plain twin's rows;
17. the trainer's levers at ViT-L/14@336px (both towers at full width,
   batch 32, bf16, ``freeze_layers=8``), each against a ``plain_grad`` twin
   from the same params, batch and generator seed, the gradients each step
   feeds its optimizer held in phase 6's bf16 band (a gradient turned to
   cosine 0.99 rejected), the updates reported: (a) gradient accumulation
   over four calls (calls 1 and 3 bit-still, the emitted mean against the two
   calls' own gradients), (d) remat (gradients equal to (a)'s without remat,
   K1/K2 twice a block), (e) GradCache in 4 chunks (against the direct kernel
   step and its twin), (b) Muon (the Newton-Schulz share), (c) LoRA rank 16
   on both towers (the base bit-still, b held at step 1, a and b at step 2),
   (f) patch drop 0.1 (T 519, the kernels), (g) patch drop 0.5 (T 289: no
   kernel), (h) the projection trainer with its CLIP unfrozen and
   accumulation, each call's launches exact and the peak memory of (a), (d)
   and (e); (i) ``DistillationTrainer`` from ViT-L/14 (224 px) to ViT-B/32,
   the KD term alone, against a twin whose teacher runs the plain route (the
   teacher's rows, the KD loss and the student's gradients); then (j)
   ``tools.finetune.main --lora-rank 16`` (its ``lora_merged.pt`` served
   bit-equal to the merge in memory, its ``final_checkpoint.pt`` refused at
   serve time), (k) ``tools.distill.main`` (its ``student.pt`` served the same
   way) and (l) ``tools.train_sustained.main`` with its defaults but 16
   steps over a pool of 8 batches (examples/s, R@1/5/10 before and after);
18. the data axis: (a) ``FrameIndex(mesh=<4 slots of the card>)`` over
   100,000 seeded unit rows of 512, bf16 and int8, under ``search_impl=
   "pallas"`` (K4 on each slot, 4 launches a query batch) and ``"xla"``, rows
   equal to the one-device index's and scores within 1e-5, over the corpus
   and two videos (the first ends two rows into a shard), a shard moved by
   one row rejected, the p50 of a query at 1 and 4 slots; (b)
   ``EmbeddingEngine(mesh=<2 slots>)`` at ViT-B/32 through K1/K2 and on int8
   weights through K3a/K3b, unit rows against the one-device engine,
   ``ServingContext(mesh=)`` and ``python -m evr_tpu_torch.serving
   --shard-index`` (every local card; a child process on a localhost port) serving
   ``/api/search`` within the served bands of the one-device context; (c)
   ViT-L/14@336px, batch 32, bf16, ``freeze_layers=8``: the gradients over 2
   slots against 1 slot in the step bands (a 0.99 control rejected), K5a/K5b
   2 x 24 a step, then timed steps at 1 and 2 slots and under FSDP (its
   first loss and its updates against data parallelism's, the bytes a slot
   holds); (d) two processes on the card through ``tools.pod_launch`` (this
   script's ``--mesh-worker`` mode, Gloo), their gradients against (c)'s
   2-slot step, a failed run failing the phase; (e)
   ``tools.finetune.main --fsdp`` over the default mesh, two steps and an
   autosave after the first, then a run resumed from it whose loss equals
   the saved run's second step;
19. the other mesh axes: the sharded IVF and IVF-PQ tiers over 4 slots (K7),
   pipelined ViT-B/32 encodes (K1/K2, K3a/K3b), sequence-parallel
   ViT-L/14@336px encodes, tensor-parallel steps (K1/K2, K5), GradCache,
   Muon and accumulation over a mesh, and the tp and pp checkpoints
   (``phase_axes``);
20. the frame annotators at ViT-B/32's full width (``phase_annotators``): the
   local OCR's ``LocalOCRAnnotator(device="cuda")`` against
   ``device="cpu"`` on 1280 x 720 JPEGs with drawn lines of text (boxes and
   texts equal, logits within OCR_LOGIT_BAND, also under a caller's TF32,
   two crops swapped rejected), the held-out accuracy where the machine has
   the DejaVu fonts; the first OCR training step on the card against the
   CPU's and ``train_ocr`` for 200 steps; ``ZeroShotObjectAnnotator.
   annotate_batch`` over 64 frames (1,216 crops) with bf16 and int8 weights,
   K1/K2 and K3a/K3b launched exactly 11 an encode batch, the similarities
   within the served bands of a plain-route twin's, two regions swapped
   rejected; an upload with ``sync=1`` annotated by both, its records one a
   frame, found by ``keyword_only`` and ``object_only``;
21. the model families, no kernel of ``ops`` (every launch counter read
   before and after; ``phase_families``): (a) SigLIP base-224 on the card
   against the CPU (fp32, TF32 off): features and ``siglip_forward``'s
   logits; (b) SigLIP so400m-384 (width 1152, 27 layers, head dim 72, 729
   tokens) served through ``serving.__main__``'s engine construction with
   ``--model-family siglip``: 256 frames encoded with bf16 and int8 weights
   (the int8 product exact in float64) and by an fp32 reference, each booted
   from its own data root; /api/search text queries (the fallback
   tokenizer), image, hybrid and /api/models; rows and served top-10s held to
   the fp32 path's, encode frames/s, the text query's p50 and a profiler
   split; (c) ``fit_siglip`` at base-224, batch 32, fp32: the first step's
   loss and gradients on 4 pairs and Adam's first update against the CPU's,
   one step over a 2-slot data mesh against one slot in the fp32 step bands,
   three steps (the loss falls, both towers and ``logit_bias`` move); (d)
   Whisper large-v3 (seeded params drawn on the card, the decoder spread)
   over two 30 s windows of seeded audio, ``max_len`` 64: the KV-cached
   greedy decode's ids equal to a full re-run's and its logits within a band
   that a decode with a zeroed cache row fails, bf16 teacher-forced logits
   against fp32, Whisper base on the card against the CPU (log-mel and
   logits), tokens/s; (e) ``tools.transcribe.main --random-init --size
   large-v3 --raw-ids --segments-out`` into a served root's metadata, the
   root booted again and a ``speech_only`` query returning the transcribed
   videos only, ``LocalWhisperTranscriber`` answering /api/transcribe-voice;
22. the MoE towers and the prefix captioner (``phase_moe_captioner``): (a)
   ViT-B/32 MoE serving, bf16 (8 experts, top-2, every 2nd block, capacity
   1.25, groups of 256; upcycled from seeded dense params, the experts moved
   apart by seeded noise): 512 frames at batch 256 and text queries, rows
   against the fp32 plain route on the card (row cosine, a turned-row
   control), K1 once a block (the MoE blocks' attention halves too) and K2
   once a dense block an encode batch, exactly; the upcycled towers before
   the noise (room for every token) against the dense engine; the MoE file
   served through ``serving.__main__``'s ``--checkpoint`` and /api/search;
   (b) ``tools.finetune.main --moe-experts 8``, batch 32, 3 steps, bf16
   (``moe_aux`` finite, the file's MoEConfig), and a (data 2, expert 2) slot
   mesh's first step against one device's (fp32: loss and gradients by leaf
   in the fp32 step bands, a 0.99 control rejected); (c) the captioner at
   ``CaptionerConfig``'s defaults: ``PrefixCaptioner.caption_batch`` over 64
   JPEGs (K1/K2 11 each) and through ``annotate_folder``, the cached greedy
   decode against a full re-run (ids equal, logits in a band a zeroed cache
   row fails), beam 1 equal to greedy, and ``tools.train_captioner`` (XE,
   then two SCST epochs; its reward's text encodes through K1/K2 counted)
   with its checkpoint reloaded.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, same sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, same sheet
H100_BYTES_PER_S = 3.35e12

VISION = dict(B=256, T=50, W=768, H=12, causal=False)
TEXT = dict(B=16, T=77, W=512, H=8, causal=True)
# ViT-L/14@336px at the training batch: its vision tower, which trains through
# K1/K2 and K5a/K5b, and its (causal) text tower
VITL = dict(B=32, T=577, W=1024, H=16, causal=False)
VITL_TEXT = dict(B=16, T=77, W=768, H=12, causal=True)
# ViT-H-14's vision tower (16 heads of 80, exact GELU), the widest the fused
# route takes: K1-K3 parity at a batch cut to 32 (VITH), their times at the
# serving batch (VITH_SERVE), and K5a's parity at head dim 80 and T = 577 at
# the kernel level (VITH_BWD: no registry tower with head dim 80 trains at
# T >= 512, where the fused backward runs)
VITH = dict(B=32, T=257, W=1280, H=16, causal=False, act="gelu")
VITH_SERVE = dict(VITH, B=256)
VITH_BWD = dict(B=4, T=577, W=1280, H=16, causal=False)
# A ragged row count for K1 and K2 (150 rows: one full 128-row GEMM tile and
# a part-filled one)
RAGGED = dict(B=3, T=50, W=768, H=12, causal=False)
# ViT-Tiny-Test (W 64, four heads of 16 in both towers): its vision tower at
# the serving batch (256 frames of 17 tokens) and its causal text tower (16
# queries of 77 tokens). Its GEMMs have N of 64, 192 and 256 (the narrow
# 64-wide tiles) and its attention head dim 16 (phase 12)
TINY_MODEL = "ViT-Tiny-Test"
TINY = dict(B=256, T=17, W=64, H=4, causal=False)
TINY_TEXT = dict(B=16, T=77, W=64, H=4, causal=True)
# The bf16 GEMM under K1, K2 and K9 alone: ViT-H-14's four vision GEMMs at
# the serving batch (256 x 257 rows), ViT-B/32's vision (256 x 50 rows) and
# text (16 x 77 rows) GEMMs, a ragged M and a single 128 x 256 x 64 tile, as
# (M, N, K). Against the fp32 product of the same bf16 inputs plus the bias,
# rounded once: the two fp32 sums differ only in their order, by far less
# than a bf16 step, so a rounded output may move by one bf16 step at its own
# magnitude; the band is GEMM_TOL_STEPS bf16 steps at the output's largest
# magnitude.
GEMM_SHAPES = {
    "vith-qkv": (65792, 3840, 1280), "vith-out": (65792, 1280, 1280),
    "vith-fc": (65792, 5120, 1280), "vith-proj": (65792, 1280, 5120),
    "vitb-qkv": (12800, 2304, 768), "vitb-out": (12800, 768, 768),
    "vitb-fc": (12800, 3072, 768), "vitb-proj": (12800, 768, 3072),
    "text-qkv": (1232, 1536, 512), "text-out": (1232, 512, 512),
    "text-fc": (1232, 2048, 512), "text-proj": (1232, 512, 2048),
    "ragged": (150, 768, 768), "one-tile": (128, 256, 64),
    "tiny-qkv": (4352, 192, 64), "tiny-out": (4352, 64, 64), "tiny-fc": (4352, 256, 64),
    "tiny-proj": (4352, 64, 256),
}
GEMM_TOL_STEPS = 1
# The same GEMM in the layouts and outputs of K5's ten products, as (M, N,
# K, a_t, w_t, out_dtype, bias): aᵀ read from a [K, M] array for the weight
# gradients, wᵀ from W's [in, out] array for the input gradients. At
# ViT-L/14@336px's training shape (18,464 rows, W 1,024, hidden 4,096) and
# its causal text shape (1,232 rows, W 768, hidden 3,072), ViT-Tiny-Test's
# text training shape (2,464 rows, W 64, hidden 256: N 64 and 192 on the
# 64-wide tile in every layout, its weight gradients split in two), a
# ragged K below one 64-row step, and a weight gradient split into four
# slices of rows
# (dW_out at W 1,024: 32 output tiles; it is timed in one pass too). K5b's
# two activation epilogues are run here in their layouts with
# the plain bf16 output (h_pre: the forward layout; dh: wᵀ); K5b's parity
# checks the epilogues themselves. Against the fp32 product of the same bf16
# inputs (torch.matmul on the transposed views): bf16 outputs within
# GEMM_TOL_STEPS bf16 steps as above; fp32 outputs within BWD_GEMM_F32_REL
# of the output's largest entry. Only the order of the fp32 sums differs
# (over up to 18,464 rows, and the slice order of a split): the largest such
# error was 2.47e-5 (dW_proj at the training shape, one pass over 18,464
# rows; 5.1e-6 for the split dW_out) in this script's run on an H100 80GB
# HBM3 (700 W), and the band is about twice that. Each run shows it
# rejecting an output whose largest entry moved by one bf16 step (about
# 6e-3 of it).
def _bwd_gemms(tag: str, R: int, W: int, hid: int) -> dict:
    bf, f32 = "bfloat16", "float32"
    return {
        f"{tag}-K5a-qkv": (R, 3 * W, W, False, False, bf, True),
        f"{tag}-K5a-do": (R, W, W, False, True, bf, False),
        f"{tag}-K5a-dW_qkv": (W, 3 * W, R, True, False, f32, False),
        f"{tag}-K5a-dy": (R, W, 3 * W, False, True, f32, False),
        f"{tag}-K5a-dW_out": (W, W, R, True, False, f32, False),
        f"{tag}-K5b-h_pre": (R, hid, W, False, False, bf, True),
        f"{tag}-K5b-dW_proj": (hid, W, R, True, False, f32, False),
        f"{tag}-K5b-dh": (R, hid, W, False, True, bf, False),
        f"{tag}-K5b-dW_fc": (W, hid, R, True, False, f32, False),
        f"{tag}-K5b-dy": (R, W, hid, False, True, f32, False),
    }


BWD_GEMM_SHAPES = {
    **_bwd_gemms("vitl", 32 * 577, 1024, 4096),
    **_bwd_gemms("text", 16 * 77, 768, 3072),
    **_bwd_gemms("tiny", 32 * 77, 64, 256),
    "ragged-k": (256, 512, 40, True, False, "float32", False),
}
BWD_GEMM_F32_REL = 5e-5
# K1's attention core alone (``ops.block_fused.attn_forward``, no path calls
# it) on the packed qkv [B, T, 3W]: held to its plain version at the block
# halves' shapes (tolerances as for K1) and at two key rows longer than the
# kernel's resident k slots (T 1,000, head dims 64 and 80, one causal), so
# that k streams through both walks; timed at ATTN_CORE_TIMED against SDPA on
# q, k, v views of the same qkv
ATTN_CORE_SHAPES = {
    "vith": VITH_SERVE, "vitl": VITL, "vitb": VISION, "text": TEXT,
    "long-d64": dict(B=2, T=1000, W=512, H=8, causal=False),
    "long-d80": dict(B=2, T=1000, W=640, H=8, causal=True),
}
ATTN_CORE_TIMED = ("vith", "vitl", "vitb", "text")
# the libraries whose bf16 GEMMs run on csrc/gemm_sm90.cuh's wgmma kernel
HGMMA_LIBS = ("block_attn", "block_mlp", "block_merged", "block_attn_bwd", "block_mlp_bwd")
# K3a's and K3b's int8 GEMM (csrc/gemm_s8_sm90.cuh): every function of it in
# the block_quant library (five epilogues x two element types x two tile
# widths) must hold warpgroup int8 products, IGMMA in the SASS
S8_LIB, S8_KERNEL, S8_FUNCTIONS = "block_quant", "gemm_s8_kernel", 20
# The int8 GEMM alone (``ops.block_fused.gemm_s8``, no path calls it) at the
# four K3 products (qkv, out, fc, proj: M, N, K and the epilogue K3 runs
# them with) of ViT-B/32's vision and text shapes, ViT-L/14@336px's T 577,
# ViT-H-14's vision shape (exact GELU), the tiny tower and a ragged M; as
# (rows, W, activation). Its int32 sums must equal torch._int_mm's and the
# plain version's exactly, and each epilogue its plain version's bit for
# bit, in bf16 and fp32, but exact GELU: the kernel's erf (common.cuh's
# erf_as, the same device code as the parent's WMMA kernel) is contracted
# into FMAs by nvcc, PyTorch's plain one rounds each operation, and the two
# differed by up to 4.768e-7, 2.00 fp32 steps of max(1, |plain|), on about a
# third of the outputs, in this script's run on an H100 80GB HBM3 (700 W).
# Exact GELU is held to GEMM_S8_GELU_STEPS such steps instead, about twice
# that. (quickGELU's kernel arithmetic and the plain version's gave the same
# bits there.)
GEMM_S8_SHAPES = {
    "vitb": (12800, 768, "quick_gelu"), "text": (1232, 512, "quick_gelu"),
    "vitl": (18464, 1024, "quick_gelu"), "vith": (65792, 1280, "gelu"),
    "tiny": (4352, 64, "quick_gelu"), "ragged": (150, 768, "gelu"),
}
GEMM_S8_GELU_STEPS = 4
# the libraries whose bf16 attention forward runs on csrc/attn_sm90.cuh's
# wgmma kernel (K6; K1, and through it the core of K3a and K9), and that
# kernel's function name: its own SASS function must hold HGMMA instructions
ATTN_HGMMA_LIBS = ("flash_attn", "block_attn")
ATTN_KERNEL = "attn_sm90_kernel"
# K5a's attention backward alone (``ops.block_fused.attn_backward``, no path
# calls it) on the packed qkv and do: in bf16 the two TMA + wgmma kernels of
# csrc/attn_bwd_sm90.cuh, whose functions in the block_attn_bwd library
# (ATTN_BWD_KERNELS at head dims 64 and 80) must each hold HGMMA
# instructions. Held to attn_backward_plain at ViT-L/14@336px's training
# shape, ViT-L/14's causal text shape, head dim 80 at T 577 (its key row
# streams through the slots) and at ViT-H-14's T 257 (a one-row tail tile),
# and a causal key row of 1,000 that streams; a second call must repeat the
# first bit for bit.
ATTN_BWD_SHAPES = {
    "vitl": VITL, "vitl-text": VITL_TEXT, "d80-577": VITH_BWD,
    "d80-257": dict(B=32, T=257, W=1280, H=16, causal=False),
    "long-causal": dict(B=2, T=1000, W=512, H=8, causal=True),
}
ATTN_BWD_LIB = "block_attn_bwd"
ATTN_BWD_KERNELS = ("attn_bwd_q_kernel", "attn_bwd_kv_kernel")
ATTN_BWD_HEAD_DIMS = (16, 64, 80)  # each kernel's functions in that library
# K5a/K5b at ViT-Tiny-Test's geometry (W 64, four heads of 16: the 64-wide
# tile in the transposed GEMMs, the attention backward at d 16): the tiny
# towers' T 17 and causal 77 at the training batch, and T 577, against their
# plain versions within the BWD_* bands; K5a's attention backward alone at d
# 16 on a wider block (W 256, H 16) within the ATTN_BWD_* bands. Each call
# repeated must give the same bits.
TINY_BWD_SHAPES = {
    "tiny": dict(B=32, T=17, W=64, H=4, causal=False),
    "tiny-text": dict(B=32, T=77, W=64, H=4, causal=True),
    "tiny-577": dict(B=4, T=577, W=64, H=4, causal=False),
}
TINY_ATTN_BWD_SHAPES = {
    "d16-577": dict(B=4, T=577, W=256, H=16, causal=False),
    "d16-text": dict(B=16, T=77, W=256, H=16, causal=True),
}
# Bands against attn_backward_plain on these inputs (qkv of unit variance, do
# of 0.01 x unit): both round at the same points, so an output differs where
# a sum in another order rounds the other way. The parent's kernels
# (flash.cuh's WMMA backward) measured, on these inputs, in one call on an
# H100 80GB HBM3 (700 W) with `python -m evr_tpu_torch.tools.attn_bench
# --parts bwd`: o within 3.906e-3 (one bf16 step, the causal text shape),
# each of dq, dk and dv within 2.007e-3 of its largest entry (dq at the
# training shape), float64 cosines at least 0.9999999994. Each band is about
# twice that.
ATTN_BWD_O_TOL = 8e-3
ATTN_BWD_REL = 4e-3
ATTN_BWD_MIN_COS = 0.9999999988
FP32_TOL = 2e-4  # max abs, fp32 kernel vs plain version (accumulation order only)
BF16_TOL = 3e-2  # max abs on unit-variance activations: about 2 bf16 ulps below 4
BF16_MIN_COS = 0.9999  # per output row, bf16
EMBED_MIN_COS = 0.999  # kernel-path vs plain-path frame embeddings, per row
# A frame may cross the top-10 cut between the kernel path and the plain
# path only where the plain path scores it this close to its own 10th score.
# Under one query vector the two frame paths' scores differed by at most
# 1.3e-3 on an H100 with this script (text queries; 2.7e-4 for frame
# queries): ONE_VECTOR_RANK_NOISE is about twice that. With each path's own
# text vectors, as /api/search ranks, they differed by up to 1.9e-3:
# SERVED_RANK_NOISE is about twice that.
ONE_VECTOR_RANK_NOISE = 2.5e-3
SERVED_RANK_NOISE = 4e-3
# K3 against its plain version. Both share every rounding point; a LayerNorm
# or head output that differs in its last bit (sums in another order) can
# move one activation across a quantisation step, which changes an output by
# one int8 step of that product: up to 3.5e-3 in fp32 in a probe run on an
# H100 (7.8e-3 / 1.6e-2 in bf16, one and two bf16 steps below 4). The limits
# are about three times that in fp32 and BF16_TOL in bf16.
INT8_FP32_TOL = 1e-2
INT8_MIN_COS = 0.99999  # per output row; the probe's worst was 0.999998
# The int8 main path's kernel-vs-plain ranking bands, chosen as the bf16
# ones were: about twice the largest score difference between the int8
# kernel path and the int8 plain path, which this script measured on an
# H100 as 2.05e-3 under one query vector (text queries; 4.7e-4 for frame
# queries) and 3.83e-3 with each path's own text vectors.
INT8_ONE_VECTOR_RANK_NOISE = 4e-3
INT8_SERVED_RANK_NOISE = 8e-3
# ViT-H-14 on int8 weights (the default route through K3, and "flash"): on
# random weights its 32 vision blocks leave the frame embeddings so alike
# that the int8 bands hold nearly every frame around each top-10 cut (all
# 1,024 for frame queries in a probe run on an H100 80GB HBM3 at 700 W), so
# the ranking check cannot reject anything there. These paths are held to a
# tighter row-cosine band instead: the int8 kernel path's unit rows against
# the plain path's were at least 0.999676 (text) and 0.999782 (frames) in
# that run, a gap of at most 3.2e-4; the band allows about twice that, and
# still rejects rows off by cosine 0.999.
VITH_INT8_MIN_COS = 0.99935
# K4 on an index of TOPK_ROWS x TOPK_DIM: rows must be equal; scores within
# 1e-5 (fp32 rows) or 1e-3 (int8/bf16), though the plain version sums in the
# kernel's order and so should agree to the bit.
TOPK_ROWS, TOPK_DIM = 1 << 20, 512
TOPK_SCORE_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "int8": 1e-3}
# K5a/K5b against their plain versions (cotangents of 0.01 x unit scale).
# fp32: only the order of sums differs; the largest error relative to the
# output's largest entry was 6.4e-6 (K5b's dW_proj at the ViT-L/14@336px
# vision shape, where each weight gradient sums 18,464 rows) in this
# script's run on an H100 80GB HBM3 (700 W). bf16: both round at the same
# points, so an output differs where a sum in another order rounds the
# other way: dx by one bf16 step (6.6e-3 of its largest entry), a parameter
# gradient by up to 8.1e-4 of its largest entry; every output's cosine was
# at least 0.999999 (per dx row, per gradient leaf). Each band is about
# twice the measurement.
BWD_FP32_REL = 1.5e-5
BWD_BF16_DX_REL = 1.6e-2  # two bf16 steps
BWD_BF16_GRAD_REL = 2e-3
BWD_MIN_COS = 0.999998
BWD_OUTPUTS = {
    "fused_attn_block_bwd": ("dx", "ln_1.scale", "ln_1.bias", "qkv.kernel", "qkv.bias",
                             "out.kernel", "out.bias"),
    "fused_mlp_block_bwd": ("dx", "ln_2.scale", "ln_2.bias", "fc.kernel", "fc.bias",
                            "proj.kernel", "proj.bias"),
}
TRAIN_MODEL, TRAIN_BATCH, N_TRAIN, N_VAL = "ViT-L/14@336px", 32, 96, 32
# One step from the same params and batch through the kernels (K1/K2,
# K5b/K5a on the vision tower) and through attn_impl="plain_grad" (their
# plain versions there, the composition on the text tower in both): bands on
# the relative differences of the loss and the gradient norm and on the
# least gradient-leaf cosine. This script measured on an H100 80GB HBM3
# (700 W), two runs alike: fp32 6.4e-8, 1.3e-7 and 0.9999998 over all 434
# trainable leaves; bf16 9.3e-5, 1.6e-3 and 0.99839 over the vision blocks'
# 286 leaves (0.9875 for the classifier's fc1, whose gradient is a
# near-cancelling sum over the batch). Each band is about twice the
# measurement; a gradient perturbed to cosine 0.99 must fail the leaf check.
STEP_FP32_BANDS = (1.5e-7, 3e-7, 0.9999995)
STEP_BF16_BANDS = (2e-4, 3e-3, 0.9968)
# K7 against its plain version: both sum each row over s in order, so they
# must agree to the bit (and within 1e-6 of the output's largest entry, the
# band of the JAX parity). Its ring walk is instantiated for each S of
# ``ops.adc.RING_SUBSPACES``.
ADC_REL_TOL = 1e-6
ADC_LIB, ADC_RING_KERNEL = "adc_list", "adc_ring_kernel"
# K7 over lists in place (adc_probe_scores): (L, C, S, K, list ids [B][n]),
# each with a negative control; repeated and unordered ids on the ring walk,
# the ragged direct-load shape, the ring at S 32 and 128 (one row a lane), and
# the direct walk's 16-byte loads on an unaligned view of the codes
ADC_PROBE_CASES = {
    "ring L=40 C=1000 S=64 K=256 repeated ids": (40, 1000, 64, 256, [[3, 17, 3, 39, 0, 17], [5, 5, 22, 1, 38, 9]]),
    "direct L=9 C=517 S=20 K=100": (9, 517, 20, 100, [[8, 0, 4], [4, 4, 1]]),
    "ring L=12 C=777 S=32 K=256": (12, 777, 32, 256, [[11, 2, 7, 7], [0, 1, 2, 3], [6, 10, 6, 4]]),
    "ring L=10 C=3072 S=128 K=256": (10, 3072, 128, 256, [[9, 1], [4, 4]]),
    "direct L=10 C=300 S=64 K=256 unaligned": (10, 300, 64, 256, [[2, 9, 2], [0, 5, 7]]),
}
# The large IVF-PQ tier: ANN_ROWS unit rows of ANN_DIM (4,194,304 x 512 fp32,
# 8 GB: about 1,165 hours of video at one frame a second), ANN_CENTRES seeded
# centres with ANN_NOISE per dimension, 2,048 lists (capacity 1.5 x 2,048 =
# 3,072 rows), searched by ANN_B queries (corpus rows perturbed by a noise
# vector of norm ANN_QUERY_PERTURB) at nprobe ANN_NPROBE, timed over
# ANN_TIMED searches per impl.
ANN_ROWS, ANN_DIM, ANN_CENTRES, ANN_NOISE = 1 << 22, 512, 8192, 0.05
ANN_LISTS, ANN_CAPACITY, ANN_B, ANN_NPROBE, ANN_TIMED = 2048, 3072, 8, 32, 20
ANN_QUERY_PERTURB = 0.3
TOOL_ROWS = 1 << 18  # the .npy that tools.index_tool builds from
# Serving under the ANN tiers: at a full probe IVF scores the same rows as
# the exact path, in another order of sums (fp32): a served frame may differ
# only within ANN_FULL_PROBE_NOISE of the exact 10th score. IVF-PQ's top-1
# on corpus frames perturbed by noise of norm ANN_FRAME_PERTURB is the exact
# path's, or scored by the exact path within ANN_INT8_NOISE of its top-1
# (the int8 host store re-ranks: one quantisation step of a unit row moves a
# score by up to about 4e-3).
ANN_FULL_PROBE_NOISE = 1e-5
ANN_FRAME_PERTURB = 0.05
ANN_INT8_NOISE = 4e-3
# K6 (``ops.attention``) at the flash route's shapes: ViT-H-14's vision
# tower (K6a, head dim 80), ViT-B/32's vision tower under "flash" (K6a, the
# shape the TPU kernel packs four sequences to a tile), ViT-H-14's causal text
# tower (K6b) and the padded non-causal route that an explicit block_q takes
# (K6b). Inputs of unit variance; tolerances as for K1 (FP32_TOL, BF16_TOL,
# BF16_MIN_COS).
FLASH_SHAPES = {
    "vith-vision": dict(B=256, H=16, T=257, d=80, causal=False, block_q=None),
    "vitb-vision": dict(B=256, H=12, T=50, d=64, causal=False, block_q=None),
    "vith-text": dict(B=16, H=16, T=77, d=64, causal=True, block_q=None),
    "vith-vision-block_q": dict(B=32, H=16, T=257, d=80, causal=False, block_q=128),
}
# the shape each K6 route is timed and reported at: the ViT-H-14 main path's
FLASH_MAIN_SHAPE = {"flash_attention_full": "vith-vision", "flash_attention_blocked": "vith-text"}
# The flash route's main path: ViT-H-14 served and trained under
# attn_impl="flash" (FLASH_TRAIN_STEPS steps of make_train_step at batch
# TRAIN_BATCH). Its bands against the same path with K6's plain version,
# chosen as the bf16 ones were: about twice the largest difference this
# script measured on an H100 80GB HBM3 (700 W). Served scores differed by
# 1.27e-3 under one query vector (1.5e-4 for frame queries) and 1.74e-3 with
# each path's own text vectors, so the ViT-B/32 bands fit. A K6 step and a
# plain step from the same params and batch: fp32 0, 0 and a least leaf
# cosine of 0.9999998 over all 674 trainable leaves (STEP_FP32_BANDS fit);
# bf16 2.0e-4, 7.8e-3 and 0.99694 over the 662 block leaves of both towers.
# A gradient perturbed to cosine 0.99 must fail the leaf band.
FLASH_MODEL, FLASH_TRAIN_STEPS = "ViT-H-14", 3
FLASH_ONE_VECTOR_RANK_NOISE = ONE_VECTOR_RANK_NOISE
FLASH_SERVED_RANK_NOISE = SERVED_RANK_NOISE
FLASH_STEP_FP32_BANDS = STEP_FP32_BANDS
FLASH_STEP_BF16_BANDS = (4e-4, 1.6e-2, 0.9939)
# K8 (``ops.fused_layer_norm``) on the rows of the towers' LayerNorms:
# ViT-B/32's vision blocks at the serving batch (256 x 50 rows of 768),
# ViT-H-14's (256 x 257 rows of 1280), and a ragged case (1,000 rows of 100,
# not a multiple of 32 or 8); timed at ViT-H-14's rows. Tolerances as for K1.
LN_CASES = {"vitb-vision": (12800, 768), "vith-vision": (65792, 1280), "ragged": (1000, 100)}
LN_MAIN_CASE = "vith-vision"
# K9 (``fused_block_merged``) at ViT-B/32's vision and causal text shapes
# (quickGELU) and ViT-H-14's vision shape (head dim 80, exact GELU, the
# parity batch of VITH); bit-equal to fused_block_apply, and within the K1/K2
# tolerances of its plain version
MERGED_SHAPES = {"vision": VISION, "text": TEXT, "vith": VITH}
MODEL = "ViT-B/32"
N_FRAMES, N_VIDEOS, BATCH = 1024, 4, 256
N_FRAME_QUERIES = 8
QUERIES = (
    "a red car on a street", "people walking in a park", "a dog running",
    "a crowd at a concert", "a boat on the water", "text on a sign",
)
# /api/search requests with a negative query (text_clip): each scores the
# composite direction normalise(q+ - w q-) through FrameIndex.search (K4 under
# search_impl="pallas"), its two texts encoded by the engine's pooled-row path
NEGATIVE_REQUESTS = (("people at a market", "a parked bicycle"), ("a river at dawn", "a boat on a lake"))
N_NEGATIVE_TEXTS = len({t for pair in NEGATIVE_REQUESTS for t in pair})
# The one-call searchers (phase 13): each path fetches SEARCH_FETCH rows, so a
# row that leaves one path's top SEARCH_K is scored by the other; under one
# query vector the searcher's scores must match the index search's within
# SEARCHER_SCORE_TOL on the rows both return (both sum 512 fp32 products)
SEARCH_K, SEARCH_FETCH, SEARCHER_SCORE_TOL = 10, 40, 1e-5
BATCH_WINDOW_MS, SEARCHER_MAX_BATCH = 4.0, 16
BUCKETS = (1, 2, 4, 8, 16)
THREAD_ROUNDS = 2  # measured rounds of each searcher, after one warm-up round each
THREAD_QUERIES = (  # one a thread
    "a man riding a horse", "two dogs in the snow", "a burning building", "children on a beach",
    "a train at a station", "a woman singing on stage", "cars stuck in traffic", "a cat on a sofa",
    "soldiers marching", "a plate of food", "an airplane taking off", "people dancing at a party",
    "a storm over the sea", "a football match", "a police car with lights", "an empty classroom",
)
N_THREADS = len(THREAD_QUERIES)
P50_QUERIES = 20
N_IMAGE_QUERIES = 8
# Checkpoints (phase 13): a ViT-B/32 reference file of seeded weights (seed
# CKPT_SEED, not the engines' 0) and a seeded classifier head; classify on
# the card against the plain head on the CPU within CLASSIFY_TOL
CKPT_SEED, CLASSIFY_TOL = 5, 1e-5
# The fine-tune of phase 6 keeps an EMA (so best_model.pt serves it); the
# ViT-L/14@336px engine then encodes TRAIN_SERVE_FRAMES frames of 336^2
TRAIN_EMA_DECAY, TRAIN_SERVE_FRAMES = 0.999, 256


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. the card -------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# -- shared helpers ----------------------------------------------------------


def block_params(torch, W: int, gen, device):
    """One residual block's fp32 parameters at CLIP's init scales."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    proj_std = W ** -0.5 * (2 * 12) ** -0.5
    return {
        "ln_1": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "attn": {
            "qkv": {"kernel": normal((W, 3 * W), W ** -0.5), "bias": normal((3 * W,), 0.02)},
            "out": {"kernel": normal((W, W), proj_std), "bias": normal((W,), 0.02)},
        },
        "ln_2": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "mlp": {
            "fc": {"kernel": normal((W, 4 * W), (2 * W) ** -0.5), "bias": normal((4 * W,), 0.02)},
            "proj": {"kernel": normal((4 * W, W), proj_std), "bias": normal((W,), 0.02)},
        },
    }


def unit_activations(torch, shape, gen, device):
    """Unit-variance activations, uniform on [-sqrt 3, sqrt 3]."""
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * math.sqrt(3.0)


def compare(torch, got, ref):
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    err = (g - r).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=-1).min().item()
    finite = bool(torch.isfinite(g).all().item())
    return err, cos, finite


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -- 2. build ----------------------------------------------------------------


def sass_functions(sass: str, mnemonic: str = "HGMMA") -> dict[str, int]:
    """``mnemonic`` instructions (HGMMA: bf16 warpgroup products; IGMMA:
    int8 ones) per function of ``cuobjdump -sass`` output, split at each
    ``Function :`` header."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and mnemonic in line:
            counts[name] += 1
    return counts


def phase_build():
    from evr_tpu_torch.ops import build

    t0 = time.perf_counter()
    times = build.build()
    total = time.perf_counter() - t0
    for name in build.KERNEL_SOURCES:
        path = build.library_path(name)
        check(path.exists(), f"{name}: no library after the build")
        report = path.with_suffix(".log")
        if report.exists():
            current = ""
            for line in report.read_text().splitlines():
                if "Compiling entry function" in line:
                    current = line.split("'")[1] if "'" in line else line
                serialised = "C7514" in line or "C7515" in line
                if S8_KERNEL in line and serialised:
                    log(f"  ptxas {name} (int8 GEMM, wgmma serialised): {line.strip()}")
                elif "spill" in line or "registers" in line or "C7515" in line:
                    tag = " (attention forward)" if ATTN_KERNEL in current else ""
                    if S8_KERNEL in current:
                        tag = " (int8 GEMM)"
                    for k in ATTN_BWD_KERNELS:
                        if k in current:  # the mangled name holds the head dim as ILi16E / ILi64E / ILi80E
                            d = next((d for d in ATTN_BWD_HEAD_DIMS if f"ILi{d}E" in current), "?")
                            tag = f" (attention backward: {k}<{d}>)"
                    log(f"  ptxas {name}{tag}: {line.strip()}")
    log(f"build: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"total {total:.1f} s (0 = already built)")
    # the bf16 GEMMs of K1, K2, K9 and K5 must be wgmma products in the binary,
    # and so must the bf16 attention forward and backward in their own kernel
    # functions
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    counts, attn, bwd = {}, {}, {}
    for name in sorted(set(HGMMA_LIBS) | set(ATTN_HGMMA_LIBS) | {S8_LIB}):
        sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = sum("HGMMA" in line for line in sass.splitlines())
        if name in ATTN_HGMMA_LIBS:
            attn[name] = {f: n for f, n in sass_functions(sass).items() if ATTN_KERNEL in f}
        if name == ATTN_BWD_LIB:
            bwd = {f: n for f, n in sass_functions(sass).items() if any(k in f for k in ATTN_BWD_KERNELS)}
        if name == S8_LIB:
            s8 = {f: n for f, n in sass_functions(sass, "IGMMA").items() if S8_KERNEL in f}
    log(f"sass: HGMMA instructions per library {json.dumps(counts)}")
    log(f"sass: HGMMA instructions in each {ATTN_KERNEL} function {json.dumps(attn)}")
    log(f"sass: HGMMA instructions in each attention backward function of {ATTN_BWD_LIB} {json.dumps(bwd)}")
    log(f"sass: IGMMA instructions in each {S8_KERNEL} function of {S8_LIB} {json.dumps(s8)}")
    # K7's ring walk streams its tiles and tables by the TMA unit's bulk
    # copies (UBLKCP; UTMALDG would be tensor-map loads)
    from evr_tpu_torch.ops.adc import RING_SUBSPACES

    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(ADC_LIB))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    tma = {m: {f: n for f, n in sass_functions(sass, m).items() if ADC_RING_KERNEL in f} for m in ("UBLKCP", "UTMALDG")}
    log(f"sass: TMA instructions in each {ADC_RING_KERNEL} function of {ADC_LIB} {json.dumps(tma)}")
    check(len(tma["UBLKCP"]) == len(RING_SUBSPACES),
          f"{ADC_LIB}: {len(tma['UBLKCP'])} {ADC_RING_KERNEL} functions, expected {len(RING_SUBSPACES)}")
    for f, n in tma["UBLKCP"].items():
        check(n > 0, f"{ADC_LIB}: no bulk copy (UBLKCP) in {f}")
    for name in HGMMA_LIBS:
        check(counts[name] > 0, f"{name}: no HGMMA instruction in its SASS")
    for name in ATTN_HGMMA_LIBS:
        check(len(attn[name]) == 3, f"{name}: {len(attn[name])} {ATTN_KERNEL} functions, expected 3 (d 16, 64, 80)")
        for f, n in attn[name].items():
            check(n > 0, f"{name}: no HGMMA instruction in {f}")
    n_bwd = len(ATTN_BWD_HEAD_DIMS) * len(ATTN_BWD_KERNELS)
    check(len(bwd) == n_bwd,
          f"{ATTN_BWD_LIB}: {len(bwd)} attention backward functions, expected {n_bwd} "
          f"({', '.join(ATTN_BWD_KERNELS)} at d {', '.join(map(str, ATTN_BWD_HEAD_DIMS))})")
    for f, n in bwd.items():
        check(n > 0, f"{ATTN_BWD_LIB}: no HGMMA instruction in {f}")
    check(len(s8) == S8_FUNCTIONS, f"{S8_LIB}: {len(s8)} {S8_KERNEL} functions, expected {S8_FUNCTIONS}")
    for f, n in s8.items():
        check(n > 0, f"{S8_LIB}: no IGMMA instruction in {f}")


# -- 3. the GEMM alone, then kernel parity -----------------------------------


def phase_gemm(torch):
    """``gemm_bf16`` (the wgmma GEMM under K1, K2 and K9) at GEMM_SHAPES
    against ``gemm_bf16_plain`` (``torch.matmul`` in fp32, rounded once)
    within GEMM_TOL_STEPS bf16 steps, and timed against ``torch.matmul`` in
    bf16 by CUDA events."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    out = {}
    for tag, (M, N, K) in GEMM_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(14)
        a = unit_activations(torch, (M, K), gen, dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        b = (torch.randn((N,), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        before = bf.gemm_bf16.launches
        got = bf.gemm_bf16(a, w, b)
        torch.cuda.synchronize()
        check(bf.gemm_bf16.launches == before + 1, f"gemm_bf16 {tag}: the kernel did not launch")
        ref = bf.gemm_bf16_plain(a, w, b).float()
        err = (got.float() - ref).abs().max().item()
        band = GEMM_TOL_STEPS * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        finite = bool(torch.isfinite(got.float()).all().item())
        ms = min(cuda_ms(torch, lambda: bf.gemm_bf16(a, w, b)) for _ in range(2))
        lib_ms = min(cuda_ms(torch, lambda: torch.matmul(a, w)) for _ in range(2))
        flops = 2 * M * N * K
        bound = max(flops / H100_BF16_FLOPS, 2 * (M * K + K * N + N + M * N) / H100_BYTES_PER_S) * 1e3
        log(f"gemm_bf16 {tag} {M} x {N} x {K}: max_abs_err={err:.3e} (band {band:.3e}), kernel {ms:.4f} ms "
            f"{flops / ms / 1e9:.1f} TFLOP/s, torch.matmul {lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} TFLOP/s, "
            f"bound {bound:.4f} ms")
        check(finite and got.shape == (M, N), f"gemm_bf16 {tag}: {tuple(got.shape)}, finite {finite}")
        check(err <= band, f"gemm_bf16 {tag}: max abs err {err} > {band}")
        out[tag] = {"ms": ms, "library_ms": lib_ms, "tflops": flops / ms / 1e9, "flops": flops}
        del a, w, b, got, ref
    for tag, (M, N, K, a_t, w_t, out_name, has_bias) in BWD_GEMM_SHAPES.items():
        out[tag] = gemm_layout_case(torch, tag, M, N, K, a_t, w_t, getattr(torch, out_name), has_bias)
    return out


def gemm_layout_case(torch, tag, M, N, K, a_t, w_t, out_dtype, has_bias):
    """``gemm_bf16`` in one of K5's layouts against ``gemm_bf16_plain`` (the
    fp32 product of the same bf16 inputs), and timed against
    ``torch.matmul`` on the transposed views (bf16 out) by CUDA events."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    a = unit_activations(torch, (K, M) if a_t else (M, K), gen, dev).to(torch.bfloat16)
    w = (torch.randn((N, K) if w_t else (K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    b = (torch.randn((N,), generator=gen, device=dev) * 0.02).to(torch.bfloat16) if has_bias else None
    kw = dict(a_t=a_t, w_t=w_t, out_dtype=out_dtype)
    before = bf.gemm_bf16.launches
    got = bf.gemm_bf16(a, w, b, **kw)
    torch.cuda.synchronize()
    check(bf.gemm_bf16.launches == before + 1, f"gemm_bf16 {tag}: the kernel did not launch")
    ref = bf.gemm_bf16_plain(a, w, b, **kw).float()
    peak = ref.abs().max().item()
    err = (got.float() - ref).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all().item())
    check(finite and got.shape == (M, N) and got.dtype == out_dtype,
          f"gemm_bf16 {tag}: {got.dtype} {tuple(got.shape)}, finite {finite}")
    step = 2.0 ** (math.floor(math.log2(peak)) - 7)  # one bf16 step at the largest magnitude
    if out_dtype == torch.bfloat16:
        band = GEMM_TOL_STEPS * step
        verdict = f"max_abs_err={err:.3e} (band {band:.3e})"
        ok = err <= band
    else:
        rel = err / peak
        # the band must reject the output with its largest entry one bf16 step off
        moved = got.float().reshape(-1).clone()
        moved[int(ref.reshape(-1).abs().argmax().item())] += step
        moved_rel = (moved - ref.reshape(-1)).abs().max().item() / peak
        check(moved_rel > BWD_GEMM_F32_REL, f"gemm_bf16 {tag}: a one-step perturbation ({moved_rel}) passes")
        verdict = f"rel_err={rel:.3e} (band {BWD_GEMM_F32_REL:.1e}; one bf16 step off {moved_rel:.3e})"
        ok = rel <= BWD_GEMM_F32_REL
        del moved
    at, wt = (a.t() if a_t else a), (w.t() if w_t else w)
    ms = min(cuda_ms(torch, lambda: bf.gemm_bf16(a, w, b, **kw)) for _ in range(2))
    lib_ms = min(cuda_ms(torch, lambda: torch.matmul(at, wt)) for _ in range(2))
    flops = 2 * M * N * K
    tiles = -(-M // bf.GEMM_TILE_M) * (N // bf.gemm_tile_n(N))
    splits = -(-K // bf.gemm_k_slice(M, N, K, a_t, w_t)) if out_dtype == torch.float32 else 1
    nbytes = 2 * (M * K + K * N) + out_dtype.itemsize * M * N
    bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    log(f"gemm_bf16 {tag} {M} x {N} x {K} a_t={int(a_t)} w_t={int(w_t)} {str(out_dtype)[6:]} "
        f"({tiles} tiles x {splits} slices): {verdict}, kernel {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s, "
        f"torch.matmul {lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} TFLOP/s, bound {bound:.4f} ms")
    check(ok, f"gemm_bf16 {tag}: outside its band ({verdict})")
    rec = {"ms": ms, "library_ms": lib_ms, "tflops": flops / ms / 1e9, "tiles": tiles, "flops": flops}
    if splits > 1:  # what the split buys: the same product in one pass over K
        one = bf.gemm_bf16(a, w, k_slice=K, **kw)
        one_rel = (one.float() - ref).abs().max().item() / peak
        check(one_rel <= BWD_GEMM_F32_REL, f"gemm_bf16 {tag} in one pass: relative err {one_rel}")
        rec["one_pass_ms"] = min(cuda_ms(torch, lambda: bf.gemm_bf16(a, w, k_slice=K, **kw)) for _ in range(2))
        log(f"gemm_bf16 {tag} in one pass over K ({tiles} tiles): rel_err={one_rel:.3e}, kernel "
            f"{rec['one_pass_ms']:.4f} ms {flops / rec['one_pass_ms'] / 1e9:.1f} TFLOP/s; the {splits} slices "
            f"{rec['one_pass_ms'] / ms:.2f}x faster")
    return rec


def phase_gemm_s8(torch):
    """``gemm_s8`` (the int8 wgmma GEMM under K3a and K3b) at the four K3
    products of GEMM_S8_SHAPES: its int32 sums against ``torch._int_mm`` (a
    yardstick the port never calls) and ``gemm_s8_plain``, exactly; the
    product's own K3 epilogue in bf16 and fp32 against the plain version,
    bit for bit (exact GELU within GEMM_S8_GELU_STEPS fp32 steps); timed
    against ``torch._int_mm`` by CUDA events (the weight's K-major copy made
    once, by its first call), and the copy alone (``evr_transpose_s8``).
    Returns the times per product."""
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops import build
    from evr_tpu_torch.ops.int8 import quantize_rows

    dev = torch.device("cuda")
    lib = build.load("block_quant")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out, worst_gelu = {}, 0.0
    for tag, (M, W, act) in GEMM_S8_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(15)
        for name, N, K, epi in (("qkv", 3 * W, W, "store"), ("out", W, W, "residual"),
                                ("fc", 4 * W, W, act), ("proj", W, 4 * W, "residual")):
            a, a_scale = quantize_rows(unit_activations(torch, (M, K), gen, dev))
            a_scale = a_scale.reshape(-1).contiguous()
            w = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
            w_scale = torch.rand((N,), generator=gen, device=dev) * (0.02 / K ** 0.5)
            bias = torch.randn((N,), generator=gen, device=dev) * 0.02
            what = f"gemm_s8 {tag}-{name} {M} x {N} x {K}"
            before = bf.gemm_s8.launches
            sums = bf.gemm_s8(a, a_scale, w, w_scale, bias, "int32")
            torch.cuda.synchronize()
            check(bf.gemm_s8.launches == before + 1, f"{what}: the kernel did not launch")
            w_cm = w.t().contiguous().t()  # torch._int_mm's int8 path takes B column-major
            check(torch.equal(sums, torch._int_mm(a, w_cm)), f"{what}: int32 sums differ from torch._int_mm")
            check(torch.equal(sums, bf.gemm_s8_plain(a, a_scale, w, w_scale, bias, "int32")),
                  f"{what}: int32 sums differ from the plain version")
            notes = []
            for dt in (torch.bfloat16, torch.float32):
                res = unit_activations(torch, (M, N), gen, dev).to(dt) if epi == "residual" else None
                got = bf.gemm_s8(a, a_scale, w, w_scale, bias, epi, dt, res)
                ref = bf.gemm_s8_plain(a, a_scale, w, w_scale, bias, epi, dt, res)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got.float()).all().item()), f"{what} {epi} {dt}: non-finite output")
                if epi == "gelu":
                    diff = (got - ref).abs()
                    steps = (diff / (ref.abs().clamp_min(1.0) * 2.0 ** -23)).max().item()
                    worst_gelu = max(worst_gelu, diff.max().item())
                    notes.append(f"{str(dt).split('.')[-1]} {epi} max_abs_err {diff.max().item():.3e} "
                                 f"({steps:.2f} steps, {(diff > 0).float().mean().item():.3f} of outputs)")
                    check(steps <= GEMM_S8_GELU_STEPS, f"{what} {epi} {dt}: {steps} fp32 steps off the plain version")
                else:
                    same = bool(torch.equal(got, ref))
                    notes.append(f"{str(dt).split('.')[-1]} {epi} bit-equal {same}")
                    check(same, f"{what} {epi} {dt}: differs from the plain version")
                del got, ref, res
            ms = min(cuda_ms(torch, lambda: bf.gemm_s8(a, a_scale, w, w_scale, bias, "int32")) for _ in range(2))
            lib_ms = min(cuda_ms(torch, lambda: torch._int_mm(a, w_cm)) for _ in range(2))
            w_t = torch.empty((N, K), dtype=torch.int8, device=dev)

            def copy():
                rc = lib.evr_transpose_s8(w.data_ptr(), w_t.data_ptr(), K, N, stream)
                check(rc == 0, f"{what}: evr_transpose_s8 returned {rc}")

            copy()
            torch.cuda.synchronize()
            check(torch.equal(w_t, w.t()), f"{what}: the K-major copy differs from w transposed")
            copy_ms = cuda_ms(torch, copy)
            ops = 2 * M * N * K
            bound = max(ops / H100_INT8_OPS, (M * K + K * N + 4 * M * N) / H100_BYTES_PER_S) * 1e3
            log(f"{what} ({epi}): int32 equal to torch._int_mm and the plain version; {'; '.join(notes)}; "
                f"kernel {ms:.4f} ms {ops / ms / 1e9:.1f} TOP/s (the weight's K-major copy, made once: "
                f"{copy_ms:.4f} ms), torch._int_mm {lib_ms:.4f} ms {ops / lib_ms / 1e9:.1f} TOP/s, "
                f"bound {bound:.4f} ms")
            out[(tag, name)] = {"ms": ms, "copy_ms": copy_ms, "library_ms": lib_ms, "ops": ops}
            del a, a_scale, w, w_cm, w_t, sums
        torch.cuda.empty_cache()
    log(f"gemm_s8 exact GELU against its plain version: largest difference {worst_gelu:.3e}")
    return out


def phase_parity(torch):
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block": 0.0, "fused_mlp_block": 0.0}
    for shape_name, s in (("vision", VISION), ("text", TEXT), ("ragged", RAGGED), ("vitl", VITL),
                          ("vith", VITH)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            cast = lambda args: [a.to(dt) for a in args]  # noqa: E731
            for name, kern, plain, kw, args in (
                ("fused_attn_block", bf.fused_attn_block, bf.fused_attn_block_plain,
                 dict(n_heads=s["H"], causal=s["causal"]), attn_args),
                ("fused_mlp_block", bf.fused_mlp_block, bf.fused_mlp_block_plain,
                 dict(activation=s.get("act", "quick_gelu")), mlp_args),
            ):
                got = kern(x, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, *cast(args), **kw)
                err, cos, finite = compare(torch, got, ref)
                tag = f"{name} {shape_name} {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                if dt == torch.float32:
                    check(err <= FP32_TOL, f"{tag}: max abs err {err} > {FP32_TOL}")
                else:
                    check(err <= BF16_TOL, f"{tag}: max abs err {err} > {BF16_TOL}")
                    check(cos >= BF16_MIN_COS, f"{tag}: row cosine {cos} < {BF16_MIN_COS}")
                    if shape_name == "vision":
                        worst[name] = max(worst[name], err)
        # GELU variant of K2 (OpenCLIP towers), checked at the vision width
        if shape_name == "vision":
            for dt in (torch.bfloat16, torch.float32):
                x = x32.to(dt)
                got = bf.fused_mlp_block(x, *mlp_args, activation="gelu")
                ref = bf.fused_mlp_block_plain(x, *[a.to(dt) for a in mlp_args], activation="gelu")
                err, cos, finite = compare(torch, got, ref)
                tag = f"fused_mlp_block gelu vision {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                tol = FP32_TOL if dt == torch.float32 else BF16_TOL
                check(err <= tol, f"{tag}: max abs err {err} > {tol}")
    return worst


def core_inputs(torch, s: dict, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return unit_activations(torch, (s["B"], s["T"], 3 * s["W"]), gen, "cuda")


def phase_parity_core(torch):
    """K1's attention core alone (``attn_forward``) against
    ``attn_forward_plain`` at ATTN_CORE_SHAPES, bf16 (the TMA + wgmma kernel
    of csrc/attn_sm90.cuh) and fp32 (flash.cuh's flash_fwd_kernel), one
    launch a call."""
    from evr_tpu_torch.ops import block_fused as bf

    worst = 0.0
    for tag, s in ATTN_CORE_SHAPES.items():
        qkv32 = core_inputs(torch, s, seed=10)
        for dt in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dt)
            before = bf.attn_forward.launches
            got = bf.attn_forward(qkv, s["H"], s["causal"])
            torch.cuda.synchronize()
            ref = bf.attn_forward_plain(qkv, s["H"], s["causal"])
            err, cos, finite = compare(torch, got, ref)
            name = f"attn_forward {tag} {str(dt).split('.')[-1]} (T {s['T']}, d {s['W'] // s['H']})"
            log(f"parity {name}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
            check(bf.attn_forward.launches == before + 1, f"{name}: not one launch")
            check(got.dtype == dt and got.shape == ref.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
            check(finite, f"{name}: non-finite output")
            if dt == torch.float32:
                check(err <= FP32_TOL, f"{name}: max abs err {err} > {FP32_TOL}")
            else:
                check(err <= BF16_TOL, f"{name}: max abs err {err} > {BF16_TOL}")
                check(cos >= BF16_MIN_COS, f"{name}: row cosine {cos} < {BF16_MIN_COS}")
                worst = max(worst, err)
            del got, ref
    return worst


def bwd_compare(torch, got, ref, is_dx: bool):
    """(max abs err, err relative to ref's largest entry, cosine): per row
    (the least) for dx, over the whole leaf for a parameter gradient."""
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    rel = err / max(r.abs().max().item(), 1e-30)
    if is_dx:
        cos = torch.nn.functional.cosine_similarity(
            g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1]), dim=-1).min().item()
    else:
        cos = torch.nn.functional.cosine_similarity(g.reshape(1, -1), r.reshape(1, -1)).item()
    return err, rel, cos, bool(torch.isfinite(g).all().item())


def phase_parity_bwd(torch):
    """K5a and K5b against their plain versions at ViT-L/14@336px's training
    shapes, vision and causal text, bf16 and fp32, quickGELU; exact GELU
    for K5b at the vision shape; K5a at head dim 80 (VITH_BWD). Every
    output is checked."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block_bwd": 0.0, "fused_mlp_block_bwd": 0.0}
    for shape_name, s in (("vitl", VITL), ("vitl-text", VITL_TEXT), ("vith", VITH_BWD)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        g32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev) * 0.01
        cases = [("fused_attn_block_bwd", bf.fused_attn_block_bwd, bf.fused_attn_block_bwd_plain,
                  dict(n_heads=s["H"], causal=s["causal"]), attn_args)]
        if shape_name != "vith":  # K5a alone at head dim 80
            cases.append(("fused_mlp_block_bwd", bf.fused_mlp_block_bwd, bf.fused_mlp_block_bwd_plain,
                          dict(activation="quick_gelu"), mlp_args))
        if shape_name == "vitl":
            cases.append(("fused_mlp_block_bwd", bf.fused_mlp_block_bwd, bf.fused_mlp_block_bwd_plain,
                          dict(activation="gelu"), mlp_args))
        for dt in (torch.bfloat16, torch.float32):
            x, g = x32.to(dt), g32.to(dt)
            for name, kern, plain, kw, args in cases:
                got = kern(x, g, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, g, *[a.to(dt) for a in args], **kw)
                tag = f"{name} {kw.get('activation', '')} {shape_name} {str(dt).split('.')[-1]}"
                err = check_bwd_outputs(torch, tag, name, dt, got, ref)
                if shape_name == "vitl" and dt == torch.bfloat16:
                    worst[name] = max(worst[name], err)
                del got, ref
    return worst


def check_bwd_outputs(torch, tag, name, dt, got, ref) -> float:
    """Every output of a K5a/K5b call against its plain version within the
    BWD_* bands; returns the largest absolute error."""
    worst = 0.0
    for out_name, u, v in zip(BWD_OUTPUTS[name], got, ref):
        is_dx = out_name == "dx"
        err, rel, cos, finite = bwd_compare(torch, u, v, is_dx)
        log(f"parity {tag} {out_name}: max_abs_err={err:.3e} rel={rel:.3e} "
            f"{'min_row_cos' if is_dx else 'leaf_cos'}={cos:.7f}")
        check(finite, f"{tag} {out_name}: non-finite output")
        check(u.dtype == (dt if is_dx else torch.float32), f"{tag} {out_name}: dtype {u.dtype}")
        if dt == torch.float32:
            check(rel <= BWD_FP32_REL, f"{tag} {out_name}: relative err {rel} > {BWD_FP32_REL}")
        else:
            tol = BWD_BF16_DX_REL if is_dx else BWD_BF16_GRAD_REL
            check(rel <= tol, f"{tag} {out_name}: relative err {rel} > {tol}")
            check(cos >= BWD_MIN_COS, f"{tag} {out_name}: cosine {cos} < {BWD_MIN_COS}")
        worst = max(worst, err)
    return worst


def phase_parity_tiny_bwd(torch):
    """K5a and K5b at ViT-Tiny-Test's geometry (TINY_BWD_SHAPES: W 64, head
    dim 16; quickGELU, and exact GELU at T 17) against their plain
    versions, bf16 and fp32, every output within the BWD_* bands, a second
    call bit-equal to the first, one launch a call; then K5a's attention
    backward alone at d 16 (TINY_ATTN_BWD_SHAPES) as
    ``phase_parity_attn_bwd`` holds it. Returns the largest bf16 error."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = 0.0
    for shape_name, s in TINY_BWD_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(17)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        g32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev) * 0.01
        cases = [("fused_attn_block_bwd", bf.fused_attn_block_bwd, bf.fused_attn_block_bwd_plain,
                  dict(n_heads=s["H"], causal=s["causal"]), attn_args),
                 ("fused_mlp_block_bwd", bf.fused_mlp_block_bwd, bf.fused_mlp_block_bwd_plain,
                  dict(activation="quick_gelu"), mlp_args)]
        if shape_name == "tiny":
            cases.append(("fused_mlp_block_bwd", bf.fused_mlp_block_bwd, bf.fused_mlp_block_bwd_plain,
                          dict(activation="gelu"), mlp_args))
        for dt in (torch.bfloat16, torch.float32):
            x, g = x32.to(dt), g32.to(dt)
            for name, kern, plain, kw, args in cases:
                counter = getattr(bf, name)
                before = counter.launches
                got = kern(x, g, *args, **kw)
                again = kern(x, g, *args, **kw)
                torch.cuda.synchronize()
                tag = (f"{name} {kw.get('activation', '')} {shape_name} {str(dt).split('.')[-1]} "
                       f"(B {s['B']}, T {s['T']}, W {s['W']}, d {s['W'] // s['H']})")
                check(counter.launches == before + 2, f"{tag}: not one launch a call")
                check(all(torch.equal(u, v) for u, v in zip(got, again)), f"{tag}: a second call gave other bits")
                del again
                ref = plain(x, g, *[a.to(dt) for a in args], **kw)
                err = check_bwd_outputs(torch, tag, name, dt, got, ref)
                if dt == torch.bfloat16:
                    worst = max(worst, err)
                del got, ref
    for tag, s in TINY_ATTN_BWD_SHAPES.items():
        worst = max(worst, attn_bwd_case(torch, tag, s))
    return worst


def cosine64(got, ref) -> float:
    """The cosine of two tensors taken whole, in float64: near 1 an fp32
    cosine over millions of entries scatters by about 1e-7 on its own."""
    g, r = got.double().reshape(-1), ref.double().reshape(-1)
    return (g @ r / (g.norm() * r.norm())).item()


def phase_parity_attn_bwd(torch):
    """K5a's attention backward alone (``attn_backward``, bf16: the TMA +
    wgmma kernels of csrc/attn_bwd_sm90.cuh) against ``attn_backward_plain``
    at ATTN_BWD_SHAPES: o, and each of the q, k and v column blocks of the
    fp32 dqkv (error relative to the block's largest entry, cosine in
    float64); dqkv_r is dqkv rounded; a second call gives the same bits; one
    launch a call."""
    return max(attn_bwd_case(torch, tag, s) for tag, s in ATTN_BWD_SHAPES.items())


def attn_bwd_case(torch, tag, s) -> float:
    """``attn_backward`` (bf16) at one shape against ``attn_backward_plain``
    within the ATTN_BWD_* bands, a second call bit-equal, one launch a call;
    returns the largest dq/dk/dv error."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = 0.0
    B, T, W, H, causal = s["B"], s["T"], s["W"], s["H"], s["causal"]
    gen = torch.Generator(device=dev).manual_seed(12)
    qkv = unit_activations(torch, (B, T, 3 * W), gen, dev).to(torch.bfloat16)
    dout = (unit_activations(torch, (B, T, W), gen, dev) * 0.01).to(torch.bfloat16)
    name = f"attn_backward {tag} bf16 (B {B}, T {T}, d {W // H}{', causal' if causal else ''})"
    before = bf.attn_backward.launches
    o, dqkv, dqkv_r = bf.attn_backward(qkv, dout, H, causal)
    again = bf.attn_backward(qkv, dout, H, causal)
    torch.cuda.synchronize()
    check(bf.attn_backward.launches == before + 2, f"{name}: not one launch a call")
    check(all(torch.equal(u, v) for u, v in zip((o, dqkv, dqkv_r), again)),
          f"{name}: a second call gave other bits")
    del again
    check(torch.equal(dqkv_r, dqkv.to(torch.bfloat16)), f"{name}: dqkv_r is not dqkv rounded")
    o_p, dqkv_p = bf.attn_backward_plain(qkv, dout, H, causal)
    o_err = (o.float() - o_p.float()).abs().max().item()
    check(bool(torch.isfinite(o.float()).all().item()), f"{name}: non-finite o")
    check(o_err <= ATTN_BWD_O_TOL, f"{name}: o max abs err {o_err} > {ATTN_BWD_O_TOL}")
    parts = []
    for n, part in enumerate(("dq", "dk", "dv")):
        u, v = dqkv[:, n * W:(n + 1) * W], dqkv_p[:, n * W:(n + 1) * W]
        err, rel, _, finite = bwd_compare(torch, u, v, False)
        cos = cosine64(u, v)
        parts.append(f"{part} rel={rel:.3e} cos={cos:.10f}")
        check(finite, f"{name} {part}: non-finite output")
        check(rel <= ATTN_BWD_REL, f"{name} {part}: relative err {rel} > {ATTN_BWD_REL}")
        check(cos >= ATTN_BWD_MIN_COS, f"{name} {part}: cosine {cos} < {ATTN_BWD_MIN_COS}")
        worst = max(worst, err)
    log(f"parity {name}: o max_abs_err={o_err:.3e} " + " ".join(parts) + "; repeats bit for bit")
    return worst


def quantized_block(p):
    """A block's params with its four linears quantized (``models.quant``)."""
    from evr_tpu_torch.models.quant import quantize_linear_params

    return {**p,
            "attn": {n: quantize_linear_params(v) for n, v in p["attn"].items()},
            "mlp": {n: quantize_linear_params(v) for n, v in p["mlp"].items()}}


def phase_parity_int8(torch):
    """K3a and K3b against their plain versions, bf16 and fp32, at the
    serving shapes, at T = 577 (ViT-L/14@336px's vision tower), quickGELU,
    at ViT-H-14's vision shape (head dim 80, exact GELU) and at the tiny
    tower's two (W 64, head dim 16: the int8 GEMM's narrow tile); exact GELU
    also at the ViT-B/32 vision width and the tiny ones."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block_q": 0.0, "fused_mlp_block_q": 0.0}
    for shape_name, s in (("vision", VISION), ("text", TEXT), ("vitl", VITL), ("vith", VITH), ("tiny", TINY),
                          ("tiny-text", TINY_TEXT)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn, mlp = bf.quant_block_half_params(quantized_block(block_params(torch, s["W"], gen, dev)))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        cases = [("fused_attn_block_q", bf.fused_attn_block_q, bf.fused_attn_block_q_plain,
                  dict(n_heads=s["H"], causal=s["causal"]), attn),
                 ("fused_mlp_block_q", bf.fused_mlp_block_q, bf.fused_mlp_block_q_plain,
                  dict(activation=s.get("act", "quick_gelu")), mlp)]
        if shape_name in ("vision", "tiny", "tiny-text"):
            cases.append(("fused_mlp_block_q", bf.fused_mlp_block_q, bf.fused_mlp_block_q_plain,
                          dict(activation="gelu"), mlp))
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            for name, kern, plain, kw, args in cases:
                got = kern(x, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, *bf.cast_quant_args(dt, args), **kw)
                err, cos, finite = compare(torch, got, ref)
                tag = f"{name} {kw.get('activation', '')} {shape_name} {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                tol = INT8_FP32_TOL if dt == torch.float32 else BF16_TOL
                check(err <= tol, f"{tag}: max abs err {err} > {tol}")
                check(cos >= INT8_MIN_COS, f"{tag}: row cosine {cos} < {INT8_MIN_COS}")
                if shape_name == "vision" and dt == torch.bfloat16:
                    worst[name] = max(worst[name], err)
    return worst


def topk_index(torch, dtype: str, tied=((5000, 5064),)):
    """(index, row scales) of TOPK_ROWS seeded unit rows with blocks of
    duplicated rows (ties; by default 64 rows at 5,000), stored as
    ``FrameIndex`` stores ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randn((TOPK_ROWS, TOPK_DIM), generator=gen, device="cuda")
    for a, b in tied:
        emb[a:b] = emb[a]
    emb = emb / emb.norm(dim=1, keepdim=True)
    if dtype == "int8":
        scales = (emb.abs().amax(1) / 127.0).clamp_min(1e-12)
        return torch.clamp(torch.round(emb / scales[:, None]), -127, 127).to(torch.int8), scales
    return emb.to(getattr(torch, dtype)), None


def topk_case(torch, tag, index, q, start, end, k, scales, control=None):
    """One K4 call against ``fused_topk_plain``: rows equal, scores equal
    bit for bit (and within TOPK_SCORE_TOL); with ``control`` (a function of
    the kernel's rows) a wrong answer built from them must fail the same row
    check. Returns (the largest score error, the kernel's rows)."""
    from evr_tpu_torch.ops.retrieval import fused_topk, fused_topk_plain

    got_s, got_r = fused_topk(index, q, start, end, k, scales)
    torch.cuda.synchronize()
    ref_s, ref_r = fused_topk_plain(index, q, start, end, k, scales)
    err = (got_s - ref_s).abs().max().item() if bool(torch.isfinite(ref_s).all()) else \
        (got_s - ref_s)[torch.isfinite(ref_s)].abs().max().item()
    same, bits = bool(torch.equal(got_r, ref_r)), bool(torch.equal(got_s, ref_s))
    tail = f", control rows equal {bool(torch.equal(control(got_r), ref_r))}" if control else ""
    log(f"parity {tag}: rows equal {same}, scores bit-equal {bits}, max_abs_err={err:.3e}{tail}")
    check(same, f"{tag}: rows differ from the plain version")
    check(bits and err <= TOPK_SCORE_TOL[str(index.dtype).split('.')[-1]], f"{tag}: score err {err}")
    if control is not None:
        check(not torch.equal(control(got_r), ref_r), f"{tag}: the row check passed a wrong answer")
    return err, got_r


def swap_first_two(rows):
    """A wrong answer: the first two rows of each query swapped."""
    bad = rows.clone()
    bad[:, [0, 1]] = bad[:, [1, 0]]
    return bad


def phase_parity_topk(torch):
    """K4 against its plain version: Q in {1, 5, 32}, k in {1, 30, 300}, a
    row range that starts past 0 and ends before the last tile, a query on
    the tied block; then, each with a negative control, k above a range of
    10 rows (the tail of -inf rows, lowest first), a new index with tied
    blocks across a tile boundary (rows 1,000..1,050) and across a block's
    boundary (8,150..8,250: 8,192 is both), and indexes of 1,000 and 1,025
    rows (under one tile, one past it)."""
    from evr_tpu_torch.ops.retrieval import topk_plan

    worst, start, end = 0.0, 17, TOPK_ROWS - 4099
    check(topk_plan(TOPK_ROWS, TOPK_DIM, 1, 30).tiles_per_block * 1024 == 8192,
          "the tied block at 8,150..8,250 no longer straddles a block's boundary")
    for dtype in ("int8", "bfloat16", "float32"):
        index, scales = topk_index(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(4)
        for nq in (1, 5, 32):
            q = torch.randn((nq, TOPK_DIM), generator=gen, device="cuda")
            q[0] = index[5000].float()
            for k in (1, 30, 300):
                err, got_r = topk_case(torch, f"fused_topk {dtype} Q={nq} k={k}", index, q, start, end, k, scales)
                worst = max(worst, err)
                tied = got_r[0][(got_r[0] >= 5000) & (got_r[0] < 5064)]
                check(bool(torch.equal(tied, tied.sort().values)), f"{dtype} Q={nq} k={k}: ties not lowest row first")
        # k above the range: ten rows, then the lowest rows at -inf; the
        # control repeats the first row in that tail
        q = torch.randn((5, TOPK_DIM), generator=gen, device="cuda")

        def repeat_tail(rows):
            bad = rows.clone()
            bad[:, 10:] = 0
            return bad

        worst = max(worst, topk_case(torch, f"fused_topk {dtype} Q=5 k=30 over rows [600000, 600010)", index, q,
                                     600000, 600010, 30, scales, repeat_tail)[0])
        for n in (1000, 1025):  # a ragged single tile, one row past a tile
            for k in (1, 30, 300):
                worst = max(worst, topk_case(
                    torch, f"fused_topk {dtype} N={n} Q=5 k={k} over rows [3, {n - 2})",
                    index[:n], q, 3, n - 2, k, None if scales is None else scales[:n].contiguous(),
                    swap_first_two if k > 1 else (lambda r: r + 1))[0])
        del index, scales
        # tied blocks across the tile boundary 1,024 and the block boundary 8,192
        index, scales = topk_index(torch, dtype, tied=((1000, 1051), (8150, 8251)))
        q = torch.randn((2, TOPK_DIM), generator=gen, device="cuda")
        q[0], q[1] = index[1000].float(), index[8150].float()
        for k, n_tied in ((30, 30), (300, 51)):
            tag = f"fused_topk {dtype} tied rows across 1,024 and 8,192, k={k}"

            def swap_tied(rows):
                bad = rows.clone()
                bad[:, [2, 3]] = bad[:, [3, 2]]
                return bad

            err, got_r = topk_case(torch, tag, index, q, 0, TOPK_ROWS, k, scales, swap_tied)
            worst = max(worst, err)
            check(bool(torch.equal(got_r[0, :n_tied].cpu(), torch.arange(1000, 1000 + n_tied)))
                  and bool(torch.equal(got_r[1, :min(k, 101)].cpu(), torch.arange(8150, 8150 + min(k, 101)))),
                  f"{tag}: the tied rows are not first, lowest first")
        del index, scales
    return worst



def flash_route(s: dict) -> str:
    from evr_tpu_torch.ops.attention import whole_sequence_route

    full = whole_sequence_route(s["T"], s["causal"], s["block_q"])
    return "flash_attention_full" if full else "flash_attention_blocked"


def flash_inputs(torch, s: dict, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (s["B"], s["H"], s["T"], s["d"])
    return [unit_activations(torch, shape, gen, "cuda") for _ in range(3)]


def phase_parity_flash(torch):
    """K6 (``flash_attention``) against its plain version at FLASH_SHAPES,
    bf16 and fp32, each through the route the JAX rule picks (one launch of
    that route's kernel per call)."""
    from evr_tpu_torch.ops import attention as fa

    worst = {"flash_attention_full": 0.0, "flash_attention_blocked": 0.0}
    for tag, s in FLASH_SHAPES.items():
        route = flash_route(s)
        q32, k32, v32 = flash_inputs(torch, s, seed=8)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            before = getattr(fa, route).launches
            got = fa.flash_attention(q, k, v, causal=s["causal"], block_q=s["block_q"])
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, s["causal"])
            err, cos, finite = compare(torch, got, ref)
            name = f"{route} {tag} {str(dt).split('.')[-1]}"
            log(f"parity {name}: max_abs_err={err:.3e} min_row_cos={cos:.7f} "
                f"(max |o| {ref.float().abs().max().item():.3f})")
            check(getattr(fa, route).launches == before + 1, f"{name}: not one launch of {route}")
            check(got.dtype == dt and got.shape == q.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
            check(finite, f"{name}: non-finite output")
            if dt == torch.float32:
                check(err <= FP32_TOL, f"{name}: max abs err {err} > {FP32_TOL}")
            else:
                check(err <= BF16_TOL, f"{name}: max abs err {err} > {BF16_TOL}")
                check(cos >= BF16_MIN_COS, f"{name}: row cosine {cos} < {BF16_MIN_COS}")
                worst[route] = max(worst[route], err)
            del got, ref
    return worst


# -- 4. main path ------------------------------------------------------------


def synthetic_frames(torch, n: int, size: int, patch: int):
    """Frames as uint8 [n, size, size, 3], each its own scene: a random
    colour per patch, a horizontal gradient and seeded pixel noise."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = size // patch
    layout = torch.randint(0, 256, (n, g, g, 3), generator=gen, device="cuda").float()
    layout = layout.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    ramp = torch.linspace(-30, 30, size, device="cuda")
    noise = torch.randn((n, size, size, 3), generator=gen, device="cuda") * 1.5
    frames = layout + ramp[None, :, None, None] + noise
    return frames.clamp(0, 255).to(torch.uint8).cpu().numpy()


def rank_check(got, ref, got_q, ref_q, noise: float, k: int = 10):
    """Hold the kernel path's top-k to the plain path's, query by query.

    ``got``/``ref`` are the two paths' unit frame embeddings, ``got_q``/
    ``ref_q`` their query vectors. A frame in one top-k and not the other is
    a violation unless the plain path scores it within ``noise`` of its own
    k-th score. Returns (violations, overlaps, frames within the noise
    band of the cut, largest score difference between the paths)."""
    import numpy as np

    violations, overlaps, band, diff = 0, [], [], 0.0
    for gq, rq in zip(got_q, ref_q):
        s_got, s_ref = got @ gq, ref @ rq
        top_got = set(np.argsort(-s_got, kind="stable")[:k].tolist())
        top_ref_order = np.argsort(-s_ref, kind="stable")[:k]
        top_ref = set(top_ref_order.tolist())
        cut = s_ref[top_ref_order[-1]]
        violations += int(sum(abs(s_ref[j] - cut) > noise for j in top_got ^ top_ref))
        overlaps.append(len(top_got & top_ref))
        band.append(int((np.abs(s_ref - cut) <= noise).sum()))
        diff = max(diff, float(np.abs(s_got - s_ref).max()))
    return violations, overlaps, band, diff


def write_video(path: pathlib.Path, n_frames: int) -> None:
    """A small real video file: boot keeps only videos whose file exists."""
    import cv2
    import numpy as np

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    for i in range(n_frames):
        writer.write(np.full((64, 64, 3), i % 256, np.uint8))
    writer.release()


def write_data_root(root: pathlib.Path, names, embeddings_per_video, frames_per_video):
    """The JAX package's data-root layout: per video an .npy of embeddings,
    metadata JSON, the frames as JPEGs (the int8 gate samples them), a
    small video file, and the registry entry."""
    import cv2
    import numpy as np

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import VideoRegistry

    cfg = DataRootConfig(root).ensure()
    registry = VideoRegistry(cfg.mapping_path)
    for name, emb, frames in zip(names, embeddings_per_video, frames_per_video):
        np.save(cfg.embedding_dir / f"{name}_embeddings.npy", emb)
        frames_dir = cfg.frames_dir / name
        frames_dir.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            cv2.imwrite(str(frames_dir / f"{i}.jpg"), np.ascontiguousarray(f[:, :, ::-1]))
        video = cfg.video_dir / f"{name}.mp4"
        write_video(video, len(emb))
        records = [
            {
                "id": f"{name}-{i}", "media_type": "image",
                "filepath": str(frames_dir / f"{i}.jpg"), "tags": [],
                "metadata": {}, "video": f"videos/{name}.mp4",
                "frameid": f"{i}.jpg", "frameidx": i,
                "text_detections": {"detections": []},
                "object_detections": {"detections": []},
            }
            for i in range(len(emb))
        ]
        meta = cfg.metadata_dir / f"{name}_metadata.json"
        meta.write_text(json.dumps(records))
        registry.add(
            name, metadata_file=meta, embeddings_file=cfg.embedding_dir / f"{name}_embeddings.npy",
            video_path=video, frames_dir=frames_dir, embedding_model="original",
        )
    return cfg


def serve_counted(torch, engine, frames, root: pathlib.Path, counted, **ctx_kwargs):
    """The main path once, through the entry points a user calls: encode the
    frames, write the data root, boot ``ServingContext`` from it and answer
    the /api/search requests: QUERIES (each an uncached one-call
    ``TextSearcher`` dispatch) and NEGATIVE_REQUESTS. Every count in
    ``counted`` (objects with a ``launches`` attribute) is set to 0 just
    before and read just after. Returns (embeddings, context, encode seconds,
    request ms of QUERIES, launches)."""
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.serving import ServingContext, create_app

    engine.encode_staged_images(frames[:BATCH])  # first call: kernel libraries load
    engine.clear_text_cache()
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    emb = engine.encode_staged_images(frames)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    check(emb.shape == (N_FRAMES, engine.cfg.embed_dim), f"embedding shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite frame embeddings")
    names = [f"video{v}" for v in range(N_VIDEOS)]
    per = N_FRAMES // N_VIDEOS
    cfg = write_data_root(root, names, [emb[v * per:(v + 1) * per] for v in range(N_VIDEOS)],
                          [frames[v * per:(v + 1) * per] for v in range(N_VIDEOS)])
    ctx = ServingContext(cfg, engine=engine, **ctx_kwargs)
    loaded = ctx.boot()
    check(loaded == names, f"boot loaded {loaded}")
    client = Client(create_app(ctx))
    check(client.get("/health").status_code == 200, "/health")
    check(client.get("/api/videos").status_code == 200, "/api/videos")
    request_ms = []
    for i, q in enumerate(QUERIES):
        body = {"query": q, "search_type": "text", "top_k": 10, "adaptive_threshold": -1.0,
                "search_method": "text_clip" if i % 2 == 0 else "text_adaptive"}
        if i == len(QUERIES) - 1:
            body["videoId"] = "video-2"
        t1 = time.perf_counter()
        resp = client.post("/api/search", json=body)
        request_ms.append((time.perf_counter() - t1) * 1e3)
        check(resp.status_code == 200, f"/api/search {q!r}: HTTP {resp.status_code}")
        events = json.loads(resp.get_data(as_text=True))["events"]
        check(len(events) > 0, f"/api/search {q!r}: no events")
        check(all(math.isfinite(e["clip_similarity"]) for e in events), "non-finite score")
        log(f"search {body['search_method']:13s} {q!r}: HTTP 200, {len(events)} events, "
            f"top {events[0]['videoId']}/{events[0]['id']} "
            f"score {events[0]['clip_similarity']:.4f}, {request_ms[-1]:.1f} ms")
    for q, neg in NEGATIVE_REQUESTS:
        body = {"query": q, "negative_query": neg, "search_type": "text", "top_k": 10,
                "search_method": "text_clip"}
        resp = client.post("/api/search", json=body)
        check(resp.status_code == 200, f"/api/search {q!r} not {neg!r}: HTTP {resp.status_code}")
        events = json.loads(resp.get_data(as_text=True))["events"]
        check(len(events) > 0 and all(math.isfinite(e["clip_similarity"]) for e in events),
              f"/api/search {q!r} not {neg!r}: {len(events)} events")
        log(f"search text_clip     {q!r} not {neg!r}: HTTP 200, {len(events)} events, top "
            f"{events[0]['videoId']}/{events[0]['id']} score {events[0]['clip_similarity']:.4f}")
    launches = {fn.__name__: fn.launches for fn in counted}
    return emb, ctx, encode_s, request_ms, launches


def served_text_launches(cfg) -> int:
    """Launches of one full-block kernel (K1, K2, K3a, K3b or K6b) by the text
    tower over serve_counted's requests: every block per uncached
    ``TextSearcher`` dispatch (one per QUERIES entry), and every block but the
    pooled last one per text that the negative requests encode
    (``EmbeddingEngine.get_text_features``)."""
    return cfg.text.layers * len(QUERIES) + (cfg.text.layers - 1) * N_NEGATIVE_TEXTS


def check_against_plain(torch, engine, frames, emb, one_noise: float, served_noise: float,
                        what: str, plain_impl: str = "plain", min_cos: float = EMBED_MIN_COS) -> dict:
    """The kernel path's embeddings and top-10 rankings against the plain
    versions' (``attn_impl=plain_impl``: "plain", or "flash_plain" for the
    flash route) on the same frames and queries: unit rows within ``min_cos``
    and rankings within the noise bands. Then the check must reject frame
    embeddings off by row cosine EMBED_MIN_COS: through the rankings, or,
    where ``min_cos`` is tighter than that (a path whose rankings are too
    flat for the bands to reject anything), through the row cosines, row by
    row. Returns the least row cosines and the largest score difference of
    each ranking case."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models.clip import encode_staged_u8, encode_text

    plain_cfg = dataclasses.replace(engine.cfg, attn_impl=plain_impl)
    with torch.inference_mode():
        ref = []
        for i in range(0, N_FRAMES, BATCH):
            staged = torch.from_numpy(frames[i:i + BATCH]).cuda()
            ref.append(encode_staged_u8(engine.params, plain_cfg, staged, dtype=engine.compute_dtype))
        ref = torch.cat(ref).float().cpu().numpy()
    got_n = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    ref_n = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    cos = (got_n * ref_n).sum(1)
    log(f"{what}: frame embeddings, kernel path vs plain path: min row cos {cos.min():.6f}")
    check(cos.min() >= min_cos, f"{what}: embedding cosine {cos.min()} < {min_cos}")
    tokens = torch.from_numpy(engine.tokenizer(list(QUERIES))).cuda()
    with torch.inference_mode():
        txt_ref = encode_text(engine.params, plain_cfg, tokens, dtype=engine.compute_dtype,
                              eot_fast_final=True).float().cpu().numpy()
    txt_ref /= np.linalg.norm(txt_ref, axis=1, keepdims=True)
    txt = engine.encode_texts(list(QUERIES))
    tcos = (txt * txt_ref).sum(1)
    log(f"{what}: text embeddings, kernel path vs plain path: min row cos {tcos.min():.6f}")
    check(tcos.min() >= min_cos, f"{what}: text embedding cosine {tcos.min()} < {min_cos}")

    # rankings: the frame paths under the plain path's text vectors and
    # under its vectors of a few frames; then the served ranking, each text
    # query through each path's own towers
    out = {"frame_cos": float(cos.min()), "text_cos": float(tcos.min())}
    picks = np.linspace(0, N_FRAMES - 1, N_FRAME_QUERIES).astype(int)
    cases = (
        ("text queries, one query vector", txt_ref, txt_ref, one_noise),
        ("frame queries, one query vector", ref_n[picks], ref_n[picks], one_noise),
        ("text queries, each path's own", txt, txt_ref, served_noise),
    )
    for kind, got_q, ref_q, noise in cases:
        bad, overlaps, band, diff = rank_check(got_n, ref_n, got_q, ref_q, noise)
        log(f"{what}: top-10 rankings, {kind}, kernel vs plain path: overlap {overlaps}, "
            f"frames within {noise} of the 10th score {band}, largest score "
            f"difference {diff:.2e}, violations {bad}")
        out[kind] = diff
        check(bad == 0, f"{what}, {kind}: {bad} top-10 swaps wider than {noise}")
    # the check must reject frame embeddings off by the row-cosine tolerance
    # (0.999): seeded noise of that size on the kernel path's frames
    noise = np.random.default_rng(0).standard_normal(got_n.shape).astype(np.float32)
    off = got_n + noise * math.sqrt((1 / EMBED_MIN_COS**2 - 1) / got_n.shape[1])
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    bad_off = sum(rank_check(off, ref_n, q, q, one_noise)[0] for q in (txt_ref, ref_n[picks]))
    off_cos = (off * ref_n).sum(1)
    log(f"{what}: the one-vector ranking checks on frame embeddings off by row cosine "
        f"{float((off * got_n).sum(1).mean()):.5f}: {bad_off} violations; their row cosines "
        f"against the plain path {float(off_cos.min()):.5f} to {float(off_cos.max()):.5f}")
    if min_cos > EMBED_MIN_COS:
        check(bad_off > 0 or bool((off_cos < min_cos).all()),
              f"{what}: neither the ranking check nor the row-cosine band {min_cos} rejects "
              "embeddings off by row cosine 0.999")
    else:
        check(bad_off > 0, f"{what}: the ranking check passes embeddings off by row cosine 0.999")
    return out


def text_query_p50_ms(engine, ctx) -> float:
    """Encode + search of a fresh query (no result cache), p50 of 20."""
    lat = []
    for i in range(20):
        t1 = time.perf_counter()
        vec = engine.encode_texts([f"query number {i} about a scene"])
        ctx.index.search(vec, 10)
        lat.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(lat)


def phase_main_path(torch, frames, then=None):
    """bf16 weights through K1 and K2, an fp32 index searched by cosine_topk;
    ``then(engine, data_root)`` runs next, over the same engine and data
    root."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import block_fused as bf

    t0 = time.perf_counter()
    engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0)
    log(f"engine: {MODEL} random weights (seed 0), {engine.compute_dtype}, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        emb, ctx, encode_s, request_ms, launches = serve_counted(
            torch, engine, frames, pathlib.Path(tmp), [bf.fused_attn_block, bf.fused_mlp_block])
        n_batches = -(-N_FRAMES // BATCH)
        n_blocks = engine.cfg.vision.layers - 1  # the last block is the pooled-row one
        expected = n_blocks * n_batches + served_text_launches(engine.cfg)
        log(f"launches over the bf16 main path: {launches} (expected {expected} each: "
            f"{n_blocks} per frame encode batch, {n_batches} batches; {engine.cfg.text.layers} per "
            f"TextSearcher dispatch, {len(QUERIES)} dispatches; {engine.cfg.text.layers - 1} per "
            f"negative-request text encode, {N_NEGATIVE_TEXTS} encodes)")
        for name, n in launches.items():
            check(n == expected > 0, f"{name}: {n} launches, expected {expected}")
        check_against_plain(torch, engine, frames, emb, ONE_VECTOR_RANK_NOISE, SERVED_RANK_NOISE,
                            "bf16")
        p50 = text_query_p50_ms(engine, ctx)
        after = then(engine, ctx.data_root.root) if then else None
    return {
        "launches": launches,
        "encode_frames_per_s": N_FRAMES / encode_s,
        "text_query_p50_ms": p50,
        "request_p50_ms": statistics.median(request_ms),
        "then": after,
    }


def phase_main_path_int8(torch, frames, then=None):
    """int8 weights through K3a and K3b, an int8 index under
    ``search_impl="pallas"``: /api/search's plain text queries through the
    one-call ``TextSearcher`` (``cosine_topk``, as in the JAX package), its
    negative queries through ``FrameIndex.search`` and K4; ``then(engine,
    data_root)`` runs next over the same engine and data root; then the boot
    gate (``--params-dtype auto``) over that data root."""
    from evr_tpu_torch.index import EmbeddingEngine, fused_search, store
    from evr_tpu_torch.models.quant_gate import auto_params_dtype
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.retrieval import fused_topk

    engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0,
                             params_dtype="int8")
    log(f"engine: {MODEL} random weights (seed 0), int8 block linears, {engine.compute_dtype}")
    # independent counts beside the kernels': index searches, and the calls
    # of the GEMM-and-sort search by the index (none: K4 serves it) and by
    # the searcher (one per uncached dispatch)
    searches, xla_search = counting(store.FrameIndex._search_raw_locked), counting(store.cosine_topk)
    searcher_topk = counting(fused_search.cosine_topk)
    store.FrameIndex._search_raw_locked, store.cosine_topk = searches, xla_search
    fused_search.cosine_topk = searcher_topk
    searcher_topk.__name__ = "searcher_cosine_topk"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            emb, ctx, encode_s, request_ms, launches = serve_counted(
                torch, engine, frames, pathlib.Path(tmp),
                [bf.fused_attn_block_q, bf.fused_mlp_block_q, fused_topk, searches, xla_search,
                 searcher_topk],
                index_dtype="int8", search_impl="pallas")
            n_batches, n_neg = -(-N_FRAMES // BATCH), len(NEGATIVE_REQUESTS)
            expected = (engine.cfg.vision.layers - 1) * n_batches + served_text_launches(engine.cfg)
            log(f"launches over the int8 main path: {launches} (expected {expected} of each K3 "
                f"half; {len(QUERIES)} TextSearcher dispatches, each one cosine_topk; "
                f"{n_neg} negative-query requests, each one index search and one fused_topk "
                f"launch; no cosine_topk in the index)")
            for name in ("fused_attn_block_q", "fused_mlp_block_q"):
                check(launches[name] == expected > 0, f"{name}: {launches[name]} launches, expected {expected}")
            check(launches["searcher_cosine_topk"] == len(QUERIES),
                  f"TextSearcher ran cosine_topk {launches['searcher_cosine_topk']} times")
            check(launches["_search_raw_locked"] == n_neg, f"{launches['_search_raw_locked']} index searches")
            check(launches["fused_topk"] == n_neg >= 2, f"fused_topk: {launches['fused_topk']} launches")
            check(launches["cosine_topk"] == 0, f"the index ran cosine_topk {launches['cosine_topk']} times")
            check(ctx.index._device_index.dtype == torch.int8, "the served index is not int8")
            check_against_plain(torch, engine, frames, emb, INT8_ONE_VECTOR_RANK_NOISE,
                                INT8_SERVED_RANK_NOISE, "int8")
            p50 = text_query_p50_ms(engine, ctx)
            root = ctx.data_root
            after = then(engine, root.root) if then else None
            del engine, ctx

            # --params-dtype auto: a float32 engine, gated over the data root
            gated = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0)
            report = auto_params_dtype(gated, root)
            log(f"int8 gate (auto_params_dtype) on random weights: {json.dumps(report.as_dict())} "
                f"-> serving {gated.params_dtype}")
            check(gated.params_dtype == ("int8" if report.passed else "bfloat16"),
                  f"gate passed={report.passed} but the engine serves {gated.params_dtype}")
            check(report.n_frames == min(256, N_FRAMES), f"the gate sampled {report.n_frames} frames")
    finally:
        store.FrameIndex._search_raw_locked = searches.__wrapped__
        store.cosine_topk = xla_search.__wrapped__
        fused_search.cosine_topk = searcher_topk.__wrapped__
    launches = {k: v for k, v in launches.items()
                if k not in ("_search_raw_locked", "cosine_topk", "searcher_cosine_topk")}
    return {
        "launches": launches,
        "encode_frames_per_s": N_FRAMES / encode_s,
        "text_query_p50_ms": p50,
        "request_p50_ms": statistics.median(request_ms),
        "gate": report.as_dict(),
        "then": after,
    }


def counting(fn):
    """``fn`` with a ``launches`` count of its calls."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)

    wrapper.launches = 0
    return wrapper


# -- 6. training -------------------------------------------------------------


def write_caption_set(root: pathlib.Path, size: int, patch: int, n_train: int = N_TRAIN, n_val: int = N_VAL):
    """A synthetic caption set in the reference trainer's layout: JPEGs of
    size² (seeded scenes, as ``synthetic_frames``) and two JSONs keyed by
    relative path with caption and category. Returns (train json, val json)."""
    import cv2
    import numpy as np
    import torch

    frames = synthetic_frames(torch, n_train + n_val, size, patch)
    cats = ["Violence", "NonViolence", "Sensitive content"]
    rng = np.random.default_rng(11)
    meta = []
    for i, f in enumerate(frames):
        cv2.imwrite(str(root / f"img{i}.jpg"), np.ascontiguousarray(f[:, :, ::-1]))
        words = rng.choice(["a", "red", "car", "crowd", "street", "dog", "boat", "sign", "night",
                            "people", "running", "park", "fight", "water"], size=6)
        meta.append((f"img{i}.jpg", {"caption": " ".join(words), "category": cats[i % 3]}))
    paths = []
    for name, part in (("train.json", meta[:n_train]), ("val.json", meta[n_train:])):
        (root / name).write_text(json.dumps(dict(part)))
        paths.append(root / name)
    return paths


def leaf_cosines(torch, grads_k, grads_p) -> dict:
    """Cosine of each gradient leaf between two steps (leaves zero in both
    are left out)."""
    out = {}
    for k in grads_k:
        a, b = grads_k[k].float().flatten(), grads_p[k].float().flatten()
        if a.norm().item() == 0.0 and b.norm().item() == 0.0:
            continue
        out[k] = torch.nn.functional.cosine_similarity(a[None], b[None]).item()
    return out


def vision_block_leaf(key: str) -> bool:
    return key.startswith("clip/visual/blocks/")


def step_compare(torch, tag, m_k, m_p, grads_k, grads_p, check_leaves):
    """A kernel step against a plain step: the loss and the gradient norm
    (relative differences), the least cosine of the leaves ``check_leaves``
    selects, and that least cosine once the kernel's gradients are
    perturbed to cosine 0.99. Prints the worst leaves of each group."""
    from evr_tpu_torch.training.finetune import global_norm

    loss_k, loss_p = m_k["total_loss"].item(), m_p["total_loss"].item()
    norm_k, norm_p = global_norm(grads_k.values()).item(), global_norm(grads_p.values()).item()
    check(math.isfinite(loss_k) and math.isfinite(norm_k), f"{tag}: non-finite kernel step")
    cos = leaf_cosines(torch, grads_k, grads_p)
    checked = {k: c for k, c in cos.items() if check_leaves(k)}
    for group, sel in (("vision blocks", vision_block_leaf),
                       ("other leaves", lambda k: not vision_block_leaf(k))):
        worst = sorted((c, k) for k, c in cos.items() if sel(k))[:3]
        log(f"{tag}: {group}: least leaf cosines {[(k, round(c, 7)) for c, k in worst]}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    off = {}
    for k in checked:
        g = grads_k[k].float()
        noise = torch.randn(g.shape, generator=gen, device=g.device)
        noise -= (noise.flatten() @ g.flatten()) / max(g.norm().item() ** 2, 1e-30) * g
        off[k] = g + noise * (g.norm() * math.tan(math.acos(0.99)) / max(noise.norm().item(), 1e-30))
    out = {"loss_rel": abs(loss_k - loss_p) / abs(loss_p), "norm_rel": abs(norm_k - norm_p) / norm_p,
           "least_leaf_cos": min(checked.values()), "leaves": len(checked),
           "perturbed_least_cos": min(leaf_cosines(torch, off, {k: grads_p[k] for k in off}).values())}
    log(f"{tag}: loss {loss_k:.6f} / {loss_p:.6f}, grad norm {norm_k:.6f} / {norm_p:.6f}: "
        f"{json.dumps(out)}")
    return out


def step_check(tag, got, bands) -> None:
    """The bands (loss rel, grad norm rel, least leaf cosine); the leaf
    band must reject the gradients perturbed to cosine 0.99."""
    check(got["loss_rel"] <= bands[0], f"{tag}: losses apart by {got['loss_rel']} > {bands[0]}")
    check(got["norm_rel"] <= bands[1], f"{tag}: gradient norms apart by {got['norm_rel']} > {bands[1]}")
    check(got["least_leaf_cos"] >= bands[2], f"{tag}: leaf cosine {got['least_leaf_cos']} < {bands[2]}")
    check(got["perturbed_least_cos"] < bands[2],
          f"{tag}: the leaf check passes gradients perturbed to cosine 0.99")


def record_first_step(finetune_module):
    """Wrap ``make_train_step`` in ``training.finetune`` (the Trainer builds
    its step with it) so the first step records its batch, its generator's
    state, its state object (the Trainer's, updated in place by every later
    step) and its total loss. Returns (the record, a function that
    restores the module)."""
    record, make = {}, finetune_module.make_train_step

    def recording(*args, **kwargs):
        step, eval_step = make(*args, **kwargs)

        def first_step(state, batch, generator=None):
            if "loss" in record:
                return step(state, batch, generator)
            record.update(batch=batch, state=state, generator=generator.get_state())
            state, metrics = step(state, batch, generator)
            record["loss"] = metrics["total_loss"].item()
            return state, metrics

        return first_step, eval_step

    finetune_module.make_train_step = recording
    return record, lambda: setattr(finetune_module, "make_train_step", make)


def phase_train(torch):
    """The training path through ``tools.finetune.main`` (counted), started
    from ``--init-checkpoint``: a reference file of the seeded params, whose
    first step's loss must equal the loss of the same params, batch and
    dropout draw in memory; with an EMA (``--ema-decay``). The checkpoint
    against the initial weights, the kernel step against the plain step, the
    time of a step; then ``best_model.pt`` served (``serve_trained``)."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models import get_model_config, init_clip_params, params_from_numpy
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.models.torch_export import save_reference_checkpoint
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.tools import finetune as cli
    from evr_tpu_torch.training import (
        CaptionDataset, TrainConfig, TrainState, make_grad_fn, make_optimizer, make_train_step,
        param_group_labels,
    )
    from evr_tpu_torch.training import finetune as tf
    from evr_tpu_torch.training.finetune import flat_leaves

    cfg = get_model_config(TRAIN_MODEL)
    seed = 0
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train_json, val_json = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size)
        t0 = time.perf_counter()
        save_reference_checkpoint(root / "init.pt", init_clip_params(seed, cfg))
        log(f"--init-checkpoint: {TRAIN_MODEL} seeded params written as a reference file "
            f"({(root / 'init.pt').stat().st_size / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
        plain_attn, plain_mlp = counting(bf.fused_attn_block_bwd_plain), counting(bf.fused_mlp_block_bwd_plain)
        bf.fused_attn_block_bwd_plain, bf.fused_mlp_block_bwd_plain = plain_attn, plain_mlp
        counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd,
                   bf.fused_mlp_block_bwd, plain_attn, plain_mlp]
        first, restore = record_first_step(tf)
        try:
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            result = cli.main([
                "--train-json", str(train_json), "--val-json", str(val_json), "--data-dir", str(root),
                "--model", TRAIN_MODEL, "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
                "--seed", str(seed), "--save-dir", str(root / "ckpt"), "--device", "cuda",
                "--init-checkpoint", str(root / "init.pt"), "--ema-decay", str(TRAIN_EMA_DECAY),
            ])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
        finally:
            bf.fused_attn_block_bwd_plain = plain_attn.__wrapped__
            bf.fused_mlp_block_bwd_plain = plain_mlp.__wrapped__
            restore()
        blocks = cfg.vision.layers
        steps, val_batches = N_TRAIN // TRAIN_BATCH, N_VAL // TRAIN_BATCH
        log(f"training launches: {launches} (expected K1 = K2 = {blocks} x {steps + val_batches}, "
            f"K5a = K5b = {blocks} x {steps}, plain backward 0); fit {fit_s:.1f} s")
        check(launches["fused_attn_block"] == launches["fused_mlp_block"] == blocks * (steps + val_batches),
              f"K1/K2 launches {launches}")
        check(launches["fused_attn_block_bwd"] == launches["fused_mlp_block_bwd"] == blocks * steps,
              f"K5 launches {launches}")
        check(launches["fused_attn_block_bwd_plain"] == launches["fused_mlp_block_bwd_plain"] == 0,
              f"plain backward ran: {launches}")
        row = result["history"][0]
        log(f"training epoch: {json.dumps({k: v for k, v in row.items()})}")
        check(row["train_batches"] == steps and row["val_batches"] == val_batches, f"batches {row}")
        for key in ("train_total_loss", "train_grad_norm", "val_total_loss", "train_contrastive_loss"):
            check(math.isfinite(row[key]), f"{key} = {row[key]}")
        saves = dict(result["checkpoint_seconds"])
        ckpt = root / "ckpt" / "final_checkpoint.pt"
        log(f"checkpoint saves: {json.dumps(saves)} s, final {ckpt.stat().st_size / 1e9:.2f} GB")

        # frozen leaves bit-unchanged, trainable ones moved
        init = {"clip": init_clip_params(seed, cfg),
                "classifier": init_classifier_params(seed + 1, ClassifierConfig(embed_dim=cfg.embed_dim))}
        final = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
        labels = flat_leaves(param_group_labels(final, 8))
        want, got = flat_leaves(init), flat_leaves(final)
        frozen = [k for k in labels if labels[k] == "frozen"]
        stale = [k for k in labels if labels[k] != "frozen" and torch.equal(got[k], torch.from_numpy(np.asarray(want[k])))]
        moved = [k for k in frozen if not torch.equal(got[k], torch.from_numpy(np.asarray(want[k])))]
        log(f"final checkpoint: {len(frozen)} frozen leaves, {len(moved)} of them moved; "
            f"{len(labels) - len(frozen)} trainable leaves, {len(stale)} of them unmoved")
        check(len(frozen) == 16 and not moved, f"frozen leaves moved: {moved}")
        check(not stale, f"trainable leaves did not move: {stale[:5]}")
        del final, got

        # the first step from --init-checkpoint against the same params in memory
        params = params_from_numpy(init, "cuda")
        cls_cfg = ClassifierConfig(embed_dim=cfg.embed_dim)
        generator = torch.Generator(device="cuda")
        generator.set_state(first["generator"])
        grad_fn = make_grad_fn(cfg, cls_cfg, TrainConfig(seed=seed, batch_size=TRAIN_BATCH, epochs=1,
                                                         ema_decay=TRAIN_EMA_DECAY))
        in_memory_loss = grad_fn(params, first["batch"], generator)[0]["total_loss"].item()
        log(f"first step's loss from --init-checkpoint {first['loss']!r}, from the same params, batch and "
            f"dropout draw in memory {in_memory_loss!r}")
        check(first["loss"] == in_memory_loss, "the first step from the file differs from the params in memory")
        served = serve_trained(torch, cfg, root / "ckpt" / "best_model.pt", first.pop("state"))
        first.clear()

        # one step from the same params and batch: kernels against plain
        batch = next(iter(CaptionDataset(train_json, root).batches(TRAIN_BATCH, cfg.vision.image_size, seed=seed)))
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain_grad")
    compared = {}
    for dtype in ("float32", "bfloat16"):
        tc = TrainConfig(seed=seed, batch_size=TRAIN_BATCH, epochs=1, compute_dtype=dtype)
        fn_k, fn_p = make_grad_fn(cfg, cls_cfg, tc), make_grad_fn(plain_cfg, cls_cfg, tc)
        m_k, grads_k = fn_k(params, batch, torch.Generator(device="cuda").manual_seed(1))
        m_p, grads_p = fn_p(params, batch, torch.Generator(device="cuda").manual_seed(1))
        # fp32: every leaf; bf16: the vision blocks' leaves, which the kernels
        # compute (a leaf elsewhere whose gradient is a near-cancelling sum
        # over the batch, such as the classifier's, moves with bf16 noise)
        compared[dtype] = step_compare(
            torch, f"kernel step vs plain step, {dtype}", m_k, m_p, grads_k, grads_p,
            (lambda k: True) if dtype == "float32" else vision_block_leaf)
        del grads_k, grads_p
    for dtype, bands in (("float32", STEP_FP32_BANDS), ("bfloat16", STEP_BF16_BANDS)):
        step_check(f"kernel step vs plain step, {dtype}", compared[dtype], bands)

    # the time of a step (bf16): forward, backward and the optimizer
    opt = make_optimizer(tc, params, N_TRAIN // TRAIN_BATCH)
    step, _ = make_train_step(cfg, cls_cfg, tc, opt)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    step(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    log(f"train step ({TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16): {[round(t, 4) for t in times]} s, "
        f"median {step_s:.4f} s = {TRAIN_BATCH / step_s:.2f} samples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {"launches": launches, "step_s": step_s, "samples_per_s": TRAIN_BATCH / step_s,
            "checkpoint_s": saves, "compared": compared, "served": served,
            "first_step_loss": in_memory_loss}


def serve_trained(torch, cfg, best: pathlib.Path, state) -> dict:
    """The fine-tuned model served: ``EmbeddingEngine.from_checkpoint(best,
    TRAIN_MODEL)`` with ``prefer_ema`` (the run kept an EMA), TRAIN_SERVE_FRAMES
    frames of 336^2 encoded in one batch through K1/K2 at T 577 and six
    queries searched by ``TextSearcher``, each kernel's launches exact
    (vision.layers - 1 per batch, text.layers per dispatch); the embeddings
    bit-equal to an engine built from the Trainer's in-memory EMA
    (``state``); the load seconds and the classes of the batch."""
    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine, FrameIndex
    from evr_tpu_torch.index.fused_search import TextSearcher
    from evr_tpu_torch.models.torch_import import read_torch_file
    from evr_tpu_torch.ops import block_fused as bf

    payload = read_torch_file(best)
    check(payload.get("ema") is not None, f"{best.name} holds no EMA")
    del payload
    t0 = time.perf_counter()
    engine = EmbeddingEngine.from_checkpoint(best, TRAIN_MODEL, prefer_ema=True, device="cuda",
                                             batch_size=TRAIN_SERVE_FRAMES)
    total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.load_finetuned(best, "reload", prefer_ema=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del engine.models["reload"]
    check(engine.active_model == "finetuned", f"from_checkpoint left {engine.active_model!r} active")
    frames = synthetic_frames(torch, TRAIN_SERVE_FRAMES, cfg.vision.image_size, cfg.vision.patch_size)
    counted = [bf.fused_attn_block, bf.fused_mlp_block]
    for fn in counted:
        fn.launches = 0
    emb = engine.encode_staged_images(frames)
    index = FrameIndex(embed_dim=cfg.embed_dim, device="cuda")
    index.add_video("trained", emb)
    searcher = TextSearcher(engine, index)
    results = [searcher.search(q, SEARCH_K) for q in QUERIES]
    launches = {fn.__name__: fn.launches for fn in counted}
    expected = cfg.vision.layers - 1 + cfg.text.layers * len(QUERIES)
    in_memory = EmbeddingEngine(TRAIN_MODEL, params=state.ema_params["clip"], device="cuda",
                                batch_size=TRAIN_SERVE_FRAMES)
    ref = in_memory.encode_staged_images(frames)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    classes = np.bincount(engine.classify(unit).argmax(1), minlength=3).tolist()
    log(f"serving {best.name} ({best.stat().st_size / 1e9:.2f} GB, EMA): from_checkpoint {total_s:.2f} s "
        f"(with the random 'original' it also draws), the file's EMA to the card {load_s:.2f} s; "
        f"{TRAIN_SERVE_FRAMES} frames of {cfg.vision.image_size}^2 bit-equal to the Trainer's in-memory EMA: "
        f"{np.array_equal(emb, ref)}; launches {launches} (expected {expected} each: "
        f"{cfg.vision.layers - 1} per encode batch at T {cfg.vision.seq_len}, {cfg.text.layers} per "
        f"TextSearcher dispatch, {len(QUERIES)} dispatches); classes of the batch {classes}; top-1 of "
        f"{QUERIES[0]!r}: row {int(results[0][1][0, 0])}, score {float(results[0][0][0, 0]):.4f}")
    check(np.array_equal(emb, ref), "best_model.pt: embeddings differ from the Trainer's in-memory EMA's")
    check(all(n == expected for n in launches.values()), f"serving best_model.pt: launches {launches}")
    check(all(np.isfinite(s).all() and r.shape == (1, min(SEARCH_K, TRAIN_SERVE_FRAMES)) for s, r in results),
          "serving best_model.pt: TextSearcher results")
    del engine, in_memory
    torch.cuda.empty_cache()
    return {"from_checkpoint_s": total_s, "load_s": load_s, "classes": classes}


# -- 7. times ----------------------------------------------------------------


def half_bound_ms(name: str, s: dict, elt: int) -> tuple[float, float, str]:
    """(operations time, bytes time, description) of one call at the card's
    peaks: each input read once, each output written once. The int8 halves
    count their GEMMs at the int8 rate and the attention at the bf16 rate."""
    rows, W = s["B"] * s["T"], s["W"]
    attn_flops = 4 * s["B"] * s["T"] * s["T"] * W
    if name.endswith("_bwd"):  # the backward halves: x and g in, dx and fp32 grads out
        if name == "fused_attn_block_bwd":  # QKV recompute, do, dW_out, dW_qkv, dy; 6 T^2 products
            gemm, attn, n_par = 22 * rows * W * W, 3 * attn_flops, 4 * W * W + 6 * W
        else:  # fc recompute, dW_proj, dh, dW_fc, dy
            gemm, attn, n_par = 40 * rows * W * W, 0, 8 * W * W + 7 * W
        nbytes = 3 * rows * W * elt + n_par * elt + n_par * 4
        desc = f"{gemm / 1e9:.2f} GFLOP GEMM, {attn / 1e9:.2f} GFLOP attention, {nbytes / 1e6:.1f} MB"
        return (gemm + attn) / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3, desc
    if name in ("fused_attn_block", "fused_attn_block_q"):
        gemm = 2 * rows * W * 3 * W + 2 * rows * W * W
        weights, vectors, attn = 4 * W * W, 4 * W, attn_flops
    else:
        gemm = 2 * 2 * rows * W * 4 * W
        weights, vectors, attn = 8 * W * W, 5 * W, 0
    if name.endswith("_q"):  # int8 kernels; fp32 scales and biases
        t_ops = gemm / H100_INT8_OPS + attn / H100_BF16_FLOPS
        nbytes = 2 * rows * W * elt + weights + 2 * vectors * 4 + 2 * W * elt
    else:
        t_ops = (gemm + attn) / H100_BF16_FLOPS
        nbytes = (2 * rows * W + weights + vectors + 2 * W) * elt
    desc = f"{gemm / 1e9:.2f} G GEMM ops, {attn / 1e9:.2f} GFLOP attention, {nbytes / 1e6:.1f} MB"
    return t_ops * 1e3, nbytes / H100_BYTES_PER_S * 1e3, desc


def time_case(torch, name, tag, kern, plain, lib, t_ops, t_bytes, desc, counted):
    """Kernel, plain version and library yardstick by CUDA events, in the
    order plain, kernel, kernel, plain so the pairs share a clock; the
    timing launches are taken back out of the main-path counts."""
    saved = [c.launches for c in counted]
    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kern, kern, plain))
    lib_ms = cuda_ms(torch, lib)
    for c, n in zip(counted, saved):
        c.launches = n
    rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"time {name} {tag}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {desc})")
    return rec


def library_act(torch, act: str):
    """The activation of a library yardstick: quickGELU, or exact GELU."""
    if act == "quick_gelu":
        return lambda h: h * torch.sigmoid(1.702 * h)
    return torch.nn.functional.gelu


def library_halves(torch, a, m, s: dict):
    """The library yardsticks of K1 and K2, which the port never calls:
    ``F.layer_norm`` + ``F.linear`` + ``F.scaled_dot_product_attention`` +
    ``F.linear``, and LN + linear + activation + linear, over the halves'
    parameters ``a`` and ``m`` in the compute dtype. Returns two functions
    of x."""
    import torch.nn.functional as F

    B, T, W, H = s["B"], s["T"], s["W"], s["H"]
    act_fn = library_act(torch, s.get("act", "quick_gelu"))
    qkv_t, out_t = a[2].t().contiguous(), a[4].t().contiguous()
    fc_t, pr_t = m[2].t().contiguous(), m[4].t().contiguous()

    def attn(x):
        y = F.layer_norm(x, (W,), a[0], a[1], 1e-5)
        q, k, v = F.linear(y, qkv_t, a[3]).view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"])
        return x + F.linear(o.transpose(1, 2).reshape(B, T, W), out_t, a[5])

    def mlp(x):
        h = F.linear(F.layer_norm(x, (W,), m[0], m[1], 1e-5), fc_t, m[3])
        return x + F.linear(act_fn(h), pr_t, m[5])

    return attn, mlp


def phase_times(torch):
    """K1, K2, K3a and K3b at the ViT-B/32 serving shapes (vision, text) and
    at ViT-H-14's vision shape (VITH_SERVE, exact GELU), bf16."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.int8 import quantize_rows

    dev = torch.device("cuda")
    counted = (bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q)
    out = {}
    for shape_name, s in (("vision", VISION), ("text", TEXT), ("vith", VITH_SERVE)):
        act = s.get("act", "quick_gelu")
        act_fn = library_act(torch, act)
        gen = torch.Generator(device=dev).manual_seed(2)
        fp = block_params(torch, s["W"], gen, dev)
        attn_args, mlp_args = bf.block_half_params(fp)
        dt = torch.bfloat16
        x = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev).to(dt)
        a = [t.to(dt) for t in attn_args]
        m = [t.to(dt) for t in mlp_args]
        B, T, W, H = s["B"], s["T"], s["W"], s["H"]
        qa, qm = bf.quant_block_half_params(quantized_block(fp))
        qa_args = bf.cast_quant_args(dt, qa)
        qm_args = bf.cast_quant_args(dt, qm)
        lib_attn_of, lib_mlp_of = library_halves(torch, a, m, s)

        # int8 yardsticks: the library's int8 GEMM (torch._int_mm, weights
        # column-major as its int8 path takes them) around the same
        # per-token quantisation and dequantisation
        def int_mm(y32, kq_cm, ks, b):
            yq, ys = quantize_rows(y32)
            return torch._int_mm(yq, kq_cm).float() * ys * ks + b

        qkv_cm, outq_cm = (qa_args[i].t().contiguous().t() for i in (2, 5))
        fc_cm, prq_cm = (qm_args[i].t().contiguous().t() for i in (2, 5))

        def lib_attn_q():
            y = F.layer_norm(x.float(), (W,), qa_args[0].float(), qa_args[1].float(), 1e-5)
            qkv = int_mm(y.view(-1, W), qkv_cm, qa_args[3], qa_args[4]).to(dt)
            q, k, v = qkv.view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"])
            o = o.transpose(1, 2).reshape(-1, W).float()
            return (x.view(-1, W).float() + int_mm(o, outq_cm, qa_args[6], qa_args[7])).to(dt)

        def lib_mlp_q():
            y = F.layer_norm(x.float(), (W,), qm_args[0].float(), qm_args[1].float(), 1e-5)
            h = int_mm(y.view(-1, W), fc_cm, qm_args[3], qm_args[4])
            o = int_mm(act_fn(h), prq_cm, qm_args[6], qm_args[7])
            return (x.view(-1, W).float() + o).to(dt)

        cases = (
            ("fused_attn_block", lambda: bf.fused_attn_block(x, *a, n_heads=H, causal=s["causal"]),
             lambda: bf.fused_attn_block_plain(x, *a, n_heads=H, causal=s["causal"]), lambda: lib_attn_of(x)),
            ("fused_mlp_block", lambda: bf.fused_mlp_block(x, *m, activation=act),
             lambda: bf.fused_mlp_block_plain(x, *m, activation=act), lambda: lib_mlp_of(x)),
            ("fused_attn_block_q",
             lambda: bf.fused_attn_block_q(x, *qa, n_heads=H, causal=s["causal"]),
             lambda: bf.fused_attn_block_q_plain(x, *qa_args, n_heads=H, causal=s["causal"]),
             lib_attn_q),
            ("fused_mlp_block_q", lambda: bf.fused_mlp_block_q(x, *qm, activation=act),
             lambda: bf.fused_mlp_block_q_plain(x, *qm_args, activation=act), lib_mlp_q),
        )
        for name, kern, plain, lib in cases:
            t_ops, t_bytes, desc = half_bound_ms(name, s, 2)
            out[(name, shape_name)] = time_case(torch, name, f"{shape_name} bf16", kern, plain, lib,
                                                t_ops, t_bytes, desc, counted)
    return out


def phase_times_train(torch, gemm):
    """K1, K2, K5a and K5b at the ViT-L/14@336px training shape (bf16). The
    yardsticks: the forward composition of ``phase_times`` for K1/K2, and
    its forward and backward under torch.autograd for K5a/K5b (the kernels
    recompute their half's forward too). Then K5a split: its attention
    backward alone (``attn_backward``, timed against its plain version, the
    backward of SDPA on views of the same qkv and its bound) and the sum of
    its five GEMMs as the GEMM phase timed them (``gemm``), the rest being
    the LN passes and the column sums."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    s = VITL
    B, T, W, H = s["B"], s["T"], s["W"], s["H"]
    gen = torch.Generator(device=dev).manual_seed(2)
    attn_args, mlp_args = bf.block_half_params(block_params(torch, W, gen, dev))
    dt = torch.bfloat16
    x = unit_activations(torch, (B, T, W), gen, dev).to(dt)
    g = (unit_activations(torch, (B, T, W), gen, dev) * 0.01).to(dt)
    a = [t.to(dt) for t in attn_args]
    m = [t.to(dt) for t in mlp_args]
    la = [a[0], a[1], a[2].t().contiguous(), a[3], a[4].t().contiguous(), a[5]]
    lm = [m[0], m[1], m[2].t().contiguous(), m[3], m[4].t().contiguous(), m[5]]

    def lib_attn(xr, p):
        y = F.layer_norm(xr, (W,), p[0], p[1], 1e-5)
        q, k, v = F.linear(y, p[2], p[3]).view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return xr + F.linear(o.transpose(1, 2).reshape(B, T, W), p[4], p[5])

    def lib_mlp(xr, p):
        h = F.linear(F.layer_norm(xr, (W,), p[0], p[1], 1e-5), p[2], p[3])
        return xr + F.linear(h * torch.sigmoid(1.702 * h), p[4], p[5])

    def fwd_bwd(fn, p):
        def run():
            leaves = [t.detach().requires_grad_() for t in (x, *p)]
            return torch.autograd.grad(fn(leaves[0], leaves[1:]), leaves, g)
        return run

    counted = (bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd)
    cases = (
        ("fused_attn_block", lambda: bf.fused_attn_block(x, *a, n_heads=H),
         lambda: bf.fused_attn_block_plain(x, *a, n_heads=H), lambda: lib_attn(x, la)),
        ("fused_mlp_block", lambda: bf.fused_mlp_block(x, *m),
         lambda: bf.fused_mlp_block_plain(x, *m), lambda: lib_mlp(x, lm)),
        ("fused_attn_block_bwd", lambda: bf.fused_attn_block_bwd(x, g, *a, n_heads=H),
         lambda: bf.fused_attn_block_bwd_plain(x, g, *a, n_heads=H), fwd_bwd(lib_attn, la)),
        ("fused_mlp_block_bwd", lambda: bf.fused_mlp_block_bwd(x, g, *m),
         lambda: bf.fused_mlp_block_bwd_plain(x, g, *m), fwd_bwd(lib_mlp, lm)),
    )
    out = {}
    for name, kern, plain, lib in cases:
        t_ops, t_bytes, desc = half_bound_ms(name, s, 2)
        out[(name, "vitl")] = time_case(torch, name, "vitl bf16", kern, plain, lib, t_ops, t_bytes,
                                        desc, counted)
    # K5a's attention backward alone, on qkv and do from the kernel's own GEMMs
    y = bf.ln_rows_plain(x, a[0], a[1]).reshape(-1, W)
    qkv = bf.gemm_bf16(y, a[2], a[3]).reshape(B, T, 3 * W)
    dout = bf.gemm_bf16(g.reshape(-1, W), a[4], w_t=True).reshape(B, T, W)
    before = bf.attn_backward.launches
    o, dqkv, dqkv_r = bf.attn_backward(qkv, dout, H)
    torch.cuda.synchronize()
    check(bf.attn_backward.launches == before + 1, "attn_backward: the kernel did not launch")
    check(bool(torch.isfinite(dqkv).all().item()), "attn_backward: non-finite dqkv")
    check(torch.equal(dqkv_r, dqkv.to(dt)), "attn_backward: round(dqkv) is not dqkv rounded")
    o_p, dqkv_p = bf.attn_backward_plain(qkv, dout, H)
    err, rel, cos, _ = bwd_compare(torch, dqkv, dqkv_p, False)
    o_err = (o.float() - o_p.float()).abs().max().item()
    del o, dqkv, dqkv_r, o_p, dqkv_p
    # its yardstick, which the port never calls: the backward of SDPA on q, k,
    # v views of the same qkv, the forward outside the timed region. Its
    # bound: 12 d operations per (query, key) pair (s, o, dpn, dv, dq, dk)
    # against qkv and do read, o, the fp32 and bf16 dqkv and the statistics
    # written once.
    d = W // H
    leaf = qkv.detach().requires_grad_()
    q, k, v = leaf.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)
    lib_out = F.scaled_dot_product_attention(q, k, v)
    g_out = dout.view(B, T, H, d).transpose(1, 2)
    flops = 12 * B * H * T * T * d
    nbytes = B * T * W * (3 * 2 + 2 + 2 + 3 * 4 + 3 * 2) + 3 * B * H * T * 4
    attn = time_case(
        torch, "attn_backward", "vitl bf16", lambda: bf.attn_backward(qkv, dout, H),
        lambda: bf.attn_backward_plain(qkv, dout, H),
        lambda: torch.autograd.grad(lib_out, leaf, g_out, retain_graph=True),
        flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3,
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB", (bf.attn_backward,))
    del leaf, q, k, v, lib_out
    attn_ms = attn["ms"]
    gemm_ms = sum(gemm[tag]["ms"] for tag in gemm if tag.startswith("vitl-K5a-"))
    k5a = out[("fused_attn_block_bwd", "vitl")]["ms"]
    out["k5a_split"] = {"ms": k5a, "attention_ms": attn_ms, "gemm_ms": gemm_ms,
                        "rest_ms": k5a - attn_ms - gemm_ms, "attention_bound_ms": attn["bound_ms"],
                        "attention_library_ms": attn["library_ms"]}
    log(f"K5a split at vitl bf16: {k5a:.4f} ms = attention backward {attn_ms:.4f} ms "
        f"({attn_ms / k5a:.1%}; bound {attn['bound_ms']:.4f} ms, SDPA's backward {attn['library_ms']:.4f} ms) "
        f"+ five GEMMs {gemm_ms:.4f} ms ({gemm_ms / k5a:.1%}; gemm_bf16 at the same "
        f"shapes and layouts) + the rest {k5a - attn_ms - gemm_ms:.4f} ms; attention backward against its "
        f"plain version: dqkv rel {rel:.3e} cos {cos:.7f}, o max abs {o_err:.3e}")
    return out


def phase_times_core(torch):
    """K1's attention core alone (``attn_forward``, bf16) at ATTN_CORE_TIMED,
    against its plain version and ``F.scaled_dot_product_attention`` on q, k,
    v views of the same qkv (which the port never calls). The bound counts
    qkv read once and o written once, and 4·d operations per (query, key)
    pair the mask keeps."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf

    out = {}
    for tag in ATTN_CORE_TIMED:
        s = ATTN_CORE_SHAPES[tag]
        B, T, W, H, causal = s["B"], s["T"], s["W"], s["H"], s["causal"]
        d = W // H
        qkv = core_inputs(torch, s, seed=11).to(torch.bfloat16)
        q, k, v = qkv.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)
        pairs = T * (T + 1) // 2 if causal else T * T
        flops, nbytes = 4 * B * H * pairs * d, 4 * B * T * W * 2
        out[tag] = time_case(
            torch, "attn_forward", f"{tag} bf16 B={B} T={T} W={W} H={H}",
            lambda: bf.attn_forward(qkv, H, causal), lambda: bf.attn_forward_plain(qkv, H, causal),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
            flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3,
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB", (bf.attn_forward,))
        del qkv, q, k, v
    return out


def topk_bound_ms(n: int, d: int, elt: int, nq: int, k: int, scaled: bool) -> tuple[float, float, str]:
    """(operations time, bytes time, description) of a K4 call: the rows (and
    their scales) and the queries read once, the top k written once; one
    product and one sum per element and query at the fp32 peak."""
    nbytes = n * d * elt + (4 * n if scaled else 0) + 4 * d * nq + nq * k * (4 + 8)
    ops = 2 * n * d * nq
    return (ops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3,
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP fp32")


def phase_times_topk(torch):
    """K4 at the serving shape of one text query: Q = 1, k = 30 over
    TOPK_ROWS int8 rows (the row scales applied), the whole call against
    its plain version and ``torch.matmul`` + ``torch.topk`` on the rows
    dequantised to bf16, beside its bound; then the call split by CUDA
    events into ``prepared_queries``, the kernel alone
    (``topk_candidates``), the scan alone (the same walk with no selection,
    ``scan_only``), the selection (the kernel less the scan) and ``_merge``;
    then bf16 and fp32 rows at Q = 1 and int8 rows at Q = 5 and 32, each
    against its library call and bound. Returns (the int8 Q = 1 record, the
    split and the other cases)."""
    from evr_tpu_torch.ops.retrieval import (_merge, fused_topk, fused_topk_plain, prepared_queries,
                                             topk_candidates)

    k, n, d = 30, TOPK_ROWS, TOPK_DIM
    index, scales = topk_index(torch, "int8")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((1, d), generator=gen, device="cuda")
    rows_bf16 = (index.float() * scales[:, None]).to(torch.bfloat16)
    q_bf16 = (q / q.norm()).to(torch.bfloat16)
    t_ops, t_bytes, desc = topk_bound_ms(n, d, 1, 1, k, True)
    rec = time_case(
        torch, "fused_topk", f"int8 {n} x {d}, Q=1, k={k}",
        lambda: fused_topk(index, q, 0, n, k, scales),
        lambda: fused_topk_plain(index, q, 0, n, k, scales),
        lambda: torch.topk(q_bf16 @ rows_bf16.T, k), t_ops, t_bytes, desc, (fused_topk,))
    saved = fused_topk.launches
    qp = prepared_queries(q, index.dtype)
    cands = topk_candidates(index, qp, 0, n, k, scales)
    parts = {
        "call": lambda: fused_topk(index, q, 0, n, k, scales),
        "prepared_queries": lambda: prepared_queries(q, index.dtype),
        "kernel": lambda: topk_candidates(index, qp, 0, n, k, scales),
        "scan": lambda: topk_candidates(index, qp, 0, n, k, scales, scan_only=True),
        "merge": lambda: _merge(*cands, k),
    }
    split = {name: min(cuda_ms(torch, fn) for _ in range(2)) for name, fn in parts.items()}
    split["selection"] = split["kernel"] - split["scan"]
    log(f"time fused_topk int8 Q=1 k={k} split: " + ", ".join(f"{p} {v:.4f} ms" for p, v in split.items())
        + f" (candidates {tuple(cands[0].shape)}; the scan's bound {t_bytes:.4f} ms)")
    del rows_bf16, cands
    cases = {}
    for dtype, nq in (("int8", 5), ("int8", 32), ("bfloat16", 1), ("float32", 1)):
        if dtype != "int8":
            del index, scales
            index, scales = topk_index(torch, dtype)
        qq = torch.randn((nq, d), generator=gen, device="cuda")
        qn = qq / qq.norm(dim=1, keepdim=True)
        if dtype == "int8":
            rows = (index.float() * scales[:, None]).to(torch.bfloat16)
            lib = lambda: torch.topk(qn.to(torch.bfloat16) @ rows.T, k)  # noqa: E731
        else:
            rows = index
            lib = lambda: torch.topk(qn.to(rows.dtype) @ rows.T, k)  # noqa: E731
        ms = min(cuda_ms(torch, lambda: fused_topk(index, qq, 0, n, k, scales)) for _ in range(2))
        lib_ms = cuda_ms(torch, lib)
        o, b, what = topk_bound_ms(n, d, index.element_size(), nq, k, scales is not None)
        cases[f"{dtype} Q={nq}"] = {"ms": ms, "library_ms": lib_ms, "bound_ms": max(o, b),
                                     "bound_by": "operations" if o >= b else "bytes"}
        log(f"time fused_topk {dtype} {n} x {d}, Q={nq}, k={k}: kernel {ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {max(o, b):.4f} ms ({'operations' if o >= b else 'bytes'}: {what})")
        del rows
    fused_topk.launches = saved
    del index, scales
    return rec, {"split": split, "cases": cases}


def phase_times_flash(torch):
    """K6 at each FLASH_SHAPES shape (bf16): the route's kernel, its plain
    version, and ``F.scaled_dot_product_attention`` (which the port never
    calls) as the library yardstick. The bound counts q, k, v and o once
    each, and 4·d operations per (query, key) pair the mask keeps."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import attention as fa

    counted = (fa.flash_attention_full, fa.flash_attention_blocked)
    out = {}
    for tag, s in FLASH_SHAPES.items():
        route = flash_route(s)
        q, k, v = (t.to(torch.bfloat16) for t in flash_inputs(torch, s, seed=9))
        B, H, T, d = s["B"], s["H"], s["T"], s["d"]
        pairs = T * (T + 1) // 2 if s["causal"] else T * T
        flops = 4 * B * H * pairs * d
        nbytes = 4 * B * H * T * d * 2
        desc = f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB"
        if route == "flash_attention_full":
            kern = lambda: fa.flash_attention_full(q, k, v)  # noqa: E731
        else:
            kern = lambda: fa.flash_attention_blocked(q, k, v, s["causal"])  # noqa: E731
        out[(route, tag)] = time_case(
            torch, route, f"{tag} bf16 B={B} H={H} T={T} d={d}", kern,
            lambda: fa.flash_attention_plain(q, k, v, s["causal"]),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"]),
            flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3, desc, counted)
    return out


# -- 8. the ANN tiers --------------------------------------------------------


def adc_case(torch, p: int, c: int, s: int, k: int, b: int, seed: int):
    """Seeded codes [p, c, s] uint8 and tables [b, s, k] fp32 on the card,
    the tables' entries at 1/sqrt(s) (a unit query's ADC table scale)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = torch.randint(0, k, (p, c, s), generator=gen, device="cuda", dtype=torch.uint8)
    tables = torch.randn((b, s, k), generator=gen, device="cuda") / math.sqrt(s)
    return blocks, tables


def adc_compare(torch, got, ref, tag: str) -> float:
    """K7's scores against its plain version's on the same inputs: bit-equal
    (the same order of sums), and within ADC_REL_TOL of the output's scale."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    same = bool(torch.equal(got, ref))
    log(f"parity adc_list_scores {tag}: bit-equal {same}, max_abs_err={err:.3e} "
        f"(output scale {scale:.3f})")
    check(bool(torch.isfinite(got).all().item()), f"adc_list_scores {tag}: non-finite scores")
    check(same, f"adc_list_scores {tag}: not bit-equal to the plain version")
    check(err <= ADC_REL_TOL * scale, f"adc_list_scores {tag}: err {err} above {ADC_REL_TOL} x {scale}")
    return err


def adc_plan_check(torch, codes, n_probed: int, k: int, tag: str):
    """The kernel's plan (``evr_adc_plan``) equal to ``ops.adc.adc_plan``'s
    mirror for these codes; returns it."""
    import ctypes

    from evr_tpu_torch.ops import build
    from evr_tpu_torch.ops.adc import adc_plan

    n_lists, c, s = codes.shape
    aligned = codes.data_ptr() % 16 == 0
    out = (ctypes.c_int * 7)()
    rc = build.load(ADC_LIB).evr_adc_plan(n_lists, c, s, k, n_probed, int(aligned), out)
    want = adc_plan(n_lists, c, s, k, n_probed, aligned)
    check(rc == 0 and tuple(out) == tuple(want), f"adc plan {tag}: C {tuple(out)} (rc {rc}), adc_plan {tuple(want)}")
    return want


def phase_parity_adc(torch) -> float:
    """K7 against its plain version, bit for bit: through ``adc_list_scores``
    on gathered blocks at the IVF-PQ probe shape of phase 8 (P = B x nprobe =
    256 lists of C = 3,072 rows, S = 64, K = 256), a ragged C with several
    probes per query, and an S that takes the direct walk; then through
    ``adc_probe_scores`` on lists in place at ADC_PROBE_CASES, each with a
    negative control (one output element moved by one step) that the
    bit-equality check must reject, and the kernel's plan equal to its
    Python mirror; last, a list id out of range must fault on the card
    (``adc_trap_check``)."""
    from evr_tpu_torch.ops.adc import (
        adc_list_scores, adc_list_scores_plain, adc_probe_scores, adc_probe_scores_plain)

    worst = 0.0
    for tag, (p, c, s, k, b) in (
        ("P=256 C=3072 S=64 K=256 B=8", (ANN_B * ANN_NPROBE, ANN_CAPACITY, 64, 256, ANN_B)),
        ("P=24 C=1000 S=64 K=256 B=3", (24, 1000, 64, 256, 3)),
        ("P=6 C=517 S=20 K=100 B=2", (6, 517, 20, 100, 2)),
    ):
        blocks, tables = adc_case(torch, p, c, s, k, b, seed=p + c)
        adc_plan_check(torch, blocks, p, k, tag)
        got = adc_list_scores(blocks, tables, p // b)
        worst = max(worst, adc_compare(torch, got, adc_list_scores_plain(blocks, tables, p // b), tag))
    for tag, (n_lists, c, s, k, ids) in ADC_PROBE_CASES.items():
        codes, tables = adc_case(torch, n_lists, c, s, k, len(ids), seed=n_lists + c + s)
        if tag.endswith("unaligned"):
            flat = torch.empty(codes.numel() + 16, dtype=torch.uint8, device="cuda")
            codes = flat[1:1 + codes.numel()].view(codes.shape).copy_(codes)
        ids = torch.tensor(ids, device="cuda")
        plan = adc_plan_check(torch, codes, ids.numel(), k, tag)
        check(plan.walk == (0 if tag.startswith("direct") else 1), f"adc {tag}: plan {plan}")
        got = adc_probe_scores(codes, ids, tables)
        ref = adc_probe_scores_plain(codes, ids, tables)
        worst = max(worst, adc_compare(torch, got, ref, f"in place, {tag}"))
        bad = got.clone().view(-1)
        i = bad.numel() // 2
        bad[i] = torch.nextafter(bad[i], bad[i] + 1)
        check(not torch.equal(bad.view(got.shape), ref), f"adc {tag}: the negative control passed the bit-equality check")
        log(f"parity adc_probe_scores {tag}: plan {tuple(plan)}; negative control rejected")
    adc_trap_check()
    return worst


def adc_trap_check() -> None:
    """``adc_probe_scores`` does not read CUDA list ids back; K7 traps on an
    id outside [0, L) instead, which loses the process's CUDA context, so
    each walk is driven with the id L in a child process of its own (both
    started together), which must fail with a CUDA error and print no
    scores."""
    here = pathlib.Path(__file__).resolve().parent
    procs = {}
    for walk, (c, s, k) in {"ring": (128, 64, 256), "direct": (100, 20, 100)}.items():
        code = ("import torch\n"
                "from evr_tpu_torch.ops.adc import adc_probe_scores\n"
                f"codes = torch.zeros((4, {c}, {s}), dtype=torch.uint8, device='cuda')\n"
                f"out = adc_probe_scores(codes, torch.tensor([[1, 4]], device='cuda'), torch.zeros((1, {s}, {k}), device='cuda'))\n"
                "print('scores', float(out.sum()))\n")
        procs[walk] = subprocess.Popen([sys.executable, "-c", code], cwd=here, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for walk, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SmokeFailure(f"adc {walk} walk: the child with an id out of range did not end in 300 s")
        last = (err.strip().splitlines() or [""])[-1]
        log(f"adc {walk} walk, list id 4 of 4 lists: child exit {proc.returncode}, {last[:200]!r}")
        check(proc.returncode != 0 and "scores" not in out and "CUDA error" in err,
              f"adc {walk} walk: an id out of range gave exit {proc.returncode}, stdout {out[-200:]!r}")


def clustered_unit_rows(torch, n: int, d: int, centres: int, seed: int):
    """[n, d] fp32 unit rows on the card: seeded centres plus per-row noise
    of ANN_NOISE per dimension, written slab by slab."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cents = torch.randn((centres, d), generator=gen, device="cuda")
    cents /= cents.norm(dim=1, keepdim=True)
    x = torch.empty((n, d), dtype=torch.float32, device="cuda")
    step = 1 << 20
    for lo in range(0, n, step):
        m = min(step, n - lo)
        pick = torch.randint(0, centres, (m,), generator=gen, device="cuda")
        rows = cents[pick] + ANN_NOISE * torch.randn((m, d), generator=gen, device="cuda")
        x[lo:lo + m] = rows / rows.norm(dim=1, keepdim=True)
    return x


def perturbed(torch, x, rows, scale: float, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = x[rows] + scale * torch.randn((len(rows), x.shape[1]), generator=gen, device="cuda")
    return (q / q.norm(dim=1, keepdim=True)).cpu().numpy()


def served_events(client, queries) -> tuple[list, list]:
    """/api/search (text_clip, top 10) for each query: the events' (video,
    id, score) lists and the request times in ms."""
    out, ms = [], []
    for q in queries:
        body = {"query": q, "search_type": "text", "search_method": "text_clip", "top_k": 10}
        t1 = time.perf_counter()
        resp = client.post("/api/search", json=body)
        ms.append((time.perf_counter() - t1) * 1e3)
        check(resp.status_code == 200, f"/api/search {q!r}: HTTP {resp.status_code}")
        events = json.loads(resp.get_data(as_text=True))["events"]
        check(len(events) > 0, f"/api/search {q!r}: no events")
        check(all(math.isfinite(e["clip_similarity"]) for e in events), "non-finite score")
        out.append([(e["videoId"], e["id"], e["clip_similarity"]) for e in events])
    return out, ms


def phase_ann_serving(torch, engine, root: pathlib.Path):
    """The bf16 phase's data root served under ``search_impl="ivf"`` (full
    probe) and ``"ivfpq"`` with the int8 host store, beside the exact path
    (two steps, as the ANN tiers search, under the same query vectors):
    IVF's served top-10 equals the exact path's (a frame may cross the cut
    only within ANN_FULL_PROBE_NOISE of the exact 10th score); IVF-PQ's top-1
    on perturbed corpus frames equals the exact path's. Returns the
    /api/search p50 of each tier."""
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.serving import ServingContext, create_app

    t0 = time.perf_counter()
    exact = ServingContext(root, engine=engine)
    exact.boot()
    # the ANN tiers take the two-step path (the engine's cached text features,
    # then FrameIndex.search); the exact reference takes it too, with the
    # one-call searcher of the exact tier set aside, so both score the same
    # query vectors
    exact.query_engine._searcher = None
    exact_events, _ = served_events(Client(create_app(exact)), QUERIES)
    emb = np.concatenate([exact.index.get_embeddings(v) for v in exact.index.videos]).astype(np.float32)
    picks = np.linspace(0, len(emb) - 1, 16).astype(int)
    noise = np.random.default_rng(5).standard_normal((len(picks), emb.shape[1])).astype(np.float32)
    frame_q = emb[picks] + ANN_FRAME_PERTURB * noise / math.sqrt(emb.shape[1])
    frame_q /= np.linalg.norm(frame_q, axis=1, keepdims=True)
    exact_top1 = exact.index.search_raw(frame_q, 1)[1][:, 0]
    n_lists = int(round(len(emb) ** 0.5))
    out = {}
    for impl, kw in (("ivf", {}), ("ivfpq", {"ivfpq_host_store": True})):
        ctx = ServingContext(root, engine=engine, search_impl=impl, ivf_clusters=n_lists,
                             ivf_nprobe=n_lists, **kw)
        check(ctx.boot() == exact.video_names(), f"{impl}: boot")
        events, ms = served_events(Client(create_app(ctx)), QUERIES)
        ann = ctx.index._ivf
        check(ann is not None and ctx.index.search_impl == impl, f"{impl}: no ANN index was built")
        top1 = ctx.index.search_raw(frame_q, 1)[1][:, 0]
        if impl == "ivf":
            bad = 0
            for got, ref in zip(events, exact_events):
                cut = ref[min(9, len(ref) - 1)][2]
                ref_score = {(v, i): sc for v, i, sc in ref}
                got_score = {(v, i): sc for v, i, sc in got}
                for key in set(ref_score) ^ set(got_score):
                    sc = ref_score.get(key, got_score.get(key))
                    bad += int(abs(sc - cut) > ANN_FULL_PROBE_NOISE)
                for key in set(ref_score) & set(got_score):
                    bad += int(abs(ref_score[key] - got_score[key]) > ANN_FULL_PROBE_NOISE)
            log(f"ann serving ivf ({ann.n_clusters} lists, nprobe {ctx.index.ivf_nprobe}, pool "
                f"{ann._overflow_size} rows): served events vs exact: {bad} differences beyond "
                f"{ANN_FULL_PROBE_NOISE}")
            check(bad == 0, f"ivf at a full probe: {bad} served events differ from the exact path's")
        agree = int((top1 == exact_top1).sum())
        # exact scores of each query's exact top-1 and of the tier's top-1
        exact_sc = frame_q @ emb.T
        gap = exact_sc[np.arange(len(picks)), exact_top1] - exact_sc[np.arange(len(picks)), top1]
        log(f"ann serving {impl}: top-1 of {len(picks)} perturbed frames equal to the exact "
            f"path's: {agree}, the others {gap[top1 != exact_top1].tolist()} below the exact top-1 "
            f"score; /api/search p50 {statistics.median(ms):.2f} ms")
        if impl == "ivfpq":
            check(ann._originals is None and ann._originals_int8 is not None,
                  "ivfpq host store: fp32 originals kept or no int8 store")
        band = ANN_INT8_NOISE if impl == "ivfpq" else ANN_FULL_PROBE_NOISE
        check(bool((gap <= band).all()), f"{impl}: a top-1 scored {gap.max()} below the exact top-1")
        out[impl] = statistics.median(ms)
    log(f"ann serving: {time.perf_counter() - t0:.1f} s")
    return out


def phase_ann_large(torch):
    """The large IVF-PQ tier with K7: ANN_ROWS seeded clustered unit rows of
    512 on the card, ``IVFPQIndex.build_device`` (packed, 2,048 lists, S =
    64, K = 256), built twice from the same seed (identical codes); ANN_B
    perturbed corpus rows searched at nprobe = ANN_NPROBE with K7 and with
    the gather-sum (identical rows, scores within 1e-4 / 1e-5); recall@10
    against the exact top-10, with and without an int8 host re-rank of 50;
    one full probe through K7; the query p50 of both; K7's launches over the
    phase's searches."""
    import numpy as np

    from evr_tpu_torch.index import IVFPQIndex
    from evr_tpu_torch.index.ivf import chunk_rows, probe_lists
    from evr_tpu_torch.index.pq import adc_tables
    from evr_tpu_torch.ops.adc import adc_list_scores, adc_probe_scores, adc_probe_scores_plain
    from evr_tpu_torch.ops.topk import cosine_topk

    t0 = time.perf_counter()
    x = clustered_unit_rows(torch, ANN_ROWS, ANN_DIM, ANN_CENTRES, seed=11)
    torch.cuda.synchronize()
    log(f"ann large: {ANN_ROWS} x {ANN_DIM} fp32 rows ({x.numel() * 4 / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.2f} s")
    kw = dict(n_clusters=ANN_LISTS, n_subspaces=64, n_centroids=256, capacity_factor=1.5)
    builds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = IVFPQIndex().build_device(x, **kw)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, idx))
    (build_s, idx), (build2_s, idx2) = builds
    same = bool(torch.equal(idx.codes_lists, idx2.codes_lists)) and bool(
        torch.equal(idx.id_lists, idx2.id_lists)) and bool(torch.equal(idx.centroids, idx2.centroids))
    del idx2, builds
    o = int(idx.overflow.shape[0])
    log(f"ann large build: {build_s:.2f} s and {build2_s:.2f} s; capacity {idx._capacity}, pool "
        f"{o} rows ({o / ANN_ROWS:.4%}), codes {idx.codes_lists.numel() / 1e6:.1f} MB; "
        f"second build identical: {same}")
    check(same, "a second build with the same seed gave other codes, ids or centroids")
    check(idx._capacity == ANN_CAPACITY, f"capacity {idx._capacity}, expected {ANN_CAPACITY}")

    qrows = (torch.arange(ANN_B, device="cuda") * 2 + 1) * (ANN_ROWS // (2 * ANN_B))
    q = perturbed(torch, x, qrows, ANN_QUERY_PERTURB / math.sqrt(ANN_DIM), seed=12)
    _, exact_rows = cosine_topk(x, torch.from_numpy(q).cuda(), 0, ANN_ROWS, 10)
    exact_rows = exact_rows.cpu().numpy()
    sc, scl = [], []
    for lo in range(0, ANN_ROWS, 1 << 20):
        r8, s8 = quantize_host_rows(torch, x[lo:lo + (1 << 20)])
        sc.append(r8)
        scl.append(s8)
    idx.attach_host_store(np.concatenate(sc), np.concatenate(scl))
    del sc, scl

    def recall(rows):
        return float(np.mean([len(set(r) & set(e)) / 10 for r, e in zip(rows, exact_rows)]))

    chunk = chunk_rows(ANN_B * idx._capacity * 17)  # probes per K7 launch: 17 bytes a row (ivfpq.py)
    per_search = -(-ANN_NPROBE // chunk)
    adc_list_scores.launches = 0
    results = {}
    for impl in ("pallas", "xla"):
        for rerank in (None, 50):
            results[(impl, rerank)] = idx.search(q, 10, nprobe=ANN_NPROBE, rerank=rerank, adc_impl=impl)
    # a full probe: every list, ceil(lists / chunk) launches, the scores
    # bounded by the chunk
    t1 = time.perf_counter()
    sf, rf = idx.search(q, 10, nprobe=ANN_LISTS, adc_impl="pallas")
    full_ms = (time.perf_counter() - t1) * 1e3
    check(bool(np.isfinite(sf).all()) and bool((rf >= 0).all()) and bool((np.diff(sf, axis=1) <= 0).all()),
          "ann large: the full-probe search returned non-finite, missing or unsorted results")
    lat = {}
    for impl in ("pallas", "xla"):
        ts = []
        for _ in range(ANN_TIMED):
            t1 = time.perf_counter()
            idx.search(q, 10, nprobe=ANN_NPROBE, adc_impl=impl)
            ts.append((time.perf_counter() - t1) * 1e3)
        lat[impl] = statistics.median(ts)
    launches = adc_list_scores.launches
    expected = (2 + ANN_TIMED) * per_search + -(-ANN_LISTS // chunk)
    (sp, rp), (sx, rx) = results[("pallas", None)], results[("xla", None)]
    err = float(np.abs(sp - sx).max())
    log(f"ann large search B={ANN_B} nprobe={ANN_NPROBE} top 10: K7 vs gather-sum rows equal "
        f"{np.array_equal(rp, rx)}, max score difference {err:.3e}; recall@10 {recall(rp):.4f} "
        f"(re-rank 50: {recall(results[('pallas', 50)][1]):.4f}); query p50 K7 {lat['pallas']:.3f} ms, "
        f"gather-sum {lat['xla']:.3f} ms; a full probe of {ANN_LISTS} lists {full_ms:.1f} ms, "
        f"recall@10 {recall(rf):.4f}; K7 launches {launches} (expected {expected}: {per_search} a "
        f"search at nprobe {ANN_NPROBE}, {2 + ANN_TIMED} such searches, {-(-ANN_LISTS // chunk)} "
        f"for the full probe)")
    check(np.array_equal(rp, rx), "ann large: the pallas (K7) and xla searches returned other rows")
    check(bool(np.allclose(sp, sx, rtol=1e-4, atol=1e-5)), f"ann large: scores differ by {err}")
    check(np.array_equal(results[("pallas", 50)][1], results[("xla", 50)][1]),
          "ann large: re-ranked rows differ between the two impls")
    check(launches == expected > 0, f"adc_list_scores: {launches} launches, expected {expected}")
    extra = ann_host_costs(torch, idx, q, chunk)

    # K7 against its plain version at the path's own inputs: the index's
    # lists in place, this search's probed list ids and tables
    with torch.no_grad():
        qt = torch.from_numpy(q).cuda()
        cids = probe_lists(qt, idx.centroids, ANN_NPROBE)[2]
        codes_lists = idx.codes_lists.view(idx.n_clusters, idx._capacity, 64)
        tables = adc_tables(qt, idx.codebooks)
    err_path = adc_compare(torch, adc_probe_scores(codes_lists, cids, tables),
                           adc_probe_scores_plain(codes_lists, cids, tables), "on the search's lists in place")
    split = ann_query_split(torch, idx, q, lat["pallas"])
    log(f"ann large query split (nprobe {ANN_NPROBE}, B {ANN_B}, torch.profiler, ms a search): "
        f"{json.dumps({k: round(v, 4) for k, v in split.items()})}")
    del x
    torch.cuda.empty_cache()
    return {"build_s": build_s, "build2_s": build2_s, "pool": o, "launches": launches,
            "recall": recall(rp), "recall_rerank": recall(results[("pallas", 50)][1]),
            "p50_pallas": lat["pallas"], "p50_xla": lat["xla"], "max_abs_err": err_path,
            "full_ms": full_ms, **extra, "split": split, "index": idx, "cids": cids, "tables": tables}


def ann_host_costs(torch, idx, q, chunk: int, runs: int = 7) -> dict:
    """Two costs of the search beside K7, each timed in turns with the
    search as it is (query p50s, ms): the nprobe-32 query with a read-back
    of the probed ids' range before each launch (one synchronisation, as
    an id check on the host would make), and a full probe of ANN_LISTS
    lists chunked as the gathered copy was (a chunk of uint8 codes, 64
    bytes a row: ceil(ANN_LISTS / chunk) launches) against the chunk of
    ``chunk`` probes. Their K7 launches are not counted."""
    import evr_tpu_torch.index.ivfpq as ivfpq_mod
    from evr_tpu_torch.index.ivf import chunk_rows
    from evr_tpu_torch.ops import adc

    saved = adc.adc_list_scores.launches
    probe = ivfpq_mod.adc_probe_scores

    def synced(codes_lists, list_ids, tables):
        adc._check_ids(list_ids, codes_lists.shape[0])
        return probe(codes_lists, list_ids, tables)

    def gathered_chunks(_):
        return chunk_rows(ANN_B * idx._capacity * 64)

    cases = {}
    order = ("nprobe", "nprobe_synced", "full", "full_gathered_chunks")
    for name in order + order[::-1]:
        try:
            if name == "nprobe_synced":
                ivfpq_mod.adc_probe_scores = synced
            if name == "full_gathered_chunks":
                ivfpq_mod.chunk_rows = gathered_chunks
            nprobe = ANN_NPROBE if name.startswith("nprobe") else ANN_LISTS
            ts = []
            for _ in range(runs if nprobe == ANN_LISTS else 2 * ANN_TIMED):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                idx.search(q, 10, nprobe=nprobe, adc_impl="pallas")
                ts.append((time.perf_counter() - t1) * 1e3)
        finally:
            ivfpq_mod.adc_probe_scores = probe
            ivfpq_mod.chunk_rows = chunk_rows
        cases.setdefault(name, []).append(statistics.median(ts))
    adc.adc_list_scores.launches = saved
    out = {f"{k}_p50": v for k, v in cases.items()}
    log(f"ann large host costs (query p50 ms, two runs each in turns): {json.dumps(out)}; the full probe "
        f"{-(-ANN_LISTS // chunk)} launches, chunked as the gathered copy "
        f"{-(-ANN_LISTS // chunk_rows(ANN_B * idx._capacity * 64))}")
    return out


def kernel_busy_ms(torch, fn, calls: int) -> dict:
    """``fn`` run ``calls`` times under ``torch.profiler``: each kernel's
    device time a call (ms, by name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            busy[e.key] = (getattr(e, "device_time_total", 0.0) or e.cuda_time_total) / 1e3 / calls
    return busy


def ann_query_split(torch, idx, q, p50: float, searches: int = 10) -> dict:
    """A ``torch.profiler`` split of the nprobe-32 query with K7, in device
    ms a search: K7's kernels, ``probe_lists``' and ``merge_candidates``'
    kernels (their first-argmax rounds; each traced alone on the arguments
    one search hands it), the pool's GEMM kernels, every other kernel and the
    device's busy time; then the query's p50 without the profiler (``p50``)
    and the host's share of it (p50 less the busy time)."""
    import evr_tpu_torch.index.ivfpq as ivfpq_mod

    captured = {}
    saved = {n: getattr(ivfpq_mod, n) for n in ("probe_lists", "merge_candidates")}

    def capturing(name, fn):
        def run(*args, **kw):
            captured[name] = (args, kw)
            return fn(*args, **kw)
        return run

    for n, fn in saved.items():
        setattr(ivfpq_mod, n, capturing(n, fn))
    try:
        idx.search(q, 10, nprobe=ANN_NPROBE, adc_impl="pallas")
    finally:
        for n, fn in saved.items():
            setattr(ivfpq_mod, n, fn)
    whole = kernel_busy_ms(torch, lambda: idx.search(q, 10, nprobe=ANN_NPROBE, adc_impl="pallas"), searches)
    out = {"K7": sum(v for k, v in whole.items() if "adc_" in k)}
    for n, fn in saved.items():
        args, kw = captured[n]
        args = tuple(a.clone() if torch.is_tensor(a) else a for a in args)  # merge_candidates overwrites its scores
        part = kernel_busy_ms(torch, lambda: fn(*args, **kw), searches)
        out[n] = sum(part.values())
    out["pool_gemm"] = sum(v for k, v in whole.items()
                           if any(s in k.lower() for s in ("gemm", "gemv", "xmma", "cutlass")))
    out["device_busy"] = sum(whole.values())
    out["other_kernels"] = out["device_busy"] - out["K7"] - out["probe_lists"] - out["merge_candidates"] - out["pool_gemm"]
    out["p50"] = p50
    out["host"] = p50 - out["device_busy"]
    return out


def quantize_host_rows(torch, rows):
    """(int8 rows, fp32 scales) on the host: the int8 re-rank store."""
    scale = (rows.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127).to(torch.int8)
    return q.cpu().numpy(), scale.cpu().numpy()


def phase_times_adc(torch, idx, cids, tables):
    """K7 at the path's shape (the search's lists in place, its 256 probed
    list ids at B = 8 x nprobe 32, C = 3,072, S = 64, K = 256): the call as
    the search makes it (``adc_probe_scores``: the table's code-major copy
    and the launch), its plain version and a library expression of the same
    function on the gathered blocks (each block's query table expanded over
    C, gathered at the codes, summed), by CUDA events over back-to-back
    calls as every kernel's ``ms``; beside them the parent's form, the
    probed lists gathered into [P, C, S] and scored by ``adc_list_scores``.
    From a ``torch.profiler`` trace, the device time of K7's launch
    (``device_ms``) and of all the kernels of each form. The bound counts
    the distinct probed lists' codes once."""
    from evr_tpu_torch.ops import adc

    codes_lists = idx.codes_lists.view(idx.n_clusters, idx._capacity, 64)
    b, n = cids.shape
    _, c, s = codes_lists.shape
    k = tables.shape[2]
    p = b * n
    flat = cids.reshape(-1)
    blocks = codes_lists[flat]
    owner = torch.arange(p, device="cuda") // n

    def library():
        t = tables[owner][:, None].expand(p, c, s, k)
        return torch.gather(t, 3, blocks.long()[..., None])[..., 0].sum(dim=2)

    def call():
        return adc.adc_probe_scores(codes_lists, cids, tables)

    def parent_form():
        return adc.adc_list_scores(codes_lists[flat], tables, n)

    lists = int(torch.unique(cids).numel())
    nbytes = adc.adc_bytes(lists, c, s, k, b, p)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = p * c * s / H100_FP32_FLOPS * 1e3
    desc = f"{nbytes / 1e6:.1f} MB ({lists} distinct lists), {p * c * s / 1e6:.1f} M fp32 adds"
    rec = time_case(
        torch, "adc_list_scores", f"in place, P={p} C={c} S={s} K={k} B={b}", call,
        lambda: adc.adc_probe_scores_plain(codes_lists, cids, tables), library, t_ops, t_bytes, desc,
        (adc.adc_list_scores,))
    saved = adc.adc_list_scores.launches
    form_ms = cuda_ms(torch, parent_form)
    copy_ms = cuda_ms(torch, lambda: codes_lists[flat])
    busy = {"call": kernel_busy_ms(torch, call, 20), "parent_form": kernel_busy_ms(torch, parent_form, 20)}
    adc.adc_list_scores.launches = saved
    k7 = {f: sum(v for key, v in t.items() if "adc_" in key) for f, t in busy.items()}
    rec.update({"device_ms": k7["call"], "call_device_ms": sum(busy["call"].values()),
                "parent_form_ms": form_ms, "parent_form_k7_device_ms": k7["parent_form"],
                "parent_form_device_ms": sum(busy["parent_form"].values()), "gather_copy_ms": copy_ms})
    log(f"time adc_list_scores in place: the call {rec['ms']:.4f} ms (CUDA events), its kernels "
        f"{rec['call_device_ms']:.4f} ms on the device, K7's launch {rec['device_ms']:.4f}; the parent's "
        f"form (gather + adc_list_scores) {form_ms:.4f} ms, its kernels {rec['parent_form_device_ms']:.4f} "
        f"(K7's launch {k7['parent_form']:.4f}); the gathered copy alone {copy_ms:.4f} ms")
    return rec


def phase_index_tool(torch, ckpt: pathlib.Path):
    """``tools.index_tool.main``: ``build --type ivfpq --streamed`` (the
    paired layout) with the int8 host store over a TOOL_ROWS-row .npy, then
    ``query`` with a re-rank; its JSON lines against a direct search of the
    same index. Then ``query --query ... --checkpoint ckpt`` (the ViT-B/32
    reference file of ``phase_checkpoint``): its rows against a direct search
    with the text vectors of ``EmbeddingEngine.from_checkpoint(ckpt)``."""
    import contextlib
    import io

    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine, IVFPQIndex
    from evr_tpu_torch.tools import index_tool

    x = clustered_unit_rows(torch, TOOL_ROWS, ANN_DIM, 1024, seed=21)
    q = perturbed(torch, x, torch.arange(0, TOOL_ROWS, TOOL_ROWS // 8, device="cuda"),
                  ANN_QUERY_PERTURB / math.sqrt(ANN_DIM), seed=22)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        np.save(tmp / "emb.npy", x.cpu().numpy())
        np.save(tmp / "q.npy", q)
        del x
        runs = {}
        for name, argv in (
            ("build", ["build", "--embeddings", str(tmp / "emb.npy"), "--type", "ivfpq",
                       "--streamed", "--out", str(tmp / "idx.npz"), "--host-store",
                       str(tmp / "store"), "--device", "cuda"]),
            ("query", ["query", "--index", str(tmp / "idx.npz"), "--type", "ivfpq",
                       "--query-embeddings", str(tmp / "q.npy"), "--top-k", "10", "--nprobe", "32",
                       "--rerank", "50", "--host-store", str(tmp / "store"), "--device", "cuda"]),
        ):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                index_tool.main(argv)
            runs[name] = ([json.loads(line) for line in buf.getvalue().splitlines()],
                          time.perf_counter() - t0)
        built = runs["build"][0][-1]
        check(built["streamed"] and built["rows"] == TOOL_ROWS, f"index_tool build: {built}")
        lines = runs["query"][0]
        check(len(lines) == len(q) + 1 and lines[-1]["queries"] == len(q),
              f"index_tool query printed {len(lines)} lines")
        idx = IVFPQIndex.load(tmp / "idx.npz", device="cuda")
        check(idx._paired, "index_tool --streamed did not give the paired layout")
        idx.attach_host_store(np.load(tmp / "store.rows.npy"), np.load(tmp / "store.scales.npy"))
        _, rows = idx.search(q, 10, nprobe=32, rerank=50)
        for qi, line in enumerate(lines[:-1]):
            check([h["row"] for h in line["hits"]] == [int(r) for r in rows[qi] if r >= 0],
                  f"index_tool query {qi}: rows differ from a direct search")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            index_tool.main(["query", "--index", str(tmp / "idx.npz"), "--type", "ivfpq", "--query",
                             *QUERIES, "--model", MODEL, "--checkpoint", str(ckpt), "--top-k", "10",
                             "--nprobe", "32", "--rerank", "50", "--host-store", str(tmp / "store"),
                             "--device", "cuda"])
        ckpt_s = time.perf_counter() - t0
        text_lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        q_text = EmbeddingEngine.from_checkpoint(ckpt, MODEL, device="cuda").encode_texts(list(QUERIES))
        _, text_rows = idx.search(q_text, 10, nprobe=32, rerank=50)
        check(len(text_lines) == len(QUERIES) + 1, f"index_tool query --checkpoint printed {len(text_lines)} lines")
        for qi, line in enumerate(text_lines[:-1]):
            check([h["row"] for h in line["hits"]] == [int(r) for r in text_rows[qi] if r >= 0],
                  f"index_tool query --checkpoint {qi}: rows differ from a direct search")
    log(f"index_tool: build {json.dumps(built)} in {runs['build'][1]:.2f} s; query of {len(q)} "
        f"in {runs['query'][1]:.2f} s ({lines[-1]['batch_ms']} ms search), rows equal to a direct "
        f"search; query --checkpoint of {len(QUERIES)} texts with the {MODEL} reference file in "
        f"{ckpt_s:.2f} s, rows equal to a direct search with the engine's finetuned text vectors")
    return {"build_s": runs["build"][1], "query_s": runs["query"][1], "query_checkpoint_s": ckpt_s}


# -- 9. the flash route: ViT-H-14 ---------------------------------------------


def flash_params():
    """ViT-H-14 under ``attn_impl="flash"`` and its seeded random weights
    (numpy, drawn once for every ViT-H-14 phase)."""
    import numpy as np

    from evr_tpu_torch.models import get_model_config, init_clip_params

    cfg = get_model_config(FLASH_MODEL, attn_impl="flash")
    t0 = time.perf_counter()
    params = init_clip_params(0, cfg)  # drawn during the build (predraw_params)

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return int(np.asarray(tree).size)

    log(f"{FLASH_MODEL} (attn_impl=\"flash\"): {count(params) / 1e6:.1f} M random parameters "
        f"(seed 0) drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def phase_main_path_flash(torch, cfg, np_params, params_dtype: str = "float32"):
    """The flash route served: ``EmbeddingEngine(cfg=...)`` with the seeded
    ViT-H-14 weights (or, with ``params_dtype="int8"``, their int8 block
    linears) encodes N_FRAMES synthetic 224² frames at batch BATCH, the data
    root is written, ``ServingContext(engine=...)`` boots and answers
    /api/search; K6a's and K6b's launches against the counts expected (every
    full block of both towers), K1's, K2's, K3a's and K3b's (none), and the
    unit embeddings and rankings against the same path with K6's plain
    version (``attn_impl="flash_plain"``), within the int8 bands on int8
    weights."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf

    vis = cfg.vision
    frames = synthetic_frames(torch, N_FRAMES, vis.image_size, vis.patch_size)
    t0 = time.perf_counter()
    engine = EmbeddingEngine(FLASH_MODEL, params=np_params, cfg=cfg, device="cuda", batch_size=BATCH,
                             params_dtype=params_dtype)
    log(f"engine: {FLASH_MODEL}, attn_impl={engine.cfg.attn_impl!r}, {params_dtype} weights, "
        f"{engine.compute_dtype}, set up in {time.perf_counter() - t0:.1f} s")
    counted = [fa.flash_attention_full, fa.flash_attention_blocked, bf.fused_attn_block,
               bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q]
    what = f"{FLASH_MODEL} flash" + (" int8" if params_dtype == "int8" else "")
    with tempfile.TemporaryDirectory() as tmp:
        emb, ctx, encode_s, request_ms, launches = serve_counted(
            torch, engine, frames, pathlib.Path(tmp), counted)
        n_batches = -(-N_FRAMES // BATCH)
        expected = {"flash_attention_full": (vis.layers - 1) * n_batches,
                    "flash_attention_blocked": served_text_launches(cfg),
                    "fused_attn_block": 0, "fused_mlp_block": 0, "fused_attn_block_q": 0,
                    "fused_mlp_block_q": 0}
        log(f"launches over the {what} path: {launches} (expected {expected}: "
            f"{vis.layers - 1} full vision blocks per encode batch, {n_batches} batches; "
            f"{cfg.text.layers} text blocks per TextSearcher dispatch, {len(QUERIES)} dispatches; "
            f"{cfg.text.layers - 1} per negative-request text encode, {N_NEGATIVE_TEXTS} encodes)")
        for name, n in expected.items():
            check(launches[name] == n, f"{name}: {launches[name]} launches, expected {n}")
        if params_dtype == "int8":
            bands = (INT8_ONE_VECTOR_RANK_NOISE, INT8_SERVED_RANK_NOISE, what, "flash_plain",
                     VITH_INT8_MIN_COS)
        else:
            bands = (FLASH_ONE_VECTOR_RANK_NOISE, FLASH_SERVED_RANK_NOISE, what, "flash_plain")
        diffs = check_against_plain(torch, engine, frames, emb, *bands)
        p50 = text_query_p50_ms(engine, ctx)
        del ctx
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "encode_frames_per_s": N_FRAMES / encode_s,
            "text_query_p50_ms": p50, "request_p50_ms": statistics.median(request_ms),
            "against_plain": diffs}


def block_leaf(key: str) -> bool:
    return key.startswith(("clip/visual/blocks/", "clip/text/blocks/"))


def phase_train_flash(torch, cfg, np_params):
    """The flash route trained: FLASH_TRAIN_STEPS steps of ``make_train_step``
    (the step ``Trainer`` runs) on ViT-H-14 at full width, batch 32, bf16,
    ``freeze_layers=8``, InfoNCE + 0.2 × CE, on a synthetic caption set. K6
    launches in the forward of every block (K6a in the vision tower, K6b in
    the causal text tower); the backward is the plain recompute
    (``xla_attention``) with no kernel and no plain forward; finite losses;
    frozen leaves bit-unchanged and trainable ones moved. Then one step from
    the same params and batch through K6 and through its plain version
    (``attn_impl="flash_plain"``), fp32 and bf16, held within bands that a
    gradient perturbed to cosine 0.99 fails; the step time."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models import params_from_numpy
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.training import (
        CaptionDataset, TrainConfig, TrainState, make_grad_fn, make_optimizer, make_train_step,
        param_group_labels,
    )
    from evr_tpu_torch.training.finetune import flat_leaves

    cls_cfg = ClassifierConfig(embed_dim=cfg.embed_dim)
    init = {"clip": np_params, "classifier": init_classifier_params(1, cls_cfg)}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train_json, _ = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size)
        batches = list(CaptionDataset(train_json, root).batches(
            TRAIN_BATCH, cfg.vision.image_size, seed=0))[:FLASH_TRAIN_STEPS]
    check(len(batches) == FLASH_TRAIN_STEPS, f"{len(batches)} caption batches")
    tc = TrainConfig(seed=0, batch_size=TRAIN_BATCH, epochs=1, compute_dtype="bfloat16",
                     freeze_layers=8)
    params = params_from_numpy(init, "cuda")
    opt = make_optimizer(tc, params, len(batches))
    step, _ = make_train_step(cfg, cls_cfg, tc, opt)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    recompute, plain_fwd = counting(fa.xla_attention), counting(fa.flash_attention_plain)
    fa.xla_attention, fa.flash_attention_plain = recompute, plain_fwd
    counted = [fa.flash_attention_full, fa.flash_attention_blocked, bf.fused_attn_block,
               bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd, recompute,
               plain_fwd]
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in counted:
            fn.launches = 0
        times, losses = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics["total_loss"].item())
        launches = {fn.__name__: fn.launches for fn in counted}
    finally:
        fa.xla_attention, fa.flash_attention_plain = recompute.__wrapped__, plain_fwd.__wrapped__
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(batches)
    blocks = cfg.vision.layers + cfg.text.layers
    expected = {"flash_attention_full": cfg.vision.layers * n, "flash_attention_blocked": cfg.text.layers * n,
                "xla_attention": blocks * n}
    log(f"{FLASH_MODEL} flash training launches over {n} steps: {launches} (expected {expected}, "
        f"every other count 0); losses {[round(v, 6) for v in losses]}")
    for name, count in launches.items():
        check(count == expected.get(name, 0), f"{name}: {count} launches, expected {expected.get(name, 0)}")
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")

    labels = flat_leaves(param_group_labels(state.params, tc.freeze_layers))
    want, got = flat_leaves(init), flat_leaves(state.params)
    frozen = [k for k in labels if labels[k] == "frozen"]
    moved = [k for k in frozen if not torch.equal(got[k].cpu(), torch.from_numpy(np.asarray(want[k])))]
    stale = [k for k in labels if labels[k] != "frozen"
             and torch.equal(got[k].cpu(), torch.from_numpy(np.asarray(want[k])))]
    log(f"{FLASH_MODEL} flash training: {len(frozen)} frozen leaves, {len(moved)} of them moved; "
        f"{len(labels) - len(frozen)} trainable leaves, {len(stale)} of them unmoved")
    check(len(frozen) == 16 and not moved, f"frozen leaves moved: {moved}")
    check(not stale, f"trainable leaves did not move: {stale[:5]}")
    del state, params, opt, got
    torch.cuda.empty_cache()

    # one step from the same params and batch: K6 against its plain version
    params = params_from_numpy(init, "cuda")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flash_plain")
    compared = {}
    for dtype in ("float32", "bfloat16"):
        tcd = dataclasses.replace(tc, compute_dtype=dtype)
        fn_k, fn_p = make_grad_fn(cfg, cls_cfg, tcd), make_grad_fn(plain_cfg, cls_cfg, tcd)
        m_k, grads_k = fn_k(params, batches[0], torch.Generator(device="cuda").manual_seed(1))
        m_p, grads_p = fn_p(params, batches[0], torch.Generator(device="cuda").manual_seed(1))
        compared[dtype] = step_compare(
            torch, f"{FLASH_MODEL} K6 step vs plain step, {dtype}", m_k, m_p, grads_k, grads_p,
            (lambda k: True) if dtype == "float32" else block_leaf)
        del grads_k, grads_p
    del params
    torch.cuda.empty_cache()
    for dtype, bands in (("float32", FLASH_STEP_FP32_BANDS), ("bfloat16", FLASH_STEP_BF16_BANDS)):
        step_check(f"{FLASH_MODEL} K6 step vs plain step, {dtype}", compared[dtype], bands)
    step_s = statistics.median(times)
    log(f"{FLASH_MODEL} flash train step (batch {TRAIN_BATCH}, bf16): {[round(t, 4) for t in times]} s, "
        f"median {step_s:.4f} s = {TRAIN_BATCH / step_s:.2f} samples/s; peak memory {peak:.1f} GiB")
    return {"launches": launches, "step_s": step_s, "samples_per_s": TRAIN_BATCH / step_s,
            "peak_gib": peak, "compared": compared}


# -- 10. ViT-H-14 under its default route -----------------------------------


def phase_main_path_vith(torch, np_params, params_dtype: str = "float32"):
    """ViT-H-14 served under its default configuration:
    ``EmbeddingEngine(FLASH_MODEL, params=..., device="cuda")`` with no
    ``cfg``, so ``attn_impl="auto"`` sends every full block of both towers
    (vision W 1280, 16 heads of 80, exact GELU; text W 1024, 16 heads of 64)
    to K1 and K2, or with ``params_dtype="int8"`` to K3a and K3b. The path of
    phase 4 over the seeded ViT-H-14 weights; the launches of the route's
    pair against the counts expected, of the other pair and of K6 (none);
    embeddings and rankings against ``attn_impl="plain"`` within the bf16
    (int8) bands."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf

    t0 = time.perf_counter()
    engine = EmbeddingEngine(FLASH_MODEL, params=np_params, device="cuda", batch_size=BATCH,
                             params_dtype=params_dtype)
    cfg = engine.cfg
    check(cfg.attn_impl == "auto", f"{FLASH_MODEL}'s default attn_impl is {cfg.attn_impl!r}")
    int8 = params_dtype == "int8"
    what = f"{FLASH_MODEL} auto " + ("int8" if int8 else "bf16")
    log(f"engine: {FLASH_MODEL}, default configuration (attn_impl={cfg.attn_impl!r}), {params_dtype} "
        f"weights, {engine.compute_dtype}, set up in {time.perf_counter() - t0:.1f} s")
    frames = synthetic_frames(torch, N_FRAMES, cfg.vision.image_size, cfg.vision.patch_size)
    route = [bf.fused_attn_block_q, bf.fused_mlp_block_q] if int8 else [bf.fused_attn_block, bf.fused_mlp_block]
    other = [bf.fused_attn_block, bf.fused_mlp_block] if int8 else [bf.fused_attn_block_q, bf.fused_mlp_block_q]
    counted = route + other + [fa.flash_attention_full, fa.flash_attention_blocked]
    with tempfile.TemporaryDirectory() as tmp:
        emb, ctx, encode_s, request_ms, launches = serve_counted(
            torch, engine, frames, pathlib.Path(tmp), counted)
        n_batches = -(-N_FRAMES // BATCH)
        per_route = (cfg.vision.layers - 1) * n_batches + served_text_launches(cfg)
        expected = {fn.__name__: per_route if fn in route else 0 for fn in counted}
        log(f"launches over the {what} path: {launches} (expected {expected}: "
            f"{cfg.vision.layers - 1} full vision blocks per encode batch, {n_batches} batches; "
            f"{cfg.text.layers} text blocks per TextSearcher dispatch, {len(QUERIES)} dispatches; "
            f"{cfg.text.layers - 1} per negative-request text encode, {N_NEGATIVE_TEXTS} encodes)")
        for name, n in expected.items():
            check(launches[name] == n, f"{name}: {launches[name]} launches, expected {n}")
        if int8:
            bands = (INT8_ONE_VECTOR_RANK_NOISE, INT8_SERVED_RANK_NOISE, what, "plain", VITH_INT8_MIN_COS)
        else:
            bands = (ONE_VECTOR_RANK_NOISE, SERVED_RANK_NOISE, what, "plain")
        diffs = check_against_plain(torch, engine, frames, emb, *bands)
        p50 = text_query_p50_ms(engine, ctx)
        del ctx
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "encode_frames_per_s": N_FRAMES / encode_s,
            "text_query_p50_ms": p50, "request_p50_ms": statistics.median(request_ms),
            "against_plain": diffs}


# -- 11. K8 and K9, the exported ops -----------------------------------------


def ln_inputs(torch, rows: int, d: int, seed: int):
    """x [rows, d] of unit variance, scale about 1 and bias about 0 (fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = unit_activations(torch, (rows, d), gen, "cuda")
    scale = 1.0 + torch.randn(d, generator=gen, device="cuda") * 0.1
    bias = torch.randn(d, generator=gen, device="cuda") * 0.1
    return x, scale, bias


def phase_layer_norm(torch):
    """K8 through the entry point a user calls, ``ops.fused_layer_norm``
    (no tower calls it, as in the JAX package): every LN_CASES case, bf16
    and fp32, with and without the quickGELU tail, its launches counted over
    that run alone; then each output against the plain version on the same
    inputs (fp32 FP32_TOL, bf16 BF16_TOL); zero rows; the times at
    LN_MAIN_CASE in bf16 against ``F.layer_norm`` (and the tail)."""
    import torch.nn.functional as F

    from evr_tpu_torch import ops
    from evr_tpu_torch.ops import layernorm as ln

    inputs = {tag: ln_inputs(torch, rows, d, seed=12) for tag, (rows, d) in LN_CASES.items()}
    cases = [(tag, dt, act) for tag in LN_CASES for dt in (torch.bfloat16, torch.float32)
             for act in ("none", "quick_gelu")]
    ln.fused_layer_norm.launches = 0
    outs = [ops.fused_layer_norm(inputs[tag][0].to(dt), *inputs[tag][1:], activation=act)
            for tag, dt, act in cases]
    torch.cuda.synchronize()
    launches = ln.fused_layer_norm.launches
    log(f"fused_layer_norm launches over its {len(cases)} calls: {launches}")
    check(launches == len(cases), f"fused_layer_norm: {launches} launches, expected {len(cases)}")
    worst = 0.0
    for (tag, dt, act), got in zip(cases, outs):
        x, scale, bias = inputs[tag]
        ref = ln.fused_layer_norm_plain(x.to(dt), scale, bias, act)
        err, cos, finite = compare(torch, got, ref)
        name = f"fused_layer_norm {tag} {act} {str(dt).split('.')[-1]}"
        log(f"parity {name}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
        check(got.dtype == dt and got.shape == x.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
        check(finite, f"{name}: non-finite output")
        tol = FP32_TOL if dt == torch.float32 else BF16_TOL
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        if dt == torch.bfloat16:
            worst = max(worst, err)
    empty = ops.fused_layer_norm(torch.empty((0, 768), device="cuda", dtype=torch.bfloat16),
                                 *inputs["vitb-vision"][1:])
    check(empty.shape == (0, 768) and ln.fused_layer_norm.launches == launches, "zero rows")
    del outs

    rows, d = LN_CASES[LN_MAIN_CASE]
    x32, scale, bias = inputs[LN_MAIN_CASE]
    x = x32.to(torch.bfloat16)
    s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    times = {}
    for act, ops_per in (("none", 8), ("quick_gelu", 13)):
        def lib(act=act):
            y = F.layer_norm(x, (d,), s16, b16, 1e-5)
            return y * torch.sigmoid(1.702 * y) if act == "quick_gelu" else y

        nbytes = 2 * rows * d * 2 + 2 * d * 4
        flops = ops_per * rows * d
        times[act] = time_case(
            torch, "fused_layer_norm", f"{LN_MAIN_CASE} {act} bf16 {rows} x {d}",
            lambda act=act: ops.fused_layer_norm(x, scale, bias, activation=act),
            lambda act=act: ln.fused_layer_norm_plain(x, scale, bias, act), lib,
            flops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3,
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP fp32", (ln.fused_layer_norm,))
    return {"launches": launches, "max_abs_err": worst, "times": times}


def phase_merged(torch):
    """K9 through the entry point a user calls, ``fused_block_merged`` (no
    tower calls it, as in the JAX package), at MERGED_SHAPES, bf16 and fp32,
    its launches counted over that run alone; each output bit-equal to
    ``fused_block_apply`` (K1 then K2) on the same inputs and within the
    K1/K2 tolerances of the plain version; the times at each shape (bf16)
    against the K1 + K2 pair, the plain version and the library composition
    of the two halves."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    blocks = {}
    for tag, s in MERGED_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(13)
        p = block_params(torch, s["W"], gen, dev)
        blocks[tag] = (p, unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev))
    cases = [(tag, dt) for tag in MERGED_SHAPES for dt in (torch.bfloat16, torch.float32)]

    def run(fn, tag, dt):
        s = MERGED_SHAPES[tag]
        p, x32 = blocks[tag]
        return fn(x32.to(dt), p, s["H"], s.get("act", "quick_gelu"), s["causal"])

    bf.fused_block_merged.launches = 0
    outs = [run(bf.fused_block_merged, tag, dt) for tag, dt in cases]
    torch.cuda.synchronize()
    launches = bf.fused_block_merged.launches
    log(f"fused_block_merged launches over its {len(cases)} calls: {launches}")
    check(launches == len(cases), f"fused_block_merged: {launches} launches, expected {len(cases)}")
    worst = 0.0
    for (tag, dt), got in zip(cases, outs):
        pair = run(bf.fused_block_apply, tag, dt)
        ref = run(bf.fused_block_merged_plain, tag, dt)
        err, cos, finite = compare(torch, got, ref)
        same = bool(torch.equal(got, pair))
        name = f"fused_block_merged {tag} {str(dt).split('.')[-1]}"
        log(f"parity {name}: bit-equal to fused_block_apply {same}; against the plain version "
            f"max_abs_err={err:.3e} min_row_cos={cos:.7f}")
        check(same, f"{name}: differs from fused_block_apply (K1 then K2)")
        check(finite, f"{name}: non-finite output")
        if dt == torch.float32:
            check(err <= FP32_TOL, f"{name}: max abs err {err} > {FP32_TOL}")
        else:
            check(err <= BF16_TOL, f"{name}: max abs err {err} > {BF16_TOL}")
            check(cos >= BF16_MIN_COS, f"{name}: row cosine {cos} < {BF16_MIN_COS}")
            if tag == "vision":
                worst = max(worst, err)
        del pair, ref
    del outs

    dt = torch.bfloat16
    counted = (bf.fused_block_merged, bf.fused_attn_block, bf.fused_mlp_block)
    recs, pair_ms = {}, {}
    for tag, s in MERGED_SHAPES.items():
        p32, x32 = blocks[tag]
        x = x32.to(dt)
        p = {k: {n: (v.to(dt) if torch.is_tensor(v) else {m: t.to(dt) for m, t in v.items()})
                 for n, v in g.items()} for k, g in p32.items()}
        act = s.get("act", "quick_gelu")
        attn, mlp = bf.block_half_params(p)
        lib_attn, lib_mlp = library_halves(torch, attn, mlp, s)
        saved = [c.launches for c in counted]
        pair_ms[tag] = min(cuda_ms(torch, lambda: bf.fused_block_apply(x, p, s["H"], act, s["causal"]))
                           for _ in range(2))
        for c, n in zip(counted, saved):
            c.launches = n
        t_ops = sum(half_bound_ms(n, s, 2)[0] for n in ("fused_attn_block", "fused_mlp_block"))
        nbytes = (2 * s["B"] * s["T"] * s["W"] + 12 * s["W"] ** 2 + 13 * s["W"]) * 2
        recs[tag] = time_case(
            torch, "fused_block_merged", f"{tag} bf16",
            lambda: bf.fused_block_merged(x, p, s["H"], act, s["causal"]),
            lambda: bf.fused_block_merged_plain(x, p, s["H"], act, s["causal"]), lambda: lib_mlp(lib_attn(x)),
            t_ops, nbytes / H100_BYTES_PER_S * 1e3,
            f"{t_ops:.4f} ms of K1's and K2's operations, {nbytes / 1e6:.1f} MB", counted)
        log(f"time fused_block_merged {tag} bf16: the K1 + K2 pair (fused_block_apply) {pair_ms[tag]:.4f} ms")
    return {"launches": launches, "max_abs_err": worst, "times": recs["vision"], "pair_ms": pair_ms}


# -- 12. ViT-Tiny-Test on the card ---------------------------------------------


def tiny_kernel_parity(torch) -> float:
    """K1, K2, K3a, K3b, K9 and K6 (K6a on the vision shape, K6b on the
    causal text shape) against their plain versions at TINY and TINY_TEXT
    (W 64, four heads of 16), bf16 and fp32, within the bands of their
    registry-shape checks; K9 bit-equal to fused_block_apply too. Returns
    the largest bf16 error."""
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = 0.0
    for shape_name, s in (("tiny", TINY), ("tiny-text", TINY_TEXT)):
        B, T, W, H, causal = s["B"], s["T"], s["W"], s["H"], s["causal"]
        gen = torch.Generator(device=dev).manual_seed(16)
        p = block_params(torch, W, gen, dev)
        attn, mlp = bf.block_half_params(p)
        qattn, qmlp = bf.quant_block_half_params(quantized_block(p))
        x32 = unit_activations(torch, (B, T, W), gen, dev)
        qkv32 = [unit_activations(torch, (B, H, T, W // H), gen, dev) for _ in range(3)]
        k6 = fa.flash_attention_blocked if causal else fa.flash_attention_full
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            a, m = [t.to(dt) for t in attn], [t.to(dt) for t in mlp]
            q, k, v = (t.to(dt) for t in qkv32)
            cases = (
                ("fused_attn_block", lambda: bf.fused_attn_block(x, *attn, n_heads=H, causal=causal),
                 lambda: bf.fused_attn_block_plain(x, *a, n_heads=H, causal=causal), False),
                ("fused_mlp_block", lambda: bf.fused_mlp_block(x, *mlp),
                 lambda: bf.fused_mlp_block_plain(x, *m), False),
                ("fused_attn_block_q", lambda: bf.fused_attn_block_q(x, *qattn, n_heads=H, causal=causal),
                 lambda: bf.fused_attn_block_q_plain(x, *bf.cast_quant_args(dt, qattn), n_heads=H,
                                                     causal=causal), True),
                ("fused_mlp_block_q", lambda: bf.fused_mlp_block_q(x, *qmlp),
                 lambda: bf.fused_mlp_block_q_plain(x, *bf.cast_quant_args(dt, qmlp)), True),
                ("fused_block_merged", lambda: bf.fused_block_merged(x, p, H, causal=causal),
                 lambda: bf.fused_block_merged_plain(x, p, H, causal=causal), False),
                (k6.__name__, lambda: k6(q, k, v, causal) if causal else k6(q, k, v),
                 lambda: fa.flash_attention_plain(q, k, v, causal), False),
            )
            for name, kern, plain, int8 in cases:
                got = kern()
                torch.cuda.synchronize()
                err, cos, finite = compare(torch, got, plain())
                tag = f"{name} {shape_name} {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                if dt == torch.float32:
                    tol = INT8_FP32_TOL if int8 else FP32_TOL
                    check(err <= tol, f"{tag}: max abs err {err} > {tol}")
                else:
                    check(err <= BF16_TOL, f"{tag}: max abs err {err} > {BF16_TOL}")
                    worst = max(worst, err)
                check(cos >= (INT8_MIN_COS if int8 else BF16_MIN_COS), f"{tag}: row cosine {cos}")
                if name == "fused_block_merged":
                    pair = bf.fused_block_apply(x, p, H, causal=causal)
                    check(torch.equal(got, pair), f"{tag}: differs from fused_block_apply (K1 then K2)")
    return worst


def phase_tiny(torch):
    """ViT-Tiny-Test on the card (ROADMAP C3): its kernels against their
    plain versions (``tiny_kernel_parity``), then
    ``EmbeddingEngine(TINY_MODEL, params=..., device="cuda")`` with seeded
    random weights encodes N_FRAMES synthetic 64² frames at batch BATCH and
    the text queries, through K1 and K2 with bf16 weights, K3a and K3b with
    int8 weights, and K6a and K6b under ``attn_impl="flash"``: each route's
    launches against the counts expected (every full block of both towers;
    the other kernels none), and the unit frame and text embeddings against
    the same engine's plain route (``"plain"``, ``"flash_plain"``) within
    row cosine EMBED_MIN_COS."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.clip import encode_staged_u8, encode_text
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf

    worst = tiny_kernel_parity(torch)
    np_params = init_clip_params(np.random.default_rng(0), get_model_config(TINY_MODEL))
    counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q,
               fa.flash_attention_full, fa.flash_attention_blocked]
    out = {"max_abs_err": worst}
    for route, impl, params_dtype, plain_impl, kernels in (
            ("bf16", "auto", "float32", "plain", ("fused_attn_block", "fused_mlp_block")),
            ("int8", "auto", "int8", "plain", ("fused_attn_block_q", "fused_mlp_block_q")),
            ("flash", "flash", "float32", "flash_plain", ("flash_attention_full", "flash_attention_blocked"))):
        cfg = get_model_config(TINY_MODEL, attn_impl=impl)
        engine = EmbeddingEngine(TINY_MODEL, params=np_params, cfg=cfg, device="cuda", batch_size=BATCH,
                                 params_dtype=params_dtype)
        frames = synthetic_frames(torch, N_FRAMES, cfg.vision.image_size, cfg.vision.patch_size)
        engine.encode_staged_images(frames[:BATCH])  # first call: kernel libraries load
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        emb = engine.encode_staged_images(frames)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        txt = engine.encode_texts(list(QUERIES))
        launches = {fn.__name__: fn.launches for fn in counted}
        n_batches = -(-N_FRAMES // BATCH)
        vis, text = cfg.vision.layers - 1, cfg.text.layers - 1  # full blocks: the last is pooled
        per = {"fused_attn_block": vis * n_batches + text, "flash_attention_full": vis * n_batches,
               "flash_attention_blocked": text}
        per["fused_mlp_block"] = per["fused_attn_block_q"] = per["fused_mlp_block_q"] = per["fused_attn_block"]
        expected = {name: per[name] if name in kernels else 0 for name in launches}
        what = f"{TINY_MODEL} {route}"
        log(f"launches over the {what} encode ({n_batches} batches of {BATCH} frames, one text encode of "
            f"{len(QUERIES)} queries): {launches} (expected {expected})")
        for name, n in expected.items():
            check(launches[name] == n, f"{what}: {name} {launches[name]} launches, expected {n}")
        check(emb.shape == (N_FRAMES, cfg.embed_dim) and bool(np.isfinite(emb).all()),
              f"{what}: embeddings {emb.shape}, finite {bool(np.isfinite(emb).all())}")
        plain_cfg = dataclasses.replace(engine.cfg, attn_impl=plain_impl)
        with torch.inference_mode():
            ref = torch.cat([encode_staged_u8(engine.params, plain_cfg, torch.from_numpy(frames[i:i + BATCH]).cuda(),
                                              dtype=engine.compute_dtype) for i in range(0, N_FRAMES, BATCH)])
            tokens = torch.from_numpy(engine.tokenizer(list(QUERIES))).cuda()
            txt_ref = encode_text(engine.params, plain_cfg, tokens, dtype=engine.compute_dtype, eot_fast_final=True)
        ref, txt_ref = ref.float().cpu().numpy(), txt_ref.float().cpu().numpy()
        unit = [x / np.linalg.norm(x, axis=1, keepdims=True) for x in (emb, ref, txt, txt_ref)]
        cos, tcos = (unit[0] * unit[1]).sum(1).min(), (unit[2] * unit[3]).sum(1).min()
        log(f"{what}: encode {N_FRAMES / encode_s:.1f} frames/s; against {plain_impl!r}: least row cosine "
            f"{cos:.7f} (frames), {tcos:.7f} (text)")
        check(min(cos, tcos) >= EMBED_MIN_COS, f"{what}: row cosine {min(cos, tcos)} < {EMBED_MIN_COS}")
        out[route] = {"launches": launches, "frame_cos": float(cos), "text_cos": float(tcos),
                      "encode_frames_per_s": N_FRAMES / encode_s}
        del engine
    torch.cuda.empty_cache()
    return out


# -- 13. checkpoints and the one-call searchers ------------------------------


def band_violations(a, b, noise: float, k: int = SEARCH_K) -> int:
    """Hold two paths' rankings of one query together: ``a`` and ``b`` are
    (scores, rows) of at least k entries. A row in one path's top k and not
    the other's must score, in the other path, within ``noise`` of that
    path's k-th score; a row the other path did not return counts too."""
    bad = 0
    for (s_a, r_a), (s_b, r_b) in ((a, b), (b, a)):
        top_b = set(r_b[:k].tolist())
        score_b = dict(zip(r_b.tolist(), s_b.tolist()))
        cut = float(s_b[k - 1])
        for r in r_a[:k].tolist():
            if r not in top_b:
                bad += int(r not in score_b or abs(score_b[r] - cut) > noise)
    return bad


def ranking_check(got, ref, noise: float) -> tuple[int, float]:
    """(band violations over every query, largest score difference on the
    rows both return) of two [Q, n] (scores, rows) results."""
    bad, diff = 0, 0.0
    for i in range(len(ref[1])):
        a, b = (got[0][i], got[1][i]), (ref[0][i], ref[1][i])
        bad += band_violations(a, b, noise)
        ref_score = dict(zip(b[1].tolist(), b[0].tolist()))
        common = [abs(s - ref_score[r]) for s, r in zip(a[0].tolist(), a[1].tolist()) if r in ref_score]
        diff = max([diff] + common)
    return bad, diff


def thread_round(searcher, queries) -> tuple[list, float, float]:
    """Each query searched by its own thread, all released at once: (each
    query's (scores, rows), p50 ms, queries per second from the first start
    to the last return)."""
    import threading

    n = len(queries)
    barrier, out = threading.Barrier(n), [None] * n
    spans = [(0.0, 0.0)] * n
    errors = []

    def worker(i):
        try:
            barrier.wait()
            t1 = time.perf_counter()
            scores, rows = searcher.search(queries[i], SEARCH_FETCH)
            out[i] = (scores[0], rows[0])
            spans[i] = (t1, time.perf_counter())
        except Exception as e:  # noqa: BLE001 - reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and not errors, f"search threads: {errors[:3]}")
    lat = [(e - b) * 1e3 for b, e in spans]
    wall = max(e for _, e in spans) - min(b for b, _ in spans)
    return out, statistics.median(lat), n / wall


def phase_searchers(torch, engine, root: pathlib.Path, frames, one_noise: float, served_noise: float,
                    what: str, counted, **ctx_kwargs) -> dict:
    """The one-call searchers over a served data root (``ctx_kwargs``: its
    index settings). ``TextSearcher`` against the two-step path
    (``encode_texts`` then ``FrameIndex.search_raw``): under one query vector
    within ``one_noise`` (scores within SEARCHER_SCORE_TOL on the rows both
    return), with each path's own text vectors within ``served_noise``; the
    uncached text-query p50 of both, in turns. N_THREADS threads with
    distinct single queries, unbatched and under a BATCH_WINDOW_MS window
    (``ServingContext(batch_window_ms=...)``): the batched dispatches fewer
    than the queries and of bucket sizes, the batched rows within
    ``one_noise`` of the unbatched ones, and the same check rejecting rows
    handed to the wrong query; the p50 and queries per second of each. Then
    ``ImageSearcher`` with N_IMAGE_QUERIES indexed frames as queries: each
    frame's own row its top-1, in one dispatch through every vision block
    (``counted``: the route's two kernels)."""
    import threading

    import numpy as np

    from evr_tpu_torch.models.clip import encode_text
    from evr_tpu_torch.serving import ServingContext

    t0 = time.perf_counter()
    ctx = ServingContext(root, engine=engine, **ctx_kwargs)
    check(len(ctx.boot()) == N_VIDEOS, f"{what}: boot")
    searcher, index = ctx.query_engine._searcher, ctx.index
    check(searcher is not None and searcher._batcher is None, f"{what}: no one-call searcher")

    # the one call against the two steps
    one = searcher.search(list(QUERIES), SEARCH_FETCH)
    with torch.inference_mode():
        tokens = torch.from_numpy(engine.tokenizer(list(QUERIES))).cuda()
        q_one = encode_text(engine.params, engine.cfg, tokens, dtype=engine.compute_dtype).float().cpu().numpy()
    bad_one, diff_one = ranking_check(one, index.search_raw(q_one, SEARCH_FETCH), one_noise)
    bad_own, diff_own = ranking_check(one, index.search_raw(engine.encode_texts(list(QUERIES)), SEARCH_FETCH),
                                      served_noise)
    log(f"{what}: TextSearcher vs the two-step path, top {SEARCH_K} of {len(QUERIES)} queries: one query "
        f"vector: {bad_one} rows beyond {one_noise}, scores on common rows apart by {diff_one:.2e}; each "
        f"path's own text vectors: {bad_own} rows beyond {served_noise}, largest difference {diff_own:.2e}")
    check(bad_one == 0 and diff_one <= SEARCHER_SCORE_TOL,
          f"{what}: TextSearcher vs the index search under one vector: {bad_one} rows, {diff_one}")
    check(bad_own == 0, f"{what}: TextSearcher vs the two-step path: {bad_own} rows beyond {served_noise}")

    # uncached text-query latency, the two paths in turns
    lat = {"two_step": [], "one_call": []}
    for i in range(P50_QUERIES):
        for mode in (("two_step", "one_call") if i % 2 == 0 else ("one_call", "two_step")):
            q = f"a {mode.replace('_', ' ')} query number {i} about a scene"
            t1 = time.perf_counter()
            if mode == "two_step":
                index.search_raw(engine.encode_texts([q]), SEARCH_K)
            else:
                searcher.search(q, SEARCH_K)
            lat[mode].append((time.perf_counter() - t1) * 1e3)
    p50 = {m: statistics.median(v) for m, v in lat.items()}
    log(f"{what}: uncached text query p50, {P50_QUERIES} each in turns: one call (TextSearcher) "
        f"{p50['one_call']:.3f} ms, two steps (encode_texts + search_raw) {p50['two_step']:.3f} ms")

    # N_THREADS concurrent single queries, without and with the window
    batched_ctx = ServingContext(root, engine=engine, batch_window_ms=BATCH_WINDOW_MS, **ctx_kwargs)
    batched_ctx.boot()
    batched = batched_ctx.query_engine._searcher
    check(batched._batcher is not None and batched._batcher.window_s == BATCH_WINDOW_MS / 1e3
          and batched.max_batch == SEARCHER_MAX_BATCH, f"{what}: the window did not reach the searcher")
    sizes, lock = [], threading.Lock()
    dispatch = batched._dispatch

    def recorded(queries, *args, **kwargs):
        with lock:
            sizes.append(len(queries))
        return dispatch(queries, *args, **kwargs)

    batched._dispatch = recorded
    runs = {"unbatched": [], "batched": []}
    for r in range(THREAD_ROUNDS + 1):  # round 0 warms each bucket shape up
        queries = [f"{q}, take {r}" for q in THREAD_QUERIES]
        order = (("unbatched", searcher), ("batched", batched))
        for mode, s in (order if r % 2 == 0 else order[::-1]):
            sizes.clear()
            out, p50_t, qps = thread_round(s, queries)
            runs[mode].append({"out": out, "p50_ms": p50_t, "qps": qps, "dispatches": list(sizes)})
    bad_batched, bad_control = 0, 0
    for plain, batch in zip(runs["unbatched"], runs["batched"]):
        check(len(batch["dispatches"]) < N_THREADS and set(batch["dispatches"]) <= set(BUCKETS)
              and sum(batch["dispatches"]) >= N_THREADS,
              f"{what}: batched dispatches {batch['dispatches']}")
        for i in range(N_THREADS):
            bad_batched += band_violations(batch["out"][i], plain["out"][i], one_noise)
            # the negative control: a flush that hands each query the next one's row
            bad_control += band_violations(batch["out"][(i + 1) % N_THREADS], plain["out"][i], one_noise)
    check(bad_batched == 0, f"{what}: batched rows beyond {one_noise} of the unbatched: {bad_batched}")
    check(bad_control > 0, f"{what}: the check passes rows handed to the wrong query")
    measured = {m: v[1:] for m, v in runs.items()}
    summary = {m: {"p50_ms": statistics.median(x["p50_ms"] for x in v),
                   "qps": statistics.median(x["qps"] for x in v)} for m, v in measured.items()}
    log(f"{what}: {N_THREADS} threads of single queries, {THREAD_ROUNDS} rounds each after a warm-up: "
        f"unbatched p50 {summary['unbatched']['p50_ms']:.3f} ms, {summary['unbatched']['qps']:.1f} queries/s; "
        f"window {BATCH_WINDOW_MS} ms p50 {summary['batched']['p50_ms']:.3f} ms, "
        f"{summary['batched']['qps']:.1f} queries/s, dispatch sizes "
        f"{[x['dispatches'] for x in runs['batched']]} (round 0 the warm-up); batched rows within {one_noise} "
        f"of the unbatched; the same check on rows handed to the next query: {bad_control} violations")

    # ImageSearcher: indexed frames as queries find themselves
    picks = np.linspace(0, N_FRAMES - 1, N_IMAGE_QUERIES).astype(int)
    image = ctx.image_searcher
    for fn in counted:
        fn.launches = 0
    scores, rows = image.search(frames[picks], 1)
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"{what}: ImageSearcher, {N_IMAGE_QUERIES} indexed frames as queries: top-1 rows {rows[:, 0].tolist()} "
        f"for frames {picks.tolist()}, scores {[round(float(x), 5) for x in scores[:, 0]]}; launches "
        f"{launches} (expected {engine.cfg.vision.layers} each: one dispatch through every vision block)")
    check(rows[:, 0].tolist() == picks.tolist(), f"{what}: an indexed frame's top-1 is another row")
    check(all(n == engine.cfg.vision.layers for n in launches.values()), f"{what}: image launches {launches}")
    log(f"{what}: the searcher phase took {time.perf_counter() - t0:.1f} s")
    return {"p50_one_call_ms": p50["one_call"], "p50_two_step_ms": p50["two_step"],
            "threads": summary, "dispatches": [x["dispatches"] for x in measured["batched"]]}


def phase_checkpoint(torch, frames, path: pathlib.Path) -> dict:
    """A ViT-B/32 reference checkpoint at full width: seeded params (seed
    CKPT_SEED) and a seeded classifier head written by the port's
    ``save_reference_checkpoint``, loaded by ``EmbeddingEngine.from_checkpoint``
    with bf16 and with int8 weights; the N_FRAMES frames' embeddings bit-equal
    to an engine built from the same params in memory, the route's kernel
    launches counted, ``classify`` on the card against the plain head on the
    CPU. Writes the file at ``path`` (``phase_index_tool`` queries with it)."""
    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.models import get_model_config, init_clip_params, params_from_numpy
    from evr_tpu_torch.models.classifier import (
        ClassifierConfig, classifier_forward, init_classifier_params,
    )
    from evr_tpu_torch.models.torch_export import save_reference_checkpoint
    from evr_tpu_torch.ops import block_fused as bf

    cfg = get_model_config(MODEL)
    params = init_clip_params(CKPT_SEED, cfg)
    head = init_classifier_params(CKPT_SEED + 1, ClassifierConfig(embed_dim=cfg.embed_dim))
    t0 = time.perf_counter()
    save_reference_checkpoint(path, params, head, epoch=1)
    out = {"write_s": time.perf_counter() - t0, "bytes": path.stat().st_size}
    for params_dtype, kernels in (("bfloat16", (bf.fused_attn_block, bf.fused_mlp_block)),
                                  ("int8", (bf.fused_attn_block_q, bf.fused_mlp_block_q))):
        t0 = time.perf_counter()
        engine = EmbeddingEngine.from_checkpoint(path, MODEL, device="cuda", batch_size=BATCH,
                                                 params_dtype=params_dtype)
        total_s = time.perf_counter() - t0
        check(engine.active_model == "finetuned", f"from_checkpoint left {engine.active_model!r} active")
        t0 = time.perf_counter()
        engine.load_finetuned(path, "reload")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del engine.models["reload"]
        engine.encode_staged_images(frames[:BATCH])  # first call: kernel libraries load
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        emb = engine.encode_staged_images(frames)
        launches = {fn.__name__: fn.launches for fn in kernels}
        expected = (cfg.vision.layers - 1) * -(-N_FRAMES // BATCH)
        in_memory = EmbeddingEngine(MODEL, params=params, device="cuda", batch_size=BATCH,
                                    params_dtype=params_dtype)
        ref = in_memory.encode_staged_images(frames)
        unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        probs = engine.classify(unit)
        with torch.inference_mode():
            plain = torch.softmax(classifier_forward(
                params_from_numpy(head), ClassifierConfig(embed_dim=cfg.embed_dim),
                torch.from_numpy(unit)), dim=-1).numpy()
        err = float(np.abs(probs - plain).max())
        log(f"checkpoint {MODEL} ({out['bytes'] / 1e6:.1f} MB, written in {out['write_s']:.2f} s), "
            f"{params_dtype} weights: from_checkpoint {total_s:.2f} s (with the random 'original' it also "
            f"draws), the file to the card in the serving format {load_s:.2f} s; "
            f"{N_FRAMES} frames bit-equal to the in-memory engine: {np.array_equal(emb, ref)}; launches "
            f"{launches} (expected {expected} each); classify on the card vs the plain head on the CPU: "
            f"max abs err {err:.2e}, classes {np.bincount(probs.argmax(1), minlength=3).tolist()}")
        check(np.array_equal(emb, ref), f"checkpoint {params_dtype}: embeddings differ from the in-memory engine's")
        check(all(n == expected for n in launches.values()), f"checkpoint {params_dtype}: launches {launches}")
        check(probs.shape == (N_FRAMES, 3) and err <= CLASSIFY_TOL, f"classify: max abs err {err}")
        out[params_dtype] = {"from_checkpoint_s": total_s, "load_s": load_s, "classify_err": err}
        del engine, in_memory
    torch.cuda.empty_cache()
    return out


# -- 14. every route ---------------------------------------------------------

# seeded metadata written over the main paths' roots: OCR text (some with
# Vietnamese accents), objects, tags, captions and a transcript per video
ROUTE_OCR = ("LỐI THOÁT", "lối thoát hiểm", "Đường phố", "EXIT", "cấm vào", "bệnh viện", "xe máy")
ROUTE_OBJECTS = ("person", "car", "dog", "knife", "motorbike")
ROUTE_TAGS = ("night", "đám đông", "street")
ROUTE_CAPTIONS = ("a red car on a street", "người đàn ông đang chạy", "a crowd at night")
ROUTE_SPEECH = ("hãy chạy ra lối thoát", "the car is on fire", "đi đường này", "xin chào các bạn")
ROUTE_SEED = 15
# a top_k whose top_k×3 CLIP candidates cover every frame: the metadata filter
# alone decides which frames a text_* strategy returns, so the kernel path's
# set must equal the plain path's exactly
ROUTE_TOP_ALL = N_FRAMES // 3 + 1
# uncached /api/search requests per method for its p50, the methods in turns
# after one round of warm-up; each p50 held under PERF.md §2's limit
ROUTE_P50_RUNS, ROUTE_P50_LIMIT_MS = 15, 50.0  # runs cut from 50 (then 25) for the script's time
# the near-miss control: the kernel path's text vector turned to this row
# cosine with its own
NEAR_COS = 0.999
VI_QUERY, VI_PROCESSED = "đánh nhau trên đường", "fighting on the road"
ROUTE_IMAGE_PICKS = (5, 300, 777)
# viz.umap at the route's max_points cap, on the sparse tier: seeded unit rows
# around UMAP_CENTRES centres, UMAP_NOISE a dimension (about 100 rows a cluster)
UMAP_ROWS, UMAP_DIM, UMAP_CENTRES, UMAP_NOISE, UMAP_SEED, UMAP_K = 20_000, 512, 200, 0.02, 23, 10


def write_route_metadata(root: pathlib.Path) -> dict:
    """Overwrite each video's metadata JSON under ``root`` with seeded
    detections, tags and captions (frame ids and file paths kept) and write
    its transcript sidecar. Returns {video: records}."""
    import numpy as np

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import VideoRegistry

    cfg = DataRootConfig(root)
    registry = VideoRegistry(cfg.mapping_path)
    rng = np.random.default_rng(ROUTE_SEED)
    out = {}
    for name in registry.names():
        meta = pathlib.Path(registry.get(name)["metadata_file"])
        meta = meta if meta.is_absolute() else cfg.root / meta
        records = json.loads(meta.read_text(encoding="utf-8"))

        def dets(pool, p):
            if rng.random() >= p:
                return []
            return [{"label": str(rng.choice(pool)), "confidence": float(np.round(rng.uniform(0.3, 1), 3)),
                     "bounding_box": [0, 0, 1, 1]}]

        for rec in records:
            rec["text_detections"] = {"detections": dets(ROUTE_OCR, 0.3)}
            rec["object_detections"] = {"detections": dets(ROUTE_OBJECTS, 0.3)}
            rec["tags"] = [str(rng.choice(ROUTE_TAGS))] if rng.random() < 0.2 else []
            rec["metadata"] = {"caption": str(rng.choice(ROUTE_CAPTIONS))} if rng.random() < 0.2 else {}
        meta.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
        seconds = len(records) / 25.0  # write_video's rate
        starts = np.arange(0.0, seconds, 1.5)
        segments = [{"start": float(s), "end": float(s + 1.2), "text": str(rng.choice(ROUTE_SPEECH))}
                    for s in starts]
        (meta.parent / f"{name}_transcript.json").write_text(
            json.dumps({"segments": segments}, ensure_ascii=False), encoding="utf-8")
        out[name] = records
    return out


def route_post(client, body) -> list:
    resp = client.post("/api/search", json=body)
    check(resp.status_code == 200, f"/api/search {body}: HTTP {resp.status_code} {resp.get_data()[:200]!r}")
    events = json.loads(resp.get_data(as_text=True))["events"]
    check(all(math.isfinite(e.get("clip_similarity", 0.0)) for e in events), f"{body}: non-finite score")
    return events


def _event_id(e):
    return (e.get("videoId"), e.get("id"))


def cut_violations(got, ref, key: str, noise: float) -> int:
    """Two paths' events of one ranked request: a frame both return must
    score within ``noise`` in both; a frame only one returns must score
    within ``noise`` of the reference's last (cut) score."""
    if not ref:
        return len(got)
    g, r = {_event_id(e): e[key] for e in got}, {_event_id(e): e[key] for e in ref}
    cut = min(r.values())
    bad = sum(abs(g[i] - r[i]) > noise for i in g.keys() & r.keys())
    bad += sum(abs(s - cut) > noise for side in (g, r) for i, s in side.items() if i not in g.keys() & r.keys())
    return bad + abs(len(got) - len(ref))


def set_violations(got, ref, key: str, noise: float) -> int:
    """Events decided by metadata over every frame: the same frames, each
    one's score within ``noise`` in both paths."""
    g, r = {_event_id(e): e[key] for e in got}, {_event_id(e): e[key] for e in ref}
    return len(g.keys() ^ r.keys()) + sum(abs(g[i] - r[i]) > noise for i in g.keys() & r.keys())


def chain_violations(got, ref, noise: float) -> int:
    """Temporal chains: rank by rank the same video; the same frames with
    each step's score within ``noise``, or, where a near tie changed the
    chain, totals within ``noise`` a step."""
    bad = abs(len(got) - len(ref))
    for g, r in zip(got, ref):
        steps = len(r["chain"])
        if [_event_id(e) for e in g["chain"]] == [_event_id(e) for e in r["chain"]]:
            bad += sum(abs(a["clip_similarity"] - b["clip_similarity"]) > noise
                       for a, b in zip(g["chain"], r["chain"]))
        else:
            bad += int(abs(g["total_score"] - r["total_score"]) > noise * steps)
    return bad


def png_b64(frame) -> str:
    import base64

    import cv2
    import numpy as np

    ok, data = cv2.imencode(".png", np.ascontiguousarray(frame[:, :, ::-1]))
    check(ok, "png encode")
    return base64.b64encode(data.tobytes()).decode()


def knn_overlap(torch, x, y, k: int = UMAP_K, device: str = "cuda") -> float:
    """Mean share of each row's k nearest rows (cosine in ``x``) kept among
    its k nearest in the layout ``y`` (euclidean), on the card by chunked
    GEMMs, no sklearn."""
    def neighbours(t, cosine: bool):
        t = t.float()
        if cosine:
            t = t / t.norm(dim=1, keepdim=True)
        sq = (t * t).sum(1)
        out = []
        for lo in range(0, len(t), 4096):
            q = t[lo:lo + 4096]
            d = -(q @ t.T) if cosine else sq[lo:lo + 4096, None] + sq[None, :] - 2 * (q @ t.T)
            d[torch.arange(len(q), device=t.device), torch.arange(lo, lo + len(q), device=t.device)] = float("inf")
            out.append(torch.topk(d, k, dim=1, largest=False).indices)
        return torch.cat(out)

    a = neighbours(torch.as_tensor(x, device=device), True)
    b = neighbours(torch.as_tensor(y, device=device), False)
    return float((a[:, :, None] == b[:, None, :]).any(2).float().mean())


def phase_routes(torch, engine, root: pathlib.Path, frames, what: str, noise: float, counted,
                 big_umap: bool = False, **ctx_kwargs) -> dict:
    """Every route of the port's app over a main path's data root, on the
    card: seeded metadata and transcripts written (``write_route_metadata``),
    ``ServingContext`` booted with the same index settings (``ctx_kwargs``)
    and the app driven through ``werkzeug.test.Client``. /api/search: every
    method of ``SEARCH_METHODS`` plus temporal, a Vietnamese query through the
    default ``VietnamesePreprocessor``, a negative query, image queries (PNG
    base64 of indexed frames: each its own top-1) and a hybrid query; each
    CLIP-backed request held to the same request through a twin engine on the
    plain route (``attn_impl="plain"``, the same params; its index searched by
    ``cosine_topk``): ranked events within ``noise`` of the plain path's cut,
    metadata-decided events the same frames, metadata-only events equal, each
    check also run on a negative control that it must reject (for the ranked
    and the set check also a near miss, the text vector turned to a row
    cosine of NEAR_COS). Each method's p50 over ROUTE_P50_RUNS requests in
    turns, every cache emptied before each, under ROUTE_P50_LIMIT_MS; the
    hybrid request's stages beside it. The kernels of
    ``counted`` are counted over the kernel path's requests and held to the
    count the dispatches imply. The other routes: UI, SPA dist, events,
    frame and video files (Range, traversal), available videos, models and the
    active model, stats, transcribe (501, then a ``CallableTranscriber``),
    upload without a file (400), an unknown job's status (404). UMAP: the route over every frame twice (the second from
    the cache), then again after the cache is emptied (the same bytes);
    ``big_umap``: ``viz.umap`` on UMAP_ROWS seeded clustered rows (sparse
    tier), its kNN preservation against PCA's and a random layout's."""
    import copy
    import dataclasses

    import numpy as np
    from werkzeug.test import Client

    import evr_tpu_torch.viz as viz
    from evr_tpu_torch.query import SEARCH_METHODS
    from evr_tpu_torch.serving import ServingContext, create_app
    from evr_tpu_torch.serving.providers import CallableTranscriber

    t0 = time.perf_counter()
    write_route_metadata(root)
    dist = root / "dist"
    dist.mkdir(exist_ok=True)
    (dist / "index.html").write_text("<html>spa</html>")
    (dist / "app.js").write_text("console.log('spa')")
    kc_ctx = ServingContext(root, engine=engine, **ctx_kwargs)
    check(len(kc_ctx.boot()) == N_VIDEOS, f"{what} routes: boot")
    check(all(kc_ctx.metadata.has_transcript(v) for v in kc_ctx.video_names()), f"{what}: transcripts")
    kc = Client(create_app(kc_ctx, frontend_dist=str(dist)))
    plain = copy.copy(engine)
    plain.cfg = dataclasses.replace(engine.cfg, attn_impl="plain")
    plain._text_cache = {}
    pc_ctx = ServingContext(root, engine=plain, **{**ctx_kwargs, "search_impl": "xla"})
    pc_ctx.boot()
    pc = Client(create_app(pc_ctx))
    qe = kc_ctx.query_engine
    check(qe.preprocess(VI_QUERY) == VI_PROCESSED, f"{what}: preprocessor gave {qe.preprocess(VI_QUERY)!r}")

    text = {"search_type": "text", "adaptive_threshold": -1.0, "text_confidence": 0.0,
            "object_confidence": 0.0}
    ranked = [  # (name, body, key): held within the noise band at the cut
        ("text_clip", {**text, "search_method": "text_clip", "query": QUERIES[0], "top_k": 10}, "clip_similarity"),
        ("text_adaptive", {**text, "search_method": "text_adaptive", "query": QUERIES[1], "top_k": 10},
         "clip_similarity"),
        ("vietnamese", {**text, "search_method": "text_clip", "query": VI_QUERY, "top_k": 10}, "clip_similarity"),
        ("negative", {**text, "search_method": "text_clip", "query": QUERIES[3], "negative_query": QUERIES[4],
                      "top_k": 10}, "clip_similarity"),
        ("video", {**text, "search_method": "video", "query": QUERIES[2], "top_k": N_VIDEOS}, "video_score"),
        ("hybrid", {"search_type": "hybrid", "image_url": png_b64(frames[ROUTE_IMAGE_PICKS[0]]), "query": "a red car",
                    "image_weight": 0.5, "top_k": 10, "adaptive_threshold": -1.0}, "clip_similarity"),
    ]
    filtered = [  # every frame a candidate: the metadata filter decides
        ("text_keyword", {**text, "search_method": "text_keyword", "query": "an exit", "keyword": "loi thoat"}),
        ("text_object", {**text, "search_method": "text_object", "query": "a person", "object": "person"}),
        ("text_object_keyword", {**text, "search_method": "text_object_keyword", "query": "street",
                                 "keyword": "đường", "object": "car"}),
        ("text_speech", {**text, "search_method": "text_speech", "query": "fire", "keyword": "fire"}),
    ]
    filtered = [(n, {**b, "top_k": ROUTE_TOP_ALL}) for n, b in filtered]
    metadata_only = [
        ("keyword_only", {**text, "search_method": "keyword_only", "query": "LOI THOAT", "top_k": 50}),
        ("object_only", {**text, "search_method": "object_only", "query": "dam dong", "top_k": 50,
                         "object_confidence": 0.5}),
        ("speech_only", {**text, "search_method": "speech_only", "query": "chay", "top_k": 50}),
    ]
    temporal = [
        ("temporal", {**text, "search_method": "temporal", "queries": list(QUERIES[:3]), "top_k": 3}),
        ("temporal_gap", {**text, "search_method": "temporal", "queries": list(QUERIES[3:5]), "max_gap": 8,
                          "top_k": 2}),
    ]
    images = [(f"image_{i}", {"search_type": "image", "image_url": png_b64(frames[i]), "top_k": 5,
                              "adaptive_threshold": -1.0}) for i in ROUTE_IMAGE_PICKS]
    methods = {b.get("search_method") for _, b, *_ in ranked + filtered + metadata_only + temporal}
    check(methods >= set(SEARCH_METHODS) | {"temporal"}, f"{what}: methods not driven: "
          f"{set(SEARCH_METHODS) - methods}")

    # the kernel path: every request once, its launches counted against the
    # dispatches they imply
    calls = {"text_dispatch": 0, "encode_texts": 0, "encode_images": 0, "image_dispatch": 0}

    def tally(obj, attr, key, per_call=lambda *a, **k: 1):
        real = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            calls[key] += per_call(*args, **kwargs)
            return real(*args, **kwargs)

        setattr(obj, attr, wrapped)

    tally(engine, "encode_texts", "encode_texts")
    tally(engine, "encode_staged_images", "encode_images", lambda x, *a, **k: -(-len(x) // engine.batch_size))
    tally(qe._searcher, "_dispatch", "text_dispatch")
    tally(kc_ctx.image_searcher, "_run_fused", "image_dispatch")
    engine.clear_text_cache()
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    got = {}
    for name, body, *_ in ranked + filtered + metadata_only + temporal + images:
        got[name] = route_post(kc, body)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    for attr in ("encode_texts", "encode_staged_images"):
        delattr(engine, attr)  # the class's methods again
    layers_t, layers_v = engine.cfg.text.layers, engine.cfg.vision.layers
    expected = (layers_t * calls["text_dispatch"] + (layers_t - 1) * calls["encode_texts"]
                + (layers_v - 1) * calls["encode_images"] + layers_v * calls["image_dispatch"])
    n_k4 = 2 if "pallas" == ctx_kwargs.get("search_impl") else 0  # the negative and the hybrid request
    log(f"{what} routes: launches {launches} over {len(got)} requests (expected {expected} of each block "
        f"kernel: {calls}; K4 {n_k4})")
    for fn in counted:
        want = n_k4 if fn.__name__ == "fused_topk" else expected
        check(fn.launches == want and (want > 0 or fn.__name__ == "fused_topk"),
              f"{what} routes: {fn.__name__} {fn.launches} launches, expected {want}")

    # the plain path: the same requests
    ref = {name: route_post(pc, body) for name, body, *_ in ranked + filtered + metadata_only + temporal + images}
    bad = {}
    for name, _, key in ranked:
        bad[name] = cut_violations(got[name], ref[name], key, noise)
    for name, _ in filtered:
        bad[name] = set_violations(got[name], ref[name], "clip_similarity", noise)
    for name, _ in metadata_only:
        bad[name] = int(got[name] != ref[name])
    for name, _ in temporal:
        bad[name] = chain_violations(got[name], ref[name], noise)
    per = N_FRAMES // N_VIDEOS

    def own_top1(name, i) -> int:  # 0 when the request's top-1 is frame i
        return int(_event_id(got[name][0]) != (f"video-video{i // per}", f"event-{i % per}"))

    for (name, _), i in zip(images, ROUTE_IMAGE_PICKS):
        bad[name] = cut_violations(got[name], ref[name], "clip_similarity", noise) + own_top1(name, i)
    sizes = {n: len(e) for n, e in got.items()}
    moved = {n: len({_event_id(e) for e in got[n]} ^ {_event_id(e) for e in ref[n]}) // 2
             for n, *_ in ranked + filtered}
    log(f"{what} routes: kernel path against the plain path (band {noise}): violations {bad}; events {sizes}; "
        f"frames in one path's events only, each within the band of the cut: {moved}")
    check(not any(bad.values()), f"{what} routes: {bad}")
    check(all(sizes[n] > 0 for n in sizes), f"{what} routes: empty results {sizes}")

    # negative controls: each check rejects what it must
    controls = {
        "ranked": cut_violations(got["text_clip"], ref["text_adaptive"], "clip_similarity", noise),
        "filtered": set_violations(got["text_keyword"][1:], ref["text_keyword"], "clip_similarity", noise),
        "temporal": chain_violations(got["temporal"], ref["temporal_gap"][:1] * len(got["temporal"]), noise),
        "image": sum(own_top1(name, i) for (name, _), i in
                     zip(images, ROUTE_IMAGE_PICKS[1:] + ROUTE_IMAGE_PICKS[:1])),
    }
    hit = ref["keyword_only"][0]  # the frame of the first keyword event, its folded label flipped
    frame = kc_ctx.metadata.frame_by_idx(hit["videoId"][len("video-"):], int(hit["id"][len("event-"):]))
    saved = list(frame.text_labels)
    frame.text_labels[:] = [(low, "flipped", conf) for low, _, conf in saved]  # a flipped folded label
    kc_ctx.search_cache.invalidate()
    try:
        controls["metadata"] = int(route_post(kc, metadata_only[0][1]) != ref["keyword_only"])
    finally:
        frame.text_labels[:] = saved
        kc_ctx.search_cache.invalidate()

    # near misses: the kernel path's text vector turned to a row cosine of
    # NEAR_COS with its own, toward the frame at the plain path's cut (where
    # the turn moves a score most), must fail the ranked and the set check;
    # turned toward a seeded random direction, what the bands see is logged
    def frame_row(event):  # the unit index row of an event's frame
        video, idx = event["videoId"][len("video-"):], event["id"][len("event-"):]
        names = [n.rsplit(".", 1)[0] for n in kc_ctx.index.frame_names(video)]
        return kc_ctx.index.get_embeddings(video)[names.index(idx)]

    def turned(body, u):
        searcher_engine = qe._searcher.engine
        real = searcher_engine.text_tower

        def encode(*args, **kwargs):
            t = real(*args, **kwargs)
            t32 = t.float()
            norm = t32.norm(dim=-1, keepdim=True)
            t_hat = t32 / norm
            v = torch.as_tensor(u, dtype=torch.float32, device=t.device)[None]
            v = v - (t_hat * v).sum(-1, keepdim=True) * t_hat
            v = v / v.norm(dim=-1, keepdim=True)
            return ((NEAR_COS * t_hat + math.sqrt(1 - NEAR_COS ** 2) * v) * norm).to(t.dtype)

        searcher_engine.text_tower = encode  # the TextSearcher's text encode
        kc_ctx.search_cache.invalidate()
        qe._searcher.invalidate()
        try:
            return route_post(kc, body)
        finally:
            del searcher_engine.text_tower
            kc_ctx.search_cache.invalidate()
            qe._searcher.invalidate()

    body_of = dict((n, b) for n, b, *_ in ranked + filtered)
    controls["ranked_near"] = cut_violations(
        turned(body_of["text_clip"], frame_row(ref["text_clip"][-1])), ref["text_clip"], "clip_similarity", noise)
    controls["filtered_near"] = set_violations(
        turned(body_of["text_keyword"], frame_row(ref["text_keyword"][-1])), ref["text_keyword"],
        "clip_similarity", noise)
    u = np.random.default_rng(ROUTE_SEED).standard_normal(engine.cfg.embed_dim).astype(np.float32)
    seen = {"ranked": cut_violations(turned(body_of["text_clip"], u), ref["text_clip"], "clip_similarity", noise),
            "filtered": set_violations(turned(body_of["text_keyword"], u), ref["text_keyword"],
                                       "clip_similarity", noise)}
    log(f"{what} routes: negative controls (each must be nonzero): {controls}; the text vector turned to cosine "
        f"{NEAR_COS} toward a random direction: violations {seen} (not held)")
    check(all(v != 0 for v in controls.values()), f"{what}: a check passed its negative control: {controls}")

    # /api/search p50 per method over the same request each round, the
    # methods in turns, every cache emptied before each request (results,
    # the searcher's, the text features: each text query encodes again); the
    # hybrid request's stages timed beside it (each one ends on the host)
    timed = ranked + filtered + metadata_only + temporal + images[:1]
    ms = {name: [] for name, *_ in timed}
    split, current = {}, [None]

    def stage_timer(obj, attr, key):
        real = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                if current[0] == "hybrid":
                    split.setdefault(key, []).append((time.perf_counter() - t1) * 1e3)

        setattr(obj, attr, wrapped)
        return obj, attr

    index = kc_ctx.index
    patched = [stage_timer(kc_ctx, "load_image_source", "decode"), stage_timer(kc_ctx, "_stage", "stage"),
               stage_timer(engine, "encode_staged_images", "image encode"),
               stage_timer(engine, "get_text_features", "text encode"),
               stage_timer(index, "search_raw", "search"), stage_timer(kc_ctx, "_events_from_rows", "events")]
    try:
        for i in range(ROUTE_P50_RUNS + 1):  # round 0 warms up
            for name, body, *_ in timed:
                kc_ctx.search_cache.invalidate()
                qe._searcher.invalidate()
                engine.clear_text_cache()
                current[0] = name if i else None
                t1 = time.perf_counter()
                route_post(kc, body)
                if i:
                    ms[name].append((time.perf_counter() - t1) * 1e3)
    finally:
        current[0] = None
        for obj, attr in patched:
            delattr(obj, attr)
    p50 = {name: statistics.median(v) for name, v in ms.items()}
    hybrid_split = {key: statistics.median(v) for key, v in split.items()}
    hybrid_split["rest (app, JSON)"] = p50["hybrid"] - sum(hybrid_split.values())
    log(f"{what} routes: /api/search p50 ms, {ROUTE_P50_RUNS} uncached each, in turns: "
        + ", ".join(f"{n} {v:.2f}" for n, v in p50.items()))
    log(f"{what} routes: the hybrid request's stages, p50 ms each: "
        + ", ".join(f"{n} {v:.2f}" for n, v in hybrid_split.items()))
    check(max(p50.values()) < ROUTE_P50_LIMIT_MS, f"{what} routes: p50 over {ROUTE_P50_LIMIT_MS} ms: {p50}")

    # the other routes
    # a frame by name resolves in the first video that has it
    frame_file = kc_ctx.resolve_path(kc_ctx.registry.get("video0")["frames_dir"]) / "7.jpg"
    video_file = kc_ctx.resolve_path(kc_ctx.registry.get("video2")["video_path"])
    resp = {
        "/": kc.get("/"), "/app/": kc.get("/app/"), "/app/app.js": kc.get("/app/app.js"),
        "events": kc.get("/api/video/video-1/events"),
        "frame": kc.get(f"/api/frame/{frame_file.name}"),
        "frame_range": kc.get(f"/api/frame/{frame_file.name}", headers={"Range": "bytes=10-109"}),
        "video_range": kc.get(f"/api/video/{video_file.name}", headers={"Range": "bytes=0-63"}),
        "traversal": kc.get("/api/frame/..%2F..%2F..%2F..%2Fetc%2Fpasswd"),
        "available": kc.get("/api/videos/available"), "models": kc.get("/api/models"),
        "active": kc.get("/api/models/active"),
        "set_active": kc.post("/api/models/active", json={"model": "original"}),
        "set_unknown": kc.post("/api/models/active", json={"model": "nope"}),
        "stats": kc.get("/api/stats"),
        "upload": kc.post("/api/upload-video"), "upload_status": kc.get("/api/upload-status/j1"),
    }
    import io

    def voice():
        return {"audio": (io.BytesIO(b"RIFF0000WAVE"), "voice.wav"), "language": "vi"}

    resp["transcribe_off"] = kc.post("/api/transcribe-voice", data=voice())
    kc_ctx.transcriber = CallableTranscriber(lambda path, lang: f"heard {lang}")
    resp["transcribe"] = kc.post("/api/transcribe-voice", data=voice())
    kc_ctx.transcriber = None
    body = {n: r.get_data() for n, r in resp.items()}
    js = {n: json.loads(b) for n, b in body.items()
          if resp[n].mimetype == "application/json"}
    route_checks = {
        "/": resp["/"].status_code == 200 and b"<title>" in body["/"],
        "/app/": body["/app/"] == b"<html>spa</html>" and body["/app/app.js"] == b"console.log('spa')",
        "events": resp["events"].status_code == 200 and len(js["events"]) == min(20, N_FRAMES // N_VIDEOS),
        "frame": body["frame"] == frame_file.read_bytes(),
        "frame_range": resp["frame_range"].status_code == 206
        and body["frame_range"] == frame_file.read_bytes()[10:110],
        "video_range": resp["video_range"].status_code == 206
        and body["video_range"] == video_file.read_bytes()[:64],
        "traversal": resp["traversal"].status_code == 404,
        "available": js["available"]["count"] == N_VIDEOS,
        "models": [m["id"] for m in js["models"]] == engine.available_models(),
        "active": js["active"]["active_model"] == engine.active_model,
        "set_active": js["set_active"].get("success") is True and resp["set_unknown"].status_code == 400,
        "stats": js["stats"]["index"]["frames"] == N_FRAMES and "search/text_clip" in js["stats"]["timings"],
        "upload": resp["upload"].status_code == 400 and js["upload"]["error"] == "No video uploaded"
        and resp["upload_status"].status_code == 404,
        "transcribe": resp["transcribe_off"].status_code == 501 and js["transcribe"]["text"] == "heard vi",
    }
    log(f"{what} routes: other routes {route_checks}")
    check(all(route_checks.values()), f"{what}: routes failed {[n for n, ok in route_checks.items() if not ok]}")

    # the UMAP route over every frame: twice (the second from the cache), then
    # again after the cache is emptied (the same layout on the card)
    real, builds = viz.generate_visualization, []
    viz.generate_visualization = lambda *a, **k: builds.append(1) or real(*a, **k)
    umap_body = {"video_names": None, "n_neighbors": 15, "min_dist": 0.1, "metric": "cosine"}
    try:
        umap_s = []
        for i in range(3):
            if i == 2:
                kc_ctx.viz_cache.invalidate()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = kc.post("/api/visualization/umap", json=umap_body)
            umap_s.append(time.perf_counter() - t1)
            check(r.status_code == 200, f"umap route: HTTP {r.status_code}")
            if i == 0:
                layout = r.get_data()
            else:
                check(r.get_data() == layout, f"umap route call {i + 1}: another layout")
    finally:
        viz.generate_visualization = real
    payload = json.loads(layout)
    coords = np.asarray(payload["coordinates"])
    check(coords.shape == (N_FRAMES, 2) and bool(np.isfinite(coords).all())
          and payload["dimensionality_reduction"]["method"] == "umap", f"umap route: {coords.shape}")
    check(len(builds) == 2, f"umap route: {len(builds)} builds over 3 calls (the second from the cache)")
    log(f"{what} routes: UMAP route over {N_FRAMES} frames (dense tier): {umap_s[0]:.3f} s, cached "
        f"{umap_s[1] * 1e3:.2f} ms, rebuilt after the cache emptied {umap_s[2]:.3f} s, bit-equal layout")
    out = {"launches": launches, "expected": expected, "p50_ms": p50, "hybrid_split_ms": hybrid_split,
           "umap_route_s": umap_s[0], "umap_cached_ms": umap_s[1] * 1e3, "umap_rebuilt_s": umap_s[2]}

    if big_umap:
        from evr_tpu_torch.viz.projection import pca
        from evr_tpu_torch.viz.umap import umap

        gen = torch.Generator(device="cuda").manual_seed(UMAP_SEED)
        cents = torch.randn((UMAP_CENTRES, UMAP_DIM), generator=gen, device="cuda")
        x = cents[torch.randint(0, UMAP_CENTRES, (UMAP_ROWS,), generator=gen, device="cuda")] / math.sqrt(UMAP_DIM)
        x = x + UMAP_NOISE * torch.randn((UMAP_ROWS, UMAP_DIM), generator=gen, device="cuda")
        x = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y = umap(x, device="cuda")
        big_s = time.perf_counter() - t1
        check(y.shape == (UMAP_ROWS, 2) and bool(np.isfinite(y).all()), f"umap {UMAP_ROWS}: {y.shape}")
        rand = np.random.default_rng(UMAP_SEED).normal(size=(UMAP_ROWS, 2)).astype(np.float32)
        kept = {"umap": knn_overlap(torch, x, y), "pca": knn_overlap(torch, x, pca(x)),
                "random": knn_overlap(torch, x, rand)}
        log(f"viz.umap on {UMAP_ROWS} x {UMAP_DIM} clustered rows (sparse tier, 200 epochs): {big_s:.2f} s; "
            f"share of {UMAP_K} nearest neighbours kept: {json.dumps({k: round(v, 4) for k, v in kept.items()})}")
        check(kept["umap"] > kept["pca"], f"umap keeps fewer neighbours than PCA: {kept}")
        check(kept["random"] < kept["pca"], f"the neighbour check passes a random layout: {kept}")
        out.update(umap_big_s=big_s, knn_kept=kept)
    log(f"{what} routes: the phase took {time.perf_counter() - t0:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    return out


# -- main --------------------------------------------------------------------


# -- 15. ingest and the upload routes -----------------------------------------

# Seeded 1280 x 720, 25 fps videos written with cv2 (mp4v): each scene a
# random 16 x 9 colour grid with a white square moving across it, a hard cut
# every INGEST_SCENE_LEN frames. The long one (two minutes) is uploaded with
# bf16 weights (async, its stages polled); three short ones: a sync bf16
# upload, an async int8 one, and bytes that are no video (the job must end in
# "error").
INGEST_SIZE, INGEST_FPS, INGEST_SCENE_LEN = (1280, 720), 25.0, (24, 49)
INGEST_LONG_FRAMES, INGEST_SHORT_FRAMES = 1500, 600  # the long one cut from 3,000 for the script's time
INGEST_SEED = 16
# embed_folder over INGEST_FOLDER_FRAMES saved 1280 x 720 JPEGs (and one that
# does not decode) on the native pipelined path at batch BATCH, against the
# stager alone and encode_staged_images alone on the same frames
INGEST_FOLDER_FRAMES = 1024  # cut from 4,096 (then 2,048) for the script's time
# cv2's decode of the saved frames against PIL's (two libjpeg-turbo builds) on
# INGEST_DECODE_SAMPLE of them: within INGEST_DECODE_LEVELS grey levels
INGEST_DECODE_SAMPLE, INGEST_DECODE_LEVELS = 16, 2
INGEST_POLL_S, INGEST_WAIT_S = 0.02, 600.0
INGEST_STAGES = ("queued", "scene_detect", "embedding", "annotating", "registering", "done")


def write_scene_video(path: pathlib.Path, n_frames: int, seed: int) -> list[int]:
    """An INGEST_SIZE mp4v video at INGEST_FPS: a new random colour grid every
    INGEST_SCENE_LEN frames, a white 64 x 64 square moving 8 pixels a frame.
    Returns the cut frames."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    w, h = INGEST_SIZE
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), INGEST_FPS, (w, h))
    cuts, left, base = [], 0, None
    for i in range(n_frames):
        if left == 0:
            if i:
                cuts.append(i)
            grid = rng.integers(0, 256, (9, 16, 3), dtype=np.uint8)
            base = cv2.resize(grid, (w, h), interpolation=cv2.INTER_NEAREST)
            left = int(rng.integers(*INGEST_SCENE_LEN))
        frame = base.copy()
        x = (i * 8) % (w - 64)
        frame[h // 2 - 32:h // 2 + 32, x:x + 64] = 255
        writer.write(frame)
        left -= 1
    writer.release()
    return cuts


def encode_batches(n: int, chunk: int) -> int:
    """Encode batches of the pipelined embed_folder over n staged frames:
    chunks of ``chunk`` frames, each padded to whole batches of BATCH."""
    return sum(-(-min(chunk, n - s) // BATCH) for s in range(0, n, chunk))


def poll_upload(client, job_id: str) -> tuple[dict, list, float]:
    """Poll /api/upload-status/<id> until the job ends; returns the last
    status, the stages seen in order with the seconds each was first seen,
    and the seconds to the end."""
    t0, seen = time.perf_counter(), []
    while True:
        resp = client.get(f"/api/upload-status/{job_id}")
        check(resp.status_code == 200, f"upload status {job_id}: HTTP {resp.status_code}")
        status = json.loads(resp.get_data(as_text=True))
        t = time.perf_counter() - t0
        if not seen or seen[-1][0] != status["stage"]:
            seen.append((status["stage"], t))
        if status["state"] in ("done", "error"):
            return status, seen, t
        check(t < INGEST_WAIT_S, f"upload {job_id} still {status['state']} after {INGEST_WAIT_S} s")
        time.sleep(INGEST_POLL_S)


def hold_ingested_rows(torch, engine, ctx, name: str, noise: float, what: str) -> dict:
    """The rows an upload stored (the kernel route) against a twin engine on
    the plain route (``attn_impl="plain"``, the same params) over the same
    saved frames: unit rows within EMBED_MIN_COS; the top-10 (top half of a
    short video's rows) of each text query within ``noise`` of the plain
    path's cut, each path with its own
    text vectors. Negative controls: rows off by row cosine EMBED_MIN_COS must
    fail the row band, and the rows of two frames swapped (the plain path's
    first and last under the first query) the ranking check."""
    import copy
    import dataclasses

    import numpy as np

    entry = ctx.registry.get(name)
    rows = np.load(ctx.resolve_path(entry["embeddings_file"]))
    plain = copy.copy(engine)
    plain.cfg = dataclasses.replace(engine.cfg, attn_impl="plain")
    plain._text_cache = {}
    ref, names = plain.embed_folder(ctx.resolve_path(entry["frames_dir"]))
    check(names == ctx.index.frame_names(name), f"{what}: the twin embedded {len(names)} frames")
    cos = (rows * ref).sum(1)
    k = min(SEARCH_K, len(rows) // 2)  # a short video holds a few dozen scenes
    txt, txt_ref = engine.encode_texts(list(QUERIES)), plain.encode_texts(list(QUERIES))
    bad, overlaps, band, diff = rank_check(rows, ref, txt, txt_ref, noise, k)
    off_cos = float((rows_off_by(rows, EMBED_MIN_COS, 0) * ref).sum(1).min())
    # rows handed to the wrong frames: the plain path's first and last frame
    # under the first query swap rows
    order = np.argsort(-(ref @ txt_ref[0]), kind="stable")
    swapped = rows.copy()
    swapped[[order[0], order[-1]]] = rows[[order[-1], order[0]]]
    swap_bad = rank_check(swapped, ref, txt, txt_ref, noise, k)[0]
    log(f"{what}: {len(rows)} ingested rows against the plain route: least row cosine {cos.min():.6f}; "
        f"top-{k} overlap {overlaps}, frames within {noise} of the cut {band}, largest score difference "
        f"{diff:.2e}, violations {bad}; controls: rows off by cosine {EMBED_MIN_COS} least {off_cos:.6f}, "
        f"two rows swapped {swap_bad} violations")
    check(float(cos.min()) >= EMBED_MIN_COS, f"{what}: ingested row cosine {cos.min()} < {EMBED_MIN_COS}")
    check(bad == 0, f"{what}: {bad} top-{k} swaps wider than {noise}")
    check(off_cos < EMBED_MIN_COS and swap_bad > 0,
          f"{what}: a control passed (row {off_cos}, swapped rows {swap_bad} violations)")
    return {"frame_cos": float(cos.min()), "score_diff": diff}


def upload(client, path: pathlib.Path, **form):
    import io

    return client.post("/api/upload-video", data={
        "video": (io.BytesIO(path.read_bytes()), path.name), **form})


def search_video(client, ctx, name: str, what: str) -> int:
    """/api/search for text in the new video only (``videoId``): events, every
    one of that video."""
    video_id = f"video-{ctx.video_names().index(name) + 1}"
    events = route_post(client, {"query": QUERIES[0], "search_type": "text", "top_k": 10,
                                 "adaptive_threshold": -1.0, "search_method": "text_clip",
                                 "videoId": video_id})
    check(bool(events) and all(e["videoId"] == f"video-{name}" for e in events),
          f"{what}: /api/search of {video_id} gave {[e['videoId'] for e in events]}")
    return len(events)


def phase_ingest(torch) -> dict:
    """Ingest and the upload routes at ViT-B/32's full width on the card:
    seeded videos uploaded through the port's app (``POST
    /api/upload-video``, async with ``/api/upload-status/<id>`` polled
    through its stages, and ``sync=1``), with bf16 weights and again with
    int8 weights and an int8 index under ``search_impl="pallas"``; after each
    upload /api/search finds the new video, its stored rows are held to a
    plain-route twin (``hold_ingested_rows``) and the launches of K1/K2 (bf16)
    or K3a/K3b (int8) over the upload equal 11 a pipelined encode batch; K4
    once in a negative query on the int8 index. The long video's ingest is
    split into decode + scene detection, frame extraction, staging and encode;
    embed_folder over INGEST_FOLDER_FRAMES saved JPEGs (one undecodable,
    skipped by index) is timed against the stager alone and
    encode_staged_images alone on the same frames, its rows equal to the
    latter's; cv2's JPEG decode is held to PIL's within INGEST_DECODE_LEVELS.
    An upload of bytes that are no video ends its job in "error"."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np
    from PIL import Image
    from werkzeug.test import Client

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ingest.scene import detect_scenes
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.retrieval import fused_topk
    from evr_tpu_torch.serving import ServingContext, create_app

    out: dict = {"launches": {}}
    launches = out["launches"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        long_video = tmp / "long_video.mp4"
        cuts = write_scene_video(long_video, INGEST_LONG_FRAMES, INGEST_SEED)
        shorts = {}
        for i, name in enumerate(("short_sync", "short_int8")):
            shorts[name] = tmp / f"{name}.mp4"
            write_scene_video(shorts[name], INGEST_SHORT_FRAMES, INGEST_SEED + 1 + i)
        (tmp / "not_a_video.mp4").write_bytes(np.random.default_rng(1).bytes(4096))
        log(f"ingest: wrote {INGEST_LONG_FRAMES} + 2 x {INGEST_SHORT_FRAMES} frames of "
            f"{INGEST_SIZE[0]}x{INGEST_SIZE[1]} ({len(cuts)} cuts in the long one) in "
            f"{time.perf_counter() - t0:.1f} s")

        # bf16 weights: the long video async, a short one with sync=1
        engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0)
        size = engine.cfg.vision.image_size
        engine.encode_staged_images(np.zeros((1, size, size, 3), np.uint8))  # kernel libraries load
        ctx = ServingContext(tmp / "root_bf16", engine=engine)
        ctx.data_root.ensure()
        client = Client(create_app(ctx))
        counted = [bf.fused_attn_block, bf.fused_mlp_block]
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        resp = upload(client, long_video)
        check(resp.status_code == 202, f"async upload: HTTP {resp.status_code}")
        job = json.loads(resp.get_data(as_text=True))
        status, seen, total_s = poll_upload(client, job["job_id"])
        got = {fn.__name__: fn.launches for fn in counted}
        stages = [s for s, _ in seen]
        check(status["state"] == "done", f"long upload: {status['state']} {status['error']}")
        check(stages == [s for s in INGEST_STAGES if s in stages] and stages[-1] == "done"
              and "scene_detect" in stages, f"long upload: stages seen {stages}")
        n_long = status["video"]["frames"]
        check(n_long == len(cuts) + 1 == status["frames_total"], f"long upload: {n_long} frames, "
              f"{len(cuts) + 1} scenes")
        expected = (engine.cfg.vision.layers - 1) * encode_batches(n_long, max(BATCH * 4, 256))
        log(f"ingest bf16, long video: stages {[(s, round(t, 3)) for s, t in seen]}, {total_s:.2f} s; "
            f"{n_long} frames; launches {got} (expected {expected} each)")
        check(all(n == expected for n in got.values()), f"long upload launches {got}, expected {expected}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        search_video(client, ctx, "long_video", "ingest bf16 long")
        out["long"] = {"seconds": total_s, "frames": n_long, "video_frames": INGEST_LONG_FRAMES,
                       "stages": seen, "rows": hold_ingested_rows(torch, engine, ctx, "long_video",
                                                                 SERVED_RANK_NOISE, "ingest bf16 long")}

        # the long video's split, each part alone: decode + scene detection,
        # frame extraction (each scene's middle frame read and written as
        # extract_scene_frames does; the same bytes as the upload's), staging
        # and encode of the saved frames
        t0 = time.perf_counter()
        spans = detect_scenes(long_video)
        detect_s = time.perf_counter() - t0
        check(len(spans) == n_long, f"detect_scenes: {len(spans)} spans")
        frames_dir = ctx.resolve_path(ctx.registry.get("long_video")["frames_dir"])
        extracted = tmp / "extracted"
        extracted.mkdir()
        t0 = time.perf_counter()
        cap = cv2.VideoCapture(str(long_video))
        for start, end in spans:
            cap.set(cv2.CAP_PROP_POS_FRAMES, (start + end) // 2)
            ok, frame = cap.read()
            check(ok, f"frame {(start + end) // 2} of the long video")
            cv2.imwrite(str(extracted / f"{(start + end) // 2}.jpg"), frame)
        cap.release()
        extract_s = time.perf_counter() - t0
        paths = sorted(frames_dir.iterdir(), key=lambda p: int(p.stem))
        check([p.read_bytes() for p in paths] == [(extracted / p.name).read_bytes() for p in paths],
              "the extracted frames differ from the upload's")
        stager = engine._ensure_native_stager()
        t0 = time.perf_counter()
        staged, ok = stager.stage_batch(paths)
        stage_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.encode_staged_images(staged[ok])
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        out["long"]["split"] = {"decode_scene_s": detect_s, "extract_s": extract_s, "stage_s": stage_s,
                                "encode_s": encode_s,
                                "rest_s": total_s - detect_s - extract_s - stage_s - encode_s}
        log(f"ingest bf16, long video: {INGEST_LONG_FRAMES / total_s:.1f} video frames/s end to end; split s "
            f"{json.dumps({k: round(v, 3) for k, v in out['long']['split'].items()})}")

        for fn in counted:
            fn.launches = 0
        resp = upload(client, shorts["short_sync"], sync="1", model="original")
        got = {fn.__name__: fn.launches for fn in counted}
        check(resp.status_code == 200, f"sync upload: HTTP {resp.status_code} {resp.get_data()[:200]!r}")
        body = json.loads(resp.get_data(as_text=True))
        n_sync = body["video"]["frames"]
        expected = (engine.cfg.vision.layers - 1) * encode_batches(n_sync, max(BATCH * 4, 256))
        check(body["status"] == "success" and n_sync > 0 and all(n == expected for n in got.values()),
              f"sync upload: {body['status']}, {n_sync} frames, launches {got} (expected {expected})")
        for name, n in got.items():
            launches[name] += n
        search_video(client, ctx, "short_sync", "ingest bf16 sync")
        out["sync"] = {"frames": n_sync, "rows": hold_ingested_rows(
            torch, engine, ctx, "short_sync", SERVED_RANK_NOISE, "ingest bf16 sync")}

        # an ingest that raises ends its job in "error"
        resp = upload(client, tmp / "not_a_video.mp4")
        status, _, _ = poll_upload(client, json.loads(resp.get_data(as_text=True))["job_id"])
        log(f"ingest: bytes that are no video: state {status['state']}, error {status['error']!r}")
        check(status["state"] == status["stage"] == "error" and "cannot open video" in (status["error"] or ""),
              f"a failed ingest: {status}")

        # embed_folder over saved 1280 x 720 JPEGs, one that does not decode
        folder = tmp / "folder"
        folder.mkdir()
        rng = np.random.default_rng(INGEST_SEED)
        grids = rng.integers(0, 256, (64, 9, 16, 3), dtype=np.uint8)

        def write_frame(i):
            frame = cv2.resize(grids[i % 64], INGEST_SIZE, interpolation=cv2.INTER_LINEAR)
            x = (i * 8) % (INGEST_SIZE[0] - 64)
            frame[INGEST_SIZE[1] // 2 - 32:INGEST_SIZE[1] // 2 + 32, x:x + 64] = 255
            cv2.imwrite(str(folder / f"{i:05d}.jpg"), frame)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write_frame, range(INGEST_FOLDER_FRAMES)))
        (folder / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, names = engine.embed_folder(folder)
        folder_s = time.perf_counter() - t0
        check(len(names) == INGEST_FOLDER_FRAMES and "broken.jpg" not in names,
              f"embed_folder: {len(names)} frames, broken skipped: {'broken.jpg' not in names}")
        paths = [folder / n for n in names]
        t0 = time.perf_counter()
        staged, ok = stager.stage_batch(paths)
        stage_s = time.perf_counter() - t0
        check(ok == list(range(len(paths))), "the stager failed on a good frame")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = engine.encode_staged_images(staged, normalise=True)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        diff = float(np.abs(rows - enc).max())
        check(diff <= 1e-6, f"embed_folder rows against encode_staged_images: {diff}")
        levels = []
        for p, s in zip(paths[::INGEST_FOLDER_FRAMES // INGEST_DECODE_SAMPLE], staged[::INGEST_FOLDER_FRAMES // INGEST_DECODE_SAMPLE]):
            pil = np.asarray(Image.open(p).convert("RGB"))
            bgr = cv2.imread(str(p), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
            staged_pil = np.empty_like(s)
            stager.stage_pixels(pil, staged_pil, bgr=False)
            levels.append((int(np.abs(pil.astype(int) - bgr[:, :, ::-1]).max()),
                           int(np.abs(staged_pil.astype(int) - s).max())))
        out["folder"] = {"frames": len(names), "seconds": folder_s, "stage_s": stage_s, "encode_s": encode_s,
                         "write_s": write_s, "max_diff": diff, "decode_levels": max(a for a, _ in levels),
                         "staged_levels": max(b for _, b in levels)}
        log(f"ingest: embed_folder over {len(names)} saved {INGEST_SIZE[0]}x{INGEST_SIZE[1]} JPEGs (batch "
            f"{BATCH}, native pipelined): {len(names) / folder_s:.1f} frames/s; the stager alone "
            f"{len(names) / stage_s:.1f} frames/s ({stager.n_threads} threads), encode_staged_images alone "
            f"{len(names) / encode_s:.1f} frames/s; rows within {diff:.1e}; writing them took {write_s:.1f} s; "
            f"cv2 against PIL decode, largest level difference {out['folder']['decode_levels']} (staged "
            f"{out['folder']['staged_levels']}) over {len(levels)} frames")
        check(out["folder"]["decode_levels"] <= INGEST_DECODE_LEVELS, f"decode levels {levels}")
        del staged, enc, rows, engine, ctx, client
        torch.cuda.empty_cache()

        # int8 weights and an int8 index (K3a/K3b; K4 on a negative query)
        engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0, params_dtype="int8")
        engine.encode_staged_images(np.zeros((1, size, size, 3), np.uint8))
        ctx = ServingContext(tmp / "root_int8", engine=engine, index_dtype="int8", search_impl="pallas")
        ctx.data_root.ensure()
        client = Client(create_app(ctx))
        counted = [bf.fused_attn_block_q, bf.fused_mlp_block_q]
        for fn in counted:
            fn.launches = 0
        resp = upload(client, shorts["short_int8"])
        check(resp.status_code == 202, f"int8 upload: HTTP {resp.status_code}")
        status, seen, int8_s = poll_upload(client, json.loads(resp.get_data(as_text=True))["job_id"])
        got = {fn.__name__: fn.launches for fn in counted}
        n_int8 = status["video"]["frames"] if status["state"] == "done" else 0
        expected = (engine.cfg.vision.layers - 1) * encode_batches(n_int8, max(BATCH * 4, 256))
        check(status["state"] == "done" and n_int8 > 0 and all(n == expected for n in got.values()),
              f"int8 upload: {status['state']} {status['error']}, {n_int8} frames, launches {got} "
              f"(expected {expected})")
        launches.update(got)
        search_video(client, ctx, "short_int8", "ingest int8")
        fused_topk.launches = 0
        events = route_post(client, {"query": QUERIES[3], "negative_query": QUERIES[4], "search_type": "text",
                                     "top_k": 10, "adaptive_threshold": -1.0, "search_method": "text_clip"})
        launches["fused_topk"] = fused_topk.launches
        check(bool(events) and fused_topk.launches == 1, f"int8 negative query: {len(events)} events, "
              f"K4 {fused_topk.launches} launches (expected 1)")
        out["int8"] = {"frames": n_int8, "seconds": int8_s, "stages": seen, "rows": hold_ingested_rows(
            torch, engine, ctx, "short_int8", INT8_SERVED_RANK_NOISE, "ingest int8")}
        log(f"ingest int8: {n_int8} frames in {int8_s:.2f} s, stages {[s for s, _ in seen]}, launches {got} "
            f"(expected {expected} each), K4 {launches['fused_topk']} in the negative query")
        del engine, ctx, client
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- 16. the benchmark harness and the trainer variants ------------------------

# The retrieval benchmark at ViT-B/32 (bf16 weights, K1/K2): HARNESS_IMAGES
# seeded JPEGs of a Flickr30k image's size (half the CLI's --max-images default),
# HARNESS_CAPTIONS captions each, in the reference harness's caption CSV; an
# Excel test set of HARNESS_EXCEL_ROWS rows with one to three ground-truth
# images over the first HARNESS_EXCEL_IMAGES images; HARNESS_CLASS_IMAGES
# JPEGs in each of three class folders; a reference .pt of the engines'
# weights perturbed by HARNESS_PERTURB of each leaf's spread, with a 3-class
# head. Each run's features are held to a twin engine on the plain route
# over the same staged pixels and tokens: unit rows within EMBED_MIN_COS, and
# each t2i / i2t rank off the twin's only by candidates the twin scores within
# the served band (bf16 SERVED_RANK_NOISE, int8 INT8_SERVED_RANK_NOISE) of
# the ground truth's twin score; R@K and MRR then differ by at most the share
# of queries that have such a candidate.
HARNESS_SEED = 17
HARNESS_IMAGES, HARNESS_CAPTIONS = 125, 5  # images cut from 1,000 (then 500, 250) for the script's time
HARNESS_SIZE = (500, 375)  # width, height
HARNESS_BLOCK = 25  # the seeded scenes' colour blocks, pixels
HARNESS_EXCEL_IMAGES, HARNESS_EXCEL_ROWS = 100, 150  # cut from 200, 300 with the images
HARNESS_CLASSES = ("Violence", "Sensitive", "NonViolence")
HARNESS_CLASS_IMAGES = 32  # cut from 128 (then 64) for the script's time
HARNESS_PERTURB = 0.05
HARNESS_WORDS = ("a", "man", "woman", "red", "car", "crowd", "street", "dog", "boat", "sign", "night",
                 "people", "running", "park", "fight", "water", "two", "on", "the", "bicycle")
HARNESS_DIAG_BATCHES = (1, 8, 16, 32)  # tools.diagnose's default sweep
# The trainer variants at ViT-L/14@336px (both towers at full width, batch
# TRAIN_BATCH, bf16) against twins on attn_impl="plain_grad" from the same
# params, batch and dropout seed: each step's loss within STEP_BF16_BANDS[0]
# (relative); each phase's first step (rate 0) leaves every param bit-equal
# and no frozen leaf ever moves; at each phase's second step (and each
# CatLIP step) the gradients through ``gradients`` with the step's draw are
# held as phase 6 holds a bf16 step (STEP_BF16_BANDS: the grad norm, and by
# cosine each leaf of the vision blocks, which K5 computes, frozen or not; a
# gradient turned to cosine 0.99 must fail). A leaf outside them moves with
# the bf16 noise of the features (the heads' and the text tower's sums over
# the batch nearly cancel: 0.9946 in a probe run). The updates are
# reported, not held (``twin_steps``); the key third of each qkv bias is
# left out of its leaf's update cosine: its gradient is zero in exact
# arithmetic (the softmax ignores a shift shared by a query's keys).
VARIANT_STEPS = 2  # steps per progressive phase; CatLIP and projection steps
VARIANT_CLASSES = 3


def quiet(fn, argv):
    """``fn(argv)`` with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return result, buf.getvalue()


def harness_images(torch, n: int, seed: int):
    """uint8 [n, H, W, 3] seeded scenes of HARNESS_SIZE on the host: a
    random colour per HARNESS_BLOCK block, a horizontal ramp and noise."""
    w, h = HARNESS_SIZE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for lo in range(0, n, 200):
        m = min(200, n - lo)
        layout = torch.randint(0, 256, (m, h // HARNESS_BLOCK, w // HARNESS_BLOCK, 3), generator=gen,
                               device="cuda").float()
        layout = layout.repeat_interleave(HARNESS_BLOCK, 1).repeat_interleave(HARNESS_BLOCK, 2)
        ramp = torch.linspace(-30, 30, w, device="cuda")
        noise = torch.randn((m, h, w, 3), generator=gen, device="cuda") * 4
        out.append((layout + ramp[None, None, :, None] + noise).clamp(0, 255).to(torch.uint8).cpu().numpy())
    return out


def write_jpegs(torch, folder: pathlib.Path, n: int, seed: int) -> list[str]:
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    names = []
    for chunk in harness_images(torch, n, seed):
        for img in chunk:
            name = f"{len(names):05d}.jpg"
            cv2.imwrite(str(folder / name), img[:, :, ::-1])
            names.append(name)
    return names


def write_harness_data(torch, root: pathlib.Path) -> dict:
    """The harness's inputs under ``root``: images/ with captions.csv,
    testset.xlsx (folder | caption | image, multi-GT rows over images/),
    classes/<class>/ and ft.pt (the perturbed reference file)."""
    import numpy as np

    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.models.torch_export import save_reference_checkpoint
    from evr_tpu_torch.training.partition import map_with_paths
    from evr_tpu_torch.utils.xlsx import write_xlsx

    rng = np.random.default_rng(HARNESS_SEED)
    names = write_jpegs(torch, root / "images", HARNESS_IMAGES, HARNESS_SEED)
    rows = ["image_name| comment_number| comment"]
    rows += [f"{n}| {c}| {' '.join(rng.choice(HARNESS_WORDS, size=7))}"
             for n in names for c in range(HARNESS_CAPTIONS)]
    (root / "captions.csv").write_text("\n".join(rows))
    sheet = [["folder", "caption", "image"]]
    for _ in range(HARNESS_EXCEL_ROWS):
        picks = rng.choice(HARNESS_EXCEL_IMAGES, size=int(rng.integers(1, 4)), replace=False)
        sheet.append(["images", " ".join(rng.choice(HARNESS_WORDS, size=6)),
                      ";".join(names[i] for i in sorted(picks))])
    write_xlsx(root / "testset.xlsx", {"Sheet1": sheet})
    for i, c in enumerate(HARNESS_CLASSES):
        write_jpegs(torch, root / "classes" / c, HARNESS_CLASS_IMAGES, HARNESS_SEED + 1 + i)
    cfg = get_model_config(MODEL)

    def perturb(_, leaf):
        if leaf.size < 2:
            return leaf
        return leaf + HARNESS_PERTURB * leaf.std() * rng.standard_normal(leaf.shape, dtype=np.float32)

    tuned = map_with_paths(init_clip_params(0, cfg), perturb)  # the engines' rng_seed 0 weights, moved
    head = init_classifier_params(HARNESS_SEED, ClassifierConfig(embed_dim=cfg.embed_dim,
                                                                  num_classes=len(HARNESS_CLASSES)))
    save_reference_checkpoint(root / "ft.pt", tuned, head)
    return {"images": root / "images", "captions": root / "captions.csv", "excel": root / "testset.xlsx",
            "classes": root / "classes", "ckpt": root / "ft.pt"}


def band_rank_check(torch, got, ref, gt, band: float) -> dict:
    """Ranks of [Q, C] candidate scores, query by query: the rank of a query
    is 1 + the count of candidates scoring strictly above its best
    ground-truth candidate (``gt``, a [Q, C] mask). A candidate counted in
    one of ``got`` / ``ref`` and not the other is a violation unless ``ref``
    scores it within ``band`` of the query's best ground-truth score there.
    Returns the violations, the queries with a candidate within the band,
    and both rank vectors."""
    neg = torch.tensor(float("-inf"), device=got.device)
    m_got = torch.where(gt, got, neg).amax(1, keepdim=True)
    m_ref = torch.where(gt, ref, neg).amax(1, keepdim=True)
    above_got, above_ref = got > m_got, ref > m_ref
    near = ((ref - m_ref).abs() <= band) & ~gt
    return {"violations": int(((above_got ^ above_ref) & ~near).sum()), "uncertain": int(near.any(1).sum()),
            "ranks": (1 + above_got.sum(1)).cpu().numpy(), "ref_ranks": (1 + above_ref.sum(1)).cpu().numpy()}


def rows_off_by(rows, cos: float, seed: int):
    """Unit rows turned by about ``cos`` away from ``rows`` (a control)."""
    import numpy as np

    off = rows + np.random.default_rng(seed).standard_normal(rows.shape).astype(np.float32) * math.sqrt(
        (1 / cos ** 2 - 1) / rows.shape[1])
    return off / np.linalg.norm(off, axis=1, keepdims=True)


def hold_harness(torch, what: str, got, ref, dataset, results: dict, band: float) -> dict:
    """One harness run's features (``got``: the kernel route's unit image
    and caption rows, as the run ranked them) against a plain-route twin's
    (``ref``) on the same dataset: rows, ranks within ``band``, R@K and MRR
    within the share of queries with a candidate in the band, the run's own
    ranks recomputed equal; and the two controls (image rows off by cosine
    EMBED_MIN_COS; two images' rows swapped), which must fail."""
    import numpy as np

    from evr_tpu_torch.evaluation.retrieval import _similarity_matrix, metrics_from_ranks

    (img, txt), (img_p, txt_p) = got, ref
    row_cos = {"images": float((img * img_p).sum(1).min()), "captions": float((txt * txt_p).sum(1).min())}
    row_of = {image_id: i for i, image_id in enumerate(dataset.image_ids)}
    gt_row = torch.tensor([row_of[c] for c in dataset.caption_image_ids], device="cuda")
    cap_gt = torch.nn.functional.one_hot(gt_row, len(img)).bool()  # [M, N]

    def ranks_of(i, t, ip, tp):
        s, sp = (torch.from_numpy(_similarity_matrix(a, b, "cuda")).cuda() for a, b in ((i, t), (ip, tp)))
        return (band_rank_check(torch, s.T, sp.T, cap_gt, band),
                band_rank_check(torch, s, sp, cap_gt.T, band))

    t2i, i2t = ranks_of(img, txt, img_p, txt_p)
    out = {"row_cos": row_cos, "violations": t2i["violations"] + i2t["violations"], "metric_gap": {},
           "share": {}}
    check(t2i["ranks"].tolist() == results["t2i_ranks"] and i2t["ranks"].tolist() == results["i2t_ranks"],
          f"{what}: the captured features do not give the run's ranks")
    for d, r in (("t2i", t2i), ("i2t", i2t)):
        twin = metrics_from_ranks(r["ref_ranks"])
        share = r["uncertain"] / len(r["ranks"])
        gap = max(abs(results[d][k] - twin[k]) for k in ("R@1", "R@5", "R@10", "MRR"))
        out["metric_gap"][d], out["share"][d] = gap, share
        check(gap <= share, f"{what}: {d} R@K / MRR {gap} off the twin's, more than the share {share} "
                            f"of queries with a candidate within {band}")
    off_cos = float((rows_off_by(img, EMBED_MIN_COS, HARNESS_SEED) * img_p).sum(1).min())
    a = 0
    b = int(np.argmin(img_p @ txt_p[0]))  # image 0's first caption scores image b lowest
    swapped = img.copy()
    swapped[[a, b]] = img[[b, a]]
    swap = sum(r["violations"] for r in ranks_of(swapped, txt, img_p, txt_p))
    out["controls"] = {"rows_off_cos": off_cos, "swapped_violations": swap}
    log(f"{what}: least row cosine images {row_cos['images']:.6f}, captions {row_cos['captions']:.6f} "
        f"(band {EMBED_MIN_COS}); rank violations {out['violations']} (band {band}); R@K / MRR off the twin's "
        f"by {json.dumps({k: round(v, 6) for k, v in out['metric_gap'].items()})}, queries with a candidate "
        f"in the band {json.dumps({k: round(v, 4) for k, v in out['share'].items()})}; controls: rows off by "
        f"cosine {EMBED_MIN_COS} least {off_cos:.6f}, images 0 and {b} swapped {swap} violations")
    check(min(row_cos.values()) >= EMBED_MIN_COS, f"{what}: row cosine {row_cos} < {EMBED_MIN_COS}")
    check(out["violations"] == 0, f"{what}: {out['violations']} ranks off the twin's beyond {band}")
    check(off_cos < EMBED_MIN_COS and swap > 0,
          f"{what}: a control passed (rows {off_cos}, swapped images {swap} violations)")
    return out


def twin_features(torch, engine, staged, tokens) -> tuple:
    """Unit image and caption rows of ``engine`` from staged pixels and
    tokens (``encode_texts`` after its tokenizer)."""
    import numpy as np

    from evr_tpu_torch.models.clip import encode_text

    with torch.inference_mode():
        txt = encode_text(engine.params, engine.cfg, torch.from_numpy(tokens).to(engine.device),
                          dtype=engine.compute_dtype, eot_fast_final=True).cpu().numpy()
    txt = txt / np.maximum(np.linalg.norm(txt, axis=-1, keepdims=True), 1e-12)
    return engine.encode_staged_images(staged, normalise=True), txt


def phase_harness(torch) -> dict:
    """The retrieval and classification benchmark (A12) on the card. (a)
    ``tools.evaluate.main`` over HARNESS_IMAGES JPEGs and their captions,
    the base model and the fine-tuned reference file (bf16 weights, K1/K2),
    its JSON / CSV / XLSX written (the workbook read back), each model's
    features held to a plain-route twin (``hold_harness``); ``--excel`` on
    the multi-GT test set (P@K); ``--classification-dirs`` through the
    checkpoint's trained head and a probe, then ``--zeroshot``;
    ``tools.ab_compare`` and ``tools.diagnose`` (exit 0). K1/K2 launches over
    those runs equal to their encode batches. (b) A ``ModelComparison`` over
    an int8 engine (K3a/K3b) held to its plain twin in the int8 bands."""
    import copy
    import dataclasses

    import numpy as np

    from evr_tpu_torch.evaluation import EngineAdapter, ModelComparison
    from evr_tpu_torch.evaluation import compare as compare_module
    from evr_tpu_torch.evaluation.datasets import load_captions_csv
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.preprocess import stage_image_fast
    from evr_tpu_torch.tokenizer import get_default_tokenizer
    from evr_tpu_torch.tools import ab_compare, diagnose, evaluate
    from evr_tpu_torch.utils.xlsx import read_xlsx

    cfg = get_model_config(MODEL)
    v_launch, t_launch = cfg.vision.layers - 1, cfg.text.layers - 1
    batches = lambda n: -(-n // BATCH)  # noqa: E731
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        data = write_harness_data(torch, root)
        log(f"harness inputs: {HARNESS_IMAGES} JPEGs of {HARNESS_SIZE[0]} x {HARNESS_SIZE[1]}, "
            f"{HARNESS_IMAGES * HARNESS_CAPTIONS} captions, {HARNESS_EXCEL_ROWS} Excel rows, "
            f"{len(HARNESS_CLASSES)} x {HARNESS_CLASS_IMAGES} class JPEGs, ft.pt "
            f"({data['ckpt'].stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
        captured, real = [], compare_module.evaluate_retrieval

        def recording(img, txt, *args, **kwargs):
            captured.append((img, txt))
            return real(img, txt, *args, **kwargs)

        dev = ["--device", "cuda", "--model", MODEL]
        ckpt = ["--checkpoint", str(data["ckpt"])]
        classes = ["--classification-dirs", *(f"{c}={data['classes'] / c}" for c in HARNESS_CLASSES)]
        runs, seconds, texts = {}, {}, {}
        counted = [bf.fused_attn_block, bf.fused_mlp_block]
        compare_module.evaluate_retrieval = recording
        try:
            for fn in counted:
                fn.launches = 0
            for name, fn, argv in (
                ("captions", evaluate.main, ["--images-dir", str(data["images"]), "--captions-csv",
                                             str(data["captions"]), "--output-dir", str(root / "out"), *ckpt]),
                ("excel", evaluate.main, ["--images-dir", str(root), "--excel", str(data["excel"]),
                                          "--output-dir", str(root / "out_excel")]),
                ("classification", evaluate.main, [*classes, "--images-dir", str(data["images"]),
                                                   "--output-dir", str(root / "out_cls"), *ckpt]),
                ("zeroshot", evaluate.main, [*classes, "--zeroshot", "--images-dir", str(data["images"]),
                                             "--output-dir", str(root / "out_zs"), *ckpt]),
                ("ab_compare", ab_compare.main, ["--frames-dir", str(data["classes"] / HARNESS_CLASSES[0]),
                                                 "--queries", *QUERIES, "--output", str(root / "ab.json"), *ckpt]),
                ("diagnose", diagnose.main, ckpt),
            ):
                t0 = time.perf_counter()
                runs[name], texts[name] = quiet(fn, argv + dev)
                torch.cuda.synchronize()
                seconds[name] = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
        finally:
            compare_module.evaluate_retrieval = real
        n_cls = len(HARNESS_CLASSES) * HARNESS_CLASS_IMAGES
        excel_images = len(captured[2][0])  # captured: the two captions models, then the Excel run
        expected = (2 * (batches(HARNESS_IMAGES) * v_launch + t_launch)  # captions: two models
                    + batches(excel_images) * v_launch + t_launch  # excel: the base model
                    + 2 * batches(n_cls) * v_launch  # classification
                    + 2 * (batches(n_cls) * v_launch + t_launch)  # zero-shot: all prompts in one encode
                    + 2 * (v_launch + t_launch * len(QUERIES))  # ab_compare: one folder batch, a query each
                    + v_launch * (1 + len(HARNESS_DIAG_BATCHES)))  # diagnose: 8 frames, then the sweep
        log(f"harness launches {json.dumps(launches)} (expected {expected} each); seconds "
            f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
        check(all(n == expected for n in launches.values()), f"harness launches {launches}, expected {expected}")

        # (a) the captions run: outputs, speeds, the table, then the twin
        results = runs["captions"]
        book = read_xlsx(root / "out" / "comparison_results.xlsx")
        saved = json.loads((root / "out" / "comparison_results.json").read_text())
        check(list(book) == ["Text-to-Image", "Image-to-Text", "Mean Metrics"], f"workbook sheets {list(book)}")
        for title, key in (("Text-to-Image", "t2i"), ("Image-to-Text", "i2t"), ("Mean Metrics", "mean")):
            for row in book[title][1:]:
                check(row[1:7] == [saved[row[0]][key][m] for m in ("R@1", "R@5", "R@10", "MRR", "Median_Rank",
                                                                     "Mean_Rank")], f"workbook {title} {row}")
        check((root / "out" / "comparison_results.csv").exists(), "no CSV report")
        speeds = {}
        for name, r in results.items():
            speeds[name] = {"images_per_s": HARNESS_IMAGES / r["encode_image_seconds"],
                            "captions_per_s": HARNESS_IMAGES * HARNESS_CAPTIONS / r["encode_text_seconds"]}
        table = texts["captions"][texts["captions"].index("\nmodel") + 1:].split("wrote")[0].rstrip()
        for line in table.splitlines():
            log(f"  {line}")
        log(f"harness encode rates (images include cv2 staging): {json.dumps({k: {m: round(x, 1) for m, x in v.items()} for k, v in speeds.items()})}")
        check(results["clip_original"]["mean"] != results["clip_finetuned"]["mean"],
              "the fine-tuned file ranks as the base model does")
        dataset = load_captions_csv(data["captions"], data["images"], max_images=HARNESS_IMAGES)
        staged = np.stack([stage_image_fast(p, cfg.vision.image_size) for p in dataset.ordered_paths])
        tokens = get_default_tokenizer()(dataset.captions, context_length=cfg.text.context_length)
        plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
        held = {}
        for i, (name, twin) in enumerate((
            ("clip_original", lambda: EmbeddingEngine(MODEL, cfg=plain_cfg, device="cuda")),
            ("clip_finetuned", lambda: EmbeddingEngine.from_checkpoint(data["ckpt"], MODEL, cfg=plain_cfg,
                                                                     device="cuda")),
        )):
            held[name] = hold_harness(torch, f"harness bf16 {name}", captured[i],
                                      twin_features(torch, twin(), staged, tokens), dataset, results[name],
                                      SERVED_RANK_NOISE)
        # --excel (P@K), classification, zero-shot, ab_compare, diagnose
        multi = runs["excel"]["clip_original"]["multi_gt"]
        log(f"harness --excel: {excel_images} images, {HARNESS_EXCEL_ROWS} rows: "
            f"{json.dumps({k: round(v, 4) for k, v in multi.items()})}")
        check(all(0.0 <= multi[f"P@{k}"] <= 1.0 for k in (1, 5, 10)) and math.isfinite(multi["MRR"]),
              f"--excel multi-GT metrics {multi}")
        modes = {tag: {m: (r["mode"], round(r["accuracy"], 4), round(r["f1_macro"], 4))
                       for m, r in runs[tag].items()} for tag in ("classification", "zeroshot")}
        log(f"harness classification over {n_cls} images (mode, accuracy, F1): {json.dumps(modes)}")
        check(modes["classification"]["original"][0] == "linear_probe"
              and modes["classification"]["finetuned"][0] == "trained_head"
              and {m[0] for m in modes["zeroshot"].values()} == {"zeroshot"}, f"classification modes {modes}")
        ab = json.loads((root / "ab.json").read_text())
        check(set(ab) == {"original", "finetuned"} and all(
            len(hits) == SEARCH_K and all(math.isfinite(h["similarity"]) for h in hits)
            for per in ab.values() for hits in per.values()) and ab["original"] != ab["finetuned"],
            "ab_compare results")
        rc = runs["diagnose"]
        report = json.loads(texts["diagnose"])
        log(f"harness diagnose: exit {rc}, dtypes {report['dtype']['dtypes']}, freeze audit "
            f"{report['freeze_audit']['tensor_counts_by_group']}, sweep "
            f"{ {k: v.get('output_shape') for k, v in report['batch_size_sweep'].items() if isinstance(v, dict)} }")
        check(rc == 0 and report["ok"], f"tools.diagnose exit {rc}: {texts['diagnose'][-2000:]}")

        # (b) int8 weights through K3a/K3b against the int8 plain twin
        engine = EmbeddingEngine(MODEL, device="cuda", params_dtype="int8")
        comp = ModelComparison(output_dir=root / "out_int8", log=lambda *_: None, device="cuda")
        comp.register("clip_int8", lambda: EngineAdapter(engine))
        counted_q = [bf.fused_attn_block_q, bf.fused_mlp_block_q]
        captured.clear()
        compare_module.evaluate_retrieval = recording
        try:
            for fn in counted_q:
                fn.launches = 0
            res_q = comp.run_evaluation(dataset)["clip_int8"]
            torch.cuda.synchronize()
            launches_q = {fn.__name__: fn.launches for fn in counted_q}
        finally:
            compare_module.evaluate_retrieval = real
        expected_q = batches(HARNESS_IMAGES) * v_launch + t_launch
        log(f"harness int8: launches {json.dumps(launches_q)} (expected {expected_q} each); rsum "
            f"{res_q['mean']['rsum']:.4f}")
        check(all(n == expected_q for n in launches_q.values()), f"harness int8 launches {launches_q}")
        plain_q = copy.copy(engine)
        plain_q.cfg, plain_q._text_cache = plain_cfg, {}
        held["int8"] = hold_harness(torch, "harness int8", captured[0],
                                    twin_features(torch, plain_q, staged, tokens), dataset, res_q,
                                    INT8_SERVED_RANK_NOISE)
        del engine, plain_q, staged
        torch.cuda.empty_cache()
    for name, m in launches_q.items():
        launches[name] = m
    return {"launches": launches, "speeds": speeds, "held": held, "seconds": seconds,
            "phase_s": time.perf_counter() - t_phase, "rsum": {k: r["mean"]["rsum"] for k, r in results.items()}}


def update_vector(torch, key: str, after, before):
    u = (after - before).float().flatten()
    if key.endswith("attn/qkv/bias"):  # the key third: see VARIANT_STEPS
        w = u.shape[0] // 3
        u = torch.cat([u[:w], u[2 * w:]])
    return u


def update_cosines(torch, before_k, after_k, before_p, after_p, keys) -> dict:
    """Each leaf's update (``keys``) through the kernels against the twin's,
    by cosine: the least three. Leaves that neither route moves are left
    out."""
    cos = {}
    for k in keys:
        a, b = update_vector(torch, k, after_k[k], before_k[k]), update_vector(torch, k, after_p[k], before_p[k])
        if a.norm().item() == 0.0 and b.norm().item() == 0.0:
            continue
        cos[k] = torch.nn.functional.cosine_similarity(a[None], b[None]).item()
    return {"worst": [(k, round(c, 6)) for c, k in sorted((c, k) for k, c in cos.items())[:3]]}


def snapshot(trainer_params) -> dict:
    from evr_tpu_torch.training.finetune import flat_leaves

    return {k: v.detach().clone() for k, v in flat_leaves(trainer_params).items()}


def variant_batch(torch, cfg, n: int):
    """n staged frames of the model's size, captions' tokens, labels."""
    import numpy as np

    from evr_tpu_torch.tokenizer import get_default_tokenizer

    rng = np.random.default_rng(HARNESS_SEED)
    captions = [" ".join(rng.choice(HARNESS_WORDS, size=7)) for _ in range(n)]
    return captions, {"images": synthetic_frames(torch, n, cfg.vision.image_size, cfg.vision.patch_size),
                      "tokens": get_default_tokenizer()(captions, context_length=cfg.text.context_length),
                      "labels": np.arange(n) % VARIANT_CLASSES}


def twin_steps(torch, what: str, kernel, twin, batch, counted, trainable, first_still: bool, grads_of=None):
    """One step of ``kernel`` and one of ``twin`` on ``batch``: (the kernel
    step's seconds and launches, the check's figures). With ``first_still``
    the step must leave every param of both bit-equal. ``grads_of`` (a
    predicate on leaf keys): first the gradients of both, through
    ``gradients`` with the step's dropout draw, held on those leaves as
    phase 6 holds a step (``step_compare``); those launches are the
    comparison's, not the step's. The updates (after minus before) of the
    trainable leaves are reported by cosine, towers and heads apart, and not
    held: two steps into a phase, Adam divides each element by its own
    root mean square, so an element whose gradient is small beside the bf16
    noise of the step moves by a full step either way; the update cosines
    sit well under the gradients' (0.967 against 0.9988 in a probe run)."""
    out = {}
    if grads_of is not None:
        (m_k, g_k), (m_p, g_p) = kernel.gradients(batch), twin.gradients(batch)
        m_k, m_p = ({"total_loss": m.get("total_loss", m.get("bce_loss"))} for m in (m_k, m_p))
        out["grads"] = step_compare(torch, f"{what}: gradients, kernels vs plain", m_k, m_p, g_k, g_p, grads_of)
        del g_k, g_p
    bk, bp = snapshot(kernel.params), snapshot(twin.params)
    start = {fn.__name__: fn.launches for fn in counted}
    t0 = time.perf_counter()
    mk = kernel.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches - start[fn.__name__] for fn in counted}
    mp = twin.train_step(batch)
    key = "total_loss" if "total_loss" in mk else "bce_loss"
    out.update(loss=mk[key], loss_rel=abs(mk[key] - mp[key]) / abs(mp[key]))
    ak, ap = snapshot(kernel.params), snapshot(twin.params)
    if first_still:
        out["still"] = all(torch.equal(ak[k], bk[k]) for k in bk) and all(torch.equal(ap[k], bp[k]) for k in bp)
    else:
        for part, keys in (("towers", [k for k in trainable if k.startswith("clip/")]),
                           ("heads", [k for k in trainable if not k.startswith("clip/")])):
            if keys:
                out[f"update_cos_{part}"] = update_cosines(torch, bk, ak, bp, ap, keys)["worst"]
        frozen = [k for k in bk if k not in trainable]
        out["frozen_moved"] = sum(not torch.equal(ak[k], bk[k]) for k in frozen)
    del bk, bp, ak, ap
    return step_s, launches, out


def variant_check(what: str, out: dict) -> None:
    loss_band = STEP_BF16_BANDS[0]
    check(math.isfinite(out["loss"]) and out["loss_rel"] <= loss_band,
          f"{what}: losses apart by {out['loss_rel']} > {loss_band}")
    if "grads" in out:
        step_check(f"{what}: gradients", out["grads"], STEP_BF16_BANDS)
    if "still" in out:
        check(out["still"], f"{what}: a first step (rate 0) moved a param")
    else:
        check(out["frozen_moved"] == 0, f"{what}: {out['frozen_moved']} frozen leaves moved")


def phase_variants(torch) -> dict:
    """The trainer variants (``training.variants``) on the card. (c)
    ``ProgressiveTrainer`` at ViT-L/14@336px through phases 1, 2 and 3,
    VARIANT_STEPS steps each, against a ``plain_grad`` twin (see
    VARIANT_STEPS for the bands); K1/K2 forward and K5a/K5b backward launch
    once a vision block every step of every phase (the clip reads the frozen
    towers' gradients too). (d) ``CatLIPTrainer`` there (vision only) against
    its twin, and ``ProjectionTrainer`` at ViT-B/32 (frozen CLIP), whose
    ``encode_projected`` runs K1/K2 and is held to a plain twin's rows."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.training.finetune import flat_leaves
    from evr_tpu_torch.training.variants import (
        CatLIPTrainConfig, CatLIPTrainer, ProgressiveTrainConfig, ProgressiveTrainer, ProjectionTrainConfig,
        ProjectionTrainer, build_concept_vocab, concept_targets,
    )

    t_phase = time.perf_counter()
    cfg = get_model_config(TRAIN_MODEL)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain_grad")
    blocks = cfg.vision.layers
    counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd]
    totals = {fn.__name__: 0 for fn in counted}
    params = init_clip_params(HARNESS_SEED, cfg)
    captions, batch = variant_batch(torch, cfg, TRAIN_BATCH)
    pcfg = ProgressiveTrainConfig(num_classes=VARIANT_CLASSES, steps_per_phase=VARIANT_STEPS,
                                  compute_dtype="bfloat16")
    kernel = ProgressiveTrainer(cfg, params, pcfg, seed=HARNESS_SEED, device="cuda")
    twin = ProgressiveTrainer(plain_cfg, params, pcfg, seed=HARNESS_SEED, device="cuda")
    progressive = {}
    for phase in (1, 2, 3):
        if phase > 1:
            kernel.next_phase()
            twin.next_phase()
        labels = flat_leaves(kernel.labels_for_phase(phase))
        trainable = [k for k, v in labels.items() if v != "frozen"]
        rows = []
        for s in range(VARIANT_STEPS):
            # the second step holds the vision blocks' gradients (K5's, which
            # the clip reads in every phase, frozen or not)
            step_s, launches, out = twin_steps(
                torch, f"progressive phase {phase} step {s}", kernel, twin, batch, counted, trainable,
                first_still=s == 0, grads_of=vision_block_leaf if s == VARIANT_STEPS - 1 else None)
            for k, n in launches.items():
                totals[k] += n
            rows.append({"step_s": step_s, "launches": launches, **out})
            log(f"progressive phase {phase} step {s}: {step_s:.4f} s, launches {json.dumps(launches)}, "
                f"{json.dumps(out)}")
            check(all(n == blocks for n in launches.values()), f"progressive launches {launches}, expected {blocks}")
            variant_check(f"progressive phase {phase} step {s}", out)
        progressive[phase] = {"trainable": len(trainable), "steps": rows}
    del kernel, twin
    torch.cuda.empty_cache()

    vocab = build_concept_vocab(captions, size=64, min_count=1)
    cbatch = {"images": batch["images"], "targets": concept_targets(captions, vocab)}
    kernel = CatLIPTrainer(cfg, params, vocab, CatLIPTrainConfig(), seed=HARNESS_SEED, device="cuda")
    twin = CatLIPTrainer(plain_cfg, params, vocab, CatLIPTrainConfig(), seed=HARNESS_SEED, device="cuda")
    trainable = [k for k in snapshot(kernel.params) if k.startswith(("clip/visual/", "head/"))]
    text_before = snapshot(kernel.params["clip"]["text"])
    catlip = []
    for s in range(VARIANT_STEPS):
        step_s, launches, out = twin_steps(torch, f"catlip step {s}", kernel, twin, cbatch, counted, trainable,
                                           first_still=False, grads_of=vision_block_leaf)
        for k, n in launches.items():
            totals[k] += n
        catlip.append({"step_s": step_s, "launches": launches, **out})
        log(f"catlip step {s}: {step_s:.4f} s, launches {json.dumps(launches)}, {json.dumps(out)}")
        check(all(n == blocks for n in launches.values()), f"catlip launches {launches}, expected {blocks}")
        variant_check(f"catlip step {s}", out)
    check(all(torch.equal(v, text_before[k]) for k, v in snapshot(kernel.params["clip"]["text"]).items()),
          "catlip moved the text tower")
    del kernel, twin, params, text_before
    torch.cuda.empty_cache()

    cfg_b = get_model_config(MODEL)
    params_b = init_clip_params(HARNESS_SEED, cfg_b)
    _, batch_b = variant_batch(torch, cfg_b, TRAIN_BATCH)
    pr_cfg = ProjectionTrainConfig(num_classes=VARIANT_CLASSES)
    proj = ProjectionTrainer(cfg_b, params_b, pr_cfg, seed=HARNESS_SEED, device="cuda")
    clip_before, heads_before = snapshot(proj.params["clip"]), snapshot(proj.params["heads"])
    t0 = time.perf_counter()
    losses = [proj.train_step(batch_b)["total_loss"] for _ in range(VARIANT_STEPS)]
    torch.cuda.synchronize()
    proj_step_s = (time.perf_counter() - t0) / VARIANT_STEPS
    check(all(math.isfinite(x) for x in losses), f"projection losses {losses}")
    check(all(torch.equal(v, clip_before[k]) for k, v in snapshot(proj.params["clip"]).items()),
          "the projection trainer moved the frozen CLIP")
    check(all(not torch.equal(v, heads_before[k]) for k, v in snapshot(proj.params["heads"]).items()),
          "a projection head did not move")
    twin_b = ProjectionTrainer(dataclasses.replace(cfg_b, attn_impl="plain"), params_b, pr_cfg,
                               seed=HARNESS_SEED, device="cuda")
    twin_b.params["heads"] = {k: {kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone()
                              for k, v in proj.params["heads"].items()}
    counted_f = counted[:2]
    for fn in counted_f:
        fn.launches = 0
    img, txt = proj.encode_projected(batch_b["images"], batch_b["tokens"])
    torch.cuda.synchronize()
    proj_launches = {fn.__name__: fn.launches for fn in counted_f}
    img_p, txt_p = twin_b.encode_projected(batch_b["images"], batch_b["tokens"])
    row_cos = float(min((img * img_p).sum(1).min(), (txt * txt_p).sum(1).min()))
    off_cos = float((rows_off_by(img, EMBED_MIN_COS, HARNESS_SEED) * img_p).sum(1).min())
    expected_f = cfg_b.vision.layers + cfg_b.text.layers
    log(f"projection trainer ({MODEL}, batch {TRAIN_BATCH}, bf16): losses {[round(x, 6) for x in losses]}, "
        f"{proj_step_s:.4f} s/step; encode_projected launches {json.dumps(proj_launches)} (expected "
        f"{expected_f} each), least row cosine to the plain twin {row_cos:.6f}, control (rows off by "
        f"{EMBED_MIN_COS}) {off_cos:.6f}")
    check(all(n == expected_f for n in proj_launches.values()), f"encode_projected launches {proj_launches}")
    check(row_cos >= EMBED_MIN_COS and off_cos < EMBED_MIN_COS,
          f"encode_projected rows {row_cos}, control {off_cos} (band {EMBED_MIN_COS})")
    for name, n in proj_launches.items():
        totals[name] += n
    del proj, twin_b, params_b
    torch.cuda.empty_cache()
    return {"launches": totals, "progressive": progressive, "catlip": catlip,
            "projection": {"losses": losses, "step_s": proj_step_s, "row_cos": row_cos},
            "phase_s": time.perf_counter() - t_phase}


# -- 17. the trainer levers, distillation and their CLIs ----------------------

LEVER_SEED = 18
LEVER_LORA_RANK = 16
LEVER_ACCUM, LEVER_CHUNKS = 2, 4
# patch_drop 0.1 keeps T = 1 + 518 (the kernel route, T >= 512); 0.5 keeps
# T = 1 + 288, which takes the plain composition in both packages
LEVER_DROP_KERNEL, LEVER_DROP_PLAIN = 0.1, 0.5
DISTILL_TEACHER, DISTILL_STUDENT, DISTILL_STEPS = "ViT-L/14", "ViT-B/32", 1  # steps cut from 2
# one step of TRAIN_BATCH each (cut from two for the script's time)
LORA_CLI_TRAIN, DISTILL_CLI_IMAGES = 32, 32
# the distillation step against its twin (the teacher on attn_impl="plain"):
# the teacher's unit rows by cosine, then the student's KD loss and gradients
# (every student leaf: the student runs the plain composition in both, so
# only the teacher's rows differ); bands about twice the gap measured on an
# H100 80GB HBM3 (700 W), see PERF.md
DISTILL_ROW_MIN_COS = 0.999
DISTILL_BANDS = (3e-3, 5e-3, 0.999)
# LoRA's factor gradients are rank-16 projections of the dense kernels'
# (dB = aᵀ·dW, dA = dW·bᵀ): their bf16 noise against the plain twin measured
# a least cosine of 0.99583 on an H100 80GB HBM3 (700 W), under the dense
# leaves' 0.9968 band; the factors' band is about twice that gap (the
# loss and norm bands are phase 6's)
LORA_BANDS = (STEP_BF16_BANDS[0], STEP_BF16_BANDS[1], 0.992)
# the projection trainer's loss (two linear heads and a hard-negative
# InfoNCE over the towers' features) sits further from its twin's than the
# fine-tune loss: 4.09e-4 measured on an H100 80GB HBM3 (700 W) with the
# gradients in the step band; its band is about twice that
PROJECTION_BANDS = (8e-4, STEP_BF16_BANDS[1], STEP_BF16_BANDS[2])
# train_sustained at its defaults (ViT-B/32, batch 256) but 16 steps over a
# pool of 8 batches (two cycles), cut from 320 steps over 32 (64 over 16
# until phase 18 came, 32 over 8 until phase 22 came) to keep the script in
# its time
SUSTAINED_ARGV = ["--device", "cuda", "--steps", "16", "--pool", "8"]


def lever_leaf(key: str) -> bool:
    """The vision blocks' leaves (phase 6's band), LoRA's factors there too."""
    return key.startswith(("clip/visual/blocks/", "lora/visual/blocks/"))


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def lever_steps(torch, what: str, cfg, plain_cfg, tc, master, batch, calls: int, compare_at=(0,),
                twin: bool = True, seed: int = LEVER_SEED, bands=STEP_BF16_BANDS, twin_calls: int = 1):
    """``calls`` calls of the kernel step (``make_train_step`` on ``cfg``) and
    of its ``plain_grad`` twin from copies of the same params (``master``, a
    tree on the card), batch and generator seed. Before each call in ``compare_at`` both gradients are taken at the
    kernel step's current params with one fresh generator seed and compared
    (``step_compare``, the vision blocks' leaves), held with ``bands`` (the
    step band) and, at call 0, returned (``g0``) with their loss. Each call's
    seconds, launches, the peak memory over the call and above the memory
    before it, the params left bit-equal or not and, where they moved, the
    least update cosines against the twin (reported, not held). Under
    ``MultiSteps`` the mean each emitting call hands its inner optimizer is
    kept (``emitted``). The twin steps on the first ``twin_calls`` calls only
    (one step against the twin a lever: cut from every call for the
    script's time; the gradients are held before call 1 in any case)."""
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.training import MultiSteps, TrainState, make_grad_fn, make_optimizer, make_train_step
    from evr_tpu_torch.training.partition import map_with_paths

    counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd]
    cls_cfg = lever_classifier_cfg(cfg)
    runs = {}
    for tag, mcfg in (("kernel", cfg),) + ((("twin", plain_cfg),) if twin else ()):
        params = map_with_paths(master, lambda _, t: t.clone())
        opt = make_optimizer(tc, params, 1)
        step, _ = make_train_step(mcfg, cls_cfg, tc, opt)
        runs[tag] = {"state": TrainState(params=params, opt_state=opt.init(params), step=0), "step": step,
                     "grad": make_grad_fn(mcfg, cls_cfg, tc), "opt": opt,
                     "gen": torch.Generator(device="cuda").manual_seed(seed)}
    emitted = []
    opt_k = runs["kernel"]["opt"]
    if isinstance(opt_k, MultiSteps):
        inner_apply = opt_k.inner.apply
        opt_k.inner.apply = lambda params, grads, state: emitted.append(grads) or inner_apply(params, grads, state)
    out = {"calls": [], "emitted": emitted}
    for c in range(calls):
        if c in compare_at and twin:
            params = runs["kernel"]["state"].params
            m_k, g_k = runs["kernel"]["grad"](params, batch, torch.Generator(device="cuda").manual_seed(seed + 100))
            m_p, g_p = runs["twin"]["grad"](params, batch, torch.Generator(device="cuda").manual_seed(seed + 100))
            got = step_compare(torch, f"{what}: gradients before call {c + 1}, kernels vs plain", m_k, m_p, g_k, g_p,
                               lever_leaf)
            step_check(f"{what}: gradients before call {c + 1}", got, bands)
            out.setdefault("grads", []).append(got)
            if c == 0:
                out["g0"], out["loss0"] = g_k, m_k["total_loss"]
            del g_p
        row = {}
        active = {tag: r for tag, r in runs.items() if tag == "kernel" or c < twin_calls}
        twin_now = "twin" in active
        befores = {tag: snapshot(r["state"].params) for tag, r in active.items()}
        for tag, r in active.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = {fn.__name__: fn.launches for fn in counted}
            t0 = time.perf_counter()
            r["state"], m = r["step"](r["state"], batch, r["gen"])
            torch.cuda.synchronize()
            row[f"{tag}_s"] = time.perf_counter() - t0
            row[f"{tag}_loss"] = m["total_loss"].item()
            row[f"{tag}_peak_gib"] = peak_gib(torch)
            row[f"{tag}_extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            if tag == "kernel":
                row["launches"] = {fn.__name__: fn.launches - start[fn.__name__] for fn in counted}
        after = {tag: snapshot(r["state"].params) for tag, r in active.items()}
        row["still"] = {tag: all(torch.equal(after[tag][k], befores[tag][k]) for k in befores[tag]) for tag in active}
        if twin_now and not row["still"]["kernel"]:
            keys = [k for k in after["kernel"] if not torch.equal(after["kernel"][k], befores["kernel"][k])]
            row["update_cos_worst"] = update_cosines(torch, befores["kernel"], after["kernel"], befores["twin"],
                                                     after["twin"], keys)["worst"]
        if twin_now:
            row["loss_rel"] = abs(row["kernel_loss"] - row["twin_loss"]) / abs(row["twin_loss"])
        log(f"{what} call {c + 1}: {json.dumps(row)}")
        check(math.isfinite(row["kernel_loss"]), f"{what} call {c + 1}: loss {row['kernel_loss']}")
        if twin_now:
            check(row["loss_rel"] <= STEP_BF16_BANDS[0], f"{what} call {c + 1}: losses apart by {row['loss_rel']}")
        out["calls"].append(row)
        del befores, after
    out["runs"] = runs
    return out


def lever_classifier_cfg(cfg):
    """The 3-class head the fine-tune CLI trains, with its dropout."""
    from evr_tpu_torch.models.classifier import ClassifierConfig

    return ClassifierConfig(embed_dim=cfg.embed_dim, num_classes=VARIANT_CLASSES)


def check_launches(what: str, launches: dict, attn_mlp: int, bwd: int) -> None:
    want = {"fused_attn_block": attn_mlp, "fused_mlp_block": attn_mlp,
            "fused_attn_block_bwd": bwd, "fused_mlp_block_bwd": bwd}
    check(launches == want, f"{what}: launches {launches}, expected {want}")


def add_launches(totals: dict, run: dict) -> None:
    for row in run["calls"]:
        for k, n in row.get("launches", {}).items():
            totals[k] = totals.get(k, 0) + n


def lora_after_two_steps(torch, cfg, plain_cfg, base: dict, runs: dict, batch) -> dict:
    """LoRA after two steps, a and b both non-zero. The factors' gradients
    are the dense kernels' projected (dA = s·dW·bᵀ, dB = s·aᵀ·dW, s =
    alpha / r). Two steps in, the classifier's and the temperature's Adam
    steps have halved the gradient, so the kernels' bf16 noise weighs about
    four times as much against it as at the initial point, where phase 6 set
    its band: the merged kernels' gradients and the factors' against the
    twin are reported, not held (PERF.md). Held: the LoRA step's loss
    bit-equal to the merged dense step's, and the factors' gradients equal
    to the chain rule of that dense gradient, which K5 computes."""
    from evr_tpu_torch.training import TrainConfig, make_grad_fn, merge_lora
    from evr_tpu_torch.training.finetune import flat_leaves
    from evr_tpu_torch.training.partition import map_with_paths

    kernel, twin = runs["kernel"], runs["twin"]
    params = kernel["state"].params
    alpha, rank = 16.0, LEVER_LORA_RANK

    def gen():
        return torch.Generator(device="cuda").manual_seed(LEVER_SEED + 200)

    m_lk, g_lk = kernel["grad"](params, batch, gen())
    m_lp, g_lp = twin["grad"](params, batch, gen())
    factors = step_compare(torch, "(c) lora after two steps: the factors, kernels vs plain (reported)", m_lk, m_lp,
                           g_lk, g_lp, lever_leaf)
    del g_lp
    with torch.no_grad():
        merged = merge_lora(params["clip"], params["lora"], alpha)
        dense = {"clip": map_with_paths(merged, lambda _, t: t.detach().clone()),
                 "classifier": map_with_paths(params["classifier"], lambda _, t: t.detach().clone())}
    del merged
    tc = TrainConfig(**dict(base, freeze_layers=0))  # every dense kernel's gradient
    m_dk, g_dk = make_grad_fn(cfg, lever_classifier_cfg(cfg), tc)(dense, batch, gen())
    dense_p = map_with_paths(dense, lambda _, t: t.detach().clone())
    m_dp, g_dp = make_grad_fn(plain_cfg, lever_classifier_cfg(cfg), tc)(dense_p, batch, gen())
    merged_cmp = step_compare(torch, "(c) lora after two steps: the merged kernels, kernels vs plain (reported)",
                              m_dk, m_dp, g_dk, g_dp, vision_block_leaf)
    del g_dp, dense_p
    lora_p = flat_leaves(params["lora"])
    chain = 0.0
    for key, g in g_lk.items():
        if not key.startswith("lora/visual/blocks/"):
            continue
        stem = key[len("lora/"):-2]  # "visual/blocks/<i>/<target path>"
        dw = (alpha / rank) * g_dk[f"clip/{stem}/kernel"]
        a, b = lora_p[stem + "/a"], lora_p[stem + "/b"]
        want = dw @ b.T if key.endswith("/a") else a.T @ dw
        chain = max(chain, ((g - want).abs().max() / want.abs().max()).item())
    same_loss = m_lk["total_loss"].item() == m_dk["total_loss"].item()
    log(f"(c) lora after two steps: loss {m_lk['total_loss'].item()!r}, the merged dense step's "
        f"{m_dk['total_loss'].item()!r}; the factors' gradients against the chain rule of the merged kernels' "
        f"(s dW b^T, s a^T dW): largest error {chain:.3e} of a leaf's largest entry")
    check(same_loss, "(c) lora: the LoRA step's loss differs from the merged dense step's")
    check(chain <= 1e-5, f"(c) lora: the factors' gradients off the chain rule by {chain}")
    del g_lk, g_dk, dense
    return {"factors": factors, "merged": merged_cmp, "chain_err": chain}


def phase_levers(torch) -> dict:
    """Phase 17's levers (a)-(h) at ViT-L/14@336px, batch 32, bf16,
    ``freeze_layers=8``, each against a ``plain_grad`` twin: (a) gradient
    accumulation over four calls, (b) Muon, (c) LoRA (rank 16, both towers),
    (d) remat (its gradients bit-equal to (a)'s, its step timed alone), (e)
    GradCache (4 chunks), (f) and (g) patch drop at T 519 (kernels) and 289
    (the plain composition, timed alone), (h) the projection trainer with
    its CLIP unfrozen and accumulation."""
    import dataclasses

    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.classifier import init_classifier_params
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.training import TrainConfig, init_lora, make_grad_fn
    from evr_tpu_torch.training.finetune import flat_leaves
    from evr_tpu_torch.training.muon import muon_direction
    from evr_tpu_torch.training.partition import map_with_paths
    from evr_tpu_torch.training.variants import ProjectionTrainConfig, ProjectionTrainer

    t_phase = time.perf_counter()
    cfg = get_model_config(TRAIN_MODEL)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain_grad")
    L = cfg.vision.layers
    np_params = {"clip": init_clip_params(LEVER_SEED, cfg),
                 "classifier": init_classifier_params(LEVER_SEED + 1, lever_classifier_cfg(cfg))}
    master = params_from_numpy(np_params, "cuda")  # never updated: each run takes a copy

    def fresh():
        return map_with_paths(master, lambda _, t: t.clone())

    _, batch = variant_batch(torch, cfg, TRAIN_BATCH)
    base = dict(seed=LEVER_SEED, batch_size=TRAIN_BATCH, epochs=1, compute_dtype="bfloat16", freeze_layers=8)
    totals: dict = {}
    out = {}

    # (a) gradient accumulation: call 1 bit-still, call 2 emits the mean
    # (calls cut from 4 for the script's time)
    a = lever_steps(torch, "(a) accumulation", cfg, plain_cfg, TrainConfig(**base, grad_accumulation_steps=LEVER_ACCUM),
                    master, batch, LEVER_ACCUM)
    add_launches(totals, a)
    for c, row in enumerate(a["calls"]):
        check_launches(f"(a) call {c + 1}", row["launches"], L, L)
        if c % 2 == 0:
            check(all(row["still"].values()), f"(a) call {c + 1} moved a param: {row['still']}")
        else:
            check(not any(row["still"].values()), f"(a) call {c + 1} left the params still")
    g1 = a.pop("g0")
    loss1 = a["loss0"]
    # the first emitted mean against the two calls' own gradients: call 2's
    # generator state follows call 1's draw
    r = a["runs"]["kernel"]
    gen = torch.Generator(device="cuda").manual_seed(LEVER_SEED)
    grad_k = r["grad"]
    _, g_1 = grad_k(fresh(), batch, gen)
    _, g_2 = grad_k(fresh(), batch, gen)
    mean = a["emitted"][0]
    errs = {k: (mean[k] - (g_1[k] + (g_2[k] - g_1[k]) / 2)).abs().max().item() / max(mean[k].abs().max().item(), 1e-30)
            for k in mean}
    mean_err = max(errs.values())
    inexact = sorted(k for k, e in errs.items() if e > 0)
    log(f"(a) the first emitted mean against the Welford mean of the two calls' own gradients: largest error "
        f"{mean_err:.3e} of a leaf's largest entry; leaves not bit-equal {inexact}")
    check(mean_err <= 1e-6, f"(a) emitted mean off by {mean_err}")
    out["a"] = {"calls": a["calls"], "grads": a["grads"], "mean_err": mean_err}
    del a, g_1, g_2, mean, r, grad_k
    torch.cuda.empty_cache()

    # (d) remat: bit-equal to (a)'s first call without remat; peak memory
    rcfg = dataclasses.replace(cfg, remat=True)
    tc_d = TrainConfig(**base, remat=True)
    params = fresh()
    m_r, g_r = make_grad_fn(rcfg, lever_classifier_cfg(cfg), tc_d)(params, batch,
                                                                torch.Generator(device="cuda").manual_seed(LEVER_SEED + 100))
    differ = sorted(k for k in g1 if not torch.equal(g_r[k], g1[k]))
    worst = max([0.0] + [((g_r[k] - g1[k]).abs().max() / g1[k].abs().max()).item() for k in differ])
    remat_equal = m_r["total_loss"].item() == loss1.item() and not differ
    log(f"(d) remat: loss {m_r['total_loss'].item()!r} against {loss1.item()!r} without remat; gradients not "
        f"bit-equal {differ} (largest error {worst:.3e} of a leaf's largest entry)")
    check(m_r["total_loss"].item() == loss1.item() and not any(lever_leaf(k) for k in differ) and worst <= 1e-6,
          f"(d) remat's gradients differ from the step's without remat: {differ}")
    del params, g_r
    torch.cuda.empty_cache()
    # its gradients are held above, bit-equal to (a)'s: the step is timed alone
    d = lever_steps(torch, "(d) remat", rcfg, None, tc_d, master, batch, 1, compare_at=(), twin=False)
    add_launches(totals, d)
    check_launches("(d)", d["calls"][0]["launches"], 2 * L, L)
    out["d"] = {"calls": d["calls"], "bit_equal": remat_equal}
    del d
    torch.cuda.empty_cache()

    # (e) GradCache: against the direct kernel step and its own twin
    tc_e = TrainConfig(**base, gradcache_chunks=LEVER_CHUNKS)
    params = fresh()
    m_e, g_e = make_grad_fn(cfg, lever_classifier_cfg(cfg), tc_e)(params, batch,
                                                               torch.Generator(device="cuda").manual_seed(LEVER_SEED + 100))
    direct = step_compare(torch, "(e) GradCache vs the direct kernel step", m_e, {"total_loss": loss1}, g_e, g1,
                          lever_leaf)
    step_check("(e) GradCache vs the direct kernel step", direct, STEP_BF16_BANDS)
    del params, g_e, g1
    torch.cuda.empty_cache()
    e = lever_steps(torch, "(e) GradCache", cfg, plain_cfg, tc_e, master, batch, 1)
    add_launches(totals, e)
    check_launches("(e)", e["calls"][0]["launches"], 2 * L * LEVER_CHUNKS, L * LEVER_CHUNKS)
    out["e"] = {"calls": e["calls"], "grads": e["grads"], "direct": direct}
    del e
    torch.cuda.empty_cache()

    # (b) Muon: the Newton-Schulz share of the step
    tc_b = TrainConfig(**base, optimizer="muon")
    b = lever_steps(torch, "(b) muon", cfg, plain_cfg, tc_b, master, batch, 2)
    add_launches(totals, b)
    for c, row in enumerate(b["calls"]):
        check_launches(f"(b) call {c + 1}", row["launches"], L, L)
    r = b["runs"]["kernel"]
    muon_keys = [k for k, lab in r["opt"].labels.items() if lab.endswith(":muon")]
    flat = flat_leaves(r["state"].params)
    grads = {k: torch.randn_like(flat[k]) for k in muon_keys}
    bufs = {k: torch.zeros_like(flat[k]) for k in muon_keys}
    ns_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in muon_keys:
            muon_direction(grads[k], bufs[k], tc_b.muon_momentum, True, tc_b.muon_ns_steps)
        torch.cuda.synchronize()
        ns_s.append(time.perf_counter() - t0)
    step_s = b["calls"][-1]["kernel_s"]
    log(f"(b) muon: {len(muon_keys)} Muon leaves; their Newton-Schulz directions {min(ns_s):.4f} s of the step's "
        f"{step_s:.4f} s ({100 * min(ns_s) / step_s:.1f} %)")
    out["b"] = {"calls": b["calls"], "grads": b["grads"], "ns_s": min(ns_s), "muon_leaves": len(muon_keys)}
    del b, r, flat, grads, bufs
    torch.cuda.empty_cache()

    # (c) LoRA rank 16 on both towers: the base bit-still; b at step 1, a and b at step 2
    lora = {**master, "lora": params_from_numpy(
        init_lora(torch.Generator().manual_seed(LEVER_SEED + 1), np_params["clip"], LEVER_LORA_RANK), "cuda")}
    c_run = lever_steps(torch, "(c) lora", cfg, plain_cfg, TrainConfig(**base, lora_rank=LEVER_LORA_RANK), lora, batch,
                        2, bands=LORA_BANDS)
    add_launches(totals, c_run)
    for c, row in enumerate(c_run["calls"]):
        check_launches(f"(c) call {c + 1}", row["launches"], L, L)
    base_still = {}
    for tag, r in c_run["runs"].items():
        got, want = flat_leaves(r["state"].params["clip"]), flat_leaves(master["clip"])
        base_still[tag] = all(torch.equal(got[k], want[k]) for k in want if k != "logit_scale")
    zero_a = [k for k in c_run["g0"] if k.endswith("/a")]
    a_zero = all(not c_run["g0"][k].any() for k in zero_a)
    log(f"(c) lora: the base bit-still {base_still}; every a gradient exactly 0 at step 1: {a_zero} "
        f"({len(zero_a)} factors); b held at step 1 ({c_run['grads'][0]['leaves']} leaves)")
    check(all(base_still.values()), f"(c) lora moved the base: {base_still}")
    check(a_zero and c_run["grads"][0]["leaves"] > 0, "(c) lora: the factors at step 1")
    c_run.pop("g0")
    c_after = lora_after_two_steps(torch, cfg, plain_cfg, base, c_run["runs"], batch)
    out["c"] = {"calls": c_run["calls"], "grads": c_run["grads"], **c_after}
    del c_run, lora
    torch.cuda.empty_cache()

    # (f) patch drop 0.1: T = 519 on the kernels; (g) 0.5: T = 289, no kernel
    f = lever_steps(torch, "(f) patch_drop 0.1", cfg, plain_cfg, TrainConfig(**base, patch_drop=LEVER_DROP_KERNEL),
                    master, batch, 1)
    add_launches(totals, f)
    check_launches("(f)", f["calls"][0]["launches"], L, L)
    f.pop("g0")
    out["f"] = {"calls": f["calls"], "grads": f["grads"]}
    del f
    g = lever_steps(torch, "(g) patch_drop 0.5", cfg, plain_cfg, TrainConfig(**base, patch_drop=LEVER_DROP_PLAIN),
                    master, batch, 1, compare_at=(), twin=False)
    add_launches(totals, g)
    for c, row in enumerate(g["calls"]):
        check_launches(f"(g) call {c + 1}", row["launches"], 0, 0)
    out["g"] = {"calls": g["calls"]}
    del g
    torch.cuda.empty_cache()

    # (h) the projection trainer, CLIP unfrozen (remat) with accumulation
    pcfg = ProjectionTrainConfig(num_classes=VARIANT_CLASSES, freeze_clip=False, grad_accumulation_steps=LEVER_ACCUM)
    kernel = ProjectionTrainer(cfg, master["clip"], pcfg, seed=LEVER_SEED, device="cuda")
    twin = ProjectionTrainer(plain_cfg, master["clip"], pcfg, seed=LEVER_SEED, device="cuda")
    check(kernel.model_cfg.remat and not kernel._infer_cfg.remat, "(h) the projection trainer's remat switch")
    (m_k, g_k), (m_p, g_p) = kernel.gradients(batch), twin.gradients(batch)
    h_grads = step_compare(torch, "(h) projection: gradients, kernels vs plain", m_k, m_p, g_k, g_p, lever_leaf)
    step_check("(h) projection: gradients", h_grads, PROJECTION_BANDS)
    del g_k, g_p
    counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd]
    h_calls = []
    # call 1 accumulates (still), call 2 emits; the twin steps on call 1 only
    # (calls cut from 4, the twin from every call, for the script's time)
    for c in range(LEVER_ACCUM):
        trainers = (kernel, twin) if c == 0 else (kernel,)
        before = [snapshot(t.params) for t in trainers]
        start = {fn.__name__: fn.launches for fn in counted}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk = kernel.train_step(batch)
        torch.cuda.synchronize()
        row = {"kernel_s": time.perf_counter() - t0,
               "launches": {fn.__name__: fn.launches - start[fn.__name__] for fn in counted}}
        if c == 0:
            t0 = time.perf_counter()
            mp = twin.train_step(batch)
            torch.cuda.synchronize()
            row["twin_s"] = time.perf_counter() - t0
            row["loss_rel"] = abs(mk["total_loss"] - mp["total_loss"]) / abs(mp["total_loss"])
        after = [snapshot(t.params) for t in trainers]
        row["still"] = [all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(after, before)]
        log(f"(h) projection call {c + 1}: {json.dumps(row)}")
        check_launches(f"(h) call {c + 1}", row["launches"], 2 * L, L)
        check(row.get("loss_rel", 0.0) <= PROJECTION_BANDS[0], f"(h) call {c + 1}: losses apart by {row.get('loss_rel')}")
        check(all(row["still"]) == (c % 2 == 0) and any(row["still"]) == (c % 2 == 0),
              f"(h) call {c + 1}: still {row['still']}")
        for k, n in row["launches"].items():
            totals[k] = totals.get(k, 0) + n
        h_calls.append(row)
        del before, after
    out["h"] = {"calls": h_calls, "grads": [h_grads]}
    del kernel, twin
    torch.cuda.empty_cache()
    out.update(launches=totals, phase_s=time.perf_counter() - t_phase)
    return out


def phase_distill(torch) -> dict:
    """(i) ``DistillationTrainer`` from a ViT-L/14 teacher (224 px) to a
    ViT-B/32 student, the KD term alone (embed dims 768 and 512), against a
    twin whose teacher runs ``attn_impl="plain"``: the teacher's forward runs
    K1/K2 (24 vision + 12 text launches a step) and no K5; the student takes
    the plain composition (T 50 and 77) in both."""
    import dataclasses

    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.training import DistillationTrainer, DistillConfig

    t_phase = time.perf_counter()
    t_cfg, s_cfg = get_model_config(DISTILL_TEACHER), get_model_config(DISTILL_STUDENT)
    teacher, student = init_clip_params(LEVER_SEED + 2, t_cfg), init_clip_params(LEVER_SEED + 3, s_cfg)
    dcfg = DistillConfig(contrastive_weight=0.0, kd_weight=1.0, align_weight=0.0)
    kernel = DistillationTrainer(s_cfg, student, t_cfg, teacher, dcfg, device="cuda")
    twin = DistillationTrainer(s_cfg, student, dataclasses.replace(t_cfg, attn_impl="plain"), teacher, dcfg,
                               device="cuda")
    del teacher, student
    _, batch = variant_batch(torch, s_cfg, TRAIN_BATCH)
    batch = {"images": batch["images"], "tokens": batch["tokens"]}
    ti_k, tt_k = (t.float().cpu().numpy() for t in kernel.teacher_features(batch))
    ti_p, tt_p = (t.float().cpu().numpy() for t in twin.teacher_features(batch))
    row_cos = float(min((ti_k * ti_p).sum(1).min(), (tt_k * tt_p).sum(1).min()))
    off_cos = float((rows_off_by(ti_k, DISTILL_ROW_MIN_COS, LEVER_SEED) * ti_p).sum(1).min())
    log(f"(i) distill: the teacher's unit rows, kernels vs plain: least cosine {row_cos:.7f}, control (rows off by "
        f"{DISTILL_ROW_MIN_COS}) {off_cos:.7f}")
    check(row_cos >= DISTILL_ROW_MIN_COS and off_cos < DISTILL_ROW_MIN_COS, f"(i) teacher rows {row_cos}, {off_cos}")
    (m_k, g_k), (m_p, g_p) = kernel.gradients(batch), twin.gradients(batch)
    m_k, m_p = ({"total_loss": m["kd_loss"]} for m in (m_k, m_p))
    grads = step_compare(torch, "(i) distill: KD loss and student gradients, kernels vs plain", m_k, m_p,
                         {f"clip/{k}": v for k, v in g_k.items()}, {f"clip/{k}": v for k, v in g_p.items()},
                         lambda k: True)
    step_check("(i) distill", grads, DISTILL_BANDS)
    del g_k, g_p
    counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd]
    totals = {fn.__name__: 0 for fn in counted}
    steps = []
    for s in range(DISTILL_STEPS):
        start = {fn.__name__: fn.launches for fn in counted}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk = kernel.train_step(batch)
        torch.cuda.synchronize()
        row = {"kernel_s": time.perf_counter() - t0,
               "launches": {fn.__name__: fn.launches - start[fn.__name__] for fn in counted}}
        t0 = time.perf_counter()
        mp = twin.train_step(batch)
        torch.cuda.synchronize()
        row.update(twin_s=time.perf_counter() - t0, kd_loss=mk["kd_loss"],
                   kd_rel=abs(mk["kd_loss"] - mp["kd_loss"]) / abs(mp["kd_loss"]))
        log(f"(i) distill step {s + 1}: {json.dumps(row)}")
        want = t_cfg.vision.layers + t_cfg.text.layers
        check_launches(f"(i) step {s + 1}", row["launches"], want, 0)
        # the first step from equal students; after it Adam's near-sign update
        # has moved the two students apart, so later steps are reported
        check(math.isfinite(mk["kd_loss"]) and (s > 0 or row["kd_rel"] <= DISTILL_BANDS[0]), f"(i) kd loss {row}")
        for k, n in row["launches"].items():
            totals[k] += n
        steps.append(row)
    del kernel, twin
    torch.cuda.empty_cache()
    return {"launches": totals, "steps": steps, "grads": grads, "row_cos": row_cos,
            "phase_s": time.perf_counter() - t_phase}


def served_bit_equal(torch, model: str, params, path: pathlib.Path, frames, counted) -> dict:
    """An engine on ``params`` (in memory) and the same engine after
    ``load_finetuned(path)``: their rows for ``frames`` (one batch) must be
    bit-equal; the launches of both encodes."""
    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine

    engine = EmbeddingEngine(model, params=params, device="cuda", batch_size=len(frames))
    start = {fn.__name__: fn.launches for fn in counted}
    ref = engine.encode_staged_images(frames)
    engine.load_finetuned(path, "file")
    check(engine.set_active_model("file"), f"{path.name}: not registered")
    got = engine.encode_staged_images(frames)
    launches = {fn.__name__: fn.launches - start[fn.__name__] for fn in counted}
    equal = np.array_equal(got, ref)
    log(f"serving {path.name}: {len(frames)} rows bit-equal to the in-memory engine's: {equal}; launches {launches}")
    check(equal and np.isfinite(got).all(), f"{path.name}: served rows differ from the in-memory engine's")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_lever_clis(torch) -> dict:
    """(j) ``tools.finetune.main --lora-rank 16`` at ViT-L/14@336px (two
    steps and a validation batch), its ``lora_merged.pt`` served bit-equal
    to ``merge_lora`` of the final state in memory, the trainer's own
    ``final_checkpoint.pt`` refused at serve time; (k) ``tools.distill.main``
    ViT-L/14 → ViT-B/32, its ``student.pt`` served the same way; (l)
    ``tools.train_sustained.main`` with its defaults but the steps
    (``SUSTAINED_ARGV``)."""
    from evr_tpu_torch.index.engine import load_torch_checkpoint
    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.models.torch_import import read_torch_file
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.tools import distill as distill_cli
    from evr_tpu_torch.tools import finetune as finetune_cli
    from evr_tpu_torch.tools import train_sustained
    from evr_tpu_torch.training import merge_lora

    counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd]
    totals = {fn.__name__: 0 for fn in counted}
    out = {}

    def since(start):
        return {fn.__name__: fn.launches - start[fn.__name__] for fn in counted}

    def add(launches):
        for k, n in launches.items():
            totals[k] += n

    cfg = get_model_config(TRAIN_MODEL)
    L = cfg.vision.layers
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train_json, val_json = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size,
                                                 n_train=LORA_CLI_TRAIN, n_val=TRAIN_BATCH)
        save = root / "lora"
        start = {fn.__name__: fn.launches for fn in counted}
        t0 = time.perf_counter()
        result, _ = quiet(finetune_cli.main, [
            "--train-json", str(train_json), "--val-json", str(val_json), "--data-dir", str(root),
            "--model", TRAIN_MODEL, "--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--seed", str(LEVER_SEED),
            "--save-dir", str(save), "--device", "cuda", "--lora-rank", str(LEVER_LORA_RANK)])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = since(start)
        add(launches)
        steps = LORA_CLI_TRAIN // TRAIN_BATCH
        log(f"(j) LoRA CLI: {steps} steps + 1 validation batch in {fit_s:.1f} s, launches {launches}; "
            f"history {json.dumps(result['history'][0])}")
        check_launches("(j) LoRA CLI", launches, L * (steps + 1), L * steps)
        check((save / "lora_merged.pt").exists(), "(j) no lora_merged.pt")
        try:
            load_torch_checkpoint(save / "final_checkpoint.pt")
            check(False, "(j) the LoRA trainer's final_checkpoint.pt served")
        except ValueError as e:
            check("lora_merged.pt" in str(e), f"(j) refusal {e}")
        final = read_torch_file(save / "final_checkpoint.pt")["params"]
        with torch.no_grad():
            merged = merge_lora(_to_cuda(torch, final["clip"]), _to_cuda(torch, final["lora"]), 16.0)
        del final
        frames = synthetic_frames(torch, TRAIN_BATCH, cfg.vision.image_size, cfg.vision.patch_size)
        served = served_bit_equal(torch, TRAIN_MODEL, merged, save / "lora_merged.pt", frames, counted)
        check(all(n == 2 * (L - 1) for k, n in served.items() if not k.endswith("_bwd")),
              f"(j) serving launches {served}")
        add(served)
        del merged
        out["lora_cli"] = {"fit_s": fit_s, "launches": launches, "served": served,
                           "val_loss": result["history"][0].get("val_total_loss")}

        t_cfg, s_cfg = get_model_config(DISTILL_TEACHER), get_model_config(DISTILL_STUDENT)
        droot = root / "distill"
        droot.mkdir()
        d_json, _ = write_caption_set(droot, s_cfg.vision.image_size, s_cfg.vision.patch_size,
                                      n_train=DISTILL_CLI_IMAGES, n_val=0)
        start = {fn.__name__: fn.launches for fn in counted}
        t0 = time.perf_counter()
        history, _ = quiet(distill_cli.main, [
            "--train-json", str(d_json), "--data-dir", str(droot), "--student-model", DISTILL_STUDENT,
            "--teacher-model", DISTILL_TEACHER, "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
            "--save-dir", str(droot / "out"), "--device", "cuda", "--seed", str(LEVER_SEED)])
        torch.cuda.synchronize()
        distill_s = time.perf_counter() - t0
        launches = since(start)
        add(launches)
        d_steps = DISTILL_CLI_IMAGES // TRAIN_BATCH
        log(f"(k) distill CLI: {d_steps} steps in {distill_s:.1f} s, launches {launches}; {json.dumps(history)}")
        check_launches("(k) distill CLI", launches, d_steps * (t_cfg.vision.layers + t_cfg.text.layers), 0)
        student = read_torch_file(droot / "out" / "student.pt")["params"]["clip"]
        frames = synthetic_frames(torch, TRAIN_BATCH, s_cfg.vision.image_size, s_cfg.vision.patch_size)
        served = served_bit_equal(torch, DISTILL_STUDENT, student, droot / "out" / "student.pt", frames, counted)
        check(all(n == 2 * (s_cfg.vision.layers - 1) for k, n in served.items() if not k.endswith("_bwd")),
              f"(k) serving launches {served}")
        add(served)
        out["distill_cli"] = {"seconds": distill_s, "launches": launches, "served": served,
                              "kd_loss": history[-1]["kd_loss"]}

    start = {fn.__name__: fn.launches for fn in counted}
    t0 = time.perf_counter()
    sustained, _ = quiet(train_sustained.main, SUSTAINED_ARGV)
    torch.cuda.synchronize()
    sustained_s = time.perf_counter() - t0
    launches = since(start)
    add(launches)
    b = get_model_config("ViT-B/32")
    holdout = 2 * (b.vision.layers + b.text.layers)
    log(f"(l) train_sustained ({' '.join(SUSTAINED_ARGV)}: {sustained['steps']} steps, batch 256) in "
        f"{sustained_s:.1f} s: "
        f"{sustained['sustained_ex_per_s']:.1f} examples/s; R@K before {json.dumps(sustained['before'])}, after "
        f"{json.dumps(sustained['after'])}; losses {sustained['first_loss']:.4f} -> {sustained['last_loss']:.4f}; "
        f"launches {launches} (expected {holdout} of K1/K2: the holdout encodes before and after)")
    check_launches("(l) train_sustained", launches, holdout, 0)
    check(sustained["after"]["R@5"] > sustained["before"]["R@5"], f"(l) no R@5 lift: {sustained}")
    out["sustained"] = {**sustained, "seconds": sustained_s, "launches": launches}
    out["launches"] = totals
    return out


# -- 18. the data axis: the sharded search, the mesh engine and sharded serving,
# data-parallel and FSDP steps, two processes on one card, the FSDP CLI ------

MESH_SEED = 19
MESH_ROWS, MESH_DIM, MESH_Q, MESH_K = 100_000, 512, 8, 10
MESH_SEARCH_SLOTS, MESH_TRAIN_SLOTS = 4, 2
MESH_STEPS_TIMED = 2
MESH_CLI_IMAGES = 80  # the CLI keeps 64 for training (two steps of 32) and 16 for validation
MESH_SCORE_TOL = 1e-5
# FSDP against data parallelism, update by update: the same gradients and an
# elementwise AdamW, so equal but for the atomics of plain backward ops
MESH_UPDATE_COS = 0.9999


def mesh_launch_counters():
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.adc import adc_list_scores
    from evr_tpu_torch.ops.retrieval import fused_topk

    return [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q, fused_topk,
            bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd, adc_list_scores]


def launches_since(start: dict) -> dict:
    return {fn.__name__: fn.launches - start[fn.__name__] for fn in mesh_launch_counters()}


def launches_now() -> dict:
    return {fn.__name__: fn.launches for fn in mesh_launch_counters()}


def add_into(totals: dict, launches: dict) -> None:
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n


def check_step_launches(what: str, launches: dict, n: int) -> None:
    """K1, K2, K5a and K5b ``n`` times each; K3, K4 and K7 never."""
    want = {k: (n if k.endswith(("attn_block", "mlp_block", "_bwd")) else 0) for k in launches}
    check(launches == want, f"{what}: launches {launches}, expected {want}")


def phase_mesh_search(torch) -> dict:
    """(a) ``FrameIndex(mesh=<4 slots>)`` over MESH_ROWS seeded unit rows of
    512 in bf16 and in int8 with per-row scales, searched under
    ``search_impl="pallas"`` (K4 on each slot: 4 launches a query batch) and
    ``"xla"``, held to the one-device index on the card: rows equal, scores
    within MESH_SCORE_TOL, globally and over two videos, the first of which
    ends two rows into the second shard (fewer than k of that shard's rows in
    range). A shard whose row offset is moved by one must fail. The p50 of a
    one-query search at 1 and 4 slots."""
    import numpy as np

    from evr_tpu_torch.index.store import FrameIndex
    from evr_tpu_torch.ops.retrieval import fused_topk
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.parallel.sharded_search import ShardedIndex, sharded_cosine_topk

    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    rows = torch.randn((MESH_ROWS, MESH_DIM), generator=gen, device="cuda")
    rows = (rows / rows.norm(dim=1, keepdim=True)).cpu().numpy()
    q = torch.randn((MESH_Q, MESH_DIM), generator=gen, device="cuda").cpu().numpy()
    mesh = get_mesh(MESH_SEARCH_SLOTS)
    per = -(-MESH_ROWS // MESH_SEARCH_SLOTS)
    per = -(-per // 128) * 128  # FrameIndex pads a shard to whole 128-row tiles
    videos = {"v0": rows[:per + 2], "v1": rows[per + 2:]}
    out = {"launches": {"fused_topk": 0}, "p50_ms": {}, "cases": 0}
    for dtype in ("bfloat16", "int8"):
        one, sharded = {}, {}
        for impl in ("pallas", "xla"):
            one[impl] = FrameIndex(embed_dim=MESH_DIM, device_dtype=dtype, search_impl=impl, device="cuda")
            sharded[impl] = FrameIndex(embed_dim=MESH_DIM, device_dtype=dtype, search_impl=impl, mesh=mesh)
            for ix in (one[impl], sharded[impl]):
                for name, emb in videos.items():
                    ix.add_video(name, emb)
                ix.build()
            shards = sharded[impl]._device_index
            check(isinstance(shards, ShardedIndex) and shards.n_shards == MESH_SEARCH_SLOTS
                  and shards.rows_per_shard == per, f"(a) {dtype}: the index is not split {MESH_SEARCH_SLOTS} x {per}")
            for video in (None, "v0", "v1"):
                s1, r1 = one[impl].search_raw(q, MESH_K, video)
                start = fused_topk.launches
                s4, r4 = sharded[impl].search_raw(q, MESH_K, video)
                n = fused_topk.launches - start
                out["launches"]["fused_topk"] += n
                want = MESH_SEARCH_SLOTS if impl == "pallas" else 0
                check(n == want, f"(a) {dtype} {impl} {video}: {n} K4 launches, expected {want}")
                check(np.array_equal(r4, r1), f"(a) {dtype} {impl} {video}: rows differ from the one-device index")
                diff = float(np.abs(s4 - s1).max())
                check(diff <= MESH_SCORE_TOL and np.isfinite(s4).all(),
                      f"(a) {dtype} {impl} {video}: scores apart by {diff}")
                check(all(len(set(r.tolist())) == MESH_K for r in r4), f"(a) {dtype} {impl} {video}: a row twice")
                out["cases"] += 1
                log(f"(a) sharded search {dtype} {impl} {video or 'all'}: rows equal to the one-device index's, "
                    f"scores within {diff:.2e}, K4 launches {n}")
            # p50 of one query at 1 and 4 slots, in turns
            lat = {"1 slot": [], f"{MESH_SEARCH_SLOTS} slots": []}
            for _ in range(20):
                for tag, ix in (("1 slot", one[impl]), (f"{MESH_SEARCH_SLOTS} slots", sharded[impl])):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ix.search_raw(q[:1], MESH_K)
                    lat[tag].append((time.perf_counter() - t0) * 1e3)
            out["p50_ms"][f"{dtype} {impl}"] = {t: statistics.median(v) for t, v in lat.items()}
        # the negative control: shard 1 holds the rows one place further on
        ix = sharded["pallas"]._device_index
        full, scales = ix.gathered()
        moved = [full[s * per + (s == 1):(s + 1) * per + (s == 1)].contiguous() for s in range(MESH_SEARCH_SLOTS)]
        moved_sc = None if scales is None else [scales[s * per + (s == 1):(s + 1) * per + (s == 1)].contiguous()
                                                for s in range(MESH_SEARCH_SLOTS)]
        moved[-1] = full[(MESH_SEARCH_SLOTS - 1) * per:].contiguous()
        if moved_sc is not None:
            moved_sc[-1] = scales[(MESH_SEARCH_SLOTS - 1) * per:].contiguous()
        with torch.inference_mode():
            _, r_bad = sharded_cosine_topk(mesh, moved, torch.from_numpy(q).cuda(), 0, MESH_ROWS, MESH_K,
                                           row_scales=moved_sc, impl="pallas")
        _, r1 = one["pallas"].search_raw(q, MESH_K)
        moved_ok = bool(np.array_equal(r_bad.cpu().numpy(), r1))
        log(f"(a) {dtype}: a shard's row offset moved by one: rows equal to the one-device index's: {moved_ok}")
        check(not moved_ok, f"(a) {dtype}: the row check passes a shard moved by one row")
        del one, sharded, ix, full, scales, moved, moved_sc
        torch.cuda.empty_cache()
    return out


def served_band_violations(got, ref, noise: float) -> int:
    """Two servers' events of the same queries (``served_events``): an event
    in one top-10 and not the other must score within ``noise`` of the
    reference's 10th score; common events within ``noise`` of each other."""
    bad = 0
    for g, r in zip(got, ref):
        cut = r[min(9, len(r) - 1)][2]
        rs = {(v, i): sc for v, i, sc in r}
        gs = {(v, i): sc for v, i, sc in g}
        for key in set(rs) ^ set(gs):
            bad += int(abs(rs.get(key, gs.get(key)) - cut) > noise)
        for key in set(rs) & set(gs):
            bad += int(abs(rs[key] - gs[key]) > noise)
    return bad


def shard_index_server(root: pathlib.Path, queries) -> tuple[list, str]:
    """``python -m evr_tpu_torch.serving --shard-index`` (a mesh of every
    local card) on the card, in a child process on a free localhost port: its events for
    ``queries`` (``/api/search``, text_clip, top 10) and its output. The
    child is stopped before this returns."""
    import socket
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logf = root / "server.log"
    with open(logf, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "evr_tpu_torch.serving", "--data-root", str(root), "--device", "cuda",
             "--model", MODEL, "--batch-size", str(BATCH), "--port", str(port), "--params-dtype", "bfloat16",
             "--shard-index"],
            stdout=fh, stderr=subprocess.STDOUT, cwd=str(pathlib.Path(__file__).resolve().parent))
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 180
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            check(proc.poll() is None, f"(b) the --shard-index server exited: {logf.read_text()[-2000:]}")
            check(time.time() < deadline, "(b) the --shard-index server did not come up")
            time.sleep(0.5)
        events = []
        for qt in queries:
            body = json.dumps({"query": qt, "search_type": "text", "search_method": "text_clip",
                               "top_k": 10}).encode()
            req = urllib.request.Request(base + "/api/search", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                check(r.status == 200, f"(b) --shard-index /api/search {qt!r}: HTTP {r.status}")
                got = json.loads(r.read())["events"]
            check(len(got) > 0, f"(b) --shard-index /api/search {qt!r}: no events")
            events.append([(e["videoId"], e["id"], e["clip_similarity"]) for e in got])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return events, logf.read_text()


def phase_mesh_engine(torch, frames) -> dict:
    """(b) ``EmbeddingEngine(mesh=<2 slots>)`` at ViT-B/32 through K1/K2 (bf16)
    and K3a/K3b (int8 weights): every encode batch split over the slots, the
    launches counted, unit rows (frames and texts) against the one-device
    engine's within EMBED_MIN_COS (rows off by that cosine rejected), and
    ``ServingContext(mesh=)`` over a data root of the one-device embeddings
    serving ``/api/search`` within the served bands of the one-device
    context; then ``python -m evr_tpu_torch.serving --shard-index`` in a child
    process, its six requests' events within the same bands."""
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.serving import ServingContext, create_app

    mesh = get_mesh(MESH_TRAIN_SLOTS)
    out = {"launches": {}}
    names = [f"video{v}" for v in range(N_VIDEOS)]
    per = N_FRAMES // N_VIDEOS
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, halves, noise in (("bfloat16", (bf.fused_attn_block, bf.fused_mlp_block), SERVED_RANK_NOISE),
                                     ("int8", (bf.fused_attn_block_q, bf.fused_mlp_block_q),
                                      INT8_SERVED_RANK_NOISE)):
            one = EmbeddingEngine(MODEL, device="cuda", params_dtype=dtype, batch_size=BATCH)
            two = EmbeddingEngine(MODEL, device="cuda", params_dtype=dtype, batch_size=BATCH, mesh=mesh)
            ref = one.encode_staged_images(frames, normalise=True)
            ref_t = one.encode_texts(list(QUERIES))
            two.encode_staged_images(frames[:BATCH])  # the replicas and libraries load
            start = launches_now()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = two.encode_staged_images(frames, normalise=True)
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
            got_t = two.encode_texts(list(QUERIES))
            launches = launches_since(start)
            add_into(out["launches"], launches)
            cfg = one.cfg
            want = (N_FRAMES // BATCH) * MESH_TRAIN_SLOTS * (cfg.vision.layers - 1) + \
                MESH_TRAIN_SLOTS * (cfg.text.layers - 1)
            for fn in halves:
                check(launches[fn.__name__] == want,
                      f"(b) {dtype}: {fn.__name__} launched {launches[fn.__name__]} times, expected {want}")
            cos = float((got * ref).sum(1).min())
            tcos = float((got_t * ref_t).sum(1).min())
            noise_rows = np.random.default_rng(3).standard_normal(got.shape).astype(np.float32)
            off = got + noise_rows * math.sqrt((1 / EMBED_MIN_COS**2 - 1) / got.shape[1])
            off /= np.linalg.norm(off, axis=1, keepdims=True)
            off_cos = float((off * ref).sum(1).min())  # the statistic the row check holds
            log(f"(b) mesh engine {dtype}, {MESH_TRAIN_SLOTS} slots: {N_FRAMES} frames in {encode_s:.3f} s "
                f"({N_FRAMES / encode_s:.1f} frames/s), launches {launches} (expected {want} of each half); "
                f"least unit-row cosine against the one-device engine: frames {cos:.7f}, texts {tcos:.7f}; "
                f"rows off by {EMBED_MIN_COS}: least {off_cos:.5f}")
            check(min(cos, tcos) >= EMBED_MIN_COS, f"(b) {dtype}: row cosine {min(cos, tcos)}")
            check(off_cos < EMBED_MIN_COS, f"(b) {dtype}: the row band passes rows off by {EMBED_MIN_COS}")
            root = pathlib.Path(tmp) / dtype
            write_data_root(root, names, [ref[v * per:(v + 1) * per] for v in range(N_VIDEOS)],
                            [frames[v * per:(v + 1) * per] for v in range(N_VIDEOS)])
            plain_ctx = ServingContext(root, engine=one)
            plain_ctx.boot()
            ref_events, _ = served_events(Client(create_app(plain_ctx)), QUERIES)
            mesh_ctx = ServingContext(root, engine=two, mesh=mesh)
            mesh_ctx.boot()
            check(mesh_ctx.index.mesh is mesh, f"(b) {dtype}: the served index is not on the mesh")
            start = launches_now()
            got_events, ms = served_events(Client(create_app(mesh_ctx)), QUERIES)
            served = launches_since(start)
            add_into(out["launches"], served)
            bad = served_band_violations(got_events, ref_events, noise)
            log(f"(b) sharded serving {dtype}: /api/search events against the one-device context's: {bad} "
                f"outside the {noise} band; p50 {statistics.median(ms):.2f} ms; launches {served}")
            check(bad == 0, f"(b) {dtype}: {bad} served events outside the band")
            want_t = cfg.text.layers * len(QUERIES)
            for fn in halves:
                check(served[fn.__name__] == want_t, f"(b) {dtype} serving: {fn.__name__} {served[fn.__name__]}")
            out[dtype] = {"frame_cos": cos, "text_cos": tcos, "encode_frames_per_s": N_FRAMES / encode_s,
                          "served_p50_ms": statistics.median(ms)}
            if dtype == "bfloat16":
                t0 = time.perf_counter()
                cli_events, text = shard_index_server(root, QUERIES)
                bad = served_band_violations(cli_events, ref_events, noise)
                booted = f"sharding over {{'data': {torch.cuda.device_count()}}} mesh" in text
                log(f"(b) python -m evr_tpu_torch.serving --shard-index: booted {booted}, "
                    f"{len(cli_events)} requests, {bad} events outside the {noise} band, "
                    f"{time.perf_counter() - t0:.1f} s with its start")
                check(booted and bad == 0, f"(b) --shard-index server: booted {booted}, {bad} off the band")
            del one, two, plain_ctx, mesh_ctx
            torch.cuda.empty_cache()
    return out


def mesh_train_setup(torch):
    """(config, classifier config, params on the card, batch, TrainConfig)
    of phase 18's steps: ViT-L/14@336px from MESH_SEED, batch 32, bf16,
    ``freeze_layers=8``, the 3-class head with its dropout."""
    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.classifier import init_classifier_params
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.training import TrainConfig

    cfg = get_model_config(TRAIN_MODEL)
    cls_cfg = lever_classifier_cfg(cfg)
    master = params_from_numpy({"clip": init_clip_params(MESH_SEED, cfg),
                                "classifier": init_classifier_params(MESH_SEED + 1, cls_cfg)}, "cuda")
    _, batch = variant_batch(torch, cfg, TRAIN_BATCH)
    tc = TrainConfig(seed=MESH_SEED, batch_size=TRAIN_BATCH, epochs=1, compute_dtype="bfloat16", freeze_layers=8)
    return cfg, cls_cfg, master, batch, tc


def phase_mesh_steps(torch, cfg, cls_cfg, master, batch, tc) -> dict:
    """(c) the gradients of one step over 2 slots (each 16 rows of the global
    batch of 32) against the 1-slot step from the same params, batch and
    generator (the step bands; a gradient turned to cosine 0.99 rejected),
    K1/K2 and K5a/K5b 24 launches a slot; then timed steps with the
    optimizer at 1 and 2 slots and under FSDP over 2 slots (its first loss
    that of data parallelism within 1e-6, its updates after the steps within
    cosine MESH_UPDATE_COS of data parallelism's leaf by leaf, the bytes a
    slot holds against the replicated state's)."""
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.parallel.fsdp import fsdp_state_shardings, gather_tree, shard_tree, sharded_bytes_per_device
    from evr_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from evr_tpu_torch.training.finetune import flat_leaves, make_grad_fn
    from evr_tpu_torch.training.partition import map_with_paths

    L = cfg.vision.layers
    out = {"launches": {}}
    grads = {}
    for n in (1, MESH_TRAIN_SLOTS):
        mesh = get_mesh(n)
        fn = make_grad_fn(cfg, cls_cfg, tc, mesh)
        start = launches_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, g = fn({mesh.local_devices[0]: master}, batch, torch.Generator(device="cuda").manual_seed(MESH_SEED))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launches_since(start)
        add_into(out["launches"], launches)
        log(f"(c) gradients over {n} slot(s): {secs:.3f} s, launches {launches}, loss {m['total_loss'].item():.6f}")
        check_step_launches(f"(c) {n} slot(s)", launches, n * L)
        grads[n] = (m, g)
    (m1, g1), (m2, g2) = grads[1], grads[MESH_TRAIN_SLOTS]
    got = step_compare(torch, f"(c) {MESH_TRAIN_SLOTS} slots vs 1 slot", m2, m1, g2, g1, vision_block_leaf)
    step_check(f"(c) {MESH_TRAIN_SLOTS} slots vs 1 slot", got, STEP_BF16_BANDS)
    out["grads"] = got
    ref = {"metrics": {k: v.item() for k, v in m2.items()}, "norm": global_norm_of(torch, g2),
           "vision": {k: v for k, v in g2.items() if vision_block_leaf(k)}}
    del grads, g1, g2
    torch.cuda.empty_cache()

    finals, out["s_per_step"], out["loss_first"] = {}, {}, {}
    for tag, n, fsdp in (("1 slot", 1, False), (f"{MESH_TRAIN_SLOTS} slots", MESH_TRAIN_SLOTS, False),
                         (f"fsdp {MESH_TRAIN_SLOTS} slots", MESH_TRAIN_SLOTS, True)):
        mesh = get_mesh(n)
        params = map_with_paths(master, lambda _, t: t.clone())
        opt = make_optimizer(tc, params)
        sh = None
        if fsdp:
            sh = fsdp_state_shardings(params, opt, mesh)
            whole = sum(t.numel() * t.element_size() for t in list(flat_leaves(params).values())
                        + [v for v in flat_leaves(opt.init(params)).values() if hasattr(v, "numel")])
            state = TrainState(shard_tree(params, sh.params), shard_tree(opt.init(params), sh.opt_state), 0)
            del params
            slot_bytes = sharded_bytes_per_device((state.params, state.opt_state))
            out["bytes"] = {"slot": slot_bytes, "replicated": whole}
            log(f"(c) FSDP over {n} slots: {slot_bytes / 2**30:.3f} GiB of params and AdamW moments a slot "
                f"(sharded_bytes_per_device) against {whole / 2**30:.3f} GiB replicated")
            check(slot_bytes < 0.75 * whole, f"(c) FSDP holds {slot_bytes} of {whole} bytes a slot")
        else:
            state = TrainState(params, opt.init(params), 0)
        step, _ = make_train_step(cfg, cls_cfg, tc, opt, mesh=mesh, state_shardings=sh)
        gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
        secs = []
        start = launches_now()
        for i in range(MESH_STEPS_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                out["loss_first"][tag] = m["total_loss"].item()
            check(math.isfinite(m["total_loss"].item()), f"(c) {tag} step {i + 1}: loss {m['total_loss'].item()}")
        launches = launches_since(start)
        add_into(out["launches"], launches)
        check_step_launches(f"(c) {tag} steps", launches, MESH_STEPS_TIMED * n * L)
        out["s_per_step"][tag] = secs
        log(f"(c) {tag}: s/step {[round(s, 4) for s in secs]}, first loss {out['loss_first'][tag]:.6f}, "
            f"launches {launches}")
        if n == MESH_TRAIN_SLOTS:
            after = flat_leaves(gather_tree(state.params) if fsdp else state.params)
            before = flat_leaves(master)
            finals[tag] = {k: (after[k] - before[k]).float() for k in after}
        del state, step, opt
        torch.cuda.empty_cache()
    dp, fs = finals[f"{MESH_TRAIN_SLOTS} slots"], finals[f"fsdp {MESH_TRAIN_SLOTS} slots"]
    equal = sum(bool(torch.equal(dp[k], fs[k])) for k in dp)
    cos = leaf_cosines(torch, fs, dp)
    worst = min(cos.values())
    loss_rel = abs(out["loss_first"][f"fsdp {MESH_TRAIN_SLOTS} slots"] - out["loss_first"][f"{MESH_TRAIN_SLOTS} slots"]) \
        / abs(out["loss_first"][f"{MESH_TRAIN_SLOTS} slots"])
    log(f"(c) FSDP against data parallelism: first losses apart by {loss_rel:.2e}; after {MESH_STEPS_TIMED} steps "
        f"{equal} of {len(dp)} leaves' updates bit-equal, the least update cosine {worst:.7f}")
    check(loss_rel <= 1e-6, f"(c) FSDP's first loss apart from data parallelism's by {loss_rel}")
    check(worst >= MESH_UPDATE_COS, f"(c) an FSDP update at cosine {worst} to data parallelism's")
    out["fsdp_vs_dp"] = {"loss_rel": loss_rel, "bit_equal_leaves": equal, "leaves": len(dp), "least_update_cos": worst}
    del finals, dp, fs
    torch.cuda.empty_cache()
    out["ref"] = ref
    return out


def global_norm_of(torch, grads: dict) -> float:
    from evr_tpu_torch.training.finetune import global_norm

    return global_norm(grads.values()).item()


def mesh_worker(workdir: pathlib.Path) -> int:
    """One process of phase 18 (d), started by ``tools.pod_launch``: joins the
    group (``multihost.bootstrap``), takes its rows of the global batch and
    runs the gradients of one step over the global mesh (one slot a process,
    both on this card); the coordinator writes the gradients of the vision
    blocks (rounded to bf16 for the file), the metrics and the norm of every
    leaf to ``workdir``."""
    import numpy as np
    import torch

    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.parallel import multihost as mh
    from evr_tpu_torch.training import TrainConfig
    from evr_tpu_torch.training.finetune import make_grad_fn

    pid, n = mh.bootstrap(device="cuda")
    mesh = mh.global_mesh()
    dev = mesh.local_devices[0]
    print(f"process {pid} of {n}: backend {mh.backend()}, mesh {mesh.shape}, device {dev}", flush=True)
    cfg = get_model_config(TRAIN_MODEL)
    cls_cfg = lever_classifier_cfg(cfg)
    params = params_from_numpy(torch.load(workdir / "params.pt", mmap=True, weights_only=True), dev)
    with np.load(workdir / "batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    rows = mh.process_slice(len(batch["images"]))
    local = {k: v[rows] for k, v in batch.items()}
    tc = TrainConfig(seed=MESH_SEED, batch_size=TRAIN_BATCH, epochs=1, compute_dtype="bfloat16", freeze_layers=8)
    fn = make_grad_fn(cfg, cls_cfg, tc, mesh)
    start = launches_now()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, g = fn({dev: params}, local, torch.Generator(device=dev).manual_seed(MESH_SEED))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launches_since(start)
    if mh.is_coordinator():
        torch.save({"metrics": {k: v.item() for k, v in m.items()}, "norm": global_norm_of(torch, g),
                    "vision": {k: v.to(torch.bfloat16).cpu() for k, v in g.items() if vision_block_leaf(k)}},
                   workdir / "result.pt")
    mh.barrier()
    print("MESHWORKER " + json.dumps({"process": pid, "processes": n, "backend": mh.backend(),
                                      "seconds": secs, "launches": launches}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def phase_mesh_processes(torch, master, batch, ref) -> dict:
    """(d) two processes on the one card through ``tools.pod_launch`` (each
    one slot, half of the global batch of 32; Gloo, as NCCL refuses two
    ranks on one card): their step's gradients held to (c)'s 2-slot step in
    the step bands. A failed run fails the phase."""
    import numpy as np

    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.training.partition import map_with_paths

    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        torch.save(map_with_paths(master, lambda _, t: t.detach().cpu()), work / "params.pt")
        np.savez(work / "batch.npz", **{k: np.asarray(v) for k, v in batch.items()})
        n, want = 2, ref
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "evr_tpu_torch.tools.pod_launch", "-n", str(n), "--",
             sys.executable, str(pathlib.Path(__file__).resolve()), "--mesh-worker", str(work)],
            capture_output=True, text=True, timeout=600, cwd=str(pathlib.Path(__file__).resolve().parent))
        secs = time.perf_counter() - t0
        lines = [json.loads(line.split("MESHWORKER ", 1)[1]) for line in proc.stdout.splitlines()
                 if "MESHWORKER " in line]
        for line in proc.stdout.splitlines():
            if "backend" in line and "MESHWORKER" not in line:
                log(f"(d) {line.strip()}")
        check(proc.returncode == 0 and len(lines) == n,
              f"(d) {n} processes on the card failed (exit {proc.returncode}): "
              f"{(proc.stdout + proc.stderr)[-3000:]}")
        out["processes"], out["backend"], out["seconds"] = n, lines[0]["backend"], secs
        for row in lines:
            add_into(out["launches"], row["launches"])
            check_step_launches(f"(d) process {row['process']}", row["launches"],
                                get_model_config(TRAIN_MODEL).vision.layers)
        res = torch.load(work / "result.pt", weights_only=True)
    vision = {k: v.cuda().float() for k, v in res["vision"].items()}
    metrics = {k: torch.tensor(v) for k, v in res["metrics"].items()}
    ref_metrics = {k: torch.tensor(v) for k, v in want["metrics"].items()}
    got = step_compare(torch, f"(d) {n} processes vs the 2-slot step", metrics,
                       ref_metrics, vision, want["vision"], vision_block_leaf)
    norm_rel = abs(res["norm"] - want["norm"]) / want["norm"]
    got["norm_rel"] = max(got["norm_rel"], norm_rel)
    log(f"(d) {n} processes, backend {out['backend']}: {secs:.1f} s with the launch; every leaf's norm "
        f"apart by {norm_rel:.2e}; launches {out['launches']}")
    step_check(f"(d) {n} processes", got, STEP_BF16_BANDS)
    out["grads"] = got
    return out


def phase_mesh_cli(torch) -> dict:
    """(e) ``tools.finetune.main --fsdp`` at ViT-L/14@336px over the default
    mesh (every local card): two steps of 32 with an autosave after the
    first; then a run resumed from that autosave, whose first step is the
    saved run's second: its contrastive loss (no dropout in it) equal bit
    for bit. The CLI's other checkpoint files (step 2's autosave, best and
    final, 5 GB each) are not written, for the script's time: phase 6 and
    phase 17's (j) write and read them."""
    import shutil

    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.tools import finetune as finetune_cli
    from evr_tpu_torch.training import finetune as ft

    cfg = get_model_config(TRAIN_MODEL)
    L = cfg.vision.layers
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train_json, _ = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size,
                                          n_train=MESH_CLI_IMAGES, n_val=0)
        save = root / "ck"
        losses, make = [], ft.make_train_step

        def recording(*args, **kwargs):
            step, eval_step = make(*args, **kwargs)

            def recorded(state, batch, generator=None):
                if len(losses) == 1 and (save / "autosave.pt").exists():
                    shutil.copy(save / "autosave.pt", save / "resume.pt")  # the autosave of step 1
                state, m = step(state, batch, generator)
                losses.append(m["contrastive_loss"].item())
                return state, m

            return recorded, eval_step

        argv = ["--train-json", str(train_json), "--data-dir", str(root), "--model", TRAIN_MODEL,
                "--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--seed", str(MESH_SEED),
                "--save-dir", str(save), "--device", "cuda", "--fsdp"]
        real_save = ft.Trainer.save_checkpoint

        def first_autosave_only(self, name, *args, **kwargs):
            if name == "autosave" and not (save / "resume.pt").exists():
                real_save(self, name, *args, **kwargs)

        ft.make_train_step, ft.Trainer.save_checkpoint = recording, first_autosave_only
        try:
            start = launches_now()
            t0 = time.perf_counter()
            _, text_a = quiet(finetune_cli.main, argv + ["--save-every-steps", "1"])
            torch.cuda.synchronize()
            out["run_s"] = time.perf_counter() - t0
            saved = list(losses)
            t0 = time.perf_counter()
            _, text_b = quiet(finetune_cli.main, argv + ["--resume-from", "resume"])
            torch.cuda.synchronize()
            out["resume_s"] = time.perf_counter() - t0
            launches = launches_since(start)
        finally:
            ft.make_train_step, ft.Trainer.save_checkpoint = make, real_save
        add_into(out["launches"], launches)
        resumed = losses[len(saved):]
        mesh_line = [line for line in text_a.splitlines() if line.startswith("mesh ")]
        log(f"(e) tools.finetune --fsdp: {mesh_line}; run {out['run_s']:.1f} s, contrastive losses {saved}; "
            f"resumed from step 1's autosave {out['resume_s']:.1f} s, losses {resumed}; launches {launches}")
        check(bool(mesh_line) and mesh_line[0].endswith("fsdp"), f"(e) no FSDP mesh: {text_a[-1500:]}")
        check(len(saved) == 2 and len(resumed) == 1, f"(e) steps {saved} then {resumed}")
        check("resumed from resume mid-epoch 0 (skipping 1 consumed batches)" in text_b, f"(e) {text_b[-1500:]}")
        check(resumed[0] == saved[1], f"(e) the resumed step's loss {resumed[0]} is not the saved run's {saved[1]}")
        check_step_launches("(e) tools.finetune --fsdp", launches, 3 * L)
        out["losses"] = {"run": saved, "resumed": resumed}
    return out


def phase_mesh(torch, frames) -> dict:
    """Phase 18, the data axis: (a) the sharded exact search, (b) the mesh
    engine and sharded serving, (c) data-parallel and FSDP steps, (d) two
    processes on the card, (e) the FSDP CLI with its resume."""
    t0 = time.perf_counter()
    out = {"launches": {}}
    search = phase_mesh_search(torch)
    engine = phase_mesh_engine(torch, frames)
    cfg, cls_cfg, master, batch, tc = mesh_train_setup(torch)
    steps = phase_mesh_steps(torch, cfg, cls_cfg, master, batch, tc)
    ref = steps.pop("ref")
    procs = phase_mesh_processes(torch, master, batch, ref)
    del master, ref
    torch.cuda.empty_cache()
    cli = phase_mesh_cli(torch)
    for part in (search, engine, steps, procs, cli):
        add_into(out["launches"], part["launches"])
    out.update(search=search, engine=engine, steps=steps, processes=procs, cli=cli,
               seconds=time.perf_counter() - t0)
    return out


# -- 19. the other mesh axes: the sharded IVF / IVF-PQ tiers (K7), pipelined
# encodes (K1/K2, K3a/K3b), sequence parallelism, tensor-parallel steps
# (K1/K2, K5), GradCache, Muon and accumulation over a mesh, checkpoints ------

AXES_SEED = 20
AXES_SLOTS = 4
# IVF at a full probe over 128 lists a shard; IVF-PQ with ~sqrt(rows a shard)
# lists (as FrameIndex sizes them: 316 at 1 slot, 158 at 4); its exact check
# re-ranks the whole candidate depth of a full probe (every row: on these
# random rows a 2,000-deep re-rank missed true top-10 rows, scores 8.4e-3 off)
AXES_LISTS, AXES_NPROBE, AXES_RERANK, AXES_TIMED = 128, 32, MESH_ROWS, 20
AXES_SERVE_LISTS = 8  # the served data root: 1,024 rows over 4 slots, probed whole
AXES_MICRO = 4
AXES_SP_BATCH, AXES_SP_SLOTS = 8, (2, 4)
AXES_ADC_TOL = dict(rtol=1e-4, atol=1e-5)


def turned_rows(np, rows, cos: float, seed: int):
    """Unit rows each turned by a random direction to cosine ``cos`` of
    themselves (the negative control of a row band)."""
    noise = np.random.default_rng(seed).standard_normal(rows.shape).astype(np.float32)
    off = rows + noise * math.sqrt((1 / cos**2 - 1) / rows.shape[1])
    return off / np.linalg.norm(off, axis=1, keepdims=True)


def unit(np, x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def phase_axes_ann(torch, frames) -> dict:
    """(a) The sharded ANN tiers over AXES_SLOTS slots of the card, on phase
    18's 100,000 x 512 unit rows: ``ShardedIVFIndex`` at a full probe against
    the one-device exact search (rows equal, scores within
    MESH_SCORE_TOL); ``ShardedIVFPQIndex`` at a full probe re-ranking the
    whole candidate depth (exact rows); its ADC search at nprobe
    AXES_NPROBE through K7 (``adc_impl="pallas"``) against the gather-sum
    (same rows, scores within AXES_ADC_TOL); a shard's row offset moved by
    one must fail; the p50 at nprobe AXES_NPROBE at 1 and 4 slots, and
    recall@10; then ``ServingContext(mesh=, search_impl="ivfpq")`` at a full
    probe, its events within the served band of the one-device exact
    context's."""
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.index.ivfpq import probe_step
    from evr_tpu_torch.ops.adc import adc_list_scores
    from evr_tpu_torch.ops.topk import cosine_topk
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.parallel.sharded_ann import ShardedIVFIndex, ShardedIVFPQIndex
    from evr_tpu_torch.serving import ServingContext, create_app

    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    x = torch.randn((MESH_ROWS, MESH_DIM), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    rows = x.cpu().numpy()
    q = perturbed(torch, x, list(range(0, MESH_ROWS, MESH_ROWS // MESH_Q))[:MESH_Q], 0.05, AXES_SEED)
    with torch.inference_mode():
        es, er = cosine_topk(x, torch.from_numpy(q).cuda(), 0, MESH_ROWS, MESH_K)
    es, er = es.cpu().numpy(), er.cpu().numpy()
    mesh = get_mesh(AXES_SLOTS)
    out = {"launches": {}, "seconds": {}}
    start = launches_now()
    t0 = time.perf_counter()
    ivf = ShardedIVFIndex(mesh).build(rows, n_clusters=AXES_LISTS, seed=AXES_SEED)
    out["seconds"]["ivf_build"] = time.perf_counter() - t0
    s, r = ivf.search(q, MESH_K, nprobe=AXES_LISTS)
    diff = float(np.abs(s - es).max())
    log(f"(a) ShardedIVFIndex over {AXES_SLOTS} slots, {MESH_ROWS} x {MESH_DIM}, {AXES_LISTS} lists a shard "
        f"(built in {out['seconds']['ivf_build']:.2f} s): full probe rows equal to the exact search's "
        f"{np.array_equal(r, er)}, scores within {diff:.2e}")
    check(np.array_equal(r, er) and diff <= MESH_SCORE_TOL, f"(a) sharded IVF at a full probe: rows or {diff}")
    want = np.arange(ivf.offsets[1] + 5, ivf.offsets[1] + 5 + MESH_Q)  # self-queries of shard 1
    ivf.offsets[1] += 1
    _, r_bad = ivf.search(rows[want], 1, nprobe=AXES_LISTS)
    ivf.offsets[1] -= 1
    _, r_ok = ivf.search(rows[want], 1, nprobe=AXES_LISTS)
    log(f"(a) a shard's row offset moved by one: self-queries found {int((r_bad[:, 0] == want).sum())} of "
        f"{MESH_Q} (restored: {int((r_ok[:, 0] == want).sum())})")
    check(not np.array_equal(r_bad[:, 0], want) and np.array_equal(r_ok[:, 0], want),
          "(a) the row check passes a shard offset moved by one")
    del ivf
    pq = {}
    for n in (1, AXES_SLOTS):
        t0 = time.perf_counter()
        pq[n] = ShardedIVFPQIndex(get_mesh(n)).build(rows, n_clusters=int(round(math.sqrt(MESH_ROWS / n))),
                                                     seed=AXES_SEED)
        out["seconds"][f"ivfpq_build_{n}"] = time.perf_counter() - t0
    sharded = pq[AXES_SLOTS]
    s, r = sharded.search(q, MESH_K, nprobe=sharded.n_clusters, rerank=AXES_RERANK)
    diff = float(np.abs(s - es).max())
    log(f"(a) ShardedIVFPQIndex over {AXES_SLOTS} slots (built in {out['seconds'][f'ivfpq_build_{AXES_SLOTS}']:.2f}"
        f" s): full probe + re-rank {AXES_RERANK} rows equal to the exact search's {np.array_equal(r, er)}, "
        f"scores within {diff:.2e}")
    check(np.array_equal(r, er) and diff <= MESH_SCORE_TOL, f"(a) sharded IVF-PQ re-ranked: rows or {diff}")
    k7 = adc_list_scores.launches
    sp_, rp = sharded.search(q, MESH_K, nprobe=AXES_NPROBE, adc_impl="pallas")
    k7 = adc_list_scores.launches - k7
    sx, rx = sharded.search(q, MESH_K, nprobe=AXES_NPROBE, adc_impl="xla")
    same = bool(np.array_equal(rp, rx)) and bool(np.allclose(sp_, sx, **AXES_ADC_TOL))
    log(f"(a) K7 (adc_impl='pallas') against the gather-sum at nprobe {AXES_NPROBE}: rows equal "
        f"{np.array_equal(rp, rx)}, scores within {float(np.abs(sp_ - sx).max()):.2e}; K7 launches {k7} a "
        f"search of {MESH_Q} queries")
    nprobe = max(1, min(AXES_NPROBE, sharded.n_clusters))
    planned = sum(math.ceil(nprobe / probe_step("pallas", MESH_Q, sub._capacity, sub.codebooks.shape[0]))
                  for sub in sharded.shards)  # one launch a shard and probe chunk
    check(same and k7 == planned, f"(a) K7 against the gather-sum: same {same}, {k7} launches of {planned} planned")
    out["k7_launches_per_search"] = k7
    recall = {}
    for tag, kw in (("adc", {}), ("rerank 50", {"rerank": 50})):
        _, rr = sharded.search(q, MESH_K, nprobe=AXES_NPROBE, adc_impl="pallas", **kw)
        recall[tag] = float(np.mean([len(set(a) & set(b)) / MESH_K for a, b in zip(rr, er)]))
    lat = {f"{n} slot(s)": [] for n in pq}
    for _ in range(AXES_TIMED):
        for n, ix in pq.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ix.search(q[:1], MESH_K, nprobe=AXES_NPROBE, adc_impl="pallas")
            lat[f"{n} slot(s)"].append((time.perf_counter() - t0) * 1e3)
    out["p50_ms"] = {k: statistics.median(v) for k, v in lat.items()}
    out["recall@10"] = recall
    log(f"(a) IVF-PQ p50, one query at nprobe {AXES_NPROBE} through K7: "
        + json.dumps({k: round(v, 3) for k, v in out["p50_ms"].items()}) + f"; recall@10 {json.dumps(recall)}")
    del pq, sharded
    torch.cuda.empty_cache()

    # the served tier: a data root of the bf16 engine's frame embeddings
    one = EmbeddingEngine(MODEL, device="cuda", params_dtype="bfloat16", batch_size=BATCH)
    ref = one.encode_staged_images(frames, normalise=True)
    names = [f"video{v}" for v in range(N_VIDEOS)]
    per = N_FRAMES // N_VIDEOS
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_data_root(root, names, [ref[v * per:(v + 1) * per] for v in range(N_VIDEOS)],
                        [frames[v * per:(v + 1) * per] for v in range(N_VIDEOS)])
        plain_ctx = ServingContext(root, engine=one)
        plain_ctx.boot()
        ref_events, _ = served_events(Client(create_app(plain_ctx)), QUERIES)
        ctx = ServingContext(root, engine=one, mesh=mesh, search_impl="ivfpq", ivf_clusters=AXES_SERVE_LISTS,
                             ivf_nprobe=AXES_SERVE_LISTS)
        ctx.boot()
        got_events, ms = served_events(Client(create_app(ctx)), QUERIES)
        tier = type(ctx.index._ivf).__name__
    bad = served_band_violations(got_events, ref_events, SERVED_RANK_NOISE)
    log(f"(a) ServingContext(mesh=<{AXES_SLOTS} slots>, search_impl='ivfpq') over {N_FRAMES} rows, "
        f"{AXES_SERVE_LISTS} lists a shard probed whole: tier {tier}, /api/search events {bad} outside the "
        f"{SERVED_RANK_NOISE} band of the one-device exact context's, p50 {statistics.median(ms):.2f} ms")
    check(tier == "ShardedIVFPQIndex" and bad == 0, f"(a) served ivfpq tier {tier}: {bad} events off the band")
    out["served_p50_ms"] = statistics.median(ms)
    out["launches"] = launches_since(start)
    del one, plain_ctx, ctx
    torch.cuda.empty_cache()
    return out


def phase_axes_pp(torch, frames) -> dict:
    """(b) Pipelined encodes at ViT-B/32's full width, batch BATCH: 4 stages x
    AXES_MICRO microbatches and a (data 2, stage 2) mesh, the image and the
    text tower, bf16 weights (K1/K2) and int8 weights (K3a/K3b), each against
    the one-device ``encode_image`` / ``encode_text`` with every block full:
    unit rows at cosine >= EMBED_MIN_COS (rows turned to that cosine
    rejected), 12 blocks x microbatches launches of each half an encode
    (x data groups); frames/s at 1 stage (the one-device encode) and at 4."""
    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.models.clip import encode_image, encode_text
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from evr_tpu_torch.parallel import get_mesh, pp
    from evr_tpu_torch.tokenizer import get_default_tokenizer

    out = {"launches": {}, "frames_per_s": {}, "least_cos": {}}
    staged = torch.from_numpy(frames[:BATCH]).cuda()
    mean = torch.tensor(CLIP_MEAN, device="cuda")
    std = torch.tensor(CLIP_STD, device="cuda")
    pixels = (staged.float() / 255.0 - mean) / std
    texts = [QUERIES[i % len(QUERIES)] + f" {i}" for i in range(BATCH)]
    layouts = (("4 stages", get_mesh(4, ("stage",)), None),
               ("data 2 x stage 2", get_mesh(4, ("data", "stage"), (2, 2)), "data"))
    for dtype, halves in (("bfloat16", (bf.fused_attn_block, bf.fused_mlp_block)),
                          ("int8", (bf.fused_attn_block_q, bf.fused_mlp_block_q))):
        eng = EmbeddingEngine(MODEL, device="cuda", params_dtype=dtype, batch_size=BATCH)
        cfg, params = eng.cfg, eng.params
        tokens = get_default_tokenizer()(texts, context_length=cfg.text.context_length)
        tokens = torch.as_tensor(tokens).cuda()
        with torch.inference_mode():
            ref = {"image": unit(np, encode_image(params, cfg, pixels, dtype=torch.bfloat16).cpu().numpy()),
                   "text": unit(np, encode_text(params, cfg, tokens, dtype=torch.bfloat16).cpu().numpy())}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                encode_image(params, cfg, pixels, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            out["frames_per_s"][f"{dtype} 1 stage"] = 3 * BATCH / (time.perf_counter() - t0)
        for tag, mesh, data_axis in layouts:
            rest, v_st, t_st = pp.stage_params(mesh, params)
            enc_i = pp.make_pipelined_image_encode(mesh, cfg, AXES_MICRO, torch.bfloat16, data_axis=data_axis,
                                                   presplit=True)
            enc_t = pp.make_pipelined_text_encode(mesh, cfg, AXES_MICRO, torch.bfloat16, data_axis=data_axis,
                                                  presplit=True)
            groups = 2 if data_axis else 1
            with torch.inference_mode():
                enc_i(rest, v_st, pixels[:8 * groups * AXES_MICRO])  # the libraries and K-major copies
                for tower, fn, stacked, x in (("image", enc_i, v_st, pixels), ("text", enc_t, t_st, tokens)):
                    start = launches_now()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = fn(rest, stacked, x)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    launches = launches_since(start)
                    add_into(out["launches"], launches)
                    got = unit(np, got.cpu().numpy())
                    cos = float((got * ref[tower]).sum(1).min())
                    equal = bool(np.array_equal(got, ref[tower]))
                    off_cos = float((turned_rows(np, got, EMBED_MIN_COS, 3) * ref[tower]).sum(1).min())
                    want = groups * AXES_MICRO * (cfg.vision.layers if tower == "image" else cfg.text.layers)
                    log(f"(b) pipelined {tower} encode, {dtype}, {tag} x {AXES_MICRO} microbatches: {BATCH} rows in "
                        f"{secs:.4f} s, least unit-row cosine {cos:.7f} (bit-equal {equal}), rows turned to "
                        f"{EMBED_MIN_COS}: {off_cos:.5f}; launches {launches} (expected {want} of each half)")
                    check(cos >= EMBED_MIN_COS and off_cos < EMBED_MIN_COS,
                          f"(b) {tower} {dtype} {tag}: cosine {cos}, control {off_cos}")
                    for h in halves:
                        check(launches[h.__name__] == want, f"(b) {tower} {dtype} {tag}: {h.__name__} "
                              f"{launches[h.__name__]}, expected {want}")
                    out["least_cos"][f"{tower} {dtype} {tag}"] = cos
                    if tower == "image":
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(3):
                            fn(rest, stacked, x)
                        torch.cuda.synchronize()
                        out["frames_per_s"][f"{dtype} {tag}"] = 3 * BATCH / (time.perf_counter() - t0)
            del rest, v_st, t_st
        del eng, params
        torch.cuda.empty_cache()
    log("(b) pipelined encode frames/s (4 stages and the data x stage mesh on one card run in turn): "
        + json.dumps({k: round(v, 1) for k, v in out["frames_per_s"].items()}))
    return out


def phase_axes_sp(torch, cfg, master) -> dict:
    """(c) Sequence parallelism at ViT-L/14@336px (T 577, padded), bf16, batch
    AXES_SP_BATCH, over 2 and 4 ``seq`` slots, against the one-device plain
    route (``attn_impl="xla"``): unit rows >= EMBED_MIN_COS; the causal text
    tower over 4 slots (77 padded to 80); no kernel launches; the peak
    memory above the start of each encode."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models.clip import encode_image, encode_text
    from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from evr_tpu_torch.parallel import get_mesh, sp
    from evr_tpu_torch.tokenizer import get_default_tokenizer

    plain = dataclasses.replace(cfg, attn_impl="xla")
    clip = master["clip"]
    staged = torch.from_numpy(synthetic_frames(torch, AXES_SP_BATCH, cfg.vision.image_size,
                                               cfg.vision.patch_size)).cuda()
    pixels = (staged.float() / 255.0 - torch.tensor(CLIP_MEAN, device="cuda")) / torch.tensor(CLIP_STD, device="cuda")
    tokens = torch.as_tensor(get_default_tokenizer()(list(QUERIES[:AXES_SP_BATCH]) * 2,
                                                     context_length=cfg.text.context_length)[:AXES_SP_BATCH]).cuda()
    out = {"peak_gib": {}, "least_cos": {}, "launches": {}}
    start = launches_now()

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            y = fn()
        torch.cuda.synchronize()
        return unit(np, y.float().cpu().numpy()), (torch.cuda.max_memory_allocated() - base) / 2**30

    ref_i, out["peak_gib"]["image 1 slot (plain route)"] = peak(
        lambda: encode_image(clip, plain, pixels, dtype=torch.bfloat16))
    ref_t, out["peak_gib"]["text 1 slot (plain route)"] = peak(
        lambda: encode_text(clip, plain, tokens, dtype=torch.bfloat16))
    cases = [("image", n, sp.make_sp_image_encode, pixels, ref_i) for n in AXES_SP_SLOTS]
    cases.append(("text", 4, sp.make_sp_text_encode, tokens, ref_t))
    for tower, n, make, x, ref in cases:
        enc = make(get_mesh(n, ("seq",)), cfg, torch.bfloat16)
        got, gib = peak(lambda: enc(clip, x))
        cos = float((got * ref).sum(1).min())
        off = float((turned_rows(np, got, EMBED_MIN_COS, 4) * ref).sum(1).min())
        key = f"{tower} {n} slots"
        out["peak_gib"][key], out["least_cos"][key] = gib, cos
        tcfg = cfg.vision if tower == "image" else cfg.text
        t_pad = -(-tcfg.seq_len // n) * n if tower == "image" else -(-tcfg.context_length // n) * n
        scores_gib = AXES_SP_BATCH * tcfg.heads * (t_pad // n) * t_pad * 4 / 2**30
        log(f"(c) sequence-parallel {tower} encode over {n} seq slots (T padded to {t_pad}): least unit-row cosine "
            f"{cos:.7f} against the one-device plain route (rows turned to {EMBED_MIN_COS}: {off:.5f}); peak "
            f"{gib:.3f} GiB above the start, one slot's fp32 scores {scores_gib:.3f} GiB")
        check(cos >= EMBED_MIN_COS and off < EMBED_MIN_COS, f"(c) {key}: cosine {cos}, control {off}")
    out["launches"] = launches_since(start)
    check(all(v == 0 for v in out["launches"].values()), f"(c) sequence parallelism launched {out['launches']}")
    log(f"(c) peak memory GiB {json.dumps({k: round(v, 3) for k, v in out['peak_gib'].items()})}; launches "
        f"{out['launches']} (none expected: plain products, as in the JAX module)")
    return out


def phase_axes_tp(torch, cfg, cls_cfg, master, batch, tc) -> dict:
    """(d) Tensor parallelism at ViT-L/14@336px, batch 32, bf16,
    ``freeze_layers=8``: the gradients over (data 1, model 2) and (data 2,
    model 2) against the one-slot gradients (the step bands; a gradient
    turned to cosine 0.99 rejected), K1/K2/K5 24 launches a data group;
    then 2 timed steps with the optimizer at one slot and each layout, and
    the bytes of params and AdamW moments a slot holds."""
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.parallel.fsdp import shard_tree, sharded_bytes_per_device
    from evr_tpu_torch.parallel.tp import clip_param_shardings, lazy_tree, tp_state_shardings
    from evr_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from evr_tpu_torch.training.finetune import flat_leaves, make_grad_fn
    from evr_tpu_torch.training.partition import map_with_paths

    L = cfg.vision.layers
    dev = torch.device("cuda", 0)
    out = {"launches": {}, "grads": {}, "s_per_step": {}, "bytes": {}}
    m1, g1 = make_grad_fn(cfg, cls_cfg, tc, get_mesh(1))({dev: master}, batch,
                                                         torch.Generator(device="cuda").manual_seed(AXES_SEED))
    layouts = (("data 1 x model 2", (1, 2)), ("data 2 x model 2", (2, 2)))
    for tag, shape in layouts:
        mesh = get_mesh(shape[0] * shape[1], ("data", "model"), shape)
        tree = shard_tree(master, clip_param_shardings(mesh, master))
        fn = make_grad_fn(cfg, cls_cfg, tc, mesh)
        start = launches_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, g = fn({dev: lazy_tree(tree, dev, "data")}, batch, torch.Generator(device="cuda").manual_seed(AXES_SEED))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launches_since(start)
        add_into(out["launches"], launches)
        log(f"(d) tensor-parallel gradients over {tag}: {secs:.3f} s, launches {launches}")
        check_step_launches(f"(d) {tag}", launches, shape[0] * L)
        got = step_compare(torch, f"(d) {tag} vs 1 slot", m, m1, g, g1, vision_block_leaf)
        step_check(f"(d) {tag} vs 1 slot", got, STEP_BF16_BANDS)
        out["grads"][tag] = got
        del tree, m, g
        torch.cuda.empty_cache()
    del g1
    for tag, shape in (("1 slot", None),) + layouts:
        params = map_with_paths(master, lambda _, t: t.clone())
        opt = make_optimizer(tc, params)
        whole = sum(t.numel() * t.element_size() for t in list(flat_leaves(params).values())
                    + [v for v in flat_leaves(opt.init(params)).values() if hasattr(v, "numel")])
        if shape is None:
            mesh, sh = None, None
            state = TrainState(params, opt.init(params), 0)
        else:
            mesh = get_mesh(shape[0] * shape[1], ("data", "model"), shape)
            sh = tp_state_shardings(params, opt, mesh)
            state = TrainState(shard_tree(params, sh.params), shard_tree(opt.init(params), sh.opt_state), 0)
            slot = sharded_bytes_per_device((state.params, state.opt_state))
            out["bytes"][tag] = {"slot": slot, "replicated": whole}
            check(slot < 0.75 * whole, f"(d) {tag}: a slot holds {slot} of {whole} bytes")
        del params
        step, _ = make_train_step(cfg, cls_cfg, tc, opt, mesh=mesh, state_shardings=sh)
        gen = torch.Generator(device="cuda").manual_seed(AXES_SEED)
        secs = []
        start = launches_now()
        for i in range(MESH_STEPS_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(math.isfinite(m["total_loss"].item()), f"(d) {tag} step {i + 1}: loss {m['total_loss'].item()}")
        launches = launches_since(start)
        add_into(out["launches"], launches)
        out["s_per_step"][tag] = secs
        log(f"(d) {tag}: s/step {[round(s, 4) for s in secs]}, launches {launches}"
            + (f", a slot holds {out['bytes'][tag]['slot'] / 2**30:.3f} of {whole / 2**30:.3f} GiB of params and "
               f"AdamW moments" if tag in out["bytes"] else ""))
        del state, step, opt
        torch.cuda.empty_cache()
    return out


def phase_axes_levers(torch, cfg, cls_cfg, master, batch, tc) -> dict:
    """(e) The levers over a mesh at ViT-L/14@336px, batch 32, bf16: GradCache
    (2 chunks of the global batch) over 2 slots against the 2-slot direct
    gradients (the step bands); Muon under FSDP against Muon under data
    parallelism and accumulation 2 under FSDP against data parallelism's
    (2 steps each, 2 slots: updates bit-equal, held at MESH_UPDATE_COS leaf
    by leaf)."""
    import dataclasses

    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.parallel.fsdp import fsdp_state_shardings, gather_tree, shard_tree
    from evr_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from evr_tpu_torch.training.finetune import flat_leaves, make_grad_fn
    from evr_tpu_torch.training.partition import map_with_paths

    L = cfg.vision.layers
    dev = torch.device("cuda", 0)
    mesh = get_mesh(MESH_TRAIN_SLOTS)
    out = {"launches": {}, "s": {}}
    grads = {}
    for tag, t in (("direct", tc), ("gradcache", dataclasses.replace(tc, gradcache_chunks=2))):
        start = launches_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads[tag] = make_grad_fn(cfg, cls_cfg, t, mesh)({dev: master}, batch,
                                                         torch.Generator(device="cuda").manual_seed(AXES_SEED))
        torch.cuda.synchronize()
        out["s"][tag] = time.perf_counter() - t0
        launches = launches_since(start)
        add_into(out["launches"], launches)
        log(f"(e) {tag} gradients over {MESH_TRAIN_SLOTS} slots: {out['s'][tag]:.3f} s, launches {launches}")
    n = MESH_TRAIN_SLOTS * L
    check(out["launches"]["fused_attn_block_bwd"] == 2 * n and out["launches"]["fused_attn_block"] == 3 * n,
          f"(e) launches {out['launches']}: GradCache encodes each chunk twice, the direct step once")
    (md, gd), (mc, gc) = grads["direct"], grads["gradcache"]
    got = step_compare(torch, "(e) GradCache over 2 slots vs the direct step", mc, md, gc, gd, vision_block_leaf)
    step_check("(e) GradCache over 2 slots vs the direct step", got, STEP_BF16_BANDS)
    out["gradcache"] = got
    del grads, gd, gc
    torch.cuda.empty_cache()
    for lever, t in (("muon", dataclasses.replace(tc, optimizer="muon")),
                     ("accumulation 2", dataclasses.replace(tc, grad_accumulation_steps=2))):
        finals = {}
        for layout in ("data parallel", "fsdp"):
            params = map_with_paths(master, lambda _, x: x.clone())
            opt = make_optimizer(t, params)
            sh = None
            if layout == "fsdp":
                sh = fsdp_state_shardings(params, opt, mesh)
                state = TrainState(shard_tree(params, sh.params), shard_tree(opt.init(params), sh.opt_state), 0)
                del params
            else:
                state = TrainState(params, opt.init(params), 0)
            step, _ = make_train_step(cfg, cls_cfg, t, opt, mesh=mesh, state_shardings=sh)
            gen = torch.Generator(device="cuda").manual_seed(AXES_SEED)
            secs = []
            start = launches_now()
            for _ in range(MESH_STEPS_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch, gen)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                check(math.isfinite(m["total_loss"].item()), f"(e) {lever} {layout}: loss")
            launches = launches_since(start)
            add_into(out["launches"], launches)
            check_step_launches(f"(e) {lever} {layout}", launches, MESH_STEPS_TIMED * n)
            after = flat_leaves(gather_tree(state.params) if sh is not None else state.params)
            before = flat_leaves(master)
            finals[layout] = {k: (after[k] - before[k]).float() for k in after}
            out["s"][f"{lever} {layout}"] = secs
            log(f"(e) {lever} {layout}: s/step {[round(s, 4) for s in secs]}, launches {launches}")
            del state, step, opt, after
            torch.cuda.empty_cache()
        dp, fs = finals["data parallel"], finals["fsdp"]
        equal = sum(bool(torch.equal(dp[k], fs[k])) for k in dp)
        moved = [k for k in dp if dp[k].abs().max().item() > 0]
        worst = min(leaf_cosines(torch, {k: fs[k] for k in moved}, {k: dp[k] for k in moved}).values())
        log(f"(e) {lever} under FSDP against data parallelism after {MESH_STEPS_TIMED} steps: {equal} of {len(dp)} "
            f"leaves' updates bit-equal, the least update cosine {worst:.7f} ({len(moved)} leaves moved)")
        check(worst >= MESH_UPDATE_COS and moved, f"(e) {lever}: an FSDP update at cosine {worst}")
        out[lever] = {"bit_equal_leaves": equal, "leaves": len(dp), "least_update_cos": worst}
        del finals, dp, fs
        torch.cuda.empty_cache()
    return out


def phase_axes_ckpt(torch) -> dict:
    """(f) Checkpoints on the card, ViT-B/32's params: the tensor-parallel tree
    over (data 1, model 2) and the stage-stacked tree over 4 stages
    round-trip bit-equal with their placement; the tp 2 checkpoint restores
    over (data 1, model 4) and replicated, bit-equal."""
    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.parallel import get_mesh, pp
    from evr_tpu_torch.parallel.fsdp import gather_tree
    from evr_tpu_torch.parallel.mesh import Sharding
    from evr_tpu_torch.parallel.tp import clip_param_shardings
    from evr_tpu_torch.training.finetune import flat_leaves
    from evr_tpu_torch.training.partition import map_with_paths
    from evr_tpu_torch.training.sharded_ckpt import restore_sharded, save_sharded

    cfg = get_model_config(MODEL)
    mesh2 = get_mesh(2, ("data", "model"), (1, 2))
    params = params_from_numpy(init_clip_params(AXES_SEED, cfg), "cuda")
    tree = params_from_numpy(init_clip_params(AXES_SEED, cfg), shardings=clip_param_shardings(mesh2, params))
    out = {"seconds": {}}

    def equal(a, b) -> int:
        fa, fb = flat_leaves(gather_tree(a)), flat_leaves(gather_tree(b))
        return sum(not torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fb)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_sharded(pathlib.Path(tmp) / "tp2", tree)
        out["seconds"]["save tp2"] = time.perf_counter() - t0
        rep = Sharding(get_mesh(2), ())
        targets = (("tp 2", clip_param_shardings(mesh2, params)),
                   ("tp 4", clip_param_shardings(get_mesh(4, ("data", "model"), (1, 4)), params)),
                   ("replicated", map_with_paths(params, lambda _, t: rep)))
        bad = {}
        for tag, target in targets:
            t0 = time.perf_counter()
            got = restore_sharded(pathlib.Path(tmp) / "tp2", target)
            out["seconds"][f"restore {tag}"] = time.perf_counter() - t0
            bad[tag] = equal(got, params)
            qkv = got["visual"]["blocks"][0]["attn"]["qkv"]["kernel"]
            check(qkv.shards[0].shape == qkv.sharding.shard_shape(qkv.shape) and qkv.shards[0].is_cuda,
                  f"(f) {tag}: shard {tuple(qkv.shards[0].shape)}")
            del got
        stage_mesh = get_mesh(4, ("stage",))
        _, v_st, _ = pp.stage_params(stage_mesh, params)
        save_sharded(pathlib.Path(tmp) / "pp4", v_st)
        got = restore_sharded(pathlib.Path(tmp) / "pp4", pp.stage_shardings(stage_mesh, v_st))
        bad["pp 4"] = equal(got, pp.stack_blocks(params["visual"]["blocks"]))
    log(f"(f) checkpoints: leaves not bit-equal after the round trips {json.dumps(bad)}; seconds "
        + json.dumps({k: round(v, 3) for k, v in out["seconds"].items()}))
    check(all(v == 0 for v in bad.values()), f"(f) checkpoints: {bad}")
    out["bad"] = bad
    return out


def phase_axes(torch, frames) -> dict:
    """Phase 19, the other mesh axes: (a) the sharded ANN tiers (K7), (b)
    pipelined encodes (K1/K2, K3a/K3b), (c) sequence parallelism, (d)
    tensor-parallel steps (K1/K2, K5), (e) GradCache, Muon and accumulation
    over a mesh, (f) checkpoints."""
    t0 = time.perf_counter()
    out = {"launches": {}, "seconds": {}}
    parts = {}
    for name, fn in (("ann", lambda: phase_axes_ann(torch, frames)), ("pp", lambda: phase_axes_pp(torch, frames))):
        t1 = time.perf_counter()
        parts[name] = fn()
        out["seconds"][name] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cfg, cls_cfg, master, batch, tc = mesh_train_setup(torch)
    out["seconds"]["setup"] = time.perf_counter() - t1
    for name, fn in (("sp", lambda: phase_axes_sp(torch, cfg, master)),
                     ("tp", lambda: phase_axes_tp(torch, cfg, cls_cfg, master, batch, tc)),
                     ("levers", lambda: phase_axes_levers(torch, cfg, cls_cfg, master, batch, tc))):
        t1 = time.perf_counter()
        parts[name] = fn()
        out["seconds"][name] = time.perf_counter() - t1
    del master
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    parts["ckpt"] = phase_axes_ckpt(torch)
    out["seconds"]["ckpt"] = time.perf_counter() - t1
    for part in parts.values():
        add_into(out["launches"], part.get("launches", {}))
    out.update(parts)
    out["seconds"]["phase"] = time.perf_counter() - t0
    log(f"phase 19 seconds {json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}; launches "
        f"{json.dumps(out['launches'])}")
    return out


# -- 20. the frame annotators ---------------------------------------------------

# The local OCR and the zero-shot object annotator at ViT-B/32's full width, on
# INGEST_SIZE JPEG frames (the file type ingest writes). Lines of text are
# drawn with the DejaVu fonts where the machine has them (ocr.FONT_PATHS) and
# with cv2.putText where it has none; the OCR's training and held-out renders
# then come from puttext_line, and the accuracy gate (OCR_ACC_BAR, the JAX
# test's) runs only with the fonts. (a) LocalOCRAnnotator on the card against
# the CPU on the same files: boxes and texts equal, the card's logits within
# OCR_LOGIT_BAND of the CPU's (both fp32, TF32 off; about twice the gap
# measured on an H100), two crops' logits swapped rejected; (b) the first
# training step on the card against the CPU (the loss OCR_LOSS_REL relative,
# each leaf's gradient within OCR_GRAD_TOL of its largest entry, under a
# caller's TF32 within OCR_TF32_GRAD_BAND, the module's fp32 pin taken out
# rejected, a gradient turned to cosine 0.99 rejected), then train_ocr for OCR_TRAIN_STEPS steps
# under OCR_LOSS_BAR (the JAX CPU test's bar after 40); (c) the zero-shot
# annotator over ANNOT_ZS_FRAMES frames (19 regions each) with bf16 and int8
# weights: K1/K2 (K3a/K3b) launched exactly 11 an encode batch (crops and the
# classifier's two text encodes), the similarities within the served bands of
# a plain-route twin's, each region's decisions equal where the twin's margin
# exceeds what the band can move (also under a wide-margin classifier made of
# the twin's centred crop features, where some regions are held, a swap of two
# rejected), two regions' rows swapped rejected; (d) an
# upload with sync=1 annotated by both, searched by keyword_only and
# object_only.
ANNOT_SEED = 21
ANNOT_WORDS = ("fire warning", "police arrive", "breaking news", "exit now", "danger zone", "live camera",
               "road closed", "hello world")
ANNOT_OCR_FRAMES = 16  # and one blank frame
ANNOT_ZS_FRAMES = 64
ANNOT_UPLOAD_WORDS = ("fire warning", "police arrive", "exit now")
ANNOT_UPLOAD_SCENE = 25  # frames a scene, one word a scene
OCR_LOGIT_BAND = 2e-4  # twice the gap an H100 gave (8.39e-5 on logits up to 180)
OCR_LOSS_REL, OCR_GRAD_TOL = 1e-5, 5e-3
# the first step's gradients under a caller's TF32: the module's pin must hold
# them near the TF32-off gap (9.26e-6 of a leaf's largest entry on an H100, the
# backward's sum order not fixed); the pin taken out gave 1.22e-3 there, inside
# OCR_GRAD_TOL, so this band, not OCR_GRAD_TOL, is what sees TF32
OCR_TF32_GRAD_BAND = 5e-5
OCR_TRAIN_STEPS, OCR_TRAIN_BATCH, OCR_TRAIN_SET, OCR_LOSS_BAR = 200, 64, 1024, 85.0
OCR_ACC_BAR, OCR_EVAL_N = 0.7, 256
OCR_TIMED_STEPS = 20
# accept-everything thresholds: random weights have no semantics (the JAX
# package's end-to-end test uses the same)
ZS_ACCEPT_ALL = dict(sim_threshold=-1.0, bg_margin=-10.0)


def puttext_line(text: str, rng):
    """``ocr.render_line`` without font files: the text drawn with
    cv2.putText (the Hershey fonts draw ASCII only, so accents are folded
    away; the label keeps them) at a random font, scale, weight and pad, then
    staged and augmented as render_line stages its renders."""
    import unicodedata

    import cv2
    import numpy as np

    from evr_tpu_torch.ingest import ocr

    folded = unicodedata.normalize("NFD", text).encode("ascii", "ignore").decode() or "?"
    font = (cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_DUPLEX)[int(rng.integers(2))]
    scale, thick, pad = float(rng.uniform(0.6, 1.0)), int(rng.integers(1, 3)), int(rng.integers(2, 8))
    (w, h), base = cv2.getTextSize(folded, font, scale, thick)
    img = np.zeros((h + base + 2 * pad, w + 2 * pad), np.uint8)
    cv2.putText(img, folded, (pad, pad + h), font, scale, 255, thick, cv2.LINE_AA)
    return ocr.stage_crop(img.astype(np.float32) / 255.0, rng)


def text_frame(word: str, background):
    """An INGEST_SIZE BGR frame: ``background`` with one white line of text,
    in DejaVu Sans where the machine has it, else cv2's Hershey simplex."""
    import cv2
    import numpy as np

    from evr_tpu_torch.ingest import ocr

    frame = np.ascontiguousarray(background)
    if ocr.FONT_PATHS:
        from PIL import Image, ImageDraw, ImageFont

        img = Image.fromarray(frame[:, :, ::-1])
        ImageDraw.Draw(img).text((100, 560), word, fill=(255, 255, 255),
                                 font=ImageFont.truetype(ocr.FONT_PATHS[0], 64))
        return np.ascontiguousarray(np.asarray(img)[:, :, ::-1])
    cv2.putText(frame, word, (100, 600), cv2.FONT_HERSHEY_SIMPLEX, 2.0, (255, 255, 255), 3, cv2.LINE_AA)
    return frame


def scene_background(rng):
    """A smooth seeded INGEST_SIZE background (blurred noise, camera-like)."""
    import cv2

    w, h = INGEST_SIZE
    return cv2.GaussianBlur(rng.integers(10, 90, (h, w, 3)).astype("uint8"), (31, 31), 0)


@contextlib.contextmanager
def caller_tf32(torch):
    """TF32 allowed for matmuls and cuDNN, as a caller may leave it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def phase_annot_ocr(torch, tmp: pathlib.Path, device: str) -> dict:
    """(a): OCR on the card (``device``) against the CPU plain path on the
    same JPEGs."""
    import cv2
    import numpy as np

    from evr_tpu_torch.ingest import ocr

    fonts = bool(ocr.FONT_PATHS)
    log(f"annotators: ocr.FONT_PATHS {list(ocr.FONT_PATHS) if fonts else 'is empty (no DejaVu fonts here): '}"
        + ("" if fonts else "lines drawn with cv2.putText, renders by puttext_line, no accuracy gate"))
    folder = tmp / "ocr_frames"
    folder.mkdir()
    rng = np.random.default_rng(ANNOT_SEED)
    paths = []
    for i in range(ANNOT_OCR_FRAMES):
        paths.append(folder / f"{i:03d}.jpg")
        cv2.imwrite(str(paths[-1]), text_frame(ANNOT_WORDS[i % len(ANNOT_WORDS)], scene_background(rng)))
    paths.append(folder / "999.jpg")
    cv2.imwrite(str(paths[-1]), np.full((INGEST_SIZE[1], INGEST_SIZE[0], 3), 90, np.uint8))
    card, cpu = ocr.LocalOCRAnnotator(device=device), ocr.LocalOCRAnnotator(device="cpu")
    grays = [cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) for p in paths]
    t0 = time.perf_counter()
    boxes = [ocr.detect_text_regions(g) for g in grays]
    detect_ms = 1e3 * (time.perf_counter() - t0) / len(grays)
    card.annotate_batch(paths[:1])  # first call: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card.annotate_batch(paths)
    torch.cuda.synchronize()
    annotate_s = time.perf_counter() - t0
    ref = cpu.annotate_batch(paths)
    spans, crops = card.frame_crops(paths)
    check([s[2] for s in spans] == boxes == [s[2] for s in cpu.frame_crops(paths)[0]],
          "ocr: the frames' boxes differ between calls")
    logits_k = ocr._batched_logits(card.params, crops)
    logits_p = ocr._batched_logits(cpu.params, crops)
    gap = float(np.abs(logits_k - logits_p).max())
    # the module pins fp32 itself: a caller that allows TF32 changes nothing
    with caller_tf32(torch):
        logits_tf32 = ocr._batched_logits(card.params, crops)
    tf32_gap = float(np.abs(logits_tf32 - logits_p).max())
    texts_k, conf_k = ocr.ctc_greedy_decode(logits_k)
    texts_p, conf_p = ocr.ctc_greedy_decode(logits_p)
    pair = next(j for j in range(1, len(texts_p)) if texts_p[j] != texts_p[0])
    swapped = logits_k.copy()
    swapped[[0, pair]] = logits_k[[pair, 0]]
    swap_gap = float(np.abs(swapped - logits_p).max())
    labels = [[d["label"] for d in o["text_detections"]] for o in got]
    log(f"ocr (a): {len(paths)} frames, {len(crops)} line crops; card logits against the CPU's: largest gap "
        f"{gap:.3e} (band {OCR_LOGIT_BAND}, |logits| up to {float(np.abs(logits_p).max()):.1f}), confidences "
        f"{float(np.abs(conf_k - conf_p).max()):.2e}; under a caller's TF32 {tf32_gap:.3e} (bit-equal "
        f"{bool(np.array_equal(logits_tf32, logits_k))}); control: two crops swapped {swap_gap:.3e}; texts "
        f"equal {texts_k == texts_p}; read {labels}")
    check(max(gap, tf32_gap) <= OCR_LOGIT_BAND,
          f"ocr: card logits {gap} (under TF32 {tf32_gap}) from the CPU's, band {OCR_LOGIT_BAND}")
    check(swap_gap > OCR_LOGIT_BAND, f"ocr: two crops' logits swapped pass the band ({swap_gap})")
    check(texts_k == texts_p, "ocr: the card decodes other texts than the CPU")
    for g, r in zip(got, ref):
        check([(d["label"], d["bounding_box"]) for d in g["text_detections"]]
              == [(d["label"], d["bounding_box"]) for d in r["text_detections"]],
              f"ocr: the card's detections {g} against the CPU's {r}")
    check(all(labels[:-1]) and labels[-1] == [], f"ocr: a text frame read empty or the blank one not: {labels}")
    # the recogniser alone on the card: crops/s over the held-out renders
    render = None if fonts else puttext_line
    held = ocr.make_dataset(OCR_EVAL_N, seed=ANNOT_SEED + 99, render=render)[0]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ocr._batched_logits(card.params, held)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"frames": len(paths), "crops": len(crops), "logit_gap": gap, "tf32_gap": tf32_gap, "swap_gap": swap_gap,
           "detect_ms_per_frame": detect_ms, "annotate_frames_per_s": len(paths) / annotate_s,
           "recogniser_crops_per_s": OCR_EVAL_N / statistics.median(times), "fonts": fonts}
    if fonts:
        out["acc"] = ocr.eval_ocr(card.params, n=OCR_EVAL_N, seed=ANNOT_SEED + 99)
        check(out["acc"] >= OCR_ACC_BAR, f"ocr: held-out exact match {out['acc']} < {OCR_ACC_BAR}")
    else:  # reported, not held: the checkpoint learnt the DejaVu fonts
        out["acc_puttext"] = ocr.eval_ocr(card.params, n=OCR_EVAL_N, seed=ANNOT_SEED + 99, render=render)
    log(f"ocr (a): detector {detect_ms:.2f} ms a {INGEST_SIZE[0]}x{INGEST_SIZE[1]} frame (host); annotate_batch "
        f"{out['annotate_frames_per_s']:.1f} frames/s; the recogniser {out['recogniser_crops_per_s']:.1f} crops/s "
        f"(batch {card.batch}); held-out exact match "
        + (f"{out['acc']:.4f} (bar {OCR_ACC_BAR})" if fonts else f"on putText renders {out['acc_puttext']:.4f} "
           "(not held: no fonts here)"))
    return out


def phase_annot_ocr_train(torch, device: str) -> dict:
    """(b): the first OCR step on the card against the CPU plain step, then
    train_ocr on the card."""
    import numpy as np

    from evr_tpu_torch.ingest import ocr

    render = None if ocr.FONT_PATHS else puttext_line
    params0 = ocr.init_ocr_params(torch.Generator().manual_seed(ANNOT_SEED))
    batch = ocr.make_dataset(OCR_TRAIN_BATCH, seed=ANNOT_SEED, render=render)[:3]
    on_card = [torch.from_numpy(a).to(device) for a in batch]
    loss_k, grads_k = ocr.grads_of(ocr.params_to(params0, device), *on_card)
    loss_p, grads_p = ocr.grads_of(ocr.params_to(params0, "cpu"), *(torch.from_numpy(a) for a in batch))
    # the module pins fp32 over the forward and the backward: a caller that
    # allows TF32 changes nothing; with the pin taken out (a control) TF32 runs
    with caller_tf32(torch):
        loss_t, grads_t = ocr.grads_of(ocr.params_to(params0, device), *on_card)
        pin, ocr.full_fp32 = ocr.full_fp32, contextlib.nullcontext
        try:
            loss_u, grads_u = ocr.grads_of(ocr.params_to(params0, device), *on_card)
        finally:
            ocr.full_fp32 = pin

    def rel(loss):
        return abs(loss.item() - loss_p.item()) / abs(loss_p.item())

    def worst(grads):
        return max(float((grads[k].cpu() - g).abs().max() / g.abs().max()) for k, g in grads_p.items())

    loss_rel, tf32_loss_rel = rel(loss_k), rel(loss_t)
    tf32_err, unpinned_err = worst(grads_t), worst(grads_u)
    tf32_same = all(torch.equal(grads_t[k], grads_k[k]) for k in grads_k)

    gen = torch.Generator(device=device).manual_seed(2)
    off = {}
    for k, g in grads_k.items():  # each leaf turned to cosine 0.99 (a control)
        noise = torch.randn(g.shape, generator=gen, device=g.device)
        noise -= (noise.flatten() @ g.flatten()) / max(g.norm().item() ** 2, 1e-30) * g
        off[k] = g + noise * (g.norm() * math.tan(math.acos(0.99)) / max(noise.norm().item(), 1e-30))
    grad_err, off_err = worst(grads_k), worst(off)
    log(f"ocr (b): first step, batch {OCR_TRAIN_BATCH}: loss card {loss_k.item():.6f} / CPU {loss_p.item():.6f} "
        f"(rel {loss_rel:.2e}, band {OCR_LOSS_REL}); worst leaf gradient error {grad_err:.2e} of its largest "
        f"entry (band {OCR_GRAD_TOL}); control: turned to cosine 0.99 {off_err:.2e}; under a caller's TF32: loss "
        f"rel {tf32_loss_rel:.2e}, gradients {tf32_err:.2e} (bit-equal to TF32 off {tf32_same}); with the module's "
        f"pin taken out: loss rel {rel(loss_u):.2e}, gradients {unpinned_err:.2e} (band {OCR_TF32_GRAD_BAND})")
    check(max(loss_rel, tf32_loss_rel) <= OCR_LOSS_REL, f"ocr step: loss rel {loss_rel} (under TF32 {tf32_loss_rel})")
    check(max(grad_err, tf32_err) <= OCR_GRAD_TOL, f"ocr step: gradient error {grad_err} (under TF32 {tf32_err})")
    check(tf32_err <= OCR_TF32_GRAD_BAND < unpinned_err,
          f"ocr step: under a caller's TF32 gradients {tf32_err}, with the pin taken out {unpinned_err}, band "
          f"{OCR_TF32_GRAD_BAND}")
    check(off_err > OCR_GRAD_TOL, f"ocr step: a gradient turned to cosine 0.99 passes ({off_err})")
    # the step train_ocr runs, timed alone on the card
    params = ocr.params_to(params0, device)
    opt = ocr.OCROptimizer(OCR_TRAIN_STEPS, 1e-3)
    state = opt.init(params)
    x, y, yp = (torch.from_numpy(a).to(device) for a in batch)
    for i in range(OCR_TIMED_STEPS + 5):
        if i == 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        opt.apply(params, ocr.grads_of(params, x, y, yp)[1], state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / OCR_TIMED_STEPS
    t0 = time.perf_counter()
    _, metrics = ocr.train_ocr(steps=OCR_TRAIN_STEPS, batch=OCR_TRAIN_BATCH, dataset_size=OCR_TRAIN_SET,
                               seed=ANNOT_SEED, device=device, render=render)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    log(f"ocr (b): train_ocr {OCR_TRAIN_STEPS} steps, batch {OCR_TRAIN_BATCH}, {OCR_TRAIN_SET} renders"
        f"{'' if render is None else ' (puttext_line)'}: last-chunk loss {metrics['loss']:.4f} (bar {OCR_LOSS_BAR}), "
        f"held-out exact match {metrics['acc']:.4f}, {train_s:.2f} s with rendering; a step {step_s * 1e3:.2f} ms")
    check(np.isfinite(metrics["loss"]) and metrics["loss"] < OCR_LOSS_BAR,
          f"ocr: train_ocr's loss {metrics['loss']} after {OCR_TRAIN_STEPS} steps")
    return {"loss_rel": loss_rel, "grad_err": grad_err, "off_err": off_err, "tf32_loss_rel": tf32_loss_rel,
            "tf32_grad_err": tf32_err, "tf32_bit_equal": tf32_same, "unpinned_loss_rel": rel(loss_u),
            "unpinned_grad_err": unpinned_err, "step_s": step_s,
            "train_s": train_s, **metrics}


def region_decisions(np, sims, n_cls: int, threshold: float, margin: float):
    """Per region: the best class, its margin over the second, and whether
    it passes the threshold and the background rule, with their margins."""
    obj, bg = sims[:, :n_cls], sims[:, n_cls:]
    order = np.argsort(-obj, axis=1, kind="stable")
    rows = np.arange(len(sims))
    best, second = obj[rows, order[:, 0]], obj[rows, order[:, 1]]
    over_bg = best - bg.max(axis=1) - margin
    return {"best": order[:, 0], "gap": best - second, "pass": (best >= threshold) & (over_bg > 0),
            "gap_threshold": np.abs(best - threshold), "gap_bg": np.abs(over_bg)}


def keep_features(engine, store: dict, key: str) -> None:
    """``engine.encode_staged_images`` wrapped on the instance to keep its
    last output in ``store[key]`` (``del engine.encode_staged_images`` ends it)."""
    encode = engine.encode_staged_images

    def kept(*args, **kwargs):
        store[key] = encode(*args, **kwargs)
        return store[key]

    engine.encode_staged_images = kept


def phase_annot_zeroshot(torch, paths, params_dtype: str, counted, band: float, device: str) -> dict:
    """(c): the zero-shot annotator's main-path call, launches counted, held
    to a plain-route twin."""
    import copy
    import dataclasses

    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ingest.zeroshot import ZeroShotObjectAnnotator

    what = f"zero-shot {params_dtype}"
    engine = EmbeddingEngine(MODEL, device=device, batch_size=BATCH, rng_seed=0, params_dtype=params_dtype)
    size = engine.cfg.vision.image_size
    engine.encode_staged_images(np.zeros((1, size, size, 3), np.uint8))  # kernel libraries load
    twin = copy.copy(engine)
    twin.cfg = dataclasses.replace(engine.cfg, attn_impl="plain")
    twin._text_cache = {}
    ann = ZeroShotObjectAnnotator(engine, **ZS_ACCEPT_ALL)
    captured, feats = {}, {}
    score = ann._score_crops
    ann._score_crops = lambda staged: captured.setdefault("sims", score(staged))
    keep_features(engine, feats, "card")
    n_crops = len(paths) * len(ann.regions)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = ann._classifier()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ann.annotate_batch(paths)
    torch.cuda.synchronize()
    annotate_s = time.perf_counter() - t0
    got = {fn.__name__: fn.launches for fn in counted}
    del ann._score_crops, engine.encode_staged_images
    # the two text encodes of the classifier (its prompts, the background
    # prompts) and the crops' encode batches, 11 pooled blocks each
    expected = (engine.cfg.text.layers - 1) * 2 + (engine.cfg.vision.layers - 1) * -(-n_crops // BATCH)
    check(all(n == expected for n in got.values()), f"{what}: launches {got}, expected {expected} each")
    sims = captured["sims"]
    t0 = time.perf_counter()
    staged = ann.stage_frames(paths)[1]
    stage_s = time.perf_counter() - t0
    twin_ann = ZeroShotObjectAnnotator(twin, **ZS_ACCEPT_ALL)
    keep_features(twin, feats, "twin")
    ref = twin_ann._score_crops(staged)
    check(sims.shape == ref.shape == (n_crops, len(w)) and np.isfinite(sims).all(), f"{what}: sims {sims.shape}")
    unit = {k: f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-6)
            for k, f in ((k, np.asarray(f, np.float32)) for k, f in feats.items())}
    check(np.array_equal(unit["card"] @ w.T, sims) and np.array_equal(unit["twin"] @ twin_ann._classifier().T, ref),
          f"{what}: the kept features are not the ones scored")
    gap = float(np.abs(sims - ref).max())
    w_cos = float((w * twin_ann._classifier()).sum(1).min())
    far = int(np.abs(ref - ref[0]).max(axis=1).argmax())
    swapped = sims.copy()
    swapped[[0, far]] = sims[[far, 0]]
    swap_gap = float(np.abs(swapped - ref).max())
    n_cls = len(ann.classnames)
    flips, held = {}, {}
    for name, (thr, margin) in (("accept_all", (-1.0, -10.0)), ("default", (0.22, 0.0))):
        k, r = region_decisions(np, sims, n_cls, thr, margin), region_decisions(np, ref, n_cls, thr, margin)
        # a region's class can move only where the twin's best-to-second gap
        # is within what two scores each off by the band can close
        sure = r["gap"] > 2 * band
        sure_pass = (r["gap_threshold"] > band) & (r["gap_bg"] > 2 * band)
        flips[name] = int((k["best"] != r["best"])[sure].sum() + (k["pass"] != r["pass"])[sure_pass].sum())
        held[name] = (int(sure.sum()), int(sure_pass.sum()))
        widest = float(r["gap"].max())
    # random towers score the 80 classes within a few thousandths, under what
    # the band can move, so the class check above holds no region. A classifier
    # with wide margins: the twin's own features of the full-frame crop of every
    # fourth frame, centred on the mean crop feature and made unit, then the
    # background rows; some class decisions then clear twice the band
    rows = np.arange(0, n_crops, len(ann.regions) * 4)
    centred = unit["twin"][rows] - unit["twin"].mean(0)
    w_wide = np.concatenate([centred / np.linalg.norm(centred, axis=1, keepdims=True), w[n_cls:]])
    sims_wide, ref_wide = unit["card"] @ w_wide.T, unit["twin"] @ w_wide.T
    wide_gap = float(np.abs(sims_wide - ref_wide).max())
    r = region_decisions(np, ref_wide, len(rows), -1.0, -10.0)
    sure = np.flatnonzero(r["gap"] > 2 * band)

    def class_flips(card_sims):
        return int((region_decisions(np, card_sims, len(rows), -1.0, -10.0)["best"] != r["best"])[sure].sum())

    # control: the card's rows of two held regions with different classes swapped
    i = sure[0] if len(sure) else 0
    j = next((x for x in sure if r["best"][x] != r["best"][i]), i)
    swapped_wide = sims_wide.copy()
    swapped_wide[[i, j]] = sims_wide[[j, i]]
    wide = {"gap": wide_gap, "held": len(sure), "flips": class_flips(sims_wide),
            "control_flips": class_flips(swapped_wide),
            "least_held_margin": float(r["gap"][sure].min()) if len(sure) else None}
    default = ZeroShotObjectAnnotator(engine)
    n_default = sum(len(default._detect(sims[i * len(ann.regions):(i + 1) * len(ann.regions)]))
                    for i in range(len(paths)))
    log(f"{what}: {len(paths)} frames, {n_crops} crops, launches {got} (expected {expected} each); sims against "
        f"the plain twin: largest gap {gap:.3e} (band {band}), classifier rows least cosine {w_cos:.7f}; control: "
        f"two regions swapped {swap_gap:.3e}; region decisions flipped {flips} over (class, pass) regions held "
        f"{held} (the twin's widest best-to-second class gap {widest:.2e}); a wide-margin classifier of "
        f"{len(rows)} centred twin crop features: sims {wide_gap:.3e} from the twin's, class decisions flipped "
        f"{wide['flips']} over {wide['held']} regions held (least twin margin held {wide['least_held_margin']}), "
        f"control: regions {i} and {j} swapped flips {wide['control_flips']}; detections at accept-everything "
        f"thresholds {sum(len(o['object_detections']) for o in out)}, at the defaults {n_default} (reported); "
        f"classifier build {build_s:.3f} s, annotate_batch "
        f"{len(paths) / annotate_s:.1f} frames/s, {n_crops / annotate_s:.1f} crops/s (staging alone {stage_s:.2f} s)")
    check(gap <= band, f"{what}: sims {gap} from the plain twin's, band {band}")
    check(swap_gap > band, f"{what}: two regions' rows swapped pass the band ({swap_gap})")
    check(all(v == 0 for v in flips.values()), f"{what}: region decisions flipped {flips}")
    check(wide_gap <= band, f"{what}: wide-margin sims {wide_gap} from the twin's, band {band}")
    check(wide["held"] > 0 and wide["flips"] == 0 and wide["control_flips"] > 0,
          f"{what}: wide-margin class decisions {wide}")
    check(all(o["object_detections"] and o["text_detections"] == [] for o in out),
          f"{what}: a frame without detections at accept-everything thresholds")
    return {"launches": got, "gap": gap, "swap_gap": swap_gap, "w_cos": w_cos, "flips": flips, "held": held,
            "wide": wide,
            "build_s": build_s, "annotate_s": annotate_s, "stage_s": stage_s, "frames_per_s": len(paths) / annotate_s,
            "crops_per_s": n_crops / annotate_s, "default_detections": n_default, "engine": engine,
            "annotator": ann}


def phase_annot_upload(torch, tmp: pathlib.Path, engine, zero_shot, counted, device: str) -> dict:
    """(d): an upload with sync=1 through the port's app, annotated by the
    zero-shot annotator and the OCR on the card, then searched."""
    import cv2
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.ingest import ocr
    from evr_tpu_torch.ingest.annotators import CompositeAnnotator
    from evr_tpu_torch.serving import ServingContext, create_app

    video = tmp / "annotated.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), INGEST_FPS, INGEST_SIZE)
    rng = np.random.default_rng(ANNOT_SEED + 1)
    # dark, bright red (BGR), dark: each cut's HSV content change is far above
    # the detector's threshold, so each word's scene gives one frame
    for word, colour in zip(ANNOT_UPLOAD_WORDS, ((0, 0, 0), (0, 0, 150), (0, 0, 0))):
        frame = text_frame(word, scene_background(rng) + np.asarray(colour, np.uint8))
        for _ in range(ANNOT_UPLOAD_SCENE):
            writer.write(frame)
    writer.release()
    ctx = ServingContext(tmp / "root_annot", engine=engine,
                         annotator=CompositeAnnotator(zero_shot, ocr.LocalOCRAnnotator(device=device)))
    ctx.data_root.ensure()
    client = Client(create_app(ctx))
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    resp = upload(client, video, sync="1")
    upload_s = time.perf_counter() - t0
    got = {fn.__name__: fn.launches for fn in counted}
    check(resp.status_code == 200, f"annotated upload: HTTP {resp.status_code} {resp.get_data()[:200]!r}")
    n = json.loads(resp.get_data(as_text=True))["video"]["frames"]
    layers = engine.cfg.vision.layers - 1
    expected = layers * (encode_batches(n, max(BATCH * 4, 256)) + -(-n * len(zero_shot.regions) // BATCH))
    check(n == len(ANNOT_UPLOAD_WORDS) and all(v == expected for v in got.values()),
          f"annotated upload: {n} frames, launches {got} (expected {expected})")
    entry = ctx.registry.get("annotated")
    records = json.loads(ctx.resolve_path(entry["metadata_file"]).read_text())
    check(len(records) == n and all(r["object_detections"]["detections"] for r in records),
          f"annotated upload: {len(records)} records of {n} frames, object detections "
          f"{[len(r['object_detections']['detections']) for r in records]}")
    frames_dir = ctx.resolve_path(entry["frames_dir"])
    paths = sorted(frames_dir.glob("*.jpg"), key=lambda p: int(p.stem))
    read = ocr.LocalOCRAnnotator(device="cpu").annotate_batch(paths)
    word, frame_idx = next((d["label"].split()[0], int(p.stem)) for p, o in zip(paths, read)
                           for d in o["text_detections"])
    text = {"search_type": "text", "adaptive_threshold": -1.0, "text_confidence": 0.0, "object_confidence": 0.0,
            "top_k": 50}
    kw = route_post(client, {**text, "search_method": "keyword_only", "query": word})
    label = records[0]["object_detections"]["detections"][0]["label"]
    obj = route_post(client, {**text, "search_method": "object_only", "query": label})
    with_label = {f"event-{r['frameidx']}" for r in records
                  if label in [d["label"] for d in r["object_detections"]["detections"]]}
    log(f"annotated upload (sync=1): {n} frames in {upload_s:.2f} s, launches {got} (expected {expected} each); "
        f"stored text {[[d['label'] for d in r['text_detections']['detections']] for r in records]}; keyword_only "
        f"{word!r} (the CPU's read of frame {frame_idx}) → {[e['id'] for e in kw]}; object_only {label!r} → "
        f"{len(obj)} events")
    check(f"event-{frame_idx}" in [e["id"] for e in kw], f"keyword_only {word!r}: {[e['id'] for e in kw]}")
    check(bool(obj) and {e["id"] for e in obj} <= with_label and all(e["object_confidence"] > 0 for e in obj),
          f"object_only {label!r}: {[e['id'] for e in obj]}, frames with the label {sorted(with_label)}")
    return {"frames": n, "seconds": upload_s, "launches": got}


def phase_annotators(torch, device: str = "cuda") -> dict:
    """Phase 20, the frame annotators: (a) OCR on the card against the CPU,
    (b) OCR training, (c) the zero-shot annotator with bf16 and int8 weights,
    (d) an annotated upload. ``device`` is the card (the CPU only to rehearse
    the phase's control flow: no kernel launches there)."""
    import cv2
    import numpy as np

    from evr_tpu_torch.ops import block_fused as bf

    t_phase = time.perf_counter()
    out = {"launches": {}, "seconds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        out["ocr"] = phase_annot_ocr(torch, tmp, device)
        out["seconds"]["ocr"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["train"] = phase_annot_ocr_train(torch, device)
        out["seconds"]["train"] = time.perf_counter() - t0
        folder = tmp / "zs_frames"
        folder.mkdir()
        rng = np.random.default_rng(ANNOT_SEED + 2)
        grids = rng.integers(0, 256, (ANNOT_ZS_FRAMES, 9, 16, 3), dtype=np.uint8)
        paths = []
        for i, grid in enumerate(grids):  # colour grids with a white square, as phase 15's frames
            frame = cv2.resize(grid, INGEST_SIZE, interpolation=cv2.INTER_NEAREST)
            x = (i * 16) % (INGEST_SIZE[0] - 128)
            frame[INGEST_SIZE[1] // 2 - 64:INGEST_SIZE[1] // 2 + 64, x:x + 128] = 255
            paths.append(folder / f"{i:05d}.jpg")
            cv2.imwrite(str(paths[-1]), frame)
        for dtype, counted, band in (("float32", [bf.fused_attn_block, bf.fused_mlp_block], SERVED_RANK_NOISE),
                                     ("int8", [bf.fused_attn_block_q, bf.fused_mlp_block_q], INT8_SERVED_RANK_NOISE)):
            t0 = time.perf_counter()
            zs = phase_annot_zeroshot(torch, paths, dtype, counted, band, device)
            engine, ann = zs.pop("engine"), zs.pop("annotator")
            add_into(out["launches"], zs["launches"])
            out[f"zeroshot_{dtype}"] = zs
            if dtype == "float32":
                t1 = time.perf_counter()
                out["upload"] = phase_annot_upload(torch, tmp, engine, ann, counted, device)
                add_into(out["launches"], out["upload"]["launches"])
                out["seconds"]["upload"] = time.perf_counter() - t1
            del engine, ann
            torch.cuda.empty_cache()
            out["seconds"][f"zeroshot_{dtype}"] = time.perf_counter() - t0
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 20 seconds {json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}; launches "
        f"{json.dumps(out['launches'])}")
    return out


# -- 21. the model families: SigLIP and Whisper -------------------------------

FAMILY_SEED = 22
# phase 21's configurations (a CPU rehearsal of the phase registers tiny ones
# under these names); for the script's time large-v3's max_len is cut from
# WhisperASR's 224 to 64 and so400m's served frames from 512 to 256
FAMILY = dict(
    siglip_parity="siglip-base-patch16-224", siglip_serve="siglip-so400m-patch14-384",
    siglip_train="siglip-base-patch16-224", whisper="large-v3", whisper_parity="base",
    frames=256, videos=4, batch=64, parity_pairs=4, train_batch=32, train_steps=3, grad_pairs=4,
    windows=2, max_len=64,
)
FAMILY_QUERIES = ("a red car on the street", "a crowd at night", "a dog running on grass", "a boat on a river",
                  "người đàn ông đang đi bộ", "a burning building", "two people talking", "an empty road")
# Whisper's decode check spreads the random decoder (token embedding x10,
# positions x300, as tests/test_torch_whisper.py does) so that its greedy
# ids vary and stay far from ties; the un-spread CLI weights repeat one id
WHISPER_SPREAD = (10.0, 300.0)
# Bands, each about twice what the same check measured on an H100 80GB HBM3
# at 700 W in this phase's first development run (PERF.md §6; the
# measurement in each comment). Relative errors are max |card − reference|
# over each row's (or leaf's) largest |reference|; each band comes with a
# negative control that must fail it (rows turned to FAMILY_CONTROL_COS,
# gradients and updates to 0.99, a zeroed cache row, ranks 41-50).
FAMILY_F32_REL = 3e-6  # fp32 (TF32 off), card against CPU: SigLIP features 1.2e-6, logits 9.6e-8; Whisper base 1.3e-6
FAMILY_MEL_TOL = 5e-5  # the log-mel, card against CPU, max abs: 2.6e-5 (cuFFT against pocketfft, then log10)
FAMILY_GRAD_REL = 1e-3  # the first SigLIP step's gradients, card against CPU: 4.8e-4 (a scalar leaf)
FAMILY_UPDATE_COS = 0.9998  # Adam's first update, card against CPU, per leaf: 0.99990
FAMILY_ROW_COS = {"bfloat16": 0.99965, "int8": 0.9992}  # served rows against the fp32 path's: 0.99983, 0.99961
FAMILY_SERVED_NOISE = {"bfloat16": 3.5e-3, "int8": 5e-3}  # the top-10 cut band: scores apart up to 1.7e-3, 2.3e-3
FAMILY_DECODE_REL = 4e-6  # the cached decode's logits against the full re-run's, fp32: 1.9e-6
FAMILY_BF16_LOGIT_COS = 0.9997  # bf16 teacher-forced logits against fp32, per row: 0.99985
FAMILY_CONTROL_COS = 0.999  # the rows of the negative controls


def family_counters():
    """Every launch counter of the ops package: K1-K9 and the kernels their
    wrappers also launch alone."""
    from evr_tpu_torch.ops import adc, attention, layernorm, retrieval
    from evr_tpu_torch.ops import block_fused as bf

    return [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q,
            retrieval.fused_topk, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd, adc.adc_list_scores,
            attention.flash_attention_full, attention.flash_attention_blocked, layernorm.fused_layer_norm,
            bf.fused_block_merged, bf.gemm_bf16, bf.gemm_s8, bf.attn_forward, bf.attn_backward]


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rows_of(torch, x):
    x = torch.as_tensor(x).detach().float().cpu()
    return x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)


def rel_err(torch, got, ref) -> float:
    """max |got − ref| over each row's largest |ref|, the largest over rows."""
    g, r = rows_of(torch, got), rows_of(torch, ref)
    return ((g - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-30)).max().item()


def leaf_err(torch, got, ref) -> float:
    """max |got − ref| over the leaf's largest |ref|."""
    g, r = rows_of(torch, got).reshape(-1), rows_of(torch, ref).reshape(-1)
    return ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()


def least_cos(torch, got, ref) -> float:
    return torch.nn.functional.cosine_similarity(rows_of(torch, got), rows_of(torch, ref), dim=-1).min().item()


def turned(torch, x, cos: float, seed: int):
    """``x``'s rows each turned to exactly cosine ``cos`` of themselves,
    norms kept (float32 on the CPU): the negative control of a band."""
    r = rows_of(torch, x)
    noise = torch.randn(r.shape, generator=torch.Generator().manual_seed(seed))
    noise = noise - (noise * r).sum(-1, keepdim=True) / (r * r).sum(-1, keepdim=True).clamp_min(1e-30) * r
    noise = noise / noise.norm(dim=-1, keepdim=True) * r.norm(dim=-1, keepdim=True)
    return r * cos + noise * math.sqrt(1.0 - cos * cos)


def held(what: str, value: float, ok, control: float) -> dict:
    """``value`` within its band (``ok``) and the negative control's outside."""
    check(ok(value), f"{what}: {value:.3e} outside its band")
    check(not ok(control), f"{what}: the negative control ({control:.3e}) passed the band")
    return {"value": value, "control": control}


def device_split(torch, fn) -> dict:
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA): its wall ms, the
    ms its CUDA kernels took on the device (their sum) and the five kernels
    of most device time. A trace without device events gives None (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_ms": busy or None,
            "top": [(name[:70], round(ms, 3)) for name, ms in top]}


def family_frames(torch, n: int, size: int, device, seed: int):
    """Seeded uint8 frames [n, size, size, 3]: a random colour on an 8 x 8
    grid, a gradient and pixel noise, each frame its own scene."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cells = torch.randint(0, 256, (n, 8, 8, 3), generator=gen, device=device).float()
    frames = torch.nn.functional.interpolate(cells.permute(0, 3, 1, 2), size=(size, size), mode="nearest")
    frames = frames.permute(0, 2, 3, 1) + torch.linspace(-25, 25, size, device=device)[None, :, None, None]
    frames = frames + torch.randn(frames.shape, generator=gen, device=device) * 2.0
    return frames.clamp(0, 255).to(torch.uint8).cpu().numpy()


def family_audio(n_samples: int, rate: int, seed: int):
    """Seeded float32 speech-band audio: a tone whose pitch changes every
    half second, under noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    freq = np.repeat(rng.uniform(120, 900, -(-n_samples // (rate // 2))), rate // 2)[:n_samples]
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(freq) / rate) + 0.02 * rng.standard_normal(n_samples)
    return x.astype(np.float32)


def write_wav(path: pathlib.Path, audio, rate: int) -> None:
    import wave

    import numpy as np

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


def family_siglip_parity(torch, device) -> dict:
    """(a) SigLIP at FAMILY["siglip_parity"], the port's seeded params: image
    and text features and ``siglip_forward``'s logits on the card (fp32,
    TF32 off) against the CPU, through the same port code."""
    from evr_tpu_torch.models import siglip as sig
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.tokenizer import SiglipFallbackTokenizer
    from evr_tpu_torch.utils.device import full_fp32

    cfg = sig.get_siglip_config(FAMILY["siglip_parity"])
    params = sig.init_siglip_params(FAMILY_SEED, cfg, device)
    host = params_from_numpy(params, "cpu")
    n = FAMILY["parity_pairs"]
    staged = torch.from_numpy(family_frames(torch, n, cfg.vision.image_size, device, FAMILY_SEED))
    tokens = torch.from_numpy(SiglipFallbackTokenizer(cfg.text.context_length, cfg.text.vocab_size)(
        FAMILY_QUERIES[:n]).astype("int64"))
    outs = []
    with torch.no_grad(), full_fp32():
        for p, dev in ((params, device), (host, "cpu")):
            pixels, toks = sig.stage_pixels(staged.to(dev)), tokens.to(dev)
            outs.append({"image": sig.encode_image(p, cfg, pixels), "text": sig.encode_text(p, cfg, toks),
                         "logits": sig.siglip_forward(p, cfg, pixels, toks)["logits_per_image"]})
    card, cpu = outs
    out = {}
    for key in ("image", "text", "logits"):
        ok = lambda v: v <= FAMILY_F32_REL  # noqa: E731
        out[key] = held(f"21a SigLIP {key}, card against CPU", rel_err(torch, card[key], cpu[key]), ok,
                        rel_err(torch, turned(torch, cpu[key], FAMILY_CONTROL_COS, 1), cpu[key]))
    return out


def served_siglip(torch, device, root: pathlib.Path, dtype: str, frames, names):
    """The SigLIP engine of ``serving.__main__`` for ``--params-dtype dtype``
    (float32: the fp32 reference, compute in fp32), its encode of
    ``frames`` into a data root, and the booted context and app."""
    from werkzeug.test import Client

    from evr_tpu_torch.index.siglip_engine import SiglipEngine
    from evr_tpu_torch.models.siglip import get_siglip_config
    from evr_tpu_torch.serving import ServingContext, create_app
    from evr_tpu_torch.serving.__main__ import build_engine, parse_args

    batch = FAMILY["batch"]
    if dtype == "float32":
        engine = SiglipEngine(get_siglip_config(FAMILY["siglip_serve"]), compute_dtype="float32", device=device,
                              batch_size=batch)
    else:
        engine = build_engine(parse_args([
            "--model-family", "siglip", "--model", FAMILY["siglip_serve"], "--device", str(device),
            "--params-dtype", dtype, "--batch-size", str(batch), "--data-root", str(root)]))
    check(type(engine).__name__ == "SiglipEngine" and engine.params_dtype == dtype, f"21b engine {dtype}")
    engine.encode_staged_images(frames[:batch])  # warm-up
    sync(torch, device)
    t0 = time.perf_counter()
    emb = engine.encode_staged_images(frames)
    encode_s = time.perf_counter() - t0
    per = len(frames) // len(names)
    write_data_root(root, names, [emb[i * per:(i + 1) * per] for i in range(len(names))],
                    [frames[i * per:(i + 1) * per] for i in range(len(names))])
    ctx = ServingContext(root, engine=engine)
    check(ctx.boot() == list(names), f"21b {dtype}: boot")
    return engine, ctx, Client(create_app(ctx)), emb, encode_s


def family_siglip_serving(torch, device, tmp: pathlib.Path) -> dict:
    """(b) SigLIP served at FAMILY["siglip_serve"]: FAMILY["frames"] frames
    encoded with bf16 and int8 weights (``serving.__main__``'s engine) and
    by the fp32 reference, each into its own data root; /api/search's text
    queries (the fallback tokenizer), the image and hybrid routes and
    /api/models; the served rankings and rows held to the fp32 path's."""
    import numpy as np

    from evr_tpu_torch.models.siglip import get_siglip_config
    from evr_tpu_torch.utils.device import full_fp32

    cfg = get_siglip_config(FAMILY["siglip_serve"])
    frames = family_frames(torch, FAMILY["frames"], cfg.vision.image_size, device, FAMILY_SEED + 1)
    names = [f"sig{v}" for v in range(FAMILY["videos"])]
    per = len(frames) // len(names)
    out, served = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        with full_fp32() if dtype == "float32" else contextlib.nullcontext():
            engine, ctx, client, emb, encode_s = served_siglip(torch, device, tmp / f"siglip_{dtype}", dtype,
                                                               frames, names)
            events, ms = served_events(client, FAMILY_QUERIES)
            hybrid = route_post(client, {"search_type": "hybrid", "image_url": png_b64(frames[per + 3]),
                                         "query": FAMILY_QUERIES[0], "image_weight": 0.7, "top_k": 10,
                                         "adaptive_threshold": -1.0})
            if dtype == "float32":  # ranks 41-50 of each query: the ranking check's negative control
                deep = [[(e["videoId"], e["id"], e["clip_similarity"]) for e in route_post(client, {
                    "query": q, "search_type": "text", "search_method": "text_clip", "top_k": 50})[40:50]]
                    for q in FAMILY_QUERIES]
        served[dtype] = {"emb": emb, "events": events, "hybrid": hybrid}
        out[dtype] = {"encode_frames_per_s": len(frames) / encode_s, "request_p50_ms": statistics.median(ms)}
        if dtype == "bfloat16":
            images = []
            for v, i in ((0, 5), (1, 3 * per // 5), (2, 0), (3, per - 1)):
                hit = route_post(client, {"search_type": "image", "image_url": png_b64(frames[v * per + i]),
                                          "top_k": 1, "adaptive_threshold": -1.0})
                images.append(hit[0]["id"] == f"event-{i}" and hit[0]["videoId"] == f"video-{names[v]}")
            check(all(images), f"21b image route: indexed frames found themselves {images}")
            models = json.loads(client.get("/api/models").get_data(as_text=True))
            check("siglip" in models[0]["name"], f"21b /api/models {models}")
            engine.clear_text_cache()
            text_ms = []
            for q in FAMILY_QUERIES * 3:
                engine.clear_text_cache()
                t0 = time.perf_counter()
                engine.get_text_features(q)
                text_ms.append((time.perf_counter() - t0) * 1e3)
            out[dtype]["text_query_p50_ms"] = statistics.median(text_ms)
            keep = (engine, ctx)
        else:
            del engine, ctx, client
    ref = served["float32"]
    for dtype in ("bfloat16", "int8"):
        got = served[dtype]
        noise = FAMILY_SERVED_NOISE[dtype]
        out[dtype]["rows"] = held(f"21b {dtype} rows against fp32", least_cos(torch, got["emb"], ref["emb"]),
                                  lambda v: v >= FAMILY_ROW_COS[dtype],  # noqa: B023
                                  least_cos(torch, turned(torch, ref["emb"], FAMILY_CONTROL_COS, 2), ref["emb"]))
        out[dtype]["ranking"] = held(f"21b {dtype} served top-10 against fp32",
                                     served_band_violations(got["events"], ref["events"], noise), lambda v: v == 0,
                                     served_band_violations(deep, ref["events"], noise))
        both = [[(e["videoId"], e["id"], e["clip_similarity"]) for e in got["hybrid"]],
                [(e["videoId"], e["id"], e["clip_similarity"]) for e in ref["hybrid"]]]
        check(both[0] and served_band_violations(both[:1], both[1:], noise) == 0, f"21b {dtype} hybrid route")
        common = [abs(a[2] - b[2]) for qa, qb in zip(got["events"], ref["events"]) for a in qa for b in qb
                  if a[:2] == b[:2]]
        out[dtype]["score_diff"] = max(common) if common else 0.0
    del served
    return out, keep, names


def family_siglip_train(torch, device) -> dict:
    """(c) ``fit_siglip`` at FAMILY["siglip_train"], batch
    FAMILY["train_batch"], fp32 on the card: the first step's loss and
    gradients on FAMILY["grad_pairs"] pairs and Adam's first update against
    the CPU's; one step over a 2-slot data mesh against one slot; then
    FAMILY["train_steps"] steps (the loss falls, both towers and logit_bias
    move)."""
    from evr_tpu_torch.models import siglip as sig
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.tokenizer import SiglipFallbackTokenizer
    from evr_tpu_torch.training import siglip_train as st
    from evr_tpu_torch.training.finetune import flat_leaves
    from evr_tpu_torch.utils.device import full_fp32

    cfg = sig.get_siglip_config(FAMILY["siglip_train"])
    params = sig.init_siglip_params(FAMILY_SEED + 2, cfg, device)
    n, b = FAMILY["grad_pairs"], FAMILY["train_batch"]
    captions = [f"{FAMILY_QUERIES[i % len(FAMILY_QUERIES)]} {i}" for i in range(b)]
    batch = {"images": family_frames(torch, b, cfg.vision.image_size, device, FAMILY_SEED + 2),
             "tokens": SiglipFallbackTokenizer(cfg.text.context_length, cfg.text.vocab_size)(captions)}
    tc = st.SiglipTrainConfig(lr=1e-4)
    out = {}
    with full_fp32():
        small = {k: v[:n] for k, v in batch.items()}
        host = params_from_numpy(params, "cpu")
        (loss_c, g_c), (loss_h, g_h) = (st.siglip_grads(p, cfg, small) for p in (params, host))
        out["loss_rel"] = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
        check(out["loss_rel"] <= FAMILY_F32_REL, f"21c first loss card {loss_c.item()} CPU {loss_h.item()}")
        worst = max(g_h, key=lambda k: leaf_err(torch, g_c[k], g_h[k]))
        big = "visual/blocks/0/mlp/fc/kernel"  # the controls' leaf (a scalar leaf cannot be turned)
        out["grads"] = held("21c first-step gradients, card against CPU", leaf_err(torch, g_c[worst], g_h[worst]),
                            lambda v: v <= FAMILY_GRAD_REL,
                            leaf_err(torch, turned(torch, g_h[big].reshape(1, -1), 0.99, 3), g_h[big]))
        out["grads_worst_leaf"] = worst
        updates = []
        for p, g in ((params, g_c), (host, g_h)):
            before = flat_leaves(p)
            fresh = {k: v.clone() for k, v in before.items()}
            opt = st.make_siglip_optimizer(tc)
            opt.apply(fresh, g, opt.init(fresh))
            updates.append({k: (fresh[k] - before[k]).cpu() for k in fresh})
        cos = {k: least_cos(torch, updates[0][k].reshape(1, -1), updates[1][k].reshape(1, -1)) for k in g_h}
        worst = min(cos, key=cos.get)
        out["updates"] = held("21c Adam's first update, card against CPU", cos[worst],
                              lambda v: v >= FAMILY_UPDATE_COS,
                              least_cos(torch, turned(torch, updates[1][big].reshape(1, -1), 0.99, 4),
                                        updates[1][big].reshape(1, -1)))
        del host, g_h, updates
        # the port's fp32 step bands (STEP_FP32_BANDS: loss, gradient norm, least leaf cosine)
        (l1, g1), (l2, g2) = (st.siglip_grads(params, cfg, batch, mesh=m)
                              for m in (None, get_mesh(2, device=device)))
        norms = [math.sqrt(sum(g.double().square().sum().item() for g in gs.values())) for gs in (g1, g2)]
        out["mesh"] = {"loss_rel": abs(l2.item() - l1.item()) / abs(l1.item()),
                       "norm_rel": abs(norms[1] - norms[0]) / norms[0]}
        check(out["mesh"]["loss_rel"] <= STEP_FP32_BANDS[0] and out["mesh"]["norm_rel"] <= STEP_FP32_BANDS[1],
              f"21c 2 slots against 1: {out['mesh']}")
        out["mesh"]["leaf_cos"] = held("21c 2-slot gradients against one slot, least leaf cosine",
                                       min(leaf_cosines(torch, g2, g1).values()),
                                       lambda v: v >= STEP_FP32_BANDS[2],
                                       least_cos(torch, turned(torch, g1[big].reshape(1, -1), 0.99, 5),
                                                 g1[big].reshape(1, -1)))
        del g1, g2
        sync(torch, device)
        t0 = time.perf_counter()
        trained, losses = st.fit_siglip(params, cfg, [batch] * FAMILY["train_steps"], tc, device=device)
        out["step_s"] = (time.perf_counter() - t0) / FAMILY["train_steps"]
    out["losses"] = losses
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"21c losses {losses}")
    for tower in ("visual", "text"):
        key = flat_leaves(trained)[f"{tower}/blocks/0/mlp/fc/kernel"]
        check(not torch.equal(key, flat_leaves(params)[f"{tower}/blocks/0/mlp/fc/kernel"]), f"21c {tower} moved")
    check(trained["logit_bias"].item() != params["logit_bias"].item(), "21c logit_bias moved")
    return out


def family_whisper(torch, device) -> dict:
    """(d) Whisper at FAMILY["whisper"], the port's seeded params drawn on
    the device (the decoder spread by WHISPER_SPREAD), FAMILY["windows"]
    windows of seeded audio, fp32 (TF32 off): the KV-cached greedy decode's
    ids equal to a full re-run's and its logits within FAMILY_DECODE_REL (a
    decode with cache row 0 zeroed fails); bf16 teacher-forced logits
    against fp32 by row cosine; FAMILY["whisper_parity"] on the card against
    the CPU through fp32 teacher-forced logits on one window."""
    from evr_tpu_torch.models import whisper as wh
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.utils.device import full_fp32

    cfg = wh.WHISPER_SIZES[FAMILY["whisper"]]
    params = wh.init_whisper_params(FAMILY_SEED + 3, cfg, device)
    params["decoder"]["token_embedding"].mul_(WHISPER_SPREAD[0])
    params["decoder"]["pos"].mul_(WHISPER_SPREAD[1])
    asr = wh.WhisperASR(params, cfg, [cfg.sot_id], max_len=FAMILY["max_len"], device=device)
    audio = family_audio(FAMILY["windows"] * cfg.n_samples, cfg.sampling_rate, FAMILY_SEED + 3)
    windows = wh.pad_or_trim(audio.reshape(FAMILY["windows"], -1), cfg.n_samples)
    max_len, out = asr.max_len, {}
    with torch.inference_mode(), full_fp32():
        mel = wh.log_mel_spectrogram(torch.from_numpy(windows).to(device), asr.filters, cfg.n_fft, cfg.hop_length)
        wh.greedy_decode(params, cfg, mel, [cfg.sot_id], 4)  # warm-up
        sync(torch, device)
        t0 = time.perf_counter()
        ids, logits = wh.greedy_decode(params, cfg, mel, [cfg.sot_id], max_len, return_logits=True)
        sync(torch, device)
        decode_s = time.perf_counter() - t0
        enc = wh.encoder_forward(params, cfg, mel)
        seq, done, oracle = ids[:, :1], torch.zeros(len(ids), dtype=torch.bool, device=ids.device), []
        for _ in range(max_len - 1):
            last = wh.decoder_forward(params, cfg, seq, enc)[:, -1]
            oracle.append(last)
            nxt = torch.where(done, torch.full_like(seq[:, 0], cfg.eos_id), last.argmax(-1))
            done = done | (nxt == cfg.eos_id)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
        oracle = torch.stack(oracle, dim=1)
        check(torch.equal(ids, seq), f"21d cached decode ids {ids.tolist()} against the full re-run {seq.tolist()}")
        top2 = torch.topk(logits, 2, dim=-1).values
        out["least_top2_gap"] = (top2[..., 0] - top2[..., 1]).min().item()
        out["distinct_ids"] = len(set(ids[:, 1:].reshape(-1).tolist()))
        original = wh._mha_cached

        def row_zeroed(x_row, p, n_heads, k_cache, v_cache, pos):
            if pos > 0:
                k_cache[:, 0] = 0
                v_cache[:, 0] = 0
            return original(x_row, p, n_heads, k_cache, v_cache, pos)

        wh._mha_cached = row_zeroed
        try:
            bad_ids, bad_logits = wh.greedy_decode(params, cfg, mel, [cfg.sot_id], max_len, return_logits=True)
        finally:
            wh._mha_cached = original
        out["decode"] = held("21d cached decode logits against the full re-run", rel_err(torch, logits, oracle),
                             lambda v: v <= FAMILY_DECODE_REL, rel_err(torch, bad_logits, oracle))
        out["control_ids_differ"] = not torch.equal(bad_ids, ids)
        enc16 = wh.encoder_forward(params, cfg, mel, torch.bfloat16)
        lg16 = wh.decoder_forward(params, cfg, ids[:, :-1], enc16, torch.bfloat16)
        lg32 = wh.decoder_forward(params, cfg, ids[:, :-1], enc)
        out["bf16"] = held("21d bf16 teacher-forced logits against fp32", least_cos(torch, lg16, lg32),
                           lambda v: v >= FAMILY_BF16_LOGIT_COS,
                           least_cos(torch, turned(torch, lg32, FAMILY_CONTROL_COS, 6), lg32))
        del enc16, lg16, lg32, enc
        bcfg = wh.WHISPER_SIZES[FAMILY["whisper_parity"]]
        host = wh.init_whisper_params(FAMILY_SEED + 4, bcfg, "cpu")
        card = params_from_numpy(host, device)
        one = wh.pad_or_trim(audio[None, :bcfg.n_samples], bcfg.n_samples)
        tokens = torch.randint(0, bcfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(FAMILY_SEED))
        filters = torch.from_numpy(wh.mel_filter_bank(1 + bcfg.n_fft // 2, bcfg.num_mel_bins, bcfg.sampling_rate))
        res = []
        for p, dev in ((card, device), (host, "cpu")):
            m = wh.log_mel_spectrogram(torch.from_numpy(one).to(dev), filters.to(dev), bcfg.n_fft, bcfg.hop_length)
            res.append((m, wh.decoder_forward(p, bcfg, tokens, wh.encoder_forward(p, bcfg, m))))
        shifted = torch.roll(res[1][0], 1, dims=-1)  # the CPU's frames one hop late: the control
        out["mel"] = held("21d log-mel, card against CPU", (res[0][0].cpu() - res[1][0]).abs().max().item(),
                          lambda v: v <= FAMILY_MEL_TOL, (shifted - res[1][0]).abs().max().item())
        out["base"] = held(f"21d {FAMILY['whisper_parity']} logits, card against CPU", rel_err(torch, *[r[1] for r in res]),
                           lambda v: v <= FAMILY_F32_REL,
                           rel_err(torch, turned(torch, res[1][1], FAMILY_CONTROL_COS, 7), res[1][1]))
    out["decode_tokens_per_s"] = ids.shape[0] * (max_len - 1) / decode_s
    out["decode_s"] = decode_s
    return out, asr


def family_transcription(torch, device, tmp: pathlib.Path, engine, root: pathlib.Path, names, asr) -> dict:
    """(e) ``python -m evr_tpu_torch.tools.transcribe --random-init --size
    FAMILY["whisper"] --max-len FAMILY["max_len"] --raw-ids --segments-out
    <root's metadata dir>`` over two videos' WAVs (the fallback text of the
    random weights is empty: their ids lie past the byte range), the root
    booted again with the transcripts, a speech query through /api/search
    returning the transcribed videos only; ``LocalWhisperTranscriber``
    answering /api/transcribe-voice."""
    import io

    from werkzeug.test import Client

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.models.whisper import WHISPER_SIZES
    from evr_tpu_torch.serving import ServingContext, create_app
    from evr_tpu_torch.serving.providers import LocalWhisperTranscriber
    from evr_tpu_torch.tools import transcribe
    from evr_tpu_torch.utils.device import full_fp32

    cfg = WHISPER_SIZES[FAMILY["whisper"]]
    wavs = tmp / "wavs"
    wavs.mkdir()
    spoken = names[:2]
    for i, name in enumerate(spoken):  # two windows, then one
        write_wav(wavs / f"{name}.wav", family_audio((2 - i) * cfg.n_samples, cfg.sampling_rate, FAMILY_SEED + 5 + i),
                  cfg.sampling_rate)
    meta = DataRootConfig(root).metadata_dir
    t0 = time.perf_counter()
    with full_fp32():
        results, _ = quiet(transcribe.main, [str(wavs / f"{n}.wav") for n in spoken] + [
            "--random-init", "--size", FAMILY["whisper"], "--max-len", str(FAMILY["max_len"]), "--raw-ids",
            "--segments-out", str(meta), "--device", str(device)])
    out = {"cli_s": time.perf_counter() - t0}
    for i, name in enumerate(spoken):
        segs = json.loads((meta / f"{name}_transcript.json").read_text())["segments"]
        check(len(segs) == 2 - i and all(s["text"] for s in segs), f"21e {name} transcript {segs}")
    keyword = json.loads((meta / f"{spoken[0]}_transcript.json").read_text())["segments"][0]["text"].split()[0]
    ctx = ServingContext(root, engine=engine, transcriber=LocalWhisperTranscriber(asr))
    check(ctx.boot() == list(names), "21e boot with the transcripts")
    client = Client(create_app(ctx))
    events = route_post(client, {"search_method": "speech_only", "keyword": keyword, "query": keyword,
                                 "top_k": 10})
    videos = {e["videoId"] for e in events}
    check(f"video-{spoken[0]}" in videos and videos <= {f"video-{n}" for n in spoken},
          f"21e speech query {keyword!r}: videos {videos}")
    out["speech_videos"] = sorted(videos)
    write_wav(wavs / "voice.wav", family_audio(10 * cfg.sampling_rate, cfg.sampling_rate, FAMILY_SEED + 7),
              cfg.sampling_rate)
    t0 = time.perf_counter()
    with full_fp32():
        resp = client.post("/api/transcribe-voice",
                           data={"audio": (io.BytesIO((wavs / "voice.wav").read_bytes()), "voice.wav")})
    out["voice_s"] = time.perf_counter() - t0
    text = json.loads(resp.get_data(as_text=True)).get("text")
    check(resp.status_code == 200 and isinstance(text, str) and text, f"21e transcribe route {resp.status_code}")
    return out


def family_splits(torch, engine, asr) -> dict:
    """Profiler splits (``device_split``), taken last in phase 21 (a trace
    slows the launches after it): 8 frames through the bf16 so400m engine,
    one text query, and two steps of large-v3's decode over one window."""
    from evr_tpu_torch.models import whisper as wh

    frames = family_frames(torch, 8, engine.cfg.vision.image_size, engine.device, FAMILY_SEED + 8)
    cfg = asr.cfg
    audio = family_audio(cfg.n_samples, cfg.sampling_rate, FAMILY_SEED + 8)
    with torch.inference_mode():
        mel = wh.log_mel_spectrogram(torch.from_numpy(audio[None]).to(asr.device), asr.filters, cfg.n_fft,
                                     cfg.hop_length)
        return {"encode_8": device_split(torch, lambda: engine.encode_staged_images(frames)),
                "text_query": device_split(torch, lambda: engine.encode_texts(FAMILY_QUERIES[:1])),
                "decode_2": device_split(torch, lambda: wh.greedy_decode(asr.params, cfg, mel, [cfg.sot_id], 3))}


def phase_families(torch, device: str = "cuda") -> dict:
    """Phase 21, the model families: (a) SigLIP card against CPU, (b)
    SigLIP served at so400m's full width (bf16, int8, the fp32 reference),
    (c) SigLIP fine-tuned, (d) Whisper large-v3's decode and base card
    against CPU, (e) transcription end to end. No kernel of ``ops`` runs:
    every launch counter is read before and after (``device``: the card,
    the CPU only to rehearse the phase's control flow)."""
    t_phase = time.perf_counter()
    before = {fn.__name__: fn.launches for fn in family_counters()}
    out = {"seconds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        out["parity"] = family_siglip_parity(torch, device)
        out["seconds"]["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serving"], (engine, ctx), names = family_siglip_serving(torch, device, tmp)
        out["seconds"]["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["train"] = family_siglip_train(torch, device)
        out["seconds"]["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["whisper"], asr = family_whisper(torch, device)
        out["seconds"]["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["transcription"] = family_transcription(torch, device, tmp, engine, ctx.data_root.root, names, asr)
        out["seconds"]["e"] = time.perf_counter() - t0
        if torch.device(device).type == "cuda":
            t0 = time.perf_counter()
            out["split"] = family_splits(torch, engine, asr)
            out["seconds"]["split"] = time.perf_counter() - t0
        del engine, ctx, asr
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    moved = {fn.__name__: fn.launches - before[fn.__name__] for fn in family_counters()
             if fn.launches != before[fn.__name__]}
    check(not moved, f"phase 21 launched kernels of ops: {moved}")
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 21 seconds {json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}; "
        f"no ops kernel launched ({len(before)} counters)")
    return out


# -- 22. the MoE towers (expert parallelism) and the prefix captioner (SCST) --

MOE_SEED = 23
MOE_EXPERTS, MOE_K, MOE_EVERY, MOE_CAPACITY, MOE_GROUP = 8, 2, 2, 1.25, 256
MOE_FRAMES = 512
MOE_EXPERT_NOISE = 0.25  # each expert's kernels moved by this share of their std
MOE_FT_STEPS = 3  # the CLI's steps of TRAIN_BATCH (the mesh step's batch too)
# the MoE engine's unit rows against the fp32 plain route (frames and texts):
# bf16 moves a token whose two best experts nearly tie to another expert, and
# past the capacity that reorders which tokens are dropped, so the least row
# cosine is far below the dense towers' (0.99241 measured on an H100 80GB
# HBM3, 700 W); its band is about twice that gap, its control rows
# turned to 0.97. The upcycled towers before the noise (room for every
# token) against the dense engine: 0.99993 measured, band about twice the
# gap, control 0.999. Every row is held too, each tower apart: the median row
# cosine at about twice its gap (frames 0.9999518, texts 0.9972326
# measured: a text's 77 tokens cross six MoE layers) and the share of frames
# under 0.999 (48 of 512) at about twice that share; their control is a real
# fault, the engine run with two experts of every MoE layer swapped (frames
# median 0.997294, texts 0.9898379 measured). See PERF.md
MOE_ROW_COS, MOE_ROW_CONTROL = 0.985, 0.97
MOE_ROW_MEDIAN, MOE_FRAME_SHARE_UNDER = {"frames": 0.9999, "texts": 0.9945}, 0.19
MOE_STEP0_COS = 0.99985
CAP_SEED, CAP_FRAMES = 24, 64
CAP_DECODE_TOL = 7e-5  # cached against full re-run logits, fp32, TF32 off (3.43e-5 measured; see PERF.md)
CAP_TRAIN_ARGV = ["--xe-epochs", "1", "--scst-epochs", "2", "--batch-size", "16", "--target-reward", "101",
                  "--demo", "2"]


def moe_counters():
    from evr_tpu_torch.ops import block_fused as bf

    return [bf.fused_attn_block, bf.fused_mlp_block]


def moe_params(torch, cfg, moe):
    """(the dense ViT-B/32 params, the upcycled tree before the noise, the
    tree with its experts moved apart), every tree on the card in fp32."""
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.models.moe import upcycle_clip_params
    from evr_tpu_torch.training.partition import map_with_paths

    from evr_tpu_torch.models import init_clip_params

    dense = params_from_numpy(init_clip_params(MOE_SEED, cfg), "cuda")
    up = upcycle_clip_params(torch.Generator().manual_seed(MOE_SEED), dense, cfg, moe)
    up = params_from_numpy(up, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)

    def moved(path, t):
        if "moe" in path and path[-1] == "kernel" and path[-2] in ("fc", "proj"):
            return t + MOE_EXPERT_NOISE * t.std() * torch.randn(t.shape, generator=gen, device="cuda")
        return t

    return dense, up, map_with_paths(up, moved)


def unit_rows(np, x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def moe_serving(torch, tmp: pathlib.Path) -> dict:
    """(a): the MoE engine against the fp32 plain route, its launches, the
    step-0 upcycled towers against the dense engine, the file served."""
    import dataclasses

    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.index.engine import normalise_u8
    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.models.moe import MoEConfig, encode_image_moe, encode_text_moe
    from evr_tpu_torch.serving import ServingContext, create_app
    from evr_tpu_torch.serving.__main__ import build_engine, parse_args
    from evr_tpu_torch.training.partition import map_with_paths

    cfg = get_model_config(MODEL)
    moe = MoEConfig(MOE_EXPERTS, MOE_K, MOE_CAPACITY, MOE_EVERY, group_size=MOE_GROUP)
    dense, up, moved = moe_params(torch, cfg, moe)
    frames = synthetic_frames(torch, MOE_FRAMES, cfg.vision.image_size, cfg.vision.patch_size)
    out = {}
    counted = moe_counters()
    engine = EmbeddingEngine(MODEL, params=moved, moe=moe, batch_size=BATCH, device="cuda")
    engine.encode_staged_images(frames[:BATCH])  # warm
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    emb = engine.encode_staged_images(frames, normalise=True)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    img_launches = {fn.__name__: fn.launches for fn in counted}
    for fn in counted:
        fn.launches = 0
    txt = engine.encode_texts(list(QUERIES))
    txt_launches = {fn.__name__: fn.launches for fn in counted}
    n_moe_v = len([b for b in moved["visual"]["blocks"] if "moe" in b])
    n_moe_t = len([b for b in moved["text"]["blocks"] if "moe" in b])
    batches = MOE_FRAMES // BATCH
    want_img = {"fused_attn_block": batches * cfg.vision.layers,
                "fused_mlp_block": batches * (cfg.vision.layers - n_moe_v)}
    want_txt = {"fused_attn_block": cfg.text.layers, "fused_mlp_block": cfg.text.layers - n_moe_t}
    log(f"(a) MoE engine {MODEL} ({MOE_EXPERTS} experts, top-{MOE_K}, every {MOE_EVERY}, capacity {MOE_CAPACITY}): "
        f"{MOE_FRAMES} frames in {encode_s:.3f} s ({MOE_FRAMES / encode_s:.1f} frames/s), launches {img_launches} "
        f"(expected {want_img}); {len(QUERIES)} texts, launches {txt_launches} (expected {want_txt})")
    check(img_launches == want_img, f"(a) MoE encode launches {img_launches}, expected {want_img}")
    check(txt_launches == want_txt, f"(a) MoE text launches {txt_launches}, expected {want_txt}")
    out.update(encode_frames_per_s=MOE_FRAMES / encode_s, launches={
        k: img_launches[k] + txt_launches[k] for k in img_launches})
    plain = dataclasses.replace(cfg, attn_impl="plain")
    refs = []
    with torch.inference_mode():
        for lo in range(0, MOE_FRAMES, BATCH):
            x = normalise_u8(torch.from_numpy(frames[lo:lo + BATCH]).cuda())
            refs.append(encode_image_moe(moved, plain, moe, x, torch.float32)[0].cpu().numpy())
        tokens = torch.from_numpy(engine.tokenizer(list(QUERIES), context_length=77)).cuda()
        ref_txt = encode_text_moe(moved, plain, moe, tokens, torch.float32)[0].cpu().numpy()
    ref = unit_rows(np, np.concatenate(refs))
    ref_txt = unit_rows(np, ref_txt)
    frame_cos, text_cos = (emb * ref).sum(1), (txt * ref_txt).sum(1)
    rows_cos = float(min(frame_cos.min(), text_cos.min()))
    control = float((rows_off_by(ref, MOE_ROW_CONTROL, MOE_SEED) * ref).sum(1).min())
    log(f"(a) MoE bf16 rows against the fp32 plain route: least cosine frames {float(frame_cos.min()):.7f}, texts "
        f"{float(text_cos.min()):.7f} (band {MOE_ROW_COS}), median frame {float(np.median(frame_cos)):.7f}, frames "
        f"under 0.999 {int((frame_cos < 0.999).sum())} of {MOE_FRAMES}; rows turned to {MOE_ROW_CONTROL}: "
        f"{control:.7f}")
    out["rows"] = held("(a) MoE rows against fp32 plain", rows_cos, lambda v: v >= MOE_ROW_COS, control)
    # every row: each tower's median and the frames' share under 0.999,
    # against a real fault (experts 0 and 1 of every MoE layer swapped)
    def swapped(path, t):
        if "moe" in path and path[-2] in ("fc", "proj"):
            return t[[1, 0] + list(range(2, t.shape[0]))]
        return t

    faulty = EmbeddingEngine(MODEL, params=map_with_paths(moved, swapped), moe=moe, batch_size=BATCH, device="cuda")
    fault = {"frames": (faulty.encode_staged_images(frames, normalise=True) * ref).sum(1),
             "texts": (faulty.encode_texts(list(QUERIES)) * ref_txt).sum(1)}
    del faulty

    def spread(cos):
        return {tower: (float(np.median(c)), float((c < 0.999).mean())) for tower, c in cos.items()}

    def spread_ok(tower, median, share):
        return median >= MOE_ROW_MEDIAN[tower] and (tower == "texts" or share <= MOE_FRAME_SHARE_UNDER)

    got, bad = spread({"frames": frame_cos, "texts": text_cos}), spread(fault)
    log(f"(a) every MoE row, (median cosine, share under 0.999): {json.dumps(got)} (bands median "
        f"{json.dumps(MOE_ROW_MEDIAN)}, frames' share {MOE_FRAME_SHARE_UNDER}); two experts swapped: {json.dumps(bad)}")
    for tower in got:
        check(spread_ok(tower, *got[tower]), f"(a) MoE {tower}: (median, share under 0.999) {got[tower]}")
        check(not spread_ok(tower, *bad[tower]), f"(a) the swapped experts passed the {tower}' bands {bad[tower]}")
    out["row_spread"] = {"rows": got, "swapped": bad}
    # step 0: identical experts, room for every token, against the dense engine
    roomy = dataclasses.replace(moe, capacity_factor=MOE_EXPERTS / MOE_K)
    up_engine = EmbeddingEngine(MODEL, params=up, moe=roomy, batch_size=BATCH, device="cuda")
    dense_engine = EmbeddingEngine(MODEL, params=dense, batch_size=BATCH, device="cuda")
    step0 = float(min((up_engine.encode_staged_images(frames[:BATCH], normalise=True)
                       * dense_engine.encode_staged_images(frames[:BATCH], normalise=True)).sum(1).min(),
                      (up_engine.encode_texts(list(QUERIES)) * dense_engine.encode_texts(list(QUERIES))).sum(1).min()))
    log(f"(a) upcycled towers at step 0 (capacity {roomy.capacity_factor}) against the dense engine: least row "
        f"cosine {step0:.7f}")
    out["step0"] = held("(a) upcycled step 0", step0, lambda v: v >= MOE_STEP0_COS,
                        float((rows_off_by(emb[:BATCH], 0.999, MOE_SEED) * emb[:BATCH]).sum(1).min()))
    del up_engine, dense_engine, dense, up
    # the file, served through the CLI's engine construction and /api/search
    path = tmp / "moe.pt"
    t0 = time.perf_counter()
    torch.save({"params": {"clip": map_with_paths(moved, lambda _, t: t.cpu())}, "opt_state": {}, "step": 0,
                "moe": dataclasses.asdict(moe)}, path)
    save_s = time.perf_counter() - t0
    root = tmp / "moe_root"
    args = parse_args(["--data-root", str(root), "--model", MODEL, "--device", "cuda", "--checkpoint", str(path),
                       "--batch-size", str(BATCH), "--local-ocr", "off"])
    served = build_engine(args)
    check(served.moe == moe and "finetuned" in served.models, f"(a) served engine {served.moe}")
    served.set_active_model("finetuned")
    served_emb = served.encode_staged_images(frames, normalise=True)
    check(np.array_equal(served_emb, emb), "(a) the served file's rows differ from the in-memory engine's")
    per = MOE_FRAMES // N_VIDEOS
    names = [f"video{v}" for v in range(N_VIDEOS)]
    dcfg = write_data_root(root, names, [emb[v * per:(v + 1) * per] for v in range(N_VIDEOS)],
                           [frames[v * per:(v + 1) * per] for v in range(N_VIDEOS)])
    ctx = ServingContext(dcfg, engine=served)
    check(ctx.boot() == names, "(a) the MoE data root did not boot")
    for fn in counted:
        fn.launches = 0
    events, ms = served_events(Client(create_app(ctx)), QUERIES)
    served_launches = {fn.__name__: fn.launches for fn in counted}
    # the same root booted on the in-memory engine: the file serves its events
    mem = ServingContext(dcfg, engine=engine)
    mem.boot()
    mem_events, _ = served_events(Client(create_app(mem)), QUERIES)
    log(f"(a) the MoE file ({path.stat().st_size / 1e9:.2f} GB, saved in {save_s:.1f} s) through serving.__main__ "
        f"--checkpoint: rows bit-equal to the in-memory engine's; /api/search p50 {sorted(ms)[len(ms) // 2]:.2f} "
        f"ms, events equal to the in-memory engine's {events == mem_events}; launches {served_launches} (one "
        f"TextSearcher dispatch a query: K1 12, K2 6)")
    check(events == mem_events, "(a) the served file's events differ from the in-memory engine's")
    check(served_launches == {"fused_attn_block": 12 * len(QUERIES), "fused_mlp_block": 6 * len(QUERIES)},
          f"(a) served launches {served_launches}")
    for k, n in served_launches.items():
        out["launches"][k] += n
    out["request_p50_ms"] = sorted(ms)[len(ms) // 2]
    return out, moved


def moe_train(torch, tmp: pathlib.Path, moved) -> dict:
    """(b): ``tools.finetune --moe-experts 8`` and the (data 2, expert 2)
    mesh step against one device."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.index.engine import load_torch_checkpoint
    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.models.moe import MoEConfig, moe_group
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.tools import finetune as finetune_cli
    from evr_tpu_torch.training import TrainConfig, Trainer
    from evr_tpu_torch.training import finetune as ft

    cfg = get_model_config(MODEL)
    out = {"launches": {}}
    root = tmp / "moe_ft"
    root.mkdir()
    train_json, val_json = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size,
                                             n_train=MOE_FT_STEPS * TRAIN_BATCH, n_val=TRAIN_BATCH)
    step_s, make = [], ft.make_train_step

    def timed(*args, **kwargs):
        step, eval_step = make(*args, **kwargs)

        def run(state, batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, generator)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return state, m

        return run, eval_step

    real_save = ft.Trainer.save_checkpoint

    def final_only(self, name, *args, **kwargs):  # best_model.pt is phase 6's
        if name == "final_checkpoint":
            real_save(self, name, *args, **kwargs)

    start = launches_now()
    ft.make_train_step, ft.Trainer.save_checkpoint = timed, final_only
    t0 = time.perf_counter()
    try:
        result, text = quiet(finetune_cli.main, [
            "--train-json", str(train_json), "--val-json", str(val_json), "--data-dir", str(root),
            "--model", MODEL, "--batch-size", str(TRAIN_BATCH), "--epochs", "1", "--seed", str(MOE_SEED),
            "--save-dir", str(root / "ck"), "--device", "cuda", "--moe-experts", str(MOE_EXPERTS)])
    finally:
        ft.make_train_step, ft.Trainer.save_checkpoint = make, real_save
    cli_s = time.perf_counter() - t0
    launches = launches_since(start)
    row = result["history"][0]
    blob = load_torch_checkpoint(root / "ck" / "final_checkpoint.pt")
    log(f"(b) tools.finetune --moe-experts {MOE_EXPERTS}: {len(step_s)} steps of {TRAIN_BATCH}, s/step "
        f"{[round(x, 4) for x in step_s]}, the run {cli_s:.1f} s; train moe_aux {row['train_moe_aux']:.5f}, total "
        f"loss {row['train_total_loss']:.4f}; the file's MoEConfig {blob['moe']}; launches {launches} (no kernel at "
        f"T 50 and 77: the trainer's route, as in JAX)")
    check(len(step_s) == MOE_FT_STEPS and math.isfinite(row["train_moe_aux"]) and row["train_moe_aux"] > 0,
          f"(b) the MoE fine-tune: {row}")
    check("sparse-upcycled dense init" in text, "(b) the CLI did not upcycle")
    check(blob["moe"] == MoEConfig(n_experts=MOE_EXPERTS, router_k=2), f"(b) the file's MoEConfig {blob['moe']}")
    check(not any(launches.values()), f"(b) launches {launches}")
    out.update(step_s=step_s, cli_s=cli_s, moe_aux=row["train_moe_aux"])
    del blob
    # the (data 2, expert 2) mesh against one device, one step of TRAIN_BATCH:
    # the text tower's token groups cross the two data slots' row boundary
    moe = MoEConfig(MOE_EXPERTS, MOE_K, MOE_CAPACITY, MOE_EVERY, group_size=MOE_GROUP)
    ctx, per_slot = cfg.text.context_length, TRAIN_BATCH // 2
    S = moe_group(TRAIN_BATCH * ctx, MOE_GROUP)
    check((per_slot * ctx) % S != 0, f"(b) the text groups (S {S}) do not cross the slots")
    # fp32 (TF32 off): the slots' smaller products round alike, so routing
    # cannot flip between the two layouts and the fp32 step bands hold
    tc = TrainConfig(seed=MOE_SEED, batch_size=TRAIN_BATCH, epochs=1, compute_dtype="float32",
                     freeze_layers=0, moe=moe)
    _, batch = variant_batch(torch, cfg, TRAIN_BATCH)
    batch = {"images": batch["images"], "tokens": batch["tokens"]}
    grads, metrics, secs = {}, {}, {}
    for tag, mesh in (("one", None), ("mesh", get_mesh(4, ("data", "expert"), (2, 2)))):
        trainer = Trainer(cfg, moved, dataclasses.replace(tc), device="cuda", mesh=mesh, log_fn=lambda *_: None)
        if mesh is None:
            trainer.optimizer.apply = lambda params, g, state, **kw: grads.setdefault(tag, g) is None
        else:
            real_apply = ft._fsdp_apply
            ft._fsdp_apply = lambda opt, state, g, m: grads.setdefault(tag, g) is None
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics[tag] = trainer.train_step(trainer.state, batch, trainer.generator)
            torch.cuda.synchronize()
            secs[tag] = time.perf_counter() - t0
        finally:
            if mesh is not None:
                ft._fsdp_apply = real_apply
        if mesh is not None:
            leaf = trainer.state.params["clip"]["visual"]["blocks"][-1]["moe"]["fc"]["kernel"]
            check(leaf.sharding.spec == ("expert", None, None) and leaf.shards[0].shape[0] == MOE_EXPERTS // 2,
                  f"(b) the expert layout {leaf}")
        del trainer
    got = step_compare(torch, "(b) MoE step, (data 2, expert 2) slots vs one device", metrics["mesh"],
                       metrics["one"], grads["mesh"], grads["one"], lambda k: True)
    step_check("(b) MoE mesh step", got, STEP_FP32_BANDS)
    log(f"(b) MoE step (batch {TRAIN_BATCH}, fp32; text groups of {S} tokens, {per_slot * ctx / S:.2f} a slot) "
        f"one device {secs['one']:.3f} s, (data 2, expert 2) {secs['mesh']:.3f} s; moe_aux "
        f"{float(metrics['one']['moe_aux']):.5f} / {float(metrics['mesh']['moe_aux']):.5f}")
    out.update(mesh=got, mesh_s=secs)
    return out


class SpelledIds:
    """A tokenizer that spells each id (``t<id>``)."""

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


def captioner_phase(torch, tmp: pathlib.Path) -> dict:
    """(c): ``PrefixCaptioner`` over JPEGs and through ``annotate_folder``,
    the cached decode against a full re-run, beam 1 against greedy,
    ``tools.train_captioner``."""
    import numpy as np

    from evr_tpu_torch.data_prep import PrefixCaptioner
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ingest.annotate import annotate_folder
    from evr_tpu_torch.models import captioner as mc
    from evr_tpu_torch.tokenizer import get_default_tokenizer
    from evr_tpu_torch.tools import train_captioner
    from evr_tpu_torch.training.scst import load_captioner

    counted = moe_counters()
    out = {"launches": {fn.__name__: 0 for fn in counted}}
    cap_cfg = mc.CaptionerConfig()
    params = mc.init_captioner_params(torch.Generator().manual_seed(CAP_SEED), cap_cfg)
    # random weights decode near ties and ids the machine's tokenizer cannot
    # spell: the tied embedding spread ×10, the ids past its vocabulary zeroed
    params["token_embedding"] *= 10
    params["token_embedding"][len(get_default_tokenizer().decoder):cap_cfg.sot_id] = 0
    engine = EmbeddingEngine(MODEL, batch_size=BATCH, device="cuda")
    captioner = PrefixCaptioner(engine, params, cap_cfg)
    folder = tmp / "cap_frames"
    names = write_jpegs(torch, folder, CAP_FRAMES, CAP_SEED)
    paths = [str(folder / n) for n in names]
    captioner.caption_batch(paths[:2])  # warm
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    captions = captioner.caption_batch(paths)
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    want = engine.cfg.vision.layers - 1  # one encode batch, the pooled last block plain
    log(f"(c) PrefixCaptioner ({cap_cfg.width} wide, {cap_cfg.layers} layers, {cap_cfg.max_new_tokens} new tokens): "
        f"{CAP_FRAMES} captions in {cap_s:.3f} s ({CAP_FRAMES / cap_s:.1f} captions/s), launches {launches}; "
        f"first {captions[:2]}")
    # a random captioner emits EOT first now and then (an empty caption)
    check(len(captions) == CAP_FRAMES and sum(map(bool, captions)) >= CAP_FRAMES // 2, f"(c) captions {captions}")
    check(all(n == want for n in launches.values()), f"(c) caption launches {launches}, expected {want} each")
    for k, n in launches.items():
        out["launches"][k] += n
    # the records against the frames, with each id spelled (the machine's
    # fallback tokenizer spells a random captioner's captions alike)
    spelled = PrefixCaptioner(engine, params, cap_cfg, tokenizer=SpelledIds())
    want = spelled.caption_batch(paths)
    records = annotate_folder(folder, "v.mp4", captioner=spelled)
    by_frame = {r["frameid"]: r["metadata"].get("caption") for r in records}
    log(f"(c) annotate_folder: {len(records)} records, {len(set(want))} distinct spelled captions")
    check(len(set(want)) > 1 and by_frame == dict(zip(names, want)),
          "(c) annotate_folder's captions differ from caption_batch's, frame by frame")
    # the cached decode against a full re-run, fp32, on the same features
    feats = torch.from_numpy(engine.encode_image_files(paths, normalise=True)).cuda()
    cached, full = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _ = mc.generate(captioner.params, cap_cfg, feats, step_logits=cached)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    ids_full, _ = mc.generate(captioner.params, cap_cfg, feats, use_cache=False, step_logits=full)
    finite = torch.isfinite(full[0])
    gap = max(float((a - b)[finite].abs().max()) for a, b in zip(cached, full))
    top2 = min(float((s.topk(2).values[:, 0] - s.topk(2).values[:, 1]).min()) for s in full)
    real = mc.block_apply_cached

    def zeroed(x, p, h, kc, vc, pos, activation="quick_gelu"):
        y, kc, vc = real(x, p, h, kc, vc, pos, activation)
        if pos > 0:
            kc, vc = kc.clone(), vc.clone()
            kc[:, 0] = 0
            vc[:, 0] = 0
        return y, kc, vc

    bad = []
    mc.block_apply_cached = zeroed
    try:
        mc.generate(captioner.params, cap_cfg, feats, step_logits=bad)
    finally:
        mc.block_apply_cached = real
    control = max(float((a - b)[finite].abs().max()) for a, b in zip(bad, full))
    beam, _ = mc.beam_search(captioner.params, cap_cfg, feats, beam_size=1)
    log(f"(c) cached greedy decode ({len(cached)} steps, {CAP_FRAMES} rows) in {decode_s:.3f} s "
        f"({CAP_FRAMES * len(cached) / decode_s:.1f} tokens/s): ids equal to a full re-run's "
        f"{bool(torch.equal(ids, ids_full))}, logits apart by {gap:.2e} (band {CAP_DECODE_TOL}), a zeroed cache "
        f"row {control:.2e}; least top-2 gap {top2:.3f}; beam 1 equal to greedy {bool(torch.equal(beam, ids))}")
    check(torch.equal(ids, ids_full), "(c) the cached decode's ids differ from a full re-run's")
    check(top2 > 10 * CAP_DECODE_TOL, f"(c) a greedy step near a tie ({top2})")
    out["decode"] = held("(c) cached decode", gap, lambda v: v <= CAP_DECODE_TOL, control)
    check(torch.equal(beam, ids), "(c) beam search at beam 1 differs from greedy")
    out.update(captions_per_s=CAP_FRAMES / cap_s, decode_tokens_per_s=CAP_FRAMES * len(cached) / decode_s)
    # the CLI: XE, then SCST epochs over the frames' features, the reward's
    # text encodes through K1/K2 (fp32, every block: 12 a reward)
    np.save(tmp / "cap_emb.npy", feats.cpu().numpy())
    rng = np.random.default_rng(CAP_SEED)
    words = ["a", "red", "car", "crowd", "street", "dog", "boat", "night", "people", "park"]
    (tmp / "cap.json").write_text(json.dumps([" ".join(rng.choice(words, size=5)) for _ in range(CAP_FRAMES)]))
    save = tmp / "scst"
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    history, text = quiet(train_captioner.main, [
        "--embeddings", str(tmp / "cap_emb.npy"), "--captions", str(tmp / "cap.json"), "--model", MODEL,
        "--device", "cuda", "--save-dir", str(save), "--seed", str(CAP_SEED), *CAP_TRAIN_ARGV])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    n_val = max(1, int(CAP_FRAMES * 0.1))
    steps = (CAP_FRAMES - n_val) // 16
    want = engine.cfg.text.layers * (2 * steps * len(history) + len(history))
    reloaded = load_captioner(save / "scst_final.pt", device="cuda")
    start = mc.init_captioner_params(torch.Generator().manual_seed(CAP_SEED), mc.CaptionerConfig(image_dim=512))
    log(f"(c) tools.train_captioner ({' '.join(CAP_TRAIN_ARGV)}): {cli_s:.1f} s, history {json.dumps(history)}; "
        f"launches {launches} (expected {want} each); {[ln for ln in text.splitlines() if 'XE' in ln]}")
    check(len(history) == 2 and all(math.isfinite(h["train_reward"]) for h in history), f"(c) history {history}")
    check(all((save / f).exists() for f in ("scst_epoch1.pt", "scst_epoch2.pt", "scst_final.pt")),
          "(c) the captioner's checkpoints")
    check(not torch.equal(reloaded["blocks"][0]["mlp"]["fc"]["kernel"].cpu(), start["blocks"][0]["mlp"]["fc"]["kernel"])
          and all(bool(torch.isfinite(t).all()) for t in reloaded["blocks"][0]["mlp"]["fc"].values()),
          "(c) the reloaded captioner is not the trained one")
    check(all(n == want for n in launches.values()), f"(c) train_captioner launches {launches}, expected {want}")
    for k, n in launches.items():
        out["launches"][k] += n
    out["cli_s"] = cli_s
    return out


def phase_moe_captioner(torch) -> dict:
    """Phase 22: (a) MoE serving, (b) MoE fine-tuning and the (data,
    expert) mesh, (c) the captioner and SCST."""
    t_phase = time.perf_counter()
    out = {"seconds": {}, "launches": {fn.__name__: 0 for fn in moe_counters()}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        out["serving"], moved = moe_serving(torch, tmp)
        out["seconds"]["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["train"] = moe_train(torch, tmp, moved)
        out["seconds"]["b"] = time.perf_counter() - t0
        del moved
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["captioner"] = captioner_phase(torch, tmp)
        out["seconds"]["c"] = time.perf_counter() - t0
    for part in (out["serving"], out["train"], out["captioner"]):
        for k, n in part["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 22 seconds {json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}; launches "
        f"{json.dumps(out['launches'])}")
    return out


def cache_param_draws() -> dict:
    """Seeded random CLIP weights drawn once a (seed, configuration) pair
    for the rest of the process: the script builds dozens of engines and
    trainers from the same few seeds (every ``EmbeddingEngine`` without
    params draws seed 0), and numpy draws about 20 ns a parameter on the
    card's host (8 s for ViT-L/14@336px). Every caller gets its own copy of
    the same values, so nothing any phase holds changes; a numpy
    ``Generator`` argument is drawn from as before. Returns the cache's
    counts (draws, reuses)."""
    import copy

    from evr_tpu_torch import models
    from evr_tpu_torch.index import engine
    from evr_tpu_torch.models import clip

    draw, cache, counts = clip.init_clip_params, {}, {"draws": 0, "reuses": 0}

    def cached(rng, cfg):
        if not isinstance(rng, int):
            return draw(rng, cfg)
        key = (rng, cfg)
        if key in cache:
            counts["reuses"] += 1
        else:
            counts["draws"] += 1
            cache[key] = draw(rng, cfg)
        return copy.deepcopy(cache[key])

    for module in (clip, models, engine):
        module.init_clip_params = cached
    return counts


def predraw_params() -> None:
    """Draw into ``cache_param_draws``'s cache the seeded weights the later
    phases build their engines and trainers from: the main thread does this
    host work while ``nvcc`` compiles the kernels in child processes."""
    from evr_tpu_torch import models

    for name, seed in ((TRAIN_MODEL, 0), (TRAIN_MODEL, HARNESS_SEED), (TRAIN_MODEL, LEVER_SEED),
                       (TRAIN_MODEL, MESH_SEED), (TRAIN_MODEL, AXES_SEED), (DISTILL_TEACHER, LEVER_SEED + 1),
                       (DISTILL_TEACHER, LEVER_SEED + 2), (MODEL, 0)):
        models.init_clip_params(seed, models.get_model_config(name))
    models.init_clip_params(0, models.get_model_config(FLASH_MODEL, attn_impl="flash"))


def _to_cuda(torch, tree):
    from evr_tpu_torch.training.partition import map_with_paths

    return map_with_paths(tree, lambda _, t: t.to("cuda"))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-worker":  # phase 18 (d)'s processes
        return mesh_worker(pathlib.Path(sys.argv[2]))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from evr_tpu_torch.models import get_model_config
    except ImportError as e:
        print(f"chip_smoke: the evr_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    draws = cache_param_draws()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt_dir = tempfile.TemporaryDirectory()
    try:
        from evr_tpu_torch.ops import block_fused as bf
        from evr_tpu_torch.ops.retrieval import fused_topk

        # the kernels compile in child processes while this thread draws the
        # later phases' seeded weights (host work that would otherwise wait)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as pool:
            building = pool.submit(phase_build)
            t_draw = time.perf_counter()
            predraw_params()
            log(f"seeded weights of the later phases drawn in {time.perf_counter() - t_draw:.1f} s during the build")
            building.result()
        gemm = phase_gemm(torch)
        gemm_s8 = phase_gemm_s8(torch)
        worst = phase_parity(torch)
        core_worst = phase_parity_core(torch)
        worst.update(phase_parity_int8(torch))
        worst["fused_topk"] = phase_parity_topk(torch)
        worst.update(phase_parity_bwd(torch))
        attn_bwd_worst = phase_parity_attn_bwd(torch)
        tiny_bwd_worst = phase_parity_tiny_bwd(torch)
        worst["adc_list_scores"] = phase_parity_adc(torch)
        worst.update(phase_parity_flash(torch))
        vis = get_model_config(MODEL).vision
        frames = synthetic_frames(torch, N_FRAMES, vis.image_size, vis.patch_size)
        t0 = time.perf_counter()
        main = phase_main_path(torch, frames, then=lambda e, r: {
            "ann": phase_ann_serving(torch, e, r),
            "searchers": phase_searchers(torch, e, r, frames, ONE_VECTOR_RANK_NOISE, SERVED_RANK_NOISE,
                                         "bf16", [bf.fused_attn_block, bf.fused_mlp_block]),
            "routes": phase_routes(torch, e, r, frames, "bf16", SERVED_RANK_NOISE,
                                   [bf.fused_attn_block, bf.fused_mlp_block], big_umap=True)})
        main_q = phase_main_path_int8(torch, frames, then=lambda e, r: {
            "searchers": phase_searchers(
                torch, e, r, frames, INT8_ONE_VECTOR_RANK_NOISE, INT8_SERVED_RANK_NOISE, "int8",
                [bf.fused_attn_block_q, bf.fused_mlp_block_q], index_dtype="int8", search_impl="pallas"),
            "routes": phase_routes(torch, e, r, frames, "int8", INT8_SERVED_RANK_NOISE,
                                   [bf.fused_attn_block_q, bf.fused_mlp_block_q, fused_topk],
                                   index_dtype="int8", search_impl="pallas")})
        ckpt = pathlib.Path(ckpt_dir.name) / "vitb32.pt"
        ckpt_run = phase_checkpoint(torch, frames, ckpt)
        train = phase_train(torch)
        times = phase_times(torch)
        times[("fused_topk", "vision")], topk_times = phase_times_topk(torch)
        times.update(phase_times_train(torch, gemm))
        core = phase_times_core(torch)
        log("K1/K2 bf16 at ViT-L/14@336px (vitl) and ViT-H-14 (vith): " + ", ".join(
            f"{n} {sh} {times[(n, sh)]['ms']:.4f} ms (library {times[(n, sh)]['library_ms']:.4f})"
            for sh in ("vitl", "vith") for n in ("fused_attn_block", "fused_mlp_block")))
        log("K1's attention core alone (attn_forward, bf16): " + ", ".join(
            f"{sh} {core[sh]['ms']:.4f} ms of K1's "
            f"{times[('fused_attn_block', 'vision' if sh == 'vitb' else sh)]['ms']:.4f} "
            f"(SDPA {core[sh]['library_ms']:.4f}, bound {core[sh]['bound_ms']:.4f})"
            for sh in ("vith", "vitl", "vitb")) + f"; text {core['text']['ms']:.4f} ms "
            f"(SDPA {core['text']['library_ms']:.4f}); parity max abs err {core_worst:.3e}")
        t1 = time.perf_counter()
        ann = phase_ann_large(torch)
        worst["adc_list_scores"] = max(worst["adc_list_scores"], ann["max_abs_err"])
        times[("adc_list_scores", "vision")] = phase_times_adc(torch, ann.pop("index"), ann.pop("cids"),
                                                               ann.pop("tables"))
        tool = phase_index_tool(torch, ckpt)
        ann_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        flash_cfg, flash_np = flash_params()
        main_f = phase_main_path_flash(torch, flash_cfg, flash_np)
        main_fq = phase_main_path_flash(torch, flash_cfg, flash_np, params_dtype="int8")
        train_f = phase_train_flash(torch, flash_cfg, flash_np)
        times.update(phase_times_flash(torch))
        flash_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        main_h = phase_main_path_vith(torch, flash_np)
        main_hq = phase_main_path_vith(torch, flash_np, params_dtype="int8")
        del flash_np
        vith_s = time.perf_counter() - t3
        k8 = phase_layer_norm(torch)
        k9 = phase_merged(torch)
        t4 = time.perf_counter()
        tiny = phase_tiny(torch)
        tiny_s = time.perf_counter() - t4
        ingest = phase_ingest(torch)
        harness = phase_harness(torch)
        variants = phase_variants(torch)
        t5 = time.perf_counter()
        levers = phase_levers(torch)
        distill = phase_distill(torch)
        lever_clis = phase_lever_clis(torch)
        phase17_s = time.perf_counter() - t5
        mesh = phase_mesh(torch, frames)
        axes = phase_axes(torch, frames)
        annot = phase_annotators(torch)
        families = phase_families(torch)
        t6 = time.perf_counter()
        moe_cap = phase_moe_captioner(torch)
        phase22_s = time.perf_counter() - t6
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        ckpt_dir.cleanup()
    for tag, m in (("bf16", main), ("int8", main_q)):
        log(f"main path {tag}: encode {m['encode_frames_per_s']:.1f} frames/s "
            f"(batch {BATCH}, {N_FRAMES} frames), text query p50 "
            f"{m['text_query_p50_ms']:.2f} ms, /api/search p50 {m['request_p50_ms']:.2f} ms")
    for tag, m in (("bf16", main["then"]["searchers"]), ("int8", main_q["then"]["searchers"])):
        t = m["threads"]
        log(f"searchers {tag}: uncached text query p50 one call {m['p50_one_call_ms']:.3f} ms, two steps "
            f"{m['p50_two_step_ms']:.3f} ms; {N_THREADS} threads unbatched p50 {t['unbatched']['p50_ms']:.3f} ms "
            f"{t['unbatched']['qps']:.1f} queries/s, window {BATCH_WINDOW_MS} ms p50 {t['batched']['p50_ms']:.3f} "
            f"ms {t['batched']['qps']:.1f} queries/s, dispatch sizes {m['dispatches']}")
    log(f"checkpoints: {MODEL} reference file ({ckpt_run['bytes'] / 1e6:.1f} MB) to the card "
        f"{ckpt_run['bfloat16']['load_s']:.2f} s (bf16), {ckpt_run['int8']['load_s']:.2f} s (int8); "
        f"from_checkpoint {ckpt_run['bfloat16']['from_checkpoint_s']:.2f} / "
        f"{ckpt_run['int8']['from_checkpoint_s']:.2f} s; {TRAIN_MODEL} best_model.pt (EMA) to the card "
        f"{train['served']['load_s']:.2f} s, from_checkpoint {train['served']['from_checkpoint_s']:.2f} s; "
        f"classes of {TRAIN_SERVE_FRAMES} served frames {train['served']['classes']}")
    log(f"main path training: {TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16: step {train['step_s']:.4f} s, "
        f"{train['samples_per_s']:.2f} samples/s; checkpoint saves {json.dumps(train['checkpoint_s'])} s; "
        f"kernel vs plain step: {json.dumps(train['compared'])}")
    split = times["k5a_split"]
    log(f"K5 at {TRAIN_MODEL}, bf16: K5a {times[('fused_attn_block_bwd', 'vitl')]['ms']:.4f} ms (attention "
        f"backward {split['attention_ms']:.4f}, its bound {split['attention_bound_ms']:.4f}, SDPA's backward "
        f"{split['attention_library_ms']:.4f}; GEMMs {split['gemm_ms']:.4f}, rest {split['rest_ms']:.4f}), "
        f"K5b {times[('fused_mlp_block_bwd', 'vitl')]['ms']:.4f} ms; attention backward parity max abs err "
        f"{attn_bwd_worst:.3e}")
    log(f"C4: K5a/K5b at W 64, head dim 16 ({', '.join(TINY_BWD_SHAPES)}) and attn_backward at d 16 "
        f"({', '.join(TINY_ATTN_BWD_SHAPES)}) within their bands, largest bf16 error {tiny_bwd_worst:.3e}")
    k4 = times[("fused_topk", "vision")]
    log(f"K4 (fused_topk), int8 {TOPK_ROWS} x {TOPK_DIM}, Q=1, k=30: {k4['ms']:.4f} ms (library "
        f"{k4['library_ms']:.4f}, bound {k4['bound_ms']:.4f}); split "
        + ", ".join(f"{p} {v:.4f}" for p, v in topk_times["split"].items()) + " ms; "
        + ", ".join(f"{c} {r['ms']:.4f} ms (library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f})"
                    for c, r in topk_times["cases"].items()))
    k7 = times[("adc_list_scores", "vision")]
    log(f"K7 (adc_list_scores) in place at P={ANN_B * ANN_NPROBE}: the call {k7['ms']:.4f} ms (CUDA events; "
        f"K7's launch {k7['device_ms']:.4f} ms on the device, bound {k7['bound_ms']:.4f}, library "
        f"{k7['library_ms']:.4f}); the parent's form, gather + kernel, {k7['parent_form_ms']:.4f} ms (device "
        f"{k7['parent_form_device_ms']:.4f}, the copy {k7['gather_copy_ms']:.4f}); query split "
        f"{json.dumps({k: round(v, 4) for k, v in ann['split'].items()})}")
    log(f"ann tiers: /api/search p50 ivf {main['then']['ann']['ivf']:.2f} ms, ivfpq (host store) "
        f"{main['then']['ann']['ivfpq']:.2f} ms; large IVF-PQ ({ANN_ROWS} x {ANN_DIM}, {ANN_LISTS} lists): "
        f"build {ann['build_s']:.2f} s, pool {ann['pool']} rows, recall@10 {ann['recall']:.4f} "
        f"(re-rank 50: {ann['recall_rerank']:.4f}), query p50 K7 {ann['p50_pallas']:.3f} ms / "
        f"gather-sum {ann['p50_xla']:.3f} ms at nprobe {ANN_NPROBE}, B {ANN_B} (in turns: "
        f"{json.dumps(ann['nprobe_p50'])}, with an id read-back {json.dumps(ann['nprobe_synced_p50'])}); "
        f"full probe {json.dumps(ann['full_p50'])} ms (chunked as the gathered copy "
        f"{json.dumps(ann['full_gathered_chunks_p50'])}); index_tool build "
        f"{tool['build_s']:.2f} s, query {tool['query_s']:.2f} s; the large tier and the tool took "
        f"{ann_s:.1f} s")
    log(f"flash route, {FLASH_MODEL}: encode {main_f['encode_frames_per_s']:.1f} frames/s (batch {BATCH}, "
        f"{N_FRAMES} frames), text query p50 {main_f['text_query_p50_ms']:.2f} ms, /api/search p50 "
        f"{main_f['request_p50_ms']:.2f} ms; against K6's plain version {json.dumps(main_f['against_plain'])}; "
        f"train step (batch {TRAIN_BATCH}, bf16) {train_f['step_s']:.4f} s, {train_f['samples_per_s']:.2f} "
        f"samples/s, peak {train_f['peak_gib']:.1f} GiB; K6 step vs plain step {json.dumps(train_f['compared'])}; "
        f"the flash phases took {flash_s:.1f} s")
    log(f"flash route, {FLASH_MODEL}, int8 weights: encode {main_fq['encode_frames_per_s']:.1f} frames/s, "
        f"text query p50 {main_fq['text_query_p50_ms']:.2f} ms, /api/search p50 "
        f"{main_fq['request_p50_ms']:.2f} ms; against K6's plain version {json.dumps(main_fq['against_plain'])}")
    for tag, m in (("bf16", main_h), ("int8", main_hq)):
        log(f"default route (auto), {FLASH_MODEL}, {tag}: encode {m['encode_frames_per_s']:.1f} frames/s "
            f"(batch {BATCH}, {N_FRAMES} frames), text query p50 {m['text_query_p50_ms']:.2f} ms, "
            f"/api/search p50 {m['request_p50_ms']:.2f} ms; against the plain route "
            f"{json.dumps(m['against_plain'])}")
    log(f"the {FLASH_MODEL} default-route phases took {vith_s:.1f} s")
    for width, (b, q) in ((MODEL, (main, main_q)), (FLASH_MODEL, (main_h, main_hq))):
        log(f"int8 against bf16 encode, {width}: {q['encode_frames_per_s']:.1f} against "
            f"{b['encode_frames_per_s']:.1f} frames/s ({q['encode_frames_per_s'] / b['encode_frames_per_s']:.3f}x)")
    for shape, tag in (("vision", "vitb"), ("vith", "vith")):
        for half, names in (("fused_attn_block_q", ("qkv", "out")), ("fused_mlp_block_q", ("fc", "proj"))):
            copy_ms = sum(gemm_s8[(tag, n)]["copy_ms"] for n in names)
            half_ms = times[(half, shape)]["ms"]
            log(f"{half} {shape}: the K-major copies of its two kernels, made once per weight, would take "
                f"{copy_ms:.4f} ms a call, {100 * copy_ms / half_ms:.2f} % of its {half_ms:.4f} ms")
    log("gemm_s8 TOP/s (torch._int_mm): " + ", ".join(
        f"{tag}-{n} {g['ops'] / g['ms'] / 1e9:.1f} ({g['ops'] / g['library_ms'] / 1e9:.1f})"
        for (tag, n), g in gemm_s8.items()))
    log(f"{TINY_MODEL} (phase 12, {tiny_s:.1f} s): kernels against their plain versions, largest bf16 error "
        f"{tiny['max_abs_err']:.3e}; " + "; ".join(
            f"{r} encode {tiny[r]['encode_frames_per_s']:.1f} frames/s, launches {json.dumps(tiny[r]['launches'])}, "
            f"least row cosine {min(tiny[r]['frame_cos'], tiny[r]['text_cos']):.7f}"
            for r in ("bf16", "int8", "flash")))
    log("gemm_bf16 TFLOP/s: " + ", ".join(
        f"{tag} {g['tflops']:.1f} (torch.matmul {g['flops'] / g['library_ms'] / 1e9:.1f})"
        for tag, g in gemm.items()))
    log(f"everything after the parity phases {time.perf_counter() - t0:.1f} s, "
        f"the whole script {time.perf_counter() - start:.1f} s; seeded CLIP weights drawn {draws['draws']} times "
        f"and reused {draws['reuses']} times (cache_param_draws)")
    for tag, m in (("bf16", main["then"]["routes"]), ("int8", main_q["then"]["routes"])):
        log(f"routes {tag}: launches {json.dumps(m['launches'])}; /api/search p50 ms "
            f"{json.dumps({k: round(v, 3) for k, v in m['p50_ms'].items()})}; UMAP route over {N_FRAMES} frames "
            f"{m['umap_route_s']:.3f} s (cached {m['umap_cached_ms']:.2f} ms); the phase {m['seconds']:.1f} s")
    lg, fo = ingest["long"], ingest["folder"]
    log(f"ingest (phase 15, {ingest['seconds']:.1f} s): the long video, {lg['video_frames']} frames of "
        f"{INGEST_SIZE[0]}x{INGEST_SIZE[1]} to {lg['frames']} scene frames, {lg['seconds']:.2f} s, "
        f"{lg['video_frames'] / lg['seconds']:.1f} video frames/s; split s "
        f"{json.dumps({k: round(v, 3) for k, v in lg['split'].items()})}; sync upload {ingest['sync']['frames']} "
        f"frames, int8 upload {ingest['int8']['frames']} frames in {ingest['int8']['seconds']:.2f} s; launches "
        f"{json.dumps(ingest['launches'])}; least ingested row cosines bf16 {lg['rows']['frame_cos']:.6f} / "
        f"{ingest['sync']['rows']['frame_cos']:.6f}, int8 {ingest['int8']['rows']['frame_cos']:.6f}")
    log(f"ingest: embed_folder {fo['frames']} JPEGs {fo['frames'] / fo['seconds']:.1f} frames/s, the stager "
        f"alone {fo['frames'] / fo['stage_s']:.1f}, encode_staged_images alone {fo['frames'] / fo['encode_s']:.1f}; "
        f"cv2 against PIL decode {fo['decode_levels']} levels")
    log(f"harness (phase 16, {harness['phase_s']:.1f} s): images/s and captions/s "
        f"{json.dumps({k: {m: round(x, 1) for m, x in v.items()} for k, v in harness['speeds'].items()})}; rsum "
        f"{json.dumps({k: round(v, 4) for k, v in harness['rsum'].items()})}; tool seconds "
        f"{json.dumps({k: round(v, 2) for k, v in harness['seconds'].items()})}; against the plain twins "
        + "; ".join(f"{k}: rows {min(h['row_cos'].values()):.6f}, violations {h['violations']}, metric gap "
                    f"{max(h['metric_gap'].values()):.6f} of share {min(h['share'].values()):.4f}"
                    for k, h in harness["held"].items()))
    pr = variants["progressive"]
    log(f"trainer variants (phase 16, {variants['phase_s']:.1f} s), {TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16: "
        f"progressive s/step " + ", ".join(f"phase {ph} {[round(r['step_s'], 4) for r in pr[ph]['steps']]}"
                                           for ph in pr)
        + f"; K5a/K5b a step {pr[3]['steps'][-1]['launches']['fused_attn_block_bwd']} in every phase; the second "
        f"steps' least gradient-leaf cosines {[round(pr[ph]['steps'][-1]['grads']['least_leaf_cos'], 6) for ph in pr]} "
        f"(band {STEP_BF16_BANDS[2]}), losses apart by up to "
        f"{max(r['loss_rel'] for ph in pr for r in pr[ph]['steps']):.2e}; "
        f"catlip s/step {[round(r['step_s'], 4) for r in variants['catlip']]}, least gradient-leaf cosines "
        f"{[round(r['grads']['least_leaf_cos'], 6) for r in variants['catlip']]}; projection ({MODEL}) "
        f"{variants['projection']['step_s']:.4f} s/step, encode_projected row cosine "
        f"{variants['projection']['row_cos']:.6f}")
    lv = {k: levers[k] for k in "abcdefgh"}
    log(f"trainer levers (phase 17, {phase17_s:.1f} s: levers {levers['phase_s']:.1f}, distillation "
        f"{distill['phase_s']:.1f}), {TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16: s/step kernel / plain twin "
        + ", ".join(f"({k}) {[round(r['kernel_s'], 4) for r in v['calls']]} / "
                    f"{[round(r['twin_s'], 4) for r in v['calls'] if 'twin_s' in r]}" for k, v in lv.items())
        + "; least vision-block gradient cosines "
        + ", ".join(f"({k}) {[round(g['least_leaf_cos'], 6) for g in v['grads']]}" for k, v in lv.items() if "grads" in v)
        + f" (band {STEP_BF16_BANDS[2]}); GradCache vs the direct step {levers['e']['direct']['least_leaf_cos']:.6f}; "
        f"emitted mean error {levers['a']['mean_err']:.2e}; remat bit-equal {levers['d']['bit_equal']}; "
        f"Newton-Schulz {levers['b']['ns_s']:.4f} s a step; peak memory GiB (the step's own above its start): "
        f"(a) {lv['a']['calls'][0]['kernel_peak_gib']:.1f} ({lv['a']['calls'][0]['kernel_extra_gib']:.1f}), "
        f"(d) remat {lv['d']['calls'][0]['kernel_peak_gib']:.1f} ({lv['d']['calls'][0]['kernel_extra_gib']:.1f}), "
        f"(e) GradCache {lv['e']['calls'][0]['kernel_peak_gib']:.1f} ({lv['e']['calls'][0]['kernel_extra_gib']:.1f})")
    ls = lever_clis["sustained"]
    log(f"distillation ({DISTILL_TEACHER} -> {DISTILL_STUDENT}): teacher rows {distill['row_cos']:.7f}, KD loss "
        f"rel {distill['grads']['loss_rel']:.2e}, student gradients norm rel {distill['grads']['norm_rel']:.2e}, "
        f"least leaf cosine {distill['grads']['least_leaf_cos']:.7f} (bands {DISTILL_BANDS}); s/step "
        f"{[round(r['kernel_s'], 4) for r in distill['steps']]} / {[round(r['twin_s'], 4) for r in distill['steps']]}; "
        f"CLIs: LoRA fit {lever_clis['lora_cli']['fit_s']:.1f} s, distill {lever_clis['distill_cli']['seconds']:.1f} s; "
        f"train_sustained {ls['steps']} steps {ls['sustained_ex_per_s']:.1f} examples/s, R@1/5/10 "
        f"{[ls['before'][k] for k in ('R@1', 'R@5', 'R@10')]} -> {[ls['after'][k] for k in ('R@1', 'R@5', 'R@10')]}")
    st, eng = mesh["steps"], mesh["engine"]
    log(f"mesh (phase 18, {mesh['seconds']:.1f} s; {card}): sharded search p50 ms, one query, 1 slot / "
        f"{MESH_SEARCH_SLOTS} slots, {MESH_ROWS} x {MESH_DIM}: "
        + json.dumps({k: {t: round(v, 3) for t, v in d.items()} for k, d in mesh["search"]["p50_ms"].items()})
        + f"; mesh engine ({MESH_TRAIN_SLOTS} slots, {MODEL}) bf16 {eng['bfloat16']['encode_frames_per_s']:.1f} / "
        f"int8 {eng['int8']['encode_frames_per_s']:.1f} frames/s; {TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16, s/step "
        + json.dumps({k: [round(s, 4) for s in v] for k, v in st["s_per_step"].items()})
        + f"; FSDP {st['bytes']['slot'] / 2**30:.3f} GiB a slot of {st['bytes']['replicated'] / 2**30:.3f} GiB; "
        f"{MESH_TRAIN_SLOTS} slots vs 1: {json.dumps(st['grads'])}; {mesh['processes']['processes']} process(es) "
        f"({mesh['processes']['backend']}) vs the step: {json.dumps(mesh['processes']['grads'])}; the FSDP CLI run "
        f"{mesh['cli']['run_s']:.1f} s, resumed {mesh['cli']['resume_s']:.1f} s; launches {json.dumps(mesh['launches'])}")
    an, ppr, spr, tpr, lvr = axes["ann"], axes["pp"], axes["sp"], axes["tp"], axes["levers"]
    log(f"other mesh axes (phase 19, {axes['seconds']['phase']:.1f} s; {card}): sharded IVF-PQ p50 ms at nprobe "
        f"{AXES_NPROBE} {json.dumps({k: round(v, 3) for k, v in an['p50_ms'].items()})}, recall@10 "
        f"{json.dumps(an['recall@10'])}, served ivfpq p50 {an['served_p50_ms']:.2f} ms; pipelined frames/s "
        f"{json.dumps({k: round(v, 1) for k, v in ppr['frames_per_s'].items()})}; sp peak GiB "
        f"{json.dumps({k: round(v, 3) for k, v in spr['peak_gib'].items()})}; tp s/step "
        + json.dumps({k: [round(x, 4) for x in v] for k, v in tpr["s_per_step"].items()})
        + f", bytes a slot {json.dumps({k: round(v['slot'] / 2**30, 3) for k, v in tpr['bytes'].items()})} GiB; "
        f"levers s {json.dumps({k: (round(v, 4) if isinstance(v, float) else [round(x, 4) for x in v]) for k, v in lvr['s'].items()})}; "
        f"launches {json.dumps(axes['launches'])}")
    ao, at, zb, zq = annot["ocr"], annot["train"], annot["zeroshot_float32"], annot["zeroshot_int8"]
    log(f"frame annotators (phase 20, {annot['seconds']['phase']:.1f} s; {card}): OCR logits card against CPU "
        f"{ao['logit_gap']:.3e} (band {OCR_LOGIT_BAND}), detector {ao['detect_ms_per_frame']:.2f} ms a frame, "
        f"recogniser {ao['recogniser_crops_per_s']:.1f} crops/s, annotate_batch {ao['annotate_frames_per_s']:.1f} "
        f"frames/s, fonts {ao['fonts']}; OCR step {at['step_s'] * 1e3:.2f} ms, loss rel {at['loss_rel']:.2e}, "
        f"gradients {at['grad_err']:.2e}, train_ocr loss {at['loss']:.4f} in {at['train_s']:.2f} s; zero-shot "
        + "; ".join(f"{tag}: sims gap {z['gap']:.3e}, {z['crops_per_s']:.1f} crops/s, {z['frames_per_s']:.1f} "
                    f"frames/s, classifier {z['build_s']:.3f} s, launches {json.dumps(z['launches'])}"
                    for tag, z in (("bf16", zb), ("int8", zq)))
        + f"; annotated upload {annot['upload']['frames']} frames in {annot['upload']['seconds']:.2f} s")
    fs, ft, fw = families["serving"], families["train"], families["whisper"]
    log(f"model families (phase 21, {families['seconds']['phase']:.1f} s; {card}): SigLIP "
        f"{FAMILY['siglip_parity']} card against CPU " + ", ".join(
            f"{k} {v['value']:.2e}" for k, v in families["parity"].items())
        + f"; {FAMILY['siglip_serve']} encode frames/s " + ", ".join(
            f"{d} {fs[d]['encode_frames_per_s']:.1f}" for d in ("float32", "bfloat16", "int8"))
        + f", /api/search p50 ms " + ", ".join(f"{d} {fs[d]['request_p50_ms']:.2f}" for d in fs)
        + f", text query p50 {fs['bfloat16']['text_query_p50_ms']:.2f} ms (bf16), rows against fp32 "
        + ", ".join(f"{d} {fs[d]['rows']['value']:.6f} (scores apart up to {fs[d]['score_diff']:.2e})"
                    for d in ("bfloat16", "int8"))
        + f"; fit_siglip {FAMILY['siglip_train']} batch {FAMILY['train_batch']} fp32 {ft['step_s']:.3f} s/step, "
        f"losses {[round(x, 4) for x in ft['losses']]}, gradients card against CPU {ft['grads']['value']:.2e}, "
        f"updates cos {ft['updates']['value']:.6f}, 2 slots against 1 {json.dumps(ft['mesh'], default=str)}; Whisper "
        f"{FAMILY['whisper']} decode {fw['decode_tokens_per_s']:.1f} tokens/s ({FAMILY['windows']} windows, "
        f"max_len {FAMILY['max_len']}), against the full re-run {fw['decode']['value']:.2e} (row zeroed "
        f"{fw['decode']['control']:.2e}), least top-2 gap {fw['least_top2_gap']:.3f}, bf16 logits cos "
        f"{fw['bf16']['value']:.6f}, {FAMILY['whisper_parity']} card against CPU {fw['base']['value']:.2e}; "
        f"transcribe CLI {families['transcription']['cli_s']:.1f} s, voice route "
        f"{families['transcription']['voice_s']:.2f} s; profiler splits (wall under the trace, device ms, top "
        f"kernels) {json.dumps(families['split'])}")
    ms, mt, mc_ = moe_cap["serving"], moe_cap["train"], moe_cap["captioner"]
    log(f"MoE and captioner (phase 22, {phase22_s:.1f} s; {card}): MoE {MODEL} bf16 encode "
        f"{ms['encode_frames_per_s']:.1f} frames/s, rows against fp32 plain {ms['rows']['value']:.6f}, step 0 "
        f"against dense {ms['step0']['value']:.6f}, served /api/search p50 {ms['request_p50_ms']:.2f} ms; MoE fine-tune "
        f"s/step {[round(x, 4) for x in mt['step_s']]}, moe_aux {mt['moe_aux']:.5f}, (data 2, expert 2) against one "
        f"device {json.dumps(mt['mesh'])}; captions/s {mc_['captions_per_s']:.1f}, cached decode "
        f"{mc_['decode_tokens_per_s']:.1f} tokens/s, against a full re-run {mc_['decode']['value']:.2e} (row zeroed "
        f"{mc_['decode']['control']:.2e}), train_captioner {mc_['cli_s']:.1f} s; launches {json.dumps(moe_cap['launches'])}; "
        f"phases 1-21 {t6 - start:.1f} s")
    big = main["then"]["routes"]
    log(f"viz.umap at {UMAP_ROWS} x {UMAP_DIM}: {big['umap_big_s']:.2f} s, neighbours kept "
        f"{json.dumps(big['knn_kept'])}")
    launches = {**main["launches"], **main_q["launches"]}
    # the routes phase's launches on its kernel paths (K1/K2 bf16, K3a/K3b and K4 int8)
    for m in (main["then"]["routes"], main_q["then"]["routes"]):
        for name, n in m["launches"].items():
            launches[name] += n
    # the ingest phase's uploads (K1/K2 bf16, K3a/K3b int8) and its negative query (K4)
    for name, n in ingest["launches"].items():
        launches[name] += n
    launches.update({k: train["launches"][k] for k in ("fused_attn_block_bwd", "fused_mlp_block_bwd")})
    # phase 16: the harness's runs (K1/K2 bf16, K3a/K3b int8) and the trainer
    # variants (K1/K2 forward, K5a/K5b backward, encode_projected's K1/K2)
    # phase 17: the levers' steps, the distillation steps and the three CLIs
    # phase 18: the sharded search (K4), the mesh engine and its serving (K1/K2,
    # K3a/K3b), the mesh steps, the two processes and the FSDP CLI (K1/K2, K5)
    # phase 19: the pipelined encodes (K1/K2, K3a/K3b), the tensor-parallel
    # steps and the levers over a mesh (K1/K2, K5), the served ivfpq tier's
    # encodes (K1/K2) and the sharded IVF-PQ searches (K7)
    # phase 20: the zero-shot annotator's crops and classifier (K1/K2 bf16,
    # K3a/K3b int8) and the annotated upload (K1/K2)
    # phase 22: the MoE engine's encodes and its served queries, the
    # captioner's frame encode and the SCST reward's text encodes (K1/K2)
    for m in (harness["launches"], variants["launches"], levers["launches"], distill["launches"],
              lever_clis["launches"], mesh["launches"], axes["launches"], annot["launches"],
              moe_cap["launches"]):
        for name, n in m.items():
            if name != "adc_list_scores":  # K7's: phase 13's large tier and phase 19's, below
                launches[name] += n
    launches["adc_list_scores"] = ann["launches"] + axes["launches"]["adc_list_scores"]
    launches.update({k: main_f["launches"][k] for k in FLASH_MAIN_SHAPE})
    # K8 and K9 have no caller on a serving path: their launches are those of
    # their own phases, through the entry points the ops package exports
    launches["fused_layer_norm"] = k8["launches"]
    launches["fused_block_merged"] = k9["launches"]
    worst["fused_layer_norm"] = k8["max_abs_err"]
    worst["fused_block_merged"] = k9["max_abs_err"]
    times[("fused_layer_norm", LN_MAIN_CASE)] = k8["times"]["none"]
    times[("fused_block_merged", "vision")] = k9["times"]
    sources = {
        "fused_attn_block": ("evr_tpu_torch/ops/csrc/block_attn.cu", "evr_tpu/ops/block_fused.py:340"),
        "fused_mlp_block": ("evr_tpu_torch/ops/csrc/block_mlp.cu", "evr_tpu/ops/block_fused.py:1038"),
        "fused_attn_block_q": ("evr_tpu_torch/ops/csrc/block_quant.cu", "evr_tpu/ops/block_fused.py:865"),
        "fused_mlp_block_q": ("evr_tpu_torch/ops/csrc/block_quant.cu", "evr_tpu/ops/block_fused.py:894"),
        "fused_topk": ("evr_tpu_torch/ops/csrc/topk_fused.cu", "evr_tpu/ops/retrieval_pallas.py:142"),
        "fused_attn_block_bwd": ("evr_tpu_torch/ops/csrc/block_attn_bwd.cu", "evr_tpu/ops/block_fused.py:618"),
        "fused_mlp_block_bwd": ("evr_tpu_torch/ops/csrc/block_mlp_bwd.cu", "evr_tpu/ops/block_fused.py:698"),
        "adc_list_scores": ("evr_tpu_torch/ops/csrc/adc_list.cu", "evr_tpu/ops/adc_pallas.py:137"),
        "flash_attention_full": ("evr_tpu_torch/ops/csrc/flash_attn.cu", "evr_tpu/ops/attention.py:188"),
        "flash_attention_blocked": ("evr_tpu_torch/ops/csrc/flash_attn.cu", "evr_tpu/ops/attention.py:224"),
        "fused_layer_norm": ("evr_tpu_torch/ops/csrc/layernorm.cu", "evr_tpu/ops/layernorm.py:58"),
        "fused_block_merged": ("evr_tpu_torch/ops/csrc/block_merged.cu", "evr_tpu/ops/block_fused.py:293"),
    }
    kernels = []
    main_shape = {**FLASH_MAIN_SHAPE, "fused_layer_norm": LN_MAIN_CASE}
    for name, (src, replaces) in sources.items():
        shape = main_shape.get(name, "vitl" if name.endswith("_bwd") else "vision")
        t = times[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # K7: its launch's device time (torch.profiler) beside the call's
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
