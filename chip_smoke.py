#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``synapseml_tpu_torch``) on one card.

    python3 chip_smoke.py [--rows N]

Needs one NVIDIA Hopper card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``)
and the repository beside this file; without a card, or run from a directory
that does not hold the package, it prints no result and exits non-zero.
Phases, each of which fails the run if it fails:

1. the card's name and power limit; build every CUDA kernel from
   ``synapseml_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
2. kernels: ``child_histogram``, ``range_histogram`` and
   ``level_histograms`` against their plain PyTorch versions on the card at
   the main paths' shapes (FP = 32 padded features, B = 256 bins,
   ``--rows`` rows; the level kernel over those rows laid out in 31
   chunk-aligned slots of uneven size, as the depthwise grower lays them
   out), rtol 1e-5 / atol 1e-3 on the gradient and hessian sums (atomics
   add in an order that changes from run to run) and exact counts; each
   timed with CUDA events beside its plain version, one
   ``index_put_(accumulate=True)`` call (a yardstick the port never calls)
   and its bound on the H100 (bytes over 3.35 TB/s, float32 adds over
   67 TFLOP/s, the larger); all three again on fit-shaped bins (the padded
   features all in bin 0, held to the float64 sum within ``PAD_SUM_ULPS``
   units of roundoff of the sum of magnitudes; per slot for the level
   kernel), the level kernel also at B = 512 and logged beside the tensor
   floor of its one-hot design; then all three at B = 4096, 8192 and 32768
   (``LARGE_BINS``, 500k rows, some bins outside [0, B); at 32768 the
   leaf-wise kernels run two 16384-bin windows, the level kernel sixteen
   of 2048), each timed;
3. main path: ``LightGBMClassifier(numIterations=10, numLeaves=31,
   maxBin=255).fit`` on a HIGGS-shaped ``Table`` (28 dense float32
   features, ``--rows`` rows), then ``.transform`` and ``saveNativeModel``;
   the kernels' launch counts are zeroed just before and read just after,
   and ``child_histogram`` and ``range_histogram`` must be above 0;
4. depthwise path: ``train_booster`` with ``growth_policy="depthwise"``
   (10 iterations, 31 leaves, max_bin 255) on the same table, then
   ``predict`` and a model-string reload; counts zeroed just before and
   read just after, ``level_histograms`` must be above 0;
5. cross-check: both paths on 100,000 rows for 3 iterations on the card and
   on the CPU (plain versions); AUCs within 1e-3 and mean absolute
   probability difference at most 1e-3 (atomics can flip near-tie splits);
6. one torch.profiler pass over each boosting loop: device time by kernel;
7. flash kernels: ``flash_attention`` and ``flash_attention_block`` against
   their plain PyTorch versions on the card (causal and not, S_q != S_k,
   non-divisible lengths, strided inputs, bf16, offsets with a block wholly
   in the causal future, ``m = -inf`` rows), rtol 2e-4 / atol 2e-5 in
   float32 and 8e-3 / 1e-3 in bf16 (both sides round p to bf16); then at the seq path's shapes (Ulysses:
   (4, 8192, 4, 32) per rank; ring step: (4, 4096, 8, 32) against 4096 keys)
   each timed beside its plain version, its bound on the tensor cores
   (float32 as three TF32 products per product over 495 TFLOP/s, bf16
   over 989 TFLOP/s, or bytes over 3.35 TB/s, the larger) and, for
   ``flash_attention``, one ``scaled_dot_product_attention`` call (a
   yardstick the port never calls; no single PyTorch call computes the
   ring's carried-state step); causal and bf16 cases timed as well; both
   kernels also at head dims 96 and 128 (the DP = 128 instantiation) and
   192 and 256 (the wide kernel) against their plain versions, and timed
   with D = 128 and D = 256 at the path's lengths ((4, 8192, 4, D) beside
   SDPA; (4, 4096, 8, D));
8. seq path: ``TransformerEncoder(mask_free=True)`` at
   ``DeepTextClassifier``'s widths (vocab 32768, 4 layers, 8 heads, hidden
   256, MLP 1024; float32, random weights from a seed in the JAX package's
   flax layout, carried by ``convert.text_encoder_from_reference``) on
   batch 4 x 8192 ``hash_tokenize`` ids: two ranks of ``torch.distributed``
   (gloo, CUDA tensors staged through pinned host memory) share the card on
   the mesh ``{"seq": 2}`` and run the forward inside
   ``seq_attention_scope`` with ring, then Ulysses attention; launch counts
   zeroed just before each forward and read just after (per rank: 8
   ``flash_attention_block`` for the ring, 4 ``flash_attention`` for
   Ulysses); logits within rtol 2e-4 / atol 2e-5 of the same encoder out of
   scope on the card (plain attention), ring and Ulysses within 1e-5 of
   each other. Then ``sharded_self_attention`` of a (2, 4095, 8, 32)
   sequence (padded to the shard grid) with each variant: within rtol 2e-4
   / atol 2e-5 of ``attention_reference`` on the card, through the kernels
   (2 ring-step launches, 1 Ulysses launch per rank). A failed rank fails
   the run;
9. training: ``DeepTextClassifier(seqParallel=True, seqAxisSize=2)`` at
   its default widths (vocab 32768, 4 layers, 8 heads, hidden 256, MLP
   1024, adamw), ``maxTokenLen`` 8192, batch 4, on 8 synthetic texts from
   a seed: two gloo ranks sharing the card each call ``fit`` (mesh
   ``{"data": 1, "seq": 2}``) for 2 steps with ring attention, then 2 with
   Ulysses (each model then ``transform``s the table), then 1 step with
   ``precision="bfloat16"`` ("auto", which resolves to ring). Launch counts
   zeroed just before each fit and transform and read just after; every
   training forward must launch 8 ``flash_attention_block`` (ring) or 4
   ``flash_attention`` (Ulysses) per rank (forward hooks read the counts
   around it). Losses finite, parameters bitwise equal across the ranks
   (sha256), the ring's first-step loss within rtol 2e-4 of the same step
   out of scope on the card (plain attention, one process) and within 1e-5
   of Ulysses'; per step forward, backward, gradient all-reduce and update
   seconds, staged bytes and peak memory logged per rank, each flash
   kernel's recompute backward timed alone at the path's shape, and one
   more ring step in the warmed ranks profiled on rank 0 (device busy time
   by kernel);
10. the objective family on synthetic tables made from a seed:
   ``LightGBMRegressor(objective="regression")`` (5 iterations, 31 leaves,
   max_bin 255) on the HIGGS-shaped ``--rows`` table with its continuous
   margin as the label, then ``transform``, ``saveNativeModel`` and a
   reload; ``LightGBMClassifier`` with 7 classes on a Covertype-shaped
   table (581,012 rows, 10 numeric and 44 one-hot columns; 35 trees), and
   the same fit depthwise through ``train_booster``; ``LightGBMRanker(
   maxPosition=20)`` on an MSLR-WEB10K-shaped table (10,000 queries, about
   1.2M rows, 136 features, labels 0-4, groups of mean about 120 and at
   most 908). Counts zeroed just before each fit and read just after
   (``child_histogram`` and ``range_histogram``, or ``level_histograms``
   depthwise, above 0); fit seconds, rows x iterations per second and peak
   memory logged, and for the ranker one iteration's lambdarank gradients
   timed alone with their peak memory. Then every objective (regression,
   l1, huber, fair, poisson, quantile, mape, gamma, tweedie and
   cross_entropy regressors, multiclass and multiclassova classifiers, the
   ranker) at 50,000 rows for 3 iterations on the card and on the CPU
   (the CPU fits in 4 spawned processes, started beside the full-width
   fits):
   mean absolute prediction gap at most 1e-3 of the CPU's mean absolute
   prediction, class predictions equal on 99.9% of rows.
11. vision: ``DeepVisionClassifier(backbone="resnet50")`` at 224x224
   (ImageNet stem) on CIFAR-10-shaped synthetic images from a seed (uint8
   32x32x3, 10 classes, each a class colour plus noise) resized on the
   host: fit A with the estimator's defaults (batch 16, the last two
   blocks and the head trained, adam 1e-3, float32) on 512 images, then
   ``transform``, ``save``, ``load`` and ``transform`` again (within
   1e-6); fit B in bf16, batch 64, everything trained, on 1024 images.
   Per fit: host preprocessing seconds, steady images/s over steps 2..n
   with forward, backward and update seconds, peak memory, transform
   images/s, the step's FLOPs counted from the convolution and dense
   shapes beside their bound (float32 over 67 TFLOP/s, TF32 being off;
   bf16 over 989), and a profile of three more steps (device busy share,
   device time by op). Checks: finite losses; after fit A the stem and
   blocks 0-13 bitwise unchanged, blocks 14-15 and the head changed, the
   frozen blocks' BatchNorm statistics moved; after fit B every parameter
   changed; 5 steps on one batch lower its loss; card against CPU from
   the same ``state_dict`` (ResNet-50 ``smallImages=True`` at 32x32,
   batch 8: eval logits, two momentum steps' losses, running statistics
   and eval logits after them; the ImageNet stem at 224, batch 2, fit A's
   weights: eval logits), each within 1e-4 (``VISION_*_TOL``). No kernel
   of the port lies on this path (cuDNN and cuBLAS).
12. the rest of the GBDT estimator surface, on the HIGGS-shaped ``--rows``
   table with its last min(500,000, rows / 4) rows flagged in an ``isVal``
   column (HIGGS's published split keeps its last 500,000 of 11,000,000
   rows as the test set): ``LightGBMClassifier(numIterations=50,
   learningRate=0.1, numLeaves=31, maxBin=255, earlyStoppingRound=20,
   metric="auc", validationIndicatorCol="isVal")``, then the same fit
   depthwise through ``train_booster(valid=...)``; counts zeroed just
   before each fit and read just after (``child_histogram`` and
   ``range_histogram``, or ``level_histograms``, above 0); fit seconds,
   iterations run, best iteration and score, host syncs per tree logged;
   a stopped fit must keep best + 1 trees, one that ran to the end must
   name the first maximum of its AUC series, and ``best_score`` must be
   the AUC of ``predict(num_iteration=best + 1)`` within 1e-6. Then
   ``transform`` of the validation rows with ``leafPredictionCol`` (shape
   (Nv, T); the picked leaf values summed within 1e-5 of max |raw| of
   ``raw_score``), ``getFeatureShaps`` on 64 of them (additivity within
   1e-4 of max |raw|, rows/s logged), ``dumpModel`` (parses, T trees, leaf
   values within 1e-6 relative), a warm start from the model string with
   ``numBatches=2`` x 10 iterations (T + 20 trees, the first T equal in
   structure and thresholds, leaf values within 1e-6 relative), a custom
   logistic ``fobj`` on 100,000 rows (AUC within 1e-3 of
   ``objective="binary"``), a ``checkpoint_store`` fit stopped by a
   ``PreemptionError`` after iteration 6 and resumed (the restored trees
   bitwise the saved ones, AUC within 1e-3 of an uninterrupted fit), and a
   100,000-row validation fit on the card and on the CPU (per-iteration
   AUC within 1e-3).
13. sampling and monotone constraints on phase 12's table and split:
   first the draws of ``core/prng.py`` (threefry uniforms over the
   ``--rows`` rows, the bag under ``baggingFreq=5``, GOSS's rows, the
   feature permutation and mask at iterations 0, 1, 5 and 7, every node
   mask of one tree) made on the card and on the CPU, bitwise equal; then
   ``LightGBMClassifier(numIterations=10, learningRate=0.1,
   numLeaves=31, maxBin=255, metric="auc")`` leaf-wise with the
   validation column for each mode: bagging 0.8 every 5 iterations with
   feature fraction 0.9 (LightGBM's ``simple_example.py``), GOSS and DART
   at their defaults, RF (bagging 0.8 every iteration, feature fraction
   0.8), ``featureFractionByNode=0.5`` and ``monotoneConstraints`` +1 on
   X2, beside the same fit unsampled; and depthwise ``train_booster`` with
   GOSS and with DART. Counts zeroed just before each fit and read just
   after (each kernel of the policy above 0); fit seconds, seconds per
   iteration, host syncs per tree, validation AUC, launches per iteration
   against phase 3's, and the histogram kernels' time per iteration (CUDA
   events around each launch) against the unsampled fit's logged. Checks: ``child_histogram`` and ``range_histogram`` on the
   arguments of the GOSS fit's first root and split, ``level_histograms``
   on the GOSS depthwise fit's first level, against their plain versions
   at phase 2's tolerance; every split on X2 of the monotone fit orders
   its children's outputs upward (the raw score along a 64-point grid of
   X2 over 1,000 rows is logged: the constraint, as the JAX package
   enforces it, does not bound a split's descendants); DART's tree
   weights equal a host replay of its drops; the RF model string carries
   ``average_output`` and reloads within 1e-5. CUDA events time the
   sampling work of one iteration alone. Then every mode (and
   the depthwise GOSS and DART fits) at 25,000 rows for 10 iterations on
   the card and on the CPU (the CPU fits in spawned worker processes):
   per-iteration validation AUC within 1e-3.
14. categorical and sparse data on phase 10's Covertype-shaped table:
   its 4 wilderness and 40 soil one-hot columns folded into two ids (the
   12 columns of UCI's raw ``covtype.data``), then
   ``LightGBMClassifier(categoricalSlotIndexes=[10, 11])`` leaf-wise and
   depthwise ``train_booster(categorical_features=[10, 11])``, 7 classes,
   ``FAMILY_ITERS`` iterations, the categorical params at their defaults.
   Counts zeroed just before each fit and read just after (each kernel of
   the policy above 0); fit seconds, rows x iterations per second, host
   syncs per tree and the histogram kernels' time per iteration (CUDA
   events) beside phase 10's one-hot fits. Checks: one-vs-rest splits on
   wilderness and category sets of several soils in each policy; host
   syncs per tree those of a numeric tree (leaf-wise one per split and one
   for the root, depthwise at most one per level); reloads within 1e-5;
   the three kernels on the fits' first root, split and level against
   their plain versions at phase 2's tolerance or within ``PAD_SUM_ULPS``
   units of the float64 sums, counts exact; both fits at 50,000 rows on
   the card and on the CPU, mean |probability difference| within 1e-3,
   classes agreeing on 99.9% of rows. Then the 54-column one-hot table as
   scipy CSR (12 entries per row, LIBSVM's layout) through
   ``train_booster`` beside phase 10's dense fit of the same rows and
   config: ``Dataset(csr)``'s bins bitwise ``apply_bins`` of the dense
   rows on the card, the mappers equal, the same trees (model strings
   equal but for the lines of float sums, which the card's atomic adds
   order differently from fit to fit), the same predictions, and
   ``predict`` of the CSR rows bitwise that of the dense rows; both fits'
   ``referenceDataset`` and ``dataPreparation`` spans logged.
15. serving: phase 12's early-stopped leaf-wise classifier (28 float32
   features) through ``Booster.serving_fn(max_batch_size=64)``, its ladder
   1..64 captured as CUDA graphs by ``warmup()`` (seconds per rung
   logged); graphs against ``serving_fn(bucketed=False)`` (eager) at 1, 64
   and 4096 rows (4096 also through the ``predict(batch_size=4096)``
   runner, one replay), median host and CUDA-event milliseconds of 50
   calls, replies bitwise equal or within 1e-6; ``predict(batch_size=4096)``
   over phase 12's validation rows against the unbatched ``predict``
   (within 1e-6, rows/s of both). Then one ``ServingServer(max_batch_size=
   64, max_batch_latency=0.005)`` with a ``QoSController`` and two
   tenants: ``"higgs"`` over the graphs, ``"covtype"`` over
   ``serving_main.build_handler`` of phase 14's categorical model, saved
   and reloaded (``probability``). 32 client threads with keep-alive
   connections and 10 s timeouts send 4000 one-row requests to ``"higgs"``
   and 1000 to ``"covtype"``, interleaved; halfway, ``ModelRegistry.
   swap_to`` flips ``"higgs"`` to phase 3's 10-iteration model, captured
   off the hot path. Checks: every reply 200; each within 1e-6 of
   ``predict`` of its row by the version that was serving when it was
   sent (either version inside the swap), covtype classes equal; no
   capture after warmup on either version. Logged: p50 and p99 latency,
   requests/s, mean batch size, the runners' hits by rung and the swap's
   seconds. Then a burst of 200 requests against ``max_queue_size=8``
   (the handler stalled until the burst is in) must see 503s, each within
   1 s, and 200s within 1e-6 of ``predict``; ``X-Deadline-Ms: 1`` in front
   of a 50 ms handler must get a 504. No kernel of ours runs on this path
   (forest traversal is PyTorch operations, replayed from the graphs).
16. dl_state, the DL training state, on phase 11's fit A configuration
   (``Trainer`` over ResNet-50 at 224x224, batch 16, float32, adam 1e-3,
   the last two blocks and the head trained, ``cifar_like`` images resized
   on the host; cuDNN deterministic for the phase): one process first. A
   3-epoch fit on 64 images with ``checkpoint_dir``, stopped by a
   preemption hook at ``dl.epoch`` 2, then resumed: the restored
   parameters, batch statistics, moments and counts bitwise the saved
   ones (a restore-only fit), the resumed eval logits within
   ``VISION_LOGIT_TOL`` of an uninterrupted fit's, history epochs [2];
   ``state.msgpack`` bytes, save and restore seconds logged. A NaN batch
   at step 3 under ``nonfinite_policy="skip"`` (counters 1 and 1, every
   loss finite) and at step 6 under ``"rollback"`` (the restored state
   bitwise the epoch-1 checkpoint, history epochs [0, 1, 2]).
   ``DeepVisionClassifier`` save and ``PipelineStage.load`` through
   ``params.msgpack`` (probabilities within 1e-6), and the JAX package's
   committed TinyCNN model (``tests/resources/torch_port/tiny_cnn_jax``)
   loaded through the JAX package's class name: its recorded logits
   within 1e-5. Then two gloo ranks sharing the card on ``{"data": 2}``,
   global batch 16 (8 rows each), 4 steps on 64 images, replicated and
   ZeRO: losses within 1e-4 relative of one process's batch-16 fit from
   the same weights (BatchNorm over the global batch), each step's
   gather, forward, backward, all-reduce and update seconds, and the
   parameters and optimizer state at rest per rank by the shard specs and
   by ``torch.cuda.memory_allocated`` (ZeRO under 0.6 of replicated); the
   ZeRO checkpoint of the two ranks restored in one process is bitwise
   their gathered state (its msgpack bytes equal). No kernel of ours runs
   on this path.
17. distributed GBDT: ``train_booster(X, y, cfg, mesh=make_mesh({"data":
   2}))`` on two gloo ranks sharing the card (a ``FileStore`` in a
   temporary directory), both given phase 3's ``--rows`` table, each
   holding its 1M-row block; 10 iterations, 31 leaves, max_bin 255:
   ``tree_learner="data"`` on the f32, bf16 and int8 wires, "feature",
   "voting" (top_k 8), "auto" (the router's choice and predicted seconds
   per tree logged) and depthwise "data". Checks: model strings equal
   across ranks; every rank launches ``child_histogram`` and
   ``range_histogram`` (``level_histograms`` depthwise); on 200k held-out
   rows data/f32 probabilities within ``DIST_PROB_TOL`` of a one-process
   fit, int8 AUC within ``DIST_AUC_TOL`` of f32 and every wire's within
   it of the JAX package's on the same table (``DIST_REFERENCE_AUC``; its
   bf16 wire loses 0.003 against f32 at 2M rows), voting AUC at least
   data's less ``DIST_VOTING_AUC_GAP``; on the decisive fixture int8
   trees equal f32's and feature probabilities within
   ``DIST_IDENTITY_TOL`` of data's; ``allreduce_sum_quantized`` and
   ``reduce_scatter_sum_quantized`` on card tensors bitwise across ranks
   and within n scale / 2 of the float64 sums. Logged per rank and run:
   per iteration the histogram kernels' ms (CUDA events), the collectives'
   ms (wall, pinned staging included) and the rest, and per tree the
   collectives and the bytes on the wire and staged.
18. ONNX inference: ``ONNXModel.transform`` as a user calls it, on the
   bucketed runner's captured CUDA graphs, at ``bench.py:311-372``'s
   shapes: the generated ResNet-50 (1000 classes, 224x224, seeded weights)
   at ``miniBatchSize`` 64 in float32 and bf16, and the 12-layer, 768-wide,
   3072-FF encoder over 128 tokens at 32; each table 20 full batches and
   a tail of 5 (the rung of 8), the wall the median of 5 transforms.
   Logged: graph nodes and weights; generate,
   encode, parse and import s; capture s per rung; steady wall images/s
   or sequences/s, one batch's graph replay (CUDA events), its latency
   through the runner and its eager ms; peak GiB. Checks: rungs captured
   once each and none after; outputs finite; the card against the port's
   CPU run of the same graph on 2 rows (1e-3 of max |y| in float32, 0.01 in
   bf16, and bf16 nearer the CPU's bf16 run than the card's float32 output);
   every committed fixture against torch's output (2e-3 / 2e-4);
   phase 3's booster through ``Booster.to_onnx`` and ``ONNXModel``
   against ``predict`` on 100k rows (2e-4 / 2e-5). No kernel of ours runs
   here (the JAX package's ONNX ops are plain ``jnp``). ``--phase 18``
   builds the kernels and runs it alone (a small booster trained first).
19. out-of-core GBDT: a seeded generator of HIGGS-shaped chunks
   (``higgs_like`` per 1M-row chunk; 2,000,000 rows of HIGGS's
   11,000,000 since phase 24 was added (5,500,000 with phase 23), the raw
   floats never whole) into ``StreamedDataset``: the sketch over a
   150k-row prefix byte for byte ``compute_bin_mapper``'s, then the
   sketch pass and the bin-and-cache pass (seconds, host cache bytes, the
   chunk rows and their decision logged). ``train_booster_streamed``
   leaf-wise, then depthwise, then leaf-wise with ``resident=True`` (10
   iterations, 31 leaves, 255 bins); counts zeroed just before each fit and
   read just after (``child_histogram``, or ``level_histograms``
   depthwise, above 0); fit s, rows x iterations / s, passes per tree,
   each pumped pass's H2D copy ms (CUDA events on the side stream) against
   its wall, the exposed transfer (the compute stream waiting on copy
   events) and the host's wait on the producer thread as shares of the
   fit, histogram kernel ms per iteration and peak memory logged. Checks on a 500k-row held-out stream from a second
   seed: resident mode's AUC within 1e-3 of the streamed fit's and its
   peak memory above the streamed peak; the resident ``train_booster`` on
   the same rows and the sketch's boundaries within 1e-3 of the
   streamed AUC (the classic ``LightGBMClassifier`` on its own 200k-row bin
   sample is fitted and logged beside it, fit s and AUC: two bin samples
   alone move the AUC by more than 1e-3); the streamed fit at 100k rows, 3
   iterations on the card and on the CPU within 1e-3; ``predict_streamed``
   within 1e-5 of ``predict``.
   ``--phase 19`` builds the kernels and runs it alone.
20. GBDT across ranks and layouts. (a) On one process, phase 3's table
   (binned once, held-out rows phase 17's 200k): each stable-partition
   primitive (``sort``, ``sort32``, ``scan``, ``scatter``) exactly
   ``torch.argsort(stable=True)``'s source indices on 2M random keys in
   {-1, 0, 1, 2} (ms each logged); then ``train_booster`` leaf-wise (5
   iterations, 31 leaves, 255 bins) with ``row_layout`` partition, gather
   and masked, ``partition_impl`` sort32, scan and scatter, and partition
   with ``use_segmented=False``: fit s, histogram kernel ms per iteration
   (CUDA events), launches (counts zeroed just before each fit and read
   just after) and host syncs per tree logged; each run's held-out AUC
   within 1e-3 of the partition fit's, its split features and bins the
   partition fit's (a near tie broken by the card's float32 sums is
   logged, and that run held to the AUC bound alone). (b) The
   multi-process contract: two processes join through
   ``initialize_distributed`` (a ``TCPStore`` on localhost) and share the
   card, each passing only its own half of the table to
   ``train_booster(mesh=...)``, leaf-wise and depthwise, 5 iterations,
   the f32 wire: model strings equal across the ranks, each rank's mapper
   the gathered sample's, held-out probabilities within 5e-3 of the
   one-process fit on that mapper; each rank's ``referenceDataset`` span
   and per iteration its kernels, collectives, leaf gather and the rest
   logged. (c) Phase 19's stream over a mesh of two gloo ranks sharing the
   card (each rank sketches the whole stream, bins, caches and streams its
   half of every 1M-row chunk): ``train_booster_streamed(mesh=...)``
   leaf-wise and depthwise over phase 19's rows, leaf-wise with
   ``resident=True``, and the f32, bf16 and int8 wires on the stream's
   first 2,000,000 rows: model strings equal across the ranks; on phase
   19's 500k held-out stream the leaf-wise AUC within 1e-3 of phase 19's
   one-process streamed fit (its recorded reading when phase 20 runs
   alone) and of resident mode's, each lossy wire's within 1e-3 of f32's
   on the same rows. Per rank: sketch and bin-and-cache s, host cache
   bytes, fit s, rows x iterations / s, per pass the wall, the H2D copy,
   the host's wait on the producer, the collectives and the kernels, and
   peak memory. Every failure of (a)-(c) is collected and raised at the
   end; the three histogram kernels must each have launched on phase
   20's paths. ``--phase 20`` builds the kernels and runs it alone. Every
   phase's seconds are logged as it ends.

21. pipeline-parallel DL and elastic training (``--phase 21`` alone).
   (a) ``make_staged_backbone("resnet50", num_stages=2)`` at 224x224 on
   CIFAR-10-shaped images, float32, on ``{"stage": 2}`` (two ranks, one
   stage each): a fit with one microbatch under fill-drain, whose
   losses must be within 1e-4 of the same model's replicated ``Trainer``
   in one process from the same seeded weights (its BatchNorm statistics
   are the whole batch's, so the maths is the same); then batch 32 in 4
   microbatches under ``fill_drain``, ``overlap`` and ``overlap`` with
   ZeRO stages, 2 steps each, logging per rank and step the forward,
   backward, hop and update ms (CUDA events), hop bytes, the idle share
   between the rank's stage programs (against the analytic bubble
   (S-1)/(M+S-1)), images/s and peak memory. (b) the staged encoder at
   ``DeepTextClassifier``'s default widths (2 layers) and 8192 tokens,
   batch 2 in 2
   microbatches, on ``{"stage": 2, "seq": 2}`` (four ranks): ring and
   Ulysses, each under both schedules, every loss within 2e-4 of the same
   model fit with the same variant on ``{"seq": 2}`` without a pipeline
   from the same weights (the two such fits run at once on ranks 0-1 and
   2-3);
   ``flash_attention_block`` must launch in every ring fit's stages and
   ``flash_attention`` in every Ulysses fit's (the counts zeroed just
   before each fit and read just after), with the collectives' ms inside
   the stages. (c) elastic: (a)'s fill-drain fit under
   ``elastic_watchdog`` bitwise the plain one; a hang planted in a
   ``transfer.hop`` surfaces as ``PeerLostError`` naming the op within
   twice its 1 s budget; the text pipeline killed at epoch 2 resumes
   bitwise on the same mesh; a two-rank GBDT fit (phase 17's table, its
   first 125,000 rows, 6 iterations) killed at iteration 3 resumes in one
   process within 1e-4 of the uninterrupted fit's raw scores. Every
   failure is collected and raised at the end.
22. the serving fabric, VW and the online loop (``--phase 22`` alone,
   which first fits its own 100-iteration classifier on 500,000 rows).
   (a) Phase 12's classifier, its model string saved once, loaded by two
   processes joined by ``initialize_distributed`` and served by each
   through its own ``serving_fn`` graphs inside
   ``DistributedServingServer`` (the gateway in process 0): 3000 one-row
   requests from 32 clients (p50 / p99 ms and requests/s beside phase
   15's single server, forwards by worker and to a worker advertising the
   request's rung), then 3000 more round
   robin while process 1's worker is killed and restarted (seconds to
   eviction and to rejoin); every reply 200 and within 1e-6 of
   ``predict``. (b) Two federated gateways over those workers, one killed
   under load: seconds until its ring arcs and tenant leases move to the
   peer, no accepted request without a 200. (c) Three tenants on two
   workers behind one gateway (the classifier; phase 18's ResNet-50
   ``ONNXModel`` through its runner, requests naming preloaded images; an
   epsilon-greedy VW policy): each tenant's p99 before and while
   ``chaos_tenant_flood`` floods and NaN-storms the VW tenant, which must
   shed at its own 429 / 500 / 503 while the others answer 200. (d) VW on
   a seeded Criteo-shaped table (13 integer and 26 categorical columns,
   500,000 rows and 250,000 held out, each column's vocabulary hashed
   once): one logistic pass at batch 256 at 18 and 24 bits, weights within
   1e-4 of max |w| and progressive loss within 1e-5 of the same pass on
   the CPU (run in a spawned process meanwhile), rows/s, launches per
   batch, held-out AUC; ``VowpalWabbitClassifier`` fit / transform on the
   18-bit table; ``train_vw(mesh=)`` on the two processes of (a) (each its
   half of the 500,000 rows: both ranks' weights bitwise equal, the
   held-out AUC within 0.02 of one process on those rows). (e) The online
   loop at ``bench.py``'s shapes: updates/s while the fleet's policy serves
   over HTTP, ``PromotionGate`` with a ``PromotionBroadcast`` flipping
   both workers (ms), and a kill mid-update resumed bitwise under
   ``torch.use_deterministic_algorithms``. No kernel of ours runs here.
23. anomaly detection, recommendation and nearest neighbours
   (``--phase 23`` alone), on seeded tables shaped like public ones. (a)
   ``IsolationForest`` (100 trees of 256 samples, contamination 0.00172)
   on a table shaped like ULB's credit-card fraud set (284,807 rows x 30
   features, 492 planted frauds): fit s with the host's tree growth and
   the card's scoring apart, transform rows/s, the AUC against the planted
   frauds; the port on the CPU (a spawned process) grows the same forest
   arrays and scores within 1e-6 (labels equal but within 1e-6 of the
   threshold); ``iforest_stream_scorer`` in a ``StreamingAnomalyLoop``
   over 20,000 events at batch 64 (updates/s). (b) ``AccessAnomaly``
   (rank 10, 25 iterations) on 4 tenants of 5,000 users and 2,000
   resources in 10 departments, 250,000 accesses each with 1%
   cross-department accesses planted: fit s per tenant, transform rows/s,
   the planted share of each tenant's top 1%; explicit mode on tenant 0;
   tenant 0 against the CPU port in both modes (normalized scores within
   1e-3, the 1,000 highest scores' sets 99% equal);
   ``access_anomaly_stream_scorer`` in the loop (updates/s). (c) ``SAR``
   (jaccard, support 4, decay 30 days) on a MovieLens-10M-shaped log
   (69,878 users x 10,677 items, 10,000,054 ratings): fit s with the
   host's matrices and the card's similarity apart, the similarity on 64
   columns bitwise the float64 counts, ``recommend_for_all_users(10)``
   users/s, ``recommend_for_user_subset`` of 1,000 users against the CPU
   port (the same top 10 but at near ties of the 10th and 11th scores),
   ``transform`` of 250,000 pairs, host memory. (d) ``KNN`` (k 10) on a
   SIFT1M-shaped corpus (500,000 x 128 integer-valued keys, 10,000
   queries): index build s, queries/s brute force and pruned, recall
   against a float64 host brute force on 256 queries (1.0 but at near
   ties); ``ConditionalKNN`` with 1,000 labels and 5 a query on 256
   queries. Every failure is collected and raised at the end. None of the
   five kernels runs here (products, gathers and sorts of PyTorch).
24. explainers, causal inference, the image ops and leaf histograms
   (``--phase 24`` alone, which first fits phase 3's classifier). (a)
   ``TabularSHAP`` (2 * 28 + 2048 samples a row) and ``TabularLIME``
   (1,000) on phase 3's classifier over its first 512 rows: each solver
   runner's buckets captured ahead, then rows explained/s with scoring,
   solves and host sampling apart, no capture in the steady state, replay
   ms by bucket, ``solver_stats()``; phi and the LIME coefficients within
   1e-4 of the CPU port's on the same rows, SHAP's local accuracy within
   1e-4. (b) ``ImageLIME`` on the seeded ResNet-50 at 224x224: 2 images x
   256 masks, SLIC at cell size 16; images/s with SLIC, masking, scoring
   and solves apart; image 0's scores within 1e-4 and coefficients within
   1e-3 of the CPU port's. (c) ``DoubleMLEstimator`` with
   ``LightGBMRegressor`` nuisance models (20 iterations) on 250,000
   HIGGS-shaped rows with a planted effect of 2.0: the ATE within 0.05 of
   it, and on the first 25,000 rows within 5e-3 of the CPU port's. (d)
   ``SyntheticDiffInDiffEstimator`` on a Proposition-99-shaped panel (39 x
   31, 1 treated, 19 pre-periods) and a 2,000 x 200 panel: unit and time
   weights within 1e-4 of the CPU port's, each solve's ms on both. (e) every
   image op of ``ops/image.py`` on 256 x 224 x 224 x 3 within 1e-5 of the
   CPU port (card ms, images/s), ``leaf_histograms`` at 2,000,000 x 28 x
   255 bins x 31 leaves (counts exact, sums within 1e-5 of each bin's sum
   of magnitudes) and ``sharded_histogram_fn`` on two gloo ranks sharing
   the card, equal on both. A spawned CPU process runs (a)-(c) on the CPU
   port meanwhile. Every failure is collected and raised at the end. None
   of the five kernels runs here except in the nuisance models' and the
   classifier's fits (``child_histogram``, ``range_histogram``).
25. featurization, TrainClassifier and AutoML (``--phase 25`` alone, which
   first fits phase 3's classifier). (a) ``TrainClassifier(LightGBMClassifier(
   numIterations=100))`` on a UCI-Adult-shaped table (48,842 rows, six
   integer and eight string columns at Adult's cardinalities, ``"?"`` in
   three, a ``"<=50K"`` / ``">50K"`` label 24% positive): fit on the
   32,561-row train split, the 16,281-row test split scored, then
   ``ComputeModelStatistics``, ``ComputePerInstanceStatistics`` and a save
   and load (scores within 1e-5); the featurized matrix bitwise the CPU
   port's, probabilities and AUC within 1e-3 of it, ``scored_labels`` the
   original strings, the native library built and its murmur3 batch equal
   to the numpy path on every string. (b) ``TrainClassifier`` on phase 3's
   table as 28 float32 columns: ``Featurize``'s matrix bitwise phase 3's X,
   the held-out AUC (500,000 rows of another seed) within 1e-3 of phase 3's
   classifier. (c) ``TuneHyperparameters``: 8 random candidates
   (``numLeaves`` 15 / 31 / 63, ``learningRate`` log-uniform in 0.05-0.3,
   10 iterations), 3 folds, ``halvingEta`` 2, one thread on the card, a
   ``checkpointDir``: seconds by rung, fold fits/s, peak memory; no NaN;
   fold fits the ladder's 14 of exhaustive's 24; ``FindBestModel`` over
   the finalists; the same search killed at rung 1 by
   ``chaos_candidate``'s hook and resumed: every checkpointed score read
   back bitwise and the same best params; two candidates' rung-0 fold AUC
   within 1e-3 of the CPU port's. (d) ``GangCandidatePool``: two of the
   port's spool workers fit on the card, one rank killed mid-task: it
   respawns, its task is re-spooled and its AUC within 1e-3 of the same
   fit alone. A spawned CPU process runs (a) and (c)'s folds on the CPU
   port meanwhile. Every failure is collected and raised at the end.
   ``child_histogram`` and ``range_histogram`` launch in every fit.

The last lines are the card line, ``{"kernels": [...]}`` (each kernel's
launches counted on its own path; the flash kernels' in phase 21's
pipeline stages, ring fits for ``flash_attention_block`` and Ulysses fits
for ``flash_attention``, summed over the four ranks; phase 9's counts are
logged) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from urllib.parse import urlsplit

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FEATURES = 28
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM tensor cores, TF32, dense
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, bf16, dense
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-3
# fit-shaped histograms: a padded feature's one bin sums every row of the
# range in float32, held to the float64 sum within
# PAD_SUM_ULPS * 2^-24 * sum |x|. A summation tree of depth d is within
# d * 2^-24 * sum |x| in any order (Higham, Accuracy and Stability, eq.
# 4.4); the kernels' trees are about 500 adds deep at 2M rows (a warp's 5
# shuffles, a block's warp sums, one add per block), but their errors mostly
# cancel: the largest gaps read on an H100 80GB HBM3 at 700 W were 11 units
# for h (terms of one sign) and 0.03 for g (either sign; PERF.md §6).
# 100 leaves 9x room above h's reading and is a fifth of the worst case of a
# tree that deep, so g lost for one lane of every warp is far outside it.
PAD_SUM_ULPS = 100
CROSS_TOL = 1e-3
FLASH_RTOL, FLASH_ATOL = 2e-4, 2e-5      # float32: FMA order differs
# bf16 inputs: both sides round p to bf16 before the PV product, but against
# running maxima that differ between the kernel's key tiles and the plain
# blocks; flash_attention's output is bf16 (one ulp is up to 2^-7 of it)
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 8e-3, 1e-3
SEQ_RTOL, SEQ_ATOL = 2e-4, 2e-5          # seq path logits vs out of scope
VARIANT_TOL = 1e-5                       # ring vs Ulysses logits
# the seq path's model: DeepTextClassifier's default widths, maxTokenLen 8192
ENCODER = dict(vocab_size=32768, num_layers=4, num_heads=8, hidden=256,
               mlp_ratio=4, max_len=8192, num_classes=2, dropout=0.0,
               mask_free=True)
SEQ_BATCH, SEQ_RANKS = 4, 2
# phase 9: DeepTextClassifier at its default widths on the seq path's
# window and batch; TRAIN_ROWS rows = 2 steps of SEQ_BATCH per epoch
TRAIN_ROWS = 8
TRAIN_EST = dict(vocabSize=32768, numLayers=4, numHeads=8, hiddenSize=256,
                 maxTokenLen=8192, batchSize=SEQ_BATCH, maxEpochs=1,
                 learningRate=1e-4, optimizer="adamw", seed=0,
                 seqParallel=True, seqAxisSize=SEQ_RANKS)
# (run, estimator params): 2 steps each with ring and Ulysses (then
# transform), one bf16 step with the variant "auto" resolves to (ring)
TRAIN_RUNS = [("ring", dict(seqAttention="ring")),
              ("ulysses", dict(seqAttention="ulysses")),
              ("bf16", dict(seqAttention="auto", precision="bfloat16",
                            stepsPerEpoch=1))]
# flash launches per rank in one training forward
FORWARD_LAUNCHES = {"ring": {"flash_attention_block": 4 * 2,
                             "flash_attention": 0},
                    "ulysses": {"flash_attention": 4,
                                "flash_attention_block": 0}}
# head dims above 64: the DP = 128 instantiation (96, 128) and the wide
# kernel (192, 256); timed at the seq path's lengths ((B, S, H, D) of one
# Ulysses rank and of one ring step) with TIMED_HEAD_DIMS
WIDE_HEAD_DIMS = (96, 128, 192, 256)
TIMED_HEAD_DIMS = (128, 256)
# bin spaces above the B = 256 of the main path, all three kernels; 32768
# runs the leaf-wise kernels in two 16384-bin windows
LARGE_BINS = (4096, 8192, 32768)
LARGE_BIN_ROWS = 500_000
# a sequence that does not divide the seq axis: padded, its padded keys
# dropped before the kernels (B, S, H, D)
PADDED_SHAPE = (2, 4095, 8, 32)
# phase 10, the objective family. Shapes of public tables (no data is read):
# UCI Covertype (581,012 rows; 10 numeric, 4 wilderness and 40 soil one-hot
# columns; 7 cover types) and MSLR-WEB10K (10,000 queries, 136 features,
# relevance 0-4, about 120 documents per query, at most 908)
COVTYPE_ROWS, COVTYPE_NUMERIC, COVTYPE_CLASSES = 581_012, 10, 7
COVTYPE_WILD, COVTYPE_SOIL = 4, 40
MSLR_QUERIES, MSLR_FEATURES, MSLR_MAX_GROUP = 10_000, 136, 908
# 5 iterations a fit (10 before phase 25 was added)
FAMILY_ITERS = 5
# the cross-check at 50,000 rows (100,000 before phase 20 was added)
FAMILY_CROSS_ROWS, FAMILY_CROSS_ITERS = 50_000, 3
# card against CPU: atomics can flip near-tie splits, so the mean absolute
# prediction gap is held to 1e-3 of the CPU's mean absolute prediction, and
# class predictions to 99.9% agreement
FAMILY_REL_TOL, CLASS_AGREEMENT = 1e-3, 0.999
REGRESSION_OBJECTIVES = ("regression", "regression_l1", "huber", "fair",
                         "poisson", "quantile", "mape", "gamma", "tweedie",
                         "cross_entropy")
# phase 11: DeepVisionClassifier's default backbone at ImageNet width on
# CIFAR-10-shaped synthetic images (32x32x3 uint8, 10 classes) resized on
# the host to 224x224. Fit A: the estimator's defaults (batch 16, two
# trailing blocks and the head trained, adam 1e-3, float32); fit B: bf16,
# batch 64, everything trained. (label, estimator params, images)
VISION_BACKBONE, VISION_CLASSES, VISION_SIDE, VISION_SIZE = \
    "resnet50", 10, 32, 224
VISION_FITS = [("fit A", dict(batchSize=16, additionalLayersToTrain=2,
                              precision="float32"), 512),
               ("fit B", dict(batchSize=64, additionalLayersToTrain=-1,
                              precision="bfloat16"), 1024)]
VISION_OVERFIT_STEPS = 5
VISION_RELOAD_TOL = 1e-6     # the same weights through the same kernels
# card against CPU, float32 on both (TF32 off), from the estimator's
# initial state (each block's last BatchNorm scale 0): cuDNN's and
# oneDNN's sums run in other orders through 53 BatchNorms, each of which
# divides by its channel's spread; on the CPU this check's float32 run is
# within 3e-7 of float64 (losses equal, statistics 2.6e-7 of their
# largest magnitude). Logits within 1e-4 of max |logit|; two momentum
# steps' losses within 1e-4 relative (the second sees weights that differ
# by lr times the gradients' roundoff); every running statistic within
# 1e-4 of its tensor's largest magnitude. (BatchNorm scales drawn around
# 1 make the same steps chaotic: the float32 run's second loss is 8.5e-4
# from float64 at lr 1e-3, so no bound could tell the card from the CPU.)
VISION_LOGIT_TOL, VISION_LOSS_RTOL, VISION_STAT_TOL = 1e-4, 1e-4, 1e-4
# phase 12: validation with early stopping on the --rows table (its last
# min(SURFACE_VALID_ROWS, rows // 4) rows flagged, as HIGGS keeps its last
# 500,000 rows for testing), then leaf indices, SHAP, the JSON dump, a
# warm start, fobj, resume and a card-against-CPU curve on smaller tables.
# 50 iterations (300 before phase 13 was added: both fits stopped after
# 189-239 of them, so a fit now may run to the end unstopped; 150 before
# phase 21 was added, 100 before phase 25)
SURFACE_VALID_ROWS, SURFACE_ITERS, SURFACE_ESR = 500_000, 50, 20
SURFACE_SHAP_ROWS = 64
SURFACE_WARM_ITERS, SURFACE_WARM_BATCHES = 10, 2
SURFACE_SMALL_ROWS, SURFACE_SMALL_ITERS, SURFACE_RESUME_AT = 100_000, 10, 6
# best_score against the AUC recomputed from raw_score: the same float32
# AUC of scores summed in another order; the leaves' values summed against
# raw_score (float64 against float32 sums of up to 300 trees) and SHAP's
# additivity (float64 recursion against the float32 raw score), each
# relative to max |raw|; dumped and string-carried leaf values against the
# booster's (17 significant digits of a float32 and its float64 sum with
# the base score); card against CPU (atomics flip near-tie splits)
SURFACE_SCORE_TOL, SURFACE_LEAF_TOL, SURFACE_SHAP_TOL = 1e-6, 1e-5, 1e-4
SURFACE_DUMP_RTOL, SURFACE_CURVE_TOL = 1e-6, 1e-3
# phase 13: sampling and monotone constraints on phase 12's table and
# split. (label, LightGBMClassifier params, the same as BoosterConfig
# fields): bagging as LightGBM's examples/python-guide/simple_example.py
# sets it, GOSS and DART at their defaults, RF, per-node feature sampling,
# and X2 (which the label rises with by construction) constrained upward;
# 10 iterations a mode (50 before phase 20 was added, 20 before phase 21)
SAMPLING_ITERS = 10
SAMPLING_MODES = [
    ("bagging", dict(baggingFraction=0.8, baggingFreq=5,
                     featureFraction=0.9),
     dict(bagging_fraction=0.8, bagging_freq=5, feature_fraction=0.9)),
    ("goss", dict(boostingType="goss"), dict(boosting_type="goss")),
    ("dart", dict(boostingType="dart"), dict(boosting_type="dart")),
    ("rf", dict(boostingType="rf", baggingFraction=0.8, baggingFreq=1,
                featureFraction=0.8),
     dict(boosting_type="rf", bagging_fraction=0.8, bagging_freq=1,
          feature_fraction=0.8)),
    ("bynode", dict(featureFractionByNode=0.5),
     dict(feature_fraction_bynode=0.5)),
    ("monotone", dict(monotoneConstraints=[0, 0, 1]),
     dict(monotone_constraints=[0, 0, 1])),
]
# the depthwise fits (train_booster, growth_policy="depthwise")
SAMPLING_DEPTHWISE = ("goss", "dart")
# the unsampled fit every mode's launches and kernel time are held beside
PLAIN_MODE = ("plain", {}, {})
SAMPLING_BITWISE_ITS = (0, 1, 5, 7)      # iterations drawn on both devices
MONOTONE_FEATURE, MONOTONE_ROWS, MONOTONE_GRID = 2, 1000, 64
# a split on the constrained feature orders its children's outputs; the
# children's values are float32 sums of their rows in another order than
# the split search's prefix sums, so the order is held within 1e-5 of the
# tree's largest |value|
MONOTONE_TOL = 1e-5
# the cross-check at 25,000 rows (100,000 before phase 20 was added,
# 50,000 before phase 25)
SAMPLING_CROSS_ROWS, SAMPLING_CROSS_ITERS = 25_000, 10
SAMPLING_RELOAD_TOL = 1e-5
# phase 14: categorical and sparse data on phase 10's Covertype-shaped
# table. UCI's raw covtype.data stores wilderness and soil as one id each
# (12 columns: the last two categorical, 4 and 40 categories); LIBSVM's
# covtype is the 54-column one-hot table, 12 non-zeros per row, as CSR.
CAT_FEATURES = [COVTYPE_NUMERIC, COVTYPE_NUMERIC + 1]
CAT_CROSS_ROWS = 50_000     # halved for the time limit, as phase 10's
CAT_RELOAD_TOL = 1e-5

# phase 15: serving on the card. The bucketed runner at the JAX package's
# default ladder (max batch 64), graphs against eager at 1, 64 and 4096
# rows (median of SERVE_CALLS calls), batch predict in SERVE_PREDICT_BATCH
# chunks, then two tenants behind one ServingServer under SERVE_CLIENTS
# client threads with a hot swap halfway, a burst against a queue of
# SERVE_BURST_QUEUE, and a 1 ms deadline. Replies are held to predict on the
# same rows: traversal treats each row on its own, so padding and batching
# change no value (the tolerance covers another sum order)
SERVE_MAX_BATCH, SERVE_SIZES, SERVE_CALLS = 64, (1, 64, 4096), 50
SERVE_PREDICT_BATCH = 4096
SERVE_CLIENTS, SERVE_HIGGS_REQUESTS, SERVE_COVTYPE_REQUESTS = 32, 4000, 1000
SERVE_BATCH_LATENCY, SERVE_TOL = 0.005, 1e-6
SERVE_BURST, SERVE_BURST_QUEUE, SERVE_BURST_BATCH = 200, 8, 8
SERVE_STALL_S = 2.0
SERVE_CLIENT_TIMEOUT, SERVE_LOAD_TIMEOUT = 10.0, 300.0
# phase 16: the DL training state on phase 11's fit A configuration; 64
# images, 4 steps an epoch (128 and a rollback at step 10 before phase 21
# was added: the rollback step stays in epoch 1)
STATE_IMAGES, STATE_EPOCHS, STATE_BATCH = 64, 3, 16
STATE_SKIP_STEP, STATE_ROLLBACK_STEP = 3, 6
STATE_RANKS, STATE_RANK_IMAGES, STATE_RANK_STEPS = 2, 64, 4
STATE_SAVE_TOL = 1e-6          # save / load of the same weights
STATE_FIXTURE_TOL = 1e-5       # the JAX package's logits of its fixture
STATE_RANK_LOSS_TOL = 1e-4     # two ranks against one process, relative
STATE_FIXTURE = REPO / "tests" / "resources" / "torch_port" / "tiny_cnn_jax"
# phase 17: distributed GBDT, two gloo ranks sharing the card, each holding
# its block of the --rows HIGGS-shaped table (1M rows of the default 2M)
DIST_RANKS, DIST_ITERS, DIST_EVAL_ROWS = 2, 10, 200_000
DIST_RUNS = (
    ("data_f32", dict(tree_learner="data", hist_allreduce_dtype="f32")),
    ("data_bf16", dict(tree_learner="data", hist_allreduce_dtype="bf16")),
    ("data_int8", dict(tree_learner="data", hist_allreduce_dtype="int8")),
    ("feature", dict(tree_learner="feature")),
    # 28 features beat 2 top_k only below top_k = 14
    ("voting", dict(tree_learner="voting", top_k=8)),
    ("auto", dict(tree_learner="auto")),
    ("depthwise", dict(tree_learner="data", growth_policy="depthwise")))
DIST_PROB_TOL = 5e-3        # tests/test_distributed.py:126-129's bound
DIST_AUC_TOL = 1e-3         # int8 wire AUC against f32; each wire's
                            # against the JAX package's on the same table
# the JAX package's held-out AUC of each wire on this phase's table (the
# CPU, two virtual devices: tools/dist_gbdt_reference_auc.py), by --rows.
# Its bf16 wire gives up 0.003045 against f32 at 2M rows, so the bf16 rung
# is held to it rather than to f32 (the port's reproduces it)
DIST_REFERENCE_AUC = {2_000_000: {"f32": 0.950174, "bf16": 0.947129,
                                  "int8": 0.949794}}
DIST_VOTING_AUC_GAP = 0.02  # tests/test_voting.py:42-54
# the identity fixture: tests/test_distributed_gbdt_collectives.py's
# decisive table and config
DIST_DECISIVE_ROWS, DIST_DECISIVE_FEATURES = 4096, 16
DIST_DECISIVE_CFG = dict(objective="binary", num_iterations=3, num_leaves=8,
                         max_bin=256, seed=7)
DIST_IDENTITY_TOL = 1e-6
# the sizes phase 17's ranks take from this process (a rehearsal's smaller)
_DIST_SETTINGS = ("DIST_ITERS", "DIST_EVAL_ROWS", "DIST_DECISIVE_ROWS")
# phase 18: ONNX inference at bench.py:311-372's shapes: the modelgen
# ResNet-50 (ImageNet head, 224x224) and the 12-layer, 768-wide, 3072-FF
# encoder over 128 tokens (BERT-base's widths), seeded weights
ONNX_MODELS = (
    ("resnet50", "make_resnet", dict(depth=50, num_classes=1000,
                                     image_size=224), 64,
     ("float32", "bfloat16")),
    ("bert_base", "make_transformer_encoder",
     dict(num_layers=12, d_model=768, num_heads=12, seq_len=128, d_ff=3072,
          num_classes=2), 32, ("float32",)))
ONNX_FULL_BATCHES = 20      # each table: 20 full mini-batches ...
ONNX_TAIL = 5               # ... and a tail padded to the rung of 8
ONNX_TIMED = 5              # steady transforms timed after the first
ONNX_REPLAYS = 5            # one full batch's replay, CUDA events
ONNX_CROSS_ROWS = 2         # rows held to the port's CPU run
# card against the port's CPU run of the same graph, of max |y|: float32
# (no TF32; cuDNN's and oneDNN's algorithms sum in other orders), bf16
# (each op rounds to bf16 after sums in another order). On an H100 the
# bf16 ResNet-50 reads 0.00439 from the CPU's bf16 run and 0.019 from the
# card's own float32 output on the same 2 rows (PERF.md, PR 15): the bound
# sits between, so a card that kept float32 fails it
ONNX_F32_REL = 1e-3
ONNX_BF16_REL = 0.01
ONNX_FIXTURE_TOL = (2e-3, 2e-4)    # tests/test_onnx_thirdparty.py:65
ONNX_TREE_TOL = (2e-4, 2e-5)       # tests/test_onnx_treeensemble.py:48
ONNX_TREE_ROWS = 100_000
ONNX_TREE_BATCH = 4096
# phase 19: the streamed GBDT over HIGGS-shaped rows, 2,000,000 of HIGGS's
# 11,000,000-row published train split since phase 24 was added (the
# script's depth cuts: 5,500,000 when phase 23 was added; the last 500,000
# of its rows are its test set, drawn here from a second seed). Past the
# sketch's 200k-row reservoir the stream takes the exact second sketch
# pass, as the JAX package does
STREAM_ROWS = 2_000_000
STREAM_VALID_ROWS = 500_000
STREAM_SOURCE_ROWS = 1_000_000   # rows per generated source chunk
STREAM_SEED, STREAM_VALID_SEED, STREAM_CROSS_SEED = 19, 20, 21
STREAM_ITERS = 10
STREAM_PREFIX_ROWS = 150_000     # the sketch's exact regime, byte for byte
STREAM_CROSS_ROWS = 100_000
STREAM_CROSS_ITERS = 3
STREAM_AUC_TOL = 1e-3            # tests/test_oocore.py:233's bound
STREAM_PREDICT_TOL = 1e-5
# phase 20: GBDT across ranks and layouts. (a) every leaf-wise hot-loop
# design on phase 3's table; (b) the multi-process contract, two ranks each
# passing its half of it; (c) phase 19's stream over a mesh of two ranks
LAYOUT_ITERS = 5                 # 10 before phase 23 was added
LAYOUT_RUNS = (
    ("partition", {}),
    ("gather", dict(row_layout="gather")),
    ("masked", dict(row_layout="masked")),
    ("sort32", dict(partition_impl="sort32")),
    ("scan", dict(partition_impl="scan")),
    ("scatter", dict(partition_impl="scatter")),
    ("unsegmented", dict(use_segmented=False)))
LAYOUT_AUC_TOL = 1e-3
PARTITION_KEYS = 2_000_000
MP_RANKS, MP_ITERS = 2, 5          # 10 before phase 23 was added
MESH_RANKS = 2
MESH_LOSSY_ROWS = 2_000_000      # the lossy wires' prefix of the stream
# the prefix's chunk rows, fixed (the probe picks the same on the card) so
# that tools/stream_mesh_reference_auc.py sums in the same order
MESH_CHUNK_ROWS = 1 << 20
# phase 19's leaf-wise streamed AUC on its held-out stream as phase 19
# reads it at STREAM_ROWS on an H100 80GB HBM3 (700 W), with the exact
# second sketch pass; the reference when phase 20 runs alone
STREAM_REFERENCE_AUC = 0.945501
# the JAX package's held-out AUC of each wire, mesh-streamed on the
# prefix (the CPU, two virtual devices: tools/stream_mesh_reference_auc.py),
# by MESH_LOSSY_ROWS, logged beside the card's. The table's first split is
# a near tie (its margin X0 * X1 is symmetric in the two features), and
# which side of it ten trees land on moves the AUC by several 1e-3: the
# reference's bf16 and int8 wires read -0.005778 and +0.002434 from its
# f32. So a lossy wire is held to the f32 fit on the prefix only within
# MESH_WIRE_AUC_GAP, and to its f32 trees on phase 17's decisive fixture,
# streamed over the same ranks (bf16 exactly, int8 within a bin: see
# same_splits_within_a_bin)
MESH_REFERENCE_AUC = {2_000_000: {"f32": 0.945501, "bf16": 0.939723,
                                  "int8": 0.947935}}
MESH_WIRE_AUC_GAP = 0.01
# the sizes phase 20's ranks take from this process (a rehearsal's smaller)
_MESH_SETTINGS = ("STREAM_ROWS", "STREAM_VALID_ROWS", "STREAM_SOURCE_ROWS",
                  "STREAM_ITERS", "MESH_LOSSY_ROWS", "MESH_CHUNK_ROWS",
                  "MP_ITERS", "DIST_EVAL_ROWS", "DIST_DECISIVE_ROWS")
# phase 21: pipeline-parallel DL and elastic training. (a) the staged
# ResNet-50 at phase 11's 224x224 on {"stage": 2} (two ranks, one stage
# each): the parity fit (M = 1, fill-drain, its BatchNorm statistics the
# whole batch's) against the same model's replicated Trainer, then timed
# fits at M = 4 under each schedule
# PIPE_STEPS 3 before phase 23 was added
PIPE_RANKS, PIPE_BATCH, PIPE_MICRO, PIPE_STEPS = 2, 32, 4, 2
PIPE_PARITY_STEPS, PIPE_PARITY_TOL = 2, 1e-4
PIPE_RUNS = (("fill_drain", {}),
             ("overlap", dict(pipeline_schedule="overlap")),
             ("overlap+zero", dict(pipeline_schedule="overlap",
                                   pipeline_param_sharding="zero")))
# (b) the staged text encoder at DeepTextClassifier's default widths and
# phase 8/9's 8192 tokens on {"stage": 2, "seq": 2} (four ranks), ring and
# Ulysses under both schedules, held to the same model fit on {"seq": 2};
# a batch of 2 sequences in 2 microbatches and 2 layers, one a stage (4
# sequences and 4 layers before phase 25 was added)
PIPE_TEXT = dict(vocab_size=32768, num_classes=2, num_stages=2, num_layers=2,
                 hidden=256, heads=8, max_len=8192)
PIPE_TEXT_RANKS, PIPE_TEXT_BATCH, PIPE_TEXT_MICRO = 4, 2, 2
PIPE_TEXT_STEPS, PIPE_TEXT_TOL = 2, 2e-4
# (c) elastic: the hang's watchdog budget, and the GBDT killed on two ranks
# at an iteration and resumed in one process (phase 17's table, cut)
PIPE_HANG_BUDGET_S = 1.0
# (500,000 rows before phase 23 was added, 250,000 before phase 24)
PIPE_GBDT_ROWS, PIPE_GBDT_ITERS, PIPE_GBDT_KILL = 125_000, 6, 3
PIPE_GBDT_TOL = 1e-4
_PIPE_SETTINGS = ("VISION_SIZE", "VISION_CLASSES", "VISION_SIDE",
                  "PIPE_BATCH", "PIPE_MICRO", "PIPE_STEPS",
                  "PIPE_PARITY_STEPS", "PIPE_TEXT", "PIPE_TEXT_BATCH",
                  "PIPE_TEXT_MICRO", "PIPE_TEXT_STEPS", "PIPE_HANG_BUDGET_S",
                  "PIPE_GBDT_ROWS", "PIPE_GBDT_ITERS", "PIPE_GBDT_KILL",
                  "PIPE_BACKBONE", "PIPE_WIDTH")
PIPE_BACKBONE, PIPE_WIDTH = "resnet50", 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def higgs_margin(rows: int, seed: int = 0):
    """HIGGS-shaped synthetic features (28 standard-normal float32 columns)
    and the continuous margin X0*X1 + 0.5*X2 + 0.2*noise (float32)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] + 0.2 * rng.normal(size=rows)
    return X, margin.astype(np.float32)


def higgs_like(rows: int, seed: int = 0):
    """HIGGS-shaped synthetic table: ``higgs_margin``'s features and the
    label margin > 0."""
    X, margin = higgs_margin(rows, seed)
    return X, (margin > 0).astype(np.float32)


def table_of(X, y):
    """A ``Table`` of ``X``'s columns ``f0..``, ``label`` and their
    ``assemble_features`` column ``features`` (``X`` itself in float32,
    which is what the assembler would concatenate)."""
    from synapseml_tpu_torch.core import Table

    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    return Table({**cols, "label": y}).with_column(
        "features", np.ascontiguousarray(X, np.float32))


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(FP: int, rows: int, B: int, slots: int = 1) -> tuple:
    """(least milliseconds on an H100, what bounds it) for the histograms of
    ``rows`` rows: read bT (int32) and g/h/m once, write ``slots`` (FP, B, 3)
    float32 histograms once; 3 float32 adds per (feature, row)."""
    bytes_ = FP * rows * 4 + 12 * rows + slots * FP * B * 3 * 4
    ops = 3 * FP * rows
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(rows: int, dev: str) -> dict:
    from synapseml_tpu_torch.ops import hist_kernel as hk

    FP, B = hk.features_padded(FEATURES), hk.pad_bins(255)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bT = torch.randint(0, B, (FP, rows), generator=gen, device=dev,
                       dtype=torch.int32)
    m = (torch.rand(rows, generator=gen, device=dev) > 0.2).float()
    g = torch.randn(rows, generator=gen, device=dev) * m
    h = torch.rand(rows, generator=gen, device=dev) * m

    compare = compare_histograms
    results = {}
    err = compare("child_histogram n=%d" % rows,
                  hk.child_histogram(bT, g, h, m, B),
                  hk._hist_plain(bT, g, h, m, B))
    ranges = [(0, rows), (rows // 3, 1500), (rows - rows // 3, rows // 3),
              (5, 1)]
    rerr = 0.0
    for s, ln in ranges:
        st = torch.tensor(s, dtype=torch.int32, device=dev)
        le = torch.tensor(ln, dtype=torch.int32, device=dev)
        rerr = max(rerr, compare(
            f"range_histogram [{s}, {s + ln})",
            hk.range_histogram(bT, g, h, m, st, le, B),
            hk._range_hist_plain(bT, g, h, m, s, ln, B)))

    def library(start, length):
        """One index_put_(accumulate=True) over flattened (feature, bin)
        indices of the same rows: the yardstick call, inputs prepared
        outside the timed call."""
        b = bT[:, start:start + length].to(torch.int64)
        flat = (b + torch.arange(FP, device=dev)[:, None] * B).reshape(-1)
        return _index_put(flat, g[start:start + length],
                          h[start:start + length], m[start:start + length],
                          FP, FP * B)

    iters = 20
    t_child = time_ms(lambda: hk.child_histogram(bT, g, h, m, B), iters)
    t_child_plain = time_ms(lambda: hk._hist_plain(bT, g, h, m, B), 5)
    t_child_lib = time_ms(library(0, rows), 5)
    bnd, by = bound_ms(FP, rows, B)
    results["child_histogram"] = dict(
        replaces="synapseml_tpu/ops/hist_kernel.py:94", max_abs_err=err,
        ms=t_child, plain_ms=t_child_plain, bound_ms=bnd, bound_by=by,
        library_ms=t_child_lib, shape=f"FP={FP} n={rows} B={B}")
    # the range kernel timed on half the rows: the largest smaller child
    s, ln = rows // 4, rows // 2
    st = torch.tensor(s, dtype=torch.int32, device=dev)
    le = torch.tensor(ln, dtype=torch.int32, device=dev)
    t_range = time_ms(lambda: hk.range_histogram(bT, g, h, m, st, le, B),
                      iters)
    t_range_plain = time_ms(
        lambda: hk._range_hist_plain(bT, g, h, m, s, ln, B), 5)
    t_range_lib = time_ms(library(s, ln), 5)
    bnd, by = bound_ms(FP, ln, B)
    results["range_histogram"] = dict(
        replaces="synapseml_tpu/ops/hist_kernel.py:219", max_abs_err=rerr,
        ms=t_range, plain_ms=t_range_plain, bound_ms=bnd, bound_by=by,
        library_ms=t_range_lib, shape=f"FP={FP} n={rows} B={B} length={ln}")
    fit_shaped_phase(bT, g, h, m, B, compare, results, iters)
    del bT, g, h, m
    torch.cuda.empty_cache()
    results["level_histograms"] = level_kernel_phase(rows, dev, compare)
    large_bins_phase(dev, compare)
    for name, r in results.items():
        log(f"  {name} [{r['shape']}]: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"-> {r['bound_ms'] / r['ms']:.1%} of bound")
    return results


def compare_histograms(label, got, want) -> float:
    """Hold a kernel's histograms to its plain version's: rtol 1e-5 / atol
    1e-3 on the gradient and hessian sums, exact counts. Returns the largest
    absolute gap."""
    _sync(str(got.device))
    err = (got - want).abs().reshape(-1, 3).amax(dim=0).tolist()
    ok = (torch.allclose(got[..., :2], want[..., :2], rtol=KERNEL_RTOL,
                         atol=KERNEL_ATOL)
          and torch.equal(got[..., 2], want[..., 2]))
    log(f"  {label}: max |kernel - plain| g={err[0]:.3g} h={err[1]:.3g} "
        f"count={err[2]:.3g} -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return max(err)


def fit_shaped_check(label, got, want, vals, compare) -> float:
    """Histograms of fit-shaped bins (features FEATURES..FP-1 with every
    row in bin 0) over rows whose bf16-rounded values are ``vals`` (rows,
    3) float64: the real features held to the plain version by
    ``compare``, the padded features to the float64 sum by
    ``padded_check``. Returns the real features' largest gap."""
    err = compare(f"{label} real features", got[:FEATURES], want[:FEATURES])
    ok, gap, unit, bound = padded_check(got[FEATURES:].double(), vals)
    log(f"  {label} padded features (one bin, {len(vals)} rows): |kernel - "
        f"float64| g={gap[0]:.3g} ({gap[0] / unit[0]:.3g} units) "
        f"h={gap[1]:.3g} ({gap[1] / unit[1]:.3g} units) "
        f"count={gap[2]:.3g}, limit g={bound[0]:.3g} h={bound[1]:.3g} "
        f"({PAD_SUM_ULPS} units) -> "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: padded features outside "
                             "PAD_SUM_ULPS of the float64 sum")
    return err


def fit_shaped_phase(bT, g, h, m, B: int, compare, results: dict,
                     iters: int) -> None:
    """``child_histogram`` and ``range_histogram`` (length n/2) checked and
    timed on the bins as the fit has them: ``transpose_bins`` leaves the
    padded features FEATURES..FP-1 with every row in bin 0 (``bT`` is
    overwritten in place). The real features are held to the plain version
    at the phase's tolerance. A padded feature puts every row of the range
    into one float32 sum, whose summation order alone exceeds rtol 1e-5;
    it is held to the float64 sum of the same bf16-rounded values within
    ``PAD_SUM_ULPS * 2^-24 * sum |x|`` (see there), with exact counts
    (integers below 2^24 add exactly) and every other bin exactly 0. Adds
    ``fit_ms``/``fit_err`` to the two kernels' ``results``."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    FP, rows = bT.shape
    bT[FEATURES:] = 0
    vals = hk._rounded_values(g, h, m).double()

    def check(label, got, want, s, ln):
        return fit_shaped_check(label, got, want, vals[s:s + ln], compare)

    fit_err = {"child_histogram": check(
        f"child_histogram fit-shaped n={rows}",
        hk.child_histogram(bT, g, h, m, B), hk._hist_plain(bT, g, h, m, B),
        0, rows)}
    s, ln = rows // 4, rows // 2
    st = torch.tensor(s, dtype=torch.int32, device=bT.device)
    le = torch.tensor(ln, dtype=torch.int32, device=bT.device)
    fit_err["range_histogram"] = check(
        f"range_histogram fit-shaped [{s}, {s + ln})",
        hk.range_histogram(bT, g, h, m, st, le, B),
        hk._range_hist_plain(bT, g, h, m, s, ln, B), s, ln)
    fit_ms = {
        "child_histogram": time_ms(
            lambda: hk.child_histogram(bT, g, h, m, B), iters),
        "range_histogram": time_ms(
            lambda: hk.range_histogram(bT, g, h, m, st, le, B), iters)}
    for name in fit_ms:
        r = results[name]
        r["fit_ms"], r["fit_err"] = fit_ms[name], fit_err[name]
        log(f"  {name} fit-shaped (features {FEATURES}-{FP - 1} in bin 0) "
            f"[{r['shape']}]: kernel_ms={fit_ms[name]:.4f} (random bins "
            f"{r['ms']:.4f}) bound_ms={r['bound_ms']:.4f}")


def padded_check(pad, v) -> tuple:
    """(ok, gap, unit, bound) of the padded features' histograms ``pad``
    (P, B, 3) float64 over rows whose bf16-rounded values are ``v`` (rows, 3)
    float64: bin 0 within ``PAD_SUM_ULPS`` units (one unit = 2^-24 * sum |x|)
    of the float64 sum, exact counts, every other bin exactly 0."""
    unit = 2.0 ** -24 * v.abs().sum(0)  # one roundoff of sum |x|
    exact, bound = v.sum(0), PAD_SUM_ULPS * unit
    gap = (pad[:, 0] - exact).abs().amax(0)
    ok = (bool((gap[:2] <= bound[:2]).all())
          and bool((pad[:, 0, 2] == exact[2]).all())
          and not pad[:, 1:].any())
    return ok, gap, unit, bound


def _index_put(flat, g, h, m, FP: int, size: int):
    """The yardstick call: one index_put_(accumulate=True) of the
    bf16-rounded [g, h, m] of each (feature, row) at ``flat``, into a
    (size, 3) zeroed output; inputs prepared outside the timed call."""
    vals = torch.stack([g, h, m], -1).to(torch.bfloat16).float()
    vals = vals.expand(FP, g.shape[0], 3).reshape(-1, 3)
    out = torch.zeros((size, 3), device=g.device)
    return lambda: out.index_put_((flat,), vals, accumulate=True)


def level_inputs(rows: int, dev: str, L: int = 31, B: int = 256):
    """Inputs of ``level_histograms`` at the depthwise path's shapes:
    ``rows`` rows in L chunk-aligned slots of uneven size (three of them own
    one empty chunk), padded to CAP = ceil(rows / CHUNK) * CHUNK + L * CHUNK
    rows. Padding rows sit in bin 0 with g = h = m = 0, as the grower leaves
    them; real rows have random bins in all FP = 32 features, as phase 2's
    other inputs (a padded feature puts a whole slot in one float32 sum,
    whose summation-order error alone reaches rtol 1e-5). Returns
    (bT, g, h, m, start_chunks, slot_of_row)."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    FP, C = hk.features_padded(FEATURES), hk.CHUNK
    CAP = -(-rows // C) * C + L * C
    rng = np.random.default_rng(0)
    w = rng.gamma(0.7, size=L)
    w[[i for i in (3, 11, 29) if i < L]] = 0.0    # slots with one empty chunk
    counts = np.floor(w / w.sum() * rows).astype(np.int64)
    counts[0] += rows - counts.sum()
    cap = np.maximum(-(-counts // C), 1)
    base = np.cumsum(cap) - cap
    slot_of_chunk = np.repeat(np.arange(L), cap)
    slot_of_chunk = np.concatenate(
        [slot_of_chunk, np.full(CAP // C - len(slot_of_chunk), L - 1)])
    slot = torch.as_tensor(np.repeat(slot_of_chunk, C), device=dev)
    q = torch.arange(CAP, device=dev)
    base_d = torch.as_tensor(base, device=dev)
    valid = (q - base_d[slot] * C) < torch.as_tensor(counts, device=dev)[slot]
    starts = torch.as_tensor(base, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bT = torch.randint(0, B, (FP, CAP), generator=gen, device=dev,
                       dtype=torch.int32) * valid
    m = (torch.rand(CAP, generator=gen, device=dev) > 0.2).float() * valid
    g = torch.randn(CAP, generator=gen, device=dev) * m
    h = torch.rand(CAP, generator=gen, device=dev) * m
    return bT, g, h, m, starts, slot


def level_fit_shaped_check(label, got, want, vals, slot, L: int,
                           compare) -> float:
    """The level histograms of fit-shaped bins (features FEATURES..FP-1 with
    every row in bin 0): the real features held to the plain version at the
    phase's tolerance, each slot's padded features to the float64 sum of its
    rows within ``PAD_SUM_ULPS`` (``padded_check``). Returns the real
    features' max error."""
    err = compare(f"{label} real features", got[:, :FEATURES],
                  want[:, :FEATURES])
    ok, worst = True, [0.0, 0.0]
    for s in range(L):
        ok_s, gap, unit, _ = padded_check(got[s, FEATURES:].double(),
                                          vals[slot == s])
        ok &= ok_s
        for q in range(2):
            if unit[q] > 0:
                worst[q] = max(worst[q], float(gap[q] / unit[q]))
    log(f"  {label} padded features (one bin per slot): largest |kernel - "
        f"float64| g={worst[0]:.3g} h={worst[1]:.3g} units of 2^-24 sum|x|, "
        f"limit {PAD_SUM_ULPS} -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: padded features outside "
                             "PAD_SUM_ULPS of the float64 sum")
    return err


def level_kernel_phase(rows: int, dev: str, compare) -> dict:
    """``level_histograms`` at the depthwise path's shapes: random bins
    (rtol/atol and exact counts), the same rows fit-shaped
    (``level_fit_shaped_check``) and a small B = 512 case; timed beside its
    plain version, one ``index_put_`` call, its bytes bound and the tensor
    floor of its design (one-hot products, CAP * FP * B * 6 flops of
    bf16)."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    FP, B, L = hk.features_padded(FEATURES), hk.pad_bins(255), 31
    bT, g, h, m, starts, slot = level_inputs(rows, dev, L)
    CAP = bT.shape[1]

    def call():
        return hk.level_histograms(bT, g, h, m, starts, slot, B, L)

    err = compare(f"level_histograms CAP={CAP} slots={L}", call(),
                  hk._level_hist_plain(bT, g, h, m, slot, B, L))
    t_kernel = time_ms(call, 20)
    t_plain = time_ms(lambda: hk._level_hist_plain(bT, g, h, m, slot, B, L),
                      5)
    flat = ((slot.to(torch.int64)[None, :] * FP
             + torch.arange(FP, device=dev)[:, None]) * B + bT).reshape(-1)
    t_lib = time_ms(_index_put(flat, g, h, m, FP, L * FP * B), 5)
    del flat
    bnd, by = bound_ms(FP, CAP, B, L)
    tensor_ms = CAP * FP * B * 6 / BF16_OPS_PER_S * 1e3

    bT[FEATURES:] = 0                      # fit-shaped: padded features
    vals = hk._rounded_values(g, h, m).double()
    fit_err = level_fit_shaped_check(
        f"level_histograms fit-shaped CAP={CAP}", call(),
        hk._level_hist_plain(bT, g, h, m, slot, B, L), vals, slot, L, compare)
    t_fit = time_ms(call, 20)
    del bT, g, h, m, vals
    torch.cuda.empty_cache()

    b512 = level_inputs(rows // 10, dev, 7, B=512)
    compare(f"level_histograms B=512 CAP={b512[0].shape[1]} slots=7",
            hk.level_histograms(*b512, 512, 7),
            hk._level_hist_plain(*b512[:4], b512[5], 512, 7))
    del b512
    torch.cuda.empty_cache()

    log(f"  level_histograms fit-shaped kernel_ms={t_fit:.4f}; floors: bytes "
        f"{bnd:.4f} ms, tensor work {tensor_ms:.4f} ms "
        f"({CAP * FP * B * 6:.3g} bf16 flops at "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    return dict(replaces="synapseml_tpu/ops/hist_kernel.py:294",
                max_abs_err=max(err, fit_err), ms=t_kernel, plain_ms=t_plain,
                bound_ms=bnd, bound_by=by, library_ms=t_lib, fit_ms=t_fit,
                tensor_ms=tensor_ms,
                shape=f"FP={FP} CAP={CAP} B={B} slots={L}")


def large_bins_phase(dev: str, compare) -> None:
    """All three histogram kernels at each of ``LARGE_BINS`` against their
    plain versions (phase 2's tolerance, exact counts), ``LARGE_BIN_ROWS``
    rows of FP = 32 random bins (some outside [0, B)), the level kernel over
    3 slots of whole chunks; each kernel timed once per B beside its plain
    version, one ``index_put_`` call (out-of-range bins sent to a spare row)
    and its bytes bound."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    FP, n = hk.features_padded(FEATURES), LARGE_BIN_ROWS
    C = hk.CHUNK
    n = -(-n // C) * C
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    starts = torch.tensor([0, n // C // 3, 2 * (n // C) // 3],
                          dtype=torch.int32, device=dev)
    slot = torch.bucketize(torch.arange(n, device=dev) // C,
                           starts[1:].long(), right=True)
    st = torch.tensor(n // 5, dtype=torch.int32, device=dev)
    le = torch.tensor(n // 2, dtype=torch.int32, device=dev)
    rows = slice(n // 5, n // 5 + n // 2)
    f = torch.arange(FP, device=dev)[:, None]
    for B in LARGE_BINS:
        bT = torch.randint(-2, B + 2, (FP, n), generator=gen, device=dev,
                           dtype=torch.int32)
        m = (torch.rand(n, generator=gen, device=dev) > 0.2).float()
        g = torch.randn(n, generator=gen, device=dev) * m
        h = torch.rand(n, generator=gen, device=dev) * m
        b = bT.to(torch.int64)
        ok = (b >= 0) & (b < B)
        flat = torch.where(ok, f * B + b, FP * B)
        level_flat = torch.where(ok, (slot[None, :] * FP + f) * B + b,
                                 3 * FP * B)
        calls = {
            "child_histogram": (
                lambda: hk.child_histogram(bT, g, h, m, B),
                lambda: hk._hist_plain(bT, g, h, m, B),
                _index_put(flat.reshape(-1), g, h, m, FP, FP * B + 1),
                bound_ms(FP, n, B)),
            "range_histogram": (
                lambda: hk.range_histogram(bT, g, h, m, st, le, B),
                lambda: hk._range_hist_plain(bT, g, h, m, n // 5, n // 2,
                                             B),
                _index_put(flat[:, rows].reshape(-1), g[rows], h[rows],
                           m[rows], FP, FP * B + 1),
                bound_ms(FP, n // 2, B)),
            "level_histograms": (
                lambda: hk.level_histograms(bT, g, h, m, starts, slot, B, 3),
                lambda: hk._level_hist_plain(bT, g, h, m, slot, B, 3),
                _index_put(level_flat.reshape(-1), g, h, m, FP,
                           3 * FP * B + 1),
                bound_ms(FP, n, B, 3))}
        del b, ok
        for name, (kernel, plain, library, (bnd, by)) in calls.items():
            compare(f"{name} B={B} n={n}", kernel(), plain())
            t = time_ms(kernel, 5)
            t_plain = time_ms(plain, 3)
            t_lib = time_ms(library, 3)
            log(f"  {name} B={B}: kernel_ms={t:.4f} plain_ms={t_plain:.4f} "
                f"library_ms={t_lib:.4f} bound_ms={bnd:.4f} ({by}) -> "
                f"{bnd / t:.1%} of bound, {t_plain / t:.2f}x faster than "
                f"plain, {t_lib / t:.2f}x than the library call")
        del bT, g, h, m, flat, level_flat, calls
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

MAIN_KERNELS = ("child_histogram", "range_histogram")
DEPTHWISE_KERNELS = ("level_histograms",)


def _check_launches(launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the path never launched {missing}")


def main_path(X, y, dev: str) -> dict:
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.objectives import auc
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk

    rows = X.shape[0]
    t0 = time.perf_counter()
    t = table_of(X, y)
    log(f"  Table assembled in {time.perf_counter() - t0:.3f}s")
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(t)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(t)
    transform_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.txt"
        model.saveNativeModel(str(path))
        text = path.read_text()
    launches = dict(hk.LAUNCHES)

    booster = model.booster
    prob = out["probability"]
    if prob.shape != (rows, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"probability column bad: shape {prob.shape}, "
                             f"finite {np.isfinite(prob).all()}")
    a = float(auc(torch.as_tensor(y, device=dev),
                  torch.as_tensor(prob[:, 1], device=dev)))
    reloaded = Booster.from_model_string(text, device=dev)
    sub = X[:10_000]
    reload_diff = float(np.abs(reloaded.predict(sub) - prob[:10_000, 1]).max())
    ntrees = booster.num_trees
    syncs = booster.metadata["host_syncs"]
    spans = {k: round(v, 4) for k, v in booster.metadata["measures"].items()}
    log(f"  fit_s={fit_s:.3f} rows/s={rows / fit_s:.0f} "
        f"row_iterations/s={rows * ntrees / fit_s:.0f} "
        f"transform_s={transform_s:.3f}")
    log(f"  fit spans: {json.dumps(spans)}")
    log(f"  train AUC={a:.6f} trees={ntrees} splits/tree="
        f"{np.mean([int(tr.num_splits) for tr in booster.trees]):.1f} "
        f"host_syncs={syncs} host_syncs/tree={syncs / ntrees:.1f}")
    log(f"  peak device memory={torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; model string {len(text)} bytes, reload max |diff|="
        f"{reload_diff:.3g}")
    log(f"  launches on the main path: {json.dumps(launches)}")
    if ntrees != 10 or not text.startswith("tree") or reload_diff > 1e-5:
        raise AssertionError("fitted model or its native string is wrong")
    if a < 0.75:
        raise AssertionError(f"train AUC {a} is too low for this table")
    _check_launches(launches, MAIN_KERNELS)
    return dict(launches=launches, fit_s=fit_s, auc=a, booster=booster,
                model=model)


def depthwise_path(X, y, dev: str) -> dict:
    """``train_booster`` with the depthwise growth policy, ``predict`` and a
    model-string reload, on the main path's table."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.grower import forest_max_depth
    from synapseml_tpu_torch.gbdt.objectives import auc
    from synapseml_tpu_torch.ops import hist_kernel as hk

    rows = X.shape[0]
    cfg = BoosterConfig(objective="binary", growth_policy="depthwise",
                        num_iterations=10, num_leaves=31, max_bin=255)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = train_booster(X, y, cfg, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = booster.predict(X)
    predict_s = time.perf_counter() - t0
    text = booster.model_string()
    launches = dict(hk.LAUNCHES)

    if prob.shape != (rows,) or not np.isfinite(prob).all():
        raise AssertionError(f"predictions bad: shape {prob.shape}, finite "
                             f"{np.isfinite(prob).all()}")
    a = float(auc(torch.as_tensor(y, device=dev),
                  torch.as_tensor(prob, device=dev)))
    reloaded = Booster.from_model_string(text, device=dev)
    reload_diff = float(np.abs(reloaded.predict(X[:10_000])
                               - prob[:10_000]).max())
    ntrees = booster.num_trees
    syncs = booster.metadata["host_syncs"]
    passes = sum(1 + forest_max_depth([t]) for t in booster.trees)
    spans = {k: round(v, 4) for k, v in booster.metadata["measures"].items()}
    log(f"  fit_s={fit_s:.3f} rows/s={rows / fit_s:.0f} "
        f"row_iterations/s={rows * ntrees / fit_s:.0f} "
        f"predict_s={predict_s:.3f}")
    log(f"  fit spans: {json.dumps(spans)}")
    log(f"  train AUC={a:.6f} trees={ntrees} splits/tree="
        f"{np.mean([int(tr.num_splits) for tr in booster.trees]):.1f} "
        f"level passes/tree={passes / ntrees:.1f} host_syncs={syncs} "
        f"host_syncs/tree={syncs / ntrees:.1f}")
    log(f"  peak device memory={torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; model string {len(text)} bytes, reload max |diff|="
        f"{reload_diff:.3g}")
    log(f"  launches on the depthwise path: {json.dumps(launches)}")
    if ntrees != 10 or not text.startswith("tree") or reload_diff > 1e-5:
        raise AssertionError("fitted model or its native string is wrong")
    if a < 0.75:
        raise AssertionError(f"train AUC {a} is too low for this table")
    if launches["level_histograms"] != passes:
        raise AssertionError(f"{launches['level_histograms']} level "
                             f"launches for {passes} level passes")
    _check_launches(launches, DEPTHWISE_KERNELS)
    return dict(launches=launches, fit_s=fit_s, auc=a)


# ---------------------------------------------------------------------------
# phase 4: card against CPU; phase 5: where the time goes
# ---------------------------------------------------------------------------

def cross_check(dev: str, policy: str) -> None:
    """``policy`` "leafwise" runs the estimator (the main path), "depthwise"
    ``train_booster`` with that growth policy."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt.objectives import auc
    from synapseml_tpu_torch.models import LightGBMClassifier

    X, y = higgs_like(100_000, seed=1)
    t = table_of(X, y)
    probs, aucs, trees = {}, {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        if policy == "leafwise":
            model = LightGBMClassifier(numIterations=3, numLeaves=31,
                                       maxBin=255, device=d).fit(t)
            probs[d] = model.transform(t)["probability"][:, 1]
            booster = model.booster
        else:
            booster = train_booster(X, y, BoosterConfig(
                objective="binary", growth_policy=policy, num_iterations=3,
                num_leaves=31, max_bin=255), device=d)
            probs[d] = booster.predict(X)
        aucs[d] = float(auc(torch.as_tensor(y), torch.as_tensor(probs[d])))
        trees[d] = [(tr.split_feature.tolist(), tr.split_bin.tolist())
                    for tr in booster.trees]
        log(f"  {policy} {d}: AUC={aucs[d]:.6f} fit+predict "
            f"{time.perf_counter() - t0:.3f}s")
    dauc = abs(aucs[dev] - aucs["cpu"])
    dprob = float(np.abs(probs[dev] - probs["cpu"]).mean())
    same = sum(a == b for a, b in zip(trees[dev], trees["cpu"]))
    log(f"  {policy}: |AUC diff|={dauc:.3g} mean |prob diff|={dprob:.3g} "
        f"identical trees {same}/{len(trees['cpu'])}")
    if dauc > CROSS_TOL or dprob > CROSS_TOL:
        raise AssertionError(f"{policy}: card and CPU fits disagree")


def profile_phase(ds, dev: str, policy: str) -> None:
    """Device time by kernel over the boosting loop alone (2 iterations of
    the growth ``policy`` on ``ds``, a pre-binned ``Dataset`` of the main
    path's table), from torch.profiler (CUPTI). Busy time sums device-side
    events (kernels and copies); it overstates busy time only where two of
    them overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    cfg = BoosterConfig(objective="binary", num_iterations=2,
                        growth_policy=policy)
    train_booster(ds, None, cfg, device=dev)     # warm caches and allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_booster(ds, None, cfg, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.self_device_time_total / 1e3, e.count, e.key)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(ms for ms, _, _ in events)
    if not busy:
        log("  profiler recorded no device time: not measured")
        return
    log(f"  {policy} 2-iteration training loop: wall {wall_ms:.1f} ms, "
        f"device busy "
        f"{busy:.1f} ms, idle {1 - busy / wall_ms:.1%} of wall")
    for ms, count, key in sorted(events, reverse=True)[:10]:
        log(f"    {ms:9.3f} ms {ms / busy:6.1%} {count:6d}x  {key[:80]}")


# ---------------------------------------------------------------------------
# phase 7: the flash kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_bound_ms(B, H, Sq, Sk, D, elem_bytes, causal=False,
                       state=False, q_offset=0, k_offset=0) -> tuple:
    """(least milliseconds on an H100, what bounds it) for attention of
    (B, Sq, H, D) queries over Sk keys on the route the card offers, the
    tensor cores: 2*D products per live (query, key) pair (QK^T and PV),
    two flops each, the live pairs counted under a causal mask at the given
    offsets. float32 inputs take three TF32 products per float32 product
    (3xTF32, the float32-accurate route) over 495 TFLOP/s, bf16 inputs one
    over 989 TFLOP/s. Bytes: q/k/v read once and the output written once
    (a carried state read and written once more) over 3.35 TB/s."""
    if causal:
        rows = np.arange(Sq, dtype=np.int64) + q_offset - k_offset
        pairs = int(np.clip(rows + 1, 0, Sk).sum())
    else:
        pairs = Sq * Sk
    flops = 4 * B * H * pairs * D
    t_ops = (3 * flops / TF32_OPS_PER_S if elem_bytes == 4
             else flops / BF16_OPS_PER_S) * 1e3
    bytes_ = elem_bytes * B * H * D * (Sq + 2 * Sk) + 4 * B * Sq * H * D
    if state:
        bytes_ += 4 * (2 * B * H * Sq + B * Sq * H * D)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flash_compare(label, got, want, bf16=False) -> float:
    """Max |kernel - plain| over the finite entries of ``want``; raises
    when the two disagree beyond the stated tolerance. Where the plain
    version's running max is -inf (no key reached the row) the kernel must
    hold its finite sentinel -1e30 (or -inf)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    rtol, atol = ((FLASH_BF16_RTOL, FLASH_BF16_ATOL) if bf16
                  else (FLASH_RTOL, FLASH_ATOL))
    ok = torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol) \
        and bool((got[~fin] <= -1e30).all())
    log(f"  {label}: max |kernel - plain| {err:.3g} -> "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             "version")
    return err


def _block_compare(label, got, want, bf16=False, o_bound=None) -> float:
    """``_flash_compare`` of a carried state (m, l, o). o is compared after
    dividing both sides by the plain version's l (1 where l = 0): the
    unnormalised sum over Sk keys carries float32 rounding in proportion to
    l, not to o, whose entries can sit near zero. The raw o gap is logged
    beside it, unchecked. ``o_bound``, where given, replaces the tolerance
    of o / l by that absolute bound (``bf16_o_bound``)."""
    (mk, lk, ok), (mp, lp, op) = got, want
    denom = torch.where(lp > 0, lp, 1.0).transpose(1, 2)[..., None]
    log(f"  {label}: raw o max |kernel - plain| "
        f"{float((ok - op).abs().max()):.3g} (unchecked), max |o / l| "
        f"{float((op / denom).abs().max()):.3g}")
    if o_bound is not None:
        err = float((ok / denom - op / denom).abs().max())
        log(f"  {label}: o / l: max |kernel - plain| {err:.3g}, bound "
            f"{o_bound:.3g} -> {'ok' if err <= o_bound else 'MISMATCH'}")
        if not err <= o_bound:
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 "version")
    return max(_flash_compare(f"{label}: m", mk, mp, bf16),
               _flash_compare(f"{label}: l", lk, lp, bf16),
               err if o_bound is not None else _flash_compare(
                   f"{label}: o / l", ok / denom, op / denom, bf16))


def bf16_o_bound(v) -> float:
    """The bound on |kernel - plain| of a bf16 carried state's o / l: each
    side rounds every p to bf16 (relative error at most 2^-9) against its
    own running maximum, so the two roundings of one p differ by at most
    2^-8 of it; o / l sums p · v over l >= sum p, so the gap is at most
    2^-8 · max |v| (plus float32 rounding, far below). The phase's
    elementwise bf16 tolerance, 8e-3 |x| + 1e-3, assumes o / l of order 1:
    gaps of 1.1e-3 to 1.3e-3 were read at D = 64, 96 and 128 on an H100
    80GB HBM3 at 700 W, so it fails wherever such a gap falls on an entry
    below about 0.04 in size, at any head dim."""
    return 2.0 ** -8 * float(v.float().abs().max())


def _randn(gen, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_kernel_phase(dev: str) -> dict:
    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel.ring_attention import _block_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    fa_err = fb_err = 0.0
    # flash_attention: (B, Sq, Sk, H, D, causal, dtype, strided q)
    for B, Sq, Sk, H, D, causal, dtype, strided in [
            (2, 300, 300, 2, 64, False, torch.float32, False),
            (2, 300, 300, 2, 64, True, torch.float32, True),
            (1, 37, 53, 3, 8, True, torch.float32, False),
            (1, 53, 37, 3, 8, True, torch.float32, False),
            (2, 129, 257, 4, 32, False, torch.bfloat16, True),
            (1, 100, 100, 1, 64, True, torch.float32, False)]:
        q = _randn(gen, (B, Sq, 2 * H if strided else H, D), dev, dtype)
        q = q[:, :, ::2] if strided else q
        k, v = (_randn(gen, (B, Sk, H, D), dev, dtype) for _ in range(2))
        bf16 = dtype == torch.bfloat16
        fa_err = max(fa_err, _flash_compare(
            f"flash_attention B={B} Sq={Sq} Sk={Sk} H={H} D={D} "
            f"causal={causal} {'bf16' if bf16 else 'f32'}"
            f"{' strided q' if strided else ''}",
            ak.flash_attention(q, k, v, causal=causal),
            ak._xla_fallback(q, k, v, causal, D ** -0.5, 128), bf16))
    # flash_attention_block: empty state (m = -inf rows) and a carried one
    B, Sq, Sk, H, D = 2, 140, 128, 2, 64
    for q_off, k_off, causal, dtype in [
            (64, 0, False, torch.float32), (64, 0, True, torch.float32),
            (0, 140, True, torch.float32),    # wholly in the causal future
            (200, 100, True, torch.float32), (150, 100, True,
                                              torch.bfloat16)]:
        q, k, v = (_randn(gen, (B, n, H, D), dev, dtype)
                   for n in (Sq, Sk, Sk))
        bf16 = dtype == torch.bfloat16
        for carried in (False, True):
            if carried:
                # rows no key has reached yet (m = -inf) hold l = 0, o = 0
                m = _randn(gen, (B, H, Sq), dev)
                l = torch.rand((B, H, Sq), generator=gen, device=dev) + 0.5
                o = _randn(gen, (B, Sq, H, D), dev)
                m[:, :, ::7], l[:, :, ::7], o[:, ::7] = -float("inf"), 0, 0
            else:
                m = torch.full((B, H, Sq), -float("inf"), device=dev)
                l = torch.zeros((B, H, Sq), device=dev)
                o = torch.zeros((B, Sq, H, D), device=dev)
            got = ak.flash_attention_block(q, k, v, m, l, o, q_off, k_off,
                                           causal=causal, scale=0.125)
            want = _block_attention(q, k, v, m, l, o, q_off, k_off, causal,
                                    0.125)
            label = (f"flash_attention_block q_off={q_off} k_off={k_off} "
                     f"causal={causal} {'bf16' if bf16 else 'f32'} "
                     f"{'carried' if carried else 'empty'} state")
            fb_err = max(fb_err, _block_compare(label, got, want, bf16))
            if k_off > q_off + Sq - 1:
                if not (torch.equal(got[1], l) and torch.equal(got[2], o)):
                    raise AssertionError("a step wholly in the causal future "
                                         "changed the state")
    fa_err, fb_err = wide_heads_phase(dev, gen, fa_err, fb_err)
    return path_shape_phase(dev, gen, fa_err, fb_err)


def wide_heads_phase(dev: str, gen, fa_err: float, fb_err: float) -> tuple:
    """Both kernels at each of ``WIDE_HEAD_DIMS`` against their plain
    versions (float32; bf16 without a causal mask for ``flash_attention``,
    as phase 7's other bf16 case), then at each of ``TIMED_HEAD_DIMS`` at
    the seq path's lengths (``_time_wide_head``)."""
    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel.ring_attention import _block_attention

    for D in WIDE_HEAD_DIMS:
        for causal, dtype in ((False, torch.float32), (True, torch.float32),
                              (False, torch.bfloat16)):
            bf16 = dtype == torch.bfloat16
            q, k, v = (_randn(gen, (2, n, 3, D), dev, dtype)
                       for n in (145, 130, 130))
            fa_err = max(fa_err, _flash_compare(
                f"flash_attention D={D} Sq=145 Sk=130 causal={causal} "
                f"{'bf16' if bf16 else 'f32'}",
                ak.flash_attention(q, k, v, causal=causal),
                ak._xla_fallback(q, k, v, causal, D ** -0.5, 128), bf16))
            m = _randn(gen, (2, 3, 145), dev)
            l = torch.rand((2, 3, 145), generator=gen, device=dev) + 0.5
            o = _randn(gen, (2, 145, 3, D), dev)
            m[:, :, ::7], l[:, :, ::7], o[:, ::7] = -float("inf"), 0, 0
            fb_err = max(fb_err, _block_compare(
                f"flash_attention_block D={D} q_off=40 k_off=17 "
                f"causal={causal} {'bf16' if bf16 else 'f32'} carried state",
                ak.flash_attention_block(q, k, v, m, l, o, 40, 17,
                                         causal=causal),
                _block_attention(q, k, v, m, l, o, 40, 17, causal,
                                 D ** -0.5), bf16,
                bf16_o_bound(v) if bf16 else None))
    for D in TIMED_HEAD_DIMS:
        fa_err, fb_err = _time_wide_head(dev, gen, D, fa_err, fb_err)
    return fa_err, fb_err


def _time_wide_head(dev: str, gen, D: int, fa_err: float,
                    fb_err: float) -> tuple:
    """Both kernels at head dim ``D`` at the seq path's lengths: checked,
    then timed beside their plain versions, bounds and (flash_attention)
    SDPA."""
    import torch.nn.functional as F

    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel.ring_attention import _block_attention

    B, S, H = SEQ_BATCH, ENCODER["max_len"], ENCODER["num_heads"]
    hu, s_local, scale = H // SEQ_RANKS, S // SEQ_RANKS, D ** -0.5
    q, k, v = (_randn(gen, (B, S, hu, D), dev) for _ in range(3))
    fa_err = max(fa_err, _flash_compare(
        f"flash_attention at ({B}, {S}, {hu}, {D})",
        ak.flash_attention(q, k, v), ak._xla_fallback(q, k, v, False, scale,
                                                      128)))
    t_k = time_ms(lambda: ak.flash_attention(q, k, v), 5)
    t_p = time_ms(lambda: ak._xla_fallback(q, k, v, False, scale, 128), 2)
    qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(qT, kT, vT,
                                                         scale=scale), 5)
    bnd, by = attention_bound_ms(B, hu, S, S, D, 4)
    log(f"  flash_attention D={D} [q/k/v ({B}, {S}, {hu}, {D}) f32]: "
        f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
        f"bound_ms={bnd:.4f} ({by}) -> {bnd / t_k:.1%} of bound")
    del q, k, v, qT, kT, vT
    q, k, v = (_randn(gen, (B, s_local, H, D), dev) for _ in range(3))
    m = _randn(gen, (B, H, s_local), dev)
    l = torch.rand((B, H, s_local), generator=gen, device=dev) + 0.5
    o = _randn(gen, (B, s_local, H, D), dev)
    fb_err = max(fb_err, _block_compare(
        f"flash_attention_block at ({B}, {s_local}, {H}, {D})",
        ak.flash_attention_block(q, k, v, m, l, o, s_local, 0),
        _block_attention(q, k, v, m, l, o, s_local, 0, False, scale)))
    t_k = time_ms(lambda: ak.flash_attention_block(q, k, v, m, l, o,
                                                   s_local, 0), 5)
    t_p = time_ms(lambda: _block_attention(q, k, v, m, l, o, s_local, 0,
                                           False, scale), 2)
    bnd, by = attention_bound_ms(B, H, s_local, s_local, D, 4, state=True)
    log(f"  flash_attention_block D={D} [q/k/v ({B}, {s_local}, {H}, {D}) "
        f"f32, carried state]: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
        f"bound_ms={bnd:.4f} ({by}) -> {bnd / t_k:.1%} of bound")
    del q, k, v, m, l, o
    torch.cuda.empty_cache()
    return fa_err, fb_err


def path_shape_phase(dev: str, gen, fa_err: float, fb_err: float) -> dict:
    """Both kernels at the seq path's shapes: checked, then timed beside
    their plain versions, bounds and (flash_attention) SDPA."""
    import torch.nn.functional as F

    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel.ring_attention import _block_attention

    B, S, H, D = SEQ_BATCH, ENCODER["max_len"], ENCODER["num_heads"], \
        ENCODER["hidden"] // ENCODER["num_heads"]
    hu, s_local = H // SEQ_RANKS, S // SEQ_RANKS
    scale = D ** -0.5
    results = {}
    # Ulysses: each rank attends over the whole sequence for H / p heads
    q, k, v = (_randn(gen, (B, S, hu, D), dev) for _ in range(3))
    fa_err = max(fa_err, _flash_compare(
        f"flash_attention at the Ulysses shape ({B}, {S}, {hu}, {D})",
        ak.flash_attention(q, k, v), ak._xla_fallback(q, k, v, False, scale,
                                                      128)))
    t_kernel = time_ms(lambda: ak.flash_attention(q, k, v), 10)
    t_plain = time_ms(lambda: ak._xla_fallback(q, k, v, False, scale, 128),
                      3)
    qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(qT, kT, vT,
                                                           scale=scale), 5)
    bnd, by = attention_bound_ms(B, hu, S, S, D, 4)
    for causal, dtype in ((True, torch.float32), (False, torch.bfloat16),
                          (True, torch.bfloat16)):
        qc, kc, vc = (x.to(dtype) for x in (q, k, v))
        t_c = time_ms(lambda: ak.flash_attention(qc, kc, vc, causal=causal),
                      10)
        qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (qc, kc, vc))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            qT, kT, vT, is_causal=causal, scale=scale), 5)
        b_c, by_c = attention_bound_ms(B, hu, S, S, D, qc.element_size(),
                                       causal=causal)
        log(f"  flash_attention causal={causal} {str(dtype)[6:]} at the "
            f"same shape: kernel_ms={t_c:.4f} library_ms={t_l:.4f} "
            f"bound_ms={b_c:.4f} ({by_c}) -> {b_c / t_c:.1%} of bound")
    del qc, kc, vc
    results["flash_attention"] = dict(
        replaces="synapseml_tpu/ops/attention_kernel.py:37",
        max_abs_err=fa_err, ms=t_kernel, plain_ms=t_plain, bound_ms=bnd,
        bound_by=by, library_ms=t_lib,
        shape=f"q/k/v ({B}, {S}, {hu}, {D}) f32")
    del q, k, v, qT, kT, vT
    # ring step: this rank's queries against one rank's keys, carried state
    q, k, v = (_randn(gen, (B, s_local, H, D), dev) for _ in range(3))
    m = _randn(gen, (B, H, s_local), dev)
    l = torch.rand((B, H, s_local), generator=gen, device=dev) + 0.5
    o = _randn(gen, (B, s_local, H, D), dev)
    got = ak.flash_attention_block(q, k, v, m, l, o, s_local, 0)
    want = _block_attention(q, k, v, m, l, o, s_local, 0, False, scale)
    fb_err = max(fb_err, _block_compare(
        f"flash_attention_block at the ring shape ({B}, {s_local}, {H}, {D})",
        got, want))
    del got, want
    t_kernel = time_ms(
        lambda: ak.flash_attention_block(q, k, v, m, l, o, s_local, 0), 10)
    t_plain = time_ms(
        lambda: _block_attention(q, k, v, m, l, o, s_local, 0, False, scale),
        3)
    bnd, by = attention_bound_ms(B, H, s_local, s_local, D, 4, state=True)
    # the ring's diagonal step (causal, equal offsets) and bf16 inputs (the
    # bf16 training step's instantiation): checked, then timed
    for causal, dtype in ((True, torch.float32), (False, torch.bfloat16)):
        qc, kc, vc = (x.to(dtype) for x in (q, k, v))
        bf16 = dtype == torch.bfloat16
        fb_err = max(fb_err, _block_compare(
            f"flash_attention_block causal={causal} {str(dtype)[6:]} "
            f"(offsets {s_local}, {s_local}) at the ring shape",
            ak.flash_attention_block(qc, kc, vc, m, l, o, s_local, s_local,
                                     causal=causal),
            _block_attention(qc, kc, vc, m, l, o, s_local, s_local, causal,
                             scale),
            bf16=bf16, o_bound=bf16_o_bound(vc) if bf16 else None))
        t_c = time_ms(lambda: ak.flash_attention_block(
            qc, kc, vc, m, l, o, s_local, s_local, causal=causal), 10)
        b_c, by_c = attention_bound_ms(B, H, s_local, s_local, D,
                                       qc.element_size(), causal=causal,
                                       state=True)
        log(f"  flash_attention_block causal={causal} {str(dtype)[6:]} "
            f"(offsets {s_local}, {s_local}) at the same shape: kernel_ms="
            f"{t_c:.4f} bound_ms={b_c:.4f} ({by_c}) -> {b_c / t_c:.1%} of "
            "bound")
    del qc, kc, vc
    results["flash_attention_block"] = dict(
        replaces="synapseml_tpu/ops/attention_kernel.py:253",
        max_abs_err=fb_err, ms=t_kernel, plain_ms=t_plain, bound_ms=bnd,
        bound_by=by, library_ms=None,
        shape=f"q/k/v ({B}, {s_local}, {H}, {D}) f32, carried state")
    del q, k, v, m, l, o
    torch.cuda.empty_cache()
    for name, r in results.items():
        lib = ("none (no single PyTorch call computes the carried-state "
               "update)" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"  {name} [{r['shape']}]: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"-> {r['bound_ms'] / r['ms']:.1%} of bound")
    return results


# ---------------------------------------------------------------------------
# phase 8: the sequence-parallel encoder on two ranks
# ---------------------------------------------------------------------------

def reference_params(cfg: dict, seed: int = 0) -> dict:
    """Random weights for the encoder ``cfg`` in the JAX package's flax
    layout (nested dict of numpy arrays, flax's names), at the scales of
    flax's initialisers; LayerNorm and bias terms perturbed so each one
    matters."""
    rng = np.random.default_rng(seed)
    h, mlp, L = cfg["hidden"], cfg["hidden"] * cfg["mlp_ratio"], \
        cfg["num_layers"]
    nh = cfg["num_heads"]

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    def dense(shape_in, shape_out):
        fan_in = int(np.prod(shape_in))
        return {"kernel": normal(shape_in + shape_out, fan_in ** -0.5),
                "bias": normal(shape_out, 0.02)}

    def norm():
        return {"scale": 1 + normal((h,), 0.1), "bias": normal((h,), 0.1)}

    p = {"tok_embed": {"embedding": normal((cfg["vocab_size"], h),
                                           h ** -0.5)},
         "pos_embed": normal((cfg["max_len"], h), 0.02),
         "head": dense((h,), (cfg["num_classes"],))}
    for i in range(L):
        p[f"attn_{i}"] = {n: dense((h,), (nh, h // nh))
                          for n in ("query", "key", "value")}
        p[f"attn_{i}"]["out"] = dense((nh, h // nh), (h,))
        p[f"Dense_{2 * i}"] = dense((h,), (mlp,))
        p[f"Dense_{2 * i + 1}"] = dense((mlp,), (h,))
    for i in range(2 * L + 1):
        p[f"LayerNorm_{i}"] = norm()
    return {"params": p}


def seq_inputs(cfg: dict, seed: int = 0) -> np.ndarray:
    """(SEQ_BATCH, max_len) ids from ``hash_tokenize``: texts of random
    words, long enough to fill the window but one row half of it (PAD
    tokens, learned in a mask-free encoder)."""
    from synapseml_tpu_torch.dl import hash_tokenize

    rng = np.random.default_rng(seed)
    n = cfg["max_len"]
    lengths = [n + 100, n + 100, n // 2, n + 100]
    texts = [" ".join(f"w{w}" for w in rng.integers(0, 50_000, size=ln))
             for ln in lengths]
    return hash_tokenize(texts, cfg["vocab_size"], n)


def build_encoder(cfg: dict, dev):
    from synapseml_tpu_torch.convert import text_encoder_from_reference
    from synapseml_tpu_torch.dl import TransformerEncoder

    model = TransformerEncoder(**cfg)
    model.load_state_dict(text_encoder_from_reference(reference_params(cfg)))
    return model.to(dev).eval()


def _seq_rank(rank: int, workdir: str, dev: str, cfg: dict) -> None:
    """One rank of the seq path (spawned): the encoder ``cfg`` forward in
    scope, ring then Ulysses, on ``dev`` (the card, shared with the other
    rank)."""
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.dl import (seq_attention_scope,
                                        sharded_self_attention)
    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel import (attention_reference,
                                              collectives, init_distributed,
                                              make_mesh)

    init_distributed("gloo", os.path.join(workdir, "store"), rank, SEQ_RANKS,
                     timeout_s=300)
    mesh = make_mesh({"seq": SEQ_RANKS}, device=dev)
    model = build_encoder(cfg, mesh.device)
    ids = torch.as_tensor(seq_inputs(cfg), device=mesh.device)
    report = {}
    with torch.no_grad():
        for variant in ("ring", "ulysses"):
            with seq_attention_scope(mesh, variant):
                model(ids)                           # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ak.reset_launch_counts()
                collectives.reset_staging_counts()
                t0 = time.perf_counter()
                logits = model(ids)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(ak.LAUNCHES)
            np.save(os.path.join(workdir, f"{variant}_{rank}.npy"),
                    logits.cpu().numpy())
            report[variant] = dict(
                forward_s=wall, launches=launches,
                staged_bytes=collectives.STAGING["bytes"],
                staging_s=collectives.STAGING["seconds"],
                comm_s=dict(collectives.COMM_SECONDS),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del logits
        torch.cuda.empty_cache()
        # the same inputs on every rank: a generator on the card, one seed
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(5)
        q, k, v = (torch.randn(PADDED_SHAPE, generator=gen,
                               device=mesh.device) for _ in range(3))
        want = attention_reference(q, k, v)
        for variant in ("ring", "ulysses"):
            ak.reset_launch_counts()
            got = sharded_self_attention(q, k, v, mesh, variant=variant)
            torch.cuda.synchronize()
            report[f"padded_{variant}"] = dict(
                launches=dict(ak.LAUNCHES),
                max_abs_err=float((got - want).abs().max()),
                ok=bool(torch.allclose(got, want, rtol=FLASH_RTOL,
                                       atol=FLASH_ATOL)))
    with open(os.path.join(workdir, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def seq_path(dev: str, cfg: dict = ENCODER) -> None:
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ids = seq_inputs(cfg)
    model = build_encoder(cfg, dev)
    log(f"  encoder built from flax-layout weights via the converter in "
        f"{time.perf_counter() - t0:.2f}s; ids {ids.shape}, "
        f"{int((ids != 0).sum())} non-PAD tokens")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ids_d = torch.as_tensor(ids, device=dev)
        ref = model(ids_d)                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = model(ids_d).cpu().numpy()
        ref_s = time.perf_counter() - t0
    log(f"  out of scope (plain attention, one process): forward "
        f"{ref_s:.3f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, logits "
        f"{ref.ravel().round(6).tolist()}")
    if ref.shape != (SEQ_BATCH, cfg["num_classes"]) \
            or not np.isfinite(ref).all():
        raise AssertionError(f"reference logits bad: {ref}")
    del model, ids_d
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        mp.spawn(_seq_rank, args=(workdir, f"{dev}:0", cfg),
                 nprocs=SEQ_RANKS, join=True)
        log(f"  {SEQ_RANKS} ranks spawned, ran and joined in "
            f"{time.perf_counter() - t0:.1f}s")
        reports = []
        logits = {}
        for r in range(SEQ_RANKS):
            with open(os.path.join(workdir, f"report_{r}.json")) as f:
                reports.append(json.load(f))
            for variant in ("ring", "ulysses"):
                logits[variant, r] = np.load(
                    os.path.join(workdir, f"{variant}_{r}.npy"))
    want = {"ring": {"flash_attention_block": 2 * cfg["num_layers"],
                     "flash_attention": 0},
            "ulysses": {"flash_attention": cfg["num_layers"],
                        "flash_attention_block": 0}}
    for variant in ("ring", "ulysses"):
        for r, rep in enumerate(reports):
            x = rep[variant]
            got = logits[variant, r]
            err = float(np.abs(got - ref).max())
            log(f"  {variant} rank {r}: forward {x['forward_s']:.3f}s, "
                f"staging {x['staging_s']:.3f}s for "
                f"{x['staged_bytes'] / 2**20:.1f} MiB, collectives "
                f"{json.dumps({k: round(v, 4) for k, v in x['comm_s'].items()})}"
                f", peak device memory {x['peak_gib']:.3f} GiB, launches "
                f"{json.dumps(x['launches'])}, max |logits - out of scope| "
                f"{err:.3g}")
            if not np.allclose(got, ref, rtol=SEQ_RTOL, atol=SEQ_ATOL):
                raise AssertionError(f"{variant} rank {r}: logits disagree "
                                     "with the encoder out of scope")
            if x["launches"] != want[variant]:
                raise AssertionError(f"{variant} rank {r}: launches "
                                     f"{x['launches']}, expected "
                                     f"{want[variant]}")
    padded_want = {"ring": {"flash_attention_block": 2, "flash_attention": 0},
                   "ulysses": {"flash_attention": 1,
                               "flash_attention_block": 0}}
    for variant in ("ring", "ulysses"):
        for r, rep in enumerate(reports):
            x = rep[f"padded_{variant}"]
            log(f"  padded {PADDED_SHAPE} {variant} rank {r}: launches "
                f"{json.dumps(x['launches'])}, max |sharded - reference| "
                f"{x['max_abs_err']:.3g}")
            if not x["ok"] or x["launches"] != padded_want[variant]:
                raise AssertionError(f"padded {variant} rank {r}: expected "
                                     f"{padded_want[variant]} launches "
                                     "and agreement with the reference")
    diff = max(float(np.abs(logits["ring", r] - logits["ulysses", r]).max())
               for r in range(SEQ_RANKS))
    log(f"  ring vs Ulysses: max |logits diff| {diff:.3g}")
    if not all(np.allclose(logits["ring", r], logits["ulysses", r],
                           rtol=VARIANT_TOL, atol=VARIANT_TOL)
               for r in range(SEQ_RANKS)):
        raise AssertionError("ring and Ulysses logits disagree")


# ---------------------------------------------------------------------------
# phase 9: DeepTextClassifier trains on two ranks
# ---------------------------------------------------------------------------

def _on_card(dev: str) -> bool:
    return dev.startswith("cuda")


def _sync(dev: str) -> None:
    if _on_card(dev):
        torch.cuda.synchronize()


def _peak_gib(dev: str, reset: bool = False) -> float:
    """Peak device memory since the last reset (0 on the CPU)."""
    if not _on_card(dev):
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def train_table(est: dict, seed: int = 0):
    """``TRAIN_ROWS`` texts long enough to fill the window, balanced labels
    (alternating), each text's words drawn at random with its label's
    sentiment words sprinkled in."""
    from synapseml_tpu_torch.core import Table

    rng = np.random.default_rng(seed)
    n = est["maxTokenLen"] + 100
    labels = np.arange(TRAIN_ROWS) % 2
    texts = []
    for y in labels:
        words = np.array([f"w{w}" for w in rng.integers(0, 50_000, size=n)])
        words[rng.random(n) < 0.05] = ("good", "bad")[y]
        texts.append(" ".join(words))
    return Table({"text": texts, "label": labels})


def _digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _train_rank(rank: int, workdir: str, dev: str, est_params: dict) -> None:
    """One rank of phase 9 (spawned): every ``TRAIN_RUNS`` fit through
    ``DeepTextClassifier`` on ``dev`` (the card, shared with the other
    rank), the ring and Ulysses models' ``transform``; the launch counts
    are zeroed just before each fit and each transform and read just after,
    and each training forward's launches are read around it (forward
    hooks)."""
    sys.path.insert(0, str(REPO))
    from torch.nn.modules import module as nn_module

    from synapseml_tpu_torch.dl.text import (DeepTextClassifier,
                                             TransformerEncoder)
    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel import collectives, init_distributed

    init_distributed("gloo", os.path.join(workdir, "store"), rank, SEQ_RANKS,
                     timeout_s=600)
    table = train_table(est_params)
    forwards = []

    def pre(mod, args):
        if isinstance(mod, TransformerEncoder) and mod.training:
            forwards.append(dict(ak.LAUNCHES))

    def post(mod, args, out):
        if isinstance(mod, TransformerEncoder) and mod.training:
            forwards[-1] = {k: ak.LAUNCHES[k] - forwards[-1][k]
                            for k in ak.LAUNCHES}

    hooks = [nn_module.register_module_forward_pre_hook(pre),
             nn_module.register_module_forward_hook(post)]
    report = {}
    for run, kw in TRAIN_RUNS:
        est = DeepTextClassifier(**est_params, **kw, device=dev)
        forwards.clear()
        _sync(dev)
        _peak_gib(dev, reset=True)
        collectives.reset_staging_counts()
        ak.reset_launch_counts()
        t0 = time.perf_counter()
        model = est.fit(table)
        _sync(dev)
        fit_s = time.perf_counter() - t0
        x = dict(fit_s=fit_s, launches=dict(ak.LAUNCHES),
                 forwards=list(forwards), steps=model.trainer.step_stats,
                 variant=model.trainer.stats.get("seq_attention"),
                 staged_bytes=collectives.STAGING["bytes"],
                 staging_s=collectives.STAGING["seconds"],
                 comm_s=dict(collectives.COMM_SECONDS),
                 peak_gib=_peak_gib(dev),
                 digest=_digest(model.trainer.model))
        if run in ("ring", "ulysses"):
            ak.reset_launch_counts()
            t0 = time.perf_counter()
            out = model.transform(table)
            x["transform_s"] = time.perf_counter() - t0
            x["transform_launches"] = dict(ak.LAUNCHES)
            np.save(os.path.join(workdir, f"prob_{run}_{rank}.npy"),
                    np.asarray(out["probability"]))
        report[run] = x
        del model
        if _on_card(dev):
            torch.cuda.empty_cache()
    for h in hooks:
        h.remove()
    if _on_card(dev):
        report["profile"] = _profiled_step(rank, table, dev, est_params)
    with open(os.path.join(workdir, f"train_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def _profiled_step(rank: int, table, dev: str, est_params: dict) -> dict:
    """One more ring step in the warmed process (a 1-step fit), rank 0
    under torch.profiler (CUPTI), rank 1 alongside it: the step's wall,
    device busy time and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.dl.text import DeepTextClassifier

    est = DeepTextClassifier(**est_params, seqAttention="ring",
                             stepsPerEpoch=1, device=dev)
    if rank != 0:
        est.fit(table)
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model = est.fit(table)
        _sync(dev)
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3
    # device time by the PyTorch op that launched it (a kernel of the port
    # is launched by no op and shows under its own name)
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in avg if e.self_device_time_total > 0
                  and (e.device_type == DeviceType.CPU
                       or "flash" in e.key)), reverse=True)
    st = model.trainer.step_stats[0]
    return dict(wall_ms=1e3 * sum(st[k] for k in ("forward_s", "backward_s",
                                                  "allreduce_s",
                                                  "update_s")),
                busy_ms=busy,
                top=[(ms, n, key[:70]) for ms, n, key in ops[:14]])


def reference_fit(dev: str, est_params: dict, **kw) -> list:
    """The ``step_stats`` of the same fit out of scope: the estimator's
    initial encoder (the same seed), its ``TrainConfig`` and batches
    (``default_rng([seed, 0])``), plain attention, one process (no mesh).
    Each batch runs as ``batchSize`` microbatches of one row
    (``accum_steps``): the same mean loss and summed gradient, without the
    plain attention's (B, H, S, S) scores of the whole batch held for the
    backward."""
    from synapseml_tpu_torch.dl.text import DeepTextClassifier, hash_tokenize
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    est = DeepTextClassifier(**{**est_params, **kw}, device=dev)
    table = train_table(est_params)
    ids = hash_tokenize(list(table["text"]), est.getVocabSize(),
                        est.getMaxTokenLen())
    cfg = TrainConfig(batch_size=est.getBatchSize(),
                      max_epochs=est.getMaxEpochs(),
                      learning_rate=est.getLearningRate(),
                      optimizer=est.getOptimizer(),
                      compute_dtype=est.getPrecision(), seed=est.getSeed(),
                      steps_per_epoch=est.getStepsPerEpoch() or None,
                      accum_steps=est.getBatchSize())
    tr = Trainer(est._encoder(2), cfg, device=dev)
    tr.fit(ids, np.asarray(table["label"]))
    steps = tr.step_stats
    del tr
    if _on_card(dev):
        torch.cuda.empty_cache()
    return steps


def grad_norm_gap(got: dict, want: dict) -> tuple:
    """(largest |got - want| over the parameters' gradient norms, the whole
    gradient's norm in ``want``): the per-parameter norms of one step
    against the reference's. Holding the gap to ``SEQ_RTOL`` of the whole
    norm holds no more than the whole gradient to ``SEQ_RTOL``, since
    | |a| - |b| | <= |a - b| leaf by leaf."""
    if set(got) != set(want):
        raise AssertionError("gradient norms of different parameters")
    total = float(np.sqrt(sum(v * v for v in want.values())))
    return max(abs(got[k] - want[k]) for k in want), total


def recompute_backward_ms(dev: str, est: dict) -> dict:
    """Device milliseconds of each flash kernel's recompute backward (the
    plain version's autograd, what a training step runs for every launch)
    at the path's shapes, float32, and its peak memory."""
    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel.ring_attention import _block_attention

    B, S, H = est["batchSize"], est["maxTokenLen"], est["numHeads"]
    D = est["hiddenSize"] // H
    hu, s_local, scale = H // SEQ_RANKS, S // SEQ_RANKS, D ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = {}
    q, k, v, g = (_randn(gen, (B, S, hu, D), dev) for _ in range(4))
    _peak_gib(dev, reset=True)
    out["flash_attention"] = (time_ms(lambda: ak._recompute_grads(
        lambda a, b, c: ak._xla_fallback(a, b, c, False, scale, 128),
        (q, k, v), (g,)), 2), _peak_gib(dev))
    del q, k, v, g
    q, k, v, o = (_randn(gen, (B, s_local, H, D), dev) for _ in range(4))
    m = _randn(gen, (B, H, s_local), dev)
    l = torch.rand((B, H, s_local), generator=gen, device=dev) + 0.5
    grads = (torch.randn_like(m), torch.randn_like(l), torch.randn_like(o))
    if _on_card(dev):
        torch.cuda.empty_cache()
    _peak_gib(dev, reset=True)
    out["flash_attention_block"] = (time_ms(lambda: ak._recompute_grads(
        lambda *a: _block_attention(*a, s_local, 0, False, scale),
        (q, k, v, m, l, o), grads), 2), _peak_gib(dev))
    del q, k, v, m, l, o, grads
    if _on_card(dev):
        torch.cuda.empty_cache()
    return out


def check_against_reference(report: dict, ref: list, ref16: list) -> None:
    """One rank's fits against the same fits out of scope
    (``reference_fit``; the ranks are bitwise equal, so one is enough).

    float32, ring and Ulysses: every step's loss within ``SEQ_RTOL`` of the
    reference's, and the first step's gradient (after the all-reduce) within
    ``SEQ_RTOL`` of the whole reference gradient's norm, parameter by
    parameter (``grad_norm_gap``). The first step is the forward; the
    second holds the backward, the all-reduce and the update too (adamw:
    ``lr · sign(g)`` at the first update, and a sign that flips in float32
    noise belongs to an entry near 0, which moves the loss by about
    ``lr · |g|``); the gradient norms hold its scale, which adamw's update
    does not see (a missing 1/world, a head summed without it, shards
    left unsummed).

    bf16: the step's loss within twice the reference's own distance from
    the float32 loss (at least 2^-8 of that loss). Both sides cast every
    layer to bf16 alike and differ inside the attention only, where the
    plain side rounds scores and weights to bf16 as flax does and the
    kernel keeps them float32: one rounding among the several of each layer
    that make up the reference's distance from float32."""
    for run in ("ring", "ulysses"):
        steps = report[run]["steps"]
        for st, want in zip(steps, ref):
            if not np.isclose(st["loss"], want["loss"], rtol=SEQ_RTOL,
                              atol=0):
                raise AssertionError(
                    f"{run} step {st['step']}: loss {st['loss']} against "
                    f"{want['loss']} out of scope")
        gap, total = grad_norm_gap(steps[0]["grad_norms"],
                                   ref[0]["grad_norms"])
        log(f"  {run}: step losses {[round(x['loss'], 7) for x in steps]}; "
            f"first-step gradient norms: largest gap {gap:.3g} against the "
            f"whole norm {total:.6g} ({gap / total:.2e}; limit {SEQ_RTOL})")
        if not gap <= SEQ_RTOL * total:
            raise AssertionError(f"{run}: the first step's gradient "
                                 "disagrees with the same step out of scope")
    got, want = report["bf16"]["steps"][0]["loss"], ref16[0]["loss"]
    tol = max(2 * abs(want - ref[0]["loss"]), 2.0 ** -8 * ref[0]["loss"])
    log(f"  bf16: first loss {got:.7f} against {want:.7f} out of scope: gap "
        f"{abs(got - want):.3g}, limit {tol:.3g}")
    if not abs(got - want) <= tol:
        raise AssertionError("the bf16 step disagrees with the same step out "
                             "of scope")


def train_path(dev: str, est: dict = TRAIN_EST) -> dict:
    """Phase 9's checks over both ranks' reports; returns the flash launches
    of the ring fit (``flash_attention_block``) and of the Ulysses fit
    (``flash_attention``), summed over the ranks."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    _peak_gib(dev, reset=True)
    ref = reference_fit(dev, est)
    ref16 = reference_fit(dev, est, precision="bfloat16", stepsPerEpoch=1)
    log(f"  the same fits out of scope (plain attention, one process, "
        f"microbatches of one row): float32 losses "
        f"{[round(st['loss'], 7) for st in ref]}, bf16 first loss "
        f"{ref16[0]['loss']:.7f} ({time.perf_counter() - t0:.1f}s, peak "
        f"{_peak_gib(dev):.2f} GiB)")
    for name, (ms, gib) in recompute_backward_ms(dev, est).items():
        log(f"  {name} recompute backward at the path's shape: {ms:.2f} ms, "
            f"peak {gib:.2f} GiB")
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        mp.spawn(_train_rank, args=(workdir, dev, est), nprocs=SEQ_RANKS,
                 join=True)
        log(f"  {SEQ_RANKS} ranks spawned, trained and joined in "
            f"{time.perf_counter() - t0:.1f}s")
        reports = []
        for r in range(SEQ_RANKS):
            with open(os.path.join(workdir, f"train_{r}.json")) as f:
                reports.append(json.load(f))
        probs = {(run, r): np.load(os.path.join(workdir,
                                                f"prob_{run}_{r}.npy"))
                 for run in ("ring", "ulysses") for r in range(SEQ_RANKS)}
    first = {}
    batches = -(-TRAIN_ROWS // est["batchSize"])
    for run, kw in TRAIN_RUNS:
        steps = 1 if kw.get("stepsPerEpoch") else TRAIN_ROWS // est[
            "batchSize"]
        per_forward = FORWARD_LAUNCHES["ulysses" if run == "ulysses"
                                       else "ring"]
        for r, rep in enumerate(reports):
            x = rep[run]
            losses = [st["loss"] for st in x["steps"]]
            for st in x["steps"]:
                log(f"  {run} rank {r} step {st['step']}: loss "
                    f"{st['loss']:.7f} forward {st['forward_s']:.3f}s "
                    f"backward {st['backward_s']:.3f}s all-reduce "
                    f"{st['allreduce_s']:.3f}s update {st['update_s']:.4f}s")
            comm = {k: round(v, 3) for k, v in x["comm_s"].items()}
            log(f"  {run} rank {r}: variant {x['variant']}, fit "
                f"{x['fit_s']:.2f}s, staged "
                f"{x['staged_bytes'] / 2**20:.1f} MiB in "
                f"{x['staging_s']:.3f}s, collectives {json.dumps(comm)}"
                f", peak device memory {x['peak_gib']:.2f} GiB, launches "
                f"{json.dumps(x['launches'])}, per forward "
                f"{json.dumps(x['forwards'])}")
            if "transform_s" in x:
                log(f"  {run} rank {r}: transform {x['transform_s']:.2f}s, "
                    f"launches {json.dumps(x['transform_launches'])}")
            if len(losses) != steps or not np.isfinite(losses).all():
                raise AssertionError(f"{run} rank {r}: losses {losses}")
            if x["variant"] != ("ulysses" if run == "ulysses" else "ring"):
                raise AssertionError(f"{run}: ran {x['variant']}")
            if x["forwards"] != [per_forward] * steps:
                raise AssertionError(f"{run} rank {r}: forward launches "
                                     f"{x['forwards']}, expected "
                                     f"{per_forward} in each of {steps}")
            if x["launches"] != {k: v * steps
                                 for k, v in per_forward.items()}:
                raise AssertionError(f"{run} rank {r}: launches in the fit "
                                     f"{x['launches']}")
            if "transform_s" in x:
                if x["transform_launches"] != {
                        k: v * batches for k, v in per_forward.items()}:
                    raise AssertionError(f"{run} rank {r}: transform "
                                         "launches, expected "
                                         f"{per_forward} per batch")
                p = probs[run, r]
                if p.shape != (TRAIN_ROWS, 2) or not np.isfinite(p).all() \
                        or not np.allclose(p.sum(-1), 1.0, atol=1e-5):
                    raise AssertionError(f"{run} rank {r}: probabilities "
                                         f"{p}")
        if len({rep[run]["digest"] for rep in reports}) != 1:
            raise AssertionError(f"{run}: parameters differ across ranks")
        if not all(np.array_equal(probs[run, r], probs[run, 0])
                   for r in range(SEQ_RANKS) if (run, r) in probs):
            raise AssertionError(f"{run}: probabilities differ across ranks")
        first[run] = reports[0][run]["steps"][0]["loss"]
        log(f"  {run}: parameters bitwise equal on {SEQ_RANKS} ranks "
            f"(sha256 {reports[0][run]['digest'][:16]})")
    prof = reports[0].get("profile")
    if prof and prof["busy_ms"]:
        log(f"  profiled ring step (rank 0, warm): wall {prof['wall_ms']:.1f} "
            f"ms (under the profiler), device busy {prof['busy_ms']:.1f} ms, "
            f"idle {1 - prof['busy_ms'] / prof['wall_ms']:.1%}")
        for ms, n, key in prof["top"]:
            log(f"    {ms:9.3f} ms {ms / prof['busy_ms']:6.1%} {n:6d}x  {key}")
    elif prof is not None:
        log("  profiler recorded no device time: not measured")
    log(f"  first-step losses: ring {first['ring']:.7f} ulysses "
        f"{first['ulysses']:.7f} bf16 {first['bf16']:.7f}; out of scope "
        f"float32 {ref[0]['loss']:.7f} bf16 {ref16[0]['loss']:.7f}")
    check_against_reference(reports[0], ref, ref16)
    if not np.isclose(first["ring"], first["ulysses"], rtol=VARIANT_TOL,
                      atol=VARIANT_TOL):
        raise AssertionError("ring and Ulysses first-step losses disagree")
    return {name: sum(rep[run]["launches"][name] for rep in reports)
            for run, name in (("ring", "flash_attention_block"),
                              ("ulysses", "flash_attention"))}


# ---------------------------------------------------------------------------
# phase 10: the objective family (regression, multiclass, lambdarank)
# ---------------------------------------------------------------------------

def covertype_like(rows: int, seed: int = 0):
    """Covertype-shaped synthetic table: ``COVTYPE_NUMERIC`` standard-normal
    float32 columns, then one-hot wilderness (4) and soil (40) columns, and
    one of ``COVTYPE_CLASSES`` classes: the argmax of a random linear score
    of all 54 columns plus noise."""
    rng = np.random.default_rng(seed)
    width = COVTYPE_NUMERIC + COVTYPE_WILD + COVTYPE_SOIL
    X = np.zeros((rows, width), np.float32)
    X[:, :COVTYPE_NUMERIC] = rng.standard_normal(
        (rows, COVTYPE_NUMERIC), dtype=np.float32)
    at = np.arange(rows)
    X[at, COVTYPE_NUMERIC + rng.integers(0, COVTYPE_WILD, rows)] = 1.0
    X[at, COVTYPE_NUMERIC + COVTYPE_WILD
      + rng.integers(0, COVTYPE_SOIL, rows)] = 1.0
    W = rng.standard_normal((width, COVTYPE_CLASSES), dtype=np.float32)
    score = X @ W + 0.5 * rng.standard_normal((rows, COVTYPE_CLASSES),
                                              dtype=np.float32)
    return X, np.argmax(score, axis=1).astype(np.float32)


def mslr_group_sizes(queries: int, seed: int = 0) -> np.ndarray:
    """MSLR-WEB10K-shaped documents per query: lognormal with a mean of
    about 120, the tail clipped at ``MSLR_MAX_GROUP``."""
    rng = np.random.default_rng(seed)
    sizes = np.rint(rng.lognormal(np.log(90.0), 0.75, queries))
    return np.clip(sizes, 1, MSLR_MAX_GROUP).astype(np.int64)


def mslr_like(queries: int, seed: int = 0):
    """MSLR-WEB10K-shaped synthetic table, group-contiguous: (X (n, 136)
    float32, relevance labels 0-4, mostly 0, the query id of each row, the
    group sizes)."""
    sizes = mslr_group_sizes(queries, seed)
    n = int(sizes.sum())
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((n, MSLR_FEATURES), dtype=np.float32)
    rel = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.standard_normal(
        n, dtype=np.float32)
    y = np.digitize(rel, [0.3, 1.3, 2.2, 2.8]).astype(np.float32)
    return X, y, np.repeat(np.arange(queries), sizes), sizes


def regression_label(objective: str, margin: np.ndarray) -> np.ndarray:
    """A label in ``objective``'s own domain from a HIGGS margin: positive
    for gamma (in (0.22, 4.5)), non-negative counts with about half zeros
    for poisson and tweedie (0-4), in [0, 1] for cross_entropy, the margin
    itself otherwise. The exp-family labels go through tanh: the margin's
    product term has tails past +-10, and exp of those makes labels whose
    first leaves overflow the log link."""
    u = np.tanh(margin / 2.0)
    if objective in ("poisson", "tweedie"):
        return np.floor(np.exp(1.5 * u)).astype(np.float32)
    if objective == "gamma":
        return np.exp(1.5 * u).astype(np.float32)
    if objective == "cross_entropy":
        return (1.0 / (1.0 + np.exp(-2.0 * margin))).astype(np.float32)
    return margin.astype(np.float32)


def family_fit(label: str, est, table, rows: int, kernels, dev: str):
    """``est.fit(table)`` with the launch counts zeroed just before and read
    just after (every kernel of ``kernels`` must have launched); logs fit
    seconds, rows x iterations per second, the fit's spans and peak device
    memory."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    _peak_gib(dev, reset=True)
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    model = est.fit(table)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    iters = model.getBoosterNumTotalIterations()
    log(f"  {label}: fit_s={fit_s:.3f} row_iterations/s="
        f"{rows * iters / fit_s:.0f} trees={model.getBoosterNumTotalModel()}"
        f" peak device memory={_peak_gib(dev):.3f} GiB launches "
        f"{json.dumps(launches)}")
    spans = {k: round(v, 4)
             for k, v in model.booster.metadata["measures"].items()}
    log(f"  {label}: fit spans {json.dumps(spans)}")
    _check_launches(launches, kernels)
    return model


def _save_reload_gap(model, X, want, dev: str) -> float:
    """Max |reloaded - fitted| prediction over the first 10,000 rows after
    ``saveNativeModel`` and a reload of the model string."""
    from synapseml_tpu_torch.gbdt.boosting import Booster

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.txt"
        model.saveNativeModel(str(path))
        reloaded = Booster.from_model_string(path.read_text(), device=dev)
    return float(np.abs(reloaded.predict(X[:10_000]) - want[:10_000]).max())


def _numeric_baseline(booster, fit_s: float, events: dict) -> dict:
    """Phase 14's yardstick from a phase-10 Covertype fit: the booster,
    fit seconds, host syncs per tree and histogram kernel ms per iteration
    (CUDA events; 0 off the card)."""
    iters = booster.num_trees // max(booster.models_per_iter, 1)
    return dict(booster=booster, fit_s=fit_s,
                syncs_per_tree=booster.metadata["host_syncs"]
                / booster.num_trees,
                kernel_ms=sum(timed_ms(events).values()) / max(iters, 1))


def family_full_width(rows: int, dev: str) -> dict:
    """The regressor on the HIGGS-shaped table, the 7-class classifier on
    the Covertype-shaped one (then once more depthwise through
    ``train_booster``) and the ranker on the MSLR-shaped one. Returns the
    Covertype fits' ``_numeric_baseline`` by policy."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt.objectives import (lambdarank_objective,
                                                     make_grouped, ndcg_at_k)
    from synapseml_tpu_torch.models import (LightGBMClassifier,
                                            LightGBMRanker, LightGBMRegressor)
    from synapseml_tpu_torch.ops import hist_kernel as hk

    common = dict(numIterations=FAMILY_ITERS, numLeaves=31, maxBin=255,
                  device=dev)
    X, margin = higgs_margin(rows, seed=2)
    table = table_of(X, margin)
    model = family_fit(
        f"LightGBMRegressor(objective='regression') {rows} x {FEATURES}",
        LightGBMRegressor(objective="regression", **common), table, rows,
        MAIN_KERNELS, dev)
    pred = model.transform(table)["prediction"]
    gap = _save_reload_gap(model, X, pred, dev)
    rmse = float(np.sqrt(np.mean((pred - margin) ** 2)))
    log(f"  regression: rmse={rmse:.5f} (label std {margin.std():.5f}), "
        f"reload max |diff|={gap:.3g}")
    if pred.shape != (rows,) or not np.isfinite(pred).all() \
            or gap > 1e-5 or not rmse < 0.95 * margin.std():
        raise AssertionError("the regressor's fit, transform or reload is "
                             "wrong")
    del X, margin, table, model, pred

    X, y = covertype_like(COVTYPE_ROWS)
    table = table_of(X, y)
    t0 = time.perf_counter()
    with kernel_timer(dev) as events:
        model = family_fit(
            f"LightGBMClassifier {COVTYPE_CLASSES} classes {COVTYPE_ROWS} x "
            f"{X.shape[1]}", LightGBMClassifier(**common), table,
            COVTYPE_ROWS, MAIN_KERNELS, dev)
    baselines = {"leafwise": _numeric_baseline(
        model.booster, time.perf_counter() - t0, events)}
    out = model.transform(table)
    prob = out["probability"]
    acc = float((out["prediction"] == y).mean())
    gap = _save_reload_gap(model, X, prob, dev)
    base = float(np.bincount(y.astype(np.int64)).max() / len(y))
    log(f"  multiclass: train accuracy={acc:.4f} (largest class "
        f"{base:.4f}), reload max |diff|={gap:.3g}")
    if prob.shape != (COVTYPE_ROWS, COVTYPE_CLASSES) \
            or model.getBoosterNumTotalModel() != FAMILY_ITERS \
            * COVTYPE_CLASSES or not np.allclose(prob.sum(1), 1.0, atol=1e-5) \
            or gap > 1e-5 or not acc > base + 0.1:
        raise AssertionError("the multiclass classifier's fit, transform or "
                             "reload is wrong")
    del model, out, prob, table
    cfg = BoosterConfig(objective="multiclass", num_class=COVTYPE_CLASSES,
                        growth_policy="depthwise",
                        num_iterations=FAMILY_ITERS, num_leaves=31,
                        max_bin=255)
    _peak_gib(dev, reset=True)
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    with kernel_timer(dev) as events:
        booster = train_booster(X, y, cfg, device=dev)
        _sync(dev)
    fit_s = time.perf_counter() - t0
    baselines["depthwise"] = _numeric_baseline(booster, fit_s, events)
    launches = dict(hk.LAUNCHES)
    acc_d = float((np.argmax(booster.predict(X), 1) == y).mean())
    spans = {k: round(v, 4) for k, v in booster.metadata["measures"].items()}
    log(f"  multiclass depthwise train_booster: fit_s={fit_s:.3f} "
        f"row_iterations/s={COVTYPE_ROWS * FAMILY_ITERS / fit_s:.0f} "
        f"trees={booster.num_trees} peak device memory={_peak_gib(dev):.3f}"
        f" GiB train accuracy={acc_d:.4f} launches {json.dumps(launches)}"
        f" fit spans {json.dumps(spans)}")
    _check_launches(launches, DEPTHWISE_KERNELS)
    if booster.num_trees != FAMILY_ITERS * COVTYPE_CLASSES \
            or not acc_d > base + 0.1:
        raise AssertionError("the depthwise multiclass fit is wrong")
    del X, y, booster

    t0 = time.perf_counter()
    X, y, query, sizes = mslr_like(MSLR_QUERIES)
    n = len(y)
    table = table_of(X, y).with_column("query", query)
    log(f"  MSLR-shaped table: {MSLR_QUERIES} queries, {n} rows x "
        f"{MSLR_FEATURES}, groups mean {sizes.mean():.1f} max {sizes.max()}"
        f", made in {time.perf_counter() - t0:.1f}s")
    model = family_fit(
        f"LightGBMRanker(maxPosition=20) {n} x {MSLR_FEATURES}",
        LightGBMRanker(maxPosition=20, groupCol="query", **common), table,
        n, MAIN_KERNELS, dev)
    pred = model.transform(table)["prediction"]
    gi = make_grouped(y, sizes)
    yt = torch.as_tensor(y, device=dev)
    ndcg = float(ndcg_at_k(yt, torch.as_tensor(pred, device=dev), gi, 10))
    rnd = np.random.default_rng(5).standard_normal(n, dtype=np.float32)
    ndcg0 = float(ndcg_at_k(yt, torch.as_tensor(rnd, device=dev), gi, 10))
    gap = _save_reload_gap(model, X, pred, dev)
    log(f"  ranker: train NDCG@10={ndcg:.4f} (random scores {ndcg0:.4f}), "
        f"reload max |diff|={gap:.3g}")
    if not np.isfinite(pred).all() or gap > 1e-5 or not ndcg > ndcg0 + 0.1:
        raise AssertionError("the ranker's fit, transform or reload is "
                             "wrong")
    # one iteration's lambdarank gradients at this shape, alone
    cfg = model.booster.config
    obj = lambdarank_objective(gi, cfg.sigmoid,
                               cfg.lambdarank_truncation_level,
                               cfg.label_gain)
    w = torch.ones(n, device=dev)
    for what, score in (("equal scores (iteration 0)",
                         torch.zeros(n, device=dev)),
                        ("the fit's scores", torch.as_tensor(pred,
                                                             device=dev))):
        _peak_gib(dev, reset=True)
        ms = time_ms(lambda: obj.grad_hess(score, yt, w), 3)
        log(f"  lambdarank gradients, {what}: {ms:.3f} ms per iteration, "
            f"peak device memory {_peak_gib(dev):.3f} GiB")
    return baselines


FAMILY_CROSS_WORKERS = 4


def family_case(index: int, rows: int) -> tuple:
    """(label, estimator class, params, table) of the cross-check's case
    ``index``: the regression objectives, the two multiclass ones, the
    ranker, each on its own seeded table of ``rows`` rows."""
    from synapseml_tpu_torch.models import (LightGBMClassifier,
                                            LightGBMRanker, LightGBMRegressor)

    nreg = len(REGRESSION_OBJECTIVES)
    if index < nreg:
        o = REGRESSION_OBJECTIVES[index]
        X, margin = higgs_margin(rows, seed=3)
        return (f"regressor {o}", LightGBMRegressor, dict(objective=o),
                table_of(X, regression_label(o, margin)))
    if index < nreg + 2:
        o = ("multiclass", "multiclassova")[index - nreg]
        Xc, yc = covertype_like(rows, seed=3)
        return (f"classifier {o}", LightGBMClassifier, dict(objective=o),
                table_of(Xc, yc))
    Xr, yr, query, _ = mslr_like(rows // 120, seed=3)
    return ("ranker lambdarank", LightGBMRanker,
            dict(maxPosition=20, groupCol="query"),
            table_of(Xr, yr).with_column("query", query))


FAMILY_CASES = len(REGRESSION_OBJECTIVES) + 3


def family_fits(indices, rows: int, it: int, dev: str,
                threads: int = 0) -> list:
    """(label, predictions, classes or None, seconds) of each case of
    ``indices`` fitted and transformed on ``dev`` (``threads``: intra-op
    threads, 0 keeps them); classes for the classifiers only."""
    from synapseml_tpu_torch.models import LightGBMClassifier

    if threads:
        torch.set_num_threads(threads)
    out = []
    for index in indices:
        label, cls, params, table = family_case(index, rows)
        t0 = time.perf_counter()
        res = cls(numIterations=it, numLeaves=31, maxBin=255, device=dev,
                  **params).fit(table).transform(table)
        key = "probability" if "probability" in res else "prediction"
        out.append((label, np.asarray(res[key], np.float64),
                    np.asarray(res["prediction"])
                    if cls is LightGBMClassifier else None,
                    time.perf_counter() - t0))
    return out


def start_family_cpu():
    """The cross-check's CPU fits, started in ``FAMILY_CROSS_WORKERS``
    spawned processes (cases dealt round-robin, one intra-op thread each)
    so that they run beside the card's work: (pool, futures)."""
    from concurrent.futures import ProcessPoolExecutor

    ctx = torch.multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(max_workers=FAMILY_CROSS_WORKERS,
                               mp_context=ctx)
    futures = [pool.submit(family_fits, range(w, FAMILY_CASES,
                                              FAMILY_CROSS_WORKERS),
                           FAMILY_CROSS_ROWS, FAMILY_CROSS_ITERS, "cpu", 1)
               for w in range(FAMILY_CROSS_WORKERS)]
    return pool, futures


def family_cross_check(dev: str, cpu=None) -> None:
    """Every objective at ``FAMILY_CROSS_ROWS`` rows for
    ``FAMILY_CROSS_ITERS`` iterations on the card and on the CPU; ``cpu``
    is ``start_family_cpu()``'s, started earlier (else started here). The
    pool is shut down before the phase goes on."""
    pool, futures = cpu or start_family_cpu()
    try:
        card = family_fits(range(FAMILY_CASES), FAMILY_CROSS_ROWS,
                           FAMILY_CROSS_ITERS, dev)
        cpu_fits = [None] * FAMILY_CASES
        for w, f in enumerate(futures):
            for index, fit in zip(range(w, FAMILY_CASES,
                                        FAMILY_CROSS_WORKERS), f.result()):
                cpu_fits[index] = fit
    finally:
        pool.shutdown()
    for (label, pd, cd, td), (_, pc, cc, tc) in zip(card, cpu_fits):
        gap = float(np.abs(pd - pc).mean())
        scale = float(np.abs(pc).mean())
        agree = float((cd == cc).mean()) if cc is not None else 1.0
        ok = gap <= FAMILY_REL_TOL * scale and agree >= CLASS_AGREEMENT
        log(f"  {label}: fit+transform {td:.2f}s {dev}, {tc:.2f}s cpu; mean"
            f" |pred diff|={gap:.3g} (bound {FAMILY_REL_TOL * scale:.3g}), "
            f"classes agree {agree:.4%} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{label}: card and CPU fits disagree")


# ---------------------------------------------------------------------------
# phase 11: DeepVisionClassifier fine-tunes ResNet-50
# ---------------------------------------------------------------------------

def cifar_like(n: int, seed: int = 0):
    """CIFAR-10-shaped synthetic images (no data is read): ``n`` uint8
    32x32x3 images of ``VISION_CLASSES`` balanced classes in random order,
    each its class's mean colour plus Gaussian noise (std 40), and the
    int64 labels."""
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(n) % VISION_CLASSES)
    colours = rng.uniform(48, 208, size=(VISION_CLASSES, 3))
    side = VISION_SIDE
    imgs = colours[y][:, None, None, :] + rng.normal(
        0, 40, size=(n, side, side, 3))
    return np.clip(np.rint(imgs), 0, 255).astype(np.uint8), y


def vision_layer_flops(model, image_shape, dev: str) -> list:
    """``[(module name, FLOPs)]`` of one image's forward through each
    convolution and dense layer, in call order: 2 x multiply-adds from the
    shapes each layer sees in one batch-1 forward under hooks (kernel
    ``(kh, kw, in, out)`` over ``Ho x Wo`` outputs; dense ``in x out``).
    BatchNorm, relu, pooling and the residual adds are not counted."""
    from synapseml_tpu_torch.dl.layers import Conv, DenseGeneral

    out, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            hooks.append(mod.register_forward_hook(
                lambda m, i, y, name=name: out.append(
                    (name, 2 * y.shape[1] * y.shape[2] * m.kernel.numel()))))
        elif isinstance(mod, DenseGeneral):
            hooks.append(mod.register_forward_hook(
                lambda m, i, y, name=name: out.append(
                    (name, 2 * m.kernel.numel()))))
    try:
        with torch.no_grad():
            model(torch.zeros((1,) + tuple(image_shape), device=dev),
                  train=False)
    finally:
        for h in hooks:
            h.remove()
    return out


def vision_step_flops(layer_flops: list, batch: int) -> int:
    """FLOPs of one training step on ``batch`` images: every layer's
    forward, its weight gradient (frozen leaves' too: the optimizer masks
    them after the backward, as the JAX package's does) and its input
    gradient, but for the first layer, whose input needs none."""
    total = sum(f for _, f in layer_flops)
    return batch * (3 * total - layer_flops[0][1])


def vision_bound_ms(flops: float, precision: str) -> float:
    """Least milliseconds on an H100 for ``flops``: float32 over 67 TFLOP/s
    (``core/device.py`` turns TF32 off, so the tensor cores take no float32
    work), bf16 over 989 TFLOP/s."""
    rate = BF16_OPS_PER_S if precision == "bfloat16" else F32_OPS_PER_S
    return flops / rate * 1e3


def vision_init_state(small_images: bool = False) -> dict:
    """The parameters and statistics ``DeepVisionClassifier`` starts from
    (``Trainer.init`` draws them on the CPU from seed 0)."""
    from synapseml_tpu_torch.dl import make_backbone
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    model = make_backbone(VISION_BACKBONE, VISION_CLASSES,
                          small_images=small_images)
    Trainer(model, TrainConfig(seed=0), device="cpu").init()
    return {k: v.clone() for k, v in model.state_dict().items()}


def check_frozen(label: str, net, init: dict, k: int) -> None:
    """After a fit with ``additionalLayersToTrain=k``: the stem and every
    block but the last ``k`` (none with k = -1) bitwise unchanged, every
    other parameter tensor changed; the frozen blocks' BatchNorm statistics
    moved all the same."""
    blocks = net.blocks
    frozen = set() if k < 0 else {"stem_conv", "stem_bn",
                                  *blocks[:len(blocks) - k]}
    bad = []
    for name, p in net.named_parameters():
        same = torch.equal(p.detach().cpu(), init[name])
        if same != (name.split(".")[0] in frozen):
            bad.append(name)
    moved = [name for name, b in net.named_buffers()
             if name.split(".")[0] in frozen
             and not torch.equal(b.detach().cpu(), init[name])]
    n_stats = sum(1 for name, _ in net.named_buffers()
                  if name.split(".")[0] in frozen)
    log(f"  {label}: {len(frozen)} frozen top-level modules "
        f"{sorted(frozen, key=lambda t: (len(t), t))[:3]}... bitwise "
        f"unchanged, every other parameter tensor changed: "
        f"{'ok' if not bad else 'WRONG ' + str(bad[:5])}; frozen "
        f"statistics moved {len(moved)}/{n_stats}")
    if bad or len(moved) != n_stats:
        raise AssertionError(f"{label}: frozen/trainable parameters wrong")


def vision_fit(label: str, params: dict, n: int, dev: str,
               layer_flops: list, seed: int):
    """One ``DeepVisionClassifier`` fit at ``VISION_SIZE`` (host resize of
    ``cifar_like`` images) and its ``transform``; logs host preprocessing
    seconds, steady images/s over steps 2..n with the step's forward,
    backward, all-reduce and update seconds, peak memory, transform
    images/s, and the step's FLOPs beside their bound. Returns the model,
    its images and its probabilities."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.dl import vision as tv

    imgs, y = cifar_like(n, seed)
    t0 = time.perf_counter()
    tv._normalize(tv._resolve_images(imgs, VISION_SIZE))
    prep_s = time.perf_counter() - t0
    est = tv.DeepVisionClassifier(backbone=VISION_BACKBONE,
                                  imageSize=VISION_SIZE, maxEpochs=1,
                                  learningRate=1e-3, optimizer="adam",
                                  seed=0, device=dev, **params)
    _peak_gib(dev, reset=True)
    _sync(dev)
    t0 = time.perf_counter()
    model = est.fit(Table({"image": imgs, "label": y}))
    _sync(dev)
    fit_s = time.perf_counter() - t0
    peak = _peak_gib(dev)
    steps = model.trainer.step_stats
    losses = [st["loss"] for st in steps]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    bs, precision = est.getBatchSize(), est.getPrecision()
    split = {k: float(np.mean([st[k] for st in steps[1:]]))
             for k in ("forward_s", "backward_s", "allreduce_s",
                       "update_s")}
    step_s = sum(split.values())
    flops = vision_step_flops(layer_flops, bs)
    bound = vision_bound_ms(flops, precision)
    log(f"  {label}: {n} images, batch {bs}, {len(steps)} steps, "
        f"{precision}: host preprocessing {prep_s:.3f}s (resize "
        f"{VISION_SIDE}->{VISION_SIZE} + normalise, timed alone), fit "
        f"{fit_s:.3f}s, losses first {losses[0]:.4f} last {losses[-1]:.4f}")
    log(f"  {label}: steady step (steps 2..{len(steps)}) {step_s * 1e3:.2f} "
        f"ms = {json.dumps({k: round(v * 1e3, 3) for k, v in split.items()})}"
        f" ms -> {bs / step_s:.1f} images/s; peak device memory "
        f"{peak:.3f} GiB")
    log(f"  {label}: step FLOPs {flops:.4e} (convolutions and dense layers, "
        f"forward + both gradients) -> bound {bound:.3f} ms at "
        f"{'989' if precision == 'bfloat16' else '67'} TFLOP/s, "
        f"{bound / (step_s * 1e3):.1%} of it reached")
    table = Table({"image": imgs})
    _sync(dev)
    t0 = time.perf_counter()
    prob = np.asarray(model.transform(table)["probability"])
    _sync(dev)
    tr_s = time.perf_counter() - t0
    acc = float((prob.argmax(-1) == y).mean())
    log(f"  {label}: transform {tr_s:.3f}s -> {n / tr_s:.1f} images/s "
        f"(host resize included), train-set accuracy {acc:.3f}")
    return model, table, prob


def vision_reload(model, table, prob, dev: str) -> None:
    """``save``, ``load`` and ``transform`` again: within 1e-6 of the first
    transform (the same weights through the same kernels)."""
    from synapseml_tpu_torch.core import PipelineStage

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "vision_model")
        model.save(path)
        loaded = PipelineStage.load(path)
        again = np.asarray(loaded.transform(table)["probability"])
    gap = float(np.abs(again - prob).max())
    log(f"  reload: max |probability gap| {gap:.3g} (bound "
        f"{VISION_RELOAD_TOL}, device {loaded.getDevice()}) -> "
        f"{'ok' if gap <= VISION_RELOAD_TOL else 'MISMATCH'}")
    if gap > VISION_RELOAD_TOL or loaded.getDevice() != dev:
        raise AssertionError("vision model reload changed its output")


def vision_profile(model, dev: str) -> None:
    """Three more steps of a fitted model's configuration in the warmed
    process under torch.profiler (CUPTI): wall, device busy share and the
    device time by the PyTorch op that launched it. On the card only."""
    if not _on_card(dev):
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.dl import vision as tv

    tr = model.trainer
    imgs, y = cifar_like(3 * tr.cfg.batch_size, seed=7)
    X = tv._normalize(tv._resolve_images(imgs, VISION_SIZE))
    tr.step_stats = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.fit(X, y)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3
    if not busy:
        log("  profiler recorded no device time: not measured")
        return
    steps_ms = 1e3 * sum(st[k] for st in tr.step_stats
                         for k in ("forward_s", "backward_s", "allreduce_s",
                                   "update_s"))
    log(f"  profiled fit of 3 steps: wall {wall_ms:.1f} ms (steps "
        f"{steps_ms:.1f} ms), device busy {busy:.1f} ms, idle "
        f"{1 - busy / wall_ms:.1%} of wall; device time by op:")
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in avg if e.self_device_time_total > 0
                  and e.device_type == DeviceType.CPU), reverse=True)
    for ms, count, key in ops[:12]:
        log(f"    {ms:9.3f} ms {ms / busy:6.1%} {count:6d}x  {key[:70]}")


def vision_fixed_batch(dev: str) -> None:
    """``VISION_OVERFIT_STEPS`` adam steps on one batch of 16 images at
    ``VISION_SIZE``: the last step's loss must fall below the first's (a
    broken backward leaves it where it is)."""
    from synapseml_tpu_torch.dl import make_backbone
    from synapseml_tpu_torch.dl import vision as tv
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    imgs, y = cifar_like(16, seed=4)
    X = tv._normalize(tv._resolve_images(imgs, VISION_SIZE))
    cfg = TrainConfig(batch_size=16, max_epochs=VISION_OVERFIT_STEPS,
                      learning_rate=1e-3, optimizer="adam", seed=0)
    tr = Trainer(make_backbone(VISION_BACKBONE, VISION_CLASSES), cfg,
                 device=dev).init()
    tr.fit(X, y)
    losses = [round(st["loss"], 5) for st in tr.step_stats]
    ok = losses[-1] < losses[0]
    log(f"  one fixed batch, {VISION_OVERFIT_STEPS} steps: losses {losses}"
        f" -> {'ok' if ok else 'NOT LOWER'}")
    if not ok:
        raise AssertionError("training steps did not lower a fixed batch's "
                             "loss")


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def vision_cross_check(dev: str, trained: dict) -> None:
    """Card against CPU on the same ``state_dict``: ResNet-50 with
    ``smallImages=True`` at 32x32, batch 8, from the estimator's initial
    state: eval logits, two momentum steps' losses, every BatchNorm's
    running statistics and the eval logits after the steps; the ImageNet
    stem at ``VISION_SIZE``, batch 2, eval logits of ``trained`` (fit A's
    parameters and statistics)."""
    from synapseml_tpu_torch.dl import make_backbone
    from synapseml_tpu_torch.dl import vision as tv
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    imgs, y = cifar_like(16, seed=5)
    X = tv._normalize(tv._resolve_images(imgs, None))
    state = vision_init_state(small_images=True)
    res = {}
    for d in (dev, "cpu"):
        cfg = TrainConfig(batch_size=8, max_epochs=1, learning_rate=0.01,
                          optimizer="momentum", seed=0)
        tr = Trainer(make_backbone(VISION_BACKBONE, VISION_CLASSES,
                                   small_images=True), cfg, device=d)
        tr.load_params(state)
        t0 = time.perf_counter()
        before = tr.predict_logits(X[:8])
        tr.fit(X, y)
        res[d] = (before, [st["loss"] for st in tr.step_stats],
                  {n: b.detach().cpu().numpy()
                   for n, b in tr.model.named_buffers()},
                  tr.predict_logits(X[8:]))
        log(f"  smallImages 32x32 {d}: eval + 2 steps + eval "
            f"{time.perf_counter() - t0:.2f}s, losses {res[d][1]}")
    (lg, ls, st, ag), (lw, lsw, stw, aw) = res[dev], res["cpu"]
    loss_gap = float(np.max(np.abs(np.subtract(ls, lsw)) / np.abs(lsw)))
    big = make_backbone(VISION_BACKBONE, VISION_CLASSES)
    big.load_state_dict(trained)
    imgs2, _ = cifar_like(2, seed=6)
    X2 = torch.from_numpy(tv._normalize(tv._resolve_images(imgs2,
                                                           VISION_SIZE)))
    with torch.no_grad():
        want = big.eval()(X2, train=False).numpy()
        got = big.to(dev)(X2.to(dev), train=False).cpu().numpy()
    checks = [("small-stem eval logits", _gap(lg, lw), VISION_LOGIT_TOL),
              ("small-stem step losses (relative)", loss_gap,
               VISION_LOSS_RTOL),
              ("small-stem running statistics",
               max(_gap(st[n], stw[n]) for n in stw), VISION_STAT_TOL),
              ("small-stem eval logits after the steps", _gap(ag, aw),
               VISION_LOGIT_TOL),
              (f"ImageNet stem {VISION_SIZE}x{VISION_SIZE} eval logits "
               "(fit A's weights)", _gap(got, want), VISION_LOGIT_TOL)]
    for name, gap, tol in checks:
        log(f"  card vs CPU, {name}: {gap:.3g} (bound {tol}) -> "
            f"{'ok' if gap <= tol else 'MISMATCH'}")
    if any(gap > tol for _, gap, tol in checks):
        raise AssertionError("vision path: card and CPU disagree")


def vision_path(dev: str) -> None:
    """Phase 11: fits A (float32, two trailing blocks trained) and B (bf16,
    everything trained) with their checks, the fixed-batch check and the
    card-vs-CPU check."""
    from synapseml_tpu_torch.dl import make_backbone

    init = vision_init_state()
    flops = vision_layer_flops(
        make_backbone(VISION_BACKBONE, VISION_CLASSES).to(dev),
        (VISION_SIZE, VISION_SIZE, 3), dev)
    log(f"  {VISION_BACKBONE} at {VISION_SIZE}x{VISION_SIZE}: "
        f"{len(flops)} convolution/dense layers, forward "
        f"{sum(f for _, f in flops):.4e} FLOPs per image")
    trained = None
    for i, (label, params, n) in enumerate(VISION_FITS):
        model, table, prob = vision_fit(label, params, n, dev, flops, i)
        net = model.trainer.model
        check_frozen(label, net, init, params["additionalLayersToTrain"])
        if trained is None:
            trained = {k: v.detach().cpu().clone()
                       for k, v in net.state_dict().items()}
            vision_reload(model, table, prob, dev)
        vision_profile(model, dev)
        del model, net
        if _on_card(dev):
            torch.cuda.empty_cache()
    vision_fixed_batch(dev)
    vision_cross_check(dev, trained)


# ---------------------------------------------------------------------------
# phase 12: validation, early stopping, warm start, fobj, resume, leaf
# indices, SHAP and the JSON dump
# ---------------------------------------------------------------------------

def surface_split(rows: int) -> int:
    """Validation rows flagged at the end of the ``rows`` table: HIGGS's
    published split keeps its last 500,000 of 11,000,000 rows as the test
    set; a smaller table keeps a quarter."""
    return min(SURFACE_VALID_ROWS, rows // 4)


def _valid_auc(booster, Xv, yv, dev: str, num_iteration: int = -1) -> float:
    from synapseml_tpu_torch.gbdt.objectives import auc

    prob = booster.predict(Xv, num_iteration=num_iteration)
    return float(auc(torch.as_tensor(yv, device=dev),
                     torch.as_tensor(prob, device=dev)))


def check_early_stop(label: str, booster, Xv, yv, dev: str,
                     num_iterations: int) -> dict:
    """Log and check one early-stopped fit: the trees end at the best
    iteration if it stopped, else the best is the first maximum of the
    logged series; ``best_score`` is the AUC of the cut forest."""
    series = np.asarray(booster.metadata["valid_metric"]["values"])
    best, ran = booster.best_iteration, len(series)
    stopped = ran < num_iterations
    if stopped:
        if booster.num_trees != best + 1 or ran - 1 - best != SURFACE_ESR:
            raise AssertionError(
                f"{label}: stopped after {ran} iterations with best {best} "
                f"but kept {booster.num_trees} trees")
    elif best != int(np.argmax(series)):
        raise AssertionError(f"{label}: best {best} is not the first "
                             f"maximum {int(np.argmax(series))}")
    again = _valid_auc(booster, Xv, yv, dev, num_iteration=best + 1)
    gap = abs(again - booster.best_score)
    log(f"  {label}: iterations run {ran} ({'stopped' if stopped else 'no stop'}"
        f"), best_iteration={best} best_score={booster.best_score!r} AUC of "
        f"raw_score(num_iteration=best+1)={again!r} |gap|={gap:.3g}; AUC "
        f"series first/last {series[0]:.6f}/{series[-1]:.6f}")
    if gap > SURFACE_SCORE_TOL:
        raise AssertionError(f"{label}: best_score is {gap} from the AUC of "
                             "the forest it names")
    return dict(iterations=ran, stopped=stopped, best=best)


def surface_fits(X, y, dev: str) -> dict:
    """Steps 1 and 2: the classifier (leaf-wise) and depthwise
    ``train_booster`` with validation and early stopping on the ``--rows``
    table, launch counts zeroed just before each fit and read just after."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk

    rows = X.shape[0]
    nv = surface_split(rows)
    is_val = np.zeros(rows, bool)
    is_val[rows - nv:] = True
    t = table_of(X, y).with_column("isVal", is_val)
    Xv, yv = X[rows - nv:], y[rows - nv:]
    out = {}
    for label, policy in (("leaf-wise classifier", "leafwise"),
                          ("depthwise train_booster", "depthwise")):
        _peak_gib(dev, reset=True)
        hk.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        if policy == "leafwise":
            model = LightGBMClassifier(
                numIterations=SURFACE_ITERS, learningRate=0.1, numLeaves=31,
                maxBin=255, earlyStoppingRound=SURFACE_ESR, metric="auc",
                validationIndicatorCol="isVal", device=dev).fit(t)
            booster = model.booster
        else:
            booster = train_booster(
                X[:rows - nv], y[:rows - nv], BoosterConfig(
                    objective="binary", num_iterations=SURFACE_ITERS,
                    learning_rate=0.1, num_leaves=31, max_bin=255,
                    early_stopping_round=SURFACE_ESR, metric="auc",
                    growth_policy="depthwise"),
                valid=(Xv, yv), device=dev)
        _sync(dev)
        fit_s = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        grown = len(booster.metadata["valid_metric"]["values"])
        syncs = booster.metadata["host_syncs"]
        spans = booster.metadata["measures"]
        log(f"  {label}: fit_s={fit_s:.3f} on {rows - nv} rows + {nv} "
            f"validation rows, {grown} iterations "
            f"({fit_s / grown * 1e3:.1f} ms each), host_syncs={syncs} "
            f"host_syncs/tree={syncs / grown:.2f}, peak device memory="
            f"{_peak_gib(dev):.3f} GiB, launches {json.dumps(launches)}")
        log(f"  {label}: validation span {spans['validation']:.3f}s "
            f"({spans['validation'] / grown * 1e3:.2f} ms per iteration: "
            f"binned traversal of each tree and the AUC, host clock), "
            f"trainingIterations {spans['trainingIterations']:.3f}s, "
            f"referenceDataset {spans['referenceDataset']:.3f}s")
        _check_launches(launches, MAIN_KERNELS if policy == "leafwise"
                        else DEPTHWISE_KERNELS)
        out[policy] = dict(check_early_stop(label, booster, Xv, yv, dev,
                                            SURFACE_ITERS),
                           fit_s=fit_s, launches=launches, booster=booster)
        if policy == "leafwise":
            out["model"], out["table"] = model, t
    return out


def leaf_and_shap_check(model, X, nv: int, dev: str) -> None:
    """Steps 3 and 4: ``transform`` of the validation rows with
    ``leafPredictionCol``, and ``getFeatureShaps`` on ``SURFACE_SHAP_ROWS``
    of them."""
    from synapseml_tpu_torch.core import Table

    booster = model.booster
    Xv = X[X.shape[0] - nv:]
    T = booster.num_trees
    model.set("leafPredictionCol", "leaves")
    _sync(dev)
    t0 = time.perf_counter()
    out = model.transform(Table({"features": Xv}))
    _sync(dev)
    transform_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    leaves = booster.predict_leaf(Xv)
    leaf_s = time.perf_counter() - t0
    model.set("leafPredictionCol", None)
    col = out["leaves"]
    if col.shape != (nv, T) or not np.array_equal(col, leaves):
        raise AssertionError(f"leaf column shape {col.shape}, want {(nv, T)}")
    lv = torch.as_tensor(np.stack([np.asarray(tr.leaf_value, np.float32)
                                   for tr in booster.trees]), device=dev)
    idx = torch.as_tensor(leaves, dtype=torch.int64, device=dev)
    picked = lv[torch.arange(T, device=dev)[None, :], idx]       # (Nv, T)
    raw = booster.raw_score(Xv)
    summed = (picked.double().sum(1) + float(booster.base_score[0])).cpu().numpy()
    gap = float(np.abs(summed - raw).max() / np.abs(raw).max())
    log(f"  leafPredictionCol: transform of {nv} rows in {transform_s:.3f}s "
        f"(raw, probability and leaves), predict_leaf alone {leaf_s:.3f}s; "
        f"shape {col.shape}; leaf values summed vs raw_score "
        f"{gap:.3g} of max |raw|")
    if gap > SURFACE_LEAF_TOL:
        raise AssertionError(f"the leaves' values sum {gap} away from the "
                             "raw score")
    rows = Xv[:SURFACE_SHAP_ROWS]
    t0 = time.perf_counter()
    phi = model.getFeatureShaps(rows)
    shap_s = time.perf_counter() - t0
    raw = booster.raw_score(rows)
    gap = float(np.abs(phi.sum(1) - raw).max() / np.abs(raw).max())
    log(f"  getFeatureShaps: {len(rows)} rows x {T} trees in {shap_s:.3f}s "
        f"({len(rows) / shap_s:.1f} rows/s, host numpy), additivity "
        f"{gap:.3g} of max |raw|")
    if phi.shape != (len(rows), FEATURES + 1) or gap > SURFACE_SHAP_TOL:
        raise AssertionError(f"SHAP shape {phi.shape} or additivity {gap}")


def _dump_leaves(node: dict, out: dict) -> None:
    stack = [node]
    while stack:
        nd = stack.pop()
        if "leaf_index" in nd:
            out[nd["leaf_index"]] = nd["leaf_value"]
        else:
            stack += [nd["left_child"], nd["right_child"]]


def dump_check(model) -> None:
    """Step 5: ``dumpModel`` parses, holds every tree, and its leaf values
    (the base score folded into the first tree) match the booster's."""
    booster = model.booster
    t0 = time.perf_counter()
    text = model.dumpModel()
    dump_s = time.perf_counter() - t0
    doc = json.loads(text)
    trees = doc["tree_info"]
    if len(trees) != booster.num_trees:
        raise AssertionError(f"dump has {len(trees)} trees, the booster "
                             f"{booster.num_trees}")
    worst = 0.0
    for i, entry in enumerate(trees):
        got = {}
        _dump_leaves(entry["tree_structure"], got)
        lv = np.asarray(booster.trees[i].leaf_value, np.float64)
        shift = float(booster.base_score[0]) if i == 0 else 0.0
        for leaf, value in got.items():
            want = lv[leaf] + shift
            worst = max(worst, abs(value - want) / max(abs(want), 1e-30))
    log(f"  dumpModel: {len(text)} bytes, {len(trees)} trees in "
        f"{dump_s:.3f}s; leaf values within {worst:.3g} relative")
    if worst > SURFACE_DUMP_RTOL:
        raise AssertionError(f"dumped leaf values {worst} off")


def warm_start_check(model, table, dev: str) -> None:
    """Step 6: ``numBatches=2`` warm-started from step 1's model string,
    ``numIterations`` each: the first T trees are step 1's."""
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk

    first = model.booster
    T = first.num_trees
    train = table.filter(~np.asarray(table["isVal"], bool))
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    warm = LightGBMClassifier(
        numIterations=SURFACE_WARM_ITERS, learningRate=0.1, numLeaves=31,
        maxBin=255, numBatches=SURFACE_WARM_BATCHES,
        modelString=model.getNativeModel(), device=dev).fit(train)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    booster = warm.booster
    want = T + SURFACE_WARM_ITERS * SURFACE_WARM_BATCHES
    worst = 0.0
    for i in range(T):
        a, b = booster.trees[i], first.trees[i]
        ns = int(b.num_splits)
        same = (int(a.num_splits) == ns and all(
            np.array_equal(np.asarray(getattr(a, f))[:ns],
                           np.asarray(getattr(b, f))[:ns])
            for f in ("split_feature", "left_child", "right_child"))
            and np.array_equal(booster._thresholds(i)[:ns],
                               first._thresholds(i)[:ns]))
        if not same:
            raise AssertionError(f"warm-started tree {i} is not step 1's")
        # the model string folds the base score into the first tree
        shift = (float(first.base_score[0]) - float(booster.base_score[0])
                 if i == 0 else 0.0)
        la = np.asarray(a.leaf_value, np.float64)[:ns + 1]
        lb = np.asarray(b.leaf_value, np.float64)[:ns + 1] + shift
        worst = max(worst, float((np.abs(la - lb)
                                  / np.maximum(np.abs(lb), 1e-30)).max()))
    log(f"  warm start: {SURFACE_WARM_BATCHES} batches x "
        f"{SURFACE_WARM_ITERS} iterations from a {T}-tree model string in "
        f"{fit_s:.3f}s, {booster.num_trees} trees; the first {T} trees "
        f"equal in structure and thresholds, leaf values within {worst:.3g} "
        f"relative; launches {json.dumps(launches)}")
    if booster.num_trees != want or worst > SURFACE_DUMP_RTOL:
        raise AssertionError(f"warm start: {booster.num_trees} trees (want "
                             f"{want}), leaf values {worst} off")
    _check_launches(launches, MAIN_KERNELS)


def _torch_logistic(score, label, weight):
    p = torch.sigmoid(score)
    return (p - label) * weight, p * (1 - p) * weight


def fobj_and_resume_check(dev: str) -> None:
    """Steps 7 and 8 on ``SURFACE_SMALL_ROWS`` rows: a custom logistic
    objective against ``objective="binary"``, and a checkpointed fit
    stopped after iteration ``SURFACE_RESUME_AT`` and resumed."""
    from synapseml_tpu_torch.core.checkpoint import PreemptionError
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt.grower import trees_to_host
    from synapseml_tpu_torch.gbdt.objectives import auc
    from synapseml_tpu_torch.ops import hist_kernel as hk

    X, y = higgs_like(SURFACE_SMALL_ROWS, seed=2)
    cfg = BoosterConfig(objective="binary", num_iterations=SURFACE_SMALL_ITERS,
                        num_leaves=31, max_bin=255)

    def train_auc(booster):
        return float(auc(torch.as_tensor(y, device=dev),
                         torch.as_tensor(booster.predict(X), device=dev)))

    plain = train_booster(X, y, cfg, device=dev)
    hk.reset_launch_counts()
    custom = train_booster(X, y, cfg, fobj=_torch_logistic, device=dev)
    launches = dict(hk.LAUNCHES)
    a, b = train_auc(custom), train_auc(plain)
    log(f"  fobj: AUC {a:.6f} against objective='binary' {b:.6f} "
        f"(|gap| {abs(a - b):.3g}); launches {json.dumps(launches)}")
    _check_launches(launches, MAIN_KERNELS)
    if abs(a - b) > SURFACE_CURVE_TOL:
        raise AssertionError("the custom logistic objective fits another "
                             "model")
    saved = {}

    def keep(it, trees):
        if it == SURFACE_RESUME_AT - 1:
            saved["trees"] = trees_to_host(trees)

    def stop(it, trees):
        if it == SURFACE_RESUME_AT:
            raise PreemptionError(f"stopped after iteration {it}")

    with tempfile.TemporaryDirectory() as tmp:
        try:
            train_booster(X, y, cfg, device=dev, checkpoint_store=tmp,
                          checkpoint_every=2, callbacks=[keep, stop])
            raise AssertionError("the preempting callback did not stop the "
                                 "fit")
        except PreemptionError:
            pass
        t0 = time.perf_counter()
        resumed = train_booster(X, y, cfg, device=dev, checkpoint_store=tmp,
                                checkpoint_every=2)
        resume_s = time.perf_counter() - t0
    n_saved = len(saved["trees"])
    bitwise = all(
        np.array_equal(np.asarray(getattr(r, f)), np.asarray(getattr(s, f)))
        for r, s in zip(resumed.trees[:n_saved], saved["trees"])
        for f in r._fields)
    a = train_auc(resumed)
    log(f"  resume: {n_saved} trees restored "
        f"{'bitwise' if bitwise else 'NOT bitwise'}, "
        f"{resumed.num_trees - n_saved} regrown in {resume_s:.3f}s; AUC "
        f"{a:.6f} against the uninterrupted fit's {b:.6f}")
    if not bitwise or abs(a - b) > SURFACE_CURVE_TOL \
            or resumed.num_trees != SURFACE_SMALL_ITERS:
        raise AssertionError("resume lost or changed the saved trees")


def valid_curve_check(dev: str) -> None:
    """Step 9: a validation fit on the card and on the CPU; the
    per-iteration validation AUC within ``SURFACE_CURVE_TOL``."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    X, y = higgs_like(SURFACE_SMALL_ROWS, seed=3)
    nv = SURFACE_SMALL_ROWS // 5
    cfg = BoosterConfig(objective="binary", num_iterations=SURFACE_SMALL_ITERS,
                        num_leaves=31, max_bin=255, metric="auc")
    curves = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        booster = train_booster(X[:-nv], y[:-nv], cfg, valid=(X[-nv:],
                                                              y[-nv:]),
                                device=d)
        curves[d] = np.asarray(booster.metadata["valid_metric"]["values"])
        log(f"  validation curve on {d}: {time.perf_counter() - t0:.3f}s, "
            f"AUC {curves[d][0]:.6f} .. {curves[d][-1]:.6f}")
    gap = float(np.abs(curves[dev] - curves["cpu"]).max())
    log(f"  card against CPU: max |AUC gap| over {len(curves['cpu'])} "
        f"iterations {gap:.3g}")
    if gap > SURFACE_CURVE_TOL:
        raise AssertionError("card and CPU validation curves disagree")


def surface_path(rows: int, dev: str) -> dict:
    """Phase 12: every step above on the HIGGS-shaped ``rows`` table."""
    X, y = higgs_like(rows)
    fits = surface_fits(X, y, dev)
    model = fits["model"]
    leaf_and_shap_check(model, X, surface_split(rows), dev)
    dump_check(model)
    warm_start_check(model, fits["table"], dev)
    fobj_and_resume_check(dev)
    valid_curve_check(dev)
    fits["Xv"] = X[X.shape[0] - surface_split(rows):]
    return fits


# ---------------------------------------------------------------------------
# phase 13: sampling (bagging, GOSS, DART, RF, feature fractions) and
# monotone constraints
# ---------------------------------------------------------------------------

def _mode(label: str) -> tuple:
    """(estimator params, BoosterConfig fields) of mode ``label``."""
    return next((params, cfg) for name, params, cfg
                in SAMPLING_MODES + [PLAIN_MODE] if name == label)


def _mode_config(label: str) -> dict:
    return _mode(label)[1]


class _TimedLibrary:
    """The loaded histogram library with each launch bracketed by CUDA
    events on the current stream: ``events`` collects (start, end) pairs
    per C function."""

    def __init__(self, lib, events: dict):
        self._lib, self._events = lib, events

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._events:
            return fn

        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self._events[name].append((start, end))
            return rc

        return launch


@contextlib.contextmanager
def kernel_timer(dev: str):
    """Time every histogram kernel launched in the block: CUDA events just
    before and after each launch of the built library (``ops._build``
    hands the wrappers the library it holds). Yields {C function: [(start,
    end), ...]}; read them with ``timed_ms`` after a synchronise. Off the
    card nothing is timed (the lists stay empty)."""
    from synapseml_tpu_torch.ops import _build
    from synapseml_tpu_torch.ops import hist_kernel as hk

    events = {"child_histogram": [], "range_histogram": [],
              "level_histogram": []}
    if not _on_card(dev):
        yield events
        return
    lib = hk._lib()
    _build._LIBS["hist_kernel"] = _TimedLibrary(lib, events)
    try:
        yield events
    finally:
        _build._LIBS["hist_kernel"] = lib


def timed_ms(events: dict) -> dict:
    """{name: summed milliseconds} of ``kernel_timer``'s events."""
    return {name: sum(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in events.items()}


@contextlib.contextmanager
def captured_call(module, name: str, index: int = 0):
    """Wrap ``module.name`` for the block: the ``index``-th call's
    arguments are kept (tensors cloned: the growers partition theirs in
    place afterwards) in the yielded dict under ``"args"``."""
    real = getattr(module, name)
    calls, out = [0], {}

    def wrapper(*a, **k):
        if calls[0] == index:
            out["args"] = [x.clone() if isinstance(x, torch.Tensor) else x
                           for x in a]
        calls[0] += 1
        return real(*a, **k)

    setattr(module, name, wrapper)
    try:
        yield out
    finally:
        setattr(module, name, real)


def sampling_bitwise_check(rows: int, dev: str) -> None:
    """The draws on the card against the same draws on the CPU, bit for
    bit, at iterations ``SAMPLING_BITWISE_ITS``: threefry uniforms over
    ``rows`` rows, the bag under ``baggingFreq=5`` (carried between
    draws), GOSS's rows from the first iteration's gradients (two values:
    the stable order is all that separates ties), the feature permutation
    and mask, and every node mask of one 31-leaf tree."""
    from synapseml_tpu_torch.core import prng
    from synapseml_tpu_torch.gbdt import BoosterConfig
    from synapseml_tpu_torch.gbdt import boosting as gb
    from synapseml_tpu_torch.gbdt.grower import GrowerConfig, node_masks
    from synapseml_tpu_torch.ops.hist_kernel import features_padded

    _, y = higgs_like(rows)
    p = np.float32(1 / (1 + np.exp(-0.1)))
    g0 = (p - y).astype(np.float32)[None]
    h0 = np.full_like(g0, p * (1 - p))
    bag_cfg = BoosterConfig(objective="binary", **_mode_config("bagging"))
    goss_cfg = BoosterConfig(objective="binary", boosting_type="goss")
    FP = features_padded(FEATURES)
    draws = {}
    for d in (dev, "cpu"):
        _sync(dev)
        t0 = time.perf_counter()
        key0 = prng.prng_key(0)
        g, h = torch.as_tensor(g0).to(d), torch.as_tensor(h0).to(d)
        cur = torch.ones(rows, device=d)
        out = {}
        for it in range(max(SAMPLING_BITWISE_ITS) + 1):
            bag, _, _, cur = gb._sample_rows_impl(bag_cfg, rows, key0, it, g,
                                                  h, cur)
            if it not in SAMPLING_BITWISE_ITS:
                continue
            out[f"uniform it={it}"] = prng.uniform(
                prng.fold_in(key0, 20_000_000 + it), rows, d)
            out[f"bag it={it}"] = bag
            out[f"goss rows it={it}"] = gb._sample_rows_impl(
                goss_cfg, rows, key0, it, g, h, cur)[1]
            out[f"permutation it={it}"] = prng.permutation(
                prng.fold_in(key0, 10_000_000 + it), FEATURES, d)
            out[f"feature mask it={it}"] = gb._sample_features_impl(
                bag_cfg, FEATURES, key0, it, d)
        featp = torch.zeros(FP, dtype=torch.bool, device=d)
        featp[:FEATURES] = out[f"feature mask it={SAMPLING_BITWISE_ITS[-1]}"]
        out["node masks"] = node_masks(
            GrowerConfig(feature_fraction_bynode=0.5), featp,
            gb._node_key_data(key0, 3, 0), 31)
        _sync(dev)
        draws[d] = {k: v.cpu() for k, v in out.items()}
        log(f"  draws on {d}: {len(out)} tensors in "
            f"{time.perf_counter() - t0:.3f}s")
    bad = [k for k in draws["cpu"]
           if not torch.equal(draws[dev][k], draws["cpu"][k])]
    kept = int(draws[dev][f"bag it={SAMPLING_BITWISE_ITS[0]}"].sum())
    log(f"  card against CPU: {len(draws['cpu']) - len(bad)} of "
        f"{len(draws['cpu'])} draws bitwise equal (bag keeps {kept} of "
        f"{rows} rows); differing: {bad}")
    if bad:
        raise AssertionError(f"sampling differs between the card and the "
                             f"CPU: {bad}")


def sampling_table(rows: int):
    """Phase 12's table and split, and the bin mapper of its training rows
    (computed once and passed as ``referenceDataset``: the same bounds each
    fit would compute)."""
    from synapseml_tpu_torch.ops.quantize import compute_bin_mapper

    X, y = higgs_like(rows)
    nv = surface_split(rows)
    is_val = np.zeros(rows, bool)
    is_val[rows - nv:] = True
    t0 = time.perf_counter()
    mapper = compute_bin_mapper(X[:rows - nv], 255, 200_000, seed=0)
    log(f"  bin mapper of {rows - nv} training rows in "
        f"{time.perf_counter() - t0:.3f}s (shared by every fit)")
    return X, y, nv, table_of(X, y).with_column("isVal", is_val), mapper


def sampling_fit(label: str, X, y, nv: int, table, mapper, dev: str,
                 policy: str, plain_per_iter: dict) -> dict:
    """One 50-iteration fit of mode ``label``: the classifier leaf-wise, or
    ``train_booster`` depthwise, with the validation rows; launch counts
    zeroed just before and read just after."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk

    rows = X.shape[0]
    params, cfg = _mode(label)
    kernels = MAIN_KERNELS if policy == "leafwise" else DEPTHWISE_KERNELS
    _peak_gib(dev, reset=True)
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    with kernel_timer(dev) as events:
        if policy == "leafwise":
            model = LightGBMClassifier(
                numIterations=SAMPLING_ITERS, learningRate=0.1,
                numLeaves=31, maxBin=255, metric="auc",
                validationIndicatorCol="isVal", referenceDataset=mapper,
                device=dev, **params).fit(table)
            booster = model.booster
        else:
            booster = train_booster(
                X[:rows - nv], y[:rows - nv], BoosterConfig(
                    objective="binary", num_iterations=SAMPLING_ITERS,
                    learning_rate=0.1, num_leaves=31, max_bin=255,
                    metric="auc", growth_policy="depthwise", **cfg),
                valid=(X[rows - nv:], y[rows - nv:]), mapper=mapper,
                device=dev)
        _sync(dev)
    fit_s = time.perf_counter() - t0
    kernel_ms = sum(timed_ms(events).values()) / SAMPLING_ITERS
    launches = dict(hk.LAUNCHES)
    series = booster.metadata["valid_metric"]["values"]
    syncs = booster.metadata["host_syncs"]
    spans = booster.metadata["measures"]
    per_iter = {k: launches[k] / SAMPLING_ITERS for k in kernels}
    ratio = {k: per_iter[k] / plain_per_iter[k] for k in kernels
             if plain_per_iter.get(k)}
    log(f"  {label} {policy}: fit_s={fit_s:.3f} "
        f"({fit_s / SAMPLING_ITERS * 1e3:.1f} ms per iteration, "
        f"{len(series)} iterations), host_syncs/tree="
        f"{syncs / booster.num_trees:.2f}, validation AUC last "
        f"{series[-1]:.6f} best {booster.best_score:.6f} at "
        f"{booster.best_iteration}; launches {json.dumps(launches)} "
        f"({json.dumps({k: round(v, 2) for k, v in ratio.items()})} x phase "
        f"3's per iteration); histogram kernels {kernel_ms:.3f} ms per "
        f"iteration (CUDA events); sampling span "
        f"{spans.get('sampling', 0.0) / SAMPLING_ITERS * 1e3:.3f} ms per "
        f"iteration (host clock), peak {_peak_gib(dev):.3f} GiB")
    _check_launches(launches, kernels)
    if len(series) != SAMPLING_ITERS or not np.isfinite(series).all() \
            or series[-1] < 0.75:
        raise AssertionError(f"{label} {policy}: validation AUC series "
                             f"{series[:3]}..{series[-3:]}")
    return dict(booster=booster, fit_s=fit_s, launches=launches,
                auc=series[-1], kernel_ms=kernel_ms)


def dart_weight_replay(cfg: dict, iterations: int) -> list:
    """DART's tree weights after ``iterations`` one-tree iterations,
    replayed on the host from the config's drop parameters and seeds alone
    (LightGBM's DART: weighted or uniform drops, ``max_drop``,
    ``skip_drop``; the new tree at 1 / (k + 1) and the dropped trees scaled
    by k / (k + 1), or with the learning rate in place of 1 in xgboost
    mode)."""
    from synapseml_tpu_torch.gbdt import BoosterConfig

    c = BoosterConfig(**cfg)
    rng = np.random.default_rng(c.seed)
    weights: list = []
    for it in range(iterations):
        drop = []
        if weights:
            draw = (np.random.default_rng([c.drop_seed, it]) if c.drop_seed
                    else rng)
            if draw.random() >= c.skip_drop:
                w = np.asarray(weights)
                p = (np.full(len(w), c.drop_rate) if c.uniform_drop else
                     np.minimum(c.drop_rate * w * len(w) / w.sum(), 1.0))
                drop = list(np.nonzero(draw.random(len(w)) < p)[0]
                            [: c.max_drop])
        k = len(drop)
        one = c.learning_rate if c.xgboost_dart_mode else 1.0
        for j in drop:
            weights[j] *= k / (k + one)
        weights.append(1.0 / (k + one) if k else 1.0)
    return weights


def monotone_check(booster, dev: str) -> None:
    """The constraint as the port (and the JAX package) enforces it: at
    every split on X2 the right child's output is at least the left's
    (within ``MONOTONE_TOL`` of the tree's largest |value|). The raw score
    along a ``MONOTONE_GRID``-point grid of X2 over ``MONOTONE_ROWS`` rows
    is logged: neither package bounds a split's descendants (LightGBM's
    basic method does), so it need not rise."""
    checked, worst = 0, 0.0
    for tree in booster.trees:
        ns = int(tree.num_splits)
        lv = np.asarray(tree.leaf_value, np.float64)
        iv = np.asarray(tree.internal_value, np.float64)
        scale = max(np.abs(lv[:ns + 1]).max(), np.abs(iv[:ns]).max(), 1e-30)

        def value(c):
            return iv[c] if c >= 0 else lv[~c]

        for i in np.nonzero(np.asarray(tree.split_feature)[:ns]
                            == MONOTONE_FEATURE)[0]:
            gap = (value(tree.right_child[i]) - value(tree.left_child[i])) \
                / scale
            worst = min(worst, gap)
            checked += 1
    X, _ = higgs_like(MONOTONE_ROWS, seed=5)
    grid = np.linspace(-3, 3, MONOTONE_GRID, dtype=np.float32)
    tiled = np.repeat(X[None], MONOTONE_GRID, 0)
    tiled[:, :, MONOTONE_FEATURE] = grid[:, None]
    raw = booster.raw_score(tiled.reshape(-1, FEATURES)).reshape(
        MONOTONE_GRID, MONOTONE_ROWS)
    step = np.diff(raw, axis=0)
    log(f"  monotone: {checked} splits on X{MONOTONE_FEATURE} in "
        f"{booster.num_trees} trees, right child - left child >= "
        f"{worst:.3g} of the tree's max |value| (limit -{MONOTONE_TOL}); raw "
        f"score over a {MONOTONE_GRID}-point grid of X{MONOTONE_FEATURE}: "
        f"{int((step < 0).any(0).sum())} of {MONOTONE_ROWS} rows fall "
        f"somewhere, largest fall {max(-step.min(), 0.0):.4g}")
    if checked == 0 or worst < -MONOTONE_TOL:
        raise AssertionError(f"monotone: {checked} constrained splits, "
                             f"worst order {worst}")


def dart_and_rf_check(fits: dict, X, dev: str) -> None:
    """DART's kept tree weights against ``dart_weight_replay``; the RF
    model string carries ``average_output`` and reloads within
    ``SAMPLING_RELOAD_TOL``."""
    from synapseml_tpu_torch.gbdt.boosting import Booster

    dart = fits["dart leafwise"]["booster"]
    want = dart_weight_replay(dict(objective="binary", learning_rate=0.1,
                                   **_mode_config("dart")), SAMPLING_ITERS)
    dropped = sum(w < 1.0 for w in dart.tree_weights)
    log(f"  dart: {dropped} of {dart.num_trees} trees reweighted, weights "
        f"{min(dart.tree_weights):.4g}..{max(dart.tree_weights):.4g}; host "
        f"replay {'equal' if dart.tree_weights == want else 'DIFFERS'}")
    if dart.tree_weights != want or not dropped:
        raise AssertionError("DART's tree weights are not the replay's")
    rf = fits["rf leafwise"]["booster"]
    text = rf.model_string()
    sub = X[:10_000]
    gap = float(np.abs(Booster.from_model_string(text, device=dev)
                       .predict(sub) - rf.predict(sub)).max())
    log(f"  rf: model string {'has' if 'average_output' in text else 'LACKS'}"
        f" average_output, reload max |diff| {gap:.3g}")
    if "average_output" not in text or gap > SAMPLING_RELOAD_TOL:
        raise AssertionError("the RF model string does not reload")


def goss_kernel_check(captured: dict) -> None:
    """``child_histogram`` and ``range_histogram`` on the arguments of the
    GOSS fit's first root and first split (bins as the fit has them; g and
    h amplified on the sampled rows, m in {0, 1}) against their plain
    versions, as phase 2 holds them; ``level_histograms`` on the GOSS
    depthwise fit's first level below the root."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    bT, g, h, m, B = captured["child_histogram"]
    log(f"  GOSS root: {int(m.sum())} of {m.numel()} rows sampled, max |g| "
        f"{float(g.abs().max()):.4g}")
    fit_shaped_check("child_histogram GOSS root",
                     hk.child_histogram(bT, g, h, m, B),
                     hk._hist_plain(bT, g, h, m, B),
                     hk._rounded_values(g, h, m).double(),
                     compare_histograms)
    bT, g, h, m, st, ln, B = captured["range_histogram"]
    s, n = int(st), int(ln)
    fit_shaped_check(f"range_histogram GOSS split [{s}, {s + n})",
                     hk.range_histogram(bT, g, h, m, st, ln, B),
                     hk._range_hist_plain(bT, g, h, m, s, n, B),
                     hk._rounded_values(g, h, m)[s:s + n].double(),
                     compare_histograms)
    bT, g, h, m, starts, slot, B, L = captured["level_histograms"]
    level_fit_shaped_check(
        f"level_histograms GOSS depthwise level CAP={bT.shape[1]}",
        hk.level_histograms(bT, g, h, m, starts, slot, B, L),
        hk._level_hist_plain(bT, g, h, m, slot, B, L),
        hk._rounded_values(g, h, m).double(), slot, L, compare_histograms)


def sampling_cost(rows: int, dev: str) -> None:
    """The sampling work of one iteration alone, per mode, timed with CUDA
    events at the fit's row count (draws, GOSS's order, masks), and DART's
    score rebuild from 50 contributions."""
    from synapseml_tpu_torch.core import prng
    from synapseml_tpu_torch.gbdt import BoosterConfig
    from synapseml_tpu_torch.gbdt import boosting as gb
    from synapseml_tpu_torch.gbdt.grower import GrowerConfig, node_masks
    from synapseml_tpu_torch.ops import hist_kernel as hk

    if not _on_card(dev):
        return
    key0 = prng.prng_key(0)
    g = torch.randn((1, rows), device=dev)
    cur = torch.ones(rows, device=dev)
    featp = torch.ones(hk.features_padded(FEATURES), dtype=torch.bool,
                       device=dev)
    timed = {}
    for label, _, cfg in SAMPLING_MODES:
        bc = BoosterConfig(objective="binary", **cfg)

        def sample(bc=bc):
            gb._sample_rows_impl(bc, rows, key0, 0, g, g, cur)
            gb._sample_features_impl(bc, FEATURES, key0, 0, dev)
            if bc.feature_fraction_bynode < 1:
                node_masks(GrowerConfig(feature_fraction_bynode=0.5), featp,
                           gb._node_key_data(key0, 0, 0), 31)

        timed[label] = time_ms(sample, 5)
    contribs = gb._Contribs(rows, dev)
    for _ in range(SAMPLING_ITERS):
        contribs.append(0, g[0])
    timed["dart rebuild of 50 trees"] = time_ms(
        lambda: contribs.weighted([0.5] * SAMPLING_ITERS, 1), 5)
    log("  sampling alone per iteration (CUDA events, "
        f"{rows} rows): " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in timed.items()))


def sampling_curve(name: str, policy: str, rows: int, iters: int,
                   dev: str, threads: int = 0) -> tuple:
    """(per-iteration validation AUC, fit seconds) of mode ``name`` on
    ``rows`` HIGGS-shaped rows from seed 4, the last fifth as validation;
    ``threads`` > 0 sets torch's intra-op threads (a worker process)."""
    if threads:
        torch.set_num_threads(threads)
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    X, y = higgs_like(rows, seed=4)
    nv = rows // 5
    cfg = BoosterConfig(objective="binary", num_iterations=iters,
                        num_leaves=31, max_bin=255, metric="auc",
                        growth_policy=policy, **_mode_config(name))
    t0 = time.perf_counter()
    booster = train_booster(X[:-nv], y[:-nv], cfg, valid=(X[-nv:], y[-nv:]),
                            device=dev)
    return (np.asarray(booster.metadata["valid_metric"]["values"]),
            time.perf_counter() - t0)


def sampling_cross_check(dev: str) -> None:
    """Every mode (and the depthwise GOSS and DART fits) on
    ``SAMPLING_CROSS_ROWS`` rows, the last fifth as validation, for
    ``SAMPLING_CROSS_ITERS`` iterations on the card and on the CPU: the
    per-iteration validation AUC within ``CROSS_TOL`` (atomics flip
    near-tie splits). The CPU fits run at once in spawned worker
    processes, one per fit (the leaf-wise loop gains nothing from
    intra-op threads), while the card fits run here; the pool is shut
    down before the phase goes on."""
    from concurrent.futures import ProcessPoolExecutor

    cases = ([(name, "leafwise") for name, _, _ in SAMPLING_MODES]
             + [(name, "depthwise") for name in SAMPLING_DEPTHWISE])
    args = (SAMPLING_CROSS_ROWS, SAMPLING_CROSS_ITERS)
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(cases), mp_context=ctx) as pool:
        cpu = [pool.submit(sampling_curve, name, policy, *args, "cpu",
                           2 if policy == "depthwise" else 1)
               for name, policy in cases]
        card = [sampling_curve(name, policy, *args, dev)
                for name, policy in cases]
        cpu = [f.result() for f in cpu]
    worst = 0.0
    for (name, policy), (got, t_card), (want, t_cpu) in zip(cases, card,
                                                            cpu):
        gap = float(np.abs(got - want).max())
        worst = max(worst, gap)
        log(f"  {name} {policy}: max |AUC gap| {gap:.3g} over {len(want)} "
            f"iterations (AUC {want[-1]:.6f}; {t_card:.2f}s card, "
            f"{t_cpu:.2f}s CPU)")
        if gap > CROSS_TOL or len(got) != len(want):
            raise AssertionError(f"{name} {policy}: card and CPU validation "
                                 "curves disagree")
    log(f"  card against CPU: every mode within {worst:.3g}, "
        f"{time.perf_counter() - t0:.1f}s with the CPU fits in parallel")


def sampling_path(rows: int, dev: str, plain_launches: dict) -> dict:
    """Phase 13: the draws bitwise, every mode's fit on the ``rows`` table
    with its checks, the kernels on GOSS inputs, the sampling cost and the
    card-against-CPU curves. ``plain_launches`` are phase 3's (10
    iterations of the plain fit)."""
    from synapseml_tpu_torch.gbdt import grower, grower_depthwise

    t_start = time.perf_counter()

    def lap(step: str) -> None:
        log(f"  [{time.perf_counter() - t_start:.1f}s] {step} done")

    sampling_bitwise_check(rows, dev)
    lap("draws")
    X, y, nv, table, mapper = sampling_table(rows)
    plain = {k: v / 10 for k, v in plain_launches.items()}
    fits, captured = {}, {}
    for label, _, _ in [PLAIN_MODE] + SAMPLING_MODES:
        if label == "goss":
            with captured_call(grower, "child_histogram") as c, \
                    captured_call(grower, "range_histogram") as r:
                fits["goss leafwise"] = sampling_fit(
                    label, X, y, nv, table, mapper, dev, "leafwise", plain)
            captured["child_histogram"] = c["args"]
            captured["range_histogram"] = r["args"]
        else:
            fits[f"{label} leafwise"] = sampling_fit(
                label, X, y, nv, table, mapper, dev, "leafwise", plain)
    for label in SAMPLING_DEPTHWISE:
        # the GOSS fit's first level below the root
        index = 1 if label == "goss" else -1
        with captured_call(grower_depthwise, "level_histograms", index) as c:
            fits[f"{label} depthwise"] = sampling_fit(
                label, X, y, nv, table, mapper, dev, "depthwise", plain)
        if label == "goss":
            captured["level_histograms"] = c["args"]
    del table
    base = fits["plain leafwise"]["kernel_ms"]
    if base:
        log("  histogram kernel time per iteration against the plain fit's "
            f"{base:.3f} ms: " + ", ".join(
                f"{k} {f['kernel_ms'] / base:.2f}x" for k, f in fits.items()
                if k.endswith("leafwise")))
    lap("fits")
    goss_kernel_check(captured)
    del captured
    monotone_check(fits["monotone leafwise"]["booster"], dev)
    dart_and_rf_check(fits, X, dev)
    lap("checks")
    sampling_cost(X.shape[0] - nv, dev)
    lap("sampling alone")
    del X, y
    sampling_cross_check(dev)
    return fits


# ---------------------------------------------------------------------------
# phase 14: categorical and sparse (CSR) data
# ---------------------------------------------------------------------------

def fold_one_hot(X: np.ndarray) -> np.ndarray:
    """(n, 54) Covertype one-hot table → (n, 12): the numeric columns, then
    the index of the set wilderness column and of the set soil column (the
    raw ``covtype.data`` layout)."""
    num, wild = COVTYPE_NUMERIC, COVTYPE_WILD
    out = np.empty((X.shape[0], num + 2), np.float32)
    out[:, :num] = X[:, :num]
    out[:, num] = np.argmax(X[:, num:num + wild], axis=1)
    out[:, num + 1] = np.argmax(X[:, num + wild:], axis=1)
    return out


def covtype_csr(X: np.ndarray):
    """The one-hot table as a scipy CSR matrix (LIBSVM's ``covtype``
    layout): 12 non-zeros per row (10 numeric values, one wilderness, one
    soil)."""
    from scipy import sparse

    csr = sparse.csr_matrix(X)
    want = (COVTYPE_NUMERIC + 2) * X.shape[0]
    if csr.nnz != want:
        raise AssertionError(f"CSR holds {csr.nnz} entries, not {want}")
    return csr


def category_sets(booster, feature: int) -> list:
    """The number of categories sent left by every categorical split on
    ``feature`` (the popcount of its bitset)."""
    out = []
    for t in booster.trees:
        ns = int(t.num_splits)
        for i in np.flatnonzero((np.asarray(t.split_type)[:ns] == 1)
                                & (np.asarray(t.split_feature)[:ns]
                                   == feature)):
            out.append(int(sum(bin(int(w)).count("1")
                               for w in t.cat_bitset[i])))
    return out


def check_split_modes(label: str, booster) -> None:
    """Wilderness (4 categories, at most ``max_cat_to_onehot``) splits
    one-vs-rest; soil (40) takes category sets, at least one of several
    categories."""
    wild, soil = (category_sets(booster, f) for f in CAT_FEATURES)
    log(f"  {label}: {len(wild)} wilderness splits (sets of "
        f"{sorted(set(wild))}), {len(soil)} soil splits (sets of "
        f"{sorted(set(soil))})")
    if not wild or set(wild) != {1} or not soil or max(soil) < 2:
        raise AssertionError(f"{label}: expected one-vs-rest wilderness and "
                             "many-vs-many soil splits")


def check_syncs(label: str, booster, policy: str) -> float:
    """Host syncs per tree; a categorical split reads nothing more than a
    numeric one: leaf-wise one read for the root and one per split,
    depthwise at most one per level of the tree and the root's."""
    from synapseml_tpu_torch.gbdt.grower import forest_max_depth

    syncs = booster.metadata["host_syncs"]
    if policy == "leafwise":
        bound = sum(1 + int(t.num_splits) for t in booster.trees)
        ok = syncs == bound
    else:
        bound = sum(1 + forest_max_depth([t]) for t in booster.trees)
        ok = syncs <= bound
    if not ok:
        raise AssertionError(f"{label}: {syncs} host syncs for a bound of "
                             f"{bound}")
    return syncs / booster.num_trees


def categorical_fit(policy: str, X, y, table, dev: str) -> dict:
    """The 7-class fit on the 12-column table with its two categorical
    columns: the classifier leaf-wise, ``train_booster`` depthwise. Counts
    zeroed just before and read just after; the first root, split and
    level kernel calls captured; kernel time by CUDA events."""
    from synapseml_tpu_torch.gbdt import (BoosterConfig, grower,
                                          grower_depthwise, train_booster)
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk

    rows = X.shape[0]
    kernels = MAIN_KERNELS if policy == "leafwise" else DEPTHWISE_KERNELS
    captured = {}
    _peak_gib(dev, reset=True)
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    with kernel_timer(dev) as events:
        if policy == "leafwise":
            with captured_call(grower, "child_histogram") as c, \
                    captured_call(grower, "range_histogram") as r:
                model = LightGBMClassifier(
                    numIterations=FAMILY_ITERS, numLeaves=31, maxBin=255,
                    categoricalSlotIndexes=CAT_FEATURES,
                    device=dev).fit(table)
                _sync(dev)
            captured.update(child_histogram=c["args"],
                            range_histogram=r["args"])
            booster = model.booster
        else:
            with captured_call(grower_depthwise, "level_histograms", 1) as c:
                booster = train_booster(X, y, BoosterConfig(
                    objective="multiclass", num_class=COVTYPE_CLASSES,
                    growth_policy="depthwise", num_iterations=FAMILY_ITERS,
                    num_leaves=31, max_bin=255),
                    categorical_features=CAT_FEATURES, device=dev)
                _sync(dev)
            captured["level_histograms"] = c["args"]
            model = None
    fit_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    label = f"categorical {policy}"
    syncs = check_syncs(label, booster, policy)
    kernel_ms = sum(timed_ms(events).values()) / FAMILY_ITERS
    spans = {k: round(v, 4) for k, v in booster.metadata["measures"].items()}
    log(f"  {label} ({rows} x {X.shape[1]}, features {CAT_FEATURES} "
        f"categorical): fit_s={fit_s:.3f} row_iterations/s="
        f"{rows * FAMILY_ITERS / fit_s:.0f} trees={booster.num_trees} "
        f"host_syncs/tree={syncs:.2f} histogram kernels {kernel_ms:.3f} ms "
        f"per iteration (CUDA events) peak {_peak_gib(dev):.3f} GiB "
        f"launches {json.dumps(launches)} fit spans {json.dumps(spans)}")
    _check_launches(launches, kernels)
    check_split_modes(label, booster)
    if booster.num_trees != FAMILY_ITERS * COVTYPE_CLASSES:
        raise AssertionError(f"{label}: {booster.num_trees} trees")
    return dict(model=model, booster=booster, fit_s=fit_s, syncs=syncs,
                kernel_ms=kernel_ms, captured=captured)


def hist_float64(bT, vals, B: int, slot=None, slots: int = 1):
    """(slots, FP, B, 6) float64: per (slot, feature, bin) the sums of the
    rows' bf16-rounded [g, h, m] ``vals`` (n, 3) and of their magnitudes
    (one slot without ``slot``)."""
    FP, n = bT.shape
    b = bT.to(torch.int64)
    f = torch.arange(FP, device=bT.device)[:, None]
    s = (torch.zeros_like(b[:1]) if slot is None
         else slot.to(torch.int64)[None, :])
    flat = (s * FP + f) * B + b
    ok = (b >= 0) & (b < B) & (s >= 0) & (s < slots)
    flat = torch.where(ok, flat, slots * FP * B)
    v = vals.double()
    out = torch.zeros((slots * FP * B + 1, 6), dtype=torch.float64,
                      device=bT.device)
    out.index_add_(0, flat.reshape(-1), torch.cat([v, v.abs()], 1)
                   .expand(FP, n, 6).reshape(-1, 6))
    return out[:-1].reshape(slots, FP, B, 6)


def check_against_float64(label, got, plain, ref) -> None:
    """Phase 2's tolerance bin by bin: g and h within rtol 1e-5 / atol
    1e-3 of the plain version, or within ``PAD_SUM_ULPS`` units (2^-24 of
    the bin's sum of magnitudes) of the float64 sum ``ref`` (the bound
    phase 2 holds a bin of every row to: a float32 sum of 10^5 rows of
    near-equal values is rounded in the plain version's own order too);
    counts exact against both."""
    got, plain, ref = got.double(), plain.double(), ref.reshape(got.shape[:-1]
                                                                + (6,))
    exact, unit = ref[..., :3], 2.0 ** -24 * ref[..., 3:]
    near_plain = ((got - plain).abs()
                  <= KERNEL_ATOL + KERNEL_RTOL * plain.abs())[..., :2]
    near_exact = ((got - exact).abs() <= PAD_SUM_ULPS * unit)[..., :2]
    ok = (bool((near_plain | near_exact).all())
          and torch.equal(got[..., 2], plain[..., 2])
          and torch.equal(got[..., 2], exact[..., 2]))

    def units(a):
        gap = (a - exact).abs()[..., :2] / unit[..., :2].clamp_min(1e-300)
        return float(gap.max())

    gap_plain = (got - plain).abs().reshape(-1, 3).amax(0).tolist()
    log(f"  {label}: max |kernel - plain| g={gap_plain[0]:.3g} "
        f"h={gap_plain[1]:.3g} count={gap_plain[2]:.3g}; against float64: "
        f"kernel {units(got):.3g} units, plain {units(plain):.3g} units "
        f"(limit {PAD_SUM_ULPS}) -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} is off both its plain version and "
                             "the float64 sums")


def categorical_kernel_check(captured: dict) -> None:
    """The three kernels on the categorical fits' own first root, first
    split and first level below the root, against their plain versions
    and the float64 sums (``check_against_float64``)."""
    from synapseml_tpu_torch.ops import hist_kernel as hk

    bT, g, h, m, B = captured["child_histogram"]
    vals = hk._rounded_values(g, h, m)
    check_against_float64("child_histogram categorical root",
                          hk.child_histogram(bT, g, h, m, B),
                          hk._hist_plain(bT, g, h, m, B),
                          hist_float64(bT, vals, B))
    bT, g, h, m, st, ln, B = captured["range_histogram"]
    s, n = int(st), int(ln)
    check_against_float64(
        f"range_histogram categorical split [{s}, {s + n})",
        hk.range_histogram(bT, g, h, m, st, ln, B),
        hk._range_hist_plain(bT, g, h, m, s, n, B),
        hist_float64(bT[:, s:s + n], hk._rounded_values(g, h, m)[s:s + n],
                     B))
    bT, g, h, m, starts, slot, B, L = captured["level_histograms"]
    check_against_float64(
        f"level_histograms categorical depthwise level CAP={bT.shape[1]}",
        hk.level_histograms(bT, g, h, m, starts, slot, B, L),
        hk._level_hist_plain(bT, g, h, m, slot, B, L),
        hist_float64(bT, hk._rounded_values(g, h, m), B, slot, L))


def categorical_checks(fits: dict, X, y, dev: str) -> None:
    """Accuracy, reload within ``CAT_RELOAD_TOL`` and the kernels on the
    categorical fits' own inputs."""
    from synapseml_tpu_torch.gbdt.boosting import Booster

    base = float(np.bincount(y.astype(np.int64)).max() / len(y))
    sub = X[:10_000]
    for policy, fit in fits.items():
        booster = fit["booster"]
        prob = booster.predict(X)
        acc = float((np.argmax(prob, 1) == y).mean())
        reloaded = Booster.from_model_string(booster.model_string(),
                                             device=dev)
        gap = float(np.abs(reloaded.predict(sub) - prob[:10_000]).max())
        log(f"  categorical {policy}: train accuracy={acc:.4f} (largest "
            f"class {base:.4f}), reload max |diff|={gap:.3g}")
        if not np.allclose(prob.sum(1), 1.0, atol=1e-5) \
                or gap > CAT_RELOAD_TOL or not acc > base + 0.1:
            raise AssertionError(f"categorical {policy}: predictions or "
                                 "reload wrong")
    categorical_kernel_check({**fits["leafwise"]["captured"],
                              **fits["depthwise"]["captured"]})


def categorical_cross_check(Xc, y, dev: str) -> None:
    """Both categorical fits at ``CAT_CROSS_ROWS`` rows for
    ``FAMILY_CROSS_ITERS`` iterations on the card and on the CPU: mean
    |probability difference| within ``CROSS_TOL``, classes agreeing on
    ``CLASS_AGREEMENT`` of the rows."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

    X, y = Xc[:CAT_CROSS_ROWS], y[:CAT_CROSS_ROWS]
    for policy in ("leafwise", "depthwise"):
        cfg = BoosterConfig(objective="multiclass", num_class=COVTYPE_CLASSES,
                            growth_policy=policy,
                            num_iterations=FAMILY_CROSS_ITERS, num_leaves=31,
                            max_bin=255)
        probs = {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            probs[d] = train_booster(X, y, cfg,
                                     categorical_features=CAT_FEATURES,
                                     device=d).predict(X)
            log(f"  categorical {policy} {d}: fit+predict "
                f"{time.perf_counter() - t0:.2f}s")
        gap = float(np.abs(probs[dev] - probs["cpu"]).mean())
        agree = float((np.argmax(probs[dev], 1)
                       == np.argmax(probs["cpu"], 1)).mean())
        ok = gap <= CROSS_TOL and agree >= CLASS_AGREEMENT
        log(f"  categorical {policy}: card against CPU mean |prob diff|="
            f"{gap:.3g}, classes agree {agree:.4%} -> "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"categorical {policy}: card and CPU fits "
                                 "disagree")


# model-string lines that depend on float sums rather than the trees'
# structure (two fits on the same bins differ there only by the order of
# the card's atomic adds)
_SUM_FIELDS = ("tree_sizes=", "split_gain=", "leaf_value=", "leaf_weight=",
               "internal_value=", "internal_weight=")


def model_structure(text: str) -> list:
    return [ln for ln in text.splitlines() if not ln.startswith(_SUM_FIELDS)]


def _log_fit(what: str, booster, rows: int, fit_s: float,
             launches=None) -> None:
    syncs = check_syncs(what, booster, "leafwise")
    spans = booster.metadata["measures"]
    log(f"  {what}: fit_s={fit_s:.3f} row_iterations/s="
        f"{rows * FAMILY_ITERS / fit_s:.0f} host_syncs/tree={syncs:.2f} "
        f"referenceDataset {spans.get('referenceDataset', 0.0):.4f}s "
        f"dataPreparation {spans.get('dataPreparation', 0.0):.4f}s "
        f"trainingIterations {spans.get('trainingIterations', 0.0):.4f}s"
        + (f" launches {json.dumps(launches)}" if launches else ""))


def sparse_fit(X, y, dev: str, dense=None, dense_s: float = 0.0) -> float:
    """The one-hot table as CSR through ``train_booster`` beside the same
    rows dense (``dense``: phase 10's leaf-wise fit of them, else fitted
    here): bins bitwise equal, the same trees, predictions on the CSR rows
    equal to the dense rows'. The CSR fit takes the dense fit's config.
    Returns the CSR fit's seconds."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, Dataset, train_booster
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.ops.quantize import apply_bins

    rows = X.shape[0]
    t0 = time.perf_counter()
    csr = covtype_csr(X)
    log(f"  CSR: {csr.shape[0]} x {csr.shape[1]}, {csr.nnz} entries "
        f"({csr.nnz / rows:.1f} per row), built in "
        f"{time.perf_counter() - t0:.2f}s")
    if dense is None:
        t0 = time.perf_counter()
        dense = train_booster(X, y, BoosterConfig(
            objective="multiclass", num_class=COVTYPE_CLASSES,
            num_iterations=FAMILY_ITERS, num_leaves=31, max_bin=255),
            device=dev)
        dense_s = time.perf_counter() - t0
    _log_fit("dense fit (one-hot)", dense, rows, dense_s)
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    with kernel_timer(dev) as events:
        sparse_b = train_booster(csr, y, dense.config, device=dev)
        _sync(dev)
    launches = dict(hk.LAUNCHES)
    sparse_s = time.perf_counter() - t0
    _log_fit("CSR fit (train_booster)", sparse_b, rows, sparse_s, launches)
    log(f"  CSR fit: histogram kernels "
        f"{sum(timed_ms(events).values()) / FAMILY_ITERS:.3f} ms per "
        "iteration (CUDA events)")
    _check_launches(launches, MAIN_KERNELS)
    t0 = time.perf_counter()
    ds = Dataset(csr, y, device=dev)
    _sync(dev)
    ds_s = time.perf_counter() - t0
    same_bins = bool(torch.equal(ds.binned, apply_bins(ds.mapper, X, dev)))
    same_mapper = all(np.array_equal(getattr(ds.mapper, f),
                                     getattr(dense.mapper, f))
                      for f in ("boundaries", "num_bins", "has_nan"))
    text_d, text_s = dense.model_string(), sparse_b.model_string()
    identical = text_d == text_s
    same_trees = model_structure(text_d) == model_structure(text_s)
    differ = sorted({a.split("=")[0] for a, b in zip(text_d.splitlines(),
                                                     text_s.splitlines())
                     if a != b})
    pd_, ps = sparse_b.predict(X), sparse_b.predict(csr)
    same_pred = bool(np.array_equal(pd_, ps))
    gap = float(np.abs(dense.predict(X) - pd_).mean())
    log(f"  Dataset(CSR) in {ds_s:.2f}s: bins bitwise the dense rows' "
        f"{same_bins}, mappers equal {same_mapper}; model strings "
        f"byte-identical {identical} (lines that differ: {differ}; tree "
        f"structure identical {same_trees}, mean |prob diff| {gap:.3g}); "
        f"predict(CSR) == "
        f"predict(dense) {same_pred}")
    if not (same_bins and same_mapper and same_trees and same_pred
            and gap <= CROSS_TOL):
        raise AssertionError("the CSR fit is not the dense fit")
    return sparse_s


def categorical_path(dev: str, numeric: dict) -> dict:
    """Phase 14: the categorical fits of both policies on the 12-column
    Covertype table with their checks, beside phase 10's numeric one-hot
    fits (``numeric``: ``_numeric_baseline`` by policy); card against CPU;
    then the CSR fit. Returns the leaf-wise model and its 12-column rows
    (phase 15 serves them)."""
    t_start = time.perf_counter()
    X, y = covertype_like(COVTYPE_ROWS)
    Xc = fold_one_hot(X)
    table = table_of(Xc, y)
    fits = {p: categorical_fit(p, Xc, y, table, dev)
            for p in ("leafwise", "depthwise")}
    del table
    for policy, fit in fits.items():
        base = numeric.get(policy, {})
        if base.get("kernel_ms"):
            log(f"  {policy}: against phase 10's one-hot fit: histogram "
                f"kernels {fit['kernel_ms']:.3f} / {base['kernel_ms']:.3f} ms"
                f" per iteration ({fit['kernel_ms'] / base['kernel_ms']:.2f}"
                f"x), fit {fit['fit_s']:.3f} / {base['fit_s']:.3f} s, host "
                f"syncs per tree {fit['syncs']:.2f} / "
                f"{base['syncs_per_tree']:.2f}")
    categorical_checks(fits, Xc, y, dev)
    cat_s = {p: f["fit_s"] for p, f in fits.items()}
    served = dict(model=fits["leafwise"]["model"], Xc=Xc)
    del fits
    categorical_cross_check(Xc, y, dev)
    base = numeric.get("leafwise", {})
    sparse_s = sparse_fit(X, y, dev, base.get("booster"),
                          base.get("fit_s", 0.0))
    log(f"  categorical leaf-wise fit {cat_s['leafwise']:.3f} s against "
        f"the one-hot CSR fit's {sparse_s:.3f} s in this phase "
        f"({cat_s['leafwise'] / sparse_s:.2f}x)")
    return served


# ---------------------------------------------------------------------------
# phase 15: serving on the card
# ---------------------------------------------------------------------------

def _serve_handler(serve):
    """A ``ServingServer`` handler over a bucketed serving callable: each
    request is ``{"features": [...]}``, each reply the row's prediction."""
    from synapseml_tpu_torch.core import Table

    def handler(df):
        x = np.asarray([v["features"] for v in df["value"]], np.float32)
        return Table({"id": df["id"], "reply": serve(x)})

    handler.warmup = serve.warmup
    handler.runner = serve.runner
    return handler


def _median_call_ms(fn, dev: str, stream, calls: int) -> tuple:
    """(median host ms, median CUDA-event ms on ``stream``, or None on the
    CPU) over ``calls`` calls of ``fn`` after one warm call. ``fn`` ends in
    a host copy of its result, so the host time is the caller's latency;
    the events span the stream from before the call to after it, gaps
    while the stream waits on the host included."""
    fn()
    wall, event = [], []
    for _ in range(calls):
        if _on_card(dev):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
        t0 = time.perf_counter()
        fn()
        wall.append((time.perf_counter() - t0) * 1e3)
        if _on_card(dev):
            e1.record(stream)
            e1.synchronize()
            event.append(e0.elapsed_time(e1))
    return (float(np.median(wall)),
            float(np.median(event)) if event else None)


def _check_gap(label: str, got, want, tol: float = SERVE_TOL) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: shape {got.shape} against "
                             f"{want.shape}, finite {np.isfinite(got).all()}")
    gap = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    if gap > tol:
        raise AssertionError(f"{label}: max |gap| {gap} above {tol}")
    return gap


def _check_no_capture(label: str, runner) -> dict:
    stats = runner.stats()
    if stats["total_compiles"] != stats["warmup_compiles"]:
        raise AssertionError(f"{label}: {stats['total_compiles']} captures, "
                             f"{stats['warmup_compiles']} of them in "
                             "warmup: a request waited on a capture")
    return stats


def serving_warmup(booster, dev: str):
    """Step 1: the bucketed serving callable, every rung captured."""
    serve = booster.serving_fn(max_batch_size=SERVE_MAX_BATCH)
    _sync(dev)
    t0 = time.perf_counter()
    stats = serve.warmup()
    _sync(dev)
    warm_s = time.perf_counter() - t0
    per_rung = {b: round(s, 4) for (b, _), s in
                sorted(serve.runner.capture_seconds.items())}
    log(f"  warmup: {stats['total_compiles']} rungs {stats['buckets']} "
        f"captured in {warm_s:.3f}s ({booster.num_trees} trees, depth "
        f"{booster._depth_cache}); capture seconds by rung "
        f"{json.dumps(per_rung)}")
    if stats["total_compiles"] != len(stats["buckets"]):
        raise AssertionError(f"warmup captured {stats['compiles']}")
    return serve, per_rung


def serving_batch_predict(booster, Xv, dev: str) -> dict:
    """Step 3: ``predict(batch_size=SERVE_PREDICT_BATCH)`` over the
    validation rows against the unbatched ``predict``."""
    rows = Xv.shape[0]
    t0 = time.perf_counter()
    booster.predict(Xv, batch_size=SERVE_PREDICT_BATCH)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = booster.predict(Xv, batch_size=SERVE_PREDICT_BATCH)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = booster.predict(Xv)
    plain_s = time.perf_counter() - t0
    gap = _check_gap("predict(batch_size)", got, want)
    out = dict(rows_per_s=rows / batched_s, plain_rows_per_s=rows / plain_s,
               first_s=first_s, gap=gap)
    log(f"  predict(batch_size={SERVE_PREDICT_BATCH}) of {rows} rows: "
        f"{rows / batched_s:.0f} rows/s ({batched_s:.3f}s; first call with "
        f"its captures {first_s:.3f}s) against unbatched predict "
        f"{rows / plain_s:.0f} rows/s ({plain_s:.3f}s), max |gap| {gap:.3g}")
    return out


def serving_graph_vs_eager(booster, serve, Xv, dev: str) -> dict:
    """Step 2: the captured graphs against ``serving_fn(bucketed=False)``
    (eager) at each of ``SERVE_SIZES`` rows; at the largest size also the
    ``predict(batch_size=...)`` runner, one replay of its top rung."""
    plain = booster.serving_fn(bucketed=False)
    big = booster._serving_cache[SERVE_PREDICT_BATCH]
    eager_stream = torch.cuda.current_stream() if _on_card(dev) else None
    out = {}
    for rows in SERVE_SIZES:
        X = Xv[:rows]
        want = plain(X).cpu().numpy()
        cases = [("graphs", serve)]
        if rows > SERVE_MAX_BATCH:
            cases.append((f"graphs, top rung {SERVE_PREDICT_BATCH}", big))
        eager = _median_call_ms(lambda: plain(X).cpu().numpy(), dev,
                                eager_stream, SERVE_CALLS)
        for label, fn in cases:
            got = fn(X)
            gap = 0.0 if np.array_equal(got, want) else \
                _check_gap(f"{label} at {rows} rows", got, want)
            ms = _median_call_ms(lambda: fn(X), dev, fn.runner.stream,
                                 SERVE_CALLS)
            out[(rows, label)] = dict(graph=ms, eager=eager, gap=gap)
            speed = eager[0] / ms[0]
            ev = (f"; CUDA-event ms {ms[1]:.4f} against {eager[1]:.4f} "
                  f"({eager[1] / ms[1]:.2f}x)" if ms[1] else "")
            log(f"  {rows} rows, {label}: median of {SERVE_CALLS} calls "
                f"{ms[0]:.4f} ms against eager {eager[0]:.4f} ms "
                f"({speed:.2f}x){ev}; "
                + ("replies bitwise equal" if gap == 0.0
                   else f"max |gap| {gap:.3g}"))
    return out


def serving_replay_stages(serve, Xv, dev: str) -> dict:
    """Where one dispatch's time goes at 1 and ``SERVE_MAX_BATCH`` rows,
    median of ``SERVE_CALLS`` after one warm call: the host's padding into a
    pinned staging buffer (host ms), then on the runner's stream the
    copy-in, the replay and the copy-out into fresh tensors (CUDA events
    between them), then ``PendingBatch.result``'s wait, copy to the host
    and slice (host ms). These are ``_Graph.run``'s steps taken one by one
    under the runner's replay lock, and each reply must equal ``serve``'s.
    Nothing is captured on the CPU, so there it returns {}."""
    if not _on_card(dev):
        return {}
    from synapseml_tpu_torch.core.inference import PendingBatch, _pad_to

    runner = serve.runner
    out = {}
    for rows in (1, SERVE_MAX_BATCH):
        X = np.ascontiguousarray(Xv[:rows], dtype=np.float32)
        bucket = runner.bucket_for(rows)
        graph = runner._compiled[(bucket, (runner._spec_of(X),))]
        want = serve(X)
        times = {k: [] for k in ("staging", "copy_in", "replay", "copy_out",
                                 "result")}
        for call in range(SERVE_CALLS + 1):
            t0 = time.perf_counter()
            host = torch.empty(graph.inputs[0].shape,
                               dtype=graph.inputs[0].dtype, pin_memory=True)
            _pad_to(X, bucket, out=host.numpy())
            t1 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            with graph.lock, torch.cuda.stream(runner.stream):
                ev[0].record()
                graph.inputs[0].copy_(host, non_blocking=True)
                ev[1].record()
                graph.graph.replay()
                ev[2].record()
                outs = [o.clone() for o in graph.outputs]
                ev[3].record()
            t2 = time.perf_counter()
            got = PendingBatch([(outs, rows, bucket)], graph.kind, rows,
                               ev[3]).result()
            t3 = time.perf_counter()
            if not np.array_equal(got, want):
                _check_gap(f"replay stages at {rows} rows", got, want)
            if not call:
                continue
            times["staging"].append((t1 - t0) * 1e3)
            times["copy_in"].append(ev[0].elapsed_time(ev[1]))
            times["replay"].append(ev[1].elapsed_time(ev[2]))
            times["copy_out"].append(ev[2].elapsed_time(ev[3]))
            times["result"].append((t3 - t2) * 1e3)
        out[rows] = {k: float(np.median(v)) for k, v in times.items()}
        m = out[rows]
        log(f"  dispatch stages at {rows} rows (rung {bucket}), median of "
            f"{SERVE_CALLS}: host staging {m['staging']:.4f} ms, copy-in "
            f"{m['copy_in']:.4f} ms, replay {m['replay']:.4f} ms, copy-out "
            f"{m['copy_out']:.4f} ms (CUDA events on the runner's stream), "
            f"result (wait, copy to host, slice) {m['result']:.4f} ms")
    return out


def _client_loop(url: str, work, results: list, lock, done) -> None:
    """One client thread: a keep-alive connection, requests taken from the
    shared ``work`` iterator until it is empty; each result is (index,
    status, reply, sent at, seconds), and ``done`` counts them."""
    parts = urlsplit(url)
    conn = None
    while True:
        with lock:
            item = next(work, None)
        if item is None:
            break
        i, tenant, body = item
        if conn is None:
            conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                              timeout=SERVE_CLIENT_TIMEOUT)
        t0 = time.monotonic()
        try:
            conn.request("POST", parts.path or "/", body=body, headers={
                "Content-Type": "application/json", "X-Tenant": tenant})
            resp = conn.getresponse()
            status, payload = resp.status, resp.read()
        except (OSError, http.client.HTTPException) as e:
            status, payload = -1, repr(e).encode()
            conn.close()
            conn = None
        reply = json.loads(payload) if status == 200 else payload
        results.append((i, status, reply, t0, time.monotonic() - t0))
        with done.get_lock():
            done.value += 1
    if conn is not None:
        conn.close()


def _client_process(url: str, items: list, threads: int, done, out) -> None:
    """The load's clients, in a process of their own so that they do not
    share the server's interpreter lock: ``threads`` client threads over
    ``items``; the results go to the queue ``out``."""
    results: list = []
    lock = threading.Lock()
    work = iter(items)
    pool = [threading.Thread(target=_client_loop,
                             args=(url, work, results, lock, done))
            for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    out.put(results)


def _post_once(url: str, body: bytes, headers=None) -> tuple:
    """(status, reply or None, seconds) of one POST on a fresh connection
    (``http.client``: ``urllib``'s first calls in many threads at once
    each build an opener and load the system's TLS certificates)."""
    parts = urlsplit(url)
    t0 = time.monotonic()
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=SERVE_CLIENT_TIMEOUT)
    try:
        conn.request("POST", parts.path or "/", body=body, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        status, payload = resp.status, resp.read()
    finally:
        conn.close()
    reply = json.loads(payload) if status == 200 else None
    return status, reply, time.monotonic() - t0


def _stamp_stages(server, batch_s: list, stages: list) -> None:
    """Stamp each request of ``server`` as the batch loop takes it from the
    queue and as its batch is handed to the batch thread, and keep
    (admitted, taken, handed, run start, run end) of every request the
    batch thread runs in ``stages``, each batch's seconds in ``batch_s``.
    Wraps the server's queues and ``_run_batch``; the server's code is
    unchanged."""
    q, handoff = server._queue, server._handoff

    def stamped(get):
        def take(*args, **kw):
            req = get(*args, **kw)
            req.taken_at = time.monotonic()
            return req
        return take

    def hand(batch, *args, **kw):
        now = time.monotonic()
        for req in batch or ():
            req.handed_at = now
        return put(batch, *args, **kw)

    q.get, q.get_nowait = stamped(q.get), stamped(q.get_nowait)
    put, handoff.put = handoff.put, hand
    run_batch = server._run_batch

    def run(batch):
        t0 = time.monotonic()
        try:
            return run_batch(batch)
        finally:
            t1 = time.monotonic()
            batch_s.append(t1 - t0)
            stages.extend((r.admitted_at, r.taken_at, r.handed_at, t0, t1)
                          for r in batch)

    server._run_batch = run


def _request_stages(stages: list, lat_ms, n: int) -> dict:
    """Mean and p50 ms of each stage of a request on the server: queue wait
    (admitted to taken by the batch loop), batch formation (taken to its
    batch's hand-off), hand-off wait (to its batch's run start, while the
    batch thread runs earlier batches), the batch's run (decode, handlers,
    reply encode); HTTP in and out is the clients' mean latency less the
    server's mean admitted-to-run-end (means add up, medians do not)."""
    st = np.asarray(stages, np.float64)
    if st.shape != (n, 5):
        raise AssertionError(f"request stages: {st.shape[0]} of {n} "
                             "requests stamped")
    names = ("queue_wait", "formation", "handoff", "run")
    out = {k: dict(mean_ms=float((st[:, i + 1] - st[:, i]).mean() * 1e3),
                   p50_ms=float(np.median(st[:, i + 1] - st[:, i]) * 1e3))
           for i, k in enumerate(names)}
    out["http"] = dict(mean_ms=float(np.mean(lat_ms)
                                     - (st[:, 4] - st[:, 0]).mean() * 1e3))
    return out


def serving_load(serve, booster, swap_booster, cat_stage, Xv, Xc,
                 dev: str) -> dict:
    """Steps 4-6: two tenants behind one ``ServingServer`` under
    ``SERVE_CLIENTS`` client threads (in a process of their own), and a hot
    swap of ``"higgs"`` to ``swap_booster`` halfway through its requests.
    The batch thread's and each handler's host seconds are kept."""
    from synapseml_tpu_torch.core.qos import QoSController
    from synapseml_tpu_torch.io.serving import ServingServer
    from synapseml_tpu_torch.io.serving_main import build_handler

    nh, nc = SERVE_HIGGS_REQUESTS, SERVE_COVTYPE_REQUESTS
    rng = np.random.default_rng(15)
    hrows = rng.integers(0, Xv.shape[0], nh)
    crows = rng.integers(0, Xc.shape[0], nc)
    want = {"v1": booster.predict(Xv[hrows]),
            "v2": swap_booster.predict(Xv[hrows]),
            "covtype": cat_stage.booster.predict(Xc[crows])}
    tenants = np.array(["higgs"] * nh + ["covtype"] * nc)
    items = [(int(i), str(tenants[i]), json.dumps({"features": (
        Xv[hrows[i]] if i < nh else Xc[crows[i - nh]]).tolist()}).encode())
        for i in rng.permutation(nh + nc)]
    busy = {"batch": [], "higgs": [], "covtype": []}
    # (admitted, taken from the queue, batch run start, batch run end) of
    # every request the batch thread ran
    stages: list = []

    def timed(name, fn):
        """``fn`` with its host seconds per call kept under ``name``."""
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                busy[name].append(time.perf_counter() - t)

        for attr in ("warmup", "runner"):
            if hasattr(fn, attr):
                setattr(call, attr, getattr(fn, attr))
        return call

    higgs_v1 = _serve_handler(serve)
    higgs_v2 = _serve_handler(swap_booster.serving_fn(
        max_batch_size=SERVE_MAX_BATCH))
    covtype = build_handler(cat_stage, "probability")
    serve.runner.reset_stats()
    server = ServingServer(higgs_v1, host="127.0.0.1", port=0,
                           max_batch_size=SERVE_MAX_BATCH,
                           max_batch_latency=SERVE_BATCH_LATENCY,
                           qos=QoSController())
    _stamp_stages(server, busy["batch"], stages)
    ctx = mp.get_context("spawn")
    done, out = ctx.Value("i", 0), ctx.Queue()
    clients, swap = None, {}

    def swapper():
        # the tenants' requests are interleaved at random: half of all
        # replies is about half of "higgs"'s
        while done.value < (nh + nc) // 2 and clients.is_alive():
            time.sleep(0.002)
        swap["start"] = time.monotonic()
        reg.swap_to("v2", timed("higgs", higgs_v2))
        swap["end"] = time.monotonic()

    server.start()
    try:
        reg = server.add_tenant("higgs", timed("higgs", higgs_v1),
                                version="v1")
        server.add_tenant("covtype", timed("covtype", covtype))
        clients = ctx.Process(target=_client_process, args=(
            server.url, items, SERVE_CLIENTS, done, out))
        swap_thread = threading.Thread(target=swapper)
        clients.start()
        swap_thread.start()
        results = out.get(timeout=SERVE_LOAD_TIMEOUT)
        clients.join(timeout=SERVE_LOAD_TIMEOUT)
        swap_thread.join(timeout=SERVE_LOAD_TIMEOUT)
        metrics = server.metrics.snapshot()
    finally:
        server.stop()
        if clients is not None and clients.is_alive():
            clients.kill()
            clients.join()
    if clients.exitcode != 0 or swap_thread.is_alive() or "end" not in swap:
        raise AssertionError("serving load: a client or the swap did not "
                             "finish")
    failed = [(i, s, r) for i, s, r, _, _ in results if s != 200]
    if len(results) != nh + nc or failed:
        raise AssertionError(f"serving load: {len(results)} of {nh + nc} "
                             f"replies, not 200: {failed[:5]}")
    by_version = {"v1": 0, "v2": 0}
    for i, _, reply, sent, secs in results:
        if i >= nh:
            j = i - nh
            _check_gap(f"covtype request {i}", reply, want["covtype"][j])
            if int(np.argmax(reply)) != int(np.argmax(want["covtype"][j])):
                raise AssertionError(f"covtype request {i}: class differs")
            continue
        gaps = {v: abs(float(reply) - float(want[v][i])) for v in by_version}
        allowed = ("v1",) if sent + secs < swap["start"] else \
            ("v2",) if sent > swap["end"] else ("v1", "v2")
        fits = [v for v in allowed if gaps[v] <= SERVE_TOL]
        if not fits:
            raise AssertionError(f"higgs request {i}: reply {reply} is none "
                                 f"of {allowed}'s predict ({gaps})")
        by_version[fits[-1]] += 1
    lat = np.asarray([r[4] for r in results]) * 1e3
    # from the first request sent to the last reply (the client process's
    # start-up is not the server's)
    wall = max(r[3] + r[4] for r in results) - min(r[3] for r in results)
    stats_v1 = _check_no_capture("higgs v1", serve.runner)
    stats_v2 = _check_no_capture("higgs v2", higgs_v2.runner)
    swap_capture = sum(higgs_v2.runner.capture_seconds.values())
    out = dict(p50_ms=float(np.percentile(lat, 50)),
               p99_ms=float(np.percentile(lat, 99)),
               rps=len(results) / wall,
               mean_batch=metrics["completed"] / max(metrics["batches"], 1),
               swap_s=swap["end"] - swap["start"], swap_capture_s=swap_capture)
    for tenant, sel in (("higgs", lambda i: i < nh),
                        ("covtype", lambda i: i >= nh)):
        tl = np.asarray([r[4] for r in results if sel(r[0])]) * 1e3
        log(f"  {tenant}: {len(tl)} requests, p50 {np.percentile(tl, 50):.3f}"
            f" ms p99 {np.percentile(tl, 99):.3f} ms")
    log(f"  load: {len(results)} requests from {SERVE_CLIENTS} clients in "
        f"{wall:.3f}s ({out['rps']:.1f} requests/s), latency p50 "
        f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms, mean batch "
        f"{out['mean_batch']:.2f} rows over {metrics['batches']} batches, "
        f"every reply 200 and within {SERVE_TOL} of predict, covtype "
        "classes equal")
    per = {k: (len(v), float(np.sum(v))) for k, v in busy.items()}
    out["busy"] = per
    out["stages"] = _request_stages(stages, lat, nh + nc)
    log(f"  server: the batch thread busy {per['batch'][1]:.3f}s of "
        f"{wall:.3f}s over {per['batch'][0]} batches ("
        f"{per['batch'][1] / max(per['batch'][0], 1) * 1e3:.3f} ms each): "
        f"higgs handler {per['higgs'][1]:.3f}s in {per['higgs'][0]} calls "
        f"({per['higgs'][1] / max(per['higgs'][0], 1) * 1e3:.3f} ms each), "
        f"covtype transform {per['covtype'][1]:.3f}s in "
        f"{per['covtype'][0]} calls ("
        f"{per['covtype'][1] / max(per['covtype'][0], 1) * 1e3:.3f} ms "
        f"each), the rest request decode and reply encode")
    rs = out["stages"]
    log(f"  a request's time on the server, mean (p50) ms: queue wait "
        f"{rs['queue_wait']['mean_ms']:.3f} ({rs['queue_wait']['p50_ms']:.3f})"
        f", batch formation {rs['formation']['mean_ms']:.3f} "
        f"({rs['formation']['p50_ms']:.3f}), hand-off wait "
        f"{rs['handoff']['mean_ms']:.3f} ({rs['handoff']['p50_ms']:.3f}), "
        f"its batch's run "
        f"{rs['run']['mean_ms']:.3f} ({rs['run']['p50_ms']:.3f}); HTTP in "
        f"and out (client latency less admitted-to-run-end) "
        f"{rs['http']['mean_ms']:.3f} mean, of a mean latency "
        f"{float(np.mean(lat)):.3f}")
    log(f"  runner hits by rung: v1 {json.dumps(stats_v1['hits'])}, v2 "
        f"{json.dumps(stats_v2['hits'])}; captures after warmup: none")
    log(f"  hot swap to phase 3's model ({swap_booster.num_trees} trees) "
        f"halfway through: swap_to took {out['swap_s']:.3f}s, of it "
        f"{swap_capture:.3f}s capturing v2's {stats_v2['total_compiles']} "
        f"rungs while v1 served; higgs replies by version {by_version}")
    if not by_version["v2"] or not by_version["v1"]:
        raise AssertionError(f"hot swap: replies by version {by_version}")
    return out


def serving_overload(serve, booster, Xv, dev: str) -> dict:
    """Step 7: a burst against ``max_queue_size=SERVE_BURST_QUEUE`` while
    the handler is stalled must see fast 503s and correct 200s; a 1 ms
    deadline in front of a 50 ms handler must get a 504."""
    from synapseml_tpu_torch.io.serving import ServingServer

    inner = _serve_handler(serve)
    want = booster.predict(Xv[:SERVE_BURST])

    def stalled(df):
        # a model busy for the whole burst: every request is either queued
        # or shed before the first batch is answered (at most SERVE_STALL_S)
        end = time.monotonic() + SERVE_STALL_S
        while time.monotonic() < end and (
                server.metrics["accepted"] + server.metrics["shed"]
                < SERVE_BURST):
            time.sleep(0.002)
        return inner(df)

    server = ServingServer(stalled, host="127.0.0.1", port=0,
                           max_batch_size=SERVE_BURST_BATCH,
                           max_batch_latency=SERVE_BATCH_LATENCY,
                           max_queue_size=SERVE_BURST_QUEUE, warmup=False)
    server.start()
    try:
        bodies = [json.dumps({"features": Xv[i].tolist()}).encode()
                  for i in range(SERVE_BURST)]
        with ThreadPoolExecutor(max_workers=SERVE_BURST) as pool:
            burst = list(pool.map(lambda b: _post_once(server.url, b),
                                  bodies))
        shed = server.metrics["shed"]
    finally:
        server.stop()
    statuses = [s for s, _, _ in burst]
    slow_503 = [t for s, _, t in burst if s == 503 and t >= 1.0]
    if not statuses.count(503) or set(statuses) - {200, 503} or slow_503 \
            or shed != statuses.count(503):
        raise AssertionError(f"overload: statuses {sorted(set(statuses))}, "
                             f"{statuses.count(503)} 503s ({shed} shed), "
                             f"{len(slow_503)} of them after 1 s")
    for i, (status, reply, _) in enumerate(burst):
        if status == 200:
            _check_gap(f"burst request {i}", reply, want[i])
    log(f"  overload: {SERVE_BURST} requests at once against "
        f"max_queue_size={SERVE_BURST_QUEUE}, max_batch_size="
        f"{SERVE_BURST_BATCH}, the handler stalled until the burst is in: "
        f"{statuses.count(200)} x 200, {statuses.count(503)} x "
        f"503, the slowest 503 in "
        f"{max(t for s, _, t in burst if s == 503) * 1e3:.1f} ms; the 200s "
        f"within {SERVE_TOL} of predict")

    def sleepy(df):
        time.sleep(0.05)
        return inner(df)

    server = ServingServer(sleepy, host="127.0.0.1", port=0, warmup=False)
    server.start()
    try:
        status, _, secs = _post_once(server.url, bodies[0],
                                     {"X-Deadline-Ms": "1"})
    finally:
        server.stop()
    if status != 504:
        raise AssertionError(f"deadline: status {status}, not 504")
    log(f"  deadline: X-Deadline-Ms: 1 in front of a 50 ms handler got 504 "
        f"in {secs * 1e3:.1f} ms")
    return dict(shed=statuses.count(503))


def serving_path(dev: str, booster, Xv, cat_model, Xc, swap_booster
                 ) -> dict:
    """Phase 15: phase 12's early-stopped classifier served through captured
    graphs and behind the HTTP server beside phase 14's categorical model
    (saved and reloaded), with a hot swap to phase 3's model."""
    from synapseml_tpu_torch.core import PipelineStage

    t_start = time.perf_counter()
    serve, per_rung = serving_warmup(booster, dev)
    predict = serving_batch_predict(booster, Xv, dev)
    timed = serving_graph_vs_eager(booster, serve, Xv, dev)
    replay = serving_replay_stages(serve, Xv, dev)
    with tempfile.TemporaryDirectory() as tmp:
        cat_model.save(tmp)
        cat_stage = PipelineStage.load(tmp, device=dev)
    load = serving_load(serve, booster, swap_booster, cat_stage, Xv, Xc,
                        dev)
    overload = serving_overload(serve, booster, Xv, dev)
    return dict(per_rung=per_rung, predict=predict, timed=timed,
                replay=replay, load=load, overload=overload)


# ---------------------------------------------------------------------------
# phase 16: DL training state
# ---------------------------------------------------------------------------

def state_mismatches(a, b) -> list:
    """Paths of the leaves where two training-state trees (``Trainer.
    state_tree()``) differ in structure, dtype, shape or any bit."""
    from synapseml_tpu_torch.core.checkpoint import tree_flatten_with_path

    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return ["<structure>"]
    bad = []
    for (path, x), (_, y) in zip(fa, fb):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8) if x.numel() else x,
                y.reshape(-1).view(torch.uint8) if y.numel() else y):
            bad.append(path)
    return bad


def spec_state_bytes(shapes, dims, nshard: int, moments: int,
                     counts: int, itemsize: int = 4) -> int:
    """Bytes of parameters and optimizer state one rank holds at rest when
    tensor i of ``shapes`` is cut into ``nshard`` blocks along ``dims[i]``
    (None: held whole): each tensor plus ``moments`` moments of its size,
    and ``counts`` int32 counts."""
    total = 0
    for shape, dim in zip(shapes, dims):
        numel = int(np.prod(shape))
        total += (numel // nshard if dim is not None else numel) * itemsize
    return total * (1 + moments) + 4 * counts


def state_images(n: int, seed: int = 0):
    """``n`` ``cifar_like`` images resized on the host and normalised as
    the vision estimator does, and their labels."""
    from synapseml_tpu_torch.dl import vision as tv

    imgs, y = cifar_like(n, seed)
    return tv._normalize(tv._resolve_images(imgs, VISION_SIZE)), y


def state_trainer(init: dict, dev: str, mesh=None, **kw):
    """A ``Trainer`` of phase 11's fit A configuration (float32, adam 1e-3,
    batch 16, the last two blocks and the head trained) from ``init``."""
    from synapseml_tpu_torch.dl import make_backbone
    from synapseml_tpu_torch.dl import vision as tv
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    model = make_backbone(VISION_BACKBONE, VISION_CLASSES)
    model.load_state_dict(init)
    regex = tv.DeepVisionClassifier(additionalLayersToTrain=2) \
        ._freeze_regex(model)
    cfg = dict(batch_size=STATE_BATCH, max_epochs=STATE_EPOCHS,
               learning_rate=1e-3, optimizer="adam", freeze_regex=regex,
               seed=0)
    cfg.update(kw)
    return Trainer(model, TrainConfig(**cfg), mesh=mesh, device=dev)


@contextlib.contextmanager
def preempt_at(phase: str, step: int):
    """Raise ``PreemptionError`` at the given ``preemption_point``."""
    from synapseml_tpu_torch.core import checkpoint as ck

    def hook(p, s):
        if p == phase and s == step:
            raise ck.PreemptionError(f"preempted at {p}[{s}]")
    ck._PREEMPT_HOOK = hook
    try:
        yield
    finally:
        ck._PREEMPT_HOOK = None


@contextlib.contextmanager
def nan_batch_at(step: int):
    """Poison the host batch of training step ``step`` once (its first
    image NaN), through the trainer's batch hook."""
    from synapseml_tpu_torch.dl import trainer as tt

    def hook(s, xb, yb):
        if s != step or hook.fired:
            return xb, yb
        hook.fired = True
        xb = np.array(xb, np.float32)
        xb[0] = np.nan
        return xb, yb
    hook.fired = False
    tt._CHAOS_BATCH_HOOK = hook
    try:
        yield
    finally:
        tt._CHAOS_BATCH_HOOK = None


def state_kill_resume(init: dict, X, y, dev: str, workdir: str):
    """Kill at ``dl.epoch`` 2 and resume against an uninterrupted fit."""
    from synapseml_tpu_torch.core.checkpoint import (CheckpointStore,
                                                     PreemptionError)

    ref = state_trainer(init, dev).fit(X, y)
    want = ref.predict_logits(X[:32])
    ck = os.path.join(workdir, "kill")
    killed = state_trainer(init, dev, checkpoint_dir=ck)
    try:
        with preempt_at("dl.epoch", 2):
            killed.fit(X, y)
        raise AssertionError("the preemption hook did not stop the fit")
    except PreemptionError:
        pass
    saved = killed.state_tree()
    t0 = time.perf_counter()
    probe = state_trainer(init, dev, checkpoint_dir=ck, max_epochs=2)
    probe.fit(X, y)                        # restore only: epoch 2 of 2
    _sync(dev)
    restore_s = time.perf_counter() - t0
    bad = state_mismatches(probe.state_tree(), saved)
    store = CheckpointStore(os.path.join(workdir, "timed"))
    t0 = time.perf_counter()
    killed._save_checkpoint(store, 2)
    save_s = time.perf_counter() - t0
    blob = os.path.getsize(os.path.join(workdir, "timed",
                                        "ckpt_00000002.state.msgpack"))
    resumed = state_trainer(init, dev, checkpoint_dir=ck).fit(X, y)
    gap = _gap(resumed.predict_logits(X[:32]), want)
    epochs = [h["epoch"] for h in resumed.history]
    log(f"  kill at dl.epoch 2 and resume: restored state bitwise the saved "
        f"one ({len(saved['params'])} top-level modules, moments and "
        f"counts): {'ok' if not bad else 'WRONG ' + str(bad[:4])}; resumed "
        f"epochs {epochs}; eval logits max |diff| {gap:.3g} against the "
        f"uninterrupted fit (tolerance {VISION_LOGIT_TOL})")
    log(f"  state.msgpack {blob} bytes; save {save_s:.3f}s (encode, write, "
        f"fsync, manifest), restore {restore_s:.3f}s (a restore-only fit: "
        f"verify, decode, load)")
    if bad or epochs != [2] or gap > VISION_LOGIT_TOL:
        raise AssertionError("kill and resume went wrong")
    return resumed


def state_policies(init: dict, X, y, dev: str, workdir: str) -> None:
    """The skip and rollback non-finite policies on poisoned batches."""
    from synapseml_tpu_torch.core.logging import (failure_counts,
                                                  reset_failure_counts)
    from synapseml_tpu_torch.core.serialization import from_bytes

    reset_failure_counts()
    with nan_batch_at(STATE_SKIP_STEP):
        skip = state_trainer(init, dev, max_epochs=1,
                             nonfinite_policy="skip").fit(X, y)
    fc = failure_counts()
    losses = [st["loss"] for st in skip.step_stats]
    counts = (fc.get("train.nonfinite_loss", 0),
              fc.get("train.nonfinite_skipped", 0))
    log(f"  skip: NaN batch at step {STATE_SKIP_STEP}: counters "
        f"(nonfinite_loss, nonfinite_skipped) {counts}, {len(losses)} steps "
        f"applied, every loss finite {bool(np.all(np.isfinite(losses)))}")
    if counts != (1, 1) or not np.all(np.isfinite(losses)) or \
            len(losses) != len(X) // STATE_BATCH - 1:
        raise AssertionError("the skip policy went wrong")
    reset_failure_counts()
    ck = os.path.join(workdir, "rollback")
    roll = state_trainer(init, dev, checkpoint_dir=ck,
                         nonfinite_policy="rollback")
    seen = []
    restore = roll._restore_checkpoint

    def spy(store):
        epoch = restore(store)
        if epoch is not None:             # not the resume at the fit's start
            seen.append((epoch, roll.state_tree()))
        return epoch
    roll._restore_checkpoint = spy
    with nan_batch_at(STATE_ROLLBACK_STEP):
        roll.fit(X, y)
    epochs = [h["epoch"] for h in roll.history]
    with open(os.path.join(ck, "ckpt_00000001.state.msgpack"), "rb") as f:
        ckpt = from_bytes({**seen[0][1], "epoch": 0}, f.read()) if seen \
            else None
    bad = ["<no rollback>"] if not seen else state_mismatches(
        seen[0][1], {k: ckpt[k] for k in seen[0][1]})
    n = failure_counts().get("train.nonfinite_rollback", 0)
    log(f"  rollback: NaN batch at step {STATE_ROLLBACK_STEP}: rolled back "
        f"to epoch {seen[0][0] if seen else None} ({n} rollback), restored "
        f"state bitwise the epoch-1 checkpoint: "
        f"{'ok' if not bad else 'WRONG ' + str(bad[:4])}; history epochs "
        f"{epochs}")
    if bad or n != 1 or epochs != list(range(STATE_EPOCHS)) or \
            seen[0][0] != 1:
        raise AssertionError("the rollback policy went wrong")


def state_save_load(dev: str, workdir: str) -> None:
    """``DeepVisionClassifier`` save and ``PipelineStage.load`` through
    ``params.msgpack``, then the JAX package's fixture."""
    from synapseml_tpu_torch.core import PipelineStage, Table
    from synapseml_tpu_torch.dl import vision as tv

    imgs, y = cifar_like(32, seed=3)
    model = tv.DeepVisionClassifier(
        backbone=VISION_BACKBONE, imageSize=VISION_SIZE, maxEpochs=1,
        batchSize=STATE_BATCH, device=dev).fit(Table({"image": imgs,
                                                      "label": y}))
    table = Table({"image": imgs})
    want = np.asarray(model.transform(table)["probability"])
    path = os.path.join(workdir, "saved")
    model.save(path)
    loaded = PipelineStage.load(path)
    gap = _gap(np.asarray(loaded.transform(table)["probability"]), want)
    size = os.path.getsize(os.path.join(path, "params.msgpack"))
    log(f"  DeepVisionClassifier save / PipelineStage.load through "
        f"params.msgpack ({size} bytes): probabilities max |diff| {gap:.3g} "
        f"(tolerance {STATE_SAVE_TOL})")
    fx = np.load(STATE_FIXTURE / "inputs.npz")
    jax_model = PipelineStage.load(str(STATE_FIXTURE / "model"), device=dev)
    X = tv._normalize(tv._resolve_images(fx["images"],
                                         jax_model.getImageSize() or None))
    fgap = _gap(jax_model.trainer.predict_logits(X), fx["logits"])
    log(f"  the JAX package's saved TinyCNN ({type(jax_model).__name__}, "
        f"{len(fx['images'])} images): logits max |diff| {fgap:.3g} "
        f"(tolerance {STATE_FIXTURE_TOL})")
    if gap > STATE_SAVE_TOL or fgap > STATE_FIXTURE_TOL:
        raise AssertionError("msgpack save / load went wrong")


_STATE_SETTINGS = ("VISION_BACKBONE", "VISION_CLASSES", "VISION_SIDE",
                   "VISION_SIZE", "STATE_BATCH", "STATE_RANKS",
                   "STATE_RANK_IMAGES", "STATE_RANK_STEPS")


def _state_settings() -> dict:
    """The settings phase 16's ranks must share with this process (they
    import this module afresh): the sizes, and the backbone when it is not
    one of the package's own (a rehearsal's smaller one)."""
    from synapseml_tpu_torch.dl import backbones as tb

    out = {"globals": {k: globals()[k] for k in _STATE_SETTINGS},
           "backbones": {}}
    if VISION_BACKBONE not in ("resnet18", "resnet34", "resnet50",
                               "resnet101", "tiny"):
        out["backbones"][VISION_BACKBONE] = tb.BACKBONES[VISION_BACKBONE]
    return out


def _state_rank(rank: int, workdir: str, dev: str, settings: dict) -> None:
    """One rank of phase 16 (b): the replicated and the ZeRO fit on the
    mesh ``{"data": 2}``, resident bytes at rest, the step split, and the
    ZeRO fit's gathered state for the one-process restore."""
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.core.serialization import to_bytes
    from synapseml_tpu_torch.dl import backbones as tb
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    globals().update(settings["globals"])
    tb.BACKBONES.update(settings["backbones"])
    init_distributed("gloo", os.path.join(workdir, "store"), rank,
                     STATE_RANKS, timeout_s=300)
    mesh = make_mesh({"data": STATE_RANKS}, device=dev)
    init = torch.load(os.path.join(workdir, "init.pt"))
    X, y = state_images(STATE_RANK_IMAGES, seed=2)
    report = {}
    for mode in ("replicated", "zero"):
        tr = state_trainer(init, dev, mesh=mesh, max_epochs=1,
                           steps_per_epoch=STATE_RANK_STEPS,
                           param_sharding=mode,
                           checkpoint_dir=os.path.join(workdir, mode)
                           if mode == "zero" else None)
        rest = []

        def at_rest(ep):
            _sync(dev)
            rest.append(torch.cuda.memory_allocated()
                        if _on_card(dev) else 0)
        if _on_card(dev):
            torch.cuda.empty_cache()
        tr.fit(X, y, log_fn=at_rest)
        opt = tr.optimizer
        report[mode] = dict(
            losses=[st["loss"] for st in tr.step_stats],
            split={k: float(np.mean([st[k] for st in tr.step_stats[1:]]))
                   for k in ("gather_s", "forward_s", "backward_s",
                             "allreduce_s", "update_s")},
            allocated=rest[-1], bytes=tr.stats["state_bytes_per_rank"],
            spec_bytes=spec_state_bytes(
                opt.whole_shapes,
                [s.dim for s in tr.specs] if tr.specs else
                [None] * len(opt.whole_shapes), STATE_RANKS, 2, 2))
        if mode == "zero":
            with open(os.path.join(workdir, f"zero_{rank}.msgpack"),
                      "wb") as f:
                f.write(to_bytes(tr.state_tree()))
        del tr, opt
    with open(os.path.join(workdir, f"rank_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def state_ranks(init: dict, dev: str, workdir: str) -> None:
    """Phase 16 (b): two gloo ranks sharing the card, replicated and ZeRO,
    against one process; the ZeRO checkpoint restored in one process."""
    import torch.multiprocessing as tmp

    from synapseml_tpu_torch.core.serialization import to_bytes

    X, y = state_images(STATE_RANK_IMAGES, seed=2)
    one = state_trainer(init, dev, max_epochs=1,
                        steps_per_epoch=STATE_RANK_STEPS).fit(X, y)
    ref = [st["loss"] for st in one.step_stats]
    del one
    torch.save(init, os.path.join(workdir, "init.pt"))
    t0 = time.perf_counter()
    tmp.spawn(_state_rank, args=(workdir, dev, _state_settings()),
              nprocs=STATE_RANKS, join=True)
    log(f"  {STATE_RANKS} ranks spawned, trained and joined in "
        f"{time.perf_counter() - t0:.1f}s; one process, batch "
        f"{STATE_BATCH}: losses {[round(v, 6) for v in ref]}")
    reports = []
    for r in range(STATE_RANKS):
        with open(os.path.join(workdir, f"rank_{r}.json")) as f:
            reports.append(json.load(f))
    ok = True
    for mode in ("replicated", "zero"):
        for r, rep in enumerate(reports):
            x = rep[mode]
            gap = float(np.max(np.abs(np.subtract(x["losses"], ref))
                               / np.abs(ref)))
            ok &= gap <= STATE_RANK_LOSS_TOL and x["bytes"] == \
                x["spec_bytes"] and x["losses"] == reports[0][mode]["losses"]
            log(f"  {mode} rank {r}: losses max rel gap {gap:.3g} "
                f"(tolerance {STATE_RANK_LOSS_TOL}); at rest "
                f"{x['allocated'] / 2**20:.1f} MiB allocated, parameters "
                f"and optimizer state {x['bytes'] / 2**20:.1f} MiB "
                f"(shard specs: {x['spec_bytes'] / 2**20:.1f} MiB); step "
                f"{json.dumps({k: round(v * 1e3, 2) for k, v in x['split'].items()})}"
                f" ms")
    rep, zer = reports[0]["replicated"], reports[0]["zero"]
    log(f"  ZeRO at rest: {zer['bytes'] / rep['bytes']:.3f} of replicated "
        f"by the shard specs, {zer['allocated'] / max(rep['allocated'], 1):.3f}"
        f" by memory_allocated")
    one = state_trainer(init, dev, max_epochs=1,
                        steps_per_epoch=STATE_RANK_STEPS,
                        checkpoint_dir=os.path.join(workdir, "zero"))
    one.fit(X, y)                             # restore only
    restored = to_bytes(one.state_tree())
    same = []
    for r in range(STATE_RANKS):
        with open(os.path.join(workdir, f"zero_{r}.msgpack"), "rb") as f:
            same.append(f.read() == restored)
    log(f"  the two ranks' ZeRO checkpoint restored in one process: its "
        f"state's msgpack ({len(restored)} bytes) equal to each rank's "
        f"gathered state's: {same}")
    if not ok or not all(same) or zer["bytes"] >= 0.6 * rep["bytes"]:
        raise AssertionError("the two-rank fits went wrong")


def state_path(dev: str) -> None:
    """Phase 16: epoch checkpoints with resume, the skip and rollback
    policies, msgpack save and load, the JAX fixture, and two ranks
    replicated and ZeRO."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        init = vision_init_state()
        X, y = state_images(STATE_IMAGES)
        seconds = {"init_and_images": time.perf_counter() - t0}
        with tempfile.TemporaryDirectory() as workdir:
            for name, fn in (
                    ("kill_resume", lambda: state_kill_resume(
                        init, X, y, dev, workdir)),
                    ("policies", lambda: state_policies(init, X, y, dev,
                                                        workdir)),
                    ("save_load", lambda: state_save_load(dev, workdir)),
                    ("ranks", lambda: state_ranks(init, dev, workdir))):
                t0 = time.perf_counter()
                fn()
                seconds[name] = time.perf_counter() - t0
        log(f"  phase 16 seconds by part: "
            f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    finally:
        torch.backends.cudnn.deterministic = deterministic


# ---------------------------------------------------------------------------
# phase 17: distributed GBDT
# ---------------------------------------------------------------------------

def decisive_table(rows: int = DIST_DECISIVE_ROWS,
                   features: int = DIST_DECISIVE_FEATURES, seed: int = 0):
    """The JAX package's decisive fixture: the label rides thresholds of
    features 0-3 with margins far above the int8 grid's noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, features)).astype(np.float32)
    margin = (1.5 * (X[:, 0] > 0.3) + 1.2 * (X[:, 1] < -0.2)
              + 1.0 * (X[:, 2] > 0.0) + 0.8 * (X[:, 3] > 0.7)
              + rng.normal(scale=0.25, size=rows))
    return X, (margin > 1.4).astype(np.float32)


def quantized_inputs(rank: int, world: int) -> tuple:
    """One rank's inputs of the quantized pair: (32, 256) for the
    all-reduce, (2 world, 256) for the reduce-scatter."""
    rng = np.random.default_rng(70 + rank)
    shape = (32 + 2 * world, 256)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-2, 3, size=shape)
         ).astype(np.float32)
    return x[:32], x[32:]


def quantized_bound(parts: list, block: int = 256) -> np.ndarray:
    """Per element, n · scale / 2 of the quantized sum of ``parts`` (one
    array per rank, rows of ``block`` values): each rank snaps once to the
    shared grid of its block's max |x| over the ranks / 127."""
    stack = np.stack(parts).reshape(len(parts), -1, block)
    scale = np.abs(stack).max(axis=(0, 2)) / 127.0
    return np.repeat(len(parts) * scale / 2, block).reshape(parts[0].shape)


def _tree_shape(booster) -> list:
    return [(np.asarray(t.split_feature)[:int(t.num_splits)].tolist(),
             np.asarray(t.split_bin)[:int(t.num_splits)].tolist(),
             np.asarray(t.left_child)[:int(t.num_splits)].tolist(),
             np.asarray(t.right_child)[:int(t.num_splits)].tolist())
            for t in booster.trees]


def _dist_rank(rank: int, workdir: str, dev: str, rows: int,
               settings: dict) -> None:
    """One rank of phase 17: every run of ``DIST_RUNS`` on its block of the
    table (kernel launches, kernel and collective time, wire bytes, model
    digest), the identity fixture and the quantized pair on the card."""
    import hashlib

    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt import grower as tg
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.parallel import collectives as C
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed("gloo", os.path.join(workdir, "store"), rank,
                     DIST_RANKS, timeout_s=600)
    mesh = make_mesh({"data": DIST_RANKS}, device=dev)
    X, y = higgs_like(rows)
    Xe, _ = higgs_like(DIST_EVAL_ROWS, seed=1)
    report = {"runs": {}, "identity": {}}
    for name, kw in DIST_RUNS:
        cfg = BoosterConfig(objective="binary", num_iterations=DIST_ITERS,
                            num_leaves=31, max_bin=255, **kw)
        hk.reset_launch_counts()
        tg.reset_wire_counts()
        C.reset_staging_counts()
        _sync(dev)
        with kernel_timer(dev) as events:
            t0 = time.perf_counter()
            b = train_booster(X, y, cfg, mesh=mesh, device=dev)
            _sync(dev)
            fit_s = time.perf_counter() - t0
        prob = b.predict(Xe)
        np.save(os.path.join(workdir, f"prob_{name}_{rank}.npy"), prob)
        report["runs"][name] = dict(
            model_sha=hashlib.sha256(b.model_string().encode()).hexdigest(),
            launches=dict(hk.LAUNCHES), fit_s=fit_s,
            kernel_ms=sum(timed_ms(events).values()),
            wire=dict(tg.WIRE), staging_bytes=C.STAGING["bytes"],
            trees=b.num_trees, learner=b.config.tree_learner,
            splits=int(sum(int(t.num_splits) for t in b.trees)),
            routing=b.metadata.get("routing"),
            spans=b.metadata["measures"])
    Xd, yd = decisive_table(DIST_DECISIVE_ROWS)
    for name, kw in (("f32", dict(tree_learner="data")),
                     ("int8", dict(tree_learner="data",
                                   hist_allreduce_dtype="int8")),
                     ("feature", dict(tree_learner="feature"))):
        b = train_booster(Xd, yd, BoosterConfig(**DIST_DECISIVE_CFG, **kw),
                          mesh=mesh, device=dev)
        report["identity"][name] = dict(shape=_tree_shape(b),
                                        prob=b.predict(Xd))
    x, rs = quantized_inputs(rank, DIST_RANKS)
    group = mesh.group("data")
    report["quantized"] = dict(
        allreduce=C.allreduce_sum_quantized(
            torch.as_tensor(x, device=dev), group).cpu().numpy(),
        reduce_scatter=C.reduce_scatter_sum_quantized(
            torch.as_tensor(rs, device=dev), group).cpu().numpy())
    with open(os.path.join(workdir, f"dist_{rank}.json"), "w") as f:
        json.dump(report, f, default=lambda a: np.asarray(a).tolist())
    torch.distributed.destroy_process_group()


def dist_checks(reports: list, probs: dict, p_one, ye,
                reference: dict = None) -> dict:
    """Phase 17's checks on the ranks' reports and rank 0's evaluation
    probabilities (``probs[name]``) beside the one-process fit's
    (``p_one``) and, where known, the JAX package's AUC of each wire on
    the same table (``reference``); raises AssertionError naming every
    failure. Returns the AUCs."""
    from synapseml_tpu_torch.gbdt.objectives import auc

    bad = []
    for name, _ in DIST_RUNS:
        shas = {r["runs"][name]["model_sha"] for r in reports}
        if len(shas) != 1:
            bad.append(f"{name}: model strings differ across ranks")
        kernels = (("level_histograms",) if name == "depthwise"
                   else ("child_histogram", "range_histogram"))
        for i, r in enumerate(reports):
            missing = [k for k in kernels if r["runs"][name]["launches"][k]
                       <= 0]
            if missing:
                bad.append(f"{name}: rank {i} never launched {missing}")
    aucs = {name: float(auc(torch.as_tensor(ye), torch.as_tensor(p)))
            for name, p in probs.items()}
    gap = float(np.abs(probs["data_f32"] - p_one).max())
    if gap > DIST_PROB_TOL:
        bad.append(f"data_f32 probabilities {gap:.3g} from one process "
                   f"(tolerance {DIST_PROB_TOL})")
    if abs(aucs["data_int8"] - aucs["data_f32"]) > DIST_AUC_TOL:
        bad.append(f"data_int8 AUC {aucs['data_int8']:.6f} against f32 "
                   f"{aucs['data_f32']:.6f}")
    for wire, want in (reference or {}).items():
        if abs(aucs[f"data_{wire}"] - want) > DIST_AUC_TOL:
            bad.append(f"data_{wire} AUC {aucs[f'data_{wire}']:.6f} against "
                       f"the JAX package's {want:.6f}")
    if aucs["voting"] < aucs["data_f32"] - DIST_VOTING_AUC_GAP:
        bad.append(f"voting AUC {aucs['voting']:.6f} below data's less "
                   f"{DIST_VOTING_AUC_GAP}")
    ident = reports[0]["identity"]
    if ident["int8"]["shape"] != ident["f32"]["shape"]:
        bad.append("decisive fixture: int8 trees differ from f32's")
    fgap = float(np.abs(np.asarray(ident["feature"]["prob"])
                        - np.asarray(ident["f32"]["prob"])).max())
    if fgap > DIST_IDENTITY_TOL:
        bad.append(f"decisive fixture: feature against data {fgap:.3g}")
    parts = [quantized_inputs(r, len(reports)) for r in range(len(reports))]
    want = np.sum([p[0].astype(np.float64) for p in parts], axis=0)
    bound = quantized_bound([p[0] for p in parts])
    for i, r in enumerate(reports):
        got = np.asarray(r["quantized"]["allreduce"])
        if not np.array_equal(got, reports[0]["quantized"]["allreduce"]):
            bad.append(f"allreduce_sum_quantized differs on rank {i}")
        if (np.abs(got - want) > bound * (1 + 1e-6)).any():
            bad.append(f"allreduce_sum_quantized on rank {i} beyond n scale/2")
        rs_want = np.sum([p[1].astype(np.float64) for p in parts], axis=0)
        rs_bound = quantized_bound([p[1] for p in parts])
        chunk = rs_want.shape[0] // len(reports)
        sl = slice(i * chunk, (i + 1) * chunk)
        got = np.asarray(r["quantized"]["reduce_scatter"])
        if (np.abs(got - rs_want[sl]) > rs_bound[sl] * (1 + 1e-6)).any():
            bad.append(f"reduce_scatter_sum_quantized on rank {i} beyond "
                       "n scale/2")
    if bad:
        raise AssertionError("phase 17: " + "; ".join(bad))
    return dict(aucs=aucs, prob_gap=gap, feature_gap=fgap)


def dist_path(rows: int, dev: str) -> dict:
    """Phase 17: ``train_booster(mesh=...)`` on two gloo ranks sharing the
    card, every learner and wire, against a one-process fit."""
    import torch.multiprocessing as tmp

    from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster
    from synapseml_tpu_torch.gbdt.voting import collective_bytes_per_split

    X, y = higgs_like(rows)
    Xe, ye = higgs_like(DIST_EVAL_ROWS, seed=1)
    cfg = BoosterConfig(objective="binary", num_iterations=DIST_ITERS,
                        num_leaves=31, max_bin=255, tree_learner="data")
    t0 = time.perf_counter()
    p_one = train_booster(X, y, cfg, device=dev).predict(Xe)
    log(f"  one process: {rows} rows, {DIST_ITERS} iterations in "
        f"{time.perf_counter() - t0:.2f}s")
    del X, y
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        settings = {k: globals()[k] for k in _DIST_SETTINGS}
        tmp.spawn(_dist_rank, args=(workdir, dev, rows, settings),
                  nprocs=DIST_RANKS, join=True)
        log(f"  {DIST_RANKS} ranks spawned, trained and joined in "
            f"{time.perf_counter() - t0:.1f}s")
        reports = []
        for r in range(DIST_RANKS):
            with open(os.path.join(workdir, f"dist_{r}.json")) as f:
                reports.append(json.load(f))
        probs = {name: np.load(os.path.join(workdir, f"prob_{name}_0.npy"))
                 for name, _ in DIST_RUNS}
    predicted = collective_bytes_per_split(FEATURES, 255)
    for name, _ in DIST_RUNS:
        for i, r in enumerate(reports):
            x = r["runs"][name]
            it = max(x["trees"], 1)
            loop = x["spans"]["trainingIterations"] * 1e3 / it
            kernel = x["kernel_ms"] / it
            coll = x["wire"]["seconds"] * 1e3 / it
            gather = x["spans"].get("nodeGather", 0.0) * 1e3 / it
            log(f"  {name} rank {i} ({x['learner']}): fit {x['fit_s']:.3f}"
                f" s, binning "
                f"{x['spans'].get('referenceDataset', 0.0):.3f} + "
                f"{x['spans'].get('dataPreparation', 0.0):.3f} s; per "
                f"iteration {loop:.2f} ms = histogram kernels {kernel:.2f} "
                f"+ histogram collectives {coll:.2f} + leaf gather "
                f"{gather:.2f} + rest {loop - kernel - coll - gather:.2f}; "
                "per tree "
                f"{x['wire']['collectives'] / it:.1f} collectives, "
                f"{x['wire']['bytes'] / it:.0f} B on the wire, "
                f"{x['staging_bytes'] / it:.0f} B staged (predicted "
                f"{predicted} B a split x {x['splits'] / it:.1f} splits + "
                f"1 root); launches {json.dumps(x['launches'])}")
    routing = reports[0]["runs"]["auto"]["routing"]
    log(f"  router: {routing['tree_learner']} ({routing['router']}), "
        f"predicted s/tree "
        f"{json.dumps({k: round(v, 6) for k, v in routing['predicted_s_per_tree'].items()})}"
        f", link {routing['inputs']['link_bytes_per_s']:.4g} B/s")
    reference = DIST_REFERENCE_AUC.get(rows)
    out = dist_checks(reports, probs, p_one, ye, reference)
    log(f"  AUC on {DIST_EVAL_ROWS} held-out rows: "
        f"{json.dumps({k: round(v, 6) for k, v in out['aucs'].items()})}; "
        f"the JAX package's: {json.dumps(reference)}; "
        f"data/f32 against one process max |dp| {out['prob_gap']:.3g}; "
        f"decisive fixture: int8 trees = f32 trees, feature against data "
        f"{out['feature_gap']:.3g}; model strings equal across ranks; "
        "quantized pair bitwise across ranks within n scale/2")
    return out


# ---------------------------------------------------------------------------
# phase 18: ONNX inference through ONNXModel on captured graphs
# ---------------------------------------------------------------------------

def onnx_rel_gap(label: str, got, want, rel: float) -> float:
    """max |got - want| over max |want|; raises above ``rel`` or on a
    shape or finiteness mismatch."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: shape {got.shape} against "
                             f"{want.shape}, finite {np.isfinite(got).all()}")
    gap = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    if gap > rel:
        raise AssertionError(f"{label}: max |gap| / max |y| {gap:.3g} above "
                             f"{rel}")
    return gap


def onnx_stage(raw: bytes, in_name: str, out_name: str, batch: int,
               precision: str, dev: str):
    from synapseml_tpu_torch.onnx import ONNXModel

    return (ONNXModel(device=dev, floatPrecision=precision)
            .setModelPayload(raw).setMiniBatchSize(batch)
            .setFeedDict({in_name: "x"}).setFetchDict({"y": out_name}))


def onnx_model_run(label: str, raw: bytes, in_name: str, out_name: str,
                   x: np.ndarray, batch: int, precision: str, dev: str,
                   card: str) -> dict:
    """One model at one precision: import, the first transform (its
    captures), ``ONNX_TIMED`` steady transforms, one full batch's replay and
    eager call timed with CUDA events, peak memory, and the card against
    the port's CPU run of the same graph on ``ONNX_CROSS_ROWS`` rows."""
    from synapseml_tpu_torch.core import Table

    rows = x.shape[0]
    stage = onnx_stage(raw, in_name, out_name, batch, precision, dev)
    _sync(dev)
    _peak_gib(dev, reset=True)
    t0 = time.perf_counter()
    fn = stage._onnx_fn()
    _sync(dev)
    import_s = time.perf_counter() - t0
    table = Table({"x": x})
    t0 = time.perf_counter()
    y = stage.transform(table)["y"]
    first_s = time.perf_counter() - t0
    runner = next(iter(stage._runner_cache.values()))
    stats = runner.stats()
    want_rungs = {batch: 1, runner.bucket_for(rows % batch or batch): 1}
    if stats["compiles"] != want_rungs:
        raise AssertionError(f"{label}: captures {stats['compiles']}, "
                             f"expected {want_rungs}")
    per_rung = {b: round(s_, 4) for (b, _), s_ in
                sorted(runner.capture_seconds.items())}
    walls = []
    for _ in range(ONNX_TIMED):
        t0 = time.perf_counter()
        y2 = stage.transform(table)["y"]
        walls.append(time.perf_counter() - t0)
    if not np.array_equal(y, y2):
        raise AssertionError(f"{label}: a replay changed the output")
    if runner.stats()["compiles"] != stats["compiles"]:
        raise AssertionError(f"{label}: a steady transform captured again")
    wall_s = float(np.median(walls))
    out = dict(label=label, rows=rows, import_s=import_s, first_s=first_s,
               per_rung=per_rung, wall_rows_per_s=rows / wall_s,
               nodes=len(fn._plan))
    if _on_card(dev):
        full = x[:batch]
        # one batch's latency through the runner (copy in, replay, copy
        # out), then the captured graph's replay alone
        replay, _ = _median_call_ms(
            lambda: runner.dispatch(full).result(), dev, runner.stream,
            ONNX_REPLAYS)
        graph = runner._compiled[(batch, (runner._spec_of(full),))]

        def replay_only():
            with torch.cuda.stream(runner.stream):
                graph.graph.replay()
        _, replay_ev = _median_call_ms(replay_only, dev, runner.stream,
                                       ONNX_REPLAYS)
        f, _ = fn.as_torch([in_name])
        xt = torch.from_numpy(full).to(dev)
        with torch.no_grad():
            eager_wall, eager_ev = _median_call_ms(
                lambda: f(xt), dev, torch.cuda.current_stream(), 3)
        out.update(replay_ms=replay_ev, replay_wall_ms=replay,
                   eager_ms=eager_ev, eager_wall_ms=eager_wall,
                   device_rows_per_s=batch / replay_ev * 1e3,
                   peak_gib=_peak_gib(dev))
    cpu = onnx_stage(raw, in_name, out_name, batch, precision, "cpu")
    want = cpu.transform(Table({"x": x[:ONNX_CROSS_ROWS]}))["y"]
    rel = ONNX_BF16_REL if precision == "bfloat16" else ONNX_F32_REL
    out["cpu_gap"] = onnx_rel_gap(f"{label} against the CPU",
                                  y[:ONNX_CROSS_ROWS], want, rel)
    out["head"] = y[:ONNX_CROSS_ROWS]
    if y.shape[0] != rows or not np.isfinite(y).all():
        raise AssertionError(f"{label}: output {y.shape}, finite "
                             f"{np.isfinite(y).all()}")
    unit = "images" if "resnet" in label else "sequences"
    dev_part = (f"; one batch of {batch}: graph replay "
                f"{out['replay_ms']:.4f} ms (CUDA events), through the "
                f"runner {out['replay_wall_ms']:.4f} ms wall (copies in and "
                f"out), eager {out['eager_ms']:.4f} ms "
                f"({out['eager_wall_ms']:.4f} wall), "
                f"{out['device_rows_per_s']:.1f} {unit}/s on the device; "
                f"peak {out['peak_gib']:.3f} GiB") if _on_card(dev) else ""
    log(f"  {label}: {out['nodes']} nodes; import {import_s:.3f} s; first "
        f"transform {first_s:.3f} s (captures by rung {json.dumps(per_rung)}"
        f" s); steady transform of {rows} rows: "
        f"{out['wall_rows_per_s']:.1f} {unit}/s wall{dev_part}; card against "
        f"CPU on {ONNX_CROSS_ROWS} rows {out['cpu_gap']:.3g} of max |y| "
        f"(bound {rel}); {card}")
    return out


def onnx_models(dev: str, card: str) -> list:
    """ResNet-50 (float32, bf16) and the BERT-base-wide encoder: generated
    with seeded weights, encoded, parsed and imported (each timed), then
    ``onnx_model_run`` per precision."""
    from synapseml_tpu_torch.onnx import Model, modelgen

    results = []
    for name, maker, kw, batch, precisions in ONNX_MODELS:
        kw = dict(kw)
        t0 = time.perf_counter()
        if maker == "make_resnet":
            model = modelgen.make_resnet(kw.pop("depth"), **kw)
        else:
            model = getattr(modelgen, maker)(**kw)
        gen_s = time.perf_counter() - t0
        in_vi, out_vi = model.graph.inputs[0], model.graph.outputs[0]
        weights = sum(int(np.prod(t.dims)) for t in
                      model.graph.initializers.values())
        t0 = time.perf_counter()
        raw = model.encode()
        encode_s = time.perf_counter() - t0
        del model
        t0 = time.perf_counter()
        parsed = Model.parse(raw)
        parse_s = time.perf_counter() - t0
        nodes = len(parsed.graph.nodes)
        del parsed
        log(f"  {name}: {nodes} nodes, {weights} weights "
            f"({len(raw) / 2 ** 20:.1f} MiB); generate {gen_s:.3f} s, "
            f"encode {encode_s:.3f} s, parse {parse_s:.3f} s; {card}")
        rows = ONNX_FULL_BATCHES * batch + ONNX_TAIL
        shape = tuple(d for d in in_vi.shape[1:])
        x = np.random.default_rng(0).normal(size=(rows,) + shape).astype(
            np.float32)
        for precision in precisions:
            r = onnx_model_run(f"{name} {precision}", raw, in_vi.name,
                               out_vi.name, x, batch, precision, dev, card)
            r.update(gen_s=gen_s, encode_s=encode_s, parse_s=parse_s,
                     weights=weights)
            results.append(r)
            if _on_card(dev):
                torch.cuda.empty_cache()
        if len(precisions) == 2:
            onnx_bf16_against_f32(name, *results[-2:], card)
    return results


def onnx_bf16_against_f32(name: str, f32: dict, bf16: dict, card: str
                          ) -> None:
    """The card's bf16 output against its float32 output on the same rows:
    what the bf16 bound has to tell apart. A card that computed float32
    where bf16 was asked would sit nearer its float32 output than the CPU's
    bf16 run; that raises."""
    f32_gap = float(np.abs(bf16["head"] - f32["head"]).max()
                    / max(np.abs(f32["head"]).max(), 1e-30))
    bf16["f32_gap"] = f32_gap
    if not bf16["cpu_gap"] < f32_gap:
        raise AssertionError(
            f"{name} bfloat16: {bf16['cpu_gap']:.3g} of max |y| from the "
            f"CPU's bf16 run, {f32_gap:.3g} from the card's float32 output")
    log(f"  {name}: bf16 against float32 on the card, {ONNX_CROSS_ROWS} "
        f"rows: {f32_gap:.3g} of max |y| (bf16 bound {ONNX_BF16_REL}); "
        f"{card}")


def onnx_fixtures(dev: str, card: str) -> dict:
    """Every committed fixture through ``ONNXModel`` in one mini-batch
    (the runtime If / Loop fixtures' conditions read the whole input),
    against torch's own output."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.onnx import Model

    res = REPO / "tests" / "resources" / "onnx"
    gaps = {}
    for path in sorted(res.glob("*.onnx")):
        raw = path.read_bytes()
        data = np.load(path.with_suffix(".npz"))
        g = Model.parse(raw).graph
        in_name = [vi.name for vi in g.inputs
                   if vi.name not in g.initializers][0]
        stage = onnx_stage(raw, in_name, g.outputs[0].name,
                           len(data["x"]), "float32", dev)
        got = stage.transform(Table({"x": data["x"]}))["y"]
        rtol, atol = ONNX_FIXTURE_TOL
        if got.shape != data["y"].shape or not np.allclose(
                got, data["y"], rtol=rtol, atol=atol):
            raise AssertionError(
                f"fixture {path.stem}: max |gap| "
                f"{np.abs(got - data['y']).max():.3g} over rtol {rtol} / "
                f"atol {atol}")
        gaps[path.stem] = float(np.abs(got - data["y"]).max())
    log(f"  {len(gaps)} committed fixtures against torch's output (rtol "
        f"{ONNX_FIXTURE_TOL[0]} / atol {ONNX_FIXTURE_TOL[1]}): max |gap| "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in gaps.items()})}; "
        f"{card}")
    if len(gaps) < 12:
        raise AssertionError(f"only {len(gaps)} fixtures found in {res}")
    return gaps


def onnx_tree_ensemble(booster, dev: str, card: str) -> dict:
    """``Booster.to_onnx`` of a binary booster through ``ONNXModel`` on the
    card, against ``Booster.predict`` on ``ONNX_TREE_ROWS`` rows."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.onnx import ONNXModel

    X, _ = higgs_like(ONNX_TREE_ROWS, seed=3)
    t0 = time.perf_counter()
    raw = booster.to_onnx().encode()
    export_s = time.perf_counter() - t0
    stage = (ONNXModel(device=dev).setModelPayload(raw)
             .setMiniBatchSize(ONNX_TREE_BATCH)
             .setFeedDict({"input": "x"})
             .setFetchDict({"p": "probabilities"}))
    table = Table({"x": X})
    t0 = time.perf_counter()
    stage.transform(table)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = stage.transform(table)["p"][:, 1]
    steady_s = time.perf_counter() - t0
    want = booster.predict(X)
    rtol, atol = ONNX_TREE_TOL
    gap = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"tree ensemble: max |gap| {gap:.3g} over "
                             f"rtol {rtol} / atol {atol}")
    log(f"  Booster.to_onnx ({booster.num_trees} trees, {len(raw)} bytes, "
        f"exported in {export_s:.3f} s) through ONNXModel: "
        f"{ONNX_TREE_ROWS} rows first {first_s:.3f} s, steady "
        f"{ONNX_TREE_ROWS / steady_s:.0f} rows/s wall; against predict max "
        f"|gap| {gap:.3g} (rtol {rtol} / atol {atol}); {card}")
    return dict(gap=gap, rows_per_s=ONNX_TREE_ROWS / steady_s)


def onnx_path(dev: str, booster=None, card: str = "") -> dict:
    """Phase 18: ONNX inference as a user runs it, ``ONNXModel.transform``
    on captured CUDA graphs; ``booster`` is phase 3's (a small one is
    trained when the phase runs alone)."""
    if booster is None:
        from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

        X, y = higgs_like(200_000, seed=2)
        booster = train_booster(X, y, BoosterConfig(
            objective="binary", num_iterations=10, num_leaves=31),
            device=dev)
    t0 = time.perf_counter()
    models = onnx_models(dev, card)
    fixtures = onnx_fixtures(dev, card)
    tree = onnx_tree_ensemble(booster, dev, card)
    return dict(models=models, fixtures=fixtures, tree=tree)


# ---------------------------------------------------------------------------
# phase 19: the streamed (out-of-core) GBDT on HIGGS-shaped rows
# ---------------------------------------------------------------------------

def stream_source(rows: int, seed: int, chunk_rows: int = None):
    """A re-iterable HIGGS-shaped chunk source (``higgs_like`` of seed
    ``(seed, k)`` for chunk k): the raw floats exist one chunk at a time."""
    step = chunk_rows or STREAM_SOURCE_ROWS

    def batches():
        for k, a in enumerate(range(0, rows, step)):
            yield higgs_like(min(step, rows - a), seed=(seed, k))

    return batches


def _whole(source):
    """Every chunk of ``source`` concatenated: (X, y)."""
    parts = list(source())
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def sketch_prefix_check(cfg) -> None:
    """The streaming sketch over a 150k-row prefix of the stream, in ragged
    chunks (its exact regime) against ``compute_bin_mapper`` of the same
    rows: boundaries byte for byte."""
    from synapseml_tpu_torch.ops.quantize import (StreamingQuantileSketch,
                                                  compute_bin_mapper)

    X = higgs_like(STREAM_PREFIX_ROWS, seed=(STREAM_SEED, 0))[0]
    sk = StreamingQuantileSketch(FEATURES, cfg.max_bin, cfg.bin_sample_count,
                                 seed=cfg.seed)
    for a in range(0, STREAM_PREFIX_ROWS, 40_000):
        sk.update(X[a:a + 40_000])
    got = sk.finalize()
    want = compute_bin_mapper(X, cfg.max_bin, cfg.bin_sample_count,
                              seed=cfg.seed)
    same = (sk.exact and got.boundaries.tobytes() == want.boundaries.tobytes()
            and np.array_equal(got.num_bins, want.num_bins)
            and np.array_equal(got.nan_bins, want.nan_bins))
    log(f"  sketch over a {STREAM_PREFIX_ROWS}-row prefix: exact="
        f"{sk.exact}, boundaries byte-identical to compute_bin_mapper: "
        f"{same}")
    if not same:
        raise AssertionError("the streaming sketch's exact regime differs "
                             "from compute_bin_mapper")


def streamed_fit(label: str, ds, cfg, dev: str, kernels,
                 resident: bool = False) -> dict:
    """One ``train_booster_streamed`` fit with its readings: counts zeroed
    just before and read just after, each histogram launch timed (CUDA
    events), peak device memory, and the pump's per-pass copy and exposed
    wait times."""
    from synapseml_tpu_torch.gbdt import train_booster_streamed
    from synapseml_tpu_torch.ops import hist_kernel as hk

    if _on_card(dev):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with kernel_timer(dev) as events:
        hk.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        booster = train_booster_streamed(ds, cfg, resident=resident,
                                         device=dev)
        _sync(dev)
        fit_s = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
    kernel_ms = sum(timed_ms(events).values())
    peak = _peak_gib(dev)
    md = booster.metadata["streamed"]
    ntrees = booster.num_trees
    bin_passes = md["passes"] - ntrees          # less the score updates
    passes = md.get("transfer", [])
    h2d = sum(p["h2d_ms"] for p in passes)
    wall = sum(p["wall_ms"] for p in passes)
    exposed = sum(p["exposed_ms"] for p in passes)
    waited = sum(p["producer_wait_ms"] for p in passes)
    log(f"  {label}: fit_s={fit_s:.3f} row_iterations/s="
        f"{md['rows'] * ntrees / fit_s:.0f} trees={ntrees} splits/tree="
        f"{np.mean([int(t.num_splits) for t in booster.trees]):.1f} "
        f"passes/tree={md['passes'] / ntrees:.2f} (bins "
        f"{bin_passes / ntrees:.2f} + 1 score update) chunks={md['num_chunks']}"
        f" x {md['chunk_rows']} rows host_syncs/tree="
        f"{booster.metadata['host_syncs'] / ntrees:.1f}")
    log(f"    launches {json.dumps(launches)}; histogram kernels "
        f"{kernel_ms / ntrees:.3f} ms/iteration; peak device memory "
        f"{peak:.3f} GiB")
    if passes:
        log(f"    {len(passes)} pumped passes: H2D copy {h2d / len(passes):.3f}"
            f" ms/pass (CUDA events, side stream) against a pass wall of "
            f"{wall / len(passes):.3f} ms; exposed transfer (compute stream "
            f"waiting on copy events) {exposed:.3f} ms in all = "
            f"{exposed / (fit_s * 1e3):.2%} of the fit, "
            f"{exposed / ntrees:.3f} ms/iteration; the host waiting for "
            f"the producer thread (pinned fill) {waited / len(passes):.3f} "
            f"ms/pass = {waited / (fit_s * 1e3):.2%} of the fit; first passes "
            f"{json.dumps([{k: round(v, 3) if isinstance(v, float) else v for k, v in p.items()} for p in passes[:3]])}")
    _check_launches(launches, kernels)
    return dict(booster=booster, fit_s=fit_s, launches=launches, peak=peak,
                kernel_ms=kernel_ms, exposed_ms=exposed, h2d_ms=h2d,
                producer_wait_ms=waited)


def _heldout_auc(booster, Xv, yv, dev: str) -> float:
    from synapseml_tpu_torch.gbdt.objectives import auc

    return float(auc(torch.as_tensor(yv), torch.as_tensor(
        booster.predict(Xv))))


def stream_cross_check(dev: str) -> None:
    """The streamed leaf-wise fit at 100k rows, 3 iterations, on the card and
    on the CPU (plain versions): held-out AUCs within 1e-3."""
    import dataclasses

    from synapseml_tpu_torch.gbdt import BoosterConfig, StreamedDataset
    from synapseml_tpu_torch.gbdt import train_booster_streamed

    cfg = BoosterConfig(objective="binary", num_iterations=STREAM_CROSS_ITERS,
                        num_leaves=31, max_bin=255)
    ds = StreamedDataset(stream_source(STREAM_CROSS_ROWS, STREAM_CROSS_SEED,
                                       STREAM_CROSS_ROWS // 4),
                         num_features=FEATURES)
    Xv, yv = higgs_like(STREAM_CROSS_ROWS // 2, seed=(STREAM_CROSS_SEED, 99))
    aucs = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        b = train_booster_streamed(ds, dataclasses.replace(cfg), device=d)
        aucs[d] = _heldout_auc(b, Xv, yv, d)
        log(f"  streamed {d}: held-out AUC={aucs[d]:.6f} fit+predict "
            f"{time.perf_counter() - t0:.3f}s")
    gap = abs(aucs[dev] - aucs["cpu"])
    log(f"  streamed card against CPU: |AUC diff|={gap:.3g}")
    if gap > STREAM_AUC_TOL:
        raise AssertionError("streamed fits on the card and the CPU disagree")


def stream_path(dev: str, rows: int = None) -> dict:
    """Phase 19 (module docstring)."""
    import dataclasses

    from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                          predict_streamed, train_booster)
    from synapseml_tpu_torch.models import LightGBMClassifier

    t_phase = time.perf_counter()
    rows = rows or STREAM_ROWS
    cfg = BoosterConfig(objective="binary", num_iterations=STREAM_ITERS,
                        num_leaves=31, max_bin=255)
    sketch_prefix_check(cfg)
    source = stream_source(rows, STREAM_SEED)
    ds = StreamedDataset(source, num_features=FEATURES)
    t0 = time.perf_counter()
    ds.prepare(cfg, device=dev)
    secs = {k: round(v, 3) for k, v in ds.ingest_seconds.items()}
    log(f"  StreamedDataset over {ds.n_rows} rows in {len(ds.chunks)} chunks"
        f" of {ds.chunk_rows} rows: prepare {time.perf_counter() - t0:.3f}s "
        f"({json.dumps(secs)}; sketch pass, bin-and-cache pass), sketch "
        f"exact={ds.sketch_exact}, host cache {ds.cache_bytes() / 2**20:.1f}"
        f" MiB, chunk rows decision {json.dumps(ds.chunk_decision)}, second"
        f" pass {json.dumps(ds.second_pass_decision)}")
    Xv, yv = _whole(stream_source(STREAM_VALID_ROWS, STREAM_VALID_SEED))

    lw = streamed_fit("leaf-wise streamed", ds, cfg, dev, MAIN_KERNELS[:1])
    a_lw = _heldout_auc(lw["booster"], Xv, yv, dev)
    dw = streamed_fit("depthwise streamed", ds,
                      dataclasses.replace(cfg, growth_policy="depthwise"),
                      dev, DEPTHWISE_KERNELS)
    a_dw = _heldout_auc(dw["booster"], Xv, yv, dev)
    rs = streamed_fit("leaf-wise resident mode", ds, cfg, dev,
                      MAIN_KERNELS[:1], resident=True)
    a_rs = _heldout_auc(rs["booster"], Xv, yv, dev)
    log(f"  held-out AUC ({STREAM_VALID_ROWS} rows): leaf-wise streamed "
        f"{a_lw:.6f}, depthwise streamed {a_dw:.6f}, resident mode "
        f"{a_rs:.6f}; peak GiB streamed {lw['peak']:.3f} against resident "
        f"mode {rs['peak']:.3f}")
    if abs(a_rs - a_lw) > STREAM_AUC_TOL:
        raise AssertionError("resident mode and streamed AUCs disagree")
    if _on_card(dev) and not lw["peak"] < rs["peak"]:
        raise AssertionError("the streamed fit's peak memory is not below "
                             "the resident mode's")

    # the classic resident path on the same rows: the classifier (its own
    # 200k-row bin sample), and train_booster on the streamed dataset's
    # boundaries, which the cross-path bound holds (two bin samples alone
    # move the AUC past it)
    t0 = time.perf_counter()
    X, y = _whole(source)
    table = table_of(X, y)
    made_s = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    same_bins = train_booster(X, y, dataclasses.replace(cfg), mapper=ds.mapper,
                              device=dev)
    _sync(dev)
    same_bins_s = time.perf_counter() - t0
    del X, y
    a_sb = _heldout_auc(same_bins, Xv, yv, dev)
    log(f"  resident train_booster on the sketch's boundaries: fit_s="
        f"{same_bins_s:.3f} held-out AUC {a_sb:.6f}, streamed {a_lw:.6f}, "
        f"|diff|={abs(a_sb - a_lw):.3g}")
    if abs(a_sb - a_lw) > STREAM_AUC_TOL:
        raise AssertionError("the streamed and the resident fits on the "
                             "same boundaries differ past the cross-path "
                             "bound")
    if _on_card(dev):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    model = LightGBMClassifier(numIterations=STREAM_ITERS, numLeaves=31,
                               maxBin=255, device=dev).fit(table)
    _sync(dev)
    classic_s = time.perf_counter() - t0
    del table
    a_cl = _heldout_auc(model.booster, Xv, yv, dev)
    spans = {k: round(v, 3)
             for k, v in model.booster.metadata["measures"].items()}
    log(f"  classic LightGBMClassifier on the same {rows} rows: fit_s="
        f"{classic_s:.3f} row_iterations/s={rows * STREAM_ITERS / classic_s:.0f}"
        f" (table made in {made_s:.1f}s) spans {json.dumps(spans)} peak "
        f"{_peak_gib(dev):.3f} GiB; held-out AUC {a_cl:.6f} on its own bin "
        f"sample, streamed {a_lw:.6f}, |diff|={abs(a_cl - a_lw):.3g}")

    stream_cross_check(dev)
    t0 = time.perf_counter()
    got = np.concatenate(list(predict_streamed(
        lw["booster"], (Xv[a:a + 100_000] for a in range(0, len(Xv),
                                                         100_000)))))
    want = lw["booster"].predict(Xv)
    gap = float(np.abs(got - want).max())
    log(f"  predict_streamed over {len(Xv)} held-out rows: "
        f"{time.perf_counter() - t0:.3f}s, max |diff| to predict={gap:.3g}")
    if got.shape != want.shape or gap > STREAM_PREDICT_TOL:
        raise AssertionError("predict_streamed differs from predict")
    return dict(leafwise=lw["launches"], depthwise=dw["launches"], auc=a_lw)


# ---------------------------------------------------------------------------
# phase 20: GBDT across ranks and layouts
# ---------------------------------------------------------------------------

def partition_primitive_check(dev: str) -> dict:
    """Each stable-partition primitive's source indices against
    ``torch.argsort(stable=True)``'s on ``PARTITION_KEYS`` random keys in
    {-1, 0, 1, 2} on ``dev``, exactly; ms per call on the card."""
    from synapseml_tpu_torch.gbdt.grower import (PARTITION_IMPLS,
                                                 stable_partition_src)

    gen = torch.Generator(device=dev).manual_seed(20)
    key = torch.randint(-1, 3, (PARTITION_KEYS,), generator=gen, device=dev)
    want = torch.argsort(key, stable=True)
    out = {}
    for impl in PARTITION_IMPLS:
        got = stable_partition_src(key, impl)
        if not torch.equal(got, want):
            raise AssertionError(f"partition_impl={impl!r}: source indices "
                                 "differ from argsort(stable=True)'s")
        out[impl] = (time_ms(lambda i=impl: stable_partition_src(key, i), 5)
                     if _on_card(dev) else 0.0)
    log(f"  partition primitives on {PARTITION_KEYS} keys: each exactly "
        f"argsort(stable=True)'s source indices; ms per call "
        f"{json.dumps({k: round(v, 4) for k, v in out.items()})}")
    return out


def layout_fits(X, y, Xe, ye, dev: str) -> dict:
    """Phase 20 (a): one ``train_booster`` fit per run of ``LAYOUT_RUNS`` on
    the rows ``X`` binned once, with its readings: fit s, histogram kernel
    ms per iteration (CUDA events), launches (counts zeroed just before the
    fit, read just after), host syncs per tree, held-out AUC."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, Dataset, train_booster
    from synapseml_tpu_torch.ops import hist_kernel as hk

    ds = Dataset(X, y, device=dev)
    fits = {}
    for name, kw in LAYOUT_RUNS:
        cfg = BoosterConfig(objective="binary", num_iterations=LAYOUT_ITERS,
                            num_leaves=31, max_bin=255, **kw)
        with kernel_timer(dev) as events:
            hk.reset_launch_counts()
            _sync(dev)
            t0 = time.perf_counter()
            b = train_booster(ds, None, cfg, device=dev)
            _sync(dev)
            fit_s = time.perf_counter() - t0
            launches = dict(hk.LAUNCHES)
        trees = b.num_trees
        fits[name] = dict(
            fit_s=fit_s, launches=launches,
            kernel_ms=sum(timed_ms(events).values()) / trees,
            syncs=b.metadata["host_syncs"] / trees,
            auc=_heldout_auc(b, Xe, ye, dev), shape=_tree_shape(b))
        log(f"  {name}: fit_s={fit_s:.3f} histogram kernels "
            f"{fits[name]['kernel_ms']:.3f} ms/iteration host_syncs/tree="
            f"{fits[name]['syncs']:.1f} held-out AUC {fits[name]['auc']:.6f}"
            f" launches {json.dumps(launches)}")
    return fits


def layout_checks(fits: dict) -> list:
    """Phase 20 (a)'s checks; the failures as strings. Every run launched
    ``child_histogram`` (the segmented partition runs ``range_histogram``
    too) and holds the partition fit's held-out AUC within
    ``LAYOUT_AUC_TOL``; its split features and bins equal the partition
    fit's, or, where the card's float32 sums broke a near tie, the break is
    logged and the AUC bound alone holds."""
    bad = []
    base = fits["partition"]
    for name, kw in LAYOUT_RUNS:
        f = fits[name]
        want = (MAIN_KERNELS if kw.get("row_layout", "partition")
                == "partition" and kw.get("use_segmented", True)
                else MAIN_KERNELS[:1])
        missing = [k for k in want if f["launches"][k] <= 0]
        if missing:
            bad.append(f"{name}: the path never launched {missing}")
        if abs(f["auc"] - base["auc"]) > LAYOUT_AUC_TOL:
            bad.append(f"{name}: held-out AUC {f['auc']:.6f} against "
                       f"partition's {base['auc']:.6f}")
        if f["shape"] != base["shape"]:
            tree = next(i for i, (a, b) in enumerate(zip(f["shape"],
                                                         base["shape"]))
                        if a != b)
            log(f"  {name}: splits differ from partition's from tree {tree}"
                " (a near tie broken by the card's float32 sums); held to "
                "the AUC bound alone")
    return bad


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gathered_mapper(X, cfg, nproc: int):
    """The bin mapper of ``nproc`` processes each holding an equal block of
    ``X``: ``compute_bin_mapper`` of each block's ``default_rng(seed)``
    sample, gathered in rank order, with the NaN bins of the whole table."""
    from synapseml_tpu_torch.ops.quantize import compute_bin_mapper

    blk = X.shape[0] // nproc
    per = max(1, min(blk, -(-cfg.bin_sample_count // nproc)))
    parts = []
    for r in range(nproc):
        sub = np.random.default_rng(cfg.seed).choice(blk, size=per,
                                                     replace=False)
        parts.append(X[r * blk:(r + 1) * blk][np.sort(sub)])
    return compute_bin_mapper(np.concatenate(parts), cfg.max_bin,
                              cfg.bin_sample_count, None, cfg.seed,
                              has_nan=np.isnan(X).any(axis=0),
                              min_data_in_bin=cfg.min_data_in_bin)


def _mapper_sha(mapper) -> str:
    import hashlib

    h = hashlib.sha256(np.asarray(mapper.boundaries).tobytes())
    h.update(np.asarray(mapper.num_bins).tobytes())
    h.update(np.asarray(mapper.nan_mask).tobytes())
    return h.hexdigest()


def _mp_cfg(policy: str):
    from synapseml_tpu_torch.gbdt import BoosterConfig

    return BoosterConfig(objective="binary", num_iterations=MP_ITERS,
                         num_leaves=31, max_bin=255, tree_learner="data",
                         growth_policy=policy)


def _mp_rank(rank: int, workdir: str, dev: str, port: int, rows: int,
             settings: dict) -> None:
    """One process of phase 20 (b): it joins the world through
    ``initialize_distributed`` and passes only its own rows of the
    ``rows`` table to each policy's fit."""
    import hashlib

    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.gbdt import boosting as tb
    from synapseml_tpu_torch.gbdt import grower as tg
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(f"127.0.0.1:{port}", MP_RANKS, rank,
                           timeout_s=600)
    mesh = make_mesh({"data": MP_RANKS}, device=dev)
    X, y = higgs_like(rows)
    blk = rows // MP_RANKS
    Xl, yl = X[rank * blk:(rank + 1) * blk], y[rank * blk:(rank + 1) * blk]
    del X, y
    Xe, _ = higgs_like(DIST_EVAL_ROWS, seed=1)
    report = {"runs": {}}
    for policy in ("leafwise", "depthwise"):
        hk.reset_launch_counts()
        tg.reset_wire_counts()
        _sync(dev)
        with kernel_timer(dev) as events:
            t0 = time.perf_counter()
            b = tb.train_booster(Xl, yl, _mp_cfg(policy), mesh=mesh,
                                 device=dev)
            _sync(dev)
            fit_s = time.perf_counter() - t0
            launches = dict(hk.LAUNCHES)
        np.save(os.path.join(workdir, f"mp_{policy}_{rank}.npy"),
                b.predict(Xe))
        report["runs"][policy] = dict(
            model_sha=hashlib.sha256(b.model_string().encode()).hexdigest(),
            mapper_sha=_mapper_sha(b.mapper), launches=launches,
            fit_s=fit_s, kernel_ms=sum(timed_ms(events).values()),
            wire=dict(tg.WIRE), trees=b.num_trees,
            spans=b.metadata["measures"], routing=b.metadata.get("routing"))
    with open(os.path.join(workdir, f"mp_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def mp_checks(reports: list, probs: dict, p_one: dict,
              mapper_sha: str) -> list:
    """Phase 20 (b)'s checks; the failures as strings: per policy the
    model strings equal across the processes, each process's mapper the
    gathered-sample one, its kernels launched, and rank 0's held-out
    probabilities within ``DIST_PROB_TOL`` of the one-process fit on that
    mapper."""
    bad = []
    for policy, kernels in (("leafwise", MAIN_KERNELS),
                            ("depthwise", DEPTHWISE_KERNELS)):
        runs = [r["runs"][policy] for r in reports]
        if len({x["model_sha"] for x in runs}) != 1:
            bad.append(f"multi-process {policy}: model strings differ "
                       "across ranks")
        for i, x in enumerate(runs):
            if x["mapper_sha"] != mapper_sha:
                bad.append(f"multi-process {policy}: rank {i}'s mapper is "
                           "not the gathered sample's")
            missing = [k for k in kernels if x["launches"][k] <= 0]
            if missing:
                bad.append(f"multi-process {policy}: rank {i} never "
                           f"launched {missing}")
        gap = float(np.abs(probs[policy] - p_one[policy]).max())
        if gap > DIST_PROB_TOL:
            bad.append(f"multi-process {policy}: probabilities {gap:.3g} "
                       f"from one process (tolerance {DIST_PROB_TOL})")
    return bad


def mp_path(rows: int, dev: str, Xe) -> tuple:
    """Phase 20 (b): ``MP_RANKS`` processes share the card through
    ``initialize_distributed``, each passing its block of the ``rows``
    table; one-process fits on the gathered-sample mapper beside them.
    Returns (failures, launches summed over ranks and policies)."""
    import torch.multiprocessing as tmp

    from synapseml_tpu_torch.gbdt import train_booster

    X, y = higgs_like(rows)
    mapper = gathered_mapper(X, _mp_cfg("leafwise"), MP_RANKS)
    p_one = {}
    for policy in ("leafwise", "depthwise"):
        t0 = time.perf_counter()
        p_one[policy] = train_booster(X, y, _mp_cfg(policy), mapper=mapper,
                                      device=dev).predict(Xe)
        log(f"  one process on the gathered-sample mapper, {policy}: "
            f"{time.perf_counter() - t0:.2f}s")
    del X, y
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        settings = {k: globals()[k] for k in _MESH_SETTINGS}
        tmp.spawn(_mp_rank, args=(workdir, dev, _free_port(), rows,
                                  settings), nprocs=MP_RANKS, join=True)
        log(f"  {MP_RANKS} processes spawned, trained and joined in "
            f"{time.perf_counter() - t0:.1f}s")
        reports = []
        for r in range(MP_RANKS):
            with open(os.path.join(workdir, f"mp_{r}.json")) as f:
                reports.append(json.load(f))
        probs = {p: np.load(os.path.join(workdir, f"mp_{p}_0.npy"))
                 for p in ("leafwise", "depthwise")}
    launches = {k: 0 for k in MAIN_KERNELS + DEPTHWISE_KERNELS}
    for policy in ("leafwise", "depthwise"):
        for i, r in enumerate(reports):
            x = r["runs"][policy]
            for k in launches:
                launches[k] += x["launches"][k]
            it = max(x["trees"], 1)
            loop = x["spans"]["trainingIterations"] * 1e3 / it
            kernel = x["kernel_ms"] / it
            coll = x["wire"]["seconds"] * 1e3 / it
            gather = x["spans"].get("nodeGather", 0.0) * 1e3 / it
            log(f"  multi-process {policy} rank {i}: fit {x['fit_s']:.3f} s,"
                f" referenceDataset "
                f"{x['spans'].get('referenceDataset', 0.0):.3f} s (the "
                f"gathered sample), dataPreparation "
                f"{x['spans'].get('dataPreparation', 0.0):.3f} s; per "
                f"iteration {loop:.2f} ms = histogram kernels {kernel:.2f} "
                f"+ histogram collectives {coll:.2f} + leaf gather "
                f"{gather:.2f} + rest {loop - kernel - coll - gather:.2f}; "
                f"{x['wire']['collectives'] / it:.1f} collectives a tree; "
                f"launches {json.dumps(x['launches'])}; routing "
                f"{json.dumps(x['routing'])}")
    bad = mp_checks(reports, probs, p_one, _mapper_sha(mapper))
    for policy in ("leafwise", "depthwise"):
        log(f"  multi-process {policy} against one process: max |dp| "
            f"{float(np.abs(probs[policy] - p_one[policy]).max()):.3g}")
    return bad, launches


def _mesh_runs(cfg):
    """(name, dataset key, config, resident) of phase 20 (c)'s fits."""
    import dataclasses

    # the depthwise run streams the prefix, to keep the script inside its
    # time budget
    return [("leafwise", "all", cfg, False),
            ("resident", "all", cfg, True),
            ("depthwise", "prefix",
             dataclasses.replace(cfg, growth_policy="depthwise"), False)] + [
        (f"{w}_prefix", "prefix",
         dataclasses.replace(cfg, hist_allreduce_dtype=w), False)
        for w in ("f32", "bf16", "int8")]


def _mesh_stream_rank(rank: int, workdir: str, dev: str,
                      settings: dict) -> None:
    """One rank of phase 20 (c): phase 19's stream (and its
    ``MESH_LOSSY_ROWS`` prefix) over the mesh; every rank gets the same
    source and streams its block of every chunk."""
    import dataclasses
    import hashlib

    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.gbdt import (BoosterConfig, StreamedDataset,
                                          train_booster_streamed)
    from synapseml_tpu_torch.gbdt import grower as tg
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed("gloo", os.path.join(workdir, "store"), rank,
                     MESH_RANKS, timeout_s=900)
    mesh = make_mesh({"data": MESH_RANKS}, device=dev)
    cfg = BoosterConfig(objective="binary", num_iterations=STREAM_ITERS,
                        num_leaves=31, max_bin=255)
    Xv, yv = _whole(stream_source(STREAM_VALID_ROWS, STREAM_VALID_SEED))
    data = {"prefix": StreamedDataset(stream_source(MESH_LOSSY_ROWS,
                                                    STREAM_SEED),
                                      num_features=FEATURES,
                                      chunk_rows=MESH_CHUNK_ROWS)}
    if STREAM_ROWS != MESH_LOSSY_ROWS:
        data["all"] = StreamedDataset(stream_source(STREAM_ROWS,
                                                    STREAM_SEED),
                                      num_features=FEATURES)
    report = {"ingest": {}, "runs": {}}
    for key, ds in data.items():
        t0 = time.perf_counter()
        ds.prepare(cfg, row_multiple=MESH_RANKS,
                   row_block=(rank, MESH_RANKS), device=dev)
        report["ingest"][key] = dict(
            prepare_s=time.perf_counter() - t0,
            seconds=dict(ds.ingest_seconds), cache_bytes=ds.cache_bytes(),
            rows=ds.n_rows, chunks=len(ds.chunks),
            chunk_rows=ds.chunk_rows, block_rows=ds.block_rows)
    for name, key, c, resident in _mesh_runs(cfg):
        if key not in data:
            key = "prefix"       # the whole stream is the prefix
        if name == "f32_prefix" and "all" not in data:
            # the prefix's f32 fit is the leaf-wise fit on the same rows
            report["runs"][name] = dict(report["runs"]["leafwise"])
            continue
        if _on_card(dev):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        hk.reset_launch_counts()
        tg.reset_wire_counts()
        _sync(dev)
        with kernel_timer(dev) as events:
            t0 = time.perf_counter()
            b = train_booster_streamed(data[key], dataclasses.replace(c),
                                       mesh=mesh, resident=resident,
                                       device=dev)
            _sync(dev)
            fit_s = time.perf_counter() - t0
            launches = dict(hk.LAUNCHES)
        md = b.metadata["streamed"]
        report["runs"][name] = dict(
            model_sha=hashlib.sha256(b.model_string().encode()).hexdigest(),
            launches=launches, fit_s=fit_s,
            kernel_ms=sum(timed_ms(events).values()), wire=dict(tg.WIRE),
            trees=b.num_trees, rows=md["rows"], passes=md["passes"],
            transfer=md.get("transfer", []), peak=_peak_gib(dev),
            auc=_heldout_auc(b, Xv, yv, dev))
    # the decisive fixture streamed in four chunks: each wire's trees
    Xd, yd = decisive_table(DIST_DECISIVE_ROWS)
    report["identity"] = {wire: _tree_shape(train_booster_streamed(
        StreamedDataset.from_arrays(Xd, yd, chunk_rows=DIST_DECISIVE_ROWS // 4),
        BoosterConfig(**DIST_DECISIVE_CFG, hist_allreduce_dtype=wire),
        mesh=mesh, device=dev)) for wire in ("f32", "bf16", "int8")}
    with open(os.path.join(workdir, f"mesh_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def mesh_stream_checks(reports: list, stream_auc: float) -> list:
    """Phase 20 (c)'s checks; the failures as strings: every fit's model
    strings equal across the ranks and its kernels launched on each; the
    leaf-wise held-out AUC within ``STREAM_AUC_TOL`` of the one-process
    streamed fit's (``stream_auc``) and of resident mode's on the ranks;
    on the prefix each lossy wire's within ``MESH_WIRE_AUC_GAP`` of the
    f32 fit's, and on the decisive fixture its trees the f32 trees."""
    bad = []
    for name in reports[0]["runs"]:
        kernels = (DEPTHWISE_KERNELS if name == "depthwise"
                   else MAIN_KERNELS[:1])
        runs = [r["runs"][name] for r in reports]
        if len({x["model_sha"] for x in runs}) != 1:
            bad.append(f"mesh-streamed {name}: model strings differ across "
                       "ranks")
        for i, x in enumerate(runs):
            missing = [k for k in kernels if x["launches"][k] <= 0]
            if missing:
                bad.append(f"mesh-streamed {name}: rank {i} never launched "
                           f"{missing}")
    auc = {name: x["auc"] for name, x in reports[0]["runs"].items()}
    for name, want, what, tol in (
            ("leafwise", stream_auc, "the one-process streamed fit's",
             STREAM_AUC_TOL),
            ("leafwise", auc["resident"], "resident mode's on the ranks",
             STREAM_AUC_TOL),
            ("bf16_prefix", auc["f32_prefix"], "f32's on the same rows",
             MESH_WIRE_AUC_GAP),
            ("int8_prefix", auc["f32_prefix"], "f32's on the same rows",
             MESH_WIRE_AUC_GAP)):
        if abs(auc[name] - want) > tol:
            bad.append(f"mesh-streamed {name}: held-out AUC "
                       f"{auc[name]:.6f} against {what} {want:.6f}")
    ident = reports[0]["identity"]
    if ident["bf16"] != ident["f32"]:
        bad.append("mesh-streamed decisive fixture: bf16 trees differ from "
                   "f32's")
    if not same_splits_within_a_bin(ident["int8"], ident["f32"]):
        bad.append("mesh-streamed decisive fixture: int8 trees differ from "
                   "f32's by more than a bin")
    return bad


def same_splits_within_a_bin(got: list, want: list) -> bool:
    """``_tree_shape`` lists with the same split features and structure,
    each split's bin within one of ``want``'s: on the decisive fixture
    streamed over two ranks the JAX package's own int8 wire moves a
    threshold by one bin in trees 1 and 2 against its f32 wire."""
    if len(got) != len(want):
        return False
    for (f, b, lc, rc), (f2, b2, lc2, rc2) in zip(got, want):
        if (f, lc, rc) != (f2, lc2, rc2) or len(b) != len(b2) or any(
                abs(x - y) > 1 for x, y in zip(b, b2)):
            return False
    return True


def mesh_stream_path(dev: str, stream_auc: float) -> tuple:
    """Phase 20 (c): ``train_booster_streamed(mesh=...)`` on
    ``MESH_RANKS`` gloo ranks sharing the card. Returns (failures,
    launches summed over ranks and fits)."""
    import torch.multiprocessing as tmp

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        settings = {k: globals()[k] for k in _MESH_SETTINGS}
        tmp.spawn(_mesh_stream_rank, args=(workdir, dev, settings),
                  nprocs=MESH_RANKS, join=True)
        log(f"  {MESH_RANKS} ranks spawned, streamed and joined in "
            f"{time.perf_counter() - t0:.1f}s")
        reports = []
        for r in range(MESH_RANKS):
            with open(os.path.join(workdir, f"mesh_{r}.json")) as f:
                reports.append(json.load(f))
    launches = {k: 0 for k in MAIN_KERNELS + DEPTHWISE_KERNELS}
    for i, r in enumerate(reports):
        for key, ing in r["ingest"].items():
            log(f"  rank {i} {key}: {ing['rows']} rows in {ing['chunks']} "
                f"chunks of {ing['chunk_rows']}, its block {ing['block_rows']}"
                f" rows a chunk; prepare {ing['prepare_s']:.3f}s "
                f"({json.dumps({k: round(v, 3) for k, v in ing['seconds'].items()})};"
                f" sketch pass, bin-and-cache pass); host cache "
                f"{ing['cache_bytes'] / 2**20:.1f} MiB")
        for name, x in r["runs"].items():
            for k in launches:
                launches[k] += x["launches"][k]
            trees = max(x["trees"], 1)
            bin_passes = max(x["passes"] - trees, 1)
            passes = x["transfer"]
            per = (lambda key: sum(p[key] for p in passes) / len(passes)
                   if passes else 0.0)
            log(f"  rank {i} {name}: fit_s={x['fit_s']:.3f} "
                f"row_iterations/s={x['rows'] * trees / x['fit_s']:.0f} "
                f"held-out AUC {x['auc']:.6f}; per pass wall "
                f"{per('wall_ms'):.3f} ms, H2D copy {per('h2d_ms'):.3f} ms, "
                f"host waiting on the producer {per('producer_wait_ms'):.3f}"
                f" ms, collectives "
                f"{x['wire']['seconds'] * 1e3 / bin_passes:.3f} ms "
                f"({x['wire']['collectives'] / trees:.1f} a tree), kernels "
                f"{x['kernel_ms'] / bin_passes:.3f} ms; peak "
                f"{x['peak']:.3f} GiB; launches {json.dumps(x['launches'])}")
    reference = MESH_REFERENCE_AUC.get(MESH_LOSSY_ROWS)
    bad = mesh_stream_checks(reports, stream_auc)
    auc = {name: round(x["auc"], 6) for name, x in reports[0]["runs"].items()}
    log(f"  held-out AUC on the ranks {json.dumps(auc)}; the one-process "
        f"streamed fit's {stream_auc:.6f}; the JAX package's on the prefix "
        f"{json.dumps(reference)}; lossy wires against f32 on the prefix "
        + ", ".join(f"{w} {auc[w + '_prefix'] - auc['f32_prefix']:+.6f}"
                    for w in ("bf16", "int8"))
        + "; decisive fixture: bf16 trees = f32 trees, int8's within a "
        "bin of them")
    return bad, launches


def ranks_layouts_path(rows: int, dev: str, stream_auc: float = None) -> dict:
    """Phase 20 (module docstring): (a), (b) and (c), every failure of
    the three collected and raised at the end."""
    t_phase = time.perf_counter()
    log("  (a) the leaf-wise hot-loop designs on one process")
    partition_primitive_check(dev)
    X, y = higgs_like(rows)
    Xe, ye = higgs_like(DIST_EVAL_ROWS, seed=1)
    fits = layout_fits(X, y, Xe, ye, dev)
    del X, y
    bad = layout_checks(fits)
    base = fits["partition"]["kernel_ms"]
    if base:
        log("  histogram kernel ms per iteration against partition's "
            f"{base:.3f}: " + ", ".join(
                f"{k} {f['kernel_ms'] / base:.2f}x" for k, f in fits.items()))
    launches = {k: sum(f["launches"][k] for f in fits.values())
                for k in MAIN_KERNELS + DEPTHWISE_KERNELS}
    log(f"  [{time.perf_counter() - t_phase:.1f}s] (b) the multi-process "
        f"contract: {MP_RANKS} processes, each its own {rows // MP_RANKS} "
        "rows")
    if _on_card(dev):
        torch.cuda.empty_cache()
    mp_bad, mp_launches = mp_path(rows, dev, Xe)
    log(f"  [{time.perf_counter() - t_phase:.1f}s] (c) phase 19's stream "
        f"over a mesh of {MESH_RANKS} ranks")
    if _on_card(dev):
        torch.cuda.empty_cache()
    ms_bad, ms_launches = mesh_stream_path(
        dev, STREAM_REFERENCE_AUC if stream_auc is None else stream_auc)
    for k in launches:
        launches[k] += mp_launches[k] + ms_launches[k]
    log(f"  launches on phase 20's paths, every rank: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        bad.append(f"phase 20's paths never launched {missing}")
    bad += mp_bad + ms_bad
    if bad:
        raise AssertionError("phase 20: " + "; ".join(bad))
    return dict(launches=launches, layouts=fits)


# ---------------------------------------------------------------------------
# phase 21: pipeline-parallel DL and elastic training
# ---------------------------------------------------------------------------

class _Hang:
    """A hang planted through ``parallel.collectives._CHAOS_HOOK``: the
    ``at_call``-th call whose op starts with ``op`` blocks until released
    (leaving the context releases it), then raises, so the abandoned
    worker thread moves no data."""

    def __init__(self, op: str, at_call: int = 1, hang_s: float = 60.0):
        self.op, self.at_call, self.hang_s = op, at_call, hang_s
        self.calls, self.hung = 0, []
        self._release = threading.Event()

    def _hook(self, name: str) -> None:
        if not name.startswith(self.op):
            return
        self.calls += 1
        if self.calls == self.at_call:
            self.hung.append(name)
            self._release.wait(self.hang_s)
            raise RuntimeError(f"hung {name} released")

    def __enter__(self):
        from synapseml_tpu_torch.parallel import collectives as c

        c._CHAOS_HOOK = self._hook
        return self

    def __exit__(self, *exc):
        from synapseml_tpu_torch.parallel import collectives as c

        c._CHAOS_HOOK = None
        self._release.set()


def _pipe_settings() -> dict:
    """The settings phase 21's ranks share with this process (they import
    this module afresh; a rehearsal's are smaller)."""
    return {k: globals()[k] for k in _PIPE_SETTINGS}


def pipe_vision_model():
    from synapseml_tpu_torch.dl import make_staged_backbone

    return make_staged_backbone(PIPE_BACKBONE, VISION_CLASSES, 2,
                                width=PIPE_WIDTH)


def pipe_trainer(init: dict, dev: str, mesh=None, **kw):
    """A ``Trainer`` of the staged vision model from ``init`` (float32, adam
    1e-3, batch ``PIPE_BATCH``, everything trained)."""
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    model = pipe_vision_model()
    model.load_state_dict(init)
    cfg = dict(batch_size=PIPE_BATCH, max_epochs=1, learning_rate=1e-3,
               optimizer="adam", seed=0)
    cfg.update(kw)
    return Trainer(model, TrainConfig(**cfg), mesh=mesh, device=dev)


def _step_log(tag: str, rank: int, steps: list, batch: int) -> list:
    """Log a pipeline fit's steps on one rank; returns its lines' numbers
    (ms, share, bytes, images/s) per step."""
    out = []
    for st in steps:
        row = dict(step=st["step"], loss=st["loss"],
                   forward_ms=st["forward_s"] * 1e3,
                   backward_ms=st["backward_s"] * 1e3,
                   hop_ms=st["hop_s"] * 1e3,
                   hop_wait_ms=st["hop_wait_s"] * 1e3,
                   update_ms=st["update_s"] * 1e3,
                   wall_ms=st["wall_s"] * 1e3, idle=st["idle_share"],
                   collective_ms=st["collective_s"] * 1e3,
                   hops=st["hops"], hop_bytes=st["hop_bytes"],
                   per_s=batch / st["wall_s"])
        log(f"  {tag} rank {rank} step {row['step']}: loss "
            f"{row['loss']:.7f} wall {row['wall_ms']:.2f} ms = forward "
            f"{row['forward_ms']:.2f} + backward {row['backward_ms']:.2f} + "
            f"hop {row['hop_ms']:.2f} + update {row['update_ms']:.2f} (CUDA "
            f"events) + idle; idle share {row['idle']:.3f}; collectives "
            f"{row['collective_ms']:.2f} ms; host in hops "
            f"{row['hop_wait_ms']:.2f} ms; {row['hops']} hops "
            f"{row['hop_bytes'] / 2**20:.2f} MiB; {row['per_s']:.1f} per s")
        out.append(row)
    return out


def _pipe_vision_rank(rank: int, workdir: str, dev: str,
                      settings: dict) -> None:
    """One rank of phase 21 (a) and (c): the staged vision model on
    ``{"stage": 2}``, the watchdog's parity and hang, and the two-rank
    GBDT killed at an iteration."""
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.core.checkpoint import PreemptionError
    from synapseml_tpu_torch.gbdt.boosting import BoosterConfig, train_booster
    from synapseml_tpu_torch.parallel import (CollectiveWatchdog,
                                              HeartbeatMonitor,
                                              HeartbeatWriter, PeerLostError,
                                              elastic_watchdog,
                                              init_distributed, make_mesh)

    globals().update(settings)
    if not _on_card(dev):
        torch.set_num_threads(1)     # a CPU rehearsal: ranks share cores
    torch.backends.cudnn.deterministic = True
    init_distributed("gloo", os.path.join(workdir, "store"), rank,
                     PIPE_RANKS, timeout_s=300)
    mesh = make_mesh({"stage": 2}, device=dev)
    init = torch.load(os.path.join(workdir, "init.pt"))
    X = np.load(os.path.join(workdir, "images.npy"))
    y = np.load(os.path.join(workdir, "labels.npy"))
    report = {}
    tr = pipe_trainer(init, dev, mesh, steps_per_epoch=PIPE_PARITY_STEPS,
                      param_sharding="pipeline", pipeline_microbatches=1)
    tr.fit(X, y)
    report["parity"] = [st["loss"] for st in tr.step_stats]
    for name, kw in PIPE_RUNS:
        if _on_card(dev):
            torch.cuda.empty_cache()
        _peak_gib(dev, reset=True)
        tr = pipe_trainer(init, dev, mesh, steps_per_epoch=PIPE_STEPS,
                          param_sharding="pipeline",
                          pipeline_microbatches=PIPE_MICRO, **kw)
        tr.fit(X, y)
        report[name] = dict(steps=tr.step_stats, peak_gib=_peak_gib(dev),
                            bytes=tr.stats["state_bytes_per_rank"],
                            schedule=tr.stats["schedule"])
    # (c) the same fill-drain fit under the watchdog, bitwise
    digests = []
    for wrapped in (False, True):
        tr = pipe_trainer(init, dev, mesh, steps_per_epoch=2,
                          param_sharding="pipeline",
                          pipeline_microbatches=PIPE_MICRO)
        if wrapped:
            wd = CollectiveWatchdog(timeout=120.0, writer=HeartbeatWriter(
                os.path.join(workdir, f"hb_ok_{rank}"), rank=rank))
            with elastic_watchdog(wd):
                tr.fit(X, y)
            report["wd_guarded"] = wd.ops_guarded
        else:
            tr.fit(X, y)
        digests.append(_digest(tr.model))
    report["wd_equal"] = digests[0] == digests[1]
    # (c) a hang planted in a hop, a stale peer on record
    hb = os.path.join(workdir, f"hb_hang_{rank}")
    peer = 1000 + rank
    HeartbeatWriter(hb, rank=peer).beat("transfer.hop")
    past = time.time() - 60
    os.utime(os.path.join(hb, f"hb_p{peer}.json"), (past, past))
    wd = CollectiveWatchdog(
        timeout=PIPE_HANG_BUDGET_S, writer=HeartbeatWriter(hb, rank=rank),
        monitor=HeartbeatMonitor(hb, timeout=2 * PIPE_HANG_BUDGET_S,
                                 expected=[rank, peer], self_rank=rank))
    tr = pipe_trainer(init, dev, mesh, steps_per_epoch=1,
                      param_sharding="pipeline",
                      pipeline_microbatches=PIPE_MICRO)
    t0 = time.perf_counter()
    try:
        with _Hang("transfer.hop") as hang, elastic_watchdog(wd):
            tr.fit(X, y)
        report["hang"] = None
    except PeerLostError as e:
        report["hang"] = dict(op=e.op, lost=e.lost, last=e.last_ops,
                              hung=hang.hung, peer=peer,
                              detect_s=time.perf_counter() - t0,
                              waited_s=e.waited_s)
    del tr
    torch.distributed.barrier()
    # (c) GBDT on two ranks, killed at an iteration
    Xg, yg = higgs_like(PIPE_GBDT_ROWS, seed=3)
    cfg = dict(objective="binary", num_iterations=PIPE_GBDT_ITERS,
               num_leaves=31, max_bin=255)
    gmesh = make_mesh({"data": PIPE_RANKS}, device=dev)
    ref = train_booster(Xg, yg, BoosterConfig(**cfg), mesh=gmesh,
                        device=dev)
    if rank == 0:
        np.save(os.path.join(workdir, "gbdt_ref.npy"), ref.raw_score(Xg))
    t0 = time.perf_counter()
    try:
        with preempt_at("gbdt.iteration", PIPE_GBDT_KILL):
            train_booster(Xg, yg, BoosterConfig(**cfg), mesh=gmesh,
                          device=dev, checkpoint_every=PIPE_GBDT_KILL,
                          checkpoint_store=os.path.join(workdir, "gbdt"))
        report["gbdt_killed"] = False
    except PreemptionError:
        report["gbdt_killed"] = True
    report["gbdt_killed_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"vision_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def pipe_vision(dev: str, workdir: str, failures: list) -> None:
    """Phase 21 (a) and (c) with the two vision ranks, checked here."""
    import torch.multiprocessing as tmp

    from synapseml_tpu_torch.dl.trainer import Trainer, TrainConfig
    from synapseml_tpu_torch.gbdt.boosting import BoosterConfig, train_booster

    t0 = time.perf_counter()
    model = pipe_vision_model()
    Trainer(model, TrainConfig(seed=0), device="cpu").init()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    X, y = state_images(PIPE_BATCH * PIPE_STEPS, seed=5)
    torch.save(init, os.path.join(workdir, "init.pt"))
    np.save(os.path.join(workdir, "images.npy"), X)
    np.save(os.path.join(workdir, "labels.npy"), y)
    log(f"  seeded {PIPE_BACKBONE} staged in 2 and {len(X)} images at "
        f"{VISION_SIZE}x{VISION_SIZE} in {time.perf_counter() - t0:.1f}s")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = pipe_trainer(init, dev, steps_per_epoch=PIPE_PARITY_STEPS)
        one.fit(X, y)
        ref = [st["loss"] for st in one.step_stats]
        del one
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if _on_card(dev):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp.spawn(_pipe_vision_rank, args=(workdir, dev, _pipe_settings()),
              nprocs=PIPE_RANKS, join=True)
    log(f"  {PIPE_RANKS} ranks spawned, trained and joined in "
        f"{time.perf_counter() - t0:.1f}s")
    reports = []
    for r in range(PIPE_RANKS):
        with open(os.path.join(workdir, f"vision_{r}.json")) as f:
            reports.append(json.load(f))
    for r, rep in enumerate(reports):
        gap = float(np.max(np.abs(np.subtract(rep["parity"], ref))))
        log(f"  (a) rank {r}: parity fit (M = 1, fill-drain) losses "
            f"{[round(v, 7) for v in rep['parity']]} against the replicated "
            f"Trainer's {[round(v, 7) for v in ref]}: max gap {gap:.3g} "
            f"(tolerance {PIPE_PARITY_TOL})")
        if not gap <= PIPE_PARITY_TOL:
            failures.append(f"(a) rank {r}: parity gap {gap}")
        for name, _ in PIPE_RUNS:
            x = rep[name]
            rows = _step_log(f"(a) {name}", r, x["steps"], PIPE_BATCH)
            warm = rows[1:] or rows
            log(f"  (a) {name} rank {r}: schedule {x['schedule']}, steps "
                f"after the first: wall {np.mean([w['wall_ms'] for w in warm]):.2f}"
                f" ms, idle share {np.mean([w['idle'] for w in warm]):.3f} "
                f"(analytic bubble (S-1)/(M+S-1) = "
                f"{1 / (PIPE_MICRO + 1):.3f}), "
                f"{np.mean([w['per_s'] for w in warm]):.1f} images/s, hop "
                f"{np.mean([w['hop_ms'] for w in warm]) / max(warm[0]['hops'], 1):.3f}"
                f" ms a hop; state at rest {x['bytes'] / 2**20:.1f} MiB; "
                f"peak {x['peak_gib']:.2f} GiB")
            if len(rows) != PIPE_STEPS or not all(
                    np.isfinite(w["loss"]) for w in rows):
                failures.append(f"(a) {name} rank {r}: steps {rows}")
        log(f"  (c) rank {r}: the fill-drain fit under elastic_watchdog "
            f"({rep.get('wd_guarded')} steps guarded) bitwise the plain "
            f"one: {rep['wd_equal']}")
        if not rep["wd_equal"]:
            failures.append(f"(c) rank {r}: the watchdog changed the fit")
        h = rep["hang"]
        if h is None:
            failures.append(f"(c) rank {r}: the hung hop was not detected")
        else:
            log(f"  (c) rank {r}: hang in {h['hung']} surfaced as "
                f"PeerLostError op {h['op']!r}, lost {h['lost']} (last op "
                f"{h['last']}), detected {h['detect_s']:.3f}s after the fit "
                f"began ({h['waited_s']:.3f}s after the step began; budget "
                f"{PIPE_HANG_BUDGET_S}s)")
            if (h["op"] != "dl.pipeline.step" or h["lost"] != [h["peer"]]
                    or h["hung"] != ["transfer.hop"]
                    or h["last"].get(str(h["peer"])) != "transfer.hop"
                    or h["waited_s"] > 2 * PIPE_HANG_BUDGET_S):
                failures.append(f"(c) rank {r}: hang report {h}")
        if not rep["gbdt_killed"]:
            failures.append(f"(c) rank {r}: the GBDT fit was not killed")
    want = np.load(os.path.join(workdir, "gbdt_ref.npy"))
    Xg, yg = higgs_like(PIPE_GBDT_ROWS, seed=3)
    t0 = time.perf_counter()
    got = train_booster(Xg, yg, BoosterConfig(
        objective="binary", num_iterations=PIPE_GBDT_ITERS, num_leaves=31,
        max_bin=255), device=dev, checkpoint_every=PIPE_GBDT_KILL,
        checkpoint_store=os.path.join(workdir, "gbdt")).raw_score(Xg)
    gap = float(np.max(np.abs(got - want)))
    log(f"  (c) GBDT killed on {PIPE_RANKS} ranks at iteration "
        f"{PIPE_GBDT_KILL} ({reports[0]['gbdt_killed_s']:.2f}s), resumed in "
        f"one process in {time.perf_counter() - t0:.2f}s: max |raw score "
        f"gap| against the uninterrupted two-rank fit {gap:.3g} (tolerance "
        f"{PIPE_GBDT_TOL})")
    if not gap <= PIPE_GBDT_TOL:
        failures.append(f"(c) GBDT resumed on one rank: gap {gap}")


def pipe_text_tokens(rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, PIPE_TEXT["vocab_size"],
                     size=(rows, PIPE_TEXT["max_len"])).astype(np.int32)
    return X, np.arange(rows) % 2


def pipe_text_trainer(init: dict, dev: str, mesh, **kw):
    from synapseml_tpu_torch.dl import staged_text_encoder
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    model = staged_text_encoder(**PIPE_TEXT)
    model.load_state_dict(init)
    cfg = dict(batch_size=PIPE_TEXT_BATCH, max_epochs=1, learning_rate=1e-4,
               optimizer="adamw", seed=0)
    cfg.update(kw)
    return Trainer(model, TrainConfig(**cfg), mesh=mesh, device=dev)


def _pipe_text_rank(rank: int, workdir: str, dev: str,
                    settings: dict) -> None:
    """One rank of phase 21 (b) and (c): the staged encoder on
    ``{"stage": 2, "seq": 2}``, ring and Ulysses under both schedules (the
    launch counts zeroed just before each fit and read just after), the
    same model on ``{"seq": 2}`` without a pipeline (ring on ranks 0 and 1
    while Ulysses runs on ranks 2 and 3), and a kill at epoch 2 and its
    resume."""
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.core.checkpoint import PreemptionError
    from synapseml_tpu_torch.ops import attention_kernel as ak
    from synapseml_tpu_torch.parallel import (collectives, init_distributed,
                                              make_mesh)

    globals().update(settings)
    if not _on_card(dev):
        torch.set_num_threads(1)     # a CPU rehearsal: ranks share cores
    init_distributed("gloo", os.path.join(workdir, "store_text"), rank,
                     PIPE_TEXT_RANKS, timeout_s=600)
    pipe = make_mesh({"stage": 2, "seq": 2}, device=dev)
    # the references without a pipeline, at once on the card: ring on
    # ranks 0 and 1, Ulysses on ranks 2 and 3
    seq = (make_mesh({"seq": 2}, device=dev, ranks=[0, 1])
           or make_mesh({"seq": 2}, device=dev, ranks=[2, 3]))
    init = torch.load(os.path.join(workdir, "text_init.pt"))
    X, y = pipe_text_tokens(PIPE_TEXT_BATCH * PIPE_TEXT_STEPS)
    variant = "ring" if rank < 2 else "ulysses"
    tr = pipe_text_trainer(init, dev, seq, seq_attention=variant)
    tr.fit(X, y)
    report = {"ref": [st["loss"] for st in tr.step_stats]}
    del tr
    torch.distributed.barrier()
    for variant in ("ring", "ulysses"):
        for sched in ("fill_drain", "overlap"):
            if _on_card(dev):
                torch.cuda.empty_cache()
            _peak_gib(dev, reset=True)
            tr = pipe_text_trainer(init, dev, pipe, seq_attention=variant,
                                   param_sharding="pipeline",
                                   pipeline_microbatches=PIPE_TEXT_MICRO,
                                   pipeline_schedule=sched)
            collectives.reset_staging_counts()
            ak.reset_launch_counts()
            _sync(dev)
            tr.fit(X, y)
            _sync(dev)
            report[f"{variant}/{sched}"] = dict(
                steps=tr.step_stats, launches=dict(ak.LAUNCHES),
                comm_s=dict(collectives.COMM_SECONDS),
                variant=tr.stats.get("seq_attention"),
                peak_gib=_peak_gib(dev))
            del tr
    # (c) killed at epoch 2, resumed on the same mesh
    ck = os.path.join(workdir, "text_ck")
    kw = dict(seq_attention="ring", param_sharding="pipeline",
              pipeline_microbatches=PIPE_TEXT_MICRO, max_epochs=3,
              steps_per_epoch=1)
    ref = pipe_text_trainer(init, dev, pipe, **kw).fit(X, y)
    want = _digest(ref.model)
    del ref
    t0 = time.perf_counter()
    try:
        with preempt_at("dl.epoch", 2):
            pipe_text_trainer(init, dev, pipe, checkpoint_dir=ck, **kw) \
                .fit(X, y)
        report["killed"] = False
    except PreemptionError:
        report["killed"] = True
    report["killed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = pipe_text_trainer(init, dev, pipe, checkpoint_dir=ck, **kw)
    got.fit(X, y)
    report["resumed_s"] = time.perf_counter() - t0
    report["resumed_epochs"] = [h["epoch"] for h in got.history]
    report["resume_equal"] = _digest(got.model) == want
    with open(os.path.join(workdir, f"text_{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def pipe_text(dev: str, workdir: str, failures: list) -> dict:
    """Phase 21 (b) and (c) with the four text ranks, checked here;
    returns the flash launches of the pipelines' ring fits
    (``flash_attention_block``) and Ulysses fits (``flash_attention``),
    summed over the ranks."""
    import torch.multiprocessing as tmp

    from synapseml_tpu_torch.dl import staged_text_encoder
    from synapseml_tpu_torch.dl.trainer import Trainer, TrainConfig

    t0 = time.perf_counter()
    model = staged_text_encoder(**PIPE_TEXT)
    Trainer(model, TrainConfig(seed=0), device="cpu").init()
    torch.save({k: v.clone() for k, v in model.state_dict().items()},
               os.path.join(workdir, "text_init.pt"))
    del model
    log(f"  seeded staged encoder {json.dumps(PIPE_TEXT)} in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tmp.spawn(_pipe_text_rank, args=(workdir, dev, _pipe_settings()),
              nprocs=PIPE_TEXT_RANKS, join=True)
    log(f"  {PIPE_TEXT_RANKS} ranks spawned, trained and joined in "
        f"{time.perf_counter() - t0:.1f}s")
    reports = []
    for r in range(PIPE_TEXT_RANKS):
        with open(os.path.join(workdir, f"text_{r}.json")) as f:
            reports.append(json.load(f))
    launches = {"flash_attention_block": 0, "flash_attention": 0}
    kernel = {"ring": "flash_attention_block", "ulysses": "flash_attention"}
    for variant in ("ring", "ulysses"):
        ref = reports[0 if variant == "ring" else 2]["ref"]
        log(f"  (b) {variant} on {{'seq': 2}} without a pipeline: losses "
            f"{[round(v, 7) for v in ref]}")
        for sched in ("fill_drain", "overlap"):
            for r, rep in enumerate(reports):
                x = rep[f"{variant}/{sched}"]
                tag = f"(b) {variant} {sched}"
                _step_log(tag, r, x["steps"], PIPE_TEXT_BATCH)
                comm = {k: round(v * 1e3, 2) for k, v in x["comm_s"].items()}
                log(f"  {tag} rank {r}: collectives inside the stages "
                    f"{json.dumps(comm)} ms, launches "
                    f"{json.dumps(x['launches'])}, peak "
                    f"{x['peak_gib']:.2f} GiB")
                losses = [st["loss"] for st in x["steps"]]
                gap = float(np.max(np.abs(np.subtract(losses, ref))))
                other = kernel["ulysses" if variant == "ring" else "ring"]
                if x["variant"] != variant:
                    failures.append(f"{tag} rank {r}: ran {x['variant']}")
                if not gap <= PIPE_TEXT_TOL:
                    failures.append(f"{tag} rank {r}: loss gap {gap}")
                if x["launches"][kernel[variant]] <= 0 \
                        or x["launches"][other] != 0:
                    failures.append(f"{tag} rank {r}: flash launches "
                                    f"{x['launches']}")
                launches[kernel[variant]] += x["launches"][kernel[variant]]
            log(f"  {tag}: losses within {PIPE_TEXT_TOL} of the fit "
                f"without a pipeline: max gap "
                f"{max(float(np.max(np.abs(np.subtract([st['loss'] for st in rep[f'{variant}/{sched}']['steps']], ref)))) for rep in reports):.3g}")
    for r, rep in enumerate(reports):
        log(f"  (c) rank {r}: text pipeline killed at epoch 2 "
            f"({rep['killed_s']:.1f}s), resumed epochs "
            f"{rep['resumed_epochs']} in {rep['resumed_s']:.1f}s, bitwise "
            f"the uninterrupted fit: {rep['resume_equal']}")
        if not (rep["killed"] and rep["resume_equal"]
                and rep["resumed_epochs"] == [2]):
            failures.append(f"(c) text rank {r}: kill/resume {rep}")
    return launches


def pipeline_path(dev: str) -> dict:
    """Phase 21: (a) the staged ResNet-50 on two ranks, (b) the staged
    encoder on four with both flash kernels inside the stages, (c) the
    elastic checks. Every failure is collected and raised at the end;
    returns the flash launches of (b)."""
    failures, seconds = [], {}
    launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        for name, fn in (("vision", lambda: pipe_vision(dev, workdir,
                                                        failures)),
                         ("text", lambda: launches.update(pipe_text(
                             dev, workdir, failures)))):
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - collected, raised below
                failures.append(f"{name}: {type(e).__name__}: {e}")
            seconds[name] = round(time.perf_counter() - t0, 1)
            if _on_card(dev):
                torch.cuda.empty_cache()
    log(f"  phase 21 seconds by part: {json.dumps(seconds)}; flash launches "
        f"in the pipelines' stages {json.dumps(launches)}")
    if failures:
        raise AssertionError("phase 21 failed:\n  " + "\n  ".join(failures))
    return launches


# ---------------------------------------------------------------------------
# phase 22: the serving fabric, VW and the online loop
# ---------------------------------------------------------------------------

# (a) the fabric across processes: phase 15's classifier (phase 12's
# booster) behind DistributedServingServer on two processes sharing the
# card; --phase 22 alone fits its own on FABRIC_ALONE_ROWS rows. Heartbeats
# every FABRIC_BEAT_S, eviction after FABRIC_EVICT_S of silence
FABRIC_RANKS = 2
FABRIC_ALONE_ROWS, FABRIC_ITERS = 500_000, 100
FABRIC_REQUESTS, FABRIC_KILL_REQUESTS = 3000, 3000
FABRIC_BEAT_S, FABRIC_EVICT_S = 0.2, 1.0
FABRIC_WAIT_S = 120.0
# (b) two federated gateways over the same workers: FED_REQUESTS one-row
# requests of FED_TENANTS tenants from FED_CLIENTS clients
FED_REQUESTS, FED_TENANTS, FED_CLIENTS = 1200, 8, 16
# (c) three tenants on two workers; each tenant's latency from
# FLEET_CLIENTS clients of FLEET_REQUESTS requests, before and during a
# FLEET_FLOOD-request flood of the VW tenant; the DL tenant is phase 18's
# ResNet-50 on FLEET_IMAGES preloaded seeded images, FLEET_DL_BATCH rows a
# graph
FLEET_REQUESTS, FLEET_CLIENTS, FLEET_FLOOD = 60, 4, 400
FLEET_IMAGES, FLEET_DL_BATCH = 16, 8
FLEET_RESNET = dict(depth=50, num_classes=1000, image_size=224)
FLEET_DL_REL = 1e-3          # phase 18's float32 bound, of max |y|
# (d) VW at full width on a Criteo-shaped table (the Criteo Display
# Advertising Challenge's 13 integer and 26 categorical columns), made in
# seeded chunks of CRITEO_CHUNK rows (a prefix is the same rows at any
# length), logistic loss, one pass at batch 256. The card against the CPU
# (atomics add repeated indices in no fixed order on the card): weights
# within CRITEO_CARD_TOL of max |w|, progressive loss CRITEO_LOSS_TOL
# relative. The mesh on CRITEO_MESH_ROWS rows over the two processes of
# (a), held-out AUC within CRITEO_MESH_AUC_GAP of one process on them: the
# average of two models that each saw half the rows against one that saw
# them all in order (0.0105 apart on a 40,000-row CPU rehearsal)
# CRITEO_ROWS 2,000,000 before phase 24 was added, 1,000,000 before phase
# 25 (the mesh's CRITEO_MESH_ROWS are all of them now)
CRITEO_ROWS, CRITEO_CHUNK = 500_000, 250_000
CRITEO_INTS, CRITEO_CATS = 13, 26
CRITEO_BITS, CRITEO_BATCH = (18, 24), 256
# the learning rate: at VWConfig's default 0.5 this table's 39 features a
# row overshoot (progressive loss 1.34 on 500,000 rows, above log 2), and
# two CPU passes that differ only in the order of their sums end 0.3% of
# max |w| apart; at 0.02 the loss is 0.569 and that gap 4e-7 (CPU runs)
CRITEO_LR = 0.02
CRITEO_MAX_CARD = 50_000
CRITEO_CARD_TOL, CRITEO_LOSS_TOL = 1e-4, 1e-5
CRITEO_MESH_ROWS, CRITEO_MESH_AUC_GAP = 500_000, 0.02
CRITEO_CPU_THREADS = 2
# (e) the online loop at bench.py:1771-1830's shapes
ONLINE_BITS, ONLINE_BATCH, ONLINE_EVENTS, ONLINE_ACTIONS = 16, 64, 8192, 4
ONLINE_REQUESTS = 200
_FABRIC_SETTINGS = ("FABRIC_BEAT_S", "FABRIC_EVICT_S", "FABRIC_WAIT_S",
                    "SERVE_MAX_BATCH", "SERVE_BATCH_LATENCY",
                    "CRITEO_MESH_ROWS", "CRITEO_CHUNK", "CRITEO_BATCH",
                    "CRITEO_MAX_CARD", "CRITEO_LR", "CRITEO_BITS",
                    "CRITEO_INTS", "CRITEO_CATS")


def _await_file(workdir: str, name: str, deadline_s: float = None):
    """The JSON written as ``name`` in ``workdir`` (None for a command
    file), polling until it exists; raises after ``deadline_s``."""
    path = os.path.join(workdir, name)
    deadline = time.monotonic() + (deadline_s or FABRIC_WAIT_S)
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 22: {name} never came")
        time.sleep(0.01)
    if name.startswith("cmd_"):
        return None
    for _ in range(100):
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError:                  # caught mid-write
            time.sleep(0.01)
    raise AssertionError(f"phase 22: {name} is not JSON")


def _put_json(workdir: str, name: str, obj) -> None:
    tmp = os.path.join(workdir, f".{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, os.path.join(workdir, name))


def _command(workdir: str, name: str) -> None:
    open(os.path.join(workdir, f"cmd_{name}"), "w").close()


class _Abort(Exception):
    """The parent gave up on phase 22: a rank stops where it is."""


def _rank_await(workdir: str, name: str) -> None:
    """Wait for the parent's command ``name`` (a file ``cmd_<name>``);
    raise ``_Abort`` when ``cmd_abort`` appears instead."""
    while not os.path.exists(os.path.join(workdir, f"cmd_{name}")):
        if os.path.exists(os.path.join(workdir, "cmd_abort")):
            raise _Abort(name)
        time.sleep(0.01)


def _criteo_columns(seed: int = 0):
    """(each categorical column's cardinality, each integer column's
    mean count): the table's shape, the same for every chunk."""
    meta = np.random.default_rng([seed, 1 << 30])
    card = np.exp(meta.uniform(np.log(4), np.log(CRITEO_MAX_CARD),
                               CRITEO_CATS)).astype(np.int64)
    return card, meta.uniform(0.5, 60.0, CRITEO_INTS)


def _criteo_vocab_hashes(seed: int = 0) -> list:
    """Each categorical column's vocabulary (``C<j>=<8 hex digits>`` for
    every category code) hashed once: uint32 per code."""
    from synapseml_tpu_torch.vw.hashing import hash_strings

    card, _ = _criteo_columns(seed)
    return [hash_strings([f"C{j + 1}={v:08x}" for v in range(int(c))]
                         ).astype(np.uint32) for j, c in enumerate(card)]


def criteo_mask(h: np.ndarray, bits: int) -> np.ndarray:
    """The table's feature hashes masked into ``bits`` bits (int32)."""
    return (h & np.uint32((1 << bits) - 1)).astype(np.int32)


def criteo_table(rows: int, seed: int = 0, vocab=None):
    """``rows`` rows of a Criteo-shaped table as padded VW rows: (unmasked
    feature hashes (rows, 39) uint32, val (rows, 39) float32, labels in
    +-1). The 13 integer columns are ``I<j>`` features with value
    log1p(count) (heavy-tailed counts, 10% missing: value 0); the 26
    categorical columns are one ``C<j>=<hex>``
    feature each, category codes drawn with a skew toward small codes.
    Each chunk's codes are mapped to their hashed vocabulary through
    ``np.unique``'s inverse. Labels are drawn from a logistic model with a
    hidden weight per unhashed feature, so both bit widths see the same
    labels."""
    from synapseml_tpu_torch.vw.hashing import hash_strings

    card, lam = _criteo_columns(seed)
    card32, lam32 = card.astype(np.float32), lam.astype(np.float32)
    vocab = vocab if vocab is not None else _criteo_vocab_hashes(seed)
    ihash = hash_strings([f"I{j + 1}" for j in range(CRITEO_INTS)]
                         ).astype(np.uint32)
    hs, vals, ys = [], [], []
    for c in range(-(-rows // CRITEO_CHUNK)):
        n = min(CRITEO_CHUNK, rows - c * CRITEO_CHUNK)
        rng = np.random.default_rng([seed, c])
        # heavy-tailed counts: the floor of an exponential of mean lam
        counts = np.floor(rng.standard_exponential(
            size=(CRITEO_CHUNK, CRITEO_INTS), dtype=np.float32)[:n] * lam32)
        missing = rng.random((CRITEO_CHUNK, CRITEO_INTS),
                             dtype=np.float32)[:n] < 0.1
        ival = np.where(missing, np.float32(0), np.log1p(counts))
        u = rng.random((CRITEO_CHUNK, CRITEO_CATS), dtype=np.float32)[:n]
        codes = (card32 * (u * u * u)).astype(np.int32)
        h = np.empty((n, CRITEO_INTS + CRITEO_CATS), np.uint32)
        h[:, :CRITEO_INTS] = ihash
        for j in range(CRITEO_CATS):
            uniq, inv = np.unique(codes[:, j], return_inverse=True)
            h[:, CRITEO_INTS + j] = vocab[j][uniq][inv]
        val = np.concatenate([ival, np.ones((n, CRITEO_CATS), np.float32)],
                             axis=1)
        # a hidden weight in [-0.5, 0.5) per unhashed feature (a 32-bit
        # multiplicative hash), about 30% positives (the challenge's click
        # rate is 25.6%)
        w = (h * np.uint32(2654435761)).astype(np.float32) / 2 ** 32 - 0.5
        margin = (1.2 * w[:, CRITEO_INTS:].sum(axis=1)
                  + 0.3 * (w[:, :CRITEO_INTS] * (ival - 2.0)).sum(axis=1)
                  - 1.2)
        p = 1.0 / (1.0 + np.exp(-margin))
        ys.append(np.where(rng.random(CRITEO_CHUNK, dtype=np.float32)[:n]
                           < p, np.float32(1), np.float32(-1)))
        hs.append(h)
        vals.append(val)
    return np.concatenate(hs), np.concatenate(vals), np.concatenate(ys)


def _auc(y_pm, score) -> float:
    from synapseml_tpu_torch.gbdt.objectives import auc

    return float(auc(torch.from_numpy((np.asarray(y_pm) > 0).astype(
        np.float32)), torch.from_numpy(np.asarray(score, np.float32))))


_CRITEO_SETTINGS = ("CRITEO_ROWS", "CRITEO_CHUNK", "CRITEO_BITS",
                    "CRITEO_BATCH", "CRITEO_MAX_CARD", "CRITEO_CPU_THREADS",
                    "CRITEO_LR")


def _criteo_cpu(out_dir: str, settings: dict) -> None:
    """The CPU's pass at every bit width (a spawned process beside the
    card's work): weights, bias and progressive loss to ``out_dir``."""
    sys.path.insert(0, str(REPO))
    globals().update(settings)
    rows = CRITEO_ROWS
    from synapseml_tpu_torch.vw.learner import VWConfig, train_vw

    torch.set_num_threads(CRITEO_CPU_THREADS)
    h, val, y = criteo_table(rows)
    for bits in CRITEO_BITS:
        idx = criteo_mask(h, bits)
        t0 = time.perf_counter()
        st, prog = train_vw(idx, val, y, VWConfig(
            num_bits=bits, loss_function="logistic",
            batch_size=CRITEO_BATCH, learning_rate=CRITEO_LR),
            collect_progressive=True, device="cpu")
        # written whole, then renamed: the parent polls for the name
        tmp = os.path.join(out_dir, f".cpu_{bits}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, weights=st.weights.numpy(), bias=st.bias.numpy(),
                     loss=np.float64(st.progressive_loss),
                     prog=prog[:100_000],
                     seconds=np.float64(time.perf_counter() - t0))
        os.replace(tmp, os.path.join(out_dir, f"cpu_{bits}.npz"))


def start_criteo_cpu():
    """The CPU passes of (d) in a spawned process: (process, out dir)."""
    out = tempfile.mkdtemp(prefix="criteo_cpu_")
    ctx = torch.multiprocessing.get_context("spawn")
    p = ctx.Process(target=_criteo_cpu, args=(
        out, {k: globals()[k] for k in _CRITEO_SETTINGS}))
    p.start()
    return p, out


def vw_step_launches(cfg, width: int, dev: str) -> int:
    """Kernel launches of one batch of the VW learner's pass
    (``vw.learner._step``) on the card, read by ``torch.profiler`` over
    one step of a throwaway state after a first one."""
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.vw.learner import VWState, _step

    b = cfg.batch_size
    st = VWState.init(cfg.num_bits, dev)
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 1 << cfg.num_bits, (b, width), generator=g).to(dev)
    val = torch.rand(b, width, generator=g).to(dev)
    y = torch.where(torch.rand(b, generator=g) > 0.5, 1.0, -1.0).to(dev)
    sw = torch.ones(b, device=dev)
    _step(st, idx, val, y, sw, cfg)          # first-use allocations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _step(st, idx, val, y, sw, cfg)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _fabric_rank(rank: int, workdir: str, dev: str, port: int,
                 settings: dict) -> None:
    """One process of phase 22 (a): it joins the world through
    ``initialize_distributed``, serves the saved classifier through its
    own ``serving_fn`` graphs inside ``DistributedServingServer`` (the
    gateway in process 0), then follows the parent's commands: process 0
    switches its gateway to round robin, process 1's worker is killed and
    restarted, both report their counters, run (d)'s mesh pass on their
    own rows, and stop."""
    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.io.distributed_serving import (
        DistributedServingServer, WorkerAgent)
    from synapseml_tpu_torch.io.serving import ServingServer
    from synapseml_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh)
    from synapseml_tpu_torch.testing import kill_worker
    from synapseml_tpu_torch.vw.learner import VWConfig, train_vw

    if _on_card(dev):
        torch.cuda.set_device(0)
    initialize_distributed(f"127.0.0.1:{port}", FABRIC_RANKS, rank,
                           timeout_s=600)
    with open(os.path.join(workdir, "model.txt")) as f:
        booster = Booster.from_model_string(f.read(), device=dev)
    t0 = time.perf_counter()
    serve = booster.serving_fn(max_batch_size=SERVE_MAX_BATCH)
    handler = _serve_handler(serve)
    dss = DistributedServingServer(
        handler, host="127.0.0.1", advertise_host="127.0.0.1",
        max_batch_size=SERVE_MAX_BATCH,
        max_batch_latency=SERVE_BATCH_LATENCY,
        heartbeat_interval=FABRIC_BEAT_S,
        heartbeat_timeout=FABRIC_EVICT_S).start()
    _put_json(workdir, f"up_{rank}.json", dict(
        worker=dss.worker.url, gateway=dss.url if rank == 0 else None,
        start_s=time.perf_counter() - t0, runner=serve.runner.stats(),
        t_up=time.time()))
    gw_url = _await_file(workdir, "up_0.json")["gateway"]
    extra = []
    try:
        if rank == 0:
            _rank_await(workdir, "rr")
            dss.gateway.mode = "round_robin"
        else:
            _rank_await(workdir, "kill")
            t_kill = time.time()
            kill_worker(dss.worker)          # a crash: no drain, no farewell
            dss.agent.stop(deregister=False)
            _put_json(workdir, "killed.json", dict(t=t_kill))
            _rank_await(workdir, "restart")
            t_up = time.time()
            w2 = ServingServer(handler, host="127.0.0.1", port=0,
                               max_batch_size=SERVE_MAX_BATCH,
                               max_batch_latency=SERVE_BATCH_LATENCY).start()
            a2 = WorkerAgent(w2, gw_url, interval=FABRIC_BEAT_S).start()
            extra = [a2, w2]
            _put_json(workdir, "restarted.json", dict(t=t_up, url=w2.url))
        _rank_await(workdir, "stats")
        servers = [dss.worker] + [x for x in extra
                                  if isinstance(x, ServingServer)]
        _put_json(workdir, f"stats_{rank}.json", dict(
            runner=serve.runner.stats(),
            workers={s.url: s.metrics.snapshot() for s in servers}))
        _rank_await(workdir, "vw")
        # (d): each process passes its own block of the table's prefix
        blk = CRITEO_MESH_ROWS // FABRIC_RANKS
        rows = slice(rank * blk, (rank + 1) * blk)
        idx, val, y = (np.load(os.path.join(workdir, f"mesh_{k}.npy"),
                               mmap_mode="r")[rows]
                       for k in ("idx", "val", "y"))
        mesh = make_mesh({"data": FABRIC_RANKS}, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        st, _ = train_vw(np.asarray(idx), np.asarray(val), np.asarray(y),
                         VWConfig(num_bits=18, loss_function="logistic",
                                  batch_size=CRITEO_BATCH,
                                  learning_rate=CRITEO_LR),
                         mesh=mesh, device=dev)
        _sync(dev)
        secs = time.perf_counter() - t0
        data = st.to_bytes()
        if rank == 0:
            with open(os.path.join(workdir, "mesh_state.npz"), "wb") as f:
                f.write(data)
        import hashlib

        # launches of one batch's step, counted by torch.profiler in a
        # process that has run no profiler before
        launches = {bits: vw_step_launches(VWConfig(
            num_bits=bits, loss_function="logistic",
            batch_size=CRITEO_BATCH, learning_rate=CRITEO_LR),
            CRITEO_INTS + CRITEO_CATS, dev)
            for bits in CRITEO_BITS} if rank == 0 and _on_card(dev) else {}
        _put_json(workdir, f"vw_{rank}.json", dict(
            seconds=secs, loss=st.progressive_loss, launches=launches,
            sha=hashlib.sha256(st.weights.cpu().numpy().tobytes()
                               ).hexdigest()))
        _rank_await(workdir, "stop")
    except _Abort:
        pass
    finally:
        for x in extra:
            x.stop()
        dss.stop()
        torch.distributed.destroy_process_group()


def _gateway_health(url: str) -> dict:
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=SERVE_CLIENT_TIMEOUT)
    try:
        conn.request("GET", "/")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _run_clients(url: str, items: list, threads: int, on_progress=None):
    """``items`` through ``threads`` of phase 15's keep-alive clients, in
    this process (the servers are in the ranks'); ``on_progress(done)`` is
    polled while they run. Returns the results sorted by index."""
    results: list = []
    lock = threading.Lock()
    work = iter(items)
    done = mp.Value("i", 0)
    pool = [threading.Thread(target=_client_loop,
                             args=(url, work, results, lock, done))
            for _ in range(threads)]
    for t in pool:
        t.start()
    while any(t.is_alive() for t in pool):
        if on_progress is not None:
            on_progress(done.value)
        time.sleep(0.005)
    for t in pool:
        t.join()
    return sorted(results)


def _latency(results) -> dict:
    lat = np.asarray([r[4] for r in results]) * 1e3
    wall = max(r[3] + r[4] for r in results) - min(r[3] for r in results)
    return dict(p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), rps=len(results) / wall,
                n=len(results))


def _check_fabric_replies(label: str, results, want, allow=(200, 503)
                          ) -> dict:
    """Every accepted request (anything but a 503 shed) got a 200 within
    ``SERVE_TOL`` of ``want``; no transport failure (-1), no other 5xx."""
    statuses = {}
    for i, status, reply, _, _ in results:
        statuses[status] = statuses.get(status, 0) + 1
        if status not in allow:
            raise AssertionError(f"{label}: request {i} got {status} "
                                 f"({reply!r:.200})")
        if status == 200:
            _check_gap(f"{label} request {i}", reply, want[i])
    return statuses


def start_fabric_ranks(dev: str, booster, workdir: str) -> tuple:
    """Save the classifier's model string once and start the processes of
    (a), each loading it: (their handle, the start time)."""
    import torch.multiprocessing as tmp

    with open(os.path.join(workdir, "model.txt"), "w") as f:
        f.write(booster.model_string())
    settings = {k: globals()[k] for k in _FABRIC_SETTINGS}
    t0 = time.time()
    return tmp.start_processes(_fabric_rank, args=(
        workdir, dev, _free_port(), settings), nprocs=FABRIC_RANKS,
        join=False, start_method="spawn"), t0


def fabric_path(dev: str, booster, Xv, workdir: str, t_start: float,
                card: str, single: dict = None) -> dict:
    """(a): the two processes (started at ``t_start``), the steady load
    through process 0's gateway, then a kill and a restart of process 1's
    worker under load. They stay up for (b) and (d)."""
    ups = [_await_file(workdir, f"up_{r}.json") for r in range(
        FABRIC_RANKS)]
    gw = ups[0]["gateway"]
    log(f"  {FABRIC_RANKS} processes up "
        f"{max(u['t_up'] for u in ups) - t_start:.2f}s after their start "
        f"(each: booster from the saved model string, serving_fn captured "
        f"{ups[0]['runner']['total_compiles']} rungs in "
        f"{max(u['start_s'] for u in ups):.2f}s, worker, agent); gateway "
        f"{gw} in process 0; workers {[u['worker'] for u in ups]}")
    rng = np.random.default_rng(22)
    rows = rng.integers(0, Xv.shape[0], FABRIC_REQUESTS
                        + FABRIC_KILL_REQUESTS)
    want = booster.predict(Xv[rows])
    items = [(i, "higgs", json.dumps({"features": Xv[rows[i]].tolist()}
                                     ).encode())
             for i in range(len(rows))]
    wait = time.monotonic() + FABRIC_WAIT_S
    while not all(l["warm_buckets"] for l in _gateway_health(gw)["workers"]):
        if time.monotonic() > wait:
            raise AssertionError("phase 22: no warm ladder advertised")
        time.sleep(0.02)
    steady = _run_clients(gw, items[:FABRIC_REQUESTS], SERVE_CLIENTS)
    st = _check_fabric_replies("fabric steady", steady, want, allow=(200,))
    health = _gateway_health(gw)
    lat = _latency(steady)
    covering = sum(l["ok"] for l in health["workers"]
                   if 1 in l["warm_buckets"])
    beside = (f"phase 15's single server p50 {single['p50_ms']:.3f} ms p99 "
              f"{single['p99_ms']:.3f} ms, {single['rps']:.1f} requests/s"
              if single else "phase 15 did not run in this call")
    log(f"  (a) steady: {lat['n']} one-row requests from {SERVE_CLIENTS} "
        f"clients through the gateway: p50 {lat['p50_ms']:.3f} ms p99 "
        f"{lat['p99_ms']:.3f} ms, {lat['rps']:.1f} requests/s ({beside}), "
        f"statuses {st}, every reply within "
        f"{SERVE_TOL} of predict; bucket-aware: {covering} of "
        f"{health['forwarded']} forwards to a worker advertising the "
        f"request's rung 1 (ladders "
        f"{[l['warm_buckets'] for l in health['workers']]}, forwards by "
        f"worker {[l['ok'] for l in health['workers']]}, sticky least "
        f"loaded); {card}")
    # the kill: round robin spreads the load, so the killed worker is hit
    _command(workdir, "rr")
    marks = {"polled": 0.0}
    killed_url = ups[1]["worker"].rstrip("/")
    n_kill = FABRIC_KILL_REQUESTS

    def progress(done):
        now = time.monotonic()
        if now - marks["polled"] < 0.02:        # the gateway's health GET
            return
        marks["polled"] = now
        if "kill" not in marks and done >= n_kill // 4:
            marks["kill"] = time.time()
            _command(workdir, "kill")
        if "kill" in marks and "evicted" not in marks:
            if all(l["url"].rstrip("/") != killed_url
                   for l in _gateway_health(gw)["workers"]):
                marks["evicted"] = time.time()
                _command(workdir, "restart")
        if "evicted" in marks and "rejoined" not in marks:
            new = os.path.join(workdir, "restarted.json")
            if os.path.exists(new):
                url = _await_file(workdir, "restarted.json")["url"]
                if any(l["url"].rstrip("/") == url.rstrip("/")
                       for l in _gateway_health(gw)["workers"]):
                    marks["rejoined"] = time.time()

    killed = _run_clients(gw, items[FABRIC_REQUESTS:], SERVE_CLIENTS,
                          progress)
    wait = time.monotonic() + FABRIC_WAIT_S
    while "rejoined" not in marks:
        if time.monotonic() > wait:
            raise AssertionError(f"phase 22: the restarted worker never "
                                 f"rejoined ({marks})")
        progress(n_kill)
        time.sleep(0.01)
    kt = _await_file(workdir, "killed.json")["t"]
    rt = _await_file(workdir, "restarted.json")["t"]
    kst = _check_fabric_replies("fabric kill", killed, want)
    klat = _latency(killed)
    health = _gateway_health(gw)
    log(f"  (a) kill: process 1's worker killed (no drain, no farewell) "
        f"after {n_kill // 4} of {n_kill} requests; evicted "
        f"{marks['evicted'] - kt:.3f}s after the kill (heartbeats every "
        f"{FABRIC_BEAT_S}s, eviction after {FABRIC_EVICT_S}s); restarted "
        f"worker rejoined {marks['rejoined'] - rt:.3f}s after its start; "
        f"statuses {kst} (no 5xx for an accepted request, no transport "
        f"failure), replies within {SERVE_TOL} of predict; p50 "
        f"{klat['p50_ms']:.3f} ms p99 {klat['p99_ms']:.3f} ms "
        f"{klat['rps']:.1f} requests/s round robin; gateway retried "
        f"{health['retried']}, failed {health['failed']}, evicted "
        f"{health['evicted']}, rejoined+joined "
        f"{health['rejoined'] + health['joined']}; {card}")
    return dict(gateway=gw, workers=[
        ups[0]["worker"], _await_file(workdir, "restarted.json")["url"]],
        steady=lat, kill=klat, evict_s=marks["evicted"] - kt,
        rejoin_s=marks["rejoined"] - rt)


def _stop_ranks(workdir: str, ranks, ok: bool) -> None:
    """``cmd_stop`` after a whole phase, ``cmd_abort`` after a failure;
    then join the ranks (a rank that raised fails the phase)."""
    _command(workdir, "stop" if ok else "abort")
    deadline = time.monotonic() + FABRIC_WAIT_S
    while not ranks.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.terminate()
            raise AssertionError("phase 22: the ranks did not stop")


def federation_path(worker_urls: list, booster, Xv, card: str) -> dict:
    """(b): two federated gateways over the same workers; one killed
    under load. Clients retry a connection error on the other gateway
    (a fleet load balancer's move: no status came back)."""
    from synapseml_tpu_torch.core.qos import QoSClass, QoSController
    from synapseml_tpu_torch.io.distributed_serving import (ServingGateway,
                                                            federate)
    from synapseml_tpu_torch.testing import kill_gateway

    def qos():
        return QoSController(default_class=QoSClass(rate_per_sec=1e6,
                                                     burst=1e6))

    gws = [ServingGateway(worker_urls, host="127.0.0.1", port=0,
                          gossip_interval=0.05, peer_timeout=0.5,
                          lease_ttl=1.0, qos=qos()).start()
           for _ in range(2)]
    try:
        federate(gws)
        tenants = [f"t{k}" for k in range(FED_TENANTS)]
        wait = time.monotonic() + FABRIC_WAIT_S
        while not all(len(g.ring.nodes()) == 2 for g in gws):
            if time.monotonic() > wait:
                raise AssertionError("phase 22: gateways never converged")
            time.sleep(0.01)
        homes = {t: gws[0].tenant_home(t) for t in tenants}
        moved = [t for t in tenants if homes[t] == gws[1].public_url]
        rng = np.random.default_rng(23)
        rows = rng.integers(0, Xv.shape[0], FED_REQUESTS)
        want = booster.predict(Xv[rows])
        results, drops, marks = [], [], {}
        lock = threading.Lock()
        work = iter(range(FED_REQUESTS))

        def client():
            while True:
                with lock:
                    i = next(work, None)
                if i is None:
                    return
                tenant = tenants[i % FED_TENANTS]
                body = json.dumps({"features": Xv[rows[i]].tolist()}).encode()
                if i == FED_REQUESTS // 3:
                    marks["kill"] = time.monotonic()
                    kill_gateway(gws[1])
                for k in range(3):
                    # each tenant's requests alternate between the gateways
                    url = gws[(i // FED_TENANTS + k) % 2].url
                    try:
                        t0 = time.monotonic()
                        status, reply, secs = _post_once(
                            url, body, {"X-Tenant": tenant})
                        with lock:
                            results.append((i, status, reply, t0, secs))
                        break
                    except (OSError, http.client.HTTPException) as e:
                        err = repr(e)
                else:
                    with lock:
                        drops.append((i, err))

        def watch():
            survivor = gws[0]
            while "kill" not in marks or "leases" not in marks:
                if "kill" in marks:
                    if "arcs" not in marks and survivor.ring.nodes() == [
                            survivor.public_url]:
                        marks["arcs"] = time.monotonic()
                    if "leases" not in marks and all(
                            survivor.leases.holders(t)
                            == [survivor.gateway_id] for t in tenants):
                        marks["leases"] = time.monotonic()
                time.sleep(0.002)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        pool = [threading.Thread(target=client) for _ in range(FED_CLIENTS)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        # keep-alive traffic on the survivor until its leases settle
        wait = time.monotonic() + FABRIC_WAIT_S
        while "leases" not in marks:
            if time.monotonic() > wait:
                raise AssertionError(f"phase 22: the dead gateway's leases "
                                     f"never moved ({marks})")
            keep = json.dumps({"features": Xv[0].tolist()}).encode()
            for t in tenants:
                _post_once(gws[0].url, keep, {"X-Tenant": t})
        watcher.join(timeout=FABRIC_WAIT_S)
        if drops:
            raise AssertionError(f"phase 22 (b): {len(drops)} requests got "
                                 f"no status from either gateway: "
                                 f"{drops[:3]}")
        st = _check_fabric_replies("federation", sorted(results), want)
        homes_after = {t: gws[0].tenant_home(t) for t in tenants}
        if set(homes_after.values()) != {gws[0].public_url}:
            raise AssertionError(f"phase 22 (b): tenant homes {homes_after}")
        lat = _latency(results)
        log(f"  (b) federation: two gateways federated over the workers, "
            f"{FED_REQUESTS} requests of {FED_TENANTS} tenants from "
            f"{FED_CLIENTS} clients spread over both, gateway 2 killed after "
            f"a third: its arcs ({len(moved)} of {FED_TENANTS} tenants homed "
            f"there) moved to the peer {marks['arcs'] - marks['kill']:.3f}s "
            f"and its leases {marks['leases'] - marks['kill']:.3f}s after "
            f"the kill (gossip every 0.05s, peer timeout 0.5s, lease ttl "
            f"1.0s); statuses {st}, no accepted request without a 200; p50 "
            f"{lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms; {card}")
        return dict(arcs_s=marks["arcs"] - marks["kill"],
                    leases_s=marks["leases"] - marks["kill"], statuses=st)
    finally:
        for g in gws:
            g.stop()


def _dl_tenant(dev: str):
    """Phase 18's ResNet-50 (``onnx/modelgen.py``, seeded weights) as an
    ``ONNXModel`` behind its ``BucketedRunner``: requests name one of
    ``FLEET_IMAGES`` preloaded images; every batch is padded to
    ``FLEET_DL_BATCH`` rows (one captured graph). Returns (handler, the
    reference top class and logit of every image)."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.onnx import modelgen

    kw = dict(FLEET_RESNET)
    model = modelgen.make_resnet(kw.pop("depth"), **kw)
    in_name, out_name = model.graph.inputs[0].name, \
        model.graph.outputs[0].name
    side = FLEET_RESNET["image_size"]
    raw = model.encode()
    del model
    stage = onnx_stage(raw, in_name, out_name, FLEET_DL_BATCH, "float32", dev)
    images = np.random.default_rng(24).normal(
        size=(FLEET_IMAGES, 3, side, side)).astype(np.float32)
    lock = threading.Lock()

    def score(x):
        n = x.shape[0]
        pad = np.concatenate([x, np.repeat(x[-1:], FLEET_DL_BATCH - n, 0)])
        with lock:       # ONNXModel's runner cache is filled on first use
            y = stage.transform(Table({"x": pad}))["y"]
        return np.asarray(y[:n])

    ref = score(images[:FLEET_DL_BATCH])
    ref = np.concatenate([ref, score(images[FLEET_DL_BATCH:])])

    def handler(df):
        ids = [int(v["image"]) for v in df["value"]]
        out = []
        for s in range(0, len(ids), FLEET_DL_BATCH):
            out.append(score(images[ids[s:s + FLEET_DL_BATCH]]))
        y = np.concatenate(out)
        reply = np.empty(len(ids), object)
        reply[:] = [[int(np.argmax(r)), float(np.max(r))] for r in y]
        return Table({"id": df["id"], "reply": reply})

    handler.runner = next(iter(stage._runner_cache.values()))
    return handler, ref


def _online_featurize(make_sparse_batch):
    def featurize(_v=None):
        return list(make_sparse_batch(
            [[a * 11 + 1, a * 11 + 2, a * 11 + 3]
             for a in range(ONLINE_ACTIONS)],
            [[1.0, 1.0, 1.0]] * ONLINE_ACTIONS, pad_to=4))
    return featurize


def _fleet_post(url: str, tenant: str, value) -> tuple:
    status, reply, secs = _post_once(url, json.dumps(value).encode(),
                                     {"X-Tenant": tenant})
    return status, reply, secs


def fleet_path(dev: str, booster, Xv, card: str) -> dict:
    """(c): gbdt, dl and vw tenants on two workers behind one gateway;
    each tenant's p99 before and while the vw tenant floods and NaN-storms.
    Returns the fleet (stopped by ``stop_fleet``)."""
    from synapseml_tpu_torch.core.qos import QoSClass, QoSController
    from synapseml_tpu_torch.io.distributed_serving import (ServingGateway,
                                                            WorkerAgent)
    from synapseml_tpu_torch.io.serving import ServingServer
    from synapseml_tpu_torch.online import GreedyPolicy, make_policy_handler
    from synapseml_tpu_torch.testing import chaos_tenant_flood
    from synapseml_tpu_torch.vw.learner import (VWConfig, VWState,
                                                make_sparse_batch)

    t0 = time.perf_counter()
    gbdt = _serve_handler(booster.serving_fn(max_batch_size=FLEET_DL_BATCH))
    gbdt.warmup()
    dl, dl_ref = _dl_tenant(dev)
    cfg = VWConfig(num_bits=ONLINE_BITS, batch_size=ONLINE_BATCH,
                   learning_rate=0.5)
    featurize = _online_featurize(make_sparse_batch)
    vw = make_policy_handler(GreedyPolicy(
        VWState.init(cfg.num_bits, dev), cfg, epsilon=1.0, seed=0,
        version="v0"), featurize)
    build_s = time.perf_counter() - t0
    workers, agents, regs = [], [], []
    fleet = dict(workers=workers, agents=agents, gateway=None)
    try:
        for _ in range(2):
            qos = QoSController(default_class=QoSClass(), classes={
                "vw": QoSClass(rate_per_sec=2000.0, burst=200.0,
                               quarantine_threshold=3,
                               quarantine_cooldown=1.0)})
            w = ServingServer(handler=None, host="127.0.0.1", port=0,
                              qos=qos, max_batch_size=FLEET_DL_BATCH,
                              max_batch_latency=0.002, warmup=False)
            w.add_tenant("gbdt", gbdt, warmup=False)
            w.add_tenant("dl", dl, warmup=False)
            regs.append(w.add_tenant("vw", vw, warmup=False))
            workers.append(w.start())
        gw = ServingGateway([w.url for w in workers], host="127.0.0.1",
                            port=0, heartbeat_timeout=30.0).start()
        fleet["gateway"] = gw
        for i, w in enumerate(workers):
            agents.append(WorkerAgent(w, gw.url, worker_id=f"fleet-w{i}",
                                      interval=0.2).start())
        wait = time.monotonic() + FABRIC_WAIT_S
        while not all(l.tenants for l in gw.links):
            if time.monotonic() > wait:
                raise AssertionError("phase 22: tenants never advertised")
            time.sleep(0.02)
        fleet.update(regs=regs, cfg=cfg, featurize=featurize)
        rng = np.random.default_rng(25)
        hrows = rng.integers(0, Xv.shape[0], FLEET_REQUESTS)
        hwant = booster.predict(Xv[hrows])

        def tenant_load(tenant, n, out):
            def one(i):
                try:
                    out.append(checked(i))
                except Exception as e:  # noqa: BLE001 — reported below
                    out.append((repr(e), 0.0))

            def checked(i):
                if tenant == "gbdt":
                    s, r, secs = _fleet_post(gw.url, tenant, {
                        "features": Xv[hrows[i]].tolist()})
                    if s == 200:
                        _check_gap(f"fleet gbdt {i}", r, hwant[i])
                elif tenant == "dl":
                    k = i % FLEET_IMAGES
                    s, r, secs = _fleet_post(gw.url, tenant, {"image": k})
                    if s == 200 and (r[0] != int(np.argmax(dl_ref[k])) or
                                     abs(r[1] - float(np.max(dl_ref[k])))
                                     > FLEET_DL_REL * float(np.abs(
                                         dl_ref[k]).max())):
                        raise AssertionError(f"fleet dl {i}: {r} against "
                                             "the direct transform")
                else:
                    s, r, secs = _fleet_post(gw.url, tenant, {})
                return s, secs
            with ThreadPoolExecutor(FLEET_CLIENTS) as pool:
                list(pool.map(one, range(n)))

        def p99(tenants, flood=None):
            outs = {t: [] for t in tenants}
            threads = [threading.Thread(target=tenant_load,
                                        args=(t, FLEET_REQUESTS, outs[t]))
                       for t in tenants]
            for t in threads:
                t.start()
            if flood is not None:
                flood.run()
            for t in threads:
                t.join()
            for t, xs in outs.items():
                bad = [s for s, _ in xs if s != 200]
                if bad:
                    raise AssertionError(f"phase 22 (c): tenant {t} got "
                                         f"{bad[:5]}")
            return {t: float(np.percentile([s for _, s in xs], 99)) * 1e3
                    for t, xs in outs.items()}

        before = p99(("gbdt", "dl", "vw"))
        with chaos_tenant_flood(gw.url, "vw", server=workers[0], nan=True), \
                chaos_tenant_flood(gw.url, "vw", n_requests=FLEET_FLOOD,
                                   threads=6, seed=3, server=workers[1],
                                   nan=True) as flood:
            during = p99(("gbdt", "dl"), flood)
            counts = flood.status_counts()
        if not set(counts) <= {429, 500, 503} or not counts.get(503):
            raise AssertionError(f"phase 22 (c): the flood's statuses "
                                 f"{counts}")
        wait = time.monotonic() + FABRIC_WAIT_S
        while _fleet_post(gw.url, "vw", {})[0] != 200:
            if time.monotonic() > wait:
                raise AssertionError("phase 22 (c): vw never recovered")
            time.sleep(0.1)
        stats = {"gbdt": gbdt.runner.stats(), "dl": dl.runner.stats()}
        log(f"  (c) fleet: gbdt (the classifier's graphs), dl (ResNet-"
            f"{FLEET_RESNET['depth']} ONNXModel, {FLEET_DL_BATCH} rows a "
            f"graph, "
            f"{FLEET_RESNET['image_size']}x{FLEET_RESNET['image_size']}) and "
            f"vw (epsilon-greedy policy) on 2 workers behind one gateway, "
            f"built in {build_s:.2f}s; p99 ms before the flood "
            f"{json.dumps({k: round(v, 3) for k, v in before.items()})}, "
            f"during vw's flood and NaN storm "
            f"{json.dumps({k: round(v, 3) for k, v in during.items()})}; "
            f"the flood's statuses {counts} (shed at its own 429 / 500 / "
            f"503), every gbdt and dl request 200 and within bounds; "
            f"captures gbdt {stats['gbdt']['total_compiles']} dl "
            f"{stats['dl']['total_compiles']}; {card}")
        fleet.update(before=before, during=during, flood=counts)
        return fleet
    except BaseException:
        stop_fleet(fleet)
        raise


def stop_fleet(fleet: dict) -> None:
    for a in fleet["agents"]:
        a.stop()
    if fleet["gateway"] is not None:
        fleet["gateway"].stop()
    for w in fleet["workers"]:
        w.stop()


def _online_events(FeedbackEvent, acts, n: int, seed: int) -> list:
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = int(r.integers(1, ONLINE_ACTIONS + 1))
        out.append(FeedbackEvent(
            key=f"b{seed}.{i}", actions=acts, action=a,
            probability=1.0 / ONLINE_ACTIONS,
            reward=0.9 if a == 2 else float(r.random() * 0.2)))
    return out


def online_path(dev: str, fleet: dict, workdir: str, card: str) -> dict:
    """(e): the learner loop's updates/s while the fleet's vw tenant
    serves over HTTP; the gate with a broadcast flipping both workers; a
    kill mid-update resumed bit for bit (deterministic algorithms on)."""
    from synapseml_tpu_torch.core.checkpoint import (CheckpointStore,
                                                     PreemptionError)
    from synapseml_tpu_torch.io.distributed_serving import PromotionBroadcast
    from synapseml_tpu_torch.online import (FeedbackEvent, FeedbackLog,
                                            OnlineLearnerLoop, PromotionGate,
                                            policy_builder)
    from synapseml_tpu_torch.testing import ChaosPreemption

    cfg, featurize, regs = fleet["cfg"], fleet["featurize"], fleet["regs"]
    gw = fleet["gateway"]
    acts = featurize()
    store = CheckpointStore(os.path.join(workdir, "online"), keep_last=3)
    log_ = FeedbackLog(capacity=ONLINE_EVENTS + 1)
    loop = OnlineLearnerLoop(log_, cfg, store=store, snapshot_every=16,
                             device=dev)
    gate = PromotionGate(regs[0], min_samples=256,
                         broadcast=PromotionBroadcast(regs))
    for ev in _online_events(FeedbackEvent, acts, ONLINE_BATCH, 99):
        log_.offer(ev)
    loop.run_until_drained()                     # first-use allocations
    for ev in _online_events(FeedbackEvent, acts, ONLINE_EVENTS, 1):
        log_.offer(ev)
        gate.record(ev)
    served = []

    def client():
        for _ in range(ONLINE_REQUESTS):
            served.append(_fleet_post(gw.url, "vw", {})[0])

    t = threading.Thread(target=client)
    t0 = time.perf_counter()
    t.start()
    updates = loop.run_until_drained()
    _sync(dev)
    train_s = time.perf_counter() - t0
    t.join()
    serve_s = time.perf_counter() - t0
    if set(served) != {200}:
        raise AssertionError(f"phase 22 (e): vw requests {set(served)}")
    t0 = time.perf_counter()
    dec = gate.try_promote(store, policy_builder(cfg, featurize, device=dev))
    promote_ms = (time.perf_counter() - t0) * 1e3
    if not dec.promoted or [r.active for r in regs] != \
            [dec.candidate_version] * len(regs):
        raise AssertionError(f"phase 22 (e): gate {dec}, workers on "
                             f"{[r.active for r in regs]}")
    versions = {_fleet_post(gw.url, "vw", {})[1]["version"]
                for _ in range(8)}
    if versions != {dec.candidate_version}:
        raise AssertionError(f"phase 22 (e): served versions {versions}")
    # kill mid-update, resume from the newest verified snapshot, replay:
    # bit for bit the uninterrupted run (the card's scatter-adds in
    # deterministic order)
    events = _online_events(FeedbackEvent, acts, ONLINE_EVENTS // 4, 7)
    n_up = len(events) // ONLINE_BATCH
    every, kill_at = max(n_up // 4, 1), n_up * 3 // 5

    def fresh(store=None):
        lg = FeedbackLog(capacity=ONLINE_EVENTS + 1)
        return OnlineLearnerLoop(lg, cfg, store=store, snapshot_every=every,
                                 device=dev)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    t_kill = time.perf_counter()
    try:
        ref = fresh()
        for ev in events:
            ref.log.offer(ev)
        ref.run_until_drained()
        kstore = CheckpointStore(os.path.join(workdir, "online_kill"),
                                 keep_last=3)
        killed = fresh(kstore)
        for ev in events:
            killed.log.offer(ev)
        try:
            with ChaosPreemption(at={"online.update": [kill_at]}):
                killed.run_until_drained()
            raise AssertionError("phase 22 (e): the kill never fired")
        except PreemptionError:
            pass
        t0 = time.perf_counter()
        resumed = fresh(kstore)
        if not resumed.restore_latest():
            raise AssertionError("phase 22 (e): no snapshot to resume")
        at = resumed.updates
        for ev in events[resumed.events_seen:]:
            resumed.log.offer(ev)
        resumed.run_until_drained()
        resume_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(was)
    kill_s = time.perf_counter() - t_kill
    a, b = ref.state.arrays(), resumed.state.arrays()
    diff = [k for k in a if a[k].tobytes() != b[k].tobytes()]
    if diff:
        raise AssertionError(f"phase 22 (e): resumed state differs from "
                             f"the uninterrupted run in {diff}")
    out = dict(updates_per_s=updates / train_s, promote_ms=promote_ms,
               serve_rps=len(served) / serve_s)
    log(f"  (e) online loop: {updates} updates of {ONLINE_BATCH} events "
        f"(num_bits {ONLINE_BITS}) in {train_s:.3f}s, "
        f"{out['updates_per_s']:.1f} updates/s "
        f"({out['updates_per_s'] * ONLINE_BATCH:.0f} events/s) while the "
        f"policy served {len(served)} requests through the gateway "
        f"({out['serve_rps']:.1f} requests/s); gate + broadcast "
        f"{promote_ms:.1f} ms over {dec.n_samples} samples, both workers on "
        f"{dec.candidate_version}; killed at update {kill_at} of {n_up}, "
        f"resumed from update {at} in {resume_s:.3f}s, bitwise the "
        f"uninterrupted run (the three runs {kill_s:.3f}s); {card}")
    return out


def criteo_path(dev: str, table: tuple, workdir: str, cpu, card: str
                ) -> dict:
    """(d): the Criteo-shaped ``table`` (``criteo_table`` of
    ``CRITEO_ROWS`` rows and a chunk held out, with its vocabulary) at
    both bit widths on the card against the CPU's pass (spawned earlier),
    launches per batch, the classifier's fit / transform, and the mesh
    pass of the two processes of (a) on the table's prefix."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.vw import VowpalWabbitClassifier
    from synapseml_tpu_torch.vw.learner import (SPARSE_DTYPE, VWConfig,
                                                VWState, train_vw,
                                                vw_predict)

    _command(workdir, "stats")
    h_all, val_all, y_all, vocab, made_s = table
    val, y = val_all[:CRITEO_ROWS], y_all[:CRITEO_ROWS]
    hval, hy = val_all[CRITEO_ROWS:], y_all[CRITEO_ROWS:]
    log(f"  (d) Criteo-shaped table: {CRITEO_ROWS} rows (and "
        f"{CRITEO_CHUNK} held out) x {CRITEO_INTS} integer + "
        f"{CRITEO_CATS} categorical columns (vocabularies "
        f"{sum(len(v) for v in vocab)} categories, each hashed once), "
        f"positives {float((y > 0).mean()):.4f}, made in {made_s:.2f}s "
        "while the processes of (a) started")
    out = {}
    for bits in CRITEO_BITS:
        idx_all = criteo_mask(h_all, bits)
        idx, hidx = idx_all[:CRITEO_ROWS], idx_all[CRITEO_ROWS:]
        cfg = VWConfig(num_bits=bits, loss_function="logistic",
                       batch_size=CRITEO_BATCH, learning_rate=CRITEO_LR)
        _sync(dev)
        t0 = time.perf_counter()
        st, prog = train_vw(idx, val, y, cfg, collect_progressive=True,
                            device=dev)
        _sync(dev)
        secs = time.perf_counter() - t0
        cpu_file = os.path.join(cpu[1], f"cpu_{bits}.npz")
        wait = time.monotonic() + FABRIC_WAIT_S * 3
        while not os.path.exists(cpu_file):
            if time.monotonic() > wait or not cpu[0].is_alive():
                if not os.path.exists(cpu_file):
                    raise AssertionError(f"phase 22 (d): the CPU pass at "
                                         f"{bits} bits never came")
            time.sleep(0.05)
        c = np.load(cpu_file)
        w = st.weights.cpu().numpy()
        gap = float(np.abs(w - c["weights"]).max() / np.abs(c["weights"]
                                                            ).max())
        lgap = abs(st.progressive_loss - float(c["loss"])) / float(c["loss"])
        pgap = float(np.abs(prog[:100_000] - c["prog"]).max())
        if gap > CRITEO_CARD_TOL or lgap > CRITEO_LOSS_TOL:
            raise AssertionError(f"phase 22 (d) {bits} bits: card against "
                                 f"CPU weights {gap:.3g} of max |w|, "
                                 f"progressive loss {lgap:.3g}")
        if not np.isfinite(w).all():
            raise AssertionError(f"phase 22 (d) {bits} bits: weights")
        auc_ = _auc(hy, vw_predict(st, hidx, hval))
        out[bits] = dict(seconds=secs, rows_per_s=CRITEO_ROWS / secs,
                         cpu_s=float(c["seconds"]),
                         gap=gap, loss=st.progressive_loss, auc=auc_)
        log(f"  (d) {bits} bits: one pass of {CRITEO_ROWS} rows at batch "
            f"{CRITEO_BATCH} on the card in {secs:.3f}s "
            f"({CRITEO_ROWS / secs:.0f} rows/s, packing and the copy in "
            f"included; {-(-CRITEO_ROWS // CRITEO_BATCH)} batches); the "
            f"CPU's pass "
            f"{float(c['seconds']):.3f}s ({CRITEO_CPU_THREADS} threads); "
            f"card against CPU: weights {gap:.3g} of max |w| (bound "
            f"{CRITEO_CARD_TOL}), progressive loss {st.progressive_loss:.6f} "
            f"vs {float(c['loss']):.6f} ({lgap:.3g}, bound "
            f"{CRITEO_LOSS_TOL}), progressive predictions max |gap| "
            f"{pgap:.3g}; held-out AUC {auc_:.6f} on the next "
            f"{CRITEO_CHUNK} rows; {card}")
        if bits == CRITEO_BITS[0]:
            sp = np.zeros(idx.shape, SPARSE_DTYPE)
            sp["idx"], sp["val"] = idx, val
            table = Table({"features": sp, "label": (y > 0).astype(
                np.float32)})
            t0 = time.perf_counter()
            model = VowpalWabbitClassifier(
                numBits=bits, learningRate=CRITEO_LR, device=dev).fit(table)
            fit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            scored = model.transform(table)
            tr_s = time.perf_counter() - t0
            mgap = float(np.abs(model.state.weights.cpu().numpy() - w).max()
                         / np.abs(w).max())
            prob = np.asarray(scored["probability"])[:, 1]
            if not np.isfinite(prob).all() or mgap > CRITEO_CARD_TOL:
                raise AssertionError(f"phase 22 (d): classifier weights "
                                     f"{mgap:.3g} from train_vw's")
            log(f"  (d) VowpalWabbitClassifier(numBits={bits}, learningRate="
                f"{CRITEO_LR}) fit "
                f"{fit_s:.3f}s, transform {tr_s:.3f}s "
                f"({CRITEO_ROWS / tr_s:.0f} rows/s) on the table; its weights "
                f"{mgap:.3g} of max |w| from train_vw's; {card}")
            mrows = CRITEO_MESH_ROWS
            for k, a in (("idx", idx), ("val", val), ("y", y)):
                np.save(os.path.join(workdir, f"mesh_{k}.npy"), a[:mrows])
            _command(workdir, "vw")
            one, _ = train_vw(idx[:mrows], val[:mrows], y[:mrows], cfg,
                              device=dev)
            mesh_hidx = hidx
        del idx, idx_all
    stats = [_await_file(workdir, f"stats_{r}.json")
             for r in range(FABRIC_RANKS)]
    vws = [_await_file(workdir, f"vw_{r}.json", FABRIC_WAIT_S * 2)
           for r in range(FABRIC_RANKS)]
    if vws[0]["sha"] != vws[1]["sha"]:
        raise AssertionError("phase 22 (d): the two ranks' weights differ")
    launches = {int(b): n for b, n in vws[0]["launches"].items()}
    if _on_card(dev) and not all(launches.get(b) for b in CRITEO_BITS):
        raise AssertionError(f"phase 22 (d): launches per batch {launches}")
    for bits in CRITEO_BITS:
        out[bits]["launches"] = launches.get(bits, 0)
    with open(os.path.join(workdir, "mesh_state.npz"), "rb") as f:
        mstate = VWState.from_bytes(f.read(), dev)
    mauc = _auc(hy, vw_predict(mstate, mesh_hidx, hval))
    oauc = _auc(hy, vw_predict(one, mesh_hidx, hval))
    if abs(mauc - oauc) > CRITEO_MESH_AUC_GAP:
        raise AssertionError(f"phase 22 (d): mesh AUC {mauc:.6f} against "
                             f"one process {oauc:.6f}")
    log(f"  (d) train_vw(mesh=) on {FABRIC_RANKS} gloo processes sharing "
        f"the card, {mrows // FABRIC_RANKS} rows each: "
        f"{max(v['seconds'] for v in vws):.3f}s, both ranks' weights "
        f"bitwise equal; held-out AUC {mauc:.6f} against one process on "
        f"the same {mrows} rows {oauc:.6f} (bound {CRITEO_MESH_AUC_GAP}); "
        f"launches per batch of one pass's step by bits "
        f"{json.dumps(launches)} (torch.profiler in process 0); "
        f"workers' runners after (a): "
        f"{[s['runner']['total_compiles'] for s in stats]} captures, "
        f"{[s['runner']['total_hits'] for s in stats]} hits; {card}")
    out["mesh"] = dict(auc=mauc, one_auc=oauc)
    return out


def fabric_online_path(dev: str, booster=None, Xv=None, card: str = "",
                       single: dict = None) -> dict:
    """Phase 22: (a)-(e) above, (a) printed beside phase 15's single
    server (``single``: its load's p50 / p99 ms and requests/s). Alone, it
    first fits the served classifier (phase 12's configuration cut to
    ``FABRIC_ALONE_ROWS``)."""
    cpu = start_criteo_cpu()
    workdir = tempfile.mkdtemp(prefix="phase22_")
    held, ok = {}, False
    if booster is None:
        from synapseml_tpu_torch.gbdt import BoosterConfig, train_booster

        X, y = higgs_like(FABRIC_ALONE_ROWS)
        t0 = time.perf_counter()
        booster = train_booster(X, y, BoosterConfig(
            objective="binary", num_iterations=FABRIC_ITERS,
            num_leaves=31), device=dev)
        Xv = X[-surface_split(FABRIC_ALONE_ROWS):]
        log(f"  the served classifier: {FABRIC_ITERS} iterations on "
            f"{FABRIC_ALONE_ROWS} rows in {time.perf_counter() - t0:.2f}s")
        del X, y
    out = {}
    t0 = [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        log(f"  ({name}) took {now - t0[0]:.1f}s")
        t0[0] = now

    try:
        held["ranks"], t_ranks = start_fabric_ranks(dev, booster, workdir)
        # (d)'s table is made while the ranks start (host work only)
        t = time.perf_counter()
        vocab = _criteo_vocab_hashes()
        table = (*criteo_table(CRITEO_ROWS + CRITEO_CHUNK, vocab=vocab),
                 vocab, time.perf_counter() - t)
        part("table")
        fabric = fabric_path(dev, booster, Xv, workdir, t_ranks, card,
                             single)
        out["fabric"] = fabric
        part("a")
        out["federation"] = federation_path(fabric["workers"], booster, Xv,
                                            card)
        part("b")
        out["vw"] = criteo_path(dev, table, workdir, cpu, card)
        del table
        part("d")
        fleet = fleet_path(dev, booster, Xv, card)
        part("c")
        try:
            out["online"] = online_path(dev, fleet, workdir, card)
        finally:
            t = time.perf_counter()
            stop_fleet(fleet)
            log(f"  the fleet stopped in {time.perf_counter() - t:.2f}s")
        part("e")
        ok = True
    finally:
        if "ranks" in held:
            _stop_ranks(workdir, held["ranks"], ok)
        cpu[0].join(timeout=FABRIC_WAIT_S)
        if cpu[0].is_alive():
            cpu[0].terminate()
    return out


# ---------------------------------------------------------------------------
# phase 23: anomaly detection, recommendation and nearest neighbours
# ---------------------------------------------------------------------------

# Shapes of public tables (no data is read; every table is made from a seed).
# (a) ULB's "Credit Card Fraud Detection" (Kaggle mlg-ulb/creditcardfraud):
# 284,807 transactions x 30 features (Time, the PCA components V1-V28,
# Amount), 492 frauds (0.172%); the isolation forest at LinkedIn's defaults
# (100 trees of 256 samples) with the frauds' share as contamination
CREDIT_ROWS, CREDIT_FEATURES, CREDIT_FRAUDS = 284_807, 30, 492
IFOREST = dict(numEstimators=100, maxSamples=256.0, contamination=0.00172,
               randomSeed=1)
# card against the port on the CPU: scores within IFOREST_TOL, labels equal
# but for rows within IFOREST_TOL of the threshold
IFOREST_TOL = 1e-6
# the online loop over ANOMALY_EVENTS events in micro-batches of
# ANOMALY_BATCH
ANOMALY_EVENTS, ANOMALY_BATCH = 20_000, 64
# (b) access logs in tests/test_cyber.py's group pattern (each department's
# users reach their own resource group), cross-department accesses planted
ACCESS_TENANTS, ACCESS_USERS, ACCESS_RES, ACCESS_DEPTS = 4, 5_000, 2_000, 10
ACCESS_ROWS, ACCESS_CROSS = 250_000, 0.01
ACCESS = dict(rankParam=10, maxIter=25)
# card against CPU on tenant 0: normalized scores within ACCESS_SCORE_TOL,
# the ACCESS_TOP highest scores' sets at least ACCESS_TOP_AGREE equal
ACCESS_SCORE_TOL, ACCESS_TOP, ACCESS_TOP_AGREE = 1e-3, 1_000, 0.99
# (c) GroupLens MovieLens-10M (ML-10M100K): 69,878 users x 10,677 items,
# 10,000,054 ratings of 0.5-5 in halves from 1995-01-09 to 2009-01-05,
# every user with at least 20; item popularity from a power law. SAR as
# its documentation's example configures it
ML_USERS, ML_ITEMS, ML_RATINGS, ML_MIN_PER_USER = 69_878, 10_677, \
    10_000_054, 20
ML_T0, ML_T1 = 789_609_600, 1_231_113_600        # epoch seconds
SAR_PARAMS = dict(similarityFunction="jaccard", supportThreshold=4,
                  timeDecayCoeff=30)
# top-SAR_K of SAR_SUBSET users against the CPU port (equal but where the
# 10th and 11th scores lie within SAR_TIE_RTOL); SAR_CHECK_COLS similarity
# columns against float64 counts; transform of SAR_PAIRS pairs
SAR_K, SAR_SUBSET, SAR_TIE_RTOL = 10, 1_000, 1e-5
# SAR_PAIRS 1,000,000 before phase 24 was added
SAR_CHECK_COLS, SAR_PAIRS = 64, 250_000
# (d) texmex ANN_SIFT1M's shape, its 1,000,000 base vectors cut to 500,000
# (before phase 25 was added, all of them) x 128, integer-valued 0-255,
# 10,000 queries; k = 10. Against a float64 host brute force on
# KNN_CHECK queries: recall 1.0 but at near ties (the 10th and 11th inner
# products within KNN_TIE_RTOL). ConditionalKNN: KNN_LABELS labels,
# KNN_COND labels a query, KNN_CHECK queries
SIFT_BASE, SIFT_DIM, SIFT_QUERIES = 500_000, 128, 10_000
KNN_K, KNN_CHECK, KNN_TIE_RTOL = 10, 256, 1e-5
KNN_LABELS, KNN_COND = 1_000, 5
# the CPU port's runs of (a) and (b) in a spawned process beside the card's
ANALYTICS_CPU_THREADS = 4
ANALYTICS_WAIT_S = 600.0
_ANALYTICS_SETTINGS = ("CREDIT_ROWS", "CREDIT_FRAUDS", "IFOREST",
                       "ACCESS_TENANTS", "ACCESS_USERS", "ACCESS_RES",
                       "ACCESS_DEPTS", "ACCESS_ROWS", "ACCESS_CROSS",
                       "ACCESS", "ANALYTICS_CPU_THREADS")


def credit_like(rows: int, frauds: int, seed: int = 0):
    """A credit-card-shaped table: Time (seconds over two days, sorted),
    V1-V28 (normal, standard deviations falling from 2 to 0.3 as PCA
    components' do), Amount (log-normal, cents); ``frauds`` rows planted
    off the bulk, shifted 3-6 standard deviations in V1-V14 and with larger
    amounts. (X float32 [rows, 30], planted bool [rows])."""
    rng = np.random.default_rng(seed)
    X = np.empty((rows, CREDIT_FEATURES), np.float32)
    X[:, 0] = np.sort(rng.uniform(0.0, 172_792.0, rows))
    sd = np.linspace(2.0, 0.3, 28)
    X[:, 1:29] = rng.normal(size=(rows, 28)) * sd
    X[:, 29] = np.round(rng.lognormal(3.0, 1.4, rows), 2)
    planted = np.zeros(rows, bool)
    idx = rng.choice(rows, frauds, replace=False)
    planted[idx] = True
    sign = np.where(rng.random(14) < 0.5, -1.0, 1.0)
    X[idx, 1:15] += (sign * sd[:14] * rng.uniform(3.0, 6.0, (frauds, 14))
                     ).astype(np.float32)
    X[idx, 29] = np.round(rng.lognormal(5.0, 1.0, frauds), 2)
    return X, planted


def access_log(tenants: int, users: int, res: int, depts: int, rows: int,
               cross: float, seed: int = 0) -> dict:
    """Access-log columns (``tenant``, ``user``, ``res``, ``likelihood``
    accesses a day, and the ``planted`` mask): user u belongs to department
    u % depts and reaches its department's resource group (res / depts
    resources), but for a ``cross`` share of planted accesses to another
    department's group. Each tenant ``rows`` accesses."""
    rng = np.random.default_rng(seed)
    per = res // depts
    cols = {k: [] for k in ("tenant", "user", "res", "likelihood",
                            "planted")}
    for t in range(tenants):
        u = rng.integers(0, users, rows)
        planted = rng.random(rows) < cross
        dept = (u % depts + planted * rng.integers(1, depts, rows)) % depts
        cols["tenant"].append(np.full(rows, t, np.int64))
        cols["user"].append(u.astype(np.int64))
        cols["res"].append((dept * per + rng.integers(0, per, rows)
                            ).astype(np.int64))
        cols["likelihood"].append(rng.integers(1, 10, rows).astype(
            np.float64))
        cols["planted"].append(planted)
    return {k: np.concatenate(v) for k, v in cols.items()}


def movielens_like(users: int, items: int, ratings: int, seed: int = 0
                   ) -> dict:
    """Rating-log columns (``user``, ``item``, ``rating`` 0.5-5 in halves,
    ``time`` epoch seconds in [ML_T0, ML_T1]): every user at least
    ML_MIN_PER_USER ratings and the rest drawn by a heavy-tailed activity,
    items by a power law of popularity (exponent 0.9) over a seeded item
    order, every item rated at least once."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(users, dtype=np.int64),
                     min(ML_MIN_PER_USER, ratings // max(users, 1)))
    activity = rng.pareto(1.2, users) + 1.0
    user = np.concatenate([base, rng.choice(
        users, ratings - base.size, p=activity / activity.sum())])
    pop = 1.0 / np.arange(1, items + 1) ** 0.9
    item = rng.permutation(items)[rng.choice(items, ratings,
                                             p=pop / pop.sum())]
    item[:items] = np.arange(items)
    return {"user": user, "item": item.astype(np.int64),
            "rating": (rng.integers(1, 11, ratings) / 2.0).astype(np.float32),
            "time": rng.integers(ML_T0, ML_T1 + 1, ratings).astype(
                np.int64)}


def sift_like(base: int, dim: int, queries: int, seed: int = 0):
    """SIFT-shaped descriptors: non-negative, heavy-tailed, integer-valued
    0-255 (so inner products, below 128 x 255^2 < 2^24, are exact in
    float32), drawn around 256 seeded centres. (keys [base, dim], queries
    [queries, dim]) float32."""
    rng = np.random.default_rng(seed)
    centres = rng.gamma(0.5, 40.0, size=(256, dim)).astype(np.float32)
    out = np.empty((base + queries, dim), np.float32)
    step = 1 << 17
    for s in range(0, base + queries, step):
        n = min(step, base + queries - s)
        x = centres[rng.integers(0, 256, n)] * rng.standard_exponential(
            (n, dim), np.float32)
        out[s:s + n] = np.clip(np.round(x), 0, 255)
    return out[:base], out[base:]


def _auc64(planted, score) -> float:
    """AUC of ``score`` against the planted mask, ties counted half
    (float64 ranks)."""
    from scipy.stats import rankdata

    planted = np.asarray(planted, bool)
    r = rankdata(np.asarray(score, np.float64))
    pos = int(planted.sum())
    neg = planted.size - pos
    return float((r[planted].sum() - pos * (pos + 1) / 2) / (pos * neg))


@contextlib.contextmanager
def timed_calls(owner, name: str, dev: str, seconds: list):
    """Time every call of ``owner.name`` (a function of a module, or a
    method or static method of a class; the card synchronized at its end)
    into ``seconds`` while the block runs."""
    fn = owner.__dict__[name]
    real = fn.__func__ if isinstance(fn, staticmethod) else fn

    def timed(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        _sync(dev)
        seconds.append(time.perf_counter() - t)
        return out

    setattr(owner, name, staticmethod(timed) if isinstance(fn, staticmethod)
            else timed)
    try:
        yield seconds
    finally:
        setattr(owner, name, fn)


def _host_rss_gib() -> tuple:
    """(current, peak) resident memory of this process, GiB."""
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    cur = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                cur = int(line.split()[1]) / 2 ** 20
    return cur, peak


def _analytics_cpu(out_dir: str, settings: dict) -> None:
    """The CPU port's (a) and (b) (a spawned process beside the card's
    work): the forest, its scores and threshold, and tenant 0's implicit
    and explicit scores, each written whole and then renamed."""
    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.cyber import AccessAnomaly
    from synapseml_tpu_torch.isolationforest import IsolationForest

    torch.set_num_threads(ANALYTICS_CPU_THREADS)

    def put(name: str, **arrays) -> None:
        tmp = os.path.join(out_dir, f".{name}")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(out_dir, name))

    X, _ = credit_like(CREDIT_ROWS, CREDIT_FRAUDS)
    t0 = time.perf_counter()
    model = IsolationForest(device="cpu", **IFOREST).fit(
        Table({"features": X}))
    f = model.get("forest")
    put("iforest.npz",
        scores=model.transform(Table({"features": X}))[model.getScoreCol()],
        threshold=np.float64(f["threshold"]),
        seconds=np.float64(time.perf_counter() - t0),
        **{k: f[k] for k in ("feat", "thresh", "left", "plen")})
    del X
    t0_table = _access_tenant0()
    out = {}
    for mode, implicit in (("implicit", True), ("explicit", False)):
        t0 = time.perf_counter()
        m = AccessAnomaly(applyImplicitCf=implicit, device="cpu",
                          **ACCESS).fit(Table(t0_table))
        out[mode] = m.transform(Table(t0_table))[m.getOutputCol()]
        out[f"{mode}_seconds"] = np.float64(time.perf_counter() - t0)
    put("access.npz", **out)


def _access_tenant0() -> dict:
    """Tenant 0's columns of (b)'s log (no ``planted`` column)."""
    cols = access_log(ACCESS_TENANTS, ACCESS_USERS, ACCESS_RES,
                      ACCESS_DEPTS, ACCESS_ROWS, ACCESS_CROSS)
    sel = cols["tenant"] == 0
    return {k: v[sel] for k, v in cols.items() if k != "planted"}


def start_analytics_cpu():
    """(a) and (b) on the CPU port in a spawned process: (process, dir)."""
    out = tempfile.mkdtemp(prefix="analytics_cpu_")
    ctx = torch.multiprocessing.get_context("spawn")
    p = ctx.Process(target=_analytics_cpu, args=(
        out, {k: globals()[k] for k in _ANALYTICS_SETTINGS}))
    p.start()
    return p, out


def _cpu_result(cpu, name: str) -> dict:
    """The CPU process's ``name`` (waiting for it up to ANALYTICS_WAIT_S)."""
    proc, out = cpu
    path = os.path.join(out, name)
    deadline = time.monotonic() + ANALYTICS_WAIT_S
    while not os.path.exists(path):
        if not proc.is_alive() and not os.path.exists(path):
            raise AssertionError(f"phase 23: the CPU process ended "
                                 f"(exit code {proc.exitcode}) without "
                                 f"{name}")
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 23: {name} never came")
        time.sleep(0.05)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _stream_rate(scorer, events: list, dev: str) -> dict:
    """``events`` through a ``StreamingAnomalyLoop`` scored by ``scorer``
    at ANOMALY_BATCH: updates/s, events/s, flags."""
    from synapseml_tpu_torch.online import (StreamingAnomalyLoop,
                                            anomaly_feedback_log)

    log_ = anomaly_feedback_log(capacity=len(events) + 1,
                                dedup_window=len(events) + 1)
    for ev in events:
        log_.offer(ev)
    loop = StreamingAnomalyLoop(log_, scorer, batch_size=ANOMALY_BATCH,
                                window=4096, min_window=256,
                                contamination=0.01)
    t = time.perf_counter()
    loop.run_until_drained()
    _sync(dev)
    s = time.perf_counter() - t
    return {"updates": loop.updates, "scored": loop.scored,
            "flagged": loop.flagged, "s": s,
            "updates_per_s": loop.updates / s, "events_per_s": loop.scored / s}


def iforest_part(dev: str, cpu, fails: list) -> tuple:
    """(a): fit (host growth and card scoring timed apart), transform,
    AUC against the planted frauds, the streaming adapter. Returns the
    results and the check against the CPU port's forest and scores (run
    once the CPU process is done)."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.isolationforest import IsolationForest
    from synapseml_tpu_torch.isolationforest import iforest as iforest_mod
    from synapseml_tpu_torch.online import AnomalyEvent, iforest_stream_scorer

    t = time.perf_counter()
    X, planted = credit_like(CREDIT_ROWS, CREDIT_FRAUDS)
    log(f"  (a) credit-card-shaped table {X.shape}, {int(planted.sum())} "
        f"planted frauds, made in {time.perf_counter() - t:.2f}s")
    table = Table({"features": X})
    with timed_calls(iforest_mod, "_score", dev, []) as score_s:
        t = time.perf_counter()
        model = IsolationForest(device=dev, **IFOREST).fit(table)
        fit_s = time.perf_counter() - t
    t = time.perf_counter()
    out = model.transform(table)
    tr_s = time.perf_counter() - t
    scores = out[model.getScoreCol()]
    labels = out[model.getPredictionCol()]
    auc = _auc64(planted, scores)
    f = model.get("forest")
    res = {"fit_s": fit_s, "grow_s": fit_s - sum(score_s),
           "score_s": sum(score_s), "transform_rows_per_s": len(X) / tr_s,
           "auc": auc, "flagged": int(labels.sum()),
           "flagged_planted": int(labels[planted].sum())}
    log(f"    fit {fit_s:.3f}s (host growth {res['grow_s']:.3f}s, card "
        f"scoring {res['score_s']:.3f}s); transform {tr_s:.3f}s = "
        f"{res['transform_rows_per_s']:.0f} rows/s; AUC {auc:.6f}; "
        f"{res['flagged']} flagged, {res['flagged_planted']} of them planted")
    if not np.isfinite(scores).all() or scores.shape != (len(X),):
        fails.append("(a) scores not finite or of the wrong shape")
    if auc < 0.9:
        fails.append(f"(a) AUC {auc:.4f} below 0.9 on the planted frauds")

    def against_cpu() -> None:
        ref = _cpu_result(cpu, "iforest.npz")
        for k in ("feat", "thresh", "left", "plen"):
            if not np.array_equal(ref[k], f[k]):
                fails.append(f"(a) the CPU port's forest {k} differs")
        gap = float(np.abs(ref["scores"] - scores).max())
        thr = float(ref["threshold"])
        near = np.abs(ref["scores"] - thr) <= IFOREST_TOL
        flips = int(((ref["scores"] >= thr) != (labels > 0))[~near].sum())
        res.update(cpu_gap=gap, cpu_threshold_gap=abs(thr - f["threshold"]),
                   cpu_label_flips=flips, cpu_fit_s=float(ref["seconds"]))
        log(f"    (a) card against the CPU port: forest arrays equal, max "
            f"|score gap| {gap:.3e}, threshold gap "
            f"{res['cpu_threshold_gap']:.3e}, {flips} labels differ away "
            f"from the threshold ({int(near.sum())} rows within "
            f"{IFOREST_TOL} of it); CPU fit + score {ref['seconds']:.2f}s")
        if gap > IFOREST_TOL or res["cpu_threshold_gap"] > IFOREST_TOL \
                or flips:
            fails.append(f"(a) card against CPU: score gap {gap:.3e}, "
                         f"{flips} label flips")

    events = [AnomalyEvent(key=f"tx{i}", features=X[i % len(X)])
              for i in range(ANOMALY_EVENTS)]
    st = _stream_rate(iforest_stream_scorer(model), events, dev)
    res["stream"] = st
    log(f"    iforest_stream_scorer: {st['scored']} events in "
        f"{st['updates']} updates of {ANOMALY_BATCH} in {st['s']:.3f}s = "
        f"{st['updates_per_s']:.1f} updates/s, {st['events_per_s']:.0f} "
        f"events/s, {st['flagged']} flagged")
    if st["scored"] != ANOMALY_EVENTS:
        fails.append(f"(a) the loop scored {st['scored']} events")
    return res, against_cpu


def access_part(dev: str, cpu, fails: list) -> tuple:
    """(b): implicit fits of every tenant (seconds each), transform, the
    planted accesses' share of each tenant's top 1%, explicit mode on
    tenant 0, the streaming adapter. Returns the results and the check of
    tenant 0 against the CPU port (run once the CPU process is done)."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.cyber import AccessAnomaly
    from synapseml_tpu_torch.online import (AnomalyEvent,
                                            access_anomaly_stream_scorer)

    class Timed(AccessAnomaly):
        """Times each tenant's fit into ``tenant_s``."""

        def _fit_tenant(self, df):
            t = time.perf_counter()
            out = super()._fit_tenant(df)
            self.tenant_s.append(time.perf_counter() - t)
            return out

    t = time.perf_counter()
    cols = access_log(ACCESS_TENANTS, ACCESS_USERS, ACCESS_RES, ACCESS_DEPTS,
                      ACCESS_ROWS, ACCESS_CROSS)
    planted = cols.pop("planted")
    table = Table(cols)
    log(f"  (b) access log: {ACCESS_TENANTS} tenants x {ACCESS_ROWS} "
        f"accesses ({ACCESS_USERS} users, {ACCESS_RES} resources, "
        f"{ACCESS_DEPTS} departments), {int(planted.sum())} planted, made "
        f"in {time.perf_counter() - t:.2f}s")
    res = {}
    est = Timed(device=dev, **ACCESS)
    est.tenant_s = []
    t = time.perf_counter()
    model = est.fit(table)
    res["fit_s"] = time.perf_counter() - t
    res["tenant_fit_s"] = list(est.tenant_s)
    t = time.perf_counter()
    scores = model.transform(table)[model.getOutputCol()]
    tr_s = time.perf_counter() - t
    res["transform_rows_per_s"] = len(scores) / tr_s
    shares = []
    for ten in range(ACCESS_TENANTS):
        sel = np.flatnonzero(cols["tenant"] == ten)
        top = sel[np.argsort(-scores[sel], kind="stable")[:len(sel) // 100]]
        shares.append(float(planted[top].mean()))
    res["planted_share_top1pct"] = shares
    log(f"    implicit fit {res['fit_s']:.3f}s, per tenant "
        f"{[round(s, 3) for s in est.tenant_s]}s; transform {tr_s:.3f}s = "
        f"{res['transform_rows_per_s']:.0f} rows/s; planted share of each "
        f"tenant's top 1%: {[round(s, 4) for s in shares]} (base rate "
        f"{planted.mean():.4f})")
    if not np.isfinite(scores).all():
        fails.append("(b) scores not finite")
    if min(shares) < 10 * ACCESS_CROSS:
        fails.append(f"(b) planted share of a top 1% {min(shares):.3f} "
                     f"below {10 * ACCESS_CROSS}")
    sel0 = np.flatnonzero(cols["tenant"] == 0)
    t0_table = Table({k: v[sel0] for k, v in cols.items()})
    card = {"implicit": scores[sel0]}
    t = time.perf_counter()
    ex = AccessAnomaly(applyImplicitCf=False, device=dev, **ACCESS).fit(
        t0_table)
    res["explicit_fit_s"] = time.perf_counter() - t
    card["explicit"] = ex.transform(t0_table)[ex.getOutputCol()]
    top = np.argsort(-card["explicit"], kind="stable")[:len(sel0) // 100]
    res["explicit_planted_share_top1pct"] = float(planted[sel0][top].mean())
    log(f"    explicit fit on tenant 0 {res['explicit_fit_s']:.3f}s; "
        f"planted share of its top 1% "
        f"{res['explicit_planted_share_top1pct']:.4f}")
    def against_cpu() -> None:
        ref = _cpu_result(cpu, "access.npz")
        for mode in ("implicit", "explicit"):
            gap = float(np.abs(ref[mode] - card[mode]).max())
            a = set(np.argsort(-card[mode], kind="stable")[:ACCESS_TOP])
            b = set(np.argsort(-ref[mode], kind="stable")[:ACCESS_TOP])
            agree = len(a & b) / ACCESS_TOP
            res[f"{mode}_cpu_gap"], res[f"{mode}_top_agree"] = gap, agree
            log(f"    (b) {mode} card against the CPU port on tenant 0: max "
                f"|normalized score gap| {gap:.3e}, top {ACCESS_TOP} sets "
                f"{agree:.4f} equal; CPU fit + transform "
                f"{float(ref[mode + '_seconds']):.2f}s")
            if gap > ACCESS_SCORE_TOL or agree < ACCESS_TOP_AGREE:
                fails.append(f"(b) {mode} card against CPU: gap {gap:.3e},"
                             f" top-{ACCESS_TOP} agreement {agree:.4f}")

    rows = np.arange(ANOMALY_EVENTS) % len(scores)
    events = [AnomalyEvent(key=f"acc{i}", features={
        "tenant": int(cols["tenant"][r]), "user": int(cols["user"][r]),
        "res": int(cols["res"][r])}) for i, r in enumerate(rows)]
    st = _stream_rate(access_anomaly_stream_scorer(model), events, dev)
    res["stream"] = st
    log(f"    access_anomaly_stream_scorer: {st['scored']} events in "
        f"{st['updates']} updates in {st['s']:.3f}s = "
        f"{st['updates_per_s']:.1f} updates/s, {st['events_per_s']:.0f} "
        f"events/s")
    if st["scored"] != ANOMALY_EVENTS:
        fails.append(f"(b) the loop scored {st['scored']} events")
    return res, against_cpu


def _cooccurrence_columns(cols: dict, support: int, check: np.ndarray):
    """float64 co-occurrence counts C[:, check] and the item supports of
    the support-filtered 0/1 occurrence matrix, from the rating log on the
    host (scipy's sparse product: integer sums, exact)."""
    import scipy.sparse as sp

    users, items = cols["user"], cols["item"]
    n_u, n_i = int(users.max()) + 1, int(items.max()) + 1
    occ = sp.csr_matrix((np.ones(len(users)), (users, items)),
                        shape=(n_u, n_i))
    occ.data[:] = 1.0                              # duplicates count once
    diag = np.asarray(occ.sum(axis=0)).ravel()
    active = diag >= support
    occ = occ @ sp.diags(active.astype(np.float64))
    diag = diag * active
    c = np.asarray((occ.T @ occ[:, check]).todense())
    return c, diag


def sar_part(dev: str, fails: list) -> dict:
    """(c): fit (host matrices and card similarity timed apart), the
    similarity against float64 counts, recommend_for_all_users,
    recommend_for_user_subset against the CPU port, transform."""
    from synapseml_tpu_torch.convert import sar_model_from_reference
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.recommendation import SAR
    from synapseml_tpu_torch.recommendation import sar as sar_mod

    t = time.perf_counter()
    cols = movielens_like(ML_USERS, ML_ITEMS, ML_RATINGS)
    log(f"  (c) MovieLens-10M-shaped log: {ML_RATINGS} ratings of "
        f"{ML_USERS} users x {ML_ITEMS} items, made in "
        f"{time.perf_counter() - t:.2f}s")
    res = {}
    with timed_calls(sar_mod, "_similarity", dev, []) as sim_s:
        t = time.perf_counter()
        model = SAR(device=dev, **SAR_PARAMS).fit(Table(dict(cols)))
        res["fit_s"] = time.perf_counter() - t
    res["similarity_s"] = sum(sim_s)
    res["host_s"] = res["fit_s"] - res["similarity_s"]
    cur, peak = _host_rss_gib()
    res["host_rss_gib"], res["host_peak_gib"] = cur, peak
    sim = model.get("itemSimilarity")
    aff = model.get("userAffinity")
    log(f"    fit {res['fit_s']:.3f}s: host matrices {res['host_s']:.3f}s, "
        f"card similarity (occurrence upload, O^T O, jaccard, download) "
        f"{res['similarity_s']:.3f}s; similarity {sim.shape}, affinity "
        f"{aff.shape}; host RSS {cur:.2f} GiB, peak {peak:.2f} GiB")
    check = np.sort(np.random.default_rng(5).choice(
        sim.shape[0], SAR_CHECK_COLS, replace=False))
    c, diag = _cooccurrence_columns(cols, SAR_PARAMS["supportThreshold"],
                                    check)
    denom = diag[:, None] + diag[check][None, :] - c
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.where(denom > 0, c / denom, 0.0).astype(np.float32)
    bad = int((sim[:, check] != want).sum())
    res["similarity_mismatches"] = bad
    log(f"    similarity on {SAR_CHECK_COLS} columns against float64 host "
        f"counts: {bad} of {want.size} entries differ (bitwise)")
    if bad:
        fails.append(f"(c) {bad} similarity entries differ from the "
                     "float64 counts")
    t = time.perf_counter()
    recs = model.recommend_for_all_users(SAR_K)
    all_s = time.perf_counter() - t
    res["all_users_per_s"] = aff.shape[0] / all_s
    log(f"    recommend_for_all_users({SAR_K}): {aff.shape[0]} users in "
        f"{all_s:.3f}s = {res['all_users_per_s']:.0f} users/s")
    if recs["recommendations"].shape != (aff.shape[0], SAR_K) or \
            not np.isfinite(recs["ratings"]).all():
        fails.append("(c) recommend_for_all_users: wrong shape or "
                     "non-finite ratings")
    users = np.sort(np.random.default_rng(6).choice(
        aff.shape[0], SAR_SUBSET, replace=False))
    t = time.perf_counter()
    sub = model.recommend_for_user_subset(Table({"user": users}), SAR_K)
    res["subset_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cpu = sar_model_from_reference(sim, aff[users], device="cpu")
    ref = cpu.recommend_for_all_users(SAR_K + 1)
    res["cpu_subset_s"] = time.perf_counter() - t
    ri, rv = ref["recommendations"], ref["ratings"]
    near = np.abs(rv[:, SAR_K - 1] - rv[:, SAR_K]) <= SAR_TIE_RTOL * \
        np.abs(rv[:, SAR_K - 1])
    same = np.array([set(a) == set(b) for a, b in
                     zip(sub["recommendations"], ri[:, :SAR_K])])
    rgap = float((np.abs(sub["ratings"] - rv[:, :SAR_K]) / np.maximum(
        np.abs(rv[:, :SAR_K]), 1e-30)).max())
    res.update(subset_differ=int((~same).sum()),
               subset_near_ties=int(near.sum()),
               subset_differ_not_near=int((~same & ~near).sum()),
               subset_rating_rel_gap=rgap,
               subset_equal_to_all_users=bool(np.array_equal(
                   sub["recommendations"],
                   recs["recommendations"][users])))
    log(f"    recommend_for_user_subset of {SAR_SUBSET} users "
        f"{res['subset_s']:.3f}s (the CPU port's top {SAR_K + 1}: "
        f"{res['cpu_subset_s']:.2f}s): {res['subset_differ']} top-{SAR_K} "
        f"sets differ, {res['subset_near_ties']} rows with a near tie at "
        f"the cut, {res['subset_differ_not_near']} differ away from one; "
        f"ratings within {rgap:.2e} relative; equal to those users' rows "
        f"of recommend_for_all_users: {res['subset_equal_to_all_users']}")
    if res["subset_differ_not_near"] or rgap > SAR_TIE_RTOL:
        fails.append(f"(c) top-{SAR_K} against the CPU port: "
                     f"{res['subset_differ_not_near']} rows differ, "
                     f"ratings {rgap:.2e} relative")
    rng = np.random.default_rng(7)
    pairs = Table({"user": rng.integers(0, aff.shape[0], SAR_PAIRS),
                   "item": rng.integers(0, sim.shape[0], SAR_PAIRS)})
    t = time.perf_counter()
    pred = model.transform(pairs)["prediction"]
    tr_s = time.perf_counter() - t
    res["transform_pairs_per_s"] = SAR_PAIRS / tr_s
    cur, peak = _host_rss_gib()
    log(f"    transform of {SAR_PAIRS} (user, item) pairs {tr_s:.3f}s = "
        f"{res['transform_pairs_per_s']:.0f} pairs/s; host RSS {cur:.2f} "
        f"GiB, peak {peak:.2f} GiB")
    if pred.shape != (SAR_PAIRS,) or not np.isfinite(pred).all():
        fails.append("(c) transform: wrong shape or non-finite")
    return res


def _host_top_k(s: np.ndarray, k: int) -> np.ndarray:
    """Top-k indices by (-score, index) of each row (host): the entries at
    or above the row's k-th largest, ordered by (-score, index)."""
    out = np.empty((len(s), k), np.int64)
    kth = -np.partition(-s, k - 1, axis=1)[:, k - 1]
    for r in range(len(s)):
        cand = np.flatnonzero(s[r] >= kth[r])
        out[r] = cand[np.lexsort((cand, -s[r, cand]))[:k]]
    return out


def _recall_check(label: str, idx: np.ndarray, s64: np.ndarray,
                  fails: list) -> dict:
    """``idx`` (the port's top-KNN_K) against the float64 scores ``s64``:
    recall 1.0 on every query whose KNN_K-th and next inner products are
    not within KNN_TIE_RTOL."""
    ref = _host_top_k(s64, KNN_K + 1)
    kth = np.take_along_axis(s64, ref[:, KNN_K - 1:KNN_K + 1], 1)
    near = np.abs(kth[:, 0] - kth[:, 1]) <= KNN_TIE_RTOL * np.abs(kth[:, 0])
    recall = np.array([len(set(a) & set(b)) / KNN_K
                       for a, b in zip(idx, ref[:, :KNN_K])])
    exact = float((idx == ref[:, :KNN_K]).all(axis=1).mean())
    out = {"recall": float(recall.mean()), "near_ties": int(near.sum()),
           "short_away_from_a_tie": int(((recall < 1.0) & ~near).sum()),
           "same_order": exact}
    log(f"    {label}: recall@{KNN_K} {out['recall']:.6f} on "
        f"{len(idx)} queries ({out['near_ties']} with a near tie at the "
        f"cut, {out['short_away_from_a_tie']} short away from one); "
        f"the float64 order exactly on {exact:.4f}")
    if out["short_away_from_a_tie"]:
        fails.append(f"(d) {label}: {out['short_away_from_a_tie']} "
                     "queries miss a neighbour away from a tie")
    return out


def knn_part(dev: str, fails: list) -> dict:
    """(d): KNN index build, queries/s pruned and brute force, against a
    float64 host brute force; ConditionalKNN with label sets."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.nn import ConditionalKNN, KNN

    t = time.perf_counter()
    keys, queries = sift_like(SIFT_BASE, SIFT_DIM, SIFT_QUERIES)
    log(f"  (d) SIFT1M-shaped corpus {keys.shape}, {len(queries)} queries, "
        f"made in {time.perf_counter() - t:.2f}s")
    res = {}
    rng = np.random.default_rng(8)
    labels = rng.integers(0, KNN_LABELS, len(keys))
    conds = [rng.choice(KNN_LABELS, KNN_COND, replace=False).tolist()
             for _ in range(KNN_CHECK)]
    # ConditionalKNN's index is built in a thread beside KNN.fit's (numpy
    # releases the GIL in the splits' array work)
    cfit = {}

    def conditional_fit() -> None:
        t = time.perf_counter()
        try:
            cfit["model"] = ConditionalKNN(k=KNN_K, device=dev).fit(
                Table({"features": keys, "labels": labels}))
        except Exception as e:              # re-raised in the phase
            cfit["error"] = e
        cfit["s"] = time.perf_counter() - t

    builder = threading.Thread(target=conditional_fit, daemon=True)
    builder.start()
    t = time.perf_counter()
    model = KNN(k=KNN_K, device=dev).fit(Table({"features": keys}))
    res["build_s"] = time.perf_counter() - t
    tree = model.getBallTree()
    log(f"    KNN.fit (host ball index: {tree.num_blocks} blocks) "
        f"{res['build_s']:.3f}s, ConditionalKNN.fit's beside it")
    tree.query_batch(queries[:8], KNN_K, prune=False)   # keys to the card
    _sync(dev)
    runs = {}
    for label, prune in (("brute force", False), ("pruned", True)):
        t = time.perf_counter()
        runs[label] = tree.query_batch(queries, KNN_K, prune=prune)
        _sync(dev)
        s = time.perf_counter() - t
        res[f"{label.replace(' ', '_')}_queries_per_s"] = len(queries) / s
        log(f"    {label}: {len(queries)} queries in {s:.3f}s = "
            f"{len(queries) / s:.0f} queries/s")
    t = time.perf_counter()
    out = model.transform(Table({"features": queries}))[model.getOutputCol()]
    res["transform_s"] = time.perf_counter() - t
    log(f"    KNNModel.transform of {len(queries)} query rows "
        f"{res['transform_s']:.3f}s")
    if len(out) != len(queries) or len(out[0]) != KNN_K:
        fails.append("(d) transform: wrong shape")
    q64 = queries[:KNN_CHECK].astype(np.float64)
    t = time.perf_counter()
    s64 = q64 @ keys.astype(np.float64).T
    log(f"    float64 host brute force of {KNN_CHECK} queries "
        f"{time.perf_counter() - t:.2f}s")
    for label, (idx, _) in runs.items():
        res[label] = _recall_check(label, idx[:KNN_CHECK], s64, fails)
    t = time.perf_counter()
    builder.join()
    if "error" in cfit:
        raise cfit["error"]
    cmodel = cfit["model"]
    res["conditional_build_s"] = cfit["s"]
    res["conditional_build_wait_s"] = time.perf_counter() - t
    cq = np.empty(KNN_CHECK, dtype=object)
    cq[:] = conds
    t = time.perf_counter()
    cout = cmodel.transform(Table({"features": queries[:KNN_CHECK],
                                   "conditioner": cq}))[
        cmodel.getOutputCol()]
    res["conditional_transform_s"] = time.perf_counter() - t
    log(f"    ConditionalKNN: fit {res['conditional_build_s']:.3f}s "
        f"(beside KNN.fit; waited {res['conditional_build_wait_s']:.3f}s "
        f"for it after the KNN queries), transform of {KNN_CHECK} queries with {KNN_COND} of "
        f"{KNN_LABELS} labels each {res['conditional_transform_s']:.3f}s")
    admissible = np.stack([np.isin(labels, c) for c in conds])
    cidx = np.array([[m["value"] for m in row] for row in cout])
    if any(not admissible[r, cidx[r]].all() for r in range(len(cidx))):
        fails.append("(d) ConditionalKNN returned an inadmissible key")
    res["conditional"] = _recall_check(
        "ConditionalKNN", cidx, np.where(admissible, s64, -np.inf), fails)
    return res


def analytics_path(dev: str) -> dict:
    """Phase 23: (a)-(d) above; every failure is collected and raised at
    the end."""
    cpu = start_analytics_cpu()
    fails, out = [], {}
    t0 = [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        log(f"  ({name}) took {now - t0[0]:.1f}s")
        t0[0] = now

    checks = []

    def with_check(result: tuple) -> dict:
        checks.append(result[1])
        return result[0]

    try:
        for name, run in (
                ("a", lambda: with_check(iforest_part(dev, cpu, fails))),
                ("b", lambda: with_check(access_part(dev, cpu, fails))),
                ("c", lambda: sar_part(dev, fails)),
                ("d", lambda: knn_part(dev, fails)),
                ("card against the CPU process", lambda: [
                    check() for check in checks])):
            try:
                out[name] = run()
            except Exception as e:          # collected, raised at the end
                import traceback

                traceback.print_exc()
                fails.append(f"({name}) raised {type(e).__name__}: {e}")
            part(name)
            if _on_card(dev):
                torch.cuda.empty_cache()
    finally:
        cpu[0].join(timeout=ANALYTICS_WAIT_S)
        if cpu[0].is_alive():
            cpu[0].terminate()
            fails.append("phase 23: the CPU process did not end")
    out.pop("card against the CPU process", None)
    log(f"  phase 23 results {json.dumps(out, default=float)}")
    if fails:
        raise AssertionError("phase 23: " + "; ".join(fails))
    return out


# ---------------------------------------------------------------------------
# phase 24: explainers, causal inference, the image ops and leaf histograms
# ---------------------------------------------------------------------------

# (a) KernelSHAP and LIME on phase 3's classifier, its 28 features as the
# named columns f0..f27: the table's first EXPLAIN_ROWS rows, SHAP at its
# default 2 * 28 + 2048 samples a row (2,154,496 rows scored), LIME at its
# default 1,000. Card against the CPU port on the same rows (the same host
# draws, the same trees): phi and the LIME coefficients within EXPLAIN_TOL
# (float32 solves over 2,104 samples in other orders), SHAP's local
# accuracy sum(phi) = f(x) - base within ADDITIVITY_TOL; 512 rows (1,024
# before phase 25 was added)
EXPLAIN_ROWS = 512
EXPLAIN_TOL, ADDITIVITY_TOL = 1e-4, 1e-4
# (b) ImageLIME on phase 11's seeded ResNet-50 (the estimator's seed-0
# initial state) at 224x224: IMAGE_LIME_IMAGES CIFAR-shaped images resized,
# IMAGE_LIME_SAMPLES masks each, SLIC at cellSize IMAGE_LIME_CELL (196
# superpixels), class 0's probability explained. The CPU port explains the
# first image (its masks are the first of the one generator's draws): its
# 256 scores within IMAGE_SCORE_TOL of the card's (the float32 logits'
# cuDNN-against-oneDNN gap, VISION_LOGIT_TOL, after a softmax), and its
# coefficients within IMAGE_LIME_TOL (a 197-unknown solve over 256 samples
# magnifies that gap); 2 images (4 before phase 25 was added)
IMAGE_LIME_IMAGES, IMAGE_LIME_SAMPLES, IMAGE_LIME_CELL = 2, 256, 16
IMAGE_SCORE_TOL, IMAGE_LIME_TOL = 1e-4, 1e-3
# (c) DoubleML on DML_ROWS HIGGS-shaped rows: the treatment drawn with
# propensity sigmoid(X0 + 0.5 X2), the outcome DML_ATE * T + the HIGGS
# margin + X0 (X0 confounds both); LightGBMRegressor nuisance models of
# DML_ITERS iterations at learning rate DML_LR, maxIter 1. The ATE within
# DML_ATE_TOL of the planted effect; on the first DML_PREFIX rows the
# card's ATE within DML_CARD_TOL of the CPU port's (the same trees but
# where float32 sums on the card split a near tie another way); 250,000
# rows and a 25,000-row prefix (500,000 and 50,000 before phase 25 was
# added)
DML_ROWS, DML_PREFIX, DML_ITERS, DML_LR, DML_ATE = \
    250_000, 25_000, 20, 0.3, 2.0
DML_ATE_TOL, DML_CARD_TOL = 0.05, 5e-3
# (d) SyntheticDiffInDiff on panels (name, units, periods, treated units,
# pre-periods): Proposition 99's shape (Abadie, Diamond & Hainmueller 2010:
# 39 states x 31 years, 1970-2000, California treated from 1989) and a
# 2,000 x 200 panel; unit and time weights within SDID_TOL of the CPU port's
PANELS = (("proposition 99", 39, 31, 1, 19),
          ("2000 x 200", 2_000, 200, 20, 160))
PANEL_EFFECT, SDID_TOL = -15.0, 1e-4
# (e) every image op on IMAGE_OPS_N x 224 x 224 x 3 float32 images in
# [0, 1] against the CPU port within IMAGE_OPS_TOL; leaf_histograms at
# HIST_ROWS x 28 features x HIST_BINS bins x HIST_LEAVES leaves against the
# CPU port (counts exact, sums within HIST_REL of each bin's sum of
# magnitudes), and sharded_histogram_fn on MESH_RANKS gloo ranks sharing
# the card (equal on every rank)
IMAGE_OPS_N, IMAGE_OPS_SIDE, IMAGE_OPS_TOL = 256, 224, 1e-5
HIST_ROWS, HIST_BINS, HIST_LEAVES, HIST_REL = 2_000_000, 255, 31, 1e-5
# the CPU port's (a)-(c) in a spawned process beside the card's work
EXPLAIN_CPU_THREADS = 6
EXPLAIN_WAIT_S = 600.0
_EXPLAIN_SETTINGS = ("EXPLAIN_ROWS", "IMAGE_LIME_IMAGES",
                     "IMAGE_LIME_SAMPLES", "IMAGE_LIME_CELL", "DML_ROWS",
                     "DML_PREFIX",
                     "DML_ITERS", "DML_LR", "DML_ATE", "EXPLAIN_CPU_THREADS",
                     "VISION_BACKBONE", "VISION_CLASSES", "VISION_SIDE",
                     "VISION_SIZE")
FEATURE_NAMES = [f"f{i}" for i in range(FEATURES)]


class ColumnsModel:
    """The explainers' ``model`` for a classifier of one ``features``
    column: scores a table of the named columns ``FEATURE_NAMES``."""

    def __init__(self, model):
        self.model = model

    def transform(self, df):
        from synapseml_tpu_torch.core.table import Table

        feats = np.stack([np.asarray(df[c], np.float32)
                          for c in FEATURE_NAMES], 1)
        return self.model.transform(Table({"features": feats}))


def explain_rows(n: int) -> dict:
    """Phase 3's first ``n`` rows (``higgs_like`` draws its features row
    by row from one generator, before the labels) as named columns."""
    X, _ = higgs_like(n)
    return {c: X[:, i] for i, c in enumerate(FEATURE_NAMES)}


def dml_table(rows: int, seed: int = 24) -> dict:
    """(c)'s columns: ``features``, ``treatment``, ``outcome``."""
    X, margin = higgs_margin(rows, seed)
    rng = np.random.default_rng((seed, 1))
    p = 1.0 / (1.0 + np.exp(-(X[:, 0] + 0.5 * X[:, 2])))
    T = (rng.uniform(size=rows) < p).astype(np.float64)
    Y = DML_ATE * T + margin.astype(np.float64) + X[:, 0]
    return {"features": X, "treatment": T, "outcome": Y}


def panel_table(units: int, periods: int, treated: int, pre: int,
                seed: int = 24) -> dict:
    """A long panel: unit and period effects, a unit-specific trend and
    noise; ``PANEL_EFFECT`` added to the treated units' post periods."""
    rng = np.random.default_rng((seed, units, periods))
    u, t = np.meshgrid(np.arange(units), np.arange(periods), indexing="ij")
    y = (rng.normal(100.0, 20.0, size=(units, 1))
         + np.linspace(0.0, -30.0, periods)[None, :]
         + rng.normal(0.0, 0.5, size=(units, 1)) * np.arange(periods)
         + rng.normal(0.0, 2.0, size=(units, periods)))
    is_treated = u < treated
    is_post = t >= pre
    y = y + PANEL_EFFECT * (is_treated & is_post)
    return {"unit": u.ravel(), "time": t.ravel(), "outcome": y.ravel(),
            "treatment": is_treated.ravel().astype(np.float64),
            "postTreatment": is_post.ravel().astype(np.float64)}


def explain_images() -> np.ndarray:
    """(b)'s images: CIFAR-shaped, resized to ``VISION_SIZE`` in [0, 1]."""
    from synapseml_tpu_torch.dl import vision as tv

    imgs, _ = cifar_like(IMAGE_LIME_IMAGES, seed=24)
    return tv._resolve_images(imgs.astype(np.float32) / 255.0, VISION_SIZE)


def vision_model(state: dict, dev: str):
    """A ``DeepVisionModel`` of the ResNet-50 in ``state`` on ``dev``."""
    from synapseml_tpu_torch.dl import DeepVisionModel, make_backbone
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    tr = Trainer(make_backbone(VISION_BACKBONE, VISION_CLASSES),
                 TrainConfig(batch_size=64), device=dev).load_params(state)
    return DeepVisionModel(tr, np.arange(VISION_CLASSES), imageCol="image",
                           backbone=VISION_BACKBONE, device=dev)


def image_lime(model, images: np.ndarray, dev: str, scores: list):
    """ImageLIME of ``images`` with ``model``; every image's scores are
    appended to ``scores``."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.explainers import ImageLIME

    class Recording(ImageLIME):
        def _score(self, samples):
            y = super()._score(samples)
            scores.append(y)
            return y

    col = np.empty(len(images), object)
    for i in range(len(images)):
        col[i] = images[i]
    return Recording(model=model, targetCol="probability", targetClasses=[0],
                     numSamples=IMAGE_LIME_SAMPLES,
                     cellSize=float(IMAGE_LIME_CELL), device=dev).transform(
        Table({"image": col}))


def _stacked(col) -> np.ndarray:
    return np.stack([np.asarray(c, np.float64) for c in col])


def _explain_cpu(out_dir: str, model_dir: str, settings: dict,
                 backbones: dict) -> None:
    """The CPU port's (a)-(c) (a spawned process beside the card's work),
    each result written whole and then renamed: the ResNet-50's initial
    state (which the card loads too), SHAP and LIME on phase 3's rows,
    image 0's ImageLIME, and DoubleML on the prefix."""
    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.core.pipeline import PipelineStage
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.dl import backbones as tb
    from synapseml_tpu_torch.explainers import TabularLIME, TabularSHAP

    tb.BACKBONES.update(backbones)
    torch.set_num_threads(EXPLAIN_CPU_THREADS)

    def put(name: str, **arrays) -> None:
        tmp = os.path.join(out_dir, f".{name}")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(out_dir, name))

    state = vision_init_state()
    torch.save(state, os.path.join(out_dir, ".resnet.pt"))
    os.replace(os.path.join(out_dir, ".resnet.pt"),
               os.path.join(out_dir, "resnet.pt"))
    model = ColumnsModel(PipelineStage.load(model_dir, device="cpu"))
    rows = Table(explain_rows(EXPLAIN_ROWS))
    out = {}
    for name, cls in (("shap", TabularSHAP), ("lime", TabularLIME)):
        t0 = time.perf_counter()
        got = cls(model=model, inputCols=FEATURE_NAMES, targetClasses=[1],
                  device="cpu").transform(rows)
        out[name] = _stacked(got["explanation"])
        out[f"{name}_s"] = np.float64(time.perf_counter() - t0)
    put("tabular.npz", **out)
    scores = []
    t0 = time.perf_counter()
    got = image_lime(vision_model(state, "cpu"), explain_images()[:1],
                     "cpu", scores)
    put("image.npz", coefs=_stacked(got["explanation"])[0],
        scores=scores[0], seconds=np.float64(time.perf_counter() - t0))
    del state, got
    t0 = time.perf_counter()
    ate = dml_ate(Table(dml_prefix(dml_table(DML_ROWS))), "cpu")
    put("dml.npz", ate=np.float64(ate),
        seconds=np.float64(time.perf_counter() - t0))


def dml_prefix(cols: dict) -> dict:
    """The first ``DML_PREFIX`` rows of (c)'s columns."""
    return {k: v[:DML_PREFIX] for k, v in cols.items()}


def dml_ate(table, dev: str) -> float:
    """DoubleML's ATE on ``table`` with (c)'s nuisance models on
    ``dev``."""
    from synapseml_tpu_torch.causal import DoubleMLEstimator
    from synapseml_tpu_torch.models import LightGBMRegressor

    def nuisance():
        return LightGBMRegressor(numIterations=DML_ITERS,
                                 learningRate=DML_LR, device=dev)

    return DoubleMLEstimator(treatmentModel=nuisance(),
                             outcomeModel=nuisance(), maxIter=1,
                             seed=0).fit(table).get_avg_treatment_effect()


def start_explain_cpu(model):
    """(a)-(c) on the CPU port in a spawned process, given (a)'s
    classifier ``model``: (process, output dir)."""
    out = tempfile.mkdtemp(prefix="explain_cpu_")
    model_dir = os.path.join(out, "classifier")
    model.save(model_dir)
    ctx = torch.multiprocessing.get_context("spawn")
    p = ctx.Process(target=_explain_cpu, args=(
        out, model_dir, {k: globals()[k] for k in _EXPLAIN_SETTINGS},
        _state_settings()["backbones"]))
    p.start()
    return p, out


def _explain_result(cpu, name: str) -> str:
    """The path of the CPU process's ``name``, once written (waiting up to
    EXPLAIN_WAIT_S)."""
    proc, out = cpu
    path = os.path.join(out, name)
    deadline = time.monotonic() + EXPLAIN_WAIT_S
    while not os.path.exists(path):
        if not proc.is_alive() and not os.path.exists(path):
            raise AssertionError(f"phase 24: the CPU process ended (exit "
                                 f"code {proc.exitcode}) without {name}")
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 24: {name} never came")
        time.sleep(0.05)
    return path


def _npz(cpu, name: str) -> dict:
    with np.load(_explain_result(cpu, name)) as z:
        return {k: z[k] for k in z.files}


def replay_ms(runner, dev: str, reps: int = 10) -> dict:
    """Card ms of one replay of each captured bucket of ``runner`` (CUDA
    events on its stream; {} off the card)."""
    if not _on_card(dev):
        return {}
    out = {}
    for (bucket, _), entry in sorted(runner._compiled.items(),
                                     key=lambda kv: kv[0][0]):
        with torch.cuda.stream(runner.stream):
            entry.graph.replay()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record(runner.stream)
            for _ in range(reps):
                entry.graph.replay()
            t1.record(runner.stream)
        t1.synchronize()
        out[bucket] = round(t0.elapsed_time(t1) / reps, 4)
    return out


def tabular_part(model, dev: str) -> dict:
    """(a) on the card: each explainer's runner captured ahead for its
    sample shape, then SHAP and LIME timed, the steady state checked
    (no capture), each replay timed. Returns the outputs and readings."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.explainers import TabularLIME, TabularSHAP
    from synapseml_tpu_torch.explainers import base as eb
    from synapseml_tpu_torch.explainers import lime as el
    from synapseml_tpu_torch.explainers import shap as es
    from synapseml_tpu_torch.explainers import solvers

    rows = Table(explain_rows(EXPLAIN_ROWS))
    scorer = ColumnsModel(model)
    runner = solvers._runner("lstsq", 1e-6, dev)
    out = {}
    for name, cls, module, S, D in (
            ("shap", TabularSHAP, es, eb.default_num_samples(FEATURES),
             FEATURES - 1),
            ("lime", TabularLIME, el, 1000, FEATURES)):
        t0 = time.perf_counter()
        runner.warmup(np.zeros((1, S, D), np.float32),
                      np.zeros((1, S, 1), np.float32),
                      np.zeros((1, S), np.float32))
        capture_s = time.perf_counter() - t0
        before = runner.stats()
        solve_s, score_s = [], []
        with timed_calls(module, "solve_batched", dev, solve_s), \
                timed_calls(ColumnsModel, "transform", dev, score_s):
            _sync(dev)
            t0 = time.perf_counter()
            got = cls(model=scorer, inputCols=FEATURE_NAMES,
                      targetClasses=[1], device=dev).transform(rows)
            _sync(dev)
            wall = time.perf_counter() - t0
        after = runner.stats()
        captures = after["total_compiles"] - before["total_compiles"]
        hits = after["total_hits"] - before["total_hits"]
        out[name] = dict(
            explanation=_stacked(got["explanation"]),
            r2=np.asarray(got["r2"], np.float64), wall_s=wall,
            rows_per_s=EXPLAIN_ROWS / wall, samples=S,
            scored_rows=EXPLAIN_ROWS * S, capture_s=capture_s,
            solve_s=sum(solve_s), score_s=sum(score_s),
            host_s=wall - sum(solve_s) - sum(score_s),
            steady_captures=captures, steady_hits=hits,
            replay_ms=replay_ms(runner, dev))
        log(f"  (a) {name}: {EXPLAIN_ROWS} rows x {S} samples in "
            f"{wall:.3f}s = {EXPLAIN_ROWS / wall:.1f} rows explained/s "
            f"(scoring {sum(score_s):.3f}s, solves {sum(solve_s):.3f}s, "
            f"host sampling and assembly {out[name]['host_s']:.3f}s); "
            f"buckets captured ahead in {capture_s:.3f}s, then {captures} "
            f"captures and {hits} replays; replay ms by bucket "
            f"{json.dumps(out[name]['replay_ms'])}")
    fx = model.transform(Table({"features": np.stack(
        [rows[c] for c in FEATURE_NAMES], 1)}))["probability"][:, 1]
    vals = out["shap"]["explanation"][:, 0, :]
    out["additivity_gap"] = float(np.abs(vals.sum(1) - fx).max())
    out["solver_stats"] = solvers.solver_stats()
    log(f"  (a) SHAP local accuracy: max |base + sum(phi) - f(x)| "
        f"{out['additivity_gap']:.3g} (bound {ADDITIVITY_TOL}); "
        f"solver_stats {json.dumps(out['solver_stats'])}")
    return out


def tabular_check(card: dict, cpu, fails: list) -> dict:
    got = _npz(cpu, "tabular.npz")
    gaps = {}
    for name in ("shap", "lime"):
        gaps[name] = float(np.abs(card[name]["explanation"]
                                  - got[name]).max())
        if gaps[name] > EXPLAIN_TOL:
            fails.append(f"(a) {name}: card against CPU {gaps[name]:.3g} > "
                         f"{EXPLAIN_TOL}")
        if card[name]["steady_captures"]:
            fails.append(f"(a) {name}: {card[name]['steady_captures']} "
                         "captures after the warm-up")
    if card["additivity_gap"] > ADDITIVITY_TOL:
        fails.append(f"(a) SHAP local accuracy {card['additivity_gap']:.3g}"
                     f" > {ADDITIVITY_TOL}")
    log(f"  (a) card against CPU: phi {gaps['shap']:.3g}, LIME "
        f"{gaps['lime']:.3g} (bound {EXPLAIN_TOL}); the CPU port took "
        f"{float(got['shap_s']):.2f}s and {float(got['lime_s']):.2f}s")
    return gaps


def image_part(dev: str, cpu) -> dict:
    """(b) on the card, SLIC, masking, scoring and solves timed apart."""
    from synapseml_tpu_torch.explainers import lime as el
    from synapseml_tpu_torch.image import Superpixel

    state = torch.load(_explain_result(cpu, "resnet.pt"))
    model = vision_model(state, dev)
    images = explain_images()
    scores, slic_s, mask_s, solve_s, score_s = [], [], [], [], []
    with timed_calls(el, "slic_segments", dev, slic_s), \
            timed_calls(Superpixel, "masked_image", dev, mask_s), \
            timed_calls(el, "solve_batched", dev, solve_s), \
            timed_calls(type(model), "_transform", dev, score_s):
        _sync(dev)
        t0 = time.perf_counter()
        got = image_lime(model, images, dev, scores)
        _sync(dev)
        wall = time.perf_counter() - t0
    segs = [int(np.asarray(s).max()) + 1 for s in got["superpixels"]]
    out = dict(coefs=_stacked(got["explanation"]), scores=scores[0],
               wall_s=wall, images_per_s=len(images) / wall,
               slic_s=sum(slic_s), mask_s=sum(mask_s),
               score_s=sum(score_s), solve_s=sum(solve_s), segments=segs)
    log(f"  (b) ImageLIME: {len(images)} images x {IMAGE_LIME_SAMPLES} masks "
        f"({segs} superpixels) in {wall:.3f}s = {len(images) / wall:.2f} "
        f"images/s: SLIC {out['slic_s']:.3f}s, masking {out['mask_s']:.3f}s"
        f" ({len(mask_s)} masked images), ResNet-50 scoring "
        f"{out['score_s']:.3f}s ({len(images) * IMAGE_LIME_SAMPLES / max(out['score_s'], 1e-9):.0f} images/s), "
        f"solves {out['solve_s']:.3f}s")
    return out


def image_check(card: dict, cpu, fails: list) -> dict:
    got = _npz(cpu, "image.npz")
    gaps = dict(scores=float(np.abs(card["scores"] - got["scores"]).max()),
                coefs=float(np.abs(card["coefs"][0] - got["coefs"]).max()))
    for name, tol in (("scores", IMAGE_SCORE_TOL), ("coefs", IMAGE_LIME_TOL)):
        if gaps[name] > tol:
            fails.append(f"(b) image 0's {name}: card against CPU "
                         f"{gaps[name]:.3g} > {tol}")
    log(f"  (b) image 0 card against CPU: scores {gaps['scores']:.3g} "
        f"(bound {IMAGE_SCORE_TOL}), coefficients {gaps['coefs']:.3g} "
        f"(bound {IMAGE_LIME_TOL}, largest |coef| "
        f"{float(np.abs(got['coefs']).max()):.3g}); the CPU port took "
        f"{float(got['seconds']):.2f}s")
    return gaps


def dml_part(dev: str, fails: list) -> dict:
    """(c) on the card: the whole table, then the prefix."""
    from synapseml_tpu_torch.core.table import Table

    cols = dml_table(DML_ROWS)
    _sync(dev)
    t0 = time.perf_counter()
    ate = dml_ate(Table(cols), dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prefix = dml_ate(Table(dml_prefix(cols)), dev)
    prefix_s = time.perf_counter() - t0
    if abs(ate - DML_ATE) > DML_ATE_TOL:
        fails.append(f"(c) ATE {ate:.6f} against the planted {DML_ATE} "
                     f"(bound {DML_ATE_TOL})")
    log(f"  (c) DoubleML on {DML_ROWS} rows: ATE {ate:.6f} (planted "
        f"{DML_ATE}), fit {fit_s:.3f}s = {DML_ROWS / fit_s:.0f} rows/s "
        f"(four nuisance fits and their predictions); on {DML_PREFIX} "
        f"rows {prefix:.6f} in {prefix_s:.3f}s")
    return dict(ate=ate, fit_s=fit_s, prefix_ate=prefix, prefix_s=prefix_s)


def dml_check(card: dict, cpu, fails: list) -> float:
    got = _npz(cpu, "dml.npz")
    gap = abs(card["prefix_ate"] - float(got["ate"]))
    if gap > DML_CARD_TOL:
        fails.append(f"(c) prefix ATE card {card['prefix_ate']:.6f} against"
                     f" CPU {float(got['ate']):.6f} (bound {DML_CARD_TOL})")
    log(f"  (c) prefix ATE card against CPU: {gap:.3g} (bound "
        f"{DML_CARD_TOL}); the CPU port took {float(got['seconds']):.2f}s")
    return gap


def panel_part(dev: str, fails: list) -> dict:
    """(d): each panel on the card and on the CPU port."""
    from synapseml_tpu_torch.causal import SyntheticDiffInDiffEstimator
    from synapseml_tpu_torch.causal import did
    from synapseml_tpu_torch.core.table import Table

    out = {}
    for name, units, periods, treated, pre in PANELS:
        table = Table(panel_table(units, periods, treated, pre))
        res = {}
        for d in (dev, "cpu"):
            solve_s = []
            with timed_calls(did, "constrained_least_squares", d, solve_s):
                t0 = time.perf_counter()
                s = SyntheticDiffInDiffEstimator(device=d).fit(
                    table).getSummary()
                res[d] = (s, time.perf_counter() - t0, solve_s)
        (s, fit_s, solve_s), (w, wfit_s, wsolve_s) = res[dev], res["cpu"]
        gap = max(float(np.abs(s.unitWeights - w.unitWeights).max()),
                  float(np.abs(s.timeWeights - w.timeWeights).max()))
        if gap > SDID_TOL:
            fails.append(f"(d) {name}: weights card against CPU {gap:.3g} "
                         f"> {SDID_TOL}")
        out[name] = dict(effect=s.treatmentEffect,
                         cpu_effect=w.treatmentEffect, weight_gap=gap,
                         solve_ms=[round(x * 1e3, 3) for x in solve_s],
                         cpu_solve_ms=[round(x * 1e3, 3) for x in wsolve_s],
                         fit_s=fit_s, cpu_fit_s=wfit_s)
        log(f"  (d) {name} ({units} units x {periods} periods, {treated} "
            f"treated, {pre} pre-periods): effect {s.treatmentEffect:.4f} "
            f"(planted {PANEL_EFFECT}; CPU {w.treatmentEffect:.4f}), "
            f"weights card against CPU {gap:.3g} (bound {SDID_TOL}); "
            f"unit and time solves {out[name]['solve_ms']} ms on the card, "
            f"{out[name]['cpu_solve_ms']} ms on the CPU; fit {fit_s:.3f}s "
            f"/ {wfit_s:.3f}s")
    return out


def _event_ms(fn, dev: str, reps: int = 3) -> float:
    """Mean card ms of ``fn()`` (CUDA events, after one warm-up call)."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def image_ops_part(dev: str, fails: list) -> dict:
    """(e)'s image ops: each on the card (timed) and on the CPU port."""
    from synapseml_tpu_torch.ops import image as I

    x = np.random.default_rng(24).uniform(size=(
        IMAGE_OPS_N, IMAGE_OPS_SIDE, IMAGE_OPS_SIDE, 3)).astype(np.float32)
    xc, xd = torch.from_numpy(x), torch.from_numpy(x).to(dev)
    ops = [("resize bilinear 112", lambda t: I.resize(t, 112, 112)),
           ("resize lanczos3 160", lambda t: I.resize(t, 160, 160,
                                                      "lanczos3")),
           ("resize bicubic 256", lambda t: I.resize(t, 256, 256, "bicubic")),
           ("resize nearest 256", lambda t: I.resize(t, 256, 256, "nearest")),
           ("crop 192", lambda t: I.crop(t, 16, 16, 192, 192)),
           ("center_crop 200", lambda t: I.center_crop(t, 200, 200)),
           ("flip both", lambda t: I.flip(t, -1)),
           ("blur 5 1.0", lambda t: I.blur(t, 5, 1.0)),
           ("threshold 0.5", lambda t: I.threshold(t, 0.5)),
           ("color_to_gray", I.color_to_gray)]
    out = {}
    for name, op in ops:
        t0 = time.perf_counter()
        want = op(xc).numpy()
        cpu_s = time.perf_counter() - t0
        got = op(xd).cpu().numpy()
        gap = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        ms = _event_ms(lambda: op(xd), dev) if _on_card(dev) else \
            cpu_s * 1e3
        out[name] = dict(ms=round(ms, 4), images_per_s=IMAGE_OPS_N / ms * 1e3,
                         cpu_ms=round(cpu_s * 1e3, 3), gap=gap)
        if gap > IMAGE_OPS_TOL:
            fails.append(f"(e) {name}: card against CPU {gap:.3g} > "
                         f"{IMAGE_OPS_TOL}")
    log("  (e) image ops on " f"{IMAGE_OPS_N}x{IMAGE_OPS_SIDE}x"
        f"{IMAGE_OPS_SIDE}x3 (card ms, images/s, CPU ms, gap): " + "; ".join(
            f"{k} {v['ms']:.3f} ms {v['images_per_s']:.0f}/s cpu "
            f"{v['cpu_ms']:.1f} gap {v['gap']:.2g}" for k, v in out.items()))
    return out


def hist_inputs(rows: int, seed: int = 24) -> tuple:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, HIST_BINS, size=(rows, FEATURES), dtype=np.uint8),
            rng.integers(-1, HIST_LEAVES, size=rows).astype(np.int32),
            rng.normal(size=rows).astype(np.float32),
            rng.uniform(size=rows).astype(np.float32))


def hist_gap(got: np.ndarray, want: np.ndarray, args: tuple) -> tuple:
    """(counts equal, worst sum gap in units of its bin's sum of
    magnitudes)."""
    binned, node, g, h = args
    keep = node >= 0
    flat = ((node[keep, None].astype(np.int64) * FEATURES
             + np.arange(FEATURES)) * HIST_BINS + binned[keep])
    mag = np.zeros((HIST_LEAVES * FEATURES * HIST_BINS, 2))
    for k, v in enumerate((g, h)):
        mag[:, k] = np.bincount(flat.ravel(), weights=np.repeat(
            np.abs(v[keep].astype(np.float64)), FEATURES),
            minlength=mag.shape[0])
    gap = np.abs(got[..., :2].reshape(-1, 2).astype(np.float64)
                 - want[..., :2].reshape(-1, 2))
    rel = float((gap / np.maximum(mag, 1e-30)).max())
    return bool(np.array_equal(got[..., 2], want[..., 2])), rel


def _hist_rank(rank: int, workdir: str, dev: str, rows: int) -> None:
    """One rank of (e)'s sharded histogram."""
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.ops.histogram import sharded_histogram_fn
    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed("gloo", os.path.join(workdir, "store"), rank,
                     MESH_RANKS, timeout_s=300)
    mesh = make_mesh({"data": MESH_RANKS}, device=dev)
    fn = sharded_histogram_fn(mesh, HIST_LEAVES, HIST_BINS)
    args = hist_inputs(rows)
    fn(*args)
    _sync(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(dev)
    np.save(os.path.join(workdir, f"hist_{rank}.npy"), out.cpu().numpy())
    with open(os.path.join(workdir, f"hist_{rank}.json"), "w") as f:
        json.dump({"s": time.perf_counter() - t0}, f)
    torch.distributed.destroy_process_group()


def cpu_hist() -> tuple:
    """(e)'s histogram on the CPU port: (histogram, seconds)."""
    from synapseml_tpu_torch.ops.histogram import leaf_histograms

    args = hist_inputs(HIST_ROWS)
    t0 = time.perf_counter()
    want = leaf_histograms(*(torch.from_numpy(a) for a in args),
                           HIST_LEAVES, HIST_BINS).numpy()
    return want, time.perf_counter() - t0


def start_hist_ranks(dev: str) -> tuple:
    """(e)'s sharded histogram, its MESH_RANKS ranks spawned at the phase's
    start beside the rest of its work: (context, directory, start s)."""
    import torch.multiprocessing as tmp

    workdir = tempfile.mkdtemp(prefix="hist_ranks_")
    ctx = tmp.start_processes(_hist_rank, args=(workdir, dev, HIST_ROWS),
                              nprocs=MESH_RANKS, join=False,
                              start_method="spawn")
    return ctx, workdir, time.perf_counter()


def stop_hist_ranks(ranks: tuple) -> None:
    ctx, workdir, _ = ranks
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
    shutil.rmtree(workdir, ignore_errors=True)


def hist_part(dev: str, fails: list, ranks: tuple, cpu_ref) -> dict:
    """(e)'s histograms: leaf_histograms on the card (timed) against the CPU
    port's (``cpu_ref``, a future of ``cpu_hist``), then the ranks of
    ``start_hist_ranks`` joined and their sharded histogram checked."""
    from synapseml_tpu_torch.ops.histogram import leaf_histograms

    args = hist_inputs(HIST_ROWS)
    want, cpu_s = cpu_ref.result()
    dargs = [torch.from_numpy(a).to(dev) for a in args]

    def call():
        return leaf_histograms(*dargs, HIST_LEAVES, HIST_BINS)

    got = call().cpu().numpy()
    ms = _event_ms(call, dev) if _on_card(dev) else cpu_s * 1e3
    counts_ok, rel = hist_gap(got, want, args)
    kept = int((args[1] >= 0).sum())
    # bytes: the inputs read once and the histogram written once
    nbytes = sum(a.nbytes for a in args) + want.nbytes
    if not counts_ok or rel > HIST_REL:
        fails.append(f"(e) leaf_histograms card against CPU: counts equal "
                     f"{counts_ok}, sums {rel:.3g} > {HIST_REL}")
    ctx, workdir, t0 = ranks
    deadline = time.monotonic() + EXPLAIN_WAIT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            raise AssertionError("(e) the sharded histogram's ranks did not "
                                 "end")
    spawn_s = time.perf_counter() - t0
    parts = [np.load(os.path.join(workdir, f"hist_{r}.npy"))
             for r in range(MESH_RANKS)]
    rank_s = []
    for r in range(MESH_RANKS):
        with open(os.path.join(workdir, f"hist_{r}.json")) as f:
            rank_s.append(json.load(f)["s"])
    same = all(np.array_equal(parts[0], p) for p in parts[1:])
    s_ok, s_rel = hist_gap(parts[0], want, args)
    if not same or not s_ok or s_rel > HIST_REL:
        fails.append(f"(e) sharded_histogram_fn: equal on the ranks {same}, "
                     f"counts {s_ok}, sums {s_rel:.3g} (bound {HIST_REL})")
    out = dict(ms=ms, cpu_ms=cpu_s * 1e3, rows_per_s=HIST_ROWS / ms * 1e3,
               bytes_bound_ms=nbytes / 3.35e12 * 1e3, rel=rel,
               sharded_rel=s_rel, sharded_rank_s=rank_s, spawn_s=spawn_s)
    log(f"  (e) leaf_histograms {HIST_ROWS} x {FEATURES} x {HIST_BINS} bins "
        f"x {HIST_LEAVES} leaves ({kept} rows in a leaf): card {ms:.3f} ms "
        f"({HIST_ROWS / ms * 1e3:.0f} rows/s; its bytes over 3.35 TB/s "
        f"{out['bytes_bound_ms']:.4f} ms), CPU {cpu_s * 1e3:.1f} ms; counts "
        f"equal {counts_ok}, sums {rel:.3g} of each bin's sum of magnitudes;"
        f" sharded over {MESH_RANKS} ranks: equal on the ranks {same}, sums "
        f"{s_rel:.3g}, a call {[round(s * 1e3, 3) for s in rank_s]} ms per "
        f"rank, spawned at the phase's start and joined after "
        f"{spawn_s:.1f}s")
    return out


def explain_path(dev: str, model=None, rows: int = 2_000_000) -> dict:
    """Phase 24: (a)-(e) above; every failure is collected and raised at
    the end. ``model`` is phase 3's classifier (fitted here when absent,
    as phase 3 fits it on ``rows`` rows)."""
    if model is None:
        from synapseml_tpu_torch.models import LightGBMClassifier

        t0 = time.perf_counter()
        X, y = higgs_like(rows)
        model = LightGBMClassifier(numIterations=10, numLeaves=31,
                                   maxBin=255, device=dev).fit(table_of(X, y))
        del X, y
        log(f"  phase 3's classifier fitted on {rows} rows in "
            f"{time.perf_counter() - t0:.2f}s")
    cpu = start_explain_cpu(model)
    ranks = start_hist_ranks(dev)
    pool = ThreadPoolExecutor(1)
    cpu_ref = pool.submit(cpu_hist)
    fails, out = [], {}
    t0 = [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        log(f"  ({name}) took {now - t0[0]:.1f}s")
        t0[0] = now

    try:
        for name, run in (
                ("a", lambda: tabular_part(model, dev)),
                ("b", lambda: image_part(dev, cpu)),
                ("c", lambda: dml_part(dev, fails)),
                ("d", lambda: panel_part(dev, fails)),
                ("e", lambda: {"images": image_ops_part(dev, fails),
                               "hist": hist_part(dev, fails, ranks,
                                                 cpu_ref)}),
                ("card against the CPU process", lambda: {
                    "a": tabular_check(out["a"], cpu, fails),
                    "b": image_check(out["b"], cpu, fails),
                    "c": dml_check(out["c"], cpu, fails)})):
            try:
                out[name] = run()
            except Exception as e:          # collected, raised at the end
                import traceback

                traceback.print_exc()
                fails.append(f"({name}) raised {type(e).__name__}: {e}")
            part(name)
            if _on_card(dev):
                torch.cuda.empty_cache()
    finally:
        cpu[0].join(timeout=EXPLAIN_WAIT_S)
        if cpu[0].is_alive():
            cpu[0].terminate()
            fails.append("phase 24: the CPU process did not end")
        stop_hist_ranks(ranks)
        pool.shutdown(wait=True)
    out.pop("card against the CPU process", None)
    if fails:
        raise AssertionError("phase 24: " + "; ".join(fails))
    return out


# ---------------------------------------------------------------------------
# Phase 25: featurization, TrainClassifier / TrainRegressor, the pipeline
# stages and AutoML's elastic halving search
# ---------------------------------------------------------------------------
# (a) TrainClassifier on UCI Adult at its real shape (Kohavi 1996; the
# upstream classification notebook's data set), made from a seed: 48,842
# rows, the 32,561-row train split fitted and the 16,281-row test split
# scored; six integer columns and eight string columns at Adult's
# cardinalities, "?" a level of workclass, occupation and native-country;
# the label "<=50K" / ">50K", ADULT_POSITIVE of the rows positive with a
# planted signal. The CPU port fits the same in a spawned process: the
# featurized matrix bitwise its, the probabilities within ADULT_PROB_TOL and
# the AUC within ADULT_AUC_TOL (atomics may flip a near-tie split); the
# reloaded model's scores within ADULT_RELOAD_TOL
ADULT_ROWS, ADULT_TRAIN, ADULT_POSITIVE, ADULT_ITERS = \
    48_842, 32_561, 0.24, 100
ADULT_NUMERIC = ("age", "fnlwgt", "education-num", "capital-gain",
                 "capital-loss", "hours-per-week")
ADULT_STRINGS = {"workclass": 9, "education": 16, "marital-status": 7,
                 "occupation": 15, "relationship": 6, "race": 5, "sex": 2,
                 "native-country": 42}
ADULT_MISSING = ("workclass", "occupation", "native-country")
ADULT_PROB_TOL, ADULT_AUC_TOL, ADULT_RELOAD_TOL = 1e-3, 1e-3, 1e-5
# (b) TrainClassifier on phase 3's table (its X and y, as 28 float32
# columns): Featurize's matrix bitwise X, and the inner fit's AUC on
# HELDOUT_ROWS HIGGS-shaped rows of another seed within TRAIN_AUC_TOL of
# phase 3's classifier's
HELDOUT_ROWS, TRAIN_AUC_TOL = 500_000, 1e-3
# (c) TuneHyperparameters on (a)'s featurized train split: random search
# over TUNE_CANDIDATES draws (numLeaves in TUNE_LEAVES, learningRate
# log-uniform in TUNE_LR), TUNE_ITERS iterations, TUNE_FOLDS folds, eta
# TUNE_ETA, TUNE_THREADS threads, a checkpointDir; FindBestModel over the
# finalists; the same search killed at rung TUNE_KILL_RUNG (chaos_candidate's
# hook) and resumed. TUNE_CROSS candidates' rung-0 fold scores within
# TUNE_CROSS_TOL of the CPU port's. Every task runs under an explicit budget
# of TUNE_BUDGET_S (the journal's matched rows would arm a reaper at 4x a
# fold's seconds). One thread and 10 iterations, not 4 and 50: the port's
# leaf-wise fit is host-bound at this size, and fits in threads on one card
# are slower than one after another (every small torch op the grower issues
# releases and retakes the GIL, and the threads queue on it);
# tools/automl_fit_costs.py measures both
TUNE_CANDIDATES, TUNE_FOLDS, TUNE_ETA, TUNE_THREADS = 8, 3, 2, 1
TUNE_ITERS, TUNE_LEAVES, TUNE_LR, TUNE_SEED = 10, (15, 31, 63), (0.05, 0.3), 0
TUNE_KILL_RUNG, TUNE_CROSS, TUNE_CROSS_TOL, TUNE_BUDGET_S = 1, 2, 1e-3, 600.0
# (d) the gang: GANG_WORKERS spool workers of the port on the card, each
# fitting (c)'s base model on the train split; one rank killed mid-task;
# the re-spooled task's AUC within GANG_AUC_TOL of the same fit alone
GANG_WORKERS, GANG_AUC_TOL, GANG_WAIT_S = 2, 1e-3, 300.0
# the CPU port's (a) and (c) in a spawned process beside the card's work
AUTOML_CPU_THREADS = 4
AUTOML_WAIT_S = 600.0
_AUTOML_SETTINGS = ("ADULT_ROWS", "ADULT_TRAIN", "ADULT_POSITIVE",
                    "ADULT_ITERS", "TUNE_CANDIDATES", "TUNE_FOLDS",
                    "TUNE_ITERS", "TUNE_LEAVES", "TUNE_LR", "TUNE_SEED",
                    "TUNE_CROSS", "AUTOML_CPU_THREADS")


def adult_like(rows: int, seed: int = 0) -> dict:
    """UCI-Adult-shaped columns: the six integer columns in Adult's ranges,
    the eight string columns at Adult's cardinalities (skewed levels; "?"
    one of them where Adult has missing values) and the string label with
    a planted signal, about ADULT_POSITIVE positive."""
    rng = np.random.default_rng(seed)
    cols = {
        "age": rng.integers(17, 91, rows),
        "fnlwgt": rng.integers(12_285, 1_484_706, rows),
        "education-num": rng.integers(1, 17, rows),
        "capital-gain": np.where(rng.random(rows) < 0.08,
                                 rng.integers(1, 99_999, rows), 0),
        "capital-loss": np.where(rng.random(rows) < 0.05,
                                 rng.integers(1, 4_356, rows), 0),
        "hours-per-week": rng.integers(1, 100, rows)}
    for name, k in ADULT_STRINGS.items():
        levels = [f"{name}-{i}" for i in range(k)]
        if name in ADULT_MISSING:
            levels[-1] = "?"
        p = 1.0 / np.arange(1, k + 1)
        cols[name] = np.asarray(levels, object)[
            rng.choice(k, size=rows, p=p / p.sum())]
    margin = (0.04 * (cols["age"] - 38) + 0.3 * (cols["education-num"] - 10)
              + 1.5 * (cols["capital-gain"] > 0)
              + 1.2 * (cols["marital-status"] == "marital-status-0")
              + 0.5 * (cols["sex"] == "sex-0")
              + 0.02 * (cols["hours-per-week"] - 40)
              + rng.normal(size=rows))
    cut = np.quantile(margin, 1.0 - ADULT_POSITIVE)
    cols["income"] = np.where(margin > cut, ">50K", "<=50K").astype(object)
    return cols


def adult_split(cols: dict) -> tuple:
    """(train, test) ``Table`` s: the first ADULT_TRAIN rows and the rest."""
    from synapseml_tpu_torch.core.table import Table

    return (Table({k: v[:ADULT_TRAIN] for k, v in cols.items()}),
            Table({k: v[ADULT_TRAIN:] for k, v in cols.items()}))


def _array_digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def tune_space():
    from synapseml_tpu_torch.automl import (DiscreteHyperParam,
                                            HyperparamBuilder,
                                            RangeHyperParam)

    return (HyperparamBuilder()
            .addHyperparam("numLeaves", DiscreteHyperParam(list(TUNE_LEAVES)))
            .addHyperparam("learningRate",
                           RangeHyperParam(*TUNE_LR, log=True))
            .build())


def tune_candidates() -> list:
    from synapseml_tpu_torch.automl import RandomSpace

    return list(RandomSpace(tune_space(), TUNE_CANDIDATES, TUNE_SEED))


def tune_folds(n: int) -> list:
    """``TuneHyperparameters``' folds of ``n`` rows at TUNE_SEED."""
    perm = np.random.default_rng(TUNE_SEED).permutation(n)
    return np.array_split(perm, max(TUNE_FOLDS, 2))


def featurized(model, table):
    """(a)'s featurized ``table`` for the search: the fitted featurizer's
    matrix and the indexed label, as a ``features`` / ``label`` Table."""
    from synapseml_tpu_torch.core.table import Table

    work = model.indexer.transform(model.featurizer.transform(table))
    return Table({"features": work["features"],
                  "label": work["__label_indexed"].astype(np.float64)})


def fold_score(table, params: dict, fold: int, dev: str) -> float:
    """One fold of the search (fit on the other folds, AUC on ``fold``), as
    ``TuneHyperparameters`` scores it."""
    from synapseml_tpu_torch.automl.tune import _evaluate
    from synapseml_tpu_torch.models import LightGBMClassifier

    folds = tune_folds(table.num_rows)
    train_idx = np.concatenate([f for i, f in enumerate(folds) if i != fold])
    est = LightGBMClassifier(numIterations=TUNE_ITERS, device=dev).copy(
        extra=params)
    return _evaluate(est.fit(table.take(train_idx)),
                     table.take(folds[fold]), "AUC", "label")


def _automl_cpu(out_dir: str, settings: dict) -> None:
    """The CPU port's (a) and (c)'s rung-0 folds (a spawned process beside
    the card's work), each result written whole and then renamed."""
    sys.path.insert(0, str(REPO))
    globals().update(settings)
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.train import TrainClassifier
    from synapseml_tpu_torch.train.metrics import auc_score

    torch.set_num_threads(AUTOML_CPU_THREADS)

    def put(name: str, **arrays) -> None:
        tmp = os.path.join(out_dir, f".{name}")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(out_dir, name))

    train, test = adult_split(adult_like(ADULT_ROWS))
    t0 = time.perf_counter()
    model = TrainClassifier(
        model=LightGBMClassifier(numIterations=ADULT_ITERS, device="cpu"),
        labelCol="income").fit(train)
    scored = model.transform(test)
    y = np.asarray(scored["income"] == ">50K", np.float64)
    put("adult.npz", probability=scored["probability"],
        features=np.str_(_array_digest(scored["features"])),
        auc=np.float64(auc_score(y, scored["probability"][:, 1])),
        seconds=np.float64(time.perf_counter() - t0))
    table = featurized(model, train)
    t0 = time.perf_counter()
    scores = [fold_score(table, p, 0, "cpu")
              for p in tune_candidates()[:TUNE_CROSS]]
    put("tune.npz", scores=np.asarray(scores, np.float64),
        seconds=np.float64(time.perf_counter() - t0))


def start_automl_cpu():
    """(a) and (c)'s folds on the CPU port in a spawned process: (process,
    output dir)."""
    out = tempfile.mkdtemp(prefix="automl_cpu_")
    ctx = torch.multiprocessing.get_context("spawn")
    p = ctx.Process(target=_automl_cpu, args=(
        out, {k: globals()[k] for k in _AUTOML_SETTINGS}))
    p.start()
    return p, out


def _automl_npz(cpu, name: str) -> dict:
    """The CPU process's ``name``, once written (waiting up to
    AUTOML_WAIT_S)."""
    proc, out = cpu
    path = os.path.join(out, name)
    deadline = time.monotonic() + AUTOML_WAIT_S
    while not os.path.exists(path):
        if not proc.is_alive() and not os.path.exists(path):
            raise AssertionError(f"phase 25: the CPU process ended (exit "
                                 f"code {proc.exitcode}) without {name}")
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 25: {name} never came")
        time.sleep(0.05)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def gang_fit_task(path: str, device: str, iters: int) -> dict:
    """A gang worker's task (importable as ``chip_smoke:gang_fit_task``):
    (c)'s base model (``iters`` iterations) fitted on the arrays at
    ``path`` on ``device``, its AUC on their held-out rows, and the
    launches it made."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.train.metrics import auc_score

    if not _on_card(device):
        torch.set_num_threads(1)    # two workers share the host's cores
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    hk.reset_launch_counts()
    model = LightGBMClassifier(numIterations=iters, device=device).fit(
        Table({"features": d["X"], "label": d["y"]}))
    prob = model.transform(Table({"features": d["Xv"]}))["probability"]
    return {"auc": float(auc_score(d["yv"], prob[:, 1])),
            "launches": dict(hk.LAUNCHES), "pid": os.getpid()}


def adult_part(dev: str, cpu, fails: list) -> dict:
    """(a): TrainClassifier on the Adult-shaped table, its statistics, a
    save and load, the native hashes; held to the CPU port's."""
    from synapseml_tpu_torch import native
    from synapseml_tpu_torch.core.pipeline import PipelineStage
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.train import (ComputeModelStatistics,
                                           ComputePerInstanceStatistics,
                                           TrainClassifier)
    from synapseml_tpu_torch.vw.hashing import murmur3_32_batch

    t0 = time.perf_counter()
    cols = adult_like(ADULT_ROWS)
    train, test = adult_split(cols)
    log(f"  (a) Adult-shaped table: {ADULT_ROWS} rows ({ADULT_TRAIN} train), "
        f"{len(ADULT_NUMERIC)} integer + {len(ADULT_STRINGS)} string columns, "
        f"{np.mean(cols['income'] == '>50K'):.4f} positive, made in "
        f"{time.perf_counter() - t0:.2f}s")
    est = TrainClassifier(
        model=LightGBMClassifier(numIterations=ADULT_ITERS, device=dev),
        labelCol="income")
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    model = est.fit(train)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    t0 = time.perf_counter()
    scored = model.transform(test)
    score_s = time.perf_counter() - t0
    work = model.indexer.transform(scored)
    stats = ComputeModelStatistics(
        labelCol="__label_indexed", evaluationMetric="classification",
        scoresCol="probability").transform(work)
    per_row = ComputePerInstanceStatistics(
        labelCol="__label_indexed").transform(work)
    auc = float(stats["AUC"][0])
    prob = scored["probability"]
    levels = model.indexer.levels
    log(f"  (a) TrainClassifier(LightGBMClassifier(numIterations="
        f"{ADULT_ITERS})): {model.featurizer.feature_dim} features, fit "
        f"{fit_s:.3f}s ({ADULT_TRAIN * ADULT_ITERS / fit_s:.0f} row "
        f"iterations/s, featurize and index included), scored "
        f"{ADULT_ROWS - ADULT_TRAIN} rows in {score_s:.3f}s; test AUC "
        f"{auc:.6f}, accuracy {stats['accuracy'][0]:.4f}, mean log loss "
        f"{per_row['log_loss'].mean():.4f}; launches {json.dumps(launches)}")
    if _on_card(dev):
        _check_launches(launches, MAIN_KERNELS)
    if prob.shape != (ADULT_ROWS - ADULT_TRAIN, 2) \
            or not np.isfinite(prob).all() or auc < 0.75:
        fails.append(f"(a) scores bad: shape {prob.shape}, AUC {auc}")
    want = np.asarray(levels, object)[np.argmax(prob, 1)]
    if levels != ["<=50K", ">50K"] \
            or list(scored["scored_labels"]) != list(want):
        fails.append(f"(a) scored_labels are not the original strings "
                     f"(levels {levels})")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model.save(os.path.join(tmp, "trained"))
        loaded = PipelineStage.load(os.path.join(tmp, "trained"), device=dev)
        reload_gap = float(np.abs(
            loaded.transform(test)["probability"] - prob).max())
        log(f"  (a) save and load of the TrainedClassifierModel in "
            f"{time.perf_counter() - t0:.2f}s: scores max |diff| "
            f"{reload_gap:.3g} (tolerance {ADULT_RELOAD_TOL})")
    if not reload_gap <= ADULT_RELOAD_TOL:
        fails.append(f"(a) reloaded scores {reload_gap} from the fitted")
    strings = [str(v) for c in ADULT_STRINGS for v in cols[c]] \
        + [str(v) for v in cols["income"]]
    t0 = time.perf_counter()
    available = native.available()          # builds it at first use
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native.murmur3_32_batch(strings, 0, vw_numeric_names=False)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_h = murmur3_32_batch([s.encode("utf-8") for s in strings], 0)
    numpy_s = time.perf_counter() - t0
    same = got is not None and np.array_equal(got, want_h)
    log(f"  (a) native library available {available} (built or loaded in "
        f"{build_s:.2f}s, {native.library_path()}): murmur3 of the table's "
        f"{len(strings)} "
        f"strings {native_s * 1e3:.1f} ms native, {numpy_s * 1e3:.1f} ms "
        f"numpy, equal {same}")
    if not (available and same):
        fails.append("(a) the native library is unavailable or its hashes "
                     "differ from the numpy path's")
    return dict(model=model, train=train, test=test, prob=prob, auc=auc,
                features=_array_digest(scored["features"]),
                plans=model.featurizer.plans, launches=launches,
                fit_s=fit_s)


def adult_check(card: dict, cpu, fails: list) -> None:
    ref = _automl_npz(cpu, "adult.npz")
    gap = float(np.abs(card["prob"] - ref["probability"]).max())
    auc_gap = abs(card["auc"] - float(ref["auc"]))
    same = card["features"] == str(ref["features"])
    log(f"  (a) card against CPU: featurized test matrix bitwise {same}, "
        f"probabilities max |diff| {gap:.3g} (tolerance {ADULT_PROB_TOL}), "
        f"AUC {card['auc']:.6f} against {float(ref['auc']):.6f} (tolerance "
        f"{ADULT_AUC_TOL}); the CPU port took {float(ref['seconds']):.2f}s")
    if not same:
        fails.append("(a) the featurized matrix differs from the CPU port's")
    if not (gap <= ADULT_PROB_TOL and auc_gap <= ADULT_AUC_TOL):
        fails.append(f"(a) card against CPU: probabilities {gap}, AUC "
                     f"{auc_gap}")


def higgs_train_part(X, y, reference, dev: str, fails: list) -> dict:
    """(b): TrainClassifier on phase 3's table as 28 float32 columns."""
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.train import TrainClassifier
    from synapseml_tpu_torch.train.metrics import auc_score

    names = [f"f{i}" for i in range(X.shape[1])]
    table = Table({**{n: X[:, i] for i, n in enumerate(names)}, "label": y})
    hk.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    model = TrainClassifier(model=LightGBMClassifier(
        numIterations=10, numLeaves=31, maxBin=255, device=dev)).fit(table)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    t0 = time.perf_counter()
    Xf = model.featurizer.transform(table)["features"]
    feat_s = time.perf_counter() - t0
    bitwise = Xf.dtype == X.dtype and Xf.shape == X.shape and \
        np.ascontiguousarray(Xf).tobytes() == np.ascontiguousarray(X).tobytes()
    del Xf, table
    Xh, yh = higgs_like(HELDOUT_ROWS, seed=1)
    got = model.transform(Table({n: Xh[:, i] for i, n in enumerate(names)}))
    auc = auc_score(yh, got["probability"][:, 1])
    want = auc_score(yh, reference.transform(table_of(Xh, yh))[
        "probability"][:, 1])
    log(f"  (b) TrainClassifier on {X.shape[0]} rows x {X.shape[1]} float32 "
        f"columns: fit {fit_s:.3f}s (featurize, index and fit), Featurize's "
        f"transform {feat_s:.3f}s, its matrix bitwise phase 3's X {bitwise}; "
        f"held-out AUC ({HELDOUT_ROWS} rows) {auc:.6f} against phase 3's "
        f"classifier {want:.6f} (tolerance {TRAIN_AUC_TOL}); launches "
        f"{json.dumps(launches)}")
    if _on_card(dev):
        _check_launches(launches, MAIN_KERNELS)
    if not bitwise:
        fails.append("(b) Featurize's matrix is not phase 3's X")
    if not abs(auc - want) <= TRAIN_AUC_TOL:
        fails.append(f"(b) held-out AUC {auc} against phase 3's {want}")
    return dict(fit_s=fit_s, featurize_s=feat_s, auc=auc)


@contextlib.contextmanager
def rung_clock(seconds: dict):
    """Wall seconds of each rung of the halving scheduler's brackets run
    inside, summed by rung index into ``seconds``."""
    from synapseml_tpu_torch.automl import scheduler as sch

    run_rung = sch.ElasticHalvingScheduler._run_rung

    def timed(self, rung, alive):
        t0 = time.perf_counter()
        try:
            return run_rung(self, rung, alive)
        finally:
            seconds[rung.index] = seconds.get(rung.index, 0.0) \
                + time.perf_counter() - t0

    sch.ElasticHalvingScheduler._run_rung = timed
    try:
        yield seconds
    finally:
        sch.ElasticHalvingScheduler._run_rung = run_rung


def _bracket(ckpt: str) -> dict:
    from synapseml_tpu_torch.core.checkpoint import CheckpointStore

    ck = CheckpointStore(os.path.join(ckpt, "bracket")).load_latest()
    return json.loads(ck.artifacts["bracket.json"])


def tune_part(adult: dict, dev: str, cpu, fails: list) -> dict:
    """(c): the halving search, FindBestModel over its finalists, and the
    same search killed at a rung and resumed."""
    from synapseml_tpu_torch.automl import FindBestModel, TuneHyperparameters
    from synapseml_tpu_torch.automl.scheduler import plan_rungs
    from synapseml_tpu_torch.core import perfmodel
    from synapseml_tpu_torch.core.checkpoint import PreemptionError
    from synapseml_tpu_torch.models import LightGBMClassifier
    from synapseml_tpu_torch.ops import hist_kernel as hk
    from synapseml_tpu_torch.testing import chaos_candidate

    table = featurized(adult["model"], adult["train"])
    test = featurized(adult["model"], adult["test"])
    candidates = tune_candidates()
    keys = [TuneHyperparameters._candidate_key(p) for p in candidates]
    work = tempfile.mkdtemp(prefix="automl_tune_")
    journal = perfmodel.JOURNAL_PATH
    perfmodel.JOURNAL_PATH = os.path.join(work, "perf_rows.jsonl")

    def tuner(ckpt: str):
        return TuneHyperparameters(
            model=LightGBMClassifier(numIterations=TUNE_ITERS, device=dev),
            paramSpace=tune_space(), searchMode="random",
            numRuns=TUNE_CANDIDATES, numFolds=TUNE_FOLDS, seed=TUNE_SEED,
            evaluationMetric="AUC", parallelism=TUNE_THREADS,
            halvingEta=TUNE_ETA, minResourceFolds=1, checkpointDir=ckpt,
            candidateBudgetSeconds=TUNE_BUDGET_S, perfJournal=True)

    class KillAtRung(chaos_candidate):
        """chaos_candidate whose every task of rung TUNE_KILL_RUNG kills
        the search (a ``PreemptionError`` out of the hook)."""

        def _hook(self, key, rung, attempt):
            if rung == TUNE_KILL_RUNG:
                self.injected.append(("kill", key, rung, attempt))
                raise PreemptionError(f"phase 25: search killed at rung "
                                      f"{rung}")
            return super()._hook(key, rung, attempt)

    try:
        rungs = plan_rungs(TUNE_CANDIDATES, TUNE_FOLDS, eta=TUNE_ETA)
        planned, prev = 0, 0
        for r in rungs:
            planned += r.survivors * (r.resource - prev)
            prev = r.resource
        rung_s: dict = {}
        hk.reset_launch_counts()
        peak0 = _peak_gib(dev, reset=True)
        d1 = os.path.join(work, "search")
        t0 = time.perf_counter()
        with rung_clock(rung_s):
            tuned = tuner(d1).fit(table)
        search_s = time.perf_counter() - t0
        peak = _peak_gib(dev)
        launches = dict(hk.LAUNCHES)
        state = _bracket(d1)
        fold_fits = sum(len(v) for v in state["fold_scores"].values())
        metrics = [r["metric"] for r in tuned.allResults]
        rows = perfmodel.training_rows("automl_rung")
        log(f"  (c) TuneHyperparameters: {TUNE_CANDIDATES} candidates x "
            f"{TUNE_FOLDS} folds, eta {TUNE_ETA}, {TUNE_THREADS} threads on "
            f"one card: rungs {[(r.resource, r.survivors) for r in rungs]}, "
            f"{search_s:.2f}s (the best's refit included); seconds by rung "
            f"{json.dumps({k: round(v, 3) for k, v in rung_s.items()})}; "
            f"{fold_fits} fold fits ({fold_fits / sum(rung_s.values()):.2f}"
            f"/s over the rungs), {fold_fits / (TUNE_CANDIDATES * TUNE_FOLDS):.3f}"
            f" of exhaustive's {TUNE_CANDIDATES * TUNE_FOLDS}; peak "
            f"memory_allocated {peak:.3f} GiB (before {peak0:.3f}); "
            f"{len(rows)} automl_rung rows journaled "
            f"({rows[0]['platform'] if rows else '-'}); launches "
            f"{json.dumps(launches)}")
        log(f"  (c) best {json.dumps(tuned.bestParams)} CV AUC "
            f"{tuned.bestMetric:.6f}; metrics "
            f"{[round(m, 6) for m in metrics]}")
        if _on_card(dev):
            _check_launches(launches, MAIN_KERNELS)
        if any(np.isnan(m) for m in metrics):
            fails.append(f"(c) a candidate scored NaN without chaos: "
                         f"{metrics}")
        if fold_fits != planned or fold_fits >= TUNE_CANDIDATES * TUNE_FOLDS:
            fails.append(f"(c) {fold_fits} fold fits against the ladder's "
                         f"{planned}")

        # FindBestModel over the finalists fitted on the split: the
        # search's refitted best and the others fitted here
        finalists = [candidates[keys.index(k)]
                     for k in state["promoted"][str(len(rungs) - 1)]]
        t0 = time.perf_counter()
        models = [tuned.bestModel if p == tuned.bestParams else
                  LightGBMClassifier(numIterations=TUNE_ITERS, device=dev)
                  .copy(extra=p).fit(table) for p in finalists]
        best = FindBestModel(models=models, evaluationMetric="AUC",
                             parallelism=TUNE_THREADS).fit(test)
        held = [m["metric"] for m in best.allModelMetrics]
        log(f"  (c) FindBestModel over the {len(models)} finalists "
            f"{json.dumps(finalists)} on the test split: AUC {held}, best "
            f"#{models.index(best.bestModel)} ({time.perf_counter() - t0:.2f}"
            f"s with the fits)")
        if not finalists or not all(np.isfinite(held)):
            fails.append(f"(c) FindBestModel: finalists {finalists}, AUC "
                         f"{held}")

        # the same search, killed at rung TUNE_KILL_RUNG, then resumed
        d2 = os.path.join(work, "killed")
        t0 = time.perf_counter()
        try:
            with KillAtRung(seed=TUNE_SEED) as chaos:
                tuner(d2).fit(table)
            fails.append("(c) the kill at rung 1 never fired")
        except PreemptionError:
            pass
        kill_s = time.perf_counter() - t0
        before = _bracket(d2)
        t0 = time.perf_counter()
        resumed = tuner(d2).fit(table)
        resume_s = time.perf_counter() - t0
        after = _bracket(d2)
        kept = all(after["fold_scores"][k][:len(v)] == v
                   for k, v in before["fold_scores"].items())
        done = sum(len(v) for v in before["fold_scores"].values())
        refit = sum(len(v) for v in after["fold_scores"].values()) - done
        log(f"  (c) killed at rung {TUNE_KILL_RUNG} after {kill_s:.2f}s "
            f"({len([i for i in chaos.injected if i[0] == 'kill'])} tasks "
            f"killed, {done} fold scores checkpointed), resumed in "
            f"{resume_s:.2f}s with {refit} more fold fits: every completed "
            f"score read back bitwise {kept}; best "
            f"{json.dumps(resumed.bestParams)} against the uninterrupted "
            f"{json.dumps(tuned.bestParams)}")
        if not kept or resumed.bestParams != tuned.bestParams \
                or done != TUNE_CANDIDATES:
            fails.append(f"(c) resume: scores kept {kept}, best "
                         f"{resumed.bestParams} against {tuned.bestParams}, "
                         f"{done} checkpointed")
        card_folds = [state["fold_scores"][k][0]
                      for k in keys[:TUNE_CROSS]]
    finally:
        perfmodel.JOURNAL_PATH = journal
        shutil.rmtree(work, ignore_errors=True)
    return dict(card_folds=card_folds, search_s=search_s, rung_s=rung_s,
                fold_fits=fold_fits, peak_gib=peak, launches=launches,
                best=tuned.bestParams)


def tune_check(card: dict, cpu, fails: list) -> None:
    ref = _automl_npz(cpu, "tune.npz")
    gaps = np.abs(np.asarray(card["card_folds"]) - ref["scores"])
    log(f"  (c) card against CPU: rung-0 fold AUC of candidates "
        f"0-{TUNE_CROSS - 1} {card['card_folds']} against "
        f"{ref['scores'].tolist()}: max |diff| {gaps.max():.3g} (tolerance "
        f"{TUNE_CROSS_TOL}); the CPU port took {float(ref['seconds']):.2f}s")
    if not gaps.max() <= TUNE_CROSS_TOL:
        fails.append(f"(c) rung-0 fold scores {gaps.tolist()} from the CPU "
                     f"port's")


def start_gang(dev: str):
    """(d)'s pool of GANG_WORKERS spool workers (the port's worker module),
    started at the phase's beginning so they import beside (a)-(c)."""
    from synapseml_tpu_torch.automl import GangCandidatePool

    spool = tempfile.mkdtemp(prefix="automl_gang_")
    t0 = time.perf_counter()
    pool = GangCandidatePool(world_size=GANG_WORKERS, spool_dir=spool,
                             hb_timeout=60.0)
    return pool, t0


def gang_part(adult: dict, gang, dev: str, fails: list) -> dict:
    """(d): a fit task on each worker, one rank killed mid-task, the
    re-spooled task's result against the same fit alone."""
    from synapseml_tpu_torch.testing import kill_rank

    pool, started = gang
    spool = pool.spool
    workers = [pool.supervisor.procs[r].args for r in sorted(
        pool.supervisor.procs)]
    if not all("synapseml_tpu_torch.automl.worker" in a for a in workers):
        fails.append(f"(d) the gang's workers are not the port's: {workers}")
    table = featurized(adult["model"], adult["train"])
    test = featurized(adult["model"], adult["test"])
    path = os.path.join(spool, "data.npz")
    np.savez(path, X=table["features"], y=table["label"], Xv=test["features"],
             yv=test["label"])
    task = {"entry": "chip_smoke:gang_fit_task",
            "payload": {"path": path, "device": dev, "iters": TUNE_ITERS}}
    claims, seen, done = {}, [], threading.Event()

    def watch():
        while not done.is_set():
            for fn in os.listdir(spool):
                if ".claimed.r" in fn and fn not in claims:
                    claims[fn] = time.perf_counter()
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    box = {}

    def submit(i):
        try:
            box[i] = pool.run_task(task, budget_s=GANG_WAIT_S,
                                   op=f"phase25.gang{i}")
        except Exception as e:          # noqa: BLE001 — reported below
            box[i] = e

    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(GANG_WORKERS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + GANG_WAIT_S
        while not claims and time.monotonic() < deadline:
            time.sleep(0.01)
        victim = sorted(claims)[0]
        rank = int(victim.rsplit(".r", 1)[1].split(".p")[0])
        old_pid = pool.supervisor.procs[rank].pid
        t_kill = time.perf_counter()
        kill_rank(pool.supervisor, rank)
        # the kill to the respawned rank's own first heartbeat (the
        # supervisor pumped here as well as by the waiting tasks)
        respawn_s = None
        hb = os.path.join(spool, f"hb_p{rank}.json")
        deadline = time.monotonic() + GANG_WAIT_S
        while time.monotonic() < deadline:
            with pool._lock:
                pool.supervisor.step()
            proc = pool.supervisor.procs.get(rank)
            try:
                with open(hb) as f:
                    beat = json.load(f)
            except (OSError, ValueError):
                beat = {}
            if proc is not None and proc.pid != old_pid \
                    and proc.poll() is None and beat.get("pid") == proc.pid:
                respawn_s = time.perf_counter() - t_kill
                break
            time.sleep(0.02)
        for t in threads:
            t.join(GANG_WAIT_S)
        tasks_s = time.perf_counter() - t_kill
    finally:
        done.set()
        watcher.join(5)
    results = [box.get(i) for i in range(GANG_WORKERS)]
    tid = victim.split(".claimed")[0]
    pids = {int(fn.rsplit(".p", 1)[1]) for fn in claims
            if fn.startswith(tid)}
    alone = gang_fit_task(path, dev, TUNE_ITERS)
    ok = [r for r in results if isinstance(r, dict)]
    gaps = [abs(r["auc"] - alone["auc"]) for r in ok]
    log(f"  (d) GangCandidatePool: {GANG_WORKERS} workers "
        f"(python -m synapseml_tpu_torch.automl.worker) started "
        f"{claims and min(claims.values()) - started:.1f}s before the first "
        f"claim; rank {rank} (pid {old_pid}) killed mid-task "
        f"({victim}); its task claimed by pids {sorted(pids)} (re-spooled "
        f"{len(pids) > 1}); the rank respawned and beating after "
        f"{respawn_s if respawn_s is None else round(respawn_s, 2)}s "
        f"(respawns {pool.supervisor.respawns}); both tasks done "
        f"{tasks_s:.2f}s after the kill (claims at "
        f"{sorted(round(t - t_kill, 2) for t in claims.values())}s); "
        f"results AUC "
        f"{[r['auc'] if isinstance(r, dict) else repr(r) for r in results]}"
        f" against the fit alone {alone['auc']:.6f} (tolerance "
        f"{GANG_AUC_TOL}); worker launches "
        f"{[r['launches'] for r in ok]}")
    if len(ok) != GANG_WORKERS or respawn_s is None or len(pids) < 2 \
            or not max(gaps, default=1.0) <= GANG_AUC_TOL:
        fails.append(f"(d) gang: results {results}, respawn {respawn_s}, "
                     f"claimants {pids}, AUC gaps {gaps}")
    if _on_card(dev) and not all(r["launches"].get(k, 0) > 0
                                 for r in ok for k in MAIN_KERNELS):
        fails.append("(d) a worker's fit launched no histogram kernel")
    return dict(respawn_s=respawn_s, auc=alone["auc"])


def automl_path(dev: str, X=None, y=None, reference=None,
                rows: int = 2_000_000) -> dict:
    """Phase 25: (a)-(d) above; every failure is collected and raised at
    the end. ``X``, ``y`` and ``reference`` are phase 3's table and
    classifier (made and fitted here when absent, as phase 3 does on
    ``rows`` rows)."""
    if X is None:
        from synapseml_tpu_torch.models import LightGBMClassifier

        t0 = time.perf_counter()
        X, y = higgs_like(rows)
        reference = LightGBMClassifier(numIterations=10, numLeaves=31,
                                       maxBin=255, device=dev).fit(
            table_of(X, y))
        log(f"  phase 3's classifier fitted on {rows} rows in "
            f"{time.perf_counter() - t0:.2f}s")
    cpu = start_automl_cpu()
    gang = start_gang(dev)
    fails, out = [], {}
    t0 = [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        log(f"  ({name}) took {now - t0[0]:.1f}s")
        t0[0] = now

    try:
        for name, run in (
                ("a", lambda: adult_part(dev, cpu, fails)),
                ("b", lambda: higgs_train_part(X, y, reference, dev, fails)),
                ("c", lambda: tune_part(out["a"], dev, cpu, fails)),
                ("d", lambda: gang_part(out["a"], gang, dev, fails)),
                ("card against the CPU process", lambda: {
                    "a": adult_check(out["a"], cpu, fails),
                    "c": tune_check(out["c"], cpu, fails)})):
            try:
                out[name] = run()
            except Exception as e:          # collected, raised at the end
                import traceback

                traceback.print_exc()
                fails.append(f"({name}) raised {type(e).__name__}: {e}")
            part(name)
            if _on_card(dev):
                torch.cuda.empty_cache()
    finally:
        gang[0].close()
        cpu[0].join(timeout=AUTOML_WAIT_S)
        if cpu[0].is_alive():
            cpu[0].terminate()
            fails.append("phase 25: the CPU process did not end")
        shutil.rmtree(gang[0].spool, ignore_errors=True)
        shutil.rmtree(cpu[1], ignore_errors=True)
    out.pop("card against the CPU process", None)
    if fails:
        raise AssertionError("phase 25: " + "; ".join(fails))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="rows of the HIGGS-shaped table (HIGGS: 11,000,000)")
    ap.add_argument("--phase", type=int,
                    choices=(17, 18, 19, 20, 21, 22, 23, 24, 25),
                    default=None,
                    help="build the kernels and run only this phase (no "
                    "kernels or result line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "synapseml_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} does not hold the synapseml_tpu_torch "
              "package; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from synapseml_tpu_torch.ops import _build

    dev = "cuda"
    t_start = time.perf_counter()
    marks, seconds = [], {}

    def phase(n: int, msg: str = None) -> None:
        """End the running phase (its seconds logged), then start phase
        ``n`` (none without ``msg``)."""
        now = time.perf_counter()
        if marks:
            seconds[marks[-1][0]] = round(now - marks[-1][1], 1)
            log(f"  phase {marks[-1][0]} took {seconds[marks[-1][0]]:.1f}s; "
                f"{card}")
        marks.append((n, now))
        if msg is not None:
            log(f"[{n}] {msg}")

    card = card_line()
    phase(1, f"card: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"    built {sorted(libs)} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc seconds: {json.dumps(_build.BUILD_SECONDS)})")
    if args.phase == 17:
        phase(17, f"distributed GBDT alone, {args.rows} rows")
        dist_path(args.rows, dev)
        phase(0)
        return 0
    if args.phase == 18:
        phase(18, "ONNX inference alone")
        onnx_path(dev, card=card)
        phase(0)
        return 0
    if args.phase == 19:
        phase(19, f"streamed GBDT alone, {STREAM_ROWS} rows")
        stream_path(dev)
        phase(0)
        return 0
    if args.phase == 20:
        phase(20, f"GBDT across ranks and layouts alone, {args.rows} rows "
              f"and {STREAM_ROWS} streamed")
        ranks_layouts_path(args.rows, dev)
        phase(0)
        return 0
    if args.phase == 21:
        phase(21, "pipeline-parallel DL and elastic training alone")
        pipeline_path(dev)
        phase(0)
        return 0
    if args.phase == 22:
        phase(22, "the serving fabric, VW and the online loop alone")
        fabric_online_path(dev, card=card)
        phase(0)
        log(f"  seconds by phase {json.dumps(seconds)}")
        return 0
    if args.phase == 23:
        phase(23, "anomaly detection, recommendation and nearest neighbours "
              "alone")
        analytics_path(dev)
        phase(0)
        log(f"  seconds by phase {json.dumps(seconds)}")
        return 0
    if args.phase == 24:
        phase(24, "explainers, causal inference, the image ops and leaf "
              f"histograms alone (phase 3's classifier fitted first, "
              f"{args.rows} rows)")
        explain_path(dev, rows=args.rows)
        phase(0)
        log(f"  seconds by phase {json.dumps(seconds)}")
        return 0
    if args.phase == 25:
        phase(25, "featurization, TrainClassifier and AutoML alone (phase "
              f"3's classifier fitted first, {args.rows} rows)")
        automl_path(dev, rows=args.rows)
        phase(0)
        log(f"  seconds by phase {json.dumps(seconds)}")
        return 0

    phase(2, f"kernels against their plain versions, n={args.rows}")
    kernels = kernel_phase(args.rows, dev)
    t0 = time.perf_counter()
    X, y = higgs_like(args.rows)
    log(f"  table: {args.rows} rows x {FEATURES} features, made in "
        f"{time.perf_counter() - t0:.3f}s")
    phase(3, f"main path: LightGBMClassifier fit/transform/save, "
        f"{args.rows} rows")
    main = main_path(X, y, dev)
    phase(4, f"depthwise path: train_booster(growth_policy='depthwise'), "
        f"{args.rows} rows")
    depthwise = depthwise_path(X, y, dev)
    phase(5, "cross-check: card against CPU, 100000 rows, 3 iterations")
    for policy in ("leafwise", "depthwise"):
        cross_check(dev, policy)
    phase(6, "profile: 2-iteration training loops")
    from synapseml_tpu_torch.gbdt import Dataset

    ds = Dataset(X, y, device=dev)
    table3 = (X, y)                      # phase 25 featurizes it again
    del X, y
    for policy in ("leafwise", "depthwise"):
        profile_phase(ds, dev, policy)

    phase(7, "flash kernels against their plain versions")
    del ds
    torch.cuda.empty_cache()
    flash = flash_kernel_phase(dev)
    phase(8, f"seq path: TransformerEncoder(mask_free=True) on {SEQ_RANKS} "
        f"ranks sharing the card, batch {SEQ_BATCH} x {ENCODER['max_len']}")
    seq_path(dev)
    phase(9, f"training: DeepTextClassifier(seqParallel=True) on {SEQ_RANKS} "
        f"ranks sharing the card, batch {SEQ_BATCH} x "
        f"{TRAIN_EST['maxTokenLen']}")
    train_launches = train_path(dev)
    phase(10, "objective family: regressor, 7-class classifier and ranker at "
        "full width")
    family_cpu = start_family_cpu()      # beside the full-width fits
    numeric = family_full_width(args.rows, dev)
    log(f"    cross-check: card against CPU, {FAMILY_CROSS_ROWS} rows, "
        f"{FAMILY_CROSS_ITERS} iterations, every objective")
    family_cross_check(dev, family_cpu)
    phase(11, f"vision: DeepVisionClassifier({VISION_BACKBONE}) fine-tunes at "
        f"{VISION_SIZE}x{VISION_SIZE} on CIFAR-10-shaped images")
    vision_path(dev)
    phase(12, f"estimator surface: validation and early stopping on "
        f"{args.rows} rows, leaf indices, SHAP, dumpModel, warm start, "
        "fobj, resume")
    torch.cuda.empty_cache()
    surface = surface_path(args.rows, dev)
    served = dict(booster=surface["leafwise"]["booster"], Xv=surface["Xv"])
    fabric_served = dict(served)           # phase 22 serves it again
    del surface
    phase(13, f"sampling: bagging, GOSS, DART, RF, per-node feature "
        f"fractions and monotone constraints, {SAMPLING_ITERS} iterations "
        f"each on {args.rows} rows")
    torch.cuda.empty_cache()
    sampling_path(args.rows, dev, main["launches"])
    phase(14, "categorical and sparse data: Covertype's raw 12 columns (2 "
        "categorical), both policies, and its one-hot table as CSR")
    torch.cuda.empty_cache()
    categorical = categorical_path(dev, numeric)
    phase(15, f"serving: phase 12's classifier through captured graphs and "
        f"behind the HTTP server with phase 14's model, {SERVE_CLIENTS} "
        f"clients, a hot swap to phase 3's model")
    torch.cuda.empty_cache()
    single = serving_path(dev, served["booster"], served["Xv"],
                          categorical["model"], categorical["Xc"],
                          main["booster"])["load"]
    phase(16, f"DL training state: {VISION_BACKBONE} at {VISION_SIZE}x"
        f"{VISION_SIZE}, checkpoints, resume, non-finite policies, msgpack, "
        f"{STATE_RANKS} ranks replicated and ZeRO")
    del served, categorical
    torch.cuda.empty_cache()
    state_path(dev)
    phase(17, f"distributed GBDT: train_booster(mesh=...) on {DIST_RANKS} "
        f"ranks sharing the card, {args.rows} rows, every learner and wire")
    torch.cuda.empty_cache()
    dist_path(args.rows, dev)
    phase(18, "ONNX inference: ONNXModel.transform on captured graphs, "
        "ResNet-50 (float32, bf16) and the BERT-base-wide encoder, every "
        "committed fixture, phase 3's booster through to_onnx")
    torch.cuda.empty_cache()
    onnx_path(dev, main["booster"], card)
    phase(19, f"streamed GBDT: StreamedDataset and train_booster_streamed "
        f"over {STREAM_ROWS} HIGGS-shaped rows, both policies, resident "
        "mode, the classic classifier, card against CPU, predict_streamed")
    torch.cuda.empty_cache()
    streamed = stream_path(dev)
    phase(20, f"GBDT across ranks and layouts: every row layout and "
          f"partition primitive on {args.rows} rows, {MP_RANKS} processes "
          f"each passing its own rows, phase 19's stream over {MESH_RANKS} "
          "ranks")
    torch.cuda.empty_cache()
    across = ranks_layouts_path(args.rows, dev, streamed["auc"])
    phase(21, f"pipeline-parallel DL and elastic training: staged "
          f"{PIPE_BACKBONE} on {PIPE_RANKS} ranks ({{'stage': 2}}), the "
          f"staged encoder on {PIPE_TEXT_RANKS} ({{'stage': 2, 'seq': 2}}) "
          "with both flash kernels in its stages, the watchdog, a hung hop, "
          "kills and resumes")
    torch.cuda.empty_cache()
    pipe_launches = pipeline_path(dev)
    phase(22, f"the serving fabric, VW and the online loop: phase 12's "
          f"classifier behind DistributedServingServer on {FABRIC_RANKS} "
          f"processes, federated gateways, three tenants with a flood, VW on "
          f"a {CRITEO_ROWS}-row Criteo-shaped table at {CRITEO_BITS} bits, "
          "the online loop with a gated broadcast and a kill")
    torch.cuda.empty_cache()
    fabric_online_path(dev, fabric_served["booster"], fabric_served["Xv"],
                       card, single)
    del fabric_served
    phase(23, f"anomaly detection, recommendation and nearest neighbours: "
          f"IsolationForest on a {CREDIT_ROWS}-row credit-card-shaped table, "
          f"AccessAnomaly on {ACCESS_TENANTS} tenants, SAR on a "
          f"MovieLens-10M-shaped log, KNN and ConditionalKNN on a "
          f"SIFT1M-shaped corpus")
    torch.cuda.empty_cache()
    analytics_path(dev)
    phase(24, f"explainers, causal inference, the image ops and leaf "
          f"histograms: TabularSHAP and TabularLIME on phase 3's classifier "
          f"({EXPLAIN_ROWS} rows), ImageLIME on the seeded {VISION_BACKBONE} "
          f"at {VISION_SIZE}x{VISION_SIZE}, DoubleML on {DML_ROWS} rows, "
          f"SyntheticDiffInDiff on two panels, every image op and "
          f"leaf_histograms on the card against the CPU port")
    torch.cuda.empty_cache()
    explain_path(dev, main["model"])
    phase(25, f"featurization and AutoML: TrainClassifier on a "
          f"{ADULT_ROWS}-row Adult-shaped table and on phase 3's table, "
          f"TuneHyperparameters over {TUNE_CANDIDATES} candidates x "
          f"{TUNE_FOLDS} folds (eta {TUNE_ETA}, {TUNE_THREADS} threads) with a "
          f"kill and a resume, FindBestModel, and {GANG_WORKERS} gang workers "
          f"with a killed rank")
    torch.cuda.empty_cache()
    automl_path(dev, *table3, main["model"])
    del table3
    phase(0)
    log(f"  seconds by phase {json.dumps(seconds)}")
    log(f"  launches on phase 20's paths: {json.dumps(across['launches'])}")
    log(f"  flash launches in phase 9's fits {json.dumps(train_launches)}, "
        f"in phase 21's pipeline stages {json.dumps(pipe_launches)}")

    launches = {**{k: main["launches"][k] for k in MAIN_KERNELS},
                **{k: depthwise["launches"][k] for k in DEPTHWISE_KERNELS},
                **pipe_launches}
    sources = {**{k: "synapseml_tpu_torch/csrc/hist_kernel.cu"
                  for k in kernels},
               **{k: "synapseml_tpu_torch/csrc/attention_kernel.cu"
                  for k in flash}}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in {**kernels, **flash}.items()]}
    log(f"    total {time.perf_counter() - t_start:.1f}s")
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
