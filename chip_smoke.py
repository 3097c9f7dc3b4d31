#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's paths (``tracknetv3_tpu_torch``) at the full width
of the published TrackNet configuration (seq_len 8, bg_mode concat,
288x512, bf16 convolutions): training (batch 10, alpha 0.5 mixup, Adam
1e-3) from weights made from a seed, on plain batches and on segmented,
frame-mixup and device-resident ones, and single-video serving (eval_mode
weight, InpaintNet seq_len 16) from the checkpoint that training wrote,
with its 3x3 convs on cuDNN and on each hand-written conv kernel. It
holds each hand-written kernel against its plain PyTorch version. One
compact JSON line per phase (``--verbose`` prints the line of every shape
or case too); the train CLI's own lines go to stderr; any failed phase
exits nonzero.

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the six CUDA sources of ``tracknetv3_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once), timed; the count of
   ``HGMMA`` (wgmma), ``UTMALDG`` / ``UTMASTG`` (TMA) and ``SYNCS``
   (mbarrier) instructions in the conv library's SASS, and of ``UBLKCP``
   (1-D bulk copies) and ``SYNCS`` in the copy library's, which must not
   be 0;
3. kernel vs plain at the main-path shape (10, 288, 512, 8), plain and
   mixup targets, logits reaching the clamp, and mixup targets on logits
   that peak on the label disks: loss relative error <= 1e-5, max |dz -
   dz_plain| <= 1e-5 * max |dz_plain|; K1 gives the same loss bits in four
   calls; two wrong K1 forwards emulated from the plain version (the last
   item's partial dropped, every label row skipped) must fail the 1e-5
   bound on the peaked logits; kernel_times: median kernel and plain times
   of K1 and K2 beside each kernel's bound, the larger of the bytes at 3.35
   TB/s and the arithmetic instructions per element (read from the probe
   kernels of ``csrc/wbce_disk.cu``'s SASS, moves, convergence markers and
   uniform index math left out) at the issue rate of the SM clock
   ``nvidia-smi`` reads;
4. bn_vs_plain: the four BatchNorm + ReLU kernels (P4 statistics, P5
   normalise + ReLU, the backward's reduce and apply) against their plain
   versions at the train step's four shapes at batch 10, bf16 and float32,
   on data with per-channel means far from 0, exact zeros and a constant
   channel (variance 0, a ReLU tie): statistics against float64, the
   forward and the apply bit-exact on equal inputs, the whole op's output
   and dy, dgamma, dbeta within ``BN_BOUNDS``, which a backward without
   its mean term or its variance term must fail; bf16 times of each
   kernel, its plain version and ``torch.var_mean`` beside each bound;
5. the slice: a synthetic dataset (numpy only, in the loader's npz cache
   formats) and ``tracknetv3_tpu_torch.train.main`` for one epoch, then
   ``--resume_training`` to epoch 2; K1/K2 must have launched once per
   train step, each BatchNorm kernel 17 times per train step and the
   normalise 17 times per eval batch; losses finite, checkpoints reload,
   val metrics back; then ms/step of the full-width step and peak device
   memory;
6. step parity: one train step (TF32 off, deterministic cuDNN) from the
   same weights and batch through the kernels and with one part swapped
   for its plain version. float32: the plain loss, and the plain
   BatchNorm; loss relative error <= 1e-5, relative L2 error of each
   parameter gradient <= 1e-4. bfloat16: the plain BatchNorm within
   ``STEP_PARITY_BOUNDS``, which the two wrong backwards must fail;
7. pool_up_vs_plain: the 2x2 max pool (P6) and nearest-2x upsample (P7)
   kernels vs ``F.max_pool2d`` / ``F.interpolate`` at the serving forward's
   six shapes at batch 16 and at batch 23 (the B+L-1 windows of the
   stateless chunks of phase 15), bf16 with NaN and -inf entries:
   bit-exact (max abs error 0, NaN positions equal); at batch 16 median
   kernel and plain times beside each shape's bytes bound;
   decode_peak: the peak-blob decode kernel (``csrc/detect.cu``) against
   ``decode_heatmaps_plain`` at serving's three calls (v3's chunk of 16
   maps and flush of 7, v2's 16 x 3 maps as a view of NHWC memory), bit for
   bit in every field, which a one-step plain decode must fail; one call
   under ``torch.cuda.set_sync_debug_mode("error")``; kernel, plain and
   host-per-call times beside the bound (the maps read once at 3.35 TB/s);
8. conv_vs_plain: the two 3x3 conv kernels (``k3c``: P1, P2 with the sheet,
   P3 ``full``; ``9tap``: P2 without, P3 ``full-9mm``) against
   ``conv3x3_bias_relu_plain`` at the 11 distinct shapes of the serving
   forward's 17 convs at batch 16 and at batch 23 (the B+L-1 windows of
   the stateless chunks of phase 15) and at two shapes with odd H and W, with
   and without the bias + ReLU epilogue, on inputs with exact zeros, a NaN
   and an inf: NaN and inf positions equal (and the NaN exactly on its 3x3
   neighbourhood), every other element within ``CONV_ULPS_BOUND`` bfloat16
   spacings, and the two kernels within it of each other, which five
   deliberately wrong convs (a tap dropped, dx mirrored, the halo not
   zero-filled, the bias added after the cast, the last input-channel chunk
   dropped) must fail; times of each kernel, the plain version, cuDNN alone
   and cuDNN with the torch epilogue passes, per shape and summed over the
   17 calls of one forward, beside the bound; conv_ablate: the ablation
   probe's six variants at (24, 72, 128, 256 -> 256), ms and share of the
   bf16 peak;
9. serve: ``stage_frames`` -> ``run_staged`` -> ``inpaint_trajectory`` ->
   ``write_pred_csv`` on a synthetic 480-frame 288x512 video, with the
   trained TrackNet and a seeded InpaintNet, at batch 16 (the CLI default)
   and 120: 480 CSV rows, every coordinate inside the frame, P6 and P7
   each launched 3x per chunk forwarded, the decode kernel once a chunk
   and once for the flushed tail; after a warm-up, the median of 2
   runs of run_fps (frames / run_staged wall time), e2e_fps (host frames
   to CSV) and peak device memory; then the same through
   ``conv_backend="hand_k3c"`` and ``"hand_9tap"`` at batch 16 and 120 (17
   launches of the conv kernel per chunk forwarded);
   serve_vs_cpu, after each of these: one more served run of the video's
   first 64 frames (``SERVE_REPLAY_T``, a depth cut for time), with the
   trained checkpoint's predictor bias lowered so that its heatmaps hold
   detections (``detecting_checkpoint``), whose chunks' window
   probabilities are copied to the host. Each chunk is held to the
   unfolded TrackNet in eval mode on the same input (phase 10's bf16 bound);
   a CPU predictor replays the probabilities through its own
   ``run_staged`` (ensemble, decode, the flushed tail rows) and
   ``inpaint_trajectory``: its rows must equal the card's, and so must
   InpaintNet's output on the served rows and on the disk's track with an
   occlusion cut into each pass (a masked frame may differ by 1 px: the
   two devices sum InpaintNet's convolutions in different orders);
10. serve_parity: three chunks of 16 windows of the served video through
   the folded forward on the ``cudnn`` route and through the unfolded TrackNet
   in eval mode (cuDNN, its BatchNorm on the P5 kernel, torch pool and
   upsample) from a checkpoint trained as phase 5's but with deterministic
   cuDNN, no autotuning and TF32 off (``deterministic_checkpoint``: it
   repeats from run to run, and so do the readings), TF32 off: float32 max
   |probability difference| <= 1e-5, mean <= 1e-6 (the bounds of
   ``tests/test_torch_fused_forward.py``); bfloat16, two roundings of one
   function, within ``SERVE_PARITY_BOUNDS``, set between these sound
   readings and the upper readings of deliberately wrong forwards
   (``wrong_forward``), each of which must fail the bound; the bfloat16
   chunks also go through both hand conv backends, under the same bound.

11. copy_vs_plain (run after phase 4): the three copy kernels (each
   ``window_copy`` and ``repeat_rows`` case names the route of the plan it
   launched)
   (``window_copy``, ``repeat_rows``, ``roll_cols``: the halo / shift,
   repeat and roll probes U1-U7) at the probes' shapes ((32, 264, 128)
   bf16, (32, 256, 256) for U4, float32 and bf16 for U6, (2, 32, 264, 128)
   for U7) and at the train path's (segments (2, 12, 288, 512, 3) uint8 ->
   (10, 8, ...), the median x5, and x1, and x5 of a row of an odd byte
   count (1-byte vectors), 80 frames of a 160-frame resident buffer,
   10 float32 medians, the blend's two gathers) and the rally evaluation's
   (16 windows of 8 frames from a padded 200-frame rally), float inputs holding NaN
   payloads, -0.0, inf and denormals: every bit equal to the plain version
   and to one PyTorch call, while a wrong version of each (a start off by
   one, the unshifted tile, the other channels, the tiled repeat, a roll
   the other way) must differ; times beside the bytes bound (for the repeat
   cases also a plain ``copy_`` of the output's bytes and an empty kernel);
12. seg_train (after phase 6): ``train.main`` for one epoch each with
   ``--segment_windows 5``, ``--frame_alpha 0.5`` (alone: the two-disk loss
   kernels; with ``--alpha 0.5``: materialised labels) and
   ``--resident_frames``: finite losses, val metrics, and the copy kernels'
   launches (1 ``window_copy`` + 1 ``repeat_rows`` per segmented step, 2
   ``window_copy`` per frame-mixup or resident step and per resident eval
   batch); seg_step_time: ms per step, peak memory and host bytes shipped
   on one fixed batch of each kind, the plain batch first and last;
   seg_parity: one float32 train step (TF32 off, deterministic cuDNN) on a
   segmented and on a resident batch against the plain batch holding the
   same windows: the assembled input bit-equal, loss and gradients
   bit-equal (or within phase 6's float32 bounds if a plain step does not
   repeat itself bit for bit).
13. inpaint_train (after phase 12): InpaintNet at the README configuration
   (seq_len 16, StepLR, mask_ratio 0.3, batch 32, Adam 1e-3 with its
   gradients clipped to a global norm of 1.0, float32, TF32 off) through
   the train CLI on the synthetic dataset's ``predicted_csv`` files: 2
   epochs, then resumed for a third; the eval (``eval_inpaintnet``) with
   the trained model; no hand kernel launched; one card step held to the
   same step on the CPU (same init, batch and mask): the loss, every
   gradient and the parameters as one vector within relative L2 1e-5
   (each parameter's reading printed: Adam's first step moves a
   zero-initialised bias by lr * g / (|g| + eps), so float32 rounding of a
   gradient element near 0 moves a whole element of such a bias); ms per
   step (median of 20) and peak memory beside the card's name and power
   limit.

14. rally (after phase 13): rally evaluation at the same width (seq_len 8,
   concat, 288x512, batch 16, bf16 on the default ``hand_9tap`` route) on
   the synthetic dataset's test split (2 rallies x 200 frames, corrected
   labels, a drop-frame window, a ``0.png`` per rally), with phase 5's
   TrackNet with its predictor's bias lowered (``detecting_checkpoint``):
   ``generate_mask_data`` over the three splits (one ``predicted_csv`` row
   per label row), one epoch of InpaintNet training on those files, then
   the ``test`` CLI in ``weight``, ``nonoverlap``, ``--exact_decode``,
   ``--exact_decode host``, ``--linear_interp``, with the InpaintNet
   checkpoint and with ``--output_bbox`` (mAP): one row per label row,
   coordinates inside the frame, per chunk forwarded 17 conv-kernel
   launches, 3 of P6 and of P7 and 1 ``window_copy`` (none with
   InpaintNet); frames/s of each run (``last_eval_stats``);
   rally_vs_cpu: the card's window probabilities of each chunk replayed
   through a CPU engine, whose rows must equal the card's (InpaintNet's
   too, over the generated files with an occlusion cut into each 40-frame
   pass: a masked frame within 1 px); the card's ``decode_heatmaps_exact``
   equal to ``decode_heatmaps_host`` on every ensembled test frame and on a
   seeded multi-blob corpus at 288x512 (area ties, blobs larger than the
   crop), on which two wrong rules (ties kept last, a fill capped at the
   crop) must differ; the exact, the peak-blob and the host decoders' ms
   per frame over the first rally's ensembled frames in chunks of 16.

15. serve_paths (after phase 10): the rest of serving at the same width
   (seq_len 8, concat, 288x512, batch 16, bf16, ``hand_9tap``) on videos
   drawn in memory at 1280x720 (``synthetic_reader`` installed at
   ``inference.open_video``: the card's machine has no decoder), with a
   TrackNet from a seeded init holding one hand-set path that finds the
   disk (``disk_detector_checkpoint``) and InpaintNet (seed 17):
   ``predict_video(device_resize=True)`` over 480 frames in ``weight`` and
   ``nonoverlap`` (CSV rows, every visible row within 4 model pixels of
   the disk, 17 / 3 / 3 launches a chunk; run_fps, e2e_fps from frames in
   memory to CSV, the median's and a chunk's resize ms, peak memory; over
   the first 160 frames the card's window probabilities replayed by a CPU
   predictor give the same rows); the resize of one chunk within ``RESIZE_BOUND`` of a float64
   resize, which a TF32 resize must fail; ``predict_video_streaming``
   without the host resize (cv2) in both modes: rows within 1 px of the
   device-resize rows (the differing ones counted), frames/s, peak memory
   at 480 and 960 frames within 10% (the median over the default
   ``max_sample_num`` of 1800, so over every frame), the median's seconds
   and peak over 1800 sampled frames below that peak, a reader failing at
   frame 200 raising ``RuntimeError`` before any CSV; ``predict_videos``
   over five videos (480, 300, 97, 33 frames and one failing mid-read)
   under a budget of two 600-frame waves: the waves, the failing video
   skipped (raised under ``on_error="raise"``), rows equal to each video
   served alone on the same predictor, peak memory within two waves, one
   video and a video's working memory, frames/s against the single calls
   in sequence.

16. yuv_stage (after phase 15): YUV420 staging, the default of the native
   decoder, which the card's machine lacks (no libav there): first
   ``yuv420_to_rgb`` on one reader slab (120 seeded frames at 288x512
   spanning 0..255, so that c < 0 and both clips occur) bit-equal to its
   CPU run and to the numpy version (``yuv420_to_rgb_np``), ms a slab
   beside its bytes bound; then a stand-in native reader
   (``synthetic_native_reader`` at ``inference.open_native_video``: the
   ``_Scene`` frames drawn at model size, planar YUV420 from them by the
   BT.601 forward transform with 2x2-averaged chroma; a 1280x720 source)
   and ``predict_video`` of a 480-frame video at the same width (batch 16,
   bf16, ``hand_9tap``, InpaintNet seed 17) under ``stage_format="yuv420"``
   and ``"bgr"``: ``decode_backend``, 17 / 3 / 3 launches a chunk, CSV
   rows, every visible row within 4 model pixels of the disk, H2D bytes (the
   YUV420 video half of BGR's), upload s, finalize ms (the conversion and
   the median), run_fps, e2e_fps (median of 3 after the entry-point call),
   peak memory; the YUV420 run's staged frames, median and rows equal to a
   CPU predictor staging the same planes and replaying the card's window
   probabilities; YUV420 rows within a model pixel of the BGR rows; a forced
   ``yuv420`` at an odd model width raises, where ``auto`` stages packed BGR.

17. tools (after phase 13): the host tools' device work. Dataset
   preparation's rally median (``utils.io.get_rally_median``) over 240
   seeded 1280x720 uint8 frames drawn in memory (a stand-in
   ``generate_frames``: no decoder on the card's machine), taken on the card
   in slabs of rows: bit-equal to host ``np.median`` over a float32 band of
   90 rows, ``median.npz`` holding it; seconds and peak memory of both. Then
   one ``--debug`` epoch of the train CLI at the README's TrackNet
   configuration and one of InpaintNet (seq_len 16, StepLR, mask_ratio 0.3,
   batch 20) on phase 5's dataset: ``logs/scalars.jsonl`` holding the
   returned history in the JAX loop's tags, the progress sample
   (``cur_pred.gif``, ``cur_traj.png``) written every 4 steps, each
   TrackNet sample's eval forward through the BatchNorm kernel (17
   ``bn_relu_fwd`` launches on top of the train steps' and validation's),
   no hand kernel on InpaintNet's path; where PIL or matplotlib is not
   installed, a line naming it and the runs' ``(viz skipped: ...)`` lines
   instead of the files; each sample's drawing time (on the loop's writer
   thread) and the same TrackNet epoch without samples. Last, ms a train
   step over 40 steps queued back to back on a fixed batch, alone and while
   a GIF is drawn over and over on another thread.

18. mesh (after phase 16): data-parallel serving and rally evaluation
   (``parallel/mesh.py``) at the same width (seq_len 8, concat, 288x512,
   batch 16, bf16, ``hand_9tap``) with a TrackNet holding the hand-set path
   to the disk (``disk_detector_checkpoint``) and InpaintNet (seed 17). On a
   card alone ``make_mesh(2)`` must refuse ("only 1 available"), so the
   meshes are ``make_mesh(devices=["cuda:0", "cuda:0"])``, the card stood
   in twice, and, where there are two cards, ``make_mesh(2)``.
   mesh_serve: ``run_staged`` of a 240-frame video drawn in memory in
   ``weight`` and ``nonoverlap`` on each mesh against ``mesh=None``: rows and
   InpaintNet's rows equal, per chunk and shard 17 ``9tap``, 3 P6 and 3 P7
   launches, ``run_fps`` (median of 3 after a warm-up) and peak memory per
   card; ``predict_videos`` of three videos (480, 300, 97 frames) through
   ``num_devices=2`` with ``inference.make_mesh`` standing the card in twice:
   CSVs equal to the single device's; unpatched
   ``predict_video(num_devices=2)`` on a card alone raises ``ValueError``.
   mesh_rally: ``RallyTestEngine(mesh=)`` over the synthetic test split
   against ``mesh=None``: X, Y, BBox equal, Confidence within 1e-3, 2
   ``window_copy`` launches per evaluated chunk against 1, frames/s.
   mesh_procs: ``engine.test(split, save_inpaint_mask=True)`` in two
   processes on cuda:0 over a gloo group (127.0.0.1, a free port), each on
   its own copy of the test split and limited to ``MESH_CHILD_S``: both end
   with the SHA-256 of one process's dict and write every ``predicted_csv``
   file; each rank gathers only its rally's windows. mesh_procs_val: in the
   same two processes, the train loop's validation merged over the group
   (``evaluation/loops.py``): ``eval_tracknet`` over the val split (3
   batches of 4, serving and exact decode; the eval step's 17 BatchNorm
   layers on ``bn_relu_fwd``) and ``eval_inpaintnet`` over its
   ``predicted_csv`` files, with deterministic cuDNN and no autotuning:
   each rank's losses and confusions bit-equal to one process's on the
   card, 17 ``bn_relu_fwd`` launches per batch a rank evaluated; the
   merge's seconds.

19. convert (after phase 18): a reference TrackNetV3 checkpoint of the
   README's TrackNet (seq_len 8, concat, 27 input channels; seeded He-scaled
   weights, BatchNorm statistics, ``num_batches_tracked``) and one of
   InpaintNet, written in the reference's ``torch.save`` layout, converted by
   ``python -m tracknetv3_tpu_torch.convert_reference_checkpoint`` (both at
   once, a process each; seconds), then served by ``predict_video`` (a
   ``CONVERT_T``-frame video from the stand-in native reader, batch 16,
   bf16, ``hand_9tap``, InpaintNet): 17 / 3 / 3 launches a chunk, a CSV row
   a frame; each chunk's window probabilities against the reference
   architecture in ``torch.nn.functional`` (``reference_tracknet_forward``)
   in float32 with TF32 off on the same inputs within ``CONVERT_BOUNDS``,
   which two wrong converters (3x3 kernels spatially transposed, running
   statistics dropped) must fail; the converted InpaintNet against its
   reference forward in float32 within ``INPAINT_CONVERT_BOUND``.

20. mesh_train (after phase 19): data-parallel training of the README's
   TrackNet (batch 10 in ``SHARES`` shares of 5, sample mixup whose partner
   rows lie on the other share). split_vs_plain: the four split BatchNorm
   entry points (``bn_stats_sums``, ``bn_relu_fwd_split``,
   ``bn_relu_bwd_sums``, ``bn_relu_bwd_apply_split``) against their plain
   versions at the step's four shapes at a share of 5, bf16 and float32,
   within ``SPLIT_BOUNDS``; the forward's sums bit-equal over
   ``SPLIT_REPEATS`` launches and to the numpy model of the kernel's order
   (``bn_stats_sums_in_order``); the split normalise's out, st and running
   statistics bit-equal to its plain pair (finalize, then normalise) and to
   the unsplit normalise kernel on the plain st, a launch without running
   statistics to one with them, the synchronised op over two shares on the
   card to one split normalise a share (the running statistics updated
   once), and a wrong split normalise on the share's own sums unequal; the
   split apply's dy, dgamma and dbeta bit-equal to the unsplit apply kernel
   on the plain finalize's coefficients; 1 device launch a call of each
   fused kernel (torch.profiler); bf16 times summed over one share's 17
   layers beside the bound. mesh_step_parity:
   one float32 Adam step (TF32 off, deterministic cuDNN) over a mesh that
   stands the card in twice (and over
   two cards where there are two) against the single step on the global
   batch: loss, every gradient (the worst one, and all as one vector), the
   running statistics and the parameters within ``MESH_STEP_BOUNDS``, which
   two wrong steps must fail: the unsynchronised step (each share with its
   own statistics) and the step whose backward alone is unsynchronised
   (each share's coefficients from its own sums and rows). Two witnesses,
   held to no bound: the single step on the same batch with its rows
   reordered (the halves swapped, the mixup carried along), which moves
   nothing but the order of every sum over the batch; and the 2-share step
   against the single step with cuDNN off on both sides (PyTorch's own
   convolutions), which takes cuDNN's choices for a half batch out of the
   comparison. mesh_train: one epoch of the train
   CLI with ``--num_devices 2`` (the loop's ``make_mesh`` standing the card
   in twice where it is alone): per train step and layer 2 launches of the
   forward's sums, of the split normalise, of the backward's sums and of the
   split apply, none of the unsplit reductions or apply, the unsplit
   normalise on the eval batches alone, K1 / K2 once a share. mesh_step_time: bf16 ms per step (median of
   10 after 2) single and over each mesh, peak memory per card, the ms a step spends
   in the 34 cross-share sums (CUDA events) and in the split kernels.
   mesh_procs_train: two processes on cuda:0 over a gloo group (one share
   each, ``DeviceGroup`` on host copies) and, where there are two cards, two
   over NCCL (rank r on cuda:r), started at the phase's start:
   ``MESH_TRAIN_STEPS`` float32 steps once the kernel timings are done
   (beside the untimed parity steps and CLI epoch), the first held to the
   single step (``MESH_STEP_BOUNDS``), the last to the same steps over the
   card stood in twice in one process (``MESH_PROCS_BOUND``), the ranks'
   parameters bit-equal; then, once the step timings are done, each rank's
   bf16 ms per step and its split kernels' launches.

21. mesh_shard (after phase 20): resident frames sharded over the holders
   (``frame_sharding="shard"``) on the train cell's synthetic split (160
   frames, 70.8 MB of RGB; 80 rows, 35.4 MB an entry at N = 2), at the README
   width. mesh_shard_parity, on the card stood in twice and on two cards
   where there are two: each entry's rows equal to the same rows of the
   replicated buffer (the bytes each entry holds); the first README batch's
   assembled inputs, per share (the train step's exchange) and whole on the
   first entry (the eval step's), bit-equal to ``"replicate"``'s; the
   ``window_copy`` launches of that assembly held to the design's count:
   under ``"shard"`` one a holder and share with rows to send (N x N where
   every entry holds a row of every share's windows) and one reorder a
   share, then a median gather a share, and for the whole batch one a holder
   with rows plus one reorder and one median gather; under ``"replicate"``
   a frame and a median gather a share and the same on the first entry; one
   float32 step (TF32 off, deterministic cuDNN, sample mixup with every
   partner on the other share) under ``"shard"`` bit-equal to the
   ``"replicate"`` step: loss, gradients, running statistics, parameters
   (SHA-256); both comparisons must fail on two wrong exchanges: the
   reorder skipped, and each holder's local rows off by one shard
   (``_wrong_exchange``). mesh_shard: one epoch of ``train --num_devices 2
   --resident_frames`` with the loader's budget at 3/4 of the train split
   (``SHARD_BUDGET_SHARE``, patched in as ``mesh_train`` patches
   ``make_mesh``): the line ``Resident frames: split staged to device memory
   (shard over 2 devices)``, finite losses, and ``window_copy`` launches
   equal to the sum of its batches' exchanges (drawn again on the host), a
   median gather a share and step, and two gathers an eval batch (the val
   split, half as large, replicated). mesh_shard_time: bf16 ms a step under
   ``"replicate"`` and ``"shard"`` in turns (replicate, shard, shard,
   replicate; median of 10 after 2 each) on each mesh, the exchange's ms alone
   (CUDA events on every card) and bytes (gathered, copied between two
   cards, reordered), peak memory per card. mesh_shard_procs: each process
   of ``mesh_train``'s pairs (gloo on cuda:0; NCCL on two cards where there
   are two) takes the same float32 step on its resident loaders' first batch
   (``process_count`` 2) under both placements, among its float32 work:
   each rank's ``"shard"`` step bit-equal to its ``"replicate"`` step and to
   the one-process mesh's on the card stood in twice.

``--conv_only`` runs phases 1, 2 and 8 alone (a first check of a changed
conv kernel), ``--copy_only`` phases 1, 2 and 11, ``--loss_only`` phases 1,
2 and 3, ``--inpaint_only`` phases 1 and 13, ``--rally_only`` phases 1, 2
and 14 (from a TrackNet made from a seed), ``--serve_paths_only`` phases 1,
2 and 15, ``--yuv_only`` phases 1, 2 and 16, ``--tools_only`` phases 1, 2
and 17, ``--mesh_only`` phases 1, 2 and 18, ``--convert_only`` phases 1, 2
and 19, ``--mesh_train_only`` phases 1, 2 and 20, ``--mesh_shard_only``
phases 1, 2 and 21 (starting its own pairs of training processes, which run
only their sharded steps), ``--split_bn_only`` phases 1, 2 and phase 20's
split_vs_plain, ``--decode_only`` phases 1, 2 and phase 7's decode_peak,
``--v1_only`` phases 1, 2 and v1 (below); none prints a kernels line.

v1 (TrackNetV1, the original TrackNet; in the whole run after conv_ablate):
v1_conv_vs_plain holds the conv kernels' ReLU -> affine epilogue mode
(``scale`` / ``shift``, random per channel) to ``conv3x3_bias_relu_plain``
at each distinct conv shape of TrackNetV1's forward at batch 16
(``V1_CONV_SHAPES``, 12 for its 18 convs: 9 -> 64 padded to 16 and the
64 -> 256 head at 360x640, down to 512 -> 512 at 45x80, whose partial tiles
the U-Net never makes), within ``CONV_ULPS_BOUND``, NaN and inf where the
plain version has them, k3c equal to 9tap bit for bit; the affine before the
ReLU (the wrong order) must fall outside the bound. v1_serve, in a process
of its own: the predict CLI (``--cv2_decode --profile``, a reader stood
in) serves a 60-frame clip through ``predict_video`` -> ``run_staged``
with a seeded TrackNetV1 checkpoint on each hand backend: rows equal
between them, frames 0-1 invisible, ``launch.conv3x3_relu_affine`` 18 a
chunk, and ``spans.json`` holding ``serve::classify``. With ``--v1_only``
also v1_conv_times: at each shape both kernels with the affine, the 9tap
kernel without it, the plain version, cuDNN with torch's epilogue passes
and the bound, and their sums over the 18 convs.
With ``--copy_only`` or ``--loss_only``, ``--baseline DIR`` (a checkout of another commit, e.g. the
parent's unpacked by ``git archive`` into ``build/``) builds that tree's copy
and loss kernels from its own sources, holds them bit for bit against this
tree's and times the two in turns (old, new, new, old), with the host time
of a call of each forward or copy wrapper beside. With ``--split_bn_only``
it builds that tree's BatchNorm kernels, holds the split normalise bit for
bit against its ``bn_stats_finalize`` + ``bn_relu_fwd``, times that pair (a
finalize and ``SHARES`` normalises a layer) in turns with ``SHARES`` split
normalises, and traces the pair's launches apart at each shape.

Then the ``{"kernels": [...]}`` line, the card line from ``nvidia-smi``,
and as the last line ``{"ok": true, "device": {...}}``. Exits with 2,
printing no result, where CUDA is missing or the package is not beside
this script.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W, L = 10, 288, 512, 8  # the main path's loss shape (README config)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
DEVICE = "cuda"  # of the BatchNorm, step-parity and serving phases
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense


_START = time.time()
VERBOSE = False  # --verbose: the per-shape detail lines go to the output too


def emit(obj, detail: bool = False) -> None:
    """One JSON line; a phase's line also carries the seconds since start.
    A ``detail`` line (one shape or case of a phase, which the phase's own
    line summarises) is printed only with ``--verbose``."""
    if detail and not VERBOSE:
        return
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.time() - _START, 1)}
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"chip_smoke: phase {phase} failed: {msg}")


# ---------------------------------------------------------------- timing


def time_launches(fn, n: int = 30, windows: int = 5) -> float:
    """Device time per call in ms, the median over ``windows`` windows of
    ``n`` calls. Before each window the card spins so that the host can
    queue all ``n`` calls; one event pair spans them, so host launch
    overhead is hidden, as it is inside a busy training step."""
    import torch

    fn(0)  # warm-up
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def host_us_per_call(fn, n: int = 200, windows: int = 5) -> float:
    """Host time of one call in us, the median over ``windows`` windows of
    ``n`` calls, while the card spins so that no call waits for it: what a
    wrapper adds to the host's side of a step."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def bound_ms(n_bytes: int, n_ops: int, peak: float = F32_FLOPS):
    """Least time on the card for the work: (ms, what bounds it); ``peak``
    is the card's rate for the operations' type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- phases


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card})
    return card


def phase_build(baseline=None):
    from concurrent.futures import ThreadPoolExecutor

    from tracknetv3_tpu_torch.ops import (
        batchnorm,
        conv3x3,
        cuda_build,
        detect,
        pool_up2x,
        shift_copy,
        wbce_disk,
    )

    modules = (wbce_disk, pool_up2x, batchnorm, conv3x3, shift_copy, detect)
    t0 = time.time()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(lambda m: cuda_build.build(m.SOURCE), modules))
    seconds = time.time() - t0
    sources = {}
    for mod, (path, log) in zip(modules, builds):
        mod._lib()
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "entry function" in ln or "spill" in ln]
        emit({"phase": "build", "source": f"tracknetv3_tpu_torch/csrc/{mod.SOURCE}",
              "library": os.path.relpath(path, ROOT), "ptxas": regs}, detail=True)
        used = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        sources[mod.SOURCE] = {"kernels": len(used), "max_registers": max(used, default=None),
                               "max_spill_bytes": max(spills, default=0)}
    path = {mod: p for mod, (p, _) in zip(modules, builds)}
    with ThreadPoolExecutor(2) as pool:  # one cuobjdump per library, both at once
        sass = dict(zip(("conv3x3", "shift_copy"), pool.map(
            lambda a: _sass_counts(*a),
            ((path[conv3x3], ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS")),
             (path[shift_copy], BULK_OPCODES)))))
    emit({"phase": "build", "nvcc": "one process per source, all at once",
          "seconds": round(seconds, 3), "sources": sources,
          **{f"{k}_sass": v for k, v in sass.items()}})
    # the copy ring is built from bulk copies and mbarriers
    counts = sass["shift_copy"]
    if isinstance(counts, dict) and not all(counts[op] > 0 for op in BULK_OPCODES):
        fail("build", f"shift_copy: no bulk-copy or mbarrier instruction in its SASS: {counts}")
    if baseline is not None:  # the other tree's kernels, built before timing, all at once
        with ThreadPoolExecutor(len(baseline)) as pool:
            list(pool.map(lambda m: m._lib(), baseline))


# SASS of the 1-D bulk copies (UBLKCP: cp.async.bulk, both directions) and of
# the mbarrier operations (SYNCS)
BULK_OPCODES = ("UBLKCP", "SYNCS")


def _sass(library):
    """``cuobjdump -sass`` of a built library, or why it is not there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None, "not measured: no cuobjdump"
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        return None, f"not measured: cuobjdump exited {out.returncode}"
    return out.stdout, None


def _sass_counts(library, opcodes):
    """How many instructions of each SASS opcode a built library holds (any
    suffix: ``UBLKCP.S.G`` counts as ``UBLKCP``): HGMMA (wgmma), UTMALDG /
    UTMASTG (TMA tensor loads / stores), UBLKCP (1-D bulk copies), SYNCS
    (mbarrier operations); "not measured" where cuobjdump is missing."""
    text, why = _sass(library)
    if text is None:
        return why
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in opcodes}


def _logits_np(seed: int) -> np.ndarray:
    """Logits (B, L, H, W) with tails past the clamp (|z| > 16.2). Values
    within 1e-3 of the clamp boundary +-16.1181 move off it: there the
    plain version's clamp gradient (torch passes it at equality) and the
    kernel's strict test may disagree on an exact tie."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, L, H, W), dtype=np.float32) * np.float32(8.0)
    near = np.abs(np.abs(z) - 16.1181) < 1e-3
    z[near] += np.float32(0.01) * np.sign(z[near])
    return z


def _centers_np(rng) -> np.ndarray:
    cx = rng.integers(0, W, (B, L))
    cy = rng.integers(0, H, (B, L))
    cx[0, 1] = cy[0, 1] = 0  # one frame without a ball
    return np.stack([cx, cy], axis=-1).astype(np.int32)


PEAK = 12.0  # kernel_vs_plain's peaked logits: raised by this much on the label disks


def _label_rows(cxcy2, sigma: float):
    """(B, L) counts of the rows of each plane that can hold a label pixel:
    within sigma of a visible center's row (the rows K1 does not skip)."""
    c = cxcy2.cpu().numpy().astype(np.float32)  # (B, 2, 2, L)
    r = np.arange(H, dtype=np.float32)[None, None, :]
    s2 = np.float32(sigma) * np.float32(sigma)
    near = np.zeros((B, L, H), bool)
    for k in (0, 1):
        cx, cy = c[:, k, 0], c[:, k, 1]  # (B, L)
        vis = (cx != 0) | (cy != 0)
        d = r - cy[..., None]
        near |= vis[..., None] & (d * d <= s2)
    return near.sum(-1)


def _wrong_k1(name: str, z, cxcy2, w):
    """A wrong K1 forward, emulated from the plain version: ``last_item_dropped``
    leaves out the partial of the plan's last item (the last row of the last
    plane); ``label_rows_skipped`` takes every row for one no disk touches (y
    = 0 everywhere)."""
    import torch

    from tracknetv3_tpu_torch.ops import losses
    from tracknetv3_tpu_torch.ops import wbce_disk as wd

    logits = z.movedim(1, -1)  # (B, H, W, L)
    if name == "label_rows_skipped":
        return losses.wbce_from_logits(logits, torch.zeros_like(logits))
    y = wd.disk_labels_plain(cxcy2, w, H, W)
    part = losses.wbce_from_logits(logits[-1:, -1:, :, -1:], y[-1:, -1:, :, -1:])
    n, n_part = logits.numel(), W
    return (losses.wbce_from_logits(logits, y).double() * n - part.double() * n_part) / n


def _sass_functions(library):
    """{function: [opcode, ...]} of a built library's SASS, each through its
    first unpredicated EXIT (the straight path; subroutines placed after it,
    such as the IEEE division's slow path, are left out). None where
    cuobjdump is missing or fails."""
    text, _ = _sass(library)
    if text is None:
        return None
    funcs, name, done = {}, None, False
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name, done = m.group(1), False
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None and not done:
            funcs[name].append(m.group(2))
            done = m.group(2) == "EXIT" and m.group(1) is None
    return funcs


# SASS opcodes that are not arithmetic the loss needs: register moves (the
# compiler re-materialises constants per element), convergence markers and
# branches, loads, stores, constant and special-register reads. Opcodes of
# the uniform datapath (U...: index and parameter math) are left out too.
NOT_ARITHMETIC = ("MOV", "IMAD.MOV", "MOV32I", "BSSY", "BSYNC", "BRA", "BRX", "CALL", "RET",
                  "EXIT", "WARPSYNC", "NOP", "BAR", "S2R", "CS2R", "S2UR", "R2UR", "LDC", "LDG",
                  "STG", "LDS", "STS", "LD", "ST")


def _arithmetic(op: str) -> bool:
    return not op.startswith("U") and not any(
        op == x or op.startswith(x + ".") for x in NOT_ARITHMETIC)


def _per_element_instructions():
    """SASS instructions per element of K1 (on a label row and on a skipped
    row) and of K2, from the probe kernels of csrc/wbce_disk.cu: the
    arithmetic on each probe's straight path less ``wbce_probe_base``'s (its
    index math), plus 1 (K1's accumulating add, K2's scale). Beside it the
    whole straight path counted the same way (``straight_path``), the
    opcodes left out (``left_out``) and the MUFU among the arithmetic (the
    quarter-rate special-function instructions)."""
    from collections import Counter

    from tracknetv3_tpu_torch.ops import cuda_build, wbce_disk

    funcs = _sass_functions(cuda_build.library_path(wbce_disk.SOURCE))
    if funcs is None:
        return None
    base = funcs.get("wbce_probe_base")
    counts = {}
    for key, probe in (("fwd_label", "wbce_probe_fwd_label"), ("fwd_skip", "wbce_probe_fwd_skip"),
                       ("bwd", "wbce_probe_bwd")):
        ops = funcs.get(probe)
        if ops is None or base is None:
            return None
        arith = Counter(op for op in ops if _arithmetic(op))
        arith.subtract(op for op in base if _arithmetic(op))
        counts[key] = {"arithmetic": sum(arith.values()) + 1,
                       "straight_path": len(ops) - len(base) + 1,
                       "mufu": sum(v for op, v in arith.items() if op.startswith("MUFU")),
                       "arithmetic_opcodes": {op: v for op, v in sorted(arith.items()) if v},
                       "left_out": dict(sorted(Counter(
                           op for op in ops if not _arithmetic(op)).items()))}
    return counts


def _sm_clock_hz():
    """The SM clock's maximum as nvidia-smi reads it (Hz), None if unread."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    try:
        return float(smi.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return None


def issue_bound_ms(instructions: float, sms: int, clock_hz: float) -> float:
    """Instructions (per lane) over the card's issue rate: each SM's 4
    schedulers issue one warp instruction (32 lanes) a cycle."""
    return instructions / (sms * 4 * 32 * clock_hz) * 1e3


def phase_kernels(baseline=None):
    import torch

    from tracknetv3_tpu_torch.ops import wbce_disk as wd

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cxcy = torch.from_numpy(_centers_np(rng)).to(dev)
    perm = torch.from_numpy(rng.permutation(B)).to(dev)
    lam = rng.beta(0.5, 0.5, B)
    lam = torch.from_numpy(np.maximum(lam, 1 - lam).astype(np.float32)).to(dev)
    cases = {
        "plain": wd.pack_plain_targets(cxcy),
        "mixup": wd.pack_mixup_targets(cxcy, perm, lam),
    }
    z_sym = torch.from_numpy(_logits_np(0)).to(dev)  # (B, L, H, W)
    # On logits symmetric about 0 a label pixel's term has the same expectation
    # with y = 1 as with y = 0, so a forward that loses the labels can pass.
    # ``peaked``: the same logits raised by PEAK on the disks, as a trained
    # TrackNet's heatmap peaks on the ball; there the labels move the loss.
    y_mix = wd.disk_labels_plain(*cases["mixup"], H, W).movedim(-1, 1)  # (B, L, H, W)
    z_peak = z_sym + PEAK * (y_mix > 0).float()
    near = ((z_peak.abs() - 16.1181).abs() < 1e-3)  # off the clamp boundary, as _logits_np
    z_peak = torch.where(near, z_peak + 0.01 * z_peak.sign(), z_peak)
    clamp_share = float((z_sym.abs() > 16.2).float().mean())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wd.loss_plan(B, L, H, W, sms)
    err = {"fwd": 0.0, "bwd": 0.0}
    for name, (cxcy2, w), z in (("plain", cases["plain"], z_sym),
                                ("mixup", cases["mixup"], z_sym),
                                ("mixup_peaked", cases["mixup"], z_peak)):
        a = z.movedim(1, -1).detach().requires_grad_()
        loss_k = wd.wbce_disk_loss(a, cxcy2, w)
        loss_k.backward()
        b = z.movedim(1, -1).detach().requires_grad_()
        loss_p = wd.wbce_disk_loss_plain(b, cxcy2, w)
        loss_p.backward()
        centers, wf = wd.flatten_targets(cxcy2, w)
        # three more calls on one input
        repeats = [wd.wbce_disk_forward(z, centers, wf) for _ in range(3)]
        wrong = {k: float(_wrong_k1(k, z, cxcy2, w))
                 for k in ("last_item_dropped", "label_rows_skipped")}
        torch.cuda.synchronize()
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        rel = abs(lk - lp) / abs(lp)
        dz_err = float((a.grad - b.grad).abs().max())
        dz_max = float(b.grad.abs().max())
        bits = [int(t.view(torch.int32)) for t in [loss_k.detach(), *repeats]]
        wrong_rel = {k: abs(v - lp) / abs(lp) for k, v in wrong.items()}
        emit({"phase": "kernel_vs_plain", "targets": name, "loss_kernel": lk,
              "loss_plain": lp, "loss_rel_err": rel, "dz_max_abs_err": dz_err,
              "dz_plain_max": dz_max, "clamped_share": clamp_share,
              "loss_bits_4_calls": bits, "wrong_rel_err": wrong_rel,
              "label_rows": int(_label_rows(cxcy2, wd.SIGMA).sum()), "rows": B * L * H})
        if not (math.isfinite(lk) and rel <= 1e-5):
            fail("kernel_vs_plain", f"{name}: loss {lk} vs plain {lp} (rel {rel})")
        if not dz_err <= 1e-5 * dz_max:
            fail("kernel_vs_plain", f"{name}: dz err {dz_err} > 1e-5 * {dz_max}")
        if len(set(bits)) != 1:
            fail("kernel_vs_plain", f"{name}: K1 gave different bits in four calls: {bits}")
        for k, v in wrong_rel.items():
            if z is z_peak and not v > 1e-5:
                fail("kernel_vs_plain", f"{name}: the wrong forward {k} passes (rel {v})")
        err["fwd"] = max(err["fwd"], abs(lk - lp))
        err["bwd"] = max(err["bwd"], dz_err)

    # Times at the main path's shape, mixup targets. Three copies of the
    # logits (141 MB, past the 50 MB L2) rotate so each call reads cold data.
    cxcy2, w = cases["mixup"]
    centers, wf = wd.flatten_targets(cxcy2, w)
    zs = [z_sym.clone() for _ in range(3)]
    g = torch.ones((), device=dev)
    fwd = lambda i: wd.wbce_disk_forward(zs[i % 3], centers, wf)  # noqa: E731
    bwd = lambda i: wd.wbce_disk_backward(zs[i % 3], centers, wf, g)  # noqa: E731
    earlier = {}
    if baseline is not None:  # the parent's kernels, in turns: old, new, new, old
        old_wd = baseline[1]
        old = {"fwd": lambda i: old_wd.wbce_disk_forward(zs[i % 3], centers, wf),
               "bwd": lambda i: old_wd.wbce_disk_backward(zs[i % 3], centers, wf, g)}
        new = {"fwd": fwd, "bwd": bwd}
        turns = {k: [time_launches(old[k]), time_launches(new[k]), time_launches(new[k]),
                     time_launches(old[k])] for k in ("fwd", "bwd")}
        earlier = {k: statistics.mean(v[0::3]) for k, v in turns.items()}
        host = [host_us_per_call(old["fwd"]), host_us_per_call(fwd), host_us_per_call(fwd),
                host_us_per_call(old["fwd"])]
        emit({"phase": "kernel_times", "what": "turns old, new, new, old (ms); the forward "
              "wrapper's host us per call in the same turns", "turns": turns,
              "fwd_host_us_per_call": host})
    ms = {"fwd": time_launches(fwd), "bwd": time_launches(bwd)}
    with torch.no_grad():
        plain_fwd = time_launches(
            lambda i: wd.wbce_disk_loss_plain(zs[i % 3].movedim(1, -1), cxcy2, w)
        )
    leaves = [t.movedim(1, -1).detach().requires_grad_() for t in zs]
    graphs = [wd.wbce_disk_loss_plain(t, cxcy2, w) for t in leaves]
    plain_bwd = time_launches(
        lambda i: torch.autograd.grad(graphs[i % 3], leaves[i % 3], retain_graph=True)
    )
    del graphs, leaves
    # each input read once, each output written once: logits, centers and
    # weights in; the loss (4 B) out forward; g (4 B) in and dz out backward.
    # Beside the bytes, the instructions this data needs at the card's issue
    # rate: K1 pays the label path only on the rows a disk can touch.
    n = B * L * H * W
    in_bytes = 4 * (n + centers.numel() + wf.numel())
    bytes_ms = {"fwd": bound_ms(in_bytes + 4, 0)[0], "bwd": bound_ms(in_bytes + 4 + 4 * n, 0)[0]}
    per_elem, clock = _per_element_instructions(), _sm_clock_hz()
    issue_ms, label_elems = {}, int(_label_rows(cxcy2, wd.SIGMA).sum()) * W
    if per_elem is not None and clock is not None:
        fwd_instr = (label_elems * per_elem["fwd_label"]["arithmetic"]
                     + (n - label_elems) * per_elem["fwd_skip"]["arithmetic"])
        issue_ms = {"fwd": issue_bound_ms(fwd_instr, sms, clock),
                    "bwd": issue_bound_ms(n * per_elem["bwd"]["arithmetic"], sms, clock)}
    bound = {k: (max(bytes_ms[k], issue_ms.get(k, 0.0)),
                 "operations" if issue_ms.get(k, 0.0) > bytes_ms[k] else "bytes")
             for k in ("fwd", "bwd")}
    emit({"phase": "kernel_times", "shape_BHWL": [B, H, W, L], "kernel_ms": ms,
          "earlier_ms": earlier or "not measured",
          "plain_ms": {"fwd": plain_fwd, "bwd": plain_bwd},
          "bound_ms": {k: v[0] for k, v in bound.items()},
          "bound_by": {k: v[1] for k, v in bound.items()},
          "bytes_bound_ms": bytes_ms, "issue_bound_ms": issue_ms or "not measured",
          "per_element_sass": per_elem or "not measured", "sm_clock_max_hz": clock,
          "label_row_share": label_elems / n, "fwd_device_launches": 1,
          "fwd_plan": {"items": plan.items, "grid": plan.grid}})
    return err, ms, {"fwd": plain_fwd, "bwd": plain_bwd}, bound


# ---------------------------------------------------------------- BatchNorm

# NHWC shape of each BatchNorm + ReLU of the train step at batch 10, and how
# many of its 17 layers have it (down 1 / up 3, down 2 / up 2, down 3 / up 1,
# the bottleneck)
BN_SHAPES = {(B, 288, 512, 64): 4, (B, 144, 256, 128): 4, (B, 72, 128, 256): 6,
             (B, 36, 64, 512): 3}
BN_LAYERS = sum(BN_SHAPES.values())
BN_KERNELS = ("bn_stats", "bn_relu_fwd", "bn_relu_bwd_reduce", "bn_relu_bwd_apply")
# activation elements each kernel reads + writes, and per-channel float32
# vectors (gamma, running stats, st, bias, coefficients, gradients)
BN_TRAFFIC = {"bn_stats": (1, 9), "bn_relu_fwd": (2, 5), "bn_relu_bwd_reduce": (2, 9),
              "bn_relu_bwd_apply": (3, 7)}
# float32 operations per element, counted from csrc/batchnorm.cu
BN_OPS_PER_ELEM = {"bn_stats": 3, "bn_relu_fwd": 4, "bn_relu_bwd_reduce": 10,
                   "bn_relu_bwd_apply": 11}
BN_CONST_CHANNEL = 3  # constant 3.0 with bias 0: var 0 and a ReLU tie
# Statistics against float64 (relative; the mean over |mean| + std): the
# kernel read <= 5.8e-8, float32's own rounding. Kernel vs plain, relative
# L2: the reduce kernel's outputs on equal inputs, and the whole op's output
# and dy, dgamma, dbeta. Both sum every element in double, and read 0 at
# all four shapes in both dtypes; a backward without its variance term read
# 9.3e-3 or more, without its mean term 0.147 or more (PERF.md). The
# bounds sit between.
BN_BOUNDS = {"stats": 1e-6, "out": {"bfloat16": 1e-3, "float32": 1e-5},
             "grad": {"bfloat16": 1e-3, "float32": 1e-5}, "reduce": 1e-5}


def _bn_data(shape, dtype, seed: int, dev):
    """A layer's conv output y (NCHW view of channels_last memory): per
    channel a mean in [-8, 8] and a spread in [0.5, 2], 5% exact zeros and
    one constant channel; an output gradient g with a per-channel offset and
    a per-channel share of y's own standardised value (so both the mean and
    the variance terms of the backward matter); gamma, beta (0 where y is
    constant); running statistics."""
    import torch

    C = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(*size, generator=gen, device=dev)

    z = torch.randn(shape, generator=gen, device=dev)
    y = (z * u(0.5, 2.0, C) + u(-8.0, 8.0, C)).masked_fill(u(0, 1, *shape) < 0.05, 0.0)
    y[..., BN_CONST_CHANNEL] = 3.0
    g = u(-0.5, 0.5, C) + u(-1.0, 1.0, C) * z + torch.randn(shape, generator=gen, device=dev)
    beta = u(-0.5, 0.5, C)
    beta[BN_CONST_CHANNEL] = 0.0
    nchw = lambda t: t.to(dtype).permute(0, 3, 1, 2)  # noqa: E731
    return nchw(y), nchw(g), u(0.5, 1.5, C), beta, u(-1.0, 1.0, C), u(0.5, 2.0, C)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _ulp_diff(a, b):
    """(max distance in units in the last place, count of unequal entries)
    of two tensors of one float dtype."""
    import torch

    ints, mag = {torch.bfloat16: (torch.int16, 0x7FFF), torch.float32: (torch.int32, 0x7FFFFFFF)}[
        a.dtype]

    def line(t):  # sign-magnitude bits -> a monotone integer line
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & mag), i)

    return int((line(a) - line(b)).abs().max()), int((a != b).sum())


def _stats_f64(y):
    """(mean, var) over (N, H, W) in float64, two-pass, no clamp."""
    yd = y.double()
    mean = yd.mean((0, 2, 3))
    return mean, (yd - mean[:, None, None]).square().mean((0, 2, 3))


def _bn_op_vs_plain(bn, y, g, gamma, beta, rm, rv):
    """The op through its Function with the kernels and with the plain
    versions: (out, dy, dgamma, dbeta) of each."""
    res = []
    for ops in (bn.KERNEL_OPS, bn.PLAIN_OPS):
        yy = y.detach().requires_grad_()
        w, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        out = bn.bn_relu(yy, w, b, rm.clone(), rv.clone(), True, ops)
        out.backward(g)
        res.append((out.detach(), yy.grad, w.grad, b.grad))
    return res


def phase_bn():
    """bn_vs_plain: the four BatchNorm kernels vs their plain versions at
    the train step's four shapes, bf16 and float32; times in bf16."""
    import torch

    from tracknetv3_tpu_torch.ops import batchnorm as bn

    dev = torch.device(DEVICE)
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
               "max_abs_err": 0.0, "bound_by": set()} for k in BN_KERNELS}
    worst = {}  # per dtype, over the four shapes
    for dtype, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for i, (shape, layers) in enumerate(BN_SHAPES.items()):
            y, g, gamma, beta, rm, rv = _bn_data(shape, dtype, 10 + i, dev)
            C = shape[-1]
            # statistics and the running update
            rmk, rvk, rmp, rvp = rm.clone(), rv.clone(), rm.clone(), rv.clone()
            st_k = bn.bn_stats(y, gamma, rmk, rvk)
            st_p = bn.bn_stats_plain(y, gamma, rmp, rvp)
            mean64, var64 = _stats_f64(y)
            scale = mean64.abs() + var64.sqrt()
            live = var64 > 0
            stats_err = {}
            for name, st in (("kernel", st_k), ("plain", st_p)):
                stats_err[name] = {
                    "mean": float(((st[0].double() - mean64).abs() / scale).max()),
                    "var": float(((st[1].double() - var64).abs() / var64)[live].max()),
                }
            tie = bool(st_k[1, BN_CONST_CHANNEL] == 0 and st_p[1, BN_CONST_CHANNEL] == 0)
            running = max(_rel_l2(rmk, rmp), _rel_l2(rvk, rvp))
            # each kernel on the plain version's inputs
            fwd_k, fwd_p = bn.bn_relu_fwd(y, st_p, beta), bn.bn_relu_fwd_plain(y, st_p, beta)
            red_k = bn.bn_relu_bwd_reduce(g, y, st_p, beta, True)
            red_p = bn.bn_relu_bwd_reduce_plain(g, y, st_p, beta, True)
            coef = red_p[2]
            dy_k = bn.bn_relu_bwd_apply(g, y, st_p, beta, coef)
            dy_p = bn.bn_relu_bwd_apply_plain(g, y, st_p, beta, coef)
            fwd_ulp, fwd_unequal = _ulp_diff(fwd_k, fwd_p)
            apply_ulp, apply_unequal = _ulp_diff(dy_k, dy_p)
            reduce_err = max(_rel_l2(a, b) for a, b in zip(red_k, red_p))
            # the whole op, and the backward with a term dropped
            (o_k, dy_ok, dw_k, db_k), (o_p, dy_op, dw_p, db_p) = _bn_op_vs_plain(
                bn, y, g, gamma, beta, rm, rv)
            op_ulp, op_unequal = _ulp_diff(o_k, o_p)
            op = {"out": _rel_l2(o_k, o_p), "dy": _rel_l2(dy_ok, dy_op),
                  "dgamma": _rel_l2(dw_k, dw_p), "dbeta": _rel_l2(db_k, db_p)}
            wrong = {}
            for name, row in (("no_mean_term", 0), ("no_variance_term", 1)):
                cut = coef.clone()
                cut[row] = 0.0
                wrong[name] = _rel_l2(bn.bn_relu_bwd_apply_plain(g, y, st_p, beta, cut), dy_p)
            res = {"phase": "bn_vs_plain", "dtype": dname, "shape_NHWC": list(shape),
                   "stats_vs_float64": stats_err, "const_channel_var_zero": tie,
                   "running_rel_l2": running, "fwd_max_ulp": fwd_ulp,
                   "fwd_unequal": fwd_unequal, "reduce_rel_l2": reduce_err,
                   "apply_max_ulp": apply_ulp, "apply_unequal": apply_unequal,
                   "op_rel_l2": op, "op_out_max_ulp": op_ulp, "op_out_unequal": op_unequal,
                   "wrong_backward_dy_rel_l2": wrong}
            if dtype == torch.bfloat16:
                res.update(_bn_times(bn, shape, y, g, gamma, beta, rm, rv, st_p, coef))
                for k in BN_KERNELS:
                    for key in ("ms", "plain_ms", "bound_ms"):
                        out[k][key] += layers * res[key][k]
                    out[k]["bound_by"].add(res["bound_by"][k])
                out["bn_stats"]["library_ms"] = ((out["bn_stats"]["library_ms"] or 0.0)
                                                 + layers * res["library_ms"]["bn_stats"])
                errs = {"bn_stats": float((st_k - st_p).abs().max()),
                        "bn_relu_fwd": float((fwd_k.float() - fwd_p.float()).abs().max()),
                        "bn_relu_bwd_reduce": max(float((a - b).abs().max())
                                                  for a, b in zip(red_k, red_p)),
                        "bn_relu_bwd_apply": float((dy_k.float() - dy_p.float()).abs().max())}
                for k, e in errs.items():
                    out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
            emit(res, detail=True)
            acc = worst.setdefault(dname, {"stats_vs_float64": 0.0, "fwd_unequal": 0,
                                          "apply_unequal": 0, "reduce_rel_l2": 0.0,
                                          "op_rel_l2": 0.0, "min_wrong_dy_rel_l2": math.inf})
            acc["stats_vs_float64"] = max(acc["stats_vs_float64"], *stats_err["kernel"].values())
            acc["fwd_unequal"] += fwd_unequal
            acc["apply_unequal"] += apply_unequal
            acc["reduce_rel_l2"] = max(acc["reduce_rel_l2"], reduce_err)
            acc["op_rel_l2"] = max(acc["op_rel_l2"], *op.values())
            acc["min_wrong_dy_rel_l2"] = min(acc["min_wrong_dy_rel_l2"], *wrong.values())
            bad = []
            if max(stats_err["kernel"].values()) > BN_BOUNDS["stats"]:
                bad.append(f"statistics off float64 by {stats_err['kernel']}")
            if not tie:
                bad.append("the constant channel's variance is not exactly 0")
            if running > BN_BOUNDS["stats"]:
                bad.append(f"running statistics rel {running}")
            if fwd_unequal or apply_unequal:
                bad.append(f"fwd / apply not bit-exact on equal inputs ({fwd_unequal}, "
                           f"{apply_unequal} unequal)")
            if reduce_err > BN_BOUNDS["reduce"]:
                bad.append(f"reduce rel L2 {reduce_err}")
            if op["out"] > BN_BOUNDS["out"][dname]:
                bad.append(f"op output rel L2 {op['out']}")
            grad_bound = BN_BOUNDS["grad"][dname]
            if max(op[k] for k in ("dy", "dgamma", "dbeta")) > grad_bound:
                bad.append(f"op gradients {op}")
            if min(wrong.values()) <= grad_bound:
                bad.append(f"a wrong backward passes the dy bound {grad_bound}: {wrong}")
            if bad:
                fail("bn_vs_plain", f"{dname} {shape}: " + "; ".join(bad))
            del y, g, st_k, st_p, fwd_k, fwd_p, red_k, red_p, dy_k, dy_p, o_k, o_p, dy_ok, dy_op
            torch.cuda.empty_cache()
    for v in out.values():
        v["bound_by"] = "/".join(sorted(v["bound_by"]))
    emit({"phase": "bn_vs_plain", "shapes_NHWC": [list(sh) for sh in BN_SHAPES],
          "worst_over_shapes": worst, "bounds": BN_BOUNDS,
          "bf16_ms_per_train_step": {k: {key: v[key] for key in
                                         ("ms", "plain_ms", "bound_ms", "library_ms")}
                                     for k, v in out.items()}})
    return out


def _bn_times(bn, shape, y, g, gamma, beta, rm, rv, st, coef):
    """Median times of each kernel, its plain version and (for the
    statistics) ``torch.var_mean`` at one shape; three copies of y and g
    rotate so each call reads cold data, as the step does."""
    import torch

    ys = [y] + [y.clone(memory_format=torch.channels_last) for _ in range(2)]
    gs = [g] + [g.clone(memory_format=torch.channels_last) for _ in range(2)]
    rm, rv = rm.clone(), rv.clone()
    calls = {
        "bn_stats": (lambda f: lambda i: f(ys[i % 3], gamma, rm, rv),
                     bn.bn_stats, bn.bn_stats_plain),
        "bn_relu_fwd": (lambda f: lambda i: f(ys[i % 3], st, beta),
                        bn.bn_relu_fwd, bn.bn_relu_fwd_plain),
        "bn_relu_bwd_reduce": (lambda f: lambda i: f(gs[i % 3], ys[i % 3], st, beta, True),
                               bn.bn_relu_bwd_reduce, bn.bn_relu_bwd_reduce_plain),
        "bn_relu_bwd_apply": (lambda f: lambda i: f(gs[i % 3], ys[i % 3], st, beta, coef),
                              bn.bn_relu_bwd_apply, bn.bn_relu_bwd_apply_plain),
    }
    n_elem = math.prod(shape)
    C = shape[-1]
    res = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}, "library_ms": {}}
    for k, (call, kern, plain) in calls.items():
        res["ms"][k] = time_launches(call(kern))
        res["plain_ms"][k] = time_launches(call(plain), n=10, windows=3)
        elems, vecs = BN_TRAFFIC[k]
        res["bound_ms"][k], res["bound_by"][k] = bound_ms(
            elems * n_elem * y.element_size() + vecs * 4 * C, n_elem * BN_OPS_PER_ELEM[k])
        res["library_ms"][k] = None
    res["library_ms"]["bn_stats"] = time_launches(
        lambda i: torch.var_mean(ys[i % 3], dim=(0, 2, 3), unbiased=False))
    return res


def _write_npz(path: str, **arrays) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` (h, w, 3), written with zlib and struct."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _draw_rally(rng, T: int, occluded: bool):
    """A rally's (T, H, W, 3) uint8 frames (a seeded textured background, a
    bright disk of radius 4 on a parabolic arc, one 40-frame pass after
    another) and its label rows (frame, visibility, x, y); with ``occluded``
    the disk is hidden on frames 12-15 of each pass."""
    yy, xx = np.mgrid[0:H, 0:W]
    bg = np.full((H, W, 3), (40, 90, 40), np.int32)
    bg = (bg + rng.integers(0, 40, (H, W, 3))).astype(np.uint8)
    frames = np.repeat(bg[None], T, axis=0)
    rows = []
    for t in range(T):
        u = (t % 40) / 39
        visible = not (occluded and 12 <= t % 40 < 16)
        x = int(W * 0.1 + W * 0.8 * u)
        y = int(H * 0.7 - H * 0.5 * math.sin(math.pi * u))
        if visible:
            frames[t][(yy - y) ** 2 + (xx - x) ** 2 <= 16] = 255
        rows.append((t, int(visible), x if visible else 0, y if visible else 0))
    return frames, rows


RALLY_T = 200  # frames of each rally of the synthetic test split
RALLY_BATCH = 16  # the test CLI's default batch
RALLY_DROP = 8  # frames left out at each end of a test rally (drop_frame.json)


def write_synthetic_dataset(root: str, seed: int = 0) -> None:
    """Shuttlecock-layout dataset at 288x512 with numpy only: seeded
    textured backgrounds, a moving bright disk, label CSVs, and the
    loader's npz caches (so no PNG is decoded). Train: 2 matches x 2
    rallies x 40 frames; val: 1 match x 2 rallies x 40 frames; test: 1 match
    x 2 rallies x ``RALLY_T`` frames with ``corrected_csv`` labels and a
    ``drop_frame.json`` window. Each rally's first frame is also written as
    ``0.png`` (the evaluation reads the source size from it). Each train and
    val rally also gets the InpaintNet data, ``predicted_csv/{rally}_ball.csv``:
    the label with a TrackNet-like prediction beside it (seeded noise of a
    few pixels, dropped detections) and an ``Inpaint_Mask`` over the gaps,
    drawn from a generator of its own (the frames do not change with it)."""
    from tracknetv3_tpu_torch.data.dataset import _slide_windows

    rng = np.random.default_rng(seed)
    pred_rng = np.random.default_rng([seed, 1])
    T = 40
    for split, matches, step in (("train", (1, 2), 1), ("val", (1,), L)):
        parts = []
        rally_i = 0
        for m in matches:
            match_dir = os.path.join(root, split, f"match{m}")
            os.makedirs(os.path.join(match_dir, "csv"), exist_ok=True)
            for r in (1, 2):
                rally = f"1_{r:02d}_00"
                frame_dir = os.path.join(match_dir, "frame", rally)
                os.makedirs(frame_dir, exist_ok=True)
                frames, rows = _draw_rally(rng, T, occluded=r == 1)
                with open(os.path.join(match_dir, "csv", f"{rally}_ball.csv"), "w",
                          newline="") as f:
                    wr = csv.writer(f)
                    wr.writerow(["Frame", "Visibility", "X", "Y"])
                    wr.writerows(rows)
                _write_predicted_csv(match_dir, rally, rows, pred_rng)
                median = np.median(frames, axis=0).astype(np.uint8)
                _write_npz(os.path.join(frame_dir, f"cache_{H}x{W}_concat.npz"),
                           rgb=frames, median_resized=median)
                _write_png(os.path.join(frame_dir, "0.png"), frames[0])
                lab = np.asarray(rows, np.float32)
                win = np.asarray(_slide_windows(T, L, step, False))
                parts.append({
                    "id": np.stack([np.full_like(win, rally_i), win], -1).astype(np.int32),
                    "frame_id": lab[win, 0].astype(np.int64),
                    "coor": np.stack([lab[win, 2], lab[win, 3]], -1),
                    "vis": lab[win, 1],
                })
                rally_i += 1
        n_rally = rally_i
        _write_npz(os.path.join(root, f"img_config_{H}x{W}_{split}.npz"),
                   img_shape=np.tile(np.asarray([[W, H]], np.float64), (n_rally, 1)),
                   img_scaler=np.ones((n_rally, 2), np.float64))
        _write_npz(os.path.join(root, f"data_l{L}_s{step}_heatmap_{split}.npz"),
                   **{k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    match_dir = os.path.join(root, "test", "match1")
    os.makedirs(os.path.join(match_dir, "corrected_csv"), exist_ok=True)
    drop = {"start": {}, "end": {}}
    for r in (1, 2):
        rally = f"1_{r:02d}_00"
        frame_dir = os.path.join(match_dir, "frame", rally)
        os.makedirs(frame_dir, exist_ok=True)
        frames, rows = _draw_rally(rng, RALLY_T, occluded=r == 1)
        with open(os.path.join(match_dir, "corrected_csv", f"{rally}_ball.csv"), "w",
                  newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["Frame", "Visibility", "X", "Y"])
            wr.writerows(rows)
        _write_npz(os.path.join(frame_dir, f"cache_{H}x{W}_concat.npz"), rgb=frames,
                   median_resized=np.median(frames, axis=0).astype(np.uint8))
        _write_png(os.path.join(frame_dir, "0.png"), frames[0])
        drop["start"][f"1_{rally}"] = RALLY_DROP
        drop["end"][f"1_{rally}"] = RALLY_T - RALLY_DROP
    with open(os.path.join(root, "drop_frame.json"), "w") as f:
        json.dump(drop, f)


def _write_predicted_csv(match_dir: str, rally: str, rows, rng) -> None:
    """``predicted_csv/{rally}_ball.csv`` from a rally's label rows (t,
    visibility, x, y): the prediction misses a visible frame with
    probability 0.15 and is off by a normal 2 px elsewhere; a missed visible
    frame is masked for inpainting."""
    out = []
    for t, vis, x, y in rows:
        hit = vis and rng.random() >= 0.15
        px, py = ((int(round(x + rng.normal(0, 2))), int(round(y + rng.normal(0, 2))))
                  if hit else (0, 0))
        out.append((t, vis, x, y, int(hit), px, py, int(vis and not hit)))
    os.makedirs(os.path.join(match_dir, "predicted_csv"), exist_ok=True)
    with open(os.path.join(match_dir, "predicted_csv", f"{rally}_ball.csv"), "w",
              newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["Frame", "Visibility_GT", "X_GT", "Y_GT", "Visibility", "X", "Y",
                     "Inpaint_Mask"])
        wr.writerows(out)


def phase_slice(tmp: str):
    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index
    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

    data_dir = os.path.join(tmp, "data")
    save_dir = os.path.join(tmp, "exp")
    t0 = time.time()
    write_synthetic_dataset(data_dir)
    data_s = time.time() - t0
    common = ["--seq_len", str(L), "--bg_mode", "concat", "--alpha", "0.5",
              "--batch_size", str(B), "--data_dir", data_dir, "--save_dir", save_dir]

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()  # counts of the main path only
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):  # the CLI's own lines
        out1 = train_cli.main(common + ["--epochs", "1"])
        out2 = train_cli.main(common + ["--epochs", "2", "--resume_training"])
    torch.cuda.synchronize()
    launches = _launches(wd)
    bn_launches = _launches(bn)
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()

    steps = out2["step"]
    hist = out1["history"] + out2["history"]
    losses = [v for h in hist for v in (h["train_loss"], h["val_loss"])]
    reloaded = [load_model_from_checkpoint(os.path.join(save_dir, f"TrackNet_{k}.pt"))[1]
                for k in ("best", "cur")]
    # 17 BatchNorm layers: each kernel once per layer per train step, and
    # the normalise once per layer per eval batch (one validation an epoch)
    eval_batches = len(hist) * len(HeatmapBatchLoader(
        build_split_index(data_dir, "val", L, L), "concat", B, data_dir=data_dir))
    want_bn = {k: BN_LAYERS * steps if k in BN_KERNELS else 0 for k in bn.KERNELS}
    want_bn["bn_relu_fwd"] += BN_LAYERS * eval_batches
    emit({"phase": "slice", "train_steps": steps, "eval_batches": eval_batches,
          "launches": launches, "bn_launches": bn_launches,
          "epochs": [h["epoch"] for h in hist], "losses": losses,
          "val_res": hist[-1]["val_res"], "dataset_s": data_s, "train_s": train_s,
          "peak_mem_bytes": peak})
    if not steps or launches != {"wbce_disk_fwd": steps, "wbce_disk_bwd": steps}:
        fail("slice", f"launches {launches} != {steps} train steps")
    if bn_launches != want_bn:
        fail("slice", f"BatchNorm launches {bn_launches} != {want_bn} ({steps} train steps, "
             f"{eval_batches} eval batches, {BN_LAYERS} layers)")
    if [h["epoch"] for h in hist] != [0, 1]:
        fail("slice", "resume did not continue at epoch 2")
    if not all(math.isfinite(v) for v in losses):
        fail("slice", f"non-finite loss in {losses}")
    if any(pd.get("seq_len") != L for pd in reloaded):
        fail("slice", "checkpoint did not reload")
    if "accuracy" not in hist[-1]["val_res"]:
        fail("slice", "no val metrics")

    # Step time and peak memory of the full-width step on a fixed batch,
    # after warm-up, BatchNorm on the kernels.
    model = out2["model"]
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_train_steps(model, data_dir)
    step_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "step_time", "config": "TrackNet seq_len 8 concat 288x512 batch 10 "
          "alpha 0.5 Adam bf16", "median_ms_per_step": statistics.median(step_ms),
          "ms_per_step": step_ms, "step_peak_mem_bytes": step_peak,
          "train_run_peak_mem_bytes": peak})
    return launches, bn_launches, statistics.median(step_ms), peak, model


def _first_batch(data_dir: str, dev):
    import torch

    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index

    index = build_split_index(data_dir, "train", L, 1)
    batch = next(iter(HeatmapBatchLoader(index, "concat", B, shuffle=True, seed=3,
                                         data_dir=data_dir)))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _time_train_steps(model, data_dir: str, n: int = 12):
    import torch

    return _time_steps(model, _first_batch(data_dir, torch.device("cuda")), 0.5, n)[0]


# (loss relative error, worst relative L2 error of a parameter gradient) of
# one train step against the same step with one part swapped. float32: the
# kernel loss vs the plain loss (read 0 and 1.8e-5), and the BatchNorm
# kernels vs their plain versions (read 0 and 0). bfloat16, BatchNorm
# kernels vs plain: read 0 and 0, while the wrong backwards read a
# gradient error of 1.0 or more (PERF.md); each must fail the bound.
STEP_PARITY_BOUNDS = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 1e-2)}


def _step(base, dtype, x, targets, loss_fn, bn_op):
    """Loss and parameter gradients of one train step of a copy of ``base``
    in working dtype ``dtype``, BatchNorm through ``bn_op``."""
    import torch

    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.training.steps import _to_model_input

    model = copy.deepcopy(base).to(DEVICE, memory_format=torch.channels_last).train()
    model.dtype = dtype
    with mock.patch.object(bn, "bn_relu_train", bn_op):
        loss = loss_fn(model(_to_model_input(x)).movedim(1, -1), *targets)
        loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _wrong_bn(row: int):
    """``bn_relu_train`` whose (plain) backward drops its mean term (row 0
    of the coefficients) or its variance term (row 1)."""
    from tracknetv3_tpu_torch.ops import batchnorm as bn

    def apply(g, y, st, bias, coef):
        cut = coef.clone()
        cut[row] = 0.0
        return bn.bn_relu_bwd_apply_plain(g, y, st, bias, cut)

    ops = bn.PLAIN_OPS._replace(bwd_apply=apply)
    return lambda *args: bn.bn_relu(*args, True, ops)


def phase_step_parity(data_dir: str):
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.steps import (
        assemble_tracknet_inputs,
        sample_mixup_inputs,
        sample_mixup_params,
    )

    dev = torch.device("cuda")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    # no autotuning: it tried every float32 algorithm of every layer, 2.5 min
    torch.backends.cudnn.benchmark = False
    kernel_loss, plain_loss = wd.wbce_disk_loss, wd.wbce_disk_loss_plain
    runs = {
        "float32": {"kernel": (kernel_loss, bn.bn_relu_train),
                    "plain_loss": (plain_loss, bn.bn_relu_train),
                    "plain_bn": (kernel_loss, bn.bn_relu_train_plain)},
        "bfloat16": {"kernel": (kernel_loss, bn.bn_relu_train),
                     "plain_bn": (kernel_loss, bn.bn_relu_train_plain),
                     "no_mean_term": (kernel_loss, _wrong_bn(0)),
                     "no_variance_term": (kernel_loss, _wrong_bn(1))},
    }
    try:
        batch = _first_batch(data_dir, dev)
        perm, lam = (torch.from_numpy(a).to(dev)
                     for a in sample_mixup_params(np.random.default_rng(7), B, 0.5))
        x = sample_mixup_inputs(assemble_tracknet_inputs(batch, "concat"), perm, lam)
        targets = wd.pack_mixup_targets(batch["cxcy"], perm, lam)
        base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(11),
                         dtype=torch.float32)
        for dname, variants in runs.items():
            out = {name: _step(base, getattr(torch, dname), x, targets, loss_fn, op)
                   for name, (loss_fn, op) in variants.items()}
            lk, gk = out.pop("kernel")
            loss_bound, grad_bound = STEP_PARITY_BOUNDS[dname]
            res = {}
            for name, (lv, gv) in out.items():
                grad_rel = {k: _rel_l2(gk[k], gv[k]) for k in gv}
                worst = max(grad_rel, key=grad_rel.get)
                res[name] = {"loss": lv, "loss_rel_err": abs(lk - lv) / abs(lv),
                             "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_worst_param": worst}
                res[name]["within_bounds"] = (res[name]["loss_rel_err"] <= loss_bound
                                              and grad_rel[worst] <= grad_bound)
            emit({"phase": "step_parity", "dtype": dname, "tf32": False, "loss_kernel": lk,
                  "loss_bound": loss_bound, "grad_bound": grad_bound, "vs": res})
            for name, r in res.items():
                if r["within_bounds"] == name.startswith("no_"):
                    fail("step_parity", f"{dname} vs {name}: {r} (bounds {loss_bound}, "
                         f"{grad_bound}; a wrong backward must fail them)")
            del out
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


# ---------------------------------------------------------------- InpaintNet training

INPAINT_SEQ, INPAINT_BATCH = 16, 32  # the README's InpaintNet configuration


def _kernel_modules():
    """The modules of the hand kernels, each with its ``KERNELS`` (launch counters)."""
    from tracknetv3_tpu_torch.ops import batchnorm, conv3x3, pool_up2x, shift_copy, wbce_disk

    return batchnorm, conv3x3, pool_up2x, shift_copy, wbce_disk


def phase_inpaint(tmp: str, card: str):
    """inpaint_train: InpaintNet at the README configuration (seq_len 16,
    StepLR, mask_ratio 0.3, batch 32, Adam 1e-3 clipped to 1.0, float32 with
    TF32 off) through the train CLI for 2 epochs on the card, resumed for a
    third, then eval_inpaintnet on the val split with the trained model; one
    card step held to the same step on the CPU (same init, batch and mask):
    loss, every gradient and the parameters as one vector within relative L2
    1e-5, each parameter's reading printed; ms per step (median of 20 after 5
    warm-up steps, host clock around synchronize) and peak memory."""
    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.data.dataset import CoordinateBatchLoader, build_split_index
    from tracknetv3_tpu_torch.evaluation.loops import eval_inpaintnet
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training import optim, steps
    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint
    from tracknetv3_tpu_torch.training.loop import _COORDINATE_KEYS, prefetch_to_device

    data_dir = os.path.join(tmp, "data")
    if not os.path.isdir(data_dir):
        write_synthetic_dataset(data_dir)
    save_dir = os.path.join(tmp, "inpaint_exp")
    dev = torch.device(DEVICE)
    common = ["--model_name", "InpaintNet", "--seq_len", str(INPAINT_SEQ), "--lr_scheduler",
              "StepLR", "--mask_ratio", "0.3", "--batch_size", str(INPAINT_BATCH),
              "--data_dir", data_dir, "--save_dir", save_dir]
    _zero_launches()  # no hand kernel is on this path
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):  # the CLI's own lines
        out1 = train_cli.main(common + ["--epochs", "2"])
        out2 = train_cli.main(common + ["--epochs", "3", "--resume_training"])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {m.__name__.rsplit(".", 1)[-1]: _launches(m) for m in _kernel_modules()}
    hist = out1["history"] + out2["history"]
    losses = [v for h in hist for v in (h["train_loss"], h["val_loss"])]
    reloaded = [load_model_from_checkpoint(os.path.join(save_dir, f"InpaintNet_{k}.pt"))[1]
                for k in ("best", "cur")]

    # the eval, with the trained model, on the val split
    val_index = build_split_index(data_dir, "val", INPAINT_SEQ, INPAINT_SEQ, "coordinate")
    val_loss, val_res = eval_inpaintnet(
        steps.make_inpaintnet_eval_step(out2["model"]),
        prefetch_to_device(CoordinateBatchLoader(val_index, INPAINT_BATCH), dev,
                           keys=_COORDINATE_KEYS),
        input_hw=val_index.input_hw)

    # one step on the card against the same step on the CPU
    index = build_split_index(data_dir, "train", INPAINT_SEQ, 1, "coordinate")
    loader = CoordinateBatchLoader(index, INPAINT_BATCH, shuffle=True, drop_last=True, seed=13)
    batch = next(iter(loader))
    mask = steps.sample_inpaint_mask(np.random.default_rng([13, 0]), batch["vis"].shape, 0.3)
    init = get_model("InpaintNet", generator=torch.Generator().manual_seed(13))

    def one_step(device):
        model = copy.deepcopy(init).to(device)
        opt, sched = optim.build_optimizer("Adam", model.parameters(), 1e-3, "StepLR",
                                           epochs=3, steps_per_epoch=len(loader), clip_norm=1.0)
        step = steps.make_inpaintnet_train_step(model, opt, sched)
        tb = {k: torch.from_numpy(batch[k]).to(device) for k in _COORDINATE_KEYS}
        loss = float(step(tb, 0, torch.from_numpy(mask).to(device)))
        return (loss, {n: p.detach().double().cpu() for n, p in model.named_parameters()},
                {n: p.grad.double().cpu() for n, p in model.named_parameters()}, model, opt,
                step, tb)

    got_loss, got_p, got_g, model, _, step, tb = one_step(dev)
    want_loss, want_p, want_g = one_step(torch.device("cpu"))[:3]
    param_rel = {n: _rel_l2(got_p[n], want_p[n]) for n in want_p}
    grad_rel = {n: _rel_l2(got_g[n], want_g[n]) for n in want_g}
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    all_rel = _rel_l2(torch.cat([got_p[n].reshape(-1) for n in want_p]),
                      torch.cat([want_p[n].reshape(-1) for n in want_p]))

    # ms per step on a fixed batch and mask, and the peak memory
    dmask = torch.from_numpy(mask).to(dev)
    for i in range(5):
        step(tb, i, dmask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(20):
        t1 = time.perf_counter()
        step(tb, 5 + i, dmask)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del model, step, tb

    emit({"phase": "inpaint_train", "card": card,
          "config": "InpaintNet seq_len 16 StepLR mask_ratio 0.3 batch 32 Adam 1e-3 clip 1.0 "
                    "float32 TF32 off", "train_steps": out2["step"],
          "epochs": [h["epoch"] for h in hist], "losses": losses, "train_s": train_s,
          "val_res": {k: v["accuracy"] for k, v in hist[-1]["val_res"].items()},
          "eval_loss": val_loss, "eval_accuracy": {k: v["accuracy"] for k, v in val_res.items()},
          "hand_kernel_launches": launches,
          "card_vs_cpu": {"loss_rel": loss_rel, "max_grad_rel_l2": max(grad_rel.values()),
                          "params_rel_l2": all_rel, "param_rel_l2": param_rel},
          "median_ms_per_step": statistics.median(ms), "ms_per_step": ms,
          "peak_mem_bytes": peak})
    if [h["epoch"] for h in hist] != [0, 1, 2]:
        fail("inpaint_train", "resume did not continue at epoch 3")
    if not all(math.isfinite(v) for v in losses + [val_loss]):
        fail("inpaint_train", f"non-finite loss in {losses}, eval {val_loss}")
    if any(pd.get("model_name") != "InpaintNet" for pd in reloaded):
        fail("inpaint_train", "checkpoint did not reload as InpaintNet")
    if sorted(val_res) != ["baseline", "inpaint", "reconstruct"]:
        fail("inpaint_train", f"eval gave {sorted(val_res)}")
    if any(n for m in launches.values() for n in m.values()):
        fail("inpaint_train", f"a hand kernel launched on a path that has none: {launches}")
    bad = {n: r for n, r in grad_rel.items() if r > 1e-5}
    if loss_rel > 1e-5 or bad or all_rel > 1e-5:
        fail("inpaint_train", f"card step vs CPU step: loss {loss_rel}, gradients over 1e-5 "
             f"{bad}, parameters {all_rel}")


# ---------------------------------------------------------------- copy kernels

PROBE_TILE = 8  # the halo / shift probes' row tile: windows start at rows 0, 8, 16, 24
SEG_WINDOWS = 5  # windows per segment of the segmented runs: 2 segments of 12 frames a batch
COPY_KERNELS = ("window_copy", "repeat_rows", "roll_cols")


def _bits_data(shape, dtype, seed: int, dev):
    """uint8: uniform bytes. bfloat16 / float32: unit normals with 1% of the
    words replaced by random bit patterns (NaNs with payloads, infinities,
    denormals) and -0.0, +inf and two NaNs of different payloads set."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    ints, bits = {torch.bfloat16: (torch.int16, 16), torch.float32: (torch.int32, 32)}[dtype]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    words = x.view(ints).view(-1)  # shares x's memory
    idx = torch.randint(0, words.numel(), (words.numel() // 100,), generator=g, device=dev)
    lo = -(2 ** (bits - 1))
    words[idx] = torch.randint(lo, -lo, (idx.numel(),), generator=g, device=dev).to(ints)
    for i, v in enumerate((0x8000, 0x7F80, 0x7FC1, 0xFF83)):
        v <<= bits - 16
        words[7 * i + 1] = v - 2 ** bits if v >= -lo else v
    return x


def _words(t):
    import torch

    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _unequal_words(a, b) -> int:
    """Elements of ``a`` whose bits differ from ``b``'s (-1: shape or dtype)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    return int((_words(a) != _words(b)).sum())


def _window_rows(starts, rows: int):
    """(n, rows) int64 row indices of the windows: what one indexing call takes."""
    import torch

    return starts.long()[:, None] + torch.arange(rows, device=starts.device)[None, :]


def _off_by_one(starts, rows: int, n_rows: int):
    return (starts + 1).clamp(max=n_rows - rows)


def _copy_cases(dev, sc=None):
    """The seven probes at the probe's shapes and the train path's copies at
    the README configuration's. Each case: the kernel's call, its plain
    version, one PyTorch call that computes the same (``library``), a wrong
    version that must differ, on an input made by ``make(seed)``; ``needed``
    counts the elements the call must read (for a gather: its distinct rows).
    ``sc``: the copy module whose kernels the cases call (this tree's by
    default)."""
    import torch

    if sc is None:
        from tracknetv3_tpu_torch.ops import shift_copy as sc

    bf16, f32, u8 = torch.bfloat16, torch.float32, torch.uint8
    Hp, Wp, Cp = 32, 256, 128  # the probes' tile
    tile = torch.arange(0, Hp, PROBE_TILE, dtype=torch.int32, device=dev)
    cases = []

    def add(name, kernel, probe, shape, dtype, call, plain, library, lib_name, wrong, wrong_name,
            needed=None):
        cases.append(dict(name=name, kernel=kernel, probe=probe, shape=shape, dtype=dtype,
                          call=call, plain=plain, library=library, library_name=lib_name,
                          wrong=wrong, wrong_name=wrong_name, needed=needed))

    def window_case(name, probe, shape, dtype, starts, rows, lib, lib_name, wrong=None,
                    wrong_name="a start off by one", flat=None, **kw):
        """``window_copy`` on ``flat(x)`` (x viewed as rows of the source)."""
        flat = flat or (lambda x: x)
        fshape = tuple(flat(torch.empty(shape, device="meta")).shape)
        n_rows = fshape[0]
        plain_kw = {k: v for k, v in kw.items() if k != "staged"}
        # the distinct source rows, and of each the columns and channels copied
        needed = (torch.unique(_window_rows(starts, rows)).numel() * math.prod(fshape[1:-2])
                  * kw.get("cols", fshape[-2]) * kw.get("chs", fshape[-1]))
        add(name, "window_copy", probe, shape, dtype,
            lambda x: sc.window_copy(flat(x), starts, rows, **kw),
            lambda x: sc.window_copy_plain(flat(x), starts, rows, **plain_kw),
            lib, lib_name,
            wrong or (lambda x: sc.window_copy_plain(
                flat(x), _off_by_one(starts, rows, n_rows), rows, **plain_kw)),
            wrong_name, needed)

    # ---- the probes (tools/probe_mosaic_caps.py)
    xs = (Hp, Wp + 8, Cp)
    tiled = lambda t: t.reshape((Hp // PROBE_TILE, PROBE_TILE) + tuple(t.shape[1:]))  # noqa: E731
    window_case("U1", "U1 leading-slice DMA", xs, bf16, tile, PROBE_TILE,
                lambda x: tiled(x.clone()), "clone")
    shifted = lambda x: tiled(x.narrow(1, 1, Wp).contiguous())  # noqa: E731
    window_case("U2", "U2 sublane-offset-1 DMA", xs, bf16, tile, PROBE_TILE, shifted,
                "narrow().contiguous()", col0=1, cols=Wp)
    window_case("U3", "U3 in-kernel sublane-offset slice", xs, bf16, tile, PROBE_TILE, shifted,
                "narrow().contiguous()",
                wrong=lambda x: sc.window_copy_plain(x, tile, PROBE_TILE, col0=0, cols=Wp),
                wrong_name="the unshifted tile", col0=1, cols=Wp, staged=True)
    upper = lambda x: tiled(x.narrow(2, 128, 128).contiguous())  # noqa: E731
    for name, staged in (("U4", True), ("U4_direct", False)):
        window_case(name, "U4 in-kernel lane-slice aligned", (Hp, Wp, 256), bf16, tile,
                    PROBE_TILE, upper, "narrow().contiguous()",
                    wrong=lambda x: sc.window_copy_plain(x, tile, PROBE_TILE, ch0=0, chs=128),
                    wrong_name="the lower channels", ch0=128, chs=128, staged=staged)
    add("U5", "repeat_rows", "U5 pltpu.repeat sublane x2", (Hp, Wp, Cp), bf16,
        lambda x: sc.repeat_rows(x, 2), lambda x: sc.repeat_rows_plain(x, 2),
        lambda x: x.repeat_interleave(2, dim=0), "repeat_interleave",
        lambda x: tiled(x).repeat(1, 2, 1, 1).reshape((2 * Hp, Wp, Cp)),
        "the tiled repeat of each 8-row tile")
    for name, dtype in (("U6", f32), ("U6_bf16", bf16)):
        add(name, "roll_cols", "U6 f32 sublane roll", (Hp, Wp, Cp), dtype,
            lambda x: sc.roll_cols(x, 1), lambda x: sc.roll_cols_plain(x, 1),
            lambda x: torch.roll(x, 1, dims=-2), "torch.roll",
            lambda x: torch.roll(x, -1, dims=-2), "a roll the other way")
    window_case("U7", "U7 rank4 sublane-offset DMA", (2,) + xs, bf16, tile, PROBE_TILE,
                lambda x: tiled(x[0].narrow(1, 1, Wp).contiguous()), "narrow().contiguous()",
                flat=lambda x: x.reshape((2 * Hp,) + xs[1:]), col0=1, cols=Wp)

    # ---- the train path (training/steps.assemble_tracknet_inputs), README configuration
    rng = np.random.default_rng(31)
    frame = (H, W, 3)
    span = SEG_WINDOWS + L - 1
    n_seg = B // SEG_WINDOWS
    seg_starts = (torch.arange(n_seg, device=dev)[:, None] * span
                  + torch.arange(SEG_WINDOWS, device=dev)[None, :]).reshape(-1)
    flat_segs = lambda x: x.reshape((n_seg * span,) + frame)  # noqa: E731
    seg_rows = _window_rows(seg_starts, L)
    window_case("segment_expand", None, (n_seg, span) + frame, u8, seg_starts, L,
                lambda x: flat_segs(x)[seg_rows], "advanced indexing", flat=flat_segs)
    def repeat_case(name, shape, k, wrong, wrong_name):
        add(name, "repeat_rows", None, shape, u8,
            lambda x: sc.repeat_rows(x, k), lambda x: sc.repeat_rows_plain(x, k),
            lambda x: x.repeat_interleave(k, dim=0), "repeat_interleave", wrong, wrong_name)

    tiled_repeat = lambda x: x.repeat(SEG_WINDOWS, 1, 1, 1)  # noqa: E731
    repeat_case("median_repeat", (n_seg,) + frame, SEG_WINDOWS, tiled_repeat, "the tiled repeat")
    # k = 1 (a plain copy of the rows), and a row of an odd byte count
    # (287 x 511 x 3), which takes 1-byte vectors
    repeat_case("repeat_k1", (n_seg,) + frame, 1, lambda x: x.roll(1, 0), "the rows rolled by one")
    repeat_case("repeat_odd_row", (n_seg, H - 1, W - 1, 3), SEG_WINDOWS, tiled_repeat,
                "the tiled repeat")
    n_res = 160  # frames of the synthetic train split: 2 matches x 2 rallies x 40
    res_idx = torch.from_numpy(rng.integers(0, n_res, B * L).astype(np.int32)).to(dev)
    window_case("resident_gather", None, (n_res,) + frame, u8, res_idx, 1,
                lambda x: torch.index_select(x, 0, res_idx)[:, None], "index_select")
    med_idx = torch.from_numpy(rng.integers(0, 4, B).astype(np.int32)).to(dev)
    window_case("resident_median_gather", None, (4,) + frame, f32, med_idx, 1,
                lambda x: torch.index_select(x, 0, med_idx)[:, None], "index_select")
    # the rally evaluation's window gather: one chunk of 16 windows from a
    # staged 200-frame rally (padded with L-1 repeats of its last frame)
    rally_starts = torch.arange(32, 32 + RALLY_BATCH, dtype=torch.int32, device=dev)
    rally_rows = _window_rows(rally_starts, L)
    window_case("rally_gather", None, (RALLY_T + L - 1,) + frame, u8, rally_starts, L,
                lambda x: torch.index_select(x, 0, rally_rows.reshape(-1)).reshape(
                    (RALLY_BATCH, L) + frame), "index_select")
    pair = torch.from_numpy(rng.integers(0, L, (B, L, 2))).to(dev)
    flat_win = lambda x: x.reshape((B * L,) + frame)  # noqa: E731
    for k in (0, 1):
        starts = (torch.arange(B, device=dev)[:, None] * L + pair[..., k]).reshape(-1)
        window_case(f"blend_gather_{'ab'[k]}", None, (B, L) + frame, u8, starts, 1,
                    lambda x, starts=starts: torch.index_select(flat_win(x), 0, starts)[:, None],
                    "index_select", flat=flat_win)
    return cases


def phase_copy(baseline=None):
    """copy_vs_plain: the three copy kernels against their plain versions,
    bit for bit, at the probes' shapes and the train path's; wrong versions
    must differ; times beside the bytes bound and one PyTorch call. With
    ``baseline`` (another tree's ops modules), that tree's kernels too, bit
    for bit, and the two timed in turns: old, new, new, old."""
    import torch

    from tracknetv3_tpu_torch.ops import shift_copy as sc
    from tracknetv3_tpu_torch.training import steps

    dev = torch.device(DEVICE)
    rows = {}
    old_cases = _copy_cases(dev, baseline[0]) if baseline is not None else None
    for i, c in enumerate(_copy_cases(dev)):
        xs = [_bits_data(c["shape"], c["dtype"], 200 + 3 * i + k, dev) for k in range(3)]
        sc.LAST_PLAN = None
        got = c["call"](xs[0])
        plan = sc.LAST_PLAN  # the plan window_copy launched (None for the other kernels)
        want, lib, wrong = (c[f](xs[0]) for f in ("plain", "library", "wrong"))
        torch.cuda.synchronize()
        unequal = _unequal_words(got, want)
        lib_unequal = _unequal_words(got.reshape(lib.shape), lib)
        wrong_unequal = _unequal_words(got.reshape(wrong.shape), wrong)
        # beside the bit comparison, the measured max |got - want| where both are finite
        err = _bit_compare(got, want)[2] if got.shape == want.shape else float("inf")
        turns = None
        if old_cases is not None:
            old = old_cases[i]["call"]
            old_unequal = _unequal_words(old(xs[0]), got)
            if old_unequal:
                fail("copy_vs_plain", f"{c['name']}: {old_unequal} words differ from the "
                     "baseline tree's kernel")
            new = lambda j: c["call"](xs[j % 3])  # noqa: E731
            turns = [time_launches(lambda j: old(xs[j % 3])), time_launches(new),
                     time_launches(new), time_launches(lambda j: old(xs[j % 3]))]
            if plan is not None:
                host = [host_us_per_call(lambda j: old(xs[j % 3])), host_us_per_call(new),
                        host_us_per_call(new), host_us_per_call(lambda j: old(xs[j % 3]))]
        ms = time_launches(lambda j: c["call"](xs[j % 3]))
        plain_ms = time_launches(lambda j: c["plain"](xs[j % 3]))
        lib_ms = time_launches(lambda j: c["library"](xs[j % 3]))
        if c["kernel"] == "repeat_rows":  # a plain device copy of the output's bytes
            dst, src = torch.empty_like(got), got.clone()
            copy_ms = time_launches(lambda j: dst.copy_(src))
            del dst, src
            empty_ms = time_launches(lambda j: torch.cuda._sleep(0))  # an empty kernel
        n_in = math.prod(c["shape"]) if c["needed"] is None else c["needed"]
        n_bytes = (n_in + got.numel()) * got.element_size()
        b_ms, b_by = bound_ms(n_bytes, 0)
        special = 0 if c["dtype"] == torch.uint8 else int((~torch.isfinite(got)).sum())
        rows[c["name"]] = r = {
            "phase": "copy_vs_plain", "case": c["name"], "kernel": c["kernel"],
            "probe": c["probe"], "dtype": str(c["dtype"]).split(".")[-1],
            "in_shape": list(c["shape"]), "out_shape": list(got.shape),
            "unequal_words": unequal, "max_abs_err": err, "library": c["library_name"],
            "library_unequal_words": lib_unequal, "wrong": c["wrong_name"],
            "wrong_unequal_words": wrong_unequal, "nan_or_inf_copied": special,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "mb_moved": n_bytes / 1e6}
        if plan is not None:
            r["route"] = plan.route
        if c["kernel"] == "repeat_rows":
            r["copy_ms"] = copy_ms
            r["empty_kernel_ms"] = empty_ms
            r["plan"] = dataclasses.asdict(plan) if plan is not None else None
        if turns is not None:
            r["turns_old_new_new_old_ms"] = turns
            r["earlier_ms"] = statistics.mean(turns[0::3])
            r["new_in_turns_ms"] = statistics.mean(turns[1:3])
            if plan is not None:
                r["host_us_per_call_old_new_new_old"] = host
        emit(r, detail=True)
        if unequal or lib_unequal:
            fail("copy_vs_plain", f"{c['name']}: {unequal} words differ from the plain version, "
                 f"{lib_unequal} from {c['library_name']}")
        if wrong_unequal == 0:
            fail("copy_vs_plain", f"{c['name']}: {c['wrong_name']} passes the comparison")
        if c["dtype"] != torch.uint8 and special == 0:
            fail("copy_vs_plain", f"{c['name']}: no NaN or inf reached the output")
        del xs, got, want, lib, wrong
    # the step's own helpers reach the same kernels with tables they build themselves
    segs = _bits_data((B // SEG_WINDOWS, SEG_WINDOWS + L - 1, H, W, 3), torch.uint8, 290, dev)
    want = torch.stack([segs[s, j : j + L] for s in range(segs.shape[0])
                        for j in range(SEG_WINDOWS)])
    helper_unequal = _unequal_words(steps._expand_segments(segs, L), want)
    if helper_unequal:
        fail("copy_vs_plain", f"_expand_segments: {helper_unequal} words differ from slicing")
    emit({"phase": "copy_vs_plain", "what": "bit-equal to the plain version and to one PyTorch "
          "call; each wrong version differs; [ms, bound_ms, plain_ms, library_ms]",
          "cases": {k: [round(r[key], 5) for key in ("ms", "bound_ms", "plain_ms", "library_ms")]
                    for k, r in rows.items()},
          "routes": {k: r["route"] for k, r in rows.items() if "route" in r},
          "earlier_ms": ({k: round(r["earlier_ms"], 5) for k, r in rows.items()}
                         if baseline is not None else "not measured"),
          "expand_segments_helper_unequal_words": helper_unequal})
    # the kernels' line: each kernel at the train path's shape (the roll at the probe's)
    at = {"window_copy": "segment_expand", "repeat_rows": "median_repeat", "roll_cols": "U6"}
    return {k: {"at": f"copy_vs_plain case {v}",
                **{key: rows[v][key] for key in ("max_abs_err", "unequal_words", "ms", "plain_ms",
                                                 "bound_ms", "bound_by", "library_ms")}}
            for k, v in at.items()}


# (name, flags beyond the common ones, (window_copy, repeat_rows) launches per
# train step and per eval batch, K1 / K2 launches per train step): segmented
# batches expand once and repeat the median once; a frame-mixup step gathers
# the blend's two operands (with sample mixup too it composes materialised
# labels, so the two-disk loss kernels rest); a resident step gathers frames
# and medians, in training and in validation
SEG_RUNS = (
    ("segment_windows", ["--segment_windows", str(SEG_WINDOWS), "--alpha", "0.5"], (1, 1), (0, 0), 1),
    ("frame_alpha", ["--frame_alpha", "0.5", "--alpha", "-1"], (2, 0), (0, 0), 1),
    ("frame_alpha+alpha", ["--frame_alpha", "0.5", "--alpha", "0.5"], (2, 0), (0, 0), 0),
    ("resident_frames", ["--resident_frames", "--alpha", "0.5"], (2, 0), (2, 0), 1),
)


def _device_batch(batch, dev):
    import torch

    return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


def _seg_batches(data_dir: str, dev):
    """The first batch (seed 3) of each loader mode, on the host."""
    from tracknetv3_tpu_torch.data.dataset import (
        HeatmapBatchLoader,
        ResidentHeatmapLoader,
        build_split_index,
    )

    index = build_split_index(data_dir, "train", L, 1)
    kw = dict(shuffle=True, seed=3, data_dir=data_dir)
    loaders = {
        "plain": HeatmapBatchLoader(index, "concat", B, **kw),
        "segment_windows": HeatmapBatchLoader(index, "concat", B, segment_windows=SEG_WINDOWS, **kw),
        "frame_alpha": HeatmapBatchLoader(index, "concat", B, frame_alpha=0.5, **kw),
        "resident_frames": ResidentHeatmapLoader(index, "concat", B, device=dev, **kw),
    }
    return {k: next(iter(v)) for k, v in loaders.items()}


def phase_seg_train(tmp: str, model):
    """seg_train: the train CLI with segmented batches, frame mixup (alone and
    with sample mixup) and device-resident frames, one epoch each; then ms per
    step, peak memory and host bytes shipped per step on a fixed batch of each
    kind, beside the plain batch's."""
    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index
    from tracknetv3_tpu_torch.ops import shift_copy as sc
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.loop import _DEVICE_KEYS

    dev = torch.device(DEVICE)
    data_dir = os.path.join(tmp, "data")
    eval_batches = len(HeatmapBatchLoader(build_split_index(data_dir, "val", L, L), "concat", B,
                                          data_dir=data_dir))
    total = dict.fromkeys(sc.KERNELS, 0)
    runs = {}
    for name, flags, per_step, per_eval, loss_kernels in SEG_RUNS:
        _zero_launches()  # counts of this run only
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):  # the CLI's own lines
            out = train_cli.main(["--seq_len", str(L), "--bg_mode", "concat",
                                  "--batch_size", str(B), "--data_dir", data_dir,
                                  "--epochs", "1",
                                  "--save_dir", os.path.join(tmp, f"exp_{name}")] + flags)
        torch.cuda.synchronize()
        launches, k_launches = _launches(sc), _launches(wd)
        steps, (h,) = out["step"], out["history"]
        want = {"window_copy": per_step[0] * steps + per_eval[0] * eval_batches,
                "repeat_rows": per_step[1] * steps + per_eval[1] * eval_batches, "roll_cols": 0}
        runs[name] = {"train_steps": steps, "eval_batches": eval_batches, "launches": launches,
                      "loss_kernel_launches": k_launches, "train_loss": h["train_loss"],
                      "val_loss": h["val_loss"], "seconds": round(time.time() - t0, 2)}
        if not steps or launches != want:
            fail("seg_train", f"{name}: copy launches {launches} != {want} ({steps} train steps, "
                 f"{eval_batches} eval batches)")
        if k_launches != {"wbce_disk_fwd": loss_kernels * steps,
                          "wbce_disk_bwd": loss_kernels * steps}:
            fail("seg_train", f"{name}: loss kernel launches {k_launches} in {steps} steps")
        if not (math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])
                and "accuracy" in h["val_res"]):
            fail("seg_train", f"{name}: {h}")
        for k, v in launches.items():
            total[k] += v
    emit({"phase": "seg_train", "config": f"TrackNet seq_len {L} concat {H}x{W} batch {B} bf16, "
          f"one epoch each through the train CLI", "runs": runs, "copy_launches_total": total})

    # a fixed batch of each kind, in turns: plain first and last
    batches = _seg_batches(data_dir, dev)
    order = (("plain", "plain", 0.5), ("segment_windows", "segment_windows", 0.5),
             ("frame_alpha", "frame_alpha", -1.0), ("frame_alpha+alpha", "frame_alpha", 0.5),
             ("resident_frames", "resident_frames", 0.5), ("plain_again", "plain", 0.5))
    times = {}
    for name, kind, alpha in order:
        host = batches[kind]
        shipped = sum(v.nbytes for k, v in host.items()
                      if k in _DEVICE_KEYS and isinstance(v, np.ndarray))
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses = _time_steps(model, _device_batch(host, dev), alpha)
        times[name] = {"median_ms": statistics.median(step_ms), "min_ms": min(step_ms),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "host_bytes_shipped": shipped,
                       "loss_first_last": [losses[0], losses[-1]]}
        if not all(math.isfinite(v) for v in losses) or min(losses[-3:]) > 1.1 * losses[0]:
            fail("seg_step_time", f"{name}: the loss on a fixed batch went {losses}")
    emit({"phase": "seg_step_time", "what": "per step: 10 steps after 2 warm-up on one fixed "
          "batch of each kind, host clock around synchronize", "kinds": times})
    return total


def _time_steps(model, batch, alpha: float, n: int = 12):
    """(ms of each step after 2 warm-up, the loss of every step) of ``n``
    train steps on one device batch, a new Adam each time."""
    import torch

    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import make_tracknet_train_step, sample_mixup_params

    dev = torch.device(DEVICE)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_train_step(model, opt, "concat", alpha, sched)
    mix = ()
    if alpha > 0:
        mix = tuple(torch.from_numpy(a).to(dev)
                    for a in sample_mixup_params(np.random.default_rng(5), B, alpha))
    times, losses = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch, i, *mix)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return times[2:], losses


def _expanded_plain(batch):
    """The plain batch that holds the windows of a segmented or resident
    batch, by torch indexing (no kernel of the port)."""
    import torch

    out = {"cxcy": batch["cxcy"]}
    if "seg_rgb" in batch:
        segs = batch["seg_rgb"]
        seg = segs.shape[1] - L + 1
        out["rgb"] = segs[:, _window_rows(torch.arange(seg, device=segs.device), L)].flatten(0, 1)
        out["median"] = batch["median"].repeat_interleave(seg, dim=0)
    else:
        out["rgb"] = batch["res_rgb_buf"][batch["res_idx"].long()]
        out["median"] = batch["res_median_buf"][batch["res_median_idx"].long()]
    return out


def phase_seg_parity(data_dir: str):
    """seg_parity: one float32 train step (TF32 off, deterministic cuDNN, no
    autotuning) from the same weights on a segmented batch, on a resident
    batch, and on the plain batch holding the same windows: the assembled
    input bit-equal; loss and gradients bit-equal, or within the float32
    bounds of ``step_parity`` where a plain step differs from itself."""
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import (
        assemble_tracknet_inputs,
        make_tracknet_train_step,
        sample_mixup_params,
    )

    dev = torch.device(DEVICE)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(11),
                     dtype=torch.float32)
    perm, lam = (torch.from_numpy(a).to(dev)
                 for a in sample_mixup_params(np.random.default_rng(7), B, 0.5))

    def one_step(batch):
        model = copy.deepcopy(base).to(dev, memory_format=torch.channels_last)
        opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
        loss = make_tracknet_train_step(model, opt, "concat", 0.5, sched)(batch, 0, perm, lam)
        return float(loss), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    def versus(a, b):
        (la, ga), (lb, gb) = a, b
        rel = {k: _rel_l2(ga[k], gb[k]) for k in gb}
        return {"loss": la, "loss_rel_err": abs(la - lb) / abs(lb),
                "grad_rel_l2_max": max(rel.values()),
                "bit_equal": la == lb and all(torch.equal(ga[k], gb[k]) for k in gb)}

    loss_bound, grad_bound = STEP_PARITY_BOUNDS["float32"]
    try:
        host = _seg_batches(data_dir, dev)
        res = {}
        for kind in ("segment_windows", "resident_frames"):
            batch = _device_batch(host[kind], dev)
            plain = _expanded_plain(batch)
            x_unequal = _unequal_words(assemble_tracknet_inputs(batch, "concat"),
                                       assemble_tracknet_inputs(plain, "concat"))
            ref = one_step(plain)
            res[kind] = {"x_unequal_words": x_unequal, "vs_plain": versus(one_step(batch), ref),
                         "plain_vs_itself": versus(one_step(plain), ref)}
        emit({"phase": "seg_parity", "dtype": "float32", "tf32": False,
              "cudnn": "deterministic, no autotuning", "loss_bound": loss_bound,
              "grad_bound": grad_bound, "kinds": res})
        for kind, r in res.items():
            v = r["vs_plain"]
            if r["x_unequal_words"]:
                fail("seg_parity", f"{kind}: {r['x_unequal_words']} elements of the assembled "
                     "input differ from the plain batch's")
            if not (v["bit_equal"] or (v["loss_rel_err"] <= loss_bound
                                       and v["grad_rel_l2_max"] <= grad_bound)):
                fail("seg_parity", f"{kind}: {v} (bounds {loss_bound}, {grad_bound})")
            if not v["bit_equal"] and r["plain_vs_itself"]["bit_equal"]:
                fail("seg_parity", f"{kind}: equal inputs, a plain step that repeats bit for "
                     f"bit, and yet {v}")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


# ---------------------------------------------------------------- serving

SERVE_T = 480  # frames of the synthetic video
# (conv_backend, batch size, frames served): each route at the predict CLI's
# default batch and bench.py's, over the whole video
# frames of serve_vs_cpu's run and CPU replay (4 chunks at batch 16, 1 at
# 120): a depth cut for time, from 160 when data-parallel training joined
SERVE_REPLAY_T = 64
SERVE_RUNS = (("cudnn", 16, SERVE_T), ("cudnn", 120, SERVE_T), ("hand_k3c", 16, SERVE_T),
              ("hand_k3c", 120, SERVE_T), ("hand_9tap", 16, SERVE_T), ("hand_9tap", 120, SERVE_T))
# (max, mean) |dp| of the folded forward vs the unfolded TrackNet, on the
# checkpoint of deterministic_checkpoint, which repeats from run to run. bf16:
# the sound forward read 0.0127 max (the hand routes 0.0134) and every wrong
# forward at least 0.237 (pool1_stride2 0.249, up3_tiled 0.291, pool3_stride2
# 0.239, up1_tiled 0.237) on an H100 (PERF.md): the bound sits between.
# float32: the bounds of tests/test_torch_fused_forward.py
SERVE_PARITY_BOUNDS = {"bfloat16": (3e-2, 1e-3), "float32": (1e-5, 1e-6)}
PARITY_STARTS = (0, 232, 456)  # first window of each 16-window chunk of serve_parity
# each must fail the bf16 bound; bias_after_cast, a rounding, is read beside them
WRONG_FORWARDS = ("pool1_stride2", "up3_tiled", "pool3_stride2", "up1_tiled")
HAND_BACKENDS = ("hand_k3c", "hand_9tap")  # the 3x3 convs on the kernels of conv3x3.cu
# NHWC input shape of each pool and upsample call of one forward at batch 16
POOL_SHAPES = ((16, 288, 512, 64), (16, 144, 256, 128), (16, 72, 128, 256))
UP_SHAPES = ((16, 36, 64, 512), (16, 72, 128, 256), (16, 144, 256, 128))
# the stateless overlap steps (device resize, streaming) forward B+L-1 = 23
# windows a chunk at batch 16: every serving shape is held at that N too
STATELESS_BATCH = 16 + 8 - 1


def _special_bf16(shape, seed: int, dev):
    """Random bf16 NHWC data with 32 NaN and 32 -inf entries, as the NCHW
    view (channels_last memory) that the kernels take."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    flat = x.view(-1)
    idx = torch.randint(0, flat.numel(), (64,), generator=g, device=dev)
    flat[idx[:32]] = float("nan")
    flat[idx[32:]] = float("-inf")
    return x.permute(0, 3, 1, 2)


def _bit_compare(a, b):
    """(NaN positions equal, count of other unequal entries, max |a - b| over
    entries finite in both)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    both = ~na & ~nb
    unequal = int(((a != b) & both).sum())
    finite = both & torch.isfinite(a) & torch.isfinite(b)
    err = float((a.float() - b.float()).abs()[finite].max()) if bool(finite.any()) else 0.0
    return bool(torch.equal(na, nb)), unequal, err


def phase_pool_up():
    import torch

    from tracknetv3_tpu_torch.ops import pool_up2x as pu

    dev = torch.device(DEVICE)
    kernels = (
        # name, kernel, plain, input shapes, output/input elements, ops per output
        ("maxpool2x2", pu.maxpool2x2, pu.maxpool2x2_plain, POOL_SHAPES, 0.25, 3),
        ("up2x_nearest", pu.up2x_nearest, pu.up2x_nearest_plain, UP_SHAPES, 4, 0),
    )
    totals = {}
    for name, kern, plain, shapes, ratio, ops in kernels:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "bound_by": []}
        # batch 16 timed; the stateless chunks' N checked untimed
        cases = [(shape, True) for shape in shapes] + [
            ((STATELESS_BATCH,) + shape[1:], False) for shape in shapes]
        for i, (shape, timed) in enumerate(cases):
            # three copies so each timed call reads cold data, as in the forward
            xs = [_special_bf16(shape, 100 * i + k, dev) for k in range(3 if timed else 1)]
            got, want = kern(xs[0]), plain(xs[0])
            torch.cuda.synchronize()
            same_nan, unequal, err = _bit_compare(got, want)
            layout = got.is_contiguous(memory_format=torch.channels_last)
            rec = {"phase": "pool_up_vs_plain", "kernel": name, "shape_NHWC": list(shape),
                   "nan_positions_equal": same_nan, "unequal": unequal, "max_abs_err": err,
                   "channels_last_out": layout}
            if timed:
                ms = time_launches(lambda j: kern(xs[j % 3]))
                plain_ms = time_launches(lambda j: plain(xs[j % 3]))
                n_in = math.prod(shape)
                n_out = int(n_in * ratio)
                b_ms, b_by = bound_ms(2 * (n_in + n_out), ops * n_out)
                rec.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "mb_moved": 2 * (n_in + n_out) / 1e6})
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += b_ms
                tot["bound_by"].append(b_by)
            emit(rec, detail=True)
            if not (same_nan and unequal == 0 and err == 0.0 and layout
                    and tuple(got.shape) == tuple(want.shape)):
                fail("pool_up_vs_plain", f"{name} at {shape}: nan_equal={same_nan} "
                     f"unequal={unequal} err={err} channels_last={layout}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            del xs, got, want
        totals[name] = tot
    emit({"phase": "pool_up_vs_plain", "what": "the three calls of one serving forward at "
          f"batch 16 (timed, ms summed) and {STATELESS_BATCH} (checked), bf16 with NaN and "
          "-inf; every shape bit-exact",
          "kernels": {k: {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                      for k, v in totals.items()}})
    return totals


# ---------------------------------------------------------------- decode

# the peak-blob decode's calls in serving: v3's chunk of 16 ensembled frames
# and its flush of L - 1, v2's 16 windows of 3 maps (a view of NHWC memory)
DECODE_CASES = (("v3_chunk", (16,), False), ("v3_flush", (L - 1,), False),
                ("v2_chunk", (16, 3), True))


def _decode_maps(lead, nhwc: bool, seed: int, dev):
    """Heatmaps like the served ones: noise under the threshold, a disk
    (radius 2-9, cone values up to 1) and 30 speckles above it a map."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(lead)
    x = torch.rand((n, H, W), generator=g, device=dev) * 0.45
    cy = torch.randint(0, H, (n, 1, 1), generator=g, device=dev)
    cx = torch.randint(0, W, (n, 1, 1), generator=g, device=dev)
    r = torch.randint(2, 10, (n, 1, 1), generator=g, device=dev)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    x = torch.where(d2 <= r * r, torch.maximum(x, 1.0 - d2 / 256.0), x)
    flat = x.view(n, -1)
    idx = torch.randint(0, H * W, (n, 30), generator=g, device=dev)
    flat.scatter_(1, idx, 0.5 + 0.5 * torch.rand((n, 30), generator=g, device=dev))
    if nhwc:  # the (B, L, h, w) view of (B, h, w, L) memory that v2's forward returns
        return x.view(*lead, H, W).permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    return x.view(*lead, H, W)


def _decode_unequal(got: dict, want: dict) -> int:
    """Maps whose decode differs in any field (conf by its bits)."""
    import torch

    differs = torch.zeros(got["cx"].numel(), dtype=torch.bool, device=got["cx"].device)
    for k in ("cx", "cy", "vis", "bbox", "conf"):
        a, b = got[k], want[k]
        if k == "conf":
            a, b = a.view(torch.int32), b.view(torch.int32)
        differs |= (a != b).reshape(differs.numel(), -1).any(dim=1)
    return int(differs.sum())


def phase_decode_peak():
    """decode_peak: the peak-blob decode kernel against its plain version at
    serving's calls, bit for bit; a plain decode of one dilation step must
    differ (the comparison sees the fill); no host synchronisation in a
    call; times beside the bound (the maps read once)."""
    import torch

    from tracknetv3_tpu_torch.ops import detect

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = {}
    for i, (name, lead, nhwc) in enumerate(DECODE_CASES):
        xs = [_decode_maps(lead, nhwc, 300 + 10 * i + k, dev) for k in range(3)]
        got, want = detect.decode_heatmaps(xs[0]), detect.decode_heatmaps_plain(xs[0])
        wrong = detect.decode_heatmaps_plain(xs[0], max_iters=1)
        torch.cuda.synchronize()
        unequal, wrong_unequal = _decode_unequal(got, want), _decode_unequal(wrong, want)
        torch.cuda.set_sync_debug_mode("error")
        try:
            detect.decode_heatmaps(xs[1])
            synced = None
        except RuntimeError as e:
            synced = str(e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ms = time_launches(lambda j: detect.decode_heatmaps(xs[j % 3]))
        plain_ms = time_launches(lambda j: detect.decode_heatmaps_plain(xs[j % 3]), n=5,
                                 windows=3)
        host_us = host_us_per_call(lambda j: detect.decode_heatmaps(xs[j % 3]))
        n_bytes = 4 * math.prod(lead) * H * W
        b_ms, b_by = bound_ms(n_bytes, 0)
        rec = {"phase": "decode_peak", "case": name, "maps": list(lead) + [H, W],
               "nhwc_view": nhwc, "cluster": detect.cluster_size(math.prod(lead), sms),
               "visible": int(want["vis"].sum()), "unequal_maps": unequal,
               "wrong_one_step_unequal_maps": wrong_unequal, "sync": synced, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "host_us_per_call": host_us}
        emit(rec, detail=True)
        if unequal or not wrong_unequal or synced is not None:
            fail("decode_peak", f"{name}: {unequal} maps differ from the plain decode, "
                 f"{wrong_unequal} from the one-step decode, sync: {synced}")
        totals[name] = {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "host_us_per_call")}
        del xs, got, want, wrong
    emit({"phase": "decode_peak", "what": "serving's decode calls, float32 maps: the kernel "
          "bit-equal to the plain decode, no host synchronisation", "cases": totals})
    return totals


# ---------------------------------------------------------------- 3x3 conv

# (H, W, Ci, Co) of each distinct 3x3 conv of one serving forward, and how
# many of its 17 convs have it (blocks of 2/2/3/3/3/2/2; an up block's first
# conv reads the concat [up2x(x), skip])
CONV_SHAPES = {(288, 512, 27, 64): 1, (288, 512, 64, 64): 2, (288, 512, 192, 64): 1,
               (144, 256, 64, 128): 1, (144, 256, 128, 128): 2, (144, 256, 384, 128): 1,
               (72, 128, 128, 256): 1, (72, 128, 256, 256): 4, (72, 128, 768, 256): 1,
               (36, 64, 256, 512): 1, (36, 64, 512, 512): 2}
CONV_LAYERS = sum(CONV_SHAPES.values())
CONV_BATCH = 16
# N, H, W, Ci, Co where no tile divides H or W: BN = 128, and BN = 64 (the 9tap
# kernel's M = 256 tile) with a partial last input-channel chunk
CONV_ODD_SHAPES = ((3, 37, 61, 96, 128), (3, 37, 61, 40, 64))
CONV_VARIANTS = ("k3c", "9tap")
# Kernel vs plain in bfloat16 spacings at max(|a|, |b|, RMS / 8)
# (``bf16_ulps_apart``): both round one float32 sum of the same terms once,
# so they are equal or neighbours: the kernels read exactly 1.0 at every
# shape on the card. The bias added after the cast reads 4.25 or more and
# the other wrong convs 255 (PERF.md); the bound sits between.
CONV_ULPS_BOUND = 1.0
CONV_FLOOR_OF_RMS = 0.125
CONV_WRONG = ("tap_dropped", "dx_mirrored", "halo_not_zero", "bias_after_cast",
              "last_chunk_dropped")
ABLATE_SHAPE = (24, 72, 128, 256, 256)  # the ablation probe's: N, H, W, Ci, Co


def _conv_data(N, H, W, Ci, Co, seed: int, dev):
    """One layer's operands: x (NCHW view of channels_last bf16, channels
    padded with zeros to the kernels' multiple) of unit normals with 5% exact
    zeros, one NaN and one inf in sample 0; a He-scaled HWIO kernel, so that
    outputs have an RMS near 1; a bias of spread 0.5, so that the ReLU cuts
    about half and sums cancel against it."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    g = torch.Generator(device=dev).manual_seed(seed)
    cp = c3.padded_channels(Ci)
    x = torch.zeros((N, H, W, cp), dtype=torch.bfloat16, device=dev)
    v = torch.randn((N, H, W, Ci), generator=g, device=dev)
    v = v.masked_fill(torch.rand((N, H, W, Ci), generator=g, device=dev) < 0.05, 0.0)
    x[..., :Ci] = v.to(torch.bfloat16)
    del v
    x[0, H // 3, W // 3, Ci // 2] = float("nan")
    x[0, (2 * H) // 3, (2 * W) // 3, Ci // 3] = float("inf")
    k = torch.randn((3, 3, Ci, Co), generator=g, device=dev) * math.sqrt(2.0 / (9 * Ci))
    bias = 0.5 * torch.randn((Co,), generator=g, device=dev)
    return x.permute(0, 3, 1, 2), k, bias


def _conv_f32(x_f32, w_hwio_f32, padding: int = 1):
    """float32 conv of NCHW ``x`` with an HWIO kernel by PyTorch's own
    (non-cuDNN) convolution, as the plain version runs it."""
    import torch
    import torch.nn.functional as F

    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(x_f32, w_hwio_f32.permute(3, 2, 0, 1), padding=padding)


def _wrong_conv(name: str, x, w_hwio, bias):
    """The conv + bias + ReLU with one deliberate fault, in float32 torch
    ops: the (dy 2, dx 0) tap dropped, the kernel mirrored in dx, the halo
    filled with the edge pixel instead of zero, the bias added after the
    cast to bfloat16, or the last chunk of ``CK`` input channels dropped (an
    off-by-one in the ring's drain or an mbarrier phase fault)."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.ops.conv3x3 import CK

    xf, w = x.float(), w_hwio.to(torch.bfloat16).float()
    w = F.pad(w, (0, 0, 0, x.shape[1] - w.shape[2]))  # the input's zero channels
    if name == "tap_dropped":
        w = w.clone()
        w[2, 0] = 0.0
    elif name == "dx_mirrored":
        w = w.flip(1)
    elif name == "last_chunk_dropped":
        w = w.clone()
        w[:, :, (x.shape[1] - 1) // CK * CK:] = 0.0
    if name == "halo_not_zero":
        y = _conv_f32(F.pad(xf, (1, 1, 1, 1), mode="replicate"), w, padding=0)
    else:
        y = _conv_f32(xf, w)
    if name == "bias_after_cast":
        y = y.to(torch.bfloat16).float()
    y = torch.maximum(y + bias.reshape(1, -1, 1, 1), torch.zeros((), device=y.device))
    return y.to(torch.bfloat16)


def _conv_compare(got, want, x):
    """Kernel output vs plain: (NaN positions equal, and equal to the 3x3
    neighbourhood of the input's NaN; inf positions equal; bfloat16 spacings
    apart; share of unequal finite entries; max |a - b| over finite ones)."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.ops.conv3x3 import bf16_ulps_apart

    nan_in = torch.isnan(x).any(dim=1, keepdim=True).float()
    nan_want = F.max_pool2d(nan_in, 3, stride=1, padding=1).bool().expand_as(got)
    ng, nw = torch.isnan(got), torch.isnan(want)
    ig, iw = torch.isinf(got), torch.isinf(want)
    finite = torch.isfinite(got) & torch.isfinite(want)
    wf = want.float()
    rms = float(wf[finite].square().mean().sqrt())
    return {
        "nan_positions_equal": bool(torch.equal(ng, nw)),
        "nan_is_3x3_neighbourhood": bool(torch.equal(ng, nan_want)),
        "inf_positions_equal": bool(torch.equal(ig, iw)
                                    and torch.equal(got[ig] > 0, want[ig] > 0)),
        "nan_entries": int(ng.sum()), "inf_entries": int(ig.sum()),
        "ulps_apart": bf16_ulps_apart(got, want, CONV_FLOOR_OF_RMS * rms),
        "unequal_share": float(((got != want) & finite).float().mean()),
        "max_abs_err": float((got.float() - wf).abs()[finite].max()),
        "out_rms": rms,
    }


def _conv_sound(r) -> bool:
    return (r["nan_positions_equal"] and r["nan_is_3x3_neighbourhood"]
            and r["inf_positions_equal"] and r["ulps_apart"] <= CONV_ULPS_BOUND)


def _conv_check_shape(c3, shape, seed: int, dev, timed: bool):
    """conv_vs_plain at one (N, H, W, Ci, Co); times too when ``timed``."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.models import fused_forward as ff

    N, H, W, Ci, Co = shape
    x, k, bias = _conv_data(N, H, W, Ci, Co, seed, dev)
    packed = c3.pack_weights(k, torch.bfloat16, device=dev)
    res = {"phase": "conv_vs_plain", "shape_NHWC": [N, H, W, Ci], "Co": Co,
           "padded_Ci": x.shape[1], "bound_ulps": CONV_ULPS_BOUND}
    bad = []
    for label, b, relu in (("epilogue", bias, True), ("bare", None, False)):
        want = c3.conv3x3_bias_relu_plain(x, packed, b, relu=relu)
        outs = {v: c3.conv3x3_bias_relu(x, packed, b, variant=v, relu=relu)
                for v in CONV_VARIANTS}
        torch.cuda.synchronize()
        res[label] = {v: _conv_compare(o, want, x) for v, o in outs.items()}
        res[label]["k3c_equals_9tap"] = bool(torch.equal(
            outs["k3c"].view(torch.int16), outs["9tap"].view(torch.int16)))
        between = _conv_compare(outs["k3c"], outs["9tap"], x)
        res[label]["k3c_vs_9tap_ulps"] = between["ulps_apart"]
        if not _conv_sound(between):
            bad.append(f"k3c and 9tap {label} differ: {between}")
        for v, o in outs.items():
            if not (_conv_sound(res[label][v])
                    and o.is_contiguous(memory_format=torch.channels_last)
                    and tuple(o.shape) == (N, Co, H, W)):
                bad.append(f"{v} {label}: {res[label][v]}")
        if label == "epilogue":
            # the wrong convs on two samples that hold no NaN or inf
            lo = min(2, N - 1)
            xs, ws = x[lo : lo + 2], want[lo : lo + 2].float()
            floor = CONV_FLOOR_OF_RMS * float(ws.square().mean().sqrt())
            res["wrong_ulps_apart"] = {
                name: c3.bf16_ulps_apart(_wrong_conv(name, xs, k, bias), ws, floor)
                for name in CONV_WRONG}
            passed = [n for n, u in res["wrong_ulps_apart"].items() if u <= CONV_ULPS_BOUND]
            if passed:
                bad.append(f"the bound passes the wrong convs {passed}")
        del want, outs
    if timed:
        # three copies of x rotate so that each call reads cold data
        xs = [x] + [x.clone(memory_format=torch.channels_last) for _ in range(2)]
        ms = {v: time_launches(lambda i, v=v: c3.conv3x3_bias_relu(
            xs[i % 3], packed, bias, variant=v), n=10, windows=3) for v in CONV_VARIANTS}
        plain_ms = time_launches(lambda i: c3.conv3x3_bias_relu_plain(xs[i % 3], packed, bias),
                                 n=2, windows=3)
        # today's route: cuDNN on the unpadded bf16 channels_last operands,
        # alone and with the torch bias + ReLU + cast passes
        w = k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b4 = bias.reshape(1, -1, 1, 1)
        xc = [t[:, :Ci].contiguous(memory_format=torch.channels_last) for t in xs]
        cudnn_ms = time_launches(lambda i: F.conv2d(xc[i % 3], w, padding=1), n=10, windows=3)
        cudnn_epi_ms = time_launches(lambda i: ff._conv_relu(xc[i % 3], w, b4), n=10, windows=3)
        flops = 2 * N * H * W * 9 * Ci * Co
        n_bytes = 2 * (N * H * W * (Ci + Co) + 9 * Ci * Co) + 4 * Co
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
        res.update({"ms": ms, "plain_ms": plain_ms, "cudnn_ms": cudnn_ms,
                    "cudnn_with_epilogue_ms": cudnn_epi_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "gflop": flops / 1e9,
                    "tflops": {v: flops / t / 1e9 for v, t in ms.items()}})
    emit(res, detail=True)
    if bad:
        fail("conv_vs_plain", f"{shape}: " + "; ".join(bad))
    return res


def phase_conv():
    """conv_vs_plain at the serving forward's shapes at batch 16 (timed) and
    23 (the stateless chunks' windows), and at two odd shapes; returns per
    kernel the sums over the 17 convs of one batch-16 forward."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    dev = torch.device(DEVICE)
    torch.backends.cudnn.benchmark = True  # the yardstick picks its fastest algorithms
    tot = {v: {"ms": 0.0, "max_abs_err": 0.0} for v in CONV_VARIANTS}
    shared = {"plain_ms": 0.0, "cudnn_ms": 0.0, "cudnn_with_epilogue_ms": 0.0,
              "bound_ms": 0.0, "gflop": 0.0}
    bound_by = {"bytes": 0.0, "operations": 0.0}  # ms of the summed bound under each
    checked, per_shape = [], []
    for i, ((H, W, Ci, Co), layers) in enumerate(CONV_SHAPES.items()):
        r = _conv_check_shape(c3, (CONV_BATCH, H, W, Ci, Co), 40 + i, dev, timed=True)
        checked.append(r)
        per_shape.append({"H": H, "W": W, "Ci": Ci, "Co": Co, "layers": layers,
                          **{f"{v}_ms": r["ms"][v] for v in CONV_VARIANTS},
                          "cudnn_ms": r["cudnn_ms"], "bound_ms": r["bound_ms"],
                          "share_of_bound": {v: r["bound_ms"] / r["ms"][v]
                                             for v in CONV_VARIANTS}})
        for v in CONV_VARIANTS:
            tot[v]["ms"] += layers * r["ms"][v]
            tot[v]["max_abs_err"] = max(tot[v]["max_abs_err"], r["epilogue"][v]["max_abs_err"],
                                        r["bare"][v]["max_abs_err"])
        for key in shared:
            shared[key] += layers * r[key]
        bound_by[r["bound_by"]] += layers * r["bound_ms"]
        torch.cuda.empty_cache()
    for i, (H, W, Ci, Co) in enumerate(CONV_SHAPES):
        checked.append(_conv_check_shape(c3, (STATELESS_BATCH, H, W, Ci, Co), 70 + i, dev,
                                         timed=False))
        torch.cuda.empty_cache()
    for i, shape in enumerate(CONV_ODD_SHAPES):
        checked.append(_conv_check_shape(c3, shape, 60 + i, dev, timed=False))
    emit({"phase": "conv_vs_plain", "shapes": len(checked), "bound_ulps": CONV_ULPS_BOUND,
          "worst_ulps_apart": max(r[e][v]["ulps_apart"] for r in checked
                                  for e in ("epilogue", "bare") for v in CONV_VARIANTS),
          "max_unequal_share": max(r[e][v]["unequal_share"] for r in checked
                                   for e in ("epilogue", "bare") for v in CONV_VARIANTS),
          "k3c_equals_9tap_everywhere": all(r[e]["k3c_equals_9tap"] for r in checked
                                            for e in ("epilogue", "bare")),
          "worst_k3c_vs_9tap_ulps": max(r[e]["k3c_vs_9tap_ulps"] for r in checked
                                        for e in ("epilogue", "bare")),
          "min_wrong_ulps_apart": {n: min(r["wrong_ulps_apart"][n] for r in checked)
                                   for n in CONV_WRONG}})
    emit({"phase": "conv_times", "what": f"the {CONV_LAYERS} 3x3 convs of one serving forward "
          f"at batch {CONV_BATCH}, bf16, ms summed", "kernel_ms": {v: tot[v]["ms"] for v in tot},
          **shared, "tflops": {v: shared["gflop"] / tot[v]["ms"] for v in tot},
          "cudnn_tflops": shared["gflop"] / shared["cudnn_ms"], "bound_ms_by": bound_by,
          "per_shape": per_shape})
    return {v: {**tot[v], "plain_ms": shared["plain_ms"], "bound_ms": shared["bound_ms"],
                "bound_by": max(bound_by, key=bound_by.get), "library_ms": shared["cudnn_ms"],
                "library_with_epilogue_ms": shared["cudnn_with_epilogue_ms"]} for v in tot}


# (H, W, Ci, Co) of each distinct 3x3 conv of TrackNetV1's forward at
# 360x640, and how many of its 18 convs have it (``models/tracknet_v1.LAYERS``:
# no skips, so each conv reads the one before it; the first reads the 9
# channels of a window, padded to 16; 45x80 leaves partial tiles)
V1_CONV_SHAPES = {(360, 640, 9, 64): 1, (360, 640, 64, 64): 2, (180, 320, 64, 128): 1,
                  (180, 320, 128, 128): 2, (90, 160, 128, 256): 1, (90, 160, 256, 256): 4,
                  (45, 80, 256, 512): 1, (45, 80, 512, 512): 2, (90, 160, 512, 256): 1,
                  (180, 320, 256, 128): 1, (360, 640, 128, 64): 1, (360, 640, 64, 256): 1}
V1_CLIP_T = 60


def _v1_layer_shapes() -> dict:
    """``V1_CONV_SHAPES`` as ``models/tracknet_v1`` builds the forward."""
    from tracknetv3_tpu_torch.models import tracknet_v1 as v1

    out, h, w = {}, v1.HEIGHT, v1.WIDTH
    for ci, co, after in v1.layer_channels():
        out[(h, w, ci, co)] = out.get((h, w, ci, co), 0) + 1
        h, w = (h // 2, w // 2) if after == "pool" else (h * 2, w * 2) if after == "up" else (h, w)
    return out


def _v1_conv_check_shape(c3, shape, seed: int, dev, timed: bool) -> dict:
    """v1_conv_vs_plain at one (N, H, W, Ci, Co): both variants with a
    random ``scale`` and ``shift`` against ``conv3x3_bias_relu_plain`` with
    the same, and the wrong order; with ``timed`` v1_conv_times' row too."""
    import torch

    from tracknetv3_tpu_torch.models import fused_forward as ff

    N, H, W, Ci, Co = shape
    x, k, bias = _conv_data(N, H, W, Ci, Co, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    scale = 0.5 + torch.rand((Co,), generator=g, device=dev)
    shift = 0.5 * torch.randn((Co,), generator=g, device=dev)
    packed = c3.pack_weights(k, torch.bfloat16, device=dev)
    want = c3.conv3x3_bias_relu_plain(x, packed, bias, scale=scale, shift=shift)
    outs = {v: c3.conv3x3_bias_relu(x, packed, bias, variant=v, scale=scale, shift=shift)
            for v in CONV_VARIANTS}
    torch.cuda.synchronize()
    res = {"phase": "v1_conv_vs_plain", "shape_NHWC": [N, H, W, Ci], "Co": Co,
           "padded_Ci": x.shape[1], **{v: _conv_compare(o, want, x) for v, o in outs.items()},
           "k3c_equals_9tap": bool(torch.equal(outs["k3c"].view(torch.int16),
                                               outs["9tap"].view(torch.int16)))}
    bad = [f"{v}: {res[v]}" for v, o in outs.items()
           if not (_conv_sound(res[v]) and o.is_contiguous(memory_format=torch.channels_last)
                   and tuple(o.shape) == (N, Co, H, W))]
    # the wrong order: the affine map before the ReLU, on two samples
    # without NaN or inf
    lo = min(1, N - 1)
    xs, ws = x[lo : lo + 2], want[lo : lo + 2].float()
    wf = c3.conv3x3_bias_relu_plain(xs, packed, bias, relu=False).float()
    wrong = torch.relu(wf * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1))
    floor = CONV_FLOOR_OF_RMS * float(ws.square().mean().sqrt())
    res["wrong_order_ulps_apart"] = c3.bf16_ulps_apart(wrong.to(torch.bfloat16), ws, floor)
    if not res["k3c_equals_9tap"]:
        bad.append("k3c and 9tap differ")
    if res["wrong_order_ulps_apart"] <= CONV_ULPS_BOUND:
        bad.append(f"the bound passes the wrong order ({res['wrong_order_ulps_apart']})")
    del want, outs, wf, wrong, ws
    if timed:
        # three copies of x rotate so that each call reads cold data
        xr = [torch.nan_to_num(x)] + [torch.nan_to_num(x).contiguous(
            memory_format=torch.channels_last) for _ in range(2)]
        ms = {v: time_launches(lambda i, v=v: c3.conv3x3_bias_relu(
            xr[i % 3], packed, bias, variant=v, scale=scale, shift=shift), n=10, windows=3)
            for v in CONV_VARIANTS}
        relu_only_ms = time_launches(lambda i: c3.conv3x3_bias_relu(
            xr[i % 3], packed, bias, variant="9tap"), n=10, windows=3)
        plain_ms = time_launches(lambda i: c3.conv3x3_bias_relu_plain(
            xr[i % 3], packed, bias, scale=scale, shift=shift), n=2, windows=3)
        w = k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        xc = [t[:, :Ci].contiguous(memory_format=torch.channels_last) for t in xr]
        cudnn_ms = time_launches(lambda i: ff._conv_relu_affine(
            xc[i % 3], w, bias, scale, shift, "cudnn"), n=10, windows=3)
        flops = 2 * N * H * W * 9 * Ci * Co
        b_ms, b_by = bound_ms(2 * (N * H * W * (Ci + Co) + 9 * Ci * Co) + 12 * Co, flops,
                              BF16_FLOPS)
        res.update({"ms": ms, "relu_only_9tap_ms": relu_only_ms, "plain_ms": plain_ms,
                    "cudnn_with_epilogue_ms": cudnn_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "gflop": flops / 1e9,
                    "share_of_bound": {v: b_ms / t for v, t in ms.items()}})
        del xr, xc
    emit(res, detail=True)
    del x
    torch.cuda.empty_cache()
    if bad:
        fail("v1_conv_vs_plain", f"{shape}: " + "; ".join(bad))
    return res


def phase_v1(tmp: str, card: str, timed: bool = False) -> None:
    """v1_conv_vs_plain and v1_serve (the module docstring); with ``timed``
    (``--v1_only``) v1_conv_times too."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    dev = torch.device(DEVICE)
    if _v1_layer_shapes() != V1_CONV_SHAPES:
        fail("v1_conv_vs_plain", f"V1_CONV_SHAPES is not the model's: {_v1_layer_shapes()}")
    torch.backends.cudnn.benchmark = True  # the yardstick picks its fastest algorithms
    checked = [_v1_conv_check_shape(c3, (CONV_BATCH, H, W, Ci, Co), 80 + i, dev, timed)
               for i, (H, W, Ci, Co) in enumerate(V1_CONV_SHAPES)]
    emit({"phase": "v1_conv_vs_plain", "batch": CONV_BATCH, "shapes": len(checked),
          "layers": sum(V1_CONV_SHAPES.values()), "bound_ulps": CONV_ULPS_BOUND,
          "worst_ulps_apart": max(r[v]["ulps_apart"] for r in checked for v in CONV_VARIANTS),
          "max_unequal_share": max(r[v]["unequal_share"] for r in checked
                                   for v in CONV_VARIANTS),
          "k3c_equals_9tap_everywhere": all(r["k3c_equals_9tap"] for r in checked),
          "min_wrong_order_ulps_apart": min(r["wrong_order_ulps_apart"] for r in checked)})
    if timed:
        layers = list(V1_CONV_SHAPES.values())
        tot = {key: sum(n * r[key] for n, r in zip(layers, checked))
               for key in ("relu_only_9tap_ms", "plain_ms", "cudnn_with_epilogue_ms",
                           "bound_ms", "gflop")}
        tot.update({f"{v}_ms": sum(n * r["ms"][v] for n, r in zip(layers, checked))
                    for v in CONV_VARIANTS})
        emit({"phase": "v1_conv_times", "what": f"the {sum(layers)} 3x3 convs of one TrackNetV1 "
              f"forward at batch {CONV_BATCH}, bf16, ReLU -> affine epilogue, ms summed", **tot,
              "tflops": {v: tot["gflop"] / tot[f"{v}_ms"] for v in CONV_VARIANTS},
              "per_shape": [{"H": r["shape_NHWC"][1], "W": r["shape_NHWC"][2],
                             "Ci": r["shape_NHWC"][3], "Co": r["Co"], "layers": n,
                             **{f"{v}_ms": r["ms"][v] for v in CONV_VARIANTS},
                             "relu_only_9tap_ms": r["relu_only_9tap_ms"],
                             "plain_ms": r["plain_ms"],
                             "cudnn_with_epilogue_ms": r["cudnn_with_epilogue_ms"],
                             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                            for n, r in zip(layers, checked)]})
    _v1_serve_child(tmp)


V1_SERVE_CHILD_S = 300  # v1_serve's process: its time limit
V1_SERVE_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
cs._v1_serve({tmp!r})
"""


def _v1_serve_child(tmp: str) -> None:
    """v1_serve in a process of its own, its lines passed on. Its predict
    CLI runs with ``--profile``, and a torch.profiler session started later
    in a process that has already profiled can miss kernels (a device
    launch count of 0 or 0.9 where 1 is right), which would break
    ``_device_kernels``' counts in the phases after this one."""
    p = subprocess.run([sys.executable, "-c", V1_SERVE_CHILD.format(root=ROOT, tmp=tmp)],
                       capture_output=True, text=True, timeout=V1_SERVE_CHILD_S, cwd=ROOT)
    sys.stdout.write(p.stdout)
    sys.stdout.flush()
    if p.returncode != 0:
        fail("v1_serve", f"its process exited {p.returncode}: {p.stderr[-3000:]}")


def _v1_serve(tmp: str) -> None:
    """v1_serve (the module docstring)."""
    import torch

    from tracknetv3_tpu_torch import inference as tinf
    from tracknetv3_tpu_torch import predict as tpredict
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    model = get_model("TrackNetV1", generator=torch.Generator().manual_seed(7))
    ckpt = os.path.join(tmp, "TrackNetV1_best.pt")
    save_checkpoint(ckpt, epoch=0, max_val_acc=0.0, model=model,
                    param_dict={"model_name": "TrackNetV1", "seq_len": 3, "bg_mode": "",
                                "height": 360, "width": 640})
    src = os.path.join(tmp, "v1_clip.mp4")
    videos = {src: (V1_CLIP_T, _Scene(11), None)}
    rows, res = {}, {"phase": "v1_serve", "frames": V1_CLIP_T}
    chunks = -(-(V1_CLIP_T - 2) // 16)
    with mock.patch.object(tinf, "open_video", synthetic_reader(videos)):
        for backend in ("hand_9tap", "hand_k3c"):
            out = os.path.join(tmp, f"v1_{backend}")
            _zero_launches()
            t0 = time.time()
            tpredict.main(["--video_file", src, "--tracknet_file", ckpt, "--save_dir", out,
                           "--cv2_decode", "--conv_backend", backend, "--profile", out])
            with open(os.path.join(out, "spans.json")) as f:
                spans = json.load(f)
            with open(os.path.join(out, "v1_clip_ball.csv")) as f:
                rows[backend] = list(csv.DictReader(f))
            variant = backend[len("hand_"):]
            res[backend] = {"s": time.time() - t0, "counters": spans["counters"],
                            "classify_spans": spans["spans"].get("serve::classify", {}).get("n"),
                            "visible": sum(int(r["Visibility"]) for r in rows[backend])}
            want = {f"launch.conv3x3_{variant}": 18 * chunks,
                    "launch.conv3x3_relu_affine": 18 * chunks, "launch.decode_peak": chunks}
            got = {k2: spans["counters"].get(k2) for k2 in want}
            if got != want or res[backend]["classify_spans"] != chunks:
                fail("v1_serve", f"{backend}: launches {got} (want {want}), serve::classify "
                     f"{res[backend]['classify_spans']} (want {chunks})")
    first = rows["hand_9tap"]
    res["rows_equal"] = first == rows["hand_k3c"]
    res["first_two_invisible"] = all(r["Visibility"] == "0" for r in first[:2])
    emit(res)
    if len(first) != V1_CLIP_T or not res["rows_equal"] or not res["first_two_invisible"]:
        fail("v1_serve", f"{len(first)} rows, {res}")


def phase_conv_ablate():
    """conv_ablate: the ablation probe's variants at its shape. ``full`` and
    ``full-9mm`` are the two kernels (held to plain); the partial variants
    run products on zeroed shared memory and are timings only."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    dev = torch.device(DEVICE)
    N, H, W, Ci, Co = ABLATE_SHAPE
    x, k, _ = _conv_data(N, H, W, Ci, Co, 70, dev)
    packed = c3.pack_weights(k, torch.bfloat16, device=dev)
    want = c3.conv3x3_bias_relu_plain(x, packed, None, relu=False)
    calls = {"full": lambda: c3.conv3x3_bias_relu(x, packed, None, variant="k3c", relu=False),
             "full-9mm": lambda: c3.conv3x3_bias_relu(x, packed, None, variant="9tap",
                                                      relu=False)}
    for name in c3.ABLATION_VARIANTS:
        calls[name] = lambda name=name: c3.conv3x3_ablation(x, packed, variant=name)
    flops = 2 * N * H * W * 9 * Ci * Co
    res = {"phase": "conv_ablate", "shape_NHWC": [N, H, W, Ci], "Co": Co,
           "gflop": flops / 1e9, "variants": {}}
    bad = []
    for name, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        ms = time_launches(lambda i: call(), n=10, windows=3)
        res["variants"][name] = {"ms": ms, "share_of_bf16_peak": flops / (ms * 1e-3) / BF16_FLOPS}
        if name in ("full", "full-9mm"):
            cmp = _conv_compare(out, want, x)
            emit({"phase": "conv_ablate", "variant": name, "vs_plain": cmp}, detail=True)
            res["variants"][name]["ulps_apart"] = cmp["ulps_apart"]
            if not _conv_sound(cmp):
                bad.append(f"{name}: {cmp}")
    # the plain version, cuDNN alone and the bound at the same shape
    import torch.nn.functional as F

    w = k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    torch.backends.cudnn.benchmark = True
    res["plain_ms"] = time_launches(
        lambda i: c3.conv3x3_bias_relu_plain(x, packed, None, relu=False), n=2, windows=3)
    res["cudnn_ms"] = time_launches(lambda i: F.conv2d(x, w, padding=1), n=10, windows=3)
    res["bound_ms"], res["bound_by"] = bound_ms(
        2 * (N * H * W * (Ci + Co) + 9 * Ci * Co), flops, BF16_FLOPS)
    emit(res)
    if bad:
        fail("conv_ablate", "; ".join(bad))


def synthetic_video(T: int, seed: int):
    """(T, H, W, 3) RGB uint8 frames drawn as ``write_synthetic_dataset``
    draws a rally (seeded textured background, a bright disk of radius 4
    on a parabolic arc, one 40-frame pass after another; ``_Scene``) and
    the disk's (x, y) per frame."""
    scene = _Scene(seed)
    frames = np.stack([scene.frame(t, W, H) for t in range(T)])
    return frames, np.asarray([scene.center(t, W, H) for t in range(T)])


def phase_serve(tmp: str):
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import conv3x3 as c3
    from tracknetv3_tpu_torch.ops import detect as dt
    from tracknetv3_tpu_torch.ops import pool_up2x as pu
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint
    from tracknetv3_tpu_torch.utils.io import write_pred_csv

    tn = os.path.join(tmp, "exp", "TrackNet_best.pt")  # written by phase_slice
    inp = os.path.join(tmp, "InpaintNet_seed17.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0,
                    model=get_model("InpaintNet", generator=torch.Generator().manual_seed(17)),
                    param_dict={"model_name": "InpaintNet", "seq_len": 16})
    frames, centers = synthetic_video(SERVE_T, seed=21)
    torch.backends.cudnn.benchmark = True  # as the predict CLI sets it
    tn_detect = detecting_checkpoint(tn, frames, os.path.join(tmp, "TrackNet_detect.pt"))
    launches_by, cpu_staged = {}, {}
    for backend, bs, T in SERVE_RUNS:
        video, track = frames[:T], centers[:T]
        p = TrackNetPredictor(tn, inp, batch_size=bs, device=DEVICE,
                              conv_backend=backend)  # weight, bf16
        csv_path = os.path.join(tmp, f"serve_{backend}_b{bs}_ball.csv")

        def once():
            t0 = time.perf_counter()
            staged = p.stage_frames(video)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred = p.run_staged(staged)  # ends in the one fetch
            t2 = time.perf_counter()
            pred = p.inpaint_trajectory(pred, (W, H))
            write_pred_csv(pred, csv_path)
            t3 = time.perf_counter()
            return pred, t2 - t1, t3 - t0

        once()  # warm-up: cuDNN autotuning, allocator growth
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_s, e2e_s = [], []
        for i in range(2):
            if i == 0:  # counts of this run only
                _zero_launches()
            pred, r, e = once()
            if i == 0:
                launches = _launches(pu, c3, dt)
            run_s.append(r)
            e2e_s.append(e)
        peak = torch.cuda.max_memory_allocated()
        chunks = -(-(T - L + 1) // bs)
        with open(csv_path) as f:
            n_rows = sum(1 for _ in f) - 1
        xs, ys, vis = (np.asarray(pred[k]) for k in ("X", "Y", "Visibility"))
        inside = bool(((xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)).all())
        hit = (vis == 1) & (np.abs(xs - track[:, 0]) <= 4) & (np.abs(ys - track[:, 1]) <= 4)
        res = {"phase": "serve", "conv_backend": backend, "batch_size": bs, "frames": T,
               "chunks": chunks, "launches": launches, "csv_rows": n_rows,
               "inside_frame": inside,
               "visible_frames": int(vis.sum()), "within_4px_of_disk": int(hit.sum()),
               "run_fps": T / statistics.median(run_s),
               "e2e_fps": T / statistics.median(e2e_s),
               "run_s": run_s, "e2e_s": e2e_s, "peak_mem_bytes": peak}
        emit(res)
        want = {"maxpool2x2": 3 * chunks, "up2x_nearest": 3 * chunks,
                "conv3x3_k3c": CONV_LAYERS * chunks * (backend == "hand_k3c"),
                "conv3x3_9tap": CONV_LAYERS * chunks * (backend == "hand_9tap"),
                "decode_peak": chunks + 1}  # a chunk's frames, then the flush
        if n_rows != T:
            fail("serve", f"{backend} batch {bs}: {n_rows} CSV rows != {T}")
        if launches != want:
            fail("serve", f"{backend} batch {bs}: launches {launches} != {want} "
                 f"({chunks} chunks)")
        if not inside:
            fail("serve", f"{backend} batch {bs}: a coordinate lies outside the {W}x{H} frame")
        launches_by[backend, bs] = launches
        del p
        serve_vs_cpu(tn_detect, inp, video[:SERVE_REPLAY_T], track[:SERVE_REPLAY_T], bs,
                     backend, cpu_staged)
        torch.cuda.empty_cache()
    return launches_by, frames


def _unfolded(tn: str, dtype):
    """The checkpoint's TrackNet in eval mode on the card (cuDNN, BatchNorm
    after each conv, torch pool and upsample): the plain serving forward."""
    import torch

    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

    model, _ = load_model_from_checkpoint(tn, dtype=dtype)
    return model.to(DEVICE, memory_format=torch.channels_last).eval()


def _row(pred, t):
    return pred["X"][t], pred["Y"][t], pred["Visibility"][t]


def _inpaint_vs_cpu(p, cpu, traj):
    """InpaintNet on the card and on the CPU over one trajectory: (frames
    masked for inpainting, unmasked frames that differ, masked frames
    that differ by more than 1 px or in visibility)."""
    from tracknetv3_tpu_torch.ops.postprocess import generate_inpaint_mask

    got = p.inpaint_trajectory(traj, (W, H))
    want = cpu.inpaint_trajectory(traj, (W, H))
    mask = generate_inpaint_mask(traj, th_h=H * 0.05)  # inpaint_trajectory's th_h
    off_mask = far = 0
    for t, m in enumerate(mask):
        (gx, gy, gv), (wx, wy, wv) = _row(got, t), _row(want, t)
        if not m:
            off_mask += (gx, gy, gv) != (wx, wy, wv)
        else:
            far += abs(gx - wx) > 1 or abs(gy - wy) > 1 or gv != wv
    return sum(mask), off_mask, far


def detecting_checkpoint(tn: str, frames: np.ndarray, path: str) -> str:
    """The trained TrackNet with its predictor's bias lowered so that the
    top 1% of the logits of the video's first 16 windows pass 0.5: heatmaps
    as sparse as a trained model's, so that the rows ``serve_vs_cpu``
    compares hold detections whatever a 26-step training learnt."""
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.fused_forward import tracknet_fused_forward
    from tracknetv3_tpu_torch.ops.preprocess import make_staged_preprocessor
    from tracknetv3_tpu_torch.training.checkpoint import (
        load_model_from_checkpoint,
        save_checkpoint,
    )

    p = TrackNetPredictor(tn, batch_size=16, device=DEVICE)
    staged = p.stage_frames(frames)
    pre = make_staged_preprocessor(p.bg_mode, L, False, out_dtype=p.compute_dtype)
    with torch.inference_mode():
        x = pre(staged.buf, staged.median, torch.arange(16, device=DEVICE))
        logits = tracknet_fused_forward(p.params, x, apply_sigmoid=False).flatten()
        cut = float(torch.topk(logits, logits.numel() // 100).values[-1])
    model, pd = load_model_from_checkpoint(tn, dtype=torch.float32)
    with torch.no_grad():
        model.predictor.bias -= cut
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model, param_dict=pd)
    return path


def serve_vs_cpu(tn: str, inp: str, frames: np.ndarray, centers: np.ndarray,
                 bs: int, backend: str, cpu_staged: dict) -> None:
    """One more served run on the card (bf16, the kernels) with each
    chunk's window probabilities copied to the host and held to the
    unfolded TrackNet on the same input; then a CPU predictor replays those
    probabilities through its ``run_staged`` and ``inpaint_trajectory``,
    which must give the card's rows. The CPU's staged video (its median
    over every frame) depends on the frames alone: it is made at the first
    call and kept in ``cpu_staged`` for the others."""
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor

    T = len(frames)
    p = TrackNetPredictor(tn, inp, batch_size=bs, device=DEVICE, conv_backend=backend)
    t0 = time.time()
    model = _unfolded(tn, torch.bfloat16)
    forward = p._windows
    host_probs, gaps = [], []

    def recording(pre, buf, med, starts):
        probs = forward(pre, buf, med, starts)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=False, deterministic=cudnn.deterministic,
                         allow_tf32=False):  # one pass: autotuning costs more than it saves
            ref = torch.sigmoid(model(pre(buf, med, starts).permute(0, 3, 1, 2)))
        d = (probs - ref).abs()
        gaps.append((float(d.max()), float(d.mean())))
        host_probs.append(probs.cpu())
        return probs

    p._windows = recording
    card = p.run_staged(p.stage_frames(frames))
    del model
    card_s = time.time() - t0

    cpu = TrackNetPredictor(tn, inp, batch_size=bs, device="cpu")
    replay = iter(host_probs)
    cpu._windows = lambda pre, buf, med, starts: next(replay)
    if T not in cpu_staged:
        cpu_staged[T] = cpu.stage_frames(frames)
    want = cpu.run_staged(cpu_staged[T])
    differ = [t for t in range(T) if _row(card, t) != _row(want, t)]
    # InpaintNet over the served rows, and over the disk's drawn track with
    # an occlusion cut into every 40-frame pass (frames 12-15, as in the
    # training data), so that its own output reaches the rows
    occluded = {"Frame": list(range(T)), "X": [int(v) for v in centers[:, 0]],
                "Y": [int(v) for v in centers[:, 1]], "Visibility": [1] * T}
    for t in range(T):
        if 12 <= t % 40 < 16:
            occluded["X"][t] = occluded["Y"][t] = occluded["Visibility"][t] = 0
    inpaint = {name: dict(zip(("masked", "unmasked_differ", "masked_differ_over_1px"),
                              _inpaint_vs_cpu(p, cpu, traj)))
               for name, traj in (("served", card), ("occluded", occluded))}
    bound, mean_bound = SERVE_PARITY_BOUNDS["bfloat16"]
    worst = max(g[0] for g in gaps), max(g[1] for g in gaps)
    visible = sum(card["Visibility"])
    emit({"phase": "serve_vs_cpu", "conv_backend": backend, "batch_size": bs,
          "chunks": len(gaps),
          "bf16_max_abs_prob_err": worst[0], "bf16_mean_abs_prob_err_worst_chunk": worst[1],
          "bound": bound,
          "mean_bound": mean_bound, "rows": T, "visible_rows": visible,
          "rows_differ": len(differ),
          "first_differ": differ[:5], "inpaint": inpaint, "card_s": card_s,
          "cpu_s": time.time() - t0 - card_s})
    emit({"phase": "serve_vs_cpu", "conv_backend": backend, "batch_size": bs,
          "bf16_chunk_max_errs": [g[0] for g in gaps]}, detail=True)
    if not (worst[0] <= bound and worst[1] <= mean_bound):
        fail("serve_vs_cpu", f"{backend} batch {bs}: a chunk's forward is off the unfolded "
             f"model by max {worst[0]} / mean {worst[1]} (bounds {bound} / {mean_bound})")
    if not visible:
        fail("serve_vs_cpu", f"{backend} batch {bs}: no detection in the rows compared")
    if differ:
        fail("serve_vs_cpu", f"{backend} batch {bs}: {len(differ)} rows differ from the CPU's, "
             f"first {differ[:5]}")
    for name, r in inpaint.items():
        if r["unmasked_differ"] or r["masked_differ_over_1px"]:
            fail("serve_vs_cpu", f"{backend} batch {bs}: InpaintNet on {name} rows: {r}")
    if not inpaint["occluded"]["masked"]:
        fail("serve_vs_cpu", f"{backend} batch {bs}: no frame was masked for inpainting")


@contextlib.contextmanager
def wrong_forward(name: str):
    """The folded forward with one deliberate fault, for the upper readings
    of the bf16 parity bound: ``pool<n>_stride2`` takes the n-th pool as a
    stride-2 slice, ``up<n>_tiled`` tiles the n-th upsample instead of
    interleaving it, ``bias_after_cast`` adds each 3x3 conv's bias in
    bfloat16 (a rounding, not a fault: read, not held to the bound)."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.models import fused_forward as ff

    saved = {k: getattr(ff, k) for k in ("maxpool2x2", "up2x_nearest", "_conv_relu")}
    calls = {"pool": 0, "up": 0}
    kind = name.split("_")[0]  # pool<n>, up<n> or bias
    nth = int(kind[-1]) if kind[-1].isdigit() else 0

    def pool(x):
        calls["pool"] += 1
        if calls["pool"] == nth:
            return x[:, :, ::2, ::2].contiguous(memory_format=torch.channels_last)
        return saved["maxpool2x2"](x)

    def up(x):
        calls["up"] += 1
        if calls["up"] == nth:
            return x.repeat(1, 1, 2, 2).contiguous(memory_format=torch.channels_last)
        return saved["up2x_nearest"](x)

    def conv_relu(x, w, b, backend="cudnn"):
        return torch.add(F.conv2d(x, w, padding=1), b.to(x.dtype)).relu_()

    attr, fn = {"pool": ("maxpool2x2", pool), "up": ("up2x_nearest", up),
                "bias": ("_conv_relu", conv_relu)}[kind.rstrip("0123456789")]
    setattr(ff, attr, fn)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ff, k, v)


def _parity(out, ref, bound: float, mean_bound: float) -> dict:
    """|dp| of a forward against the reference probabilities, and whether it
    is within the (max, mean) bound."""
    d = (out - ref).abs()
    err, mean = float(d.max()), float(d.mean())
    return {"max": err, "mean": mean, "flips": int(((out > 0.5) != (ref > 0.5)).sum()),
            "within_bound": err <= bound and mean <= mean_bound}


def deterministic_checkpoint(tmp: str):
    """The serve cell's TrackNet trained as ``phase_slice`` trains it (the
    README configuration, 2 epochs of the synthetic dataset, seed 13), but
    through ``training.loop.train`` with cuDNN's autotuning off,
    deterministic algorithms and TF32 off. The train CLI turns autotuning
    on, and with it the checkpoint, and a wrong forward's reading on it,
    change from run to run; this one repeats, and so do serve_parity's
    margins. Returns its path and a SHA-256 of its parameters."""
    import hashlib

    import torch

    from tracknetv3_tpu_torch.config import TrainConfig
    from tracknetv3_tpu_torch.training.loop import train

    save_dir = os.path.join(tmp, "exp_deterministic")
    cfg = TrainConfig(seq_len=L, bg_mode="concat", alpha=0.5, batch_size=B, epochs=2,
                      save_dir=save_dir)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False), \
                contextlib.redirect_stdout(sys.stderr):
            model = train(cfg, data_dir=os.path.join(tmp, "data"), device=DEVICE)["model"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode() + v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return os.path.join(save_dir, "TrackNet_best.pt"), digest.hexdigest()


def phase_serve_parity(tmp: str, frames: np.ndarray) -> None:
    import torch

    from tracknetv3_tpu_torch.device import tf32_off
    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.fused_forward import tracknet_fused_forward
    from tracknetv3_tpu_torch.ops.preprocess import make_staged_preprocessor

    dev = torch.device(DEVICE)
    t0 = time.time()
    tn, digest = deterministic_checkpoint(tmp)
    emit({"phase": "serve_parity", "checkpoint": "trained with deterministic cuDNN, no "
          "autotuning, TF32 off", "params_sha256": digest, "train_s": time.time() - t0})
    torch.backends.cudnn.benchmark = False  # one chunk each: autotuning costs more than it saves
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        # the cudnn route, with the faults patched into it; the hand routes beside
        p = TrackNetPredictor(tn, batch_size=16, compute_dtype=dtype, device=dev,
                              conv_backend="cudnn")
        staged = p.stage_frames(frames)
        pre = make_staged_preprocessor(p.bg_mode, L, False, out_dtype=dtype)
        model = _unfolded(tn, dtype)
        bound, mean_bound = SERVE_PARITY_BOUNDS[name]
        variants = ("folded",)
        hand = {}  # the folded weights packed for each hand conv backend
        if name == "bfloat16":
            variants += WRONG_FORWARDS + ("bias_after_cast",)
            hand = {b: TrackNetPredictor(tn, batch_size=16, compute_dtype=dtype, device=dev,
                                         conv_backend=b).params for b in HAND_BACKENDS}
        worst = {}  # variant -> (max, mean) |dp| over the chunks; the wrong ones: the least
        for s in PARITY_STARTS:
            res = {}
            with torch.inference_mode(), tf32_off():
                x = pre(staged.buf, staged.median, s + torch.arange(16, device=dev))
                ref = torch.sigmoid(model(x.permute(0, 3, 1, 2)))
                for v in variants:
                    with contextlib.nullcontext() if v == "folded" else wrong_forward(v):
                        out = tracknet_fused_forward(p.params, x).permute(0, 3, 1, 2)
                    res[v] = _parity(out, ref, bound, mean_bound)
                    if v == "folded":
                        cudnn_out = out
                for b, params in hand.items():
                    out = tracknet_fused_forward(params, x).permute(0, 3, 1, 2)
                    res[b] = _parity(out, ref, bound, mean_bound)
                    res[b]["max_vs_cudnn_route"] = float((out - cudnn_out).abs().max())
            emit({"phase": "serve_parity", "windows": [s, s + 16], "dtype": name,
                  "tf32": False, "max_abs_prob_err": res["folded"]["max"],
                  "mean_abs_prob_err": res["folded"]["mean"],
                  "threshold_flips": res["folded"]["flips"], "pixels": out.numel(),
                  "bound": bound, "mean_bound": mean_bound,
                  "hand_backends": {b: res[b] for b in hand},
                  "wrong_forwards": {v: r for v, r in res.items()
                                     if v != "folded" and v not in hand}}, detail=True)
            for v, r in res.items():
                pick = min if v in WRONG_FORWARDS else max
                old = worst.get(v, (r["max"], r["mean"]))
                worst[v] = (pick(old[0], r["max"]), pick(old[1], r["mean"]))
            for v in ("folded",) + tuple(hand):
                if not res[v]["within_bound"]:
                    fail("serve_parity", f"{name} windows {s}-{s + 16}, {v}: max |dp| "
                         f"{res[v]['max']} (bound {bound}), mean {res[v]['mean']} "
                         f"(bound {mean_bound})")
            caught = [v for v in WRONG_FORWARDS if v in res and res[v]["within_bound"]]
            if caught:
                fail("serve_parity", f"{name} windows {s}-{s + 16}: the bound passes the "
                     f"wrong forwards {caught}")
        emit({"phase": "serve_parity", "dtype": name, "tf32": False,
              "chunks_of_16_windows": len(PARITY_STARTS), "bound": bound, "mean_bound": mean_bound,
              "max_and_mean_abs_prob_err": {
                  v: {"max": m[0], "mean": m[1],
                      "over_chunks": "least" if v in WRONG_FORWARDS else "worst",
                      **({"must_fail": True} if v in WRONG_FORWARDS else {})}
                  for v, m in worst.items()}})
        del p, staged, x, out, model, ref, hand


# ---------------------------------------------------------------- serving paths

PATHS_SRC = (1280, 720)  # source (width, height) of serve_paths' videos
PATHS_T = 480
PATHS_BATCH = 16  # the predict CLI's default
PATHS_MODES = ("weight", "nonoverlap")
PATHS_REPLAY_T = 160  # frames of the CPU replay (10 chunks): depth cut for time
PATHS_KERNELS = ("conv3x3_9tap", "maxpool2x2", "up2x_nearest")  # the default route's
# |card resize - float64 resize| in grey levels: the sound float32 resize and
# a TF32 one must fall on either side (PERF.md)
RESIZE_BOUND = 2e-3
# the batch: (name, frames, frame where reading fails); a wave holds 600
# model-resolution frames, so the waves are [480] and [300, 97, 33] with the
# failing video skipped in the second
BATCH_VIDEOS = (("b480", 480, None), ("b300", 300, None), ("bbad", 200, 100),
                ("b97", 97, None), ("b33", 33, None))
BATCH_WAVE_FRAMES = 600
MEDIAN_SAMPLES = 1800  # VideoReader.sample_frames' default max_sample_num


class _Scene:
    """A synthetic rally at any size: a seeded textured background and a
    bright disk (radius 4 at 512 wide, scaled) on a parabolic arc, one
    ``PERIOD``-frame pass after another. The frames repeat with the pass, so
    each of a pass's frames is drawn once per size and handed out read-only
    (drawing a 720p frame took 3.5 ms, a copy of it a tenth of that)."""

    PERIOD = 40

    def __init__(self, seed: int):
        self.seed = seed
        self._bg = {}
        self._frames = {}

    def center(self, t: int, w: int, h: int):
        u = (t % self.PERIOD) / (self.PERIOD - 1)
        return int(w * 0.1 + w * 0.8 * u), int(h * 0.7 - h * 0.5 * math.sin(math.pi * u))

    def frame(self, t: int, w: int, h: int) -> np.ndarray:
        key = (t % self.PERIOD, w, h)
        if key not in self._frames:
            if (w, h) not in self._bg:
                rng = np.random.default_rng(self.seed)
                bg = np.full((h, w, 3), (40, 90, 40), np.int32)
                self._bg[w, h] = (bg + rng.integers(0, 40, (h, w, 3))).astype(np.uint8)
            f = self._bg[w, h].copy()
            r = 4 * w / W
            x, y = self.center(t, w, h)
            y0, y1, x0, x1 = int(y - r), int(y + r) + 1, int(x - r), int(x + r) + 1
            dy, dx = np.mgrid[y0:y1, x0:x1]
            f[y0:y1, x0:x1][(dy - y) ** 2 + (dx - x) ** 2 <= r * r] = 255
            f.flags.writeable = False
            self._frames[key] = f
        return self._frames[key]

    def _derived(self, kind: str, t: int, w: int, h: int, make) -> np.ndarray:
        key = (kind, t % self.PERIOD, w, h)
        if key not in self._frames:
            f = make(self.frame(t, w, h))
            f.flags.writeable = False
            self._frames[key] = f
        return self._frames[key]

    def bgr(self, t: int, w: int, h: int) -> np.ndarray:
        """``frame`` with its channels reversed, contiguous."""
        return self._derived("bgr", t, w, h, lambda f: np.ascontiguousarray(f[..., ::-1]))

    def yuv420(self, t: int, w: int, h: int) -> np.ndarray:
        """``frame`` as a planar YUV420 row (``bt601_yuv420``)."""
        return self._derived("yuv420", t, w, h, bt601_yuv420)


def synthetic_reader(videos: dict):
    """A reader class with the port ``VideoReader``'s interface over the
    videos of ``videos`` ({path: (frames, scene, frame where reading
    fails or None)}), drawn in memory at ``PATHS_SRC``: the card's machine
    has no decoder. ``read_resized_bgr`` draws at the asked size (the
    staged path's frames); a read of the failing frame raises, except right
    after a seek (the median's sampling reads it). ``read_all`` and
    ``sample_frames`` are the port's own."""
    from tracknetv3_tpu_torch.utils.io import VideoReader

    class SyntheticReader(VideoReader):
        def __init__(self, path: str):
            self.path = path
            self.video_len, self.scene, self.fail_at = videos[path]
            self.fps = 30.0
            self.w, self.h = PATHS_SRC
            self.pos, self.sought = 0, False

        def _check(self, t: int) -> None:
            if t == self.fail_at:
                raise OSError(f"synthetic decode failure at frame {t} of {self.path}")

        def seek(self, frame_idx: int) -> None:
            self.pos, self.sought = frame_idx, True

        def read(self):
            if self.pos >= self.video_len:
                return None
            if not self.sought:
                self._check(self.pos)
            self.sought = False
            self.pos += 1
            return self.scene.frame(self.pos - 1, self.w, self.h)

        def read_resized_bgr(self, width: int, height: int) -> np.ndarray:
            out = np.empty((self.video_len, height, width, 3), np.uint8)
            for t in range(self.video_len):
                self._check(t)
                out[t] = self.scene.bgr(t, width, height)
            return out

        def release(self) -> None:
            pass

    return SyntheticReader


def disk_detector_checkpoint(path: str, seed: int) -> str:
    """The README TrackNet (seq_len 8, concat) from a seeded random init
    with one path set by hand so that it finds ``_Scene``'s disk: in the
    first and the last two conv layers, channel i (i < 8) is ReLU(frame i
    - median, summed over colours) at the centre tap, carried through
    unchanged, and the predictor maps it to frame i's logit (x10, -5). No
    other channel feeds those channels, so the random rest of the network
    (the pools, upsamples, the deep blocks) runs at full width beside it."""
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        first = model.down_block_1.conv_1.conv.weight  # (64, 3 + 3L, 3, 3)
        first[:L] = 0
        for i in range(L):
            first[i, 3 + 3 * i : 6 + 3 * i, 1, 1] = 1.0
            first[i, 0:3, 1, 1] = -1.0
        for conv, offset in ((model.down_block_1.conv_2.conv, 0),
                             (model.up_block_3.conv_1.conv, 128),  # [up2x(x), skip]
                             (model.up_block_3.conv_2.conv, 0)):
            conv.weight[:L] = 0
            for i in range(L):
                conv.weight[i, offset + i, 1, 1] = 1.0
        model.predictor.weight.zero_()
        for i in range(L):
            model.predictor.weight[i, i, 0, 0] = 10.0
        model.predictor.bias.fill_(-5.0)
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                    param_dict={"model_name": "TrackNet", "seq_len": L, "bg_mode": "concat"})
    return path


@contextlib.contextmanager
def _tf32_on():
    """The wrong resize: ``preprocess.tf32_off`` swapped for TF32 on."""
    import torch

    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    m.allow_tf32 = True
    try:
        yield
    finally:
        m.allow_tf32 = before


def _resize_f64(frames, hw):
    """PIL-bicubic resize of uint8 frames in float64 on the CPU, from the
    same float32 matrices."""
    import torch

    from tracknetv3_tpu_torch.ops.preprocess import _pil_bicubic_matrix

    h0, w0 = frames.shape[-3], frames.shape[-2]
    rh = torch.tensor(_pil_bicubic_matrix(h0, hw[0]), dtype=torch.float64)
    rw = torch.tensor(_pil_bicubic_matrix(w0, hw[1]), dtype=torch.float64)
    x = frames.cpu().movedim(-1, -3).double()
    return (rh @ x @ rw.t()).clamp(0, 255).movedim(-3, -1)


def _rows(pred):
    return list(zip(pred["X"], pred["Y"], pred["Visibility"]))


def _track_check(pred, scene, T: int):
    """(visible frames, visible frames farther than 4 model pixels from the
    disk, coordinates outside the source frame)."""
    sx, sy = PATHS_SRC[0] / W, PATHS_SRC[1] / H
    far = outside = 0
    for t, (x, y, v) in enumerate(_rows(pred)[:T]):
        if v:
            cx, cy = scene.center(t, *PATHS_SRC)
            far += abs(x - cx) > 4 * sx or abs(y - cy) > 4 * sy
            outside += not (0 <= x < PATHS_SRC[0] and 0 <= y < PATHS_SRC[1])
    return sum(pred["Visibility"][:T]), far, outside


def _chunks_of(T: int, mode: str, staged: bool = False) -> int:
    """Chunks TrackNet forwards for T frames at PATHS_BATCH: a chunk per
    PATHS_BATCH disjoint windows (nonoverlap), per PATHS_BATCH real windows
    (the staged overlap path), or per PATHS_BATCH frames (the stateless
    overlap steps of the resident and streaming paths)."""
    if mode == "nonoverlap":
        n = -(-T // L)
    else:
        n = max(T - L + 1, 1) if staged else T
    return -(-n // PATHS_BATCH)


def _want_launches(chunks: int):
    return {"conv3x3_9tap": CONV_LAYERS * chunks, "maxpool2x2": 3 * chunks,
            "up2x_nearest": 3 * chunks, "window_copy": 0}


def phase_serve_paths(tmp: str, card: str) -> dict:
    """serve_paths: device-resize, streaming and batch serving at full width
    on videos read from memory (``synthetic_reader`` at ``open_video``)."""
    import torch

    from tracknetv3_tpu_torch import inference as tinf
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import preprocess
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint
    from tracknetv3_tpu_torch.utils.io import write_pred_csv

    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True  # as the predict CLI sets it
    tn = disk_detector_checkpoint(os.path.join(tmp, "TrackNet_disk.pt"), seed=29)
    inp = os.path.join(tmp, "InpaintNet_paths.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0,
                    model=get_model("InpaintNet", generator=torch.Generator().manual_seed(17)),
                    param_dict={"model_name": "InpaintNet", "seq_len": 16})
    scene = _Scene(seed=21)
    src, failing = f"synthetic://720p_{PATHS_T}.mp4", "synthetic://720p_failing.mp4"
    long = f"synthetic://720p_{MEDIAN_SAMPLES}.mp4"  # the median at its default sample count
    videos = {src: (PATHS_T, scene, None),
              f"synthetic://720p_{2 * PATHS_T}.mp4": (2 * PATHS_T, scene, None),
              long: (MEDIAN_SAMPLES, scene, None),
              failing: (PATHS_T, scene, PATHS_T * 5 // 12)}  # 200 of 480
    batch = [f"synthetic://{name}.mp4" for name, _, _ in BATCH_VIDEOS]
    videos.update({f: (T, _Scene(seed=40 + i), fail)
                   for i, (f, (_, T, fail)) in enumerate(zip(batch, BATCH_VIDEOS))})
    decode = "synthetic, in memory"
    launches_by = {}
    out_dir = os.path.join(tmp, "serve_paths")
    dev = torch.device(DEVICE)

    def run_counted(fn):
        _zero_launches()
        out = fn()
        return out, _path_launches()

    with mock.patch.object(tinf, "open_video", synthetic_reader(videos)):
        # ---- 1. device_resize
        reader = tinf.open_video(src)
        t0 = time.perf_counter()
        frames = reader.read_all()  # what decode would hand over, not timed
        draw_s = time.perf_counter() - t0
        tn_rows = {}
        for mode in PATHS_MODES:
            t0 = time.perf_counter()
            pred, launches = run_counted(lambda: tinf.predict_video(
                src, tn, inp, eval_mode=mode, batch_size=PATHS_BATCH, device=DEVICE,
                device_resize=True, save_dir=out_dir, video_name=f"device_resize_{mode}"))
            entry_s = time.perf_counter() - t0  # the first call: the model load, cold memory
            p = tinf.TrackNetPredictor(tn, inp, eval_mode=mode, batch_size=PATHS_BATCH,
                                       device=DEVICE)  # bf16, hand_9tap, as predict_video's
            chunks = _chunks_of(PATHS_T, mode)
            with open(os.path.join(out_dir, f"device_resize_{mode}_ball.csv")) as f:
                n_rows = sum(1 for _ in f) - 1
            visible, far, outside = _track_check(pred, scene, PATHS_T)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run_s, e2e_s = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                buf, T = p.stage_resident(frames)
                med = p.median_of_resident(buf, T)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rows = p.run_resident(buf, T, med, (PATHS_SRC[0] / W, PATHS_SRC[1] / H))
                t2 = time.perf_counter()
                write_pred_csv(p.inpaint_trajectory(rows, PATHS_SRC),
                               os.path.join(tmp, "paths_timed_ball.csv"))
                t3 = time.perf_counter()
                run_s.append(t2 - t1)
                e2e_s.append(t3 - t0)
                del buf
            peak = torch.cuda.max_memory_allocated()
            tn_rows[mode] = rows
            buf, T = p.stage_resident(frames)
            median_ms = time_launches(lambda i: p.median_of_resident(buf, T), n=3, windows=3)
            span = buf[:PATHS_BATCH + 2 * L - 2]  # one overlap chunk's frames
            resize_ms = time_launches(lambda i: preprocess.resize_frames(span, H, W), n=10,
                                      windows=3)
            del buf, span
            buf, T = p.stage_resident(frames[:PATHS_REPLAY_T])
            replay = _replay_resident(p, tn, inp, buf, T, mode)
            del buf
            res = {"phase": "serve_paths", "case": "device_resize", "eval_mode": mode,
                   "decode": decode, "source_wh": list(PATHS_SRC), "frames": PATHS_T,
                   "batch_size": PATHS_BATCH, "conv_backend": p.params["conv_backend"],
                   "chunks": chunks, "launches": launches,
                   "launches_per_chunk": {k: launches[k] / chunks for k in PATHS_KERNELS},
                   "csv_rows": n_rows, "visible_frames": visible, "far_from_disk": far,
                   "outside_frame": outside, "run_fps": PATHS_T / statistics.median(run_s),
                   "e2e_fps": PATHS_T / statistics.median(e2e_s), "run_s": run_s,
                   "e2e_s": e2e_s, "median_ms": median_ms,
                   "resize_ms_per_chunk": resize_ms, "resize_chunk_frames": PATHS_BATCH + 2 * L - 2,
                   "peak_mem_bytes": peak, "replay": replay, "drawing_the_frames_s": draw_s,
                   "entry_point_s": entry_s,
                   "card": card}
            emit(res)
            if launches != _want_launches(chunks):
                fail("serve_paths", f"device_resize {mode}: launches {launches} != "
                     f"{_want_launches(chunks)}")
            if n_rows != PATHS_T or outside or far or visible < PATHS_T // 2:
                fail("serve_paths", f"device_resize {mode}: {n_rows} rows, {visible} visible, "
                     f"{far} farther than 4 px from the disk, {outside} outside the frame")
            if replay["rows_differ"]:
                fail("serve_paths", f"device_resize {mode}: rows differ from the CPU replay: "
                     f"{replay}")
            launches_by[f"device_resize {mode}"] = launches
            del p
        _resize_check(frames)
        del frames, reader

        # ---- 2. streaming (raw frames resized on the card; the kernels are warm)
        t0 = time.perf_counter()
        sampled = tinf.open_video(src).sample_frames()
        t1 = time.perf_counter()
        preprocess.median_of_host_frames(sampled, dev)
        torch.cuda.synchronize()
        median_s = {"sampling_s": t1 - t0, "median_s": time.perf_counter() - t1}  # a 480 run's
        del sampled
        sampled = tinf.open_video(long).sample_frames()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        preprocess.median_of_host_frames(sampled, dev)
        torch.cuda.synchronize()
        median_1800 = {"frames": len(sampled), "median_s": time.perf_counter() - t0,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated() - base,
                       "host_bytes": sampled.nbytes}
        del sampled
        for mode in PATHS_MODES:
            p = tinf.TrackNetPredictor(tn, eval_mode=mode, batch_size=PATHS_BATCH,
                                       device=DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pred, launches = run_counted(lambda: p.predict_video_streaming(src, host_resize=False))
            stream_s = time.perf_counter() - t0
            # the bounded-memory contract: this run's peak beside a 960-frame run's
            peaks = {PATHS_T: torch.cuda.max_memory_allocated()} if mode == "weight" else {}
            chunks = _chunks_of(PATHS_T, mode)
            want = _rows(tn_rows[mode])
            got = _rows(pred)
            differ = [t for t in range(PATHS_T) if got[t] != want[t]]
            over_1px = [t for t in differ if abs(got[t][0] - want[t][0]) > 1
                        or abs(got[t][1] - want[t][1]) > 1 or got[t][2] != want[t][2]]
            for T in (2 * PATHS_T,) if peaks else ():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                n = len(p.predict_video_streaming(f"synthetic://720p_{T}.mp4",
                                                  host_resize=False)["Frame"])
                peaks[T] = torch.cuda.max_memory_allocated()
                if n != T:
                    fail("serve_paths", f"streaming {mode}: {n} rows of {T} frames")
            failed = None
            csv_path = os.path.join(out_dir, f"stream_fail_{mode}_ball.csv")
            try:
                write_pred_csv(p.predict_video_streaming(failing, host_resize=False), csv_path)
            except RuntimeError as e:
                failed = f"{e} (from {type(e.__cause__).__name__}: {e.__cause__})"
            res = {"phase": "serve_paths", "case": "streaming", "eval_mode": mode,
                   "host_resize": False, "decode": decode, "frames": PATHS_T, "chunks": chunks,
                   "launches": launches, "frames_per_s": PATHS_T / stream_s, "seconds": stream_s,
                   "of_which_median": median_s,
                   "rows_differ_from_device_resize": len(differ),
                   "differ_by_more_than_1px": len(over_1px), "first_differ": differ[:5],
                   "peak_mem_bytes_by_frames": peaks,
                   "peak_ratio_960_to_480": (peaks[2 * PATHS_T] / peaks[PATHS_T]
                                             if peaks else None),
                   "median_samples_in_memory_runs": "every frame (max_sample_num "
                                                    f"{MEDIAN_SAMPLES})",
                   "median_over_1800_samples": median_1800,
                   "failing_reader": failed, "csv_written": os.path.exists(csv_path),
                   "host_resize_variant": "needs cv2: held on the CPU only "
                                          "(tests/test_torch_streaming.py)", "card": card}
            emit(res)
            if launches != _want_launches(chunks):
                fail("serve_paths", f"streaming {mode}: launches {launches} != "
                     f"{_want_launches(chunks)}")
            if over_1px:
                fail("serve_paths", f"streaming {mode}: rows {over_1px[:5]} differ from the "
                     "device_resize rows by more than 1 px")
            if peaks and not 0.9 <= res["peak_ratio_960_to_480"] <= 1.1:
                fail("serve_paths", f"streaming {mode}: peak memory grows with the video: {peaks}")
            if peaks and median_1800["peak_mem_bytes"] >= peaks[PATHS_T]:
                fail("serve_paths", f"streaming {mode}: the median over {MEDIAN_SAMPLES} frames "
                     f"takes {median_1800['peak_mem_bytes']} B, not below the stream's peak")
            if failed is None or res["csv_written"]:
                fail("serve_paths", f"streaming {mode}: a reader failing at frame 200 gave "
                     f"{failed!r}, CSV written: {res['csv_written']}")
            launches_by[f"streaming {mode}"] = launches
            del p

        # ---- 3. batch serving
        p = tinf.TrackNetPredictor(tn, inp, batch_size=PATHS_BATCH, device=DEVICE)
        fb = H * W * 3
        budget = 2 * BATCH_WAVE_FRAMES * fb
        good = [f for f, (_, _, fail_at) in zip(batch, BATCH_VIDEOS) if fail_at is None]
        tinf.predict_videos([good[-1]], tn, predictor=p)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        single, single_s, single_peak = {}, 0.0, 0
        for f in good:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            single[f] = tinf.predict_videos([f], tn, predictor=p)[f]
            single_s += time.perf_counter() - t0
            single_peak = max(single_peak, torch.cuda.max_memory_allocated() - base
                              - videos[f][0] * fb)
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got, launches = run_counted(lambda: tinf.predict_videos(
            batch, tn, predictor=p, staging_budget_bytes=budget, on_error="skip", stats=stats,
            save_dir=out_dir))
        batch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        peak_bound = budget + max(videos[f][0] for f in good) * fb + single_peak
        raised = None
        try:
            tinf.predict_videos(batch, tn, predictor=p, staging_budget_bytes=budget)
        except (RuntimeError, OSError) as e:
            raised = f"{type(e).__name__}: {e}"
        want_waves = [[batch[0]], [batch[1], batch[3], batch[4]]]
        want_buckets = [[videos[f][0] for f in w] for w in want_waves]
        chunks = sum(_chunks_of(videos[f][0], "weight", staged=True) for f in good)
        frames_total = sum(videos[f][0] for f in good)
        res = {"phase": "serve_paths", "case": "batch", "decode": decode,
               "videos": {f: videos[f][0] for f in batch}, "failing": batch[2],
               "staging_budget_frames": 2 * BATCH_WAVE_FRAMES,
               "waves": stats["waves"], "streaming": stats["streaming"],
               "results": sorted(got), "rows_equal_single": all(got.get(f) == single[f]
                                                                 for f in good),
               "raise_mode": raised, "chunks": chunks, "launches": launches,
               "frames_per_s": frames_total / batch_s,
               "sequential_frames_per_s": frames_total / single_s,
               "batch_vs_sequential": single_s / batch_s,
               "peak_mem_bytes_over_weights": peak, "peak_bound_bytes": peak_bound,
               "single_video_working_bytes": single_peak, "card": card}
        emit(res)
        if sorted(got) != sorted(good) or not res["rows_equal_single"]:
            fail("serve_paths", f"batch: results {sorted(got)} of {good}; rows equal to single "
                 f"calls: {res['rows_equal_single']}")
        if ([w["videos"] for w in stats["waves"]] != want_waves or stats["streaming"]
                or [w["slots"] for w in stats["waves"]] != [1, 1]
                or [w["buckets"] for w in stats["waves"]] != want_buckets):
            fail("serve_paths", f"batch: waves {stats['waves']} (want {want_waves}), "
                 f"streaming {stats['streaming']}")
        if raised is None:
            fail("serve_paths", "batch: on_error='raise' did not raise on the failing video")
        if launches != _want_launches(chunks):
            fail("serve_paths", f"batch: launches {launches} != {_want_launches(chunks)}")
        if peak > peak_bound:
            fail("serve_paths", f"batch: peak {peak} B over the weights > {peak_bound} B "
                 "(two waves, one video and a video's working memory)")
        launches_by["batch"] = launches
    return launches_by


def _replay_resident(p, tn: str, inp: str, buf, T: int, mode: str) -> dict:
    """One more ``run_resident`` with each chunk's window probabilities
    copied to the host; a CPU predictor replays them through its own
    ``run_resident`` (ensemble, decode, collect), whose rows must equal the
    card's."""
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor

    forward = p._forward_windows
    host = []

    def recording(frames, median, starts):
        probs = forward(frames, median, starts)
        host.append(probs.cpu())
        return probs

    p._forward_windows = recording
    try:
        med = p.median_of_resident(buf, T)
        card = p.run_resident(buf, T, med, (PATHS_SRC[0] / W, PATHS_SRC[1] / H))
    finally:
        del p._forward_windows
    cpu = TrackNetPredictor(tn, inp, eval_mode=mode, batch_size=PATHS_BATCH, device="cpu")
    replay = iter(host)
    cpu._forward_windows = lambda frames, median, starts: next(replay)
    dummy = torch.zeros((buf.shape[0], 1, 1, 3), dtype=torch.uint8)  # never read
    want = cpu.run_resident(dummy, T, None, (PATHS_SRC[0] / W, PATHS_SRC[1] / H))
    differ = [t for t in range(T) if _rows(card)[t] != _rows(want)[t]]
    return {"chunks": len(host), "rows": T, "visible": sum(card["Visibility"]),
            "rows_differ": len(differ), "first_differ": differ[:5]}


def _resize_check(frames) -> None:
    """The card's resize of one overlap chunk's 30 frames against a float64
    CPU resize of its first 4: within RESIZE_BOUND; the same resize with
    TF32 on must fall outside it."""
    import torch

    from tracknetv3_tpu_torch.ops import preprocess

    chunk = torch.from_numpy(frames[: PATHS_BATCH + 2 * L - 2]).to(DEVICE)
    ref = _resize_f64(chunk[:4], (H, W))
    sound = preprocess.resize_frames(chunk, H, W)
    with mock.patch.object(preprocess, "tf32_off", _tf32_on):
        wrong = preprocess.resize_frames(chunk, H, W)
    err = float((sound[:4].cpu().double() - ref).abs().max())
    err_tf32 = float((wrong[:4].cpu().double() - ref).abs().max())
    emit({"phase": "serve_paths", "case": "resize_vs_float64", "frames": 4,
          "chunk_frames": int(chunk.shape[0]), "source_wh": list(PATHS_SRC),
          "max_abs_err": err, "tf32_max_abs_err": err_tf32, "bound": RESIZE_BOUND,
          "tf32_must_fail": True})
    if not err <= RESIZE_BOUND:
        fail("serve_paths", f"the card's resize is {err} grey levels off float64 "
             f"(bound {RESIZE_BOUND})")
    if err_tf32 <= RESIZE_BOUND:
        fail("serve_paths", f"a TF32 resize ({err_tf32} off float64) passes the bound "
             f"{RESIZE_BOUND}")


# ---------------------------------------------------------------- YUV420 staging

YUV_T = 480  # frames of yuv_stage's video
YUV_SLAB = 120  # frames the native reader hands over at once, and the timed conversion's
YUV_FORMATS = ("yuv420", "bgr")
YUV_SEED = 31
YUV_NUMPY_FRAMES = 16  # frames of the slab the numpy version converts too: its time


def bt601_yuv420(rgb: np.ndarray) -> np.ndarray:
    """One (h, w, 3) RGB uint8 frame as a planar YUV420 row (Y[h*w],
    U[h/2*w/2], V[h/2*w/2]): the BT.601 limited-range forward transform in
    float64, chroma averaged over 2x2 blocks, rounded: what a decoder's
    4:2:0 output holds."""
    f = rgb.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    h, w = y.shape

    def pooled(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    return np.concatenate([np.clip(np.rint(p), 0, 255).astype(np.uint8).ravel()
                           for p in (y, pooled(u), pooled(v))])


def yuv420_to_rgb_np(flat: np.ndarray, h: int, w: int) -> np.ndarray:
    """The plain version of ``ops.preprocess.yuv420_to_rgb`` in numpy int64
    (``>>`` on negative numbers is numpy's arithmetic shift)."""
    T, yn, cn = flat.shape[0], h * w, (h // 2) * (w // 2)
    y = flat[:, :yn].reshape(T, h, w).astype(np.int64)

    def up(a):
        return np.repeat(np.repeat(flat[:, a:a + cn].reshape(T, h // 2, w // 2).astype(np.int64)
                                   - 128, 2, axis=1), 2, axis=2)

    c, d, e = 298 * (y - 16) + 128, up(yn), up(yn + cn)
    rgb = np.stack([(c + 409 * e) >> 8, (c - 100 * d - 208 * e) >> 8, (c + 516 * d) >> 8], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def synthetic_native_reader(videos: dict, opened: list):
    """``open_native_video`` over the videos of ``videos`` ({path: (frames,
    scene, unused)}), drawn in memory as ``synthetic_reader`` draws them: a
    reader with ``NativeVideoReader``'s interface that draws ``_Scene``
    frames at the asked (model) size and hands out planar YUV420 made from
    them (``bt601_yuv420``; each frame of a pass made once, ``_Scene``) for
    ``read_into_yuv``, the drawn BGR (or RGB) for ``read_into``. The source
    is ``PATHS_SRC``; an odd output size fails at the first YUV read, as
    the library does. Each reader it opens is appended to ``opened``."""

    class SyntheticNativeReader:
        def __init__(self, path, out_w, out_h, lowres=0, bgr=True):
            self.video_len, self.scene, _ = videos[path]
            self.out_w, self.out_h, self.bgr = out_w, out_h, bgr
            self.src_w, self.src_h = PATHS_SRC
            self.n_frames, self.fps, self.applied_lowres = self.video_len, 30.0, 0
            self.pos = 0

        def _fill(self, out, frame_of) -> int:
            n = min(len(out), self.video_len - self.pos)
            for i in range(n):
                out[i] = frame_of(self.pos + i)
            self.pos += n
            return n

        def read_into(self, out) -> int:
            draw = self.scene.bgr if self.bgr else self.scene.frame
            return self._fill(out, lambda t: draw(t, self.out_w, self.out_h))

        def read_into_yuv(self, out) -> int:
            if self.out_w % 2 or self.out_h % 2:
                raise RuntimeError("native video decode error (yuv420)")
            return self._fill(out, lambda t: self.scene.yuv420(t, self.out_w, self.out_h))

        def close(self) -> None:
            pass

    def open_native_video(path, out_w, out_h, lowres=0, bgr=True):
        if path not in videos:
            return None
        opened.append(SyntheticNativeReader(path, out_w, out_h, lowres, bgr))
        return opened[-1]

    return open_native_video


def _yuv_convert_check(card: str) -> dict:
    """``yuv420_to_rgb`` on the card against its CPU run and the numpy
    version, on seeded planes at the model size spanning 0..255 (a slab of
    dark luma under saturated chroma, so that c < 0 and both clips occur),
    one reader slab (the numpy version over its first ``YUV_NUMPY_FRAMES``,
    the dark ones among them); ms a slab beside the bytes bound."""
    import torch

    from tracknetv3_tpu_torch.ops.preprocess import yuv420_to_rgb

    rng = np.random.default_rng(YUV_SEED)
    flat = rng.integers(0, 256, (YUV_SLAB, H * W * 3 // 2), dtype=np.uint8)
    flat[:8, : H * W] = rng.integers(0, 16, (8, H * W), dtype=np.uint8)
    flat[:8, H * W:] = np.where(rng.random((8, H * W // 2)) < 0.5, 0, 255).astype(np.uint8)
    plain = yuv420_to_rgb_np(flat[:YUV_NUMPY_FRAMES], H, W)
    cpu = yuv420_to_rgb(torch.from_numpy(flat), H, W).numpy()
    dev = torch.from_numpy(flat).to(DEVICE)
    out = torch.empty((YUV_SLAB, H, W, 3), dtype=torch.uint8, device=DEVICE)
    got = yuv420_to_rgb(dev, H, W, out=out).cpu().numpy()
    y = flat[:, : H * W].astype(np.int64)
    ms = time_launches(lambda i: yuv420_to_rgb(dev, H, W, out=out), n=10, windows=5)
    n_bytes = YUV_SLAB * H * W * 3 // 2 + YUV_SLAB * H * W * 3  # planes read, RGB written
    bound, by = bound_ms(n_bytes, 0)
    res = {"phase": "yuv_stage", "case": "yuv420_to_rgb", "frames": YUV_SLAB,
           "hw": [H, W], "unequal_card_vs_cpu": int((got != cpu).sum()),
           "unequal_cpu_vs_numpy": int((cpu[:YUV_NUMPY_FRAMES] != plain).sum()),
           "numpy_frames": YUV_NUMPY_FRAMES,
           "c_negative": int((298 * (y - 16) + 128 < 0).sum()),
           "clipped_at_0": int((plain == 0).sum()), "clipped_at_255": int((plain == 255).sum()),
           "ms": ms, "bytes": n_bytes, "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / ms, "card": card}
    emit(res)
    if res["unequal_card_vs_cpu"] or res["unequal_cpu_vs_numpy"]:
        fail("yuv_stage", f"yuv420_to_rgb: card, CPU and numpy differ: {res}")
    if not (res["c_negative"] and res["clipped_at_0"] and res["clipped_at_255"]):
        fail("yuv_stage", f"yuv420_to_rgb: the planes miss c < 0 or a clip: {res}")
    return res


def _video_copy_ms(n_bytes: int, fmt: str):
    """(ms of one pinned host-to-card copy of a staged video's ``n_bytes``,
    ms of converting the video on the card, or None for BGR): device
    times of what YUV420 staging saves and what it adds."""
    import torch

    from tracknetv3_tpu_torch.ops.preprocess import yuv420_to_rgb

    host = torch.zeros(n_bytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n_bytes, dtype=torch.uint8, device=DEVICE)
    copy_ms = time_launches(lambda i: dev.copy_(host, non_blocking=True), n=3, windows=3)
    convert_ms = None
    if fmt == "yuv420":
        flat = dev.view(-1, H * W * 3 // 2)
        out = torch.empty((flat.shape[0], H, W, 3), dtype=torch.uint8, device=DEVICE)
        convert_ms = time_launches(lambda i: yuv420_to_rgb(flat, H, W, out=out), n=3, windows=3)
    return copy_ms, convert_ms


def _replay_yuv(p, tn: str, opened: list, src: str, T: int) -> dict:
    """One YUV420-staged run of ``src`` (T frames) with each chunk's window
    probabilities copied to the host; a CPU predictor stages the same
    planes (read again from the stand-in reader the run opened, the last of
    ``opened``), converts them and
    replays the probabilities through its ``run_staged``: its staged
    frames, median and rows must equal the card's."""
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor

    forward, host = p._windows, []

    def recording(pre, buf, med, starts):
        probs = forward(pre, buf, med, starts)
        host.append(probs.cpu())
        return probs

    p._windows = recording
    try:
        staged = p.finalize_staged(p.upload_video(src))
        card = p.run_staged(staged)
    finally:
        del p._windows
    planes = np.empty((T, H * W * 3 // 2), np.uint8)
    reader = opened[-1]
    reader.pos = 0
    reader.read_into_yuv(planes)
    cpu = TrackNetPredictor(tn, batch_size=PATHS_BATCH, device="cpu")
    cpu_staged = cpu.finalize_staged(cpu.upload_staged(planes, src_wh=PATHS_SRC, yuv=True))
    replay = iter(host)
    cpu._windows = lambda pre, buf, med, starts: next(replay)
    want = cpu.run_staged(cpu_staged)
    differ = [t for t in range(T) if _rows(card)[t] != _rows(want)[t]]
    return {"chunks": len(host), "rows": T, "visible": sum(card["Visibility"]),
            "staged_unequal": int((staged.buf.cpu() != cpu_staged.buf).sum()),
            "median_unequal": int((staged.median.cpu() != cpu_staged.median).sum()),
            "rows_differ": len(differ), "first_differ": differ[:5]}


def phase_yuv_stage(tmp: str, card: str) -> dict:
    """yuv_stage: ``yuv420_to_rgb`` on the card; then ``predict_video`` of a
    480-frame video from a stand-in native reader (``synthetic_native_reader``
    at ``inference.open_native_video``, ``synthetic_reader`` at
    ``open_video``: the card's machine has no libav) under
    ``stage_format="yuv420"`` and ``"bgr"``, at full width (seq_len 8,
    concat, 288x512, batch 16, bf16, ``hand_9tap``, InpaintNet seed 17)."""
    import torch

    from tracknetv3_tpu_torch import inference as tinf
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint
    from tracknetv3_tpu_torch.utils.io import write_pred_csv

    t_phase = time.time()
    conversion = _yuv_convert_check(card)
    torch.cuda.empty_cache()
    tn = disk_detector_checkpoint(os.path.join(tmp, "TrackNet_yuv.pt"), seed=29)
    inp = os.path.join(tmp, "InpaintNet_yuv.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0,
                    model=get_model("InpaintNet", generator=torch.Generator().manual_seed(17)),
                    param_dict={"model_name": "InpaintNet", "seq_len": 16})
    scene = _Scene(seed=21)
    src = f"synthetic://yuv_{YUV_T}.mp4"
    replay_src = f"synthetic://yuv_{PATHS_REPLAY_T}.mp4"  # the CPU replay's: depth cut for time
    videos = {src: (YUV_T, scene, None), replay_src: (PATHS_REPLAY_T, scene, None)}
    opened = []
    out_dir = os.path.join(tmp, "yuv_stage")
    chunks = _chunks_of(YUV_T, "weight", staged=True)
    sx, sy = PATHS_SRC[0] / W, PATHS_SRC[1] / H
    launches_by, rows_by, res_by = {}, {}, {}
    with mock.patch.object(tinf, "open_video", synthetic_reader(videos)), \
            mock.patch.object(tinf, "open_native_video", synthetic_native_reader(videos, opened)):
        for fmt in YUV_FORMATS:
            made = []
            real = tinf.TrackNetPredictor

            def recording(*args, **kwargs):
                made.append(real(*args, **kwargs))
                return made[-1]

            _zero_launches()
            t0 = time.perf_counter()
            with mock.patch.object(tinf, "TrackNetPredictor", recording):
                pred = tinf.predict_video(src, tn, inp, batch_size=PATHS_BATCH, device=DEVICE,
                                          stage_format=fmt, save_dir=out_dir,
                                          video_name=f"yuv_stage_{fmt}")
            entry_s = time.perf_counter() - t0
            launches = _path_launches()
            backend = made[0].decode_backend
            with open(os.path.join(out_dir, f"yuv_stage_{fmt}_ball.csv")) as f:
                n_rows = sum(1 for _ in f) - 1
            p = tinf.TrackNetPredictor(tn, inp, batch_size=PATHS_BATCH, device=DEVICE,
                                       stage_format=fmt)  # bf16, hand_9tap, as predict_video's
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            upload_s, finalize_ms, run_s, e2e_s = [], [], [], []
            for _ in range(3):
                t0 = time.perf_counter()
                up = p.upload_video(src)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                staged = p.finalize_staged(up)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                rows = p.run_staged(staged, (sx, sy))
                t3 = time.perf_counter()
                write_pred_csv(p.inpaint_trajectory(rows, PATHS_SRC),
                               os.path.join(tmp, "yuv_timed_ball.csv"))
                t4 = time.perf_counter()
                upload_s.append(t1 - t0)
                finalize_ms.append((t2 - t1) * 1e3)
                run_s.append(t3 - t2)
                e2e_s.append(t4 - t0)
                h2d = up.buf.nbytes
                del up, staged
            peak = torch.cuda.max_memory_allocated()
            copy_ms, convert_ms = _video_copy_ms(h2d, fmt)
            replay = (_replay_yuv(p, tn, opened, replay_src, PATHS_REPLAY_T)
                      if fmt == "yuv420" else None)
            visible, far, outside = _track_check(rows, scene, YUV_T)
            rows_by[fmt] = rows
            launches_by[fmt] = launches
            res = {"phase": "yuv_stage", "case": "predict_video", "stage_format": fmt,
                   "decode": "stand-in native reader, drawn in memory",
                   "decode_backend": backend, "source_wh": list(PATHS_SRC), "frames": YUV_T,
                   "batch_size": PATHS_BATCH, "conv_backend": p.params["conv_backend"],
                   "chunks": chunks, "launches": launches,
                   "launches_per_chunk": {k: launches[k] / chunks for k in PATHS_KERNELS},
                   "csv_rows": n_rows, "entry_rows": len(pred["Frame"]),
                   "h2d_bytes": h2d, "h2d_copy_ms": copy_ms, "conversion_ms": convert_ms,
                   "upload_s": upload_s, "finalize_ms": finalize_ms,
                   "run_fps": YUV_T / statistics.median(run_s),
                   "e2e_fps": YUV_T / statistics.median(e2e_s), "run_s": run_s,
                   "e2e_s": e2e_s, "peak_mem_bytes": peak, "visible_frames": visible,
                   "far_from_disk": far, "outside_frame": outside, "replay": replay,
                   "entry_point_s": entry_s, "card": card}
            res_by[fmt] = res
            emit(res)
            want_backend = "native-lowres0" + ("+yuv420" if fmt == "yuv420" else "")
            if backend != want_backend or p.decode_backend != want_backend:
                fail("yuv_stage", f"{fmt}: decode_backend {backend} / {p.decode_backend}, "
                     f"want {want_backend}")
            if launches != _want_launches(chunks):
                fail("yuv_stage", f"{fmt}: launches {launches} != {_want_launches(chunks)}")
            if n_rows != YUV_T or outside or far or visible < YUV_T // 2:
                fail("yuv_stage", f"{fmt}: {n_rows} rows, {visible} visible, {far} farther "
                     f"than 4 px from the disk, {outside} outside the frame")
            want_h2d = YUV_T * H * W * 3 // (2 if fmt == "yuv420" else 1)
            if h2d != want_h2d:
                fail("yuv_stage", f"{fmt}: {h2d} bytes crossed to the card, want {want_h2d}")
            if replay and (replay["rows_differ"] or replay["staged_unequal"]
                           or replay["median_unequal"]):
                fail("yuv_stage", f"{fmt}: the card differs from the CPU replay: {replay}")
            del p

        # a forced yuv420 at an odd model width raises; auto stages packed BGR there
        odd = {}
        for fmt in ("yuv420", "auto"):
            p = tinf.TrackNetPredictor(tn, batch_size=PATHS_BATCH, device=DEVICE,
                                       input_hw=(H, W - 1), stage_format=fmt)
            try:
                up = p.upload_video(src)
                odd[fmt] = {"yuv": up.yuv, "shape": list(up.buf.shape),
                            "decode_backend": p.decode_backend}
                del up
            except RuntimeError as e:
                odd[fmt] = {"raised": str(e)}
            del p
    a, b = _rows(rows_by["yuv420"]), _rows(rows_by["bgr"])
    differ = [t for t in range(YUV_T) if a[t] != b[t]]
    over_1px = [t for t in differ if abs(a[t][0] - b[t][0]) > sx or abs(a[t][1] - b[t][1]) > sy
                or a[t][2] != b[t][2]]
    ratio = res_by["yuv420"]["h2d_bytes"] / res_by["bgr"]["h2d_bytes"]
    emit({"phase": "yuv_stage", "case": "summary", "h2d_ratio_yuv_to_bgr": ratio,
          "rows_differ_yuv_vs_bgr": len(differ), "differ_by_more_than_1_model_px": len(over_1px),
          "first_differ": differ[:5], "odd_width": odd,
          "upload_s_median": {f: statistics.median(r["upload_s"]) for f, r in res_by.items()},
          "finalize_ms_median": {f: statistics.median(r["finalize_ms"])
                                 for f, r in res_by.items()},
          "conversion_ms_per_slab": conversion["ms"],
          "h2d_copy_ms_saved": res_by["bgr"]["h2d_copy_ms"] - res_by["yuv420"]["h2d_copy_ms"],
          "conversion_ms_per_video": res_by["yuv420"]["conversion_ms"],
          "phase_s": time.time() - t_phase,
          "card": card})
    if ratio != 0.5:
        fail("yuv_stage", f"YUV420 staging moved {ratio} of BGR's bytes, not half")
    if over_1px:
        fail("yuv_stage", f"YUV420 rows {over_1px[:5]} differ from the BGR rows by more than "
             "a model pixel")
    if "raised" not in odd["yuv420"] or "not even" not in odd["yuv420"]["raised"]:
        fail("yuv_stage", f"a forced yuv420 at width {W - 1} did not raise: {odd}")
    if odd["auto"].get("yuv", True) or odd["auto"]["decode_backend"] != "native-lowres0":
        fail("yuv_stage", f"auto at width {W - 1} did not stage packed BGR: {odd}")
    return {f"yuv_stage {fmt}": n for fmt, n in launches_by.items()}


# ---------------------------------------------------------------- rally evaluation

# the test CLI's runs: (name, its flags, how TrackNet forwards the chunks:
# carried-tail ensemble, disjoint windows, or not at all with InpaintNet)
RALLY_RUNS = (
    ("weight", [], "overlap"),
    ("nonoverlap", ["--eval_mode", "nonoverlap"], "nonoverlap"),
    ("exact_device", ["--exact_decode"], "overlap"),
    ("exact_host", ["--exact_decode", "host"], "overlap"),
    ("linear_interp", ["--linear_interp"], "overlap"),
    ("inpaintnet", ["--inpaintnet_file", None], None),
    ("output_bbox", ["--output_bbox"], "overlap"),
)
RALLY_KERNELS = ("conv3x3_9tap", "maxpool2x2", "up2x_nearest", "window_copy")
EXACT_CORPUS_N = 24  # maps of the seeded multi-blob corpus at 288x512


def _rally_chunks(T: int, mode: str) -> int:
    """Chunks of RALLY_BATCH windows that TrackNet forwards for a T-frame rally."""
    n_win = -(-T // L) if mode == "nonoverlap" else max(T - L + 1, 1)
    return -(-n_win // RALLY_BATCH)


def _path_launches():
    """The launch counts of the kernels on the rally path."""
    from tracknetv3_tpu_torch.ops import conv3x3, pool_up2x, shift_copy

    counts = _launches(conv3x3, pool_up2x, shift_copy)
    return {k: counts[k] for k in RALLY_KERNELS}


def _launches(*modules) -> dict:
    """The launch counts of the hand kernels of ``modules`` by kernel (the
    ``launch.<kernel>`` counters of ``utils/profiling``)."""
    from tracknetv3_tpu_torch.utils import profiling

    counts = profiling.counters()
    return {k: counts[f"launch.{k}"] for m in modules for k in m.KERNELS}


def _zero_launches():
    from tracknetv3_tpu_torch.utils import profiling

    profiling.reset()


def _rally_label_counts(data_dir: str, split: str):
    """{rally key: label rows} of a split."""
    from tracknetv3_tpu_torch.utils.io import get_rally_dirs, label_csv_path, parse_rally_dir

    out = {}
    for rd in get_rally_dirs(data_dir, split):
        match_dir, rally = parse_rally_dir(os.path.join(data_dir, rd))
        with open(label_csv_path(match_dir, rally)) as f:
            out[f"{match_dir.split('match')[-1]}_{rally}", match_dir, rally] = sum(1 for _ in f) - 1
    return out


def _exact_corpus(seed: int) -> np.ndarray:
    """Seeded multi-blob maps at 288x512: random rectangles and disks above
    0.5 on sub-threshold noise, in every third map two blobs of equal
    bounding-box area larger than the others (the raster-later one
    brighter), in every fourth a blob larger than the 96-pixel crop, and an
    empty map."""
    rng = np.random.default_rng(seed)
    maps = rng.uniform(0.0, 0.5, (EXACT_CORPUS_N, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(EXACT_CORPUS_N - 1):
        for _ in range(int(rng.integers(1, 8))):
            v = np.float32(rng.uniform(0.55, 1.0))
            if rng.random() < 0.5:
                y0, x0 = int(rng.integers(0, H - 16)), int(rng.integers(0, W - 16))
                maps[i, y0 : y0 + int(rng.integers(1, 16)), x0 : x0 + int(rng.integers(1, 16))] = v
            else:
                cy, cx = int(rng.integers(4, H - 4)), int(rng.integers(4, W - 4))
                maps[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= int(rng.integers(2, 40))] = v
        if i % 3 == 0:  # 20 x 30 boxes: larger than any random blob
            maps[i, 2:22, 3:33] = 0.6
            maps[i, H - 24 : H - 4, W - 34 : W - 4] = 0.97
        if i % 4 == 0:
            maps[i, 40:160, 100:300] = 0.56
    maps[-1] = 0.25
    return maps


def _decode_differs(got, want) -> int:
    """Frames whose integer fields or confidence differ."""
    bad = np.zeros(np.asarray(want["cx"]).shape, bool)
    for k in ("cx", "cy", "vis", "conf"):
        bad |= np.asarray(got[k]) != np.asarray(want[k])
    bad |= (np.asarray(got["bbox"]) != np.asarray(want["bbox"])).any(axis=-1)
    return int(bad.sum())


def _on_host(dec):
    return {k: v.cpu().numpy() for k, v in dec.items()}


def _occlude_predicted_csv(rally_dir: str) -> None:
    """Rewrite a rally's ``predicted_csv`` file with frames 12-15 of every
    40-frame pass missed (visibility and coordinates 0) and masked for
    inpainting, as ``serve_vs_cpu`` cuts its occlusions."""
    from tracknetv3_tpu_torch.utils.io import parse_rally_dir

    match_dir, rally = parse_rally_dir(rally_dir)
    path = os.path.join(match_dir, "predicted_csv", f"{rally}_ball.csv")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    col = {name: i for i, name in enumerate(rows[0])}
    for r in rows[1:]:
        if 12 <= int(r[col["Frame"]]) % 40 < 16:
            r[col["Visibility"]] = r[col["X"]] = r[col["Y"]] = "0"
            r[col["Inpaint_Mask"]] = "1"
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


def _rally_engine(tn: str, inp=None, device=None, **kw):
    import torch

    from tracknetv3_tpu_torch.evaluation.test_engine import RallyTestEngine
    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

    model, pd = load_model_from_checkpoint(tn, dtype=torch.float32)
    inpaint = load_model_from_checkpoint(inp)[0] if inp else None
    return RallyTestEngine(model, inpaint, tracknet_seq_len=pd["seq_len"],
                           bg_mode=pd["bg_mode"], batch_size=RALLY_BATCH,
                           device=device or DEVICE, **kw)


def rally_vs_cpu(tn: str, inp: str, data_dir: str) -> dict:
    """The card's test split, replayed on the CPU: each chunk's window
    probabilities are copied to the host and a CPU engine runs its own
    ensemble and decode on them; its rows must equal the card's. InpaintNet's
    rows likewise, over the ``predicted_csv`` files with occlusions cut in (a
    masked frame may be 1 px off). Then the card's ``decode_heatmaps_exact``
    against ``decode_heatmaps_host`` on every ensembled test frame and on a
    seeded multi-blob corpus, where two wrong rules must fail; and the
    decoders' ms per frame over the first rally's ensembled frames."""
    import torch
    from scipy import ndimage

    from tracknetv3_tpu_torch.ops import detect
    from tracknetv3_tpu_torch.utils.io import get_rally_dirs, read_csv_columns

    card = _rally_engine(tn)
    forward = card._forward_cached
    host_probs = []

    def recording(staged, starts):
        probs = forward(staged, starts)
        host_probs.append(probs.cpu())
        return probs

    card._forward_cached = recording
    got = card.test(data_dir, "test")
    cpu = _rally_engine(tn, device="cpu")
    replay = iter(host_probs)
    cpu._forward_cached = lambda staged, starts: next(replay)
    want = cpu.test(data_dir, "test")
    fields = ("X", "Y", "Visibility", "Type")
    differ = {k: sum(any(got[k][f][t] != want[k][f][t] for f in fields)
                     for t in range(len(want[k]["Frame"]))) for k in want}

    # InpaintNet over the generated predicted_csv files, with an occlusion
    # cut into each 40-frame pass (frames 12-15 missed and masked) so that
    # InpaintNet's own output reaches the rows
    for rd in get_rally_dirs(data_dir, "test"):
        _occlude_predicted_csv(os.path.join(data_dir, rd))
    got_i = _rally_engine(tn, inp).test(data_dir, "test")
    want_i = _rally_engine(tn, inp, device="cpu").test(data_dir, "test")
    inpaint = {}
    for key, pred in want_i.items():
        match_id, rally = key.split("_", 1)
        csv_file = os.path.join(data_dir, "test", f"match{match_id}", "predicted_csv",
                                f"{rally}_ball.csv")
        mask = read_csv_columns(csv_file, ("Inpaint_Mask",))["Inpaint_Mask"]
        off = far = 0
        for t, m in enumerate(mask):
            g = (got_i[key]["X"][t], got_i[key]["Y"][t], got_i[key]["Visibility"][t])
            w = (pred["X"][t], pred["Y"][t], pred["Visibility"][t])
            if not m:
                off += g != w
            else:
                far += abs(g[0] - w[0]) > 1 or abs(g[1] - w[1]) > 1 or g[2] != w[2]
        inpaint[key] = {"masked": int(mask.sum()), "unmasked_differ": off,
                        "masked_differ_over_1px": far}

    # the exact rule on the card against the host oracle: every ensembled frame
    exact_differ = frames_n = multi_blob = 0
    timed = exact_ms = None  # the first rally's frames, and the exact decode's ms a frame
    for rd in get_rally_dirs(data_dir, "test"):
        staged = card._staged_rallies[os.path.join(data_dir, rd)]
        frames = card.ensembled_frames(staged)
        host = detect.decode_heatmaps_host(frames.cpu().numpy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():  # in the engine's chunks
            dev = [detect.decode_heatmaps_exact(frames[i : i + RALLY_BATCH])
                   for i in range(0, staged.T, RALLY_BATCH)]
        torch.cuda.synchronize()
        if timed is None:
            timed, exact_ms = frames, (time.perf_counter() - t0) * 1e3 / staged.T
        dev = {k: np.concatenate([d[k].cpu().numpy() for d in dev]) for k in dev[0]}
        exact_differ += _decode_differs(dev, host)
        frames_n += staged.T
        multi_blob += sum(ndimage.label(m, np.ones((3, 3)))[1] > 1
                          for m in frames.cpu().numpy() > 0.5)

    # a seeded corpus: area ties, blobs larger than the crop, an empty map
    corpus = _exact_corpus(41)
    want_c = detect.decode_heatmaps_host(corpus)
    dcorpus = torch.from_numpy(corpus).to(DEVICE)
    with torch.inference_mode():
        corpus_differ = _decode_differs(_on_host(detect.decode_heatmaps_exact(dcorpus)), want_c)
        wrong = {}
        for name, attr, fn in (
                ("ties_kept_last", "_better", lambda area, first, best_area, best_first:
                 (area > best_area) | ((area == best_area) & (first > best_first))),
                ("fill_capped_at_crop", "_expand", lambda region, remaining, active: region)):
            with mock.patch.object(detect, attr, fn):
                wrong[name] = _decode_differs(
                    _on_host(detect.decode_heatmaps_exact(dcorpus)), want_c)

        # ms per frame of the other decoders over the same frames and chunks,
        # and of the peak blob and the exact rule on the corpus
        def per_frame_ms(decode, maps, n=3):
            chunks = [maps[i : i + RALLY_BATCH] for i in range(0, maps.shape[0], RALLY_BATCH)]
            ts = []
            for _ in range(n + 1):  # the first is a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for c in chunks:
                    decode(c)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3 / maps.shape[0])
            return statistics.median(ts[1:])

        peak_ms = per_frame_ms(detect.decode_heatmaps, timed)
        host_ms = per_frame_ms(lambda c: detect.decode_heatmaps_host(c.cpu().numpy()), timed)
        corpus_ms = {"exact": per_frame_ms(detect.decode_heatmaps_exact, dcorpus, n=1),
                     "peak_blob": per_frame_ms(detect.decode_heatmaps, dcorpus)}
    blobs = [int(ndimage.label(m, np.ones((3, 3)))[1]) for m in timed.cpu().numpy() > 0.5]
    res = {"rows_differ": differ, "visible_rows": {k: sum(p["Visibility"]) for k, p in got.items()},
           "chunks_replayed": len(host_probs), "inpaint": inpaint,
           "exact_vs_host": {"frames": frames_n, "differ": exact_differ,
                             "multi_blob_frames": int(multi_blob),
                             "corpus_maps": EXACT_CORPUS_N, "corpus_differ": corpus_differ,
                             "wrong_rules_differ": wrong,
                             "host_backend": detect.host_backend()},
           "decode_ms_per_frame": {"exact": exact_ms, "peak_blob": peak_ms,
                                   "host_oracle_with_fetch": host_ms,
                                   "frames": int(timed.shape[0]),
                                   "blobs_per_frame_max": max(blobs),
                                   "blobs_per_frame_mean": statistics.mean(blobs),
                                   "corpus": corpus_ms}}
    if any(differ.values()):
        fail("rally_vs_cpu", f"rows differ from the CPU replay: {differ}")
    if not sum(res["visible_rows"].values()):
        fail("rally_vs_cpu", "no detection in the rows compared")
    for key, r in inpaint.items():
        if r["unmasked_differ"] or r["masked_differ_over_1px"]:
            fail("rally_vs_cpu", f"InpaintNet rows of {key}: {r}")
        if not r["masked"]:
            fail("rally_vs_cpu", f"InpaintNet rows of {key}: no frame was masked")
    if exact_differ or corpus_differ:
        fail("rally_vs_cpu", f"decode_heatmaps_exact differs from the host oracle on "
             f"{exact_differ} of {frames_n} test frames and {corpus_differ} corpus maps")
    if not all(wrong.values()):
        fail("rally_vs_cpu", f"a wrong exact rule passes the comparison: {wrong}")
    return res


def _eval_breakdown(tn: str, data_dir: str) -> dict:
    """Where a ``weight`` run's wall time goes (host clock): reading the test
    rallies' frame caches from disk, staging them on the card, and the
    rallies' chunk loops with the host's work around them (each ends in the
    rally's one fetch)."""
    import torch

    from tracknetv3_tpu_torch.data.dataset import FrameCache
    from tracknetv3_tpu_torch.utils.io import get_rally_dirs

    engine = _rally_engine(tn)
    rally_dirs = [os.path.join(data_dir, rd) for rd in get_rally_dirs(data_dir, "test")]
    cache = FrameCache(data_dir, engine.bg_mode, input_hw=(H, W))
    t0 = time.perf_counter()
    for rally_dir in rally_dirs:
        cache.load(rally_dir)
    t1 = time.perf_counter()
    engine.prestage(data_dir, rally_dirs, cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for rally_dir in rally_dirs:
        engine.test_rally(data_dir, rally_dir, cache)
    t3 = time.perf_counter()
    return {"cache_load": t1 - t0, "stage": t2 - t1, "rallies": t3 - t2,
            "frames": sum(s.T for s in engine._staged_rallies.values())}


def phase_rally(tmp: str, card: str, tn=None) -> dict:
    """rally: generate_mask_data -> InpaintNet training -> test on the card at
    288x512, seq_len 8, concat, batch 16, bf16 on the default conv route,
    through the two CLIs and the train CLI; launch counts per run; then
    rally_vs_cpu. ``tn``: a TrackNet checkpoint (phase 5's); without one a
    seeded TrackNet is saved. Returns the kernels' launches over the phase's
    CLI runs."""
    import torch

    from tracknetv3_tpu_torch import generate_mask_data as mask_cli
    from tracknetv3_tpu_torch import test as test_cli
    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    t_phase = time.time()
    data_dir = os.path.join(tmp, "data")
    if not os.path.isdir(os.path.join(data_dir, "test")):
        write_synthetic_dataset(data_dir)
    if tn is None:
        tn = os.path.join(tmp, "TrackNet_seed13.pt")
        model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(13))
        save_checkpoint(tn, epoch=0, max_val_acc=0.0, model=model,
                        param_dict={"model_name": "TrackNet", "seq_len": L, "bg_mode": "concat"})
    with np.load(os.path.join(data_dir, "test", "match1", "frame", "1_01_00",
                              f"cache_{H}x{W}_concat.npz")) as z:
        frames = z["rgb"]
    tn = detecting_checkpoint(tn, frames, os.path.join(tmp, "TrackNet_rally_detect.pt"))
    total = dict.fromkeys(RALLY_KERNELS, 0)
    runs = {}

    # generate_mask_data over the three splits
    _zero_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        stats = mask_cli.main(["--tracknet_file", tn, "--data_dir", data_dir,
                               "--batch_size", str(RALLY_BATCH), "--device", DEVICE])
    launches = _path_launches()
    labels = {split: _rally_label_counts(data_dir, split) for split in ("train", "val", "test")}
    chunks = sum(_rally_chunks(n, "overlap") for rows in labels.values() for n in rows.values())
    csv_rows = {}
    for split, rows in labels.items():
        for (key, match_dir, rally), n in rows.items():
            with open(os.path.join(match_dir, "predicted_csv", f"{rally}_ball.csv")) as f:
                csv_rows[f"{split}/{key}"] = (sum(1 for _ in f) - 1, n)
    runs["generate_mask_data"] = {"s": time.time() - t0, "chunks": chunks, "launches": launches,
                                  "fps": {k: v["fps"] for k, v in stats.items()}}
    want = {"conv3x3_9tap": CONV_LAYERS * chunks, "maxpool2x2": 3 * chunks,
            "up2x_nearest": 3 * chunks, "window_copy": chunks}
    if launches != want:
        fail("rally", f"generate_mask_data: launches {launches} != {want} ({chunks} chunks)")
    bad = {k: v for k, v in csv_rows.items() if v[0] != v[1]}
    if bad:
        fail("rally", f"predicted_csv rows != label rows (got, want): {bad}")
    for k in total:
        total[k] += launches[k]

    # one epoch of InpaintNet on the generated files (the stale coordinate-mode
    # caches of the inpaint_train phase go first)
    for name in os.listdir(data_dir):
        if "_coordinate_" in name:
            os.remove(os.path.join(data_dir, name))
    inp_dir = os.path.join(tmp, "rally_inpaint")
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        out = train_cli.main(["--model_name", "InpaintNet", "--seq_len", str(INPAINT_SEQ),
                              "--lr_scheduler", "StepLR", "--mask_ratio", "0.3",
                              "--batch_size", str(INPAINT_BATCH), "--epochs", "1",
                              "--data_dir", data_dir, "--save_dir", inp_dir,
                              "--device", DEVICE])
    inp = os.path.join(inp_dir, "InpaintNet_best.pt")
    h = out["history"][0]
    runs["inpaint_train"] = {"s": time.time() - t0, "steps": out["step"],
                             "losses": [h["train_loss"], h["val_loss"]]}
    if not (out["step"] and math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])):
        fail("rally", f"InpaintNet training: {runs['inpaint_train']}")

    # the test CLI
    test_rows = labels["test"]
    for name, flags, mode in RALLY_RUNS:
        flags = [inp if f is None else f for f in flags]
        save = os.path.join(tmp, f"rally_{name}")
        _zero_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            out = test_cli.main(["--tracknet_file", tn, "--data_dir", data_dir,
                                 "--batch_size", str(RALLY_BATCH), "--save_dir", save,
                                 "--device", DEVICE] + flags)
        launches = _path_launches()
        chunks = sum(_rally_chunks(n, mode) for n in test_rows.values()) if mode else 0
        pred = out["pred_dict"]
        n_rows = {k: len(p["Frame"]) for k, p in pred.items()}
        inside = all(0 <= x < W and 0 <= y < H for p in pred.values()
                     for x, y in zip(p["X"], p["Y"]))
        res = out["res"]
        runs[name] = {"s": time.time() - t0, "fps": res["eval_speed"]["fps"],
                      "chunks": chunks, "launches": launches,
                      "f1": res["f1"], "accuracy": res["accuracy"],
                      "visible": sum(sum(p["Visibility"]) for p in pred.values())}
        if out["mAP"] is not None:
            runs[name]["mAP"] = out["mAP"]
        want = {"conv3x3_9tap": CONV_LAYERS * chunks, "maxpool2x2": 3 * chunks,
                "up2x_nearest": 3 * chunks, "window_copy": chunks}
        if launches != want:
            fail("rally", f"test {name}: launches {launches} != {want} ({chunks} chunks)")
        if n_rows != {k: n for (k, _, _), n in test_rows.items()}:
            fail("rally", f"test {name}: rows {n_rows} != label rows {test_rows}")
        if not inside:
            fail("rally", f"test {name}: a coordinate lies outside the {W}x{H} frame")
        if out["mAP"] is not None and not all(math.isfinite(v) for v in out["mAP"].values()):
            fail("rally", f"test {name}: mAP {out['mAP']}")
        for k in total:
            total[k] += launches[k]
    if not os.path.exists(os.path.join(tmp, "rally_output_bbox", "test_coco_res_weight.json")):
        fail("rally", "--output_bbox wrote no COCO result")

    breakdown = _eval_breakdown(tn, data_dir)
    t0 = time.time()
    vs = rally_vs_cpu(tn, inp, data_dir)
    vs_s = time.time() - t0
    emit({"phase": "rally_vs_cpu", "card": card, "s": vs_s, **vs})
    emit({"phase": "rally", "card": card,
          "config": "TrackNet seq_len 8 concat 288x512 batch 16 bf16 hand_9tap; test split 2 "
                    f"rallies x {RALLY_T} frames",
          "fps_by_run": {k: r["fps"] for k, r in runs.items() if "fps" in r},
          "decode_ms_per_frame": vs["decode_ms_per_frame"],
          "weight_breakdown_s": breakdown, "launches_total": total,
          "phase_s": time.time() - t_phase})
    for k, r in runs.items():
        emit({"phase": "rally", "run": k, **r}, detail=True)
    return total


# ---------------------------------------------------------------- host tools

TOOLS_T, TOOLS_HW, TOOLS_BAND = 240, (720, 1280), 90  # rally frames, source size, host rows
TOOLS_DISPLAY_STEP = 4  # the train loop's display_step under --debug
TOOLS_INPAINT_BATCH = 20  # 5 steps an epoch at seq_len 16, so one progress sample


def _tools_median(tmp: str) -> dict:
    """get_rally_median on the card over ``TOOLS_T`` seeded 1280x720 frames
    drawn in memory (a stand-in ``generate_frames``: no decoder on the card's
    machine), bit-equal to host ``np.median`` over a float32 band of
    ``TOOLS_BAND`` rows; seconds and peak memory of both (the card's from
    ``max_memory_allocated``, the host's from ``tracemalloc``)."""
    import tracemalloc

    import torch

    from tracknetv3_tpu_torch.utils import io as tio

    frames = np.random.default_rng(23).integers(0, 256, (TOOLS_T, *TOOLS_HW, 3), np.uint8)
    video = os.path.join(tmp, "tools_data", "train", "match1", "video", "1_01_00.mp4")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(tio, "generate_frames",
                           lambda path: (frames, 30.0, TOOLS_HW[::-1])):
        t0 = time.time()
        med = tio.get_rally_median(video)
        card_s = time.time() - t0
    card_peak = torch.cuda.max_memory_allocated() - base
    saved = np.load(os.path.join(tmp, "tools_data", "train", "match1", "frame", "1_01_00",
                                 "median.npz"))["median"]
    r0 = (TOOLS_HW[0] - TOOLS_BAND) // 2
    tracemalloc.start()
    t0 = time.time()
    want = np.median(frames[:, r0:r0 + TOOLS_BAND].astype(np.float32), axis=0)
    host_s = time.time() - t0
    host_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    band = med[r0:r0 + TOOLS_BAND]
    res = {"frames": TOOLS_T, "hw": list(TOOLS_HW), "card_s": card_s,
           "card_peak_bytes": card_peak, "host_band_rows": TOOLS_BAND, "host_band_s": host_s,
           "host_band_peak_bytes": host_peak,
           "host_whole_rally_float32_bytes": frames.size * 4,  # what np.median would stack
           "unequal_in_band": int(np.count_nonzero(band.view(np.uint32) != want.view(np.uint32)))}
    if med.dtype != np.float32 or med.shape != (*TOOLS_HW, 3):
        fail("tools", f"median {med.dtype} {med.shape}, not float32 {(*TOOLS_HW, 3)}")
    if res["unequal_in_band"] or band.dtype != want.dtype:
        fail("tools", f"the card's rally median differs from np.median: {res}")
    if saved.tobytes() != med.tobytes():
        fail("tools", "median.npz does not hold the returned median")
    return res


def _jsonl_rows(path: str):
    with open(path) as f:
        return [(r["tag"], r["value"], r["step"]) for r in map(json.loads, f)]


def _logged_rows(model_name: str, history):
    """The (tag, value, step) rows the JAX loop's write_to_tb logs for
    ``history``."""
    rows = []
    for h in history:
        rows += [(f"{model_name}/loss/train", h["train_loss"], h["epoch"]),
                 (f"{model_name}/loss/val", h["val_loss"], h["epoch"])]
        res = h["val_res"]
        if model_name == "TrackNet":
            rows += [(f"{model_name}/val/{k}", float(v), h["epoch"]) for k, v in res.items()]
        else:
            rows += [(f"{model_name}/val_{t}/{k}", float(v), h["epoch"])
                     for t, r in res.items() for k, v in r.items()]
    return rows


def _train_cli_run(argv, save_dir: str):
    """The train CLI for one epoch: (its result, what it printed, wall s,
    seconds of each progress sample's drawing)."""
    import io

    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.utils import visualize as tvis

    draws = []

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            fn(*a, **k)
            draws.append(time.perf_counter() - t0)
        return run

    printed = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(printed), \
            mock.patch.object(tvis, "plot_heatmap_pred_sample",
                              timed(tvis.plot_heatmap_pred_sample)), \
            mock.patch.object(tvis, "plot_traj_pred_sample", timed(tvis.plot_traj_pred_sample)):
        res = train_cli.main(argv + ["--epochs", "1", "--save_dir", save_dir])
    torch.cuda.synchronize()
    wall = time.time() - t0
    sys.stderr.write(printed.getvalue())  # the CLI's own lines
    return res, printed.getvalue(), wall, draws


def _tools_train(data_dir: str, tmp: str, missing: list) -> dict:
    """One --debug epoch of each model through the train CLI: TrackNet at the
    README configuration (after one epoch without progress samples, the
    baseline of their cost), then InpaintNet (seq_len 16, StepLR, mask_ratio
    0.3, batch ``TOOLS_INPAINT_BATCH``). ``logs/scalars.jsonl`` must hold the
    returned history in the JAX loop's layout; the progress sample must be
    written every ``TOOLS_DISPLAY_STEP`` steps, TrackNet's through the
    BatchNorm kernels (17 ``bn_relu_fwd`` launches each), unless the plotting
    library is ``missing``: then the run must say so."""
    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index

    tracknet = ["--seq_len", str(L), "--bg_mode", "concat", "--alpha", "0.5",
                "--batch_size", str(B), "--data_dir", data_dir]
    runs = {
        "TrackNet": (tracknet, "cur_pred.gif", "PIL"),
        "InpaintNet": (["--model_name", "InpaintNet", "--seq_len", str(INPAINT_SEQ),
                        "--lr_scheduler", "StepLR", "--mask_ratio", "0.3", "--batch_size",
                        str(TOOLS_INPAINT_BATCH), "--data_dir", data_dir], "cur_traj.png",
                       "matplotlib"),
    }
    # the same epoch without samples (display_step 100 > 13 steps)
    _, _, no_samples_s, _ = _train_cli_run(tracknet, os.path.join(tmp, "tools_plain"))
    out = {}
    for name, (argv, sample, lib) in runs.items():
        save_dir = os.path.join(tmp, f"tools_{name}")
        _zero_launches()
        res, printed, train_s, draws = _train_cli_run(argv + ["--debug"], save_dir)
        launches = {m.__name__.rsplit(".", 1)[-1]: _launches(m) for m in _kernel_modules()}
        steps, samples = res["step"], res["step"] // TOOLS_DISPLAY_STEP
        logged = _jsonl_rows(os.path.join(save_dir, "logs", "scalars.jsonl"))
        written = os.path.exists(os.path.join(save_dir, sample))
        skipped = printed.count("(viz skipped:")
        out[name] = {"train_s": train_s, "sample_draw_s": draws, "steps": steps,
                     "samples": samples,
                     "sample_written": written, "viz_skipped_lines": skipped,
                     "tensorboard_events": any(f.startswith("events.out.tfevents") for f in
                                               os.listdir(os.path.join(save_dir, "logs"))),
                     "scalars": len(logged)}
        if not samples:
            fail("tools", f"{name}: {steps} steps give no progress sample")
        if logged != _logged_rows(name, res["history"]):
            fail("tools", f"{name}: scalars.jsonl {logged} does not hold the history")
        if lib in missing:
            if written or skipped != samples:
                fail("tools", f"{name}: {lib} is missing, yet {skipped} of {samples} samples "
                     f"said so (sample written: {written})")
        elif not written or skipped:
            fail("tools", f"{name}: no {sample} ({skipped} samples skipped)")
        if name == "TrackNet":
            val = len(HeatmapBatchLoader(build_split_index(data_dir, "val", L, L, debug=True),
                                         "concat", B, data_dir=data_dir))
            # the serving kernels (convs, pool / upsample) and the copies of
            # other batch kinds are not on this path
            want = {k: dict.fromkeys(v, 0) for k, v in launches.items()}
            want["wbce_disk"] = {"wbce_disk_fwd": steps, "wbce_disk_bwd": steps}
            want["batchnorm"] = {k: BN_LAYERS * steps if k in BN_KERNELS else 0
                                 for k in launches["batchnorm"]}
            # the eval forward of validation and of each progress sample
            want["batchnorm"]["bn_relu_fwd"] += BN_LAYERS * (val + samples)
            out[name].update(eval_batches=val, launches=launches,
                             train_s_without_samples=no_samples_s)
            if launches != want:
                fail("tools", f"TrackNet launches {launches} != {want}")
        elif any(n for counts in launches.values() for n in counts.values()):
            fail("tools", f"InpaintNet launched a hand kernel: {launches}")
    return out


def _steps_beside_drawing(data_dir: str, tmp: str, n: int = 40) -> dict:
    """Wall ms a train step over ``n`` steps queued back to back (one
    synchronize at the end, as in the loop) on a fixed README batch: alone,
    while a progress sample's GIF is drawn over and over on another thread
    (the share of the GIL the drawing holds slows the launches), and alone
    again."""
    import threading

    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import make_tracknet_train_step, sample_mixup_params
    from tracknetv3_tpu_torch.utils.visualize import plot_heatmap_pred_sample

    dev = torch.device(DEVICE)
    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_train_step(model, opt, "concat", 0.5, sched)
    batch = _first_batch(data_dir, dev)
    mix = tuple(torch.from_numpy(a).to(dev)
                for a in sample_mixup_params(np.random.default_rng(5), B, 0.5))

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(batch, i, *mix)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    rng = np.random.default_rng(29)
    sample = (rng.random((L, H, W, 3), np.float32), rng.random((L, H, W), np.float32),
              rng.random((L, H, W), np.float32))
    stop, draws = threading.Event(), []

    def draw():
        while not stop.is_set():
            t0 = time.perf_counter()
            plot_heatmap_pred_sample(*sample, save_dir=os.path.join(tmp, "tools_draw"))
            draws.append(time.perf_counter() - t0)

    run()  # warm-up
    alone = run()
    thread = threading.Thread(target=draw)
    thread.start()
    beside = run()
    stop.set()
    thread.join()
    return {"steps": n, "ms_per_step_alone": [alone, run()], "ms_per_step_beside_drawing": beside,
            "draws_s": draws}


def phase_tools(tmp: str, card: str) -> None:
    """tools: dataset preparation's rally median on the card (``_tools_median``)
    and training's scalar logs and progress samples (``_tools_train``) on
    the synthetic dataset of phase 5 (written here if absent), and what a
    sample drawn beside training costs its steps (``_steps_beside_drawing``)."""
    import importlib.util

    data_dir = os.path.join(tmp, "data")
    t_data = time.time()
    if not os.path.isdir(data_dir):
        write_synthetic_dataset(data_dir)
    t0 = time.time()
    missing = [lib for lib in ("PIL", "matplotlib", "tensorboard")
               if importlib.util.find_spec(lib) is None]
    for lib in missing:
        print(f"chip_smoke: tools: {lib} is not installed here", file=sys.stderr, flush=True)
    median = _tools_median(tmp)
    train = _tools_train(data_dir, tmp, missing)
    beside = _steps_beside_drawing(data_dir, tmp) if "PIL" not in missing else None
    emit({"phase": "tools", "card": card, "missing_libraries": missing, "median": median,
          "train": train, "steps_beside_drawing": beside, "dataset_s": t0 - t_data,
          "phase_s": time.time() - t0})


# ---------------------------------------------------------------- data parallel

MESH_T = 240  # frames of mesh_serve's video: cut from 480 for the script's time
MESH_MODES = ("weight", "nonoverlap")
MESH_VIDEOS = (("m480", 480), ("m300", 300), ("m97", 97))  # mesh_serve's predict_videos
MESH_CHILD_S = 120  # mesh_procs: each child's time limit
MESH_CHILD = r"""
import datetime, glob, hashlib, json, os, sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
import chip_smoke as cs
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=60))
try:
    engine = cs._rally_engine({tn!r})
    cs._zero_launches()
    pred = engine.test({data!r}, "test", save_inpaint_mask=True)
    launches = cs._path_launches()
    csvs = glob.glob(os.path.join({data!r}, "test", "match*", "predicted_csv", "*_ball.csv"))
    val = cs._merged_val({tn!r}, {inp!r}, {val!r}, {rank}, 2)
    print("MESH_PROC " + json.dumps(dict(
        rank={rank}, sha256=hashlib.sha256(json.dumps(pred).encode()).hexdigest(),
        keys=list(pred), frames=engine.last_eval_stats["frames"],
        eval_s=engine.last_eval_stats["seconds"], merge_s=engine.last_merge_s,
        predicted_csv=len(csvs), launches=launches, val=val)), flush=True)
finally:
    dist.destroy_process_group()
"""


VAL_BATCH = 4  # the merged validation's TrackNet batch: 3 batches of the val split's 10 windows
VAL_INPAINT_BATCH = 2  # and InpaintNet's
VAL_DECODES = (False, "device")


def _merged_val(tn: str, inp: str, data_dir: str, process_id: int = 0,
                process_count: int = 1) -> dict:
    """The train loop's validation of both models over the val split of
    ``data_dir`` as process ``process_id`` of ``process_count`` (the merged
    validation of ``evaluation/loops.py``): ``eval_tracknet`` with the
    serving decode and the exact one (the eval step's BatchNorm on the
    ``bn_relu_fwd`` kernel, TrackNet in bf16 as training holds it) and
    ``eval_inpaintnet`` over the ``predicted_csv`` files, with deterministic
    cuDNN and no autotuning, so that processes pick the same algorithms.
    Returns each loss as its float's hex and the metrics, the batches
    evaluated, the ``bn_relu_fwd`` launches and the seconds in the merge."""
    import torch

    from tracknetv3_tpu_torch.data.dataset import (CoordinateBatchLoader, HeatmapBatchLoader,
                                                   build_split_index)
    from tracknetv3_tpu_torch.evaluation import loops
    from tracknetv3_tpu_torch.ops import batchnorm
    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint
    from tracknetv3_tpu_torch.training.loop import _COORDINATE_KEYS, prefetch_to_device
    from tracknetv3_tpu_torch.training.steps import (make_inpaintnet_eval_step,
                                                     make_tracknet_eval_step)

    dev = torch.device(DEVICE)
    kw = dict(process_id=process_id, process_count=process_count)
    merge_s, real_merge = [], loops._merge_across_processes

    def timed_merge(*args):
        t0 = time.perf_counter()
        out = real_merge(*args)
        merge_s.append(time.perf_counter() - t0)
        return out

    tracknet = load_model_from_checkpoint(tn)[0].to(dev, memory_format=torch.channels_last)
    inpaint = load_model_from_checkpoint(inp)[0].to(dev)
    index = build_split_index(data_dir, "val", L, L)
    coord = build_split_index(data_dir, "val", INPAINT_SEQ, INPAINT_SEQ, "coordinate")
    out = {}
    _zero_launches()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True), \
            mock.patch.object(loops, "_merge_across_processes", timed_merge):
        for decode in VAL_DECODES:
            loader = HeatmapBatchLoader(index, "concat", VAL_BATCH, data_dir=data_dir)
            loss, res = loops.eval_tracknet(make_tracknet_eval_step(tracknet, "concat"),
                                            prefetch_to_device(loader, dev), 4.0,
                                            exact_decode=decode, **kw)
            out[f"tracknet exact_decode={decode}"] = [loss.hex(), res]
        loader = CoordinateBatchLoader(coord, VAL_INPAINT_BATCH)
        loss, res = loops.eval_inpaintnet(make_inpaintnet_eval_step(inpaint),
                                          prefetch_to_device(loader, dev, keys=_COORDINATE_KEYS),
                                          4.0, input_hw=coord.input_hw, **kw)
        out["inpaintnet"] = [loss.hex(), res]
    n = len(HeatmapBatchLoader(index, "concat", VAL_BATCH, data_dir=data_dir))
    return {"results": out, "eval_s": time.perf_counter() - t0, "merge_s": merge_s,
            "tracknet_batches": n, "inpaint_batches": len(loader),
            "evaluated": [i for i in range(n) if i % process_count == process_id],
            "bn_relu_fwd": _launches(batchnorm)["bn_relu_fwd"]}


def _want_mesh_launches(chunks: int, shards: int, copies: bool) -> dict:
    """The path's kernels, per chunk and shard: 17 conv, 3 pool, 3
    upsample and, where the rally engine gathers, 1 ``window_copy``."""
    want = _want_launches(chunks * shards)
    want["window_copy"] = chunks * shards * copies
    return want


def _mesh_serve(tmp: str, card: str, tn: str, inp: str, meshes: dict) -> dict:
    """run_staged over each mesh in both modes, then predict_videos through
    num_devices=2 on the card twice, and predict_video(num_devices=2)
    unpatched."""
    import torch

    from tracknetv3_tpu_torch import inference as tinf
    from tracknetv3_tpu_torch.parallel import mesh as pmesh

    launches_by = {}
    scene = _Scene(seed=23)
    frames = np.stack([scene.frame(t, W, H) for t in range(MESH_T)])
    for mode in MESH_MODES:
        p = tinf.TrackNetPredictor(tn, inp, eval_mode=mode, batch_size=PATHS_BATCH,
                                   device=DEVICE, conv_backend="hand_9tap")
        staged = p.stage_frames(frames, src_wh=PATHS_SRC)
        chunks = _chunks_of(MESH_T, mode, staged=True)
        ref = None
        for name, mesh in meshes.items():
            cards = sorted({d.index for d in mesh.devices}) if mesh else [0]
            p.run_staged(staged, mesh=mesh)  # warm-up: the weights' copies, the allocator
            torch.cuda.synchronize()
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
            run_s = []
            for i in range(3):
                if i == 0:
                    _zero_launches()
                t0 = time.perf_counter()
                pred = p.run_staged(staged, mesh=mesh)  # ends in the one fetch
                run_s.append(time.perf_counter() - t0)
                if i == 0:
                    launches = _path_launches()
            peaks = {f"cuda:{d}": torch.cuda.max_memory_allocated(d) for d in cards}
            rows = p.inpaint_trajectory(pred, PATHS_SRC)
            visible, far, outside = _track_check(pred, scene, MESH_T)
            shards = mesh.size if mesh else 1
            want = _want_mesh_launches(chunks, shards, copies=False)
            res = {"phase": "mesh_serve", "mode": mode, "mesh": name,
                   "devices": [str(d) for d in mesh.devices] if mesh else [DEVICE],
                   "frames": MESH_T, "batch_size": PATHS_BATCH, "chunks": chunks,
                   "launches": launches, "want_launches": want,
                   "rows_equal_single": ref is None or pred == ref[0],
                   "inpaint_rows_equal_single": ref is None or rows == ref[1],
                   "visible": visible, "far_from_disk": far, "outside": outside,
                   "run_fps": MESH_T / statistics.median(run_s), "run_s": run_s,
                   "peak_mem_bytes": peaks, "card": card}
            emit(res)
            if ref is None:
                ref = (pred, rows)
                if visible < MESH_T // 4 or far or outside:
                    fail("mesh_serve", f"{mode}: the single-device rows do not track the disk "
                         f"({visible} visible, {far} far, {outside} outside)")
            if not (res["rows_equal_single"] and res["inpaint_rows_equal_single"]):
                fail("mesh_serve", f"{mode} {name}: rows differ from the single-device run")
            if launches != want:
                fail("mesh_serve", f"{mode} {name}: launches {launches} != {want}")
            if name != "single":
                launches_by[f"mesh_serve {mode} {name}"] = launches
        del p, staged
        torch.cuda.empty_cache()

    # predict_videos through num_devices=2, make_mesh standing the one card in twice
    videos = {f"synthetic://{name}.mp4": (T, _Scene(seed=50 + i), None)
              for i, (name, T) in enumerate(MESH_VIDEOS)}
    files = list(videos)
    chunks = sum(_chunks_of(T, "weight", staged=True) for T, _, _ in videos.values())
    p = tinf.TrackNetPredictor(tn, inp, batch_size=PATHS_BATCH, device=DEVICE,
                               conv_backend="hand_9tap", native_decode=False)
    out = {}
    with mock.patch.object(tinf, "open_video", synthetic_reader(videos)):
        tinf.predict_videos(files, tn, predictor=p)  # warm-up
        # in turns: single, card twice, card twice, single; launches and CSVs of
        # each's first run
        for turn, (name, n) in enumerate((("single", None), ("card_twice", 2),
                                          ("card_twice", 2), ("single", None))):
            save = os.path.join(tmp, f"mesh_videos_{name}_{turn}")
            _zero_launches()
            t0 = time.perf_counter()
            with mock.patch.object(tinf, "make_mesh", lambda k, device: pmesh.make_mesh(
                    devices=[f"{device}:0"] * k)):
                tinf.predict_videos(files, tn, predictor=p, num_devices=n, save_dir=save)
            s = time.perf_counter() - t0
            if name in out:
                out[name]["s"].append(s)
                continue
            texts = {}
            for f in files:
                with open(os.path.join(save, f"{f.split('/')[-1][:-4]}_ball.csv")) as fh:
                    texts[f] = fh.read()
            out[name] = {"s": [s], "launches": _path_launches(), "csv": texts}
        refused = two_cards = None
        if torch.cuda.device_count() < 2:
            try:
                tinf.predict_video(files[-1], tn, num_devices=2, device=DEVICE)
            except ValueError as e:
                refused = str(e)
        else:  # a true 2-card mesh, unpatched
            save = os.path.join(tmp, "mesh_video_two_cards")
            tinf.predict_video(files[-1], tn, inp, num_devices=2, device=DEVICE,
                               conv_backend="hand_9tap", native_decode=False, save_dir=save)
            with open(os.path.join(save, "m97_ball.csv")) as fh:
                two_cards = fh.read() == out["single"]["csv"][files[-1]]
    frames_n = sum(v[0] for v in videos.values())
    res = {"phase": "mesh_serve", "case": "predict_videos", "videos": {f: v[0] for f, v in
                                                                      videos.items()},
           "csv_equal_single": out["card_twice"]["csv"] == out["single"]["csv"],
           "frames_per_s": {k: [frames_n / t for t in o["s"]] for k, o in out.items()},
           "launches": {k: o["launches"] for k, o in out.items()},
           "predict_video_num_devices_2": refused, "two_cards_csv_equal_single": two_cards,
           "card": card}
    emit(res)
    if not res["csv_equal_single"]:
        fail("mesh_serve", "predict_videos(num_devices=2) CSVs differ from the single device's")
    for name, shards in (("single", 1), ("card_twice", 2)):
        want = _want_mesh_launches(chunks, shards, copies=False)
        if out[name]["launches"] != want:
            fail("mesh_serve", f"predict_videos {name}: launches {out[name]['launches']} != "
                 f"{want}")
    if torch.cuda.device_count() < 2 and (refused is None or "only 1 available" not in refused):
        fail("mesh_serve", f"predict_video(num_devices=2) on one card: {refused!r}")
    if two_cards is False:
        fail("mesh_serve", "predict_video(num_devices=2) on two cards: CSV differs")
    launches_by["mesh_serve predict_videos card_twice"] = out["card_twice"]["launches"]
    return launches_by


def _mesh_rally(card: str, tn: str, data_dir: str, meshes: dict) -> dict:
    """The rally engine over the synthetic test split on each mesh against
    the single device: X, Y, BBox equal, Confidence within 1e-3."""
    chunks = sum(_rally_chunks(n, "overlap") for n in _rally_label_counts(data_dir, "test")
                 .values())
    launches_by, ref = {}, None
    for name, mesh in meshes.items():
        engine = _rally_engine(tn, mesh=mesh)
        engine.test(data_dir, "test", output_bbox=True)  # warm-up, stages the rallies
        _zero_launches()
        pred = engine.test(data_dir, "test", output_bbox=True)
        launches = _path_launches()
        shards = mesh.size if mesh else 1
        want = _want_mesh_launches(chunks, shards, copies=True)
        if ref is None:
            ref = pred
        same = all(pred[k][c] == ref[k][c] for k in ref for c in ("X", "Y", "BBox", "Visibility"))
        conf = max(abs(a - b) for k in ref for a, b in zip(pred[k]["Confidence"],
                                                            ref[k]["Confidence"]))
        res = {"phase": "mesh_rally", "mesh": name, "chunks": chunks, "launches": launches,
               "want_launches": want, "rows_equal_single": same, "max_conf_diff": conf,
               "visible": sum(sum(p["Visibility"]) for p in pred.values()),
               "fps": engine.last_eval_stats["fps"], "card": card}
        emit(res)
        if list(pred) != list(ref) or not same or conf > 1e-3:
            fail("mesh_rally", f"{name}: rows differ from the single device's (conf {conf})")
        if launches != want:
            fail("mesh_rally", f"{name}: launches {launches} != {want}")
        if name != "single":
            launches_by[f"mesh_rally {name}"] = launches
        del engine
    return launches_by


def _mesh_procs(tmp: str, card: str, tn: str, inp: str, data_dir: str) -> None:
    """engine.test(save_inpaint_mask=True) in two processes on cuda:0 over a
    gloo group, each on its own copy of the test split, against one process;
    then, in the same processes, the merged validation of both models
    (``_merged_val``) over the val split of ``data_dir`` against one process."""
    import hashlib
    import socket

    from tracknetv3_tpu_torch.data.dataset import build_split_index

    dirs = {}
    for tag in ("rank0", "rank1", "solo"):
        dirs[tag] = os.path.join(tmp, "mesh_procs", tag)
        shutil.copytree(os.path.join(data_dir, "test"), os.path.join(dirs[tag], "test"),
                        ignore=shutil.ignore_patterns("predicted_csv"))
    for args in ((L, L), (INPAINT_SEQ, INPAINT_SEQ, "coordinate")):  # caches, before the children
        build_split_index(data_dir, "val", *args)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_CHILD.format(root=ROOT, port=port, rank=r, tn=tn, inp=inp,
                                                 data=dirs[f"rank{r}"], val=data_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(MESH_CHILD_S - (time.time() - t0), 1))
            except subprocess.TimeoutExpired:
                fail("mesh_procs", f"rank {r} did not end within {MESH_CHILD_S} s")
            if p.returncode != 0:
                fail("mesh_procs", f"rank {r} exited {p.returncode}: {err[-2000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith("MESH_PROC ")]
            if len(lines) != 1:
                fail("mesh_procs", f"rank {r} printed no result: {out[-1000:]} {err[-1000:]}")
            outs.append(json.loads(lines[0][len("MESH_PROC "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    procs_s = time.time() - t0
    engine = _rally_engine(tn)
    pred = engine.test(dirs["solo"], "test", save_inpaint_mask=True)
    solo = hashlib.sha256(json.dumps(pred).encode()).hexdigest()
    chunks = [_rally_chunks(n, "overlap") for n in _rally_label_counts(dirs["solo"], "test")
              .values()]
    res = {"phase": "mesh_procs", "processes": 2, "backend": "gloo", "device": DEVICE,
           "ranks": outs, "solo_sha256": solo, "solo_frames": engine.last_eval_stats["frames"],
           "rallies": len(chunks), "wall_s": procs_s, "card": card}
    emit(res)
    for o, n in zip(outs, chunks):  # rank r evaluated rally r
        if o["sha256"] != solo or o["keys"] != list(pred):
            fail("mesh_procs", f"rank {o['rank']}'s merged dict differs from one process's")
        if o["frames"] != res["solo_frames"] or o["predicted_csv"] != len(chunks):
            fail("mesh_procs", f"rank {o['rank']}: {o['frames']} frames, "
                 f"{o['predicted_csv']} predicted_csv files")
        if o["launches"]["window_copy"] != n:
            fail("mesh_procs", f"rank {o['rank']}: {o['launches']['window_copy']} window_copy "
                 f"launches for its rally's {n} chunks")
    val = _merged_val(tn, inp, data_dir)
    emit({"phase": "mesh_procs_val", "processes": 2, "backend": "gloo", "device": DEVICE,
          "solo": val["results"], "tracknet_batches": val["tracknet_batches"],
          "inpaint_batches": val["inpaint_batches"],
          "ranks": [{k: o["val"][k] for k in ("evaluated", "bn_relu_fwd", "eval_s", "merge_s")}
                    for o in outs],
          "solo_bn_relu_fwd": val["bn_relu_fwd"], "solo_eval_s": val["eval_s"], "card": card})
    if val["tracknet_batches"] < 2 or val["inpaint_batches"] < 2:
        fail("mesh_procs_val", f"{val['tracknet_batches']} / {val['inpaint_batches']} val "
             "batches: too few to share between two processes")
    for o in outs:
        r = o["val"]
        if r["results"] != val["results"]:
            fail("mesh_procs_val", f"rank {o['rank']}'s merged validation differs from one "
                 f"process's: {r['results']} != {val['results']}")
        if r["bn_relu_fwd"] != BN_LAYERS * len(VAL_DECODES) * len(r["evaluated"]):
            fail("mesh_procs_val", f"rank {o['rank']}: {r['bn_relu_fwd']} bn_relu_fwd launches "
                 f"for {len(r['evaluated'])} batches, {len(VAL_DECODES)} decodes")
        if len(r["merge_s"]) != len(VAL_DECODES) + 1:
            fail("mesh_procs_val", f"rank {o['rank']} merged {len(r['merge_s'])} times")
    if val["bn_relu_fwd"] != BN_LAYERS * len(VAL_DECODES) * val["tracknet_batches"]:
        fail("mesh_procs_val", f"one process: {val['bn_relu_fwd']} bn_relu_fwd launches")


def phase_mesh(tmp: str, card: str) -> dict:
    """mesh: serving and rally evaluation sharded over a mesh that stands the
    card in twice (and over two cards where there are two), and rally
    evaluation in two processes; returns the paths' launches."""
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.parallel import mesh as pmesh
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    t_phase = time.time()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True  # as the CLIs set it
    tn = disk_detector_checkpoint(os.path.join(tmp, "TrackNet_mesh.pt"), seed=37)
    inp = os.path.join(tmp, "InpaintNet_mesh.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0,
                    model=get_model("InpaintNet", generator=torch.Generator().manual_seed(17)),
                    param_dict={"model_name": "InpaintNet", "seq_len": 16})
    meshes = {"single": None, "card_twice": pmesh.make_mesh(devices=["cuda:0", "cuda:0"])}
    refusal = None
    if torch.cuda.device_count() >= 2:
        meshes["two_cards"] = pmesh.make_mesh(2)
    else:
        try:
            pmesh.make_mesh(2)
        except ValueError as e:
            refusal = str(e)
        if refusal != "Requested 2 devices, only 1 available":
            fail("mesh", f"make_mesh(2) on one card: {refusal!r}")
    launches_by = _mesh_serve(tmp, card, tn, inp, meshes)
    t_serve = time.time() - t_phase
    data_dir = os.path.join(tmp, "data")
    if not os.path.isdir(os.path.join(data_dir, "test")):
        write_synthetic_dataset(data_dir)
    t0 = time.time()
    launches_by.update(_mesh_rally(card, tn, data_dir, meshes))
    t_rally = time.time() - t0
    t0 = time.time()
    _mesh_procs(tmp, card, tn, inp, data_dir)
    emit({"phase": "mesh", "card": card, "cards": torch.cuda.device_count(),
          "meshes": {k: [str(d) for d in m.devices] if m else [DEVICE]
                     for k, m in meshes.items()},
          "make_mesh_2": refusal or "two cards", "serve_s": t_serve, "rally_s": t_rally,
          "procs_s": time.time() - t0, "phase_s": time.time() - t_phase})
    return launches_by


# ---------------------------------------------------------------- reference checkpoints

CONVERT_T = 96  # frames of convert's video: 6 chunks at batch 16
CONVERT_SEED = 43
# the served bf16 probabilities against the reference forward in float32:
# (max, mean of the worst chunk) |dp|, set between the sound reading (0.0355,
# 0.00276 on an H100) and those of WRONG_CONVERTERS (0.724, 0.0471 with the
# kernels transposed; 0.769, 0.316 with the statistics dropped)
CONVERT_BOUNDS = (7e-2, 7e-3)
WRONG_CONVERTERS = ("kernels_transposed", "stats_dropped")
INPAINT_CONVERT_BOUND = 1e-5  # InpaintNet, float32 on both sides, TF32 off
_REF_TRACKNET = (("down_block_1", 2, 64), ("down_block_2", 2, 128), ("down_block_3", 3, 256),
                 ("bottleneck", 3, 512), ("up_block_1", 3, 256), ("up_block_2", 2, 128),
                 ("up_block_3", 2, 64))
_REF_INPAINT = (("down_1", 3, 32), ("down_2", 32, 64), ("down_3", 64, 128),
                ("buttleneck.conv_1", 128, 256), ("buttleneck.conv_2", 256, 256),
                ("up_1", 384, 128), ("up_2", 192, 64), ("up_3", 96, 32))


def reference_tracknet_state_dict(seed: int) -> dict:
    """A reference TrackNetV3 state dict (``nn.BatchNorm2d`` buffers and
    all) of the README's TrackNet (seq_len 8, concat: 27 input channels),
    seeded: He-scaled conv weights, so that the activations stay O(1)
    through the 17 layers, and BatchNorm statistics far enough from (0, 1)
    that dropping them shows."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    sd, cin = {}, 3 * (L + 1)
    skips = {"up_block_1": 256, "up_block_2": 128, "up_block_3": 64}
    for block, n, cout in _REF_TRACKNET:
        c = cin + skips.get(block, 0) if block.startswith("up") else cin
        for i in range(1, n + 1):
            pre = f"{block}.conv_{i}"
            sd[f"{pre}.conv.weight"] = t(rng.normal(0, math.sqrt(2 / (9 * c)), (cout, c, 3, 3)))
            sd[f"{pre}.bn.weight"] = t(rng.uniform(0.5, 1.5, cout))
            sd[f"{pre}.bn.bias"] = t(rng.normal(0, 0.1, cout))
            sd[f"{pre}.bn.running_mean"] = t(rng.normal(0, 0.2, cout))
            sd[f"{pre}.bn.running_var"] = t(rng.uniform(0.4, 1.6, cout))
            sd[f"{pre}.bn.num_batches_tracked"] = torch.tensor(1000, dtype=torch.long)
            c = cout
        cin = cout
    sd["predictor.weight"] = t(rng.normal(0, math.sqrt(2 / 64), (L, 64, 1, 1)))
    sd["predictor.bias"] = t(rng.normal(0, 0.1, L))
    return sd


def reference_inpaintnet_state_dict(seed: int) -> dict:
    """A reference InpaintNet state dict (its ``buttleneck`` keys have no
    ``.conv`` level), seeded."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}
    for ref, cin, cout in _REF_INPAINT:
        key = ref if ref.startswith("buttleneck") else f"{ref}.conv"
        sd[f"{key}.weight"] = torch.tensor(rng.normal(0, 0.2, (cout, cin, 3)).astype(np.float32))
        sd[f"{key}.bias"] = torch.tensor(rng.normal(0, 0.1, cout).astype(np.float32))
    sd["predictor.weight"] = torch.tensor(rng.normal(0, 0.2, (2, 32, 3)).astype(np.float32))
    sd["predictor.bias"] = torch.tensor(rng.normal(0, 0.1, 2).astype(np.float32))
    return sd


def reference_tracknet_forward(sd: dict, x):
    """The reference TrackNet (model.py:44-73) in ``torch.nn.functional``,
    independent of the port's modules: conv, BatchNorm on the running
    statistics, ReLU; max pools, nearest upsamples, skip concats; sigmoid.
    NCHW in, (N, L, H, W) probabilities out."""
    import torch
    import torch.nn.functional as F

    def block(x, name, n):
        for i in range(1, n + 1):
            pre = f"{name}.conv_{i}"
            x = F.conv2d(x, sd[f"{pre}.conv.weight"], padding=1)
            x = F.batch_norm(x, sd[f"{pre}.bn.running_mean"], sd[f"{pre}.bn.running_var"],
                             sd[f"{pre}.bn.weight"], sd[f"{pre}.bn.bias"], training=False,
                             eps=1e-5)
            x = F.relu(x)
        return x

    x1 = block(x, "down_block_1", 2)
    x2 = block(F.max_pool2d(x1, 2), "down_block_2", 2)
    x3 = block(F.max_pool2d(x2, 2), "down_block_3", 3)
    x = block(F.max_pool2d(x3, 2), "bottleneck", 3)
    x = block(torch.cat([F.interpolate(x, scale_factor=2), x3], 1), "up_block_1", 3)
    x = block(torch.cat([F.interpolate(x, scale_factor=2), x2], 1), "up_block_2", 2)
    x = block(torch.cat([F.interpolate(x, scale_factor=2), x1], 1), "up_block_3", 2)
    return torch.sigmoid(F.conv2d(x, sd["predictor.weight"], sd["predictor.bias"]))


def reference_inpaintnet_forward(sd: dict, coords, mask):
    """The reference InpaintNet (model.py:76-129) in ``torch.nn.functional``."""
    import torch
    import torch.nn.functional as F

    def block(x, ref):
        key = ref if ref.startswith("buttleneck") else f"{ref}.conv"
        return F.leaky_relu(F.conv1d(x, sd[f"{key}.weight"], sd[f"{key}.bias"], padding=1), 0.01)

    x = torch.cat([coords, mask], -1).transpose(1, 2)
    x1 = block(x, "down_1")
    x2 = block(x1, "down_2")
    x3 = block(x2, "down_3")
    x = block(block(x3, "buttleneck.conv_1"), "buttleneck.conv_2")
    x = block(torch.cat([x, x3], 1), "up_1")
    x = block(torch.cat([x, x2], 1), "up_2")
    x = block(torch.cat([x, x1], 1), "up_3")
    x = F.conv1d(x, sd["predictor.weight"], sd["predictor.bias"], padding=1)
    return torch.sigmoid(x).transpose(1, 2)


def wrong_converter_params(sd: dict, name: str):
    """The folded bf16 ``hand_9tap`` weights of a deliberately wrong
    converter of ``sd``: ``kernels_transposed`` leaves every 3x3 kernel
    spatially transposed (kh and kw swapped), ``stats_dropped`` writes mean 0
    and variance 1 in place of the running statistics."""
    import torch

    from tracknetv3_tpu_torch.convert_reference_checkpoint import convert_tracknet
    from tracknetv3_tpu_torch.models.convert import tracknet_from_jax
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.models.fused_forward import fold_batchnorm, fused_params

    variables = convert_tracknet(sd)
    for block, n, _ in _REF_TRACKNET:
        for i in range(1, n + 1):
            p, st = variables["params"][block][f"conv_{i}"], variables["batch_stats"][block]
            if name == "kernels_transposed":
                p["conv"]["kernel"] = p["conv"]["kernel"].transpose(1, 0, 2, 3)
            else:
                bn = st[f"conv_{i}"]["bn"]
                bn["mean"], bn["var"] = np.zeros_like(bn["mean"]), np.ones_like(bn["var"])
    model = get_model("TrackNet", L, "concat", dtype=torch.float32)
    model.load_state_dict(tracknet_from_jax(variables))
    return fused_params(fold_batchnorm(model), torch.bfloat16, DEVICE, "hand_9tap")


def _convert_cli(pairs) -> float:
    """Both conversions through the module's CLI, each in its own process,
    at once; their wall seconds."""
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-m",
                               "tracknetv3_tpu_torch.convert_reference_checkpoint",
                               "--in", src, "--out", dst], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for src, dst in pairs]
    try:
        for (src, _), p in zip(pairs, procs):
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                fail("convert", f"converting {src} took over 120 s")
            if p.returncode != 0 or "Converted" not in out:
                fail("convert", f"converting {src} exited {p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.time() - t0


def phase_convert(tmp: str, card: str) -> dict:
    """convert: reference TrackNetV3 checkpoints (seeded, in the reference's
    ``torch.save`` layout) brought to the card through ``python -m
    tracknetv3_tpu_torch.convert_reference_checkpoint`` and served by
    ``predict_video`` (a ``CONVERT_T``-frame video from the stand-in native
    reader, batch 16, bf16, ``hand_9tap``, InpaintNet), the served window
    probabilities held to ``reference_tracknet_forward`` in float32 (TF32
    off) on the same inputs within ``CONVERT_BOUNDS``, which each wrong
    converter must fail; the converted InpaintNet held to its reference
    forward in float32. Returns the path's launches."""
    import torch

    from tracknetv3_tpu_torch import inference as tinf
    from tracknetv3_tpu_torch.device import tf32_off
    from tracknetv3_tpu_torch.models.fused_forward import tracknet_fused_forward
    from tracknetv3_tpu_torch.training.checkpoint import load_checkpoint, load_model_from_checkpoint

    t_phase = time.time()
    d = os.path.join(tmp, "convert")
    os.makedirs(d, exist_ok=True)
    refs = {"TrackNet": (reference_tracknet_state_dict(CONVERT_SEED),
                         {"model_name": "TrackNet", "seq_len": L, "bg_mode": "concat"}),
            "InpaintNet": (reference_inpaintnet_state_dict(CONVERT_SEED + 1),
                           {"model_name": "InpaintNet", "seq_len": INPAINT_SEQ})}
    pairs, out = [], {}
    for name, (sd, pd) in refs.items():
        src, out[name] = os.path.join(d, f"{name}_reference.pt"), os.path.join(d, f"{name}.pt")
        torch.save({"model": sd, "param_dict": pd, "epoch": 29, "max_val_acc": 0.9}, src)
        pairs.append((src, out[name]))
    convert_s = _convert_cli(pairs)
    for name, (_, pd) in refs.items():
        got = load_checkpoint(out[name])
        if got["param_dict"] != pd or (got["epoch"], got["max_val_acc"]) != (29, 0.9):
            fail("convert", f"{name}: the converted file holds {got['param_dict']}, "
                 f"epoch {got['epoch']}, max_val_acc {got['max_val_acc']}")

    scene = _Scene(seed=CONVERT_SEED)
    src = f"synthetic://convert_{CONVERT_T}.mp4"
    videos = {src: (CONVERT_T, scene, None)}
    inputs, served = [], []
    real_windows = tinf.TrackNetPredictor._windows

    def recording(self, pre, buf, med, starts, params=None):
        probs = real_windows(self, pre, buf, med, starts, params)
        inputs.append(pre(buf, med, starts))
        served.append(probs.clone())
        return probs

    _zero_launches()
    t0 = time.time()
    with mock.patch.object(tinf, "open_video", synthetic_reader(videos)), \
            mock.patch.object(tinf, "open_native_video", synthetic_native_reader(videos, [])), \
            mock.patch.object(tinf.TrackNetPredictor, "_windows", recording):
        pred = tinf.predict_video(src, out["TrackNet"], out["InpaintNet"], batch_size=PATHS_BATCH,
                                  device=DEVICE, conv_backend="hand_9tap", save_dir=d,
                                  video_name="convert")
    serve_s = time.time() - t0
    launches = _path_launches()
    chunks = _chunks_of(CONVERT_T, "weight", staged=True)
    with open(os.path.join(d, "convert_ball.csv")) as f:
        n_rows = sum(1 for _ in f) - 1

    # the readings: the served chunks and the wrong converters' forwards
    # against the reference forward, in float32 without TF32, on the same inputs
    sd = {k: v.to(DEVICE) for k, v in refs["TrackNet"][0].items()}
    wrong = {name: wrong_converter_params(refs["TrackNet"][0], name) for name in WRONG_CONVERTERS}
    gaps = {name: [] for name in ("served",) + WRONG_CONVERTERS}
    unsaturated = []
    with tf32_off(), torch.no_grad():
        for x, probs in zip(inputs, served):
            ref = reference_tracknet_forward(sd, x.float().permute(0, 3, 1, 2))
            unsaturated.append(float(((ref > 0.01) & (ref < 0.99)).float().mean()))
            outs = {"served": probs}
            for name, params in wrong.items():
                outs[name] = tracknet_fused_forward(params, x).permute(0, 3, 1, 2)
            for name, o in outs.items():
                diff = (o.float() - ref).abs()
                gaps[name].append((float(diff.max()), float(diff.mean())))
        inpaint = load_model_from_checkpoint(out["InpaintNet"])[0].to(DEVICE).eval()
        rng = np.random.default_rng(CONVERT_SEED)
        coords = torch.tensor(rng.uniform(0, 1, (16, INPAINT_SEQ, 2)).astype(np.float32),
                              device=DEVICE)
        mask = torch.tensor((rng.random((16, INPAINT_SEQ, 1)) < 0.3).astype(np.float32),
                            device=DEVICE)
        isd = {k: v.to(DEVICE) for k, v in refs["InpaintNet"][0].items()}
        inpaint_err = float((inpaint(coords, mask) - reference_inpaintnet_forward(isd, coords, mask))
                            .abs().max())
    bound, mean_bound = CONVERT_BOUNDS
    readings = {name: {"max": max(g[0] for g in v), "mean_worst_chunk": max(g[1] for g in v)}
                for name, v in gaps.items()}
    for r in readings.values():
        r["within_bound"] = r["max"] <= bound and r["mean_worst_chunk"] <= mean_bound
    res = {"phase": "convert", "reference": "seeded, torch.save layout, README TrackNet "
           "(seq_len 8, concat) + InpaintNet", "convert_s": convert_s, "frames": CONVERT_T,
           "batch_size": PATHS_BATCH, "conv_backend": "hand_9tap", "chunks": chunks,
           "launches": launches,
           "launches_per_chunk": {k: launches[k] / chunks for k in PATHS_KERNELS},
           "csv_rows": n_rows, "entry_rows": len(pred["Frame"]), "serve_s": serve_s,
           "bound": bound, "mean_bound": mean_bound, "readings": readings,
           "reference_unsaturated_share_min": min(unsaturated),
           "inpaint_max_abs_err": inpaint_err, "inpaint_bound": INPAINT_CONVERT_BOUND,
           "phase_s": time.time() - t_phase, "card": card}
    emit(res)
    emit({"phase": "convert", "chunk_gaps": gaps}, detail=True)
    if launches != _want_launches(chunks) or len(inputs) != chunks:
        fail("convert", f"launches {launches} over {len(inputs)} chunks != "
             f"{_want_launches(chunks)} ({chunks} chunks)")
    if n_rows != CONVERT_T:
        fail("convert", f"{n_rows} CSV rows != {CONVERT_T}")
    if not readings["served"]["within_bound"]:
        fail("convert", f"the served probabilities are off the reference forward: "
             f"{readings['served']} (bounds {bound} / {mean_bound})")
    for name in WRONG_CONVERTERS:
        if readings[name]["within_bound"]:
            fail("convert", f"the wrong converter {name} passes the bound: {readings[name]}")
    if min(unsaturated) < 0.5:
        fail("convert", f"the reference probabilities saturate: {min(unsaturated)} unsaturated")
    if not inpaint_err <= INPAINT_CONVERT_BOUND:
        fail("convert", f"InpaintNet off its reference forward by {inpaint_err}")
    return {"convert": launches}


# ---------------------------------------------------------------- data-parallel training

SHARES = 2  # the data-parallel phase's shares of the README batch: 2 of 5
SPLIT_KERNELS = ("bn_stats_sums", "bn_relu_fwd_split", "bn_relu_bwd_sums",
                 "bn_relu_bwd_apply_split")
SPLIT_REPLACES = {"bn_stats_sums": "tools/probe_bn_pool.py:128",
                  "bn_relu_fwd_split": "tools/probe_bn_pool.py:167",
                  "bn_relu_bwd_sums": "tracknetv3_tpu/models/fused_forward.py:285",
                  "bn_relu_bwd_apply_split": "tracknetv3_tpu/models/fused_forward.py:285"}
# the split normalise also takes the rest of stats_kernel (its finalize)
SPLIT_ALSO_REPLACES = {"bn_relu_fwd_split": ["tools/probe_bn_pool.py:128 (the statistics "
                                             "from summed sums)"]}
# per layer of one share: activation elements read or written, float32
# C-vectors read or written, float64 (2, C) sums read or written (the split
# normalise with the running statistics, as the first share runs it)
SPLIT_TRAFFIC = {"bn_stats_sums": (1, 0, 1), "bn_relu_fwd_split": (2, 10, 1),
                 "bn_relu_bwd_sums": (2, 3, 1), "bn_relu_bwd_apply_split": (3, 7, 2)}
# float32 / float64 operations per activation element and per channel,
# counted from csrc/batchnorm.cu (the split normalise: the normalise's per
# element, the old forward finalize's per channel; the split apply: the
# apply's per element, the old backward finalize's per channel)
SPLIT_OPS = {"bn_stats_sums": (3, 0), "bn_relu_fwd_split": (4, 16),
             "bn_relu_bwd_sums": (10, 0), "bn_relu_bwd_apply_split": (11, 12)}
# launches of each kernel per layer and train step over SHARES shares: one
# of each a share
SPLIT_PER_LAYER = {k: SHARES for k in SPLIT_KERNELS}
# a split kernel against its plain version on equal inputs, relative L2: the
# sums (float64, added in another order), the fused normalise and apply (the
# same float32 roundings)
SPLIT_BOUNDS = {"sums": 1e-12, "fused": 1e-6}
# launches of bn_stats_sums on one input whose bits must all be equal
SPLIT_REPEATS = 20
# the float32 (TF32 off, deterministic cuDNN) step over SHARES shares against
# the single step on the global batch: loss relative error, the worst
# gradient's relative L2, all gradients as one vector (relative L2), the
# worst running statistic's relative L2, and the parameters after Adam as
# one vector (relative L2). On an H100 the card stood in twice read 0,
# 1.1e-2 (a BatchNorm bias; the first conv's weight 9.2e-3), 1.37e-3,
# 3.3e-7 and 2.2e-3 (Adam's first step moves each weight by about lr *
# sign(g), so a gradient element near 0 that rounds the other way moves a
# whole element). Two witnesses place it in cuDNN's convolutions of a half
# batch: with cuDNN off on both sides the same comparison read 0, 1.6e-7,
# 6.1e-8, 0 and 2.5e-8, and the single step with its rows reordered 0,
# 5.3e-5, 5.8e-6, 0 and 1.1e-5. Two wrong steps: the unsynchronised one read
# 4.8e-5, 1.03, 0.126, 0.90 and 2.9e-2; the one whose backward alone is
# unsynchronised 0, 0.123, 1.97e-2, 3.3e-7 and 9.9e-3. The bounds sit
# between the sound reading and the wrong ones: the first fails all five,
# the second the worst gradient, the one vector and the parameters.
MESH_STEP_BOUNDS = {"loss": 1e-5, "grad": 4e-2, "grads_as_one_vector": 5e-3, "stats": 1e-4,
                    "params": 5e-3}
# mesh_procs_train: the processes' float32 steps, held after the first to
# the single step (MESH_STEP_BOUNDS) and after the last to the same steps
# over the card stood in twice in one process (relative error of the losses
# and of the parameters as one vector), and their timed bf16 steps
MESH_TRAIN_STEPS = 2
MESH_PROCS_BOUND = 1e-6
MESH_PROCS_TIMED = 4
MESH_TRAIN_CHILD = r"""
import time
T0 = time.time()
import datetime, json, sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
import chip_smoke as cs
dist.init_process_group({backend!r}, init_method="tcp://127.0.0.1:{port}", world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=60))
try:
    res = cs._group_train({data!r}, {out!r}, {go!r}, {card}, time.time() - T0, {stages!r})
    res["seconds"]["child"] = time.time() - T0
    print("MESH_TRAIN " + json.dumps(res), flush=True)
finally:
    dist.destroy_process_group()
"""


def _device_kernels(fn, n: int = 10) -> dict:
    """{kernel name: [launches a call, device us a launch]} of ``n`` calls of
    ``fn`` under torch.profiler (CUPTI), after a warm-up call."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.count:
            out[evt.key[:80]] = [evt.count / n, evt.self_device_time_total / evt.count]
    return out


def _rows_of(y):
    """The (rows, C) float32 numpy rows of an NCHW view of channels_last memory."""
    return y.permute(0, 2, 3, 1).reshape(-1, y.shape[1]).float().cpu().numpy()


def _unequal(got, want) -> int:
    """Words of the tensors ``got`` that differ from those of ``want``."""
    return sum(int((a != b).sum()) for a, b in zip(got, want))


# the split kernels that fold a finalize into one launch
SPLIT_FUSED = ("bn_stats_sums", "bn_relu_fwd_split", "bn_relu_bwd_apply_split")


def _split_vs_plain(old_bn=None):
    """The split BatchNorm entry points against their plain versions at the
    train step's four shapes at a share of B / SHARES (bf16, as training
    runs them, and float32) within ``SPLIT_BOUNDS``; the forward's summed
    sums are the share's and another share's (``_bn_data`` of another seed).
    Bit for bit: the forward's sums over SPLIT_REPEATS launches and against
    the numpy model of the kernel's order; the split normalise's out, st and
    running statistics against its plain pair (the finalize, then the
    normalise), against the unsplit normalise kernel on the plain st and,
    with ``old_bn`` (another tree's batchnorm module), against its finalize
    + normalise kernels; a launch without running statistics against one
    with them; the synchronised op over the two shares on the card stood in
    twice against one split normalise a share, the running statistics
    updated once; the split apply's dy, dgamma and dbeta against the unsplit
    apply kernel on the plain finalize's coefficients. A wrong split
    normalise that takes the share's own sums over its own rows must read
    unequal. Device launches a call of SPLIT_FUSED (torch.profiler): 1 each.
    Times in bf16, summed over one share's 17 layers; with ``old_bn`` the
    old pair (a finalize and SHARES normalises a layer) and SHARES split
    normalises timed in turns (old, new, new, old), the old pair's launches
    traced apart."""
    import torch

    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(DEVICE)
    twice = pmesh.mesh_reducer(pmesh.make_mesh(devices=[DEVICE] * SHARES))
    rows, errs = [], dict.fromkeys(SPLIT_BOUNDS, 0.0)
    unequal = dict.fromkeys(
        ("sums_repeats", "sums_vs_model", "fwd_split_vs_plain_pair", "fwd_split_vs_unsplit_fwd",
         "fwd_split_without_running_stats", "fwd_split_over_shares",
         "apply_split_vs_unsplit_apply") + (("fwd_split_vs_old_pair",) if old_bn else ()), 0)
    times = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set()}
             for k in SPLIT_KERNELS}
    turns, old_traced, wrong = [0.0] * 4, {}, []
    flat = lambda ts: torch.cat([t.double().flatten() for t in ts])  # noqa: E731
    for i, (shape, layers) in enumerate(BN_SHAPES.items()):
        shape = (B // SHARES,) + shape[1:]
        n = math.prod(shape[:-1])
        n_all = SHARES * n
        C = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            y, g, gamma, beta, rm, rv = _bn_data(shape, dtype, 50 + i, dev)
            y2 = _bn_data(shape, dtype, 150 + i, dev)[0]  # the other share's rows
            sums = bn.bn_stats_sums_plain(y)
            total = sums + bn.bn_stats_sums_plain(y2)
            rm_p, rv_p = rm.clone(), rv.clone()
            st = bn.bn_stats_finalize_plain(total, n_all, gamma, rm_p, rv_p)
            plain_pair = (bn.bn_relu_fwd_plain(y, st, beta), st, rm_p, rv_p)
            rm_k, rv_k = rm.clone(), rv.clone()
            fwd = (*bn.bn_relu_fwd_split(y, gamma, beta, total, n_all, rm_k, rv_k), rm_k, rv_k)
            rm_w, rv_w = rm.clone(), rv.clone()
            own = (*bn.bn_relu_fwd_split(y, gamma, beta, bn.bn_stats_sums(y), n, rm_w, rv_w),
                   rm_w, rv_w)
            # the synchronised op over both shares: the running update once
            rm_s, rv_s = rm.clone(), rv.clone()
            with torch.no_grad():
                over = bn.split_bn_relu_train([y, y2], [gamma] * SHARES, [beta] * SHARES, rm_s,
                                              rv_s, twice)
            ktotal = bn.bn_stats_sums(y) + bn.bn_stats_sums(y2)
            rm_1, rv_1 = rm.clone(), rv.clone()
            once = [bn.bn_relu_fwd_split(y, gamma, beta, ktotal, n_all, rm_1, rv_1)[0],
                    bn.bn_relu_fwd_split(y2, gamma, beta, ktotal, n_all)[0]]
            gsums = bn.bn_relu_bwd_sums_plain(g, y, st, beta)
            btotal = gsums * SHARES  # as if every share had this one's sums
            ksums = [bn.bn_stats_sums(y) for _ in range(SPLIT_REPEATS)]
            plan = bn.sums_plan(n, C, y.element_size(), bn._max_clusters(y.device.index, dtype))
            model = torch.from_numpy(bn.bn_stats_sums_in_order(_rows_of(y), plan))
            fused = bn.bn_relu_bwd_apply_split(g, y, st, beta, gsums, btotal, n_all)
            dg_p, db_p, coef_p = bn.bn_relu_bwd_finalize_plain(gsums, btotal, n_all, st, True)
            row = {"shape_NHWC": list(shape), "dtype": str(dtype).split(".")[-1],
                   "clusters": plan.clusters, "rows_per_block": plan.rows_per_block}
            row["sums_repeats_unequal"] = sum(int(not torch.equal(t, ksums[0]))
                                              for t in ksums[1:])
            row["sums_vs_model_unequal"] = int(not torch.equal(ksums[0].cpu(), model))
            row["fwd_split_vs_plain_pair_unequal"] = _unequal(fwd, plain_pair)
            row["fwd_split_vs_unsplit_fwd_unequal"] = _unequal(
                fwd[:1], [bn.bn_relu_fwd(y, st, beta)])
            row["fwd_split_without_running_stats_unequal"] = _unequal(
                bn.bn_relu_fwd_split(y, gamma, beta, total, n_all), fwd[:2])
            row["fwd_split_over_shares_unequal"] = _unequal([*over, rm_s, rv_s],
                                                            [*once, rm_1, rv_1])
            row["apply_split_vs_unsplit_apply_unequal"] = _unequal(
                fused, (bn.bn_relu_bwd_apply(g, y, st, beta, coef_p), dg_p, db_p))
            if old_bn is not None:
                rm_o, rv_o = rm.clone(), rv.clone()
                st_o = old_bn.bn_stats_finalize(total, n_all, gamma, rm_o, rv_o)
                row["fwd_split_vs_old_pair_unequal"] = _unequal(
                    fwd, (old_bn.bn_relu_fwd(y, st_o, beta), st_o, rm_o, rv_o))
            for name in unequal:
                unequal[name] += row[f"{name}_unequal"]
            row["wrong_own_sums_unequal"] = _unequal(own, plain_pair)
            wrong.append(row["wrong_own_sums_unequal"])
            got = {
                "bn_stats_sums": (ksums[0], sums),
                "bn_relu_fwd_split": (flat(fwd), flat(plain_pair)),
                "bn_relu_bwd_sums": (bn.bn_relu_bwd_sums(g, y, st, beta), gsums),
                "bn_relu_bwd_apply_split": (flat(fused), flat(bn.bn_relu_bwd_apply_split_plain(
                    g, y, st, beta, gsums, btotal, n_all))),
            }
            for k, (a, b) in got.items():
                kind = "sums" if k.endswith("sums") else "fused"
                # each row of the sums apart: Σy² dwarfs Σy
                e = (max(_rel_l2(a[j], b[j]) for j in range(2)) if kind == "sums"
                     else _rel_l2(a, b))
                row[k] = e
                row[f"{k}_max_abs_err"] = float((a.double() - b.double()).abs().max())
                errs[kind] = max(errs[kind], e)
            if dtype == torch.bfloat16:
                st_k = fwd[1]
                rm_t, rv_t = rm.clone(), rv.clone()
                calls = {
                    "bn_stats_sums": (lambda f: lambda j: f(y), bn.bn_stats_sums,
                                      bn.bn_stats_sums_plain),
                    "bn_relu_fwd_split": (
                        lambda f: lambda j: f(y, gamma, beta, total, n_all, rm_t, rv_t),
                        bn.bn_relu_fwd_split, bn.bn_relu_fwd_split_plain),
                    "bn_relu_bwd_sums": (lambda f: lambda j: f(g, y, st_k, beta),
                                         bn.bn_relu_bwd_sums, bn.bn_relu_bwd_sums_plain),
                    "bn_relu_bwd_apply_split": (
                        lambda f: lambda j: f(g, y, st_k, beta, gsums, btotal, n_all),
                        bn.bn_relu_bwd_apply_split, bn.bn_relu_bwd_apply_split_plain),
                }
                for k, (call, kern, plain) in calls.items():
                    elems, vecs, sums2 = SPLIT_TRAFFIC[k]
                    per_elem, per_chan = SPLIT_OPS[k]
                    # three windows each, for the script's time limit
                    t = time_launches(call(kern), windows=3)
                    tp = time_launches(call(plain), n=10, windows=3)
                    bms, by = bound_ms(elems * n * C * y.element_size() + vecs * 4 * C
                                       + sums2 * 16 * C, per_elem * n * C + per_chan * C)
                    row[f"{k}_ms"] = t
                    times[k]["ms"] += layers * t
                    times[k]["plain_ms"] += layers * tp
                    times[k]["bound_ms"] += layers * bms
                    times[k]["bound_by"].add(by)
                if i == 0 or old_bn is not None:  # device launches a call, traced
                    row["device_launches_a_call"] = {k: _device_kernels(calls[k][0](calls[k][1]))
                                                     for k in SPLIT_FUSED}
                if old_bn is not None:
                    def old_layer(j):  # a finalize and SHARES normalises
                        st_o = old_bn.bn_stats_finalize(total, n_all, gamma, rm_t, rv_t)
                        for _ in range(SHARES):
                            old_bn.bn_relu_fwd(y, st_o, beta)

                    def new_layer(j):  # SHARES split normalises, the first with the update
                        bn.bn_relu_fwd_split(y, gamma, beta, total, n_all, rm_t, rv_t)
                        for _ in range(SHARES - 1):
                            bn.bn_relu_fwd_split(y, gamma, beta, total, n_all)

                    four = [time_launches(f, windows=3)
                            for f in (old_layer, new_layer, new_layer, old_layer)]
                    row["fwd_split_turns_ms"] = four
                    turns = [a + layers * b for a, b in zip(turns, four)]
                    old_traced[str(list(shape))] = row["old_device_launches_a_call"] = \
                        _device_kernels(old_layer)
            rows.append(row)
            emit({"phase": "split_vs_plain", **row}, detail=True)
    for k, v in times.items():
        v["bound_by"] = "/".join(sorted(v["bound_by"]))
        v["library_ms"] = None  # no one PyTorch call computes these sums or fused ops
        v["max_abs_err"] = max(r[f"{k}_max_abs_err"] for r in rows)
    a_call = {k: sum(c[0] for c in rows[0]["device_launches_a_call"][k].values())
              for k in SPLIT_FUSED}
    emit({"phase": "split_vs_plain", "shares": SHARES, "share_batch": B // SHARES,
          "worst": errs, "bounds": SPLIT_BOUNDS, "unequal": unequal,
          "wrong_own_sums_unequal": wrong, "sums_repeats": SPLIT_REPEATS,
          "device_launches_a_call": a_call,
          "ms_per_share_step": {k: v["ms"] for k, v in times.items()},
          "bound_ms": {k: v["bound_ms"] for k, v in times.items()},
          **({"fwd_turns_old_new_new_old_ms_per_step": turns,
              "old_device_kernels_by_shape": old_traced} if old_bn is not None else {})})
    for kind, e in errs.items():
        if not e <= SPLIT_BOUNDS[kind]:
            fail("split_vs_plain", f"{kind}: {e} > {SPLIT_BOUNDS[kind]}")
    if any(unequal.values()):
        fail("split_vs_plain", f"unequal bits where none may differ: {unequal}")
    if not all(wrong):
        fail("split_vs_plain", f"the split normalise on the share's own sums reads equal: {wrong}")
    # one launch a call (a trace may lose an event: 0.9 reads as 1)
    if any(round(v) != 1 for v in a_call.values()):
        fail("split_vs_plain", f"device launches a call {a_call}, not 1 each")
    return times


def _crossing_mixup():
    """The global batch's (perm, lam) with every partner on the other share."""
    rng = np.random.default_rng(9)
    perm = (np.arange(B) + B // SHARES) % B
    lam = np.maximum(rng.uniform(0, 1, B), 0.5).astype(np.float32)
    return perm.astype(np.int64), lam


def _mesh_step_result(model, loss) -> dict:
    import torch

    return {"loss": float(loss),
            "grads": {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()},
            "stats": {k: v.detach().float().cpu() for k, v in model.named_buffers()},
            "params": torch.cat([p.detach().float().flatten().cpu()
                                 for p in model.parameters()])}


def _flat(tensors):
    import torch

    return torch.cat([t.flatten() for t in tensors])


def _mesh_readings(got: dict, want: dict) -> dict:
    grads = {k: _rel_l2(got["grads"][k], want["grads"][k]) for k in want["grads"]}
    stats = {k: _rel_l2(got["stats"][k], want["stats"][k]) for k in want["stats"]}
    every = [_flat(got["grads"].values()), _flat(want["grads"].values())]
    bn_grads = {k: v for k, v in grads.items() if ".bn." in k}
    conv_grads = {k: v for k, v in grads.items() if ".bn." not in k}
    r = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
         "grad": max(grads.values()), "grad_worst": max(grads, key=grads.get),
         # where the gradient error sits: BatchNorm parameters, convs
         "grad_bn": max(bn_grads.values()), "grad_conv": max(conv_grads.values()),
         "grad_conv_worst": max(conv_grads, key=conv_grads.get),
         "grads_as_one_vector": _rel_l2(*every),
         "stats": max(stats.values()), "stats_worst": max(stats, key=stats.get),
         "params": _rel_l2(got["params"], want["params"])}
    r["within_bounds"] = all(r[k] <= b for k, b in MESH_STEP_BOUNDS.items())
    return r


def _each_share_its_own(ys, weights, biases, running_mean, running_var, reducer, ops=None):
    """The unsynchronised version: each share with its own statistics."""
    from tracknetv3_tpu_torch.ops import batchnorm as bn

    return [bn.bn_relu_train(y, w, b, running_mean, running_var)
            for y, w, b in zip(ys, weights, biases)]


def _apply_from_own_sums(g, y, st, bias, local, total, n):
    """The backward unsynchronised: each share's coefficients from its own
    sums over its own rows (the forward's statistics stay global)."""
    from tracknetv3_tpu_torch.ops import batchnorm as bn

    return bn.bn_relu_bwd_apply_split(g, y, st, bias, local, local, n // SHARES)


def _rows_reordered(batch, perm, lam):
    """The batch with its halves swapped, and the mixup that pairs the same
    windows with the same weights: the same step, every sum over the batch
    in another order."""
    import torch

    order = np.roll(np.arange(B), B // 2)
    where = np.argsort(order)  # the new row of each old row
    moved = {k: (v[torch.from_numpy(order).to(v.device)] if torch.is_tensor(v) else v[order])
             for k, v in batch.items()}
    return moved, where[perm[order]], lam[order]


def _one_step(base, batch, perm, lam, mesh=None, group=None, steps_n: int = 1):
    """``steps_n`` float32 Adam steps of a copy of ``base`` on the README batch
    (sample mixup with ``perm`` / ``lam``), on one device or over ``mesh`` /
    ``group``; the first step's result (loss, gradients, statistics,
    parameters), every loss, and the parameters after each step as one
    float32 vector on the host."""
    import torch

    from tracknetv3_tpu_torch.parallel.mesh import shard_train_batch
    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import (make_tracknet_shares_train_step,
                                                     make_tracknet_train_step)

    dev = torch.device(DEVICE)
    model = copy.deepcopy(base).to(dev, memory_format=torch.channels_last)
    model.dtype = torch.float32
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    if mesh is None and group is None:
        step = make_tracknet_train_step(model, opt, "concat", 0.5, sched)
        args = (batch, torch.from_numpy(perm).to(dev), torch.from_numpy(lam).to(dev))
    else:
        step = make_tracknet_shares_train_step(model, opt, "concat", 0.5, sched, mesh=mesh,
                                               group=group)
        args = (shard_train_batch(batch, mesh) if group is None else [batch], perm, lam)
    losses, params = [], []
    for i in range(steps_n):
        loss = step(args[0], i, *args[1:])
        if i == 0:
            first = _mesh_step_result(model, loss)
        losses.append(float(loss))
        params.append(_flat(p.detach().float().cpu() for p in model.parameters()))
    return first, losses, params


def _f32_deterministic():
    """TF32 off and deterministic cuDNN without autotuning (the parity runs')."""
    import torch

    stack = contextlib.ExitStack()
    from tracknetv3_tpu_torch.device import tf32_off

    stack.enter_context(tf32_off())
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                   deterministic=True, allow_tf32=False))
    return stack


def _mesh_step_parity(data_dir: str, meshes: dict, card: str) -> dict:
    """The float32 step over each mesh against the single step, and the two
    wrong steps, which must fail the bounds. Returns what the training
    processes are held to: the single step's loss and parameters, and
    MESH_TRAIN_STEPS steps' losses and last parameters over the card stood
    in twice."""
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import batchnorm as bn

    batch = _first_batch(data_dir, torch.device(DEVICE))
    perm, lam = _crossing_mixup()
    base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(41),
                     dtype=torch.float32)
    wrong = {"unsynchronised": mock.patch.object(bn, "sync_bn_relu_train",
                                                 _each_share_its_own),
             "backward_unsynchronised": mock.patch.object(
                 bn, "SPLIT_KERNEL_OPS",
                 bn.SPLIT_KERNEL_OPS._replace(bwd_apply=_apply_from_own_sums))}
    res = {}
    with _f32_deterministic():
        want, single_losses, single_params = _one_step(base, batch, perm, lam)
        refs = {"single": (single_losses[0], single_params[0])}
        for name, mesh in meshes.items():
            got, losses, params = _one_step(base, batch, perm, lam, mesh,
                                            steps_n=MESH_TRAIN_STEPS)
            res[name] = _mesh_readings(got, want)
            if name == "card_twice":
                refs["mesh"] = (losses, params[-1])
        for name, patch in wrong.items():
            with patch:
                res[name] = _mesh_readings(
                    _one_step(base, batch, perm, lam, meshes["card_twice"])[0], want)
        witness = {"single_rows_reordered": _mesh_readings(
            _one_step(base, *_rows_reordered(batch, perm, lam))[0], want)}
        conv = torch.nn.functional.conv2d
        # PyTorch's own convs, whose NCHW output the BatchNorm kernels get in
        # channels_last memory, as cuDNN's
        with torch.backends.cudnn.flags(enabled=False), mock.patch.object(
                torch.nn.functional, "conv2d", lambda *a, **k: conv(*a, **k).contiguous(
                    memory_format=torch.channels_last)):
            witness["cudnn_off_card_twice_vs_single"] = _mesh_readings(
                _one_step(base, batch, perm, lam, meshes["card_twice"])[0],
                _one_step(base, batch, perm, lam)[0])
    emit({"phase": "mesh_step_parity", "dtype": "float32", "tf32": False, "shares": SHARES,
          "bounds": MESH_STEP_BOUNDS, "loss_single": want["loss"], "vs": res,
          "witness": witness, "card": card})
    for name, r in res.items():
        if r["within_bounds"] == (name in wrong):
            fail("mesh_step_parity", f"{name}: {r} (bounds {MESH_STEP_BOUNDS}; the wrong "
                 f"steps {sorted(wrong)} must fail them)")
    return refs


def _timed_reducer(mesh, spent: list):
    """``mesh_reducer(mesh)`` whose every sum is timed by CUDA events."""
    import torch

    from tracknetv3_tpu_torch.parallel.mesh import Reducer, mesh_reducer

    inner = mesh_reducer(mesh)

    def total(parts):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner.sum(parts)
        b.record()
        spent.append((a, b))
        return out

    return Reducer(total)


def _time_mesh_steps(model, batch, mesh, n: int = 12) -> dict:
    """ms of each bf16 train step over ``mesh`` after 2 warm-up, peak memory
    of each card, and the ms a step spends in the cross-share sums (CUDA
    events around each of the 34 reductions)."""
    import torch

    from tracknetv3_tpu_torch.parallel.mesh import shard_train_batch
    from tracknetv3_tpu_torch.training import steps as st
    from tracknetv3_tpu_torch.training.optim import build_optimizer

    perm, lam = _crossing_mixup()
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    spent: list = []
    with mock.patch.object(st, "mesh_reducer", lambda m: _timed_reducer(m, spent)):
        step = st.make_tracknet_shares_train_step(model, opt, "concat", 0.5, sched, mesh=mesh)
    shares = shard_train_batch(batch, mesh)
    cards = sorted({d.index for d in mesh.devices})
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    times, reduce_ms = [], []
    for i in range(n):
        for c in cards:
            torch.cuda.synchronize(c)
        spent.clear()
        t0 = time.perf_counter()
        step(shares, i, perm, lam)
        for c in cards:
            torch.cuda.synchronize(c)
        times.append((time.perf_counter() - t0) * 1e3)
        reduce_ms.append(sum(a.elapsed_time(b) for a, b in spent))
        reductions = len(spent)
    return {"median_ms_per_step": statistics.median(times[2:]), "ms_per_step": times[2:],
            "reductions_per_step": reductions,
            "reduce_ms_per_step": statistics.median(reduce_ms[2:]),
            "peak_mem_bytes": {f"cuda:{c}": torch.cuda.max_memory_allocated(c) for c in cards}}


def _wait_for(path: str) -> None:
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > MESH_CHILD_S:
            raise TimeoutError(f"no {path} within {MESH_CHILD_S} s")
        time.sleep(0.02)


def _group_train(data_dir: str, out: str, go: str, card: int, started_s: float,
                 stages=("f32", "shard", "bf16")) -> dict:
    """One rank of ``mesh_procs_train`` (a group of two: gloo on cuda:0, or
    NCCL with rank r on ``cuda:r``), on the card ``card``: its share of the
    README batch, made on the host; once the file ``go.f32`` exists (the
    parent's kernel timings are done), MESH_TRAIN_STEPS float32 steps (TF32
    off, deterministic cuDNN) whose parameters go to ``out`` (stage
    ``f32``), then the float32 step on its resident loaders' first batch
    under ``"shard"`` and ``"replicate"`` (stage ``shard``, phase 21:
    ``_resident_steps``), then ``out.done``; once ``go.bf16`` exists (the
    parent's step timings are done and the card is free), bf16 steps timed
    (stage ``bf16``). ``started_s``: the seconds from the process's start to
    the group."""
    import hashlib

    import torch
    import torch.distributed as dist

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.parallel.mesh import Mesh, split_batch
    from tracknetv3_tpu_torch.parallel.processes import device_group
    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import make_tracknet_shares_train_step

    t_setup = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    batch = _first_batch(data_dir, torch.device("cpu"))
    perm, lam = _crossing_mixup()
    base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(41),
                     dtype=torch.float32)
    t_wait = time.perf_counter()
    _wait_for(go + ".f32")
    t_start = time.perf_counter()
    dev = torch.device(DEVICE, card)
    torch.cuda.set_device(dev)
    group = device_group(dev)
    share = {k: split_batch(v, world)[rank].to(dev) for k, v in batch.items()}
    res = {"rank": rank, "backend": str(dist.get_backend()), "device": str(dev)}
    if "f32" in stages:
        with _f32_deterministic():
            _, losses, params = _one_step(base, share, perm, lam, Mesh((dev,)), group,
                                          steps_n=MESH_TRAIN_STEPS)
        np.savez(out, first=params[0].numpy(), last=params[-1].numpy())
        res.update(losses=losses, params_sha256=hashlib.sha256(
            params[-1].numpy().tobytes()).hexdigest())
    t_shard = time.perf_counter()
    if "shard" in stages:
        res["shard_steps"] = _resident_steps(data_dir, base, dev, group)
    open(out + ".done", "w").close()
    t_f32 = time.perf_counter()
    res["seconds"] = {"start": started_s, "setup": t_wait - t_setup, "waited": t_start - t_wait,
                      "float32": t_shard - t_start, "shard": t_f32 - t_shard}
    if "bf16" not in stages:
        return res
    _wait_for(go + ".bf16")
    t_bf16 = time.perf_counter()
    # bf16 steps as training runs them
    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(41)).to(
        dev, memory_format=torch.channels_last)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_shares_train_step(model, opt, "concat", 0.5, sched, mesh=Mesh((dev,)),
                                           group=group)
    _zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(2 + MESH_PROCS_TIMED):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step([share], i, perm, lam)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    res["seconds"].update(waited_bf16=t_bf16 - t_f32, bf16=time.perf_counter() - t_bf16)
    return {**res, "median_ms_per_step": statistics.median(times[2:]),
            "ms_per_step": times[2:], "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "split_launches": {k: _launches(bn)[k] for k in SPLIT_KERNELS}}


def _spawn_train_children(tmp: str, data_dir: str, backend: str,
                          stages=("f32", "shard", "bf16")):
    """Start a pair of ``mesh_procs_train``'s processes over ``backend``
    (gloo: both on cuda:0; nccl: rank r on cuda:r) that run ``stages`` of
    ``_group_train``; they set up on the host and wait for their go files.
    Returns (backend, processes, their output files, the go files' stem, the
    start time)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(tmp, f"mesh_train_{backend}_rank{r}.npz") for r in (0, 1)]
    go = os.path.join(tmp, f"mesh_train_{backend}_go")
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_TRAIN_CHILD.format(
            root=ROOT, backend=backend, port=port, rank=r, data=data_dir, out=outs[r], go=go,
            card=r if backend == "nccl" else 0, stages=tuple(stages))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    return backend, procs, outs, go, time.time()


def _release(children, stage: str) -> None:
    """Let a pair of training processes start their ``stage``: "f32" or "bf16"."""
    open(f"{children[3]}.{stage}", "w").close()


def _await_float32(children) -> None:
    """Wait until both processes of a pair have written their float32
    parameters (before the parent times anything on the card)."""
    backend, procs, outs, go, t0 = children
    while not all(os.path.exists(o + ".done") for o in outs):
        for r, p in enumerate(procs):
            if p.poll() is not None:
                fail("mesh_procs_train", f"{backend} rank {r} exited {p.returncode} before "
                     f"its float32 steps were written: {p.stderr.read()[-2000:]}")
        if time.time() - t0 > MESH_CHILD_S:
            fail("mesh_procs_train", f"{backend}: no float32 steps within {MESH_CHILD_S} s")
        time.sleep(0.05)


def _child_results(children, phase: str) -> list:
    """Each rank's result line of a pair of training processes, once they
    end (within MESH_CHILD_S of their start)."""
    backend, procs, outs, go, t0 = children
    ranks = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(MESH_CHILD_S - (time.time() - t0), 1))
            except subprocess.TimeoutExpired:
                fail(phase, f"{backend} rank {r} did not end within {MESH_CHILD_S} s")
            if p.returncode != 0:
                fail(phase, f"{backend} rank {r} exited {p.returncode}: {err[-2000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith("MESH_TRAIN ")]
            if len(lines) != 1:
                fail(phase, f"{backend} rank {r} printed no result: {out[-1000:]}")
            ranks.append(json.loads(lines[0][len("MESH_TRAIN "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ranks


def _mesh_procs_train(children, card: str, refs: dict) -> list:
    """Release a pair of ``_spawn_train_children``'s processes, whose float32
    steps are written, to their bf16 timings; hold their MESH_TRAIN_STEPS
    float32 steps to one process's (``refs``: the single step, and the same
    steps over the card stood in twice). Returns the ranks' results."""
    import torch

    backend, procs, outs, go, t0 = children
    t_go = time.time()
    _release(children, "bf16")
    ranks = _child_results(children, "mesh_procs_train")
    (single_loss, single_params), (mesh_losses, mesh_params) = refs["single"], refs["mesh"]
    readings = []
    for r, o in zip(ranks, outs):
        with np.load(o) as z:
            first, last = torch.from_numpy(z["first"]), torch.from_numpy(z["last"])
        readings.append({
            "single_step_loss": abs(r["losses"][0] - single_loss) / abs(single_loss),
            "single_step_params": _rel_l2(first, single_params),
            "mesh_losses": max(abs(a - b) / abs(b) for a, b in zip(r["losses"], mesh_losses)),
            "mesh_params": _rel_l2(last, mesh_params)})
    emit({"phase": "mesh_procs_train", "processes": 2, "backend": backend,
          "float32_steps": MESH_TRAIN_STEPS, "single_step_loss": single_loss,
          "mesh_losses": mesh_losses, "ranks": ranks, "vs_one_process": readings,
          "bounds": {"single_step": MESH_STEP_BOUNDS, "mesh": MESH_PROCS_BOUND},
          "wall_s": time.time() - t0, "after_go_s": time.time() - t_go, "card": card})
    if ranks[0]["params_sha256"] != ranks[1]["params_sha256"]:
        fail("mesh_procs_train", "the ranks' parameters differ")
    for r in readings:
        if (r["single_step_loss"] > MESH_STEP_BOUNDS["loss"]
                or r["single_step_params"] > MESH_STEP_BOUNDS["params"]
                or r["mesh_losses"] > MESH_PROCS_BOUND or r["mesh_params"] > MESH_PROCS_BOUND):
            fail("mesh_procs_train", f"a rank off one process: {r}")
    want_l = {k: BN_LAYERS * (2 + MESH_PROCS_TIMED) for k in SPLIT_KERNELS}  # a share a rank
    for r in ranks:
        if r["split_launches"] != want_l:
            fail("mesh_procs_train", f"rank {r['rank']}: launches {r['split_launches']} != "
                 f"{want_l}")
    return ranks


def phase_mesh_train(tmp: str, card: str) -> dict:
    """mesh_train: data-parallel training over SHARES shares of the README
    batch. Returns the split kernels' times, the main path's launches and
    each training process's float32 steps on its resident loaders (phase
    21's, by backend)."""
    import torch

    t_phase = time.time()
    torch.cuda.empty_cache()
    data_dir = os.path.join(tmp, "data")
    if not os.path.isdir(os.path.join(data_dir, "train")):
        write_synthetic_dataset(data_dir)
    _first_batch(data_dir, torch.device("cpu"))  # the frame caches, before the children read them
    # the training processes set up on the host while this one measures:
    # gloo on the card, and NCCL on two cards where there are two
    pairs = [_spawn_train_children(tmp, data_dir, "gloo")]
    if torch.cuda.device_count() >= 2:
        pairs.append(_spawn_train_children(tmp, data_dir, "nccl"))
    try:
        out = _mesh_train_measured(tmp, card, data_dir, pairs)
    finally:
        for p in (p for pair in pairs for p in pair[1]):
            if p.poll() is None:
                p.kill()
                p.wait()
    emit({"phase": "mesh_train_done", "phase_s": time.time() - t_phase, "card": card})
    return out


def _mesh_train_measured(tmp: str, card: str, data_dir: str, pairs):
    """phase_mesh_train's measurements; the ``pairs`` of training processes
    wait for the last."""
    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.parallel import mesh as pmesh
    from tracknetv3_tpu_torch.training import loop

    times = _split_vs_plain()
    # the processes' float32 steps run beside the untimed work that follows
    for pair in pairs:
        _release(pair, "f32")
    meshes = {"card_twice": pmesh.make_mesh(devices=["cuda:0", "cuda:0"])}
    if torch.cuda.device_count() >= 2:
        meshes["two_cards"] = pmesh.make_mesh(2)
    refs = _mesh_step_parity(data_dir, meshes, card)

    # the main path: the train CLI with --num_devices 2 (the card stood in
    # twice where it is alone), one epoch of the README configuration
    save_dir = os.path.join(tmp, "exp_mesh")
    argv = ["--seq_len", str(L), "--bg_mode", "concat", "--alpha", "0.5", "--batch_size",
            str(B), "--epochs", "1", "--num_devices", str(SHARES), "--data_dir", data_dir,
            "--save_dir", save_dir]
    stand_in = (mock.patch.object(loop, "make_mesh", lambda n, device: meshes["card_twice"])
                if "two_cards" not in meshes else contextlib.nullcontext())
    torch.backends.cudnn.benchmark = True
    _zero_launches()
    t0 = time.time()
    with stand_in, contextlib.redirect_stdout(sys.stderr):
        out = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = _launches(bn, wd)
    steps, h = out["step"], out["history"][0]
    del out  # the CLI's model and optimizer: out of the peaks below
    val = len(HeatmapBatchLoader(build_split_index(data_dir, "val", L, L), "concat", B,
                                 data_dir=data_dir))
    want = {k: BN_LAYERS * SPLIT_PER_LAYER[k] * steps for k in SPLIT_KERNELS}
    # the unsplit normalise on the eval batches alone
    want.update(bn_stats=0, bn_relu_bwd_reduce=0, bn_relu_bwd_apply=0,
                bn_relu_fwd=BN_LAYERS * val,
                wbce_disk_fwd=SHARES * steps, wbce_disk_bwd=SHARES * steps)
    emit({"phase": "mesh_train", "cli": "--num_devices 2", "mesh": [
        str(d) for d in (meshes.get("two_cards") or meshes["card_twice"]).devices],
        "train_steps": steps, "eval_batches": val, "launches": launches,
        "train_loss": h["train_loss"], "val_loss": h["val_loss"], "val_res": h["val_res"],
        "train_s": train_s, "checkpoint": os.path.exists(os.path.join(save_dir,
                                                                      "TrackNet_cur.pt"))})
    if launches != want:
        fail("mesh_train", f"launches {launches} != {want} ({steps} steps, {val} eval batches)")
    if not (math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])):
        fail("mesh_train", f"non-finite losses {h}")

    # bf16 ms per step of the README configuration: single, over each mesh,
    # and in two processes; peak memory per card. The card is the parent's
    # alone from here until each pair is released to its timings.
    for pair in pairs:
        _await_float32(pair)
    batch = _first_batch(data_dir, torch.device(DEVICE))
    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(41)).to(
        DEVICE, memory_format=torch.channels_last)
    torch.cuda.reset_peak_memory_stats()
    single = _time_steps(model, batch, 0.5)[0]
    timing = {"single": {"median_ms_per_step": statistics.median(single),
                         "ms_per_step": single,
                         "peak_mem_bytes": {"cuda:0": torch.cuda.max_memory_allocated()}}}
    for name, mesh in meshes.items():
        timing[name] = _time_mesh_steps(model, batch, mesh)
    split_ms = sum(times[k]["ms"] * SPLIT_PER_LAYER[k] for k in SPLIT_KERNELS)
    emit({"phase": "mesh_step_time", "config": "TrackNet seq_len 8 concat 288x512 batch 10 "
          "alpha 0.5 Adam bf16", "shares": SHARES, "timing": timing,
          "split_kernels_ms_per_step": split_ms, "card": card})
    shard_ranks = {pair[0]: [r["shard_steps"] for r in _mesh_procs_train(pair, card, refs)]
                   for pair in pairs}
    return times, {k: launches[k] for k in SPLIT_KERNELS}, shard_ranks


# ---------------------------------------------------------------- sharded resident frames

SHARD_MODES = ("shard", "replicate")
# the CLI epoch's resident budget, as a share of the train split's bytes:
# above 1/2 (each of 2 entries holds half) and below 1, so that "auto" shards
# the train split (and, as the val split holds half as many frames,
# replicates the val split)
SHARD_BUDGET_SHARE = 0.75
WRONG_EXCHANGES = ("reorder_skipped", "local_index_off_by_one_shard")


def _resident_loaders(data_dir: str, dev, mesh=None, group=None) -> dict:
    """The README configuration's resident loaders (shuffled, seed 3, full
    batches) under ``"shard"`` and ``"replicate"``, on ``mesh`` or as this
    rank of ``group``."""
    from tracknetv3_tpu_torch.data.dataset import ResidentHeatmapLoader, build_split_index

    index = build_split_index(data_dir, "train", L, 1)
    kw = dict(shuffle=True, seed=3, drop_last=True, data_dir=data_dir, device=dev, mesh=mesh)
    if group is not None:
        kw.update(process_id=group.rank, process_count=group.size)
    return {m: ResidentHeatmapLoader(index, "concat", B, frame_sharding=m, **kw)
            for m in SHARD_MODES}


def _first_resident(loaders: dict, dev) -> dict:
    """Each loader's first batch, its numpy leaves as tensors on ``dev``."""
    return {m: _device_batch(next(iter(ld)), dev) for m, ld in loaders.items()}


def _step_digest(first: dict) -> dict:
    """A step result's loss and the SHA-256 of its gradients, running
    statistics and parameters (``_mesh_step_result``)."""
    import hashlib

    h = hashlib.sha256()
    for part in (first["grads"], first["stats"]):
        for k in sorted(part):
            h.update(part[k].numpy().tobytes())
    h.update(first["params"].numpy().tobytes())
    return {"loss": first["loss"], "sha256": h.hexdigest()}


def _resident_steps(data_dir: str, base, dev, group) -> dict:
    """This rank's float32 step (TF32 off, deterministic cuDNN; sample mixup
    with every partner on the other share) over ``group`` on its first
    resident batch under each of SHARD_MODES: digests."""
    import torch

    from tracknetv3_tpu_torch.parallel.mesh import Mesh

    batches = _first_resident(_resident_loaders(data_dir, dev, group=group), dev)
    perm, lam = _crossing_mixup()
    with _f32_deterministic():
        out = {m: _step_digest(_one_step(base, b, perm, lam, Mesh((dev,)), group)[0])
               for m, b in batches.items()}
    torch.cuda.synchronize(dev)
    return out


def _wrong_exchange(name: str):
    """``parallel.mesh.plan_exchange`` made wrong: the receiver's reorder
    skipped (its rows taken in the order received), or each holder's local
    rows off by one shard (holder j gathers, at the local rows meant for
    holder j + 1, its own: frame g - R for frame g)."""
    from tracknetv3_tpu_torch.parallel import mesh as pmesh

    real = pmesh.plan_exchange

    def plan(idx, rows, holders, receivers):
        ex = real(idx, rows, holders, receivers)
        if name == "reorder_skipped":
            return ex._replace(order=tuple(
                np.minimum(np.arange(len(o)), sum(ex.received(i)) - 1).astype(np.int32)
                for i, o in enumerate(ex.order)))
        return ex._replace(send=tuple(ex.send[(j + 1) % holders] for j in range(holders)))

    return mock.patch.object(pmesh, "plan_exchange", plan)


def _want_exchange_copies(fs, receivers: int) -> int:
    """``window_copy`` launches of one train step's frame exchange over
    ``receivers`` shares of a one-process mesh: one a holder and receiver
    that has rows to send (N x N where every entry holds a row of every
    share's windows), and one reorder a receiver."""
    ex = fs.exchange(receivers)
    return sum(1 for j in range(fs.holders) for i in range(receivers)
               if len(ex.send[j][i])) + receivers


def _exchange_bytes(fs, mesh) -> dict:
    """The bytes one train step's exchange moves over ``mesh``: gathered by
    the holders, copied between two devices, written by the reorders."""
    ex = fs.exchange(mesh.size)
    row = H * W * 3
    devs = mesh.devices
    pairs = [(j, i, len(ex.send[j][i])) for j in range(fs.holders) for i in range(mesh.size)]
    return {"gathered": row * sum(n for _, _, n in pairs),
            "between_devices": row * sum(n for j, i, n in pairs if devs[j] != devs[i]),
            "reordered": row * sum(len(o) for o in ex.order)}


def _shard_placement(loaders: dict, mesh) -> dict:
    """Each entry's rows against the same rows of the replicated buffer, and
    the bytes each entry holds."""
    import torch

    shards, whole = loaders["shard"].rgb_buf, loaders["replicate"].rgb_buf
    n, R = loaders["shard"]._n_frames, loaders["shard"]._shard_rows
    ok = True
    for j, (sh, full) in enumerate(zip(shards, whole)):
        want = full[j * R:(j + 1) * R]
        pad = (j + 1) * R - n  # the last entry's padding: the last row repeated
        if pad > 0:
            want = torch.cat([want, full[-1:].expand((pad,) + tuple(full.shape[1:]))])
        ok &= sh.shape == want.shape and torch.equal(sh, want)
    return {"rows_equal": bool(ok), "rows_per_entry": R, "frames": n,
            "bytes_per_entry": [t.numel() for t in shards],
            "replicated_bytes_per_entry": [t.numel() for t in whole]}


def _shard_inputs(batches: dict, mesh) -> dict:
    """The assembled inputs of each mode's batch: per share (the train
    step's exchange) and whole on the first entry (the eval step's)."""
    from tracknetv3_tpu_torch.parallel.mesh import shard_train_batch
    from tracknetv3_tpu_torch.training import steps as st

    sh = st._Shares(mesh, None)
    return {m: {"shares": [st.assemble_tracknet_inputs(b, "concat")
                           for b in sh.frames(shard_train_batch(batch, mesh))],
                "eval": st.assemble_tracknet_inputs(batch, "concat")}
            for m, batch in batches.items()}


def _inputs_equal(got: dict, want: dict) -> bool:
    import torch

    return (all(torch.equal(a, b) for a, b in zip(got["shares"], want["shares"]))
            and torch.equal(got["eval"], want["eval"]))


def _time_resident_steps(model, batch, mesh, n: int = 12) -> dict:
    """bf16 ms of each train step over ``mesh`` on one resident batch after 2
    warm-up, peak memory per card, and (a sharded batch) the ms of its
    exchange alone by CUDA events on every card."""
    import torch

    from tracknetv3_tpu_torch.parallel.mesh import shard_train_batch
    from tracknetv3_tpu_torch.training import steps as st
    from tracknetv3_tpu_torch.training.optim import build_optimizer

    perm, lam = _crossing_mixup()
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = st.make_tracknet_shares_train_step(model, opt, "concat", 0.5, sched, mesh=mesh)
    shares = shard_train_batch(batch, mesh)
    cards = sorted({d.index for d in mesh.devices})
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    times = []
    for i in range(n):
        for c in cards:
            torch.cuda.synchronize(c)
        t0 = time.perf_counter()
        step(shares, i, perm, lam)
        for c in cards:
            torch.cuda.synchronize(c)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"median_ms_per_step": statistics.median(times[2:]), "ms_per_step": times[2:],
           "peak_mem_bytes": {f"cuda:{c}": torch.cuda.max_memory_allocated(c) for c in cards}}
    if "res_shards" in batch:
        sh, spent = st._Shares(mesh, None), []
        for i in range(n):
            ev = {c: [torch.cuda.Event(enable_timing=True) for _ in range(2)] for c in cards}
            for c in cards:
                torch.cuda.synchronize(c)
                ev[c][0].record(torch.cuda.current_stream(c))
            sh.frames(shares)
            for c in cards:
                ev[c][1].record(torch.cuda.current_stream(c))
            for c in cards:
                torch.cuda.synchronize(c)
            spent.append(max(a.elapsed_time(b) for a, b in ev.values()))
        out["exchange_ms"] = statistics.median(spent[2:])
        out["exchange_bytes"] = _exchange_bytes(batch["res_shards"], mesh)
    return out


class _Tee:
    """A text stream that writes to two."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _shard_cli_epoch(tmp: str, data_dir: str, meshes: dict) -> dict:
    """One epoch of ``train --num_devices 2 --resident_frames`` with the
    loader's budget at SHARD_BUDGET_SHARE of the train split (the card
    stood in twice where it is alone): its placement line, losses and
    ``window_copy`` launches against the exchange plans of its batches."""
    import functools
    import io

    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.config import TrainConfig
    from tracknetv3_tpu_torch.data import dataset as ds
    from tracknetv3_tpu_torch.ops import shift_copy
    from tracknetv3_tpu_torch.parallel.mesh import make_mesh
    from tracknetv3_tpu_torch.training import loop

    mesh = meshes.get("two_cards") or meshes["card_twice"]
    index = ds.build_split_index(data_dir, "train", L, 1)
    train_bytes = ds.ResidentHeatmapLoader(index, "concat", B, data_dir=data_dir,
                                           device="cpu").rgb_buf.numel()
    budget = SHARD_BUDGET_SHARE * train_bytes
    seed = TrainConfig().seed
    # the CLI's train batches, drawn again on the host: their exchanges' launches
    plans = [b["res_shards"] for b in ds.ResidentHeatmapLoader(
        index, "concat", B, shuffle=True, drop_last=True, seed=seed, data_dir=data_dir,
        budget_bytes=budget, mesh=make_mesh(SHARES, device="cpu"), device="cpu")]
    val = len(ds.ResidentHeatmapLoader(ds.build_split_index(data_dir, "val", L, L), "concat", B,
                                       data_dir=data_dir, device="cpu"))
    # per train step the exchange and a median gather a share; per eval batch
    # the frames' and the median's gathers on the first entry (val replicated)
    want = sum(_want_exchange_copies(fs, SHARES) + SHARES for fs in plans) + 2 * val
    save_dir = os.path.join(tmp, "exp_shard")
    argv = ["--seq_len", str(L), "--bg_mode", "concat", "--alpha", "0.5", "--batch_size",
            str(B), "--epochs", "1", "--num_devices", str(SHARES), "--resident_frames",
            "--data_dir", data_dir, "--save_dir", save_dir]
    stand_in = (mock.patch.object(loop, "make_mesh", lambda n, device: meshes["card_twice"])
                if "two_cards" not in meshes else contextlib.nullcontext())
    placed = functools.partial(ds.ResidentHeatmapLoader, budget_bytes=budget)
    printed = io.StringIO()
    torch.backends.cudnn.benchmark = True
    _zero_launches()
    t0 = time.time()
    with stand_in, mock.patch.object(loop, "ResidentHeatmapLoader", placed), \
            contextlib.redirect_stdout(_Tee(sys.stderr, printed)):
        out = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = _launches(shift_copy)["window_copy"]
    h = out["history"][0]
    lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("Resident frames")]
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"cli": "--num_devices 2 --resident_frames", "mesh": [str(d) for d in mesh.devices],
            "budget_bytes": budget, "train_bytes": train_bytes, "placement_line": lines,
            "train_steps": out["step"], "eval_batches": val, "window_copy": launches,
            "want_window_copy": want, "train_loss": h["train_loss"], "val_loss": h["val_loss"],
            "train_s": train_s}


def phase_mesh_shard(tmp: str, card: str, ranks=None) -> dict:
    """mesh_shard: resident frames sharded over the entries of a mesh (the
    card stood in twice, and two cards where there are two) and over the
    training processes (``ranks``: their float32 steps by backend, from
    ``mesh_train``'s pairs; started here where that phase did not run).
    Returns the ``window_copy`` launches of the CLI epoch."""
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import shift_copy
    from tracknetv3_tpu_torch.parallel import mesh as pmesh

    t_phase = time.time()
    torch.cuda.empty_cache()
    data_dir = os.path.join(tmp, "data")
    if not os.path.isdir(os.path.join(data_dir, "train")):
        write_synthetic_dataset(data_dir)
    pairs = []
    if ranks is None:  # the processes' shard steps beside this phase's work
        _first_batch(data_dir, torch.device("cpu"))
        pairs = [_spawn_train_children(tmp, data_dir, "gloo", ("shard",))]
        if torch.cuda.device_count() >= 2:
            pairs.append(_spawn_train_children(tmp, data_dir, "nccl", ("shard",)))
        for pair in pairs:
            _release(pair, "f32")
    try:
        meshes = {"card_twice": pmesh.make_mesh(devices=["cuda:0", "cuda:0"])}
        if torch.cuda.device_count() >= 2:
            meshes["two_cards"] = pmesh.make_mesh(2)
        base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(41),
                         dtype=torch.float32)
        dev = torch.device(DEVICE, 0)
        res, failures, all_loaders = {}, [], {}
        for name, mesh in meshes.items():
            loaders = all_loaders[name] = _resident_loaders(data_dir, dev, mesh)
            r = {"placement": _shard_placement(loaders, mesh)}
            batches = _first_resident(loaders, dev)
            fs = batches["shard"]["res_shards"]
            # launches of the train step's assembly over the shares and of the
            # eval step's of the whole batch: under "shard" the exchange and a
            # median gather a share, then the whole batch's exchange to one
            # receiver and its median; under "replicate" a frame and a median
            # gather a share, then the same on the first entry
            want_copies = {"shard": _want_exchange_copies(fs, mesh.size) + mesh.size
                           + _want_exchange_copies(fs, 1) + 1,
                           "replicate": 2 * mesh.size + 2}
            inputs, r["window_copy_per_step"] = {}, {}
            for m in SHARD_MODES:
                _zero_launches()
                inputs[m] = _shard_inputs({m: batches[m]}, mesh)[m]
                r["window_copy_per_step"][m] = _launches(shift_copy)["window_copy"]
            r["want_window_copy_per_step"] = want_copies
            r["inputs_equal"] = _inputs_equal(inputs["shard"], inputs["replicate"])
            wrong_inputs = {}
            for w in WRONG_EXCHANGES:
                with _wrong_exchange(w):
                    wrong_inputs[w] = _inputs_equal(
                        _shard_inputs({"shard": batches["shard"]}, mesh)["shard"],
                        inputs["replicate"])
            del inputs
            perm, lam = _crossing_mixup()
            with _f32_deterministic():
                steps = {m: _step_digest(_one_step(base, b, perm, lam, mesh)[0])
                         for m, b in batches.items()}
                for w in WRONG_EXCHANGES:
                    with _wrong_exchange(w):
                        steps[w] = _step_digest(_one_step(base, batches["shard"], perm, lam,
                                                          mesh)[0])
            r["steps"] = steps
            r["step_equal"] = steps["shard"] == steps["replicate"]
            r["wrong"] = {w: {"inputs_equal": wrong_inputs[w],
                              "step_equal": steps[w] == steps["replicate"]}
                          for w in WRONG_EXCHANGES}
            res[name] = r
            if not r["placement"]["rows_equal"]:
                failures.append(f"{name}: an entry's rows differ from the replicated buffer's")
            if not (r["inputs_equal"] and r["step_equal"]):
                failures.append(f"{name}: shard and replicate differ: inputs "
                                f"{r['inputs_equal']}, step {steps}")
            for w, v in r["wrong"].items():
                if v["inputs_equal"] or v["step_equal"]:
                    failures.append(f"{name}: the wrong exchange {w} passes: {v}")
            if r["window_copy_per_step"] != want_copies:
                failures.append(f"{name}: window_copy {r['window_copy_per_step']} != "
                                f"{want_copies}")
            del loaders, batches
        emit({"phase": "mesh_shard_parity", "dtype": "float32", "tf32": False,
              "config": "TrackNet seq_len 8 concat 288x512 batch 10 alpha 0.5", "vs": res,
              "card": card})
        if failures:
            fail("mesh_shard_parity", "; ".join(failures))

        cli = _shard_cli_epoch(tmp, data_dir, meshes)
        emit({"phase": "mesh_shard", **cli})
        want_line = [f"Resident frames: split staged to device memory (shard over {SHARES} "
                     "devices)"]
        if cli["placement_line"] != want_line:
            fail("mesh_shard", f"placement {cli['placement_line']} != {want_line}")
        if cli["window_copy"] != cli["want_window_copy"]:
            fail("mesh_shard", f"window_copy {cli['window_copy']} != {cli['want_window_copy']}")
        if not (math.isfinite(cli["train_loss"]) and math.isfinite(cli["val_loss"])):
            fail("mesh_shard", f"non-finite losses {cli}")

        # bf16 ms a step, the exchange's ms and bytes, peak memory per card
        for pair in pairs:
            _await_float32(pair)
        model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(41)
                          ).to(DEVICE, memory_format=torch.channels_last)
        timing = {}
        for name, mesh in meshes.items():  # in turns: replicate, shard, shard, replicate
            batches = _first_resident(all_loaders.pop(name), dev)
            turns = [(m, _time_resident_steps(model, batches[m], mesh))
                     for m in ("replicate", "shard", "shard", "replicate")]
            timing[name] = {m: [t for k, t in turns if k == m] for m in SHARD_MODES}
            del batches
        emit({"phase": "mesh_shard_time", "config": "TrackNet seq_len 8 concat 288x512 batch "
              "10 alpha 0.5 Adam bf16", "shares": SHARES, "timing": timing, "card": card})

        if ranks is None:
            ranks = {pair[0]: [r["shard_steps"] for r in _child_results(pair, "mesh_shard_procs")]
                     for pair in pairs}
    finally:
        for p in (p for pair in pairs for p in pair[1]):
            if p.poll() is None:
                p.kill()
                p.wait()
    mesh_step = res["card_twice"]["steps"]["shard"]
    emit({"phase": "mesh_shard_procs", "processes": 2, "ranks": ranks,
          "one_process_mesh": mesh_step, "card": card})
    for backend, rs in ranks.items():
        for rank, r in enumerate(rs):
            if not r["shard"] == r["replicate"] == mesh_step:
                fail("mesh_shard_procs", f"{backend} rank {rank}: {r} against the one-process "
                     f"mesh's {mesh_step}")
    emit({"phase": "mesh_shard_done", "phase_s": time.time() - t_phase, "card": card})
    return cli["window_copy"]


def _baseline_modules(root: str):
    """The copy, loss and BatchNorm kernel modules of the port in another checkout,
    imported under another package name so that both trees live in one
    process; each builds its kernels from its own sources into its own
    ``build/``."""
    import importlib
    import importlib.util

    name = "baseline_tracknetv3_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "tracknetv3_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.shift_copy"),
            importlib.import_module(f"{name}.ops.wbce_disk"),
            importlib.import_module(f"{name}.ops.batchnorm"))


def _path_name(path: str) -> str:
    """The kernels line's name of a serving path: ``serve_paths <path>``, or
    ``yuv_stage <format>`` as it is."""
    return path if path.startswith("yuv_stage") else f"serve_paths {path}"


def main() -> int:
    global VERBOSE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conv_only", action="store_true",
                    help="build, conv_vs_plain and conv_ablate alone; no kernels line")
    ap.add_argument("--copy_only", action="store_true",
                    help="build and copy_vs_plain alone; no kernels line")
    ap.add_argument("--loss_only", action="store_true",
                    help="build, kernel_vs_plain and kernel_times alone; no kernels line")
    ap.add_argument("--inpaint_only", action="store_true",
                    help="inpaint_train alone (no hand kernel is on its path, so no build); "
                         "no kernels line")
    ap.add_argument("--serve_paths_only", action="store_true",
                    help="build and serve_paths (device resize, streaming, batch serving "
                         "from videos drawn in memory) alone; no kernels line")
    ap.add_argument("--yuv_only", action="store_true",
                    help="build and yuv_stage (YUV420 staging from a stand-in native reader) "
                         "alone; no kernels line")
    ap.add_argument("--rally_only", action="store_true",
                    help="build and rally (generate_mask_data, InpaintNet training, the test "
                         "CLI, rally_vs_cpu) alone, from a seeded TrackNet; no kernels line")
    ap.add_argument("--tools_only", action="store_true",
                    help="build and tools (the rally median of dataset preparation, "
                         "training's scalar logs and progress samples) alone; no kernels line")
    ap.add_argument("--mesh_only", action="store_true",
                    help="build and mesh (serving and rally evaluation over a mesh that "
                         "stands the card in twice, rally evaluation in two processes) alone; "
                         "no kernels line")
    ap.add_argument("--convert_only", action="store_true",
                    help="build and convert (reference checkpoints converted by the CLI and "
                         "served, held to the reference forward) alone; no kernels line")
    ap.add_argument("--mesh_train_only", action="store_true",
                    help="build and mesh_train (data-parallel training: the split BatchNorm "
                         "kernels, the 2-share step against the single one, the train CLI "
                         "with --num_devices 2, two processes over gloo) alone; no kernels line")
    ap.add_argument("--mesh_shard_only", action="store_true",
                    help="build and mesh_shard (resident frames sharded over a mesh's entries "
                         "and over two training processes) alone; no kernels line")
    ap.add_argument("--split_bn_only", action="store_true",
                    help="build and split_vs_plain (the split BatchNorm kernels of "
                         "data-parallel training against their plain versions, timed) alone; "
                         "no kernels line")
    ap.add_argument("--decode_only", action="store_true",
                    help="build and decode_peak (the peak-blob decode kernel against its "
                         "plain version at serving's calls, timed) alone; no kernels line")
    ap.add_argument("--v1_only", action="store_true",
                    help="build and v1 (TrackNetV1's conv epilogue mode against its plain "
                         "version, and a clip served by the predict CLI) alone; no kernels line")
    ap.add_argument("--baseline", metavar="DIR",
                    help="with --copy_only, --loss_only or --split_bn_only: a checkout of "
                         "another commit (e.g. the parent's, unpacked with git archive); its "
                         "copy, loss or split BatchNorm kernels are built from its sources, "
                         "checked against this tree's and timed in turns with them (old, new, "
                         "new, old)")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-shape detail lines too")
    args = ap.parse_args()
    VERBOSE = args.verbose
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tracknetv3_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "tracknetv3_tpu_torch package must sit beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    only = ("conv" if args.conv_only else "copy" if args.copy_only
            else "loss" if args.loss_only else "inpaint" if args.inpaint_only
            else "rally" if args.rally_only
            else "serve_paths" if args.serve_paths_only
            else "yuv" if args.yuv_only
            else "tools" if args.tools_only
            else "mesh" if args.mesh_only
            else "convert" if args.convert_only
            else "mesh_train" if args.mesh_train_only
            else "mesh_shard" if args.mesh_shard_only
            else "split_bn" if args.split_bn_only
            else "decode" if args.decode_only
            else "v1" if args.v1_only else None)
    if args.baseline and only not in ("copy", "loss", "split_bn"):
        print("chip_smoke: --baseline goes with --copy_only, --loss_only or --split_bn_only",
              file=sys.stderr)
        return 2
    baseline = _baseline_modules(args.baseline) if args.baseline else None
    card = phase_env()
    if only != "inpaint":
        phase_build(baseline)
    if only:
        if only == "inpaint":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_inpaint(tmp, card)
        elif only == "rally":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_rally(tmp, card)
        elif only == "serve_paths":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_serve_paths(tmp, card)
        elif only == "yuv":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_yuv_stage(tmp, card)
        elif only == "tools":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_tools(tmp, card)
        elif only == "mesh":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_mesh(tmp, card)
        elif only == "convert":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_convert(tmp, card)
        elif only == "mesh_train":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_mesh_train(tmp, card)
        elif only == "mesh_shard":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_mesh_shard(tmp, card)
        elif only == "conv":
            phase_conv()
            phase_conv_ablate()
        elif only == "copy":
            phase_copy(baseline)
        elif only == "split_bn":
            _split_vs_plain(baseline[2] if baseline is not None else None)
        elif only == "decode":
            phase_decode_peak()
        elif only == "v1":
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                phase_v1(tmp, card, timed=True)
        else:
            phase_kernels(baseline)
        print(card, flush=True)
        emit({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    err, ms, plain_ms, bound = phase_kernels()
    bn_times = phase_bn()
    copies = phase_copy()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, bn_launches, step_ms, peak, model = phase_slice(tmp)
        phase_step_parity(os.path.join(tmp, "data"))
        copy_launches = phase_seg_train(tmp, model)
        del model
        phase_seg_parity(os.path.join(tmp, "data"))
        phase_inpaint(tmp, card)
        phase_tools(tmp, card)
        rally_launches = phase_rally(tmp, card, os.path.join(tmp, "exp", "TrackNet_best.pt"))
        torch.cuda.empty_cache()
        pool_up = phase_pool_up()
        decode = phase_decode_peak()
        conv = phase_conv()
        phase_conv_ablate()
        phase_v1(tmp, card)
        serve_launches, frames = phase_serve(tmp)
        phase_serve_parity(tmp, frames)
        del frames
        paths_launches = phase_serve_paths(tmp, card)
        paths_launches.update(phase_yuv_stage(tmp, card))
        mesh_launches = phase_mesh(tmp, card)
        mesh_launches.update(phase_convert(tmp, card))
        split_times, split_launches, shard_ranks = phase_mesh_train(tmp, card)
        shard_launches = phase_mesh_shard(tmp, card, shard_ranks)

    src = "tracknetv3_tpu_torch/csrc/wbce_disk.cu"
    replaces = {"fwd": "tracknetv3_tpu/ops/pallas_wbce.py:73",
                "bwd": "tracknetv3_tpu/ops/pallas_wbce.py:87"}
    # K1/K2 bounds: the larger of the bytes and the SASS instructions at the
    # issue rate (kernel_times)
    lines = [
        {"name": f"wbce_disk_{k}", "route": "cuda", "source": src,
         "replaces": replaces[k], "launches": launches[f"wbce_disk_{k}"], "max_abs_err": err[k],
         "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bound[k][0],
         "bound_by": bound[k][1], "library_ms": None}
        for k in ("fwd", "bwd")
    ]
    # P6/P7: times and bounds summed over the three calls of one forward at
    # batch 16; the plain version is one PyTorch call, so it is the library's
    replaces = {"maxpool2x2": "tools/probe_bn_pool.py:203",
                "up2x_nearest": "tools/probe_bn_pool.py:236"}
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/pool_up2x.cu",
         "replaces": replaces[k], "launches": serve_launches["cudnn", 16][k],
         "launches_by_path": {"serve cudnn batch 16": serve_launches["cudnn", 16][k],
                              "rally": rally_launches[k],
                              **{_path_name(p): n[k] for p, n in paths_launches.items()},
                              **{p: n[k] for p, n in mesh_launches.items()}},
         "max_abs_err": v["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
         "bound_ms": v["bound_ms"], "bound_by": "/".join(sorted(set(v["bound_by"]))),
         "library_ms": v["plain_ms"]}
        for k, v in pool_up.items()
    ]
    # BatchNorm: times and bounds summed over the 17 calls of one train step
    # at batch 10 (bf16); launches per run of the train path. The backward
    # kernels replace JAX's autodiff of the epilogue (no Pallas source).
    replaces = {"bn_stats": "tools/probe_bn_pool.py:128",
                "bn_relu_fwd": "tools/probe_bn_pool.py:167",
                "bn_relu_bwd_reduce": "tracknetv3_tpu/models/fused_forward.py:285",
                "bn_relu_bwd_apply": "tracknetv3_tpu/models/fused_forward.py:311"}
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/batchnorm.cu",
         "replaces": replaces[k], "launches": bn_launches[k], **v}
        for k, v in bn_times.items()
    ]
    # the split BatchNorm entry points of data-parallel training: times and
    # bounds summed over one share's 17 calls at a share of 5 (bf16);
    # launches of the train CLI's epoch over 2 shares
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/batchnorm.cu",
         "replaces": SPLIT_REPLACES[k], "also_replaces": SPLIT_ALSO_REPLACES.get(k, []),
         "launches": split_launches[k], **v}
        for k, v in split_times.items()
    ]
    # P1-P3: times and bounds summed over the 17 convs of one forward at batch
    # 16 (bf16); library: cuDNN's conv alone, and with the torch epilogue
    # passes that today's default route adds. Launches: the hand_k3c serve of
    # the whole video, the hand_9tap serve of its 64-frame cut.
    replaces = {"k3c": "tools/probe_pallas_conv.py:48", "9tap": "tools/probe_pallas_conv.py:130"}
    also = {"k3c": ["tools/probe_pallas_conv.py:130 (sheet=True)",
                    "tools/probe_pallas_ablate.py:63 (full and the partial variants)"],
            "9tap": ["tools/probe_pallas_ablate.py:63 (full-9mm)"]}
    served = {"k3c": ("hand_k3c", 16), "9tap": ("hand_9tap", 16)}
    lines += [
        {"name": f"conv3x3_{k}", "route": "cuda",
         "source": "tracknetv3_tpu_torch/csrc/conv3x3.cu", "replaces": replaces[k],
         "also_replaces": also[k],
         "launches": serve_launches[served[k]][f"conv3x3_{k}"],
         "launches_by_path": {f"serve {served[k][0]} batch 16":
                              serve_launches[served[k]][f"conv3x3_{k}"],
                              "rally": rally_launches.get(f"conv3x3_{k}", 0),
                              **{_path_name(p): n.get(f"conv3x3_{k}", 0)
                                 for p, n in paths_launches.items()},
                              **{p: n.get(f"conv3x3_{k}", 0)
                                 for p, n in mesh_launches.items()}}, **v}
        for k, v in conv.items()
    ]
    # P8/P9: each kernel at the train path's shape of copy_vs_plain (the roll,
    # which no path of the system runs, at its probe's); launches summed over
    # seg_train's four runs of the train CLI and, for window_copy, the rally
    # phase's runs of the two evaluation CLIs; by path also the sharded
    # rally evaluation's and the sharded resident frames' CLI epoch
    replaces = {"window_copy": "tools/probe_mosaic_caps.py:88",
                "repeat_rows": "tools/probe_mosaic_caps.py:164",
                "roll_cols": "tools/probe_mosaic_caps.py:201"}
    also = {"window_copy": ["tools/probe_mosaic_caps.py:107 (U2)",
                            "tools/probe_mosaic_caps.py:126 (U3: staged)",
                            "tools/probe_mosaic_caps.py:147 (U4)",
                            "tools/probe_mosaic_caps.py:230 (U7)"],
            "repeat_rows": [], "roll_cols": []}
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/shift_copy.cu",
         "replaces": replaces[k], "also_replaces": also[k],
         "launches": copy_launches[k] + rally_launches.get(k, 0),
         "launches_by_path": {"seg_train": copy_launches[k], "rally": rally_launches.get(k, 0),
                              **{p: n.get(k, 0) for p, n in mesh_launches.items()
                                 if p.startswith("mesh_rally")},
                              "mesh_shard": shard_launches if k == "window_copy" else 0},
         "on_a_ported_path": k != "roll_cols", **copies[k]}
        for k in COPY_KERNELS
    ]
    # the peak-blob decode: times and bounds of v3's chunk call (16 maps);
    # launches of the hand_9tap serve (a chunk's frames and the flush)
    lines.append(
        {"name": "decode_peak", "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/detect.cu",
         "replaces": "none (tracknetv3_tpu/ops/detect.py:147 decode_heatmaps is XLA ops)",
         "launches": serve_launches["hand_9tap", 16]["decode_peak"],
         "by_case": decode, **decode["v3_chunk"], "library_ms": None})
    emit({"kernels": lines})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
