"""On-card smoke test of the PyTorch/CUDA port (``cosmos_curate_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``cosmos_curate_tpu_torch/csrc``
and prints one JSON line per phase:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA,
   which optional modules import (``cv2``, ``msgpack``, ``cloudpickle``,
   ``prometheus_client``, ``pyarrow``, ``regex``, ``boto3``,
   ``google.cloud.storage``, ``yaml``, ``zstandard``, ``lance``, ``transformers``,
   ``safetensors``), and which FFmpeg libraries and
   headers are installed;
2. build: seconds to compile every kernel (one ``nvcc`` per source, in
   parallel), and the HGMMA / UTMALDG / FFMA counts of the tensor-core
   kernels' SASS (flash, prefill, paged: each must hold wgmma and TMA loads);
3. kernels: each kernel against its plain PyTorch version at the shapes the
   caption engine gives it at ``VLM_BASE`` width (bf16 inputs, the plain
   version in fp32 on the same inputs, the two tensor-core prefill kernels'
   on their stated q * scale rounded to bf16, ``scaled_query``; bound 1e-2
   max abs error; paged
   decode and contiguous decode at both lanes' widths, 1024 and 256 keys,
   contiguous decode also within it of its split mirror in fp32 and
   bit-equal to paged decode on its rows scattered into a pool; paged
   prefill also bit-equal to the contiguous prefill kernel on
   the gathered rows), timed with
   CUDA events (median of 30 launches after warm-up, L2 flushed between
   launches, the host kept ahead of the device), beside the card's least
   time for the same work and one
   ``scaled_dot_product_attention`` call on the equivalent gathered /
   contiguous tensors (a yardstick only; it excludes the gather, and the port
   never calls it), with ``bound_share`` (bound / kernel time) and
   ``vs_library`` (kernel time / SDPA time). A ``card_state`` line before
   and after the phase reads the SM clock, its maximum, the power draw and
   the temperature, so a slow card and a slow kernel can be told apart;
   qwen_kernels: kernels 1-4 the same way at the Qwen caption drives'
   shapes (``check_qwen_kernels``: Qwen2-VL-2B's Hkv 2, G 6, D 128 and
   Qwen2.5-VL-7B's Hkv 4, G 7; the 1024-key lane, a 256-token chunk and
   the 512-token bucket after the 45-token chat prefix, the prefix build);
4. embed: ``ClipEmbeddingStage(variant="video")`` at ``VIDEO_EMBED_BASE``
   with seeded random weights embeds the main path's shapes (8 stage calls
   of 8 tasks x 4 clips x 8 random uint8 224x224 frames, 32 clips per call
   in micro-batches of ``EMBED_MICRO_BATCH`` clips) after a warm-up call:
   clips/s, the pipeline's per-dispatch copy-in / compute / copy-out times,
   peak memory and flash launches; every clip must hold a finite unit-norm
   embedding, within ``EMBED_BOUND`` of the same stage with the flash kernel
   swapped for its plain version, while the plain version with one key
   tile dropped (the first, or the ragged last) must land beyond that bound.
   Then clips/s of ``VideoEmbedder.encode_clips`` on the same calls at
   micro-batches of 32, 16 and 8 clips, over ``SWEEP_ROUNDS`` rounds in
   rotating order. ``mfu``: ``models/flops.py``'s forward FLOPs of every
   timed clip over the dispatches' device time and the card's dense bf16
   peak (``chip_peak_flops``);
5. slice: ``CaptionEngine(VLM_BASE)`` with seeded random weights answers the
   caption benchmark's base workload (8 requests, 4 random 224x224 frames,
   the default prompt or the 686-token long prompt as shared prefix, 64 new
   tokens) through the paged kernels;
6. gather: the same workload through ``CaptionEngine(VLM_BASE,
   paged_attention="gather")``, whose decode steps run the contiguous decode
   kernel and whose prefills run the contiguous prefill kernel; the paged
   kernels must not launch there; then 16 of its engine steps under the
   profiler, as in 7 (``gather_breakdown``);
   witness: for each request the two engines answer differently, the first
   differing step and both engines' top-2 logits there, and which engine
   four more drives side with: a paged drive with both paged kernels held
   against their fp32 plain versions on every call (within 1e-2 of the
   call's largest output), and gather drives with the prefill kernel held
   the same way, with its plain version in its place and with it at the
   kernel's stated precision (the rerun of the kernel and the plain
   version in fp32 left the call with the av phase, PERF.md §5). That paged drive counts its paged calls by shape and
   snapshots each prefill shape's first call (inputs, pool layer, output);
   paged prefill is then checked and timed at the (B, T) it sent most, on
   that snapshot (``paged_prefill_at_drive_shape``);
7. breakdown: with both lanes of the paged engine decoding, 16 engine steps
   without a profiler (wall time per step), then 16 under torch.profiler
   tracing the device only (device time by kernel, the decode kernel's own
   time and launches, launches per step, and the device's idle share of
   that traced window);
8. forward: the engine's model on a small input with every kernel against
   the same forward with each kernel replaced by its plain version;
9. pipeline: the annotate half of the main path through the port's own
   ``run_pipeline``: ``ClipEmbeddingStage(variant="video")`` ->
   ``CaptionPrepStage`` -> ``CaptionStage(model_flavor="base")`` at
   ``VIDEO_EMBED_BASE`` and ``VLM_BASE`` (seeded random weights) over the
   embed phase's shapes (tasks of 4 clips x 8 random uint8 224x224 frames,
   each clip one caption window). The default runner (the
   ``PipelinedRunner``) over ``PIPELINE_TASKS`` tasks, more than one embed
   stage call can take, so the embed stage embeds while the caption stage
   decodes, from two host threads on one card; then ``SequentialRunner``
   over 2 of the tasks (``PIPELINE_NEW_TOKENS`` new tokens a window); then the caption pipeline efficiency as
   ``benchmarks/caption_benchmark.py`` defines it: the windows of
   ``EFFICIENCY_TASKS`` tasks straight into the shared engine, then the
   same windows through ``CaptionStage``, each pass's decode tokens over its
   wall, and the ratio. Reported: clips embedded and windows captioned, wall time, clips/s, in-pipeline
   caption tok/s, the runner's overlap fraction and the seconds during
   which the embed and caption stages ran at once (both asserted above 0),
   each kernel's launches, the CUDA stream each stage's worker thread
   launched on, peak memory, and how far the two runners agree (the same
   clips and windows, embeddings within ``EMBED_BOUND``, identical
   captions reported).

10. split: the whole main path through the port's own ``run_split``, from
   raw mp4 files to the output layout: bench.py's corpus (32 of its 64 videos of 4 s
   at 1280x720, mp4v, made by this script's copy of bench.py's generator
   on the host's other cores while the kernels build and the kernel phases
   run; its build is timed and kept out of the wall). Run A is bench.py's
   headline row (1 s fixed-stride clips, 8 fps frames at 224x224,
   ``embedding_model="video"`` at ``VIDEO_EMBED_BASE``) through the default
   runner: wall, clips/s, ``summary.json``'s video hours per day per chip,
   each stage's busy seconds and batches (``process_data`` wrapped), the
   codec the clips were written with and the native H.264 writer's status,
   flash launches, the device's peak memory and the host's peak RSS; it
   asserts 128 clips cut, transcoded, embedded and written (128 metas, 128
   parquet rows of finite unit-norm embeddings). Run B captions the first 2
   videos (``captioning=True``, ``caption_model="base"``): every window of
   every meta captioned, and paged decode, paged prefill, prefill and
   flash launched. Then the first 2 videos through ``SequentialRunner`` and
   the default runner (the same clip uuids and output files, embeddings
   within ``EMBED_BOUND``), and a second ``run_split`` on run A's output,
   which must discover no video. Every run leaves its live status: run A's
   ``report/live/status.json`` must be final with every stage finished.
   observe (``scripts/observe_phase.py``, on the split phase's corpus and
   outputs): run B again with ``tracing=True`` (the same clips and
   embeddings within ``EMBED_BOUND``, every window captioned, the four
   kernels of ``PIPELINE_KERNELS`` launched; the NDJSON trace and a
   connected run report whose dispatch section equals the embed
   pipeline's own records and whose stage spans agree with the
   ``process_data`` timings), the tracing overhead against the untraced
   run B before it and an untraced run B after it, and the trace's size
   and cost a span; ``SequentialRunner`` over the 2 videos
   traced the same way, its spans exported over OTLP/HTTP to a local fake
   collector; a toy pipeline whose hung batch must show as a
   ``stuck_batch`` anomaly in the live status while it hangs.
   engine (``scripts/engine_phase.py``, right after observe, on the split
   phase's corpus): run B's settings on its first video through the
   default runner plain and then with stage save, cProfile and tracemalloc
   on (the same uuids and files, embeddings within ``EMBED_BOUND``, every
   window captioned, a profile and saved batches for every stage, no saved
   CUDA tensor); the embed stage replayed over its saved batches (held by
   ``compare_tasks`` against the next stage's saved inputs at
   ``EMBED_BOUND``, flash launched) and the caption stage (every window
   captioned, kernels 1-3 launched); one embed call under
   ``ProfilingConfig(device=True)`` (its Chrome trace's flash kernels equal
   to the counted launches); the same videos through ``StreamingRunner`` in
   ``STREAMING`` (traced) and ``BATCH`` mode and through ``MapRunner`` (the
   baseline's uuids and files, the kernels of ``PIPELINE_KERNELS``
   launched, the object store's native framing for every driver put, no
   CPU worker holding the card); ``report``, ``top`` and ``dlq`` as
   subprocesses of the port's command line.

11. canonical: run C, the reference's canonical split through ``run_split``
   on the first ``CANONICAL_VIDEOS`` (8) videos of the split phase's
   corpus, clipped as run A clips it (1 s clips, none
   under 0.5 s): TransNetV2 shot detection (``transnetv2_threshold`` above
   1: the seeded detector has no signal, so no frame is a cut and each
   video is one scene, which ``max_clip_len_s`` cuts into four 1 s clips;
   the detector's probabilities in the run and its cut count at the
   default 0.4 are reported beside it, and its bf16 probabilities on one
   video's windows are held within ``TRANSNET_BOUND`` of the fp32 module),
   the aesthetic filter (CLIP ViT-L/14 + the aesthetic MLP, threshold
   ``AESTHETIC_THRESHOLD``), ``embedding_model="clip"`` (CLIP ViT-B/16
   frame means), 8 fps frames at 224x224. It asserts both the kept and the
   filtered set non-empty, every clip's meta carrying its score, each clip
   kept exactly when its score is ``>= AESTHETIC_THRESHOLD``, the summary's
   filtered count, and a unit-norm 512-d CLIP embedding in the parquet for
   every kept clip; one 32-frame L/14 batch's embeddings within
   ``EMBED_BOUND`` of the tower on plain flash, and the plain version with
   the first key tile dropped beyond it (the one-key last tile's loss is
   reported: the kernels phase's check at [32,16,257,64] catches it). It
   reports the wall, each stage's calls, clips and busy share, clips kept
   and filtered, flash launches and every flash shape (any not in
   ``FLASH_CASES`` checked and timed on the spot);
    filters: the split's filters and caption add-ons. The OCR detector and
   recognizer on the committed trained weights, on the card (fp32, TF32
   off) against the port's CPU path on the golden fixtures (the port's
   ``models/ocr_train.py`` generators): logits within ``OCR_BOUND`` of
   their scale, the same coverage, thresholded heatmap and strings, the
   golden assertions of ``tests/models/test_ocr.py``, and the learned score's
   time per clip. Then ``run_split`` on the first ``FILTER_VIDEOS`` corpus
   videos with the text filter (learned), the semantic filter, ``video``
   embeddings, ``base`` captions and enhanced captions, through the default
   runner: every clip scored by the text filter and every clip it kept asked
   of the semantic filter, the kept and filtered counts in the summary,
   every kept window captioned and enhanced, the kernels of the caption
   path launched; reported: wall, clips/s, each stage's workers and busy
   share, the planner's first and last plans, the OCR share of the wall,
   the engine's per-owner tokens. Then run A's settings on the same videos
   with ``transcode_cpus=1`` on ``FILTER_FANOUT_CPUS`` CPUs of budget,
   fanned out and with one worker a stage: transcode fans out, the device
   stage does not, and both write the same files. The split phase's record
   holds the planner's plans for run A (all ones on 8 cores).
    curate (``scripts/curate_phase.py``, on the split phase's corpus and run
   A's output): flash_causal (flash's causal branch at the CLIP text
   towers' shapes, [256, 12, 77, 64] and [256, 8, 64, 64], against its plain
   version, timed); t5 (``T5EncoderTPU(T5_SMALL)`` on 256 caption-length
   texts padded to 512 tokens: captions/s, idle and attention shares, peak
   memory, bf16 within ``T5_BOUND`` of fp32 on the card); clip_text
   (``CLIPTextEmbeddings("clip-text-l-tpu")`` on 256 queries: queries/s,
   unit norms, within ``CLIP_TEXT_BOUND`` of plain flash, 12 flash launches
   a call); split_extras (run D: run B's videos with T5 caption embeddings
   and previews); dedup_shard (``run_dedup`` and ``run_shard`` on run A's
   output, k-means on 2^20 x 768 rows at K = 1024, semantic dedup on 2^16
   rows with planted near-copies).
    index (``scripts/index_phase.py``, after curate; it sets
   ``CURATE_INDEX_ALLOW_RANDOM=1`` itself, after checking that the gates
   refuse the seeded models without it): a corpus index of 2^16 x 512
   planted rows at K = 512 (built: k-means on the card, shard writes on the
   host), ``incremental_dedup`` of 1024 queries at nprobe 8 (exactly the
   512 planted near-copies removed, each ``duplicate_of`` its source), the
   query wall split (routing, shard loads, device top-k, merge) and idle
   share, recall@8 >= 0.95 against an exact top-8 on the card; an
   ``IndexServer`` answering 256 concurrent clip, uuid and text requests
   (the text tower ``clip-text-b-tpu`` runs flash's causal branch; every
   shape checked against the plain version), each answer equal to
   ``CorpusIndex.query`` on its rows; ``compact_index`` folding 4096 rows
   while queries run, the server adopting the new generation, recall@8
   still >= 0.95. index_split (run E): 8 corpus videos through
   ``run_split`` with ``clip`` embeddings and ``corpus_index=True`` (all 32
   clips consolidated), the same videos renamed through ``run_split`` with
   ``incremental_dedup="enable"`` (all 32 removed as duplicates), and
   ``run_dedup`` on the first output (``method == "index_query"``).
    legs (``scripts/legs_phase.py``, after index): motion (48 calibration
   clips at 1280x720 through ``MotionFilterStage(backend="frame-diff")``,
   every score within 1e-5 relative of the CPU path's, static clips
   filtered, full-frame moving clips kept); tracking (the NCC tracker and
   the siamese tracker from a staged seeded checkpoint on a scaled
   moving-box clip, boxes equal to the CPU path's and on the object, and on
   32 corpus clips; ms and launches a frame, idle share); sr (one 8-frame
   1280x720 window through the diffusion model, its final conv drawn
   non-zero, and SRNet, bf16 against fp32 on the card; frames/s, chunk
   group, peak memory); legs_split (run F: 2 corpus videos through
   ``run_split`` with the motion filter, annotated tracking, per-event
   captions and captions at ``VLM_BASE``, every tracked clip with its event
   captions and annotated clip, no clip errors, kernels 1, 2, 3 and 5
   launched; then 12 frames of one video with ``sr=True``, every clip at
   2560x1440).
    image and cli (``scripts/image_phase.py``, after legs): a corpus of 256
   seeded stills (1920x1080 and 4032x3024 JPEGs, 1280x720 PNGs, 1024x768
   WebPs, 640x480 BMPs) and two broken files through the port's own command
   line, ``local image-annotate``: run I1 (CLIP ViT-B/16 and the aesthetic
   filter over all of them: images/s, stage busy shares, peak, a sample held
   against the CPU path, the embed stage's idle share), run I2 (the first
   8 with the semantic filter, the classifier and captions at
   ``VLM_BASE``: three owners of one engine; kernels 1, 2 and 5 launched),
   run I3 (captions from a local fake OpenAI-compatible server that answers
   one 503 first; byte-exact bodies), run I4 (I1 resumed: only the broken
   files rediscovered) and the ``video`` embedder on stills; then ``info``
   and ``local hello`` as subprocesses, ``local split --config`` on 2
   corpus videos, ``local dedup``, ``local shard``, ``index build``,
   ``query`` and ``stats`` against the entry points called directly, and
   the refusals of ``--runner streaming`` with ``CURATE_ENGINE_DRIVER_PORT``
   set and no ``CURATE_ENGINE_TOKEN`` (the cross-node plane runs only with
   its cluster secret) and of ``local split --sr --sr-sp-size 2`` (item 7).
    remote (``scripts/remote_phase.py``, after image and cli): the
   repository's fake S3, GCS and Azure servers on 127.0.0.1 in this
   process (every SigV4 and Shared Key signature verified), the first 2
   corpus videos uploaded to ``s3://`` and a seeded ``VIDEO_EMBED_BASE``
   checkpoint (~397 MB, multipart) with its sha256 under an ``s3://``
   ``CURATE_WEIGHTS_URI``; run A's settings from ``s3://`` to ``az://``
   through the default runner with an empty staging directory (the
   checkpoint pulled once by ranged reads and verified, flash launched,
   every embedding within ``EMBED_BOUND`` of a local run on the same
   checkpoint, the same files by video and span), a resumed run that
   discovers nothing, a traced run through two HTTP 503s (the retries read
   from its ``storage.read`` spans), ``run_dedup`` and ``run_shard`` to
   ``gs://`` equal to the same calls on a local copy, and ``local split``
   as a subprocess from ``s3://`` to ``gs://``; walls beside the local
   run's, requests and bytes a backend, the pull's MB/s.
    multinode (``scripts/multinode_phase.py``, after remote): run A's
   settings on the first 2 corpus videos in this process (the one-node
   reference), then in two node processes under ``CURATE_NUM_NODES=2``
   (partition, merged by ``local merge-summaries``; then work stealing),
   each printing its own launch counts (flash launched in both); the
   cross-node plane (this process the driver, ``CURATE_RUNNER=engine``,
   one loopback agent through the ``agent`` command: the CPU stages on the
   agent, the embed stage and flash on the card, one connected trace); and
   node loss (two agents, chaos ``agent.kill`` on one right after its
   first result: the run completes, objects reconstructed, nothing
   dead-lettered). Every run's clips are the one-node run's (embeddings
   within ``EMBED_BOUND``); walls beside the one-node run's, workers by
   node, spawn-to-ready seconds, object-channel bytes and prefetch overlap.
    av (``scripts/av_phase.py``, after multinode): 6 corpus videos as two
   sessions of three cameras, one camera a scene shorter: ``run_split``
   at run A's settings with ``multicam=True`` (every camera's clips under
   the primary's uuid, metas and embeddings of the primary only, flash
   launched, a resumed run empty, shot detection refused); the AV pipeline's
   steps through ``local av`` in process (ingest, split, caption on
   ``CaptionEngine(VLM_BASE, max_batch=8)``: one batch of 8 requests with
   paged decode, paged prefill and flash launched, its idle share; the rest
   of the clips, then a resume that builds no engine and launches nothing;
   the trajectory's phase correlation on the card; annotate; package on
   ``T5EncoderTPU(T5_BASE)``, its device ms; shard with the T5 and
   clip-session tars); ingest and split again on the fake PostgreSQL
   server (``tests/pipelines/fake_pg.py``), whose rows are the sqlite
   run's, with ``postgres update-schemas`` and ``show-tables``.
    service (``scripts/service_phase.py``, after av): run B's settings as a
   ``split`` job through the port's job service over HTTP (``build_app`` in
   a thread; the job child counts its own launches: flash, paged decode and
   paged prefill; clips and embeddings run B's); a ``serve`` subprocess
   SIGKILLed while its job runs and started again on the same work root
   (the orphaned child's group reaped before the resumed attempt, the
   journal's transitions, the outputs the multinode phase's one-node run's);
   ``POST /v1/search`` by embedding, clip uuid and text over an index of the
   job's embeddings (answers the ``IndexServer``'s, causal flash launched in
   this process, p50 / p99, a burst shed with 429 + ``Retry-After``).
    sensors (``scripts/sensors_phase.py``, after service; host code, no
   kernel launches, which it asserts): the corpus's first three videos as
   the three cameras of a rig (4 s at 1280x720, 96 frames a camera)
   captured by ``make_mcap_from_video`` (zstd where ``zstandard`` imports);
   each camera read through ``McapCameraSensor`` and through
   ``CameraSensor`` over its mp4 at 10 and 24 Hz, the same batches and
   frames bit for bit, frames/s and MB/s of each; a ``SensorGroup`` of the
   MCAP cameras with the rear camera cut to 2 s, its lockstep windows
   holding the short camera only inside its span, and ``align`` over the
   frame refs; the lance backend on a host without ``pylance``: a lance
   store and index resolved to parquet with the reference's warning, the
   index answering, ``export-lance`` exiting 2 with the guidance;
    train (``scripts/train_phase.py``, after sensors; no kernel on its path,
   which it asserts): the five trainers' six runs (tracker, TransNet, the
   OCR detector and recognizer, SR, diffusion SR) at their default
   configurations and batches, ``train_phase.STEPS`` eager steps each through
   ``train_and_stage``: host synthesis and device ms a step, samples/s,
   launches a step and the idle share over the last steps (traced), peak
   memory, the mean loss of the first and last 10 steps (finite and
   falling); each checkpoint loaded by the port's inference class with
   ``require_weights=True`` and read back bit-equal.
    convert (``scripts/convert_phase.py``, after train): seeded state dicts
   under the public HF tensor names and shapes, converted by the port's
   HF converters, staged with ``registry.save_params`` and served through
   the models' entry points with their weights required: CLIP ViT-L/14 and
   the aesthetic head through ``ClipEmbeddingStage(variant="clip",
   clip_variant="clip-vit-l14-tpu")`` and ``AestheticFilterStage`` (flash
   launched; the embeddings within ``EMBED_BOUND`` of the same tree on
   flash's plain version), CLIP text L and T5 (t5-small's shapes) one encode
   each, Qwen2-VL-2B at full width and depth captioning through
   ``CaptionStage(model_flavor="qwen2vl-2b")`` (paged prefill and decode
   launched; the staged checkpoint read back bit-equal), Qwen3-VL-30B-A3B
   (2 LM layers, 2 tower blocks) and InternVideo2-1B (2 blocks) loaded and
   run once; then ``lint --concurrency --schema`` over the port's package
   in process (no finding). The seconds of each model's build,
   conversion, staging and serve, and its launches.
12. iv2: ``ClipEmbeddingStage(variant="iv2")`` at ``IV2_1B`` (1408 wide, 40
   blocks, 16 heads of 88, 8 frames at 224^2, 2049 tokens) on a seeded
   ``state_dict`` whose LayerScale is drawn uniform 0.05-0.2 (at its 1e-5
   init every block is close to the identity), over ``IV2_CALLS`` calls of
   8 tasks x 4 clips x 8 random 224^2 frames after a warm-up call: clips/s,
   per-dispatch copy-in / compute / copy-out, peak device memory, the
   attention's share of one call's device time (CUDA events); one 4-clip
   batch's bf16 embeddings within ``IV2_BOUND`` of the same module in fp32
   on the card; and the stage without ``params`` and without a staged
   checkpoint must raise.

13. qwen: ``CaptionEngine(VLM_QWEN2_2B)`` at full width and depth
   (28 layers, 1536 wide, GQA 12 / 2 of 128, vocab 151936, the 32-block
   1280-wide tower) with seeded weights on the flavor's KV lanes serves 8
   chat requests (``build_qwen_vl_chat`` around the default caption
   prompt over byte-level ids: ``HFVocabTokenizer`` over a generated
   byte vocabulary; 8 random 224^2 frames: 4 temporal patches, 1024
   tower tokens, 256 vision tokens; ``QWEN_NEW_TOKENS`` greedy tokens), paged
   and then gather: tok/s end to end and decoding, ms a decode step, the profiled
   decode window (device idle share, launches a step), device peak, each
   kernel's launches, the measured requests' paged prefill calls by
   (B, T) (each (B, T) the qwen kernels phase did not check is checked
   against the plain version and timed there), and the two engines' agreement
   (reported, not asserted). The paged engine's model runs one request's
   prefill with its kernels against the same module in fp32 with the
   plain attention (max abs logit difference within
   ``QWEN_FORWARD_BOUND``), and its tower runs one 8-frame call in bf16
   against fp32 (within ``QWEN_TOWER_BOUND`` of the output's largest
   magnitude) with its plain attention's share of the call (CUDA events);
   qwen_7b: ``VLM_QWEN25_7B`` at full width and depth serves 2 requests
   at 2 fps (the time-scaled m-rope), and its windowed tower is checked
   the same way; qwen_stage: ``CaptionStage(model_flavor="qwen2vl-2b")``
   refuses to set up without staged tokenizer files and without weights,
   and ``CaptionStage(model_flavor="qwen-chat-tiny-test")`` captions 8
   windows through ``run_pipeline``.

14. qwen3_kernels: kernels 1-4 as in 3 at Qwen3-VL-30B-A3B's heads (Hkv 4,
   G 8, D 128: the top of the split decode's G <= 8 body) on both lanes
   (1024 and 4096 keys, one idle row each), a 256-token chunk and the
   512-token bucket after the 45-token chat prefix, the prefix build, the
   gather engine's bucket and decode, the bit-equal pairs asserted;
   qwen3: ``CaptionEngine(VLM_QWEN3_VL_MOE_A3B)`` at full width and depth
   (48 layers of 128 experts, top 8, capacity factor 2; the 27-block
   1152-wide deepstack tower, taps at blocks 8 / 16 / 24), seeded weights
   with the experts stored in bf16, on the flavor's lanes: 3 chat requests
   of 8 frames at 2 fps and one text-only request in one 512-token prefill
   bucket (prep at admission), ``QWEN3_NEW_TOKENS`` greedy tokens, paged and then gather
   (``drive_qwen3``): tok/s, ms a decode step, the profiled window's idle
   share and launches a step, the MoE's share of the device's busy time
   (profiler ranges), peak memory and parameter bytes, dropped over routed
   assignments in prefill and in decode, layer 0 in bf16 with the kernels
   against fp32 with the plain attention (within ``QWEN3_LAYER_BOUND`` of
   its update's largest magnitude), the tower's merger and deepstack levels
   in bf16 against fp32 with its attention share at D = 72, each kernel's
   launches asserted, and the two drives' token agreement.

Every path's run zeroes the launch counters just before it and reads them
just after; each kernel must have launched on the path that uses it
(``KERNEL_PATH``).

Then the script's seconds, the ``{"kernels": [...]}`` line, the card line,
and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero and prints no result. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
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
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers, the streaming engine's and the map
# runner's CPU workers) imports this script again as ``__mp_main__`` and runs
# none of its device code: it skips torch, as a worker of the command line
# (whose main module imports no torch) does
if __name__ != "__mp_main__":
    import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
BOUND = 1e-2  # kernel vs plain version, max abs error (bf16 output)
# embed stage with the flash kernel vs with its plain version, max abs error
# of unit-norm 768-d embeddings: above the 1.2e-3 sound runs read, below
# what a kernel that drops one key tile gives (PERF.md)
EMBED_BOUND = 3e-3
# rounds of the embed phase's micro-batch sweep, each setting in another
# order: 3 since the sensors phase joined the call (6 before; the full
# call's time, PERF.md §5)
SWEEP_ROUNDS = 3
FORWARD_BOUND = 5e-2  # 12-layer logits, kernels vs plain versions, bf16
SEED = 0

# TPU kernels these replace: the pl.pallas_call of each
REPLACES = {
    "paged_decode": "cosmos_curate_tpu/ops/paged_attention.py:210",
    "paged_prefill": "cosmos_curate_tpu/ops/paged_attention.py:264",
    "prefill": "cosmos_curate_tpu/ops/prefill_attention.py:146",
    "decode": "cosmos_curate_tpu/ops/decode_attention.py:112",
    "flash": "cosmos_curate_tpu/ops/flash_attention.py:125",
}
SOURCES = {
    "paged_decode": "cosmos_curate_tpu_torch/csrc/paged_attention.cu",
    "paged_prefill": "cosmos_curate_tpu_torch/csrc/paged_attention.cu",
    "prefill": "cosmos_curate_tpu_torch/csrc/prefill_attention.cu",
    "decode": "cosmos_curate_tpu_torch/csrc/decode_attention.cu",
    "flash": "cosmos_curate_tpu_torch/csrc/flash_attention.cu",
}
# the path whose run counts each kernel's launches
KERNEL_PATH = {
    "paged_decode": "slice",
    "paged_prefill": "slice",
    "prefill": "slice",
    "decode": "gather",
    "flash": "embed",
}
# kernels the pipeline phase must launch (cct_decode serves only the gather
# engine, which no stage uses)
PIPELINE_KERNELS = ("paged_decode", "paged_prefill", "prefill", "flash")
# six embed stage calls (192 clips): the caption stage's first batch takes
# at most 32 tasks and waits 0.2 s for them, while an embed call of 8 tasks
# takes under 0.1 s, so with fewer tasks embedding ends before captioning
# starts and the two device stages never run at once
PIPELINE_TASKS = 48
PIPELINE_SEQUENTIAL_TASKS = 2
# 16 new tokens a window (split.py's stage default is 128): the phase's
# decode is host-bound at ~130-170 tok/s, and at 128 its 192 windows took
# 140 s of the full call's 1200 s on a slow host; 64 until the service
# phase joined the call, 32 until the sensors phase did
PIPELINE_NEW_TOKENS = 16
# 8 windows: through the engine alone, then CaptionStage (16 until the
# service phase joined the call)
EFFICIENCY_TASKS = 2
# split phase: bench.py's corpus (bench.py:41-47, :84-103) and headline
# settings (bench.py:217-227), built by this script's own copy of its
# generator: 32 videos (64 before the multinode phase joined the call: the
# full call's time, PERF.md §5) of 2 scenes x 48 frames at 24 fps, 1280x720, mp4v,
# seeded per video with 1000 + i; 1 s fixed-stride clips, 8 fps frames at
# 224^2, embedding_model="video". Run B captions the first 2 videos at
# VLM_BASE (4 before the remote phase joined the call: the full call's
# time, PERF.md §5); the runner agreement takes the first 2
SPLIT_VIDEOS = 32
SPLIT_SCENE_FRAMES = 48
SPLIT_NUM_SCENES = 2
SPLIT_FRAME_W, SPLIT_FRAME_H = 1280, 720
SPLIT_CLIPS = SPLIT_VIDEOS * SPLIT_NUM_SCENES * SPLIT_SCENE_FRAMES // 24
SPLIT_CAPTION_VIDEOS = 2
SPLIT_AGREEMENT_VIDEOS = 2
SPLIT_RSS_SAMPLE_S = 0.05
# canonical phase (run C): the split corpus's first videos, clipped as run A
# clips them (1 s clips, none under 0.5 s): a shot threshold above every
# probability, since the seeded detector has no signal (at 0.4 a quarter
# of the frames cut and almost every scene falls under min_clip_len_s), so
# each 4 s video is one scene, cut by max_clip_len_s into four 1 s clips
# (four clips a task, so the clip embed stage's fused frame-mean batch
# holds several); the seeded L/14 scorer's 256 scores on this corpus run
# -0.084 to 0.092 with their median at -0.0035 on the H100 (PERF.md), so
# a threshold of 0 keeps about half the clips and drops the rest
CANONICAL_CLIP_LEN_S = 1.0
CANONICAL_SHOT_THRESHOLD = 1.5
# run C's videos: the corpus's first quarter since the remote phase joined
# the call, its first eighth since the train phase did (16 before, 32
# before the remote phase, 64 before the engine phase; the full call's
# time, PERF.md §5)
CANONICAL_VIDEOS = 8
AESTHETIC_THRESHOLD = 0.0
CANONICAL_L14_CLIPS = 4  # kept clips whose frames make the L/14 check's batch
# bf16 detector probabilities vs the fp32 module on the card (a CPU reading
# of the seeded default config: 2.2e-3)
TRANSNET_BOUND = 1e-2
# iv2 phase: stage calls of EMBED_STAGE_TASK_BATCH tasks x 4 clips; bf16
# embeddings vs the fp32 module, max abs error of unit-norm 512-d vectors:
# about 6x the 8.6e-4 two full runs read on the H100 (PERF.md). 2 calls
# since the sensors phase joined the call (4 before; the full call's time)
IV2_CALLS = 2
IV2_BOUND = 5e-3
IV2_CHECK_CLIPS = 4
# filters phase: the split's text filter (the learned detector on the
# committed OCR weights), semantic filter, video embeddings, base captions
# and enhanced captions (seeded caption weights) on the first
# FILTER_VIDEOS corpus videos through the default runner; then run A's
# settings on the same videos with transcode_cpus=1 and 16 CPUs of budget,
# fanned out and with one worker a stage. OCR on the card vs its CPU path:
# max abs logit difference over the largest CPU logit (stated before the
# first run; the port's CPU path matches the JAX package within 1e-4 on
# these weights). 4 videos since the train phase joined the call (8 since
# the engine phase did, 16 before; the full call's time, PERF.md §5)
FILTER_VIDEOS = 4
FILTER_FANOUT_CPUS = 16
OCR_BOUND = 1e-4
OCR_TIMED_CLIPS = 32
# modules and FFmpeg libraries the port's later slices may need (split
# assembly decodes and encodes through cv2 and a native H.264 writer over
# libavcodec, and writes parquet with pyarrow; the Qwen flavors' tokenizer
# splits with regex; previews are WebP through PIL; a staged T5
# tokenizer.json loads through tokenizers); the device phase reports which
# are here (transformers and safetensors: whether HF's own model classes
# and checkpoint files could be read beside the converters, which need
# neither)
OPTIONAL_MODULES = ("cv2", "msgpack", "cloudpickle", "prometheus_client", "pyarrow", "regex", "PIL", "tokenizers",
                    "boto3", "google.cloud.storage", "yaml", "aiohttp", "zstandard", "lance", "transformers",
                    "safetensors")
FFMPEG_LIBRARIES = ("avcodec", "avformat", "avutil", "swscale", "x264")
# embed phase: stage calls timed, clips per task (4 one-second clips of
# bench.py's videos), so each call is one 32-clip dispatch
EMBED_CALLS = 8
EMBED_CLIPS_PER_TASK = 4
# qwen phase: the dense Qwen-VL caption flavors at full width and depth,
# seeded weights. Chat requests: a 45-token chat prefix, 8 frames of 224^2
# (4 temporal patches: 1024 tower tokens, 256 vision tokens) and a
# 120-token suffix around the default caption prompt (byte-level ids),
# QWEN_NEW_TOKENS greedy tokens; 8 through the 2B (paged, then gather), 2
# through the 7B at 2 fps. Bounds (stated before the first run): the 28-layer prefill logits
# in bf16 with the kernels vs the module in fp32 with the plain attention,
# max abs difference (the seeded logits' std is about 0.8); each tower's
# bf16 output vs fp32, max abs difference over the fp32 output's largest
# magnitude
QWEN_FLAVORS = ("qwen2vl-2b", "qwen25vl-7b")
QWEN_LONG_LANE = ("qwen2vl-2b", "qwen3vl-moe-a3b")  # flavors whose 4096-key lane decode is checked too
QWEN_REQUESTS = 8
QWEN_7B_REQUESTS = 2
# greedy tokens a measured Qwen2 / Qwen2.5 request: 32 since the sensors
# phase joined the call (64 before; the full call's time, PERF.md §5)
QWEN_NEW_TOKENS = 32
QWEN_FRAMES = 8
QWEN_FPS = 2.0
QWEN_PREFIX = 45
QWEN_SUFFIX = 376  # 256 vision tokens + the 120-token text suffix
QWEN_STAGE_TASKS = 4
QWEN_FORWARD_BOUND = 0.25
QWEN_TOWER_BOUND = 5e-2
# qwen3 phase: Qwen3-VL-30B-A3B at full width and depth (48 layers of 128
# experts, top 8; the 27-block 1152-wide deepstack tower), seeded weights,
# the experts stored in bf16. QWEN3_REQUESTS chat requests of 8 frames at
# 2 fps (4 temporal patches of 14 x 14 at patch 16: 784 tower tokens, 196
# vision tokens) around the default caption prompt, and one text-only
# request whose prompt carries a transcript, so that its suffix falls in
# the same 512-token bucket: the four rows share one prefill, deepstack
# and not; QWEN3_NEW_TOKENS greedy tokens; prep at admission (no prep thread), so both
# drives hand the MoE the same rows. Bound (stated before the first run):
# layer 0 in bf16 with the kernels against the same layer in fp32 with the
# plain attention, on one request's prefill input, max abs difference of
# the layer's update (output - input) over the fp32 update's largest
# magnitude (a CPU reading at reduced width: 6e-3 to 1e-2)
QWEN3_FLAVOR = "qwen3vl-moe-a3b"
QWEN3_REQUESTS = 3
QWEN3_SUFFIX = 316  # 196 vision tokens + the 120-token text suffix
QWEN3_TRANSCRIPT = " transcript: " + "the camera pans across the scene. " * 6
# greedy tokens a measured Qwen3 request: 12 since the sensors phase joined
# the call (24 since the av phase did, 64 before; the full call's time,
# PERF.md §5)
QWEN3_NEW_TOKENS = 12
QWEN3_LAYER_BOUND = 5e-2
# engine steps in the profiled decode window and in the MoE's (each step
# runs both lanes: ~12 000 launches, so few steps keep the traces short)
QWEN3_PROFILE_STEPS = 4
QWEN3_MOE_STEPS = 2
# flash shapes timed: ViT-B/16 at 224^2 over the embed phase's 16-clip x
# 8-frame dispatch (the row of the kernels line) and over 32 clips, CLIP
# ViT-L/14 at 224^2 over the canonical phase's 32-frame aesthetic dispatch
# (S = 257 = 4 x 64 + 1: its last key tile holds one key), the base pooler
# over 16 clips, and a causal ViT-B/16-at-768^2 length; then the split
# phase's embed dispatches, whose calls hold 1 or 2 tasks of 4 clips
# (padded to 4 and 8 clips; 3 or 4 tasks pad to the 16-clip cases)
FLASH_CASES = (
    ("vit_b16_224", (128, 12, 197, 64), False),
    ("clip_l14_224", (32, 16, 257, 64), False),
    ("vit_b16_224_32_clips", (256, 12, 197, 64), False),
    ("pooler", (16, 8, 9, 64), False),
    ("causal_2305", (1, 16, 2305, 64), True),
    ("vit_b16_224_4_clips", (32, 12, 197, 64), False),
    ("vit_b16_224_8_clips", (64, 12, 197, 64), False),
    ("pooler_4_clips", (4, 8, 9, 64), False),
    ("pooler_8_clips", (8, 8, 9, 64), False),
)


EMITTED_AT: list = []  # [phase, time.monotonic()] of every phase line, for the timing line


def emit(obj) -> None:
    if "phase" in obj:
        EMITTED_AT.append([obj["phase"], time.monotonic()])
    print(json.dumps(obj), flush=True)


def sass_counts() -> dict:
    """Instructions of the tensor-core kernels' built libraries, from
    ``cuobjdump -sass``: HGMMA (wgmma), UTMALDG (TMA tile loads) and FFMA
    (fp32 FMAs on the CUDA cores)."""
    from cosmos_curate_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("flash_attention", "prefill_attention", "paged_attention"):
        sass = subprocess.run(
            [tool, "-sass", str(_build._library_path(name))], capture_output=True, text=True, check=True, timeout=120
        ).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "FFMA")}
        assert counts[name]["HGMMA"] > 0 and counts[name]["UTMALDG"] > 0, f"{name}: no wgmma / TMA in its SASS"
    return counts


def flash_key_tile() -> int:
    """Keys per tile of the flash kernel: ``kBK`` of its tensor-core body,
    read from the source, so the dropped-tile controls drop one real tile."""
    from cosmos_curate_tpu_torch.ops import _build

    header = (_build.CSRC / "tc_attention.cuh").read_text()
    return int(re.search(r"constexpr int kBK = (\d+);", header).group(1))


def gpu_state() -> dict:
    """The card's SM clock, its maximum, power draw and temperature now."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(keys)}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return dict(zip(keys, (v.strip() for v in out.stdout.strip().splitlines()[0].split(","))))


def with_shares(result: dict) -> dict:
    """A kernel's timing record with its share of the bound (bound / kernel
    time) and its time over the library call's."""
    return {**result, "bound_share": result["bound_ms"] / result["kernel_ms"],
            "vs_library": result["kernel_ms"] / result["library_ms"]}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch.
    The device spins for ~0.5 ms after the flush, so the host has enqueued
    the call before its start event fires: the time is the device's, not
    the host's wrapper and launch overhead."""

    def __init__(self, device) -> None:
        self._flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 30, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self._flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / H100_BF16_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def visible_keys(write, kv_len, t: int) -> np.ndarray:
    """[B, T] keys each query sees: causal at write + t, below kv_len."""
    pos = write[:, None] + np.arange(t)[None, :]
    return np.minimum(pos + 1, kv_len[:, None])


def attention_work(q_shape, write, kv_len, hk: int, d: int) -> tuple[float, float]:
    """(bytes, flops) the chunk attention needs for these inputs: q and out
    once, each visible K/V row once per (row, kv head), tables and lengths;
    4 * D flops per (query head, visible key)."""
    b, t, _, g, _ = q_shape
    vis = visible_keys(write, kv_len, t)
    kv_rows = vis.max(axis=1).sum()
    n_bytes = 2 * (2 * b * t * hk * g * d) + 2 * (2 * kv_rows * hk * d) + 8 * b
    flops = 4.0 * d * g * hk * vis.sum()
    return n_bytes, flops


def sdpa_inputs(q, k, v, write, kv_len):
    """[B, T, Hkv, G, D] q and [B, S, Hkv, D] K/V -> SDPA layout + mask."""
    b, t, hk, g, d = q.shape
    s = k.shape[1]
    qs = q.reshape(b, t, hk * g, d).transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).contiguous()
    vs = v.transpose(1, 2).contiguous()
    k_pos = torch.arange(s, device=q.device)[None, None, None, :]
    q_pos = (write[:, None] + torch.arange(t, device=q.device)[None, :])[:, None, :, None]
    mask = (k_pos <= q_pos) & (k_pos < kv_len[:, None, None, None])
    return qs, ks, vs, mask


def random_bf16(rng, dev):
    """A maker of bf16 tensors of standard normal values drawn from ``rng``,
    on ``dev``."""

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    return bf16


def check_flash(timer, bf16, shape: tuple, causal: bool, label: str) -> dict:
    """The flash wrapper against its fp32 plain version at one [B, H, S, D]
    shape, and the kernel's, the plain version's and SDPA's times on the
    same inputs beside the bound.

    Asserted within BOUND: the error beyond what rounding the fp32 plain
    output to the kernel's bf16 output costs by itself (per element, |got -
    want| - |bf16(want) - want|; at most twice the kernel's error before its
    output rounding). The raw max abs error is recorded beside it, and
    SDPA's on the same inputs: the first rows of a short causal sequence
    attend to a few keys, their outputs reach |4|, where bf16's half ulp is
    0.0156, and SDPA's error there equals that rounding."""
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = bf16(*shape), bf16(*shape), bf16(*shape)

    def run():
        return flash_attention(q, k, v, causal=causal)

    got = run()
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    err = diff.max().item()
    err_beyond = (diff - (want.to(torch.bfloat16).float() - want).abs()).max().item()
    assert err_beyond <= BOUND, f"flash {label}: error beyond bf16 rounding {err_beyond} > {BOUND} (raw {err})"
    sdpa_err = (sdpa(q, k, v, is_causal=causal).float() - want).abs().max().item()
    fb, fh, fs, fd = shape
    # the plain version without the first or the last (ragged) key tile:
    # what a kernel that lost the tile would give, which BOUND must catch
    dropped = {}
    if not causal and fs > flash_key_tile():
        for name, lo_tile in (("first_tile_dropped", True), ("last_tile_dropped", False)):
            lost = tile_dropping_flash(lo_tile)(q.float(), k.float(), v.float())
            dropped[name] = (lost - want).abs().max().item()
            assert dropped[name] > BOUND, f"flash {label}: the bound {BOUND} misses {name} ({dropped[name]})"
    pairs = fs * (fs + 1) // 2 if causal else fs * fs
    bms, by = bound_ms(4 * 2 * fb * fh * fs * fd, 4.0 * fd * fb * fh * pairs)
    return with_shares(dict(
        shape=dict(B=fb, H=fh, S=fs, D=fd, causal=causal),
        max_abs_err=err,
        max_abs_err_beyond_output_rounding=err_beyond,
        sdpa_max_abs_err=sdpa_err,
        kernel_ms=timer(run),
        plain_ms=timer(lambda: flash_attention_plain(q, k, v, causal=causal)),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: sdpa(q, k, v, is_causal=causal)),
        max_abs_err_with_a_tile_dropped=dropped,
    ))


@contextlib.contextmanager
def counted_launches(out: dict):
    """Every kernel's launch counter zeroed on entry; on exit ``out`` holds
    each kernel's launches over the block, by name."""
    from cosmos_curate_tpu_torch.ops import kernels

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    yield
    out.update({name: k.launches for name, k in ks.items()})


@contextlib.contextmanager
def recorded_flash_shapes(shapes: set):
    """Wrap the models' flash call for the duration: every call adds its
    (q shape, causal) to ``shapes`` and goes on to the wrapper, which counts
    its own launches as before."""
    import cosmos_curate_tpu_torch.models.layers as layers

    saved = layers.flash_attention

    def attn(q, k, v, *, causal=False):
        shapes.add((tuple(q.shape), causal))
        return saved(q, k, v, causal=causal)

    with swapped_flash(attn):
        yield


@contextlib.contextmanager
def swapped_flash(attn):
    """The models' flash call replaced by ``attn`` for the duration."""
    import cosmos_curate_tpu_torch.models.layers as layers

    saved = layers.flash_attention
    layers.flash_attention = attn
    try:
        yield
    finally:
        layers.flash_attention = saved


def tile_dropping_flash(lo_tile: bool):
    """The plain flash version without the first (``lo_tile``) or the last,
    ragged key tile of every sequence longer than one tile: what a kernel
    that skipped the tile would give."""
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention_plain

    tile = flash_key_tile()

    def attn(q, k, v, *, causal=False):
        s = q.shape[2]
        if s <= tile:
            return flash_attention_plain(q, k, v, causal=causal)
        lo, hi = (0, tile) if lo_tile else ((s - 1) // tile * tile, s)
        keep = torch.cat([torch.arange(0, lo), torch.arange(hi, s)]).to(q.device)
        return flash_attention_plain(q, k[:, :, keep], v[:, :, keep], causal=causal)

    return attn


def random_clip_tasks(rng, name: str, key: str, n_frames: int, size: int) -> list:
    """EMBED_STAGE_TASK_BATCH tasks of EMBED_CLIPS_PER_TASK one-second clips,
    each ``n_frames`` random uint8 ``size``^2 frames under ``key``."""
    from cosmos_curate_tpu_torch.data.model import Clip, SplitPipeTask, Video
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import EMBED_STAGE_TASK_BATCH

    tasks = []
    for t in range(EMBED_STAGE_TASK_BATCH):
        video = f"{name}-{t}"
        clips = [Clip(source_video=video, span=(float(i), float(i + 1)),
                      extracted_frames={key: rng.integers(0, 256, (n_frames, size, size, 3), dtype=np.uint8)})
                 for i in range(EMBED_CLIPS_PER_TASK)]
        tasks.append(SplitPipeTask(video=Video(path=f"{video}.mp4", clips=clips)))
    return tasks


def int32s(dev):
    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    return i32


def scaled_query(q, d: int):
    """q * D**-0.5 rounded to bf16: what the tensor-core prefill kernels
    (paged prefill, contiguous prefill) attend with, as the JAX package's
    prefill does, before any product. Their fp32 plain reference starts
    from it (at scale 1), so the check measures the kernel, not that
    rounding (up to 3e-3 on an output of 2-4 at D = 128)."""
    return (q * d**-0.5).float()


def check_paged(timer, rng, dev, name, b, t, write, kv_len, nbl, heads, bs=16, idle_row=False) -> dict:
    """Paged attention (decode at t = 1, prefill above) against its fp32
    plain version over a shuffled pool (layer 1 of 2; prefill on
    ``scaled_query``), asserted within BOUND; a prefill chunk must equal
    ``cct_prefill`` on the gathered rows bit for bit. ``heads``: (Hkv, G,
    D)."""
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import prefill_attention

    hk, g, d = heads
    bf16, i32 = random_bf16(rng, dev), int32s(dev)
    n_blocks = b * nbl + 1
    pk, pv = bf16(2, n_blocks, bs, hk, d), bf16(2, n_blocks, bs, hk, d)
    tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl)
    if idle_row:
        tables[-1] = 0  # garbage block 0, kv_len 1
    q = bf16(b, t, hk, g, d)
    tb, wi, kl = i32(tables), i32(write), i32(kv_len)

    def run():
        return paged_attention(q, pk, pv, tb, wi, kl, layer_index=1)

    def plain():
        return paged_attention_plain(q, pk, pv, tb, wi, kl, layer_index=1, sm_scale=d**-0.5)

    got = run()
    q32, scale = (scaled_query(q, d), 1.0) if t > 1 else (q.float(), d**-0.5)
    want = paged_attention_plain(q32, pk.float(), pv.float(), tb, wi, kl, layer_index=1, sm_scale=scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err = (got.float() - want).abs().max().item()
    assert err <= BOUND, f"{name}: max abs err {err} > {BOUND}"
    gk = pk[1][tb.long()].reshape(b, nbl * bs, hk, d)
    gv = pv[1][tb.long()].reshape(b, nbl * bs, hk, d)
    if t > 1:  # one body, one geometry: bit-equal to cct_prefill on the gathered rows
        assert torch.equal(got, prefill_attention(q, gk.contiguous(), gv.contiguous(), wi, kl)), (
            f"{name}: not bit-equal to the contiguous prefill kernel on gathered rows"
        )
    qs, ks, vs, mask = sdpa_inputs(q, gk, gv, wi, kl)
    bms, by = bound_ms(*attention_work(q.shape, np.asarray(write), np.asarray(kv_len), hk, d))
    return with_shares(dict(
        shape=dict(B=b, T=t, Hkv=hk, G=g, D=d, bs=bs, nbl=nbl),
        max_abs_err=err,
        kernel_ms=timer(run),
        plain_ms=timer(plain),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        bit_equal_to_prefill=t > 1 or None,
    ))


def check_prefill(timer, rng, dev, name, b, t, s, write, kv_len, heads) -> dict:
    """Contiguous prefill against its fp32 plain version on a [B, S, Hkv, D]
    cache and ``scaled_query``, asserted within BOUND. ``heads``: (Hkv, G,
    D)."""
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention

    hk, g, d = heads
    bf16, i32 = random_bf16(rng, dev), int32s(dev)
    q, k, v = bf16(b, t, hk, g, d), bf16(b, s, hk, d), bf16(b, s, hk, d)
    wi, kl = i32(write), i32(kv_len)

    def run():
        return prefill_attention(q, k, v, wi, kl)

    got = run()
    want = chunk_attention_plain(scaled_query(q, d), k.float(), v.float(), wi, kl, 1.0)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err = (got.float() - want).abs().max().item()
    assert err <= BOUND, f"{name}: max abs err {err} > {BOUND}"
    qs, ks, vs, mask = sdpa_inputs(q, k, v, wi, kl)
    bms, by = bound_ms(*attention_work(q.shape, np.asarray(write), np.asarray(kv_len), hk, d))
    return with_shares(dict(
        shape=dict(B=b, T=t, S=s, Hkv=hk, G=g, D=d, write=list(map(int, write)), kv_len=list(map(int, kv_len))),
        max_abs_err=err,
        kernel_ms=timer(run),
        plain_ms=timer(lambda: chunk_attention_plain(q, k, v, wi, kl, d**-0.5)),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
    ))


def check_decode(timer, rng, dev, name, b, s, kv, heads, bs=16) -> dict:
    """Contiguous decode over a [B, S, Hkv, D] cache against its fp32 plain
    version and its split mirror (within BOUND), and bit-equal to paged
    decode on the same rows scattered into a shuffled pool: one split body,
    one split count, one merge order. ``heads``: (Hkv, G, D)."""
    from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from cosmos_curate_tpu_torch.ops.paged_attention import decode_split_count, decode_split_plain, paged_attention

    hk, g, d = heads
    bf16, i32 = random_bf16(rng, dev), int32s(dev)
    nbl = s // bs
    q, k, v = bf16(b, hk, g, d), bf16(b, s, hk, d), bf16(b, s, hk, d)
    kl = i32(kv)

    def run():
        return decode_attention(q, k, v, kl)

    got = run()
    want = decode_attention_plain(q.float(), k.float(), v.float(), kl, sm_scale=d**-0.5)
    n_split = decode_split_count(s, b * hk, torch.cuda.get_device_properties(dev).multi_processor_count)
    mirror = decode_split_plain(q.float(), k.float(), v.float(), kl, sm_scale=d**-0.5, n_split=n_split)
    n_blocks = b * nbl + 1
    tables = i32(rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl))
    pk = torch.zeros(2, n_blocks, bs, hk, d, dtype=torch.bfloat16, device=dev)
    pv = torch.zeros_like(pk)
    pk[1][tables.long()] = k.reshape(b, nbl, bs, hk, d)
    pv[1][tables.long()] = v.reshape(b, nbl, bs, hk, d)
    paged = paged_attention(q[:, None], pk, pv, tables, kl - 1, kl, layer_index=1)[:, 0]
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err = (got.float() - want).abs().max().item()
    mirror_err = (got.float() - mirror).abs().max().item()
    assert max(err, mirror_err) <= BOUND, f"{name}: max abs err {err}, {mirror_err} > {BOUND}"
    assert torch.equal(got, paged), f"{name}: not bit-equal to paged decode on the same rows"
    qs, ks, vs, mask = sdpa_inputs(q[:, None], k, v, kl - 1, kl)
    bms, by = bound_ms(*attention_work((b, 1, hk, g, d), np.asarray(kv) - 1, np.asarray(kv), hk, d))
    return with_shares(dict(
        shape=dict(B=b, S=s, Hkv=hk, G=g, D=d, kv_len=list(map(int, kv)), n_split=n_split),
        max_abs_err=err,
        max_abs_err_vs_split_mirror=mirror_err,
        kernel_ms=timer(run),
        plain_ms=timer(lambda: decode_attention_plain(q, k, v, kl, sm_scale=d**-0.5)),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        bit_equal_to_paged_decode=True,
    ))


def lane_lengths(rng, b: int, width: int, low: int = 64) -> np.ndarray:
    """Random key counts of a lane's rows in [low, width], the last row idle
    at 1."""
    kv = rng.integers(low, width + 1, b)
    kv[-1] = 1
    return kv


def check_kernels(timer, dev) -> dict:
    from cosmos_curate_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED)
    heads = (8, 2, 64)  # VLM_BASE: 16 query heads over 8 KV heads of 64
    results = {}
    # paged decode: each lane of 4 slots (1024 and 256 keys), random lengths,
    # the last row idle; the long lane is the kernels line's row
    decode = {}
    for label, nbl in (("lane_1024", 64), ("lane_256", 16)):
        kv = lane_lengths(rng, 4, nbl * 16 - 1)
        decode[label] = check_paged(timer, rng, dev, f"paged_decode {label}", 4, 1, kv - 1, kv, nbl, heads,
                                    idle_row=True)
    results["paged_decode"] = {**decode["lane_1024"], "cases": decode}
    # paged prefill: a 256-token chunk, one fresh row and one mid-context row
    results["paged_prefill"] = check_paged(
        timer, rng, dev, "paged_prefill", 2, 256, np.array([0, 300]), np.array([256, 556]), 64, heads)
    # contiguous prefill: the long prompt's shared-prefix build, S = T = 1024
    results["prefill"] = check_prefill(timer, rng, dev, "prefill", 1, 1024, 1024, [0], [686], heads)
    # contiguous decode: each lane of the gather engine (4 slots, caches of
    # 1024 and 256 keys), random lengths, the last row at 1; the long lane is
    # the kernels line's row
    decode = {label: check_decode(timer, rng, dev, f"decode {label}", 4, s, lane_lengths(rng, 4, s), heads)
              for label, s in (("lane_1024", 1024), ("lane_256", 256))}
    results["decode"] = {**decode["lane_1024"], "cases": decode}
    bf16 = random_bf16(rng, dev)
    flash = {label: check_flash(timer, bf16, shape, causal, label) for label, shape, causal in FLASH_CASES}
    results["flash"] = {**flash[FLASH_CASES[0][0]], "cases": flash}
    assert set(results) == set(kernels())
    return results


@contextlib.contextmanager
def plain_attention():
    """The caption LM's three attention calls (paged, contiguous prefill,
    contiguous decode) replaced by their plain versions for the duration."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
    from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention_plain
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain

    saved = vlm_model.paged_attention, vlm_model.prefill_attention, vlm_model.decode_attention
    vlm_model.paged_attention = lambda q, pk, pv, tb, wi, kl, *, layer_index=0: paged_attention_plain(
        q, pk, pv, tb, wi, kl, layer_index=layer_index, sm_scale=q.shape[-1] ** -0.5
    )
    vlm_model.prefill_attention = lambda q, k, v, wi, kl: chunk_attention_plain(q, k, v, wi, kl, q.shape[-1] ** -0.5)
    vlm_model.decode_attention = lambda q, k, v, kl: decode_attention_plain(q, k, v, kl, sm_scale=q.shape[-1] ** -0.5)
    try:
        yield
    finally:
        vlm_model.paged_attention, vlm_model.prefill_attention, vlm_model.decode_attention = saved


def check_forward(model, dev) -> dict:
    """The engine's model with its kernels vs the same forward with each
    kernel swapped for its plain version (paged prefill + decode on a
    fragmented pool, a contiguous prefix build and a contiguous decode step
    on top of it)."""
    from cosmos_curate_tpu_torch.models.vlm.model import init_cache

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    b, t, bs, nbl = 2, 64, 16, 8
    n_blocks = b * nbl + 1
    tables = torch.as_tensor(
        rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32), device=dev
    )
    embeds = torch.as_tensor(rng.standard_normal((b, t, cfg.dim)).astype(np.float32), device=dev)
    write = torch.tensor([0, 40], dtype=torch.int32, device=dev)  # row 0 first: pos[0] = 0..t-1
    pos = write[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None]

    def run():
        shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
        pk = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        with torch.inference_mode():
            pre, _, _ = model.paged_forward(embeds, pk, pv, pos, write, write + t, tables)
            nxt = write + t
            dec, _, _ = model.paged_forward(embeds[:, :1], pk, pv, nxt[:, None], nxt, nxt + 1, tables)
            ck, cv = init_cache(cfg, 1, length=t, device=dev)
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            con, _, _ = model(embeds[:1], ck, cv, pos[:1], zero, zero + 50)
            cdec, _, _ = model(embeds[:1, :1], ck, cv, pos[:1, 50:51], zero + 50, zero + 51)
        return pre.float(), dec.float(), con.float(), cdec.float()

    got = run()
    with plain_attention():
        want = run()
    out = {}
    names = ("paged_prefill", "paged_decode", "contiguous_prefill", "contiguous_decode")
    for name, a, w in zip(names, got, want, strict=True):
        assert a.shape[-1] == cfg.vocab and torch.isfinite(a).all(), name
        out[name] = (a - w).abs().max().item()
        assert out[name] <= FORWARD_BOUND, f"forward {name}: {out[name]} > {FORWARD_BOUND}"
    return out


def drive_embed(dev) -> dict:
    """The main path's embed leg at bench.py's shapes: ClipEmbeddingStage
    (variant "video", VIDEO_EMBED_BASE, seeded) over EMBED_CALLS stage calls
    of EMBED_STAGE_TASK_BATCH tasks x EMBED_CLIPS_PER_TASK clips x 8 random
    uint8 224x224 frames (extraction at 8 fps over 1 s clips)."""
    from cosmos_curate_tpu_torch.core.stage import WorkerMetadata
    from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature
    from cosmos_curate_tpu_torch.models import flops
    from cosmos_curate_tpu_torch.models.embedder import EMBED_MICRO_BATCH, VIDEO_EMBED_BASE
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention_plain
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    cfg = VIDEO_EMBED_BASE
    extraction = FrameExtractionSignature("fps", 8.0)
    key = extraction.key()
    size = cfg.vit.image_size
    rng = np.random.default_rng(SEED + 2)

    def make_tasks(call: int) -> list:
        return random_clip_tasks(rng, f"video-{call}", key, cfg.num_frames, size)

    t0 = time.monotonic()
    stage = ClipEmbeddingStage(variant="video", extraction=extraction, device=dev)
    stage.setup(WorkerMetadata(stage_name="embed"))
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    batches = [make_tasks(c) for c in range(EMBED_CALLS + 1)]
    stage.process_data(batches[0])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    pipeline = stage.model.device_pipeline
    pipeline.records.clear()
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    for tasks in batches[1:]:
        stage.process_data(tasks)
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    launches = {name: k.launches for name, k in ks.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    records = list(pipeline.records)

    clips = [c for tasks in batches[1:] for t in tasks for c in t.video.clips]
    for c in clips:
        emb = c.embeddings[stage.model_name]
        assert emb.shape == (cfg.output_dim,) and np.isfinite(emb).all(), "bad embedding"
        assert abs(float(np.linalg.norm(emb)) - 1.0) < 1e-3, "embedding not unit norm"
    n_attn = cfg.vit.layers + cfg.temporal_layers
    assert launches["flash"] == n_attn * len(records), f"flash launches {launches['flash']} != {n_attn} x {len(records)}"
    # the kernels phase timed flash at this path's ViT dispatch shape
    assert {r.padded_rows * cfg.num_frames for r in records} == {FLASH_CASES[0][1][0]}, "flash case off the path"

    # the same stage with the flash kernel swapped for its plain version,
    # and for that version with one key tile dropped: what a kernel that
    # skipped the tile would give, which the bound must tell apart
    first = batches[1]
    with_kernel = [c.embeddings[stage.model_name].copy() for t in first for c in t.video.clips]

    errs = {}
    for label, attn in (("plain", flash_attention_plain), ("first_tile_dropped", tile_dropping_flash(True)),
                        ("last_tile_dropped", tile_dropping_flash(False))):
        with swapped_flash(attn):
            stage.process_data(first)
        got = [c.embeddings[stage.model_name] for t in first for c in t.video.clips]
        errs[label] = max(float(np.abs(a - b).max()) for a, b in zip(with_kernel, got))
    plain_err = errs["plain"]
    assert plain_err <= EMBED_BOUND, f"embed: kernel vs plain flash {plain_err} > {EMBED_BOUND}"

    n_disp = len(records)
    # model FLOPs utilization of the timed calls: the analytic forward
    # FLOPs of every clip over the dispatches' device time (CUDA events)
    flops_per_clip = flops.video_embed_forward_flops(cfg)
    device_s = sum(r.compute_s for r in records)
    return dict(
        mfu=flops.mfu(flops_per_clip * len(clips), device_s),
        mfu_inputs={"flops_per_clip": flops_per_clip, "clips": len(clips), "device_s": device_s,
                    "peak_flops": flops.chip_peak_flops(), "card": card_line()},
        breakdown=profile_window(lambda: stage.process_data(batches[1]), 2, "stage call"),
        config={"vit_width": cfg.vit.width, "vit_layers": cfg.vit.layers, "vit_heads": cfg.vit.heads,
                "image_size": size, "num_frames": cfg.num_frames, "temporal_layers": cfg.temporal_layers,
                "temporal_heads": cfg.temporal_heads, "output_dim": cfg.output_dim},
        stage_calls=EMBED_CALLS,
        clips=len(clips),
        dispatches=n_disp,
        elapsed_s=elapsed,
        clips_per_s=len(clips) / elapsed,
        wall_ms_per_dispatch=1e3 * elapsed / n_disp,
        h2d_ms_per_dispatch=1e3 * sum(r.h2d_s for r in records) / n_disp,
        compute_ms_per_dispatch=1e3 * sum(r.compute_s for r in records) / n_disp,
        d2h_ms_per_dispatch=1e3 * sum(r.d2h_s for r in records) / n_disp,
        gap_ms_per_dispatch=1e3 * sum(r.gap_s for r in records) / n_disp,
        rows_per_dispatch=[r.rows for r in records],
        max_abs_err_vs_plain_flash=plain_err,
        embed_bound=EMBED_BOUND,
        max_abs_err_vs_plain_flash_with_a_tile_dropped={k: v for k, v in errs.items() if k != "plain"},
        micro_batch=EMBED_MICRO_BATCH,
        micro_batch_sweep=sweep_micro_batch(batches, key, dev),
        setup_s=setup_s,
        launches=launches,
        peak_memory_bytes=peak,
    )


def sweep_micro_batch(batches, key: str, dev, rounds: int = SWEEP_ROUNDS) -> dict:
    """clips/s of VideoEmbedder.encode_clips (VIDEO_EMBED_BASE, seeded) over
    the embed phase's calls (32 clips each, handed over as a list) at
    micro-batches of 32, 16 and 8 clips. ``rounds`` rounds, each in another
    order; per setting, every reading and the median."""
    import cosmos_curate_tpu_torch.models.embedder as embedder

    calls = [[c.extracted_frames[key] for t in tasks for c in t.video.clips] for tasks in batches[1:]]
    settings = {"rows_32": 32, "rows_16": 16, "rows_8": 8}
    embedders = {}
    saved = embedder.EMBED_MICRO_BATCH
    try:
        for label, cap in settings.items():
            embedder.EMBED_MICRO_BATCH = cap  # read by setup()
            emb = embedder.VideoEmbedder(embedder.VIDEO_EMBED_BASE, device=dev)
            emb.setup(seed=SEED)
            embedders[label] = emb
    finally:
        embedder.EMBED_MICRO_BATCH = saved

    def one_pass(label: str) -> tuple[float, float]:
        emb = embedders[label]
        emb.device_pipeline.records.clear()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for clips in calls:
            emb.encode_clips(clips)
        torch.cuda.synchronize()
        elapsed = time.monotonic() - t0
        compute_s = sum(r.compute_s for r in emb.device_pipeline.records)
        return sum(map(len, calls)) / elapsed, 1e3 * compute_s / len(calls)

    labels = list(settings)
    for label in labels:  # warm-up: cuBLAS handles, pinned host blocks
        embedders[label].encode_clips(calls[0])
    readings = {label: [] for label in labels}
    for r in range(rounds):
        order = labels[r % len(labels):] + labels[: r % len(labels)]
        for label in order if r % 2 == 0 else reversed(order):
            readings[label].append(one_pass(label))
    return {
        label: {"clips_per_s": [c for c, _ in rs], "median_clips_per_s": statistics.median(c for c, _ in rs),
                "compute_ms_per_call": [m for _, m in rs], "dispatches_per_call": -(-len(calls[0]) // settings[label])}
        for label, rs in readings.items()
    }


def record_greedy(engine, keep_rows: bool = True):
    """Record each request's greedy choices in ``engine``, step by step,
    from the first token's logits and each decode step's: request id ->
    step -> (the id the engine chose, that step's fp32 logits, or None
    without ``keep_rows``). Returns the record and a function that gives
    the engine its own methods back."""
    steps: dict[str, dict[int, tuple[int, np.ndarray | None]]] = {}
    start_slot, decode = engine._start_slot, engine._decode

    def first(lane, slot_idx, req, t_valid, next_rope, logits_row):
        row = np.asarray(logits_row, np.float32)
        # sample_token's greedy choice
        steps.setdefault(req.request_id, {})[0] = (int(np.argmax(row)), row if keep_rows else None)
        return start_slot(lane, slot_idx, req, t_valid, next_rope, logits_row)

    def step(tables, tokens, positions, rope_positions):
        greedy, logits = decode(tables, tokens, positions, rope_positions)
        lane = next(lane for lane in engine.lanes if lane.table is tables)
        rows = logits.float().cpu().numpy() if keep_rows else [None] * len(greedy)
        for i, slot in lane.slots.items():
            steps.setdefault(slot.request.request_id, {})[len(slot.generated)] = (int(greedy[i]), rows[i])
        return greedy, logits

    engine._start_slot, engine._decode = first, step

    def restore() -> None:
        del engine._start_slot, engine._decode

    return steps, restore


def drive_slice(dev, cfg, paged_attention="auto", kv_lanes=((256, 4), (1024, 4)), *, tokenizer=None,
                prompts=None, n_frames=4, frame_fps=None, n_requests=8, keep_logits=True,
                during=contextlib.nullcontext, async_prep=True, new_tokens=64) -> tuple:
    """The caption benchmark's base workload through CaptionEngine (its
    lanes: half the slots at 256 positions, half at max_seq), or, given
    ``prompts`` ((prefix_ids, prompt_ids) pairs, taken in turn; a third
    item False makes that prompt's requests text-only) and the
    ``tokenizer`` they were encoded with, that workload's shape with other
    prompts: ``n_requests`` requests of ``n_frames`` random frames at the
    tower's size, ``new_tokens`` greedy tokens each (the request factory's
    default stays 64). ``during()`` is a context entered
    around the measured requests only (after the warm-up). With
    ``async_prep=False`` every queued request is prepped at admission, so
    the batches' rows do not depend on host timing. Returns the
    record, the engine,
    the request factory, request id -> text, and each request's greedy
    choices (``record_greedy``)."""
    from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
    from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, CaptionRequest, SamplingConfig
    from cosmos_curate_tpu_torch.ops import kernels

    t0 = time.monotonic()
    engine = CaptionEngine(
        cfg, max_batch=8, kv_lanes=kv_lanes, async_prep=async_prep, paged_attention=paged_attention, device=dev,
        tokenizer=tokenizer,
    )
    engine.setup(seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    if prompts is None:
        tok = engine.tokenizer
        prompt = get_caption_prompt("default")
        prompt_ids = tok.encode(prompt)
        long_ids = tok.encode(prompt + " transcript: " + "the camera pans across the scene. " * 40)
        prompts = [(prompt_ids, []), (prompt_ids, []), (long_ids, [])]
    rng = np.random.default_rng(SEED)
    size = cfg.qwen_vision.image_size if cfg.qwen_vision is not None else cfg.vision.image_size

    def make_request(rid: str, i: int, max_new: int = 64) -> CaptionRequest:
        prefix_ids, prompt_ids, *with_frames = prompts[i % len(prompts)]
        frames = rng.integers(0, 255, (n_frames, size, size, 3), dtype=np.uint8)
        return CaptionRequest(
            request_id=rid,
            prefix_ids=list(prefix_ids),
            prompt_ids=list(prompt_ids),
            frames=frames if with_frames in ([], [True]) else None,
            frame_fps=frame_fps,
            sampling=SamplingConfig(max_new_tokens=max_new),
        )

    # warm-up (cuBLAS handles, allocator): a short pass, then the prefix
    # cache is dropped so the measured run builds its prefixes itself
    for i in range(3):
        engine.add_request(make_request(f"warmup-{i}", i, max_new=4))
    engine.run_until_complete()
    engine.clear_prefix_cache()
    engine.reset_stats()
    torch.cuda.synchronize()

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    # earlier phases' models are held by reference cycles (an embedder and
    # its pipeline's bound forward); free them so the peak is this drive's
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    greedy, restore = record_greedy(engine, keep_logits)
    with during():
        t0 = time.monotonic()
        for i in range(n_requests):
            engine.add_request(make_request(f"r{i}", i, max_new=new_tokens))
        results = engine.run_until_complete()
        torch.cuda.synchronize()
        elapsed = time.monotonic() - t0
    launches = {name: k.launches for name, k in ks.items()}
    restore()

    assert len(results) == n_requests, f"{len(results)} of {n_requests} requests answered"
    assert all(r.num_output_tokens > 0 for r in results), "a request produced no tokens"
    assert torch.isfinite(engine._pool_k.float()).all() and torch.isfinite(engine._pool_v.float()).all()
    stats = engine.stats()
    out_tokens = sum(r.num_output_tokens for r in results)
    # one decode-kernel launch per layer per lane step
    decode_steps = launches["paged_decode" if paged_attention == "auto" else "decode"] // cfg.n_layers
    record = dict(
        paged_attention=paged_attention,
        config={"dim": cfg.dim, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "vocab": cfg.vocab,
                **({"vision": dataclasses.asdict(cfg.qwen_vision)} if cfg.qwen_vision is not None else
                   {"vision_width": cfg.vision.width, "vision_layers": cfg.vision.layers})},
        requests=len(results),
        prompt_tokens=[[len(p[0]), len(p[1])] for p in prompts],
        vision_tokens=engine._vision_token_count(n_frames),
        output_tokens=out_tokens,
        decode_tokens=engine.decode_tokens,
        elapsed_s=elapsed,
        end_to_end_tok_s=out_tokens / elapsed,
        decode_tok_s=engine.tokens_per_second,
        decode_steps=decode_steps,
        decode_ms_per_step=1e3 * stats["decode_s"] / max(1, decode_steps),
        prefill_s=stats["prefill_s"],
        prefill_tokens=stats["prefill_tokens"],
        prefix_cache_misses=engine.prefix_cache_misses,
        decode_slot_utilization=engine.decode_slot_utilization,
        kv_bytes=engine.kv_bytes(),
        setup_s=setup_s,
        launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
    )
    return record, engine, make_request, {r.request_id: r.text for r in results}, greedy


def check_drive_prefill(timer, first: tuple) -> dict:
    """Paged prefill on a drive's call, from the snapshot the witness's
    paged drive took of it (q, the call's pool layer as it stood, tables,
    write, kv_len, and the kernel's output there): run again it gives that
    output bit for bit, stays within ``BOUND`` of its fp32 plain version,
    equals ``cct_prefill`` on the gathered rows bit for bit, and is timed
    beside its bound, plain version and SDPA."""
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import prefill_attention

    q, pk, pv, tb, wi, kl, seen = first
    b, t, hk, g, d = q.shape
    bs, width = pk.shape[2], tb.shape[1] * pk.shape[2]

    def run():
        return paged_attention(q, pk, pv, tb, wi, kl)

    def plain():
        return paged_attention_plain(q, pk, pv, tb, wi, kl, layer_index=0, sm_scale=d**-0.5)

    got = run()
    assert torch.equal(got, seen), "paged prefill at the drive's shape: another output than in the drive"
    want = paged_attention_plain(q.float(), pk, pv, tb, wi, kl, layer_index=0, sm_scale=d**-0.5)
    err = (got.float() - want).abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= BOUND, f"paged prefill at the drive's shape: {err}"
    gk = pk[0][tb.long()].reshape(b, width, hk, d)
    gv = pv[0][tb.long()].reshape(b, width, hk, d)
    assert torch.equal(got, prefill_attention(q, gk.contiguous(), gv.contiguous(), wi, kl)), (
        "paged prefill at the drive's shape: not bit-equal to the contiguous prefill kernel"
    )
    write, kv_len = wi.cpu().numpy(), kl.cpu().numpy()
    qs, ks, vs, mask = sdpa_inputs(q, gk, gv, wi, kl)
    bms, by = bound_ms(*attention_work(q.shape, write, kv_len, hk, d))
    return with_shares(dict(
        shape=dict(B=b, T=t, Hkv=hk, G=g, D=d, bs=bs, nbl=tb.shape[1], write=write.tolist(),
                   kv_len=kv_len.tolist()),
        max_abs_err=err,
        kernel_ms=timer(run),
        plain_ms=timer(plain),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        bit_equal_to_prefill=True,
    ))


def agreement(a: dict, b: dict) -> dict:
    """How far two engines' greedy outputs for the same requests agree:
    identical texts, and the common prefix as a share of the first's text."""
    shares = []
    for rid, text in a.items():
        other = b[rid]
        n = next((i for i, (x, y) in enumerate(zip(text, other)) if x != y), min(len(text), len(other)))
        shares.append(n / max(1, len(text)))
    return {
        "identical": sum(a[rid] == b[rid] for rid in a),
        "requests": len(a),
        "mean_common_prefix_share": sum(shares) / len(shares),
    }


def witness_prefill(dev, cfg, paged: dict, gather: dict, timer) -> dict:
    """Which engine the requests that the paged and gather engines answer
    differently side with. Three more gather drives: with the contiguous
    prefill kernel held against its plain version in fp32 on every call the
    engine makes (the kernel's output goes on; each call's max abs error,
    over the call's largest output, must stay within ``BOUND``; the plain
    version in bf16 is held the same way), with the plain version in its
    place (the reference's rounding: bf16 probabilities), and with it at the
    kernel's stated precision (q * scale rounded to bf16, the rest in
    fp32). ``paged`` and ``gather`` are the first drives' greedy records.
    For each differing request: the first differing step, and in every run
    the choice there, the runner-up, the gap between their logits and the
    logit of the paged engine's choice minus the gather engine's; then
    which engine each witness's whole answer matches, and how many answers
    each pair of runs shares. The paged drive (both paged kernels held
    against their fp32 plain versions on every call) also counts its calls
    by (B, T) for prefill and (B, table width) for decode, and snapshots each
    prefill shape's first call; paged prefill at the most frequent shape is
    checked and timed on its snapshot (``check_drive_prefill``) and
    returned under ``paged_prefill_at_drive_shape``."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain

    def plain(q, k, v, wi, kl):
        return chunk_attention_plain(q, k, v, wi, kl, q.shape[-1] ** -0.5)

    def plain_as_kernel(q, k, v, wi, kl):
        q_scaled = (q * q.shape[-1] ** -0.5).float()  # rounded to q's bf16 first
        return chunk_attention_plain(q_scaled, k.float(), v.float(), wi, kl, 1.0).to(q.dtype)

    saved = vlm_model.prefill_attention
    # per call: the kernel's and the bf16 plain version's max abs error
    # against the fp32 plain version, its largest |output|, (B, T), and
    # whether rows past kv_len were computed
    checked = []

    def kernel_checked(q, k, v, wi, kl):
        out = saved(q, k, v, wi, kl)
        want = chunk_attention_plain(q.float(), k.float(), v.float(), wi, kl, q.shape[-1] ** -0.5)
        errs = [(x.float() - want).abs().max().item() for x in (out, plain(q, k, v, wi, kl))]
        padded = bool((wi + q.shape[1] > kl).any())
        checked.append((*errs, want.abs().max().item(), tuple(q.shape[:2]), padded))
        return out

    # the paged drive's own calls: each kernel output against its fp32 plain
    # version (kept on the device per call: no host sync in the drive)
    saved_paged = vlm_model.paged_attention
    paged_checked = {"paged_prefill": [], "paged_decode": []}
    # calls per (B, T) / (B, table width), all layers; each prefill shape's
    # first call, its pool layer cloned (device copies: no host sync)
    paged_shapes = {"paged_prefill": collections.Counter(), "paged_decode": collections.Counter()}
    first_prefill = {}

    def paged_kernel_checked(q, pk, pv, tb, wi, kl, *, layer_index=0):
        out = saved_paged(q, pk, pv, tb, wi, kl, layer_index=layer_index)
        want = paged_attention_plain(q.float(), pk, pv, tb, wi, kl, layer_index=layer_index,
                                     sm_scale=q.shape[-1] ** -0.5)
        kind = "paged_prefill" if q.shape[1] > 1 else "paged_decode"
        paged_checked[kind].append(torch.stack([(out.float() - want).abs().max(), want.abs().max()]))
        shape = (q.shape[0], q.shape[1] if q.shape[1] > 1 else tb.shape[1] * pk.shape[2])
        paged_shapes[kind][shape] += 1
        if kind == "paged_prefill" and shape not in first_prefill:
            layer = slice(layer_index, layer_index + 1)
            first_prefill[shape] = tuple(x.clone() for x in (q, pk[layer], pv[layer], tb, wi, kl, out))
        return out

    runs = {"paged": paged, "gather": gather}
    try:
        vlm_model.paged_attention = paged_kernel_checked
        _, engine, _, _, runs["paged_kernel_checked"] = drive_slice(dev, cfg)
        engine.shutdown()
        del engine
    finally:
        vlm_model.paged_attention = saved_paged
    for label, attn in (("gather_kernel_checked", kernel_checked), ("gather_plain_prefill", plain),
                        ("gather_plain_prefill_as_kernel", plain_as_kernel)):
        try:
            vlm_model.prefill_attention = attn
            _, engine, _, _, runs[label] = drive_slice(dev, cfg, paged_attention="gather")
            engine.shutdown()
            del engine
        finally:
            vlm_model.prefill_attention = saved
    tokens = {label: {rid: [s[i][0] for i in sorted(s)] for rid, s in run.items()} for label, run in runs.items()}

    def gap(choice: int, row: np.ndarray) -> tuple[int, float]:
        """The runner-up to ``choice`` and how far its logit is below."""
        others = row.copy()
        others[choice] = -np.inf
        return int(np.argmax(others)), float(row[choice] - others.max())

    witnesses = [label for label in runs if label not in ("paged", "gather")]
    gather_gaps = [gap(c, row)[1] for s in gather.values() for c, row in s.values()]
    differing = []
    for rid in sorted(tokens["paged"]):
        a, b = tokens["paged"][rid], tokens["gather"][rid]
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        at_step = {}
        for label, run in runs.items():
            if k in run[rid] and k < min(len(a), len(b)):
                choice, row = run[rid][k]
                runner_up, g = gap(choice, row)
                at_step[label] = {"choice": choice, "runner_up": runner_up, "gap": g,
                                  "paged_minus_gather_choice": float(row[a[k]] - row[b[k]])}
        differing.append({
            "request": rid,
            "first_differing_step": k,
            "at_step": at_step,
            "gather_steps_with_a_smaller_gap": sum(g < at_step["gather"]["gap"] for g in gather_gaps)
            if "gather" in at_step else None,
            "gather_steps": len(gather_gaps),
            "sides_with": {label: "paged" if tokens[label][rid] == a else "gather" if tokens[label][rid] == b
                           else "neither" for label in witnesses},
        })
    labels = list(runs)
    identical = {
        f"{x} | {y}": sum(tokens[x][rid] == tokens[y][rid] for rid in tokens[x])
        for i, x in enumerate(labels) for y in labels[i + 1:]
    }
    rel = max(e / m for e, _, m, _, _ in checked)
    assert rel <= BOUND, f"prefill kernel vs plain on the engine's inputs: {rel} of the largest output > {BOUND}"
    kernel_on_engine_inputs = {
        "calls": len(checked),
        "max_abs_err": max(c[0] for c in checked),
        "max_rel_err": rel,
        "bound_rel": BOUND,
        "plain_bf16_max_abs_err": max(c[1] for c in checked),
        "plain_bf16_max_rel_err": max(c[1] / c[2] for c in checked),
        "max_abs_output": max(c[2] for c in checked),
        "batch_and_length": sorted({c[3] for c in checked}),
        "calls_with_rows_past_kv_len": sum(c[4] for c in checked),
        "max_abs_err_with_rows_past_kv_len": max((c[0] for c in checked if c[4]), default=None),
    }
    for kind, rows in paged_checked.items():
        errs = torch.stack(rows).cpu().numpy()  # [calls, (max abs err, max |output|)]
        rel_kind = float((errs[:, 0] / errs[:, 1]).max())
        assert rel_kind <= BOUND, f"{kind} kernel vs plain on the engine's inputs: {rel_kind} > {BOUND}"
        kernel_on_engine_inputs[kind] = {
            "calls": len(rows),
            "max_abs_err": float(errs[:, 0].max()),
            "max_rel_err": rel_kind,
            "bound_rel": BOUND,
            "max_abs_output": float(errs[:, 1].max()),
            "calls_by_batch_and_length": {f"B={b} {'T' if kind == 'paged_prefill' else 'width'}={n}": c
                                          for (b, n), c in paged_shapes[kind].most_common()},
        }
    (b, t), n = paged_shapes["paged_prefill"].most_common(1)[0]
    drive_prefill = {**check_drive_prefill(timer, first_prefill.pop((b, t))), "drive_calls": n}
    return {"differing": differing, "identical_tokens": identical, "requests": len(tokens["paged"]),
            "kernel_on_engine_inputs": kernel_on_engine_inputs, "paged_prefill_at_drive_shape": drive_prefill}


def profile_window(run, steps: int, unit: str, focus: str | None = None) -> dict:
    """``run`` ``steps`` times untraced (wall time), then ``steps`` times
    under torch.profiler tracing the device only:
    device busy time, launches and top kernels per ``unit``, and the
    device's idle share of the traced window; with ``focus``, the time,
    launches and busy share of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    def window() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_wall_ms = window()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_wall_ms = window()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    assert busy_us > 0, "the profiler traced no device time"
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    focused = {}
    if focus is not None:
        hits = [e for e in kernels if focus in e.key]
        assert hits, f"no kernel named {focus} ran in the profiled window"
        focus_us = sum(e.self_device_time_total for e in hits)
        focused = {"focus": {"name": focus, "ms_per_step": focus_us / 1e3 / steps,
                             "calls_per_step": sum(e.count for e in hits) / steps, "busy_share": focus_us / busy_us}}
    return {
        "unit": unit,
        "steps": steps,
        "wall_ms_per_step": plain_wall_ms / steps,
        "traced_wall_ms_per_step": traced_wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / traced_wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top
        ],
        **focused,
    }


def profile_decode(engine, make_request, focus: str, steps: int = 16, full=None, after=None) -> dict:
    """Where a decode step's time goes, with both lanes decoding (or, given
    ``full``, once it holds): first ``steps`` engine steps with no profiler
    (wall time per step), then ``steps`` more under torch.profiler tracing
    the device only, with the decode kernel (its name holds ``focus``)
    apart. The idle share is one window's: 1 - device busy / wall of the
    traced window. ``after(engine)``, when given, runs next, while the
    batch is still full, and its dict joins the result."""
    full = full or (lambda: all(lane.slots for lane in engine.lanes))
    for i in range(8):
        engine.add_request(make_request(f"profile-{i}", i))
    deadline = time.monotonic() + 120
    # prep holds the engine lock only to hand a request over: a step loop
    # spinning on an idle engine can starve it, so let it take every request
    if engine.async_prep:
        assert engine.wait_prep_idle(120.0), "the prep thread never took the profile workload"
    while not full():
        assert time.monotonic() < deadline, "profile workload never filled the decode batch"
        engine.step()
    for _ in range(4):  # let the rest of the burst join the batch
        engine.step()
    # the async prep thread idle before the window: a CUDA call of that
    # thread racing the profiler's stop crashed the process (PERF.md §7),
    # so the window holds decode steps without prep's overlap
    if engine.async_prep:
        assert engine.wait_prep_idle(max(deadline - time.monotonic(), 0.0)), "the prep thread never went idle"
    out = profile_window(engine.step, steps, "engine step", focus)
    if after is not None:
        out.update(after(engine))
    assert full(), "a lane drained inside the profiled window"
    engine.run_until_complete()
    return out


def webp_available() -> bool:
    """Whether PIL imports here and can write WebP (the preview stage's
    format)."""
    try:
        from PIL import features
    except ImportError:
        return False
    return bool(features.check("webp"))


def optional_modules() -> dict:
    """Module -> its version (or True) where it imports here, else the
    import error; FFmpeg library -> the shared library the loader finds
    (or None), and whether libavcodec's headers are installed."""
    import ctypes.util
    import importlib
    from pathlib import Path

    out = {}
    for name in OPTIONAL_MODULES:
        try:
            mod = importlib.import_module(name)
            out[name] = str(getattr(mod, "__version__", True))
        except Exception as e:  # reported, not fatal: later slices read it
            out[name] = f"{type(e).__name__}: {e}"
    out["PIL_webp"] = webp_available()
    out["libraries"] = {name: ctypes.util.find_library(name) for name in FFMPEG_LIBRARIES}
    out["libavcodec_headers"] = Path("/usr/include/libavcodec/avcodec.h").exists() or any(
        Path("/usr/include").glob("*/libavcodec/avcodec.h"))
    return out


def drive_pipeline(dev) -> dict:
    """The annotate half of the main path through ``run_pipeline``:
    embed -> caption prep -> caption, at VIDEO_EMBED_BASE and VLM_BASE
    (``model_flavor="base"``, seeded), with ``split.py``'s stage settings
    (window_len 256, 8 frames a window, stage batch 32) but
    ``PIPELINE_NEW_TOKENS`` new tokens.
    Tasks of EMBED_CLIPS_PER_TASK clips x 8 random 224x224 frames at 8 fps,
    each clip 1 s of a 30 fps video: one caption window. First the default
    runner over PIPELINE_TASKS tasks, then SequentialRunner over
    PIPELINE_SEQUENTIAL_TASKS of them on the same frames (the same seeded
    weights: the embedder re-seeds, the caption engine is shared), then the
    caption efficiency over EFFICIENCY_TASKS tasks on that engine."""
    from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
    from cosmos_curate_tpu_torch.core.runner import RUNNER_ENV, SequentialRunner, default_runner
    from cosmos_curate_tpu_torch.data.model import (
        Clip,
        FrameExtractionSignature,
        SplitPipeTask,
        Video,
        VideoMetadata,
    )
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_BASE
    from cosmos_curate_tpu_torch.models.vlm import CaptionRequest, SamplingConfig, SharedCaptionEngine
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionPrepStage, CaptionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    cfg = VIDEO_EMBED_BASE
    sig = FrameExtractionSignature("fps", 8.0)
    size = cfg.vit.image_size
    rng = np.random.default_rng(SEED + 3)
    frames = [
        [rng.integers(0, 256, (cfg.num_frames, size, size, 3), dtype=np.uint8) for _ in range(EMBED_CLIPS_PER_TASK)]
        for _ in range(PIPELINE_TASKS)
    ]

    def make_tasks(n: int) -> list:
        return [
            SplitPipeTask(video=Video(
                path=f"video-{t}.mp4",
                metadata=VideoMetadata(width=size, height=size, fps=30.0, num_frames=30 * EMBED_CLIPS_PER_TASK,
                                       duration_s=float(EMBED_CLIPS_PER_TASK)),
                clips=[Clip(source_video=f"video-{t}", span=(float(i), float(i + 1)),
                            extracted_frames={sig.key(): f}) for i, f in enumerate(frames[t])],
            ))
            for t in range(n)
        ]

    # the pipelined run: which host thread and CUDA stream each stage's
    # batches ran on, and when
    batches: list[tuple[str, str, int, float, float]] = []
    batches_lock = threading.Lock()

    def stages() -> list:
        out = [ClipEmbeddingStage(variant="video", extraction=sig), CaptionPrepStage(extraction=sig),
               CaptionStage(model_flavor="base", max_new_tokens=PIPELINE_NEW_TOKENS)]
        for stage in out:
            def traced(tasks, _run=stage.process_data, _name=stage.name):
                t0 = time.monotonic()
                try:
                    return _run(tasks)
                finally:
                    with batches_lock:
                        batches.append((_name, threading.current_thread().name,
                                        torch.cuda.current_stream().cuda_stream, t0, time.monotonic()))

            stage.process_data = traced
        return out

    def drive(runner, n: int) -> tuple[list, float, int, dict, object]:
        ks = kernels()
        for k in ks.values():
            k.launches = 0
        batches.clear()
        used = stages()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = run_pipeline(make_tasks(n), used, runner=runner)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        caption = used[2]
        tokens = caption.model.engine.owner_decode_tokens.get(caption.owner, 0)
        return out, wall, tokens, {name: k.launches for name, k in ks.items()}, caption

    def check(out: list, n: int, label: str) -> dict:
        assert len(out) == n, f"{label}: {len(out)} of {n} tasks came out"
        clips = [c for t in out for c in t.video.clips]
        windows = [w for c in clips for w in c.windows]
        assert len(clips) == n * EMBED_CLIPS_PER_TASK, f"{label}: {len(clips)} clips"
        for c in clips:
            emb = c.embeddings.get("video-embed-tpu")
            assert emb is not None and emb.shape == (cfg.output_dim,) and np.isfinite(emb).all(), f"{label}: embedding"
            assert len(c.windows) == 1, f"{label}: {len(c.windows)} windows in a 1 s clip"
        assert all(w.caption.get("default") for w in windows), f"{label}: a window has no caption"
        return {"clips_embedded": len(clips), "windows_captioned": len(windows)}

    def outputs(out: list) -> dict:
        return {(t.video.path, c.span, (w.start_frame, w.end_frame)): (c.embeddings["video-embed-tpu"],
                                                                         w.caption["default"])
                for t in out for c in t.video.clips for w in c.windows}

    def concurrent_s(a: str, b: str) -> float:
        """Seconds during which a batch of stage ``a`` and one of ``b`` ran
        at once (the two stages' batches do not overlap themselves)."""
        spans_a = [(t0, t1) for name, _, _, t0, t1 in batches if name == a]
        spans_b = [(t0, t1) for name, _, _, t0, t1 in batches if name == b]
        return sum(max(0.0, min(a1, b1) - max(a0, b0)) for a0, a1 in spans_a for b0, b1 in spans_b)

    os.environ.pop(RUNNER_ENV, None)
    runner = default_runner()
    assert isinstance(runner, PipelinedRunner), f"default runner is {type(runner).__name__}"
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    piped, wall, tokens, launches, caption = drive(runner, PIPELINE_TASKS)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = check(piped, PIPELINE_TASKS, "pipelined")
    streams = collections.defaultdict(set)
    for name, thread, stream, _, _ in batches:
        streams[name].add((thread, stream))
    embed_caption_s = concurrent_s("ClipEmbeddingStage", "CaptionStage")
    assert embed_caption_s > 0, "the embed and caption stages never ran at once"
    assert runner.overlap_frac > 0, f"overlap fraction {runner.overlap_frac}"
    seq, seq_wall, seq_tokens, seq_launches, seq_caption = drive(SequentialRunner(), PIPELINE_SEQUENTIAL_TASKS)
    seq_counts = check(seq, PIPELINE_SEQUENTIAL_TASKS, "sequential")
    engine = caption.model.engine
    assert seq_caption.model.engine is engine, "the two runs' caption stages did not share one engine"
    # caption pipeline efficiency (benchmarks/caption_benchmark.py:263-390):
    # the same windows straight into the engine the runs above built and
    # warmed, then through a CaptionStage sharing it; decode tokens over
    # wall on both sides
    prepped = run_pipeline(make_tasks(EFFICIENCY_TASKS), [CaptionPrepStage(extraction=sig)],
                           runner=SequentialRunner())
    eff_stage = CaptionStage(model_flavor="base", max_new_tokens=PIPELINE_NEW_TOKENS)
    windows = [(f"{c.uuid}-{i}", w) for t in prepped for c in t.video.clips for i, w in enumerate(c.windows)]
    prefix_ids, prompt_ids = eff_stage.model.encode_prompt(eff_stage.prompt_text)

    def submit(tag: str, wins: list) -> None:
        for rid, win in wins:
            engine.add_request(CaptionRequest(
                request_id=f"{tag}{rid}", prefix_ids=list(prefix_ids), prompt_ids=list(prompt_ids),
                frames=win.frames, frame_fps=win.frame_fps,
                sampling=SamplingConfig(max_new_tokens=eff_stage.max_new_tokens)))

    def timed(run) -> tuple[float, int]:
        before = engine.decode_tokens
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        return time.monotonic() - t0, engine.decode_tokens - before

    def standalone() -> None:
        submit("standalone-", windows)
        engine.run_until_complete()

    standalone_s, standalone_tokens = timed(standalone)
    stage_s, stage_tokens = timed(lambda: run_pipeline(prepped, [eff_stage], runner=SequentialRunner()))
    assert all(w.caption.get("default") for _, w in windows), "efficiency: a window has no caption"
    standalone_tok_s = standalone_tokens / standalone_s
    stage_tok_s = stage_tokens / stage_s
    SharedCaptionEngine.reset()

    a = outputs(piped)
    b = outputs(seq)
    assert set(b) <= set(a), "the sequential runner made clips or windows the pipelined runner did not"
    assert {k for k in a if k[0] in {t.video.path for t in seq}} == set(b), "the runners' output sets differ"
    emb_errs = [float(np.abs(a[k][0] - b[k][0]).max()) for k in b]
    same_captions = sum(a[k][1] == b[k][1] for k in b)
    emb_agree = sum(e <= EMBED_BOUND for e in emb_errs)
    assert emb_agree == len(b), f"embeddings of the two runners differ by {max(emb_errs)} > {EMBED_BOUND}"
    return dict(
        runner=type(runner).__name__,
        tasks=PIPELINE_TASKS,
        **counts,
        wall_s=wall,
        clips_per_s=counts["clips_embedded"] / wall,
        decode_tokens=tokens,
        in_pipeline_tok_s=tokens / wall,
        overlap_frac=runner.overlap_frac,
        embed_caption_concurrent_s=embed_caption_s,
        caption_efficiency={"windows": len(windows), "standalone_s": standalone_s,
                            "standalone_decode_tokens": standalone_tokens, "standalone_tok_s": standalone_tok_s,
                            "stage_s": stage_s, "stage_decode_tokens": stage_tokens, "stage_tok_s": stage_tok_s,
                            "caption_pipeline_efficiency": stage_tok_s / standalone_tok_s},
        launches=launches,
        stage_busy_s=dict(runner.stage_times),
        stage_counts=runner.stage_counts,
        streams={k: sorted(v) for k, v in streams.items()},
        peak_memory_bytes=peak,
        sequential={"tasks": PIPELINE_SEQUENTIAL_TASKS, **seq_counts, "wall_s": seq_wall,
                    "decode_tokens": seq_tokens, "launches": seq_launches},
        same_output_sets=True,
        embeddings_within_bound=emb_agree,
        max_abs_embedding_diff=max(emb_errs),
        embed_bound=EMBED_BOUND,
        identical_captions=same_captions,
        windows_compared=len(b),
    )


def scene_frames(rng, scene_idx: int):
    """One scene of bench.py's corpus (bench.py:57-81): a moving diagonal
    gradient over a per-scene noise texture, plus a tracked high-contrast
    block; deterministic per (video, scene)."""
    import cv2

    c0 = rng.integers(0, 255, 3).astype(np.float32)
    c1 = rng.integers(0, 255, 3).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi)
    speed = rng.uniform(2.0, 8.0)  # gradient pixels/frame
    noise = rng.integers(0, 60, (SPLIT_FRAME_H // 4, SPLIT_FRAME_W // 4, 3), dtype=np.uint8)
    noise = cv2.resize(noise, (SPLIT_FRAME_W, SPLIT_FRAME_H), interpolation=cv2.INTER_LINEAR)
    noise_f = noise.astype(np.float32)
    yy, xx = np.mgrid[0:SPLIT_FRAME_H, 0:SPLIT_FRAME_W]
    proj = (np.cos(angle) * xx + np.sin(angle) * yy).astype(np.float32)
    span = float(proj.max() - proj.min()) or 1.0
    bx = int(rng.integers(0, SPLIT_FRAME_W - 160))
    bvx = int(rng.integers(3, 11)) * (1 if scene_idx % 2 == 0 else -1)
    for f in range(SPLIT_SCENE_FRAMES):
        phase = ((proj + f * speed) % span) / span
        frame = (c0[None, None] * (1 - phase[..., None]) + c1[None, None] * phase[..., None])
        frame = np.clip(frame + noise_f - 30.0, 0, 255).astype(np.uint8)
        x = (bx + f * bvx) % (SPLIT_FRAME_W - 160)
        frame[280:440, x : x + 160] = (255 - c0).astype(np.uint8)
        yield frame


def write_corpus_video(vids: Path, i: int) -> Path:
    """Video ``i`` of bench.py's corpus (bench.py:84-103): its own rng,
    seeded by its index."""
    import cv2

    rng = np.random.default_rng(1000 + i)
    path = vids / f"bench_{i}.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (SPLIT_FRAME_W, SPLIT_FRAME_H))
    assert w.isOpened(), "cv2 cannot write mp4v here"
    for scene in range(SPLIT_NUM_SCENES):
        for frame in scene_frames(rng, scene):
            w.write(frame)
    w.release()
    return path


def make_corpus(vids: Path, n: int = SPLIT_VIDEOS) -> list[Path]:
    """The first ``n`` videos of bench.py's corpus, one spawned worker
    process per core: the frame generator runs numpy on the interpreter's
    thread, so threads would share one lock."""
    import multiprocessing

    vids.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 1, mp_context=ctx) as pool:
        return list(pool.map(write_corpus_video, [vids] * n, range(n)))


@contextlib.contextmanager
def timed_stages(classes, spans: list):
    """Wrap each stage class's ``process_data`` for the duration: every call
    appends (stage, host thread, tasks, clips, start, end) to ``spans``."""
    lock = threading.Lock()
    saved = {cls: cls.__dict__["process_data"] for cls in classes}

    def wrap(fn):
        @functools.wraps(fn)
        def process_data(self, tasks):
            clips = sum(len(t.video.clips) for t in tasks)
            t0 = time.monotonic()
            try:
                return fn(self, tasks)
            finally:
                with lock:
                    spans.append((self.name, threading.current_thread().name, len(tasks), clips, t0,
                                  time.monotonic()))
        return process_data

    for cls, fn in saved.items():
        cls.process_data = wrap(fn)
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.process_data = fn


@contextlib.contextmanager
def peak_rss(out: dict):
    """The host's resident set size at the block's start (``out["start"]``)
    and its peak over the block (``out["bytes"]``), sampled every
    SPLIT_RSS_SAMPLE_S from /proc/self/status."""
    stop = threading.Event()

    def rss() -> int:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))

    def sample() -> None:
        while not stop.is_set():
            out["bytes"] = max(out.get("bytes", 0), rss())
            stop.wait(SPLIT_RSS_SAMPLE_S)

    out["start"] = out["bytes"] = rss()
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=5)


@contextlib.contextmanager
def split_corpus(n: int = SPLIT_VIDEOS):
    """The first ``n`` videos of bench.py's corpus in a temporary directory,
    removed at exit: (root, video paths, seconds to build them)."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_split-"))
    try:
        t0 = time.monotonic()
        corpus = make_corpus(root / "videos", n)
        yield root, corpus, time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def corpus_in_background(n: int = SPLIT_VIDEOS):
    """``split_corpus``, its videos written by spawned workers (one core
    left to the caller) while the caller goes on: yields ``ready()``, which
    waits for the last video and returns (root, video paths, seconds from
    the start to the last video, seconds the caller waited)."""
    import multiprocessing

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_split-"))
    vids = root / "videos"
    vids.mkdir(parents=True)
    t0 = time.monotonic()
    workers = max(1, (os.cpu_count() or 2) - 1)
    pool = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(write_corpus_video, vids, i) for i in range(n)]
    done: list = []

    def ready() -> tuple:
        if not done:
            waited = time.monotonic()
            paths = [f.result() for f in futures]
            end = time.monotonic()
            done.append((root, paths, end - t0, end - waited))
        return done[0]

    try:
        yield ready
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def patched_environ(values: dict[str, str | None]):
    """``os.environ`` with ``values`` set (None: removed), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def subset(root: Path, corpus: list[Path], name: str, n: int) -> Path:
    """A directory of links to the corpus's first ``n`` videos."""
    d = root / name
    d.mkdir()
    for path in corpus[:n]:
        (d / path.name).symlink_to(path)
    return d


def stage_busy(spans: list, wall: float) -> dict:
    """Per stage: calls, tasks, clips, busy seconds and share of the wall,
    the host threads it ran on (from ``timed_stages``' spans)."""
    by = collections.defaultdict(lambda: {"calls": 0, "tasks": 0, "clips": 0, "busy_s": 0.0, "threads": set()})
    for name, thread, n_tasks, n_clips, t0, t1 in spans:
        rec = by[name]
        rec["calls"] += 1
        rec["tasks"] += n_tasks
        rec["clips"] += n_clips
        rec["busy_s"] += t1 - t0
        rec["threads"].add(thread)
    return {name: {**rec, "threads": sorted(rec["threads"]), "busy_share": rec["busy_s"] / wall,
                   "busy_ms_per_call": 1e3 * rec["busy_s"] / rec["calls"]} for name, rec in by.items()}


def split_args(videos: Path, out: Path, **kw):
    """``SplitPipelineArgs`` of run A (bench.py's headline settings) on
    ``videos``, written to ``out``, with ``kw`` on top."""
    from cosmos_curate_tpu_torch.pipelines.video import split

    return split.SplitPipelineArgs(
        input_path=str(videos), output_path=str(out), fixed_stride_len_s=1.0, min_clip_len_s=0.5,
        extract_fps=(8.0,), extract_resize_hw=(224, 224), embedding_model="video", **kw)


def split_run(dev, a, runner, stage_classes, config=None) -> dict:
    """One run_split (with ``config``, where given) with every launch
    counter zeroed just before it: summary, wall, launches, stage spans,
    flash shapes, peaks."""
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.pipelines.video import split

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    spans: list = []
    rss: dict = {}
    shapes: set = set()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with timed_stages(stage_classes, spans), peak_rss(rss), recorded_flash_shapes(shapes):
        t0 = time.monotonic()
        summary = split.run_split(a, runner=runner, config=config)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return dict(summary=summary, wall=wall, launches={name: k.launches for name, k in ks.items()},
                spans=spans, flash_shapes=shapes, peak_device=torch.cuda.max_memory_allocated(dev),
                peak_rss=rss["bytes"], start_rss=rss["start"])


def split_outputs(out: Path, model: str) -> tuple[dict, dict, set]:
    """(uuid -> meta of every kept clip, uuid -> ``model``'s embedding,
    output file names)."""
    import pyarrow.parquet as pq

    metas = {p.stem: json.loads(p.read_text()) for p in (out / "metas" / "v0").glob("*.json")}
    embs = {}
    for path in (out / "embeddings" / model).glob("*.parquet"):
        table = pq.read_table(path).to_pydict()
        for uuid, emb in zip(table["clip_uuid"], table["embedding"], strict=True):
            assert uuid not in embs, f"{uuid} embedded twice"
            embs[uuid] = np.asarray(emb, np.float32)
    files = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}
    return metas, embs, files


def check_unit_embeddings(embs: dict, dim: int, label: str) -> None:
    for uuid, emb in embs.items():
        assert emb.shape == (dim,) and np.isfinite(emb).all(), f"{label}: embedding of {uuid}"
        assert abs(float(np.linalg.norm(emb)) - 1.0) < 1e-2, f"{label}: embedding of {uuid} is not unit-norm"


def check_new_flash_shapes(timer, shapes: set, seed: int) -> dict:
    """Flash at every shape in ``shapes`` that ``FLASH_CASES`` does not
    hold, against its plain version, timed."""
    checked = {(shape, causal) for _, shape, causal in FLASH_CASES}
    bf16 = random_bf16(np.random.default_rng(seed), "cuda")
    return {f"{'x'.join(map(str, shape))}{'_causal' if causal else ''}": check_flash(timer, bf16, shape, causal, "split")
            for shape, causal in sorted(shapes - checked)}


def drive_split(dev, timer, root: Path, corpus: list[Path], corpus_s: float) -> dict:
    """The whole main path through ``run_split``, on bench.py's corpus.
    Every flash shape the runs give the wrapper is one the kernels phase
    checked and timed (run A's embed dispatches must be), or is checked and
    timed here."""
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
    from cosmos_curate_tpu_torch.core.runner import RUNNER_ENV, SequentialRunner, default_runner
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage
    from cosmos_curate_tpu_torch.video.h264 import h264_status

    stage_classes = (
        split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
        split.ClipFrameExtractionStage, split.ClipEmbeddingStage, split.CaptionPrepStage, split.CaptionStage,
        ClipWriterStage,
    )
    cfg, model = VIDEO_EMBED_VARIANTS["video"]
    checked_shapes = {(shape, causal) for _, shape, causal in FLASH_CASES}
    os.environ.pop(RUNNER_ENV, None)

    def args(videos: Path, out: str, **kw):
        return split_args(videos, root / out, **kw)

    # run A: bench.py's headline row through the default runner
    runner = default_runner()
    assert isinstance(runner, PipelinedRunner), f"default runner is {type(runner).__name__}"
    a = split_run(dev, args(root / "videos", "out_a"), runner, stage_classes)
    summary = a["summary"]
    for key in ("num_clips", "num_transcoded", "num_with_embeddings"):
        assert summary[key] == SPLIT_CLIPS, f"run A: {key} = {summary[key]}, not {SPLIT_CLIPS}"
    assert summary["num_videos"] == SPLIT_VIDEOS and summary["num_errors"] == 0, summary
    assert runner.dlq is None or runner.dlq.recorded == 0, "run A dropped a batch"
    # run A's stages ask more CPUs of first grants than 8 cores hold
    if os.cpu_count() <= 8:
        assert runner.plans == [[1] * 6], f"run A planned {runner.plans}"
    # every run leaves its final live status
    status = json.loads((root / "out_a" / "report" / "live" / "status.json").read_text())
    assert status["state"] == "finished" and status["runner"] == "pipelined", status["state"]
    assert len(status["stages"]) == 6 and all(st["finished"] for st in status["stages"].values()), "run A: live status"
    metas, embs, files = split_outputs(root / "out_a", model)
    assert len(metas) == SPLIT_CLIPS, f"run A: {len(metas)} metas"
    assert len(embs) == SPLIT_CLIPS and set(embs) == set(metas), f"run A: {len(embs)} parquet rows"
    assert sum(f.startswith("clips/") for f in files) == SPLIT_CLIPS, "run A: clip files"
    assert sum(f.startswith("processed_videos/") for f in files) == SPLIT_VIDEOS, "run A: resume records"
    check_unit_embeddings(embs, cfg.output_dim, "run A")
    codecs = sorted({m["codec"] for m in metas.values()})
    assert len(codecs) == 1 and codecs[0], f"run A: codecs {codecs}"
    assert a["launches"]["flash"] > 0, "run A: flash was not launched"
    # the kernels phase checked and timed flash at every embed dispatch
    off_cases = a["flash_shapes"] - checked_shapes
    assert not off_cases, f"run A: flash cases off the split path: {sorted(off_cases)}"
    run_a = dict(
        videos=SPLIT_VIDEOS, clips=summary["num_clips"], num_transcoded=summary["num_transcoded"],
        num_with_embeddings=summary["num_with_embeddings"], metas=len(metas), parquet_rows=len(embs),
        wall_s=a["wall"], clips_per_s=summary["num_clips"] / a["wall"],
        pipeline_run_time_s=summary["pipeline_run_time_s"],
        video_hours_per_day_per_chip=summary["video_hours_per_day_per_chip"],
        codec=codecs[0], native_h264=h264_status(), stages=stage_busy(a["spans"], a["wall"]),
        overlap_frac=runner.overlap_frac, launches=a["launches"],
        plans=runner.plans, workers={name: c["workers"] for name, c in runner.stage_counts.items()},
        peak_device_memory_bytes=a["peak_device"], peak_host_rss_bytes=a["peak_rss"],
        host_rss_at_start_bytes=a["start_rss"],
        live_status={"state": status["state"], "seq": status["seq"], "stages": len(status["stages"]),
                     "anomaly_count": status["anomaly_count"],
                     "anomalies": [f"{ev['kind']}@{ev['stage']}" for ev in status["anomalies"]]},
    )

    # resume: a second run_split on run A's output finds every video done
    assert discover_split_tasks(str(root / "videos"), str(root / "out_a")) == [], "resume: videos rediscovered"
    again = split_run(dev, args(root / "videos", "out_a"), default_runner(), stage_classes)
    assert again["summary"]["num_videos"] == 0, f"resume: {again['summary']['num_videos']} videos rerun"

    # run B: split-annotate on the first videos, captions at VLM_BASE
    SharedCaptionEngine.reset()
    try:
        b = split_run(dev, args(subset(root, corpus, "videos_b", SPLIT_CAPTION_VIDEOS), "out_b", captioning=True,
                                caption_model="base"), default_runner(), stage_classes)
    finally:
        SharedCaptionEngine.reset()
    b_metas, b_embs, _ = split_outputs(root / "out_b", model)
    b_clips = SPLIT_CAPTION_VIDEOS * SPLIT_CLIPS // SPLIT_VIDEOS
    windows = [w for m in b_metas.values() for w in m["windows"]]
    assert len(b_metas) == b_clips and len(b_embs) == b_clips, f"run B: {len(b_metas)} metas"
    assert all(m["windows"] for m in b_metas.values()), "run B: a clip has no caption window"
    assert all(w["captions"].get("default") for w in windows), "run B: a window has no caption"
    assert b["summary"]["num_with_captions"] == b_clips, b["summary"]
    check_unit_embeddings(b_embs, cfg.output_dim, "run B")
    for name in PIPELINE_KERNELS:
        assert b["launches"][name] > 0, f"run B: kernel {name} was not launched"
    run_b = dict(videos=SPLIT_CAPTION_VIDEOS, clips=len(b_metas), windows_captioned=len(windows),
                 wall_s=b["wall"], clips_per_s=len(b_metas) / b["wall"],
                 video_hours_per_day_per_chip=b["summary"]["video_hours_per_day_per_chip"],
                 stages=stage_busy(b["spans"], b["wall"]), launches=b["launches"],
                 peak_device_memory_bytes=b["peak_device"], peak_host_rss_bytes=b["peak_rss"],
                 host_rss_at_start_bytes=b["start_rss"])

    # the two runners on the same videos
    videos_c = subset(root, corpus, "videos_c", SPLIT_AGREEMENT_VIDEOS)
    seq = split_run(dev, args(videos_c, "out_seq"), SequentialRunner(), stage_classes)
    piped = split_run(dev, args(videos_c, "out_piped"), default_runner(), stage_classes)
    s_metas, s_embs, s_files = split_outputs(root / "out_seq", model)
    p_metas, p_embs, p_files = split_outputs(root / "out_piped", model)
    assert set(s_metas) == set(p_metas) and len(s_metas) == SPLIT_AGREEMENT_VIDEOS * 4, "runners: clip uuids"
    assert {f for f in s_files if f != "summary.json"} == {f for f in p_files if f != "summary.json"}, \
        "runners: output files"
    emb_diff = max(float(np.abs(s_embs[u] - p_embs[u]).max()) for u in s_embs)
    assert emb_diff <= EMBED_BOUND, f"runners: embeddings differ by {emb_diff} > {EMBED_BOUND}"
    for key in ("num_clips", "num_transcoded", "num_with_embeddings"):
        assert seq["summary"][key] == piped["summary"][key] == SPLIT_AGREEMENT_VIDEOS * 4, key

    # flash at every shape of the phase the kernels phase did not check
    # (the caption ViT tower's batches of run B), against its plain version
    ran = set().union(*(r["flash_shapes"] for r in (a, again, b, seq, piped)))
    flash_here = check_new_flash_shapes(timer, ran, SEED + 7)
    return dict(
        cpu_count=os.cpu_count(), corpus={"videos": SPLIT_VIDEOS, "size": [SPLIT_FRAME_W, SPLIT_FRAME_H],
                                          "seconds": SPLIT_NUM_SCENES * SPLIT_SCENE_FRAMES / 24,
                                          "build_s": corpus_s},
        run_a=run_a, run_b=run_b,
        runners={"clips": len(s_metas), "same_clip_uuids": True, "same_output_files": True,
                 "max_abs_embedding_diff": emb_diff, "embed_bound": EMBED_BOUND,
                 "sequential_wall_s": seq["wall"], "pipelined_wall_s": piped["wall"]},
        resume={"videos_discovered": again["summary"]["num_videos"], "wall_s": again["wall"]},
        flash_shapes={"run_a": [list(shape) for shape, _ in sorted(a["flash_shapes"])],
                      "run_b": [list(shape) for shape, _ in sorted(b["flash_shapes"])],
                      "checked_here": flash_here},
        flash_shapes_ran=[[list(shape), causal] for shape, causal in sorted(ran | checked_shapes)],
        split_launches={name: run_a["launches"][name] + run_b["launches"][name] for name in run_a["launches"]},
    )


def check_ocr(dev) -> dict:
    """The OCR detector and recognizer on the committed weights, on the card
    (fp32, TF32 off) against the port's CPU path on the golden fixtures:
    logits within OCR_BOUND of their scale, the same coverage and strings;
    then the golden assertions, and the card's time per clip of the text
    filter's learned score (4 frames)."""
    from cosmos_curate_tpu_torch.models.ocr import OcrModel
    from cosmos_curate_tpu_torch.models.ocr_train import golden_eval_frames, golden_rec_sample

    gpu, cpu = OcrModel(device=dev), OcrModel(device="cpu")
    gpu.setup(require_weights=True)
    cpu.setup(require_weights=True)
    clean, texty = golden_eval_frames()
    out = {}
    for label, frames in (("clean", clean), ("texty", texty)):
        g, c = gpu.heatmap(frames), cpu.heatmap(frames)
        g_logits, c_logits = gpu.detector_logits(frames), cpu.detector_logits(frames)
        err = float(np.abs(g_logits - c_logits).max() / np.abs(c_logits).max())
        cover, c_cover = gpu.text_coverage(frames), cpu.text_coverage(frames)
        assert cover == c_cover, f"ocr {label}: coverage {cover} on the card, {c_cover} on the CPU"
        assert np.array_equal(g > 0.5, c > 0.5), f"ocr {label}: the thresholded heatmaps differ"
        out[f"detector_{label}"] = {"rel_err": err, "coverage": cover}
    samples = {t: golden_rec_sample(t)[None] for t in ("HELLO 42", "subscribe now!", "CUDA 12.8")}
    for text, crop in samples.items():
        g, c = gpu.recognizer_logits(crop), cpu.recognizer_logits(crop)
        err = float(np.abs(g - c).max() / np.abs(c).max())
        read, c_read = gpu.recognize(crop), cpu.recognize(crop)
        assert read == c_read, f"ocr: the card reads {read}, the CPU {c_read}"
        out[f"recognizer_{text}"] = {"rel_err": err, "read": read[0]}
    worst = max(v["rel_err"] for v in out.values())
    assert worst <= OCR_BOUND, f"ocr: logits differ by {worst} of their scale > {OCR_BOUND}"
    # tests/models/test_ocr.py's golden checks
    cov_text, cov_clean = out["detector_texty"]["coverage"], out["detector_clean"]["coverage"]
    assert cov_text > 2 * max(cov_clean, 1e-4) and cov_text > 0.01, (cov_text, cov_clean)
    # the reference's own gate: 5 of 8 read; 3 or 4 is a clear but
    # degraded signal that the test skips as environment drift (this
    # host's cv2 renders the sample with other pixels than the trainer's);
    # fewer fail
    matches = sum(a == b for a, b in zip(out["recognizer_HELLO 42"]["read"], "HELLO 42"))
    assert matches >= 3, out["recognizer_HELLO 42"]
    # the text filter's learned score of one clip: 4 frames of 224^2
    clips = np.random.default_rng(SEED + 13).integers(0, 256, (OCR_TIMED_CLIPS, 4, 224, 224, 3), dtype=np.uint8)
    gpu.text_coverage(clips[0])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for clip in clips:
        gpu.text_coverage(clip)
    ms = 1e3 * (time.monotonic() - t0) / OCR_TIMED_CLIPS
    t0 = time.monotonic()
    for clip in clips[:4]:
        cpu.text_coverage(clip)
    cpu_ms = 1e3 * (time.monotonic() - t0) / 4
    import cv2

    return {"bound": OCR_BOUND, "max_rel_err": worst, "checks": out, "golden_hello_matches": matches,
            "golden_hello_degraded": matches < 5, "cv2": cv2.__version__,
            "ms_per_clip_card": ms, "ms_per_clip_host_cpu": cpu_ms}


def fanout_run(dev, videos: Path, out: Path, pinned: bool) -> dict:
    """Run A's stages (1 s clips, 8 fps 224^2 frames, ``video`` embeddings)
    with ``transcode_cpus=1`` on FILTER_FANOUT_CPUS CPUs of budget through
    the pipelined runner: fanned out, or with ``StageSpec(num_workers=1)``
    on every stage."""
    from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, run_pipeline
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
    from cosmos_curate_tpu_torch.core.stage import StageSpec
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks

    a = split.SplitPipelineArgs(input_path=str(videos), output_path=str(out), fixed_stride_len_s=1.0,
                                min_clip_len_s=0.5, extract_fps=(8.0,), extract_resize_hw=(224, 224),
                                embedding_model="video", transcode_cpus=1)
    stages = [StageSpec(stage=s, num_workers=1 if pinned else None) for s in split.assemble_stages(a)]
    runner = PipelinedRunner()
    spans: list = []
    torch.cuda.synchronize()
    with timed_stages({type(s.stage) for s in stages}, spans):
        t0 = time.monotonic()
        done = run_pipeline(discover_split_tasks(a.input_path, a.output_path), stages,
                            config=PipelineConfig(num_cpus=FILTER_FANOUT_CPUS), runner=runner)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    clips = sum(t.stats.num_clips for t in done)
    busy = stage_busy(spans, wall)
    return dict(wall_s=wall, clips=clips, clips_per_s=clips / wall, first_plan=runner.plans[0],
                last_plan=runner.plans[-1], replans=len(runner.plans),
                stages={name: {"workers": c["workers"], "busy_share": busy[name]["busy_share"],
                               "calls": busy[name]["calls"]} for name, c in runner.stage_counts.items()},
                overlap_frac=runner.overlap_frac)


def drive_filters(dev, root: Path, corpus: list[Path]) -> dict:
    """The split's filters and enhanced captions on the card through
    ``run_split`` and the default runner, then the fan-out pair."""
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    ocr = check_ocr(dev)
    videos = subset(root, corpus, "videos_filters", FILTER_VIDEOS)
    stage_classes = (split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.ArtificialTextFilterStage, split.SemanticFilterStage,
                     split.ClipEmbeddingStage, split.CaptionPrepStage, split.CaptionStage, split.EnhanceCaptionStage,
                     ClipWriterStage)
    out = root / "out_filters"
    args = split.SplitPipelineArgs(
        input_path=str(videos), output_path=str(out), fixed_stride_len_s=1.0, min_clip_len_s=0.5,
        extract_fps=(8.0,), extract_resize_hw=(224, 224), text_filter="enable", semantic_filter="enable",
        embedding_model="video", captioning=True, caption_model="base", enhance_captions=True)
    runner = default_runner()
    assert isinstance(runner, PipelinedRunner), f"default runner is {type(runner).__name__}"
    SharedCaptionEngine.reset()
    try:
        f = split_run(dev, args, runner, stage_classes)
        engines = SharedCaptionEngine.stats()
    finally:
        SharedCaptionEngine.reset()
    summary = f["summary"]
    n_clips = FILTER_VIDEOS * SPLIT_CLIPS // SPLIT_VIDEOS
    assert summary["num_videos"] == FILTER_VIDEOS and summary["num_errors"] == 0, summary
    assert summary["num_clips"] == n_clips, summary
    kept, embs, _ = split_outputs(out, VIDEO_EMBED_VARIANTS["video"][1])
    filtered = {p.stem: json.loads(p.read_text()) for p in (out / "metas" / "filtered").glob("*.json")}
    metas = {**kept, **filtered}
    assert len(metas) == n_clips, f"filters: {len(metas)} metas"
    # every clip scored by the text filter; every clip it kept asked of the
    # semantic filter (an unparseable answer leaves the verdict None)
    assert all(isinstance(m["artificial_text_score"], float) for m in metas.values()), "a clip has no text score"
    by_text = {u for u, m in filtered.items() if m["filtered_by"] == "text"}
    by_semantic = {u for u, m in filtered.items() if m["filtered_by"] == "semantic"}
    assert by_text | by_semantic == set(filtered), {m["filtered_by"] for m in filtered.values()}
    assert summary["num_filtered_by_text"] == len(by_text) and summary["num_filtered_by_semantic"] == len(by_semantic)
    busy = stage_busy(f["spans"], f["wall"])
    assert busy["SemanticFilterStage"]["clips"] == n_clips - len(by_text), busy["SemanticFilterStage"]
    owners = next(iter(engines.values()))["owners"]
    sem_owner = next(o for o in owners if o.startswith("semantic-filter#"))
    assert owners[sem_owner]["requests"] == n_clips - len(by_text), owners
    windows = [w for m in kept.values() for w in m["windows"]]
    assert windows and all(m["windows"] for m in kept.values()), "filters: a kept clip has no caption window"
    assert all(w["captions"].get("default") for w in windows), "filters: a window has no caption"
    assert all("default" in w["enhanced_captions"] for w in windows), "filters: a window has no enhanced caption"
    assert set(embs) == set(kept), "filters: the kept clips and the embedded ones differ"
    check_unit_embeddings(embs, VIDEO_EMBED_VARIANTS["video"][0].output_dim, "filters")
    for name in PIPELINE_KERNELS:
        assert f["launches"][name] > 0, f"filters: kernel {name} was not launched"
    wall = f["wall"]
    run = dict(
        videos=FILTER_VIDEOS, clips=n_clips, kept=len(kept), filtered_by_text=len(by_text),
        filtered_by_semantic=len(by_semantic),
        semantic_verdicts={str(v): sum(m["semantic_pass"] == v for m in metas.values()) for v in (True, False, None)},
        windows=len(windows), wall_s=wall, clips_per_s=n_clips / wall,
        stages={name: {**rec, "workers": runner.stage_counts[name]["workers"]} for name, rec in busy.items()},
        first_plan=runner.plans[0], last_plan=runner.plans[-1], replans=len(runner.plans),
        ocr_share_of_wall=busy["ArtificialTextFilterStage"]["busy_s"] / wall,
        owner_decode_tokens={o: v["decode_tokens"] for o, v in owners.items()},
        owner_requests={o: v["requests"] for o, v in owners.items()},
        semantic_tok_s=owners[sem_owner]["decode_tokens"] / busy["SemanticFilterStage"]["busy_s"],
        enhance_tok_s=next(v["decode_tokens"] for o, v in owners.items() if o.startswith("enhance-caption#"))
        / busy["EnhanceCaptionStage"]["busy_s"],
        launches=f["launches"], peak_device_memory_bytes=f["peak_device"], peak_host_rss_bytes=f["peak_rss"],
    )

    # the fan-out: run A's settings on the same videos, fanned out and not
    fan = fanout_run(dev, videos, root / "out_fanout", pinned=False)
    one = fanout_run(dev, videos, root / "out_pinned", pinned=True)
    transcode = "ClipTranscodingStage"
    assert fan["stages"][transcode]["workers"] > 1, fan["stages"][transcode]
    assert all(v["workers"] == 1 for v in one["stages"].values()), one["stages"]
    assert fan["stages"]["ClipEmbeddingStage"]["workers"] == 1, fan["stages"]
    fan_files = {str(p.relative_to(root / "out_fanout")) for p in (root / "out_fanout").rglob("*") if p.is_file()}
    one_files = {str(p.relative_to(root / "out_pinned")) for p in (root / "out_pinned").rglob("*") if p.is_file()}
    assert fan_files == one_files and fan["clips"] == one["clips"] == n_clips, "fan-out: the output sets differ"
    return dict(ocr=ocr, run=run, fanout={"fanned_out": fan, "one_worker_a_stage": one,
                                          "same_output_files": True, "files": len(fan_files)})


@contextlib.contextmanager
def recorded_transitions(probs: list):
    """Every TransNetV2 ``predict_transitions`` result of the duration
    appended to ``probs``."""
    from cosmos_curate_tpu_torch.models.transnetv2 import TransNetV2

    saved = TransNetV2.predict_transitions

    def predict(self, frames):
        p = saved(self, frames)
        probs.append(p)
        return p

    TransNetV2.predict_transitions = predict
    try:
        yield
    finally:
        TransNetV2.predict_transitions = saved


def drive_canonical(dev, timer, root: Path, corpus: list[Path]) -> dict:
    """Run C: the canonical split (TransNetV2 shot detection -> transcode ->
    frames -> aesthetic filter -> CLIP embeddings -> writer) through
    ``run_split`` on the split corpus, then the detector and the L/14 tower
    held against their plain versions."""
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.models.clip import CLIPImageEmbeddings
    from cosmos_curate_tpu_torch.models.transnetv2 import INPUT_H, INPUT_W, TransNet, TransNetV2, transition_windows
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention_plain
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage
    from cosmos_curate_tpu_torch.video.decode import decode_frames, extract_video_metadata
    from cosmos_curate_tpu_torch.video.splitter import scene_spans_from_predictions

    stage_classes = (split.VideoDownloadStage, split.TransNetV2ClipExtractionStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.AestheticFilterStage, split.ClipEmbeddingStage,
                     ClipWriterStage)
    corpus = corpus[:CANONICAL_VIDEOS]
    out = root / "out_canonical"
    args = split.SplitPipelineArgs(
        input_path=str(subset(root, corpus, "videos_canonical", len(corpus))), output_path=str(out),
        splitting_algorithm="transnetv2",
        transnetv2_threshold=CANONICAL_SHOT_THRESHOLD, min_clip_len_s=0.5, max_clip_len_s=CANONICAL_CLIP_LEN_S,
        extract_fps=(8.0,), extract_resize_hw=(224, 224), aesthetic_threshold=AESTHETIC_THRESHOLD,
        embedding_model="clip")
    runner = default_runner()
    probs: list = []
    with recorded_transitions(probs):
        c = split_run(dev, args, runner, stage_classes)
    summary = c["summary"]
    assert summary["num_videos"] == len(corpus) and summary["num_errors"] == 0, summary
    kept, embs, _ = split_outputs(out, "clip-vit-b16-tpu")
    filtered = {p.stem: json.loads(p.read_text()) for p in (out / "metas" / "filtered").glob("*.json")}
    scores = {u: m["aesthetic_score"] for u, m in {**kept, **filtered}.items()}
    ordered = sorted(scores.values())
    # no frame is a cut: each 4 s video is one scene, four 1 s clips
    assert summary["num_clips"] == len(scores) == len(corpus) * SPLIT_CLIPS // SPLIT_VIDEOS, (summary, len(scores))
    assert all(isinstance(v, float) and np.isfinite(v) for v in ordered), "a clip's meta has no aesthetic score"
    assert all(scores[u] >= AESTHETIC_THRESHOLD and not m["filtered_by"] for u, m in kept.items()), ordered
    assert all(scores[u] < AESTHETIC_THRESHOLD and m["filtered_by"] == "aesthetic" for u, m in filtered.items())
    assert summary["num_filtered_by_aesthetic"] == len(filtered), summary
    assert set(embs) == set(kept), "a kept clip has no CLIP embedding, or a filtered one has"
    check_unit_embeddings(embs, 512, "run C")
    assert c["launches"]["flash"] > 0, "run C: flash was not launched"
    flash_here = check_new_flash_shapes(timer, c["flash_shapes"], SEED + 8)

    # the detector's probabilities in the run, and what the default
    # threshold would have cut
    assert len(probs) == len(corpus), f"the detector ran {len(probs)} times"
    allp = np.concatenate(probs)
    assert allp.max() < CANONICAL_SHOT_THRESHOLD
    fps = extract_video_metadata(str(corpus[0])).fps
    scenes = sum(len(scene_spans_from_predictions(p, fps, threshold=0.4)) for p in probs)
    # bf16 detector (the stage's seeded init) vs the fp32 module on one
    # video's windows (cuDNN's TF32 off: the fp32 convolutions are fp32)
    detector = TransNetV2(device=dev)
    detector.setup()
    _, windows = transition_windows(decode_frames(str(corpus[0]), resize_hw=(INPUT_H, INPUT_W)))
    with torch.device(dev):
        ref = TransNet(detector.cfg, dtype=torch.float32)
    ref.load_state_dict(detector.model.state_dict())
    x = torch.from_numpy(windows).to(dev)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        det_err = (torch.sigmoid(detector.model(x)) - torch.sigmoid(ref(x))).abs().max().item()
    assert det_err <= TRANSNET_BOUND, f"detector: bf16 vs fp32 {det_err} > {TRANSNET_BOUND}"
    del ref, detector

    # the L/14 tower on every third frame of the first kept clips (32
    # frames) with the flash kernel, with its plain version, and with that
    # version short of a key tile
    tower = CLIPImageEmbeddings("clip-vit-l14-tpu", device=dev)
    tower.setup()
    frames = np.concatenate([decode_frames(str(out / "clips" / f"{u}.mp4"), stride=3, resize_hw=(224, 224))
                             for u in sorted(kept)[:CANONICAL_L14_CLIPS]])
    with_kernel = tower.encode_frames(frames)
    l14 = {}
    for label, attn in (("plain", flash_attention_plain), ("first_tile_dropped", tile_dropping_flash(True)),
                        ("last_tile_dropped", tile_dropping_flash(False))):
        with swapped_flash(attn):
            l14[label] = float(np.abs(tower.encode_frames(frames) - with_kernel).max())
    assert l14["plain"] <= EMBED_BOUND, f"L/14: kernel vs plain flash {l14['plain']} > {EMBED_BOUND}"
    # a lost 64-key first tile shows in the embeddings; the last tile holds
    # one key of 257, whose loss moves them less than the kernel's own
    # rounding does (PERF.md): the kernels phase's check at [32,16,257,64]
    # is the one that catches it (BOUND against the plain version)
    assert l14["first_tile_dropped"] > EMBED_BOUND, f"L/14: the bound misses a dropped first tile ({l14})"
    del tower
    result = dict(
        videos=len(corpus), wall_s=c["wall"], clips=summary["num_clips"], kept=len(kept),
        filtered=len(filtered), aesthetic_threshold=AESTHETIC_THRESHOLD, aesthetic_scores=ordered,
        clips_per_s=summary["num_clips"] / c["wall"],
        video_hours_per_day_per_chip=summary["video_hours_per_day_per_chip"],
        stages=stage_busy(c["spans"], c["wall"]), overlap_frac=runner.overlap_frac, launches=c["launches"],
        flash_shapes=[list(shape) for shape, _ in sorted(c["flash_shapes"])], flash_checked_here=flash_here,
        peak_device_memory_bytes=c["peak_device"], peak_host_rss_bytes=c["peak_rss"],
        detector={"shot_threshold": CANONICAL_SHOT_THRESHOLD, "frames": int(allp.size),
                  "prob_min": float(allp.min()), "prob_mean": float(allp.mean()), "prob_max": float(allp.max()),
                  "cut_frames_at_0.4": int((allp >= 0.4).sum()), "scenes_at_0.4": scenes,
                  "max_abs_err_bf16_vs_fp32": det_err, "bound": TRANSNET_BOUND, "windows_checked": len(windows)},
        l14_frames=len(frames), l14_max_abs_err_vs_plain_flash=l14["plain"], embed_bound=EMBED_BOUND,
        l14_max_abs_err_vs_plain_flash_with_a_tile_dropped={k: v for k, v in l14.items() if k != "plain"},
    )
    assert kept and filtered, f"the threshold {AESTHETIC_THRESHOLD} does not split the scores: {json.dumps(result)}"
    return result


def drive_iv2(dev) -> dict:
    """ClipEmbeddingStage(variant="iv2") at IV2_1B on a seeded state_dict
    with LayerScale drawn uniform 0.05-0.2 (numpy), over IV2_CALLS calls of
    EMBED_STAGE_TASK_BATCH tasks x 4 clips x 8 random 224^2 frames."""
    import cosmos_curate_tpu_torch.models.internvideo2 as iv2
    from cosmos_curate_tpu_torch.core.stage import WorkerMetadata
    from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature
    from cosmos_curate_tpu_torch.models.layers import ATTN_CHUNK_CLIPS
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    cfg = iv2.IV2_1B
    extraction = FrameExtractionSignature("fps", 8.0)
    key = extraction.key()

    # no params and no staged checkpoint: the stage refuses to serve noise
    bare = ClipEmbeddingStage(variant="iv2", extraction=extraction, device=dev)
    try:
        bare.setup(WorkerMetadata(stage_name="iv2"))
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise AssertionError("ClipEmbeddingStage(variant='iv2') set up without weights")
    assert bare.model.model is None

    t0 = time.monotonic()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.device(dev):
        ref = iv2.InternVideo2Tower(cfg, dtype=torch.float32)
    ref.init_weights(gen)
    rng = np.random.default_rng(SEED + 11)
    with torch.no_grad():
        for block in ref.blocks:
            for ls in (block.ls1, block.ls2):
                ls.copy_(torch.from_numpy(rng.uniform(0.05, 0.2, cfg.embed_dim).astype(np.float32)))
    ref.eval().requires_grad_(False)
    stage = ClipEmbeddingStage(variant="iv2", extraction=extraction, params=ref.state_dict(), device=dev)
    stage.setup(WorkerMetadata(stage_name="iv2"))
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    batches = [random_clip_tasks(rng, f"iv2-{c}", key, cfg.num_frames, cfg.img_size) for c in range(IV2_CALLS + 1)]
    stage.process_data(batches[0])  # warm-up
    torch.cuda.synchronize()

    pipeline = stage.model.device_pipeline
    pipeline.records.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    for tasks in batches[1:]:
        stage.process_data(tasks)
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    records = list(pipeline.records)
    clips = [c for tasks in batches[1:] for t in tasks for c in t.video.clips]
    check_unit_embeddings({str(c.uuid): c.embeddings[stage.model_name] for c in clips}, cfg.proj_dim, "iv2")

    # the attention's share of one call's device time: CUDA events around
    # every attention call, over the dispatch's compute interval
    spans = []
    plain_attention = iv2.chunked_attention

    def timed_attention(q, k, v, dtype, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_attention(q, k, v, dtype, **kw)
        end.record()
        spans.append((start, end))
        return out

    iv2.chunked_attention = timed_attention
    try:
        pipeline.records.clear()
        stage.process_data(batches[1])
        torch.cuda.synchronize()
    finally:
        iv2.chunked_attention = plain_attention
    attn_ms = sum(a.elapsed_time(b) for a, b in spans)
    call_compute_ms = 1e3 * sum(r.compute_s for r in pipeline.records)

    # bf16 stage embeddings vs the same module in fp32, on one 4-clip batch
    check = [c.extracted_frames[key] for c in batches[1][0].video.clips[:IV2_CHECK_CLIPS]]
    got = stage.model.encode_clips(check)
    with torch.inference_mode():
        want = ref(torch.from_numpy(np.stack(check)).to(dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    assert err <= IV2_BOUND, f"iv2: bf16 vs fp32 {err} > {IV2_BOUND}"
    n_disp = len(records)
    out = dict(
        config={"embed_dim": cfg.embed_dim, "depth": cfg.depth, "heads": cfg.num_heads, "head_dim": cfg.head_dim,
                "mlp_hidden": cfg.mlp_hidden, "num_frames": cfg.num_frames, "img_size": cfg.img_size,
                "tokens": cfg.num_patches + 1, "proj_dim": cfg.proj_dim,
                "attention_chunk_clips": ATTN_CHUNK_CLIPS},
        refusal_without_weights=refusal, setup_s=setup_s, stage_calls=IV2_CALLS, clips=len(clips),
        dispatches=n_disp, elapsed_s=elapsed, clips_per_s=len(clips) / elapsed,
        h2d_ms_per_dispatch=1e3 * sum(r.h2d_s for r in records) / n_disp,
        compute_ms_per_dispatch=1e3 * sum(r.compute_s for r in records) / n_disp,
        d2h_ms_per_dispatch=1e3 * sum(r.d2h_s for r in records) / n_disp,
        gap_ms_per_dispatch=1e3 * sum(r.gap_s for r in records) / n_disp,
        rows_per_dispatch=[r.rows for r in records], peak_memory_bytes=peak,
        attention_ms_per_call=attn_ms, compute_ms_per_call=call_compute_ms,
        attention_share_of_compute=attn_ms / call_compute_ms, attention_calls_per_call=len(spans),
        max_abs_err_bf16_vs_fp32=err, bound=IV2_BOUND, clips_checked=len(check),
    )
    del stage, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_qwen_kernels(timer, dev, flavors=QWEN_FLAVORS, suffix=QWEN_SUFFIX, seed=SEED + 9) -> dict:
    """Kernels 1-4 at the Qwen caption drives' shapes (bf16, each against
    its fp32 plain version within BOUND, the bit-equal pairs asserted): per
    flavor, its heads and its 1024-key lane of ``kv_lanes`` slots, a
    QWEN_PREFIX-token chat prefix and a ``suffix``-token suffix (the vision
    tokens and the prompt). Paged decode on that lane (and on the 4096-key
    lane of the flavors in QWEN_LONG_LANE), paged prefill as a 256-token
    chunk (a fresh row after the prefix, a second chunk) and as the whole
    batch's 512-token bucket, contiguous prefill as the prefix build (T = S
    = 64) and as the gather engine's bucket, contiguous decode on the
    lane."""
    from cosmos_curate_tpu_torch.models.vlm.model import vlm_flavor

    rng = np.random.default_rng(seed)
    pre, total = QWEN_PREFIX, QWEN_PREFIX + suffix
    out = {}
    for flavor in flavors:
        cfg = vlm_flavor(flavor).cfg
        heads = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
        lanes = dict(vlm_flavor(flavor).kv_lanes)
        b = lanes[1024]
        r = {"paged_decode": {}, "paged_prefill": {}, "prefill": {}, "decode": {}}
        for width, n in sorted(lanes.items())[: 2 if flavor in QWEN_LONG_LANE else 1]:
            kv = lane_lengths(rng, n, width - 1, low=total)
            r["paged_decode"][f"lane_{width}"] = check_paged(
                timer, rng, dev, f"{flavor} paged_decode lane_{width}", n, 1, kv - 1, kv, width // 16, heads,
                idle_row=True)
        r["paged_prefill"]["chunk_256"] = check_paged(
            timer, rng, dev, f"{flavor} paged_prefill chunk_256", 2, 256, np.array([pre, pre + 256]),
            np.array([pre + 256, pre + 512]), 64, heads)
        r["paged_prefill"]["bucket_512"] = check_paged(
            timer, rng, dev, f"{flavor} paged_prefill bucket_512", b, 512, np.full(b, pre), np.full(b, total), 64,
            heads)
        r["prefill"]["prefix_64"] = check_prefill(
            timer, rng, dev, f"{flavor} prefill prefix_64", 1, 64, 64, [0], [pre], heads)
        r["prefill"]["bucket_512"] = check_prefill(
            timer, rng, dev, f"{flavor} prefill bucket_512", b, 512, 1024, np.full(b, pre), np.full(b, total), heads)
        r["decode"]["lane_1024"] = check_decode(
            timer, rng, dev, f"{flavor} decode lane_1024", b, 1024, lane_lengths(rng, b, 1024, low=total), heads)
        out[flavor] = r
    return out


def write_byte_vocab(directory: Path) -> None:
    """A GPT-2-format tokenizer (vocab.json + merges.txt) of the 256 byte
    tokens at ids 0-255 and no merges: what a real checkpoint's staged files
    look like, at ids every config's embedding holds."""
    from cosmos_curate_tpu_torch.models.tokenizer import _gpt2_byte_encoder

    enc = _gpt2_byte_encoder()
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.json").write_text(json.dumps({enc[b]: b for b in range(256)}))
    (directory / "merges.txt").write_text("#version: 0.2\n")


def qwen_tokenizer(directory: Path):
    """The Qwen drives' tokenizer: the port's ``HFVocabTokenizer`` (Qwen2's
    special ids) over ``write_byte_vocab``'s files."""
    from cosmos_curate_tpu_torch.models.tokenizer import HFVocabTokenizer

    write_byte_vocab(directory)
    return HFVocabTokenizer.from_gpt2_files(directory / "vocab.json", directory / "merges.txt")


@contextlib.contextmanager
def counted_paged_prefill(shapes: collections.Counter):
    """Count the caption LM's paged prefill calls by (B, T) for the duration
    (one count a layer call). Launches are still counted only by the
    wrapper."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model

    saved = vlm_model.paged_attention

    def attn(q, pk, pv, tb, wi, kl, *, layer_index=0):
        if q.shape[1] > 1:
            shapes[(q.shape[0], q.shape[1])] += 1
        return saved(q, pk, pv, tb, wi, kl, layer_index=layer_index)

    vlm_model.paged_attention = attn
    try:
        yield
    finally:
        vlm_model.paged_attention = saved


def check_prefill_shapes(timer, flavor: str, shapes: collections.Counter, checks: dict,
                         suffix: int = QWEN_SUFFIX) -> dict:
    """A Qwen drive's paged prefill calls by (B, T), and paged prefill
    checked against its plain version and timed (``check_paged``) at every
    (B, T) of them that ``check_qwen_kernels`` did not check for
    ``flavor``: B fresh rows after the chat prefix, as far into the prompt
    as T reaches, on the 1024-key lane."""
    from cosmos_curate_tpu_torch.models.vlm.model import vlm_flavor

    cfg = vlm_flavor(flavor).cfg
    heads = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
    checked = {(c["shape"]["B"], c["shape"]["T"]) for c in checks[flavor]["paged_prefill"].values()}
    rng = np.random.default_rng(SEED + 10)
    pre = QWEN_PREFIX
    unchecked = {}
    for b, t in sorted(set(shapes) - checked):
        kv = np.full(b, pre + min(t, suffix))
        unchecked[f"{b}x{t}"] = check_paged(
            timer, rng, "cuda", f"{flavor} paged_prefill drive {b}x{t}", b, t, np.full(b, pre), kv,
            max(64, -(-(pre + t) // 16)), heads)
    return {
        "paged_prefill_calls_by_shape": {f"{b}x{t}": n // cfg.n_layers for (b, t), n in shapes.most_common()},
        "paged_prefill_checked_shapes": sorted(f"{b}x{t}" for b, t in checked),
        "paged_prefill_checked_here": unchecked,
    }


def check_tower(tower, dev, label: str) -> dict:
    """One 8-frame call of a Qwen vision tower: its bf16 output against the
    same weights in fp32 (max abs difference over the fp32 output's largest
    magnitude, asserted within QWEN_TOWER_BOUND; each deepstack level of a
    qwen3 tower too), the call's device time and its plain attention's
    share of it (CUDA events around each attention call and around the
    call)."""
    from cosmos_curate_tpu_torch.models.vlm import vision_qwen
    from cosmos_curate_tpu_torch.models.vlm.vision_qwen import QwenVisionTower, frames_to_patches

    cfg = tower.cfg
    rng = np.random.default_rng(SEED + 6)
    frames = torch.as_tensor(
        rng.integers(0, 256, (1, QWEN_FRAMES, cfg.image_size, cfg.image_size, 3), dtype=np.uint8), device=dev)
    with torch.device(dev):
        ref = QwenVisionTower(cfg, dtype=torch.float32)
    ref.load_state_dict(tower.state_dict())
    spans = []
    plain = vision_qwen.chunked_attention

    def timed(q, k, v, dtype, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o = plain(q, k, v, dtype, **kw)
        end.record()
        spans.append((start, end))
        return o

    with torch.inference_mode():
        patches, grid = frames_to_patches(frames, cfg)
        tower(patches, grid)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        vision_qwen.chunked_attention = timed
        try:
            start.record()
            got = tower(patches, grid)
            end.record()
        finally:
            vision_qwen.chunked_attention = plain
        want = ref(patches, grid)
    torch.cuda.synchronize()
    levels = {}
    if cfg.variant == "qwen3":
        (got, got_ds), (want, want_ds) = got, want
        assert got_ds.shape == (len(cfg.deepstack_indexes), *got.shape) and torch.isfinite(got_ds.float()).all()
        levels = {f"deepstack_{i}": ((g.float() - w).abs().max() / w.abs().max()).item()
                  for i, (g, w) in enumerate(zip(got_ds, want_ds))}
    rel = ((got.float() - want).abs().max() / want.abs().max()).item()
    assert torch.isfinite(got.float()).all() and got.shape == (1, cfg.tokens_out(QWEN_FRAMES), cfg.hidden_size)
    for name, err in {"merger": rel, **levels}.items():
        assert err <= QWEN_TOWER_BOUND, f"{label} tower {name}: bf16 vs fp32 {err} > {QWEN_TOWER_BOUND}"
    call_ms = start.elapsed_time(end)
    attn_ms = sum(a.elapsed_time(b) for a, b in spans)
    del ref
    return dict(
        variant=cfg.variant, grid=list(grid), tokens=int(np.prod(grid)), head_dim=cfg.head_dim,
        encode_ms=call_ms, attention_ms=attn_ms, attention_share=attn_ms / call_ms, attention_calls=len(spans),
        max_abs_err_over_max_abs=rel, bound=QWEN_TOWER_BOUND,
        **({"deepstack_max_abs_err_over_max_abs": levels} if levels else {}),
    )


def check_qwen_forward(model, dev, prefix: list, suffix: list) -> dict:
    """One request's prefill through the engine's bf16 model with its
    kernels (paged prefill over a shuffled pool) against the same module in
    fp32 with the plain attention (contiguous cache), on the same input
    embeddings: the chat prefix, QWEN_FRAMES frames' vision tokens and the
    suffix, under m-rope positions. Max abs logit difference asserted within
    QWEN_FORWARD_BOUND; the greedy agreement and the logits' scale
    reported."""
    from cosmos_curate_tpu_torch.models.vlm.model import VLM, build_mrope_positions, init_cache

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 5)
    size = cfg.qwen_vision.image_size
    frames = torch.as_tensor(rng.integers(0, 256, (1, QWEN_FRAMES, size, size, 3), dtype=np.uint8), device=dev)
    with torch.device(dev):
        ref = VLM(cfg, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    ref.eval()
    with torch.inference_mode():
        ids = [torch.as_tensor(x, dtype=torch.int32, device=dev) for x in (prefix, suffix)]
        embeds = torch.cat([model.embed_tokens(ids[0]), model.encode_images(frames)[0], model.embed_tokens(ids[1])])
        embeds = embeds[None].float()
    t = embeds.shape[1]
    rope, _ = build_mrope_positions(len(prefix), cfg.qwen_vision.merged_grid(QWEN_FRAMES), len(suffix))
    pos = torch.as_tensor(rope, device=dev)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    bs = 16
    nbl = -(-t // bs)
    tables = torch.as_tensor(rng.permutation(np.arange(1, nbl + 1))[None].astype(np.int32), device=dev)
    shape = (cfg.n_layers, nbl + 1, bs, cfg.n_kv_heads, cfg.head_dim)
    pk = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    pv = torch.zeros_like(pk)
    with torch.inference_mode():
        got, _, _ = model.paged_forward(embeds, pk, pv, pos, zero, zero + t, tables)
        ck, cv = init_cache(cfg, 1, dtype=torch.float32, length=t, device=dev)
        with plain_attention():
            want, _, _ = ref(embeds, ck, cv, pos, zero, zero + t)
    got = got.float()
    torch.cuda.synchronize()
    assert got.shape == (1, t, cfg.vocab) and torch.isfinite(got).all(), "qwen forward: logits"
    err = (got - want).abs().max().item()
    out = dict(
        tokens=t, max_abs_logit_diff=err, bound=QWEN_FORWARD_BOUND,
        fp32_logit_max_abs=want.abs().max().item(), fp32_logit_std=want.std().item(),
        greedy_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item(),
    )
    del ref, ck, cv, want
    gc.collect()
    torch.cuda.empty_cache()
    assert err <= QWEN_FORWARD_BOUND, f"qwen forward: {err} > {QWEN_FORWARD_BOUND}"
    return out


def release_memory() -> None:
    """Free what the dropped references held, on the host and the card."""
    gc.collect()
    torch.cuda.empty_cache()


def drive_qwen(dev, timer, root: Path, checks: dict) -> dict:
    """The dense Qwen-VL caption flavors on the card, seeded weights.

    ``CaptionEngine(VLM_QWEN2_2B)`` at full width and depth on the
    flavor's KV lanes: QWEN_REQUESTS chat requests (``build_qwen_vl_chat``
    around the default caption prompt; QWEN_FRAMES random 224^2 frames:
    4 temporal patches, 1024 tower tokens, 256 vision tokens),
    QWEN_NEW_TOKENS greedy tokens, paged and then gather, each with the profiled decode window,
    the measured requests' paged prefill calls counted by (B, T) and each
    (B, T) that ``checks`` (``check_qwen_kernels``) lacks checked on the
    spot; the two engines' agreement reported;
    the prefill forward against fp32 and the 2B tower against fp32. Then
    ``VLM_QWEN25_7B`` at full width and depth serves QWEN_7B_REQUESTS
    requests at QWEN_FPS (Qwen2.5-VL's time-scaled m-rope), and its
    windowed tower is checked against fp32; its prefill shapes are
    counted and checked the same way."""
    from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
    from cosmos_curate_tpu_torch.models.vlm.chat import build_qwen_vl_chat
    from cosmos_curate_tpu_torch.models.vlm.model import VLM_QWEN2_2B, VLM_QWEN25_7B, vlm_flavor

    tok = qwen_tokenizer(root / "byte-vocab")
    prefix, suffix = build_qwen_vl_chat(tok, get_caption_prompt("default"))
    assert (len(prefix), len(suffix)) == (QWEN_PREFIX, QWEN_SUFFIX - VLM_QWEN2_2B.qwen_vision.tokens_out(QWEN_FRAMES))
    prompts = [(prefix, suffix)]
    out = {"tokenizer": type(tok).__name__, "prompt": {"prefix": len(prefix), "suffix_text": len(suffix)}}

    def full(engine):
        return lambda: len(engine.slots) >= QWEN_REQUESTS

    lanes = vlm_flavor("qwen2vl-2b").kv_lanes
    tokens = {}
    for mode, focus in (("auto", "PagedKV"), ("gather", "ContiguousKV")):
        shapes = collections.Counter()
        record, engine, make_request, _, greedy = drive_slice(
            dev, VLM_QWEN2_2B, mode, lanes, tokenizer=tok, prompts=prompts, n_frames=QWEN_FRAMES,
            n_requests=QWEN_REQUESTS, keep_logits=False, during=lambda s=shapes: counted_paged_prefill(s),
            new_tokens=QWEN_NEW_TOKENS)
        # seeded weights choose ids past the byte vocabulary, which decode to
        # nothing: compare the engines' token ids
        tokens[mode] = {rid: [steps[k][0] for k in sorted(steps)] for rid, steps in greedy.items()}
        record.update(check_prefill_shapes(timer, "qwen2vl-2b", shapes, checks))
        record["breakdown"] = profile_decode(engine, make_request, focus, full=full(engine))
        if mode == "auto":
            record["forward"] = check_qwen_forward(engine.model, dev, prefix, suffix)
            record["tower"] = check_tower(engine.model.vision, dev, "qwen2vl-2b")
        out[mode] = record
        engine.shutdown()
        del engine, make_request
        release_memory()
    out["gather"]["token_agreement_with_paged"] = agreement(tokens["auto"], tokens["gather"])
    for name in ("paged_decode", "paged_prefill", "prefill"):
        assert out["auto"]["launches"][name] > 0, f"qwen: {name} was not launched on the paged drive"
    for name in ("decode", "prefill"):
        assert out["gather"]["launches"][name] > 0, f"qwen: {name} was not launched on the gather drive"
    for name in ("paged_decode", "paged_prefill"):
        assert out["gather"]["launches"][name] == 0, f"qwen: the gather engine launched {name}"

    shapes = collections.Counter()
    record, engine, _, _, _ = drive_slice(
        dev, VLM_QWEN25_7B, "auto", vlm_flavor("qwen25vl-7b").kv_lanes, tokenizer=tok, prompts=prompts,
        n_frames=QWEN_FRAMES, frame_fps=QWEN_FPS, n_requests=QWEN_7B_REQUESTS,
        during=lambda: counted_paged_prefill(shapes), new_tokens=QWEN_NEW_TOKENS)
    record.update(check_prefill_shapes(timer, "qwen25vl-7b", shapes, checks))
    for name in ("paged_decode", "paged_prefill", "prefill"):
        assert record["launches"][name] > 0, f"qwen 7b: {name} was not launched"
    record["tower"] = check_tower(engine.model.vision, dev, "qwen25vl-7b")
    out["qwen25vl_7b"] = record
    engine.shutdown()
    del engine
    release_memory()
    return out


@contextlib.contextmanager
def logged_routes(log: list):
    """Every MoE call's (B, T, dropped assignments) appended to ``log`` for
    the duration."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model

    saved = vlm_model.moe_forward

    def forward(moe, x, router, gate_up, down, dtype, route_log=None):
        return saved(moe, x, router, gate_up, down, dtype, log)

    vlm_model.moe_forward = forward
    try:
        yield
    finally:
        vlm_model.moe_forward = saved


def drop_shares(log: list, top_k: int) -> dict:
    """Dropped over routed assignments of the logged MoE calls, prefill
    (T > 1) and decode (T = 1) apart."""
    out = {}
    for kind, calls in (("prefill", [c for c in log if c[1] > 1]), ("decode", [c for c in log if c[1] == 1])):
        routed = sum(b * t * top_k for b, t, _ in calls)
        dropped = sum(int(d) for _, _, d in calls)
        out[kind] = {"calls": len(calls), "routed": routed, "dropped": dropped, "share": dropped / max(1, routed)}
    return out


def moe_share(engine, steps: int = QWEN3_MOE_STEPS) -> dict:
    """``steps`` engine steps under torch.profiler (host and device), every
    MoE call inside a ``moe_forward`` range: the MoE's device milliseconds
    a step, the kernels launched inside its calls (this trace's busy time
    is not comparable: with the host traced too it reads ~2.5x the
    device-only window's)."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = vlm_model.moe_forward

    def ranged(*args, **kw):
        with record_function("moe_forward"):
            return saved(*args, **kw)

    vlm_model.moe_forward = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
    finally:
        vlm_model.moe_forward = saved
    moe = next(e for e in prof.key_averages() if e.key == "moe_forward")
    assert moe.device_time_total > 0, "the profiler traced no MoE device time"
    return {"moe": {"steps": steps, "calls_per_step": moe.count / steps,
                    "device_ms_per_step": moe.device_time_total / 1e3 / steps}}


def check_qwen3_layer(model, dev, prefix: list, suffix: list) -> dict:
    """Layer 0 of the served model at full width (attention and the MoE in
    bf16, the paged prefill kernel over a shuffled pool) against the same
    layer in fp32 (2.4 GB; the whole model would be 116 GB) with the plain
    attention on a contiguous cache, on one request's prefill input (the
    chat prefix, QWEN_FRAMES frames' vision tokens, the suffix) at its m-rope
    positions: the max abs difference of the layer's update (output -
    input) over the fp32 update's largest magnitude, asserted within
    QWEN3_LAYER_BOUND; both sides' dropped assignments reported."""
    from cosmos_curate_tpu_torch.models.vlm.model import DecoderLayer, build_mrope_positions

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 12)
    size = cfg.qwen_vision.image_size
    frames = torch.as_tensor(rng.integers(0, 256, (1, QWEN_FRAMES, size, size, 3), dtype=np.uint8), device=dev)
    layer = model.layers[0]
    with torch.device(dev):
        ref = DecoderLayer(cfg, dtype=torch.float32)
    ref.load_state_dict(layer.state_dict())
    with torch.inference_mode():
        ids = [torch.as_tensor(x, dtype=torch.int32, device=dev) for x in (prefix, suffix)]
        vis, _ = model.encode_images(frames)
        x = torch.cat([model.embed_tokens(ids[0]), vis[0], model.embed_tokens(ids[1])])[None]
    t = x.shape[1]
    rope, _ = build_mrope_positions(len(prefix), cfg.qwen_vision.merged_grid(QWEN_FRAMES), len(suffix))
    pos = torch.as_tensor(rope, device=dev)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    bs = 16
    nbl = -(-t // bs)
    tables = torch.as_tensor(rng.permutation(np.arange(1, nbl + 1))[None].astype(np.int32), device=dev)
    pk = torch.zeros((1, nbl + 1, bs, cfg.n_kv_heads, cfg.head_dim), dtype=torch.bfloat16, device=dev)
    pv = torch.zeros_like(pk)
    got_log, want_log = [], []
    with torch.inference_mode():
        with logged_routes(got_log):
            got = layer(x, pk, pv, pos, zero, zero + t, block_tables=tables, layer_index=0)
        ck = torch.zeros((1, t, cfg.n_kv_heads, cfg.head_dim), device=dev)
        cv = torch.zeros_like(ck)
        with plain_attention(), logged_routes(want_log):
            want = ref(x.float(), ck, cv, pos, zero, zero + t)
    torch.cuda.synchronize()
    assert got.shape == (1, t, cfg.dim) and torch.isfinite(got.float()).all(), "qwen3 layer: output"
    update = want - x.float()
    rel = ((got.float() - x.float() - update).abs().max() / update.abs().max()).item()
    out = dict(
        tokens=t, max_abs_err_over_max_abs=rel, bound=QWEN3_LAYER_BOUND,
        fp32_update_max_abs=update.abs().max().item(), input_max_abs=x.float().abs().max().item(),
        dropped_bf16=int(got_log[0][2]), dropped_fp32=int(want_log[0][2]),
        routed=t * cfg.moe.top_k,
    )
    del ref, ck, cv, want, update
    release_memory()
    assert rel <= QWEN3_LAYER_BOUND, f"qwen3 layer: {rel} > {QWEN3_LAYER_BOUND}"
    return out


def drive_qwen3(dev, timer, root: Path, checks: dict) -> dict:
    """Qwen3-VL-30B-A3B on the card at full width and depth, seeded
    weights, experts in bf16: ``CaptionEngine(VLM_QWEN3_VL_MOE_A3B)`` on the
    flavor's KV lanes serves QWEN3_REQUESTS chat requests of QWEN_FRAMES
    frames at QWEN_FPS and one text-only request (prep at admission: the
    four rows share one 512-token prefill bucket), QWEN3_NEW_TOKENS greedy
    tokens each,
    paged and then gather. Each drive: tok/s, ms a decode step, device
    peak, each kernel's launches (asserted). The paged drive also: its
    paged prefill calls by (B, T) (each one ``checks`` lacks is checked on
    the spot), the profiled decode window with both lanes decoding (idle
    share, launches a step) and the MoE's share of its device time
    (``moe_share``), layer 0 against fp32 (``check_qwen3_layer``) and the
    tower against fp32 (``check_tower``). The gather drive logs every MoE
    call: dropped over routed assignments in prefill and in decode. The
    two drives' token agreement is reported."""
    from cosmos_curate_tpu_torch.models.batching import next_pow2
    from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
    from cosmos_curate_tpu_torch.models.vlm.chat import build_qwen_vl_chat
    from cosmos_curate_tpu_torch.models.vlm.model import VLM_QWEN3_VL_MOE_A3B, vlm_flavor

    cfg = VLM_QWEN3_VL_MOE_A3B
    tok = qwen_tokenizer(root / "byte-vocab")
    prompt = get_caption_prompt("default")
    prefix, suffix = build_qwen_vl_chat(tok, prompt)
    t_prefix, t_suffix = build_qwen_vl_chat(tok, prompt + QWEN3_TRANSCRIPT, has_vision=False)
    n_vis = cfg.qwen_vision.tokens_out(QWEN_FRAMES)
    assert (len(prefix), len(suffix) + n_vis) == (QWEN_PREFIX, QWEN3_SUFFIX)
    assert next_pow2(len(t_suffix)) == next_pow2(QWEN3_SUFFIX), "the text-only request must share the bucket"
    prompts = [(prefix, suffix)] * QWEN3_REQUESTS + [(t_prefix, t_suffix, False)]
    out = {"tokenizer": type(tok).__name__, "vision_tokens": n_vis,
           "prompt": {"prefix": len(prefix), "suffix_text": len(suffix), "text_only": [len(t_prefix), len(t_suffix)]}}
    lanes = vlm_flavor(QWEN3_FLAVOR).kv_lanes
    tokens = {}
    for mode, focus in (("auto", "PagedKV"), ("gather", "ContiguousKV")):
        shapes, routes = collections.Counter(), []
        during = (lambda: counted_paged_prefill(shapes)) if mode == "auto" else (lambda: logged_routes(routes))
        record, engine, make_request, _, greedy = drive_slice(
            dev, cfg, mode, lanes, tokenizer=tok, prompts=prompts, n_frames=QWEN_FRAMES, frame_fps=QWEN_FPS,
            n_requests=len(prompts), keep_logits=False, during=during, async_prep=False,
            new_tokens=QWEN3_NEW_TOKENS)
        tokens[mode] = {rid: [steps[k][0] for k in sorted(steps)] for rid, steps in greedy.items()}
        record["parameter_bytes"] = sum(p.numel() * p.element_size() for p in engine.model.parameters())
        record["expert_bytes"] = sum(
            p.numel() * p.element_size() for n, p in engine.model.named_parameters() if ".moe." in n)
        if mode == "auto":
            record.update(check_prefill_shapes(timer, QWEN3_FLAVOR, shapes, checks, QWEN3_SUFFIX))
            record["breakdown"] = breakdown = profile_decode(
                engine, make_request, focus, steps=QWEN3_PROFILE_STEPS, after=moe_share)
            # both windows decode the same two lanes; the share is over the
            # device-only window's busy time
            breakdown["moe"]["share_of_device_busy"] = (
                breakdown["moe"]["device_ms_per_step"] / breakdown["device_busy_ms_per_step"])
            record["layer"] = check_qwen3_layer(engine.model, dev, prefix, suffix)
            record["tower"] = check_tower(engine.model.vision, dev, QWEN3_FLAVOR)
        else:
            record["drops"] = drop_shares(routes, cfg.moe.top_k)
        out[mode] = record
        engine.shutdown()
        del engine, make_request
        release_memory()
    out["gather"]["token_agreement_with_paged"] = agreement(tokens["auto"], tokens["gather"])
    for name in ("paged_decode", "paged_prefill", "prefill"):
        assert out["auto"]["launches"][name] > 0, f"qwen3: {name} was not launched on the paged drive"
    for name in ("decode", "prefill"):
        assert out["gather"]["launches"][name] > 0, f"qwen3: {name} was not launched on the gather drive"
    for name in ("paged_decode", "paged_prefill"):
        assert out["gather"]["launches"][name] == 0, f"qwen3: the gather engine launched {name}"
    return out


@contextlib.contextmanager
def staged_weights(root: Path):
    """``CURATE_MODEL_WEIGHTS_DIR`` at ``root`` for the duration."""
    from cosmos_curate_tpu_torch.models.registry import WEIGHTS_DIR_ENV

    saved = os.environ.get(WEIGHTS_DIR_ENV)
    os.environ[WEIGHTS_DIR_ENV] = str(root)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(WEIGHTS_DIR_ENV)
        else:
            os.environ[WEIGHTS_DIR_ENV] = saved


def drive_qwen_stage(dev, root: Path) -> dict:
    """The Qwen flavors through the caption stage on the card:
    ``qwen2vl-2b`` refuses to set up without staged tokenizer files, and
    with them but without weights; ``qwen-chat-tiny-test`` (its tokenizer
    files staged, seeded weights) captions QWEN_STAGE_TASKS tasks of 2
    one-window clips x 8 random 224^2 frames through ``run_pipeline``
    (caption prep -> caption, the default runner)."""
    from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
    from cosmos_curate_tpu_torch.data.model import Clip, FrameExtractionSignature, SplitPipeTask, Video, VideoMetadata
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionPrepStage, CaptionStage

    weights = root / "weights"
    out = {}
    with staged_weights(weights):
        refusals = {}
        for staged in ("nothing", "tokenizer"):
            if staged == "tokenizer":
                write_byte_vocab(weights / "caption-qwen2vl-2b-tpu")
            try:
                CaptionStage(model_flavor="qwen2vl-2b", device=dev).setup(None)
            except (FileNotFoundError, RuntimeError) as e:
                refusals[staged] = f"{type(e).__name__}: {e}"
            else:
                raise AssertionError(f"qwen2vl-2b set up with {staged} staged")
        want = {"nothing": "FileNotFoundError", "tokenizer": "RuntimeError"}
        for staged, kind in want.items():
            assert refusals[staged].startswith(kind), f"qwen2vl-2b with {staged} staged: {refusals[staged]}"
        out["qwen2vl_2b_refusals"] = refusals
        write_byte_vocab(weights / "caption-vlm-tpu")
        sig = FrameExtractionSignature("fps", 8.0)
        rng = np.random.default_rng(SEED + 7)
        tasks = [
            SplitPipeTask(video=Video(
                path=f"qwen-{t}.mp4",
                metadata=VideoMetadata(width=224, height=224, fps=30.0, num_frames=60, duration_s=2.0),
                clips=[Clip(source_video=f"qwen-{t}", span=(float(i), float(i + 1)),
                            extracted_frames={sig.key(): rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)})
                       for i in range(2)],
            ))
            for t in range(QWEN_STAGE_TASKS)
        ]
        ks = kernels()
        for k in ks.values():
            k.launches = 0
        # 32 new tokens: the byte-level chat prompt (~170 ids with the vision
        # block) and the stage's default 128 would overrun the flavor's 256
        stage = CaptionStage(model_flavor="qwen-chat-tiny-test", max_new_tokens=32, device=dev)
        t0 = time.monotonic()
        done = run_pipeline(tasks, [CaptionPrepStage(extraction=sig), stage])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        windows = [w for t in done for c in t.video.clips for w in c.windows]
        # seeded weights may choose only ids the byte vocabulary decodes to
        # nothing: every window must hold a caption entry and tokens decoded
        decoded = sum(t.stage_perf["caption_decode_tokens"] for t in done)
        assert len(windows) == 2 * QWEN_STAGE_TASKS and all("default" in w.caption for w in windows), (
            "qwen-chat-tiny-test: a window has no caption")
        assert decoded > 0, "qwen-chat-tiny-test: no tokens decoded"
        out["qwen_chat_tiny_test"] = dict(
            windows_captioned=len(windows), non_empty_captions=sum(bool(w.caption["default"]) for w in windows),
            decode_tokens=decoded, wall_s=wall, tokenizer=type(stage.model.tokenizer).__name__,
            eos_id=stage.model.tokenizer.eos_id, prompt_tokens=[len(x) for x in stage._encoded_prompt],
            launches={name: k.launches for name, k in ks.items()},
        )
        for name in ("paged_decode", "paged_prefill", "prefill"):
            assert ks[name].launches > 0, f"qwen-chat-tiny-test: {name} was not launched"
        SharedCaptionEngine.reset()
    return out


def phase_prologue(dev) -> tuple:
    """What ``scripts/*_phase.py`` run before their phases: every kernel
    built, the card line printed, flash checked and timed at
    ``FLASH_CASES`` (a ``flash`` line). Returns (timer, build seconds)."""
    from cosmos_curate_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    print(card_line(), flush=True)
    timer = Timer(dev)
    bf16 = random_bf16(np.random.default_rng(SEED), dev)
    flash = {label: check_flash(timer, bf16, shape, causal, label) for label, shape, causal in FLASH_CASES}
    emit({"phase": "flash", "bound": BOUND, "cases": flash})
    return timer, build_s


def main() -> int:
    with contextlib.ExitStack() as stack:
        return _main(stack)


def _main(stack: contextlib.ExitStack) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU", file=sys.stderr)
        return 1
    # the port first: without the repository around it the script fails here,
    # before printing anything
    from cosmos_curate_tpu_torch.models.vlm import VLM_BASE
    from cosmos_curate_tpu_torch.ops import _build, kernels

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import curate_phase
    import image_phase
    import index_phase
    import engine_phase
    import av_phase
    import legs_phase
    import multinode_phase
    import observe_phase
    import remote_phase
    import sensors_phase
    import convert_phase
    import service_phase
    import train_phase

    started = time.monotonic()
    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "modules": optional_modules()})
    # the split corpus is written on the host's other cores while the
    # kernels build and the kernel phases time device work; the host-bound
    # phases from embed on start once it is done
    corpus_ready = stack.enter_context(corpus_in_background())

    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0, "sass": sass_counts()})

    timer = Timer(dev)
    emit({"phase": "card_state", "at": "before kernels", **gpu_state()})
    checks = check_kernels(timer, dev)
    emit({"phase": "card_state", "at": "after kernels", **gpu_state()})
    emit({"phase": "kernels", "bound": BOUND, "results": checks,
          "library": "scaled_dot_product_attention: on K/V already gathered to contiguous "
                     "[B, Hkv, S, D] with a boolean mask for the cache kernels (the gather is "
                     "not timed), on the same [B, H, S, D] q/k/v for flash"})
    qwen_checks = check_qwen_kernels(timer, dev)
    emit({"phase": "qwen_kernels", "bound": BOUND, "results": qwen_checks})
    root, corpus, corpus_s, corpus_wait_s = corpus_ready()
    emit({"phase": "corpus", "videos": len(corpus), "build_s": corpus_s, "waited_s": corpus_wait_s})

    embed = drive_embed(dev)
    emit({"phase": "embed", **embed})
    for label, err in embed["max_abs_err_vs_plain_flash_with_a_tile_dropped"].items():
        assert err > EMBED_BOUND, f"embed: the bound {EMBED_BOUND} does not catch {label} ({err})"

    record, engine, make_request, paged_texts, paged_greedy = drive_slice(dev, VLM_BASE)
    emit({"phase": "slice", **record})

    emit({"phase": "breakdown", **profile_decode(engine, make_request, "PagedKV")})
    engine.shutdown()

    forward = check_forward(engine.model, dev)
    emit({"phase": "forward", "max_abs_logit_diff": forward, "bound": FORWARD_BOUND})
    del engine

    gather, gather_engine, gather_request, gather_texts, gather_greedy = drive_slice(
        dev, VLM_BASE, paged_attention="gather")
    # the same seeded weights and requests; the two engines' prefill
    # kernels share one tensor-core body and their decode kernels one split
    # body, each pair bit-equal on the same K/V (the kernels phase asserts
    # both), but async prep packs each drive's chunks by host timing, so
    # agreement is reported, not asserted; the witness phase explains each
    # request that differs
    emit({"phase": "gather", **gather,
          "paged": {k: record[k] for k in ("end_to_end_tok_s", "decode_tok_s", "decode_ms_per_step")},
          "agreement_with_paged": agreement(paged_texts, gather_texts)})
    emit({"phase": "gather_breakdown", **profile_decode(gather_engine, gather_request, "ContiguousKV")})
    gather_engine.shutdown()
    del gather_engine
    for name in ("paged_decode", "paged_prefill"):
        assert gather["launches"][name] == 0, f"the gather engine launched {name}"
    witness = witness_prefill(dev, VLM_BASE, paged_greedy, gather_greedy, timer)
    drive_prefill = witness.pop("paged_prefill_at_drive_shape")
    emit({"phase": "witness", **witness})
    emit({"phase": "paged_prefill_at_drive_shape", **drive_prefill})
    checks["paged_prefill"]["cases"] = {"chunk_256": dict(checks["paged_prefill"]), "drive_mode": drive_prefill}

    pipeline = drive_pipeline(dev)
    emit({"phase": "pipeline", **pipeline})
    for name in PIPELINE_KERNELS:
        assert pipeline["launches"][name] > 0, f"kernel {name} was not launched on the pipeline path"

    split_run = drive_split(dev, timer, root, corpus, corpus_s)
    emit({"phase": "split", **split_run})
    # traced run B, the traced sequential run over OTLP, stall detection
    observe = observe_phase.run(sys.modules[__name__], dev, timer, root, corpus, split_run)
    checks["flash"]["cases"].update(observe["flash_checked_here"])
    # stage save / replay / profiling, the streaming engine and the map runner, report / top / dlq
    engine_run = engine_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    checks["flash"]["cases"].update(engine_run["flash_checked_here"])
    canonical = drive_canonical(dev, timer, root, corpus)
    emit({"phase": "canonical", **canonical})
    filters = drive_filters(dev, root, corpus)
    emit({"phase": "filters", **filters})
    # flash_causal, t5, clip_text, split_extras (run D), dedup_shard
    curate = curate_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    # index (the corpus index, its server and compaction), index_split (run E)
    index = index_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    # motion, tracking, sr, legs_split (run F)
    legs = legs_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    checks["flash"]["cases"].update(curate["flash_causal"])
    checks["flash"]["cases"].update(index["index"]["server"]["flash_checked_here"])
    checks["flash"]["cases"].update(legs["legs_split"]["flash_checked_here"])
    # image (runs I1-I4 and the video embedder on stills), cli
    image = image_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    checks["flash"]["cases"].update(image["image"]["flash_checked_here"])
    # remote storage: s3:// -> az:// with the checkpoint pulled from s3://, dedup and shard to gs://
    remote = remote_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    checks["flash"]["cases"].update(remote["flash_checked_here"])
    # multi-node runs: the partition and work stealing in two node processes,
    # the cross-node plane with a loopback agent, node loss
    multinode = multinode_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    checks["flash"]["cases"].update(multinode["flash_checked_here"])
    # multicam sessions: the multicam split, the AV steps through `local av`, postgres
    av = av_phase.run(sys.modules[__name__], dev, timer, root, corpus)
    checks["flash"]["cases"].update(av["flash_checked_here"])
    # the job service: a job through HTTP, a killed service resumed, search
    service = service_phase.run(sys.modules[__name__], dev, timer, root, corpus, split_run["run_b"]["wall_s"])
    checks["flash"]["cases"].update(service["flash_checked_here"])
    # sensor rigs: MCAP capture, the two sources, the lockstep group, the lance fallback
    sensors = sensors_phase.run(sys.modules[__name__], dev, root, corpus)
    # training: the five trainers on the card, a checkpoint each, no kernel launched
    train = train_phase.run(sys.modules[__name__], dev)
    # HF checkpoints converted, staged and served: CLIP L/14 + the aesthetic head, CLIP text L, T5,
    # Qwen2-VL-2B through the caption stage, Qwen3-VL-30B-A3B and InternVideo2 at cut depth; lint
    convert = convert_phase.run(sys.modules[__name__], dev)
    emit({"phase": "iv2", **drive_iv2(dev)})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_qwen-") as tmp:
        qwen = drive_qwen(dev, timer, Path(tmp), qwen_checks)
        qwen_7b = qwen.pop("qwen25vl_7b")
        emit({"phase": "qwen", **qwen})
        emit({"phase": "qwen_7b", **qwen_7b})
        emit({"phase": "qwen_stage", **drive_qwen_stage(dev, Path(tmp))})
    release_memory()
    qwen3_checks = check_qwen_kernels(timer, dev, (QWEN3_FLAVOR,), QWEN3_SUFFIX, SEED + 11)
    emit({"phase": "qwen3_kernels", "bound": BOUND, "results": qwen3_checks})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_qwen3-") as tmp:
        qwen3 = drive_qwen3(dev, timer, Path(tmp), qwen3_checks)
    emit({"phase": "qwen3", **qwen3})

    launches = {"embed": embed["launches"], "slice": record["launches"], "gather": gather["launches"]}
    for path, counts in launches.items():
        for name, n in counts.items():
            if KERNEL_PATH[name] == path or (path == "gather" and name == "prefill"):
                assert n > 0, f"kernel {name} was not launched on the {path} path"

    rows = []
    for name in kernels():
        c = checks[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[KERNEL_PATH[name]][name], max_abs_err=c["max_abs_err"], ms=c["kernel_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], bound_share=c["bound_share"], vs_library=c["vs_library"],
            pipeline_launches=pipeline["launches"][name], split_launches=split_run["split_launches"][name],
            observe_launches=observe["launches"][name],
            engine_launches=engine_run["launches"][name],
            canonical_launches=canonical["launches"][name],
            filters_launches=filters["run"]["launches"][name],
            qwen_launches=qwen["gather" if name == "decode" else "auto"]["launches"][name],
            qwen_7b_launches=qwen_7b["launches"][name],
            qwen=qwen_checks["qwen2vl-2b"].get(name),
            qwen3_launches=qwen3["gather" if name == "decode" else "auto"]["launches"][name],
            qwen3=qwen3_checks[QWEN3_FLAVOR].get(name),
            split_extras_launches=curate["split_extras"]["launches"][name],
            clip_text_launches=curate["clip_text"]["launches"][name],
            index_server_launches=index["index"]["server"]["launches"][name],
            index_split_launches=sum(index["index_split"][run]["launches"][name] for run in ("first", "second")),
            legs_launches=legs["legs_split"]["launches"][name],
            legs_sr_launches=legs["legs_split"]["sr"]["launches"][name],
            image_launches={run: image["image"][run]["launches"][name] for run in ("i1", "i2", "i3", "i4")}
            | {"video_on_stills": image["image"]["video_on_stills"]["launches"][name]},
            cli_launches=sum(c["launches"][name] for c in image["cli"]["commands"].values()),
            remote_launches=remote["launches"][name],
            multinode_launches=multinode["launches"][name],
            av_launches={"caption": av["caption"]["launches"][name],
                         "multicam_split": av["multicam"]["launches"][name]},
            service_launches={part: service["launches"][part][name] for part in ("job", "search")},
            sensors_launches=sensors["launches"][name],
            train_launches=train["launches"][name],
            convert_launches=convert["launches"][name],
            cases=c.get("cases"),
        ))
    # each phase line's seconds from the start: where the call's time went
    emit({"phase": "timing", "script_s": time.monotonic() - started,
          "lines_at_s": [[phase, t - started] for phase, t in EMITTED_AT]})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
