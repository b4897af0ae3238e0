"""On-card smoke test of the PyTorch/CUDA port (``videop2p_tpu_torch``).

Phases, each of which must pass (any failure exits non-zero):

1. probe the device (``torch.cuda.is_available()``) and print the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``videop2p_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all in parallel) and print each kernel's registers, static
   shared memory and spills from the ``ptxas`` report, and the float32
   forward kernels' keys per tile, ring stages and dynamic shared memory
   at each padded head dim;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of every main path (the live edit's batch B = 3, the cached
   edit's 2 and its capture's 1, the full-CFG edit's 4, null-text's 1;
   GroupNorm at the same slabs), at head dims 64 and 128, and at lengths
   that are not multiples of the bf16 kernels' query or key tiles, in
   float32 and bfloat16 — frame attention, GroupNorm, and both wrappers of
   the flash kernel, with the flash forward's per-row residuals m and l
   through each wrapper's views (relative: float32 1e-5, bfloat16 1e-4) —
   and time the kernel, the plain version and one PyTorch library call
   computing the same function (each over windows of at least 20 ms, the
   median of 3; kernel and library call in turns) at the live edit's
   batch, and in float32 null-text's; a float32 forward row also prints
   the 3×TF32 bound it runs against beside the CUDA-core one, and its prep
   and attention kernels' times (torch.profiler); GroupNorm (``GN_SHAPES``)
   also at a slab whose mean is 8 std, a row that is not a whole number of
   16-byte vectors and an x off 16-byte alignment, one launch a call and a
   repeat that gives the same bits, timed in turns with F.group_norm +
   F.silu at each site class PERF.md's table lists, beside its byte bound
   and the floor HBM traffic sets where x does not fit on chip;
   that a bf16 q view the TMA path cannot read (a head-dim stride other
   than 1, a base address off 16 bytes) raises and launches nothing; that
   "auto" at head dim 160 (N 1024) runs the chunked version, as JAX's
   dispatch does above 128, and launches no fused kernel;
3b. the flash backward (the forward with its residuals, then the dQ and dK/dV
   kernels, through autograd of both wrappers) against the plain
   backward ``attention_reference_bwd`` in float32 on the kernel's own
   inputs, at null-text's shapes (B = 1), the full-CFG edit's (B = 4),
   three ragged ones and head dim 128, float32 within 1e-4·max|ref| and
   bfloat16 within 2^-7·max|ref| per gradient; at null-text's two shapes
   a second backward on the same inputs must give the same bits, in both
   dtypes; there each kernel's time (torch.profiler) beside its bounds
   (float32: the 3×TF32 bound it runs against and the CUDA-core one), the
   port's whole backward in turns with SDPA's backward alone (from a
   retained graph),
   SDPA forward + backward's and the plain backward's; and
   that the fused frame-attention and GroupNorm wrappers return an output
   with a gradient on the card (the autograd fault repaired there: their
   backward is the plain version's recompute, so it matches the plain
   version's autograd up to the order of sums over query chunks; phase 12
   holds it on the path);

then the paths chosen with ``--paths`` (default all):

fast:
4. run a small edit (tiny model, 32² latents, so the attention kernels run
   at their 1024-token sites) on the card and on the CPU from the same
   weights, cached-source and live-source, and compare the edited latents;
5. run the main path — ``videop2p_tpu_torch.cli.run_videop2p.main``, the
   cached-source fast edit (``--fast``) — at SD-1.5 width with seeded random
   weights, 512², 8 frames, the rabbit-jump prompts, refine controller,
   equalizer and LocalBlend, for ``--steps`` DDIM steps, with every
   kernel's launch count set to 0 just before and read just after; print
   the cached-maps decision; assert the launch counts, finite output of
   shape (2, 8, 512, 512, 3) and src_err = max|edited[0] − x_0| == 0.0;
6. the same edit with ``--live_source`` (the live-source path), launch
   counts asserted;
7. the same cached edit under ``frame_attention="flash_rect"`` and
   ``"flash"`` (same seed, same weights): the flash kernel launched
   10 × 2 × steps times and the fused kernel not at all, src_err == 0.0;
   the edited latents' distance to the ``"auto"`` edit is printed, and in
   float32 at 4 steps or fewer held within 2e-3 (guidance 7.5
   and LocalBlend's thresholded mask amplify per-call differences with the
   steps, so a longer run only prints it);
8. one UNet forward of the cached edit's batch (refine controller on
   captured base maps) under ``"auto"``, ``"flash_rect"`` and ``"flash"``
   against the same forward in float32 through the plain version
   (``"chunked"``), from the same weights and inputs: in float32 within
   1e-4·max|ref|; in bfloat16 a sanity bound, at most 2 × the distance of
   the bfloat16 plain version's forward (the per-kernel checks of phase 3
   are what hold the kernels in bfloat16);
9. with ``--profile``, trace one edit-batch UNet forward of the cached edit
   with ``torch.profiler`` for each ``--frame_attention`` implementation and
   print device time by kernel and the busy share (path official: one
   null-text inner step, forward and backward, likewise);

official:
4b. a small official edit (tiny model, 32² latents, 2 outer × 2 inner
   null-text steps) on the card under "auto" and "flash_rect" and on the
   CPU from the same weights: final null-text losses within 1e-3 relative,
   the same inner steps, edited latents within 2e-3;
10. the official main path — ``main`` without ``fast``: DDIM inversion,
   null-text optimization with ``--inner_steps`` (2; the reference's 10)
   inner Adam steps per outer step, the full-CFG controlled edit, decode —
   under "auto", the null-text record printed, the launch counts asserted
   against the inner steps taken, finite output of shape (2, 8, 512, 512, 3);
   the null-text phase's peak printed beside the one PERF.md records from
   before the fused backward recomputed chunk by chunk;

official_flash:
11. the official path under "auto", "flash_rect" and "flash" with 2 inner
   steps: the flash dK/dV and dQ kernels launched 9 × (inner steps) times
   (the frame-attention sites downstream of a cross-attention), the final
   losses' and edited latents' distance to "auto" printed;
12. one UNet forward of the full-CFG edit's batch (2 uncond + 2 cond
   streams, the refine controller live) and one null-text
   value-and-gradient in the uncond embedding at the main path's shape,
   each under "auto", "flash_rect" and "flash" against the same in float32
   through the plain version ("chunked"): in float32 within 1e-4·max|ref|;
   in bfloat16 at most 2 × the bf16 plain version's distance. The forward
   holds the official edit's kernels at its batch, the gradient the
   backward kernels on the path;

dependent:
13. the fork's dependent noise (``--dependent_p2p`` with ``DEPENDENT``, the
   sweep grid's decay 0.3, windows of 4 (two at 8 frames), AR chaining with
   coefficient 0.1, weight 0.2): (a) the sampler on the card — its
   transform of normals against the CPU's within 1e-6, the empirical
   covariance of 2^20 frame vectors drawn with a CUDA generator within 0.01
   of the closed form, the device time of one draw at (1, 8, 64, 64, 4);
   (b) the cached fast edit with those flags in turns with the plain one
   (plain, dependent, dependent, plain): phase 5's launch counts, finite
   (2, 8, 512, 512, 3) output, src_err == 0.0, the edit moved by the noise
   (max|Δ| > 0), and with ``dependent_weights`` 0 the plain edit bit for
   bit; the wall times printed; (c) the live-source edit with η 0.1 and
   the dependent sampler; (d) the official path with 2 inner steps, the
   null-text record printed; launch counts asserted on each;

checkpoint:
14. the seeded SD-1.5 bundle written as a tuned 3-D checkpoint (the UNet by
   ``save_pipeline`` with a scheduler config of ``steps_offset`` 1,
   ``vae/`` and ``text_encoder/`` under their diffusers / transformers
   names) under ``<tmp>/rabbit-jump`` + the Stage-1 suffix of phase 13's
   settings, then ``main`` on ``<tmp>/rabbit-jump`` with those flags: it
   resolves the suffixed directory and loads it (phase 5's launch counts),
   and its edited latents equal those of the same run from the in-memory
   bundle bit for bit; the write and load times, the bytes read and the
   host and device peaks of the load printed; the directory (under
   ``outputs/``) deleted afterwards, also on a failure.

tune:
15. Stage 1 (``cli.run_tuning.main``) on configs/rabbit-jump-tune.yaml at
   its width (``TUNE``: SD-1.5, 8 frames of data/rabbit, 512², bf16 compute
   on float32 weights, checkpointed blocks, seed 33), cut to 4 steps with a
   checkpoint at 2 and validation at 4 (4 inversion and 4 sampling steps),
   from phase 14's seeded bundle written as a float32 checkpoint
   directory: GroupNorm launched (61 + 60) a step (the forward, then the
   recomputed blocks) and 61 a validation forward, no frame-attention
   kernel ("chunked", as JAX's tuner); every loss finite; the export
   float32, every frozen tensor bit for bit the loaded one, every
   trainable tensor moved; a run preempted at step 2 and resumed from
   "latest" exports the uninterrupted run's bytes; Stage 2 (fast,
   ``--steps``) loads the export through the suffix, src_err == 0.0; one
   train step's pre-clip gradients in float32 with the kernel against the
   plain version and with checkpointing against without, within
   1e-4·max|ref|; one bf16 step's gradients under ``remat_policy``
   "dots_with_no_batch_dims_saveable" bit for bit those of full
   recompute; each step's time and the peak memory of 4 steps of bf16
   and fp32 with checkpointing on and off, and bf16 under that policy
   (frozen weights bit for bit in memory); with ``--profile`` one bf16
   step traced. With path ``distill`` phase 17 runs on the export. The
   directory is deleted afterwards.

surface:
16. the rest of Stage 2's surface through ``main`` at SD-1.5 width, 512², 8
   frames, ``--steps``: (a) official mode with "hybrid" null-text (3 Adam
   steps an outer step against the recorded trajectory) in float32 under
   "auto" and "flash_rect": inner steps 3 everywhere, launches as the steps
   imply (the flash backward 9 × steps × 3 under "flash_rect", none under
   "auto"), flash_rect's losses and latents against "auto" printed (phase
   4b also runs "hybrid", card against CPU); (b) persisted inversion reuse:
   the seeded bundle written as a float32 checkpoint directory (phase 14's
   writer), official mode with 2 inner steps twice on it: the repeat runs
   no inversion and no null-text phase, launches the edit's kernels only,
   and its GIF frames and latents equal the first run's bit for bit; a
   cached fast run saves its trajectory to a fresh ``inv_store``, and an
   official run on that store skips its inversion and runs null-text;
   ``reuse_inversion=False`` recomputes both and gives the first run's
   bits (fault 7: the null-text phase runs with cuDNN's deterministic
   algorithms; its time printed beside the time before that), after a probe of one
   null-text inner step under "auto" and "flash_rect" (repeats with and
   without deterministic convolutions, and what
   ``torch.use_deterministic_algorithms`` warns about); (c) ``multi`` (per-frame
   conditioning) cached: src_err == 0.0; (d) ``quant_mode`` off, w8 and
   w8a8 cached: the UNet's weight bytes on the card and the peak printed,
   phase 5's launch counts; (e) one full (capture) and one shallow UNet
   step's launches (10 + 61 and 5 + 16), then the cached edit with
   ``reuse_schedule`` uniform:2 beside off: launches as the schedule
   implies, src_err == 0.0, wall times printed. The directory is deleted
   afterwards.

distill:
17. consistency distillation (``cli.run_tuning.run_distillation``, 4 fp32
   steps on the 50-point grid) from the tune path's export, or from phase
   14's seeded directory: ms a step, peak, GroupNorm at 3 × 61 sites a
   step and no frame-attention kernel; the student saved and loaded with
   the same tensors; on the teacher's capture of the clip (``--steps`` × 2
   base steps) a zero head's cached edit at ``--steps`` subset steps equal
   to the teacher's bit for bit, the trained student's finite, src_err ==
   0.0, launches as the steps imply.

sdxl:
18. ``UNet3DConfig.sdxl()`` at full width in bf16: one forward of (1, 8,
   128, 128, 4) against (1, 77, 2048) and one 3-stream controlled edit
   step (refine, equalizer "origami" 2.0): wall and device times, peak,
   one frame-attention launch a transformer block and one GroupNorm a
   site; frame attention at D 64 ((B, 8, 10, 4096, 64), (B, 8, 20, 1024,
   64), B 1 and 3) and GroupNorm at every site of the forward against
   their plain versions in fp32 and bf16 (timed beside SDPA /
   F.group_norm + F.silu and the bound); one fp32 forward where it fits.

serve:
19. the serving engine (``serve/engine.py``) at SD-1.5 width, ``--steps``,
   ``--mixed_precision``: (a) an ``EditEngine`` with seeded random weights,
   warmed on the rabbit prompts' controller structure and a batch of 2,
   behind ``EditServer`` on 127.0.0.1 (an ephemeral port), talked to only
   through ``EngineClient``: the rabbit-jump request ("origami" refine,
   LocalBlend, equalizer; 8 frames of data/rabbit), the same clip with
   another edit prompt (a store hit), request 1 again (the same
   ``content_sha256``), two compatible requests together (one scan
   dispatch of 2, each video the singleton's bit for bit), a request for
   unwarmed steps (HTTP 400 with the warm list) and one through an injected
   transient fault (``fail@5``) that succeeds on its retry: every request
   done with src_err == 0.0, GIFs written, finite (2, 8, 512, 512, 3)
   videos; launches as the steps imply (2·steps forwards fresh, steps a
   hit, 2·steps the batch); no kernel build and no program-cache miss
   after warm; the last request's peak memory, and the memory allocated
   after it, no higher than the second's plus the store's growth (and 64
   MiB); request 1's
   videos against ``run_main_path``'s cached fast edit of the same frames,
   seed, weights and prompts, bit for bit; printed: warm seconds, each
   request's queue / resolve / dispatch seconds, the store entry's bytes,
   ``/metrics``' capacity section, the peak; (b) ``python -m
   videop2p_tpu_torch.cli.serve`` as a subprocess, in fp32 (its default)
   and in bf16: ``/healthz``, one request done (its store entry's bytes
   printed), SIGTERM → exit 0 with ``serve_health`` in its ledger.

fleet:
20. replicas behind a router (``serve/replica.py``, ``serve/router.py``) at
   SD-1.5 width, ``--steps``, ``--mixed_precision``: (a) a
   ``ReplicaSupervisor`` in "inproc" mode, 2 replicas sharing one warm
   ``ProgramSet`` and one disk inversion store, a ``RouterServer`` on
   127.0.0.1, talked to only through ``EngineClient``: the rabbit-jump
   request through the router (its videos against ``run_main_path``'s
   cached fast edit, bit for bit), the same clip with another edit prompt
   straight to the other replica (a disk-store hit, no program-cache miss),
   then data/car to one replica and data/tiger to the other at once (the
   pair's launches twice a fresh request's; each one's videos equal, bit
   for bit, to the same request served alone afterwards by a fresh engine
   over the same set); every request done with src_err == 0.0 and finite
   (2, 8, 512, 512, 3) videos; the router's /healthz and /metrics list both
   replicas; a second supervisor with replica 0 under ``unavail@1-999``
   (its breaker opens on one failure): the router sheds to replica 1 and
   the request completes, ``router_health`` in the router's ledger at
   close; printed: the router's overhead a request, the pair's wall time
   against the two served alone, the card's busy share over each (kernel
   intervals of a ``torch.profiler`` trace), the peak; (b) ``python -m
   videop2p_tpu_torch.cli.router --spawn 2`` as a subprocess (two
   ``cli.serve`` children on this card, fp32): the fleet's /healthz, one
   request through the router, SIGTERM → exit 0 with ``router_health`` in
   the router's ledger and ``serve_health`` in each child's.

stream:
21. streaming long-video editing (``stream/``) at SD-1.5 width, 512²,
   ``--steps``: ``run_stream_job`` on an engine over
   ``synthetic_clip(14, 512, seed=0)``, windows of 8, overlap 2 (windows
   [0, 8), [6, 14), one seam), one window in flight: every
   window done with src_err == 0.0, the final video finite (14, 512, 512,
   3), each window's launches a fresh request's, the memory allocated after
   each window no higher than after the first plus the store's growth and
   64 MiB; window 0's edited frames equal to a direct engine request for
   frames 0-7, bit for bit; a job stopped once its first window is
   harvested returns ``interrupted``, and its rerun skips that window (no
   request for it) and gives the uninterrupted run's video bit for bit;
   then ``python -m videop2p_tpu_torch.cli.stream --synthetic 14 --width
   512 --video_len 8 --overlap 2`` as a subprocess, SIGKILLed once its
   first window's sidecar appears and run again: its ``final.npy`` equal to
   the in-process run's bit for bit; printed: each window's queue / resolve
   / dispatch seconds, the seams' PSNR, the job's wall time and the peak.

observe:
22. the fleet's telemetry, correctness and incident planes at SD-1.5
   width, 512², 8 frames, ``--steps``, fp32, over one warm ``ProgramSet``
   (random weights from seed 0), (c) and (d) started at the phase's start,
   (b) while they start, (a) last: (d) ``python -m
   videop2p_tpu_torch.cli.router --spawn 2 --incidents``: the canary once
   on each ``cli.serve`` child through the router, both answers the same
   bits, and (checked after (a)) the in-process replica 0's (the answer
   audit across processes); (c) ``python -m videop2p_tpu_torch.cli.serve
   --slo --incidents``: SIGUSR1 → a ``sigusr1`` bundle, SIGTERM → exit 0
   with ``slo_report`` events; (a) ``tools/serve_loadgen.main``
   (``--router 2 --requests 8 --concurrency 2 --collector --probes --slo
   --incidents --replica_faults 1:wrong:* --window_scale 0.02 --scheduler
   fair --tenants client:1 --tracing``): the probe round before the load
   names replica 1 in a ``probe_audit`` event, the router's final /healthz
   shows it quarantined and every load request (routed after the verdict)
   avoids it, every probe of replica 0 and of the router passes (cached
   replay src_err == 0.0, determinism bit-identical), a ``probe_failed``
   bundle holds manifest.json, flight.jsonl and targets.json, the ledger has
   ``fleet_signals``, ``fleet_series`` (+ its ``.npz``) and ``slo_report``,
   and the launches are the warm-up's and each fresh or rehydrated
   request's 2·steps forwards plus each hit's steps; (b) the loadgen with
   ``--replica_faults 0:unavail@1-999 --breaker_threshold 1 --incidents``:
   a ``breaker_open`` bundle, the router sheds to replica 1, at least half
   the accepted requests done; printed: each probe's latency and
   a round's wall per target, the collector's scrape cost and its share of
   the run, the client lane's p50/p99, every bundle's bytes, the peak.

runs:
23. the run CLIs' observability (``run_videop2p`` / ``run_tuning`` with
   ``--ledger --telemetry --attn_maps --quality --report --latency
   --incidents``) at SD-1.5 width, 512², 8 frames, ``--steps``: (a) the
   cached fast edit once with the flags off, then twice with them on one
   ledger: the flags-on videos and latents equal the flags-off ones bit
   for bit, the launches equal each other and phase 5's, the ledger holds
   ``phase``, ``execute_timing`` (``cached_invert_edit``), ``telemetry``
   (steps = ``--steps``, no NaN), ``attn_maps`` (``inversion`` and
   ``edit``), a finite ``quality`` record and ``memory`` snapshots, the
   second run ``regression_verdicts``; the report exists, no incident
   bundle; (b) official mode with ``--telemetry --latency`` at 2 inner
   steps beside the same run without them: the ``null_text_fused`` record
   (the loss curve and inner steps of the run, its latent summary without
   NaN), ``execute_timing`` for ``ddim_inversion``, ``null_text_fused`` and
   ``edit_sample``, the edit's below the null-text phase's (two programs,
   not nested), the same bits and launches; (c) ``cli.run_tuning.main`` on ``TUNE`` cut to 2
   steps (validation at 2 × 2 steps) with ``--ledger --telemetry
   --latency`` beside the same without: finite grad norms in the ``metric``
   events, ``execute_timing`` for ``train_steps``, the same losses and
   launches; printed: each run's wall with the flags on against off, the
   bytes of the ledger, the sidecar and the report.

analysis:
24. program analysis, device traces and the demo layer at SD-1.5 width,
   512², 8 frames, ``--steps``: (a) ``run_videop2p.main`` ``--fast`` with
   ``--ledger --trace_analysis`` twice, then with ``--no_program_analysis``:
   videos, latents and launches the same bits in all three; the
   ``program_analysis`` of ``cached_invert_edit`` the same in runs 1 and 2
   (less ``analysis_s``; on the card ``temp_bytes`` and ``peak_hbm_bytes``
   are reported, not gated), its ``flops`` and ``transcendentals`` equal
   to a ``frame_attention="dense"`` run's; run 3 a ``disabled`` skip; each
   ``trace_analysis`` of ``cached_invert_edit`` holds as many frame-attention
   (less the fp32 prep kernels) and GroupNorm kernels as the wrappers'
   counters counted over the window, and those are the run's; a skip or a
   trace with no kernel fails; the kernels' own reports held exactly at
   the path's shapes (the fused forward, flash_rect forward + backward,
   GroupNorm + SiLU); (b) official mode under flash_rect with the analysis
   on: ``ddim_inversion``, ``null_text_fused`` and ``edit_sample``
   analysed, the flash kernels in their histograms as many times as
   launched (the backward's in ``null_text_fused`` alone); (c)
   ``run_tuning.main`` at 3 steps of one step a chunk with
   ``--trace_analysis``: one ``trace_analysis`` (``train_steps_chunk``, the
   second chunk) whose GroupNorm kernels equal the counter, one
   ``program_analysis`` of ``train_steps``; (d) the UI: ``InferencePipeline``
   (bf16) on a written SD-1.5 checkpoint, ``run`` at 2 steps writes a GIF,
   a second ``run`` reuses the warm program (one ``sample_decode`` compile),
   ``ProgramSet.sample`` = ``edit_sample`` + ``decode`` bit for bit;
   printed: the top families, idle / span, each program's FLOPs and the
   analysis' seconds. (Phases 20-23 run with the analysis' kill switch,
   ``VIDEOP2P_OBS_NO_ANALYSIS=1``; phase 19's engines analyse.)

mesh:
25. the multi-GPU layer at world size 1 (the card's one GPU), SD-1.5
   width, 512², 8 frames, ``--steps``: (a) an NCCL process group of one
   rank in this process (a ``file://`` store: no port) and its first
   all-reduce, timed; the mesh's sharded frame attention and GroupNorm
   forced onto the UNet (``set_seams``, sp = tp = 1, as JAX's tests wire
   them): one cached edit-batch forward equals the plain forward bit for
   bit with the plain forward's launches, and the wrappers' kernels match
   their plain versions at the shapes a rank's batch gives them; (b)
   ``run_videop2p.main(mesh="1,1,1", device_telemetry=True)`` on the
   rabbit clip in that group equals the plain main path bit for bit with
   the same launches, its ledger holding ``device_telemetry`` (divergence
   0.0) and ``comm_analysis``; then ``torchrun --standalone
   --nproc_per_node 1 -m videop2p_tpu_torch.cli.run_videop2p --fast --mesh
   1,1,1 --device_telemetry`` (a process with its own NCCL group) writes
   the plain run's GIFs byte for byte and its per-step telemetry; (c)
   printed: NCCL's set-up seconds, the runs' wall times, the card.

tools:
27. the operator tools, each a ``python -X importtime -m
   videop2p_tpu_torch.tools.<name>`` process (all at once), on ledgers
   written on the card at SD-1.5 width, 512², 8 frames, ``--steps``: the
   runs path's fast-edit ledger and the observe path's loadgen fleet where
   those paths ran, else two cached fast edits with the flags on one
   ledger and a ``--router 2`` loadgen fleet (every plane, tracing,
   replica 1 wrong) written here. ``ledger_summary`` exits 0 naming
   ``cached_invert_edit``; ``obs_diff`` exits 0 on the two runs, 1 (a
   ``timing:`` verdict) on a copy of the second with
   ``cached_invert_edit``'s execute seconds doubled, 0 on the fleet ledger
   against itself; ``edit_report``, ``cost_report``, ``fleet_dash``,
   ``probe_report`` and ``incident_report`` (the fleet's bundle) write
   pages holding their section headings; ``trace_view --json`` joins the
   loadgen's, the router's and the replicas' spans into at least one trace
   with all four segments; ``stream_drive`` on the card (JAX's defaults:
   14 frames, windows of 4, overlap 1, the tiny models) edits every window
   ``done`` with ``src_err_max == 0.0`` in two processes of its own (one
   after the other, after the others), and
   ``obs_diff`` of the two drives exits 0 (at ``TOOLS_NOISE_SCALE`` × its
   thresholds; 1× printed), then once more in this process for its
   launches (the counters; GroupNorm's at least one); no tool process
   imports ``jax`` or ``videop2p_tpu``; printed: each tool's seconds.

graphs:
28. CUDA graphs (``utils/cuda_graphs.py``) at SD-1.5 width, 512², 8 frames,
   bf16, each program graphed (the default on the card) against its eager
   loop (``cuda_graphs=False``), run in turns: (a) the cached fast edit
   with LocalBlend and ``uniform:2`` reuse at ``GRAPH_EDIT_STEPS`` (every
   variant of both loops occurs twice or more: a variant's first step runs
   eagerly, its second is captured and replayed), trajectory, captured maps
   and edit bit for bit; (b) ``official_null_text`` under "flash_rect" at
   ``GRAPH_NULL_STEPS`` outer × ``GRAPH_INNER_STEPS`` inner steps, early stop
   at an epsilon from an eager run's median final loss (reached at one
   outer step or more), embeddings, losses and inner steps bit for bit;
   (c) ``GRAPH_TUNE_STEPS`` Stage-1 steps (fp32 weights, bf16 compute,
   checkpointed blocks), losses, parameters and Adam moments bit for bit;
   (h) ``GRAPH_DISTILL_STEPS`` distillation steps on the same weights
   (bf16 compute, checkpointed blocks), losses, student, head, EMA target
   and Adam moments; (f) the plain ``ddim_inversion`` at ``GRAPH_INV_STEPS``
   with dependent noise; (g) the live edit at ``GRAPH_LIVE_STEPS`` (the
   official full-CFG layout, LocalBlend, null-text embeddings, η 0.1 on
   dependent noise); (e) "hybrid" null-text under "flash_rect" at
   ``GRAPH_NULL_STEPS`` × ``GRAPH_INNER_STEPS``;
   each with the same kernel launches, and the graphs captured and
   replayed (each run's wall printed); (i) a served session at
   ``--steps``: two bf16 SD-1.5 program sets on one bundle, one on kept
   runners and one with graphs off, each warmed, then ``GRAPH_SERVED`` (a
   fresh request, a hit, a second fresh request with another clip and
   prompts) on each: the kept set captures nothing and runs no step
   eagerly after warm, its videos and src_err (0.0) are the graphs-off
   set's bit for bit; its runners' pool bytes and the copy-in of a capture
   printed. With ``--graph_timings``
   (out of the default run, for its time limit): (d) the 50-step cached
   fast edit (the CLI's windows) eager / graphed / graphed / eager (wall,
   peak memory, each graph's capture seconds and each runner's pool
   bytes) and one traced run each for the card's busy share, a
   null-text inner step (flash_rect; the wall of 8 inner steps less 2's,
   over 6) and a Stage-1 step (5 steps less 2, over 3) in the same turns,
   each after an untimed warm run, and the served session at 50 steps on
   sets "off", "per_call" (graphs captured anew every request) and "kept",
   in the turns off, per_call, kept, kept, per_call. One
   seeded build serves (a)-(h): Stage 1 and distillation on its float32
   weights, then the edit and null-text on its bf16 cast.

Every other path runs graphed by default (its loops on one card).

Prints the ``{"kernels": [...]}`` line (each kernel whose path ran), then
the card line, then, last, ``{"ok": true, "device": {...}}``.

``--gn_only`` runs GroupNorm's checks and timings alone, its sums over the
UNet's 61 sites (the kernel, its byte bound, the plain-recompute backward)
and its summed device time in one edit-batch forward and one null-text
inner step, in both dtypes (``--gn_kernel_names`` names an older tree's
kernels, so that a copy of this script in that tree's checkout times it
the same way).

Run:  python3 chip_smoke.py [--steps 2] [--inner_steps 2]
                            [--mixed_precision fp32|bf16]
                            [--paths [fast] [official] [official_flash]
                                     [dependent] [checkpoint] [tune] [surface]
                                     [distill] [sdxl] [serve] [fleet] [stream]
                                     [observe] [runs] [analysis] [mesh]
                                     [serve_mesh] [tools] [graphs]]
                            [--profile [--frame_attention auto flash_rect flash]]
                            [--graph_timings]
                            [--gn_only [--gn_kernel_names NAME ...]]
                            [--out PATH.json]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# Re-initialise CUPTI for every torch.profiler session. Kept alive across
# sessions (Kineto's default), CUPTI's GPU timestamps drift from the host
# clock over minutes, and Kineto then drops every kernel record of a later
# trace as outside its capture window (measured on an H100 host:
# videop2p_tpu_torch/utils/profiler_probe.py). Set before torch loads Kineto.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 CUDA cores; bf16 dense tensor cores
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor cores: the float32 attention kernels' 3×TF32 products
L2_BYTES = 50e6  # the H100's L2 cache

# the rabbit-jump edit (configs/rabbit-jump-p2p.yaml)
RABBIT = dict(
    pretrained_model_path="./outputs/rabbit-jump",
    image_path="./data/rabbit",
    prompt="a rabbit is jumping on the grass",
    prompts=["a rabbit is jumping on the grass",
             "a origami rabbit is jumping on the grass"],
    blend_word=["rabbit", "rabbit"],
    eq_params={"words": ["origami"], "values": [2]},
    save_name="origami",
    is_word_swap=False,
)

# Limits of kernel vs plain version (max |Δ|). The plain version runs in
# float32 on the kernel's own inputs (bf16 inputs upcast exactly). float32:
# the two differ only in summation order (online vs one-pass softmax; split
# vs single statistics reduction). bfloat16: the kernels accumulate in f32
# and round once on output, which costs at most half a bf16 ulp; the limit
# is 2^-7·max|ref|, one to two bf16 ulps at the largest output.
ATTN_TOL_F32 = 1e-4
# the flash forward's residuals m and l (the backward reads them) against
# the plain version's, relative (m against max(|m|, 1)): both sum the same
# scores in another order
RES_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
GN_TOL_F32 = 2e-4
BF16_REL_TOL = 2.0 ** -7
# the flash backward against the plain backward in float32: summation order
# only, relative to the gradient's largest element (dK and dV sum over up to
# 32768 queries)
BWD_REL_TOL_F32 = 1e-4
# the small edit on the card against the same edit on the CPU, and the
# flash variants of the main path against its "auto" edit (float32, at most
# E2E_GATE_STEPS steps: the edit amplifies per-call differences with the steps)
E2E_TOL = 2e-3
E2E_GATE_STEPS = 4
# the small official edit (phase 4b): tiny models, 32² latents, 4 frames,
# 2 outer × 2 inner null-text steps
SMALL_OFFICIAL = dict(RABBIT, fast=False, width=64, video_len=4, num_ddim_steps=2,
                      num_inner_steps=2, save_gifs=False,
                      frames=np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3),
                                                               dtype=np.uint8))
# one cached edit-batch UNet forward under a kernel against the same forward
# in float32 through the plain version: float32 within this times max|ref|;
# bfloat16 (a sanity bound, not a correctness gate: any two bf16
# implementations differ by rounding) within this multiple of the bf16 plain
# version's own distance
FWD_REL_TOL_F32 = 1e-4
BF16_FWD_RATIO = 2.0
# frame-attention sites with N >= 1024 tokens per UNet forward at 512² (the
# 64² and 32² levels) and GroupNorm sites; one forward per inversion step
# and one per edit step
ATTN_SITES = 10
GN_SITES = 61
# the frame-attention sites whose inputs depend on the text embedding: all
# but the first 64² site, which lies upstream of every cross-attention; a
# null-text backward runs the flash backward kernels there
ATTN_GRAD_SITES = 9
# the small official edit on the card against the same edit on the CPU:
# final null-text losses, relative (summation order through 2 × 2 Adam
# steps; the CPU parity tests read ~1e-6)
OFFICIAL_LOSS_RTOL = 1e-3
# one null-text gradient under a kernel against the same gradient in
# float32 through the plain version, relative to its largest element
GRAD_REL_TOL_F32 = 1e-4
# the "auto" null-text phase's peak (GiB) of the official path at 4 steps
# from before the fused kernel's backward recomputed one query chunk at a
# time (PERF.md §5, PR 3's runs on an H100 80GB HBM3 at 700 W)
AUTO_NULL_TEXT_PEAK_BEFORE_GIB = {"fp32": 23.37, "bf16": 15.29}
# null-text inner steps of the official path under each kernel (phase 11)
FLASH_INNER_STEPS = 2
# the paths after the kernel checks: the fast edit (phases 4-9), the
# official main path (4b, 10), the official path under each kernel (11, 12),
# the dependent noise (13), a checkpoint directory (14), Stage 1 (15), the
# rest of Stage 2's surface (16), consistency distillation and the few-step
# student (17), SDXL's width (18), the serving engine (19), replicas behind a
# router (20), streaming long-video editing (21), the fleet's telemetry,
# correctness and incident planes (22), the run CLIs' observability (23),
# program analysis and traces (24), the mesh at world size 1 (25),
# serving over several devices (26), the operator tools (27) and CUDA
# graphs (28)
PATHS = ("fast", "official", "official_flash", "dependent", "checkpoint", "tune",
         "surface", "distill", "sdxl", "serve", "fleet", "stream", "observe", "runs",
         "analysis", "mesh", "serve_mesh", "tools", "graphs")
# phase 28: the graphed-against-eager runs' depths (every variant of each
# program occurs twice or more, so each is captured and replayed), and the
# timed fast edit's
GRAPH_EDIT_STEPS = 12
GRAPH_NULL_STEPS = 4
GRAPH_INNER_STEPS = 2
GRAPH_TUNE_STEPS = 3
GRAPH_TIMED_STEPS = 50
GRAPH_LIVE_STEPS = 8
GRAPH_INV_STEPS = 6
GRAPH_DISTILL_STEPS = 3
# phase 28's served session: a fresh request, a hit (the fresh clip, other
# prompts and equalizer) and a second fresh request (another clip and
# prompts), each compatible with the warmed controller structure
GRAPH_SERVED = (
    ("fresh", 0, RABBIT["prompts"], 2),
    ("hit", None, [RABBIT["prompt"], "a origami rabbit is jumping on the snow"], 3),
    ("fresh2", 1, ["a rabbit is sitting in the garden",
                   "a origami rabbit is sitting in the garden"], 4),
)
# phase 4b's final losses in "hybrid" null-text mode are compared relative
# to max(|loss|, this): its last outer step lands on x_0, where both losses
# sit at float32 rounding noise (~1e-15) and have no relative meaning
OFFICIAL_LOSS_FLOOR = 1e-10
# the surface path (phase 16): "hybrid" null-text's Adam steps per outer
# step (JAX's default), the persisted-reuse runs' inner steps, and the
# frame-attention and GroupNorm sites of a shallow reuse step (the first
# down block's 2 resnets and 2 transformers at 64², the last up block's 3
# and 3, conv_norm_out)
HYBRID_INNER_STEPS = 3
REUSE_INNER_STEPS = 2
SHALLOW_ATTN_SITES = 5
SHALLOW_GN_SITES = 16
REUSE_SCHEDULE = "uniform:2"
# the dependent-noise settings of phases 13-14: the sweep grid's values
# (videop2p_tpu/cli/sweep.py), two AR-chained windows of 4 at 8 frames
DEPENDENT = dict(dependent=True, dependent_p2p=True, decay_rate=0.3, window_size=4,
                 ar_sample=True, ar_coeff=0.1, dependent_weights=0.2)
# the sampler on the card against the CPU's transform of the same normals,
# and its empirical covariance over SAMPLER_VECTORS frame vectors against
# the closed form (sampling error ≈ (2/N)^½ = 1.4e-3 an entry)
SAMPLER_TOL = 1e-6
SAMPLER_VECTORS = 2 ** 20
COV_TOL = 0.01
# the SD-1.5 scheduler config a Stage-1 export writes (phase 14)
SD_SCHEDULER_CONFIG = {"_class_name": "DDIMScheduler", "num_train_timesteps": 1000,
                       "beta_start": 0.00085, "beta_end": 0.012,
                       "beta_schedule": "scaled_linear", "clip_sample": False,
                       "set_alpha_to_one": False, "steps_offset": 1}
GN_LAUNCHES_PER_CALL = 1  # one persistent launch (ops/groupnorm.py:plan)
# official mode's null-text phase (s) in phase 16b's first and
# recomputed runs before it ran with deterministic convolutions (PERF.md
# §5: two chip_smoke runs on an H100 80GB HBM3 at 700 W)
NULL_TEXT_S_BEFORE_DETERMINISM = (8.455, 8.366)
# consistency distillation (path "distill", phase 17): fp32 steps on the
# DDIM grid of the CLI's default, from the tune path's export
DISTILL_STEPS = 4
DISTILL_GRID = 50
# the remat policy Stage 1's step is timed under beside full recompute
# (phase 15, bf16)
REMAT_POLICY = "dots_with_no_batch_dims_saveable"
# Stage 1 (path "tune", phase 15): configs/rabbit-jump-tune.yaml at its
# width (SD-1.5, 8 frames, 512², bf16, checkpointed blocks), cut to 4 steps
# with a checkpoint at 2 and validation at 4 at 4 inversion and 4 sampling
# steps (written out: PyYAML may be missing on the card)
TUNE = dict(
    train_data={"video_path": "./data/rabbit", "prompt": "a rabbit is jumping on the grass",
                "n_sample_frames": 8, "width": 512, "height": 512, "sample_start_idx": 0,
                "sample_frame_rate": 1},
    validation_data={"prompts": ["a origami rabbit is jumping on the grass"],
                     "video_length": 8, "width": 512, "height": 512,
                     "num_inference_steps": 4, "guidance_scale": 12.5,
                     "use_inv_latent": True, "num_inv_steps": 4},
    learning_rate=3e-5, train_batch_size=1, max_train_steps=4, checkpointing_steps=2,
    validation_steps=4, trainable_modules=["attn1.to_q", "attn2.to_q", "attn_temp"],
    seed=33, mixed_precision="bf16", gradient_checkpointing=True)
# GroupNorm sites inside the blocks that gradient checkpointing recomputes:
# all but conv_norm_out
GN_REMAT_SITES = 60
# one train step's pre-clip gradients with the kernels against the plain
# versions, and with the blocks recomputed against without, in float32,
# relative to the largest gradient element
TUNE_GRAD_REL_TOL = 1e-4
# train steps timed per configuration (the median of steps 2 on)
TUNE_TIMED_STEPS = 4
# timing: windows of at least this many ms of back-to-back calls, the
# median of three of them
TIME_WINDOW_MS = 20.0
# the device kernels of each ported kernel, by name prefix (profile)
KERNEL_NAMES = {"frame_attention": ("frame_attention_wgmma_kernel", "frame_attention_tf32"),
                "group_norm": ("gn_persistent_kernel",),
                "flash_attention": ("flash_fwd_wgmma_kernel", "flash_fwd_tf32"),
                "flash_attention_bwd": ("flash_bwd_dkv", "flash_bwd_dq")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _window_ms(fn, launches: int) -> float:
    """Device time per call of ``launches`` back-to-back calls of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def _launches_per_window(fn) -> int:
    """Enough calls of ``fn`` (after a warm-up call) to fill TIME_WINDOW_MS,
    so that a window times the device work and not the launch overhead."""
    fn()
    return max(1, math.ceil(TIME_WINDOW_MS / max(_window_ms(fn, 1), 1e-3)))


def time_ms(fn) -> float:
    """The median over three windows of ≥ TIME_WINDOW_MS of ``fn``'s device
    time per call."""
    n = _launches_per_window(fn)
    return statistics.median(_window_ms(fn, n) for _ in range(3))


def time_in_turns(*fns) -> tuple:
    """``time_ms`` of each of ``fns`` (a kernel, the library call that
    computes the same function, its plain version), their windows taken in
    turns (forward, backward, forward: kernel, library, library, kernel,
    kernel, library for two), so that a drift of the card's clocks falls on
    each."""
    counts = [_launches_per_window(fn) for fn in fns]
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1] + order:
        times[i].append(_window_ms(fns[i], counts[i]))
    return tuple(statistics.median(t) for t in times)


def limit(dtype, ref: torch.Tensor, f32_tol: float) -> float:
    if dtype == torch.float32:
        return f32_tol
    return BF16_REL_TOL * ref.abs().max().item()


def bound_ms(nbytes: float, flops: float, dtype, peak: float = None) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forward_bounds(rec: dict, fn, dtype, b, f, h, n, d, kernel: str) -> None:
    """A timed forward row's bounds and share: bf16 at its dense
    tensor-core rate; float32 at the rate of the 3×TF32 products it runs
    (three TF32 products per product), the CUDA-core bound beside it, and
    its prep and attention kernels' device times from a trace of ``fn``
    (``kernel``: their name prefix)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = b * h * (2 * f * n + 2 * n) * d * itemsize
    flops = 4.0 * b * h * f * n * n * d
    if dtype == torch.float32:
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 3 * flops, dtype, PEAK_TF32_FLOPS)
        rec["bound_cuda_core_ms"] = bound_ms(nbytes, flops, dtype)[0]
        # None where the profiler missed them (device_ms_by_kernel)
        rec["kernels_ms"] = device_ms_by_kernel(
            fn, {"attention": f"{kernel}_kernel", "prep": f"{kernel}_prep_kernel"})
    else:
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
    rec["share"] = rec["bound_ms"] / rec["ms"]
    print(f"    kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, "
          f"sdpa {rec['library_ms']:.4f} ms (kernel/sdpa {rec['ratio']:.3f}), bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, share {rec['share']:.3f})"
          + (f", CUDA-core bound {rec['bound_cuda_core_ms']:.4f} ms; " + (
              f"prep kernel {rec['kernels_ms']['prep']:.4f} ms, attention kernel "
              f"{rec['kernels_ms']['attention']:.4f} ms (profiler)"
              if None not in rec["kernels_ms"].values()
              else "prep / attention split not measured")
             if dtype == torch.float32 else ""), flush=True)


def check_attention(gen, dtype, b, f, h, n, d, timed: bool) -> dict:
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import attention as fa

    dev = "cuda"
    # the head-split views FrameAttention hands the kernel
    q = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    out = fa.fused_frame_attention(q, k, v)
    ref = fa.chunked_frame_attention(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    tol = limit(dtype, ref, ATTN_TOL_F32)
    rec = {"shape": [b, f, h, n, d], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol}
    print(f"  frame_attention {rec['shape']} {rec['dtype']}: max|d| {err:.3e} "
          f"(limit {tol:.3e})", flush=True)
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"frame attention kernel disagrees: {rec}")
    if timed:
        # the library call on the same fold: (B, H, F·N, D) against (B, H, N, D)
        q4 = q.transpose(1, 2).reshape(b, h, f * n, d).contiguous()
        k4, v4 = k.contiguous(), v.contiguous()
        rec["ms"], rec["library_ms"] = time_in_turns(
            lambda: fa.fused_frame_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q4, k4, v4))
        rec["plain_ms"] = time_ms(lambda: fa.chunked_frame_attention(q, k, v))
        rec["ratio"] = rec["ms"] / rec["library_ms"]
        forward_bounds(rec, lambda: fa.fused_frame_attention(q, k, v), dtype, b, f, h, n, d,
                       "frame_attention_tf32")
    return rec


def flash_residual_errors(q, k, v, rect: bool) -> dict:
    """The flash forward's per-row residuals m and l, launched on the views
    the ``rect`` (flash_rect) or frame-batched (flash) wrapper hands the
    kernel, against ``attention_reference(..., residuals=True)`` on the same
    inputs in float32: the largest |Δm| / max(|m|, 1) and |Δl| / l."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = q.shape
    out = fa._frame_major_out(q)
    if rect:
        q5, out5, k5, v5 = fa._rect_view(q), fa._rect_view(out), k[:, None], v[:, None]
    else:
        q5, out5 = q, out
        k5, v5 = k[:, None].expand(b, f, h, n, d), v[:, None].expand(b, f, h, n, d)
    m, l = (torch.empty(q5.shape[:4], device=q.device) for _ in range(2))
    fa._flash(q5, k5, v5, out5, m, l)
    _, m_ref, l_ref = fa.attention_reference(q5.float(), k5.float(), v5.float(),
                                             residuals=True)
    return {"m": ((m - m_ref).abs() / m_ref.abs().clamp(min=1.0)).max().item(),
            "l": ((l - l_ref).abs() / l_ref).max().item()}


def check_flash(gen, dtype, b, f, h, n, d, timed: bool) -> list:
    """Both wrappers of the flash kernel against their plain versions."""
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import attention as fa

    dev = "cuda"
    q = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    recs = []
    for name in ("flash_rect_frame_attention", "flash_frame_attention"):
        kernel = getattr(fa, name)
        plain = getattr(fa, name + "_reference")
        out = kernel(q, k, v)
        ref = plain(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        tol = limit(dtype, ref, ATTN_TOL_F32)
        del ref
        rec = {"wrapper": name, "shape": [b, f, h, n, d],
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol}
        print(f"  {name} {rec['shape']} {rec['dtype']}: max|d| {err:.3e} "
              f"(limit {tol:.3e})", flush=True)
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"flash kernel disagrees: {rec}")
        rec["residual_err"] = flash_residual_errors(q, k, v, name == "flash_rect_frame_attention")
        print(f"    residuals: max rel |dm| {rec['residual_err']['m']:.3e}, |dl| "
              f"{rec['residual_err']['l']:.3e} (limit {RES_RTOL[dtype]:.0e})", flush=True)
        if max(rec["residual_err"].values()) > RES_RTOL[dtype]:
            raise AssertionError(f"flash residuals disagree: {rec}")
        if timed:
            q4 = q.transpose(1, 2).reshape(b, h, f * n, d).contiguous()
            k4, v4 = k.contiguous(), v.contiguous()
            rec["ms"], rec["library_ms"] = time_in_turns(
                lambda: kernel(q, k, v), lambda: F.scaled_dot_product_attention(q4, k4, v4))
            rec["plain_ms"] = time_ms(lambda: plain(q, k, v))
            rec["ratio"] = rec["ms"] / rec["library_ms"]
            forward_bounds(rec, lambda: kernel(q, k, v), dtype, b, f, h, n, d,
                           "flash_fwd_tf32")
        recs.append(rec)
    return recs


def check_tma_refusals(gen) -> dict:
    """That each attention wrapper refuses, on the card and in bfloat16, a q
    view that the TMA path cannot read — a head-dim stride other than 1,
    and a base address 2 bytes off a 16-byte boundary — with a ValueError
    naming the fault, and launches nothing."""
    from videop2p_tpu_torch.ops import attention as fa

    dev, dtype = "cuda", torch.bfloat16
    b, f, h, n, d = 1, 2, 2, 1024, 40
    k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    wide = torch.randn(b, f, n, h, 2 * d, generator=gen, device=dev).to(dtype)
    flat = torch.randn(b * f * n * h * d + 1, generator=gen, device=dev).to(dtype)
    views = {"head-dim stride 2": wide[..., ::2].transpose(2, 3),
             "base address off 16 bytes": flat[1:].view(b, f, n, h, d).transpose(2, 3)}
    rec = {}
    for name in ("fused_frame_attention", "flash_rect_frame_attention",
                 "flash_frame_attention"):
        for case, q in views.items():
            before = (fa.launch_count(), fa.flash_launch_count())
            try:
                getattr(fa, name)(q, k, v)
            except ValueError as err:
                rec[f"{name}: {case}"] = str(err)
            else:
                raise AssertionError(f"{name} took a q with a {case}")
            if (fa.launch_count(), fa.flash_launch_count()) != before:
                raise AssertionError(f"{name} launched on a q with a {case}")
            print(f"  {name}, q with a {case}: refused ({rec[f'{name}: {case}']})",
                  flush=True)
    return rec


def check_auto_above_head_dim_128(gen) -> dict:
    """That "auto" frame attention at head dim 160 (N 1024: a 1024² input's
    32² level) runs chunked_frame_attention on the card, as JAX's dispatch
    does above 128: its output is the chunked version's, bit for bit, and
    no fused kernel launches. Both dtypes."""
    from videop2p_tpu_torch.ops import attention as fa

    dev = "cuda"
    b, f, h, n, d = 1, 8, 8, 1024, 160
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
        k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
        v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
        before = fa.launch_count()
        out = fa.make_frame_attention_fn("auto")(q, k, v)
        launched = fa.launch_count() - before
        same = torch.equal(out, fa.chunked_frame_attention(q, k, v))
        name = str(dtype).replace("torch.", "")
        rec[name] = {"chunked_output": same, "fused_launches": launched}
        print(f"  auto at {[b, f, h, n, d]} {name}: the chunked output {same}, fused "
              f"launches {launched}", flush=True)
        if not (same and launched == 0 and torch.isfinite(out).all()):
            raise AssertionError(f"auto above head dim 128 did not take the chunked route: {rec}")
    return rec


def print_ptxas_reports() -> dict:
    """Each kernel's registers, static shared memory and spills as ptxas
    reported them when the libraries were built."""
    from videop2p_tpu_torch.ops import _build

    reports = {}
    for src in _build.KERNEL_SOURCES:
        reports[src] = _build.ptxas_report(src)
        for r in reports[src]:
            print(f"  ptxas {src}: {r['kernel']}: {r['registers']} registers, "
                  f"{r['smem_bytes']} bytes static smem, spills {r['spill_stores']} / "
                  f"{r['spill_loads']} bytes (stores / loads)", flush=True)
    # the float32 forward kernels' shared memory is dynamic, set at launch
    config = _build.bind("frame_attention.cu", "frame_attention_tf32_config",
                         [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
    reports["frame_attention_tf32_config"] = {}
    for dp in (16, 32, 40, 48, 64, 80, 96, 128):
        vals = [ctypes.c_int(0) for _ in range(3)]
        config(dp, *(ctypes.byref(x) for x in vals))
        keys, stages, smem = (x.value for x in vals)
        reports["frame_attention_tf32_config"][dp] = {"keys": keys, "stages": stages,
                                                      "smem_bytes": smem}
        print(f"  fp32 forward (frame_attention_tf32 / flash_fwd_tf32) DP {dp}: {keys} keys "
              f"a tile, {stages} stages, {smem} bytes dynamic smem", flush=True)
    return reports


def _trace_kernels(fn, iters: int, cpu: bool = False) -> dict:
    """Kernel name → its device durations (ms) in a torch.profiler trace of
    ``iters`` calls of ``fn`` after one warm-up call (CUDA activity only,
    or with the host's too under ``cpu``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    launches: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launches.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return launches


# traces of one measurement, at most, before it gives up on the profiler:
# a torch.profiler trace now and then comes back without some or all of the
# kernels it ran (Kineto counts them "out of range"), so the launches of
# successive traces are pooled, with a growing pause between tries
PROFILE_TRIES = 10


def _profile_pause(i: int) -> None:
    """The pause before the ``i``-th try of a trace (none before the first)."""
    if i:
        time.sleep(min(0.1 * 2 ** (i - 1), 1.0))


def _pooled_launches(fn, iters: int, enough) -> dict:
    """Kernel name → its device durations (ms), pooled over traces of
    ``fn`` (``_trace_kernels``) until ``enough(launches)`` holds or
    PROFILE_TRIES traces were taken."""
    launches: dict = {}
    for i in range(PROFILE_TRIES):
        _profile_pause(i)
        for name, ms in _trace_kernels(fn, iters).items():
            launches.setdefault(name, []).extend(ms)
        if enough(launches):
            break
    return launches


def device_ms_by_kernel(fn, prefixes: dict, iters: int = 3) -> dict:
    """Device time per call of ``fn`` summed over the kernels whose names
    contain each of ``prefixes`` (name → the kernel's function name), from
    torch.profiler traces of ``iters`` calls after one warm-up call. Every
    kernel matched is launched once a call, so each kernel's time is the
    mean over the launches the traces hold: a trace that dropped events
    does not bias it, and one that holds none of a kernel is taken again.
    Where the traces missed a kernel, one more is taken with the host's
    activity too; where that misses it as well, a one-kernel call's time
    comes from CUDA events (``time_ms``), and a call of several is timed
    whole by CUDA events, each kernel's time None (not measured). Each
    miss is said on a line of its own, with what the traces did hold."""

    def sums(launches):
        return {name: sum(statistics.fmean(ms) for kernel, ms in launches.items()
                          if prefix in kernel)
                for name, prefix in prefixes.items()}

    launches = _pooled_launches(fn, iters, lambda ls: all(sums(ls).values()))
    out = sums(launches)
    if all(out.values()):
        return out
    missed = [prefixes[name] for name, ms in out.items() if not ms]
    held = sorted(launches, key=lambda k: -len(launches[k]))[:4]
    # one trace with the host's activity too, as profile_device takes them
    with_cpu = sums(_trace_kernels(fn, iters, cpu=True))
    print(f"    the profiler saw no {', '.join(missed)} in {PROFILE_TRIES} CUDA-only traces "
          f"(they held {sum(map(len, launches.values()))} kernel events of {len(launches)} "
          "names" + (f", most often {[k[:60] for k in held]}" if held else "") + "); a "
          f"trace with the host's activity too: {with_cpu}", flush=True)
    if all(with_cpu.values()):
        return with_cpu
    call_ms = time_ms(fn)
    print(f"    the whole call takes {call_ms:.4f} ms by CUDA events", flush=True)
    if len(prefixes) == 1:
        return {name: call_ms for name in prefixes}
    return {name: None for name in prefixes}


def device_ms_total(fn, iters: int = 5) -> float:
    """Device time per call of ``fn``, summed over every kernel it launches
    (each once a call: the mean of each kernel's launches in the traces);
    from CUDA events (``time_ms``) where no trace held a kernel."""
    launches = _pooled_launches(fn, iters, bool)
    if launches:
        return sum(statistics.fmean(ms) for ms in launches.values())
    ms = time_ms(fn)
    print(f"    the profiler saw no kernel in {PROFILE_TRIES} traces: the time, {ms:.4f} ms, "
          "is from CUDA events", flush=True)
    return ms


def check_flash_bwd(gen, dtype, b, f, h, n, d, timed: bool) -> list:
    """Autograd through both flash wrappers on the card (the forward with its
    residuals, then the dQ and dK/dV kernels) against the plain backward,
    ``attention_reference_bwd``, run in float32 on the kernel's own inputs
    from the plain forward's output and residuals. At the timed (null-text)
    shapes a second backward on the same inputs must give the same bits."""
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import attention as fa

    dev = "cuda"
    q = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    do = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
    recs = []
    for name in ("flash_rect_frame_attention", "flash_frame_attention"):
        kernel = getattr(fa, name)
        rect = name.startswith("flash_rect")

        def fold(x):
            return x.transpose(1, 2).reshape(b, h, f * n, d) if rect else x

        def unfold(x):
            return x.reshape(b, h, f, n, d).transpose(1, 2) if rect else x

        def kv(x):
            return x if rect else x[:, None]

        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        before = (fa.flash_launch_count(), fa.flash_bwd_launch_counts())
        out = kernel(*leaves)
        if out.grad_fn is None:
            raise AssertionError(f"{name} output has no grad_fn")
        out.backward(do)
        after = (fa.flash_launch_count(), fa.flash_bwd_launch_counts())
        if (after[0] - before[0] != 1
                or any(after[1][key] - before[1][key] != 1 for key in ("dkv", "dq"))):
            raise AssertionError(f"{name}: launches {before} -> {after}, expected one each")
        q5, k5, v5, do5 = fold(q.float()), kv(k.float()), kv(v.float()), fold(do.float())
        o, m, l = fa.attention_reference(q5, k5, v5, residuals=True)
        refs = fa.attention_reference_bwd(q5, k5, v5, o, do5, m, l)
        refs = (unfold(refs[0]), refs[1].reshape(k.shape), refs[2].reshape(v.shape))
        del o
        rec = {"wrapper": name, "shape": [b, f, h, n, d],
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": {}, "tol": {}}
        if dtype == torch.bfloat16:
            # both wrappers give the dK/dV kernel F·N query rows per (b, h)
            rec["split"] = fa.dkv_split(b * h * -(-n // 128), f * n,
                                        torch.cuda.get_device_properties(0).multi_processor_count)
        for gname, leaf, ref in zip(("dq", "dk", "dv"), leaves, refs):
            scale = ref.abs().max().item()
            tol = BWD_REL_TOL_F32 * scale if dtype == torch.float32 else BF16_REL_TOL * scale
            err = (leaf.grad.float() - ref).abs().max().item()
            rec["max_abs_err"][gname], rec["tol"][gname] = err, tol
            if not (err <= tol and torch.isfinite(leaf.grad).all()):
                raise AssertionError(f"flash backward disagrees on {gname}: {rec}")
        del refs
        print(f"  {name} backward {rec['shape']} {rec['dtype']}: max|d| "
              + ", ".join(f"{g} {rec['max_abs_err'][g]:.3e} (limit {rec['tol'][g]:.3e})"
                          for g in ("dq", "dk", "dv"))
              + (f", dK/dV cluster split {rec['split']}" if "split" in rec else ""), flush=True)
        if timed:
            # determinism: the same inputs through a second backward
            again = [x.detach().requires_grad_(True) for x in (q, k, v)]
            kernel(*again).backward(do)
            rec["deterministic"] = all(torch.equal(a.grad, c.grad)
                                       for a, c in zip(leaves, again))
            print(f"    second backward bit-identical: {rec['deterministic']}", flush=True)
            if not rec["deterministic"]:
                raise AssertionError(f"{name}: two {rec['dtype']} backwards on the same "
                                     "inputs differ")
            del again
        if timed:
            # the kernels alone, from the residuals of one forward (profiler)
            out = kernel(*leaves)
            # float32: "dq" holds the prep kernel (flash_bwd_dq_prep_tf32_kernel)
            # that writes both kernels' tiles; "prep" is that part of it
            names = {"dkv": "flash_bwd_dkv", "dq": "flash_bwd_dq"}
            if dtype == torch.float32:
                names["prep"] = "flash_bwd_dq_prep"
            ms = device_ms_by_kernel(
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), names)
            if None in ms.values():
                raise AssertionError(f"{name}: the profiler saw no device time for the "
                                     f"backward's kernels {names}")
            # the library's backward alone, SDPA's from its own retained graph
            # on the fold, in turns with the port's whole backward (the output
            # and scratch allocations and the kernels)
            q4 = q.transpose(1, 2).reshape(b, h, f * n, d).contiguous().requires_grad_(True)
            k4, v4 = (x.contiguous().requires_grad_(True) for x in (k, v))
            do4 = do.transpose(1, 2).reshape(b, h, f * n, d).contiguous()
            out4 = F.scaled_dot_product_attention(q4, k4, v4)
            rec["backward_ms"], rec["library_ms"] = time_in_turns(
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True))
            # and SDPA forward + backward, the column of the earlier runs
            rec["library_fwd_bwd_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4).backward(do4))
            del out4
            q5, k5, v5, do5 = fold(q), kv(k), kv(v), fold(do)
            o, m, l = fa.attention_reference(q5, k5, v5, residuals=True)
            rec["plain_ms"] = time_ms(
                lambda: fa.attention_reference_bwd(q5, k5, v5, o, do5, m, l))
            del o, m, l
            itemsize = torch.finfo(dtype).bits // 8
            # q, o, dO read and dQ written; k, v read and dK, dV written; m, l, di
            nq, nk = b * f * h * n * d, b * h * n * d
            nbytes = itemsize * (4 * nq + 4 * nk) + 4 * 3 * b * f * h * n
            unit = 2.0 * b * f * h * n * n * d  # one product of the backward
            rec["ms"] = ms
            rec["bound_ms"] = {}
            # dK/dV: S, dP, dV, dK; dQ: S, dP, dQ; together S, dP, dV, dK, dQ.
            # float32 runs each product as three TF32 products on the tensor
            # cores: its bound is theirs; the CUDA-core bound is printed beside
            f32 = dtype == torch.float32
            if f32:
                rec["bound_cuda_core_ms"] = {}
            for key, products in (("dkv", 4), ("dq", 3), ("both", 5)):
                if f32:
                    rec["bound_cuda_core_ms"][key] = bound_ms(nbytes, products * unit, dtype)[0]
                    rec["bound_ms"][key], rec["bound_by"] = bound_ms(
                        nbytes, 3 * products * unit, dtype, PEAK_TF32_FLOPS)
                else:
                    rec["bound_ms"][key], rec["bound_by"] = bound_ms(nbytes, products * unit,
                                                                     dtype)
            rec["share"] = {key: rec["bound_ms"][key] / ms[key] for key in ("dkv", "dq")}
            if f32:
                print(f"    bounds: 3×TF32 {rec['bound_ms']['dkv']:.4f} / "
                      f"{rec['bound_ms']['dq']:.4f} ms (share {rec['share']['dkv']:.3f} / "
                      f"{rec['share']['dq']:.3f}), CUDA-core "
                      f"{rec['bound_cuda_core_ms']['dkv']:.4f} / "
                      f"{rec['bound_cuda_core_ms']['dq']:.4f} ms (dkv / dq)", flush=True)
            print(f"    dkv kernel {ms['dkv']:.4f} ms, dq kernel {ms['dq']:.4f} ms"
                  + (f" (of which the prep kernel {ms['prep']:.4f} ms)" if "prep" in ms else "")
                  + " (bound "
                  f"{rec['bound_ms']['dkv']:.4f} / {rec['bound_ms']['dq']:.4f} ms, "
                  f"{rec['bound_by']}); whole backward {rec['backward_ms']:.4f} ms, sdpa "
                  f"backward {rec['library_ms']:.4f} ms (kernels/sdpa bwd "
                  f"{(ms['dkv'] + ms['dq']) / rec['library_ms']:.3f}), sdpa fwd+bwd "
                  f"{rec['library_fwd_bwd_ms']:.4f} ms (kernels/sdpa fwd+bwd "
                  f"{(ms['dkv'] + ms['dq']) / rec['library_fwd_bwd_ms']:.3f}), plain "
                  f"{rec['plain_ms']:.3f} ms", flush=True)
            del q4, k4, v4, do4
        recs.append(rec)
        del leaves, out
    torch.cuda.empty_cache()
    return recs


def check_kernel_grads(gen, dtype) -> dict:
    """That the fused frame-attention and GroupNorm wrappers return, on the
    card, an output with a ``grad_fn`` whose backward fills every input's
    gradient (the repaired fault: the kernel launch bypassed autograd).
    Their backward recomputes through the plain version (frame attention
    one query chunk at a time, which sums dK and dV over the chunks in its
    own order), so the comparison with the plain version's autograd reads 0
    or last-bit differences and only guards the wiring; phase 12 and the
    CPU tests against JAX's custom VJPs hold the gradients themselves."""
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    dev = "cuda"
    b, f, h, n, d = 1, 8, 8, 4096, 40
    attn = (torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3),
            torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2),
            torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2))
    x = (torch.randn(1, 8 * 4096, 320, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    scale = torch.randn(320, generator=gen, device=dev) * 0.2 + 1.0
    bias = torch.randn(320, generator=gen, device=dev) * 0.1
    kw = dict(num_groups=32, eps=1e-5, act="silu")
    cases = {
        "frame_attention": (fa.fused_frame_attention, fa.chunked_frame_attention, attn),
        "group_norm": (lambda *a: gn.fused_group_norm(*a, **kw),
                       lambda *a: gn.group_norm_reference(*a, **kw), (x, scale, bias)),
    }
    rec = {}
    for name, (kernel, plain, inputs) in cases.items():
        grads = []
        for fn in (kernel, plain):
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out = fn(*leaves)
            if out.grad_fn is None:
                raise AssertionError(f"{name}: output of {fn} has no grad_fn")
            g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(9),
                            device=dev).to(out.dtype)
            out.backward(g)
            grads.append([leaf.grad.float() for leaf in leaves])
            del out, leaves
        errs = [(a - r).abs().max().item() for a, r in zip(*grads)]
        tols = [limit(dtype, r, ATTN_TOL_F32 * r.abs().max().item()) for r in grads[1]]
        rec[name] = {"max_abs_err": errs, "tol": tols}
        print(f"  {name} gradient {str(dtype).replace('torch.', '')} against the plain "
              f"version's autograd: max|d| {errs} (limits {tols})", flush=True)
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"{name} gradient disagrees: {rec[name]}")
    torch.cuda.empty_cache()
    return rec


def check_group_norm(gen, dtype, n, rows, c, eps, act, timed: bool, *, groups: int = 32,
                     mean: float = 0.5, offset: int = 0, expect_launches: bool = True) -> dict:
    """The GroupNorm kernel against its plain version on x = std·randn + mean
    (std 2, or 1 where the mean is large) in ``dtype``, ``offset`` elements
    past a 16-byte boundary; a second call on the same input must give the
    same bits. Timed: the kernel in turns with F.group_norm + F.silu, the
    plain version, the byte bound (one read of x, one write of y) and the
    floor HBM traffic sets where x does not fit on chip (x read once, the
    part neither the grid's shared memory nor a full 50 MB L2 holds read
    again, y written once)."""
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import groupnorm as gn

    dev = "cuda"
    flat = torch.randn(n * rows * c + offset, generator=gen, device=dev)
    x = (flat * (2.0 if abs(mean) < 1 else 1.0) + mean).to(dtype)[offset:].view(n, rows, c)
    del flat
    scale = torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    kw = dict(num_groups=groups, eps=eps, act=act)
    before = gn.launch_count()
    out = gn.fused_group_norm(x, scale, bias, **kw)
    launches = gn.launch_count() - before
    repeat_equal = torch.equal(out, gn.fused_group_norm(x, scale, bias, **kw))
    ref = gn.group_norm_reference(x.float(), scale, bias, **kw)
    err = (out.float() - ref).abs().max().item()
    tol = limit(dtype, ref, GN_TOL_F32)
    rec = {"shape": [n, rows, c], "dtype": str(dtype).replace("torch.", ""),
           "groups": groups, "eps": eps, "act": act, "mean": mean, "offset": offset,
           "max_abs_err": err, "tol": tol, "launches_per_call": launches,
           "repeat_bit_identical": repeat_equal}
    del ref
    itemsize = torch.finfo(dtype).bits // 8
    x_bytes = n * rows * c * itemsize
    if hasattr(gn, "plan"):  # a tree from before the persistent kernel has none
        p = gn.plan(n, rows, c, dtype, torch.cuda.get_device_properties(0).multi_processor_count,
                    groups, x.data_ptr() % 16 == 0)
        rec["plan"] = p._asdict()
        rec["on_chip_bytes"] = min(n * rows, p.grid * p.capacity_rows) * c * itemsize
    print(f"  group_norm {rec['shape']} {rec['dtype']} G={groups} eps={eps:g} act={act} "
          f"mean={mean:g} offset={offset}: max|d| {err:.3e} (limit {tol:.3e}), "
          f"{launches} launch(es) a call, repeat bit-identical {repeat_equal}"
          + (f", vec {p.vec}, {p.threads} threads, {p.smem_rows} rows on chip a block "
             f"({rec['on_chip_bytes'] / 1e6:.2f} of {x_bytes / 1e6:.2f} MB)"
             if "plan" in rec else ""), flush=True)
    if not (err <= tol and torch.isfinite(out).all() and repeat_equal):
        raise AssertionError(f"group norm kernel disagrees: {rec}")
    if expect_launches and launches != GN_LAUNCHES_PER_CALL:
        raise AssertionError(f"group norm launched {launches} kernels a call, expected "
                             f"{GN_LAUNCHES_PER_CALL}: {rec}")
    if timed:
        nbytes = 2 * x_bytes
        flops = 8.0 * n * rows * c  # stats (2), apply (2), SiLU (~4)
        x_nc = x.transpose(1, 2).contiguous()  # the library's channels-first layout
        w, bb = scale.to(dtype), bias.to(dtype)

        def library():
            y = F.group_norm(x_nc, groups, w, bb, eps)
            return F.silu(y) if act == "silu" else y

        def kernel():
            return gn.fused_group_norm(x, scale, bias, **kw)

        rec["ms"], rec["library_ms"] = time_in_turns(kernel, library)
        rec["plain_ms"] = time_ms(lambda: gn.group_norm_reference(x, scale, bias, **kw))
        rec["ratio"] = rec["ms"] / rec["library_ms"]
        # device time alone (the windows above also hold the host's time per
        # call, which sets them at the small slabs)
        names = KERNEL_NAMES["group_norm"]
        rec["device_ms"] = sum(device_ms_by_kernel(kernel, dict(zip(names, names))).values())
        rec["library_device_ms"] = device_ms_total(library)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
        rec["share"] = rec["bound_ms"] / rec["ms"]
        rec["device_share"] = rec["bound_ms"] / rec["device_ms"]
        if "on_chip_bytes" in rec:
            again = max(0, x_bytes - rec["on_chip_bytes"] - L2_BYTES)
            rec["hbm_floor_ms"] = (nbytes + again) / HBM_BYTES_PER_S * 1e3
        print(f"    kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, "
              f"F.group_norm+silu {rec['library_ms']:.4f} ms (kernel/library "
              f"{rec['ratio']:.3f}); device time (profiler) kernel {rec['device_ms']:.4f} ms, "
              f"library {rec['library_device_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, share of the device time {rec['device_share']:.3f})"
              + (f", HBM floor {rec['hbm_floor_ms']:.4f} ms" if "hbm_floor_ms" in rec else ""),
              flush=True)
        del x_nc
    del x, out
    return rec


# GroupNorm's shapes in phase 3: (N, rows, C, eps, act, timed, groups, mean,
# offset). Timed, in each dtype: the classes PERF.md's table needs — the
# resnets' frame-pooled 64² slabs at C 640 / 960 and B 1-3, the transformer
# entry's per-frame 64²×320 at N 8 / 16 / 24, and the B 2 resnets at 32²×640
# and 8²×1280 / 2560. Then the full-CFG edit's batch (4), null-text's (1),
# a slab whose mean is 8 std (E[x²]−E[x]² cancels), a row that is not a
# whole number of 16-byte vectors (C 42, 6 groups), an x off 16-byte
# alignment, and a ragged slab.
GN_SHAPES = (
    [(b, 8 * 4096, c, 1e-5, "silu", True, 32, 0.5, 0) for c in (640, 960) for b in (1, 2, 3)]
    + [(n, 4096, 320, 1e-6, "none", True, 32, 0.5, 0) for n in (8, 16, 24)]
    + [(2, 8 * 1024, 640, 1e-5, "silu", True, 32, 0.5, 0),
       (2, 8 * 64, 1280, 1e-5, "silu", True, 32, 0.5, 0),
       (2, 8 * 64, 2560, 1e-5, "silu", True, 32, 0.5, 0),
       (4, 8 * 4096, 640, 1e-5, "silu", False, 32, 0.5, 0),
       (4, 8 * 4096, 320, 1e-5, "silu", False, 32, 0.5, 0),
       (32, 4096, 320, 1e-6, "none", False, 32, 0.5, 0),
       (1, 8 * 4096, 320, 1e-5, "silu", False, 32, 0.5, 0),
       (3, 8 * 64, 1280, 1e-5, "silu", False, 32, 0.5, 0),
       (2, 8 * 1024, 640, 1e-5, "silu", False, 32, 8.0, 0),
       (2, 1000, 42, 1e-5, "silu", False, 6, 0.5, 0),
       (2, 1000, 96, 1e-5, "silu", False, 32, 0.5, 1),
       (2, 1000, 96, 1e-5, "silu", False, 32, 0.5, 0)])


# The 61 GroupNorm sites of one UNet forward at 512² (64² latents, 8 frames):
# (kind, latent side, channels, sites). Resnet norms (SiLU, eps 1e-5) and
# conv_norm_out pool the frames: N = B, rows = 8·side²; transformer-entry
# norms (no activation, eps 1e-6) are per frame: N = 8·B, rows = side².
UNET_GN_SITES = (
    ("resnet", 64, 320, 8), ("resnet", 64, 640, 2), ("resnet", 64, 960, 1),
    ("resnet", 32, 320, 1), ("resnet", 32, 640, 6), ("resnet", 32, 960, 1),
    ("resnet", 32, 1280, 1), ("resnet", 32, 1920, 1),
    ("resnet", 16, 640, 1), ("resnet", 16, 1280, 6), ("resnet", 16, 1920, 1),
    ("resnet", 16, 2560, 2),
    ("resnet", 8, 1280, 11), ("resnet", 8, 2560, 3),
    ("transformer", 64, 320, 5), ("transformer", 32, 640, 5),
    ("transformer", 16, 1280, 5), ("transformer", 8, 1280, 1),
)
# the sites upstream of every cross-attention (the first resnet's two norms,
# the first transformer's entry norm): a null-text backward skips them
GN_SITES_WITHOUT_GRAD = {("resnet", 64, 320): 2, ("transformer", 64, 320): 1}


def gn_site_sums(gen, dtype, batch: int) -> dict:
    """Over the 61 sites of one UNet forward at ``batch``, each timed alone
    (device time, torch.profiler) on x = 2·randn + 0.5 with scale and bias
    in x's dtype, as the model holds them: the kernel's forward, its byte
    bound, and the backward the port runs on it (the plain version's
    recompute, the gradient in x alone, as null-text optimization asks:
    the weights are frozen) at the sites a null-text backward reaches."""
    from videop2p_tpu_torch.ops import groupnorm as gn
    from videop2p_tpu_torch.ops._autograd import recompute_grads

    names = KERNEL_NAMES["group_norm"]
    out = {"sites": 0, "kernel_ms": 0.0, "bound_ms": 0.0, "backward_sites": 0,
           "backward_ms": 0.0}
    for kind, side, c, count in UNET_GN_SITES:
        if kind == "resnet":
            n, rows, kw = batch, 8 * side * side, dict(num_groups=32, eps=1e-5, act="silu")
        else:
            n, rows, kw = 8 * batch, side * side, dict(num_groups=32, eps=1e-6, act="none")
        x = (torch.randn(n, rows, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        scale = (torch.randn(c, generator=gen, device="cuda") * 0.2 + 1).to(dtype)
        bias = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(dtype)
        grad_out = torch.randn_like(x)
        ms = sum(device_ms_by_kernel(lambda: gn.fused_group_norm(x, scale, bias, **kw),
                                     dict(zip(names, names))).values())
        backward = count - GN_SITES_WITHOUT_GRAD.get((kind, side, c), 0)

        def plain(xx, ss, bb):
            return gn.group_norm_reference(xx, ss, bb, **kw)

        bwd = device_ms_total(lambda: recompute_grads(plain, (x, scale, bias),
                                                       (True, False, False), grad_out))
        out["sites"] += count
        out["kernel_ms"] += count * ms
        out["bound_ms"] += count * 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        out["backward_sites"] += backward
        out["backward_ms"] += backward * bwd
        del x, grad_out
    torch.cuda.empty_cache()
    print(f"  61 sites at B {batch}, {str(dtype).replace('torch.', '')}: kernel "
          f"{out['kernel_ms']:.3f} ms (each site alone), byte bound {out['bound_ms']:.3f} ms "
          f"(share {out['bound_ms'] / out['kernel_ms']:.3f}); the plain recompute backward at "
          f"{out['backward_sites']} sites {out['backward_ms']:.3f} ms", flush=True)
    return out


def check_group_norm_shapes(gen, expect_launches: bool = True) -> list:
    """Every GN_SHAPES entry in float32 and bfloat16."""
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, rows, c, eps, act, timed, groups, mean, offset in GN_SHAPES:
            recs.append(check_group_norm(gen, dtype, n, rows, c, eps, act, timed,
                                         groups=groups, mean=mean, offset=offset,
                                         expect_launches=expect_launches))
        torch.cuda.empty_cache()
    return recs


def small_edit_check(live_source: bool) -> float:
    """The tiny-model edit at 32² latents on the card and on the CPU from the
    same weights; returns max |Δ| of the edited latents."""
    import copy

    from videop2p_tpu_torch.cli.run_videop2p import build_models, main
    from videop2p_tpu_torch.ops import attention as fa

    frames = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    cpu_bundle = build_models(tiny=True, device="cpu", seed=3)
    gpu_bundle = copy.deepcopy(cpu_bundle)
    for mod in (gpu_bundle.unet, gpu_bundle.vae, gpu_bundle.text_encoder):
        mod.to("cuda")
    kw = dict(RABBIT, fast=True, live_source=live_source, width=64, video_len=4,
              num_ddim_steps=3, frames=frames, save_gifs=False)
    before = fa.launch_count()
    on_card = main(**kw, device="cuda", bundle=gpu_bundle)
    if fa.launch_count() == before:
        raise AssertionError("the small edit did not reach the frame-attention kernel")
    on_cpu = main(**kw, device="cpu", bundle=cpu_bundle)
    if on_card["mode"] != on_cpu["mode"]:
        raise AssertionError(f"modes differ: {on_card['mode']} vs {on_cpu['mode']}")
    err = (on_card["latents"].cpu() - on_cpu["latents"]).abs().max().item()
    print(f"  small edit ({on_card['mode']} source), card vs cpu: max|d| of edited "
          f"latents {err:.3e} (limit {E2E_TOL:g})", flush=True)
    if not (err <= E2E_TOL and torch.isfinite(on_card["latents"]).all()):
        raise AssertionError(f"small edit on the card disagrees with the CPU: {err}")
    return err


def edit_forward_inputs(bundle, full_cfg: bool = False) -> tuple:
    """The inputs of one UNet forward of an edit's batch × 8 frames at 64²:
    latents, text embeddings, and the refine controller at step 5 of 50
    (inside both the cross and the self window). The cached edit's batch
    (1 uncond + 1 edit stream) reads the base maps of one capture forward
    of ``bundle``; with ``full_cfg`` the official edit's (2 uncond + source
    and edit streams), the controller live on the batch's source stream."""
    from videop2p_tpu_torch.cli.run_videop2p import encode_prompts
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.models.attention import BASE_STORE, AttnControl

    ctx = make_controller(
        RABBIT["prompts"], bundle.tokenizer, 50, is_replace_controller=False,
        cross_replace_steps=0.2, self_replace_steps=0.5,
        blend_words=(("rabbit",), ("rabbit",)), equalizer_params=RABBIT["eq_params"],
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = next(bundle.unet.parameters()).dtype
    x = torch.randn(2, 8, 64, 64, 4, generator=gen, device="cuda").to(dtype)
    if full_cfg:
        with torch.no_grad():
            text = encode_prompts(bundle, ["", ""] + RABBIT["prompts"], "cuda")
        return torch.cat([x, x]), text, AttnControl(ctx, 5, 2)
    with torch.no_grad():
        text = encode_prompts(bundle, ["", RABBIT["prompts"][1]], "cuda")
        store: dict = {}
        bundle.unet(x[:1], 500, encode_prompts(bundle, RABBIT["prompts"][:1], "cuda"),
                    AttnControl(None, 0, capture=True), store)
    control = AttnControl(ctx, 5, 1, cached_base=store[BASE_STORE], cached_source=True)
    return x, text, control


def forward_check(mixed_precision: str, full_cfg: bool = False) -> dict:
    """One edit-batch UNet forward (the cached edit's, or with ``full_cfg``
    the official edit's) under each frame-attention kernel against the same
    forward in float32 through the plain version ("chunked"): same weights
    (bf16 ones are the float32 ones rounded), same latents, text embeddings
    and controller. Unlike the edited latents, one forward does not pass
    the kernels' differences through guidance and LocalBlend's thresholded
    mask."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    ref_bundle = build_models(device="cuda", seed=0, frame_attention="chunked")
    x, text, control = edit_forward_inputs(ref_bundle, full_cfg)
    with torch.no_grad():
        ref = ref_bundle.unet(x, 500, text, control, {})
    del ref_bundle
    scale = ref.abs().max().item()
    impls = ("auto", "flash_rect", "flash") + (("chunked",) if dtype != torch.float32 else ())
    errs = {}
    for impl in impls:
        bundle = build_models(dtype=dtype, device="cuda", seed=0, frame_attention=impl)
        with torch.no_grad():
            eps = bundle.unet(x.to(dtype), 500, text.to(dtype), control, {})
        del bundle
        if not torch.isfinite(eps).all():
            raise AssertionError(f"{impl} forward is not finite")
        errs[impl] = (eps.float() - ref).abs().max().item()
        print(f"  {impl} ({mixed_precision}) against chunked (fp32): max|d| of eps "
              f"{errs[impl]:.4e} (max|ref| {scale:.4e})", flush=True)
    torch.cuda.empty_cache()
    if dtype == torch.float32:
        tol = FWD_REL_TOL_F32 * scale
    else:
        tol = BF16_FWD_RATIO * errs["chunked"]
    print(f"  limit {tol:.4e}", flush=True)
    bad = {impl: err for impl, err in errs.items() if not err <= tol}
    if bad:
        raise AssertionError(f"{'full-CFG' if full_cfg else 'cached'} edit-batch forward "
                             f"off the plain version: {bad} (limit {tol})")
    return {"dtype": mixed_precision, "batch": int(x.shape[0]), "max_abs_ref": scale,
            "max_abs_err": errs, "tol": tol}


def profile_device(fn, label: str) -> dict:
    """``fn`` once untraced, then once under ``torch.profiler``: device time
    by kernel name, the ported kernels' share, and the device's busy share
    of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(PROFILE_TRIES):  # a trace may come back empty (PROFILE_TRIES)
        _profile_pause(i)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no device activity in "
                             f"{PROFILE_TRIES} traces")
    by_name: dict = {}
    spans = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
        spans.append((start, end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e3
    window = (spans[-1][1] - spans[0][0]) / 1e3
    total = sum(by_name.values())
    ours = {name: sum(v for k, v in by_name.items() if any(p in k for p in prefixes))
            for name, prefixes in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(f"profile: {label}: host wall {wall_ms:.2f} ms, device kernel time "
          f"{total:.2f} ms, device busy {busy:.2f} ms of a {window:.2f} ms kernel "
          f"window ({100 * busy / window:.1f} %)", flush=True)
    for name, kernel_ms in ours.items():
        print(f"  {name}: {kernel_ms:.2f} ms ({100 * kernel_ms / total:.1f} %)")
    for name, kernel_ms in top:
        print(f"  {kernel_ms:8.2f} ms {100 * kernel_ms / total:5.1f} %  {name[:100]}")
    return {"label": label, "wall_ms": wall_ms, "kernel_ms": total, "busy_ms": busy,
            "window_ms": window, "ported_ms": ours,
            "top": [[name, kernel_ms] for name, kernel_ms in top]}


def profile_edit_forward(mixed_precision: str, frame_attention: str) -> dict:
    """One UNet forward of the cached edit's batch (:func:`edit_forward_inputs`)
    under ``torch.profiler``, with the UNet's frame attention set to
    ``frame_attention``."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    bundle = build_models(dtype=dtype, device="cuda", seed=0,
                          frame_attention=frame_attention)
    x, text, control = edit_forward_inputs(bundle)

    def forward():
        with torch.no_grad():
            bundle.unet(x, 500, text, control, {})

    rec = profile_device(forward, f"one cached edit-batch UNet forward ({mixed_precision}, "
                                  f"frame_attention={frame_attention})")
    del bundle, control
    torch.cuda.empty_cache()
    return dict(rec, dtype=mixed_precision, frame_attention=frame_attention)


def profile_null_text_step(mixed_precision: str, frame_attention: str) -> dict:
    """One null-text inner step at the main path's shape (the loss's UNet
    forward and its backward to the embedding, :func:`null_text_inputs`)
    under ``torch.profiler``, with the UNet's frame attention set to
    ``frame_attention``."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    bundle = build_models(dtype=dtype, device="cuda", seed=0,
                          frame_attention=frame_attention)
    value_and_grad = null_text_inputs(bundle)
    rec = profile_device(value_and_grad, f"one null-text inner step ({mixed_precision}, "
                                         f"frame_attention={frame_attention})")
    del bundle, value_and_grad
    torch.cuda.empty_cache()
    return dict(rec, dtype=mixed_precision, frame_attention=frame_attention)


def small_official_check(frame_attention: str, on_cpu: dict,
                         null_text_mode: str = "optimize") -> dict:
    """The tiny-model official edit (32² latents, so the attention kernels
    run at their 1024-token sites; 2 outer × 2 inner steps, "hybrid": 2 × 3)
    on the card under ``frame_attention``, against ``on_cpu``, the same edit
    on the CPU from the same weights: the final losses and the edited
    latents."""
    import copy

    from videop2p_tpu_torch.cli.run_videop2p import build_models, main
    from videop2p_tpu_torch.ops import attention as fa

    bundle = build_models(tiny=True, device="cpu", seed=3, frame_attention=frame_attention)
    gpu_bundle = copy.deepcopy(bundle)
    for mod in (gpu_bundle.unet, gpu_bundle.vae, gpu_bundle.text_encoder):
        mod.to("cuda")
    before = (fa.launch_count(), fa.flash_bwd_launch_counts())
    on_card = main(**SMALL_OFFICIAL, device="cuda", bundle=gpu_bundle,
                   null_text_mode=null_text_mode)
    after = (fa.launch_count(), fa.flash_bwd_launch_counts())
    if frame_attention == "auto" and after[0] == before[0]:
        raise AssertionError("the small official edit did not reach the frame-attention kernel")
    if frame_attention != "auto" and any(after[1][k] == before[1][k] for k in after[1]):
        raise AssertionError("the small official edit did not reach the flash backward kernels")
    want, got = on_cpu["null_text"]["final_loss"], on_card["null_text"]["final_loss"]
    scale = want.abs()
    if null_text_mode == "hybrid":
        scale = scale.clamp(min=OFFICIAL_LOSS_FLOOR)
    loss_err = ((got - want).abs() / scale).max().item()
    err = (on_card["latents"].cpu() - on_cpu["latents"]).abs().max().item()
    print(f"  small official edit ({frame_attention}, {null_text_mode}), card vs cpu: "
          f"inner steps {on_card['null_text']['inner_steps'].tolist()}, final losses "
          f"{got.tolist()} vs {want.tolist()}, max rel |d| {loss_err:.3e} (limit "
          f"{OFFICIAL_LOSS_RTOL:g}); edited latents max|d| {err:.3e} (limit {E2E_TOL:g})",
          flush=True)
    if not (on_card["null_text"]["inner_steps"].tolist()
            == on_cpu["null_text"]["inner_steps"].tolist()):
        raise AssertionError("inner steps differ between card and cpu")
    if not (loss_err <= OFFICIAL_LOSS_RTOL and err <= E2E_TOL
            and torch.isfinite(on_card["latents"]).all()):
        raise AssertionError(f"small official edit on the card disagrees with the CPU: "
                             f"{loss_err}, {err}")
    return {"loss_rel_err": loss_err, "latents_err": err}


def null_text_inputs(bundle):
    """One null-text value-and-gradient at the main path's shape (1 stream ×
    8 frames at 64², the rabbit-jump prompts, the first of 50 steps) with
    ``bundle``'s UNet, its parameters frozen: returns a function that
    computes (loss, gradient in the uncond embedding), the loss's
    conditional prediction taken once."""
    from videop2p_tpu_torch.cli.run_videop2p import encode_prompts
    from videop2p_tpu_torch.core import DDIMScheduler

    sched = DDIMScheduler.create_sd()
    t = int(sched.timesteps(50)[0])
    gen = torch.Generator(device="cuda").manual_seed(2)
    x_t = torch.randn(1, 8, 64, 64, 4, generator=gen, device="cuda")
    x_prev = x_t + 0.1 * torch.randn(1, 8, 64, 64, 4, generator=gen, device="cuda")
    for p in bundle.unet.parameters():
        p.requires_grad_(False)
    with torch.no_grad():
        cond = encode_prompts(bundle, RABBIT["prompts"][:1], "cuda").float()
        uncond = encode_prompts(bundle, [""], "cuda").float()
        eps_c = bundle.unet(x_t, t, cond).float()

    def value_and_grad():
        leaf = uncond.detach().requires_grad_(True)
        eps_u = bundle.unet(x_t, t, leaf).float()
        rec = sched.prev_step(eps_u + 7.5 * (eps_c - eps_u), t, x_t, 50)
        loss = torch.mean((rec - x_prev) ** 2)
        (grad,) = torch.autograd.grad(loss, leaf)
        return loss.item(), grad

    return value_and_grad


def null_text_grad_check(mixed_precision: str) -> dict:
    """One value-and-gradient of the null-text loss in the uncond embedding
    (:func:`null_text_inputs`) under "auto", "flash_rect" and "flash",
    against the same gradient in float32 through the plain version
    ("chunked"), from the same weights and inputs."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models
    from videop2p_tpu_torch.ops import attention as fa

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    ref_loss, ref = null_text_inputs(build_models(device="cuda", seed=0,
                                                  frame_attention="chunked"))()
    torch.cuda.empty_cache()
    scale = ref.abs().max().item()
    impls = ("auto", "flash_rect", "flash") + (("chunked",) if dtype != torch.float32 else ())
    errs, losses = {}, {}
    for impl in impls:
        bundle = build_models(dtype=dtype, device="cuda", seed=0, frame_attention=impl)
        before = fa.flash_bwd_launch_counts()
        losses[impl], grad = null_text_inputs(bundle)()
        after = fa.flash_bwd_launch_counts()
        del bundle
        torch.cuda.empty_cache()
        launched = {k: after[k] - before[k] for k in after}
        want = ATTN_GRAD_SITES if impl.startswith("flash") else 0
        if any(n != want for n in launched.values()):
            raise AssertionError(f"{impl}: flash backward launches {launched}, expected {want}")
        if not torch.isfinite(grad).all():
            raise AssertionError(f"{impl} gradient is not finite")
        errs[impl] = (grad - ref).abs().max().item()
        print(f"  {impl} ({mixed_precision}) against chunked (fp32): loss {losses[impl]:.6e} "
              f"(ref {ref_loss:.6e}), max|d| of the gradient {errs[impl]:.4e} "
              f"(max|ref| {scale:.4e})", flush=True)
    tol = (GRAD_REL_TOL_F32 * scale if dtype == torch.float32
           else BF16_FWD_RATIO * errs["chunked"])
    print(f"  limit {tol:.4e}", flush=True)
    bad = {impl: err for impl, err in errs.items() if not err <= tol}
    if bad:
        raise AssertionError(f"null-text gradient off the plain version: {bad} (limit {tol})")
    return {"dtype": mixed_precision, "max_abs_ref": scale, "max_abs_err": errs, "tol": tol,
            "loss": losses, "ref_loss": ref_loss}


def reset_launch_counts() -> None:
    """Every kernel's launch count set to 0."""
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    fa.reset_launch_count()
    gn.reset_launch_count()
    fa.reset_flash_launch_count()
    fa.reset_flash_bwd_launch_counts()


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launch_counts`."""
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    bwd = fa.flash_bwd_launch_counts()
    return {"frame_attention": fa.launch_count(), "group_norm": gn.launch_count(),
            "flash_attention": fa.flash_launch_count(),
            "flash_bwd_dkv": bwd["dkv"], "flash_bwd_dq": bwd["dq"]}


def run_main_path(frames, steps: int, mixed_precision: str, *, fast: bool = True,
                  keep_outputs: bool = False, keep_videos: bool = False, **kw) -> dict:
    """One edit through ``cli.run_videop2p.main`` with every launch count set
    to 0 just before and read just after; checks the output and, for the
    cached-source path, src_err == 0.0 exactly. ``keep_outputs`` also
    returns x_T and the uint8 frames a GIF would hold (the caller deletes
    them with the latents); ``keep_videos`` the decoded [0, 1] videos."""
    from videop2p_tpu_torch.cli.run_videop2p import main as run_edit

    # every run a fresh one unless a phase asks for persisted reuse: a
    # reused inversion would drop launches and time from its counts
    kw.setdefault("reuse_inversion", False)
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_edit(**{**RABBIT, **kw}, fast=fast, device="cuda",
                   mixed_precision=mixed_precision, width=512, video_len=8,
                   num_ddim_steps=steps, frames=frames, save_gifs=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # the CLI resets the peak at each phase and records it
    peak = max(res["peak_gib"].values())
    videos = res["videos"]
    src_err = (res["latents"][0] - res["x_0"][0]).abs().max().item()
    print(f"  {res['mode']} source, {steps} steps, {mixed_precision}: {wall:.2f} s; "
          "phases (s) " + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()),
          flush=True)
    if res["cached_maps"] is not None:
        cm = res["cached_maps"]
        print(f"  cached maps: {cm['gib']:.3f} GiB against a budget of "
              f"{cm['budget_gib']:.1f} GiB, temporal maps stored "
              f"{cm['temporal_maps_dtype']}, cross window {cm['cross_len']} steps, "
              f"self window {tuple(cm['self_window'])}", flush=True)
    null_text = None
    if res["null_text"] is not None:
        # (with telemetry the record also holds the latent statistics)
        null_text = {k: v.tolist() for k, v in res["null_text"].items()
                     if isinstance(v, torch.Tensor)}
        print(f"  null-text: inner steps {null_text['inner_steps']}, final losses "
              f"{null_text['final_loss']}", flush=True)
    print(f"  launches: {launches}; peak memory {peak:.2f} GiB (by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in res["peak_gib"].items())
          + f"); src_err {src_err!r}", flush=True)
    if tuple(videos.shape) != (2, 8, 512, 512, 3):
        raise AssertionError(f"output shape {tuple(videos.shape)}")
    if not torch.isfinite(videos).all():
        raise AssertionError("non-finite output video")
    if res["mode"] == "cached" and src_err != 0.0:
        raise AssertionError(f"cached source stream is not x_0: src_err {src_err!r}")
    return {"mode": res["mode"], "steps": steps, "dtype": mixed_precision, "wall_s": wall,
            "timings": res["timings"], "launches": launches, "peak_gib": peak,
            "peak_gib_by_phase": res["peak_gib"], "null_text": null_text,
            "src_err": src_err, "cached_maps": res["cached_maps"],
            "reused": res["reused"], "unet_bytes": res["unet_bytes"],
            "checkpoint_dir": res["checkpoint_dir"], "latents": res["latents"],
            "ledger": res["ledger"], "sidecar": res["sidecar"], "report": res["report"],
            **({"x_t": res["x_t"],
                "frames_u8": (videos.clamp(0, 1) * 255).to(torch.uint8).cpu()}
               if keep_outputs else {}),
            **({"videos": videos} if keep_videos else {})}


def expect_launches(run: dict, steps: int, frame_attention: str, *,
                    hybrid: bool = False, edit_only: bool = False) -> None:
    """The launch counts of one main-path run: ATTN_SITES frame-attention
    launches per UNet forward on the chosen kernel (none on the other),
    GroupNorm one per site. A fast edit runs one forward per inversion
    and per edit step. Official mode also runs, per null-text outer step,
    the cond forward, one forward per inner step and the advancing forward;
    each inner step's backward launches the flash dK/dV and dQ kernels at
    the ATTN_GRAD_SITES sites that depend on the embedding (under "flash"
    and "flash_rect"; "auto" recomputes through the plain version).
    "hybrid" null-text runs no advancing forward (its outer steps start
    from the recorded trajectory); ``edit_only``: a run that reused its
    persisted inversion and null-text embeddings runs the edit's forwards
    only."""
    inner = sum(run["null_text"]["inner_steps"]) if run["null_text"] else 0
    null_forwards = (steps if hybrid else 2 * steps) + inner if run["null_text"] else 0
    forwards = steps if edit_only else 2 * steps + null_forwards
    want = {"frame_attention": 0, "flash_attention": 0,
            "group_norm": GN_LAUNCHES_PER_CALL * GN_SITES * forwards,
            "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    kernel = {"auto": "frame_attention", "flash": "flash_attention",
              "flash_rect": "flash_attention"}[frame_attention]
    want[kernel] = ATTN_SITES * forwards
    if frame_attention != "auto":
        want["flash_bwd_dkv"] = want["flash_bwd_dq"] = ATTN_GRAD_SITES * inner
    if run["launches"] != want:
        raise AssertionError(f"kernel launches {run['launches']}, expected {want}")


def fast_paths(args, frames, dtype, checks: dict) -> tuple:
    """Phases 4-9: the fast edit's paths. Returns (runs, failures, records)."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models

    # 4. small edits, card against cpu
    print("small edit:", flush=True)
    small_err = {mode: small_edit_check(live_source=mode == "live")
                 for mode in ("cached", "live")}
    # 5. the main path: the cached-source fast edit, "auto" frame attention,
    # after one untimed 1-step edit that takes the first-call costs
    # (cuDNN's algorithm choice, allocator growth)
    print("main path (SD-1.5 width, 512², 8 frames):", flush=True)
    run_main_path(frames, 1, args.mixed_precision)
    runs = {"auto": run_main_path(frames, args.steps, args.mixed_precision)}
    if runs["auto"]["mode"] != "cached":
        raise AssertionError("the main path did not take the cached-source edit")
    expect_launches(runs["auto"], args.steps, "auto")
    # 6. the live-source path
    runs["live"] = run_main_path(frames, args.steps, args.mixed_precision, live_source=True)
    expect_launches(runs["live"], args.steps, "auto")
    # 7. the cached edit through the flash kernel, same seed and weights;
    # both variants run before a disagreement fails the script
    gate = dtype == torch.float32 and args.steps <= E2E_GATE_STEPS
    failures = []
    for impl in ("flash_rect", "flash"):
        bundle = build_models(dtype=dtype, device="cuda", seed=0, frame_attention=impl)
        runs[impl] = run_main_path(frames, args.steps, args.mixed_precision, bundle=bundle)
        del bundle
        expect_launches(runs[impl], args.steps, impl)
        d = (runs[impl]["latents"] - runs["auto"]["latents"]).abs()
        diff = runs[impl]["max_abs_diff_vs_auto"] = d.max().item()
        runs[impl]["mean_abs_diff_vs_auto"] = d.mean().item()
        print(f"  {impl} against auto: edited latents max|d| {diff:.4e}, "
              f"mean|d| {d.mean().item():.4e}"
              + (f" (limit {E2E_TOL:g})" if gate else " (not gated)"), flush=True)
        if not np.isfinite(diff):
            failures.append(f"{impl} edit is not finite")
        elif gate and diff > E2E_TOL:
            failures.append(f"{impl} edit differs from the auto edit by {diff} "
                            f"(limit {E2E_TOL})")
    for run in runs.values():
        del run["latents"]
    torch.cuda.empty_cache()
    # 8. one edit-batch forward under each kernel against the plain version
    print("cached edit-batch forward against the plain version:", flush=True)
    forward = forward_check(args.mixed_precision)
    # 9. profile
    profiled = ([profile_edit_forward(args.mixed_precision, impl)
                 for impl in args.frame_attention] if args.profile else None)
    return runs, failures, {"small_edit_err": small_err, "forward": forward,
                            "profile": profiled}


def official_paths(args, frames, dtype) -> tuple:
    """Phases 4b and 10 (path "official"), 11 and 12 (path
    "official_flash"). Returns (runs, failures, records)."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models, main as run_edit

    runs, failures, records = {}, [], {}
    if "official" in args.paths:
        # 4b. the small official edit, card against cpu
        print("small official edit:", flush=True)
        records["small_official"] = {}
        for mode in ("optimize", "hybrid"):
            on_cpu = run_edit(**SMALL_OFFICIAL, device="cpu", null_text_mode=mode,
                              bundle=build_models(tiny=True, device="cpu", seed=3))
            records["small_official"][mode] = {
                impl: small_official_check(impl, on_cpu, mode)
                for impl in ("auto", "flash_rect")}
        # 10. the official main path, after an untimed 1-step, 1-inner-step run
        print(f"official main path (SD-1.5 width, 512², 8 frames, "
              f"{args.inner_steps} inner steps):", flush=True)
        run_main_path(frames, 1, args.mixed_precision, fast=False, num_inner_steps=1)
        runs["official"] = run_main_path(frames, args.steps, args.mixed_precision,
                                         fast=False, num_inner_steps=args.inner_steps)
        expect_launches(runs["official"], args.steps, "auto")
        peak = runs["official"]["peak_gib_by_phase"]["null_text_optimization"]
        print(f"  \"auto\" null-text peak {peak:.2f} GiB ({args.steps} steps); PERF.md's "
              f"from before the fused backward recomputed chunk by chunk (4 steps): "
              f"{AUTO_NULL_TEXT_PEAK_BEFORE_GIB[args.mixed_precision]:.2f} GiB", flush=True)
    if "official_flash" in args.paths:
        # 11. the official path through the flash kernels, fewer inner steps,
        # against "auto" at the same count; all three run before a failure
        print(f"official path under each kernel ({FLASH_INNER_STEPS} inner steps):",
              flush=True)
        for impl in ("auto", "flash_rect", "flash"):
            bundle = build_models(dtype=dtype, device="cuda", seed=0, frame_attention=impl)
            run = runs[f"official_{impl}"] = run_main_path(
                frames, args.steps, args.mixed_precision, fast=False, bundle=bundle,
                num_inner_steps=FLASH_INNER_STEPS)
            del bundle
            expect_launches(run, args.steps, impl)
            if impl == "auto":
                continue
            ref = runs["official_auto"]
            loss_d = max(abs(a - b) / abs(b) for a, b in zip(
                run["null_text"]["final_loss"], ref["null_text"]["final_loss"]))
            d = (run["latents"] - ref["latents"]).abs()
            run["final_loss_rel_diff_vs_auto"] = loss_d
            run["max_abs_diff_vs_auto"] = d.max().item()
            print(f"  {impl} against auto: final losses max rel |d| {loss_d:.4e}; edited "
                  f"latents max|d| {d.max().item():.4e}, mean|d| {d.mean().item():.4e} "
                  "(not gated: phase 12 holds the gradient)", flush=True)
            if not np.isfinite(d.max().item()):
                failures.append(f"official {impl} edit is not finite")
        # 12. one full-CFG edit-batch forward and one null-text gradient under
        # each kernel against the plain version
        print("full-CFG edit-batch forward against the plain version:", flush=True)
        records["forward_full_cfg"] = forward_check(args.mixed_precision, full_cfg=True)
        print("null-text gradient against the plain version:", flush=True)
        records["null_text_grad"] = null_text_grad_check(args.mixed_precision)
    if args.profile and "official" in args.paths:
        records["profile_null_text"] = [profile_null_text_step(args.mixed_precision, impl)
                                        for impl in args.frame_attention]
    for run in runs.values():
        del run["latents"]
    torch.cuda.empty_cache()
    return runs, failures, records


def sampler_check() -> dict:
    """Phase 13a: the dependent-noise sampler on the card. Its transform of
    normals drawn on the CPU against the CPU's transform of the same
    normals; the empirical covariance of SAMPLER_VECTORS frame vectors drawn
    with a CUDA generator against ``joint_cov()``; the device time of one
    draw at the main path's latent shape."""
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler

    kw = dict(num_frames=8, decay_rate=DEPENDENT["decay_rate"],
              window_size=DEPENDENT["window_size"], ar_sample=DEPENDENT["ar_sample"],
              ar_coeff=DEPENDENT["ar_coeff"])
    cpu = DependentNoiseSampler.create(**kw)
    card = DependentNoiseSampler.create(**kw, device="cuda")
    z = torch.randn((1, 64, 64, 4, card.num_windows, card.window_size),
                    generator=torch.Generator().manual_seed(0))
    err = (card.transform(z.cuda()).cpu() - cpu.transform(z)).abs().max().item()
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = card.sample((SAMPLER_VECTORS, 8), gen).double()
    cov_err = float(np.abs((draws.T @ draws / SAMPLER_VECTORS).cpu().numpy()
                           - card.joint_cov()).max())
    shape = (1, 8, 64, 64, 4)
    draw_ms = time_ms(lambda: card.sample(shape, gen))
    print(f"  sampler: transform on the card against the CPU max|d| {err:.3e} (limit "
          f"{SAMPLER_TOL:g}); covariance of {SAMPLER_VECTORS} draws max|d| {cov_err:.4e} "
          f"(limit {COV_TOL:g}); one draw at {shape}: {draw_ms:.4f} ms", flush=True)
    if not err <= SAMPLER_TOL:
        raise AssertionError(f"sampler transform on the card off the CPU's by {err}")
    if not cov_err <= COV_TOL:
        raise AssertionError(f"sampler covariance off the closed form by {cov_err}")
    return {"transform_max_abs_err": err, "cov_max_abs_err": cov_err,
            "vectors": SAMPLER_VECTORS, "draw_shape": list(shape), "draw_ms": draw_ms}


def dependent_paths(args, frames) -> tuple:
    """Phase 13 (path "dependent"): the sampler on the card, then the main
    path with ``--dependent_p2p`` and DEPENDENT's settings: the cached fast
    edit in turns with the plain one (plain, dependent, dependent, plain),
    the same with ``dependent_weights`` 0, the live-source edit with η 0.1,
    and the official path with 2 inner steps. Returns (runs, records)."""
    print("dependent noise (--dependent_p2p, decay 0.3, windows of 4, AR 0.1, "
          "weight 0.2):", flush=True)
    records = {"sampler": sampler_check()}
    steps, mp = args.steps, args.mixed_precision
    turns = [run_main_path(frames, steps, mp, **(DEPENDENT if dep else {}))
             for dep in (False, True, True, False)]
    for run in turns:
        expect_launches(run, steps, "auto")
        if run["mode"] != "cached":
            raise AssertionError("the dependent fast edit did not take the cached source")
    plain, dep = turns[0], turns[1]
    moved = (dep["latents"] - plain["latents"]).abs().max().item()
    repeat = (turns[2]["latents"] - dep["latents"]).abs().max().item()
    zero = run_main_path(frames, steps, mp, **dict(DEPENDENT, dependent_weights=0.0))
    zero_d = (zero["latents"] - plain["latents"]).abs().max().item()
    walls = {"plain": [turns[0]["wall_s"], turns[3]["wall_s"]],
             "dependent": [turns[1]["wall_s"], turns[2]["wall_s"]]}
    print(f"  cached edit wall (s), in turns: plain {walls['plain']}, dependent "
          f"{walls['dependent']}; dependent against plain max|d| {moved:.4e}, dependent "
          f"repeat max|d| {repeat!r}, weight 0 against plain max|d| {zero_d!r}", flush=True)
    if not moved > 0:
        raise AssertionError("the dependent edit equals the plain edit")
    if zero_d != 0.0:
        raise AssertionError(f"dependent_weights 0 differs from the plain edit by {zero_d}")
    runs = {"dependent_cached": dep}
    runs["dependent_live"] = run_main_path(frames, steps, mp, live_source=True, eta=0.1,
                                           **DEPENDENT)
    expect_launches(runs["dependent_live"], steps, "auto")
    runs["dependent_official"] = run_main_path(frames, steps, mp, fast=False,
                                               num_inner_steps=FLASH_INNER_STEPS,
                                               **DEPENDENT)
    expect_launches(runs["dependent_official"], steps, "auto")
    records["dependent_cached_edit"] = {"wall_s": walls, "max_abs_diff_vs_plain": moved,
                                        "repeat_max_abs_diff": repeat,
                                        "weight0_max_abs_diff_vs_plain": zero_d}
    for run in runs.values():
        del run["latents"]
    del turns, zero
    torch.cuda.empty_cache()
    return runs, records


class _HostPeak:
    """The peak resident set of this process while the block runs
    (``/proc/self/statm``, sampled every 5 ms), in bytes."""

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page

    def _poll(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def write_checkpoint(ckpt: str, bundle) -> int:
    """``bundle`` as a diffusers-layout checkpoint directory: the UNet
    through ``save_pipeline`` with the bundle's scheduler config, ``vae/``
    and ``text_encoder/`` under their diffusers / transformers names.
    Returns the bytes written."""
    import os

    from videop2p_tpu_torch.models import convert
    from videop2p_tpu_torch.models.pipeline_io import save_pipeline

    nbytes = save_pipeline(ckpt, bundle.unet.config, bundle.unet.state_dict(),
                           scheduler_config=bundle.scheduler_config)
    vcfg = bundle.vae.config
    for sub, cfg, sd, name in (
            ("vae", {"in_channels": vcfg.in_channels, "out_channels": vcfg.out_channels,
                     "latent_channels": vcfg.latent_channels,
                     "block_out_channels": list(vcfg.block_out_channels),
                     "layers_per_block": vcfg.layers_per_block,
                     "norm_num_groups": vcfg.norm_num_groups,
                     "scaling_factor": vcfg.scaling_factor},
             bundle.vae.state_dict(), "diffusion_pytorch_model.safetensors"),
            ("text_encoder", dict(vars(bundle.text_encoder.config)),
             convert.clip_state_dict_to_transformers(bundle.text_encoder.state_dict()),
             "model.safetensors")):
        os.makedirs(os.path.join(ckpt, sub))
        with open(os.path.join(ckpt, sub, "config.json"), "w") as fh:
            json.dump(cfg, fh)
        nbytes += convert.save_safetensors(sd, os.path.join(ckpt, sub, name))
    return nbytes


def checkpoint_path(args, frames, dtype) -> tuple:
    """Phase 14 (path "checkpoint"): the seeded SD-1.5 bundle written as a
    tuned 3-D checkpoint under ``<tmp>/rabbit-jump`` + the Stage-1 suffix of
    DEPENDENT's settings (the UNet through ``save_pipeline`` with the SD
    scheduler config, ``steps_offset`` 1; ``vae/`` and ``text_encoder/``
    under their diffusers / transformers names), then ``main`` on
    ``<tmp>/rabbit-jump`` with DEPENDENT's flags: it must resolve the
    suffixed directory and load it, and its edited latents must equal, bit
    for bit, the same run from the in-memory bundle with the same scheduler
    config. The directory is deleted afterwards, also on a failure. Returns
    (runs, records)."""
    import os
    import shutil
    import tempfile

    from videop2p_tpu_torch.cli.common import ModelBundle, build_models, dependent_suffix

    print("checkpoint directory (SD-1.5 width, written, resolved, loaded):", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_", dir="outputs")
    try:
        bundle = build_models(dtype=dtype, device="cuda", seed=0)
        bundle = ModelBundle(unet=bundle.unet, vae=bundle.vae,
                             text_encoder=bundle.text_encoder,
                             scheduler_config=dict(SD_SCHEDULER_CONFIG))
        base = os.path.join(tmp, "rabbit-jump")
        suffix_kw = {k: v for k, v in DEPENDENT.items() if k != "dependent_p2p"}
        ckpt = base + dependent_suffix(eta=0.0, **suffix_kw)
        t0 = time.perf_counter()
        nbytes = write_checkpoint(ckpt, bundle)
        write_s = time.perf_counter() - t0
        with _HostPeak() as host:
            loaded = run_main_path(frames, args.steps, args.mixed_precision,
                                   pretrained_model_path=base, **DEPENDENT)
        expect_launches(loaded, args.steps, "auto")
        if loaded["checkpoint_dir"] != ckpt:
            raise AssertionError(f"main resolved {loaded['checkpoint_dir']!r}, not {ckpt!r}")
        if "build_models" not in loaded["timings"]:
            raise AssertionError("main did not load the checkpoint")
        memory = run_main_path(frames, args.steps, args.mixed_precision, bundle=bundle,
                               **DEPENDENT)
        diff = (loaded["latents"] - memory["latents"]).abs().max().item()
        rec = {"dir": ckpt, "bytes_written": nbytes, "bytes_read": nbytes,
               "write_s": write_s, "load_s": loaded["timings"]["build_models"],
               "host_before_gib": host.start / 2 ** 30, "host_peak_gib": host.peak / 2 ** 30,
               "device_peak_gib": loaded["peak_gib_by_phase"]["build_models"],
               "max_abs_diff_vs_memory": diff}
        print(f"  wrote {nbytes / 1e9:.3f} GB in {write_s:.2f} s; loaded (read "
              f"{nbytes / 1e9:.3f} GB) in {rec['load_s']:.2f} s, host resident "
              f"{rec['host_before_gib']:.2f} → peak {rec['host_peak_gib']:.2f} GiB, device peak {rec['device_peak_gib']:.2f} GiB; "
              f"edited latents against the in-memory run max|d| {diff!r}", flush=True)
        if diff != 0.0:
            raise AssertionError(f"the checkpoint run differs from the in-memory run by {diff}")
        del loaded["latents"], memory, bundle
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"checkpoint": loaded}, {"checkpoint": rec}


def _step_launches(unet, deep_mode: str, deep_feature=None):
    """The kernels one UNet forward of the cached edit's batch (1 uncond + 1
    edit stream × 8 frames at 64²) launches under ``deep_mode``; returns
    (launches, the deep feature of a "capture")."""
    x = torch.randn(2, 8, 64, 64, 4, generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda")
    text = torch.zeros(2, 77, 768, device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        out = unet(x, 500, text, deep_mode=deep_mode, deep_feature=deep_feature)
    torch.cuda.synchronize()
    return launch_counts(), (out[1] if deep_mode == "capture" else None)


def _drop_outputs(*runs) -> None:
    for run in runs:
        for key in ("latents", "x_t", "frames_u8"):
            run.pop(key, None)


def surface_path(args, frames) -> tuple:
    """Phase 16 (path "surface"): the rest of Stage 2's surface through
    ``main`` at SD-1.5 width, 512², 8 frames, ``--steps``: (a) "hybrid"
    null-text under "auto" and "flash_rect" in float32; (b) persisted
    inversion reuse on a float32 checkpoint directory; (c) ``--multi``;
    (d) ``--quant_mode`` w8 and w8a8 beside off; (e) ``--reuse_schedule``
    uniform:2 beside off. Returns (runs, records)."""
    import os
    import shutil
    import tempfile

    from videop2p_tpu_torch.cli.common import ModelBundle, build_models

    steps, mp = args.steps, args.mixed_precision
    runs, records = {}, {}
    # a. hybrid null-text, each kernel in turn
    print(f"surface: hybrid null-text ({HYBRID_INNER_STEPS} Adam steps an outer step, "
          "fp32):", flush=True)
    for impl in ("auto", "flash_rect"):
        bundle = (None if impl == "auto" else
                  build_models(dtype=torch.float32, device="cuda", seed=0,
                               frame_attention=impl))
        run = runs[f"surface_hybrid_{impl}"] = run_main_path(
            frames, steps, "fp32", fast=False, null_text_mode="hybrid", bundle=bundle,
            keep_outputs=True)
        del bundle
        if run["null_text"]["inner_steps"] != [HYBRID_INNER_STEPS] * steps:
            raise AssertionError(f"hybrid inner steps {run['null_text']['inner_steps']}")
        expect_launches(run, steps, impl, hybrid=True)
    auto, rect = runs["surface_hybrid_auto"], runs["surface_hybrid_flash_rect"]
    loss_d = max(abs(a - b) / max(abs(b), OFFICIAL_LOSS_FLOOR) for a, b in zip(
        rect["null_text"]["final_loss"], auto["null_text"]["final_loss"]))
    lat_d = (rect["latents"] - auto["latents"]).abs().max().item()
    records["surface_hybrid"] = {"final_loss_rel_diff": loss_d, "latents_max_abs_diff": lat_d}
    print(f"  flash_rect against auto: final losses max rel |d| {loss_d:.4e}; edited "
          f"latents max|d| {lat_d:.4e} (not gated: phase 12 holds the gradient)",
          flush=True)
    _drop_outputs(auto, rect)

    # b. fault 7 first: which operations of a null-text step sum in an order
    # that varies; then persisted reuse, from a checkpoint directory (reuse
    # is off for an in-memory bundle)
    print("surface: determinism of a null-text inner step (fp32):", flush=True)
    records["determinism"] = determinism_probe()
    print(f"surface: persisted inversion reuse (official, {REUSE_INNER_STEPS} inner "
          "steps, a float32 checkpoint directory):", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_surface_", dir="outputs")
    try:
        seeded = build_models(dtype=torch.float32, device="cuda", seed=0)
        base = os.path.join(tmp, "rabbit-jump")
        write_checkpoint(base, ModelBundle(unet=seeded.unet, vae=seeded.vae,
                                           text_encoder=seeded.text_encoder,
                                           scheduler_config=dict(SD_SCHEDULER_CONFIG)))
        del seeded
        torch.cuda.empty_cache()
        kw = dict(fast=False, num_inner_steps=REUSE_INNER_STEPS, pretrained_model_path=base,
                  reuse_inversion=True, keep_outputs=True)
        first = runs["surface_reuse_first"] = run_main_path(frames, steps, "fp32", **kw)
        expect_launches(first, steps, "auto")
        repeat = runs["surface_reuse_repeat"] = run_main_path(frames, steps, "fp32", **kw)
        expect_launches(repeat, steps, "auto", edit_only=True)
        skipped = {"ddim_inversion", "null_text_optimization"} & set(repeat["timings"])
        same = (torch.equal(repeat["frames_u8"], first["frames_u8"])
                and torch.equal(repeat["latents"], first["latents"]))
        print(f"  repeat: reused {repeat['reused']}, phases {list(repeat['timings'])}, "
              f"frames bit for bit the first run's: {same}", flush=True)
        if repeat["reused"] != {"trajectory": True, "null_text": True} or skipped:
            raise AssertionError(f"the repeat run did not reuse both products: "
                                 f"{repeat['reused']}, ran {skipped}")
        if not same:
            raise AssertionError("the repeat run's output differs from the first run's")
        store = os.path.join(tmp, "store")
        cached = runs["surface_reuse_cached"] = run_main_path(
            frames, steps, "fp32", pretrained_model_path=base, reuse_inversion=True,
            inv_store=store, keep_outputs=True)
        expect_launches(cached, steps, "auto")
        after = runs["surface_reuse_after_cached"] = run_main_path(
            frames, steps, "fp32", inv_store=store, **kw)
        inner = sum(after["null_text"]["inner_steps"]) if after["null_text"] else 0
        print(f"  official after a cached run: reused {after['reused']}, phases "
              f"{list(after['timings'])}, launches {after['launches']}", flush=True)
        if (after["reused"] != {"trajectory": True, "null_text": False}
                or "ddim_inversion" in after["timings"]
                or "null_text_optimization" not in after["timings"]
                or not torch.equal(after["x_t"], cached["x_t"])):
            raise AssertionError("the official run did not take the cached run's trajectory")
        # inversion skipped: the null-text phase and the edit's forwards
        want_gn = GN_SITES * (steps + 2 * steps + inner)
        if after["launches"]["group_norm"] != want_gn:
            raise AssertionError(f"GroupNorm launches {after['launches']['group_norm']}, "
                                 f"expected {want_gn}")
        fresh = runs["surface_reuse_off"] = run_main_path(
            frames, steps, "fp32", **dict(kw, reuse_inversion=False))
        expect_launches(fresh, steps, "auto")
        recomputed = {"ddim_inversion", "null_text_optimization"} <= set(fresh["timings"])
        d = (fresh["latents"] - first["latents"]).abs().max().item()
        # fault 7: two recomputed official runs of one clip give the same bits
        reproduced = torch.equal(fresh["latents"], first["latents"])
        null_s = [r["timings"]["null_text_optimization"] for r in (first, fresh)]
        print(f"  --no_reuse_inversion: reused {fresh['reused']}, both phases run: "
              f"{recomputed}; against the first run max|d| {d!r}, the same bits: "
              f"{reproduced}; null-text phase {null_s[0]:.3f}, {null_s[1]:.3f} s "
              f"(deterministic convolutions; before: "
              f"{', '.join(f'{v:.3f}' for v in NULL_TEXT_S_BEFORE_DETERMINISM)} s)",
              flush=True)
        if fresh["reused"] != {"trajectory": False, "null_text": False} or not recomputed:
            raise AssertionError("--no_reuse_inversion did not recompute")
        if not reproduced:
            raise AssertionError(f"two recomputed official runs differ: max|d| {d!r}")
        records["surface_reuse"] = {
            "walls_s": {k: runs[f"surface_reuse_{k}"]["wall_s"]
                        for k in ("first", "repeat", "cached", "after_cached", "off")},
            "repeat_bit_identical": same, "off_max_abs_diff_vs_first": d,
            "off_bit_identical": reproduced, "null_text_s": null_s,
            "null_text_s_before_determinism": list(NULL_TEXT_S_BEFORE_DETERMINISM)}
        _drop_outputs(first, repeat, cached, after, fresh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # c. per-frame conditioning
    print("surface: --multi (cached fast edit):", flush=True)
    runs["surface_multi"] = run_main_path(frames, steps, mp, multi=True)
    if runs["surface_multi"]["mode"] != "cached":
        raise AssertionError("the multi edit did not take the cached source")
    expect_launches(runs["surface_multi"], steps, "auto")

    # d. weight quantization beside off
    print("surface: --quant_mode (cached fast edits):", flush=True)
    quant = {}
    for mode in ("off", "w8", "w8a8"):
        run = runs[f"surface_quant_{mode}"] = run_main_path(frames, steps, mp,
                                                            quant_mode=mode)
        expect_launches(run, steps, "auto")
        quant[mode] = {"unet_bytes": run["unet_bytes"], "peak_gib": run["peak_gib"],
                       "wall_s": run["wall_s"]}
        if mode != "off":
            quant[mode]["max_abs_diff_vs_off"] = (
                run["latents"] - runs["surface_quant_off"]["latents"]).abs().max().item()
        print(f"  {mode}: UNet weights on the card {run['unet_bytes'] / 1e9:.3f} GB "
              f"({run['unet_bytes'] / runs['surface_quant_off']['unet_bytes']:.3f} of off), "
              f"peak {run['peak_gib']:.2f} GiB, wall {run['wall_s']:.2f} s"
              + (f", edited latents against off max|d| {quant[mode]['max_abs_diff_vs_off']:.4e}"
                 if mode != "off" else ""), flush=True)
    records["surface_quant"] = quant
    _drop_outputs(*(runs[f"surface_quant_{m}"] for m in ("off", "w8", "w8a8")))

    # e. deep-feature reuse beside off, one full and one shallow step first
    print(f"surface: --reuse_schedule {REUSE_SCHEDULE} (cached fast edit):", flush=True)
    bundle = build_models(dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[mp],
                          device="cuda", seed=0)
    full_step, deep = _step_launches(bundle.unet, "capture")
    shallow_step, _ = _step_launches(bundle.unet, "shallow", deep)
    del bundle, deep
    torch.cuda.empty_cache()
    print(f"  one full step: {full_step}; one shallow step: {shallow_step}", flush=True)
    if (full_step["frame_attention"], full_step["group_norm"]) != (ATTN_SITES, GN_SITES) or (
            shallow_step["frame_attention"], shallow_step["group_norm"]) != (
            SHALLOW_ATTN_SITES, SHALLOW_GN_SITES):
        raise AssertionError("a full or shallow step's launches are off their sites")
    off = runs["surface_reuse_schedule_off"] = run_main_path(frames, steps, mp)
    sched = runs["surface_reuse_schedule"] = run_main_path(frames, steps, mp,
                                                           reuse_schedule=REUSE_SCHEDULE)
    from videop2p_tpu_torch.pipelines.reuse import parse_reuse_schedule

    full = sum(parse_reuse_schedule(REUSE_SCHEDULE, steps))
    want = {k: steps * full_step[k] + full * full_step[k] + (steps - full) * shallow_step[k]
            for k in full_step}
    if sched["launches"] != want:
        raise AssertionError(f"reuse-schedule launches {sched['launches']}, expected {want}")
    d = (sched["latents"] - off["latents"]).abs().max().item()
    records["surface_reuse_schedule"] = {
        "full_step_launches": full_step, "shallow_step_launches": shallow_step,
        "wall_s": sched["wall_s"], "off_wall_s": off["wall_s"],
        "edit_s": sched["timings"]["cached_invert_edit"],
        "off_edit_s": off["timings"]["cached_invert_edit"], "max_abs_diff_vs_off": d}
    print(f"  {full} full + {steps - full} shallow edit steps: wall {sched['wall_s']:.2f} s "
          f"(off {off['wall_s']:.2f} s), cached_invert_edit "
          f"{sched['timings']['cached_invert_edit']:.3f} s (off "
          f"{off['timings']['cached_invert_edit']:.3f} s); edited latents against off "
          f"max|d| {d:.4e}", flush=True)
    _drop_outputs(off, sched, runs["surface_multi"])
    torch.cuda.empty_cache()
    return runs, records


class _GradRecorder:
    """Wraps the tuner's optimizer and keeps the gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update_(self, params, grads, state):
        self.grads.append([g.detach().clone() for g in grads])
        return self.tx.update_(params, grads, state)


@contextlib.contextmanager
def plain_group_norm():
    """The UNet's GroupNorm sites through the plain version on the card (its
    autograd through plain PyTorch ops) for the block."""
    from videop2p_tpu_torch.models import layers
    from videop2p_tpu_torch.ops import groupnorm as gn

    kernel = layers.fused_group_norm
    layers.fused_group_norm = gn.group_norm_reference
    try:
        yield
    finally:
        layers.fused_group_norm = kernel


def tune_step_checks(profile: bool) -> dict:
    """One Stage-1 train step at SD-1.5 width (8 frames, 64² latents, the
    rabbit prompt, fixed noise and timestep 500), from the seeded weights:
    its pre-clip gradients in float32 with the GroupNorm kernel against the
    plain version, and with the blocks recomputed against without (both
    within TUNE_GRAD_REL_TOL·max|ref|, whether the bits are equal printed),
    and one bf16 step's under REMAT_POLICY against full recompute (bit for
    bit); then TUNE_TIMED_STEPS steps of each of bf16 / fp32 × checkpointed
    blocks on / off, and bf16 under REMAT_POLICY, each step's wall time
    (synchronised), the median of
    steps 2 on and the peak memory, the frozen weights held bit for bit and
    the trainable ones moved; with ``profile`` one bf16 checkpointed step
    under ``torch.profiler``. The weights are restored after every step."""
    import contextlib as ctx
    import dataclasses

    from videop2p_tpu_torch.cli.common import build_models, encode_prompts
    from videop2p_tpu_torch.cli.run_tuning import deterministic_convolutions
    from videop2p_tpu_torch.core import DDPMScheduler
    from videop2p_tpu_torch.ops import groupnorm as gn
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import (
        TrainState,
        TuneConfig,
        make_optimizer,
        step_generator,
        train_step,
    )

    bundle = build_models(dtype=torch.float32, device="cuda", seed=0,
                          frame_attention="chunked")
    unet, fn = bundle.unet, make_unet_fn(bundle.unet)
    text = encode_prompts(bundle, [TUNE["train_data"]["prompt"]], "cuda")
    del bundle
    gen = torch.Generator("cuda").manual_seed(0)
    latents = 0.8 * torch.randn((1, 8, 64, 64, 4), generator=gen, device="cuda")
    noise = torch.randn(latents.shape, generator=gen, device="cuda")
    timesteps = torch.tensor([500], device="cuda")
    sched, cfg = DDPMScheduler.create_sd(), TuneConfig(learning_rate=TUNE["learning_rate"])
    # the weights to restore after each step, on the host: a copy on the
    # card would add 3.4 GiB to every peak below
    start = {k: v.detach().to("cpu", copy=True) for k, v in unet.state_dict().items()}

    def configure(remat: bool, dtype, policy=None) -> None:
        unet.config = dataclasses.replace(unet.config, gradient_checkpointing=remat,
                                          remat_policy=policy)
        unet.compute_dtype = None if dtype == torch.float32 else dtype

    def restore() -> None:
        with torch.no_grad():
            for k, v in unet.state_dict().items():
                v.copy_(start[k])

    def grads_of_one_step(remat: bool, plain: bool = False, dtype=torch.float32,
                          policy=None):
        configure(remat, dtype, policy)
        tx = _GradRecorder(make_optimizer(cfg))
        state = TrainState.create(unet, tx)
        gn.reset_launch_count()
        with deterministic_convolutions(), (plain_group_norm() if plain else ctx.nullcontext()):
            _, loss = train_step(fn, tx, state, sched, latents, text, noise=noise,
                                 timesteps=timesteps)
        launches = gn.launch_count()
        restore()
        return loss.item(), tx.grads[0], launches

    print("one train step's gradients (fp32, trainable tensors, before clipping):",
          flush=True)
    ref_loss, ref, plain_launches = grads_of_one_step(True, plain=True)
    loss, got, launches = grads_of_one_step(True)
    off_loss, off, off_launches = grads_of_one_step(False)
    scale = max(g.abs().max().item() for g in ref)
    tol = TUNE_GRAD_REL_TOL * scale
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    remat_err = max((a - b).abs().max().item() for a, b in zip(got, off))
    remat_equal = all(torch.equal(a, b) for a, b in zip(got, off))
    print(f"  kernel against plain (checkpointed blocks): loss {loss:.6e} (plain "
          f"{ref_loss:.6e}), max|d| {err:.4e}, limit {tol:.4e} (max|ref| {scale:.4e}); "
          f"GroupNorm launches {launches} (plain {plain_launches})", flush=True)
    print(f"  checkpointed blocks on against off: loss {loss:.6e} / {off_loss:.6e}, max|d| "
          f"{remat_err:.4e}, bits equal: {remat_equal}; GroupNorm launches {launches} / "
          f"{off_launches}", flush=True)
    if plain_launches != 0 or launches != GN_SITES + GN_REMAT_SITES or off_launches != GN_SITES:
        raise AssertionError(f"GroupNorm launches of one step: kernel {launches}, plain "
                             f"{plain_launches}, without checkpointing {off_launches}")
    if not (err <= tol and remat_err <= tol):
        raise AssertionError(f"train-step gradients off: kernel {err}, checkpointing "
                             f"{remat_err} (limit {tol})")
    del ref, got, off
    # the remat policy keeps the linear layers' products instead of
    # recomputing them: the same arithmetic, so the same bits
    _, full, _ = grads_of_one_step(True, dtype=torch.bfloat16)
    _, kept, policy_launches = grads_of_one_step(True, dtype=torch.bfloat16,
                                                 policy=REMAT_POLICY)
    policy_equal = all(torch.equal(a, b) for a, b in zip(kept, full))
    print(f"  bf16, remat_policy {REMAT_POLICY} against full recompute: gradients bit for "
          f"bit: {policy_equal}; GroupNorm launches {policy_launches}", flush=True)
    if not policy_equal or policy_launches != GN_SITES + GN_REMAT_SITES:
        raise AssertionError(f"remat_policy {REMAT_POLICY}: gradients equal {policy_equal}, "
                             f"GroupNorm launches {policy_launches}")
    del full, kept
    rec = {"grad_max_abs_ref": scale, "grad_tol": tol, "grad_max_abs_err": err,
           "remat_grad_max_abs_err": remat_err, "remat_bits_equal": remat_equal,
           "remat_policy_bits_equal": policy_equal,
           "loss": loss, "plain_loss": ref_loss, "steps": {}}

    print(f"train steps ({TUNE_TIMED_STEPS} a configuration; ms of each, the median of "
          "steps 2 on, peak memory):", flush=True)
    for name, dtype, remat, policy in (
            ("bf16", torch.bfloat16, True, None), ("bf16", torch.bfloat16, True, REMAT_POLICY),
            ("bf16", torch.bfloat16, False, None), ("fp32", torch.float32, True, None),
            ("fp32", torch.float32, False, None)):
        configure(remat, dtype, policy)
        tx = make_optimizer(cfg)
        state = TrainState.create(unet, tx)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        with deterministic_convolutions():
            for step in range(TUNE_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, loss = train_step(fn, tx, state, sched, latents, text,
                                     step_generator(0, step, "cuda"))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.item())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        frozen_equal = all(torch.equal(p.cpu(), start[k]) for k, p in state.frozen.items())
        moved = all(not torch.equal(p.cpu(), start[k])
                    for k, p in state.trainable.items())
        del state, tx
        restore()
        label = (f"{name}, checkpointed blocks {'on' if remat else 'off'}"
                 + (f", remat_policy {policy}" if policy else ""))
        median = statistics.median(ms[1:])
        print(f"  {label}: {', '.join(f'{m:.1f}' for m in ms)} ms, median {median:.2f} "
              f"ms, peak {peak:.2f} GiB; losses {losses}; frozen bit for bit "
              f"{frozen_equal}, every trainable tensor moved {moved}", flush=True)
        if not (frozen_equal and moved and all(np.isfinite(losses))):
            raise AssertionError(f"train steps ({label}): frozen equal {frozen_equal}, "
                                 f"trainable moved {moved}, losses {losses}")
        rec["steps"][label] = {"ms": ms, "median_ms": median, "peak_gib": peak,
                               "losses": losses}
    if profile:
        configure(True, torch.bfloat16)
        tx = make_optimizer(cfg)
        state = TrainState.create(unet, tx)

        def one_step():
            with deterministic_convolutions():
                train_step(fn, tx, state, sched, latents, text, step_generator(0, 0, "cuda"))

        rec["profile"] = profile_device(one_step, "one Stage-1 train step (bf16, "
                                                  "checkpointed blocks)")
        del state, tx
        restore()
    del unet, fn, start
    torch.cuda.empty_cache()
    return rec


def run_tuning_main(**kw) -> dict:
    """One ``cli.run_tuning.main`` run of TUNE updated with ``kw`` on the
    card, every launch count set to 0 just before and read just after;
    returns its directory, wall time, launches, phase times and peak
    memory."""
    from videop2p_tpu_torch.cli import run_tuning
    from videop2p_tpu_torch.utils import profiling

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_tuning.main(**{**TUNE, **kw}, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {"dir": out, "wall_s": wall, "launches": launch_counts(),
           "phases_s": profiling.phase_records(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"  {out}: {wall:.2f} s; phases (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in run["phases_s"].items())
          + f"; launches {run['launches']}; peak {run['peak_gib']:.2f} GiB", flush=True)
    return run


def expect_tune_launches(run: dict, steps: int, validations: int, val: dict = None) -> None:
    """GroupNorm once a site a forward: each train step's forward (GN_SITES)
    and, under checkpointing, its recompute of the blocks (GN_REMAT_SITES);
    each validation's inversion steps and one CFG forward a sampling step a
    prompt (``val``: the run's validation data, TUNE's by default). No
    frame-attention kernel: the tuner's UNet runs "chunked"."""
    val = val or TUNE["validation_data"]
    forwards = val["num_inv_steps"] + val["num_inference_steps"] * len(val["prompts"])
    want = {"frame_attention": 0, "flash_attention": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
            "group_norm": GN_LAUNCHES_PER_CALL * (
                (GN_SITES + GN_REMAT_SITES * TUNE["gradient_checkpointing"]) * steps
                + GN_SITES * forwards * validations)}
    if run["launches"] != want:
        raise AssertionError(f"tune launches {run['launches']}, expected {want}")


def tune_path(args, frames, tmp: str) -> tuple:
    """Phase 15 (path "tune"): Stage 1 on the card. The seeded SD-1.5 bundle
    written as a float32 checkpoint directory (phase 14's writer) is
    ``pretrained_model_path``; ``cli.run_tuning.main`` on TUNE (4 bf16
    steps, checkpointed blocks, checkpoint at 2, validation at 4, export),
    its launches asserted (:func:`expect_tune_launches`), every loss
    finite, the export float32 with every frozen tensor bit for bit the
    loaded one and every trainable tensor moved; a run preempted at step 2
    (the preemption event set) and resumed from "latest" to step 4 exports
    the same bytes as the uninterrupted run; Stage 2 (``run_videop2p.main``
    fast, ``--steps``) loads the export through the suffix and edits with
    src_err == 0.0; then :func:`tune_step_checks`. Everything is written
    under ``tmp``, which the caller deletes; the export is
    ``runs["tune"]["dir"]``. Returns (runs, records)."""
    import os

    from videop2p_tpu_torch.cli import run_tuning
    from videop2p_tpu_torch.cli.common import ModelBundle, build_models
    from videop2p_tpu_torch.models import convert
    from videop2p_tpu_torch.train import latest_checkpoint, trainable_mask

    print("Stage-1 tuning (configs/rabbit-jump-tune.yaml: SD-1.5 width, 512², 8 frames, "
          "bf16, checkpointed blocks; 4 steps):", flush=True)
    bundle = build_models(dtype=torch.float32, device="cuda", seed=0)
    pretrained = os.path.join(tmp, "sd15")
    nbytes = write_checkpoint(pretrained, ModelBundle(
        unet=bundle.unet, vae=bundle.vae, text_encoder=bundle.text_encoder,
        scheduler_config=dict(SD_SCHEDULER_CONFIG)))
    loaded = {k: v.cpu() for k, v in bundle.unet.state_dict().items()}
    mask = trainable_mask(bundle.unet)
    del bundle
    print(f"  wrote the seeded SD-1.5 checkpoint ({nbytes / 1e9:.3f} GB); trainable "
          f"{sum(loaded[k].numel() for k, m in mask.items() if m)} of "
          f"{sum(v.numel() for v in loaded.values())} UNet parameters", flush=True)
    steps = TUNE["max_train_steps"]
    straight = run_tuning_main(pretrained_model_path=pretrained,
                               output_dir=os.path.join(tmp, "straight", "rabbit-jump"))
    expect_tune_launches(straight, steps, 1)
    with open(os.path.join(straight["dir"], "metrics.jsonl")) as fh:
        losses = [json.loads(line)["train_loss"] for line in fh]
    weights = os.path.join(straight["dir"], "unet", "diffusion_pytorch_model.safetensors")
    exported = convert.read_safetensors(weights)
    frozen_equal = all(torch.equal(exported[k], loaded[k]) for k, m in mask.items()
                       if not m)
    moved = all(not torch.equal(exported[k], loaded[k]) for k, m in mask.items() if m)
    dtypes = sorted({str(v.dtype) for v in exported.values()})
    export_bytes = os.path.getsize(weights)
    print(f"  losses {losses}; export {export_bytes} bytes in "
          f"{straight['phases_s']['export']:.2f} s, dtypes {dtypes}; frozen tensors bit "
          f"for bit the loaded ones: {frozen_equal}; every trainable tensor moved: "
          f"{moved}; validation {straight['phases_s']['validation']:.2f} s", flush=True)
    if not (len(losses) == steps and all(np.isfinite(losses))):
        raise AssertionError(f"tune losses {losses}")
    if not (sorted(exported) == sorted(loaded) and frozen_equal and moved
            and dtypes == ["torch.float32"]):
        raise AssertionError("the exported UNet is not the loaded one with its "
                             "trainable tensors moved, in float32")
    del exported

    print("  preempted at step 2, resumed from latest to step 4:", flush=True)
    resumed_dir = os.path.join(tmp, "resumed", "rabbit-jump")
    run_tuning._PREEMPT_EVENT.set()
    try:
        preempted = run_tuning_main(pretrained_model_path=pretrained,
                                    output_dir=resumed_dir)
    finally:
        run_tuning._PREEMPT_EVENT.clear()
    if not (latest_checkpoint(preempted["dir"]).endswith("checkpoint-2")
            and not os.path.exists(os.path.join(preempted["dir"], "model_index.json"))):
        raise AssertionError("the preempted run did not stop at checkpoint-2")
    expect_tune_launches(preempted, 2, 0)
    resumed = run_tuning_main(pretrained_model_path=pretrained, output_dir=resumed_dir,
                              resume_from_checkpoint="latest")
    expect_tune_launches(resumed, steps - 2, 1)
    with open(weights, "rb") as fa_, open(os.path.join(
            resumed["dir"], "unet", "diffusion_pytorch_model.safetensors"), "rb") as fb:
        same = fa_.read() == fb.read()
    diff = {}
    if not same:
        a = convert.read_safetensors(weights)
        b = convert.read_safetensors(os.path.join(
            resumed["dir"], "unet", "diffusion_pytorch_model.safetensors"))
        diff = {k: (a[k] - b[k]).abs().max().item() for k in a
                if not torch.equal(a[k], b[k])}
    print(f"  resumed export equal to the uninterrupted one byte for byte: {same}"
          + (f"; differing tensors {diff}" if diff else ""), flush=True)
    if not same:
        raise AssertionError(f"the resumed run differs from the uninterrupted run: {diff}")

    print("  Stage 2 from the export (run_videop2p fast):", flush=True)
    stage2 = run_main_path(frames, args.steps, args.mixed_precision,
                           pretrained_model_path=os.path.join(tmp, "straight",
                                                              "rabbit-jump"))
    expect_launches(stage2, args.steps, "auto")
    if stage2["checkpoint_dir"] != straight["dir"] or "build_models" not in stage2["timings"]:
        raise AssertionError(f"Stage 2 did not load {straight['dir']!r}")
    del stage2["latents"]
    torch.cuda.empty_cache()
    steps_rec = tune_step_checks(args.profile)
    torch.cuda.empty_cache()
    rec = {"losses": losses, "export_bytes": export_bytes, "frozen_equal": frozen_equal,
           "trainable_moved": moved, "resumed_bit_identical": same, **steps_rec,
           "preempted": preempted, "resumed": resumed}
    return {"tune": straight, "tune_stage2": stage2}, {"tune": rec}


def determinism_probe() -> dict:
    """Fault 7 (phase 16b): one fp32 null-text inner step (forward, backward
    to the embedding, an Adam step) at the main path's shape under "auto"
    and "flash_rect", twice as the CLI ran it before (cuDNN free to choose
    algorithms that add with atomics), twice under
    ``deterministic_convolutions``, and once under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    names each operation that has no deterministic version (the operations
    it makes deterministic, such as an index_select backward, it does not
    name); then two forwards alone, the inversion's work. Prints whether
    each pair gives the same bits and what was warned."""
    import warnings

    from videop2p_tpu_torch.cli.common import build_models, deterministic_convolutions
    from videop2p_tpu_torch.pipelines.inversion import adam_update

    out = {}
    for impl in ("auto", "flash_rect"):
        bundle = build_models(dtype=torch.float32, device="cuda", seed=0, frame_attention=impl)
        value_and_grad = null_text_inputs(bundle)

        def inner_step():
            loss, grad = value_and_grad()
            moved, _ = adam_update(torch.zeros_like(grad), grad, None, 1e-2)
            return loss, grad, moved

        def same(a, b):
            return a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])

        free = same(inner_step(), inner_step())
        with deterministic_convolutions():
            held = same(inner_step(), inner_step())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                inner_step()
            finally:
                torch.use_deterministic_algorithms(False)
        warned = sorted({str(w.message).split("\n")[0][:160] for w in caught})
        x = torch.randn(1, 8, 64, 64, 4, generator=torch.Generator("cuda").manual_seed(5),
                        device="cuda")
        text = torch.zeros(1, 77, 768, device="cuda")
        with torch.no_grad():
            forwards = torch.equal(bundle.unet(x, 500, text), bundle.unet(x, 500, text))
        del bundle, value_and_grad
        torch.cuda.empty_cache()
        out[impl] = {"inner_step_repeats_equal": free,
                     "inner_step_repeats_equal_deterministic_convolutions": held,
                     "forward_repeats_equal": forwards, "deterministic_mode_warnings": warned}
        print(f"  {impl}: a null-text inner step repeated gives the same bits: {free}; under "
              f"deterministic_convolutions: {held}; two forwards alone: {forwards}; "
              f"use_deterministic_algorithms warns about {warned or 'nothing'}", flush=True)
        if not (held and forwards):
            raise AssertionError(f"{impl}: repeats differ under deterministic_convolutions")
    return out


def distill_path(args, frames, pipeline_dir=None) -> tuple:
    """Phase 17 (path "distill"): consistency distillation and the few-step
    student at SD-1.5 width. ``cli.run_tuning.run_distillation`` for
    DISTILL_STEPS fp32 steps on the grid of DISTILL_GRID from
    ``pipeline_dir`` (the tune path's export) or, without one, from the
    seeded SD-1.5 bundle written as a float32 checkpoint directory (phase
    14's writer): its ms a step, peak and launches (GroupNorm at every site
    of its three forwards a step, the teacher's, the EMA target's and the
    student's; the student's backward recomputes through the plain version
    and launches none; no frame-attention kernel: "chunked"); the student
    loaded, saved and loaded again with the same tensors; then on the
    teacher's capture of the clip (``--steps`` × 2 base steps, "auto"), a
    zero head's cached edit at ``--steps`` subset steps equal to the
    teacher's bit for bit, and the trained student's finite, both with
    src_err == 0.0 and the launches the steps imply. The directory it
    writes, and the student, are deleted afterwards. Returns (runs,
    records)."""
    import os
    import shutil
    import tempfile

    from videop2p_tpu_torch.cli import run_tuning
    from videop2p_tpu_torch.cli.common import ModelBundle, build_models, encode_prompts
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.models.vae import encode_video
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.pipelines.cached import capture_windows
    from videop2p_tpu_torch.pipelines.inversion import ddim_inversion_captured
    from videop2p_tpu_torch.pipelines.sampling import edit_sample
    from videop2p_tpu_torch.train import (
        DistillConfig,
        DistillState,
        init_time_head,
        load_student,
        make_distill_optimizer,
        save_student,
    )
    from videop2p_tpu_torch.utils import profiling

    print(f"consistency distillation ({DISTILL_STEPS} fp32 steps, grid {DISTILL_GRID}, "
          "SD-1.5 width, 512², 8 frames) and the few-step student:", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_distill_", dir="outputs")
    runs, rec = {}, {}
    try:
        if pipeline_dir is None:
            seeded = build_models(dtype=torch.float32, device="cuda", seed=0)
            pipeline_dir = os.path.join(tmp, "sd15")
            write_checkpoint(pipeline_dir, ModelBundle(
                unet=seeded.unet, vae=seeded.vae, text_encoder=seeded.text_encoder,
                scheduler_config=dict(SD_SCHEDULER_CONFIG)))
            del seeded
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        path = run_tuning.run_distillation(
            pipeline_dir, TUNE["train_data"], distill_steps=DISTILL_STEPS,
            distill_grid=DISTILL_GRID, seed=TUNE["seed"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        phases = profiling.phase_records()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = phases["distill_steps"] / DISTILL_STEPS * 1e3
        want = {k: 0 for k in launches}
        want["group_norm"] = GN_LAUNCHES_PER_CALL * 3 * GN_SITES * DISTILL_STEPS
        print(f"  run_distillation: {wall:.2f} s; phases (s) "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
              + f"; {step_ms:.1f} ms a step (the mean of {DISTILL_STEPS}, the first "
              f"included); peak {peak:.2f} GiB; launches {launches}", flush=True)
        if launches != want:
            raise AssertionError(f"distillation launches {launches}, expected {want}")
        if not path.endswith(f"student{os.sep}checkpoint-{DISTILL_STEPS}"):
            raise AssertionError(f"the student went to {path!r}")
        runs["distill"] = {"wall_s": wall, "launches": launches, "peak_gib": peak,
                           "phases_s": phases, "step_ms": step_ms}

        teacher = build_models(pipeline_dir, dtype=torch.float32, device="cuda", seed=0)
        unet = teacher.unet
        params, head = load_student(path, unet, unet.config)
        own = {k: p.detach().clone() for k, p in unet.named_parameters()}
        unet.load_state_dict(params)
        state = DistillState.create(unet, head, make_distill_optimizer(DistillConfig()))
        again, head2 = load_student(save_student(os.path.join(tmp, "resaved"), state,
                                                 DISTILL_STEPS), unet, unet.config)
        round_trip = (all(torch.equal(again[k], params[k]) for k in params)
                      and all(torch.equal(head2[k], head[k]) for k in head))
        moved = sum(not torch.equal(params[k], own[k]) for k in own)
        print(f"  the student: {moved} tensors moved from the teacher's, head "
              f"max|dense2| {head['dense2.kernel'].abs().max().item():.3e}; saved and "
              f"loaded again with the same tensors: {round_trip}", flush=True)
        if not (round_trip and moved == len(state.trainable)):
            raise AssertionError("the student checkpoint did not round-trip")
        del state, again, head2
        with torch.no_grad():
            unet.load_state_dict(own)

        steps, base = args.steps, 2 * args.steps
        fn, sched = make_unet_fn(unet), teacher.make_scheduler()
        video = torch.as_tensor(frames, device="cuda")[None].float() / 127.5 - 1.0
        with torch.no_grad():
            latents = encode_video(teacher.vae, video).float()
        cond = encode_prompts(teacher, RABBIT["prompts"], "cuda")
        uncond = encode_prompts(teacher, [""], "cuda")[0]
        words = RABBIT["blend_word"]
        ctrl = dict(is_replace_controller=False, cross_replace_steps=0.8,
                    self_replace_steps=0.4, blend_words=((words[0],), (words[1],)),
                    equalizer_params=dict(RABBIT["eq_params"]), device="cuda")
        cross_len, window = capture_windows(
            make_controller(RABBIT["prompts"], teacher.tokenizer, base, **ctrl), base)
        trajectory, cached = ddim_inversion_captured(
            fn, sched, latents, cond[:1], num_inference_steps=base, cross_len=cross_len,
            self_window=window, capture_blend=True)
        positions = sched.subset_positions(base, steps)
        ctx = make_controller(RABBIT["prompts"], teacher.tokenizer, steps, **ctrl)

        def edit(student_head=None):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = edit_sample(fn, sched, trajectory[-1], cond, uncond,
                              num_inference_steps=steps, ctx=ctx, source_uses_cfg=False,
                              cached_source=cached, step_positions=positions,
                              student_head=student_head)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, launch_counts()

        want = {k: 0 for k in launches}
        want.update(frame_attention=ATTN_SITES * steps,
                    group_norm=GN_LAUNCHES_PER_CALL * GN_SITES * steps)
        zero = init_time_head(torch.Generator("cuda").manual_seed(1), unet.config)
        out_t, wall_t, launches_t = edit()
        out_z, wall_z, _ = edit(zero)
        with torch.no_grad():
            unet.load_state_dict(params)
        out_s, wall_s, launches_s = edit(head)
        src_err = {name: (o[0] - cached.src_latents[-1][0]).abs().max().item()
                   for name, o in (("teacher", out_t), ("zero", out_z), ("student", out_s))}
        bit_equal = torch.equal(out_z, out_t)
        d = (out_s[1:] - out_t[1:]).abs().max().item()
        print(f"  cached edits at {steps} subset steps of a {base}-step capture: teacher "
              f"{wall_t:.3f} s, zero-head student {wall_z:.3f} s (the teacher's bit for bit: "
              f"{bit_equal}), trained student {wall_s:.3f} s (against the teacher max|d| "
              f"{d:.4e}); src_err {src_err}; launches {launches_s}", flush=True)
        if not (bit_equal and all(v == 0.0 for v in src_err.values())):
            raise AssertionError(f"student edits: zero head equal {bit_equal}, src_err "
                                 f"{src_err}")
        if not torch.isfinite(out_s).all() or launches_t != want or launches_s != want:
            raise AssertionError(f"student edit launches {launches_s} (teacher "
                                 f"{launches_t}), expected {want}")
        runs["student_edit"] = {"wall_s": wall_s, "launches": launches_s}
        rec = {"distill": runs["distill"], "round_trip": round_trip,
               "edit_wall_s": {"teacher": wall_t, "zero_head": wall_z, "student": wall_s},
               "zero_head_bit_identical": bit_equal, "student_vs_teacher_max_abs": d,
               "src_err": src_err}
        del teacher, unet, fn, cached, trajectory, out_t, out_z, out_s, params, own
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if pipeline_dir is not None:
            shutil.rmtree(os.path.join(pipeline_dir, "student"), ignore_errors=True)
    torch.cuda.empty_cache()
    return runs, {"distill": rec}


def sdxl_gn_sites(unet, x, t, text) -> dict:
    """{(n, rows, c, eps, act): calls} of the GroupNorm calls of one forward."""
    from videop2p_tpu_torch.models.layers import TpuGroupNorm

    sites = {}

    def record(module, inputs):
        x = inputs[0]
        key = (x.shape[0], x[0, ..., 0].numel(), x.shape[-1], module.eps, module.act)
        sites[key] = sites.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record) for m in unet.modules()
             if isinstance(m, TpuGroupNorm)]
    try:
        with torch.no_grad():
            unet(x, t, text)
    finally:
        for h in hooks:
            h.remove()
    return sites


def sdxl_path(args) -> tuple:
    """Phase 18 (path "sdxl"): ``UNet3DConfig.sdxl()`` at full width on the
    card. Seeded bf16 weights (built in float32, cast); one forward of
    (1, 8, 128, 128, 4) latents against (1, 77, 2048) seeded embeddings and
    one controlled fast-mode edit step with 3 streams (refine, equalizer
    "origami" 2.0), as the JAX benchmark's SDXL cell: wall and device
    times, peak, launches (frame attention at every transformer block,
    GroupNorm at every site); then frame attention at SDXL's two 64-wide
    shapes (H 10 N 4096, H 20 N 1024) for B 1 and 3, and GroupNorm at every
    site the forward ran, each against its plain version in bf16 and fp32
    (timed: the forward's attention shapes and GroupNorm at 128²×320 and the
    32²×1280 stack); then one fp32 forward where it fits. Returns (runs,
    records)."""
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.models.convert import init_weights
    from videop2p_tpu_torch.models.layers import TpuGroupNorm
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
    from videop2p_tpu_torch.ops.attention import MIN_LARGE_TOKENS
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.pipelines.fast import _controlled_sites
    from videop2p_tpu_torch.pipelines.sampling import edit_sample
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    print("SDXL (UNet3DConfig.sdxl(): 3 levels, depths 1/2/10, 64-wide heads, 2048-wide "
          "context; bf16, (1, 8, 128, 128, 4) latents):", flush=True)
    runs, rec = {}, {}
    cfg = UNet3DConfig.sdxl()
    with torch.device("cuda"):
        unet = init_weights(UNet3DConditionModel(cfg), 0)
    params = sum(p.numel() for p in unet.parameters())
    unet = unet.to(torch.bfloat16).eval()
    side = cfg.sample_size
    # one frame-attention launch a transformer block at MIN_LARGE_TOKENS
    # tokens or more (all of SDXL's: 64² and 32²), one GroupNorm a site
    blocks = sum(site == "cross" and tokens >= MIN_LARGE_TOKENS
                 for site, _, tokens in _controlled_sites(unet, (side, side)).values())
    norms = sum(isinstance(m, TpuGroupNorm) for m in unet.modules())
    gen = torch.Generator("cuda").manual_seed(77)
    x = torch.randn(1, 8, side, side, 4, generator=gen, device="cuda").to(torch.bfloat16)
    width = cfg.cross_attention_dim
    text = torch.randn(1, 77, width, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([500], device="cuda")

    def forward():
        with torch.no_grad():
            return unet(x, t, text)

    def timed(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3, launch_counts(),
                torch.cuda.max_memory_allocated() / 2 ** 30)

    # the kernels first, at the shapes the model gives them
    sites = sdxl_gn_sites(unet, x, t, text)
    print("  kernel checks at SDXL's shapes:", flush=True)
    checks = {"frame_attention": [], "group_norm": []}
    timed_gn = {(1, 8 * side * side, 320, 1e-5, "silu"),
                (1, 8 * (side // 4) ** 2, 1280, 1e-5, "silu"),
                (8, (side // 4) ** 2, 1280, 1e-6, "none")}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 3):
            for h, n in ((10, 4096), (20, 1024)):
                checks["frame_attention"].append(
                    check_attention(gen, dtype, b, 8, h, n, 64, timed=b == 1))
        for (n, rows, c, eps, act), calls in sorted(sites.items()):
            r = check_group_norm(gen, dtype, n, rows, c, eps, act,
                                 timed=(n, rows, c, eps, act) in timed_gn)
            r["calls_a_forward"] = calls
            checks["group_norm"].append(r)
        torch.cuda.empty_cache()

    out, fwd_ms, fwd_launches, fwd_peak = timed(forward)
    want = {k: 0 for k in fwd_launches}
    want.update(frame_attention=blocks, group_norm=GN_LAUNCHES_PER_CALL * norms)
    fwd_profile = profile_device(forward, "one SDXL forward (bf16, B 1)")
    print(f"  {params / 1e9:.3f} B parameters; forward wall {fwd_ms:.1f} ms, device kernel "
          f"time {fwd_profile['kernel_ms']:.1f} ms, peak {fwd_peak:.2f} GiB, launches "
          f"{fwd_launches}", flush=True)
    if fwd_launches != want or not torch.isfinite(out.float()).all():
        raise AssertionError(f"SDXL forward: launches {fwd_launches} (expected {want}), "
                             f"finite {bool(torch.isfinite(out.float()).all())}")
    del out
    prompts = RABBIT["prompts"]
    ctx = make_controller(prompts, WordTokenizer(), 1, is_replace_controller=False,
                          cross_replace_steps=1.0, self_replace_steps=1.0,
                          equalizer_params={"words": ["origami"], "values": [2.0]},
                          device="cuda")
    cond = torch.randn(2, 77, width, generator=gen, device="cuda").to(torch.bfloat16)
    uncond = torch.zeros(77, width, device="cuda", dtype=torch.bfloat16)
    fn, sched = make_unet_fn(unet), DDIMScheduler.create_sd()

    def step():
        return edit_sample(fn, sched, x, cond, uncond, num_inference_steps=1, ctx=ctx,
                           source_uses_cfg=False)

    out, step_ms, step_launches, step_peak = timed(step)
    step_profile = profile_device(step, "one SDXL controlled edit step (bf16, 3 streams)")
    print(f"  controlled edit step: wall {step_ms:.1f} ms, device kernel time "
          f"{step_profile['kernel_ms']:.1f} ms, peak {step_peak:.2f} GiB, launches "
          f"{step_launches}", flush=True)
    if step_launches != want or not torch.isfinite(out).all() or tuple(out.shape) != (
            2, 8, side, side, 4):
        raise AssertionError(f"SDXL controlled step: launches {step_launches} (expected "
                             f"{want}), shape {tuple(out.shape)}")
    runs["sdxl"] = {"launches": step_launches}
    del out, fn, ctx
    torch.cuda.empty_cache()

    fp32 = {}
    unet = unet.float()
    x, text = x.float(), text.float()
    try:
        out, fp32["wall_ms"], fp32["launches"], fp32["peak_gib"] = timed(forward)
        fp32["finite"] = bool(torch.isfinite(out).all())
        del out
        print(f"  fp32 forward: wall {fp32['wall_ms']:.1f} ms, peak {fp32['peak_gib']:.2f} GiB, "
              f"finite {fp32['finite']}", flush=True)
    except torch.cuda.OutOfMemoryError:
        fp32 = {"fits": False}
        print("  fp32 forward: does not fit on the card", flush=True)
    del unet, x, text
    torch.cuda.empty_cache()
    rec = {"params": params, "transformer_blocks": blocks, "group_norm_sites": norms,
           "forward": {"wall_ms": fwd_ms, "device_kernel_ms": fwd_profile["kernel_ms"],
                       "busy_ms": fwd_profile["busy_ms"], "peak_gib": fwd_peak,
                       "launches": fwd_launches},
           "controlled_step": {"wall_ms": step_ms,
                               "device_kernel_ms": step_profile["kernel_ms"],
                               "busy_ms": step_profile["busy_ms"], "peak_gib": step_peak,
                               "launches": step_launches},
           "gn_sites": {repr(k): v for k, v in sites.items()}, "checks": checks,
           "fp32_forward": fp32}
    return runs, {"sdxl": rec}


SERVE_STORE_BUDGET_GB = 8.0
# the memory the engine may keep per request beyond the store's growth
# (small per-request leftovers of the last dispatch: embeddings, the
# controller); an edit that kept its autograd graph would hold gigabytes
SERVE_MEM_SLACK_BYTES = 64 << 20


def _serve_request(**overrides) -> dict:
    """The rabbit-jump edit as an HTTP request body (``EditRequest``'s
    fields): the "origami" refine edit with LocalBlend and the equalizer."""
    body = {k: RABBIT[k] for k in ("prompt", "prompts", "blend_word", "eq_params",
                                   "save_name", "is_word_swap")}
    body.update(image_path=RABBIT["image_path"], **overrides)
    return body


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_engine_phase(args, tmp: str) -> tuple:
    """Phase 19a: an ``EditEngine`` at SD-1.5 width behind ``EditServer`` on
    127.0.0.1, talked to only through ``EngineClient``. Returns (run,
    record)."""
    from videop2p_tpu_torch.serve import EditEngine, EngineClient, FaultPlan, ProgramSpec
    from videop2p_tpu_torch.serve.http import EditServer

    steps, mp = args.steps, args.mixed_precision
    # the fault request is the fifth dispatch attempt: requests 1-3, the
    # batch of 2, then it (the unwarmed-steps request never dispatches)
    fault_attempt = 5
    spec = ProgramSpec(width=512, video_len=8, steps=steps, mixed_precision=mp, seed=0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = EditEngine(spec, out_dir=os.path.join(tmp, "engine"),
                        store_budget_bytes=int(SERVE_STORE_BUDGET_GB * (1 << 30)),
                        max_batch=2, max_wait_s=0.1, keep_videos=True,
                        faults=FaultPlan(fail=[fault_attempt], spec=f"fail@{fault_attempt}"),
                        device="cuda")
    build_s = time.perf_counter() - t0
    server = None
    try:
        ctrl = {"blend_word": RABBIT["blend_word"], "eq_params": RABBIT["eq_params"]}
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        warm = engine.warm(tuple(RABBIT["prompts"]), controller_kwargs=ctrl)
        warm_launches = launch_counts()
        warm_peak = torch.cuda.max_memory_allocated()
        misses_after_warm = engine.programs.cache_misses
        print(f"  engine built in {build_s:.2f} s, warm {warm['seconds']:.2f} s "
              f"(launches {warm_launches}; src_err {warm['src_err']!r}), "
              f"{misses_after_warm} programs built", flush=True)
        server = EditServer(engine, host="127.0.0.1", port=0).start()
        client = EngineClient(server.url, timeout_s=60.0)
        if not client.healthz()["ok"]:
            raise AssertionError("/healthz is not ok")
        totals = {k: 0 for k in launch_counts()}
        recs, launches, mem, peaks, store_bytes = {}, {}, {}, {}, {}

        def serve(name, *bodies):
            """Submit ``bodies`` together, wait for each; the kernels'
            launches over them, the peak memory while they ran, the memory
            allocated and the store's bytes after them."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            rids = [client.submit(b) for b in bodies]
            out = [client.wait(r, timeout_s=600.0) for r in rids]
            torch.cuda.synchronize()
            launches[name] = launch_counts()
            for k, v in launches[name].items():
                totals[k] += v
            mem[name] = torch.cuda.memory_allocated()
            peaks[name] = torch.cuda.max_memory_allocated()
            store_bytes[name] = engine.store.stats()["bytes_in_use"]
            for i, rec in enumerate(out):
                recs[name if len(out) == 1 else f"{name}_{i}"] = rec
                print(f"  {name}{'' if len(out) == 1 else f'[{i}]'}: {rec['status']}, store "
                      f"{rec.get('store_source')}, queue_wait {rec.get('queue_wait_s')} s, "
                      f"resolve {rec.get('resolve_s')} s, dispatch {rec.get('dispatch_s')} s, "
                      f"total {rec.get('total_s')} s, batch {rec.get('batch_size')}/"
                      f"{rec.get('padded_size')}, attempts {rec.get('dispatch_attempts')}, "
                      f"src_err {rec.get('src_err')!r}, compile events "
                      f"{rec.get('compile_events')}, program-cache misses "
                      f"{rec.get('program_cache_misses')}; launches {launches[name]}",
                      flush=True)
            return out

        serve("fresh", _serve_request())
        entry_bytes = engine.store.stats()["bytes_in_use"]
        serve("hit", _serve_request(prompts=[RABBIT["prompt"],
                                             "a lego rabbit is jumping on the grass"],
                                    eq_params=None, save_name="lego"))
        serve("repeat", _serve_request())
        serve("batch", _serve_request(), _serve_request(save_name="origami_again"))
        try:
            client.submit(_serve_request(steps=steps + 1))
            raise AssertionError("a request for unwarmed steps was admitted")
        except RuntimeError as e:
            unwarmed = str(e)
        print(f"  unwarmed steps {steps + 1}: {unwarmed}", flush=True)
        if "400" not in unwarmed or f"warmed: [{steps}]" not in unwarmed:
            raise AssertionError(f"unwarmed steps: {unwarmed}")
        if engine.faults.attempts != fault_attempt - 1:
            raise AssertionError(f"{engine.faults.attempts} dispatch attempts before the "
                                 f"fault request, expected {fault_attempt - 1}")
        serve("fault", _serve_request())
        metrics = client.metrics()
        prom = client.metrics_prometheus()
        peak_gib = max(warm_peak, *peaks.values()) / 2 ** 30
        videos = {name: engine.videos(rec["id"]) for name, rec in recs.items()}
        done = list(recs.values())
    finally:
        if server is not None:
            server.close()
        engine.close()
    record = {"build_s": build_s, "warm": warm, "warm_launches": warm_launches,
              "records": {k: {f: v.get(f) for f in (
                  "status", "store_source", "queue_wait_s", "resolve_s", "dispatch_s",
                  "total_s", "batch_size", "padded_size", "dispatch_attempts", "src_err",
                  "compile_events", "program_cache_misses", "content_sha256", "cost")}
                  for k, v in recs.items()},
              "launches": launches, "store_entry_bytes": entry_bytes,
              "store": metrics["store"], "capacity": metrics["capacity"],
              "compile": metrics["compile"], "programs": metrics["programs"],
              "memory_allocated": mem, "memory_peak": peaks, "store_bytes": store_bytes,
              "peak_gib": peak_gib}
    print(f"  store entry: {entry_bytes} bytes ({entry_bytes / 2 ** 30:.3f} GiB) at 512², "
          f"8 frames, {steps} steps, {mp}; budget {SERVE_STORE_BUDGET_GB} GiB holds the "
          f"{metrics['store']['entries']} clips served (evictions "
          f"{metrics['store']['evictions']}, refused {metrics['store']['rejected_oversize']})",
          flush=True)
    print(f"  /metrics capacity: {json.dumps(metrics['capacity'])}", flush=True)
    print(f"  peak allocated {peak_gib:.2f} GiB (warm {warm_peak / 2 ** 30:.3f}); each "
          "request's peak / allocated after it (GiB): "
          + ", ".join(f"{k} {peaks[k] / 2 ** 30:.3f} / {v / 2 ** 30:.3f}"
                      for k, v in mem.items()), flush=True)

    # gates
    failures = []
    for name, rec in recs.items():
        if rec["status"] != "done" or rec.get("src_err") != 0.0:
            failures.append(f"{name}: status {rec['status']} ({rec.get('error')}), "
                            f"src_err {rec.get('src_err')!r}")
        elif not (os.path.isfile(rec["edit_gif"]) and os.path.isfile(rec["inversion_gif"])):
            failures.append(f"{name}: GIFs not written")
    for name, v in videos.items():
        if v is None or v.shape != (2, 8, 512, 512, 3) or not np.isfinite(v).all():
            failures.append(f"{name}: videos {None if v is None else v.shape} not finite "
                            "of shape (2, 8, 512, 512, 3)")
    hits = [n for n, r in recs.items() if n != "fresh"]
    if recs["fresh"].get("store_source") != "fresh" or any(
            recs[n].get("store_source") != "memory" for n in hits):
        failures.append("store: request 1 must invert, every later one hit the store")
    if any(recs[n].get("compile_events") or recs[n].get("program_cache_misses")
           for n in recs):
        failures.append("a request built a kernel or a program after warm")
    if engine.programs.cache_misses != misses_after_warm:
        failures.append(f"program-cache misses after warm: "
                        f"{engine.programs.cache_misses - misses_after_warm}")
    if recs["repeat"]["content_sha256"] != recs["fresh"]["content_sha256"]:
        failures.append("the repeat request's content_sha256 differs from request 1's")
    if not (recs["batch_0"]["batch_size"] == recs["batch_1"]["batch_size"] == 2
            and recs["batch_0"]["padded_size"] == 2):
        failures.append("the two compatible requests did not form one scan dispatch of 2")
    for i in (0, 1):
        if not np.array_equal(videos[f"batch_{i}"], videos["fresh"]):
            failures.append(f"batch member {i} is not its singleton's videos bit for bit")
    if recs["fault"]["dispatch_attempts"] != 2 or metrics["counters"]["retries"] != 1:
        failures.append(f"the injected fault: attempts {recs['fault']['dispatch_attempts']}, "
                        f"retries {metrics['counters']['retries']}")
    forwards = {"fresh": 2 * steps, "hit": steps, "repeat": steps, "batch": 2 * steps,
                "fault": steps}
    for name, n in forwards.items():
        want = {k: 0 for k in launches[name]}
        want.update(frame_attention=ATTN_SITES * n,
                    group_norm=GN_LAUNCHES_PER_CALL * GN_SITES * n)
        if launches[name] != want:
            failures.append(f"{name}: launches {launches[name]}, expected {want}")
    growth = store_bytes["fault"] - store_bytes["hit"]
    for what, by in (("allocated after", mem), ("peak of", peaks)):
        if by["fault"] > by["hit"] + growth + SERVE_MEM_SLACK_BYTES:
            failures.append(f"memory grows with the requests: {what} request 2 {by['hit']} "
                            f"B, the last {by['fault']} B (store growth {growth} B)")
    if metrics["store"]["rejected_oversize"] or metrics["store"]["evictions"]:
        failures.append(f"the store budget does not hold the clips: {metrics['store']}")
    if "videop2p_capacity_busy_seconds" not in prom:
        failures.append("/metrics?format=prometheus lacks the capacity section")
    run = {"launches": totals, "wall_s": sum(r["total_s"] for r in done),
           "videos_fresh": videos["fresh"]}
    return run, record, failures


# what phase 19b's plain fp32 ``cli.serve`` child answered (a fresh request
# and a hit: their records and GIF bytes), which phase 26b's child under
# torchrun must answer with the same bits
PLAIN_SERVE_CLI: dict = {}


def _hit_request() -> dict:
    """Another edit of request 1's clip: a store hit."""
    return _serve_request(prompts=[RABBIT["prompt"], "a lego rabbit is jumping on the grass"],
                          eq_params=None, save_name="lego")


def _gif_bytes(rec: dict) -> dict:
    out = {}
    for k in ("inversion_gif", "edit_gif"):
        with open(rec[k], "rb") as fh:
            out[k] = fh.read()
    return out


def serve_cli_phase(args, tmp: str, mp: str) -> tuple:
    """Phase 19b: ``python -m videop2p_tpu_torch.cli.serve`` as a subprocess
    on an ephemeral port, in ``mp`` (fp32 by the CLI's default, bf16 by its
    flag): one request (in fp32 also a store hit, whose records and GIFs
    phase 26b holds its torchrun child to: ``PLAIN_SERVE_CLI``), then
    SIGTERM. Returns (record, failures)."""
    import signal

    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineClient

    port = _free_port()
    out_dir = os.path.join(tmp, f"cli_{mp}")
    log_path = os.path.join(tmp, f"cli_{mp}.log")
    cmd = [sys.executable, "-m", "videop2p_tpu_torch.cli.serve", "--port", str(port),
           "--out_dir", out_dir, "--steps", str(args.steps),
           "--store_budget_gb", str(SERVE_STORE_BUDGET_GB),
           "--warm_prompts", *RABBIT["prompts"],
           *(() if mp == "fp32" else ("--mixed_precision", mp))]
    failures = []
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        try:
            client = EngineClient(f"http://127.0.0.1:{port}", timeout_s=60.0, retries=0)
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"the server exited {proc.returncode} before "
                                         "/healthz answered")
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("/healthz did not answer in 600 s")
                try:
                    health = client.healthz()
                    break
                except Exception:  # noqa: BLE001 — not listening yet
                    time.sleep(1.0)
            up_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            done = client.wait(client.submit(_serve_request()), timeout_s=600.0)
            request_s = time.perf_counter() - t1
            if mp == "fp32":
                hit = client.wait(client.submit(_hit_request()), timeout_s=600.0)
                PLAIN_SERVE_CLI.update(records={"fresh": done, "hit": hit},
                                       gifs={n: _gif_bytes(r) for n, r in
                                             (("fresh", done), ("hit", hit))
                                             if r["status"] == "done"})
            metrics = client.metrics()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        except Exception as e:
            with open(log_path) as fh:
                raise AssertionError(f"cli serve: {e}\n{fh.read()[-4000:]}") from e
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as fh:
        log_tail = fh.read()[-4000:]
    events = read_ledger(os.path.join(out_dir, "serve_ledger.jsonl"))
    kinds = [e["event"] for e in events]
    rec = {"dtype": mp, "up_s": up_s, "warm": health.get("warm"), "request_s": request_s,
           "status": done["status"], "src_err": done.get("src_err"),
           "store_entry_bytes": metrics["store"]["bytes_in_use"], "rc": rc,
           "ledger_tail": kinds[-4:]}
    print(f"  cli ({mp}): /healthz after {up_s:.1f} s (warm "
          f"{(health.get('warm') or {}).get('seconds')} s), request {done['status']} in "
          f"{request_s:.2f} s, src_err {done.get('src_err')!r}, store entry "
          f"{rec['store_entry_bytes']} bytes; SIGTERM → exit {rc}; ledger ends "
          f"{kinds[-4:]}", flush=True)
    if done["status"] != "done" or done.get("src_err") != 0.0:
        failures.append(f"cli request: {done['status']} ({done.get('error')}), src_err "
                        f"{done.get('src_err')!r}")
    elif not os.path.isfile(done["edit_gif"]):
        failures.append("cli request: no GIF written")
    hit = PLAIN_SERVE_CLI.get("records", {}).get("hit") if mp == "fp32" else None
    if mp == "fp32" and (hit is None or hit["status"] != "done" or hit.get("src_err") != 0.0
                         or hit.get("store_source") != "memory"):
        failures.append(f"cli hit: {hit and (hit['status'], hit.get('error'), hit.get('src_err'), hit.get('store_source'))}")
    if rc != 0:
        failures.append(f"cli exit code {rc} after SIGTERM:\n{log_tail}")
    if "serve_health" not in kinds or kinds.index("serve_health") < max(
            i for i, k in enumerate(kinds) if k == "serve_request"):
        failures.append(f"cli ledger does not close with serve_health: {kinds[-6:]}")
    return rec, failures


def serve_path(args, frames_unused) -> tuple:
    """Phase 19 (path "serve"): the serving engine. 19a in process (then the
    edit of request 1 against ``run_main_path``'s cached fast edit of the
    same clip, seed, weights and prompts), 19b the entry point in fp32 (its default) and bf16. Returns
    (runs, records)."""
    from videop2p_tpu_torch.data.dataset import load_frame_sequence

    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir="outputs")
    try:
        print("serve (SD-1.5 width, 512², 8 frames of data/rabbit):", flush=True)
        run, record, failures = serve_engine_phase(args, tmp)
        rabbit = load_frame_sequence(RABBIT["image_path"], size=512, num_frames=8)
        main = run_main_path(rabbit, args.steps, args.mixed_precision, keep_videos=True)
        served = run.pop("videos_fresh")
        ref = main.pop("videos").cpu().numpy()
        diff = float(np.abs(served - ref).max())
        record["main_path_max_abs_diff"] = diff
        print(f"  request 1 against run_main_path's cached fast edit: max|d| {diff!r} "
              "(gate: bit for bit)", flush=True)
        if not np.array_equal(served, ref):
            failures.append(f"the served edit differs from the main path's by {diff}")
        record["cli"] = {}
        for mp in ("fp32", "bf16"):
            record["cli"][mp], cli_failures = serve_cli_phase(args, tmp, mp)
            failures += cli_failures
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("serve path: " + "; ".join(failures))
    return {"serve": run}, {"serve": record}


# the car and tiger edits (configs/car-drive-p2p.yaml, tiger-forest-p2p.yaml)
# as request bodies: the fleet path's concurrent pair
CAR = dict(image_path="./data/car", prompt="a car is driving on the road",
           prompts=["a car is driving on the road", "a car is driving on the railway"],
           blend_word=["road", "railway"], eq_params={"words": ["railway"], "values": [2]},
           save_name="railway", is_word_swap=True)
TIGER = dict(image_path="./data/tiger", prompt="a tiger is walking in the forest",
             prompts=["a tiger is walking in the forest",
                      "a Lego tiger is walking in the forest"],
             blend_word=["tiger", "tiger"], eq_params={"words": ["Lego"], "values": [2]},
             save_name="lego", is_word_swap=False)
# the fault plan of the fleet's chaos run (tests/test_sched.py's): every
# dispatch of replica 0 raises backend-unavailable
FLEET_CHAOS = "unavail@1-999"
# the stream path: synthetic_clip(STREAM_FRAMES, 512), windows of the
# engine's 8 frames overlapping by STREAM_OVERLAP (windows [0, 8), [6, 14):
# STREAM_WINDOWS windows, one seam, a depth that keeps the default run within
# its time limit), and the stream CLI's
# default prompts and edit, which the in-process job uses too, so that the
# CLI's final.npy compares with it
STREAM_FRAMES = 14
STREAM_OVERLAP = 2
STREAM_WINDOWS = 2
STREAM_PROMPTS = ["a rabbit is jumping", "a origami rabbit is jumping"]
STREAM_REQUEST = dict(is_word_swap=False, blend_word=None, cross_replace_steps=0.2,
                      self_replace_steps=0.5)
# phase 21's window 0 (a direct request for frames 0-7 of the clip, its
# edit stream), which phase 26c's one-window stream job must equal
STREAM_WINDOW0: dict = {}


def _release() -> None:
    """Free what earlier phases left (the programs hold reference cycles, so
    only the cyclic collector frees their weights), so that a phase's peak
    is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def _card_used_line() -> str:
    """The card's memory in use by every process (``cudaMemGetInfo``)."""
    free, total = torch.cuda.mem_get_info()
    return f"{(total - free) / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} in use on the card"


def _allocated_line() -> str:
    _release()
    return f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated before it"


def _busy_traced(fn) -> tuple:
    """``fn()`` under a CUDA-only ``torch.profiler`` trace: (its result, the
    host wall seconds, the card's busy seconds — the union of the kernels'
    intervals — or None where the trace held no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return out, wall, None
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return out, wall, (busy + cur_e - cur_s) / 1e6


def _fresh_launches(steps: int) -> dict:
    """The kernels' launches of one fresh request: 2·steps forwards
    (inversion and edit) on "auto"."""
    want = {k: 0 for k in launch_counts()}
    want.update(frame_attention=ATTN_SITES * 2 * steps,
                group_norm=GN_LAUNCHES_PER_CALL * GN_SITES * 2 * steps)
    return want


def _check_record(name: str, rec: dict, videos, failures: list, shape=(2, 8, 512, 512, 3)):
    if rec["status"] != "done" or rec.get("src_err") != 0.0:
        failures.append(f"{name}: status {rec['status']} ({rec.get('error')}), src_err "
                        f"{rec.get('src_err')!r}")
    if videos is None or videos.shape != shape or not np.isfinite(videos).all():
        failures.append(f"{name}: videos {None if videos is None else videos.shape} not "
                        f"finite of shape {shape}")


def _print_record(name: str, rec: dict, wall_s: float = None) -> None:
    print(f"  {name}: {rec['status']} on {rec.get('replica', '-')}, store "
          f"{rec.get('store_source')}, queue_wait {rec.get('queue_wait_s')} s, resolve "
          f"{rec.get('resolve_s')} s, dispatch {rec.get('dispatch_s')} s, total "
          f"{rec.get('total_s')} s" + ("" if wall_s is None else
                                        f", the client's wall {wall_s:.3f} s")
          + f", src_err {rec.get('src_err')!r}, program-cache misses "
          f"{rec.get('program_cache_misses')}", flush=True)


def fleet_inproc_phase(args, tmp: str) -> tuple:
    """Phase 20a: two in-process replicas over one shared warm ProgramSet
    behind a RouterServer, talked to through ``EngineClient``. Returns (run,
    record, failures)."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import (
        EditEngine,
        EngineClient,
        ProgramSet,
        ProgramSpec,
        ReplicaSupervisor,
        Router,
        RouterServer,
    )

    steps, mp = args.steps, args.mixed_precision
    spec = ProgramSpec(width=512, video_len=8, steps=steps, mixed_precision=mp, seed=0)
    ctrl = {"blend_word": RABBIT["blend_word"], "eq_params": RABBIT["eq_params"]}
    store = os.path.join(tmp, "inv_store")
    engine_kwargs = dict(keep_videos=True, device="cuda", max_wait_s=0.05,
                         store_budget_bytes=int(SERVE_STORE_BUDGET_GB * (1 << 30)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    programs = ProgramSet(spec, device="cuda")
    sup = ReplicaSupervisor(spec, 2, out_dir=os.path.join(tmp, "fleet"), persist_dir=store,
                            programs=programs, warm_prompts=tuple(RABBIT["prompts"]),
                            warm_kwargs={"controller_kwargs": ctrl},
                            engine_kwargs=engine_kwargs)
    sup.start()
    up_s = time.perf_counter() - t0
    router = Router(sup.urls, probe_ttl_s=0.05, timeout_s=60.0,
                    ledger_path=os.path.join(tmp, "router_ledger.jsonl"))
    server = RouterServer(router).start()
    failures, recs, videos, walls = [], {}, {}, {}
    misses_after_warm = programs.cache_misses
    print(f"  2 replicas up in {up_s:.2f} s (one ProgramSet, warm "
          f"{programs.warmed['seconds']} s), router at {server.url}", flush=True)
    try:
        client = EngineClient(server.url, timeout_s=60.0)
        direct = [EngineClient(u, timeout_s=60.0) for u in sup.urls]
        engines = {r.name: r.engine for r in sup.replicas}

        t1 = time.perf_counter()
        rec1 = client.result(client.submit(_serve_request()), wait_s=600.0)
        walls["router_fresh"] = time.perf_counter() - t1
        recs["router_fresh"] = rec1
        videos["router_fresh"] = engines[rec1["replica"]].videos(rec1["id"])
        _print_record("router_fresh", rec1, walls["router_fresh"])
        other = 1 - int(rec1["replica"][-1])
        rec2 = direct[other].result(direct[other].submit(_serve_request(
            prompts=[RABBIT["prompt"], "a lego rabbit is jumping on the grass"],
            eq_params=None, save_name="lego")), wait_s=600.0)
        rec2["replica"] = f"replica{other}"
        recs["direct_hit"], videos["direct_hit"] = rec2, engines[rec2["replica"]].videos(rec2["id"])
        _print_record("direct_hit", rec2)
        # the concurrent pair: car to replica 0, tiger to replica 1, at once
        pair = {"car": (0, CAR), "tiger": (1, TIGER)}
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()

        def run_pair():
            rids = {n: direct[i].submit(body) for n, (i, body) in pair.items()}
            return {n: direct[pair[n][0]].result(r, wait_s=600.0) for n, r in rids.items()}

        pair_recs, pair_wall, pair_busy = _busy_traced(run_pair)
        pair_launches = launch_counts()
        pair_peak = torch.cuda.max_memory_allocated()
        for n, rec in pair_recs.items():
            rec["replica"] = f"replica{pair[n][0]}"
            recs[f"pair_{n}"] = rec
            videos[f"pair_{n}"] = engines[rec["replica"]].videos(rec["id"])
            _print_record(f"pair_{n}", rec)
        health = client.healthz()
        metrics = client.metrics()
        prom = client.metrics_prometheus()
        router_health = router.health_record()
    finally:
        server.close()
        sup.stop()
    # the same two requests served alone, one after the other, by a fresh
    # engine (no store: each inverts again) over the same programs
    from videop2p_tpu_torch.serve import EditRequest

    alone = EditEngine(spec, out_dir=os.path.join(tmp, "alone"), programs=programs,
                       keep_videos=True, device="cuda")
    try:
        def run_alone():
            out = {}
            for n, (_, body) in pair.items():
                rec = alone.result(alone.submit(EditRequest(**body)), wait_s=600.0)
                out[n] = (rec, alone.videos(rec["id"]))
            return out

        alone_out, alone_wall, alone_busy = _busy_traced(run_alone)
    finally:
        alone.close()
    for n, (rec, vid) in alone_out.items():
        _print_record(f"alone_{n}", rec)
        _check_record(f"alone_{n}", rec, vid, failures)
        if not np.array_equal(vid, videos[f"pair_{n}"]):
            failures.append(f"the concurrent {n} request differs from it served alone by "
                            f"{float(np.abs(vid - videos[f'pair_{n}']).max())}")
    for name, rec in recs.items():
        _check_record(name, rec, videos[name], failures)
    if rec2.get("store_source") != "disk" or rec2.get("program_cache_misses"):
        failures.append(f"request 2 on the other replica: store {rec2.get('store_source')}, "
                        f"program-cache misses {rec2.get('program_cache_misses')} (want a "
                        "disk hit and none)")
    if programs.cache_misses != misses_after_warm:
        failures.append(f"program-cache misses after warm: "
                        f"{programs.cache_misses - misses_after_warm}")
    want = {k: 2 * v for k, v in _fresh_launches(steps).items()}
    if pair_launches != want:
        failures.append(f"the concurrent pair's launches {pair_launches}, expected {want}")
    if set(health.get("replicas", {})) != {"replica0", "replica1"} or health["healthy"] != 2:
        failures.append(f"the router's /healthz: {health}")
    if set(metrics.get("replicas", {})) != {"replica0", "replica1"}:
        failures.append(f"the router's /metrics lists {sorted(metrics.get('replicas', {}))}")
    if 'videop2p_replica_in_flight{replica="replica1"}' not in prom:
        failures.append("the router's Prometheus text lacks replica1")
    if "router_health" not in [e["event"] for e in read_ledger(router.ledger.path)]:
        failures.append("the router's ledger lacks router_health at close")
    overhead = walls["router_fresh"] - recs["router_fresh"]["total_s"]
    serial_s = sum(rec["total_s"] for rec, _ in alone_out.values())
    print(f"  the router's overhead on request 1: {overhead:.4f} s (the client's "
          f"{walls['router_fresh']:.4f} s less the replica's total "
          f"{recs['router_fresh']['total_s']} s)", flush=True)
    print(f"  the concurrent pair: {pair_wall:.3f} s wall (launches {pair_launches}), card "
          f"busy {'not measured' if pair_busy is None else f'{pair_busy:.3f} s, {100 * pair_busy / pair_wall:.1f} %'}; "
          f"served alone one after the other: {alone_wall:.3f} s wall (totals "
          f"{serial_s:.3f} s), busy "
          f"{'not measured' if alone_busy is None else f'{alone_busy:.3f} s, {100 * alone_busy / alone_wall:.1f} %'}; "
          f"peak over the pair {pair_peak / 2 ** 30:.2f} GiB", flush=True)
    record = {"up_s": up_s, "warm": programs.warmed, "router_overhead_s": overhead,
              "walls": walls, "pair_wall_s": pair_wall, "pair_busy_s": pair_busy,
              "alone_wall_s": alone_wall, "alone_busy_s": alone_busy,
              "pair_launches": pair_launches, "pair_peak_gib": pair_peak / 2 ** 30,
              "router_health": router_health,
              "records": {k: {f: v.get(f) for f in (
                  "status", "replica", "store_source", "queue_wait_s", "resolve_s",
                  "dispatch_s", "total_s", "src_err", "program_cache_misses")}
                  for k, v in recs.items()},
              "alone": {n: {f: rec.get(f) for f in ("resolve_s", "dispatch_s", "total_s")}
                        for n, (rec, _) in alone_out.items()}}
    run = {"launches": pair_launches, "wall_s": pair_wall,
           "videos_router": videos["router_fresh"], "programs": programs}
    return run, record, failures


def fleet_chaos_phase(args, tmp: str, programs) -> tuple:
    """Phase 20a's chaos run: a second supervisor over the same warm
    programs with replica 0 under FLEET_CHAOS; a request straight to replica
    0 opens its breaker, then one through the router must be shed to
    replica 1 and complete. Returns (record, failures)."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineClient, ReplicaSupervisor, Router, RouterServer

    sup = ReplicaSupervisor(
        programs.spec, 2, out_dir=os.path.join(tmp, "chaos"),
        persist_dir=os.path.join(tmp, "inv_store"), programs=programs,
        warm_prompts=tuple(RABBIT["prompts"]),
        warm_kwargs={"controller_kwargs": {"blend_word": RABBIT["blend_word"],
                                           "eq_params": RABBIT["eq_params"]}},
        engine_kwargs=dict(keep_videos=True, device="cuda", max_retries=0,
                           breaker_threshold=1, breaker_open_s=60.0),
        faults={0: FLEET_CHAOS})
    sup.start()
    ledger_path = os.path.join(tmp, "chaos_router_ledger.jsonl")
    router = Router(sup.urls, probe_ttl_s=0.05, suspend_s=5.0, timeout_s=60.0,
                    ledger_path=ledger_path)
    server = RouterServer(router).start()
    try:
        doomed = EngineClient(sup.urls[0], timeout_s=60.0)
        rec_a = doomed.result(doomed.submit(_serve_request()), wait_s=600.0)
        client = EngineClient(server.url, timeout_s=60.0)
        rec_b = client.result(client.submit(_serve_request()), wait_s=600.0)
        vid_b = sup.replicas[1].engine.videos(rec_b["id"]) if rec_b.get("replica") == \
            "replica1" else None
        breaker0 = sup.replicas[0].engine.breaker.snapshot()
    finally:
        server.close()
        sup.stop()
    health = [e for e in read_ledger(ledger_path) if e["event"] == "router_health"]
    print(f"  chaos: replica 0 under {FLEET_CHAOS!r}: its request {rec_a['status']} "
          f"({rec_a.get('error')}), breaker {breaker0.get('state')}; through the router: "
          f"{rec_b['status']} on {rec_b.get('replica')}, total {rec_b.get('total_s')} s; "
          f"router_health {health[-1] if health else None}", flush=True)
    failures = []
    if rec_a["status"] != "error" or breaker0.get("state") != "open":
        failures.append(f"chaos: replica 0's request {rec_a['status']}, breaker "
                        f"{breaker0.get('state')} (want error, open)")
    if rec_b.get("replica") != "replica1":
        failures.append(f"chaos: the router sent the request to {rec_b.get('replica')}")
    else:
        _check_record("chaos", rec_b, vid_b, failures)
    if not health or health[-1]["routed_around"] != 1 or health[-1]["healthy"] != 1:
        failures.append(f"chaos: router_health {health[-1] if health else None}")
    return {"replica0": rec_a["status"], "breaker0": breaker0,
            "shed": {f: rec_b.get(f) for f in ("status", "replica", "total_s", "src_err")},
            "router_health": health[-1] if health else None}, failures


def _sub_seconds(record: dict, name: str, t0: float) -> float:
    """Keep and print a sub-phase's seconds since ``t0``; returns now."""
    now = time.perf_counter()
    record.setdefault("sub_s", {})[name] = now - t0
    print(f"  [{name}: {now - t0:.1f} s]", flush=True)
    return now


def fleet_path(args) -> tuple:
    """Phase 20 (path "fleet"): replicas behind a router, in process
    (request 1 against ``run_main_path``'s cached fast edit, then the chaos
    run). The router CLI with two spawned children is phase 22d's, whose
    child also carries the gates this phase held on it. Returns (runs,
    records)."""
    from videop2p_tpu_torch.data.dataset import load_frame_sequence

    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir="outputs")
    t0 = t = time.perf_counter()
    try:
        print(f"fleet (2 replicas, SD-1.5 width, 512², 8 frames; {_allocated_line()}):",
              flush=True)
        run, record, failures = fleet_inproc_phase(args, tmp)
        t = _sub_seconds(record, "20a in process", t)
        programs = run.pop("programs")
        record["chaos"], chaos_failures = fleet_chaos_phase(args, tmp, programs)
        failures += chaos_failures
        del programs
        _release()
        t = _sub_seconds(record, "20a chaos", t)
        rabbit = load_frame_sequence(RABBIT["image_path"], size=512, num_frames=8)
        main = run_main_path(rabbit, args.steps, args.mixed_precision, keep_videos=True)
        routed = run.pop("videos_router")
        ref = main.pop("videos").cpu().numpy()
        diff = float(np.abs(routed - ref).max())
        record["main_path_max_abs_diff"] = diff
        print(f"  request 1 through the router against run_main_path's cached fast edit: "
              f"max|d| {diff!r} (gate: bit for bit)", flush=True)
        if not np.array_equal(routed, ref):
            failures.append(f"the routed edit differs from the main path's by {diff}")
        del main, ref
        t = _sub_seconds(record, "20a main path", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _release()
    record["path_s"] = time.perf_counter() - t0
    print(f"  fleet path: {record['path_s']:.1f} s", flush=True)
    if failures:
        raise AssertionError("fleet path: " + "; ".join(failures))
    return {"fleet": run}, {"fleet": record}


def _stream_cli_cmd(args, job: str) -> list:
    return [sys.executable, "-m", "videop2p_tpu_torch.cli.stream", "--synthetic",
            str(STREAM_FRAMES), "--width", "512", "--video_len", "8", "--overlap",
            str(STREAM_OVERLAP), "--steps", str(args.steps), "--job_dir", job,
            *(() if args.mixed_precision == "fp32" else
              ("--mixed_precision", args.mixed_precision))]


def _window0_persisted(job: str) -> bool:
    """Window 0's sidecar written and the manifest (replaced atomically)
    listing it done."""
    if not os.path.exists(os.path.join(job, "windows", "w0000.npz")):
        return False
    try:
        with open(os.path.join(job, "manifest.json")) as fh:
            return any(w["index"] == 0 and w["status"] == "done"
                       for w in json.load(fh)["windows"])
    except (OSError, ValueError, KeyError):
        return False


def start_stream_cli_kill(args, tmp: str) -> dict:
    """Phase 21's CLI part, its first run: ``python -m
    videop2p_tpu_torch.cli.stream`` as a subprocess, SIGKILLed by a watcher
    thread once its first window is persisted (its sidecar, and the
    manifest listing it). Started before the in-process job, so that the
    child's start-up overlaps it; the handle goes to
    :func:`stream_cli_phase`."""
    import signal

    job = os.path.join(tmp, "cli_job")
    log_path = os.path.join(tmp, "cli_stream_1.log")
    log = open(log_path, "w")
    handle = {"job": job, "log_path": log_path, "t0": time.perf_counter(),
              "proc": subprocess.Popen(_stream_cli_cmd(args, job), stdout=log,
                                       stderr=subprocess.STDOUT)}

    def watch():
        proc = handle["proc"]
        try:
            while not _window0_persisted(job):
                if proc.poll() is not None:
                    handle["error"] = f"cli stream exited {proc.returncode} before its first window"
                    return
                if time.perf_counter() - handle["t0"] > 600:
                    handle["error"] = "cli stream: no window in 600 s"
                    return
                time.sleep(0.05)
            proc.send_signal(signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            handle["killed_s"] = time.perf_counter() - handle["t0"]
            log.close()

    handle["watcher"] = threading.Thread(target=watch, daemon=True)
    handle["watcher"].start()
    return handle


def stream_cli_phase(args, handle: dict, reference: np.ndarray) -> tuple:
    """Phase 21's CLI part: the first run's SIGKILL (:func:`start_stream_cli_kill`),
    then the same command again to the end: its final.npy against
    ``reference``, bit for bit. Returns (record, failures)."""
    job = handle["job"]
    cmd = _stream_cli_cmd(args, job)
    failures = []
    handle["watcher"].join(timeout=900)
    if "error" in handle or "killed_s" not in handle:
        with open(handle["log_path"]) as fh:
            raise AssertionError(f"{handle.get('error', 'cli stream: the watcher did not end')}"
                                 f":\n{fh.read()[-4000:]}")
    killed_s = handle["killed_s"]
    with open(os.path.join(job, "manifest.json")) as fh:
        persisted = sorted(w["index"] for w in json.load(fh)["windows"]
                           if w["status"] == "done")
    t1 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    resume_s = time.perf_counter() - t1
    health = next((json.loads(line)["stream_health"] for line in out.stdout.splitlines()
                   if line.startswith('{"stream_health"')), None)
    print(f"  cli stream: SIGKILL after {killed_s:.1f} s with windows {persisted} persisted; "
          f"the rerun exited {out.returncode} in {resume_s:.1f} s: {health}", flush=True)
    if out.returncode != 0 or health is None:
        failures.append(f"cli stream rerun exit {out.returncode}:\n{out.stdout[-2000:]}"
                        f"{out.stderr[-2000:]}")
        return {"killed_s": killed_s, "persisted": persisted}, failures
    if health["windows_skipped"] != len(persisted) or health["src_err_max"] != 0.0:
        failures.append(f"cli stream rerun: skipped {health['windows_skipped']} of the "
                        f"{len(persisted)} persisted, src_err_max {health['src_err_max']}")
    final = np.load(os.path.join(job, "final.npy"))
    diff = float(np.abs(final - reference).max()) if final.shape == reference.shape else None
    print(f"  cli stream final.npy against the in-process job: max|d| {diff!r} (gate: bit "
          "for bit)", flush=True)
    if not np.array_equal(final, reference):
        failures.append(f"cli stream: final.npy differs from the in-process job's by {diff}")
    return {"killed_s": killed_s, "persisted": persisted, "resume_s": resume_s,
            "health": health, "max_abs_diff": diff}, failures


def stream_path(args) -> tuple:
    """Phase 21 (path "stream"): streaming long-video editing on an engine
    at SD-1.5 width. Returns (runs, records)."""
    from videop2p_tpu_torch.serve import EditEngine, EditRequest, ProgramSpec
    from videop2p_tpu_torch.stream import run_stream_job, synthetic_clip

    steps, mp = args.steps, args.mixed_precision
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_", dir="outputs")
    failures, subs, cli = [], {}, None
    t0 = t = time.perf_counter()
    try:
        # the CLI's first (killed) run overlaps the in-process job
        cli = start_stream_cli_kill(args, tmp)
        print(f"stream ({STREAM_FRAMES} synthetic frames, windows of 8 overlapping by "
              f"{STREAM_OVERLAP}, SD-1.5 width, 512²; {_allocated_line()}):", flush=True)
        spec = ProgramSpec(width=512, video_len=8, steps=steps, mixed_precision=mp, seed=0)
        t1 = time.perf_counter()
        engine = EditEngine(spec, out_dir=os.path.join(tmp, "engine"),
                            persist_dir=os.path.join(tmp, "inv_store"), keep_videos=True,
                            store_budget_bytes=int(SERVE_STORE_BUDGET_GB * (1 << 30)),
                            device="cuda")
        try:
            warm = engine.warm(tuple(STREAM_PROMPTS), controller_kwargs=STREAM_REQUEST)
            print(f"  engine up in {time.perf_counter() - t1:.2f} s (warm {warm['seconds']} "
                  "s)", flush=True)
            clip = synthetic_clip(STREAM_FRAMES, 512, seed=0)
            per_window = []
            take = engine.take_videos

            def take_and_measure(rid):
                """The stream job's harvest, with what each window cost: its
                record, its launches and the memory after it."""
                videos = take(rid)
                torch.cuda.synchronize()
                rec = engine.poll(rid)
                per_window.append({
                    "launches": launch_counts(),
                    "allocated": torch.cuda.memory_allocated(),
                    "store_bytes": engine.store.stats()["bytes_in_use"],
                    **{f: rec.get(f) for f in ("queue_wait_s", "resolve_s", "dispatch_s",
                                               "total_s", "store_source", "src_err")}})
                reset_launch_counts()
                return videos

            engine.take_videos = take_and_measure
            job_kw = dict(overlap=STREAM_OVERLAP, seed=0, request_kwargs=STREAM_REQUEST,
                          max_inflight=1)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t1 = time.perf_counter()
            res = run_stream_job(engine, clip, STREAM_PROMPTS,
                                 job_dir=os.path.join(tmp, "job"), **job_kw)
            job_s = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated()
            del engine.take_videos
            totals = {k: sum(w["launches"][k] for w in per_window) for k in launch_counts()}
            for i, w in enumerate(per_window):
                print(f"  window {i}: store {w['store_source']}, queue {w['queue_wait_s']} s, "
                      f"resolve {w['resolve_s']} s, dispatch {w['dispatch_s']} s, total "
                      f"{w['total_s']} s, src_err {w['src_err']!r}; launches "
                      f"{w['launches']}; allocated after it "
                      f"{w['allocated'] / 2 ** 30:.3f} GiB, store "
                      f"{w['store_bytes'] / 2 ** 30:.3f} GiB", flush=True)
            print(f"  job: {job_s:.3f} s wall, health {res.health}; seams "
                  f"{[(s['start'], s['stop'], s['seam_psnr'], s['source_psnr']) for s in res.seams]}; "
                  f"peak {peak / 2 ** 30:.2f} GiB", flush=True)
            h = res.health
            if not (res.complete and h["windows_done"] == STREAM_WINDOWS
                    and h["windows_total"] == STREAM_WINDOWS
                    and h["seams"] == STREAM_WINDOWS - 1 and h["src_err_max"] == 0.0):
                failures.append(f"stream job: {h}")
            if any(w["status"] != "done" or w["src_err"] != 0.0 for w in res.windows):
                failures.append(f"stream windows: {res.windows}")
            if res.video is None or res.video.shape != (STREAM_FRAMES, 512, 512, 3) or \
                    not np.isfinite(res.video).all():
                failures.append(f"stream video: {None if res.video is None else res.video.shape}")
            want = _fresh_launches(steps)
            for i, w in enumerate(per_window):
                if w["launches"] != want:
                    failures.append(f"window {i}: launches {w['launches']}, expected {want}")
            if len(per_window) == STREAM_WINDOWS:
                for i, w in enumerate(per_window[1:], 1):
                    growth = w["store_bytes"] - per_window[0]["store_bytes"]
                    if w["allocated"] > per_window[0]["allocated"] + growth + SERVE_MEM_SLACK_BYTES:
                        failures.append(
                            f"memory grows with the windows: after window {i} "
                            f"{w['allocated']} B, after window 0 {per_window[0]['allocated']} "
                            f"B (store growth {growth} B)")
            if engine._videos:
                failures.append(f"{len(engine._videos)} windows' videos left in the engine")
            t = _sub_seconds(subs, "21 job", t)
            # window 0 against a direct request for frames 0-7
            direct = engine.result(engine.submit(EditRequest(
                frames=clip[:8], prompt=STREAM_PROMPTS[0], prompts=list(STREAM_PROMPTS),
                seed=0, **STREAM_REQUEST)), wait_s=600.0)
            direct_vid = engine.take_videos(direct["id"])
            w0 = res.manifest.valid_output(0)
            w0_ok = direct_vid is not None and np.array_equal(direct_vid[-1], w0)
            print(f"  window 0 against a direct request for frames 0-7 ({direct['status']}, "
                  f"store {direct.get('store_source')}): "
                  f"{'bit for bit' if w0_ok else 'DIFFERS'}", flush=True)
            if not w0_ok:
                failures.append("window 0 differs from a direct request for frames 0-7")
            else:
                # phase 26c's one-window job under torchrun must give these bits
                STREAM_WINDOW0.update(video=direct_vid[-1])
            t = _sub_seconds(subs, "21 direct request", t)
            # checkpoint-then-exit once the first window is harvested, then resume
            stop = threading.Event()

            def take_then_stop(rid):
                stop.set()
                return take(rid)

            engine.take_videos = take_then_stop
            part = run_stream_job(engine, clip, STREAM_PROMPTS,
                                  job_dir=os.path.join(tmp, "job_int"), stop_event=stop,
                                  **job_kw)
            del engine.take_videos
            before = len(engine._requests)
            resumed = run_stream_job(engine, clip, STREAM_PROMPTS,
                                     job_dir=os.path.join(tmp, "job_int"), **job_kw)
            requests = len(engine._requests) - before
            print(f"  stopped after window 0: interrupted {part.health['interrupted']}, done "
                  f"{part.health['windows_done']}; the rerun skipped "
                  f"{resumed.health['windows_skipped']} and sent {requests} requests: "
                  f"{'bit for bit' if resumed.complete and np.array_equal(resumed.video, res.video) else 'DIFFERS'}",
                  flush=True)
            if part.health["interrupted"] != 1 or part.health["windows_done"] != 1 or \
                    part.video is not None:
                failures.append(f"the stopped job: {part.health}")
            if resumed.health["windows_skipped"] != 1 or requests != STREAM_WINDOWS - 1 or \
                    not resumed.complete or not np.array_equal(resumed.video, res.video):
                failures.append(f"the resumed job: {resumed.health}, {requests} requests")
            t = _sub_seconds(subs, "21 stop and resume", t)
        finally:
            engine.close()
        record = {"job_s": job_s, "peak_gib": peak / 2 ** 30, "health": res.health,
                  "seams": res.seams, "windows": per_window, "warm": warm}
        reference = res.video
        del res, part, resumed
        record["cli"], cli_failures = stream_cli_phase(args, cli, reference)
        failures += cli_failures
        _sub_seconds(subs, "21 cli", t)
        record.update(subs)
    finally:
        if cli is not None and cli["proc"].poll() is None:
            cli["proc"].kill()
            cli["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    _release()
    record["path_s"] = time.perf_counter() - t0
    print(f"  stream path: {record['path_s']:.1f} s", flush=True)
    if failures:
        raise AssertionError("stream path: " + "; ".join(failures))
    return {"stream": {"launches": totals, "wall_s": job_s}}, {"stream": record}


# the observability path (phase 22): the loadgen's --router 2 with every
# plane on and replica 1 wrong-but-healthy (OBSERVE_WRONG); its load, and
# the breaker run's (OBSERVE_BREAKER) on replica 0
OBSERVE_REQUESTS = 4
OBSERVE_CONCURRENCY = 2
OBSERVE_WINDOW_SCALE = 0.02
OBSERVE_WRONG = "1:wrong:*"
OBSERVE_BREAKER = "0:unavail@1-999"
OBSERVE_BREAKER_REQUESTS = 6
# the probe records of the run's one round (before the load; the loop's
# next is due an hour later): five single-target probes on each replica and
# on the router, and the store round trip both ways around the ring of two
PROBES_PER_ROUND = 17


def _hit_launches(steps: int) -> dict:
    """The kernels' launches of a store hit: the edit's steps forwards."""
    return {k: v // 2 for k, v in _fresh_launches(steps).items()}


def _bundle_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _bundle_files(path: str) -> list:
    return sorted(os.listdir(path))


class _Child:
    """A subprocess entry point on this card in its own session (so a
    failure kills it and every process it spawned), its output in a log."""

    def __init__(self, name: str, cmd: list, log_path: str, url: str):
        from videop2p_tpu_torch.serve import EngineClient

        self.name, self.log_path = name, log_path
        self.t0 = time.perf_counter()
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(cmd, stdout=self.log, stderr=subprocess.STDOUT,
                                     start_new_session=True)
        self.client = EngineClient(url, timeout_s=60.0, retries=0)
        self.up_s = None

    def tail(self) -> str:
        """The log's end, and the end of each log it names (a router's
        replicas' ``serve.log``)."""
        import re

        if not self.log.closed:
            self.log.flush()
        with open(self.log_path) as fh:
            text = fh.read()[-4000:]
        for path in sorted(set(re.findall(r"\(see (\S+\.log)\)", text))):
            if os.path.isfile(path):
                with open(path) as fh:
                    text += f"\n--- {path} ---\n" + fh.read()[-3000:]
        return text

    def wait_up(self, timeout_s: float = 600.0) -> dict:
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name} exited {self.proc.returncode} before "
                                     f"/healthz answered ({_card_used_line()}):\n"
                                     f"{self.tail()}")
            if time.perf_counter() - self.t0 > timeout_s:
                raise AssertionError(f"{self.name}: /healthz did not answer in {timeout_s} s")
            try:
                health = self.client.healthz()
                self.up_s = time.perf_counter() - self.t0
                return health
            except Exception:  # noqa: BLE001 — not listening yet
                time.sleep(0.5)

    def stop(self, sig=None, timeout_s: float = 300.0):
        """Signal (SIGTERM by default) and wait; None when it had to be killed."""
        import signal

        try:
            self.proc.send_signal(sig or signal.SIGTERM)
            return self.proc.wait(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — killed below
            return None
        finally:
            self.kill()

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        if not self.log.closed:
            self.log.close()


def observe_children(args, tmp: str) -> dict:
    """Start phase 22's subprocesses at once, so that their start-up (≈ 15-30
    s each: a process, the weights, the warm-up) overlaps the in-process
    work: (c) ``cli.serve --slo --incidents`` and (d) ``cli.router --spawn
    2 --incidents``."""
    serve_port, router_port = _free_port(), _free_port()
    common = ["--steps", str(args.steps)]
    return {
        "serve": _Child("cli.serve", [
            sys.executable, "-m", "videop2p_tpu_torch.cli.serve", "--port", str(serve_port),
            "--out_dir", os.path.join(tmp, "serve_cli"), "--slo",
            "--incidents", os.path.join(tmp, "serve_incidents"),
            "--store_budget_gb", str(SERVE_STORE_BUDGET_GB), *common],
            os.path.join(tmp, "serve_cli.log"), f"http://127.0.0.1:{serve_port}"),
        "router": _Child("cli.router", [
            sys.executable, "-m", "videop2p_tpu_torch.cli.router", "--spawn", "2",
            "--port", str(router_port), "--out_dir", os.path.join(tmp, "router_cli"),
            "--incidents", os.path.join(tmp, "router_incidents"),
            "--serve_arg=--store_budget_gb", f"--serve_arg={SERVE_STORE_BUDGET_GB}", *common],
            os.path.join(tmp, "router_cli.log"), f"http://127.0.0.1:{router_port}"),
    }


def observe_router_cli(child, canary: dict, fp: str, out_dir: str) -> tuple:
    """Phase 22d: the answer audit across processes — the canary through
    ``cli.router --spawn 2 --incidents`` once on each ``cli.serve`` child
    (two CUDA contexts): both answers must be the same bits (and, checked
    after phase 22a, the in-process replica 0's). Also the router CLI's
    gates (phase 20b's before its cut): both children healthy, SIGTERM →
    exit 0, each child's ledger closing with ``serve_health`` and the
    router's with ``router_health``. Returns (record, failures)."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.obs.probe import AnswerAudit
    from videop2p_tpu_torch.serve import EngineClient

    failures = []
    health = child.wait_up()
    client = EngineClient(child.client.base_url, timeout_s=60.0)
    t0 = time.perf_counter()
    rid_a = client.submit(dict(canary))
    time.sleep(1.0)  # past the router's probe TTL: replica 0 now shows the load
    rid_b = client.submit(dict(canary))
    recs = [client.result(r, wait_s=600.0) for r in (rid_a, rid_b)]
    pair_s = time.perf_counter() - t0
    metrics = client.metrics()
    rc = child.stop()
    fps = {name: r.get("spec_fingerprint") for name, r in metrics["replicas"].items()}
    audit = AnswerAudit()
    for rec in recs:
        audit.observe(fps.get(rec.get("replica")), rec.get("replica"),
                      rec.get("content_sha256") or "")
    print(f"  cli.router --spawn 2 --incidents up in {child.up_s:.1f} s; the canary on "
          f"{[r.get('replica') for r in recs]}: {[r['status'] for r in recs]}, hashes "
          f"{[str(r.get('content_sha256'))[:16] for r in recs]}, totals "
          f"{[r.get('total_s') for r in recs]} s ({pair_s:.2f} s both); the audit across "
          f"the processes: {audit.summary()}; SIGTERM → exit {rc}", flush=True)
    if health.get("healthy") != 2:
        failures.append(f"cli router: /healthz {health}")
    if sorted(r.get("replica") for r in recs) != ["replica0", "replica1"]:
        failures.append(f"cli router: the two canaries went to {[r.get('replica') for r in recs]}")
    if any(r["status"] != "done" or r.get("src_err") != 0.0 for r in recs):
        failures.append(f"cli router canaries: {[(r['status'], r.get('src_err')) for r in recs]}")
    if recs[0].get("content_sha256") != recs[1].get("content_sha256"):
        failures.append("cli router: the two cli.serve children's canary answers differ: "
                        f"{[r.get('content_sha256') for r in recs]}")
    if set(fps.values()) != {fp} or not audit.summary()["ok"]:
        failures.append(f"cli router: fingerprints {fps} against {fp}, audit {audit.summary()}")
    if rc != 0:
        failures.append(f"cli router exit code {rc} after SIGTERM:\n{child.tail()}")
    kinds = {name: [e["event"] for e in read_ledger(
        os.path.join(out_dir, name, "serve_ledger.jsonl"))] for name in ("replica0", "replica1")}
    router_kinds = [e["event"] for e in read_ledger(os.path.join(out_dir, "router_ledger.jsonl"))]
    print(f"  cli.router: the children's ledgers end "
          f"{ {n: k[-2:] for n, k in kinds.items()} }, the router's holds router_health: "
          f"{'router_health' in router_kinds}", flush=True)
    for name, k in kinds.items():
        if "serve_health" not in k:
            failures.append(f"cli router: {name}'s ledger lacks serve_health: {k[-6:]}")
    if "router_health" not in router_kinds:
        failures.append("cli router: its ledger lacks router_health")
    return {"up_s": child.up_s, "pair_s": pair_s, "rc": rc,
            "replicas": [r.get("replica") for r in recs],
            "totals_s": [r.get("total_s") for r in recs],
            "hashes": [r.get("content_sha256") for r in recs]}, failures


def observe_serve_cli(child, tmp: str) -> tuple:
    """Phase 22c: ``cli.serve --slo --incidents DIR``: SIGUSR1 → a
    ``sigusr1`` bundle; SIGTERM → exit 0 with ``slo_report`` events and the
    ``incident`` in its ledger. Returns (record, failures)."""
    import signal

    from videop2p_tpu_torch.obs import read_ledger

    failures = []
    child.wait_up()
    root = os.path.join(tmp, "serve_incidents")
    t0 = time.perf_counter()
    child.proc.send_signal(signal.SIGUSR1)
    bundles = []
    while time.perf_counter() - t0 < 60.0 and not bundles:
        bundles = [d for d in os.listdir(root) if d.startswith("incident_") and ".tmp" not in d]
        time.sleep(0.1)
    capture_s = time.perf_counter() - t0
    rc = child.stop()
    events = read_ledger(os.path.join(tmp, "serve_cli", "serve_ledger.jsonl"))
    slo = [e for e in events if e["event"] == "slo_report"]
    incidents = [e for e in events if e["event"] == "incident"]
    man = (json.load(open(os.path.join(root, bundles[0], "manifest.json")))
           if bundles else {})
    nbytes = _bundle_bytes(os.path.join(root, bundles[0])) if bundles else 0
    print(f"  cli.serve --slo --incidents up in {child.up_s:.1f} s; SIGUSR1 → bundle "
          f"{bundles} in {capture_s:.2f} s ({nbytes} bytes: "
          f"{_bundle_files(os.path.join(root, bundles[0])) if bundles else []}); SIGTERM → "
          f"exit {rc}; slo_report {[(e['name'], e['actual'], e['compliant']) for e in slo]}",
          flush=True)
    if len(bundles) != 1 or man.get("trigger") != "sigusr1":
        failures.append(f"cli serve: SIGUSR1 bundles {bundles}, trigger {man.get('trigger')}")
    elif not {"manifest.json", "flight.jsonl", "targets.json"} <= set(
            _bundle_files(os.path.join(root, bundles[0]))):
        failures.append(f"cli serve: the sigusr1 bundle holds "
                        f"{_bundle_files(os.path.join(root, bundles[0]))}")
    if rc != 0:
        failures.append(f"cli serve exit code {rc} after SIGTERM:\n{child.tail()}")
    if [e["name"] for e in slo] != ["availability", "deadline_miss_rate"]:
        failures.append(f"cli serve: slo_report events {slo}")
    if [e["trigger"] for e in incidents] != ["sigusr1"]:
        failures.append(f"cli serve: incident events {incidents}")
    return {"up_s": child.up_s, "capture_s": capture_s, "bundle_bytes": nbytes, "rc": rc,
            "slo": [{k: e[k] for k in ("name", "actual", "compliant", "budget_burn")}
                    for e in slo]}, failures


def _loadgen(argv: list, **kw) -> tuple:
    """``tools/serve_loadgen.main`` in this process: (exit code, its summary
    record, wall seconds)."""
    import contextlib
    import io

    from videop2p_tpu_torch.tools import serve_loadgen

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve_loadgen.main(argv, **kw)
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for line in lines[:-1]:
        print(f"    {line}", flush=True)
    return rc, json.loads(lines[-1]), wall


def observe_loadgen_phase(args, tmp: str, programs) -> tuple:
    """Phase 22a: the loadgen's ``--router 2`` with the collector, the
    prober, the SLO reports and the incident plane, replica 1 wrong (two
    answers tie and the first replica's wins: replica 0's). Returns (run,
    record, failures)."""
    from videop2p_tpu_torch.obs import read_ledger

    steps, failures = args.steps, []
    out_dir, inc = os.path.join(tmp, "loadgen"), os.path.join(tmp, "incidents")
    ledger = os.path.join(tmp, "fleet.jsonl")
    argv = ["--router", "2", "--requests", str(OBSERVE_REQUESTS),
            "--concurrency", str(OBSERVE_CONCURRENCY), "--collector", "--probes", "--slo",
            "--incidents", inc, "--replica_faults", OBSERVE_WRONG,
            "--window_scale", str(OBSERVE_WINDOW_SCALE), "--ledger", ledger,
            "--out_dir", out_dir, "--inv_store", os.path.join(tmp, "inv_store"),
            "--scheduler", "fair", "--tenants", "client:1", "--tracing",
            "--probe_interval_s", "3600", "--steps", str(steps), "--device", "cuda"]
    print(f"  loadgen {' '.join(argv)}", flush=True)
    reset_launch_counts()
    rc, rec, wall = _loadgen(argv, programs=programs)
    launches = launch_counts()
    events = read_ledger(ledger)
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    probes = by.get("probe", [])
    rounds = [probes[i:i + PROBES_PER_ROUND] for i in range(0, len(probes), PROBES_PER_ROUND)]
    # per target and round: the wall of its probes, and each probe's latency
    for i, rnd in enumerate(rounds):
        per_target = {}
        for p in rnd:
            per_target.setdefault(p["target"], []).append(p)
        print(f"  probe round {i + 1}: " + "; ".join(
            f"{t} {sum(p['latency_s'] for p in ps):.2f} s ("
            + ", ".join(f"{p['probe']} {p['latency_s']} s{'' if p['ok'] else ' FAIL'}"
                        for p in ps) + ")" for t, ps in per_target.items()), flush=True)
    audits = by.get("probe_audit", [])
    inc_events = by.get("incident", [])
    audit_incidents = [e for e in inc_events if e["trigger"] == "probe_failed"
                       and str(e["detail"]).startswith("answer audit")]
    # the routed submits after the verdict (the router's spans, joined to
    # the load's trace ids through the loadgen's spans)
    router_spans = [e for e in read_ledger(os.path.join(out_dir, "router_ledger.jsonl"))
                    if e["event"] == "span" and e.get("name") == "router.submit"
                    and e.get("replica")]
    load_traces = {e["trace_id"] for e in by.get("span", []) if e.get("name") == "loadgen.request"}
    verdict_ns = audit_incidents[0]["wall_ns"] if audit_incidents else None
    after = ([s for s in router_spans if s["wall_ns"] > verdict_ns]
             if verdict_ns is not None else [])
    load_after = [s for s in after if s["trace_id"] in load_traces]
    per_replica_load = {}
    for s in router_spans:
        if s["trace_id"] in load_traces:
            per_replica_load[s["replica"]] = per_replica_load.get(s["replica"], 0) + 1
    # launches: the warm-up's (a fresh request's, twice on a set that keeps
    # runners: its second pass runs the loops again to capture), every fresh
    # or rehydrated request a fresh request's, every memory hit a hit's
    health = {e["label"]: e for e in by.get("serve_health", [])}
    warm = 2 if programs.keeps_graphs() else 1
    full = warm + sum(h["fresh_inversions"] + h["rehydrations"] for h in health.values())
    hits = sum(h["done"] for h in health.values()) - (full - warm)
    fresh, hit = _fresh_launches(steps), _hit_launches(steps)
    want = {k: full * fresh[k] + hits * hit[k] for k in fresh}
    bundles = {e["bundle"]: _bundle_bytes(e["bundle"]) for e in inc_events
               if e.get("bundle")}
    signals = rec.get("signals", {})
    tenants = rec.get("tenants", {})
    healthz = rec.get("router_healthz", {}).get("replicas", {})
    print(f"  loadgen --router 2: rc {rc}, {rec['done']}/{rec['requests']} done, errors "
          f"{rec['errors']}, wall {rec['wall_s']} s (the whole run {wall:.1f} s); client lane "
          f"p50 {tenants.get('client', {}).get('p50_s')} p99 "
          f"{tenants.get('client', {}).get('p99_s')} s, queue-wait p99 "
          f"{tenants.get('client', {}).get('queue_wait_p99_s')} s; load per replica "
          f"{per_replica_load}", flush=True)
    print(f"  collector: {signals.get('scrapes')} passes over 3 targets, "
          f"{signals.get('scrape_s')} s in all ("
          f"{1e3 * signals.get('scrape_s', 0) / max(signals.get('scrapes') or 1, 1):.2f} ms a "
          f"pass, {100 * signals.get('scrape_s', 0) / wall:.3f} % of the run), errors "
          f"{signals.get('scrape_errors')}, {signals.get('series')} series, "
          f"{signals.get('samples')} samples; fleet_signals {len(by.get('fleet_signals', []))}, "
          f"advice {signals.get('advice')}, burn alerts {signals.get('burn_alerts')}", flush=True)
    print(f"  prober: {rec.get('probes', {}).get('rounds')} rounds, "
          f"{rec.get('probes', {}).get('probes')} probes, failures "
          f"{rec.get('probes', {}).get('probe_failures')}, status "
          f"{rec.get('probes', {}).get('status')}; audits "
          f"{[(a['divergent'], a['hash_a'][:12], a['hash_b'][:12]) for a in audits]}; the "
          f"router's /healthz: replica1 {healthz.get('replica1', {}).get('probe_status')}; "
          f"routed after the verdict: {[s['replica'] for s in after]} ({len(load_after)} of "
          f"them load); router_health {rec.get('router')}", flush=True)
    print(f"  incidents: {[(e['trigger'], e['events'], e['suppressed']) for e in inc_events]}, "
          f"bundles {list(bundles.values())} bytes; slo_report "
          f"{[(e['name'], e['actual'], e['compliant']) for e in by.get('slo_report', [])]}; "
          f"launches {launches} (want {want}: {full} fresh-or-rehydrated incl. the warm-up, "
          f"{hits} hits)", flush=True)
    if rc != 0 or rec["done"] != OBSERVE_REQUESTS or rec["errors"]:
        failures.append(f"observe loadgen: rc {rc}, done {rec['done']}, errors {rec['errors']}")
    if not audits or {a["divergent"] for a in audits} != {"replica1"} or \
            audits[0]["replica_a"] != "replica0":
        failures.append(f"observe: probe_audit events {audits}")
    if rec.get("probes", {}).get("quarantined") != ["replica1"] or \
            healthz.get("replica1", {}).get("probe_status") != "quarantine" or \
            not healthz.get("replica1", {}).get("quarantined"):
        failures.append(f"observe: quarantine {rec.get('probes', {}).get('quarantined')}, the "
                        f"router's /healthz {healthz}")
    # the round ran before the load: every load request came after the
    # verdict, and none of them went to replica 1
    if verdict_ns is None or len(load_after) != OBSERVE_REQUESTS or any(
            s["replica"] == "replica1" for s in after):
        failures.append(f"observe: routed after the verdict {[s['replica'] for s in after]}, "
                        f"{len(load_after)} of them load (verdict at {verdict_ns})")
    if len(probes) != PROBES_PER_ROUND:
        failures.append(f"observe: {len(probes)} probe records, not one round of "
                        f"{PROBES_PER_ROUND}")
    else:
        judged = [p for p in probes if p["target"] in ("replica0", "router")]
        bad = [p for p in judged if not p["ok"]
               or (p["probe"] == "cached_replay" and "src_err=0.0" not in p["detail"])
               or (p["probe"] == "determinism" and p["detail"] != "bit-identical")]
        if bad:
            failures.append(f"observe: probes of replica 0 / the router: {bad}")
    if not audit_incidents or not {"manifest.json", "flight.jsonl", "targets.json"} <= set(
            _bundle_files(audit_incidents[0]["bundle"])):
        failures.append(f"observe: probe_failed incidents {inc_events}")
    sidecar = (by.get("fleet_series") or [{}])[0].get("sidecar")
    if not by.get("fleet_signals") or not sidecar or not os.path.isfile(sidecar) or \
            not by.get("slo_report"):
        failures.append(f"observe: fleet_signals {len(by.get('fleet_signals', []))}, "
                        f"fleet_series {by.get('fleet_series')}, slo_report "
                        f"{len(by.get('slo_report', []))}")
    if launches != want:
        failures.append(f"observe: launches {launches}, expected {want}")
    record = {"rc": rc, "wall_s": wall, "summary": {k: rec.get(k) for k in (
        "requests", "done", "errors", "store_hits", "wall_s", "latency", "tenants", "router",
        "signals", "probes", "incidents")},
        "rounds": [[{k: p[k] for k in ("probe", "target", "ok", "latency_s")} for p in r]
                   for r in rounds],
        "answer": audits[0]["hash_a"] if audits else None,
        "routed_after_verdict": [s["replica"] for s in after], "load_after_verdict":
        len(load_after), "load_per_replica": per_replica_load, "bundle_bytes": bundles,
        "launches": launches, "want_launches": want}
    return {"launches": launches, "wall_s": wall}, record, failures


def observe_breaker_phase(args, tmp: str, programs) -> tuple:
    """Phase 22b: the loadgen's ``--router 2 --incidents`` with replica 0
    unavailable: its breaker opens on the first failed dispatch and stays
    open, a ``breaker_open`` bundle is written, the router sheds to replica
    1 (the chaos default: at least half the accepted requests done).
    Returns (record, failures)."""
    from videop2p_tpu_torch.obs import read_ledger

    failures = []
    inc, ledger = os.path.join(tmp, "breaker_incidents"), os.path.join(tmp, "breaker.jsonl")
    argv = ["--router", "2", "--requests", str(OBSERVE_BREAKER_REQUESTS), "--concurrency",
            str(OBSERVE_CONCURRENCY), "--incidents", inc, "--replica_faults", OBSERVE_BREAKER,
            "--breaker_threshold", "1", "--breaker_open_s", "600", "--ledger", ledger,
            "--out_dir", os.path.join(tmp, "breaker"), "--inv_store",
            os.path.join(tmp, "inv_store"), "--steps", str(args.steps), "--device", "cuda"]
    rc, rec, wall = _loadgen(argv, programs=programs)
    incs = [e for e in read_ledger(ledger) if e["event"] == "incident"]
    opened = [e for e in incs if e["trigger"] == "breaker_open"]
    files = _bundle_files(opened[0]["bundle"]) if opened else []
    nbytes = _bundle_bytes(opened[0]["bundle"]) if opened else 0
    man = json.load(open(os.path.join(opened[0]["bundle"], "manifest.json"))) if opened else {}
    print(f"  breaker: rc {rc}, {rec['done']}/{rec['requests']} done, errors {rec['errors']}, "
          f"router {rec.get('router')}; incidents {[e['trigger'] for e in incs]}, the "
          f"breaker_open bundle {nbytes} bytes {files} ({man.get('detail')}); {wall:.1f} s",
          flush=True)
    if rc != 0 or not opened or not {"manifest.json", "flight.jsonl", "targets.json"} <= set(
            files):
        failures.append(f"observe breaker: rc {rc}, incidents {incs}, bundle files {files}")
    if (rec.get("router") or {}).get("per_replica", {}).get("replica1", 0) < 1:
        failures.append(f"observe breaker: nothing shed to replica 1: {rec.get('router')}")
    return {"rc": rc, "wall_s": wall, "done": rec["done"], "errors": rec["errors"],
            "bundle_bytes": nbytes, "router": rec.get("router")}, failures


def observe_path(args) -> tuple:
    """Phase 22 (path "observe"): the fleet's telemetry, correctness and
    incident planes at SD-1.5 width, 512², 8 frames, ``--steps``, fp32.
    Returns (runs, records)."""
    from videop2p_tpu_torch.obs.probe import ProbeSuite
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.tools.serve_loadgen import build_parser, request_from_args

    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_", dir="outputs")
    t0 = time.perf_counter()
    failures, record = [], {}
    children = {}
    try:
        print(f"observe (SD-1.5 width, 512², 8 frames, fp32; {_allocated_line()}):", flush=True)
        children = observe_children(args, tmp)
        torch.cuda.reset_peak_memory_stats()
        # the loadgen's request and the canary its prober derives from it
        canary = ProbeSuite(request_from_args(build_parser().parse_args(["--inproc"]))).canary
        t1 = t = time.perf_counter()
        programs = ProgramSet(ProgramSpec(width=512, video_len=8, steps=args.steps),
                              device="cuda")
        warm = programs.warm(tuple(canary["prompts"]))
        print(f"  the set built and warm in {time.perf_counter() - t1:.2f} s "
              f"(warm {warm['seconds']} s; {_card_used_line()})", flush=True)
        t = _sub_seconds(record, "22 set", t)
        # (b) while the children start, then (d) and (c), so that (a) has
        # the card and the host to itself
        record["breaker"], f = observe_breaker_phase(args, tmp, programs)
        failures += f
        t = _sub_seconds(record, "22b breaker", t)
        print(f"  after 22b: {_card_used_line()}", flush=True)
        record["router_cli"], f = observe_router_cli(children["router"], canary,
                                                     programs.spec.fingerprint(),
                                                     os.path.join(tmp, "router_cli"))
        failures += f
        t = _sub_seconds(record, "22d router cli", t)
        record["serve_cli"], f = observe_serve_cli(children["serve"], tmp)
        failures += f
        t = _sub_seconds(record, "22c serve cli", t)
        run, record["loadgen"], f = observe_loadgen_phase(args, tmp, programs)
        failures += f
        t = _sub_seconds(record, "22a loadgen", t)
        answer = record["loadgen"]["answer"]
        print(f"  the canary's answer: in process (replica 0) {str(answer)[:16]}…, the "
              f"cli.serve children {[str(h)[:16] for h in record['router_cli']['hashes']]}",
              flush=True)
        if set(record["router_cli"]["hashes"]) != {answer}:
            failures.append(f"observe: the children's canary answers "
                            f"{record['router_cli']['hashes']} against the in-process {answer}")
        record["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del programs
        if "tools" in args.paths and not failures:
            # phase 27 reads the loadgen's fleet ledger, its span ledgers
            # and its bundle, and then deletes the directory
            TOOLS_HANDOFF["observe"] = {"dir": tmp, "fleet": os.path.join(tmp, "fleet.jsonl"),
                                        "out_dir": os.path.join(tmp, "loadgen")}
    finally:
        for child in children.values():
            child.kill()
        if "observe" not in TOOLS_HANDOFF:
            shutil.rmtree(tmp, ignore_errors=True)
    _release()
    record["path_s"] = time.perf_counter() - t0
    print(f"  observe path: {record['path_s']:.1f} s, peak {record['peak_gib']:.2f} GiB "
          f"(this process)", flush=True)
    if failures:
        raise AssertionError("observe path: " + "; ".join(failures))
    return {"observe": run}, {"observe": record}


# the run CLIs' observability (path "runs", phase 23): the flags every
# flags-on run of run_videop2p takes, official mode's inner steps and the
# tuning run's depth (TUNE cut to 2 steps, validation at 2 × 2 steps)
RUN_OBS_FLAGS = dict(telemetry=True, attn_maps=True, quality=True, report=True,
                     latency=True)
RUN_OBS_INNER_STEPS = 2
RUN_OBS_TUNE = dict(max_train_steps=2, checkpointing_steps=0, validation_steps=2,
                    log_every=1, validation_data=dict(TUNE["validation_data"],
                                                      num_inv_steps=2,
                                                      num_inference_steps=2))


def _bundles(root: str) -> list:
    """The capture bundles under an incident root (directories with a
    manifest; the root also holds the faulthandler log)."""
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if os.path.isfile(os.path.join(root, d, "manifest.json")))


def _same_bits(name: str, a: dict, b: dict, failures: list, keys=("latents", "videos")):
    for k in keys:
        if not torch.equal(a[k], b[k]):
            failures.append(f"{name}: {k} differ with the flags on")
    if a["launches"] != b["launches"]:
        failures.append(f"{name}: launches {b['launches']} with the flags on, "
                        f"{a['launches']} off")


def _file_bytes(path) -> int:
    return os.path.getsize(path) if path and os.path.isfile(path) else 0


def runs_fast_phase(args, frames, tmp: str, failures: list) -> dict:
    """Phase 23a: the cached fast edit off, on, on (one ledger)."""
    from videop2p_tpu_torch.obs import history
    from videop2p_tpu_torch.obs.ledger import read_ledger
    from videop2p_tpu_torch.obs.quality import QUALITY_SUMMARY_FIELDS

    ckpt, led, inc = (os.path.join(tmp, n) for n in ("rabbit-jump", "fast_ledger.jsonl",
                                                     "incidents"))
    kw = dict(pretrained_model_path=ckpt, keep_videos=True)
    off = run_main_path(frames, args.steps, args.mixed_precision, **kw)
    expect_launches(off, args.steps, "auto")
    on = [run_main_path(frames, args.steps, args.mixed_precision, ledger=led, incidents=inc,
                        **RUN_OBS_FLAGS, **kw) for _ in range(2)]
    for i, run in enumerate(on):
        _same_bits(f"23a run {i + 1}", off, run, failures)
    runs = history.split_runs(read_ledger(led))
    if len(runs) != 2:
        failures.append(f"23a: the ledger holds {len(runs)} runs, not 2")
        return {"off": off, "on": on}
    for i, events in enumerate(runs):
        by_kind = {}
        for e in events:
            by_kind.setdefault(e["event"], []).append(e)
        need = {"phase", "execute_timing", "telemetry", "attn_maps", "quality", "memory"}
        missing = need - set(by_kind)
        if missing:
            failures.append(f"23a run {i + 1}: no {sorted(missing)} event")
            continue
        if [e["program"] for e in by_kind["execute_timing"]] != ["cached_invert_edit"]:
            failures.append(f"23a run {i + 1}: execute_timing {by_kind['execute_timing']}")
        tel = by_kind["telemetry"][0]
        if (tel["program"] != "cached_invert_edit" or tel["summary"]["steps"] != args.steps
                or tel["summary"]["nan_total"] or tel["summary"]["inf_total"]):
            failures.append(f"23a run {i + 1}: telemetry {tel['summary']}")
        if sorted(e["scope"] for e in by_kind["attn_maps"]) != ["edit", "inversion"]:
            failures.append(f"23a run {i + 1}: attn_maps scopes")
        quality = by_kind["quality"][0]
        if not all(math.isfinite(quality[k]) for k in QUALITY_SUMMARY_FIELDS):
            failures.append(f"23a run {i + 1}: quality {quality}")
        mem = [e for e in by_kind["memory"] if e["note"] == "after_cached_edit"]
        if not mem or not mem[0]["supported"] or not mem[0]["peak_bytes_in_use"]:
            failures.append(f"23a run {i + 1}: memory snapshot {mem}")
        has_verdicts = "regression_verdicts" in by_kind
        if has_verdicts != (i == 1):
            failures.append(f"23a run {i + 1}: regression_verdicts {has_verdicts}")
        elif has_verdicts:
            v = by_kind["regression_verdicts"][0]
            print(f"  23a verdicts: pass {v['pass']}, {len(v['verdicts'])} verdicts, "
                  f"regressions {[r['rule'] for r in v['regressions']]}", flush=True)
        print(f"  23a run {i + 1}: telemetry {tel['summary']}; quality "
              + ", ".join(f"{k} {quality[k]}" for k in QUALITY_SUMMARY_FIELDS), flush=True)
    for run in on:
        if not run["report"] or not os.path.isfile(run["report"]):
            failures.append(f"23a: no report at {run['report']!r}")
    if _bundles(inc):
        failures.append(f"23a: incident bundles on a healthy run: {_bundles(inc)}")
    sizes = {"ledger": _file_bytes(led), "sidecar": _file_bytes(on[-1]["sidecar"]),
             "report": _file_bytes(on[-1]["report"])}
    print(f"  23a wall off {off['wall_s']:.3f} s, on {on[0]['wall_s']:.3f} / "
          f"{on[1]['wall_s']:.3f} s; cached_invert_edit off "
          f"{off['timings']['cached_invert_edit']:.3f} s, on "
          f"{on[0]['timings']['cached_invert_edit']:.3f} / "
          f"{on[1]['timings']['cached_invert_edit']:.3f} s; bytes {sizes}", flush=True)
    return {"off": off, "on": on, "bytes": sizes}


def runs_official_phase(args, frames, tmp: str, failures: list) -> dict:
    """Phase 23b: official mode with --telemetry --latency beside the same
    run off; the null-text phase and the edit are two programs, so the edit's
    execute timing holds the edit alone."""
    from videop2p_tpu_torch.obs.ledger import read_ledger

    ckpt, led = os.path.join(tmp, "rabbit-jump"), os.path.join(tmp, "official_ledger.jsonl")
    kw = dict(pretrained_model_path=ckpt, keep_videos=True, fast=False,
              num_inner_steps=RUN_OBS_INNER_STEPS)
    off = run_main_path(frames, args.steps, args.mixed_precision, **kw)
    on = run_main_path(frames, args.steps, args.mixed_precision, ledger=led, telemetry=True,
                       latency=True, **kw)
    _same_bits("23b", off, on, failures)
    expect_launches(on, args.steps, "auto")
    events = read_ledger(led)
    timing = {e["program"]: e for e in events if e["event"] == "execute_timing"}
    if sorted(timing) != ["ddim_inversion", "edit_sample", "null_text_fused"]:
        failures.append(f"23b: execute_timing programs {sorted(timing)}")
    else:
        edit_s, null_s = (timing[p]["blocked_p50_s"] for p in ("edit_sample",
                                                               "null_text_fused"))
        if not edit_s < null_s:
            failures.append(f"23b: edit_sample {edit_s} s, not below null_text_fused "
                            f"{null_s} s: the edit's timing holds the null-text phase")
        print(f"  23b execute timing: ddim_inversion "
              f"{timing['ddim_inversion']['blocked_p50_s']} s, null_text_fused {null_s} s, "
              f"edit_sample {edit_s} s", flush=True)
    tel = {e["program"]: e for e in events if e["event"] == "telemetry"}
    rec = tel.get("null_text_fused")
    if (rec is None or len(rec["loss_curve"]) != args.steps
            or rec["inner_steps"] != on["null_text"]["inner_steps"]
            or rec["latent"]["steps"] != args.steps or rec["latent"]["nan_total"]):
        failures.append(f"23b: null-text record {rec}")
    else:
        print(f"  23b null-text record: loss curve {rec['loss_curve']}, inner steps "
              f"{rec['inner_steps']}, latent {rec['latent']}", flush=True)
    print(f"  23b wall off {off['wall_s']:.3f} s, on {on['wall_s']:.3f} s; null-text off "
          f"{off['timings']['null_text_optimization']:.3f} s, on "
          f"{on['timings']['null_text_optimization']:.3f} s; ledger {_file_bytes(led)} B",
          flush=True)
    return {"off": off, "on": on}


def runs_tune_phase(tmp: str, failures: list) -> dict:
    """Phase 23c: the tuning run with --ledger --telemetry --latency beside
    the same without."""
    from videop2p_tpu_torch.obs.ledger import read_ledger

    led = os.path.join(tmp, "tune_ledger.jsonl")
    out = {}
    for name, extra in (("off", {}), ("on", dict(ledger=led, telemetry=True, latency=True))):
        out[name] = run_tuning_main(
            **RUN_OBS_TUNE, pretrained_model_path=os.path.join(tmp, "no_checkpoint"),
            output_dir=os.path.join(tmp, f"tune_{name}", "rabbit-jump"), **extra)
        expect_tune_launches(out[name], RUN_OBS_TUNE["max_train_steps"], 1,
                             RUN_OBS_TUNE["validation_data"])
        with open(os.path.join(out[name]["dir"], "metrics.jsonl")) as f:
            out[name]["metrics"] = [json.loads(line) for line in f]
    losses = {k: [m["train_loss"] for m in v["metrics"]] for k, v in out.items()}
    if losses["on"] != losses["off"]:
        failures.append(f"23c: losses {losses['on']} with the flags on, {losses['off']} off")
    if out["on"]["launches"] != out["off"]["launches"]:
        failures.append("23c: launches differ with the flags on")
    events = read_ledger(led)
    norms = [e.get("grad_norm") for e in events if e["event"] == "metric"]
    if len(norms) != RUN_OBS_TUNE["max_train_steps"] or not all(
            n is not None and math.isfinite(n) and n > 0 for n in norms):
        failures.append(f"23c: grad norms {norms}")
    timing = [(e["program"], e["count"]) for e in events if e["event"] == "execute_timing"]
    if timing != [("train_steps", RUN_OBS_TUNE["max_train_steps"])]:
        failures.append(f"23c: execute_timing {timing}")
    print(f"  23c grad norms {norms}, losses {losses['on']}, execute_timing {timing}; wall "
          f"off {out['off']['wall_s']:.3f} s, on {out['on']['wall_s']:.3f} s; ledger "
          f"{_file_bytes(led)} B", flush=True)
    return out


def runs_path(args, frames) -> tuple:
    """Phase 23 (path "runs"): the run CLIs' observability. Returns (runs,
    records); raises on a failed gate."""
    print(f"run CLIs' observability (phase 23; {_allocated_line()}):", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runs_", dir="outputs")
    failures: list = []
    t0 = time.perf_counter()
    handed = False
    try:
        fast = runs_fast_phase(args, frames, tmp, failures)
        official = runs_official_phase(args, frames, tmp, failures)
        tune = runs_tune_phase(tmp, failures)
        if "tools" in args.paths and not failures:
            # phase 27 reads the fast edits' ledger (and the sidecars and
            # reports it names) and then deletes the directory
            TOOLS_HANDOFF["runs"] = {"dir": tmp,
                                     "ledger": os.path.join(tmp, "fast_ledger.jsonl")}
            handed = True
    finally:
        if not handed:
            shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"  phase 23: {wall:.1f} s", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))

    def slim(run):
        return {k: v for k, v in run.items() if k not in ("latents", "videos", "x_t")}

    record = {"wall_s": wall, "bytes": fast["bytes"],
              "fast": {"off": slim(fast["off"]), "on": [slim(r) for r in fast["on"]]},
              "official": {k: slim(v) for k, v in official.items()},
              "tune": {k: {kk: vv for kk, vv in v.items() if kk != "metrics"}
                       for k, v in tune.items()}}
    return {"runs": slim(fast["on"][0])}, {"runs": record}


# program analysis, device traces and the demo layer (path "analysis",
# phase 24): the tuning run's cut (3 steps, one a chunk, validation at the
# end at 2 × 2 steps) and the UI's sampling steps
ANALYSIS_TUNE = dict(max_train_steps=3, steps_per_call=1, checkpointing_steps=0,
                     validation_steps=0, log_every=1,
                     validation_data=dict(TUNE["validation_data"], num_inv_steps=2,
                                          num_inference_steps=2))
UI_STEPS = 2


@contextlib.contextmanager
def _analysis_off():
    """The program analysis' kill switch (``VIDEOP2P_OBS_NO_ANALYSIS=1``)
    for this process and the children it starts inside the block."""
    prev = os.environ.get("VIDEOP2P_OBS_NO_ANALYSIS")
    os.environ["VIDEOP2P_OBS_NO_ANALYSIS"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("VIDEOP2P_OBS_NO_ANALYSIS", None)
        else:
            os.environ["VIDEOP2P_OBS_NO_ANALYSIS"] = prev


def _ledger_events(path: str, kind: str) -> list:
    from videop2p_tpu_torch.obs.ledger import read_ledger

    return [e for e in read_ledger(path) if e["event"] == kind]


def _trace_kernel_counts(trace_dir: str) -> dict:
    """The hand kernels' device events in a window's chrome trace: frame
    attention (its fp32 prep kernels left out: the wrapper counts a call),
    GroupNorm, and every kernel."""
    from videop2p_tpu_torch.obs.trace import OP_CATEGORIES, load_chrome_traces, trace_events

    names = [n for n, _, _ in trace_events(load_chrome_traces(trace_dir), OP_CATEGORIES)]
    return {"frame_attention": sum("frame_attention" in n and "prep" not in n for n in names),
            "group_norm": sum("gn_persistent" in n for n in names), "all": len(names)}


def _check_trace(label: str, ev: dict, run_launches: dict, failures: list) -> dict:
    """A trace_analysis event against the counters: its kernels in the
    chrome trace equal the launches the wrappers counted over the window."""
    found = _trace_kernel_counts(ev["trace_dir"])
    for kernel in ("frame_attention", "group_norm"):
        if found[kernel] != ev["launches"][kernel]:
            failures.append(f"{label}: {found[kernel]} {kernel} kernels in the trace, "
                            f"{ev['launches'][kernel]} counted over the window")
        if run_launches is not None and ev["launches"][kernel] != run_launches[kernel]:
            failures.append(f"{label}: {ev['launches'][kernel]} {kernel} launches in the "
                            f"window, {run_launches[kernel]} in the run")
    if not ev["num_events"] or not found["group_norm"]:
        failures.append(f"{label}: the trace holds no kernel ({found})")
    fams = list(ev["families"].items())[:6]
    print(f"  {label} trace: {ev['num_events']} device events, {found}; device "
          f"{ev['device_total_s']:.4f} s, idle {ev['idle_s']:.4f} of span {ev['span_s']:.4f} s "
          f"({ev['idle_s'] / max(ev['span_s'], 1e-12):.1%}), module span "
          f"{ev['module_span_s']:.4f} s; "
          "families " + ", ".join(f"{k} {v:.4f}" for k, v in fams), flush=True)
    return {"kernels": found, "families": ev["families"], "idle_s": ev["idle_s"],
            "span_s": ev["span_s"], "device_total_s": ev["device_total_s"],
            "module_total_s": ev["module_total_s"], "module_span_s": ev["module_span_s"],
            "num_events": ev["num_events"]}


def _analysis_line(rec: dict) -> str:
    return (f"flops {rec['flops']:.6e}, transcendentals {rec['transcendentals']:.6e}, bytes "
            f"{rec['bytes_accessed']:.6e}, temp {rec['temp_bytes'] / 2 ** 30:.3f} GiB, "
            f"{rec['hlo_instructions']} ops, code {rec['generated_code_bytes']} B, "
            f"analysis {rec['analysis_s']:.3f} s")


def kernel_report_checks(dtype) -> dict:
    """The wrappers' reports into an analysis on the card, exactly: the
    fused forward at the cached edit's largest site, flash_rect forward +
    backward at null-text's, GroupNorm + SiLU at the 64² resnet slab."""
    from videop2p_tpu_torch.obs.introspect import analyze_call
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(24)
    out = {}

    def rand(*shape, grad=False):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype).requires_grad_(grad)

    b, f, h, n, d = 2, 8, 8, 4096, 40
    q, k, v = rand(b, f, h, n, d), rand(b, h, n, d), rand(b, h, n, d)
    with torch.no_grad():
        rec = analyze_call(fa.fused_frame_attention, q, k, v)[1]
    scores = b * f * h * n * n
    out["fused"] = (rec["flops"], rec["transcendentals"], 4 * scores * d, scores)
    b = 1
    q, k, v = rand(b, f, h, n, d, grad=True), rand(b, h, n, d, grad=True), rand(b, h, n, d,
                                                                                grad=True)

    def fwd_bwd(q, k, v):
        fa.flash_rect_frame_attention(q, k, v).float().sum().backward()
        return q.grad

    rec = analyze_call(fwd_bwd, q, k, v)[1]
    scores = b * f * h * n * n
    out["flash_rect_fwd_bwd"] = (rec["flops"], rec["transcendentals"], 18 * scores * d,
                                 3 * scores)
    x = rand(2, 8 * 4096, 320)
    scale, bias = rand(320), rand(320)
    with torch.no_grad():
        rec = analyze_call(lambda x: gn.fused_group_norm(x, scale, bias, num_groups=32,
                                                         act="silu"), x)[1]
    out["group_norm_silu"] = (rec["flops"], rec["transcendentals"], 0, x.numel())
    torch.cuda.synchronize()
    del q, k, v, x
    torch.cuda.empty_cache()
    return out


def analysis_fast_phase(args, frames, tmp: str, failures: list) -> dict:
    """Phase 24a: the analysed and traced fast edit."""
    from videop2p_tpu_torch.cli.common import build_models
    from videop2p_tpu_torch.obs import history
    from videop2p_tpu_torch.obs.ledger import read_ledger

    ckpt, led, dense_led = (os.path.join(tmp, n) for n in (
        "rabbit-jump", "fast_ledger.jsonl", "dense_ledger.jsonl"))
    kw = dict(pretrained_model_path=ckpt, keep_videos=True, ledger=led)
    fast = [run_main_path(frames, args.steps, args.mixed_precision, trace_analysis=True, **kw)
            for _ in range(2)]
    fast.append(run_main_path(frames, args.steps, args.mixed_precision,
                              program_analysis=False, **kw))
    for run in fast:
        expect_launches(run, args.steps, "auto")
    for i, run in enumerate(fast[1:], 2):
        _same_bits(f"24a run {i}", fast[0], run, failures)
    runs = history.split_runs(read_ledger(led))
    if len(runs) != 3:
        failures.append(f"24a: the ledger holds {len(runs)} runs, not 3")
        return {"runs": fast}
    pa = [[e for e in r if e["event"] == "program_analysis"
           and e["program"] == "cached_invert_edit"] for r in runs]
    skips = [[(e["program"], e["reason"]) for e in r
              if e["event"] == "program_analysis_skipped"] for r in runs]
    if [len(p) for p in pa] != [1, 1, 0] or skips != [[], [], [("cached_invert_edit",
                                                               "disabled")]]:
        failures.append(f"24a: analyses {[len(p) for p in pa]}, skips {skips}")
        return {"runs": fast}
    recs = [pa[0][0], pa[1][0]]
    allocator = ("temp_bytes", "peak_hbm_bytes")
    varying = sorted(k for k in recs[0] if k not in ("t", "analysis_s")
                     and recs[0][k] != recs[1][k])
    if set(varying) - set(allocator):
        failures.append(f"24a: the analyses of runs 1 and 2 differ in {varying}")
    # "dense" frame attention: aten products where "auto" launches the kernel
    bundle = build_models(dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[
        args.mixed_precision], device="cuda", seed=0, frame_attention="dense")
    dense = run_main_path(frames, args.steps, args.mixed_precision, bundle=bundle,
                          ledger=dense_led)
    del bundle
    if dense["launches"]["frame_attention"]:
        failures.append(f"24a: the dense run launched {dense['launches']}")
    drec = [e for e in _ledger_events(dense_led, "program_analysis")
            if e["program"] == "cached_invert_edit"]
    if not drec:
        failures.append("24a: no analysis of the dense run")
    else:
        for key in ("flops", "transcendentals"):
            if drec[0][key] != recs[0][key]:
                failures.append(f"24a: {key} {recs[0][key]} (auto) != {drec[0][key]} (dense)")
    traces = [[e for e in r if e["event"] == "trace_analysis"] for r in runs]
    skipped = [e for r in runs for e in r if e["event"] == "trace_analysis_skipped"]
    if skipped or [len(t) for t in traces] != [1, 1, 0]:
        failures.append(f"24a: traces {[len(t) for t in traces]}, skipped {skipped}")
        return {"runs": fast}
    trace_recs = [_check_trace(f"24a run {i + 1}", traces[i][0], fast[i]["launches"], failures)
                  for i in range(2)]
    compiles = [[e["seconds"] for e in r if e["event"] == "compile"
                 and e.get("program") == "cached_invert_edit"] for r in runs]
    print(f"  24a cached_invert_edit (auto): {_analysis_line(recs[0])}; run 2 analysis "
          f"{recs[1]['analysis_s']:.3f} s; varying between runs: {varying or 'nothing'}",
          flush=True)
    if drec:
        print(f"  24a cached_invert_edit (dense): {_analysis_line(drec[0])}", flush=True)
    print(f"  24a first-call (compile) seconds: {compiles}; cached_invert_edit phase "
          + ", ".join(f"{r['timings']['cached_invert_edit']:.3f}" for r in fast)
          + f" s (traced, traced, not analysed); dense "
          f"{dense['timings']['cached_invert_edit']:.3f} s", flush=True)
    return {"runs": fast, "analysis": recs, "dense_analysis": drec[0] if drec else None,
            "varying": varying, "traces": trace_recs, "compile_s": compiles,
            "dense_timings": dense["timings"]}


def analysis_official_phase(args, frames, tmp: str, failures: list) -> dict:
    """Phase 24b: official mode's programs under flash_rect, analysed."""
    from videop2p_tpu_torch.cli.common import build_models

    led = os.path.join(tmp, "official_ledger.jsonl")
    bundle = build_models(dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[
        args.mixed_precision], device="cuda", seed=0, frame_attention="flash_rect")
    run = run_main_path(frames, args.steps, args.mixed_precision, fast=False, bundle=bundle,
                        num_inner_steps=args.inner_steps, ledger=led)
    del bundle
    expect_launches(run, args.steps, "flash_rect")
    pa = {e["program"]: e for e in _ledger_events(led, "program_analysis")}
    if sorted(pa) != ["ddim_inversion", "edit_sample", "null_text_fused"]:
        failures.append(f"24b: analysed programs {sorted(pa)}")
        return {"run": run}
    hist = {p: pa[p]["hlo_histogram"] for p in pa}
    fwd = sum(h.get("flash_attention_fwd", 0) for h in hist.values())
    if fwd != run["launches"]["flash_attention"]:
        failures.append(f"24b: {fwd} flash forwards analysed, {run['launches']} launched")
    for key in ("dq", "dkv"):
        got = hist["null_text_fused"].get(f"flash_attention_bwd_{key}", 0)
        if got != run["launches"][f"flash_bwd_{key}"] or not got:
            failures.append(f"24b: null_text_fused holds {got} flash_attention_bwd_{key}, "
                            f"{run['launches'][f'flash_bwd_{key}']} launched")
        if any(h.get(f"flash_attention_bwd_{key}") for p, h in hist.items()
               if p != "null_text_fused"):
            failures.append(f"24b: a backward kernel outside null_text_fused: {hist}")
    for p in ("ddim_inversion", "null_text_fused", "edit_sample"):
        print(f"  24b {p}: {_analysis_line(pa[p])}", flush=True)
    return {"run": run, "analysis": {p: {k: v for k, v in pa[p].items() if k != "hlo_histogram"}
                                     for p in pa}}


def analysis_tune_phase(tmp: str, failures: list) -> dict:
    """Phase 24c: Stage 1 with --trace_analysis: one traced chunk."""
    led = os.path.join(tmp, "tune_ledger.jsonl")
    run = run_tuning_main(**ANALYSIS_TUNE, pretrained_model_path=os.path.join(tmp, "none"),
                          output_dir=os.path.join(tmp, "tune", "rabbit-jump"), ledger=led,
                          trace_analysis=True)
    expect_tune_launches(run, ANALYSIS_TUNE["max_train_steps"], 1,
                         ANALYSIS_TUNE["validation_data"])
    traces = _ledger_events(led, "trace_analysis")
    skipped = _ledger_events(led, "trace_analysis_skipped")
    pa = [e for e in _ledger_events(led, "program_analysis") if e["program"] == "train_steps"]
    rec = None
    if [e["name"] for e in traces] != ["train_steps_chunk"] or skipped:
        failures.append(f"24c: traces {[e['name'] for e in traces]}, skipped {skipped}")
    else:
        rec = _check_trace("24c", traces[0], None, failures)
        step_gn = GN_LAUNCHES_PER_CALL * (GN_SITES + GN_REMAT_SITES
                                          * TUNE["gradient_checkpointing"])
        if traces[0]["launches"]["group_norm"] != step_gn:
            failures.append(f"24c: {traces[0]['launches']} in the traced chunk, not one "
                            f"step's {step_gn} GroupNorm launches")
    if len(pa) != 1:
        failures.append(f"24c: {len(pa)} analyses of train_steps")
    else:
        print(f"  24c train_steps (1 step): {_analysis_line(pa[0])}", flush=True)
    return {"run": run, "trace": rec, "analysis": pa[0] if pa else None}


def analysis_ui_phase(args, frames, tmp: str, failures: list) -> dict:
    """Phase 24d: the demo layer's inference on a written checkpoint."""
    from PIL import Image

    from videop2p_tpu_torch.cli.common import build_models
    from videop2p_tpu_torch.obs.ledger import RunLedger
    from videop2p_tpu_torch.pipelines.sampling import edit_sample
    from videop2p_tpu_torch.ui import InferencePipeline

    ckpt = os.path.join(tmp, "experiment")
    bundle = build_models(device="cuda", seed=0)
    nbytes = write_checkpoint(ckpt, bundle)
    del bundle
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = InferencePipeline(ckpt)
    load_s = time.perf_counter() - t0
    led = RunLedger(os.path.join(tmp, "ui_ledger.jsonl"), device="cuda").activate()
    gifs, walls, launches = [], [], []
    try:
        for i in range(2):
            reset_launch_counts()
            t0 = time.perf_counter()
            gifs.append(pipe.run(RABBIT["prompts"][1], num_steps=UI_STEPS, video_length=8,
                                 out_path=os.path.join(tmp, f"sample_{i}.gif"), seed=3))
            walls.append(time.perf_counter() - t0)
            launches.append(launch_counts())
        ps = pipe.programs
        gen = torch.Generator("cuda").manual_seed(4)
        x_t = torch.randn((1, 8, 64, 64, 4), generator=gen, device="cuda")
        cond, uncond = ps.encode_prompts([RABBIT["prompt"]]), ps.encode_prompts([""])[0]
        sampled = ps.sample(x_t, cond, uncond, steps=UI_STEPS)
        with torch.no_grad():
            latents = edit_sample(ps.unet_fn, ps.scheduler, x_t, cond, uncond,
                                  num_inference_steps=UI_STEPS,
                                  guidance_scale=ps.spec.guidance_scale)
        decoded = ps.decode(latents)
        same = torch.equal(sampled, decoded)
    finally:
        led.close()
    if not same:
        failures.append("24d: sample_decode != edit_sample + decode: max|d| "
                        f"{(sampled - decoded).abs().max().item()}")
    frames_n = []
    for path in gifs:
        with Image.open(path) as im:
            frames_n.append((im.n_frames, im.size))
    if frames_n != [(8, (512, 512))] * 2:
        failures.append(f"24d: GIFs {frames_n}")
    if launches[0] != launches[1] or not launches[0]["frame_attention"] or not launches[0][
            "group_norm"]:
        failures.append(f"24d: launches {launches}")
    compiles = [e["program"] for e in _ledger_events(led.path, "compile")]
    if compiles.count("sample_decode") != 1:
        failures.append(f"24d: compile events {compiles}")
    pa = {e["program"]: e for e in _ledger_events(led.path, "program_analysis")}
    if "sample_decode" not in pa:
        failures.append(f"24d: analyses {sorted(pa)}")
    print(f"  24d checkpoint {nbytes / 1e9:.3f} GB, loaded bf16 in {load_s:.2f} s; run "
          f"{walls[0]:.3f} s (first call), {walls[1]:.3f} s (warm); launches {launches[0]}; "
          f"GIFs {frames_n[0]}; sample_decode = edit_sample + decode: {same}", flush=True)
    if "sample_decode" in pa:
        print(f"  24d sample_decode ({UI_STEPS} steps): {_analysis_line(pa['sample_decode'])}",
              flush=True)
    del pipe, ps, sampled, decoded, latents
    torch.cuda.empty_cache()
    return {"walls": walls, "launches": launches[0], "load_s": load_s, "bytes": nbytes,
            "analysis": pa.get("sample_decode")}


def analysis_path(args, frames) -> tuple:
    """Phase 24 (path "analysis"): program analysis, device traces and the
    demo layer. Returns (runs, records); raises on a failed gate."""
    print(f"program analysis, device traces and the UI (phase 24; {_allocated_line()}):",
          flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_", dir="outputs")
    failures: list = []
    t0 = time.perf_counter()
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.mixed_precision]
    try:
        reports = kernel_report_checks(dtype)
        for name, (flops, trans, want_flops, want_trans) in reports.items():
            print(f"  24a {name} reported: flops {flops} (formula {want_flops}), "
                  f"transcendentals {trans} (formula {want_trans})", flush=True)
            if (flops, trans) != (want_flops, want_trans):
                failures.append(f"24a: {name} reported ({flops}, {trans}), formulas "
                                f"({want_flops}, {want_trans})")
        fast = analysis_fast_phase(args, frames, tmp, failures)
        official = analysis_official_phase(args, frames, tmp, failures)
        tune = analysis_tune_phase(tmp, failures)
        ui = analysis_ui_phase(args, frames, tmp, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"  phase 24: {wall:.1f} s", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))

    def slim(run):
        return {k: v for k, v in run.items() if k not in ("latents", "videos", "x_t")}

    record = {"wall_s": wall, "kernel_reports": reports,
              "fast": {k: v for k, v in fast.items() if k != "runs"},
              "official": {"analysis": official["analysis"]},
              "tune": {k: v for k, v in tune.items() if k != "run"}, "ui": ui}
    return ({"analysis": slim(fast["runs"][0]),
             "analysis_flash_rect": slim(official["run"])}, {"analysis": record})


# ------------------------------------------------------------------ mesh --
# (phase 25, path "mesh"): the multi-GPU layer at world size 1, the card's
# one GPU: an NCCL group of one rank in this process (a file:// store, no
# port), the sharded wrappers forced onto the SD-1.5 UNet, the run CLI's
# mesh in process and under torchrun
MESH_SPEC = "1,1,1"
MESH_CLI_TIMEOUT_S = 300


def mesh_wrapper_checks(mesh, dtype) -> list:
    """The frame-attention and GroupNorm kernels under the mesh's wrappers
    against their plain versions at the shapes a rank's cached-edit batch
    gives them (2 streams × 8 frames; sp = 1 keeps the whole clip): frame
    attention at 64² and 32², GroupNorm on a frame-pooled resnet slab and a
    per-frame transformer slab. These launches are the comparison's, not
    the main path's."""
    from videop2p_tpu_torch.ops.attention import dense_frame_attention
    from videop2p_tpu_torch.ops.groupnorm import group_norm_reference
    from videop2p_tpu_torch.parallel import make_sharded_frame_attention_fn, make_sharded_group_norm_fn

    gen = torch.Generator(device="cuda").manual_seed(25)
    fa, gn = make_sharded_frame_attention_fn(mesh), make_sharded_group_norm_fn(mesh)
    out = []
    for b, f, h, n, d in ((2, 8, 8, 4096, 40), (2, 8, 8, 1024, 80)):
        q = torch.randn(b, f, h, n, d, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        with torch.no_grad():
            got = fa(q, k, v).float()
            ref = dense_frame_attention(q.float(), k.float(), v.float())
        err, tol = (got - ref).abs().max().item(), limit(dtype, ref, ATTN_TOL_F32)
        out.append({"wrapper": "sharded_frame_attention", "shape": [b, f, h, n, d],
                    "max_abs_err": err, "tol": tol})
    for (n, rows, c), pooled in (((2, 8 * 4096, 320), True), ((16, 4096, 320), False)):
        x = (torch.randn(n, rows, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        w, b_ = (torch.randn(c, generator=gen, device="cuda").to(dtype) for _ in range(2))
        with torch.no_grad():
            got = gn(x, w, b_, num_groups=32, eps=1e-5, act="silu", pooled=pooled).float()
            ref = group_norm_reference(x.float(), w.float(), b_.float(), num_groups=32,
                                       eps=1e-5, act="silu")
        err, tol = (got - ref).abs().max().item(), limit(dtype, ref, GN_TOL_F32)
        out.append({"wrapper": "sharded_group_norm", "pooled": pooled, "shape": [n, rows, c],
                    "max_abs_err": err, "tol": tol})
    for rec in out:
        print(f"  25a {rec['wrapper']} {rec['shape']}: max|d| {rec['max_abs_err']:.3e} "
              f"(limit {rec['tol']:.3e})", flush=True)
    return out


def mesh_staged_gn_checks(dtype) -> list:
    """The GroupNorm kernel's two staged launches (statistics, then the
    apply of reduced statistics), which the mesh runs on a frame-pooled
    slab when frames are split over GPUs (``parallel/mesh.py:
    pooled_group_norm``), at a rank's resnet slab of the cached edit
    (2 streams x 8 frames of 64², C 320 and 640):

      * ``pooled_group_norm`` over a group of one: both launches, no
        collective; equal to ``fused_group_norm`` bit for bit and within
        the GroupNorm tolerance of ``group_norm_reference``; its time
        against the fused launch's;
      * two shards on one card: the statistics of each half of the frames
        summed as the all-reduce sums them, each half applied with
        ``shards=2``, against ``group_norm_reference`` on the whole slab;
      * its time in turns with the library call that computes the same
        function at one shard (``F.group_norm`` + ``F.silu`` on the
        channels-first layout) and with the plain version, and the byte
        bound (x read once, y written once).

    These launches are the comparison's, not the main path's."""
    from videop2p_tpu_torch.ops.groupnorm import (
        fused_group_norm,
        group_norm_apply,
        group_norm_reference,
        group_norm_stats,
        launch_count,
    )
    import torch.nn.functional as F

    from videop2p_tpu_torch.parallel.mesh import pooled_group_norm

    gen = torch.Generator(device="cuda").manual_seed(251)
    out = []
    for n, rows, c in ((2, 8 * 4096, 320), (2, 8 * 1024, 640)):
        x = (torch.randn(n, rows, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        w, b_ = (torch.randn(c, generator=gen, device="cuda").to(dtype) for _ in range(2))
        kw = dict(num_groups=32, eps=1e-5, act="silu")
        with torch.no_grad():
            before = launch_count()
            staged = pooled_group_norm(x, w, b_, group=None, **kw)
            torch.cuda.synchronize()
            launches = launch_count() - before
            fused = fused_group_norm(x, w, b_, **kw)
            ref = group_norm_reference(x.float(), w.float(), b_.float(), **kw)
            # each rank holds its frames as a slab of its own
            halves = [h.contiguous() for h in x.chunk(2, dim=1)]
            sums = group_norm_stats(halves[0], num_groups=32) + group_norm_stats(
                halves[1], num_groups=32)
            split = torch.cat([group_norm_apply(h, sums, w, b_, shards=2, **kw)
                               for h in halves], dim=1)
            torch.cuda.synchronize()
            x_nc = x.transpose(1, 2).contiguous()  # the library's channels-first layout
            staged_ms, library_ms, plain_ms = time_in_turns(
                lambda: pooled_group_norm(x, w, b_, group=None, **kw),
                lambda: F.silu(F.group_norm(x_nc, 32, w, b_, 1e-5)),
                lambda: group_norm_reference(x, w, b_, **kw))
            fused_ms = time_ms(lambda: fused_group_norm(x, w, b_, **kw))
        tol = limit(dtype, ref, GN_TOL_F32)
        x_bytes = x.numel() * x.element_size()
        bound, bound_by = bound_ms(2 * x_bytes, 8.0 * x.numel(), dtype)
        rec = {"wrapper": "pooled_group_norm", "shape": [n, rows, c],
               "dtype": str(dtype).replace("torch.", ""), "launches": launches,
               "bit_exact_vs_fused": bool(torch.equal(staged, fused)),
               "max_abs_err": (staged.float() - ref).abs().max().item(),
               "two_shards_max_abs_err": (split.float() - ref).abs().max().item(),
               "tol": tol, "ms": staged_ms, "fused_ms": fused_ms, "library_ms": library_ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
        out.append(rec)
        print(f"  25a pooled_group_norm {rec['shape']} {rec['dtype']}: {launches} launches, "
              f"= fused bit for bit: {rec['bit_exact_vs_fused']}; max|d| "
              f"{rec['max_abs_err']:.3e}, two shards {rec['two_shards_max_abs_err']:.3e} "
              f"(limit {tol:.3e}); {staged_ms:.4f} ms (fused {fused_ms:.4f} ms, "
              f"F.group_norm+silu {library_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms, {bound_by})", flush=True)
        del x, x_nc, staged, fused, ref, split, halves
    return out


def mesh_cli_child(tmp: str, args, name: str, extra: list) -> tuple:
    """``torchrun --standalone --nproc_per_node 1 -m
    videop2p_tpu_torch.cli.run_videop2p`` on the clip of ``RABBIT`` at
    SD-1.5 width (its config written as JSON, which YAML reads); returns
    (wall seconds, the run's results directory, its ledger)."""
    ckpt = os.path.join(os.path.abspath(tmp), name, "rabbit-jump")
    cfg = os.path.join(tmp, f"{name}.json")
    with open(cfg, "w") as fh:
        json.dump({**RABBIT, "pretrained_model_path": ckpt, "video_len": 8}, fh)
    led = os.path.join(os.path.abspath(tmp), f"{name}.jsonl")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", "-m", "videop2p_tpu_torch.cli.run_videop2p",
            "--config", cfg, "--fast", "--steps", str(args.steps), "--mixed_precision",
            args.mixed_precision, "--telemetry", "--ledger", led, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=MESH_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"25b torchrun CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out_dir = next(os.path.join(root, d) for root, dirs, _ in os.walk(os.path.join(tmp, name))
                   for d in dirs if d.startswith("results_dp"))
    return wall, out_dir, led


def mesh_path(args) -> tuple:
    """Phase 25 (path "mesh"): (a) an NCCL group of world size 1 in this
    process; the mesh's sharded frame attention and GroupNorm forced onto
    the SD-1.5 UNet (sp = tp = 1) give the plain forward bit for bit with
    the plain forward's launches, and their kernels match the plain
    versions at the wrappers' shapes; (b) ``main(mesh="1,1,1",
    device_telemetry=True)`` in that group equals the plain main path bit
    for bit with the same launches, its ledger holding ``device_telemetry``
    (divergence 0.0) and ``comm_analysis``; the same edit through the CLI
    under ``torchrun`` writes the plain run's GIFs byte for byte and its
    per-step telemetry; (c) NCCL's setup seconds and the runs' wall times.
    Returns (runs, records); raises on a failed gate."""
    import torch.distributed as dist

    from videop2p_tpu_torch.cli.run_videop2p import _write_gifs, build_models
    from videop2p_tpu_torch.data.dataset import load_frame_sequence
    from videop2p_tpu_torch.obs.ledger import read_ledger
    from videop2p_tpu_torch.parallel import (
        make_mesh,
        make_sharded_frame_attention_fn,
        make_sharded_group_norm_fn,
    )

    print(f"the mesh at world size 1 (phase 25; {_allocated_line()}):", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir="outputs")
    failures: list = []
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.mixed_precision]
    t_phase = time.perf_counter()
    try:
        # 25a: the group, its first collective (NCCL builds its communicator
        # there), the mesh
        t0 = time.perf_counter()
        store = "file://" + os.path.abspath(os.path.join(tmp, "nccl_store"))
        try:
            dist.init_process_group("nccl", init_method=store, rank=0, world_size=1,
                                    device_id=torch.device("cuda", 0))
        except TypeError:  # a torch without device_id
            dist.init_process_group("nccl", init_method=store, rank=0, world_size=1)
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        torch.cuda.synchronize()
        mesh = make_mesh((1, 1, 1))
        nccl_s = time.perf_counter() - t0
        print(f"  25a NCCL group of 1 + first all-reduce + mesh {mesh.spec()}: "
              f"{nccl_s:.3f} s", flush=True)
        bundle = build_models(device="cuda", seed=0, dtype=dtype)
        x, text, control = edit_forward_inputs(bundle)
        with torch.no_grad():
            reset_launch_counts()
            plain = bundle.unet(x, 500, text, control, {})
            torch.cuda.synchronize()
            plain_launches = launch_counts()
            bundle.unet.set_seams(frame_attention_fn=make_sharded_frame_attention_fn(mesh),
                                  group_norm_fn=make_sharded_group_norm_fn(mesh))
            reset_launch_counts()
            wired = bundle.unet(x, 500, text, control, {})
            torch.cuda.synchronize()
            wired_launches = launch_counts()
        bundle.unet.set_seams()
        same = torch.equal(plain, wired)
        print(f"  25a forward with the wrappers forced on = plain: {same}; launches "
              f"{wired_launches} (plain {plain_launches})", flush=True)
        if not same:
            failures.append("25a: the wrapped forward is not the plain forward bit for bit")
        if wired_launches != plain_launches or not wired_launches["frame_attention"] \
                or not wired_launches["group_norm"]:
            failures.append(f"25a: launches {wired_launches}, plain {plain_launches}")
        wrappers = mesh_wrapper_checks(mesh, dtype)
        failures += [f"25a {r['wrapper']} {r['shape']}: {r['max_abs_err']} > {r['tol']}"
                     for r in wrappers if not r["max_abs_err"] <= r["tol"]]
        staged = [r for dt in (torch.float32, torch.bfloat16)
                  for r in mesh_staged_gn_checks(dt)]
        for r in staged:
            if not (r["launches"] == 2 and r["bit_exact_vs_fused"]
                    and r["max_abs_err"] <= r["tol"] and r["two_shards_max_abs_err"] <= r["tol"]):
                failures.append(f"25a pooled_group_norm {r['shape']}: {r}")
        del bundle, x, text, control, plain, wired
        _release()

        # 25b: main on the mesh (in this group) against the plain main path,
        # on the clip the CLI loads
        clip = load_frame_sequence(RABBIT["image_path"], size=512, num_frames=8)
        kw = dict(pretrained_model_path=os.path.join(tmp, "inproc", "rabbit-jump"))
        plain_led, mesh_led = (os.path.join(tmp, f"{n}.jsonl") for n in ("plain", "mesh"))
        plain_run = run_main_path(clip, args.steps, args.mixed_precision, keep_videos=True,
                                  telemetry=True, ledger=plain_led, **kw)
        mesh_run = run_main_path(clip, args.steps, args.mixed_precision, mesh=MESH_SPEC,
                                 device_telemetry=True, ledger=mesh_led, **kw)
        same = torch.equal(plain_run["latents"], mesh_run["latents"])
        print(f"  25b main(mesh={MESH_SPEC!r}) latents = plain: {same}; launches "
              f"{mesh_run['launches']} (plain {plain_run['launches']}); wall "
              f"{mesh_run['wall_s']:.3f} s (plain {plain_run['wall_s']:.3f} s)", flush=True)
        if not same:
            failures.append("25b: the mesh run's latents are not the plain run's")
        if mesh_run["launches"] != plain_run["launches"]:
            failures.append(f"25b: launches {mesh_run['launches']}, plain "
                            f"{plain_run['launches']}")
        events = read_ledger(mesh_led)
        dev = [e for e in events if e["event"] == "device_telemetry"]
        comm = [e for e in events if e["event"] == "comm_analysis"]
        if not dev or any(e["divergence_max"] != 0.0 for e in dev):
            failures.append(f"25b: device_telemetry {dev}")
        if not comm:
            failures.append("25b: no comm_analysis event")
        print(f"  25b ledger: device_telemetry "
              f"{[(e['program'], e['devices'], e['divergence_max']) for e in dev]}; "
              f"comm_analysis "
              f"{[(e['program'], e['num_partitions'], e['collective_count']) for e in comm]}",
              flush=True)
        # the GIFs the CLI would write from the plain run's videos
        plain_gifs = _write_gifs(plain_run.pop("videos"), os.path.join(tmp, "plain_gifs"),
                                 RABBIT["save_name"], True)
        in_process = {"plain": {k: v for k, v in plain_run.items() if k != "latents"},
                      "mesh": {k: v for k, v in mesh_run.items() if k != "latents"}}
        del plain_run["latents"], mesh_run["latents"]
        _release()

        # 25b: the CLI under torchrun (a process with a group of its own)
        # against the plain main path
        dist.destroy_process_group()
        cli_wall, cli_dir, cli_led = mesh_cli_child(tmp, args, "cli", [
            "--mesh", MESH_SPEC, "--device_telemetry"])
        for gif in plain_gifs:
            other = os.path.join(cli_dir, os.path.basename(gif))
            with open(gif, "rb") as a, open(other, "rb") as b:
                if a.read() != b.read():
                    failures.append(f"25b: the torchrun CLI's {os.path.basename(gif)} "
                                    "differs from the plain run's")
        tel = {name: [e["steps"] for e in read_ledger(path) if e["event"] == "telemetry"]
               for name, path in (("plain", plain_led), ("cli", cli_led))}
        if tel["plain"] != tel["cli"] or not tel["plain"]:
            failures.append("25b: the torchrun CLI's per-step telemetry is not the plain run's")
        cli_events = read_ledger(cli_led)
        cli_dev = [e for e in cli_events if e["event"] == "device_telemetry"]
        if not cli_dev or any(e["divergence_max"] != 0.0 for e in cli_dev):
            failures.append(f"25b: the CLI's device_telemetry {cli_dev}")
        if not [e for e in cli_events if e["event"] == "comm_analysis"]:
            failures.append("25b: no comm_analysis in the CLI's ledger")
        cli_ok = not [f for f in failures if f.startswith("25b: the torchrun")]
        print(f"  25c wall: the plain main path {in_process['plain']['wall_s']:.3f} s in "
              f"process, the torchrun CLI {cli_wall:.3f} s (a process: interpreter, "
              f"imports, NCCL, models, edit, GIFs); its GIFs byte for byte and its "
              f"telemetry = the plain run's: {cli_ok}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"  card: {card_line()}", flush=True)
    print(f"  phase 25: {wall:.1f} s", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    record = {"wall_s": wall, "nccl_setup_s": nccl_s, "forward_bit_exact": True,
              "forward_launches": wired_launches, "wrapper_checks": wrappers,
              "staged_group_norm": staged,
              "in_process": in_process, "cli_wall_s": cli_wall}
    mesh_rec = dict(in_process["mesh"])
    return {"mesh": mesh_rec}, {"mesh": record}


# phase 26 (path "serve_mesh"): the mesh every served child joins at world
# size 1, and how long a child may take from launch to its last answer
SERVE_MESH_SPEC = "1,1,1"
SERVE_MESH_CHILD_TIMEOUT_S = 600


def serve_mesh_vmap_phase(args, failures: list) -> dict:
    """Phase 26a: the data mesh's ``vmap`` dispatch at dp = 1 (one card):
    two compatible requests (the rabbit-jump edit of the rabbit clip and of
    the car clip) through ``ProgramSet.edit_decode_batch(dispatch="vmap")``
    give their singletons' bits, with twice a singleton edit's launches and
    no program built after warm; a ``ProgramSet`` of mesh 2,1,1 on this
    one card raises, naming the count. Returns the run (its launches are
    the vmap dispatch's)."""
    import dataclasses

    from videop2p_tpu_torch.data.dataset import load_frame_sequence
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.serve.batching import stack_items

    spec = ProgramSpec(width=512, video_len=8, steps=args.steps,
                       mixed_precision=args.mixed_precision, seed=0)
    ps = ProgramSet(spec, device="cuda")
    ctrl = {"blend_word": RABBIT["blend_word"], "eq_params": RABBIT["eq_params"]}
    ps.warm(tuple(RABBIT["prompts"]), controller_kwargs=ctrl)
    members = []
    for path in (RABBIT["image_path"], CAR["image_path"]):
        frames = load_frame_sequence(path, size=512, num_frames=8)
        ctx = ps.controller(RABBIT["prompts"], **ctrl)
        latents = ps.encode(ps.frames_to_video(frames))
        _, cached = ps.invert_capture(latents, ps.encode_prompts(RABBIT["prompts"][:1]), ctx)
        members.append((cached, ps.encode_prompts(RABBIT["prompts"]), ps.encode_uncond(), ctx,
                        latents))
    misses = ps.cache_misses
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    videos, errs = ps.edit_decode_batch(stack_items(members), dispatch="vmap")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    same = []
    for i, member in enumerate(members):
        single, err = ps.edit_decode(*member)
        same.append(bool(torch.equal(videos[i], single)) and float(errs[i]) == float(err) == 0.0)
    want = {k: 2 * v for k, v in _hit_launches(args.steps).items()}
    print(f"  26a vmap at dp = 1: 2 members in {wall:.3f} s, launches {launches} (want "
          f"{want}); each its singleton's bits and src_err 0.0: {same}; programs built after "
          f"warm {ps.cache_misses - misses}", flush=True)
    if not all(same):
        failures.append(f"26a: the vmap members against their singletons: {same}")
    if launches != want:
        failures.append(f"26a: launches {launches}, expected {want}")
    if ps.cache_misses != misses:
        failures.append("26a: the vmap dispatch built a program")
    del members, videos, errs, ps
    _release()
    cards = torch.cuda.device_count()
    try:
        ProgramSet(dataclasses.replace(spec, mesh="2,1,1"), device="cuda")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    print(f"  26a ProgramSet(mesh='2,1,1') on {cards} card(s): {refusal}", flush=True)
    if cards == 1 and (refusal is None or "needs 2 devices, this process sees 1" not in refusal):
        failures.append(f"26a: a data mesh of 2 on one card: {refusal}")
    return {"launches": launches, "wall_s": wall, "bit_exact": same, "refusal": refusal}


def _torchrun(module: str) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "1", "-m", module]


def serve_mesh_path(args) -> tuple:
    """Phase 26 (path "serve_mesh"): serving over several devices, on one
    card. The three children of (b)-(d) start first, so that their start-up
    overlaps (a) and each other:

      (a) ``serve_mesh_vmap_phase``;
      (b) ``torchrun --nproc_per_node 1 -m videop2p_tpu_torch.cli.serve
          --mesh 1,1,1``: the rank-synchronous path forced on (rank 0 drives
          a world of one through the control channel) answers a fresh
          request and a hit with phase 19b's plain child's GIF bytes and
          src_err; SIGTERM to rank 0 → torchrun exits 0;
      (c) ``torchrun ... cli.stream --mesh 1,1,1`` over the clip's first 8
          frames: one window, whose final.npy is phase 21's direct request
          for those frames bit for bit;
      (d) ``torchrun ... cli.run_videop2p --fast --attn_maps --mesh 1,1,1``
          writes the plain run's attention records (every sidecar array bit
          for bit).

    Returns (runs, records); raises on a failed gate."""
    import signal

    from videop2p_tpu_torch.obs.attention import load_obs_sidecar
    from videop2p_tpu_torch.obs.ledger import read_ledger
    from videop2p_tpu_torch.serve import EngineClient, listening_pid
    from videop2p_tpu_torch.stream import synthetic_clip

    print(f"serving over several devices (phase 26; {_allocated_line()}):", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_", dir="outputs")
    failures: list = []
    record: dict = {}
    children: dict = {}
    t_phase = t = time.perf_counter()
    try:
        if not PLAIN_SERVE_CLI.get("gifs"):
            # phase 19 did not run: the plain child's answers first
            _, f = serve_cli_phase(args, tmp, "fp32")
            failures += f
        port = _free_port()
        children["serve"] = _Child("torchrun cli.serve", [
            *_torchrun("videop2p_tpu_torch.cli.serve"), "--mesh", SERVE_MESH_SPEC,
            "--port", str(port), "--out_dir", os.path.join(tmp, "serve"),
            "--steps", str(args.steps), "--store_budget_gb", str(SERVE_STORE_BUDGET_GB),
            "--warm_prompts", *RABBIT["prompts"]],
            os.path.join(tmp, "serve.log"), f"http://127.0.0.1:{port}")
        job = os.path.join(tmp, "job")
        children["stream"] = _Child("torchrun cli.stream", [
            *_torchrun("videop2p_tpu_torch.cli.stream"), "--mesh", SERVE_MESH_SPEC,
            "--synthetic", "8", "--width", "512", "--video_len", "8", "--overlap",
            str(STREAM_OVERLAP), "--steps", str(args.steps), "--job_dir", job,
            *(() if args.mixed_precision == "fp32" else
              ("--mixed_precision", args.mixed_precision))],
            os.path.join(tmp, "stream.log"), "http://127.0.0.1:1")
        ckpt = os.path.join(os.path.abspath(tmp), "attn", "rabbit-jump")
        cfg = os.path.join(tmp, "attn.json")
        with open(cfg, "w") as fh:
            json.dump({**RABBIT, "pretrained_model_path": ckpt, "video_len": 8}, fh)
        attn_led = os.path.join(os.path.abspath(tmp), "attn.jsonl")
        children["attn"] = _Child("torchrun cli.run_videop2p", [
            *_torchrun("videop2p_tpu_torch.cli.run_videop2p"), "--config", cfg, "--fast",
            "--steps", str(args.steps), "--mixed_precision", args.mixed_precision,
            "--attn_maps", "--ledger", attn_led, "--mesh", SERVE_MESH_SPEC],
            os.path.join(tmp, "attn.log"), "http://127.0.0.1:1")

        # (a) in this process while the children start
        run = serve_mesh_vmap_phase(args, failures)
        t = _sub_seconds(record, "26a vmap", t)

        # (d)'s plain reference: the same edit in process, its records
        from videop2p_tpu_torch.data.dataset import load_frame_sequence

        clip = load_frame_sequence(RABBIT["image_path"], size=512, num_frames=8)
        plain = run_main_path(clip, args.steps, args.mixed_precision, attn_maps=True,
                              ledger=os.path.join(tmp, "plain.jsonl"),
                              pretrained_model_path=os.path.join(tmp, "plain", "rabbit-jump"))
        plain_arrays = load_obs_sidecar(plain["sidecar"])
        del plain["latents"]
        _release()
        t = _sub_seconds(record, "26d plain reference", t)

        # (b) the served mesh of one
        child = children["serve"]
        child.wait_up(SERVE_MESH_CHILD_TIMEOUT_S)
        client = EngineClient(child.client.base_url, timeout_s=60.0)
        answers = {"fresh": client.wait(client.submit(_serve_request()), timeout_s=600.0),
                   "hit": client.wait(client.submit(_hit_request()), timeout_s=600.0)}
        gifs = {n: _gif_bytes(r) for n, r in answers.items() if r["status"] == "done"}
        os.kill(listening_pid(child.log_path), signal.SIGTERM)
        try:
            rc = child.proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            rc = None
        log = child.tail()
        child.kill()
        plain_recs = PLAIN_SERVE_CLI.get("records", {})
        for name, rec in answers.items():
            ref = plain_recs.get(name, {})
            same_gifs = gifs.get(name) is not None and gifs[name] == PLAIN_SERVE_CLI[
                "gifs"].get(name)
            print(f"  26b {name}: {rec['status']}, store {rec.get('store_source')}, src_err "
                  f"{rec.get('src_err')!r} (plain {ref.get('src_err')!r}), dispatch "
                  f"{rec.get('dispatch_s')} s, total {rec.get('total_s')} s; GIFs = the plain "
                  f"child's byte for byte: {same_gifs}", flush=True)
            if rec["status"] != "done" or rec.get("src_err") != ref.get("src_err") or \
                    rec.get("store_source") != ref.get("store_source") or not same_gifs:
                failures.append(f"26b {name}: {rec['status']} ({rec.get('error')}), src_err "
                                f"{rec.get('src_err')!r}, store {rec.get('store_source')}, "
                                f"GIFs equal {same_gifs}")
        drove = "drives the mesh 1,1,1 through the control channel" in log
        print(f"  26b torchrun cli.serve: up in {child.up_s:.1f} s, rank 0 drove the channel: "
              f"{drove}; SIGTERM to rank 0 → torchrun exit {rc}", flush=True)
        if rc != 0 or not drove:
            failures.append(f"26b: exit {rc}, channel {drove}:\n{log}")
        record["serve"] = {"up_s": child.up_s, "rc": rc, "records": {
            n: {k: r.get(k) for k in ("status", "store_source", "resolve_s", "dispatch_s",
                                      "total_s", "src_err")} for n, r in answers.items()}}
        t = _sub_seconds(record, "26b torchrun cli.serve", t)

        # (c) the one-window stream job
        child = children["stream"]
        try:
            rc = child.proc.wait(timeout=SERVE_MESH_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        log = child.tail()
        child.kill()
        ref = STREAM_WINDOW0.get("video")
        final_path = os.path.join(job, "final.npy")
        final = np.load(final_path) if os.path.isfile(final_path) else None
        if ref is None:
            ref = _stream_window0_reference(args, synthetic_clip(8, 512, seed=0), tmp)
        same = final is not None and np.array_equal(final, ref)
        print(f"  26c torchrun cli.stream: exit {rc}, final.npy "
              f"{None if final is None else final.shape} = phase 21's window 0: {same}",
              flush=True)
        if rc != 0 or not same:
            failures.append(f"26c: exit {rc}, final.npy equal {same}:\n{log}")
        t = _sub_seconds(record, "26c torchrun cli.stream", t)

        # (d) the attention records of the mesh of one
        child = children["attn"]
        try:
            rc = child.proc.wait(timeout=SERVE_MESH_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        log = child.tail()
        child.kill()
        events = ([e for e in read_ledger(attn_led) if e["event"] == "attn_maps"]
                  if os.path.isfile(attn_led) else [])
        arrays = load_obs_sidecar(events[0]["sidecar"]) if events else {}
        keys = sorted(k for k in plain_arrays if k.startswith("attn_"))
        same = bool(keys) and sorted(k for k in arrays if k.startswith("attn_")) == keys and \
            all(np.array_equal(arrays[k], plain_arrays[k]) for k in keys)
        print(f"  26d torchrun cli.run_videop2p --attn_maps: exit {rc}, {len(keys)} record "
              f"arrays (scopes {sorted(e['scope'] for e in events)}) = the plain run's bit "
              f"for bit: {same}", flush=True)
        if rc != 0 or not same:
            failures.append(f"26d: exit {rc}, records equal {same}:\n{log}")
        t = _sub_seconds(record, "26d torchrun cli.run_videop2p", t)
    finally:
        for child in children.values():
            child.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    _release()
    record["path_s"] = time.perf_counter() - t_phase
    print(f"  card: {card_line()}", flush=True)
    print(f"  phase 26: {record['path_s']:.1f} s", flush=True)
    if failures:
        raise AssertionError("serve_mesh path: " + "; ".join(failures))
    record["vmap"] = {k: v for k, v in run.items() if k != "launches"}
    return {"serve_mesh": run}, {"serve_mesh": record}


# the operator tools (path "tools", phase 27): the ledgers and the bundle
# the runs and observe paths wrote in this invocation (their directories
# are kept until the phase has read them), the section headings each HTML
# page must hold, the critical-path segments a joined trace splits into,
# and the importers a tool process must not reach (the card has no JAX)
TOOLS_HANDOFF: dict = {}
TOOL_PAGES = {
    "edit_report": ("Per-word cross-attention heatmaps", "Edit quality"),
    "cost_report": ("Capacity", "Per-tenant chargeback"),
    "fleet_dash": ("Burn gauges", "Scale advice", "Correctness probes"),
    "probe_report": ("Scoreboard", "Answer-audit divergences"),
    "incident_report": ("Trigger", "Timeline", "Targets"),
}
TRACE_SEGMENTS = {"queue", "resolve", "dispatch", "decode"}
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "videop2p_tpu")
# obs_diff between two runs of the same work (the two fast edits, the two
# drives) gates at this multiple of its thresholds: their latencies differ
# by noise alone (a tiny drive's windows are host-bound, tens of percent
# apart run to run), while the count and exactness rules (failed windows,
# passthroughs, breaker trips, incidents, src_err) have threshold 0 at any
# scale. The same pairs at 1× are printed beside, and the slowed copy
# (execute seconds doubled) gates at 1×
TOOLS_NOISE_SCALE = 4.0
# the device stream_drive runs on (a CPU rehearsal of the phase sets "cpu")
TOOLS_DEVICE = "cuda"


def _tool_cmd(name: str, *argv) -> list:
    """``python -m videop2p_tpu_torch.tools.<name>`` with ``-X importtime``,
    whose report (on stderr) lists every module the process imported."""
    return [sys.executable, "-X", "importtime", "-m", f"videop2p_tpu_torch.tools.{name}",
            *map(str, argv)]


def _forbidden_imports(stderr: str) -> list:
    """The modules of JAX or of the JAX package in an ``-X importtime``
    report."""
    found = []
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            module = line.rsplit("|", 1)[1].strip()
            if module.split(".")[0] in FORBIDDEN_IMPORTS:
                found.append(module)
    return found


def _run_tools(jobs: dict) -> dict:
    """Each job's command in a process of its own, all at once: {name:
    (exit code, stdout, stderr, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(cmd):
        t = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        return res.returncode, res.stdout, res.stderr, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(one, cmd) for name, cmd in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def tools_inputs(args, frames, tmp: str, record: dict) -> dict:
    """The tools' inputs: the runs path's fast ledger and the observe path's
    fleet where they ran in this invocation, else written here — two
    cached fast edits with the observability flags on one ledger, and a
    ``--router 2`` loadgen fleet with every plane, tracing and replica 1
    wrong (its answer audit writes a ``probe_failed`` bundle)."""
    from videop2p_tpu_torch.obs import read_ledger

    out = {}
    if "runs" in TOOLS_HANDOFF:
        out["runs"] = TOOLS_HANDOFF["runs"]["ledger"]
        record["runs_from"] = "the runs path (phase 23a)"
    else:
        t = time.perf_counter()
        out["runs"] = os.path.join(tmp, "runs.jsonl")
        ckpt = os.path.join(tmp, "rabbit-jump")
        for _ in range(2):
            run = run_main_path(frames, args.steps, args.mixed_precision, ledger=out["runs"],
                                pretrained_model_path=ckpt, **RUN_OBS_FLAGS)
            expect_launches(run, args.steps, "auto")
        record["runs_from"] = f"two fast edits here ({time.perf_counter() - t:.1f} s)"
    if "observe" in TOOLS_HANDOFF:
        h = TOOLS_HANDOFF["observe"]
        out.update(fleet=h["fleet"], out_dir=h["out_dir"])
        record["fleet_from"] = "the observe path (phase 22a)"
    else:
        from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

        t = time.perf_counter()
        out.update(fleet=os.path.join(tmp, "fleet.jsonl"), out_dir=os.path.join(tmp, "fleet"))
        programs = ProgramSet(ProgramSpec(width=512, video_len=8, steps=args.steps),
                              device="cuda")
        rc, rec, _ = _loadgen(
            ["--router", "2", "--requests", str(OBSERVE_REQUESTS), "--concurrency",
             str(OBSERVE_CONCURRENCY), "--collector", "--probes", "--slo", "--incidents",
             os.path.join(tmp, "incidents"), "--replica_faults", OBSERVE_WRONG,
             "--window_scale", str(OBSERVE_WINDOW_SCALE), "--tracing", "--probe_interval_s",
             "3600", "--ledger", out["fleet"], "--out_dir", out["out_dir"], "--steps",
             str(args.steps), "--device", "cuda"], programs=programs)
        del programs
        _release()
        if rc != 0 or rec["errors"]:
            raise AssertionError(f"tools: the loadgen fleet: rc {rc}, errors {rec['errors']}")
        record["fleet_from"] = f"a loadgen fleet here ({time.perf_counter() - t:.1f} s)"
    bundles = [e["bundle"] for e in read_ledger(out["fleet"])
               if e["event"] == "incident" and e.get("bundle")]
    if not bundles:
        raise AssertionError("tools: the fleet ledger names no incident bundle")
    out["bundle"] = bundles[0]
    out["span_ledgers"] = [out["fleet"]] + sorted(
        os.path.join(root, f) for root, _, files in os.walk(out["out_dir"])
        for f in files if f.endswith(".jsonl"))
    print(f"  inputs: the run ledger from {record['runs_from']}, the fleet from "
          f"{record['fleet_from']}; {len(out['span_ledgers'])} span ledgers", flush=True)
    return out


def _split_runs(ledger: str, tmp: str) -> tuple:
    """The ledger's last two runs as a file each, and a copy of the last
    with ``cached_invert_edit``'s execute seconds doubled."""
    from videop2p_tpu_torch.obs import history
    from videop2p_tpu_torch.obs.ledger import read_ledger

    runs = history.split_runs(read_ledger(ledger))
    if len(runs) < 2:
        raise AssertionError(f"tools: the run ledger holds {len(runs)} runs, not 2")
    paths = []
    for name, events in (("run_a", runs[-2]), ("run_b", runs[-1]), ("run_b_slow", runs[-1])):
        path = os.path.join(tmp, f"{name}.jsonl")
        with open(path, "w") as fh:
            for e in events:
                if name == "run_b_slow" and e.get("event") == "execute_timing" and \
                        e.get("program") == "cached_invert_edit":
                    e = {k: (v * 2 if k.endswith("_s") and isinstance(v, (int, float))
                             and not isinstance(v, bool) else v) for k, v in e.items()}
                fh.write(json.dumps(e) + "\n")
        paths.append(path)
    return tuple(paths)


def _diff_regressions(stdout: str, failures: list, name: str) -> list:
    """The rules an ``obs_diff --json`` run names as regressed, printed."""
    try:
        rules = [r["rule"] + f" ({r['program']})"
                 for r in json.loads(stdout.strip().splitlines()[-1])["regressions"]]
    except (IndexError, ValueError, KeyError) as e:
        failures.append(f"tools: {name}'s --json output: {e}")
        return []
    print(f"    {name} regressions: {rules}", flush=True)
    return rules


def _drive_record(stdout: str, failures: list, name: str) -> dict:
    """A drive's summary record (its last stdout line), held to every
    window done and ``src_err_max == 0.0``."""
    try:
        rec = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        failures.append(f"{name}: no summary record")
        return {}
    health = rec["stream_health"]
    statuses = [w["status"] for w in rec["windows"]]
    print(f"  {name}: {health['windows_done']}/{health['windows_total']} windows done, "
          f"src_err_max {health['src_err_max']!r}, seam min/mean PSNR "
          f"{health['seam_min_psnr']}/{health['seam_mean_psnr']} dB, window seconds "
          f"{[w.get('window_s') for w in rec['windows']]}", flush=True)
    if set(statuses) != {"done"} or health["windows_done"] != health["windows_total"] or \
            health["src_err_max"] != 0.0 or not rec.get("final"):
        failures.append(f"{name}: statuses {statuses}, health {health}")
    return rec


def tools_path(args, frames) -> tuple:
    """Phase 27 (path "tools"): the operator tools, each a ``python -m
    videop2p_tpu_torch.tools.<name>`` process, on ledgers written on the
    card at SD-1.5 width, and two streaming drives on the card. Returns
    (runs, records); raises on a failed gate."""
    import contextlib
    import io

    from videop2p_tpu_torch.tools import stream_drive

    print(f"operator tools (phase 27; {_allocated_line()}):", flush=True)
    os.makedirs("outputs", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir="outputs")
    t0 = time.perf_counter()
    failures, record = [], {"tool_s": {}}
    reset_launch_counts()
    try:
        inputs = tools_inputs(args, frames, tmp, record)
        run_a, run_b, run_b_slow = _split_runs(inputs["runs"], tmp)
        pages = {name: os.path.join(tmp, f"{name}.html") for name in TOOL_PAGES}
        jobs = {
            "ledger_summary": _tool_cmd("ledger_summary", inputs["runs"]),
            "obs_diff runs": _tool_cmd("obs_diff", "--json", "--threshold-scale",
                                       TOOLS_NOISE_SCALE, run_a, run_b),
            "obs_diff runs 1x": _tool_cmd("obs_diff", "--json", run_a, run_b),
            "obs_diff slowed": _tool_cmd("obs_diff", "--json", run_b, run_b_slow),
            "obs_diff fleet": _tool_cmd("obs_diff", "--json", inputs["fleet"], inputs["fleet"]),
            "edit_report": _tool_cmd("edit_report", inputs["runs"], "-o", pages["edit_report"]),
            "cost_report": _tool_cmd("cost_report", inputs["fleet"], "--out",
                                     pages["cost_report"]),
            "fleet_dash": _tool_cmd("fleet_dash", inputs["fleet"], "--out", pages["fleet_dash"]),
            "probe_report": _tool_cmd("probe_report", inputs["fleet"], "--out",
                                      pages["probe_report"]),
            "incident_report": _tool_cmd("incident_report", inputs["bundle"], "--out",
                                         pages["incident_report"]),
            "trace_view": _tool_cmd("trace_view", "--json", *inputs["span_ledgers"]),
        }
        t = time.perf_counter()
        results = _run_tools(jobs)
        record["tools_wall_s"] = time.perf_counter() - t
        # two drives on the card, each a process of its own and alone on
        # the host: their latencies are host-bound, and obs_diff compares them
        for i in (1, 2):
            results.update(_run_tools({f"stream_drive {i}": _tool_cmd(
                "stream_drive", "--device", TOOLS_DEVICE, "--job_dir",
                os.path.join(tmp, f"drive{i}"), "--ledger", os.path.join(tmp, f"drive{i}.jsonl"))}))
        # the 1× pair is printed, not gated
        want_rc = {"obs_diff slowed": 1, "obs_diff runs 1x": None}
        record["regressions"] = {}
        for name, (rc, out, err, secs) in results.items():
            record["tool_s"][name] = secs
            bad = _forbidden_imports(err)
            print(f"  {name}: exit {rc} in {secs:.2f} s" + (f"; imported {bad}" if bad else ""),
                  flush=True)
            if bad:
                failures.append(f"tools: {name} imported {bad[:5]}")
            if name.startswith("obs_diff"):
                record["regressions"][name] = _diff_regressions(out, failures, name)
            want = want_rc.get(name, 0)
            if want is not None and rc != want:
                tail = "\n".join(line for line in err.splitlines()
                                 if not line.startswith("import time:"))[-1500:]
                failures.append(f"tools: {name} exited {rc}, not {want}: {tail}")
        print(f"  the {len(jobs)} renderers' and gates' processes together: "
              f"{record['tools_wall_s']:.1f} s", flush=True)
        if "cached_invert_edit" not in results["ledger_summary"][1]:
            failures.append("tools: ledger_summary does not name cached_invert_edit")
        if not any(r.startswith("timing:") for r in record["regressions"]["obs_diff slowed"]):
            failures.append(f"tools: obs_diff's verdicts on the slowed copy "
                            f"{record['regressions']['obs_diff slowed']}")
        for name, headings in TOOL_PAGES.items():
            text = open(pages[name]).read() if os.path.isfile(pages[name]) else ""
            missing = [h for h in headings if f"<h2>{h}" not in text]
            record.setdefault("page_bytes", {})[name] = len(text.encode())
            if not text or missing:
                failures.append(f"tools: {name}'s page ({len(text)} chars) lacks {missing}")
        try:
            doc = json.loads(results["trace_view"][1])
            full = [tr for tr in doc["traces"] if set(tr["segments"]) >= TRACE_SEGMENTS]
            record["traces"] = {"all": len(doc["traces"]), "four_segments": len(full)}
            print(f"  trace_view: {len(doc['traces'])} traces, {len(full)} with "
                  f"{sorted(TRACE_SEGMENTS)}; segment p50/p99 (s) "
                  + ", ".join(f"{k} {v['p50_s']:.3f}/{v['p99_s']:.3f}"
                              for k, v in doc["segment_percentiles"].items()), flush=True)
            if not full:
                failures.append("tools: trace_view joined no trace with all four segments")
        except (ValueError, KeyError) as e:
            failures.append(f"tools: trace_view --json output: {e}")
        drive1, drive2 = (_drive_record(results[f"stream_drive {i}"][1], failures,
                                        f"stream_drive {i}") for i in (1, 2))
        if drive1.get("final") and drive2.get("final"):
            a, b = np.load(drive1["final"]), np.load(drive2["final"])
            record["drive_final_max_abs_diff"] = float(np.abs(a - b).max())
            print(f"  the drives' final.npy: {a.shape}, max |1 - 2| "
                  f"{record['drive_final_max_abs_diff']!r}", flush=True)
        drives = (os.path.join(tmp, "drive1.jsonl"), os.path.join(tmp, "drive2.jsonl"))
        diffs = _run_tools({
            "obs_diff drives": _tool_cmd("obs_diff", "--json", "--threshold-scale",
                                         TOOLS_NOISE_SCALE, *drives),
            "obs_diff drives 1x": _tool_cmd("obs_diff", "--json", *drives)})
        for name, (rc, out, err, secs) in diffs.items():
            record["tool_s"][name] = secs
            record["regressions"][name] = _diff_regressions(out, failures, name)
            bad = _forbidden_imports(err)
            print(f"  {name}: exit {rc} in {secs:.2f} s" + (f"; imported {bad}" if bad else ""),
                  flush=True)
            if bad or (name == "obs_diff drives" and rc != 0):
                failures.append(f"tools: {name} exited {rc} (imports {bad})")
        # the same drive once more in this process, for its launches
        before = launch_counts()
        reset_launch_counts()
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = stream_drive.main(["--device", TOOLS_DEVICE, "--job_dir",
                                    os.path.join(tmp, "drive3"), "--ledger",
                                    os.path.join(tmp, "drive3.jsonl")])
        record["tool_s"]["stream_drive 3 (in process)"] = time.perf_counter() - t
        drive_launches = launch_counts()
        record["drive_launches"] = drive_launches
        print(f"  stream_drive 3 (this process): exit {rc} in "
              f"{record['tool_s']['stream_drive 3 (in process)']:.2f} s; launches "
              f"{drive_launches}", flush=True)
        _drive_record(out.getvalue(), failures, "stream_drive 3")
        if rc != 0:
            failures.append(f"tools: stream_drive 3 exited {rc}")
        if TOOLS_DEVICE == "cuda" and not drive_launches["group_norm"]:
            failures.append(f"tools: the drive launched no GroupNorm kernel: {drive_launches}")
        launches = {k: before[k] + drive_launches[k] for k in before}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for h in TOOLS_HANDOFF.values():
            shutil.rmtree(h["dir"], ignore_errors=True)
        TOOLS_HANDOFF.clear()
        _release()
    record["path_s"] = time.perf_counter() - t0
    print(f"  tools path: {record['path_s']:.1f} s", flush=True)
    if failures:
        raise AssertionError("tools path: " + "; ".join(failures))
    return {"tools": {"launches": launches}}, {"tools": record}


def _stream_window0_reference(args, frames: np.ndarray, tmp: str) -> np.ndarray:
    """Phase 21's window 0 when phase 21 did not run: a direct request for
    ``frames`` through an engine, its edit stream."""
    from videop2p_tpu_torch.serve import EditEngine, EditRequest, ProgramSpec

    spec = ProgramSpec(width=512, video_len=8, steps=args.steps,
                       mixed_precision=args.mixed_precision, seed=0)
    engine = EditEngine(spec, out_dir=os.path.join(tmp, "window0"), keep_videos=True,
                        device="cuda")
    try:
        rec = engine.result(engine.submit(EditRequest(
            frames=frames, prompt=STREAM_PROMPTS[0], prompts=list(STREAM_PROMPTS), seed=0,
            **STREAM_REQUEST)), wait_s=600.0)
        return engine.videos(rec["id"])[-1]
    finally:
        engine.close()
        _release()


def group_norm_only(args, card: str, kind: str) -> int:
    """``--gn_only``: GroupNorm's phase-3 checks and timings, its sums over
    the UNet's 61 sites (:func:`gn_site_sums`, at the edit forward's B 2 and
    null-text's B 1), then its summed device time in one edit-batch forward
    and one null-text inner step per dtype. Launches a call are recorded, not asserted, so that an
    older tree's kernel is timed by the same code."""
    # full float32 products and convolutions, as the CLI runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("group norm checks:", flush=True)
    checks = check_group_norm_shapes(gen, expect_launches=False)
    print("group norm over the UNet's 61 sites:", flush=True)
    sums = {f"{mp} B{batch}": gn_site_sums(gen, dtype, batch)
            for mp, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))
            for batch in (2, 1)}
    profiles = []
    for mixed_precision in ("fp32", "bf16"):
        profiles.append(profile_edit_forward(mixed_precision, "auto"))
        profiles.append(profile_null_text_step(mixed_precision, "flash_rect"))
    summary = {"group_norm_ms": {p["label"]: p["ported_ms"]["group_norm"] for p in profiles}}
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kind": kind, "group_norm": checks, "sites": sums,
                       "profiles": profiles}, fh, indent=1)
    print(json.dumps(summary))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _graph_runs(label: str, run) -> dict:
    """``run(cuda_graphs)`` graphed, then eager: each one's outputs, launches
    (counts set to 0 just before), wall seconds and runners' stats."""
    from videop2p_tpu_torch.utils.cuda_graphs import collect_graph_stats

    out = {}
    for flag in (True, False):
        _release()
        reset_launch_counts()
        with collect_graph_stats() as stats:
            t0 = time.perf_counter()
            res = run(flag)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[flag] = {"out": res, "launches": launch_counts(), "wall_s": wall, "stats": stats}
    g = out[True]["stats"]
    print(f"  28 {label}: graphed {out[True]['wall_s']:.2f} s, eager {out[False]['wall_s']:.2f} s; "
          "graphs " + ", ".join(
              f"{r['program']} {r['graphs']} captured in {sum(r['capture_s'].values()):.3f} s "
              f"(pool {r['pool_bytes']} B), {r['replays']} replays, {r['eager_steps']} eager"
              for r in g) + f"; launches {out[True]['launches']}", flush=True)
    return out


def _bit_diffs(a, b, name="") -> list:
    """The names of the tensors that differ in bits between two trees."""
    if isinstance(a, torch.Tensor):
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8) if a.element_size() == 1 else a,
            b.view(torch.uint8) if b.element_size() == 1 else b)
        return [] if same else [name]
    if isinstance(a, dict):
        return [d for k in a for d in _bit_diffs(a[k], b[k], f"{name}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _bit_diffs(x, y, f"{name}/{i}")]
    return [] if a == b else [name]


def _check_graphed(label: str, runs: dict, failures: list) -> dict:
    diffs = _bit_diffs(runs[True]["out"], runs[False]["out"])
    if diffs:
        failures.append(f"28 {label}: graphed != eager at {diffs[:4]}")
    if runs[True]["launches"] != runs[False]["launches"]:
        failures.append(f"28 {label}: launches graphed {runs[True]['launches']} != eager "
                        f"{runs[False]['launches']}")
    graphed = runs[True]["stats"]
    if not graphed or any(r["graphs"] == 0 or r["replays"] == 0 for r in graphed):
        failures.append(f"28 {label}: a runner captured or replayed nothing: {graphed}")
    print(f"  28 {label}: bits equal {not diffs}, launches equal "
          f"{runs[True]['launches'] == runs[False]['launches']}", flush=True)
    return {"bits_equal": not diffs, "launches": runs[True]["launches"],
            "wall_graphed_s": runs[True]["wall_s"], "wall_eager_s": runs[False]["wall_s"],
            "graphs": graphed}


def _turns(label: str, fn, turns=(False, True, True, False)) -> dict:
    """``fn(cuda_graphs)`` for each flag of ``turns`` (eager, graphed,
    graphed, eager: one card, one call): each side's values."""
    vals = {"eager": [], "graphed": []}
    for flag in turns:
        vals["graphed" if flag else "eager"].append(fn(flag))
    print(f"  28 {label}: eager {vals['eager']}, graphed {vals['graphed']}", flush=True)
    return vals


def _set_frame_attention(unet, impl: str) -> None:
    """Every frame-attention site of ``unet`` on ``impl``."""
    from videop2p_tpu_torch.models.attention import FrameAttention
    from videop2p_tpu_torch.ops.attention import make_frame_attention_fn

    for module in unet.modules():
        if isinstance(module, FrameAttention):
            module.attention_fn = make_frame_attention_fn(impl)


def _served_request(ps, frames, prompts, eq_value, cached=None):
    """One served request on ``ps``: the capture inversion of ``frames``
    (unless ``cached``, a hit), then the edit + decode. Returns its videos,
    src_err, the capture, the edit's argument tree and its walls."""
    ctrl = {"blend_word": RABBIT["blend_word"],
            "eq_params": {"words": RABBIT["eq_params"]["words"], "values": [eq_value]}}
    ctx = ps.controller(prompts, **ctrl)
    latents = ps.encode(ps.frames_to_video(frames))
    cond_all, uncond = ps.encode_prompts(prompts), ps.encode_prompts([""])[0]
    walls = {}
    torch.cuda.synchronize()
    if cached is None:
        t0 = time.perf_counter()
        _, cached = ps.invert_capture(latents, ps.encode_prompts(prompts[:1]), ctx)
        torch.cuda.synchronize()
        walls["invert_s"] = round(time.perf_counter() - t0, 4)
    args = (cached, cond_all, uncond, ctx, latents)
    t0 = time.perf_counter()
    videos, src_err = ps.edit_decode(*args)
    torch.cuda.synchronize()
    walls["edit_s"] = round(time.perf_counter() - t0, 4)
    return {"videos": videos, "src_err": float(src_err), "cached": cached, "args": args,
            "walls": walls}


def _served_frames(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)


def _copy_in_ms(ps, tree) -> dict:
    """The ms and bytes of copying a served edit's capture into the set's
    kept edit runner (what each request's edit does first), after a
    synchronize on each side."""
    runner = next(r for r in ps._runners.runners() if r.name == "cached_edit")
    before = runner.copy_in_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.inputs("cached", tree)
    torch.cuda.synchronize()
    return {"ms": round((time.perf_counter() - t0) * 1e3, 3),
            "bytes": runner.copy_in_bytes - before}


def graphs_served_session(args, steps: int, failures: list, modes=("kept", "off"),
                          turns=None) -> dict:
    """Phase 28 (i): SD-1.5 bf16 program sets of ``steps`` steps on one
    bundle, one per graphs mode of ``modes`` ("kept": kept runners,
    "per_call": graphs captured anew each request, "off": eager), each
    warmed with rabbit-jump's controller structure, then ``GRAPH_SERVED``
    on each in ``turns`` (a list of modes; default each once): after warm a
    kept set captures nothing and runs no step eagerly, and every set's
    videos and src_err (0.0) are the "off" set's bit for bit. Records each
    request's walls, captures and eager steps, the kept set's pool bytes
    after warm and the copy-in of a capture."""
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.utils.cuda_graphs import collect_graph_stats

    spec = ProgramSpec(width=512, video_len=8, steps=steps, mixed_precision="bf16", seed=0)
    sets, rec = {}, {"steps": steps, "warm": {}, "requests": {}}
    ctrl = {"blend_word": RABBIT["blend_word"], "eq_params": RABBIT["eq_params"]}
    for mode in modes:
        bundle = next(iter(sets.values())).bundle if sets else None
        sets[mode] = ProgramSet(spec, bundle=bundle, device="cuda", graphs=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = sets[mode].warm(tuple(RABBIT["prompts"]), controller_kwargs=ctrl)
        torch.cuda.synchronize()
        rec["warm"][mode] = {"wall_s": round(time.perf_counter() - t0, 3),
                             "runners": warm.get("runners"),
                             "allocated_gib": round(torch.cuda.memory_allocated() / 2 ** 30, 3)}
    frames = {0: _served_frames(280), 1: _served_frames(281)}
    results: dict = {}
    for mode in (turns or modes):
        ps, fresh_cached = sets[mode], None
        for name, clip, prompts, eq in GRAPH_SERVED:
            before = ps.runner_stats() if ps.keeps_graphs() else None
            with collect_graph_stats() as stats:
                out = _served_request(ps, frames[0 if clip is None else clip], prompts, eq,
                                      cached=fresh_cached if clip is None else None)
            if name == "fresh":
                fresh_cached = out["cached"]
            entry = {"walls": out["walls"], "src_err": out["src_err"],
                     "captures": sum(r["graphs"] for r in stats),
                     "capture_s": round(sum(sum(r["capture_s"].values()) for r in stats), 4),
                     "eager_steps": sum(r["eager_steps"] for r in stats),
                     "replays": sum(r["replays"] for r in stats)}
            if before is not None:
                after = ps.runner_stats()
                entry["runners_made"] = after["made"] - before["made"]
                entry["copy_in_bytes"] = after["copy_in_bytes"] - before["copy_in_bytes"]
                if entry["captures"] or entry["eager_steps"] or entry["runners_made"]:
                    failures.append(f"28 served {mode} {name}: after warm {entry['captures']} "
                                    f"captures, {entry['eager_steps']} eager steps, "
                                    f"{entry['runners_made']} runners made")
            if out["src_err"] != 0.0:
                failures.append(f"28 served {mode} {name}: src_err {out['src_err']!r}")
            rec["requests"].setdefault(mode, {}).setdefault(name, []).append(entry)
            results.setdefault(mode, {}).setdefault(name, out["videos"])
            if name == "hit" and mode == "kept" and "copy_in" not in rec:
                rec["copy_in"] = _copy_in_ms(ps, out["cached"])
            print(f"  28 served {mode} {name}: {entry}", flush=True)
    for mode, by_name in results.items():
        for name, videos in by_name.items():
            if mode != "off" and not torch.equal(videos, results["off"][name]):
                failures.append(f"28 served {mode} {name}: videos differ from the graphs-off "
                                "set's")
    rec["bits_equal_off"] = all(torch.equal(v, results["off"][n])
                                for m, by in results.items() for n, v in by.items())
    if "kept" in sets:
        rec["kept_runners"] = sets["kept"].runner_stats()
        print(f"  28 served kept runners: {rec['kept_runners']}; copy-in "
              f"{rec.get('copy_in')}; bits equal the graphs-off set's "
              f"{rec['bits_equal_off']}", flush=True)
    for ps in sets.values():
        ps.close()
    del sets, results
    _release()
    return rec


def graphs_path(args) -> tuple:
    """Phase 28 (the module docstring): the three graphed programs against
    their eager loops bit for bit, then their times (in turns with
    ``--graph_timings``). One seeded SD-1.5 build serves all three: Stage 1
    on its float32 weights (bf16 compute), then the edit and null-text on
    its bf16 cast."""
    import contextlib as ctx_mod

    from videop2p_tpu_torch.cli.common import build_models, deterministic_convolutions, \
        encode_prompts
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler, DDPMScheduler
    from videop2p_tpu_torch.pipelines import (
        cached_fast_edit,
        ddim_inversion,
        make_unet_fn,
        null_text_optimization,
    )
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import edit_sample
    from videop2p_tpu_torch.pipelines.cached import capture_windows
    from videop2p_tpu_torch.pipelines.sampling import official_null_text
    from videop2p_tpu_torch.train import (
        DistillConfig,
        DistillState,
        TrainState,
        TuneConfig,
        distill_steps,
        init_time_head,
        make_distill_optimizer,
        make_optimizer,
        train_steps,
    )
    from videop2p_tpu_torch.utils.cuda_graphs import collect_graph_stats
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    print(f"28. CUDA graphs against the eager loops (SD-1.5 width, 512², 8 frames, bf16; "
          f"{_allocated_line()}):", flush=True)
    failures, rec = [], {"card": card_line()}
    gen = torch.Generator("cuda").manual_seed(28)
    x0 = 0.8 * torch.randn((1, 8, 64, 64, 4), generator=gen, device="cuda")
    bundle = build_models(dtype=torch.float32, device="cuda", seed=0, frame_attention="chunked",
                          gradient_checkpointing=True)
    unet = bundle.unet
    with torch.no_grad():
        text = encode_prompts(bundle, [TUNE["train_data"]["prompt"]], "cuda")
        cond_all = encode_prompts(bundle, RABBIT["prompts"], "cuda")
        uncond = encode_prompts(bundle, [""], "cuda")[0]
    del bundle

    # (c) Stage 1: float32 weights, bf16 compute, checkpointed blocks
    unet.compute_dtype = torch.bfloat16
    latents = 0.18215 * torch.randn((1, 8, 64, 64, 4), generator=gen, device="cuda")
    start = {k: v.detach().to("cpu", copy=True) for k, v in unet.state_dict().items()}
    cfg = TuneConfig(learning_rate=TUNE["learning_rate"],
                     trainable_modules=tuple(TUNE["trainable_modules"]))

    def tune(flag, steps=GRAPH_TUNE_STEPS):
        with torch.no_grad():
            for k, v in unet.state_dict().items():
                v.copy_(start[k])
        tx = make_optimizer(cfg)
        state = TrainState.create(unet, tx, cfg.trainable_modules)
        with deterministic_convolutions():
            _, losses = train_steps(make_unet_fn(unet), tx, state, DDPMScheduler.create_sd(),
                                    latents, text, 33, num_steps=steps, cuda_graphs=flag)
        return {"losses": losses, "params": {k: v.detach().clone()
                                             for k, v in state.trainable.items()},
                "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}

    runs = _graph_runs(f"Stage 1 ({GRAPH_TUNE_STEPS} steps, bf16 compute, checkpointed "
                       "blocks)", tune)
    rec["tune"] = _check_graphed("Stage 1", runs, failures)
    del runs

    def timed(run, k0, k1):
        """Steady-state ms a step: the wall of ``k1`` steps less ``k0``'s,
        each call warming up and capturing its own graphs, after an untimed
        ``k0`` (a process's first capture at new shapes takes longer)."""
        run(k0)
        walls = {}
        for k in (k0, k1):
            _release()
            t0 = time.perf_counter()
            run(k)
            torch.cuda.synchronize()
            walls[k] = time.perf_counter() - t0
        return round((walls[k1] - walls[k0]) / (k1 - k0) * 1e3, 2)

    if args.graph_timings:
        rec["tune_step_ms"] = _turns(
            "Stage-1 step ms (bf16 compute, checkpointed blocks)",
            lambda flag: timed(lambda k: tune(flag, k), 2, 5))

    # (h) distillation on the same weights (the teacher's), bf16 compute,
    # checkpointed blocks
    dcfg = DistillConfig(learning_rate=1e-4, distill_grid=50,
                         trainable_modules=tuple(TUNE["trainable_modules"]))

    def distill(flag):
        with torch.no_grad():
            for k, v in unet.state_dict().items():
                v.copy_(start[k])
        tx = make_distill_optimizer(dcfg)
        head = init_time_head(torch.Generator("cuda").manual_seed(17), unet.config)
        state = DistillState.create(unet, head, tx, dcfg.trainable_modules)
        with deterministic_convolutions():
            _, losses = distill_steps(make_unet_fn(unet), tx, state, DDIMScheduler.create_sd(),
                                      latents, text, 29, num_steps=GRAPH_DISTILL_STEPS, cfg=dcfg,
                                      cuda_graphs=flag)
        return {"losses": losses,
                **{tree: {k: v.detach().clone() for k, v in getattr(state, tree).items()}
                   for tree in ("trainable", "head", "ema_trainable", "ema_head")},
                "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}

    runs = _graph_runs(f"distillation ({GRAPH_DISTILL_STEPS} steps, bf16 compute, "
                       "checkpointed blocks)", distill)
    rec["distill"] = _check_graphed("distillation", runs, failures)
    del runs
    with torch.no_grad():
        for k, v in unet.state_dict().items():
            v.copy_(start[k])
    del start, latents
    unet.config = dataclasses.replace(unet.config, gradient_checkpointing=False)
    unet.compute_dtype = None
    unet.to(torch.bfloat16)
    _release()

    # (a) the cached fast edit, "auto"
    sched = DDIMScheduler.create_sd()
    fn = make_unet_fn(unet)

    def controller(steps):
        return make_controller(RABBIT["prompts"], WordTokenizer(), steps,
                               is_replace_controller=False, cross_replace_steps=0.2,
                               self_replace_steps=0.5,
                               blend_words=tuple((w,) for w in RABBIT["blend_word"]),
                               equalizer_params=RABBIT["eq_params"], device="cuda")

    def fast_edit(steps, flag, reuse=None):
        ctx = controller(steps)
        cross_len, window = capture_windows(ctx, steps)
        traj, edited = cached_fast_edit(fn, sched, x0, cond_all[:1], cond_all, uncond, ctx,
                                        num_inference_steps=steps, cross_len=cross_len,
                                        self_window=window, reuse_schedule=reuse,
                                        cuda_graphs=flag)
        return {"trajectory": traj, "edited": edited}

    _set_frame_attention(unet, "auto")
    runs = _graph_runs(f"cached fast edit ({GRAPH_EDIT_STEPS} steps, LocalBlend, uniform:2)",
                       lambda flag: fast_edit(GRAPH_EDIT_STEPS, flag, "uniform:2"))
    rec["fast_edit"] = _check_graphed("cached fast edit", runs, failures)
    del runs

    # (f) the plain DDIM inversion with dependent noise, "auto"
    sampler = DependentNoiseSampler.create(num_frames=8, decay_rate=0.3, window_size=4,
                                           ar_sample=True, ar_coeff=0.1, device="cuda")
    runs = _graph_runs(f"ddim_inversion ({GRAPH_INV_STEPS} steps, dependent noise)",
                       lambda flag: ddim_inversion(
                           fn, sched, x0, cond_all[:1], num_inference_steps=GRAPH_INV_STEPS,
                           dependent_weight=0.2, dependent_sampler=sampler,
                           generator=torch.Generator("cuda").manual_seed(36),
                           cuda_graphs=flag))
    rec["ddim_inversion"] = _check_graphed("ddim_inversion", runs, failures)
    del runs

    # (g) the live edit: official mode's full-CFG layout with LocalBlend,
    # null-text embeddings and η 0.1 on dependent noise, "auto"
    null_seq = (uncond[None] + 0.05 * torch.randn(
        (GRAPH_LIVE_STEPS, *uncond.shape), generator=gen, device="cuda")).to(uncond.dtype)
    runs = _graph_runs(f"live edit ({GRAPH_LIVE_STEPS} steps, full CFG, LocalBlend, null-text "
                       "embeddings, eta 0.1 dependent)",
                       lambda flag: edit_sample(
                           fn, sched, x0, cond_all, uncond,
                           num_inference_steps=GRAPH_LIVE_STEPS,
                           ctx=controller(GRAPH_LIVE_STEPS), null_uncond_embeddings=null_seq,
                           eta=0.1, dependent_sampler=sampler,
                           generator=torch.Generator("cuda").manual_seed(37), cuda_graphs=flag))
    rec["live_edit"] = _check_graphed("live edit", runs, failures)
    del runs

    def timed_edit(flag):
        _release()
        torch.cuda.reset_peak_memory_stats()
        with collect_graph_stats() as stats:
            t0 = time.perf_counter()
            fast_edit(GRAPH_TIMED_STEPS, flag)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return {"wall_s": round(wall, 3),
                "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
                "graphs": [{k: r[k] for k in ("program", "graphs", "capture_s", "pool_bytes")}
                           for r in stats]}

    if args.graph_timings:
        rec["fast_edit_50"] = _turns(f"{GRAPH_TIMED_STEPS}-step cached fast edit", timed_edit)
        busy = {}
        for flag in (False, True):
            _release()
            _, wall, busy_s = _busy_traced(lambda: fast_edit(GRAPH_TIMED_STEPS, flag))
            busy["graphed" if flag else "eager"] = {
                "wall_s": round(wall, 3), "busy_s": busy_s and round(busy_s, 3),
                "busy_share": busy_s and round(busy_s / wall, 4)}
        print(f"  28 {GRAPH_TIMED_STEPS}-step cached fast edit traced: {busy}", flush=True)
        rec["fast_edit_50_busy"] = busy

    # (b) official null-text under flash_rect, early stop reached
    _set_frame_attention(unet, "flash_rect")
    src = cond_all[:1]
    traj = ddim_inversion(fn, sched, x0, src, num_inference_steps=GRAPH_NULL_STEPS)

    def null_text(flag, epsilon, early_stop=True):
        emb, stats = official_null_text(
            fn, sched, traj, src, uncond, lambda name: ctx_mod.nullcontext(),
            null_text_precision="fp32", num_inference_steps=GRAPH_NULL_STEPS,
            num_inner_steps=GRAPH_INNER_STEPS, epsilon=epsilon, early_stop=early_stop,
            cuda_graphs=flag)
        return {"embeddings": emb, **stats}

    calib = null_text(False, 1e-5, early_stop=False)["final_loss"]
    epsilon = float(calib.median())
    runs = _graph_runs(f"official_null_text (flash_rect, {GRAPH_NULL_STEPS} x "
                       f"{GRAPH_INNER_STEPS}, epsilon {epsilon:.4e})",
                       lambda flag: null_text(flag, epsilon))
    rec["null_text"] = _check_graphed("null-text", runs, failures)
    inner = runs[True]["out"]["inner_steps"].tolist()
    rec["null_text"]["inner_steps"] = inner
    print(f"  28 null-text inner steps {inner} (calibration final losses {calib.tolist()})",
          flush=True)
    if min(inner) >= GRAPH_INNER_STEPS:
        failures.append(f"28 null-text: early stop not reached, inner steps {inner}")
    del runs

    # (e) "hybrid" null-text under flash_rect, dependent noise
    def hybrid(flag):
        emb, losses = null_text_optimization(
            fn, sched, traj, src, uncond[None], num_inference_steps=GRAPH_NULL_STEPS,
            null_text_mode="hybrid", hybrid_inner_steps=GRAPH_INNER_STEPS, return_losses=True,
            dependent_weight=0.2, dependent_sampler=sampler,
            generator=torch.Generator("cuda").manual_seed(38), cuda_graphs=flag)
        return {"embeddings": emb, "losses": losses}

    runs = _graph_runs(f"hybrid null-text (flash_rect, {GRAPH_NULL_STEPS} x "
                       f"{GRAPH_INNER_STEPS}, dependent noise)", hybrid)
    rec["hybrid"] = _check_graphed("hybrid null-text", runs, failures)
    del runs

    def inner_steps(flag, k):
        return null_text_optimization(fn, sched, traj[:2], src, uncond[None],
                                      num_inference_steps=1, num_inner_steps=k,
                                      early_stop=False, cuda_graphs=flag)

    if args.graph_timings:
        rec["null_text_inner_ms"] = _turns(
            "null-text inner step ms (bf16, flash_rect)",
            lambda flag: timed(lambda k: inner_steps(flag, k), 2, 8))
        busy = {}
        for flag in (False, True):
            _release()
            _, wall, busy_s = _busy_traced(lambda: inner_steps(flag, 8))
            busy["graphed" if flag else "eager"] = busy_s and round(busy_s / wall, 4)
        print(f"  28 null-text (1 outer x 8 inner) busy share: {busy}", flush=True)
        rec["null_text_busy_share"] = busy
    del unet, fn, traj
    _release()

    # (i) a served session on kept runners against a graphs-off set
    rec["served"] = graphs_served_session(args, args.steps, failures)
    if args.graph_timings:
        rec["served_50"] = graphs_served_session(
            args, GRAPH_TIMED_STEPS, failures, modes=("off", "per_call", "kept"),
            turns=("off", "per_call", "kept", "kept", "per_call"))
    print(f"  28 card: {rec['card']}", flush=True)
    return {"graphs": {"launches": rec["fast_edit"]["launches"]}}, failures, {"graphs": rec}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2,
                        help="DDIM steps of every main-path run's inversion and edit "
                             "(official mode: also its null-text outer steps); 2 keeps the "
                             "default run, every path, within its time limit")
    parser.add_argument("--inner_steps", type=int, default=2,
                        help="null-text inner steps of the official main path (phase 10; "
                             "the reference's 10)")
    parser.add_argument("--mixed_precision", choices=("fp32", "bf16"), default="fp32",
                        help="compute dtype of the main path (the CLI's default: fp32)")
    parser.add_argument("--paths", nargs="*", default=list(PATHS), choices=PATHS,
                        help="the paths to drive after the kernel checks (default: all; "
                             "none: the kernel checks only)")
    parser.add_argument("--profile", action="store_true",
                        help="also trace with torch.profiler one cached edit-batch UNet "
                             "forward (path fast), one null-text inner step (path "
                             "official) and one Stage-1 train step (path tune)")
    parser.add_argument("--frame_attention", nargs="+", default=["auto"],
                        choices=("auto", "flash_rect", "flash"),
                        help="the frame-attention implementations to profile")
    parser.add_argument("--graph_timings", action="store_true",
                        help="phase 28: time each program in turns (eager, graphed, "
                             "graphed, eager) and trace the card's busy share (the default "
                             "run times each side once)")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the measurements to this JSON file")
    parser.add_argument("--gn_only", action="store_true",
                        help="GroupNorm alone: its phase-3 checks and timings (GN_SHAPES, "
                             "both dtypes), then one cached edit-batch UNet forward "
                             "('auto') and one null-text inner step ('flash_rect') under "
                             "torch.profiler in float32 and bfloat16, GroupNorm's summed "
                             "device time printed; runs on any tree's package (a copy of "
                             "this script in an older checkout times that checkout's kernel)")
    parser.add_argument("--gn_kernel_names", nargs="+", default=None,
                        help="the device kernels the profiles sum as GroupNorm (default: "
                             "this tree's, KERNEL_NAMES['group_norm'])")
    args = parser.parse_args()

    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    from videop2p_tpu_torch.ops import _build

    # 2. build
    t_run = t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    # each stage's seconds, printed on one line before the contract's lines
    seconds = {"build": build_s}
    print(f"build: {build_s:.1f} s ({', '.join(_build.KERNEL_SOURCES)})", flush=True)
    if args.gn_kernel_names:
        KERNEL_NAMES["group_norm"] = tuple(args.gn_kernel_names)
    if args.gn_only:
        return group_norm_only(args, card, kind)
    ptxas = print_ptxas_reports()

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"frame_attention": [], "group_norm": [], "flash_attention": [],
              "flash_attention_bwd": [], "kernel_grads": {}}
    print("kernel checks:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        # B = 3: the live edit's batch; B = 2, 1: the cached edit's and its
        # capture's; B = 4: the full-CFG edit's; B = 1 also the inversion's
        # and null-text's. Then head dims 64 and 128, and lengths off the
        # bf16 kernels' tiles (192 or 128 query rows, 128 or 64 keys): N
        # 1000, 1100, 333 and F·N 3000, 2200, 1665
        for shape in ((3, 8, 8, 4096, 40), (3, 8, 8, 1024, 80), (2, 8, 8, 4096, 40),
                      (1, 8, 8, 4096, 40), (2, 8, 8, 1024, 80), (4, 8, 8, 4096, 40),
                      (4, 8, 8, 1024, 80), (1, 8, 8, 1024, 80), (1, 8, 8, 1024, 64),
                      (1, 8, 8, 1024, 128), (1, 3, 2, 1000, 40), (2, 2, 4, 1100, 64),
                      (1, 5, 2, 333, 80)):
            # timed: the live edit's two sites, and in float32 null-text's
            timed = shape[0] == 3 or (dtype == torch.float32 and
                                      shape in ((1, 8, 8, 4096, 40), (1, 8, 8, 1024, 80)))
            checks["frame_attention"].append(check_attention(gen, dtype, *shape, timed))
            checks["flash_attention"] += check_flash(gen, dtype, *shape, timed)
    # the resnets' slabs (N streams, frames × pixels, C) and the
    # transformers' (N · frames, pixels, C): GN_SHAPES
    checks["group_norm"] = check_group_norm_shapes(gen)
    checks["tma_refusals"] = check_tma_refusals(gen)
    checks["auto_head_dim_160"] = check_auto_above_head_dim_128(gen)
    torch.cuda.empty_cache()
    # 3b. the flash backward against the plain backward (B = 1: null-text's
    # batch; B = 4: the full-CFG edit's), and the gradients through the
    # fused frame-attention and GroupNorm wrappers
    print("backward checks:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        # null-text's two sites (timed), the full-CFG edit's batch, lengths
        # off the bf16 kernels' tiles, and head dim 128 (BQ 32)
        for shape in ((1, 8, 8, 4096, 40), (1, 8, 8, 1024, 80), (4, 8, 8, 4096, 40),
                      (1, 3, 2, 1000, 40), (2, 2, 4, 1100, 64), (1, 5, 2, 333, 80),
                      (1, 8, 8, 1024, 128)):
            timed = shape in ((1, 8, 8, 4096, 40), (1, 8, 8, 1024, 80))
            checks["flash_attention_bwd"] += check_flash_bwd(gen, dtype, *shape, timed)
        checks["kernel_grads"][str(dtype).replace("torch.", "")] = \
            check_kernel_grads(gen, dtype)

    seconds["kernel_checks"] = time.perf_counter() - t0 - build_s

    frames = np.random.default_rng(0).integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.mixed_precision]
    runs, failures, records = {}, [], {}

    def drive(name, fn, *fn_args):
        """One path: its runs and records merged, its seconds kept."""
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t
        print(f"path {name}: {seconds[name]:.1f} s (run {time.perf_counter() - t_run:.1f} s)",
              flush=True)
        runs.update(out[0])
        records.update(out[-1])
        return out

    if "fast" in args.paths:
        failures += drive("fast", fast_paths, args, frames, dtype, checks)[1]
    if {"official", "official_flash"} & set(args.paths):
        failures += drive("official", official_paths, args, frames, dtype)[1]
    if "dependent" in args.paths:
        drive("dependent", dependent_paths, args, frames)
    if "checkpoint" in args.paths:
        drive("checkpoint", checkpoint_path, args, frames, dtype)
    # the tune path's export stays on disk until the distill path has
    # started from it
    os.makedirs("outputs", exist_ok=True)
    tune_tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_", dir="outputs")
    try:
        if "tune" in args.paths:
            drive("tune", tune_path, args, frames, tune_tmp)
        if "surface" in args.paths:
            drive("surface", surface_path, args, frames)
        if "distill" in args.paths:
            drive("distill", distill_path, args, frames,
                  runs["tune"]["dir"] if "tune" in runs else None)
    finally:
        shutil.rmtree(tune_tmp, ignore_errors=True)
    if "sdxl" in args.paths:
        drive("sdxl", sdxl_path, args)
    if "serve" in args.paths:
        drive("serve", serve_path, args, frames)
    # the program analysis runs on every engine's and every child's first
    # calls where a ledger is open; phase 19 keeps it (an engine's cost
    # model prices from it) and phase 24 holds it, while phases 20-23 run
    # with its kill switch: their engines and CLI children would add about
    # a minute to the default run
    with _analysis_off():
        if "fleet" in args.paths:
            drive("fleet", fleet_path, args)
        if "stream" in args.paths:
            drive("stream", stream_path, args)
        if "observe" in args.paths:
            drive("observe", observe_path, args)
        if "runs" in args.paths:
            drive("runs", runs_path, args, frames)
    if "analysis" in args.paths:
        drive("analysis", analysis_path, args, frames)
    if "mesh" in args.paths:
        drive("mesh", mesh_path, args)
    if "serve_mesh" in args.paths:
        with _analysis_off():
            drive("serve_mesh", serve_mesh_path, args)
    if "tools" in args.paths:
        with _analysis_off():
            drive("tools", tools_path, args, frames)
    if "graphs" in args.paths:
        failures += drive("graphs", graphs_path, args)[1]

    dname = str(dtype).replace("torch.", "")
    big_attn = [3, 8, 8, 4096, 40]

    def entry(name, kind, shape, run, counter, source, replaces, pool=checks, dt=dname,
              wrapper=None):
        """A kernel's line: its check (from ``pool``) at the largest
        main-path shape in the main path's dtype, its launches on the path
        that runs it, and on each path that ran (``launches_by_path``); the
        SDXL lines' launches are the SDXL path's alone."""
        rec = next(c for c in pool[kind] if c.get("wrapper", kind) == (wrapper or name)
                   and c["shape"] == shape and c["dtype"] == dt and "ms" in c)
        by_path = {path: r["launches"][counter] for path, r in runs.items()
                   if r.get("launches", {}).get(counter) and (path == "sdxl") == (run == "sdxl")}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": runs[run]["launches"][counter],
                "launches_by_path": by_path,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "bound_cuda_core_ms": rec.get("bound_cuda_core_ms"),
                "library_ms": rec["library_ms"],
                "ratio": rec["ratio"], "shape": rec["shape"], "dtype": rec["dtype"]}

    def bwd_entry(key, grads, replaces, run):
        """A flash backward kernel's line: its check at null-text's largest
        shape through flash_rect (its plain version and library call compute
        all three gradients: the library call is SDPA's backward alone, and
        SDPA's forward + backward rides beside it), and its launches on the
        official flash_rect path."""
        rec = next(c for c in checks["flash_attention_bwd"]
                   if c["wrapper"] == "flash_rect_frame_attention"
                   and c["shape"] == [1, 8, 8, 4096, 40] and c["dtype"] == dname)
        return {"name": f"flash_attention_bwd_{key}", "route": "cuda",
                "source": "videop2p_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                "replaces": replaces,
                "launches": runs[run]["launches"][f"flash_bwd_{key}"],
                "launches_by_path": {
                    path: r["launches"][f"flash_bwd_{key}"] for path, r in runs.items()
                    if r.get("launches", {}).get(f"flash_bwd_{key}")},
                "max_abs_err": max(rec["max_abs_err"][g] for g in grads),
                "ms": rec["ms"][key], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"][key], "bound_by": rec["bound_by"],
                "bound_cuda_core_ms": rec.get("bound_cuda_core_ms", {}).get(key),
                "library_ms": rec["library_ms"], "ratio": rec["ms"][key] / rec["library_ms"],
                "library_fwd_bwd_ms": rec["library_fwd_bwd_ms"],
                "shape": rec["shape"], "dtype": rec["dtype"]}

    # each kernel's launches come from the main path that runs it: the fast
    # edit where it ran, else official mode, else the dependent, the
    # checkpoint, the surface path's cached edit, the student's, the served
    # edits', the fleet's, the streamed windows' or the observed fleet's;
    # GroupNorm's, when only Stage 1 or distillation ran, from that run
    # (neither runs a frame-attention kernel). SDXL's run has lines of its
    # own, at its shapes (head dim 64) in bf16, the dtype it runs in.
    auto = next((r for r in ("auto", "official", "dependent_cached", "checkpoint",
                             "surface_multi", "student_edit", "serve", "fleet", "stream",
                             "observe", "runs", "analysis", "mesh", "serve_mesh", "tools",
                             "graphs")
                 if r in runs), None)
    rect = next((r for r in ("flash_rect", "official_flash_rect",
                             "surface_hybrid_flash_rect", "analysis_flash_rect")
                 if r in runs), None)
    rect_bwd = next((r for r in ("official_flash_rect", "surface_hybrid_flash_rect",
                                 "analysis_flash_rect") if r in runs), None)
    full = ("flash" if "flash" in runs else
            "official_flash" if "official_flash" in runs else None)
    kernels = []
    if auto:
        kernels += [
            entry("frame_attention", "frame_attention", big_attn, auto, "frame_attention",
                  "videop2p_tpu_torch/ops/csrc/frame_attention.cu",
                  "videop2p_tpu/ops/attention.py:111"),
            entry("group_norm", "group_norm", [3, 8 * 4096, 640], auto, "group_norm",
                  "videop2p_tpu_torch/ops/csrc/groupnorm.cu",
                  "videop2p_tpu/ops/groupnorm.py:69")]
    elif {"tune", "distill"} & set(runs):
        kernels.append(entry("group_norm", "group_norm", [3, 8 * 4096, 640],
                             "tune" if "tune" in runs else "distill",
                             "group_norm", "videop2p_tpu_torch/ops/csrc/groupnorm.cu",
                             "videop2p_tpu/ops/groupnorm.py:69"))
    if "sdxl" in runs:
        sdxl_checks, side = records["sdxl"]["checks"], 128
        kernels += [
            entry("frame_attention_sdxl", "frame_attention", [1, 8, 10, side * side // 4, 64],
                  "sdxl", "frame_attention", "videop2p_tpu_torch/ops/csrc/frame_attention.cu",
                  "videop2p_tpu/ops/attention.py:111", sdxl_checks, "bfloat16",
                  "frame_attention"),
            entry("group_norm_sdxl", "group_norm", [1, 8 * side * side, 320], "sdxl",
                  "group_norm", "videop2p_tpu_torch/ops/csrc/groupnorm.cu",
                  "videop2p_tpu/ops/groupnorm.py:69", sdxl_checks, "bfloat16", "group_norm")]
    if rect:
        kernels.append(entry("flash_rect_frame_attention", "flash_attention", big_attn, rect,
                             "flash_attention", "videop2p_tpu_torch/ops/csrc/flash_attention.cu",
                             "videop2p_tpu/ops/attention.py:94"))
    if full:
        kernels.append(entry("flash_frame_attention", "flash_attention", big_attn, full,
                             "flash_attention", "videop2p_tpu_torch/ops/csrc/flash_attention.cu",
                             "videop2p_tpu/ops/attention.py:81"))
    if rect_bwd:
        kernels += [
            bwd_entry("dkv", ("dk", "dv"),
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:941", rect_bwd),
            bwd_entry("dq", ("dq",), "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
                      rect_bwd)]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kind": kind, "build_s": build_s, "ptxas": ptxas,
                       "checks": checks,
                       "main_path": runs, **records}, fh, indent=1)
    if failures:
        print("chip_smoke failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    seconds["total"] = time.perf_counter() - t_run
    serving = sum(seconds.get(k, 0.0) for k in ("fleet", "stream", "observe"))
    print("seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; fleet + stream + observe {serving:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
