#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``autorally_tpu_torch``) on one GPU.

Drives the port's main path — BASELINE config #1 (``path_integral_nn``):
the 6-32-32-4 tanh MLP at full width with seeded Glorot weights, K=1920
rollouts, T=100, gaussian exploration, the exact 560 x 800 oval costmap —
the kernel-RNG capacity mode — the same model and map at K=262144
(BASELINE config #5; ``bench.py``'s ``rng_exact_K262144`` and
``rng_exact_ou_K262144``), gaussian and OU (theta 0.15) exploration drawn
inside the kernels — and the neural-field costmap path — the same model on
a 34-64-64-1 field fitted to that map on the card (``bench.py``'s
``neural_K65536`` and ``rng_K262144``) — the basis-function path —
BASELINE config #2 (``path_integral_bf``), the 25-basis-function model with
seeded theta at K=2560 — and the obstacle path — the main path with an
``ObstacleCost`` of 16 slots whose circles move every tick — and the tube
loop — the main path's configuration in ``run_tube_mppi``'s two
controllers with DDP gains — and the closed-loop episode — the same tube
with the tick captured as one CUDA graph — and the general rollout path
— a cost subclass through kernel 2 and a batched cost epilogue, a model
without a kernel form through the solver's plain chain — and the model
ensembles — BASELINE config #5's 8 members through ``EnsembleMPPISolver``
at K=16384 and K=65536 — and the sharded solvers — the main path's
rollouts over 1, 2 and 4 ranks of ``torch.distributed`` on the one card,
the capacity mode over 2 and the ensemble over a 2 x 2 mesh — and the ML
pipeline — BASELINE config #3: a 6-64-64-64-64-4 model trained on the
card by ``ml.trainer`` from a drive log, then driven at K=8192 through
kernels 1-4 built for its spec, on the exact map, on the field and in the
capacity mode — and the fields of other specs — kernels 3 and 4 built
for fields of five other specs (F and the hidden widths), among them the
JAX package's own 26-48-48-1 fit, fitted on the card and driven at the
field path's sizes, also in bf16 — and checks every CUDA kernel of these paths,
in every form, against its plain PyTorch version.  Phases (any failure
exits non-zero):

1. build the kernels from ``autorally_tpu_torch/csrc/rollout_kernels.cu``
   (the default library, the libraries of phase 28's three other MLP
   specs, phase 30's field libraries and phase 31's bf16 ones, one nvcc
   each, the wide spec's in parts, ``_build.NVCC_JOBS`` at once in that
   order; while the default library builds, phase 32 (a)-(b) runs and
   phases 11 and 30's fields are fitted, none of which runs its kernels;
   the others build on while phases 2-27 run, and when phase 28 or 30
   takes them each
   one's instances, kernels 3 and 4 among them, are printed with their
   registers, spills, dynamic shared memory and blocks an SM, zero spill
   bytes in every one, its field instances at least 8 warps an SM, in
   blocks of 256, and TF32 HMMA in their SASS), require seventeen kernels
   in the
   default library (kernels A, B, 3 and both modes
   of pass 1 in an MLP and a BF instance each, BF exact pass 1 being
   ``fused_rng_bf_kernel``, pass 2, kernel A in each MLP lane group,
   kernel B one rollout a warp, MLP and BF, and phase 19's check) and zero
   spill bytes in every one
   (ptxas -v); print the four field instances'
   registers, dynamic shared memory and blocks an SM (at least 8 warps),
   and require TF32 tensor-core instructions (HMMA) in their SASS
   (``cuobjdump -sass``);
2. kernel A (fused rollout + exact cost) against its plain version at
   K=1920, T=100 in four cases: nominal start, wide swarm (exploration
   std x4), NaN x coordinate, and a fine random map on which the crash
   flags differ between rollouts (there against the plain cost along
   kernel B's trajectories), and at K=1921 and on a shard's slice
   (k_offset != 0), each in every launch geometry that the launcher picks
   for some K (``launcher_geometries``: one rollout a thread, lane
   groups), every geometry bit for bit equal to the first;
3. kernel B (dynamics chain) against its plain version on the same inputs,
   on a shard's slice and at its main-path shape (the nominal trajectory,
   K=1), each in both of its geometries (``rk.CHAIN_GEOMETRIES``: one
   rollout a thread, one a warp), bit for bit equal to one rollout a
   thread;
4. the main path: one MPPI iteration on the GPU against the same iteration
   on the CPU, then ``MPPISolver`` on ``cuda`` for one untimed solve and
   200 ticks of slide + solve + plant step, with both kernels' launch
   counters reset just before and read just after; the same drive in two
   pairs whose order alternates, kernel A in one rollout a thread and in
   the launcher's geometry (the same controls), each pair's medians, and
   again for kernel B (one rollout a thread, one a warp); the host time
   that the controller state's key adds to a solve;
5. timing of each kernel at its main-path shape against its plain version
   and its bound, kernel A's launch geometry (G, block, registers, blocks
   an SM, waves), and kernel B in both geometries with its latency floor
   (T times the step's longest dependent chain, counted from its SASS by
   ``tools/sass_chain.py`` at the card's highest SM clock);
6. a torch.profiler trace of 50 ticks: device time by kernel and the
   device's idle share;
7. pass 1 of the capacity mode against its plain version at K=262144,
   T=100, gaussian and OU, in phase 2's four cases, and at K=262143 and on
   a shard's slice (one rollout a thread); its in-kernel stream
   must equal the plain stream bit for bit (pass 1 equals kernel A fed the
   plain stream); and two models with different weights whose launches
   alternate on one stream, each bit for bit kernel A with its own weights
   and held against its own plain versions;
8. pass 2 against its plain version with pass 1's softmax weights, the
   same with three warps of every four zeroed (sparse) and all 1 (dense),
   with a NaN in U (NaN where the plain version has it, and every other
   partial bit for bit the run's without the NaN), and one-hot weights
   that extract single rollouts' controls;
9. the capacity path: one iteration on the GPU against the CPU at
   K=16384, then 100 ticks of ``drive_oval.drive`` on a capacity-mode
   solver at K=262144 for each sampler, launch counters reset before and
   read after each (1 pass 1, 1 pass 2, 1 kernel B and no kernel A per
   solve), then one more, untimed tick whose pass-2 inputs are held
   against the plain version;
10. timing of both passes at K=262144 against their plain versions and
    bounds (with pass 1's launch geometry; the integer-pipe and issue
    floors of a step of their stream loop in the SASS printed beside,
    with the step's FCHK, MUFU.RCP, BSSY and BSYNC), BF exact pass 1
    gaussian and OU with its registers, warps an SM, waves and floors
    (outside forward branches and over the whole loop body),
    pass 2 on the nominal weights, the closed loop's tick's and dense
    ones, each with its share of all-zero warps, of kernel A at the same
    K, and
    of whole solves at K=262144 in
    the capacity and the host-noise modes; a torch.profiler trace of 20
    capacity-mode ticks;
11. the field: ``drive_oval.build(neural_costmap=True)`` fits it on the
    card with ``fit_neural_costmap``'s defaults (seconds, mae, flip rate);
    kernel 3 (fused rollout + field cost) against its plain version at
    K=65536, T=100 in four cases: nominal, wide swarm, NaN x, and a
    seeded random field whose values cross the 0.65 boundary (costs
    rtol 1e-4 / atol 1e-3 and crash flags equal in every rollout in the
    nominal case, in all but 1 % elsewhere; u_seq exactly), and the
    nominal case at K=65536-19;
12. pass 1 in field mode against its plain version at K=262144, the same
    cases, gaussian and OU, at K=262144-13 and on a shard's slice
    (``SHARD``: k_offset != 0), each bit for bit against kernel 3 fed the
    plain stream;
13. the field path closed-loop: 100 ticks at K=65536 in the host-noise
    mode and 50 ticks at K=262144 in the capacity mode, launch counters
    reset before and read after each (1 kernel 3 and 1 kernel B per
    host-noise solve; 1 field pass 1, 1 pass 2 and 1 kernel B per capacity
    solve; nothing else), and no plain version called;
14. timing of kernel 3 and of pass 1's field mode against their plain
    versions and two bounds (the tensor cores' for the field's hidden
    layers, and all fp32 on the CUDA cores), beside kernel A and exact
    pass 1 at the same K;
    whole field solves; torch.profiler traces of 10 ticks of each mode;
15. the BF instances of kernels A and B against their plain versions at
    K=2560 in phase 2's cases (kernel A also at K=2561 and on a shard's
    slice, in each of its launch geometries; kernel B in both of its
    geometries, bit for bit) and at the nominal trajectory (K=1), with
    the seeded theta and with a strong theta whose slip and tan rows are
    scaled by their denominators (dropping any of those rows must move the
    plain chain's states by more than 5 x the tolerance);
16. the BF path: one iteration on the GPU against the CPU, then 200 ticks
    of ``drive_oval.build(model="bf")`` (1 BF kernel A and 1 BF kernel B
    per solve, nothing else, no plain version), then one more, untimed
    tick whose inputs of BF kernel A phase 18 times;
17. the obstacle forms: two circles in 16 slots placed so that some
    rollouts hit them and some do not, kernel A (K=1920), kernel 3
    (K=65536) and pass 1 on both surfaces (K=262144) against their plain
    versions (the exact-map forms in every launch geometry), and the BF
    forms of kernel 3 and pass 1 with the strong theta; BF exact pass 1
    without circles, seeded and strong theta, gaussian and OU, at
    K=262144, at K=262144-13 and on a shard's slice; pass 1 bit for bit
    the eps-reading kernel fed the plain stream;
    the field obstacle forms also at K=65536-19 and on a shard's slice;
18. the obstacle path: a live ``CostParams.obstacles`` reaching the kernel,
    200 ticks with the circles moved every tick (1 obstacle kernel A and 1
    kernel B per solve), 20 ticks of each other BF and obstacle form,
    every form's timing against its plain version and bound (BF kernel B
    in both geometries, with its latency floor; BF kernel A on random
    noise and on phase 16's tick; BF exact pass 1 also OU), the MLP
    kernels without obstacles re-timed in the same run, and a 50-tick
    torch.profiler trace of the BF path;
19. BF exact pass 1's branch-free arithmetic, on every input: its
    quotients by the 16 constant divisors (``div_const`` with its guard)
    against IEEE division for all 2^32 float32 bit patterns, and its
    stream's quotient and square root against ``__fdiv_rn`` and
    ``__fsqrt_rn`` for all 2^23 uniforms the stream forms; 0 mismatches,
    the seconds printed;
20. the tube loop (``run_tube_mppi``: two controllers at K=1920 solving
    every tick, DDP gains on, a lockstep ``SyntheticPlant`` at 50 Hz):
    (a) the DDP on a warmed-up tick's inputs, captured bit for bit the
    eager run and within DDP_CPU_REL of the port's CPU run, timed captured,
    eager and as two overlapped runs, the eager run's launches counted by
    the profiler; (b) 200 ticks with exactly 2 launches of kernels A and B
    a tick, no plain-version call, finite controls, the car accelerating
    and moving, status 0, the arbitration's outcomes and the tick's p50 /
    p99 split into the solves, the DDP runs, the plant step and the rest;
    (c) a weight push (the next solve bit for bit a fresh solver's on the
    new weights, the next DDP run an eager run's on them), a cost push
    reaching both controllers and a throttle cut zeroing the DDP's
    throttle limit, mid-run; (d) 20 ticks with the BF model (K=2560), its
    DDP captured bit for bit its eager run, a captured run's graph nodes
    (device events) and time with the fused BF Euler step, then 100 BF
    ticks; each drive also prints Python's collections inside it;
21. the closed-loop episode (``runtime/episode.py``'s ``EpisodeRunner``,
    the tick captured once as one CUDA graph and replayed) at the main
    path's width on the oval of ``tools/lap_eval.load_track("oval")``:
    (a) 25 ticks with DDP gains, two plant substeps a tick and an ESS
    target, captured against the same ticks run eagerly on the card, every
    ``EpisodeResult`` field bit for bit; again with another desired speed
    (captured anew, other states: no stale graph) and with other seeds (the
    same graph); (b) 10 replayed ticks under the profiler: exactly 2
    launches of kernel 1 and 2 of kernel 2 a tick, no plain-version call;
    (c) 20 ticks each, captured bit for bit eager and finite: moving
    obstacles (16 slots), the capacity mode (K=262144), the asymmetric
    tube (K_pred=480); (d) the capture's seconds, ms a replayed tick (CUDA
    events), ticks/s and sim-seconds a wall-second and ``episode_metrics``
    for 250 ticks without gains, 100 with, and the BF model at K=2560
    with gains (100 ticks); (e) ``tools/lap_suite.run_config`` on an oval
    and a winding row, 500 ticks, the artifact checked by
    ``validate_laps``'s rules (the winding track allowed);
22. the async loop (``runtime/async_loop.py`` through ``run_tube_mppi``'s
    ``--async-loop`` path: both controllers one dispatched tick, captured
    once as one CUDA graph, DDP gains on, a lockstep ``SyntheticPlant``):
    (a) 30 dispatches of a captured tube bit for bit an eager one's, the
    strides 0, 1, 2 and T-1 mixed and a cost push at tick 25 (one more
    capture); (b) 10 replayed dispatches under the profiler: exactly 2 + 2
    kernel launches a tick, the graph's nodes; (c)-(e) 200 ticks at depth
    1 and 2 with ``EssTuner.attach_async`` moving gamma every harvest: the
    solution published exactly ``depth`` dispatches late, one capture in
    all, the host's dispatch ms, the harvest's wait, each dispatch's device
    span (CUDA events), and at depth 1 the device's busy share of the
    period over 20 ticks under ``runtime/profiling.device_trace``;
23. the realtime gates (``runtime/realtime_gate.py``; the simulator
    ``tools/sim_node.py --cpu`` a second process on seeded weights, UDP
    over loopback, the native pacer): the sequential loop at K=64, T=16
    and the async loop at K=1920, T=100, depth 2 adaptive, both with
    gains, 3 s passes, at most 3 attempts; each must pace natively, reach
    100 valid ticks, p99 under 20 ms, missed 0, missed_raw 0 (or at most
    the tainted ticks + 2 when some were tainted) and capture nothing in
    the measured passes; the sequential loop's kernel launches counted;
24. the general rollout path (``solver/mppi.py``'s chain and batched cost
    epilogue): (a) kernel 2 at K=1920 (MLP) and K=2560 (BF) against its
    plain version (phases 3 and 15 hold both of its geometries); (b) a
    cost subclass (the speed cost doubled) at BASELINE #1: kernel 2 and
    the epilogue against the plain chain and the epilogue, a subclass that
    overrides nothing against kernel 1, 200 ticks of ``drive_oval.drive``
    (20 with the BF model at K=2560) with exactly 2 kernel-2 launches a
    solve (one at K, one at K=1, by ``rk.LAUNCHES_BY_K``), no kernel 1 and
    no plain version; (c) ``EnsembleDynamics`` (M=8) through
    ``MPPISolver`` at K=1920, the solver's plain chain: 20 ticks eager
    with no rollout-kernel launch, and 20 captured episode ticks bit for
    bit the eager ones, each replay timed (CUDA events);
25. the ensemble solver (``solver/ensemble.py``) at bench.py's rows, M=8,
    K=16384 and K=65536, T=100, ``__graft_entry__.py``'s members and
    state: (a) 8 identical members bit for bit ``MPPISolver`` (U, the
    nominal trajectory, every stat); (b) each member's kernel 1 at K/M
    against the plain cost along kernel 2's trajectories (every rollout),
    at most 1 % of the rollouts apart from the whole plain version, u_seq
    exactly, the nominal trajectory (member 0, kernel 2); (c) 100 solves
    with a sync after each (p50 / p99) and 100 back to back (solves/s),
    peak device memory, exactly 8 kernel-1 launches at K/M and 1 kernel-2
    launch at K=1 a solve, no plain version; kernel 1 at K/M timed; (d)
    ``tools/ensemble_ab.py --track oval --members 8 --rollouts 4096
    --ticks 300 --seeds 1`` through the captured episode: each arm's
    captured ticks bit for bit its eager ones, its launches a tick (the
    capture's warm-up and captured ticks), ms a replayed tick, both arms'
    JSON;
26. the sharded solvers (``parallel/``), ranks started by
    ``parallel/launch.py`` after the kernel library is built here, each
    reporting 0 builds of its own: (a) one rank over NCCL,
    ``ShardedMPPISolver`` at K=1920 with ``force_collectives`` bit for bit
    its inline body (an iteration and 20 chained solves), the inline body
    bit for bit ``MPPISolver.iterate`` on ``fold_in(sub, 0)``'s noise, 1
    kernel-1 and 1 kernel-2 launch a solve; (b) 2 and 4 ranks sharing the
    card over gloo (NCCL refuses two ranks on one card), K=1920 host noise:
    U within rtol 1e-4 / atol 1e-5 of ``MPPISolver.iterate`` on the
    shards' noise concatenated, the baseline within rtol 1e-5, each rank's
    kernel 1 at its ``k_offset`` against its plain version, every rank's U
    and controller state bit for bit equal, 20 chained solves (p50 / p99);
    (c) the capacity mode over 2 ranks at K=262144, gaussian and OU: passes
    1 and 2 of each shard (``k_offset`` 0 and 131072) against their plain
    versions, the reduced U against the plain passes' combination; (d)
    ``EnsembleShardedMPPISolver``, 2 members x 2 rollout shards on 4 ranks,
    K=16384, against ``EnsembleMPPISolver.iterate`` on the member-block
    noise, 1 kernel-1 launch an iteration a rank;
27. the tools and the build cache: ``tools/solve_breakdown.py`` at K=1920
    and with the capacity mode at K=262144, ``tools/scaling_bench.py`` over
    1 and 2 ranks (``--mode both --k-local 1920``; the 2-rank rows share
    the card), and two processes loading the kernel library at once from
    a fresh ``enable_persistent_cache`` directory: one ``nvcc`` run;
28. kernels 1 and 2 at two other MLP specs, 6-64-64-64-64-4 (BASELINE
    #3's) and 6-24-4 (a width only the 8-lane group divides), seeded
    weights: kernel 1 at K=8192, T=100 in phase 2's four cases (the fine
    random map from 0.3 m/s) and on a shard's slice, kernel 2 at K=1 and
    K=8192, each in every geometry its launcher takes for the spec, against
    their plain versions and bit for bit equal to one another; times (CUDA
    events) beside the bounds, kernel 2's latency floor at K=1 from the
    spec library's SASS, the wide spec's geometries against K, the
    6-32-32-4 kernel 1 at K=8192; 20 ticks of the 6-24-4 spec through the
    solver (its launches); kernels 3 and 4 at those specs and 6-25-4 (279
    weights: the field after them at a float4), on phase 11's field at
    K=8192: kernel 3 in phase 11's cases (the random field from 0.3 m/s),
    at K=8173 and on a shard's slice against its plain version; pass 1 on
    the exact map and the field, gaussian and OU, bit for bit kernel 1 or 3
    fed the plain stream, also at K=8193 and on a shard's slice, and
    against its plain version; pass 2 on those weights against its plain
    version; times beside the bounds (exact pass 1 also at K=65536); 20
    ticks of each narrow spec on the field, in the capacity mode on the
    exact map and on the field (their launches);
29. BASELINE #3: a 60 s, 50 Hz drive log from a seeded 6-32-32-4 teacher
    (its output layer scaled by 0.3, so that its car does not roll over)
    under sinusoidal controls (``tools/sim_node.teacher_drive_log``),
    ``ml.trainer.run`` on the card (6-64-64-64-64-4, standardized, 30
    epochs, horizons 10 and 50: seconds, epochs a second, best validation
    loss; the trained RMSE under half a fresh init's), the exported
    ``model.npz`` through ``NeuralNetDynamics.from_npz`` at its spec; one
    iteration on the card against the CPU; ``MPPISolver`` at K=8192, T=100
    on the oval, one untimed solve and 200 ticks with exactly one launch of
    kernel 1 and one of kernel 2 a solve and no plain version (p50 / p99
    against 20 ms, printed, not a gate); an ``update_model`` swap at tick
    10 of a 20-tick drive (its solve bit for bit a fresh solver's on the
    new weights, the weights repacked); the trained model on phase 11's
    field with host noise (100 ticks; kernel 3 + kernel 2 a solve), in the
    capacity mode on the exact map, gaussian and OU, and on the field (50
    ticks each; pass 1 + pass 2 + kernel 2 a solve), each with one
    iteration on the card against the CPU, exact launch counts, no plain
    version and p50 / p99 against 20 ms (printed, not a gate); a 20-tick
    profile;
30. kernels 3 and 4 on fields of other specs (``FIELD_PAIRS``: F6-48-48,
    F5-40-20, F4-32-32-32, F8-64, F8-128-128 and F3 beside the default
    MLP, F5-40-20 beside 6-24-4), each from a library of its own (phase
    1's rules for each: zero spills, TF32 HMMA in each field instance but
    F3's, which takes no product, 8 warps an SM or one block where two do
    not fit), seeded fields: kernel 3 at K=8192 in phase 11's cases, a
    ragged K, a shard's slice and 16 circle slots, pass 1's field mode
    gaussian and OU, also at K=8193, on a shard and with the slots, bit for
    bit kernel 3 fed the plain stream, the BF instances with the strong
    theta, all against their plain versions; times of kernel 3 at K=65536
    and pass 1 at K=262144 beside both bounds; 10-tick drives of each pair
    with host noise and in the capacity mode (their launches); then
    F6-48-48 fitted on the card (``drive_oval.build(neural_costmap=True,
    fit_kwargs=FIT_KWARGS)``), 100 host-noise ticks at K=65536 and 50
    capacity ticks at K=262144 (exactly 1 + 1 and 1 + 1 + 1 launches a
    solve, no plain version, p50 / p99 against 20 ms, printed), and the
    same field in bf16 held and driven 20 ticks;
31. ``matmul_precision="default"``: the bf16-operand libraries' instances
    against their ``"default"`` plain versions, and drives on each path;
32. the physics simulator (``sim/``) and the ML loop on the card: (a)
    ``vehicle_step`` for 250 periods under a gentle and a hard command
    script on the card (the period one replayed CUDA graph) against the
    CPU within the CPU tests' rtol 1e-5 / atol 1e-4 at every period, the
    captured period bit for bit the eager one on the card, a period's ms
    eager and captured (CUDA events and host clock) and the graph's nodes
    (profiler); (b) ``tools/sim_node.py --physics --urdf --world`` as its
    own process for 3 s at 50 Hz with ``--log`` (exit 0, done at the
    world's spawn, 150 ground-truth rows, the pacer's missed periods);
    (c) ``ml_loop_demo``'s loop at its own width (seeded 6-32-32-4, K=768,
    T=60): 500 lockstep ticks against the physics plant with the log
    recorded, the fine-tune (the fit must improve), the hot swap through
    the plant's queue (both controllers hold the new weights bit for bit)
    and 500 more ticks, each drive with exactly 2 + 2 kernel launches a
    tick, no plain version and solve p50 / p99 at most 20 ms, its mean
    speed, speed error and ticks a second; (d) BASELINE #3 on the physics
    log: ``ml.trainer.run`` (6-64-64-64-64-4, 30 epochs) on (c)'s
    after-swap log, reverse and forward (RMSE under half a fresh init's),
    then 200 ticks of the physics plant at K=8192 with the trained model
    (the car covers 5 m at a mean speed of 2 m/s or more, exactly 1 + 1
    launches a solve, p99 at most 20 ms);
33. the cost-parameter sweep (``tools/param_sweep.py``) on the lane forms
    of kernels 1 and 2 (a stacked ``CostParams``, L settings in one
    launch): (a) the nine lane instances' registers (ptxas, no spill) and
    blocks an SM; (b) at L=3, K=512 and L=12, K=1920, MLP and BF, seeded
    weights, every lane's coefficients its own: kernel 1's lane form
    against its plain version by phase 11's rule (u_seq bit for bit),
    kernel 2's at K and at K=1 against theirs, and each lane bit for bit
    the solo instance run with that lane's scalars in the lane launch's
    geometry; kernel 1's lane form in every geometry and kernel 2's in
    both, bit for bit one another; (c) the tool's sweep at its defaults
    (seeded 6-32-32-4 from a temporary ``.npz``, K=512, 200 ticks,
    desired_speed 5, 6, 7) and a 12-lane grid at K=1920 (desired_speed
    4..7 x gamma 0.05, 0.15, 0.6), 50 ticks: one capture, exactly 2 + 2
    lane launches in the captured tick (counted by the wrappers; the
    profiler over 5 replayed ticks finds the lane forms and no solo
    instance), no plain version, the replayed tick's ms,
    graph nodes a tick, ticks/s and the wall time of the L solo captured
    episodes beside it (reported, not gated), the first and the last lane
    bit for bit their solo captured episodes over the whole run (every
    field), a 3-lane BF sweep's
    launches, and the lane forms timed beside their plain versions and
    bounds; (d) ``param_sweep.main``, ``ess_demo`` in both modes on the
    oval and ``two_car_demo.run_two_cars`` on the seeded ``.npz``.
34. circles, the neural field, the ESS law and moving obstacles in the
    sweep's lanes: (a) the registers, shared memory and blocks an SM of
    kernel 1's lane instances (which now stage a lane's circles) and of
    kernel 3's two new lane instances; (b) kernel 1's lane form with
    circles (16 a lane's own, 16 shared, 64 a lane's own) at L=3, K=512,
    and at L=12, K=1920 with the drives' 16 (own and shared), MLP in every
    geometry and BF, against its plain version, each lane bit for bit its
    solo instance with that lane's scalars and circles, the circles
    changing every lane's costs; (c) kernel 3's lane form at L=3, K=512
    and L=4, K=16384 (the field path's 65,536 rollouts), without and with
    16 circles a lane, and at L=12, K=1920 without (the drives' form),
    MLP and BF, on phase 11's fitted field, the same holds; (d) 50
    ticks of a 12-lane sweep at K=1920 with an ``ObstacleCost`` (each
    lane's circles) and the ESS law, the same with moving obstacles, and
    on the fitted field, each with its launches counted (2 + 2 a captured
    tick), no plain version, the replayed tick's p50 / p99, a short
    profile and lanes 0 and 11 bit for bit their solo captured episodes;
    20 ticks of 3-lane BF sweeps on the field and with circles; and the
    new instances timed beside their plain versions and bounds.
35. the capacity mode in the sweep's lanes and every library's lane
    forms: (a) pass 1's lane instances (exact and field, MLP and BF),
    gaussian and OU, with no circles, 16 a lane and 16 shared, at L=3,
    K=512 and L=12, K=1920, against their plain versions by phase 9's rule
    and each lane bit for bit its solo instance on the same stream, and
    one launch on a shard's slice (k_offset != 0); (b) pass 2's lane form
    on nominal, sparse, dense and a closed loop's weights, each lane's
    partials bit for bit the solo kernel's and the numerator within 1e-5
    of sum |w u| of its plain version; (c) kernels 1, 2, 3 and pass 1's
    lane forms bit for bit their solo instances in the 6-64-64-64-64-4
    library and the F6-48-48 field library at K=8192 and the bf16 library
    at K=1920, L=3; (d) capacity drives through ``EpisodeRunner.run`` with
    a stacked ``CostParams``, captured and replayed: 12 lanes at K=1920
    (100 gaussian ticks, 20 OU), 4 lanes at K=262144 (12 ticks on the map,
    5 on the field), 3 lanes of 6-64-64-64-64-4 at K=8192 (capacity and
    host noise, 20 each) and 3 at ``"default"`` (20), each with exactly
    2 + 2 + 2 lane launches a tick counted, no plain version, the
    replayed tick's p50 / p99, graph nodes, ticks/s, and lanes 0 and L-1
    bit for bit their solo captured episodes; the new instances timed
    beside their plain versions and bounds, and the phase's seconds.
36. circles past the 64 slots a launch stages, and a field left in device
    memory: (a) kernel 1 (MLP in the launcher's geometry at K=1920, BF at
    K=2560) at 65, 128 and 1024 slots, kernel 3 (MLP, BF) at K=65536 and
    pass 1 (exact MLP and BF, field) at K=262144 with 128, the two circles
    that some rollouts hit in slots past the 64 and every fourth slot
    free, against their plain versions (kernel 1 also along kernel 2's
    trajectories in every rollout; pass 1 also bit for bit kernel 1 or 3
    fed its stream), u_seq bit for bit; the lane forms of kernels 1 and 3
    and of pass 1 (exact and field) at L=3, K=512 with 128 a lane, each
    lane bit for bit its solo instance; (b) the library of BASELINE #3's
    6-64-64-64-64-4 beside a seeded 34-128-128-1 field (built last at
    phase 1; the packed field in device memory): its ptxas report, layout
    and shared memory, kernel 3 and field pass 1 at K=8192 against their
    plain versions (pass 1 bit for bit kernel 3 on its stream) and their
    lane forms at L=3, each lane bit for bit its solo instance; (c) drives
    with exact launches a solve and no plain version: BASELINE #1 among
    118 cones on the oval's edges in 128 slots (100 ticks; the capacity
    mode at K=262144, 20 ticks) and the pair with host noise and in the
    capacity mode (20 ticks each), each solve's p50 / p99 printed beside
    20 ms and not gated; the new forms timed beside their plain versions
    and bounds.
37. the operator's run: phase 20's tube (K=1920, T=100, DDP gains), 200
    lockstep ticks through ``run_tube_mppi.drive`` with every option of
    ``run_tube_mppi`` on (``OperatorIO``: a UDP telemetry port, a runstop
    port bound to 0, a JSONL log, the scene camera) and
    ``tools/console.py --duration`` attached in a subprocess: a runstop
    over UDP at tick 80, held each tick and released at 120, engages the
    plant's runstop for exactly the controls published after ticks 80-119
    (each the requested throttle cut to at most 0); the actual
    controller's weights pushed at tick 100 through ``msgs.encode`` ->
    ``decode`` -> ``params_from_model_msg`` -> ``update_model_params``,
    the next solve's kernel-1 outputs bit for bit a solve on the weights
    given directly with the same noise; the log holds every record kind
    (``run``, 200 ``solve``, ``timing``, ``diag``, ``system`` naming the
    card as ``nvidia-smi`` does, ``image`` at 5 Hz of the plant's clock,
    and ``lap``: the seeded car makes no lap in 200 ticks, so lap
    statistics on the start line take two turns of a circle and the
    operator publishes that lap); the console rendered and logged the run;
    exactly 2 + 2 launches a tick as in phase 20, no plain version; the
    tick's p50 / p99 beside phase 20's plain tube, against 20 ms, not
    gated;
38. the car's I/O around the solve on the card: a scripted circle (6 s at
    200 Hz) feeds the EKF with noisy IMU, GPS as GPGGA + GPGST bytes from
    ``GpsNmeaSimulator`` through ``GpsReceiver`` and
    ``GpsEstimatorBridge`` (10 Hz) and wheel speeds as ``#w`` frames over
    a pty through ``ChassisLink`` and ``WheelOdometry`` (50 Hz); at 50 Hz
    the EKF's state vector goes to the plant and BASELINE #1 solves on the
    card; the plant's control goes as ``ChassisCommand("mppi")`` into a
    ``CommandArbiter`` beside ``ConstantSpeedController`` and
    ``GpsWaypointController``, through ``SafeSpeedGovernor``, under the
    runstop of a ``VehicleNetworkNode`` that a coordinator drives, and out
    as ``#s`` frames read back from the pty; in the second half a peer
    node's relayed pose is a circle of an ``ObstacleCost``.  Exactly 1 + 1
    launches a solve (kernel 1's obstacle instance once the circle is
    live), no plain version; every ``#s`` frame the arbitrated command's
    pulse widths; MPPI silent for 20 ticks: the fallbacks own both
    actuators within ``command_max_age`` and hand them back; the runstop
    off for 20 ticks: every throttle pulse the runstop's; the peer's pose
    in kernel 1's circle slots, pricing some rollouts.  Printed, not
    gated: the solve's p50 / p99, the I/O's host ms a tick, the EKF's
    position error.  Then ``tools/scaling_forecast.py`` on this run's
    kernel-1 ladder (phase 5's K=1920, K=8192 and 262144 timed alike) with
    a short probe on two gloo CPU ranks, its document held to the schema;
39. every horizon the JAX kernels take: past the horizon at which a launch
    stages U in shared memory (``rk.staged_u``) it reads U, and kernel 2's
    warp form its eps, in device memory.  Kernel 1 (MLP lane groups and
    BF), kernel 2 (warp form, MLP and BF, K=1 and 256), exact pass 1
    (gaussian) and pass 2 at T=4100, K=256; kernel 3 and field pass 1 at
    T=2100 (the default pair) and at T=800 beside F8-128-128 (its
    library's staged cap is 792); the lane forms of kernels 1 and 3 at
    L=2 past their caps.  Each fused form against its plain version by
    phase 17-18's rule (costs and crash flags along kernel 2's
    trajectories, u_seq bit for bit), pass 1 bit for bit kernel 1 / 3 fed
    its stream, pass 2 within NUMER_RTOL of sum |w u|, kernel 2 in both
    geometries bit for bit and its first 100 steps bit for bit the staged
    launch's, each lane bit for bit its solo instance; 3-tick drives at
    each horizon with exact launches and no plain version; each form timed
    beside its bound.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(each kernel with its CUDA instance and its geometry or design, every
compiled instance with its registers, the paths' latencies, the tube's and
the BF tube's tick p50 / p99, the BF DDP run's nodes, the episode's
launches and timings, the async tick's launches and timings, both gates'
results, the general path's latencies, the ensemble's, the sharded
solvers' and the tools', BASELINE #3's, the other specs' sweeps, kernels
3 and 4's other timings and drives at the other specs, the cost-parameter
sweeps' and phases 34-36's drives, phase 37's tick, phase 38's I/O and
forecast, phase 39's drives), and as
its last
line
``{"ok": true, "device": {...}}``.  Needs one CUDA
GPU; exits non-zero without one, or without the package beside it.

Usage::

    python3 chip_smoke.py
"""

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12         # tensor cores, dense

K, T = 1920, 100
TICKS = 200
# phase 4's drives of kernel A in the old and the new geometry, in pairs
# whose order alternates (ten once, so that a gain could be told from the
# spread; two since phase 36 came)
TURN_PAIRS = 2
# timed runs of a plain version: it takes 0.1-1.5 s of launches, and one
# run gives its time; each plain version has run at its shape for its check
# before it is timed, so it takes no warm-up of its own (one before phases
# 38-39)
PLAIN_REPS = 1
PROFILE_TICKS = 50
COST_RTOL, COST_ATOL = 1e-4, 1e-3     # 100 fp32 steps, other summation order
STATE_RTOL, STATE_ATOL = 1e-4, 1e-3
ITER_ATOL = 1e-3                      # U_new of one iteration, GPU vs CPU
# rollouts whose cost may differ from the whole plain version on the 2 cm
# random map, where a rounding-level change of position moves a texel
MAX_RANDOM_MAP_DIFFER = K // 100

# The capacity mode (kernel_rng=True).
KC = 262144
K_ITER_CHECK = 16384                  # GPU vs CPU iteration
CAP_TICKS = 100
CAP_PROFILE_TICKS = 20
SAMPLERS = {"gaussian": {}, "ou": dict(noise_sampler="ou", noise_param=0.15)}
KEY = (0x2545F491, 0x9E3779B9)
# pass 2 against its plain version, relative to sum_k |w_k u_{k,t,c}|:
# fp32 sums of 262144 terms in another order (a shuffle tree per block,
# then the blocks, against cuBLAS's gemv)
NUMER_RTOL = 1e-5
ONEHOT_ATOL = 1e-5
# Operations of the in-kernel stream per rollout-step, counted in
# csrc/rollout_kernels.cu: Threefry-2x32-20 79 (key schedule 4, 20 rounds
# of add, funnel shift and xor, 5 key injections of 3), uniforms 5, log
# 29, square root 2, sine and cosine 31, Box-Muller products 2; the OU
# recursion adds 6.  Integer operations are counted at the fp32 rate, the
# higher of the two (Hopper has 64 INT32 to 128 FP32 lanes per SM), which
# keeps the bound a lower bound.
STREAM_OPS, OU_OPS = 148, 6
# pass 2 per rollout-step: the perturbation (2 mul, 2 add), w u (2 mul),
# the reduction (2 add)
UPDATE_OPS = 8

# The neural-field path (bench.py's neural_K65536 and rng_K262144): kernel 3
# in the host-noise mode at K=65536, pass 1's field mode at K=262144; a
# shard's slice of pass 1, (k_offset, K_local): neither a multiple of 32.
KF = 65536
SHARD = (KC // 2 - 69, KC - (KC // 2 - 69) - 7)
FIELD_TICKS = 100
FIELD_CAP_TICKS = 50
FIELD_PROFILE_TICKS = 10

# The basis-function path: BASELINE config #2 (path_integral_bf), the
# 25-basis-function model with seeded theta at K=2560 (bench.py's
# bf_K2560); the obstacle path: the main path's configuration with an
# ObstacleCost of 16 slots, two circles active, moved every tick.
KB = 2560
BF_TICKS = 200
OBS_TICKS = 200
BF_PROFILE_TICKS = 50
FORM_TICKS = 20                       # each other BF and obstacle form
N_SLOTS = 16
# Operations counted in csrc/rollout_kernels.cu: one BF step is the 25
# basis functions (60, atan, tan and sin one each), theta^T phi (100
# multiply-adds) and the Euler update (14); one active circle per cost step
# 13 (2 differences, 2 squares, a sum, the root, the margin, the quotient,
# 1 - q, the clip's 2 compares, the max, the hit compare), an inactive slot
# 1, and the coefficient's product 1.
BF_STEP_OPS = 60 + 2 * 100 + 14
CIRCLE_OPS, SLOT_OPS = 13, 1
# The seeded theta (std 0.01) moves the states by 1e-5 or less through the
# slip and tan rows 2-4 and 9-15, whose denominators reach 2.7e9: far under
# the tolerance, so a wrong tan branch, moving test or dropped row there
# would pass.  The strong theta scales those rows by their denominators
# (14 and 15, whose r13 is small, by 30x and 300x more) and every row by 10:
# then dropping any one of them moves some case's states by more than
# 5 x STATE_ATOL (checked on the plain chain), and the chain stays finite
# from the starts it is held on.
BF_SUSPECT_ROWS = {2: 1200.0, 3: 1.44e6, 4: 1.728e9, 9: 40.0, 10: 1400.0,
                   11: 1.96e6, 12: 2.744e9, 13: 40.0, 14: 4.8e4, 15: 1.92e7}
BF_ROW_SCALE = 10.0 * np.array([BF_SUSPECT_ROWS.get(i, 1.0)
                                for i in range(25)], np.float32)


# The tube loop (phase 20): BASELINE #1 in run_tube_mppi's loop, both
# controllers at K=1920, DDP gains on, a lockstep SyntheticPlant at 50 Hz.
TUBE_TICKS = 200
WARM_TICKS = 10                       # (a)'s inputs: a warmed-up tick's
HOT_TICKS = 12                        # (c): pushes at tick 10, cut at 11
TUBE_BF_TICKS = 20
# (d) again for a p99 that is not the slowest of 20 ticks
TUBE_BF_LONG_TICKS = 100
DDP_REPS, DDP_EAGER_REPS = 50, 5
# the DDP on the card against the port's CPU run on the same inputs, each
# field's max |error| over its max |value|: fp32 rollouts of 100 steps and
# a 99-step recursion whose sums cuBLAS and the CPU's BLAS order apart
DDP_CPU_REL = 1e-3
# The car accelerates from rest: u_x over 0.5 m/s after TUBE_TICKS ticks.
# tests/test_runtime.py holds the loop to 1.5 m/s with the reference
# weights, which the repository does not hold; the seeded MLP (Glorot,
# seed 0) is weaker: the same loop reaches 1.13 m/s in 200 ticks on the
# plain path (run_tube_mppi --cpu --ticks 200) and 0.868 on the card
TUBE_MIN_SPEED = 0.5

# The closed-loop episode (phase 21): BASELINE #1 (the MLP, seeded Glorot
# weights, K=1920, T=100) as runtime/episode.py's EpisodeRunner on the 60 m
# x 36 m oval of tools/lap_eval.load_track("oval"), the tick one CUDA graph.
EP_BIT_TICKS = 25                     # (a) captured against eager
EP_PROFILE_TICKS = 10                 # (b) launches counted by the profiler
EP_SHORT_TICKS = 20                   # (c) obstacles, capacity, asymmetric
EP_K_PRED = 480
# (d) timing (1,000 / 200 / 200 before PR 23's cut, 500 / 200 / 200 before
# PR 25's)
EP_TICKS, EP_GAIN_TICKS, EP_BF_TICKS = 250, 100, 100
EP_LAP_TICKS = 500                    # (e) the lap suite's run_config
EP_LAP_ROWS = (
    {"name": "oval_nn_gaussian", "track": "oval", "K": K, "T": T,
     "desired_speed": 6.0, "noise": "gaussian"},
    {"name": "winding_nn_gaussian", "track": "winding", "K": K, "T": T,
     "desired_speed": 6.0, "noise": "gaussian"})

# The async loop (phase 22): BASELINE #1 in run_tube_mppi's async loop, the
# tick one CUDA graph, gains on, a lockstep SyntheticPlant at 50 Hz.
ASYNC_BIT_TICKS = 30                  # (a) captured against eager
ASYNC_PUSH_AT = 25                    # (a) a cost push: one more capture
ASYNC_PROFILE_TICKS = 10              # (b) launches counted by the profiler
ASYNC_TICKS = 200                     # (c)-(e) at depth 1 and 2
ASYNC_TRACE_TICKS = 20                # (e) under device_trace
# The realtime gates (phase 23): 3 s passes, at most 3 attempts each.
GATE_SECONDS, GATE_ATTEMPTS = 3.0, 3
GATE_WARMUP = 8                       # the sequential gate's warm-up ticks

# The general rollout path (phase 24): a cost subclass at BASELINE #1 (and
# the BF model's K=2560) through kernel 2 and the batched cost epilogue;
# EnsembleDynamics (M=8) through MPPISolver, the solver's plain chain.
GEN_TICKS = 200
GEN_BF_TICKS = 20
GEN_ENS_TICKS = 20
ENS_M = 8
# The ensemble solver (phase 25): bench.py's ensemble8_K16384 and
# ensemble8_K65536 rows from __graft_entry__.py's state, chained solves;
# tools/ensemble_ab.py through the captured episode.
ENS_KS = (16384, 65536)
ENS_SOLVES = 100
ENS_START = (25.0, 0.0, 1.57, 0.0, 2.0, 0.0, 0.0)
AB_ARGS = ["--track", "oval", "--members", str(ENS_M), "--rollouts", "4096",
           "--ticks", "300", "--seeds", "1"]

# registers of each kernel instance, from the build's ptxas report; the
# library's SASS (phase 1)
PTXAS = {}
SASS = []


class PhaseFailed(Exception):
    pass


def agreeing(kc, kx, pc, px):
    """The rollouts in which a kernel's costs ``kc`` and crash flags ``kx``
    agree with its plain version's ``pc`` and ``px``: costs within
    COST_RTOL / COST_ATOL, equal flags."""
    import torch

    return torch.isclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL) & (kx == px)


def agreement(tag, name, kc, kx, pc, px, n, limit=None):
    """Costs within COST_RTOL/COST_ATOL and equal crash flags: in every
    rollout in the nominal case, in all but 1 % elsewhere (a value within
    rounding of a boundary, a texel edge or a circle can latch on one side
    only; near tan's pole the BF model turns a rounding difference into a
    large one), or in all but ``limit``.  Returns the max cost error over
    rollouts with equal flags."""
    import torch

    same = kx == px
    n_differ = int((~agreeing(kc, kx, pc, px)).sum().item())
    n_crash = int((~same).sum().item())
    err = (kc - pc)[same].abs().max().item()
    if limit is None:
        limit = 0 if name == "nominal" else n // 100
    print(f"[{tag}] {name}: max|cost err| {err:.3e} over rollouts with "
          f"equal crash flags (cost range {pc.min().item():.4g}.."
          f"{pc.max().item():.4g}), crash {int(px.sum().item())}/{n}, "
          f"crash mismatches {n_crash}, {n_differ} rollouts differ "
          f"(limit {limit})")
    check(torch.isfinite(kc).all().item(), f"{tag} {name}: non-finite")
    check(n_differ <= limit, f"{tag} {name}: {n_differ} rollouts differ "
          f"from the plain version, limit {limit}")
    if name.startswith("random"):
        check(0 < px.sum().item() < n, f"{tag} {name}: crash flags do not "
              "differ between rollouts")
    return err


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


def launcher_geometries(rk, bf: bool, k_max: int = KC, layers=None,
                        k_first: int = None) -> list:
    """Every geometry (G, block) of kernel 1 that the launcher
    (``rk.exact_geometry``) picks on this card for some K in
    1..k_max for the MLP spec ``layers`` (the default library's when
    None), the one at ``k_first`` (K=1920, BF: K=2560) first."""
    import torch

    kw = {} if layers is None else {"layers": layers}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k_first = k_first or (KB if bf else K)
    first = rk.exact_geometry(k_first, sms, bf, **kw)[:2]
    picked = {rk.exact_geometry(k, sms, bf, **kw)[:2]
              for k in range(1, k_max + 1)}
    return [first] + sorted(picked - {first})


def bit_equal(a, b) -> bool:
    """Equal bit for bit: float32 tensors compared as their int32 bits, so
    that a NaN (a state of the NaN-x case) equals the same NaN."""
    import torch

    if a.dtype == b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def geometry_label(geom) -> str:
    return "G%d block %d" % tuple(geom[:2])


def hold_geometries(tag, geoms, run, check_one, chain: bool = False):
    """``run()`` under each forced geometry in ``geoms`` (of kernel 1, or
    of kernel 2 when ``chain``): ``check_one(label, outputs)`` on each, and
    every geometry's outputs bit for bit equal to the first's (lane groups
    and warps evaluate the same arithmetic as one rollout a thread).
    Returns the first geometry's outputs."""
    import torch
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    force = forced_chain_geometry if chain else forced_geometry
    first = None
    for geom in geoms:
        label = geometry_label(geom)
        with force(*geom):
            out = run()
        torch.cuda.synchronize()
        check_one(label, out)
        if first is None:
            first = out
            continue
        same = all(bit_equal(a, b) for a, b in zip(out, first)
                   if torch.is_tensor(a))
        print(f"[{tag}] {label}: bit equal to {geometry_label(geoms[0])}: "
              f"{same}")
        check(same, f"{tag} {label}: differs from "
              f"{geometry_label(geoms[0])}")
    return first


def exact_instance(geom, rng: bool, bf: bool) -> str:
    """The CUDA instance of kernel 1 (exact pass 1 when ``rng``) that
    ``geom`` launches, by its short name."""
    if geom.group > 1:
        return f"fused_exact_group_kernel<{geom.group}>"
    if rng and bf:
        return "fused_rng_bf_kernel"
    return (f"{'fused_rng' if rng else 'fused_exact'}_kernel"
            f"<{'Bf' if bf else 'Mlp'}>")


def geometry_line(rk, tag, launch, rng: bool, bf: bool, card, layers=None):
    """Prints the geometry of a launch of kernel 1 or exact pass 1 (of the
    MLP spec ``layers``'s library; the default one when None): G, block,
    grid, registers (ptxas and the runtime), resident blocks an SM and
    waves (one rollout a thread: R = 1 always)."""
    g = launch.geometry
    kw = {} if layers is None else {"layers": layers}
    info = rk.exact_kernel_info(rng, bf, g, T, 0, **kw)
    kern = exact_instance(g, rng, bf)
    if layers is not None:
        kern += f" [{spec_label(layers)}]"
    print(f"[{tag}] geometry {geometry_label(g)}, grid {g.grid}: {kern}, "
          f"{PTXAS.get(kern, '?')} registers (ptxas), {info['registers']} "
          f"(runtime), {info['local_bytes']} bytes of local memory, "
          f"{info['blocks_per_sm']} blocks "
          f"({info['blocks_per_sm'] * g.block // 32} warps) an SM, "
          f"{info['waves']:.2f} waves ({card})")


def drive_turns(drive_oval, what, chain, old, new, solver, params,
                cost_params, costmap, controls, card) -> list:
    """The main path's drive with ``what`` (kernel 1, or kernel 2 when
    ``chain``) forced into geometry ``old`` and ``new`` in TURN_PAIRS pairs
    whose order alternates (old then new, new then old, ...), each drive's
    controls equal to ``controls``: each pair's p50 and p99 and the p50's
    gain, and a summary line."""
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    force = forced_chain_geometry if chain else forced_geometry
    turns = []
    for i in range(TURN_PAIRS):
        pair = {}
        for geom in ((old, new) if i % 2 == 0 else (new, old)):
            with force(*geom):
                o = drive_oval.drive(solver, params, cost_params, costmap,
                                     TICKS, log=lambda m: None)
            check(np.array_equal(o["controls"], controls),
                  f"main path with {what} in {geometry_label(geom)}: other "
                  "controls")
            pair["old" if geom == old else "new"] = (
                float(np.percentile(o["solve_ms"], 50)),
                float(np.percentile(o["solve_ms"], 99)))
        pair["first"] = "old" if i % 2 == 0 else "new"
        pair["gain_p50"] = pair["old"][0] - pair["new"][0]
        turns.append(pair)
        print(f"[main path] {what} pair {i} ({pair['first']} first), the "
              f"same controls: in {geometry_label(old)} p50 "
              f"{pair['old'][0]:.3f} p99 {pair['old'][1]:.3f} ms, in "
              f"{geometry_label(new)} p50 {pair['new'][0]:.3f} p99 "
              f"{pair['new'][1]:.3f} ms, p50 gain {pair['gain_p50']:.3f} ms")
    gains = [p["gain_p50"] for p in turns]
    q = {g: np.percentile([p[g][0] for p in turns], [25, 50, 75])
         for g in ("old", "new")}
    print(f"[main path] {what}: p50 gain of {geometry_label(new)} over "
          f"{geometry_label(old)} over {TURN_PAIRS} pairs: median "
          f"{statistics.median(gains):.3f} ms, range {min(gains):.3f}.."
          f"{max(gains):.3f} ms, won {sum(g > 0 for g in gains)} of "
          f"{TURN_PAIRS}; the drives' p50 median {q['old'][1]:.3f} against "
          f"{q['new'][1]:.3f} ms, quartile spread "
          f"{q['old'][2] - q['old'][0]:.3f} against "
          f"{q['new'][2] - q['new'][0]:.3f} ms ({TICKS} ticks a drive; "
          f"{card})")
    return turns


def chain_timing(rk, tag, model, params, cfg, start, U, eps, bf, reps,
                 card, sass: str = None) -> dict:
    """Kernel 2 at ``eps``'s K in the launcher's geometry and in one rollout
    a thread (CUDA events), and its latency floor in the launcher's
    geometry (``chain_floor`` on ``sass``, the default library's when
    None): {ms, geometry, one_thread_ms, floor_ms}."""
    from autorally_tpu_torch.tools.exact_variants import forced_chain_geometry

    launch, _ = rk.prepare_dynamics_chain(model, params, cfg, start, U, eps)
    with forced_chain_geometry(*rk.CHAIN_GEOMETRIES[0]):
        one, _ = rk.prepare_dynamics_chain(model, params, cfg, start, U, eps)
    ms, ms_one = cuda_ms(launch, reps), cuda_ms(one, reps)
    floor = chain_floor(SASS[0] if sass is None else sass, bf,
                        launch.geometry, max_sm_clock_mhz())
    print(f"[timing] {tag} K={eps.shape[1]} in {geometry_label(launch.geometry)}"
          f": {ms:.4f} ms; in one rollout a thread {ms_one:.4f} ms; latency "
          f"floor {floor['ms']:.4f} ms: the step's longest dependent chain "
          f"{floor['cycles']} clocks ({floor['chain']} instructions on it; "
          f"{floor['in_order']} clocks in issue order; {floor['body']} "
          f"instructions a step, {floor['skipped']} behind forward branches "
          f"left out) x T={T} at {floor['clock_mhz']:.0f} MHz (clocks.max.sm)"
          f", a floor for a dependent chain at assumed latencies, not a "
          f"roofline ({card})")
    return {"ms": ms, "geometry": launch.geometry, "one_thread_ms": ms_one,
            "floor_ms": floor["ms"]}


def chain_entry(chain: dict) -> dict:
    """Kernel 2's own keys in the ``kernels`` line."""
    return {"geometry": geometry_label(chain["geometry"]),
            "one_thread_ms": chain["one_thread_ms"]}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def mlp_flops(layers) -> int:
    """fp32 operations of one rollout-step: MLP multiply-adds and bias adds,
    plus the 7-component Euler update."""
    return sum(2 * a * b + b for a, b in zip(layers[:-1], layers[1:])) + 14


def field_eval_ops(layers, num_freqs: int) -> int:
    """Operations of one field evaluation: the MLP's multiply-adds and bias
    adds, the transform (6 products, 6 sums, 2 quotients), the 2F angle
    products and the 4F sines and cosines, each counted as one operation
    (which keeps the bound a lower bound)."""
    return (sum(2 * a * b + b for a, b in zip(layers[:-1], layers[1:]))
            + 14 + 6 * num_freqs)


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time for ``nbytes`` at the memory rate, ``flops`` at the
    fp32 rate and ``tf32_flops`` on the tensor cores: (ms, what bounds it)."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = max(flops / PEAK_FP32_FLOP_PER_S,
              tf32_flops / PEAK_TF32_FLOP_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def field_bounds(nbytes: float, other_ops: float, n_evals: float, field):
    """A field kernel's two bounds, each (ms, what bounds it): the fp32 one
    (every operation on the CUDA cores) and the tensor-core one, in which
    the two hidden layers' products as the function has them (34 features;
    the kernels' zero padding to 40 is their own overhead, not the
    function's work), tripled by 3xTF32, run at the TF32 rate and the rest
    of the field's operations (``field_eval_ops`` less the products) and
    ``other_ops`` at the fp32 rate."""
    layers, n_freqs = field.layers, field.freqs.numel()
    ops = field_eval_ops(layers, n_freqs)
    products = 2 * sum(a * b for a, b in zip(layers[:-2], layers[1:-1]))
    return (bound(nbytes, other_ops + n_evals * ops),
            bound(nbytes, other_ops + n_evals * (ops - products),
                  n_evals * 3 * products))


_SASS_OF = {}                # (layers, field) -> library_sass' text
_FITS = {}                   # fit_kwargs' items -> (build's result, seconds)


def fitted_field(drive_oval, dev, fit_kwargs=None):
    """``drive_oval.build(rollouts=KF, device=dev, neural_costmap=True,
    fit_kwargs=fit_kwargs)``, the field fitted on the card through the
    entry point, and its seconds (CUDA-synchronized host clock), once a
    run: ``main`` fits phases 11 and 30's fields while the default library
    builds (the fit runs no kernel of it)."""
    import torch

    key = tuple(sorted((fit_kwargs or {}).items()))
    if key not in _FITS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drive_oval.build(rollouts=KF, device=dev, neural_costmap=True,
                               fit_kwargs=fit_kwargs)
        torch.cuda.synchronize()
        _FITS[key] = (out, time.perf_counter() - t0)
    return _FITS[key]


def library_sass(layers=None, field=None) -> str:
    """``cuobjdump -sass`` of the built kernel library (of the MLP spec
    ``layers`` and the field spec ``field``; the default one when None),
    dumped once a run (``Builds`` dumps each library of another spec
    beside its build)."""
    from autorally_tpu_torch.ops import _build

    if (layers, field) in _SASS_OF:
        return _SASS_OF[layers, field]
    objdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([objdump, "-sass",
                          str(_build.library_path(layers, field))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise PhaseFailed(f"cuobjdump failed: {out.stderr.strip()}")
    _SASS_OF[layers, field] = out.stdout
    return out.stdout


def check_field_sass(sass: str) -> dict:
    """The TF32 tensor-core instructions (HMMA ... TF32) in the SASS of each
    field kernel instance of the built library."""
    found = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        short = re.search(r"\d+((?:fused_rng_field|fused_field)_kernel)I.*?"
                          r"(MlpSplit|Mlp|Bf)Deriv", fn.split("\n", 1)[0])
        if short:
            found[f"{short.group(1)}<{short.group(2)}>"] = sum(
                1 for line in fn.splitlines()
                if "HMMA" in line and "TF32" in line)
    return found


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def chain_floor(sass: str, bf: bool, geom, clock_mhz: float) -> dict:
    """Kernel 2's latency floor in ``geom``: T times the longest dependent
    chain of a step of its time loop, counted from its SASS at assumed
    latencies (``tools/sass_chain.py``), at ``clock_mhz``; the loop's body
    must hold one step's stores (the warp's one store instruction, or the
    thread's 7 states and 2 controls).  A floor for a dependent chain, not
    a roofline and not a measurement."""
    from autorally_tpu_torch.ops.rollout_kernel import CHAIN_OUTPUTS
    from autorally_tpu_torch.tools import sass_chain

    warp = geom.group > 1
    name = "dynamics_chain_warp_kernel" if warp else "dynamics_chain_kernel"
    chain = sass_chain.loop_chain(sass_chain.instructions(
        sass, rf"\d{name}I\w*?{'Bf' if bf else 'Mlp'}DerivELb0E"),
        stores=1 if warp else CHAIN_OUTPUTS)
    chain["ms"] = T * chain["cycles"] / (clock_mhz * 1e3)
    chain["clock_mhz"] = clock_mhz
    return chain


def stream_mix(sass: str) -> dict:
    """A step of the stream loop of exact pass 1 (MLP and BF) and of pass 2
    in the built library's SASS, by pipe, with its IEEE divisions' and
    branches' marks (``tools/sass_chain.loop_mix``)."""
    from autorally_tpu_torch.tools import sass_chain

    return {name: sass_chain.loop_mix(sass_chain.instructions(sass, regex))
            for name, regex in (
                ("pass1_mlp", r"\dfused_rng_kernelI\w*?MlpDerivELb0E"),
                ("pass1_bf", r"\dfused_rng_bf_kernelILb0E"),
                ("pass2", r"\dweighted_update_kernelILb0E"))}



def ptxas_report(log: str):
    """(kernel, registers, spill store + load bytes) for each entry
    function in ``ptxas -v`` output."""
    rows, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"\d+([a-z_]+_kernel)(?:E|ILi(\d+)E|I.*?"
                              r"(MlpSplit|Mlp|Bf)Deriv|IJ|I(?=Lb))E?(Lb1E)?",
                              m.group(1))
            arg = short and ", ".join(
                a for a in (short.group(2) or short.group(3),
                            short.group(4) and "lanes") if a)
            name = (short.group(1) + (f"<{arg}>" if arg else "") if short
                    else m.group(1))
            spill = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def next_tick_args(rk, name, solver, params, cost_params, costmap, out):
    """The arguments (args, kwargs) with which one more tick after a drive
    (``out``: ``drive_oval.drive``'s result) calls ``rk.<name>``: the
    inputs that the closed loop sends that function, taken with it wrapped
    (``tools/ab_builds.last_call``) outside the drive's timed ticks."""
    from autorally_tpu_torch.tools.ab_builds import last_call

    with last_call(rk, name) as got:
        cs = solver.slide(out["control_state"],
                          solver.cfg.optimization_stride)
        solver.solve(params, cost_params, costmap, out["state"], cs)
    return got["args"]


def random_costmap(device):
    """A 10 m x 10 m map beside the start, 2 cm texels, channel 0 uniform
    in [0, 0.66) from seed 0, cleared within 0.7 m of y = 0 so that the
    rollouts' first, shared, steps do not all cross the 0.65 boundary."""
    from autorally_tpu_torch.costs import make_costmap

    n, ppm = 500, 50.0
    data = np.zeros((n, n, 4), np.float32)
    data[..., 0] = np.random.default_rng(0).uniform(0, 0.66, (n, n))
    ys = -5.0 + (np.arange(n) + 0.5) / ppm
    data[np.abs(ys) < 0.7, :, 0] = 0.0
    return make_costmap(data, (25.0, 35.0), (-5.0, 5.0), device=device)


def profile_ticks(drive_oval, solver, params, cost_params, costmap, card,
                  ticks: int = PROFILE_TICKS, tag: str = "profile") -> None:
    """Device time by kernel over ``ticks`` ticks of ``solver``'s path
    (torch.profiler, CUPTI) and the device's busy share of their wall
    time, profiler overhead included; lines start with ``[tag]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive_oval.drive(solver, params, cost_params, costmap, ticks,
                         log=lambda m: None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                 # host ops: their kernels are rows too
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        print(f"[{tag}] device time not measured: the profiler recorded "
              f"no device events ({card})")
        return
    busy = sum(r[0] for r in rows)
    print(f"[{tag}] {ticks} ticks (+1 first solve): wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%) ({card})")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        print(f"[{tag}]   {ms / (ticks + 1):8.4f} ms/tick  x{n:<5d} "
              f"{key[:90]}")


def capacity_phases(drive_oval, solver, params, cost_params, costmap, cases,
                    U, start, cpu, card):
    """Phases 7-10: the kernel-RNG capacity mode at K=262144.  Returns the
    two passes' ``kernels`` entries and the capacity solves' latencies."""
    import torch
    from autorally_tpu_torch.config import effective_gamma
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools import sass_chain
    from autorally_tpu_torch.tools.ab_builds import zero_warp_share

    cfg, model = solver.cfg, solver.model
    dev = U.device
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    cap_cfg = {s: cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
               for s, kw in SAMPLERS.items()}

    # -- phase 7: pass 1 against its plain version ---------------------------
    # The in-kernel stream is the plain stream bit for bit, so pass 1 must
    # equal kernel A fed the plain stream (the same step body); against the
    # whole plain version it differs by the MLP's summation order, and on
    # the random map it is held, as kernel A is, against the plain cost
    # along kernel B's trajectories on that stream.
    err_p1, nominal = 0.0, {}
    for sname, ccfg0 in cap_cfg.items():
        for name, (ccfg, s0, cmap) in cases.items():
            c = ccfg0.replace(steering_std=ccfg.steering_std,
                              throttle_std=ccfg.throttle_std)
            kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params,
                                             cmap, s0, U, key)
            pc, px, _ = rk.fused_rng_costs_plain(model, params, c,
                                                 cost_params, cmap, s0, U,
                                                 key)
            eps = rk.rng_noise(ctx)
            ac, _, ax = rk.fused_exact_rollout_cost(model, params, c,
                                                    cost_params, cmap, s0, U,
                                                    eps)
            torch.cuda.synchronize()
            same_as_a = torch.equal(kc, ac) and torch.equal(kx, ax)
            near = torch.isclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL)
            n_differ = int((~near | (kx != px)).sum().item())
            note = ""
            if name == "random_map":
                check(n_differ <= KC // 100, f"pass 1 {sname} random_map: "
                      f"{n_differ} rollouts differ from the plain version, "
                      f"more than {KC // 100}")
                kb, _ = rk.dynamics_chain(model, params, c, s0, U, eps)
                pc, px = rk.trajectory_cost_plain(model, params, c,
                                                  cost_params, cmap, U, eps,
                                                  kb)
                del kb
                check(0 < px.sum().item() < KC, f"pass 1 {sname} random_map:"
                      " crash flags do not differ between rollouts")
                note = (" (held against the plain cost along kernel B's "
                        "trajectories)")
            e_cost = (kc - pc).abs().max().item()
            n_crash_diff = int((kx != px).sum().item())
            print(f"[pass 1] {sname} {name} K={KC}: max|cost err| "
                  f"{e_cost:.3e}{note} (cost range {pc.min().item():.4g}.."
                  f"{pc.max().item():.4g}), crash {int(px.sum().item())}/"
                  f"{KC}, crash mismatches {n_crash_diff}, {n_differ} "
                  f"rollouts differ from the whole plain version; equal to "
                  f"kernel A on the plain stream: {same_as_a}")
            check(torch.isfinite(kc).all().item(),
                  f"pass 1 {sname} {name}: non-finite costs")
            check(torch.allclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL),
                  f"pass 1 {sname} {name}: costs differ beyond rtol "
                  f"{COST_RTOL} atol {COST_ATOL}")
            check(n_crash_diff == 0, f"pass 1 {sname} {name}: crash flags "
                  "differ")
            check(same_as_a, f"pass 1 {sname} {name}: differs from kernel A "
                  "on the plain stream (the in-kernel stream is not the "
                  "plain one)")
            err_p1 = max(err_p1, e_cost)
            if name == "nominal":
                nominal[sname] = (c, ctx, kc)
            del eps, ac, pc
    # a K that is a multiple of neither a block nor a warp, and a shard's
    # slice of the global batch (k_offset != 0): bit for bit kernel A on the
    # slice's plain stream
    for name, case, k_off, k_loc in (("ragged_K", "nominal", 0, KC - 1),
                                     ("shard", "random_map", *SHARD)):
        ccfg, s0, cmap = cases[case]
        c = cap_cfg["ou"].replace(steering_std=ccfg.steering_std,
                                  throttle_std=ccfg.throttle_std)
        kw = dict(k_offset=k_off, K_local=k_loc)
        kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params, cmap,
                                         s0, U, key, **kw)
        pc, px, _ = rk.fused_rng_costs_plain(model, params, c, cost_params,
                                             cmap, s0, U, key, **kw)
        eps = rk.rng_noise(ctx)
        ac, _, ax = rk.fused_exact_rollout_cost(model, params, c, cost_params,
                                                cmap, s0, U, eps,
                                                k_offset=k_off)
        kb, _ = rk.dynamics_chain(model, params, c, s0, U, eps,
                                  k_offset=k_off)
        bc, bx = rk.trajectory_cost_plain(model, params, c, cost_params, cmap,
                                          U, eps, kb, k_offset=k_off)
        del kb, eps
        torch.cuda.synchronize()
        same_as_a = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[pass 1] ou {name} K={k_loc} k_offset={k_off}: equal to "
              f"kernel A on the plain stream: {same_as_a}")
        check(same_as_a, f"pass 1 {name}: differs from kernel A on the plain "
              "stream")
        err_p1 = max(err_p1, agreement(
            f"pass 1 ou K={k_loc} k_offset={k_off} along kernel B", name, kc,
            kx, bc, bx, k_loc, limit=0))
        agreement(f"pass 1 ou K={k_loc} k_offset={k_off}", name, kc, kx, pc,
                  px, k_loc, limit=0 if name == "ragged_K" else None)
        del kc, pc, ac, bc
    # two models with different weights, their launches alternating on one
    # stream with no synchronisation between them (as an ensemble's members
    # run): each bit for bit kernel A fed the plain stream with its own
    # weights, and held against its own plain cost along kernel B's
    # trajectories (every rollout) and its whole plain version (the second
    # model's seeded weights drive some rollouts off the track, where the
    # summation order moves a cost: 1 %, as in the other non-nominal cases)
    other, _, _, _, _ = drive_oval.build(rollouts=K, device=dev)
    oparams = other.model.init_params(1)
    ccfg = cap_cfg["gaussian"]
    runs = []
    for mdl, prm in ((model, params), (other.model, oparams)):
        launch, (kc, kx), ctx = rk.prepare_fused_rng_costs(
            mdl, prm, ccfg, cost_params, costmap, start, U, key)
        runs.append((mdl, prm, launch, kc, kx, ctx))
    for _ in range(3):
        for run in runs:
            run[2]()
    torch.cuda.synchronize()
    for i, (mdl, prm, _, kc, kx, ctx) in enumerate(runs):
        name = "nominal" if i == 0 else "other_weights"
        eps = rk.rng_noise(ctx)
        ac, _, ax = rk.fused_exact_rollout_cost(mdl, prm, ccfg, cost_params,
                                                costmap, start, U, eps)
        kb, _ = rk.dynamics_chain(mdl, prm, ccfg, start, U, eps)
        bc, bx = rk.trajectory_cost_plain(mdl, prm, ccfg, cost_params,
                                          costmap, U, eps, kb)
        del kb, eps
        pc, px, _ = rk.fused_rng_costs_plain(mdl, prm, ccfg, cost_params,
                                             costmap, start, U, key)
        torch.cuda.synchronize()
        same_as_a = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[pass 1] two models alternating on one stream, model {i} "
              f"(weights seed {i}): equal to kernel A on the plain stream "
              f"with its own weights: {same_as_a}")
        check(same_as_a, f"pass 1 two models: model {i} differs from kernel "
              "A with its own weights")
        err_p1 = max(err_p1, agreement(
            f"pass 1 two models, model {i} along kernel B", name, kc, kx, bc,
            bx, KC, limit=0))
        agreement(f"pass 1 two models, model {i}", name, kc, kx, pc, px, KC)
        del ac, bc, pc
    check(not torch.equal(runs[0][3], runs[1][3]), "pass 1 two models: the "
          "two models' costs are equal")
    del runs

    # -- phase 8: pass 2 against its plain version ---------------------------
    def abs_controls(c, ctx):
        """|u| (C, T, K) of ``ctx``'s rollouts: kernel A's u_seq on the
        plain stream (the controls do not depend on the state)."""
        _, u_seq, _ = rk.fused_exact_rollout_cost(
            model, params, c, cost_params, costmap, start, ctx.U,
            rk.rng_noise(ctx), k_offset=ctx.k_offset)
        return u_seq.abs_()

    def hold_numer(tag, ctx, w, u_abs):
        """Pass 2 on weights ``w`` against its plain version, within
        NUMER_RTOL of sum_k |w_k u_k|; prints the share of warps whose
        32 weights are all 0.  Returns the max abs error."""
        kn = rk.fused_rng_numer(ctx, w)
        pn = rk.fused_rng_numer_plain(ctx, w)
        scale = torch.einsum("k,ctk->ct", w.abs(), u_abs)
        torch.cuda.synchronize()
        err = (kn - pn).abs()
        rel = (err / scale.clamp(min=1e-30)).max().item()
        print(f"[pass 2] {tag} K={ctx.K}: max|numer err| "
              f"{err.max().item():.3e}, max err / sum|w u| {rel:.3e} (limit "
              f"{NUMER_RTOL}), ess {(w.sum() ** 2 / (w * w).sum()).item():.1f}"
              f", {int((w != 0).sum().item())} non-zero weights, "
              f"{100 * zero_warp_share(w):.2f} % all-zero warps")
        check(bool((err <= NUMER_RTOL * scale).all()), f"pass 2 {tag}: "
              f"numerator differs beyond {NUMER_RTOL} of sum|w u|")
        return err.max().item()

    err_p2 = 0.0
    first_pure = int(np.ceil(np.float32(cfg.pure_noise_frac * KC)))
    for sname, (c, ctx, kc) in nominal.items():
        w = torch.exp(-effective_gamma(c, cost_params) * (kc - kc.min()))
        u_abs = abs_controls(c, ctx)
        # the nominal weights; three warps of every four zeroed (sparse);
        # all 1 (dense)
        sparse = torch.where(torch.arange(KC, device=dev) // 32 % 4 == 0, w,
                             torch.zeros_like(w))
        for wname, wv in (("nominal", w), ("sparse", sparse),
                          ("dense", torch.ones_like(w))):
            err_p2 = max(err_p2, hold_numer(f"{sname} {wname}", ctx, wv,
                                            u_abs))
        del u_abs
        # a NaN in U: NaN exactly where the plain version has it, and every
        # other partial bit for bit the run's without the NaN
        U_nan = ctx.U.clone()
        U_nan[T // 2, 1] = float("nan")
        ctx_nan = ctx._replace(U=U_nan)
        kn, ks = rk.fused_rng_numer(ctx_nan, sparse), rk.fused_rng_numer(
            ctx, sparse)
        launch, part_nan = rk.prepare_fused_rng_numer(ctx_nan, sparse)
        launch()
        launch, part = rk.prepare_fused_rng_numer(ctx, sparse)
        launch()
        pn = rk.fused_rng_numer_plain(ctx_nan, sparse)
        torch.cuda.synchronize()
        keep = torch.ones_like(part, dtype=torch.bool)
        keep[:, 1, T // 2] = False
        same_nan = torch.equal(torch.isnan(kn), torch.isnan(pn))
        same_bits = bit_equal(part_nan[keep], part[keep])
        print(f"[pass 2] {sname} NaN in U[{T // 2}, 1], sparse weights: NaN "
              f"in {int(torch.isnan(kn).sum().item())} numerator entries, "
              f"where the plain version has them: {same_nan}; the other "
              f"partials bit equal to the run's without the NaN: "
              f"{same_bits}")
        check(same_nan and bool(torch.isnan(kn[1, T // 2])),
              f"pass 2 {sname} NaN in U: NaN pattern differs")
        check(torch.equal(kn[~torch.isnan(kn)], ks[~torch.isnan(kn)]),
              f"pass 2 {sname} NaN in U: other entries differ")
        check(same_bits, f"pass 2 {sname} NaN in U: other partials differ")
        del kn, ks, pn, part, part_nan
        for k in (0, 1, first_pure, KC - 1):
            onehot = torch.zeros(KC, device=dev)
            onehot[k] = 1.0
            got = rk.fused_rng_numer(ctx, onehot)
            want = rk.fused_rng_numer_plain(ctx, onehot)   # U + nu eps, masked
            e = (got - want).abs().max().item()
            print(f"[pass 2] {sname} one-hot k={k}: max|u err| {e:.3e}")
            check(e <= ONEHOT_ATOL, f"pass 2 {sname} one-hot k={k}: {e}")

    # -- phase 9: the capacity path ------------------------------------------
    cpu_solver, cpu_params, _, cpu_map = cpu
    ci = cap_cfg["gaussian"].replace(num_rollouts=K_ITER_CHECK)
    Ug, _, _ = rk.fused_rng_solve_iteration(model, params, ci, cost_params,
                                            costmap, start, U, key)
    Uc, _, _ = rk.fused_rng_solve_iteration(cpu_solver.model, cpu_params, ci,
                                            cost_params, cpu_map, start.cpu(),
                                            U.cpu(), key.cpu())
    e_it = (Ug.cpu() - Uc).abs().max().item()
    print(f"[capacity] one iteration K={K_ITER_CHECK} GPU vs CPU: max|U_new "
          f"err| {e_it:.3e}")
    check(e_it <= ITER_ATOL, f"capacity iterate: GPU and CPU differ by {e_it}")

    want = {"fused_rng_costs": 1, "fused_rng_numer": 1, "dynamics_chain": 1}
    cap_solvers, latency, run_launches = {}, {}, {}
    # each drive's pass-2 inputs (ctx, weights) of one more, untimed tick
    closed_loop = {}
    for sname, c in cap_cfg.items():
        cap = MPPISolver(model, solver.cost, c, device=dev)
        check(cap._use_kernel_rng(costmap), f"{sname}: not in capacity mode")
        cap_solvers[sname] = cap
        rk.LAUNCHES.clear()
        out = drive_oval.drive(cap, params, cost_params, costmap, CAP_TICKS,
                               log=lambda m: print(f"[capacity] {m}"))
        launches = dict(rk.LAUNCHES)
        st, stats = out["solve_ms"], out["stats"]
        latency[sname] = (float(np.percentile(st, 50)),
                          float(np.percentile(st, 99)))
        print(f"[capacity] {sname} K={KC} {CAP_TICKS} ticks: solve latency "
              f"p50 {latency[sname][0]:.3f} ms p99 {latency[sname][1]:.3f} "
              f"ms (slide + solve + control readback, host clock; {card}); "
              f"ess {stats.ess.item():.1f}, crash% "
              f"{stats.crash_frac.item() * 100:.1f}; launches {launches}")
        check(np.isfinite(out["controls"]).all(), f"{sname}: non-finite "
              "controls")
        solves = CAP_TICKS + 1
        check(launches == {n: v * solves for n, v in want.items()},
              f"{sname}: launches {launches} in {solves} solves, expected "
              f"{want} per solve (and nothing else)")
        run_launches[sname] = launches
        closed_loop[sname] = next_tick_args(rk, "fused_rng_numer", cap,
                                            params, cost_params, costmap,
                                            out)[0]
        err_p2 = max(err_p2, hold_numer(
            f"{sname} closed loop, tick {CAP_TICKS + 1}",
            *closed_loop[sname], abs_controls(c, closed_loop[sname][0])))

    # -- phase 10: timing ----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    T_ = U.shape[0]
    times = {}
    mix = stream_mix(SASS[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_mhz()
    for name, m in mix.items():
        print(f"[timing] {name}: a step of its stream loop "
              f"{m['instructions']:.1f} instructions, {m['int']:.1f} of them "
              f"integer; {m['instructions_always']:.1f} and "
              f"{m['int_always']:.1f} outside forward branches ({m['steps']} "
              f"steps a pass of the loop); a step's "
              + ", ".join(f"{op} {n:.1f}" for op, n in m["ops"].items())
              + " (SASS of the built library)")
    for sname, c in cap_cfg.items():
        ou = OU_OPS if sname == "ou" else 0
        launch1, (kc, _), ctx = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, costmap, start, U, key)
        ms1 = cuda_ms(launch1, 20)
        geometry_line(rk, f"timing pass 1 {sname}", launch1, True, False,
                      card)
        plain1 = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, c, cost_params, costmap, start, U, key), PLAIN_REPS, 0)
        # inputs read once (U, weights, state, control ranges, key, at most
        # the whole map or one texel per lookup), costs and crash written
        bytes1 = (4 * (T_ * 2 + n_w + 7 + 4 + 2 * KC)
                  + 4 * min(costmap.height * costmap.width, 2 * KC * (T_ - 1))
                  + 16)
        bound1 = bound(bytes1, (flops_step + STREAM_OPS + ou) * KC * T_)
        floors1 = sass_chain.pipe_bounds(mix["pass1_mlp"], KC, T_, sms,
                                         clock)
        w = torch.exp(-effective_gamma(c, cost_params) * (kc - kc.min()))
        plain2 = cuda_ms(lambda: rk.fused_rng_numer_plain(ctx, w), PLAIN_REPS, 0)
        # pass 2 on the nominal weights (phase 8's), the closed loop's tick
        # (phase 9's) and dense ones; its bound counts the rollouts whose
        # weight is not 0, the work that these weights need; the design's
        # floors, all K rollouts, which it replays whatever the weights
        # (its loop's one forward branch over the stream is the test of
        # rollouts past K, which every rollout here takes)
        p2 = {}
        floors2 = sass_chain.pipe_bounds(mix["pass2"], KC, T_, sms, clock,
                                         branched=True)
        for wname, (cx, wv) in (("nominal", (ctx, w)),
                                ("closed_loop", closed_loop[sname]),
                                ("dense", (ctx, torch.ones_like(w)))):
            launch2, partials = rk.prepare_fused_rng_numer(cx, wv)
            ms2 = cuda_ms(launch2, 50)
            k_need = int((wv != 0).sum().item())
            bytes2 = 4 * (KC + T_ * 2 + partials.numel()) + 16
            p2[wname] = (ms2, bound(bytes2, (STREAM_OPS + ou + UPDATE_OPS)
                                    * k_need * T_))
            print(f"[timing] pass 2 fused_rng_numer {sname} {wname} K={KC} "
                  f"T={T_}: {ms2:.4f} ms; {k_need} non-zero weights, "
                  f"{100 * zero_warp_share(wv):.2f} % all-zero warps; bound "
                  f"{p2[wname][1][0]:.5f} ms ({p2[wname][1][1]}) ({card})")
        times[sname] = (ms1, plain1, bound1, plain2, p2)
        print(f"[timing] pass 1 fused_rng_costs {sname} K={KC} T={T_}: "
              f"{ms1:.4f} ms, plain {plain1:.3f} ms, bound {bound1[0]:.5f} "
              f"ms ({bound1[1]}); its SASS's floors: integer pipe "
              f"{floors1['int_ms']:.5f} ms, issue {floors1['issue_ms']:.5f} "
              f"ms ({sms} SMs at {clock:.0f} MHz) ({card})")
        print(f"[timing] pass 2 fused_rng_numer {sname}: plain {plain2:.3f} "
              f"ms; its SASS's floors at K={KC}: integer pipe "
              f"{floors2['int_ms']:.5f} ms, issue {floors2['issue_ms']:.5f} "
              f"ms ({sms} SMs at {clock:.0f} MHz) ({card})")

    # BF exact pass 1 (fused_rng_bf_kernel) at the same K: its floors from
    # the instructions outside forward branches and from the whole loop
    # body (the draws a step ahead and the rare IEEE step sit behind
    # forward branches)
    bsolver, bparams, _, _, _ = drive_oval.build(model="bf", rollouts=KB,
                                                 device=dev)
    n_bf = rk.KERNEL_BF_WEIGHTS
    floors_bf = {b: sass_chain.pipe_bounds(mix["pass1_bf"], KC, T_, sms,
                                           clock, branched=b)
                 for b in (False, True)}
    for sname, kw in SAMPLERS.items():
        c = bsolver.cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
        launch_bf, _, _ = rk.prepare_fused_rng_costs(
            bsolver.model, bparams, c, cost_params, costmap, start, U, key)
        ms_bf = cuda_ms(launch_bf, 20)
        geometry_line(rk, f"timing BF pass 1 {sname}", launch_bf, True, True,
                      card)
        bytes_bf = (4 * (T_ * 2 + n_bf + 7 + 4 + 2 * KC)
                    + 4 * min(costmap.height * costmap.width,
                              2 * KC * (T_ - 1)) + 16)
        bound_bf = bound(bytes_bf, (BF_STEP_OPS + STREAM_OPS
                                    + (OU_OPS if sname == "ou" else 0))
                         * KC * T_)
        print(f"[timing] BF pass 1 fused_rng_costs_bf {sname} K={KC} "
              f"T={T_}: {ms_bf:.4f} ms, bound {bound_bf[0]:.5f} ms "
              f"({bound_bf[1]}); its SASS's floors outside forward "
              f"branches: integer pipe {floors_bf[False]['int_ms']:.5f} ms, "
              f"issue {floors_bf[False]['issue_ms']:.5f} ms; over the whole "
              f"loop body: integer pipe {floors_bf[True]['int_ms']:.5f} ms, "
              f"issue {floors_bf[True]['issue_ms']:.5f} ms ({sms} SMs at "
              f"{clock:.0f} MHz) ({card})")
        del launch_bf

    # kernel A at the same K on the plain stream: pass 1 less the generator
    # (and plus the eps reads and u_seq writes)
    eps = rk.rng_noise(ctx)
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cap_cfg["ou"], cost_params, costmap, start, U, eps)
    print(f"[timing] kernel A fused_exact_rollout_cost K={KC} T={T_}: "
          f"{cuda_ms(launch_a, 20):.4f} ms ({card})")
    geometry_line(rk, f"timing kernel A K={KC}", launch_a, False, False, card)
    del eps, launch_a

    host = MPPISolver(model, solver.cost, cfg.replace(num_rollouts=KC),
                      device=dev)
    for label, s in (("capacity gaussian", cap_solvers["gaussian"]),
                     ("capacity ou", cap_solvers["ou"]),
                     ("host-noise gaussian", host)):
        cs = s.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = cuda_ms(lambda: s.solve(params, cost_params, costmap, start, cs),
                     10)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        print(f"[timing] whole solve, {label}, K={KC} T={T_}: {ms:.4f} ms "
              f"(CUDA events), peak device memory {peak:.1f} MiB above the "
              f"inputs ({card})")

    profile_ticks(drive_oval, cap_solvers["gaussian"], params, cost_params,
                  costmap, card, ticks=CAP_PROFILE_TICKS,
                  tag="capacity profile")

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    ms1, plain1, bound1, plain2, p2 = times["gaussian"]
    ms2, bound2 = p2["nominal"]
    kernels = [
        {"name": "fused_rng_costs", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1221",
         "launches": run_launches["gaussian"]["fused_rng_costs"],
         "max_abs_err": err_p1, "ms": ms1, "plain_ms": plain1,
         "bound_ms": bound1[0], "bound_by": bound1[1], "library_ms": None},
        {"name": "fused_rng_numer", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1346",
         "launches": run_launches["gaussian"]["fused_rng_numer"],
         "max_abs_err": err_p2, "ms": ms2, "plain_ms": plain2,
         "bound_ms": bound2[0], "bound_by": bound2[1], "library_ms": None,
         "weights_ms": {wname: r[0] for wname, r in p2.items()}},
    ]
    return kernels, latency


def random_field(field, model, params, cfg, start, U, seed: int = 1):
    """A field of the fitted field's spec and transform with seeded
    He-normal weights, its output rescaled to a standard deviation of 0.25
    over the map and shifted so that the 0.65 crash boundary lies at the
    median of the highest value that each of 2048 rollouts from ``start``
    under ``cfg`` meets (plain chain and plain lookups, on noise of their
    own): about half of the checked rollouts crash, at different steps."""
    import torch
    from autorally_tpu_torch.costs import NeuralCostmap
    from autorally_tpu_torch.ops import rollout_kernel as rk

    dev = field.device
    rs = np.random.default_rng(seed)
    layers = field.layers
    W = [np.sqrt(2.0 / a) * rs.standard_normal((a, b))
         for a, b in zip(layers[:-1], layers[1:])]
    B = [0.1 * rs.standard_normal(b) for b in layers[1:]]
    build = lambda: NeuralCostmap.build(W, B, field.freqs.cpu(),
                                        field.r_c1.cpu(), field.r_c2.cpu(),
                                        field.trs.cpu(), device=dev)
    g = torch.linspace(0, 1, 201, device=dev)
    uu, vv = torch.meshgrid(g, g, indexing="xy")
    sd = build().forward_norm(uu.reshape(-1), vv.reshape(-1)).std().item()
    W[-1], B[-1] = W[-1] * (0.25 / sd), B[-1] * (0.25 / sd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    eps = torch.randn((U.shape[0], 2048, 2), generator=gen, device=dev)
    states, _ = rk.dynamics_chain_plain(model, params, cfg, start, U, eps)
    x, y, yaw = states[0, :-1], states[1, :-1], states[2, :-1]   # s_1..s_T-1
    hx, hy = 0.5 * torch.cos(yaw), 0.5 * torch.sin(yaw)
    f = build()
    peak = torch.maximum(f.lookup_ch0(x + hx, y + hy),
                         f.lookup_ch0(x - hx, y - hy)).amax(dim=0)
    B[-1] = B[-1] + (0.65 - torch.median(peak).item())
    return build()


class PlainCalls:
    """Counts calls of the plain versions while active (each wrapper looks
    its plain version up in the module at call time), to show that a run
    on the card never took one."""

    NAMES = ("fused_rollout_cost_plain", "trajectory_cost_plain",
             "dynamics_chain_plain", "fused_rng_costs_plain",
             "fused_rng_numer_plain", "fused_rollout_cost_lanes_plain",
             "dynamics_chain_lanes_plain", "fused_rng_costs_lanes_plain",
             "fused_rng_numer_lanes_plain")

    def __init__(self, rk):
        self.rk, self.calls = rk, dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.rk, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def counted(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(self.rk, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.rk, n, fn)


def field_phases(drive_oval, model, params, cost_params, costmap, U, start,
                 edge_start, nan_start, slow_start, card):
    """Phases 11-14: the neural-field costmap path, kernel 3 at K=65536 and
    pass 1's field mode at K=262144.  Returns the two kernels' ``kernels``
    entries, the field solves' latencies and the fitted field."""
    import torch
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver

    dev = U.device
    T_ = U.shape[0]
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)

    # -- the field, fitted on the card through the entry point ---------------
    (host, _, _, field, note), fit_s = fitted_field(drive_oval, dev)
    print(f"[field] drive_oval.build(neural_costmap=True) with "
          f"fit_neural_costmap's defaults (4000 Adam steps, batch 16384): "
          f"{fit_s:.3f} s ({card}; fitted while the default library "
          f"built); {note.splitlines()[-1]}; layers {field.layers}")
    check(field.layers == rk.FIELD_KERNEL_LAYERS, f"field layers "
          f"{field.layers}, kernels compiled for {rk.FIELD_KERNEL_LAYERS}")
    # the same seeded weights as the main path (both built from seed 0)
    for w, hw in zip(params["weights"], host.model.params()["weights"]):
        check(torch.equal(w, hw), "the field solver's weights differ")
    cfg = host.cfg
    wide = cfg.replace(steering_std=4 * cfg.steering_std,
                       throttle_std=4 * cfg.throttle_std)
    cases = {
        "nominal": (cfg, start, field),
        "wide_swarm": (wide, edge_start, field),
        "nan_x": (cfg, nan_start, field),
        "random_field": (wide, slow_start, random_field(
            field, model, params, wide, slow_start, U)),
    }

    # -- phase 11: kernel 3 against its plain version ------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    eps = torch.randn((T_, KF, 2), generator=gen, device=dev)
    err_3 = 0.0
    for name, (ccfg, s0, f) in cases.items():
        kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params,
                                           f, s0, U, eps)
        pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                                 cost_params, f, s0, U, eps)
        torch.cuda.synchronize()
        err_3 = max(err_3, agreement(f"kernel 3 K={KF}", name, kc, kx, pc,
                                     px, KF))
        check(torch.equal(ku, pu), f"kernel 3 {name}: u_seq differs")
        del kc, ku, pc, pu
    # a K that is a multiple of neither the block nor the warp: the last
    # warp's idle lanes run dummy rollouts and store nothing
    k_r = KF - 19
    ccfg, s0, f = cases["nominal"]
    e_r = eps[:, :k_r].contiguous()
    kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params, f,
                                       s0, U, e_r)
    pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                             cost_params, f, s0, U, e_r)
    torch.cuda.synchronize()
    err_3 = max(err_3, agreement(f"kernel 3 K={k_r}", "ragged_K", kc, kx, pc,
                                 px, k_r, limit=0))
    check(torch.equal(ku, pu), "kernel 3 ragged_K: u_seq differs")
    del eps, e_r, kc, ku, pc, pu

    # -- phase 12: pass 1 in field mode against its plain version ------------
    # and bit for bit against kernel 3 fed the plain stream (the same step
    # body and the same stream)
    err_p1 = 0.0
    for sname, kw in SAMPLERS.items():
        for name, (ccfg, s0, f) in cases.items():
            c = ccfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
            kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params,
                                             f, s0, U, key)
            pc, px, _ = rk.fused_rng_costs_plain(model, params, c,
                                                 cost_params, f, s0, U, key)
            ac, _, ax = rk.fused_rollout_cost(model, params, c, cost_params,
                                              f, s0, U, rk.rng_noise(ctx))
            torch.cuda.synchronize()
            same_as_3 = torch.equal(kc, ac) and torch.equal(kx, ax)
            err_p1 = max(err_p1, agreement(
                f"pass 1 field {sname} K={KC}", name, kc, kx, pc, px, KC))
            print(f"[pass 1 field] {sname} {name}: equal to kernel 3 on the "
                  f"plain stream: {same_as_3}")
            check(same_as_3, f"pass 1 field {sname} {name}: differs from "
                  "kernel 3 on the plain stream")
            del kc, pc, ac
    # a K that is not a multiple of 32, and a shard's slice of the global
    # batch (k_offset != 0): bit for bit kernel 3 on the slice's plain stream
    for name, case, k_off, k_loc in (
            ("ragged_K", "nominal", 0, KC - 13),
            ("shard", "random_field", *SHARD)):
        ccfg, s0, f = cases[case]
        c = ccfg.replace(num_rollouts=KC, kernel_rng=True)
        kw = dict(k_offset=k_off, K_local=k_loc)
        kc, kx, ctx = rk.fused_rng_costs(model, params, c, cost_params, f, s0,
                                         U, key, **kw)
        pc, px, _ = rk.fused_rng_costs_plain(model, params, c, cost_params,
                                             f, s0, U, key, **kw)
        ac, _, ax = rk.fused_rollout_cost(model, params, c, cost_params, f,
                                          s0, U, rk.rng_noise(ctx),
                                          k_offset=k_off)
        torch.cuda.synchronize()
        same_as_3 = torch.equal(kc, ac) and torch.equal(kx, ax)
        err_p1 = max(err_p1, agreement(
            f"pass 1 field K={k_loc} k_offset={k_off}", name, kc, kx, pc, px,
            k_loc, limit=0 if name == "ragged_K" else None))
        print(f"[pass 1 field] {name} K={k_loc} k_offset={k_off}: equal to "
              f"kernel 3 on the plain stream: {same_as_3}")
        check(same_as_3, f"pass 1 field {name}: differs from kernel 3 on "
              "the plain stream")
        del kc, pc, ac

    # -- phase 13: the field path closed-loop --------------------------------
    cap = MPPISolver(host.model, host.cost, cfg.replace(
        num_rollouts=KC, kernel_rng=True), device=dev)
    check(not host._use_kernel_rng(field) and cap._use_kernel_rng(field),
          "field solvers: wrong mode")
    runs = {"host-noise": (host, FIELD_TICKS, {
                "fused_rollout_cost": 1, "dynamics_chain": 1}),
            "capacity": (cap, FIELD_CAP_TICKS, {
                "fused_rng_costs_field": 1, "fused_rng_numer": 1,
                "dynamics_chain": 1})}
    latency, launches = {}, {}
    for label, (s, ticks, per_solve) in runs.items():
        latency[label], launches[label], _ = drive_counted(
            drive_oval, rk, f"field path {label}", s, params, cost_params,
            field, ticks, per_solve, card)

    # -- phase 14: timing ----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    field_ops = field_eval_ops(field.layers, field.freqs.numel())
    n_f = rk.FIELD_NUM_WEIGHTS
    eps = torch.randn((T_, KF, 2), generator=gen, device=dev)
    launch_3, _ = rk.prepare_fused_rollout_cost(model, params, cfg,
                                                cost_params, field, start, U,
                                                eps)
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cfg, cost_params, costmap, start, U, eps)
    ms_3 = cuda_ms(launch_3, 10)
    ms_a = cuda_ms(launch_a, 10)
    plain_3 = cuda_ms(lambda: rk.fused_rollout_cost_plain(
        model, params, cfg, cost_params, field, start, U, eps), PLAIN_REPS, 0)
    # eps read, u_seq, costs and crash written, the weights, the field,
    # U, the state and the control ranges read once
    bytes_3 = 4 * (3 * T_ * KF * 2 + 2 * KF + T_ * 2 + n_w + n_f + 7 + 4)
    ops_3 = KF * (T_ * flops_step + (T_ - 1) * 2 * field_ops)
    bound_3, tc_3 = field_bounds(bytes_3, KF * T_ * flops_step,
                                 KF * (T_ - 1) * 2, field)
    print(f"[timing] kernel 3 fused_rollout_cost K={KF} T={T_}: "
          f"{ms_3:.4f} ms, plain {plain_3:.3f} ms, tensor-core bound "
          f"{tc_3[0]:.4f} ms ({tc_3[1]}), fp32 bound {bound_3[0]:.4f} ms "
          f"({bound_3[1]}; {ops_3 / 1e9:.1f} GFLOP, {bytes_3 / 1e6:.1f} MB); "
          f"kernel A on the exact map at the same K: {ms_a:.4f} ms, field / "
          f"exact {ms_3 / ms_a:.2f}x ({card})")
    del eps, launch_3, launch_a

    times = {}
    for sname, kw in SAMPLERS.items():
        c = cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
        ou = OU_OPS if sname == "ou" else 0
        launch_f, _, _ = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, field, start, U, key)
        launch_e, _, _ = rk.prepare_fused_rng_costs(
            model, params, c, cost_params, costmap, start, U, key)
        check((launch_f.mode, launch_e.mode) == ("field", "exact"),
              "pass 1 modes")
        ms_f = cuda_ms(launch_f, 5)
        ms_e = cuda_ms(launch_e, 5)
        plain_f = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, c, cost_params, field, start, U, key), PLAIN_REPS, 0)
        bytes_f = 4 * (2 * KC + T_ * 2 + n_w + n_f + 7 + 4) + 16
        ops_f = KC * (T_ * (flops_step + STREAM_OPS + ou)
                      + (T_ - 1) * 2 * field_ops)
        bound_f, tc_f = field_bounds(
            bytes_f, KC * T_ * (flops_step + STREAM_OPS + ou),
            KC * (T_ - 1) * 2, field)
        times[sname] = (ms_f, plain_f, bound_f, tc_f)
        print(f"[timing] pass 1 field fused_rng_costs {sname} K={KC} "
              f"T={T_}: {ms_f:.4f} ms, plain {plain_f:.3f} ms, tensor-core "
              f"bound {tc_f[0]:.4f} ms ({tc_f[1]}), fp32 bound "
              f"{bound_f[0]:.4f} ms ({bound_f[1]}; {ops_f / 1e9:.1f} GOP, "
              f"{bytes_f / 1e6:.2f} MB); pass 1 on the exact map at the same "
              f"K: {ms_e:.4f} ms, field / exact {ms_f / ms_e:.2f}x ({card})")
    for label, s in (("host-noise K=%d" % KF, host), ("capacity K=%d" % KC,
                                                      cap)):
        cs = s.init_state()
        ms = cuda_ms(lambda: s.solve(params, cost_params, field, start, cs),
                     5, 1)
        print(f"[timing] whole field solve, {label} T={T_}: {ms:.4f} ms "
              f"(CUDA events; {card})")
    profile_ticks(drive_oval, host, params, cost_params, field, card,
                  ticks=FIELD_PROFILE_TICKS, tag="field profile")
    profile_ticks(drive_oval, cap, params, cost_params, field, card,
                  ticks=FIELD_PROFILE_TICKS, tag="field capacity profile")

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    ms_f, plain_f, bound_f, tc_f = times["gaussian"]
    kernels = [
        {"name": "fused_rollout_cost", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:606",
         "launches": launches["host-noise"]["fused_rollout_cost"],
         "max_abs_err": err_3, "ms": ms_3, "plain_ms": plain_3,
         "bound_ms": tc_3[0], "bound_by": tc_3[1],
         "fp32_bound_ms": bound_3[0], "library_ms": None},
        {"name": "fused_rng_costs_field", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1221",
         "launches": launches["capacity"]["fused_rng_costs_field"],
         "max_abs_err": err_p1, "ms": ms_f, "plain_ms": plain_f,
         "bound_ms": tc_f[0], "bound_by": tc_f[1],
         "fp32_bound_ms": bound_f[0], "library_ms": None},
    ]
    return kernels, latency, field


def obstacle_circles(model, params, cfg, start, U, radius: float = 0.5,
                     seed: int = 2):
    """Two active circles on the lane of 2048 plain rollouts from ``start``
    (noise of their own): at steps T/2 and T-2 each circle's edge runs
    through the swarm's mean position, its centre ``radius`` to the side,
    and its radius is then set to the median of the rollouts' closest
    approach, so that about half of them pass inside: some rollouts hit,
    some do not."""
    import torch
    from autorally_tpu_torch.ops import rollout_kernel as rk

    dev = U.device
    T_ = U.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    eps = torch.randn((T_, 2048, 2), generator=gen, device=dev)
    states, _ = rk.dynamics_chain_plain(
        model, params, cfg.replace(num_rollouts=2048), start, U, eps)
    xy = states[:2, :-1].double()            # the priced states s_1..s_T-1
    m = xy.mean(dim=2)
    circles = []
    for t in (T_ // 2, T_ - 2):
        v = m[:, t - 1] - m[:, t - 6]
        v = v / v.norm() if v.norm() > 1e-9 else torch.tensor(
            [1.0, 0.0], dtype=torch.float64, device=dev)
        c = m[:, t - 1] + radius * torch.stack([-v[1], v[0]])
        closest = (xy - c[:, None, None]).norm(dim=0).amin(dim=0)
        circles.append([c[0].item(), c[1].item(), closest.median().item()])
    return circles


def drive_counted(drive_oval, rk, tag, solver, params, cost_params, surface,
                  ticks, per_solve, card, tick_params=None):
    """``ticks`` ticks of ``drive_oval.drive`` with every launch counter set
    to 0 just before and read just after: exactly ``per_solve`` launches of
    each form in every solve (ticks + the untimed first), none of any other
    and no plain-version call.  Returns (latency p50, p99 in ms, the
    counts, the drive's result)."""
    rk.LAUNCHES.clear()
    with PlainCalls(rk) as plain:
        out = drive_oval.drive(solver, params, cost_params, surface, ticks,
                               log=lambda m: print(f"[{tag}] {m}"),
                               tick_params=tick_params)
    got = dict(rk.LAUNCHES)
    st, stats = out["solve_ms"], out["stats"]
    latency = (float(np.percentile(st, 50)), float(np.percentile(st, 99)))
    print(f"[{tag}] K={solver.cfg.num_rollouts} {ticks} ticks: solve latency "
          f"p50 {latency[0]:.3f} ms p99 {latency[1]:.3f} ms (slide + solve + "
          f"control readback, host clock; {card}); ess {stats.ess.item():.1f}"
          f", crash% {stats.crash_frac.item() * 100:.1f}; launches {got}; "
          f"plain-version calls {plain.calls}")
    check(np.isfinite(out["controls"]).all(), f"{tag}: non-finite controls")
    want = {n: v * (ticks + 1) for n, v in per_solve.items()}
    check(got == want, f"{tag}: launches {got}, expected {want}")
    check(not any(plain.calls.values()), f"{tag}: a plain version ran on "
          f"the card: {plain.calls}")
    return latency, got, out


def bf_obstacle_phases(drive_oval, model, params, cost_params, costmap,
                       field, cases, eps, U, start, slow_start, card):
    """Phases 15-18: the BF model (kernels 1 and 2 at its main-path shapes,
    its closed loop at K=2560) and the obstacle terms (kernels 1, 3 and 4,
    the obstacle closed loop at K=1920 with the circles moved every tick),
    the other BF and obstacle forms driven through their entry points, and
    every new form's timing.  Returns the forms' ``kernels`` entries and the
    two paths' latencies."""
    import torch
    from autorally_tpu_torch.costs import MPPICost, make_obstacles
    from autorally_tpu_torch.ops import rollout_kernel as rk
    from autorally_tpu_torch.solver.mppi import MPPISolver

    dev = U.device
    T_ = U.shape[0]
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    cfg = cases["nominal"][0]
    wide = cases["random_map"][0]
    errs = {}

    def note_err(form, err):
        errs[form] = max(errs.get(form, 0.0), err)

    def pass1_forms(tag, name, form, mdl, prm, ccfg, s0, surf, kw, limit_b,
                    k_offset=0, k_local=KC):
        """Pass 1 on ``surf`` (``ccfg``'s sampler) for the ``k_local``
        rollouts from ``k_offset`` of K=262144: bit for bit the eps-reading
        kernel fed the plain stream, against the plain cost along kernel
        2's trajectories on that stream (``limit_b`` rollouts may differ;
        None: ``agreement``'s rule) and against the whole plain version
        (1 %)."""
        c = ccfg.replace(num_rollouts=KC, kernel_rng=True)
        kc, kx, ctx = rk.fused_rng_costs(mdl, prm, c, cost_params, surf, s0,
                                         U, key, k_offset=k_offset,
                                         K_local=k_local, **kw)
        e = rk.rng_noise(ctx)
        fused = (rk.fused_exact_rollout_cost if type(surf) is type(costmap)
                 else rk.fused_rollout_cost)
        ac, _, ax = fused(mdl, prm, c, cost_params, surf, s0, U, e,
                          k_offset=k_offset, **kw)
        kb, _ = rk.dynamics_chain(mdl, prm, c, s0, U, e, k_offset=k_offset)
        bc, bx = rk.trajectory_cost_plain(mdl, prm, c, cost_params, surf, U,
                                          e, kb, k_offset=k_offset, **kw)
        del kb, e
        pc, px, _ = rk.fused_rng_costs_plain(mdl, prm, c, cost_params, surf,
                                             s0, U, key, k_offset=k_offset,
                                             K_local=k_local, **kw)
        torch.cuda.synchronize()
        same = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[{tag}] equal to the eps-reading kernel on the plain stream: "
              f"{same}")
        check(same, f"{tag}: differs from the eps-reading kernel on the "
              "plain stream")
        note_err(form, agreement(f"{tag} along kernel 2", name, kc, kx, bc,
                                 bx, k_local, limit=limit_b))
        agreement(tag, name, kc, kx, pc, px, k_local, limit=k_local // 100)
        if name == "ahead":
            check(0 < kx.sum().item() < k_local, f"{tag}: the circles are "
                  "hit by no rollout or by all")

    # -- phase 15: BF kernels 1 and 2 against their plain versions -----------
    # kernel 1 in every geometry that the launcher picks for the BF model
    bf_geoms = launcher_geometries(rk, bf=True)
    geoms = launcher_geometries(rk, bf=False)
    bf, bparams, _, _, note = drive_oval.build(model="bf", rollouts=KB,
                                               device=dev)
    bmodel, bcfg = bf.model, bf.cfg
    print(f"[bf] K={KB} T={T_} {type(bmodel).__name__}; {note}")
    strong = dict(bparams, theta=bparams["theta"] * torch.tensor(
        BF_ROW_SCALE, device=dev)[:, None])
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    beps = torch.randn((T_, KB, 2), generator=gen, device=dev)
    # the strong theta's random map from the slow start with the nominal
    # exploration (4x of it diverges there)
    strong_cases = dict(cases, random_map=(cfg, slow_start,
                                           cases["random_map"][2]))
    # its power: the most that dropping each suspect row moves the plain
    # chain's states (256 rollouts) in any of the cases
    power = {}
    for name, (ccfg, s0, _) in strong_cases.items():
        if name == "nan_x":
            continue                       # the same dynamics as nominal
        c = bcfg.replace(steering_std=ccfg.steering_std,
                         throttle_std=ccfg.throttle_std)
        ref, _ = rk.dynamics_chain_plain(bmodel, strong, c, s0, U,
                                         beps[:, :256])
        for row in BF_SUSPECT_ROWS:
            th = strong["theta"].clone()
            th[row] = 0.0
            alt, _ = rk.dynamics_chain_plain(bmodel, dict(strong, theta=th),
                                             c, s0, U, beps[:, :256])
            power[row] = max(power.get(row, 0.0),
                             (alt - ref).abs().max().item())
    print(f"[bf strong theta] max|state change| from dropping each row: "
          + ", ".join(f"{r}: {v:.2e}" for r, v in power.items()))
    check(all(v > 5 * STATE_ATOL for v in power.values()), "bf strong "
          "theta: a suspect row moves the states by less than 5 x "
          "STATE_ATOL")
    for theta_name, prm, tcases in (("seeded", bparams, cases),
                                    ("strong", strong, strong_cases)):
        for name, (ccfg, s0, cmap) in tcases.items():
            tag = f"bf {theta_name}"
            c = bcfg.replace(steering_std=ccfg.steering_std,
                             throttle_std=ccfg.throttle_std)
            kc, ku, kx = hold_geometries(
                f"{tag} kernel 1 {name}", bf_geoms,
                lambda: tuple(rk.fused_exact_rollout_cost(
                    bmodel, prm, c, cost_params, cmap, s0, U, beps)),
                lambda label, out: None)
            pc, pu, px = rk.fused_rollout_cost_plain(bmodel, prm, c,
                                                     cost_params, cmap, s0,
                                                     U, beps)
            ks, kbu = hold_geometries(
                f"{tag} kernel 2 {name}", rk.CHAIN_GEOMETRIES,
                lambda: tuple(rk.dynamics_chain(bmodel, prm, c, s0, U,
                                                beps)),
                lambda label, out: None, chain=True)
            ps, _ = rk.dynamics_chain_plain(bmodel, prm, c, s0, U, beps)
            bc, bx = rk.trajectory_cost_plain(bmodel, prm, c, cost_params,
                                              cmap, U, beps, ks)
            torch.cuda.synchronize()
            check(torch.equal(ku, pu) and torch.equal(kbu, pu),
                  f"{tag} {name}: u_seq differs")
            # the whole plain version: strict in the nominal case, 1 %
            # elsewhere (near tan's pole a rounding difference grows);
            # along kernel 2's trajectories the same cost arithmetic:
            # strict but for a texel edge on the 2 cm random map
            note_err("fused_exact_rollout_cost_bf", agreement(
                f"{tag} kernel 1 K={KB}", name, kc, kx, pc, px, KB))
            agreement(f"{tag} kernel 1 along kernel 2 K={KB}", name, kc, kx,
                      bc, bx, KB, limit=0)
            close = torch.isclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL,
                                  equal_nan=True).all(dim=1).all(dim=0)
            n_differ = int((~close).sum().item())
            fin = torch.isfinite(ps)
            e_s = (ks[fin] - ps[fin]).abs().max().item() if fin.any() else 0.0
            moving = (ps[4] > 0.1).float().mean().item()
            limit = 0 if name == "nominal" else KB // 100
            print(f"[{tag} kernel 2 K={KB}] {name}: max|state err| "
                  f"{e_s:.3e}, {n_differ} rollouts differ beyond rtol "
                  f"{STATE_RTOL} atol {STATE_ATOL} (limit {limit}); state "
                  f"range {ps[fin].min().item():.3g}.."
                  f"{ps[fin].max().item():.3g}, moving (u_x > 0.1) in "
                  f"{100 * moving:.1f}% of steps")
            check(n_differ <= limit, f"{tag} kernel 2 {name}: {n_differ} "
                  "rollouts differ")
            if name != "nan_x":
                note_err("dynamics_chain_bf", e_s)
            del ks, ps
        ks, _ = hold_geometries(
            f"bf {theta_name} kernel 2 nominal trajectory (K=1)",
            rk.CHAIN_GEOMETRIES, lambda: tuple(rk.nominal_trajectory(
                bmodel, prm, bcfg, start, U)), lambda label, out: None,
            chain=True)
        ps, _ = rk.dynamics_chain_plain(bmodel, prm, bcfg, start, U,
                                        torch.zeros((T_, 1, 2), device=dev))
        ps = torch.cat([start[None], ps[:, :, 0].T[:-1]])
        e_nom = (ks - ps).abs().max().item()
        print(f"[bf {theta_name} kernel 2] nominal trajectory (K=1): "
              f"max|state err| {e_nom:.3e}")
        check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
              f"bf {theta_name} nominal trajectory differs")
        note_err("dynamics_chain_bf", e_nom)
    # a K that is a multiple of neither a block nor a warp, and a shard's
    # slice (k_offset != 0), of BF kernel 1 in each of its geometries
    beps_r = torch.randn((T_, KB + 1, 2), generator=gen, device=dev)
    for name, e, k_off in (("ragged_K", beps_r, 0),
                           ("shard", beps[:, 301:].contiguous(), 301)):
        pc, pu, px = rk.fused_rollout_cost_plain(
            bmodel, bparams, bcfg, cost_params, costmap, start, U, e,
            k_offset=k_off)

        def check_bf(label, out):
            kc, ku, kx = out
            note_err("fused_exact_rollout_cost_bf", agreement(
                f"bf seeded kernel 1 {label} K={e.shape[1]} k_offset={k_off}",
                name, kc, kx, pc, px, e.shape[1], limit=0))
            check(torch.equal(ku, pu), f"bf kernel 1 {name}: u_seq differs")

        hold_geometries(f"bf kernel 1 {name}", bf_geoms, lambda: tuple(
            rk.fused_exact_rollout_cost(bmodel, bparams, bcfg, cost_params,
                                        costmap, start, U, e,
                                        k_offset=k_off)), check_bf)
    del beps_r

    # -- phase 16: the BF path, closed loop ----------------------------------
    cpu_bf, cpu_bparams, _, cpu_map, _ = drive_oval.build(
        model="bf", rollouts=KB, device="cpu")
    Ug, stg = bf.iterate(bparams, cost_params, costmap, start, U, beps)
    Uc, stc = cpu_bf.iterate(cpu_bparams, cost_params, cpu_map, start.cpu(),
                             U.cpu(), beps.cpu())
    e_it = (Ug.cpu() - Uc).abs().max().item()
    print(f"[bf path] one iteration GPU vs CPU: max|U_new err| {e_it:.3e}, "
          f"ess {stg.ess.item():.2f} vs {stc.ess.item():.2f}")
    check(e_it <= ITER_ATOL, f"bf iterate: GPU and CPU differ by {e_it}")
    # each run's counts, set to 0 just before it and read just after
    latency, launches = {}, {}

    def run(label, solver, prm, surface, ticks, per_solve, tick_params=None):
        latency[label], launches[label], out = drive_counted(
            drive_oval, rk, label, solver, prm, cost_params, surface, ticks,
            per_solve, card, tick_params)
        return out

    out = run("bf path", bf, bparams, costmap, BF_TICKS,
              {"fused_exact_rollout_cost_bf": 1, "dynamics_chain_bf": 1})
    # BF kernel 1's inputs (state, U, eps) of one more tick, timed in 18
    bf_tick = next_tick_args(rk, "fused_exact_rollout_cost", bf, bparams,
                             cost_params, costmap, out)

    # -- phase 17: obstacles, kernel forms against their plain versions ------
    # the seeded car hardly moves from rest: the circles lie ahead of a
    # start moving up the lane at 1 m/s ("ahead"), where the check that
    # some rollouts hit them and some do not is made
    circles = obstacle_circles(model, params, cfg, slow_start, U)
    cases = dict(cases, ahead=(cfg, slow_start, costmap))
    print(f"[obstacles] circles {circles} in {N_SLOTS} slots, coefficient "
          f"{drive_oval.OBSTACLE_COEFF}, inflation "
          f"{drive_oval.OBSTACLE_INFLATION}")
    okw = dict(obstacles=make_obstacles(circles, N_SLOTS, device=dev),
               obstacle_coeff=drive_oval.OBSTACLE_COEFF,
               inflation=drive_oval.OBSTACLE_INFLATION)
    # Against the plain cost along kernel 2's trajectories (the same chain
    # code) the flags must agree in every rollout; against the whole plain
    # version, whose trajectories differ by rounding, a rollout that grazes
    # a circle's edge (or a texel's) may latch on one side only: 1 %.
    for name, (ccfg, s0, cmap) in cases.items():
        kc, ku, kx = hold_geometries(
            f"obstacles kernel 1 {name}", geoms, lambda: tuple(
                rk.fused_exact_rollout_cost(model, params, ccfg, cost_params,
                                            cmap, s0, U, eps, **okw)),
            lambda label, out: None)
        pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                                 cost_params, cmap, s0, U,
                                                 eps, **okw)
        kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, eps)
        bc, bx = rk.trajectory_cost_plain(model, params, ccfg, cost_params,
                                          cmap, U, eps, kb, **okw)
        torch.cuda.synchronize()
        check(torch.equal(ku, pu), f"obstacles kernel 1 {name}: u_seq "
              "differs")
        note_err("fused_exact_rollout_cost_obstacles", agreement(
            f"obstacles kernel 1 along kernel 2 K={K}", name, kc, kx, bc, bx,
            K, limit=0))
        agreement(f"obstacles kernel 1 K={K}", name, kc, kx, pc, px, K,
                  limit=K // 100)
        if name == "ahead":
            check(0 < kx.sum().item() < K, "obstacles kernel 1 ahead: the "
                  "circles are hit by no rollout or by all")
    wide_f, cfg_f = wide.replace(num_rollouts=KF), cfg.replace(num_rollouts=KF)
    field_cases = {"nominal": (cfg_f, start, field),
                   "ahead": (cfg_f, slow_start, field),
                   "random_field": (wide_f, slow_start, random_field(
                       field, model, params, wide_f, slow_start, U))}
    eps3 = torch.randn((T_, KF, 2), generator=gen, device=dev)
    for name, (ccfg, s0, f) in field_cases.items():
        kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params,
                                           f, s0, U, eps3, **okw)
        pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                                 cost_params, f, s0, U, eps3,
                                                 **okw)
        kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, eps3)
        bc, bx = rk.trajectory_cost_plain(model, params, ccfg, cost_params,
                                          f, U, eps3, kb, **okw)
        del kb
        torch.cuda.synchronize()
        check(torch.equal(ku, pu), f"obstacles kernel 3 {name}: u_seq "
              "differs")
        note_err("fused_rollout_cost_obstacles", agreement(
            f"obstacles kernel 3 along kernel 2 K={KF}", name, kc, kx, bc, bx,
            KF))
        agreement(f"obstacles kernel 3 K={KF}", name, kc, kx, pc, px, KF,
                  limit=KF // 100)
        if name == "ahead":
            check(0 < kx.sum().item() < KF, "obstacles kernel 3 ahead: the "
                  "circles are hit by no rollout or by all")
    for name in ("nominal", "ahead", "random_map"):
        ccfg, s0, cmap = cases[name]
        pass1_forms(f"obstacles pass 1 K={KC}", name,
                    "fused_rng_costs_obstacles", model, params, ccfg, s0,
                    cmap, okw, 0)
    for name, (ccfg, s0, f) in field_cases.items():
        pass1_forms(f"obstacles pass 1 field K={KC}", name,
                    "fused_rng_costs_field_obstacles", model, params, ccfg,
                    s0, f, okw, None)
    # the field forms at a K that is not a multiple of 32: kernel 3, and a
    # shard's slice of pass 1 (k_offset != 0)
    k_r = KF - 19
    ccfg, s0, f = field_cases["ahead"]
    e_r = eps3[:, :k_r].contiguous()
    kc, ku, kx = rk.fused_rollout_cost(model, params, ccfg, cost_params, f,
                                       s0, U, e_r, **okw)
    pc, pu, px = rk.fused_rollout_cost_plain(model, params, ccfg,
                                             cost_params, f, s0, U, e_r,
                                             **okw)
    kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, e_r)
    bc, bx = rk.trajectory_cost_plain(model, params, ccfg, cost_params, f, U,
                                      e_r, kb, **okw)
    torch.cuda.synchronize()
    check(torch.equal(ku, pu), "obstacles kernel 3 ragged_K: u_seq differs")
    note_err("fused_rollout_cost_obstacles", agreement(
        f"obstacles kernel 3 along kernel 2 K={k_r}", "ragged_K", kc, kx, bc,
        bx, k_r))
    agreement(f"obstacles kernel 3 K={k_r}", "ragged_K", kc, kx, pc, px, k_r,
              limit=k_r // 100)
    del e_r, kb, kc, ku, pc, pu
    pass1_forms(f"obstacles pass 1 field K={SHARD[1]} k_offset={SHARD[0]}",
                "ahead",
                "fused_rng_costs_field_obstacles", model, params, ccfg, s0, f,
                okw, None, k_offset=SHARD[0], k_local=SHARD[1])
    # the BF forms of kernels 3 and 4: the strong theta from the slow start,
    # the circles placed on its swarm as above (some rollouts hit, some not)
    bcircles = obstacle_circles(bmodel, strong, bcfg, slow_start, U)
    bokw = dict(okw, obstacles=make_obstacles(bcircles, N_SLOTS, device=dev))
    print(f"[bf obstacles] strong theta, circles {bcircles}")
    bcfg_f = bcfg.replace(num_rollouts=KF)
    kc, ku, kx = rk.fused_rollout_cost(bmodel, strong, bcfg_f, cost_params,
                                       field, slow_start, U, eps3, **bokw)
    pc, pu, px = rk.fused_rollout_cost_plain(bmodel, strong, bcfg_f,
                                             cost_params, field, slow_start,
                                             U, eps3, **bokw)
    kb, _ = rk.dynamics_chain(bmodel, strong, bcfg_f, slow_start, U, eps3)
    bc, bx = rk.trajectory_cost_plain(bmodel, strong, bcfg_f, cost_params,
                                      field, U, eps3, kb, **bokw)
    del kb
    torch.cuda.synchronize()
    check(torch.equal(ku, pu), "bf kernel 3: u_seq differs")
    note_err("fused_rollout_cost_bf", agreement(
        f"bf obstacles kernel 3 along kernel 2 K={KF}", "ahead", kc, kx, bc,
        bx, KF))
    agreement(f"bf obstacles kernel 3 K={KF}", "ahead", kc, kx, pc, px, KF,
              limit=KF // 100)
    check(0 < kx.sum().item() < KF, "bf obstacles kernel 3: the circles are "
          "hit by no rollout or by all")
    del eps3
    pass1_forms(f"bf obstacles pass 1 K={KC}", "ahead", "fused_rng_costs_bf",
                bmodel, strong, bcfg, slow_start, costmap, bokw, 0)
    # BF exact pass 1 without circles: the seeded and the strong theta,
    # gaussian and OU, at K=262144, at a K that is not a multiple of 32 and
    # on a shard's slice (k_offset != 0), each bit for bit the eps-reading
    # BF kernel 1 fed the plain stream
    for theta_name, prm in (("seeded", bparams), ("strong", strong)):
        for sname, kw in SAMPLERS.items():
            pass1_forms(f"bf {theta_name} pass 1 K={KC}", sname,
                        "fused_rng_costs_bf", bmodel, prm,
                        bcfg.replace(**kw), start, costmap, {}, None)
    pass1_forms(f"bf seeded pass 1 K={KC - 13}", "ragged_K",
                "fused_rng_costs_bf", bmodel, bparams, bcfg, start, costmap,
                {}, None, k_local=KC - 13)
    pass1_forms(f"bf strong pass 1 K={SHARD[1]} k_offset={SHARD[0]}", "ou",
                "fused_rng_costs_bf", bmodel, strong,
                bcfg.replace(**SAMPLERS["ou"]), start, costmap, {}, None,
                k_offset=SHARD[0], k_local=SHARD[1])
    pass1_forms(f"bf obstacles pass 1 field K={KC}", "ahead",
                "fused_rng_costs_field_bf", bmodel, strong, bcfg, slow_start,
                field, bokw, None)

    # -- phase 18: the obstacle path, closed loop; the other forms; timing --
    obs, oparams, _, _, onote = drive_oval.build(rollouts=K, device=dev,
                                                 obstacles=circles)
    print(f"[obstacle path] {onote}")
    # a live update reaches the kernel: the same solver from the "ahead"
    # start, the circles moved away
    far = make_obstacles([[c[0] + 100.0, c[1], c[2]] for c in circles],
                         N_SLOTS, device=dev)
    moved = cost_params.replace(obstacles=far)
    _, _, x_near = obs.rollout_costs(oparams, cost_params, costmap,
                                     slow_start, U, eps)
    t_far, _, x_far = obs.rollout_costs(oparams, moved, costmap, slow_start,
                                        U, eps)
    t_ref, _, _ = rk.fused_exact_rollout_cost(model, params, cfg,
                                              cost_params, costmap,
                                              slow_start, U, eps)
    torch.cuda.synchronize()
    print(f"[obstacle path] live update: crash {int(x_near.sum().item())} "
          f"rollouts with the circles, {int(x_far.sum().item())} with them "
          f"moved 100 m away (costs then equal to no obstacles: "
          f"{torch.equal(t_far, t_ref)})")
    check(x_far.sum().item() < x_near.sum().item() and torch.equal(
        t_far, t_ref), "a live CostParams.obstacles did not reach the kernel")

    def moving(step, state):
        """The circles drift 1 cm a tick across the lane, a new array each
        tick through CostParams.obstacles (two_car_demo.py's live path)."""
        return cost_params.replace(obstacles=make_obstacles(
            [[c[0] + 0.01 * step, c[1], c[2]] for c in circles], N_SLOTS,
            device=dev))

    run("obstacle path", obs, oparams, costmap, OBS_TICKS,
        {"fused_exact_rollout_cost_obstacles": 1, "dynamics_chain": 1},
        moving)
    ocost = obs.cost
    bcap = bcfg.replace(num_rollouts=KC, kernel_rng=True)
    ocap = cfg.replace(num_rollouts=KC, kernel_rng=True)
    forms = (
        ("bf capacity", MPPISolver(bmodel, MPPICost(), bcap, device=dev),
         bparams, costmap, {"fused_rng_costs_bf": 1, "fused_rng_numer": 1,
                            "dynamics_chain_bf": 1}),
        ("bf field", MPPISolver(bmodel, MPPICost(), bcfg.replace(
            num_rollouts=KF), device=dev), bparams, field,
         {"fused_rollout_cost_bf": 1, "dynamics_chain_bf": 1}),
        ("bf field capacity", MPPISolver(bmodel, MPPICost(), bcap,
                                         device=dev), bparams, field,
         {"fused_rng_costs_field_bf": 1, "fused_rng_numer": 1,
          "dynamics_chain_bf": 1}),
        ("obstacles capacity", MPPISolver(model, ocost, ocap, device=dev),
         params, costmap, {"fused_rng_costs_obstacles": 1,
                           "fused_rng_numer": 1, "dynamics_chain": 1}),
        ("obstacles field", MPPISolver(model, ocost, cfg.replace(
            num_rollouts=KF), device=dev), params, field,
         {"fused_rollout_cost_obstacles": 1, "dynamics_chain": 1}),
        ("obstacles field capacity", MPPISolver(model, ocost, ocap,
                                                device=dev), params, field,
         {"fused_rng_costs_field_obstacles": 1, "fused_rng_numer": 1,
          "dynamics_chain": 1}),
    )
    for label, solver, prm, surface, per_solve in forms:
        run(label, solver, prm, surface, FORM_TICKS, per_solve)

    # timing: each form at its shape against its plain version and bound
    n_mlp = rk.KERNEL_NUM_WEIGHTS
    n_bf = rk.KERNEL_BF_WEIGHTS
    n_f = rk.FIELD_NUM_WEIGHTS
    mlp_step = mlp_flops(model.layers)
    n_active = sum(1 for c in circles if c[2] > 0)
    circle_ops = n_active * CIRCLE_OPS + (N_SLOTS - n_active) * SLOT_OPS + 1
    texels = 2 * (T_ - 1)
    gen.manual_seed(5)

    def surface_bound(nbytes, k, step, obstacles, surface):
        """(ms, what bounds it) for the exact map; for the field the
        tensor-core bound and then the fp32 one (``field_bounds``)."""
        other = k * (T_ * step + (T_ - 1) * (circle_ops if obstacles else 0))
        if surface != "field":
            return bound(nbytes, other)
        fp32, tc = field_bounds(nbytes, other, k * (T_ - 1) * 2, field)
        return tc + fp32

    def fused_bound(k, n_w, step, obstacles, surface):
        """Kernel 1 / 3: eps read, u_seq, costs and crash written, U, the
        weights, the state, the control ranges (and the circles, the
        field) read once; the exact map one texel per lookup."""
        nbytes = 4 * (T_ * k * 2 + 2 * T_ * k + 2 * k + T_ * 2 + n_w + 7 + 4
                      + (3 * N_SLOTS if obstacles else 0)
                      + (n_f if surface == "field" else texels * k))
        return surface_bound(nbytes, k, step, obstacles, surface)

    def pass1_bound(n_w, step, obstacles, surface):
        nbytes = (4 * (T_ * 2 + n_w + 7 + 4 + 2 * KC
                       + (3 * N_SLOTS if obstacles else 0)
                       + (n_f if surface == "field" else min(
                           costmap.height * costmap.width, texels * KC)))
                  + 16)
        return surface_bound(nbytes, KC, step + STREAM_OPS, obstacles,
                             surface)

    e_b = torch.randn((T_, KB, 2), generator=gen, device=dev)
    e_1 = eps
    e_3 = torch.randn((T_, KF, 2), generator=gen, device=dev)
    z_1 = torch.zeros((T_, 1, 2), device=dev)
    bcfg3, cfg3 = bcfg.replace(num_rollouts=KF), cfg.replace(num_rollouts=KF)
    fkw = dict(okw)
    # name -> (launch, plain, reps, plain reps, bound, TPU kernel line)
    timed = {
        "fused_exact_rollout_cost_bf": (
            rk.prepare_fused_exact_rollout_cost(
                bmodel, bparams, bcfg, cost_params, costmap, start, U,
                e_b)[0],
            lambda: rk.fused_rollout_cost_plain(
                bmodel, bparams, bcfg, cost_params, costmap, start, U, e_b),
            100, 10, fused_bound(KB, n_bf, BF_STEP_OPS, False, "exact"),
            1013),
        "dynamics_chain_bf": (
            rk.prepare_dynamics_chain(bmodel, bparams, bcfg, start, U,
                                      z_1)[0],
            lambda: rk.dynamics_chain_plain(bmodel, bparams, bcfg, start, U,
                                            z_1),
            100, 10, bound(4 * (T_ * 2 + 7 * T_ + 2 * T_ + T_ * 2 + n_bf + 7
                                + 4), BF_STEP_OPS * T_), 389),
        "fused_exact_rollout_cost_obstacles": (
            rk.prepare_fused_exact_rollout_cost(
                model, params, cfg, cost_params, costmap, start, U, e_1,
                **fkw)[0],
            lambda: rk.fused_rollout_cost_plain(
                model, params, cfg, cost_params, costmap, start, U, e_1,
                **fkw),
            100, 10, fused_bound(K, n_mlp, mlp_step, True, "exact"), 1013),
        "fused_rollout_cost_bf": (
            rk.prepare_fused_rollout_cost(bmodel, bparams, bcfg3,
                                          cost_params, field, start, U,
                                          e_3)[0],
            lambda: rk.fused_rollout_cost_plain(
                bmodel, bparams, bcfg3, cost_params, field, start, U, e_3),
            10, 2, fused_bound(KF, n_bf, BF_STEP_OPS, False, "field"), 606),
        "fused_rollout_cost_obstacles": (
            rk.prepare_fused_rollout_cost(model, params, cfg3, cost_params,
                                          field, start, U, e_3, **fkw)[0],
            lambda: rk.fused_rollout_cost_plain(
                model, params, cfg3, cost_params, field, start, U, e_3,
                **fkw),
            10, 2, fused_bound(KF, n_mlp, mlp_step, True, "field"), 606),
    }
    for form, mdl, prm, c, surf, kw, step, n_w in (
            ("fused_rng_costs_bf", bmodel, bparams, bcap, costmap, {},
             BF_STEP_OPS, n_bf),
            ("fused_rng_costs_bf_ou", bmodel, bparams,
             bcap.replace(**SAMPLERS["ou"]), costmap, {},
             BF_STEP_OPS + OU_OPS, n_bf),
            ("fused_rng_costs_obstacles", model, params, ocap, costmap, fkw,
             mlp_step, n_mlp),
            ("fused_rng_costs_field_bf", bmodel, bparams, bcap, field, {},
             BF_STEP_OPS, n_bf),
            ("fused_rng_costs_field_obstacles", model, params, ocap, field,
             fkw, mlp_step, n_mlp),
            # the MLP kernels without obstacles, re-timed in this run
            ("fused_rng_costs", model, params, ocap, costmap, {}, mlp_step,
             n_mlp)):
        timed[form] = (
            rk.prepare_fused_rng_costs(mdl, prm, c, cost_params, surf, start,
                                       U, key, **kw)[0],
            lambda mdl=mdl, prm=prm, c=c, surf=surf, kw=kw:
                rk.fused_rng_costs_plain(mdl, prm, c, cost_params, surf,
                                         start, U, key, **kw),
            5 if surf is field else 20, PLAIN_REPS,
            pass1_bound(n_w, step, bool(kw), "field" if surf is field
                        else "exact"), 1221)
    timed["fused_exact_rollout_cost"] = (
        rk.prepare_fused_exact_rollout_cost(model, params, cfg, cost_params,
                                            costmap, start, U, e_1)[0],
        None, 100, 0, fused_bound(K, n_mlp, mlp_step, False, "exact"), 1013)
    times = {}
    for form, (launch, plain, reps, plain_reps, bnd, _) in timed.items():
        ms = cuda_ms(launch, reps)
        if (getattr(launch, "geometry", None) is not None
                and not form.startswith("dynamics_chain")):
            geometry_line(rk, f"timing {form}", launch, "rng" in form,
                          "_bf" in form, card)
        plain_ms = cuda_ms(plain, plain_reps, 0) if plain else None
        times[form] = (ms, plain_ms)
        fp32 = (f", fp32 bound {bnd[2]:.5f} ms ({bnd[3]})" if len(bnd) > 2
                else "")
        print(f"[timing] {form}: {ms:.4f} ms, plain "
              f"{'-' if plain_ms is None else f'{plain_ms:.3f}'} ms, "
              f"{'tensor-core ' if fp32 else ''}bound {bnd[0]:.5f} ms "
              f"({bnd[1]}){fp32} ({card})")
    chain_bf = chain_timing(rk, "dynamics_chain_bf", bmodel, bparams, bcfg,
                            start, U, z_1, True, 100, card)
    # BF kernel 1 at K=2560 on e_b (above) and on phase 16's closed-loop
    # tick (state, U, eps), in turns, three rounds
    bf1 = {"e_b": rk.prepare_fused_exact_rollout_cost(
               bmodel, bparams, bcfg, cost_params, costmap, start, U,
               e_b)[0],
           "closed_loop": rk.prepare_fused_exact_rollout_cost(
               *bf_tick[0], **bf_tick[1])[0]}
    ms = {inputs: [] for inputs in bf1}
    for _ in range(3):
        for inputs, launch in bf1.items():
            ms[inputs].append(cuda_ms(launch, 100))
    bf1_ms = {inputs: statistics.median(v) for inputs, v in ms.items()}
    print(f"[timing] fused_exact_rollout_cost_bf K={KB}: "
          + ", ".join(f"{t:.4f} ms on {inputs}" for inputs, t in
                      bf1_ms.items())
          + f" (medians of three rounds of 100 in turns, "
          f"{geometry_label(bf1['e_b'].geometry)}) ({card})")
    print(f"[timing] MLP without obstacles in this run: kernel A K={K} "
          f"{times['fused_exact_rollout_cost'][0]:.4f} ms, exact pass 1 "
          f"K={KC} {times['fused_rng_costs'][0]:.4f} ms; with {N_SLOTS} slots "
          f"({n_active} active): kernel A "
          f"{times['fused_exact_rollout_cost_obstacles'][0]:.4f} ms, exact "
          f"pass 1 {times['fused_rng_costs_obstacles'][0]:.4f} ms ({card})")
    profile_ticks(drive_oval, bf, bparams, cost_params, costmap, card,
                  ticks=BF_PROFILE_TICKS, tag="bf profile")

    # each form's launches from the one run that is its path
    path_of = {"fused_exact_rollout_cost_bf": "bf path",
               "dynamics_chain_bf": "bf path",
               "fused_exact_rollout_cost_obstacles": "obstacle path",
               "fused_rollout_cost_bf": "bf field",
               "fused_rollout_cost_obstacles": "obstacles field",
               "fused_rng_costs_bf": "bf capacity",
               "fused_rng_costs_obstacles": "obstacles capacity",
               "fused_rng_costs_field_bf": "bf field capacity",
               "fused_rng_costs_field_obstacles": "obstacles field capacity"}
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    kernels = []
    for form, path in path_of.items():
        ms, plain_ms = times[form]
        bnd, line = timed[form][4:]
        kernels.append(
            {"name": form, "route": "cuda", "source": src,
             "replaces": f"autorally_tpu/ops/rollout_kernel.py:{line}",
             "launches": launches[path][form],
             "max_abs_err": errs[form], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
             **({"fp32_bound_ms": bnd[2]} if len(bnd) > 2 else {}),
             **(chain_entry(chain_bf) if form == "dynamics_chain_bf"
                else {})})
        if form == "fused_exact_rollout_cost_bf":
            kernels[-1]["inputs_ms"] = bf1_ms
        if form == "fused_rng_costs_bf":
            kernels[-1]["ou_ms"] = times["fused_rng_costs_bf_ou"][0]
    return kernels, latency


# -- phase 20: the tube loop -------------------------------------------------

def _ddp_inputs(ctrl, state):
    """The DDP's inputs as ``Controller.compute_feedback_gains`` passes them
    (the measured state, U, the state and control solutions, the limits)."""
    import torch

    rngs = ctrl.model_params["control_rngs"]
    x0 = torch.as_tensor(np.asarray(state, np.float32), device=ctrl.device)
    return (x0, ctrl.cs.U, ctrl.cs.state_solution, ctrl.cs.control_solution,
            rngs[:, 0], rngs[:, 1])


def _numpy_params(params) -> dict:
    """A params dict as numpy arrays, as ``params_from_jax`` takes them."""
    return {k: ([t.cpu().numpy() for t in v] if isinstance(v, list)
                else v.cpu().numpy()) for k, v in params.items()}


def _ddp_results_equal(a, b) -> bool:
    return all(bit_equal(x, y) for x, y in zip(a, b))


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|: a field's error relative to its scale."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _timed(fn, samples: list):
    """``fn`` that appends its host time in ms to ``samples``."""
    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        samples.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def ddp_on_card(tube, state, card) -> dict:
    """Phase 20 (a): the DDP on a warmed-up tick's inputs: captured against
    eager (bit for bit) and against the CPU run, timed both ways, and the
    eager run's kernel launches counted by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from autorally_tpu_torch.solver.ddp import DDPSolver

    ctrl, ddp = tube.actual, tube.actual.ddp
    params, inputs = ctrl.model_params, _ddp_inputs(ctrl, state)
    check(ddp.captures, "the default DDP configuration does not capture")
    captured = ddp.run(params, *inputs)
    eager = ddp.run(params, *inputs, eager=True)
    torch.cuda.synchronize()
    same = _ddp_results_equal(captured, eager)
    print(f"[tube ddp] captured against eager on a warmed-up tick's inputs "
          f"(K={tube.cfg.num_rollouts} solve, T={ddp.T}): bit for bit "
          f"{same}; cost {float(captured.cost):.6g}, max|K| "
          f"{captured.feedback_gain.abs().max().item():.4g}")
    check(same, "the captured DDP run differs from the eager run")
    for name, t in zip(captured._fields, captured):
        check(torch.isfinite(t).all().item(), f"DDP {name} not finite")

    cls = type(ctrl.model)
    cpu_model = cls(ddp.dt, control_ranges=tube.cfg.control_ranges,
                    device="cpu")
    cpu_params = cpu_model.params_from_jax(_numpy_params(params))
    cpu_res = DDPSolver(cpu_model, ddp.dt, ddp.T, ddp.cfg, device="cpu").run(
        cpu_params, *(t.cpu() for t in inputs))
    errs = {n: _rel_err(g, c) for n, g, c in zip(captured._fields, captured,
                                                 cpu_res)}
    print(f"[tube ddp] GPU against the port's CPU run, max|err| over the "
          f"field's max|value|: {errs} (limit {DDP_CPU_REL})")
    check(all(e <= DDP_CPU_REL for e in errs.values()),
          f"DDP on the card and on the CPU differ: {errs}")

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    run_c = lambda: ddp.run(params, *inputs)
    run_e = lambda: ddp.run(params, *inputs, eager=True)
    # two runs at once, each on its own stream, as the tube's controllers
    # run theirs
    streams = [torch.cuda.Stream() for _ in range(2)]
    run_pair = lambda: [ddp.run(params, *inputs, stream=s) for s in streams]
    t = {"eager_ms": cuda_ms(run_e, DDP_EAGER_REPS, warmup=1),
         "eager_host_ms": host_ms(run_e, DDP_EAGER_REPS),
         "captured_ms": cuda_ms(run_c, DDP_REPS),
         "captured_host_ms": host_ms(run_c, DDP_REPS),
         "pair_host_ms": host_ms(run_pair, DDP_REPS)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_e()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                 "cuLaunchKernel", "cuLaunchKernelEx"))
    t["eager_device_events"] = len(kernels)
    t["eager_kernel_launches"] = launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_c()
        torch.cuda.synchronize()
    t["captured_device_events"] = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[tube ddp] one DDP run (T={ddp.T}): eager {t['eager_ms']:.3f} ms "
          f"(CUDA events) / {t['eager_host_ms']:.3f} ms (host clock), "
          f"{launches} kernel launches from the host, {len(kernels)} device "
          f"events (profiler); captured {t['captured_ms']:.3f} ms (CUDA "
          f"events) / {t['captured_host_ms']:.3f} ms (host clock, one graph "
          f"launch and the copies in and out), "
          f"{t['captured_device_events']} device events; two captured runs "
          f"on two streams at once {t['pair_host_ms']:.3f} ms (host clock) "
          f"({card})")
    return t


def tube_drive(run_tube_mppi, rk, tag, model, ticks, card):
    """``ticks`` ticks of ``run_tube_mppi``'s loop with the launch counters
    set to 0 just before and read just after: exactly two launches of
    kernel 1 and two of kernel 2 a tick, no plain-version call; the tick's
    host time split into the solves, the DDP runs, the plant step and the
    rest.  Returns (tube, drive result, split, the car's final u_x and
    distance from the start)."""
    import torch

    from autorally_tpu_torch import drive_oval

    tube = run_tube_mppi.build(ticks=ticks, model=model,
                               device=torch.device("cuda", 0))
    split = {"solve": [], "ddp": [], "gains": [], "plant": []}
    for ctrl in (tube.actual, tube.predicted):
        ctrl.compute_control = _timed(ctrl.compute_control, split["solve"])
        # each DDP run is enqueued on its controller's stream; the loop
        # waits for the chosen one's when it reads its gains
        ctrl.compute_feedback_gains = _timed(ctrl.compute_feedback_gains,
                                             split["ddp"])
        ctrl.get_feedback_gains = _timed(ctrl.get_feedback_gains,
                                         split["gains"])
    tube.plant.step_sim = _timed(tube.plant.step_sim, split["plant"])
    sfx = "_bf" if model == "bf" else ""
    # Python's collections during the drive (a full one over this process's
    # heap can outlast a tick): generation and ms of each
    collections, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started[:] = [time.perf_counter()]
        elif started:
            collections.append((info["generation"],
                                (time.perf_counter() - started[0]) * 1e3))

    rk.LAUNCHES.clear()
    gc.callbacks.append(on_gc)
    try:
        with PlainCalls(rk) as plain:
            out = run_tube_mppi.drive(tube,
                                      log=lambda m: print(f"[{tag}] {m}"))
    finally:
        gc.callbacks.remove(on_gc)
    got = dict(rk.LAUNCHES)
    want = {"fused_exact_rollout_cost" + sfx: 2 * ticks,
            "dynamics_chain" + sfx: 2 * ticks}
    timing, plant = out["timing"], tube.plant
    tick_ms = np.array(timing.tick_samples_ms)
    # the loop's first DDP runs (before tick 1) are not in a tick; a tick
    # enqueues two and waits for the chosen one's gains
    ddp = (np.array(split["ddp"][2:]).reshape(ticks, 2).sum(1)
           + np.array(split["gains"]))
    solve = np.array(split["solve"]).reshape(ticks, 2).sum(1)
    plant_ms = np.array(split["plant"])
    rest = tick_ms - solve - ddp
    pct = lambda a: (float(np.percentile(a, 50)), float(np.percentile(a, 99)))
    res = {"tick": pct(tick_ms), "solves": pct(solve), "ddp": pct(ddp),
           "plant": pct(plant_ms), "rest": pct(rest)}
    s = plant.true_state
    moved = float(np.hypot(*(s[:2] - np.array(drive_oval.START[:2]))))
    pub = np.array([p[1:] for p in plant.published], np.float64)
    status = plant.check_status(plant.get_last_pose_time())
    print(f"[{tag}] K={tube.cfg.num_rollouts} {ticks} ticks in "
          f"{out['wall_s']:.2f} s: arbitration {out['used']}; launches {got};"
          f" plain-version calls {plain.calls}; final u_x {s[4]:.3f} m/s, "
          f"moved {moved:.2f} m, status {status}, controls published "
          f"{len(pub)} ({card})")
    print(f"[{tag}] tick p50 / p99 (ms, host clock; ddp: enqueueing both "
          f"runs and waiting for the chosen one's gains; the plant step "
          f"comes after the tick): " + ", ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in res.items())
          + f"; the slowest tick {tick_ms.max():.3f} (tick "
          f"{int(tick_ms.argmax()) + 1})")
    slow = max(collections, key=lambda c: c[1], default=(None, 0.0))
    print(f"[{tag}] Python's collections in the drive (the DDP's captures "
          f"collect once a stream, before the first tick): {len(collections)}"
          f", {sum(1 for g, _ in collections if g == 2)} of generation 2; "
          f"the slowest {slow[1]:.3f} ms (generation {slow[0]})")
    check(got == want, f"{tag}: launches {got}, expected {want}")
    check(not any(plain.calls.values()), f"{tag}: a plain version ran on "
          f"the card: {plain.calls}")
    check(len(pub) >= ticks and np.isfinite(pub).all(),
          f"{tag}: {len(pub)} controls published, or not finite")
    check(status == 0, f"{tag}: status {status} at the end")
    return tube, out, res, (float(s[4]), moved)


def tube_hot_updates(run_tube_mppi, rk, card):
    """Phase 20 (c): a model push and a cost-params push in the middle of
    a run, each seen by the next tick's solves and DDP runs, and a throttle
    cut seen by the next DDP clamp."""
    import torch

    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver

    tube = run_tube_mppi.build(ticks=HOT_TICKS,
                               device=torch.device("cuda", 0))
    actual, predicted, plant = tube.actual, tube.predicted, tube.plant
    model, ddp, solver = actual.model, actual.ddp, actual.solver
    old = actual.model_params
    new = {**old, "weights": [w * 1.1 for w in old["weights"]],
           "biases": [b * 1.1 for b in old["biases"]]}
    new_cost = actual.cost_params.replace(desired_speed=4.0)
    push = HOT_TICKS - 2
    calls = {"rollouts": [], "ddp": []}
    rollout_costs, run = solver.rollout_costs, ddp.run

    def recorder(fn, name):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            calls[name].append((a, kw, out))
            return out
        return recorded

    solver.rollout_costs = recorder(rollout_costs, "rollouts")
    ddp.run = recorder(run, "ddp")
    ticks = {}

    def on_tick(i, chosen, used, state):
        ticks[i] = {k: list(v) for k, v in calls.items()}
        for v in calls.values():
            v.clear()
        if i == push:
            plant.push_model_params(new)
            plant.push_cost_params(new_cost)
        elif i == push + 1:
            ticks["cost"] = (actual.cost_params is new_cost
                             and predicted.cost_params is new_cost)
            actual.cut_throttle()

    run_tube_mppi.drive(tube, log=lambda m: None, on_tick=on_tick)
    torch.cuda.synchronize()             # the DDP streams' last runs
    # the actual controller's solve after the push (its first rollouts)
    # against a fresh solver and model on the new weights, and the old
    a, kw, out = ticks[push + 1]["rollouts"][0]
    fresh_model = NeuralNetDynamics(model.dt,
                                    control_ranges=tube.cfg.control_ranges,
                                    device=model.device)
    fresh_params = fresh_model.params_from_jax(_numpy_params(new))
    fresh = MPPISolver(fresh_model, solver.cost, tube.cfg,
                       device=model.device).rollout_costs(
                           fresh_params, *a[1:], **kw)
    stale = rollout_costs(old, *a[1:], **kw)
    check(a[0] is new, "the solve after the push was not given the new "
          "weights")
    same_costs = bit_equal(out[0], fresh[0])
    moved_costs = not bit_equal(out[0], stale[0])
    # the actual controller's DDP run after the push against eager runs
    da, _, dout = ticks[push + 1]["ddp"][0]
    same_ddp = _ddp_results_equal(dout, run(*da, eager=True))
    moved_ddp = not bit_equal(dout.feedback_gain,
                              run(old, *da[1:], eager=True).feedback_gain)
    ca, _, cout = ticks[push + 2]["ddp"][0]
    cut_max = float(ca[6][1])
    cut_thr = float(cout.control_traj[:, 1].max())
    print(f"[tube hot] model push (weights x1.1) at tick {push}: kernel 1's "
          f"costs of the next solve bit for bit a fresh solver's on the new "
          f"weights {same_costs}, and not the old weights' {moved_costs}; "
          f"the next DDP run bit for bit an eager run on the new weights "
          f"{same_ddp}, its gains not the old weights' {moved_ddp}; cost "
          f"params on both controllers {ticks['cost']}; after cut_throttle "
          f"the DDP's throttle limit {cut_max} and its highest throttle "
          f"{cut_thr:.4g} ({card})")
    check(same_costs and moved_costs, "the solve after a model push did "
          "not run on the new weights")
    check(same_ddp and moved_ddp, "the DDP run after a model push did not "
          "run on the new weights")
    check(ticks["cost"], "a cost-params push did not reach both "
          "controllers")
    check(cut_max == 0.0 and cut_thr <= 0.0,
          "cut_throttle did not zero the DDP's throttle limit")


def tube_phase(run_tube_mppi, rk, card) -> dict:
    """Phase 20: the tube loop at BASELINE #1's width (a)-(d)."""
    import torch

    # (a) the DDP on the inputs of a warmed-up tick
    warm = tube_drive(run_tube_mppi, rk, "tube warm-up", "nn", WARM_TICKS,
                      card)[0]
    ddp_t = ddp_on_card(warm, warm.plant.full_state.to_vector(), card)
    # (b) 200 ticks, lockstep, DDP gains on
    _, out, split, (u_x, moved) = tube_drive(run_tube_mppi, rk, "tube",
                                             "nn", TUBE_TICKS, card)
    check(u_x > TUBE_MIN_SPEED, f"tube: the car did not accelerate: u_x "
          f"{u_x:.3f} m/s, not over {TUBE_MIN_SPEED}")
    check(moved > 1.0, f"tube: the car moved {moved:.2f} m")
    # (c) hot updates mid-run
    tube_hot_updates(run_tube_mppi, rk, card)
    # (d) the BF model's Jacobians through the DDP on the card
    bf, _, bf_split, _ = tube_drive(run_tube_mppi, rk, "tube BF", "bf",
                                    TUBE_BF_TICKS, card)
    bf_inputs = _ddp_inputs(bf.actual, bf.plant.full_state.to_vector())
    bf_same = _ddp_results_equal(
        bf.actual.ddp.run(bf.actual.model_params, *bf_inputs),
        bf.actual.ddp.run(bf.actual.model_params, *bf_inputs, eager=True))
    torch.cuda.synchronize()
    print(f"[tube BF] captured DDP bit for bit the eager run on the last "
          f"tick's inputs: {bf_same}")
    check(bf_same, "tube BF: the captured DDP differs from the eager run")
    bf_ddp = ddp_nodes(bf.actual.ddp, bf.actual.model_params, bf_inputs)
    print(f"[tube BF] one captured BF DDP run (the fused BF step): "
          f"{bf_ddp['nodes']} device events (graph nodes), "
          f"{bf_ddp['ms']:.3f} ms (CUDA events); the MLP's "
          f"{ddp_t['captured_device_events']} and {ddp_t['captured_ms']:.3f} "
          f"ms; BF tube tick p50 / p99 {bf_split['tick'][0]:.3f} / "
          f"{bf_split['tick'][1]:.3f} ms against the 20 ms budget ({card})")
    _, _, bf_long, _ = tube_drive(run_tube_mppi, rk, "tube BF long", "bf",
                                  TUBE_BF_LONG_TICKS, card)
    return {"ddp": ddp_t, "split": split, "bf_split": bf_split,
            "bf_long_split": bf_long, "used": out["used"], "bf_ddp": bf_ddp}


def ddp_nodes(ddp, params, inputs) -> dict:
    """One captured DDP run's device events (its graph's kernel nodes,
    profiler) and its time (CUDA events, median of DDP_REPS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = lambda: ddp.run(params, *inputs)
    ms = cuda_ms(run, DDP_REPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    nodes = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"nodes": nodes, "ms": ms}


def episode_equal(a, b) -> bool:
    """Every field of two ``EpisodeResult``s bit for bit."""
    return all(bit_equal(x, y) for x, y in zip(a, b))


class Captures:
    """Counts and times a runner's captures (``EpisodeRunner._capture``:
    the eager warm-up tick and the capture)."""

    def __init__(self, runner):
        self.seconds = []
        capture = runner._capture

        def timed(*a, **kw):
            t0 = time.perf_counter()
            capture(*a, **kw)
            self.seconds.append(time.perf_counter() - t0)
        runner._capture = timed


def episode_setup(dev, model: str = "nn", rollouts: int = K, cost=None,
                  **cfg_kw):
    """(solver, params, costmap, start, lap line, crossings) of phase 21:
    the oval of ``load_track``, seeded weights (``init_params(0)``)."""
    from autorally_tpu_torch.config import MPPIConfig
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                            NeuralNetDynamics)
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.lap_eval import load_track

    cm, start_pose, line, xings = load_track("oval", device=dev)
    cfg = MPPIConfig(num_rollouts=rollouts, num_timesteps=T, **cfg_kw)
    cls = BasisFunctionDynamics if model == "bf" else NeuralNetDynamics
    dyn = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
    params = dyn.init_params(0)
    solver = MPPISolver(dyn, cost or MPPICost(cfg.l1_cost), cfg, device=dev)
    start = [start_pose[0], start_pose[1], start_pose[2], 0, 0, 0, 0]
    return solver, params, cm, start, line, xings


def episode_held(tag, runner, args, kw=None) -> dict:
    """One captured run of ``runner`` against the same run eagerly on the
    card: every field bit for bit, every value finite.  Returns the
    captured run's result and the captures it took."""
    import torch

    kw = kw or {}
    caps = getattr(runner, "_smoke_captures", None)
    if caps is None:
        caps = runner._smoke_captures = Captures(runner)
    n0 = len(caps.seconds)
    cap = runner.run(*args, **kw)
    eag = runner.run(*args, eager=True, **kw)
    torch.cuda.synchronize()
    same = episode_equal(cap, eag)
    finite = all(torch.isfinite(t.float()).all().item() for t in cap)
    used = int(cap.used_actual.sum().item())
    print(f"[episode] {tag}: {runner.n_ticks} ticks captured ("
          f"{len(caps.seconds) - n0} capture(s)) bit for bit the eager run "
          f"{same}, finite {finite}, actual-state controller used {used} / "
          f"{runner.n_ticks}, final u_x {cap.states[-1, 4].item():.3f} m/s")
    check(same, f"episode {tag}: the captured run differs from the eager "
          f"run")
    check(finite, f"episode {tag}: a value is not finite")
    return {"result": cap, "captures": len(caps.seconds) - n0}


def episode_launches(rk, runner, args, card) -> dict:
    """Phase 21 (b): ``EP_PROFILE_TICKS`` replayed ticks under the
    profiler: exactly two launches of kernel 1's and two of kernel 2's
    instances a tick, and no plain-version call in the capture or the
    replays.  (``rk.LAUNCHES`` counts in Python: under replay it sees the
    capture only.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with PlainCalls(rk) as plain:
        runner.run(*args)                     # captures
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.run(*args)                 # replays only
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {"kernel 1": [n for n in names if "fused_exact" in n],
            "kernel 2": [n for n in names if "dynamics_chain" in n],
            "other": [n for n in names if any(
                k in n for k in ("fused_rng", "fused_field",
                                 "weighted_update"))]}
    count = {k: len(v) for k, v in ours.items()}
    n = runner.n_ticks
    print(f"[episode launches] {n} replayed ticks (profiler): kernel 1 "
          f"{count['kernel 1']} ({sorted(set(ours['kernel 1']))[:1]}), "
          f"kernel 2 {count['kernel 2']} "
          f"({sorted(set(ours['kernel 2']))[:1]}), other rollout kernels "
          f"{count['other']}; {len(names)} device events in all "
          f"({len(names) / n:.0f} a tick); plain-version calls "
          f"{plain.calls} ({card})")
    check(names, "episode: the profiler recorded no device events")
    check(count == {"kernel 1": 2 * n, "kernel 2": 2 * n, "other": 0},
          f"episode: launches {count}, expected 2 + 2 a tick")
    check(not any(plain.calls.values()), f"episode: a plain version ran "
          f"on the card: {plain.calls}")
    return {"kernel 1": count["kernel 1"] / n, "kernel 2":
            count["kernel 2"] / n, "device_events_per_tick": len(names) / n}


def episode_timing(tag, runner, args, line, xings, card) -> dict:
    """Phase 21 (d): a first run (the capture, timed) and a second,
    replayed run timed with CUDA events (ms a tick, the host's staging and
    noise draws included) and the host clock (ticks/s, sim-seconds a
    wall-second); the second run's ``episode_metrics``."""
    import torch

    from autorally_tpu_torch.tools.lap_eval import episode_metrics

    caps = Captures(runner)
    t0 = time.perf_counter()
    runner.run(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    res = runner.run(*args)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, dt = runner.n_ticks, runner.solver.cfg.dt
    ms = e0.elapsed_time(e1) / n
    m = episode_metrics(res, args[2], line, xings, dt,
                        float(args[1].boundary_threshold))
    out = {"capture_s": caps.seconds[0] if caps.seconds else None,
           "first_run_s": first_s, "ms_per_tick": ms,
           "ticks_per_s": n / wall, "sim_s_per_wall_s": n * dt / wall,
           "laps": m["laps"], "mean_speed": m["mean_speed"],
           "offtrack_frac": m["offtrack_frac"], "mean_ess": m["mean_ess"]}
    check(len(caps.seconds) == 1, f"episode {tag}: {len(caps.seconds)} "
          f"captures in two runs, expected 1")
    print(f"[episode timing] {tag}: capture {out['capture_s']:.3f} s "
          f"(warm-up tick and capture; first run {first_s:.3f} s); "
          f"{n} replayed ticks {ms:.4f} ms a tick (CUDA events), "
          f"{out['ticks_per_s']:.1f} ticks/s, "
          f"{out['sim_s_per_wall_s']:.3f} sim-s a wall-s (host clock); laps "
          f"{m['laps']}, mean speed {m['mean_speed']} m/s, off-track "
          f"{m['offtrack_frac']}, mean ESS {m['mean_ess']} ({card})")
    check(torch.isfinite(res.states).all().item(), f"episode {tag}: "
          f"states not finite")
    return out


def laps_artifact_errors(d: dict) -> list:
    """The rules of ``tests/test_artifacts.py::validate_laps``, the
    winding track allowed beside ccrf, marietta and oval: a list of what
    breaks them."""
    num = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
    errs = []
    if d.get("artifact") != "laps" or not isinstance(d.get("round"), int):
        errs.append("header")
    for row in d.get("rows") or [None]:
        if not isinstance(row, dict):
            errs.append("no rows")
            continue
        if not (isinstance(row.get("name"), str)
                and row.get("track") in ("ccrf", "marietta", "oval",
                                         "winding")
                and isinstance(row.get("K"), int)
                and isinstance(row.get("T"), int)
                and num(row.get("desired_speed")) and row.get("runs")):
            errs.append(f"row {row.get('name')}")
        for r in row.get("runs") or []:
            keys = ("mean_speed", "max_speed", "max_slip", "offtrack_frac",
                    "rollout_crash_frac", "mean_ess")
            if not (isinstance(r.get("laps"), int)
                    and isinstance(r.get("lap_times_s"), list)
                    and (r.get("best_lap_s") is None
                         or num(r.get("best_lap_s")))
                    and all(num(r.get(k)) for k in keys)
                    and 0.0 <= r["offtrack_frac"] <= 1.0):
                errs.append(f"run of {row.get('name')}")
    return errs


def episode_phase(rk, card, dev=None) -> dict:
    """Phase 21: the closed-loop episode on the card (a)-(e)."""
    import torch

    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.costs import ObstacleCost, make_obstacles
    from autorally_tpu_torch.drive_oval import (OBSTACLE_COEFF,
                                                OBSTACLE_INFLATION)
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.tools import lap_suite

    dev = torch.device("cuda", 0) if dev is None else dev
    cp = CostParams(desired_speed=6.0)
    solver, params, cm, start, line, xings = episode_setup(dev)
    cfg = solver.cfg
    out = {}

    def tube(n_ticks, **kw):
        """The tube with gains, two plant substeps a tick and an ESS
        target on the seeded MLP."""
        true = NeuralNetDynamics(cfg.dt / 2, control_ranges=cfg.control_ranges,
                                 device=dev)
        return EpisodeRunner(solver, true_model=true, n_ticks=n_ticks,
                             use_feedback_gains=True, pose_substeps=2,
                             ess_target_frac=0.25, **kw)

    # (a) bit equality, and no stale graph after other cost params
    runner = tube(EP_BIT_TICKS)
    first = episode_held("gains, 2 substeps, ESS target 0.25", runner,
                         (params, cp, cm, start))
    cp2 = cp.replace(desired_speed=4.0)
    second = episode_held("the same runner, desired speed 4 m/s", runner,
                          (params, cp2, cm, start))
    reseeded = episode_held("the same runner and cost params, seeds 2, 3",
                            runner, (params, cp2, cm, start),
                            dict(seed_a=2, seed_p=3))
    moved = not bit_equal(first["result"].states, second["result"].states)
    g = first["result"].gamma
    print(f"[episode] other cost params captured again "
          f"{second['captures'] == 1} and gave other states {moved}; other "
          f"seeds replayed the same graph {reseeded['captures'] == 0}; "
          f"gamma {g[0].item():.4g} -> {g[-1].item():.4g} (ESS target "
          f"{0.25 * cfg.num_rollouts:.0f}) ({card})")
    check(first["captures"] == 1 and second["captures"] == 1
          and reseeded["captures"] == 0, "episode: captures "
          f"{first['captures']}, {second['captures']}, "
          f"{reseeded['captures']}, expected 1, 1, 0")
    check(moved, "episode: a run with other cost params replayed the "
          "stale graph")
    check(g[-1].item() != g[0].item(), "episode: the ESS law kept gamma")
    del runner, first, second, reseeded

    # (b) launches of the replayed tick
    out["launches"] = episode_launches(rk, tube(EP_PROFILE_TICKS),
                                       (params, cp, cm, start), card)

    # (c) short runs: moving obstacles, the capacity mode, the asymmetric
    # tube
    traj = torch.full((EP_SHORT_TICKS, N_SLOTS, 3), -1.0, device=dev)
    steps = torch.arange(EP_SHORT_TICKS, device=dev, dtype=torch.float32)
    traj[:, 0, 0], traj[:, 0, 1], traj[:, 0, 2] = 30.3, 2.0 - 0.01 * steps, 0.5
    traj[:, 1, 0], traj[:, 1, 1], traj[:, 1, 2] = 29.5 + 0.01 * steps, 3.5, 0.5
    osolver, oparams, *_ = episode_setup(dev, cost=ObstacleCost(
        make_obstacles(traj[0].tolist(), N_SLOTS, device=dev),
        OBSTACLE_COEFF, OBSTACLE_INFLATION))
    episode_held("moving obstacles (16 slots)",
                 EpisodeRunner(osolver, n_ticks=EP_SHORT_TICKS),
                 (oparams, cp, cm, start), dict(obstacle_traj=traj))
    csolver, cparams, *_ = episode_setup(dev, rollouts=KC, kernel_rng=True)
    check(csolver._use_kernel_rng(cm), "the capacity solver's mode")
    episode_held(f"the capacity mode (K={KC})",
                 EpisodeRunner(csolver, n_ticks=EP_SHORT_TICKS),
                 (cparams, cp, cm, start))
    episode_held(f"the asymmetric tube (K_pred={EP_K_PRED})",
                 EpisodeRunner(solver, n_ticks=EP_SHORT_TICKS,
                               solver_predicted=solver.with_rollouts(
                                   EP_K_PRED)),
                 (params, cp, cm, start))
    del osolver, csolver
    gc.collect()
    torch.cuda.empty_cache()

    # (d) timing
    out["timing"] = {
        "nn": episode_timing(f"MLP K={K}, {EP_TICKS} ticks", EpisodeRunner(
            solver, n_ticks=EP_TICKS), (params, cp, cm, start), line, xings,
            card),
        "nn_gains": episode_timing(
            f"MLP K={K} with gains, {EP_GAIN_TICKS} ticks", EpisodeRunner(
                solver, n_ticks=EP_GAIN_TICKS, use_feedback_gains=True),
            (params, cp, cm, start), line, xings, card)}
    bsolver, bparams, *_ = episode_setup(dev, model="bf", rollouts=KB)
    out["timing"]["bf_gains"] = episode_timing(
        f"BF K={KB} with gains, {EP_BF_TICKS} ticks", EpisodeRunner(
            bsolver, n_ticks=EP_BF_TICKS, use_feedback_gains=True),
        (bparams, cp, cm, start), line, xings, card)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the lap suite's rows
    artifact = {"artifact": "laps", "round": 6, "ticks": EP_LAP_TICKS,
                "seeds": 1, "smoke": False, "rows": []}
    for row in EP_LAP_ROWS:
        t0 = time.perf_counter()
        runs = lap_suite.run_config(row, EP_LAP_TICKS, 1, device=dev)
        artifact["rows"].append({**row, "weights": runs[0]["weights"],
                                 "runs": runs})
        r = runs[0]
        print(f"[episode laps] {row['name']}: {EP_LAP_TICKS} ticks in "
              f"{time.perf_counter() - t0:.2f} s (capture included): laps "
              f"{r['laps']}, mean speed {r['mean_speed']} m/s, max speed "
              f"{r['max_speed']}, off-track {r['offtrack_frac']}, rollout "
              f"crash {r['rollout_crash_frac']}, mean ESS {r['mean_ess']}; "
              f"weights {r['weights']} ({card})")
    errs = laps_artifact_errors(artifact)
    print(f"[episode laps] the artifact against validate_laps's rules "
          f"(winding allowed): {errs or 'valid'}")
    check(not errs, f"episode laps: the artifact breaks {errs}")
    return out


# -- phase 22: the async loop -------------------------------------------------

def _bits(out_a, out_b) -> bool:
    """Two harvested ``TubeTickOutput``s bit for bit."""
    return all((x is None and y is None) or (
        x is not None and y is not None
        and np.asarray(x).tobytes() == np.asarray(y).tobytes())
        for x, y in zip(out_a, out_b))


def _busy_ms(events) -> float:
    """The union of the device events' intervals (profiler, us) in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def async_captured_vs_eager(run_tube_mppi, card) -> dict:
    """Phase 22 (a): one tube captured, one eager on the card, the same
    states and strides (0, 1, 2, T-1 mixed) and a cost push at tick
    ASYNC_PUSH_AT: every harvested output and the final carries bit for
    bit; the captured tube captured twice (the push), the eager one never."""
    import torch

    from autorally_tpu_torch.runtime.async_loop import AsyncTubeController
    from autorally_tpu_torch.runtime.profiling import count_solve_traces

    tube = run_tube_mppi.build(ticks=1, device=torch.device("cuda", 0))
    a = tube.actual
    tubes = [AsyncTubeController(a.solver, a.model_params, a.cost_params,
                                 a.costmap, eager=eager)
             for eager in (False, True)]
    traces = [count_solve_traces(t) for t in tubes]
    rs = np.random.default_rng(22)
    start = np.array(tube.plant.true_state, np.float32)
    strides = [(0, 1, 2, T - 1, 1)[i % 5] for i in range(ASYNC_BIT_TICKS)]
    for t in tubes:
        t.reset(start)
    same, finite = 0, True
    for i, stride in enumerate(strides):
        if i == ASYNC_PUSH_AT:
            for t in tubes:
                t.update_cost_params(t.cost_params.replace(
                    desired_speed=4.0))
        state = start + rs.normal(0, 0.05, 7).astype(np.float32)
        outs = [t.dispatch(state, stride).result() for t in tubes]
        same += _bits(*outs)
        finite &= all(np.isfinite(np.asarray(x, np.float64)).all()
                      for x in outs[0] if x is not None)
    carries = all(
        torch.equal(getattr(getattr(tubes[0], h), f),
                    getattr(getattr(tubes[1], h), f))
        for h in ("cs_a", "cs_p") for f in ("U", "control_hist",
                                            "state_solution",
                                            "control_solution"))
    n = ASYNC_BIT_TICKS
    print(f"[async] (a) {n} dispatches, strides {sorted(set(strides))} "
          f"mixed, a cost push at tick {ASYNC_PUSH_AT}: captured bit for bit "
          f"the eager tick in {same} / {n}, final carries equal {carries}, "
          f"finite {finite}; captures {traces[0]['n']} (captured tube), "
          f"{traces[1]['n']} (eager) ({card})")
    check(same == n and carries, f"async (a): captured dispatches differ "
          f"from eager ones ({same} / {n} equal, carries {carries})")
    check(finite, "async (a): a harvested value is not finite")
    check(traces == [{"n": 2}, {"n": 0}], f"async (a): captures {traces}, "
          f"expected 2 (the first dispatch and the push) and 0")
    return {"bit_equal": same, "captures": traces[0]["n"]}


def async_launches(run_tube_mppi, rk, card) -> dict:
    """Phase 22 (b): ASYNC_PROFILE_TICKS replayed dispatches under the
    profiler: exactly two launches of kernel 1's instances and two of
    kernel 2's a tick, no other rollout kernel, no plain-version call; and
    the graph's nodes (the device events of one bare replay)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tube = run_tube_mppi.build(ticks=1, device=torch.device("cuda", 0))
    atube = run_tube_mppi.async_tube(tube)
    state = np.array(tube.plant.true_state, np.float32)
    atube.reset(state)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with PlainCalls(rk) as plain:
        atube.dispatch(state, 1).result()           # captures
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for i in range(ASYNC_PROFILE_TICKS):
                atube.dispatch(state, i % 3).result()
            torch.cuda.synchronize()
        with profile(activities=acts) as bare:
            with torch.cuda.stream(atube._stream):
                atube._graph.replay()
            torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == dev]
    nodes = sum(1 for e in bare.events() if e.device_type == dev)
    count = {"kernel 1": sum("fused_exact" in x for x in names),
             "kernel 2": sum("dynamics_chain" in x for x in names),
             "other": sum(any(k in x for k in ("fused_rng", "fused_field",
                                                "weighted_update"))
                          for x in names)}
    n = ASYNC_PROFILE_TICKS
    print(f"[async] (b) {n} replayed dispatches (profiler): kernel 1 "
          f"{count['kernel 1']}, kernel 2 {count['kernel 2']}, other rollout "
          f"kernels {count['other']}; {len(names)} device events "
          f"({len(names) / n:.0f} a dispatch: the graph, the noise draws, "
          f"the copies); the graph alone {nodes} device events; plain-"
          f"version calls {plain.calls} ({card})")
    check(names, "async (b): the profiler recorded no device events")
    check(count == {"kernel 1": 2 * n, "kernel 2": 2 * n, "other": 0},
          f"async (b): launches {count}, expected 2 + 2 a tick")
    check(not any(plain.calls.values()), f"async (b): a plain version ran "
          f"on the card: {plain.calls}")
    return {"kernel 1": count["kernel 1"] / n,
            "kernel 2": count["kernel 2"] / n, "graph_nodes": nodes,
            "device_events_per_dispatch": len(names) / n}


def async_drive(run_tube_mppi, depth: int, card, trace_dir=None) -> dict:
    """Phase 22 (c)-(e): ASYNC_TICKS lockstep ticks of ``run_tube_mppi``'s
    async loop at ``depth`` with ``EssTuner.attach_async`` moving gamma
    every harvest: the first harvest at tick depth + 1 and every later
    solution exactly ``depth`` periods old; one capture in all; finite
    controls, status 0, the car moving; each tick's host dispatch ms, the
    harvest's wait and the dispatch's device span (CUDA events on the
    tube's stream).  With ``trace_dir`` the last ASYNC_TRACE_TICKS ticks run
    under ``device_trace`` for the device's busy share of the period."""
    import torch

    from autorally_tpu_torch.runtime.ess_tuner import EssTuner
    from autorally_tpu_torch.runtime.profiling import (count_solve_traces,
                                                       device_trace)

    n = ASYNC_TICKS
    tube = run_tube_mppi.build(ticks=n, device=torch.device("cuda", 0))
    atube = run_tube_mppi.async_tube(tube)
    traces = count_solve_traces(atube)
    tuner = EssTuner(tube.cfg, target_frac=0.25)
    ess_hook = tuner.attach_async(atube)
    ages, gammas = [], []
    dispatch_ms, spans = [], []
    dispatch = atube.dispatch

    def timed_dispatch(state, stride):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(atube._stream)
        t0 = time.perf_counter()
        out = dispatch(state, stride)
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        e1.record(atube._stream)
        spans.append((e0, e1))
        return out

    atube.dispatch = timed_dispatch

    def hook(num_iter, used, state, out, harvest_ms, age_s):
        ess_hook(num_iter, used, state, out, harvest_ms, age_s)
        ages.append((num_iter, age_s))
        gammas.append(atube.cost_params.gamma)

    out = run_tube_mppi.drive(tube, log=lambda m: None, atube=atube,
                              depth=depth, on_tick_async=hook)
    torch.cuda.synchronize()
    timing, plant = out["timing"], tube.plant
    dev_ms = [a.elapsed_time(b) for a, b in spans]
    harvest = list(timing.harvest_samples_ms)
    dt = tube.cfg.dt
    # the loop harvests n - depth solutions, the drain the last depth
    steady = [a for _, a in ages[:n - depth]]
    lag_ok = (ages[0][0] == depth + 1 and len(ages) == n and all(
        abs(a - depth * dt) < dt / 2 for a in steady))
    s = plant.true_state
    pub = np.array([p[1:] for p in plant.published], np.float64)
    status = plant.check_status(plant.get_last_pose_time())
    pct = lambda a: (float(np.percentile(a, 50)), float(np.percentile(a, 99)))
    res = {"depth": depth, "dispatch_ms": pct(dispatch_ms[1:]),
           "harvest_ms": pct(harvest[depth:]), "device_ms": pct(dev_ms[1:]),
           "tick_ms": pct(list(timing.tick_samples_ms)[1:]),
           "first_dispatch_ms": dispatch_ms[0], "captures": traces["n"],
           "u_x": float(s[4])}
    print(f"[async] depth {depth}: {n} lockstep ticks in {out['wall_s']:.2f}"
          f" s, arbitration {out['used']}; the first harvest at tick "
          f"{ages[0][0]}, solution ages {min(steady):.4f}..{max(steady):.4f} "
          f"s (depth x dt = {depth * dt:.4f}); captures {traces['n']} "
          f"(gamma {gammas[0]:.4g} -> {gammas[-1]:.4g} by attach_async); "
          f"final u_x {s[4]:.3f} m/s, status {status}, controls published "
          f"{len(pub)} ({card})")
    print(f"[async] depth {depth} p50 / p99 (ms): host dispatch "
          f"{res['dispatch_ms'][0]:.3f} / {res['dispatch_ms'][1]:.3f} (the "
          f"first, which captures, {dispatch_ms[0]:.3f}), harvest wait "
          f"{res['harvest_ms'][0]:.3f} / {res['harvest_ms'][1]:.3f}, device "
          f"span of a dispatch (CUDA events) {res['device_ms'][0]:.3f} / "
          f"{res['device_ms'][1]:.3f}, the loop's tick "
          f"{res['tick_ms'][0]:.3f} / {res['tick_ms'][1]:.3f} ({card})")
    check(lag_ok, f"async depth {depth}: the published solution does not "
          f"lag by exactly {depth} dispatches: {ages[:4]}...")
    check(traces["n"] == 1, f"async depth {depth}: {traces['n']} captures "
          f"in {n} ticks with gamma moving, expected 1")
    check(len(set(gammas)) > 2, f"async depth {depth}: gamma did not move")
    check(len(pub) >= n - depth and np.isfinite(pub).all(),
          f"async depth {depth}: {len(pub)} controls published, or not "
          f"finite")
    check(status == 0, f"async depth {depth}: status {status} at the end")
    if trace_dir is not None:
        import tempfile

        atube.dispatch = dispatch
        tube2 = tube._replace(loop_cfg=dataclasses.replace(
            tube.loop_cfg, max_iter=ASYNC_TRACE_TICKS))
        with tempfile.TemporaryDirectory(dir=trace_dir) as d:
            with device_trace(d) as prof:
                t0 = time.perf_counter()
                run_tube_mppi.drive(tube2, log=lambda m: None, atube=atube,
                                    depth=depth)
                wall = (time.perf_counter() - t0) * 1e3
            cuda = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            size = os.path.getsize(prof.trace_path)
        busy = _busy_ms(cuda) / ASYNC_TRACE_TICKS
        period = 1e3 / tube.cfg.hz
        res["busy_ms_per_tick"] = busy
        res["busy_share_of_period"] = busy / period
        print(f"[async] depth {depth} device_trace over {ASYNC_TRACE_TICKS} "
              f"lockstep ticks ({wall:.1f} ms wall under the profiler, a "
              f"{size / 2**20:.1f} MiB Chrome trace): device busy "
              f"{busy:.3f} ms a tick (the union of {len(cuda)} device "
              f"events), {100 * busy / period:.1f} % of the {period:.0f} ms "
              f"period ({card})")
        check(cuda, "async: device_trace recorded no device events")
    return res


def async_phase(run_tube_mppi, rk, card) -> dict:
    """Phase 22: the async loop on the card (a)-(e)."""
    out = {"captured_vs_eager": async_captured_vs_eager(run_tube_mppi, card),
           "launches": async_launches(run_tube_mppi, rk, card)}
    for depth in (1, 2):
        out[f"depth{depth}"] = async_drive(
            run_tube_mppi, depth, card,
            trace_dir=os.path.join(HERE, "autorally_tpu_torch", "_build")
            if depth == 1 else None)
    return out


# -- phase 23: the realtime gates ---------------------------------------------

def gate_lines(tag, res, card) -> None:
    g = lambda k: res.get(k)
    print(f"[gate] {tag}: p50 {g('p50_ms')} ms, p99 {g('p99_ms')} ms "
          f"(budget {g('budget_ms')}), missed {g('missed')}, missed_raw "
          f"{g('missed_raw')}, valid {g('valid_ticks')} / {g('ticks')} ticks, "
          f"tainted {g('tainted_ticks')}, attempts {g('attempts_used')}, "
          f"p99 over all ticks {g('p99_all_ms')}; pacer {g('pacer')}; the "
          f"warm-up's first tick {g('first_tick_ms'):.3f} ms; captures in "
          f"the measured passes {g('captures')}, full collections in "
          f"measured ticks {g('full_collections')}; {g('weights')} ({card})")
    if "depth_final" in res:
        print(f"[gate] {tag}: harvest p50 / p99 {g('harvest_p50_ms')} / "
              f"{g('harvest_p99_ms')} ms, solution age p50 / p99 "
              f"{g('age_p50_s')} / {g('age_p99_s')} s, depth "
              f"{g('depth')} -> final {g('depth_final')} (max "
              f"{g('depth_max')}), p99 net of the harvest {g('p99_net_ms')} "
              f"ms, best attempt p99 {g('best_attempt_p99_ms')} ms ({card})")


def gate_passes(tag, res) -> None:
    """The JAX test's rules (tests/test_realtime_gate.py), without its
    skip, the native pacer, and no capture in the measured passes."""
    check(res["pacer"] == "native", f"gate {tag}: the loop paced with "
          f"{res['pacer']}, not the native pacer")
    check(res["valid_ticks"] >= 100, f"gate {tag}: {res['valid_ticks']} "
          f"valid ticks, fewer than 100")
    check(res["p99_ms"] < res["budget_ms"], f"gate {tag}: p99 "
          f"{res['p99_ms']} ms over the {res['budget_ms']} ms budget")
    check(res["missed"] == 0, f"gate {tag}: {res['missed']} missed")
    bound = 0 if res["tainted_ticks"] == 0 else res["tainted_ticks"] + 2
    check(res["missed_raw"] <= bound, f"gate {tag}: missed_raw "
          f"{res['missed_raw']} over {bound}")
    check(res["captures"] == 0, f"gate {tag}: {res['captures']} captures "
          f"in the measured passes")


def descendants() -> list:
    """The pids of this process's descendants (``/proc``)."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:                      # gone meanwhile
            continue
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [os.getpid()]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


@contextlib.contextmanager
def builds_paused(card):
    """The ``with`` block on a machine without this process's running
    builds: every descendant process then alive (the background ``nvcc``
    and its compilers; the block starts its own processes after) stopped
    (SIGSTOP) and continued (SIGCONT) after the block, so that a timing
    gate does not measure the compilers beside it."""
    import signal

    stopped = []
    for pid in descendants():
        try:
            os.kill(pid, signal.SIGSTOP)
            stopped.append(pid)
        except ProcessLookupError:
            pass
    print(f"[gate] {len(stopped)} build process(es) stopped for the gates "
          f"({card})")
    try:
        yield
    finally:
        for pid in stopped:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass


def gate_phase(rk, card) -> dict:
    """Phase 23: both realtime gates on the card, the simulator a second
    process (``sim_node --cpu``, seeded weights) over loopback UDP."""
    from autorally_tpu_torch.runtime import realtime_gate as gate

    rk.LAUNCHES.clear()
    t0 = time.perf_counter()
    seq = gate.run_realtime_gate(seconds=GATE_SECONDS,
                                 attempts=GATE_ATTEMPTS,
                                 warmup_iters=GATE_WARMUP)
    seq_s = time.perf_counter() - t0
    launches = {n: rk.LAUNCHES[n] for n in ("fused_exact_rollout_cost",
                                            "dynamics_chain")}
    gate_lines(f"sequential K={seq['num_rollouts']} "
               f"T={seq['num_timesteps']} with gains ({seq_s:.1f} s)", seq,
               card)
    # warm-up included: the sequential loop solves uncaptured, two solves
    # a tick, so the counters see every launch
    want = 2 * (GATE_WARMUP + seq["ticks"])
    print(f"[gate] sequential: launches {launches} over the warm-up's "
          f"{GATE_WARMUP} and "
          f"the passes' {seq['ticks']} ticks (expected {want} each)")
    check(all(v == want for v in launches.values()),
          f"gate sequential: launches {launches}, expected {want} each")
    t0 = time.perf_counter()
    asy = gate.run_realtime_gate_async(seconds=GATE_SECONDS,
                                       attempts=GATE_ATTEMPTS, depth=2,
                                       adaptive_depth=True)
    asy_s = time.perf_counter() - t0
    gate_lines(f"async K={asy['num_rollouts']} T={asy['num_timesteps']} "
               f"with gains, depth 2 adaptive ({asy_s:.1f} s)", asy, card)
    gate_passes("sequential", seq)
    gate_passes("async", asy)
    keep = ("p50_ms", "p99_ms", "missed", "missed_raw", "valid_ticks",
            "tainted_ticks", "ticks", "first_tick_ms", "captures",
            "full_collections", "harvest_p50_ms", "harvest_p99_ms",
            "age_p50_s", "age_p99_s", "depth_final", "depth_max",
            "p99_net_ms")
    return {"sequential": {k: seq[k] for k in keep if k in seq},
            "async": {k: asy[k] for k in keep if k in asy}}


# -- phase 24: the general rollout path --------------------------------------

def doubled_speed_cost():
    """A cost subclass that overrides one term (the speed cost, doubled),
    so that the epilogue's dispatch through the subclass shows."""
    from autorally_tpu_torch.costs import MPPICost

    class DoubledSpeed(MPPICost):
        def speed_cost_c(self, p, ux):
            return 2.0 * super().speed_cost_c(p, ux)

    return DoubledSpeed()


def ensemble_members(base_params, num_members: int, noise: float = 0.05):
    """BASELINE #5's members as ``__graft_entry__.py`` builds them, stacked:
    member 0 the base, every other the base plus ``noise`` N(0, 1) from
    ``RandomState(0)`` (drawn for member 0 too, weights then biases)."""
    import torch
    from autorally_tpu_torch.models.ensemble import stack_params

    rng = np.random.RandomState(0)
    members = []
    for m in range(num_members):
        scale = 0.0 if m == 0 else noise
        plus = [[x + scale * torch.as_tensor(
            rng.randn(*x.shape).astype(np.float32), device=x.device)
            for x in base_params[name]] for name in ("weights", "biases")]
        members.append({"weights": plus[0], "biases": plus[1],
                        "control_rngs": base_params["control_rngs"]})
    return stack_params(members)


def replayed_tick_ms(runner, args) -> tuple:
    """(p50, p99) of the device time of each replayed tick of a run of the
    captured ``runner`` (CUDA events around each replay; the run captures
    first when it has to)."""
    import torch

    runner.run(*args)
    plan = runner._captured
    graph, events = plan.graph, []

    class Timed:
        def replay(self):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            events.append((e0, e1))

    plan.graph = Timed()
    try:
        runner.run(*args)
    finally:
        plan.graph = graph
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def chain_row(rk, name, model, params, cfg, start, U, eps, bf, err, card,
              launches) -> dict:
    """The ``kernels`` row of kernel 2 at ``eps``'s K: its time in the
    launcher's geometry, its plain version's, its bound (each input read
    once, states and u_seq written once; the MLP's or the BF step's
    operations)."""
    K_n = eps.shape[1]
    chain = chain_timing(rk, name, model, params, cfg, start, U, eps, bf, 100,
                         card)
    plain = cuda_ms(lambda: rk.dynamics_chain_plain(model, params, cfg,
                                                    start, U, eps), PLAIN_REPS, 0)
    n_w = rk.KERNEL_BF_WEIGHTS if bf else rk.KERNEL_NUM_WEIGHTS
    step = BF_STEP_OPS if bf else mlp_flops(model.layers)
    bnd, by = bound(4 * (11 * T * K_n + 2 * T + n_w + 7 + 4), step * T * K_n)
    print(f"[timing] {name} K={K_n}: {chain['ms']:.4f} ms, plain "
          f"{plain:.3f} ms, bound {bnd:.5f} ms ({by}) ({card})")
    return {"name": name, "route": "cuda",
            "source": "autorally_tpu_torch/csrc/rollout_kernels.cu",
            "replaces": "autorally_tpu/ops/rollout_kernel.py:389",
            "launches": launches, "max_abs_err": err, "ms": chain["ms"],
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "K": K_n, **chain_entry(chain)}


def general_phase(drive_oval, rk, card, dev=None) -> dict:
    """Phase 24: the general rollout path, (a) kernel 2 at K against its
    plain version, (b) a cost subclass at BASELINE #1 through kernel 2 and
    the batched epilogue, (c) ``EnsembleDynamics`` through ``MPPISolver``
    (the plain chain, no kernel), eager and captured."""
    import torch

    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.models import EnsembleDynamics
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.lap_eval import load_track

    dev = torch.device("cuda", 0) if dev is None else dev
    solver, params, cost_params, costmap, _ = drive_oval.build(
        rollouts=K, device=dev)
    cfg, model = solver.cfg, solver.model
    bsolver, bparams, *_ = drive_oval.build(model="bf", device=dev)
    bcfg, bmodel = bsolver.cfg, bsolver.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    eps = torch.randn((T, K, 2), generator=gen, device=dev)
    eps_b = torch.randn((T, KB, 2), generator=gen, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    out = {}

    # (a) kernel 2 at the general path's K (phases 3 and 15 hold both of
    # its geometries on their cases; here the row's inputs)
    errs = {}
    for tag, (mdl, prm, ccfg, e) in {
            "dynamics_chain": (model, params, cfg, eps),
            "dynamics_chain_bf": (bmodel, bparams, bcfg, eps_b)}.items():
        ks, ku = rk.dynamics_chain(mdl, prm, ccfg, start, U, e)
        ps, pu = rk.dynamics_chain_plain(mdl, prm, ccfg, start, U, e)
        torch.cuda.synchronize()
        errs[tag] = (ks - ps).abs().max().item()
        print(f"[general path] {tag} K={e.shape[1]} against its plain "
              f"version: max|state err| {errs[tag]:.3e}, u_seq equal "
              f"{torch.equal(ku, pu)}")
        check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
              f"general path {tag}: states differ")
        check(torch.equal(ku, pu), f"general path {tag}: u_seq differs")

    # (b) a cost subclass: kernel 2 and the epilogue against the plain
    # chain and the epilogue, the doubled term showing; a subclass that
    # overrides nothing against kernel 1
    sub = MPPISolver(model, doubled_speed_cost(), cfg, device=dev)
    check(sub.kernel_form and not sub._fusable_cost(),
          "general path: the subclass's solver does not take the chain")
    tot, u_seq, crash = sub.rollout_costs(params, cost_params, costmap,
                                          start, U, eps)
    ps, pu = rk.dynamics_chain_plain(model, params, cfg, start, U, eps)
    ptot, pcrash = sub._cost_epilogue(params, cost_params, costmap, eps, ps,
                                      pu)
    fused = solver.rollout_costs(params, cost_params, costmap, start, U, eps)

    class Same(MPPICost):
        pass

    same = MPPISolver(model, Same(), cfg, device=dev).rollout_costs(
        params, cost_params, costmap, start, U, eps)
    torch.cuda.synchronize()
    e_sub = (tot - ptot).abs().max().item()
    e_same = (same[0] - fused[0]).abs().max().item()
    n_crash = int((crash != pcrash).sum().item())
    n_same = int((same[2] != fused[2]).sum().item())
    print(f"[general path] a cost subclass (speed cost doubled) K={K}: "
          f"kernel 2 + epilogue against the plain chain + epilogue max|cost "
          f"err| {e_sub:.3e}, crash mismatches {n_crash} "
          f"({int(crash.sum().item())} crashed); a subclass overriding "
          f"nothing against kernel 1: max|cost err| {e_same:.3e}, crash "
          f"mismatches {n_same}; the doubled term moves the mean cost "
          f"{fused[0].mean().item():.4g} -> {tot.mean().item():.4g}")
    check(torch.allclose(tot, ptot, rtol=COST_RTOL, atol=COST_ATOL),
          "general path: the subclass's costs differ from the plain chain's")
    check(n_crash == 0 and torch.equal(u_seq, pu),
          "general path: the subclass's crash flags or u_seq differ")
    check(torch.allclose(same[0], fused[0], rtol=COST_RTOL, atol=COST_ATOL)
          and n_same == 0 and torch.equal(same[1], fused[1]),
          "general path: an unchanged subclass differs from kernel 1")
    check(not torch.allclose(tot, fused[0], rtol=1e-3),
          "general path: the doubled speed cost does not show")

    # the closed loops: 2 kernel-2 launches a solve (K and the nominal
    # trajectory's K=1), no kernel 1, no plain version
    by_k = {}
    for tag, (slv, prm, ticks, name, k_n) in {
            "general path": (sub, params, GEN_TICKS, "dynamics_chain", K),
            "general path bf": (MPPISolver(bmodel, doubled_speed_cost(), bcfg,
                                           device=dev), bparams, GEN_BF_TICKS,
                                "dynamics_chain_bf", KB)}.items():
        rk.LAUNCHES_BY_K.clear()
        latency, _, _ = drive_counted(drive_oval, rk, tag, slv, prm,
                                      cost_params, costmap, ticks,
                                      {name: 2}, card)
        by_k[name] = dict(rk.LAUNCHES_BY_K)
        want = {(name, k_n): ticks + 1, (name, 1): ticks + 1}
        print(f"[{tag}] launches by K: {by_k[name]}")
        check(by_k[name] == want, f"{tag}: launches by K {by_k[name]}, "
              f"expected {want}")
        out[tag] = latency
    rows = [chain_row(rk, "dynamics_chain_general", model, params, cfg,
                      start, U, eps, False, errs["dynamics_chain"], card,
                      by_k["dynamics_chain"][("dynamics_chain", K)]),
            chain_row(rk, "dynamics_chain_bf_general", bmodel, bparams, bcfg,
                      start, U, eps_b, True, errs["dynamics_chain_bf"], card,
                      by_k["dynamics_chain_bf"][("dynamics_chain_bf", KB)])]
    del eps_b, ps, pu

    # (c) EnsembleDynamics through MPPISolver: the solver's plain chain
    ens = MPPISolver(EnsembleDynamics(model, ENS_M), MPPICost(), cfg,
                     device=dev)
    stacked = ensemble_members(params, ENS_M)
    check(not ens.kernel_form, "EnsembleDynamics took a kernel form")
    out["ensemble_dynamics_eager"], _, _ = drive_counted(
        drive_oval, rk, "EnsembleDynamics plain chain", ens, stacked,
        cost_params, costmap, GEN_ENS_TICKS, {}, card)
    cm, start_pose, _, _ = load_track("oval", device=dev)
    args = (stacked, cost_params, cm,
            [start_pose[0], start_pose[1], start_pose[2], 0, 0, 0, 0])
    runner = EpisodeRunner(ens, n_ticks=GEN_ENS_TICKS)
    with PlainCalls(rk) as plain:
        rk.LAUNCHES.clear()
        episode_held(f"EnsembleDynamics (M={ENS_M}) plain chain", runner,
                     args)
        tick = replayed_tick_ms(runner, args)
    print(f"[general path] EnsembleDynamics (M={ENS_M}) K={K} episode: "
          f"{GEN_ENS_TICKS} replayed ticks (two solves and the plant each) "
          f"p50 {tick[0]:.3f} ms p99 {tick[1]:.3f} ms (CUDA events around "
          f"each replay); rollout-kernel launches {dict(rk.LAUNCHES)}, "
          f"plain-version calls {plain.calls} ({card})")
    check(not rk.LAUNCHES and not any(plain.calls.values()),
          "EnsembleDynamics episode: a rollout kernel or plain version ran")
    out["ensemble_dynamics_episode_tick"] = tick
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernels": rows, "latency": out}


# -- phase 25: the ensemble solver -------------------------------------------

def member_row(rk, ens, stacked, cfg, cm, cp, state, U, eps, err, card,
               launches) -> dict:
    """The ``kernels`` row of kernel 1 at an ensemble member's K/M (the
    last member's block, the pure-noise band's): its time, its plain
    version's and its bound (as phase 5's at this K)."""
    from autorally_tpu_torch.models.ensemble import member_params

    M = ens.num_members
    k_m = eps.shape[1] // M
    base = ens._base_solver.model
    pm = member_params(stacked, M - 1)
    e_m = eps[:, (M - 1) * k_m:].contiguous()
    kw = dict(k_offset=(M - 1) * k_m)
    launch, _ = rk.prepare_fused_exact_rollout_cost(
        base, pm, cfg, cp, cm, state, U, e_m, **kw,
        packed_weights=ens._member_packs(stacked)[M - 1])
    ms = cuda_ms(launch, 100)
    plain = cuda_ms(lambda: rk.fused_rollout_cost_plain(
        base, pm, cfg, cp, cm, state, U, e_m, **kw), PLAIN_REPS, 0)
    n_w = rk.KERNEL_NUM_WEIGHTS
    bnd, by = bound(4 * (T * k_m * 2 + 2 * T * k_m + 2 * k_m + T * 2 + n_w
                         + 7 + 4 + 2 * k_m * (T - 1)),
                    mlp_flops(base.layers) * k_m * T)
    print(f"[timing] fused_exact_rollout_cost K/M={k_m} (member {M - 1} of "
          f"{M}, k_offset {(M - 1) * k_m}): {ms:.4f} ms in "
          f"{geometry_label(launch.geometry)}, plain {plain:.3f} ms, bound "
          f"{bnd:.5f} ms ({by}) ({card})")
    return {"name": f"fused_exact_rollout_cost_member_K{k_m}",
            "route": "cuda",
            "source": "autorally_tpu_torch/csrc/rollout_kernels.cu",
            "replaces": "autorally_tpu/ops/rollout_kernel.py:1013",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "K": k_m,
            "geometry": geometry_label(launch.geometry)}


def ensemble_phase(rk, card, dev=None) -> dict:
    """Phase 25: ``EnsembleMPPISolver`` at bench.py's two ensemble rows
    (M=8, K=16384 and 65536, T=100, BASELINE #5's members on the exact
    oval): (a) identical members bit for bit ``MPPISolver``, (b) against the
    plain versions, (c) 100 chained solves, (d) ``tools/ensemble_ab.py``
    through the captured episode."""
    import torch

    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.costs import MPPICost, make_costmap
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.models.ensemble import (member_params,
                                                     stack_params)
    from autorally_tpu_torch.solver import EnsembleMPPISolver, MPPISolver
    from autorally_tpu_torch.tools import ensemble_ab
    from autorally_tpu_torch.tools import track_generator as tg

    dev = torch.device("cuda", 0) if dev is None else dev
    data, xb, yb = tg.oval_track(ppm=4.0)
    cm = make_costmap(data, xb, yb, device=dev)
    cp = CostParams()
    state = np.array(ENS_START, np.float32)
    state_t = torch.tensor(state, device=dev)
    rows, out = [], {}
    for k_tot in ENS_KS:
        cfg = MPPIConfig(num_rollouts=k_tot, num_timesteps=T)
        base = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                                 device=dev)
        p0 = base.init_params(0)
        stacked = ensemble_members(p0, ENS_M)
        ens = EnsembleMPPISolver(base, MPPICost(cfg.l1_cost), cfg,
                                 num_members=ENS_M, device=dev)
        single = MPPISolver(base, MPPICost(cfg.l1_cost), cfg, device=dev)
        k_m = k_tot // ENS_M
        tag = f"ensemble M={ENS_M} K={k_tot}"

        # (a) M identical members: MPPISolver's solve, bit for bit
        cs_e, st_e = ens.solve(stack_params([p0] * ENS_M), cp, cm, state,
                               ens.init_state())
        cs_s, st_s = single.solve(p0, cp, cm, state, single.init_state())
        torch.cuda.synchronize()
        same = {f: bit_equal(getattr(cs_e, f), getattr(cs_s, f)) for f in
                ("U", "state_solution", "control_solution")}
        same.update({f: bit_equal(getattr(st_e, f), getattr(st_s, f))
                     for f in st_e._fields})
        print(f"[{tag}] {ENS_M} identical members against MPPISolver at "
              f"K={k_tot}, bit for bit: {same}")
        check(all(same.values()), f"{tag}: identical members differ from "
              f"MPPISolver in {[f for f, v in same.items() if not v]}")

        # (b) against the plain versions, member by member.  As phase 2
        # does on its random map: a moving swarm on 25 cm texels, where the
        # plain chain's fp32 rounding (another summation order in the MLP)
        # moves a few rollouts' lookups across a texel edge, so kernel 1 is
        # held against the plain cost along kernel 2's trajectories in
        # every rollout, and at most 1 % of the rollouts may differ from
        # the whole plain version
        eps = ens._draw(cm, np.array([13, k_tot], np.uint32))
        U = ens.init_state().U
        tot, u_seq, crash = ens.rollout_costs(stacked, cp, cm, state_t, U,
                                              eps)
        along, whole = [], []
        for m in range(ENS_M):
            pm, kw = member_params(stacked, m), dict(k_offset=m * k_m)
            e_m = eps[:, m * k_m:(m + 1) * k_m].contiguous()
            kb, _ = rk.dynamics_chain(base, pm, cfg, state_t, U, e_m, **kw)
            along.append(rk.trajectory_cost_plain(base, pm, cfg, cp, cm, U,
                                                  e_m, kb, **kw))
            whole.append(rk.fused_rollout_cost_plain(base, pm, cfg, cp, cm,
                                                     state_t, U, e_m, **kw))
        ptot = torch.cat([p[0] for p in along])
        pcrash = torch.cat([p[1] for p in along])
        wtot = torch.cat([p[0] for p in whole])
        pu = torch.cat([p[1] for p in whole], dim=2)
        ns, _ = ens.nominal_trajectory(stacked, state_t, U)
        ps = rk.dynamics_chain_plain(base, member_params(stacked, 0), cfg,
                                     state_t, U, torch.zeros_like(eps[:, :1]))
        ps = torch.cat([state_t[None], ps[0][:, :, 0].T[:-1]])
        torch.cuda.synchronize()
        err = (tot - ptot).abs().max().item()
        n_crash = int((crash != pcrash).sum().item())
        n_differ = int((~torch.isclose(tot, wtot, rtol=COST_RTOL,
                                       atol=COST_ATOL)).sum().item())
        e_nom = (ns - ps).abs().max().item()
        print(f"[{tag}] against the plain versions (kernel 1 a member at "
              f"K/M={k_m}): along kernel 2's trajectories max|cost err| "
              f"{err:.3e}, crash mismatches {n_crash} "
              f"({int(crash.sum().item())} crashed); {n_differ} rollouts "
              f"differ from the whole plain version (max|cost err| "
              f"{(tot - wtot).abs().max().item():.3e}); u_seq equal "
              f"{torch.equal(u_seq, pu)}; nominal (member 0, kernel 2 K=1) "
              f"max|state err| {e_nom:.3e}")
        check(torch.allclose(tot, ptot, rtol=COST_RTOL, atol=COST_ATOL)
              and n_crash == 0 and torch.equal(u_seq, pu),
              f"{tag}: the members' kernels differ from the plain versions")
        check(n_differ <= k_tot // 100, f"{tag}: {n_differ} rollouts differ "
              f"from the whole plain version, more than {k_tot // 100}")
        check(torch.allclose(ns, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
              f"{tag}: the nominal trajectory differs")
        del along, whole, pu

        # (c) chained solves: latency (a sync after each), throughput (one
        # sync after all), peak memory, launches by K
        cs = ens.init_state()
        cs, _ = ens.solve(stacked, cp, cm, state, cs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**20
        rk.LAUNCHES.clear()
        rk.LAUNCHES_BY_K.clear()
        with PlainCalls(rk) as calls:
            ms = []
            for _ in range(ENS_SOLVES):
                t0 = time.perf_counter()
                cs, st = ens.solve(stacked, cp, cm, state, cs)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for _ in range(ENS_SOLVES):
                cs, st = ens.solve(stacked, cp, cm, state, cs)
            torch.cuda.synchronize()
            rate = ENS_SOLVES / (time.perf_counter() - t0)
        # the solves' own peak, above what was allocated before them (the
        # stacked weights, the pack, and what earlier phases hold)
        peak = torch.cuda.max_memory_allocated() / 2**20 - held
        by_k = dict(rk.LAUNCHES_BY_K)
        n = 2 * ENS_SOLVES
        want = {("fused_exact_rollout_cost", k_m): ENS_M * n,
                ("dynamics_chain", 1): n}
        lat = (float(np.percentile(ms, 50)), float(np.percentile(ms, 99)))
        print(f"[{tag}] {ENS_SOLVES} chained solves: p50 {lat[0]:.3f} ms p99 "
              f"{lat[1]:.3f} ms (a sync after each, host clock); "
              f"{rate:.1f} solves/s ({ENS_SOLVES} back to back, one sync); "
              f"peak device memory {peak:.1f} MiB above the {held:.1f} "
              f"allocated before the solves; launches by K over "
              f"{n} solves {by_k}; plain-version calls {calls.calls}; ess "
              f"{st.ess.item():.1f}, crash% {st.crash_frac.item() * 100:.1f} "
              f"({card})")
        check(by_k == want, f"{tag}: launches {by_k}, expected {want}")
        check(not any(calls.calls.values()), f"{tag}: a plain version ran")
        check(torch.isfinite(cs.U).all().item(), f"{tag}: non-finite U")
        out[f"K{k_tot}"] = {"solve_ms_p50_p99": lat, "solves_per_s": rate,
                            "peak_mib": peak, "held_mib": held}
        rows.append(member_row(rk, ens, stacked, cfg, cm, cp, state_t, U,
                               eps, err, card,
                               by_k[("fused_exact_rollout_cost", k_m)]))
        del ens, single, stacked, eps, cs
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the A/B tool through the captured episode
    args = ensemble_ab.parse_args(AB_ARGS)
    config, arms, run_args = ensemble_ab.build(args, dev)
    ab = {"config": config, "single": [], "ensemble": []}
    per_tick = {"single": {"fused_exact_rollout_cost": 2,
                           "dynamics_chain": 2},
                "ensemble": {"fused_exact_rollout_cost": 2 * args.members,
                             "dynamics_chain": 2}}
    for arm, runner, p_ctrl in arms:
        ep = (p_ctrl, *run_args[:3])
        kw = dict(params_true=run_args[3], seed_a=0, seed_p=1)
        rk.LAUNCHES.clear()
        with PlainCalls(rk) as calls:
            cap = runner.run(*ep, **kw)      # an eager tick, the capture
            ticked = {n: v / 2 for n, v in rk.LAUNCHES.items()}
            eag = runner.run(*ep, eager=True, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            runner.run(*ep, **kw)
            e1.record()
            torch.cuda.synchronize()
        bits = episode_equal(cap, eag)
        tick_ms = e0.elapsed_time(e1) / args.ticks
        print(f"[ensemble_ab] {arm}: {args.ticks} ticks captured bit for bit "
              f"the eager run {bits}; launches a tick {ticked}; "
              f"{tick_ms:.4f} ms a replayed tick (CUDA events, noise staging "
              f"included); plain-version calls {calls.calls} ({card})")
        check(bits, f"ensemble_ab {arm}: the captured run differs")
        check(ticked == per_tick[arm], f"ensemble_ab {arm}: launches a tick "
              f"{ticked}, expected {per_tick[arm]}")
        check(not any(calls.calls.values()), f"ensemble_ab {arm}: a plain "
              "version ran")
        ab[arm].append(ensemble_ab.run_arm(runner, p_ctrl, *run_args[:4], 0,
                                           *run_args[4:]))
        out[f"ab_{arm}"] = {"launches_per_tick": ticked,
                            "ms_per_tick": tick_ms}
        del cap, eag
    print(f"[ensemble_ab] {json.dumps(ensemble_ab.summarize(ab))}")
    out["ab"] = {arm: ab[f"{arm}_summary"] for arm in ("single", "ensemble")}
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernels": rows, "results": out}


# -- phase 26: the sharded solvers on the card --------------------------------

# the sharded iteration against the single-process one on the same noise
# (tests/test_sharding.py's tolerances: fp32 sums over shards in another
# order)
SHARD_RTOL, SHARD_ATOL, SHARD_BASELINE_RTOL = 1e-4, 1e-5, 1e-5
SHARD_SOLVES = 20                     # (a), (b): chained solves a rank
SHARD_CAP_SOLVES = 10                 # (c), (d)
SHARD_ENS_K, SHARD_ENS_M, SHARD_ENS_R = 16384, 2, 2
SHARD_SUB = (0x0BADF00D, 0x5EED1234)  # the iteration's subkey
RANK_TIMEOUT = 300
# two processes load the kernel library from a fresh build cache at once
COLD_LOADER = (
    "import sys, time\n"
    "from autorally_tpu_torch.io.compile_cache import "
    "enable_persistent_cache\n"
    "from autorally_tpu_torch.ops import _build\n"
    "enable_persistent_cache(sys.argv[1])\n"
    "t0 = time.perf_counter()\n"
    "lib = _build.load()\n"
    "print('built' if lib.build else 'loaded',\n"
    "      f'{time.perf_counter() - t0:.1f}', lib._name)\n")


def shard_spec(params, U, cfg_kw=None, **kw) -> dict:
    """``sharded_program``'s spec of the main path's configuration
    (``drive_oval.build``'s map, cost params, start and weights)."""
    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.parallel.launch import to_numpy
    from autorally_tpu_torch.tools import track_generator as tg

    return dict(cfg={"num_rollouts": K, "num_timesteps": T, **(cfg_kw or {})},
                params=to_numpy(params),
                costmap=tg.oval_track(half_length=30.0, half_width=18.0,
                                      track_width=6.0, ppm=10.0),
                cost_params=dict(desired_speed=6.0),
                state=np.array(drive_oval.START, np.float32),
                U=U.cpu().numpy(), sub=np.array(SHARD_SUB, np.uint32), **kw)


def ranks_equal(results) -> bool:
    """Every rank's iteration U and stats and last controller state bit for
    bit rank 0's."""
    first = results[0]
    return all(
        np.array_equal(r["U"], first["U"])
        and all(np.array_equal(r["stats"][f], v)
                for f, v in first["stats"].items())
        and all(np.array_equal(r["solve"][f], first["solve"][f])
                for f in ("U", "state_solution", "control_solution"))
        for r in results[1:])


def held_on_shard(rk, tag, model, params, cfg, cp, cm, start, U, eps,
                  k_offset, shard) -> float:
    """A rank's kernel-1 or pass-1 costs and crash flags (``shard``) at
    ``k_offset`` against the plain cost along kernel 2's trajectories on
    the shard's noise ``eps`` in every rollout, and against the whole
    plain version in all but 1 % (as phase 7 holds a shard's slice: a
    rounding of the MLP's sums can move a lookup across a texel edge).
    Returns the max cost error of the first."""
    import torch

    kc = torch.as_tensor(shard["total"], device=eps.device)
    kx = torch.as_tensor(shard["crash"], device=eps.device)
    kb, _ = rk.dynamics_chain(model, params, cfg, start, U, eps,
                              k_offset=k_offset)
    bc, bx = rk.trajectory_cost_plain(model, params, cfg, cp, cm, U, eps, kb,
                                      k_offset=k_offset)
    del kb
    err = agreement(f"{tag} along kernel 2", "shard", kc, kx, bc, bx,
                    eps.shape[1], limit=0)
    pc, _, px = rk.fused_rollout_cost_plain(model, params, cfg, cp, cm,
                                            start, U, eps, k_offset=k_offset)
    agreement(tag, "shard", kc, kx, pc, px, eps.shape[1])
    return err


def start_cold_loaders():
    """Two processes that load the kernel library at once from a fresh
    persistent cache (phase 27 reads them): (directory, processes)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="artpu_cold_cache_")
    procs = [subprocess.Popen([sys.executable, "-c", COLD_LOADER, tmp],
                              cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    return tmp, procs


def stop_cold_loaders(cold) -> None:
    """Stop the loaders still running and remove their directory."""
    import shutil

    tmp, procs = cold
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=60)



def sharded_phase(drive_oval, rk, card, dev=None) -> dict:
    """Phase 26: (a) one NCCL rank, forced collectives against the inline
    body and ``MPPISolver``; (b) 2 and 4 gloo ranks sharing the card, host
    noise; (c) the capacity mode over 2 gloo ranks at K=262144, gaussian
    and OU; (d) ``EnsembleShardedMPPISolver`` on a 2 x 2 mesh."""
    import torch

    from autorally_tpu_torch.config import MPPIConfig, effective_gamma
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import kernel_rng
    from autorally_tpu_torch.parallel import launch
    from autorally_tpu_torch.parallel.launch import to_numpy
    from autorally_tpu_torch.solver import EnsembleMPPISolver

    dev = torch.device("cuda", 0) if dev is None else dev
    check(_build.load() is not None, "the kernel library did not load")
    solver, params, cp, cm, _ = drive_oval.build(rollouts=K, device=dev)
    cfg, model = solver.cfg, solver.model
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    sub = np.array(SHARD_SUB, np.uint32)
    cards = torch.cuda.device_count()
    out, rows = {}, []
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"

    def run(n, backend, specs):
        """Each spec's results on ``n`` ranks (a list over ranks each)."""
        t0 = time.perf_counter()
        res = launch.run(launch.sharded_programs, n, (specs,),
                         backend=backend, device="cuda",
                         timeout=RANK_TIMEOUT)
        builds = sum(r["built_here"] for rr in res for r in rr)
        print(f"[sharded] {n} rank(s) over {backend} on {cards} card(s) "
              f"({-(-n // cards)} a card): {len(specs)} sharded run(s) in "
              f"{time.perf_counter() - t0:.1f} s, spawn and CUDA start-up "
              f"included; kernel builds inside the ranks {builds}")
        check(builds == 0, f"{n} ranks: a rank built the kernel library")
        return [[rr[i] for rr in res] for i in range(len(specs))]

    def t(x):
        return torch.as_tensor(x, device=dev)

    def p50_p99(ms):
        return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))

    def shard_noise(n, key_of):
        """(T, K_local, 2) host noise of each of ``n`` shards, keyed by
        ``key_of(i)``."""
        return [solver._sample_noise(solver._noise_generator(key_of(i)),
                                     (T, K // n, 2)) for i in range(n)]

    # (a) one rank over NCCL: the forced collectives against the inline
    # body, the inline body against MPPISolver on fold_in(sub, 0)'s noise
    (a,) = run(1, "nccl", [shard_spec(params, U, force_collectives=True,
                                      reference=True, solves=SHARD_SOLVES)])
    r = a[0]
    ref = r["reference"]
    forced_inline = (np.array_equal(r["U"], ref["U"])
                     and all(np.array_equal(v, ref["stats"][f])
                             for f, v in r["stats"].items())
                     and all(np.array_equal(r["solve"][f], ref["solve"][f])
                             for f in ("U", "state_solution",
                                       "control_solution")))
    inline_single = (np.array_equal(ref["U"], r["single"]["U"])
                     and all(np.array_equal(v, r["single"]["stats"][f])
                             for f, v in ref["stats"].items()))
    want = [("dynamics_chain", 1, SHARD_SOLVES),
            ("fused_exact_rollout_cost", K, SHARD_SOLVES)]
    lat_f, lat_i = p50_p99(r["solve"]["ms"]), p50_p99(ref["solve"]["ms"])
    print(f"[sharded] (a) one NCCL rank, K={K} T={T}: forced collectives bit "
          f"for bit the inline body (iteration and {SHARD_SOLVES} chained "
          f"solves) {forced_inline}; the inline body bit for bit "
          f"MPPISolver.iterate on fold_in(sub, 0)'s noise {inline_single}; "
          f"launches an iteration {r['launches']}, over the solves "
          f"{r['solve']['launches_by_k']} (inline "
          f"{ref['solve']['launches_by_k']}); solve p50 / p99 {lat_f[0]:.3f}"
          f" / {lat_f[1]:.3f} ms with the collectives, {lat_i[0]:.3f} / "
          f"{lat_i[1]:.3f} ms inline (a sync after each, host clock; "
          f"{card})")
    check(forced_inline, "(a) the forced collectives differ from the inline "
          "body")
    check(inline_single, "(a) the inline body differs from MPPISolver")
    check(r["launches"] == {"fused_exact_rollout_cost": 1},
          f"(a) launches an iteration {r['launches']}")
    check(r["solve"]["launches_by_k"] == want
          and ref["solve"]["launches_by_k"] == want,
          f"(a) launches over the solves, expected {want}")
    out["nccl_1"] = {"forced_ms_p50_p99": lat_f, "inline_ms_p50_p99": lat_i}

    # (b)-(d) on gloo ranks that share the card: 2 ranks run the host-noise
    # solve and the capacity mode, 4 ranks the host-noise solve and the
    # ensemble
    cap_cfg = {s: cfg.replace(num_rollouts=KC, kernel_rng=True, **kw)
               for s, kw in SAMPLERS.items()}
    ens_cfg = cfg.replace(num_rollouts=SHARD_ENS_K)
    stacked = ensemble_members(params, SHARD_ENS_M)
    host = shard_spec(params, U, solves=SHARD_SOLVES)
    two = run(2, "gloo", [host] + [
        shard_spec(params, U, dict(num_rollouts=KC, kernel_rng=True, **kw),
                   solves=SHARD_CAP_SOLVES) for kw in SAMPLERS.values()])
    four = run(4, "gloo", [host, shard_spec(
        stacked, U, dict(num_rollouts=SHARD_ENS_K),
        mesh=(SHARD_ENS_M, SHARD_ENS_R), solves=SHARD_CAP_SOLVES)])

    # (b) host noise, K=1920 over 2 and 4 ranks
    for n, res in ((2, two[0]), (4, four[0])):
        Kl = K // n
        offs = [x["k_offset"] for x in res]
        eps = shard_noise(n, lambda i: kernel_rng.fold_in(sub, i))
        U_s, st_s = solver.iterate(params, cp, cm, start, U,
                                   torch.cat(eps, dim=1))
        e_U = (t(res[0]["U"]) - U_s).abs().max().item()
        ok_U = torch.allclose(t(res[0]["U"]), U_s, rtol=SHARD_RTOL,
                              atol=SHARD_ATOL)
        ok_b = bool(np.isclose(res[0]["stats"]["baseline"],
                               st_s.baseline.item(), rtol=SHARD_BASELINE_RTOL,
                               atol=0.0))
        errs = [held_on_shard(
            rk, f"sharded (b) {n} ranks: kernel 1 of rank {i} K_local={Kl} "
            f"k_offset={offs[i]}", model, params, cfg, cp, cm, start, U,
            eps[i], offs[i], x["shard"]) for i, x in enumerate(res)]
        want = [("dynamics_chain", 1, SHARD_SOLVES),
                ("fused_exact_rollout_cost", Kl, SHARD_SOLVES)]
        lat = p50_p99(res[0]["solve"]["ms"])
        same = ranks_equal(res)
        print(f"[sharded] (b) {n} gloo ranks on one card, K={K} (K_local "
              f"{Kl}, k_offsets {offs}), host noise: against MPPISolver."
              f"iterate on the shards' noise max|U err| {e_U:.3e} (rtol "
              f"{SHARD_RTOL}, atol {SHARD_ATOL}), baseline "
              f"{float(res[0]['stats']['baseline']):.6g} vs "
              f"{st_s.baseline.item():.6g}; ranks bit for bit equal {same}; "
              f"launches a rank over {SHARD_SOLVES} solves "
              f"{[x['solve']['launches_by_k'] for x in res]}; solve p50 / "
              f"p99 {lat[0]:.3f} / {lat[1]:.3f} ms (rank 0, a sync after "
              f"each, host clock; {card})")
        check(offs == [i * Kl for i in range(n)], f"(b) k_offsets {offs}")
        check(ok_U and ok_b, f"(b) {n} ranks differ from MPPISolver.iterate")
        check(same, f"(b) {n} ranks: the replicas differ")
        check(all(x["solve"]["launches_by_k"] == want for x in res),
              f"(b) {n} ranks: launches, expected {want} a rank")
        out[f"gloo_{n}"] = {"solve_ms_p50_p99": lat, "max_U_err": e_U}
        if n == 2:
            # kernel 1 on rank 1's slice: K_local 960 at k_offset 960
            kw = dict(k_offset=offs[1])
            launch1, _ = rk.prepare_fused_exact_rollout_cost(
                model, params, cfg, cp, cm, start, U, eps[1], **kw)
            ms = cuda_ms(launch1, 100)
            plain = cuda_ms(lambda: rk.fused_rollout_cost_plain(
                model, params, cfg, cp, cm, start, U, eps[1], **kw), PLAIN_REPS, 0)
            n_w = rk.KERNEL_NUM_WEIGHTS
            bnd, by = bound(4 * (T * Kl * 2 + 2 * T * Kl + 2 * Kl + T * 2
                                 + n_w + 7 + 4 + 2 * Kl * (T - 1)),
                            mlp_flops(model.layers) * Kl * T)
            print(f"[timing] fused_exact_rollout_cost K_local={Kl} k_offset="
                  f"{offs[1]} (rank 1 of 2): {ms:.4f} ms in "
                  f"{geometry_label(launch1.geometry)}, plain {plain:.3f} "
                  f"ms, bound {bnd:.5f} ms ({by}) ({card})")
            rows.append({
                "name": f"fused_exact_rollout_cost_shard_K{Kl}",
                "route": "cuda", "source": src,
                "replaces": "autorally_tpu/ops/rollout_kernel.py:1013",
                "launches": {(nm, k_): v for nm, k_, v in res[1]["solve"][
                    "launches_by_k"]}.get(("fused_exact_rollout_cost", Kl),
                                          0),
                "max_abs_err": errs[1], "ms": ms, "plain_ms": plain,
                "bound_ms": bnd, "bound_by": by, "library_ms": None,
                "K": Kl, "k_offset": offs[1],
                "geometry": geometry_label(launch1.geometry)})

    # (c) the capacity mode over 2 ranks, K=262144 (K_local 131072)
    Kl = KC // 2
    flops_step = mlp_flops(model.layers)
    n_w = rk.KERNEL_NUM_WEIGHTS
    for (sname, c), res in zip(cap_cfg.items(), two[1:]):
        offs = [x["k_offset"] for x in res]
        keys = [torch.from_numpy(kernel_rng.fold_in(sub, i).astype(np.int64))
                .to(dev) for i in range(2)]
        eta = sum(float(np.sum(np.exp(-effective_gamma(c, cp) * (
            x["shard"]["total"].astype(np.float64)
            - float(res[0]["stats"]["baseline"]))))) for x in res)
        err1 = err2 = 0.0
        numer_sum = scale_sum = 0.0
        for i, x in enumerate(res):
            kc = t(x["shard"]["total"])
            ctx = rk._rng_context(model, c, cp, cm, U, keys[i], offs[i],
                                  Kl)
            err1 = max(err1, held_on_shard(
                rk, f"sharded (c) {sname}: pass 1 of rank {i} K_local={Kl} "
                f"k_offset={offs[i]}", model, params, c, cp, cm, start, U,
                rk.rng_noise(ctx), offs[i], x["shard"]))
            w = torch.exp(-effective_gamma(c, cp)
                          * (kc - float(res[0]["stats"]["baseline"])))
            pn = rk.fused_rng_numer_plain(ctx, w)
            kn = t(x["shard"]["numer"]).T
            _, u_seq, _ = rk.fused_exact_rollout_cost(
                model, params, c, cp, cm, start, U, rk.rng_noise(ctx),
                k_offset=offs[i])
            scale = torch.einsum("k,ctk->ct", w.abs(), u_seq.abs_())
            del u_seq
            e2 = (kn - pn).abs()
            print(f"[sharded] (c) {sname}: pass 2 of rank {i} K_local={Kl} "
                  f"k_offset={offs[i]} at the global weights: max|numer "
                  f"err| {e2.max().item():.3e}, max err / sum|w u| "
                  f"{(e2 / scale.clamp(min=1e-30)).max().item():.3e} (limit "
                  f"{NUMER_RTOL})")
            check(bool((e2 <= NUMER_RTOL * scale).all()), f"(c) {sname}: "
                  f"rank {i}'s pass 2 differs beyond {NUMER_RTOL} of "
                  "sum|w u|")
            err2 = max(err2, e2.max().item())
            numer_sum = numer_sum + pn.double()
            scale_sum = scale_sum + scale.double()
            if i == 1 and sname == "gaussian":
                shard1 = (c, keys[i], offs[i], ctx, w, e2.max().item())
        U_plain = (numer_sum / eta).T
        e_U = (t(res[0]["U"]).double() - U_plain).abs()
        lim = NUMER_RTOL * scale_sum.T / eta + 1e-7
        want = {"fused_rng_costs": SHARD_CAP_SOLVES,
                "fused_rng_numer": SHARD_CAP_SOLVES,
                "dynamics_chain": SHARD_CAP_SOLVES}
        lat = p50_p99(res[0]["solve"]["ms"])
        same = ranks_equal(res)
        print(f"[sharded] (c) capacity {sname}, 2 gloo ranks, K={KC} "
              f"(k_offsets {offs}): the reduced U against the plain passes' "
              f"combination of the two shards max|err| {e_U.max().item():.3e}"
              f" (limit {NUMER_RTOL} of sum|w u| / eta); ranks bit for bit "
              f"equal {same}; launches a rank over {SHARD_CAP_SOLVES} solves "
              f"{[x['solve']['launches'] for x in res]}; solve p50 / p99 "
              f"{lat[0]:.3f} / {lat[1]:.3f} ms (rank 0; {card})")
        check(offs == [0, Kl], f"(c) k_offsets {offs}")
        check(bool((e_U <= lim).all()), f"(c) {sname}: the reduced U "
              "differs from the plain combination")
        check(same, f"(c) {sname}: the replicas differ")
        check(all(x["solve"]["launches"] == want for x in res),
              f"(c) {sname}: launches, expected {want} a rank")
        out[f"capacity_{sname}"] = {"solve_ms_p50_p99": lat}
        if sname == "gaussian":
            cap_launches = res[1]["solve"]["launches"]
            errs_c = (err1, err2)

    # passes 1 and 2 on rank 1's slice: K_local 131072 at k_offset 131072
    c, key1, off1, ctx1, w1, _ = shard1
    kw = dict(k_offset=off1, K_local=Kl)
    launch1, _, _ = rk.prepare_fused_rng_costs(model, params, c, cp, cm,
                                               start, U, key1, **kw)
    ms1 = cuda_ms(launch1, 20)
    plain1 = cuda_ms(lambda: rk.fused_rng_costs_plain(
        model, params, c, cp, cm, start, U, key1, **kw), PLAIN_REPS, 0)
    bytes1 = (4 * (T * 2 + n_w + 7 + 4 + 2 * Kl)
              + 4 * min(cm.height * cm.width, 2 * Kl * (T - 1)) + 16)
    bound1 = bound(bytes1, (flops_step + STREAM_OPS) * Kl * T)
    launch2, partials = rk.prepare_fused_rng_numer(ctx1, w1)
    ms2 = cuda_ms(launch2, 50)
    plain2 = cuda_ms(lambda: rk.fused_rng_numer_plain(ctx1, w1), PLAIN_REPS, 0)
    k_need = int((w1 != 0).sum().item())
    bound2 = bound(4 * (Kl + T * 2 + partials.numel()) + 16,
                   (STREAM_OPS + UPDATE_OPS) * k_need * T)
    print(f"[timing] shard of the capacity mode (rank 1 of 2, gaussian, "
          f"K_local={Kl}, k_offset={off1}): pass 1 {ms1:.4f} ms, plain "
          f"{plain1:.3f} ms, bound {bound1[0]:.5f} ms ({bound1[1]}); pass 2 "
          f"{ms2:.4f} ms on the global weights ({k_need} non-zero), plain "
          f"{plain2:.3f} ms, bound {bound2[0]:.5f} ms ({bound2[1]}) ({card})")
    for name, ms, plain, bnd, n_l, err, extra in (
            ("fused_rng_costs", ms1, plain1, bound1,
             cap_launches.get("fused_rng_costs", 0), errs_c[0], {}),
            ("fused_rng_numer", ms2, plain2, bound2,
             cap_launches.get("fused_rng_numer", 0), errs_c[1],
             {"design": "a thread a rollout, fixed-order block sums, blocks "
                        "of %d" % rk.UPDATE_BLOCK,
              "instance": "weighted_update_kernel"})):
        rows.append({"name": f"{name}_shard_K{Kl}", "route": "cuda",
                     "source": src,
                     "replaces": "autorally_tpu/ops/rollout_kernel.py:" + (
                         "1221" if name == "fused_rng_costs" else "1346"),
                     "launches": n_l, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bnd[0],
                     "bound_by": bnd[1], "library_ms": None, "K": Kl,
                     "k_offset": off1, **extra})
    del launch1, launch2, partials, shard1, ctx1

    # (d) the ensemble on a 2 x 2 mesh of 4 ranks, K=16384
    res = four[1]
    M, R = SHARD_ENS_M, SHARD_ENS_R
    Kl = SHARD_ENS_K // (M * R)
    offs = [x["k_offset"] for x in res]
    ens = EnsembleMPPISolver(model, MPPICost(cfg.l1_cost), ens_cfg,
                             num_members=M, device=dev)
    eps = torch.cat([ens._sample_noise(ens._noise_generator(
        kernel_rng.fold_in(kernel_rng.fold_in(sub, e), r)), (T, Kl, 2))
        for e in range(M) for r in range(R)], dim=1)
    U_s, st_s = ens.iterate(stacked, cp, cm, start, U, eps)
    e_U = (t(res[0]["U"]) - U_s).abs().max().item()
    ok = (torch.allclose(t(res[0]["U"]), U_s, rtol=SHARD_RTOL,
                         atol=SHARD_ATOL)
          and bool(np.isclose(res[0]["stats"]["baseline"],
                              st_s.baseline.item(),
                              rtol=SHARD_BASELINE_RTOL, atol=0.0)))
    want = [("dynamics_chain", 1, SHARD_CAP_SOLVES),
            ("fused_exact_rollout_cost", Kl, SHARD_CAP_SOLVES)]
    lat = p50_p99(res[0]["solve"]["ms"])
    same = ranks_equal(res)
    print(f"[sharded] (d) EnsembleShardedMPPISolver M={M} x {R} rollout "
          f"shards on 4 gloo ranks, K={SHARD_ENS_K} (k_offsets {offs}): "
          f"against EnsembleMPPISolver.iterate on the member-block noise "
          f"max|U err| {e_U:.3e}; ranks bit for bit equal {same}; launches "
          f"an iteration {[x['launches'] for x in res]}, over "
          f"{SHARD_CAP_SOLVES} solves {[x['solve']['launches_by_k'] for x in res]}"
          f"; solve p50 / p99 {lat[0]:.3f} / {lat[1]:.3f} ms (rank 0; "
          f"{card})")
    check(offs == [i * Kl for i in range(M * R)], f"(d) k_offsets {offs}")
    check(ok, "(d) the ensemble shards differ from EnsembleMPPISolver")
    check(same, "(d) the replicas differ")
    check(all(x["launches"] == {"fused_exact_rollout_cost": 1} for x in res),
          "(d) launches an iteration: not one kernel-1 launch on every "
          "rank")
    check(all(x["solve"]["launches_by_k"] == want for x in res),
          f"(d) launches, expected {want} a rank")
    out["ensemble_2x2"] = {"solve_ms_p50_p99": lat, "max_U_err": e_U}
    del ens, eps, two, four
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernels": rows, "results": out}


# -- phase 27: the tools and the build cache ---------------------------------

def tools_phase(card, cold, dev=None) -> dict:
    """Phase 27: ``tools/solve_breakdown.py`` (the main path, then the
    capacity mode at K=262144), ``tools/scaling_bench.py`` over 1 and 2
    ranks, and the cold build cache's two loaders (``cold``)."""
    import torch

    from autorally_tpu_torch.tools import scaling_bench, solve_breakdown

    dev = torch.device("cuda", 0) if dev is None else dev
    out = {}
    for tag, kw in (("main", dict(rollouts=K)),
                    ("kernel_rng", dict(rollouts=KC, kernel_rng=True))):
        res = solve_breakdown.run_breakdown(timesteps=T, device=dev, **kw)
        print(f"[solve_breakdown] {tag}: {json.dumps(res)} ({card})")
        check(all(np.isfinite(v) and v > 0 for v in res["stages_ms"].values()),
              f"solve_breakdown {tag}: a stage time is not positive")
        check(res["kernel_rng"] == (tag == "kernel_rng"),
              f"solve_breakdown {tag}: the wrong mode ran")
        out[f"breakdown_{tag}"] = res
    res = scaling_bench.run_scaling([1, 2], mode="both", k_local=K,
                                    num_timesteps=T)
    print(f"[scaling_bench] {json.dumps(res)} ({card}; the 2-rank rows share "
          "one card over gloo: no multi-card scaling)")
    for m in ("weak", "strong"):
        check([(r["devices"], r["ranks_per_device"], r["backend"])
               for r in res[m]] == [(1, 1, "nccl"), (2, 2, "gloo")],
              f"scaling_bench {m}: rows {res[m]}")
    out["scaling"] = res

    lines = []
    try:
        for p in cold[1]:
            o, _ = p.communicate(timeout=900)
            check(p.returncode == 0, f"cold cache loader failed:\n{o}")
            lines.append(o.strip().splitlines()[-1].split())
    finally:
        stop_cold_loaders(cold)
    kinds = sorted(w[0] for w in lines)
    print(f"[build cache] two processes loading at once from a fresh "
          f"enable_persistent_cache directory: {kinds}, seconds "
          f"{[float(w[1]) for w in lines]} ({card})")
    check(kinds == ["built", "loaded"], f"cold cache: {kinds}, expected one "
          "nvcc run")
    out["cold_cache"] = {"loaders": kinds,
                         "seconds": [float(w[1]) for w in lines]}
    return out


# -- phases 28-29: kernels 1 and 2 at other MLP specs; BASELINE #3 ----------

# the specs of the other-spec libraries: BASELINE #3's 6-64-64-64-64-4 (the
# JAX package's wider model, neural_net.py:76-78) and 6-24-4, whose width
# only the 8-lane group divides (no warp form of kernel 2)
SPEC_LAYERS = ((6, 64, 64, 64, 64, 4), (6, 24, 4))
# kernels 3 and 4 also at 6-25-4, whose 279 weights are not a whole number
# of float4 (the field after them in shared memory at float 280)
FIELD_SPEC_LAYERS = SPEC_LAYERS + ((6, 25, 4),)
KS = 8192                              # BASELINE #3's rollouts
KS_WIDE = 65536                        # exact pass 1 also where K fills the card
SPEC_FIELD_TICKS = 20                  # each narrow spec's drives on kernels 3-4
SPEC_FORM_TICKS = 20                   # the 6-24-4 drive's ticks
# kernel 1 and 2 of the wide spec in each geometry against K (where the
# launchers' choices stand): multiples of the card's 132 SMs' 32 rollouts
SPEC_SWEEP_K = (1920, 4224, 8192, 16896, 33792)
B3_LAYERS = [6, 64, 64, 64, 64, 4]
B3_LOG_SECONDS, B3_HZ = 60.0, 50
B3_EPOCHS = 30
B3_HORIZONS = [10, 50]
B3_TICKS = 200
B3_SWAP_TICKS, B3_SWAP_AT = 20, 10     # the update_model drive
B3_PROFILE_TICKS = 20
B3_MAX_RMSE_RATIO = 0.5                # tests/test_ml_loop.py:198-200
# The teacher's output layer scaled down: at init_params(0) as it is, the
# seeded 6-32-32-4 rolls the car over and on past +-pi within the 60 s,
# where the log's quaternion round trip wraps the roll and spikes roll_der
# to -199 (the labels' RMSE is then those spikes: trained 1.89 against a
# fresh init's 2.46, my chip call 4, PR 15); at 0.3 the roll stays in
# (-3.11, 0] and the speeds within 7 m/s, as a drive's would
B3_TEACHER_OUTPUT_SCALE = 0.3
B3_BUDGET_MS = 20.0
B3_FIELD_TICKS = 100                   # on the field with host noise
B3_CAP_TICKS = 50                      # each capacity drive
# Phase 30: kernels 3 and 4 on fields of other specs, labelled by F and
# the hidden widths (F6-48-48: 26-48-48-1), each in a library of its own
# beside the default MLP spec, F5-40-20 beside 6-24-4 too.  F6-48-48 is
# the spec of the JAX package's own fit (tests/test_neural_costmap.py:
# 29-30), fitted on the card and driven at the field path's sizes; F5-40-20
# takes 24 tile columns (no padding) and a width of 20 in a padded n-tile;
# F4-32-32-32 three hidden layers, F8-64 one, F8-128-128 one m-tile a pass
# (and no room beside an 8-warp spec library), F3 none.
FIELD_LABELS = {"F6-48-48": (6, 48, 48), "F5-40-20": (5, 40, 20),
                "F4-32-32-32": (4, 32, 32, 32), "F8-64": (8, 64),
                "F8-128-128": (8, 128, 128), "F3": (3,)}
FIELD_PAIRS = tuple((None, f) for f in FIELD_LABELS.values()) + (
    ((6, 24, 4), FIELD_LABELS["F5-40-20"]),)
FIT_FIELD = "F6-48-48"
FIT_KWARGS = dict(hidden=(48, 48), num_freqs=6)
FIELD_FORM_TICKS = 10                  # each pair's drives (its launches)
BF16_TICKS = 20                        # the fitted field in bf16


def spec_label(layers) -> str:
    return "-".join(str(n) for n in layers)


# Every library the run builds, (MLP spec, field spec), None for the
# default: the default library, each spec of FIELD_SPEC_LAYERS's, and the
# field libraries of FIELD_PAIRS.
LIBRARIES = (((None, None),) + tuple((layers, None)
                                     for layers in FIELD_SPEC_LAYERS)
             + FIELD_PAIRS)


class Builds:
    """Every library of ``LIBRARIES``, of bf16 operands of
    ``BF16_LIBRARIES``, and of ``PAIR_LIBRARIES`` (phase 36's, last), one
    ``nvcc`` each (a wide spec's in ``_build.parts``), all asked for at
    once (threads) in the order the phases take them, the default library
    first: ``_build`` runs
    ``_build.NVCC_JOBS`` at once in that order, so that the phases
    meanwhile keep cores of their own.  Each float32 library of another
    spec is dumped (``library_sass``) beside its build.  ``get(layers, field, bf16)`` waits
    for that library's build and returns (library, seconds), or fails the
    phase if it did not build: the main path takes the default library
    while the others' builds run on, until phases 28, 30 and 31 need them;
    ``done[key]`` is when a build ended, in seconds from the start."""

    def __init__(self):
        import threading

        self.libs, self.errors, self.done = {}, {}, {}
        self.t0 = time.perf_counter()
        keys = ([(layers, field, False) for layers, field in LIBRARIES]
                + [(layers, field, True)
                   for layers, field in BF16_LIBRARIES]
                + [(layers, field, False)
                   for layers, field in PAIR_LIBRARIES])
        self.threads = {key: threading.Thread(target=self._build, args=key)
                        for key in keys}
        for th in self.threads.values():
            th.start()
            time.sleep(0.05)         # each asks for its slots in this order

    def _build(self, layers, field, bf16):
        from autorally_tpu_torch.ops import _build

        t0 = time.perf_counter()
        try:
            self.libs[layers, field, bf16] = (
                _build.load(layers, field, bf16=bf16),
                time.perf_counter() - t0)
            if not bf16 and (layers, field) != (None, None):
                library_sass(layers, field)      # phases 28 and 30 read it
        except Exception as e:               # reported by get, then fail
            self.errors[layers, field, bf16] = e
        self.done[layers, field, bf16] = time.perf_counter() - self.t0

    def get(self, layers, field=None, bf16=False):
        key = (layers, field, bf16)
        self.threads[key].join()
        what = (f"{layers or 'default'}" + (f" field {field}" if field else "")
                + (" (bf16 operands)" if bf16 else ""))
        if key in self.errors:
            print(f"[build] {what}: {self.errors[key]}", file=sys.stderr)
        check(key not in self.errors, f"the kernel library of {what} did "
              "not build")
        return self.libs[key]


def build_libraries(rk) -> dict:
    """Every library of ``Builds``, built: {(None or layers, None or field
    spec, bf16): (library, seconds)}."""
    builds = Builds()
    return {key: builds.get(*key) for key in builds.threads}


def parts_line(tag, log, card) -> None:
    """The seconds of each part of a library built in parts (its nvcc
    output's ``part <p>: nvcc <s>s`` lines), on one line."""
    from autorally_tpu_torch.ops import _build

    parts = re.findall(r"^(part \d+|link): nvcc ([\d.]+)s$", log, re.M)
    if parts:
        print(f"[{tag}] nvcc in {len(parts) - 1} parts and a link, "
              f"{_build.NVCC_JOBS} at once: "
              + ", ".join(f"{name} {sec}s" for name, sec in parts)
              + f" ({card})")


def spec_instances(rk, layers, lib, card) -> None:
    """Phase 1 for a library of another spec: its ptxas report (kernel 1
    in one rollout a thread and in each lane group the spec takes, kernel
    2 in one rollout a thread and, where 32 divides the widths, a warp,
    kernel 3, exact pass 1 and pass 1's field mode, each beside its lane
    form; zero spill bytes in every one: the launchers pick each for some
    K) and each instance's
    registers, dynamic shared memory and blocks an SM at T=100; the field
    instances at least 8 warps an SM and TF32 HMMA in their SASS."""
    tag = f"build {spec_label(layers)}"
    if lib.build is not None:
        parts_line(tag, lib.build[1], card)
        report = ptxas_report(lib.build[1])
        for name, regs, spill in report:
            print(f"[{tag}] {name}: {regs} registers, {spill} bytes of spill "
                  f"stores and loads")
        n_want = 2 * (2 + len(rk.lane_groups(layers)) + (
            len(rk.chain_geometries(layers)) - 1) + 3)
        check(len(report) == n_want, f"{tag}: ptxas reported {len(report)} "
              f"kernels, expected {n_want}")
        check(all(spill == 0 for _, _, spill in report),
              f"{tag}: a kernel spills")
        PTXAS.update((f"{name} [{spec_label(layers)}]", regs)
                     for name, regs, _ in report)
    for geom in rk.geometries(layers):
        g = rk._geometry(KS, *geom)
        info = rk.exact_kernel_info(False, False, g, T, layers=layers)
        print(f"[{tag}] kernel 1 {geometry_label(g)} "
              f"({exact_instance(g, False, False)}): {info['registers']} "
              f"registers, {info['local_bytes']} bytes of local memory, "
              f"{info['smem_bytes']} bytes of dynamic shared memory at T={T}, "
              f"{info['blocks_per_sm']} blocks "
              f"({info['blocks_per_sm'] * g.block // 32} warps) an SM, "
              f"{info['waves']:.2f} waves at K={KS} ({card})")
    for geom in rk.chain_geometries(layers):
        g = rk._geometry(1, *geom)
        info = rk.chain_kernel_info(False, g, T, layers=layers)
        print(f"[{tag}] kernel 2 {geometry_label(g)}: {info['registers']} "
              f"registers, {info['smem_bytes']} bytes of dynamic shared "
              f"memory at T={T}, {info['blocks_per_sm']} blocks an SM "
              f"({card})")
    g = rk._geometry(KS, 1, rk.EXACT_BLOCK)
    info = rk.exact_kernel_info(True, False, g, T, layers=layers)
    print(f"[{tag}] exact pass 1 (fused_rng_kernel<Mlp>): "
          f"{info['registers']} registers, {info['local_bytes']} bytes of "
          f"local memory, {info['smem_bytes']} bytes of dynamic shared "
          f"memory at T={T}, {info['blocks_per_sm']} blocks "
          f"({info['blocks_per_sm'] * g.block // 32} warps) an SM, "
          f"{info['waves']:.2f} waves at K={KS} ({card})")
    field_instances(rk, tag, layers)
    hmma = check_field_sass(library_sass(layers))
    print(f"[{tag}] TF32 HMMA instructions in the field kernels' SASS: "
          f"{hmma}")
    check(len(hmma) == 2 and all(n > 0 for n in hmma.values()),
          f"{tag}: the two field kernel instances do not both hold TF32 "
          "HMMA")


def field_instances(rk, tag, layers=None, field=None) -> None:
    """The field kernel instances of a library (the default MLP spec's MLP
    and BF instances, another spec's MLP ones; of the field spec ``field``
    when given) at T=100: registers, local memory, dynamic shared memory
    and blocks an SM, at least 8 warps an SM, or one block where two
    blocks' shared memory (and an SM's 1 KB reserved for each) passes the
    SM's 228 KB (34-128-128-1 beside the default MLP's 4 warps)."""
    block = rk.field_block(layers or rk.KERNEL_LAYERS)
    kw = {} if layers is None else {"layers": layers}
    if field is not None:
        kw["field"] = field
    for rng, name in ((False, "fused_field_kernel"),
                      (True, "fused_rng_field_kernel")):
        for bf in ((False, True) if layers is None else (False,)):
            info = rk.field_kernel_info(rng, bf, T, **kw)
            warps = info["blocks_per_sm"] * block // 32
            two_fit = 2 * (info["smem_bytes"] + 1024) <= 228 * 1024
            need = min(8, block // 32 * (2 if two_fit else 1))
            print(f"[{tag}] {name}<{'Bf' if bf else 'Mlp'}>: "
                  f"{info['registers']} registers, {info['local_bytes']} "
                  f"bytes of local memory a thread, {info['smem_bytes']} "
                  f"bytes of dynamic shared memory at T={T} (the field "
                  f"{rk.field_smem_layout(**kw)['layout']}), "
                  f"{info['blocks_per_sm']} blocks of {block} ({warps} "
                  f"warps) an SM")
            check(warps >= need, f"{tag} {name}: {warps} resident warps an "
                  f"SM, fewer than {need}")


def spec_setup(layers, dev, seed: int = 0):
    """(model, params, cfg) of the MLP spec ``layers`` at K=KS, T=100:
    seeded Glorot weights (``init_params(seed)``)."""
    from autorally_tpu_torch.config import MPPIConfig
    from autorally_tpu_torch.models import NeuralNetDynamics

    cfg = MPPIConfig(num_rollouts=KS, num_timesteps=T, hz=50)
    model = NeuralNetDynamics(cfg.dt, layers=layers,
                              control_ranges=cfg.control_ranges, device=dev)
    return model, model.init_params(seed), cfg


def spec_phase(drive_oval, rk, card, dev=None) -> dict:
    """Phase 28: kernels 1 and 2 of each spec of ``SPEC_LAYERS`` against
    their plain versions, as phases 2 and 3 hold the default spec's: kernel
    1 at K=KS, T=100 in phase 2's four cases and on a shard's slice, in
    every geometry its launcher takes for the spec, bit for bit equal to
    one another; kernel 2 at K=1 and K=KS in each of its geometries; the
    times (CUDA events) beside the bounds, kernel 2's latency floor at
    K=1 (the spec library's SASS); each geometry of the wide spec against
    K; the 6-32-32-4 kernel 1 at K=KS (the cost of the width); and a
    drive of the 6-24-4 spec (its launches).  Returns {"rows": the 6-24-4
    rows and the wide spec's timings for phase 29's rows, "sweep": ...}."""
    import torch

    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    dev = dev or torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cp = CostParams(desired_speed=6.0)
    costmap = drive_oval.oval_costmap(dev)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    nan_start = start.clone()
    nan_start[0] = float("nan")
    edge_start = torch.tensor([37.0, 0.0, 0.3, 0.0, 6.0, 0.0, 0.0],
                              device=dev)
    # the specs' seeded models keep the car's speed: from 1 m/s every
    # rollout reaches a texel over the boundary, from 0.3 some do not
    slow_start = start.clone()
    slow_start[4] = 0.3
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    eps = torch.randn((T, KS, 2), generator=gen, device=dev)
    eps1 = torch.zeros((T, 1, 2), device=dev)
    out = {}
    for layers in SPEC_LAYERS:
        label = spec_label(layers)
        model, params, cfg = spec_setup(layers, dev)
        wide = cfg.replace(steering_std=4 * cfg.steering_std,
                           throttle_std=4 * cfg.throttle_std)
        shard = KS // 3 + 61
        cases = {"nominal": (cfg, start, costmap, eps, {}),
                 "wide_swarm": (wide, edge_start, costmap, eps, {}),
                 "nan_x": (cfg, nan_start, costmap, eps, {}),
                 "random_map": (wide, slow_start, random_costmap(dev), eps,
                                {}),
                 "shard": (cfg, start, costmap,
                           eps[:, shard:].contiguous(),
                           dict(k_offset=shard))}
        geoms = launcher_geometries(rk, False, layers=layers, k_first=KS)
        print(f"[spec {label}] kernel 1's launcher picks "
              f"{[geometry_label(g) for g in geoms]} (at K={KS} "
              f"{geometry_label(geoms[0])}); kernel 2's "
              f"{[geometry_label(g) for g in rk.chain_geometries(layers)]}")
        err_1 = 0.0
        for name, (ccfg, s0, cmap, e, kw) in cases.items():
            k_n = e.shape[1]
            pc, pu, px = rk.fused_rollout_cost_plain(
                model, params, ccfg, cp, cmap, s0, U, e, **kw)
            if name == "random_map":
                kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, e)
                pc0 = pc
                pc, px = rk.trajectory_cost_plain(model, params, ccfg, cp,
                                                  cmap, U, e, kb)
                check(0 < px.sum().item() < k_n, f"spec {label} random_map:"
                      " crash flags do not differ between rollouts")

            def check_1(glabel, res):
                nonlocal err_1
                kc, ku, kx = res
                if name == "random_map":
                    n_differ = int((~torch.isclose(
                        kc, pc0, rtol=COST_RTOL, atol=COST_ATOL)).sum())
                    check(n_differ <= k_n // 100, f"spec {label} kernel 1 "
                          f"random_map: {n_differ} rollouts differ from the "
                          "plain version's own trajectories")
                e_c = (kc - pc).abs().max().item()
                n_x = int((kx != px).sum().item())
                print(f"[spec {label}] kernel 1 {glabel} {name} K={k_n}: "
                      f"max|cost err| {e_c:.3e}, u_seq equal "
                      f"{torch.equal(ku, pu)}, crash "
                      f"{int(px.sum().item())}/{k_n}, crash mismatches {n_x}")
                check(torch.isfinite(kc).all().item(), f"spec {label} "
                      f"kernel 1 {glabel} {name}: non-finite costs")
                check(torch.allclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL),
                      f"spec {label} kernel 1 {glabel} {name}: costs differ")
                check(n_x == 0, f"spec {label} kernel 1 {glabel} {name}: "
                      "crash flags differ")
                check(torch.equal(ku, pu), f"spec {label} kernel 1 {glabel}"
                      f" {name}: u_seq differs")
                err_1 = max(err_1, e_c)

            hold_geometries(f"spec {label} kernel 1 {name}", geoms,
                            lambda: tuple(rk.fused_exact_rollout_cost(
                                model, params, ccfg, cp, cmap, s0, U, e,
                                **kw)), check_1)
        # kernel 2 at the nominal trajectory's K=1 and at K=KS
        err_2 = 0.0
        chains = rk.chain_geometries(layers)
        for e in (eps1, eps):
            ks, ku = hold_geometries(
                f"spec {label} kernel 2 K={e.shape[1]}", chains,
                lambda: tuple(rk.dynamics_chain(model, params, cfg, start, U,
                                                e)),
                lambda glabel, res: None, chain=True)
            ps, pu = rk.dynamics_chain_plain(model, params, cfg, start, U, e)
            e_s = (ks - ps).abs().max().item()
            print(f"[spec {label}] kernel 2 K={e.shape[1]}: max|state err| "
                  f"{e_s:.3e}, u_seq equal {torch.equal(ku, pu)}")
            check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
                  f"spec {label} kernel 2 K={e.shape[1]}: states differ")
            check(torch.equal(ku, pu), f"spec {label} kernel 2 "
                  f"K={e.shape[1]}: u_seq differs")
            err_2 = max(err_2, e_s)

        # timing beside the bounds (each input read once, each output
        # written once; the step's operations)
        n_w = rk.num_weights(layers)
        step = mlp_flops(layers)
        launch_1, _ = rk.prepare_fused_exact_rollout_cost(
            model, params, cfg, cp, costmap, start, U, eps)
        ms_1 = cuda_ms(launch_1, 50)
        plain_1 = cuda_ms(lambda: rk.fused_rollout_cost_plain(
            model, params, cfg, cp, costmap, start, U, eps), PLAIN_REPS, 0)
        bound_1, by_1 = bound(4 * (T * KS * 2 + 2 * T * KS + 2 * KS + T * 2
                                   + n_w + 7 + 4 + 2 * KS * (T - 1)),
                              step * KS * T)
        print(f"[timing] spec {label} kernel 1 K={KS} T={T} in "
              f"{geometry_label(launch_1.geometry)}: {ms_1:.4f} ms, plain "
              f"{plain_1:.3f} ms, bound {bound_1:.5f} ms ({by_1}) ({card})")
        sass = library_sass(layers)
        timings = {}
        for e in (eps1, eps):
            k_n = e.shape[1]
            c = chain_timing(rk, f"spec {label} kernel 2", model, params,
                             cfg, start, U, e, False, 100 if k_n == 1 else 20,
                             card, sass=sass)
            plain = cuda_ms(lambda: rk.dynamics_chain_plain(
                model, params, cfg, start, U, e), PLAIN_REPS, 0)
            bnd, by = bound(4 * (11 * T * k_n + 2 * T + n_w + 7 + 4),
                            step * T * k_n)
            print(f"[timing] spec {label} kernel 2 K={k_n}: {c['ms']:.4f} ms"
                  f" in {geometry_label(c['geometry'])}, plain {plain:.3f} "
                  f"ms, bound {bnd:.7f} ms ({by}), latency floor "
                  f"{c['floor_ms']:.4f} ms ({card})")
            timings[k_n] = dict(c, plain_ms=plain, bound_ms=bnd, bound_by=by)
        out[layers] = {"kernel1": dict(ms=ms_1, plain_ms=plain_1,
                                       bound_ms=bound_1, bound_by=by_1,
                                       err=err_1,
                                       geometry=launch_1.geometry),
                       "kernel2": timings, "err2": err_2}

    # each geometry of the wide spec against K (CUDA events)
    wide_layers = SPEC_LAYERS[0]
    model, params, cfg = spec_setup(wide_layers, dev)
    sweep = {"kernel1": {}, "kernel2": {}}
    for k_n in SPEC_SWEEP_K:
        e = torch.randn((T, k_n, 2), generator=gen, device=dev)
        c = cfg.replace(num_rollouts=k_n)
        for geom in rk.geometries(wide_layers):
            with forced_geometry(*geom):
                launch, _ = rk.prepare_fused_exact_rollout_cost(
                    model, params, c, cp, costmap, start, U, e)
            sweep["kernel1"][f"{geometry_label(geom)} K={k_n}"] = cuda_ms(
                launch, 10, 2)
        for geom in rk.chain_geometries(wide_layers):
            with forced_chain_geometry(*geom):
                launch, _ = rk.prepare_dynamics_chain(model, params, c,
                                                      start, U, e)
            sweep["kernel2"][f"{geometry_label(geom)} K={k_n}"] = cuda_ms(
                launch, 10, 2)
        picks = (rk.exact_geometry(k_n, sms, layers=wide_layers)[:2],
                 rk.chain_geometry(k_n, sms, layers=wide_layers)[:2])
        print(f"[spec sweep {spec_label(wide_layers)}] K={k_n}: kernel 1 "
              f"{picks[0]} picked, kernel 2 {picks[1]} picked; " + ", ".join(
                  f"{n} {v:.4f} ms" for kind in sweep.values()
                  for n, v in kind.items() if n.endswith(f"K={k_n}"))
              + f" ({card})")
    # the cost of the width: the 6-32-32-4 kernel 1 at K=KS
    base = drive_oval.build(rollouts=KS, device=dev)
    launch, _ = rk.prepare_fused_exact_rollout_cost(
        base[0].model, base[1], base[0].cfg, cp, costmap, start, U, eps)
    sweep["kernel1_default_spec_K%d" % KS] = cuda_ms(launch, 50)
    print(f"[timing] 6-32-32-4 kernel 1 K={KS} in "
          f"{geometry_label(launch.geometry)}: "
          f"{sweep['kernel1_default_spec_K%d' % KS]:.4f} ms ({card})")

    # the 6-24-4 spec through the solver: its launches
    narrow = SPEC_LAYERS[1]
    model, params, cfg = spec_setup(narrow, dev)
    solver = MPPISolver(model, MPPICost(), cfg, device=dev)
    label = spec_label(narrow)
    names = (f"fused_exact_rollout_cost_{label}", f"dynamics_chain_{label}")
    latency, got, _ = drive_counted(drive_oval, rk, f"spec {label} drive",
                                    solver, params, cp, costmap,
                                    SPEC_FORM_TICKS, dict.fromkeys(names, 1),
                                    card)
    res = out[narrow]
    rows = [spec_rows(rk, narrow, res, got[names[0]], got[names[1]])]
    return {"rows": [r for pair in rows for r in pair], "specs": out,
            "sweep": sweep, "narrow_latency": latency}


def spec_rows(rk, layers, res, launches_1, launches_2) -> tuple:
    """The ``kernels`` rows of kernel 1 at K=KS and kernel 2 at K=1 of the
    spec ``layers`` (``spec_phase``'s measurements, the drive's
    launches)."""
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    label = spec_label(layers)
    k1, k2 = res["kernel1"], res["kernel2"][1]
    return (
        {"name": f"fused_exact_rollout_cost_{label}", "route": "cuda",
         "source": src, "replaces": "autorally_tpu/ops/rollout_kernel.py:1013",
         "launches": launches_1, "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "K": KS,
         "layers": list(layers), "geometry": geometry_label(k1["geometry"])},
        {"name": f"dynamics_chain_{label}", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:389",
         "launches": launches_2, "max_abs_err": res["err2"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None, "K": 1,
         "layers": list(layers), "geometry": geometry_label(k2["geometry"]),
         "one_thread_ms": k2["one_thread_ms"],
         "latency_floor_ms": k2["floor_ms"]})


def spec_drives(drive_oval, rk, tag, model, params, cfg, cp, costmap,
                field, ticks, card, samplers=("gaussian",)) -> dict:
    """Drives of an MLP spec's model through kernels 3 and 4 of its library
    (``drive_counted``): on the field with host noise (kernel 3 + kernel
    2), in the capacity mode on the exact map for each of ``samplers``
    (exact pass 1 + pass 2 + kernel 2) and on the field (field pass 1 +
    pass 2 + kernel 2); ``ticks``: {drive: ticks}.  Returns {drive:
    {"latency": (p50, p99), "launches": counts}}."""
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.solver.mppi import MPPISolver

    label = spec_label(model.layers)
    chain = {f"dynamics_chain_{label}": 1}
    runs = {"field": (cfg, field, {f"fused_rollout_cost_{label}": 1,
                                   **chain})}
    for sname in samplers:
        runs[f"capacity {sname}"] = (
            cfg.replace(kernel_rng=True, **SAMPLERS[sname]), costmap,
            {f"fused_rng_costs_{label}": 1, "fused_rng_numer": 1, **chain})
    runs["capacity field"] = (
        cfg.replace(kernel_rng=True), field,
        {f"fused_rng_costs_field_{label}": 1, "fused_rng_numer": 1, **chain})
    out = {}
    for name, (c, surface, per_solve) in runs.items():
        solver = MPPISolver(model, MPPICost(), c, device=model.device)
        check(solver._use_kernel_rng(surface) == c.kernel_rng,
              f"{tag} {name}: the solver took the other mode")
        latency, got, _ = drive_counted(drive_oval, rk, f"{tag} {name}",
                                        solver, params, cp, surface,
                                        ticks[name], per_solve, card)
        print(f"[{tag} {name}] solve p99 {latency[1]:.3f} ms against the "
              f"{B3_BUDGET_MS:.0f} ms budget: "
              f"{'inside' if latency[1] <= B3_BUDGET_MS else 'MISSED'} "
              f"({card})")
        out[name] = {"latency": latency, "launches": got}
    return out


def field_on(field, device):
    """The field ``field`` (a ``NeuralCostmap``) rebuilt on ``device``."""
    from autorally_tpu_torch.costs import NeuralCostmap

    cpu = lambda ts: [t.cpu() for t in ts]
    return NeuralCostmap.build(cpu(field.weights), cpu(field.biases),
                               field.freqs.cpu(), field.r_c1.cpu(),
                               field.r_c2.cpu(), field.trs.cpu(),
                               device=device)


def spec_field_phase(drive_oval, rk, card, field, dev=None) -> dict:
    """Phase 28, kernels 3 and 4 at each spec of ``FIELD_SPEC_LAYERS``
    (seeded weights, K=KS, T=100, on phase 11's fitted field): kernel 3 in
    phase 11's cases, at a K that is a multiple of neither the block nor
    the warp and on a shard's slice against its plain version (costs rtol
    COST_RTOL / atol COST_ATOL, u_seq exactly equal, crash flags equal in
    the nominal and ragged cases, within 1 % elsewhere); pass 1 on the
    exact map and on the field, gaussian and OU, bit for bit kernel 1 or
    kernel 3 fed the plain stream, also at K=KS+1 and on a shard's slice,
    and against its plain version; pass 2 on those pass-1 weights against
    its plain version; the times (CUDA events) beside the bounds, exact
    pass 1 also at K=KS_WIDE; and the narrow specs' drives (their
    launches).  Returns {layers: measurements} and the narrow drives."""
    import torch

    from autorally_tpu_torch.config import CostParams, effective_gamma

    dev = dev or torch.device("cuda", 0)
    cp = CostParams(desired_speed=6.0)
    costmap = drive_oval.oval_costmap(dev)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    nan_start = start.clone()
    nan_start[0] = float("nan")
    edge_start = torch.tensor([37.0, 0.0, 0.3, 0.0, 6.0, 0.0, 0.0],
                              device=dev)
    # from 1 m/s the seeded 6-25-4 rolls every rollout over (the roll
    # latch crashes them all), from 0.3 none
    slow_start = start.clone()
    slow_start[4] = 0.3
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    eps = torch.randn((T, KS, 2), generator=gen, device=dev)
    shard = KS // 3 + 61
    n_f = rk.FIELD_NUM_WEIGHTS
    field_ops = field_eval_ops(field.layers, field.freqs.numel())
    out, drives = {}, {}
    for layers in FIELD_SPEC_LAYERS:
        label = spec_label(layers)
        tag = f"spec {label}"
        model, params, cfg = spec_setup(layers, dev)
        wide = cfg.replace(steering_std=4 * cfg.steering_std,
                           throttle_std=4 * cfg.throttle_std)
        cases = {"nominal": (cfg, start, field),
                 "wide_swarm": (wide, edge_start, field),
                 "nan_x": (cfg, nan_start, field),
                 "random_field": (wide, slow_start, random_field(
                     field, model, params, wide, slow_start, U))}

        # -- kernel 3 against its plain version
        err_3 = 0.0
        runs = [(name, c, s0, f, eps, {}, None)
                for name, (c, s0, f) in cases.items()]
        runs += [("ragged_K", cfg, start, field,
                  eps[:, :KS - 19].contiguous(), {}, 0),
                 ("shard", cfg, start, field, eps[:, shard:].contiguous(),
                  dict(k_offset=shard), None)]
        for name, c, s0, f, e, kw, limit in runs:
            k_n = e.shape[1]
            kc, ku, kx = rk.fused_rollout_cost(model, params, c, cp, f, s0, U,
                                               e, **kw)
            pc, pu, px = rk.fused_rollout_cost_plain(model, params, c, cp, f,
                                                     s0, U, e, **kw)
            torch.cuda.synchronize()
            err_3 = max(err_3, agreement(f"{tag} kernel 3 K={k_n}", name, kc,
                                         kx, pc, px, k_n, limit=limit))
            check(torch.equal(ku, pu), f"{tag} kernel 3 {name}: u_seq "
                  "differs")
            del kc, ku, pc, pu

        # -- pass 1, both modes, against kernel 1 / kernel 3 fed the plain
        # stream and against its plain version; pass 2 on its weights
        err_p1 = {"exact": 0.0, "field": 0.0}
        err_p2 = 0.0
        for mode, surface, fused in (
                ("exact", costmap, rk.fused_exact_rollout_cost),
                ("field", field, rk.fused_rollout_cost)):
            p1_runs = [(sname, "nominal", 0, None)
                       for sname in SAMPLERS]
            p1_runs += [("gaussian", "ragged_K", 0, KS + 1),
                        ("ou", "shard", shard, KS - shard)]
            for sname, name, k_off, k_loc in p1_runs:
                c = cfg.replace(kernel_rng=True, **SAMPLERS[sname])
                if name == "ragged_K":
                    c = c.replace(num_rollouts=k_loc)
                kw = {} if k_loc is None else dict(k_offset=k_off,
                                                   K_local=k_loc)
                kc, kx, ctx = rk.fused_rng_costs(model, params, c, cp,
                                                 surface, start, U, key, **kw)
                pc, px, _ = rk.fused_rng_costs_plain(model, params, c, cp,
                                                     surface, start, U, key,
                                                     **kw)
                ac, au, ax = fused(model, params, c, cp, surface, start, U,
                                   rk.rng_noise(ctx), k_offset=k_off)
                torch.cuda.synchronize()
                same = torch.equal(kc, ac) and torch.equal(kx, ax)
                print(f"[{tag} pass 1 {mode}] {sname} {name} K={ctx.K} "
                      f"k_offset={k_off}: equal to kernel "
                      f"{1 if mode == 'exact' else 3} on the plain stream: "
                      f"{same}")
                check(same, f"{tag} pass 1 {mode} {sname} {name}: differs "
                      "from the eps-reading kernel on the plain stream")
                err_p1[mode] = max(err_p1[mode], agreement(
                    f"{tag} pass 1 {mode} {sname} K={ctx.K}", name, kc, kx,
                    pc, px, ctx.K, limit=0 if name != "shard" else None))
                if name == "nominal" and sname == "gaussian":
                    w = torch.exp(-effective_gamma(c, cp) * (kc - kc.min()))
                    kn = rk.fused_rng_numer(ctx, w)
                    pn = rk.fused_rng_numer_plain(ctx, w)
                    scale = torch.einsum("k,ctk->ct", w.abs(), au.abs())
                    torch.cuda.synchronize()
                    err = (kn - pn).abs()
                    print(f"[{tag} pass 2] on {mode} pass 1's weights K={KS}:"
                          f" max|numer err| {err.max().item():.3e}, max err /"
                          f" sum|w u| {(err / scale.clamp(min=1e-30)).max().item():.3e}"
                          f" (limit {NUMER_RTOL}), ess "
                          f"{(w.sum() ** 2 / (w * w).sum()).item():.1f}")
                    check(bool((err <= NUMER_RTOL * scale).all()),
                          f"{tag} pass 2 on {mode} pass 1's weights: "
                          f"numerator differs beyond {NUMER_RTOL} of sum|w u|")
                    err_p2 = max(err_p2, err.max().item())
                    if mode == "exact":
                        w_exact = (ctx, w)
                del kc, pc, ac, au

        # -- timing beside the bounds (each input read once, each output
        # written once; the step's operations; the field forms' tensor-core
        # bound first)
        n_w = rk.num_weights(layers)
        step = mlp_flops(layers)
        launch_3, _ = rk.prepare_fused_rollout_cost(model, params, cfg, cp,
                                                    field, start, U, eps)
        ms_3 = cuda_ms(launch_3, 10)
        plain_3 = cuda_ms(lambda: rk.fused_rollout_cost_plain(
            model, params, cfg, cp, field, start, U, eps), PLAIN_REPS, 0)
        bytes_3 = 4 * (3 * T * KS * 2 + 2 * KS + T * 2 + n_w + n_f + 7 + 4)
        fp32_3, tc_3 = field_bounds(bytes_3, KS * T * step, KS * (T - 1) * 2,
                                    field)
        print(f"[timing] {tag} kernel 3 fused_rollout_cost K={KS} T={T}: "
              f"{ms_3:.4f} ms, plain {plain_3:.3f} ms, tensor-core bound "
              f"{tc_3[0]:.4f} ms ({tc_3[1]}), fp32 bound {fp32_3[0]:.4f} ms "
              f"({fp32_3[1]}) ({card})")
        del launch_3
        c = cfg.replace(kernel_rng=True)
        p1 = {}
        for k_n in (KS, KS_WIDE):
            ck = c.replace(num_rollouts=k_n)
            launch_e, _, _ = rk.prepare_fused_rng_costs(
                model, params, ck, cp, costmap, start, U, key)
            ms_e = cuda_ms(launch_e, 10 if k_n == KS else 5)
            bytes_e = (4 * (T * 2 + n_w + 7 + 4 + 2 * k_n)
                       + 4 * min(costmap.height * costmap.width,
                                 2 * k_n * (T - 1)) + 16)
            bound_e = bound(bytes_e, (step + STREAM_OPS) * k_n * T)
            plain_e = None
            if k_n == KS:
                plain_e = cuda_ms(lambda: rk.fused_rng_costs_plain(
                    model, params, ck, cp, costmap, start, U, key), PLAIN_REPS, 0)
            geometry_line(rk, f"timing {tag} pass 1 K={k_n}", launch_e, True,
                          False, card, layers=layers)
            print(f"[timing] {tag} pass 1 fused_rng_costs gaussian K={k_n} "
                  f"T={T}: {ms_e:.4f} ms, plain "
                  f"{'not measured' if plain_e is None else '%.3f ms' % plain_e}"
                  f", bound {bound_e[0]:.5f} ms ({bound_e[1]}) ({card})")
            p1[k_n] = dict(ms=ms_e, plain_ms=plain_e, bound_ms=bound_e[0],
                           bound_by=bound_e[1])
            del launch_e
        launch_f, _, _ = rk.prepare_fused_rng_costs(model, params, c, cp,
                                                    field, start, U, key)
        ms_f = cuda_ms(launch_f, 10)
        plain_f = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, c, cp, field, start, U, key), PLAIN_REPS, 0)
        bytes_f = 4 * (2 * KS + T * 2 + n_w + n_f + 7 + 4) + 16
        fp32_f, tc_f = field_bounds(bytes_f, KS * T * (step + STREAM_OPS),
                                    KS * (T - 1) * 2, field)
        print(f"[timing] {tag} pass 1 field fused_rng_costs gaussian K={KS} "
              f"T={T}: {ms_f:.4f} ms, plain {plain_f:.3f} ms, tensor-core "
              f"bound {tc_f[0]:.4f} ms ({tc_f[1]}), fp32 bound "
              f"{fp32_f[0]:.4f} ms ({fp32_f[1]}) ({card})")
        del launch_f
        launch_2, partials = rk.prepare_fused_rng_numer(*w_exact)
        ms_2 = cuda_ms(launch_2, 50)
        bytes_2 = 4 * (KS + T * 2 + partials.numel()) + 16
        bound_2 = bound(bytes_2, (STREAM_OPS + UPDATE_OPS)
                        * int((w_exact[1] != 0).sum().item()) * T)
        print(f"[timing] {tag} pass 2 fused_rng_numer K={KS} on exact pass "
              f"1's weights: {ms_2:.4f} ms, bound {bound_2[0]:.5f} ms "
              f"({bound_2[1]}) ({card})")
        del launch_2, partials, w_exact
        out[layers] = {
            "kernel3": dict(ms=ms_3, plain_ms=plain_3, bound_ms=tc_3[0],
                            bound_by=tc_3[1], fp32_bound_ms=fp32_3[0],
                            err=err_3),
            "pass1": dict(p1[KS], err=err_p1["exact"],
                          ms_K65536=p1[KS_WIDE]["ms"],
                          bound_ms_K65536=p1[KS_WIDE]["bound_ms"]),
            "pass1_field": dict(ms=ms_f, plain_ms=plain_f, bound_ms=tc_f[0],
                                bound_by=tc_f[1], fp32_bound_ms=fp32_f[0],
                                err=err_p1["field"]),
            "pass2": dict(ms=ms_2, bound_ms=bound_2[0], err=err_p2)}
        if layers != SPEC_LAYERS[0]:
            drives[layers] = spec_drives(
                drive_oval, rk, f"{tag} drive", model, params, cfg, cp,
                costmap, field, dict.fromkeys(
                    ("field", "capacity gaussian", "capacity field"),
                    SPEC_FIELD_TICKS), card)
    return {"specs": out, "drives": drives}


def spec_field_rows(layers, res, drives) -> list:
    """The ``kernels`` rows of kernel 3, exact pass 1 and field pass 1 at
    K=KS of the spec ``layers`` (``spec_field_phase``'s measurements; the
    launches of ``drives``, ``spec_drives``' result)."""
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    label = spec_label(layers)
    rows = []
    for key, name, replaces, drive in (
            ("kernel3", f"fused_rollout_cost_{label}", 606, "field"),
            ("pass1", f"fused_rng_costs_{label}", 1221, "capacity gaussian"),
            ("pass1_field", f"fused_rng_costs_field_{label}", 1221,
             "capacity field")):
        r = res[key]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": f"autorally_tpu/ops/rollout_kernel.py:{replaces}",
               "launches": drives[drive]["launches"][name],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None, "K": KS,
               "layers": list(layers)}
        row.update((k, r[k]) for k in ("fp32_bound_ms", "ms_K65536",
                                       "bound_ms_K65536") if k in r)
        rows.append(row)
    return rows


def baseline3_phase(drive_oval, rk, card, spec, field_spec, field,
                    dev=None) -> dict:
    """Phase 29: BASELINE #3, a model trained on the card that then drives
    through kernels 1-4 of its own spec.  A 60 s, 50 Hz drive log from
    a seeded 6-32-32-4 teacher under sinusoidal controls
    (``tools/sim_node.teacher_drive_log``), ``ml.trainer.run`` on the card
    (6-64-64-64-64-4, standardized, 30 epochs, horizons 10 and 50; its
    seconds, epochs a second and best validation loss; the trained RMSE
    under half a fresh init's), ``from_npz`` giving the spec; one iteration
    on the card against the CPU; ``MPPISolver`` at K=8192, T=100 on the oval
    for one untimed solve and 200 ticks with exactly one launch of each
    kernel a solve and no plain version (p50 / p99 against 20 ms); a
    20-tick drive with an ``update_model`` swap at tick 10 (the swap's
    solve bit for bit a fresh solver's on the new weights, the weights
    repacked); the same model on the fitted field ``field`` with host
    noise (kernel 3 + kernel 2, 100 ticks), in the capacity mode on the
    exact map, gaussian and OU, and on the field (pass 1 + pass 2 + kernel
    2, 50 ticks each), each with exactly one launch of each a solve, no
    plain version and p50 / p99 against 20 ms, and one iteration of each on
    the card against the CPU; a 20-tick profile.  ``spec``, ``field_spec``:
    ``spec_phase``'s and ``spec_field_phase``'s measurements of this
    spec."""
    import shutil
    import tempfile

    import torch

    import autorally_tpu_torch.ml as ml
    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.ml import trainer
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.sim_node import teacher_drive_log

    dev = dev or torch.device("cuda", 0)
    layers = tuple(B3_LAYERS)
    label = spec_label(layers)
    work = tempfile.mkdtemp(prefix="baseline3_")
    results = {}
    try:
        teacher = NeuralNetDynamics(1.0 / B3_HZ, device=dev)
        tparams = teacher.init_params(0)
        with torch.no_grad():
            tparams["weights"][-1].mul_(B3_TEACHER_OUTPUT_SCALE)
            tparams["biases"][-1].mul_(B3_TEACHER_OUTPUT_SCALE)
        t0 = time.perf_counter()
        log = teacher_drive_log(os.path.join(work, "drive.jsonl"), teacher,
                                tparams, seconds=B3_LOG_SECONDS, hz=B3_HZ)
        results["log_s"] = time.perf_counter() - t0
        cfg = dict(trainer.DEFAULTS)
        cfg.update(log_jsonl=log, results_dir=os.path.join(work, "out"),
                   nn_layers=list(B3_LAYERS), standardize_data=True,
                   epochs=B3_EPOCHS, horizons=list(B3_HORIZONS))
        timed = {}
        train_dynamics = ml.train_dynamics

        def timed_train(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = train_dynamics(*a, **kw)
            torch.cuda.synchronize()
            timed["train_s"] = time.perf_counter() - t
            return out

        ml.train_dynamics = timed_train
        try:
            t0 = time.perf_counter()
            res = trainer.run(cfg, device=dev)
            results["run_s"] = time.perf_counter() - t0
        finally:
            ml.train_dynamics = train_dynamics
        results.update(best_val_loss=res["best_val_loss"],
                       train_s=timed["train_s"],
                       epochs_per_s=B3_EPOCHS / timed["train_s"],
                       multistep=res["multistep"])
        model, params = NeuralNetDynamics.from_npz(
            os.path.join(cfg["results_dir"], "model.npz"), 1.0 / B3_HZ,
            device=dev)
        check(model.layers == layers, f"from_npz read {model.layers}, "
              f"trained {layers}")
        d = np.load(os.path.join(cfg["results_dir"], "dataset.npz"))
        fresh_model = NeuralNetDynamics(1.0 / B3_HZ, layers=layers,
                                        device=dev)
        trained = ml.instantaneous_errors(model, params, d["inputs"],
                                          d["labels"])["rmse"].mean()
        fresh = ml.instantaneous_errors(fresh_model,
                                        fresh_model.init_params(9),
                                        d["inputs"], d["labels"])[
            "rmse"].mean()
        results["rmse_ratio"] = float(trained / fresh)
        print(f"[baseline3] log {B3_LOG_SECONDS:.0f} s at {B3_HZ} Hz "
              f"({len(d['inputs'])} rows) in {results['log_s']:.2f} s; "
              f"trainer.run {results['run_s']:.2f} s, training "
              f"{results['train_s']:.2f} s for {B3_EPOCHS} epochs "
              f"({results['epochs_per_s']:.2f} epochs/s), best val loss "
              f"{results['best_val_loss']:.5f}; RMSE trained {trained:.4f} "
              f"against a fresh init's {fresh:.4f} (ratio "
              f"{results['rmse_ratio']:.3f}); multistep {res['multistep']};"
              f" from_npz layers {model.layers} ({card})")
        check(results["rmse_ratio"] < B3_MAX_RMSE_RATIO, f"the trained "
              f"model's RMSE is {results['rmse_ratio']:.3f} of a fresh "
              f"init's, not under {B3_MAX_RMSE_RATIO}")

        # the solver at BASELINE #3: K=8192, T=100 on the oval
        _, _, scfg = spec_setup(layers, dev)
        cp = CostParams(desired_speed=6.0)
        costmap = drive_oval.oval_costmap(dev)
        solver = MPPISolver(model, MPPICost(), scfg, device=dev)
        cpu_model, cpu_params = NeuralNetDynamics.from_npz(
            os.path.join(cfg["results_dir"], "model.npz"), 1.0 / B3_HZ,
            device="cpu")
        cpu_solver = MPPISolver(cpu_model, MPPICost(), scfg, device="cpu")
        start = torch.tensor(drive_oval.START, dtype=torch.float32,
                             device=dev)
        U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(29)
        eps = torch.randn((T, KS, 2), generator=gen, device=dev)
        Ug, stg = solver.iterate(params, cp, costmap, start, U, eps)
        Uc, stc = cpu_solver.iterate(cpu_params, cp,
                                     drive_oval.oval_costmap("cpu"),
                                     start.cpu(), U.cpu(), eps.cpu())
        e_it = (Ug.cpu() - Uc).abs().max().item()
        print(f"[baseline3] one iteration GPU vs CPU at K={KS}: max|U_new "
              f"err| {e_it:.3e}, ess {stg.ess.item():.2f} vs "
              f"{stc.ess.item():.2f}")
        check(e_it <= ITER_ATOL, f"baseline3 iterate: GPU and CPU differ by "
              f"{e_it}")
        names = (f"fused_exact_rollout_cost_{label}",
                 f"dynamics_chain_{label}")
        latency, got, out = drive_counted(
            drive_oval, rk, "baseline3", solver, params, cp, costmap,
            B3_TICKS, dict.fromkeys(names, 1), card)
        results["latency"] = latency
        results["launches"] = got
        print(f"[baseline3] solve p99 {latency[1]:.3f} ms against the "
              f"{B3_BUDGET_MS:.0f} ms budget: "
              f"{'inside' if latency[1] <= B3_BUDGET_MS else 'MISSED'} "
              f"({card})")

        # an update_model swap mid-drive (the reference's live topic)
        swap = NeuralNetDynamics(1.0 / B3_HZ, layers=layers, device="cpu")
        sp = swap.init_params(5)
        flat = np.concatenate(
            [w.numpy().T.reshape(-1) for w in sp["weights"]]
            + [b.numpy() for b in sp["biases"]])
        cs = solver.init_state()
        state = start.clone()
        p = params
        old_pack = rk._pack_weights(model, params)
        for tick in range(B3_SWAP_TICKS):
            if tick == B3_SWAP_AT:
                p = model.update_model(params, layers, flat)
                check(p is not params, "update_model kept the old weights")
                pack = rk._pack_weights(model, p)
                check(pack is not old_pack and torch.equal(
                    pack, rk._flat_weights(model, p)), "the swap's weights "
                    "were not repacked")
                fresh = MPPISolver(model, MPPICost(), scfg, device=dev)
                want, _ = fresh.solve(p, cp, costmap, state,
                                      solver.slide(cs, 1))
            cs = solver.slide(cs, 1)
            cs, _ = solver.solve(p, cp, costmap, state, cs)
            if tick == B3_SWAP_AT:
                same = all(bit_equal(getattr(cs, f), getattr(want, f))
                           for f in ("U", "state_solution",
                                     "control_solution"))
                print(f"[baseline3] update_model at tick {tick}: the solve "
                      f"bit for bit a fresh solver's on the new weights "
                      f"{same}; weights repacked")
                check(same, "the swap's solve differs from a fresh "
                      "solver's on the new weights")
            state, _ = model.update_state(p, state, cs.control_solution[0])
        check(torch.isfinite(cs.U).all().item(), "baseline3 swap drive: "
              "non-finite controls")
        # kernels 3 and 4: one iteration of each form on the card against
        # the CPU, then the drives
        key = torch.tensor(KEY, dtype=torch.int64, device=dev)
        cpu_field = field_on(field, "cpu")
        cpu_costmap = drive_oval.oval_costmap("cpu")
        forms = {"field": ({}, field, cpu_field)}
        forms.update((f"capacity {sname}", (dict(kernel_rng=True, **kw),
                                             costmap, cpu_costmap))
                     for sname, kw in SAMPLERS.items())
        forms["capacity field"] = (dict(kernel_rng=True), field, cpu_field)
        for name, (kw, surface, cpu_surface) in forms.items():
            c = scfg.replace(**kw)
            g = MPPISolver(model, MPPICost(), c, device=dev)
            h = MPPISolver(cpu_model, MPPICost(), c, device="cpu")
            if c.kernel_rng:
                Ug, stg = g._iterate_kernel_rng(params, cp, surface, start, U,
                                                key)
                Uc, stc = h._iterate_kernel_rng(cpu_params, cp, cpu_surface,
                                                start.cpu(), U.cpu(),
                                                key.cpu())
            else:
                Ug, stg = g.iterate(params, cp, surface, start, U, eps)
                Uc, stc = h.iterate(cpu_params, cp, cpu_surface, start.cpu(),
                                    U.cpu(), eps.cpu())
            e_it = (Ug.cpu() - Uc).abs().max().item()
            print(f"[baseline3] {name}: one iteration GPU vs CPU at K={KS}: "
                  f"max|U_new err| {e_it:.3e}, ess {stg.ess.item():.2f} vs "
                  f"{stc.ess.item():.2f}")
            check(e_it <= ITER_ATOL, f"baseline3 {name} iterate: GPU and CPU "
                  f"differ by {e_it}")
        drives = spec_drives(
            drive_oval, rk, "baseline3", model, params, scfg, cp, costmap,
            field, {"field": B3_FIELD_TICKS,
                    "capacity gaussian": B3_CAP_TICKS,
                    "capacity ou": B3_CAP_TICKS,
                    "capacity field": B3_CAP_TICKS}, card,
            samplers=tuple(SAMPLERS))
        results["kernels34"] = {n: d["latency"] for n, d in drives.items()}
        profile_ticks(drive_oval, solver, params, cp, costmap, card,
                      ticks=B3_PROFILE_TICKS, tag="baseline3 profile")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rows = list(spec_rows(rk, layers, spec, got[names[0]], got[names[1]]))
    rows += spec_field_rows(layers, field_spec, drives)
    return {"rows": rows, "results": results}


def field_library_instances(rk, layers, fspec, lib, card) -> None:
    """Phase 1 for a library of another field spec (``FIELD_PAIRS``): its
    ptxas report (kernel 3 and pass 1's field mode, the MLP's and beside
    the default MLP spec the BF model's, each beside its lane form; zero
    spill bytes in every one),
    each instance's registers, dynamic shared memory and blocks an SM at
    T=100 (``field_instances``), and TF32 HMMA in each one's SASS (none
    for a field without a hidden layer, which takes no product)."""
    from autorally_tpu_torch.ops import _build

    tag = (f"build {spec_label(layers or rk.KERNEL_LAYERS)} "
           f"{_build.field_label(fspec)}")
    n_want = 4 if layers is None else 2
    if lib.build is not None:
        report = ptxas_report(lib.build[1])
        for name, regs, spill in report:
            print(f"[{tag}] {name}: {regs} registers, {spill} bytes of spill "
                  f"stores and loads")
        check(len(report) == 2 * n_want, f"{tag}: ptxas reported "
              f"{len(report)} kernels, expected {2 * n_want}")
        check(all(spill == 0 for _, _, spill in report),
              f"{tag}: a kernel spills")
        PTXAS.update((f"{name} [{tag[6:]}]", regs) for name, regs, _ in report)
    field_instances(rk, tag, layers, fspec)
    hmma = check_field_sass(library_sass(layers, fspec))
    print(f"[{tag}] TF32 HMMA instructions in the field kernels' SASS: "
          f"{hmma}")
    hidden = len(fspec) > 1
    check(len(hmma) == n_want and all((n > 0) == hidden
                                      for n in hmma.values()),
          f"{tag}: the field kernel instances' SASS does not hold TF32 HMMA "
          f"as the spec asks ({hmma})")


def field_spec_phase(drive_oval, rk, card, dev=None) -> dict:
    """Phase 30: kernels 3 and 4 on the fields of ``FIELD_PAIRS`` (seeded
    weights, ``ab_builds.seeded_field`` of each spec), each beside its MLP
    spec: kernel 3 at K=KS in phase 11's cases (the random field from 0.3
    m/s), at a K that is a multiple of neither the block nor the warp (bit
    for bit the K=KS launch's first rollouts), on a shard's slice and with
    16 circle slots, against its plain version (costs rtol COST_RTOL /
    atol COST_ATOL, u_seq exactly equal, crash flags equal in all but 1 %
    of the rollouts: the seeded fields cross the 0.65 boundary over much
    of the map, so that about half of even the nominal swarm crashes, and
    a value within rounding of the boundary latches a step apart); pass
    1's field mode gaussian and OU, also at K=KS+1, on a shard's slice and
    with the slots, bit for bit kernel 3 fed the plain stream and against
    its plain version; beside the default MLP the BF instances of
    both with the strong theta; the times (CUDA events) of kernel 3 at
    K=KF and pass 1 at K=KC beside both bounds and the plain versions;
    each pair's drives (``FIELD_FORM_TICKS`` ticks with host noise and in
    the capacity mode: exact launch counts).  Then ``FIT_FIELD``'s spec
    fitted on the card through ``drive_oval.build``, kernel 3 held on it,
    and driven: ``FIELD_TICKS`` host-noise ticks at K=KF and
    ``FIELD_CAP_TICKS`` capacity ticks at K=KC, exactly 1 + 1 and 1 + 1 + 1
    launches a solve, no plain version, p50 / p99 against 20 ms; the same
    field in bf16 (the fit cast at the end, as ``fit_neural_costmap(dtype=
    torch.bfloat16)`` casts it) held and driven ``BF16_TICKS`` ticks.
    Returns the ``kernels`` rows and the results."""
    import torch
    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.costs import MPPICost, make_obstacles
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.ab_builds import seeded_field

    dev = dev or torch.device("cuda", 0)
    cp = CostParams(desired_speed=6.0)
    costmap = drive_oval.oval_costmap(dev)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    nan_start = start.clone()
    nan_start[0] = float("nan")
    edge_start = torch.tensor([37.0, 0.0, 0.3, 0.0, 6.0, 0.0, 0.0],
                              device=dev)
    slow_start = start.clone()
    slow_start[4] = 0.3
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    eps = torch.randn((T, KS, 2), generator=gen, device=dev)
    shard = KS // 3 + 61
    okw = dict(obstacle_coeff=drive_oval.OBSTACLE_COEFF,
               inflation=drive_oval.OBSTACLE_INFLATION)
    bf_solver, bparams, _, _, _ = drive_oval.build(model="bf", rollouts=KS,
                                                   device=dev)
    bmodel, bcfg = bf_solver.model, bf_solver.cfg
    strong = dict(bparams, theta=bparams["theta"] * torch.tensor(
        BF_ROW_SCALE, device=dev)[:, None])
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    rows, results = [], {}

    def hold3(tag, name, mdl, prm, c, s0, f, e, kw=None, limit=None):
        """Kernel 3 against its plain version: (max error, the plain
        costs, the kernel's costs and crash flags)."""
        kw = kw or {}
        kc, ku, kx = rk.fused_rollout_cost(mdl, prm, c, cp, f, s0, U, e,
                                           **kw)
        pc, pu, px = rk.fused_rollout_cost_plain(mdl, prm, c, cp, f, s0, U,
                                                 e, **kw)
        torch.cuda.synchronize()
        check(torch.equal(ku, pu), f"{tag} {name}: u_seq differs")
        return agreement(f"{tag} kernel 3 K={e.shape[1]}", name, kc, kx, pc,
                         px, e.shape[1], limit=limit), pc, (kc, kx)

    def hold_p1(tag, name, mdl, prm, c, s0, f, k_off=0, k_loc=None,
                kw=None, limit=None):
        kw = dict(kw or {})
        if k_loc is not None:
            kw.update(k_offset=k_off, K_local=k_loc)
        kc, kx, ctx = rk.fused_rng_costs(mdl, prm, c, cp, f, s0, U, key, **kw)
        pc, px, _ = rk.fused_rng_costs_plain(mdl, prm, c, cp, f, s0, U, key,
                                             **kw)
        kw.pop("K_local", None)
        kw["k_offset"] = k_off
        ac, _, ax = rk.fused_rollout_cost(mdl, prm, c, cp, f, s0, U,
                                          rk.rng_noise(ctx), **kw)
        torch.cuda.synchronize()
        same = torch.equal(kc, ac) and torch.equal(kx, ax)
        print(f"[{tag} pass 1] {name} K={ctx.K} k_offset={k_off}: equal to "
              f"kernel 3 on the plain stream: {same}")
        check(same, f"{tag} pass 1 {name}: differs from kernel 3 on the "
              "plain stream")
        return agreement(f"{tag} pass 1 K={ctx.K}", name, kc, kx, pc, px,
                         ctx.K, limit=limit)

    def drives(tag, solvers, surface, params, ticks):
        out = {}
        for name, (solver, per_solve, t_) in solvers.items():
            latency, got, _ = drive_counted(
                drive_oval, rk, f"{tag} {name}", solver, params, cp,
                surface, t_ if ticks is None else ticks, per_solve, card)
            print(f"[{tag} {name}] solve p99 {latency[1]:.3f} ms against the "
                  f"{B3_BUDGET_MS:.0f} ms budget: "
                  f"{'inside' if latency[1] <= B3_BUDGET_MS else 'MISSED'} "
                  f"({card})")
            out[name] = {"latency": latency, "launches": got}
        return out

    for layers_opt, fspec in FIELD_PAIRS:
        layers = layers_opt or rk.KERNEL_LAYERS
        label = _build.field_label(fspec)
        sfx = "" if layers_opt is None else "_" + spec_label(layers)
        tag = f"field {label}" + (f" beside {spec_label(layers)}"
                                  if layers_opt else "")
        model, params, cfg = spec_setup(layers, dev)
        wide = cfg.replace(steering_std=4 * cfg.steering_std,
                           throttle_std=4 * cfg.throttle_std)
        field = seeded_field(costmap, dev, fspec=fspec)
        cases = {"nominal": (cfg, start, field),
                 "wide_swarm": (wide, edge_start, field),
                 "nan_x": (cfg, nan_start, field),
                 "random_field": (wide, slow_start, random_field(
                     field, model, params, wide, slow_start, U))}

        # -- kernel 3 against its plain version
        err_3, limit = 0.0, KS // 100
        for name, (c, s0, f) in cases.items():
            e_3, _, out = hold3(tag, name, model, params, c, s0, f, eps,
                                limit=limit)
            err_3 = max(err_3, e_3)
            if name == "nominal":
                nominal = out
        e_3, _, (rc, rx) = hold3(tag, "ragged_K", model, params, cfg, start,
                                 field, eps[:, :KS - 19].contiguous(),
                                 limit=limit)
        same = (torch.equal(rc, nominal[0][:KS - 19])
                and torch.equal(rx, nominal[1][:KS - 19]))
        print(f"[{tag} kernel 3] K={KS - 19}: bit for bit the K={KS} "
              f"launch's first rollouts: {same}")
        check(same, f"{tag} kernel 3 ragged_K: differs from the K={KS} "
              "launch's first rollouts")
        err_3 = max(err_3, e_3)
        err_3 = max(err_3, hold3(tag, "shard", model, params, cfg, start,
                                 field, eps[:, shard:].contiguous(),
                                 dict(k_offset=shard), limit=limit)[0])
        # 16 slots, two circles on the lane ahead of the slow start; they
        # must move the plain version's costs
        circles = obstacle_circles(model, params, cfg, slow_start, U)
        ok = dict(okw, obstacles=make_obstacles(circles, N_SLOTS, device=dev))
        e_slots, pc_slots, _ = hold3(tag, "slots16", model, params, cfg,
                                     slow_start, field, eps, ok, limit=limit)
        _, pc_free, _ = hold3(tag, "no_slots", model, params, cfg,
                              slow_start, field, eps, limit=limit)
        check(not torch.equal(pc_slots, pc_free), f"{tag}: the circles "
              "change no rollout's cost")
        err_3 = max(err_3, e_slots)

        # -- pass 1's field mode: bit for bit kernel 3 on the plain stream
        err_p1 = 0.0
        for sname, name, k_off, k_loc, kw, s0 in (
                ("gaussian", "nominal", 0, None, None, start),
                ("ou", "nominal", 0, None, None, start),
                ("gaussian", "ragged_K", 0, KS + 1, None, start),
                ("ou", "shard", shard, KS - shard, None, start),
                ("gaussian", "slots16", 0, None, ok, slow_start)):
            c = cfg.replace(kernel_rng=True, **SAMPLERS[sname])
            if name == "ragged_K":
                c = c.replace(num_rollouts=k_loc)
            err_p1 = max(err_p1, hold_p1(
                f"{tag} {sname}", name, model, params, c, s0, field, k_off,
                k_loc, kw, limit=(k_loc or KS) // 100))

        # -- the BF model's instances (the default MLP spec's field
        # libraries hold them), the strong theta from the slow start
        if layers_opt is None:
            hold3(f"{tag} bf", "strong", bmodel, strong, bcfg, slow_start,
                  field, eps, limit=limit)
            hold_p1(f"{tag} bf", "strong", bmodel, strong,
                    bcfg.replace(kernel_rng=True), slow_start, field,
                    limit=limit)

        # -- times beside the bounds (each input read once, each output
        # written once; the tensor-core bound first)
        n_w, n_f = rk.num_weights(layers), rk.field_num_weights(fspec)
        step = mlp_flops(layers)
        ck = cfg.replace(num_rollouts=KF)
        eps_t = torch.randn((T, KF, 2), generator=gen, device=dev)
        launch_3, _ = rk.prepare_fused_rollout_cost(model, params, ck, cp,
                                                    field, start, U, eps_t)
        ms_3 = cuda_ms(launch_3, 10)
        plain_3 = cuda_ms(lambda: rk.fused_rollout_cost_plain(
            model, params, ck, cp, field, start, U, eps_t), PLAIN_REPS, 0)
        bytes_3 = 4 * (3 * T * KF * 2 + 2 * KF + T * 2 + n_w + n_f + 7 + 4)
        fp32_3, tc_3 = field_bounds(bytes_3, KF * T * step, KF * (T - 1) * 2,
                                    field)
        del launch_3, eps_t
        cc = cfg.replace(num_rollouts=KC, kernel_rng=True)
        launch_f, _, _ = rk.prepare_fused_rng_costs(model, params, cc, cp,
                                                    field, start, U, key)
        ms_f = cuda_ms(launch_f, 5)
        plain_f = cuda_ms(lambda: rk.fused_rng_costs_plain(
            model, params, cc, cp, field, start, U, key), PLAIN_REPS, 0)
        bytes_f = 4 * (2 * KC + T * 2 + n_w + n_f + 7 + 4) + 16
        fp32_f, tc_f = field_bounds(bytes_f, KC * T * (step + STREAM_OPS),
                                    KC * (T - 1) * 2, field)
        del launch_f
        info = {rng: rk.field_kernel_info(rng, False, T, layers=layers,
                                          field=fspec)
                for rng in (False, True)}
        for what, k_n, ms, plain, tc, fp32, inf in (
                ("kernel 3 fused_rollout_cost", KF, ms_3, plain_3, tc_3,
                 fp32_3, info[False]),
                ("pass 1 field fused_rng_costs gaussian", KC, ms_f, plain_f,
                 tc_f, fp32_f, info[True])):
            print(f"[timing] {tag} {what} K={k_n} T={T}: {ms:.4f} ms, plain "
                  f"{plain:.3f} ms, tensor-core bound {tc[0]:.4f} ms "
                  f"({tc[1]}), fp32 bound {fp32[0]:.4f} ms ({fp32[1]}); "
                  f"{inf['registers']} registers, {inf['blocks_per_sm']} "
                  f"blocks of {rk.field_block(layers)} an SM ({card})")

        # -- drives through the entry points (their launches)
        chain = {f"dynamics_chain{sfx}": 1}
        n3 = f"fused_rollout_cost{sfx}_{label}"
        np1 = f"fused_rng_costs_field{sfx}_{label}"
        res = {"kernel3": dict(ms=ms_3, plain_ms=plain_3, bound_ms=tc_3[0],
                               bound_by=tc_3[1], fp32_bound_ms=fp32_3[0],
                               err=err_3, K=KF, info=info[False]),
               "pass1_field": dict(ms=ms_f, plain_ms=plain_f,
                                   bound_ms=tc_f[0], bound_by=tc_f[1],
                                   fp32_bound_ms=fp32_f[0], err=err_p1, K=KC,
                                   info=info[True])}
        if (layers_opt, label) == (None, FIT_FIELD):
            res["drives"] = fit_field_drives(
                drive_oval, rk, card, dev, tag, n3, np1, chain, hold3, drives)
        else:
            res["drives"] = drives(tag, {
                "host-noise": (MPPISolver(model, MPPICost(), cfg, device=dev),
                               {n3: 1, **chain}, None),
                "capacity": (MPPISolver(model, MPPICost(), cfg.replace(
                    kernel_rng=True), device=dev),
                    {np1: 1, "fused_rng_numer": 1, **chain}, None)},
                field, params, FIELD_FORM_TICKS)
        results[f"{spec_label(layers)} {label}"] = res
        for key_, name, replaces, launches in (
                ("kernel3", n3, 606,
                 res["drives"]["host-noise"]["launches"][n3]),
                ("pass1_field", np1, 1221,
                 res["drives"]["capacity"]["launches"][np1])):
            r = res[key_]
            rows.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": f"autorally_tpu/ops/rollout_kernel.py:{replaces}",
                "launches": launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, "K": r["K"],
                "fp32_bound_ms": r["fp32_bound_ms"], "layers": list(layers),
                "field": label, "registers": r["info"]["registers"],
                "blocks_per_sm": r["info"]["blocks_per_sm"]})
    return {"rows": rows, "results": results}


def fit_field_drives(drive_oval, rk, card, dev, tag, n3, np1, chain, hold3,
                     drives) -> dict:
    """Phase 30's drives of ``FIT_FIELD``: the field fitted on the card
    through ``drive_oval.build(neural_costmap=True, fit_kwargs=FIT_KWARGS)``,
    kernel 3 held on it (K=KF, nominal), ``FIELD_TICKS`` host-noise ticks
    at K=KF and ``FIELD_CAP_TICKS`` capacity ticks at K=KC; then the same
    field in bf16, kernel 3 held on it and ``BF16_TICKS`` host-noise
    ticks.  Returns {drive: {"latency", "launches"}}."""
    import dataclasses

    import torch
    from autorally_tpu_torch.solver.mppi import MPPISolver

    (host, params, cp, field, note), fit_s = fitted_field(
        drive_oval, dev, FIT_KWARGS)
    print(f"[{tag}] drive_oval.build(neural_costmap=True, fit_kwargs="
          f"{FIT_KWARGS}): {fit_s:.3f} s ({card}; fitted while the default "
          f"library built); {note.splitlines()[-1]}; layers {field.layers}")
    check(rk.field_spec(field) == FIELD_LABELS[FIT_FIELD],
          f"{tag}: the fit gave layers {field.layers}")
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    eps = torch.randn((T, KF, 2), generator=gen, device=dev)
    hold3(f"{tag} fitted", "nominal", host.model, params, host.cfg, start,
          field, eps)
    cap = MPPISolver(host.model, host.cost, host.cfg.replace(
        num_rollouts=KC, kernel_rng=True), device=dev)
    out = drives(f"{tag} fitted", {
        "host-noise": (host, {n3: 1, **chain}, FIELD_TICKS),
        "capacity": (cap, {np1: 1, "fused_rng_numer": 1, **chain},
                     FIELD_CAP_TICKS)}, field, params, None)
    bf16 = dataclasses.replace(field, weights=tuple(
        w.to(torch.bfloat16) for w in field.weights))
    hold3(f"{tag} fitted bf16", "nominal", host.model, params, host.cfg,
          start, bf16, eps)
    out.update({f"bf16 {k}": v for k, v in drives(
        f"{tag} fitted bf16", {"host-noise": (host, {n3: 1, **chain}, None)},
        bf16, params, BF16_TICKS).items()})
    out["fit_s"] = fit_s
    return out


# Phase 31: matmul_precision "default" (the MXU's one bf16 pass: bf16
# operands in the dynamics' products, float32 sums) in kernels 1-4, each
# instance from a library of bf16 operands: the default specs' (the MLP and
# the BF model), BASELINE #3's 6-64-64-64-64-4 and 6-32-32-4 beside
# F6-48-48, built with the others at phase 1.
BF16_LIBRARIES = ((None, None), (SPEC_LAYERS[0], None),
                  (None, FIELD_LABELS["F6-48-48"]))
PRECISION = "default"
PEAK_BF16_FLOP_PER_S = 989e12         # tensor cores, dense (data sheet)
PREC_CAP_TICKS = 50                   # the capacity mode, K=KC
PREC_FIELD_TICKS = 50                 # the field host-noise path, K=KF
PREC_SPEC_TICKS = 100                 # BASELINE #3's spec, K=KS
PREC_FORM_TICKS = 20                  # the cost subclass and the other forms
PREC_ENS_SOLVES = 20
PREC_CHAINED_SOLVES = 20              # "default" against "highest"
PREC_BUDGET_MS = 20.0
PREC_TIME_REPS = {"small": 50, "large": 5}
# tests/test_torch_matmul_precision.py's CLOSER: a "default" instance at
# least this many times closer to its "default" plain version than to the
# "highest" one, by the mean difference over its outputs
PREC_CLOSER = 10.0
# the std of the seeded biases phase 31 gives the MLPs in place of
# init_params' zeros (a trained model's are not zero; a rounded bias must
# show)
PREC_BIAS_STD = 0.3


def bf16_library_instances(rk, layers, field, lib, card) -> None:
    """Phase 1 for a library of bf16 operands: its ptxas report (the
    instances of the float32 library of the same specs but pass 2 and the
    quotient check, each beside its lane form: 30 for the default specs, a
    spec library's count, 8 for a field library beside the default MLP),
    zero spill bytes in every one, and the field instances' registers and
    blocks an SM."""
    from autorally_tpu_torch.ops import _build

    tag = "build bf16 " + (spec_label(layers) if layers else "default") + (
        f" {_build.field_label(field)}" if field else "")
    if field is not None:
        n_want = 2 * 4
    elif layers is None:
        n_want = 2 * (11 + len(rk.LANE_GROUPS) + 2 + 1 - 2)
    else:
        n_want = 2 * (2 + len(rk.lane_groups(layers)) + (
            len(rk.chain_geometries(layers)) - 1) + 3)
    if lib.build is not None:
        parts_line(tag, lib.build[1], card)
        report = ptxas_report(lib.build[1])
        for name, regs, spill in report:
            print(f"[{tag}] {name}: {regs} registers, {spill} bytes of spill "
                  f"stores and loads")
        check(len(report) == n_want, f"{tag}: ptxas reported {len(report)} "
              f"kernels, expected {n_want}")
        check(all(spill == 0 for _, _, spill in report),
              f"{tag}: a kernel spills")
        PTXAS.update((f"{name} [{tag[6:]}]", regs)
                     for name, regs, _ in report)
    block = rk.field_block(layers or rk.KERNEL_LAYERS)
    kw = dict(layers=layers or rk.KERNEL_LAYERS, precision=PRECISION)
    if field is not None:
        kw["field"] = field
    for rng in (False, True):
        info = rk.field_kernel_info(rng, False, T, **kw)
        print(f"[{tag}] {'pass 1 field' if rng else 'kernel 3'}: "
              f"{info['registers']} registers, {info['local_bytes']} bytes "
              f"of local memory, {info['blocks_per_sm']} blocks of {block} "
              f"an SM at T={T} ({card})")


def bf16_bound(nbytes: float, other_flops: float, bf16_flops: float,
               tf32_flops: float = 0.0):
    """A bf16-operand kernel's tensor-core bound, (ms, what bounds it): the
    dynamics' products (``bf16_flops``) at the dense bf16 rate and the
    field's 3xTF32 products (``tf32_flops``) at the TF32 rate, on the
    tensor cores one after the other, beside the rest at the fp32 rate,
    and ``nbytes`` at the memory rate."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = max(other_flops / PEAK_FP32_FLOP_PER_S,
              tf32_flops / PEAK_TF32_FLOP_PER_S
              + bf16_flops / PEAK_BF16_FLOP_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def mlp_products(layers) -> int:
    """The multiply-adds' operations of one rollout-step's MLP (2 a b a
    layer), the part of ``mlp_flops`` that one bf16 pass takes."""
    return sum(2 * a * b for a, b in zip(layers[:-1], layers[1:]))


BF_PRODUCTS = 2 * 25 * 4              # theta^T phi's multiply-adds


def with_biases(params, seed: int) -> dict:
    """An MLP's ``params`` with seeded normal biases (std PREC_BIAS_STD) in
    place of ``init_params``' zeros."""
    import torch

    rs = np.random.default_rng(seed)
    return dict(params, biases=[
        torch.tensor(rs.normal(0.0, PREC_BIAS_STD, tuple(b.shape)),
                     dtype=torch.float32, device=b.device)
        for b in params["biases"]])


def mean_diff(a, b, keep) -> float:
    """The mean absolute difference of ``a`` and ``b`` (rollouts on the last
    axis) over the rollouts ``keep`` and the entries finite in both."""
    import torch

    a, b = a[..., keep], b[..., keep]
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (a[fin].double() - b[fin].double()).abs().mean().item()


def closer_reading(k, p, k32, p32, keep) -> dict:
    """The CPU tests' rule for a "default" instance (PREC_CLOSER): its
    outputs ``k`` against its "default" plain version's ``p`` (``near``)
    and the "highest" plain version's ``p32`` (``far``), by the mean
    difference over the rollouts ``keep`` in which phase 11's rule finds
    ``k`` and ``p`` in agreement (it lets 1 % of them flip a latch, a
    crash penalty each, which would swamp a mean); ``held`` when
    PREC_CLOSER near <= far.  A case whose plain versions differ (``p``
    against ``p32``, ``plain_moved``) by less than 2 PREC_CLOSER times the
    float32 instance's own difference from its plain version (``k32``
    against ``p32``, ``fp32_noise``: float32's summation order, a texel or
    a crash latch) cannot tell a rounding from float32's noise: not
    ``resolved``."""
    near, far = mean_diff(k, p, keep), mean_diff(k, p32, keep)
    noise, moved = mean_diff(k32, p32, keep), mean_diff(p, p32, keep)
    return {"near": near, "far": far, "fp32_noise": noise,
            "plain_moved": moved,
            "resolved": moved >= 2 * PREC_CLOSER * noise,
            "held": PREC_CLOSER * near <= far}


def precision_phase(drive_oval, rk, card, field, dev=None) -> dict:
    """Phase 31: ``matmul_precision="default"``.  (b) Each bf16-operand
    instance against its plain version at ``"default"`` on phases 2-3's,
    7-9's and 11's inputs (phase 11's rule: costs within COST_RTOL /
    COST_ATOL in all but 1 % of the rollouts, crash flags equal in every
    nominal rollout, u_seq bit for bit; kernel 2's states within
    STATE_RTOL / STATE_ATOL in all but 1 % of the rollouts): where a
    rounded operand lies within a float32 ulp of a bf16 rounding boundary,
    the kernel and the plain version (another tanh, another summation
    order) round it one bf16 ulp apart, and the rollout's chain carries
    that on.  Beside it the CPU tests' rule (``hold_closer``): PREC_CLOSER
    times closer to the "default" plain version than to the "highest" one,
    by the mean difference.  Kernel 1 in lane groups at K=K and one
    rollout a thread at K=KC, the BF model at K=KB (strong theta);
    kernel 2 in each geometry, bit for bit each other; kernel 3 on the
    fitted field and F6-48-48, MLP and BF, with and without N_SLOTS circle
    slots; pass 1 exact (MLP, BF; bit for bit kernel 1 on the plain
    stream) and field, gaussian and OU; and at K=KS BASELINE #3's spec's
    kernels 1, 2 (each geometry), 3 and pass 1 (exact and field), and
    F6-48-48's field pass 1.  (c) Every one differs from its float32
    instance on the same inputs, and ``"high"`` is ``"highest"`` bit for
    bit.  (b), (c) and (e) take the MLPs with seeded biases
    (``with_biases``), so that a rounded bias shows.  (d)
    Drives through the entry points with exact launch counts and no
    plain-version call: BASELINE #1, the capacity mode, the field path,
    BASELINE #3's spec, a cost subclass, the BF model,
    ``EnsembleMPPISolver`` (identical members bit for bit
    ``MPPISolver``), p50 / p99 against 20 ms; the first control of 20
    chained solves against ``"highest"``'s.  (e) Each timed instance
    beside its float32 instance, alternating.  Returns the ``kernels``
    rows and the results."""
    import torch

    from autorally_tpu_torch.config import CostParams, MPPIConfig
    from autorally_tpu_torch.costs import MPPICost, make_costmap, \
        make_obstacles
    from autorally_tpu_torch.models import NeuralNetDynamics
    from autorally_tpu_torch.models.ensemble import stack_params
    from autorally_tpu_torch.parallel import ShardedMPPISolver
    from autorally_tpu_torch.solver import EnsembleMPPISolver, MPPISolver
    from autorally_tpu_torch.tools import track_generator as tg
    from autorally_tpu_torch.tools.ab_builds import seeded_field
    from autorally_tpu_torch.tools.exact_variants import forced_geometry

    P = PRECISION
    dev = torch.device("cuda", 0) if dev is None else dev
    solver, params, cp, costmap, _ = drive_oval.build(rollouts=K, device=dev)
    cfg, model = solver.cfg, solver.model
    # the holds and the times on seeded biases (PREC_BIAS_STD), the drives
    # on the entry points' seeded model (its biases zero: with seeded ones
    # the main path's car backs into a crash)
    drive_params, params = params, with_biases(params, 31)
    bsolver, bparams, *_ = drive_oval.build(model="bf", device=dev)
    bcfg, bmodel = bsolver.cfg, bsolver.model
    strong = dict(bparams, theta=bparams["theta"] * torch.tensor(
        BF_ROW_SCALE, device=dev)[:, None])
    gen = torch.Generator(device=dev)
    gen.manual_seed(310)
    eps = torch.randn((T, K, 2), generator=gen, device=dev)
    eps_b = torch.randn((T, KB, 2), generator=gen, device=dev)
    eps_s = torch.randn((T, KS, 2), generator=gen, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    nan_start = start.clone()
    nan_start[0] = float("nan")
    edge_start = torch.tensor([37.0, 0.0, 0.3, 0.0, 6.0, 0.0, 0.0],
                              device=dev)
    slow_start = start.clone()
    slow_start[4] = 1.0
    wide = cfg.replace(steering_std=4 * cfg.steering_std,
                       throttle_std=4 * cfg.throttle_std)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    # the largest cost (kernel 2: state) error of each held case, and of
    # each ``kernels`` row's instance
    held, errs, results = {}, {}, {}

    # each held case's mean differences, and the cases in which each
    # instance met PREC_CLOSER
    closer, met = {}, {}

    def same_all(a, b) -> bool:
        return all(bit_equal(x, y) for x, y in zip(a, b)
                   if torch.is_tensor(x))

    def launched(fn):
        """``fn()`` and the name of the one kernel instance it launched."""
        before = rk.LAUNCHES.copy()
        out = fn()
        names = list(rk.LAUNCHES - before)
        check(len(names) == 1, f"precision: launched {names}, expected one "
              "kernel instance")
        return out, names[0]

    def hold_closer(case, instance, k, p, k32, p32, keep):
        """``closer_reading`` on the card: held in each case that can tell
        the precision from float32's noise (``resolved``), reported in the
        others; every instance must be held in at least one."""
        r = closer[case] = closer_reading(k, p, k32, p32, keep)
        met.setdefault(instance, [])
        print(f"[precision {case}] {instance}: mean|'default' - plain "
              f"'default'| {r['near']:.3e}, mean|'default' - plain "
              f"'highest'| {r['far']:.3e} (ratio "
              f"{r['far'] / max(r['near'], 1e-300):.1f}, limit "
              f"{PREC_CLOSER:.0f}); plain 'default' - plain 'highest' "
              f"{r['plain_moved']:.3e}, float32 instance - plain 'highest' "
              f"{r['fp32_noise']:.3e}: " + (
                  "held" if r["resolved"] else
                  "float32's noise hides the precision, reported only"))
        if r["resolved"]:
            check(r["held"], f"{case} {instance}: {r['near']:.3e} from its "
                  f"'default' plain version, {r['far']:.3e} from 'highest'")
            met[instance].append(case)

    def against_fp32(tag, d, hi, high):
        """(c): the outputs ``d`` at "default" differ from the float32
        instance's ``hi``, and "high"'s ``high`` equal ``hi`` bit for
        bit."""
        moved = (d[0] - hi[0]).abs()
        moved = moved[torch.isfinite(moved)].max().item()
        print(f"[precision] {tag}: 'default' against the float32 instance "
              f"max|diff| {moved:.3e}; 'high' bit for bit 'highest': "
              f"{same_all(high, hi)}")
        check(not bit_equal(d[0], hi[0]),
              f"{tag}: the 'default' instance gives the float32 bits")
        check(same_all(high, hi), f"{tag}: 'high' differs from 'highest'")
        return moved

    def hold_fused(tag, name, run, plain, n, row=None):
        """A fused kernel (1 or 3, or pass 1 without u_seq) against its
        plain version at "default", phase 11's rule and PREC_CLOSER; (c)
        against its float32 instance; its error counts for the
        ``kernels`` row ``row``."""
        out, instance = launched(lambda: run(P))
        ref = plain(P)
        hi, high, ref32 = run("highest"), run("high"), plain("highest")
        torch.cuda.synchronize()
        kc, kx = out[0], out[-1]
        pc, px = ref[0], ref[-1]
        if len(out) == 3:
            check(bit_equal(out[1], ref[1]), f"{tag} {name}: u_seq differs")
        if name == "nominal":
            check(torch.equal(kx, px), f"{tag} {name}: crash flags differ")
        err = agreement(f"precision {tag}", name, kc, kx, pc, px, n,
                        limit=n // 100)
        hold_closer(f"{tag} {name}", f"{tag}: {instance}", kc, pc, hi[0],
                    ref32[0], agreeing(kc, kx, pc, px))
        against_fp32(f"{tag} {name}", out, hi, high)
        held[f"{tag} {name}"] = err
        if row is not None:
            errs[row] = max(errs.get(row, 0.0), err)
        return out

    def hold_chain(tag, mdl, prm, c, e, geoms, row=None):
        """Kernel 2 at K in each geometry of ``geoms`` (bit for bit each
        other) against its plain version at "default": states within
        STATE_RTOL / STATE_ATOL in all but 1 % of the rollouts, u_seq bit
        for bit, and PREC_CLOSER; (c) against its float32 instance."""
        def run(p):
            return tuple(rk.dynamics_chain(mdl, prm, c, slow_start, U, e,
                                           precision=p))
        n = e.shape[1]
        (ks, ku), instance = launched(lambda: hold_geometries(
            f"precision {tag}", geoms, lambda: run(P),
            lambda label, out: None, chain=True))
        ps, pu = rk.dynamics_chain_plain(mdl, prm, c, slow_start, U, e,
                                         precision=P)
        ps32, _ = rk.dynamics_chain_plain(mdl, prm, c, slow_start, U, e,
                                          precision="highest")
        hi, high = run("highest"), run("high")
        torch.cuda.synchronize()
        near = torch.isclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL,
                             equal_nan=True).all(dim=0).all(dim=0)
        n_differ = int((~near).sum().item())
        fin = torch.isfinite(ps)
        e_s = (ks[fin] - ps[fin]).abs().max().item()
        print(f"[precision {tag}] K={n} against its plain version: "
              f"max|state err| {e_s:.3e}, {n_differ} rollouts beyond "
              f"rtol {STATE_RTOL} / atol {STATE_ATOL} (limit {n // 100}), "
              f"u_seq bit for bit {bit_equal(ku, pu)}")
        check(n_differ <= n // 100, f"{tag}: {n_differ} rollouts' states "
              "differ from the plain version")
        check(bit_equal(ku, pu), f"{tag}: u_seq differs")
        hold_closer(tag, f"{tag}: {instance}", ks, ps, hi[0], ps32, near)
        against_fp32(f"{tag} K={n}", (ks, ku), hi, high)
        held[tag] = e_s
        if row is not None:
            errs[row] = e_s

    # -- (b), (c): kernel 1 in lane groups at K=K (phase 2's cases) and one
    # rollout a thread at K=KC; the BF model at K=KB
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geom = rk.exact_geometry(K, sms)
    check(geom.group > 1, f"kernel 1 at K={K} takes {geometry_label(geom)}")
    a_cases = {"nominal": (cfg, start, costmap),
               "wide_swarm": (wide, edge_start, costmap),
               "nan_x": (cfg, nan_start, costmap),
               "random_map": (wide, slow_start, random_costmap(dev))}
    for name, (c, s0, cm) in a_cases.items():
        def run(p, c=c, s0=s0, cm=cm):
            return rk.fused_exact_rollout_cost(model, params, c, cp, cm, s0,
                                               U, eps, precision=p)

        def plain(p, c=c, s0=s0, cm=cm):
            return rk.fused_rollout_cost_plain(model, params, c, cp, cm, s0,
                                               U, eps, precision=p)

        hold_fused(f"kernel 1 {geometry_label(geom)}", name, run, plain, K,
                   "fused_exact_rollout_cost_default")
        if name == "nominal":
            check(same_all(plain("high"), plain("highest")),
                  "kernel 1's plain version: 'high' differs from 'highest'")
    eps_c = torch.randn((T, KC, 2), generator=gen, device=dev)
    with forced_geometry(1, rk.EXACT_BLOCK):
        def run_c(p):
            return rk.fused_exact_rollout_cost(model, params, cfg, cp,
                                               costmap, start, U, eps_c,
                                               precision=p)
        hold_fused("kernel 1 G1 block 64", "nominal", run_c,
                   lambda p: rk.fused_rollout_cost_plain(
                       model, params, cfg, cp, costmap, start, U, eps_c,
                       precision=p), KC, "fused_exact_rollout_cost_default")
    del eps_c
    # BASELINE #3's spec (its library of bf16 operands), nominal
    spec_model, spec_params, spec_cfg = spec_setup(SPEC_LAYERS[0], dev)
    drive_spec_params, spec_params = spec_params, with_biases(spec_params, 32)
    label = "_" + spec_label(SPEC_LAYERS[0])

    def run_spec(p):
        return rk.fused_exact_rollout_cost(spec_model, spec_params, spec_cfg,
                                           cp, costmap, start, U, eps_s,
                                           precision=p)
    hold_fused(f"kernel 1 {spec_label(SPEC_LAYERS[0])}", "nominal",
               run_spec, lambda p: rk.fused_rollout_cost_plain(
                   spec_model, spec_params, spec_cfg, cp, costmap, start, U,
                   eps_s, precision=p), KS,
               f"fused_exact_rollout_cost{label}_default")
    for name, (prm, s0) in {"nominal": (bparams, start),
                            "strong": (strong, slow_start)}.items():
        def run_b(p, prm=prm, s0=s0):
            return rk.fused_exact_rollout_cost(bmodel, prm, bcfg, cp,
                                               costmap, s0, U, eps_b,
                                               precision=p)
        hold_fused("kernel 1 bf", name, run_b, lambda p, prm=prm, s0=s0:
                   rk.fused_rollout_cost_plain(bmodel, prm, bcfg, cp,
                                               costmap, s0, U, eps_b,
                                               precision=p), KB,
                   "fused_exact_rollout_cost_bf_default")

    # -- kernel 2 at K in each geometry, bit for bit each other; the wide
    # spec's (its warp form's staging is phase 31's spill) at K=KS
    hold_chain("kernel 2", model, params, cfg, eps, rk.CHAIN_GEOMETRIES,
               "dynamics_chain_default")
    hold_chain("kernel 2 bf", bmodel, strong, bcfg, eps_b,
               rk.CHAIN_GEOMETRIES, "dynamics_chain_bf_default")
    hold_chain(f"kernel 2 {spec_label(SPEC_LAYERS[0])}", spec_model,
               spec_params, spec_cfg, eps_s,
               rk.chain_geometries(SPEC_LAYERS[0]))

    # -- kernel 3 on the fitted field and F6-48-48, MLP and BF, with and
    # without the circle slots (slow start: the circles on its lane); the
    # wide spec on the fitted field
    f648 = seeded_field(costmap, dev, fspec=FIELD_LABELS["F6-48-48"])
    circles = obstacle_circles(model, params, cfg, slow_start, U)
    okw = dict(obstacles=make_obstacles(circles, N_SLOTS, device=dev),
               obstacle_coeff=drive_oval.OBSTACLE_COEFF,
               inflation=drive_oval.OBSTACLE_INFLATION)
    # the same slots 1 km off the map: the circles' edges, which float32
    # noise latches on either side, hide the BF model's small rounding
    # (phase 11's rule holds them above); the instance's dynamics alone
    off = [[x + 1000.0, y, r] for x, y, r in circles]
    okw_off = dict(okw, obstacles=make_obstacles(off, N_SLOTS, device=dev))
    bcfg_s = bcfg.replace(num_rollouts=KS)
    row3 = "fused_rollout_cost_default"
    for name, (mdl, prm, c, s0, f, kw, row) in {
            "nominal": (model, params, cfg, start, field, {}, row3),
            "wide_swarm": (model, params, wide, edge_start, field, {}, row3),
            "slots16": (model, params, cfg, slow_start, field, okw, None),
            "bf strong": (bmodel, strong, bcfg_s, slow_start, field, {},
                          None),
            "bf slots16": (bmodel, strong, bcfg_s, slow_start, field, okw,
                           None),
            "bf slots16 off the map": (bmodel, strong, bcfg_s, slow_start,
                                       field, okw_off, None),
            "F6-48-48": (model, params, cfg, start, f648, {}, None),
            spec_label(SPEC_LAYERS[0]): (spec_model, spec_params, spec_cfg,
                                         start, field, {}, None)}.items():
        def run3(p, mdl=mdl, prm=prm, c=c, s0=s0, f=f, kw=kw):
            return rk.fused_rollout_cost(mdl, prm, c, cp, f, s0, U, eps_s,
                                         precision=p, **kw)
        hold_fused("kernel 3", name, run3,
                   lambda p, mdl=mdl, prm=prm, c=c, s0=s0, f=f, kw=kw:
                   rk.fused_rollout_cost_plain(mdl, prm, c, cp, f, s0, U,
                                               eps_s, precision=p, **kw),
                   KS, row)

    # -- pass 1: exact MLP and BF (bit for bit kernel 1 on the plain
    # stream), field, gaussian and OU; the wide spec's exact and field
    # and F6-48-48's field at K=KS
    gauss = {"gaussian": {}}
    wide_label = spec_label(SPEC_LAYERS[0])
    for tag, (mdl, prm, base_cfg, surf, k_n, samplers, row) in {
            "pass 1": (model, params, cfg, costmap, KC, SAMPLERS,
                       "fused_rng_costs_default"),
            "pass 1 bf": (bmodel, strong, bcfg, costmap, KC, gauss,
                          "fused_rng_costs_bf_default"),
            "pass 1 field": (model, params, cfg, field, KF, SAMPLERS,
                             "fused_rng_costs_field_default"),
            "pass 1 field bf": (bmodel, strong, bcfg, field, KF, gauss,
                                None),
            f"pass 1 {wide_label}": (spec_model, spec_params, spec_cfg,
                                     costmap, KS, gauss, None),
            f"pass 1 field {wide_label}": (spec_model, spec_params,
                                           spec_cfg, field, KS, gauss,
                                           None),
            "pass 1 field F6-48-48": (model, params, cfg, f648, KS, gauss,
                                      None)}.items():
        for sname, skw in samplers.items():
            c = base_cfg.replace(num_rollouts=k_n, kernel_rng=True, **skw)
            s0 = slow_start if mdl is bmodel else start

            def run1(p, mdl=mdl, prm=prm, c=c, s0=s0, surf=surf):
                return rk.fused_rng_costs(mdl, prm, c, cp, surf, s0, U, key,
                                          precision=p)[:2]
            out = hold_fused(f"{tag} {sname}", "nominal", run1,
                             lambda p, mdl=mdl, prm=prm, c=c, s0=s0,
                             surf=surf: rk.fused_rng_costs_plain(
                                 mdl, prm, c, cp, surf, s0, U, key,
                                 precision=p)[:2], k_n, row)
            if surf is costmap:
                ctx = rk.fused_rng_costs(mdl, prm, c, cp, surf, s0, U, key,
                                         precision=P)[2]
                with forced_geometry(1, rk.EXACT_BLOCK):
                    ac, _, ax = rk.fused_exact_rollout_cost(
                        mdl, prm, c, cp, surf, s0, U, rk.rng_noise(ctx),
                        precision=P)
                torch.cuda.synchronize()
                same = bit_equal(out[0], ac) and torch.equal(out[1], ax)
                print(f"[precision {tag} {sname}] K={k_n}: bit for bit "
                      f"kernel 1 on the plain stream: {same}")
                check(same, f"{tag} {sname}: differs from kernel 1 on the "
                      "plain stream")
                del ac, ax, ctx

    # -- (d): drives through the entry points
    def drive(tag, s, prm, surface, ticks, per_solve):
        latency, got, out = drive_counted(drive_oval, rk, f"precision {tag}",
                                          s, prm, cp, surface, ticks,
                                          per_solve, card)
        print(f"[precision {tag}] solve p99 {latency[1]:.3f} ms against the "
              f"{PREC_BUDGET_MS:.0f} ms budget: "
              f"{'inside' if latency[1] <= PREC_BUDGET_MS else 'MISSED'} "
              f"({card})")
        results[tag] = {"latency": latency, "launches": got}
        return got

    def at(s, prm=None):
        return s.cfg.replace(matmul_precision=P, **(prm or {}))

    drives = {
        "main path": (MPPISolver(model, solver.cost, at(solver), device=dev),
                      drive_params, costmap, TICKS,
                      {"fused_exact_rollout_cost_default": 1,
                       "dynamics_chain": 1}),
        "capacity": (MPPISolver(model, solver.cost, at(solver, dict(
            num_rollouts=KC, kernel_rng=True)), device=dev), drive_params,
            costmap, PREC_CAP_TICKS, {"fused_rng_costs_default": 1,
                             "fused_rng_numer": 1, "dynamics_chain": 1}),
        "field": (MPPISolver(model, solver.cost, at(solver, dict(
            num_rollouts=KF)), device=dev), drive_params, field,
            PREC_FIELD_TICKS, {"fused_rollout_cost_default": 1,
                               "dynamics_chain": 1}),
        "field capacity": (MPPISolver(model, solver.cost, at(solver, dict(
            num_rollouts=KC, kernel_rng=True)), device=dev), drive_params,
            field, PREC_FORM_TICKS, {"fused_rng_costs_field_default": 1,
                                     "fused_rng_numer": 1,
                                     "dynamics_chain": 1}),
        "BASELINE #3 spec": (MPPISolver(
            spec_model, MPPICost(), spec_cfg.replace(matmul_precision=P),
            device=dev), drive_spec_params, costmap, PREC_SPEC_TICKS,
            {f"fused_exact_rollout_cost{label}_default": 1,
             f"dynamics_chain{label}": 1}),
        "cost subclass": (MPPISolver(model, doubled_speed_cost(), at(solver),
                                     device=dev), drive_params, costmap,
                          PREC_FORM_TICKS, {"dynamics_chain_default": 1,
                                            "dynamics_chain": 1}),
        "bf": (MPPISolver(bmodel, bsolver.cost, at(bsolver), device=dev),
               bparams, costmap, PREC_FORM_TICKS,
               {"fused_exact_rollout_cost_bf_default": 1,
                "dynamics_chain_bf": 1}),
        "bf capacity": (MPPISolver(bmodel, bsolver.cost, at(bsolver, dict(
            num_rollouts=KC, kernel_rng=True)), device=dev), bparams,
            costmap, PREC_FORM_TICKS, {"fused_rng_costs_bf_default": 1,
                                       "fused_rng_numer": 1,
                                       "dynamics_chain_bf": 1}),
        # one rank without a process group: the sharded solver's inline
        # body
        "sharded capacity": (ShardedMPPISolver(model, solver.cost, at(
            solver, dict(num_rollouts=KC, kernel_rng=True)), device=dev),
            drive_params, costmap, PREC_FORM_TICKS,
            {"fused_rng_costs_default": 1, "fused_rng_numer": 1,
             "dynamics_chain": 1})}
    # the one-rank sharded iterate (pass 1 on fold_in(sub, 0)'s stream, the
    # collectives' identities) against MPPISolver's on that stream
    sharded = drives["sharded capacity"][0]
    check(sharded._inline_body, "precision: the one-rank sharded solver "
          "takes collectives")
    sub = np.array(KEY, np.uint32)
    U_a, st_a = sharded._sharded_rng_iterate(drive_params, cp, costmap,
                                             start, U, sub)
    U_b, st_b = drives["capacity"][0]._iterate_drawn(
        drive_params, cp, costmap, start, U, sharded._draw(costmap, sub))
    torch.cuda.synchronize()
    same = bit_equal(U_a, U_b) and same_all(st_a, st_b)
    print(f"[precision sharded capacity] one rank at K={KC}, 'default': "
          f"its iterate bit for bit MPPISolver's on the same stream: {same}")
    check(same, "precision: the one-rank sharded iterate differs from "
          "MPPISolver's")
    launches = {}
    for tag, (s, prm, surface, ticks, per_solve) in drives.items():
        launches.update(drive(tag, s, prm, surface, ticks, per_solve))

    # the ensemble at K=ENS_KS[0]: identical members bit for bit
    # MPPISolver at "default", then chained solves with launches counted
    data, xb, yb = tg.oval_track(ppm=4.0)
    cm_e = make_costmap(data, xb, yb, device=dev)
    ecfg = MPPIConfig(num_rollouts=ENS_KS[0], num_timesteps=T,
                      matmul_precision=P)
    base = NeuralNetDynamics(ecfg.dt, control_ranges=ecfg.control_ranges,
                             device=dev)
    p0 = base.init_params(0)
    ens = EnsembleMPPISolver(base, MPPICost(ecfg.l1_cost), ecfg,
                             num_members=ENS_M, device=dev)
    single = MPPISolver(base, MPPICost(ecfg.l1_cost), ecfg, device=dev)
    e_state = np.array(ENS_START, np.float32)
    cs_e, st_e = ens.solve(stack_params([p0] * ENS_M), cp, cm_e, e_state,
                           ens.init_state())
    cs_s, st_s = single.solve(p0, cp, cm_e, e_state, single.init_state())
    torch.cuda.synchronize()
    same = {f: bit_equal(getattr(cs_e, f), getattr(cs_s, f))
            for f in ("U", "state_solution", "control_solution")}
    same.update({f: bit_equal(getattr(st_e, f), getattr(st_s, f))
                 for f in st_e._fields})
    print(f"[precision ensemble] {ENS_M} identical members against "
          f"MPPISolver at K={ENS_KS[0]}, 'default', bit for bit: {same}")
    check(all(same.values()), "precision ensemble: identical members "
          "differ from MPPISolver")
    stacked = ensemble_members(p0, ENS_M)
    cs = ens.init_state()
    rk.LAUNCHES.clear()
    with PlainCalls(rk) as calls:
        ms = []
        for _ in range(PREC_ENS_SOLVES):
            t0 = time.perf_counter()
            cs, st = ens.solve(stacked, cp, cm_e, e_state, cs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    got = dict(rk.LAUNCHES)
    want = {"fused_exact_rollout_cost_default": ENS_M * PREC_ENS_SOLVES,
            "dynamics_chain": PREC_ENS_SOLVES}
    lat = (float(np.percentile(ms, 50)), float(np.percentile(ms, 99)))
    print(f"[precision ensemble] M={ENS_M} K={ENS_KS[0]} {PREC_ENS_SOLVES} "
          f"chained solves: p50 {lat[0]:.3f} ms p99 {lat[1]:.3f} ms (solve "
          f"+ sync, host clock; {card}); launches {got}; plain-version "
          f"calls {calls.calls}")
    check(got == want, f"precision ensemble: launches {got}, expected "
          f"{want}")
    check(not any(calls.calls.values()), "precision ensemble: a plain "
          "version ran on the card")
    check(torch.isfinite(cs.U).all().item(), "precision ensemble: "
          "non-finite controls")
    results["ensemble"] = {"latency": lat, "launches": got}

    # the first control of chained solves from the same state and key,
    # "default" against "highest"
    firsts = {}
    for p in ("highest", P):
        s = MPPISolver(model, solver.cost, solver.cfg.replace(
            matmul_precision=p), device=dev)
        cs = s.init_state()
        u0 = []
        for _ in range(PREC_CHAINED_SOLVES):
            cs, _ = s.solve(drive_params, cp, costmap, start, cs)
            u0.append(cs.U[0].clone())
        firsts[p] = torch.stack(u0)
    drift = (firsts[P] - firsts["highest"]).abs().max().item()
    print(f"[precision] the first control over {PREC_CHAINED_SOLVES} "
          f"chained solves from the same state, 'default' against "
          f"'highest': max|diff| {drift:.3e} (K={K}, T={T}; {card})")
    check(np.isfinite(drift) and drift > 0.0, "precision: the chained "
          "solves' first controls do not differ, or are not finite")
    results["first_control_drift"] = drift

    # -- (e): each timed instance beside its float32 instance, alternating
    # (float32, default, default, float32), and its plain version
    f_ops = field_eval_ops(field.layers, field.freqs.numel())
    f_prod = 2 * sum(a * b for a, b in zip(field.layers[:-2],
                                           field.layers[1:-1]))
    n_f = rk.FIELD_NUM_WEIGHTS
    eps_f = torch.randn((T, KF, 2), generator=gen, device=dev)
    layers = tuple(model.layers)
    n_mlp, n_bf = rk.num_weights(layers), rk.KERNEL_BF_WEIGHTS
    step, prods = mlp_flops(layers), mlp_products(layers)
    texels = 2 * (T - 1)

    def fused_bytes(k, n_w, surface):
        return 4 * (T * k * 2 + 2 * T * k + 2 * k + T * 2 + n_w + 7 + 4
                    + (n_f if surface == "field" else texels * k))

    def pass1_bytes(k, n_w, surface):
        return 4 * (T * 2 + n_w + 7 + 4 + 2 * k + (
            n_f if surface == "field" else min(
                costmap.height * costmap.width, texels * k))) + 16

    def bounds(nbytes, k, step_ops, step_prods, surface):
        """(fp32 bound, bf16 tensor-core bound) of k rollouts."""
        n_evals = k * (T - 1) * 2 if surface == "field" else 0
        fp32 = bound(nbytes, k * T * step_ops + n_evals * f_ops)
        tc = bf16_bound(nbytes, k * T * (step_ops - step_prods)
                        + n_evals * (f_ops - f_prod), k * T * step_prods,
                        3 * n_evals * f_prod)
        return fp32, tc

    spec_steps = (mlp_flops(SPEC_LAYERS[0]), mlp_products(SPEC_LAYERS[0]))
    timed = {
        # name: (prepare(precision), K, bytes, ops a step, products a step,
        #        surface, plain(precision), replaces, reps)
        "fused_exact_rollout_cost": (
            lambda p: rk.prepare_fused_exact_rollout_cost(
                model, params, cfg, cp, costmap, start, U, eps,
                precision=p)[0], K, fused_bytes(K, n_mlp, "exact"), step,
            prods, "exact", lambda p: rk.fused_rollout_cost_plain(
                model, params, cfg, cp, costmap, start, U, eps,
                precision=p), 1013, "small"),
        "fused_exact_rollout_cost_bf": (
            lambda p: rk.prepare_fused_exact_rollout_cost(
                bmodel, bparams, bcfg, cp, costmap, start, U, eps_b,
                precision=p)[0], KB, fused_bytes(KB, n_bf, "exact"),
            BF_STEP_OPS, BF_PRODUCTS, "exact",
            lambda p: rk.fused_rollout_cost_plain(
                bmodel, bparams, bcfg, cp, costmap, start, U, eps_b,
                precision=p), 1013, "small"),
        "dynamics_chain": (
            lambda p: rk.prepare_dynamics_chain(
                model, params, cfg, start, U, eps, precision=p)[0], K,
            4 * (11 * T * K + 2 * T + n_mlp + 7 + 4), step, prods, "chain",
            lambda p: rk.dynamics_chain_plain(model, params, cfg, start, U,
                                              eps, precision=p), 389,
            "small"),
        "fused_rollout_cost": (
            lambda p: rk.prepare_fused_rollout_cost(
                model, params, cfg, cp, field, start, U, eps_f,
                precision=p)[0], KF, fused_bytes(KF, n_mlp, "field"), step,
            prods, "field", lambda p: rk.fused_rollout_cost_plain(
                model, params, cfg, cp, field, start, U, eps_f,
                precision=p), 606, "large"),
        "fused_rng_costs": (
            lambda p: rk.prepare_fused_rng_costs(
                model, params, cfg.replace(num_rollouts=KC, kernel_rng=True),
                cp, costmap, start, U, key, precision=p)[0], KC,
            pass1_bytes(KC, n_mlp, "exact"), step + STREAM_OPS, prods,
            "exact", lambda p: rk.fused_rng_costs_plain(
                model, params, cfg.replace(num_rollouts=KC, kernel_rng=True),
                cp, costmap, start, U, key, precision=p), 1221, "large"),
        "fused_rng_costs_bf": (
            lambda p: rk.prepare_fused_rng_costs(
                bmodel, bparams, bcfg.replace(num_rollouts=KC,
                                              kernel_rng=True),
                cp, costmap, start, U, key, precision=p)[0], KC,
            pass1_bytes(KC, n_bf, "exact"), BF_STEP_OPS + STREAM_OPS,
            BF_PRODUCTS, "exact", lambda p: rk.fused_rng_costs_plain(
                bmodel, bparams, bcfg.replace(num_rollouts=KC,
                                              kernel_rng=True),
                cp, costmap, start, U, key, precision=p), 1221, "large"),
        "fused_rng_costs_field": (
            lambda p: rk.prepare_fused_rng_costs(
                model, params, cfg.replace(num_rollouts=KC, kernel_rng=True),
                cp, field, start, U, key, precision=p)[0], KC,
            pass1_bytes(KC, n_mlp, "field"), step + STREAM_OPS, prods,
            "field", lambda p: rk.fused_rng_costs_plain(
                model, params, cfg.replace(num_rollouts=KC, kernel_rng=True),
                cp, field, start, U, key, precision=p), 1221, "large"),
        f"fused_exact_rollout_cost{label}": (
            lambda p: rk.prepare_fused_exact_rollout_cost(
                spec_model, spec_params, spec_cfg, cp, costmap, start, U,
                eps_s, precision=p)[0], KS,
            fused_bytes(KS, rk.num_weights(SPEC_LAYERS[0]), "exact"),
            *spec_steps, "exact", lambda p: rk.fused_rollout_cost_plain(
                spec_model, spec_params, spec_cfg, cp, costmap, start, U,
                eps_s, precision=p), 1013, "small")}
    rows = []
    for name, (prep, k_n, nbytes, ops, prod, surface, plain, replaces,
               size) in timed.items():
        launch = {p: prep(p) for p in ("highest", P)}
        reps = PREC_TIME_REPS[size]
        runs = {"highest": [], P: []}
        for p in ("highest", P, P, "highest"):
            runs[p].append(cuda_ms(launch[p], reps))
        ms, ms32 = statistics.mean(runs[P]), statistics.mean(runs["highest"])
        plain_ms = cuda_ms(lambda: plain(P), PLAIN_REPS, 0)
        fp32, tc = bounds(nbytes, k_n, ops, prod, surface)
        dname = launch[P].name
        geom = launch[P].geometry
        print(f"[timing] precision {dname} K={k_n} T={T}"
              + (f" {geometry_label(geom)}" if geom is not None else "")
              + f": 'default' {ms:.4f} ms, its float32 instance "
              f"{ms32:.4f} ms ({ms / ms32:.3f}x; runs "
              f"{[round(v, 4) for v in runs[P]]} against "
              f"{[round(v, 4) for v in runs['highest']]}), plain "
              f"{plain_ms:.3f} ms, bf16 tensor-core bound {tc[0]:.5f} ms "
              f"({tc[1]}), fp32 bound {fp32[0]:.5f} ms ({fp32[1]}) ({card})")
        check(dname in errs and launches.get(dname, 0) > 0,
              f"precision: {dname} was not held against its plain version "
              "or not launched by a drive")
        rows.append({
            "name": dname, "route": "cuda", "source": src,
            "replaces": f"autorally_tpu/ops/rollout_kernel.py:{replaces}",
            "launches": launches[dname], "max_abs_err": errs[dname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": tc[0],
            "bound_by": tc[1], "library_ms": None, "fp32_bound_ms": fp32[0],
            "fp32_instance_ms": ms32, "K": k_n, "precision": P,
            "geometry": geometry_label(geom) if geom is not None else None})
        del launch
    results["held_errors"] = held
    results["closer"] = closer
    print(f"[precision] instances held by PREC_CLOSER in a case that can "
          f"tell: {met}")
    missing = [inst for inst, cases in met.items() if not cases]
    check(not missing, f"precision: no held case could tell 'default' from "
          f"float32's noise for {missing}")
    return {"rows": rows, "results": results}


# -- phase 32: the physics simulator and the ML loop --------------------------

PHYS_PERIODS = 250                     # (a): 5 s at 50 Hz a script
PHYS_DT = 0.02
PHYS_RTOL, PHYS_ATOL = 1e-5, 1e-4      # tests/test_torch_sim_vehicle.py
PHYS_BIT_PERIODS = 100                 # (a): captured against eager
PHYS_TIME_REPS = {"eager": 20, "captured": 200}
SIM_NODE_SECONDS, SIM_NODE_HZ = 3, 50  # (b)
SIM_NODE_WORLD = dict(name="smoke", spawn_x=12.5, spawn_y=-3.0,
                      spawn_yaw=0.4, mu=0.55)
ML_K, ML_T = 768, 60                   # (c): ml_loop_demo's own width
ML_TICKS = 500                         # each drive, cut in ticks
ML_EPOCHS = 60                         # the demo's default
ML_BUDGET_MS = 20.0
PHYS_B3_TICKS = 200                    # (d): at K=KS
PHYS_B3_MIN_SPEED = 2.0                # (d): the JAX closed-loop tests' bound
PHYS_B3_MIN_PATH = 5.0                 # (d): metres in the 4 s drive


def phys_gentle(t):
    """steering 0.2 sin(0.7 t), throttle 0.3 + 0.1 sin(0.3 t)."""
    return [0.2 * np.sin(0.7 * t), 0.3 + 0.1 * np.sin(0.3 * t), 0.0]


def phys_hard(t):
    """Full-lock steering flipping every 2 pi s, throttle 0.9, the front
    brake from t = 8 s."""
    return [1.0 if int(t // (2 * np.pi)) % 2 == 0 else -1.0, 0.9,
            1.0 if t >= 8.0 else 0.0]


PHYS_SCRIPTS = {"gentle": phys_gentle, "hard": phys_hard}


def timed_solves(ctrls, samples: list):
    """Wrap each controller's ``compute_control`` (the predicted one's
    solve too) to append its host-clock ms to ``samples``; the solve ends
    with its trajectory cost read back.  Returns an undo."""
    for ctrl in ctrls:
        inner = ctrl.compute_control

        def timed(state, _inner=inner):
            t0 = time.perf_counter()
            _inner(state)
            samples.append((time.perf_counter() - t0) * 1e3)

        ctrl.compute_control = timed
    return lambda: [vars(c).pop("compute_control", None) for c in ctrls]


def physics_drive(rk, tag, loop, ticks, names, card, logf=None) -> dict:
    """``ticks`` ticks of ``loop.drive`` (``ml_loop_demo.MLLoop``) with
    every launch counter set to 0 just before and read just after: exactly
    two launches of each of ``names`` a tick (the two solves), none of any
    other and no plain-version call; the solves' p50 / p99 against 20 ms."""
    solves = []
    undo = timed_solves((loop.actual, loop.predicted), solves)
    rk.LAUNCHES.clear()
    try:
        with PlainCalls(rk) as plain:
            m = loop.drive(ticks, logf=logf)
    finally:
        undo()
    got = dict(rk.LAUNCHES)
    want = dict.fromkeys(names, 2 * ticks)
    m.update(launches=got, solve_ms=(float(np.percentile(solves, 50)),
                                     float(np.percentile(solves, 99))),
             ticks_per_s=m["ticks"] / m["wall_s"], solves=len(solves))
    del m["timing"]
    print(f"[physics {tag}] K={loop.cfg.num_rollouts} "
          f"T={loop.cfg.num_timesteps} {ticks} ticks: mean speed "
          f"{m['mean_speed']:.3f} m/s, |speed err| {m['mean_speed_err']:.3f}"
          f", path {m['path_m']:.2f} m"
          f"; solve p50 {m['solve_ms'][0]:.3f} ms p99 {m['solve_ms'][1]:.3f}"
          f" ms ({len(solves)} solves, host clock); {m['ticks_per_s']:.1f} "
          f"ticks/s ({m['wall_s']:.2f} s); launches {got}; plain-version "
          f"calls {plain.calls} ({card})")
    check(got == want, f"physics {tag}: launches {got}, expected {want}")
    check(not any(plain.calls.values()), f"physics {tag}: a plain version "
          f"ran on the card: {plain.calls}")
    check(len(solves) == 2 * ticks, f"physics {tag}: {len(solves)} solves "
          f"in {ticks} ticks")
    check(m["solve_ms"][1] <= ML_BUDGET_MS, f"physics {tag}: solve p99 "
          f"{m['solve_ms'][1]:.3f} ms over {ML_BUDGET_MS} ms")
    return m


def physics_sim_phase(card, dev=None) -> dict:
    """Phase 32 (a)-(b): the physics simulator (``sim/``) on the card
    against the CPU, and ``sim_node --physics`` as its own process.  They
    run no kernel of the port's library, so ``main`` runs them while the
    default library builds (see the module's docstring)."""
    import shutil
    import tempfile

    import torch

    from autorally_tpu_torch.runtime.realtime_gate import free_udp_ports
    from autorally_tpu_torch.sim import VehicleParams
    from autorally_tpu_torch.sim.description import (DEFAULT_URDF,
                                                     WorldDescription,
                                                     save_world)
    from autorally_tpu_torch.sim.plant import VehiclePeriod
    from autorally_tpu_torch.sim.vehicle import init_sim_state
    from torch.profiler import ProfilerActivity, profile

    dev = dev or torch.device("cuda", 0)
    vp = VehicleParams()
    results = {}

    # (a) vehicle_step on the card against the CPU; captured against eager
    for name, script in PHYS_SCRIPTS.items():
        cmds = [np.float32(script(i * PHYS_DT)) for i in range(PHYS_PERIODS)]
        runs = {}
        for where, device, eager in (("cpu", "cpu", True),
                                     ("captured", dev, False),
                                     ("eager", dev, True)):
            period = VehiclePeriod(vp, init_sim_state(device=device),
                                   PHYS_DT, 20, device, eager=eager)
            n = PHYS_BIT_PERIODS if where == "eager" else PHYS_PERIODS
            t0 = time.perf_counter()
            runs[where] = np.stack([period.step(c) for c in cmds[:n]])
            runs[where + "_s"] = time.perf_counter() - t0
            if where == "captured":
                check(period.capture_count == 1, f"physics {name}: "
                      f"{period.capture_count} captures")
        cpu, card_s = runs["cpu"], runs["captured"]
        err = np.abs(card_s - cpu)
        ratio = float((err / (PHYS_ATOL + PHYS_RTOL * np.abs(cpu))).max())
        bits = bool(np.array_equal(runs["eager"],
                                   card_s[:PHYS_BIT_PERIODS]))
        results[f"{name}_max_abs_err"] = float(err.max())
        results[f"{name}_tolerance_ratio"] = ratio
        print(f"[physics (a)] {name}: {PHYS_PERIODS} periods on the card "
              f"(captured, {runs['captured_s']:.2f} s) against the CPU "
              f"({runs['cpu_s']:.2f} s): max abs err {err.max():.3e}, "
              f"largest err / (atol {PHYS_ATOL} + rtol {PHYS_RTOL} |x|) "
              f"{ratio:.3f}; the captured period bit for bit the eager one "
              f"over {PHYS_BIT_PERIODS} periods: {bits}; final speed "
              f"{cpu[-1, 5]:.3f} m/s ({card})")
        check(np.isfinite(card_s).all(), f"physics {name}: non-finite")
        check(ratio <= 1.0, f"physics {name}: the card's states differ from "
              f"the CPU's beyond rtol {PHYS_RTOL} / atol {PHYS_ATOL}")
        check(bits, f"physics {name}: the captured period differs from "
              f"the eager one")
    # a period's ms, eager and captured, and the graph's nodes
    timing = {}
    cmd = np.float32(phys_gentle(1.0))
    for mode in ("eager", "captured"):
        period = VehiclePeriod(vp, init_sim_state(vx=3.0, device=dev),
                               PHYS_DT, 20, dev, eager=mode == "eager")
        period.step(cmd)
        reps = PHYS_TIME_REPS[mode]
        device_run = period._run if mode == "eager" else period.graph.replay
        host = []
        for _ in range(reps):
            t0 = time.perf_counter()
            period.step(cmd)
            host.append((time.perf_counter() - t0) * 1e3)
        timing[mode] = {"cuda_ms": cuda_ms(device_run, reps),
                        "host_ms": statistics.median(host)}
        if mode == "captured":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                period.graph.replay()
                torch.cuda.synchronize()
            timing["nodes"] = sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    results["period"] = timing
    eager = timing["eager"]
    print(f"[physics (a)] a period (20 substeps): eager "
          f"{eager['cuda_ms']:.3f} ms device (CUDA events), "
          f"{eager['host_ms']:.3f} ms host; captured "
          f"{timing['captured']['cuda_ms']:.3f} ms device, "
          f"{timing['captured']['host_ms']:.3f} ms host (command in, "
          f"replay, state out); the graph's nodes {timing['nodes']} "
          f"(profiler) ({card})")
    check(timing["nodes"] > 0, "physics: no device work in a replay")

    work = tempfile.mkdtemp(prefix="physics_")
    try:
        # (b) sim_node --physics as its own process
        world = os.path.join(work, "world.json")
        save_world(WorldDescription(**SIM_NODE_WORLD), world)
        log = os.path.join(work, "sim_node.jsonl")
        pose, ctrl = free_udp_ports(2)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [HERE] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "autorally_tpu_torch.tools.sim_node",
             "--physics", "--urdf", DEFAULT_URDF, "--world", world,
             "--duration", str(SIM_NODE_SECONDS), "--hz", str(SIM_NODE_HZ),
             "--log", log, "--pose-port", str(pose), "--control-port",
             str(ctrl)], cwd=HERE, env=env, capture_output=True, text=True,
            timeout=300)
        node_s = time.perf_counter() - t0
        print(f"[physics (b)] sim_node: rc {out.returncode} in {node_s:.2f}"
              f" s: {out.stdout.strip()}")
        check(out.returncode == 0, f"sim_node --physics failed: "
              f"{out.stderr[-2000:]}")
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        truth = [r for r in rows if r["topic"] == "ground_truth/state"]
        done = (f"done at t={SIM_NODE_SECONDS:.2f}s pos=("
                f"{SIM_NODE_WORLD['spawn_x']:.2f},"
                f"{SIM_NODE_WORLD['spawn_y']:.2f})")
        missed = re.search(r"missed=(\d+)", out.stdout)
        results["sim_node"] = {"rows": len(truth), "seconds": node_s,
                               "missed": int(missed.group(1))
                               if missed else None}
        print(f"[physics (b)] {len(truth)} ground_truth/state rows, the "
              f"pacer's missed periods {results['sim_node']['missed']} "
              f"({card})")
        check(done in out.stdout and "on cuda" in out.stdout,
              f"sim_node did not end at the world's spawn on the card: "
              f"{out.stdout}")
        check(len(truth) == SIM_NODE_SECONDS * SIM_NODE_HZ,
              f"sim_node logged {len(truth)} ground_truth/state rows")
        check(missed is not None, "sim_node printed no missed periods")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


def physics_phase(rk, card, dev=None, sim=None) -> dict:
    """Phase 32 (c)-(d): the drive -> log -> train -> hot-swap loop on the
    card, and BASELINE #3 trained on its log (see the module's
    docstring); with ``sim``, (a)-(b)'s results, returned beside
    them."""
    import shutil
    import tempfile

    import torch

    from autorally_tpu_torch import ml_loop_demo
    from autorally_tpu_torch.ml import instantaneous_errors
    from autorally_tpu_torch.ml import trainer
    from autorally_tpu_torch.models import NeuralNetDynamics

    dev = dev or torch.device("cuda", 0)
    results = dict(sim or {})
    work = tempfile.mkdtemp(prefix="physics_")
    try:
        # (c) the drive -> log -> train -> hot-swap loop
        loop = ml_loop_demo.MLLoop(ML_K, ML_T, 6.0, device=dev,
                                   model_path=None)
        print(f"[physics (c)] ml_loop_demo.MLLoop K={ML_K} T={ML_T} on "
              f"{loop.device}; {loop.note}")
        names = ("fused_exact_rollout_cost", "dynamics_chain")
        drive_log = os.path.join(work, "drive.jsonl")
        with open(drive_log, "w") as f:
            before = physics_drive(rk, "(c) before", loop, ML_TICKS, names,
                                   card, logf=f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = loop.fine_tune(drive_log, ML_EPOCHS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rmse0, rmse1 = float(fit["rmse0"].mean()), float(fit["rmse1"].mean())
        print(f"[physics (c)] fine-tune: {fit['rows']} rows, {ML_EPOCHS} "
              f"epochs in {fit_s:.2f} s; one-step RMSE {rmse0:.4f} -> "
              f"{rmse1:.4f} ({card})")
        check(rmse1 < rmse0, "physics (c): the fine-tune did not improve "
              "the fit")
        params1 = fit["params1"]
        loop.plant.push_model_params(params1)
        after_log = os.path.join(work, "after.jsonl")
        with open(after_log, "w") as f:
            after = physics_drive(rk, "(c) after", loop, ML_TICKS, names,
                                  card, logf=f)
        swapped = all(
            torch.equal(got, want) for c in (loop.actual, loop.predicted)
            for key in ("weights", "biases")
            for got, want in zip(c.model_params[key], params1[key]))
        print(f"[physics (c)] after the swap both controllers hold the "
              f"fine-tuned weights bit for bit: {swapped}")
        check(swapped, "physics (c): the swap did not reach both "
              "controllers")
        results["ml_loop"] = {"before": before, "after": after,
                              "rmse_before": rmse0, "rmse_after": rmse1,
                              "fine_tune_s": fit_s, "rows": fit["rows"]}

        # (d) BASELINE #3 trained on the after-swap physics log (the first
        # drive's only reverses), driving the plant
        layers = tuple(B3_LAYERS)
        cfg = dict(trainer.DEFAULTS)
        cfg.update(log_jsonl=after_log,
                   results_dir=os.path.join(work, "b3"),
                   nn_layers=list(B3_LAYERS), standardize_data=True,
                   epochs=B3_EPOCHS, horizons=list(B3_HORIZONS))
        t0 = time.perf_counter()
        res = trainer.run(cfg, device=dev)
        run_s = time.perf_counter() - t0
        model, params = NeuralNetDynamics.from_npz(
            os.path.join(cfg["results_dir"], "model.npz"), 1.0 / B3_HZ,
            device=dev)
        check(model.layers == layers, f"from_npz read {model.layers}")
        d = np.load(os.path.join(cfg["results_dir"], "dataset.npz"))
        fresh_model = NeuralNetDynamics(1.0 / B3_HZ, layers=layers,
                                        device=dev)
        trained = instantaneous_errors(model, params, d["inputs"],
                                       d["labels"])["rmse"].mean()
        fresh = instantaneous_errors(fresh_model, fresh_model.init_params(9),
                                     d["inputs"], d["labels"])["rmse"].mean()
        ratio = float(trained / fresh)
        x = d["inputs"]
        span = {"rows": int(len(x)),
                "speed": (float(x[:, 1].min()), float(x[:, 1].max())),
                "yaw_rate": (float(-x[:, 3].max()), float(-x[:, 3].min()))}
        print(f"[physics (d)] the after-swap physics log: {span['rows']} "
              f"rows, speed "
              f"{span['speed'][0]:.3f}..{span['speed'][1]:.3f} m/s, yaw "
              f"rate {span['yaw_rate'][0]:.3f}..{span['yaw_rate'][1]:.3f} "
              f"rad/s; trainer.run {run_s:.2f} s ({B3_EPOCHS} epochs), best "
              f"val loss {res['best_val_loss']:.5f}; RMSE trained "
              f"{trained:.4f} against a fresh init's {fresh:.4f} (ratio "
              f"{ratio:.3f}) ({card})")
        check(ratio < B3_MAX_RMSE_RATIO, f"physics (d): RMSE ratio "
              f"{ratio:.3f}, not under {B3_MAX_RMSE_RATIO}")
        _, _, scfg = spec_setup(layers, dev)
        b3 = ml_loop_demo.MLLoop(cfg=scfg, model=model, params0=params,
                                 device=dev)
        label = spec_label(layers)
        drive_b3 = physics_drive(
            rk, "(d) BASELINE #3", b3, PHYS_B3_TICKS,
            (f"fused_exact_rollout_cost_{label}", f"dynamics_chain_{label}"),
            card)
        check(drive_b3["mean_speed"] >= PHYS_B3_MIN_SPEED
              and drive_b3["path_m"] >= PHYS_B3_MIN_PATH,
              f"physics (d): the trained model's car drove "
              f"{drive_b3['path_m']:.2f} m at a mean speed of "
              f"{drive_b3['mean_speed']:.3f} m/s, not {PHYS_B3_MIN_PATH} m "
              f"forward at {PHYS_B3_MIN_SPEED} m/s or more")
        results["baseline3"] = {"log": span, "trainer_s": run_s,
                                "rmse_ratio": ratio, "drive": drive_b3}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# -- phase 33: the cost-parameter sweep on the lane forms of kernels 1-2 ----

# The sweep's two widths (tools/param_sweep.py): its defaults (the seeded
# 6-32-32-4, K=512, desired_speed 5, 6, 7 on the oval) and a 12-lane grid
# at BASELINE #1's K=1920, cut in ticks (400 and 100 since phase 36 came,
# 200 and 50 since phases 38-39; the tool's default is 800).
LANE_SWEEPS = {
    "L3": (["desired_speed=5,6,7"], 512, 200),
    "L12": (["desired_speed=4,5,6,7", "gamma=0.05,0.15,0.6"], K, 50),
}
LANE_SHAPES = ((3, 512), (12, K))           # (b): (L, K)
LANE_PROFILE_TICKS = 5                     # (c): replayed under the profiler
LANE_BF_TICKS = 20                         # (c): a 3-lane BF sweep
LANE_TIME_REPS = 50
# the lane instances of the default library (ptxas' names, phase 1): the
# kernels' instances with kLanes set
LANE_INSTANCES = (
    ("fused_exact_kernel<Mlp, lanes>", "fused_exact_kernel<Bf, lanes>")
    + tuple(f"fused_exact_group_kernel<{g}, lanes>" for g in (8, 16, 32))
    + ("dynamics_chain_kernel<Mlp, lanes>", "dynamics_chain_kernel<Bf, lanes>",
       "dynamics_chain_warp_kernel<Mlp, lanes>",
       "dynamics_chain_warp_kernel<Bf, lanes>"))


def lane_cost_grid(L: int):
    """A stacked CostParams of L lanes whose every coefficient that the
    kernels read differs from lane to lane (phase 33 (b))."""
    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.tools.param_sweep import stack_cost_params

    return stack_cost_params(CostParams(), [dict(
        desired_speed=4.0 + 0.5 * i, speed_coeff=4.25 * (1 + 0.1 * i),
        track_coeff=200.0 - 10.0 * i, max_slip_ang=1.25 - 0.05 * i,
        slip_penalty=10.0 + i, crash_coeff=10000.0 - 500.0 * i,
        boundary_threshold=0.65 - 0.02 * i, discount=0.1 + 0.01 * i)
        for i in range(L)])


def lane_inputs(L: int, K_: int, dev, seed: int):
    """L start states about the oval's start (0.3 m apart, 0 to 3 m/s), L
    plans U (T, 2) and one eps (T, K, 2), from ``seed``."""
    import torch
    from autorally_tpu_torch import drive_oval

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = torch.tensor(drive_oval.START, dtype=torch.float32,
                         device=dev).repeat(L, 1)
    state[:, :2] += 0.3 * torch.randn((L, 2), generator=gen, device=dev)
    state[:, 4] = torch.linspace(0.0, 3.0, L, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(L, T, 1)
    U[..., 0] = 0.2 * torch.randn((L, T), generator=gen, device=dev)
    eps = torch.randn((T, K_, 2), generator=gen, device=dev)
    return state, U, eps


def lane_hold(tag, lanes, plain, solo, L: int, K_: int, card, geoms=(None,),
              forced=None) -> dict:
    """The hold of a fused lane form (kernel 1 or 3), phases 33 (b) and 34
    (b)-(c): ``plain()``, its plain version, once, timed; then in each
    geometry of ``geoms`` (forced by ``forced``; None: the wrapper's own)
    the launch of ``lanes()`` (a ``prepare_*``: ``(launch, (costs, u_seq,
    crash))``, not counted) against it by phase 11's rule (costs and crash
    flags in all but 1 % of a lane's rollouts, u_seq bit for bit), and each
    lane i bit for bit the launch of ``solo(i)`` in the lane launch's
    geometry.  Returns the max cost error, the plain version's ms and each
    geometry's (launch, outputs)."""
    import contextlib

    import torch

    def in_geometry(g):
        return (forced(*g[:2]) if forced is not None and g is not None
                else contextlib.nullcontext())

    (pc, pu, px), plain_ms = plain_timed(plain)
    err, runs = 0.0, []
    for geom in geoms:
        with in_geometry(geom):
            launch, out = lanes()
            launch()
            torch.cuda.synchronize()
        kc, ku, kx = out
        g = launch.geometry
        label = f"{tag} in {geometry_label(g)}"
        err = max(err, max(agreement(label, f"lane {i}", kc[i], kx[i], pc[i],
                                     px[i], K_, limit=K_ // 100)
                            for i in range(L)))
        check(bit_equal(ku, pu), f"{label}: u_seq differs from its plain "
              "version's")
        same = []
        with in_geometry(g):
            for i in range(L):
                one, o = solo(i)
                one()
                torch.cuda.synchronize()
                same.append(all(bit_equal(a[i], b) for a, b in zip(out, o)))
        print(f"[{label}] {launch.name} ({g.grid} x {L} blocks of "
              f"{g.block}): each lane bit for bit the solo instance in that "
              f"geometry: {same} ({card})")
        check(all(same), f"{label}: a lane differs from the solo instance")
        runs.append((launch, out))
    return {"err": err, "plain_ms": plain_ms, "runs": runs}


def lanes_held(rk, tag, model, params, cfg, cp, cm, state, U, eps, bf,
               card) -> dict:
    """Phase 33 (b) at one (L, K): kernel 1's lane form against its plain
    version and each lane against the solo instance (``lane_hold``),
    kernel 2's at K and at K = 1 against theirs (states within STATE_RTOL
    / STATE_ATOL, u_seq bit for bit) and each lane bit for bit its solo
    instance in the lane launch's geometry.  Launches made here are not
    counted (``prepare_*``).  Returns kernel 1's max cost error, kernel
    2's max state error at K and at K = 1 (``chain_err``) and the
    geometries."""
    import torch
    from autorally_tpu_torch.config import lane_cost_params
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry, forced_geometry)

    L, K_ = state.shape[0], eps.shape[1]
    lanes = lane_cost_params(cp)
    held = lane_hold(
        f"lanes {tag} kernel 1",
        lambda: rk.prepare_fused_exact_rollout_cost_lanes(
            model, params, cfg, cp, cm, state, U, eps),
        lambda: rk.fused_rollout_cost_lanes_plain(
            model, params, cfg, cp, cm, state, U, eps),
        lambda i: rk.prepare_fused_exact_rollout_cost(
            model, params, cfg, lanes[i], cm, state[i], U[i], eps),
        L, K_, card, forced=forced_geometry)
    err, g = held["err"], held["runs"][0][0].geometry
    chains, chain_err = {}, {}
    for name, e in (("K", eps), ("K=1", torch.zeros_like(eps[:, :1]))):
        launch2, (ks, ku2) = rk.prepare_dynamics_chain_lanes(
            model, params, cfg, state, U, e)
        launch2()
        ps, pu2 = rk.dynamics_chain_lanes_plain(model, params, cfg, state,
                                                U, e)
        torch.cuda.synchronize()
        g2 = launch2.geometry
        close = torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL)
        serr = (ks - ps).abs().max().item()
        same = []
        with forced_chain_geometry(g2.group, g2.block):
            for i in range(L):
                one, out = rk.prepare_dynamics_chain(model, params, cfg,
                                                     state[i], U[i], e)
                one()
                torch.cuda.synchronize()
                same.append(bit_equal(ks[i], out[0])
                            and bit_equal(ku2[i], out[1]))
        print(f"[lanes {tag}] kernel 2's lane form at {name} in "
              f"{geometry_label(g2)}: max|state err| {serr:.3e} against "
              f"the plain version (rtol {STATE_RTOL}, atol {STATE_ATOL}: "
              f"{close}), u_seq bit for bit {bit_equal(ku2, pu2)}; each "
              f"lane bit for bit the solo instance: {same} ({card})")
        check(close and bit_equal(ku2, pu2), f"lanes {tag}: kernel 2 at "
              f"{name} differs from its plain version")
        check(all(same), f"lanes {tag}: a lane of kernel 2 at {name} "
              "differs from the solo instance")
        chains[name] = g2
        chain_err[name] = serr
    return {"err": err, "geometry": g, "chain": chains,
            "chain_err": chain_err}


def lanes_geometries(rk, model, params, cfg, cp, cm, state, U, eps, card):
    """Phase 33 (b): kernel 1's lane form in every geometry of
    ``rk.GEOMETRIES`` and kernel 2's in both of ``rk.CHAIN_GEOMETRIES``,
    each bit for bit the first (so that every lane instance of the library
    runs and agrees)."""
    def kernel1():
        launch, out = rk.prepare_fused_exact_rollout_cost_lanes(
            model, params, cfg, cp, cm, state, U, eps)
        launch()
        return out

    def kernel2():
        launch, out = rk.prepare_dynamics_chain_lanes(model, params, cfg,
                                                      state, U, eps)
        launch()
        return out

    hold_geometries("lanes geometries", list(rk.GEOMETRIES), kernel1,
                    lambda label, out: None)
    hold_geometries("lanes chain geometries", list(rk.CHAIN_GEOMETRIES),
                    kernel2, lambda label, out: None, chain=True)


def lanes_row(rk, name, launch, plain_fn, L: int, K_: int, n_w: int,
              step_ops: int, chain: bool, err, launches: dict, card) -> dict:
    """The ``kernels`` row of a lane form: its time (CUDA events), its
    plain version's, its bound (every input read once, eps shared, every
    output written once: L x the solo row's work) and the counted
    launches."""
    ms = cuda_ms(launch, LANE_TIME_REPS)
    plain = plain_timed(plain_fn)[1]        # warmed by the holds
    if chain:
        nbytes = 4 * (2 * T * K_ + L * (2 * T + 7 + 9 * T * K_) + n_w + 4)
    else:
        nbytes = 4 * (2 * T * K_ + L * (2 * T + 7 + len(rk._FLOAT_SCALARS)
                                        + 2 * K_ + 2 * T * K_
                                        + 2 * K_ * (T - 1)) + n_w + 4)
    bnd, by = bound(nbytes, step_ops * L * K_ * T)
    g = launch.geometry
    model = "Bf" if "_bf" in name else "Mlp"
    instance = (("dynamics_chain_warp_kernel" if g.group > 1
                 else "dynamics_chain_kernel") + f"<{model}, lanes>" if chain
                else f"fused_exact_group_kernel<{g.group}, lanes>"
                if g.group > 1 else f"fused_exact_kernel<{model}, lanes>")
    print(f"[timing] {name} L={L} K={K_}: {ms:.4f} ms in "
          f"{geometry_label(g)} ({g.grid} x {L} blocks), plain {plain:.3f} "
          f"ms, bound {bnd:.5f} ms ({by}) ({card})")
    return {"name": name, "route": "cuda",
            "source": "autorally_tpu_torch/csrc/rollout_kernels.cu",
            "replaces": "autorally_tpu/ops/rollout_kernel.py:" + (
                "389" if chain else "1013"),
            "launches": launches.get(name, 0), "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "K": K_, "lanes": L,
            "geometry": geometry_label(g), "instance": instance}


def sweep_launches(rk, runner, args, card, kw=None,
                   fused: str = "fused_exact") -> dict:
    """Phase 33 (c): ``LANE_PROFILE_TICKS`` replayed ticks of ``runner``'s
    sweep under the profiler (after a warm-up run of the profiler, which
    it discards): the lane forms of the fused kernel (kernel 1, or kernel 3
    with ``fused="fused_field"``, or pass 1 with ``fused="fused_rng"``,
    then pass 2's too) and of kernel 2 and no solo instance, at most the
    two launches of each that the captured tick holds (the wrappers count
    exactly 2 + 2 (+ 2) in the capture), and the device events (graph
    nodes) a tick.  A record the profiler drops is reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    kw = kw or {}
    runner.run(*args, **kw)                    # captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            runner.run(*args, **kw)            # replays only
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    n = runner.n_ticks
    # a lane instance's name ends its template arguments with kLanes
    lane = lambda x: re.search(r"(<|, )true>", x) is not None
    kernels = {"kernel 1": fused, "kernel 2": "dynamics_chain"}
    if fused == "fused_rng":
        kernels["pass 2"] = "weighted_update"
    count = {k: sum(frag in x and lane(x) for x in names)
             for k, frag in kernels.items()}
    count["solo"] = sum(("fused_" in x or "dynamics_chain" in x
                         or "weighted_update" in x) and not lane(x)
                        for x in names)
    dropped = 2 * len(kernels) * n - sum(count[k] for k in kernels)
    print(f"[sweep launches] {n} replayed ticks (profiler): " + ", ".join(
        f"{kernels[k]} lanes {count[k]}" for k in kernels)
        + f", solo instances {count['solo']}, lane launches the profiler did "
        f"not record {dropped}; {len(names)} device events "
        f"({len(names) / n:.0f} a tick) ({card})")
    check(count["solo"] == 0 and all(0 < count[k] <= 2 * n for k in kernels),
          f"sweep: launches {count}, expected the lane forms alone, 2 of "
          "each a replayed tick")
    return {"launches_per_tick": {k: count[k] / n for k in kernels},
            "graph_nodes_per_tick": len(names) / n,
            "profiler_dropped": dropped}


def timed_replays(runner, run):
    """``run()``, a run of ``runner`` that replays its captured tick, with
    each replay timed by CUDA events: (its result, the ticks' ms, its
    seconds on the host clock)."""
    import torch

    plan = runner._captured
    graph, events = plan.graph, []

    class Timed:
        def replay(self):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            events.append((e0, e1))

    plan.graph = Timed()
    try:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        plan.graph = graph
    return out, [a.elapsed_time(b) for a, b in events], wall


def sweep_phase(rk, card, dev=None) -> dict:
    """Phase 33: the cost-parameter sweep (``tools/param_sweep.py``) on the
    lane forms of kernels 1 and 2, with the rest of the port's tools."""
    import argparse
    import shutil
    import tempfile

    import torch
    from autorally_tpu_torch import two_car_demo
    from autorally_tpu_torch.config import MPPIConfig, lane_cost_params
    from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                            NeuralNetDynamics)
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.tools import ess_demo, param_sweep
    from autorally_tpu_torch.tools.lap_eval import load_track

    dev = dev or torch.device("cuda", 0)
    results, rows = {}, []

    # (a) the lane instances' registers and spills (ptxas, phase 1) and
    # their blocks an SM at T
    for bf in (False, True):
        geoms = rk.GEOMETRIES if not bf else rk.GEOMETRIES[:1]
        for chain, gs in ((False, geoms), (True, rk.CHAIN_GEOMETRIES)):
            for G, block in gs:
                info = rk.lanes_kernel_info(2 if chain else 1, bf,
                                            rk._geometry(1, G, block), T)
                print(f"[lanes (a)] {'kernel 2' if chain else 'kernel 1'} "
                      f"{'BF' if bf else 'MLP'} G{G} block {block}: "
                      f"{info['registers']} registers, "
                      f"{info['local_bytes']} bytes of local memory, "
                      f"{info['smem_bytes']} bytes of dynamic shared memory "
                      f"at T={T}, {info['blocks_per_sm']} blocks an SM "
                      f"({card})")
    lane_regs = {n: PTXAS.get(n) for n in LANE_INSTANCES}
    print(f"[lanes (a)] ptxas: {lane_regs} registers, no spill (phase 1)")
    check(all(v is not None for v in lane_regs.values()),
          f"lanes (a): ptxas reported no {lane_regs}")
    results["registers"] = lane_regs

    # (b) every lane against its plain version and the solo instance
    cm, start_pose, _, _ = load_track("oval", device=dev)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    models = {}
    for kind, cls in (("nn", NeuralNetDynamics),
                      ("bf", BasisFunctionDynamics)):
        m = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
        models[kind] = (m, m.init_params(0))
    held = {}
    for L, K_ in LANE_SHAPES:
        cp = lane_cost_grid(L)
        state, U, eps = lane_inputs(L, K_, dev, seed=L)
        for kind, (m, p) in models.items():
            c = cfg.replace(num_rollouts=K_)
            held[L, K_, kind] = lanes_held(rk, f"(b) L={L} K={K_} {kind}", m,
                                           p, c, cp, cm, state, U, eps,
                                           kind == "bf", card)
        if (L, K_) == LANE_SHAPES[0]:
            m, p = models["nn"]
            lanes_geometries(rk, m, p, cfg.replace(num_rollouts=K_), cp, cm,
                             state, U, eps, card)

    # (c) the sweep at both widths: one capture, 2 + 2 lane launches a
    # tick, no plain version; two lanes against their solo episodes; the
    # replayed tick, graph nodes, ticks/s, and L solo episodes' wall time
    work = tempfile.mkdtemp(prefix="artt_sweep_")
    saved_npz = param_sweep.MODEL_NPZ
    try:
        npz = os.path.join(work, "seeded.npz")
        models["nn"][0].save_params(models["nn"][1], npz)
        param_sweep.MODEL_NPZ = npz
        for tag, (sweeps, K_, ticks) in LANE_SWEEPS.items():
            args = argparse.Namespace(sweep=sweeps, rollouts=K_,
                                      timesteps=T, ticks=ticks, track="oval",
                                      pallas=False)
            grid, runner, params, stacked, cmap, start = param_sweep.build(
                args, dev)
            L = len(grid)
            caps = Captures(runner)
            rk.LAUNCHES.clear()
            with PlainCalls(rk) as plain:
                t0 = time.perf_counter()
                res = param_sweep.run_sweep(runner, params, stacked, cmap,
                                            start)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            launches = dict(rk.LAUNCHES)
            print(f"[sweep {tag}] {L} lanes x {ticks} ticks at K={K_}: "
                  f"first run {first_s:.2f} s ({len(caps.seconds)} "
                  f"capture(s), {sum(caps.seconds):.2f} s), launches "
                  f"counted {launches}, plain-version calls {plain.calls} "
                  f"({card})")
            check(len(caps.seconds) == 1, f"sweep {tag}: "
                  f"{len(caps.seconds)} captures")
            check(launches == {"fused_exact_rollout_cost_lanes": 4,
                               "dynamics_chain_lanes": 4},
                  f"sweep {tag}: launches {launches}, expected 2 + 2 lane "
                  "launches in the warm-up tick and 2 + 2 in the captured "
                  "tick")
            check(not any(plain.calls.values()), f"sweep {tag}: a plain "
                  f"version ran on the card: {plain.calls}")
            check(torch.isfinite(res.states).all().item(),
                  f"sweep {tag}: a state is not finite")
            # the replayed run, timed
            again, tick_ms, wall = timed_replays(
                runner, lambda: param_sweep.run_sweep(runner, params,
                                                      stacked, cmap, start))
            check(episode_equal(again, res), f"sweep {tag}: the replayed "
                  "run differs from the first")
            rows_m = param_sweep.lane_metrics(res, grid,
                                              settle=min(200, ticks // 4))
            # launches by the profiler, on a runner of a few ticks
            short = EpisodeRunner(runner.solver, n_ticks=LANE_PROFILE_TICKS)
            prof = sweep_launches(rk, short, (params, stacked, cmap, start),
                                  card)
            # L solo episodes, two held against their lanes
            solo_runner = EpisodeRunner(runner.solver, n_ticks=ticks)
            lanes = lane_cost_params(stacked)
            gaps = {}
            t0 = time.perf_counter()
            for i, cp_i in enumerate(lanes):
                solo = solo_runner.run(params, cp_i, cmap, start)
                if i in (0, L - 1):
                    gaps[i] = {
                        "bit_equal": all(bit_equal(getattr(res, f)[i],
                                                   getattr(solo, f))
                                         for f in solo._fields),
                        "max_state_gap": (res.states[i] - solo.states)
                        .abs().max().item(),
                        "first_tick_apart": next(
                            (t for t in range(ticks) if not all(
                                bit_equal(getattr(res, f)[i, t],
                                          getattr(solo, f)[t])
                                for f in solo._fields)), None)}
            torch.cuda.synchronize()
            solo_s = time.perf_counter() - t0
            print(f"[sweep {tag}] replayed tick {np.percentile(tick_ms, 50):.4f}"
                  f" / {np.percentile(tick_ms, 99):.4f} ms p50 / p99 (CUDA "
                  f"events, {ticks} ticks), {prof['graph_nodes_per_tick']:.0f}"
                  f" graph nodes a tick, {ticks / wall:.1f} ticks/s "
                  f"({L * ticks / wall:.1f} lane-ticks/s, {wall:.2f} s "
                  f"host clock); {L} solo captured episodes {solo_s:.2f} s "
                  f"({solo_s / first_s:.2f}x the sweep's first run, "
                  f"{solo_s / wall:.2f}x its replayed run) ({card})")
            for i, g in gaps.items():
                print(f"[sweep {tag}] lane {i} against its solo captured "
                      f"episode ({ticks} ticks, every field): bit for bit "
                      f"{g['bit_equal']}; max |state gap| "
                      f"{g['max_state_gap']:.3e}, first tick apart "
                      f"{g['first_tick_apart']} ({card})")
                check(g["bit_equal"], f"sweep {tag}: lane {i} differs from "
                      "its solo episode")
            for r in rows_m:
                print(f"[sweep {tag}] {json.dumps(r)}")
            results[tag] = {"lanes": L, "K": K_, "ticks": ticks,
                            "first_run_s": first_s,
                            "capture_s": sum(caps.seconds),
                            "tick_ms_p50_p99": (
                                float(np.percentile(tick_ms, 50)),
                                float(np.percentile(tick_ms, 99))),
                            "ticks_per_s": ticks / wall,
                            "solo_episodes_s": solo_s, **prof,
                            "lane_gaps": gaps, "metrics": rows_m,
                            "launches": launches}
            # the kernels line: this width's lane launches, timed
            m, p = models["nn"]
            state = runner._captured.state[:, :].clone()
            c = runner.solver.cfg
            eps = torch.randn((T, K_, 2), device=dev)
            U = runner._captured.carries[0].U.clone()
            L1, o1 = rk.prepare_fused_exact_rollout_cost_lanes(
                m, p, c, stacked, cmap, state, U, eps)
            L2, o2 = rk.prepare_dynamics_chain_lanes(
                m, p, c, state, U, torch.zeros_like(eps[:, :1]))
            rows.append(lanes_row(
                rk, "fused_exact_rollout_cost_lanes", L1,
                lambda: rk.fused_rollout_cost_lanes_plain(
                    m, p, c, stacked, cmap, state, U, eps), L, K_,
                rk.KERNEL_NUM_WEIGHTS, mlp_flops(m.layers), False,
                max(v["err"] for (l, _, kind), v in held.items()
                    if l == L and kind == "nn"),
                launches, card))
            rows.append(lanes_row(
                rk, "dynamics_chain_lanes", L2,
                lambda: rk.dynamics_chain_lanes_plain(
                    m, p, c, state, U, torch.zeros_like(eps[:, :1])), L, 1,
                rk.KERNEL_NUM_WEIGHTS, mlp_flops(m.layers), True,
                max(v["chain_err"]["K=1"] for (l, _, kind), v in held.items()
                    if l == L and kind == "nn"),
                launches, card))
            del runner, solo_runner, short
        # the BF lanes: a 3-lane BF sweep's launches
        m, p = models["bf"]
        L3, K3 = LANE_SHAPES[0]
        bcfg = cfg.replace(num_rollouts=K3)
        bsolver = MPPISolver(m, MPPICost(), bcfg, device=dev)
        brunner = EpisodeRunner(bsolver, n_ticks=LANE_BF_TICKS)
        cp3 = lane_cost_grid(L3)
        rk.LAUNCHES.clear()
        with PlainCalls(rk) as plain:
            bres = brunner.run(p, cp3, cm, [*start_pose, 0, 0, 0, 0])
            torch.cuda.synchronize()
        blaunch = dict(rk.LAUNCHES)
        print(f"[sweep BF] {L3} lanes x {LANE_BF_TICKS} ticks at K={K3}: "
              f"launches counted {blaunch}, plain-version calls "
              f"{plain.calls}, final u_x {bres.states[:, -1, 4].tolist()} "
              f"({card})")
        check(blaunch == {"fused_exact_rollout_cost_bf_lanes": 4,
                          "dynamics_chain_bf_lanes": 4},
              f"sweep BF: launches {blaunch}")
        check(not any(plain.calls.values()), "sweep BF: a plain version ran")
        state, U, eps = lane_inputs(L3, K3, dev, seed=5)
        L1, _ = rk.prepare_fused_exact_rollout_cost_lanes(m, p, bcfg, cp3, cm,
                                                          state, U, eps)
        L2, _ = rk.prepare_dynamics_chain_lanes(
            m, p, bcfg, state, U, torch.zeros_like(eps[:, :1]))
        rows.append(lanes_row(
            rk, "fused_exact_rollout_cost_bf_lanes", L1,
            lambda: rk.fused_rollout_cost_lanes_plain(
                m, p, bcfg, cp3, cm, state, U, eps), L3, K3,
            rk.KERNEL_BF_WEIGHTS, BF_STEP_OPS, False,
            held[L3, K3, "bf"]["err"], blaunch, card))
        rows.append(lanes_row(
            rk, "dynamics_chain_bf_lanes", L2,
            lambda: rk.dynamics_chain_lanes_plain(
                m, p, bcfg, state, U, torch.zeros_like(eps[:, :1])), L3, 1,
            rk.KERNEL_BF_WEIGHTS, BF_STEP_OPS, True,
            held[L3, K3, "bf"]["chain_err"]["K=1"], blaunch, card))

        # (d) the tools: param_sweep.main, ess_demo's two modes on the
        # oval, two_car_demo on the seeded .npz
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            param_sweep.main(["--ticks", "50"])
        lines = out.getvalue().strip().splitlines()
        print(f"[tools (d)] param_sweep.main --ticks 50: {lines} ({card})")
        check(len(lines) == 4 and lines[-1].startswith("BEST "),
              "tools (d): param_sweep.main printed other lines")
        ess = {}
        for mode in ("host", "episode"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                ess[mode] = ess_demo.main(["--mode", mode, "--track", "oval",
                                           "--model", npz, "--ticks", "100"])
            print(f"[tools (d)] ess_demo --mode {mode} --track oval: "
                  f"{out.getvalue().strip()} ({card})")
        check(ess["host"]["traces_tuned"] == 0, "tools (d): ess_demo's "
              "host loop captured")
        saved_cars = two_car_demo.MODEL_NPZ
        two_car_demo.MODEL_NPZ = npz
        try:
            t0 = time.perf_counter()
            sa, sb = two_car_demo.run_two_cars(ticks=100, parked=True)
            cars_s = time.perf_counter() - t0
        finally:
            two_car_demo.MODEL_NPZ = saved_cars
        d = np.hypot(sa[:, 0] - sb[:, 0], sa[:, 1] - sb[:, 1])
        print(f"[tools (d)] two_car_demo.run_two_cars(ticks=100, "
              f"parked=True): {cars_s:.2f} s, min gap {d.min():.2f} m, A's "
              f"final u_x {sa[-1, 4]:.3f} m/s ({card})")
        check(np.isfinite(sa).all() and np.isfinite(sb).all(),
              "tools (d): two_car_demo's states are not finite")
        results["tools"] = {"ess_demo": ess, "two_cars_s": cars_s}
    finally:
        param_sweep.MODEL_NPZ = saved_npz
        shutil.rmtree(work, ignore_errors=True)
    return {"results": results, "rows": rows}


# -- phase 34: circles, the field, the ESS law and moving obstacles in lanes -

# (b) kernel 1's lane form with circle slots: {label: (slots, a lane's own)}
LANE_CIRCLE_SETS = {"16 per lane": (N_SLOTS, True),
                    "16 shared": (N_SLOTS, False),
                    "64 per lane": (64, True)}
FIELD_LANE_SHAPES = ((3, 512), (12, K), (4, 16384))   # (c): (L, K)
LANE_DRIVE_TICKS = 50                  # (d): each full-width drive, L=12
#                                        (100 before phases 38-39)
# (b)-(c) at L=12 the forms the drives run (each held at L=3 too): kernel
# 1 with 16 circles a lane's own and 16 shared, kernel 3 without circles
LANE_WIDE_L, LANE_WIDE_SETS = 12, ("16 per lane", "16 shared")
LANE_BF_DRIVE_TICKS = 20               # (d): the 3-lane BF sweeps
LANE_COEFF, LANE_INFLATION = 150.0, 0.75
# kernel 3's lane instances (ptxas' names, phase 1)
FIELD_LANE_INSTANCES = ("fused_field_kernel<Mlp, lanes>",
                        "fused_field_kernel<Bf, lanes>")


def lane_circle_sets(L: int) -> list:
    """Phase 34 (b)'s circle sets at L lanes: every one of
    ``LANE_CIRCLE_SETS``, or at ``LANE_WIDE_L`` those of
    ``LANE_WIDE_SETS``."""
    return [(label, v) for label, v in LANE_CIRCLE_SETS.items()
            if L != LANE_WIDE_L or label in LANE_WIDE_SETS]


def lane_circles(rk, model, params, cfg, state, U, slots: int,
                 per_lane: bool, seed: int):
    """Phase 34's circles on the card: (L, slots, 3), each lane's along its
    own nominal path, or with ``per_lane`` clear (slots, 3) along lane 0's,
    which every lane prices.  Three of every four slots hold a circle
    whose centre lies up to 1 m to either side of the path at a step in
    the horizon's last nine tenths, of radius 0.3-0.8 m, so that the
    circles change the costs and some rollouts run into them; every fourth
    slot is free (radius -1)."""
    import torch

    L, T_ = state.shape[0], U.shape[1]
    dev = state.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    zeros = torch.zeros((T_, 1, 2), device=dev)
    out = torch.full((L, slots, 3), -1.0, device=dev)
    for i in range(L if per_lane else 1):
        states, _ = rk.dynamics_chain_plain(model, params, cfg, state[i],
                                            U[i], zeros)
        path = states[:2, :, 0]                               # (2, T)
        steps = torch.randint(T_ // 10, T_, (slots,), generator=gen,
                              device=dev)
        side = 2.0 * torch.rand((2, slots), generator=gen, device=dev) - 1.0
        out[i, :, :2] = (path[:, steps] + side).T
        out[i, :, 2] = 0.3 + 0.5 * torch.rand(slots, generator=gen,
                                              device=dev)
        out[i, 3::4, 2] = -1.0
    return out if per_lane else out[0]


def lane_solo_circles(circles, i: int):
    """Lane i's circles of ``lane_circles``' output."""
    return circles[i] if circles.dim() == 3 else circles


def plain_timed(fn):
    """``fn()`` once, timed by CUDA events: (its result, ms)."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def circles_held(rk, tag, model, params, cfg, cp, cm, state, U, eps,
                 circles, geoms, card) -> dict:
    """Phase 34 (b) at one (L, K) and set of circles: ``lane_hold`` of
    kernel 1's lane form in each geometry of ``geoms``, each lane against
    the solo instance run with lane l's scalars and circles; every
    geometry bit for bit the first, and the circles change every lane's
    costs and crash some rollouts that the free lanes do not.  Returns the
    max cost error, the name and the plain version's ms."""
    import torch
    from autorally_tpu_torch.config import lane_cost_params
    from autorally_tpu_torch.tools.exact_variants import forced_geometry

    L, K_ = state.shape[0], eps.shape[1]
    kw = dict(obstacle_coeff=LANE_COEFF, inflation=LANE_INFLATION)
    lanes = lane_cost_params(cp)
    free, (fc, _, fx) = rk.prepare_fused_exact_rollout_cost_lanes(
        model, params, cfg, cp, cm, state, U, eps)
    free()
    torch.cuda.synchronize()
    held = lane_hold(
        f"lanes circles {tag}",
        lambda: rk.prepare_fused_exact_rollout_cost_lanes(
            model, params, cfg, cp, cm, state, U, eps, obstacles=circles,
            **kw),
        lambda: rk.fused_rollout_cost_lanes_plain(
            model, params, cfg, cp, cm, state, U, eps, obstacles=circles,
            **kw),
        lambda i: rk.prepare_fused_exact_rollout_cost(
            model, params, cfg, lanes[i], cm, state[i], U[i], eps,
            obstacles=lane_solo_circles(circles, i), **kw),
        L, K_, card, geoms=geoms, forced=forced_geometry)
    first = held["runs"][0][1]
    for launch, out in held["runs"]:
        kc, _, kx = out
        label = geometry_label(launch.geometry)
        same_first = all(bit_equal(a, b) for a, b in zip(out, first))
        changed = [bool((kc[i] != fc[i]).any().item()) for i in range(L)]
        print(f"[lanes circles {tag}] {launch.name} in {label}: bit for bit "
              f"{geometry_label(geoms[0])}: {same_first}; the circles "
              f"change each lane's costs: {changed}, crash "
              f"{int(kx.sum().item())} against {int(fx.sum().item())} free "
              f"({card})")
        check(same_first, f"lanes circles {tag} {label}: differs from "
              f"{geometry_label(geoms[0])}")
        check(all(changed) and bool((kx > fx).any().item()),
              f"lanes circles {tag}: the circles change no cost or crash "
              "no rollout")
    return {"err": held["err"], "name": launch.name,
            "plain_ms": held["plain_ms"]}


def lanes_drive(rk, tag, make_runner, args, traj, expect: dict, fused: str,
                card) -> dict:
    """Phase 34 (d): one sweep of ``make_runner(n)``'s runner (``args``:
    its weights, stacked CostParams, surface and start; ``traj``: moving
    obstacles, or None) with every launch counter set to 0 just before and
    read just after: one capture, ``expect``'s launches (2 + 2 in the
    warm-up tick and 2 + 2 in the captured tick), no plain version, finite
    states; the replayed run, its ticks timed (p50 / p99), bit for bit the
    first; the profiler's launches on a short runner; and the first and
    last lanes bit for bit their solo captured episodes."""
    import torch
    from autorally_tpu_torch.config import cost_params_lanes, lane_cost_params

    runner = make_runner(None)
    n = runner.n_ticks
    kw = {} if traj is None else {"obstacle_traj": traj}
    L = cost_params_lanes(args[1])
    caps = Captures(runner)
    rk.LAUNCHES.clear()
    with PlainCalls(rk) as plain:
        t0 = time.perf_counter()
        res = runner.run(*args, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = dict(rk.LAUNCHES)
    print(f"[lanes drive {tag}] {L} lanes x {n} ticks at K="
          f"{runner.solver.cfg.num_rollouts}: first run {first_s:.2f} s "
          f"({len(caps.seconds)} capture(s), {sum(caps.seconds):.2f} s), "
          f"launches counted {launches}, plain-version calls {plain.calls} "
          f"({card})")
    check(len(caps.seconds) == 1, f"lanes drive {tag}: {len(caps.seconds)} "
          "captures")
    check(launches == expect, f"lanes drive {tag}: launches {launches}, "
          f"expected {expect}")
    check(not any(plain.calls.values()), f"lanes drive {tag}: a plain "
          f"version ran on the card: {plain.calls}")
    check(torch.isfinite(res.states).all().item(), f"lanes drive {tag}: a "
          "state is not finite")
    again, tick_ms, wall = timed_replays(runner,
                                         lambda: runner.run(*args, **kw))
    check(episode_equal(again, res), f"lanes drive {tag}: the replayed run "
          "differs from the first")
    p50, p99 = (float(np.percentile(tick_ms, q)) for q in (50, 99))
    short = make_runner(LANE_PROFILE_TICKS)
    prof = sweep_launches(rk, short, args, card, kw=(
        {} if traj is None else {"obstacle_traj": traj[:short.n_ticks]}),
        fused=fused)
    del short
    solo_runner = make_runner(None)
    lanes = lane_cost_params(args[1])
    gaps = {}
    for i in (0, L - 1):
        solo = solo_runner.run(args[0], lanes[i], *args[2:], **kw)
        gaps[i] = all(bit_equal(getattr(res, f)[i], getattr(solo, f))
                      for f in solo._fields)
    g = res.gamma
    print(f"[lanes drive {tag}] replayed tick {p50:.4f} / {p99:.4f} ms p50 / "
          f"p99 (CUDA events, {n} ticks), {n / wall:.1f} ticks/s "
          f"({L * n / wall:.1f} lane-ticks/s); lanes 0 and {L - 1} bit for "
          f"bit their solo captured episodes: {gaps}; gamma of lane 0 "
          f"{g[0, 0].item():.4g} -> {g[0, -1].item():.4g}, final u_x "
          f"{[round(v, 3) for v in res.states[:, -1, 4].tolist()]} ({card})")
    check(all(gaps.values()), f"lanes drive {tag}: a lane differs from its "
          "solo episode")
    del runner, solo_runner
    return {"lanes": L, "ticks": n, "first_run_s": first_s,
            "capture_s": sum(caps.seconds), "tick_ms_p50_p99": (p50, p99),
            "ticks_per_s": n / wall, "launches": launches, **prof}


def circles_row(rk, name, launch, held: dict, L: int, K_: int, n_w: int,
                step_ops: int, circles, field, launches: int, card,
                registers) -> dict:
    """The ``kernels`` row of a lane form with circles (kernel 1) or of
    kernel 3's (``field``): its time (CUDA events), its plain version's
    on the same inputs and its max cost error (``held``: the hold's), the
    ``launches`` of the drive at its shape, and its bound, L x the solo
    form's work: every input read once (eps and shared circles once for
    all lanes, the map one texel per lookup, or the field), every output
    written once; the field's products on the tensor cores (phase 11's
    rule, ``field_bounds``)."""
    ms = cuda_ms(launch, LANE_TIME_REPS)
    plain, err = held["plain_ms"], held["err"]
    n_obs = 0 if circles is None else circles.shape[-2]
    n_active = (0 if circles is None else
                int((circles[..., 2] > 0).sum().item()) // (
                    L if circles.dim() == 3 else 1))
    circle_ops = (n_active * CIRCLE_OPS + (n_obs - n_active) * SLOT_OPS + 1
                  if n_obs else 0)
    own = circles is not None and circles.dim() == 3
    per_lane = (2 * T + 7 + len(rk._FLOAT_SCALARS) + 2 * K_ + 2 * T * K_
                + (3 * n_obs if own else 0)
                + (0 if field is not None else 2 * K_ * (T - 1)))
    nbytes = 4 * (2 * T * K_ + L * per_lane + n_w + 4
                  + (0 if own else 3 * n_obs)
                  + (rk.FIELD_NUM_WEIGHTS if field is not None else 0))
    other = L * K_ * (T * step_ops + (T - 1) * circle_ops)
    fp32 = None
    if field is None:
        bnd, by = bound(nbytes, other)
    else:
        fp32, (bnd, by) = field_bounds(nbytes, other, L * K_ * (T - 1) * 2,
                                       field)
    g = launch.geometry
    print(f"[timing] {name} L={L} K={K_} slots {n_obs}"
          f"{' shared' if n_obs and not own else ''}, {launches} launches: "
          f"{ms:.4f} ms "
          f"({g.grid} x {L} blocks of {g.block}), plain {plain:.3f} ms, "
          f"bound {bnd:.5f} ms ({by}), {registers} registers ({card})")
    row = {"name": name, "route": "cuda",
           "source": "autorally_tpu_torch/csrc/rollout_kernels.cu",
           "replaces": "autorally_tpu/ops/rollout_kernel.py:" + (
               "1013" if field is None else "606"),
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
           "library_ms": None, "K": K_, "lanes": L, "slots": n_obs,
           "circles": "per lane" if own else "shared" if n_obs else None,
           "geometry": geometry_label(g), "registers": registers}
    if fp32 is not None:
        row["fp32_bound_ms"] = fp32[0]
    return row


def lanes_field_phase(rk, card, field, dev=None) -> dict:
    """Phase 34: circle slots in kernel 1's lane form, kernel 3's lane
    form, and the sweep with an ObstacleCost, the ESS law, moving
    obstacles and the neural field (``field``: phase 11's fit)."""
    import torch
    from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                            lane_cost_params)
    from autorally_tpu_torch.costs import MPPICost, ObstacleCost
    from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                            NeuralNetDynamics)
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.lap_eval import load_track
    from autorally_tpu_torch.tools.param_sweep import (build_grid,
                                                       stack_cost_params)

    dev = dev or torch.device("cuda", 0)
    results, rows = {}, []
    cm, start_pose, _, _ = load_track("oval", device=dev)
    cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
    models = {}
    for kind, cls in (("nn", NeuralNetDynamics),
                      ("bf", BasisFunctionDynamics)):
        m = cls(cfg.dt, control_ranges=cfg.control_ranges, device=dev)
        models[kind] = (m, m.init_params(0))

    # (a) the new and changed lane instances: registers and spills
    # (ptxas, phase 1), their shared memory and blocks an SM at T
    regs = {n: PTXAS.get(n) for n in LANE_INSTANCES[:5]
            + FIELD_LANE_INSTANCES}
    print(f"[lanes field (a)] ptxas: {regs} registers, no spill (phase 1)")
    check(all(v is not None for v in regs.values()),
          f"lanes field (a): ptxas reported no {regs}")
    for bf in (False, True):
        geoms = [rk._geometry(1, G, b) for G, b in (
            rk.GEOMETRIES if not bf else rk.GEOMETRIES[:1])]
        for kernel, gs in ((1, geoms), (3, [rk._geometry(
                1, 1, rk.FIELD_BLOCK)])):
            for g in gs:
                info = rk.lanes_kernel_info(kernel, bf, g, T, N_SLOTS)
                print(f"[lanes field (a)] kernel {kernel} "
                      f"{'BF' if bf else 'MLP'} G{g.group} block {g.block}: "
                      f"{info['registers']} registers, "
                      f"{info['local_bytes']} bytes of local memory, "
                      f"{info['smem_bytes']} bytes of dynamic shared memory "
                      f"at T={T} with {N_SLOTS} slots, "
                      f"{info['blocks_per_sm']} blocks an SM ({card})")
    results["registers"] = regs

    # (b) kernel 1's lane form with circles, every geometry
    held = {}
    for L, K_ in LANE_SHAPES:
        cp = lane_cost_grid(L)
        state, U, eps = lane_inputs(L, K_, dev, seed=L)
        for kind, (m, p) in models.items():
            c = cfg.replace(num_rollouts=K_)
            geoms = rk.GEOMETRIES if kind == "nn" else rk.GEOMETRIES[:1]
            for label, (slots, own) in lane_circle_sets(L):
                circles = lane_circles(rk, m, p, c, state, U, slots, own,
                                       seed=slots + L)
                held[L, K_, kind, label] = circles_held(
                    rk, f"(b) L={L} K={K_} {kind} {label}", m, p, c, cp, cm,
                    state, U, eps, circles, geoms, card)

    # (c) kernel 3's lane form, with and without circles, each lane
    # against the solo fused_field_kernel run with lane l's inputs
    fheld = {}
    for L, K_ in FIELD_LANE_SHAPES:
        cp = lane_cost_grid(L)
        lanes = lane_cost_params(cp)
        state, U, eps = lane_inputs(L, K_, dev, seed=L + 1)
        for kind, (m, p) in models.items():
            c = cfg.replace(num_rollouts=K_)
            circles = lane_circles(rk, m, p, c, state, U, N_SLOTS, True,
                                   seed=L + 7)
            for with_circles in ((False,) if L == LANE_WIDE_L
                                 else (False, True)):
                ob = circles if with_circles else None
                kw = ({} if ob is None else dict(
                    obstacle_coeff=LANE_COEFF, inflation=LANE_INFLATION))
                fheld[L, K_, kind, with_circles] = lane_hold(
                    f"lanes field (c) L={L} K={K_} {kind} "
                    f"{'16 per lane' if with_circles else 'no circles'}",
                    lambda: rk.prepare_fused_rollout_cost_lanes(
                        m, p, c, cp, field, state, U, eps, obstacles=ob,
                        **kw),
                    lambda: rk.fused_rollout_cost_lanes_plain(
                        m, p, c, cp, field, state, U, eps, obstacles=ob,
                        **kw),
                    lambda i: rk.prepare_fused_rollout_cost(
                        m, p, c, lanes[i], field, state[i], U[i], eps,
                        obstacles=None if ob is None else lane_solo_circles(
                            ob, i), **kw),
                    L, K_, card)
        del eps

    # (d) the sweeps at full width, and the BF forms' 3-lane sweeps
    start = [*start_pose, 0, 0, 0, 0]
    grid = build_grid({"desired_speed": [4.0, 5.0, 6.0, 7.0],
                       "gamma": [0.05, 0.15, 0.6]})
    L12 = len(grid)
    own = torch.full((N_SLOTS, 3), -1.0, device=dev)
    drives, launches = {}, {}
    U0 = torch.tensor([0.0, 0.3], device=dev).repeat(L12, T, 1)
    st0 = torch.tensor(start, dtype=torch.float32, device=dev).repeat(L12, 1)
    per_lane = lane_circles(rk, models["nn"][0], models["nn"][1], cfg, st0,
                            U0, N_SLOTS, True, seed=34)
    obstacle_grid = [dict(pt, obstacles=per_lane[i].cpu().numpy())
                     for i, pt in enumerate(grid)]
    traj = torch.full((LANE_DRIVE_TICKS, N_SLOTS, 3), -1.0, device=dev)
    ahead = lane_circles(rk, models["nn"][0], models["nn"][1], cfg, st0[:1],
                         U0[:1], N_SLOTS, True, seed=35)[0]
    for t in range(LANE_DRIVE_TICKS):       # drifting 1 cm a tick
        traj[t] = ahead
        traj[t, :, 0] += 0.01 * t * (ahead[:, 2] > 0)

    def runner_of(model, cost, K_, **kw):
        solver = MPPISolver(model, cost, cfg.replace(num_rollouts=K_),
                            device=dev)
        return lambda n: EpisodeRunner(solver, n_ticks=n or kw.get(
            "ticks", LANE_DRIVE_TICKS), **{k: v for k, v in kw.items()
                                           if k != "ticks"})

    obstacle_cost = lambda: ObstacleCost(own, LANE_COEFF, LANE_INFLATION)
    m, p = models["nn"]
    bm, bp = models["bf"]
    L3, K3 = LANE_SHAPES[0]
    # each drive with the key of the kernels row whose shape it launches:
    # (kernel, model, L, K, slots, a lane's own circles) of kernel 1's
    # rows, (kernel, model, L, K) of kernel 3's
    cases = (
        ("obstacles + ESS", runner_of(m, obstacle_cost(), K,
                                      ess_target_frac=0.25),
         (p, stack_cost_params(CostParams(), obstacle_grid), cm, start),
         None, "fused_exact_rollout_cost_obstacles_lanes",
         "dynamics_chain_lanes", "fused_exact", (1, "nn", L12, K, N_SLOTS,
                                                 True)),
        ("moving obstacles + ESS", runner_of(m, obstacle_cost(), K,
                                             ess_target_frac=0.25),
         (p, stack_cost_params(CostParams(), grid), cm, start), traj,
         "fused_exact_rollout_cost_obstacles_lanes", "dynamics_chain_lanes",
         "fused_exact", (1, "nn", L12, K, N_SLOTS, False)),
        ("field", runner_of(m, MPPICost(), K),
         (p, stack_cost_params(CostParams(), grid), field, start), None,
         "fused_rollout_cost_lanes", "dynamics_chain_lanes", "fused_field",
         (3, "nn", L12, K)),
        ("field BF", runner_of(bm, MPPICost(), K3,
                               ticks=LANE_BF_DRIVE_TICKS),
         (bp, lane_cost_grid(L3), field, start), None,
         "fused_rollout_cost_bf_lanes", "dynamics_chain_bf_lanes",
         "fused_field", (3, "bf", L3, K3)),
        ("obstacles BF", runner_of(bm, obstacle_cost(), K3,
                                   ticks=LANE_BF_DRIVE_TICKS),
         (bp, stack_cost_params(CostParams(), obstacle_grid[:L3]), cm,
          start), None, "fused_exact_rollout_cost_bf_obstacles_lanes",
         "dynamics_chain_bf_lanes", "fused_exact", (1, "bf", L3, K3,
                                                    N_SLOTS, True)),
    )
    for tag, make, args, trj, fused_name, chain_name, fused, key in cases:
        drives[tag] = lanes_drive(rk, tag, make, args, trj,
                                  {fused_name: 4, chain_name: 4}, fused,
                                  card)
        check(key not in launches, f"lanes drive {tag}: two drives at {key}")
        launches[key] = drives[tag]["launches"]
    results["drives"] = drives

    # the kernels line: the new instances, timed at their shapes; a row
    # carries the launches of the drive at its shape, slots and circles
    # (0 where it was only held and timed)
    used = set()

    def row_launches(key, name):
        used.add(key)
        return launches.get(key, {}).get(name, 0)

    for kind, (m, p) in models.items():
        bf = kind == "bf"
        n_w = rk.KERNEL_BF_WEIGHTS if bf else rk.KERNEL_NUM_WEIGHTS
        step = BF_STEP_OPS if bf else mlp_flops(m.layers)
        model_name = "Bf" if bf else "Mlp"
        for L, K_ in LANE_SHAPES:
            cp = lane_cost_grid(L)
            state, U, eps = lane_inputs(L, K_, dev, seed=L)
            c = cfg.replace(num_rollouts=K_)
            for label, (slots, own_lane) in lane_circle_sets(L):
                circles = lane_circles(rk, m, p, c, state, U, slots,
                                       own_lane, seed=slots + L)
                kw = dict(obstacles=circles, obstacle_coeff=LANE_COEFF,
                          inflation=LANE_INFLATION)
                launch, _ = rk.prepare_fused_exact_rollout_cost_lanes(
                    m, p, c, cp, cm, state, U, eps, **kw)
                g = launch.geometry
                inst = (f"fused_exact_group_kernel<{g.group}, lanes>"
                        if g.group > 1 else
                        f"fused_exact_kernel<{model_name}, lanes>")
                rows.append(circles_row(
                    rk, launch.name, launch, held[L, K_, kind, label], L,
                    K_, n_w, step, circles, None, row_launches(
                        (1, kind, L, K_, slots, own_lane), launch.name),
                    card, PTXAS.get(inst)))
        for L, K_ in FIELD_LANE_SHAPES:
            cp = lane_cost_grid(L)
            state, U, eps = lane_inputs(L, K_, dev, seed=L + 1)
            c = cfg.replace(num_rollouts=K_)
            launch, _ = rk.prepare_fused_rollout_cost_lanes(
                m, p, c, cp, field, state, U, eps)
            rows.append(circles_row(
                rk, launch.name, launch, fheld[L, K_, kind, False], L, K_,
                n_w, step, None, field, row_launches(
                    (3, kind, L, K_), launch.name),
                card, PTXAS.get(f"fused_field_kernel<{model_name}, lanes>")))
            del eps
    check(set(launches) <= used, "lanes field: a drive's shape has no row "
          f"in the kernels line: {set(launches) - used}")
    return {"results": results, "rows": rows}


# -- phase 35: the capacity mode in the sweep's lanes; every library's lanes -

# (a) pass 1's lane forms, {label: (slots, a lane's own)} at phase 33's
# shapes, and one launch on a shard's slice (k_offset, K_local): the second
# half of a 2 x 512 batch
CAP_CIRCLE_SETS = {"no circles": (0, True), "16 per lane": (N_SLOTS, True),
                   "16 shared": (N_SLOTS, False)}
CAP_SHARD = (512, 512)
# (c) every library's lane forms at L=3: the wide spec's and F6-48-48's at
# BASELINE #3's K, the bf16 library's at BASELINE #1's
LIB_LANES = 3
# (d) the capacity drives: 12 lanes at K (gaussian, OU), 4 lanes at
# BASELINE #5's KC (exact map, field), 3 lanes of BASELINE #3's spec at KS
# (capacity, host noise), 3 at "default" at K; gaussian 200, exact 25 and
# field 10 before phases 38-39
CAP_L12_TICKS = {"gaussian": 100, "ou": 20}
CAP_WIDE_LANES = 4
CAP_WIDE_TICKS = {"exact": 12, "field": 5}
CAP_FORM_TICKS = 20
CAP_TIME_REPS = 20                    # the kernels line's CUDA-event runs
# the capacity passes' lane instances in the default library (ptxas' names,
# phase 1)
CAP_LANE_INSTANCES = ("fused_rng_kernel<Mlp, lanes>",
                      "fused_rng_bf_kernel<lanes>",
                      "fused_rng_field_kernel<Mlp, lanes>",
                      "fused_rng_field_kernel<Bf, lanes>",
                      "weighted_update_kernel<lanes>")


def lanes_subset(cp, idx):
    """The stacked CostParams of the lanes ``idx`` of ``cp``."""
    import torch
    from autorally_tpu_torch.config import cost_params_lanes

    L, kw = cost_params_lanes(cp), {}
    for f in dataclasses.fields(cp):
        v = getattr(cp, f.name)
        if (torch.is_tensor(v) and v.dim() == (3 if f.name == "obstacles"
                                               else 1) and v.shape[0] == L):
            kw[f.name] = v[list(idx)]
    return cp.replace(**kw)


def cap_lanes_held(rk, tag, model, params, cfg, cp, surface, state, U, key,
                   circles, card, k_offset=0, K_local=None) -> dict:
    """Phase 35 (a) at one (L, K), model, sampler, surface and set of
    circles: pass 1's lane form (not counted) against its plain version by
    phase 9's rule (costs within COST_RTOL / COST_ATOL and equal crash
    flags, in all but 1 % of a lane's rollouts: the lanes' starts are not
    the nominal case), and each lane bit for bit the solo instance run with
    that lane's scalars, start, plan and circles on the same stream.  The
    plain version takes every lane at L=3, and lanes 0 and L-1 beyond (a
    lane of it costs 0.25-0.45 s of launches on the card at K=1920; every
    lane is held bit for bit against its solo instance, whose plain version
    is that lane's).  Returns the max cost error, the plain version's ms
    (None where it ran only some lanes) and the whole plain version, the
    launch, its ctx and costs."""
    import torch
    from autorally_tpu_torch.config import lane_cost_params

    L = state.shape[0]
    kw = dict(k_offset=k_offset, K_local=K_local)
    if circles is not None:
        kw.update(obstacle_coeff=LANE_COEFF, inflation=LANE_INFLATION)
    launch, (kc, kx), ctx = rk.prepare_fused_rng_costs_lanes(
        model, params, cfg, cp, surface, state, U, key, obstacles=circles,
        **kw)
    launch()
    idx = list(range(L)) if L <= 3 else [0, L - 1]
    sub = (None if circles is None or circles.dim() == 2
           else circles[idx])
    (pc, px, _), plain_ms = plain_timed(lambda: rk.fused_rng_costs_lanes_plain(
        model, params, cfg, lanes_subset(cp, idx), surface, state[idx],
        U[idx], key, obstacles=circles if sub is None else sub, **kw))
    K_ = ctx.K
    err = max(agreement(f"cap lanes {tag}", f"lane {i}", kc[i], kx[i], pc[j],
                        px[j], K_, limit=K_ // 100)
              for j, i in enumerate(idx))
    same = []
    for i, cp_i in enumerate(lane_cost_params(cp)):
        one, (oc, ox), _ = rk.prepare_fused_rng_costs(
            model, params, cfg, cp_i, surface, state[i], U[i], key,
            obstacles=(None if circles is None
                       else lane_solo_circles(circles, i)), **kw)
        one()
        torch.cuda.synchronize()
        same.append(bit_equal(kc[i], oc) and bit_equal(kx[i], ox))
    g = launch.geometry
    print(f"[cap lanes {tag}] {launch.name} ({g.grid} x {L} blocks of "
          f"{g.block}, k_offset {k_offset}): each lane bit for bit the solo "
          f"instance: {same}; crash {[int(v) for v in kx.sum(1).tolist()]} "
          f"of {K_} ({card})")
    check(all(same), f"cap lanes {tag}: a lane differs from the solo "
          "instance")
    return {"err": err, "plain_ms": plain_ms if len(idx) == L else None,
            "plain": lambda: rk.fused_rng_costs_lanes_plain(
                model, params, cfg, cp, surface, state, U, key,
                obstacles=circles, **kw),
            "launch": launch, "ctx": ctx, "costs": kc}


def lane_abs_controls(rk, model, params, cfg, cp, cm, ctx, eps):
    """|u| (L, C, T, K) of the lanes' rollouts on the plain stream ``eps``:
    kernel 1's lane form's u_seq (the controls do not depend on the
    state)."""
    import torch

    state = torch.zeros((ctx.U.shape[0], model.STATE_DIM),
                        device=ctx.U.device)
    launch, (_, u_seq, _) = rk.prepare_fused_exact_rollout_cost_lanes(
        model, params, cfg, cp, cm, state, ctx.U, eps, k_offset=ctx.k_offset)
    launch()
    return u_seq.abs_()


def cap_numer_held(rk, tag, model, params, cfg, cp, cm, ctx, weights,
                   card) -> float:
    """Phase 35 (b): pass 2's lane form on each of ``weights`` ({name: (L,
    K)}), each lane's partials bit for bit the solo kernel's on that lane's
    U and weights, and the numerator against its plain version within
    NUMER_RTOL of sum_k |w_k u_k|, as phase 8.  Returns the max abs
    error."""
    import torch
    from autorally_tpu_torch.tools.ab_builds import zero_warp_share

    L = ctx.U.shape[0]
    u_abs = lane_abs_controls(rk, model, params, cfg, cp, cm, ctx,
                              rk.rng_noise(ctx))
    err = 0.0
    for wname, w in weights.items():
        launch, partials = rk.prepare_fused_rng_numer_lanes(ctx, w)
        launch()
        kn = torch.stack([torch.sum(p, dim=0) for p in partials])
        pn = rk.fused_rng_numer_lanes_plain(ctx, w)
        same = []
        for i in range(L):
            one, part = rk.prepare_fused_rng_numer(ctx._replace(U=ctx.U[i]),
                                                   w[i].contiguous())
            one()
            torch.cuda.synchronize()
            same.append(bit_equal(partials[i], part))
        scale = torch.einsum("lk,lctk->lct", w.abs(), u_abs)
        e = (kn - pn).abs()
        rel = (e / scale.clamp(min=1e-30)).max().item()
        ess = [round((r.sum() ** 2 / (r * r).sum()).item(), 1) for r in w]
        print(f"[cap lanes (b) {tag}] fused_rng_numer_lanes, {wname} "
              f"weights (L={L}, K={ctx.K}): each lane's partials bit for bit "
              f"the solo kernel's: {same}; max|numer err| "
              f"{e.max().item():.3e}, max err / sum|w u| {rel:.3e} (limit "
              f"{NUMER_RTOL}); ess {ess}, "
              f"{100 * zero_warp_share(w.reshape(-1)):.2f} % all-zero warps "
              f"({card})")
        check(all(same), f"cap lanes (b) {tag} {wname}: a lane differs from "
              "the solo kernel")
        check(bool((e <= NUMER_RTOL * scale).all()), f"cap lanes (b) {tag} "
              f"{wname}: numerator differs beyond {NUMER_RTOL} of sum|w u|")
        err = max(err, e.max().item())
    return err


def lib_lanes_held(tag, pairs, card) -> None:
    """Phase 35 (c): each (name, lane launch's prepare, solo prepare of
    lane i) of ``pairs``: every lane of the lane launch bit for bit its
    solo instance of the same library."""
    import torch

    for name, lanes, solo in pairs:
        launch, out = lanes()[:2]
        launch()
        same = []
        for i in range(launch.lanes):
            one, o = solo(i)[:2]
            one()
            torch.cuda.synchronize()
            same.append(all(bit_equal(a[i], b) for a, b in zip(out, o)))
        g = launch.geometry
        print(f"[cap lanes (c) {tag}] {launch.name} ({geometry_label(g)}, "
              f"{g.grid} x {launch.lanes} blocks): each lane bit for bit the "
              f"solo instance of the library: {same} ({card})")
        check(all(same), f"cap lanes (c) {tag} {name}: a lane differs from "
              "its solo instance")


def cap_row(name, launch, plain_fn, L: int, K_: int, nbytes: float,
            bnd, err, launches: int, card, instance, plain_ms=None,
            extra=None) -> dict:
    """A ``kernels`` row of phase 35: the lane form's time (CUDA events),
    its plain version's (``plain_ms``, or ``plain_fn`` timed once), its
    bound (``bnd``: (ms, what bounds it), L x the solo form's work) and the
    drive's launches at its shape."""
    ms = cuda_ms(launch, CAP_TIME_REPS)
    plain = plain_ms if plain_ms is not None else plain_timed(plain_fn)[1]
    g = launch.geometry
    print(f"[timing] {name} L={L} K={K_}: {ms:.4f} ms ({g.grid} x {L} blocks "
          f"of {g.block}), plain {plain:.3f} ms, bound {bnd[0]:.5f} ms "
          f"({bnd[1]}), {launches} launches in its drive, {nbytes:.0f} "
          f"bytes, {PTXAS.get(instance)} registers ({card})")
    return {"name": name, "route": "cuda",
            "source": "autorally_tpu_torch/csrc/rollout_kernels.cu",
            "replaces": "autorally_tpu/ops/rollout_kernel.py:" + (
                "1346" if name.startswith("fused_rng_numer") else "1221"
                if name.startswith("fused_rng_costs") else "389"
                if name.startswith("dynamics_chain") else "606"
                if name.startswith("fused_rollout_cost") else "1013"),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "K": K_, "lanes": L,
            "geometry": geometry_label(g), "instance": instance,
            "registers": PTXAS.get(instance), **(extra or {})}


def cap_drive_runner(model, cost, cfg, ticks):
    """A drive's ``make_runner``: an ``EpisodeRunner`` of ``ticks`` ticks
    (or ``n``) on one solver of ``cfg``."""
    from autorally_tpu_torch.runtime.episode import EpisodeRunner
    from autorally_tpu_torch.solver.mppi import MPPISolver

    solver = MPPISolver(model, cost, cfg, device=model.device)
    return lambda n: EpisodeRunner(solver, n_ticks=n or ticks)


def capacity_lanes_phase(rk, card, field, dev=None) -> dict:
    """Phase 35: the capacity mode in the sweep's lanes (both passes' lane
    forms) and the lane forms in the libraries of other MLP specs, other
    fields and bf16 operands (``field``: phase 11's fit)."""
    import torch
    from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                            lane_cost_params)
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.models import (BasisFunctionDynamics,
                                            NeuralNetDynamics)
    from autorally_tpu_torch.tools.ab_builds import seeded_field
    from autorally_tpu_torch.tools.lap_eval import load_track
    from autorally_tpu_torch.tools.param_sweep import (build_grid,
                                                       stack_cost_params)

    dev = dev or torch.device("cuda", 0)
    results, rows = {}, []
    cm, start_pose, _, _ = load_track("oval", device=dev)
    start = [*start_pose, 0, 0, 0, 0]
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    models = {}
    for kind, cls in (("nn", NeuralNetDynamics),
                      ("bf", BasisFunctionDynamics)):
        base = MPPIConfig(num_rollouts=K, num_timesteps=T)
        m = cls(base.dt, control_ranges=base.control_ranges, device=dev)
        models[kind] = (m, m.init_params(0))

    def cap_cfg(K_, sampler="gaussian", **kw):
        return MPPIConfig(num_rollouts=K_, num_timesteps=T, kernel_rng=True,
                          **SAMPLERS[sampler], **kw)

    # (a) pass 1's lane instances: registers (ptxas, phase 1) and blocks an
    # SM at T; every instance, gaussian and OU, each circle set, both
    # shapes, against its plain version and each lane its solo instance
    t0 = time.perf_counter()
    regs = {n: PTXAS.get(n) for n in CAP_LANE_INSTANCES}
    print(f"[cap lanes (a)] ptxas: {regs} registers, no spill (phase 1)")
    check(all(v is not None for v in regs.values()),
          f"cap lanes (a): ptxas reported no {regs}")
    results["registers"] = regs
    for bf in (False, True):
        for fmode in (False, True):
            g = rk._geometry(1, 1, rk.FIELD_BLOCK if fmode else
                             rk.EXACT_BLOCK)
            info = rk.lanes_kernel_info(4, bf, g, T, N_SLOTS,
                                        field_mode=fmode)
            print(f"[cap lanes (a)] pass 1 {'field' if fmode else 'exact'} "
                  f"{'BF' if bf else 'MLP'}: {info['registers']} registers, "
                  f"{info['local_bytes']} bytes of local memory, "
                  f"{info['smem_bytes']} bytes of dynamic shared memory at "
                  f"T={T} with {N_SLOTS} slots, {info['blocks_per_sm']} "
                  f"blocks an SM ({card})")
    info = rk.lanes_kernel_info(5, False, rk._geometry(1, 1, rk.UPDATE_BLOCK),
                                T)
    print(f"[cap lanes (a)] pass 2: {info['registers']} registers, "
          f"{info['blocks_per_sm']} blocks an SM at T={T} ({card})")
    held = {}
    for L, K_ in LANE_SHAPES:
        cp = lane_cost_grid(L)
        state, U, _ = lane_inputs(L, K_, dev, seed=L + 35)
        for kind, (m, p) in models.items():
            own = lane_circles(rk, m, p, cap_cfg(K_), state, U, N_SLOTS, True,
                               seed=L + 35)
            shared = lane_circles(rk, m, p, cap_cfg(K_), state, U, N_SLOTS,
                                  False, seed=L + 36)
            for sampler in SAMPLERS:
                c = cap_cfg(K_, sampler)
                for surface, surf in (("exact", cm), ("field", field)):
                    for label, (slots, own_lane) in CAP_CIRCLE_SETS.items():
                        circles = (None if not slots else own if own_lane
                                   else shared)
                        held[L, K_, kind, sampler, surface, label] = (
                            cap_lanes_held(
                                rk, f"(a) L={L} K={K_} {kind} {sampler} "
                                f"{surface} {label}", m, p, c, cp, surf,
                                state, U, key, circles, card))
    # one lane launch on a shard's slice (k_offset != 0)
    k0, kl = CAP_SHARD
    L3 = LANE_SHAPES[0][0]
    state, U, _ = lane_inputs(L3, kl, dev, seed=53)
    m, p = models["nn"]
    cap_lanes_held(rk, f"(a) shard k_offset={k0} K_local={kl}", m, p,
                   cap_cfg(k0 + kl), lane_cost_grid(L3), cm, state, U, key,
                   None, card, k_offset=k0, K_local=kl)

    print(f"[time] phase 35 (a) in {time.perf_counter() - t0:.1f}s ({card})")
    t0 = time.perf_counter()

    # (b) pass 2's lane form at L=12, K: the nominal weights (each lane's
    # costs at its own gamma), three warps of every four zeroed (sparse),
    # all 1 (dense); a closed loop's below, after (d)'s drive
    L12, K12 = LANE_SHAPES[1]
    m, p = models["nn"]
    cp12 = lane_cost_grid(L12)
    a12 = held[L12, K12, "nn", "gaussian", "exact", "no circles"]
    w = rk.lane_weights(cap_cfg(K12), cp12, a12["costs"])
    sparse = torch.where(torch.arange(K12, device=dev) // 32 % 4 == 0, w,
                         torch.zeros_like(w))
    err_p2 = cap_numer_held(rk, f"L={L12} K={K12}", m, p, cap_cfg(K12), cp12,
                            cm, a12["ctx"], {"nominal": w, "sparse": sparse,
                                             "dense": torch.ones_like(w)},
                            card)

    print(f"[time] phase 35 (b) in {time.perf_counter() - t0:.1f}s ({card})")
    t0 = time.perf_counter()

    # (c) every library's lane forms at L=3, each lane bit for bit its solo
    # instance of that library
    wide = SPEC_LAYERS[0]
    wm, wp, wcfg = spec_setup(wide, dev)
    f648 = seeded_field(cm, dev, fspec=FIELD_LABELS["F6-48-48"])
    bcfg = MPPIConfig(num_rollouts=K, num_timesteps=T,
                      matmul_precision=PRECISION)
    lib_inputs = {}
    for tag, (mm, pp, c, fld, K_) in (
            (spec_label(wide), (wm, wp, wcfg, field, KS)),
            ("F6-48-48", (models["nn"][0], models["nn"][1],
                          MPPIConfig(num_rollouts=KS, num_timesteps=T),
                          f648, KS)),
            ("bf16", (models["nn"][0], models["nn"][1], bcfg, field, K))):
        cp = lane_cost_grid(LIB_LANES)
        lanes_cp = lane_cost_params(cp)
        state, U, eps = lane_inputs(LIB_LANES, K_, dev, seed=K_ % 97)
        e1 = torch.zeros_like(eps[:, :1])
        cc = c.replace(kernel_rng=True)
        kinds = [("nn", mm, pp)]
        if tag != spec_label(wide):
            kinds.append(("bf", *models["bf"]))
        pairs = []
        for kind, mk, pk in kinds:
            if tag != "F6-48-48":
                pairs += [
                    (f"kernel 1 {kind}",
                     lambda mk=mk, pk=pk: rk.prepare_fused_exact_rollout_cost_lanes(
                         mk, pk, c, cp, cm, state, U, eps),
                     lambda i, mk=mk, pk=pk: rk.prepare_fused_exact_rollout_cost(
                         mk, pk, c, lanes_cp[i], cm, state[i], U[i], eps)),
                    (f"kernel 2 {kind}",
                     lambda mk=mk, pk=pk: rk.prepare_dynamics_chain_lanes(
                         mk, pk, c, state, U, eps),
                     lambda i, mk=mk, pk=pk: rk.prepare_dynamics_chain(
                         mk, pk, c, state[i], U[i], eps)),
                    (f"kernel 2 K=1 {kind}",
                     lambda mk=mk, pk=pk: rk.prepare_dynamics_chain_lanes(
                         mk, pk, c, state, U, e1),
                     lambda i, mk=mk, pk=pk: rk.prepare_dynamics_chain(
                         mk, pk, c, state[i], U[i], e1)),
                    (f"pass 1 exact {kind}",
                     lambda mk=mk, pk=pk: rk.prepare_fused_rng_costs_lanes(
                         mk, pk, cc, cp, cm, state, U, key),
                     lambda i, mk=mk, pk=pk: rk.prepare_fused_rng_costs(
                         mk, pk, cc, lanes_cp[i], cm, state[i], U[i], key))]
            pairs += [
                (f"kernel 3 {kind}",
                 lambda mk=mk, pk=pk: rk.prepare_fused_rollout_cost_lanes(
                     mk, pk, c, cp, fld, state, U, eps),
                 lambda i, mk=mk, pk=pk: rk.prepare_fused_rollout_cost(
                     mk, pk, c, lanes_cp[i], fld, state[i], U[i], eps)),
                (f"pass 1 field {kind}",
                 lambda mk=mk, pk=pk: rk.prepare_fused_rng_costs_lanes(
                     mk, pk, cc, cp, fld, state, U, key),
                 lambda i, mk=mk, pk=pk: rk.prepare_fused_rng_costs(
                     mk, pk, cc, lanes_cp[i], fld, state[i], U[i], key))]
        lib_lanes_held(f"{tag} K={K_}", pairs, card)
        lib_inputs[tag] = (mm, pp, c, cc, fld, K_, cp, state, U, eps)

    print(f"[time] phase 35 (c) in {time.perf_counter() - t0:.1f}s ({card})")
    t0 = time.perf_counter()

    # (d) the capacity drives through EpisodeRunner.run / run_sweep with a
    # stacked CostParams: one capture, 2 + 2 + 2 lane launches a tick (the
    # wrappers' counts of the warm-up tick and the capture), no plain
    # version; the replayed run timed, bit for bit the first; the profiler's
    # launches and graph nodes; lanes 0 and L-1 bit for bit their solo
    # captured episodes
    grid12 = stack_cost_params(CostParams(), build_grid(
        {"desired_speed": [4.0, 5.0, 6.0, 7.0],
         "gamma": [0.05, 0.15, 0.6]}))
    grid4 = stack_cost_params(CostParams(), build_grid(
        {"desired_speed": [4.0, 5.0, 6.0, 7.0]}))
    nn_m, nn_p = models["nn"]
    drives, launches = {}, {}
    cases = [
        (f"L=12 K={K} {s}", nn_m, cap_cfg(K, s), CAP_L12_TICKS[s],
         (nn_p, grid12, cm, start), "fused_rng_costs_lanes",
         "dynamics_chain_lanes", ("exact", L12, K) if s == "gaussian"
         else None)
        for s in SAMPLERS] + [
        (f"L={CAP_WIDE_LANES} K={KC} {surface}", nn_m, cap_cfg(KC),
         CAP_WIDE_TICKS[surface], (nn_p, grid4, surf, start),
         "fused_rng_costs" + ("_field" if surface == "field" else "")
         + "_lanes", "dynamics_chain_lanes", (surface, CAP_WIDE_LANES, KC))
        for surface, surf in (("exact", cm), ("field", field))] + [
        (f"L=3 {spec_label(wide)} K={KS} capacity", wm, wcfg.replace(
            kernel_rng=True), CAP_FORM_TICKS,
         (wp, lane_cost_grid(LIB_LANES), cm, start),
         f"fused_rng_costs_{spec_label(wide)}_lanes",
         f"dynamics_chain_{spec_label(wide)}_lanes", ("spec", 3, KS)),
        (f"L=3 {spec_label(wide)} K={KS} host noise", wm, wcfg,
         CAP_FORM_TICKS, (wp, lane_cost_grid(LIB_LANES), cm, start),
         f"fused_exact_rollout_cost_{spec_label(wide)}_lanes",
         f"dynamics_chain_{spec_label(wide)}_lanes", ("spec host", 3, KS)),
        (f"L=3 default K={K}", nn_m, cap_cfg(K, matmul_precision=PRECISION),
         CAP_FORM_TICKS, (nn_p, lane_cost_grid(LIB_LANES), cm, start),
         "fused_rng_costs_default_lanes", "dynamics_chain_lanes",
         ("default", 3, K))]
    closed = None
    for tag, mm, c, ticks, args, p1, chain, keyname in cases:
        expect = {p1: 4, chain: 4}
        capacity = c.kernel_rng
        if capacity:
            expect["fused_rng_numer_lanes"] = 4
        make = cap_drive_runner(mm, MPPICost(), c, ticks)
        drives[tag] = lanes_drive(rk, tag, make, args, None, expect,
                                  "fused_rng" if capacity else "fused_exact",
                                  card)
        if keyname is not None:
            launches[keyname] = drives[tag]["launches"]
        if tag.startswith("L=12") and closed is None:
            # a closed loop's weights: one more, eager, iteration from the
            # drive's last state and plans
            runner = make(None)
            runner.run(*args)
            plan = runner._captured
            cs = runner.solver._slide(plan.carries[0], c.optimization_stride)
            sub = torch.tensor([7, 11], dtype=torch.int64, device=dev)
            tot, _, ctx = rk.fused_rng_costs_lanes(
                mm, args[0], c, args[1].replace(gamma=plan.gamma), cm,
                plan.state, cs.U, sub)
            closed = (ctx, rk.lane_weights(c, args[1].replace(
                gamma=plan.gamma), tot))
            del runner
    results["drives"] = drives
    err_p2 = max(err_p2, cap_numer_held(
        rk, f"L={L12} K={K12} closed loop", nn_m, nn_p, cap_cfg(K12), grid12,
        cm, closed[0], {"closed loop": closed[1]}, card))

    print(f"[time] phase 35 (d) in {time.perf_counter() - t0:.1f}s ({card})")
    t0 = time.perf_counter()

    # the kernels line: pass 1's lane instances at each shape without
    # circles (its MLP exact one also at the 4 x KC drive's, and the field
    # one there), pass 2's at 12 x K and 4 x KC, and item 5's lane forms at
    # (c)'s shapes; launches from the drive at a row's shape
    T_ = T
    for kind, (m, p) in models.items():
        bf = kind == "bf"
        n_w = rk.KERNEL_BF_WEIGHTS if bf else rk.KERNEL_NUM_WEIGHTS
        step = BF_STEP_OPS if bf else mlp_flops(m.layers)
        for L, K_ in LANE_SHAPES:
            for surface in ("exact", "field"):
                h = held[L, K_, kind, "gaussian", surface, "no circles"]
                launch = h["launch"]
                nbytes = 4 * (L * (2 * T_ + 7 + len(rk._FLOAT_SCALARS)
                                   + 2 * K_) + n_w + 4 + 2)
                other = L * K_ * T_ * (step + STREAM_OPS)
                if surface == "exact":
                    nbytes += 4 * min(cm.height * cm.width,
                                      2 * L * K_ * (T_ - 1))
                    bnd, extra = bound(nbytes, other), None
                else:
                    nbytes += 4 * rk.FIELD_NUM_WEIGHTS
                    fp32, bnd = field_bounds(nbytes, other,
                                             L * K_ * (T_ - 1) * 2, field)
                    extra = {"fp32_bound_ms": fp32[0]}
                inst = (("fused_rng_field_kernel<%s, lanes>" % (
                    "Bf" if bf else "Mlp")) if surface == "field" else
                    "fused_rng_bf_kernel<lanes>" if bf
                    else "fused_rng_kernel<Mlp, lanes>")
                rows.append(cap_row(
                    launch.name, launch, h["plain"], L, K_, nbytes, bnd,
                    h["err"], launches.get((surface, L, K_), {}).get(
                        launch.name, 0) if not bf else 0, card, inst,
                    plain_ms=h["plain_ms"], extra=extra))
    # the 4 x KC drive's shape: pass 1 exact and field, pass 2
    L4 = CAP_WIDE_LANES
    cp4 = grid4
    state, U, _ = lane_inputs(L4, KC, dev, seed=44)
    m, p = models["nn"]
    for surface, surf in (("exact", cm), ("field", field)):
        launch, (kc4, _), ctx4 = rk.prepare_fused_rng_costs_lanes(
            m, p, cap_cfg(KC), cp4, surf, state, U, key)
        launch()
        nbytes = 4 * (L4 * (2 * T_ + 7 + len(rk._FLOAT_SCALARS) + 2 * KC)
                      + rk.KERNEL_NUM_WEIGHTS + 4 + 2)
        other = L4 * KC * T_ * (mlp_flops(m.layers) + STREAM_OPS)
        if surface == "exact":
            nbytes += 4 * min(cm.height * cm.width, 2 * L4 * KC * (T_ - 1))
            bnd, extra = bound(nbytes, other), None
        else:
            nbytes += 4 * rk.FIELD_NUM_WEIGHTS
            fp32, bnd = field_bounds(nbytes, other, L4 * KC * (T_ - 1) * 2,
                                     field)
            extra = {"fp32_bound_ms": fp32[0]}
        rows.append(cap_row(
            launch.name, launch, lambda surf=surf: (
                rk.fused_rng_costs_lanes_plain(m, p, cap_cfg(KC), cp4, surf,
                                               state, U, key)),
            L4, KC, nbytes, bnd, None, launches.get((surface, L4, KC), {})
            .get(launch.name, 0), card,
            "fused_rng_field_kernel<Mlp, lanes>" if surface == "field"
            else "fused_rng_kernel<Mlp, lanes>", extra=extra))
        if surface == "exact":
            w4 = rk.lane_weights(cap_cfg(KC), cp4, kc4)
            launch2, partials = rk.prepare_fused_rng_numer_lanes(ctx4, w4)
            k_need = int((w4 != 0).sum().item())
            nbytes2 = 4 * (L4 * (KC + 2 * T_) + partials.numel()) + 16
            rows.append(cap_row(
                "fused_rng_numer_lanes", launch2,
                lambda: rk.fused_rng_numer_lanes_plain(ctx4, w4), L4, KC,
                nbytes2, bound(nbytes2, (STREAM_OPS + UPDATE_OPS) * k_need
                               * T_), None,
                launches.get(("exact", L4, KC), {}).get(
                    "fused_rng_numer_lanes", 0), card,
                "weighted_update_kernel<lanes>"))
    # pass 2 at 12 x K on the nominal weights
    launch2, partials = rk.prepare_fused_rng_numer_lanes(a12["ctx"], w)
    k_need = int((w != 0).sum().item())
    nbytes2 = 4 * (L12 * (K12 + 2 * T_) + partials.numel()) + 16
    rows.append(cap_row(
        "fused_rng_numer_lanes", launch2,
        lambda: rk.fused_rng_numer_lanes_plain(a12["ctx"], w), L12, K12,
        nbytes2, bound(nbytes2, (STREAM_OPS + UPDATE_OPS) * k_need * T_),
        err_p2, launches.get(("exact", L12, K12), {}).get(
            "fused_rng_numer_lanes", 0), card, "weighted_update_kernel<lanes>"))
    # item 5's lane forms at (c)'s shapes
    for tag, (mm, pp, c, cc, fld, K_, cp, state, U, eps) in lib_inputs.items():
        L = LIB_LANES
        bf16 = tag == "bf16"
        drive = launches.get(({spec_label(wide): "spec", "bf16": "default"}
                              .get(tag), L, K_), {})
        drive_host = (launches.get(("spec host", L, K_), {})
                      if tag == spec_label(wide) else {})
        n_w = rk.num_weights(mm.layers)
        step = mlp_flops(mm.layers)
        prods = mlp_products(mm.layers)
        # the ptxas names of phase 1's libraries
        suffix = {spec_label(wide): f" [{tag}]", "bf16": " [bf16 default]",
                  "F6-48-48": f" [{spec_label(rk.KERNEL_LAYERS)} F6-48-48]"}[
                      tag]

        def mlp_bound(nbytes, n_steps, field_evals=0, stream=False):
            """(ms, what bounds it) of ``n_steps`` rollout-steps of the
            MLP (its products at the bf16 rate at "default"), the
            stream's draws when ``stream`` and ``field_evals`` field
            evaluations (their products in 3xTF32)."""
            other = n_steps * (step - (prods if bf16 else 0)
                               + (STREAM_OPS if stream else 0))
            if field_evals:
                fops = field_eval_ops(fld.layers, fld.freqs.numel())
                fprod = 2 * sum(a * b for a, b in zip(fld.layers[:-2],
                                                      fld.layers[1:-1]))
                other += field_evals * (fops - fprod)
                tf32 = field_evals * 3 * fprod
            else:
                tf32 = 0.0
            if bf16:
                return bf16_bound(nbytes, other, n_steps * prods, tf32)
            return bound(nbytes, other, tf32)

        e1 = torch.zeros_like(eps[:, :1])
        per_lane = 2 * T + 7 + len(rk._FLOAT_SCALARS) + 2 * K_
        if tag != "F6-48-48":
            l1, _ = rk.prepare_fused_exact_rollout_cost_lanes(
                mm, pp, c, cp, cm, state, U, eps)
            nb = 4 * (2 * T * K_ + L * (per_lane + 2 * T * K_
                                        + 2 * K_ * (T - 1)) + n_w + 4)
            g = l1.geometry
            inst = ((f"fused_exact_group_kernel<{g.group}, lanes>"
                     if g.group > 1 else "fused_exact_kernel<Mlp, lanes>")
                    + suffix)
            rows.append(cap_row(
                l1.name, l1, lambda: rk.fused_rollout_cost_lanes_plain(
                    mm, pp, c, cp, cm, state, U, eps), L, K_, nb,
                mlp_bound(nb, L * K_ * T), None, drive_host.get(l1.name, 0),
                card, inst))
            l2, _ = rk.prepare_dynamics_chain_lanes(mm, pp, c, state, U, e1)
            nb = 4 * (2 * T + L * (2 * T + 7 + 9 * T) + n_w + 4)
            g = l2.geometry
            inst = (("dynamics_chain_warp_kernel" if g.group > 1 else
                     "dynamics_chain_kernel") + "<Mlp, lanes>" + suffix)
            rows.append(cap_row(
                l2.name, l2, lambda: rk.dynamics_chain_lanes_plain(
                    mm, pp, c, state, U, e1), L, 1, nb, mlp_bound(nb, L * T),
                None, max(drive.get(l2.name, 0), drive_host.get(l2.name, 0)),
                card, inst))
            lp, _, _ = rk.prepare_fused_rng_costs_lanes(mm, pp, cc, cp, cm,
                                                        state, U, key)
            nb = 4 * (L * per_lane + n_w + 4 + 2 + min(
                cm.height * cm.width, 2 * L * K_ * (T - 1)))
            rows.append(cap_row(
                lp.name, lp, lambda: rk.fused_rng_costs_lanes_plain(
                    mm, pp, cc, cp, cm, state, U, key), L, K_, nb,
                mlp_bound(nb, L * K_ * T, stream=True), None,
                drive.get(lp.name, 0), card,
                "fused_rng_kernel<Mlp, lanes>" + suffix))
        l3, _ = rk.prepare_fused_rollout_cost_lanes(mm, pp, c, cp, fld,
                                                    state, U, eps)
        nb = 4 * (2 * T * K_ + L * (per_lane + 2 * T * K_) + n_w + 4
                  + rk.field_num_weights(rk.field_spec(fld)))
        rows.append(cap_row(
            l3.name, l3, lambda: rk.fused_rollout_cost_lanes_plain(
                mm, pp, c, cp, fld, state, U, eps), L, K_, nb,
            mlp_bound(nb, L * K_ * T, L * K_ * (T - 1) * 2), None, 0, card,
            ("fused_field_kernel<MlpSplit, lanes>" if bf16 else
             "fused_field_kernel<Mlp, lanes>") + suffix))
        lf, _, _ = rk.prepare_fused_rng_costs_lanes(mm, pp, cc, cp, fld,
                                                    state, U, key)
        nb = 4 * (L * per_lane + n_w + 4 + 2
                  + rk.field_num_weights(rk.field_spec(fld)))
        rows.append(cap_row(
            lf.name, lf, lambda: rk.fused_rng_costs_lanes_plain(
                mm, pp, cc, cp, fld, state, U, key), L, K_, nb,
            mlp_bound(nb, L * K_ * T, L * K_ * (T - 1) * 2, stream=True),
            None, 0, card, "fused_rng_field_kernel<Mlp, lanes>" + suffix))
    print(f"[time] phase 35's rows in {time.perf_counter() - t0:.1f}s "
          f"({card})")
    return {"results": results, "rows": rows}


# -- phase 36: circles past the 64 staged slots (A5); a field left in device
# memory (A6) --------------------------------------------------------------

# (a) kernel 1's slots (a launch stages up to rk.MAX_OBSTACLES, and reads
# more in device memory); every other form's
MANY_SLOTS = (65, 128, 1024)
WIDE_SLOTS = 128
MANY_LANES = (3, 512)                  # (a): the lane forms' (L, K)
# (b) the pair whose staged field leaves no room: BASELINE #3's spec beside
# a seeded 34-128-128-1 field, at its K; its library builds last at phase 1
PAIR_LAYERS, PAIR_FIELD = (6, 64, 64, 64, 64, 4), (8, 128, 128)
PAIR_LIBRARIES = ((PAIR_LAYERS, PAIR_FIELD),)
# (c) the drives: BASELINE #1 with about 100 cones on the oval's edges in
# 128 slots, its capacity mode, and the pair's host-noise and capacity
# modes
CONE_SLOTS, CONE_EVERY, CONE_OFFSET, CONE_RADIUS = 128, 0.7, 2.6, 0.2
CONE_TICKS, CONE_CAP_TICKS, PAIR_TICKS = 100, 20, 20
MANY_REPS = {"small": 50, "large": 10}    # the kernels line's CUDA-event runs


def many_circles(model, params, cfg, start, U, slots: int, seed: int):
    """(slots, 3) circles on the card: phase 17's two, placed so that about
    half of the rollouts from ``start`` pass inside one, in the slot after
    the middle and in the last (both past the 64 staged where ``slots`` >
    64), the others scattered 4-12 m from ``start`` with radii 0.1-0.5 m,
    every fourth slot free (radius -1): the kernels read live and free
    slots on both sides of the staged count."""
    import torch

    tuned = obstacle_circles(model, params, cfg, start, U, seed=seed)
    rs = np.random.default_rng(seed)
    ang = rs.uniform(0.0, 2.0 * np.pi, slots)
    dist = rs.uniform(4.0, 12.0, slots)
    x0, y0 = float(start[0]), float(start[1])
    out = np.stack([x0 + dist * np.cos(ang), y0 + dist * np.sin(ang),
                    rs.uniform(0.1, 0.5, slots)], axis=1)
    out[3::4, 2] = -1.0
    out[slots // 2 + 1] = tuned[0]
    out[slots - 1] = tuned[1]
    return torch.tensor(out, dtype=torch.float32, device=U.device)


def oval_cones(spacing: float = CONE_EVERY) -> list:
    """Cones (radius ``CONE_RADIUS``) every ``spacing`` of arc along both
    edges of the oval's lane, ``CONE_OFFSET`` m either side of its
    centreline (``drive_oval.oval_costmap``'s ellipse, 30 x 18 m, a lane 6
    m wide whose crash boundary lies 1.95 m off the centreline), over the
    quarter ahead of the start (30, 0) heading +y: an autocross course's
    cones."""
    a, b = 30.0, 18.0
    cones, s = [], 0.0
    th = np.linspace(-0.15, np.pi / 2, 4001)
    x, y = a * np.cos(th), b * np.sin(th)
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x),
                                                    np.diff(y)))])
    for i in range(len(th)):
        if arc[i] < s:
            continue
        s += spacing
        nx, ny = b * np.cos(th[i]), a * np.sin(th[i])
        n = np.hypot(nx, ny)
        for side in (-1.0, 1.0):
            cones.append([x[i] + side * CONE_OFFSET * nx / n,
                          y[i] + side * CONE_OFFSET * ny / n, CONE_RADIUS])
    return cones


def fused_circle_bound(k, n_w, step, circles, field=None, map_floats=0,
                       stream=False, lanes=1, T_=T):
    """Kernel 1, 3 or pass 1 (``stream``: the noise drawn in the kernel, no
    eps read and no u_seq written) over ``lanes`` lanes of K=k with
    ``circles`` (n, 3), or (lanes, n, 3) a lane's own: every input read
    once (eps, the weights, shared circles and the field or the map once
    for all lanes; the map at most its ``map_floats``, one texel a lookup),
    every output written once (phase 18's rule), a circle 13 operations a
    step (a free slot 1), the field's products on the tensor cores
    (``field_bounds``), over ``T_`` steps.  Returns ((ms, by), fp32 (ms,
    by) or None)."""
    n = circles.shape[-2]
    own = circles.dim() == 3
    active = int((circles[..., 2] > 0).sum().item()) // (lanes if own
                                                         else 1)
    circle_ops = (active * CIRCLE_OPS + (n - active) * SLOT_OPS + 1
                  if n else 0)
    per_lane = ((2 * k if stream else 2 * T_ * k + 2 * k) + 2 * T_ + 7
                + (3 * n if own else 0))
    if field is None:
        surface = min(map_floats, 2 * (T_ - 1) * k * lanes)
    else:
        surface = sum(a * b + b for a, b in zip(field.layers[:-1],
                                                field.layers[1:])) + int(
            field.freqs.numel())
    shared = ((0 if stream else 2 * T_ * k) + n_w + 4
              + (0 if own else 3 * n) + surface)
    nbytes = 4 * (lanes * per_lane + shared) + (16 if stream else 0)
    other = lanes * k * (T_ * (step + (STREAM_OPS if stream else 0))
                         + (T_ - 1) * circle_ops)
    if field is None:
        return bound(nbytes, other), None
    fp32, tc = field_bounds(nbytes, other, lanes * k * (T_ - 1) * 2, field)
    return tc, fp32


def many_row(name, launch, reps, plain_ms, err, bnd, launches, card,
             replaces, **extra) -> dict:
    """A phase-36 row of the ``kernels`` line: the launch's time (CUDA
    events over ``reps``), its plain version's ``plain_ms``, the bound
    ``bnd`` ((ms, by), fp32 (ms, by) or None) and the drive's launches."""
    ms = cuda_ms(launch, reps)
    (b_ms, b_by), fp32 = bnd
    print(f"[timing] {name} " + " ".join(f"{k}={v}" for k, v in extra.items())
          + f": {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
          f"({b_by})" + (f", fp32 {fp32[0]:.5f} ms" if fp32 else "")
          + f", {launches} launches in its drive ({card})")
    row = {"name": name, "route": "cuda",
           "source": "autorally_tpu_torch/csrc/rollout_kernels.cu",
           "replaces": f"autorally_tpu/ops/rollout_kernel.py:{replaces}",
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, **extra}
    if fp32:
        row["fp32_bound_ms"] = fp32[0]
    if getattr(launch, "geometry", None) is not None:
        row["geometry"] = geometry_label(launch.geometry)
    return row


def many_circles_phase(drive_oval, rk, card, field, builds,
                       dev=None) -> dict:
    """Phase 36: circles past the 64 slots a launch stages (Queue 2 A5) in
    kernel 1, kernel 3 and pass 1 and their lane forms, held against their
    plain versions; the field kernels of a pair whose staged field leaves
    no room (A6: BASELINE #3's 6-64-64-64-64-4 beside 34-128-128-1, the
    field in device memory), solo and in lanes; and drives through each
    (``field``: phase 11's fit; ``builds``: phase 1's)."""
    import torch
    from autorally_tpu_torch.config import lane_cost_params
    from autorally_tpu_torch.costs import MPPICost, ObstacleCost
    from autorally_tpu_torch.costs import make_obstacles
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools.ab_builds import seeded_field

    dev = dev or torch.device("cuda", 0)
    results, rows, rowargs = {}, [], []
    solver, params, cp, costmap, _ = drive_oval.build(rollouts=K, device=dev)
    model, cfg = solver.model, solver.cfg
    bsolver, bparams, *_ = drive_oval.build(model="bf", rollouts=KB,
                                            device=dev)
    bmodel, bcfg = bsolver.model, bsolver.cfg
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    ocoeff = dict(obstacle_coeff=drive_oval.OBSTACLE_COEFF,
                  inflation=drive_oval.OBSTACLE_INFLATION)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    ahead = start.clone()
    ahead[4] = 1.0                 # phase 17's start: moving up the lane
    gen = torch.Generator(device=dev)
    gen.manual_seed(36)
    n_mlp, n_bf = rk.KERNEL_NUM_WEIGHTS, rk.KERNEL_BF_WEIGHTS
    map_floats = costmap.height * costmap.width
    steps = {"MLP": mlp_flops(model.layers), "BF": BF_STEP_OPS}
    models = {"MLP": (model, params, cfg, n_mlp),
              "BF": (bmodel, bparams, bcfg, n_bf)}
    print(f"[many circles] a launch stages up to {rk.MAX_OBSTACLES} circles "
          f"in shared memory and reads more in device memory; staged at "
          f"{MANY_SLOTS}: {[rk.staged_obstacles(n) for n in MANY_SLOTS]}")

    def hold(tag, launch_fn, plain_fn, along_fn, k, bits_fn=None,
             mixed=True):
        """A fused form against its plain version (``plain_fn``: (costs,
        u_seq or None, crash)): costs and crash flags (phase 17-18's rule:
        every rollout along kernel 2's trajectories where ``along_fn`` is
        given, all but 1 % against the whole plain version, whose
        trajectories differ by rounding), u_seq bit for bit, and with
        ``mixed`` some rollouts crashed and some not; ``bits_fn``: pass 1
        bit for bit kernel 1 or 3 fed its stream.  Returns (launch,
        outputs, error, plain ms)."""
        launch, out = launch_fn()
        launch()
        torch.cuda.synchronize()
        plain, plain_ms = plain_timed(plain_fn)
        kc, kx = out[0], out[-1]
        pc, px = plain[0], plain[2]
        err = agreement(tag, "against the plain version", kc, kx, pc, px, k,
                        limit=k // 100)
        if along_fn is not None:
            bc, bx = along_fn()
            err = agreement(tag, "along kernel 2's trajectories", kc, kx, bc,
                            bx, k, limit=0)
        if len(out) == 3:
            check(bit_equal(out[1], plain[1]), f"{tag}: u_seq differs from "
                  "its plain version's")
        if bits_fn is not None:
            oc, _, ox = bits_fn()
            torch.cuda.synchronize()
            same = bit_equal(kc, oc) and bit_equal(kx, ox)
            print(f"[{tag}] bit for bit the eps-reading kernel fed its "
                  f"stream: {same} ({card})")
            check(same, f"{tag}: pass 1 differs from the eps-reading kernel "
                  "fed its stream")
        n_hit = int(kx.sum().item())
        print(f"[{tag}] {launch.name}: crash {n_hit}/{k} ({card})")
        check(not mixed or 0 < n_hit < k, f"{tag}: no rollout or every "
              "rollout crashed")
        return launch, out, err, plain_ms

    def p1_plain(*args, **kw):
        """Pass 1's plain version as (costs, None, crash)."""
        costs, crash, _ = rk.fused_rng_costs_plain(*args, **kw)
        return costs, None, crash

    # (a) kernel 1 (MLP in the launcher's geometry, G=8 at K=1920; BF one
    # rollout a thread at K=2560) at 65, 128 and 1024 slots
    for kind, (m, p, c, n_w) in models.items():
        eps = torch.randn((T, c.num_rollouts, 2), generator=gen, device=dev)
        k = c.num_rollouts
        for slots in MANY_SLOTS:
            circles = many_circles(m, p, c, ahead, U, slots, seed=slots)
            okw = dict(obstacles=circles, **ocoeff)
            tag = f"many circles (a) kernel 1 {kind} K={k} slots {slots}"
            launch, _, err, plain_ms = hold(
                tag,
                lambda: rk.prepare_fused_exact_rollout_cost(
                    m, p, c, cp, costmap, ahead, U, eps, **okw),
                lambda: rk.fused_rollout_cost_plain(
                    m, p, c, cp, costmap, ahead, U, eps, **okw),
                lambda: rk.trajectory_cost_plain(
                    m, p, c, cp, costmap, U, eps, rk.dynamics_chain(
                        m, p, c, ahead, U, eps)[0], **okw), k)
            rowargs.append(((1, kind, k, slots), launch, MANY_REPS["small"],
                            plain_ms, err, fused_circle_bound(
                                k, n_w, steps[kind], circles,
                                map_floats=map_floats), 1013,
                            dict(K=k, slots=slots)))
        del eps

    # kernel 3 (MLP, BF) at K=65536 on phase 11's field, 128 slots
    for kind, (m, p, c, n_w) in models.items():
        c3 = c.replace(num_rollouts=KF)
        eps = torch.randn((T, KF, 2), generator=gen, device=dev)
        circles = many_circles(m, p, c3, ahead, U, WIDE_SLOTS, seed=3)
        okw = dict(obstacles=circles, **ocoeff)
        tag = f"many circles (a) kernel 3 {kind} K={KF} slots {WIDE_SLOTS}"
        launch, _, err, plain_ms = hold(
            tag,
            lambda: rk.prepare_fused_rollout_cost(
                m, p, c3, cp, field, ahead, U, eps, **okw),
            lambda: rk.fused_rollout_cost_plain(
                m, p, c3, cp, field, ahead, U, eps, **okw),
            None, KF)
        rowargs.append(((3, kind, KF, WIDE_SLOTS), launch, MANY_REPS["large"],
                        plain_ms, err, fused_circle_bound(
                            KF, n_w, steps[kind], circles, field), 606,
                        dict(K=KF, slots=WIDE_SLOTS)))
        del eps

    # pass 1 at K=262144, 128 slots: exact MLP and BF, field MLP; each
    # against its plain version and bit for bit kernel 1 / 3 fed its stream
    p1_forms = (("exact MLP", "MLP", costmap), ("exact BF", "BF", costmap),
                ("field MLP", "MLP", field))
    for label, kind, surface in p1_forms:
        m, p, c, n_w = models[kind]
        cc = c.replace(num_rollouts=KC, kernel_rng=True)
        circles = many_circles(m, p, cc, ahead, U, WIDE_SLOTS, seed=4)
        okw = dict(obstacles=circles, **ocoeff)
        is_field = surface is field
        prep = (rk.prepare_fused_rollout_cost if is_field
                else rk.prepare_fused_exact_rollout_cost)
        box = {}

        def launch_p1():
            launch, (kc, kx), ctx = rk.prepare_fused_rng_costs(
                m, p, cc, cp, surface, ahead, U, key, **okw)
            box["ctx"] = ctx
            return launch, (kc, kx)

        def bits():
            e = rk.rng_noise(box["ctx"])
            one, out = prep(m, p, cc.replace(kernel_rng=False), cp, surface,
                            ahead, U, e, **okw)
            one()
            return out

        tag = f"many circles (a) pass 1 {label} K={KC} slots {WIDE_SLOTS}"
        launch, _, err, plain_ms = hold(
            tag, launch_p1,
            lambda: p1_plain(m, p, cc, cp, surface, ahead, U, key, **okw),
            None, KC, bits_fn=bits)
        box.clear()
        rowargs.append(((4, label, KC, WIDE_SLOTS), launch,
                        MANY_REPS["large"], plain_ms, err, fused_circle_bound(
                            KC, n_w, steps[kind], circles,
                            field if is_field else None, map_floats,
                            stream=True), 1221,
                        dict(K=KC, slots=WIDE_SLOTS)))

    # the lane forms at L=3, K=512, 128 slots a lane: kernel 1, kernel 3,
    # pass 1 exact and field; each lane bit for bit its solo instance
    L, K_ = MANY_LANES
    cp3 = lane_cost_grid(L)
    lanes = lane_cost_params(cp3)
    state, Ul, eps = lane_inputs(L, K_, dev, seed=36)
    c = cfg.replace(num_rollouts=K_)
    circles = lane_circles(rk, model, params, c, state, Ul, WIDE_SLOTS,
                           True, seed=36)
    lkw = dict(obstacles=circles, obstacle_coeff=LANE_COEFF,
               inflation=LANE_INFLATION)
    for kernel, surface in ((1, costmap), (3, field)):
        prep = (rk.prepare_fused_exact_rollout_cost_lanes if kernel == 1
                else rk.prepare_fused_rollout_cost_lanes)
        solo = (rk.prepare_fused_exact_rollout_cost if kernel == 1
                else rk.prepare_fused_rollout_cost)
        held = lane_hold(
            f"many circles (a) lanes kernel {kernel} L={L} K={K_} slots "
            f"{WIDE_SLOTS}",
            lambda: prep(model, params, c, cp3, surface, state, Ul, eps,
                         **lkw),
            lambda: rk.fused_rollout_cost_lanes_plain(
                model, params, c, cp3, surface, state, Ul, eps, **lkw),
            lambda i: solo(model, params, c, lanes[i], surface, state[i],
                           Ul[i], eps, obstacles=circles[i], **{
                               k: v for k, v in lkw.items()
                               if k != "obstacles"}),
            L, K_, card)
        launch = held["runs"][0][0]
        kx = held["runs"][0][1][2]
        check(bool(kx.any().item()), f"many circles lanes kernel {kernel}: "
              "the circles crash no rollout")
        bnd = fused_circle_bound(K_, n_mlp, steps["MLP"], circles,
                                 None if kernel == 1 else field, map_floats,
                                 lanes=L)
        rowargs.append(((kernel, "lanes", L, K_), launch, MANY_REPS["small"],
                        held["plain_ms"], held["err"], bnd,
                        606 if kernel == 3 else 1013,
                        dict(K=K_, lanes=L, slots=WIDE_SLOTS)))
    cc = c.replace(kernel_rng=True)
    for label, surface in (("exact", costmap), ("field", field)):
        held = cap_lanes_held(rk, f"many circles (a) pass 1 {label} L={L} "
                              f"K={K_} slots {WIDE_SLOTS}", model, params, cc,
                              cp3, surface, state, Ul, key, circles, card)
        bnd = fused_circle_bound(K_, n_mlp, steps["MLP"], circles,
                                 None if surface is costmap else field,
                                 map_floats, stream=True, lanes=L)
        rowargs.append(((4, f"lanes {label}", L, K_), held["launch"],
                        MANY_REPS["small"], held["plain_ms"], held["err"],
                        bnd, 1221, dict(K=K_, lanes=L, slots=WIDE_SLOTS)))
    del eps

    # (b) the pair's library: its build (last at phase 1), layout, kernels
    t_wait = time.perf_counter()
    lib, lib_s = builds.get(PAIR_LAYERS, PAIR_FIELD)
    tag = (f"many circles (b) {spec_label(PAIR_LAYERS)} "
           f"{_build.field_label(PAIR_FIELD)}")
    print(f"[{tag}] {_build.library_path(PAIR_LAYERS, PAIR_FIELD).name}: "
          + (f"nvcc {lib.build[0]:.1f}s" if lib.build else "already built")
          + f", {lib_s:.1f}s, done "
          f"{builds.done[PAIR_LAYERS, PAIR_FIELD, False]:.1f}s into the run, "
          f"waited {time.perf_counter() - t_wait:.1f}s at phase 36 ({card})")
    field_library_instances(rk, PAIR_LAYERS, PAIR_FIELD, lib, card)
    lay = rk.field_smem_layout(PAIR_LAYERS, T, 0, PAIR_FIELD)
    staged = rk.field_pack_floats(PAIR_FIELD) + lay["U"] + 2 * T
    print(f"[{tag}] layout {lay['layout']} (the library's "
          f"artt_field_global {lib.artt_field_global()}): the packed field "
          f"({4 * rk.field_pack_floats(PAIR_FIELD)} bytes) in device memory, "
          f"{lay['bytes']} bytes of shared memory a block at T={T} (the "
          f"staged layout would need {4 * staged}, over {4 * rk.SMEM_FLOATS}"
          f"); T up to {rk.max_field_kernel_t(PAIR_LAYERS, PAIR_FIELD)}, "
          f"lanes {rk.max_field_kernel_t(PAIR_LAYERS, PAIR_FIELD, True)}")
    check(lay["layout"] == "global" and lib.artt_field_global() == 1,
          f"{tag}: the pair's library does not keep the field in device "
          "memory")
    wmodel, wparams, wcfg = spec_setup(PAIR_LAYERS, dev)
    pfield = seeded_field(costmap, dev, seed=36, fspec=PAIR_FIELD)
    n_wide = rk.num_weights(PAIR_LAYERS)
    wstep = mlp_flops(PAIR_LAYERS)
    eps = torch.randn((T, KS, 2), generator=gen, device=dev)
    wcap = wcfg.replace(kernel_rng=True)
    launch3, out3, err3, plain3 = hold(
        f"{tag} kernel 3 K={KS}",
        lambda: rk.prepare_fused_rollout_cost(wmodel, wparams, wcfg, cp,
                                              pfield, start, U, eps),
        lambda: rk.fused_rollout_cost_plain(wmodel, wparams, wcfg, cp,
                                            pfield, start, U, eps),
        None, KS, mixed=False)
    box = {}

    def pair_p1():
        launch, out, box["ctx"] = rk.prepare_fused_rng_costs(
            wmodel, wparams, wcap, cp, pfield, start, U, key)
        return launch, out

    def pair_bits():
        one, out = rk.prepare_fused_rollout_cost(
            wmodel, wparams, wcfg, cp, pfield, start, U,
            rk.rng_noise(box["ctx"]))
        one()
        return out

    launch1, _, err1, plain1 = hold(
        f"{tag} field pass 1 K={KS}", pair_p1,
        lambda: p1_plain(wmodel, wparams, wcap, cp, pfield, start, U, key),
        None, KS, bits_fn=pair_bits, mixed=False)
    box.clear()
    nobs = torch.zeros((0, 3), device=dev)
    rowargs.append(((3, "pair", KS), launch3, MANY_REPS["large"], plain3,
                    err3, fused_circle_bound(KS, n_wide, wstep, nobs, pfield),
                    606,
                    dict(K=KS, layers=list(PAIR_LAYERS),
                         field=_build.field_label(PAIR_FIELD),
                         layout=lay["layout"])))
    rowargs.append(((4, "pair", KS), launch1, MANY_REPS["large"], plain1,
                    err1, fused_circle_bound(KS, n_wide, wstep, nobs, pfield,
                                             stream=True), 1221,
                    dict(K=KS, layers=list(PAIR_LAYERS),
                         field=_build.field_label(PAIR_FIELD),
                         layout=lay["layout"])))
    del eps
    # the pair's lane forms at L=3, K=8192: kernel 3 and field pass 1
    state, Ul, eps = lane_inputs(LIB_LANES, KS, dev, seed=37)
    cpl = lane_cost_grid(LIB_LANES)
    held3 = lane_hold(
        f"{tag} lanes kernel 3 L={LIB_LANES} K={KS}",
        lambda: rk.prepare_fused_rollout_cost_lanes(
            wmodel, wparams, wcfg, cpl, pfield, state, Ul, eps),
        lambda: rk.fused_rollout_cost_lanes_plain(
            wmodel, wparams, wcfg, cpl, pfield, state, Ul, eps),
        lambda i: rk.prepare_fused_rollout_cost(
            wmodel, wparams, wcfg, lane_cost_params(cpl)[i], pfield,
            state[i], Ul[i], eps), LIB_LANES, KS, card)
    held1 = cap_lanes_held(rk, f"{tag} lanes field pass 1 L={LIB_LANES} "
                           f"K={KS}", wmodel, wparams, wcap, cpl, pfield,
                           state, Ul, key, None, card)
    for kernel, held_l, launch in ((3, held3, held3["runs"][0][0]),
                                   (4, held1, held1["launch"])):
        rowargs.append((
            (kernel, "pair lanes", LIB_LANES, KS), launch, MANY_REPS["large"],
            held_l["plain_ms"], held_l["err"], fused_circle_bound(
                KS, n_wide, wstep, nobs, pfield, stream=kernel == 4,
                lanes=LIB_LANES),
            606 if kernel == 3 else 1221,
            dict(K=KS, lanes=LIB_LANES, layers=list(PAIR_LAYERS),
                 field=_build.field_label(PAIR_FIELD), layout=lay["layout"])))
    del eps

    # (c) the drives, each with its exact launches a solve and no plain
    # version: BASELINE #1 among the cones (host noise and capacity), and
    # the pair (host noise and capacity)
    cones = oval_cones()
    cone_cost = ObstacleCost(make_obstacles(cones, CONE_SLOTS, device=dev),
                             **ocoeff)
    print(f"[many circles (c)] {len(cones)} cones in {CONE_SLOTS} slots on "
          f"the oval's edges ({CONE_OFFSET} m off its centreline, radius "
          f"{CONE_RADIUS} m, every {CONE_EVERY} m of arc over the quarter "
          f"ahead of the start)")
    check(90 <= len(cones) <= CONE_SLOTS, f"many circles (c): {len(cones)} "
          "cones")
    label = spec_label(PAIR_LAYERS)
    flabel = _build.field_label(PAIR_FIELD)
    drives = {
        "cones": (MPPISolver(model, cone_cost, cfg, device=dev), params,
                  costmap, CONE_TICKS, {"fused_exact_rollout_cost_obstacles":
                                        1, "dynamics_chain": 1},
                  (1, "MLP", K, WIDE_SLOTS)),
        "cones capacity": (MPPISolver(model, cone_cost, cfg.replace(
            num_rollouts=KC, kernel_rng=True), device=dev), params, costmap,
            CONE_CAP_TICKS, {"fused_rng_costs_obstacles": 1,
                             "fused_rng_numer": 1, "dynamics_chain": 1},
            (4, "exact MLP", KC, WIDE_SLOTS)),
        "pair": (MPPISolver(wmodel, MPPICost(), wcfg, device=dev), wparams,
                 pfield, PAIR_TICKS,
                 {f"fused_rollout_cost_{label}_{flabel}": 1,
                  f"dynamics_chain_{label}": 1}, (3, "pair", KS)),
        "pair capacity": (MPPISolver(wmodel, MPPICost(), wcap, device=dev),
                          wparams, pfield, PAIR_TICKS,
                          {f"fused_rng_costs_field_{label}_{flabel}": 1,
                           "fused_rng_numer": 1,
                           f"dynamics_chain_{label}": 1}, (4, "pair", KS)),
    }
    launches = {}
    for name, (s, prm, surface, ticks, per_solve, row_key) in drives.items():
        latency, got, _ = drive_counted(drive_oval, rk,
                                        f"many circles (c) {name}", s, prm,
                                        cp, surface, ticks, per_solve, card)
        print(f"[many circles (c) {name}] solve p50 {latency[0]:.3f} ms, p99 "
              f"{latency[1]:.3f} ms against the 20 ms budget (reported, not "
              f"gated; host clock; {card})")
        results[name] = {"latency": latency, "launches": got}
        fused = next(n for n in per_solve if not n.startswith(
            ("dynamics_chain", "fused_rng_numer")))
        launches[row_key] = got.get(fused, 0)

    # the kernels line: each form timed at its shape
    for row_key, launch, reps, plain_ms, err, bnd, line, extra in rowargs:
        rows.append(many_row(launch.name, launch, reps, plain_ms, err, bnd,
                             launches.get(row_key, 0), card, line, **extra))
    results["layout"] = lay
    results["cones"] = len(cones)
    return {"results": results, "rows": rows}


# -- phase 38: the car's I/O around the solve on the card -------------------
# A scripted circle (IO_SECONDS at IO_IMU_HZ) feeds the EKF: noisy IMU, GPS
# as GPGGA + GPGST bytes through the receiver and the bridge (IO_GPS_HZ),
# wheel speeds as #w frames over a pty through ChassisLink and
# WheelOdometry (IO_CONTROL_HZ).  At IO_CONTROL_HZ the EKF's state vector
# goes to the plant and BASELINE #1 solves on the card; the plant's control
# goes as ChassisCommand("mppi") into a CommandArbiter beside the
# ConstantSpeed and waypoint fallbacks, through SafeSpeedGovernor, under a
# runstop from a VehicleNetworkNode that a coordinator drives, and out as
# #s frames read back from the pty.  In the second half a peer's relayed
# pose is a circle of an ObstacleCost.
IO_SECONDS, IO_IMU_HZ, IO_GPS_HZ, IO_CONTROL_HZ = 6.0, 200, 10, 50
IO_CENTRE, IO_RADIUS, IO_SPEED = (20.0, 0.0), 10.0, 5.0
IO_DROPOUT = (60, 80)             # control ticks with MPPI silent
IO_RUNSTOP = (100, 120)           # control ticks with the runstop off
IO_PEER_RADIUS = 0.5
IO_PRIORITIES = ("mppi", "constantSpeedController", "waypointFollower")
IO_SAFE_SPEED = 8.0
IO_PROBE_ITERS = 5                # the forecast's probe
FORECAST_KEYS = ("nvlink", "infiniband")


def io_truth(t: float):
    """The scripted circle at ``t``: position (3,), yaw, body-frame specific
    force and angular rate (a perfect IMU), from drive_oval's start
    heading +y."""
    import math

    w = IO_SPEED / IO_RADIUS
    th = w * t
    pos = np.array([IO_CENTRE[0] + IO_RADIUS * math.cos(th),
                    IO_CENTRE[1] + IO_RADIUS * math.sin(th), 0.0])
    yaw = th + math.pi / 2
    a_world = np.array([-IO_RADIUS * w * w * math.cos(th),
                        -IO_RADIUS * w * w * math.sin(th), 0.0])
    R = np.array([[math.cos(yaw), -math.sin(yaw), 0.0],
                  [math.sin(yaw), math.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
    accel = R.T @ (a_world - np.array([0.0, 0.0, -9.80665]))
    return pos, yaw, accel, np.array([0.0, 0.0, w])


def forecast_schema_ok(d: dict) -> bool:
    """``tests/test_artifacts.py``'s scaling schema with the GPU fabrics'
    keys."""
    import math

    num = lambda x: (isinstance(x, (int, float)) and not isinstance(x, bool)
                     and math.isfinite(x))
    try:
        ok = (d["artifact"] == "scaling_forecast" and num(d["payload_bytes"])
              and num(d["fit"]["chain_floor_ms"])
              and num(d["fit"]["ms_per_rollout"]) and d["forecast"]
              and isinstance(d["validation"]["measured_per_iter_us"], dict)
              and num(d["validation"]["max_shape_rel_err"]))
        for per_k in d["forecast"].values():
            for fab in FORECAST_KEYS:
                ok = ok and bool(per_k[fab]) and all(
                    num(r["efficiency"]) and num(r["t_n_ms"])
                    for r in per_k[fab])
        return bool(ok)
    except (KeyError, TypeError):
        return False


def vehicle_io_phase(drive_oval, rk, card, ms_k1920: float,
                     dev=None) -> dict:
    """Phase 38 (see above).  Checks: exactly 1 + 1 launches a solve
    (kernel 1's obstacle instance once the peer's circle is live) and no
    plain version; every #s frame the arbitrated command's pulse widths;
    the fallbacks owning both actuators from command_max_age into the MPPI
    dropout until MPPI's next command; every throttle pulse of the runstop
    span the runstop's; the peer's pose in kernel 1's circle slots.
    Printed: the solve's p50 / p99, the I/O's host ms a tick, the EKF's
    position error.  Then the scaling forecast with this run's kernel-1
    ladder (``ms_k1920``: phase 5's; K=8192 and 262144 timed here alike)
    and a short probe, its document held to the schema."""
    import math
    import os
    import pty
    import struct

    import torch
    from autorally_tpu_torch import msgs
    from autorally_tpu_torch.config import CostParams
    from autorally_tpu_torch.costs import ObstacleCost
    from autorally_tpu_torch.costs import make_obstacles
    from autorally_tpu_torch.runtime.chassis import (ActuatorCalibration,
                                                     ChassisLink,
                                                     CommandArbiter)
    from autorally_tpu_torch.runtime.controllers import (
        ConstantSpeedController, GpsWaypointController, SafeSpeedGovernor)
    from autorally_tpu_torch.runtime.gps import (GpsEstimatorBridge,
                                                 GpsNmeaSimulator,
                                                 GpsReceiver)
    from autorally_tpu_torch.runtime.plant import BasePlant
    from autorally_tpu_torch.runtime.serial_device import (SerialSettings,
                                                           configure_port)
    from autorally_tpu_torch.runtime.state_estimator import ErrorStateEKF
    from autorally_tpu_torch.runtime.vehicle_network import (
        VehicleNetworkCoordinator, VehicleNetworkNode)
    from autorally_tpu_torch.runtime.wheel_odometry import WheelOdometry
    from autorally_tpu_torch.sim.sensors import SensorSimConfig
    from autorally_tpu_torch.solver.mppi import MPPISolver
    from autorally_tpu_torch.tools import scaling_forecast
    from autorally_tpu_torch.tools.ab_builds import last_call

    dev = dev or torch.device("cuda", 0)
    solver, params, cp, costmap, _ = drive_oval.build(rollouts=K, device=dev)
    model, cfg = solver.model, solver.cfg
    ocoeff = dict(obstacle_coeff=drive_oval.OBSTACLE_COEFF,
                  inflation=drive_oval.OBSTACLE_INFLATION)
    osolver = MPPISolver(model, ObstacleCost(make_obstacles(
        [], N_SLOTS, device=dev), **ocoeff), cfg, device=dev)
    sens = SensorSimConfig()
    rs = np.random.RandomState(38)
    n_imu = int(IO_SECONDS * IO_IMU_HZ)
    per_tick = IO_IMU_HZ // IO_CONTROL_HZ
    n_ticks = n_imu // per_tick

    # the sensors and the estimator
    ekf = ErrorStateEKF()
    pos0, yaw0, _, _ = io_truth(0.0)
    ekf.initialize(0.0, pos0, yaw0)
    ekf.v = np.array([0.0, IO_SPEED, 0.0])
    nmea = GpsNmeaSimulator(sigma=sens.gps_noise)
    bridge = GpsEstimatorBridge(ekf, reference=nmea.ref)
    rx = GpsReceiver(position_source="GPGGA", on_fix=bridge)
    cal = ActuatorCalibration()
    odom = WheelOdometry()
    odom.set_pose(pos0[0], pos0[1], yaw0)
    wheel = []
    master, slave = pty.openpty()
    configure_port(slave, SerialSettings())
    link = ChassisLink(slave, cal,
                       on_wheel_speeds=lambda *s: wheel.append(s))
    # the command chain and the network
    arb = CommandArbiter(list(IO_PRIORITIES))
    csc = ConstantSpeedController()
    csc.set_speed(IO_SPEED)
    wpf = GpsWaypointController([(IO_CENTRE[0], IO_CENTRE[1] + IO_RADIUS),
                                 (IO_CENTRE[0] - IO_RADIUS, IO_CENTRE[1])],
                                use_theta_gps=False)
    gov = SafeSpeedGovernor()
    plant = BasePlant(cfg.dt, cfg.num_timesteps, use_feedback_gains=False)
    coord = VehicleNetworkCoordinator(runstop_hz=200.0)
    coord.set_runstop(True)
    hub = ("127.0.0.1", coord.port)
    ego = VehicleNetworkNode("ego", hub)
    peer = VehicleNetworkNode("peer", hub, transmit_hz=1e6)
    results, records, sent = {}, [], set()
    solve_ms, io_ms, est_err, halves = [], [], [], {}
    half = n_ticks // 2
    peer_circle, last_mppi = None, None
    with contextlib.ExitStack() as stack:
        for node in (coord, ego, peer):
            node.start()
            stack.callback(node.close)
        stack.callback(os.close, master)
        stack.callback(os.close, slave)
        wait_until(lambda: len(coord.active_vehicles()) == 2
                   and ego.motion_enabled, "the network's registrations "
                   "and runstop", timeout=10.0)
        cs = solver.init_state()
        cs, _ = solver.solve(params, cp, costmap,
                             np.array(drive_oval.START, np.float32), cs)
        torch.cuda.synchronize()
        plain = stack.enter_context(PlainCalls(rk))
        rk.LAUNCHES.clear()
        for i in range(1, n_imu + 1):
            t0 = time.perf_counter()
            t = i / IO_IMU_HZ
            pos, _, accel, gyro = io_truth(t)
            ekf.imu_update(t, accel + np.asarray(sens.accel_bias)
                           + rs.randn(3) * sens.accel_noise,
                           gyro + np.asarray(sens.gyro_bias)
                           + rs.randn(3) * sens.gyro_noise)
            if i % (IO_IMU_HZ // IO_GPS_HZ) == 0:
                rx.feed(nmea.sentences(t, pos[0] + rs.randn() * sens.gps_noise,
                                       pos[1] + rs.randn() * sens.gps_noise))
            if i % per_tick:
                io_ms.append((time.perf_counter() - t0) * 1e3)
                continue
            tick = i // per_tick - 1
            # wheel speeds: a #w frame into the pty, read by the link
            rps = (IO_SPEED + rs.randn(4) * sens.vel_noise) / (
                link.wheel_diameter * math.pi)
            os.write(master, ("#w" + ",".join(f"{v:.4f}" for v in rps)
                              + "\n").encode())
            n_wheel = len(wheel)
            while len(wheel) == n_wheel:
                link.process_bytes(os.read(slave, 256))
            est = odom.update_wheel_speeds(t, *wheel[-1])
            ekf.velocity_update(np.array([est.v_x, 0.0, 0.0]))
            sv = ekf.state_vector(IO_SPEED / IO_RADIUS)
            est_err.append(float(np.hypot(sv[0] - pos[0], sv[1] - pos[1])))
            out = plant.receive_state_vector(t, sv)
            # the runstop span: the coordinator decides, the node hears it
            if tick in IO_RUNSTOP:
                on = tick == IO_RUNSTOP[1]
                coord.set_runstop(on)
                wait_until(lambda: ego.motion_enabled == on,
                           "the node hearing the coordinator's runstop")
            arb.submit_runstop("network", ego.motion_enabled, t)
            if out is not None and not (IO_DROPOUT[0] <= tick
                                        < IO_DROPOUT[1]):
                arb.submit(msgs.ChassisCommand(
                    sender="mppi", stamp=t, steering=out[0],
                    throttle=out[1], front_brake=0.0))
                last_mppi = t
            arb.submit(csc.wheel_speeds(*wheel[-1], t))
            arb.submit(wpf.odometry(sv[0], sv[1], sv[2], t))
            gov.submit_safe_speed("ocs", IO_SAFE_SPEED, t)
            st = arb.arbitrate(t)
            throttle = gov.safe_throttle(st.throttle, float(sv[4]), t)
            link.send_command(st.steering, throttle, st.front_brake)
            records.append((tick, t, last_mppi, st, throttle,
                            os.read(master, 64)))
            # the second half: the peer's pose, 1 s ahead on the circle,
            # relayed by the coordinator, is the ObstacleCost's circle
            if tick >= half:
                ahead, _, _, _ = io_truth(t + 1.0)
                pose = (float(ahead[0]), float(ahead[1]))
                check(peer.transmit_pose(t, *pose, 0.0, 0.0, 0.0),
                      "vehicle io: the peer's pose was not sent")
                sent.add(pose)
                if tick == half:
                    halves["first"] = dict(rk.LAUNCHES)
                    rk.LAUNCHES.clear()
                    last = stack.enter_context(last_call(
                        rk, "fused_exact_rollout_cost"))
                    wait_until(lambda: "peer" in ego.peers(), "the peer's "
                               "pose relayed to the ego node")
                p = ego.peers()["peer"]
                peer_circle = (p["x"], p["y"], IO_PEER_RADIUS)
            io_ms.append((time.perf_counter() - t0) * 1e3)
            # the solve on the card: slide + solve + the plan's readback
            t1 = time.perf_counter()
            state = plant.get_state().to_vector()
            if tick >= half:
                s_, cpt = osolver, CostParams(obstacles=make_obstacles(
                    [peer_circle], N_SLOTS, device=dev))
            else:
                s_, cpt = solver, cp
            cs = s_.slide(cs, cfg.optimization_stride)
            cs, _ = s_.solve(params, cpt, costmap, state, cs)
            plant.set_solution(cs.state_solution.cpu().numpy(),
                               cs.control_solution.cpu().numpy(), None, ts=t)
            solve_ms.append((time.perf_counter() - t1) * 1e3)
        halves["second"] = dict(rk.LAUNCHES)

    # launches: 1 + 1 a solve, kernel 1's obstacle instance in the second
    # half; no plain version
    n_first, n_second = half, n_ticks - half
    want = {"first": {"fused_exact_rollout_cost": n_first,
                      "dynamics_chain": n_first},
            "second": {"fused_exact_rollout_cost_obstacles": n_second,
                       "dynamics_chain": n_second}}
    print(f"[vehicle io] launches {halves}, expected {want}; plain-version "
          f"calls {plain.calls} ({card})")
    check(halves == want, f"vehicle io: launches {halves}, expected {want}")
    check(not any(plain.calls.values()), "vehicle io: a plain version ran")
    # the #s frames: the arbitrated command's pulse widths
    bad = 0
    for tick, t, _, st, throttle, frame in records:
        want_f = b"#s" + struct.pack(
            ">hhh", cal.cmd_to_us(st.steering, "steering"),
            cal.cmd_to_us(throttle, "throttle"),
            cal.cmd_to_us(st.front_brake, "frontBrake")) + b"\n"
        bad += frame != want_f
    print(f"[vehicle io] {len(records)} #s frames, {bad} not the arbitrated "
          f"command's pulse widths")
    check(bad == 0 and len(records) == n_ticks, "vehicle io: a #s frame "
          "differs from the arbitrated command")
    # the dropout: MPPI within command_max_age, then the fallbacks, then
    # MPPI again at its next command
    wrong = []
    for tick, t, lm, st, _, _ in records:
        if tick < IO_DROPOUT[0] - 5 or tick > IO_DROPOUT[1] + 5:
            continue
        fresh = lm is not None and t - lm < arb.command_max_age
        owners = (st.steering_commander, st.throttle_commander)
        expect = (("mppi", "mppi") if fresh
                  else ("waypointFollower", "constantSpeedController"))
        if owners != expect:
            wrong.append((tick, owners, expect))
    took = [tick for tick, t, lm, st, _, _ in records
            if IO_DROPOUT[0] <= tick < IO_DROPOUT[1]
            and st.throttle_commander == "constantSpeedController"]
    print(f"[vehicle io] MPPI silent at ticks {IO_DROPOUT}: the fallbacks "
          f"own both actuators from tick {took[0] if took else None} "
          f"(command_max_age {arb.command_max_age} s = "
          f"{arb.command_max_age * IO_CONTROL_HZ:.0f} ticks), MPPI again "
          f"from tick {IO_DROPOUT[1]}; wrong owners {wrong[:5]}")
    check(not wrong and took and took[0] - IO_DROPOUT[0] <= round(
        arb.command_max_age * IO_CONTROL_HZ), "vehicle io: the dropout's "
          "owners are wrong")
    # the runstop: every throttle pulse in the span the runstop's (0)
    off = cal.cmd_to_us(0.0, "throttle")
    span = [(tick, st.throttle_commander, struct.unpack(">h", frame[4:6])[0])
            for tick, _, _, st, _, frame in records
            if IO_RUNSTOP[0] <= tick < IO_RUNSTOP[1]]
    runstopped = [s for s in span if s[1] == "runstop" and s[2] == off]
    after = [st.throttle_commander for tick, _, _, st, _, _ in records
             if tick == IO_RUNSTOP[1]]
    print(f"[vehicle io] runstop off at ticks {IO_RUNSTOP}: {len(runstopped)}"
          f"/{len(span)} throttle pulses {off} us by the runstop; tick "
          f"{IO_RUNSTOP[1]}'s throttle commander {after}")
    check(len(runstopped) == len(span) == IO_RUNSTOP[1] - IO_RUNSTOP[0]
          and after == ["mppi"], "vehicle io: a throttle pulse in the "
          "runstop span is not the runstop's")
    # the peer's pose in kernel 1's circle slots
    args, kw = last["args"]
    slots = kw["obstacles"]
    print(f"[vehicle io] the peer's relayed pose {peer_circle} (one of the "
          f"{len(sent)} it sent: {peer_circle[:2] in sent}); kernel 1's "
          f"slots {slots[:2].tolist()} of {slots.shape[0]}")
    check(peer_circle[:2] in sent and torch.equal(
        slots[0].cpu(), torch.tensor(peer_circle, dtype=torch.float32))
          and bool((slots[1:, 2] < 0).all()), "vehicle io: the peer's pose "
          "is not in the kernel's circle slots")
    one, (c_on, _, _) = rk.prepare_fused_exact_rollout_cost(*args, **kw)
    one()
    args_off = args[:3] + (args[3].replace(obstacles=None),) + args[4:]
    two, (c_off, _, _) = rk.prepare_fused_exact_rollout_cost(
        *args_off, **dict(kw, obstacles=None))
    two()
    torch.cuda.synchronize()
    priced = int((c_on != c_off).sum().item())
    print(f"[vehicle io] the circle prices {priced} of {K} rollouts of the "
          f"last solve")
    check(priced > 0, "vehicle io: the peer's circle prices no rollout")
    lat = (float(np.percentile(solve_ms, 50)),
           float(np.percentile(solve_ms, 99)))
    io_tick = float(np.sum(io_ms)) / n_ticks
    err2 = float(np.mean(est_err[len(est_err) // 2:]))
    print(f"[vehicle io] {n_ticks} ticks: solve p50 {lat[0]:.3f} ms, p99 "
          f"{lat[1]:.3f} ms (slide + solve + the plan's readback, host "
          f"clock); the I/O {io_tick:.3f} ms a tick (host); the EKF's "
          f"position error {err2:.3f} m (mean, second half); GPS updates "
          f"{bridge.updates}, bad checksums {rx.framer.bad_checksums} "
          f"(reported, not gated; {card})")
    results.update(solve_ms_p50_p99=lat, io_ms_per_tick=io_tick,
                   ekf_err_m=err2, launches=halves, frames=len(records))

    # the scaling forecast on this run's kernel-1 ladder and a short probe
    ladder = {K: ms_k1920}
    for k in (KS, KC):
        ck = cfg.replace(num_rollouts=k)
        gen = torch.Generator(device=dev)
        gen.manual_seed(k)
        e = torch.randn((T, k, 2), generator=gen, device=dev)
        U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
        launch, _ = rk.prepare_fused_exact_rollout_cost(
            model, params, ck, cp, costmap, torch.tensor(
                drive_oval.START, dtype=torch.float32, device=dev), U, e)
        ladder[k] = cuda_ms(launch, 100)
        del e
    t_f = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):     # its JSON line
        doc = scaling_forecast.main(
            ["--ladder", ",".join(f"{k}={v}" for k, v in ladder.items()),
             "--iters", str(IO_PROBE_ITERS)])
    print(f"[forecast] ladder {ladder} ms (kernel 1, T={T}; {card}); fit "
          f"{doc['fit']}; payload {doc['payload_bytes']} B; probe "
          f"{doc['validation']['measured_per_iter_us']} us an iteration on "
          f"2 gloo CPU ranks; {time.perf_counter() - t_f:.1f}s")
    check(forecast_schema_ok(doc), "forecast: the document misses the "
          "schema")
    results["forecast"] = {"ladder_ms": ladder, "fit": doc["fit"],
                           "validation": doc["validation"],
                           "K262144": doc["forecast"]["K262144"]}
    return results


# -- phase 39: every horizon the JAX kernels take ---------------------------
# Past the horizon at which a launch stages U in shared memory (rk.staged_u:
# kernels 1, 2, exact pass 1 and pass 2 at rk.max_kernel_t(), 4096; the
# field kernels at rk.max_field_kernel_t(), 2048 for the default pair and
# 792 for F8-128-128 beside 6-32-32-4), a launch reads U (kernel 2's warp
# form also its eps) in device memory.  Each form past its cap against its
# plain version by phase 17-18's rule, the lane forms bit for bit their
# solo instances, short drives with exact launches, and each form's time.
# The plain versions run their thousands of steps on the host's CPU, in
# HORIZON_WORKERS processes beside the card's work: each step is some tens
# of tiny operations, which the card launches one by one (about 2.5 ms a
# step at T=4100, against 0.8 ms on one CPU core).
HORIZON_T = 4100                 # past kMaxT: kernels 1, 2, pass 1, pass 2
HORIZON_FIELD_T = 2100           # past kMaxFieldT: kernel 3, field pass 1
HORIZON_PAIR_T = 800             # past F8-128-128's staged 792
HORIZON_PAIR = (8, 128, 128)
HORIZON_K = 256
HORIZON_LANES = 2
HORIZON_PREFIX = 100             # kernel 2's steps held against the staged run
HORIZON_TICKS = 3                # each drive
HORIZON_REPS = 5                 # the kernels line's CUDA-event runs
HORIZON_WORKERS = 6              # CPU processes for the plain versions
_PLAIN = {}                      # a worker's objects (``_plain_init``)


def _to_cpu(obj):
    """``obj`` with every tensor on the CPU (dicts, lists, tuples,
    dataclasses)."""
    import torch

    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_cpu(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_cpu(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _plain_init(payload: dict) -> None:
    """A plain-version worker: one thread, the phase's CPU objects."""
    import torch

    torch.set_num_threads(1)
    _PLAIN.update(payload)


def _plain_job(fn: str, args: tuple, kw: dict):
    """``rk.<fn>(*args, **kw)`` on the CPU, a string "@name" standing for
    the worker's object ``name``: (its result, ms on the host clock)."""
    from autorally_tpu_torch.ops import rollout_kernel as rk

    get = lambda a: (_PLAIN[a[1:]] if isinstance(a, str) and a[:1] == "@"
                     else a)
    args = tuple(get(a) for a in args)
    kw = {k: get(v) for k, v in kw.items()}
    t0 = time.perf_counter()
    out = getattr(rk, fn)(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e3


def horizon_inputs(T_: int, K_: int, dev, seed: int, L: int = 0):
    """A plan U (T_, 2) (or L of them, with L starts about the oval's
    start) whose steering wanders, and eps (T_, K_, 2), from ``seed``."""
    import torch
    from autorally_tpu_torch import drive_oval

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = max(L, 1)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(n, T_, 1)
    U[..., 0] = 0.2 * torch.randn((n, T_), generator=gen, device=dev)
    eps = torch.randn((T_, K_, 2), generator=gen, device=dev)
    state = torch.tensor(drive_oval.START, dtype=torch.float32,
                         device=dev).repeat(n, 1)
    state[:, :2] += 0.3 * torch.randn((n, 2), generator=gen, device=dev)
    state[:, 4] = torch.linspace(0.0, 3.0, n, device=dev)
    if not L:
        return state[0], U[0], eps
    return state, U, eps


def horizons_phase(drive_oval, rk, card, builds, dev=None) -> dict:
    """Phase 39: kernel 1 (MLP lane groups, BF), kernel 2 (warp form, MLP
    and BF, K=1 and K=256), exact pass 1 and pass 2 at T=4100; kernel 3
    and field pass 1 at T=2100 (default library) and at T=800 beside
    F8-128-128 (its library's staged cap is 792), on seeded fields; the
    lane forms of kernels 1 and 3 at L=2 past their caps.  Each fused form
    against its plain version: costs (COST_RTOL / COST_ATOL) and crash
    flags in every rollout along kernel 2's trajectories (field forms: all
    but 1 %: a field value within rounding of the 0.65 boundary can latch
    on one side only), u_seq bit for bit; against the whole plain version
    in all but 1 %.  Kernel 2: both geometries bit for bit, the first
    HORIZON_PREFIX steps bit for bit the staged launch's, u_seq bit for
    bit the plain chain's, and each step from its own previous state
    within STATE_RTOL / STATE_ATOL of the plain step (the whole plain
    chain's rounding drifts over thousands of steps: its distance is
    printed).  Pass 1 bit for bit kernel 1 / 3 fed its stream; pass 2
    within NUMER_RTOL of sum |w u|; each lane of a lane form bit for bit
    its solo instance and within the rule of its plain lane.  Then drives
    of HORIZON_TICKS ticks at each horizon with exact launches and no
    plain version, and each form timed (``builds``: phase 1's)."""
    import multiprocessing

    import torch
    from autorally_tpu_torch.config import lane_cost_params
    from autorally_tpu_torch.costs import MPPICost
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.solver.mppi import MPPISolver, effective_gamma
    from autorally_tpu_torch.tools.ab_builds import seeded_field
    from autorally_tpu_torch.tools.exact_variants import (
        forced_chain_geometry)

    dev = dev or torch.device("cuda", 0)
    kh = HORIZON_K
    solver, params, cp, costmap, _ = drive_oval.build(rollouts=kh,
                                                      device=dev)
    model, cfg = solver.model, solver.cfg
    bsolver, bparams, *_ = drive_oval.build(model="bf", rollouts=kh,
                                            device=dev)
    bmodel, bcfg = bsolver.model, bsolver.cfg
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    map_floats = costmap.height * costmap.width
    steps = {"MLP": mlp_flops(model.layers), "BF": BF_STEP_OPS}
    n_w = {"MLP": rk.KERNEL_NUM_WEIGHTS, "BF": rk.KERNEL_BF_WEIGHTS}
    nobs = torch.zeros((0, 3), device=dev)
    pair_lib, _ = builds.get(None, HORIZON_PAIR)
    fields = {"F8-64-64": seeded_field(costmap, dev, seed=39),
              _build.field_label(HORIZON_PAIR): seeded_field(
                  costmap, dev, seed=39, fspec=HORIZON_PAIR)}
    plabel = _build.field_label(HORIZON_PAIR)
    # the CPU's twins of the card's objects, for the plain versions
    csolver, _, _, ccostmap, _ = drive_oval.build(rollouts=kh, device="cpu")
    cbsolver, *_ = drive_oval.build(model="bf", rollouts=kh, device="cpu")
    payload = {"MLP": csolver.model, "MLP params": _to_cpu(params),
               "BF": cbsolver.model, "BF params": _to_cpu(bparams),
               "costmap": ccostmap, "cp": _to_cpu(cp),
               **{name: seeded_field(ccostmap, "cpu", seed=39,
                                     fspec=rk.field_spec(f))
                  for name, f in fields.items()}}
    pool = multiprocessing.get_context("spawn").Pool(
        HORIZON_WORKERS, initializer=_plain_init, initargs=(payload,))
    jobs = {}

    def submit(name, fn, *args, **kw):
        jobs[name] = pool.apply_async(_plain_job, (fn, _to_cpu(args),
                                                   _to_cpu(kw)))

    def result(name):
        out, ms = jobs.pop(name).get(timeout=600)
        return tuple(o.to(dev) if torch.is_tensor(o) else o
                     for o in out), ms

    caps = {"kernels 1, 2, pass 1, pass 2": rk.max_kernel_t(),
            "field kernels": rk.max_field_kernel_t(),
            "field lane forms": rk.max_field_kernel_t(lanes=True),
            f"field kernels beside {plabel}":
                rk.max_field_kernel_t(field=HORIZON_PAIR),
            f"field lane forms beside {plabel}":
                rk.max_field_kernel_t(field=HORIZON_PAIR, lanes=True)}
    print(f"[horizons] staged U up to {caps}; the library beside {plabel} "
          f"reports {pair_lib.artt_max_field_t()} / "
          f"{pair_lib.artt_max_field_lanes_t()} ({card})")
    check(caps["kernels 1, 2, pass 1, pass 2"] < HORIZON_T
          and caps["field lane forms"] < HORIZON_FIELD_T
          and pair_lib.artt_max_field_t() < HORIZON_PAIR_T,
          "horizons: a form's staged cap is not below its test horizon")
    for T_, fspec in ((HORIZON_FIELD_T, rk.FIELD_KERNEL_SPEC),
                      (HORIZON_PAIR_T, HORIZON_PAIR)):
        for lanes in (False, True):
            lay = rk.field_smem_layout(rk.KERNEL_LAYERS, T_, 0, fspec, lanes)
            print(f"[horizons] field {_build.field_label(fspec)} T={T_}"
                  f"{' lanes' if lanes else ''}: U {lay['u_layout']}, "
                  f"{lay['bytes']} bytes of shared memory a block")
            check(lay["u_layout"] == "global", "horizons: the layout does "
                  "not switch past the cap")

    # every input, and the plain versions' jobs, first
    Th, Tf = HORIZON_T, HORIZON_FIELD_T
    s0, U, eps = horizon_inputs(Th, kh, dev, seed=39)
    e1 = torch.zeros((Th, 1, 2), device=dev)
    cfgs = {"MLP": cfg.replace(num_rollouts=kh, num_timesteps=Th),
            "BF": bcfg.replace(num_rollouts=kh, num_timesteps=Th)}
    mods = {"MLP": (model, params), "BF": (bmodel, bparams)}
    for kind, c in cfgs.items():
        m = ("@" + kind, "@" + kind + " params")
        submit(f"chain {kind}", "dynamics_chain_plain", *m, c, s0, U, eps)
        submit(f"chain {kind} K=1", "dynamics_chain_plain", *m, c, s0, U, e1)
        submit(f"kernel 1 {kind}", "fused_rollout_cost_plain", *m, c, "@cp",
               "@costmap", s0, U, eps)
    cc = cfgs["MLP"].replace(kernel_rng=True)
    mlp = ("@MLP", "@MLP params")
    submit("pass 1", "fused_rng_costs_plain", *mlp, cc, "@cp", "@costmap",
           s0, U, key)
    fin = {}
    for Tx, name in ((Tf, "F8-64-64"), (HORIZON_PAIR_T, plabel)):
        fin[name] = horizon_inputs(Tx, kh, dev, seed=Tx)
        cf = cfg.replace(num_rollouts=kh, num_timesteps=Tx)
        s0f, Uf, ef = fin[name]
        submit(f"kernel 3 {name}", "fused_rollout_cost_plain", *mlp, cf,
               "@cp", "@" + name, s0f, Uf, ef)
        submit(f"field pass 1 {name}", "fused_rng_costs_plain", *mlp,
               cf.replace(kernel_rng=True), "@cp", "@" + name, s0f, Uf, key)
    L = HORIZON_LANES
    cpl = lane_cost_grid(L)
    lin = {}
    for kernel, Tl, surface in ((1, Th, "costmap"), (3, Tf, "F8-64-64")):
        lin[kernel] = horizon_inputs(Tl, kh, dev, seed=Tl + L, L=L)
        state, Ul, el = lin[kernel]
        submit(f"lanes {kernel}", "fused_rollout_cost_lanes_plain", *mlp,
               cfg.replace(num_rollouts=kh, num_timesteps=Tl), cpl,
               "@" + surface, state, Ul, el)
    rowargs, results = [], {}

    def along(name, m, c, surface, U_, e_, states):
        """The plain cost along kernel 2's trajectories ``states``."""
        submit(name, "trajectory_cost_plain", "@" + m, "@" + m + " params",
               c, "@cp", "@" + surface, U_, e_, states)

    def held(tag, out, k, plain, along_out, along_limit=0, bits=None):
        """A fused form's outputs against its plain version's (see the
        docstring); returns the max cost error."""
        kc, kx = out[0], out[-1]
        err = agreement(tag, "against the plain version", kc, kx, plain[0],
                        plain[2], k, limit=k // 100)
        bc, bx = along_out
        err = agreement(tag, "along kernel 2's trajectories", kc, kx, bc, bx,
                        k, limit=along_limit)
        if len(out) == 3:
            check(bit_equal(out[1], plain[1]), f"{tag}: u_seq differs from "
                  "its plain version's")
        if bits is not None:
            same = bit_equal(kc, bits[0]) and bit_equal(kx, bits[-1])
            print(f"[{tag}] bit for bit the eps-reading kernel fed its "
                  f"stream: {same} ({card})")
            check(same, f"{tag}: pass 1 differs from the eps-reading kernel "
                  "fed its stream")
        print(f"[{tag}] crash {int(kx.sum().item())}/{k} ({card})")
        return err

    def chain_run(m, p, c, s0_, U_, e_):
        """Kernel 2 (not counted): its launch and (states, u_seq)."""
        launch, out = rk.prepare_dynamics_chain(m, p, c, s0_, U_, e_)
        launch()
        return launch, out

    try:
        # (a) T=4100: kernel 2 (MLP, BF; K=256 and 1), kernel 1, pass 1, 2
        chains = {}
        for kind, c in cfgs.items():
            m, p = mods[kind]
            for kk, e in ((kh, eps), (1, e1)):
                tag = f"horizons (a) kernel 2 {kind} T={Th} K={kk}"
                launch, (ks, ku) = chain_run(m, p, c, s0, U, e)
                chains[kind, kk] = (launch, ks, ku)
                same = []
                for geom in rk.CHAIN_GEOMETRIES:
                    with forced_chain_geometry(*geom[:2]):
                        _, (os_, ou) = chain_run(m, p, c, s0, U, e)
                    same.append(bit_equal(ks, os_) and bit_equal(ku, ou))
                n = HORIZON_PREFIX
                _, (ss, su) = chain_run(m, p, c, s0, U[:n].contiguous(),
                                        e[:n].contiguous())
                prefix = (bit_equal(ks[:, :n].contiguous(), ss)
                          and bit_equal(ku[:, :n].contiguous(), su))
                # each step from the kernel's own previous state, plainly
                prev = torch.cat([s0[:, None].expand(-1, kk)[:, None],
                                  ks[:, :-1]], 1).reshape(7, -1).T
                u_cl = m.enforce_constraints(p, ku.reshape(2, -1).T)
                step = prev + rk.kernel_state_deriv(
                    m, p, prev, u_cl, "highest", False) * m.dt
                step = step.T.reshape(ks.shape)
                e_step = (ks - step).abs().max().item()
                close = torch.allclose(ks, step, rtol=STATE_RTOL,
                                       atol=STATE_ATOL, equal_nan=True)
                print(f"[{tag}] {launch.name} in "
                      f"{geometry_label(launch.geometry)}: every geometry bit"
                      f" for bit: {same}; the first {n} steps bit for bit "
                      f"the staged launch's: {prefix}; each step against "
                      f"the plain step from its own state: max err "
                      f"{e_step:.3e} ({card})")
                check(all(same), f"{tag}: a geometry differs")
                check(prefix, f"{tag}: the first {n} steps differ from the "
                      "staged launch's")
                check(close, f"{tag}: a step differs from the plain step")
                if kk == kh:
                    along(f"along kernel 1 {kind}", kind, c, "costmap", U,
                          eps, ks)
        # pass 1's stream and kernel 2's trajectories on it
        launch_1, (kc1, kx1), ctx = rk.prepare_fused_rng_costs(
            model, params, cc, cp, costmap, s0, U, key)
        launch_1()
        e_stream = rk.rng_noise(ctx)
        one, bits1 = rk.prepare_fused_exact_rollout_cost(
            model, params, cfgs["MLP"], cp, costmap, s0, U, e_stream)
        one()
        _, (ks1, _) = chain_run(model, params, cfgs["MLP"], s0, U, e_stream)
        along("along pass 1", "MLP", cfgs["MLP"], "costmap", U, e_stream,
              ks1)
        del ks1
        launch1 = {}
        for kind, c in cfgs.items():
            m, p = mods[kind]
            launch1[kind] = rk.prepare_fused_exact_rollout_cost(
                m, p, c, cp, costmap, s0, U, eps)
            launch1[kind][0]()
        # (b) the field forms: the default pair at T=2100, F8-128-128 at 800
        launch3 = {}
        for name, fld in fields.items():
            s0f, Uf, ef = fin[name]
            cf = cfg.replace(num_rollouts=kh, num_timesteps=Uf.shape[0])
            launch3[name] = rk.prepare_fused_rollout_cost(
                model, params, cf, cp, fld, s0f, Uf, ef)
            launch3[name][0]()
            _, (ksf, _) = chain_run(model, params, cf, s0f, Uf, ef)
            along(f"along kernel 3 {name}", "MLP", cf, name, Uf, ef, ksf)
            l4, out4, ctx4 = rk.prepare_fused_rng_costs(
                model, params, cf.replace(kernel_rng=True), cp, fld, s0f, Uf,
                key)
            l4()
            ef4 = rk.rng_noise(ctx4)
            one, bits4 = rk.prepare_fused_rollout_cost(
                model, params, cf, cp, fld, s0f, Uf, ef4)
            one()
            _, (ksf4, _) = chain_run(model, params, cf, s0f, Uf, ef4)
            along(f"along field pass 1 {name}", "MLP", cf, name, Uf, ef4,
                  ksf4)
            launch3[name + " pass 1"] = (l4, out4, bits4)
            del ksf, ksf4
        # (c) the lane forms; each lane bit for bit its solo instance
        lanes_cp = lane_cost_params(cpl)
        lane_out = {}
        for kernel, (state, Ul, el) in lin.items():
            surface = costmap if kernel == 1 else fields["F8-64-64"]
            cl = cfg.replace(num_rollouts=kh, num_timesteps=Ul.shape[1])
            prep = (rk.prepare_fused_exact_rollout_cost_lanes if kernel == 1
                    else rk.prepare_fused_rollout_cost_lanes)
            solo = (rk.prepare_fused_exact_rollout_cost if kernel == 1
                    else rk.prepare_fused_rollout_cost)
            launch, out = prep(model, params, cl, cpl, surface, state, Ul, el)
            launch()
            same = []
            for i in range(L):
                one, o = solo(model, params, cl, lanes_cp[i], surface,
                              state[i], Ul[i], el)
                one()
                same.append(all(bit_equal(a[i], b) for a, b in zip(out, o)))
            tag = f"horizons (c) lanes kernel {kernel} L={L} T={Ul.shape[1]}"
            print(f"[{tag}] {launch.name} in "
                  f"{geometry_label(launch.geometry)}: each lane bit for bit"
                  f" its solo instance: {same} ({card})")
            check(all(same), f"{tag}: a lane differs from its solo instance")
            lane_out[kernel] = (launch, out)
        # pass 2 on pass 1's weights, on the card (a few hundred ms)
        w = torch.exp(-effective_gamma(cc, cp) * (kc1 - kc1.min()))
        launch_2, partials = rk.prepare_fused_rng_numer(ctx, w)
        launch_2()
        kn = partials.sum(0)
        pn, plain_2 = plain_timed(lambda: rk.fused_rng_numer_plain(ctx, w))
        scale = torch.einsum("k,ctk->ct", w.abs(), bits1[1].abs())
        torch.cuda.synchronize()
        err_2 = (kn - pn).abs()
        rel = (err_2 / scale.clamp(min=1e-30)).max().item()
        print(f"[horizons (a) pass 2 T={Th} K={kh}] fused_rng_numer: max|numer"
              f" err| {err_2.max().item():.3e}, max err / sum|w u| {rel:.3e}"
              f" (limit {NUMER_RTOL}) ({card})")
        check(bool((err_2 <= NUMER_RTOL * scale).all()), "horizons pass 2: "
              f"numerator differs beyond {NUMER_RTOL} of sum|w u|")
        launch_2.name = "fused_rng_numer"
        k_need = int((w != 0).sum().item())
        nb2 = 4 * (kh + Th * 2 + partials.numel()) + 16
        rowargs.append(((5, "exact", Th, kh), launch_2, plain_2,
                        err_2.max().item(), (bound(nb2, (STREAM_OPS
                                                         + UPDATE_OPS)
                                                   * k_need * Th), None),
                        1346, dict(T=Th, K=kh)))

        # the plain versions' results
        for kind, c in cfgs.items():
            for kk in (kh, 1):
                launch, ks, ku = chains[kind, kk]
                (ps, pu), plain_ms = result(f"chain {kind}"
                                            + ("" if kk == kh else " K=1"))
                fin_ = torch.isfinite(ps)
                e_s = (ks[fin_] - ps[fin_]).abs().max().item()
                print(f"[horizons (a) kernel 2 {kind} T={Th} K={kk}] the "
                      f"whole plain chain ({plain_ms:.0f} ms on one CPU "
                      f"core): max|state err| {e_s:.3e} (rounding drift over "
                      f"{Th} steps, not gated), u_seq bit for bit: "
                      f"{bit_equal(ku, pu)}")
                check(bit_equal(ku, pu), f"horizons kernel 2 {kind} K={kk}: "
                      "u_seq differs from the plain chain's")
                nb = 4 * (Th * 2 * kk + 7 * Th * kk + 2 * Th * kk + Th * 2
                          + n_w[kind] + 7 + 4)
                rowargs.append(((2, kind, Th, kk), launch, plain_ms, e_s,
                                (bound(nb, steps[kind] * Th * kk), None), 389,
                                dict(T=Th, K=kk, plain_device="cpu")))
            plain, plain_ms = result(f"kernel 1 {kind}")
            launch, out = launch1[kind]
            err = held(f"horizons (a) kernel 1 {kind} T={Th} K={kh}", out, kh,
                       plain, result(f"along kernel 1 {kind}")[0])
            rowargs.append(((1, kind, Th, kh), launch, plain_ms, err,
                            fused_circle_bound(kh, n_w[kind], steps[kind],
                                               nobs, map_floats=map_floats,
                                               T_=Th),
                            1013, dict(T=Th, K=kh, plain_device="cpu")))
        (pc1, px1, _), plain_1 = result("pass 1")
        err_1 = held(f"horizons (a) pass 1 gaussian T={Th} K={kh}",
                     (kc1, kx1), kh, (pc1, None, px1),
                     result("along pass 1")[0], bits=bits1)
        rowargs.append(((4, "exact", Th, kh), launch_1, plain_1, err_1,
                        fused_circle_bound(kh, n_w["MLP"], steps["MLP"], nobs,
                                           map_floats=map_floats, stream=True,
                                           T_=Th), 1221,
                        dict(T=Th, K=kh, plain_device="cpu")))
        for name, fld in fields.items():
            Tx = fin[name][1].shape[0]
            launch, out = launch3[name]
            plain, plain_ms = result(f"kernel 3 {name}")
            err = held(f"horizons (b) kernel 3 {name} T={Tx} K={kh}", out, kh,
                       plain, result(f"along kernel 3 {name}")[0],
                       along_limit=kh // 100)
            rowargs.append(((3, name, Tx, kh), launch, plain_ms, err,
                            fused_circle_bound(kh, n_w["MLP"], steps["MLP"],
                                               nobs, fld, T_=Tx), 606,
                            dict(T=Tx, K=kh, field=name, plain_device="cpu")))
            l4, out4, bits4 = launch3[name + " pass 1"]
            (pc4, px4, _), plain_ms = result(f"field pass 1 {name}")
            err = held(f"horizons (b) field pass 1 {name} T={Tx} K={kh}",
                       out4, kh, (pc4, None, px4),
                       result(f"along field pass 1 {name}")[0],
                       along_limit=kh // 100, bits=bits4)
            rowargs.append(((4, name, Tx, kh), l4, plain_ms, err,
                            fused_circle_bound(kh, n_w["MLP"], steps["MLP"],
                                               nobs, fld, stream=True, T_=Tx),
                            1221,
                            dict(T=Tx, K=kh, field=name, plain_device="cpu")))
        for kernel, (launch, out) in lane_out.items():
            Tl = lin[kernel][1].shape[1]
            (pc, pu, px), plain_ms = result(f"lanes {kernel}")
            tag = f"horizons (c) lanes kernel {kernel} L={L} T={Tl} K={kh}"
            err = max(agreement(tag, f"lane {i}", out[0][i], out[2][i], pc[i],
                                px[i], kh, limit=kh // 100) for i in range(L))
            check(bit_equal(out[1], pu), f"{tag}: u_seq differs from its "
                  "plain version's")
            rowargs.append((
                (kernel, "lanes", Tl, kh), launch, plain_ms, err,
                fused_circle_bound(kh, n_w["MLP"], steps["MLP"], nobs,
                                   None if kernel == 1
                                   else fields["F8-64-64"], map_floats,
                                   lanes=L, T_=Tl),
                1013 if kernel == 1 else 606,
                dict(T=Tl, K=kh, lanes=L, plain_device="cpu")))
    finally:
        pool.terminate()
        pool.join()

    # (d) drives at each horizon: exact launches a solve, no plain version
    fl = "_" + plabel
    drives = {
        "MLP T=4100": (model, params, cfg, costmap, Th, False,
                       {"fused_exact_rollout_cost": 1, "dynamics_chain": 1},
                       [(1, "MLP", Th, kh), (2, "MLP", Th, 1)]),
        "BF T=4100": (bmodel, bparams, bcfg, costmap, Th, False,
                      {"fused_exact_rollout_cost_bf": 1,
                       "dynamics_chain_bf": 1},
                      [(1, "BF", Th, kh), (2, "BF", Th, 1)]),
        "capacity T=4100": (model, params, cfg, costmap, Th, True,
                            {"fused_rng_costs": 1, "fused_rng_numer": 1,
                             "dynamics_chain": 1},
                            [(4, "exact", Th, kh), (5, "exact", Th, kh)]),
        "field T=2100": (model, params, cfg, fields["F8-64-64"], Tf, False,
                         {"fused_rollout_cost": 1, "dynamics_chain": 1},
                         [(3, "F8-64-64", Tf, kh)]),
        "field capacity T=2100": (model, params, cfg, fields["F8-64-64"], Tf,
                                  True, {"fused_rng_costs_field": 1,
                                         "fused_rng_numer": 1,
                                         "dynamics_chain": 1},
                                  [(4, "F8-64-64", Tf, kh)]),
        f"{plabel} T=800": (model, params, cfg, fields[plabel],
                            HORIZON_PAIR_T, False,
                            {f"fused_rollout_cost{fl}": 1,
                             "dynamics_chain": 1},
                            [(3, plabel, HORIZON_PAIR_T, kh)]),
        f"{plabel} capacity T=800": (model, params, cfg, fields[plabel],
                                     HORIZON_PAIR_T, True,
                                     {f"fused_rng_costs_field{fl}": 1,
                                      "fused_rng_numer": 1,
                                      "dynamics_chain": 1},
                                     [(4, plabel, HORIZON_PAIR_T, kh)]),
    }
    launches = {}
    first = {1: "fused_exact", 2: "dynamics_chain", 3: "fused_rollout",
             4: "fused_rng_costs", 5: "fused_rng_numer"}
    for name, (m, p, c, surface, T_, rng, per_solve, keys) in drives.items():
        s = MPPISolver(m, MPPICost(), c.replace(
            num_rollouts=kh, num_timesteps=T_, kernel_rng=rng), device=dev)
        latency, got, _ = drive_counted(drive_oval, rk, f"horizons (d) {name}",
                                        s, p, cp, surface, HORIZON_TICKS,
                                        per_solve, card)
        results[name] = {"latency": latency, "launches": got}
        for k in keys:
            fused = next(n for n in per_solve if n.startswith(first[k[0]]))
            launches[k] = got.get(fused, 0)

    # the kernels line: each form timed at its shape
    rows = [many_row(launch.name, launch, HORIZON_REPS, plain_ms, err, bnd,
                     launches.get(row_key, 0), card, line, **extra)
            for row_key, launch, plain_ms, err, bnd, line, extra in rowargs]
    results["caps"] = caps
    return {"results": results, "rows": rows}

# -- phase 37: the operator's run ------------------------------------------
OP_TICKS = 200
OP_RUNSTOP = (80, 120)     # held by a datagram each tick from 80, released
OP_PUSH = 100              # the model push over the wire
OP_CONSOLE_S = 5           # the console's seconds from its first record
OP_ASYNC_TICKS = 50        # (b): the entry point with the async loop
OP_KINDS = {"run", "solve", "timing", "diag", "system", "lap", "image"}


def free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_bound(port: int, proc, timeout: float = 120.0) -> None:
    """Wait until ``proc`` holds UDP ``port`` (a probe can no longer bind
    it)."""
    import socket

    deadline = time.time() + timeout
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
            try:
                probe.bind(("127.0.0.1", port))
            except OSError:
                return
        check(proc.poll() is None, f"the console exited ({proc.returncode})")
        check(time.time() < deadline, "the console never bound its port")
        time.sleep(0.05)


def wait_until(pred, what: str, timeout: float = 5.0) -> None:
    deadline = time.time() + timeout
    while not pred():
        check(time.time() < deadline, what)
        time.sleep(0.001)


def operator_phase(run_tube_mppi, rk, card, plain_tick, dev=None) -> dict:
    """Phase 37: the operator's run.  BASELINE #1's tube as phase 20 builds
    it (K=1920, T=100, the seeded 6-32-32-4 MLP, DDP gains), 200 lockstep
    ticks with every option of ``run_tube_mppi`` on (``OperatorIO``: a UDP
    telemetry port, a runstop port bound to 0, a JSONL log, the scene
    camera) and ``tools/console.py --duration`` attached in a subprocess;
    a runstop over UDP at tick 80, held each tick, released at 120; the
    actual controller's weights pushed at tick 100 through the wire
    (``msgs.encode`` -> ``decode`` -> ``params_from_model_msg`` ->
    ``update_model_params``), the next solve's kernel-1 outputs bit for bit
    a solve on the weights given directly with the same noise; the log's
    records, the console's frames and log, exactly 2 + 2 launches a tick
    as in phase 20, no plain version; the tick's p50 / p99 beside phase
    20's (``plain_tick``), reported against 20 ms and not gated."""
    import tempfile

    import torch

    from autorally_tpu_torch import msgs
    from autorally_tpu_torch.runtime.telemetry import LapStats
    from autorally_tpu_torch.runtime.telemetry_bus import send_runstop

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else dev
    port = free_udp_port()
    tmp = tempfile.mkdtemp(prefix="operator_run_")
    log, clog = os.path.join(tmp, "run.jsonl"), os.path.join(tmp, "con.jsonl")
    cout_path = os.path.join(tmp, "console.out")
    with open(cout_path, "w") as cout:
        console = subprocess.Popen(
            [sys.executable, "-m", "autorally_tpu_torch.tools.console",
             "--port", str(port), "--duration", str(OP_CONSOLE_S),
             "--wait-data", "120", "--log", clog, "--no-color"],
            cwd=HERE, stdout=cout, stderr=subprocess.STDOUT)
    op = None
    try:
        tube = run_tube_mppi.build(ticks=OP_TICKS, device=dev)
        actual, plant = tube.actual, tube.plant
        solver = actual.solver
        wait_bound(port, console)
        op = run_tube_mppi.OperatorIO(tube, telemetry_port=port,
                                      runstop_port=0, log=log, camera=True)
        # the operator's host time a tick, its camera's and the status
        # probes' (once a wall second)
        op_ms = {"operator": [], "camera": [], "status": []}
        op.on_tick = _timed(op.on_tick, op_ms["operator"])
        op._camera_tick = _timed(op._camera_tick, op_ms["camera"])
        op.sysmon.sample = _timed(op.sysmon.sample, op_ms["status"])
        direct = actual.model_params
        pushed, seen, pubs = {}, {}, []
        rollout_costs, publish = solver.rollout_costs, plant.publish_control

        def recorded_costs(params, *a, **kw):
            out = rollout_costs(params, *a, **kw)
            if params is pushed.get("params") and "args" not in seen:
                # the first solve on the pushed weights: its inputs and
                # outputs, copied (the next solves reuse their buffers)
                keep = lambda x: x.clone() if torch.is_tensor(x) else x
                seen["args"] = [keep(x) for x in a]
                seen["kw"] = {k: keep(v) for k, v in kw.items()}
                seen["out"] = [keep(x) for x in out]
            return out

        def recorded_publish(t, steering, throttle):
            out = publish(t, steering, throttle)
            pubs.append((plant.runstop, throttle, out[1]))
            return out

        def on_tick(i, chosen, used, state):
            if i == OP_PUSH:
                wire = msgs.encode(msgs.model_msg_from_params(
                    actual.model_params, stamp=plant.sim_time))
                pushed["bytes"] = len(wire)
                pushed["params"] = msgs.params_from_model_msg(
                    msgs.decode(wire), control_ranges=tube.cfg.control_ranges,
                    device=dev)
                actual.update_model_params(pushed["params"])
            if OP_RUNSTOP[0] <= i < OP_RUNSTOP[1]:
                send_runstop(op.runstop.port, "ocs", False)
                wait_until(lambda: plant.runstop, "runstop not applied")
            elif i == OP_RUNSTOP[1]:
                send_runstop(op.runstop.port, "ocs", True)
                wait_until(lambda: not plant.runstop, "runstop not released")

        solver.rollout_costs = recorded_costs
        plant.publish_control = recorded_publish
        rk.LAUNCHES.clear()
        with PlainCalls(rk) as plain:
            out = run_tube_mppi.drive(tube, log=lambda m: print(f"[op] {m}"),
                                      on_tick=on_tick, operator=op)
        got = dict(rk.LAUNCHES)
        del solver.rollout_costs, plant.publish_control
        # a lap: the seeded car covers a few metres in 200 ticks, so lap
        # statistics on the run's start line (x in 25-35 at y = 0) take two
        # turns of a circle of radius 30 m at 6 m/s, and the operator
        # publishes the lap they complete
        laps = LapStats(line=run_tube_mppi.LAP_LINE)
        for k in range(1, 2 * 1571 + 10):
            th = 2 * np.pi * k / 1571
            rec = laps.process_pose(0.02 * k, 30 * np.cos(th),
                                    30 * np.sin(th), 6.0, 0.0)
            if rec:
                op.publish_lap(rec)
        op.close()
        op_closed, op = op, None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stdout_tail = ""
        try:
            console.wait(timeout=120)
        finally:
            with open(cout_path) as f:
                stdout_tail = f.read()
        check(console.returncode == 0,
              f"the console exited {console.returncode}")
    finally:
        if op is not None:
            op.close()
        if console.poll() is None:
            console.kill()
            console.wait()

    # the wire-pushed weights' solve against the direct weights' solve
    check("args" in seen, "no solve ran on the wire-pushed weights")
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    with open(clog) as f:
        crecs = [json.loads(line) for line in f]

    ref = rollout_costs(direct, *seen["args"], **seen["kw"])
    same_push = all(bit_equal(a, b) for a, b in zip(seen["out"], ref))
    same_params = all(torch.equal(a, b) for k in ("weights", "biases")
                      for a, b in zip(direct[k], pushed["params"][k]))
    # the run log, the console's log and frames
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    solves = [r["tick"] for r in recs if r["kind"] == "solve"]
    system = next(r for r in recs if r["kind"] == "system")
    card_name = card.split(",")[0].strip()
    sys_kind = system["accelerator"]["devices"][0]["kind"]
    images = kinds.get("image", 0)
    span = OP_TICKS * tube.cfg.dt
    rate = images / span
    ckinds = {r["kind"] for r in crecs}
    rendered = all(s in stdout_tail for s in ("speed=", "diagnostics",
                                              "camera  msv="))
    # the runstop: engaged for the controls published after ticks 80-119
    held = [k for k, (engaged, _, _) in enumerate(pubs) if engaged]
    cut_right = all(p == (min(a, 0.0) if e else a) for e, a, p in pubs)
    cut_positive = sum(1 for e, a, _ in pubs if e and a > 0.0)
    timing = out["timing"]
    tick_ms = np.array(timing.tick_samples_ms)
    tick = (float(np.percentile(tick_ms, 50)),
            float(np.percentile(tick_ms, 99)))
    want = {"fused_exact_rollout_cost": 2 * OP_TICKS,
            "dynamics_chain": 2 * OP_TICKS}
    secs = time.perf_counter() - t0
    print(f"[operator] K={tube.cfg.num_rollouts} {OP_TICKS} ticks with "
          f"--telemetry-port --runstop-port 0 --log --camera: arbitration "
          f"{out['used']}; launches {got}; plain-version calls {plain.calls};"
          f" final u_x {plant.true_state[4]:.3f} m/s ({card})")
    print(f"[operator] log records {kinds}; solve ticks 1-{OP_TICKS} "
          f"{solves == list(range(1, OP_TICKS + 1))}; the system record's "
          f"card {sys_kind!r} (nvidia-smi {card_name!r}); {images} images "
          f"in {span:.2f} s of the plant's clock ({rate:.2f} Hz; the "
          f"republisher forwarded {op_closed.republisher.forwarded}, dropped "
          f"{op_closed.republisher.dropped}); the console rendered "
          f"{rendered} and logged {len(crecs)} records of {sorted(ckinds)}")
    print(f"[operator] runstop over UDP at tick {OP_RUNSTOP[0]}, released "
          f"at {OP_RUNSTOP[1]}: engaged for publications {held[0]}-"
          f"{held[-1]} ({len(held)}), each the requested throttle cut to "
          f"at most 0 {cut_right} ({cut_positive} positive requests cut)")
    print(f"[operator] model push at tick {OP_PUSH} over the wire "
          f"({pushed['bytes']} bytes): the weights bit for bit "
          f"{same_params}; the next solve's kernel-1 costs, u_seq and crash "
          f"flags bit for bit a solve on the weights given directly with "
          f"the same noise {same_push}")
    pct = lambda a: (float(np.percentile(a, 50)), float(np.percentile(a, 99)))
    host = {k: pct(v) for k, v in op_ms.items() if v}
    less = pct(tick_ms - np.array(op_ms["operator"][:OP_TICKS]))
    print(f"[operator] tick p50 / p99 {tick[0]:.3f} / {tick[1]:.3f} ms with "
          f"every option on, phase 20's plain tube {plain_tick[0]:.3f} / "
          f"{plain_tick[1]:.3f} ms (host clock; 20 ms reported, not gated; "
          f"{card}); phase 37 in {secs:.1f}s")
    print(f"[operator] host ms p50 / p99 in the tick: the operator's on_tick "
          f"{host['operator'][0]:.3f} / {host['operator'][1]:.3f}, its camera "
          f"{host['camera'][0]:.3f} / {host['camera'][1]:.3f}, the status "
          f"probes {len(op_ms['status'])} x {max(op_ms['status']):.3f} max; "
          f"the tick less the operator's on_tick {less[0]:.3f} / "
          f"{less[1]:.3f}")
    check(got == want, f"operator: launches {got}, expected {want}")
    check(not any(plain.calls.values()), f"operator: a plain version ran "
          f"on the card: {plain.calls}")
    check(set(kinds) == OP_KINDS, f"operator: record kinds {sorted(kinds)}")
    check(solves == list(range(1, OP_TICKS + 1)),
          "operator: not one solve record a tick")
    check(kinds["timing"] >= 2, "operator: no final timing record")
    check(system["accelerator"]["platform"] == "gpu"
          and sys_kind == card_name, f"operator: the system record names "
          f"{sys_kind!r}, nvidia-smi {card_name!r}")
    check(abs(rate - 5.0) <= 0.5, f"operator: images at {rate:.2f} Hz")
    check(rendered and OP_KINDS - {"lap"} <= ckinds,
          "operator: the console did not render or log the run")
    check(held == list(range(OP_RUNSTOP[0] - 1, OP_RUNSTOP[1] - 1))
          and cut_right, f"operator: runstop engaged for {held}")
    check(same_params and same_push, "operator: the wire-pushed weights' "
          "solve differs from the direct weights'")

    # (b) the same options through the entry point, on the card by default,
    # with the async loop (its launches a replayed tick are phase 22's)
    t1 = time.perf_counter()
    alog = os.path.join(tmp, "async.jsonl")
    argv = ["--ticks", str(OP_ASYNC_TICKS), "--async-loop", "--depth", "2",
            "--telemetry-port", str(free_udp_port()), "--runstop-port", "0",
            "--log", alog, "--camera"]
    printed = io.StringIO()
    with PlainCalls(rk) as aplain, contextlib.redirect_stdout(printed):
        run_tube_mppi.main(argv)
    with open(alog) as f:
        akinds = [json.loads(line)["kind"] for line in f]
    shutil.rmtree(tmp, ignore_errors=True)
    asolves = akinds.count("solve")
    aimages = akinds.count("image") / (OP_ASYNC_TICKS * tube.cfg.dt)
    print(f"[operator] (b) python -m autorally_tpu_torch.run_tube_mppi "
          f"{' '.join(argv)}: {asolves} solve records, kinds "
          f"{sorted(set(akinds))}, images {aimages:.2f} Hz of the plant's "
          f"clock, plain-version calls {aplain.calls}; " + "; ".join(
              ln for ln in printed.getvalue().splitlines()
              if ln.startswith(("timing:", "laps:")))
          + f" ({time.perf_counter() - t1:.1f}s; {card})")
    check(set(akinds) == OP_KINDS - {"lap"} and asolves >= OP_ASYNC_TICKS - 2,
          f"operator (b): records {sorted(set(akinds))}, {asolves} solves")
    check(abs(aimages - 5.0) <= 0.5, f"operator (b): images {aimages:.2f} Hz")
    check(not any(aplain.calls.values()), f"operator (b): a plain version "
          f"ran on the card: {aplain.calls}")
    return {"tick_ms_p50_p99": tick, "plain_tick_ms_p50_p99": plain_tick,
            "operator_host_ms_p50_p99": host,
            "tick_less_operator_ms_p50_p99": less, "kinds": kinds,
            "images_hz": rate, "seconds": secs, "launches": got,
            "async_solve_records": asolves}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import autorally_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: autorally_tpu_torch not found beside "
              f"chip_smoke.py ({e})", file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(autorally_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: autorally_tpu_torch imported from {pkg_dir}, "
              "not from beside chip_smoke.py", file=sys.stderr)
        return 1

    from autorally_tpu_torch import drive_oval
    from autorally_tpu_torch.ops import _build
    from autorally_tpu_torch.ops import rollout_kernel as rk

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    results = {}

    # -- phase 1: build ------------------------------------------------------
    # the default library and the other specs' (phase 28), one nvcc each,
    # all started together; the other specs' are checked when phase 28
    # takes them
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what):
        """Prints the time since the last lap and since the start."""
        now = time.perf_counter()
        print(f"[time] {what} in {now - laps[-1]:.1f}s, "
              f"{now - t_start:.1f}s into the run ({card})")
        laps.append(now)

    builds = Builds()
    # while the default library builds, the work of later phases that runs
    # none of its kernels: phases 11 and 30's fields, phase 32 (a)-(b)
    for fit_kwargs in (None, FIT_KWARGS):
        fitted_field(drive_oval, dev, fit_kwargs)
    physics_sim = physics_sim_phase(card, dev)
    lap("phase 32 (a)-(b) and the fields' fits, while the default library "
        "built")
    lib, build_s = builds.get(None)
    if lib.build is None:
        print(f"[build] {_build.library_path().name} was already built")
    else:
        print(f"[build] {_build.SOURCE.name}: nvcc {lib.build[0]:.1f}s")
        for line in lib.build[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        report = ptxas_report(lib.build[1])
        for name, regs, spill in report:
            print(f"[build] {name}: {regs} registers, {spill} bytes of "
                  f"spill stores and loads")
        # kernels 1-4 in an MLP and a BF instance each (4 fused, 1 chain;
        # BF exact pass 1 is fused_rng_bf_kernel), pass 2, kernel 1 in its
        # lane groups (the MLP), kernel 2 one rollout a warp (MLP and BF),
        # the constant quotients' check (phase 19), the lane forms of
        # kernels 1 and 2 in each of their geometries (phase 33), kernel
        # 3's (phase 34) and both capacity passes' (phase 35)
        n_kernels = (11 + len(rk.LANE_GROUPS) + 2 + 1 + len(LANE_INSTANCES)
                     + len(FIELD_LANE_INSTANCES) + len(CAP_LANE_INSTANCES))
        check(len(report) == n_kernels, f"ptxas reported {len(report)} "
              f"kernels, expected {n_kernels}")
        check(all(spill == 0 for _, _, spill in report), "a kernel spills")
        PTXAS.update((name, regs) for name, regs, _ in report)
    print(f"[build] total {build_s:.1f}s ({card})")
    # the field kernels: resources at the main path's T, and their SASS
    field_instances(rk, "build")
    SASS.append(library_sass())
    hmma = check_field_sass(SASS[0])
    print(f"[build] TF32 HMMA instructions in the field kernels' SASS: "
          f"{hmma}")
    check(len(hmma) == 4 and all(n > 0 for n in hmma.values()),
          "the four field kernel instances do not all hold TF32 HMMA")

    lap("phase 1")

    # -- shared inputs: the drive_oval configuration -------------------------
    solver, params, cost_params, costmap, note = drive_oval.build(
        rollouts=K, device=dev)
    cfg, model = solver.cfg, solver.model
    print(f"[setup] K={K} T={T} layers={model.layers} map "
          f"{costmap.height}x{costmap.width}; {note}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eps = torch.randn((T, K, 2), generator=gen, device=dev)
    U = torch.tensor([0.0, 0.3], device=dev).repeat(T, 1)
    start = torch.tensor(drive_oval.START, dtype=torch.float32, device=dev)
    nan_start = start.clone()
    nan_start[0] = float("nan")
    # wide swarm: exploration std x4 from a start at 6 m/s heading off the
    # map's right edge, so the lookups also clamp at the border
    edge_start = torch.tensor([37.0, 0.0, 0.3, 0.0, 6.0, 0.0, 0.0],
                              device=dev)
    slow_start = start.clone()
    slow_start[4] = 1.0
    wide = cfg.replace(steering_std=4 * cfg.steering_std,
                       throttle_std=4 * cfg.throttle_std)
    cases = {
        "nominal": (cfg, start, costmap),
        "wide_swarm": (wide, edge_start, costmap),
        "nan_x": (cfg, nan_start, costmap),
        # 2 cm texels of random cost: crash flags differ between rollouts
        # and a texel index off by one changes a cost
        "random_map": (wide, slow_start, random_costmap(dev)),
    }

    # -- phase 2: kernel A against its plain version -------------------------
    # On the random map the plain version's trajectories differ from the
    # kernel's by fp32 rounding (another summation order in the MLP), which
    # moves a few of the ~380k lookups across a 2 cm texel edge.  There
    # kernel A is held against the plain cost along kernel B's trajectories
    # (the same chain code), which isolates its cost and lookup arithmetic;
    # at most 1 % of the rollouts may differ from the whole plain version.
    # Every geometry that the launcher picks for some K (lane groups, one
    # or two rollouts a thread) runs each case, and also a K that is a
    # multiple of neither a block nor a warp and a shard's slice
    # (k_offset != 0); each bit for bit equal to the first.
    geoms = launcher_geometries(rk, bf=False)
    bf_geoms = launcher_geometries(rk, bf=True)
    print(f"[geometry] the launcher picks {[geometry_label(g) for g in geoms]}"
          f" (MLP), {[geometry_label(g) for g in bf_geoms]} (BF); at K={K} "
          f"{geometry_label(geoms[0])}, at K={KB} (BF) "
          f"{geometry_label(bf_geoms[0])}")
    err_a = 0.0
    eps_r = torch.randn((T, K + 1, 2), generator=gen, device=dev)
    shard_a = (K // 3 + 61, K - K // 3 - 61)  # (k_offset, K_local): 701
    a_cases = dict(cases, ragged_K=(cfg, start, costmap),
                   shard=(cfg, start, costmap))
    for name, (ccfg, s0, cmap) in a_cases.items():
        e, kw = {"ragged_K": (eps_r, {}),
                 "shard": (eps[:, shard_a[0]:].contiguous(),
                           dict(k_offset=shard_a[0]))}.get(name, (eps, {}))
        k_n = e.shape[1]
        pc, pu, px = rk.fused_rollout_cost_plain(
            model, params, ccfg, cost_params, cmap, s0, U, e, **kw)
        note = ""
        if name == "random_map":
            kb, _ = rk.dynamics_chain(model, params, ccfg, s0, U, e)
            pc0 = pc
            pc, px = rk.trajectory_cost_plain(model, params, ccfg,
                                              cost_params, cmap, U, e, kb)
            check(0 < px.sum().item() < K, "A random_map: crash flags do "
                  "not differ between rollouts")
            note = (", held against the plain cost along kernel B's "
                    "trajectories")

        def check_a(label, out):
            kc, ku, kx = out
            nonlocal err_a
            if name == "random_map":
                near = torch.isclose(kc, pc0, rtol=COST_RTOL, atol=COST_ATOL)
                n_differ = int((~near).sum().item())
                print(f"[kernel A] {label} random_map: {n_differ} rollouts "
                      f"differ from the plain version's own trajectories")
                check(n_differ <= MAX_RANDOM_MAP_DIFFER, f"A random_map: "
                      f"{n_differ} rollouts differ from the plain version, "
                      f"more than {MAX_RANDOM_MAP_DIFFER}")
            e_cost = (kc - pc).abs().max().item()
            e_u = (ku - pu).abs().max().item()
            n_crash_diff = int((kx != px).sum().item())
            print(f"[kernel A] {label} {name} K={k_n}: max|cost err| "
                  f"{e_cost:.3e} (cost range {pc.min().item():.4g}.."
                  f"{pc.max().item():.4g}), max|u_seq err| {e_u:.3e}, crash "
                  f"{int(px.sum().item())}/{k_n} rollouts, crash mismatches "
                  f"{n_crash_diff}{note}")
            check(torch.isfinite(kc).all().item(),
                  f"A {label} {name}: non-finite costs")
            check(torch.allclose(kc, pc, rtol=COST_RTOL, atol=COST_ATOL),
                  f"A {label} {name}: costs differ beyond rtol {COST_RTOL} "
                  f"atol {COST_ATOL}")
            check(n_crash_diff == 0, f"A {label} {name}: crash flags differ")
            check(torch.equal(ku, pu), f"A {label} {name}: u_seq differs")
            err_a = max(err_a, e_cost)

        hold_geometries(f"kernel A {name}", geoms, lambda: tuple(
            rk.fused_exact_rollout_cost(model, params, ccfg, cost_params,
                                        cmap, s0, U, e, **kw)), check_a)
    del eps_r

    lap("phase 2")

    # -- phase 3: kernel B against its plain version -------------------------
    # in each of its geometries (one rollout a thread, one a warp), each bit
    # for bit equal to one rollout a thread: at the cases' K=1920 (the fine
    # random map's included), on a shard's slice at a K that is not a
    # multiple of the warp form's block, and at the nominal trajectory (K=1)
    err_b = 0.0
    shard_b = 701
    b_cases = dict(cases, shard=(cfg, start, costmap))
    for name, (ccfg, s0, _) in b_cases.items():
        e, kw = ((eps[:, shard_b:].contiguous(), dict(k_offset=shard_b))
                 if name == "shard" else (eps, {}))
        ks, ku = hold_geometries(f"kernel B {name}", rk.CHAIN_GEOMETRIES,
                                 lambda: tuple(rk.dynamics_chain(
                                     model, params, ccfg, s0, U, e, **kw)),
                                 lambda label, out: None, chain=True)
        ps, pu = rk.dynamics_chain_plain(model, params, ccfg, s0, U, e, **kw)
        torch.cuda.synchronize()
        same_nan = torch.equal(torch.isnan(ks), torch.isnan(ps))
        fin = torch.isfinite(ps)
        e_s = (ks[fin] - ps[fin]).abs().max().item() if fin.any() else 0.0
        print(f"[kernel B] {name} K={e.shape[1]}: max|state err| {e_s:.3e}, "
              f"max|u_seq err| {(ku - pu).abs().max().item():.3e}")
        check(same_nan, f"B {name}: NaN pattern differs")
        check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL,
                             equal_nan=True), f"B {name}: states differ")
        check(torch.equal(ku, pu), f"B {name}: u_seq differs")
        err_b = max(err_b, e_s)
    ks, _ = hold_geometries("kernel B nominal trajectory (K=1)",
                            rk.CHAIN_GEOMETRIES, lambda: tuple(
                                rk.nominal_trajectory(model, params, cfg,
                                                      start, U)),
                            lambda label, out: None, chain=True)
    eps1 = torch.zeros((T, 1, 2), device=dev)
    ps, _ = rk.dynamics_chain_plain(model, params, cfg, start, U, eps1)
    ps = torch.cat([start[None], ps[:, :, 0].T[:-1]])
    e_nom = (ks - ps).abs().max().item()
    print(f"[kernel B] nominal trajectory (K=1): max|state err| {e_nom:.3e}")
    check(torch.allclose(ks, ps, rtol=STATE_RTOL, atol=STATE_ATOL),
          "B nominal trajectory differs")
    err_b = max(err_b, e_nom)

    lap("phase 3")

    # -- phase 4: the main path ----------------------------------------------
    # the same seeded configuration on the CPU (plain PyTorch path)
    cpu_solver, cpu_params, _, cpu_map, _ = drive_oval.build(
        rollouts=K, device="cpu")
    Ug, stg = solver.iterate(params, cost_params, costmap, start, U, eps)
    Uc, stc = cpu_solver.iterate(cpu_params, cost_params, cpu_map,
                                 start.cpu(), U.cpu(), eps.cpu())
    e_it = (Ug.cpu() - Uc).abs().max().item()
    print(f"[main path] one iteration GPU vs CPU: max|U_new err| {e_it:.3e}, "
          f"ess {stg.ess.item():.2f} vs {stc.ess.item():.2f}")
    check(e_it <= ITER_ATOL, f"iterate: GPU and CPU differ by {e_it}")

    rk.LAUNCHES.clear()
    out = drive_oval.drive(solver, params, cost_params, costmap, TICKS,
                           log=lambda m: print(f"[main path] {m}"))
    launches = {n: rk.LAUNCHES[n] for n in ("fused_exact_rollout_cost",
                                            "dynamics_chain")}
    st = out["solve_ms"]
    stats = out["stats"]
    print(f"[main path] {TICKS} ticks: solve latency p50 "
          f"{np.percentile(st, 50):.3f} ms p99 {np.percentile(st, 99):.3f} ms "
          f"(slide + solve + control readback, host clock; {card}); "
          f"ess {stats.ess.item():.1f}, crash% "
          f"{stats.crash_frac.item() * 100:.1f}; launches {launches}")
    check(np.isfinite(out["controls"]).all(), "non-finite controls")
    for name, n in launches.items():
        check(n >= TICKS, f"{name} launched {n} times in {TICKS} ticks")
    results["latency"] = (float(np.percentile(st, 50)),
                          float(np.percentile(st, 99)))
    # the same drive with kernel A, then kernel 2, in one rollout a thread
    # (the previous design, the same bits: the same trajectory) and in the
    # launcher's geometry, in TURN_PAIRS pairs whose order alternates
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results["latency_turns"] = {
        "kernel A": drive_turns(
            drive_oval, "kernel A", False, rk.GEOMETRIES[0],
            launcher_geometries(rk, False)[0], solver, params, cost_params,
            costmap, out["controls"], card),
        "kernel B": drive_turns(
            drive_oval, "kernel B", True, rk.CHAIN_GEOMETRIES[0],
            rk.chain_geometry(1, sms)[:2], solver, params, cost_params,
            costmap, out["controls"], card)}
    # what the controller state's key adds to a solve on the host: the
    # split and the host-noise generator seeded from the subkey
    from autorally_tpu_torch.ops import kernel_rng
    key = solver.init_state().key
    t0 = time.perf_counter()
    for _ in range(1000):
        key, sub = kernel_rng.split(key)
        solver._noise_generator(sub)
    key_us = (time.perf_counter() - t0) * 1e3
    print(f"[main path] the key's host time a solve: {key_us:.1f} us "
          f"(split + generator, host clock, mean of 1000; {card})")

    lap("phase 4")

    # -- phase 5: timing -----------------------------------------------------
    flops_step = mlp_flops(model.layers)
    n_w = sum(a * b + b for a, b in zip(model.layers[:-1], model.layers[1:]))
    launch_a, _ = rk.prepare_fused_exact_rollout_cost(
        model, params, cfg, cost_params, costmap, start, U, eps)
    ms_a = cuda_ms(launch_a, 100)
    plain_a = cuda_ms(lambda: rk.fused_rollout_cost_plain(
        model, params, cfg, cost_params, costmap, start, U, eps), PLAIN_REPS,
        0)
    bytes_a = 4 * (T * K * 2 + 2 * T * K + 2 * K + T * 2 + n_w + 7 + 4
                   + 2 * K * (T - 1))        # + one texel per front/back lookup
    bound_a, by_a = bound(bytes_a, flops_step * K * T)

    chain_b = chain_timing(rk, "B dynamics_chain", model, params, cfg, start,
                           U, eps1, False, 100, card)
    ms_b = chain_b["ms"]
    plain_b = cuda_ms(lambda: rk.dynamics_chain_plain(
        model, params, cfg, start, U, eps1), PLAIN_REPS, 0)
    bytes_b = 4 * (T * 2 + 7 * T + 2 * T + T * 2 + n_w + 7 + 4)
    bound_b, by_b = bound(bytes_b, flops_step * T)
    print(f"[timing] A fused_exact_rollout_cost K={K} T={T}: {ms_a:.4f} ms, "
          f"plain {plain_a:.3f} ms, bound {bound_a:.5f} ms ({by_a}) ({card})")
    geometry_line(rk, "timing A", launch_a, False, False, card)
    print(f"[timing] B dynamics_chain K=1 T={T}: {ms_b:.4f} ms, plain "
          f"{plain_b:.3f} ms, bound {bound_b:.7f} ms ({by_b}), latency floor "
          f"{chain_b['floor_ms']:.4f} ms ({card})")

    lap("phase 5")

    # -- phase 6: where a tick's time goes ---------------------------------
    profile_ticks(drive_oval, solver, params, cost_params, costmap, card)

    lap("phase 6")

    # -- phases 7-10: the kernel-RNG capacity mode ---------------------------
    cap_kernels, cap_latency = capacity_phases(
        drive_oval, solver, params, cost_params, costmap, cases, U, start,
        (cpu_solver, cpu_params, None, cpu_map), card)

    lap("phases 7-10")

    # -- phases 11-14: the neural-field costmap path -------------------------
    field_kernels, field_latency, field = field_phases(
        drive_oval, model, params, cost_params, costmap, U, start,
        edge_start, nan_start, slow_start, card)

    lap("phases 11-14")

    # -- phases 15-18: the BF model and the obstacle terms -------------------
    bf_obs_kernels, bf_obs_latency = bf_obstacle_phases(
        drive_oval, model, params, cost_params, costmap, field, cases, eps,
        U, start, slow_start, card)

    lap("phases 15-18")

    # -- phase 19: BF exact pass 1's constant quotients, every input ------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mismatches = rk.const_quotient_check()
    quotient_s = time.perf_counter() - t0
    print(f"[quotients] div_const with its guard against __fdiv_rn, all "
          f"2^32 float32 bit patterns for each of {len(mismatches) - 2} "
          f"divisors, and the branch-free stream's quotient and root "
          f"against __fdiv_rn and __fsqrt_rn for all 2^23 uniforms: "
          f"mismatches {mismatches} ({sum(mismatches.values())} in all), "
          f"{quotient_s:.2f} s ({card})")
    check(len(mismatches) == 18 and not any(mismatches.values()),
          f"BF pass 1's branch-free arithmetic differs from IEEE "
          f"division or root: {mismatches}")

    lap("phase 19")

    # -- phase 20: the tube loop ----------------------------------------
    from autorally_tpu_torch import run_tube_mppi
    tube = tube_phase(run_tube_mppi, rk, card)

    lap("phase 20")

    # -- phase 21: the closed-loop episode, the tick one CUDA graph -------
    episode = episode_phase(rk, card)

    lap("phase 21")

    # -- phase 22: the async loop, the tick one CUDA graph ----------------
    async_loop = async_phase(run_tube_mppi, rk, card)

    lap("phase 22")

    # -- phase 23: the realtime gates, the simulator a second process -----
    with builds_paused(card):
        gates = gate_phase(rk, card)

    lap("phase 23")

    # -- phase 24: the general rollout path -------------------------------
    general = general_phase(drive_oval, rk, card)

    lap("phase 24")

    # -- phase 25: the ensemble solver, a kernel launch a member ----------
    ensemble = ensemble_phase(rk, card)

    lap("phase 25")

    # -- phases 26-27: the sharded solvers, the tools, the build cache ----
    cold = start_cold_loaders()
    try:
        sharded = sharded_phase(drive_oval, rk, card)
        tools = tools_phase(card, cold)
    finally:
        stop_cold_loaders(cold)

    lap("phases 26-27")

    # -- phase 28: kernels 1-4 at other MLP specs -------------------------
    # phase 1 for the other specs' libraries, built meanwhile
    t_wait = time.perf_counter()
    for layers in FIELD_SPEC_LAYERS:
        spec_lib, spec_s = builds.get(layers)
        print(f"[build {spec_label(layers)}] "
              f"{_build.library_path(layers).name}: "
              + (f"nvcc {spec_lib.build[0]:.1f}s" if spec_lib.build
                 else "already built") + f", {spec_s:.1f}s, done "
              f"{builds.done[layers, None, False]:.1f}s into the run, waited "
              f"{time.perf_counter() - t_wait:.1f}s at phase 28 "
              f"({t_wait - t_start:.1f}s into the run) ({card})")
        spec_instances(rk, layers, spec_lib, card)
    spec = spec_phase(drive_oval, rk, card)
    spec_field = spec_field_phase(drive_oval, rk, card, field)

    lap("phase 28")

    # -- phase 29: BASELINE #3, a model trained on the card drives --------
    baseline3 = baseline3_phase(drive_oval, rk, card,
                                spec["specs"][SPEC_LAYERS[0]],
                                spec_field["specs"][SPEC_LAYERS[0]], field)

    lap("phase 29")

    # -- phase 30: kernels 3 and 4 on fields of other specs ---------------
    # phase 1 for the field libraries, built meanwhile
    t_wait = time.perf_counter()
    for layers, fspec in FIELD_PAIRS:
        field_lib, field_s = builds.get(layers, fspec)
        print(f"[build {_build.field_label(fspec)}] "
              f"{_build.library_path(layers, fspec).name}: "
              + (f"nvcc {field_lib.build[0]:.1f}s" if field_lib.build
                 else "already built") + f", {field_s:.1f}s, done "
              f"{builds.done[layers, fspec, False]:.1f}s into the run, waited "
              f"{time.perf_counter() - t_wait:.1f}s at phase 30 ({card})")
        field_library_instances(rk, layers, fspec, field_lib, card)
    field_specs = field_spec_phase(drive_oval, rk, card)

    lap("phase 30")

    # -- phase 31: matmul_precision "default" -----------------------------
    # phase 1 for the libraries of bf16 operands, built meanwhile
    t_wait = time.perf_counter()
    for layers, fspec in BF16_LIBRARIES:
        bf16_lib, bf16_s = builds.get(layers, fspec, bf16=True)
        print(f"[build bf16] {_build.library_path(layers, fspec, True).name}"
              ": " + (f"nvcc {bf16_lib.build[0]:.1f}s" if bf16_lib.build
                      else "already built") + f", {bf16_s:.1f}s, done "
              f"{builds.done[layers, fspec, True]:.1f}s into the run, waited "
              f"{time.perf_counter() - t_wait:.1f}s at phase 31 ({card})")
        bf16_library_instances(rk, layers, fspec, bf16_lib, card)
    precision = precision_phase(drive_oval, rk, card, field)

    lap("phase 31")

    # -- phase 32: the physics simulator and the ML loop ------------------
    t_phys = time.perf_counter()
    physics = physics_phase(rk, card, sim=physics_sim)
    print(f"[time] phase 32 (c)-(d) in {time.perf_counter() - t_phys:.1f}s "
          f"({card})")

    # -- phase 33: the cost-parameter sweep on the lane forms -------------
    t_sweep = time.perf_counter()
    sweep = sweep_phase(rk, card)
    print(f"[time] phase 33 in {time.perf_counter() - t_sweep:.1f}s ({card})")

    # -- phase 34: circles, the field, the ESS law and moving obstacles in
    # the sweep's lanes ------------------------------------------------------
    t_lanes = time.perf_counter()
    lanes_field = lanes_field_phase(rk, card, field)
    print(f"[time] phase 34 in {time.perf_counter() - t_lanes:.1f}s ({card})")

    # -- phase 35: the capacity mode in the sweep's lanes; every library's
    # lane forms ------------------------------------------------------------
    t_cap = time.perf_counter()
    cap_lanes = capacity_lanes_phase(rk, card, field)
    print(f"[time] phase 35 in {time.perf_counter() - t_cap:.1f}s ({card})")

    # -- phase 36: circles past the 64 staged slots; a field left in device
    # memory ----------------------------------------------------------------
    t_many = time.perf_counter()
    many = many_circles_phase(drive_oval, rk, card, field, builds)
    print(f"[time] phase 36 in {time.perf_counter() - t_many:.1f}s ({card})")

    # -- phase 37: the operator's run ---------------------------------------
    t_op = time.perf_counter()
    operator = operator_phase(run_tube_mppi, rk, card, tube["split"]["tick"])
    print(f"[time] phase 37 in {time.perf_counter() - t_op:.1f}s ({card})")

    # -- phase 38: the car's I/O around the solve on the card ---------------
    t_io = time.perf_counter()
    vehicle_io = vehicle_io_phase(drive_oval, rk, card, ms_a)
    print(f"[time] phase 38 in {time.perf_counter() - t_io:.1f}s ({card})")

    # -- phase 39: every horizon the JAX kernels take -----------------------
    t_hor = time.perf_counter()
    horizons = horizons_phase(drive_oval, rk, card, builds)
    print(f"[time] phase 39 in {time.perf_counter() - t_hor:.1f}s ({card})")

    src = "autorally_tpu_torch/csrc/rollout_kernels.cu"
    kernels = [
        {"name": "fused_exact_rollout_cost", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:1013",
         "launches": launches["fused_exact_rollout_cost"],
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
         "bound_ms": bound_a, "bound_by": by_a, "library_ms": None,
         "geometry": geometry_label(launch_a.geometry)},
        {"name": "dynamics_chain", "route": "cuda", "source": src,
         "replaces": "autorally_tpu/ops/rollout_kernel.py:389",
         "launches": launches["dynamics_chain"],
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": None,
         **chain_entry(chain_b)},
    ] + cap_kernels + field_kernels + bf_obs_kernels + general["kernels"] + (
        ensemble["kernels"]) + sharded["kernels"] + spec["rows"] + [
        row for layers, d in spec_field["drives"].items()
        for row in spec_field_rows(layers, spec_field["specs"][layers], d)] + (
        baseline3["rows"]) + field_specs["rows"] + precision["rows"] + (
        sweep["rows"]) + lanes_field["rows"] + cap_lanes["rows"] + (
        many["rows"]) + horizons["rows"]
    # each kernel's geometry (kernels 1 and 2, as the launcher picks it at
    # the form's K) or design
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    field_design = ("a lane a rollout, the field on the warp's mma.sync "
                    "3xTF32 tiles, blocks of %d")
    for k in kernels:
        name = k["name"]
        model = "Bf" if "_bf" in name else "Mlp"
        if (k.get("precision") == PRECISION or "lanes" in k
                or "slots" in k or "layout" in k or "T" in k):
            continue                 # phases 31, 33-36, 39 carry their own
        layers = tuple(k.get("layers", rk.KERNEL_LAYERS))
        if name.startswith("fused_exact_rollout_cost"):
            geom = rk.exact_geometry(k.get("K", KB if "_bf" in name else K),
                                     sms, "_bf" in name, layers=layers)
            k.setdefault("geometry", geometry_label(geom))
            k["instance"] = exact_instance(geom, False, "_bf" in name)
        elif name.startswith("dynamics_chain"):
            k["instance"] = ("dynamics_chain_warp_kernel" if rk.chain_geometry(
                k.get("K", 1), sms, "_bf" in name, layers=layers).group > 1
                else "dynamics_chain_kernel") + f"<{model}>"
        elif name.startswith(("fused_rollout_cost", "fused_rng_costs_field")):
            k["design"] = field_design % rk.field_block(layers)
            k["instance"] = ("fused_field_kernel" if name.startswith(
                "fused_rollout_cost") else "fused_rng_field_kernel") + (
                f"<{model}>")
        elif name.startswith("fused_rng_costs"):
            geom = rk._geometry(k.get("K", KC), 1, rk.EXACT_BLOCK)
            k["design"] = ("one rollout a thread, blocks of %d, weights in "
                           "shared memory" % rk.EXACT_BLOCK)
            k["instance"] = exact_instance(geom, True, "_bf" in name)
            if "_bf" in name:
                info = rk.exact_kernel_info(True, True, geom, T)
                k["design"] += (
                    "; the basis functions' quotients by constants without "
                    "the division's slow path (BfConstDivDeriv), the stream "
                    "drawn a step ahead (StreamNoiseAhead); %d registers, "
                    "%d warps an SM, %.2f waves at K=%d" % (
                        info["registers"],
                        info["blocks_per_sm"] * rk.EXACT_BLOCK // 32,
                        info["waves"], KC))
        elif name == "fused_rng_numer":
            k["design"] = ("a thread a rollout, fixed-order block sums, "
                           "blocks of %d" % rk.UPDATE_BLOCK)
            k["instance"] = "weighted_update_kernel"
    # every compiled instance with its registers (ptxas, phase 1), the ones
    # that no form above launches at its K included
    print(json.dumps({"kernels": kernels, "instances": PTXAS, "card": card,
                      "solve_ms_p50_p99": results["latency"],
                      "solve_ms_turns": results["latency_turns"],
                      "capacity_solve_ms_p50_p99": cap_latency,
                      "field_solve_ms_p50_p99": field_latency,
                      "bf_obstacle_solve_ms_p50_p99": bf_obs_latency,
                      "tube_tick_ms_p50_p99": tube["split"]["tick"],
                      "bf_tube_tick_ms_p50_p99": tube["bf_split"]["tick"],
                      "bf_tube_200_tick_ms_p50_p99":
                          tube["bf_long_split"]["tick"],
                      "bf_ddp": tube["bf_ddp"],
                      "episode_launches_per_tick": episode["launches"],
                      "episode_timing": episode["timing"],
                      "async_launches_per_tick": async_loop["launches"],
                      "async_depth1": async_loop["depth1"],
                      "async_depth2": async_loop["depth2"],
                      "gates": gates,
                      "general_path": general["latency"],
                      "ensemble": ensemble["results"],
                      "sharded": sharded["results"],
                      "baseline3": baseline3["results"],
                      "field_specs": field_specs["results"],
                      "precision_default": precision["results"],
                      "physics": physics,
                      "sweep": sweep["results"],
                      "lanes_field": lanes_field["results"],
                      "capacity_lanes": cap_lanes["results"],
                      "many_circles": many["results"],
                      "operator": operator,
                      "vehicle_io": vehicle_io,
                      "horizons": horizons["results"],
                      "spec_sweep_ms": spec["sweep"],
                      "spec_kernels34": {
                          spec_label(sp): {
                              "pass1_ms_K%d" % KS_WIDE: r["pass1"]["ms_K65536"],
                              "pass2_ms_K%d" % KS: r["pass2"]["ms"],
                              "pass2_bound_ms": r["pass2"]["bound_ms"]}
                          for sp, r in spec_field["specs"].items()},
                      "spec_kernels34_drives_ms_p50_p99": {
                          spec_label(sp): {n: v["latency"]
                                           for n, v in d.items()}
                          for sp, d in spec_field["drives"].items()},
                      "spec_kernel2_K%d" % KS: {
                          spec_label(sp): {
                              "ms": r["kernel2"][KS]["ms"],
                              "one_thread_ms": r["kernel2"][KS][
                                  "one_thread_ms"],
                              "plain_ms": r["kernel2"][KS]["plain_ms"],
                              "bound_ms": r["kernel2"][KS]["bound_ms"]}
                          for sp, r in spec["specs"].items()},
                      "tools": {"scaling": tools["scaling"],
                                "cold_cache": tools["cold_cache"],
                                "breakdown_full_solve_ms": {
                                    k: tools[f"breakdown_{k}"]["stages_ms"][
                                        "FULL_SOLVE"]
                                    for k in ("main", "kernel_rng")}}}))
    print(f"[time] phases 1-39 in {time.perf_counter() - t_start:.1f}s "
          f"({card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
