#!/usr/bin/env python3
"""Drive the PyTorch port (``alan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the whole check, one card

Phases, one JSON line each; any failed check makes the script exit non-zero
without its final line:

1. build     -- compile the CUDA kernels (nvcc, sm_90a, one process per
                source) and the native planner (g++) from the sources in
                this checkout, all at once;
2. kernels   -- each kernel against its plain PyTorch version on the card.
                The lazy low-rank kernels at the MovieLens main-path shape
                (1, 300, 1000, 1000, 36), an overhang
                shape, -inf-bias cases, a feature axis wider than one dU /
                dV block and one wider than shared memory holds (taken in
                chunks), a plate longer than a grid axis, the Normal's
                factors with heavy cancellation (terms 1e2-1e4 times the
                score) and the operands that the first MovieLens K=1000 QEM
                step hands to the kernel (captured, with the gradient that
                comes back): forward rtol/atol 1e-5, all three gradients
                rtol 1e-4 / atol 1e-5.  A gradient that misses that bound
                (and, in the last two cases, a forward) passes only if it is
                at least as close as the plain version to an f64 evaluation (long f32 sums round
                differently, and the plain version is no exact reference
                either).  Times from CUDA events, median of several runs,
                beside the dense two-call yardstick (``torch.baddbmm`` +
                ``torch.logsumexp``, never called by the port), the f32
                CUDA-core bound and the 3xTF32 tensor-core bound.
                The small-K chain kernels (forward and backward, several tree
                levels per launch, as the launch plan says) on whole chains
                against the level-by-level plain version: covid's (2760
                chains, T = 109, K = 30), T at and around covid's segment of
                8 (7, 8, 9, 17, and 3 < 8), K = 45 (segments of 4), K = 2,
                K = 100 with odd T, -inf entries: forward rtol/atol 1e-5,
                gradients rtol 1e-4 / atol 1e-5 (with the same f64 rule),
                bitwise equality reported, launches = the plan's length;
                the kernels' logarithm against logf on every float in
                [FLT_MIN, 128] (no difference allowed); the fix-ups' shared
                memory against the planner's.  Peaked operators at
                covid's chain (log N(x'; x, 0.01) between particle sets of
                spread 1), where the separate shifts lose whole entries:
                the kernels with their joint-shift fix-ups against the
                repaired plain version (values 1e-5, gradients of the
                summed-out chain 1e-4) and, on 60 chains, an exact float64
                chain; the entries that took the joint shift, kernel and
                plain.  Their times (each launch with its fix-up) beside
                those before the fix-ups, the plain version's and the dense
                torch route's
                (``ALAN_TPU_NO_SMALLK_CHAIN=1``).  The fused log-matmul: its
                pre-pass bitwise against its plain version; the whole at
                rtol/atol 1e-5 at both levels of the AR(1) chain ((2, 1000,
                1000) @ (2, 1000, 1000) and batch 1), a ragged K = 257, -inf
                rows and columns, K = 128 with a batch, and sums of products
                in [e^-80, e^-78] (above FLT_MIN, out near 0); products
                below FLT_MIN reported beside the plain version and f64, not
                gated; the peaked case at K = 128 (60 products at covid's
                scales) with the forward and backward fix-ups against the
                repaired plain version and f64 (value 1e-5, gradients
                1e-4); the pre-pass, the product and the whole timed at both
                levels beside the plain version and the f32 and 3xTF32
                bounds;
3. main_path -- grouped MovieLens at full width (M=300, N=5, d_z=18), K=1000,
                data from a fixed numpy seed, ``train.qem`` steps on the card;
                the launch counters are zeroed just before and read just
                after, and every kernel must have run; then a
                torch.profiler breakdown of two more steps (device busy time,
                idle share, the kernels that take the most time);
4. cross_check -- one QEM update from the same state and the same injected
                particles with the lazy path on (kernels) and off (the dense
                materialised cross product): ELBO within 1e-4 relative, the
                updated Q state within rtol/atol 1e-4;
5. movielens_k30_main_path -- bench.py's headline (``bench.py:106-120``):
                ungrouped MovieLens QEM at K=30, full width, data from a
                fixed numpy seed; no hand-written kernel runs on it; ms/step,
                device busy, idle share, peak memory and bench.py's
                K (2 + M) samples a second;
6. movielens_k30_cross_check -- one update from the same state and
                particles on the card and on the host's CPU, the host's
                with the matmul route and the factored log-density off
                (``ALAN_TPU_NO_MATMUL_CONTRACT=1``,
                ``ALAN_TPU_NO_LOWRANK_LOGPROB=1``; at this shape the card
                takes neither, so the host is the independent evaluation):
                ELBO within 1e-4 relative, the Q state within rtol/atol 1e-4;
7. vi_main_path -- grouped MovieLens with its opt Q (location and
                log-scale of each Normal), K=1000, ``train.vi`` steps: the
                lowrank forward and the backward's dU and dV modes must
                launch in every step; their device time per step by mode;
                one more step's gradients copied to the host, and Adam on
                the card (capturable) against Adam on the host from the same
                state and gradients: the largest difference in ulps, gate
                1e-6 of |new| + |update| once the card's float32 bias
                corrections are taken out;
8. vi_cross_check -- the ELBO and the gradient of every opt param from the
                same state and draws through the kernels and through the
                dense route (``ALAN_TPU_NO_LAZY_LOWRANK=1``): ELBO within
                1e-4 relative, gradients within rtol/atol 1e-4, or (the f64
                rule) at least as close as the dense route's to a float64
                evaluation and within 1e-4 (1 + max |g|) of it;
9. covid_main_path -- the covid model at full size (92 regions x 109
                training days, ``examples/models/covid.py``), a QEM Q, K=30,
                data from a fixed numpy seed, ``train.qem`` steps on the
                card: both small-K chain kernels must launch in every step
                (one launch per entry of the launch plan: 3 each at T = 109,
                K = 30), finite ELBOs and state,
                peak memory, then a profile of two more steps; at Q's
                initial state and after the path's steps, the entries of
                the chain's forward that took the joint shift and the chain
                kernels' times on that step's operator, beside those
                before the fix-ups;
10. covid_cross_check -- one covid update from the same state and injected
                particles, small-K kernels against the dense chain route:
                ELBO within 1e-4 relative, the Q state within rtol/atol 1e-4;
11. covid_rws_path -- covid at full size with its opt Q, K=30,
                ``train.rws`` (lr 0.01, ``examples/grids/covid.yaml``): both
                chain kernels in every step, ms/step, device busy, peak
                memory;
12. covid_rws_cross_check -- the ELBO and the opt params' gradients from
                the same state and particles, chain kernels against the
                dense chain route: 1e-4 as in phase 8;
13. ar1_large_k -- the AR(1) model at K=1000, whose chain runs through the
                fused log-matmul kernel (2 launches an ELBO, each of them
                required): 20 ELBO draws must bracket the exact Kalman
                log-likelihood by the criterion of
                ``tests/test_problem_vs_itself.py:141-160``; then a profile
                of two more ELBOs;
14. grouped_posterior_k1000 -- the posterior of grouped MovieLens at
                K=1000 (phase 3's model, 5 held-out films beside its 5),
                read out at the Q state after 5 QEM steps:
                ``marginals()`` (must launch the lowrank forward and
                ``MODE_DD``), ``importance_sample(1000)`` (the forward) and
                ``predict.predictive_ll_fn`` on the 10 films (the forward);
                ms, peak memory and launches of each, the ESS; gate: the
                importance samples' mean and mean2 of every latent within
                6 standard errors of the marginals' (the criterion of
                ``tests/test_problem_vs_itself.py:99-116``), widened by
                Bernstein's term for rare particles (12 R / N, R the
                largest deviation of a particle) and by 1e-5 of the moment
                for float32 rounding where a marginal is one particle),
                every output finite; a profile of two more
                importance samples (run after phase 4);
15. grouped_posterior_cross_check -- the marginals and the replay's draws
                from the same particles and Gumbel noise through the kernels
                and through the dense route: weights within rtol/atol 1e-4
                (or the f64 rule), draws equal up to near-ties (the share
                that differs reported), no lowrank launch on the dense
                route;
16. is_draws_k30 -- ``bench.py``'s ``bench_is_draws``: ungrouped MovieLens
                K=30, ``predict.importance_sample_fn`` at N = 100, 1000 and
                3000: ms per call, draws a second in ``bench.py``'s unit
                N (2 + M); no hand-written kernel runs on it; a profile at
                N = 1000; then the same draws on the host's CPU (routes as
                phase 6), equal up to near-ties (run after phase 6);
17. covid_posterior_k30 -- the covid posterior at full size (92 regions x
                109 training days, extended to 137), K=30, N=100 draws
                (``examples/runner.py``'s --predll-N), at Q after 5 QEM
                steps (run after phase 10): ``marginals()`` (must launch the
                chain kernels' forward and backward),
                ``importance_sample(100)`` (the forward at the root's and
                the regions' traversal, then FFBS over the days: one joint
                route over K_log_infected) and ``predict.predictive_ll_fn``
                over the 137 days (the forward); ms, peak memory and
                launches of each, a profile of two importance samples.
                Gate: every cell's marginal weights of InitialSize_log, psi
                and log_infected sum to 1 within 1e-3 (with the chain's
                joint shift the days keep their weights), and the
                importance moments of all three against the marginals'
                (phase 14's rule); then the same at Q centred on the
                latents the data were drawn from;
18. covid_posterior_cross_check -- the same particles and Gumbel noise
                through the chain kernels, the dense chain route
                (``ALAN_TPU_NO_SMALLK_CHAIN=1``, no chain launch) and the
                host's CPU (card and host both scoring counts of a few
                hundred: at the fake counts of 1e7 the NegativeBinomial
                rounds apart on the two): the share of draws that differ; each must be a
                near-tie, in FFBS the first that differs in each chain (the
                chain's later draws condition on another particle), but in
                the chains whose root or region draw differs;
19. ar1_ffbs_k1000 -- AR(1) at K=1000, ``importance_sample(1000)``: the
                fused log-matmul in the root contraction, FFBS over the 4
                steps; ms per call and launches; gate: each step's mean of
                the draws within 6 standard errors (at the marginals' ESS
                and N) of the Kalman smoother's mean, computed here in
                numpy;
20. scan_grouped_k1000 -- ``train.scan_steps`` (one step captured as a CUDA
                graph, replayed with no host dispatch) of phase 3's QEM step
                and phase 7's VI step, 5 and 20 steps (run after phase 15);
21. scan_headline_k30 -- ``bench.py``'s mode: ``scan_steps`` of phase 5's
                step, 20 and 80 steps; ms/step by ``bench.py``'s slope rule
                (the median of the positive slopes between the two lengths),
                samples a second in its unit, the capture's seconds;
22. vmap_runs_k30 -- ``bench_scaling.grid_throughput``'s shape:
                ``train.vmap_runs`` of phase 5's step, R = 1, 4 and 8 runs of
                20 (and 80) steps, each run its own graph on its own
                stream: ms/iter and ms/run-iter; gate: row r equals
                ``scan_steps`` from run r's generator (1e-5 relative), rows
                0 and 1 differ;
23. global_k30 -- ``train.global_vi``, ``global_rws`` and ``global_qem`` on
                the K=30 headline model (its opt Q for the first two), 5
                steps each, eager and through ``scan_steps``; then
                ``nonmp_moments_streaming`` at 2^16 particles in chunks of
                2^12 against one global softmax over the same chunks (ELBO
                1e-5 relative, moments within 1e-5 of their largest entry),
                on MovieLens (ESS 1) and on synthetic_model with Q fixed at
                its analytic posterior, scale doubled: ESS >= 1000, the
                streamed mean within 6 standard errors of the analytic one;
24. scan_covid_k30 -- ``scan_steps`` of phase 9's step, 5 and 20 steps
                (run after phase 18);
25. scan_ar1_k1000 -- 20 and 80 AR(1) ELBOs at K=1000 as a captured loop (a
                step that keeps its state and returns ``train.elbo_fn``'s
                ELBO): phase 13's Kalman bracket on the graphed draws.
                In phases 20, 21, 23, 24 and 25 every ELBO of the graphed
                loop lies within 1e-5 relative of the eager loop's from a
                generator of the same seed, the final state within
                rtol/atol 1e-4, and the two generators end alike; the
                launch counters are read around the capture (a wrapper
                counts where it launches, and inside a capture the launch
                is recorded into the graph), which gives the launches of
                each replay: QEM the lowrank forward and ``MODE_DD``, VI
                ``MODE_DU`` and ``MODE_DV``, covid 3 + 3 chain launches,
                AR(1) 2 fused launches; a profile of one call's replays
                (device busy, idle share) must show those kernels' names;
26. families_cuda -- every distribution family (35) on the card, run after
                phase 2: 2e5 draws (2e4 of a matrix) from a CUDA generator
                by ``tests/test_families.py``'s ``check_mean_var`` rule
                (or the family's own criterion where it states no
                moments), ``log_prob`` on the card against the host's
                (1e-5 of max(1, |value|)), the reparameterised draws'
                gradients against the host's from the same noise (rtol
                1e-4); no kernel of the repo runs;
27. lowrank_families_k1000 -- the factored forms of the LogNormal,
                Exponential, Gamma, Chi2 and Beta at grouped MovieLens
                K=1000's sizes (K_z = K_g = 1000, plate 300; rank F = 1 or
                2) through ``LowRankDT.contract`` (the lowrank forward and
                one backward, ``MODE_DU`` with dV) against the materialised
                route: value 1e-5, gradients 1e-4 (or the f64 rule); each
                kernel's ms at that F beside its bounds;
28. covid_corrq_main_path -- covid at full size with its corr_Q proposal
                (a QEM MultivariateNormal over the 9 NPI coefficients),
                K=30, ``train.qem``: 3 + 3 chain launches a step, finite
                ELBOs, the proposal's covariance positive definite
                (Cholesky info 0) after every step; a profile;
29. covid_corrq_cross_check -- phase 10's check on it;
30. scan_covid_corrq_k30 -- phase 24's on it (the MultivariateNormal's
                Cholesky factor inside the graph);
31. canonical_k30 -- the ten canonical models of ``alan_tpu_torch/models/``
                (synthetic_model, radon, chimpanzees, bus_breakdown,
                occupancy and the reparameterised radon, bus_breakdown,
                occupancy, movielens and covid) at their published sizes,
                fake data from numpy seed 0, QEM at K=30
                (``bench_scaling.canonical_models``) and occupancy also at
                K=10 (``examples/grids/canonical.yaml``): five eager steps
                (busy, idle, peak, the routes the launch counters show),
                ``scan_steps`` of 5 and 20 (ELBOs bitwise equal to eager;
                the slope rule), one update against the host CPU's port
                from the same particles (ELBO 1e-4 relative, state 1e-4;
                covid_reparam against the dense chain route on the card,
                as phase 10),
                ``predictive_ll_fn`` at N = 100 where canonical.yaml runs it
                (finite); covid_reparam: 3 + 3 chain launches a step and a
                replay, every day's log_infected weights summing to 1 after
                its steps.

32. strategies_covid_k30 -- full-size covid QEM at K=30 (phase 36's
                recipe counts, Q centred on their latents) under
                no_checkpoint, checkpoint, Split("nRs", 23) (4 equal
                chunks) and Split("nRs", 40) (40, 40 and 12): 3 eager steps
                and the same 3 captured (bitwise the eager loop, the
                launches of a replay those of an eager step); one step's
                ELBO within rtol 1e-5 / atol 1e-6 of no_checkpoint's
                (``tests/test_problem_vs_itself.py:189``), its new state
                within 1e-4, the marginal weights of one particle tree
                within ``COVID_WEIGHTS_TOL`` (2e-2; float32's order effect
                is ~2e-3), which reversed chunks must meet and a planted
                off-by-one chunk must miss, the chain kernels launched in
                every chunk; launches a step, busy ms, idle share and peak
                GB of each;
33. strategies_grouped_k1000 -- grouped MovieLens K=1000, QEM and VI,
                under no_checkpoint, checkpoint and Split("plate_1", 100):
                phase 32's gates, the weights within 1e-4 (VI by its ELBO's
                gradients); each chunk of 100 users stays on the lazy
                route, so the lowrank kernels launch in every chunk (by
                mode);
34. covid_k300_split -- the covid K sweep's K = 300 point
                (``scripts/covid_k_sweep.py:170-180``): 16 x 25 (20 training
                days, the counts of ``scripts/moments_vs_hmc_covid.py:51-62``),
                Split("nRs", 2), 5 QEM steps and ``marginals()``: the fused
                kernel and its fix-ups in every chunk, the joint entries and
                peak GB; unsplit where it fits (else its out-of-memory
                reported), one step of Split("nRs", 1) and of both with
                their chunks reversed, each first ELBO within 1e-5 of the
                first run's (the state after it reported, and the order's
                share of it); one step of each chunking from Q centred on
                the recipe's latents, the state within 1e-4; one region's
                chain and gradient at a batch of 1 and of 2, bitwise or not;
35. gold_analytic -- ``tests/test_mcmc_smc.py``'s five oracles at their
                draw counts and gates: HMC, NUTS and SMC's evidence on the
                linear Gaussian, HMC on the Dirichlet-Categorical and on an
                LKJ correlation;
36. gold_covid -- covid at full size (92 x 109, D = 10,318) with the
                recipe's counts, started at the recipe's own latents:
                NUTS (4 chains, max_depth 8) and HMC in float64, each
                iteration captured (one leapfrog's energy error in float32
                and float64 reported: float32 rounds by tens of nats);
                gates: every draw finite, the log posterior and its
                gradient at 4 thetas within 1e-5 and 1e-4 of the host's
                float64 evaluation, a depth-4 NUTS draw within 1e-4 of the
                host port's from the same state and noise, 5 captured draws
                bitwise 5 eager;
                reported: ms a draw and gradient evaluations a second
                (captured and eager), acceptance, step size, split-R-hat and
                bulk ESS, z-scores of MP QEM at K=30 against NUTS; at 16 x 25
                NUTS and SMC (2048 particles, its host syncs) and SMC's
                z-scores against NUTS (``scripts/covid_k_sweep.py:126-148``),
                each labelled unconverged where NUTS's R-hat exceeds 1.1;
37. checkpoint_resume -- covid QEM K=30 and grouped MovieLens VI K=1000
                (Adam's state) under ``scan_steps``: 10 steps bitwise 5, a
                save (state and generator), a load into a fresh problem and
                5 more; the file loaded on the host and back, bitwise.
38. perf_report -- ``perf.mfu_report`` of five paths' eager steps
                (the K=30 headline's QEM, grouped MovieLens K=1000 QEM and
                VI, covid QEM K=30, AR(1)'s ELBO at K=1000) at the ms a
                step of their captured loops by the slope rule (phases 20,
                21, 24, 25): analytic FLOPs a step (matmul and elementwise
                apart), ``FlopCounterMode``'s, ``mfu`` against the TF32
                peak and the float32 share, the card's name and power
                limit; gates: each analytic count equals the host's plain
                route's on the same problem (a process of its own, started
                after the build, with the card's matmul threshold), and
                ``mfu`` <= 1;
39. profiling_trace -- ``profiling.trace`` around 3 eager covid QEM steps
                (its file names both small-K chain kernels),
                ``timed_steps`` over 5 (5 positive times),
                ``device_memory_stats()``'s peak equal to
                ``max_memory_allocated()``;
40. mesh_single_card -- ``train`` steps under a ``MeshPlan`` at world size
                1 (NCCL, a TCP store on 127.0.0.1; DTensor layouts, the
                kernels through ``local_map``): grouped MovieLens K=1000
                QEM and VI under ``{"plate_1": "p"}`` + all K, covid K=30
                QEM under ``{"nRs": "p"}`` + all K and under ``{"nDs":
                "t"}`` (the chain through ``parallel/seq.py``), AR(1)'s
                ELBO at K=1000 under ``{"T": "t"}``; gates: ELBO and state
                bitwise or within 1e-6 relative of the unsharded step's
                from one generator seed, each path's kernels launched under
                the plan, the T-sharded chain taken; the collective
                inventory, eager and busy ms beside the unsharded step's;
41. runner_cli -- ``python -m alan_tpu_torch.runner`` as a subprocess:
                covid QEM K=30, 5 iterations; the same with ``--split nRs
                23``; under ``torchrun --nproc-per-node 1`` with ``--mesh
                p=1 --shard nRs=p``: exit 0, finite ELBOs, the first
                ELBO the train API's from the same seed;
42. grid_cli -- a 2-job grid spec (full-size covid QEM K=30 and MovieLens
                QEM K=30, 3 iterations each) through ``runner --grid`` in
                this process, through ``python -m alan_tpu_torch.run_grid
                -j 1`` (``alan-grid`` built from ``csrc/gridrunner.cpp``),
                and as single runs: first ELBOs bitwise alike, the status
                file 2 ok, a rerun skips both;
43. moments_gold -- ``runner_moments`` on MovieLens at its published size:
                NUTS in float32 (100 + 100 draws, 4 chains), QEM K=30: the
                JAX record's keys, finite, the MP means equal to
                ``marginals()``' on the fitted state; R-hat, ESS, times and
                MSE reported;
44. moments_is_sweep -- ``runner_moments_IS`` on MovieLens at its published
                size, 3 runs, MP K = 3, 30, 300, global IS K = 100, 10^4,
                10^6 in chunks of at most 30000: each K's record, run_s and
                the card's busy time and idle share a run;
45. scan_planned -- phase 40's five planned paths through ``scan_steps``
                (captured under the plan, world size 1): bitwise the eager
                planned loop, launches per replay, captured ms/step beside
                the unsharded step's captured ms/step.
46. experiments_covid_gold -- ``alan_tpu_torch.experiments`` modules 2-5
                at covid 16 x 25: ``moments_vs_hmc_covid`` (two NUTS golds
                of 100 + 100 draws, QEM K=30), ``covid_k_sweep`` (SMC 2048,
                MP at K = 10, 30, 100), ``covid_corrq_probe`` (corr_Q at
                K = 30), ``covid_smc_particle_trend`` (256, 1024, 2048):
                every draw and ELBO finite, each MP step's chain launches
                those of the launch plan; z by K and variable, self-z,
                R-hat, ESS and seconds reported;
47. experiments_covid_full_quality -- ``covid_full_qem_quality`` seed 0:
                full-size covid, 12 x 50 captured QEM steps, the predictive
                log-likelihood over 137 days after each: finite, the last
                segment's ELBO above the first's, 3 + 3 chain launches a
                replay; ms a step, peak GB, latent recovery reported;
48. experiments_ffbs_coupling -- ``ffbs_coupling_sweep`` at its defaults:
                the joint FFBS route within 5 standard errors of the
                Kalman posterior at every coupling; the conditional route
                reported;
49. latent_recovery -- ``experiments.latent_recovery``: the checks of
                ``tests/test_latent_recovery.py`` at its settings and bars;
50. experiments_occupancy_collapse -- ``occupancy_collapse_probe``: the
                seven configurations at a third of their steps, coverage
                reported, ELBOs finite.

Each path (phases 3, 5, 7, 9, 11, 13, 28, each model of 31, each call of
14, 16, 17 and 19, each family of 27, and phases 42-44, 46-50) is driven with the launch counters set to 0 just
before it and read just after, and each but 13's, 19's and 27's is
profiled over two more steps or calls.  Then the ``kernels`` line (the VI
path's lowrank launches by backward mode, the RWS and corr_Q paths' chain
launches, the posterior calls' lowrank, chain and fused launches beside
the QEM paths', the factored families' lowrank launches and ms,
covid_reparam's chain launches (``canonical_launches``),
``graph_launches``: each captured path's launches per replay and its
replays, and ``strategy_launches``: phases 32-34's launches a step under
each strategy; ``mesh_launches``: phase 40's launches under a plan;
``new_path_launches``: phases 42-44's launches and phase 45's per replay;
``experiment_launches``: phases 46 and 48-50's launches, 47's per replay), the
card's name and power limit as nvidia-smi prints them, and
``{"ok": true, "device": {...}}`` last.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
#: outside the tensor cores and dense TF32 FLOP/s on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
#: exponentials per second on the special-function units: 16 per SM per
#: clock, 132 SMs, 1.98 GHz
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

MAIN_SHAPE = (1, 300, 1000, 1000, 36)   # S, P, I, J, F of grouped MovieLens K=1000
K_MAIN, STEPS = 1000, 5
#: bench.py's headline: ungrouped MovieLens QEM at K=30
K_HEADLINE = 30
#: covid's log_infected chain at K=30: nRs * K_npis chains, T = 109 days, K
COVID_CHAIN = (92 * 30, 109, 30)
#: the chain kernels' forward (3 launches) and backward ms at COVID_CHAIN
#: before the joint-shift fix-ups (commit 173b609 on an NVIDIA H100 80GB
#: HBM3 at 700 W)
CHAIN_MS_BEFORE_FIXUPS = (2.2664, 5.3013)
K_COVID = 30
LR_QEM = 0.1
#: nb, M, K, N of the two chain levels of the AR(1) model at K=1000
FUSED_MAIN = (2, 1000, 1000, 1000)
FUSED_TOP = (1, 1000, 1000, 1000)
K_AR1, AR1_ELBOS = 1000, 20
#: peaked pairs and K of the covid K sweep's K = 300 chain level
PEAKED_K300 = (192, 300)
#: the posterior read-out: grouped MovieLens K=1000 after 5 QEM steps, with
#: 5 held-out films; importance draws per call; bench_is_draws' N
POSTERIOR_QEM_STEPS, N_TEST_FILMS, N_DRAWS = 5, 5, 1000
IS_DRAWS_N = (100, 1000, 3000)
#: the covid posterior: N draws a call (``examples/runner.py``'s --predll-N)
#: and the scale of the Q centred on the data's latents
N_COVID_DRAWS, COVID_NEAR_TRUTH_SCALE = 100, 0.003

FAILURES = []
#: the fix-ups' times and bounds on the main paths' own operators, for the
#: kernels line
FIXUP_REPORTS = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    FAILURES.append(f"{phase}: {msg}")


def cuda_ms(fn, reps=7, inner=3):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def graph_ms(fn, n=20, reps=5):
    """Device time of one call: ``n`` calls captured in a CUDA graph, the
    median over ``reps`` replays (CUDA events) divided by ``n``.  For a
    kernel shorter than its host launch, where back-to-back eager calls
    time the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    del graph
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1 ------------------------------------------------------------------

def phase_build():
    from alan_tpu_torch import _build
    t0 = time.perf_counter()
    builds = _build.start_all()
    paths = [b.wait() for b in builds]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, REPO) for p in paths]})


# ---- phase 2 ------------------------------------------------------------------

def _check(res, phase, tag, name, got, want, exact, rtol, atol, f64_rule, gate=True):
    """Record ``got`` against the plain version ``want``.  Where
    ``f64_rule`` holds, a result that misses the bound passes if it is at
    least as close as the plain version to the f64 evaluation ``exact``.
    Without ``gate`` the result is only recorded."""
    import torch
    err = (got - want).abs().max().item()
    close = torch.allclose(got, want, rtol=rtol, atol=atol)
    err64 = (got.double() - exact).abs().max().item()
    plain64 = (want.double() - exact).abs().max().item()
    res[name] = {"max_abs_err": err, "within_tol": close,
                 "err_vs_f64": err64, "plain_err_vs_f64": plain64}
    if gate and not close and not (f64_rule and err64 <= plain64):
        res["ok"] = False
        fail(phase, f"{tag} {name}: max abs err {err} "
                    f"(vs f64 {err64}, plain vs f64 {plain64})")


def _operands(shape, seed, inf_bias=False):
    import numpy as np
    import torch
    S, P, I, J, F = shape
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((S, P, I, F), dtype=np.float32) * 0.5
    V = rng.standard_normal((S, J, F), dtype=np.float32) * 0.5
    D = rng.standard_normal((S, P, I), dtype=np.float32) * 2.0
    if inf_bias:
        D = np.where(rng.random((S, P, I)) < 0.3, -np.inf, 0.0).astype(np.float32)
    G = rng.standard_normal((S, P, J), dtype=np.float32)
    return [torch.from_numpy(a).cuda() for a in (U, V, D, G)]


def _value_and_grads(f, U, V, D, G):
    import torch
    ts = [t.detach().clone().requires_grad_(True) for t in (U, V, D)]
    out = f(*ts)
    grads = torch.autograd.grad(out, ts, G)
    return out.detach(), grads


def _check_case(tag, shape, seed, inf_bias=False, operands=None, f64_out=False):
    """The kernels against the plain version on ``operands`` (U, V, D, G),
    or on random ones of ``shape``; with ``f64_out`` the forward may pass by
    the f64 rule too."""
    import torch
    from alan_tpu_torch.ops import lowrank_kernel as lk
    U, V, D, G = operands if operands is not None else _operands(shape, seed, inf_bias)
    got, ggot = _value_and_grads(lk.lowrank_logsumexp, U, V, D, G)
    want, gwant = _value_and_grads(lk.reference_lowrank_logsumexp, U, V, D, G)
    exact, gexact = _value_and_grads(
        lk.reference_lowrank_logsumexp, *(t.double() for t in (U, V, D, G)))
    torch.cuda.synchronize()
    res = {"phase": "kernels", "case": tag, "shape": list(U.shape[:3]) + [V.shape[1], U.shape[3]],
           "ok": True}
    _check(res, "kernels", tag, "out", got, want, exact, 1e-5, 1e-5, f64_out)
    for n, a, b, c in zip("UVD", ggot, gwant, gexact):
        _check(res, "kernels", tag, f"d{n}", a, b, c, 1e-4, 1e-5, True)
    if not torch.isfinite(got).all():
        res["ok"] = False
        fail("kernels", f"{tag}: non-finite output")
    emit(res)
    return res, (U, V, D, G)


def _cancellation_operands(shape, seed):
    """The Normal's factors as ``ops/lowrank._normal_terms`` builds them,
    small scales, locations away from the centre (``tests/lowrank_operands.py``)."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from lowrank_operands import normal_factor_operands
    return [torch.from_numpy(a).cuda()
            for a in normal_factor_operands(shape, seed, 1.0, 0.3, 3e-4)]


def _captured_main_operands():
    """The U, V and D that the first grouped-MovieLens K=1000 QEM step hands
    to ``lowrank_logsumexp``, and the gradient that comes back to its
    output."""
    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.ops import lowrank as tlr
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    problem = ml.grouped_problem(ps, data, cov, device="cuda")
    step, state = train.qem(problem, K_MAIN, lr=0.1)
    seen = {}
    kernel = tlr.lowrank_logsumexp

    def capture(U, V, D):
        out = kernel(U, V, D)
        if not seen:
            seen.update(U=U.detach().clone(), V=V.detach().clone(), D=D.detach().clone())
            out.register_hook(lambda g: seen.setdefault("G", g.detach().clone()))
        return out

    tlr.lowrank_logsumexp = capture
    try:
        step(state, torch.Generator(device="cuda").manual_seed(1))
    finally:
        tlr.lowrank_logsumexp = kernel
    torch.cuda.synchronize()
    if "G" not in seen:
        fail("kernels", "the first MovieLens step handed no gradient back to the kernel")
        seen["G"] = torch.zeros_like(seen["D"][..., :1].expand(-1, -1, seen["V"].shape[1]))
    return [seen[k].contiguous() for k in "UVDG"]


def _lowrank_bounds(S, P, I, J, F):
    """The least times of the lowrank kernels' work at (S, P, I, J, F), in
    ms: each input read once and each output written once over the HBM
    rate, against the products as f32 FMAs on the CUDA cores (``_f32``) or
    as the kernels make them, 3xTF32 on the tensor cores with the
    exponentials on the special-function units (``_tc``).  The forward
    reads U, V, D and writes out; the backward's dD mode reads them, out
    and the cotangent and writes dD; all three gradients also write dU and
    dV, and need the scores once and the dU and dV products (2 P I J F
    operations each) with the exponentials once.  The kernels do more:
    ``MODE_DU`` and ``MODE_DV`` each recompute the scores and the
    exponentials, the count reported beside the bound."""
    f32 = 4
    fwd_bytes = f32 * (S * P * I * F + S * J * F + S * P * I + S * P * J)
    bwd_bytes = f32 * (S * P * I * F + S * J * F + 2 * S * P * I + 2 * S * P * J)
    all_bytes = bwd_bytes + f32 * (S * P * I * F + S * J * F)
    flops = 2.0 * S * P * I * J * F
    exps = S * P * I * J
    tc_ms, exp_ms = 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3, exps / PEAK_EXP_PER_S * 1e3
    fwd_byte_ms = fwd_bytes / PEAK_BYTES_PER_S * 1e3
    return {
        "fwd_bound_f32_ms": bound(fwd_bytes, flops)[0],
        "bwd_dD_bound_f32_ms": bound(bwd_bytes, flops)[0],
        "bwd_all_grads_bound_f32_ms": bound(all_bytes, 3 * flops)[0],
        "fwd_bound_tc_ms": max(fwd_byte_ms, tc_ms, exp_ms),
        "bwd_dD_bound_tc_ms": max(bwd_bytes / PEAK_BYTES_PER_S * 1e3, tc_ms, exp_ms),
        "bwd_all_grads_bound_tc_ms": max(all_bytes / PEAK_BYTES_PER_S,
                                         3 * 3 * flops / PEAK_TF32_FLOP_PER_S,
                                         exps / PEAK_EXP_PER_S) * 1e3,
        "bwd_all_grads_kernels_count_tc_ms": max(all_bytes / PEAK_BYTES_PER_S,
                                                 3 * 4 * flops / PEAK_TF32_FLOP_PER_S,
                                                 2 * exps / PEAK_EXP_PER_S) * 1e3,
        "bound_by": "operations" if max(tc_ms, exp_ms) >= fwd_byte_ms else "bytes",
        "tc_products_ms": tc_ms, "tc_exp_ms": exp_ms,
    }


def phase_kernels():
    """Kernel = plain version, and the times of both at the main shape."""
    import torch
    from alan_tpu_torch.ops import lowrank_kernel as lk
    _check_case("overhang", (2, 9, 1300, 130, 4), seed=1)
    _check_case("inf_bias", (1, 4, 64, 5, 3), seed=2, inf_bias=True)
    _check_case("inf_bias_wide", (1, 8, 1000, 300, 36), seed=3, inf_bias=True)
    _check_case("wide_f", (1, 6, 300, 200, 80), seed=4)        # two dU / dV blocks
    _check_case("chunked_f", (1, 4, 260, 150, 150), seed=8)    # F in shared-memory chunks
    _check_case("long_plate", (1, 70000, 3, 5, 2), seed=5)     # P > 65535
    _check_case("ragged_tiles", (1, 5, 1037, 203, 36), seed=6)  # off the 64 / 128 tiles
    _check_case("cancellation", None, None, f64_out=True,
                operands=_cancellation_operands((1, 8, 1000, 300, 36), seed=7))
    _check_case("captured_main_path", None, None, f64_out=True,
                operands=_captured_main_operands())
    main, (U, V, D, G) = _check_case("main_path", MAIN_SHAPE, seed=0)

    S, P, I, J, F = MAIN_SHAPE
    out, rnd = lk._launch_fwd(U, V, D)
    fwd_ms = cuda_ms(lambda: lk._launch_fwd(U, V, D))
    bwd_ms = cuda_ms(lambda: lk._launch_bwd(U, V, D, out, rnd, G, False, False))
    bwd_all_ms = cuda_ms(lambda: lk._launch_bwd(U, V, D, out, rnd, G, True, True))
    plain_fwd_ms = cuda_ms(lambda: lk.reference_lowrank_logsumexp(U, V, D), reps=5, inner=1)
    Dg = D.clone().requires_grad_(True)
    plain_out = lk.reference_lowrank_logsumexp(U, V, Dg)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, Dg, G, retain_graph=True),
                           reps=5, inner=1)
    del plain_out, Dg

    def dense_two_call():
        A = torch.baddbmm(D.reshape(S, P * I, 1), U.reshape(S, P * I, F),
                          V.transpose(1, 2))
        return torch.logsumexp(A.reshape(S, P, I, J), dim=2)
    two_call_ms = cuda_ms(dense_two_call, reps=5, inner=1)

    b = _lowrank_bounds(S, P, I, J, F)
    fwd_bound, bwd_bound = b["fwd_bound_f32_ms"], b["bwd_dD_bound_f32_ms"]
    fwd_tc, bwd_tc, tc_by = b["fwd_bound_tc_ms"], b["bwd_dD_bound_tc_ms"], b["bound_by"]
    tc_ms, exp_ms = b["tc_products_ms"], b["tc_exp_ms"]
    exps = S * P * I * J
    all_f32, all_tc = b["bwd_all_grads_bound_f32_ms"], b["bwd_all_grads_bound_tc_ms"]
    all_impl_tc = b["bwd_all_grads_kernels_count_tc_ms"]
    emit({"phase": "kernels", "case": "timing", "shape": list(MAIN_SHAPE),
          "fwd_ms": fwd_ms, "bwd_dD_ms": bwd_ms, "bwd_all_grads_ms": bwd_all_ms,
          "plain_fwd_ms": plain_fwd_ms, "plain_bwd_dD_ms": plain_bwd_ms,
          "dense_two_call_ms": two_call_ms,
          "fwd_bound_ms": fwd_bound, "bwd_dD_bound_ms": bwd_bound,
          "fwd_bound_tc_ms": fwd_tc, "bwd_dD_bound_tc_ms": bwd_tc,
          "tc_products_ms": tc_ms, "tc_exp_ms": exp_ms,
          "fwd_share_f32": fwd_bound / fwd_ms, "fwd_share_tc": fwd_tc / fwd_ms,
          "bwd_dD_share_f32": bwd_bound / bwd_ms, "bwd_dD_share_tc": bwd_tc / bwd_ms,
          "bwd_all_grads_bound_ms": all_f32, "bwd_all_grads_bound_tc_ms": all_tc,
          "bwd_all_grads_share_tc": all_tc / bwd_all_ms,
          "bwd_all_grads_kernels_count_tc_ms": all_impl_tc,
          "exp_per_call": exps, "clocks_power": nvidia_smi_clocks()})
    return {
        "fwd": dict(max_abs_err=main["out"]["max_abs_err"], ms=fwd_ms,
                    plain_ms=plain_fwd_ms, bound_ms=fwd_tc, bound_by=tc_by,
                    bound_f32_ms=fwd_bound, dense_two_call_ms=two_call_ms),
        "bwd": dict(max_abs_err=max(main[k]["max_abs_err"] for k in ("dU", "dV", "dD")),
                    ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bwd_tc, bound_by=tc_by,
                    bound_f32_ms=bwd_bound, dense_two_call_ms=None,
                    all_grads_ms=bwd_all_ms, all_grads_bound_ms=all_tc,
                    all_grads_bound_f32_ms=all_f32),
    }


# ---- phase 2, the timeseries kernels ------------------------------------------

def _chain_operands(shape, seed, inf=False):
    import numpy as np
    import torch
    B, T, K = shape
    rng = np.random.default_rng(seed)
    ms = (rng.standard_normal((B, T, K, K), dtype=np.float32) * 2 - 1)
    if inf:
        ms[:, 2, :, 3] = -np.inf
        ms[:, 3, 1, :] = -np.inf
    W = rng.standard_normal((B, K, K), dtype=np.float32)
    return torch.from_numpy(ms).cuda(), torch.from_numpy(W).cuda()


def _plain_chain(x):
    """The plain version of the whole chain, one tree level at a time."""
    from alan_tpu_torch.ops import smallk_kernel as sk
    while x.shape[1] != 1:
        x = sk.reference_level(x)
    return x[:, 0]


def _chain_value_and_grad(chain, ms, W):
    import torch
    x = ms.clone().requires_grad_(True)
    y = chain(x)
    (g,) = torch.autograd.grad((y * W).sum(), [x])
    return y.detach(), g


def _check_chain(tag, shape, seed, inf=False):
    import torch
    from alan_tpu_torch.ops import smallk_kernel as sk
    ms, W = _chain_operands(shape, seed, inf)
    before = (sk.FWD_LAUNCHES, sk.BWD_LAUNCHES)
    got, ggot = _chain_value_and_grad(sk.chain_logmmexp_smallk, ms, W)
    torch.cuda.synchronize()
    launches = [sk.FWD_LAUNCHES - before[0], sk.BWD_LAUNCHES - before[1]]
    want, gwant = _chain_value_and_grad(_plain_chain, ms, W)
    exact, gexact = _chain_value_and_grad(_plain_chain, ms.double(), W.double())
    torch.cuda.synchronize()
    plan = sk.launch_plan(shape[1], shape[2])
    res = {"phase": "kernels", "kernel": "smallk_logmmexp", "case": tag,
           "chains_T_K": list(shape), "plan": plan, "launches": launches,
           "bitwise": [bool(torch.equal(got, want)), bool(torch.equal(ggot, gwant))],
           "ok": True}
    _check(res, "kernels", tag, "out", got, want, exact, 1e-5, 1e-5, False)
    _check(res, "kernels", tag, "dms", ggot, gwant, gexact, 1e-4, 1e-5, True)
    if not torch.isfinite(got).all():
        res["ok"] = False
        fail("kernels", f"{tag}: non-finite chain")
    if launches != [len(plan)] * 2:
        res["ok"] = False
        fail("kernels", f"{tag}: {launches} launches, the plan {plan} has {len(plan)}")
    emit(res)
    return res, ms


def _levels(T):
    """Pairs per tree level of a chain of T operators."""
    out = []
    while T != 1:
        out.append(T // 2)
        T = (T + 1) // 2
    return out


def phase_chain_kernels():
    """The small-K chain kernels against their plain version on whole
    chains, and their times over covid's chain."""
    import ctypes
    import torch
    from alan_tpu_torch.ops import logmmexp as lm
    from alan_tpu_torch.ops import native
    from alan_tpu_torch.ops import smallk_kernel as sk
    lib = native.load("smallk_logmmexp", sk._SIGNATURES)
    sizes = {f"K{K}_m{m}_{d}_{direct}": [lib.smallk_smem_bytes(K, m, int(d == "bwd"), direct),
                                     sk.segment_smem(K, m, d == "bwd", direct)]
             for K in (1, 2, 30, 45, 100, 128) for m in (1, 2, 3)
             for d in ("fwd", "bwd") for direct in (0, 1)}
    if any(a != b for a, b in sizes.values()):
        fail("kernels", f"shared memory: the kernel and the planner disagree {sizes}")
    log_bad = sk.log_mismatches()
    if log_bad:
        fail("kernels", f"the kernels' logarithm differs from logf at {log_bad} floats")
    _check_chain("K2", (130, 8, 2), seed=21)
    _check_chain("K100_odd_T", (16, 5, 100), seed=22)
    records = ctypes.c_int(-1)

    def fix_layout(K, m, bwd):
        """The kernel's and the planner's (shared bytes, device floats of
        the backward's records)."""
        nbytes = lib.smallk_fixup_smem_bytes(K, m, int(bwd), ctypes.byref(records))
        _, rec, want = sk.fixup_layout(K, m, bwd)
        return [[nbytes, records.value],
                [want, sk.fixup_records(K, m) if bwd and want and not rec else 0]]
    fix_sizes = {f"K{K}_m{m}_{'bwd' if bwd else 'fwd'}": fix_layout(K, m, bwd)
                 for K in (1, 2, 30, 45, 100, 128) for m in (1, 2, 3, 4, 5)
                 for bwd in (False, True)}
    if any(a != b for a, b in fix_sizes.values()):
        fail("kernels", f"fix-up shared memory: the kernel and the planner disagree {fix_sizes}")
    _check_chain("inf", (40, 7, 30), seed=23, inf=True)
    for T in (3, 7, 8, 9, 17):                  # around covid's segment of 8
        _check_chain(f"K30_T{T}", (40, T, 30), seed=24 + T)
    _check_chain("K45_T9", (24, 9, 45), seed=25)   # segments of 4
    main, ms = _check_chain("covid_chain", COVID_CHAIN, seed=20)
    peaked = _check_peaked_chain("covid_peaked", COVID_CHAIN, seed=26)

    B, T, K = COVID_CHAIN
    _chain_times(ms)
    smi = [nvidia_smi_clocks()]
    times = _chain_times(ms)    # timed again, beside the sample
    fwd_ms, bwd_ms = times["fwd_ms"], times["bwd_ms"]

    def plain_fwd():
        with torch.no_grad():
            _plain_chain(ms)

    def dense_fwd():
        with torch.no_grad():
            lm.chain_logmmexp(ms)

    plain_fwd_ms = cuda_ms(plain_fwd, reps=5, inner=1)
    os.environ["ALAN_TPU_NO_SMALLK_CHAIN"] = "1"
    try:
        dense_fwd_ms = cuda_ms(dense_fwd, reps=5, inner=1)
    finally:
        del os.environ["ALAN_TPU_NO_SMALLK_CHAIN"]
    xg = ms.clone().requires_grad_(True)
    loss = _plain_chain(xg).sum()
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss, xg, retain_graph=True),
                           reps=5, inner=1)
    del loss, xg

    pairs = sum(_levels(T))                 # 108 pair products per chain
    op = 4 * B * K * K                      # one operator of every chain, bytes
    # the whole chain as one call: each input read once, each output written once
    fwd_bound, fwd_by = bound(T * op + op, 2.0 * pairs * B * K ** 3)
    bwd_bound, bwd_by = bound(T * op + op + T * op, 6.0 * pairs * B * K ** 3)
    emit({"phase": "kernels", "kernel": "smallk_logmmexp", "case": "timing",
          "chains_T_K": list(COVID_CHAIN), "plan": sk.launch_plan(T, K),
          "levels": len(_levels(T)), "pair_products": pairs,
          "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "with_fixups": True,
          "fwd_ms_before_fixups": CHAIN_MS_BEFORE_FIXUPS[0],
          "bwd_ms_before_fixups": CHAIN_MS_BEFORE_FIXUPS[1],
          "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
          "dense_route_fwd_ms": dense_fwd_ms,
          "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
          "fwd_bound_share": fwd_bound / fwd_ms, "bwd_bound_share": bwd_bound / bwd_ms,
          "apart": times, "peaked": {k: v for k, v in peaked.items() if k.endswith("_ms")
                                     or k.startswith(("joint", "flagged", "fixup"))},
          "log_mismatches_in_FLT_MIN_to_128": log_bad,
          "clocks_power": smi})

    def apart(d, way):
        return {"fast_ms": d[f"fast_{way}_ms"], "fixup_ms": d[f"fixup_{way}_ms"],
                "fixup_bound_ms": d[f"fixup_{way}_bound_ms"],
                "fixup_bound_share": d[f"fixup_{way}_bound_share"]}
    return {
        "fwd": dict(max_abs_err=main["out"]["max_abs_err"], ms=fwd_ms,
                    plain_ms=plain_fwd_ms, bound_ms=fwd_bound, bound_by=fwd_by,
                    dense_route_ms=dense_fwd_ms, **apart(times, "fwd"),
                    peaked_ms=peaked["fwd_ms"], peaked=apart(peaked, "fwd"),
                    peaked_joint_entries=peaked["joint_entries"],
                    peaked_max_abs_err=peaked["out"]["max_abs_err"]),
        "bwd": dict(max_abs_err=main["dms"]["max_abs_err"], ms=bwd_ms,
                    plain_ms=plain_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_by,
                    dense_route_ms=None, **apart(times, "bwd"),
                    peaked_ms=peaked["bwd_ms"], peaked=apart(peaked, "bwd"),
                    peaked_flagged_pairs=peaked["flagged_pairs_bwd"],
                    peaked_max_abs_err=peaked["dms"]["max_abs_err"]),
    }


def _flagged_pairs(flags, n, m):
    """Pair products in the segment jobs that ``flags`` (a launch's, over
    (nB, n, K, K) at m) marks: a segment of len operators holds len - 1."""
    import torch
    S = 1 << m
    nseg = (n + S - 1) >> m
    seg = torch.arange(flags.numel(), device=flags.device) % nseg
    lens = torch.clamp(n - seg * S, max=S)
    return int(((lens - 1) * (flags != 0)).sum())


def _chain_times(ms, seed=0):
    """CUDA-event ms over ``ms`` (nB, T, K, K) of the chain's launches,
    forward (each with its fix-up, keeping the state the backward takes)
    and backward from seeded random gradients, and of the fast launches and
    the fix-ups apart (the forward's also without that state).  Each
    fix-up's bound counts the exponentials this data needs: K a joint
    entry forward, 2 K^3 a pair of a flagged segment backward (the sum that
    gives log(sum), then the weights), at PEAK_EXP_PER_S."""
    import torch
    from alan_tpu_torch.ops import smallk_kernel as sk
    B, T, K, _ = ms.shape
    plan = sk.launch_plan(T, K)
    xs, outs, fflags, saves, x, joints = [], [], [], [], ms, 0
    for m in plan:
        out, flags = sk.fast_fwd(x, m)
        saved, n = _joint_counted(lambda: sk.fixup_fwd(x, out, flags, m, save=True))
        joints += n
        xs.append(x)
        outs.append(out)
        fflags.append(flags)
        saves.append(saved)
        x = out
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gs = [torch.randn(o.shape, device="cuda", generator=gen) for o in outs]
    # the backward takes the forward's flags and saved state, as the
    # autograd launch does; the forward keeps that state, as on a path
    # that wants gradients
    dxs = [sk.fixup_bwd(x, g, sk.fast_bwd(x, g, m, f)[0], f, sv, m)
           for x, g, f, sv, m in zip(xs, gs, fflags, saves, plan)]
    pairs = sum(_flagged_pairs(f, x.shape[1], m) for f, x, m in zip(fflags, xs, plan))

    def fwd():
        x = ms
        for m in plan:
            x = sk._launch_fwd(x, m, save=True)[0]

    def bwd():
        for x, g, f, sv, m in zip(xs, gs, fflags, saves, plan):
            sk._launch_bwd(x, g, m, f, sv)
    res = {"fwd_ms": cuda_ms(fwd), "bwd_ms": cuda_ms(bwd),
           "fast_fwd_ms": cuda_ms(lambda: [sk.fast_fwd(x, m) for x, m in zip(xs, plan)]),
           "fixup_fwd_ms": cuda_ms(lambda: [sk.fixup_fwd(x, o, f, m, save=True)
                                            for x, o, f, m in zip(xs, outs, fflags, plan)]),
           "fixup_fwd_nograd_ms": cuda_ms(lambda: [sk.fixup_fwd(x, o, f, m) for x, o, f, m
                                                   in zip(xs, outs, fflags, plan)]),
           "fast_bwd_ms": cuda_ms(lambda: [sk.fast_bwd(x, g, m, f)
                                           for x, g, f, m in zip(xs, gs, fflags, plan)]),
           "fixup_bwd_ms": cuda_ms(lambda: [sk.fixup_bwd(x, g, d, f, sv, m) for x, g, d, f, sv, m
                                            in zip(xs, gs, dxs, fflags, saves, plan)]),
           "saved_gb": sum(4 * sv.numel() for sv in saves) / 1e9,
           "joint_entries": joints, "flagged_pairs_bwd": pairs,
           "fixup_fwd_bound_ms": joints * K / PEAK_EXP_PER_S * 1e3,
           "fixup_bwd_bound_ms": pairs * 2.0 * K ** 3 / PEAK_EXP_PER_S * 1e3}
    res["fixup_fwd_bound_share"] = res["fixup_fwd_bound_ms"] / res["fixup_fwd_ms"]
    res["fixup_bwd_bound_share"] = res["fixup_bwd_bound_ms"] / res["fixup_bwd_ms"]
    return res


def _peaked_chain(shape, seed):
    """Covid's chain with peaked transitions: entry (i, j) of operator t is
    log N(x[t + 1, j]; x[t, i], 0.01), each day's K particles drawn with a
    spread of 1 around a random walk (numpy seed): as covid's transitions,
    whose noise scale is exp(log(0.01)), under a proposal of scale 1."""
    import numpy as np
    import torch
    B, T, K = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T + 1, K)) + np.cumsum(rng.normal(0, 0.3, (B, T + 1, 1)), axis=1)
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    d = (x[:, 1:, None, :] - x[:, :-1, :, None]) / 0.01
    return -0.5 * d * d - math.log(0.01 * math.sqrt(2 * math.pi))


def _f64_logmmexp_exact(A, B):
    """``logsumexp_k(A[..., i, k] + B[..., k, j])`` in float64, the K^3
    cross sum."""
    import torch
    return torch.logsumexp(A.double()[..., :, :, None] + B.double()[..., None, :, :], -2)


def _f64_chain(x):
    """The chain of (nB, T, K, K) by the kernels' tree, each product
    :func:`_f64_logmmexp_exact`."""
    import torch
    x = x.double()
    while x.shape[1] != 1:
        n = x.shape[1]
        prod = _f64_logmmexp_exact(x[:, 0:n - n % 2:2], x[:, 1:n:2])
        x = torch.cat([prod, x[:, n - 1:]], 1) if n % 2 else prod
    return x[:, 0]


def _joint_counted(fn):
    """``fn()``'s result and the entries that took the joint shift in it
    (``logmmexp_kernel.JOINT_COUNT`` on the card)."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    old, lk.JOINT_COUNT = lk.JOINT_COUNT, count
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        lk.JOINT_COUNT = old
    return out, int(count.item())


def _check_peaked_chain(tag, shape, seed, n_f64=60):
    """The chain kernels and their fix-ups on peaked operators against the
    repaired plain version (values rtol/atol 1e-5, gradients 1e-4) and, on
    the first ``n_f64`` chains, against the exact float64 chain (values
    1e-5 of max(1, |value|), gradients rtol/atol 1e-4); the gradient is the
    chain's result summed out, as an ELBO takes it.  The entries that took
    the joint shift, by kernel and plain version; times of the launches."""
    import torch
    from alan_tpu_torch.ops import smallk_kernel as sk
    ms = _peaked_chain(shape, seed)
    lse = lambda y: torch.logsumexp(y.flatten(-2), -1).sum()

    def run(chain, x0):
        x = x0.clone().requires_grad_(True)
        y = chain(x)
        (g,) = torch.autograd.grad(lse(y), [x])
        return y.detach(), g
    before = (sk.FWD_LAUNCHES, sk.BWD_LAUNCHES)
    (got, ggot), joints_k = _joint_counted(lambda: run(sk.chain_logmmexp_smallk, ms))
    launches = [sk.FWD_LAUNCHES - before[0], sk.BWD_LAUNCHES - before[1]]
    (want, gwant), joints_p = _joint_counted(lambda: run(_plain_chain, ms))
    sub = ms[:n_f64].double().requires_grad_(True)
    y64 = _f64_chain(sub)
    (g64,) = torch.autograd.grad(lse(y64), [sub])
    B, T, K = shape
    entries = sum(_levels(T)) * B * K * K
    plan = sk.launch_plan(T, K)
    res = {"phase": "kernels", "kernel": "smallk_logmmexp", "case": tag,
           "chains_T_K": list(shape), "plan": plan, "launches": launches,
           "joint_entries_kernel": joints_k, "joint_entries_plain": joints_p,
           "entries": entries, "joint_share": joints_k / entries, "ok": True}
    _check(res, "kernels", tag, "out", got, want, want.double(), 1e-5, 1e-5, False)
    _check(res, "kernels", tag, "dms", ggot, gwant, gwant.double(), 1e-4, 1e-4, False)
    err64 = ((got[:n_f64].double() - y64.detach()).abs()
             / y64.detach().abs().clamp(min=1.0)).max().item()
    gerr64 = ((ggot[:n_f64].double() - g64).abs() - 1e-4 * g64.abs()).max().item()
    res["f64"] = {"chains": n_f64, "value_max_rel_err": err64,
                  "grad_max_err_over_rtol": gerr64}
    if err64 > 1e-5 or gerr64 > 1e-4:
        res["ok"] = False
        fail("kernels", f"{tag}: against f64 {res['f64']}")
    if joints_k == 0 or abs(joints_k - joints_p) > joints_p // 10000:
        res["ok"] = False
        fail("kernels", f"{tag}: joint entries kernel {joints_k}, plain {joints_p}")
    if launches != [len(plan)] * 2 or not torch.isfinite(got).all():
        res["ok"] = False
        fail("kernels", f"{tag}: {launches} launches or a non-finite chain")
    res.update(_chain_times(ms))
    emit(res)
    return res


def _fused_operands(shape, seed, inf=False):
    import numpy as np
    import torch
    nb, M, K, N = shape
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nb, M, K), dtype=np.float32) * 3
    B = rng.standard_normal((nb, K, N), dtype=np.float32) * 3
    if inf:
        A[:, ::7] = -np.inf
        B[:, :, 5] = -np.inf
    return torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()


def _small_sum_operands(shape, seed, gap, edge, top):
    """A's row maxima at k = 0 and B's column maxima at k = 1, each within 1
    of ``top``; every other entry ``gap`` (a uniform range) below its max,
    and the entries at the other operand's max k ``edge`` below, so every
    product of two exponentials lies in e^-[2 gap] (= e^-[edge]).  The
    shifts put out near 0, so the 1e-5 tolerance bounds the sum's relative
    error."""
    import numpy as np
    import torch
    nb, M, K, N = shape
    rng = np.random.default_rng(seed)
    c = rng.uniform(top - 1, top + 1, (nb, M, 1))
    d = rng.uniform(top - 1, top + 1, (nb, 1, N))
    A = c - rng.uniform(*gap, (nb, M, K))
    B = d - rng.uniform(*gap, (nb, K, N))
    A[:, :, 0], B[:, 1, :] = c[:, :, 0], d[:, 0, :]
    A[:, :, 1] = c[:, :, 0] - rng.uniform(*edge, (nb, M))
    B[:, 0, :] = d[:, 0, :] - rng.uniform(*edge, (nb, N))
    return (torch.from_numpy(A.astype(np.float32)).cuda(),
            torch.from_numpy(B.astype(np.float32)).cuda())


def _f64_logmmexp(A, B):
    """The function in float64, with float32's tiny inside the log."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    a_max, b_max = lk._shifts(A.double(), B.double())
    C = torch.matmul(torch.exp(A.double() - a_max), torch.exp(B.double() - b_max))
    return torch.log(C + lk._TINY) + a_max + b_max


def _check_fused(tag, A, B, gate=True):
    """The fused kernel against its plain version at rtol/atol 1e-5 (only
    reported where ``gate`` is false), with both beside float64."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    before = lk.LAUNCHES
    got = lk.logmmexp_fused(A, B)
    torch.cuda.synchronize()
    launches = lk.LAUNCHES - before
    want = lk.reference_logmmexp(A, B)
    exact = _f64_logmmexp(A, B)
    torch.cuda.synchronize()
    nb, M, K = A.shape
    res = {"phase": "kernels", "kernel": "logmmexp", "case": tag,
           "nb_M_K_N": [nb, M, K, B.shape[2]],
           "tile_n": lk.tile_n(nb, M, B.shape[2], lk._sms(A.device)),
           "launches": launches, "gated": gate, "ok": True}
    _check(res, "kernels", tag, "out", got, want, exact, 1e-5, 1e-5, False, gate)
    if not gate:
        res["first"] = {"kernel": got[0, 0, 0].item(), "plain": want[0, 0, 0].item(),
                        "f64": exact[0, 0, 0].item()}
    if not torch.isfinite(got).all() or launches != 1:
        res["ok"] = False
        fail("kernels", f"{tag}: non-finite output or {launches} launches")
    emit(res)
    return res


def _check_prepass(tag, A, B):
    """The pre-pass kernels against their plain version: bitwise."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    nb, M, K = A.shape
    N = B.shape[2]
    bn = lk.tile_n(nb, M, N, lk._sms(A.device))
    got = lk._prepass(A, B, bn)
    want = lk.reference_prepass(A, B, bn)
    torch.cuda.synchronize()
    diff = [int((g != w).sum().item()) for g, w in zip(got, want)]
    res = {"phase": "kernels", "kernel": "logmmexp_prepass", "case": tag,
           "nb_M_K_N": [nb, M, K, N], "tile_n": bn,
           "differing_amax_bmax_scratch": diff, "scratch_floats": got[2].numel(),
           "ok": diff == [0, 0, 0]}
    if not res["ok"]:
        fail("kernels", f"pre-pass {tag}: {diff} elements differ from the plain version")
    emit(res)


def _time_fused(shape, A, B):
    """Device times of the pre-pass, the product and the whole (CUDA graphs
    of 20 calls: the kernels are shorter than their host calls), beside the
    plain version's, the whole's eager time (back-to-back calls, host
    included) and the bounds."""
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    nb, M, K, N = shape
    bn = lk.tile_n(nb, M, N, lk._sms(A.device))
    pre = lk._prepass(A, B, bn)
    prepass_ms = graph_ms(lambda: lk._prepass(A, B, bn))
    product_ms = graph_ms(lambda: lk._product(*pre, nb, M, K, N, bn))
    ms = graph_ms(lambda: lk._launch(A, B))
    eager_ms = cuda_ms(lambda: lk._launch(A, B))
    # the plain version finds the entries its repair takes on the host, so
    # no graph holds it: back-to-back calls, host included
    plain_ms = cuda_ms(lambda: lk.reference_logmmexp(A, B), reps=5, inner=1)
    io_bytes = 4 * nb * (M * K + K * N + M * N)
    flops = 2.0 * nb * M * K * N
    f32_ms, _ = bound(io_bytes, flops)
    tc_ms = max(io_bytes / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_FLOP_PER_S) * 1e3
    # the pre-pass reads A and B and writes the maxes and the scratch; the
    # product reads the scratch and the maxes and writes out
    scratch = 4 * lk.scratch_floats(nb, M, K, N, bn)
    pre_bytes = 4 * nb * (M * K + K * N + M + N) + scratch
    prod_bound = max((scratch + 4 * nb * (M + N + M * N)) / PEAK_BYTES_PER_S,
                     3 * flops / PEAK_TF32_FLOP_PER_S) * 1e3
    res = {"phase": "kernels", "kernel": "logmmexp", "case": "timing",
           "nb_M_K_N": list(shape), "tile_n": bn, "ms": ms, "prepass_ms": prepass_ms,
           "product_ms": product_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "bound_f32_ms": f32_ms, "bound_3xtf32_ms": tc_ms,
           "share_f32": f32_ms / ms, "share_3xtf32": tc_ms / ms,
           "prepass_bound_ms": pre_bytes / PEAK_BYTES_PER_S * 1e3,
           "product_bound_ms": prod_bound, "clocks_power": nvidia_smi_clocks()}
    emit(res)
    return res


def phase_fused_kernel():
    """The fused log-matmul: pre-pass bitwise, the whole at rtol/atol 1e-5
    on every case, and its times at both levels of the AR(1) chain."""
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    from alan_tpu_torch.ops import native
    lib = native.load("logmmexp", lk._SIGNATURES)
    sizes = {f"{s}_{bn}": [lib.logmmexp_scratch_floats(*s, bn), lk.scratch_floats(*s, bn)]
             for s in ((3, 130, 257, 77), FUSED_MAIN, (1, 1, 1, 1)) for bn in lk.TILE_WIDTHS}
    if any(a != b for a, b in sizes.values()):
        fail("kernels", f"scratch floats: the kernel and the plain version disagree {sizes}")
    ragged = _fused_operands((3, 130, 257, 77), seed=31)
    _check_prepass("ragged", *ragged)
    _check_fused("ragged", *ragged)
    inf_rows = _fused_operands((2, 70, 300, 65), seed=32, inf=True)
    _check_prepass("inf_rows", *inf_rows)
    _check_fused("inf_rows", *inf_rows)
    _check_fused("k128_batch", *_fused_operands((6, 128, 128, 128), seed=33))
    # every product in [e^-80, e^-78]: above FLT_MIN, and + FLT_MIN counts
    _check_fused("small_sums", *_small_sum_operands((2, 300, 128, 300), 34, (39, 40),
                                                    (78, 80), 37))
    _check_fused("small_sums_k1000", *_small_sum_operands((1, 300, 1000, 300), 35,
                                                          (39, 40), (78, 80), 37))
    # every product in [e^-110, e^-90], below FLT_MIN: reported, not gated
    _check_fused("below_flt_min", *_small_sum_operands((2, 300, 128, 300), 36, (45, 55),
                                                       (90, 110), 43), gate=False)
    peaked = _check_peaked_fused("peaked_k128", (60, 128), seed=38)
    # the chain of the covid K sweep's K = 300 point (16 regions, 25 days:
    # 192 pairs at its first level), float64 on its first 24 products
    k300 = _check_peaked_fused("peaked_k300", PEAKED_K300, seed=39, n_f64=24, f64_chunk=4)
    times = {}
    for tag, shape, seed in (("ar1_top", FUSED_TOP, 37), ("ar1_level", FUSED_MAIN, 30)):
        A, B = _fused_operands(shape, seed)
        _check_prepass(tag, A, B)
        times[tag] = (_check_fused(tag, A, B), _time_fused(shape, A, B))
    main, t = times["ar1_level"]
    top = times["ar1_top"][1]
    return dict(max_abs_err=main["out"]["max_abs_err"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_3xtf32_ms"],
                bound_by="operations", bound_f32_ms=t["bound_f32_ms"],
                prepass_ms=t["prepass_ms"], product_ms=t["product_ms"], eager_ms=t["eager_ms"],
                top_level_ms=top["ms"], dense_route_ms=t["plain_ms"],
                peaked_k128_ms=peaked["ms"], peaked_k128_bwd_ms=peaked["bwd_ms"],
                peaked_k128_max_abs_err=peaked["out"]["max_abs_err"],
                peaked_k300={k: k300[k] for k in (
                    "ms", "fixup_ms", "fixup_bwd_ms", "fixup_bound_ms", "bwd_ms",
                    "joint_entries_kernel", "entries", "plain_ms", "kept_bytes",
                    "peak_growth_saving_bytes")},
                peaked_k300_max_abs_err=k300["out"]["max_abs_err"])


def _check_peaked_fused(tag, shape, seed, n_f64=None, f64_chunk=None):
    """The fused kernel with its fix-ups on peaked operators (covid's
    scales at K: ``_peaked_chain``'s first two operators of each of ``nb``
    chains) against the repaired plain version (value rtol/atol 1e-5, the
    gradients of a random linear function of the product 1e-4) and an exact
    float64 evaluation (of the first ``n_f64`` products, ``f64_chunk`` at a
    time); one forward and one backward fix-up launch; the entries that
    took the joint shift, kernel and plain (within 0.1%); the backward
    bitwise the same in two calls; times: the whole forward, the forward
    fix-up alone (the whole less the pre-pass and product), the backward,
    the backward fix-up alone, each fix-up beside its bound (K exponentials
    a joint entry at PEAK_EXP_PER_S)."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    nb, K = shape
    AB = _peaked_chain((nb, 2, K), seed)
    A, B = AB[:, 0].contiguous(), AB[:, 1].contiguous()
    W = torch.randn((nb, K, K), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))

    def run(f, A, B, W):
        a, b = A.clone().requires_grad_(True), B.clone().requires_grad_(True)
        y = f(a, b)
        return (y.detach(), *torch.autograd.grad((y * W.to(y.dtype)).sum(), [a, b]))
    before = (lk.LAUNCHES, lk.BWD_LAUNCHES)
    got, joints_k = _joint_counted(lambda: run(lk.logmmexp_fused, A, B, W))
    launches = [lk.LAUNCHES - before[0], lk.BWD_LAUNCHES - before[1]]
    want, joints_p = _joint_counted(lambda: run(lk.reference_logmmexp, A, B, W))
    n = n_f64 or nb
    step = f64_chunk or n
    parts = [run(_f64_logmmexp_exact, A[c:c + step].double(), B[c:c + step].double(),
                 W[c:c + step]) for c in range(0, n, step)]
    exact = [torch.cat(p) for p in zip(*parts)]
    res = {"phase": "kernels", "kernel": "logmmexp", "case": tag, "nb_M_K_N": [nb, K, K, K],
           "launches_fwd_bwd": launches, "joint_entries_kernel": joints_k,
           "joint_entries_plain": joints_p, "entries": nb * K * K, "f64_products": n,
           "ok": True}
    for name, g, w, e, tol in zip(("out", "dA", "dB"), got, want, exact, (1e-5, 1e-4, 1e-4)):
        _check(res, "kernels", tag, name, g, w, w.double(), tol, tol, False)
        # float64 covers the first n products
        res[name]["err_vs_f64"] = (g[:n].double() - e).abs().max().item()
        res[name]["plain_err_vs_f64"] = (w[:n].double() - e).abs().max().item()
        bad = ((g[:n].double() - e).abs() - tol * e.abs()).max().item()
        res[name]["f64_max_err_over_rtol"] = bad
        if bad > tol:
            res["ok"] = False
            fail("kernels", f"{tag} {name}: against f64 {bad}")
    if launches != [1, 1] or joints_k == 0 or abs(joints_k - joints_p) > joints_p // 1000:
        res["ok"] = False
        fail("kernels", f"{tag}: launches {launches}, joint entries {joints_k} / {joints_p}")
    _, flags, kept = lk._launch(A, B, save=True)
    g = W.clone()
    first = lk._launch_bwd(A, B, flags, kept, g)
    second = lk._launch_bwd(A, B, flags, kept, g)
    res["bwd_bitwise_repeatable"] = all(torch.equal(x, y) for x, y in zip(first, second))
    if not res["bwd_bitwise_repeatable"]:
        res["ok"] = False
        fail("kernels", f"{tag}: two backward calls differ")
    res.update(_fixup_times(A, B, g, joints_k))
    # the plain version finds its flagged entries on the host: no graph
    res["plain_ms"] = cuda_ms(lambda: lk.reference_logmmexp(A, B), reps=5, inner=1)
    emit(res)
    return res


def _peak_growth(fn):
    """Bytes by which ``fn()`` raises the card's allocated memory at its
    peak, what it returns included."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    del out
    return grown


def _fixup_times(A, B, g, joints):
    """Device ms (CUDA graphs of 20) of the fused route on (A, B): the
    forward as a gradient-free call makes it and as one that keeps state
    for the backward, the pre-pass and product alone, the forward fix-up
    (the difference) and the backward and its fix-up alone, given the
    output's gradient ``g``; each fix-up beside its bound, K exponentials
    a joint entry (the backward forms each weight twice, so it takes 2 K);
    the bytes kept for the backward, and the peak memory growth of the
    forward with and without them and of the backward."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    nb, M, K = A.shape
    N = B.shape[2]
    bn = lk.tile_n(nb, M, N, lk._sms(A.device))
    _, flags, kept = lk._launch(A, B, save=True)
    dA, dB = torch.zeros_like(A), torch.zeros_like(B)
    res = {"ms": graph_ms(lambda: lk._launch(A, B)),
           "saving_ms": graph_ms(lambda: lk._launch(A, B, save=True)),
           "prepass_product_ms": graph_ms(
               lambda: lk._product(*lk._prepass(A, B, bn), nb, M, K, N, bn)),
           "bwd_ms": graph_ms(lambda: lk._launch_bwd(A, B, flags, kept, g)),
           "fixup_bwd_ms": graph_ms(lambda: lk._fixup_bwd(A, B, g, kept, dA, dB)),
           "fixup_bound_ms": joints * K / PEAK_EXP_PER_S * 1e3}
    res.update(kept_bytes=sum(t.numel() * t.element_size() for t in kept),
               peak_growth_bytes=_peak_growth(lambda: lk._launch(A, B)),
               peak_growth_saving_bytes=_peak_growth(lambda: lk._launch(A, B, save=True)),
               bwd_peak_growth_bytes=_peak_growth(lambda: lk._launch_bwd(A, B, flags, kept, g)))
    res["fixup_ms"] = res["ms"] - res["prepass_product_ms"]
    res["fixup_bound_share"] = res["fixup_bound_ms"] / max(res["fixup_ms"], 1e-9)
    res["fixup_bwd_bound_share"] = res["fixup_bound_ms"] / res["fixup_bwd_ms"]
    return res


# ---- phases 3 to 7 --------------------------------------------------------------

def _state_finite(state):
    """Every parameter of (stateP, stateQ, ...) is finite."""
    import torch
    return all(bool(torch.isfinite(v.data).all())
               for part in state[:2] for group in part.values() for v in group.values())


def _max_state_diff(a, b):
    diffs = {}
    for group in ("qem_params", "qem_means"):
        for k, v in a[group].items():
            w = b[group][k].with_dims_front(list(v.dims))
            diffs[k] = (v.data - w.data).abs().max().item()
    return diffs


def _counters():
    from alan_tpu_torch.ops import logmmexp_kernel as fk
    from alan_tpu_torch.ops import lowrank_kernel as lk
    from alan_tpu_torch.ops import smallk_kernel as sk
    return [(lk, "FWD_LAUNCHES", "lowrank_fwd"), (lk, "BWD_LAUNCHES", "lowrank_bwd"),
            (lk, "DD_LAUNCHES", "lowrank_bwd_dD"), (lk, "DU_LAUNCHES", "lowrank_bwd_dU"),
            (lk, "DV_LAUNCHES", "lowrank_bwd_dV"),
            (sk, "FWD_LAUNCHES", "smallk_fwd"), (sk, "BWD_LAUNCHES", "smallk_bwd"),
            (fk, "LAUNCHES", "logmmexp")]


def zero_counts():
    for mod, attr, _ in _counters():
        setattr(mod, attr, 0)


def read_counts():
    return {key: getattr(mod, attr) for mod, attr, key in _counters()}


def _finite(xs):
    return all(x == x and abs(x) != float("inf") for x in xs)


def _train_path(phase, step, state, K, must_launch, info, check=None):
    """``STEPS`` timed training steps after a warm-up, with the launch
    counters zeroed just before and read after every step: each kernel in
    ``must_launch`` must run in every step.  ``check(state)``, if given,
    returns a number that must be 0 after every step (read after the timed
    loop).  Then a profile of two more steps.  Returns (state, launches
    over the timed steps, the result line, the profile line)."""
    import torch
    from alan_tpu_torch.utils import assert_full_f32
    assert_full_f32(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, _ = step(state, gen)                # warm-up (cuBLAS handles, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    elbos, per_step, checks = [], [], []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, elbo = step(state, gen)
        elbos.append(elbo)
        per_step.append(read_counts())
        if check is not None:
            checks.append(check(state))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    launches = per_step[-1]
    steps_without = [k for k in must_launch
                     if any(b[k] - a[k] < 1 for a, b in
                            zip([dict.fromkeys(launches, 0)] + per_step, per_step))]
    elbos = [float(e) for e in elbos]
    res = {"phase": phase, **info, "K": K, "steps": STEPS, "ms_per_step": ms,
           "elbos": elbos, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": True}
    if not _finite(elbos):
        res["ok"] = False
        fail(phase, f"non-finite ELBO {elbos}")
    if not _state_finite(state):
        res["ok"] = False
        fail(phase, "non-finite state")
    if steps_without:
        res["ok"] = False
        fail(phase, f"{steps_without} did not launch in every step: {per_step}")
    if check is not None:
        res["checks_per_step"] = [int(c) for c in checks]
        if any(res["checks_per_step"]):
            res["ok"] = False
            fail(phase, f"the step check is not 0 after every step: {res['checks_per_step']}")
    emit(res)
    prof = _profile_step(phase, step, state, gen, ms)
    return state, launches, res, prof


def _qem_path(phase, problem, K, must_launch, info):
    """``train.qem`` steps through :func:`_train_path`; returns (step,
    state, launches)."""
    from alan_tpu_torch import train
    step, state = train.qem(problem, K, lr=LR_QEM)
    state, launches, _, _ = _train_path(phase, step, state, K, must_launch, info)
    return step, state, launches


def phase_main_path():
    from alan_tpu_torch.models import movielens as ml
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    problem = ml.grouped_problem(ps, data, cov, device="cuda")
    step, state, launches = _qem_path(
        "main_path", problem, K_MAIN, ["lowrank_fwd", "lowrank_bwd"],
        {"model": "grouped_movielens", "M": ml.M, "N": ml.N, "d_z": ml.d_z})
    return problem, step, state, launches


def _movielens_k30(device):
    from alan_tpu_torch.models import movielens as ml
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device=device)
    return ml.generate_problem(ps, data, cov, "qem", device=device)


def phase_movielens_k30_main_path():
    """bench.py's headline (``bench.py:106-120``): ungrouped MovieLens QEM
    at K=30, full width.  No hand-written kernel runs on it: z's factor is
    dense (its work, 1.46e8, is under the factored form's 2^28) and no
    contraction step passes the matmul route's shape gate, so every
    contraction is a broadcast log-sum-exp."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import movielens as ml
    problem = _movielens_k30("cuda")
    step, state = train.qem(problem, K_HEADLINE, lr=LR_QEM)
    phase = "movielens_k30_main_path"
    state, _, res, prof = _train_path(
        phase, step, state, K_HEADLINE, [],
        {"model": "movielens", "M": ml.M, "N": ml.N, "d_z": ml.d_z})
    busy = prof["device_busy_ms"] / prof["steps"]
    emit({"phase": phase, "summary": True, "ms_per_step": res["ms_per_step"],
          "device_busy_ms_per_step": busy,
          "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
          "peak_mem_gb": res["peak_mem_gb"],
          # bench.py's unit: K particles of each of the 2 + M latent sites
          "samples_per_s": K_HEADLINE * (2 + ml.M) / (res["ms_per_step"] / 1e3)})
    return problem, step, state


def _tree_to(tree, device):
    from alan_tpu_torch.dims import DT
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else (DT(v.data.to(device), v.dims) if isinstance(v, DT) else v)
            for k, v in tree.items()}


def phase_grad_cross_check(phase, problem, state, K, reparam, env, sample=None,
                           exact_problem=None):
    """The ELBO and its gradient with respect to every opt param from the
    same state and draws (a particle tree, or a generator of one seed)
    through the kernel route and through the route ``env`` selects: ELBO
    within 1e-4 relative, every gradient within rtol/atol 1e-4.  With
    ``exact_problem`` (the same problem in float64) a gradient that misses
    that bound passes if it is at least as close as the other route's to
    the float64 evaluation of the other route, the f64 rule of the kernel
    checks (both routes sum ~1e6 terms a gradient in float32), and lies
    within 1e-4 (1 + max |g|) of it, a ceiling that does not lean on the
    other route."""
    import torch
    from alan_tpu_torch import train

    def run(prob, dtype=None):
        f = train.elbo_fn(prob, K, reparam)
        leaves, sP, sQ = train.opt_leaves(state[0], state[1], dtype)
        draws = ({"sample": sample} if sample is not None else
                 {"generator": torch.Generator(device="cuda").manual_seed(2)})
        elbo = f(sP, sQ, **draws)
        grads = torch.autograd.grad(elbo, leaves)
        torch.cuda.synchronize()
        names = [*sP["opt"], *sQ["opt"]]
        return float(elbo.detach()), dict(zip(names, grads))

    elbo_k, grads_k = run(problem)
    t0 = time.perf_counter()
    os.environ.update(env)
    try:
        elbo_d, grads_d = run(problem)
        other_ms = (time.perf_counter() - t0) * 1e3
        exact = run(exact_problem, torch.float64)[1] if exact_problem is not None else None
    finally:
        for k in env:
            del os.environ[k]
    rel = abs(elbo_k - elbo_d) / abs(elbo_d)
    grads = {}
    for k, g in grads_d.items():
        close = torch.allclose(grads_k[k], g, rtol=1e-4, atol=1e-4)
        grads[k] = {"max_abs_diff": (grads_k[k] - g).abs().max().item(),
                    "max_abs": g.abs().max().item(), "within_tol": close}
        if exact is not None:
            grads[k]["err_vs_f64"] = (grads_k[k].double() - exact[k]).abs().max().item()
            grads[k]["other_err_vs_f64"] = (g.double() - exact[k]).abs().max().item()
            grads[k]["f64_ceiling"] = 1e-4 * (1 + exact[k].abs().max().item())
            close = close or (grads[k]["err_vs_f64"] <= grads[k]["other_err_vs_f64"]
                              and grads[k]["err_vs_f64"] <= grads[k]["f64_ceiling"])
        grads[k]["ok"] = close
    res = {"phase": phase, "other_route": env, "elbo_kernel": elbo_k,
           "elbo_other": elbo_d, "elbo_rel_diff": rel, "grads": grads,
           "other_route_ms_one_call": other_ms,
           "ok": rel <= 1e-4 and all(g["ok"] for g in grads.values())}
    if not res["ok"]:
        fail(phase, f"ELBO rel diff {rel}, gradients {grads}")
    emit(res)


def _movielens_f64(Q_param_type="opt"):
    """The same grouped MovieLens problem with its data and covariates in
    float64: fed a float64 state, it evaluates the ELBO in float64."""
    import torch
    from alan_tpu_torch.dims import DT
    from alan_tpu_torch.models import movielens as ml
    a = ml.fake_data(0, ml.M, ml.N)
    plates = ("plate_1", "plate_2")
    f64 = lambda x: DT(torch.from_numpy(x).double().cuda(), plates)
    return ml.grouped_problem({"plate_1": ml.M, "plate_2": ml.N}, {"obs": f64(a["obs"])},
                              {"x": f64(a["x"])}, Q_param_type, device="cuda")


def phase_vi_main_path():
    """Grouped MovieLens with its opt Q at K=1000, ``train.vi``: z's draw
    sits in the lazy factor's U and mu_z's and psi_z's in its V, so every
    step launches the lowrank backward's dU and dV modes."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import movielens as ml
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    problem = ml.grouped_problem(ps, data, cov, "opt", device="cuda")
    step, state = train.vi(problem, K_MAIN, lr=0.01)
    phase = "vi_main_path"
    state, launches, res, prof = _train_path(
        phase, step, state, K_MAIN, ["lowrank_fwd", "lowrank_bwd_dU", "lowrank_bwd_dV"],
        {"model": "grouped_movielens_opt", "method": "vi", "M": ml.M, "N": ml.N,
         "d_z": ml.d_z})
    modes = _lowrank_mode_ms(prof)
    adam = _adam_card_vs_host(problem, state, K_MAIN, lr=0.01)
    if not adam["ok"]:
        fail(phase, f"Adam on the card against the host's: {adam}")
    emit({"phase": phase, "summary": True, "ms_per_step": res["ms_per_step"],
          "adam_card_vs_host": adam,
          "device_busy_ms_per_step": prof["device_busy_ms"] / prof["steps"],
          "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
          "peak_mem_gb": res["peak_mem_gb"],
          "samples_per_s": K_MAIN * (2 + ml.M) / (res["ms_per_step"] / 1e3),
          "launches_per_step": {k: v / STEPS for k, v in launches.items() if v},
          "lowrank_device_ms_per_step": modes,
          "lowrank_bwd_device_ms_per_step":
              sum(modes[k] for k in ("bwd_dD", "bwd_dU", "bwd_dV", "dv_reduce"))})
    return problem, state, launches, modes


def _ulps(a, b):
    """Elementwise distance in float32 ulps (units in the last place)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _adam_card_vs_host(problem, state, K, lr):
    """One VI step's gradients at ``state`` (grouped MovieLens K=1000 after
    its path), copied to the host; Adam on the card (capturable, as
    ``train.vi`` builds it there) and on the host (not capturable) from the
    same Adam state and gradients: the largest difference of the new opt
    params in float32 ulps and relative to the host's, and against
    |new| + |update|.  Gate: with the host's update scaled by the factor
    that the card's float32 bias corrections predict, within 1e-6 of
    |new| + |update|; every param moved."""
    import torch
    from alan_tpu_torch import train
    stateP, stateQ, opt_state = state
    f = train.elbo_fn(problem, K, True)
    leaves, sP, sQ = train.opt_leaves(stateP, stateQ)
    elbo = f(sP, sQ, torch.Generator(device="cuda").manual_seed(21))
    grads = torch.autograd.grad(elbo, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g.detach()
             for x, g in zip(leaves, train._ascend_all(len(stateP["opt"]), grads))]
    adam = lambda capturable: (lambda params: torch.optim.Adam(params, lr=lr,
                                                               capturable=capturable))
    fresh = lambda ts, device: [t.detach().to(device).clone().requires_grad_(True) for t in ts]
    cP, cQ, _ = train._optimizer_step(adam(True), opt_state, fresh(leaves, "cuda"), grads,
                                      stateP, stateQ)
    host_opt = {"state": {i: {k: v.cpu() for k, v in st.items()}
                          for i, st in opt_state["state"].items()},
                "param_groups": [dict(g, capturable=False) for g in opt_state["param_groups"]]}
    hP, hQ, _ = train._optimizer_step(adam(False), host_opt, fresh(leaves, "cpu"),
                                      [g.cpu() for g in grads], _tree_to(stateP, "cpu"),
                                      _tree_to(stateQ, "cpu"))
    # the card's Adam takes its bias corrections 1 - beta^t in float32
    # (``torch._foreach_pow`` of its step tensor), the host's in float64:
    # at t ~ 7, 1 - 0.999^t loses ~3 digits to the float32 rounding of
    # 0.999^t, so the two updates differ by a factor f of ~1e-5, which the
    # gate takes out before it compares
    group = opt_state["param_groups"][0]
    (b1, b2), lr_ = group["betas"], group["lr"]
    step_t = next(iter(opt_state["state"].values()))["step"] + 1
    t = float(step_t)
    bc32 = [float(1 - torch._foreach_pow(b, [step_t])[0]) for b in (b1, b2)]
    bc64 = [1 - b ** t for b in (b1, b2)]
    f = (bc64[0] / bc32[0]) * math.sqrt(bc32[1] / bc64[1])
    worst_ulps, worst_rel, worst_raw, worst, moved, n = 0, 0.0, 0.0, 0.0, True, 0
    ratios = []
    for card, host, old in ((cP, hP, stateP), (cQ, hQ, stateQ)):
        for k, v in card["opt"].items():
            a, b, o = (x.double() for x in (v.data.cpu(), host["opt"][k].data,
                                             old["opt"][k].data.cpu()))
            upd = b - o
            scale = (b.abs() + upd.abs()).clamp(min=1e-30)
            worst_ulps = max(worst_ulps, int(_ulps(v.data.cpu(), host["opt"][k].data).max()))
            worst_rel = max(worst_rel, ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item())
            worst_raw = max(worst_raw, ((a - b).abs() / scale).max().item())
            worst = max(worst, ((a - (o + f * upd)).abs() / scale).max().item())
            big = upd.abs() > 1e-3 * lr_
            ratios.append(((a - o)[big] / upd[big]).flatten())
            moved = moved and bool((upd != 0).any())
            n += a.numel()
    ratio = torch.cat(ratios).median().item()
    return {"params": n, "adam_step": t, "max_ulps": worst_ulps, "max_rel_diff": worst_rel,
            "max_diff_over_value_plus_update": worst_raw,
            "bias_correction_factor_predicted": f, "update_ratio_card_over_host_median": ratio,
            "max_diff_after_factor": worst, "all_moved": moved,
            "gate": "|card - (old + f (host - old))| <= 1e-6 (|host| + |host - old|)",
            "ok": worst <= 1e-6 and moved}


def phase_covid_rws_path():
    """Covid at full size with its opt Q, K=30, ``train.rws`` (lr 0.01, as
    ``examples/grids/covid.yaml``): the gradients of log P and log Q flow
    back through the small-K chain kernels."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import covid
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cuda")
    problem = covid.generate_problem(ps, data, cov, "opt", device="cuda")
    step, state = train.rws(problem, K_COVID, lr=0.01)
    state, launches, res, prof = _train_path(
        "covid_rws_path", step, state, K_COVID, ["smallk_fwd", "smallk_bwd"],
        {"model": "covid_opt", "method": "rws", "nRs": ps["nRs"],
         "nDs_train": ps["nDs"], "chains": ps["nRs"] * K_COVID})
    emit({"phase": "covid_rws_path", "summary": True, "ms_per_step": res["ms_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms"] / prof["steps"],
          "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
          "peak_mem_gb": res["peak_mem_gb"],
          "launches_per_step": {k: v / STEPS for k, v in launches.items() if v}})
    return problem, state, launches


def _rws_draws(problem, state, K):
    import torch
    from alan_tpu_torch.sampler import PermutationSampler
    gen = torch.Generator(device="cuda").manual_seed(2)
    tree, _ = problem.Q._sample(K, False, PermutationSampler, problem.all_platedims,
                                gen, state=state[1])
    return tree


def _chain_report(step, state, seed):
    """One QEM step at ``state``: the entries of its chain's forward that
    took the joint shift, of all its pair products' entries, and the chain
    kernels' times (forward launches with their fix-ups, backward ones, and
    the fast launches and the fix-ups apart, with the fix-ups' bounds) on
    the operator that step hands them."""
    import torch
    from alan_tpu_torch.ops import logmmexp as lm
    captured, orig = [], lm.chain_logmmexp_smallk

    def spy(ms):
        captured.append(ms.detach().reshape(-1, *ms.shape[-3:]).clone())
        return orig(ms)
    lm.chain_logmmexp_smallk = spy
    try:
        _, joints = _joint_counted(
            lambda: step(state, torch.Generator(device="cuda").manual_seed(seed)))
    finally:
        lm.chain_logmmexp_smallk = orig
    ms = captured[0]
    B, T, K, _ = ms.shape
    entries = sum(_levels(T)) * B * K * K
    times = _chain_times(ms)
    del captured, ms
    return {"joint_entries": joints, "entries": entries, "joint_share": joints / entries,
            "chain_fwd_ms": times.pop("fwd_ms"), "chain_bwd_ms": times.pop("bwd_ms"),
            **times}


def phase_covid_main_path():
    """Covid QEM at full size through ``_qem_path``, and the chain's
    joint-shift entries and kernel times at Q's initial state and after the
    path's 1 + 5 steps, beside the kernel times before the fix-ups."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import covid
    phase = "covid_main_path"
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cuda")
    problem = covid.generate_problem(ps, data, cov, "qem", device="cuda")
    at_init = _chain_report(*train.qem(problem, K_COVID, lr=LR_QEM), seed=3)
    step, state, launches = _qem_path(
        phase, problem, K_COVID, ["smallk_fwd", "smallk_bwd"],
        {"model": "covid", "nRs": ps["nRs"], "nDs_train": ps["nDs"],
         "chains": ps["nRs"] * K_COVID})
    trained = _chain_report(step, state, seed=4)
    FIXUP_REPORTS["covid_own"] = trained
    emit({"phase": phase, "joint_shift": True, "at_q_init": at_init,
          "after_6_qem_steps": trained,
          "chain_fwd_ms_before_fixups": CHAIN_MS_BEFORE_FIXUPS[0],
          "chain_bwd_ms_before_fixups": CHAIN_MS_BEFORE_FIXUPS[1]})
    return problem, step, state, launches


def _kalman_bracket(e):
    """(min, max, ok) of the criterion of tests/test_problem_vs_itself.py
    on ELBO draws of the AR(1) model: the mean of the draws, widened by 6
    standard errors and by half the (widened) variance, must bracket its
    exact Kalman log-likelihood, within a gap of 1 nat."""
    import numpy as np
    from alan_tpu_torch.models import ar1
    e = np.asarray(e, dtype=np.float64)
    n = len(e)
    mean, var = e.mean(), e.var(ddof=1)
    se_mean, se_var = np.sqrt(var / n), np.sqrt(2 * var ** 2 / n)
    hi = mean + 6 * se_mean + (var + 6 * se_var) / 2
    lo = mean - 6 * se_mean
    return float(lo), float(hi), bool(_finite(e) and lo < ar1.known_elbo < hi
                                      and hi - lo < 1.0)


def phase_ar1_large_k():
    """ELBO draws of the AR(1) model at K=1000 against its exact Kalman
    log-likelihood (``_kalman_bracket``)."""
    import numpy as np
    import torch
    from alan_tpu_torch.models import ar1
    problem = ar1.generate_problem("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    float(problem.sample(K_AR1, gen, reparam=False).elbo_nograd())      # warm-up
    torch.cuda.synchronize()
    zero_counts()
    draws, per_elbo = [], []
    t0 = time.perf_counter()
    for _ in range(AR1_ELBOS):
        draws.append(float(problem.sample(K_AR1, gen, reparam=False).elbo_nograd()))
        per_elbo.append(read_counts()["logmmexp"] - sum(per_elbo))
    ms = (time.perf_counter() - t0) / AR1_ELBOS * 1e3
    launches = read_counts()
    e = np.array(draws)
    min_elbo, max_elbo, bracketed = _kalman_bracket(e)
    res = {"phase": "ar1_large_k", "K": K_AR1, "T": ar1.T, "draws": len(e),
           "ms_per_elbo": ms, "known_elbo": ar1.known_elbo,
           "elbo_min": float(e.min()), "elbo_max": float(e.max()),
           "elbo_mean": float(e.mean()), "bracket": [min_elbo, max_elbo],
           "launches": launches, "ok": True}
    if not bracketed:
        res["ok"] = False
        fail("ar1_large_k", f"ELBO bracket {min_elbo, max_elbo} vs exact "
                            f"{ar1.known_elbo}")
    if per_elbo != [2] * AR1_ELBOS:
        res["ok"] = False
        fail("ar1_large_k", f"fused launches per ELBO {per_elbo}, not 2 in each")
    emit(res)

    def elbo(state, gen):
        return state, float(problem.sample(K_AR1, gen, reparam=False).elbo_nograd())
    _profile_step("ar1_large_k", elbo, None, gen, ms)
    own = _fused_fixup_report(lambda: problem.sample(K_AR1, gen, reparam=False).elbo_nograd(),
                              "ar1_large_k")
    FIXUP_REPORTS["ar1_own"] = own
    if len(own) != 2:
        fail("ar1_large_k", f"an ELBO made {len(own)} fused launches, not 2")
    emit({"phase": "ar1_large_k", "fused_fixup_on_own_operators": own,
          "ok": len(own) == 2 and all(r["ok"] for r in own)})
    return launches


def _f64_rows(A, B, g=None, rows=64):
    """``logsumexp_k(A[b, i, k] + B[b, k, j])`` in float64 and, given the
    output's gradient ``g``, the gradients (dA, dB) of ``sum(out * g)``
    (softmax weights over k), by chunks of ``rows`` rows of the K^3 cross
    sum: the whole cross sum of (1000, 1000, 1000) would take 8 GB."""
    import torch
    A, B = A.double(), B.double()
    nb, M, _ = A.shape
    out = torch.empty((nb, M, B.shape[2]), dtype=torch.float64, device=A.device)
    dA, dB = torch.empty_like(A), torch.zeros_like(B)
    for b in range(nb):
        for r in range(0, M, rows):
            x = A[b, r:r + rows, :, None] + B[b]                  # (rows, K, N)
            lse = torch.logsumexp(x, 1)
            out[b, r:r + rows] = lse
            if g is not None:
                w = torch.exp(x - lse[:, None, :]) * g[b, r:r + rows, None, :].double()
                dA[b, r:r + rows] = w.sum(2)
                dB[b] += w.sum(0)
    return out if g is None else (out, dA, dB)


def _hold_to_plain(res, phase, tag, got, want, exact, tols):
    """``got`` (value and gradients) against the plain version ``want`` at
    rtol/atol ``tols`` and against float64 ``exact`` within tol (1 +
    |exact|), recorded in ``res`` under out, dA, dB."""
    for name, g, w, e, tol in zip(("out", "dA", "dB"), got, want, exact, tols):
        _check(res, phase, tag, name, g, w, e, tol, tol, False)
        bad = ((g.double() - e).abs() - tol * e.abs()).max().item()
        res[name]["f64_max_err_over_rtol"] = bad
        if bad > tol:
            res["ok"] = False
            fail(phase, f"{tag} {name}: against f64 {bad}")


def _plain_joints(res, phase, tag, joints, fn):
    """The plain version's ``fn()`` and its joint entries, which the
    kernel's ``joints`` must match within 0.1%."""
    want, joints_p = _joint_counted(fn)
    res["joint_entries_plain"] = joints_p
    if joints == 0 or abs(joints - joints_p) > joints_p // 1000:
        res["ok"] = False
        fail(phase, f"{tag}: joint entries {joints}, plain {joints_p}")
    return want


def _fused_fixup_report(run, phase):
    """The fused route's launches of one ``run()`` on its own operators:
    each launch's device ms (CUDA graphs of 20), the pre-pass and product
    alone, the fix-up as the difference, its joint entries and its bound
    (K exponentials a joint entry at PEAK_EXP_PER_S); each launch's output
    held to the plain version (rtol/atol 1e-5, joint entries within 0.1%)
    and float64, its unflagged entries bitwise the product's."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    captured, orig = [], lk._launch

    def spy(A, B, save=False):
        captured.append((A.clone(), B.clone()))
        return orig(A, B, save)
    lk._launch = spy
    try:
        run()
    finally:
        lk._launch = orig
    out = []
    for n, (A, B) in enumerate(captured):
        nb, M, K = A.shape
        N = B.shape[2]
        bn = lk.tile_n(nb, M, N, lk._sms(A.device))
        ms = graph_ms(lambda: lk._launch(A, B))
        before_ms = graph_ms(lambda: lk._product(*lk._prepass(A, B, bn), nb, M, K, N, bn))
        (got, flags, _), joints = _joint_counted(lambda: lk._launch(A, B))
        bound_ms = joints * K / PEAK_EXP_PER_S * 1e3
        res = {"nb_M_K_N": [nb, M, K, N], "ms": ms, "prepass_product_ms": before_ms,
               "fixup_ms": ms - before_ms, "joint_entries": joints, "fixup_bound_ms": bound_ms,
               "fixup_bound_share": bound_ms / max(ms - before_ms, 1e-9),
               **_tile_shares(flags), "ok": True}
        tag = f"own operators, launch {n}"
        want = _plain_joints(res, phase, tag, joints, lambda: lk.reference_logmmexp(A, B))
        _hold_to_plain(res, phase, tag, [got], [want], [_f64_rows(A, B)], (1e-5,))
        product = lk._product(*lk._prepass(A, B, bn), nb, M, K, N, bn)
        res["unflagged_bitwise"] = torch.equal(got[~flags], product[~flags])
        if not res["unflagged_bitwise"]:
            res["ok"] = False
            fail(phase, f"{tag}: unflagged entries differ from the product's")
        out.append(res)
    return out


def _tile_shares(flags):
    """Of the forward fix-up's tiles (FIX_TM x FIX_TN entries), the share
    that holds a flagged entry and so is walked, and the share of the
    entries in those tiles that are flagged."""
    import torch.nn.functional as F
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    nb, M, N = flags.shape
    mt, nt = lk.fixup_tiles(M, N)
    f = F.pad(flags, (0, nt * lk.FIX_TN - N, 0, mt * lk.FIX_TM - M))
    per_tile = f.reshape(nb, mt, lk.FIX_TM, nt, lk.FIX_TN).sum((2, 4))
    visited = per_tile > 0
    inside = F.pad(flags.new_ones((nb, M, N)), (0, nt * lk.FIX_TN - N, 0, mt * lk.FIX_TM - M))
    entries = inside.reshape(nb, mt, lk.FIX_TM, nt, lk.FIX_TN).sum((2, 4))
    return {"tiles_visited_share": visited.float().mean().item(),
            "flagged_share_in_visited": (per_tile.sum() / entries[visited].sum()).item()}


def _fused_fixup_bwd_report(run, phase):
    """The fused route's backward on its own operators and gradients, as
    one ``run()`` hands them to it: per launch the forward (keeping state),
    the backward and both fix-ups alone (``_fixup_times``), the joint
    entries; value and gradients held to the plain version's autograd
    (rtol/atol 1e-5 and 1e-4, joint entries within 0.1%) and float64, at
    the run's own g scaled to a largest entry of 1 and at a unit normal g;
    two backward calls giving the same bits."""
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    captured, orig = [], lk._launch_bwd

    def spy(A, B, flags, kept, g):
        captured.append((A.clone(), B.clone(), g.clone()))
        return orig(A, B, flags, kept, g)
    lk._launch_bwd = spy
    try:
        run()
    finally:
        lk._launch_bwd = orig

    def plain(A, B, g):
        a, b = A.clone().requires_grad_(True), B.clone().requires_grad_(True)
        y = lk.reference_logmmexp(a, b)
        return (y.detach(), *torch.autograd.grad(y, [a, b], g))
    out = []
    for n, (A, B, g) in enumerate(captured):
        (y, flags, kept), joints = _joint_counted(lambda: lk._launch(A, B, save=True))
        first = lk._launch_bwd(A, B, flags, kept, g)
        second = lk._launch_bwd(A, B, flags, kept, g)
        res = {"nb_M_K_N": [*A.shape, B.shape[2]], "joint_entries": joints,
               "bwd_bitwise_repeatable": all(torch.equal(x, y)
                                             for x, y in zip(first, second)), "ok": True}
        tag = f"own operators and gradients, launch {n}"
        if not res["bwd_bitwise_repeatable"]:
            res["ok"] = False
            fail(phase, f"{tag}: two backward calls differ")
        # the gradients are linear in g, and marginals()'s g is a posterior's
        # weights (its gradients ~1e-11, below any atol): held at g scaled to
        # a largest entry of 1, and at a unit normal g
        g_max = g.abs().max()
        res["g_max_abs"] = g_max.item()
        rand = torch.randn(g.shape, device=g.device,
                           generator=torch.Generator(device=g.device).manual_seed(n))
        for name, gg in (("scaled_g", g / g_max), ("normal_g", rand)):
            res[name] = {"ok": True}
            got = [y, *lk._launch_bwd(A, B, flags, kept, gg)]
            want = _plain_joints(res[name], phase, f"{tag}, {name}", joints,
                                 lambda: plain(A, B, gg))
            _hold_to_plain(res[name], phase, f"{tag}, {name}", got, want, _f64_rows(A, B, gg),
                           (1e-5, 1e-4, 1e-4))
            res[name]["max_abs_dA_dB"] = [w.abs().max().item() for w in want[1:]]
            res["ok"] &= res[name]["ok"]
        res.update(_fixup_times(A, B, g, joints))
        out.append(res)
    return out


def _profile_step(phase, step, state, gen, ms_per_step):
    """Device time by kernel name over two QEM steps (torch.profiler).

    Device activity is every CUDA event that is not a user annotation: the
    profiler also puts each operator's name on the device timeline, and
    counting those would count the kernels under them twice.  Busy time is
    the union of the activity intervals.  The profiler slows the host, so
    the idle share is given over the profiled window and, with the busy time
    per step, over the unprofiled step time of the path's phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def on_device(ev):
        return (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False))

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if on_device(ev))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages() if on_device(ev)), reverse=True)
    busy_ms = busy_us / 1e3
    res = {"phase": "profile", "of": phase, "steps": steps, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "device_events": len(spans),
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "device_idle_share_unprofiled":
               max(0.0, 1.0 - busy_ms / steps / ms_per_step),
           "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c}
                   for us, k, c in rows[:12]]}
    emit(res)
    res["rows"] = rows
    return res


def _lowrank_mode_ms(prof):
    """Device ms per step of the lowrank kernels, by mode (the template
    argument of ``lse_tc_kernel``), of the split pass and of dV's reduce."""
    import re
    names = {"0": "fwd", "1": "bwd_dD", "2": "bwd_dU", "3": "bwd_dV"}
    out = dict.fromkeys([*names.values(), "split", "dv_reduce"], 0.0)
    for us, key, _ in prof["rows"]:
        m = re.search(r"lse_tc_kernel<\D*([0-3])", key)
        name = (names[m.group(1)] if m else "split" if "lse_split_kernel" in key
                else "dv_reduce" if "lse_bwd_dv_reduce" in key else None)
        if name is not None:
            out[name] += us / 1e3 / prof["steps"]
    return out


def phase_cross_check(phase, problem, step, state, K, env, host_problem=None):
    """One QEM update from the same state and injected particles with the
    kernel route and with the route that ``env`` selects: ELBO within 1e-4
    relative, the updated Q state within rtol/atol 1e-4.  With
    ``host_problem`` (the same problem on the CPU) the other update runs
    on the host, plain PyTorch: the independent evaluation for a path
    whose routes on the card are already the plain ones."""
    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.sampler import PermutationSampler
    gen = torch.Generator(device="cuda").manual_seed(2)
    tree, _ = problem.Q._sample(K, False, PermutationSampler,
                                problem.all_platedims, gen, state=state[1])
    (_, newQ_k), elbo_k = step(state, sample=tree)
    torch.cuda.synchronize()
    other_step = step
    if host_problem is not None:
        other_step, _ = train.qem(host_problem, K, lr=LR_QEM, device="cpu")
        state, tree = tuple(_tree_to(s, "cpu") for s in state), _tree_to(tree, "cpu")
    t0 = time.perf_counter()
    os.environ.update(env)
    try:
        (_, newQ_d), elbo_d = other_step(state, sample=tree)
        torch.cuda.synchronize()
    finally:
        for k in env:
            del os.environ[k]
    other_ms = (time.perf_counter() - t0) * 1e3
    elbo_k, elbo_d = float(elbo_k), float(elbo_d)
    rel = abs(elbo_k - elbo_d) / abs(elbo_d)
    if host_problem is not None:
        newQ_k = _tree_to(newQ_k, "cpu")
    diffs = _max_state_diff(newQ_k, newQ_d)
    state_ok = all(
        torch.allclose(v.data, newQ_d[g][k].with_dims_front(list(v.dims)).data,
                       rtol=1e-4, atol=1e-4)
        for g in ("qem_params", "qem_means") for k, v in newQ_k[g].items())
    res = {"phase": phase, "other_route": env,
           "other_device": "cpu" if host_problem is not None else "cuda",
           "elbo_kernel": elbo_k, "elbo_other": elbo_d, "elbo_rel_diff": rel,
           "max_state_abs_diff": max(diffs.values()),
           "worst_state_entry": max(diffs, key=diffs.get),
           "other_step_ms_one_call": other_ms,
           "ok": rel <= 1e-4 and state_ok}
    if not res["ok"]:
        fail(phase, f"ELBO rel diff {rel}, state diffs {diffs}")
    emit(res)
    return res


# ---- the posterior read-out (phases 14 to 16) -----------------------------------

def _posterior_sample(problem, state, K, seed):
    """A ``Sample`` of K particles from Q at ``state`` (drawn with a seeded
    generator), evaluated at ``state``."""
    import torch
    from alan_tpu_torch.sample import Sample
    from alan_tpu_torch.sampler import PermutationSampler
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tree, gv2K = problem.Q._sample(K, False, PermutationSampler, problem.all_platedims,
                                   gen, state=state[1])
    return Sample(problem, tree, gv2K, PermutationSampler, False, states=state)


def _driven(fn):
    """One call of ``fn`` with the launch counters zeroed just before it and
    read just after, and the peak device memory over it: (result, ms,
    launches, peak GB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, read_counts(), torch.cuda.max_memory_allocated() / 1e9


def _host_ms(fn, reps=3):
    """Median host-clock ms of ``reps`` calls, each ending in a synchronise."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _all_finite(tensors):
    import torch
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _moments_gate(marg, isamp, varnames, N):
    """The criterion of ``tests/test_problem_vs_itself.py:99-116``, made to
    hold for skewed marginals: each importance-sample moment (mean and
    mean2 of every latent) within 6 standard errors, sqrt(var / N) with the
    variance from the marginals, of the marginal moment, plus Bernstein's
    term for draws of rare particles, 12 R / N with R the largest
    |f - E f| over the particles (the two together fail with probability
    2 e^-18 a cell), plus 1e-5 of the moment: where a marginal is one
    particle both estimates are its value up to float32 rounding.  The
    variance is the weighted central moment sum_k w_k (f_k - E f)^2: the
    raw moments' difference E f^2 - (E f)^2 cancels in float32 (covid's
    log_infected, ~27 with particles ~0.005 apart, gave 0)."""
    from alan_tpu_torch import moments
    from alan_tpu_torch.dims import amax_dims, sum_dims
    worst = worst_6se = 0.0
    cells = 0
    for var in varnames:
        x = marg.samples[var]
        kdims = tuple(d for d in x.dims if d not in marg.all_platedims)
        w = marg.weights[frozenset([marg.varname2groupvarname[var]])]
        for m in (moments.mean, moments.mean2):
            mm = marg.moments(var, m)
            aligned = lambda t: t.with_dims_front(list(mm.dims)).data
            im = isamp.moments(var, m)
            dev_k = m.f(x) - mm
            six_se = aligned(6 * (sum_dims(w * dev_k * dev_k, kdims) / N).sqrt())
            spread = aligned(amax_dims(dev_k.abs(), kdims))
            dev = aligned(im - mm).abs()
            worst = max(worst, (dev / (six_se + 12 * spread / N
                                       + 1e-5 * mm.abs().data)).max().item())
            worst_6se = max(worst_6se, (dev / six_se).max().item())
            cells += mm.data.numel()
    return {"worst_dev_over_band": worst, "worst_dev_over_6se": worst_6se,
            "cells": cells, "ok": worst <= 1.0}


def phase_grouped_posterior_k1000(problem, step):
    """The posterior of grouped MovieLens at K=1000, full width, read out at
    the Q state after 5 QEM steps: ``marginals()`` (its source-term backward
    is the lowrank kernels' forward and ``MODE_DD``),
    ``importance_sample(1000)`` (the forward, in the contraction the replay
    reverses) and ``predict.predictive_ll_fn`` on the 5 training and 5
    held-out films.  Each call driven once with the counters zeroed, then
    timed over 3 more."""
    import torch
    from alan_tpu_torch import predict
    from alan_tpu_torch.models import movielens as ml
    phase = "grouped_posterior_k1000"
    state = (problem.P.state(), problem.Q.state())
    gen = torch.Generator(device="cuda").manual_seed(4)
    for _ in range(POSTERIOR_QEM_STEPS):
        state, _ = step(state, gen)
    s = _posterior_sample(problem, state, K_MAIN, 5)
    all_ps, all_data, all_cov = ml.load_all_data_covariates(
        seed=0, M=ml.M, N=ml.N, N_test=N_TEST_FILMS, device="cuda")
    pll_f = predict.predictive_ll_fn(problem, K_MAIN, N_DRAWS, all_ps)
    calls = {
        "marginals": lambda: s.marginals(),
        "importance_sample": lambda: s.importance_sample(N_DRAWS, gen),
        "predictive_ll": lambda: pll_f(*state, all_cov, all_data, gen),
    }
    res = {"phase": phase, "model": "grouped_movielens", "M": ml.M, "N": ml.N,
           "N_test": N_TEST_FILMS, "d_z": ml.d_z, "K": K_MAIN, "draws": N_DRAWS,
           "qem_steps": POSTERIOR_QEM_STEPS, "ok": True}
    outs, launches = {}, {}
    for name, fn in calls.items():
        outs[name], first_ms, launches[name], peak = _driven(fn)
        res[name] = {"first_call_ms": first_ms, "ms": _host_ms(fn),
                     "launches": launches[name], "peak_mem_gb": peak}
    must = {"marginals": ["lowrank_fwd", "lowrank_bwd_dD"],
            "importance_sample": ["lowrank_fwd"], "predictive_ll": ["lowrank_fwd"]}
    for name, keys in must.items():
        missing = [k for k in keys if launches[name][k] < 1]
        if missing:
            res["ok"] = False
            fail(phase, f"{name} did not launch {missing}: {launches[name]}")
    marg, isamp, pll = outs["marginals"], outs["importance_sample"], outs["predictive_ll"]
    ess = marg.ess()
    res["ess"] = {"/".join(sorted(k)): {"min": v.data.min().item(),
                                        "median": v.data.median().item()}
                  for k, v in ess.items()}
    res["min_ess"] = float(marg.min_ess())
    res["predictive_ll"]["value"] = {k: float(v) for k, v in pll.items()}
    res["moments_gate"] = _moments_gate(marg, isamp, ["mu_z", "psi_z", "z"], N_DRAWS)
    finite = _all_finite([w.data for w in marg.weights.values()]
                         + [v.data for v in isamp.dump().values()] + list(pll.values()))
    res["finite"] = finite
    if not res["moments_gate"]["ok"] or not finite:
        res["ok"] = False
        fail(phase, f"moments gate {res['moments_gate']}, finite {finite}")
    emit(res)
    _profile_step(phase, lambda st, g: (st, s.importance_sample(N_DRAWS, g)), state,
                  gen, res["importance_sample"]["ms"])
    return state, launches


class _RecordedDraws:
    """While active, every draw of the reverse replay records its Gumbel
    noise and the log-weights it perturbs (``reduce_ks.gumbel``)."""

    def __enter__(self):
        from alan_tpu_torch import reduce_ks
        self.mod, self.original, self.draws = reduce_ks, reduce_ks.gumbel, []

        def recorded(shape, like, keygen, noise=None):
            g = self.original(shape, like, keygen, noise)
            self.draws.append((g, like))
            return g
        reduce_ks.gumbel = recorded
        return self.draws

    def __exit__(self, *a):
        self.mod.gumbel = self.original


def _compare_draws(draws, other, rel=1e-4):
    """The draws of two routes from the same noise: the share of draws that
    differ, and whether each that differs is a near-tie (under the first
    route's log-weights, the two picks' perturbed scores within ``rel``,
    relative)."""
    import torch
    n = differ = 0
    ties_ok = True
    for (g, a), (_, b) in zip(draws, other):
        score = g + a
        ia = torch.argmax(score, dim=-1, keepdim=True)
        ib = torch.argmax(g + b, dim=-1, keepdim=True)
        d = ia != ib
        n += d.numel()
        differ += int(d.sum())
        if d.any():
            sa, sb = score.gather(-1, ia)[d], score.gather(-1, ib)[d]
            ties_ok &= bool(((sa - sb).abs() <= rel * sa.abs().clamp(min=1.0)).all())
    return {"draws": n, "differ": differ, "share_differ": differ / max(n, 1),
            "differing_are_near_ties": ties_ok,
            "ok": ties_ok and len(draws) == len(other)}


def _excused_chains(idx, other_idx, chain, T_dim):
    """Per chain of the timeseries group ``chain`` (its index's dims but
    ``T_dim``, flattened in that order, which is the order of FFBS's draw
    tensors), whether an index drawn above it differs between two routes'
    importance indices: such a chain conditions on other particles."""
    import torch
    from alan_tpu_torch.dims import DT, expand_to
    cdims = [d for d in idx[chain].dims if d != T_dim]
    out = torch.zeros([idx[chain].dim_size(d) for d in cdims], dtype=torch.bool)
    for g, r in idx.items():
        if g != chain:
            o = other_idx[g].with_dims_front(list(r.dims)).data.cpu()
            out |= expand_to(DT(r.data.cpu() != o, r.dims), cdims)
    return out.flatten()


def _compare_chain_draws(draws, other, rel=1e-4, excused=None):
    """FFBS's draws of two routes from the same noise, chain by chain (each
    draw tensor holds one step of every chain, in draw order): the first
    draw at which a chain's picks differ must be a near-tie (as in
    ``_compare_draws``, under the first route's log-weights); the chain's
    later draws condition on another particle, so they are counted but not
    compared, and so are the chains in ``excused`` (a flat bool per chain:
    an index drawn above them differs).  Returns the share of draws that
    differ and the number of chains that diverge."""
    import torch
    scores = torch.stack([g + a for g, a in draws])         # (S, *cells, K)
    S, K = scores.shape[0], scores.shape[-1]
    scores = scores.reshape(S, -1, K)
    ia = scores.argmax(-1)
    ib = torch.stack([(g + b).argmax(-1) for (g, _), (_, b) in zip(draws, other)]
                     ).reshape(S, -1)
    d = ia != ib
    hit = d.any(0)
    n_excused = 0
    if excused is not None:
        excused = excused.to(hit.device)
        n_excused = int((hit & excused).sum())
        hit = hit & ~excused
    cells = hit.nonzero().squeeze(1)
    first = d.float().argmax(0)[cells]
    sa = scores[first, cells].gather(-1, ia[first, cells][:, None])
    sb = scores[first, cells].gather(-1, ib[first, cells][:, None])
    ties_ok = bool(((sa - sb).abs() <= rel * sa.abs().clamp(min=1.0)).all())
    return {"draws": d.numel(), "differ": int(d.sum()),
            "share_differ": int(d.sum()) / d.numel(), "chains": d.shape[1],
            "chains_diverged": int(hit.sum()) + n_excused,
            "chains_excused": n_excused, "first_differences_are_near_ties": ties_ok,
            "ok": ties_ok and len(draws) == len(other)}


def _double_tree(tree):
    from alan_tpu_torch.dims import DT
    return {k: _double_tree(v) if isinstance(v, dict)
            else (DT(v.data.double(), v.dims) if isinstance(v, DT) else v)
            for k, v in tree.items()}


def phase_grouped_posterior_cross_check(problem, state):
    """The marginals and the replay's draws from the same particles and the
    same Gumbel noise through the kernels and through the dense route
    (``ALAN_TPU_NO_LAZY_LOWRANK=1``, which must launch no lowrank kernel):
    marginal weights within rtol/atol 1e-4, or by the f64 rule (at least as
    close as the dense route's to a float64 evaluation of the dense route,
    and within 1e-4 of it); the draws equal up to near-ties."""
    import torch
    from alan_tpu_torch.sample import Sample
    from alan_tpu_torch.split import no_checkpoint
    phase = "grouped_posterior_cross_check"
    s = _posterior_sample(problem, state, K_MAIN, 6)
    gen = torch.Generator(device="cuda").manual_seed(7)
    with _RecordedDraws() as draws_k:
        zero_counts()
        w_k = s.marginals().weights
        s._importance_sample_idxs(N_DRAWS, no_checkpoint, gen)
        launches_k = read_counts()
    os.environ["ALAN_TPU_NO_LAZY_LOWRANK"] = "1"
    try:
        with _RecordedDraws() as draws_d:
            zero_counts()
            t0 = time.perf_counter()
            w_d = s.marginals().weights
            s._importance_sample_idxs(N_DRAWS, no_checkpoint,
                                      noise=[g for g, _ in draws_k])
            torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            launches_d = read_counts()
        exact = None
        if not all(torch.allclose(w_k[k].data, w_d[k].with_dims_front(list(w_k[k].dims)).data,
                                  rtol=1e-4, atol=1e-4) for k in w_k):
            p64 = _movielens_f64("qem")
            s64 = Sample(p64, _double_tree(s.detached_sample), s.groupvarname2Kdim,
                         s.sampler, False, states=tuple(_double_tree(x) for x in state))
            exact = s64.marginals().weights
    finally:
        del os.environ["ALAN_TPU_NO_LAZY_LOWRANK"]
    weights = {}
    for k, wk in w_k.items():
        wd = w_d[k].with_dims_front(list(wk.dims)).data
        close = torch.allclose(wk.data, wd, rtol=1e-4, atol=1e-4)
        r = {"max_abs_diff": (wk.data - wd).abs().max().item(), "within_tol": close}
        if exact is not None:
            e = exact[k].with_dims_front(list(wk.dims)).data
            r["err_vs_f64"] = (wk.data.double() - e).abs().max().item()
            r["dense_err_vs_f64"] = (wd.double() - e).abs().max().item()
            close = close or (r["err_vs_f64"] <= r["dense_err_vs_f64"]
                              and r["err_vs_f64"] <= 1e-4)
        r["ok"] = close
        weights["/".join(sorted(k))] = r
    draws = _compare_draws(draws_k, draws_d)
    kernel_ok = launches_k["lowrank_fwd"] >= 2 and launches_k["lowrank_bwd_dD"] >= 1
    dense_ok = not any(v for k, v in launches_d.items() if k.startswith("lowrank"))
    res = {"phase": phase, "other_route": {"ALAN_TPU_NO_LAZY_LOWRANK": "1"},
           "weights": weights, "draws": draws, "launches_kernel_route": launches_k,
           "launches_dense_route": launches_d, "dense_route_ms_one_call": dense_ms,
           "ok": (all(r["ok"] for r in weights.values()) and draws["ok"]
                  and kernel_ok and dense_ok)}
    if not res["ok"]:
        fail(phase, f"weights {weights}, draws {draws}, launches {launches_k} / "
                    f"{launches_d}")
    emit(res)


def phase_is_draws_k30(problem):
    """``bench.py``'s ``bench_is_draws`` (``bench.py:175-245``): N joint
    posterior draws per ``predict.importance_sample_fn`` call (Q's K=30
    particles, the contraction, the reverse replay, the gather) on ungrouped
    MovieLens at Q's initial state, N = 100, 1000, 3000; ms per call and
    draws a second in ``bench.py``'s unit, N (2 + M) per call.  No
    hand-written kernel runs on it.  Then the same draws (particles and
    noise from the card) on the host's CPU, by the routes of
    ``movielens_k30_cross_check``: equal up to near-ties."""
    import torch
    from alan_tpu_torch import predict
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.sample import Sample
    from alan_tpu_torch.split import no_checkpoint
    phase = "is_draws_k30"
    state = (problem.P.state(), problem.Q.state())
    res = {"phase": phase, "model": "movielens", "M": ml.M, "N": ml.N, "d_z": ml.d_z,
           "K": K_HEADLINE, "by_N": {}, "ok": True}
    gen = torch.Generator(device="cuda").manual_seed(8)
    for n in IS_DRAWS_N:
        f = predict.importance_sample_fn(problem, K_HEADLINE, n)
        f(*state, gen)                                   # warm-up
        out, first_ms, launches, peak = _driven(lambda: f(*state, gen))
        ms = _host_ms(lambda: f(*state, gen), reps=5)
        finite = _all_finite([v.data for v in out.values()])
        res["by_N"][n] = {"ms_per_call": ms, "first_call_ms": first_ms,
                          "draws_per_s": n * (2 + ml.M) / (ms / 1e3),
                          "peak_mem_gb": peak, "launches": launches, "finite": finite}
        if not finite:
            res["ok"] = False
            fail(phase, f"non-finite draws at N={n}")
    emit(res)
    f = predict.importance_sample_fn(problem, K_HEADLINE, IS_DRAWS_N[1])
    _profile_step(phase, lambda st, g: (st, f(*st, g)), state, gen,
                  res["by_N"][IS_DRAWS_N[1]]["ms_per_call"])

    s = _posterior_sample(problem, state, K_HEADLINE, 9)
    with _RecordedDraws() as draws_card:
        s._importance_sample_idxs(IS_DRAWS_N[1], no_checkpoint, gen)
    host = _movielens_k30("cpu")
    hs = Sample(host, _tree_to(s.detached_sample, "cpu"), s.groupvarname2Kdim,
                s.sampler, False, states=tuple(_tree_to(x, "cpu") for x in state))
    env = {"ALAN_TPU_NO_MATMUL_CONTRACT": "1", "ALAN_TPU_NO_LOWRANK_LOGPROB": "1"}
    os.environ.update(env)
    try:
        with _RecordedDraws() as draws_host:
            t0 = time.perf_counter()
            hs._importance_sample_idxs(IS_DRAWS_N[1], no_checkpoint,
                                       noise=[g.cpu() for g, _ in draws_card])
            host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for k in env:
            del os.environ[k]
    draws = _compare_draws([(g.cpu(), a.cpu()) for g, a in draws_card], draws_host)
    check = {"phase": "is_draws_k30_cross_check", "other_route": env,
             "other_device": "cpu", "N": IS_DRAWS_N[1], "draws": draws,
             "host_ms_one_call": host_ms, "ok": draws["ok"]}
    if not check["ok"]:
        fail("is_draws_k30_cross_check", f"draws {draws}")
    emit(check)


# ---- the timeseries posterior (phases 17 to 19) ----------------------------------

def _weight_sums(marg, gvns):
    """[min, max] over the cells of each group's marginal weights summed over
    its particles (1 where the weights are a distribution)."""
    out = {}
    for g in gvns:
        w = marg.weights[frozenset([g])]
        tot = w.data.sum(0)
        out[g] = [tot.min().item(), tot.max().item()]
    return out


def _covid_near_truth_state(problem, scale=COVID_NEAR_TRUTH_SCALE):
    """(P's state, Q's state with every Normal centred on the latent the fake
    data were drawn with, at scale ``scale``)."""
    import torch
    from alan_tpu_torch.dims import DT
    from alan_tpu_torch.models import covid
    truth = covid.fake_data(seed=0)
    nD = problem.all_platedims["nDs"]
    st = problem.Q.state()
    qp = {}
    for k, v in st["qem_params"].items():
        name, arg = k.rsplit("_", 1)
        t = torch.as_tensor(truth[name][..., :nD] if name == "log_infected" else truth[name])
        qp[k] = DT((t if arg == "loc" else torch.full(t.shape, scale)).float().cuda(), v.dims)
    return (problem.P.state(), {**st, "qem_params": qp})


def phase_covid_posterior_k30(problem, step):
    """The covid posterior at full size (92 regions x 109 training days,
    extended to 137), K=30, N=100 draws, at Q after 5 QEM steps:
    ``marginals()`` (the chain kernels' forward and backward),
    ``importance_sample(100)`` (the forward at the root's and the regions'
    traversal, then FFBS over the days) and ``predict.predictive_ll_fn``
    over the 137 days, each driven once with the counters zeroed, then
    timed over 3 more; a profile of two importance samples.  Gate: the
    importance moments against the marginals' (``_moments_gate``) of
    InitialSize_log, psi and log_infected, where the marginal weights are a
    distribution; the same gate at Q centred on the latents the data came
    from (scale ``COVID_NEAR_TRUTH_SCALE``), where the chain contraction
    keeps every day's weights."""
    import torch
    from alan_tpu_torch import predict, reduce_ks
    from alan_tpu_torch.models import covid
    phase = "covid_posterior_k30"
    state = (problem.P.state(), problem.Q.state())
    gen = torch.Generator(device="cuda").manual_seed(10)
    for _ in range(POSTERIOR_QEM_STEPS):
        state, _ = step(state, gen)
    s = _posterior_sample(problem, state, K_COVID, 11)
    _, all_ps, _, all_data, _, all_cov = covid.load_data_covariates(seed=0, device="cuda")
    pll_f = predict.predictive_ll_fn(problem, K_COVID, N_COVID_DRAWS, all_ps)
    calls = {
        "marginals": lambda: s.marginals(),
        "importance_sample": lambda: s.importance_sample(N_COVID_DRAWS, gen),
        "predictive_ll": lambda: pll_f(*state, all_cov, all_data, gen),
    }
    res = {"phase": phase, "model": "covid", "nRs": all_ps["nRs"],
           "nDs_train": problem.all_platedims["nDs"], "nDs_all": all_ps["nDs"],
           "K": K_COVID, "draws": N_COVID_DRAWS, "qem_steps": POSTERIOR_QEM_STEPS,
           "ok": True}
    outs, launches = {}, {}
    for name, fn in calls.items():
        outs[name], first_ms, launches[name], peak = _driven(fn)
        if name == "importance_sample":
            res["ffbs_routes"] = [[r, list(ks)] for r, ks in reduce_ks._ffbs_routes]
        res[name] = {"first_call_ms": first_ms, "ms": _host_ms(fn),
                     "launches": launches[name], "peak_mem_gb": peak}
    must = {"marginals": {"smallk_fwd": 1, "smallk_bwd": 1},
            "importance_sample": {"smallk_fwd": 2}, "predictive_ll": {"smallk_fwd": 2}}
    for name, need in must.items():
        short = {k: launches[name][k] for k, n in need.items() if launches[name][k] < n}
        if short:
            res["ok"] = False
            fail(phase, f"{name} launched too few chain kernels {short}: {launches[name]}")
    if res["ffbs_routes"] != [["joint", ["K_log_infected"]]]:
        res["ok"] = False
        fail(phase, f"FFBS routes {res['ffbs_routes']}")
    marg, isamp, pll = outs["marginals"], outs["importance_sample"], outs["predictive_ll"]
    gvn = {"InitialSize_log": "a", "psi": "a", "log_infected": "log_infected"}
    sums = _weight_sums(marg, set(gvn.values()))
    res["marginal_weight_sums"] = sums
    res["min_ess"] = float(marg.min_ess())
    res["predictive_ll"]["value"] = {k: float(v) for k, v in pll.items()}
    res["moments_gate"] = {"variables": list(gvn),
                           **_moments_gate(marg, isamp, list(gvn), N_COVID_DRAWS)}
    finite = _all_finite([v.data for v in isamp.dump().values()] + list(pll.values()))
    res["finite"] = finite
    sums_ok = all(abs(a - 1) <= 1e-3 and abs(b - 1) <= 1e-3 for a, b in sums.values())
    if not sums_ok or not res["moments_gate"]["ok"] or not finite:
        res["ok"] = False
        fail(phase, f"moments gate {res['moments_gate']}, weight sums {sums}, "
                    f"finite {finite}")

    # the gate where the chain keeps every day's weights
    near = _covid_near_truth_state(problem)
    sn = _posterior_sample(problem, near, K_COVID, 12)
    marg_n = sn.marginals()
    isamp_n = sn.importance_sample(N_COVID_DRAWS, gen)
    sums_n = _weight_sums(marg_n, set(gvn.values()))
    gate_n = _moments_gate(marg_n, isamp_n, list(gvn), N_COVID_DRAWS)
    res["near_truth"] = {"q_scale": COVID_NEAR_TRUTH_SCALE, "marginal_weight_sums": sums_n,
                         "min_ess": float(marg_n.min_ess()), "moments_gate": gate_n}
    if not gate_n["ok"] or any(abs(a - 1) > 1e-3 or abs(b - 1) > 1e-3
                               for a, b in sums_n.values()):
        res["ok"] = False
        fail(phase, f"near-truth gate {gate_n}, weight sums {sums_n}")
    emit(res)
    _profile_step(phase, lambda st, g: (st, s.importance_sample(N_COVID_DRAWS, g)),
                  state, gen, res["importance_sample"]["ms"])
    return state, launches


def phase_covid_posterior_cross_check(problem, state):
    """The covid importance sample from the same particles and Gumbel noise
    through the chain kernels, through the dense chain route
    (``ALAN_TPU_NO_SMALLK_CHAIN=1``, which must launch no chain kernel)
    and on the host's CPU (the card and the host both at counts of a few
    hundred, see below): the share of draws that differ from the kernel
    route's.  The root's and the regions' draws must be near-ties where
    they differ, FFBS's where a chain first differs (``_compare_chain_draws``:
    the chain's later draws condition on another particle), but in the
    chains whose root or region index differs."""
    import numpy as np
    import torch
    from alan_tpu_torch.convert import dt_from_numpy
    from alan_tpu_torch.dims import DT
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.sample import Sample
    from alan_tpu_torch.split import no_checkpoint
    phase = "covid_posterior_cross_check"
    s = _posterior_sample(problem, state, K_COVID, 13)
    gen = torch.Generator(device="cuda").manual_seed(14)
    with _RecordedDraws() as draws_k:
        zero_counts()
        idx_k, _ = s._importance_sample_idxs(N_COVID_DRAWS, no_checkpoint, gen)
        launches_k = read_counts()
    noise = [g for g, _ in draws_k]
    os.environ["ALAN_TPU_NO_SMALLK_CHAIN"] = "1"
    try:
        with _RecordedDraws() as draws_d:
            zero_counts()
            t0 = time.perf_counter()
            idx_d, _ = s._importance_sample_idxs(N_COVID_DRAWS, no_checkpoint, noise=noise)
            torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            launches_d = read_counts()
    finally:
        del os.environ["ALAN_TPU_NO_SMALLK_CHAIN"]
    # the host's CPU: at covid's fake counts of 1e7 the NegativeBinomial's
    # probs lie within float32 ulps of 1, and the host and the card round
    # them ~4e-4 of the score apart (ROADMAP queue 3, "not faults"), above
    # the near-tie rule's 1e-4; the host and the card both score counts of
    # a few hundred instead, as the CPU parity tests do, from the same
    # particles, state and noise
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cpu")
    counts = np.random.default_rng(5).poisson(300.0, tuple(data["obs"].data.shape))
    obs = {d: {"obs": dt_from_numpy(counts.astype(np.float32), data["obs"].dims, d)}
           for d in ("cuda", "cpu")}
    card_cov = {k: DT(v.data.cuda(), v.dims) for k, v in cov.items()}
    s300 = Sample(covid.generate_problem(ps, obs["cuda"], card_cov, "qem", device="cuda"),
                  s.detached_sample, s.groupvarname2Kdim, s.sampler, False, states=state)
    with _RecordedDraws() as draws_k300:
        idx_k300, _ = s300._importance_sample_idxs(N_COVID_DRAWS, no_checkpoint, noise=noise)
    host = covid.generate_problem(ps, obs["cpu"], cov, "qem", device="cpu")
    hs = Sample(host, _tree_to(s.detached_sample, "cpu"), s.groupvarname2Kdim, s.sampler,
                False, states=tuple(_tree_to(x, "cpu") for x in state))
    with _RecordedDraws() as draws_h:
        t0 = time.perf_counter()
        idx_h, _ = hs._importance_sample_idxs(N_COVID_DRAWS, no_checkpoint,
                                              noise=[g.cpu() for g in noise])
        host_ms = (time.perf_counter() - t0) * 1e3
    n_ffbs = problem.all_platedims["nDs"]
    cpu = lambda d: [(g.cpu(), a.cpu()) for g, a in d]
    routes = {"dense": (draws_d, draws_k, idx_d, idx_k),
              "host_cpu_counts_300": (draws_h, cpu(draws_k300), idx_h, idx_k300)}
    res = {"phase": phase, "draws_per_route": len(draws_k), "ffbs_draws_per_route": n_ffbs,
           "launches_kernel_route": launches_k, "launches_dense_route": launches_d,
           "dense_route_ms_one_call": dense_ms, "host_ms_one_call": host_ms}
    ok = launches_k["smallk_fwd"] >= 2 and not (launches_d["smallk_fwd"]
                                                 or launches_d["smallk_bwd"])
    for name, (other, ref, idx_o, idx_r) in routes.items():
        above = _compare_draws(ref[:-n_ffbs], other[:-n_ffbs])
        ffbs = _compare_chain_draws(ref[-n_ffbs:], other[-n_ffbs:], excused=_excused_chains(
            idx_r, idx_o, "log_infected", "nDs"))
        res[name] = {"root_and_regions": above, "ffbs": ffbs}
        ok &= above["ok"] and ffbs["ok"]
    res["ok"] = ok
    if not ok:
        fail(phase, f"{res}")
    emit(res)


def _kalman_post_mean(y, T, A, init_scale, ts_noise_scale, obs_noise_scale):
    """The AR(1) chain's posterior mean given ``y``, Gaussian algebra: prior
    covariance of the chain, then the posterior precision with the
    observations' (``tests/model_timeseries.py``'s smoother)."""
    import numpy as np
    prior_cov = np.zeros((T, T))
    diag_var = init_scale ** 2
    for i in range(T):
        diag_var = diag_var * A ** 2 + ts_noise_scale ** 2
        future = diag_var * A ** np.arange(T - i)
        prior_cov[i, i:] = future
        prior_cov[i:, i] = future
    like_prec = np.eye(T) / obs_noise_scale ** 2
    post_cov = np.linalg.inv(np.linalg.inv(prior_cov) + like_prec)
    return post_cov @ like_prec @ np.asarray(y, np.float64)


def phase_ar1_ffbs_k1000():
    """AR(1) at K=1000, ``importance_sample(1000)``: the root contraction
    of the chain runs the fused log-matmul kernel, then FFBS over the 4
    steps.  Gate: each step's mean of the draws within 6 standard errors,
    sqrt(var (1 / ESS + 1 / N)) with the marginals' least ESS, of the Kalman
    smoother's mean."""
    import numpy as np
    import torch
    from alan_tpu_torch import reduce_ks
    from alan_tpu_torch.models import ar1
    phase = "ar1_ffbs_k1000"
    problem = ar1.generate_problem("cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    s = problem.sample(K_AR1, gen, reparam=False)
    fn = lambda: s.importance_sample(K_AR1, gen)
    fn()                                              # warm-up
    isamp, first_ms, launches, peak = _driven(fn)
    routes = [[r, list(ks)] for r, ks in reduce_ks._ffbs_routes]
    ms = _host_ms(fn)
    ts = isamp.dump()["ts"].with_dims_front(["T"]).data.double()
    ess = float(s.marginals().min_ess())
    marginals_ms = _host_ms(lambda: s.marginals())
    bwd = _fused_fixup_bwd_report(lambda: s.marginals(), phase)
    FIXUP_REPORTS["ar1_own_bwd"] = bwd
    mean = ts.mean(1).cpu().numpy()
    se = torch.sqrt(ts.var(1) * (1 / ess + 1 / K_AR1)).cpu().numpy()
    kalman = _kalman_post_mean(ar1.data_ts, ar1.T, ar1.A, ar1.init_scale,
                               ar1.ts_noise_scale, ar1.obs_noise_scale)
    dev = np.abs(mean - kalman)
    res = {"phase": phase, "K": K_AR1, "T": ar1.T, "draws": K_AR1, "ms_per_call": ms,
           "first_call_ms": first_ms, "peak_mem_gb": peak, "launches": launches,
           "ffbs_routes": routes, "min_ess": ess, "mean": mean.tolist(),
           "kalman_mean": kalman.tolist(), "dev_over_se": (dev / se).tolist(),
           "marginals_ms": marginals_ms, "fused_fixup_bwd_on_own_operators": bwd,
           "ok": True}
    if not (np.all(dev < 6 * se) and launches["logmmexp"] >= 2
            and routes == [["joint", ["K_ts"]]]):
        res["ok"] = False
        fail(phase, f"dev/se {dev / se}, launches {launches}, routes {routes}")
    if len(bwd) != 2 or not all(r["ok"] for r in bwd):
        res["ok"] = False
        fail(phase, f"marginals(): the fused backward's launches {bwd}")
    emit(res)
    return launches


# ---- the captured loop (phases 20 to 25) -------------------------------------------

#: bench.py's scan lengths (``N_STEPS`` and 4 N_STEPS) for the K=30 headline
#: and bench_scaling.grid_throughput's R; the shorter paths' lengths
SCAN_SHORT, SCAN_LONG = 20, 80
SCAN_GROUPED = (5, 20)
SCAN_COVID_STEPS, SCAN_AR1_STEPS, GLOBAL_STEPS = 5, 20, 5
VMAP_RS = (1, 4, 8)
#: nonmp_moments_streaming's particles and chunk
STREAM_K, STREAM_CHUNK = 1 << 16, 1 << 12


class _CountedCaptures:
    """While active, every CUDA graph capture zeroes the launch counters as
    it begins and records them as it ends.  A wrapper counts where it
    launches its kernel, and inside a capture that launch is recorded into
    the graph: the count of a capture is the launches of each replay."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        import torch
        self.original = original = torch.cuda.graph
        records = self.records

        class counted(original):
            def __enter__(self):
                zero_counts()
                return super().__enter__()

            def __exit__(self, *args):
                out = super().__exit__(*args)
                records.append(read_counts())
                return out
        torch.cuda.graph = counted
        return self

    def __exit__(self, *args):
        import torch
        torch.cuda.graph = self.original


def _state_compare(a, b, rtol=1e-4, atol=1e-4):
    """(all within rtol/atol, largest abs difference) of two states leaf by
    leaf, the constants of their specs equal."""
    import torch
    from alan_tpu_torch import train
    la, sa = train._flatten(a)
    lb, sb = train._flatten(b)
    if sa != sb:
        return False, float("inf")
    ok, worst = True, 0.0
    for x, y in zip(la, lb):
        x, y = x.double(), y.double()
        worst = max(worst, (x - y).abs().max().item() if x.numel() else 0.0)
        ok = ok and torch.allclose(x, y, rtol=rtol, atol=atol)
    return ok, worst


def _rel_diff(got, want):
    import torch
    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return ((got - want).abs() / want.abs().clamp(min=1e-30)).max().item()


def _scan_vs_eager(phase, step, state0, n, seed=5):
    """``n`` eager steps and ``scan_steps(step, n)`` from generators of one
    seed: each ELBO within 1e-5 relative, the final states within
    rtol/atol 1e-4, the two generators advanced alike.  Returns (run, the
    launches of each replay, the comparison's fields, peak GB of the
    captured call)."""
    import torch
    from alan_tpu_torch import train
    g_e = torch.Generator(device="cuda").manual_seed(seed)
    st_e, el_e = train._eager(step, n, state0, g_e)
    torch.cuda.synchronize()
    run = train.scan_steps(step, n)
    g_g = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    with _CountedCaptures() as cap:
        st_g, el_g = run(state0, g_g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rel = _rel_diff(el_g, el_e)
    state_ok, state_diff = _state_compare(st_g, st_e)
    same_gen = bool(torch.equal(g_e.get_state(), g_g.get_state()))
    fields = {"n_steps": n, "elbos_graph": el_g.tolist(), "elbos_eager": el_e.tolist(),
              "elbo_max_rel_diff": rel, "state_max_abs_diff": state_diff,
              "generators_equal": same_gen, "capture_s": run.capture_seconds,
              "captures": len(cap.records)}
    ok = (rel <= 1e-5 and state_ok and same_gen and _finite(el_g.tolist())
          and len(cap.records) == 1)
    if not ok:
        fail(phase, f"graphed against eager: {fields}")
    return run, (cap.records[0] if cap.records else {}), fields, peak, ok, st_g


def _slope_ms(run_short, run_long, state0, seed=5):
    """``bench.py``'s rule (``bench.py:69-95``): the ms of one step is the
    slope between a short and a long call, each ended by a synchronise,
    the median of the positive slopes (up to 3 rounds of 3)."""
    import torch
    n_s, n_l = run_short.n_steps, run_long.n_steps
    for run in (run_short, run_long):          # captured and warm
        run(state0, torch.Generator(device="cuda").manual_seed(seed))
    capture_long = run_long.capture_seconds
    dts, pos = [], []
    for _ in range(3):
        for _ in range(3):
            t = {}
            for n, run in ((n_s, run_short), (n_l, run_long)):
                g = torch.Generator(device="cuda").manual_seed(seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(state0, g)
                torch.cuda.synchronize()
                t[n] = time.perf_counter() - t0
            dts.append((t[n_l] - t[n_s]) / (n_l - n_s) * 1e3)
        pos = [d for d in dts if d > 0]
        if len(pos) >= 2:
            break
    return (statistics.median(pos) if pos else float("nan")), dts, capture_long


#: kernel names in the profiler's rows that show each counter's kernel ran
#: inside a replay
KERNEL_NAMES = {"lowrank_fwd": "lse_tc_kernel", "lowrank_bwd_dD": "lse_tc_kernel",
                "lowrank_bwd_dU": "lse_tc_kernel", "lowrank_bwd_dV": "lse_bwd_dv_reduce",
                "smallk_fwd": "segment_fwd_kernel", "smallk_bwd": "segment_bwd_kernel",
                "logmmexp": "logmmexp_product_kernel"}


def _profile_run(phase, run, state0, ms_per_step, must_launch):
    """A profile of one call of ``run`` (its replays): device busy and idle
    share per step, and the calls of each kernel that ``must_launch`` names
    (``KERNEL_NAMES``), which must appear in the replays."""
    import torch
    n = run.n_steps
    gen = torch.Generator(device="cuda").manual_seed(9)
    prof = _profile_step(f"{phase}_replay", lambda st, g: run(st, g), state0, gen,
                         ms_per_step * n)
    calls = {}
    for _, key, count in prof["rows"]:
        for name in {KERNEL_NAMES[k] for k in must_launch}:
            if name in key:
                calls[name] = calls.get(name, 0) + count
    missing = [k for k in must_launch if calls.get(KERNEL_NAMES[k], 0) < 2 * n]
    if missing:
        fail(phase, f"kernels {missing} not in the profiled replays: {calls}")
    return {"device_busy_ms_per_step": prof["device_busy_ms"] / prof["steps"] / n,
            "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
            "profiled_kernel_calls": calls, "profiled_steps": prof["steps"] * n}


def _scan_phase(phase, step, state0, n_short, n_long, must_launch, info,
                per_replay=None, gate=None):
    """A captured training path: graphed against eager over ``n_short``
    steps (``_scan_vs_eager``), the launches of each replay (each kernel of
    ``must_launch`` at least once, or exactly ``per_replay``), ms/step by
    the slope rule over ``n_short`` and ``n_long`` steps (and the seconds
    the long loop's capture took), a profiled call.
    Returns (result line, launches of each replay)."""
    import torch
    from alan_tpu_torch import train
    run_s, launches, fields, peak, ok, st_g = _scan_vs_eager(phase, step, state0, n_short)
    if per_replay is not None:
        bad = {k: launches.get(k) for k, v in per_replay.items() if launches.get(k) != v}
    else:
        bad = {k: launches.get(k) for k in must_launch if launches.get(k, 0) < 1}
    if bad:
        ok = False
        fail(phase, f"launches per replay {launches}, wanted {per_replay or must_launch}")
    if gate is not None:
        ok = gate(fields, st_g) and ok
    run_l = train.scan_steps(step, n_long)
    ms, slopes, capture_long = _slope_ms(run_s, run_l, state0)
    SLOPE_MS[phase] = ms
    prof = _profile_run(phase, run_s, state0, ms, must_launch)
    res = {"phase": phase, **info, "ms_per_step": ms, "slopes_ms": slopes,
           "capture_s": fields.pop("capture_s"),
           "capture_s_long": capture_long, "peak_mem_gb": peak,
           "launches_per_replay": {k: v for k, v in launches.items() if v},
           "replays": n_short, **prof, **fields, "ok": ok}
    emit(res)
    del run_s, run_l
    torch.cuda.empty_cache()
    return res, launches


def phase_scan_headline_k30(problem):
    """``bench.py``'s mode: ``train.scan_steps`` of the ungrouped MovieLens
    QEM step at K=30, 20 and 80 steps."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import movielens as ml
    step, state0 = train.qem(problem, K_HEADLINE, lr=LR_QEM)
    res, _ = _scan_phase("scan_headline_k30", step, state0, SCAN_SHORT, SCAN_LONG, [],
                         {"model": "movielens", "K": K_HEADLINE, "M": ml.M, "N": ml.N})
    emit({"phase": "scan_headline_k30", "summary": True, "ms_per_step": res["ms_per_step"],
          "samples_per_s": K_HEADLINE * (2 + ml.M) / (res["ms_per_step"] / 1e3),
          "capture_s": res["capture_s"], "device_busy_ms_per_step":
              res["device_busy_ms_per_step"],
          "device_idle_share_unprofiled": res["device_idle_share_unprofiled"],
          "peak_mem_gb": res["peak_mem_gb"]})
    return res


def phase_scan_grouped_k1000(problem):
    """Grouped MovieLens at K=1000, QEM and VI, 5 and 20 steps captured:
    QEM replays the lowrank forward and ``MODE_DD``, VI ``MODE_DU`` and
    ``MODE_DV``, in every step."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import movielens as ml
    step, state0 = train.qem(problem, K_MAIN, lr=LR_QEM)
    qem, qem_l = _scan_phase("scan_grouped_k1000_qem", step, state0, *SCAN_GROUPED,
                             ["lowrank_fwd", "lowrank_bwd_dD"],
                             {"model": "grouped_movielens", "method": "qem", "K": K_MAIN})
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    opt_problem = ml.grouped_problem(ps, data, cov, "opt", device="cuda")
    step, state0 = train.vi(opt_problem, K_MAIN, lr=0.01)
    vi, vi_l = _scan_phase("scan_grouped_k1000_vi", step, state0, *SCAN_GROUPED,
                           ["lowrank_fwd", "lowrank_bwd_dU", "lowrank_bwd_dV"],
                           {"model": "grouped_movielens_opt", "method": "vi", "K": K_MAIN})
    return {"scan_grouped_k1000_qem": (qem_l, qem["replays"]),
            "scan_grouped_k1000_vi": (vi_l, vi["replays"])}


def phase_scan_covid_k30(problem):
    """Covid QEM at full size, K=30, 5 steps captured: 3 forward and 3
    backward chain launches in each replay."""
    from alan_tpu_torch import train
    step, state0 = train.qem(problem, K_COVID, lr=LR_QEM)
    res, launches = _scan_phase("scan_covid_k30", step, state0, SCAN_COVID_STEPS,
                                4 * SCAN_COVID_STEPS, ["smallk_fwd", "smallk_bwd"],
                                {"model": "covid", "K": K_COVID},
                                per_replay={"smallk_fwd": 3, "smallk_bwd": 3})
    return {"scan_covid_k30": (launches, res["replays"])}


def phase_scan_ar1_k1000():
    """20 AR(1) ELBOs at K=1000 as a captured loop (a step that keeps its
    state and returns ``elbo_fn``'s ELBO): 2 fused launches each, and the
    graphed draws bracket the exact Kalman log-likelihood."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import ar1
    problem = ar1.generate_problem("cuda")
    f = train.elbo_fn(problem, K_AR1, reparam=False)

    def step(state, generator):
        return state, f(state[0], state[1], generator).detach()

    def bracket(fields, _):
        lo, hi, ok = _kalman_bracket(fields["elbos_graph"])
        fields.update(bracket=[lo, hi], known_elbo=ar1.known_elbo)
        if not ok:
            fail("scan_ar1_k1000", f"ELBO bracket {lo, hi} vs exact {ar1.known_elbo}")
        return ok

    res, launches = _scan_phase("scan_ar1_k1000", step,
                                (problem.P.state(), problem.Q.state()),
                                SCAN_AR1_STEPS, 4 * SCAN_AR1_STEPS, ["logmmexp"],
                                {"model": "ar1", "K": K_AR1}, per_replay={"logmmexp": 2},
                                gate=bracket)
    return {"scan_ar1_k1000": (launches, res["replays"])}


def phase_vmap_runs_k30(problem):
    """``bench_scaling.grid_throughput``'s shape: the K=30 headline, R = 1, 4
    and 8 runs of 20 (and 80) steps through ``train.vmap_runs``: ms/iter
    and ms/run-iter by the slope rule; row r equals ``scan_steps`` from run
    r's generator (1e-5 relative), rows 0 and 1 differ."""
    import torch
    from alan_tpu_torch import train
    phase = "vmap_runs_k30"
    step, state0 = train.qem(problem, K_HEADLINE, lr=LR_QEM)
    seed, n = 11, SCAN_SHORT
    single = train.scan_steps(step, n)
    out, ok = {}, True
    for R in VMAP_RS:
        runs = {m: train.vmap_runs(step, m, R) for m in (n, 4 * n)}
        states, elbos = runs[n](state0, seed)
        runs[4 * n](state0, seed)
        torch.cuda.synchronize()
        capture = runs[n].capture_seconds + runs[4 * n].capture_seconds
        rows = []
        for r in range(R):
            _, e = single(state0, train.run_generator(seed, r, "cuda"))
            rows.append(_rel_diff(elbos[r], e))
        distinct = R < 2 or not torch.allclose(elbos[0], elbos[1])
        best = None
        for _ in range(3):
            t = {}
            for m, many in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                many(state0, seed)
                torch.cuda.synchronize()
                t[m] = time.perf_counter() - t0
            dt = (t[4 * n] - t[n]) / (3 * n) * 1e3
            best = dt if best is None else min(best, dt)
        row_ok = max(rows) <= 1e-5 and distinct and tuple(elbos.shape) == (R, n)
        ok = ok and row_ok
        if not row_ok:
            fail(phase, f"R={R}: rows against scan_steps {rows}, distinct {distinct}")
        out[f"R{R}"] = {"ms_per_iter": best, "ms_per_run_iter": best / R,
                        "capture_s": capture,
                        "row_max_rel_diff": max(rows), "rows_distinct": distinct}
        del runs, states
        torch.cuda.empty_cache()
    emit({"phase": phase, "K": K_HEADLINE, "n_steps": n, **out, "ok": ok})


def phase_global_k30(problem):
    """``global_vi``, ``global_rws`` and ``global_qem`` on the K=30
    headline model, 5 steps each, eager and through ``scan_steps``; then
    ``nonmp_moments_streaming`` at 2^16 particles in chunks of 2^12 against
    one global softmax over the same chunks, on MovieLens (ESS 1: both read
    one particle) and on synthetic_model against its analytic posterior."""
    import torch
    from alan_tpu_torch import mean, train
    from alan_tpu_torch.models import movielens as ml
    phase = "global_k30"
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    opt_problem = ml.generate_problem(ps, data, cov, "opt", device="cuda")
    res, ok = {"phase": phase, "K": K_HEADLINE}, True
    for method, prob in (("global_vi", opt_problem), ("global_rws", opt_problem),
                         ("global_qem", problem)):
        step, state0 = getattr(train, method)(prob, K_HEADLINE)
        run, _, fields, peak, m_ok, _ = _scan_vs_eager(phase, step, state0, GLOBAL_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state0, torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        fields["graphed_ms_per_step"] = (time.perf_counter() - t0) / GLOBAL_STEPS * 1e3
        t0 = time.perf_counter()
        train._eager(step, GLOBAL_STEPS, state0, torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        fields["eager_ms_per_step"] = (time.perf_counter() - t0) / GLOBAL_STEPS * 1e3
        res[method] = {**fields, "peak_mem_gb": peak}
        ok = ok and m_ok
        del run
    # streaming against one global softmax over the same chunks
    stream, s_ok = _streaming_vs_softmax(problem, [("mu_z", mean), ("z", mean)], 13)
    del stream["streamed"], stream["softmax"]
    res["streaming"] = stream
    if not s_ok:
        fail(phase, f"streaming against one softmax: {stream}")
    # a case that can fail: synthetic_model's conjugate posterior, known
    res["synthetic"], syn_ok = _streaming_synthetic()
    if not syn_ok:
        fail(phase, f"synthetic_model against its analytic posterior: {res['synthetic']}")
    res["ok"] = ok and s_ok and syn_ok
    emit(res)
    torch.cuda.empty_cache()


def _streaming_vs_softmax(problem, moms, seed):
    """``nonmp_moments_streaming`` at 2^16 particles in chunks of 2^12 and
    one global softmax over the same chunks: (fields, ELBO within 1e-5
    relative and each moment within 1e-5 of its largest entry); the
    fields carry the softmax's ESS and moments (``ref``)."""
    import torch
    from alan_tpu_torch.dims import as_dt
    from alan_tpu_torch.ir.plate import flatten_tree
    from alan_tpu_torch.sample_nonmp import nonmp_moments_streaming
    from alan_tpu_torch.utils import fold_seed, seeded_generator
    t0 = time.perf_counter()
    got, elbo = nonmp_moments_streaming(problem, STREAM_K, STREAM_CHUNK, moms, seed)
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3
    os_, fs, rest = [], [[] for _ in moms], [None] * len(moms)
    with torch.no_grad():
        for c in range(STREAM_K // STREAM_CHUNK):
            s = problem.sample_nonmp(STREAM_CHUNK, seeded_generator(fold_seed(seed, c), "cuda"),
                                     reparam=False)
            os_.append(s.logpq(s.detached_sample).order(s.Kdim).data)
            flat = flatten_tree(s.detached_sample)
            for i, (vn, m) in enumerate(moms):
                f = as_dt(m.f(flat[vn])).with_dims_front([s.Kdim])
                fs[i].append(f.data)
                rest[i] = list(f.dims[1:])
        o = torch.cat(os_)
        w = torch.softmax(o, dim=0)
        ref_elbo = torch.logsumexp(o, 0) - math.log(o.numel())
        diffs, refs, gots = [], [], []
        for i, g in enumerate(got):
            ref = torch.tensordot(w, torch.cat(fs[i]), dims=([0], [0]))
            d = (g.with_dims_front(rest[i]).data - ref).abs().max().item()
            diffs.append(d / ref.abs().max().clamp(min=1e-30).item())
            refs.append(ref.double().cpu().numpy())
            gots.append(g.with_dims_front(rest[i]).data.double().cpu().numpy())
    elbo_rel = _rel_diff(elbo, ref_elbo)
    fields = {"K_total": STREAM_K, "chunk": STREAM_CHUNK, "ms": stream_ms,
              "elbo": float(elbo), "elbo_rel_diff": elbo_rel,
              "moment_max_diff_rel_to_max": diffs, "ess": float(1.0 / (w * w).sum()),
              "streamed": gots, "softmax": refs}
    return fields, max(diffs) <= 1e-5 and elbo_rel <= 1e-5


def _streaming_synthetic():
    """``synthetic_model`` (conjugate) with a fixed Q at the analytic
    posterior, its scale doubled (an importance efficiency of sqrt(7) / 4
    = 0.66, so an ESS of ~4.3e4 of 2^16): the streamed posterior mean of
    ``mean`` against the one global softmax (1e-5 relative) and against
    the analytic mean (6 standard errors, sd / sqrt(ESS)); ESS >= 1000."""
    from alan_tpu_torch import mean
    from alan_tpu_torch.bound import BoundPlate
    from alan_tpu_torch.ir import Data, Normal, Plate
    from alan_tpu_torch.models import synthetic_model as sm
    from alan_tpu_torch.problem import Problem
    ps, _, data, _, cov, _ = sm.load_data_covariates(seed=0, device="cuda")
    loc, sd = (float(v) for v in sm.posterior(data["obs"].data.cpu().numpy()))
    Q = BoundPlate(Plate(mean=Normal(loc, 2 * sd), plate_1=Plate(obs=Data())), ps,
                   inputs=cov, device="cuda")
    problem = Problem(sm.get_P(ps, cov, "cuda"), Q, data, device="cuda")
    fields, ok = _streaming_vs_softmax(problem, [("mean", mean)], 17)
    streamed = float(fields["streamed"][0])
    se = sd / math.sqrt(fields["ess"])
    fields.update(posterior_mean=loc, posterior_sd=sd, q_scale=2 * sd,
                  streamed_mean=streamed, standard_errors=abs(streamed - loc) / se,
                  expected_ess=STREAM_K * math.sqrt(7) / 4)
    fields["streamed"], fields["softmax"] = streamed, float(fields["softmax"][0])
    ok = ok and fields["ess"] >= 1000 and bool(abs(streamed - loc) <= 6 * se)
    return fields, ok


# ---- the seventh slice: every family, the factored forms, covid corr_Q ---------

#: draws per family on the card (matrix families: FAMILY_MATRIX_DRAWS)
FAMILY_DRAWS, FAMILY_MATRIX_DRAWS = 200_000, 20_000


def _family_cases():
    """name -> (params, (mean, var, rtol) or None, event shape): the
    parameters and analytic moments of ``tests/test_families.py``, and for
    the families that file leaves out, moments of their own."""
    import numpy as np
    from math import gamma as G, pi
    cat = np.array([0.2, 0.5, 0.3])
    A = np.array([[2.0, 0.5], [0.5, 1.0]])
    cov = A @ A.T
    W = np.array([[1.0, 0.5], [-0.3, 0.8]])
    lr_cov = W @ W.T + np.diag([0.5, 0.2])
    V = np.array([[1.0, 0.3], [0.3, 2.0]])
    dirm = np.array([0.2, 0.3, 0.5])
    kum_m = 3.0 * G(1.5) * G(3.0) / G(4.5)
    kum_m2 = 3.0 * G(2.0) * G(3.0) / G(5.0)
    wei_m = 2.0 * G(1 + 1 / 1.5)
    # ContinuousBernoulli(0.3)'s mean and variance in closed form
    lam = 0.3
    cb_m = lam / (2 * lam - 1) + 1 / np.log((1 - lam) / lam)
    cb_v = lam * (lam - 1) / (1 - 2 * lam) ** 2 + 1 / np.log((1 - lam) / lam) ** 2
    return {
        "Normal": ({"loc": 1.5, "scale": 2.0}, (1.5, 4.0, 0.05), ()),
        "HalfNormal": ({"scale": 2.0}, (2.0 * np.sqrt(2 / pi), 4.0 * (1 - 2 / pi), 0.05), ()),
        "Cauchy": ({"loc": 0.5, "scale": 1.5}, None, ()),
        "HalfCauchy": ({"scale": 1.5}, None, ()),
        "LogNormal": ({"loc": 0.2, "scale": 0.5},
                      (np.exp(0.325), (np.exp(0.25) - 1) * np.exp(0.65), 0.05), ()),
        "Uniform": ({"low": -1.0, "high": 3.0}, (1.0, 16 / 12, 0.05), ()),
        "Exponential": ({"rate": 2.0}, (0.5, 0.25, 0.05), ()),
        "Gamma": ({"concentration": 3.0, "rate": 2.0}, (1.5, 0.75, 0.05), ()),
        "Chi2": ({"df": 5.0}, (5.0, 10.0, 0.05), ()),
        "Beta": ({"concentration1": 2.0, "concentration0": 3.0}, (0.4, 0.04, 0.05), ()),
        "StudentT": ({"df": 5.0, "loc": 1.0, "scale": 2.0}, (1.0, 4.0 * 5 / 3, 0.1), ()),
        "Laplace": ({"loc": 0.5, "scale": 1.5}, (0.5, 4.5, 0.05), ()),
        "Gumbel": ({"loc": 0.5, "scale": 1.5},
                   (0.5 + 1.5 * np.euler_gamma, (pi * 1.5) ** 2 / 6, 0.05), ()),
        "Kumaraswamy": ({"concentration1": 2.0, "concentration0": 3.0},
                        (kum_m, kum_m2 - kum_m ** 2, 0.05), ()),
        "Pareto": ({"scale": 1.0, "alpha": 3.0}, (1.5, 0.75, 0.3), ()),
        "Weibull": ({"scale": 2.0, "concentration": 1.5},
                    (wei_m, 4.0 * G(1 + 2 / 1.5) - wei_m ** 2, 0.05), ()),
        "FisherSnedecor": ({"df1": 5.0, "df2": 8.0},
                           (8 / 6, 2 * 8 ** 2 * 11 / (5 * 36 * 4), 0.2), ()),
        "VonMises": ({"loc": 0.5, "concentration": 2.0}, None, ()),
        "Bernoulli": ({"probs": 0.3}, (0.3, 0.21, 0.05), ()),
        "ContinuousBernoulli": ({"probs": 0.3}, (cb_m, cb_v, 0.05), ()),
        "Binomial": ({"total_count": 10.0, "probs": 0.3}, (3.0, 2.1, 0.05), ()),
        "Poisson": ({"rate": 4.0}, (4.0, 4.0, 0.05), ()),
        "Geometric": ({"probs": 0.3}, (0.7 / 0.3, 0.7 / 0.09, 0.1), ()),
        "NegativeBinomial": ({"total_count": 5.0, "probs": 0.4},
                             (5 * 0.4 / 0.6, 5 * 0.4 / 0.36, 0.1), ()),
        "Categorical": ({"probs": cat}, (cat @ np.arange(3),
                                         cat @ np.arange(3) ** 2 - (cat @ np.arange(3)) ** 2,
                                         0.05), ()),
        "OneHotCategorical": ({"probs": cat}, (cat, cat * (1 - cat), 0.05), (3,)),
        "Multinomial": ({"total_count": 4.0, "probs": cat}, (4 * cat, 4 * cat * (1 - cat), 0.05),
                        (3,)),
        "Dirichlet": ({"concentration": np.array([2.0, 3.0, 5.0])},
                      (dirm, dirm * (1 - dirm) / 11, 0.05), (3,)),
        "MultivariateNormal": ({"loc": np.array([1.0, -1.0]), "covariance_matrix": cov},
                               (np.array([1.0, -1.0]), np.diag(cov), 0.05), (2,)),
        "LowRankMultivariateNormal": (
            {"loc": np.array([0.5, 0.0]), "cov_factor": W, "cov_diag": np.array([0.5, 0.2])},
            (np.array([0.5, 0.0]), np.diag(lr_cov), 0.05), (2,)),
        "LogitRelaxedBernoulli": ({"temperature": 0.5, "logits": 0.4},
                                  (0.8, 4.0 * pi ** 2 / 3, 0.05), ()),
        "RelaxedBernoulli": ({"temperature": 0.5, "probs": 0.3}, None, ()),
        "RelaxedOneHotCategorical": ({"temperature": 0.7, "probs": cat}, None, (3,)),
        "Wishart": ({"df": 5.0, "covariance_matrix": V},
                    (5.0 * V, 5.0 * (V ** 2 + np.outer(np.diag(V), np.diag(V))), 0.05), (2, 2)),
        "LKJCholesky": ({"dim": 3, "concentration": 1.5}, None, (3, 3)),
    }


def _family_criterion(name, x, params):
    """(ok, value) of a family without moments above: Cauchy and
    HalfCauchy their quartiles, VonMises its circular mean and resultant
    length, the relaxed families their logistic and argmax laws, the
    LKJCholesky a unit diagonal and its correlations' variance."""
    import numpy as np
    if name == "Cauchy":
        v = float(np.mean(np.abs(x - 0.5) < 1.5))
        return abs(v - 0.5) < 0.005, v
    if name == "HalfCauchy":
        v = float(np.mean(x < 1.5))
        return abs(v - 0.5) < 0.005 and bool(np.all(x >= 0)), v
    if name == "VonMises":
        z = np.exp(1j * x.astype(np.float64)).mean()
        r = 0.6978556                                  # I1(2) / I0(2)
        return (abs(np.angle(z) - 0.5) < 0.02 and abs(abs(z) - r) < 0.01
                and bool(np.all(np.abs(x) <= np.pi))), [float(np.angle(z)), float(abs(z))]
    if name == "RelaxedBernoulli":
        # sigmoid of a logistic of location logit(0.3) / 0.5 and scale 2
        want = 1 / (1 + np.exp(np.log(0.3 / 0.7) / 0.5 / 2.0))
        v = float(np.mean(x < 0.5))
        return abs(v - want) < 0.005 and bool(np.all((x >= 0) & (x <= 1))), v
    if name == "RelaxedOneHotCategorical":
        freq = np.bincount(x.argmax(-1), minlength=3) / len(x)
        return (bool(np.allclose(freq, params["probs"], atol=0.01))
                and bool(np.allclose(x.sum(-1), 1.0, atol=1e-5))), freq.tolist()
    if name == "LKJCholesky":
        C = x.astype(np.float64) @ np.swapaxes(x, -1, -2)
        b = 1.5 - 1 + 1.5
        v = float(C[:, 1, 0].var())
        return (bool(np.allclose(np.diagonal(C, axis1=-2, axis2=-1), 1.0, atol=1e-5))
                and abs(v - 1 / (2 * b + 1)) < 0.01), v
    raise KeyError(name)


def phase_families_cuda():
    """Every family on the card: 2e5 draws (2e4 of a matrix) from a CUDA
    generator, gated by ``check_mean_var``'s rule of
    ``tests/test_families.py`` (the mean within 6 standard errors + 0.02,
    the variance within its rtol + 0.02, elementwise) or by the family's
    own criterion; ``log_prob`` of 1000 draws on the card against the same
    call on the host's CPU (1e-5 of max(1, |value|)); and for the
    reparameterised families, the gradient of a function of the draws
    from the card's noise with respect to every parameter, against the
    host's from the same noise (rtol 1e-4, atol 1e-4 of the largest).  No
    kernel of this repo runs: it checks that every sampler, and every
    implicit gradient, runs on a CUDA generator and its tensors."""
    import numpy as np
    import torch
    from alan_tpu_torch.distributions import families as F
    phase = "families_cuda"
    res, ok = {}, True
    t0 = time.perf_counter()
    for name, (params, moments, ev) in _family_cases().items():
        fam = F.FAMILIES[name]
        n = FAMILY_MATRIX_DRAWS if len(ev) == 2 else FAMILY_DRAWS

        def on(device, grad=False):
            p = {k: torch.tensor(np.asarray(v, np.float32), device=device,
                                 requires_grad=grad and k != "dim")
                 for k, v in params.items()}
            return p, fam.canonicalize(dict(p))
        _, p_card = on("cuda")
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = fam.sample(gen, (n, *ev), p_card)
        torch.cuda.synchronize()
        xs = x.float().cpu().numpy()
        row = {"draws": n, "finite": bool(np.all(np.isfinite(xs)))}
        if moments is not None:
            mean, var, rtol = moments
            se = np.sqrt(np.asarray(var) / n)
            m, v = xs.mean(0), xs.var(0)
            row.update(mean=np.round(np.asarray(m, np.float64), 6).tolist(),
                       var=np.round(np.asarray(v, np.float64), 6).tolist())
            good = bool(np.all(np.abs(m - mean) < 6 * se + 0.02)
                        and np.allclose(v, var, rtol=rtol, atol=0.02))
        else:
            good, row["criterion"] = _family_criterion(name, xs, params)
        pts = x[:1000]
        lp_card = fam.log_prob(pts, p_card)
        lp_host = fam.log_prob(pts.cpu(), on("cpu")[1])
        lp_err = ((lp_card.cpu() - lp_host).abs() / lp_host.abs().clamp(min=1.0)).max().item()
        row["log_prob_rel_err"] = lp_err
        good = good and row["finite"] and lp_err <= 1e-5
        if fam.has_rsample:
            leaves_c, pc = on("cuda", grad=True)
            leaves_h, ph = on("cpu", grad=True)
            eps = fam.noise(torch.Generator(device="cuda").manual_seed(8), (2000, *ev), pc)
            keys = [k for k, v in leaves_c.items() if v.requires_grad]
            gc = torch.autograd.grad(torch.sin(fam.from_noise(eps, pc)).sum(),
                                     [leaves_c[k] for k in keys])
            gh = torch.autograd.grad(torch.sin(fam.from_noise(eps.cpu(), ph)).sum(),
                                     [leaves_h[k] for k in keys])
            gerr = max(((a.cpu() - b).abs() / (1e-4 * (1 + b.abs()))).max().item()
                       for a, b in zip(gc, gh))
            row["grad_err_over_tol"] = gerr
            good = good and gerr <= 1.0
        row["ok"] = good
        res[name] = row
        if not good:
            ok = False
            fail(phase, f"{name}: {row}")
    emit({"phase": phase, "families": len(res), "seconds": time.perf_counter() - t0,
          "by_family": res, "ok": ok})


#: K and the plate of grouped MovieLens at K=1000 (``main_path``)
LOWRANK_FAMILIES_KP = (1000, 300)


def _family_factor(name, dtype, requires_grad):
    """A factor of ``name`` between K_z and K_g: x over (K_z, plate_1), its
    parameters over K_g (one scalar latent per plate cell, so F = 1 or 2),
    an x-side term over (K_z, plate_1); numpy seed by family."""
    import zlib
    import numpy as np
    import torch
    from alan_tpu_torch.dims import DT
    K, P = LOWRANK_FAMILIES_KP
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    pos = lambda *s, lo=0.3, sc=1.0: np.abs(rng.standard_normal(s)) * sc + lo
    if name == "LogNormal":
        x = np.exp(rng.standard_normal((K, P)) * 0.5)
        params = {"loc": rng.standard_normal(K) * 0.3, "scale": pos(K, lo=0.4, sc=0.3)}
    elif name == "Exponential":
        x, params = pos(K, P), {"rate": pos(K, lo=0.5)}
    elif name == "Gamma":
        x, params = pos(K, P), {"concentration": pos(K, lo=1.0, sc=2.0), "rate": pos(K, lo=0.5)}
    elif name == "Chi2":
        x, params = pos(K, P, sc=3.0), {"df": pos(K, lo=1.0, sc=3.0)}
    else:  # Beta
        u = pos(K, P)
        x, params = u / (u + 1.2), {"concentration1": pos(K, lo=0.8, sc=2.0),
                                    "concentration0": pos(K, lo=0.8, sc=2.0)}
    side = rng.standard_normal((K, P))
    mk = lambda a, dims: DT(torch.tensor(a, dtype=dtype, device="cuda",
                                         requires_grad=requires_grad), dims)
    return (mk(x, ("K_z", "plate_1")), {k: mk(v, ("K_g",)) for k, v in params.items()},
            mk(side, ("K_z", "plate_1")))


def _family_contract(name, dtype, env, record=None):
    """logsumexp over K_z of the factor plus its x-side term, its value and
    the gradients (weighted by a fixed cotangent) of x, the parameters and
    the x-side term, through the route ``env`` selects."""
    import numpy as np
    import torch
    from alan_tpu_torch.dims import logsumexp_dims
    from alan_tpu_torch.distributions import families as F
    from alan_tpu_torch.distributions.dimdist import DimDist
    from alan_tpu_torch.ops import lowrank as tlr
    x, params, side = _family_factor(name, dtype, True)
    leaves = [x.data, *(v.data for v in params.values()), side.data]
    kernel = tlr.lowrank_logsumexp
    if record is not None:
        def recording(U, V, D):
            record.append((U.detach(), V.detach(), D.detach()))
            return kernel(U, V, D)
        tlr.lowrank_logsumexp = recording
    os.environ.update(env)
    try:
        lp = DimDist(F.FAMILIES[name], **params).log_prob(x)
        lazy = getattr(lp, "__lazy_dt__", False)
        out = lp.contract(("K_z",), [side]) if lazy else None
        if out is None:
            out = logsumexp_dims(lp + side, ("K_z",))
        out = out.with_dims_front(["plate_1", "K_g"]).data
        G = torch.from_numpy(np.random.default_rng(1).standard_normal(
            tuple(out.shape))).to(device="cuda", dtype=dtype)
        grads = torch.autograd.grad(out, leaves, G)
        torch.cuda.synchronize()
    finally:
        tlr.lowrank_logsumexp = kernel
        for k in env:
            del os.environ[k]
    return lazy, out.detach(), grads


def phase_lowrank_families_k1000():
    """The factored forms of the LogNormal, Exponential, Gamma, Chi2 and
    Beta at grouped MovieLens K=1000's sizes (K_z = K_g = 1000, plate 300):
    the lazy factor contracted through ``LowRankDT.contract``, which
    launches the lowrank forward (row 1) and the backward once (row 2, in
    ``MODE_DU``, which gives dD beside dU, and with dV: x, the parameters
    and the x-side term all carry a gradient), at rank F = 1 (Exponential)
    or 2, against
    the materialised route (``ALAN_TPU_NO_LAZY_LOWRANK=1``): value 1e-5
    relative, gradients rtol/atol 1e-4, or (the f64 rule of
    ``_check_case``) at least as close as the materialised route to the
    float64 evaluation.  Then each kernel's ms at that F, on the operands
    the contraction handed it."""
    import torch
    from alan_tpu_torch.ops import lowrank_kernel as lk
    phase = "lowrank_families_k1000"
    lazy_env = {"ALAN_TPU_LOWRANK_MIN": "1", "ALAN_TPU_LAZY_LOWRANK": "1"}
    dense_env = {"ALAN_TPU_LOWRANK_MIN": "1", "ALAN_TPU_NO_LAZY_LOWRANK": "1"}
    rows, launches_all = {}, {}
    for name in ("LogNormal", "Exponential", "Gamma", "Chi2", "Beta"):
        record = []
        zero_counts()
        lazy, out_k, g_k = _family_contract(name, torch.float32, lazy_env, record)
        launches = read_counts()
        _, out_d, g_d = _family_contract(name, torch.float32, dense_env)
        _, out_e, g_e = _family_contract(name, torch.float64, dense_env)
        row = {"lazy": lazy, "launches": {k: v for k, v in launches.items() if v},
               "ok": lazy}
        _check(row, phase, name, "out", out_k, out_d, out_e, 1e-5, 1e-5, True)
        for n_, a, b, c in zip(["x", *range(len(g_k) - 2), "side"], g_k, g_d, g_e):
            _check(row, phase, name, f"d_{n_}", a, b, c, 1e-4, 1e-4, True)
        need = ("lowrank_fwd", "lowrank_bwd", "lowrank_bwd_dU", "lowrank_bwd_dV")
        if not lazy or any(launches[k] != 1 for k in need):
            row["ok"] = False
            fail(phase, f"{name}: lazy {lazy}, launches {launches}")
        U, V, D = record[0]
        S, Pp, I, F = U.shape
        J = V.shape[1]
        G = torch.randn(S, Pp, J, device="cuda")
        o, rnd = lk._launch_fwd(U, V, D)
        row.update(shape=[S, Pp, I, J, F], F=F,
                   fwd_ms=cuda_ms(lambda: lk._launch_fwd(U, V, D)),
                   bwd_dD_ms=cuda_ms(lambda: lk._launch_bwd(U, V, D, o, rnd, G, False, False)),
                   bwd_all_grads_ms=cuda_ms(lambda: lk._launch_bwd(U, V, D, o, rnd, G,
                                                                    True, True)),
                   plain_fwd_ms=cuda_ms(lambda: lk.reference_lowrank_logsumexp(U, V, D),
                                        reps=5, inner=1),
                   **_lowrank_bounds(S, Pp, I, J, F))
        rows[name] = row
        launches_all[name] = launches
        emit({"phase": phase, "family": name, **row})
    ok = all(r["ok"] for r in rows.values())
    summary = {name: {k: r[k] for k in ("F", "fwd_ms", "bwd_dD_ms", "bwd_all_grads_ms",
                                         "plain_fwd_ms", "fwd_bound_tc_ms",
                                         "bwd_dD_bound_tc_ms", "bwd_all_grads_bound_tc_ms")}
               for name, r in rows.items()}
    emit({"phase": phase, "summary": True, "by_family": summary,
          "clocks_power": nvidia_smi_clocks(), "ok": ok})
    total = {k: sum(l[k] for l in launches_all.values()) for k in read_counts()}
    return total, summary


def _corrq_problem():
    from alan_tpu_torch.models import covid
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cuda")
    return covid.generate_problem(ps, data, cov, "qem", corr_Q=True, device="cuda"), ps


def _cholesky_info(state):
    """The info of the Cholesky factorisation of the MVN proposal's
    covariance in a QEM state: 0 where it is positive definite."""
    import torch
    cov = state[1]["qem_params"]["CM_alpha_covariance_matrix"].data
    return torch.linalg.cholesky_ex(cov)[1]


def phase_covid_corrq_main_path():
    """Covid at full size with its corr_Q proposal (a QEM MultivariateNormal
    over the 9 NPI coefficients), K=30, ``train.qem``: 3 forward and 3
    backward chain launches a step, as factorised covid has, finite ELBOs,
    and the proposal's covariance positive definite (Cholesky info 0)
    after every step."""
    from alan_tpu_torch import train
    problem, ps = _corrq_problem()
    step, state = train.qem(problem, K_COVID, lr=LR_QEM)
    phase = "covid_corrq_main_path"
    state, launches, res, prof = _train_path(
        phase, step, state, K_COVID, ["smallk_fwd", "smallk_bwd"],
        {"model": "covid_corr_q", "nRs": ps["nRs"], "nDs_train": ps["nDs"],
         "chains": ps["nRs"] * K_COVID}, check=_cholesky_info)
    per_step = {k: v / STEPS for k, v in launches.items() if v}
    ok = per_step.get("smallk_fwd") == 3 and per_step.get("smallk_bwd") == 3
    if not ok:
        fail(phase, f"chain launches a step {per_step}, wanted 3 + 3")
    emit({"phase": phase, "summary": True, "ms_per_step": res["ms_per_step"],
          "device_busy_ms_per_step": prof["device_busy_ms"] / prof["steps"],
          "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
          "peak_mem_gb": res["peak_mem_gb"], "launches_per_step": per_step,
          "ok": ok and res["ok"]})
    return problem, step, state, launches


def phase_scan_covid_corrq_k30(problem):
    """Covid corr_Q QEM at full size, K=30, 5 and 20 steps captured: 3
    forward and 3 backward chain launches in each replay, and the
    MultivariateNormal's factorisation inside the graph."""
    from alan_tpu_torch import train
    step, state0 = train.qem(problem, K_COVID, lr=LR_QEM)
    res, launches = _scan_phase("scan_covid_corrq_k30", step, state0, SCAN_COVID_STEPS,
                                4 * SCAN_COVID_STEPS, ["smallk_fwd", "smallk_bwd"],
                                {"model": "covid_corr_q", "K": K_COVID},
                                per_replay={"smallk_fwd": 3, "smallk_bwd": 3})
    return {"scan_covid_corrq_k30": (launches, res["replays"])}


# ---- the eighth slice: the canonical models --------------------------------------

#: ``bench_scaling.canonical_models``' table (QEM at K=30, lr 0.1) over the
#: ten models of the slice, occupancy also at ``examples/grids/canonical.yaml``'s
#: K=10; the predictive log-likelihood's N where canonical.yaml runs one
#: (``predll_N: 100``; 0 for occupancy and covid)
CANONICAL = [("synthetic_model", 30, 100), ("radon", 30, 100), ("chimpanzees", 30, 100),
             ("bus_breakdown", 30, 100), ("occupancy", 30, 0), ("occupancy", 10, 0),
             ("radon_reparam", 30, 100), ("bus_breakdown_reparam", 30, 100),
             ("occupancy_reparam", 30, 0), ("movielens_reparam", 30, 100),
             ("covid_reparam", 30, 0)]
CANONICAL_SCAN = (5, 20)


def _routes(launches):
    """The contraction routes a path took, from its launch counters: the
    lazy low-rank kernels, the small-K chain kernels, the fused log-matmul;
    every other factor is contracted densely (torch ops)."""
    out = ["dense"]
    if launches.get("lowrank_fwd"):
        out.append("lazy_lowrank")
    if launches.get("smallk_fwd"):
        out.append("smallk_chain")
    if launches.get("logmmexp"):
        out.append("fused")
    return out


def _canonical_model(name, K, predll_N):
    """One canonical model at its published size, QEM at ``K``: five eager
    steps (``_train_path``: launches, busy, idle, peak), ``scan_steps`` of
    5 and 20 (ELBOs bitwise equal to eager), one update against the host
    CPU's port from the same particles (covid_reparam: the dense chain
    route on the card), the predictive log-likelihood at ``predll_N``
    draws.  Covid_reparam: 3 + 3 chain launches a step and a replay, and
    every day's ``log_infected`` weights sum to 1 after the path's steps.
    Returns (summary, launches of the eager steps, launches a replay)."""
    import importlib
    import torch
    from alan_tpu_torch import predict, train
    mod = importlib.import_module(f"alan_tpu_torch.models.{name}")
    problem, all_data, all_cov, all_ps = mod.load_and_generate_problem(
        seed=0, Q_param_type="qem", device="cuda")
    chain = name == "covid_reparam"
    must = ["smallk_fwd", "smallk_bwd"] if chain else []
    tag = f"canonical_{name}_k{K}"
    info = {"model": name, "method": "qem", "platesizes": dict(problem.all_platedims)}
    step, state0 = train.qem(problem, K, lr=LR_QEM)
    state, launches, res, prof = _train_path(tag, step, state0, K, must, info)
    per_step = {k: v / STEPS for k, v in launches.items() if v}
    ok = res["ok"]
    if chain and (per_step.get("smallk_fwd"), per_step.get("smallk_bwd")) != (3, 3):
        ok = False
        fail(tag, f"chain launches a step {per_step}, wanted 3 + 3")

    def bitwise(fields, _):
        if fields["elbos_graph"] != fields["elbos_eager"]:
            fail(tag, "captured ELBOs differ from the eager loop's")
            return False
        return True
    cap, replay = _scan_phase(tag + "_scan", step, state0, *CANONICAL_SCAN, must, info,
                              per_replay={"smallk_fwd": 3, "smallk_bwd": 3} if chain else None,
                              gate=bitwise)
    t0 = time.perf_counter()
    if chain:
        # covid's fake counts of 1e7 leave its NegativeBinomial's probs
        # within ulps of 1, where the host and the card round them apart
        # (ROADMAP queue 3, "not faults"), and the host's repaired chain
        # takes minutes at full size: the independent route is the dense
        # chain route on the card, as covid_cross_check's
        host = None
        cross = phase_cross_check(tag + "_cross_check", problem, step, state, K,
                                  {"ALAN_TPU_NO_SMALLK_CHAIN": "1"})
    else:
        host = mod.load_and_generate_problem(seed=0, Q_param_type="qem", device="cpu")[0]
        cross = phase_cross_check(tag + "_cross_check", problem, step, state, K, {},
                                  host_problem=host)
    out = {"model": name, "K": K, "routes": _routes(launches),
           "eager_ms_per_step": res["ms_per_step"],
           "eager_busy_ms_per_step": prof["device_busy_ms"] / prof["steps"],
           "eager_idle_share": prof["device_idle_share_unprofiled"],
           "captured_ms_per_step": cap["ms_per_step"],
           "captured_busy_ms_per_step": cap["device_busy_ms_per_step"],
           "captured_idle_share": cap["device_idle_share_unprofiled"],
           "capture_s": [cap["capture_s"], cap["capture_s_long"]],
           "peak_gb": [res["peak_mem_gb"], cap["peak_mem_gb"]],
           "launches_per_step": per_step,
           "launches_per_replay": {k: v for k, v in replay.items() if v},
           "cross_check_elbo_rel_diff": cross["elbo_rel_diff"],
           "cross_check_s": time.perf_counter() - t0}
    ok = ok and cap["ok"] and cross["ok"]
    if predll_N:
        gen = torch.Generator(device="cuda").manual_seed(12)
        f = predict.predictive_ll_fn(problem, K, predll_N, all_ps)
        pll = {k: float(v) for k, v in f(*state, all_cov, all_data, gen).items()}
        out["predictive_ll"] = {"N": predll_N, "value": pll}
        if not _finite(pll.values()):
            ok = False
            fail(tag, f"predictive log-likelihood {pll}")
    if chain:
        marg = _posterior_sample(problem, state, K, 11).marginals()
        sums = _weight_sums(marg, {"a", "log_infected"})
        out["marginal_weight_sums"] = sums
        if any(abs(a - 1) > 1e-3 or abs(b - 1) > 1e-3 for a, b in sums.values()):
            ok = False
            fail(tag, f"marginal weight sums {sums}")
    out["ok"] = ok
    del problem, host, step, state, state0
    torch.cuda.empty_cache()
    return out, launches, replay


def phase_canonical_k30():
    """Every model of ``CANONICAL`` through ``_canonical_model``; one line
    with a row per model.  Returns covid_reparam's chain launches: eager
    over the path's steps, and per replay."""
    rows, chain = [], {}
    t0 = time.perf_counter()
    for name, K, predll_N in CANONICAL:
        row, launches, replay = _canonical_model(name, K, predll_N)
        rows.append(row)
        if name == "covid_reparam":
            chain = {"eager": {k: launches[k] for k in ("smallk_fwd", "smallk_bwd")},
                     "per_replay": {k: replay.get(k) for k in ("smallk_fwd", "smallk_bwd")}}
    emit({"phase": "canonical_k30", "models": rows, "seconds": time.perf_counter() - t0,
          "ok": all(r["ok"] for r in rows)})
    return chain


# ---- phases 32-37: computation strategies, the gold samplers, resume -------------

#: eager steps and captured replays a strategy is driven over
STRATEGY_STEPS = 3
#: the gate of a strategy against no_checkpoint: the ELBO's bound in
#: ``tests/test_problem_vs_itself.py:189``, the state's and the marginals'
STRATEGY_ELBO_TOL, STRATEGY_TOL = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-4)
#: full-size covid's marginal weights against no_checkpoint's, largest
#: difference: above the plate sum's order effect (2.4e-3 in float32, a
#: Split's and reversed chunks') and below a planted chunking fault's
#: (``_control_splits``); both read in every run
COVID_WEIGHTS_TOL = 2e-2
#: the covid K sweep's K = 300 point (``scripts/covid_k_sweep.py:170-180``),
#: 3 steps (5 before phases 46-50 joined the script's time limit)
K300_SHAPE, K300, K300_STEPS = (16, 25), 300, 3
#: the gold runs on full-size covid: NUTS (warmup, draws, chains, depth),
#: HMC (warmup, draws, leapfrog steps), SMC at 16 x 25, QEM at K = 30;
#: NUTS cut from 150 + 100 and the small NUTS from 50 + 50 for the same limit
GOLD_NUTS = (100, 50, 4, 8)
GOLD_HMC = (100, 100, 16)
#: the step sizes one leapfrog's energy error is read at (``_energy_errors``)
ENERGY_EPS = (0.1, 1e-2, 1e-3, 1e-4)
GOLD_SMC_PARTICLES, GOLD_SMC_SHAPE = 2048, (16, 25)
GOLD_SMALL_NUTS = (25, 25, 4, 8)
GOLD_QEM_ITERS = 150


def _control_splits(platename, split_size):
    """Two Splits the strategies' weights gate is read against: the same
    chunks added in reverse order (the plate sum's order alone), and a
    planted fault, the last chunk's bounds one row low (one row evaluated
    twice, the last never), which the gate must refuse."""
    from alan_tpu_torch import Split

    class Reversed(Split):
        def _split_bounds(self, size):
            return super()._split_bounds(size)[::-1]

    class OffByOne(Split):
        def _split_bounds(self, size):
            bounds = super()._split_bounds(size)
            (a, b) = bounds[-1]
            return bounds[:-1] + [(a - 1, b - 1)]
    return Reversed(platename, split_size), OffByOne(platename, split_size)


def _strategy_runs(phase, problem, make_step, check, strategies, kernels, info,
                   weights_tol=None, controls=()):
    """Each strategy's step from ``make_step(cs) -> (step, state0)``:
    ``STRATEGY_STEPS`` eager steps (launches per step, host ms, peak GB), the
    same steps under ``scan_steps`` (launches per replay, peak GB; bitwise
    the eager loop) and a profile of two eager steps (busy ms, idle share).
    ``check(cs) -> (elbo, tensors, weights)`` gives one ELBO from fixed draws,
    what follows from it (a QEM step's new state, a VI ELBO's gradients)
    and the marginal weights of one particle tree; every strategy is held
    to the first (no_checkpoint): the ELBO within ``STRATEGY_ELBO_TOL``, the
    tensors within ``STRATEGY_TOL``, the weights within ``STRATEGY_TOL``
    or, with ``weights_tol``, by their largest difference.  Each kernel of
    ``kernels`` launches at least once a chunk.  ``controls`` ((name,
    strategy, held) a piece) are read against ``weights_tol`` after the
    strategies: a held one within it, a planted fault beyond it.  The
    3-step ELBOs and states against no_checkpoint's are reported.  Returns
    ({strategy: launches per step}, all held)."""
    import torch
    from alan_tpu_torch import train
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    base, out, ok = None, {}, True

    def weights_diff(weights, b_weights):
        return max((weights[k].with_dims_front(list(v.dims)).data - v.data).abs().max().item()
                   for k, v in b_weights.items())

    for name, cs in strategies:
        step, state0 = make_step(cs)
        step(state0, gen(0))                               # warm-up
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        st_e, el_e = train._eager(step, STRATEGY_STEPS, state0, gen(5))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STRATEGY_STEPS * 1e3
        per_step = {k: v // STRATEGY_STEPS for k, v in read_counts().items() if v}
        peak_eager = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        with _CountedCaptures() as cap:
            st_g, el_g = train.scan_steps(step, STRATEGY_STEPS)(state0, gen(5))
        torch.cuda.synchronize()
        peak_graph = torch.cuda.max_memory_allocated() / 1e9
        replay = {k: v for k, v in (cap.records[0] if cap.records else {}).items() if v}
        bitwise = bool(torch.equal(el_g, el_e)) and all(
            torch.equal(a, b) for a, b in zip(train._flatten(st_g)[0], train._flatten(st_e)[0]))
        prof = _profile_step(f"{phase}_{name}", step, st_e, gen(9), ms)
        elbo, tensors, weights = check(cs)
        chunks = (len(cs._split_bounds(problem.all_platedims[cs.platename]))
                  if hasattr(cs, "platename") else 1)
        res = {"phase": phase, "strategy": name, **info, "chunks": chunks, "ms_per_step": ms,
               "elbos": el_e.tolist(), "launches_per_step": per_step,
               "launches_per_replay": replay, "bitwise_captured_eager": bitwise,
               "device_busy_ms_per_step": prof["device_busy_ms"] / prof["steps"],
               "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
               "peak_mem_gb_eager": peak_eager, "peak_mem_gb_captured": peak_graph,
               "resident_gb_before": resident}
        faults = []
        if not (bitwise and _finite(el_e.tolist())):
            faults.append("captured loop not bitwise its eager loop, or a non-finite ELBO")
        if replay != per_step:
            faults.append(f"launches per replay {replay} != per eager step {per_step}")
        short = [k for k in kernels if per_step.get(k, 0) < chunks]
        if short:
            faults.append(f"{short} launched fewer times than the {chunks} chunks")
        if base is None:
            base = (elbo, tensors, weights, el_e, st_e)
        else:
            b_elbo, b_tensors, b_weights, b_el, b_st = base
            res["elbo_rel_diff"] = _rel_diff(elbo, b_elbo)
            res["max_abs_diff"] = max(((t - u).abs().max().item() for t, u in
                                       zip(tensors, b_tensors) if t.numel()), default=0.0)
            res["bitwise_no_checkpoint"] = bool(torch.equal(elbo, b_elbo)) and all(
                torch.equal(t, u) for t, u in zip(tensors, b_tensors))
            w = {k: weights[k].with_dims_front(list(v.dims)).data for k, v in b_weights.items()}
            res["marginals_max_abs_diff"] = weights_diff(weights, b_weights)
            res["three_steps_elbo_max_rel_diff"] = _rel_diff(el_e, b_el)
            res["three_steps_state_max_abs_diff"] = _state_compare(st_e, b_st)[1]
            if not torch.allclose(elbo.double(), b_elbo.double(), **STRATEGY_ELBO_TOL):
                faults.append(f"ELBO {float(elbo)} against no_checkpoint's {float(b_elbo)}")
            if not all(torch.allclose(t, u, **STRATEGY_TOL) for t, u in zip(tensors, b_tensors)):
                faults.append("state or gradients off no_checkpoint's")
            if not (res["marginals_max_abs_diff"] <= weights_tol if weights_tol else
                    all(torch.allclose(w[k], v.data, **STRATEGY_TOL)
                        for k, v in b_weights.items())):
                faults.append("marginals off no_checkpoint's")
        res["ok"] = not faults
        for f in faults:
            fail(phase, f"{name}: {f}")
        ok = ok and not faults
        emit(res)
        out[name] = per_step
        del st_e, st_g, el_e, el_g, weights
        torch.cuda.empty_cache()
    readings, faults = {}, []
    for name, cs, held in controls:
        readings[name] = weights_diff(check(cs)[2], base[2])
        if held != (readings[name] <= weights_tol):
            faults.append(f"{name}'s weights {readings[name]} against the limit {weights_tol}")
    if controls:
        emit({"phase": phase, "controls": readings, "weights_limit": weights_tol,
              "ok": not faults})
    for f in faults:
        fail(phase, f)
    return out, ok and not faults


def _qem_check(problem, K, state, tree):
    """``_strategy_runs``'s check of a QEM step: one step from ``state`` with
    a generator of one seed (its ELBO and new state) and the marginals of
    ``tree`` at ``state``."""
    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.sample import Sample
    from alan_tpu_torch.sampler import PermutationSampler
    gv2K = problem.Q.plate.groupvarname2Kdim(K)

    def check(cs):
        step, _ = train.qem(problem, K, lr=LR_QEM, computation_strategy=cs)
        new, elbo = step(state, torch.Generator(device="cuda").manual_seed(2))
        weights = Sample(problem, tree, gv2K, PermutationSampler, False,
                         states=state).marginals(computation_strategy=cs).weights
        return elbo, train._flatten(new)[0], weights
    return check


def _near_truth(problem, truth, scale):
    """(P's state, Q's state with every Normal's location at ``truth`` (a
    dict of DTs) and its scale ``scale``)."""
    import torch
    from alan_tpu_torch.dims import DT
    st = problem.Q.state()
    qp = {}
    for k, v in st["qem_params"].items():
        name, arg = k.rsplit("_", 1)
        t = truth[name].with_dims_front(list(v.dims)).data
        qp[k] = DT(t.clone() if arg == "loc" else torch.full_like(t, scale), v.dims)
    return (problem.P.state(), {**st, "qem_params": qp})


def phase_strategies_covid_k30():
    """Full-size covid QEM at K=30 under no_checkpoint, checkpoint,
    Split("nRs", 23) (4 equal chunks) and Split("nRs", 40) (40, 40 and a
    remainder of 12), eager and captured, on the recipe's counts
    (``experiments.covid_recipe.recipe``) with Q centred on the recipe's
    latents (scale ``COVID_NEAR_TRUTH_SCALE``).  At the fake data's Q initial state the
    ELBO is -2.4e7, a float32 ulp of it 2 nats, so the order of the plate
    sum alone moves the root's marginal weights by ~1e-2; here by ~2e-3,
    so the weights are held to ``COVID_WEIGHTS_TOL``, read against the
    order alone (chunks reversed) and a planted chunking fault
    (``_control_splits``)."""
    import torch
    from alan_tpu_torch import Split, checkpoint, no_checkpoint, train
    from alan_tpu_torch.experiments import covid_recipe
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.sampler import PermutationSampler
    ps, cov, data, walk = covid_recipe.recipe(covid.nRs, covid.nDs)
    problem = covid.generate_problem(ps, data, cov, "qem", device="cuda")
    state = _near_truth(problem, _covid_truth_latents(ps, walk, "cuda"),
                        COVID_NEAR_TRUTH_SCALE)
    tree, _ = problem.Q._sample(K_COVID, False, PermutationSampler, problem.all_platedims,
                                torch.Generator(device="cuda").manual_seed(6),
                                state=state[1])
    strategies = [("no_checkpoint", no_checkpoint), ("checkpoint", checkpoint),
                  ("split_nRs_23", Split("nRs", 23)), ("split_nRs_40", Split("nRs", 40))]
    reversed_40, off_by_one_40 = _control_splits("nRs", 40)
    return _strategy_runs(
        "strategies_covid_k30", problem,
        lambda cs: (train.qem(problem, K_COVID, lr=LR_QEM, computation_strategy=cs)[0],
                    state),
        _qem_check(problem, K_COVID, state, tree), strategies,
        ["smallk_fwd", "smallk_bwd"],
        {"model": "covid", "data": "recipe", "nRs": ps["nRs"], "nDs_train": ps["nDs"],
         "K": K_COVID}, COVID_WEIGHTS_TOL,
        [("split_nRs_40_reversed", reversed_40, True),
         ("split_nRs_40_off_by_one_planted_fault", off_by_one_40, False)])[0]


def phase_strategies_grouped_k1000():
    """Grouped MovieLens K=1000, QEM and VI, under no_checkpoint, checkpoint
    and Split("plate_1", 100): each chunk of 100 users stays on the lazy
    route (1000^2 x 100 = 1e8 > 2^26), so the lowrank kernels launch in
    every chunk.  VI is held by its ELBO's gradients (a VI step's Adam
    update divides each by its own scale: a gradient entry near 0 moves
    its parameter by up to lr whatever its size)."""
    import torch
    from alan_tpu_torch import Split, checkpoint, no_checkpoint, train
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.sample import Sample
    from alan_tpu_torch.sampler import PermutationSampler
    out = {}
    strategies = [("no_checkpoint", no_checkpoint), ("checkpoint", checkpoint),
                  ("split_plate_1_100", Split("plate_1", 100))]
    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    for method, qtype, kernels in (("qem", "qem", ["lowrank_fwd", "lowrank_bwd_dD"]),
                                   ("vi", "opt", ["lowrank_fwd", "lowrank_bwd_dU",
                                                  "lowrank_bwd_dV"])):
        problem = ml.grouped_problem(ps, data, cov, qtype, device="cuda")
        state = (problem.P.state(), problem.Q.state())
        tree, gv2K = problem.Q._sample(K_MAIN, False, PermutationSampler,
                                       problem.all_platedims,
                                       torch.Generator(device="cuda").manual_seed(6))
        if method == "qem":
            check = _qem_check(problem, K_MAIN, state, tree)
        else:
            def check(cs, problem=problem, tree=tree, gv2K=gv2K):
                leaves, sP, sQ = train.opt_leaves(problem.P.state(), problem.Q.state())
                elbo = train.elbo_fn(problem, K_MAIN, True, computation_strategy=cs)(
                    sP, sQ, torch.Generator(device="cuda").manual_seed(2))
                grads = torch.autograd.grad(elbo, leaves)
                weights = Sample(problem, tree, gv2K, PermutationSampler, False).marginals(
                    computation_strategy=cs).weights
                return elbo.detach(), list(grads), weights
        factory = getattr(train, method)
        out[method], _ = _strategy_runs(
            f"strategies_grouped_k1000_{method}", problem,
            lambda cs: factory(problem, K_MAIN, computation_strategy=cs), check,
            strategies, kernels, {"model": "grouped_movielens", "method": method, "K": K_MAIN})
        del problem, tree
        torch.cuda.empty_cache()
    return out


def phase_covid_k300_split():
    """The covid K sweep's K = 300 point: covid at 16 x 25 (20 training
    days), the recipe's counts, QEM at K = 300 under Split("nRs", 2) (8
    chunks), ``K300_STEPS`` steps and ``marginals()``: the fused log-matmul and both its
    fix-ups in every chunk (each chunk checkpointed: the fused kernel keeps
    20.5 GB a region for its backward).  Unsplit (about 35 GB of factor by
    ``alan_tpu``'s comment) where it fits, else reported; and one step under
    Split("nRs", 1), and one of Split("nRs", 2) with its chunks added in
    reverse order.  Each other run's first ELBO is held to the first's
    within phase 32's 1e-5, and the state after it reported: at ESS 1 (the
    marginals' least) the moments follow the rounding of the sums, 0.017
    apart after one step of Split("nRs", 1) against ("nRs", 2); the reversed runs
    (Split("nRs", 2) and ("nRs", 1), the same chunks in another order)
    read the order's share of that, and one region's chain alone and
    beside another the kernel's.  From Q centred on the recipe's latents
    (``COVID_NEAR_TRUTH_SCALE``), where the weights spread, one step of
    Split("nRs", 1) is held to ("nRs", 2)'s: the ELBO within 1e-5, the
    state within ``STRATEGY_TOL``."""
    import torch
    from alan_tpu_torch import Split, no_checkpoint, train
    from alan_tpu_torch.experiments import covid_recipe
    from alan_tpu_torch.models import covid
    phase = "covid_k300_split"
    nRs, nDs = K300_SHAPE
    ps, cov, data, walk = covid_recipe.recipe(nRs, nDs)
    runs, first, ones = {}, None, {}
    ok = True
    for name, cs, chunks, steps in (("split_nRs_2", Split("nRs", 2), 8, K300_STEPS),
                                    ("unsplit", no_checkpoint, 1, K300_STEPS),
                                    ("split_nRs_1", Split("nRs", 1), 16, 1),
                                    ("split_nRs_2_reversed", _control_splits("nRs", 2)[0],
                                     8, 1),
                                    ("split_nRs_1_reversed", _control_splits("nRs", 1)[0],
                                     16, 1)):
        problem = covid.generate_problem(ps, data, cov, "qem", device="cuda")
        step, state0 = train.qem(problem, K300, lr=LR_QEM, computation_strategy=cs)
        gen = torch.Generator(device="cuda").manual_seed(5)

        def drive():
            one, e1 = train._eager(step, 1, state0, gen)
            last, rest = train._eager(step, steps - 1, one, gen) if steps > 1 else (one, e1[:0])
            return one, last, torch.cat([e1, rest])
        try:
            ((one, state, elbos), ms, launches, peak), joints = _joint_counted(
                lambda: _driven(drive))
            marg = m_ms = m_launches = m_peak = None
            if steps > 1:
                s = _posterior_sample(problem, state, K300, 7)
                marg, m_ms, m_launches, m_peak = _driven(
                    lambda: s.marginals(computation_strategy=cs))
                del s
        except torch.cuda.OutOfMemoryError as e:
            res = {"phase": phase, "strategy": name, "chunks": chunks,
                   "out_of_memory": str(e).split(". ")[0][:300],
                   "peak_mem_gb_before_failure": torch.cuda.max_memory_allocated() / 1e9}
            emit(res)
            runs[name] = res
            del problem, step, state0
            torch.cuda.empty_cache()
            continue
        res = {"phase": phase, "strategy": name, "nRs": nRs, "nDs_train": ps["nDs"],
               "K": K300, "chunks": chunks, "steps": steps,
               "ms_per_step": ms / steps, "elbos": elbos.tolist(),
               "launches_per_step": {k: v // steps for k, v in launches.items() if v},
               "joint_entries_per_step": joints // steps, "peak_mem_gb": peak,
               "marginals_ms": m_ms,
               "marginals_launches": m_launches and {k: v for k, v in m_launches.items() if v},
               "marginals_peak_gb": m_peak,
               "marginals_min_ess": marg and min(v.data.min().item()
                                                 for v in marg.ess().values())}
        faults = []
        if not (_finite(elbos.tolist()) and launches["logmmexp"] >= chunks * steps):
            faults.append("a non-finite ELBO, or the fused kernel missed a chunk")
        if first is None:
            first = (name, elbos[0], one)
        else:
            res["first_step_elbo_rel_diff"] = _rel_diff(elbos[0], first[1])
            res["first_step_state_max_abs_diff"] = _state_compare(one, first[2])[1]
            res["first_step_state_max_rel_diff"] = max(
                _rel_diff(x, y) for x, y in zip(train._flatten(one)[0],
                                                train._flatten(first[2])[0]))
            if not torch.allclose(elbos[0].double(), first[1].double(), **STRATEGY_ELBO_TOL):
                faults.append(f"its first ELBO off {first[0]}'s")
            if name.endswith("_reversed"):
                # the same chunks, another order of the plate sum
                res["order_only_state_max_abs_diff"] = _state_compare(
                    one, ones[name[:-len("_reversed")]])[1]
        ones[name] = one
        res["ok"] = not faults
        for f in faults:
            fail(phase, f"{name}: {f}")
        ok = ok and not faults
        emit(res)
        runs[name] = res
        del problem, step, state0, one, state, marg
        torch.cuda.empty_cache()
    # the two chunkings again from Q centred on the recipe's latents, where
    # the weights spread over particles: one step's state held to STRATEGY_TOL
    near = {}
    for name, cs in (("split_nRs_2", Split("nRs", 2)), ("split_nRs_1", Split("nRs", 1))):
        problem = covid.generate_problem(ps, data, cov, "qem", device="cuda")
        step, _ = train.qem(problem, K300, lr=LR_QEM, computation_strategy=cs)
        start = _near_truth(problem, _covid_truth_latents(ps, walk, "cuda"),
                            COVID_NEAR_TRUTH_SCALE)
        near[name] = step(start, torch.Generator(device="cuda").manual_seed(5))
        if name == "split_nRs_2":
            s = _posterior_sample(problem, start, K300, 7)
            near_ess = min(v.data.min().item()
                           for v in s.marginals(computation_strategy=cs).ess().values())
            del s
        del problem, step
        torch.cuda.empty_cache()
    (st2, el2), (st1, el1) = near["split_nRs_2"], near["split_nRs_1"]
    near_ok = (torch.allclose(el1.double(), el2.double(), **STRATEGY_ELBO_TOL)
               and all(torch.allclose(a, b, **STRATEGY_TOL) for a, b in
                       zip(train._flatten(st1)[0], train._flatten(st2)[0])))
    if not near_ok:
        fail(phase, "near the latents, one step of Split(\"nRs\", 1) off (\"nRs\", 2)'s")
    ok = ok and near_ok
    # a chunk of 1 region and one of 2 chain the same region's operators
    # through the fused kernel at different batch sizes (its tile differs
    # at a batch of 1): the region's chain and its gradient, bitwise or not,
    # on random operators and on peaked ones (most entries take the fix-ups)
    from alan_tpu_torch.ops.logmmexp import chain_logmmexp

    def chained(ms):
        ms = ms.clone().requires_grad_(True)
        out = chain_logmmexp(ms)
        w = torch.randn(out.shape[1:], device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(13))
        g, = torch.autograd.grad((out * w).sum(), [ms])
        return out[0].detach(), g[0]
    batch = {}
    for kind, ms in (
            ("random", 3.0 * torch.randn((2, ps["nDs"], K300, K300), device="cuda",
                                         generator=torch.Generator(device="cuda").manual_seed(12))),
            ("peaked", _peaked_chain((2, ps["nDs"], K300), 12))):
        (alone, g_alone), (paired, g_paired) = chained(ms[:1]), chained(ms)
        batch[kind] = {"bitwise": bool(torch.equal(alone, paired) and torch.equal(g_alone, g_paired)),
                       "max_rel_diff": _rel_diff(alone, paired),
                       "grad_max_abs_diff": (g_alone - g_paired).abs().max().item()}
    emit({"phase": phase, "summary": True, "ok": ok,
          "peak_gb": {k: v.get("peak_mem_gb") for k, v in runs.items()},
          "out_of_memory": [k for k, v in runs.items() if "out_of_memory" in v],
          "chain_batch_1_vs_2": batch,
          "near_latents": {"min_ess": near_ess, "ok": near_ok,
                           "elbo_rel_diff": _rel_diff(el1, el2),
                           "state_max_abs_diff": _state_compare(st1, st2)[1]}})
    return {k: v["launches_per_step"] for k, v in runs.items() if "launches_per_step" in v}


def _linear_gaussian(device):
    """``tests/model_linear_gaussian.py`` on ``device``: (P, data, posterior
    mean, posterior precision, log evidence)."""
    import numpy as np
    import scipy.stats
    import torch
    from alan_tpu_torch import BoundPlate, Normal, Plate, named
    prior_mean, prior_scale, like_scale, mult, N = 2, 2, 3, 2.5, 10
    data_np = 1.5 + np.random.default_rng(0).standard_normal(N)
    post_prec = 1 / prior_scale ** 2 + N * mult ** 2 / like_scale ** 2
    post_mean = (prior_mean / prior_scale ** 2
                 + mult ** 2 / like_scale ** 2 * (data_np.sum() / mult)) / post_prec
    known = float(scipy.stats.multivariate_normal.logpdf(
        data_np, prior_mean * mult * np.ones(N),
        (mult * prior_scale) ** 2 * np.ones((N, N)) + like_scale ** 2 * np.eye(N)))
    P = BoundPlate(Plate(a=Normal(prior_mean, prior_scale),
                         T=Plate(d=Normal(lambda a: mult * a, like_scale))), {"T": N},
                   device=device)
    data = {"d": named(torch.tensor(data_np, dtype=torch.float32, device=device), "T")}
    return P, data, post_mean, post_prec, known


def phase_gold_analytic():
    """``tests/test_mcmc_smc.py``'s five oracles on the card, at their draw
    counts and with their gates: HMC and NUTS on the linear Gaussian, SMC's
    evidence, HMC on the Dirichlet-Categorical (stick-breaking) and on an
    LKJ correlation (the correlation Cholesky transform)."""
    import numpy as np
    import torch
    from alan_tpu_torch import (BoundPlate, Categorical, Dirichlet, LKJCholesky,
                                MultivariateNormal, Plate, named)
    from alan_tpu_torch.mcmc import run_hmc
    from alan_tpu_torch.nuts import run_nuts
    from alan_tpu_torch.smc import run_smc
    phase = "gold_analytic"
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    P, data, post_mean, post_prec, known = _linear_gaussian("cuda")
    true_sd = (1 / post_prec) ** 0.5
    checks = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (s, d), sec = timed(lambda: run_hmc(P, data, num_samples=400, num_warmup=400,
                                        num_chains=4, generator=gen(0)))
    a = s["a"].data.cpu().numpy()
    mcse = a.std() / np.sqrt(200)
    checks["hmc_linear_gaussian"] = dict(
        s=sec, mean=float(a.mean()), sd=float(a.std()), accept=d["mean_accept"],
        step_size=d["step_size"],
        ok=bool(abs(a.mean() - post_mean) < 8 * mcse + 0.05 and abs(a.std() - true_sd) < 0.15
                and d["mean_accept"] > 0.5))
    (s, info), sec = timed(lambda: run_smc(P, data, num_particles=512, mutation_steps=8,
                                           step_size=0.3, generator=gen(1)))
    a = s["a"].data.cpu().numpy()
    checks["smc_linear_gaussian_evidence"] = dict(
        s=sec, mean=float(a.mean()), log_Z=info["log_Z"], known_log_evidence=known,
        stages=info["stages"], host_syncs=info["host_syncs"],
        ok=bool(abs(a.mean() - post_mean) < 0.2 and abs(info["log_Z"] - known) < 1.0
                and info["final_lambda"] == 1.0))
    (s, d), sec = timed(lambda: run_nuts(P, data, num_samples=400, num_warmup=400,
                                         num_chains=4, max_depth=6, generator=gen(3)))
    a = s["a"].data.cpu().numpy()
    checks["nuts_linear_gaussian"] = dict(
        s=sec, mean=float(a.mean()), sd=float(a.std()), accept=d["mean_accept"],
        ok=bool(abs(a.mean() - post_mean) < 0.1 and abs(a.std() - true_sd) < 0.1
                and d["mean_accept"] > 0.6 and np.abs(a.mean(axis=0) - a.mean()).max() < 0.25))
    counts = torch.tensor([0, 0, 1, 1, 1, 2, 2, 2, 2, 2], dtype=torch.float32, device="cuda")
    Pd = BoundPlate(Plate(p=Dirichlet(torch.ones(3)), T=Plate(c=Categorical(probs="p"))),
                    {"T": 10}, device="cuda")
    (s, d), sec = timed(lambda: run_hmc(Pd, {"c": named(counts, "T")}, num_samples=500,
                                        num_warmup=500, num_chains=4, generator=gen(5)))
    p = s["p"].data.cpu().numpy().mean(axis=(0, 1))
    alpha = np.array([3., 4., 6.])
    checks["hmc_dirichlet_categorical"] = dict(
        s=sec, mean=p.tolist(), ok=bool(np.allclose(p, alpha / alpha.sum(), atol=0.07)))
    rng = np.random.default_rng(0)
    true_L = np.linalg.cholesky(np.array([[1., .7], [.7, 1.]]))
    obs = (rng.standard_normal((200, 2)) @ true_L.T).astype(np.float32)
    Pl = BoundPlate(Plate(L=LKJCholesky(2, 2.0),
                          T=Plate(y=MultivariateNormal(torch.zeros(2), scale_tril="L"))),
                    {"T": 200}, device="cuda")
    (s, d), sec = timed(lambda: run_hmc(
        Pl, {"y": named(torch.tensor(obs, device="cuda"), "T")}, num_samples=300,
        num_warmup=300, num_chains=4, generator=gen(0)))
    Ls = s["L"].data.cpu().numpy()
    corr = (Ls @ np.swapaxes(Ls, -1, -2))[..., 0, 1]
    checks["hmc_lkj_correlation"] = dict(s=sec, corr=float(corr.mean()),
                                         ok=bool(abs(corr.mean() - 0.7) < 0.1))
    ok = all(c["ok"] for c in checks.values())
    if not ok:
        fail(phase, f"an oracle failed: {checks}")
    emit({"phase": phase, **checks, "ok": ok})


def _covid_truth_latents(ps, walk, device):
    """Covid's latents at the recipe's own process: log_infected the walk,
    psi = log r, the walk's drift as RegionR (every NPI, wearing and
    mobility coefficient 0), its noise scale 0.15 and initial size 1000; a
    finite start where a prior draw's log_infected overflows float32 at 109
    days."""
    import math
    import numpy as np
    import torch
    from alan_tpu_torch.dims import DT
    li, r = walk
    nRs = ps["nRs"]
    f = lambda a, *dims: DT(torch.tensor(np.asarray(a, np.float32), device=device), dims)
    return {"CM_alpha": f(np.zeros(9)), "Wearing_alpha": f(0.0), "Mobility_alpha": f(0.0),
            "RegionR": f(0.05), "InitialSize_log_mean": f(math.log(1000.0)),
            "log_infected_noise_mean": f(math.log(0.15)),
            "InitialSize_log": f(np.full(nRs, math.log(1000.0)), "nRs"),
            "log_infected_noise": f(np.full(nRs, math.log(0.15)), "nRs"),
            "psi": f(np.log(r[:, 0]), "nRs"), "log_infected": f(li, "nRs", "nDs")}


def _energy_errors(lp32, lp64, theta, gen):
    """One leapfrog step's energy error from each chain's ``theta`` (chain,
    D) with unit-normal momenta, at each of ``ENERGY_EPS``, through the
    float32 log posterior ``lp32`` and the float64 ``lp64`` from the same
    start: the largest |dH| of each and of their difference, and the
    float32 log posterior's largest distance from float64 at ``theta``.  A
    difference far above 1 at every step size is rounding that no step
    size brings to an acceptance."""
    import torch
    from alan_tpu_torch import mcmc
    th64 = theta.double()
    r = torch.randn(th64.shape, generator=gen, dtype=torch.float64, device=th64.device)
    ones = torch.ones(th64.shape[1], dtype=torch.float64, device=th64.device)
    dH = {}
    for name, lp, dt in (("f32", lp32, torch.float32), ("f64", lp64, torch.float64)):
        vg = lambda th, lp=lp: mcmc.value_and_grad(lp, th)
        th, m = th64.to(dt), r.to(dt)
        v0, g0 = vg(th)
        for eps in ENERGY_EPS:
            _, m1, v1, _ = mcmc._leapfrog(vg, th, m, g0, eps, ones.to(dt), 1)
            dH[name, eps] = ((v0 - 0.5 * (m * m).sum(1))
                             - (v1 - 0.5 * (m1 * m1).sum(1))).double()
    big = lambda t: t.abs().max().item()
    return {"by_eps": {f"{e:g}": {"dH_f32_max_abs": big(dH["f32", e]),
                                  "dH_f64_max_abs": big(dH["f64", e]),
                                  "dH_f32_minus_f64_max_abs": big(dH["f32", e] - dH["f64", e])}
                       for e in ENERGY_EPS},
            "logpost_f64": lp64(th64).tolist(),
            "logpost_f32_minus_f64_max_abs": big(lp32(th64.float()).double() - lp64(th64))}


def phase_gold_covid():
    """The gold samplers on covid.  Full size (92 x 109 training days, the
    recipe's counts): NUTS (4 chains, max_depth 8) and HMC, each iteration a
    captured CUDA graph, in float64: the float32 log posterior misses
    float64 by ~1e-3 relative there (the NegativeBinomial's lgamma terms
    of counts up to 3e7 cancel), tens of nats, and a leapfrog's energy
    error with it, so no step size is accepted (``_energy_errors`` reads
    it at both precisions).  Gates: the log posterior and its gradient at
    4 thetas within 1e-5 (gradient 1e-4 of its largest entry) of the
    port's float64 evaluation on the host; one NUTS draw at max_depth 4
    within 1e-4 of the host port's from the same state and noise; 5
    captured draws bitwise 5 eager ones.  At 16 x 25 (the script's size),
    NUTS in float64 and SMC (float32) with 2048 particles.  Reported: ms
    per draw, gradient evaluations a second, acceptance, step size,
    split-R-hat and bulk ESS (``diagnostics``), and the SMC-vs-NUTS and
    MP-QEM-K30-vs-NUTS z-scores (not gated: the finite-K bias is known),
    labelled ``unconverged`` where a gold run's R-hat exceeds 1.1."""
    import numpy as np
    import torch
    from alan_tpu_torch import diagnostics, mean, mcmc, train
    from alan_tpu_torch.dims import DT
    from alan_tpu_torch.experiments import covid_recipe
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.nuts import _Draw, run_nuts
    from alan_tpu_torch.smc import run_smc
    phase = "gold_covid"
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    faults = []
    f64 = lambda tree: {k: DT(v.data.double(), v.dims) for k, v in tree.items()}
    ps, cov, data32, walk = covid_recipe.recipe(covid.nRs, covid.nDs)
    P, data = covid.get_P(ps, f64(cov), device="cuda"), f64(data32)
    latents = f64(_covid_truth_latents(ps, walk, "cuda"))
    logpost = mcmc.LogPost(P, data, latents)
    logpost32 = mcmc.LogPost(covid.get_P(ps, cov, device="cuda"), data32,
                             _covid_truth_latents(ps, walk, "cuda"))
    D = logpost.D

    # the log posterior on the card against float64 on the host
    ps_h, cov_h, data_h, _ = covid_recipe.recipe(covid.nRs, covid.nDs, device="cpu")
    logpost_h = mcmc.LogPost(covid.get_P(ps_h, f64(cov_h), device="cpu"), f64(data_h),
                             f64(_covid_truth_latents(ps_h, walk, "cpu")))
    thetas = logpost.theta0[None] + 0.01 * torch.randn(
        (4, D), generator=gen(1), dtype=torch.float64, device="cuda")
    vh, gh = mcmc.value_and_grad(logpost_h, thetas.cpu())

    def errs(v, g):
        return (((v.double().cpu() - vh).abs() / vh.abs()).max().item(),
                ((g.double().cpu() - gh).abs().max() / gh.abs().max()).item())
    v_err, g_err = errs(*mcmc.value_and_grad(logpost, thetas))
    v_err32, g_err32 = errs(*mcmc.value_and_grad(logpost32, thetas.float()))
    if not (v_err <= 1e-5 and g_err <= 1e-4):
        faults.append(f"log posterior {v_err} or gradient {g_err} off the host's float64")
    energy = _energy_errors(logpost32, logpost, thetas, gen(10))

    # NUTS at full size, captured
    W, S, C, MD = GOLD_NUTS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samples, diag = run_nuts(P, data, num_samples=S, num_warmup=W, num_chains=C, max_depth=MD,
                             generator=gen(2), latents=latents)
    torch.cuda.synchronize()
    nuts_s = time.perf_counter() - t0
    nuts_peak = torch.cuda.max_memory_allocated() / 1e9
    theta = diag["theta"]
    if not bool(torch.isfinite(theta).all()):
        faults.append("a NUTS draw is not finite")
    leapfrogs = (2 ** MD - 1 + 1) * C           # a draw's gradients, every chain
    nuts_ms = (nuts_s - diag["capture_s"]) / (W + S) * 1e3
    gold = covid_recipe.draws_np(samples)

    # 5 draws captured against eager, bitwise
    short = dict(num_samples=5, num_warmup=0, num_chains=C, max_depth=MD, latents=latents)
    _, cd = run_nuts(P, data, generator=gen(3), **short)
    loop = mcmc._loop
    mcmc._loop = lambda step, n, state, g: (
        (*train._eager(step, n, state, g), 0.0) if n else loop(step, n, state, g))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ed = run_nuts(P, data, generator=gen(3), **short)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    finally:
        mcmc._loop = loop
    nuts_bitwise = bool(torch.equal(cd["theta"], ed["theta"]))
    if not nuts_bitwise:
        faults.append("5 captured NUTS draws differ from the eager ones")

    # one draw at max_depth 4 from the same state and noise, card and host
    eps = torch.tensor(diag["step_size"], device="cuda")
    inv_mass = torch.ones(D, device="cuda")
    g4 = gen(4)
    r0 = torch.randn((C, D), generator=g4, device="cuda")
    bits = torch.rand((C, 4), generator=g4, device="cuda") < 0.5
    merge, leaf = (torch.rand((C, n), generator=g4, device="cuda") for n in (4, 15))

    def one_draw(lp, dev):
        dirs = torch.where(bits.to(dev), 1.0, -1.0)
        m, lf = merge.to(dev), leaf.to(dev)
        draw = _Draw(lambda th: mcmc.value_and_grad(lp, th), 4, lambda k: lf[:, k],
                     lambda d: m[:, d], lambda d: dirs[:, d])
        return draw(theta[-1].to(dev), r0.to(dev), eps.to(dev), inv_mass.to(dev))[0]
    z_card = one_draw(logpost, "cuda").cpu()
    z_host = one_draw(logpost_h, "cpu")
    draw_err = (z_card - z_host).abs().max().item()
    if not draw_err <= 1e-4:
        faults.append(f"a NUTS draw at max_depth 4 differs from the host's by {draw_err}")

    # HMC at full size, captured
    Wh, Sh, L = GOLD_HMC
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_samples, h_diag = mcmc.run_hmc(P, data, num_samples=Sh, num_warmup=Wh, num_chains=C,
                                     num_leapfrog=L, generator=gen(5), latents=latents)
    torch.cuda.synchronize()
    hmc_s = time.perf_counter() - t0 - h_diag["capture_s"]
    if not bool(torch.isfinite(h_diag["theta"]).all()):
        faults.append("an HMC draw is not finite")

    def diagnose(draws):
        out = {}
        for name in ("CM_alpha", "Wearing_alpha", "Mobility_alpha", "RegionR",
                     "InitialSize_log_mean", "log_infected_noise_mean", "InitialSize_log",
                     "log_infected_noise", "psi", "log_infected"):
            rh, es = diagnostics.split_rhat(draws[name]), diagnostics.ess_bulk(draws[name])
            out[name] = {"rhat_max": float(np.max(rh)), "ess_min": float(np.min(es)),
                         "ess_median": float(np.median(es))}
        return out

    def z_against(gold_draws, gold_diag, other):
        """The z-scores of ``other`` against a gold run, keyed ``unconverged``
        where the run's R-hat exceeds 1.1 anywhere."""
        ok = all(v["rhat_max"] <= 1.1 for v in gold_diag.values())
        return {"z_vs_nuts" if ok else "z_vs_nuts_unconverged":
                covid_recipe.z_scores(gold_draws, other)}

    # MP QEM at K = 30 on the same data, against the NUTS draws
    problem = covid.generate_problem(ps, data32, cov, "qem", device="cuda")
    step, state = train.qem(problem, K_COVID, lr="0.1/t@100")
    t0 = time.perf_counter()
    state, _ = train.scan_steps(step, GOLD_QEM_ITERS)(state, gen(6))
    (stP, stQ), _ = state
    s = _posterior_sample(problem, (stP, stQ), K_COVID, 7)
    marg = s.marginals()
    qem_s = time.perf_counter() - t0
    mp = {k: marg.moments(k, mean).with_dims_front(list(latents[k].dims)).data.cpu().numpy()
          for k in gold}

    # NUTS (float64) and SMC (float32) at the script's 16 x 25
    nR, nD = GOLD_SMC_SHAPE
    ps_s, cov_s, data_s, walk_s = covid_recipe.recipe(nR, nD)
    P_s = covid.get_P(ps_s, cov_s, device="cuda")
    lat_s = _covid_truth_latents(ps_s, walk_s, "cuda")
    P_s64 = covid.get_P(ps_s, f64(cov_s), device="cuda")
    small_energy = _energy_errors(mcmc.LogPost(P_s, data_s, lat_s),
                                  mcmc.LogPost(P_s64, f64(data_s), f64(lat_s)),
                                  mcmc.LogPost(P_s64, f64(data_s), f64(lat_s)).theta0[None]
                                  .expand(4, -1), gen(11))
    Ws, Ss, Cs, MDs = GOLD_SMALL_NUTS
    t0 = time.perf_counter()
    small, small_diag = run_nuts(P_s64, f64(data_s), num_samples=Ss, num_warmup=Ws,
                                 num_chains=Cs, max_depth=MDs, generator=gen(8),
                                 latents=f64(lat_s))
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    smc, smc_info = run_smc(P_s, data_s, num_particles=GOLD_SMC_PARTICLES, generator=gen(9),
                            latents=lat_s)
    smc_s = time.perf_counter() - t0
    small_np = covid_recipe.draws_np(small)
    smc_means = {k: v.with_dims_front(["particle", *lat_s[k].dims]).data.cpu().numpy()
                 .mean(axis=0) for k, v in smc.items()}
    gold_diag, small_gold_diag = diagnose(gold), diagnose(small_np)
    res = {"phase": phase, "D": D, "nRs": ps["nRs"], "nDs_train": ps["nDs"],
           "logpost_rel_err_vs_f64": v_err, "grad_rel_err_vs_f64": g_err,
           "f32_logpost_rel_err_vs_f64": v_err32, "f32_grad_rel_err_vs_f64": g_err32,
           "energy_errors": energy, "dtype": "float64",
           "nuts": {"warmup": W, "draws": S, "chains": C, "max_depth": MD, "s": nuts_s,
                    "capture_s": diag["capture_s"],
                    "ms_per_draw_captured": nuts_ms, "ms_per_draw_eager": eager_ms,
                    "grad_evals_per_s_captured": leapfrogs / (nuts_ms / 1e3),
                    "grad_evals_per_s_eager": leapfrogs / (eager_ms / 1e3),
                    "mean_accept": diag["mean_accept"], "step_size": diag["step_size"],
                    "peak_mem_gb": nuts_peak, "captured_bitwise_eager_5_draws": nuts_bitwise,
                    "depth4_draw_max_abs_diff_host": draw_err,
                    "diagnostics": gold_diag},
           "hmc": {"warmup": Wh, "draws": Sh, "num_leapfrog": L, "s": hmc_s,
                   "capture_s": h_diag["capture_s"],
                   "grad_evals_per_s_captured": (L + 1) * C * (Wh + Sh) / hmc_s,
                   "ms_per_draw_captured": hmc_s / (Wh + Sh) * 1e3,
                   "mean_accept": h_diag["mean_accept"], "step_size": h_diag["step_size"],
                   "diagnostics": diagnose(covid_recipe.draws_np(h_samples))},
           "qem_k30": {"iters": GOLD_QEM_ITERS, "s": qem_s, **z_against(gold, gold_diag, mp)},
           "small": {"nRs": nR, "nDs_train": ps_s["nDs"], "D": small_diag["theta"].shape[-1],
                     "nuts_s": small_s, "nuts_capture_s": small_diag["capture_s"],
                     "nuts_ms_per_draw_captured":
                         (small_s - small_diag["capture_s"]) / (Ws + Ss) * 1e3,
                     "nuts_mean_accept": small_diag["mean_accept"],
                     "nuts_step_size": small_diag["step_size"],
                     "energy_errors": small_energy,
                     "nuts_diagnostics": small_gold_diag,
                     "smc_s": smc_s, "smc_particles": GOLD_SMC_PARTICLES,
                     "smc_log_Z": smc_info["log_Z"], "smc_stages": smc_info["stages"],
                     "smc_host_syncs": smc_info["host_syncs"],
                     "smc_mutation_accept": smc_info["mean_mutation_accept"],
                     **{f"smc_{k}": v for k, v in
                        z_against(small_np, small_gold_diag, smc_means).items()}}}
    if not bool(torch.isfinite(smc_info["theta"]).all()):
        faults.append("an SMC particle is not finite")
    res["ok"] = not faults
    for f in faults:
        fail(phase, f)
    emit(res)


def phase_checkpoint_resume():
    """Resume on the card, bitwise: covid QEM at K=30 under ``scan_steps``,
    10 steps against 5, a save, a load into a fresh problem and 5 more;
    grouped MovieLens VI at K=1000 (Adam's state) the same way; a file
    written on the card loads on the CPU and back."""
    import tempfile
    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.checkpointing import load_checkpoint, save_checkpoint
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.models import movielens as ml
    phase = "checkpoint_resume"
    checks = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")
                                     if os.path.isdir(os.path.join(REPO, "build")) else None) as tmp:
        def resume(name, make, n):
            step, state0 = make()
            full, _ = train.scan_steps(step, n)(state0,
                                                torch.Generator(device="cuda").manual_seed(3))
            gen = torch.Generator(device="cuda").manual_seed(3)
            half, _ = train.scan_steps(step, n // 2)(state0, gen)
            path = os.path.join(tmp, name)
            save_checkpoint(path, {"state": half, "generator": gen})
            ck = load_checkpoint(path)
            step2, _ = make()
            resumed, _ = train.scan_steps(step2, n - n // 2)(ck["state"], ck["generator"])
            a, sa = train._flatten(full)
            b, sb = train._flatten(resumed)
            same = sa == sb and all(torch.equal(x, y) for x, y in zip(a, b))
            # the card's file on the host and back
            host = load_checkpoint(path, device="cpu")
            save_checkpoint(path + "_host", {"state": host["state"]})
            back = load_checkpoint(path + "_host", device="cuda")["state"]
            h, _ = train._flatten(host["state"])
            c, _ = train._flatten(back)
            round_trip = all(x.device.type == "cpu" for x in h) and all(
                y.device.type == "cuda" and torch.equal(x, y)
                for x, y in zip(train._flatten(half)[0], c))
            checks[name] = {"steps": n, "bitwise": bool(same),
                            "card_host_card_bitwise": bool(round_trip),
                            "leaves": len(a), "bytes": os.path.getsize(path + ".npz")}
        ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cuda")
        resume("covid_qem_k30", lambda: train.qem(
            covid.generate_problem(ps, data, cov, "qem", device="cuda"), K_COVID,
            lr="0.1/t@100"), 10)
        mps, mdata, mcov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
        resume("grouped_movielens_vi_k1000", lambda: train.vi(
            ml.grouped_problem(mps, mdata, mcov, "opt", device="cuda"), K_MAIN), 10)
    ok = all(c["bitwise"] and c["card_host_card_bitwise"] for c in checks.values())
    if not ok:
        fail(phase, f"resume not bitwise: {checks}")
    emit({"phase": phase, **checks, "ok": ok})


# ---- phases 38-41: perf, profiling, the mesh plan, the runner ------------------

#: ms/step of each captured path by the slope rule (``_scan_phase``), which
#: ``perf_report`` divides the analytic FLOPs by
SLOPE_MS = {}


def _perf_paths(device):
    """name -> (path whose slope-rule ms it takes, one-step call, grad): the
    five paths of ``perf_report``, built on ``device`` from the same seeds."""
    from alan_tpu_torch import train
    from alan_tpu_torch.models import ar1, covid
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.utils import seeded_generator

    def call(step, state):
        return lambda: step(state, seeded_generator(5, device))

    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device=device)
    cps, _, cdata, _, ccov, _ = covid.load_data_covariates(seed=0, device=device)
    ar = ar1.generate_problem(device)
    f = train.elbo_fn(ar, K_AR1, reparam=False)
    return {
        "headline_qem_k30": ("scan_headline_k30", call(*train.qem(
            ml.generate_problem(ps, data, cov, device=device), K_HEADLINE, lr=LR_QEM,
            device=device)), True),
        "grouped_qem_k1000": ("scan_grouped_k1000_qem", call(*train.qem(
            ml.grouped_problem(ps, data, cov, device=device), K_MAIN, lr=LR_QEM,
            device=device)), True),
        "grouped_vi_k1000": ("scan_grouped_k1000_vi", call(*train.vi(
            ml.grouped_problem(ps, data, cov, "opt", device=device), K_MAIN, lr=0.01,
            device=device)), True),
        "covid_qem_k30": ("scan_covid_k30", call(*train.qem(
            covid.generate_problem(cps, cdata, ccov, "qem", device=device), K_COVID,
            lr=LR_QEM, device=device)), True),
        "ar1_elbo_k1000": ("scan_ar1_k1000", lambda: f(
            ar.P.state(), ar.Q.state(), seeded_generator(5, device)).detach(), False),
    }


def host_counts():
    """The analytic FLOPs of ``_perf_paths`` on the host's plain route, one
    JSON line: run by ``perf_report`` in a process of its own, with the
    card's matmul threshold (``ALAN_TPU_MATMUL_MIN_K=8``, ``reduce_ks``'s
    default for CUDA tensors) so the host takes the card's routes.  The
    plain joint-shift repair, which no hook counts, is off: on covid it
    would take the host minutes (93% of the chain's entries)."""
    import torch
    from alan_tpu_torch import perf
    from alan_tpu_torch.ops import logmmexp_kernel
    logmmexp_kernel.JOINT_BELOW = 0.0
    torch.set_num_threads(3)
    out = {}
    for name, (_, fn, grad) in _perf_paths("cpu").items():
        out[name] = perf.analytic_flops(fn, (), grad=grad)
    print(json.dumps(out), flush=True)


def _start_host_counts():
    """Start ``host_counts`` in a process of its own (killed at exit if the
    script ends before ``perf_report`` reads it)."""
    import atexit
    env = dict(os.environ, ALAN_TPU_MATMUL_MIN_K="8", CUDA_VISIBLE_DEVICES="")
    p = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.host_counts()"],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    atexit.register(lambda: p.poll() is None and p.kill())
    return p


def phase_perf_report(host):
    """``perf.mfu_report`` of each path's eager step at its captured loop's
    ms by the slope rule: analytic FLOPs a step (matmul and elementwise
    apart), ``FlopCounterMode``'s, ``mfu`` against TF32 and the float32
    share.  Gates: each analytic count equals the host's plain route's on
    the same problem exactly (``host``, the process ``_start_host_counts``
    started), and ``mfu`` <= 1 for both counts."""
    from alan_tpu_torch import perf
    phase = "perf_report"
    t0 = time.perf_counter()
    out, err = host.communicate(timeout=900)
    host_wait = time.perf_counter() - t0
    if host.returncode != 0:
        fail(phase, f"the host's count failed: {err[-2000:]}")
        return
    want = json.loads(out.strip().splitlines()[-1])
    rows, ok = {}, True
    for name, (slope_of, fn, grad) in _perf_paths("cuda").items():
        ms = SLOPE_MS.get(slope_of)
        if ms is None or not ms > 0:
            fail(phase, f"no slope-rule ms for {name} ({slope_of})")
            ok = False
            continue
        rep = perf.mfu_report(fn, (), ms / 1e3, device="cuda", grad=grad)
        same = all(rep[k] == want[name][v] for k, v in (
            ("flops_per_step_analytic", "flops"),
            ("matmul_flops_per_step_analytic", "matmul_flops"),
            ("elementwise_flops_per_step_analytic", "elementwise_flops")))
        under = rep["flops_per_step_analytic"] > 0 and all(
            rep[k] is not None and rep[k] <= 1 for k in ("mfu", "mfu_analytic"))
        rows[name] = {"ms_per_step": ms, "of": slope_of, "host_analytic": want[name],
                      "equals_host": same, **rep}
        if not same:
            ok = False
            fail(phase, f"{name}: card count {rep['flops_per_step_analytic']} != host "
                        f"{want[name]['flops']}")
        if not under:
            ok = False
            fail(phase, f"{name}: mfu {rep['mfu']} / {rep['mfu_analytic']} not in (0, 1]")
    emit({"phase": phase, "host_wait_s": host_wait, "paths": rows, "ok": ok})
    return rows


def phase_profiling_trace():
    """``profiling.trace`` around 3 eager covid steps (the trace file names
    the small-K chain kernels), ``timed_steps`` over 5 more (5 positive
    times) and ``device_memory_stats`` (its peak is
    ``max_memory_allocated``)."""
    import shutil
    import tempfile
    import torch
    from alan_tpu_torch import profiling, train
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.utils import seeded_generator
    phase = "profiling_trace"
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cuda")
    step, state = train.qem(covid.generate_problem(ps, data, cov, "qem", device="cuda"),
                            K_COVID, lr=LR_QEM)
    gen = seeded_generator(2, "cuda")
    state, _ = step(state, gen)                  # warm-up
    torch.cuda.synchronize()
    logdir = tempfile.mkdtemp(prefix="alan_trace_")
    try:
        t0 = time.perf_counter()
        with profiling.trace(logdir):
            for _ in range(3):
                state, _ = step(state, gen)
        trace_s = time.perf_counter() - t0
        path = os.path.join(logdir, "trace.json")
        size = os.path.getsize(path) if os.path.exists(path) else 0
        names = set()
        if size:
            with open(path) as fh:
                names = {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    chain = {k: sum(1 for n in names if k in n)
             for k in ("segment_fwd_kernel", "segment_bwd_kernel")}
    torch.cuda.reset_peak_memory_stats()
    state, outs, times = profiling.timed_steps(step, state, [gen] * 5)
    stats = profiling.device_memory_stats()
    peak = (stats.get("cuda:0") or {}).get("allocated_bytes.all.peak")
    res = {"phase": phase, "trace_bytes": size, "trace_s_3_steps": trace_s,
           "trace_chain_kernel_names": chain, "iter_times_s": times,
           "elbos": [float(e) for e in outs], "peak_bytes_stats": peak,
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "ok": True}
    if not size or not all(chain.values()):
        res["ok"] = False
        fail(phase, f"trace of {size} bytes, chain kernels named {chain}")
    if len(times) != 5 or not all(t > 0 for t in times) or not _finite(res["elbos"]):
        res["ok"] = False
        fail(phase, f"timed_steps gave {times}, ELBOs {res['elbos']}")
    if peak != res["max_memory_allocated"]:
        res["ok"] = False
        fail(phase, f"memory stats peak {peak} != max_memory_allocated")
    emit(res)


def _planned_case(plan, name, make, must_launch, seq_route):
    """One path under ``plan`` against the same step unplanned, from one
    generator seed and state: ELBO and state bitwise or within 1e-6
    relative, every kernel of ``must_launch`` launched under the plan,
    the T-sharded chain taken where ``seq_route``; eager ms of 3 steps,
    busy ms of a profile of 2, the collective inventory of one step."""
    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.parallel import collective_audit, seq
    from alan_tpu_torch.utils import seeded_generator
    plain_step, state0 = make(None)
    planned_step, _ = make(plan)
    out = {}
    for key, step in (("unsharded", plain_step), ("planned", planned_step)):
        step(state0, seeded_generator(1, "cuda"))              # warm-up
        torch.cuda.synchronize()
        zero_counts()
        calls0 = seq.CALLS
        state, elbo = step(state0, seeded_generator(3, "cuda"))
        torch.cuda.synchronize()
        launches, seq_calls = read_counts(), seq.CALLS - calls0
        t0 = time.perf_counter()
        st = state0
        for i in range(3):
            st, _ = step(st, seeded_generator(10 + i, "cuda"))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        prof = _profile_step(f"mesh_single_card_{name}_{key}", step, state0,
                             seeded_generator(4, "cuda"), ms)
        out[key] = {"state": state, "elbo": elbo, "launches": launches,
                    "seq_calls": seq_calls, "eager_ms": ms,
                    "busy_ms": prof["device_busy_ms"] / prof["steps"]}
    inv = collective_audit.collective_inventory(
        lambda: planned_step(state0, seeded_generator(3, "cuda")))
    a, b = out["planned"], out["unsharded"]
    la, _ = train._flatten(a["state"])
    lb, _ = train._flatten(b["state"])
    bitwise = torch.equal(a["elbo"], b["elbo"]) and all(torch.equal(x, y) for x, y in zip(la, lb))
    rel = max([_rel_diff(a["elbo"], b["elbo"])] + [
        ((x.double() - y.double()).abs().max() / y.double().abs().max().clamp(min=1e-30)).item()
        for x, y in zip(la, lb) if x.numel()])
    res = {"case": name, "elbo": float(a["elbo"]), "elbo_unsharded": float(b["elbo"]),
           "bitwise": bitwise, "max_rel_diff": rel,
           "launches_planned": {k: v for k, v in a["launches"].items() if v},
           "launches_unsharded": {k: v for k, v in b["launches"].items() if v},
           "seq_calls": a["seq_calls"], "collectives": inv,
           **{f"{k}_{m}": out[k][m] for k in ("planned", "unsharded")
              for m in ("eager_ms", "busy_ms")}, "ok": True}
    if not (bitwise or rel <= 1e-6):
        res["ok"] = False
        fail("mesh_single_card", f"{name}: planned differs from unsharded by {rel}")
    missing = [k for k in must_launch if not a["launches"].get(k)]
    if missing:
        res["ok"] = False
        fail("mesh_single_card", f"{name}: {missing} did not launch under the plan")
    if seq_route and a["seq_calls"] < 1:
        res["ok"] = False
        fail("mesh_single_card", f"{name}: the T-sharded chain was not taken")
    return res


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh_single_card():
    """The paths under a ``MeshPlan`` at world size 1 (one process, NCCL,
    a TCP store on 127.0.0.1): grouped MovieLens K=1000 QEM and VI under
    ``{"plate_1": "p"}`` + all K, covid K=30 QEM under ``{"nRs": "p"}`` +
    all K and under ``{"nDs": "t"}``, AR(1) K=1000's ELBO under
    ``{"T": "t"}``.  Returns each kernel counter's launches under a plan."""
    import torch.distributed as dist
    from alan_tpu_torch import train
    from alan_tpu_torch.models import ar1, covid
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.parallel import distributed
    from alan_tpu_torch.parallel.mesh import MeshPlan, make_mesh
    phase = "mesh_single_card"
    t0 = time.perf_counter()
    started = distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                                     device_type="cuda")
    cases = []
    try:
        kp = make_mesh({"k": 1, "p": 1})
        t1 = make_mesh({"t": 1})
        ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
        grouped = ml.grouped_problem(ps, data, cov, device="cuda")
        grouped_opt = ml.grouped_problem(ps, data, cov, "opt", device="cuda")
        plate = MeshPlan(kp, {"plate_1": "p"}).with_all_K("k")
        cases.append(_planned_case(plate, "grouped_qem_k1000", lambda plan: train.qem(
            grouped, K_MAIN, lr=LR_QEM, mesh_plan=plan), ["lowrank_fwd", "lowrank_bwd_dD"],
            False))
        cases.append(_planned_case(plate, "grouped_vi_k1000", lambda plan: train.vi(
            grouped_opt, K_MAIN, lr=0.01, mesh_plan=plan),
            ["lowrank_fwd", "lowrank_bwd_dU", "lowrank_bwd_dV"], False))
        cps, _, cdata, _, ccov, _ = covid.load_data_covariates(seed=0, device="cuda")
        cproblem = covid.generate_problem(cps, cdata, ccov, "qem", device="cuda")
        for label, plan in (("covid_qem_k30_nRs", MeshPlan(kp, {"nRs": "p"}).with_all_K("k")),
                            ("covid_qem_k30_nDs", MeshPlan(t1, {"nDs": "t"}))):
            cases.append(_planned_case(plan, label, lambda plan: train.qem(
                cproblem, K_COVID, lr=LR_QEM, mesh_plan=plan), ["smallk_fwd", "smallk_bwd"],
                label.endswith("nDs")))
        ar = ar1.generate_problem("cuda")

        def ar1_step(plan):
            f = train.elbo_fn(ar, K_AR1, reparam=False, mesh_plan=plan)

            def step(state, gen):
                return state, f(state[0], state[1], gen).detach()
            return step, (ar.P.state(), ar.Q.state())
        cases.append(_planned_case(MeshPlan(t1, {"T": "t"}), "ar1_elbo_k1000", ar1_step,
                                   ["logmmexp"], True))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    launches = {}
    for c in cases:
        for k, v in c["launches_planned"].items():
            launches[k] = launches.get(k, 0) + v
    emit({"phase": phase, "world_size": 1, "backend": "nccl", "initialized": started,
          "seconds": time.perf_counter() - t0, "cases": cases,
          "ok": all(c["ok"] for c in cases)})
    return launches


def _runner_record(argv, torchrun=False):
    """One runner invocation as a subprocess: (exit code, its JSON record or
    None, the end of its output)."""
    cmd = [sys.executable, "-m", "alan_tpu_torch.runner", *argv]
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
               "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
               "-m", "alan_tpu_torch.runner", *argv]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO))
    rec = None
    for line in reversed(p.stdout.strip().splitlines()):
        if line.startswith("{"):
            rec = json.loads(line)
            break
    return p.returncode, rec, (p.stdout + p.stderr)[-2000:]


def phase_runner_cli():
    """``python -m alan_tpu_torch.runner`` as a subprocess: covid QEM K=30
    for 5 iterations, the same with ``--split nRs 23``, and under
    ``torchrun --nproc-per-node 1`` with ``--mesh p=1 --shard nRs=p``.
    Each must exit 0 with finite ELBOs, its first ELBO the train API's
    from the same seed (the same strategy; the plan's against the plain
    step, bitwise or within 1e-6 relative)."""
    from alan_tpu_torch import Split, train
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.utils import seeded_generator
    phase = "runner_cli"
    base = ["--model", "covid", "--method", "qem", "--K", str(K_COVID), "--iters", "5"]
    runs = {"plain": (base, False, None), "split": (base + ["--split", "nRs", "23"], False,
                                                   Split("nRs", 23)),
            "torchrun_mesh": (base + ["--mesh", "p=1", "--shard", "nRs=p"], True, None)}
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, device="cuda")
    problem = covid.generate_problem(ps, data, cov, "qem", device="cuda")
    rows, ok = {}, True
    for name, (argv, torchrun, strategy) in runs.items():
        t0 = time.perf_counter()
        rc, rec, tail = _runner_record(argv, torchrun)
        secs = time.perf_counter() - t0
        kw = {} if strategy is None else {"computation_strategy": strategy}
        step, state = train.qem(problem, K_COVID, lr=LR_QEM, **kw)
        _, first = step(state, seeded_generator(1, "cuda"))
        row = {"rc": rc, "seconds": secs, "train_api_first_elbo": float(first)}
        good = rc == 0 and rec is not None and _finite(rec["elbos"]) and len(rec["elbos"]) == 5
        if good:
            row.update(elbos=rec["elbos"], mean_iter_time_s=rec["mean_iter_time_s"],
                       compile_time_s=rec["compile_time_s"],
                       peak_memory_bytes=rec["peak_memory_bytes"])
            rel = _rel_diff(rec["elbos"][0], float(first))
            row["first_elbo_bitwise"] = rec["elbos"][0] == float(first)
            row["first_elbo_rel_diff"] = rel
            good = row["first_elbo_bitwise"] or (torchrun and rel <= 1e-6)
        if not good:
            ok = False
            row["tail"] = tail
            fail(phase, f"{name}: rc {rc}, record {rec is not None}: {tail[-500:]}")
        rows[name] = row
    emit({"phase": phase, "runs": rows, "ok": ok})


#: the grid phase's iterations a job; the gold phase's NUTS draws (warm-up,
#: kept), QEM steps and K; the IS sweep's runs, Ks and chunk
GRID_ITERS = 3
MOMENTS_NUTS, MOMENTS_QEM_ITERS, MOMENTS_K = (100, 100), 50, 30
IS_RUNS, IS_MP_KS, IS_IS_KS, IS_CHUNK = 3, (3, 30, 300), (100, 10 ** 4, 10 ** 6), 30000
#: the planned captured loops' short and long calls (the slope rule)
SCAN_PLANNED = {"grouped_qem_k1000": (5, 20), "grouped_vi_k1000": (5, 20),
                "covid_qem_k30_nRs": (3, 12), "covid_qem_k30_nDs": (3, 12),
                "ar1_elbo_k1000": (5, 20)}


def _grid_spec(out_dir):
    """The grid phase's spec: full-size covid QEM K=30 and MovieLens QEM
    K=30, ``GRID_ITERS`` iterations each, records into ``out_dir``."""
    return {"defaults": {"iters": GRID_ITERS, "method": "qem", "K": K_COVID,
                         "out_dir": out_dir},
            "jobs": [{"model": "covid"}, {"model": "movielens"}]}


def phase_grid_cli():
    """A 2-job grid (``_grid_spec``) through ``runner --grid`` in this
    process (its launch counters read around it), then through
    ``python -m alan_tpu_torch.run_grid -j 1`` (``alan-grid`` built from
    ``csrc/gridrunner.cpp``, one process a job), and each job as a single
    ``runner`` run in this process.  Gates: every record's first ELBO
    bitwise the single run's, the status file 2 ok, a rerun adds nothing."""
    import shutil
    import tempfile
    from alan_tpu_torch import gridspec, runner
    phase = "grid_cli"
    root = tempfile.mkdtemp(prefix="alan_grid_")
    res, ok = {"phase": phase}, True
    try:
        specs = {}
        for name in ("grid", "alan_grid", "single"):
            os.makedirs(os.path.join(root, name))
            specs[name] = os.path.join(root, f"{name}.json")
            with open(specs[name], "w") as fh:
                json.dump(_grid_spec(os.path.join(root, name)), fh)
        t0 = time.perf_counter()
        zero_counts()
        runner.main(["--grid", specs["grid"]])
        launches = read_counts()
        res["grid_s"] = time.perf_counter() - t0
        status = os.path.join(root, "status.tsv")
        cmd = [sys.executable, "-m", "alan_tpu_torch.run_grid", specs["alan_grid"], "-j", "1",
               "-t", "600", "-s", status]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
        res["alan_grid_s"] = time.perf_counter() - t0
        res["alan_grid_rc"] = p.returncode
        for argv in gridspec.expand(_grid_spec(os.path.join(root, "single"))):
            runner.main(argv)
        with open(status) as fh:
            lines = fh.read().splitlines()
        res["status_ok"] = sum("\tok\t" in line for line in lines)
        rerun = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        with open(status) as fh:
            res["rerun_skipped"] = rerun.returncode == 0 and fh.read().splitlines() == lines
        rows = {}
        for fname in sorted(os.listdir(os.path.join(root, "single"))):
            recs = {}
            for name in ("grid", "alan_grid", "single"):
                path = os.path.join(root, name, fname)
                recs[name] = json.load(open(path)) if os.path.exists(path) else None
            firsts = {k: (r["elbos"][0] if r else None) for k, r in recs.items()}
            rows[fname] = {"first_elbos": firsts,
                           "bitwise": len({v for v in firsts.values()}) == 1
                           and None not in firsts.values(),
                           "finite": all(r is not None and _finite(r["elbos"])
                                         for r in recs.values()),
                           "mean_iter_time_s": {k: (r["mean_iter_time_s"] if r else None)
                                                for k, r in recs.items()},
                           "device_kind": recs["alan_grid"] and recs["alan_grid"]["device_kind"]}
        res.update(records=rows, launches={k: v for k, v in launches.items() if v})
        ok = (p.returncode == 0 and len(rows) == 2 and res["status_ok"] == 2
              and res["rerun_skipped"] and all(r["bitwise"] and r["finite"]
                                               for r in rows.values())
              and launches.get("smallk_fwd", 0) > 0 and launches.get("smallk_bwd", 0) > 0)
        if not ok:
            res["alan_grid_tail"] = (p.stdout + p.stderr)[-1500:]
            fail(phase, f"grid records, status or launches: {res}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["ok"] = ok
    emit(res)
    return res.get("launches", {})


def phase_moments_gold():
    """``runner_moments`` on MovieLens at its published size: NUTS gold in
    the data's float dtype (float32), QEM at K=30, the MP means from the
    marginals.  Gates: the record has the JAX harness's keys and finite
    values, and its MP means equal ``marginals()``' means recomputed on
    the fitted state from the same seed.  R-hat, ESS, the times and the
    MSE are reported, not gated."""
    import numpy as np
    import torch
    from alan_tpu_torch import runner_moments
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.utils import seeded_generator
    phase, seed = "moments_gold", 0
    problem = ml.load_and_generate_problem(seed=seed, Q_param_type="qem", device="cuda")[0]
    zero_counts()
    t0 = time.perf_counter()
    rec, gold, mp, dims = runner_moments.compare(
        problem, "movielens", K=MOMENTS_K, iters=MOMENTS_QEM_ITERS,
        hmc_samples=MOMENTS_NUTS[1], hmc_warmup=MOMENTS_NUTS[0], seed=seed, sampler="nuts")
    seconds = time.perf_counter() - t0
    launches = read_counts()
    marg = problem.sample(MOMENTS_K, seeded_generator(seed + 3, "cuda"),
                          reparam=False).marginals()
    again = runner_moments.mp_means(marg, dims)
    same = set(again) == set(mp) and all(np.array_equal(again[k], mp[k]) for k in mp)
    keys = {"model", "K", "iters", "hmc_time_s", "mp_time_s", "hmc_diag", "moment_mse"}
    diag = rec["hmc_diag"]
    finite = (all(math.isfinite(v) for v in rec["moment_mse"].values())
              and set(rec["moment_mse"]) == {"mu_z", "psi_z", "z"}
              and all(np.isfinite(g).all() for g in gold.values()))
    ok = keys <= set(rec) and finite and same
    out = {"phase": phase, "record": rec, "seconds": seconds,
           "nuts_draws": MOMENTS_NUTS, "dtype": str(next(iter(problem._data.values())).data.dtype),
           "mp_means_equal_marginals": same,
           "rhat_max": max(v for k, v in diag.items() if k.startswith("rhat_max")),
           "ess_min": min(v for k, v in diag.items() if k.startswith("ess_min")),
           "launches": {k: v for k, v in launches.items() if v}, "ok": ok}
    if not ok:
        fail(phase, f"record keys {sorted(rec)}, finite {finite}, MP means equal {same}")
    emit(out)
    del problem, marg
    torch.cuda.empty_cache()
    return out["launches"]


def phase_moments_is_sweep():
    """``runner_moments_IS.sweep`` on MovieLens at its published size: MP
    at K in ``IS_MP_KS``, global IS at K in ``IS_IS_KS`` streamed in chunks
    of at most ``IS_CHUNK``, ``IS_RUNS`` runs each; per K ``var_mse``,
    ``fake_mse``, ``run_s`` and the card's busy time and idle share of a
    run.  Gates: every K has the JAX record's keys and finite totals, and
    the JSON written to ``out`` is the returned record; the launch
    counters are read around the whole sweep."""
    import shutil
    import tempfile
    import torch
    from alan_tpu_torch import runner_moments_IS
    phase = "moments_is_sweep"
    out_dir = tempfile.mkdtemp(prefix="alan_is_")
    out_path = os.path.join(out_dir, "moments_is_movielens.json")
    zero_counts()
    t0 = time.perf_counter()
    rec = runner_moments_IS.sweep("movielens", list(IS_MP_KS), list(IS_IS_KS), runs=IS_RUNS,
                                  chunk=IS_CHUNK, out=out_path, device="cuda")
    seconds = time.perf_counter() - t0
    launches = read_counts()
    with open(out_path) as fh:
        written = json.load(fh) == json.loads(json.dumps(rec))
    shutil.rmtree(out_dir, ignore_errors=True)
    keys = {"run_s", "var_mse", "fake_mse", "var_mse_total", "fake_mse_total", "busy_s",
            "idle_share"}
    rows, ok = {}, True
    for tag in ("mp", "global_is"):
        for K, r in rec[tag].items():
            good = keys <= set(r) and all(r[k] is not None and math.isfinite(r[k]) for k in (
                "run_s", "var_mse_total", "fake_mse_total", "busy_s"))
            rows[f"{tag}_K{K}"] = ({k: r[k] for k in ("run_s", "steady_run_s", "busy_s",
                                                       "idle_share", "var_mse_total",
                                                       "fake_mse_total")}
                                   if good else r)
            ok = ok and good
    if not written:
        ok = False
        fail(phase, "the JSON written to --out differs from the returned record")
    if not ok:
        fail(phase, f"a K failed or lacks the record's keys: {rows}")
    emit({"phase": phase, "runs": IS_RUNS, "chunk": IS_CHUNK, "seconds": seconds,
          "per_K": rows, "launches": {k: v for k, v in launches.items() if v}, "ok": ok})
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


def _planned_scan_case(name, make, n_short, n_long):
    """One planned path at world size 1 through ``scan_steps``: its eager
    planned loop and its captured loop over ``n_short`` steps from one
    seed (ELBOs and state bitwise), the launches of a replay, captured
    ms/step by the slope rule beside the unsharded step's captured loop."""
    import torch
    from alan_tpu_torch import train
    planned, state0 = make(True)
    plain, _ = make(False)
    st_e, el_e = train._eager(planned, n_short, state0,
                              torch.Generator(device="cuda").manual_seed(5))
    run_s = train.scan_steps(planned, n_short)
    with _CountedCaptures() as cap:
        st_g, el_g = run_s(state0, torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    capture_s = run_s.capture_seconds
    la, _ = train._flatten(st_g)
    lb, _ = train._flatten(st_e)
    bitwise = torch.equal(el_g, el_e) and all(torch.equal(x, y) for x, y in zip(la, lb))
    ms, slopes, _ = _slope_ms(run_s, train.scan_steps(planned, n_long), state0)
    ms_plain, slopes_plain, _ = _slope_ms(train.scan_steps(plain, n_short),
                                          train.scan_steps(plain, n_long), state0)
    launches = cap.records[0] if cap.records else {}
    res = {"case": name, "n_steps": n_short, "bitwise_eager_planned": bitwise,
           "elbos": el_g.tolist(), "capture_s": capture_s,
           "captures": len(cap.records),
           "launches_per_replay": {k: v for k, v in launches.items() if v},
           "captured_ms_per_step": ms, "captured_ms_per_step_unsharded": ms_plain,
           "ratio": ms / ms_plain, "slopes_ms": slopes, "slopes_ms_unsharded": slopes_plain,
           "ok": bitwise and _finite(el_g.tolist()) and len(cap.records) == 1}
    if not res["ok"]:
        fail("scan_planned", f"{name}: captured planned loop against its eager loop: {res}")
    SLOPE_MS[f"scan_planned_{name}"] = ms
    del run_s
    torch.cuda.empty_cache()
    return res


def phase_scan_planned():
    """``mesh_single_card``'s five planned paths (world size 1, NCCL)
    through ``scan_steps``: each captured under its plan, bitwise its eager
    planned loop, with its launches per replay and its captured ms/step
    beside the unsharded step's captured ms/step."""
    import torch.distributed as dist
    from alan_tpu_torch import train
    from alan_tpu_torch.models import ar1, covid
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.parallel import distributed
    from alan_tpu_torch.parallel.mesh import MeshPlan, make_mesh
    phase = "scan_planned"
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device_type="cuda")
    cases = []
    try:
        kp, t1 = make_mesh({"k": 1, "p": 1}), make_mesh({"t": 1})
        ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
        grouped = ml.grouped_problem(ps, data, cov, device="cuda")
        grouped_opt = ml.grouped_problem(ps, data, cov, "opt", device="cuda")
        plate = MeshPlan(kp, {"plate_1": "p"}).with_all_K("k")
        cps, _, cdata, _, ccov, _ = covid.load_data_covariates(seed=0, device="cuda")
        cproblem = covid.generate_problem(cps, cdata, ccov, "qem", device="cuda")
        ar = ar1.generate_problem("cuda")

        def ar1_step(plan):
            f = train.elbo_fn(ar, K_AR1, reparam=False, mesh_plan=plan)
            return (lambda st, g: (st, f(st[0], st[1], g).detach())), (ar.P.state(),
                                                                         ar.Q.state())
        makes = {
            "grouped_qem_k1000": lambda plan: train.qem(grouped, K_MAIN, lr=LR_QEM,
                                                        mesh_plan=plan),
            "grouped_vi_k1000": lambda plan: train.vi(grouped_opt, K_MAIN, lr=0.01,
                                                      mesh_plan=plan),
            "covid_qem_k30_nRs": lambda plan: train.qem(cproblem, K_COVID, lr=LR_QEM,
                                                        mesh_plan=plan),
            "covid_qem_k30_nDs": lambda plan: train.qem(cproblem, K_COVID, lr=LR_QEM,
                                                        mesh_plan=plan),
            "ar1_elbo_k1000": ar1_step}
        plans = {"grouped_qem_k1000": plate, "grouped_vi_k1000": plate,
                 "covid_qem_k30_nRs": MeshPlan(kp, {"nRs": "p"}).with_all_K("k"),
                 "covid_qem_k30_nDs": MeshPlan(t1, {"nDs": "t"}),
                 "ar1_elbo_k1000": MeshPlan(t1, {"T": "t"})}
        for name, make in makes.items():
            try:
                cases.append(_planned_scan_case(
                    name, lambda planned, m=make, p=plans[name]: m(p if planned else None),
                    *SCAN_PLANNED[name]))
            except Exception as e:        # a case that cannot be captured is recorded
                import traceback
                cases.append({"case": name, "ok": False,
                              "error": f"{type(e).__name__}: {e}"[:2000],
                              "traceback": traceback.format_exc()[-3000:]})
                fail(phase, f"{name}: {type(e).__name__}: {str(e)[:500]}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    launches = {}
    for c in cases:
        for k, v in c.get("launches_per_replay", {}).items():
            launches[k] = launches.get(k, 0) + v
    emit({"phase": phase, "world_size": 1, "backend": "nccl",
          "seconds": time.perf_counter() - t0, "cases": cases,
          "ok": all(c["ok"] for c in cases)})
    return {c["case"]: c.get("launches_per_replay", {}) for c in cases}


# ---- phases 46-50: the quality experiments ---------------------------------------

#: phase 46's cuts, in draws and iterations only: both gold runs 100 warm-up
#: + 100 draws (the JAX scripts' 500 + 500; each run also captures its two
#: graphs, ~15 s each), the K sweep at K = 10, 30, 100
#: (its K = 300 point is phase 34's), corr_Q at K = 30 beside the sweep's
#: factorised K = 30, the particle trend at 256, 1024 and 2048 (4096); QEM
#: at the scripts' 150 steps
EXP_GOLD = (100, 100)
EXP_KS, EXP_CORRQ_KS, EXP_PARTICLES, EXP_ITERS = (10, 30, 100), (30,), (256, 1024, 2048), 150
#: phase 50 runs each occupancy configuration for a third of its steps
EXP_OCC_STEPS_CUT = 3


class _StepLaunches:
    """An ``after_step`` hook for ``experiments.covid_recipe.fit_mp``: each
    QEM step's small-K chain launches, forward and backward, beside the
    launch plan's length for the chain of ``T`` operators at the step's
    K (one forward and one backward launch a plan entry)."""

    def __init__(self, T):
        self.T, self.rows, self.last = T, [], None

    def __call__(self, tag, K, i):
        from alan_tpu_torch.ops.smallk_kernel import launch_plan
        now = read_counts()
        if i >= 0:
            self.rows.append((tag, i, {k: now[k] - self.last[k]
                                       for k in ("smallk_fwd", "smallk_bwd")},
                              len(launch_plan(self.T, K))))
        self.last = now

    def report(self):
        """({fit: {steps, launches a step, plan}}, steps off the plan)."""
        fits, off = {}, []
        for tag, i, d, plan in self.rows:
            f = fits.setdefault(tag, {"steps": 0, "per_step": set(), "plan": plan})
            f["steps"] += 1
            f["per_step"].add((d["smallk_fwd"], d["smallk_bwd"]))
            if d["smallk_fwd"] != plan or d["smallk_bwd"] != plan:
                off.append((tag, i, d, plan))
        return {k: dict(v, per_step=sorted(v["per_step"])) for k, v in fits.items()}, off


def _z_summary(entry):
    return {"overall": entry.get("overall"),
            "z_median_by_variable": {k: v["z_median"] for k, v in entry["variables"].items()}}


def _diag_summary(diag):
    return {"rhat_max": max(v["rhat_max"] for v in diag.values()),
            "ess_min": min(v["ess_min"] for v in diag.values()),
            "rhat_max_by_variable": {k: v["rhat_max"] for k, v in diag.items()}}


def phase_experiments_covid_gold():
    """``experiments`` modules 2-5 at covid 16 x 25 (``EXP_*``'s cuts), in
    one output directory so that the modules share the NUTS gold's cache.
    Gates: every gold draw (both runs) and SMC particle finite, every QEM
    ELBO finite, each QEM step's chain launches those of the launch plan
    (``_StepLaunches``).  Reported: z by K and by variable, NUTS's
    self-consistency z, R-hat, ESS, the gold's dtype and each module's
    seconds."""
    import tempfile
    import numpy as np
    import torch
    from alan_tpu_torch.experiments import (covid_corrq_probe, covid_k_sweep,
                                            covid_smc_particle_trend, moments_vs_hmc_covid)
    from alan_tpu_torch.experiments import covid_recipe as cr
    phase = "experiments_covid_gold"
    nRs, nDs = cr.REDUCED
    hook = _StepLaunches(int(0.8 * nDs))
    seconds = {}
    zero_counts()
    with tempfile.TemporaryDirectory() as out:
        common = dict(nRs=nRs, nDs=nDs, warmup=EXP_GOLD[0], draws=EXP_GOLD[1], device="cuda",
                      out_dir=out)
        t0 = time.perf_counter()
        hmc = moments_vs_hmc_covid.run(K=K_COVID, iters=EXP_ITERS,
                                       after_step=lambda i: hook("moments_K30", K_COVID, i),
                                       **common)
        seconds["moments_vs_hmc_covid"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sweep = covid_k_sweep.run(Ks=EXP_KS, iters=EXP_ITERS,
                                  after_step=lambda K, i: hook(f"sweep_K{K}", K, i), **common)
        seconds["covid_k_sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        corrq = covid_corrq_probe.run(Ks=EXP_CORRQ_KS, iters=EXP_ITERS, arms=(("corr_Q", True),),
                                      after_step=lambda a, K, i: hook(f"{a}_K{K}", K, i),
                                      **common)
        seconds["covid_corrq_probe"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        smc = covid_smc_particle_trend.run(particle_counts=EXP_PARTICLES, **common)
        seconds["covid_smc_particle_trend"] = time.perf_counter() - t0
        gold = np.load(os.path.join(out, "covid_nuts_gold.npz"))
        gold_finite = all(bool(np.isfinite(gold[k]).all()) for k in gold.files)
    launches = read_counts()
    fits, off_plan = hook.report()
    elbos_finite = {"moments_K30": hmc["mp_elbos_finite"],
                    **{f"sweep_K{K}": r["elbos_finite"] for K, r in sweep["by_K"].items()},
                    **{k: r["elbos_finite"] for k, r in corrq["arms"].items()}}
    draws_finite = {"gold": gold_finite, "gold2": hmc["diag2"]["finite"],
                    "smc_2048": smc["smc_diag"]["finite"],
                    **{f"smc_{n}": t["finite"] for n, t in smc["particle_trend"].items()}}
    steps = EXP_ITERS * (1 + len(EXP_KS) + len(EXP_CORRQ_KS))
    faults = []
    if not all(draws_finite.values()):
        faults.append(f"a draw is not finite: {draws_finite}")
    if not all(elbos_finite.values()):
        faults.append(f"an ELBO is not finite: {elbos_finite}")
    if off_plan or len(hook.rows) != steps:
        faults.append(f"{len(hook.rows)} of {steps} QEM steps read; off the launch plan: "
                      f"{off_plan[:5]}")
    res = {"phase": phase, "nRs": nRs, "nDs_train": int(0.8 * nDs),
           "cuts": {"gold_warmup_draws": EXP_GOLD, "Ks": EXP_KS, "corr_Q_Ks": EXP_CORRQ_KS,
                    "particles": EXP_PARTICLES, "iters": EXP_ITERS},
           "gold_dtype": hmc["gold_dtype"], "gold_diag": hmc["diag"], "gold2_diag": hmc["diag2"],
           "gold_diagnostics": _diag_summary(hmc["gold_diagnostics"]),
           "gold2_diagnostics": _diag_summary(hmc["gold2_diagnostics"]),
           "moments_vs_hmc": {"overall": hmc.get("overall"),
                              "by_variable": {k: {m: v[m] for m in (
                                  "z_median", "nuts_self_z_median", "nuts_converged_here")}
                                  for k, v in hmc["variables"].items()}},
           "z_by_K": {K: _z_summary(r) for K, r in sweep["by_K"].items()},
           "corr_Q": {k: _z_summary(r) for k, r in corrq["arms"].items()},
           "smc_vs_nuts": smc.get("overall"),
           "smc_particle_trend": {n: {m: t[m] for m in ("z_median", "frac_z_lt_5", "log_Z",
                                                      "smc_time_s")}
                                  for n, t in smc["particle_trend"].items()},
           "qem_launches_per_step": fits, "draws_finite": draws_finite,
           "elbos_finite": elbos_finite, "seconds": seconds,
           "launches": {k: v for k, v in launches.items() if v}, "ok": not faults}
    for f in faults:
        fail(phase, f)
    emit(res)
    torch.cuda.empty_cache()
    return res["launches"]


def phase_experiments_covid_full_quality():
    """``covid_full_qem_quality`` seed 0 at full size: 12 segments of 50
    captured QEM steps, the predictive log-likelihood over all 137 days
    after each.  Gates: every ELBO and predictive log-likelihood finite,
    the last segment's ELBO above the first's, each captured replay's
    chain launches 3 + 3 (the launch plan at T = 109, K = 30).  Reported:
    ELBO, predictive log-likelihood and ms a step by segment, the peak,
    latent recovery."""
    import torch
    from alan_tpu_torch.experiments import covid_full_qem_quality as fq
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.ops.smallk_kernel import launch_plan
    phase = "experiments_covid_full_quality"
    plan = len(launch_plan(int(0.8 * covid.nDs), fq.K))
    t0 = time.perf_counter()
    with _CountedCaptures() as caps:
        zero_counts()
        rec = fq.run_seed(0, "cuda")
        launches = read_counts()
    seconds = time.perf_counter() - t0
    segs = rec.pop("segments")
    rec.pop("final_flat_means")
    replays = [{k: c[k] for k in ("smallk_fwd", "smallk_bwd")} for c in caps.records]
    faults = []
    if not all(s["elbos_finite"] and math.isfinite(s["predictive_ll"]) for s in segs):
        faults.append("a non-finite ELBO or predictive log-likelihood")
    if not segs[-1]["elbo"] > segs[0]["elbo"]:
        faults.append(f"the last segment's ELBO {segs[-1]['elbo']} not above the first's "
                      f"{segs[0]['elbo']}")
    if not replays or any(r["smallk_fwd"] != plan or r["smallk_bwd"] != plan for r in replays):
        faults.append(f"captured replays' chain launches {replays}, plan {plan} + {plan}")
    res = {"phase": phase, "seed": 0, "K": fq.K, "segments_x_steps": (fq.N_SEGS, fq.SEG),
           "predictive_N": fq.PRED_N,
           "by_segment": {k: [s[k] for s in segs] for k in (
               "elbo", "predictive_ll", "moment_max_rel_drift", "ms_per_step",
               "predictive_ll_s")},
           "capture_s": segs[0]["capture_s"],
           "ms_per_step_median_after_capture": statistics.median(
               s["ms_per_step"] for s in segs[1:]) if len(segs) > 1 else None,
           **rec, "launches_per_replay": replays, "launches": launches,
           "seconds": seconds, "ok": not faults}
    for f in faults:
        fail(phase, f)
    emit(res)
    torch.cuda.empty_cache()
    return replays[0] if replays else {}


def phase_experiments_ffbs_coupling():
    """``ffbs_coupling_sweep`` at its defaults (K = 16, N = 4000, 8
    repetitions, five couplings).  Gate: the joint route within 5 standard
    errors of the Kalman posterior at every coupling; the conditional
    route reported."""
    import tempfile
    from alan_tpu_torch.experiments import ffbs_coupling_sweep as fs
    phase = "experiments_ffbs_coupling"
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rec = fs.run(device="cuda", out_dir=out)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    joint = {c: r["joint"]["max_bias_over_stderr"] for c, r in rec["couplings"].items()}
    ok = all(z <= 5.0 for z in joint.values())
    if not ok:
        fail(phase, f"the joint route's bias over its standard error {joint}")
    emit({"phase": phase, "K": rec["K"], "N": rec["N"], "reps": rec["reps"],
          "couplings": rec["couplings"], "joint_max_bias_over_stderr": joint,
          "seconds": seconds, "launches": {k: v for k, v in launches.items() if v}, "ok": ok})
    return {k: v for k, v in launches.items() if v}


def phase_latent_recovery():
    """``experiments.latent_recovery``: ``tests/test_latent_recovery.py``'s
    checks at its settings and bars (coverage 0.85, occupancy 0.70, the
    ELBO rising, the predictive log-likelihood improving), each gated."""
    import tempfile
    from alan_tpu_torch.experiments import latent_recovery as lr
    phase = "latent_recovery"
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rec = lr.run(device="cuda", out_dir=out)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    failed = [f"{test}/{m}" for test, v in rec.items() if test.startswith("test_")
              for m, r in (v.items() if "ok" not in v else [("", v)]) if not r["ok"]]
    if failed:
        fail(phase, f"failed: {failed}")
    emit({"phase": phase, **{k: v for k, v in rec.items() if k.startswith("test_")},
          "seconds": seconds, "launches": {k: v for k, v in launches.items() if v},
          "ok": not failed})
    return {k: v for k, v in launches.items() if v}


def phase_experiments_occupancy_collapse():
    """``occupancy_collapse_probe``'s seven configurations at a third of
    their steps (``EXP_OCC_STEPS_CUT``): coverage, median posterior sd and
    the last ELBOs reported; gate: every ELBO finite."""
    from alan_tpu_torch.experiments import occupancy_collapse_probe as oc
    phase = "experiments_occupancy_collapse"
    zero_counts()
    t0 = time.perf_counter()
    rec = {name: oc.run_config(name, method, qtype, K, iters // EXP_OCC_STEPS_CUT, lr,
                               device="cuda")
           for name, (method, qtype, K, iters, lr) in oc.CONFIGS.items()}
    seconds = time.perf_counter() - t0
    launches = read_counts()
    ok = all(r["elbos_finite"] for r in rec.values())
    if not ok:
        fail(phase, "a non-finite ELBO")
    emit({"phase": phase, "configs": {k: {m: r[m] for m in (
        "method", "K", "iters", "lr", "coverage", "median_post_sd", "elbo_end", "seconds")}
        for k, r in rec.items()}, "steps_cut": EXP_OCC_STEPS_CUT, "seconds": seconds,
        "launches": {k: v for k, v in launches.items() if v}, "ok": ok})
    return {k: v for k, v in launches.items() if v}


def nvidia_smi_clocks():
    """The card's SM clock, power draw and power limit, sampled now."""
    out = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main():
    # one card: the first visible one, so that device_count() is 1
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to drive",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import alan_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = nvidia_smi_line()
    phase_build()
    host = _start_host_counts()            # the host's counts, beside the card's phases
    lowrank = phase_kernels()
    smallk = phase_chain_kernels()
    fused = phase_fused_kernel()
    phase_families_cuda()
    fam_launches, fam_ms = phase_lowrank_families_k1000()
    problem, step, state, ml_launches = phase_main_path()
    phase_cross_check("cross_check", problem, step, state, K_MAIN,
                      {"ALAN_TPU_NO_LAZY_LOWRANK": "1"})
    state, post_launches = phase_grouped_posterior_k1000(problem, step)
    phase_grouped_posterior_cross_check(problem, state)
    graph_launches = phase_scan_grouped_k1000(problem)
    del problem, step, state
    problem, step, state = phase_movielens_k30_main_path()
    phase_cross_check("movielens_k30_cross_check", problem, step, state, K_HEADLINE,
                      {"ALAN_TPU_NO_MATMUL_CONTRACT": "1",
                       "ALAN_TPU_NO_LOWRANK_LOGPROB": "1"},
                      host_problem=_movielens_k30("cpu"))
    phase_is_draws_k30(problem)
    phase_scan_headline_k30(problem)
    phase_vmap_runs_k30(problem)
    phase_global_k30(problem)
    del problem, step, state
    problem, state, vi_launches, vi_modes = phase_vi_main_path()
    phase_grad_cross_check("vi_cross_check", problem, state, K_MAIN, True,
                           {"ALAN_TPU_NO_LAZY_LOWRANK": "1"},
                           exact_problem=_movielens_f64())
    del problem, state
    problem, step, state, covid_launches = phase_covid_main_path()
    phase_cross_check("covid_cross_check", problem, step, state, K_COVID,
                      {"ALAN_TPU_NO_SMALLK_CHAIN": "1"})
    state, covid_post_launches = phase_covid_posterior_k30(problem, step)
    phase_covid_posterior_cross_check(problem, state)
    graph_launches.update(phase_scan_covid_k30(problem))
    del problem, step, state
    problem, state, rws_launches = phase_covid_rws_path()
    phase_grad_cross_check("covid_rws_cross_check", problem, state, K_COVID, False,
                           {"ALAN_TPU_NO_SMALLK_CHAIN": "1"},
                           sample=_rws_draws(problem, state, K_COVID))
    del problem, state
    problem, step, state, corrq_launches = phase_covid_corrq_main_path()
    phase_cross_check("covid_corrq_cross_check", problem, step, state, K_COVID,
                      {"ALAN_TPU_NO_SMALLK_CHAIN": "1"})
    graph_launches.update(phase_scan_covid_corrq_k30(problem))
    del problem, step, state
    canonical_chain = phase_canonical_k30()
    ar1_launches = phase_ar1_large_k()
    ar1_post_launches = phase_ar1_ffbs_k1000()
    graph_launches.update(phase_scan_ar1_k1000())
    strategy_launches, seconds = {}, {}
    for name in ("strategies_covid_k30", "strategies_grouped_k1000", "covid_k300_split",
                 "gold_analytic", "gold_covid", "checkpoint_resume"):
        t0 = time.perf_counter()
        out = globals()[f"phase_{name}"]()
        seconds[name] = time.perf_counter() - t0
        if name == "strategies_grouped_k1000":
            strategy_launches.update({f"grouped_k1000_{m}": v for m, v in out.items()})
        elif out is not None:
            strategy_launches[name.replace("strategies_", "")] = out
    emit({"phase": "strategies_and_gold", "seconds": seconds})
    for name, run in (("perf_report", lambda: phase_perf_report(host)),
                      ("profiling_trace", phase_profiling_trace),
                      ("mesh_single_card", phase_mesh_single_card),
                      ("runner_cli", phase_runner_cli)):
        t0 = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t0
        if name == "mesh_single_card":
            mesh_launches = out
    emit({"phase": "perf_mesh_runner", "seconds": {k: seconds[k] for k in (
        "perf_report", "profiling_trace", "mesh_single_card", "runner_cli")}})
    new_launches = {}
    for name in ("grid_cli", "moments_gold", "moments_is_sweep", "scan_planned"):
        t0 = time.perf_counter()
        new_launches[name] = globals()[f"phase_{name}"]()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "grid_moments_planned", "seconds": {k: seconds[k] for k in (
        "grid_cli", "moments_gold", "moments_is_sweep", "scan_planned")}})
    experiment_launches = {}
    for name in ("experiments_covid_gold", "experiments_covid_full_quality",
                 "experiments_ffbs_coupling", "latent_recovery",
                 "experiments_occupancy_collapse"):
        t0 = time.perf_counter()
        experiment_launches[name] = globals()[f"phase_{name}"]()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "experiments", "seconds": {k: seconds[k] for k in experiment_launches}})

    def new_paths(*keys):
        """Each new path's launches of the counters ``keys``: the grid's
        and the harnesses' over their run, the planned loops' per replay
        by case."""
        out = {path: {k: per.get(k, 0) for k in keys}
               for path, per in new_launches.items() if path != "scan_planned"}
        out["scan_planned_per_replay"] = {
            case: {k: per.get(k, 0) for k in keys}
            for case, per in new_launches["scan_planned"].items()}
        return out

    def experiments(*keys):
        """Each experiment phase's launches of the counters ``keys`` (the
        full-size quality run's per replay)."""
        return {path: {k: per.get(k, 0) for k in keys}
                for path, per in experiment_launches.items()}

    def graphed(key):
        """Each captured path's launches of one counter: per replay, and
        the replays of the path's checked call."""
        return {path: {"per_replay": launches[key], "replays": replays}
                for path, (launches, replays) in graph_launches.items()
                if launches.get(key)}

    def by_strategy(*keys):
        """Each strategy path's launches a step of the counters ``keys``."""
        return {path: {st: {k: per.get(k, 0) for k in keys} for st, per in runs.items()}
                for path, runs in strategy_launches.items()
                if any(per.get(k) for per in runs.values() for k in keys)}

    smallk_src = "alan_tpu_torch/csrc/smallk_logmmexp.cu"
    emit({"kernels": [
        dict(name="lowrank_lse_fwd", route="cuda",
             source="alan_tpu_torch/csrc/lowrank_lse.cu",
             replaces="alan_tpu/ops/pallas_lowrank.py:215",
             launches=ml_launches["lowrank_fwd"], vi_launches=vi_launches["lowrank_fwd"],
             mesh_launches=mesh_launches.get("lowrank_fwd", 0),
             posterior_launches={k: v["lowrank_fwd"] for k, v in post_launches.items()},
             graph_launches=graphed("lowrank_fwd"),
             families_launches=fam_launches["lowrank_fwd"],
             new_path_launches=new_paths("lowrank_fwd"),
             experiment_launches=experiments("lowrank_fwd"),
             strategy_launches=by_strategy("lowrank_fwd"),
             families_ms={k: {m: v[m] for m in ("F", "fwd_ms", "plain_fwd_ms",
                                                 "fwd_bound_tc_ms")}
                          for k, v in fam_ms.items()},
             library_ms=None, **lowrank["fwd"]),
        dict(name="lowrank_lse_bwd", route="cuda",
             source="alan_tpu_torch/csrc/lowrank_lse.cu",
             replaces="alan_tpu/ops/pallas_lowrank.py:298",
             launches=ml_launches["lowrank_bwd"],
             mesh_launches_by_mode={m: mesh_launches.get(f"lowrank_bwd_{m}", 0)
                                    for m in ("dD", "dU", "dV")},
             vi_launches_by_mode={m: vi_launches[f"lowrank_bwd_{m}"] for m in ("dD", "dU", "dV")},
             vi_device_ms_per_step=vi_modes,
             posterior_launches_by_mode={
                 k: {m: v[f"lowrank_bwd_{m}"] for m in ("dD", "dU", "dV")}
                 for k, v in post_launches.items()},
             graph_launches={m: graphed(f"lowrank_bwd_{m}") for m in ("dD", "dU", "dV")},
             families_launches_by_mode={m: fam_launches[f"lowrank_bwd_{m}"]
                                        for m in ("dD", "dU", "dV")},
             new_path_launches=new_paths("lowrank_bwd_dD", "lowrank_bwd_dU",
                                         "lowrank_bwd_dV"),
             experiment_launches=experiments("lowrank_bwd_dD", "lowrank_bwd_dU",
                                             "lowrank_bwd_dV"),
             strategy_launches=by_strategy("lowrank_bwd_dD", "lowrank_bwd_dU",
                                           "lowrank_bwd_dV"),
             families_ms={k: {m: v[m] for m in ("F", "bwd_dD_ms", "bwd_all_grads_ms",
                                                 "bwd_dD_bound_tc_ms",
                                                 "bwd_all_grads_bound_tc_ms")}
                          for k, v in fam_ms.items()},
             library_ms=None, **lowrank["bwd"]),
        dict(name="smallk_logmmexp_fwd", route="cuda", source=smallk_src,
             replaces="alan_tpu/ops/pallas_smallk.py:66",
             launches=covid_launches["smallk_fwd"], rws_launches=rws_launches["smallk_fwd"],
             mesh_launches=mesh_launches.get("smallk_fwd", 0),
             corrq_launches=corrq_launches["smallk_fwd"],
             posterior_launches={k: v["smallk_fwd"] for k, v in covid_post_launches.items()},
             graph_launches=graphed("smallk_fwd"),
             canonical_launches={k: v.get("smallk_fwd") for k, v in canonical_chain.items()},
             strategy_launches=by_strategy("smallk_fwd"),
             new_path_launches=new_paths("smallk_fwd"),
             experiment_launches=experiments("smallk_fwd"),
             covid_own={k: FIXUP_REPORTS["covid_own"][k] for k in (
                 "chain_fwd_ms", "fast_fwd_ms", "fixup_fwd_ms", "fixup_fwd_bound_ms",
                 "joint_entries")},
             library_ms=None, **smallk["fwd"]),
        dict(name="smallk_logmmexp_bwd", route="cuda", source=smallk_src,
             replaces="alan_tpu/ops/pallas_smallk.py:80",
             launches=covid_launches["smallk_bwd"], rws_launches=rws_launches["smallk_bwd"],
             mesh_launches=mesh_launches.get("smallk_bwd", 0),
             corrq_launches=corrq_launches["smallk_bwd"],
             posterior_launches={k: v["smallk_bwd"] for k, v in covid_post_launches.items()},
             graph_launches=graphed("smallk_bwd"),
             canonical_launches={k: v.get("smallk_bwd") for k, v in canonical_chain.items()},
             strategy_launches=by_strategy("smallk_bwd"),
             new_path_launches=new_paths("smallk_bwd"),
             experiment_launches=experiments("smallk_bwd"),
             covid_own={k: FIXUP_REPORTS["covid_own"][k] for k in (
                 "chain_bwd_ms", "fast_bwd_ms", "fixup_bwd_ms", "fixup_bwd_bound_ms",
                 "flagged_pairs_bwd")},
             library_ms=None, **smallk["bwd"]),
        dict(name="logmmexp_fused", route="cuda",
             source="alan_tpu_torch/csrc/logmmexp.cu",
             replaces="alan_tpu/ops/pallas_logmmexp.py:28",
             launches=ar1_launches["logmmexp"],
             mesh_launches=mesh_launches.get("logmmexp", 0),
             posterior_launches={"importance_sample": ar1_post_launches["logmmexp"]},
             strategy_launches=by_strategy("logmmexp"),
             new_path_launches=new_paths("logmmexp"),
             experiment_launches=experiments("logmmexp"),
             graph_launches=graphed("logmmexp"),
             ar1_own_fixups=FIXUP_REPORTS["ar1_own"],
             ar1_own_bwd_fixups=[{k: r[k] for k in (
                 "nb_M_K_N", "joint_entries", "saving_ms", "bwd_ms", "fixup_bwd_ms",
                 "fixup_bound_ms", "fixup_bwd_bound_share", "kept_bytes",
                 "peak_growth_saving_bytes")}
                 for r in FIXUP_REPORTS["ar1_own_bwd"]],
             library_ms=None, **fused),
    ]})
    print(card, flush=True)
    if FAILURES:
        for f in FAILURES:
            print(f"chip_smoke FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
