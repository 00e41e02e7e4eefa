#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``nmma_tpu_torch/csrc`` and drives the
EM parameter-estimation main path of ``nmma_tpu_torch`` with its source
models: the Bu2019lm SVD surrogate at production width (P=4, H=2048, C=10,
F=9, Q=150) through K1, the analytic Me2017 kilonova (299 shells, T=150,
9 filters x 9 bandpass nodes) through K2, the TrPi2018 GRB afterglow at the
JAX package's full resolution (48 rings x 16 phi nodes, 256 radii, stage 2
on 128, 64 observer times, 5 filters) through K4 (its stage 1) and K3, and
Me2017 + TrPi2018 through K2, K4 and K3; then TrPi2018's energy ramp through
K4's per-row times and K3's per-row mode,
config 3's posterior against the JAX package's, the ensemble MCMC, the
supernova, shock-cooling, spectral and bolometric paths, GW-only BNS
inference through nmma-generation / nmma-analysis (no kernel), and joint
GW + EM + EOS inference (BASELINE config 5: the sparse Bu2019lm surrogate,
P=2, H=128, through K1, and EOS tables the port's TOV solver makes); then
fiesta surrogates, FITS sky maps, POSSIS spectra and the post-processing
(no kernel of their own; Bu2019lm through K1 where they use it); then
K1's general path, surrogate training, likelihood-free inference and the
EOS emulators (K1 only); then survey cadences, the command-line tools, the
native table loader and the model registry (K1 only); then the analysis
service and the SkyPortal bridge (K2, K3), with the best-fit reports and
light-curve bands on the runs that make them (K1, K2, K3):

  1. device   the card's name, and its name and power limit from nvidia-smi;
  2. build    nvcc build of every kernel, all started together, in seconds,
              and ptxas's registers, stack and spills of each kernel;
  3. k1       K1 against its plain PyTorch version on the card at the main
              path's shapes (B = 1, 128, 8199; max abs error <= 1e-4 mag),
              then its device time at the samplers' B = 128 (torch.profiler
              over 20 launches) and kernel and plain timings at B = 8192
              (CUDA events, median of 25 rounds of 10 launches), each with
              its bound;
  4. logl     synthetic photometry from the surrogate -> .dat file ->
              load_em_observations -> EMAnalysis.batched_logl at B = 8192
              (one K1 launch, no K2 launch): finite share, evals/s over 5
              rounds of >= 0.4 s of back-to-back calls (with the spread of
              the rounds), and max |dlogL| against the same batch with the
              plain K1 on the card; a torch.profiler pass at B = 8192 and
              128 gives device-busy time and idle share;
  5. sampler  EMAnalysis.run: nested sampling with nlive=1024, n_delete=128,
              capped at 40 iterations and 90 s; logZ, likelihood calls and
              the run's K1 launches, which must be 1 + iterations x walks,
              with no K2 launch; result files.
  6. k2       K2 against its plain version on the card at B = 1, 128, 8199
              under the near-tie rule (ops/me2017_kernel.py
              compare_dynamics): max relative errors, near-ties, mismatches;
              r_photo must equal the plain version's bit for bit and ltot
              lie within 1e-4 relative where ltot_ref > 1e-4; then its
              device time at B = 128 and kernel and plain timings at
              B = 8192 as for K1; then [k2_ties]: K2 against its plain
              version at B = 1024 on shells tied exactly in pairs
              (ops/me2017_kernel.py tied_operands), the pair in two lanes
              and in two slots of one lane: r_photo bit for bit, at least
              100 ties where the pair's vm differ, ltot within 1e-4, one
              launch per call;
  7. me2017_logl
              the same as phase 4 with the Me2017 model (one K2 and one K5
              launch, no K1 launch), its peak device memory, and |dlogL|
              against the plain K2 off the live points where the plain
              version sees a near-tie;
  8. me2017_sampler
              the same as phase 5 with the Me2017 model: K2 launches
              1 + iterations x walks, K5 launches as many, K6 launches one
              per MAX_BATCH part of each likelihood call, no K1 launch.
  8a. k5      K5 (csrc/bb_photometry.cu, the banded blackbody) against the
              plain photometry on the card at B = 8192, 256 and 61:
              Me2017's photospheres from K2 with the temperature fill's
              edge cases (undefined at the head, in the middle and at the
              tail; one valid sample; none) through the kernel's prologue,
              and Piro2021, blackbody_fixedT and HoNa2020 photospheres
              without it: one launch a call, max |dmag| over the finite
              entries <= 1e-4 and the same infinities; then K5's device
              time at B = 8192 and 256, the plain chain's, the bound and
              the peak memory of each;
  8b. k6      K6 (csrc/em_likelihood.cu, the EM likelihood from the
              source's magnitudes) against the plain likelihood on the card
              at B = 8192, 256, 61 and 8253 (two parts), on Me2017 (Pei
              SMC, a sampled E(B-V)), Me2017 with a composite filter, the
              CCM89 foreground, a detection limit and time-node
              systematics, TrPi2018 and the Bu2019lm surrogate (row
              selection, a composite V, a detection limit): one launch a
              part, max |dlogL| / max(1, |logL|) over the finite rows <=
              1e-4 and the same -1e30 rows; then K6's device time at
              B = 8192 and 256, the plain chain's, the bound and the peak
              memory of each;
  9a. k4      K4 (csrc/grb_dynamics.cu, TrPi2018's stage 1) against the
              plain stage 1 on the card over the Gaussian, tophat and
              power-law jets, spreading with and without the trumpet and
              without spreading, no injection and an injection by
              log10_L0, an L0 column or a constant L0, R = 256 and 128,
              shared and per-row times (B = 257 config-3 prior draws each,
              one K4 launch each): the operands without a sum bit for bit,
              t_delay and the log tracks within the K4_* tolerances where
              gamma - 1 >= 1e-2 and the tracks within the tail's bound
              below it (with an injection, all but 1e-4 of the values),
              K3's flux of the two within 1e-3; then
              [k4_fault]: PERF.md section 7's fault point inside a B = 8192
              batch, K4 against the plain stage 1 there and the logL of
              each; then K4's device time at B = 8192 and 64, the plain
              stage 1's, the bound and the peak memory of each;
  9. k3       K3 against its plain version on the card on stage-1 operands
              of config-3 prior draws at B = 1, 64, 257 (max relative error
              where |ref| > 1e-6 max|ref|, <= 1e-4); then the kernel's time
              at B = 8192 (median of 5 rounds of 2 launches), its time on
              the same rows with every query moved above the cap (the map,
              cummax and phi sum alone), the plain version's (one call) and
              the bound; then [k3_edges]: K3 against its plain version on
              hand-made rows (ops/grb_kernel.py edge_operands: cummax
              plateaus, queries on a node, on a plateau value, at both ends
              and outside the rows) at R = 100, 128, 256, T = 37, Ph = 5
              and 16: within the same 1e-4, zeros in the same places, one
              launch per call;
 10. grb_logl the same as phase 7 with TrPi2018 on config-3 photometry (one
              K3 and one K4 launch, no K1 or K2 launch), with |dlogL| against
              the plain
              K3 at B = 1024 and the profile at B = 8192 and 64 with K3's
              device time;
 11. grb_sampler
              nested sampling with config 3's nlive=512, n_delete=64,
              walks=16, capped at 40 iterations and 90 s: K3 and K4
              launches 1 + iterations x walks each, no K1 or K2 launch,
              finite logZ;
 12. combined_logl
              Me2017 + TrPi2018 (make_combined_source_model) on synthetic
              photometry, one batched_logl at B = 1024: one K2, one K3 and
              one K4 launch, |dlogL| against the plain K2 and K3 off near-tie live
              points.
 13. cli      nmma_tpu_torch.cli.lightcurve_analysis.main([config.yaml])
              in-process on the production surrogate (9 filters, Q = 150):
              photometry from an injection json, Ebv shaped by --Ebv-max,
              yaml systematics with time nodes on one filter group, G23-MW
              extinction, a checkpoint after every chunk; nested sampling
              (nlive=512, walks=8, dlogz=0.5) to convergence. logZ,
              iterations, calls and seconds; K1 launches 3 + iterations x
              walks (the injection's light curve, the initial live set, one
              per walk step, the best-fit report of --bestfit, on by
              default), no K2 or K3 launch; every result file and the
              checkpoint; main([config, "--skip-sampling"]) must regenerate
              the run's logZ bit for bit; the logL at the injection (its
              first and last epochs on the model grid's end nodes) finite.
 14. kn_models
              HoNa2020, blackbody_fixedT, PL_BB_fixedT and
              synchrotron_powerlaw (plain PyTorch, no kernel): batched_logl
              at B = 8192 on photometry each model makes at its injection,
              with finite share, evals/s, device-busy ms of one profiled
              call and peak memory; then the card against the port on the
              CPU at B = 128 on the same unit points (rtol 1e-4, atol 1e-2,
              identical sentinels).
 15. k3_rowq  K3's per-row query mode (log_q [rows, 1], the energy ramp's
              folded (live point, node) rows) against its plain version on
              ramp-prior operands at 1, 1,000 and 4,096 rows and on the
              hand-made edge rows with one query each (R = 100, 128, 256,
              Ph = 5, 16): 1e-4 relative, zeros in the same places (on the
              ramp-prior rows a subnormal counts as zero, as in the JAX
              reference, which flushes them); its time and bound at 4,096
              rows, and over the 91 chunks of the B = 8192 ramp's 524,288
              rows.
 16. grb_ramp TrPi2018 on the quasi-static energy ramp at full resolution
              (RAMP_PRIOR_TEXT): magnitudes and logL at B = 64 against the
              plain K3 (1e-3 mag below FAINT_MAG, identical inf; the logL
              gate of phase 10); batched_logl at B = 64 and 8192 with K3
              and K4 launches and the grb.ramp.chunks counter equal to the
              chunks exactly (1 and 91), wall and device ms,
              evals/s and peak memory; and the ramp's meaning (before
              t_start the constant-E0(Estart) curve, after the injection
              the constant-E0(Eend) one, between them inside both).
 17. posterior_config3
              BASELINE config 3 to convergence at nlive=2048
              (scripts/torch_parity_config3.py): K3 launches 1 + iterations
              x walks, logZ against the JAX package's -59.4958 +- 0.0843
              (within 5 combined errors) and JS per parameter against its
              two reference posteriors in artifacts/, each below 0.01.
 18. mcmc     the [cli] configuration with --sampler mcmc (MCMC_WALKERS,
              MCMC_SWEEPS, MCMC_TEMPS): K1 launches 3 + 2 x sweeps, max
              R-hat <= 1.1, JS per parameter against the [cli] run's nested
              posterior below 0.05, the result files.
 19. em_models
              Piro2021, Sr2023 and a spectral template model
              (tests/data/synthetic_sn_template.dat) through batched_logl,
              Arnett and Arnett_modified through the bolometric likelihood,
              at B = 8192 as phase 14, with the card against the CPU at
              B = 128.
 20. lbol     lightcurve-analysis-lbol (lbol_main) on an Arnett csv from an
              injection, to convergence at nlive=256: finite logZ and the
              injection inside each parameter's 90% interval.
 21. gw_waveform
              the GW-only BNS path (BASELINE config 5's GW settings: H1, L1
              and V1, 64 s, 25-1024 Hz, IMRPhenomD_NRTidalv2, relative
              binning at epsilon 0.1; no K1-K3 on it): TaylorF2, IMRPhenomD
              and IMRPhenomD_NRTidalv2 at B = 8192 on the relative-binning
              edges of the three detectors and at B = 256 on the dense grid
              (63,937 bins), device ms, card against CPU (amplitude within
              GW_AMP_RTOL, complex strain within GW_STRAIN_TOL of its
              maximum); then a 36+29 Msun BBH whose band reaches PhenomD's
              intermediate amplitude: its 5x5 solve and amplitude against
              the CPU.
 22. gw_logl  nmma_generation at full width on a json injection (a
              zero-noise injection), then the relative-binning joint
              likelihood of the dump through build_joint_likelihood at
              B = 8192: finite share, evals/s over 5 rounds of >= 0.4 s,
              device-busy ms, launches and idle share at B = 8192 and 128
              ([gw_profile]), peak memory; the card against the port on the
              CPU at B = 128 (the GW logL gate, identical sentinels); logL
              at the injection against SNR^2/2 within 2e-3; relative
              binning against dense within 1.0 at tests/test_gw.py's five
              points.
 23. gw_dense the dense likelihood, and the phase + distance + time
              marginalised one (262,144-point FFTs), at B = 1024 and 8192 in
              chunks of DENSE_CHUNK_BYTES: ms, chunks and peak memory.
 24. gw_sampler
              nmma_analysis's sampler on the relative-binning likelihood
              (nlive=1024, n_delete=128, walks=24), capped at 40 iterations
              and 90 s: batched logL calls 1 + iterations x walks, finite
              logZ, no K1-K3 launch.
 25. gw_cli   nmma_generation on a LIGO-LW xml injection and one .gwf strain
              file per detector (written by write_gwf: 256 s of seeded
              design-PSD noise, then the 64 s segment with the injection and
              a zero noise realisation), through the read, median-Welch PSD,
              Tukey window and FFT; then nmma_analysis in process to
              convergence under GW_CLI_CAP: the generation's seconds per
              phase, iterations, logZ, seconds, and the injection inside
              the 90% intervals of chirp_mass, mass_ratio and
              luminosity_distance.
 26. k1_sparse
              (phases 26-30 run after phase 20, before phase 21)
              K1 built for P = 2 against its plain version on the sparse
              surrogate's operands at config 5's grid (Q = 100), B = 1,
              128, 8199 at F = 9 (every trained filter, what the joint
              path's model evaluates) and F = 2 (ztfg, ztfr): <= 1e-4 mag,
              one launch a call; ms and bound at B = 8192 and 128, the
              plain version's ms; a P the kernel was not built for refused
              before any launch; [ptxas] per template instance.
 27. eos    the port's TOV solver builds config 5's EOS family on the card
              (10 NEP tables on a numpy crust, 64 central pressures each,
              one RK4 loop) and writes the macro files; M and R against
              the CPU within 1e-5, Lambda within 5e-3 from 1 Msun; each
              table's M_TOV; load_macro_eos_set and the TabulatedEOSSet
              step at B = 8192.
 28. joint_logl
              nmma_generation of config 5 at full width on those files,
              then the joint likelihood (relative-binning GW + EM through
              K1 + the tabulated EOS) at B = 8192 and the sampler's 256
              ([joint_profile]): one K1 launch a call and no K2/K3,
              evals/s, launches, idle share, peak memory; the card against
              the port on the CPU at B = 256 within the GW gate of the GW
              term plus the EM gate of the EM term, identical sentinels.
 29. joint_reweight
              one generation with --eos-reweight and a lower-MTOV
              constraint: the sorted directory, ascending weights summing
              to 1, a finite test logL.
 30. joint_cli
              nmma_generation and nmma_analysis to convergence
              (nlive=1024, n_delete=256, walks=16, dlogz=0.1, cap 600):
              K1 launches 3 + iterations x walks (the injection's light
              curve, the test logL, the initial live set, one batch a walk
              step), no K2/K3; logZ, seconds; the injection inside the 90%
              intervals of chirp_mass, mass_ratio, luminosity_distance and
              EOS_index.

 31. fiesta_lc
              (phases 31-37 run after phase 25, on the EOS tables of phase
              27) a lightcurve-kind fiesta surrogate seeded at the
              production Bu2019lm surrogate's filters, parameters, supports
              and 100-point grid with two hidden layers of 2,048 (this
              repo's assumed shape: no fiesta weights are in the repo),
              through EMAnalysis.batched_logl at B = 8192 and 128 on
              photometry it makes: evals/s, device-busy ms, idle share,
              launches, peak memory; the card against the CPU at B = 128
              (magnitudes within 1e-4 mag, the logL gate); no K1-K3.
 32. fiesta_flux
              a flux-kind surrogate on TrPi2018's 8 parameters with
              alphaWing (64 log-spaced frequencies over the GRB filters,
              100 times, two hidden layers of 2,048) at B = 8192, at the
              filters' frequencies and over their quadrature: ms, peak
              memory, the GRB gate's count equal to the CPU's, magnitudes
              within 1e-4 mag of the CPU at B = 512.
 33. fiesta_cli
              lightcurve-analysis --fiesta-surrogates-dir on a fiesta-format
              directory of phase 31's surrogate (pickled metadata and
              per-filter parameter trees), nested sampling to convergence
              at nlive 512: seconds, logZ, the 90% intervals beside the
              injection (printed, not gated: a seeded random network need
              not make every parameter identifiable).
 34. fits     a multi-order sky map (UNIQ and the four *_SAMPLES columns)
              and an m4opt limit map written with write_bintable;
              lightcurve-analysis --fits-file --dL --ra --dec
              --detection-limit-fits-file on the [cli] configuration with
              KNtheta from the sky map's inclination prior, --skip-sampling
              on the card and the CPU (the prior's nodes and the limit
              equal), then the card's analysis capped at 40 iterations:
              K1 launches 1 + iterations x walks.
 35. possis   a seeded POSSIS ASCII spectrum (4 angles, 500 wavelengths, 50
              times) through spectral_model_from_file, batched_logl at
              B = 8192 as phase 19, the card against the CPU at B = 128.
 36. marginalisation
              lightcurve-marginalisation on 2,000 seeded GW posterior
              samples, the EOS tables and Bu2019lm (one K1 launch):
              seconds, and the percentile bands within 1e-4 mag of the
              port's CPU run on the same draws; --plot where matplotlib is
              present (the card's machine has none: printed as not run).
 37. resampling
              GWEMResampler on the EOS tables and MaximumMassResampler on
              their baryonic tables (host odeint, 10 EOS x 19 masses), each
              a nested run capped at 40 iterations: seconds, finite logZ,
              no K1-K3 launch.

 38. k1_general
              (phases 38-42 run last; no K2 or K3 launch in any, and their
              K1 launches counted exactly) K1's general path against its
              plain version at (P, C) = (1, 10), (3, 8), (6, 10), (7, 6),
              (4, 6), (4, 40), B = 1, 128, 8199, F = 9, H = 2048, Q = 150
              on seeded weights, within 1e-4 mag; ms at B = 8192 beside
              the bound and the plain version's; (4, 10) and (2, 10) still
              routed to the specialised instantiations, P = 17 refused.
 39. svd_train
              1,024 Bu2019lm points (the production surrogate's plain K1
              at seeded points in its bounds) written as bulla files;
              create-svdmodel --axial-symmetry, C = 10, H = 2048, 4,000
              epochs, 100 times (3,072 entries): seconds reading,
              interpolating, decomposing and fitting, epochs/s, train and
              holdout MSE, peak memory; the first 20 epochs card against
              CPU from the same weights; svdmodel-benchmark (one K1
              launch); K1 on the trained surrogate against its plain
              version; the [cli] configuration on it, capped at 40
              iterations (K1 launches 3 + iterations x walks); a second
              training, C = 8 on 3 parameters (Bu2019nsbh's filenames,
              KNphi at 45), whose surrogate takes K1's general path in one
              batched_logl at B = 8192 against the plain K1.
 40. gp_train create-svdmodel --interpolation-type api_gp on the grid (one
              1,024^2 Cholesky, 90 right-hand sides); the sklearn_gp
              backend on its first 256 points for up to 400 steps; seconds,
              peak memory, first and last NLL, all 400 steps finite
              (fault 3h: the noise bound keeps the f32 Cholesky able to
              factor) and the step the bound first bound, NaN count 0;
              magnitudes at 64 held-out points
              card against CPU.
 41. lfi      lightcurve-analysis --sampler neuralnet on the [cli]
              configuration (3,000 simulations, 400 epochs, 20,000 draws),
              then with --lfi-vicreg-pretrain (60 epochs) and with
              --lfi-pretrained-embedding on a seeded state dict under the
              reference's key names: seconds of each stage, K1 launches
              (the injection's light curve, one simulation batch), the
              result's keys, the injected parameters inside and outside
              the 90% intervals.
 42. tov_emulator
              train_tov_emulator on the [eos] crust at its defaults (128
              NEP EOS, hidden 64, 4,000 epochs): seconds for the targets
              and the fit; M_TOV and R_1.4 at 32 held-out NEP points against
              the port's TOV solver; the emulator step and a seeded LEC-13
              set at B = 8192, ms and card against CPU.

 43. cadences
              (phases 43 and 46 run last; 44 after phase 37, on its tmp
              files; 45 after phase 39, on its grid) create_light_curve_data
              on the production surrogate at TRIGGER_MJD with --ztf-sampling,
              --ztf-uncertainties and --ztf-ToO 180, and with
              --rubin-ToO-type platinum, 4 seeds each, on the card (one K1
              launch a call) and on the CPU: epochs and limits bit for bit,
              magnitudes within 1e-4 mag, detection flags and errors equal
              but at detections within 1e-4 mag of their limit or of an
              uncertainty interval's edge (counted); epochs and detections
              per filter; then the [cli] configuration with --ztf-sampling
              --ztf-uncertainties on ztfg, ztfr, ztfi, capped at 40
              iterations: K1 launches 3 + iterations x walks, no K2/K3.
 44. tools    each entry point the twelfth slice added to cli/tools.py once,
              on the card where it runs a model or a sampler:
              lightcurve-generation on 16 injections (16 K1 launches),
              nmma-create-injection --ejecta-conversion --eos-dir on the
              [eos] tables, gwem-resampling (nlive 128, 40 iterations),
              gwem-Hubble-estimate (with and without GW posteriors),
              combine-EOS, convert-skyportal-lcs, nmma-make-lcs on the
              [possis] spectrum, multi-config-analysis (one subprocess of
              the port's CLI on the card, rc 0), the two slurm tools;
              plot-svdmodel-benchmarks and nmma-plot-multi-corner where
              matplotlib is present (else printed as not run); seconds
              and files written.
 45. native   the native loader's library (native/, else built into
              _build/, else np.loadtxt), then parse_many over the 1,024
              bulla files of phase 39 against np.loadtxt, bit for bit, and
              the seconds of each.
 46. registry a reference-layout registry tree written from the production
              surrogate and served on 127.0.0.1: download_model, ingestion
              onto the card, batched_logl at B = 8192 (one K1 launch) equal
              bit for bit to the .npz surrogate's (printed as skipped,
              naming the package, without joblib or h5py); then get_model
              through a hook copying the .npz and load_registered_model,
              with the same check.

 47. bestfit  (inside phase 13) the [cli] run's {label}_bestfit.json: its
              log evidence and best-fit index the run's; then
              compute_chisquare_dict at its best-fit point on the card,
              counted (one K1 launch exactly); that table and the report's
              each within 1e-3 + 1e-3 chi^2/dof of the port's compute on
              the CPU at the same point on the same data.
 48. lc_bands (inside phases 13, 17 and 50) plotting.lightcurve_bands on
              the [cli] run (Bu2019lm), config 3's converged run (TrPi2018)
              and the SkyPortal bridge's run (Me2017, nlive 128): the best
              fit and 60 posterior draws (each run holds more equal-weight
              samples; B = 61 is required) in one model call, one launch of
              K1, K3 or K2 exactly, against the same call with the plain
              kernel on the card (1e-4 mag, 1e-3 below mag 45, 1e-3), inf
              and NaN in the same places; the figure drawn only where
              matplotlib is present ("matplotlib=absent" on the card's
              machine).
 49. service  (phases 49 and 50 run last) nmma_tpu_torch.api's
              AnalysisService on the card on an ephemeral port: a Me2017
              request (tests/test_services.py's payload) with a callback to
              a loopback server, a TrPi2018 request at full resolution, both
              at nlive 64, and a model off the whitelist (400): wall s and
              K1-K3 launches of each (K2 or K3 only, > 0), K6 launches one
              per MAX_BATCH part of each likelihood call, the callback
              exactly once.
 50. skyportal
              run_from_skyportal_inputs on a Me2017 SkyPortal payload (a
              photometry csv from 0.5 d after the event, a redshift csv,
              fix_z, nlive 128) through the port's CLI on the card, through
              the invoke hook (which keeps the run's analysis for
              [lc_bands], and takes out --plot where matplotlib is absent):
              status success, a logZ off the sentinel, the posterior,
              result and best-fit files, K2 launches only (K5 as many, K6
              one per MAX_BATCH part of each likelihood call).
 51. mesh     (runs after phase 5) the nested sampler split over a
              torch.distributed group (nmma_tpu_torch.parallel), on phase
              4's analysis with nlive 1,024, n_delete 128, 10 iterations:
              (a) one rank on NCCL in this process, NestedSampler with
              make_mesh() against it without: samples, logL and logZ bit
              for bit, K1 launches 1 + iterations x walks in both runs (at
              1,024 and 128 rows), and as many likelihood collectives with
              the mesh; (b) two ranks sharing the card (this script with
              --mesh-rank, gloo, each killed after MESH_TIMEOUT_S): the
              ranks' results bit for bit equal, K1 launches 1 +
              iterations x walks on each at half the batch (512 and 64
              rows), shard_logl on 8192 seeded rows
              against the one-process batched_logl (sentinels identical,
              |dlogL| <= 1e-2 + 1e-4 |logL|, K1's 1e-4 mag carried to
              logL), and logZ within 3 max(hypot(errors), 0.1) of the
              one-process run's (whether it is bit for bit is printed).
              Printed: wall s of each run, each collective's mean us at
              B = 128 (NCCL, one rank; gloo, 64 rows a rank) and the card's
              idle share over a sharded walk step at B = 128.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line. Without a CUDA device it exits 1 at once.

``python3 chip_smoke.py --mesh-rank RANK DIRECTORY`` is one rank of phase
51(b), started by the smoke itself.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(HERE, "artifacts", "Bu2019lm_production_svd.npz")
MODEL = "Bu2019lm_production"
# the headline prior of the repo's benchmark (bench.py:59-66)
PRIOR_TEXT = """\
log10_mej_dyn = Uniform(minimum=-3., maximum=-1.)
log10_mej_wind = Uniform(minimum=-2., maximum=-0.5)
KNphi = Uniform(minimum=15., maximum=75.)
KNtheta = Uniform(minimum=0., maximum=90.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
INJECTION = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2, "KNphi": 45.0,
             "KNtheta": 30.0, "luminosity_distance": 40.0, "timeshift": 0.0}
TRIGGER_MJD = 60000.0
DEVICE = "cuda"
BATCH = 8192
K1_TOL = 1e-4                # mag, as tests/test_pallas_svd.py:55
LOGL_RTOL, LOGL_ATOL = 1e-4, 1e-2
# the Me2017 path: the in-repo prior of tests/test_inference.py:61-66 with
# the distance and timeshift free, and its injection (:46-47)
ME_PRIOR_TEXT = """\
log10_mej = Uniform(minimum=-3., maximum=-0.5)
log10_vej = Uniform(minimum=-2., maximum=-0.5)
beta = Uniform(minimum=1., maximum=5.)
log10_kappa_r = Uniform(minimum=-1., maximum=2.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
ME_INJECTION = {"log10_mej": -1.3, "log10_vej": -1.1, "beta": 3.0,
                "log10_kappa_r": 0.8, "luminosity_distance": 40.0,
                "timeshift": 0.0}
# f32 operations per (live point, shell, step) in the K2 loop body
# (csrc/me2017_dynamics.cu), and per (live point, step) outside it
K2_OPS_SHELL_STEP = 31
K2_OPS_STEP = 2
# K2's ltot against its plain version, relative, where ltot_ref > 1e-4: the
# kernel's one reciprocal per shell-step and FMAs read ~5e-7 in the CPU
# emulation (tests/test_torch_me2017.py); 20x inside compare_dynamics' 2e-3
K2_LTOT_TOL = 1e-4
# the samplers' walk batch (n_delete=128), where K1 and K2 run 961 times
SAMPLER_BATCH = 128
# [mesh]: the capped sampler's iterations, and the seconds after which the
# two ranks of (b) are killed
MESH_ITERATIONS = 10
MESH_TIMEOUT_S = 240
# the TrPi2018 path: BASELINE config 3, scripts/bench_grb_pe.py:17-50
GRB_FILTERS = ["ztfg", "ztfr", "ztfi", "X-ray-1keV", "radio-6GHz"]
GRB_PRIOR_TEXT = """\
log10_E0 = Uniform(minimum=49., maximum=54.)
thetaCore = Uniform(minimum=0.01, maximum=0.3)
thetaWing = 0.4
inclination_EM = Uniform(minimum=0., maximum=0.5)
log10_n0 = Uniform(minimum=-4., maximum=1.)
p = Uniform(minimum=2.01, maximum=2.9)
log10_epsilon_e = Uniform(minimum=-3., maximum=-0.3)
log10_epsilon_B = Uniform(minimum=-5., maximum=-0.5)
xi_N = 1.0
luminosity_distance = 350.0
timeshift = Uniform(minimum=-0.1, maximum=0.1)
"""
GRB_INJECTION = {"log10_E0": 51.5, "thetaCore": 0.1, "thetaWing": 0.4,
                 "inclination_EM": 0.05, "log10_n0": -1.5, "p": 2.4,
                 "log10_epsilon_e": -1.2, "log10_epsilon_B": -3.0,
                 "xi_N": 1.0, "luminosity_distance": 350.0, "timeshift": 0.0}
# relative, where |ref| > 1e-6 max|ref|: K3 reads <= 2.6e-5 against its plain
# version on the card, a bf16 hat (the JAX default's) 3e-4 to 7e-4 against
# the plain version on the CPU (tests/test_torch_grb.py)
K3_TOL = 1e-4
# K4 (TrPi2018's stage 1) against the plain stage 1 on the card. The two
# differ only in the order of the five running sums (sequential in r in K4,
# torch.cumsum's parallel scan in the plain version). r_grid, scal, log_q,
# d_cos, inv_dl26 and the phi nodes hold no sum: bit for bit. t_delay and
# the log tracks are bounded node by node by how well stage 1 is
# conditioned there. Where gamma - 1 >= 1e-2: t_delay within K4_TDELAY_TOL
# relative, the tracks within K4_TRACK_TOL in the log (1e-4 of the
# quantity, K3's own tolerance). In the Newtonian tail below it, gamma - 1
# cancels in f32 (gamma = sqrt(1 + u2) rounds to within 2^-24 of 1 + u2/2)
# and a one-ulp change of gamma moves the field, nu_m', nu_c' and the
# emission by up to ~2 2^-24 / (gamma - 1) in the log: there the tracks'
# bound is K4_TRACK_TOL plus K4_TAIL_ULPS of that amplification; 1 -
# beta_sh cancels as well, and t_delay is not bounded node by node. With an
# energy injection the bounds hold at all but K4_ONSET_SHARE of the values:
# where t_b crosses ts, a one-ulp change of t_b switches E_inj on or off,
# and a ring whose E_iso sits at its 1e-12 floor changes gamma by orders of
# magnitude there. K3's flux of the two sets of operands: K4_FLUX_TOL
# relative, the magnitude gate of tests/test_torch_grb.py (1e-3 mag)
K4_TDELAY_TOL = 1e-5
K4_TRACK_TOL = 1e-4
K4_TAIL_ULPS = 64
K4_ONSET_SHARE = 1e-4
K4_FLUX_TOL = 1e-3
# stage 1's parameters a K4 comparison draws for its switches: the power
# law's b, an energy injection log10_L0 (or L0, a column or a constant),
# q and ts
K4_B_RANGE = (1.5, 9.0)
K4_LOG10_L0_RANGE = (44.0, 48.0)
# a column of L0 in erg/s is f32 and tops out at 3.4e38
K4_LOG10_L0_COLUMN_RANGE = (30.0, 38.0)
K4_Q_VALUES = (0.0, 0.5, 1.0, 1.0005, 2.0)
K4_TS_RANGE = (1e2, 1e4)
# PERF.md §7: a proposal at the top of log10_E0 where the program and the
# benchmark's reference disagree (both sides of one run)
K4_FAULT_U = (0.99999988, 0.95318, 0.83112, 0.24144, 0.14920, 0.02560,
              0.35947, 0.57345)
# [k4] draws from a generator of its own, so the phases after it see the
# draws they saw before it was added
K4_SEED = 22
# [k5] draws from a generator of its own, for the same reason; K5 against
# the plain photometry on the card: max |dmag| over the finite entries (the
# two differ in the order of the sum over the nodes alone), at the sampler
# cells' batch, the documented traffic's n_delete and a batch that fills no
# warp evenly
K5_SEED = 24
K5_MAG_TOL = 1e-4
K5_BATCHES = (BATCH, 256, 61)
# [k6] draws from a generator of its own, for the same reason; K6 against
# the plain likelihood on the card: max |dlogL| / max(1, |logL|) over the
# rows finite on both sides (the two differ in the order of the sums over
# the nodes and the observations, and in erfcx), the -1e30 rows identical,
# at the same batches and at one of two MAX_BATCH parts
K6_SEED = 26
K6_LOGL_TOL = 1e-4
K6_BATCHES = (BATCH, 256, 61, BATCH + 61)
# the systematics of [k6]'s time-node case: three nodes on the optical
# filters, one sampled value on the rest
K6_SYSTEMATICS = {
    "optical": {"filters": ["F606W", "ztfi"], "time_nodes": 3,
                "time_range": "linear 0.5 12.0",
                "prior": "Uniform(minimum=0.05, maximum=1.0)"},
    "rest": {"prior": "Uniform(minimum=0.05, maximum=1.0)"},
}
K6_EBV_PRIOR = "Ebv = Uniform(minimum=0., maximum=0.5)\n"
# Me2017 + TrPi2018: the model and prior of BASELINE config 4
# (scripts/bench_grb_pe.py:63-97) on synthetic photometry
COMBINED_PRIOR_TEXT = """\
log10_mej = Uniform(minimum=-3., maximum=-1.)
log10_vej = Uniform(minimum=-2., maximum=-0.5)
beta = Uniform(minimum=1., maximum=5.)
log10_kappa_r = Uniform(minimum=-1., maximum=2.)
log10_E0 = Uniform(minimum=47., maximum=53.)
thetaCore = Uniform(minimum=0.01, maximum=0.3)
thetaWing = 0.3
inclination_EM = Uniform(minimum=0., maximum=0.4)
log10_n0 = Uniform(minimum=-5., maximum=1.)
p = Uniform(minimum=2.01, maximum=2.9)
log10_epsilon_e = Uniform(minimum=-3., maximum=-0.3)
log10_epsilon_B = Uniform(minimum=-5., maximum=-0.5)
xi_N = 1.0
luminosity_distance = 350.0
timeshift = 0.0
"""
COMBINED_INJECTION = {"log10_mej": -1.3, "log10_vej": -1.1, "beta": 3.0,
                      "log10_kappa_r": 0.8, "log10_E0": 51.0,
                      "thetaCore": 0.1, "thetaWing": 0.3,
                      "inclination_EM": 0.05, "log10_n0": -1.5, "p": 2.4,
                      "log10_epsilon_e": -1.2, "log10_epsilon_B": -3.0,
                      "xi_N": 1.0, "luminosity_distance": 350.0,
                      "timeshift": 0.0}
# the lightcurve-analysis CLI on the production surrogate: its config (keys
# are the flags' destinations), the injection's extinction and trigger time
# beside INJECTION, and yaml systematics with time nodes on one filter group
CLI_CONFIG = {
    "model": "Bu2019lm_cli", "label": "chip_smoke_cli",
    "filters": "sdssu,ztfg,ztfr,ztfi,ps1::z,ps1::y,2massj,2massh,2massks",
    "tmin": 0.25, "tmax": 12.0, "ebv-max": 0.5,
    "extinction-law": "G23_MW", "nlive": 512, "n-delete": 128, "walks": 8,
    "dlogz": 0.5,
    "check-point-delta-t": 0.0, "seed": 7,
}
CLI_INJECTION = {"Ebv": 0.1, "trigger_time": TRIGGER_MJD}
CLI_SYSTEMATICS = {
    "optical": {"filters": ["ztfg", "ztfr", "ztfi"], "time_nodes": 3,
                "time_range": "linear 0.5 12.0",
                "prior": "Uniform(minimum=0.0, maximum=1.0)"},
    "rest": {"prior": "Uniform(minimum=0.0, maximum=1.0)"},
}
# the kilonova models without a kernel: (prior, injection, grid start)
KN_MODELS = {
    "HoNa2020": ("""\
log10_mej = Uniform(minimum=-2.5, maximum=-1.)
vej_min = Uniform(minimum=0.03, maximum=0.08)
vej_max = Uniform(minimum=0.2, maximum=0.4)
vej_frac = Uniform(minimum=0.2, maximum=0.8)
log10_kappa_low_vej = Uniform(minimum=-0.5, maximum=0.5)
log10_kappa_high_vej = Uniform(minimum=0.3, maximum=1.)
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.1, maximum=0.1)
""", {"log10_mej": -1.5, "vej_min": 0.05, "vej_max": 0.3, "vej_frac": 0.5,
      "log10_kappa_low_vej": 0.0, "log10_kappa_high_vej": 0.7,
      "luminosity_distance": 40.0, "timeshift": 0.0}, 0.05),
    "blackbody_fixedT": ("""\
log10_bb_luminosity = Uniform(minimum=40., maximum=42.)
temperature = Uniform(minimum=3000., maximum=10000.)
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.1, maximum=0.1)
""", {"log10_bb_luminosity": 41.0, "temperature": 5000.0,
      "luminosity_distance": 40.0, "timeshift": 0.0}, 0.01),
    "PL_BB_fixedT": ("""\
log10_bb_luminosity = Uniform(minimum=40., maximum=42.)
temperature = Uniform(minimum=3000., maximum=10000.)
beta = Uniform(minimum=0.5, maximum=2.)
powerlaw_mag = Uniform(minimum=18., maximum=24.)
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.1, maximum=0.1)
""", {"log10_bb_luminosity": 41.0, "temperature": 5000.0, "beta": 1.0,
      "powerlaw_mag": 21.0, "luminosity_distance": 40.0,
      "timeshift": 0.0}, 0.01),
    "synchrotron_powerlaw": ("""\
alpha_time = Uniform(minimum=0.5, maximum=1.5)
beta_freq = Uniform(minimum=0.5, maximum=1.)
F_ref = Uniform(minimum=1e9, maximum=1e11)
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.1, maximum=0.1)
""", {"alpha_time": 1.0, "beta_freq": 0.75, "F_ref": 1e10,
      "luminosity_distance": 40.0, "timeshift": 0.0}, 0.01),
}
# TrPi2018 on the quasi-static energy ramp: config 3's prior with log10_E0
# replaced by the ramp's four parameters, around the point of
# tests/test_grb.py:287-293 (t_start and the ramp's end inside the grid)
RAMP_PRIOR_TEXT = """\
energy_exponential = Uniform(minimum=0.8, maximum=1.4)
log10_Eend = Uniform(minimum=52., maximum=53.)
t_start = Uniform(minimum=1e4, maximum=5e4)
injection_duration = Uniform(minimum=1e6, maximum=3e6)
""" + GRB_PRIOR_TEXT.split("\n", 1)[1]
RAMP_INJECTION = {**{k: v for k, v in GRB_INJECTION.items()
                     if k != "log10_E0"},
                  "energy_exponential": 1.2, "log10_Eend": 52.5,
                  "t_start": 2.0e4, "injection_duration": 2.0e6}
# the folded live points of [k3_rowq] (x 64 nodes = 4,096 rows, the
# sampler's B = 64 as one ramp chunk)
RAMP_POINTS = 64
# the ramp's magnitudes through K3 against the plain K3: the fused-hat gate
# of tests/test_torch_grb.py; points fainter than FAINT_MAG (its rule) are
# counted, not compared
RAMP_MAG_TOL = 1e-3
FAINT_MAG = 45.0
# the ensemble MCMC on the [cli] configuration. ~70% of its prior volume is
# the -1e30 sentinel, and untempered walkers stay on that plateau: 2,000
# sweeps without a ladder read max R-hat 4.86 on the card (5.13 in the JAX
# package on the CPU); an 8-rung ladder hands them to the hot rungs
MCMC_WALKERS = 256
MCMC_SWEEPS = 4000
MCMC_TEMPS = 8
MCMC_RHAT_GATE = 1.1
MCMC_JS_GATE = 0.05
# the supernova, shock-cooling and spectral models: (prior, injection,
# model grid (tmin, tmax, n_tsteps, timescale), filters, epochs)
SN_TEMPLATE = os.path.join(HERE, "tests", "data", "synthetic_sn_template.dat")
EM_MODELS = {
    "Piro2021": ("""\
log10_Menv = Uniform(minimum=-2., maximum=-0.5)
log10_Renv = Uniform(minimum=12., maximum=14.)
log10_Ee = Uniform(minimum=49., maximum=51.)
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.02, maximum=0.02)
""", {"log10_Menv": -1.0, "log10_Renv": 13.0, "log10_Ee": 50.0,
      "luminosity_distance": 40.0, "timeshift": 0.0},
        (1.0 / 24.0, 3.5, 100, "log"), ["sdssu", "ztfg", "ztfr", "ztfi"],
        (0.1, 3.0)),
    "Sr2023": ("""\
alpha_AG = Uniform(minimum=0.5, maximum=1.5)
""" + "".join(f"""\
a_AG_{f} = Uniform(minimum=1., maximum=100.)
f_nu_{f} = Uniform(minimum=1., maximum=10.)
host_mag_{f} = Uniform(minimum=20., maximum=24.)
""" for f in ("ztfg", "ztfr", "ztfi")) + """\
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.1, maximum=0.1)
""", {"alpha_AG": 1.0, "luminosity_distance": 40.0, "timeshift": 0.0,
      **{f"{k}_{f}": v for f in ("ztfg", "ztfr", "ztfi")
         for k, v in (("a_AG", 10.0), ("f_nu", 5.0), ("host_mag", 22.0))}},
        (0.1, 20.0, 50, "log"), ["ztfg", "ztfr", "ztfi"], (0.5, 15.0)),
    "sn_template_smoke": ("""\
supernova_mag_boost = Uniform(minimum=-1., maximum=1.)
luminosity_distance = Uniform(minimum=10., maximum=500.)
timeshift = Uniform(minimum=-1., maximum=1.)
""", {"supernova_mag_boost": 0.0, "luminosity_distance": 100.0,
      "timeshift": 0.0},
        (1.0, 60.0, 60, "linear"), ["sdssu", "ztfg", "ztfr", "ztfi"],
        (3.0, 50.0)),
}
# the Arnett bolometric path: prior and injection of
# tests/test_torch_em_models.py (lbol_data)
ARNETT_PRIOR_TEXT = """\
tau_m = Uniform(minimum=5., maximum=30.)
log10_mni = Uniform(minimum=-2., maximum=0.)
"""
ARNETT_INJECTION = {"tau_m": 15.0, "log10_mni": -0.5}
# the GW-only BNS path: BASELINE config 5's GW settings
# (scripts/bench_joint_pe.py:47-52) without its EM and EOS parts, and the
# injection of tests/test_gw.py:11-13
GW_DETECTORS = "H1,L1,V1"
GW_DURATION = 64.0
GW_FMIN, GW_FMAX = 25.0, 1024.0
GW_WAVEFORM = "IMRPhenomD_NRTidalv2"
GW_EPSILON = 0.1
GW_TRIGGER = 1187008882.4
GW_PRIOR_TEXT = """\
chirp_mass = Uniform(name='chirp_mass', minimum=1.18, maximum=1.21)
mass_ratio = Uniform(name='mass_ratio', minimum=0.6, maximum=1.0)
lambda_1 = Uniform(name='lambda_1', minimum=0, maximum=5000)
lambda_2 = Uniform(name='lambda_2', minimum=0, maximum=5000)
luminosity_distance = Uniform(name='luminosity_distance', minimum=10, maximum=100)
theta_jn = Sine(name='theta_jn')
phase = Uniform(name='phase', minimum=0, maximum=2 * np.pi, boundary='periodic')
psi = Uniform(name='psi', minimum=0, maximum=np.pi, boundary='periodic')
ra = Uniform(name='ra', minimum=0, maximum=2 * np.pi, boundary='periodic')
dec = Cosine(name='dec')
geocent_time = Uniform(name='geocent_time', minimum=-0.1, maximum=0.1)
"""
GW_INJECTION = {"mass_1": 1.48, "mass_2": 1.26, "lambda_1": 300.0,
                "lambda_2": 500.0, "luminosity_distance": 40.0,
                "theta_jn": 0.4, "phase": 1.3, "ra": 3.446, "dec": -0.408,
                "psi": 1.5, "geocent_time": 0.0}
# the IMRPhenomD BBH of tests/test_joint_cli_breadth.py:17-19, whose band
# reaches the intermediate amplitude and its 5x5 solve (Mf 0.014 at 44 Hz)
GW_BBH = {"mass_1": 36.0, "mass_2": 29.0, "chi_1": 0.0, "chi_2": 0.0,
          "luminosity_distance": 600.0, "theta_jn": 0.4, "phase": 1.0,
          "ra": 1.3, "dec": -0.5, "psi": 0.7, "geocent_time": 0.0}
# the waveforms card against CPU: amplitude relative where it exceeds 1e-6
# of its maximum (f32 libm ulps, ~1e-6); the complex strain as
# max|h_card - h_cpu| / max|h_cpu|, held by the f32 rounding of phases of
# ~1e4 rad at 25 Hz (an ulp is 1e-3 rad; the port against the JAX package
# reads <= 7e-3, tests/test_torch_gw_waveforms.py)
GW_AMP_RTOL = 1e-4
GW_STRAIN_TOL = 2e-2
# the logL gate on GW paths: 1e-2 + 1e-4 |logL| + GW_PHASE_ULP <d,d>.
# logL is a difference of inner products of size <d,d> = SNR^2, and the
# BNS phase at 25 Hz (~6e3 rad) carries f32 rounding that differs between
# libms; to first order logL moves by <d,d> times the phase difference
# (tests/test_torch_gw_likelihood.py)
GW_PHASE_ULP = 2.0**-10      # rad, an f32 ulp of a phase in [8192, 16384)
GW_SNR_RTOL = 2e-3           # logL(injection) against SNR^2/2, test_gw.py:28
GW_RB_ATOL = 1.0             # relative binning against dense, test_gw.py:44
# [gw_cli]'s sampler: a probe at nlive=1024, n_delete=128, walks=24 took
# 400 iterations (303 s, host-bound); a quarter of the live set a round
# halves the iterations, 16 walks a point cut each one by a third
GW_CLI_NLIVE, GW_CLI_NDELETE, GW_CLI_WALKS = 1024, 256, 16
GW_CLI_CAP = 600
# f32 operations that K3's function needs, an FMA counted as two and a sin,
# exp or log as one, from the steps of csrc/grb_eats.cu: per (live point,
# ring, phi, r) the arrival-time map, its log, the cummax and the cap at 60;
# per (live point, ring, phi, t) query the in-range test. A query out of
# range carries no flux and needs nothing more; one in range needs a search
# of the monotone log-time row (a compare and a select per step), the two
# hat nodes that can be nonzero (coefficients, hat and six sums each) and
# the Doppler/synchrotron epilogue, with its per-filter part and the phi sum
K3_OPS_MAP = 11
K3_OPS_RANGE = 2
K3_OPS_SEARCH_STEP = 2
K3_OPS_NODE = 24
K3_OPS_PAIR = 52
K3_OPS_PAIR_F = 9
# peaks of one H100 SXM at 700 W (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def ptxas_summary(report):
    """registers, stack frame and spill bytes of each kernel entry in
    nvcc's -Xptxas -v output, '/'-joined where a library has several."""
    regs = re.findall(r"Used (\d+) registers", report)
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", report)
    return {"registers": "/".join(regs),
            "stack_bytes": "/".join(f[0] for f in frames),
            "spill_store_bytes": "/".join(f[1] for f in frames),
            "spill_load_bytes": "/".join(f[2] for f in frames)}


def ptxas_entries(report):
    """{entry: registers/stack/spills} for each kernel entry of nvcc's
    -Xptxas -v output, the entry named by its template arguments (K1's
    ``svd_mlp_mags_kernel<P, R, LP>`` as ``P4_R6_LP32``)."""
    out = {}
    for chunk in report.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'(\S+)'", chunk).group(1)
        args = re.findall(r"Li(\d+)E", name)
        key = ("P{}_R{}_LP{}".format(*args) if len(args) == 3
               else name)
        out[key] = ptxas_summary(chunk)
    return out


def relative_error(torch, got, want):
    """Max |got - want| / |want| where |want| > 1e-6 max|want|."""
    scale = float(want.abs().max())
    return float(((got - want).abs() / torch.clamp(
        want.abs(), min=1e-6 * scale)).max())


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(torch, fn, rounds=25, launches=10, warmup=3):
    """Device time of one ``fn()``: CUDA events around ``launches``
    back-to-back calls, median over ``rounds`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def throughput(torch, fn, rounds=5, round_s=0.4, warmup=3):
    """Host-clock rate of back-to-back ``fn()`` calls after warm-up: each
    round calls ``fn`` at least once and until ``round_s`` has passed, then
    synchronizes.
    Returns (ms per call over all rounds, calls, [ms per call of each
    round])."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls, seconds, per_round = 0, 0.0, []
    for _ in range(rounds):
        n = 0
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < round_s:
            fn()
            n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls, seconds = calls + n, seconds + dt
        per_round.append(1e3 * dt / n)
    return 1e3 * seconds / calls, calls, per_round


# torch.profiler keeps only the device records inside the window it opened
# on the host's clock, and on its timeline the card's kernels sit up to ~3
# ms off the host's launch calls (scripts/torch_profiler_window.py); late
# in the process a short window without margins kept none of its launches:
# the host idles this long at both ends of every window.
PROFILE_MARGIN_S = 0.05
# A window with the margins has still kept none of 20 launches, for a cause
# not yet found: kernel_device_windows traces up to this many windows, and
# each reading is printed with the number it took.
PROFILE_WINDOWS = 3


def device_profile(torch, fn, kernel=None):
    """(device-busy ms, kernel launches, top kernels, device ms of the
    kernels whose name contains ``kernel``, their launches) of one ``fn()``
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    named = [e for e in dev if kernel and kernel in e.key]
    return busy_ms, sum(e.count for e in dev), ";".join(
        f"{e.key[:40]}:{e.self_device_time_total / 1e3:.4f}" for e in top), \
        sum(e.self_device_time_total for e in named) / 1e3, \
        sum(e.count for e in named)


def kernel_device_windows(torch, fn, kernel, calls=20, warmup=3):
    """(device ms of one launch of the kernels whose name contains
    ``kernel``, windows traced), from torch.profiler over ``calls`` calls
    of ``fn`` after warm-up: at the samplers' small batches the host
    launches slower than the card runs the kernel, so CUDA events would
    time the host's gaps. A window in which the tracer kept no launch is
    traced again, up to PROFILE_WINDOWS windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        named_ms, count = device_profile(
            torch, lambda: [fn() for _ in range(calls)], kernel)[3:]
        # the tracer may drop a record: average over the launches it kept
        if 0 < count <= calls:
            return named_ms / count, window
    raise RuntimeError(f"the profiler saw {count} launches of {kernel} in "
                       f"{calls} calls, in each of {PROFILE_WINDOWS} windows")


def kernel_device_ms(torch, fn, kernel, calls=20, warmup=3):
    """The ms of ``kernel_device_windows`` alone (scripts/compare_kernels.py
    reads it)."""
    return kernel_device_windows(torch, fn, kernel, calls, warmup)[0]


def synthetic_photometry(np, torch, model, filters, path, injection,
                         sample_times, epochs):
    """Injection light curve of one of the port's models on the grid
    ``geomspace(*sample_times)``: 10 epochs per filter drawn in ``epochs``
    (days) with seeded noise and a few upper limits, written as a .dat
    file in MJD."""
    from nmma_tpu_torch.io import write_em_observations
    from nmma_tpu_torch.models import DetectorLightCurveModel

    detector = DetectorLightCurveModel(
        model, filters, sample_times=np.geomspace(*sample_times),
        device=DEVICE)
    params = {k: torch.tensor([v], device=DEVICE)
              for k, v in injection.items()}
    t_obs, mags = detector(params)
    t_obs = t_obs[0].cpu().numpy().astype(np.float64)
    mags = mags[0].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(2017)
    data = {}
    for i, f in enumerate(filters):
        t = np.sort(rng.uniform(epochs[0], epochs[1], 10))
        m = np.interp(t, t_obs, mags[i]) + rng.normal(0.0, 0.1, t.size)
        err = np.full(t.size, 0.1)
        if i % 3 == 0:      # last epoch of every third filter: upper limit
            m[-1] -= 1.0
            err[-1] = np.inf
        if not np.all(np.isfinite(m)):
            raise RuntimeError(f"injection light curve not finite in {f}")
        data[f] = {"time": t + TRIGGER_MJD, "mag": m, "mag_error": err}
    write_em_observations(path, data, fmt="dat")
    return data


def injection_units(priors, injection):
    """The injection as a [1, ndim] point of the unit cube (Uniform
    priors)."""
    import torch

    return torch.tensor([[
        (injection[n] - priors[n].minimum)
        / (priors[n].maximum - priors[n].minimum)
        for n in priors.sampled_names]], device=DEVICE)


def me2017_path(np, torch, gen, sample_times):
    """Phases 6-8: K2 against its plain version, then the Me2017 main path
    through EMAnalysis.batched_logl and the sampler. Returns K2's entry of
    the kernel line."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.ops import me2017_kernel as k2

    # 6. K2 against its plain version at the main path's shapes
    def draw(b):   # the parameter ranges of tests/test_pallas_kernel.py
        u = torch.rand((4, b), generator=gen, device=DEVICE)
        return (-3.0 + 2.5 * u[0], -2.0 + 1.5 * u[1], 1.0 + 4.0 * u[2],
                10.0 ** (-1.0 + 3.0 * u[3]))

    worst = {"ltot_max_rel": 0.0, "r_max_rel_non_tie": 0.0}
    max_err = 0.0
    for b in (1, 128, BATCH + 7):
        ops = k2.me2017_operands(*draw(b), sample_times)
        ltot, r_photo = k2.me2017_dynamics_from_operands(*ops)
        want = k2.me2017_dynamics_plain(*ops, with_ties=True)
        torch.cuda.synchronize()
        stats = k2.compare_dynamics(ltot, r_photo, *want)
        if ltot.shape != want[0].shape or not stats["ok"]:
            raise RuntimeError(f"K2 disagrees at B={b}: {stats}")
        # the kernel rounds tau as the plain version does: same shell
        if not torch.equal(r_photo, want[1]):
            raise RuntimeError(f"K2's r_photo differs from the plain "
                               f"version's at B={b} in "
                               f"{int((r_photo != want[1]).sum())} points")
        if stats["ltot_max_rel"] > K2_LTOT_TOL:
            raise RuntimeError(f"K2's ltot is {stats['ltot_max_rel']} off "
                               f"the plain version's at B={b} (tolerance "
                               f"{K2_LTOT_TOL})")
        for key in worst:
            worst[key] = max(worst[key], stats[key])
        max_err = max(max_err, float((ltot - want[0]).abs().max()))
        say("k2", batch=b, **{k: v for k, v in stats.items() if k != "ok"},
            r_exact_share=f"{float((r_photo == want[1]).float().mean()):.6f}")
    n_t = sample_times.shape[0]

    def bound(ops, n_b):
        n_ops = (n_t - 1) * n_b * (K2_OPS_SHELL_STEP * k2.N_SHELLS
                                   + K2_OPS_STEP)
        n_bytes = 4.0 * sum(t.numel() for t in ops) + 4.0 * 2 * n_b * n_t
        return n_ops, n_bytes, 1e3 * max(n_ops / PEAK_F32_FLOPS,
                                         n_bytes / PEAK_BYTES), \
            "operations" if n_ops / PEAK_F32_FLOPS >= n_bytes / PEAK_BYTES \
            else "bytes"

    ops = k2.me2017_operands(*draw(SAMPLER_BATCH), sample_times)
    k2_ms_small, windows = kernel_device_windows(
        torch, lambda: k2.me2017_dynamics_from_operands(*ops),
        "me2017_dynamics_kernel")
    say("k2", batch=SAMPLER_BATCH, kernel_ms=f"{k2_ms_small:.4f}",
        timed_by="profiler", profiled_windows=windows,
        bound_ms=f"{bound(ops, SAMPLER_BATCH)[2]:.4f}")
    ops = k2.me2017_operands(*draw(BATCH), sample_times)
    k2_ms = time_ms(torch, lambda: k2.me2017_dynamics_from_operands(*ops))
    k2_plain_ms = time_ms(torch, lambda: k2.me2017_dynamics_plain(*ops))
    n_ops, n_bytes, k2_bound_ms, k2_bound_by = bound(ops, BATCH)
    say("k2", batch=BATCH, kernel_ms=f"{k2_ms:.4f}",
        plain_ms=f"{k2_plain_ms:.4f}", bound_ms=f"{k2_bound_ms:.4f}",
        bound_by=k2_bound_by, bound_share=f"{k2_bound_ms / k2_ms:.4f}",
        gops=f"{n_ops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}")

    # K2 on exact ties: shell s + stride takes tau of shell s, in two lanes
    # (stride 1) or two slots of one lane (stride 32); the first shell of a
    # pair must win, as in the plain version
    n_ties = 1024
    for stride in (1, 32):
        shells, per_sample, per_step = k2.me2017_operands(
            *draw(n_ties), sample_times)
        shells = k2.tied_operands(shells, stride)
        before = k2_launches()
        ltot, r_photo = k2.me2017_dynamics_from_operands(
            shells, per_sample, per_step)
        launched = k2_launches() - before
        ltot_ref, r_ref, gap, r_cand = k2.me2017_dynamics_plain(
            shells, per_sample, per_step, with_ties=True)
        torch.cuda.synchronize()
        tied = gap == 0
        decisive = tied & (r_cand[..., 0] != r_cand[..., 1])
        sel = ltot_ref > 1e-4
        ltot_rel = float(((ltot - ltot_ref).abs() / ltot_ref)[sel].max())
        mismatches = int((r_photo != r_ref).sum())
        say("k2_ties", stride=stride, batch=n_ties,
            exact_ties=int(tied.sum()), decisive_ties=int(decisive.sum()),
            r_mismatches=mismatches, ltot_max_rel=f"{ltot_rel:.3e}",
            launches=launched)
        if launched != 1 or mismatches or int(decisive.sum()) < 100 \
                or not ltot_rel <= K2_LTOT_TOL \
                or not bool(torch.isfinite(ltot).all()):
            raise RuntimeError(f"K2 fails on tied shells (stride {stride}): "
                               f"{launched} launches, {mismatches} r_photo "
                               f"mismatches, {int(decisive.sum())} decisive "
                               f"ties, ltot {ltot_rel} off")

    # 7. the Me2017 main path: photometry file -> batched_logl at B=8192
    filters = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
               "2massj", "2massh", "2massks"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_me2017_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "me2017.prior")
        with open(prior_path, "w") as f:
            f.write(ME_PRIOR_TEXT)
        synthetic_photometry(np, torch, "Me2017", filters, data_path,
                             ME_INJECTION, sample_times=(0.01, 14.0, 150),
                             epochs=(0.5, 12.0))
        cfg = EMAnalysisConfig(
            model="Me2017", prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, data_tmax=12.5, error_budget=1.0,
            filters=filters, outdir=os.path.join(tmp, "outdir"),
            label="chip_smoke_me2017",
            sampler=NestedSamplerConfig(nlive=1024, n_delete=128,
                                        max_iter=40, max_seconds=90.0))
        analysis = EMAnalysis(cfg, device=DEVICE)
        u = analysis.priors.sample_units(gen, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        reset_counts("k1", "k2", "k5")
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        logl_launches = k2_launches()
        if logl_launches != 1 or k1_launches() != 0 or k5_launches() != 1:
            raise RuntimeError(f"Me2017 batched_logl launched K2 "
                               f"{logl_launches} times, K5 {k5_launches()} "
                               f"times and K1 {k1_launches()} times, not "
                               "once, once and never")
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if logl.shape != (BATCH,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")
        logl_ms, logl_calls, round_ms = throughput(
            torch, lambda: analysis.batched_logl(u))
        for b, ms in ((BATCH, logl_ms), (128, throughput(
                torch, lambda: analysis.batched_logl(u[:128]))[0])):
            busy, n_launch, top, _, _ = device_profile(
                torch, lambda: analysis.batched_logl(u[:b]))
            say("me2017_profile", batch=b, wall_ms=f"{ms:.4f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / ms:.4f}",
                kernel_launches=n_launch, top=top)

        # the same batch with the plain K2 on the card, off the live points
        # where the plain version sees a near-tie
        kernel_fn = k2.me2017_dynamics_from_operands
        k2.me2017_dynamics_from_operands = k2.me2017_dynamics_plain
        try:
            logl_plain = analysis.batched_logl(u)
        finally:
            k2.me2017_dynamics_from_operands = kernel_fn
        p = analysis.priors.transform(u)
        gap = k2.me2017_dynamics_plain(*k2.me2017_operands(
            p["log10_mej"], p["log10_vej"], p["beta"],
            10.0 ** p["log10_kappa_r"], analysis.model.sample_times),
            with_ties=True)[2]
        keep = ~(gap < k2.NEAR_TIE).any(dim=1)
        if not torch.equal(usable[keep], (logl_plain > -1e29)[keep]):
            raise RuntimeError("sentinel positions differ from the plain K2")
        kept = usable & keep
        dlogl = (logl - logl_plain)[kept].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[kept].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"logL off the plain K2 by {float(dlogl.max())}")
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, ME_INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("me2017_logl", batch=BATCH, finite_share=f"{finite_share:.4f}",
            k2_launches=logl_launches, k5_launches=1,
            k1_launches=k1_launches(), calls=logl_calls,
            wall_ms=f"{logl_ms:.4f}",
            evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
            evals_per_s_rounds=",".join(
                f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
            peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
            tie_samples_dropped=int((~keep).sum()),
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")

        # 8. the nested sampler on the Me2017 path
        t0 = time.time()
        reset_counts("k1", "k2", "k5")
        with LoglParts() as logl_parts:
            result = analysis.run(verbose=False)
        torch.cuda.synchronize()
        launches = k2_launches()
        seconds = time.time() - t0
        if not math.isfinite(result.logz):
            raise RuntimeError(f"Me2017 logZ not finite: {result.logz}")
        expected = 1 + result.niter * cfg.sampler.walks
        if launches != expected or launches <= 0 \
                or k1_launches() != 0 or k5_launches() != launches \
                or k6_launches() != logl_parts.parts:
            raise RuntimeError(f"the Me2017 sampler launched K2 {launches} "
                               f"times (expected {expected}), K5 "
                               f"{k5_launches()} times, K6 {k6_launches()} "
                               f"times ({logl_parts.parts} parts) and K1 "
                               f"{k1_launches()} times")
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_bestfit_params.json"):
            if not os.path.exists(os.path.join(cfg.outdir,
                                               cfg.label + suffix)):
                raise RuntimeError(f"missing result file {suffix}")
        say("me2017_sampler", logz=f"{result.logz:.4f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            k2_launches=launches, k5_launches=k5_launches(),
            k6_launches=k6_launches(), logl_parts=logl_parts.parts,
            k1_launches=k1_launches())

    return {
        "name": "me2017_dynamics", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/me2017_dynamics.cu",
        "replaces": "nmma_tpu/ops/pallas_me2017.py:35",
        "launches": launches, "launches_batched_logl": logl_launches,
        "max_abs_err": max_err, **worst,
        "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
        "ms_sampler_batch": k2_ms_small,
        "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
    }


def k5_photospheres(ltot, r_photo):
    """Me2017's (ltot40, r_photo) [B, T] from K2 with the temperature
    fill's edge cases planted in rows 0-9 (a batch of fewer rows keeps the
    first ones): undefined temperatures at the head, in the middle and at
    the tail, by R = 0 (no radius either) or by L = 0 (a radius to fill
    over); a row with one valid sample and one with none; a negative L; a
    row whose two valid samples set a long extrapolation."""
    ltot, r_photo = ltot.clone(), r_photo.clone()
    n_b, n_t = ltot.shape
    cases = [(r_photo, 0, slice(0, 7)), (r_photo, 1, slice(60, 70)),
             (r_photo, 2, slice(n_t - 20, n_t)), (ltot, 5, slice(10, 15)),
             (ltot, 6, slice(0, 5)), (ltot, 7, slice(n_t - 30, n_t))]
    for t, row, cols in cases:
        if row < n_b:
            t[row, cols] = 0.0
    if n_b > 3:
        r_photo[3, :] = 0.0
        r_photo[3, 40] = 1e15
    if n_b > 4:
        r_photo[4, :] = 0.0
    if n_b > 8:
        ltot[8] = -ltot[8]
    if n_b > 9:
        keep = ltot[9, [50, 52]].clone()
        ltot[9, :] = 0.0
        ltot[9, [50, 52]] = keep
    return ltot, r_photo


def k5_compare(torch, got, want):
    """(max |dmag| over the entries finite on both sides, whether +inf,
    -inf and NaN sit in the same places)."""
    same = all(bool(torch.equal(f(got), f(want))) for f in
               (torch.isposinf, torch.isneginf, torch.isnan))
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[both].abs().max()) if bool(both.any()) \
        else 0.0
    return err, same


def k5_path(np, torch):
    """Phase 8a: K5 (csrc/bb_photometry.cu) against the plain photometry on
    the card at B = 8192, 256 and 61: Me2017's photospheres from K2 with
    the fill's edge cases through _me2017_photometry (the prologue) against
    _me2017_photometry_plain, and the Piro2021, blackbody_fixedT and
    HoNa2020 photospheres (1/T and R, no prologue) against the same models
    with blackbody_ab_mag_banded_plain; one K5 launch a call, max |dmag|
    over the finite entries <= K5_MAG_TOL and the same infinities. Then
    K5's device time at B = 8192 and 256, the plain chain's, the bound
    (counted as portbench/metrics/k5_roofline.py counts it) and the peak
    memory of each. Returns K5's entry of the kernel line."""
    from nmma_tpu_torch.models import DetectorLightCurveModel, kilonova
    from nmma_tpu_torch.models import shock_cooling
    from nmma_tpu_torch.ops import me2017_kernel as k2
    from nmma_tpu_torch.ops import photometry
    from nmma_tpu_torch.priors import parse_prior_dict
    from portbench.metrics import k5_roofline

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(K5_SEED)
    filters = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
               "2massj", "2massh", "2massks"]
    me = DetectorLightCurveModel("Me2017", filters, device=DEVICE)
    t_days = me.sample_times
    me_priors = parse_prior_dict(ME_PRIOR_TEXT)

    def me2017_inputs(b):
        p = me.prepare_parameters(me_priors.transform(
            me_priors.sample_units(gen, b)))
        ltot, r_photo = k2.me2017_dynamics(
            p["log10_mej"], p["log10_vej"], p["beta"],
            10.0 ** p["log10_kappa_r"], t_days)
        ltot, r_photo = k5_photospheres(ltot, r_photo)
        z = p["redshift"]
        return (ltot, r_photo, t_days, me.nu_0s[None] * (1.0 + z)[:, None],
                me.nu_nodes[None] * (1.0 + z)[:, None, None], me.nu_weights)

    class Plain:
        """blackbody_ab_mag_banded swapped for its plain version where a
        model module reads it."""
        modules = (kilonova, shock_cooling)

        def __enter__(self):
            self.kept = [m.blackbody_ab_mag_banded for m in self.modules]
            for m in self.modules:
                m.blackbody_ab_mag_banded = \
                    photometry.blackbody_ab_mag_banded_plain

        def __exit__(self, *exc):
            for m, fn in zip(self.modules, self.kept):
                m.blackbody_ab_mag_banded = fn

    def source_call(model, prior_text, grid, b):
        det = DetectorLightCurveModel(model, filters, device=DEVICE,
                                      sample_times=grid)
        priors = parse_prior_dict(prior_text)
        p = det.prepare_parameters(priors.transform(
            priors.sample_units(gen, b)))
        z = p["redshift"]
        args = (p, det.sample_times, det.nu_0s[None] * (1.0 + z)[:, None])
        kw = dict(nu_nodes=det.nu_nodes[None] * (1.0 + z)[:, None, None],
                  nu_weights=det.nu_weights)
        return lambda: det.source.mags_fn(*args, **kw)

    worst, failed = 0.0, []
    for b in K5_BATCHES:
        inputs = me2017_inputs(b)
        calls = {"Me2017": (lambda: kilonova._me2017_photometry(*inputs),
                            lambda: kilonova._me2017_photometry_plain(
                                *inputs))}
        for model, grid in (("Piro2021", np.geomspace(1.0 / 24.0, 3.5, 100)),
                            ("blackbody_fixedT", np.geomspace(0.01, 14.0,
                                                              150)),
                            ("HoNa2020", np.geomspace(0.05, 14.0, 150))):
            prior = EM_MODELS[model][0] if model in EM_MODELS \
                else KN_MODELS[model][0]
            fn = source_call(model, prior, grid, b)

            def plain(fn=fn):
                with Plain():
                    return fn()
            calls[model] = (fn, plain)
        for model, (fn, plain) in calls.items():
            reset_counts("k5")
            got = fn()
            launched = k5_launches()
            want = plain()
            torch.cuda.synchronize()
            err, same = k5_compare(torch, got, want)
            finite = float(torch.isfinite(want).float().mean())
            worst = max(worst, err)
            say("k5", model=model, batch=b, prologue=model == "Me2017",
                max_abs_dmag=f"{err:.3e}", inf_identical=same,
                finite_share=f"{finite:.4f}", launches=launched)
            if launched != 1 or not same or not err <= K5_MAG_TOL:
                failed.append(f"{model} B={b}: {launched} launches, "
                              f"{err} mag, infinities identical: {same}")

    # device time at B = 8192 and 256 (the profiler), the plain chain's
    # (CUDA events), the bound and the peak memory of one call of each
    readings = {}
    for b in (BATCH, 256):
        inputs = me2017_inputs(b)
        fn = lambda: kilonova._me2017_photometry(*inputs)  # noqa: E731
        plain = lambda: kilonova._me2017_photometry_plain(  # noqa: E731
            *inputs)
        dev_ms, windows = kernel_device_windows(torch, fn,
                                                "bb_photometry_kernel")
        plain_ms = time_ms(torch, plain, rounds=5, launches=2, warmup=1)
        peaks = []
        for call in (fn, plain):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = call()
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
            del out
        n_f, n_k = inputs[4].shape[1:]
        n_ops, n_bytes = k5_roofline.work(b, n_f, n_k, t_days.shape[0])
        bound_ms, bound_by = roofline_ms(n_ops, n_bytes)
        readings[b] = dict(dev_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           peaks=peaks)
        say("k5", batch=b, kernel_device_ms=f"{dev_ms:.4f}",
            timed_by="profiler", profiled_windows=windows,
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, share_of_bound=f"{bound_ms / dev_ms:.4f}",
            gops=f"{n_ops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}",
            peak_mib=f"{peaks[0]:.1f}", plain_peak_mib=f"{peaks[1]:.1f}")
    if failed:
        raise RuntimeError("K5 disagrees with the plain photometry:\n"
                           + "\n".join(failed))
    big = readings[BATCH]
    return {
        "name": "bb_photometry", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/bb_photometry.cu",
        "replaces": None, "max_abs_dmag": worst,
        "ms": big["dev_ms"], "ms_256": readings[256]["dev_ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "peak_mib": big["peaks"][0],
        "plain_peak_mib": big["peaks"][1], "library_ms": None,
    }


class LoglParts:
    """While open, counts the ``MAX_BATCH`` parts of the calls into
    ``EMLikelihood.log_likelihood`` on the card (K6 launches one a part)
    and resets K6's counter on entry."""

    def __enter__(self):
        import torch

        from nmma_tpu_torch.likelihood import em
        from nmma_tpu_torch.ops import em_likelihood_kernel as k6

        self.parts = 0
        self.kept = em.EMLikelihood.log_likelihood
        kept = self.kept

        def counted(lk, parameters):
            if lk.data.times.device.type == "cuda":
                rows = max(v.shape[0] for v in parameters.values()
                           if isinstance(v, torch.Tensor) and v.dim() > 0)
                self.parts += -(-rows // k6.MAX_BATCH)
            return kept(lk, parameters)

        em.EMLikelihood.log_likelihood = counted
        reset_counts("k6")
        return self

    def __exit__(self, *exc):
        from nmma_tpu_torch.likelihood import em
        em.EMLikelihood.log_likelihood = self.kept


def k6_data(np, torch, det, observed, injection, epochs, seed):
    """Photometry of ``det`` at ``injection`` for the ``observed`` filters
    (a composite one the mean of its helper rows), in days since the
    trigger: 10 epochs a filter in ``epochs`` with seeded 0.1 mag noise,
    the last epoch of every third filter an upper limit 1 mag brighter."""
    from nmma_tpu_torch.filters import resolve_filter

    params = {k: torch.tensor([v], device=DEVICE)
              for k, v in injection.items()}
    t_obs, mags = det(params)
    t_obs = t_obs[0].double().cpu().numpy()
    mags = mags[0].double().cpu().numpy()
    rng = np.random.default_rng(seed)
    data = {}
    for i, f in enumerate(observed):
        kind, payload = resolve_filter(f, available=det.source.filter_names)
        helpers = [payload] if kind == "direct" else list(payload)
        t = np.sort(rng.uniform(epochs[0], epochs[1], 10))
        m = np.mean([np.interp(t, t_obs, mags[det.filters.index(h)])
                     for h in helpers], axis=0)
        m = m + rng.normal(0.0, 0.1, t.size)
        err = np.full(t.size, 0.1)
        if i % 3 == 0:
            m[-1] -= 1.0
            err[-1] = np.inf
        if not np.all(np.isfinite(m)):
            raise RuntimeError(f"[k6] injection light curve not finite in {f}")
        data[f] = {"time": t, "mag": m, "mag_error": err}
    return data


def k6_cases(np, torch):
    """[k6]'s likelihoods on the card, by name: (EMLikelihood, PriorDict).
    Me2017 on the nine filters of its cells (Pei SMC at the host, a
    sampled E(B-V)); Me2017 with a composite filter (F606W, the mean of g
    and r), the CCM89 foreground, a finite detection limit and time-node
    systematics; TrPi2018 at full resolution on its five filters; the
    Bu2019lm surrogate (a row selection, with V's own row untrained and
    its helpers appended) with a detection limit."""
    from nmma_tpu_torch.likelihood import (EMLikelihood, PhotometryData,
                                           SystematicsModel)
    from nmma_tpu_torch.models import (DetectorLightCurveModel,
                                       SVDModelData, make_svd_source_model)
    from nmma_tpu_torch.priors import PriorDict, parse_prior_dict

    make_svd_source_model("Bu2019lm_k6", SVDModelData.load(ARTIFACT,
                                                           device=DEVICE))
    me_filters = ["sdssu", "ztfg", "ztfr", "ztfi", "ps1::z", "ps1::y",
                  "2massj", "2massh", "2massks"]
    specs = {
        "Me2017": ("Me2017", me_filters, "P92_SMC_host", None, None,
                   ME_PRIOR_TEXT + K6_EBV_PRIOR, ME_INJECTION,
                   (0.01, 14.0, 150), (0.5, 12.0), {}),
        "Me2017_mw": ("Me2017", ["F606W", "ztfi", "2massks"], "G23_MW",
                      {"ztfi": 19.5}, K6_SYSTEMATICS,
                      ME_PRIOR_TEXT + K6_EBV_PRIOR, ME_INJECTION,
                      (0.01, 14.0, 150), (0.5, 12.0), {}),
        "TrPi2018": ("TrPi2018", GRB_FILTERS, "P92_SMC_host", None, None,
                     GRB_PRIOR_TEXT, GRB_INJECTION, (0.05, 40.0, 64),
                     (0.1, 30.0), {}),
        "Bu2019lm": ("Bu2019lm_k6", ["ztfg", "V", "ztfi", "ps1::z"],
                     "P92_SMC_host", {"ps1::z": 20.5}, None,
                     PRIOR_TEXT + K6_EBV_PRIOR, INJECTION,
                     (0.01, 14.0, 150), (0.5, 12.0), {}),
    }
    cases = {}
    for i, (name, (model, observed, law, limit, sys_spec, prior, injection,
                   grid, epochs, kw)) in enumerate(specs.items()):
        det = DetectorLightCurveModel(model, observed,
                                      sample_times=np.geomspace(*grid),
                                      extinction_law=law, model_kwargs=kw,
                                      device=DEVICE)
        data = k6_data(np, torch, det, observed, injection, epochs, 60 + i)
        photo, filters = PhotometryData.from_dict(data, observed,
                                                  device=DEVICE)
        systematics = SystematicsModel(filters, sys_spec, 1.0,
                                       model_time_range=grid[:2])
        priors = parse_prior_dict(prior)
        priors = PriorDict({**priors.priors, **systematics.create_priors()})
        systematics.finalize(list(priors.keys()))
        cases[name] = (EMLikelihood(det, photo, filters, systematics,
                                    detection_limit=limit), priors)
    return cases


def k6_plant(frame):
    """The frame with the detector's edge cases planted in rows 0-5 of the
    source's magnitudes (a batch of fewer rows keeps the first ones): a
    source row with one finite sample left (its bands all inf), a head of
    inf (early epochs outside the row's finite span), a gap inside the
    span (read as 0 there), a NaN, an inf tail, and every row inf."""
    mags = frame.mags.clone()
    n_b, _, n_t = mags.shape
    cases = [(0, 0, slice(0, n_t - 1), math.inf),
             (1, 1, slice(0, (3 * n_t) // 5), math.inf),
             (2, 0, slice(n_t // 3, n_t // 3 + 5), math.inf),
             (3, 1, slice(n_t // 2, n_t // 2 + 1), math.nan),
             (4, 0, slice(n_t - n_t // 4, n_t), math.inf),
             (5, slice(None), slice(None), math.inf)]
    for row, f, cols, value in cases:
        if row < n_b:
            mags[row, f, cols] = value
    return frame._replace(mags=mags)


def k6_compare(torch, got, want):
    """(max |dlogL| / max(1, |logL|) over the rows finite on both sides,
    whether the -1e30 rows and any NaN sit in the same places)."""
    same = bool(torch.equal(got <= -1e29, want <= -1e29)) and \
        bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    both = (got > -1e29) & (want > -1e29)
    err = float(((got - want).abs() / want.abs().clamp(min=1.0))[both].max()) \
        if bool(both.any()) else 0.0
    return err, same


def k6_path(np, torch):
    """Phase 8b: K6 (csrc/em_likelihood.cu) against the plain likelihood
    (EMLikelihood.log_likelihood_plain) on the card, on k6_cases' four
    likelihoods at B = 8192, 256, 61 and 8253 (two parts): one K6 launch
    a part, max |dlogL| / max(1, |logL|) over the finite rows <=
    K6_LOGL_TOL and the same -1e30 rows. Both sides read one frame (the
    parameters and the source's magnitudes) computed once, with k6_plant's
    edge cases in its first rows. Then, on the
    Me2017 case at B = 8192 and 256, K6's device time, the plain chain's
    after the frame (sigma_sys included, as on K6's side), the bound
    (counted as portbench/metrics/k6_roofline.py counts it) and the peak
    memory of each. Returns K6's entry of the kernel line."""
    from nmma_tpu_torch.ops import em_likelihood_kernel as k6
    from portbench.metrics import k6_roofline

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(K6_SEED)
    cases = k6_cases(np, torch)
    worst, failed, readings = 0.0, [], {}
    for name, (lk, priors) in cases.items():
        for b in K6_BATCHES:
            p = priors.transform(priors.sample_units(gen, b))
            frame = k6_plant(lk.model.frame(p))
            lk.model.frame = lambda params, frame=frame: frame
            try:
                reset_counts("k6")
                got = lk.log_likelihood(p)
                launched = k6_launches()
                want = lk.log_likelihood_plain(p)
                torch.cuda.synchronize()
                err, same = k6_compare(torch, got, want)
                finite = float((want > -1e29).float().mean())
                parts = -(-b // k6.MAX_BATCH)
                worst = max(worst, err)
                say("k6", case=name, batch=b, law=lk.model.extinction_law,
                    max_rel_dlogl=f"{err:.3e}", sentinels_identical=same,
                    finite_share=f"{finite:.4f}", launches=launched)
                if launched != parts or not same or not err <= K6_LOGL_TOL \
                        or finite == 0.0:
                    failed.append(f"{name} B={b}: {launched} launches for "
                                  f"{parts} parts, {err} relative, "
                                  f"sentinels identical: {same}, finite "
                                  f"share {finite}")
                if name == "Me2017" and b in (BATCH, 256):
                    ops = lk.k6_operands(p)
                    dev_ms, windows = kernel_device_windows(
                        torch, lambda: k6.em_log_likelihood(**ops),
                        "em_likelihood_kernel")
                    plain_ms = time_ms(torch,
                                       lambda: lk.log_likelihood_plain(p),
                                       rounds=5, launches=2, warmup=1)
                    peaks = []
                    for call in (lk.log_likelihood, lk.log_likelihood_plain):
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                        out = call(p)
                        torch.cuda.synchronize()
                        peaks.append((torch.cuda.max_memory_allocated()
                                      - base) / 2**20)
                        del out
                    n_f, n_pad = lk.data.valid.shape
                    n_ops, n_bytes = k6_roofline.work(
                        b, n_f, lk.model.sample_times.shape[0], n_pad,
                        int(lk.data.valid.sum()))
                    bound_ms, bound_by = roofline_ms(n_ops, n_bytes)
                    readings[b] = dict(dev_ms=dev_ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       peaks=peaks)
                    say("k6", batch=b, kernel_device_ms=f"{dev_ms:.4f}",
                        timed_by="profiler", profiled_windows=windows,
                        plain_ms=f"{plain_ms:.4f}",
                        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                        share_of_bound=f"{bound_ms / dev_ms:.4f}",
                        gops=f"{n_ops / 1e9:.3f}",
                        mbytes=f"{n_bytes / 1e6:.3f}",
                        peak_mib=f"{peaks[0]:.1f}",
                        plain_peak_mib=f"{peaks[1]:.1f}")
            finally:
                del lk.model.frame
    if failed:
        raise RuntimeError("K6 disagrees with the plain likelihood:\n"
                           + "\n".join(failed))
    big = readings[BATCH]
    return {
        "name": "em_likelihood", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/em_likelihood.cu",
        "replaces": None, "max_rel_dlogl": worst,
        "ms": big["dev_ms"], "ms_256": readings[256]["dev_ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "peak_mib": big["peaks"][0],
        "plain_peak_mib": big["peaks"][1], "library_ms": None,
    }


def k3_queries_in_range(torch, ops, rows=256):
    """K3's (row, ring, phi, t) queries whose log_q lies in
    [log_t[0], log_t[-1]], the ones that carry flux, counted on the card
    in chunks of `rows` rows."""
    from nmma_tpu_torch.constants import c_cgs
    from nmma_tpu_torch.ops.grb_kernel import one_minus_mu

    t_delay, tracks, r_grid, scal, log_q, cphi = ops[:6]
    count = 0
    for s in range(0, t_delay.shape[0], rows):
        # shared queries [T], or one a row [B, 1] (the energy ramp)
        lq = log_q if log_q.dim() == 1 else log_q[s:s + rows, None, None]
        sc = scal[s:s + rows, :, None, None, None]           # [b, 8, 1, 1, 1]
        th_r = torch.exp(tracks[s:s + rows, 4])[:, :, None, :]
        t_obs = (1.0 + sc[:, 0]) * (
            t_delay[s:s + rows, :, None, :]
            + one_minus_mu(sc[:, 4], sc[:, 2], th_r, cphi[:, None])
            * r_grid[s:s + rows, None, None, :] / c_cgs)     # [b, Th, Ph, R]
        log_t = torch.log(torch.clamp(t_obs, min=1e-10))
        lo = torch.clamp(log_t[..., :1], max=60.0)
        hi = torch.clamp(log_t.amax(-1, keepdim=True), max=60.0)
        count += int(((lq >= lo) & (lq <= hi)).sum())
    return count


def k3_work(torch, ops):
    """(f32 operations, bytes, queries in range, queries) that K3's function
    needs on these operands: the map of every (row, ring, phi, r), the
    in-range test of every query, and for a query in range the search, the
    two hat nodes and the epilogue; each operand read and the output written
    once."""
    n_b, n_th, n_r = ops[0].shape
    n_t, n_phi, n_f = ops[4].shape[-1], ops[5].shape[0], ops[7].shape[1]
    queries = n_b * n_th * n_phi * n_t
    in_range = k3_queries_in_range(torch, ops)
    n_ops = (n_b * n_th * n_phi * n_r * K3_OPS_MAP + queries * K3_OPS_RANGE
             + in_range * (K3_OPS_SEARCH_STEP * math.ceil(math.log2(n_r))
                           + 2 * K3_OPS_NODE + K3_OPS_PAIR
                           + K3_OPS_PAIR_F * n_f))
    n_bytes = 4.0 * (sum(t.numel() for t in ops) + n_b * n_th * n_f * n_t)
    return n_ops, n_bytes, in_range, queries


def roofline_ms(n_ops, n_bytes):
    """(ms, "operations" or "bytes"): the larger of the operations at the
    f32 peak and the bytes at the memory rate."""
    ops_s, bytes_s = n_ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s >= bytes_s else "bytes"


def k4_errors(torch, got, want):
    """{name: error} of K4's stage 1 (``got``) against the plain one
    (``want``), both ``grb_stage1``'s (operands, d_cos, inv_dl26):
    ``exact_mismatches``, the values of the operands without a sum that
    are not bit for bit equal; ``t_delay`` relative (where |ref| > 1e-6
    max|ref|) over the nodes with gamma - 1 >= 1e-2 (``head``), and over the
    rest (``t_delay_tail``, not bounded); the tracks' largest absolute
    error over the head (``tracks_head``) and over the tail as a share of
    its bound (``tracks_tail_share``); ``over``, the share of t_delay's head
    values and of all track values outside their bounds; the share of all
    track values within 1e-5 relative (``tracks_rel_1e-5``) and of tail
    nodes (``tail_nodes``). A non-finite value where the other side is
    finite reads inf."""
    names = ("t_delay", "log_tracks", "r_grid", "scal", "log_q", "cphi",
             "wphi", "nu_obs", "d_cos", "inv_dl26")
    pairs = dict(zip(names, zip(tuple(got[0]) + tuple(got[1:]),
                                tuple(want[0]) + tuple(want[1:]))))
    for name, (g, w) in pairs.items():
        if g.shape != w.shape:
            raise RuntimeError(f"K4's {name} has shape {tuple(g.shape)}, the "
                               f"plain stage 1's {tuple(w.shape)}")
    errs = {"exact_mismatches": float(sum(
        int((g != w).sum()) - int((g.isnan() & w.isnan()).sum())
        for name, (g, w) in pairs.items()
        if name not in ("t_delay", "log_tracks")))}
    td_g, td_w = pairs["t_delay"]
    g, w = pairs["log_tracks"]
    if not bool(torch.equal(torch.isfinite(td_g), torch.isfinite(td_w))) \
            or not bool(torch.isfinite(g).all()):
        errs.update(t_delay=math.inf, tracks_head=math.inf, over=1.0)
        return errs
    gm1 = torch.expm1(w[:, 0])                            # [B, Th, R']
    head = gm1 >= 1e-2
    scale = float(td_w.abs().max())
    rel = (td_g - td_w).abs() / torch.clamp(td_w.abs(), min=1e-6 * scale)
    errs["t_delay"] = float(rel[head].max()) if bool(head.any()) else 0.0
    errs["t_delay_tail"] = float(rel[~head].max()) \
        if bool((~head).any()) else 0.0
    diff = (g - w).abs()                                  # [B, 5, Th, R']
    head5 = head[:, None].expand_as(diff)
    bound = torch.where(head5, K4_TRACK_TOL, K4_TRACK_TOL
                        + K4_TAIL_ULPS * 2.0**-24 / gm1[:, None])
    errs["tracks_head"] = float(diff[head5].max()) \
        if bool(head.any()) else 0.0
    errs["tracks_tail_share"] = float((diff / bound)[~head5].max()) \
        if bool((~head).any()) else 0.0
    errs["over"] = (int((rel[head] > K4_TDELAY_TOL).sum())
                    + int((diff > bound).sum())) / (int(head.sum())
                                                    + diff.numel())
    errs["tracks_rel_1e-5"] = float((diff <= 1e-5 * w.abs()).float().mean())
    errs["tail_nodes"] = float((~head).float().mean())
    return errs


def k4_failures(errs, injection=False):
    """The bounds a ``k4_errors`` reading breaks, as text: every value in
    its bound, or with an energy injection all but K4_ONSET_SHARE."""
    bounds = {"exact_mismatches": 0.0, "over": K4_ONSET_SHARE if injection
              else 0.0, "flux": K4_FLUX_TOL}
    return [f"{k}={errs[k]:.3e} (bound {v:.0e})"
            for k, v in bounds.items() if k in errs and not errs[k] <= v]


def k4_worst(worst, errs, injection):
    """Fold a ``k4_errors`` reading into ``worst`` (the injection cases'
    head tracks apart)."""
    for name, v in errs.items():
        if name == "tracks_head" and injection:
            name = "tracks_head_injection"
        if name == "tracks_rel_1e-5":
            worst[name] = min(worst.get(name, 1.0), v)
        else:
            worst[name] = max(worst.get(name, 0.0), v)


def k4_switch_params(torch, p, jet, inj, gen):
    """``p`` with the power law's b and an energy injection in one of its
    forms ("none", "log10_L0", "L0" a column with zeros, "L0_const")."""
    n_b = p["thetaCore"].shape[0]
    dev = p["thetaCore"].device
    p = dict(p)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n_b, generator=gen, device=dev)

    if jet == 4:
        p["b"] = uniform(*K4_B_RANGE)
    if inj != "none":
        q = torch.tensor(K4_Q_VALUES, device=dev)
        p["q"] = q[torch.arange(n_b, device=dev) % len(K4_Q_VALUES)]
        p["ts"] = uniform(*K4_TS_RANGE)
    if inj == "log10_L0":
        p["log10_L0"] = uniform(*K4_LOG10_L0_RANGE)
    elif inj == "L0":
        l0 = 10.0 ** uniform(*K4_LOG10_L0_COLUMN_RANGE)
        p["L0"] = torch.where(torch.arange(n_b, device=dev) % 7 == 0, 0.0, l0)
    elif inj == "L0_const":
        p["L0"] = 3e46
    return p


def k4_work(n_b, n_th, n_r):
    """(f32 operations, bytes) of stage 1 at (B, Th, R), as
    portbench/counts/trpi2018.py counts it: STAGE1_OPS per (row, ring,
    radius), STAGE1_SUB_OPS per (row, ring, subgrid radius); the operands
    written once (t_delay and five tracks per (row, ring, subgrid radius),
    r_grid, d_cos, scal and inv_dl26) and the 15 parameters of a row read
    once."""
    from portbench.counts.trpi2018 import STAGE1_OPS, STAGE1_SUB_OPS

    n_sub = (n_r + 1) // 2 if n_r >= 256 else n_r
    n_ops = n_b * n_th * (n_r * STAGE1_OPS + n_sub * STAGE1_SUB_OPS)
    n_bytes = 4.0 * n_b * (6 * n_th * n_sub + n_sub + n_th + 8 + 1 + 15)
    return n_ops, n_bytes


def k4_path(np, torch, analysis, t_grid):
    """Phase 9a: K4 against the plain stage 1 on the card, over the jet
    types, spread and trumpet on and off, no injection and each form of
    one, R = 256 and 128, shared and per-row times (B = 257 config-3 prior
    draws each); at PERF.md §7's fault point inside a B = 8192 batch; then
    K4's device time at B = 8192 and 64, the plain stage 1's, the bound and
    the peak memory of each. Returns K4's entry of the kernel line."""
    from nmma_tpu_torch.models import grb
    from nmma_tpu_torch.ops import grb_kernel as k3

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(K4_SEED)

    def draw(b, u=None):
        u = analysis.priors.sample_units(gen, b) if u is None else u
        p = analysis.model.prepare_parameters(analysis.priors.transform(u))
        p.setdefault("d_L", 3.086e19)
        return p, analysis.model.nu_0s[None].expand(b, -1)

    worst, failed = {}, []
    n_b = 257
    injections = ("none", "log10_L0", "L0", "L0_const")
    k = 0
    for jet in (grb.JET_GAUSSIAN, grb.JET_TOPHAT, grb.JET_POWERLAW):
        for spread, trumpet in ((True, True), (True, False), (False, False)):
            for with_inj in (False, True):
                for n_r in (256, 128):
                    for per_row in (False, True):
                        k += 1
                        inj = injections[k % 3 + 1] if with_inj else "none"
                        p, nu = draw(n_b)
                        p = k4_switch_params(torch, p, jet, inj, gen)
                        if k % 2:      # the distance as luminosity_distance
                            del p["d_L"]
                        t = t_grid[torch.arange(n_b, device=DEVICE)
                                   % t_grid.shape[0]][:, None] \
                            if per_row else t_grid
                        kw = dict(jet_type=jet, n_r=n_r, spread=spread,
                                  trumpet=trumpet)
                        reset_counts("k4")
                        got = grb.grb_stage1(t, nu, p, **kw)
                        launched = k4_launches()
                        want = grb.grb_stage1_plain(t, nu, p, **kw)
                        errs = k4_errors(torch, got, want)
                        # K3 on both: the flux the operands give
                        flux = [k3.eats_flux(*o[0]) for o in (got, want)]
                        errs["flux"] = relative_error(torch, *flux)
                        bad = k4_failures(errs, injection=with_inj)
                        if launched != 1:
                            bad.append(f"{launched} K4 launches")
                        case = (f"jet{jet}_spread{int(spread)}_trumpet"
                                f"{int(trumpet)}_{inj}_R{n_r}_"
                                f"{'rowtime' if per_row else 'shared'}")
                        k4_worst(worst, errs, with_inj)
                        say("k4", case=case, batch=n_b, ok=not bad,
                            **{name: f"{v:.3e}" for name, v in errs.items()})
                        if bad:
                            failed.append(f"{case}: {', '.join(bad)}")

    # the fault point inside a B = 8192 batch: K4 against the plain stage 1
    # and the logL each gives
    u = analysis.priors.sample_units(gen, BATCH)
    u[0] = torch.tensor(K4_FAULT_U, device=DEVICE)
    p, nu = draw(BATCH, u)
    got = grb.grb_stage1(t_grid, nu, p)
    want = grb.grb_stage1_plain(t_grid, nu, p)
    errs = k4_errors(torch, got, want)
    k4_worst(worst, errs, False)

    def first_row(out):
        """Row 0 of grb_stage1's results (log_q and the phi nodes are
        shared)."""
        ops, d_cos, inv_dl26 = out
        return (tuple(o if i in (4, 5, 6) else o[:1]
                      for i, o in enumerate(ops)), d_cos[:1], inv_dl26[:1])

    row0 = k4_errors(torch, first_row(got), first_row(want))
    equal = all(bool(torch.equal(a, b)) for a, b in zip(
        *(tuple(r[0]) + r[1:] for r in (first_row(got), first_row(want)))))
    del got, want
    logl = analysis.batched_logl(u)
    stage1 = grb.grb_stage1
    grb.grb_stage1 = grb.grb_stage1_plain
    try:
        logl_plain = analysis.batched_logl(u)
    finally:
        grb.grb_stage1 = stage1
    usable = (logl > -1e29) & (logl_plain > -1e29)
    dlogl = (logl - logl_plain)[usable].abs()
    bad = k4_failures(errs)
    if bool((dlogl > LOGL_ATOL + LOGL_RTOL
             * logl_plain[usable].abs()).any()):
        bad.append(f"logL off the plain stage 1 by {float(dlogl.max())}")
    if not torch.equal(logl > -1e29, logl_plain > -1e29):
        bad.append("sentinels differ from the plain stage 1")
    if bad:
        failed.append(f"fault batch: {', '.join(bad)}")
    say("k4_fault", batch=BATCH, u=",".join(map(str, K4_FAULT_U)),
        row_bit_equal=equal, logl_k4=f"{float(logl[0]):.4f}",
        logl_plain=f"{float(logl_plain[0]):.4f}",
        max_abs_dlogl=f"{float(dlogl.max()):.3e}",
        **{f"row_{name}": f"{v:.3e}" for name, v in row0.items()},
        **{f"batch_{name}": f"{v:.3e}" for name, v in errs.items()})

    # device time at B = 8192 (CUDA events) and 64 (the profiler: the host
    # launches slower than the card runs there), the plain version's, the
    # bound, and the peak memory of one call of each
    p, nu = draw(BATCH)
    k4_ms = time_ms(torch, lambda: grb.grb_stage1(t_grid, nu, p), rounds=5,
                    launches=5, warmup=2)
    k4_dev_ms = kernel_device_ms(torch, lambda: grb.grb_stage1(t_grid, nu, p),
                                 "grb_dynamics", calls=5, warmup=1)
    p64, nu64 = draw(SAMPLER_BATCH // 2)
    k4_ms_64, windows = kernel_device_windows(
        torch, lambda: grb.grb_stage1(t_grid, nu64, p64), "grb_dynamics")
    plain_ms = time_ms(torch, lambda: grb.grb_stage1_plain(t_grid, nu, p),
                       rounds=1, launches=1, warmup=1)
    peaks = []
    for fn in (grb.grb_stage1, grb.grb_stage1_plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(t_grid, nu, p)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
        del out
    ops = grb.grb_stage1(t_grid, nu, p)[0]
    n_ops, n_bytes = k4_work(BATCH, ops[0].shape[1], grb.N_R)
    bound_ms, bound_by = roofline_ms(n_ops, n_bytes)
    n_ops64, n_bytes64 = k4_work(SAMPLER_BATCH // 2, ops[0].shape[1],
                                 grb.N_R)
    bound_ms_64 = roofline_ms(n_ops64, n_bytes64)[0]
    del ops
    say("k4", batch=BATCH, kernel_ms=f"{k4_ms:.4f}",
        kernel_device_ms=f"{k4_dev_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / k4_dev_ms:.4f}",
        gops=f"{n_ops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}",
        peak_mib=f"{peaks[0]:.1f}", plain_peak_mib=f"{peaks[1]:.1f}")
    say("k4", batch=SAMPLER_BATCH // 2, kernel_device_ms=f"{k4_ms_64:.4f}",
        timed_by="profiler", profiled_windows=windows,
        bound_ms=f"{bound_ms_64:.4f}")
    say("k4", worst=",".join(f"{k}:{v:.3e}" for k, v in worst.items()),
        cases=k)
    if failed:
        raise RuntimeError("K4 disagrees with the plain stage 1:\n"
                           + "\n".join(failed))
    return {
        "name": "grb_dynamics", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/grb_dynamics.cu",
        "replaces": None, "max_rel_err_t_delay": worst["t_delay"],
        "max_abs_err_tracks_head": worst["tracks_head"],
        "max_abs_err_tracks_head_injection": worst["tracks_head_injection"],
        "max_rel_err_flux": worst["flux"],
        "ms": k4_dev_ms, "kernel_ms": k4_ms, "ms_64": k4_ms_64,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "peak_mib": peaks[0], "plain_peak_mib": peaks[1], "library_ms": None,
    }


def grb_path(np, torch, gen):
    """Phases 9-11: K3 against its plain version, then the TrPi2018 main
    path (BASELINE config 3) through EMAnalysis.batched_logl and the
    sampler. Returns K3's and K4's entries of the kernel line."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.models import grb
    from nmma_tpu_torch.ops import grb_kernel as k3

    def reset():
        reset_launches()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grb_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "trpi2018.prior")
        with open(prior_path, "w") as f:
            f.write(GRB_PRIOR_TEXT)
        synthetic_photometry(np, torch, "TrPi2018", GRB_FILTERS, data_path,
                             GRB_INJECTION, sample_times=(0.05, 40.0, 64),
                             epochs=(0.1, 30.0))
        cfg = EMAnalysisConfig(
            model="TrPi2018", prior_file=prior_path,
            light_curve_data=data_path, trigger_time=TRIGGER_MJD, tmin=0.05,
            tmax=40.0, n_tsteps=64, error_budget=0.5, filters=GRB_FILTERS,
            outdir=os.path.join(tmp, "outdir"), label="chip_smoke_grb",
            sampler=NestedSamplerConfig(nlive=512, n_delete=64, walks=16,
                                        max_iter=40, max_seconds=90.0))
        analysis = EMAnalysis(cfg, device=DEVICE)
        t_grid = grb.trpi2018_time_grid(analysis.model.sample_times)
        k4_entry = k4_path(np, torch, analysis, t_grid)

        def operands(b):
            """K3's operands for b config-3 prior draws at full width."""
            p = analysis.model.prepare_parameters(analysis.priors.transform(
                analysis.priors.sample_units(gen, b)))
            p.setdefault("d_L", 3.086e19)
            nu_obs = analysis.model.nu_0s[None].expand(b, -1)
            return grb.grb_stage1(t_grid, nu_obs, p)[0]

        # 9. K3 against its plain version at the main path's shapes
        max_rel = max_abs = 0.0
        for b in (1, 64, 257):
            ops = operands(b)
            got = k3.eats_flux(*ops)
            want = k3.eats_flux_plain(*ops)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            rel = relative_error(torch, got, want)
            if got.shape != want.shape or not math.isfinite(rel) \
                    or rel > K3_TOL or not torch.isfinite(got).all():
                raise RuntimeError(f"K3 disagrees at B={b}: max relative "
                                   f"error {rel} (tolerance {K3_TOL})")
            max_rel = max(max_rel, rel)
            max_abs = max(max_abs, float((got - want).abs().max()))
            say("k3", batch=b, shape="x".join(map(str, got.shape)),
                max_rel_err=f"{rel:.3e}", max_abs_err=f"{max_abs:.3e}",
                ref_max=f"{scale:.4e}")
        # a shape the kernel is not built for is refused before a launch
        launched = k3_launches()
        wide = [o.repeat_interleave(3, dim=-1).contiguous() if i < 3 else o
                for i, o in enumerate(ops)]
        refused = False
        try:
            k3.eats_flux(*wide)
        except ValueError:
            refused = True
        if not refused or k3_launches() != launched:
            raise RuntimeError(f"K3 took R={wide[0].shape[-1]}, beyond the "
                               "shapes it is built for")
        ops = operands(BATCH)
        k3_ms = time_ms(torch, lambda: k3.eats_flux(*ops), rounds=5,
                        launches=2, warmup=1)
        k3_plain_ms = time_ms(torch, lambda: k3.eats_flux_plain(*ops),
                              rounds=1, launches=1, warmup=1)
        # the same rows with every query above the cap of 60: each query
        # skips the search, the hat nodes and the epilogue, so this is the
        # time of the map, its cummax and the phi sum
        above = ops[:4] + (ops[4] + 100.0,) + ops[5:]
        k3_map_ms = time_ms(torch, lambda: k3.eats_flux(*above), rounds=5,
                            launches=2, warmup=1)
        del above
        n_ops, n_bytes, in_range, queries = k3_work(torch, ops)
        k3_bound_ms, k3_bound_by = roofline_ms(n_ops, n_bytes)
        n_b, n_th, n_r = ops[0].shape
        n_t, n_phi, n_f = ops[4].shape[0], ops[5].shape[0], ops[7].shape[1]
        say("k3", batch=BATCH, kernel_ms=f"{k3_ms:.4f}",
            no_query_in_range_ms=f"{k3_map_ms:.4f}",
            plain_ms=f"{k3_plain_ms:.4f}", bound_ms=f"{k3_bound_ms:.4f}",
            bound_by=k3_bound_by, gops=f"{n_ops / 1e9:.3f}",
            mbytes=f"{n_bytes / 1e6:.3f}",
            queries_in_range=f"{in_range}/{queries}",
            share_of_bound=f"{k3_bound_ms / k3_ms:.4f}",
            shape=f"B{n_b}xTh{n_th}xPh{n_phi}xT{n_t}xR{n_r}xF{n_f}")
        del ops

        # K3 on hand-made rows: cummax plateaus, a query on a node, on a
        # plateau value, at log_t[0] and log_t[-1], and outside the rows
        for n_r in (100, 128, 256):
            for n_phi in (5, 16):
                ops = k3.edge_operands(8, 8, n_r, 37, n_phi, len(GRB_FILTERS),
                                       seed=n_r + n_phi, device=DEVICE)
                launched = k3_launches()
                got = k3.eats_flux(*ops)
                want = k3.eats_flux_plain(*ops)
                torch.cuda.synchronize()
                rel = relative_error(torch, got, want)
                zeros = want == 0
                if k3_launches() != launched + 1 or not math.isfinite(rel) \
                        or rel > K3_TOL or not torch.isfinite(got).all() \
                        or not torch.equal(got == 0, zeros):
                    raise RuntimeError(
                        f"K3 disagrees on hand-made rows at R={n_r}, "
                        f"Ph={n_phi}: max relative error {rel} (tolerance "
                        f"{K3_TOL}), zeros {int((got == 0).sum())} against "
                        f"{int(zeros.sum())}, {k3_launches() - launched} "
                        "launches")
                say("k3_edges", R=n_r, Ph=n_phi, T=37,
                    shape="x".join(map(str, got.shape)),
                    max_rel_err=f"{rel:.3e}",
                    zeros=f"{int(zeros.sum())}/{zeros.numel()}")

        # 10. the TrPi2018 main path: photometry file -> batched_logl
        u = analysis.priors.sample_units(gen, BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        reset()
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        logl_launches, logl_k4 = k3_launches(), k4_launches()
        if logl_launches != 1 or logl_k4 != 1 or k1_launches() != 0 \
                or k2_launches() != 0:
            raise RuntimeError(
                f"TrPi2018 batched_logl launched K3 {logl_launches} times, "
                f"K4 {logl_k4}, K1 {k1_launches()} and K2 "
                f"{k2_launches()} times, not once, once, never and never")
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if logl.shape != (BATCH,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")
        logl_ms, logl_calls, round_ms = throughput(
            torch, lambda: analysis.batched_logl(u), warmup=1)
        walk = cfg.sampler.n_delete
        for b, ms in ((BATCH, logl_ms), (walk, throughput(
                torch, lambda: analysis.batched_logl(u[:walk]))[0])):
            busy, n_launch, top, k3_dev, _ = device_profile(
                torch, lambda: analysis.batched_logl(u[:b]),
                kernel="grb_eats")
            say("grb_profile", batch=b, wall_ms=f"{ms:.4f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / ms:.4f}",
                kernel_launches=n_launch, k3_device_ms=f"{k3_dev:.4f}",
                top=top)

        # the same batch with the plain K3 on the card
        n_cmp = 1024
        kernel_fn = k3.eats_flux
        k3.eats_flux = k3.eats_flux_plain
        try:
            logl_plain = analysis.batched_logl(u[:n_cmp])
        finally:
            k3.eats_flux = kernel_fn
        if not torch.equal(usable[:n_cmp], logl_plain > -1e29):
            raise RuntimeError("sentinel positions differ from the plain K3")
        kept = usable[:n_cmp]
        dlogl = (logl[:n_cmp] - logl_plain)[kept].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[kept].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"logL off the plain K3 by {float(dlogl.max())}")
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, GRB_INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("grb_logl", batch=BATCH, finite_share=f"{finite_share:.4f}",
            k3_launches=logl_launches, k4_launches=logl_k4,
            k1_launches=k1_launches(),
            k2_launches=k2_launches(), calls=logl_calls,
            wall_ms=f"{logl_ms:.4f}",
            evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
            evals_per_s_rounds=",".join(
                f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
            peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
            compared=n_cmp,
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")

        # 11. the nested sampler with config 3's settings
        t0 = time.time()
        reset()
        result = analysis.run(verbose=False)
        torch.cuda.synchronize()
        launches = k3_launches()
        seconds = time.time() - t0
        if not math.isfinite(result.logz):
            raise RuntimeError(f"TrPi2018 logZ not finite: {result.logz}")
        expected = 1 + result.niter * cfg.sampler.walks
        if launches != expected or k4_launches() != expected \
                or launches <= 0 or k1_launches() != 0 or k2_launches() != 0:
            raise RuntimeError(
                f"the TrPi2018 sampler launched K3 {launches} and K4 "
                f"{k4_launches()} times (expected {expected} each), K1 "
                f"{k1_launches()} and K2 {k2_launches()} times")
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_bestfit_params.json"):
            if not os.path.exists(os.path.join(cfg.outdir,
                                               cfg.label + suffix)):
                raise RuntimeError(f"missing result file {suffix}")
        say("grb_sampler", logz=f"{result.logz:.4f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            k3_launches=launches, k4_launches=k4_launches(),
            k1_launches=k1_launches(), k2_launches=k2_launches())
    k4_entry.update(launches=launches, launches_batched_logl=logl_k4)

    return {
        "name": "grb_eats_flux", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/grb_eats.cu",
        "replaces": "nmma_tpu/ops/pallas_grb.py:47",
        "launches": launches, "launches_batched_logl": logl_launches,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": k3_ms, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms, "bound_by": k3_bound_by, "library_ms": None,
    }, k4_entry


def combined_logl(np, torch, gen):
    """Phase 12: Me2017 + TrPi2018 through make_combined_source_model, one
    batched_logl at B = 1024 through K2 and K3, against the plain K2 and K3
    off the live points where the plain K2 sees a near-tie."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.models import (get_source_model,
                                       make_combined_source_model)
    from nmma_tpu_torch.ops import grb_kernel as k3
    from nmma_tpu_torch.ops import me2017_kernel as k2

    model = "Me2017_TrPi2018_smoke"
    make_combined_source_model(model, [get_source_model("Me2017"),
                                       get_source_model("TrPi2018")])
    filters = ["ztfg", "ztfr", "ztfi", "2massks", "X-ray-1keV",
               "radio-6GHz"]
    n_b = 1024
    with tempfile.TemporaryDirectory(prefix="chip_smoke_combined_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "combined.prior")
        with open(prior_path, "w") as f:
            f.write(COMBINED_PRIOR_TEXT)
        synthetic_photometry(np, torch, model, filters, data_path,
                             COMBINED_INJECTION,
                             sample_times=(0.02, 40.0, 100),
                             epochs=(0.5, 12.0))
        cfg = EMAnalysisConfig(
            model=model, prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, tmin=0.02, tmax=40.0, n_tsteps=100,
            error_budget=1.0, filters=filters)
        analysis = EMAnalysis(cfg, device=DEVICE)
        u = analysis.priors.sample_units(gen, n_b)
        reset_launches()
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        launches = (k1_launches(), k2_launches(), k3_launches(),
                    k4_launches())
        if launches != (0, 1, 1, 1):
            raise RuntimeError(f"the combined batched_logl launched (K1, K2, "
                               f"K3, K4) {launches} times, not (0, 1, 1, 1)")
        if logl.shape != (n_b,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")

        kernels = (k2.me2017_dynamics_from_operands, k3.eats_flux)
        k2.me2017_dynamics_from_operands = k2.me2017_dynamics_plain
        k3.eats_flux = k3.eats_flux_plain
        try:
            logl_plain = analysis.batched_logl(u)
        finally:
            k2.me2017_dynamics_from_operands, k3.eats_flux = kernels
        p = analysis.priors.transform(u)
        gap = k2.me2017_dynamics_plain(*k2.me2017_operands(
            p["log10_mej"], p["log10_vej"], p["beta"],
            10.0 ** p["log10_kappa_r"], analysis.model.sample_times),
            with_ties=True)[2]
        keep = ~(gap < k2.NEAR_TIE).any(dim=1)
        if not torch.equal(usable[keep], (logl_plain > -1e29)[keep]):
            raise RuntimeError("sentinel positions differ from the plain "
                               "K2 and K3")
        kept = usable & keep
        dlogl = (logl - logl_plain)[kept].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[kept].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"combined logL off the plain kernels by "
                               f"{float(dlogl.max())}")
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, COMBINED_INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("combined_logl", batch=n_b, finite_share=f"{finite_share:.4f}",
            k1_launches=launches[0], k2_launches=launches[1],
            k3_launches=launches[2], k4_launches=launches[3],
            tie_samples_dropped=int((~keep).sum()),
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            max_rel_dlogl_vs_plain=f"{float((dlogl / logl_plain[kept].abs().clamp(min=1.0)).max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")


def cli_config(tmp):
    """The [cli] run's prior, injection json, systematics yaml and config
    yaml written under ``tmp``: (config dict, path of the yaml)."""
    import yaml

    from nmma_tpu_torch.injections import write_injection_file

    with open(os.path.join(tmp, "bu2019lm.prior"), "w") as f:
        f.write(PRIOR_TEXT)
    write_injection_file(os.path.join(tmp, "injection.json"), {
        k: [v] for k, v in {**INJECTION, **CLI_INJECTION}.items()})
    with open(os.path.join(tmp, "systematics.yaml"), "w") as f:
        yaml.safe_dump(CLI_SYSTEMATICS, f)
    config = {**CLI_CONFIG, "svd-path": ARTIFACT,
              "prior": os.path.join(tmp, "bu2019lm.prior"),
              "injection": os.path.join(tmp, "injection.json"),
              "systematics-file": os.path.join(tmp, "systematics.yaml"),
              "outdir": os.path.join(tmp, "outdir")}
    config_path = os.path.join(tmp, "run.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f)
    return config, config_path


def cli_path(np, torch):
    """Phase 13: the lightcurve-analysis CLI in-process on the production
    surrogate through K1, with injection, Ebv shaping, yaml systematics,
    G23-MW extinction and checkpoints; then --skip-sampling. Returns the
    run's K1 launches, its posterior, and [lc_bands]'s and [bestfit]'s K1
    launches; then [bestfit] and [lc_bands] on the run."""
    from nmma_tpu_torch.cli import lightcurve_analysis
    from nmma_tpu_torch.ops import svd_kernel

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        config, config_path = cli_config(tmp)
        t0 = time.time()
        reset_launches()
        analysis = lightcurve_analysis.main([config_path])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = (k1_launches(), k2_launches(),
                    k3_launches())
        result = analysis.result
        walks = analysis.config.sampler.walks
        # the injection's light curve, the initial live set, one batch per
        # walk step, the best-fit report
        expected = 1 + 1 + result.niter * walks + BESTFIT_LAUNCHES
        if not math.isfinite(result.logz) or \
                analysis.device.type != torch.device(DEVICE).type:
            raise RuntimeError(f"CLI run on {analysis.device}: logZ "
                               f"{result.logz}")
        if launches != (expected, 0, 0):
            raise RuntimeError(f"the CLI launched K1, K2, K3 {launches} "
                               f"times; expected ({expected}, 0, 0)")
        if analysis.model.extinction_law != "G23_MW" or not {
                "Ebv", "em_syserr_optical_2"} <= set(
                    analysis.priors.sampled_names):
            raise RuntimeError("the CLI run lost its Ebv, systematics or "
                               "extinction configuration")
        # no wall-clock cap: a run short of max_iter ended on dlogz
        if result.niter >= analysis.config.sampler.max_iter:
            raise RuntimeError(f"the CLI run did not converge in "
                               f"{result.niter} iterations")
        label = os.path.join(config["outdir"], config["label"])
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_checkpoint_resume.npz",
                       "_config_complete.ini", "_bestfit.json"):
            if not os.path.exists(label + suffix):
                raise RuntimeError(f"the CLI wrote no {suffix}")
        bands_launches = lc_bands(
            np, torch, "Bu2019lm", analysis, result, svd_kernel,
            "svd_surrogate_mags", svd_kernel.svd_surrogate_mags_plain,
            (1, 0, 0), tmp)
        os.remove(label + "_result.npz")
        again = lightcurve_analysis.main([config_path, "--skip-sampling"])
        regenerated = float(np.load(label + "_result.npz")["logz"])
        if again.result.logz != result.logz or regenerated != result.logz:
            raise RuntimeError(f"--skip-sampling gave logZ "
                               f"{again.result.logz} ({regenerated} on "
                               f"file), the run {result.logz}")
        logl_injection = cli_injection_logl(torch, analysis)
        if not logl_injection > -1e29:
            raise RuntimeError(f"the [cli] logL at its injection is "
                               f"{logl_injection}")
        say("cli", logz=f"{result.logz:.4f}",
            logl_injection=f"{logl_injection:.3f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            ndim=analysis.priors.ndim, k1_launches=launches[0],
            k1_expected=f"3+{result.niter}x{walks}", k2_launches=launches[1],
            k3_launches=launches[2],
            skip_sampling_logz=repr(again.result.logz))
        posterior = analysis.posterior_samples()
        bestfit_launches = bestfit_check(np, torch, analysis, label)
    return launches[0], posterior, bands_launches, bestfit_launches


def cli_injection_logl(torch, analysis):
    """The [cli] analysis's logL at its own injection (INJECTION with
    CLI_INJECTION's extinction; the systematics at their priors'
    midpoints), without launching K1 into the counts of the run."""
    injection = {**INJECTION, **CLI_INJECTION}
    u = [[(injection[n] - analysis.priors[n].minimum)
          / (analysis.priors[n].maximum - analysis.priors[n].minimum)
          if n in injection else 0.5 for n in analysis.priors.sampled_names]]
    return float(analysis.batched_logl(torch.tensor(u, device=DEVICE))[0])


def kn_models(np, torch, gen):
    """Phase 14: HoNa2020, blackbody_fixedT, PL_BB_fixedT and
    synchrotron_powerlaw through EMAnalysis.batched_logl at B = BATCH on
    photometry each model makes at its injection; the card against the port
    on the CPU at B = 128 on the same unit points."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig

    filters = ["sdssu", "ztfg", "ztfr", "ztfi", "2massks"]
    for model, (prior_text, injection, tmin) in KN_MODELS.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_kn_") as tmp:
            data_path = os.path.join(tmp, "injection.dat")
            prior_path = os.path.join(tmp, "model.prior")
            with open(prior_path, "w") as f:
                f.write(prior_text)
            synthetic_photometry(np, torch, model, filters, data_path,
                                 injection, sample_times=(tmin, 14.0, 150),
                                 epochs=(0.5, 12.0))
            cfg = EMAnalysisConfig(
                model=model, prior_file=prior_path,
                light_curve_data=data_path, trigger_time=TRIGGER_MJD,
                data_tmax=12.5, tmin=tmin, filters=filters,
                outdir=os.path.join(tmp, "outdir"))
            analysis = EMAnalysis(cfg, device=DEVICE)
            u = analysis.priors.sample_units(gen, BATCH)
            analysis.batched_logl(u[:128])      # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mb = torch.cuda.memory_allocated() / 2**20
            reset_launches()
            logl = analysis.batched_logl(u)
            torch.cuda.synchronize()
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            launches = (k1_launches(), k2_launches(),
                        k3_launches())
            if launches != (0, 0, 0):
                raise RuntimeError(f"{model} launched K1, K2, K3 {launches} "
                                   "times")
            if logl.shape != (BATCH,) or torch.isnan(logl).any():
                raise RuntimeError(f"bad {model} logL {logl.shape}")
            usable = logl > -1e29
            finite_share = float(usable.float().mean())
            if finite_share < 0.5:
                raise RuntimeError(f"only {finite_share:.3f} of {model} "
                                   "logL finite")
            logl_ms, calls, round_ms = throughput(
                torch, lambda: analysis.batched_logl(u))
            busy, n_launch = device_profile(
                torch, lambda: analysis.batched_logl(u))[:2]

            # the card against the port on the CPU, same unit points
            on_cpu = EMAnalysis(cfg, device="cpu")
            u_small = u[:128]
            got = analysis.batched_logl(u_small).cpu()
            want = on_cpu.batched_logl(u_small.cpu())
            if not torch.equal(got > -1e29, want > -1e29):
                raise RuntimeError(f"{model}: sentinel positions differ "
                                   "between the card and the CPU")
            ok = want > -1e29
            dlogl = (got - want)[ok].abs()
            if bool((dlogl > LOGL_ATOL + LOGL_RTOL * want[ok].abs()).any()):
                raise RuntimeError(f"{model}: the card's logL is "
                                   f"{float(dlogl.max())} off the CPU's")
            logl_inj = float(analysis.batched_logl(
                injection_units(analysis.priors, injection))[0])
            if not logl_inj > float(logl[usable].median()):
                raise RuntimeError(f"{model}: injection logL {logl_inj} "
                                   "below the median")
            say("kn_models", model=model, batch=BATCH,
                finite_share=f"{finite_share:.4f}", calls=calls,
                wall_ms=f"{logl_ms:.4f}",
                evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
                evals_per_s_rounds=",".join(
                    f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
                device_busy_ms=f"{busy:.4f}", kernel_launches=n_launch,
                peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
                cpu_batch=u_small.shape[0], cpu_finite=int(ok.sum()),
                max_abs_dlogl_vs_cpu=f"{float(dlogl.max()):.3e}",
                logl_injection=f"{logl_inj:.3f}")


def rows_of(ops, n):
    """The first n rows of K3's per-row operands (cphi and wphi shared)."""
    return tuple(o if i in (5, 6) else o[:n].contiguous()
                 for i, o in enumerate(ops))


def grb_ramp_path(np, torch, gen):
    """Phases 15-16: K3's per-row query mode against its plain version, then
    TrPi2018 on the energy ramp (its 64 nodes folded into the batch, in
    chunks of models/grb.py:ramp_chunk_rows rows, one K3 launch each)
    through the detector and EMAnalysis.batched_logl. Returns the per-row
    fields of K3's entry in the kernel line."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.models import grb
    from nmma_tpu_torch.ops import grb_kernel as k3

    def reset():
        from nmma_tpu_torch import tracing
        reset_launches()
        tracing.reset(tracing.RAMP_CHUNKS)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ramp_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "ramp.prior")
        with open(prior_path, "w") as f:
            f.write(RAMP_PRIOR_TEXT)
        synthetic_photometry(np, torch, "TrPi2018", GRB_FILTERS, data_path,
                             RAMP_INJECTION, sample_times=(0.05, 40.0, 64),
                             epochs=(0.1, 30.0))
        cfg = EMAnalysisConfig(
            model="TrPi2018", prior_file=prior_path,
            light_curve_data=data_path, trigger_time=TRIGGER_MJD, tmin=0.05,
            tmax=40.0, n_tsteps=64, error_budget=0.5, filters=GRB_FILTERS)
        analysis = EMAnalysis(cfg, device=DEVICE)
        t_grid = grb.trpi2018_time_grid(analysis.model.sample_times)
        n_nodes = t_grid.shape[0]
        chunk = grb.ramp_chunk_rows()

        def folded(b):
            """b ramp prior draws folded with the nodes: (params, t_rows,
            nu_rows) of b x 64 rows."""
            p = analysis.model.prepare_parameters(analysis.priors.transform(
                analysis.priors.sample_units(gen, b)))
            p.setdefault("d_L", 3.086e19)
            return grb.ramp_rows(p, t_grid,
                                 analysis.model.nu_0s[None].expand(b, -1))

        def row_operands(rows, s=0, e=None):
            p, t_rows, nu_rows = rows
            e = t_rows.shape[0] if e is None else e
            part = {k: (v[s:e] if isinstance(v, torch.Tensor) and v.dim()
                        else v) for k, v in p.items()}
            return grb.grb_stage1(t_rows[s:e], nu_rows[s:e], part)[0]

        # 15. K3 with one query a row against its plain version. Zeros
        # must sit in the same places, a subnormal counting as zero: on
        # these operands K3 leaves 1-8 ulps of the smallest subnormal
        # (<= 1.1e-44, against outputs up to ~1e-16) where the plain
        # version's other order of operations underflows to 0, and the JAX
        # reference flushes every subnormal to zero (XLA)
        tiny = torch.finfo(torch.float32).tiny
        ops = row_operands(folded(RAMP_POINTS))           # 4,096 rows
        max_rel = 0.0
        for n in sorted({1, min(1000, ops[0].shape[0]), ops[0].shape[0]}):
            sub = rows_of(ops, n)
            launched = k3_launches()
            got = k3.eats_flux(*sub)
            want = k3.eats_flux_plain(*sub)
            torch.cuda.synchronize()
            rel = relative_error(torch, got, want)
            exact = (got == 0) != (want == 0)
            residue = float(torch.where(exact, got.abs() + want.abs(),
                                        0.0).max())
            if got.shape != (n, sub[0].shape[1], len(GRB_FILTERS), 1) \
                    or k3_launches() != launched + 1 \
                    or not math.isfinite(rel) or rel > K3_TOL or not torch.isfinite(got).all() \
                    or not torch.equal(got.abs() < tiny, want.abs() < tiny):
                raise RuntimeError(
                    f"K3's per-row mode disagrees at {n} rows: max relative "
                    f"error {rel} (tolerance {K3_TOL}), zeros "
                    f"{int((got.abs() < tiny).sum())} against "
                    f"{int((want.abs() < tiny).sum())}")
            max_rel = max(max_rel, rel)
            say("k3_rowq", rows=n, shape="x".join(map(str, got.shape)),
                max_rel_err=f"{rel:.3e}",
                max_abs_err=f"{float((got - want).abs().max()):.3e}",
                zeros=f"{int((want == 0).sum())}/{want.numel()}",
                subnormal_only_mismatches=int(exact.sum()),
                max_mismatch_value=f"{residue:.3e}")
        # hand-made rows, each with its own query: on a node, on a plateau
        # value, at both ends of its row and outside it
        for n_r in (100, 128, 256):
            for n_phi in (5, 16):
                edge = k3.edge_operands(148, 8, n_r, 37, n_phi,
                                        len(GRB_FILTERS), seed=n_r + n_phi,
                                        device=DEVICE)
                lq = edge[4][torch.arange(148, device=DEVICE) % 37]
                edge = edge[:4] + (lq[:, None].contiguous(),) + edge[5:]
                got = k3.eats_flux(*edge)
                want = k3.eats_flux_plain(*edge)
                torch.cuda.synchronize()
                rel = relative_error(torch, got, want)
                zeros = want == 0
                if not math.isfinite(rel) or rel > K3_TOL \
                        or not torch.isfinite(got).all() \
                        or not torch.equal(got == 0, zeros):
                    raise RuntimeError(
                        f"K3's per-row mode disagrees on hand-made rows at "
                        f"R={n_r}, Ph={n_phi}: max relative error {rel}, "
                        f"zeros {int((got == 0).sum())} against "
                        f"{int(zeros.sum())}")
                max_rel = max(max_rel, rel)
                say("k3_rowq", edges=f"R{n_r}xPh{n_phi}", rows=148,
                    max_rel_err=f"{rel:.3e}",
                    zeros=f"{int(zeros.sum())}/{zeros.numel()}")
        rowq_ms = time_ms(torch, lambda: k3.eats_flux(*ops), rounds=5,
                          launches=2, warmup=1)
        rowq_plain_ms = time_ms(torch, lambda: k3.eats_flux_plain(*ops),
                                rounds=1, launches=1, warmup=1)
        n_ops, n_bytes, in_range, queries = k3_work(torch, ops)
        rowq_bound_ms, rowq_bound_by = roofline_ms(n_ops, n_bytes)
        say("k3_rowq", rows=ops[0].shape[0], kernel_ms=f"{rowq_ms:.4f}",
            plain_ms=f"{rowq_plain_ms:.4f}",
            bound_ms=f"{rowq_bound_ms:.4f}", bound_by=rowq_bound_by,
            gops=f"{n_ops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}",
            queries_in_range=f"{in_range}/{queries}",
            share_of_bound=f"{rowq_bound_ms / rowq_ms:.4f}")
        del ops, sub, got, want
        # the B = 8192 ramp's 524,288 rows, chunk by chunk as the model
        # runs them: K3's time (CUDA events, one launch a chunk) and bound
        rows = folded(BATCH)
        n_rows = rows[1].shape[0]
        big_ms, big_ops, big_bytes, big_chunks = 0.0, 0.0, 0.0, 0
        for s in range(0, n_rows, chunk):
            ops = row_operands(rows, s, min(n_rows, s + chunk))
            if s == 0:
                k3.eats_flux(*ops)                        # warm-up
            big_ms += time_ms(torch, lambda: k3.eats_flux(*ops), rounds=1,
                              launches=1, warmup=0)
            work = k3_work(torch, ops)
            big_ops, big_bytes = big_ops + work[0], big_bytes + work[1]
            big_chunks += 1
            del ops
        big_bound_ms, big_bound_by = roofline_ms(big_ops, big_bytes)
        say("k3_rowq", rows=n_rows, chunks=big_chunks, chunk_rows=chunk,
            kernel_ms=f"{big_ms:.4f}", bound_ms=f"{big_bound_ms:.4f}",
            bound_by=big_bound_by, gops=f"{big_ops / 1e9:.3f}",
            mbytes=f"{big_bytes / 1e6:.3f}",
            share_of_bound=f"{big_bound_ms / big_ms:.4f}")
        del rows

        # 16. the ramp's magnitudes against the plain K3 (B = 64)
        def calls(n_b):
            return math.ceil(n_b * n_nodes / chunk)

        u = analysis.priors.sample_units(gen, BATCH)
        p64 = analysis.priors.transform(u[:64])
        reset()
        _, mags = analysis.model(p64)
        torch.cuda.synchronize()
        if k3_launches() != calls(64) or k4_launches() != calls(64) \
                or ramp_chunks() != calls(64):
            raise RuntimeError(f"the ramp at B=64 launched K3 {k3_launches()} "
                               f"and K4 {k4_launches()} times in "
                               f"{ramp_chunks()} chunks, not {calls(64)}")
        kernel_fn = k3.eats_flux
        k3.eats_flux = k3.eats_flux_plain
        try:
            _, mags_plain = analysis.model(p64)
            logl_plain = analysis.batched_logl(u[:64])
        finally:
            k3.eats_flux = kernel_fn
        if not torch.equal(torch.isinf(mags), torch.isinf(mags_plain)) \
                or torch.isnan(mags).any():
            raise RuntimeError("the ramp's inf magnitudes differ from the "
                               "plain K3's")
        fin = torch.isfinite(mags_plain)
        faint = fin & (mags_plain >= FAINT_MAG)
        bright = fin & ~faint
        dmag = float((mags - mags_plain)[bright].abs().max())
        if not dmag <= RAMP_MAG_TOL or float(bright.float().mean()) < 0.5:
            raise RuntimeError(f"the ramp's magnitudes are {dmag} mag off "
                               f"the plain K3's (tolerance {RAMP_MAG_TOL})")
        reset()
        logl = analysis.batched_logl(u[:64])
        torch.cuda.synchronize()
        if (k3_launches(), k4_launches(), k1_launches(), k2_launches(),
                ramp_chunks()) != (calls(64), calls(64), 0, 0, calls(64)):
            raise RuntimeError(
                f"the ramp's batched_logl at B=64 launched K3, K4, K1, K2 "
                f"{k3_launches()}, {k4_launches()}, {k1_launches()}, "
                f"{k2_launches()} times in {ramp_chunks()} chunks")
        usable = logl > -1e29
        if not torch.equal(usable, logl_plain > -1e29):
            raise RuntimeError("the ramp's sentinels differ from the plain "
                               "K3's")
        dlogl = (logl - logl_plain)[usable].abs()
        if bool((dlogl > LOGL_ATOL + LOGL_RTOL
                 * logl_plain[usable].abs()).any()):
            raise RuntimeError(f"the ramp's logL is {float(dlogl.max())} off "
                               "the plain K3's")
        say("grb_ramp", batch=64, max_abs_dmag=f"{dmag:.3e}",
            compared_mags=int(bright.sum()),
            fainter_than=f"{FAINT_MAG}:{int(faint.sum())}",
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            finite_share=f"{float(usable.float().mean()):.4f}")

        # wall and device time, peak memory and evals/s at B = 64 and 8192
        for b, rounds in ((64, 5), (BATCH, 2)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mb = torch.cuda.memory_allocated() / 2**20
            ub = u[:b]
            b = ub.shape[0]
            reset()
            logl = analysis.batched_logl(ub)
            torch.cuda.synchronize()
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            launches = (k3_launches(), k1_launches(),
                        k2_launches(), k4_launches(), ramp_chunks())
            if launches != (calls(b), 0, 0, calls(b), calls(b)):
                raise RuntimeError(
                    f"the ramp's batched_logl at B={b} launched K3, K1, K2, "
                    f"K4 {launches[:4]} times in {launches[4]} chunks, not "
                    f"({calls(b)}, 0, 0, {calls(b)}) in {calls(b)}")
            usable = logl > -1e29
            if logl.shape != (b,) or torch.isnan(logl).any() \
                    or float(usable.float().mean()) < 0.5:
                raise RuntimeError(f"bad ramp logL at B={b}")
            wall_ms, n_calls, round_ms = throughput(
                torch, lambda: analysis.batched_logl(ub), rounds=rounds,
                round_s=0.4 if b == 64 else 0.0, warmup=1)
            # one profiled call at B = 8192, the mean of 10 at B = 64
            n_prof = 1 if b == BATCH else 10
            busy, n_launch, top, k3_dev, k3_seen = device_profile(
                torch, lambda: [analysis.batched_logl(ub)
                                for _ in range(n_prof)], kernel="grb_eats")
            busy, n_launch, k3_dev = (busy / n_prof, n_launch // n_prof,
                                      k3_dev / n_prof)
            k3_seen //= n_prof
            if b == BATCH:
                ramp_k3_ms = k3_dev
            say("grb_ramp", batch=b, rows=b * n_nodes, k3_launches=launches[0],
                k4_launches=launches[3], ramp_chunks=launches[4],
                k3_expected=calls(b), calls=n_calls, wall_ms=f"{wall_ms:.4f}",
                evals_per_s=f"{b / (wall_ms / 1e3):.1f}",
                evals_per_s_rounds=",".join(
                    f"{b / (ms / 1e3):.1f}" for ms in round_ms),
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / wall_ms:.4f}",
                kernel_launches=n_launch, k3_device_ms=f"{k3_dev:.4f}",
                k3_profiled_launches=k3_seen, profiled_calls=n_prof,
                peak_mem_mib=f"{peak_mb:.1f}",
                base_mem_mib=f"{base_mb:.1f}",
                finite_share=f"{float(usable.float().mean()):.4f}", top=top)

    # the ramp's meaning (tests/test_grb.py:281-314), at full resolution:
    # before t_start the constant-E0(Estart) curve, after the injection the
    # constant-E0(Eend) curve, between them inside their envelopes
    base = dict(thetaCore=0.08, thetaWing=0.32, inclination_EM=0.0,
                log10_n0=-2.0, p=2.3, log10_epsilon_e=-1.0,
                log10_epsilon_B=-3.0, xi_N=1.0, d_L=3.086e19)
    a, le, t_start, t_end = 1.2, 52.5, 2.0e4, 2.0e6
    t = torch.tensor(np.geomspace(0.05, 200.0, 40), dtype=torch.float32,
                     device=DEVICE)
    nu = torch.tensor([[5e14]], device=DEVICE)

    def curve(**extra):
        p = {k: torch.tensor([v], device=DEVICE)
             for k, v in dict(base, **extra).items()}
        return grb.trpi2018_mags(p, t, nu)[0, 0].cpu().numpy()

    reset()
    m_inj = curve(energy_exponential=a, log10_Eend=le, t_start=t_start,
                  injection_duration=t_end)
    if k3_launches() != calls(1) or k4_launches() != calls(1) \
            or ramp_chunks() != calls(1):
        raise RuntimeError(f"one ramp curve launched K3 {k3_launches()} and "
                           f"K4 {k4_launches()} times in {ramp_chunks()} "
                           f"chunks")
    m_lo = curve(log10_E0=le + a * math.log10(t_start / t_end))
    m_hi = curve(log10_E0=le)
    t_sec = t.cpu().numpy() * 86400.0
    pre, post = t_sec < 0.8 * t_start, t_sec > 1.3 * t_end
    mid = ~(pre | post)
    d_pre = float(np.abs(m_inj[pre] - m_lo[pre]).max())
    d_post = float(np.abs(m_inj[post] - m_hi[post]).max())
    if not (pre.any() and post.any() and d_pre <= 0.05 and d_post <= 0.05
            and np.all(m_inj[mid] <= m_lo[mid] + 0.05)
            and np.all(m_inj[mid] >= m_hi[mid] - 0.05)):
        raise RuntimeError(f"the ramp's curve leaves its envelopes: "
                           f"{d_pre} before t_start, {d_post} after")
    say("grb_ramp", semantics="ok", pre_points=int(pre.sum()),
        post_points=int(post.sum()), max_dmag_pre=f"{d_pre:.3e}",
        max_dmag_post=f"{d_post:.3e}")
    return {"rowq_ms_4096": rowq_ms, "rowq_plain_ms_4096": rowq_plain_ms,
            "rowq_bound_ms_4096": rowq_bound_ms,
            "rowq_bound_by_4096": rowq_bound_by,
            "rowq_ms_524288": big_ms, "rowq_bound_ms_524288": big_bound_ms,
            "rowq_profiled_ms_524288": ramp_k3_ms,
            "rowq_max_rel_err": max_rel,
            "launches_ramp_call_8192": calls(BATCH)}


def posterior_config3(np, torch):
    """Phase 17: BASELINE config 3 to convergence at the JAX package's
    production settings (scripts/torch_parity_config3.py), its posterior
    against the JAX package's two, JS < 0.01 per parameter, and logZ; then
    [lc_bands] on the run. Returns [lc_bands]'s K3 launches."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_parity_config3 as parity

    from nmma_tpu_torch.ops import grb_kernel

    with tempfile.TemporaryDirectory(prefix="chip_smoke_config3_") as tmp:
        analysis = parity.config3_analysis(tmp, device=DEVICE)
        reset_launches()
        result, post, seconds = parity.run(analysis)
        launches = (k3_launches(), k1_launches(),
                    k2_launches())
        bands_launches = lc_bands(
            np, torch, "TrPi2018", analysis, result, grb_kernel, "eats_flux",
            grb_kernel.eats_flux_plain, (0, 0, 1), tmp, faint=FAINT_MAG)
    walks = analysis.config.sampler.walks
    expected = 1 + result.niter * walks
    if launches != (expected, 0, 0):
        raise RuntimeError(f"config 3 launched K3, K1, K2 {launches} times; "
                           f"expected ({expected}, 0, 0)")
    summary = parity.compare(post, result.logz, result.logz_err)
    for ref in parity.REFERENCES:
        say("posterior_config3", reference=ref, **{
            k: f"{v:.5f}" for k, v in summary[f"js_{ref}"].items()},
            js_max=f"{max(summary[f'js_{ref}'].values()):.5f}")
    say("posterior_config3", iterations=result.niter,
        likelihood_calls=result.ncall, k3_launches=launches[0],
        k3_expected=f"1+{result.niter}x{walks}",
        logz=f"{result.logz:.4f}", logz_err=f"{result.logz_err:.4f}",
        reference_logz="-59.4958+-0.0843",
        dlogz=f"{summary['dlogz']:.4f}",
        dlogz_limit=f"{summary['dlogz_limit']:.4f}",
        js_max=f"{summary['js_max']:.5f}", js_gate=parity.JS_GATE,
        samples=summary["n_samples"], seconds=f"{seconds:.2f}")
    if not summary["ok"]:
        raise RuntimeError(f"config 3's posterior fails its check: JS max "
                           f"{summary['js_max']}, dlogZ {summary['dlogz']} "
                           f"(limit {summary['dlogz_limit']})")
    return bands_launches


def mcmc_path(np, torch, nested):
    """Phase 18: the [cli] configuration with --sampler mcmc: K1 launches,
    R-hat, and JS per parameter against the [cli] run's nested posterior
    ``nested``."""
    from nmma_tpu_torch.cli import lightcurve_analysis
    from nmma_tpu_torch.post_processing import posterior_js_divergences

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mcmc_") as tmp:
        config, config_path = cli_config(tmp)
        flags = ["--sampler", "mcmc", "--mcmc-walkers", str(MCMC_WALKERS),
                 "--mcmc-sweeps", str(MCMC_SWEEPS), "--mcmc-temps",
                 str(MCMC_TEMPS)]
        t0 = time.time()
        reset_launches()
        analysis = lightcurve_analysis.main([config_path, *flags])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = (k1_launches(), k2_launches(),
                    k3_launches())
        res = analysis.mcmc_result
        # the injection's light curve, the initial walkers, two half-sweeps,
        # the best-fit report
        expected = 1 + 1 + 2 * MCMC_SWEEPS + BESTFIT_LAUNCHES
        if launches != (expected, 0, 0):
            raise RuntimeError(f"the MCMC launched K1, K2, K3 {launches} "
                               f"times; expected ({expected}, 0, 0)")
        label = os.path.join(config["outdir"], config["label"])
        written = [label + s for s in ("_mcmc_result.npz",
                                       "_mcmc_posterior_samples.csv",
                                       "_bestfit.json")]
        if not all(os.path.exists(p) for p in written):
            raise RuntimeError("the MCMC wrote no result files")
        post = analysis.posterior_samples(result=res)
    names = analysis.priors.sampled_names
    js = posterior_js_divergences(post, nested, names)
    max_rhat = float(np.nanmax(res.rhat))
    say("mcmc", walkers=MCMC_WALKERS, sweeps=MCMC_SWEEPS, temps=MCMC_TEMPS,
        seconds=f"{seconds:.2f}", acceptance=f"{res.acceptance:.4f}",
        max_rhat=f"{max_rhat:.4f}", likelihood_calls=res.n_call,
        k1_launches=launches[0], k1_expected=f"3+2x{MCMC_SWEEPS}",
        samples=res.samples_u.shape[0],
        written=",".join(os.path.basename(p) for p in written))
    say("mcmc", **{f"rhat_{k}": f"{v:.4f}" for k, v in zip(names, res.rhat)})
    say("mcmc", **{f"js_{k}": f"{v:.5f}" for k, v in js.items()},
        js_max=f"{max(js.values()):.5f}", js_gate=MCMC_JS_GATE)
    if not max_rhat <= MCMC_RHAT_GATE:
        raise RuntimeError(f"MCMC max R-hat {max_rhat} > {MCMC_RHAT_GATE}")
    if not max(js.values()) < MCMC_JS_GATE:
        raise RuntimeError(f"MCMC posterior off the nested one: JS {js}")


def em_models(np, torch, gen):
    """Phase 19: Piro2021, Sr2023 and a spectral template through
    EMAnalysis.batched_logl, Arnett and Arnett_modified through the
    bolometric likelihood, each at B = BATCH: evals/s, device ms, launches,
    peak memory, and the card against the CPU at B = 128."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.likelihood import BolometricLikelihood
    from nmma_tpu_torch.models import (DetectorLightCurveModel,
                                       spectral_model_from_file)
    from nmma_tpu_torch.priors import parse_prior_dict

    spectral_model_from_file("sn_template_smoke", SN_TEMPLATE)

    for model, (prior_text, injection, grid, filters, epochs) in \
            EM_MODELS.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_em_") as tmp:
            data_path = os.path.join(tmp, "injection.dat")
            prior_path = os.path.join(tmp, "model.prior")
            with open(prior_path, "w") as f:
                f.write(prior_text)
            synthetic_photometry(np, torch, model, filters, data_path,
                                 injection, sample_times=grid[:3],
                                 epochs=epochs)
            cfg = EMAnalysisConfig(
                model=model, prior_file=prior_path,
                light_curve_data=data_path, trigger_time=TRIGGER_MJD,
                tmin=grid[0], tmax=grid[1], n_tsteps=grid[2],
                timescale=grid[3], filters=filters,
                outdir=os.path.join(tmp, "outdir"))
            analysis = EMAnalysis(cfg, device=DEVICE)
            on_cpu = EMAnalysis(cfg, device="cpu")
            u = analysis.priors.sample_units(gen, BATCH)
            measure_logl(torch, "em_models", model, analysis.batched_logl,
                         on_cpu.batched_logl, u,
                         float(analysis.batched_logl(injection_units(
                             analysis.priors, injection))[0]))

    for model, prior_text, injection in (
            ("Arnett", ARNETT_PRIOR_TEXT, ARNETT_INJECTION),
            ("Arnett_modified", ARNETT_PRIOR_TEXT
             + "t_0 = Uniform(minimum=5., maximum=50.)\n",
             {**ARNETT_INJECTION, "t_0": 20.0})):
        phase, lbol, lbol_err = arnett_lbol(np, torch, model, injection)
        priors = parse_prior_dict(prior_text)
        funcs = []
        for device in (DEVICE, "cpu"):
            like = BolometricLikelihood(DetectorLightCurveModel(
                model, [], device=device), phase, lbol, lbol_err)
            funcs.append(lambda v, like=like: like(priors.transform(v)))
        u = priors.sample_units(gen, BATCH)
        measure_logl(torch, "em_models", model, *funcs, u, float(funcs[0](
            injection_units(priors, injection))[0]))


def measure_logl(torch, phase, model, fn_on, fn_cpu, u, injection_logl):
    """Launches (none of K1-K3), throughput, profile and peak memory of one
    model's batched log-likelihood ``fn_on`` at B = BATCH, and the card
    against ``fn_cpu`` at B = 128 (LOGL_RTOL, LOGL_ATOL, identical
    sentinels); printed as ``[phase]``."""
    fn_on(u[:128])                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    logl = fn_on(u)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = kernel_launches()
    if launches != (0, 0, 0):
        raise RuntimeError(f"{model} launched K1, K2, K3 {launches}")
    if logl.shape != (BATCH,) or torch.isnan(logl).any():
        raise RuntimeError(f"bad {model} logL {logl.shape}")
    usable = logl > -1e29
    finite_share = float(usable.float().mean())
    if finite_share < 0.5:
        raise RuntimeError(f"only {finite_share:.3f} of {model} logL "
                           "finite")
    logl_ms, calls, round_ms = throughput(torch, lambda: fn_on(u))
    busy, n_launch = device_profile(torch, lambda: fn_on(u))[:2]
    got = fn_on(u[:128]).cpu()
    want = fn_cpu(u[:128].cpu())
    if not torch.equal(got > -1e29, want > -1e29):
        raise RuntimeError(f"{model}: sentinels differ between the card "
                           "and the CPU")
    ok = want > -1e29
    dlogl = (got - want)[ok].abs()
    if bool((dlogl > LOGL_ATOL + LOGL_RTOL * want[ok].abs()).any()):
        raise RuntimeError(f"{model}: the card's logL is "
                           f"{float(dlogl.max())} off the CPU's")
    if not injection_logl > float(logl[usable].median()):
        raise RuntimeError(f"{model}: injection logL {injection_logl} "
                           "below the median")
    say(phase, model=model, batch=BATCH,
        finite_share=f"{finite_share:.4f}", calls=calls,
        wall_ms=f"{logl_ms:.4f}",
        evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
        evals_per_s_rounds=",".join(
            f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
        device_busy_ms=f"{busy:.4f}", kernel_launches=n_launch,
        peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
        cpu_batch=128, cpu_finite=int(ok.sum()),
        max_abs_dlogl_vs_cpu=f"{float(dlogl.max()):.3e}",
        max_rel_dlogl_vs_cpu=f"{float((dlogl / want[ok].abs().clamp(min=1.0)).max()):.3e}",
        logl_injection=f"{injection_logl:.3f}")


def arnett_lbol(np, torch, model, injection):
    """Bolometric photometry of an Arnett model at ``injection``: 12 epochs
    in 1-19 d with 5% seeded noise, the last epoch an upper limit
    (erg/s)."""
    from nmma_tpu_torch.models import DetectorLightCurveModel

    det = DetectorLightCurveModel(model, [], device=DEVICE)
    t, lbol40 = det({k: torch.tensor([v], device=DEVICE)
                     for k, v in injection.items()})
    rng = np.random.default_rng(11)
    phase = np.linspace(1.0, 19.0, 12)
    true = np.interp(phase, t[0].cpu().numpy(),
                     lbol40[0].cpu().numpy()) * 1e40
    err = 0.05 * true
    obs = true + rng.normal(0.0, err)
    err[-1] = np.inf
    return phase, obs, err


def lbol_path(np, torch):
    """Phase 20: lightcurve-analysis-lbol (lbol_main) on an Arnett csv from
    an injection, nested sampling to convergence: finite logZ and the
    injection inside the 90% interval of each sampled parameter."""
    from nmma_tpu_torch.cli.lightcurve_analysis import lbol_main

    phase, lbol, lbol_err = arnett_lbol(np, torch, "Arnett",
                                        ARNETT_INJECTION)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lbol_") as tmp:
        csv = os.path.join(tmp, "lbol.csv")
        np.savetxt(csv, np.column_stack([phase, lbol, lbol_err]),
                   delimiter=",", header="phase,Lbb,Lbb_unc", comments="")
        prior = os.path.join(tmp, "arnett.prior")
        with open(prior, "w") as f:
            f.write(ARNETT_PRIOR_TEXT)
        t0 = time.time()
        reset_launches()
        result = lbol_main(["--model", "Arnett", "--prior", prior,
                            "--light-curve-data", csv, "--nlive", "256",
                            "--dlogz", "0.1", "--outdir", tmp,
                            "--label", "lbol"])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = (k1_launches(), k2_launches(),
                    k3_launches())
        post = np.load(os.path.join(tmp, "lbol_result.npz"))
        intervals = {k: np.quantile(post[f"posterior_{k}"], [0.05, 0.95])
                     for k in ("tau_m", "log10_mni")}
    if not math.isfinite(result.logz) or launches != (0, 0, 0):
        raise RuntimeError(f"lbol_main: logZ {result.logz}, K1/K2/K3 "
                           f"launches {launches}")
    outside = {k: (float(lo), float(hi)) for k, (lo, hi) in intervals.items()
               if not lo <= ARNETT_INJECTION[k] <= hi}
    say("lbol", logz=f"{result.logz:.4f}", logz_err=f"{result.logz_err:.4f}",
        iterations=result.niter, likelihood_calls=result.ncall,
        seconds=f"{seconds:.2f}", **{
            f"{k}_90": f"{lo:.4f}..{hi:.4f}"
            for k, (lo, hi) in intervals.items()},
        injection=",".join(f"{k}={v}" for k, v in ARNETT_INJECTION.items()))
    if outside:
        raise RuntimeError(f"the injection lies outside the 90% intervals "
                           f"{outside}")


def k1_launches():
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.K1_LAUNCHES)


def k2_launches():
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.K2_LAUNCHES)


def k3_launches():
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.K3_LAUNCHES)


def k4_launches():
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.K4_LAUNCHES)


def k5_launches():
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.K5_LAUNCHES)


def k6_launches():
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.K6_LAUNCHES)


def ramp_chunks():
    """The energy ramp's chunks since they were last reset."""
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.RAMP_CHUNKS)


def collectives():
    """The split likelihood's collectives since they were last reset."""
    from nmma_tpu_torch import tracing
    return tracing.counter(tracing.MESH_COLLECTIVES)


def kernel_launches():
    """(K1, K2, K3) launch counts since the last reset_launches()."""
    return (k1_launches(), k2_launches(), k3_launches())


def reset_counts(*names):
    """Set the counters of nmma_tpu_torch.tracing named "k1" to "k6"
    (kernel launches) or "mesh" (collectives) to 0."""
    from nmma_tpu_torch import tracing
    tracing.reset(*(tracing.MESH_COLLECTIVES if n == "mesh"
                    else f"kernel.{n}.launches" for n in names))


def reset_launches():
    reset_counts("k1", "k2", "k3", "k4", "k5", "k6")


def gw_logl_gate(torch, got, want, data_power):
    """Sentinels identical and |got - want| <= 1e-2 + 1e-4 |want| +
    GW_PHASE_ULP <d,d> where finite; returns (max |dlogL|, largest share of
    the gate used)."""
    if not torch.equal(got > -1e29, want > -1e29):
        raise RuntimeError("GW logL sentinel positions differ")
    ok = want > -1e29
    d = (got - want)[ok].abs()
    allowed = LOGL_ATOL + LOGL_RTOL * want[ok].abs() + GW_PHASE_ULP * data_power
    share = float((d / allowed).max()) if d.numel() else 0.0
    if share > 1.0:
        raise RuntimeError(f"GW logL off by {float(d.max())} (gate share "
                           f"{share:.3f})")
    return (float(d.max()) if d.numel() else 0.0), share


def gw_files(tmp):
    """The prior file and json injection of the GW path under ``tmp``."""
    from nmma_tpu_torch.injections import write_injection_file

    prior = os.path.join(tmp, "bns.prior")
    with open(prior, "w") as f:
        f.write(GW_PRIOR_TEXT)
    injection = os.path.join(tmp, "injection.json")
    write_injection_file(injection, {k: [v] for k, v in GW_INJECTION.items()})
    return prior, injection


def gw_generation_args(tmp, label):
    return ["--outdir", os.path.join(tmp, "outdir"), "--label", label,
            "--trigger-time", repr(GW_TRIGGER), "--gw-detectors", GW_DETECTORS,
            "--duration", repr(GW_DURATION),
            "--minimum-frequency", repr(GW_FMIN),
            "--maximum-frequency", repr(GW_FMAX), "--waveform", GW_WAVEFORM,
            "--binning-epsilon", repr(GW_EPSILON)]


def gw_waveform(np, torch, gen):
    """Phase 21: TaylorF2, IMRPhenomD and IMRPhenomD_NRTidalv2 on the
    relative-binning edges at B = BATCH and on the dense grid at B = 256,
    card against CPU; then the BBH case whose band reaches PhenomD's
    intermediate amplitude and its 5x5 solve."""
    from nmma_tpu_torch.conversion import generate_mass_parameters
    from nmma_tpu_torch.gw import WAVEFORM_MODELS, imrphenomd
    from nmma_tpu_torch.gw.phenomd import (
        _amplitude_intermediate_coefficients, _phenomd_pieces)
    from nmma_tpu_torch.gw.relative_binning import setup_bins
    from nmma_tpu_torch.priors import parse_prior_dict

    priors = parse_prior_dict(GW_PRIOR_TEXT)
    params = generate_mass_parameters(
        priors.transform(priors.sample_units(gen, BATCH)))
    edges = setup_bins(GW_FMIN, GW_FMAX, 1.0, GW_EPSILON)
    dense = np.arange(round(GW_FMIN * GW_DURATION),
                      round(GW_FMAX * GW_DURATION) + 1) / GW_DURATION
    grids = {"edges": (np.tile(edges, 3), BATCH, 32),
             "dense": (dense, 256, 8)}

    def compare(fn, freqs, p, rows):
        """(amplitude rel error, strain rel error) card against CPU."""
        f_card = torch.as_tensor(freqs, dtype=torch.float32, device=DEVICE)
        sub = {k: v[:rows] for k, v in p.items()}
        got = fn(f_card, sub)[0].cpu()
        want = fn(f_card.cpu(), {k: v.cpu() for k, v in sub.items()})[0]
        amp_g, amp_w = got.abs(), want.abs()
        keep = amp_w > 1e-6 * amp_w.max()
        amp = float(((amp_g - amp_w).abs()[keep] / amp_w[keep]).max())
        strain = float((got - want).abs().max() / want.abs().max())
        return amp, strain

    with torch.no_grad():
        for name, fn in WAVEFORM_MODELS.items():
            for grid, (freqs, b, rows) in grids.items():
                f_card = torch.as_tensor(freqs, dtype=torch.float32,
                                         device=DEVICE)
                sub = {k: v[:b] for k, v in params.items()}
                reset_launches()
                ms = time_ms(torch, lambda: fn(f_card, sub), rounds=5,
                             launches=2, warmup=2)
                amp, strain = compare(fn, freqs, params, rows)
                if kernel_launches() != (0, 0, 0) or amp > GW_AMP_RTOL \
                        or strain > GW_STRAIN_TOL or not math.isfinite(amp):
                    raise RuntimeError(
                        f"{name} on {grid}: card against CPU amplitude "
                        f"{amp}, strain {strain}, K1-K3 {kernel_launches()}")
                say("gw_waveform", waveform=name, grid=grid,
                    frequencies=len(freqs), batch=b, device_ms=f"{ms:.4f}",
                    cpu_rows=rows, amp_rel_vs_cpu=f"{amp:.3e}",
                    strain_rel_vs_cpu=f"{strain:.3e}")

        # the BBH: its 5x5 solve card against CPU, and the amplitude there
        rng = np.random.default_rng(36)
        bbh = {k: torch.full((64,), v, device=DEVICE)
               for k, v in GW_BBH.items()}
        bbh["mass_1"][1:] = torch.as_tensor(rng.uniform(30.0, 42.0, 63),
                                            dtype=torch.float32)
        bbh["mass_2"][1:] = torch.as_tensor(rng.uniform(24.0, 34.0, 63),
                                            dtype=torch.float32)
        cols = [bbh[k].reshape(-1, 1) for k in ("mass_1", "mass_2",
                                                "chi_1", "chi_2")]
        delta, f3 = _amplitude_intermediate_coefficients(
            _phenomd_pieces(*cols))
        delta_cpu, _ = _amplitude_intermediate_coefficients(
            _phenomd_pieces(*[c.cpu() for c in cols]))
        solve_rel = float(((delta.cpu() - delta_cpu).abs()
                           / delta_cpu.abs().clamp(min=1e-30)).max())
        amp, strain = compare(imrphenomd, dense, bbh, 64)
        mf = (bbh["mass_1"] + bbh["mass_2"]).cpu() * 4.925490947641267e-06
        in_band = int(((mf[:, None] * torch.as_tensor(dense)[None] >= 0.014)
                       & (mf[:, None] * torch.as_tensor(dense)[None]
                          < f3.cpu())).sum())
    if amp > GW_AMP_RTOL or strain > GW_STRAIN_TOL or in_band == 0:
        raise RuntimeError(f"BBH card against CPU: amplitude {amp}, strain "
                           f"{strain}, 5x5 solve {solve_rel}, "
                           f"{in_band} intermediate bins")
    say("gw_waveform", waveform="IMRPhenomD", case="BBH_36+29",
        batch=64, intermediate_bins=in_band,
        solve_rel_vs_cpu=f"{solve_rel:.3e}", amp_rel_vs_cpu=f"{amp:.3e}",
        strain_rel_vs_cpu=f"{strain:.3e}")


def gw_logl(np, torch, gen, tmp):
    """Phase 22: nmma_generation at full width (a zero-noise injection),
    then the relative-binning joint likelihood of the dump at B = BATCH:
    finite share, evals/s, device-busy ms, idle share, peak memory; card
    against CPU at B = 128; logL at the injection against SNR^2/2; relative
    binning against dense at test_gw.py's five points. Returns (dump,
    likelihood, priors, <d,d>)."""
    import pickle

    from nmma_tpu_torch.cli.joint_main import (build_joint_likelihood,
                                               nmma_generation, unit_cube_logl)
    from nmma_tpu_torch.gw import GWTransientLikelihood, get_waveform

    prior, injection = gw_files(tmp)
    t0 = time.time()
    path = nmma_generation(gw_generation_args(tmp, "gw_logl") + [
        "--prior-file", prior, "--injection-file", injection])
    gen_s = time.time() - t0
    with open(path, "rb") as f:
        dump = pickle.load(f)
    likelihood, priors = build_joint_likelihood(dump, device=DEVICE)
    rb = likelihood.likelihoods[0]
    logl_fn = unit_cube_logl(likelihood, priors)
    u = priors.sample_units(gen, BATCH)
    logl_fn(u[:128])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    logl = logl_fn(u)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    if kernel_launches() != (0, 0, 0):
        raise RuntimeError(f"the GW logL launched K1-K3 {kernel_launches()}")
    if logl.shape != (BATCH,) or torch.isnan(logl).any():
        raise RuntimeError(f"bad GW logL {logl.shape}")
    finite_share = float((logl > -1e29).float().mean())
    if finite_share < 0.99:
        raise RuntimeError(f"only {finite_share} of the GW logL finite")
    logl_ms, calls, round_ms = throughput(torch, lambda: logl_fn(u))
    profiles = []
    for b in (BATCH, SAMPLER_BATCH):
        ms = logl_ms if b == BATCH else throughput(
            torch, lambda: logl_fn(u[:b]))[0]
        busy, n_launch, top, _, _ = device_profile(
            torch, lambda: logl_fn(u[:b]))
        profiles.append((b, ms, busy, n_launch))
        say("gw_profile", batch=b, wall_ms=f"{ms:.4f}",
            device_busy_ms=f"{busy:.4f}", idle_share=f"{1.0 - busy / ms:.4f}",
            kernel_launches=n_launch, top=top)

    # logL at the injection against SNR^2/2 (zero noise), with the dense
    # likelihood's optimal SNR; relative binning against dense near it
    waveform = get_waveform(GW_WAVEFORM)
    dense = GWTransientLikelihood(dump["ifos"], waveform=waveform,
                                  trigger_time=GW_TRIGGER, device=DEVICE)
    points = [GW_INJECTION, {**GW_INJECTION, "mass_1": 1.4802},
              {**GW_INJECTION, "luminosity_distance": 44.0},
              {**GW_INJECTION, "lambda_1": 600.0},
              {**GW_INJECTION, "theta_jn": 0.5}]
    batch = {k: torch.tensor([p[k] for p in points], device=DEVICE)
             for k in GW_INJECTION}
    with torch.no_grad():
        snr = float(dense.optimal_snr(batch)[0])
        rb_five = rb(batch).cpu()
        dense_five = dense(batch).cpu()
    data_power = snr**2
    snr_rel = abs(float(rb_five[0]) - data_power / 2) / (data_power / 2)
    rb_vs_dense = float((rb_five - dense_five).abs().max())
    if snr_rel > GW_SNR_RTOL or rb_vs_dense > GW_RB_ATOL:
        raise RuntimeError(f"GW logL(injection) {float(rb_five[0])} against "
                           f"SNR^2/2 {data_power / 2} ({snr_rel}); relative "
                           f"binning against dense {rb_vs_dense}")

    # the card against the port on the CPU, same unit points
    cpu_lk, cpu_priors = build_joint_likelihood(dump, device="cpu")
    u_small = u[:SAMPLER_BATCH]
    got = logl_fn(u_small).cpu()
    want = unit_cube_logl(cpu_lk, cpu_priors)(u_small.cpu())
    max_d, share = gw_logl_gate(torch, got, want, data_power)
    plain_share = float(((got - want).abs() / (
        LOGL_ATOL + LOGL_RTOL * want.abs())).max())
    say("gw_logl", batch=BATCH, bins=",".join(map(str, rb.n_bins)),
        frequencies=len(dump["ifos"][0].frequencies),
        generation_s=f"{gen_s:.2f}", finite_share=f"{finite_share:.4f}",
        calls=calls, wall_ms=f"{logl_ms:.4f}",
        evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
        evals_per_s_rounds=",".join(f"{BATCH / (ms / 1e3):.1f}"
                                    for ms in round_ms),
        peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
        snr=f"{snr:.4f}", logl_injection=f"{float(rb_five[0]):.4f}",
        snr2_half=f"{data_power / 2:.4f}", snr_rel=f"{snr_rel:.3e}",
        rb_vs_dense_max=f"{rb_vs_dense:.4f}",
        cpu_batch=SAMPLER_BATCH, max_abs_dlogl_vs_cpu=f"{max_d:.4e}",
        gate_share=f"{share:.4f}", plain_gate_share=f"{plain_share:.4f}")
    return dump, likelihood, priors, data_power


def gw_dense(np, torch, gen, dump, priors):
    """Phase 23: the dense likelihood, and the phase + distance + time
    marginalised one, through build_joint_likelihood at B = 1024 and
    BATCH, in chunks: ms, peak memory and the chunk count."""
    from nmma_tpu_torch.cli.joint_main import (build_joint_likelihood,
                                               unit_cube_logl)

    u = priors.sample_units(gen, BATCH)
    for kind, flags in (("dense", {"no_relative_binning": True}),
                        ("marginalized", {"time_marginalization": True,
                                          "phase_marginalization": True,
                                          "distance_marginalization": True})):
        lk, lk_priors = build_joint_likelihood(
            {**dump, "args": {**dump["args"], **flags}}, device=DEVICE)
        gw = lk.likelihoods[0]
        logl_fn = unit_cube_logl(lk, lk_priors)
        for b in (1024, BATCH):
            logl_fn(u[:64])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            logl = logl_fn(u[:b])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            finite = float((logl > -1e29).float().mean())
            if kernel_launches() != (0, 0, 0) or torch.isnan(logl).any() \
                    or finite < 0.99:
                raise RuntimeError(f"{kind} GW logL at B={b}: finite share "
                                   f"{finite}, K1-K3 {kernel_launches()}")
            say("gw_dense", likelihood=kind, batch=b, ms=f"{ms:.2f}",
                evals_per_s=f"{b / (ms / 1e3):.1f}", chunks=gw.n_chunks(b),
                chunk_rows=gw.chunk_rows, peak_mem_mib=f"{peak_mb:.1f}",
                finite_share=f"{finite:.4f}")


def gw_sampler(np, torch, likelihood, priors):
    """Phase 24: nmma_analysis's sampler on the relative-binning likelihood
    (nlive=1024, n_delete=128, walks=24), capped at 40 iterations and 90 s:
    batched logL calls 1 + iterations x walks, finite logZ, no K1-K3
    launch."""
    from nmma_tpu_torch.cli.joint_main import unit_cube_logl
    from nmma_tpu_torch.inference import NestedSampler, NestedSamplerConfig

    logl_fn = unit_cube_logl(likelihood, priors)
    calls = [0]

    def counted(u):
        calls[0] += 1
        return logl_fn(u)

    cfg = NestedSamplerConfig(nlive=1024, n_delete=128, walks=24,
                              max_iter=40, max_seconds=90.0)
    reset_launches()
    t0 = time.time()
    result = NestedSampler(counted, priors.ndim, cfg,
                           device=DEVICE).run(verbose=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    expected = 1 + result.niter * cfg.walks
    if not math.isfinite(result.logz) or calls[0] != expected or \
            kernel_launches() != (0, 0, 0):
        raise RuntimeError(f"GW sampler: logZ {result.logz}, {calls[0]} "
                           f"logL calls (expected {expected}), K1-K3 "
                           f"{kernel_launches()}")
    say("gw_sampler", logz=f"{result.logz:.4f}",
        logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
        logl_calls=calls[0], logl_calls_expected=f"1+{result.niter}x24",
        likelihood_evals=result.ncall, seconds=f"{seconds:.2f}",
        evals_per_s=f"{result.ncall / seconds:.1f}",
        k1_k2_k3_launches=",".join(map(str, kernel_launches())))


def gw_xml_injection(path, injection):
    """A LIGO-LW sim_inspiral table with one row, written with the standard
    library as tests/test_ligolw.py:14-42 does. geocent_end_time is the
    offset from the trigger, which is what both packages' CLIs read
    geocent_time as."""
    cols = {"simulation_id": 0, "mass1": injection["mass_1"],
            "mass2": injection["mass_2"], "spin1x": 0.0, "spin1y": 0.0,
            "spin1z": 0.0, "spin2x": 0.0, "spin2y": 0.0, "spin2z": 0.0,
            "inclination": injection["theta_jn"],
            "coa_phase": injection["phase"],
            "distance": injection["luminosity_distance"],
            "longitude": injection["ra"], "latitude": injection["dec"],
            "polarization": injection["psi"],
            "geocent_end_time": injection["geocent_time"],
            "geocent_end_time_ns": 0.0}
    columns = "\n".join(
        f'      <Column Name="sim_inspiral:{c}" Type="ilwd:char"/>'
        if c == "simulation_id" else
        f'      <Column Name="sim_inspiral:{c}" Type="real_8"/>'
        for c in cols)
    row = ",".join('"sim_inspiral:simulation_id:0"' if c == "simulation_id"
                   else repr(float(v)) for c, v in cols.items())
    with open(path, "w") as f:
        f.write(f"""<?xml version='1.0' encoding='utf-8'?>
<!DOCTYPE LIGO_LW SYSTEM "http://ldas-sw.ligo.caltech.edu/doc/ligolwAPI/html/ligolw_dtd.txt">
<LIGO_LW>
  <Table Name="sim_inspiral:table">
{columns}
      <Stream Name="sim_inspiral:table" Type="Local" Delimiter=",">
      {row}
      </Stream>
  </Table>
</LIGO_LW>
""")


def gw_strain_files(np, torch, tmp, injection, sample_rate=4096.0,
                    psd_duration=256.0, post_trigger=2.0):
    """One .gwf file per detector written by the port's write_gwf: 256 s of
    Gaussian noise of the design PSD (seeded), from which the generation
    estimates the PSD by median Welch, then the 64 s analysis segment with
    the injection projected onto the detector and a zero noise
    realisation. Returns the --strain-files spec."""
    from nmma_tpu_torch.gw import get_detector, get_waveform, write_gwf
    from nmma_tpu_torch.gw.likelihood import as_batch, project_signal
    from nmma_tpu_torch.gw.strain import StrainSeries
    from nmma_tpu_torch.gw.waveforms import aligo_design_psd

    seg_start = GW_TRIGGER + post_trigger - GW_DURATION
    n_seg = int(GW_DURATION * sample_rate)
    n_off = int(psd_duration * sample_rate)
    freqs = np.fft.rfftfreq(n_seg, d=1.0 / sample_rate)
    band = (freqs >= GW_FMIN) & (freqs <= GW_FMAX)
    spec = []
    for k, name in enumerate(GW_DETECTORS.split(",")):
        rng = np.random.default_rng(2017 + k)
        off_f = np.fft.rfftfreq(n_off, d=1.0 / sample_rate)
        psd = aligo_design_psd(off_f)
        amp = np.where(np.isfinite(psd), np.sqrt(psd * psd_duration / 4.0),
                       0.0)
        noise_f = amp * (rng.normal(size=off_f.size)
                         + 1j * rng.normal(size=off_f.size))
        noise = np.fft.irfft(noise_f * sample_rate, n=n_off)
        with torch.no_grad():
            h = project_signal(
                get_detector(name), get_waveform(GW_WAVEFORM),
                torch.as_tensor(freqs[band], dtype=torch.float32,
                                device=DEVICE),
                as_batch(injection, DEVICE), GW_TRIGGER)[0]
        h_f = np.zeros(freqs.size, dtype=np.complex128)
        h_f[band] = h.cpu().numpy()
        # the template convention puts the merger at zero offset; in the
        # segment it sits (duration - post_trigger) after the start
        h_f *= np.exp(-2j * np.pi * freqs * (GW_DURATION - post_trigger))
        signal = np.fft.irfft(h_f * sample_rate, n=n_seg)
        series = StrainSeries(np.concatenate([noise, signal]),
                              seg_start - psd_duration, sample_rate)
        path = os.path.join(tmp, f"{name}.gwf")
        write_gwf(path, {f"{name}:SIM-STRAIN": series})
        spec.append(f"{name}:{path}")
    return ",".join(spec)


def gw_cli(np, torch):
    """Phase 25: nmma_generation on an xml injection and .gwf strain (read,
    median-Welch PSD, Tukey window, FFT), then nmma_analysis in process to
    convergence under a cap; the injection inside the 90% intervals of
    chirp_mass, mass_ratio and luminosity_distance."""
    import json as _json

    from nmma_tpu_torch.cli.joint_main import nmma_analysis, nmma_generation
    from nmma_tpu_torch.conversion import (
        component_masses_to_chirp_mass)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gw_cli_") as tmp:
        prior, _ = gw_files(tmp)
        xml = os.path.join(tmp, "injection.xml")
        gw_xml_injection(xml, GW_INJECTION)
        t0 = time.time()
        strain = gw_strain_files(np, torch, tmp, {
            **GW_INJECTION, "lambda_1": 0.0, "lambda_2": 0.0})
        files_s = time.time() - t0
        t0 = time.time()
        reset_launches()
        dump = nmma_generation(gw_generation_args(tmp, "gw_cli") + [
            "--prior-file", prior, "--injection-file", xml,
            "--strain-files", strain])
        with open(os.path.join(tmp, "outdir",
                               "gw_cli_generation_meta.json")) as f:
            meta = _json.load(f)
        result = nmma_analysis([
            "--data-dump", dump, "--outdir", os.path.join(tmp, "outdir"),
            "--label", "gw_cli", "--nlive", str(GW_CLI_NLIVE),
            "--n-delete", str(GW_CLI_NDELETE),
            "--walks", str(GW_CLI_WALKS), "--dlogz", "0.1",
            "--max-iter", str(GW_CLI_CAP)])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        post = np.load(os.path.join(tmp, "outdir", "gw_cli_result.npz"))
        truth = {"chirp_mass": float(component_masses_to_chirp_mass(
                     torch.tensor(GW_INJECTION["mass_1"]),
                     torch.tensor(GW_INJECTION["mass_2"]))),
                 "mass_ratio": GW_INJECTION["mass_2"] / GW_INJECTION["mass_1"],
                 "luminosity_distance": GW_INJECTION["luminosity_distance"]}
        intervals = {k: np.quantile(post[f"posterior_{k}"], [0.05, 0.95])
                     for k in truth}
    if result.niter >= GW_CLI_CAP or not math.isfinite(result.logz) or \
            kernel_launches() != (0, 0, 0):
        raise RuntimeError(f"the GW CLI run: {result.niter} iterations "
                           f"(cap {GW_CLI_CAP}), logZ {result.logz}, K1-K3 "
                           f"{kernel_launches()}")
    outside = {k: (float(lo), float(hi)) for k, (lo, hi) in intervals.items()
               if not lo <= truth[k] <= hi}
    say("gw_cli", logz=f"{result.logz:.4f}", logz_err=f"{result.logz_err:.4f}",
        iterations=result.niter, cap=GW_CLI_CAP, nlive=GW_CLI_NLIVE,
        n_delete=GW_CLI_NDELETE, walks=GW_CLI_WALKS,
        likelihood_evals=result.ncall,
        seconds=f"{seconds:.2f}", strain_files_s=f"{files_s:.2f}",
        generation_phases_s=",".join(f"{k}={v}" for k, v in
                                     meta["timings_s"].items()),
        test_logl=f"{meta['test_logl']:.4f}", **{
            f"{k}_90": f"{lo:.5f}..{hi:.5f}"
            for k, (lo, hi) in intervals.items()},
        truth=",".join(f"{k}={v:.5f}" for k, v in truth.items()))
    if outside:
        raise RuntimeError(f"the injection lies outside the 90% intervals "
                           f"{outside}")


def gw_path(np, torch):
    """Phases 21-25, the GW-only BNS path: no K1, K2 or K3 launch."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(12)
    gw_waveform(np, torch, gen)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gw_") as tmp:
        dump, likelihood, priors, _ = gw_logl(np, torch, gen, tmp)
        gw_dense(np, torch, gen, dump, priors)
        gw_sampler(np, torch, likelihood, priors)
    gw_cli(np, torch)


# ---------------------------------------------------------------------------
# the joint GW + EM + EOS path (BASELINE config 5)
# ---------------------------------------------------------------------------
SPARSE_ARTIFACT = os.path.join(HERE, "artifacts", "Bu2019lm_sparse_svd.npz")
SPARSE_MODEL = "Bu2019lm_sparse"
# config 5's EM grid: DetectorLightCurveModel's sample_times of
# build_joint_likelihood, geomspace(--em-tmin, --em-tmax, 100)
JOINT_SAMPLE_TIMES = (0.1, 14.0, 100)
JOINT_FILTERS = ("ztfg", "ztfr")


def k1_bound(n_b, n_f, p, h, c, q):
    """(flop, bytes, bound ms, bound_by) of one K1 call: each input read
    once, the output written once, 2 FLOP an FMA."""
    flops = 2.0 * n_b * n_f * (p * h + h * c + c * q)
    n_bytes = 4.0 * (n_b * p + n_f * (p * h + h + h * c + c + c * q + q)
                     + n_b * n_f * q)
    return (flops, n_bytes) + roofline_ms(flops, n_bytes)


def k1_sparse(np, torch, gen):
    """[k1_sparse]: K1 built for P = 2 on the sparse Bu2019lm (H = 128) at
    config 5's grid, against its plain version at B = 1, 128, 8199 and F =
    9 (every trained filter, what the joint path's model evaluates) and F =
    2 (ztfg, ztfr); one launch a call; its time at B = 8192 and 128 beside
    its bound and the plain version's; P = 17 refused before any launch.
    Returns the fields of K1's kernel-line entry."""
    from nmma_tpu_torch.models import SVDModelData
    from nmma_tpu_torch.ops import svd_kernel

    svd = SVDModelData.load(SPARSE_ARTIFACT, device=DEVICE)
    t_days = torch.tensor(np.geomspace(*JOINT_SAMPLE_TIMES),
                          dtype=torch.float32, device=DEVICE)
    va_q, off_q, _ = svd.operator_rankc(t_days)
    full = (svd.w1, svd.b1, svd.w2, svd.b2, va_q, off_q)
    pick = torch.tensor([svd.filters.index(f) for f in JOINT_FILTERS],
                        device=DEVICE)
    two = tuple(a[pick].contiguous() for a in full)
    _, p, h = svd.w1.shape
    c, q = svd.w2.shape[2], va_q.shape[2]
    if (p, h, c) != (2, 128, 10):
        raise RuntimeError(f"the sparse surrogate is P={p}, H={h}, C={c}")
    fields, max_err = {}, 0.0
    for n_f, weights in ((svd.w1.shape[0], full), (len(JOINT_FILTERS), two)):
        for b in (1, 128, BATCH + 7):
            x = torch.rand((b, p), generator=gen, device=DEVICE)
            before = k1_launches()
            got = svd_kernel.svd_surrogate_mags(x, *weights)
            launched = k1_launches() - before
            want = svd_kernel.svd_surrogate_mags_plain(x, *weights)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if got.shape != want.shape or launched != 1 \
                    or not math.isfinite(err) or err > K1_TOL:
                raise RuntimeError(
                    f"K1 (P=2) at B={b}, F={n_f}: max abs err {err} "
                    f"(tolerance {K1_TOL} mag), {launched} launches")
            max_err = max(max_err, err)
            say("k1_sparse", batch=b, filters=n_f, launches=launched,
                max_abs_err=f"{err:.3e}")
        x = torch.rand((SAMPLER_BATCH, p), generator=gen, device=DEVICE)
        ms_small, windows = kernel_device_windows(
            torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights),
            "svd_mlp_mags_kernel")
        x = torch.rand((BATCH, p), generator=gen, device=DEVICE)
        ms = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights))
        plain = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags_plain(
            x, *weights))
        flops, n_bytes, bound, bound_by = k1_bound(BATCH, n_f, p, h, c, q)
        small_bound = k1_bound(SAMPLER_BATCH, n_f, p, h, c, q)[2]
        say("k1_sparse", batch=BATCH, filters=n_f, p=p, h=h, c=c, q=q,
            kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            bound_share=f"{bound / ms:.4f}", gflop=f"{flops / 1e9:.4f}",
            mbytes=f"{n_bytes / 1e6:.4f}",
            kernel_ms_b128=f"{ms_small:.4f}", timed_by_b128="profiler",
            profiled_windows_b128=windows, bound_ms_b128=f"{small_bound:.4f}")
        tag = f"sparse_f{n_f}"
        fields.update({f"{tag}_ms": ms, f"{tag}_ms_sampler_batch": ms_small,
                       f"{tag}_plain_ms": plain, f"{tag}_bound_ms": bound,
                       f"{tag}_bound_by": bound_by})
    # a P outside the kernels' range: refused before any launch
    before = k1_launches()
    w1_17 = torch.zeros((2, 17, h), device=DEVICE)
    try:
        svd_kernel.svd_surrogate_mags(
            torch.zeros((4, 17), device=DEVICE), w1_17, *two[1:])
    except ValueError as err:
        refused = str(err)
    else:
        raise RuntimeError("K1 took P=17")
    if k1_launches() != before:
        raise RuntimeError("K1 launched for P=17")
    from nmma_tpu_torch import _kernels
    for entry, summary in ptxas_entries(
            _kernels.REPORTS.get("svd_mlp", "")).items():
        say("ptxas", library="svd_mlp", entry=entry, **summary)
    say("k1_sparse", refused_p17=repr(refused), max_abs_err=f"{max_err:.3e}",
        specialised=",".join(f"P{p}C{c}" for p, c in svd_kernel.SPECIALISED))
    fields["sparse_max_abs_err"] = max_err
    return fields


# config 5 (scripts/bench_joint_pe.py:21-52): its injection and prior; the
# EOS set is made here (the reference's eos_macro directory is not in the
# repo), from a numpy crust under NEP cores of these symmetry-energy slopes
JOINT_INJECTION = {
    "chirp_mass": 1.1977, "mass_ratio": 0.9, "luminosity_distance": 40.0,
    "EOS": 4.2, "ratio_zeta": 0.3, "alpha": 5e-5, "theta_jn": 0.4,
    "phase": 1.3, "psi": 1.5, "ra": 3.446, "dec": -0.408,
    "geocent_time": 0.0, "timeshift": 0.0}
JOINT_PRIOR_TEXT = """\
chirp_mass = Uniform(minimum=1.18, maximum=1.21)
mass_ratio = Uniform(minimum=0.6, maximum=1.0)
luminosity_distance = Uniform(minimum=10., maximum=100.)
EOS = Uniform(minimum=0., maximum=10.)
ratio_zeta = Uniform(minimum=0., maximum=0.5)
alpha = 5e-5
theta_jn = 0.4
phase = 1.3
psi = 1.5
ra = 3.446
dec = -0.408
geocent_time = 0.0
timeshift = 0.0
"""
EOS_SLOPES = tuple(40.0 + 50.0 * i / 9 for i in range(10))   # L [MeV]
# the EOS family card against CPU: M and R relative on the stable branch;
# k2 and so Lambda from 1.0 Msun, where f32 k2 loses ~C^-4 ulps to the
# cancellation in its denominator (tests/test_torch_eos.py)
EOS_MR_RTOL, EOS_LAMBDA_RTOL, EOS_LAMBDA_FROM = 1e-5, 5e-3, 1.0
# [joint_cli]: bench_joint_pe.py's nlive=1024, walks=16 and dlogz=0.1;
# n_delete a quarter of the live set as [gw_cli] takes it (the default is
# an eighth), and an iteration cap
JOINT_CLI_NLIVE, JOINT_CLI_NDELETE, JOINT_CLI_WALKS = 1024, 256, 16
JOINT_CLI_CAP = 600


def crust_table(np, n_rows=120, n_max=0.0999, p_top=0.3, gamma=4.0 / 3.0):
    """(n [fm^-3], p, eps [MeV fm^-3]) rows of a polytropic crust below the
    NEP core's 0.1 fm^-3. A copy of tests/test_torch_eos.py:crust_table
    (which imports JAX, so the smoke cannot import it): keep the two in
    step, so that the smoke and the tests build the same EOS family."""
    n = np.geomspace(1e-8, n_max, n_rows)
    p = p_top * (n / 0.1) ** gamma
    return np.column_stack([n, p, n * 939.565 + p / (gamma - 1.0)])


def eos_path(np, torch, gen, tmp):
    """[eos]: the port's TOV solver builds the EOS family of config 5 on
    the card (10 NEP tables on the numpy crust, 64 central pressures each,
    all in one RK4 loop), held against the same call on the CPU, and writes
    the macro files; then load_macro_eos_set and the TabulatedEOSSet step
    at B = BATCH. Returns the macro directory."""
    from nmma_tpu_torch.eos import (construct_families, eos_from_nep,
                                    load_macro_eos_set, nep_eos_table)

    tables = [nep_eos_table(32.0, slope, crust_table(np))
              for slope in EOS_SLOPES]
    t0 = time.time()
    card = construct_families(tables, device=DEVICE)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    t0 = time.time()
    cpu = construct_families(tables, device="cpu")
    cpu_s = time.time() - t0
    eos_dir = os.path.join(tmp, "eos")
    os.makedirs(eos_dir)
    worst = {"m": 0.0, "r": 0.0, "lambda": 0.0}
    for i, ((r, m, lam, _), (r0, m0, lam0, _)) in enumerate(zip(card, cpu)):
        r, m, lam = (a.cpu().numpy() for a in (r, m, lam))
        r0, m0, lam0 = (a.numpy() for a in (r0, m0, lam0))
        stable = slice(0, int(np.argmax(m0)) + 1)
        heavy = m0[stable] >= EOS_LAMBDA_FROM
        errs = {"m": np.abs(m / m0 - 1)[stable].max(),
                "r": np.abs(r / r0 - 1)[stable].max(),
                "lambda": np.abs(lam / lam0 - 1)[stable][heavy].max()}
        worst = {k: max(worst[k], float(v)) for k, v in errs.items()}
        np.savetxt(os.path.join(eos_dir, f"{i}.dat"),
                   np.column_stack([r, m, lam]))
    if not (worst["m"] <= EOS_MR_RTOL and worst["r"] <= EOS_MR_RTOL
            and worst["lambda"] <= EOS_LAMBDA_RTOL):
        raise RuntimeError(f"the EOS family on the card against the CPU: "
                           f"{worst}")
    # the maximum-mass resampler's tables ([resampling]): macro (R, M,
    # Lambda, P_c) on each stable branch, micro (n, eps, p, cs2)
    for kind in ("macro", "micro"):
        os.makedirs(os.path.join(tmp, "baryonic", kind))
    for i, (slope, (r, m, lam, pc)) in enumerate(zip(EOS_SLOPES, card)):
        n, p, eps = eos_from_nep(32.0, slope, crust_table(np)).T
        m = m.cpu().numpy()
        stable = slice(0, int(np.argmax(m)) + 1)
        np.savetxt(os.path.join(tmp, "baryonic", "macro", f"{i}.dat"),
                   np.column_stack([r.cpu().numpy(), m, lam.cpu().numpy(),
                                    pc.cpu().numpy()])[stable])
        np.savetxt(os.path.join(tmp, "baryonic", "micro", f"{i}.dat"),
                   np.column_stack([n, eps, p, np.gradient(p, eps)]))
    t0 = time.time()
    eos_set = load_macro_eos_set(eos_dir)
    load_ms = 1e3 * (time.time() - t0)
    if not 2.0 < float(eos_set.tov_mass.min()) <= \
            float(eos_set.tov_mass.max()) < 2.5:
        raise RuntimeError(f"TOV masses {eos_set.tov_mass}")
    u = torch.rand((3, BATCH), generator=gen, device=DEVICE)
    params = {"EOS": 10.0 * u[0], "mass_1_source": 1.0 + 1.5 * u[1],
              "mass_2_source": 1.0 + 0.6 * u[2]}
    out = eos_set(params)
    if not (torch.isfinite(out["radius_1"]).all()
            and bool((out["radius_1"] == 0).any())):
        raise RuntimeError("the TabulatedEOSSet step lost its BH rows")
    step_ms = time_ms(torch, lambda: eos_set(params))
    say("eos", tables=len(tables), central_pressures=64,
        card_s=f"{card_s:.3f}", cpu_s=f"{cpu_s:.3f}",
        tov_mass=",".join(f"{m:.4f}" for m in eos_set.tov_mass),
        max_rel_m=f"{worst['m']:.3e}", max_rel_r=f"{worst['r']:.3e}",
        max_rel_lambda_from_1msun=f"{worst['lambda']:.3e}",
        load_macro_ms=f"{load_ms:.3f}", eos_step_ms=f"{step_ms:.4f}",
        eos_step_batch=BATCH)
    return eos_dir


def joint_files(tmp):
    from nmma_tpu_torch.injections import write_injection_file

    prior = os.path.join(tmp, "config5.prior")
    with open(prior, "w") as f:
        f.write(JOINT_PRIOR_TEXT)
    injection = os.path.join(tmp, "config5.json")
    write_injection_file(injection, {k: [v] for k, v in
                                     JOINT_INJECTION.items()})
    return prior, injection


def joint_generation_args(tmp, label, eos_dir):
    """nmma-generation flags of config 5 (bench_joint_pe.py:47-52)."""
    prior, injection = joint_files(tmp)
    return gw_generation_args(tmp, label) + [
        "--prior-file", prior, "--injection-file", injection,
        "--eos-data", eos_dir, "--em-model", SPARSE_MODEL,
        "--svd-path", SPARSE_ARTIFACT]


def joint_gate(torch, likelihood, params, got, want, data_power):
    """Sentinels identical and |got - want| within the GW gate of the GW
    term plus the EM gate of the EM term (the card's terms); returns (max
    |dlogL|, largest share of the gate used)."""
    if not torch.equal(got > -1e29, want > -1e29):
        raise RuntimeError("joint logL sentinel positions differ")
    with torch.no_grad():
        conv = likelihood.conversion(params)
        gw = likelihood.likelihoods[0](conv).cpu()
        em = likelihood.likelihoods[1](conv).cpu()
    ok = want > -1e29
    d = (got - want)[ok].abs()
    allowed = (LOGL_ATOL + LOGL_RTOL * gw[ok].abs()
               + GW_PHASE_ULP * data_power) \
        + (LOGL_ATOL + LOGL_RTOL * em[ok].abs())
    share = float((d / allowed).max())
    if share > 1.0:
        raise RuntimeError(f"joint logL off by {float(d.max())} (gate "
                           f"share {share:.3f})")
    return float(d.max()), share


def joint_logl(np, torch, gen, tmp, eos_dir):
    """[joint_logl]: config 5's joint likelihood (GW relative binning + the
    sparse Bu2019lm through K1 + the tabulated EOS) of a full-width dump at
    B = BATCH and the sampler's B: evals/s, launches, idle share, peak
    memory, one K1 launch a call and no K2/K3; the card against the port
    on the CPU at the sampler's B (the GW gate plus the EM gate)."""
    import pickle

    from nmma_tpu_torch.cli.joint_main import (build_joint_likelihood,
                                               nmma_generation, unit_cube_logl)
    from nmma_tpu_torch.gw import GWTransientLikelihood, get_waveform

    t0 = time.time()
    path = nmma_generation(joint_generation_args(tmp, "joint_logl",
                                                 eos_dir))
    gen_s = time.time() - t0
    with open(path, "rb") as f:
        dump = pickle.load(f)
    likelihood, priors = build_joint_likelihood(dump, device=DEVICE)
    names = [type(t).__name__ for t in likelihood.likelihoods]
    if names != ["RelativeBinningGWLikelihood", "EMLikelihood"]:
        raise RuntimeError(f"config 5's likelihood terms: {names}")
    logl_fn = unit_cube_logl(likelihood, priors)
    u = priors.sample_units(gen, BATCH)
    logl_fn(u[:JOINT_CLI_NDELETE])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    launches = {}
    for b in (BATCH, JOINT_CLI_NDELETE):
        reset_launches()
        logl = logl_fn(u[:b])
        torch.cuda.synchronize()
        launches[b] = kernel_launches()
        if launches[b] != (1, 0, 0):
            raise RuntimeError(f"the joint logL at B={b} launched K1-K3 "
                               f"{launches[b]}, not (1, 0, 0)")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    logl = logl_fn(u)
    if logl.shape != (BATCH,) or torch.isnan(logl).any():
        raise RuntimeError(f"bad joint logL {logl.shape}")
    finite_share = float((logl > -1e29).float().mean())
    if finite_share < 0.9:
        raise RuntimeError(f"only {finite_share} of the joint logL finite")
    logl_ms, calls, round_ms = throughput(torch, lambda: logl_fn(u))
    for b in (BATCH, JOINT_CLI_NDELETE):
        ms = logl_ms if b == BATCH else throughput(
            torch, lambda: logl_fn(u[:b]))[0]
        busy, n_launch, top, k1_ms, k1_n = device_profile(
            torch, lambda: logl_fn(u[:b]), "svd_mlp_mags_kernel")
        say("joint_profile", batch=b, wall_ms=f"{ms:.4f}",
            evals_per_s=f"{b / (ms / 1e3):.1f}",
            device_busy_ms=f"{busy:.4f}", idle_share=f"{1.0 - busy / ms:.4f}",
            kernel_launches=n_launch, k1_device_ms=f"{k1_ms:.4f}",
            k1_launches=k1_n, top=top)

    # <d,d> of the zero-noise data: the optimal SNR^2 at the injection
    fid = dump["fiducial"]
    dense = GWTransientLikelihood(dump["ifos"], waveform=get_waveform(
        GW_WAVEFORM), trigger_time=GW_TRIGGER, device=DEVICE)
    with torch.no_grad():
        snr = float(dense.optimal_snr({k: torch.tensor(
            [v], device=DEVICE) for k, v in fid.items()})[0])
    cpu_lk, cpu_priors = build_joint_likelihood(dump, device="cpu")
    u_small = u[:JOINT_CLI_NDELETE]
    got = logl_fn(u_small).cpu()
    want = unit_cube_logl(cpu_lk, cpu_priors)(u_small.cpu())
    with torch.no_grad():
        params = priors.transform(u_small)
    max_d, share = joint_gate(torch, likelihood, params, got, want, snr**2)
    say("joint_logl", batch=BATCH, generation_s=f"{gen_s:.2f}",
        terms=",".join(names), finite_share=f"{finite_share:.4f}",
        calls=calls, wall_ms=f"{logl_ms:.4f}",
        evals_per_s=f"{BATCH / (logl_ms / 1e3):.1f}",
        evals_per_s_rounds=",".join(f"{BATCH / (ms / 1e3):.1f}"
                                    for ms in round_ms),
        k1_k2_k3_launches_a_call=",".join(map(str, launches[BATCH])),
        peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
        snr=f"{snr:.4f}", cpu_batch=JOINT_CLI_NDELETE,
        max_abs_dlogl_vs_cpu=f"{max_d:.4e}", gate_share=f"{share:.4f}")


def joint_cli(np, torch, eos_dir):
    """[joint_cli]: config 5 through nmma_generation and nmma_analysis in
    process to convergence: K1 launches exactly 2 + 1 + iterations x walks
    (the injection's light curve and the test logL of the generation, the
    initial live set, one batch a walk step), no K2/K3; logZ, seconds, and
    the injection inside the 90% intervals of chirp_mass, mass_ratio and
    luminosity_distance, its EOS index inside that of EOS_index. Returns
    the run's K1 launches."""
    import json as _json

    from nmma_tpu_torch.cli.joint_main import nmma_analysis, nmma_generation

    with tempfile.TemporaryDirectory(prefix="chip_smoke_joint_cli_") as tmp:
        outdir = os.path.join(tmp, "outdir")
        reset_launches()
        t0 = time.time()
        dump = nmma_generation(joint_generation_args(tmp, "joint_cli",
                                                     eos_dir))
        gen_s = time.time() - t0
        with open(os.path.join(outdir, "joint_cli_generation_meta.json")) \
                as f:
            meta = _json.load(f)
        result = nmma_analysis([
            "--data-dump", dump, "--outdir", outdir, "--label", "joint_cli",
            "--nlive", str(JOINT_CLI_NLIVE),
            "--n-delete", str(JOINT_CLI_NDELETE),
            "--walks", str(JOINT_CLI_WALKS), "--dlogz", "0.1",
            "--max-iter", str(JOINT_CLI_CAP)])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = kernel_launches()
        post = np.load(os.path.join(outdir, "joint_cli_result.npz"))
        truth = {"chirp_mass": JOINT_INJECTION["chirp_mass"],
                 "mass_ratio": JOINT_INJECTION["mass_ratio"],
                 "luminosity_distance":
                     JOINT_INJECTION["luminosity_distance"],
                 "EOS_index": math.floor(JOINT_INJECTION["EOS"])}
        intervals = {k: np.quantile(post[f"posterior_{k}"], [0.05, 0.95])
                     for k in truth}
    expected = 3 + result.niter * JOINT_CLI_WALKS
    if result.niter >= JOINT_CLI_CAP or not math.isfinite(result.logz) or \
            launches != (expected, 0, 0):
        raise RuntimeError(f"the joint CLI run: {result.niter} iterations "
                           f"(cap {JOINT_CLI_CAP}), logZ {result.logz}, "
                           f"K1-K3 {launches}, K1 expected {expected}")
    outside = {k: (float(lo), float(hi)) for k, (lo, hi) in intervals.items()
               if not lo <= truth[k] <= hi}
    say("joint_cli", logz=f"{result.logz:.4f}",
        logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
        cap=JOINT_CLI_CAP, nlive=JOINT_CLI_NLIVE, n_delete=JOINT_CLI_NDELETE,
        walks=JOINT_CLI_WALKS, likelihood_evals=result.ncall,
        seconds=f"{seconds:.2f}", generation_s=f"{gen_s:.2f}",
        k1_launches=launches[0],
        k1_expected=f"3+{result.niter}x{JOINT_CLI_WALKS}",
        generation_phases_s=",".join(f"{k}={v}" for k, v in
                                     meta["timings_s"].items()),
        test_logl=f"{meta['test_logl']:.4f}", **{
            f"{k}_90": f"{lo:.5f}..{hi:.5f}"
            for k, (lo, hi) in intervals.items()},
        truth=",".join(f"{k}={v}" for k, v in truth.items()))
    if outside:
        raise RuntimeError(f"the injection lies outside the 90% intervals "
                           f"{outside}")
    return launches[0]


def joint_reweight(np, torch, tmp, eos_dir):
    """[joint_reweight]: one config-5 generation with --eos-reweight and a
    lower-MTOV constraint: the sorted directory and weights, and a finite
    test logL."""
    import json as _json
    import pickle

    from nmma_tpu_torch.cli.joint_main import nmma_generation

    t0 = time.time()
    path = nmma_generation(joint_generation_args(tmp, "joint_reweight",
                                                 eos_dir)
                           + ["--eos-reweight", "--lower-mtov", "2.1,0.05"])
    seconds = time.time() - t0
    with open(path, "rb") as f:
        dump = pickle.load(f)
    with open(os.path.join(tmp, "outdir",
                           "joint_reweight_generation_meta.json")) as f:
        meta = _json.load(f)
    weights = np.loadtxt(dump["eos_weights"])
    files = sorted(os.listdir(dump["eos_data"]))
    if len(files) != len(EOS_SLOPES) or len(weights) != len(files) or \
            not np.all(np.diff(weights) >= 0) or \
            abs(weights.sum() - 1.0) > 1e-9 or dump["eos_constraints"] or \
            not math.isfinite(meta["test_logl"]):
        raise RuntimeError(f"the reweighting wrote {files}, weights "
                           f"{weights}, test logL {meta['test_logl']}")
    say("joint_reweight", seconds=f"{seconds:.2f}", sorted_files=len(files),
        weights=",".join(f"{w:.4g}" for w in weights),
        test_logl=f"{meta['test_logl']:.4f}")


def joint_path(np, torch, tmp):
    """The joint GW + EM + EOS path of config 5: [k1_sparse], [eos],
    [joint_logl], [joint_reweight], [joint_cli], with the EOS tables made
    under ``tmp`` (the post-processing phases read them later). Returns
    K1's fields for the kernel line."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    fields = k1_sparse(np, torch, gen)
    eos_dir = eos_path(np, torch, gen, tmp)
    joint_logl(np, torch, gen, tmp, eos_dir)
    joint_reweight(np, torch, tmp, eos_dir)
    fields["launches_joint_cli"] = joint_cli(np, torch, eos_dir)
    return fields


# ---------------------------------------------------------------------------
# fiesta surrogates, FITS sky maps, POSSIS spectra and the post-processing
# (no K1-K3 on the fiesta, FITS-prior, POSSIS and resampling paths; the
# [fits] and [marginalisation] runs evaluate Bu2019lm through K1)
# ---------------------------------------------------------------------------
# seeded fiesta surrogates at shapes this repo assumes (no fiesta weights are
# in the repo): the lightcurve kind at the production Bu2019lm surrogate's
# filters, parameters, supports and time grid; the flux kind on TrPi2018's
# parameters with alphaWing, FIESTA_NU log-spaced frequencies over the GRB
# filters and FIESTA_FLUX_TIMES times; both with two hidden layers of
# FIESTA_HIDDEN units
FIESTA_HIDDEN = 2048
FIESTA_NU = 64
FIESTA_FLUX_TIMES = 100
FIESTA_MODEL = "fiesta_lc_smoke"
FIESTA_CLI_MODEL = "fiesta_cli_smoke"
# PRIOR_TEXT inside the production surrogate's trained support, which the
# fiesta support guard holds the CLI's prior to
FIESTA_PRIOR_TEXT = """\
log10_mej_dyn = Uniform(minimum=-3., maximum=-1.7)
log10_mej_wind = Uniform(minimum=-2., maximum=-0.9)
KNphi = Uniform(minimum=15., maximum=75.)
KNtheta = Uniform(minimum=0., maximum=90.)
luminosity_distance = Uniform(minimum=1., maximum=200.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
# the flux kind's inputs and their supports; epsilon_e reaches 1, so the
# epsilon_e + epsilon_B <= 1 gate closes on part of the prior, and
# alphaWing x thetaCore passes pi/2 on another part
FIESTA_FLUX_SUPPORT = {
    "inclination_EM": (0.0, 0.5), "log10_E0": (49.0, 54.0),
    "thetaCore": (0.01, 0.3), "alphaWing": (1.0, 10.0),
    "log10_n0": (-4.0, 1.0), "p": (2.01, 2.9),
    "log10_epsilon_e": (-3.0, 0.0), "log10_epsilon_B": (-5.0, -0.5)}
FIESTA_MAG_TOL = 1e-4        # mag, card against CPU: the models' gate
FIESTA_CPU_BATCH = 128
FIESTA_FLUX_CPU_BATCH = 512
FIESTA_CLI_NLIVE = 512
# the seeded POSSIS spectrum: viewing angles, wavelengths, times
POSSIS_SHAPE = (4, 500, 50)
POSSIS_MODEL = "possis_smoke"
POSSIS_FILTERS = ["ztfg", "ztfr", "ztfi", "2massj"]
POSSIS_PRIOR_TEXT = """\
supernova_mag_boost = Uniform(minimum=-1., maximum=1.)
luminosity_distance = Uniform(minimum=10., maximum=200.)
timeshift = Uniform(minimum=-0.5, maximum=0.5)
"""
POSSIS_INJECTION = {"supernova_mag_boost": 0.0, "luminosity_distance": 40.0,
                    "timeshift": 0.0}
# [marginalisation]: seeded GW posterior samples, percentile bands within
# FIESTA_MAG_TOL of the port on the CPU
MARG_SAMPLES = 2000
# [resampling]: nested runs capped at this many iterations, and the
# baryonic tables' mass grid (0.1 Msun steps)
RESAMPLING_ITERATIONS = 40
BARYONIC_GRID = (0.8, 2.6, 19)


def smooth_basis(np, *axes, degree=4):
    """Products of Legendre polynomials P_k of degree k < ``degree`` in
    each axis's log, scaled to [-1, 1], each damped by 1 / (1 + k)^2:
    [degree**len(axes), prod(len(axis))]."""
    from numpy.polynomial import legendre

    per_axis = []
    for axis in axes:
        x = np.log(axis)
        x = 2.0 * (x - x[0]) / (x[-1] - x[0]) - 1.0
        per_axis.append(np.stack([legendre.legval(x, np.eye(degree)[k])
                                  / (1.0 + k) ** 2 for k in range(degree)]))
    basis = per_axis[0]
    for b in per_axis[1:]:
        basis = np.einsum("ai,bj->abij", basis, b).reshape(
            basis.shape[0] * b.shape[0], -1)
    return basis.astype(np.float32)


def seeded_mlp(np, rng, dims, basis, stacks=()):
    """(kernels, biases) of a ReLU MLP with N(0, 1/d_in) weights whose last
    layer maps onto ``basis`` [K, n_out]: each output row a smooth curve
    (in time, and in frequency for the flux kind), as a trained
    surrogate's are; ``stacks`` leads every shape (one net a filter)."""
    def normal(*shape):
        return rng.standard_normal(stacks + shape, dtype=np.float32)

    kernels = [normal(a, b) / np.float32(np.sqrt(a))
               for a, b in zip(dims[:-2], dims[1:-1])]
    biases = [0.1 * normal(b) for b in dims[1:-1]]
    k = basis.shape[0]
    kernels.append(normal(dims[-2], k) / np.float32(np.sqrt(dims[-2] * k))
                   @ basis)
    biases.append(0.1 * normal(k) @ basis / np.float32(np.sqrt(k)))
    return tuple(kernels), tuple(biases)


def fiesta_lightcurve_fields(np, name, seed=14):
    """The numpy fields of a lightcurve-kind FiestaSurrogateData at the
    production Bu2019lm surrogate's filters, parameters, supports and time
    grid: per-filter MLPs P -> H -> H -> T (H = FIESTA_HIDDEN), each
    output a smooth curve in log time, scaled to absolute magnitudes
    around -17..-9."""
    with np.load(ARTIFACT) as z:
        filters = tuple(str(f) for f in z["filters"])
        names = tuple(str(p) for p in z["parameter_names"])
        lo, hi, times = z["param_mins"], z["param_maxs"], z["tt"]
    rng = np.random.default_rng(seed)
    n_f, n_t = len(filters), len(times)
    kernels, biases = seeded_mlp(
        np, rng, [len(names), FIESTA_HIDDEN, FIESTA_HIDDEN, n_t],
        smooth_basis(np, times), stacks=(n_f,))
    return dict(
        name=name, kind="lightcurve", parameter_names=names,
        parameter_distributions={n: (float(a), float(b))
                                 for n, a, b in zip(names, lo, hi)},
        times=times, x_min=lo, x_max=hi, kernels=kernels, biases=biases,
        y_min=np.full((n_f, n_t), -17.0), y_max=np.full((n_f, n_t), -9.0),
        filters=filters)


def fiesta_flux_fields(np, seed=15):
    """The numpy fields of a flux-kind FiestaSurrogateData on TrPi2018's
    parameters with alphaWing: one MLP 8 -> H -> H -> Nu x T whose output
    is a smooth surface in log frequency and log time (a spectrum, as a
    trained surrogate's), log10 F_nu [mJy at 10 pc] around 10..14, on
    FIESTA_NU frequencies over 1e9 to 1e18 Hz (the GRB filters redshifted)
    and FIESTA_FLUX_TIMES times in 0.05-40 d."""
    names = tuple(FIESTA_FLUX_SUPPORT)
    lo, hi = (np.array([v[i] for v in FIESTA_FLUX_SUPPORT.values()])
              for i in (0, 1))
    rng = np.random.default_rng(seed)
    nus = np.geomspace(1e9, 1e18, FIESTA_NU)
    times = np.geomspace(0.05, 40.0, FIESTA_FLUX_TIMES)
    n_out = FIESTA_NU * FIESTA_FLUX_TIMES
    kernels, biases = seeded_mlp(
        np, rng, [len(names), FIESTA_HIDDEN, FIESTA_HIDDEN, n_out],
        smooth_basis(np, nus, times))
    return dict(
        name="fiesta_flux_smoke", kind="flux", parameter_names=names,
        parameter_distributions=dict(FIESTA_FLUX_SUPPORT), times=times,
        x_min=lo, x_max=hi, kernels=kernels, biases=biases,
        y_min=np.full(n_out, 10.0), y_max=np.full(n_out, 14.0), nus=nus)


def logl_profile(torch, phase, fn, u, batches):
    """[phase] lines: wall ms (host clock over >= 2 s of back-to-back
    calls), evals/s, device-busy ms, launches and idle share of ``fn`` at
    each batch size, and the peak memory of one call."""
    for b in batches:
        ub = u[:b]
        fn(ub)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        fn(ub)
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        ms, calls, round_ms = throughput(torch, lambda: fn(ub))
        busy, n_launch, top, _, _ = device_profile(torch, lambda: fn(ub))
        say(phase, batch=b, calls=calls, wall_ms=f"{ms:.4f}",
            evals_per_s=f"{b / (ms / 1e3):.1f}",
            evals_per_s_rounds=",".join(
                f"{b / (r / 1e3):.1f}" for r in round_ms),
            device_busy_ms=f"{busy:.4f}",
            idle_share=f"{1.0 - busy / ms:.4f}", kernel_launches=n_launch,
            peak_mem_mib=f"{peak_mb:.1f}", base_mem_mib=f"{base_mb:.1f}",
            top=top)


def compare_mags(torch, phase, got, want):
    """Card magnitudes against the CPU's: inf in the same places, the rest
    within FIESTA_MAG_TOL; returns (max |dmag|, finite count)."""
    got = got.cpu()
    if got.shape != want.shape or not torch.equal(torch.isinf(got),
                                                  torch.isinf(want)):
        raise RuntimeError(f"[{phase}] inf positions differ between the card "
                           "and the CPU")
    ok = torch.isfinite(want)
    if not bool(ok.any()) or torch.isnan(got).any():
        raise RuntimeError(f"[{phase}] no finite magnitude, or NaN")
    dmag = float((got - want)[ok].abs().max())
    if dmag > FIESTA_MAG_TOL:
        raise RuntimeError(f"[{phase}] the card's magnitudes are {dmag} off "
                           "the CPU's")
    return dmag, int(ok.sum())


def fiesta_lc(np, torch, gen, tmp):
    """[fiesta_lc]: the lightcurve-kind surrogate at production shapes
    through EMAnalysis.batched_logl at B = BATCH and the sampler's batch,
    on photometry it makes at INJECTION; the card against the port on the
    CPU at B = FIESTA_CPU_BATCH. Returns (fields, photometry path)."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.models import (fiesta_from_numpy,
                                       make_fiesta_source_model)

    t0 = time.time()
    fields = fiesta_lightcurve_fields(np, FIESTA_MODEL)
    data = fiesta_from_numpy(fields, device=DEVICE)
    build_s = time.time() - t0
    make_fiesta_source_model(FIESTA_MODEL, data)
    filters = list(fields["filters"])
    data_path = os.path.join(tmp, "fiesta_injection.dat")
    prior_path = os.path.join(tmp, "fiesta.prior")
    with open(prior_path, "w") as f:
        f.write(FIESTA_PRIOR_TEXT)
    synthetic_photometry(np, torch, FIESTA_MODEL, filters, data_path,
                         INJECTION, sample_times=(0.2, 14.0, 100),
                         epochs=(0.5, 12.0))
    cfg = EMAnalysisConfig(
        model=FIESTA_MODEL, prior_file=prior_path, light_curve_data=data_path,
        trigger_time=TRIGGER_MJD, data_tmax=12.5, tmin=0.2, tmax=14.0,
        filters=filters, outdir=os.path.join(tmp, "fiesta_outdir"))
    analysis = EMAnalysis(cfg, device=DEVICE)
    u = analysis.priors.sample_units(gen, BATCH)
    reset_launches()
    logl = analysis.batched_logl(u)
    torch.cuda.synchronize()
    if kernel_launches() != (0, 0, 0):
        raise RuntimeError(f"[fiesta_lc] launched K1-K3 {kernel_launches()}")
    if logl.shape != (BATCH,) or torch.isnan(logl).any():
        raise RuntimeError(f"bad fiesta logL {logl.shape}")
    usable = logl > -1e29
    logl_inj = float(analysis.batched_logl(
        injection_units(analysis.priors, INJECTION))[0])
    if not (float(usable.float().mean()) > 0.5
            and logl_inj > float(logl[usable].median())):
        raise RuntimeError(f"[fiesta_lc] finite share "
                           f"{float(usable.float().mean())}, injection logL "
                           f"{logl_inj}")
    logl_profile(torch, "fiesta_lc", analysis.batched_logl, u,
                 (BATCH, SAMPLER_BATCH))

    # the card against the port on the CPU, on the same live points
    on_cpu = EMAnalysis(cfg, device="cpu")
    u_small = u[:FIESTA_CPU_BATCH]
    params = analysis.priors.transform(u_small)
    dmag, n_fin = compare_mags(
        torch, "fiesta_lc", analysis.model(params)[1],
        on_cpu.model({k: v.cpu() for k, v in params.items()})[1])
    got = analysis.batched_logl(u_small).cpu()
    want = on_cpu.batched_logl(u_small.cpu())
    if not torch.equal(got > -1e29, want > -1e29):
        raise RuntimeError("[fiesta_lc] sentinels differ from the CPU's")
    ok = want > -1e29
    dlogl = (got - want)[ok].abs()
    if bool((dlogl > LOGL_ATOL + LOGL_RTOL * want[ok].abs()).any()):
        raise RuntimeError(f"[fiesta_lc] logL {float(dlogl.max())} off the "
                           "CPU's")
    say("fiesta_lc", filters=len(filters), parameters=len(
        fields["parameter_names"]), hidden=FIESTA_HIDDEN,
        times=len(fields["times"]), build_s=f"{build_s:.3f}",
        finite_share=f"{float(usable.float().mean()):.4f}",
        k1_k2_k3_launches="0,0,0", cpu_batch=FIESTA_CPU_BATCH,
        max_abs_dmag_vs_cpu=f"{dmag:.3e}", finite_mags=n_fin,
        max_abs_dlogl_vs_cpu=f"{float(dlogl.max()):.3e}",
        logl_injection=f"{logl_inj:.3f}",
        logl_median=f"{float(logl[usable].median()):.3f}")
    return fields, data_path


def fiesta_flux(np, torch, gen):
    """[fiesta_flux]: the flux-kind surrogate at B = BATCH at the GRB
    filters' host-frame frequencies and over their quadrature (350 Mpc),
    with the GRB gate: the same count of gated points on the CPU, and
    magnitudes within FIESTA_MAG_TOL of the port on the CPU at B =
    FIESTA_FLUX_CPU_BATCH."""
    from nmma_tpu_torch.models import DetectorLightCurveModel
    from nmma_tpu_torch.models.fiesta import fiesta_from_numpy, grb_gate

    fields = fiesta_flux_fields(np)
    data = fiesta_from_numpy(fields, device=DEVICE)
    det = DetectorLightCurveModel("TrPi2018", GRB_FILTERS, device=DEVICE)
    z = float(det.cosmology.redshift_at_dl(torch.tensor(350.0)))
    lo = torch.tensor([v[0] for v in FIESTA_FLUX_SUPPORT.values()],
                      device=DEVICE)
    hi = torch.tensor([v[1] for v in FIESTA_FLUX_SUPPORT.values()],
                      device=DEVICE)
    theta = lo + (hi - lo) * torch.rand((BATCH, len(lo)), generator=gen,
                                        device=DEVICE)
    params = {k: theta[:, i] for i, k in enumerate(FIESTA_FLUX_SUPPORT)}
    t_days = torch.tensor(np.geomspace(0.05, 40.0, 64), dtype=torch.float32,
                          device=DEVICE)
    nu_host = (det.nu_0s * (1 + z)).expand(BATCH, -1).contiguous()
    nu_nodes = (det.nu_nodes * (1 + z)).expand(BATCH, -1, -1).contiguous()
    forms = {"point": (nu_host, None, None),
             "banded": (None, nu_nodes, det.nu_weights)}
    n_cpu = FIESTA_FLUX_CPU_BATCH
    cpu_params = {k: v[:n_cpu].cpu() for k, v in params.items()}
    gated = int((~grb_gate(params)).sum())
    gated_cpu = int((~grb_gate({k: v.cpu() for k, v in params.items()})
                     ).sum())
    if gated_cpu != gated or not 0 < gated < BATCH:
        raise RuntimeError(f"[fiesta_flux] gated points: card {gated}, CPU "
                           f"{gated_cpu} of {BATCH}")
    for form, (nh, nn, nw) in forms.items():
        reset_launches()
        mags = data.magnitudes(params, t_days, nh, nn, nw)
        torch.cuda.synchronize()
        if kernel_launches() != (0, 0, 0) or mags.shape != (
                BATCH, len(GRB_FILTERS), len(t_days)):
            raise RuntimeError(f"[fiesta_flux] {form}: {mags.shape}, K1-K3 "
                               f"{kernel_launches()}")
        row_inf = torch.isinf(mags).all(-1).all(-1)
        if int(row_inf.sum()) != gated:
            raise RuntimeError(f"[fiesta_flux] {form}: {int(row_inf.sum())} "
                               f"all-inf live points, {gated} gated")
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: data.magnitudes(params, t_days, nh, nn,
                                                    nw), rounds=5,
                     launches=3)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        want = data.magnitudes(
            cpu_params, t_days.cpu(), None if nh is None else nh[:n_cpu].cpu(),
            None if nn is None else nn[:n_cpu].cpu(),
            None if nw is None else nw.cpu())
        dmag, n_fin = compare_mags(torch, "fiesta_flux",
                                   mags[:n_cpu], want)
        say("fiesta_flux", form=form, batch=BATCH, parameters=len(lo),
            frequencies=FIESTA_NU, times=FIESTA_FLUX_TIMES,
            hidden=FIESTA_HIDDEN, ms=f"{ms:.4f}",
            evals_per_s=f"{BATCH / (ms / 1e3):.1f}",
            peak_mem_mib=f"{peak_mb:.1f}", gated=gated, gated_cpu=gated_cpu,
            cpu_batch=n_cpu, max_abs_dmag_vs_cpu=f"{dmag:.3e}",
            finite_mags=n_fin,
            k1_k2_k3_launches="0,0,0")


def write_fiesta_format_dir(directory, fields, name):
    """fiesta's artifact layout: ``{name}_metadata.pkl`` and one pickled
    flax parameter tree a filter."""
    import pickle

    os.makedirs(directory)
    meta = {"times": fields["times"],
            "parameter_names": list(fields["parameter_names"]),
            "parameter_distributions": fields["parameter_distributions"],
            "filters": list(fields["filters"]),
            "X_scaler": {"min_val": fields["x_min"],
                         "max_val": fields["x_max"]},
            "y_scaler": {f: {"min_val": fields["y_min"][i],
                             "max_val": fields["y_max"][i]}
                         for i, f in enumerate(fields["filters"])}}
    with open(os.path.join(directory, f"{name}_metadata.pkl"), "wb") as f:
        pickle.dump(meta, f)
    for i, filt in enumerate(fields["filters"]):
        tree = {"params": {f"Dense_{k}": {"kernel": w[i], "bias": b[i]}
                           for k, (w, b) in enumerate(zip(
                               fields["kernels"], fields["biases"]))}}
        with open(os.path.join(directory, f"{filt}.pkl"), "wb") as f:
            pickle.dump(tree, f)


def fiesta_cli(np, torch, fields, data_path, tmp):
    """[fiesta_cli]: lightcurve-analysis --fiesta-surrogates-dir on a
    fiesta-format directory of the [fiesta_lc] surrogate, nested sampling to
    convergence at nlive FIESTA_CLI_NLIVE on its photometry: seconds, logZ
    and each parameter's 90% interval beside the injection (printed; a
    seeded random network need not make every parameter identifiable)."""
    from nmma_tpu_torch.cli import lightcurve_analysis

    surdir = os.path.join(tmp, "fiesta_surrogates")
    t0 = time.time()
    write_fiesta_format_dir(surdir, fields, FIESTA_CLI_MODEL)
    write_s = time.time() - t0
    prior = os.path.join(tmp, "fiesta_cli.prior")
    with open(prior, "w") as f:
        f.write(FIESTA_PRIOR_TEXT)
    args = ["--model", FIESTA_CLI_MODEL, "--fiesta-surrogates-dir", surdir,
            "--prior", prior, "--light-curve-data", data_path,
            "--trigger-time", str(TRIGGER_MJD), "--tmin", "0.2",
            "--tmax", "14.0", "--filters", ",".join(fields["filters"]),
            "--nlive", str(FIESTA_CLI_NLIVE), "--n-delete", "128",
            "--walks", "8", "--dlogz", "0.5",
            "--outdir", os.path.join(tmp, "fiesta_cli"),
            "--label", "fiesta_cli"]
    reset_launches()
    t0 = time.time()
    analysis = lightcurve_analysis.main(args)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    result = analysis.result
    if kernel_launches() != (0, 0, 0) or not math.isfinite(result.logz) \
            or result.niter >= analysis.config.sampler.max_iter:
        raise RuntimeError(f"[fiesta_cli] logZ {result.logz} after "
                           f"{result.niter} iterations, K1-K3 "
                           f"{kernel_launches()}")
    post = analysis.posterior_samples()
    intervals = {k: np.quantile(post[k], [0.05, 0.95])
                 for k in analysis.priors.sampled_names}
    inside = {k: bool(lo <= INJECTION[k] <= hi)
              for k, (lo, hi) in intervals.items()}
    say("fiesta_cli", logz=f"{result.logz:.4f}",
        logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
        likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
        write_dir_s=f"{write_s:.2f}", nlive=FIESTA_CLI_NLIVE,
        injection_inside_90=sum(inside.values()), of=len(inside),
        **{f"{k}_90": f"{lo:.4f}..{hi:.4f}"
           for k, (lo, hi) in intervals.items()})


def skymap_columns(np, seed=1, base_order=2, nodes=10):
    """A multi-order sky map: every pixel of ``base_order``, the first 24
    split into their 4 children one order deeper, with the four cos-iota
    ``*_SAMPLES`` layers. A copy of tests/test_torch_fits.py:skymap_columns
    (which imports JAX): keep the two in step."""
    rng = np.random.default_rng(seed)
    n_base = 12 * 4**base_order
    split = np.arange(24)
    uniq = [4 ** (base_order + 1) + i for i in range(n_base)
            if i not in split]
    uniq += [4 ** (base_order + 2) + 4 * i + k for i in split
             for k in range(4)]
    uniq = np.asarray(uniq, dtype=np.int64)
    n = len(uniq)
    mu = rng.uniform(30.0, 50.0, (n, nodes))
    sigma = rng.uniform(5.0, 12.0, (n, nodes))
    return {"UNIQ": uniq,
            "PROBDENSITY_SAMPLES": rng.uniform(0.1, 2.0, (n, nodes)),
            "DISTMU_SAMPLES": mu, "DISTSIGMA_SAMPLES": sigma,
            "DISTNORM_SAMPLES": 1.0 / (mu**2 + sigma**2)}


def fits_phase(np, torch, tmp):
    """[fits]: a multi-order sky map and an m4opt limit map written with
    write_bintable, then lightcurve-analysis --fits-file --dL --ra --dec
    --detection-limit-fits-file on the [cli] configuration (Bu2019lm
    through K1, KNtheta from the sky map's inclination prior) with
    --skip-sampling on the card and on the CPU: the inclination prior's
    nodes and the detection limit equal; then the card's analysis capped at
    RESAMPLING_ITERATIONS iterations: K1 launches 1 + iterations x walks."""
    import dataclasses

    from nmma_tpu_torch.cli import lightcurve_analysis
    from nmma_tpu_torch.io.fits import write_bintable

    root = os.path.join(tmp, "fits")
    os.makedirs(root)
    sky, limits = os.path.join(root, "skymap.fits"), \
        os.path.join(root, "m4opt.fits")
    write_bintable(sky, skymap_columns(np), extra_header={"MOC": True})
    # limits fainter than the injection's photometry: the CLI reads the map
    # after it has made the injection (as the JAX package does), and a
    # detection fainter than the limit sends the truncated Gaussian's
    # -log Phi(b) to large positive logL (ROADMAP fault 3e)
    nside = 64
    write_bintable(limits, {"LIMMAG": np.random.default_rng(8).uniform(
        27.0, 28.0, 12 * nside**2)},
        extra_header={"NSIDE": nside, "ORDERING": "NESTED"})
    _, config_path = cli_config(root)
    prior = os.path.join(root, "sky.prior")
    with open(prior, "w") as f:
        f.write("".join(line + "\n" for line in PRIOR_TEXT.splitlines()
                        if not line.startswith("KNtheta")))
    args = [config_path, "--prior", prior, "--fits-file", sky, "--dL", "40",
            "--ra", "197.45", "--dec", "-23.38",
            "--detection-limit-fits-file", limits, "--skip-sampling"]
    t0 = time.time()
    card = lightcurve_analysis.main(args + ["--outdir",
                                            os.path.join(root, "card")])
    setup_s = time.time() - t0
    cpu = lightcurve_analysis.main(
        args + ["--outdir", os.path.join(root, "cpu")], device="cpu")
    incl, incl_cpu = card.priors["inclination_EM"], cpu.priors[
        "inclination_EM"]
    if not (np.array_equal(incl.xx, incl_cpu.xx)
            and np.array_equal(incl.yy, incl_cpu.yy)
            and card.config.detection_limit == cpu.config.detection_limit
            and "inclination_EM" in card.priors.sampled_names):
        raise RuntimeError("[fits] the card's inclination prior or detection "
                           "limit differs from the CPU's")
    card.config.sampler = dataclasses.replace(
        card.config.sampler, max_iter=RESAMPLING_ITERATIONS)
    reset_launches()
    t0 = time.time()
    result = card.run(verbose=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    walks = card.config.sampler.walks
    expected = (1 + result.niter * walks, 0, 0)
    if kernel_launches() != expected or not math.isfinite(result.logz) \
            or result.niter != RESAMPLING_ITERATIONS:
        raise RuntimeError(f"[fits] logZ {result.logz} after {result.niter} "
                           f"iterations, K1-K3 {kernel_launches()} (expected "
                           f"{expected})")
    say("fits", skymap_rows=len(skymap_columns(np)["UNIQ"]),
        limit_nside=nside, inclination_nodes=len(incl.xx),
        inclination_max=f"{incl.maximum:.6f}",
        detection_limit=f"{card.config.detection_limit:.4f}",
        setup_s=f"{setup_s:.2f}", iterations=result.niter,
        logz=f"{result.logz:.4f}", seconds=f"{seconds:.2f}",
        k1_launches=kernel_launches()[0],
        k1_expected=f"1+{result.niter}x{walks}")


def write_possis_ascii(np, path, seed=16):
    """A seeded POSSIS ASCII spectral series at 10 pc (POSSIS_SHAPE angles,
    wavelengths and times): a cooling blackbody-like shape with a 5%
    ripple, dimmer with the viewing angle."""
    n_obs, n_wave, n_time = POSSIS_SHAPE
    rng = np.random.default_rng(seed)
    wave = np.geomspace(1500.0, 25000.0, n_wave)
    time_d = np.linspace(0.3, 13.0, n_time)
    temp = 6000.0 * (time_d / 0.3) ** -0.4
    x = 1.4388e8 / (wave[None, :] * temp[:, None])
    shape = 1.0 / (wave[None, :] ** 5 * np.expm1(np.minimum(x, 700.0)))
    dt = time_d[1] - time_d[0]
    with open(path, "w") as fh:
        fh.write(f"{n_obs}\n{n_wave}\n{n_time} {time_d[0] - 0.5 * dt} "
                 f"{time_d[0] + (n_time - 0.5) * dt}\n")
        for i in range(n_obs):
            flam = 1e-3 * (1.0 - 0.15 * i) * shape * np.abs(
                1.0 + 0.05 * rng.standard_normal(shape.shape))
            np.savetxt(fh, np.column_stack([wave, flam.T]))


def possis_phase(np, torch, gen, tmp):
    """[possis]: a seeded POSSIS ASCII spectrum through
    spectral_model_from_file, then EMAnalysis.batched_logl at B = BATCH on
    photometry it makes at POSSIS_INJECTION, the card against the CPU at
    B = 128 (measure_logl)."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.models import spectral_model_from_file

    spectrum = os.path.join(tmp, "possis_spectra.txt")
    t0 = time.time()
    write_possis_ascii(np, spectrum)
    model = spectral_model_from_file(POSSIS_MODEL, spectrum)
    load_s = time.time() - t0
    data_path = os.path.join(tmp, "possis_injection.dat")
    prior_path = os.path.join(tmp, "possis.prior")
    with open(prior_path, "w") as f:
        f.write(POSSIS_PRIOR_TEXT)
    synthetic_photometry(np, torch, POSSIS_MODEL, POSSIS_FILTERS, data_path,
                         POSSIS_INJECTION, sample_times=(0.4, 13.0, 50),
                         epochs=(1.0, 12.0))
    cfg = EMAnalysisConfig(
        model=POSSIS_MODEL, prior_file=prior_path, light_curve_data=data_path,
        trigger_time=TRIGGER_MJD, tmin=0.4, tmax=13.0, n_tsteps=50,
        filters=POSSIS_FILTERS, outdir=os.path.join(tmp, "possis_outdir"))
    analysis = EMAnalysis(cfg, device=DEVICE)
    on_cpu = EMAnalysis(cfg, device="cpu")
    u = analysis.priors.sample_units(gen, BATCH)
    say("possis", angles=POSSIS_SHAPE[0], wavelengths=POSSIS_SHAPE[1],
        times=POSSIS_SHAPE[2], banded=model.banded, load_s=f"{load_s:.3f}")
    measure_logl(torch, "possis", POSSIS_MODEL, analysis.batched_logl,
                 on_cpu.batched_logl, u, float(analysis.batched_logl(
                     injection_units(analysis.priors, POSSIS_INJECTION))[0]))


def marginalisation_phase(np, torch, eos_dir, tmp):
    """[marginalisation]: lightcurve-marginalisation on MARG_SAMPLES seeded
    GW posterior samples (a csv posterior with the ejecta nuisances), the
    [eos] tables and the production Bu2019lm surrogate: one K1 launch on
    the card; the percentile bands within FIESTA_MAG_TOL of the port's run
    on the CPU on the same draws."""
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.post_processing import marginalisation

    rng = np.random.default_rng(17)
    n = MARG_SAMPLES
    post = {"chirp_mass": rng.normal(1.1977, 0.002, n),
            "mass_ratio": rng.uniform(0.7, 1.0, n),
            "luminosity_distance": rng.normal(40.0, 5.0, n),
            "theta_jn": rng.uniform(0.1, 0.6, n),
            "ratio_zeta": rng.uniform(0.1, 0.3, n),
            "alpha": rng.uniform(0.0, 1e-3, n),
            "KNphi": rng.uniform(15.0, 75.0, n)}
    csv = os.path.join(tmp, "gw_posterior.csv")
    np.savetxt(csv, np.column_stack(list(post.values())), delimiter=",",
               header=",".join(post), comments="")
    with np.load(ARTIFACT) as z:
        filters = ",".join(str(f) for f in z["filters"])
    # the CPU run needs the surrogate's weights on the CPU
    make_svd_source_model(MODEL + "_cpu",
                          SVDModelData.load(ARTIFACT, device="cpu"))
    args = ["--posterior-file", csv, "--eos-data", eos_dir,
            "--filters", filters, "--tmin", "0.2", "--tmax", "14.0",
            "--n-tstep", "50", "-n", str(n)]
    reset_launches()
    t0 = time.time()
    out = marginalisation.main(args + ["--model", MODEL, "--outdir",
                                       os.path.join(tmp, "marg_card")])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kernel_launches()
    t0 = time.time()
    out_cpu = marginalisation.main(
        args + ["--model", MODEL + "_cpu", "--outdir",
                os.path.join(tmp, "marg_cpu")], device="cpu")
    cpu_s = time.time() - t0
    got = np.load(out, allow_pickle=True)["bands"]
    want = np.load(out_cpu, allow_pickle=True)["bands"]
    ok = np.isfinite(want)
    if launches != (1, 0, 0) or got.shape != want.shape or not \
            np.array_equal(np.isnan(got), np.isnan(want)) or \
            ok.mean() < 0.5:
        raise RuntimeError(f"[marginalisation] K1-K3 {launches}, bands "
                           f"{got.shape} against {want.shape}, finite "
                           f"{ok.mean()}")
    dmag = float(np.abs(got[ok] - want[ok]).max())
    if dmag > FIESTA_MAG_TOL:
        raise RuntimeError(f"[marginalisation] bands {dmag} mag off the CPU")
    if matplotlib_present():
        marginalisation.main(args + ["--model", MODEL, "--plot", "--outdir",
                                     os.path.join(tmp, "marg_plot")])
        plot = "marginalised_lc.pdf"
    else:
        plot = "not run: matplotlib absent"
    say("marginalisation", samples=n, bands="x".join(map(str, got.shape)),
        plot=plot,
        seconds=f"{seconds:.3f}", cpu_seconds=f"{cpu_s:.3f}",
        k1_launches=launches[0], finite_share=f"{ok.mean():.4f}",
        max_abs_dband_vs_cpu=f"{dmag:.3e}",
        median_band_ztfg_peak=f"{np.nanmin(got[1, 1]):.3f}")


def resampling_phase(np, torch, eos_dir, tmp):
    """[resampling]: GWEMResampler on the [eos] macro set and
    MaximumMassResampler on its baryonic tables, each a nested run capped
    at RESAMPLING_ITERATIONS iterations on the card: seconds and a finite
    logZ, no K1-K3 launch."""
    from nmma_tpu_torch.eos import load_macro_eos_set
    from nmma_tpu_torch.post_processing import (GWEMResampler,
                                                MaximumMassResampler)

    rng = np.random.default_rng(18)
    n = 2000
    gw = {"chirp_mass": rng.normal(1.1977, 0.001, n),
          "mass_ratio": rng.uniform(0.7, 1.0, n),
          "luminosity_distance": rng.normal(40.0, 4.0, n),
          "EOS": rng.uniform(0.0, len(EOS_SLOPES), n)}
    em = {"log10_mej_dyn": rng.normal(-2.2, 0.2, n),
          "log10_mej_wind": rng.normal(-1.6, 0.2, n)}
    q = rng.uniform(0.75, 1.0, n)
    mm = {"chirp_mass": rng.normal(1.19, 0.005, n),
          "eta_star": np.log(0.25 - q / (1 + q) ** 2 + 1e-6),
          "EOS": rng.uniform(0.0, len(EOS_SLOPES), n),
          "log10_mdisk": rng.normal(-1.3, 0.2, n),
          "log10_mej_dyn": rng.normal(-2.3, 0.2, n)}
    t0 = time.time()
    gwem = GWEMResampler(gw, em, load_macro_eos_set(eos_dir))
    gwem_setup = time.time() - t0
    t0 = time.time()
    maxmass = MaximumMassResampler(
        mm, os.path.join(tmp, "baryonic", "macro"),
        os.path.join(tmp, "baryonic", "micro"),
        mass_grid=np.linspace(*BARYONIC_GRID))
    maxmass_setup = time.time() - t0
    for name, rs, setup_s, nlive in (("GWEMResampler", gwem, gwem_setup, 512),
                                     ("MaximumMassResampler", maxmass,
                                      maxmass_setup, 256)):
        reset_launches()
        t0 = time.time()
        result, post = rs.run(nlive=nlive, max_iter=RESAMPLING_ITERATIONS)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        if not math.isfinite(result.logz) or kernel_launches() != (0, 0, 0) \
                or result.niter != RESAMPLING_ITERATIONS:
            raise RuntimeError(f"[resampling] {name}: logZ {result.logz} "
                               f"after {result.niter}, K1-K3 "
                               f"{kernel_launches()}")
        say("resampling", resampler=name, nlive=nlive,
            iterations=result.niter, likelihood_calls=result.ncall,
            logz=f"{result.logz:.4f}", setup_s=f"{setup_s:.2f}",
            seconds=f"{seconds:.2f}",
            eos_median=f"{float(np.median(post['EOS'])):.3f}")


def post_path(np, torch, tmp):
    """The fiesta, FITS, POSSIS and post-processing phases, with the
    [eos] tables under ``tmp``: [fiesta_lc], [fiesta_flux], [fiesta_cli],
    [fits], [possis], [marginalisation], [resampling]."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(14)
    t0 = time.time()
    fields, data_path = fiesta_lc(np, torch, gen, tmp)
    fiesta_flux(np, torch, gen)
    fiesta_cli(np, torch, fields, data_path, tmp)
    del fields
    fits_phase(np, torch, tmp)
    possis_phase(np, torch, gen, tmp)
    eos_dir = os.path.join(tmp, "eos")
    marginalisation_phase(np, torch, eos_dir, tmp)
    resampling_phase(np, torch, eos_dir, tmp)
    say("post_phases", seconds=f"{time.time() - t0:.2f}")


# --- item 18: K1's general path, surrogate training, LFI, EOS emulators ---

# (P, C) of the general path's check; (4, 10) and (2, 10) must still take
# the specialised instantiations
K1_GENERAL_SHAPES = ((1, 10), (3, 8), (6, 10), (7, 6), (4, 6), (4, 40))
TRAIN_POINTS = 1024
TRAIN_FLAGS = ["--svd-ncoeff", "10", "--hidden", "2048", "--n-epochs", "4000",
               "--n-tsteps", "100"]
TRAIN_CHECK_EPOCHS = 20
# card against CPU after 20 epochs from the same weights: the losses (same
# data, same adam, f32 sums in another order) and the net's coefficients
TRAIN_LOSS_RTOL = 1e-3
TRAIN_COEFF_ATOL = 1e-3
TRAIN_CLI_CAP = 40
# the second training: Bu2019nsbh's filename convention (3 parameters,
# KNphi dropped: its grid is the production surrogate at KNphi = 45)
NSBH_POINTS = 512
NSBH_FLAGS = ["--svd-ncoeff", "8", "--hidden", "2048", "--n-epochs", "1000",
              "--n-tsteps", "100"]
NSBH_PRIOR_TEXT = """\
log10_mej_dyn = Uniform(minimum=-3., maximum=-1.7)
log10_mej_wind = Uniform(minimum=-2., maximum=-0.9)
KNtheta = Uniform(minimum=0., maximum=90.)
luminosity_distance = Uniform(minimum=10., maximum=100.)
timeshift = Uniform(minimum=-0.2, maximum=0.2)
"""
NSBH_INJECTION = {"log10_mej_dyn": -2.0, "log10_mej_wind": -1.2,
                  "KNtheta": 30.0, "luminosity_distance": 40.0,
                  "timeshift": 0.0}
GP_SUBSET = 256
GP_STEPS = 400
GP_HELD_OUT = 64
GP_MAG_TOL = 5e-2      # mag, card against CPU, same surrogate file
LFI_VICREG_EPOCHS = 60
LFI_SIMULATIONS = 3000
TOV_HELD_OUT = 32
TOV_MTOV_TOL = 0.05    # Msun, emulator against the port's TOV solver
TOV_R14_TOL = 0.3      # km
# the emulator steps, card against CPU: f32 sums in another order passed
# through exp and 10^x; the port's relative gate (K3's)
EMULATOR_RTOL = 1e-4


def assert_launches(phase, k1):
    """Raise unless K1 launched exactly ``k1`` times, and K2 and K3 never,
    since the last reset_launches()."""
    got = kernel_launches()
    if got != (k1, 0, 0):
        raise RuntimeError(f"[{phase}] launched K1, K2, K3 {got} times; "
                           f"expected ({k1}, 0, 0)")


def seeded_k1_operands(torch, gen, p, c, b, n_f=9, h=2048, q=150):
    """K1's operands at production widths with seeded weights of a trained
    surrogate's scales: x [B, P] in [0, 1], He-normal W1, 1/sqrt(H) W2, a
    basis of O(1) magnitudes around -15."""
    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=DEVICE)
    x = torch.rand((b, p), generator=gen, device=DEVICE)
    return (x, randn(n_f, p, h, scale=math.sqrt(2.0 / p)),
            randn(n_f, h, scale=0.1), randn(n_f, h, c, scale=h ** -0.5),
            randn(n_f, c, scale=0.1), randn(n_f, c, q, scale=2.0 / math.sqrt(c)),
            -15.0 + randn(n_f, q))


def k1_general(np, torch, gen):
    """[k1_general]: K1's general path against its plain version at the
    (P, C) of K1_GENERAL_SHAPES, B = 1, 128, 8199, production widths (F=9,
    H=2048, Q=150); one launch a call; its time at B = 8192 beside its
    bound and the plain version's. (4, 10) and (2, 10) still route to the
    specialised instantiations; P = 17 is refused before any launch.
    Returns the fields of K1's kernel-line entry."""
    from nmma_tpu_torch.ops import svd_kernel

    fields, max_err = {}, 0.0
    for p, c in ((4, 10), (2, 10)):
        if svd_kernel.kernel_route(p, c) != "specialised":
            raise RuntimeError(f"K1 ({p}, {c}) left its instantiation")
    for p, c in K1_GENERAL_SHAPES:
        if svd_kernel.kernel_route(p, c) != "general":
            raise RuntimeError(f"K1 ({p}, {c}) is not on the general path")
        shape_err = 0.0
        for b in (1, SAMPLER_BATCH, BATCH + 7):
            ops = seeded_k1_operands(torch, gen, p, c, b)
            reset_launches()
            got = svd_kernel.svd_surrogate_mags(*ops)
            assert_launches("k1_general", 1)
            want = svd_kernel.svd_surrogate_mags_plain(*ops)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if got.shape != want.shape or not math.isfinite(err) \
                    or err > K1_TOL:
                raise RuntimeError(f"K1 general (P={p}, C={c}) at B={b}: "
                                   f"max abs err {err} (tolerance {K1_TOL})")
            shape_err = max(shape_err, err)
        max_err = max(max_err, shape_err)
        ops = seeded_k1_operands(torch, gen, p, c, BATCH)
        ms = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags(*ops),
                     rounds=10)
        plain = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags_plain(
            *ops), rounds=10)
        flops, n_bytes, bound, bound_by = k1_bound(BATCH, 9, p, 2048, c, 150)
        say("k1_general", p=p, c=c, batch=BATCH, kernel_ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, bound_share=f"{bound / ms:.4f}",
            max_abs_err_b1_b128_b8199=f"{shape_err:.3e}")
        fields[f"general_p{p}_c{c}_ms"] = ms
        fields[f"general_p{p}_c{c}_plain_ms"] = plain
        fields[f"general_p{p}_c{c}_bound_ms"] = bound
    ops = seeded_k1_operands(torch, gen, 17, 10, 4)
    reset_launches()
    try:
        svd_kernel.svd_surrogate_mags(*ops)
    except ValueError as err:
        refused = str(err)
    else:
        raise RuntimeError("K1 took P=17")
    assert_launches("k1_general", 0)
    say("k1_general", shapes=len(K1_GENERAL_SHAPES), batches="1,128,8199",
        max_abs_err=f"{max_err:.3e}", refused_p17=repr(refused))
    fields["general_max_abs_err"] = max_err
    return fields


def surrogate_grid(np, torch, svd, n, seed, fixed=None):
    """(params {name: [n]}, mags [n, F, T]) of the surrogate ``svd`` on its
    own time grid at n points drawn with ``seed`` inside its bounds (a
    name in ``fixed`` held at its value), through its plain K1 version."""
    from nmma_tpu_torch.ops import svd_kernel

    rng = np.random.default_rng(seed)
    names = list(svd.parameter_names)
    theta = rng.uniform(svd.host["param_mins"], svd.host["param_maxs"],
                        (n, len(names)))
    for name, value in (fixed or {}).items():
        theta[:, names.index(name)] = value
    params = {k: torch.tensor(theta[:, i], dtype=torch.float32,
                              device=DEVICE) for i, k in enumerate(names)}
    kernel_fn = svd_kernel.svd_surrogate_mags
    svd_kernel.svd_surrogate_mags = svd_kernel.svd_surrogate_mags_plain
    try:
        with torch.no_grad():
            mags = svd(params, torch.tensor(svd.tt, dtype=torch.float32,
                                            device=DEVICE))
    finally:
        svd_kernel.svd_surrogate_mags = kernel_fn
    return ({k: theta[:, i] for i, k in enumerate(names)},
            mags.cpu().numpy())


def train_on_card_and_cpu(np, torch, entries, pnames, filters):
    """The first TRAIN_CHECK_EPOCHS epochs of the [svd_train] fit from the
    same initial weights on the card and on the CPU: (max relative loss
    difference, max |coefficient difference| on the holdout)."""
    from nmma_tpu_torch.training import svd as t_svd

    cfg = t_svd.SVDTrainingConfig(n_coeff=10, hidden=2048, n_tsteps=100)
    tt = np.linspace(cfg.tmin, cfg.tmax, cfg.n_tsteps)
    data = t_svd._interp_grid(entries, filters, tt)
    params = np.asarray([[e["params"][p] for p in pnames] for e in entries])
    _, _, x, _, _, va, coeffs = t_svd._normalize_and_decompose(
        data, params, cfg.n_coeff)
    perm = np.random.default_rng(cfg.seed).permutation(len(entries))
    n_hold = max(1, int(round(len(entries) * cfg.holdout_fraction)))
    train, hold = perm[n_hold:], perm[:n_hold]
    out = {}
    for device in (DEVICE, "cpu"):
        net = t_svd.initial_mlp(len(filters), params.shape[1], cfg.hidden,
                                va.shape[2], cfg.seed, device)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=device)
        losses = []
        for _ in range(TRAIN_CHECK_EPOCHS):
            net, loss = t_svd.fit_mlp(net, dev(x[train]), dev(coeffs[train]),
                                      1, cfg.learning_rate, verbose=False)
            losses.append(loss)
        with torch.no_grad():
            pred = t_svd.stacked_mlp(dev(x[hold]), net).cpu().numpy()
        out[device] = (np.asarray(losses), pred)
    (l_card, p_card), (l_cpu, p_cpu) = out[DEVICE], out["cpu"]
    return (float(np.abs(l_card / l_cpu - 1).max()),
            float(np.abs(p_card - p_cpu).max()), l_card)


def capped_cli(cap):
    """lightcurve_analysis with its nested sampler capped at ``cap``
    iterations, as a context manager."""
    import contextlib
    import dataclasses

    from nmma_tpu_torch.cli import lightcurve_analysis

    @contextlib.contextmanager
    def patch():
        real = lightcurve_analysis.sampler_config_from_args
        lightcurve_analysis.sampler_config_from_args = \
            lambda args: dataclasses.replace(real(args), max_iter=cap)
        try:
            yield lightcurve_analysis
        finally:
            lightcurve_analysis.sampler_config_from_args = real
    return patch()


def trained_cli(np, torch, svd_path, tmp):
    """The [cli] configuration on the trained surrogate: a nested run
    capped at TRAIN_CLI_CAP iterations; returns (iterations, K1 launches,
    logZ, seconds)."""
    config, config_path = cli_config(tmp)
    t0 = time.time()
    reset_launches()
    with capped_cli(TRAIN_CLI_CAP) as cli:
        analysis = cli.main(
            [config_path, "--svd-path", svd_path, "--model",
             "Bu2019lm_trained", "--label", "trained"])
    torch.cuda.synchronize()
    result = analysis.result
    expected = 2 + result.niter * analysis.config.sampler.walks \
        + BESTFIT_LAUNCHES
    assert_launches("svd_train", expected)
    if not math.isfinite(result.logz) or result.niter > TRAIN_CLI_CAP:
        raise RuntimeError(f"the trained surrogate's run: logZ "
                           f"{result.logz} in {result.niter} iterations")
    return result.niter, expected, result.logz, time.time() - t0


def nsbh_logl(np, torch, gen, svd_path, tmp):
    """The P=3, C=8 surrogate in one EMAnalysis.batched_logl at B = BATCH
    (K1's general path, one launch), against the plain K1; returns (finite
    share, max |dlogL|)."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.ops import svd_kernel

    svd = SVDModelData.load(svd_path, device=DEVICE)
    model = make_svd_source_model("Bu2019nsbh_trained", svd).name
    data_path = os.path.join(tmp, "nsbh.dat")
    prior_path = os.path.join(tmp, "nsbh.prior")
    with open(prior_path, "w") as f:
        f.write(NSBH_PRIOR_TEXT)
    synthetic_photometry(np, torch, model, list(svd.filters), data_path,
                         NSBH_INJECTION, sample_times=(0.2, 14.0, 100),
                         epochs=(0.5, 12.0))
    analysis = EMAnalysis(EMAnalysisConfig(
        model=model, prior_file=prior_path, light_curve_data=data_path,
        trigger_time=TRIGGER_MJD, data_tmax=12.5, error_budget=1.0,
        filters=list(svd.filters), tmin=0.2, tmax=14.0), device=DEVICE)
    u = analysis.priors.sample_units(gen, BATCH)
    reset_launches()
    logl = analysis.batched_logl(u)
    torch.cuda.synchronize()
    assert_launches("svd_train", 1)
    kernel_fn = svd_kernel.svd_surrogate_mags
    svd_kernel.svd_surrogate_mags = svd_kernel.svd_surrogate_mags_plain
    try:
        plain = analysis.batched_logl(u)
    finally:
        svd_kernel.svd_surrogate_mags = kernel_fn
    usable = logl > -1e29
    if not torch.equal(usable, plain > -1e29) or float(
            usable.float().mean()) < 0.5:
        raise RuntimeError("the P=3 surrogate's logL lost its sentinels "
                           "or most of its batch")
    dlogl = (logl - plain)[usable].abs()
    if bool((dlogl > LOGL_ATOL + LOGL_RTOL * plain[usable].abs()).any()):
        raise RuntimeError(f"P=3 logL off the plain K1 by "
                           f"{float(dlogl.max())}")
    return float(usable.float().mean()), float(dlogl.max())


def svd_train(np, torch, gen, tmp):
    """[svd_train]: a 1,024-point Bu2019lm grid (the production surrogate
    through its plain K1 version, seeded points inside its bounds) written
    as bulla files, then create-svdmodel --axial-symmetry at production
    width on the card (3,072 entries, 4,000 epochs), the first 20 epochs
    card against CPU, svdmodel-benchmark, the trained surrogate through
    the [cli] configuration (K1 against its plain version, a nested run of
    40 iterations), and a second training at --svd-ncoeff 8 on 3
    parameters (Bu2019nsbh's filenames, KNphi at 45) whose surrogate runs
    through K1's general path in one batched_logl. Returns the grid
    directory and the fields of K1's kernel-line entry."""
    from nmma_tpu_torch.cli import tools
    from nmma_tpu_torch.models import SVDModelData
    from nmma_tpu_torch.ops import svd_kernel
    from nmma_tpu_torch.training import read_bulla_grid
    from nmma_tpu_torch.training.svd import axial_symmetry, write_bulla_grid

    t_start = time.time()
    prod = SVDModelData.load(ARTIFACT, device=DEVICE)
    grid_dir = os.path.join(tmp, "grid")
    params, mags = surrogate_grid(np, torch, prod, TRAIN_POINTS, seed=18)
    write_bulla_grid(grid_dir, "Bu2019lm", params, prod.tt, mags,
                     list(prod.filters))
    svd_dir = os.path.join(tmp, "svdmodels")
    info = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    out = tools.create_svdmodel(
        ["--model", "Bu2019lm", "--data-path", grid_dir, "--svd-path",
         svd_dir, "--axial-symmetry", *TRAIN_FLAGS], info=info)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    assert_launches("svd_train", 0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if info["n_entries"] != 3 * TRAIN_POINTS or info["epochs"] != 4000 \
            or not info["holdout_mse"] < 0.05:
        raise RuntimeError(f"create-svdmodel: {info}")
    say("svd_train", grid_points=TRAIN_POINTS, entries=info["n_entries"],
        read_s=f"{info['read_s']:.3f}", interp_s=f"{info['interp_s']:.3f}",
        svd_s=f"{info['svd_s']:.3f}", fit_s=f"{info['fit_s']:.3f}",
        epochs=info["epochs"],
        epochs_per_s=f"{info['epochs'] / info['fit_s']:.1f}",
        train_mse=f"{info['train_mse']:.3e}",
        holdout_mse=f"{info['holdout_mse']:.3e}",
        n_holdout=info["n_holdout"], peak_gib=f"{peak_gib:.3f}",
        create_svdmodel_s=f"{train_s:.2f}")

    entries, pnames, filters = read_bulla_grid(
        sorted(os.path.join(grid_dir, f) for f in os.listdir(grid_dir)),
        model="Bu2019lm")
    loss_rel, coeff_err, losses = train_on_card_and_cpu(
        np, torch, axial_symmetry(entries), pnames, filters)
    if loss_rel > TRAIN_LOSS_RTOL or coeff_err > TRAIN_COEFF_ATOL:
        raise RuntimeError(f"20 epochs card against CPU: losses {loss_rel} "
                           f"relative, coefficients {coeff_err}")
    say("svd_train", card_vs_cpu_epochs=TRAIN_CHECK_EPOCHS,
        max_rel_loss=f"{loss_rel:.3e}", max_abs_coeff=f"{coeff_err:.3e}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        tolerance=f"{TRAIN_LOSS_RTOL}/{TRAIN_COEFF_ATOL}")

    reset_launches()
    t0 = time.time()
    scores = tools.svdmodel_benchmark(
        ["--model", "Bu2019lm", "--data-path", grid_dir, "--svd-path",
         svd_dir, "--outdir", os.path.join(tmp, "bench")])
    assert_launches("svd_train", 1)
    medians = [v[2] for v in scores.values()]
    if sorted(scores) != sorted(prod.filters) or not max(medians) < 1.0:
        raise RuntimeError(f"svdmodel-benchmark: {scores}")
    say("svd_train", benchmark_s=f"{time.time() - t0:.3f}", k1_launches=1,
        chi2_median_max=f"{max(medians):.4e}",
        chi2_median_ztfg=f"{scores['ztfg'][2]:.4e}")

    trained = SVDModelData.load(out, device=DEVICE)
    t_days = torch.tensor(np.geomspace(0.25, 12.0, 100), dtype=torch.float32,
                          device=DEVICE)
    va_q, off_q, _ = trained.operator_rankc(t_days)
    weights = (trained.w1, trained.b1, trained.w2, trained.b2, va_q, off_q)
    max_err = 0.0
    for b in (1, SAMPLER_BATCH, BATCH + 7):
        x = torch.rand((b, 4), generator=gen, device=DEVICE)
        err = float((svd_kernel.svd_surrogate_mags(x, *weights)
                     - svd_kernel.svd_surrogate_mags_plain(x, *weights))
                    .abs().max())
        if not err <= K1_TOL:
            raise RuntimeError(f"K1 on the trained surrogate at B={b}: {err}")
        max_err = max(max_err, err)
    iterations, launches, logz, cli_s = trained_cli(np, torch, out, tmp)
    say("svd_train", trained_k1_max_abs_err=f"{max_err:.3e}",
        cli_iterations=iterations, cli_k1_launches=launches,
        cli_logz=f"{logz:.4f}", cli_s=f"{cli_s:.2f}")

    nsbh_dir = os.path.join(tmp, "grid_nsbh")
    params, mags = surrogate_grid(np, torch, prod, NSBH_POINTS, seed=19,
                                  fixed={"KNphi": 45.0})
    del params["KNphi"]
    write_bulla_grid(nsbh_dir, "Bu2019nsbh", params, prod.tt, mags,
                     list(prod.filters))
    info = {}
    reset_launches()
    out = tools.create_svdmodel(
        ["--model", "Bu2019nsbh", "--data-path", nsbh_dir, "--svd-path",
         svd_dir, *NSBH_FLAGS], info=info)
    assert_launches("svd_train", 0)
    nsbh = SVDModelData.load(out, device=DEVICE)
    if nsbh.w1.shape[1] != 3 or nsbh.n_coeff != 8:
        raise RuntimeError(f"the nsbh surrogate is {tuple(nsbh.w1.shape)}")
    share, dlogl = nsbh_logl(np, torch, gen, out, tmp)
    say("svd_train", nsbh_points=NSBH_POINTS, nsbh_p=3, nsbh_c=8,
        nsbh_fit_s=f"{info['fit_s']:.3f}",
        nsbh_holdout_mse=f"{info['holdout_mse']:.3e}",
        nsbh_logl_batch=BATCH, nsbh_k1_launches=1,
        nsbh_finite_share=f"{share:.4f}",
        nsbh_max_abs_dlogl_vs_plain=f"{dlogl:.3e}",
        seconds=f"{time.time() - t_start:.2f}")
    return grid_dir, {"trained_max_abs_err": max_err,
                      "launches_trained_cli": launches}


def gp_train(np, torch, gen, grid_dir, tmp):
    """[gp_train]: --interpolation-type api_gp on the 1,024-point grid
    (one 1,024^2 Cholesky with 90 right-hand sides), then the sklearn_gp
    backend on its first 256 points for 400 adam steps (a [90, 256, 256]
    Cholesky and its backward a step; every step's NLL must be finite,
    fault 3h, and the step the noise bound first bound is printed); each
    surrogate's magnitudes at
    64 held-out points, card against CPU."""
    from nmma_tpu_torch.cli import tools
    from nmma_tpu_torch.training import (load_gp_surrogate, read_bulla_grid,
                                         svd_gp_surrogate_mags,
                                         train_svd_gp_model)
    from nmma_tpu_torch.training.svd import SVDTrainingConfig

    files = sorted(os.path.join(grid_dir, f) for f in os.listdir(grid_dir))
    svd_dir = os.path.join(tmp, "gp")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    out = tools.create_svdmodel(
        ["--model", "Bu2019lm", "--data-path", grid_dir, "--svd-path",
         svd_dir, "--interpolation-type", "api_gp", "--svd-ncoeff", "10",
         "--n-tsteps", "100"])
    torch.cuda.synchronize()
    api_s = time.time() - t0
    api_peak = torch.cuda.max_memory_allocated() / 2**30
    meta, api = load_gp_surrogate(out, device=DEVICE)
    api_nan = int(torch.isnan(api.alpha_vecs).sum())

    entries, pnames, filters = read_bulla_grid(files[:GP_SUBSET],
                                               model="Bu2019lm")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    skl_meta, skl = train_svd_gp_model(
        entries, pnames, filters, SVDTrainingConfig(n_coeff=10,
                                                    n_tsteps=100),
        n_steps=GP_STEPS, verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    skl_s = time.time() - t0
    skl_peak = torch.cuda.max_memory_allocated() / 2**30
    assert_launches("gp_train", 0)
    nll = skl.nll_history
    skl_nan = int(np.isnan(nll).sum()) + int(torch.isnan(skl.alpha_vecs).sum())
    if api_nan or skl_nan or not nll[-1] < nll[0] \
            or skl.stopped_at is not None or len(nll) != GP_STEPS:
        raise RuntimeError(f"GP fits: {api_nan} NaN alphas (api_gp), "
                           f"{skl_nan} NaN (sklearn_gp), NLL {nll[0]} -> "
                           f"{nll[-1]}, stopped at {skl.stopped_at}")

    rng = np.random.default_rng(20)
    lo, hi = meta["param_mins"], meta["param_maxs"]
    theta = rng.uniform(lo, hi, (GP_HELD_OUT, len(lo)))
    t_out = np.geomspace(0.25, 12.0, 50)
    errs = {}
    for name, (m, gp) in (("api_gp", (meta, api)),
                          ("sklearn_gp", (skl_meta, skl))):
        path = os.path.join(tmp, f"{name}.npz")
        from nmma_tpu_torch.training import save_gp_surrogate
        save_gp_surrogate(path, m, gp)
        cpu_meta, cpu_gp = load_gp_surrogate(path, device="cpu")
        got = svd_gp_surrogate_mags(m, gp, {k: torch.tensor(
            theta[:, i], dtype=torch.float32, device=DEVICE)
            for i, k in enumerate(pnames)}, t_out).cpu().numpy()
        want = svd_gp_surrogate_mags(cpu_meta, cpu_gp, {k: torch.tensor(
            theta[:, i], dtype=torch.float32) for i, k in enumerate(pnames)},
            t_out).numpy()
        if not np.isfinite(want).all() or not np.isfinite(got).all():
            raise RuntimeError(f"{name}: non-finite magnitudes")
        errs[name] = float(np.abs(got - want).max())
        if errs[name] > GP_MAG_TOL:
            raise RuntimeError(f"{name} card against CPU: {errs[name]} mag")
    say("gp_train", api_gp_points=len(files), api_gp_rhs=90,
        api_gp_s=f"{api_s:.3f}", api_gp_peak_gib=f"{api_peak:.3f}",
        api_gp_nan=api_nan,
        api_gp_alpha_absmax=f"{float(api.alpha_vecs.abs().max()):.3e}",
        sklearn_gp_points=GP_SUBSET, sklearn_gp_steps=GP_STEPS,
        sklearn_gp_s=f"{skl_s:.3f}", sklearn_gp_peak_gib=f"{skl_peak:.3f}",
        nll_first=f"{nll[0]:.4f}", nll_last=f"{nll[-1]:.4f}",
        sklearn_gp_steps_run=len(nll),
        sklearn_gp_stopped_at=skl.stopped_at,
        sklearn_gp_bound_from=skl.bound_from,
        sklearn_gp_nan=skl_nan, held_out=GP_HELD_OUT,
        api_gp_card_vs_cpu_mag=f"{errs['api_gp']:.3e}",
        sklearn_gp_card_vs_cpu_mag=f"{errs['sklearn_gp']:.3e}",
        tolerance_mag=GP_MAG_TOL)


def lfi_phase(np, torch, tmp):
    """[lfi]: lightcurve-analysis --sampler neuralnet on the [cli]
    configuration at the JAX package's defaults (3,000 simulations through
    K1, 400 epochs, 20,000 draws), then with --lfi-vicreg-pretrain (60
    epochs), then with --lfi-pretrained-embedding on a seeded state dict
    saved under the reference's key names. Returns the runs' K1
    launches."""
    from nmma_tpu_torch.cli import lightcurve_analysis
    from nmma_tpu_torch.mlmodel.inference import SIM_BATCH
    from nmma_tpu_torch.mlmodel.pretrained import seeded_state_dict

    config, config_path = cli_config(tmp)
    weights = os.path.join(tmp, "similarity_embedding_weights.pth")
    torch.save(seeded_state_dict(18), weights)
    truth = {**INJECTION, **CLI_INJECTION}
    runs = (("flow", []),
            ("vicreg", ["--lfi-vicreg-pretrain", "--lfi-vicreg-epochs",
                        str(LFI_VICREG_EPOCHS)]),
            ("pretrained", ["--lfi-pretrained-embedding",
                            "--lfi-embedding-weights", weights]))
    launches = {}
    for name, flags in runs:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        analysis = lightcurve_analysis.main(
            [config_path, "--sampler", "neuralnet", "--label",
             f"lfi_{name}", *flags])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        # the injection's light curve, then the simulations in batches of
        # at most SIM_BATCH
        expected = 1 + -(-LFI_SIMULATIONS // SIM_BATCH)
        assert_launches("lfi", expected)
        launches[name] = expected
        result = np.load(os.path.join(config["outdir"],
                                      f"lfi_{name}_result.npz"))
        keys = sorted(result.files)
        want = sorted(["sampler"] + [f"posterior_{k}" for k in
                                     analysis.priors.sampled_names])
        post = analysis.neuralnet_posterior
        if keys != want or any(v.shape != (20000,) or
                               not np.isfinite(v).all()
                               for v in post.values()):
            raise RuntimeError(f"[lfi] {name}: result keys {keys}")
        inside = {k: bool(np.quantile(v, 0.05) <= truth[k]
                          <= np.quantile(v, 0.95))
                  for k, v in post.items() if k in truth}
        timing = analysis.lfi_timings
        say("lfi", run=name, seconds=f"{seconds:.2f}",
            simulate_s=f"{timing['simulate_s']:.3f}",
            train_s=f"{timing['train_s']:.3f}",
            sample_s=f"{timing['sample_s']:.3f}",
            **({"vicreg_s": f"{timing['vicreg_s']:.3f}"}
               if "vicreg_s" in timing else {}),
            k1_launches=expected, simulations=LFI_SIMULATIONS,
            draws=len(next(iter(post.values()))),
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            keys=",".join(keys),
            inside_90=",".join(k for k, v in inside.items() if v),
            outside_90=",".join(k for k, v in inside.items() if not v)
            or "none")
    return launches


def tov_emulator_phase(np, torch, gen):
    """[tov_emulator]: train_tov_emulator on the [eos] crust at its
    defaults (128 NEP EOS, hidden 64, 4,000 epochs) on the card; M_TOV and
    R_1.4 at 32 held-out NEP points against the port's TOV solver; the
    emulator step and a seeded LEC-13 set at B = BATCH, card against CPU."""
    from nmma_tpu_torch.eos import emulator, lec

    timings = {}
    t0 = time.time()
    reset_launches()
    emu = emulator.train_tov_emulator(crust_table(np), device=DEVICE,
                                      timings=timings)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    rng = np.random.default_rng(21)
    held = rng.uniform([28.0, 30.0], [36.0, 90.0], (TOV_HELD_OUT, 2))
    keep, truth = emulator.emulator_targets(held, ["S0", "L"],
                                            crust_table(np), device=DEVICE)
    got = emu({"S0": torch.tensor(held[keep, 0], dtype=torch.float32,
                                  device=DEVICE),
               "L": torch.tensor(held[keep, 1], dtype=torch.float32,
                                 device=DEVICE)})
    d_mtov = np.abs(got["TOV_mass"].cpu().numpy() - truth[:, 0])
    r14 = np.array([np.interp(1.4 / row[0], emulator.X_GRID,
                              row[1:1 + len(emulator.X_GRID)])
                    for row in truth])
    d_r14 = np.abs(got["R_14"].cpu().numpy() - r14)
    if d_mtov.max() > TOV_MTOV_TOL or d_r14.max() > TOV_R14_TOL:
        raise RuntimeError(f"the emulator off its solver: M_TOV "
                           f"{d_mtov.max()}, R_1.4 {d_r14.max()}")

    path_emu = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_emu_"),
                            "emu.npz")
    emu.save(path_emu)
    emu_cpu = emulator.TOVEmulator.load(path_emu, device="cpu")
    u = torch.rand((4, BATCH), generator=gen, device=DEVICE)
    params = {"S0": 28.0 + 8.0 * u[0], "L": 30.0 + 60.0 * u[1],
              "mass_1_source": 1.0 + 1.5 * u[2],
              "mass_2_source": 1.0 + 0.6 * u[3]}
    step_ms = time_ms(torch, lambda: emu(params))

    def worst(card, cpu_fn, ps):
        out = card(ps)
        ref = cpu_fn({k: v.cpu() for k, v in ps.items()})
        errs = []
        for k in out:
            a, b = out[k].cpu(), ref[k]
            same = torch.isnan(a) == torch.isnan(b)
            if not bool(same.all()):
                raise RuntimeError(f"NaN placement differs in {k}")
            ok = ~torch.isnan(b)
            errs.append(float(((a - b).abs()[ok] / b.abs()[ok].clamp(
                min=1e-6)).max()) if bool(ok.any()) else 0.0)
        return max(errs)
    emu_err = worst(emu, emu_cpu, params)
    t0 = time.perf_counter()
    emu_cpu({k: v.cpu() for k, v in params.items()})
    emu_cpu_ms = 1e3 * (time.perf_counter() - t0)

    lec_rng = np.random.default_rng(22)
    n_p, n_m = len(lec.LEC13_PARAMETERS), 30

    def layers(out, scale):
        return ((lec_rng.normal(0, 0.3, (n_p, 64)),
                 lec_rng.normal(0, 0.1, 64)),
                (lec_rng.normal(0, scale, (64, out)),
                 lec_rng.normal(0, 0.1, out)))
    fields = dict(parameter_names=lec.LEC13_PARAMETERS,
                  feat_loc=np.zeros(n_p), feat_scale=np.ones(n_p),
                  mass_layers=((lec_rng.normal(0, 0.3, (n_p, 64)),
                                lec_rng.normal(0, 0.1, 64)),
                               (lec_rng.normal(0, 0.02, (64, 1)),
                                np.array([2.1]))),
                  radius_layers=layers(n_m, 0.2),
                  lambda_layers=layers(n_m, 0.2),
                  radius_loc=np.full(n_m, 12.0),
                  radius_scale=np.full(n_m, 0.5),
                  lambda_loc=np.linspace(3.5, 0.5, n_m),
                  lambda_scale=np.full(n_m, 0.2))
    lec_card = lec.LECEmulatorSet.from_numpy(device=DEVICE, **fields)
    lec_cpu = lec.LECEmulatorSet.from_numpy(device="cpu", **fields)
    lp = {k: torch.randn(BATCH, generator=gen, device=DEVICE)
          for k in lec.LEC13_PARAMETERS}
    lp["mass_1_source"] = params["mass_1_source"]
    lp["mass_2_source"] = params["mass_2_source"]
    lec_err = worst(lec_card, lec_cpu, lp)
    lec_ms = time_ms(torch, lambda: lec_card(lp))
    assert_launches("tov_emulator", 0)
    if emu_err > EMULATOR_RTOL or lec_err > EMULATOR_RTOL:
        raise RuntimeError(f"emulator steps card against CPU: {emu_err}, "
                           f"LEC {lec_err}")
    say("tov_emulator", eos=timings["n_eos"], hidden=64,
        epochs=timings["epochs"], targets_s=f"{timings['targets_s']:.3f}",
        fit_s=f"{timings['fit_s']:.3f}", train_s=f"{train_s:.3f}",
        mse=f"{timings['mse']:.3e}", held_out=len(keep),
        max_dmtov=f"{d_mtov.max():.4f}", max_dr14_km=f"{d_r14.max():.4f}",
        step_batch=BATCH, step_ms=f"{step_ms:.4f}",
        step_cpu_ms=f"{emu_cpu_ms:.3f}", step_max_rel=f"{emu_err:.3e}",
        lec13_ms=f"{lec_ms:.4f}", lec13_max_rel=f"{lec_err:.3e}")


def training_path(np, torch):
    """The item-18 phases: [k1_general], [svd_train], [native] (on
    [svd_train]'s grid), [gp_train], [lfi], [tov_emulator]. Returns the
    fields they add to K1's kernel-line entry, and [native]'s seconds as
    native_s."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(18)
    t0 = time.time()
    fields = k1_general(np, torch, gen)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        grid_dir, train_fields = svd_train(np, torch, gen, tmp)
        fields.update(train_fields)
        t_native = time.time()
        native_phase(np, grid_dir)
        fields["native_s"] = time.time() - t_native
        gp_train(np, torch, gen, grid_dir, tmp)
        fields["launches_lfi"] = lfi_phase(np, torch, tmp)
    tov_emulator_phase(np, torch, gen)
    say("training_phases", seconds=f"{time.time() - t0:.2f}")
    return fields


# --- item 19a: survey cadences, the thin tools, the native loader, the
# model registry (K1 only) ---

CADENCES = {"ztf": dict(ztf_sampling=True, ztf_uncertainties=True,
                        ztf_too="180"),
            "rubin": dict(rubin_too_type="platinum")}
CADENCE_SEEDS = (1, 2, 3, 4)
CADENCE_EDGE = 1e-4     # mag: flags and errors may differ this near an edge
CADENCE_CLI_CAP = 40
CADENCE_FILTERS = "ztfg,ztfr,ztfi"     # ZTF epochs exist in these only
CADENCE_SYSTEMATICS = {
    "optical": {"filters": ["ztfg", "ztfr", "ztfi"], "time_nodes": 3,
                "time_range": "linear 0.5 12.0",
                "prior": "Uniform(minimum=0.0, maximum=1.0)"}}
TOOLS_GENERATION_ROWS = 16
TOOLS_INJECTIONS = 64
TOOLS_RESAMPLING_NLIVE = 128
REGISTRY_MODEL = "Bu2019lm_registry_tf"
REGISTRY_CORE = "Bu2019lm_registry"        # the name it registers under
# the surrogate's filters whose names the registry keeps (ps1::z is ps1__z)
REGISTRY_FILTERS = ["sdssu", "ztfg", "ztfr", "ztfi", "2massj", "2massh",
                    "2massks"]


def cadences_phase(np, torch):
    """[cadences]: create_light_curve_data on the production surrogate at
    TRIGGER_MJD with each of CADENCES and CADENCE_SEEDS, on the card (one
    K1 launch) and with device="cpu": epochs and limits equal bit for bit,
    magnitudes within K1_TOL, detection flags and drawn errors equal except
    at epochs within CADENCE_EDGE of their limit or of an uncertainty
    interval's edge (counted). Then the [cli] configuration with
    --ztf-sampling --ztf-uncertainties on CADENCE_FILTERS, capped at
    CADENCE_CLI_CAP iterations: K1 launches 2 + iterations x walks. Returns
    the CLI run's K1 launches."""
    from nmma_tpu_torch.injections import create_light_curve_data
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.strategies import ZTFObservingModel

    svd_cpu = SVDModelData.load(ARTIFACT, device="cpu")
    make_svd_source_model(MODEL + "_cpu", svd_cpu)
    filters = list(svd_cpu.filters)
    edges = ZTFObservingModel().interval_edges()
    for case, kwargs in CADENCES.items():
        epochs, detections, near, seconds = {}, {}, 0, 0.0
        for seed in CADENCE_SEEDS:
            limits, limits_cpu = {}, {}
            reset_launches()
            t0 = time.time()
            card = create_light_curve_data(
                INJECTION, MODEL, filters, trigger_time=TRIGGER_MJD,
                seed=seed, keep_infinite_data=True, ztf_limits=limits,
                **kwargs)
            torch.cuda.synchronize()
            seconds += time.time() - t0
            assert_launches("cadences", 1)
            cpu = create_light_curve_data(
                INJECTION, MODEL + "_cpu", filters, trigger_time=TRIGGER_MJD,
                seed=seed, keep_infinite_data=True, ztf_limits=limits_cpu,
                device="cpu", **kwargs)
            if sorted(card) != sorted(cpu) or not card:
                raise RuntimeError(f"[cadences] {case}: filters {sorted(card)}"
                                   f" on the card, {sorted(cpu)} on the CPU")
            for f in cpu:
                g, w = card[f], cpu[f]
                if not np.array_equal(g["time"], w["time"]) or not all(
                        np.array_equal(limits[k], limits_cpu[k])
                        for k in limits_cpu):
                    raise RuntimeError(f"[cadences] {case} {f}: epochs or "
                                       "limits differ from the CPU's")
                fin = np.isfinite(w["mag"])
                if not np.array_equal(np.isfinite(g["mag"]), fin) or (
                        fin.any() and np.abs(g["mag"][fin] - w["mag"][fin])
                        .max() > K1_TOL):
                    raise RuntimeError(f"[cadences] {case} {f}: magnitudes "
                                       "off the CPU's")
                close = np.zeros(len(w["mag"]), dtype=bool)
                if f in limits_cpu:
                    # a detection (on either side) this near its limit or
                    # an interval edge may flip or draw another error
                    for side in (g, w):
                        mag = np.where(np.isfinite(side["mag_error"]),
                                       side["mag"], np.inf)
                        close |= (np.abs(mag - limits_cpu[f])
                                  <= CADENCE_EDGE) | (np.abs(
                                      mag[:, None] - edges[None, :])
                                      .min(axis=1) <= CADENCE_EDGE)
                if not np.array_equal(g["mag_error"][~close],
                                      w["mag_error"][~close]):
                    raise RuntimeError(f"[cadences] {case} {f}: detections "
                                       "or errors differ off the edges")
                near += int(close.sum())
                epochs[f] = epochs.get(f, 0) + len(w["time"])
                detections[f] = detections.get(f, 0) + int(
                    np.isfinite(g["mag_error"]).sum())
        say("cadences", case=case, seeds=len(CADENCE_SEEDS),
            seconds=f"{seconds:.3f}", near_edge=near,
            epochs=",".join(f"{f}:{n}" for f, n in sorted(epochs.items())),
            detections=",".join(f"{f}:{n}" for f, n in
                                sorted(detections.items())))

    import yaml
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cadences_") as tmp:
        config, config_path = cli_config(tmp)
        with open(os.path.join(tmp, "ztf_systematics.yaml"), "w") as f:
            yaml.safe_dump(CADENCE_SYSTEMATICS, f)
        t0 = time.time()
        reset_launches()
        with capped_cli(CADENCE_CLI_CAP) as cli:
            analysis = cli.main([
                config_path, "--ztf-sampling", "--ztf-uncertainties",
                "--filters", CADENCE_FILTERS, "--systematics-file",
                os.path.join(tmp, "ztf_systematics.yaml"), "--label",
                "cadences"])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        result = analysis.result
        launches = 2 + result.niter * analysis.config.sampler.walks \
            + BESTFIT_LAUNCHES
        assert_launches("cadences", launches)
        if not math.isfinite(result.logz) or \
                result.niter > CADENCE_CLI_CAP:
            raise RuntimeError(f"[cadences] CLI run: logZ {result.logz} "
                               f"after {result.niter} iterations")
        data = analysis.data_dict
        say("cadences", case="cli", iterations=result.niter,
            logz=f"{result.logz:.4f}", seconds=f"{seconds:.2f}",
            k1_launches=launches, k1_expected=f"3+{result.niter}x"
            f"{analysis.config.sampler.walks}",
            epochs=",".join(f"{f}:{len(data[f]['time'])}" for f in
                            sorted(data)))
    return launches


def tools_phase(np, torch, tmp):
    """[tools]: each entry point cli/tools.py gained in this slice, once on
    the card where it runs a model or a sampler, on files earlier phases
    wrote under ``tmp`` ([eos]'s tables, [possis]'s spectrum) or seeded
    ones; seconds and files written for each. lightcurve-generation on a
    TOOLS_GENERATION_ROWS-row injection file must launch K1 once a row;
    multi-config-analysis starts one subprocess of the port's CLI (rc 0, on
    the card). Returns lightcurve-generation's K1 launches."""
    import shutil

    import yaml

    from nmma_tpu_torch.cli import tools
    from nmma_tpu_torch.injections import write_injection_file

    eos_dir = os.path.join(tmp, "eos")
    work = os.path.join(tmp, "tools")
    os.makedirs(work)
    rng = np.random.default_rng(19)
    t_start = time.time()

    def run(name, fn, *args, launches=(0, 0, 0), **kwargs):
        reset_launches()
        t0 = time.time()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        if kernel_launches() != launches:
            raise RuntimeError(f"[tools] {name} launched K1-K3 "
                               f"{kernel_launches()}, expected {launches}")
        written = sum(len(files) for _, _, files in os.walk(work))
        say("tools", command=name, seconds=f"{time.time() - t0:.3f}",
            files_in_workdir=written)
        return out

    n = TOOLS_GENERATION_ROWS
    write_injection_file(os.path.join(work, "rows.json"), {
        "log10_mej_dyn": rng.uniform(-3.0, -1.0, n),
        "log10_mej_wind": rng.uniform(-2.0, -0.5, n),
        "KNphi": rng.uniform(15.0, 75.0, n),
        "KNtheta": rng.uniform(0.0, 90.0, n),
        "luminosity_distance": rng.uniform(20.0, 200.0, n),
        "timeshift": np.zeros(n)})
    paths = run("lightcurve-generation", tools.lightcurve_generation,
                ["--model", MODEL, "--injection",
                 os.path.join(work, "rows.json"), "--outdir",
                 os.path.join(work, "lcs")], launches=(n, 0, 0))
    if len(paths) != n:
        raise RuntimeError(f"[tools] lightcurve-generation wrote {paths}")

    with open(os.path.join(work, "bns.prior"), "w") as f:
        f.write(JOINT_PRIOR_TEXT.replace(
            "maximum=10.)", f"maximum={float(len(EOS_SLOPES))})"))
    params = run("nmma-create-injection", tools.create_injection,
                 ["--prior-file", os.path.join(work, "bns.prior"),
                  "--n-injection", str(TOOLS_INJECTIONS),
                  "--ejecta-conversion",
                  "--eos-dir", eos_dir, "-f", os.path.join(work, "bns.json")])
    if not np.all(np.isfinite(params["log10_mej_dyn"])):
        raise RuntimeError("[tools] nmma-create-injection: ejecta not finite")

    m = 2000
    gw = {"chirp_mass": rng.normal(1.1977, 0.001, m),
          "mass_ratio": rng.uniform(0.7, 1.0, m),
          "luminosity_distance": rng.normal(40.0, 4.0, m),
          "EOS": rng.uniform(0.0, len(EOS_SLOPES), m)}
    em = {"log10_mej_dyn": rng.normal(-2.2, 0.2, m),
          "log10_mej_wind": rng.normal(-1.6, 0.2, m),
          "luminosity_distance": rng.normal(42.0, 5.0, m)}
    for name, post in (("gw", gw), ("em", em)):
        np.savetxt(os.path.join(work, f"{name}.csv"),
                   np.column_stack(list(post.values())), delimiter=",",
                   header=",".join(post), comments="")
    gw_csv, em_csv = (os.path.join(work, f"{k}.csv") for k in ("gw", "em"))
    result, _ = run(
        "gwem-resampling", tools.gwem_resampling,
        ["--GWsamples", gw_csv, "--EMsamples", em_csv, "--EOS-data", eos_dir,
         "--nlive", str(TOOLS_RESAMPLING_NLIVE), "--outdir", work],
        sampler_kwargs={"max_iter": RESAMPLING_ITERATIONS})
    if not math.isfinite(result.logz):
        raise RuntimeError(f"[tools] gwem-resampling logZ {result.logz}")
    med, lo, hi = run("gwem-Hubble-estimate", tools.gwem_hubble_estimate,
                      ["--posterior-files", em_csv, "--redshifts", "0.0098",
                       "--outdir", work])
    run("gwem-Hubble-estimate --gw-posterior-files",
        tools.gwem_hubble_estimate,
        ["--posterior-files", f"{em_csv},{em_csv}", "--gw-posterior-files",
         f"{gw_csv},{gw_csv}", "--redshifts", "0.0098,0.0098",
         "--N-reordering", "2", "--N-posterior-samples", "300",
         "--outdir", work])
    _, trend = run("combine-EOS", tools.combine_eos,
                   ["--posterior-files", gw_csv, "--eos-data", eos_dir,
                    "--outdir", work])
    with open(os.path.join(work, "skyportal.csv"), "w") as f:
        f.write("mjd,filter,mag,magerr,limiting_mag\n" + "".join(
            f"{TRIGGER_MJD + 0.5 * i},ztf{'gri'[i % 3]},"
            f"{19.0 + 0.1 * i},0.05,21.0\n" for i in range(12)))
    run("convert-skyportal-lcs", tools.convert_skyportal,
        ["--csv-file", os.path.join(work, "skyportal.csv"), "--outfile",
         os.path.join(work, "skyportal.dat")])
    modeldir = os.path.join(work, "possis")
    os.makedirs(modeldir)
    shutil.copy(os.path.join(tmp, "possis_spectra.txt"),
                os.path.join(modeldir, "nph1e6_mej0.05.txt"))
    lcs = run("nmma-make-lcs", tools.make_lcs,
              ["--modeldir", modeldir, "--lcdir",
               os.path.join(work, "possis_lcs"), "--dMpc", "40",
               "--filters", ",".join(POSSIS_FILTERS)])
    if not lcs:
        raise RuntimeError("[tools] nmma-make-lcs wrote nothing")

    config, _ = cli_config(work)
    flags = {"model": "Bu2019lm_multi", "svd_path": ARTIFACT,
             "prior": config["prior"], "injection": config["injection"],
             "filters": CADENCE_FILTERS, "tmin": 0.5, "tmax": 11.0,
             "nlive": 64, "n_delete": 16, "walks": 4, "dlogz": 50.0,
             "check_point_delta_t": 1e6,
             "outdir": os.path.join(work, "multi")}
    with open(os.path.join(work, "runs.yaml"), "w") as f:
        yaml.safe_dump({"multi_cli": flags}, f)
    out = run("multi-config-analysis", tools.multi_config,
              ["--config", os.path.join(work, "runs.yaml")])
    if out != [("multi_cli", 0)] or not os.path.exists(
            os.path.join(work, "multi", "multi_cli_result.npz")):
        raise RuntimeError(f"[tools] multi-config-analysis gave {out}")

    with open(os.path.join(work, "job.sh"), "w") as f:
        f.write("python -m nmma_tpu_torch.cli.lightcurve_analysis --prior "
                "PRIOR --outdir OUTDIR --injection-num INJNUM\n")
    run("lightcurve-injection-slurm-setup", tools.injection_slurm_setup,
        ["--prior-file", os.path.join(work, "bns.prior"), "--analysis-file",
         os.path.join(work, "job.sh"), "--n-injection", "4", "--outdir",
         os.path.join(work, "jobs")])
    run("create-lightcurve-slurm", tools.create_lightcurve_slurm,
        ["--injection", os.path.join(work, "rows.json"), "--analysis-file",
         os.path.join(work, "job.sh"), "--n-per-job", "5", "--outdir",
         os.path.join(work, "lc_jobs")])
    # the two entry points that draw (this slice): host matplotlib only
    if matplotlib_present():
        with open(os.path.join(work, "Bu2019lm_benchmark.json"), "w") as f:
            json.dump({f"ztf{b}": sorted(rng.uniform(0.01, 5.0, 5).tolist())
                       for b in "gri"}, f)
        outs = [run("plot-svdmodel-benchmarks",
                    tools.plot_svdmodel_benchmarks,
                    ["--benchmark-file",
                     os.path.join(work, "Bu2019lm_benchmark.json"),
                     "--outdir", os.path.join(work, "bench_plot")])]
        np.savetxt(os.path.join(work, "posterior.csv"),
                   rng.normal(size=(400, 2)) + [-2.0, -1.2], delimiter=",",
                   header="log10_mej_dyn,log10_mej_wind", comments="")
        outs.append(run("nmma-plot-multi-corner",
                        tools.COMMANDS["nmma-plot-multi-corner"],
                        [os.path.join(work, "multi", "multi_cli_result.npz"),
                         os.path.join(work, "posterior.csv"), "--parameters",
                         "log10_mej_dyn,log10_mej_wind", "--outfile",
                         os.path.join(work, "multi_corner.png")]))
        if not all(os.path.getsize(o) > 0 for o in outs):
            raise RuntimeError(f"[tools] empty figures {outs}")
    else:
        for name in ("plot-svdmodel-benchmarks", "nmma-plot-multi-corner"):
            say("tools", command=name, result="not run: matplotlib absent")
    say("tools", h0=f"{med:.2f}", h0_68=f"{lo:.2f},{hi:.2f}",
        r14=f"{trend[-1][0]:.3f}", seconds=f"{time.time() - t_start:.2f}")
    return n


def native_phase(np, grid_dir):
    """[native]: which loader reads the tables, then parse_many over the
    [svd_train] grid's bulla files against np.loadtxt, bit for bit, with
    the seconds of each."""
    import glob

    from nmma_tpu_torch import native

    files = sorted(glob.glob(os.path.join(grid_dir, "*.dat")))
    t0 = time.time()
    available = native.native_available()
    setup_s = time.time() - t0
    t0 = time.time()
    tables = native.parse_many(files)
    native_s = time.time() - t0
    t0 = time.time()
    want = [np.loadtxt(f, ndmin=2) for f in files]
    loadtxt_s = time.time() - t0
    if len(files) != TRAIN_POINTS or not all(
            np.array_equal(a, b) and a.dtype == b.dtype
            for a, b in zip(tables, want)):
        raise RuntimeError(f"[native] {len(files)} files; parse_many "
                           "differs from np.loadtxt")
    say("native", native_available=available,
        loader=os.path.relpath(native.loader(), HERE) if available
        else native.loader(), files=len(files),
        rows_cols=f"{want[0].shape[0]}x{want[0].shape[1]}",
        setup_s=f"{setup_s:.3f}", parse_many_s=f"{native_s:.4f}",
        loadtxt_s=f"{loadtxt_s:.4f}")


def serve_directory(root):
    """A ThreadingHTTPServer on 127.0.0.1, port 0, serving ``root`` from a
    thread: (base URL, stop)."""
    import threading
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        lambda *a, **kw: Quiet(*a, directory=root, **kw))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    return f"http://127.0.0.1:{server.server_address[1]}", stop


def registry_logl(np, torch, gen, name, direct, filters, tmp):
    """EMAnalysis.batched_logl at B = BATCH through surrogate ``name`` and
    through ``direct`` on the same photometry, prior and unit points: the
    two must agree bit for bit, and each call launches K1 once. Returns
    the finite share."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig

    data_path = os.path.join(tmp, f"{name}.dat")
    synthetic_photometry(np, torch, direct, filters, data_path, INJECTION,
                         sample_times=(0.01, 14.0, 150), epochs=(0.5, 12.0))
    prior_path = os.path.join(tmp, "registry.prior")
    with open(prior_path, "w") as f:
        f.write(PRIOR_TEXT)
    logl, u = [], None
    for model in (name, direct):
        analysis = EMAnalysis(EMAnalysisConfig(
            model=model, prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, data_tmax=12.5, filters=filters),
            device=DEVICE)
        if u is None:
            u = analysis.priors.sample_units(gen, BATCH)
        reset_launches()
        logl.append(analysis.batched_logl(u))
        torch.cuda.synchronize()
        assert_launches("registry", 1)
    if not torch.equal(logl[0], logl[1]):
        raise RuntimeError(f"[registry] {name}'s logL differs from the .npz "
                           "surrogate's by "
                           f"{float((logl[0] - logl[1]).abs().max())}")
    return float((logl[0] > -1e29).float().mean())


def registry_phase(np, torch):
    """[registry]: a reference-layout registry tree written from the
    production surrogate (models.yaml, a joblib core, keras-layout h5
    weights a filter) served on 127.0.0.1; download_model, the ingestion
    onto the card, and batched_logl at B = BATCH (one K1 launch) equal bit
    for bit to the surrogate loaded from its .npz (REGISTRY_FILTERS, the
    names the registry keeps). Then get_model through a hook that copies
    the .npz and load_registered_model, with the same check on every
    filter. Without joblib or h5py the first half names the missing
    package. Returns the K1 launches."""
    import importlib.util
    import shutil

    from nmma_tpu_torch import registry

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(20)
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as tmp:
        missing = [m for m in ("joblib", "h5py")
                   if importlib.util.find_spec(m) is None]
        if missing:
            say("registry", reference_format="skipped",
                missing=",".join(missing))
        else:
            with np.load(ARTIFACT) as z:
                arrays = {k: z[k] for k in z.files}
            root = os.path.join(tmp, "served")
            t0 = time.time()
            registry.write_reference_layout(root, REGISTRY_MODEL, arrays)
            write_s = time.time() - t0
            url, stop = serve_directory(root)
            try:
                t0 = time.time()
                paths, _ = registry.download_model(
                    REGISTRY_MODEL, models_home=os.path.join(tmp, "home"),
                    base_url=url)
                download_s = time.time() - t0
                t0 = time.time()
                svd = registry.load_reference_registry_model(
                    REGISTRY_MODEL, models_home=os.path.join(tmp, "home"),
                    base_url=url, device=DEVICE)
                ingest_s = time.time() - t0
            finally:
                stop()
            finite = registry_logl(np, torch, gen, REGISTRY_CORE, MODEL,
                                   REGISTRY_FILTERS, tmp)
            launches += 1
            size = sum(os.path.getsize(p) for p in paths)
            say("registry", reference_format="ok", files=len(paths),
                megabytes=f"{size / 1e6:.2f}",
                write_s=f"{write_s:.3f}", download_s=f"{download_s:.3f}",
                ingest_s=f"{ingest_s:.3f}", batch=BATCH,
                finite_share=f"{finite:.4f}", logl="bit for bit")

        def hook(name, home):
            shutil.copy(ARTIFACT, os.path.join(home, f"{name}.npz"))

        registry.set_download_hook(hook)
        try:
            t0 = time.time()
            svd = registry.load_registered_model(
                "Bu2019lm_hooked", models_home=os.path.join(tmp, "hooked"),
                device=DEVICE)
            load_s = time.time() - t0
        finally:
            registry.set_download_hook(None)
        finite = registry_logl(np, torch, gen, "Bu2019lm_hooked", MODEL,
                               list(svd.filters), tmp)
        launches += 1
        say("registry", hook="ok", load_s=f"{load_s:.3f}", batch=BATCH,
            filters=len(svd.filters), finite_share=f"{finite:.4f}",
            logl="bit for bit")
    return launches


# the thirteenth slice: best-fit reports, light-curve bands, the analysis
# service and the SkyPortal bridge. The best-fit report is one model call at
# the best-fit point (plotting.compute_chisquare_dict): one K1 launch on
# every lightcurve-analysis run that samples, now that --bestfit is on by
# default as in the JAX package
BESTFIT_LAUNCHES = 1
# the report's chi^2/dof on the card against the port on the CPU at the
# same best-fit point, on the same data: 1e-3 + 1e-3 chi^2/dof
BESTFIT_ATOL, BESTFIT_RTOL = 1e-3, 1e-3
# lightcurve_bands on the card against the same call with the plain kernel
# on the card: K1's 1e-4 mag; Me2017 1e-3 mag (K2's ltot within 1e-4
# relative and r_photo bit for bit, through T_eff and the Planck factor,
# tests/test_torch_em_slice.py); TrPi2018 [grb_ramp]'s 1e-3 mag below
# FAINT_MAG
LC_BANDS_TOL = {"Bu2019lm": K1_TOL, "Me2017": 1e-3, "TrPi2018": RAMP_MAG_TOL}
LC_BANDS_DRAWS = 60
# the analysis service: tests/test_services.py:38-91's Me2017 request, and
# a TrPi2018 request at config 3's injection (three parameters free), both
# at nlive 64
SERVICE_ME_TRUTH = {"log10_mej": -1.4, "log10_vej": -1.1, "beta": 3.0,
                    "log10_kappa_r": 0.7, "luminosity_distance": 40.0,
                    "timeshift": 0.0}
SERVICE_ME_PRIOR = """\
log10_mej = Uniform(minimum=-3., maximum=-0.5)
log10_vej = -1.1
beta = 3.0
log10_kappa_r = 0.7
luminosity_distance = 40.0
timeshift = 0.0
"""
SERVICE_GRB_PRIOR = """\
log10_E0 = Uniform(minimum=50., maximum=53.)
thetaCore = Uniform(minimum=0.05, maximum=0.2)
thetaWing = 0.4
inclination_EM = 0.05
log10_n0 = Uniform(minimum=-3., maximum=0.)
p = 2.4
log10_epsilon_e = -1.2
log10_epsilon_B = -3.0
xi_N = 1.0
luminosity_distance = 350.0
timeshift = 0.0
"""
SERVICE_SAMPLER = {"nlive": 64, "walks": 8, "dlogz": 1.0, "max_iter": 150}
# the SkyPortal bridge: Me2017 photometry from 0.5 d after the event (the
# bridge's trigger is the first epoch, so the timeshift reaches back to
# it), a redshift csv and fix_z (the distance pinned from the cosmology);
# nlive 128 through analysis_parameters, so that the run holds more than
# LC_BANDS_DRAWS equal-weight samples (562 at nlive 256 and 67 at the
# bridge's default 32 in a CPU run of this payload)
SKYPORTAL_NLIVE = 128
SKYPORTAL_PRIOR = """\
log10_mej = Uniform(minimum=-3., maximum=-0.5)
log10_vej = Uniform(minimum=-2., maximum=-0.5)
beta = 3.0
log10_kappa_r = 0.7
luminosity_distance = Uniform(minimum=10., maximum=100.)
timeshift = Uniform(minimum=-1., maximum=0.)
"""


def matplotlib_present():
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def bestfit_check(np, torch, analysis, label):
    """[bestfit]: ``label``_bestfit.json of a CLI run on the card; then
    compute_chisquare_dict at its best-fit point on the card, counted (one
    K1 launch exactly); that table and the report's each within
    BESTFIT_ATOL + BESTFIT_RTOL chi^2/dof of the port's compute on the CPU
    at the same point on the same data (the production surrogate loaded on the CPU
    under a name of its own). Returns the report's K1 launches."""
    import dataclasses

    from nmma_tpu_torch.analysis import EMAnalysis
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.plotting import compute_chisquare_dict

    with open(label + "_bestfit.json") as f:
        report = json.load(f)
    if report["log_evidence"] != analysis.result.logz or \
            report["Best fit index"] != int(np.argmax(analysis.result.logl)):
        raise RuntimeError(f"[bestfit] the report does not describe the run: "
                           f"{report['log_evidence']}, "
                           f"{report['Best fit index']}")
    reset_launches()
    t0 = time.time()
    card = compute_chisquare_dict(analysis, report["posterior_parameters"])
    torch.cuda.synchronize()
    card_s = time.time() - t0
    counted = kernel_launches()
    if counted != (BESTFIT_LAUNCHES, 0, 0):
        raise RuntimeError(f"[bestfit] the report launched K1-K3 {counted} "
                           f"times; expected ({BESTFIT_LAUNCHES}, 0, 0)")
    cpu_model = make_svd_source_model(
        MODEL + "_bestfit_cpu", SVDModelData.load(ARTIFACT, device="cpu"))
    cpu = EMAnalysis(dataclasses.replace(
        analysis.config, model=cpu_model.name, trigger_time=0.0),
        data=analysis.data_dict, priors=analysis.priors, device="cpu")
    t0 = time.time()
    want = compute_chisquare_dict(cpu, report["posterior_parameters"])
    cpu_s = time.time() - t0
    worst = 0.0
    for table in (card, report["chi2_per_dof"]):
        if sorted(table) != sorted(want):
            raise RuntimeError(f"[bestfit] filters {sorted(table)} against "
                               f"the CPU's {sorted(want)}")
        for filt, row in want.items():
            for key in ("chi2_per_dof", "chi2_per_dof_with_systematics"):
                err = abs(table[filt][key] - row[key])
                worst = max(worst, err / (BESTFIT_ATOL
                                          + BESTFIT_RTOL * abs(row[key])))
            if table[filt]["n_points"] != row["n_points"]:
                raise RuntimeError(f"[bestfit] {filt}: {table[filt]} "
                                   f"against {row}")
    if not worst <= 1.0:
        raise RuntimeError(f"[bestfit] chi^2/dof off the CPU's: the card "
                           f"{card}, the report {report['chi2_per_dof']}, "
                           f"the CPU {want}")
    say("bestfit", file=os.path.basename(label) + "_bestfit.json",
        filters=len(card), log_likelihood=f"{report['log_likelihood']:.3f}",
        chi2_per_dof=",".join(f"{f}:{r['chi2_per_dof']:.3f}"
                              for f, r in sorted(card.items())),
        worst_over_tolerance=f"{worst:.3e}", card_s=f"{card_s:.3f}",
        cpu_s=f"{cpu_s:.3f}", k1_launches=counted[0])
    return counted[0]


def lc_bands(np, torch, model, analysis, result, module, attr, plain,
             launches, tmp, faint=math.inf):
    """[lc_bands]: plotting.lightcurve_bands on the card (the best fit and
    LC_BANDS_DRAWS posterior draws in one model call: ``launches`` (K1, K2,
    K3) exactly; ``result`` must hold at least LC_BANDS_DRAWS equal-weight
    samples) against the same call with ``module.attr`` swapped for its
    plain version ``plain`` on the card, within LC_BANDS_TOL[model] (below
    ``faint``), inf and NaN in the same places; the figure drawn only where
    matplotlib is present, after the counted call. Returns the kernel's
    launches."""
    from nmma_tpu_torch.plotting import lightcurve_bands, lightcurve_fit_plot

    reset_launches()
    t0 = time.time()
    got = lightcurve_bands(analysis, result, LC_BANDS_DRAWS)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counted = kernel_launches()
    kernel_fn = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        want = lightcurve_bands(analysis, result, LC_BANDS_DRAWS)
    finally:
        setattr(module, attr, kernel_fn)
    err = 0.0
    for key in ("best", "draws", "lo", "hi"):
        g, w = got[key], want[key]
        if g.shape != w.shape or not np.array_equal(np.isinf(g),
                                                    np.isinf(w)) \
                or not np.array_equal(np.isnan(g), np.isnan(w)):
            raise RuntimeError(f"[lc_bands] {model} {key}: {g.shape} "
                               f"against {w.shape}, or inf/NaN moved")
        sel = np.isfinite(w) & (w < faint)
        if sel.any():
            err = max(err, float(np.abs(g[sel] - w[sel]).max()))
    finite = float(np.isfinite(got["best"]).mean())
    if counted != launches or not err <= LC_BANDS_TOL[model] \
            or finite < 0.5 or got["draws"].shape[0] != LC_BANDS_DRAWS:
        raise RuntimeError(f"[lc_bands] {model}: K1-K3 {counted} (expected "
                           f"{launches}), {err} mag off the plain kernel, "
                           f"finite share {finite}, "
                           f"{got['draws'].shape[0]} draws (expected "
                           f"{LC_BANDS_DRAWS})")
    figure = "absent"
    if matplotlib_present():
        path = lightcurve_fit_plot(
            analysis, result, LC_BANDS_DRAWS,
            save_path=os.path.join(tmp, f"{model}_lightcurves.png"))
        figure = f"{os.path.basename(path)}:{os.path.getsize(path)}B"
    say("lc_bands", model=model, batch=1 + got["draws"].shape[0],
        filters=got["best"].shape[0], times=got["best"].shape[1],
        k1_k2_k3_launches=",".join(map(str, counted)),
        seconds=f"{seconds:.3f}", max_abs_dmag_vs_plain=f"{err:.3e}",
        tolerance_mag=LC_BANDS_TOL[model], best_finite_share=f"{finite:.3f}",
        matplotlib=figure)
    return max(counted)


class _WebhookSink:
    """A loopback HTTP server that keeps the JSON bodies POSTed to it."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        received = self.received = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                received.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        import threading
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/hook"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def service_phase(np, torch, tmp):
    """[service]: nmma_tpu_torch.api.AnalysisService on the card on an
    ephemeral port answers a Me2017 request (K2) with a callback to a
    loopback server, a TrPi2018 request (K3, full resolution), and a model
    off the whitelist (400): each request's wall seconds and K1-K3
    launches; the callback arrives exactly once. Returns the K2 and K3
    launches."""
    import urllib.error
    import urllib.request

    from nmma_tpu_torch.api import AnalysisService
    from nmma_tpu_torch.injections import create_light_curve_data

    def photometry(truth, model, filters, times, seed):
        data = create_light_curve_data(truth, model, filters, seed=seed,
                                       sample_times=times, device=DEVICE)
        return {f: {k: np.asarray(v).tolist() for k, v in sub.items()}
                for f, sub in data.items()}

    requests = {
        "Me2017": dict(SERVICE_SAMPLER, model="Me2017",
                       prior=SERVICE_ME_PRIOR, photometry=photometry(
                           SERVICE_ME_TRUTH, "Me2017", ["ztfg", "ztfr"],
                           np.geomspace(0.4, 8.0, 10), 2)),
        "TrPi2018": dict(SERVICE_SAMPLER, model="TrPi2018",
                         prior=SERVICE_GRB_PRIOR, photometry=photometry(
                             GRB_INJECTION, "TrPi2018", GRB_FILTERS,
                             np.geomspace(0.2, 12.0, 8), 3)),
    }
    sink = _WebhookSink()
    requests["Me2017"]["callback_url"] = sink.url
    service = AnalysisService(port=0).start()

    def post(payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{service.port}/analysis",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    counts = {}
    try:
        for name, payload in requests.items():
            payload["outdir"] = os.path.join(tmp, f"service_{name}")
            reset_launches()
            t0 = time.time()
            with LoglParts() as logl_parts:
                out = post(payload)
                torch.cuda.synchronize()
            wall = time.time() - t0
            counted = kernel_launches()
            k5, k6 = k5_launches(), k6_launches()
            want = (0, counted[1], 0) if name == "Me2017" else \
                (0, 0, counted[2])
            if out["status"] != "success" or not math.isfinite(
                    out["log_evidence"]) or counted != want \
                    or max(counted) == 0 or k5 != counted[1] \
                    or k6 != logl_parts.parts or k6 == 0:
                raise RuntimeError(f"[service] {name}: {out['status']}, "
                                   f"logZ {out.get('log_evidence')}, K1-K3 "
                                   f"{counted}, K5 {k5}, K6 {k6} "
                                   f"({logl_parts.parts} parts)")
            counts[name] = max(counted)
            say("service", request=name, wall_s=f"{wall:.3f}",
                logz=f"{out['log_evidence']:.4f}",
                likelihood_calls=out["n_likelihood_evaluations"],
                k1_k2_k3_launches=",".join(map(str, counted)),
                k5_launches=k5, k6_launches=k6,
                logl_parts=logl_parts.parts,
                quantiles=",".join(sorted(out["posterior_quantiles"])),
                webhook=out.get("webhook_status", "none"))
        reset_launches()
        t0 = time.time()
        try:
            post(dict(requests["Me2017"], model="NotAModel",
                      callback_url=None))
            code = 200
        except urllib.error.HTTPError as err:
            code = err.code
        if code != 400 or kernel_launches() != (0, 0, 0):
            raise RuntimeError(f"[service] a model off the whitelist "
                               f"answered {code}")
        say("service", request="NotAModel", status=code,
            wall_s=f"{time.time() - t0:.3f}")
    finally:
        service.stop()
        sink.close()
    if len(sink.received) != 1 or sink.received[0]["status"] != "success":
        raise RuntimeError(f"[service] the callback arrived "
                           f"{len(sink.received)} times")
    say("service", callbacks=len(sink.received), device=str(service.device))
    return counts["Me2017"], counts["TrPi2018"]


def skyportal_phase(np, torch, tmp):
    """[skyportal]: run_from_skyportal_inputs on a Me2017 SkyPortal payload
    (a photometry csv, a redshift csv, fix_z, nlive 128) through the port's
    CLI on the card, through the invoke hook, which keeps the run's
    analysis and, where matplotlib is absent, takes --plot out of the argv.
    status success, the posterior, result and best-fit files; K2 launches
    only; then [lc_bands] on the run (--plot's bands). Returns the bridge's
    K2 launches and [lc_bands]'s."""
    import csv

    from nmma_tpu_torch.cli import lightcurve_analysis
    from nmma_tpu_torch.injections import create_light_curve_data
    from nmma_tpu_torch.ops import me2017_kernel
    from nmma_tpu_torch.skyportal import run_from_skyportal_inputs

    root = os.path.join(tmp, "skyportal")
    os.makedirs(root)
    data = create_light_curve_data(
        SERVICE_ME_TRUTH, "Me2017", ["ztfg", "ztfr"], seed=5,
        sample_times=np.geomspace(0.5, 5.0, 8), device=DEVICE)
    with open(os.path.join(root, "phot.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["mjd", "filter", "mag", "magerr"])
        for f, sub in data.items():
            for t, m, e in zip(sub["time"], sub["mag"], sub["mag_error"]):
                w.writerow([repr(TRIGGER_MJD + float(t)), f, repr(float(m)),
                            repr(float(e))])
    with open(os.path.join(root, "z.csv"), "w") as fh:
        fh.write("redshift\n0.009\n")
    with open(os.path.join(root, "Me2017.prior"), "w") as fh:
        fh.write(SKYPORTAL_PRIOR)
    payload = {"photometry": os.path.join(root, "phot.csv"),
               "redshift": os.path.join(root, "z.csv"),
               "prior": os.path.join(root, "Me2017.prior"),
               "analysis_parameters": {"fix_z": True,
                                       "nlive": SKYPORTAL_NLIVE}}
    plot = "drawn" if matplotlib_present() else "removed:matplotlib_absent"
    runs = []

    def invoke(argv):
        if plot != "drawn":
            argv = [a for a in argv if a != "--plot"]
        runs.append(lightcurve_analysis.main(argv))
        return runs[-1]
    reset_launches()
    t0 = time.time()
    with LoglParts() as logl_parts:
        out = run_from_skyportal_inputs(
            payload, outdir=os.path.join(root, "run"), invoke=invoke)
        torch.cuda.synchronize()
    seconds = time.time() - t0
    counted = kernel_launches()
    k5, k6 = k5_launches(), k6_launches()
    label = os.path.join(root, "run", "Me2017_obj")
    missing = [s for s in ("_result.npz", "_posterior_samples.csv",
                           "_bestfit.json", "_result_meta.json")
               if not os.path.exists(label + s)]
    if out["status"] != "success" or missing or counted[1] == 0 \
            or counted[0] or counted[2] or k5 != counted[1] or not \
            -1e29 < out["log_bayes_factor"] < 0.0 or \
            (plot == "drawn") != bool(out["plot_file"]) or \
            k6 != logl_parts.parts or k6 == 0:
        raise RuntimeError(f"[skyportal] {out}, missing {missing}, K1-K3 "
                           f"{counted}, K5 {k5}, K6 {k6} "
                           f"({logl_parts.parts} parts)")
    with open(os.path.join(root, "run", "Me2017.prior")) as fh:
        pinned = [ln for ln in fh if ln.startswith("luminosity_distance")]
    say("skyportal", status=out["status"],
        logz=f"{out['log_bayes_factor']:.4f}", seconds=f"{seconds:.2f}",
        k2_launches=counted[1], k5_launches=k5, k6_launches=k6,
        logl_parts=logl_parts.parts, plot=plot,
        distance=pinned[0].split("=")[1].strip(),
        posterior_samples=len(runs[0].result.posterior_indices()))
    bands_launches = lc_bands(
        np, torch, "Me2017", runs[0], runs[0].result, me2017_kernel,
        "me2017_dynamics_from_operands", me2017_kernel.me2017_dynamics_plain,
        (0, 1, 0), root)
    return counted[1], bands_launches


def mesh_run(torch, analysis, cfg, mesh, device=None):
    """(result, K1 launches, likelihood collectives, wall s, the sorted
    distinct row counts of K1's launches) of the capped sampler on
    ``analysis``, split over ``mesh`` when it is given."""
    from nmma_tpu_torch.inference import NestedSampler
    from nmma_tpu_torch.ops import svd_kernel

    rows, kernel = set(), svd_kernel.svd_surrogate_mags

    def counted(x, *weights):
        rows.add(x.shape[0])
        return kernel(x, *weights)

    reset_counts("k1", "mesh")
    svd_kernel.svd_surrogate_mags = counted
    t0 = time.time()
    try:
        result = NestedSampler(analysis.batched_logl, analysis.priors.ndim,
                               cfg.sampler, device=device, mesh=mesh).run(
            verbose=False)
        torch.cuda.synchronize()
    finally:
        svd_kernel.svd_surrogate_mags = kernel
    return (result, k1_launches(), collectives(), time.time() - t0,
            sorted(rows))


def mesh_collective_us(torch, mesh, rows, calls=200, warmup=10):
    """Mean us of one all_reduce of a [rows] f32 buffer on the card over
    the mesh's group: ``calls`` back to back, then one synchronize."""
    import torch.distributed as dist

    buf = torch.zeros(rows, device=mesh.device)
    for _ in range(warmup):
        dist.all_reduce(buf, group=mesh.group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        dist.all_reduce(buf, group=mesh.group)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def mesh_walk(torch, fn, u, profile=True, calls=50, warmup=3):
    """(wall ms, device-busy ms, idle share) of one sharded walk step
    ``fn(u)``: wall over ``calls`` back-to-back calls, busy from one
    profiled call (only where ``profile``; the call is made either way, so
    every rank makes the same collectives)."""
    for _ in range(warmup):
        fn(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(u)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    if not profile:
        fn(u)
        torch.cuda.synchronize()
        return wall_ms, float("nan"), float("nan")
    busy_ms = device_profile(torch, lambda: fn(u))[0]
    return wall_ms, busy_ms, 1.0 - busy_ms / wall_ms


def mesh_analysis(torch, root, device):
    """[mesh]'s analysis from ``root/config.json`` (phase 4's, with the
    capped sampler) on ``device``, and the 8192 unit-cube rows drawn from a
    generator seeded with 0 there."""
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig

    with open(os.path.join(root, "config.json")) as f:
        fields = json.load(f)
    cfg = EMAnalysisConfig(**{**fields, "sampler": NestedSamplerConfig(
        **fields["sampler"])})
    analysis = EMAnalysis(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return cfg, analysis, analysis.priors.sample_units(gen, BATCH)


def mesh_worker(rank, root):
    """One rank of phase 51(b): the capped sampler split over two gloo
    ranks sharing card 0, shard_logl on the seeded rows, the collective's
    time and a walk step's idle share; writes ``root/rank{rank}.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.parallel import mesh as M

    M.initialize_distributed(init_method=f"file://{root}/gloo_store",
                             world_size=2, rank=rank, backend="gloo")
    mesh = M.make_mesh(device="cuda:0")
    make_svd_source_model(MODEL, SVDModelData.load(ARTIFACT,
                                                   device=mesh.device))
    cfg, analysis, u = mesh_analysis(torch, root, mesh.device)
    result, launches, collectives, seconds, rows = mesh_run(
        torch, analysis, cfg, mesh)
    sharded = M.shard_logl(analysis.batched_logl, mesh)
    logl = sharded(u).cpu().numpy()
    collective_us = mesh_collective_us(torch, mesh, SAMPLER_BATCH)
    walk = mesh_walk(torch, sharded, u[:SAMPLER_BATCH], profile=rank == 0)
    dist.barrier()
    np.savez(os.path.join(root, f"rank{rank}.npz"),
             samples_u=result.samples_u, logl=result.logl, logz=result.logz,
             logz_err=result.logz_err, niter=result.niter,
             ncall=result.ncall, launches=launches, collectives=collectives,
             seconds=seconds, rows=rows, logl_rows=logl,
             collective_us=collective_us, walk=walk)
    dist.destroy_process_group()
    return 0


def mesh_phase(np, torch, cfg, tmp):
    """Phase 51 on phase 4's analysis ``cfg``: (a) one NCCL rank in this
    process, (b) two gloo ranks sharing the card. Returns K1's launches in
    (a)'s sharded run and on each rank of (b)."""
    import dataclasses

    import torch.distributed as dist
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.parallel import mesh as M

    t_phase = time.time()
    root = os.path.join(tmp, "mesh")
    os.makedirs(root)
    cfg = dataclasses.replace(cfg, sampler=NestedSamplerConfig(
        nlive=1024, n_delete=128, max_iter=MESH_ITERATIONS))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    cfg, analysis, u = mesh_analysis(torch, root, DEVICE)

    # (a) one rank on NCCL: the mesh run against the plain run
    M.initialize_distributed(init_method=f"file://{root}/nccl_store",
                             world_size=1, rank=0, backend="nccl")
    try:
        mesh = M.make_mesh()
        dist.barrier()      # the communicator forms here, not in a run
        plain, plain_k1, _, plain_s, plain_rows = mesh_run(
            torch, analysis, cfg, None, device=DEVICE)
        sharded, mesh_k1, collectives, mesh_s, mesh_rows = mesh_run(
            torch, analysis, cfg, mesh)
        nccl_us = mesh_collective_us(torch, mesh, SAMPLER_BATCH)
        walk = mesh_walk(torch, M.shard_logl(analysis.batched_logl, mesh),
                         u[:SAMPLER_BATCH])
    finally:
        dist.destroy_process_group()
    expected = 1 + plain.niter * cfg.sampler.walks
    for field in ("samples_u", "logl", "logz"):
        if not np.array_equal(getattr(sharded, field), getattr(plain, field)):
            raise RuntimeError(f"[mesh] one NCCL rank: {field} differs from "
                               "the plain run")
    whole = [cfg.sampler.n_delete, cfg.sampler.nlive]
    if (plain_k1, mesh_k1, collectives) != (expected,) * 3 \
            or plain_rows != whole or mesh_rows != whole:
        raise RuntimeError(
            f"[mesh] K1 launches {plain_k1} (plain), {mesh_k1} (mesh) and "
            f"{collectives} collectives at rows {plain_rows}, {mesh_rows}, "
            f"expected {expected} each at rows {whole}")
    say("mesh", part="a", backend="nccl", ranks=1, iterations=plain.niter,
        logz=f"{plain.logz:.4f}", bitwise_vs_plain=True,
        seconds_plain=f"{plain_s:.3f}", seconds_mesh=f"{mesh_s:.3f}",
        k1_launches=mesh_k1, collectives=collectives,
        collective_us_b128=f"{nccl_us:.2f}", walk_wall_ms=f"{walk[0]:.4f}",
        walk_busy_ms=f"{walk[1]:.4f}", walk_idle_share=f"{walk[2]:.4f}")

    # (b) two gloo ranks sharing the card, this script with --mesh-rank
    logl_one = analysis.batched_logl(u).cpu().numpy()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(rank),
         root], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=max(1.0, MESH_TIMEOUT_S - (time.time() - t0))))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    world_s = time.time() - t0
    for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise RuntimeError(f"[mesh] rank {rank} exited {proc.returncode}"
                               f":\n{out}\n{err[-4000:]}")
    ranks = []
    for rank in (0, 1):
        with np.load(os.path.join(root, f"rank{rank}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    first, second = ranks
    for field in ("samples_u", "logl", "logz", "niter", "ncall"):
        if not np.array_equal(first[field], second[field]):
            raise RuntimeError(f"[mesh] the two ranks' {field} differ")
    niter = int(first["niter"])
    expected = 1 + niter * cfg.sampler.walks
    half = [cfg.sampler.n_delete // 2, cfg.sampler.nlive // 2]
    for rank, r in enumerate(ranks):
        if int(r["launches"]) != expected or int(r["collectives"]) \
                != expected or list(r["rows"]) != half:
            raise RuntimeError(
                f"[mesh] rank {rank}: K1 launches {int(r['launches'])} at "
                f"rows {list(r['rows'])} and {int(r['collectives'])} "
                f"collectives, expected {expected} at rows {half}")
    got = first["logl_rows"]
    usable = logl_one > -1e29
    if not np.array_equal(usable, got > -1e29):
        raise RuntimeError("[mesh] shard_logl's sentinels differ from the "
                           "one-process batched_logl's")
    dlogl = np.abs(got - logl_one)[usable]
    if np.any(dlogl > LOGL_ATOL + LOGL_RTOL * np.abs(logl_one[usable])):
        raise RuntimeError(f"[mesh] shard_logl off the one-process "
                           f"batched_logl by {float(dlogl.max())}")
    dz = abs(float(first["logz"]) - plain.logz)
    dz_gate = 3.0 * max(math.hypot(float(first["logz_err"]),
                                   plain.logz_err), 0.1)
    if not dz < dz_gate:
        raise RuntimeError(f"[mesh] two ranks' logZ {float(first['logz'])} "
                           f"against one process's {plain.logz}: |dlogZ| "
                           f"{dz} >= {dz_gate}")
    bitwise = all(np.array_equal(first[f], np.asarray(getattr(plain, f)))
                  for f in ("samples_u", "logl", "logz"))
    walk = first["walk"]
    say("mesh", part="b", backend="gloo", ranks=2, device="cuda:0",
        iterations=niter, logz=f"{float(first['logz']):.4f}",
        logz_one_process=f"{plain.logz:.4f}", dlogz=f"{dz:.4f}",
        dlogz_gate=f"{dz_gate:.4f}", bitwise_ranks=True,
        bitwise_vs_one_process=bitwise,
        logl_rows=BATCH, logl_bitwise=bool(np.array_equal(got, logl_one)),
        max_abs_dlogl=f"{float(dlogl.max()) if dlogl.size else 0.0:.3e}",
        seconds_world=f"{world_s:.3f}",
        seconds_run=",".join(f"{float(r['seconds']):.3f}" for r in ranks),
        k1_launches_per_rank=expected,
        k1_rows=",".join(str(int(n)) for n in first["rows"]),
        collective_us_b64_a_rank=",".join(
            f"{float(r['collective_us']):.2f}" for r in ranks),
        walk_wall_ms=f"{walk[0]:.4f}", walk_busy_ms=f"{walk[1]:.4f}",
        walk_idle_share=f"{walk[2]:.4f}")
    say("mesh", seconds=f"{time.time() - t_phase:.2f}")
    return mesh_k1, expected


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, HERE)
    import nmma_tpu_torch
    if not os.path.abspath(nmma_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError("nmma_tpu_torch must come from this checkout, not "
                           f"{nmma_tpu_torch.__file__}")
    from nmma_tpu_torch import _kernels
    from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
    from nmma_tpu_torch.inference import NestedSamplerConfig
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model
    from nmma_tpu_torch.ops import svd_kernel

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build
    t0 = time.time()
    libs = _kernels.build()
    say("build", seconds=f"{time.time() - t0:.3f}",
        libraries=",".join(os.path.basename(p) for p in libs.values()))
    for lib in libs:
        say("ptxas", library=lib, **(ptxas_summary(_kernels.REPORTS[lib])
                                     if lib in _kernels.REPORTS
                                     else {"report": "not built in this run"}))

    # 3. K1 against its plain version at the main path's shapes
    svd = SVDModelData.load(ARTIFACT, device=DEVICE)
    sample_times = torch.tensor(np.geomspace(0.01, 14.0, 150),
                                dtype=torch.float32, device=DEVICE)
    va_q, off_q, _ = svd.operator_rankc(sample_times)
    weights = (svd.w1, svd.b1, svd.w2, svd.b2, va_q, off_q)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    max_err = 0.0
    for b in (1, 128, BATCH + 7):
        x = torch.rand((b, svd.w1.shape[1]), generator=gen, device=DEVICE)
        got = svd_kernel.svd_surrogate_mags(x, *weights)
        want = svd_kernel.svd_surrogate_mags_plain(x, *weights)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != want.shape or not math.isfinite(err) \
                or err > K1_TOL:
            raise RuntimeError(f"K1 disagrees at B={b}: max abs err {err} "
                               f"(tolerance {K1_TOL} mag)")
        max_err = max(max_err, err)
        say("k1", batch=b, max_abs_err=f"{err:.3e}")
    n_f, p, h = svd.w1.shape
    c, q = svd.w2.shape[2], va_q.shape[2]
    dims = (n_f, p, h, c, q)

    x = torch.rand((SAMPLER_BATCH, p), generator=gen, device=DEVICE)
    k1_ms_small, windows = kernel_device_windows(
        torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights),
        "svd_mlp_mags_kernel")
    say("k1", batch=SAMPLER_BATCH, kernel_ms=f"{k1_ms_small:.4f}",
        timed_by="profiler", profiled_windows=windows,
        bound_ms=f"{k1_bound(SAMPLER_BATCH, *dims)[2]:.4f}")
    x = torch.rand((BATCH, p), generator=gen, device=DEVICE)
    k1_ms = time_ms(torch, lambda: svd_kernel.svd_surrogate_mags(x, *weights))
    plain_ms = time_ms(
        torch, lambda: svd_kernel.svd_surrogate_mags_plain(x, *weights))
    flops, n_bytes, bound_ms, bound_by = k1_bound(BATCH, *dims)
    say("k1", batch=BATCH, kernel_ms=f"{k1_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, bound_share=f"{bound_ms / k1_ms:.4f}",
        gflop=f"{flops / 1e9:.3f}", mbytes=f"{n_bytes / 1e6:.3f}")

    # 4. main path: photometry file -> EMAnalysis.batched_logl at B=8192
    make_svd_source_model(MODEL, svd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_path = os.path.join(tmp, "injection.dat")
        prior_path = os.path.join(tmp, "bu2019lm.prior")
        with open(prior_path, "w") as f:
            f.write(PRIOR_TEXT)
        synthetic_photometry(np, torch, MODEL, list(svd.filters), data_path,
                             INJECTION, sample_times=(0.01, 14.0, 150),
                             epochs=(0.5, 12.0))

        cfg = EMAnalysisConfig(
            model=MODEL, prior_file=prior_path, light_curve_data=data_path,
            trigger_time=TRIGGER_MJD, data_tmax=12.5, error_budget=1.0,
            filters=list(svd.filters), outdir=os.path.join(tmp, "outdir"),
            label="chip_smoke",
            sampler=NestedSamplerConfig(nlive=1024, n_delete=128,
                                        max_iter=40, max_seconds=90.0))
        analysis = EMAnalysis(cfg, device=DEVICE)
        u = analysis.priors.sample_units(gen, BATCH)
        reset_counts("k1", "k2")
        logl = analysis.batched_logl(u)
        torch.cuda.synchronize()
        logl_launches = k1_launches()
        if logl_launches != 1 or k2_launches() != 0:
            raise RuntimeError(f"batched_logl launched K1 {logl_launches} "
                               f"times and K2 {k2_launches()} times, "
                               "not once and never")
        if logl.shape != (BATCH,) or torch.isnan(logl).any():
            raise RuntimeError(f"bad batched_logl output {logl.shape}")
        usable = logl > -1e29
        finite_share = float(usable.float().mean())
        if finite_share < 0.5:
            raise RuntimeError(f"only {finite_share:.3f} of logL finite")
        logl_ms, logl_calls, round_ms = throughput(
            torch, lambda: analysis.batched_logl(u))
        evals_per_s = BATCH / (logl_ms / 1e3)
        # where the time goes: device-busy share of the unprofiled wall
        # time, at this batch and at the sampler's walk batch
        for b, ms in ((BATCH, logl_ms), (128, throughput(
                torch, lambda: analysis.batched_logl(u[:128]))[0])):
            busy, n_launch, top, _, _ = device_profile(
                torch, lambda: analysis.batched_logl(u[:b]))
            say("profile", batch=b, wall_ms=f"{ms:.4f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1.0 - busy / ms:.4f}",
                kernel_launches=n_launch, top=top)

        # the same batch with the plain K1 on the card
        kernel_fn = svd_kernel.svd_surrogate_mags
        svd_kernel.svd_surrogate_mags = svd_kernel.svd_surrogate_mags_plain
        try:
            logl_plain = analysis.batched_logl(u)
        finally:
            svd_kernel.svd_surrogate_mags = kernel_fn
        if not torch.equal(usable, logl_plain > -1e29):
            raise RuntimeError("sentinel positions differ from the plain K1")
        dlogl = (logl - logl_plain)[usable].abs()
        allowed = LOGL_ATOL + LOGL_RTOL * logl_plain[usable].abs()
        if bool((dlogl > allowed).any()):
            raise RuntimeError(f"logL off the plain K1 by {float(dlogl.max())}")
        # the injection must fit better than a typical prior draw
        logl_inj = float(analysis.batched_logl(
            injection_units(analysis.priors, INJECTION))[0])
        if not logl_inj > float(logl[usable].median()):
            raise RuntimeError(f"injection logL {logl_inj} below the median")
        say("logl", batch=BATCH, finite_share=f"{finite_share:.4f}",
            k1_launches=logl_launches, calls=logl_calls,
            wall_ms=f"{logl_ms:.4f}", evals_per_s=f"{evals_per_s:.1f}",
            evals_per_s_rounds=",".join(
                f"{BATCH / (ms / 1e3):.1f}" for ms in round_ms),
            max_abs_dlogl_vs_plain=f"{float(dlogl.max()):.3e}",
            logl_injection=f"{logl_inj:.3f}",
            logl_median=f"{float(logl[usable].median()):.3f}")

        # 5. nested sampler through EMAnalysis.run
        t0 = time.time()
        reset_counts("k1", "k2")
        result = analysis.run(verbose=False)
        torch.cuda.synchronize()
        launches = k1_launches()
        seconds = time.time() - t0
        if not math.isfinite(result.logz):
            raise RuntimeError(f"logZ not finite: {result.logz}")
        # one batch for the initial live set, one per walk step
        expected = 1 + result.niter * cfg.sampler.walks
        if launches != expected or launches <= 0:
            raise RuntimeError(f"the sampler launched K1 {launches} times, "
                               f"expected {expected}")
        if k2_launches() != 0:
            raise RuntimeError(f"the Bu2019lm sampler launched K2 "
                               f"{k2_launches()} times")
        for suffix in ("_result.npz", "_result_meta.json",
                       "_posterior_samples.csv", "_bestfit_params.json"):
            if not os.path.exists(os.path.join(cfg.outdir,
                                               cfg.label + suffix)):
                raise RuntimeError(f"missing result file {suffix}")
        say("sampler", logz=f"{result.logz:.4f}",
            logz_err=f"{result.logz_err:.4f}", iterations=result.niter,
            likelihood_calls=result.ncall, seconds=f"{seconds:.2f}",
            k1_launches=launches)

        # 51. the sampler split over a torch.distributed group
        k1_mesh, k1_mesh_rank = mesh_phase(np, torch, cfg, tmp)

    k2_entry = me2017_path(np, torch, gen, sample_times)
    k5_entry = k5_path(np, torch)
    k6_entry = k6_path(np, torch)
    k3_entry, k4_entry = grb_path(np, torch, gen)
    combined_logl(np, torch, gen)
    cli_launches, cli_posterior, k1_bands, k1_bestfit = cli_path(np, torch)
    kn_models(np, torch, gen)
    k3_entry.update(grb_ramp_path(np, torch, gen))
    k3_entry["launches_lc_bands"] = posterior_config3(np, torch)
    mcmc_path(np, torch, cli_posterior)
    em_models(np, torch, gen)
    lbol_path(np, torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_joint_") as tmp:
        k1_joint = joint_path(np, torch, tmp)
        gw_path(np, torch)
        post_path(np, torch, tmp)
        t0 = time.time()
        generation_launches = tools_phase(np, torch, tmp)
        item19_s = time.time() - t0
    k1_training = training_path(np, torch)
    t0 = time.time()
    cadence_launches = cadences_phase(np, torch)
    registry_launches = registry_phase(np, torch)
    item19_s += time.time() - t0 + k1_training.pop("native_s")
    say("item19_phases", seconds=f"{item19_s:.2f}")
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        service_k2, service_k3 = service_phase(np, torch, tmp)
        skyportal_k2, k2_bands = skyportal_phase(np, torch, tmp)
    say("item19b_phases", seconds=f"{time.time() - t0:.2f}")
    k2_entry.update(launches_service=service_k2,
                    launches_skyportal=skyportal_k2,
                    launches_lc_bands=k2_bands)
    k3_entry.update(launches_service=service_k3)
    kernels = [{
        "name": "svd_mlp_mags", "route": "cuda",
        "source": "nmma_tpu_torch/csrc/svd_mlp.cu",
        "replaces": "nmma_tpu/ops/pallas_svd.py:37",
        "launches": launches, "launches_batched_logl": logl_launches,
        "launches_cli": cli_launches, "max_abs_err": max_err,
        "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": plain_ms,
        "ms_sampler_batch": k1_ms_small, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        **k1_joint, **k1_training,
        "launches_cadences_cli": cadence_launches,
        "launches_lightcurve_generation": generation_launches,
        "launches_registry": registry_launches,
        "launches_lc_bands": k1_bands,
        "launches_bestfit_cli": k1_bestfit,
        "launches_mesh": k1_mesh, "launches_mesh_rank": k1_mesh_rank,
    }, k2_entry, k3_entry, k4_entry, k5_entry, k6_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
