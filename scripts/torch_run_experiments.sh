#!/usr/bin/env bash
# Run every module of alan_tpu_torch/experiments at its JAX script's defaults
# on the card, one process each, the K sweep's K = 300 arm last (about 25
# minutes of it).  Records and logs go to OUT_DIR (default results_torch/);
# each run's exit code and seconds follow its log.
#
#     bash scripts/torch_run_experiments.sh [OUT_DIR]
set -u
O=${1:-results_torch}
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() {
    local log=$1 s=$SECONDS rc
    shift
    python -m "alan_tpu_torch.experiments.$@" --out-dir "$O" > "$O/$log.log" 2>&1
    rc=$?
    echo "RC $rc SECONDS $((SECONDS - s)) :: $*" | tee -a "$O/$log.log"
}
run moments moments_vs_hmc_covid
run sweep covid_k_sweep --Ks 10 30 100
run trend covid_smc_particle_trend
run corrq covid_corrq_probe
run ffbs ffbs_coupling_sweep
run latent latent_recovery
run occupancy occupancy_collapse_probe
run full covid_full_qem_quality
run k300 covid_k_sweep --Ks 300 --skip-smc
