#!/usr/bin/env bash
# Smoke-run EVERY example CLI of the port (counterpart of examples/run_all.sh
# and of the reference run*.sh orchestration scripts). Small configs; pass
# OUT=dir to redirect outputs and DEVICE=cpu to run without a card (the
# default, cuda, raises without one). The CLIs whose modules have a fused
# path run it (--fused-kernels): K1, K3, K5, K6.
#
# QUICK=1 runs a representative subset (one CLI per family).
set -e
cd "$(dirname "$0")/../.."
OUT="${OUT:-runs}"
DEVICE="${DEVICE:-cuda}"
ex() { time python -m "diffnet_tpu_torch.examples.$1" "${@:2}" --device "$DEVICE"; }

ex poisson_mms_2d    --domain-size 32 --max-epochs 40 --fused-kernels --out-dir "$OUT"
ex ns_ldc            --domain-size 33 --solver newton --fused-kernels --out-dir "$OUT"
ex eikonal_reconstruction --domain-size 32 --max-epochs 150 --out-dir "$OUT"
ex poisson_ibn_parametric -b 16 --n-samples 32 --max-epochs 2 --out-dir "$OUT"
ex more_physics helmholtz --domain-size 32 --max-epochs 60 --out-dir "$OUT"
# examples/multichip_scaling.py's counterpart: 4 ranks
time torchrun --nproc-per-node 4 -m diffnet_tpu_torch.parallel.scaling \
  --data 2 --space 2 --domain-size 32 --batch-size 8 --steps 5 --device "$DEVICE"

if [ -n "${QUICK:-}" ]; then
  echo "QUICK EXAMPLES OK (subset; unset QUICK for the full sweep)"
  exit 0
fi

ex poisson_mms_2d    --domain-size 129 --optimizer mg-cg --fused-kernels --out-dir "$OUT"
ex poisson_3d        --domain-size 9  --max-epochs 30 --fused-kernels --out-dir "$OUT"
ex stokes_mms        --domain-size 32 --max-epochs 150 --out-dir "$OUT"
ex stokes_mms        --domain-size 33 --solver gmres --out-dir "$OUT"
ex ns_ldc            --domain-size 32 --max-epochs 100 --fused-kernels --out-dir "$OUT"
ex ldc_validation    --re 1000 --solver newton --domain-size 33 --fused-kernels --out "$OUT/ldc_validation.png"
ex eikonal_reconstruction --nsd 3 --domain-size 17 --max-epochs 60 --out-dir "$OUT"
ex ibn_3d            --domain-size 16 --batch-size 4 --n-samples 8 --max-epochs 2 --out-dir "$OUT"
ex ibn_3d            --domain-size 16 --batch-size 4 --n-samples 8 --max-epochs 2 --data-devices 2 --out-dir "$OUT"
ex klsum_uq          --n-train 32 --n-query 64 --max-epochs 3 --fused-kernels --out-dir "$OUT"
QDIR=$(ls -d "$OUT"/klsum/version_* | sort -V | tail -1)  # latest run
ex query_run         "$QDIR" --n-query 64 --fused-kernels

for PHYS in advdiff allen-cahn burgers fsdt topopt; do
  ex more_physics "$PHYS" --domain-size 32 --max-epochs 60 --out-dir "$OUT"
done

ex ns_fpc_parametric --max-epochs 2 --n-samples 4 --batch-size 2 --width 64 --height 32 --out-dir "$OUT"
ex eikonal_airfoil   --domain-size 32 --max-epochs 60 --out-dir "$OUT"
ex ns_fps            --eq stokes --re 1 --h 0.5 --out-dir "$OUT"
ex eikonal_parametric --net immdiff --n-train 3 --n-test 1 --domain-size 32 --n-points 48 --max-epochs 20 --out-dir "$OUT"
ex sweep --physics klsum --param n_train --values 8,16 --domain-size 16 --max-epochs 2 --fused-kernels --out-dir "$OUT"
echo "ALL EXAMPLES OK"
