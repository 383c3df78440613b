#!/bin/sh
# Adjoint (gridding) reconstructions, timed 3x each — rebuild of reference
# src/RUNME3_tron_grid_all.sh.  The reference's git-lfs datasets are not
# shipped; synthetic stand-ins with the same geometry are generated first.
set -e
cd "$(dirname "$0")/.."
mkdir -p output

timed() {
  t0=$(date +%s.%N)
  "$@"
  t1=$(date +%s.%N)
  echo "elapsed: $(echo "$t1 $t0" | awk '{printf "%.2f s", $1-$2}')  [$*]"
}

# phantom data from RUNME1
[ -f output/sl_data_tron.ra ] || sh scripts/RUNME1_tron_degrid_phantom.sh

# 1) linear-angle phantom gridding (reference: tron -a -d 512).
#    --scheme linear_half matches the convention RUNME1's degrid used
#    (the reference's grid/degrid linear conventions differ; SURVEY.md §7)
for i in 1 2 3; do
  timed python -m tron_jax.cli -a -d 512 --scheme linear_half \
    output/sl_data_tron.ra output/sl_img_tron.ra
done

# 2) golden-angle multicoil dynamic series (whole-body analog, reduced):
#    reference: tron -a -G -u 0.4 -d 21 ex_whole_body.ra
[ -f output/ga_multicoil.ra ] || \
  python -m tron_jax.tools.make_goldenangle output/ga_multicoil.ra --nc 6 --nro 512 --npe 1479
for i in 1 2 3; do
  timed python -m tron_jax.cli -a -G -u 0.4 -d 21 output/ga_multicoil.ra output/ga_img_tron.ra
done

# 3) FULL reference-scale whole-body (6 x 512 x 20,271 = 498 MB, 956 frames
#    of 256^2 — the 3.28 s CUDA headline, src/RUNME3:10) streamed from disk
#    through the native windowed reader.  TRON_FULLSCALE=0 skips (synthesis
#    of the fixture alone takes a few minutes).
if [ "${TRON_FULLSCALE:-1}" != "0" ]; then
  [ -f output/ex_whole_body.ra ] || \
    python -m tron_jax.tools.make_goldenangle output/ex_whole_body.ra \
      --nc 6 --nro 512 --npe 20271
  for i in 1 2 3; do
    timed python -m tron_jax.cli -a -G -u 0.4 -d 21 -v --stream \
      output/ex_whole_body.ra output/img_cmt_tron.ra
  done
  python scripts/dataset_metrics.py output/img_cmt_tron.ra --data output/ex_whole_body.ra \
    --nc 6 -G -u 0.4 -d 21 --frames 0,400,-1 --label whole_body --oracle

  # fp16-pair input variant: halves the acquisition bytes (and the H2D
  # upload leg); input quantization costs about 2e-4 NRMSE
  [ -f output/ex_whole_body_f16.ra ] || \
    python -m tron_jax.tools.ra_tool half \
      output/ex_whole_body.ra output/ex_whole_body_f16.ra
  for i in 1 2 3; do
    timed python -m tron_jax.cli -a -G -u 0.4 -d 21 -v --stream --half \
      output/ex_whole_body_f16.ra output/img_cmt_tron_f16.ra
  done
fi

# 4) optic-nerve-class series (reference: tron -u 0.5 -a -G, RUNME3:16-18;
#    non-overlapping 128-profile frames)
[ -f output/optic_nerve.ra ] || \
  python -m tron_jax.tools.make_goldenangle output/optic_nerve.ra \
    --nc 4 --nro 256 --npe 2176
for i in 1 2 3; do
  timed python -m tron_jax.cli -a -G -u 0.5 output/optic_nerve.ra output/img_on_tron.ra
done
python scripts/dataset_metrics.py output/img_on_tron.ra --data output/optic_nerve.ra \
  --nc 4 -G -u 0.5 --frames 0,-1 --label optic_nerve

# 5) swallowing-class series (reference: tron -u 0.5 -d 21 -a -G,
#    RUNME3:20-22; 21-profile sliding window)
[ -f output/swallowing.ra ] || \
  python -m tron_jax.tools.make_goldenangle output/swallowing.ra \
    --nc 4 --nro 256 --npe 3000
for i in 1 2 3; do
  timed python -m tron_jax.cli -a -G -u 0.5 -d 21 output/swallowing.ra output/img_sw_tron.ra
done
python scripts/dataset_metrics.py output/img_sw_tron.ra --data output/swallowing.ra \
  --nc 4 -G -u 0.5 -d 21 --frames 0,60,-1 --label swallowing
echo done
