#!/bin/sh
# Synthesize radial data from the Shepp-Logan phantom with the forward
# (degrid) op — the rebuild of reference src/RUNME1_tron_degrid_phantom.sh,
# which did: make && ./tron ../data/shepplogan.ra output/sl_data_tron.ra
set -e
cd "$(dirname "$0")/.."
mkdir -p output
# generate the phantom fixture (the reference ships it via git-lfs)
python -m tron_jax.tools.make_phantom output/shepplogan.ra --n 256
python -m tron_jax.cli output/shepplogan.ra output/sl_data_tron.ra
echo "wrote output/sl_data_tron.ra"
