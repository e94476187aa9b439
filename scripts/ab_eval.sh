#!/usr/bin/env bash
# Interleaved A/B of the analog LSTM's infer step on one GPU.
#
#   scripts/ab_eval.sh OTHER_CHECKOUT [ROUNDS] [-- lstm_eval arguments]
#
# For each setting (PTB flat, PTB with 512-column threshold banks, KWS) it
# runs `python -m repro_torch.launch.lstm_eval` from OTHER_CHECKOUT (side A)
# and from the checkout holding this script (side B) in the order A B B A,
# ROUNDS times (default 2), each run its own process building its kernels
# in its own checkout.  Each run prints one line: its side, its setting and
# lstm_eval's JSON result (step_ms, launches, BPC).  Host-clock steps vary
# between processes, so only the interleaved pairs are compared.
set -euo pipefail
other=$(cd "$1" && pwd)
shift
rounds=2
if [ $# -gt 0 ] && [ "$1" != "--" ]; then rounds=$1; shift; fi
[ "${1:-}" = "--" ] && shift
here=$(cd "$(dirname "$0")/.." && pwd)
settings=("--config ptb_lstm" "--config ptb_lstm --bank-cols 512"
          "--config kws_lstm")
for setting in "${settings[@]}"; do
  for _ in $(seq "$rounds"); do
    for side in A B B A; do
      if [ "$side" = A ]; then root=$other; else root=$here; fi
      # shellcheck disable=SC2086  # the setting is a list of arguments
      line=$(cd "$root" && PYTHONPATH=src python3 -m \
             repro_torch.launch.lstm_eval $setting "$@" | tail -n 1)
      echo "$side | $setting | $line"
    done
  done
done
