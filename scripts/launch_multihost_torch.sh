#!/usr/bin/env bash
# Spawn an N-process torch.distributed job of the PyTorch port on THIS
# machine (the supported no-cluster topology of
# repro_torch.runtime.distributed):
#
#   scripts/launch_multihost_torch.sh [-n N] [-t SECONDS] [-- CMD...]
#
#   -n N        processes (default 2); one process is one rank on one
#               device, so there is no devices-per-process flag
#   -t SECONDS  hard per-process timeout (default 900)
#   CMD...      the per-process command (default:
#               python -m repro_torch.launch.multihost)
#
# Every child is launched with the runtime.distributed env contract —
# the SAME variables a cluster scheduler exports on every host, where CMD
# runs once per GPU:
#
#   COORDINATOR_ADDRESS=<host:port>   here: 127.0.0.1:<fresh free port>
#   NUM_PROCESSES=<N>                 identical on every process
#   PROCESS_ID=<i>                    distinct, 0..N-1 (0 = coordinator)
#   DIST_INIT_TIMEOUT=<seconds>       optional connect timeout
#
# Process 0's output streams to stdout; the others log to a temp dir and
# are dumped only on failure.  The first failing process kills the
# stragglers (a dead peer leaves the rest blocked in a collective), and
# the per-process `timeout` is a hard cap — a hung barrier cannot
# outlive it.
#
# Examples:
#   scripts/launch_multihost_torch.sh -n 2 -- \
#       python -m repro_torch.launch.multihost --device cpu   # gloo, CPU
#   scripts/launch_multihost_torch.sh -n 4 -- \
#       python -m repro_torch.launch.multihost --data 2       # NCCL, 4 GPUs
set -euo pipefail
cd "$(dirname "$0")/.."

N=2
TIMEOUT=900
while getopts "n:t:" opt; do
    case "$opt" in
        n) N="$OPTARG" ;;
        t) TIMEOUT="$OPTARG" ;;
        *) echo "usage: $0 [-n N] [-t SECONDS] [-- CMD...]" >&2
           exit 2 ;;
    esac
done
shift $((OPTIND - 1))
[[ "${1:-}" == "--" ]] && shift
if [[ $# -eq 0 ]]; then
    set -- python -m repro_torch.launch.multihost
fi

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
PORT=$(python - <<'PYEOF'
import socket
s = socket.socket()
s.bind(("127.0.0.1", 0))
print(s.getsockname()[1])
s.close()
PYEOF
)

LOGDIR=$(mktemp -d)
trap 'rm -rf "$LOGDIR"' EXIT

pids=()
for ((i = 0; i < N; i++)); do
    if [[ $i -eq 0 ]]; then
        out=/dev/stdout
    else
        out="$LOGDIR/proc$i.log"
    fi
    COORDINATOR_ADDRESS="127.0.0.1:$PORT" NUM_PROCESSES="$N" \
        PROCESS_ID="$i" \
        timeout --signal=TERM --kill-after=10 "$TIMEOUT" \
        "$@" > "$out" 2>&1 &
    pids+=($!)
done

fail=0
for ((i = 0; i < N; i++)); do
    # first failure kills the stragglers; remaining waits then return fast
    if ! wait -n; then
        fail=1
        kill "${pids[@]}" 2>/dev/null || true
    fi
done

if [[ $fail -ne 0 ]]; then
    echo "launch_multihost_torch: FAILED (N=$N)" >&2
    for ((i = 1; i < N; i++)); do
        echo "--- process $i log ---" >&2
        cat "$LOGDIR/proc$i.log" >&2 || true
    done
    exit 1
fi
