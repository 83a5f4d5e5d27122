#!/usr/bin/env bash
# Process supervision for the PyTorch port's monitor loop — equivalent of
# meteor_detect_class/prime_watchdog.sh: restart on crash with 3 s backoff,
# append output to a log file.  --docker switches the log path (the
# reference's Docker convention) and records the environment.
#
# Usage: watchdog.sh [--docker] [monitor args...]

set -u

LOG_FILE_PATH="log.txt"
if [[ "${1:-}" == "--docker" ]]; then
    shift
    LOG_FILE_PATH="/data/log.txt"
    pip freeze >> "$LOG_FILE_PATH" 2>&1 || true
fi

echo "[watchdog] starting monitor supervision, log: $LOG_FILE_PATH"
while true; do
    echo "[watchdog] $(date -Is) launching monitor" >> "$LOG_FILE_PATH"
    python -m meteor_scatter_tpu_torch.apps.monitor "$@" >> "$LOG_FILE_PATH" 2>&1
    code=$?
    echo "[watchdog] $(date -Is) monitor exited with code $code; restarting in 3 s" >> "$LOG_FILE_PATH"
    sleep 3
done
